// Block-sparse flash attention for Hopper (sm_90a), bf16 / fp16 / fp32: the
// forward, the dQ kernel and the dK/dV kernel.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/block_sparse_attention.py:
// _fwd_kernel (pallas_call in BlockSparseAttention._forward), _dq_kernel and
// _dkv_kernel (the two pallas_calls of BlockSparseAttention._backward). There the
// grid itself is sparse: per layout row a scalar-prefetched list of active kv
// blocks drives the BlockSpec index maps, over a sequential grid axis that
// carries (m, l, acc) in scratch. Here one thread block walks its own list in
// a loop, in the list's (ascending) order, so nothing carries over between
// blocks and no atomics are needed: every output tile is owned by one block,
// which sums in a fixed order, and the result is deterministic.
//
// The layout is a boolean [n_q_blocks, n_kv_blocks] mask of `block`-token
// blocks (ops/sparse_attention/sparsity_config.py). The host turns it once
// into padded lists: idx[j, a] (a < cnt[j]) are the kv blocks that q block j
// attends, ascending; the transposed lists (of layout^T) are the q blocks that
// attend kv block j. The kernels' tiles are TILE rows, the largest of 64, 32,
// 16 that divides the block (min(64, block) for the patterns' power-of-two
// blocks; at most 32 at head_dim 256, for shared memory), so a layout block
// may split into several tiles. head_dim is 32, 64, 80, 96, 128 or 256 (every
// width of the model registry's presets). With causal
// masking (aligned to the bottom right: key c is seen by query r when
// c <= r + s_kv - s_q, the TPU kernel's q_offset) the per-element mask
// applies on tiles that cross the diagonal only, and a tile wholly above the
// diagonal is skipped, never masked: the TPU kernel's whole-block tiles never
// meet one, and a fully masked tile met first would otherwise enter the
// online softmax.
//
//   forward:  one block per (batch*head, q tile); online softmax over the
//             active kv tiles (m, l, acc in fp32, as the TPU kernel's
//             :92-101); o in the input type and lse = m + log(max(l, 1e-30))
//             in fp32 per row ([b, h, s_q]; the TPU's 128-lane broadcast is a
//             VMEM layout device and is not copied).
//   dQ:       the forward's grid and lists; delta = rowsum(o * dO) in fp32,
//             once per q tile (the TPU kernel's a == 0 step), also written out
//             for the dK/dV kernel; P = exp(scale q.k - lse) recomputed,
//             dS = P (dP - delta) scale, dQ += dS K.
//   dK/dV:    one block per (batch*head, kv tile) over the transposed lists;
//             dV += P^T dO, dK += dS^T Q. A kv tile no q block attends writes
//             zeros (the TPU kernel's :239-244).
// Rounding follows the TPU kernels: P is rounded to the input type before
// P V and P^T dO, dS before dS K and dS^T Q; every product accumulates in
// fp32; outputs are rounded once to the input type.
//
// What bounds it on an H100 SXM: at GPT-2 medium's training shape (b 12,
// h 16, s 1024, d 64, block 128, the fixed pattern keeping 24 of 36 causal
// blocks) the kept score elements need 16 GFLOP forward (2 products of 2 d
// operations each) and 40 GFLOP backward (5 products), 0.016 / 0.041 ms at
// 989 TFLOP/s, while q, k, v, o (and dO, lse, dq, dk, dv) take 0.030 / 0.060
// ms at 3.35 TB/s: bytes bound it.
//
// The backward has two routes, fixed by the caller before the launch
// (ops/cuda/block_sparse_attention.py block_sparse_route): the wgmma route
// (bf16 / fp16 at head_dim 64 and 128 with a block that is a multiple of 128,
// the training layout's; ds_block_sparse_attention_bwd_wgmma at the end of
// this file) runs the flash backward's TMA + wgmma kernels
// (csrc/flash_bwd_sm90.cuh) with a list-driven tile schedule: a 128-token
// layout block is exactly one 128-row q tile of its dQ kernel and one 128-row
// kv tile of its dK/dV kernel, so the dQ block walks the 64-row halves of its
// list's kv blocks and the dK/dV block the q tiles of its transposed list's
// q blocks; the producer thread reads the list and issues the TMA loads from
// it, the consumers only count tiles and mask the diagonal. The grid takes
// the layout rows longest list first (SparseLayout's orders). The forward,
// and the backward's other shapes (fp32, head_dims 32/80/96/256, blocks not
// a multiple of 128), take the wmma route below: the port's simple flash
// design (csrc/flash_attention_{fwd,bwd}.cu) with sparse loops.
//
// The wmma route's design: TILE / 16 warps per block (TILE = 16, 32 or 64),
// each owning 16 rows of the block's tile end to end. Tiles are staged in
// shared memory with 16-byte loads; S = Q K^T and the other products are
// warp-level tensor-core MMA (nvcuda::wmma 16x16x16, fp32 accumulate) for
// bf16/fp16 and fp32 FMAs for fp32 (full fp32, no TF32; the last column
// group masked where head_dim is not a multiple of 32); S, P, dS and the
// fp32 accumulators live in shared memory. fp32 dK/dV blocks step over q in
// 32-row tiles so that their shared memory fits the 227 KB a block can have.
// The C entry points launch on the caller's stream, do not synchronise and
// return a cudaError_t.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int ROWS = 16;  // rows per warp
constexpr int MAX_SMEM = 232448;
constexpr float NEG_BIG = -1e30f;

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> struct TensorCore { static constexpr bool value = false; };
template <> struct TensorCore<__half> { static constexpr bool value = true; };
template <> struct TensorCore<__nv_bfloat16> { static constexpr bool value = true; };

// Row strides in shared memory are padded by 16 bytes (16-bit types) or 4
// floats: rows stay 16-byte aligned for the vector copies, every 16x16 MMA
// fragment starts on a 32-byte boundary and wmma's ldm rules hold.
template <typename T, int D>
__host__ __device__ constexpr int ld_t() { return D + 16 / (int)sizeof(T); }
template <int N>
__host__ __device__ constexpr int ld_f() { return N + 4; }
template <typename T, int N>
__host__ __device__ constexpr int ld_p() { return N + 16 / (int)sizeof(T); }
__host__ __device__ constexpr size_t align128(size_t x) { return (x + 127) & ~(size_t)127; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy ROWS_N rows x D elements (rows 16-byte aligned in global memory) into
// shared memory with row stride ld_t<T, D>(), NT threads.
template <typename T, int D, int ROWS_N, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  constexpr int LD = ld_t<T, D>();
  for (int i = threadIdx.x; i < ROWS_N * CHUNKS; i += NT) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    *reinterpret_cast<uint4*>(dst + r * LD + c) =
        *reinterpret_cast<const uint4*>(src + r * row_stride + c);
  }
}

// One warp: C[16 x N] = scale * A[16 x D] . B[N x D]^T, fp32 out. A and B are
// row-major tiles of T in shared memory with row stride ld_t<T, D>().
template <typename T, int D, int N>
__device__ __forceinline__ void mm_abt(const T* A, const T* B, float* C, float scale, int lane) {
  constexpr int LD = ld_t<T, D>();
  constexpr int LDC = ld_f<N>();
  if constexpr (TensorCore<T>::value) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[N / 16];
#pragma unroll
    for (int j = 0; j < N / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::load_matrix_sync(a, A + kk, LD);
#pragma unroll
      for (int j = 0; j < N / 16; ++j) {
        // B^T as a column-major operand: element (k, n) is B[n][k]
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, B + (16 * j) * LD + kk, LD);
        wmma::mma_sync(acc[j], a, b, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < N / 16; ++j) {
#pragma unroll
      for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= scale;
      wmma::store_matrix_sync(C + 16 * j, acc[j], LDC, wmma::mem_row_major);
    }
  } else {
    constexpr int CPL = (N + 31) / 32;  // columns per lane: lane + 32 c (< N)
    float acc[ROWS][CPL];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] = 0.0f;
    for (int k = 0; k < D; ++k) {
      float bv[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = lane + 32 * c;
        bv[c] = col < N ? to_float(B[col * LD + k]) : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const float a = to_float(A[i * LD + k]);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(a, bv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        const int col = lane + 32 * c;
        if (col < N) C[i * LDC + col] = acc[i][c] * scale;
      }
  }
}

// One warp: C[16 x D] += A[16 x N] . B[N x D]. A is a T tile with row stride
// ld_p<T, N>(), B a row-major T tile with row stride ld_t<T, D>(), C an fp32
// accumulator with row stride ld_f<D>().
template <typename T, int D, int N>
__device__ __forceinline__ void mm_ab_acc(const T* A, const T* B, float* C, int lane) {
  constexpr int LDA = ld_p<T, N>();
  constexpr int LDB = ld_t<T, D>();
  constexpr int LDC = ld_f<D>();
  if constexpr (TensorCore<T>::value) {
#pragma unroll
    for (int n = 0; n < D; n += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, C + n, LDC, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < N; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + kk, LDA);
        wmma::load_matrix_sync(b, B + kk * LDB + n, LDB);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + n, acc, LDC, wmma::mem_row_major);
    }
  } else {
    // lane owns columns lane + 32 c, the last group masked when D is not a
    // multiple of 32 (80, 96), at most 4 groups per pass
    constexpr int C_ALL = (D + 31) / 32;
    constexpr int CPL = C_ALL < 4 ? C_ALL : 4;
#pragma unroll
    for (int c0 = 0; c0 < C_ALL; c0 += CPL) {
      float acc[ROWS][CPL];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = 0.0f;
      for (int kk = 0; kk < N; ++kk) {
        float bv[CPL];
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int col = lane + 32 * (c0 + c);
          bv[c] = col < D ? to_float(B[kk * LDB + col]) : 0.0f;
        }
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float a = to_float(A[i * LDA + kk]);
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(a, bv[c], acc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int col = lane + 32 * (c0 + c);
          if (col < D) C[i * LDC + col] += acc[i][c];
        }
    }
  }
}

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

// Everything the three kernels read: the forward uses q, k, v, o and lse
// (null when the caller needs none); the backward all of it. Strides are in
// elements, (batch, seq, head) per tensor in the enum's order.
struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const void* dout;
  float* lse;      // [b, heads, s_q] fp32
  float* delta;    // [b, heads, s_q] fp32, written by the dQ kernel
  void* dq;
  void* dk;
  void* dv;
  const int* fidx;  // [n_q_blocks, max_a] active kv blocks per q block
  const int* fcnt;  // [n_q_blocks]
  const int* bidx;  // [n_kv_blocks, max_aq] q blocks attending each kv block
  const int* bcnt;  // [n_kv_blocks]
  int max_a, max_aq;
  int heads, s_q, s_kv, block;
  long long st[8][3];
  float scale;
  int causal;
};

// ---------------------------------------------------------------------------
// forward: one block per (b*h, q tile)
// ---------------------------------------------------------------------------
template <typename T, int D, int TILE>
struct FwdSmem {
  static constexpr int LDT = ld_t<T, D>();
  static constexpr int LDS = ld_f<TILE>();
  static constexpr int LDP = ld_p<T, TILE>();
  static constexpr int LDO = ld_f<D>();
  static constexpr bool kAlias = !TensorCore<T>::value;  // fp32: P overwrites S in place
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = align128(q_off + sizeof(T) * TILE * LDT);
  static constexpr size_t v_off = align128(k_off + sizeof(T) * TILE * LDT);
  static constexpr size_t s_off = align128(v_off + sizeof(T) * TILE * LDT);
  static constexpr size_t p_off = align128(s_off + sizeof(float) * TILE * LDS);
  static constexpr size_t p_bytes = kAlias ? 0 : sizeof(T) * TILE * LDP;
  static constexpr size_t o_off = align128(p_off + p_bytes);
  static constexpr size_t m_off = align128(o_off + sizeof(float) * TILE * LDO);
  static constexpr size_t l_off = m_off + sizeof(float) * TILE;
  static constexpr size_t bytes = l_off + sizeof(float) * TILE;
  static_assert(bytes <= MAX_SMEM, "forward shared memory");
};

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(TILE / ROWS * 32) bs_fwd_kernel(const Params p) {
  using S = FwdSmem<T, D, TILE>;
  constexpr int NT = TILE / ROWS * 32;
  constexpr int CPL = (TILE + 31) / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + S::q_off);
  T* sK = reinterpret_cast<T*>(smem + S::k_off);
  T* sV = reinterpret_cast<T*>(smem + S::v_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  T* sP = S::kAlias ? reinterpret_cast<T*>(sS) : reinterpret_cast<T*>(smem + S::p_off);
  float* sO = reinterpret_cast<float*>(smem + S::o_off);
  float* sM = reinterpret_cast<float*>(smem + S::m_off);
  float* sL = reinterpret_cast<float*>(smem + S::l_off);

  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = blockIdx.y * TILE;
  const int qb = q0 / p.block;  // this tile's layout row
  const int q_offset = p.s_kv - p.s_q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;

  const T* qg = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][2] + q0 * p.st[Q][1];
  const T* kg = static_cast<const T*>(p.k) + b * p.st[K][0] + h * p.st[K][2];
  const T* vg = static_cast<const T*>(p.v) + b * p.st[V][0] + h * p.st[V][2];

  load_tile<T, D, TILE, NT>(sQ, qg, p.st[Q][1]);
  for (int i = threadIdx.x; i < TILE * D; i += NT) sO[(i / D) * S::LDO + i % D] = 0.0f;
  for (int i = threadIdx.x; i < TILE; i += NT) {
    sM[i] = NEG_BIG;
    sL[i] = 0.0f;
  }

  const int n_act = p.fcnt[qb];
  const int* list = p.fidx + (long long)qb * p.max_a;
  const int last_col = q0 + TILE - 1 + q_offset;  // the last key any row of the tile sees
  for (int a = 0; a < n_act; ++a) {
    const int kb = list[a];
    for (int kv0 = kb * p.block; kv0 < (kb + 1) * p.block; kv0 += TILE) {
      // a tile wholly above the diagonal is skipped (the rest of the list lies above too)
      if (p.causal && kv0 > last_col) break;
      const bool diag = p.causal && kv0 + TILE - 1 > q0 + q_offset;
      __syncthreads();  // the previous tile's K/V are consumed
      load_tile<T, D, TILE, NT>(sK, kg + kv0 * p.st[K][1], p.st[K][1]);
      load_tile<T, D, TILE, NT>(sV, vg + kv0 * p.st[V][1], p.st[V][1]);
      __syncthreads();

      mm_abt<T, D, TILE>(sQ + r0 * S::LDT, sK, sS + r0 * S::LDS, p.scale, lane);
      __syncwarp();
      // online softmax over this warp's 16 rows; lane owns columns lane + 32 j
      for (int i = 0; i < ROWS; ++i) {
        const int r = r0 + i;
        const int limit = q0 + r + q_offset;  // last key row r may attend to
        float s[CPL];
        bool ok[CPL];
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          ok[j] = c < TILE && (!diag || kv0 + c <= limit);
          s[j] = ok[j] ? sS[r * S::LDS + c] : -INFINITY;
          mx = fmaxf(mx, s[j]);
        }
        mx = warp_max(mx);
        const float m_old = sM[r];
        const float m_new = fmaxf(m_old, mx);
        float pr[CPL];
        float sum = 0.0f;
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          pr[j] = ok[j] ? expf(s[j] - m_new) : 0.0f;
          sum += pr[j];
        }
        sum = warp_sum(sum);
        const float corr = expf(m_old - m_new);
        __syncwarp();
        if (lane == 0) {
          sM[r] = m_new;
          sL[r] = sL[r] * corr + sum;
        }
#pragma unroll
        for (int j = 0; j < CPL; ++j) {
          const int c = lane + 32 * j;
          if (c < TILE) sP[r * S::LDP + c] = from_float<T>(pr[j]);
        }
        for (int c = lane; c < D; c += 32) sO[r * S::LDO + c] *= corr;
      }
      __syncwarp();
      mm_ab_acc<T, D, TILE>(sP + r0 * S::LDP, sV, sO + r0 * S::LDO, lane);  // O += P V
    }
  }
  __syncthreads();

  T* og = static_cast<T*>(p.o) + b * p.st[O][0] + h * p.st[O][2] + q0 * p.st[O][1];
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D;
    const int c = i % D;
    og[r * p.st[O][1] + c] = from_float<T>(sO[r * S::LDO + c] / fmaxf(sL[r], 1e-30f));
  }
  if (p.lse != nullptr) {
    float* lg = p.lse + ((long long)b * p.heads + h) * p.s_q + q0;
    for (int r = threadIdx.x; r < TILE; r += NT) lg[r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

// ---------------------------------------------------------------------------
// dQ: one block per (b*h, q tile), over the forward lists
// ---------------------------------------------------------------------------
template <typename T, int D, int TILE>
struct DqSmem {
  static constexpr int LDT = ld_t<T, D>();
  static constexpr int LDS = ld_f<TILE>();
  static constexpr int LDP = ld_p<T, TILE>();
  static constexpr int LDA = ld_f<D>();
  static constexpr bool kAlias = !TensorCore<T>::value;  // fp32: dS overwrites S in place
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = align128(q_off + sizeof(T) * TILE * LDT);
  static constexpr size_t k_off = align128(do_off + sizeof(T) * TILE * LDT);
  static constexpr size_t v_off = align128(k_off + sizeof(T) * TILE * LDT);
  static constexpr size_t s_off = align128(v_off + sizeof(T) * TILE * LDT);
  static constexpr size_t dp_off = align128(s_off + sizeof(float) * TILE * LDS);
  static constexpr size_t ds_off = align128(dp_off + sizeof(float) * TILE * LDS);
  static constexpr size_t ds_bytes = kAlias ? 0 : sizeof(T) * TILE * LDP;
  static constexpr size_t acc_off = align128(ds_off + ds_bytes);
  static constexpr size_t lse_off = align128(acc_off + sizeof(float) * TILE * LDA);
  static constexpr size_t delta_off = lse_off + sizeof(float) * TILE;
  static constexpr size_t bytes = delta_off + sizeof(float) * TILE;
  static_assert(bytes <= MAX_SMEM, "dQ shared memory");
};

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(TILE / ROWS * 32) bs_dq_kernel(const Params p) {
  using S = DqSmem<T, D, TILE>;
  constexpr int NT = TILE / ROWS * 32;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + S::q_off);
  T* sDO = reinterpret_cast<T*>(smem + S::do_off);
  T* sK = reinterpret_cast<T*>(smem + S::k_off);
  T* sV = reinterpret_cast<T*>(smem + S::v_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  float* sDP = reinterpret_cast<float*>(smem + S::dp_off);
  T* sDS = S::kAlias ? reinterpret_cast<T*>(sS) : reinterpret_cast<T*>(smem + S::ds_off);
  float* sAcc = reinterpret_cast<float*>(smem + S::acc_off);
  float* sLse = reinterpret_cast<float*>(smem + S::lse_off);
  float* sDelta = reinterpret_cast<float*>(smem + S::delta_off);

  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int q0 = blockIdx.y * TILE;
  const int qb = q0 / p.block;
  const int q_offset = p.s_kv - p.s_q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;

  const T* qg = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][2] + q0 * p.st[Q][1];
  const T* og = static_cast<const T*>(p.o) + b * p.st[O][0] + h * p.st[O][2] + q0 * p.st[O][1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.st[DO][0] + h * p.st[DO][2] +
                 q0 * p.st[DO][1];
  const T* kg = static_cast<const T*>(p.k) + b * p.st[K][0] + h * p.st[K][2];
  const T* vg = static_cast<const T*>(p.v) + b * p.st[V][0] + h * p.st[V][2];
  const long long stat = ((long long)b * p.heads + h) * p.s_q + q0;

  load_tile<T, D, TILE, NT>(sQ, qg, p.st[Q][1]);
  load_tile<T, D, TILE, NT>(sDO, dog, p.st[DO][1]);
  for (int i = threadIdx.x; i < TILE * D; i += NT) sAcc[(i / D) * S::LDA + i % D] = 0.0f;
  // delta = rowsum(o * dO) in fp32, each warp its own 16 rows
  for (int i = 0; i < ROWS; ++i) {
    const int r = r0 + i;
    float acc = 0.0f;
    for (int c = lane; c < D; c += 32)
      acc = fmaf(to_float(og[r * p.st[O][1] + c]), to_float(dog[r * p.st[DO][1] + c]), acc);
    acc = warp_sum(acc);
    if (lane == 0) {
      sDelta[r] = acc;
      sLse[r] = p.lse[stat + r];
      p.delta[stat + r] = acc;
    }
  }

  const int n_act = p.fcnt[qb];
  const int* list = p.fidx + (long long)qb * p.max_a;
  const int last_col = q0 + TILE - 1 + q_offset;
  for (int a = 0; a < n_act; ++a) {
    const int kb = list[a];
    for (int kv0 = kb * p.block; kv0 < (kb + 1) * p.block; kv0 += TILE) {
      if (p.causal && kv0 > last_col) break;  // above the diagonal: skipped
      const bool diag = p.causal && kv0 + TILE - 1 > q0 + q_offset;
      __syncthreads();  // the previous tile's K/V are consumed
      load_tile<T, D, TILE, NT>(sK, kg + kv0 * p.st[K][1], p.st[K][1]);
      load_tile<T, D, TILE, NT>(sV, vg + kv0 * p.st[V][1], p.st[V][1]);
      __syncthreads();

      mm_abt<T, D, TILE>(sQ + r0 * S::LDT, sK, sS + r0 * S::LDS, p.scale, lane);   // S
      mm_abt<T, D, TILE>(sDO + r0 * S::LDT, sV, sDP + r0 * S::LDS, 1.0f, lane);    // dP
      __syncwarp();
      for (int i = 0; i < ROWS; ++i) {
        const int r = r0 + i;
        const int limit = q0 + r + q_offset;
        const float lse = sLse[r];
        const float delta = sDelta[r];
        for (int c = lane; c < TILE; c += 32) {
          const bool ok = !diag || kv0 + c <= limit;
          const float pr = ok ? expf(sS[r * S::LDS + c] - lse) : 0.0f;
          const float ds = pr * (sDP[r * S::LDS + c] - delta) * p.scale;
          sDS[r * S::LDP + c] = from_float<T>(ds);
        }
      }
      __syncwarp();
      mm_ab_acc<T, D, TILE>(sDS + r0 * S::LDP, sK, sAcc + r0 * S::LDA, lane);   // dQ += dS K
    }
  }
  __syncthreads();

  T* dqg = static_cast<T*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][2] + q0 * p.st[DQ][1];
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D;
    const int c = i % D;
    dqg[r * p.st[DQ][1] + c] = from_float<T>(sAcc[r * S::LDA + c]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (b*h, kv tile), over the transposed lists
// ---------------------------------------------------------------------------
template <typename T, int TILE>
struct DkvRows {  // q rows per step
  static constexpr int value = TensorCore<T>::value ? TILE : (TILE < 32 ? TILE : 32);
};

template <typename T, int D, int TILE>
struct DkvSmem {
  static constexpr int NQ = DkvRows<T, TILE>::value;
  static constexpr int LDT = ld_t<T, D>();
  static constexpr int LDS = ld_f<NQ>();
  static constexpr int LDP = ld_p<T, NQ>();
  static constexpr int LDA = ld_f<D>();
  static constexpr bool kAlias = !TensorCore<T>::value;  // fp32: P, dS overwrite S, dP
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = align128(k_off + sizeof(T) * TILE * LDT);
  static constexpr size_t q_off = align128(v_off + sizeof(T) * TILE * LDT);
  static constexpr size_t do_off = align128(q_off + sizeof(T) * NQ * LDT);
  static constexpr size_t s_off = align128(do_off + sizeof(T) * NQ * LDT);
  static constexpr size_t dp_off = align128(s_off + sizeof(float) * TILE * LDS);
  static constexpr size_t p_off = align128(dp_off + sizeof(float) * TILE * LDS);
  static constexpr size_t p_bytes = kAlias ? 0 : align128(sizeof(T) * TILE * LDP);
  static constexpr size_t ds_off = p_off + p_bytes;
  static constexpr size_t dk_off = align128(ds_off + p_bytes);
  static constexpr size_t dv_off = align128(dk_off + sizeof(float) * TILE * LDA);
  static constexpr size_t lse_off = align128(dv_off + sizeof(float) * TILE * LDA);
  static constexpr size_t delta_off = lse_off + sizeof(float) * NQ;
  static constexpr size_t bytes = delta_off + sizeof(float) * NQ;
  static_assert(bytes <= MAX_SMEM, "dK/dV shared memory");
};

template <typename T, int D, int TILE>
__global__ void __launch_bounds__(TILE / ROWS * 32) bs_dkv_kernel(const Params p) {
  using S = DkvSmem<T, D, TILE>;
  constexpr int NT = TILE / ROWS * 32;
  constexpr int NQ = S::NQ;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem + S::k_off);
  T* sV = reinterpret_cast<T*>(smem + S::v_off);
  T* sQ = reinterpret_cast<T*>(smem + S::q_off);
  T* sDO = reinterpret_cast<T*>(smem + S::do_off);
  float* sST = reinterpret_cast<float*>(smem + S::s_off);    // S^T  [kv x q]
  float* sDPT = reinterpret_cast<float*>(smem + S::dp_off);  // dP^T [kv x q]
  T* sPT = S::kAlias ? reinterpret_cast<T*>(sST) : reinterpret_cast<T*>(smem + S::p_off);
  T* sDST = S::kAlias ? reinterpret_cast<T*>(sDPT) : reinterpret_cast<T*>(smem + S::ds_off);
  float* sDK = reinterpret_cast<float*>(smem + S::dk_off);
  float* sDV = reinterpret_cast<float*>(smem + S::dv_off);
  float* sLse = reinterpret_cast<float*>(smem + S::lse_off);
  float* sDelta = reinterpret_cast<float*>(smem + S::delta_off);

  const int b = blockIdx.x / p.heads;
  const int h = blockIdx.x % p.heads;
  const int kv0 = blockIdx.y * TILE;
  const int kb = kv0 / p.block;  // this tile's layout column
  const int q_offset = p.s_kv - p.s_q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;

  load_tile<T, D, TILE, NT>(sK, static_cast<const T*>(p.k) + b * p.st[K][0] + h * p.st[K][2] +
                                    kv0 * p.st[K][1], p.st[K][1]);
  load_tile<T, D, TILE, NT>(sV, static_cast<const T*>(p.v) + b * p.st[V][0] + h * p.st[V][2] +
                                    kv0 * p.st[V][1], p.st[V][1]);
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    sDK[(i / D) * S::LDA + i % D] = 0.0f;
    sDV[(i / D) * S::LDA + i % D] = 0.0f;
  }
  const T* qg = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][2];
  const T* dog = static_cast<const T*>(p.dout) + b * p.st[DO][0] + h * p.st[DO][2];
  const long long stat = ((long long)b * p.heads + h) * p.s_q;

  // n_act == 0 (no q block attends this kv block) leaves the zeros
  const int n_act = p.bcnt[kb];
  const int* list = p.bidx + (long long)kb * p.max_aq;
  for (int a = 0; a < n_act; ++a) {
    const int qb = list[a];
    for (int q0 = qb * p.block; q0 < (qb + 1) * p.block; q0 += NQ) {
      // no row of this q tile reaches the kv tile: skipped
      if (p.causal && q0 + NQ - 1 + q_offset < kv0) continue;
      const bool diag = p.causal && kv0 + TILE - 1 > q0 + q_offset;
      __syncthreads();  // the previous q tile is consumed
      load_tile<T, D, NQ, NT>(sQ, qg + q0 * p.st[Q][1], p.st[Q][1]);
      load_tile<T, D, NQ, NT>(sDO, dog + q0 * p.st[DO][1], p.st[DO][1]);
      for (int i = threadIdx.x; i < NQ; i += NT) {
        sLse[i] = p.lse[stat + q0 + i];
        sDelta[i] = p.delta[stat + q0 + i];
      }
      __syncthreads();

      mm_abt<T, D, NQ>(sK + r0 * S::LDT, sQ, sST + r0 * S::LDS, p.scale, lane);  // S^T
      mm_abt<T, D, NQ>(sV + r0 * S::LDT, sDO, sDPT + r0 * S::LDS, 1.0f, lane);  // dP^T
      __syncwarp();
      for (int jj = 0; jj < ROWS; ++jj) {
        const int j = r0 + jj;
        const int col = kv0 + j;
        for (int i = lane; i < NQ; i += 32) {
          const bool ok = !diag || col <= q0 + i + q_offset;
          const float pr = ok ? expf(sST[j * S::LDS + i] - sLse[i]) : 0.0f;
          const float ds = pr * (sDPT[j * S::LDS + i] - sDelta[i]) * p.scale;
          sPT[j * S::LDP + i] = from_float<T>(pr);
          sDST[j * S::LDP + i] = from_float<T>(ds);
        }
      }
      __syncwarp();
      mm_ab_acc<T, D, NQ>(sPT + r0 * S::LDP, sDO, sDV + r0 * S::LDA, lane);   // dV += P^T dO
      mm_ab_acc<T, D, NQ>(sDST + r0 * S::LDP, sQ, sDK + r0 * S::LDA, lane);   // dK += dS^T Q
    }
  }
  __syncthreads();

  T* dkg = static_cast<T*>(p.dk) + b * p.st[DK][0] + h * p.st[DK][2] + kv0 * p.st[DK][1];
  T* dvg = static_cast<T*>(p.dv) + b * p.st[DV][0] + h * p.st[DV][2] + kv0 * p.st[DV][1];
  for (int i = threadIdx.x; i < TILE * D; i += NT) {
    const int r = i / D;
    const int c = i % D;
    dkg[r * p.st[DK][1] + c] = from_float<T>(sDK[r * S::LDA + c]);
    dvg[r * p.st[DV][1] + c] = from_float<T>(sDV[r * S::LDA + c]);
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, size_t bytes) {
  // above 48 KB of shared memory a kernel must opt in (per device, so on
  // every launch rather than once per process)
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

template <typename T, int D, int TILE>
cudaError_t launch_fwd(const Params& p, int batch, cudaStream_t stream) {
  using S = FwdSmem<T, D, TILE>;
  cudaError_t err = opt_in(bs_fwd_kernel<T, D, TILE>, S::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.heads, p.s_q / TILE);
  bs_fwd_kernel<T, D, TILE><<<grid, TILE / ROWS * 32, S::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, int TILE>
cudaError_t launch_bwd(const Params& p, int batch, cudaStream_t stream) {
  // dQ first: it writes delta, which the dK/dV kernel reads (stream order)
  cudaError_t err = opt_in(bs_dq_kernel<T, D, TILE>, DqSmem<T, D, TILE>::bytes);
  if (err != cudaSuccess) return err;
  bs_dq_kernel<T, D, TILE><<<dim3(batch * p.heads, p.s_q / TILE), TILE / ROWS * 32,
                             DqSmem<T, D, TILE>::bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = opt_in(bs_dkv_kernel<T, D, TILE>, DkvSmem<T, D, TILE>::bytes);
  if (err != cudaSuccess) return err;
  bs_dkv_kernel<T, D, TILE><<<dim3(batch * p.heads, p.s_kv / TILE), TILE / ROWS * 32,
                              DkvSmem<T, D, TILE>::bytes, stream>>>(p);
  return cudaGetLastError();
}

// The tile: the largest of 64, 32, 16 rows that divides the block (min(64,
// block) for the power-of-two blocks the patterns use), at most 32 at head_dim
// 256, where a 64-row tile's shared memory passes the 227 KB a block can have.
__host__ __device__ constexpr int tile_for(int block, int head_dim) {
  return block % 64 == 0 && head_dim <= 128 ? 64 : (block % 32 == 0 ? 32 : 16);
}

template <typename T, int D>
cudaError_t dispatch_tile(const Params& p, int batch, bool bwd, cudaStream_t stream) {
  switch (tile_for(p.block, D)) {
    case 64:
      if constexpr (D <= 128)
        return bwd ? launch_bwd<T, D, 64>(p, batch, stream)
                   : launch_fwd<T, D, 64>(p, batch, stream);
      return cudaErrorInvalidValue;
    case 32:
      return bwd ? launch_bwd<T, D, 32>(p, batch, stream) : launch_fwd<T, D, 32>(p, batch, stream);
    default:
      return bwd ? launch_bwd<T, D, 16>(p, batch, stream) : launch_fwd<T, D, 16>(p, batch, stream);
  }
}

template <typename T>
cudaError_t dispatch(const Params& p, int batch, int head_dim, bool bwd, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return dispatch_tile<T, 32>(p, batch, bwd, stream);
    case 64: return dispatch_tile<T, 64>(p, batch, bwd, stream);
    case 80: return dispatch_tile<T, 80>(p, batch, bwd, stream);
    case 96: return dispatch_tile<T, 96>(p, batch, bwd, stream);
    case 128: return dispatch_tile<T, 128>(p, batch, bwd, stream);
    case 256: return dispatch_tile<T, 256>(p, batch, bwd, stream);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t run(const Params& p, int dtype, int batch, int head_dim, bool bwd, void* stream) {
  // the block must be a multiple of 16 and divide both lengths; one grid
  // row per tile
  if (batch <= 0 || p.heads <= 0 || p.block <= 0 || p.block % 16 != 0 || p.s_q <= 0 ||
      p.s_kv <= 0 || p.s_q % p.block != 0 || p.s_kv % p.block != 0 ||
      (p.causal && p.s_q > p.s_kv) || p.s_q / tile_for(p.block, head_dim) > 65535 ||
      p.s_kv / tile_for(p.block, head_dim) > 65535 || p.max_a <= 0 || (bwd && p.max_aq <= 0))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch<float>(p, batch, head_dim, bwd, st);
    case 1: return dispatch<__half>(p, batch, head_dim, bwd, st);
    case 2: return dispatch<__nv_bfloat16>(p, batch, head_dim, bwd, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. q, k, v, o are [batch, s, heads,
// head_dim] read through `strides` (12 element strides: (batch, seq, head) of q,
// k, v, o; the last dimension contiguous, rows 16-byte aligned). idx/cnt are the
// layout's forward lists ([s_q / block, max_a] and [s_q / block] int32). lse is
// null or a contiguous [batch, heads, s_q] fp32 buffer. Returns a cudaError_t.
extern "C" int ds_block_sparse_attention_fwd(
    const void* q, const void* k, const void* v, void* o, float* lse, const int* idx,
    const int* cnt, int max_a, int dtype, int batch, int heads, int s_q, int s_kv,
    int head_dim, int block, const long long* strides, float scale, int causal, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.fidx = idx;
  p.fcnt = cnt;
  p.max_a = max_a;
  p.heads = heads;
  p.s_q = s_q;
  p.s_kv = s_kv;
  p.block = block;
  for (int t = 0; t < 4; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = strides[3 * t + j];
  p.scale = scale;
  p.causal = causal;
  return (int)run(p, dtype, batch, head_dim, false, stream);
}

// The backward: the dQ kernel (which also fills `delta`, contiguous [batch,
// heads, s_q] fp32 scratch) and then the dK/dV kernel. `strides` holds 24
// element strides: (batch, seq, head) of q, k, v, o, dout, dq, dk, dv in that
// order. fidx/fcnt are the forward lists, bidx/bcnt those of the transposed
// layout ([s_kv / block, max_aq] and [s_kv / block]). Returns a cudaError_t.
extern "C" int ds_block_sparse_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, const int* fidx,
    const int* fcnt, const int* bidx, const int* bcnt, int max_a, int max_aq, int dtype,
    int batch, int heads, int s_q, int s_kv, int head_dim, int block, const long long* strides,
    float scale, int causal, void* stream) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = const_cast<void*>(o);
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.fidx = fidx;
  p.fcnt = fcnt;
  p.bidx = bidx;
  p.bcnt = bcnt;
  p.max_a = max_a;
  p.max_aq = max_aq;
  p.heads = heads;
  p.s_q = s_q;
  p.s_kv = s_kv;
  p.block = block;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = strides[3 * t + j];
  p.scale = scale;
  p.causal = causal;
  return (int)run(p, dtype, batch, head_dim, true, stream);
}

// ===================================================================================
// The backward's wgmma route: bf16 / fp16 at head_dim 64 and 128, blocks a
// multiple of 128, on the kernels of csrc/flash_bwd_sm90.cuh with the layout's
// lists as their tile schedule (ListDq, ListDkv).
// ===================================================================================

#include "flash_bwd_sm90.cuh"

// The arguments as ds_block_sparse_attention_bwd's, except that `scratch` is
// the caller's fp32 buffer of 2 * batch * heads * s_q floats (lse2 rows, then
// delta rows), which the call fills, and q_order / kv_order are the grid's
// order of the layout's q and kv blocks (permutations, int32). Every stride a
// multiple of 8 elements, every base 16-byte aligned (TMA). Returns a
// cudaError_t; what the route does not take is cudaErrorInvalidValue.
extern "C" int ds_block_sparse_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* scratch, void* dq, void* dk, void* dv, const int* fidx,
    const int* fcnt, const int* bidx, const int* bcnt, const int* q_order, const int* kv_order,
    int max_a, int max_aq, int dtype, int batch, int heads, int s_q, int s_kv, int head_dim,
    int block, const long long* strides, float scale, int causal, void* stream) {
  namespace fb = flash_bwd_sm90;
  if (batch <= 0 || heads <= 0 || block <= 0 || block % fb::PAD != 0 || s_q <= 0 ||
      s_kv <= 0 || s_q % block != 0 || s_kv % block != 0 || (causal && s_q > s_kv) ||
      s_q / fb::PAD > 65535 || s_kv / fb::PAD > 65535 || max_a <= 0 || max_aq <= 0)
    return (int)cudaErrorInvalidValue;
  fb::Args a;
  a.s_pad = s_q;   // a multiple of the 128-row pad already
  const long long rows = (long long)batch * heads * a.s_pad;
  a.lse = lse;
  a.lse2 = scratch;
  a.delta = scratch + rows;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.heads = heads;
  a.kv_heads = heads;
  a.s_q = s_q;
  a.s_kv = s_kv;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) a.st[t][j] = strides[3 * t + j];
  a.scale = scale;
  a.causal = causal;
  const fb::ListParams fwd{fidx, fcnt, q_order, max_a, block};
  const fb::ListParams bwd{bidx, bcnt, kv_order, max_aq, block};
  const void* ptr[8] = {q, k, v, o, dout, dq, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1 && head_dim == 64)
    err = fb::launch<__half, 64, fb::ListDq, fb::ListDkv>(ptr, a, batch, fwd, bwd, s);
  if (dtype == 1 && head_dim == 128)
    err = fb::launch<__half, 128, fb::ListDq, fb::ListDkv>(ptr, a, batch, fwd, bwd, s);
  if (dtype == 2 && head_dim == 64)
    err = fb::launch<__nv_bfloat16, 64, fb::ListDq, fb::ListDkv>(ptr, a, batch, fwd, bwd, s);
  if (dtype == 2 && head_dim == 128)
    err = fb::launch<__nv_bfloat16, 128, fb::ListDq, fb::ListDkv>(ptr, a, batch, fwd, bwd, s);
  return (int)err;
}
