// Flash-attention backward for Hopper (sm_90a), bf16 / fp16 / fp32.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py
// that _flash_bwd launches: _dq_kernel_single and _dq_kernel (dQ over one or
// several kv tiles) and _dkv_kernel_single and _dkv_kernel (dK, dV over one or
// several q tiles). As on the TPU this is the FlashAttention-2 split, with no
// atomics, so the result is deterministic:
//   * delta_kernel: delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in fp32
//     (the TPU kernels compute it in their own bodies; here a first __global__
//     of the same call computes it once for both of the others);
//   * dq_kernel: one block per (batch*head, 64-row q tile); it loops over the kv
//     tiles up to the causal diagonal. P = exp(scale q.k - lse) is recomputed
//     from the forward's lse, dP = dO V^T, dS = P (dP - delta) scale, and
//     dQ += dS K;
//   * dkv_kernel: one block per (batch, kv head, 64-row kv tile); it loops over
//     the heads/kv_heads query heads that share the kv head (GQA: the forward
//     reads unrepeated kv heads, so dK and dV come back with kv_heads heads,
//     summed in fp32 over the group) and over the q tiles from the causal
//     diagonal on: dV += P^T dO and dK += dS^T Q.
// Rounding follows the TPU kernels: P is rounded to dO's type before P^T dO,
// dS to q's type before dS K and dS^T Q; every product accumulates in fp32; the
// outputs are rounded once to the input type. Masking is causal or none, with
// the causal mask aligned to the bottom right (key j is seen by query i when
// j <= i + s_kv - s_q, the TPU kernel's q_offset). Inputs are [b, s, h, d]
// read through the caller's strides (last dimension contiguous, rows 16-byte
// aligned); any s_q and s_kv are masked in-kernel; head_dim is 32, 64, 80,
// 96, 128 or 256 (every width of the model registry's presets).
//
// What bounds it on an H100 SXM: operations. Per allowed (i, j) pair the
// backward does five products of d multiply-adds (S and dP in both kernels,
// then dQ, dK and dV): 10 * d operations, 64 GFLOP at the training shape
// (b 12, h 16, s 1024, d 64, causal), 0.065 ms at 989 TFLOP/s in bf16; the
// bytes (q, k, v, o, dO, lse in, dq, dk, dv out) take about 0.05 ms at 3.35 TB/s.
//
// Two routes, as in the forward (ops/cuda/flash_attention.py
// attention_route): the wgmma route for bf16 and fp16 at head_dim 64, 80, 96,
// 128 and 256 (ds_flash_attention_bwd_wgmma at the end of this file: the
// kernels of csrc/flash_bwd_sm90.cuh, which the block-sparse backward shares,
// over the dense causal range; at 256 with 32-row K/V tiles in the dQ kernel
// and the dK/dV kernel's two warpgroups splitting the columns) and the wmma
// route below (ds_flash_attention_bwd) for the rest: fp32, and 16-bit at
// head_dim 32. The wmma kernels also take every 16-bit shape when the
// caller forces them (the old route timed against the new one).
//
// The wmma route's design (a simple right kernel, like the forward's): 4
// warps per block, each owning 16 rows of the block's tile end to end, so
// after the tiles are staged in shared memory
// no block barrier is needed until the next tile. The products are warp-level
// tensor-core MMA (nvcuda::wmma 16x16x16, fp32 accumulate) for bf16/fp16 and
// fp32 FMAs for fp32 inputs (full fp32, no TF32); S, dP, P and dS of a tile and
// the fp32 dQ / dK / dV accumulators live in shared memory. The tiles are
// picked per (type, head_dim) at compile time so that a block's shared memory
// fits the 227 KB it can have (TileCfg below): fp32 dK/dV blocks take 32-row
// q tiles; at head_dim 256 the dQ kernel takes 32-row kv tiles (fp32: 32-row
// q tiles too) and the dK/dV kernel 32-row kv tiles, with 2 warps of 16 rows
// for bf16/fp16 and 4 warps of 8 rows for fp32. Where head_dim is not a
// multiple of 32 (80, 96) the FMA path's last column group is masked. The C
// entry point launches on the caller's stream, does not synchronise and
// returns the cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int MAX_SMEM = 232448;

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

// The tiles of each kernel for (T, D). A warp owns RW rows of its block's
// tile end to end: 16 on the tensor cores (one MMA row block), 8 or 16 with
// fp32 FMAs.
//   dQ block:    DQ_Q q rows, stepping over DQ_KV kv rows, 4 warps;
//   dK/dV block: DKV_KV kv rows, stepping over DKV_Q q rows, DKV_KV / DKV_RW
//                warps.
template <typename T, int D>
struct TileCfg {
  static constexpr bool TC = TensorCore<T>::value;
  static constexpr bool WIDE = D > 128;
  static constexpr int DQ_Q = !TC && WIDE ? 32 : 64;
  static constexpr int DQ_KV = WIDE ? 32 : 64;
  static constexpr int DQ_RW = DQ_Q / 4;
  static constexpr int DKV_KV = WIDE ? 32 : 64;
  static constexpr int DKV_Q = TC ? 64 : 32;
  static constexpr int DKV_RW = TC ? 16 : DKV_KV / 4;
  static constexpr int DQ_THREADS = 128;
  static constexpr int DKV_THREADS = DKV_KV / DKV_RW * 32;
};

constexpr int DELTA_WARPS = 4;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;   // [b, heads, s_q] fp32
  float* delta;       // [b, heads, s_q] fp32 scratch
  void* dq;
  void* dk;
  void* dv;
  int heads, kv_heads, s_q, s_kv;
  // element strides (batch, seq, head) of q, k, v, o, dout, dq, dk, dv
  long long st[8][3];
  float scale;
  int causal;
};

enum { Q = 0, K = 1, V = 2, O = 3, DO = 4, DQ = 5, DK = 6, DV = 7 };

// Row strides in shared memory are padded by 16 bytes (16-bit types) or 4
// floats: rows stay 16-byte aligned for the vector copies, every 16x16 MMA
// fragment starts on a 32-byte boundary and wmma's ldm rules hold.
template <typename T, int D>
__host__ __device__ constexpr int ld_t() { return D + 16 / (int)sizeof(T); }
template <int N>
__host__ __device__ constexpr int ld_f() { return N + 4; }
template <typename T, int N>
__host__ __device__ constexpr int ld_p() { return N + 16 / (int)sizeof(T); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Copy `TILE` rows x D elements into shared memory (rows >= rows_valid zero),
// NT threads.
template <typename T, int D, int TILE, int NT>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride,
                                          int rows_valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  constexpr int LD = ld_t<T, D>();
  for (int i = threadIdx.x; i < TILE * CHUNKS; i += NT) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// One warp: C[RW x N] = scale * A[RW x D] . B[N x D]^T, fp32 out. A and B are
// row-major tiles of T in shared memory with row stride ld_t<T, D>(). RW is
// 16 on the tensor cores; N is a multiple of 32.
template <typename T, int D, int N, int RW>
__device__ __forceinline__ void mm_abt(const T* A, const T* B, float* C, float scale, int lane) {
  constexpr int LD = ld_t<T, D>();
  constexpr int LDC = ld_f<N>();
  static_assert(N % 32 == 0, "columns per lane");
  if constexpr (TensorCore<T>::value) {
    static_assert(RW == 16, "one MMA row block per warp");
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
    constexpr int CPL = N / 32;  // columns per lane: lane + 32 c
    float acc[RW][CPL];
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) acc[i][c] = 0.0f;
    for (int k = 0; k < D; ++k) {
      float bv[CPL];
#pragma unroll
      for (int c = 0; c < CPL; ++c) bv[c] = to_float(B[(lane + 32 * c) * LD + k]);
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float a = to_float(A[i * LD + k]);
#pragma unroll
        for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(a, bv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < RW; ++i)
#pragma unroll
      for (int c = 0; c < CPL; ++c) C[i * LDC + lane + 32 * c] = acc[i][c] * scale;
  }
}

// One warp: C[RW x D] += A[RW x N] . B[N x D]. A is a T tile with row stride
// ld_p<T, N>(), B a row-major T tile with row stride ld_t<T, D>(), C an fp32
// accumulator with row stride ld_f<D>(). The FMA path gives lane the columns
// lane + 32 c, the last group masked when D is not a multiple of 32, at most
// 4 groups per pass.
template <typename T, int D, int N, int RW>
__device__ __forceinline__ void mm_ab_acc(const T* A, const T* B, float* C, int lane) {
  constexpr int LDA = ld_p<T, N>();
  constexpr int LDB = ld_t<T, D>();
  constexpr int LDC = ld_f<D>();
  if constexpr (TensorCore<T>::value) {
    static_assert(RW == 16, "one MMA row block per warp");
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
    constexpr int C_ALL = (D + 31) / 32;
    constexpr int CPL = C_ALL < 4 ? C_ALL : 4;
#pragma unroll
    for (int c0 = 0; c0 < C_ALL; c0 += CPL) {
      float acc[RW][CPL];
#pragma unroll
      for (int i = 0; i < RW; ++i)
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
        for (int i = 0; i < RW; ++i) {
          const float a = to_float(A[i * LDA + kk]);
#pragma unroll
          for (int c = 0; c < CPL; ++c) acc[i][c] = fmaf(a, bv[c], acc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < RW; ++i)
#pragma unroll
        for (int c = 0; c < CPL; ++c) {
          const int col = lane + 32 * (c0 + c);
          if (col < D) C[i * LDC + col] += acc[i][c];
        }
    }
  }
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O): one warp per (b, i, h) row
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(DELTA_WARPS * 32) delta_kernel(const Params p, int batch) {
  const long long row = (long long)blockIdx.x * DELTA_WARPS + threadIdx.x / 32;
  const long long rows = (long long)batch * p.s_q * p.heads;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int h = (int)(row % p.heads);
  const int i = (int)((row / p.heads) % p.s_q);
  const int b = (int)(row / ((long long)p.heads * p.s_q));
  const T* o = static_cast<const T*>(p.o) + b * p.st[O][0] + i * p.st[O][1] + h * p.st[O][2];
  const T* g = static_cast<const T*>(p.dout) + b * p.st[DO][0] + i * p.st[DO][1] + h * p.st[DO][2];
  float acc = 0.0f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(o[c]), to_float(g[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[((long long)b * p.heads + h) * p.s_q + i] = acc;
}

// ---------------------------------------------------------------------------
// dQ: one block per (b*h, q tile)
// ---------------------------------------------------------------------------
template <typename T, int D>
struct DqSmem {
  static constexpr int BQ = TileCfg<T, D>::DQ_Q;
  static constexpr int BKV = TileCfg<T, D>::DQ_KV;
  static constexpr int LDT = ld_t<T, D>();
  static constexpr int LDS = ld_f<BKV>();
  static constexpr int LDP = ld_p<T, BKV>();
  static constexpr int LDA = ld_f<D>();
  static constexpr bool kAlias = !TensorCore<T>::value;  // fp32: dS overwrites S in place
  static constexpr size_t q_off = 0;
  static constexpr size_t do_off = q_off + sizeof(T) * BQ * LDT;
  static constexpr size_t k_off = do_off + sizeof(T) * BQ * LDT;
  static constexpr size_t v_off = k_off + sizeof(T) * BKV * LDT;
  static constexpr size_t s_off = v_off + sizeof(T) * BKV * LDT;
  static constexpr size_t dp_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t ds_off = dp_off + sizeof(float) * BQ * LDS;
  static constexpr size_t ds_bytes = kAlias ? 0 : sizeof(T) * BQ * LDP;
  static constexpr size_t acc_off = ds_off + ds_bytes;
  static constexpr size_t lse_off = acc_off + sizeof(float) * BQ * LDA;
  static constexpr size_t delta_off = lse_off + sizeof(float) * BQ;
  static constexpr size_t bytes = delta_off + sizeof(float) * BQ;
  static_assert(bytes <= MAX_SMEM, "dQ shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(TileCfg<T, D>::DQ_THREADS) dq_kernel(const Params p) {
  using S = DqSmem<T, D>;
  constexpr int BQ = S::BQ, BKV = S::BKV;
  constexpr int RW = TileCfg<T, D>::DQ_RW;
  constexpr int NT = TileCfg<T, D>::DQ_THREADS;
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

  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int g = h / (p.heads / p.kv_heads);
  // the last q tiles carry the most causal work: schedule them first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_rows = min(BQ, p.s_q - q0);
  const int q_offset = p.s_kv - p.s_q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * RW;

  const T* qg = static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][2] + q0 * p.st[Q][1];
  const T* dog = static_cast<const T*>(p.dout) + b * p.st[DO][0] + h * p.st[DO][2] +
                 q0 * p.st[DO][1];
  const T* kg = static_cast<const T*>(p.k) + b * p.st[K][0] + g * p.st[K][2];
  const T* vg = static_cast<const T*>(p.v) + b * p.st[V][0] + g * p.st[V][2];
  const long long stat = ((long long)b * p.heads + h) * p.s_q + q0;

  load_tile<T, D, BQ, NT>(sQ, qg, p.st[Q][1], q_rows);
  load_tile<T, D, BQ, NT>(sDO, dog, p.st[DO][1], q_rows);
  for (int i = threadIdx.x; i < BQ * D; i += NT) sAcc[(i / D) * S::LDA + i % D] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += NT) {
    sLse[i] = i < q_rows ? p.lse[stat + i] : 0.0f;
    sDelta[i] = i < q_rows ? p.delta[stat + i] : 0.0f;
  }

  int kv_end = p.s_kv;
  if (p.causal) kv_end = min(p.s_kv, q0 + q_rows + q_offset);

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's K/V are consumed
    const int kv_rows = min(BKV, p.s_kv - kv0);
    load_tile<T, D, BKV, NT>(sK, kg + kv0 * p.st[K][1], p.st[K][1], kv_rows);
    load_tile<T, D, BKV, NT>(sV, vg + kv0 * p.st[V][1], p.st[V][1], kv_rows);
    __syncthreads();

    mm_abt<T, D, BKV, RW>(sQ + r0 * S::LDT, sK, sS + r0 * S::LDS, p.scale, lane);   // S
    mm_abt<T, D, BKV, RW>(sDO + r0 * S::LDT, sV, sDP + r0 * S::LDS, 1.0f, lane);    // dP
    __syncwarp();
    for (int i = 0; i < RW; ++i) {
      const int r = r0 + i;
      const int limit = q0 + r + q_offset;  // last kv index row r attends to
      const float lse = sLse[r];
      const float delta = sDelta[r];
      for (int c = lane; c < BKV; c += 32) {
        const int col = kv0 + c;
        const bool ok = r < q_rows && col < p.s_kv && (!p.causal || col <= limit);
        const float pr = ok ? expf(sS[r * S::LDS + c] - lse) : 0.0f;
        const float ds = pr * (sDP[r * S::LDS + c] - delta) * p.scale;
        sDS[r * S::LDP + c] = from_float<T>(ds);
      }
    }
    __syncwarp();
    mm_ab_acc<T, D, BKV, RW>(sDS + r0 * S::LDP, sK, sAcc + r0 * S::LDA, lane);   // dQ += dS K
  }
  __syncthreads();

  T* dqg = static_cast<T*>(p.dq) + b * p.st[DQ][0] + h * p.st[DQ][2] + q0 * p.st[DQ][1];
  for (int i = threadIdx.x; i < q_rows * D; i += NT) {
    const int r = i / D;
    const int c = i % D;
    dqg[r * p.st[DQ][1] + c] = from_float<T>(sAcc[r * S::LDA + c]);
  }
}

// ---------------------------------------------------------------------------
// dK, dV: one block per (b * kv_heads, kv tile)
// ---------------------------------------------------------------------------
template <typename T, int D>
struct DkvSmem {
  static constexpr int BKV = TileCfg<T, D>::DKV_KV;
  static constexpr int NQ = TileCfg<T, D>::DKV_Q;
  static constexpr int LDT = ld_t<T, D>();
  static constexpr int LDS = ld_f<NQ>();
  static constexpr int LDP = ld_p<T, NQ>();
  static constexpr int LDA = ld_f<D>();
  static constexpr bool kAlias = !TensorCore<T>::value;  // fp32: P, dS overwrite S, dP
  static constexpr size_t k_off = 0;
  static constexpr size_t v_off = k_off + sizeof(T) * BKV * LDT;
  static constexpr size_t q_off = v_off + sizeof(T) * BKV * LDT;
  static constexpr size_t do_off = q_off + sizeof(T) * NQ * LDT;
  static constexpr size_t s_off = do_off + sizeof(T) * NQ * LDT;
  static constexpr size_t dp_off = s_off + sizeof(float) * BKV * LDS;
  static constexpr size_t p_off = dp_off + sizeof(float) * BKV * LDS;
  static constexpr size_t p_bytes = kAlias ? 0 : sizeof(T) * BKV * LDP;
  static constexpr size_t ds_off = p_off + p_bytes;
  static constexpr size_t dk_off = ds_off + p_bytes;
  static constexpr size_t dv_off = dk_off + sizeof(float) * BKV * LDA;
  static constexpr size_t lse_off = dv_off + sizeof(float) * BKV * LDA;
  static constexpr size_t delta_off = lse_off + sizeof(float) * NQ;
  static constexpr size_t bytes = delta_off + sizeof(float) * NQ;
  static_assert(bytes <= MAX_SMEM, "dK/dV shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(TileCfg<T, D>::DKV_THREADS) dkv_kernel(const Params p) {
  using S = DkvSmem<T, D>;
  constexpr int BKV = S::BKV, NQ = S::NQ;
  constexpr int RW = TileCfg<T, D>::DKV_RW;
  constexpr int NT = TileCfg<T, D>::DKV_THREADS;
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

  const int b = blockIdx.x / p.kv_heads;
  const int g = blockIdx.x % p.kv_heads;
  const int n_rep = p.heads / p.kv_heads;
  const int kv0 = blockIdx.y * BKV;
  const int kv_rows = min(BKV, p.s_kv - kv0);
  const int q_offset = p.s_kv - p.s_q;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * RW;

  load_tile<T, D, BKV, NT>(sK, static_cast<const T*>(p.k) + b * p.st[K][0] + g * p.st[K][2] +
                                   kv0 * p.st[K][1], p.st[K][1], kv_rows);
  load_tile<T, D, BKV, NT>(sV, static_cast<const T*>(p.v) + b * p.st[V][0] + g * p.st[V][2] +
                                   kv0 * p.st[V][1], p.st[V][1], kv_rows);
  for (int i = threadIdx.x; i < BKV * D; i += NT) {
    sDK[(i / D) * S::LDA + i % D] = 0.0f;
    sDV[(i / D) * S::LDA + i % D] = 0.0f;
  }
  // first q tile whose last row reaches this kv tile
  const int q_start = p.causal ? max(0, kv0 - q_offset) / NQ * NQ : 0;

  for (int hr = 0; hr < n_rep; ++hr) {
    const int h = g * n_rep + hr;
    const long long stat = ((long long)b * p.heads + h) * p.s_q;
    for (int q0 = q_start; q0 < p.s_q; q0 += NQ) {
      __syncthreads();  // the previous q tile is consumed
      const int q_rows = min(NQ, p.s_q - q0);
      load_tile<T, D, NQ, NT>(sQ, static_cast<const T*>(p.q) + b * p.st[Q][0] + h * p.st[Q][2] +
                                      q0 * p.st[Q][1], p.st[Q][1], q_rows);
      load_tile<T, D, NQ, NT>(sDO, static_cast<const T*>(p.dout) + b * p.st[DO][0] +
                                       h * p.st[DO][2] + q0 * p.st[DO][1], p.st[DO][1], q_rows);
      for (int i = threadIdx.x; i < NQ; i += NT) {
        sLse[i] = i < q_rows ? p.lse[stat + q0 + i] : 0.0f;
        sDelta[i] = i < q_rows ? p.delta[stat + q0 + i] : 0.0f;
      }
      __syncthreads();

      mm_abt<T, D, NQ, RW>(sK + r0 * S::LDT, sQ, sST + r0 * S::LDS, p.scale, lane);  // S^T
      mm_abt<T, D, NQ, RW>(sV + r0 * S::LDT, sDO, sDPT + r0 * S::LDS, 1.0f, lane);  // dP^T
      __syncwarp();
      for (int jj = 0; jj < RW; ++jj) {
        const int j = r0 + jj;
        const int col = kv0 + j;
        for (int i = lane; i < NQ; i += 32) {
          const bool ok = i < q_rows && col < p.s_kv &&
                          (!p.causal || col <= q0 + i + q_offset);
          const float pr = ok ? expf(sST[j * S::LDS + i] - sLse[i]) : 0.0f;
          const float ds = pr * (sDPT[j * S::LDS + i] - sDelta[i]) * p.scale;
          sPT[j * S::LDP + i] = from_float<T>(pr);
          sDST[j * S::LDP + i] = from_float<T>(ds);
        }
      }
      __syncwarp();
      mm_ab_acc<T, D, NQ, RW>(sPT + r0 * S::LDP, sDO, sDV + r0 * S::LDA, lane);   // dV += P^T dO
      mm_ab_acc<T, D, NQ, RW>(sDST + r0 * S::LDP, sQ, sDK + r0 * S::LDA, lane);   // dK += dS^T Q
    }
  }
  __syncthreads();

  T* dkg = static_cast<T*>(p.dk) + b * p.st[DK][0] + g * p.st[DK][2] + kv0 * p.st[DK][1];
  T* dvg = static_cast<T*>(p.dv) + b * p.st[DV][0] + g * p.st[DV][2] + kv0 * p.st[DV][1];
  for (int i = threadIdx.x; i < kv_rows * D; i += NT) {
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

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using C = TileCfg<T, D>;
  const long long rows = (long long)batch * p.s_q * p.heads;
  delta_kernel<T, D><<<(unsigned)((rows + DELTA_WARPS - 1) / DELTA_WARPS), DELTA_WARPS * 32, 0,
                       stream>>>(p, batch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = opt_in(dq_kernel<T, D>, DqSmem<T, D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 dq_grid(batch * p.heads, (p.s_q + C::DQ_Q - 1) / C::DQ_Q);
  dq_kernel<T, D><<<dq_grid, C::DQ_THREADS, DqSmem<T, D>::bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  err = opt_in(dkv_kernel<T, D>, DkvSmem<T, D>::bytes);
  if (err != cudaSuccess) return err;
  const dim3 dkv_grid(batch * p.kv_heads, (p.s_kv + C::DKV_KV - 1) / C::DKV_KV);
  dkv_kernel<T, D><<<dkv_grid, C::DKV_THREADS, DkvSmem<T, D>::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const Params& p, int batch, int head_dim, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 80: return launch<T, 80>(p, batch, stream);
    case 96: return launch<T, 96>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. `strides` holds 24 element
// strides: (batch, seq, head) of q, k, v, o, dout, dq, dk, dv in that order;
// the last dimension of every tensor is contiguous. lse and delta are
// contiguous [batch, heads, s_q] fp32 (delta is scratch the call fills).
// Returns a cudaError_t.
extern "C" int ds_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* delta, void* dq, void* dk, void* dv, int dtype, int batch,
    int heads, int kv_heads, int s_q, int s_kv, int head_dim, const long long* strides,
    float scale, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || s_q <= 0 ||
      s_kv <= 0 || (causal && s_q > s_kv))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.s_q = s_q;
  p.s_kv = s_kv;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) p.st[t][j] = strides[3 * t + j];
  p.scale = scale;
  p.causal = causal;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_d<float>(p, batch, head_dim, st); break;
    case 1: err = launch_d<__half>(p, batch, head_dim, st); break;
    case 2: err = launch_d<__nv_bfloat16>(p, batch, head_dim, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}

// ===================================================================================
// The wgmma route: bf16 / fp16 at head_dim 64, 80, 96, 128 and 256, on TMA and wgmma: the
// kernels of csrc/flash_bwd_sm90.cuh (a delta / lse2 pass, the dQ kernel and
// the dK/dV kernel, every accumulator in registers) over the dense causal
// range, the longest rows first. The block-sparse backward runs the same
// kernels over its layout's lists.
// ===================================================================================

#include "flash_bwd_sm90.cuh"

namespace {

template <typename T>
cudaError_t launch_wgmma(const void* const* ptr, const flash_bwd_sm90::Args& a, int batch,
                         int head_dim, cudaStream_t s) {
  namespace fb = flash_bwd_sm90;
  const fb::NoParams none{};
  switch (head_dim) {
    case 64: return fb::launch<T, 64, fb::DenseDq, fb::DenseDkv>(ptr, a, batch, none, none, s);
    case 80: return fb::launch<T, 80, fb::DenseDq, fb::DenseDkv>(ptr, a, batch, none, none, s);
    case 96: return fb::launch<T, 96, fb::DenseDq, fb::DenseDkv>(ptr, a, batch, none, none, s);
    case 128: return fb::launch<T, 128, fb::DenseDq, fb::DenseDkv>(ptr, a, batch, none, none, s);
    case 256: return fb::launch<T, 256, fb::DenseDq, fb::DenseDkv>(ptr, a, batch, none, none, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The wgmma route: dtype 1 = float16, 2 = bfloat16; head_dim 64, 80, 96, 128 or 256; the
// arguments as ds_flash_attention_bwd's, except that `scratch` is the
// caller's fp32 buffer of 2 * batch * heads * s_pad floats, s_pad = s_q
// rounded up to a multiple of 128 (lse2 rows, then delta rows), which the
// call fills. Every stride a multiple of 8 elements, every base 16-byte
// aligned (TMA). Returns a cudaError_t; what the route does not take is
// cudaErrorInvalidValue.
extern "C" int ds_flash_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o, const void* dout,
    const float* lse, float* scratch, void* dq, void* dk, void* dv, int dtype, int batch,
    int heads, int kv_heads, int s_q, int s_kv, int head_dim, const long long* strides,
    float scale, int causal, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || s_q <= 0 ||
      s_kv <= 0 || (causal && s_q > s_kv))
    return (int)cudaErrorInvalidValue;
  namespace fb = flash_bwd_sm90;
  fb::Args a;
  a.s_pad = (s_q + fb::PAD - 1) / fb::PAD * fb::PAD;
  const long long rows = (long long)batch * heads * a.s_pad;
  a.lse = lse;
  a.lse2 = scratch;
  a.delta = scratch + rows;
  a.dq = dq;
  a.dk = dk;
  a.dv = dv;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.s_q = s_q;
  a.s_kv = s_kv;
  for (int t = 0; t < 8; ++t)
    for (int j = 0; j < 3; ++j) a.st[t][j] = strides[3 * t + j];
  a.scale = scale;
  a.causal = causal;
  const void* ptr[8] = {q, k, v, o, dout, dq, dk, dv};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) err = launch_wgmma<__half>(ptr, a, batch, head_dim, s);
  if (dtype == 2) err = launch_wgmma<__nv_bfloat16>(ptr, a, batch, head_dim, s);
  return (int)err;
}
