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
// attention_route): the wgmma route for bf16 and fp16 at head_dim 64 and 128
// (the second half of this file, ds_flash_attention_bwd_wgmma) and the wmma
// route below (ds_flash_attention_bwd) for the rest.
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
// The wgmma route: bf16 / fp16 at head_dim 64 and 128, on TMA and wgmma.
//
// Three kernels in one call, as above, with every accumulator in registers:
//   * prep_kernel: per (b*h, row) of a q length padded to 128, delta = rowsum(dO * O)
//     in fp32 and lse2 = lse * log2(e); padded rows get lse2 = +inf and
//     delta = 0, so their P is exactly 0 wherever it is recomputed;
//   * dq_wgmma_kernel: one block per (b*h, 128-row q tile), two consumer
//     warpgroups of 64 q rows and a producer warpgroup (one thread issues
//     the loads; setmaxnreg hands its registers to the consumers, 24 a
//     thread against their 240). Q and dO are loaded once by TMA; the
//     64-row K and V tiles up to the causal diagonal stream through a
//     3-stage mbarrier ring. Per tile t: S_t = Q K_t^T and dP_t = dO V_t^T by
//     wgmma (A and B from shared memory, K-major) are issued together with
//     the previous tile's dQ += dS_{t-1} K_{t-1} (A = dS from registers, B =
//     the K tile read MN-major); once S_t and dP_t are done, P = exp2(S scale
//     log2 e - lse2) and dS = P (dP - delta) scale are computed in registers
//     while that product runs, and dS is rounded to q's type. A tile's K is
//     read until the next tile's products, hence the third stage;
//   * dkv_wgmma_kernel: one block per (b*kv_heads, 128-row kv tile), two
//     consumer warpgroups of 64 kv rows and a producer warpgroup. K and V are
//     loaded once; the q tiles (64 rows at head_dim 64, 32 at 128, which keeps
//     dK and dV in registers) of every query head of the kv head's group,
//     from the causal diagonal on, stream through a 3-stage ring with their
//     lse2 and delta rows (bulk copies). Per q tile n: S^T_n = K Q_n^T and
//     dP^T_n = V dO_n^T (K-major, shared memory) are issued together with
//     the previous tile's dV += P^T dO (P^T rounded to dO's type) and
//     dK += dS^T Q (A from registers, B = dO, Q read MN-major); P^T_n and
//     dS^T_n are computed in registers, with lse2 and delta read per column,
//     while those run.
// Nothing is transposed in memory, there are no atomics (the result does not
// depend on the launch), and each output is rounded once.
// ===================================================================================

#include "sm90_utils.cuh"

namespace wg_route {

using namespace sm90;

constexpr int CONSUMERS = 2;                        // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * 128;      // + the producer warpgroup
// registers a thread after the producer warpgroup gives up its share:
// 128 x 24 + 256 x 240 <= 65536
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int PAD = 128;                            // the q length of lse2 / delta rows
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct DqCfg {
  static constexpr int BQ = 64 * CONSUMERS;
  static constexpr int BKV = 64;
  static constexpr int STAGES = 3;   // tile t's K is read until tile t + 1's products
  static constexpr int PANELS = D / 64;
  static constexpr int Q_BYTES = BQ * D * 2;        // one of the Q, dO tiles
  static constexpr int KV_BYTES = BKV * D * 2;      // one of the K, V tiles
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int do_off = Q_BYTES;
  static constexpr int kv_off = 2 * Q_BYTES;
  static constexpr int bar_off = kv_off + STAGES * STAGE_BYTES;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(bytes <= 232448, "wgmma dQ shared memory");
};

template <int D>
struct DkvCfg {
  static constexpr int BKV = 64 * CONSUMERS;
  static constexpr int BQ = D == 64 ? 64 : 32;
  static constexpr int STAGES = 3;   // q tile n is read until q tile n + 1's products
  static constexpr int PANELS = D / 64;
  static constexpr int KV_BYTES = BKV * D * 2;      // one of the K, V tiles
  static constexpr int QT_BYTES = BQ * D * 2;       // one of the Q, dO tiles
  static constexpr int TX_BYTES = 2 * QT_BYTES + 2 * BQ * 4;   // + lse2 and delta rows
  static constexpr int STAGE_BYTES = (TX_BYTES + 1023) / 1024 * 1024;
  static constexpr int v_off = KV_BYTES;
  static constexpr int st_off = 2 * KV_BYTES;
  static constexpr int bar_off = st_off + STAGES * STAGE_BYTES;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(bytes <= 232448, "wgmma dK/dV shared memory");
};

struct Args {
  const float* lse;   // [b, heads, s_q]
  float* lse2;        // [b * heads, s_pad]
  float* delta;       // [b * heads, s_pad]
  void* dq;
  void* dk;
  void* dv;
  int heads, kv_heads, s_q, s_kv, s_pad;
  long long st[8][3];
  float scale;
  int causal;
};

enum { T_Q = 0, T_K = 1, T_V = 2, T_O = 3, T_DO = 4, T_DQ = 5, T_DK = 6, T_DV = 7 };

template <typename T, int D>
__global__ void __launch_bounds__(128) prep_kernel(const T* o, const T* dout, const Args a,
                                                   long long rows) {
  const long long row = (long long)blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int bh = (int)(row / a.s_pad);
  const int i = (int)(row % a.s_pad);
  if (i >= a.s_q) {
    if (lane == 0) {
      a.lse2[row] = INFINITY;
      a.delta[row] = 0.0f;
    }
    return;
  }
  const int b = bh / a.heads, h = bh % a.heads;
  const T* orow = o + b * a.st[T_O][0] + i * a.st[T_O][1] + h * a.st[T_O][2];
  const T* grow = dout + b * a.st[T_DO][0] + i * a.st[T_DO][1] + h * a.st[T_DO][2];
  float acc = 0.0f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(to_float(orow[c]), to_float(grow[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) {
    a.delta[row] = acc;
    a.lse2[row] = a.lse[(long long)bh * a.s_q + i] * LOG2E;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    dq_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                    __grid_constant__ const CUtensorMap tm_do,
                    __grid_constant__ const CUtensorMap tm_k,
                    __grid_constant__ const CUtensorMap tm_v, const Args a) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_bar = base + C::bar_off;
  const uint32_t full0 = q_bar + 8;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / a.heads;
  const int h = bh % a.heads;
  const int g = h / (a.heads / a.kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int q_offset = a.s_kv - a.s_q;
  int kv_end = a.s_kv;
  if (a.causal) kv_end = min(a.s_kv, q0 + min(BQ, a.s_q - q0) + q_offset);
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS * 4 && lane == 0) {
      mbar_expect_tx(q_bar, 2 * C::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::PANELS; ++pn) {
        tma_load_4d(base + pn * BQ * 128, &tm_q, q_bar, 64 * pn, q0, h, b);
        tma_load_4d(base + C::do_off + pn * BQ * 128, &tm_do, q_bar, 64 * pn, q0, h, b);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        if (t >= STAGES) mbar_wait(empty0 + 8 * st, (uint32_t)(t / STAGES + 1) & 1u);
        const uint32_t kd = base + C::kv_off + st * C::STAGE_BYTES;
        mbar_expect_tx(full0 + 8 * st, C::STAGE_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::PANELS; ++pn) {
          tma_load_4d(kd + pn * BKV * 128, &tm_k, full0 + 8 * st, 64 * pn, t * BKV, g, b);
          tma_load_4d(kd + C::KV_BYTES + pn * BKV * 128, &tm_v, full0 + 8 * st, 64 * pn,
                      t * BKV, g, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);
  const float sl2 = a.scale * LOG2E;
  const int wg_first_row = q0 + wg * 64;
  const long long stat = (long long)bh * a.s_pad + row0;   // rows < s_pad: q0 + 128 <= s_pad
  const float lse2[2] = {a.lse2[stat], a.lse2[stat + 8]};
  const float delta[2] = {a.delta[stat], a.delta[stat + 8]};

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;
  float s[BKV / 2], dp[BKV / 2];
  uint32_t pa[BKV / 16][4];   // dS of the previous tile, wgmma's A operand
  const uint32_t qa = base + wg * 64 * 128;
  const uint32_t da = base + C::do_off + wg * 64 * 128;

  // S_t and dP_t
  const auto issue_sdp = [&](int t) {
    const uint32_t kd = base + C::kv_off + (t % STAGES) * C::STAGE_BYTES;
    const uint32_t vd = kd + C::KV_BYTES;
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dq);
    fence_regs(pa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV, T>(s, sw128_desc(qa + (kk >> 2) * BQ * 128 + 32 * (kk & 3)),
                       sw128_desc(kd + (kk >> 2) * BKV * 128 + 32 * (kk & 3)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BKV, T>(dp, sw128_desc(da + (kk >> 2) * BQ * 128 + 32 * (kk & 3)),
                       sw128_desc(vd + (kk >> 2) * BKV * 128 + 32 * (kk & 3)), kk > 0);
    wgmma_commit();
  };
  // dQ += dS_t K_t, dS_t in pa
  const auto issue_dq = [&](int t) {
    const uint32_t kd = base + C::kv_off + (t % STAGES) * C::STAGE_BYTES;
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_rs<D, T>(dq, pa[kk], sw128_mn_desc(kd + kk * 2048, BKV * 128), 1);
    wgmma_commit();
  };
  // S_t, dP_t (waited for) -> dS_t in s
  const auto grads = [&](int t) {
    const int kv0 = t * BKV;
    const bool mask = kv0 + BKV > a.s_kv ||
                      (a.causal && kv0 + BKV - 1 > wg_first_row + q_offset);
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * hh + e;
          float pr = fast_exp2(fmaf(s[idx], sl2, -lse2[hh]));
          if (mask) {
            const int col = kv0 + 8 * j + cq + e;
            if (col >= a.s_kv || (a.causal && col > row0 + 8 * hh + q_offset)) pr = 0.0f;
          }
          s[idx] = pr * (dp[idx] - delta[hh]) * a.scale;   // dS
        }
  };
  const auto release = [&](int t) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (t % STAGES));
  };

  mbar_wait(q_bar, 0);
  // tile 0: S, dP and dS
  mbar_wait(full0, 0);
  issue_sdp(0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grads(0);
#pragma unroll
  for (int kk = 0; kk < BKV / 16; ++kk) pack_a<T>(pa[kk], s, kk);
  for (int t = 1; t < n_tiles; ++t) {
    mbar_wait(full0 + 8 * (t % STAGES), (uint32_t)(t / STAGES) & 1u);
    issue_sdp(t);
    issue_dq(t - 1);
    wgmma_wait<1>();   // S_t and dP_t are done; dS_{t-1} K_{t-1} may still run
    fence_regs(s);
    fence_regs(dp);
    grads(t);
    wgmma_wait<0>();
    fence_regs(dq);
    fence_regs(pa);
    release(t - 1);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) pack_a<T>(pa[kk], s, kk);
  }
  fence_regs(dq);
  fence_regs(pa);
  wgmma_fence();
  issue_dq(n_tiles - 1);
  wgmma_wait<0>();
  fence_regs(dq);
  fence_regs(pa);

  T* dqg = static_cast<T*>(a.dq) + b * a.st[T_DQ][0] + h * a.st[T_DQ][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = row0 + 8 * hh;
    if (row < a.s_q) {
      T* r = dqg + row * a.st[T_DQ][1] + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(r + 8 * j) =
            pack2<T>(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_wgmma_kernel(__grid_constant__ const CUtensorMap tm_k,
                     __grid_constant__ const CUtensorMap tm_v,
                     __grid_constant__ const CUtensorMap tm_q,
                     __grid_constant__ const CUtensorMap tm_do, const Args a) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t kv_bar = base + C::bar_off;
  const uint32_t full0 = kv_bar + 8;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / a.kv_heads;
  const int g = blockIdx.x % a.kv_heads;
  const int n_rep = a.heads / a.kv_heads;
  const int kv0 = blockIdx.y * BKV;
  const int q_offset = a.s_kv - a.s_q;
  // the first q tile whose last row reaches this kv tile
  const int q_start = a.causal ? max(0, kv0 - q_offset) / BQ * BQ : 0;
  const int n_q = q_start < a.s_q ? (a.s_q - q_start + BQ - 1) / BQ : 0;
  const int n_iter = n_rep * n_q;

  if (threadIdx.x == 0) {
    mbar_init(kv_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS * 4 && lane == 0) {
      mbar_expect_tx(kv_bar, 2 * C::KV_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::PANELS; ++pn) {
        tma_load_4d(base + pn * BKV * 128, &tm_k, kv_bar, 64 * pn, kv0, g, b);
        tma_load_4d(base + C::v_off + pn * BKV * 128, &tm_v, kv_bar, 64 * pn, kv0, g, b);
      }
      for (int n = 0; n < n_iter; ++n) {
        const int st = n % STAGES;
        const int h = g * n_rep + n / n_q;
        const int q0 = q_start + (n % n_q) * BQ;
        if (n >= STAGES) mbar_wait(empty0 + 8 * st, (uint32_t)(n / STAGES + 1) & 1u);
        const uint32_t sd = base + C::st_off + st * C::STAGE_BYTES;
        const uint32_t bar = full0 + 8 * st;
        mbar_expect_tx(bar, C::TX_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::PANELS; ++pn) {
          tma_load_4d(sd + pn * BQ * 128, &tm_q, bar, 64 * pn, q0, h, b);
          tma_load_4d(sd + C::QT_BYTES + pn * BQ * 128, &tm_do, bar, 64 * pn, q0, h, b);
        }
        const long long stat = ((long long)b * a.heads + h) * a.s_pad + q0;
        bulk_load(sd + 2 * C::QT_BYTES, a.lse2 + stat, BQ * 4, bar);
        bulk_load(sd + 2 * C::QT_BYTES + BQ * 4, a.delta + stat, BQ * 4, bar);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2;
  const int krow0 = kv0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows +0, +8
  const int cq = 2 * (lane & 3);
  const float sl2 = a.scale * LOG2E;
  const int wg_last_row = kv0 + wg * 64 + 63;
  const uint32_t ka = base + wg * 64 * 128;
  const uint32_t va = base + C::v_off + wg * 64 * 128;

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }

  float s[BQ / 2], dp[BQ / 2];
  uint32_t pp[BQ / 16][4], pd[BQ / 16][4];   // P^T and dS^T of the previous q tile
  // S^T_n and dP^T_n
  const auto issue_sdp = [&](int n) {
    const uint32_t qd = base + C::st_off + (n % STAGES) * C::STAGE_BYTES;
    const uint32_t dod = qd + C::QT_BYTES;
    fence_regs(s);
    fence_regs(dp);
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pp);
    fence_regs(pd);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, T>(s, sw128_desc(ka + (kk >> 2) * BKV * 128 + 32 * (kk & 3)),
                      sw128_desc(qd + (kk >> 2) * BQ * 128 + 32 * (kk & 3)), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss<BQ, T>(dp, sw128_desc(va + (kk >> 2) * BKV * 128 + 32 * (kk & 3)),
                      sw128_desc(dod + (kk >> 2) * BQ * 128 + 32 * (kk & 3)), kk > 0);
    wgmma_commit();
  };
  // dV += P^T_n dO_n and dK += dS^T_n Q_n, from pp and pd
  const auto issue_dkv = [&](int n) {
    const uint32_t qd = base + C::st_off + (n % STAGES) * C::STAGE_BYTES;
    const uint32_t dod = qd + C::QT_BYTES;
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D, T>(dv, pp[kk], sw128_mn_desc(dod + kk * 2048, BQ * 128), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      wgmma_rs<D, T>(dk, pd[kk], sw128_mn_desc(qd + kk * 2048, BQ * 128), 1);
    wgmma_commit();
  };
  // S^T_n, dP^T_n (waited for) -> P^T_n in s, dS^T_n in dp; lse2 and delta
  // per column from the stage
  const auto grads = [&](int n) {
    const int q0 = q_start + (n % n_q) * BQ;
    const float* stats = reinterpret_cast<const float*>(
        smem + C::st_off + (n % STAGES) * C::STAGE_BYTES + 2 * C::QT_BYTES);
    const bool mask = a.causal && wg_last_row > q0 + q_offset;
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(stats + 8 * j + cq);
      const float2 dl = *reinterpret_cast<const float2*>(stats + BQ + 8 * j + cq);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * hh + e;
          float pr = fast_exp2(fmaf(s[idx], sl2, -(e ? l2.y : l2.x)));
          if (mask && krow0 + 8 * hh > q0 + 8 * j + cq + e + q_offset) pr = 0.0f;
          dp[idx] = pr * (dp[idx] - (e ? dl.y : dl.x)) * a.scale;   // dS^T
          s[idx] = pr;                                               // P^T
        }
    }
  };
  const auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      pack_a<T>(pp[kk], s, kk);
      pack_a<T>(pd[kk], dp, kk);
    }
  };
  const auto release = [&](int n) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (n % STAGES));
  };

  mbar_wait(kv_bar, 0);
  // q tile 0: S^T, dP^T, P^T and dS^T
  mbar_wait(full0, 0);
  issue_sdp(0);
  wgmma_wait<0>();
  fence_regs(s);
  fence_regs(dp);
  grads(0);
  pack();
  for (int n = 1; n < n_iter; ++n) {
    mbar_wait(full0 + 8 * (n % STAGES), (uint32_t)(n / STAGES) & 1u);
    issue_sdp(n);
    issue_dkv(n - 1);
    wgmma_wait<1>();   // S^T_n and dP^T_n are done; tile n - 1's dV and dK may still run
    fence_regs(s);
    fence_regs(dp);
    grads(n);
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pp);
    fence_regs(pd);
    release(n - 1);
    pack();
  }
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(pp);
  fence_regs(pd);
  wgmma_fence();
  issue_dkv(n_iter - 1);
  wgmma_wait<0>();
  fence_regs(dv);
  fence_regs(dk);
  fence_regs(pp);
  fence_regs(pd);

  T* dkg = static_cast<T*>(a.dk) + b * a.st[T_DK][0] + g * a.st[T_DK][2];
  T* dvg = static_cast<T*>(a.dv) + b * a.st[T_DV][0] + g * a.st[T_DV][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = krow0 + 8 * hh;
    if (row < a.s_kv) {
      T* rk = dkg + row * a.st[T_DK][1] + cq;
      T* rv = dvg + row * a.st[T_DV][1] + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        *reinterpret_cast<uint32_t*>(rk + 8 * j) =
            pack2<T>(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(rv + 8 * j) =
            pack2<T>(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* const* ptr, const Args& a, int batch, cudaStream_t stream) {
  using CQ = DqCfg<D>;
  using CKV = DkvCfg<D>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // runtime calls first: they make the device's context current on this
  // thread (autograd runs the backward on a thread of its own), which
  // encoding a tensor map through the driver needs
  auto dqk = dq_wgmma_kernel<T, D>;
  auto dkvk = dkv_wgmma_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         CQ::bytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(dkvk, cudaFuncAttributeMaxDynamicSharedMemorySize, CKV::bytes);
  if (err != cudaSuccess) return err;
  const auto map = [&](CUtensorMap* m, int t, int seq, int heads, int rows) {
    return encode_bshd(m, type, ptr[t], batch, seq, heads, D, a.st[t][0], a.st[t][1], a.st[t][2],
                       rows);
  };
  CUtensorMap dq_q, dq_do, dq_k, dq_v, kv_k, kv_v, kv_q, kv_do;
  if (!map(&dq_q, T_Q, a.s_q, a.heads, CQ::BQ) || !map(&dq_do, T_DO, a.s_q, a.heads, CQ::BQ) ||
      !map(&dq_k, T_K, a.s_kv, a.kv_heads, CQ::BKV) ||
      !map(&dq_v, T_V, a.s_kv, a.kv_heads, CQ::BKV) ||
      !map(&kv_k, T_K, a.s_kv, a.kv_heads, CKV::BKV) ||
      !map(&kv_v, T_V, a.s_kv, a.kv_heads, CKV::BKV) ||
      !map(&kv_q, T_Q, a.s_q, a.heads, CKV::BQ) || !map(&kv_do, T_DO, a.s_q, a.heads, CKV::BQ))
    return cudaErrorInvalidValue;

  const long long rows = (long long)batch * a.heads * a.s_pad;
  prep_kernel<T, D><<<(unsigned)((rows + 3) / 4), 128, 0, stream>>>(
      static_cast<const T*>(ptr[T_O]), static_cast<const T*>(ptr[T_DO]), a, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dqk<<<dim3(batch * a.heads, (a.s_q + CQ::BQ - 1) / CQ::BQ), THREADS, CQ::bytes, stream>>>(
      dq_q, dq_do, dq_k, dq_v, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dkvk<<<dim3(batch * a.kv_heads, (a.s_kv + CKV::BKV - 1) / CKV::BKV), THREADS, CKV::bytes,
         stream>>>(kv_k, kv_v, kv_q, kv_do, a);
  return cudaGetLastError();
}

}  // namespace wg_route

// The wgmma route: dtype 1 = float16, 2 = bfloat16; head_dim 64 or 128; the
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
  wg_route::Args a;
  a.s_pad = (s_q + wg_route::PAD - 1) / wg_route::PAD * wg_route::PAD;
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
  if (dtype == 1 && head_dim == 64) err = wg_route::launch<__half, 64>(ptr, a, batch, s);
  if (dtype == 1 && head_dim == 128) err = wg_route::launch<__half, 128>(ptr, a, batch, s);
  if (dtype == 2 && head_dim == 64) err = wg_route::launch<__nv_bfloat16, 64>(ptr, a, batch, s);
  if (dtype == 2 && head_dim == 128) err = wg_route::launch<__nv_bfloat16, 128>(ptr, a, batch, s);
  return (int)err;
}
