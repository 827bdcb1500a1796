// Flash-attention forward for Hopper (sm_90a), bf16 / fp16 / fp32.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/flash_attention.py:
// _fwd_kernel_single (pallas_call in _flash_fwd_single, one kv tile covers
// s_kv) and _fwd_kernel (pallas_call in _flash_fwd, online softmax over a
// sequential grid of kv tiles with an (m, l, acc) scratch triple). Here one
// kernel covers both: a loop over kv tiles inside the block takes the place of
// the TPU's sequential grid axis, so nothing carries over between blocks.
//
// out[b, i, h, :] = softmax_j(scale * q[b, i, h, :] . k[b, j, g(h), :]) v[b, j, g(h), :]
// with g(h) = h / (heads / kv_heads) (GQA reads the unrepeated kv heads) and,
// when causal, j <= i + (s_kv - s_q): the mask is aligned to the bottom right,
// as the TPU kernel's q_offset is. Inputs are [b, s, h, d] read through the
// strides the caller gives (the last dimension contiguous); any s_q, s_kv are
// masked in-kernel; head_dim is 32, 64, 80, 96, 128 or 256 (every width of
// the model registry's presets; each a multiple of 16, as wmma needs).
//
// What bounds it on an H100 SXM: operations 4 * b * h * d * (allowed (i, j)
// pairs) -- about 4*b*h*s_q*s_kv*d, halved when causal -- at 989 TFLOP/s in
// bf16/fp16 tensor cores (67 TFLOP/s fp32 without them), against the bytes of
// q, k, v and o at 3.35 TB/s. At the prefill shapes of the serving path
// (s >= 128, d = 128) the operations dominate by far: the kernel is bound by
// operations, and the design keeps every s_q x s_kv intermediate on chip.
//
// Two routes, picked by the caller as a pure function of dtype and head_dim
// (ops/cuda/flash_attention.py attention_route): the wgmma route (bf16 and
// fp16 at head_dim 64, 80, 96, 128 and 256, the widths of every main path;
// the kernel of csrc/flash_fwd_sm90.cuh, ds_flash_attention_fwd_wgmma at the
// end of this file) and the wmma route below (ds_flash_attention_fwd: fp32,
// and 16-bit at head_dim 32).
//
// The wmma route's design (a simple right kernel):
//   * one thread block of 4 warps per (batch*head, 64-row q tile); the q tile
//     is staged in shared memory once;
//   * 64-row K and V tiles (32-row for fp32 at head_dim 256, whose q, k, v
//     and fp32 O tiles would otherwise pass the 227 KB a block can have) are
//     staged through shared memory with 16-byte loads, rows past s_kv
//     zero-filled; tiles wholly above the causal diagonal are never loaded;
//   * each warp owns 16 q rows end to end: S = Q K^T with warp-level tensor-core
//     MMA (nvcuda::wmma, 16x16x16, fp32 accumulate) for bf16/fp16, with fp32
//     FMAs for fp32 inputs (each lane owns the columns lane + 32 c, the last
//     group masked where head_dim is not a multiple of 32, as at 80 and 96,
//     at most 4 groups at a time to bound the registers); an online softmax
//     in fp32 (row max and sum by warp shuffles) masks the ragged tail and
//     the diagonal; P is rounded to the
//     input type (as the TPU kernel's p.astype(v.dtype)) and O += P V
//     accumulates in an fp32 tile in shared memory;
//   * the last step divides by the row sum and writes o in the input type and,
//     when the caller passes an lse buffer (the training forward, whose
//     backward recomputes P from it), lse = m + log(l) in fp32 per row, as the
//     TPU kernel emits under its vjp (there lane-broadcast, here [b, h, s_q]).
// The C entry point launches on the caller's stream, does not synchronise and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BQ = 64;                      // q rows per block
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS_PER_WARP = BQ / WARPS;   // 16: one MMA row block per warp

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T> struct TensorCore { static constexpr bool value = false; };
template <> struct TensorCore<__half> { static constexpr bool value = true; };
template <> struct TensorCore<__nv_bfloat16> { static constexpr bool value = true; };

// kv rows per tile: 64, or 32 for fp32 at head_dim 256
template <typename T, int D>
__host__ __device__ constexpr int kv_tile() { return sizeof(T) == 4 && D > 128 ? 32 : 64; }

// Shared-memory layout. Row strides are padded by 16 bytes: rows stay 16-byte
// aligned for the vector copies, every 16x16 MMA fragment starts on a 32-byte
// boundary, and wmma's ldm rules hold (a multiple of 8 elements for 16-bit
// types, of 4 for fp32).
template <typename T, int D>
struct Smem {
  static constexpr int BKV = kv_tile<T, D>();
  static constexpr int LD_T = D + 16 / (int)sizeof(T);   // q, k, v rows
  static constexpr int LD_S = BKV + 4;                   // fp32 logits / fp32 P
  static constexpr int LD_P = BKV + 8;                   // 16-bit P
  static constexpr int LD_O = D + 4;                     // fp32 output accumulator
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * BQ * LD_T;
  static constexpr size_t v_off = k_off + sizeof(T) * BKV * LD_T;
  static constexpr size_t s_off = v_off + sizeof(T) * BKV * LD_T;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LD_S;
  static constexpr size_t p_bytes = TensorCore<T>::value ? sizeof(T) * BQ * LD_P : 0;
  static constexpr size_t o_off = p_off + p_bytes;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LD_O;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * BQ;
  static_assert(bytes <= 232448, "forward shared memory");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // [b, heads, s_q] fp32, or null when the caller needs no lse
  int heads, kv_heads, s_q, s_kv;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

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

// Copy ROWS_N x D elements (rows 16-byte aligned in global memory) into a
// shared tile; rows >= rows_valid are zero-filled.
template <typename T, int D, int ROWS_N>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long row_stride,
                                          int rows_valid) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = D / VEC;
  for (int i = threadIdx.x; i < ROWS_N * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows_valid) val = *reinterpret_cast<const uint4*>(src + r * row_stride + c);
    *reinterpret_cast<uint4*>(dst + r * Smem<T, D>::LD_T + c) = val;
  }
}

// S[r0:r0+16, :] = scale * Q[r0:r0+16, :] K^T with tensor cores.
template <typename T, int D>
__device__ __forceinline__ void scores_mma(const T* sQ, const T* sK, float* sS, int r0,
                                           float scale) {
  using S = Smem<T, D>;
  constexpr int BKV = S::BKV;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BKV / 16];
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
    wmma::load_matrix_sync(a, sQ + r0 * S::LD_T + kk, S::LD_T);
#pragma unroll
    for (int j = 0; j < BKV / 16; ++j) {
      // K^T as a column-major B operand: element (k, n) is sK[n][k]
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
      wmma::load_matrix_sync(b, sK + (16 * j) * S::LD_T + kk, S::LD_T);
      wmma::mma_sync(acc[j], a, b, acc[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < BKV / 16; ++j) {
#pragma unroll
    for (int e = 0; e < acc[j].num_elements; ++e) acc[j].x[e] *= scale;
    wmma::store_matrix_sync(sS + r0 * S::LD_S + 16 * j, acc[j], S::LD_S, wmma::mem_row_major);
  }
}

// O[r0:r0+16, :] += P[r0:r0+16, :] V with tensor cores.
template <typename T, int D>
__device__ __forceinline__ void pv_mma(const T* sP, const T* sV, float* sO, int r0) {
  using S = Smem<T, D>;
  constexpr int BKV = S::BKV;
#pragma unroll
  for (int n = 0; n < D; n += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, sO + r0 * S::LD_O + n, S::LD_O, wmma::mem_row_major);
#pragma unroll
    for (int kk = 0; kk < BKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
      wmma::load_matrix_sync(a, sP + r0 * S::LD_P + kk, S::LD_P);
      wmma::load_matrix_sync(b, sV + kk * S::LD_T + n, S::LD_T);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sO + r0 * S::LD_O + n, acc, S::LD_O, wmma::mem_row_major);
  }
}

// fp32 inputs: the same two products with FMAs (full fp32, no TF32). Lane
// owns kv columns lane + 32 j of the scores and head columns lane + 32 c of
// the output, the last group masked when D is not a multiple of 32.
template <int D>
__device__ __forceinline__ void scores_fma(const float* sQ, const float* sK, float* sS, int r0,
                                           int lane, float scale) {
  using S = Smem<float, D>;
  constexpr int J = S::BKV / 32;
  float acc[ROWS_PER_WARP][J];
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[i][j] = 0.0f;
  for (int k = 0; k < D; ++k) {
    float kv[J];
#pragma unroll
    for (int j = 0; j < J; ++j) kv[j] = sK[(lane + 32 * j) * S::LD_T + k];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const float qv = sQ[(r0 + i) * S::LD_T + k];
#pragma unroll
      for (int j = 0; j < J; ++j) acc[i][j] = fmaf(qv, kv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
    for (int j = 0; j < J; ++j) sS[(r0 + i) * S::LD_S + lane + 32 * j] = acc[i][j] * scale;
}

template <int D>
__device__ __forceinline__ void pv_fma(const float* sP, const float* sV, float* sO, int r0,
                                       int lane) {
  using S = Smem<float, D>;
  constexpr int C_ALL = (D + 31) / 32;
  constexpr int C = C_ALL < 4 ? C_ALL : 4;  // column groups per pass
#pragma unroll
  for (int c0 = 0; c0 < C_ALL; c0 += C) {
    float acc[ROWS_PER_WARP][C];
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) acc[i][c] = 0.0f;
    for (int kk = 0; kk < S::BKV; ++kk) {
      float vv[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * (c0 + c);
        vv[c] = col < D ? sV[kk * S::LD_T + col] : 0.0f;
      }
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const float p = sP[(r0 + i) * S::LD_S + kk];
#pragma unroll
        for (int c = 0; c < C; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
#pragma unroll
    for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int col = lane + 32 * (c0 + c);
        if (col < D) sO[(r0 + i) * S::LD_O + col] += acc[i][c];
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS) flash_fwd_kernel(const Params p) {
  using S = Smem<T, D>;
  constexpr bool kTC = TensorCore<T>::value;
  constexpr int BKV = S::BKV;
  constexpr int J = BKV / 32;  // kv columns per lane in the softmax
  extern __shared__ __align__(128) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem + S::q_off);
  T* sK = reinterpret_cast<T*>(smem + S::k_off);
  T* sV = reinterpret_cast<T*>(smem + S::v_off);
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  T* sP = reinterpret_cast<T*>(smem + S::p_off);
  float* sO = reinterpret_cast<float*>(smem + S::o_off);
  float* sM = reinterpret_cast<float*>(smem + S::m_off);
  float* sL = reinterpret_cast<float*>(smem + S::l_off);

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
  const int r0 = warp * ROWS_PER_WARP;

  const T* qg = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh + q0 * p.q_ss;
  const T* kg = static_cast<const T*>(p.k) + b * p.k_sb + g * p.k_sh;
  const T* vg = static_cast<const T*>(p.v) + b * p.v_sb + g * p.v_sh;

  load_tile<T, D, BQ>(sQ, qg, p.q_ss, q_rows);
  for (int i = threadIdx.x; i < BQ * D; i += THREADS) sO[(i / D) * S::LD_O + i % D] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    sM[i] = -1e30f;
    sL[i] = 0.0f;
  }

  // kv columns any valid row of this tile may see; later tiles are skipped
  int kv_end = p.s_kv;
  if (p.causal) kv_end = min(p.s_kv, q0 + q_rows + q_offset);

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's K/V are consumed
    const int kv_rows = min(BKV, p.s_kv - kv0);
    load_tile<T, D, BKV>(sK, kg + kv0 * p.k_ss, p.k_ss, kv_rows);
    load_tile<T, D, BKV>(sV, vg + kv0 * p.v_ss, p.v_ss, kv_rows);
    __syncthreads();

    if constexpr (kTC) {
      scores_mma<T, D>(sQ, sK, sS, r0, p.scale);
    } else {
      scores_fma<D>(sQ, sK, sS, r0, lane, p.scale);
    }
    __syncwarp();

    // online softmax over this warp's 16 rows; lane owns columns lane + 32 j
    for (int i = 0; i < ROWS_PER_WARP; ++i) {
      const int r = r0 + i;
      const int limit = q0 + r + q_offset;  // last kv index row r may attend to
      float s[J];
      bool ok[J];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        const int col = kv0 + c;
        ok[j] = col < p.s_kv && (!p.causal || col <= limit);
        s[j] = ok[j] ? sS[r * S::LD_S + c] : -INFINITY;
        mx = fmaxf(mx, s[j]);
      }
      mx = warp_max(mx);
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      float pr[J];
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
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
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if constexpr (kTC) {
          sP[r * S::LD_P + c] = from_float<T>(pr[j]);
        } else {
          sS[r * S::LD_S + c] = pr[j];
        }
      }
      for (int c = lane; c < D; c += 32) sO[r * S::LD_O + c] *= corr;
    }
    __syncwarp();

    if constexpr (kTC) {
      pv_mma<T, D>(sP, sV, sO, r0);
    } else {
      pv_fma<D>(sS, sV, sO, r0, lane);
    }
  }
  __syncthreads();

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + q0 * p.o_ss;
  for (int i = threadIdx.x; i < q_rows * D; i += THREADS) {
    const int r = i / D;
    const int c = i % D;
    og[r * p.o_ss + c] = from_float<T>(sO[r * S::LD_O + c] / fmaxf(sL[r], 1e-30f));
  }
  if (p.lse != nullptr) {
    float* lg = p.lse + ((long long)b * p.heads + h) * p.s_q + q0;
    for (int r = threadIdx.x; r < q_rows; r += THREADS) lg[r] = sM[r] + logf(fmaxf(sL[r], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, int batch, cudaStream_t stream) {
  using S = Smem<T, D>;
  // above 48 KB of shared memory a kernel must opt in (per device, so on
  // every launch rather than once per process)
  const cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * p.heads, (p.s_q + BQ - 1) / BQ);
  flash_fwd_kernel<T, D><<<grid, THREADS, S::bytes, stream>>>(p);
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

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements; the
// last dimension of every tensor is contiguous. lse is null or a contiguous
// [batch, heads, s_q] fp32 buffer. Returns a cudaError_t.
extern "C" int ds_flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, int batch, int heads,
    int kv_heads, int s_q, int s_kv, int head_dim, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, float* lse, void* stream) {
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || s_q <= 0 ||
      s_kv <= 0 || (causal && s_q > s_kv))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = lse;
  p.heads = heads;
  p.kv_heads = kv_heads;
  p.s_q = s_q;
  p.s_kv = s_kv;
  p.q_sb = q_sb; p.q_ss = q_ss; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_ss = k_ss; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_ss = v_ss; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_ss = o_ss; p.o_sh = o_sh;
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
// The wgmma route: bf16 / fp16 at head_dim 64, 80, 96, 128 and 256, on TMA and
// wgmma: the kernel of csrc/flash_fwd_sm90.cuh with the dense causal range as
// its tile schedule (DenseFwd). The last q tiles, which carry the most causal
// work, run first, and kv tiles wholly above the causal diagonal are never
// loaded.
// ===================================================================================

#include "flash_fwd_sm90.cuh"

namespace {

template <typename T>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const flash_fwd_sm90::Args& a, int batch, int head_dim,
                         const long long* st, cudaStream_t s) {
  namespace ff = flash_fwd_sm90;
  const ff::NoParams none;
  switch (head_dim) {
    case 64: return ff::launch<T, 64, ff::DenseFwd>(q, k, v, a, batch, st, none, s);
    case 80: return ff::launch<T, 80, ff::DenseFwd>(q, k, v, a, batch, st, none, s);
    case 96: return ff::launch<T, 96, ff::DenseFwd>(q, k, v, a, batch, st, none, s);
    case 128: return ff::launch<T, 128, ff::DenseFwd>(q, k, v, a, batch, st, none, s);
    case 256: return ff::launch<T, 256, ff::DenseFwd>(q, k, v, a, batch, st, none, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The wgmma route: dtype 1 = float16, 2 = bfloat16; head_dim 64, 80, 96, 128
// or 256; the arguments as ds_flash_attention_fwd's (strides in elements,
// every stride a multiple of 8 and every base 16-byte aligned, as TMA needs).
// Returns a cudaError_t; what the route does not take is
// cudaErrorInvalidValue.
extern "C" int ds_flash_attention_fwd_wgmma(
    const void* q, const void* k, const void* v, void* o, int dtype, int batch, int heads,
    int kv_heads, int s_q, int s_kv, int head_dim, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long o_sb, long long o_ss, long long o_sh,
    float scale, int causal, float* lse, void* stream) {
  namespace ff = flash_fwd_sm90;
  if (batch <= 0 || heads <= 0 || kv_heads <= 0 || heads % kv_heads != 0 || s_q <= 0 ||
      s_kv <= 0 || (causal && s_q > s_kv))
    return (int)cudaErrorInvalidValue;
  ff::Args a;
  a.o = o;
  a.lse = lse;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.s_q = s_q;
  a.s_kv = s_kv;
  a.o_sb = o_sb; a.o_ss = o_ss; a.o_sh = o_sh;
  a.scale = scale;
  a.causal = causal;
  const long long st[9] = {q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 1) err = launch_wgmma<__half>(q, k, v, a, batch, head_dim, st, s);
  if (dtype == 2) err = launch_wgmma<__nv_bfloat16>(q, k, v, a, batch, head_dim, st, s);
  return (int)err;
}
