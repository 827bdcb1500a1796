// Weight-only int8 / int4 dequant-matmul for Hopper (sm_90a), bf16 / fp16 / fp32 x.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/quantized_matmul.py:
// _int8_kernel and _int4_kernel (the two pallas_calls of quantized_matmul).
//
//   y[m, n] = sum_k x[m, k] * w[k, n],   w[k, n] = float(q[k, n]) * float(scale[k / g, n])
//
// q is int8 [K, N], or for 4 bits uint8 [K/2, N] with two rows a byte: packed
// row p holds row 2p in its low nibble and row 2p+1 in its high nibble, each
// stored + 8 (ops/quantizer.py pack_int4). scale is [K/g, N] in x's type (the
// model casts its fp32 scales to the compute type, as the JAX model does);
// it is widened to fp32 on load. For bf16 x, w is rounded to bf16 and the
// product runs on the tensor cores (wmma 16x16x16) with fp32 accumulation;
// for fp16 and fp32 x, w stays fp32 and the product is fp32 FMA (the TPU
// kernel's dot_dtype). The sum is cast to x's type.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
//   * decode (m of 1-8): the weight bytes. At m 8, k 4096, n 11008 the int8
//     weights are 45.1 MB plus 1.4 MB of bf16 scales: 13.9 us; int4 24.0 MB:
//     7.1 us (the unquantized bf16 GEMM reads 90 MB: 27 us);
//   * prefill (m 2048): the operations, 2 * 2048 * 4096 * 11008 = 185 GFLOP:
//     0.19 ms.
//
// Design: the simple tiled product. One block per (m tile, n tile) holds its
// fp32 accumulators for the whole k sweep (the TPU grid's sequential k axis
// becomes the block's own loop): 128 x 128 tiles and 8 warps for bf16, 64 x
// 64 and 4 warps for fp16/fp32. Each k step stages an x tile and a
// DEQUANTIZED w tile in shared memory (4 columns per 4-byte weight load):
// the int4 nibbles are unpacked in registers straight into interleaved rows
// (no even/odd split of x as on the TPU), and the group of row r is r / g, so
// any g dividing k is taken, odd ones included. Ragged m, n and k tails are
// masked in the kernel and nothing is padded on the host. When the output
// tiles are too few to fill the card (a short prefill), k is split and the
// fp32 partials are added in order by a second kernel. For m <= 16 (decode)
// a split-k GEMV takes over (below): 4-byte weight loads, each thread 4
// columns, the same partials. Both are simple designs: 16-byte loads, a
// pipelined ring, or wgmma + TMA are later work.
//
// The C entry point launches on the caller's stream, does not synchronise and
// returns the cudaError_t of its launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

template <typename T> __device__ __forceinline__ float to_float(T x);
template <> __device__ __forceinline__ float to_float<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <> __device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// the type the staged tiles hold: bf16 for the tensor cores, else fp32
template <typename T> struct TileType { using type = float; };
template <> struct TileType<__nv_bfloat16> { using type = __nv_bfloat16; };

// The tiled kernel. TC (bf16 x): BM x BN tiles on the tensor cores, WARPS
// warps as 2 x (WARPS / 2), each warp FM x FN wmma fragments; fp16/fp32 x:
// fp32 FMA, each thread one column and every (THREADS / BN)-th row.
// PARTIAL: the block sweeps only k range blockIdx.z (k_per_split rows) and
// writes its fp32 partial [split, m, n]; else it sweeps all of k and writes y.
template <typename T, int BITS, int BM, int BN, int BK, int THREADS, bool PARTIAL>
__global__ void __launch_bounds__(THREADS)
    qmm_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
               const T* __restrict__ scale, T* __restrict__ y, float* __restrict__ partial,
               int M, int N, int K, int group, int k_per_split) {
  using W = typename TileType<T>::type;
  constexpr bool TC = std::is_same<W, __nv_bfloat16>::value;
  constexpr int WARPS = THREADS / 32;
  // tensor-core tiles are padded by 16 bytes a row against bank conflicts;
  // the FMA path reads x by broadcast and w along its rows, and needs none
  constexpr int XLD = TC ? BK + 8 : BK;
  constexpr int WLD = TC ? BN + 8 : BN;
  // the tensor-core path stages each output fragment through a per-warp
  // 16 x 16 fp32 scratch on its way to the masked store
  constexpr int STAGE_BYTES = (int)sizeof(W) * (BM * XLD + BK * WLD);
  constexpr int OUT_BYTES = TC ? (int)sizeof(float) * WARPS * 256 : 0;
  __shared__ __align__(32) unsigned char smem[STAGE_BYTES + OUT_BYTES];
  W* xs = reinterpret_cast<W*>(smem);
  W* ws = xs + BM * XLD;

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  constexpr int WARPS_M = 2;
  constexpr int WARPS_N = WARPS / WARPS_M;
  constexpr int FM = BM / 16 / WARPS_M;
  constexpr int FN = BN / 16 / WARPS_N;
  const int warp = tid >> 5, lane = tid & 31;
  const int wrow = (warp / WARPS_N) * FM * 16, wcol = (warp % WARPS_N) * FN * 16;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc_tc[TC ? FM : 1][TC ? FN : 1];
  if constexpr (TC) {
    for (int i = 0; i < FM; ++i)
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc_tc[i][j], 0.f);
  }
  constexpr int RSTEP = THREADS / BN;
  constexpr int RPT = BM / RSTEP;
  float acc[TC ? 1 : RPT];
  if constexpr (!TC) {
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  }

  // weight staging: each thread dequantizes 4 adjacent columns of a row
  // from one 4-byte load (bytes one by one on a ragged or unaligned edge)
  constexpr int QUADS = BN / 4;
  const bool vec_n = N % 4 == 0;
  const int k_begin = PARTIAL ? blockIdx.z * k_per_split : 0;
  const int k_end = PARTIAL ? min(K, k_begin + k_per_split) : K;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // stage x [BM, BK]: consecutive threads read consecutive k
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int gm = m0 + r, gk = k0 + c;
      const float v = (gm < M && gk < k_end) ? to_float<T>(x[(long long)gm * K + gk]) : 0.f;
      xs[r * XLD + c] = from_float<W>(v);
    }
    // stage the dequantized w [BK, BN]
    for (int e = tid; e < BK * QUADS; e += THREADS) {
      const int r = e / QUADS, c = (e % QUADS) * 4;
      const int gk = k0 + r, gn = n0 + c;
      float w[4] = {0.f, 0.f, 0.f, 0.f};
      if (gk < k_end && gn < N) {
        const long long qrow = BITS == 4 ? (long long)(gk >> 1) * N : (long long)gk * N;
        uint32_t packed = 0;
        if (vec_n && gn + 3 < N) {
          packed = *reinterpret_cast<const uint32_t*>(q + qrow + gn);
        } else {
          for (int j = 0; j < 4; ++j)
            if (gn + j < N) packed |= (uint32_t)q[qrow + gn + j] << (8 * j);
        }
        const T* srow = scale + (long long)(gk / group) * N + gn;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int byte = (packed >> (8 * j)) & 0xFF;
          const int qv = BITS == 8 ? (int)(int8_t)byte : (((gk & 1) ? byte >> 4 : byte & 0xF) - 8);
          if (gn + j < N) w[j] = (float)qv * to_float<T>(srow[j]);
        }
      }
      alignas(16) W wv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wv[j] = from_float<W>(w[j]);
      if constexpr (sizeof(W) == 2)
        *reinterpret_cast<uint2*>(ws + r * WLD + c) = *reinterpret_cast<const uint2*>(wv);
      else
        *reinterpret_cast<uint4*>(ws + r * WLD + c) = *reinterpret_cast<const uint4*>(wv);
    }
    __syncthreads();
    if constexpr (TC) {
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[FM];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> b[FN];
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(a[i], xs + (wrow + i * 16) * XLD + kk, XLD);
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(b[j], ws + kk * WLD + wcol + j * 16, WLD);
        for (int i = 0; i < FM; ++i)
          for (int j = 0; j < FN; ++j) wmma::mma_sync(acc_tc[i][j], a[i], b[j], acc_tc[i][j]);
      }
    } else {
      const int c = tid % BN, r0 = tid / BN;
      for (int kk = 0; kk < BK; ++kk) {
        const float w = ws[kk * WLD + c];
        for (int i = 0; i < RPT; ++i) acc[i] = fmaf(xs[(r0 + i * RSTEP) * XLD + kk], w, acc[i]);
      }
    }
    __syncthreads();
  }

  if constexpr (TC) {
    float* cs = reinterpret_cast<float*>(smem + STAGE_BYTES) + warp * 256;
    for (int i = 0; i < FM; ++i) {
      for (int j = 0; j < FN; ++j) {
        wmma::store_matrix_sync(cs, acc_tc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        for (int e = lane; e < 256; e += 32) {
          const int r = m0 + wrow + i * 16 + e / 16, c = n0 + wcol + j * 16 + e % 16;
          if (r < M && c < N) {
            const long long o = (long long)r * N + c;
            if (PARTIAL) partial[(long long)blockIdx.z * M * N + o] = cs[e];
            else y[o] = from_float<T>(cs[e]);
          }
        }
        __syncwarp();
      }
    }
  } else {
    const int c = tid % BN, r0 = tid / BN;
    if (n0 + c < N) {
      for (int i = 0; i < RPT; ++i) {
        const int r = m0 + r0 + i * RSTEP;
        if (r >= M) continue;
        const long long o = (long long)r * N + n0 + c;
        if (PARTIAL) partial[(long long)blockIdx.z * M * N + o] = acc[i];
        else y[o] = from_float<T>(acc[i]);
      }
    }
  }
}

// -- decode: m <= 16 rows --------------------------------------------------------
//
// A 16-row tile wastes most of the tensor-core tile when m is 1-8, and one
// block per 64 columns sweeping all of k leaves the card latency-bound
// (64-172 blocks, each a long chain of dependent loads). For m <= 16 the
// product runs as a split-k GEMV instead: a block takes a 128-column strip
// and one k range; each thread owns 4 adjacent columns (one 4-byte load of
// the int8 row, or of the packed row pair for int4) and the MT rows of x,
// staged in fp32 in shared memory per 128-row chunk. Its 4 warps take every
// 4th row (int4: row pair) of the range, 8 loads in flight each; they sum
// through shared memory, and the block writes its fp32 partial [split, m, n].
// A second kernel adds the splits in order and casts to x's type, so the
// result does not depend on the launch.
// The weight is dequantized exactly as in the tiled kernel: float(q) *
// float(scale), rounded to bf16 for bf16 x; products and sums in fp32.

constexpr int QMV_WARPS = 4;
constexpr int QMV_COLS = 128;   // columns per block: 32 lanes x 4
constexpr int QMV_KC = 128;     // rows of x staged per chunk
constexpr int QMV_UNROLL = 8;   // weight loads each thread has in flight

template <typename T, int BITS, int MT>
__global__ void __launch_bounds__(QMV_WARPS * 32)
    qmv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q,
               const T* __restrict__ scale, float* __restrict__ partial, int M, int N, int K,
               int group, int k_per_split) {
  using W = typename TileType<T>::type;
  __shared__ float xs[MT][QMV_KC];
  __shared__ float red[QMV_WARPS][MT][QMV_COLS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * QMV_COLS, c0 = n0 + lane * 4;
  const int k0 = blockIdx.y * k_per_split, k1 = min(K, k0 + k_per_split);
  const bool vec = (N % 4 == 0) && (c0 + 3 < N);
  float acc[MT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  int g_cur = -1;

  for (int kc = k0; kc < k1; kc += QMV_KC) {
    const int rows = min(QMV_KC, k1 - kc);
    for (int e = tid; e < MT * QMV_KC; e += QMV_WARPS * 32) {
      const int i = e / QMV_KC, kk = e % QMV_KC;
      xs[i][kk] = (i < M && kk < rows) ? to_float<T>(x[(long long)i * K + kc + kk]) : 0.f;
    }
    __syncthreads();
    // BITS 8: one row per step; BITS 4: one packed row (two rows) per step.
    // Each warp issues QMV_UNROLL independent loads before it uses them, so
    // enough bytes are in flight to cover the load latency.
    constexpr int RPS = BITS == 4 ? 2 : 1;
    constexpr int STEP = QMV_WARPS * RPS;
    for (int kb = warp * RPS; kb < rows; kb += STEP * QMV_UNROLL) {
      uint32_t packed[QMV_UNROLL];
#pragma unroll
      for (int u = 0; u < QMV_UNROLL; ++u) {
        const int k = kc + kb + u * STEP;
        const long long qrow = BITS == 4 ? (long long)(k >> 1) * N : (long long)k * N;
        packed[u] = 0;
        if (kb + u * STEP < rows) {
          if (vec) {
            packed[u] = *reinterpret_cast<const uint32_t*>(q + qrow + c0);
          } else {
            for (int j = 0; j < 4; ++j)
              if (c0 + j < N) packed[u] |= (uint32_t)q[qrow + c0 + j] << (8 * j);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < QMV_UNROLL; ++u) {
        const int kk = kb + u * STEP;
        if (kk >= rows) break;
#pragma unroll
        for (int r = 0; r < RPS; ++r) {
          const int g = (kc + kk + r) / group;
          if (g != g_cur) {
            g_cur = g;
            for (int j = 0; j < 4; ++j)
              s[j] = c0 + j < N ? to_float<T>(scale[(long long)g * N + c0 + j]) : 0.f;
          }
          float w[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int byte = (packed[u] >> (8 * j)) & 0xFF;
            const int qv = BITS == 8 ? (int)(int8_t)byte : ((r ? byte >> 4 : byte & 0xF) - 8);
            w[j] = to_float<W>(from_float<W>((float)qv * s[j]));
          }
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            const float xv = xs[i][kk + r];
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(xv, w[j], acc[i][j]);
          }
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) red[warp][i][lane * 4 + j] = acc[i][j];
  __syncthreads();
  float* out = partial + (long long)blockIdx.y * M * N;
  for (int e = tid; e < MT * QMV_COLS; e += QMV_WARPS * 32) {
    const int i = e / QMV_COLS, c = e % QMV_COLS;
    if (i < M && n0 + c < N) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < QMV_WARPS; ++w) sum += red[w][i][c];
      out[(long long)i * N + n0 + c] = sum;
    }
  }
}

// y = the splits' partials added in order, cast to T
template <typename T>
__global__ void qmv_reduce_kernel(const float* __restrict__ partial, T* __restrict__ y, int MN,
                                  int splits) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= MN) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += partial[(long long)sp * MN + idx];
  y[idx] = from_float<T>(sum);
}

template <typename T, int BITS, int MT>
cudaError_t launch_qmv(const void* x, const void* q, const void* scale, void* y, float* work,
                       int M, int N, int K, int group, int splits, cudaStream_t stream) {
  int k_per_split = (K + splits - 1) / splits;
  k_per_split = (k_per_split + QMV_KC - 1) / QMV_KC * QMV_KC;   // whole chunks, even
  splits = (K + k_per_split - 1) / k_per_split;
  const dim3 grid((N + QMV_COLS - 1) / QMV_COLS, splits);
  qmv_kernel<T, BITS, MT><<<grid, QMV_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(q), static_cast<const T*>(scale),
      work, M, N, K, group, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int mn = M * N;
  qmv_reduce_kernel<T><<<(mn + 255) / 256, 256, 0, stream>>>(work, static_cast<T*>(y), mn,
                                                             splits);
  return cudaGetLastError();
}

// splits > 1: each block sweeps one k range into the fp32 partials `work`,
// which the GEMV's reduce kernel then adds in order (few output tiles, as at
// a short prefill, would otherwise leave most SMs idle)
template <typename T, int BITS, int BM, int BN, int BK, int THREADS>
cudaError_t launch_tile(const void* x, const void* q, const void* scale, void* y, float* work,
                        int M, int N, int K, int group, int splits, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const uint8_t* qt = static_cast<const uint8_t*>(q);
  const T* st = static_cast<const T*>(scale);
  if (splits <= 1) {
    const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    qmm_kernel<T, BITS, BM, BN, BK, THREADS, false><<<grid, THREADS, 0, stream>>>(
        xt, qt, st, static_cast<T*>(y), nullptr, M, N, K, group, K);
    return cudaGetLastError();
  }
  if (work == nullptr) return cudaErrorInvalidValue;
  int k_per_split = (K + splits - 1) / splits;
  k_per_split = (k_per_split + BK - 1) / BK * BK;
  splits = (K + k_per_split - 1) / k_per_split;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, splits);
  qmm_kernel<T, BITS, BM, BN, BK, THREADS, true><<<grid, THREADS, 0, stream>>>(
      xt, qt, st, nullptr, work, M, N, K, group, k_per_split);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int mn = M * N;
  qmv_reduce_kernel<T><<<(mn + 255) / 256, 256, 0, stream>>>(work, static_cast<T*>(y), mn,
                                                             splits);
  return cudaGetLastError();
}

template <typename T, int BITS>
cudaError_t launch(const void* x, const void* q, const void* scale, void* y, float* work, int M,
                   int N, int K, int group, int splits, cudaStream_t stream) {
  if (M <= 16) {
    if (work == nullptr || splits < 1) return cudaErrorInvalidValue;
    if (M <= 1) return launch_qmv<T, BITS, 1>(x, q, scale, y, work, M, N, K, group, splits, stream);
    if (M <= 2) return launch_qmv<T, BITS, 2>(x, q, scale, y, work, M, N, K, group, splits, stream);
    if (M <= 4) return launch_qmv<T, BITS, 4>(x, q, scale, y, work, M, N, K, group, splits, stream);
    if (M <= 8) return launch_qmv<T, BITS, 8>(x, q, scale, y, work, M, N, K, group, splits, stream);
    return launch_qmv<T, BITS, 16>(x, q, scale, y, work, M, N, K, group, splits, stream);
  }
  // bf16 on the tensor cores: 128 x 128 tiles, 8 warps; fp16/fp32 FMA: 64 x 64, 4 warps
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_tile<T, BITS, 128, 128, 32, 256>(x, q, scale, y, work, M, N, K, group, splits,
                                                   stream);
  else
    return launch_tile<T, BITS, 64, 64, 32, 128>(x, q, scale, y, work, M, N, K, group, splits,
                                                 stream);
}

template <typename T>
cudaError_t launch_bits(int bits, const void* x, const void* q, const void* scale, void* y,
                        float* work, int M, int N, int K, int group, int splits,
                        cudaStream_t stream) {
  if (bits == 8) return launch<T, 8>(x, q, scale, y, work, M, N, K, group, splits, stream);
  if (bits == 4) return launch<T, 4>(x, q, scale, y, work, M, N, K, group, splits, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, scale and y): 0 = float32, 1 = float16, 2 = bfloat16. bits 8:
// q is int8 [K, N]; bits 4: q is uint8 [K/2, N] (K even). scale is [K/group, N].
// Every tensor is contiguous. work is the caller's fp32 scratch of
// splits * M * N for the split-k partials: needed for M <= 16 (the GEMV,
// splits >= 1) and for splits > 1; else it may be null.
// Returns a cudaError_t.
extern "C" int ds_quantized_matmul(const void* x, const void* q, const void* scale, void* y,
                                   void* work, int dtype, int bits, int M, int N, int K,
                                   int group, int splits, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || K % group != 0 || (bits == 4 && K % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_bits<float>(bits, x, q, scale, y, wk, M, N, K, group, splits, st); break;
    case 1: err = launch_bits<__half>(bits, x, q, scale, y, wk, M, N, K, group, splits, st); break;
    case 2:
      err = launch_bits<__nv_bfloat16>(bits, x, q, scale, y, wk, M, N, K, group, splits, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
