// Weight-only int8 / int4 dequant-matmul for Hopper (sm_90a), bf16 / fp16 / fp32 x.
//
// Replaces the Pallas TPU kernels of deepspeed_tpu/ops/pallas/quantized_matmul.py:
// _int8_kernel and _int4_kernel (the pallas_calls of quantized_matmul at :161
// and :176).
//
//   y[m, n] = sum_k x[m, k] * w[k, n],   w[k, n] = float(q[k, n]) * float(scale[k / g, n])
//
// q is int8 [K, N], or for 4 bits uint8 [K/2, N] with two rows a byte: packed
// row p holds row 2p in its low nibble and row 2p+1 in its high nibble, each
// stored + 8 (ops/quantizer.py pack_int4). scale is [K/g, N] in x's type (the
// model casts its fp32 scales to the compute type, as the JAX model does).
// For bf16 x, w is rounded to bf16 (bf16(float(q) * float(scale))) and the
// product runs on the tensor cores with fp32 accumulation; for fp16 and fp32
// x, w stays fp32 and the product is fp32 FMA (the TPU kernel's dot_dtype).
// The sum is cast to x's type.
//
// What bounds it on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16):
//   * decode (m of 1-8): the weight bytes. At m 8, k 4096, n 11008 the int8
//     weights are 45.1 MB plus 1.4 MB of bf16 scales: 13.9 us; int4 24.0 MB:
//     7.1 us (the unquantized bf16 GEMM reads 90 MB: 27 us);
//   * prefill (m 2048): the operations, 2 * 2048 * 4096 * 11008 = 185 GFLOP:
//     0.19 ms, and on the way there the dequantization: every weight element
//     is turned into bf16 once per 128-row block of x, on the CUDA cores.
//
// Four routes, picked by the caller as a pure function of the shape
// (ops/cuda/quantized_matmul.py kernel_route) and passed in:
//
//   * wgmma (the prefill, m > 16, bf16 x, k a multiple of 64, n of 16, g a
//     multiple of 64 or one of 8, 16, 32): one block per output tile of 128
//     columns and 256 rows (each of the two consumer warpgroups owns two
//     64-row tiles), or 128 rows for a grid of 256-row tiles too small to
//     fill the card; k in steps of 64. Thread 0 keeps TMA loads
//     (cp.async.bulk.tensor, descriptors encoded on the host) of the step's x
//     tile [rows, 64] (128-byte swizzle), q tile [64, 128] (int4: [32, 128]
//     bytes) and scale rows in flight in a ring of 4 stages (5 for 128 rows),
//     each completing on its stage's mbarrier. Every step the 256 threads
//     dequantize the q tile in shared memory into a bf16 B tile, K-major with
//     the 128-byte swizzle wgmma reads (int8 and nibbles to float exactly by
//     a byte permute into 2^23's mantissa, one bf16x2 multiply by the scale:
//     the rounding the plain version pins), fence it for the async proxy, and
//     each warpgroup issues wgmma.mma_async m64n128k16 over A = x and B = the
//     dequantized tile, both from shared memory, accumulating in registers.
//     The products of one step run while the next step is dequantized (wgmma
//     wait_group 1; three B tiles rotate so that a slow warpgroup's products
//     never see their B overwritten). The epilogue casts to bf16 in registers
//     and stores with the ragged m and n masked. What bounds it: the tensor
//     cores' operations, and on the way there the dequantization on the CUDA
//     cores (about 3 instructions an element, every weight element once per
//     block of x rows: the 256-row tile halves that per operation);
//   * wmma (the other m > 16 shapes: fp16/fp32 x, ragged k or n, odd groups):
//     the simple tiled product. One block per (m tile, n tile) holds its
//     fp32 accumulators for the whole k sweep: 128 x 128 tiles and 8 warps for
//     bf16 (nvcuda::wmma 16x16x16), 64 x 64 and 4 warps for fp16/fp32 (FMA).
//     Each k step stages an x tile and a DEQUANTIZED w tile in shared memory;
//     the group of row r is r / g, so any g dividing k is taken, odd ones
//     included, and ragged m, n and k tails are masked;
//   * mma (decode, m <= 16, the shapes the wgmma route takes): weights
//     streamed through a cp.async ring, dequantized in registers into
//     mma.sync's A operand, split k added in order by each strip's last
//     block; below;
//   * gemv (the other m <= 16 shapes: fp16/fp32 x, ragged, odd groups): a
//     split-k GEMV, below.
// A wgmma or wmma grid too small to fill the card (a short prefill) splits k,
// and a second kernel adds the fp32 partials in order, so the result does not
// depend on the launch.
//
// The C entry point launches on the caller's stream, does not synchronise and
// returns the cudaError_t of its launches. The TMA descriptors are encoded
// with cuTensorMapEncodeTiled, reached through cudaGetDriverEntryPoint, so the
// library links the CUDA runtime only (no -lcuda).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_utils.cuh"  // mbarriers, TMA, wgmma descriptors, tensor-map encoding

namespace {

using namespace nvcuda;
using namespace sm90;

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

// -- decode: m <= 16 rows, the shapes the mma route does not take ----------------
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

// -- prefill on Hopper: TMA + wgmma ----------------------------------------------

// MT: 64-row m tiles per warpgroup, so 128 * MT x rows per block (the caller
// picks 2 for a grid that fills the card, else 1)
constexpr int WG_BN = 128;          // n per block
constexpr int WG_BK = 64;           // k per step: one 128-byte swizzle row of bf16
constexpr int WG_THREADS = 256;     // two consumer warpgroups
constexpr int WG_SCALE_ROWS = 8;    // scale rows a stage holds (group 8: 64 / 8)
constexpr int WG_B_BUFS = 3;        // dequantized B tiles in rotation

template <int BITS, int MT>
struct WgSmem {
  static constexpr int BM = 128 * MT;
  static constexpr int BN = WG_BN;
  static constexpr int STAGES = MT == 1 ? 5 : 4;  // TMA ring; STAGES - 2 steps load ahead
  static constexpr int A_BYTES = BM * WG_BK * 2;
  static constexpr int Q_BYTES = (BITS == 8 ? WG_BK : WG_BK / 2) * BN;
  static constexpr int S_BYTES = WG_SCALE_ROWS * BN * 2;
  static constexpr int STAGE = (A_BYTES + Q_BYTES + S_BYTES + 1023) / 1024 * 1024;
  static constexpr int B_BYTES = BN * WG_BK * 2;
  static constexpr int b_off = STAGES * STAGE;
  static constexpr int bar_off = b_off + WG_B_BUFS * B_BYTES;
  static constexpr int bytes = bar_off + 8 * STAGES + 1024;  // + slack to align the base to 1024
  static_assert(bytes <= 232448, "wgmma route shared memory");
};

// D[64 x 128] += A[64 x 16] B[16 x 128], both from shared memory (128-byte
// swizzled, K-major), fp32 accumulators in registers
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// One thread's share of a step's dequantization: rows 8o..8o+7 (one 16-byte
// chunk of a B row) of the 4 columns 4 quad..4 quad+3. q comes as one 4-byte
// word per row (int4: per packed row, holding two rows); each element becomes
// a float exactly (its biased byte or nibble permuted into the mantissa of
// 2^23, less the bias), a pair of rows is packed to bf16x2 (exact, integers
// below 2^8) and multiplied by the column's scale pair in bf16x2: one
// rounding of the exact product, bf16(float(q) * float(scale)). The columns
// are written in an order rotated by (lane / 2) % 4, so that the 8 lanes of
// each quarter warp store to 8 different 16-byte bank groups of the swizzled
// tile.
template <int BITS>
__device__ __forceinline__ void dequant_unit(const uint8_t* sq, const __nv_bfloat16* srow,
                                             uint8_t* bbuf, int o, int quad, int rot) {
  constexpr int BN = WG_BN;
  const uint2 sv = *reinterpret_cast<const uint2*>(srow + 4 * quad);
  uint32_t w[BITS == 8 ? 8 : 4];
#pragma unroll
  for (int i = 0; i < (BITS == 8 ? 8 : 4); ++i)
    w[i] = *reinterpret_cast<const uint32_t*>(sq + ((BITS == 8 ? 8 : 4) * o + i) * BN + 4 * quad);
#pragma unroll
  for (int slot = 0; slot < 4; ++slot) {
    const int j = (slot + rot) & 3;  // the column of this slot within the quad
    const int n = 4 * quad + j;
    const uint32_t sw = j < 2 ? sv.x : sv.y;
    const uint32_t s16 = (j & 1) ? (sw >> 16) : (sw & 0xFFFFu);
    const uint32_t s2 = s16 | (s16 << 16);
    const __nv_bfloat162 sc = *reinterpret_cast<const __nv_bfloat162*>(&s2);
    uint32_t out[4];
#pragma unroll
    for (int pr = 0; pr < 4; ++pr) {  // rows 8o + 2pr, 8o + 2pr + 1
      float f0, f1;
      if constexpr (BITS == 8) {
        const uint32_t sel = 0x7540u | (uint32_t)j;  // [byte j, 0, 0, 0x4B]
        f0 = __uint_as_float(__byte_perm(w[2 * pr] ^ 0x80808080u, 0x4B000000u, sel)) - 8388736.0f;
        f1 = __uint_as_float(__byte_perm(w[2 * pr + 1] ^ 0x80808080u, 0x4B000000u, sel)) -
             8388736.0f;
      } else {
        const uint32_t byte = (w[pr] >> (8 * j)) & 0xFFu;
        f0 = __uint_as_float(0x4B000000u | (byte & 0xFu)) - 8388616.0f;  // low nibble: row 2p
        f1 = __uint_as_float(0x4B000000u | (byte >> 4)) - 8388616.0f;    // high: row 2p + 1
      }
      out[pr] = bf162_bits(__hmul2(__floats2bfloat162_rn(f0, f1), sc));
    }
    // row n of the K-major B tile, chunk o, 128-byte swizzle: chunk o ^ (n % 8)
    *reinterpret_cast<uint4*>(bbuf + n * 128 + ((o ^ (n & 7)) << 4)) =
        make_uint4(out[0], out[1], out[2], out[3]);
  }
}

// The loads of k step t into stage t % STAGES, completing on its mbarrier
// (issued by one thread): the x tile, the q tile and the step's scale rows.
template <int BITS, int MT>
__device__ __forceinline__ void wg_issue(uint32_t base, const CUtensorMap* tm_x,
                                         const CUtensorMap* tm_q, const CUtensorMap* tm_s, int t,
                                         int k_begin, int m0, int n0, int group,
                                         uint32_t tx_bytes) {
  using Sm = WgSmem<BITS, MT>;
  const int st = t % Sm::STAGES;
  const int k0 = k_begin + t * WG_BK;
  const uint32_t dst = base + st * Sm::STAGE;
  const uint32_t bar = base + Sm::bar_off + 8 * st;
  mbar_expect_tx(bar, tx_bytes);
  tma_load_2d(dst, tm_x, bar, k0, m0);
  tma_load_2d(dst + Sm::A_BYTES, tm_q, bar, n0, BITS == 8 ? k0 : k0 / 2);
  tma_load_2d(dst + Sm::A_BYTES + Sm::Q_BYTES, tm_s, bar, n0, k0 / group);
}

// One block per (128 * MT-row m tile, 128-column n tile[, k split]). PARTIAL:
// the block sweeps only k range blockIdx.z (k_per_split rows, a multiple of
// 64) and writes its fp32 partial [split, M, N]; else all of k into y.
template <int BITS, int MT, bool PARTIAL>
__global__ void __launch_bounds__(WG_THREADS, 1)
    qmm_wgmma_kernel(__grid_constant__ const CUtensorMap tm_x,
                     __grid_constant__ const CUtensorMap tm_q,
                     __grid_constant__ const CUtensorMap tm_s, __nv_bfloat16* __restrict__ y,
                     float* __restrict__ partial, int M, int N, int K, int group,
                     int k_per_split) {
  using Sm = WgSmem<BITS, MT>;
  constexpr int BN = Sm::BN, STAGES = Sm::STAGES;
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, wg = warp >> 2;
  const int m0 = blockIdx.x * Sm::BM, n0 = blockIdx.y * BN;
  const int k_begin = PARTIAL ? blockIdx.z * k_per_split : 0;
  const int k_end = PARTIAL ? min(K, k_begin + k_per_split) : K;
  const int nk = (k_end - k_begin) / WG_BK;
  const int srows = group >= WG_BK ? 1 : WG_BK / group;
  const uint32_t tx_bytes = Sm::A_BYTES + Sm::Q_BYTES + srows * BN * 2;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) mbar_init(base + Sm::bar_off + 8 * st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid == 0)
    for (int t = 0; t < min(nk, STAGES - 2); ++t)
      wg_issue<BITS, MT>(base, &tm_x, &tm_q, &tm_s, t, k_begin, m0, n0, group, tx_bytes);

  float acc[MT][BN / 2];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[t][i] = 0.0f;

  const int rot = (lane >> 1) & 3;
  for (int kt = 0; kt < nk; ++kt) {
    const int st = kt % STAGES;
    const int bb = kt % WG_B_BUFS;
    mbar_wait(base + Sm::bar_off + 8 * st, (uint32_t)(kt / STAGES) & 1u);
    const uint8_t* sq = smem + st * Sm::STAGE + Sm::A_BYTES;
    const __nv_bfloat16* ss =
        reinterpret_cast<const __nv_bfloat16*>(smem + st * Sm::STAGE + Sm::A_BYTES + Sm::Q_BYTES);
    uint8_t* bbuf = smem + Sm::b_off + bb * Sm::B_BYTES;
    // warp w dequantizes rows 8w..8w+7 of the step (their scale row), lane
    // the 4 columns 4 lane..4 lane+3
    const int srow = group >= WG_BK ? 0 : (8 * warp) / group;
    dequant_unit<BITS>(sq, ss + srow * BN, bbuf, warp, lane, rot);
    // the B tile was written through the generic proxy; wgmma reads it
    // through the async proxy
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    __syncthreads();
    // every warpgroup is past step kt - 1's wait: step kt - 2's stage is free
    if (tid == 0 && kt + STAGES - 2 < nk)
      wg_issue<BITS, MT>(base, &tm_x, &tm_q, &tm_s, kt + STAGES - 2, k_begin, m0, n0, group,
                         tx_bytes);
    __syncwarp();  // warp 0 reconverges before the warpgroup-wide wgmma

    // this warpgroup's MT 64-row tiles of x (8 KB each), all against B
    const uint32_t a = base + st * Sm::STAGE + wg * MT * 64 * 128;
    const uint32_t b = base + Sm::b_off + bb * Sm::B_BYTES;
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < WG_BK / 16; ++kk) {
      // a 16-deep slice is 32 bytes further along each 128-byte row
#pragma unroll
      for (int t = 0; t < MT; ++t)
        wgmma_n128(acc[t], sw128_desc(a + t * 64 * 128 + 32 * kk), sw128_desc(b + 32 * kk));
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");

  // accumulator layout of m64nN: register 4j + 2h + e holds row
  // 16 (warp % 4) + lane / 4 + 8h, column 8j + 2 (lane % 4) + e
  const int col0 = n0 + 2 * (lane & 3);
#pragma unroll
  for (int t = 0; t < MT; ++t) {
    const int row0 = m0 + (wg * MT + t) * 64 + (warp & 3) * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int col = col0 + 8 * j;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + 8 * h;
        if (row < M && col < N) {  // N % 16 == 0: col + 1 < N too
          const long long off = (long long)row * N + col;
          if constexpr (PARTIAL)
            *reinterpret_cast<float2*>(partial + (long long)blockIdx.z * M * N + off) =
                make_float2(acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
          else
            *reinterpret_cast<__nv_bfloat162*>(y + off) =
                __floats2bfloat162_rn(acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
        }
      }
    }
  }
}

// what the wgmma route takes (kernel_route in ops/cuda/quantized_matmul.py)
bool wgmma_takes(int M, int N, int K, int group) {
  return M > 0 && K % WG_BK == 0 && N % 16 == 0 && group % 8 == 0 &&
         (group % WG_BK == 0 || WG_BK % group == 0);
}

template <int BITS, int MT, bool PARTIAL>
cudaError_t launch_wgmma_grid(const CUtensorMap& tx, const CUtensorMap& tq, const CUtensorMap& ts,
                              void* y, float* work, int M, int N, int K, int group,
                              int k_per_split, int splits, cudaStream_t stream) {
  using Sm = WgSmem<BITS, MT>;
  auto kernel = qmm_wgmma_kernel<BITS, MT, PARTIAL>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Sm::bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((M + Sm::BM - 1) / Sm::BM, (N + Sm::BN - 1) / Sm::BN, splits);
  kernel<<<grid, WG_THREADS, Sm::bytes, stream>>>(tx, tq, ts, static_cast<__nv_bfloat16*>(y),
                                                   work, M, N, K, group, k_per_split);
  return cudaGetLastError();
}

template <int BITS, int MT>
cudaError_t launch_wgmma(const void* x, const void* q, const void* scale, void* y, float* work,
                         int M, int N, int K, int group, int splits, cudaStream_t stream) {
  if (!wgmma_takes(M, N, K, group)) return cudaErrorInvalidValue;
  const int srows = group >= WG_BK ? 1 : WG_BK / group;
  CUtensorMap tx, tq, ts;
  if (!encode_2d(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, WG_BK,
                 WgSmem<BITS, MT>::BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, q, N, BITS == 8 ? K : K / 2, N, WG_BN,
                 BITS == 8 ? WG_BK : WG_BK / 2, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode_2d(&ts, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, scale, N, K / group, (uint64_t)N * 2,
                 WG_BN, srows, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  if (splits <= 1)
    return launch_wgmma_grid<BITS, MT, false>(tx, tq, ts, y, nullptr, M, N, K, group, K, 1,
                                              stream);
  if (work == nullptr) return cudaErrorInvalidValue;
  int k_per_split = (K + splits - 1) / splits;
  k_per_split = (k_per_split + WG_BK - 1) / WG_BK * WG_BK;
  splits = (K + k_per_split - 1) / k_per_split;
  cudaError_t err = launch_wgmma_grid<BITS, MT, true>(tx, tq, ts, nullptr, work, M, N, K, group,
                                                      k_per_split, splits, stream);
  if (err != cudaSuccess) return err;
  const int mn = M * N;
  qmv_reduce_kernel<__nv_bfloat16><<<(mn + 255) / 256, 256, 0, stream>>>(
      work, static_cast<__nv_bfloat16*>(y), mn, splits);
  return cudaGetLastError();
}

// -- decode on Hopper: streamed weights, dequantized in registers, mma.sync -------
//
// m <= 16 rows of bf16 x, the shapes the wgmma route takes (wgmma_takes). The
// product runs transposed, y^T = W^T x^T, on mma.sync.m16n8k16 (bf16 in, fp32
// accumulators): the dequantized weight is the A operand (16 output columns x
// 16 k) built in registers, x^T the B operand (16 k x 8 tokens; two of them
// for m 9-16). So the tensor cores do every product, and each weight element
// costs the CUDA cores only its dequantization.
//
// The MMA's k slots may stand for any k, and its rows for any columns, as
// long as A and B agree; the kernel picks them so that a thread's A fragments
// come from its own 16-byte loads. Lane (g, t) (g = lane / 4, t = lane % 4)
// of a warp owns the 16 adjacent columns 16g .. 16g + 15 of the warp's
// 128-column strip and, in every 16-deep k chunk, the 4 adjacent k rows
// 4t .. 4t + 3; MMA j (of 8 per chunk) maps its row g to column 16g + 2j and
// row g + 8 to 16g + 2j + 1. Per chunk a thread loads 4 int8 rows (16 bytes
// each: its 16 columns), or 2 packed int4 rows, and its 8-byte slice of each
// x row; per warp a load instruction fetches whole 128-byte lines.
//
// The loads are cp.async (16 bytes a thread; x 8 bytes) into a ring of
// MMA_STAGES stages in shared memory, each thread reading back only what it
// copied, so the ring needs no barrier: per step (16 k of int8, 32 k of int4)
// a warp streams 2 KB of weights, and MMA_STAGES - 1 steps are in flight, 6
// KB a warp, 48 KB an SM at the 2 blocks of 4 warps an SM the caller's k
// splits make (the latency of HBM at 3.35 TB/s over 132 SMs asks for about
// 24 KB; on an H100 a deeper ring, 8-warp blocks and 3-4 blocks an SM were
// slower, and every split adds a tail: PERF.md §6). The scale rows of the
// block's k range are copied to shared memory once, at the start; a thread
// reads its 16 columns' scales when its group changes.
//
// Dequantization, in registers: int8 bytes become floats exactly (the biased
// byte permuted into the mantissa of 2^23, less the bias), a pair is rounded
// to bf16x2 (exact: integers below 2^8) and multiplied by the scale pair in
// bf16x2; int4: one byte permute puts a column's two packed rows side by side
// and each nibble pair becomes bf16x2 128 + n by a mask into 0x4300's
// mantissa, less 136 (exact), times the scale pair. One rounding of the
// exact product each: bf16(float(q) * float(scale)), the plain version's.
//
// The grid: one block per (128-column strip, k split); its 4 warps take the
// steps of its k range in turn and add their partials in warp order. With
// more than one split each block writes its fp32 partial [split, m, n], and
// the last block of a strip to finish (an atomic ticket per strip, which that
// block resets to 0) adds the partials in split order and writes y, each
// thread 4 columns with 8 splits' loads in flight: one launch, and a result
// that does not depend on the launch.

constexpr int MMA_WARPS = 4;
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr int MMA_COLS = 128;       // columns per block: 8 lane groups x 16
constexpr int MMA_STAGES = 4;       // steps in each thread's ring
constexpr int MMA_UNITS = 6;        // 16-byte units a thread holds a stage: 4 of weights, 2 of x
constexpr int MMA_STAGE_BYTES = MMA_UNITS * MMA_THREADS * 16;
constexpr int MMA_RING = MMA_STAGES * MMA_STAGE_BYTES;   // 48 KB
constexpr int MMA_SPLIT_ROWS = 64;  // a k split is a multiple of this many rows

// 16 bytes, L1 bypassed; L2 fetches the whole 128-byte line from HBM (on an
// H100 3-4% faster on the int8 linears of 45 MB than no hint, 256 bytes
// slower: PERF.md §6)
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global.L2::128B [%0], [%1], 16;" ::"r"(smem_u32(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// D (+)= A B: m16n8k16, bf16 in, fp32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four floats rounded to bf16 at an 8-byte aligned address
__device__ __forceinline__ void store_bf16x4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(bf162_bits(__floats2bfloat162_rn(v.x, v.y)),
                                              bf162_bits(__floats2bfloat162_rn(v.z, v.w)));
}

__device__ __forceinline__ uint32_t bf16x2_mul(uint32_t a, uint32_t b) {
  return bf162_bits(__hmul2(*reinterpret_cast<const __nv_bfloat162*>(&a),
                            *reinterpret_cast<const __nv_bfloat162*>(&b)));
}

// an int8 byte (selected by b) of a word biased by 0x80 per byte, as a float
__device__ __forceinline__ float int8_float(uint32_t biased, uint32_t b) {
  return __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | b)) - 8388736.0f;
}

// (x & 0x000F000F) | 0x43004300: the nibbles at bits 0 and 16 as bf16x2 128 + n
__device__ __forceinline__ uint32_t nibbles_bf16x2(uint32_t x) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0xEA;" : "=r"(r) : "r"(x), "r"(0x000F000Fu), "r"(0x43004300u));
  return r;
}

// The A fragment of MMA j from a thread's loads, scaled: rows g (column 2j of
// its 16) and g + 8 (column 2j + 1). int8: w holds the 4 rows 4t .. 4t + 3,
// biased by 0x80 per byte; k slots (2t, 2t + 1, 2t + 8, 2t + 9) stand for
// rows (4t, 4t + 1, 4t + 2, 4t + 3). int4: w[0], w[1] hold the packed rows of
// k (4t, 4t + 1) and (4t + 2, 4t + 3); the slots stand for (4t, 4t + 2,
// 4t + 1, 4t + 3).
template <int BITS>
__device__ __forceinline__ void a_fragment(uint32_t (&a)[4], const uint4* w, int j,
                                           uint32_t sc_lo, uint32_t sc_hi) {
  const int wi = j >> 1;
  const auto word = [&](int r) {
    const uint4 v = w[r];
    return wi == 0 ? v.x : wi == 1 ? v.y : wi == 2 ? v.z : v.w;
  };
  if constexpr (BITS == 8) {
    const uint32_t b0 = 2 * (j & 1), b1 = b0 + 1;
    const uint32_t r0 = word(0), r1 = word(1), r2 = word(2), r3 = word(3);
    a[0] = bf162_bits(__floats2bfloat162_rn(int8_float(r0, b0), int8_float(r1, b0)));
    a[1] = bf162_bits(__floats2bfloat162_rn(int8_float(r0, b1), int8_float(r1, b1)));
    a[2] = bf162_bits(__floats2bfloat162_rn(int8_float(r2, b0), int8_float(r3, b0)));
    a[3] = bf162_bits(__floats2bfloat162_rn(int8_float(r2, b1), int8_float(r3, b1)));
  } else {
    // bytes: column 2j of row pair 0, column 2j + 1 of it, the same of row pair 1
    const uint32_t x = __byte_perm(word(0), word(1), (j & 1) ? 0x7632u : 0x5410u);
    const __nv_bfloat162 bias = __floats2bfloat162_rn(136.0f, 136.0f);
    const auto deq = [&](uint32_t v) {
      return bf162_bits(__hsub2(*reinterpret_cast<const __nv_bfloat162*>(&v), bias));
    };
    a[0] = deq(nibbles_bf16x2(x));
    a[2] = deq(nibbles_bf16x2(x >> 4));
    a[1] = deq(nibbles_bf16x2(x >> 8));
    a[3] = deq(nibbles_bf16x2(x >> 12));
  }
  a[0] = bf16x2_mul(a[0], sc_lo);
  a[2] = bf16x2_mul(a[2], sc_lo);
  a[1] = bf16x2_mul(a[1], sc_hi);
  a[3] = bf16x2_mul(a[3], sc_hi);
}

// One block per (128-column strip, k split of k_per_split rows, a multiple of
// 64). MT: 8 or 16 tokens (m <= MT). partial/tickets: the split-k scratch
// ([splits, M, N] fp32; one int per strip, 0 between launches), unused with
// one split.
template <int BITS, int MT>
__global__ void __launch_bounds__(MMA_THREADS, MT == 8 ? 4 : 3)
    qmv_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q,
                   const __nv_bfloat16* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                   float* __restrict__ partial, int* __restrict__ tickets, int M, int N, int K,
                   int group, int k_per_split) {
  constexpr int SK = BITS == 8 ? 16 : 32;     // k rows of a warp's step
  constexpr int CHUNKS = SK / 16;
  constexpr int HALVES = MT / 8;              // n8 MMAs per A fragment
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * MMA_COLS;
  const int col = n0 + 16 * g;                // this thread's columns col .. col + 15
  const bool col_ok = col < N;                // N % 16 == 0: all 16 or none
  const int k_begin = blockIdx.y * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int n_steps = (k_end - k_begin) / SK;
  const int my_steps = n_steps > warp ? (n_steps - warp + MMA_WARPS - 1) / MMA_WARPS : 0;
  const int g_first = k_begin / group;
  const int n_srows = (k_end - 1) / group - g_first + 1;
  __nv_bfloat16* srows = reinterpret_cast<__nv_bfloat16*>(smem + MMA_RING);  // [n_srows][128]

  // the k rows of this warp's step j: k_begin + (warp + 4 j) SK ..
  const auto issue = [&](int j) {
    const int k0 = k_begin + (warp + MMA_WARPS * j) * SK;
    unsigned char* st = smem + (j % MMA_STAGES) * MMA_STAGE_BYTES;
    if (col_ok) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const long long row = BITS == 8 ? k0 + 4 * t + i : k0 / 2 + 8 * (i >> 1) + 2 * t + (i & 1);
        cp_async16(st + (i * MMA_THREADS + tid) * 16, q + row * N + col);
      }
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      unsigned char* dst = st + ((4 + c) * MMA_THREADS + tid) * 16;
      const int kx = k0 + 16 * c + 4 * t;
      if (g < M) cp_async8(dst, x + (long long)g * K + kx);
      if (HALVES == 2 && g + 8 < M) cp_async8(dst + 8, x + (long long)(g + 8) * K + kx);
    }
  };

  for (int e = tid; e < n_srows * (MMA_COLS / 8); e += MMA_THREADS) {
    const int r = e / (MMA_COLS / 8), c8 = (e % (MMA_COLS / 8)) * 8;
    if (n0 + c8 < N)
      cp_async16(srows + r * MMA_COLS + c8, scale + (long long)(g_first + r) * N + n0 + c8);
  }
#pragma unroll
  for (int j = 0; j < MMA_STAGES - 1; ++j) {
    if (j < my_steps) issue(j);
    cp_async_commit();
  }
  cp_async_wait<MMA_STAGES - 2>();   // the scale rows (and step 0) have landed
  __syncthreads();

  float acc[HALVES][8][4];
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[h][j][e] = 0.0f;
  int s_row = -1;
  uint32_t sw[8];   // scales of this thread's 16 columns in its current group, bf16 pairs

  for (int j = 0; j < my_steps; ++j) {
    if (j + MMA_STAGES - 1 < my_steps) issue(j + MMA_STAGES - 1);
    cp_async_commit();
    cp_async_wait<MMA_STAGES - 1>();   // step j has landed
    const unsigned char* st = smem + (j % MMA_STAGES) * MMA_STAGE_BYTES;
    const int k0 = k_begin + (warp + MMA_WARPS * j) * SK;
    uint4 w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      w[i] = *reinterpret_cast<const uint4*>(st + (i * MMA_THREADS + tid) * 16);
      if constexpr (BITS == 8) {
        w[i].x ^= 0x80808080u;
        w[i].y ^= 0x80808080u;
        w[i].z ^= 0x80808080u;
        w[i].w ^= 0x80808080u;
      }
    }
#pragma unroll
    for (int c = 0; c < CHUNKS; ++c) {
      const int row = (k0 + 16 * c + 4 * t) / group - g_first;
      if (row != s_row) {
        s_row = row;
        const uint4* sp = reinterpret_cast<const uint4*>(srows + row * MMA_COLS + 16 * g);
        const uint4 s0 = sp[0], s1 = sp[1];
        sw[0] = s0.x; sw[1] = s0.y; sw[2] = s0.z; sw[3] = s0.w;
        sw[4] = s1.x; sw[5] = s1.y; sw[6] = s1.z; sw[7] = s1.w;
      }
      const uint4 xv = *reinterpret_cast<const uint4*>(st + ((4 + c) * MMA_THREADS + tid) * 16);
      uint32_t b[HALVES][2];
      if constexpr (BITS == 8) {
        b[0][0] = xv.x;
        b[0][1] = xv.y;
        if constexpr (HALVES == 2) {
          b[1][0] = xv.z;
          b[1][1] = xv.w;
        }
      } else {
        b[0][0] = __byte_perm(xv.x, xv.y, 0x5410u);
        b[0][1] = __byte_perm(xv.x, xv.y, 0x7632u);
        if constexpr (HALVES == 2) {
          b[1][0] = __byte_perm(xv.z, xv.w, 0x5410u);
          b[1][1] = __byte_perm(xv.z, xv.w, 0x7632u);
        }
      }
#pragma unroll
      for (int mj = 0; mj < 8; ++mj) {
        uint32_t a[4];
        a_fragment<BITS>(a, BITS == 8 ? w : w + 2 * c, mj, __byte_perm(sw[mj], 0, 0x1010u),
                         __byte_perm(sw[mj], 0, 0x3232u));
#pragma unroll
        for (int h = 0; h < HALVES; ++h) mma_bf16(acc[h][mj], a, b[h][0], b[h][1]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // every warp is done with the ring: it becomes the warps' sums

  // accumulator c0..c3 of MMA j: (column 16g + 2j, token 2t), (16g + 2j, 2t + 1),
  // (16g + 2j + 1, 2t), (16g + 2j + 1, 2t + 1), tokens + 8 in the second half
  float* red = reinterpret_cast<float*>(smem);   // [warps][MT][128]
#pragma unroll
  for (int h = 0; h < HALVES; ++h)
#pragma unroll
    for (int mj = 0; mj < 8; ++mj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(red + (warp * MT + 8 * h + 2 * t + e) * MMA_COLS + 16 * g +
                                   2 * mj) = make_float2(acc[h][mj][e], acc[h][mj][2 + e]);
  __syncthreads();
  // the block's sum in warp order, 4 columns of one token a thread at a time
  const int splits = gridDim.y;
  for (int e = tid; e < M * (MMA_COLS / 4); e += MMA_THREADS) {
    const int tok = e / (MMA_COLS / 4), c = (e % (MMA_COLS / 4)) * 4;
    if (n0 + c >= N) continue;   // N % 16 == 0: all 4 columns or none
    float4 sum = *reinterpret_cast<const float4*>(red + tok * MMA_COLS + c);
#pragma unroll
    for (int wp = 1; wp < MMA_WARPS; ++wp) {
      const float4 v = *reinterpret_cast<const float4*>(red + (wp * MT + tok) * MMA_COLS + c);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const long long o = (long long)tok * N + n0 + c;
    if (splits > 1)
      *reinterpret_cast<float4*>(partial + (long long)blockIdx.y * M * N + o) = sum;
    else
      store_bf16x4(y + o, sum);
  }
  if (splits == 1) return;
  // the last block of the strip adds the splits' partials in order
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(tickets + blockIdx.x, 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  constexpr int BATCH = 8;   // partials in flight a thread: one L2 round trip per BATCH splits
  for (int e = tid; e < M * (MMA_COLS / 4); e += MMA_THREADS) {
    const int tok = e / (MMA_COLS / 4), c = (e % (MMA_COLS / 4)) * 4;
    if (n0 + c >= N) continue;
    const long long o = (long long)tok * N + n0 + c;
    float4 sum = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int s0 = 0; s0 < splits; s0 += BATCH) {
      float4 v[BATCH];
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (s0 + u < splits)
          v[u] = __ldcg(reinterpret_cast<const float4*>(partial + (s0 + u) * (long long)M * N +
                                                        o));
#pragma unroll
      for (int u = 0; u < BATCH; ++u)
        if (s0 + u < splits) {
          sum.x += v[u].x;
          sum.y += v[u].y;
          sum.z += v[u].z;
          sum.w += v[u].w;
        }
    }
    store_bf16x4(y + o, sum);
  }
  if (tid == 0) tickets[blockIdx.x] = 0;
}

template <int BITS, int MT>
cudaError_t launch_mma(const void* x, const void* q, const void* scale, void* y, float* work,
                       int* tickets, int M, int N, int K, int group, int splits,
                       cudaStream_t stream) {
  if (!wgmma_takes(M, N, K, group) || M > MT || splits < 1) return cudaErrorInvalidValue;
  int k_per_split = (K + splits - 1) / splits;
  k_per_split = (k_per_split + MMA_SPLIT_ROWS - 1) / MMA_SPLIT_ROWS * MMA_SPLIT_ROWS;
  splits = (K + k_per_split - 1) / k_per_split;
  if (splits > 1 && (work == nullptr || tickets == nullptr)) return cudaErrorInvalidValue;
  // the scale rows a k range can touch: one more where it starts inside a group
  const int bytes = MMA_RING + (k_per_split / group + 2) * MMA_COLS * 2;
  if (bytes > 232448) return cudaErrorInvalidValue;
  auto kernel = qmv_mma_kernel<BITS, MT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + MMA_COLS - 1) / MMA_COLS, splits);
  kernel<<<grid, MMA_THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q),
      static_cast<const __nv_bfloat16*>(scale), static_cast<__nv_bfloat16*>(y), work, tickets, M,
      N, K, group, k_per_split);
  return cudaGetLastError();
}

enum Route { ROUTE_GEMV = 0, ROUTE_WMMA = 1, ROUTE_WGMMA = 2, ROUTE_MMA = 3 };

template <typename T, int BITS>
cudaError_t launch(int route, int block_rows, const void* x, const void* q, const void* scale,
                   void* y, float* work, int* tickets, int M, int N, int K, int group, int splits,
                   cudaStream_t stream) {
  if (route == ROUTE_MMA) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (M <= 8)
        return launch_mma<BITS, 8>(x, q, scale, y, work, tickets, M, N, K, group, splits, stream);
      return launch_mma<BITS, 16>(x, q, scale, y, work, tickets, M, N, K, group, splits, stream);
    }
    return cudaErrorInvalidValue;
  }
  if (route == ROUTE_GEMV) {
    if (M > 16 || work == nullptr || splits < 1) return cudaErrorInvalidValue;
    if (M <= 1) return launch_qmv<T, BITS, 1>(x, q, scale, y, work, M, N, K, group, splits, stream);
    if (M <= 2) return launch_qmv<T, BITS, 2>(x, q, scale, y, work, M, N, K, group, splits, stream);
    if (M <= 4) return launch_qmv<T, BITS, 4>(x, q, scale, y, work, M, N, K, group, splits, stream);
    if (M <= 8) return launch_qmv<T, BITS, 8>(x, q, scale, y, work, M, N, K, group, splits, stream);
    return launch_qmv<T, BITS, 16>(x, q, scale, y, work, M, N, K, group, splits, stream);
  }
  if (route == ROUTE_WGMMA) {
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      if (block_rows == 128)
        return launch_wgmma<BITS, 1>(x, q, scale, y, work, M, N, K, group, splits, stream);
      if (block_rows == 256)
        return launch_wgmma<BITS, 2>(x, q, scale, y, work, M, N, K, group, splits, stream);
    }
    return cudaErrorInvalidValue;
  }
  if (route != ROUTE_WMMA) return cudaErrorInvalidValue;
  // bf16 on the tensor cores: 128 x 128 tiles, 8 warps; fp16/fp32 FMA: 64 x 64, 4 warps
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_tile<T, BITS, 128, 128, 32, 256>(x, q, scale, y, work, M, N, K, group, splits,
                                                   stream);
  else
    return launch_tile<T, BITS, 64, 64, 32, 128>(x, q, scale, y, work, M, N, K, group, splits,
                                                 stream);
}

template <typename T>
cudaError_t launch_bits(int bits, int route, int block_rows, const void* x, const void* q,
                        const void* scale, void* y, float* work, int* tickets, int M, int N,
                        int K, int group, int splits, cudaStream_t stream) {
  if (bits == 8)
    return launch<T, 8>(route, block_rows, x, q, scale, y, work, tickets, M, N, K, group, splits,
                        stream);
  if (bits == 4)
    return launch<T, 4>(route, block_rows, x, q, scale, y, work, tickets, M, N, K, group, splits,
                        stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype (of x, scale and y): 0 = float32, 1 = float16, 2 = bfloat16. bits 8:
// q is int8 [K, N]; bits 4: q is uint8 [K/2, N] (K even). scale is [K/group, N].
// Every tensor is contiguous (and, for the wgmma and mma routes, 16-byte
// aligned). route: 0 the GEMV (M <= 16), 1 the wmma/FMA tiled kernel, 2 the
// TMA + wgmma kernel (bf16; K % 64 == 0, N % 16 == 0, group a multiple of 64
// or one of 8, 16, 32) with blocks of block_rows (128 or 256) rows of x, 3
// the mma decode kernel (M <= 16, the wgmma route's shapes); the other routes
// ignore block_rows. work is the caller's fp32 scratch of splits * M * N for
// the split-k partials: needed for the GEMV (splits >= 1) and for splits > 1;
// else it may be null. tickets: the mma route's int per 128-column strip,
// zero before the launch and zero after it (needed for splits > 1). Returns a
// cudaError_t.
extern "C" int ds_quantized_matmul(const void* x, const void* q, const void* scale, void* y,
                                   void* work, void* tickets, int dtype, int bits, int M, int N,
                                   int K, int group, int splits, int route, int block_rows,
                                   void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || group <= 0 || K % group != 0 || (bits == 4 && K % 2 != 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* wk = static_cast<float*>(work);
  int* tk = static_cast<int*>(tickets);
  cudaError_t err;
  switch (dtype) {
    case 0:
      err = launch_bits<float>(bits, route, block_rows, x, q, scale, y, wk, tk, M, N, K, group,
                               splits, st);
      break;
    case 1:
      err = launch_bits<__half>(bits, route, block_rows, x, q, scale, y, wk, tk, M, N, K, group,
                                splits, st);
      break;
    case 2:
      err = launch_bits<__nv_bfloat16>(bits, route, block_rows, x, q, scale, y, wk, tk, M, N, K,
                                       group, splits, st);
      break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
