// Streaming LM-head cross-entropy forward for Hopper (sm_90a), bf16 / fp16 / fp32.
//
// Replaces the Pallas TPU kernel _ce_fwd_kernel of
// deepspeed_tpu/ops/pallas/cross_entropy.py (pallas_call in pallas_ce_forward):
// for every token t, over the whole vocabulary,
//   logit[t, j] = x[t, :] . E[j, :] (+ bias[j], fp32)      (fp32 accumulation)
//   lse[t]      = m + log(max(s, 1e-30)), the online logsumexp over j
//   label_logit[t] = logit[t, labels[t]]
// and the [tokens, vocab] logits never reach device memory. x is [T, d] and E
// [V, d] in one type (the caller casts E to x's type first, as the TPU kernel
// does); labels are int32 already made safe (ignored rows hold any valid id);
// bias is fp32 [V] or absent. Vocabulary columns at or past V are masked here
// in the kernel: there is no padded copy of E.
//
// What bounds it on an H100 SXM: operations, 2 * T * V * d, 1.27 TFLOP at the
// training shape (T 12288, V 50304, d 1024): 1.28 ms at 989 TFLOP/s in bf16.
// Its bytes (x and E once, two fp32 outputs) take about 0.04 ms at 3.35 TB/s.
//
// Design (a simple right kernel first; wgmma, TMA and warp specialisation are
// later work): one block of 4 warps per 64-token tile sweeps every 64-column
// vocab tile, as the TPU grid's sequential vocab axis does; each vocab tile's
// logits are accumulated over 64-wide chunks of d with warp-level tensor-core
// MMA (nvcuda::wmma 16x16x16, fp32 accumulate) for bf16/fp16, with fp32 FMAs
// for fp32 inputs. The x and E chunks stream through a two-stage cp.async ring
// in shared memory, so the next chunk's load overlaps the current chunk's
// products. Each warp owns 16 token rows end to end: its finished logit tile
// goes through shared memory once, where its lanes fold it into the running
// (m, s) and pick the label logit; nothing crosses blocks. All blocks sweep E
// in the same order at about the same pace, so E's tiles are shared in L2.
// The C entry point launches on the caller's stream, does not synchronise and
// returns the cudaError_t of the launch.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BT = 64;     // tokens per block
constexpr int BV = 64;     // vocab columns per tile
constexpr int DK = 64;     // d per chunk
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 16;   // token rows per warp
constexpr float NEG_INF = -1e30f;

template <typename T> struct TensorCore { static constexpr bool value = false; };
template <> struct TensorCore<__half> { static constexpr bool value = true; };
template <> struct TensorCore<__nv_bfloat16> { static constexpr bool value = true; };

// Row strides padded by 16 bytes (16-bit) or 4 floats: 16-byte aligned rows
// for cp.async, 32-byte aligned MMA fragments, wmma's ldm rules.
template <typename T>
struct Smem {
  static constexpr int LD = DK + 16 / (int)sizeof(T);
  static constexpr int LDS = BV + 4;
  static constexpr size_t stage_bytes = sizeof(T) * (BT + BV) * LD;
  static constexpr size_t s_off = 2 * stage_bytes;
  static constexpr size_t m_off = s_off + sizeof(float) * BT * LDS;
  static constexpr size_t sum_off = m_off + sizeof(float) * BT;
  static constexpr size_t lab_off = sum_off + sizeof(float) * BT;
  static constexpr size_t label_off = lab_off + sizeof(float) * BT;
  static constexpr size_t bytes = label_off + sizeof(int) * BT;
};

struct Params {
  const void* x;
  const void* emb;
  const int* labels;
  const float* bias;  // null when the head has none
  float* lse;
  float* label_logit;
  int tokens, vocab, dim;
  long long x_stride, e_stride;
};

__device__ __forceinline__ float to_float(float x) { return x; }

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

// 16-byte asynchronous copy global -> shared; src_bytes 0 fills zeros.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Issue the copies of the x chunk and the E chunk of step `it` (vocab tile
// it / n_dc, d chunk it % n_dc) into one ring stage. Rows past T or V and
// columns past d are zero.
template <typename T>
__device__ __forceinline__ void load_stage(const Params& p, T* sx, T* se, int t0, int it,
                                          int n_dc) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int CHUNKS = DK / VEC;
  constexpr int LD = Smem<T>::LD;
  const int v0 = (it / n_dc) * BV;
  const int c0 = (it % n_dc) * DK;
  const T* xg = static_cast<const T*>(p.x);
  const T* eg = static_cast<const T*>(p.emb);
  for (int i = threadIdx.x; i < (BT + BV) * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS;
    const int c = (i % CHUNKS) * VEC;
    const bool is_x = r < BT;
    const int row = is_x ? t0 + r : v0 + (r - BT);
    const bool ok = (is_x ? row < p.tokens : row < p.vocab) && c0 + c < p.dim;
    const T* base = is_x ? xg : eg;
    const long long stride = is_x ? p.x_stride : p.e_stride;
    // a zero-size copy still names a valid address: the tensor's first row
    const T* src = ok ? base + row * stride + c0 + c : base;
    T* dst = is_x ? sx + r * LD + c : se + (r - BT) * LD + c;
    cp_async16(dst, src, ok ? 16 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) ce_fwd_kernel(const Params p) {
  using S = Smem<T>;
  constexpr bool kTC = TensorCore<T>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  T* stage[2][2];  // [stage][x, E]
  for (int s = 0; s < 2; ++s) {
    stage[s][0] = reinterpret_cast<T*>(smem + s * S::stage_bytes);
    stage[s][1] = stage[s][0] + BT * S::LD;
  }
  float* sS = reinterpret_cast<float*>(smem + S::s_off);
  float* sM = reinterpret_cast<float*>(smem + S::m_off);
  float* sSum = reinterpret_cast<float*>(smem + S::sum_off);
  float* sLab = reinterpret_cast<float*>(smem + S::lab_off);
  int* sLabel = reinterpret_cast<int*>(smem + S::label_off);

  const int t0 = blockIdx.x * BT;
  const int t_rows = min(BT, p.tokens - t0);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int r0 = warp * ROWS;
  for (int i = threadIdx.x; i < BT; i += THREADS) {
    sM[i] = NEG_INF;
    sSum[i] = 0.0f;
    sLab[i] = 0.0f;
    sLabel[i] = i < t_rows ? p.labels[t0 + i] : -1;
  }

  const int n_vt = (p.vocab + BV - 1) / BV;
  const int n_dc = (p.dim + DK - 1) / DK;
  const int total = n_vt * n_dc;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BV / 16];
  float facc[ROWS][BV / 32];  // fp32 inputs: lane owns columns lane, lane + 32

  load_stage<T>(p, stage[0][0], stage[0][1], t0, 0, n_dc);
  cp_async_commit();
  for (int it = 0; it < total; ++it) {
    const int cur = it & 1;
    if (it + 1 < total) {
      load_stage<T>(p, stage[cur ^ 1][0], stage[cur ^ 1][1], t0, it + 1, n_dc);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this step's chunk has landed for every thread

    const int dc = it % n_dc;
    const T* sx = stage[cur][0] + r0 * S::LD;
    const T* se = stage[cur][1];
    if constexpr (kTC) {
      if (dc == 0) {
#pragma unroll
        for (int j = 0; j < BV / 16; ++j) wmma::fill_fragment(acc[j], 0.0f);
      }
#pragma unroll
      for (int kk = 0; kk < DK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
        wmma::load_matrix_sync(a, sx + kk, S::LD);
#pragma unroll
        for (int j = 0; j < BV / 16; ++j) {
          // E^T as a column-major operand: element (k, n) is E[n][k]
          wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
          wmma::load_matrix_sync(b, se + (16 * j) * S::LD + kk, S::LD);
          wmma::mma_sync(acc[j], a, b, acc[j]);
        }
      }
    } else {
      if (dc == 0) {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int c = 0; c < BV / 32; ++c) facc[i][c] = 0.0f;
      }
      for (int k = 0; k < DK; ++k) {
        float ev[BV / 32];
#pragma unroll
        for (int c = 0; c < BV / 32; ++c) ev[c] = to_float(se[(lane + 32 * c) * S::LD + k]);
#pragma unroll
        for (int i = 0; i < ROWS; ++i) {
          const float xv = to_float(sx[i * S::LD + k]);
#pragma unroll
          for (int c = 0; c < BV / 32; ++c) facc[i][c] = fmaf(xv, ev[c], facc[i][c]);
        }
      }
    }

    if (dc == n_dc - 1) {
      // the vocab tile's logits are complete: fold them into (m, s, label)
      const int v0 = (it / n_dc) * BV;
      if constexpr (kTC) {
#pragma unroll
        for (int j = 0; j < BV / 16; ++j)
          wmma::store_matrix_sync(sS + r0 * S::LDS + 16 * j, acc[j], S::LDS,
                                  wmma::mem_row_major);
      } else {
#pragma unroll
        for (int i = 0; i < ROWS; ++i)
#pragma unroll
          for (int c = 0; c < BV / 32; ++c) sS[(r0 + i) * S::LDS + lane + 32 * c] = facc[i][c];
      }
      __syncwarp();
      for (int i = 0; i < ROWS; ++i) {
        const int r = r0 + i;
        float lg[BV / 32];
        bool ok[BV / 32];
        float mx = NEG_INF;
        float hit = 0.0f;
#pragma unroll
        for (int c = 0; c < BV / 32; ++c) {
          const int col = v0 + lane + 32 * c;
          ok[c] = col < p.vocab;
          lg[c] = sS[r * S::LDS + lane + 32 * c];
          if (ok[c] && p.bias != nullptr) lg[c] += p.bias[col];
          if (ok[c]) mx = fmaxf(mx, lg[c]);
          if (ok[c] && col == sLabel[r]) hit = lg[c];
        }
        mx = warp_max(mx);
        const float m_old = sM[r];
        const float m_new = fmaxf(m_old, mx);
        float sum = 0.0f;
#pragma unroll
        for (int c = 0; c < BV / 32; ++c) sum += ok[c] ? expf(lg[c] - m_new) : 0.0f;
        sum = warp_sum(sum);
        hit = warp_sum(hit);
        __syncwarp();
        if (lane == 0) {
          sSum[r] = sSum[r] * expf(m_old - m_new) + sum;
          sM[r] = m_new;
          sLab[r] += hit;
        }
        __syncwarp();
      }
    }
    __syncthreads();  // every thread is done with this stage before it is refilled
  }

  for (int i = threadIdx.x; i < t_rows; i += THREADS) {
    p.lse[t0 + i] = sM[i] + logf(fmaxf(sSum[i], 1e-30f));
    p.label_logit[t0 + i] = sLab[i];
  }
}

template <typename T>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t bytes = Smem<T>::bytes;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ce_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  ce_fwd_kernel<T><<<(p.tokens + BT - 1) / BT, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16 (x and emb alike). x is
// [tokens, dim] and emb [vocab, dim], rows `x_stride` / `e_stride` elements
// apart, 16-byte aligned, dim a multiple of 16 bytes; labels int32 [tokens];
// bias fp32 [vocab] or null; lse and label_logit fp32 [tokens]. Returns a
// cudaError_t.
extern "C" int ds_fused_ce_fwd(const void* x, const void* emb, const int* labels,
                               const float* bias, float* lse, float* label_logit, int dtype,
                               int tokens, int vocab, int dim, long long x_stride,
                               long long e_stride, void* stream) {
  if (tokens <= 0 || vocab <= 0 || dim <= 0) return (int)cudaErrorInvalidValue;
  Params p;
  p.x = x;
  p.emb = emb;
  p.labels = labels;
  p.bias = bias;
  p.lse = lse;
  p.label_logit = label_logit;
  p.tokens = tokens;
  p.vocab = vocab;
  p.dim = dim;
  p.x_stride = x_stride;
  p.e_stride = e_stride;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return (int)launch<float>(p, st);
    case 1: return (int)launch<__half>(p, st);
    case 2: return (int)launch<__nv_bfloat16>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
