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
// Two routes, fixed by the caller before the launch (ops/cuda/cross_entropy.py
// ce_route): the wgmma route (bf16 / fp16 with d a multiple of 64, every
// preset of the model registry; the second half of this file,
// ds_fused_ce_fwd_wgmma) and the wmma route below (ds_fused_ce_fwd: fp32 and
// any other d it takes).
//
// The wmma route's design (the port's first, simple kernel): one block of 4
// warps per 64-token tile sweeps every 64-column
// vocab tile, as the TPU grid's sequential vocab axis does; each vocab tile's
// logits are accumulated over 64-wide chunks of d with warp-level tensor-core
// MMA (nvcuda::wmma 16x16x16, fp32 accumulate) for bf16/fp16, with fp32 FMAs
// for fp32 inputs. The x and E chunks stream through a two-stage cp.async ring
// in shared memory, so the next chunk's load overlaps the current chunk's
// products. Each warp owns 16 token rows end to end: its finished logit tile
// goes through shared memory once, where its lanes fold it into the running
// (m, s) and pick the label logit; nothing crosses blocks. All blocks sweep E
// in the same order at about the same pace, so E's tiles are shared in L2.
// The C entry points launch on the caller's stream, do not synchronise and
// return the cudaError_t of the launches.

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

// ===================================================================================
// The wgmma route: bf16 / fp16 with d a multiple of 64, on TMA and wgmma.
//
// It is a GEMM (M = T, N = V, K = d) whose epilogue is a row reduction. One
// block per (128-token tile, vocab slice): two consumer warpgroups of 64 token
// rows and a producer warpgroup (one thread issues the loads; setmaxnreg hands
// its registers to the consumers, 24 a thread against their 240). The block
// walks its slice's 256-column vocab tiles; for each, the x chunk [128 x 64]
// and the E chunk [256 x 64] of every 64-wide step of d stream through a
// 4-stage TMA ring (128-byte swizzle, mbarriers), and each warpgroup issues
// wgmma m64n128k16 twice a 16-deep slice (the tile's two column halves), A = x
// and B = E both from shared memory and both K-major as stored: nothing is
// transposed. A step's products run while the next step's are issued (wait
// group 1). The logits stay in the accumulator registers; the epilogue adds
// the bias per column, turns columns at or past V (TMA's zero fill) into -inf,
// picks the label's logit where a column equals the row's label, and folds
// the tile into the thread's running (m, s) with exp2f (log2 e folded into one
// FMA). A thread keeps its own (m, s) over its columns; the 4 lanes that share
// a row combine theirs once, at the end of the slice, and write the slice's
// partial (m, s, label logit) to an fp32 [3, S, T] scratch. A second kernel of
// the same call combines the S partials of each token in slice order: no
// atomics, so the result does not depend on the launch.
//
// Filling the card: 96 token tiles at the training shape are fewer than
// the 132 SMs, so V is cut into S slices (ops/cuda/cross_entropy.py
// ce_vocab_splits: about 8 blocks per SM). L2: E (103 MB at the training
// shape) is twice the 50 MB L2 while x (25 MB) fits, so the grid runs token
// tiles fastest: the blocks in flight together are the token tiles of one or
// two slices, which walk the same E tiles at about the same pace, and each E
// tile comes from device memory about once per slice rather than once per
// token tile (96 x 103 MB = 9.9 GB, about 3 ms at 3.35 TB/s). What is left is
// L2 -> SM traffic: each tile step reads its x and E chunks (48 KB for
// 4.2 MFLOP, 87 FLOP a byte), 14.6 GB at the training shape.
// ===================================================================================

#include "sm90_utils.cuh"  // mbarriers, TMA, wgmma descriptors, tensor-map encoding

namespace wg_route {

using namespace sm90;

constexpr int CONSUMERS = 2;                     // warpgroups of 64 token rows
constexpr int THREADS = (CONSUMERS + 1) * 128;   // + the producer warpgroup
constexpr int PRODUCER_REGS = 24;                // 128 x 24 + 256 x 240 <= 65536
constexpr int CONSUMER_REGS = 240;
constexpr int BM = 64 * CONSUMERS;               // tokens per block
constexpr int BN = 256;                          // vocab columns per tile (two n128 halves)
constexpr int BK = 64;                           // d per step: one 128-byte swizzled panel
constexpr int STAGES = 4;
constexpr int X_BYTES = BM * BK * 2;
constexpr int E_BYTES = BN * BK * 2;
constexpr int STAGE_BYTES = X_BYTES + E_BYTES;
constexpr int BAR_OFF = STAGES * STAGE_BYTES;
constexpr int SMEM_BYTES = BAR_OFF + 16 * STAGES + 1024;   // + slack to align the base to 1024
static_assert(SMEM_BYTES <= 232448, "CE wgmma shared memory");
constexpr float LOG2E = 1.4426950408889634f;
constexpr float M_INIT = -1e30f;   // finite: a running max never meets -inf - -inf

struct Args {
  const int* labels;
  const float* bias;   // null when the head has none
  float* part;         // [3, splits, tokens]: the slices' m, s and label logit
  int tokens, vocab, dim, splits, n_vt;
};

template <typename T, bool BIAS>
__global__ void __launch_bounds__(THREADS, 1)
    ce_wgmma_kernel(__grid_constant__ const CUtensorMap tm_x,
                    __grid_constant__ const CUtensorMap tm_e, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t full0 = base + BAR_OFF;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int t0 = blockIdx.x * BM;
  const int slice = blockIdx.y;
  const int vt0 = (int)((long long)slice * a.n_vt / a.splits);
  const int vt1 = (int)((long long)(slice + 1) * a.n_vt / a.splits);
  const int n_k = a.dim / BK;
  const int steps = (vt1 - vt0) * n_k;

  if (threadIdx.x == 0) {
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
      for (int it = 0; it < steps; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(empty0 + 8 * st, (uint32_t)(it / STAGES + 1) & 1u);
        const int v0 = (vt0 + it / n_k) * BN;
        const int k0 = (it % n_k) * BK;
        const uint32_t dst = base + st * STAGE_BYTES;
        const uint32_t bar = full0 + 8 * st;
        mbar_expect_tx(bar, STAGE_BYTES);   // out-of-bounds rows arrive as zeros, counted
        tma_load_2d(dst, &tm_x, bar, k0, t0);
        tma_load_2d(dst + X_BYTES, &tm_e, bar, k0, v0);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2;
  const int r0 = t0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);   // rows r0, r0 + 8
  const int cq = 2 * (lane & 3);
  int label[2];
  float m[2], s[2], lab[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    label[h] = r0 + 8 * h < a.tokens ? a.labels[r0 + 8 * h] : -1;
    m[h] = M_INIT;
    s[h] = 0.0f;
    lab[h] = 0.0f;
  }
  // acc[nh][4 j + 2 h + e]: row r0 + 8 h, column v0 + 128 nh + 8 j + cq + e
  float acc[2][64];

  // one tile's logits (in acc) into (m, s, lab)
  const auto fold = [&](int v0) {
    const bool ragged = v0 + BN > a.vocab;
    float tmax[2] = {M_INIT, M_INIT};
#pragma unroll
    for (int nh = 0; nh < 2; ++nh)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = v0 + 128 * nh + 8 * j + cq + e;
          const bool out = ragged && col >= a.vocab;
          float bv = 0.0f;
          if constexpr (BIAS) bv = out ? 0.0f : __ldg(a.bias + col);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            float v = acc[nh][4 * j + 2 * h + e];
            if constexpr (BIAS) v += bv;
            v = out ? -INFINITY : v;
            acc[nh][4 * j + 2 * h + e] = v;
            tmax[h] = fmaxf(tmax[h], v);
          }
        }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // the label's column, if this tile holds it in this thread's columns
      const int c = label[h] - v0 - cq;
      if ((unsigned)c < (unsigned)BN && (c & 6) == 0) {
        const int g = c >> 3;
        float v = 0.0f;
#pragma unroll
        for (int nh = 0; nh < 2; ++nh)
#pragma unroll
          for (int j = 0; j < 16; ++j)
            if (16 * nh + j == g)
              v = (c & 1) ? acc[nh][4 * j + 2 * h + 1] : acc[nh][4 * j + 2 * h];
        lab[h] = v;
      }
      const float m_new = fmaxf(m[h], tmax[h]);
      s[h] *= fast_exp2((m[h] - m_new) * LOG2E);
      m[h] = m_new;
    }
    const float mb[2] = {-m[0] * LOG2E, -m[1] * LOG2E};
    float sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int nh = 0; nh < 2; ++nh)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sum[h] += fast_exp2(fmaf(acc[nh][4 * j + 2 * h + e], LOG2E, mb[h]));
    s[0] += sum[0];
    s[1] += sum[1];
  };
  const auto release = [&](int it) {
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * (it % STAGES));
  };

  int it = 0;
  for (int vt = vt0; vt < vt1; ++vt) {
    for (int kc = 0; kc < n_k; ++kc, ++it) {
      const int st = it % STAGES;
      mbar_wait(full0 + 8 * st, (uint32_t)(it / STAGES) & 1u);
      const uint32_t xs = base + st * STAGE_BYTES + wg * 64 * 128;
      const uint32_t es = base + st * STAGE_BYTES + X_BYTES;
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint64_t da = sw128_desc(xs + 32 * kk);
        const int accumulate = kc > 0 || kk > 0;
        wgmma_ss_n128<T>(acc[0], da, sw128_desc(es + 32 * kk), accumulate);
        wgmma_ss_n128<T>(acc[1], da, sw128_desc(es + 128 * 128 + 32 * kk), accumulate);
      }
      wgmma_commit();
      wgmma_wait<1>();   // the previous step's products are done
      fence_regs(acc[0]);
      fence_regs(acc[1]);
      if (kc > 0) release(it - 1);
    }
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    release(it - 1);
    fold(vt * BN);
  }

  // the 4 lanes of a row combine their (m, s, lab); lane 0 of the four writes
  const long long plane = (long long)a.splits * a.tokens;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mq = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    mq = fmaxf(mq, __shfl_xor_sync(0xffffffffu, mq, 2));
    float sq = s[h] * fast_exp2((m[h] - mq) * LOG2E);
    sq += __shfl_xor_sync(0xffffffffu, sq, 1);
    sq += __shfl_xor_sync(0xffffffffu, sq, 2);
    float lq = lab[h] + __shfl_xor_sync(0xffffffffu, lab[h], 1);
    lq += __shfl_xor_sync(0xffffffffu, lq, 2);
    const int row = r0 + 8 * h;
    if ((lane & 3) == 0 && row < a.tokens) {
      const long long at = (long long)slice * a.tokens + row;
      a.part[at] = mq;
      a.part[plane + at] = sq;
      a.part[2 * plane + at] = lq;
    }
  }
}

// lse and label logit of each token from the slices' partials, in slice order
__global__ void ce_combine_kernel(const float* __restrict__ part, float* __restrict__ lse,
                                  float* __restrict__ label_logit, int tokens, int splits) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= tokens) return;
  const long long plane = (long long)splits * tokens;
  float m = M_INIT;
  for (int i = 0; i < splits; ++i) m = fmaxf(m, part[(long long)i * tokens + t]);
  float s = 0.0f, l = 0.0f;
  for (int i = 0; i < splits; ++i) {
    const long long at = (long long)i * tokens + t;
    s += part[plane + at] * expf(part[at] - m);
    l += part[2 * plane + at];
  }
  lse[t] = m + logf(fmaxf(s, 1e-30f));
  label_logit[t] = l;
}

template <typename T, bool BIAS>
cudaError_t launch(const void* x, const void* emb, float* lse_out, float* lab_out,
                   const Args& a, long long x_stride, long long e_stride, cudaStream_t stream) {
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  auto kernel = ce_wgmma_kernel<T, BIAS>;
  // a runtime call first: it makes the device's context current on this
  // thread, which encoding a tensor map through the driver needs
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return err;
  CUtensorMap tx, te;
  if (!encode_2d(&tx, type, x, a.dim, a.tokens, (uint64_t)x_stride * 2, BK, BM,
                 CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode_2d(&te, type, emb, a.dim, a.vocab, (uint64_t)e_stride * 2, BK, BN,
                 CU_TENSOR_MAP_SWIZZLE_128B))
    return cudaErrorInvalidValue;
  kernel<<<dim3((a.tokens + BM - 1) / BM, a.splits), THREADS, SMEM_BYTES, stream>>>(tx, te, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ce_combine_kernel<<<(a.tokens + 255) / 256, 256, 0, stream>>>(
      a.part, lse_out, lab_out, a.tokens, a.splits);
  return cudaGetLastError();
}

}  // namespace wg_route

// The wgmma route: dtype 1 = float16, 2 = bfloat16; dim a multiple of 64;
// the arguments as ds_fused_ce_fwd's (rows 16-byte aligned, strides a
// multiple of 8 elements: TMA), plus `splits`, the number of vocab slices (1
// to ceil(vocab / 256)), and `scratch`, the caller's fp32 buffer of 3 *
// splits * tokens floats. Returns a cudaError_t; what the route does not take
// is cudaErrorInvalidValue.
extern "C" int ds_fused_ce_fwd_wgmma(const void* x, const void* emb, const int* labels,
                                     const float* bias, float* lse, float* label_logit,
                                     float* scratch, int dtype, int tokens, int vocab, int dim,
                                     long long x_stride, long long e_stride, int splits,
                                     void* stream) {
  const int n_vt = vocab > 0 ? (vocab + wg_route::BN - 1) / wg_route::BN : 0;
  if (tokens <= 0 || vocab <= 0 || dim <= 0 || dim % wg_route::BK != 0 || splits < 1 ||
      splits > n_vt || splits > 65535 || x_stride % 8 != 0 || e_stride % 8 != 0)
    return (int)cudaErrorInvalidValue;
  wg_route::Args a;
  a.labels = labels;
  a.bias = bias;
  a.part = scratch;
  a.tokens = tokens;
  a.vocab = vocab;
  a.dim = dim;
  a.splits = splits;
  a.n_vt = n_vt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool has_bias = bias != nullptr;
  switch (dtype) {
    case 1:
      return (int)(has_bias ? wg_route::launch<__half, true>(x, emb, lse, label_logit, a, x_stride,
                                                             e_stride, st)
                            : wg_route::launch<__half, false>(x, emb, lse, label_logit, a,
                                                              x_stride, e_stride, st));
    case 2:
      return (int)(has_bias ? wg_route::launch<__nv_bfloat16, true>(x, emb, lse, label_logit, a,
                                                                    x_stride, e_stride, st)
                            : wg_route::launch<__nv_bfloat16, false>(x, emb, lse, label_logit,
                                                                     a, x_stride, e_stride, st));
    default:
      return (int)cudaErrorInvalidValue;
  }
}
