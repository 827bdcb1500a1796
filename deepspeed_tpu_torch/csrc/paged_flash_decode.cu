// Paged flash-decode for Hopper (sm_90a), bf16 / fp16 / fp32, on a pool of the
// compute type or an int8 pool with per-(token, head) fp32 scales.
//
// Replaces the Pallas TPU kernel of deepspeed_tpu/ops/pallas/paged_attention.py:
// _decode_kernel (pallas_call in paged_flash_decode), and the combine that
// follows that call there. One query row per slot attends to the slot's
// positions [0, pos[s]) of a paged KV pool, plus the fresh k/v row of the
// current token (logically at pos[s], not yet in the pool):
//
//   out[s, h, :] = softmax_j(scale * q[s, h, :] . k_j + alibi_h (j - pos[s])) v_j
//
// with k_j, v_j at pool block table[s, j / bs], row j % bs, kv head
// g = h / (n_heads / kv_heads) for j < pos[s], and the fresh row at j = pos[s].
// The pool is [n_blocks, bs, kv_heads, head_dim] (one layer), read through
// the strides the caller gives; head_dim is 64 or 128.
//
// The int8 pool (the int8 branch of the TPU kernel, _decode_kernel's
// `if int8`) holds int8 rows and fp32 scales [n_blocks, bs, kv_heads, 1]:
// each staged row is dequantized as float(q) * scale and rounded to the
// compute type, as the TPU kernel's (k.astype(f32) * ks).astype(q.dtype),
// and the rest of the kernel runs unchanged on the staged tile. A (token,
// head) then moves 2 * (head_dim + 4) bytes instead of 4 * head_dim in bf16:
// 132 against 256 at head_dim 128.
//
// What bounds it on an H100 SXM: bytes. Each (slot, kv head) reads its valid
// K and V rows once, 2 * pos * head_dim elements, and does 4 * hq * head_dim
// operations per row: about 2 operations per byte in bf16, far below the
// ~295 the card needs before its tensor cores become the limit. So the
// least time is the bytes of the valid K/V windows, q and out at 3.35 TB/s,
// and the design reads nothing else:
//   * blocks whose base is at or past pos[s] are never read (on the TPU the
//     BlockSpec DMA still landed on the garbage block); rows of the last
//     block at or past the cursor are not loaded either;
//   * the grid is one block of 4 warps per (split, kv head, slot). A split is
//     a contiguous run of table columns; each block reads table[s, j] from
//     global memory itself (no scalar prefetch, no index map) and runs the
//     hq = n_heads / kv_heads query rows of its kv head (GQA);
//   * K and V rows are staged through shared memory in tiles of 32 tokens
//     with 16-byte loads; q.k runs in fp32, one warp per (query row, token)
//     with a shuffle reduction; an online softmax (m, l, acc) in fp32 lives
//     in shared memory; P is rounded to the input type before P.V, as the TPU
//     kernel's p.astype(v.dtype) (the fresh row's weight is not);
//   * each split writes its partial (acc, m, l); a second kernel per (kv
//     head, slot) combines the splits, folds in the fresh row and writes out
//     in the input type. Splits with no valid position write (0, -1e30, 0)
//     and drop out of the combine.
// The C entry point launches both kernels on the caller's stream, does not
// synchronise and returns the cudaError_t of the launches.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 32;                 // tokens staged per step
constexpr float NEG_INF = -1e30f;

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

// x rounded to T and back (the P rounding); exact for fp32
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float<T>(from_float<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

struct Params {
  const void* q;        // [S, n_heads, dh]
  const void* k_new;    // [S, kv_heads, dh]
  const void* v_new;
  const void* kc;       // [n_blocks, bs, kv_heads, dh]
  const void* vc;
  const float* k_scale; // int8 pool: [n_blocks, bs, kv_heads, 1]; else null
  const float* v_scale;
  const int* table;     // [S, nb_cols]
  const int* pos;       // [S]
  const float* slopes;  // [n_heads] or null
  float* acc;           // [S, kv_heads, splits, hq, dh]
  float* m;             // [S, kv_heads, splits, hq]
  float* l;
  void* out;            // [S, n_heads, dh]
  int n_heads, kv_heads, block_size, nb_cols, splits;
  long long q_ss, q_sh, kn_ss, kn_sh, vn_ss, vn_sh;
  long long c_sb, c_st, c_sh;   // pool strides (k and v alike)
  long long s_sb, s_st, s_sh;   // scale strides (k and v alike)
  long long t_ss;
  long long o_ss, o_sh;
  float scale;
};

template <typename T, int DH>
struct SplitSmem {
  // k, v tiles (T, 16-byte aligned rows), then fp32 q, acc, scores, m, l, corr
  static size_t bytes(int hq) {
    return sizeof(T) * 2 * TILE * DH + sizeof(float) * (2 * hq * DH + hq * TILE + 3 * hq);
  }
};

// T: the compute type; P: the pool's element type (T, or int8_t)
template <typename T, typename P, int DH>
__global__ void __launch_bounds__(THREADS) paged_decode_split_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sp = blockIdx.x, g = blockIdx.y, s = blockIdx.z;
  const int hq = p.n_heads / p.kv_heads;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  T* k_sh = reinterpret_cast<T*>(smem);
  T* v_sh = k_sh + TILE * DH;
  float* q_sh = reinterpret_cast<float*>(v_sh + TILE * DH);
  float* acc_sh = q_sh + hq * DH;
  float* sc_sh = acc_sh + hq * DH;
  float* m_sh = sc_sh + hq * TILE;
  float* l_sh = m_sh + hq;
  float* corr_sh = l_sh + hq;

  const int cursor = p.pos[s];
  const T* qg = static_cast<const T*>(p.q) + s * p.q_ss + (long long)(g * hq) * p.q_sh;
  for (int e = tid; e < hq * DH; e += THREADS) {
    q_sh[e] = to_float<T>(qg[(e / DH) * p.q_sh + (e % DH)]);
    acc_sh[e] = 0.f;
  }
  for (int h = tid; h < hq; h += THREADS) {
    m_sh[h] = NEG_INF;
    l_sh[h] = 0.f;
  }
  __syncthreads();

  constexpr int VEC = 16 / (int)sizeof(P);   // pool elements per 16-byte load
  constexpr int VPR = DH / VEC;              // 16-byte loads per row
  const int bps = p.nb_cols / p.splits;
  const int* trow = p.table + s * p.t_ss;
  for (int jb = 0; jb < bps; ++jb) {
    const int col = sp * bps + jb;
    const int base = col * p.block_size;
    if (base >= cursor) break;               // the rest of the split is past the cursor
    const long long bid = trow[col];
    const int n_valid = min(p.block_size, cursor - base);
    const P* kb = static_cast<const P*>(p.kc) + bid * p.c_sb + g * p.c_sh;
    const P* vb = static_cast<const P*>(p.vc) + bid * p.c_sb + g * p.c_sh;
    for (int t0 = 0; t0 < n_valid; t0 += TILE) {
      const int nt = min(TILE, n_valid - t0);
      for (int e = tid; e < nt * VPR; e += THREADS) {
        const int t = e / VPR, c = (e % VPR) * VEC;
        const uint4 kraw = *reinterpret_cast<const uint4*>(kb + (t0 + t) * p.c_st + c);
        const uint4 vraw = *reinterpret_cast<const uint4*>(vb + (t0 + t) * p.c_st + c);
        if constexpr (std::is_same<P, int8_t>::value) {
          // dequantize on the staged tile: float(q) * scale, rounded to T
          const long long si = bid * p.s_sb + (t0 + t) * p.s_st + g * p.s_sh;
          const float ks = p.k_scale[si], vs = p.v_scale[si];
          const int8_t* kq = reinterpret_cast<const int8_t*>(&kraw);
          const int8_t* vq = reinterpret_cast<const int8_t*>(&vraw);
          // dequantized in registers, stored 16 bytes at a time
          alignas(16) T kd[VEC], vd[VEC];
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            kd[i] = from_float<T>((float)kq[i] * ks);
            vd[i] = from_float<T>((float)vq[i] * vs);
          }
          constexpr int CHUNKS = VEC * (int)sizeof(T) / 16;
#pragma unroll
          for (int j = 0; j < CHUNKS; ++j) {
            reinterpret_cast<uint4*>(k_sh + t * DH + c)[j] = reinterpret_cast<const uint4*>(kd)[j];
            reinterpret_cast<uint4*>(v_sh + t * DH + c)[j] = reinterpret_cast<const uint4*>(vd)[j];
          }
        } else {
          *reinterpret_cast<uint4*>(k_sh + t * DH + c) = kraw;
          *reinterpret_cast<uint4*>(v_sh + t * DH + c) = vraw;
        }
      }
      __syncthreads();
      // scores: one warp per (query row, token)
      for (int pr = warp; pr < hq * nt; pr += WARPS) {
        const int h = pr / nt, t = pr % nt;
        float dot = 0.f;
        for (int d = lane; d < DH; d += 32) dot += q_sh[h * DH + d] * to_float<T>(k_sh[t * DH + d]);
        dot = warp_sum(dot);
        if (lane == 0) {
          float sc = dot * p.scale;
          if (p.slopes != nullptr)   // int distance first, then the fp32 multiply
            sc += p.slopes[g * hq + h] * (float)(base + t0 + t - cursor);
          sc_sh[h * TILE + t] = sc;
        }
      }
      __syncthreads();
      // online softmax: one warp per query row; P overwrites the scores
      for (int h = warp; h < hq; h += WARPS) {
        float tmax = NEG_INF;
        for (int t = lane; t < nt; t += 32) tmax = fmaxf(tmax, sc_sh[h * TILE + t]);
        tmax = warp_max(tmax);
        const float m_prev = m_sh[h];
        const float m_new = fmaxf(m_prev, tmax);
        float sum = 0.f;
        for (int t = lane; t < nt; t += 32) {
          const float pv = expf(sc_sh[h * TILE + t] - m_new);
          sc_sh[h * TILE + t] = pv;
          sum += pv;
        }
        sum = warp_sum(sum);
        if (lane == 0) {
          const float corr = expf(m_prev - m_new);
          l_sh[h] = l_sh[h] * corr + sum;
          m_sh[h] = m_new;
          corr_sh[h] = corr;
        }
      }
      __syncthreads();
      // acc = acc * corr + round(P) V
      for (int e = tid; e < hq * DH; e += THREADS) {
        const int h = e / DH, d = e % DH;
        float a = acc_sh[e] * corr_sh[h];
        for (int t = 0; t < nt; ++t) a += round_to<T>(sc_sh[h * TILE + t]) * to_float<T>(v_sh[t * DH + d]);
        acc_sh[e] = a;
      }
      __syncthreads();
    }
  }
  const long long part = ((long long)(s * p.kv_heads + g) * p.splits + sp) * hq;
  for (int e = tid; e < hq * DH; e += THREADS) p.acc[part * DH + e] = acc_sh[e];
  for (int h = tid; h < hq; h += THREADS) {
    p.m[part + h] = m_sh[h];
    p.l[part + h] = l_sh[h];
  }
}

// one block per (kv head, slot): combine the splits, fold in the fresh row
template <typename T, int DH>
__global__ void __launch_bounds__(THREADS) paged_decode_combine_kernel(Params p) {
  const int g = blockIdx.x, s = blockIdx.y;
  const int hq = p.n_heads / p.kv_heads;
  const int lane = threadIdx.x & 31;
  const T* kn = static_cast<const T*>(p.k_new) + s * p.kn_ss + g * p.kn_sh;
  const T* vn = static_cast<const T*>(p.v_new) + s * p.vn_ss + g * p.vn_sh;
  for (int h = 0; h < hq; ++h) {
    const int head = g * hq + h;
    const long long part0 = (long long)(s * p.kv_heads + g) * p.splits * hq + h;
    float m_c = NEG_INF;
    for (int sp = 0; sp < p.splits; ++sp) m_c = fmaxf(m_c, p.m[part0 + (long long)sp * hq]);
    float l_c = 0.f;
    for (int sp = 0; sp < p.splits; ++sp) {
      const long long i = part0 + (long long)sp * hq;
      l_c += p.l[i] * expf(p.m[i] - m_c);
    }
    // the fresh row's score: every warp reduces the same dot product
    const T* qh = static_cast<const T*>(p.q) + s * p.q_ss + head * p.q_sh;
    float dot = 0.f;
    for (int d = lane; d < DH; d += 32) dot += to_float<T>(qh[d]) * to_float<T>(kn[d]);
    const float s_new = warp_sum(dot) * p.scale;
    const float m_t = fmaxf(m_c, s_new);
    const float corr = expf(m_c - m_t);
    const float w_new = expf(s_new - m_t);
    const float l_t = l_c * corr + w_new;
    T* og = static_cast<T*>(p.out) + s * p.o_ss + head * p.o_sh;
    for (int d = threadIdx.x; d < DH; d += THREADS) {
      float a = 0.f;
      for (int sp = 0; sp < p.splits; ++sp) {
        const long long i = part0 + (long long)sp * hq;
        a += p.acc[i * DH + d] * expf(p.m[i] - m_c);
      }
      a = a * corr + w_new * to_float<T>(vn[d]);
      og[d] = from_float<T>(a / fmaxf(l_t, 1e-30f));
    }
  }
}

template <typename T, typename P, int DH>
cudaError_t launch(const Params& p, int n_slots, cudaStream_t stream) {
  const int hq = p.n_heads / p.kv_heads;
  const size_t bytes = SplitSmem<T, DH>::bytes(hq);
  // above 48 KB of shared memory a kernel must opt in (per device, so on
  // every such launch rather than once per process); at or below it, as for
  // one query head per kv head, no host call is spent on it
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_split_kernel<T, P, DH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return err;
  }
  paged_decode_split_kernel<T, P, DH>
      <<<dim3(p.splits, p.kv_heads, n_slots), THREADS, bytes, stream>>>(p);
  const cudaError_t err1 = cudaGetLastError();
  if (err1 != cudaSuccess) return err1;
  paged_decode_combine_kernel<T, DH><<<dim3(p.kv_heads, n_slots), THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, typename P>
cudaError_t launch_d(const Params& p, int n_slots, int head_dim, cudaStream_t stream) {
  if (head_dim == 64) return launch<T, P, 64>(p, n_slots, stream);
  if (head_dim == 128) return launch<T, P, 128>(p, n_slots, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_pool(const Params& p, bool int8_pool, int n_slots, int head_dim,
                        cudaStream_t stream) {
  if (int8_pool) return launch_d<T, int8_t>(p, n_slots, head_dim, stream);
  return launch_d<T, T>(p, n_slots, head_dim, stream);
}

}  // namespace

// Bytes of shared memory one block of `device` may opt in to, or -1.
extern "C" int ds_paged_decode_smem_optin(int device) {
  int bytes = 0;
  const cudaError_t err =
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return err == cudaSuccess ? bytes : -1;
}

// dtype (of q, the fresh rows and out): 0 = float32, 1 = float16, 2 = bfloat16.
// int8_pool: 0 = kc/vc hold dtype and k_scale/v_scale are null; 1 = kc/vc are
// int8 and k_scale/v_scale fp32 [n_blocks, bs, kv_heads, 1] with the strides
// s_sb, s_st, s_sh (shared by both). table and pos are int32;
// slopes is fp32 [n_heads] or null; acc/m/l are the caller's fp32 scratch of
// [S, kv_heads, splits, hq, dh] and [S, kv_heads, splits, hq]. Strides are in
// elements; the last dimension of every tensor is contiguous; k and v pools
// share their strides. Returns a cudaError_t.
extern "C" int ds_paged_flash_decode(
    const void* q, const void* k_new, const void* v_new, const void* kc, const void* vc,
    const void* k_scale, const void* v_scale, const void* table, const void* pos,
    const void* slopes, void* acc, void* m, void* l, void* out, int dtype, int int8_pool,
    int n_slots, int n_heads, int kv_heads, int head_dim, int block_size, int nb_cols,
    int splits, long long q_ss, long long q_sh, long long kn_ss, long long kn_sh,
    long long vn_ss, long long vn_sh, long long c_sb, long long c_st, long long c_sh,
    long long s_sb, long long s_st, long long s_sh, long long t_ss, long long o_ss,
    long long o_sh, float scale, void* stream) {
  if (n_slots <= 0 || n_heads <= 0 || kv_heads <= 0 || n_heads % kv_heads != 0 ||
      block_size <= 0 || nb_cols <= 0 || splits <= 0 || nb_cols % splits != 0 ||
      (int8_pool && (k_scale == nullptr || v_scale == nullptr)))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q; p.k_new = k_new; p.v_new = v_new; p.kc = kc; p.vc = vc;
  p.k_scale = static_cast<const float*>(k_scale);
  p.v_scale = static_cast<const float*>(v_scale);
  p.table = static_cast<const int*>(table);
  p.pos = static_cast<const int*>(pos);
  p.slopes = static_cast<const float*>(slopes);
  p.acc = static_cast<float*>(acc);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.out = out;
  p.n_heads = n_heads; p.kv_heads = kv_heads; p.block_size = block_size;
  p.nb_cols = nb_cols; p.splits = splits;
  p.q_ss = q_ss; p.q_sh = q_sh; p.kn_ss = kn_ss; p.kn_sh = kn_sh;
  p.vn_ss = vn_ss; p.vn_sh = vn_sh;
  p.c_sb = c_sb; p.c_st = c_st; p.c_sh = c_sh;
  p.s_sb = s_sb; p.s_st = s_st; p.s_sh = s_sh;
  p.t_ss = t_ss; p.o_ss = o_ss; p.o_sh = o_sh;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dtype) {
    case 0: err = launch_pool<float>(p, int8_pool != 0, n_slots, head_dim, st); break;
    case 1: err = launch_pool<__half>(p, int8_pool != 0, n_slots, head_dim, st); break;
    case 2: err = launch_pool<__nv_bfloat16>(p, int8_pool != 0, n_slots, head_dim, st); break;
    default: err = cudaErrorInvalidValue;
  }
  return (int)err;
}
