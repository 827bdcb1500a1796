// The flash-attention forward on Hopper (sm_90a) with TMA and wgmma, bf16 /
// fp16 at head_dim 64, 80, 96, 128 and 256, driven by a tile schedule: shared
// by the dense flash forward (csrc/flash_attention_fwd.cu, the dense causal
// range, every width) and the block-sparse forward
// (csrc/block_sparse_attention.cu, the layout's lists, every width too).
//
// One block per (batch*head, 128-row q tile), 384 threads: two consumer
// warpgroups own 64 q rows each, and one thread of a producer warpgroup
// issues every load (the producer gives its registers up to the consumers
// with setmaxnreg: 24 a thread against their 240). The producer loads the q
// tile once by TMA and streams the K and V tiles of the schedule (128 rows
// each; 64 at head_dim 256, which keeps the rings inside 227 KB) through two
// rings of 2 stages, one for K and one for V: a stage's
// `full` mbarrier completes when its bytes have landed, its `empty` mbarrier
// when all 8 consumer warps have released it. K and V have rings of their own
// because they are released at different times (below). The tensor maps
// cover [b, s, h, d] through the caller's strides, so rows past s_kv (or s_q)
// arrive as zeros; each 64-column panel of a tile is one TMA box with the
// 128-byte swizzle.
//
// Head dims that are no multiple of 64 (80, 96) are padded to whole panels
// (DP = 128): the second panel's box reads the 16 or 32 real columns and TMA
// fills the rest with zeros. S = Q K^T issues only D / 16 k-steps (the real
// columns); P V runs at N = DP, because wgmma reads an MN-major B through the
// 128-byte swizzle in whole 64-column atoms, so its padded columns of O are
// computed (as zeros) and never stored: the epilogue writes the D real ones.
//
// Per kv tile t a consumer warpgroup
//   * issues S_t = Q K_t^T (wgmma m64nBKVk16, A = its q rows, B = the K tile,
//     both K-major from shared memory), then rescales O by the previous
//     tile's correction and issues O += P_{t-1} V_{t-1} (wgmma m64nDPk16, A =
//     P_{t-1} from registers, rounded to the input type as the TPU kernels'
//     p.astype(v.dtype); B = the V tile read MN-major, the transpose bit, so V
//     is never transposed in memory); both run asynchronously;
//   * waits for S_t only, releases K_t, and runs the online softmax of S_t on
//     the accumulator layout while P_{t-1} V_{t-1} is still on the tensor
//     cores: each thread holds two rows, a row's max is reduced over the 4
//     lanes sharing it, the logits are scaled by scale * log2(e) and
//     exponentiated with ex2, the row sums stay per thread until the end;
//     masking (the causal diagonal, columns past s_kv) is applied only to
//     the tiles that need it, each tile's first key taken from the schedule;
//   * waits for P_{t-1} V_{t-1}, releases V_{t-1} and packs P_t.
// The two warpgroups take turns to issue their products (named barriers, a
// ping-pong), so one's softmax overlaps the other's products. The epilogue
// adds the last P V, reduces the row sums over the quad, divides, and stores
// o (and, when the caller asks for it, the natural-log lse = m ln 2 + log(l))
// straight from registers. S, P and the O accumulator never leave registers.
//
// A schedule says which q tile a grid position is and which kv tiles it walks:
//   * DenseFwd (the flash forward): q tiles from the last (the longest causal
//     rows first), kv tiles 0 .. the causal diagonal;
//   * ListFwd (the block-sparse forward): a layout block is a multiple of 64
//     tokens, so each warpgroup's 64 q rows lie in one q block. A q tile
//     walks the kv tiles (128 rows where the block is a multiple of 128,
//     else 64; 64 at head_dim 256) of the kv blocks of the ascending union of
//     its two halves' forward lists; a warpgroup whose q block does not list
//     the entry masks the whole tile (S = -inf), so both keep the one
//     producer stream. With causal masking a tile wholly past the diagonal
//     is skipped, not masked. The grid rows take the q tiles in the host's
//     heavy-first order (SparseLayout.q_tiles).
// A q tile whose schedule holds no tile writes o = 0 and lse = -1e30 +
// log(1e-30), what the plain version writes for a row that sees no key.

#pragma once

#include "sm90_utils.cuh"  // mbarriers, TMA, wgmma descriptors, tensor-map encoding

namespace flash_fwd_sm90 {

using namespace sm90;

constexpr int CONSUMERS = 2;                        // warpgroups of 64 q rows
constexpr int THREADS = (CONSUMERS + 1) * 128;      // + the producer warpgroup
// registers a thread after the producer warpgroup gives up its share:
// 128 x 24 + 256 x 240 <= 65536
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_BIG = -1e30f;                   // the plain version's running max at start

// KV: the kv tile's rows where the schedule fixes them (a layout of 64-token
// blocks: 64), else 0 for the width's own
template <int D, int KV = 0>
struct Cfg {
  static_assert(D % 16 == 0 && D <= 256, "wgmma forward head_dim");
  static constexpr int DP = (D + 63) / 64 * 64;     // the width in whole 64-column panels
  static constexpr int BQ = 64 * CONSUMERS;
  // head_dim 256: 64 + 4 x 32 KB of tiles
  static constexpr int BKV = KV ? KV : DP > 128 ? 64 : 128;
  // 64-row tiles of at most 128 columns: twice the stages in the same bytes
  static constexpr int STAGES = BKV == 64 && DP <= 128 ? 4 : 2;
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_BYTES = BQ * DP * 2;       // TMA's zero fill counts as bytes
  static constexpr int KV_BYTES = BKV * DP * 2;     // one K or V tile
  static constexpr int k_off = Q_BYTES;             // the K ring, then the V ring
  static constexpr int v_off = k_off + STAGES * KV_BYTES;
  static constexpr int bar_off = v_off + STAGES * KV_BYTES;
  // the q barrier, then full_k, full_v, empty_k, empty_v [STAGES] each; +
  // slack to align the base to 1024 (the swizzle's period)
  static constexpr int bytes = bar_off + 8 * (1 + 4 * STAGES) + 1024;
  static_assert(bytes <= 232448, "wgmma forward shared memory");
};

struct Args {
  void* o;
  float* lse;   // [b, heads, s_q] fp32, or null when the caller needs no lse
  int heads, kv_heads, s_q, s_kv;
  long long o_sb, o_ss, o_sh;
  float scale;
  int causal;
};

// -- schedules ----------------------------------------------------------------------

struct NoParams {};

// the dense range: q tiles from the last, kv tiles up to the causal diagonal
template <int BQ, int BKV>
struct DenseFwd {
  using Params = NoParams;
  int q0, n;
  __device__ DenseFwd(const Args& a, const Params&) {
    q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    int kv_end = a.s_kv;
    if (a.causal) kv_end = min(a.s_kv, q0 + min(BQ, a.s_q - q0) + a.s_kv - a.s_q);
    n = (kv_end + BKV - 1) / BKV;
  }
  struct Cursor {
    int t;
    __device__ int next() { return BKV * t++; }   // the next kv tile's first key
    __device__ bool owns(int) const { return true; }
  };
  __device__ Cursor cursor() const { return Cursor{0}; }
};

// the block-sparse forward: the kv tiles of each kv block of a q tile's union list
template <int BQ, int BKV>
using ListFwd = ListQ<BQ, BKV>;

// -- the kernel ---------------------------------------------------------------------

// named barriers 1 and 2: warpgroup w waits on 1 + w for its turn to issue
// products and hands the turn to the other with an arrive
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(CONSUMERS * 128) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, %1;" ::"r"(2 - wg), "n"(CONSUMERS * 128) : "memory");
}

// the online softmax of one S tile for this thread's two rows: S becomes P
// (unrounded), m (log2 domain) and the per-thread row sums l advance, and
// corr is the factor the O accumulator must be rescaled by; `dead` (a tile
// this warpgroup's q block does not list) masks every element
template <int BKV, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[BKV / 2], float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sl2, int row0, int col0,
                                             int limit_off, int s_kv, int causal, bool dead) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = s[4 * j + 2 * h + e] * sl2;
        if constexpr (MASK) {
          const int col = col0 + 8 * j + e;
          if (dead || col >= s_kv || (causal && col > row0 + 8 * h + limit_off)) x = -INFINITY;
        }
        s[4 * j + 2 * h + e] = x;
        mx = fmaxf(mx, x);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx);
    const float m_use = m_new == -INFINITY ? 0.0f : m_new;   // a row with nothing seen yet
    corr[h] = fast_exp2(m[h] - m_use);
    float sum = 0.0f;
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = fast_exp2(s[4 * j + 2 * h + e] - m_use);
        s[4 * j + 2 * h + e] = p;
        sum += p;
      }
    }
    l[h] = l[h] * corr[h] + sum;
    m[h] = m_new;
  }
}

template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2], const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      o[4 * j + 2 * h] *= corr[h];
      o[4 * j + 2 * h + 1] *= corr[h];
    }
}

template <typename T, int D, template <int, int> class Sched, int KV>
__global__ void __launch_bounds__(THREADS, 1)
    fwd_kernel(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_k,
               __grid_constant__ const CUtensorMap tm_v, const Args p,
               const typename Sched<Cfg<D, KV>::BQ, Cfg<D, KV>::BKV>::Params sp) {
  using C = Cfg<D, KV>;
  constexpr int BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES, DP = C::DP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t q_bar = base + C::bar_off;
  const uint32_t full_k = q_bar + 8, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES, empty_v = empty_k + 8 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int bh = blockIdx.x;
  const int b = bh / p.heads;
  const int h = bh % p.heads;
  const int g = h / (p.heads / p.kv_heads);
  const Sched<BQ, BKV> sc(p, sp);
  const int q0 = sc.q0;
  const int q_offset = p.s_kv - p.s_q;
  const int n_tiles = sc.n;

  if (threadIdx.x == 0) {
    mbar_init(q_bar, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k + 8 * st, 1);
      mbar_init(full_v + 8 * st, 1);
      mbar_init(empty_k + 8 * st, CONSUMERS * 4);
      mbar_init(empty_v + 8 * st, CONSUMERS * 4);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp >= CONSUMERS * 4) {
    // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMERS * 4 && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(q_bar, C::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::PANELS; ++pn)
        tma_load_4d(base + pn * BQ * 128, &tm_q, q_bar, 64 * pn, q0, h, b);
      auto cur = sc.cursor();
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const uint32_t phase = (uint32_t)(t / STAGES + 1) & 1u;
        const int kv0 = cur.next();
        if (t >= STAGES) mbar_wait(empty_k + 8 * st, phase);
        mbar_expect_tx(full_k + 8 * st, C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load_4d(base + C::k_off + st * C::KV_BYTES + pn * BKV * 128, &tm_k,
                      full_k + 8 * st, 64 * pn, kv0, g, b);
        if (t >= STAGES) mbar_wait(empty_v + 8 * st, phase);
        mbar_expect_tx(full_v + 8 * st, C::KV_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::PANELS; ++pn)
          tma_load_4d(base + C::v_off + st * C::KV_BYTES + pn * BKV * 128, &tm_v,
                      full_v + 8 * st, 64 * pn, kv0, g, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));

  // a consumer warpgroup: 64 q rows
  const int wg = warp >> 2;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);  // this thread's rows: +0, +8
  const int cq = 2 * (lane & 3);   // this thread's first column in each group of 8

  float o[DP / 2];   // the padded columns stay zero and are not stored
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};

  if (n_tiles > 0) {
    const float sl2 = p.scale * LOG2E;
    const int wg_first_row = q0 + wg * 64;
    const uint32_t qa = base + wg * 64 * 128;   // this warpgroup's rows of the q tile
    auto cur = sc.cursor();
    float corr[2] = {1.0f, 1.0f};
    float s[BKV / 2];
    uint32_t pa[BKV / 16][4];   // P of the previous tile, wgmma's A operand

    if (wg == 1) turn_pass(1);   // the first turn is warpgroup 0's
    mbar_wait(q_bar, 0);

    // S_t = Q K_t^T into s, over the D real columns
    const auto issue_s = [&](int t) {
      const uint32_t kd = base + C::k_off + (t % STAGES) * C::KV_BYTES;
      // q's descriptors are the same for every tile; kept out of the loop
      // they would hold two registers each (32 at head_dim 256) and spill
      uint32_t qt = qa;
      asm volatile("" : "+r"(qt));
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKV, T>(s, sw128_desc(qt + (kk >> 2) * BQ * 128 + 32 * (kk & 3)),
                         sw128_desc(kd + (kk >> 2) * BKV * 128 + 32 * (kk & 3)), kk > 0);
      wgmma_commit();
    };
    // O = O corr + P_t V_t, P_t in pa
    const auto issue_pv = [&](int t) {
      const int stage = t % STAGES;
      rescale<DP>(o, corr);
      mbar_wait(full_v + 8 * stage, (uint32_t)(t / STAGES) & 1u);
      const uint32_t vd = base + C::v_off + stage * C::KV_BYTES;
      fence_regs(o);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs<DP, T>(o, pa[kk], sw128_mn_desc(vd + kk * 2048, BKV * 128), 1);
      wgmma_commit();
    };
    // S_t (waited for) -> P_t, with m, l and corr advanced; called for t = 0, 1, ... in turn
    const auto softmax = [&]() {
      const int kv0 = cur.next();
      const bool dead = !cur.owns(wg);
      // does any (row, column) of this warpgroup's tile need a mask?
      const bool mask = dead || kv0 + BKV > p.s_kv ||
                        (p.causal && kv0 + BKV - 1 > wg_first_row + q_offset);
      if (mask)
        softmax_tile<BKV, true>(s, m, l, corr, sl2, row0, kv0 + cq, q_offset, p.s_kv, p.causal,
                                dead);
      else
        softmax_tile<BKV, false>(s, m, l, corr, sl2, row0, kv0 + cq, q_offset, p.s_kv, p.causal,
                                 false);
    };
    const auto release = [&](uint32_t bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // tile 0: S_0 and its softmax
    mbar_wait(full_k, 0);
    turn_wait(wg);
    issue_s(0);
    if (!(wg == 1 && n_tiles == 1)) turn_pass(wg);
    wgmma_wait<0>();
    fence_regs(s);
    release(empty_k);
    softmax();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) pack_a<T>(pa[kk], s, kk);

    for (int t = 1; t < n_tiles; ++t) {
      const int st = t % STAGES;
      mbar_wait(full_k + 8 * st, (uint32_t)(t / STAGES) & 1u);
      turn_wait(wg);
      issue_s(t);
      issue_pv(t - 1);
      if (!(wg == 1 && t == n_tiles - 1)) turn_pass(wg);
      wgmma_wait<1>();   // S_t is done; P_{t-1} V_{t-1} may still run
      fence_regs(s);
      release(empty_k + 8 * st);
      softmax();
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      release(empty_v + 8 * ((t - 1) % STAGES));
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) pack_a<T>(pa[kk], s, kk);
    }
    issue_pv(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pa);
  }

  T* og = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float lt = l[hh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt = fmaxf(lt, 1e-30f);
    const float inv = 1.0f / lt;
    const int row = row0 + 8 * hh;
    if (row < p.s_q) {
      T* orow = og + row * p.o_ss + cq;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack2<T>(o[4 * j + 2 * hh] * inv, o[4 * j + 2 * hh + 1] * inv);
      if (p.lse != nullptr && (lane & 3) == 0)
        p.lse[((long long)b * p.heads + h) * p.s_q + row] =
            (m[hh] == -INFINITY ? NEG_BIG : m[hh] * LN2) + logf(lt);
    }
  }
}

// The kernel on the caller's stream; st holds the (batch, seq, head) element
// strides of q, k and v. The grid: (batch * heads, ceil(s_q / 128)); the
// schedule maps its grid row to a q tile. KV as Cfg's.
template <typename T, int D, template <int, int> class Sched, int KV = 0>
cudaError_t launch(const void* q, const void* k, const void* v, const Args& a, int batch,
                   const long long* st,
                   const typename Sched<Cfg<D, KV>::BQ, Cfg<D, KV>::BKV>::Params& sp,
                   cudaStream_t stream) {
  using C = Cfg<D, KV>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // a runtime call first: it makes the device's context current on this
  // thread (the backward runs on autograd's own thread), which encoding a
  // tensor map through the driver needs
  auto kernel = fwd_kernel<T, D, Sched, KV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tq, tk, tv;
  if (!encode_bshd(&tq, type, q, batch, a.s_q, a.heads, D, st[0], st[1], st[2], C::BQ) ||
      !encode_bshd(&tk, type, k, batch, a.s_kv, a.kv_heads, D, st[3], st[4], st[5], C::BKV) ||
      !encode_bshd(&tv, type, v, batch, a.s_kv, a.kv_heads, D, st[6], st[7], st[8], C::BKV))
    return cudaErrorInvalidValue;
  const dim3 grid(batch * a.heads, (a.s_q + C::BQ - 1) / C::BQ);
  kernel<<<grid, THREADS, C::bytes, stream>>>(tq, tk, tv, a, sp);
  return cudaGetLastError();
}

}  // namespace flash_fwd_sm90
