// The flash-attention backward on Hopper (sm_90a) with TMA and wgmma, bf16 /
// fp16 at head_dim 64, 80, 96, 128 and 256, driven by a tile schedule: shared
// by the dense flash backward (csrc/flash_attention_bwd.cu, the dense causal
// range, every width) and the block-sparse backward
// (csrc/block_sparse_attention.cu, the layout's lists, every width too).
//
// Head dims 80 and 96 are padded to two 64-column panels (DP = 128) as in the
// forward (csrc/flash_fwd_sm90.cuh): TMA fills the columns past head_dim
// with zeros, the K-major products (S, dP, S^T, dP^T) issue only D / 16
// k-steps, the products whose B is read MN-major (dS K, P^T dO, dS^T Q) run
// at N = DP, and the prep pass and the dQ, dK and dV stores touch only the D
// real columns.
//
// Head_dim 256 changes two tiles (DqCfg, DkvCfg). The dQ kernel takes 32-row
// K/V tiles: Q and dO (2 x 64 KB) and a 3-stage ring of 64-row tiles (3 x 64
// KB) would not fit 227 KB, 32-row ones (3 x 32 KB) do; dQ is 128 fp32
// registers a thread, dQ += dS K one m64n256k16 per 16 keys. The dK/dV kernel
// cannot give each warpgroup 64 kv rows of both dK and dV (2 x 64 x 256 fp32
// over 128 threads: 256 registers a thread), so at 256 a block takes 64 kv
// rows and each consumer warpgroup owns half the columns of both (64 + 64
// registers). The products over all 256 columns are split between them
// instead of repeated: warpgroup 0 issues S^T = K Q^T and warpgroup 1 dP^T =
// V dO^T, and each hands its fp32 tile to the other through shared memory
// (two buffers by q tile parity, one named barrier per q tile). Both then
// form the same P^T and dS^T in registers and issue dV += P^T dO and dK +=
// dS^T Q at N 128 over their own columns of dO and Q: the unsplit kernel's
// count of products (no operand read twice), for 16 KB of fp32 exchanged a
// q tile.
//
// Three kernels in one call, with every accumulator in registers:
//   * prep_kernel: per (b*h, row) of a q length padded to 128, delta = rowsum(dO * O)
//     in fp32 and lse2 = lse * log2(e); padded rows get lse2 = +inf and
//     delta = 0, so their P is exactly 0 wherever it is recomputed;
//   * dq_kernel: one block per (b*h, 128-row q tile), two consumer
//     warpgroups of 64 q rows and a producer warpgroup (one thread issues
//     the loads; setmaxnreg hands its registers to the consumers, 24 a
//     thread against their 240). Q and dO are loaded once by TMA; the
//     64-row K and V tiles (32 at head_dim 256) of the schedule stream
//     through a 3-stage mbarrier ring. Per tile t: S_t = Q K_t^T and dP_t =
//     dO V_t^T by wgmma (A and B from shared memory, K-major) are issued
//     together with the previous tile's dQ += dS_{t-1} K_{t-1} (A = dS from
//     registers, B = the K tile read MN-major); once S_t and dP_t are done,
//     P = exp2(S scale log2 e - lse2) and dS = P (dP - delta) scale are
//     computed in registers while that product runs, and dS is rounded to
//     q's type. A tile's K is read until the next tile's products, hence
//     the third stage;
//   * dkv_kernel: one block per (b*kv_heads, 128-row kv tile), two consumer
//     warpgroups of 64 kv rows (at head_dim 256: a 64-row kv tile, the
//     warpgroups splitting its columns, above) and a producer warpgroup. K
//     and V are loaded once; the q tiles of the schedule (64 rows at
//     head_dim 64, 32 at 80, 96, 128 and 256, which keeps dK and dV in
//     registers), over every query head of the kv head's group, stream
//     through a 3-stage ring with their lse2 and delta rows (bulk copies).
//     Per q tile n: S^T_n = K Q_n^T and dP^T_n = V dO_n^T (K-major, shared
//     memory) are issued together with the previous tile's dV += P^T dO
//     (P^T rounded to dO's type) and dK += dS^T Q (A from registers, B =
//     dO, Q read MN-major); P^T_n and dS^T_n are computed in registers, with
//     lse2 and delta read per column, while those run.
// Nothing is transposed in memory, there are no atomics (the result does not
// depend on the launch), and each output is rounded once. A block whose
// schedule holds no tile writes zeros.
//
// A schedule says which block a grid position is and which tiles it walks:
//   * DenseDq / DenseDkv (the flash backward): q tiles from the last (the
//     longest causal rows first), kv tiles 0 .. the causal diagonal; kv tiles
//     in order, q tiles from the causal diagonal on, for each query head of
//     the group;
//   * ListDq / ListDkv (the block-sparse backward): a block of the layout is
//     a multiple of 64 tokens, so each warpgroup's 64 rows (q rows in dQ, kv
//     rows in dK/dV; at head_dim 256 the dK/dV block's one 64-row half) lie
//     in one block. A dQ block walks the kv tiles of the kv blocks of the
//     ascending union of its two q halves' forward lists, a dK/dV block the
//     q tiles of the q blocks of the union of its kv halves' transposed
//     lists; a warpgroup whose block does not list the entry takes the tile
//     as wholly masked (P = dS = 0), so both keep the one producer stream.
//     With causal masking a tile wholly past the diagonal is skipped, not
//     masked. The grid rows take the tiles in the host's heavy-first order
//     (SparseLayout.q_tiles / kv_tiles: the longest unions first).
// Within a tile the per-element mask applies where the tile crosses the causal
// diagonal (q_offset = s_kv - s_q, the TPU kernel's) or the end of s_kv.

#pragma once

#include "sm90_utils.cuh"  // mbarriers, TMA, wgmma descriptors, tensor-map encoding

namespace flash_bwd_sm90 {

using namespace sm90;

constexpr int CONSUMERS = 2;                        // warpgroups of 64 rows
constexpr int THREADS = (CONSUMERS + 1) * 128;      // + the producer warpgroup
// registers a thread after the producer warpgroup gives up its share:
// 128 x 24 + 256 x 240 <= 65536
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int PAD = 128;                            // the q length of lse2 / delta rows
constexpr float LOG2E = 1.4426950408889634f;

// the width in whole 64-column panels (80, 96 -> 128)
template <int D>
constexpr int padded_width() {
  static_assert(D % 16 == 0 && (D <= 128 || D == 256), "wgmma backward head_dim");
  return (D + 63) / 64 * 64;
}

template <int D>
struct DqCfg {
  static constexpr int DP = padded_width<D>();
  static constexpr int BQ = 64 * CONSUMERS;
  static constexpr int BKV = DP > 128 ? 32 : 64;   // head_dim 256: 64 + 64 + 3 x 32 KB
  static constexpr int STAGES = 3;   // tile t's K is read until tile t + 1's products
  static constexpr int PANELS = DP / 64;
  static constexpr int Q_BYTES = BQ * DP * 2;       // one of the Q, dO tiles (zero fill counts)
  static constexpr int KV_BYTES = BKV * DP * 2;     // one of the K, V tiles
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int do_off = Q_BYTES;
  static constexpr int kv_off = 2 * Q_BYTES;
  static constexpr int bar_off = kv_off + STAGES * STAGE_BYTES;
  static constexpr int bytes = bar_off + 8 * (1 + 2 * STAGES) + 1024;
  static_assert(bytes <= 232448, "wgmma dQ shared memory");
};

template <int D>
struct DkvCfg {
  static constexpr int DP = padded_width<D>();
  // head_dim 256: both warpgroups take the block's 64 kv rows, each DW of the
  // columns, and trade S^T and dP^T through shared memory
  static constexpr bool SPLIT = DP > 128;
  static constexpr int BKV = SPLIT ? 64 : 64 * CONSUMERS;
  static constexpr int WG_ROWS = SPLIT ? 0 : 64;    // kv rows between the warpgroups' first
  static constexpr int DW = SPLIT ? DP / CONSUMERS : DP;   // dK, dV columns a warpgroup owns
  static constexpr int BQ = DP == 64 ? 64 : 32;
  static constexpr int STAGES = 3;   // q tile n is read until q tile n + 1's products
  static constexpr int PANELS = DP / 64;
  static constexpr int KV_BYTES = BKV * DP * 2;     // one of the K, V tiles
  static constexpr int QT_BYTES = BQ * DP * 2;      // one of the Q, dO tiles
  static constexpr int TX_BYTES = 2 * QT_BYTES + 2 * BQ * 4;   // + lse2 and delta rows
  static constexpr int STAGE_BYTES = (TX_BYTES + 1023) / 1024 * 1024;
  static constexpr int X_BYTES = 64 * BQ * 4;       // one warpgroup's S^T or dP^T tile, fp32
  static constexpr int v_off = KV_BYTES;
  static constexpr int st_off = 2 * KV_BYTES;
  // SPLIT: the exchange, [q tile parity][warpgroup] tiles
  static constexpr int x_off = st_off + STAGES * STAGE_BYTES;
  static constexpr int bar_off = x_off + (SPLIT ? 2 * CONSUMERS * X_BYTES : 0);
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

__device__ __forceinline__ float load_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float load_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// -- schedules ----------------------------------------------------------------------

struct NoParams {};

// the dense dQ range: q tiles from the last, kv tiles up to the causal diagonal
template <int BQ, int BKV>
struct DenseDq {
  using Params = NoParams;
  int q0, n;
  __device__ DenseDq(const Args& a, const Params&) {
    q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
    int kv_end = a.s_kv;
    if (a.causal) kv_end = min(a.s_kv, q0 + min(BQ, a.s_q - q0) + a.s_kv - a.s_q);
    n = (kv_end + BKV - 1) / BKV;
  }
  struct Cursor {
    int t;
    __device__ int next() { return BKV * t++; }   // the next kv tile's first row
    __device__ bool owns(int) const { return true; }
  };
  __device__ Cursor cursor() const { return Cursor{0}; }
};

// the dense dK/dV range: every query head of the group, q tiles from the causal
// diagonal on
template <int BQ, int BKV>
struct DenseDkv {
  using Params = NoParams;
  int kv0, n, h0, q_start, n_q;
  __device__ DenseDkv(const Args& a, const Params&) {
    const int n_rep = a.heads / a.kv_heads;
    kv0 = blockIdx.y * BKV;
    h0 = (blockIdx.x % a.kv_heads) * n_rep;
    // the first q tile whose last row reaches this kv tile
    q_start = a.causal ? max(0, kv0 - (a.s_kv - a.s_q)) / BQ * BQ : 0;
    n_q = q_start < a.s_q ? (a.s_q - q_start + BQ - 1) / BQ : 0;
    n = n_rep * n_q;
  }
  struct Cursor {
    int h0, q_start, n_q, t;
    __device__ void next(int& h, int& q0) {   // the next q tile's head and first row
      h = h0 + t / n_q;
      q0 = q_start + (t % n_q) * BQ;
      ++t;
    }
    __device__ bool owns(int) const { return true; }
  };
  __device__ Cursor cursor() const { return Cursor{h0, q_start, n_q, 0}; }
};

// dQ over the forward lists: the kv tiles of each kv block of the q tile's union
template <int BQ, int BKV>
using ListDq = ListQ<BQ, BKV>;

// dK/dV over the transposed lists: the BQ-row q tiles of each q block of the
// kv tile's union (one head: the block-sparse kernels take q, k and v with
// one head count)
template <int BQ, int BKV>
struct ListDkv {
  using Params = ListParams;
  static_assert(BKV % 64 == 0 && 64 % BQ == 0, "list tiles");
  struct Cursor {
    const int* list;
    int block, lim, causal, h;   // lim: the first query row that sees the kv tile
    int i, sub, q_blk, own;
    // the first q tile of the block starting at row q whose last row reaches the kv tile
    __device__ int first(int q) const {
      if (!causal) return 0;
      const int need = lim - (BQ - 1) - q;   // the tile must start this far into the block
      return need <= 0 ? 0 : min(block / BQ, (need + BQ - 1) / BQ);
    }
    __device__ void next(int& head, int& q0) {   // the next q tile's head and first row
      while (sub >= block / BQ) {
        const int e = list[i++];
        q_blk = (e >> 2) * block;
        own = e & 3;
        sub = first(q_blk);
      }
      head = h;
      q0 = q_blk + BQ * sub++;
    }
    // does kv half `half` own the tile next() returned last?
    __device__ bool owns(int half) const { return (own >> half) & 1; }
  };
  int kv0, n;
  Cursor start;
  __device__ ListDkv(const Args& a, const Params& p) {
    const int tile = p.order[blockIdx.y];
    kv0 = tile * BKV;
    start = Cursor{p.idx + (long long)tile * p.max_a, p.block, kv0 - (a.s_kv - a.s_q), a.causal,
                   (int)(blockIdx.x % a.kv_heads), 0, p.block / BQ, 0, 0};
    const int cnt = p.cnt[tile];
    n = 0;
    for (int i = 0; i < cnt; ++i)
      n += p.block / BQ - start.first((start.list[i] >> 2) * p.block);
  }
  __device__ Cursor cursor() const { return start; }
};

// -- kernels ------------------------------------------------------------------------

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
  for (int c = lane; c < D; c += 32) acc = fmaf(load_float(orow[c]), load_float(grow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    a.delta[row] = acc;
    a.lse2[row] = a.lse[(long long)bh * a.s_q + i] * LOG2E;
  }
}

template <typename T, int D, template <int, int> class Sched>
__global__ void __launch_bounds__(THREADS, 1)
    dq_kernel(__grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_do,
              __grid_constant__ const CUtensorMap tm_k, __grid_constant__ const CUtensorMap tm_v,
              const Args a, const typename Sched<DqCfg<D>::BQ, DqCfg<D>::BKV>::Params sp) {
  using C = DqCfg<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES, DP = C::DP;
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
  const Sched<BQ, BKV> sc(a, sp);
  const int q0 = sc.q0;
  const int q_offset = a.s_kv - a.s_q;
  const int n_tiles = sc.n;

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
    if (warp == CONSUMERS * 4 && lane == 0 && n_tiles > 0) {
      mbar_expect_tx(q_bar, 2 * C::Q_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::PANELS; ++pn) {
        tma_load_4d(base + pn * BQ * 128, &tm_q, q_bar, 64 * pn, q0, h, b);
        tma_load_4d(base + C::do_off + pn * BQ * 128, &tm_do, q_bar, 64 * pn, q0, h, b);
      }
      auto cur = sc.cursor();
      for (int t = 0; t < n_tiles; ++t) {
        const int st = t % STAGES;
        const int kv0 = cur.next();
        if (t >= STAGES) mbar_wait(empty0 + 8 * st, (uint32_t)(t / STAGES + 1) & 1u);
        const uint32_t kd = base + C::kv_off + st * C::STAGE_BYTES;
        mbar_expect_tx(full0 + 8 * st, C::STAGE_BYTES);
#pragma unroll
        for (int pn = 0; pn < C::PANELS; ++pn) {
          tma_load_4d(kd + pn * BKV * 128, &tm_k, full0 + 8 * st, 64 * pn, kv0, g, b);
          tma_load_4d(kd + C::KV_BYTES + pn * BKV * 128, &tm_v, full0 + 8 * st, 64 * pn, kv0,
                      g, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));

  const int wg = warp >> 2;
  const int row0 = q0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);
  const int cq = 2 * (lane & 3);

  float dq[DP / 2];   // the padded columns stay zero and are not stored
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.0f;

  if (n_tiles > 0) {
    const float sl2 = a.scale * LOG2E;
    const int wg_first_row = q0 + wg * 64;
    const long long stat = (long long)bh * a.s_pad + row0;   // rows < s_pad: q0 + 128 <= s_pad
    const float lse2[2] = {a.lse2[stat], a.lse2[stat + 8]};
    const float delta[2] = {a.delta[stat], a.delta[stat + 8]};
    auto cur = sc.cursor();

    float s[BKV / 2], dp[BKV / 2];
    uint32_t pa[BKV / 16][4];   // dS of the previous tile, wgmma's A operand
    const uint32_t qa = base + wg * 64 * 128;
    const uint32_t da = base + C::do_off + wg * 64 * 128;

    // S_t and dP_t
    const auto issue_sdp = [&](int t) {
      const uint32_t kd = base + C::kv_off + (t % STAGES) * C::STAGE_BYTES;
      const uint32_t vd = kd + C::KV_BYTES;
      // Q's and dO's descriptors are the same for every tile; kept out of
      // the loop they would hold two registers each (64 at head_dim 256)
      uint32_t qt = qa, dt = da;
      asm volatile("" : "+r"(qt), "+r"(dt));
      fence_regs(s);
      fence_regs(dp);
      fence_regs(dq);
      fence_regs(pa);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKV, T>(s, sw128_desc(qt + (kk >> 2) * BQ * 128 + 32 * (kk & 3)),
                         sw128_desc(kd + (kk >> 2) * BKV * 128 + 32 * (kk & 3)), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<BKV, T>(dp, sw128_desc(dt + (kk >> 2) * BQ * 128 + 32 * (kk & 3)),
                         sw128_desc(vd + (kk >> 2) * BKV * 128 + 32 * (kk & 3)), kk > 0);
      wgmma_commit();
    };
    // dQ += dS_t K_t, dS_t in pa
    const auto issue_dq = [&](int t) {
      const uint32_t kd = base + C::kv_off + (t % STAGES) * C::STAGE_BYTES;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
        wgmma_rs<DP, T>(dq, pa[kk], sw128_mn_desc(kd + kk * 2048, BKV * 128), 1);
      wgmma_commit();
    };
    // S_t, dP_t (waited for) -> dS_t in s; called for t = 0, 1, ... in turn
    const auto grads = [&]() {
      const int kv0 = cur.next();
      const bool dead = !cur.owns(wg);   // this warpgroup's q block does not list the tile
      const bool mask = dead || kv0 + BKV > a.s_kv ||
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
              if (dead || col >= a.s_kv || (a.causal && col > row0 + 8 * hh + q_offset))
                pr = 0.0f;
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
    grads();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) pack_a<T>(pa[kk], s, kk);
    for (int t = 1; t < n_tiles; ++t) {
      mbar_wait(full0 + 8 * (t % STAGES), (uint32_t)(t / STAGES) & 1u);
      issue_sdp(t);
      issue_dq(t - 1);
      wgmma_wait<1>();   // S_t and dP_t are done; dS_{t-1} K_{t-1} may still run
      fence_regs(s);
      fence_regs(dp);
      grads();
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
  }

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

template <typename T, int D, template <int, int> class Sched>
__global__ void __launch_bounds__(THREADS, 1)
    dkv_kernel(__grid_constant__ const CUtensorMap tm_k, __grid_constant__ const CUtensorMap tm_v,
               __grid_constant__ const CUtensorMap tm_q, __grid_constant__ const CUtensorMap tm_do,
               const Args a, const typename Sched<DkvCfg<D>::BQ, DkvCfg<D>::BKV>::Params sp) {
  using C = DkvCfg<D>;
  constexpr int BQ = C::BQ, BKV = C::BKV, STAGES = C::STAGES, DP = C::DP;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  const uint32_t base = smem_u32(smem);
  const uint32_t kv_bar = base + C::bar_off;
  const uint32_t full0 = kv_bar + 8;
  const uint32_t empty0 = full0 + 8 * STAGES;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x / a.kv_heads;
  const int g = blockIdx.x % a.kv_heads;
  const Sched<BQ, BKV> sc(a, sp);
  const int kv0 = sc.kv0;
  const int q_offset = a.s_kv - a.s_q;
  const int n_iter = sc.n;

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
    if (warp == CONSUMERS * 4 && lane == 0 && n_iter > 0) {
      mbar_expect_tx(kv_bar, 2 * C::KV_BYTES);
#pragma unroll
      for (int pn = 0; pn < C::PANELS; ++pn) {
        tma_load_4d(base + pn * BKV * 128, &tm_k, kv_bar, 64 * pn, kv0, g, b);
        tma_load_4d(base + C::v_off + pn * BKV * 128, &tm_v, kv_bar, 64 * pn, kv0, g, b);
      }
      auto cur = sc.cursor();
      for (int n = 0; n < n_iter; ++n) {
        const int st = n % STAGES;
        int h, q0;
        cur.next(h, q0);
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
  const int krow0 = kv0 + wg * C::WG_ROWS + (warp & 3) * 16 + (lane >> 2);  // rows +0, +8
  const int cq = 2 * (lane & 3);

  float dk[C::DW / 2], dv[C::DW / 2];   // the padded columns stay zero and are not stored
#pragma unroll
  for (int i = 0; i < C::DW / 2; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }

  if (n_iter > 0) {
    const float sl2 = a.scale * LOG2E;
    const int wg_last_row = kv0 + wg * C::WG_ROWS + 63;
    const uint32_t ka = base + wg * C::WG_ROWS * 128;
    const uint32_t va = base + C::v_off + wg * C::WG_ROWS * 128;
    // this warpgroup's first column panel of Q and dO in the MN-major products
    const uint32_t col = C::SPLIT ? wg * (C::DW / 64) * BQ * 128 : 0;
    auto cur = sc.cursor();

    float s[BQ / 2], dp[BQ / 2];
    uint32_t pp[BQ / 16][4], pd[BQ / 16][4];   // P^T and dS^T of the previous q tile
    // S^T_n and dP^T_n (SPLIT: S^T_n in warpgroup 0, dP^T_n in warpgroup 1, into s)
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
      if constexpr (C::SPLIT) {
        // K's or V's descriptors are the same for every q tile; kept out of
        // the loop they would hold 32 registers
        uint32_t xa = wg == 0 ? ka : va;
        asm volatile("" : "+r"(xa));
        const uint32_t xb = wg == 0 ? qd : dod;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BQ, T>(s, sw128_desc(xa + (kk >> 2) * BKV * 128 + 32 * (kk & 3)),
                          sw128_desc(xb + (kk >> 2) * BQ * 128 + 32 * (kk & 3)), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BQ, T>(s, sw128_desc(ka + (kk >> 2) * BKV * 128 + 32 * (kk & 3)),
                          sw128_desc(qd + (kk >> 2) * BQ * 128 + 32 * (kk & 3)), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BQ, T>(dp, sw128_desc(va + (kk >> 2) * BKV * 128 + 32 * (kk & 3)),
                          sw128_desc(dod + (kk >> 2) * BQ * 128 + 32 * (kk & 3)), kk > 0);
      }
      wgmma_commit();
    };
    // dV += P^T_n dO_n and dK += dS^T_n Q_n, from pp and pd, over this
    // warpgroup's DW columns
    const auto issue_dkv = [&](int n) {
      const uint32_t qd = base + C::st_off + (n % STAGES) * C::STAGE_BYTES + col;
      const uint32_t dod = qd + C::QT_BYTES;
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<C::DW, T>(dv, pp[kk], sw128_mn_desc(dod + kk * 2048, BQ * 128), 1);
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
        wgmma_rs<C::DW, T>(dk, pd[kk], sw128_mn_desc(qd + kk * 2048, BQ * 128), 1);
      wgmma_commit();
    };
    // SPLIT: each warpgroup's product (waited for, in s) to the other through
    // shared memory, so that s holds S^T_n and dp dP^T_n in both; a buffer
    // per q tile parity, so one barrier a tile keeps a buffer from being
    // written before the other warpgroup has read it (it read it before
    // arriving at the next tile's barrier)
    const auto exchange = [&](int n) {
      float4* xbuf = reinterpret_cast<float4*>(smem + C::x_off) +
                     (n & 1) * CONSUMERS * (C::X_BYTES / 16);
      const int t = threadIdx.x & 127;
      float4* mine = xbuf + wg * (C::X_BYTES / 16);
      const float4* other = xbuf + (1 - wg) * (C::X_BYTES / 16);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
        mine[128 * j + t] = make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
      asm volatile("bar.sync 1, %0;" ::"n"(CONSUMERS * 128) : "memory");
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float4 o = other[128 * j + t];
        const float x[4] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (wg == 0) {
            dp[4 * j + e] = x[e];
          } else {
            dp[4 * j + e] = s[4 * j + e];
            s[4 * j + e] = x[e];
          }
        }
      }
    };
    // S^T_n, dP^T_n (waited for) -> P^T_n in s, dS^T_n in dp; lse2 and delta
    // per column from the stage; called for n = 0, 1, ... in turn
    const auto grads = [&](int n) {
      if constexpr (C::SPLIT) exchange(n);
      int h, q0;
      cur.next(h, q0);
      const float* stats = reinterpret_cast<const float*>(
          smem + C::st_off + (n % STAGES) * C::STAGE_BYTES + 2 * C::QT_BYTES);
      // this warpgroup's kv block does not list the q tile's block
      const bool dead = !cur.owns(wg * C::WG_ROWS / 64);
      const bool mask = dead || (a.causal && wg_last_row > q0 + q_offset);
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
            if (mask && (dead || krow0 + 8 * hh > q0 + 8 * j + cq + e + q_offset)) pr = 0.0f;
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
  }

  // this warpgroup's columns: all D, or (SPLIT) its DW
  const int c0 = C::SPLIT ? wg * C::DW : 0;
  constexpr int NJ = C::SPLIT ? C::DW / 8 : D / 8;
  T* dkg = static_cast<T*>(a.dk) + b * a.st[T_DK][0] + g * a.st[T_DK][2] + c0;
  T* dvg = static_cast<T*>(a.dv) + b * a.st[T_DV][0] + g * a.st[T_DV][2] + c0;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = krow0 + 8 * hh;
    if (row < a.s_kv) {
      T* rk = dkg + row * a.st[T_DK][1] + cq;
      T* rv = dvg + row * a.st[T_DV][1] + cq;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        *reinterpret_cast<uint32_t*>(rk + 8 * j) =
            pack2<T>(dk[4 * j + 2 * hh], dk[4 * j + 2 * hh + 1]);
        *reinterpret_cast<uint32_t*>(rv + 8 * j) =
            pack2<T>(dv[4 * j + 2 * hh], dv[4 * j + 2 * hh + 1]);
      }
    }
  }
}

// The three kernels on the caller's stream. ptr: q, k, v, o, dout, dq, dk, dv.
// The grid: (batch * heads, ceil(s_q / 128)) dQ blocks and (batch * kv_heads,
// ceil(s_kv / 128)) dK/dV blocks; each schedule maps its grid row to a tile.
template <typename T, int D, template <int, int> class DqSched, template <int, int> class DkvSched>
cudaError_t launch(const void* const* ptr, const Args& a, int batch,
                   const typename DqSched<DqCfg<D>::BQ, DqCfg<D>::BKV>::Params& dq_params,
                   const typename DkvSched<DkvCfg<D>::BQ, DkvCfg<D>::BKV>::Params& dkv_params,
                   cudaStream_t stream) {
  using CQ = DqCfg<D>;
  using CKV = DkvCfg<D>;
  const CUtensorMapDataType type = std::is_same<T, __half>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  // runtime calls first: they make the device's context current on this
  // thread (autograd runs the backward on a thread of its own), which
  // encoding a tensor map through the driver needs
  auto dqk = dq_kernel<T, D, DqSched>;
  auto dkvk = dkv_kernel<T, D, DkvSched>;
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
      dq_q, dq_do, dq_k, dq_v, a, dq_params);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  dkvk<<<dim3(batch * a.kv_heads, (a.s_kv + CKV::BKV - 1) / CKV::BKV), THREADS, CKV::bytes,
         stream>>>(kv_k, kv_v, kv_q, kv_do, a, dkv_params);
  return cudaGetLastError();
}

}  // namespace flash_bwd_sm90
