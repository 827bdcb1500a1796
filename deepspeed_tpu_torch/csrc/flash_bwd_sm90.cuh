// The flash-attention backward on Hopper (sm_90a) with TMA and wgmma, bf16 /
// fp16 at head_dim 64 and 128, driven by a tile schedule: shared by the dense
// flash backward (csrc/flash_attention_bwd.cu, the dense causal range) and the
// block-sparse backward (csrc/block_sparse_attention.cu, the layout's lists).
//
// Three kernels in one call, with every accumulator in registers:
//   * prep_kernel: per (b*h, row) of a q length padded to 128, delta = rowsum(dO * O)
//     in fp32 and lse2 = lse * log2(e); padded rows get lse2 = +inf and
//     delta = 0, so their P is exactly 0 wherever it is recomputed;
//   * dq_kernel: one block per (b*h, 128-row q tile), two consumer
//     warpgroups of 64 q rows and a producer warpgroup (one thread issues
//     the loads; setmaxnreg hands its registers to the consumers, 24 a
//     thread against their 240). Q and dO are loaded once by TMA; the
//     64-row K and V tiles of the schedule stream through a 3-stage mbarrier
//     ring. Per tile t: S_t = Q K_t^T and dP_t = dO V_t^T by wgmma (A and B
//     from shared memory, K-major) are issued together with the previous
//     tile's dQ += dS_{t-1} K_{t-1} (A = dS from registers, B = the K tile
//     read MN-major); once S_t and dP_t are done, P = exp2(S scale log2 e -
//     lse2) and dS = P (dP - delta) scale are computed in registers while
//     that product runs, and dS is rounded to q's type. A tile's K is read
//     until the next tile's products, hence the third stage;
//   * dkv_kernel: one block per (b*kv_heads, 128-row kv tile), two consumer
//     warpgroups of 64 kv rows and a producer warpgroup. K and V are loaded
//     once; the q tiles of the schedule (64 rows at head_dim 64, 32 at 128,
//     which keeps dK and dV in registers), over every query head of the kv
//     head's group, stream through a 3-stage ring with their lse2 and delta
//     rows (bulk copies). Per q tile n: S^T_n = K Q_n^T and dP^T_n = V dO_n^T
//     (K-major, shared memory) are issued together with the previous tile's
//     dV += P^T dO (P^T rounded to dO's type) and dK += dS^T Q (A from
//     registers, B = dO, Q read MN-major); P^T_n and dS^T_n are computed in
//     registers, with lse2 and delta read per column, while those run.
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
//     a whole number of tiles (its size a multiple of 128). A dQ block walks
//     the 64-row halves of the kv blocks of its q block's forward list
//     fidx[qb, :fcnt[qb]] in the list's (ascending) order, a dK/dV block the
//     q tiles of the q blocks of its kv block's transposed list; with causal
//     masking a tile wholly past the diagonal is skipped, not masked. The
//     grid rows take the layout's rows in the host's heavy-first order
//     (SparseLayout: the longest lists first).
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
  };
  __device__ Cursor cursor() const { return Cursor{h0, q_start, n_q, 0}; }
};

// a layout's lists (ops/cuda/block_sparse_attention.py SparseLayout): idx
// [rows, max_a] ascending, cnt [rows], order a permutation of the rows
struct ListParams {
  const int* idx;
  const int* cnt;
  const int* order;
  int max_a;
  int block;
};

// dQ over the forward lists: the 64-row halves of each listed kv block
template <int BQ, int BKV>
struct ListDq {
  using Params = ListParams;
  static_assert(BQ % 64 == 0 && BKV % 64 == 0, "list tiles");
  struct Cursor {
    const int* list;
    int block, lim, causal;   // lim: the last key the q tile's last row sees
    int i, sub, k0, n_sub;
    // the kv tiles of the block starting at key k that some row of the q tile reaches
    __device__ int reach(int k) const {
      if (!causal) return block / BKV;
      return lim < k ? 0 : min(block / BKV, (lim - k) / BKV + 1);
    }
    __device__ int next() {   // the next kv tile's first row
      while (sub >= n_sub) {
        k0 = list[i++] * block;
        n_sub = reach(k0);
        sub = 0;
      }
      return k0 + BKV * sub++;
    }
  };
  int q0, n;
  Cursor start;
  __device__ ListDq(const Args& a, const Params& p) {
    const int per = p.block / BQ;
    const int qb = p.order[blockIdx.y / per];
    q0 = qb * p.block + (blockIdx.y % per) * BQ;
    start = Cursor{p.idx + (long long)qb * p.max_a, p.block, q0 + BQ - 1 + a.s_kv - a.s_q,
                   a.causal, 0, 0, 0, 0};
    const int cnt = p.cnt[qb];
    n = 0;
    for (int i = 0; i < cnt; ++i) n += start.reach(start.list[i] * p.block);
  }
  __device__ Cursor cursor() const { return start; }
};

// dK/dV over the transposed lists: the BQ-row q tiles of each listed q block
// (one head: the block-sparse kernels take q, k and v with one head count)
template <int BQ, int BKV>
struct ListDkv {
  using Params = ListParams;
  static_assert(BKV % 64 == 0, "list tiles");
  struct Cursor {
    const int* list;
    int block, lim, causal, h;   // lim: the first query row that sees the kv tile
    int i, sub, q_blk;
    // the first q tile of the block starting at row q whose last row reaches the kv tile
    __device__ int first(int q) const {
      if (!causal) return 0;
      const int need = lim - (BQ - 1) - q;   // the tile must start this far into the block
      return need <= 0 ? 0 : min(block / BQ, (need + BQ - 1) / BQ);
    }
    __device__ void next(int& head, int& q0) {   // the next q tile's head and first row
      while (sub >= block / BQ) {
        q_blk = list[i++] * block;
        sub = first(q_blk);
      }
      head = h;
      q0 = q_blk + BQ * sub++;
    }
  };
  int kv0, n;
  Cursor start;
  __device__ ListDkv(const Args& a, const Params& p) {
    const int per = p.block / BKV;
    const int kb = p.order[blockIdx.y / per];
    kv0 = kb * p.block + (blockIdx.y % per) * BKV;
    start = Cursor{p.idx + (long long)kb * p.max_a, p.block, kv0 - (a.s_kv - a.s_q), a.causal,
                   (int)(blockIdx.x % a.kv_heads), 0, p.block / BQ, 0};
    const int cnt = p.cnt[kb];
    n = 0;
    for (int i = 0; i < cnt; ++i) n += p.block / BQ - start.first(start.list[i] * p.block);
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

  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.0f;

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
    // S_t, dP_t (waited for) -> dS_t in s; called for t = 0, 1, ... in turn
    const auto grads = [&]() {
      const int kv0 = cur.next();
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
  const int krow0 = kv0 + wg * 64 + (warp & 3) * 16 + (lane >> 2);  // rows +0, +8
  const int cq = 2 * (lane & 3);

  float dk[D / 2], dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) {
    dk[i] = 0.0f;
    dv[i] = 0.0f;
  }

  if (n_iter > 0) {
    const float sl2 = a.scale * LOG2E;
    const int wg_last_row = kv0 + wg * 64 + 63;
    const uint32_t ka = base + wg * 64 * 128;
    const uint32_t va = base + C::v_off + wg * 64 * 128;
    auto cur = sc.cursor();

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
    // per column from the stage; called for n = 0, 1, ... in turn
    const auto grads = [&](int n) {
      int h, q0;
      cur.next(h, q0);
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
  }

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
