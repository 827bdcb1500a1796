"""The routes of the flash forward and backward at the head dims beside 64
and 128, the CE forward, the block-sparse forward and backward and the
quantized matmul, on the CPU: which kernel each shape takes (a pure
function of dtype, width, block and m, decided before the launch), the
host-side planning of the Hopper routes (the CE's vocab slices, the
block-sparse lists by grid tile and their heavy-first order, the
block-sparse kernels' walks over them and the flash kernels' over the dense
causal range, the quantized decode kernel's k splits), and the forced route
the shape cannot take, which raises."""

import ast
import inspect

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.registry import MODEL_CONFIGS
from deepspeed_tpu_torch.ops import sparse_attention as SA
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda import quantized_matmul as qmm
from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
    SparseLayout, _visible, block_sparse_attention_bwd, block_sparse_attention_bwd_reference,
    block_sparse_attention_fwd, block_sparse_attention_fwd_reference, block_sparse_route,
    heavy_first)
from deepspeed_tpu_torch.ops.cuda.cross_entropy import (ce_route, ce_vocab_splits,
                                                        fused_ce_forward,
                                                        fused_ce_forward_reference)
from deepspeed_tpu_torch.ops.cuda.flash_attention import (attention_route, flash_attention_bwd,
                                                          flash_attention_bwd_reference,
                                                          flash_attention_fwd,
                                                          flash_attention_reference)

DTYPES = (torch.bfloat16, torch.float16, torch.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _registry_configs():
    """{(family, size): config} of every preset the port's registry builds
    (each family's sizes are the keys of its ``presets`` table, read from the
    registry's source; presets whose features are not ported raise and are
    left out)."""
    cfgs = {}
    for family, make in MODEL_CONFIGS.items():
        tree = ast.parse(inspect.getsource(make))
        sizes = [key.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "presets" for key in node.value.keys]
        assert sizes, family
        for size in sizes:
            try:
                cfgs[(family, size)] = make(size)
            except NotImplementedError:
                continue
    return cfgs


def test_ce_route_is_fixed_by_dtype_and_width():
    """bf16 and fp16 with d a multiple of 64 take the TMA + wgmma kernel;
    fp32, and 16-bit widths that are no multiple of 64, the wmma kernel;
    what no kernel takes (rows not a multiple of 16 bytes, other dtypes) has
    no route."""
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 768, 1024, 1600, 4096):
            assert ce_route(dtype, d) == "wgmma"
        for d in (8, 72, 200):
            assert ce_route(dtype, d) == "wmma"
        assert ce_route(dtype, 36) is None
    for d in (4, 64, 1024, 4096):
        assert ce_route(torch.float32, d) == "wmma"
    assert ce_route(torch.float32, 6) is None
    assert ce_route(torch.float64, 1024) is None


def test_block_sparse_route_is_fixed_by_dtype_width_and_block():
    """bf16 and fp16 with blocks 64, 128, 192, 256 and 384 take the TMA +
    wgmma forward and backward at head_dim 64, 80, 96, 128 and 256; fp32,
    head_dim 32 and the blocks of 16, 32 and 48 the wmma kernels; what no
    kernel takes has no route, and a kernel that is neither "fwd" nor "bwd"
    raises."""
    wgmma = {"fwd": (64, 80, 96, 128, 256), "bwd": (64, 80, 96, 128, 256)}
    for kernel, dims in wgmma.items():
        for dtype in (torch.bfloat16, torch.float16):
            for d in dims:
                for block in (64, 128, 192, 256, 384):
                    assert block_sparse_route(dtype, d, block, kernel) == "wgmma"
                for block in (16, 32, 48, 80, 112):
                    assert block_sparse_route(dtype, d, block, kernel) == "wmma"
            for d in sorted({32, 64, 80, 96, 128, 256} - set(dims)):
                for block in (64, 128):
                    assert block_sparse_route(dtype, d, block, kernel) == "wmma", (kernel, d)
        for d in (32, 64, 80, 96, 128, 256):
            for block in (16, 128, 256):
                assert block_sparse_route(torch.float32, d, block, kernel) == "wmma"
        assert block_sparse_route(torch.bfloat16, 48, 128, kernel) is None
        assert block_sparse_route(torch.bfloat16, 64, 24, kernel) is None
        assert block_sparse_route(torch.float64, 64, 128, kernel) is None
    with pytest.raises(ValueError, match="kernel"):
        block_sparse_route(torch.bfloat16, 64, 128, "dq")


def test_every_preset_has_a_route_for_both_kernels():
    """Every preset of the registry maps to some CE route and some
    block-sparse forward and backward route (at the JAX package's default
    128-token block) in each kernel dtype, and the training paths' GPT-2
    medium in bf16 to wgmma for all three."""
    cfgs = _registry_configs()
    assert ("gpt2", "medium") in cfgs and ("llama", "7b") in cfgs
    for dtype in DTYPES:
        no_ce = {k: c.d_model for k, c in cfgs.items() if ce_route(dtype, c.d_model) is None}
        assert not no_ce, f"{dtype}: no CE route for {no_ce}"
        for kernel in ("fwd", "bwd"):
            no_bs = {k: c.head_dim for k, c in cfgs.items()
                     if block_sparse_route(dtype, c.head_dim, 128, kernel) is None}
            assert not no_bs, f"{dtype}: no block-sparse {kernel} route for {no_bs}"
    medium = cfgs[("gpt2", "medium")]
    assert ce_route(torch.bfloat16, medium.d_model) == "wgmma"
    for kernel in ("fwd", "bwd"):
        assert block_sparse_route(torch.bfloat16, medium.head_dim, 128, kernel) == "wgmma"
    # every preset's width is a multiple of 64: all of them take the wgmma CE
    assert all(ce_route(torch.bfloat16, c.d_model) == "wgmma" for c in cfgs.values())


def test_ce_vocab_splits_fill_the_card():
    """The wgmma CE's vocab slices: about 8 blocks per SM, at most one slice
    per 256-column vocab tile, at least one. The training shape (T 12288,
    V 50304, 132 SMs) takes 11 slices, 96 x 11 = 1056 blocks = 8 waves."""
    assert ce_vocab_splits(12288, 50304, 132) == 11
    assert ce_vocab_splits(12288 + 37, 50257, 132) == 11   # 97 token tiles
    assert ce_vocab_splits(1000, 50257, 132) == 132        # 8 token tiles
    assert ce_vocab_splits(12288 + 37, 129, 132) == 1      # one vocab tile
    assert ce_vocab_splits(64, 1000, 132) == 4             # capped at the 4 vocab tiles
    assert ce_vocab_splits(10 ** 6, 50304, 132) == 1
    for tokens, vocab, sms in ((1, 1, 1), (300, 1031, 114), (4096, 50304, 132)):
        n_v = -(-vocab // 256)
        assert 1 <= ce_vocab_splits(tokens, vocab, sms) <= n_v


def test_heavy_first_order_of_the_training_layout():
    """The wgmma kernels' grids take the layout's tiles longest union first
    (a stable sort). Phase 8's layout (fixed, 128-token blocks, 4 local, 1
    global, causal, s 1024): each 4-block window is lower triangular and
    the windows' last block (3) is global, so q blocks attend 1-5 kv blocks
    (q block 7 the most) and kv block 3 is attended by 5 q blocks; a block
    is a grid tile, its list the tile's. Its twin of 64-token blocks (8
    local, 2 global) keeps the same order: each 128-row tile's union holds
    both halves' lists, twice as many blocks. The dK/dV kernel's 64-row kv
    tiles (head_dim 256) take the halves of the 128-row ones."""
    attn = SA.BlockSparseAttention(SA.PATTERNS["fixed"](block=128, num_local_blocks=4,
                                                        num_global_blocks=1), 1024, causal=True)
    lists = attn.lists
    assert int(attn.layout.sum()) == 24
    np.testing.assert_array_equal(lists.fwd_cnt.numpy(), [1, 2, 3, 4, 2, 3, 4, 5])
    np.testing.assert_array_equal(lists.q_tiles.cnt.numpy(), lists.fwd_cnt.numpy())
    np.testing.assert_array_equal(lists.q_tiles.order.numpy(), [7, 3, 6, 2, 5, 1, 4, 0])
    np.testing.assert_array_equal(lists.bwd_cnt.numpy(), [4, 3, 2, 5, 4, 3, 2, 1])
    np.testing.assert_array_equal(lists.kv_tiles[128].order.numpy(), [3, 0, 4, 1, 5, 2, 6, 7])
    np.testing.assert_array_equal(lists.kv_tiles[64].cnt.numpy(),
                                  np.repeat(lists.bwd_cnt.numpy(), 2))
    np.testing.assert_array_equal(lists.q_tiles.idx.numpy() >> 2 & 0xff,
                                  np.where(np.arange(lists.max_a) < lists.fwd_cnt.numpy()[:, None],
                                           lists.fwd_idx.numpy(), 0))
    assert lists.q_tiles.order.dtype == lists.kv_tiles[128].order.dtype == torch.int32
    twin = SA.BlockSparseAttention(SA.PATTERNS["fixed"](block=64, num_local_blocks=8,
                                                        num_global_blocks=2), 1024,
                                   causal=True).lists
    np.testing.assert_array_equal(twin.q_tiles.cnt.numpy(), 2 * lists.fwd_cnt.numpy())
    np.testing.assert_array_equal(twin.q_tiles.order.numpy(), [7, 3, 6, 2, 5, 1, 4, 0])
    np.testing.assert_array_equal(twin.kv_tiles[128].cnt.numpy(), 2 * lists.bwd_cnt.numpy())
    # the twin keeps the same (query, key) pairs, so the plain versions agree
    # in fp32 but for the order of their sums (phase 8's 64-token layout):
    # within 1e-6 + 1e-6 |plain| (a few ulps where |dq| reaches 3)
    np.testing.assert_array_equal(_seen(twin, True, True, 1024, 1024),
                                  _seen(lists, True, True, 1024, 1024))
    r = np.random.RandomState(3)
    q, k, v, do = (torch.tensor(r.randn(1, 1024, 2, 16), dtype=torch.float32) for _ in range(4))
    outs = [block_sparse_attention_fwd_reference(q, k, v, sl, return_lse=True)
            for sl in (lists, twin)]
    for got, want in zip(outs[1], outs[0]):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    o, lse = outs[0]
    for got, want in zip(block_sparse_attention_bwd_reference(q, k, v, o, lse, do, twin),
                         block_sparse_attention_bwd_reference(q, k, v, o, lse, do, lists)):
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(heavy_first([2, 0, 2, 3]), [3, 0, 2, 1])
    for layout in (np.ones((3, 5), bool), np.eye(4, dtype=bool)):
        for block in (128, 64):
            sl = SparseLayout(layout, block)
            n_q, n_kv = (-(-n * block // 128) for n in layout.shape)
            assert sorted(sl.q_tiles.order.tolist()) == list(range(n_q))
            assert sorted(sl.kv_tiles[128].order.tolist()) == list(range(n_kv))
    assert SparseLayout(np.eye(4, dtype=bool), 32).q_tiles is None   # no wgmma route


def test_forced_route_the_shape_cannot_take_raises():
    """``_route`` forces a route (for timing one against the other); one the
    shape cannot take raises, on CPU tensors too, and a route it can take
    still gives the plain version, launching nothing."""
    r = np.random.RandomState(0)
    x = torch.tensor(r.randn(8, 64), dtype=torch.float32)
    emb = torch.tensor(r.randn(300, 64), dtype=torch.float32)
    labels = torch.tensor(r.randint(0, 300, 8))
    for route in ("wgmma", "tiled"):
        with pytest.raises(ValueError, match="route"):
            fused_ce_forward(x, emb, labels, _route=route)
    with pytest.raises(ValueError, match="route"):
        fused_ce_forward(x[:, :40].to(torch.bfloat16), emb[:, :40], labels, _route="wgmma")
    before = dict(LAUNCH_COUNTS)
    got = fused_ce_forward(x.to(torch.bfloat16), emb, labels, _route="wgmma")
    want = fused_ce_forward_reference(x.to(torch.bfloat16), emb, labels)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)

    layout = np.tril(np.ones((2, 2), bool))
    q, k, v, do = (torch.tensor(r.randn(1, 128, 2, 64), dtype=torch.float32) for _ in range(4))
    lists = SparseLayout(layout, 64)
    o, lse = block_sparse_attention_fwd_reference(q, k, v, lists, return_lse=True)
    for route in ("wgmma", "tiled"):
        with pytest.raises(ValueError, match="route"):
            block_sparse_attention_bwd(q, k, v, o, lse, do, lists, _route=route)
    q16 = q.to(torch.bfloat16)
    lists32 = SparseLayout(np.tril(np.ones((4, 4), bool)), 32)
    with pytest.raises(ValueError, match="route"):   # a 32-token block
        block_sparse_attention_bwd(q16, k.to(q16.dtype), v.to(q16.dtype), o.to(q16.dtype), lse,
                                   do.to(q16.dtype), lists32, _route="wgmma")
    got = block_sparse_attention_bwd(q16, k.to(q16.dtype), v.to(q16.dtype), o.to(q16.dtype),
                                     lse, do.to(q16.dtype), lists, _route="wgmma")
    want = block_sparse_attention_bwd_reference(q16, k.to(q16.dtype), v.to(q16.dtype),
                                                o.to(q16.dtype), lse, do.to(q16.dtype), lists)
    for g, w in zip(got, want):   # a 64-token block takes the wgmma route
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    lists128 = SparseLayout(np.ones((1, 1), bool), 128)
    args = [t.to(torch.bfloat16) for t in (q, k, v)]
    o16, lse16 = block_sparse_attention_fwd_reference(*args, lists128, return_lse=True)
    got = block_sparse_attention_bwd(*args, o16, lse16, do.to(torch.bfloat16), lists128,
                                     _route="wgmma")
    want = block_sparse_attention_bwd_reference(*args, o16, lse16, do.to(torch.bfloat16),
                                                lists128)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert dict(LAUNCH_COUNTS) == before


def _entries(tiles, t):
    """(block, owner bits) of grid tile t's union list (``TileLists``)."""
    return [(e >> 2, e & 3) for e in tiles.idx[t, :int(tiles.cnt[t])].tolist()]


def _list_fwd_walk(lists, s_q, s_kv, causal, kv_tile=128):
    """A mirror of ``ListQ`` (csrc/sm90_utils.cuh), the wgmma forward's
    ``ListFwd`` and the dQ kernel's ``ListDq`` (128-row q tiles, ``kv_tile``
    -row kv tiles: the forward's 128, or 64 at blocks of 64 and at head_dim
    256; dQ's 64, or 32 at 256): for every grid row (the q tiles in
    ``q_tiles.order``), [(first key, owner bits)] of the kv tiles its
    producer loads and its warpgroups take (bit h: q half h uses the tile),
    in order."""
    block, tiles = lists.block, lists.q_tiles
    walks = {}
    for row in range(-(-s_q // 128)):
        t = int(tiles.order[row])
        q0 = 128 * t
        lim = min(q0 + 128, s_q) - 1 + s_kv - s_q   # the last key the tile's last row sees

        def reach(k):
            if not causal:
                return block // kv_tile
            return 0 if lim < k else min(block // kv_tile, (lim - k) // kv_tile + 1)

        entries = _entries(tiles, t)
        n = sum(reach(kb * block) for kb, _ in entries)
        walk, i, sub, k0, n_sub, own = [], 0, 0, 0, 0, 0
        for _ in range(n):   # Cursor::next
            while sub >= n_sub:
                kb, own = entries[i]
                i += 1
                k0 = kb * block
                n_sub, sub = reach(k0), 0
            walk.append((k0 + kv_tile * sub, own))
            sub += 1
        walks[q0] = walk
    return walks


def _list_dkv_walk(lists, s_q, s_kv, causal, rows, bq):
    """A mirror of ``ListDkv`` (csrc/flash_bwd_sm90.cuh), the dK/dV kernel's
    schedule: ``rows``-row kv tiles (128, a warpgroup's 64 rows each; 64 at
    head_dim 256, both warpgroups on the one half) over the transposed
    lists, ``bq``-row q tiles (64 at head_dim 64, else 32): for every grid
    row (the kv tiles in ``kv_tiles[rows].order``), [(first query row, owner
    bits)] of the q tiles it walks, in order."""
    block, tiles = lists.block, lists.kv_tiles[rows]
    walks = {}
    for row in range(-(-s_kv // rows)):
        t = int(tiles.order[row])
        kv0 = rows * t
        lim = kv0 - (s_kv - s_q)   # the first query row that sees the kv tile

        def first(q):
            if not causal:
                return 0
            need = lim - (bq - 1) - q
            return 0 if need <= 0 else min(block // bq, -(-need // bq))

        entries = _entries(tiles, t)
        n = sum(block // bq - first(qb * block) for qb, _ in entries)
        walk, i, sub, q_blk, own = [], 0, block // bq, 0, 0
        for _ in range(n):   # Cursor::next
            while sub >= block // bq:
                qb, own = entries[i]
                i += 1
                q_blk = qb * block
                sub = first(q_blk)
            walk.append((q_blk + bq * sub, own))
            sub += 1
        walks[kv0] = walk
    return walks


def _seen(lists, rows_fwd, causal, s_q, s_kv):
    """[s_q, s_kv] bool: the (query, key) elements the plain version's
    ``_visible`` keeps, over the forward or the transposed lists."""
    blk = lists.block
    seen = np.zeros((s_q, s_kv), bool)
    for a in range(lists.max_a if rows_fwd else lists.max_aq):
        other, ok = _visible(lists, a, rows_fwd, causal, s_q, s_kv, "cpu")
        ok = ok.expand(-1, blk, blk).numpy()   # [n, 1, 1] where nothing is masked
        for j in range(ok.shape[0]):
            qb, kb = (j, int(other[j])) if rows_fwd else (int(other[j]), j)
            seen[qb * blk:(qb + 1) * blk, kb * blk:(kb + 1) * blk] |= ok[j]
    return seen


def _check_walk(walks, seen, tile_rows, step):
    """``walks`` ({first row of a grid tile: [(first row of a walked tile,
    owners)]}) against ``seen`` ([grid axis, walked axis]): every grid tile
    once; each walk ascending, each tile once; for every 64-row half h of a
    grid tile, the walked tiles it owns (bit h) in which its rows see some
    element are exactly the ``step``-row tiles in which they do (so a tile a
    half does not own is one it needs nothing of). Returns the walked tiles
    and those some half needs."""
    assert sorted(walks) == list(range(0, seen.shape[0], tile_rows))
    walked = needed = 0
    for r0, walk in walks.items():
        keys = [k for k, _ in walk]
        assert keys == sorted(set(keys)), r0
        halves = range(r0, min(r0 + tile_rows, seen.shape[0]), 64)
        need_any = set()
        for h, h0 in enumerate(halves):
            rows = seen[h0:h0 + 64]
            need = [k for k in range(0, seen.shape[1], step) if rows[:, k:k + step].any()]
            used = [k for k, own in walk if own >> h & 1 and rows[:, k:k + step].any()]
            assert used == need, (r0, h)
            need_any |= set(need)
        assert all(0 < own < 1 << len(halves) for _, own in walk), r0
        walked += len(keys)
        needed += len(need_any)
    return walked, needed


# (pattern, block, causal, s_q, s_kv, pattern config) of each case: a
# layout of 128-token blocks or more and its twins of 64-token blocks
_FIXED_1024 = {"num_local_blocks": 4, "num_global_blocks": 1}
_FIXED_1024_64 = {"num_local_blocks": 8, "num_global_blocks": 2}


@pytest.mark.parametrize("case", [
    (64, [("fixed", 128, True, 1024, 1024, _FIXED_1024),
          ("fixed", 64, True, 1024, 1024, _FIXED_1024_64)]),
    (128, [("bigbird", 256, False, 2048, 2048, {}), ("bigbird", 64, True, 1024, 1024, {}),
           ("bigbird", 64, False, 1024, 1024, {})]),
    (80, [("fixed", 128, True, 768, 1024, {}), ("fixed", 64, True, 832, 1024, {}),
          ("variable", 64, True, 960, 960, {})]),
    (256, [("fixed", 128, True, 2048, 2048, _FIXED_1024),
           ("fixed", 64, True, 2048, 2048, _FIXED_1024_64),
           ("bslongformer", 64, True, 576, 576, {})]),
], ids=["training-layout", "bigbird-256-noncausal", "causal-sq<skv", "d256-training-layout"])
def test_list_fwd_walk_is_the_plain_versions_visible_tiles(case):
    """The wgmma kernels' tile walks over a layout's lists by tile visit
    what the plain version's ``_visible`` keeps, at a head_dim's tiles: the
    forward (128-row q tiles over 128-row kv tiles; 64 at blocks of 64 and
    at head_dim 256) and dQ (64-row kv tiles; 32 at 256) for every q tile,
    the dK/dV kernel (128-row kv tiles over 64-row q tiles at head_dim 64,
    32 at 80-128; 64-row kv tiles over 32 at 256) for every kv tile: each
    walked tile once, ascending, and each 64-row half of a grid tile uses
    exactly the tiles in which it sees some element (``_check_walk``). At
    blocks of 128 and more the two halves share a list; at 64 a union walks
    tiles one half masks whole, counted below."""
    d, layouts = case
    for pattern, block, causal, s_q, s_kv, kw in layouts:
        lists = SA.BlockSparseAttention(SA.PATTERNS[pattern](block=block, **kw), s_q, s_kv,
                                        causal=causal).lists
        seen = _seen(lists, True, causal, s_q, s_kv)
        np.testing.assert_array_equal(seen, _seen(lists, False, causal, s_q, s_kv))
        fwd_kv = 64 if d > 128 or block % 128 else 128
        dq_kv, dkv_kv, dkv_q = _bwd_tiles(d)
        fwd = _check_walk(_list_fwd_walk(lists, s_q, s_kv, causal, fwd_kv), seen, 128, fwd_kv)
        _check_walk(_list_fwd_walk(lists, s_q, s_kv, causal, dq_kv), seen, 128, dq_kv)
        dkv = _check_walk(_list_dkv_walk(lists, s_q, s_kv, causal, dkv_kv, dkv_q), seen.T,
                          dkv_kv, dkv_q)
        tiles = lists.q_tiles
        if block >= 128:   # the halves share a block: nothing walked in vain
            assert tiles.walked == tiles.needed
            assert fwd[0] == fwd[1] and dkv[0] == dkv[1]
        assert tiles.needed == int(lists.layout.sum()) * (block // 64)
        assert lists.kv_tiles[dkv_kv].needed == tiles.needed
        if (pattern, s_q, s_kv) == ("fixed", 1024, 1024):
            # phase 8's layout keeps 24 blocks of 128, its twin 88 of 64:
            # the same (query, key) pairs (test_torch_sparse_attention.py)
            assert int(lists.layout.sum()) == {128: 24, 64: 88}[block]
            # the forward walks 24 tiles of 128 x 128, or 48 of 128 x 64:
            # each q tile's union holds its odd half's diagonal block too
            assert fwd == {128: (24, 24), 64: (48, 48)}[block]
            assert (tiles.walked, tiles.needed) == {128: (48, 48), 64: (96, 88)}[block]
        if (pattern, s_q, s_kv) == ("fixed", 2048, 2048) and block == 128:
            # phase 10's GPT-J layout keeps 64 blocks, each two 64-row kv tiles
            # (a diagonal block's too: the q tile's last row sees both)
            assert int(lists.fwd_cnt.sum()) == 64
            assert fwd == (2 * 64, 2 * 64)


def test_block_sparse_forward_takes_the_backwards_route():
    """The forward's route is ``block_sparse_route``'s, as the backward's: a
    forced wgmma route at a block it cannot take (32) or in fp32 raises on
    CPU tensors too; where it can (blocks of 64 and 128), the CPU tensors
    still take the plain version (with an empty layout row: o = 0, lse =
    -1e30), launching nothing."""
    r = np.random.RandomState(0)
    q, k, v = (torch.tensor(r.randn(1, 256, 2, 64), dtype=torch.float32) for _ in range(3))
    with pytest.raises(ValueError, match="route"):
        block_sparse_attention_fwd(q, k, v, SparseLayout(np.tril(np.ones((2, 2), bool)), 128),
                                   _route="wgmma")
    layout = np.tril(np.ones((8, 8), bool))
    with pytest.raises(ValueError, match="route"):
        block_sparse_attention_fwd(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                                   SparseLayout(layout, 32), _route="wgmma")
    with pytest.raises(ValueError, match="route"):
        block_sparse_attention_fwd(q, k, v, SparseLayout(layout[:4, :4], 64), _route="tiled")
    before = dict(LAUNCH_COUNTS)
    args = [t.to(torch.bfloat16) for t in (q, k, v)]
    for block in (128, 64):
        layout = np.tril(np.ones((256 // block,) * 2, bool))
        layout[-1] = False   # the last q block sees no key
        lists = SparseLayout(layout, block)
        got, lse = block_sparse_attention_fwd(*args, lists, causal=False, return_lse=True,
                                              _route="wgmma")
        want, want_lse = block_sparse_attention_fwd_reference(*args, lists, causal=False,
                                                              return_lse=True)
        torch.testing.assert_close(got, want, rtol=0, atol=0)
        torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
        assert (got[:, -block:] == 0).all() and (lse[:, :, -block:] == -1e30).all()
    assert dict(LAUNCH_COUNTS) == before


# the flash forward's kv tile per head_dim (csrc/flash_fwd_sm90.cuh Cfg): 128
# rows, 64 at head_dim 256; head dims padded to whole 64-column panels
def _fwd_kv_tile(d):
    return 64 if d > 128 else 128


def _padded(d):
    return -(-d // 64) * 64


def test_width_presets_take_the_wgmma_flash_kernels():
    """The registry's OPT-2.7B (head_dim 80), GPT-NeoX-20B (96) and GPT-J-6B
    (256) take the TMA + wgmma flash forward and backward in bf16 and fp16;
    the block-sparse forward and backward take the wgmma route at these
    widths with blocks 64, 128 and 256 and the wmma route with blocks 16
    and 32."""
    cfgs = _registry_configs()
    for key in (("opt", "2.7b"), ("gpt_neox", "20b"), ("gptj", "6b")):
        d = cfgs[key].head_dim
        assert d in (80, 96, 256), key
        for dtype in (torch.bfloat16, torch.float16):
            assert attention_route(dtype, d, "fwd") == "wgmma", key
            assert attention_route(dtype, d, "bwd") == "wgmma", key
            for block in (16, 32, 64, 128, 256):
                want = "wgmma" if block >= 64 else "wmma"
                assert block_sparse_route(dtype, d, block, "fwd") == want, (key, block)
                assert block_sparse_route(dtype, d, block, "bwd") == want, (key, block)
        assert attention_route(torch.float32, d, "fwd") == "wmma"
        assert attention_route(torch.float32, d, "bwd") == "wmma"


def _bwd_tiles(d):
    """The backward's tiles per head_dim (csrc/flash_bwd_sm90.cuh): the dQ
    kernel's kv tile (64 rows, 32 at 256), the dK/dV kernel's kv tile (128
    rows, a warpgroup's 64 each; 64 at 256, the warpgroups splitting its
    columns) and q tile (64 rows at head_dim 64, else 32)."""
    wide = d > 128
    return (32 if wide else 64), (64 if wide else 128), (64 if d == 64 else 32)


def test_wgmma_flash_tiles_fit_shared_memory():
    """The forward's q tile, K ring and V ring (2 stages each) of padded
    width fit the 227 KB a block may have at every wgmma head_dim (head_dim
    256 only with 64-row kv tiles), as do the backward's dQ tiles (Q, dO and
    a 3-stage K/V ring; at 256 only with 32-row kv tiles) and its dK/dV
    tiles (K, V, a 3-stage ring of Q, dO, lse2 and delta; at 256 also the
    warpgroups' two exchange buffers of S^T / dP^T a q tile parity) at every
    wgmma backward head_dim, as DqCfg and DkvCfg count them."""
    limit = 232448
    for d in (64, 80, 96, 128, 256):
        dp, bkv = _padded(d), _fwd_kv_tile(d)
        assert dp % 64 == 0 and dp - d < 64
        fwd = 128 * dp * 2 + 4 * bkv * dp * 2 + 8 * 9 + 1024
        assert fwd <= limit, d
        if d == 256:
            assert 128 * dp * 2 + 4 * 128 * dp * 2 > limit   # why its kv tile is 64 rows
    for d in (64, 80, 96, 128, 256):
        dp = _padded(d)
        dq_kv, dkv_kv, dkv_q = _bwd_tiles(d)
        dq = 2 * 128 * dp * 2 + 3 * 2 * dq_kv * dp * 2 + 8 * 7 + 1024
        stage = -(-(2 * dkv_q * dp * 2 + 2 * dkv_q * 4) // 1024) * 1024
        exchange = 2 * 2 * 64 * dkv_q * 4 if d > 128 else 0
        dkv = 2 * dkv_kv * dp * 2 + 3 * stage + exchange + 8 * 7 + 1024
        assert dq <= limit and dkv <= limit, d
        if d == 256:
            assert (dq, dkv) == (230456, 200760)
            # why: 64-row K/V tiles overflow the dQ ring; dK and dV of 64 kv
            # rows in one warpgroup would be 2 x 64 x 256 fp32 over 128
            # threads, past the 240 registers a consumer thread has
            assert 2 * 128 * dp * 2 + 3 * 2 * 64 * dp * 2 > limit
            assert 2 * 64 * dp // 128 > 240


def _dense_fwd_walk(s_q, s_kv, causal, bkv, bq=128):
    """A mirror of ``DenseFwd`` (csrc/flash_fwd_sm90.cuh): for every grid row,
    its q tile's first row and the first keys of the kv tiles it walks."""
    n_rows = -(-s_q // bq)
    walks = {}
    for y in range(n_rows):
        q0 = (n_rows - 1 - y) * bq
        kv_end = s_kv
        if causal:
            kv_end = min(s_kv, q0 + min(bq, s_q - q0) + s_kv - s_q)
        walks[q0] = [bkv * t for t in range(-(-kv_end // bkv))]
    return walks


def _dense_dkv_walk(s_q, s_kv, causal, bq, bkv):
    """A mirror of ``DenseDkv`` (csrc/flash_bwd_sm90.cuh) for one query head
    of the group: for every grid row, its kv tile's first row and the first
    rows of the q tiles it walks."""
    walks = {}
    for y in range(-(-s_kv // bkv)):
        kv0 = y * bkv
        q_start = max(0, kv0 - (s_kv - s_q)) // bq * bq if causal else 0
        n_q = -(-(s_q - q_start) // bq) if q_start < s_q else 0
        walks[kv0] = [q_start + bq * t for t in range(n_q)]
    return walks


@pytest.mark.parametrize("d", [80, 96, 128, 256])
@pytest.mark.parametrize("case", [(True, 2048, 2048), (True, 1000, 1000), (True, 200, 777),
                                  (False, 300, 500)],
                         ids=["causal-s2048", "causal-s1000", "causal-sq200<skv777",
                              "noncausal-sq300-skv500"])
def test_dense_fwd_walk_is_the_plain_versions_visible_tiles(d, case):
    """The wgmma forward's walk over the dense range visits, for every q
    tile, exactly the kv tiles (128 rows; 64 at head_dim 256) in which the
    plain version's mask keeps some (query, key) element, ascending, each
    once; every q tile of the grid once, the last first. The backward's
    walks at the same width too: each dK/dV block (``DenseDkv``: a 128-row
    kv tile; 64 rows at head_dim 256) visits exactly the q tiles (32 rows)
    in which the mask keeps some element of its kv tile, and each dQ block
    (``DenseDq``: the forward's walk with 64-row kv tiles, 32 at 256)
    exactly the kv tiles its rows see."""
    causal, s_q, s_kv = case
    bkv = _fwd_kv_tile(d)
    walks = _dense_fwd_walk(s_q, s_kv, causal, bkv)
    assert list(walks) == list(range(0, s_q, 128))[::-1]
    rows = np.arange(s_q)[:, None]
    cols = np.arange(s_kv)[None, :]
    seen = (cols <= rows + s_kv - s_q) if causal else np.ones((s_q, s_kv), bool)
    for q0, keys in walks.items():
        block = seen[q0:q0 + 128]
        want = [k0 for k0 in range(0, s_kv, bkv) if block[:, k0:k0 + bkv].any()]
        assert keys == want, q0
    dq_kv, dkv_kv, dkv_q = _bwd_tiles(d)
    dkv_walks = _dense_dkv_walk(s_q, s_kv, causal, dkv_q, dkv_kv)
    assert list(dkv_walks) == list(range(0, s_kv, dkv_kv))
    for kv0, q_rows in dkv_walks.items():
        tile = seen[:, kv0:kv0 + dkv_kv]
        assert q_rows == [q for q in range(0, s_q, dkv_q) if tile[q:q + dkv_q].any()], kv0
    for q0, keys in _dense_fwd_walk(s_q, s_kv, causal, dq_kv).items():
        tile = seen[q0:q0 + 128]
        assert keys == [k0 for k0 in range(0, s_kv, dq_kv) if tile[:, k0:k0 + dq_kv].any()], q0


def test_flash_forced_wgmma_backward_at_256_raises():
    """The backward at head_dim 32 has no wgmma kernel: forcing that route
    raises, on CPU tensors too. At 256 it has one (since the d 256 dK/dV
    kernel split its columns between the warpgroups): the forced wgmma and
    wmma routes, and the forward forced onto wgmma, give the plain versions
    on CPU tensors, launching nothing; as at 80 and 96."""
    r = np.random.RandomState(1)
    q, k, v, do = (torch.tensor(r.randn(1, 64, 2, 256), dtype=torch.bfloat16)
                   for _ in range(4))
    before = dict(LAUNCH_COUNTS)
    o, lse = flash_attention_fwd(q, k, v, return_lse=True, _route="wgmma")
    want_o, want_lse = flash_attention_reference(q, k, v, return_lse=True)
    torch.testing.assert_close(o, want_o, rtol=0, atol=0)
    torch.testing.assert_close(lse, want_lse, rtol=0, atol=0)
    args32 = [t[..., :32] for t in (q, k, v)]
    o32, lse32 = flash_attention_reference(*args32, return_lse=True)
    with pytest.raises(ValueError, match="route"):
        flash_attention_bwd(*args32, o32, lse32, do[..., :32], _route="wgmma")
    for route in ("wgmma", "wmma"):
        got = flash_attention_bwd(q, k, v, o, lse, do, _route=route)
        for g, w in zip(got, flash_attention_bwd_reference(q, k, v, o, lse, do)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    for d in (80, 96):   # the backward's wgmma route takes these widths
        args = [t[..., :d] for t in (q, k, v)]
        o_d, lse_d = flash_attention_reference(*args, return_lse=True)
        got = flash_attention_bwd(*args, o_d, lse_d, do[..., :d], _route="wgmma")
        for g, w in zip(got, flash_attention_bwd_reference(*args, o_d, lse_d, do[..., :d])):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert dict(LAUNCH_COUNTS) == before


def test_quantized_matmul_route_is_fixed_by_dtype_shape_and_m():
    """bf16 x with k a multiple of 64, n of 16 and a group of 8/16/32 or a
    multiple of 64 takes the mma decode kernel at m <= 16 and the wgmma
    kernel above; every other shape the split-k GEMV at m <= 16 and the
    wmma kernel above; the same for both bit widths. Every block linear of
    the registry's presets (the tiny test presets aside) takes the mma
    route in bf16 decode."""
    for bits in (8, 4):
        route = lambda m, n, k, g, dtype=torch.bfloat16: qmm.kernel_route(m, n, k, g, dtype, bits)
        for m in (1, 4, 8, 9, 16):
            for k, n in ((4096, 4096), (4096, 11008), (11008, 4096)):
                for g in (8, 16, 32, 64, 128):
                    assert route(m, n, k, g) == "mma"
            assert route(m, 4104, 4096, 64) == "gemv"    # n: 8 past a multiple of 16
            assert route(m, 1024, 4128, 32) == "gemv"    # k: 32 past a multiple of 64
            assert route(m, 1024, 4032, 96) == "gemv"    # a group neither side of 64 divides
            for dtype in (torch.float16, torch.float32):
                assert route(m, 11008, 4096, 64, dtype) == "gemv"
        assert route(17, 11008, 4096, 64) == "wgmma"
        assert route(17, 11008, 4096, 64, torch.float16) == "wmma"
    for (family, size), c in _registry_configs().items():
        if size == "tiny":
            continue
        q_width, kv_width = c.n_heads * c.head_dim, c.kv_heads * c.head_dim
        for k, n in ((c.d_model, q_width), (c.d_model, kv_width), (q_width, c.d_model),
                     (c.d_model, c.d_ff), (c.d_ff, c.d_model)):
            assert qmm.kernel_route(8, n, k, 64, torch.bfloat16, 8) == "mma", (family, size, k, n)


def test_mma_splits_make_two_blocks_an_sm():
    """The mma decode kernel's k splits on 132 SMs: as many (128-column strip,
    split) blocks as make two an SM, at least one, at most one per 64 rows
    of k. Llama-7B's linears: 86 strips x 3 splits (n 11008), 32 x 8 (n
    4096)."""
    assert qmm.mma_splits(11008, 4096, 132) == 3
    assert qmm.mma_splits(4096, 4096, 132) == qmm.mma_splits(4096, 11008, 132) == 8
    assert qmm.mma_splits(4096, 128, 132) == 2                 # capped by k
    assert qmm.mma_splits(10 ** 6, 4096, 132) == 1
    for n, k in ((64, 64), (11008, 11008), (4112, 4160)):
        s = qmm.mma_splits(n, k, 132)
        assert 1 <= s <= k // 64 and s * -(-n // 128) <= max(264, -(-n // 128))


def test_quantized_matmul_forced_routes():
    """A forced route may take the older kernel of the same m (the GEMV
    where mma is picked, the wmma kernel where wgmma is); one the shape
    cannot take raises, on CPU tensors too (mma on fp16 x; mma at m 17;
    wgmma at m 8); CPU tensors compute the plain version, launching nothing."""
    from deepspeed_tpu_torch.ops.quantizer import quantize_per_channel

    r = np.random.RandomState(0)
    w = torch.tensor(r.randn(128, 64) * 0.02, dtype=torch.float32)
    q, scale = quantize_per_channel(w, bits=8, group_size=64)
    before = dict(LAUNCH_COUNTS)
    for m, ok, bad in ((8, ("mma", "gemv"), ("wgmma", "wmma", "tiled")),
                       (17, ("wgmma", "wmma"), ("mma", "gemv"))):
        x = torch.tensor(r.randn(m, 128), dtype=torch.float32).to(torch.bfloat16)
        s = scale.to(torch.bfloat16)
        want = qmm.quantized_matmul_reference(x, q, s, bits=8)
        for route in ok:
            torch.testing.assert_close(qmm.quantized_matmul(x, q, s, bits=8, route=route), want,
                                       rtol=0, atol=0)
        for route in bad:
            with pytest.raises(ValueError, match="route"):
                qmm.quantized_matmul(x, q, s, bits=8, route=route)
    x16 = torch.tensor(r.randn(8, 128), dtype=torch.float16)
    with pytest.raises(ValueError, match="route"):
        qmm.quantized_matmul(x16, q, scale.to(torch.float16), bits=8, route="mma")
    assert dict(LAUNCH_COUNTS) == before
