"""The routes of the CE forward and the block-sparse backward, on the CPU:
which kernel each shape takes (a pure function of dtype and width, decided
before the launch), the host-side planning of the TMA + wgmma routes (the
CE's vocab slices, the block-sparse grid's heavy-first order), and the
forced ``_route`` the shape cannot take, which raises."""

import ast
import inspect

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.models.registry import MODEL_CONFIGS
from deepspeed_tpu_torch.ops import sparse_attention as SA
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
    SparseLayout, block_sparse_attention_bwd, block_sparse_attention_bwd_reference,
    block_sparse_attention_fwd_reference, block_sparse_route, heavy_first)
from deepspeed_tpu_torch.ops.cuda.cross_entropy import (ce_route, ce_vocab_splits,
                                                        fused_ce_forward,
                                                        fused_ce_forward_reference)

DTYPES = (torch.bfloat16, torch.float16, torch.float32)


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
    """bf16 and fp16 at head_dim 64 and 128 with blocks 128 and 256 take the
    TMA + wgmma backward; fp32, the other head dims and the smaller or
    unaligned blocks the wmma kernels; what no kernel takes has no route."""
    for dtype in (torch.bfloat16, torch.float16):
        for d in (64, 128):
            for block in (128, 256, 384):
                assert block_sparse_route(dtype, d, block) == "wgmma"
            for block in (16, 32, 48, 64, 192):
                assert block_sparse_route(dtype, d, block) == "wmma"
        for d in (32, 80, 96, 256):
            assert block_sparse_route(dtype, d, 128) == "wmma"
    for d in (32, 64, 80, 96, 128, 256):
        for block in (16, 128, 256):
            assert block_sparse_route(torch.float32, d, block) == "wmma"
    assert block_sparse_route(torch.bfloat16, 48, 128) is None
    assert block_sparse_route(torch.bfloat16, 64, 24) is None
    assert block_sparse_route(torch.float64, 64, 128) is None


def test_every_preset_has_a_route_for_both_kernels():
    """Every preset of the registry maps to some CE route and some
    block-sparse backward route (at the JAX package's default 128-token
    block) in each kernel dtype, and the training paths' GPT-2 medium in
    bf16 to wgmma for both."""
    cfgs = _registry_configs()
    assert ("gpt2", "medium") in cfgs and ("llama", "7b") in cfgs
    for dtype in DTYPES:
        no_ce = {k: c.d_model for k, c in cfgs.items() if ce_route(dtype, c.d_model) is None}
        assert not no_ce, f"{dtype}: no CE route for {no_ce}"
        no_bs = {k: c.head_dim for k, c in cfgs.items()
                 if block_sparse_route(dtype, c.head_dim, 128) is None}
        assert not no_bs, f"{dtype}: no block-sparse route for {no_bs}"
    medium = cfgs[("gpt2", "medium")]
    assert ce_route(torch.bfloat16, medium.d_model) == "wgmma"
    assert block_sparse_route(torch.bfloat16, medium.head_dim, 128) == "wgmma"
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
    """The wgmma backward's grid takes the layout's rows longest list first
    (a stable sort). Phase 8's layout (fixed, 128-token blocks, 4 local, 1
    global, causal, s 1024): each 4-block window is lower triangular and
    the windows' last block (3) is global, so q blocks attend 1-5 kv blocks
    (q block 7 the most) and kv block 3 is attended by 5 q blocks."""
    attn = SA.BlockSparseAttention(SA.PATTERNS["fixed"](block=128, num_local_blocks=4,
                                                        num_global_blocks=1), 1024, causal=True)
    lists = attn.lists
    assert int(attn.layout.sum()) == 24
    np.testing.assert_array_equal(lists.fwd_cnt.numpy(), [1, 2, 3, 4, 2, 3, 4, 5])
    np.testing.assert_array_equal(lists.q_order.numpy(), [7, 3, 6, 2, 5, 1, 4, 0])
    np.testing.assert_array_equal(lists.bwd_cnt.numpy(), [4, 3, 2, 5, 4, 3, 2, 1])
    np.testing.assert_array_equal(lists.kv_order.numpy(), [3, 0, 4, 1, 5, 2, 6, 7])
    assert lists.q_order.dtype == lists.kv_order.dtype == torch.int32
    np.testing.assert_array_equal(heavy_first([2, 0, 2, 3]), [3, 0, 2, 1])
    for layout in (np.ones((3, 5), bool), np.eye(4, dtype=bool)):
        sl = SparseLayout(layout, 128)
        assert sorted(sl.q_order.tolist()) == list(range(layout.shape[0]))
        assert sorted(sl.kv_order.tolist()) == list(range(layout.shape[1]))


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
    with pytest.raises(ValueError, match="route"):   # a 64-token block
        block_sparse_attention_bwd(q16, k.to(q16.dtype), v.to(q16.dtype), o.to(q16.dtype), lse,
                                   do.to(q16.dtype), lists, _route="wgmma")
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
