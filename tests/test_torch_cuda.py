"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA GPU and nvcc; elsewhere each one skips. On
a machine with a card (which need not have JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda.flash_attention import (
    flash_attention_fwd, flash_attention_reference, rounding_bound)

pytestmark = pytest.mark.cuda


def _assert_matches_plain(out, q, k, v, causal):
    """bf16/fp16: within 1e-5 + ``rounding_bound`` (the kernel rounds P and
    its output to the input type; the plain version keeps P in fp32 and
    rounds its output). fp32: summation order only, rtol/atol 2e-5."""
    ref = flash_attention_reference(q, k, v, causal=causal)
    assert out.dtype == q.dtype and out.shape == q.shape
    diff = (out.float() - ref.float()).abs()
    if q.dtype == torch.float32:
        limit = 2e-5 + 2e-5 * ref.abs()
    else:
        limit = 1e-5 + rounding_bound(q, k, v, ref, causal=causal)
    worst = (diff / limit).max().item()
    assert worst <= 1.0, f"max abs err {diff.max().item()}, {worst:.2f} of the limit"


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _qkv(b, s_q, s_kv, h, kvh, d, dtype, device, seed=0):
    r = np.random.RandomState(seed)
    mk = lambda s, n: torch.tensor(r.randn(b, s, n, d), dtype=torch.float32).to(device, dtype)
    return mk(s_q, h), mk(s_kv, kvh), mk(s_kv, kvh)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("shape", [
    (1, 64, 64, 2, 2, 64, True),       # one tile
    (2, 200, 200, 4, 4, 128, True),    # ragged tail, several tiles
    (1, 77, 300, 4, 2, 64, True),      # s_q < s_kv, GQA
    (1, 130, 90, 2, 1, 128, False),    # non-causal, s_q > s_kv, MQA
    # the registry's other widths: s_q < s_kv, GQA, ragged (d 256 at fp32:
    # 32-row kv tiles); and one non-causal MQA case at a width no 32 divides
    (1, 77, 200, 4, 2, 32, True),
    (1, 77, 200, 4, 2, 80, True),
    (1, 77, 200, 4, 2, 96, True),
    (1, 77, 200, 4, 2, 256, True),
    (1, 130, 90, 2, 1, 80, False),
], ids=["one-tile", "ragged", "sq<skv-gqa", "noncausal-mqa", "d32", "d80", "d96", "d256",
        "d80-noncausal-mqa"])
def test_kernel_matches_plain(cuda, dtype, shape):
    b, s_q, s_kv, h, kvh, d, causal = shape
    q, k, v = _qkv(b, s_q, s_kv, h, kvh, d, dtype, cuda)
    before = LAUNCH_COUNTS["flash_attention_fwd"]
    out = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention_fwd"] == before + 1
    _assert_matches_plain(out, q, k, v, causal)


def test_kernel_reads_strided_views(cuda):
    """q/k/v as views of one fused [b, s, 3, h, d] projection: no copies."""
    r = np.random.RandomState(3)
    qkv = torch.tensor(r.randn(2, 96, 3, 4, 128), dtype=torch.float32).to(cuda, torch.bfloat16)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    out = flash_attention_fwd(q, k, v, causal=True)
    _assert_matches_plain(out, q.contiguous(), k.contiguous(), v.contiguous(), causal=True)


def test_kernel_refuses_what_it_does_not_take(cuda):
    q, k, v = _qkv(1, 64, 64, 2, 2, 48, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd(q, k, v)
    q, k, v = _qkv(1, 128, 64, 2, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="s_q <= s_kv"):
        flash_attention_fwd(q, k, v, causal=True)
    q, k, v = _qkv(1, 64, 64, 2, 2, 64, torch.float64, cuda)
    with pytest.raises(TypeError):
        flash_attention_fwd(q, k, v)


# -- paged flash-decode --------------------------------------------------------

def _paged_inputs(s_dim, n_heads, kvh, dh, bs, nb_cols, dtype, device, seed=0):
    """A paged pool with a poisoned garbage block 0, each slot's blocks
    drawn without replacement, ragged cursors (one at 0) and unbound
    columns on the garbage block."""
    from deepspeed_tpu_torch.serving.kv_pool import GARBAGE_BLOCK

    r = np.random.RandomState(seed)
    n_blocks = s_dim * nb_cols + 1
    t = lambda *shape: torch.tensor(r.randn(*shape), dtype=torch.float32)
    kc, vc = t(n_blocks, bs, kvh, dh), t(n_blocks, bs, kvh, dh)
    kc[GARBAGE_BLOCK] = 1e4
    vc[GARBAGE_BLOCK] = 1e4
    pos = r.randint(1, nb_cols * bs, s_dim)
    pos[0] = 0
    table = np.full((s_dim, nb_cols), GARBAGE_BLOCK, np.int32)
    ids = r.permutation(np.arange(1, n_blocks))
    for s in range(s_dim):
        used = -(-int(pos[s]) // bs)
        table[s, :used] = ids[s * nb_cols:s * nb_cols + used]
    to = lambda x: x.to(device, dtype)
    return (to(t(s_dim, n_heads, dh)), to(t(s_dim, kvh, dh)), to(t(s_dim, kvh, dh)), to(kc),
            to(vc), torch.tensor(table, device=device), torch.tensor(pos, dtype=torch.int32,
                                                                      device=device))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("shape", [
    (8, 32, 32, 128, 16, 128, False, None),   # Llama-7B decode, the kernel's own splits
    (4, 32, 8, 128, 16, 32, True, 4),         # GQA 32/8, alibi, 4 splits
    (3, 6, 2, 64, 8, 8, True, 1),             # hq 3, one split, small blocks
    (2, 32, 1, 128, 16, 8, False, 2),         # hq 32: over 48 KB of shared memory
], ids=["llama7b", "gqa-alibi", "hq3-one-split", "hq32-opt-in"])
def test_paged_kernel_matches_plain(cuda, dtype, shape):
    from deepspeed_tpu_torch.ops.cuda.paged_attention import (
        paged_flash_decode, paged_flash_decode_reference, rounding_bound)

    s_dim, n_heads, kvh, dh, bs, nb_cols, alibi, splits = shape
    args = _paged_inputs(s_dim, n_heads, kvh, dh, bs, nb_cols, dtype, cuda)
    slopes = (0.5 ** torch.arange(1, n_heads + 1, dtype=torch.float32, device=cuda)
              if alibi else None)
    before = LAUNCH_COUNTS["paged_flash_decode"]
    out = paged_flash_decode(*args, alibi_slopes=slopes, kv_splits=splits)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["paged_flash_decode"] == before + 1
    ref = paged_flash_decode_reference(*args, alibi_slopes=slopes, kv_splits=splits or 4)
    assert out.dtype == dtype and out.shape == ref.shape
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        limit = 2e-5 + 2e-5 * ref.float().abs()
    else:
        limit = 1e-5 + rounding_bound(*args, ref, alibi_slopes=slopes)
    worst = (diff / limit).max().item()
    assert worst <= 1.0, f"max abs err {diff.max().item()}, {worst:.2f} of the limit"


def test_fused_decode_supported_asks_the_device(cuda):
    """A GQA group whose blocks need more than 48 KB of shared memory is
    admitted up to the device's opt-in limit and refused past it."""
    import types

    from deepspeed_tpu_torch.ops.cuda.paged_attention import fused_decode_supported

    geo = lambda kvh: types.SimpleNamespace(local_attention_window=0, n_heads=256,
                                            kv_heads=kvh, head_dim=128,
                                            compute_dtype=torch.float32)
    assert fused_decode_supported(geo(8), 16, device=cuda)[0]      # hq 32: 70 KB
    ok, reason = fused_decode_supported(geo(1), 16, device=cuda)   # hq 256: 323 KB
    assert not ok and "shared memory" in reason


def test_paged_kernel_refuses_what_it_does_not_take(cuda):
    from deepspeed_tpu_torch.ops.cuda.paged_attention import paged_flash_decode

    args = list(_paged_inputs(2, 4, 4, 32, 8, 4, torch.bfloat16, cuda))
    with pytest.raises(ValueError, match="head_dim"):
        paged_flash_decode(*args)
    args = list(_paged_inputs(2, 4, 4, 64, 8, 4, torch.bfloat16, cuda))
    with pytest.raises(TypeError, match="int32"):
        paged_flash_decode(*args[:5], args[5].long(), args[6])
    with pytest.raises(TypeError):
        paged_flash_decode(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="aligned"):
        kc = torch.empty(args[3].numel() + 1, dtype=args[3].dtype, device=cuda)[1:]
        paged_flash_decode(*args[:3], kc.view(args[3].shape), *args[4:])


# -- flash backward and the forward's lse ------------------------------------------

def _bwd_inputs(b, s_q, s_kv, h, kvh, d, causal, dtype, device, seed=0):
    """q, k, v, the plain forward's o (rounded to dtype) and fp32 lse, and dO."""
    q, k, v = _qkv(b, s_q, s_kv, h, kvh, d, dtype, device, seed=seed)
    o, lse = flash_attention_reference(q, k, v, causal=causal, return_lse=True)
    do = torch.tensor(np.random.RandomState(seed + 1).randn(b, s_q, h, d),
                      dtype=torch.float32).to(device, dtype)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
def test_forward_lse_matches_plain(cuda, dtype):
    """The kernel's lse against the plain version's: fp32 rows that differ
    only in summation order, within 1e-5 + 1e-5 |lse|."""
    q, k, v = _qkv(2, 200, 200, 4, 2, 64, dtype, cuda)
    out, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    ref, ref_lse = flash_attention_reference(q, k, v, causal=True, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 4, 200)
    assert ((lse - ref_lse).abs() <= 1e-5 + 1e-5 * ref_lse.abs()).all()
    _assert_matches_plain(out, q, k, v, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "fp32"])
@pytest.mark.parametrize("d", [32, 80, 96, 256])
def test_forward_lse_matches_plain_at_every_head_dim(cuda, dtype, d):
    """The lse at the registry's other widths, as above."""
    q, k, v = _qkv(1, 150, 200, 4, 2, d, dtype, cuda)
    out, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    _, ref_lse = flash_attention_reference(q, k, v, causal=True, return_lse=True)
    assert ((lse - ref_lse).abs() <= 1e-5 + 1e-5 * ref_lse.abs()).all()
    _assert_matches_plain(out, q, k, v, True)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("shape", [
    (1, 64, 64, 2, 2, 64, True),       # one tile
    (2, 200, 200, 4, 4, 128, True),    # ragged tail, several tiles
    (1, 77, 300, 4, 2, 64, True),      # s_q < s_kv, GQA
    (1, 130, 90, 4, 1, 128, False),    # non-causal, s_q > s_kv, MQA
    # the registry's other widths (d 256: 32-row kv tiles, and 32-row q
    # tiles at fp32), s_q < s_kv, GQA, ragged
    (1, 150, 200, 4, 2, 32, True),
    (1, 150, 200, 4, 2, 80, True),
    (1, 150, 200, 4, 2, 96, True),
    (1, 150, 200, 4, 2, 256, True),
    (1, 130, 90, 4, 1, 96, False),
], ids=["one-tile", "ragged", "sq<skv-gqa", "noncausal-mqa", "d32", "d80", "d96", "d256",
        "d96-noncausal-mqa"])
def test_bwd_kernel_matches_plain(cuda, dtype, shape):
    """bf16/fp16: within 1e-5 + ``bwd_rounding_bound`` (the kernel rounds P
    and dS to the input type, both sides round the outputs). fp32:
    summation order only, 2e-5 + 2e-5 |plain|."""
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        bwd_rounding_bound, flash_attention_bwd, flash_attention_bwd_reference)

    b, s_q, s_kv, h, kvh, d, causal = shape
    args = _bwd_inputs(b, s_q, s_kv, h, kvh, d, causal, dtype, cuda)
    before = LAUNCH_COUNTS["flash_attention_bwd"]
    grads = flash_attention_bwd(*args, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention_bwd"] == before + 1
    refs = flash_attention_bwd_reference(*args, causal=causal)
    bounds = bwd_rounding_bound(*args, refs, causal=causal)
    for name, g, r, i in zip(("dq", "dk", "dv"), grads, refs, range(3)):
        assert g.dtype == dtype and g.shape == r.shape, name
        diff = (g.float() - r.float()).abs()
        limit = (2e-5 + 2e-5 * r.float().abs()) if bounds is None else 1e-5 + bounds[i]
        worst = (diff / limit).max().item()
        assert worst <= 1.0, f"{name}: max abs err {diff.max().item()}, {worst:.2f} of the limit"


def test_bwd_kernel_refuses_what_it_does_not_take(cuda):
    from deepspeed_tpu_torch.ops.cuda.flash_attention import flash_attention_bwd

    q, k, v, o, lse, do = _bwd_inputs(1, 64, 64, 2, 2, 64, True, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, None, do)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, lse.to(torch.bfloat16), do)
    with pytest.raises(ValueError, match="does not match"):
        flash_attention_bwd(q, k, v, o, lse, do.float())
    q, k, v, o, lse, do = _bwd_inputs(1, 64, 64, 2, 2, 48, True, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(q, k, v, o, lse, do)


def test_flash_autograd_reaches_both_kernels(cuda):
    """Under autograd the dispatch saves the forward's lse and its backward
    is the bwd kernel: one launch of each, grads equal to the wrapper's."""
    from deepspeed_tpu_torch.ops.cuda.flash_attention import flash_attention_bwd
    from deepspeed_tpu_torch.ops.flash_attention import flash_attention

    q, k, v = (t.requires_grad_() for t in _qkv(2, 128, 128, 4, 2, 64, torch.bfloat16, cuda))
    do = torch.randn(2, 128, 4, 64, device=cuda).to(torch.bfloat16)
    before = dict(LAUNCH_COUNTS)
    out = flash_attention(q, k, v, causal=True)
    out.backward(do)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert LAUNCH_COUNTS["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
    o, lse = flash_attention_fwd(q.detach(), k.detach(), v.detach(), causal=True,
                                 return_lse=True)
    for g, w in zip((q.grad, k.grad, v.grad),
                    flash_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse, do)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


# -- the two routes of the flash kernels ---------------------------------------------

_ROUTE_SHAPES = [
    # (b, s_q, s_kv, heads, kv_heads, causal, lse)
    (2, 200, 200, 4, 4, True, True),     # ragged: two q tiles, the last part empty
    (1, 77, 300, 8, 2, True, False),     # s_q < s_kv (bottom-right mask), GQA 4
    (1, 130, 90, 4, 1, False, True),     # non-causal, s_q > s_kv, MQA
    (1, 300, 300, 8, 2, False, False),   # non-causal, GQA 4, ragged
    (1, 256, 512, 4, 4, True, True),     # s_q < s_kv on tile bounds
]
_ROUTE_IDS = ["ragged", "sq<skv-gqa4", "noncausal-mqa", "noncausal-gqa4", "sq256<skv512"]


@pytest.mark.parametrize("route", ["wgmma", "wmma"])
@pytest.mark.parametrize("d", [64, 80, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("shape", _ROUTE_SHAPES, ids=_ROUTE_IDS)
def test_forward_routes_match_plain(cuda, shape, dtype, d, route):
    """The TMA + wgmma forward (the route of 16-bit types at head_dim 64,
    80, 96, 128 and 256) and the wmma kernel forced at the same shapes: o
    within 1e-5 + ``rounding_bound`` of the plain version, lse within 1e-5 +
    1e-5 |lse|; each launch counted on its route."""
    from deepspeed_tpu_torch.ops.cuda.flash_attention import attention_route

    b, s_q, s_kv, h, kvh, causal, with_lse = shape
    assert attention_route(dtype, d, "fwd") == "wgmma"
    q, k, v = _qkv(b, s_q, s_kv, h, kvh, d, dtype, cuda)
    before = dict(LAUNCH_COUNTS)
    forced = None if route == "wgmma" else route
    got = flash_attention_fwd(q, k, v, causal=causal, return_lse=with_lse, _route=forced)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention_fwd"] == before["flash_attention_fwd"] + 1
    assert (LAUNCH_COUNTS["flash_attention_fwd_wgmma"]
            == before["flash_attention_fwd_wgmma"] + (route == "wgmma"))
    out = got[0] if with_lse else got
    _assert_matches_plain(out, q, k, v, causal)
    if with_lse:
        _, ref_lse = flash_attention_reference(q, k, v, causal=causal, return_lse=True)
        assert got[1].shape == (b, h, s_q)
        assert ((got[1] - ref_lse).abs() <= 1e-5 + 1e-5 * ref_lse.abs()).all()


def _check_backward_route(device, shape, dtype, d, route):
    """The flash backward on ``route`` at ``shape`` (``_ROUTE_SHAPES``
    without lse): dq, dk, dv within 1e-5 + ``bwd_rounding_bound`` of the
    plain version, a second launch bitwise the same (no atomics), each
    launch counted on its route."""
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        attention_route, bwd_rounding_bound, flash_attention_bwd, flash_attention_bwd_reference)

    b, s_q, s_kv, h, kvh, causal = shape
    assert attention_route(dtype, d, "bwd") == "wgmma"
    args = _bwd_inputs(b, s_q, s_kv, h, kvh, d, causal, dtype, device)
    forced = None if route == "wgmma" else route
    before = dict(LAUNCH_COUNTS)
    grads = flash_attention_bwd(*args, causal=causal, _route=forced)
    again = flash_attention_bwd(*args, causal=causal, _route=forced)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention_bwd"] == before["flash_attention_bwd"] + 2
    assert (LAUNCH_COUNTS["flash_attention_bwd_wgmma"]
            == before["flash_attention_bwd_wgmma"] + 2 * (route == "wgmma"))
    refs = flash_attention_bwd_reference(*args, causal=causal)
    bounds = bwd_rounding_bound(*args, refs, causal=causal)
    for name, g, g2, r, bound in zip(("dq", "dk", "dv"), grads, again, refs, bounds):
        assert g.dtype == dtype and g.shape == r.shape, name
        assert torch.equal(g, g2), f"{name}: two launches differ"
        diff = (g.float() - r.float()).abs()
        worst = (diff / (1e-5 + bound)).max().item()
        assert worst <= 1.0, (f"{shape} {dtype} d{d} {route} {name}: max abs err "
                              f"{diff.max().item()}, {worst:.2f} of the limit")


@pytest.mark.parametrize("route", ["wgmma", "wmma"])
@pytest.mark.parametrize("d", [64, 80, 96, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("shape", [s[:6] for s in _ROUTE_SHAPES], ids=_ROUTE_IDS)
def test_backward_routes_match_plain(cuda, shape, dtype, d, route):
    """The TMA + wgmma backward (16-bit types at head_dim 64, 80, 96 and
    128) and the wmma kernels forced at the same shapes
    (``_check_backward_route``)."""
    _check_backward_route(cuda, shape, dtype, d, route)


def test_backward_routes_match_plain_at_256(cuda):
    """The same at head_dim 256 (32-row kv tiles in the dQ kernel, the dK/dV
    warpgroups splitting the columns), bf16 and fp16, both routes, every
    shape of ``_ROUTE_SHAPES`` (ragged, s_q < s_kv, GQA, MQA, non-causal)."""
    for shape in _ROUTE_SHAPES:
        for dtype in (torch.bfloat16, torch.float16):
            for route in ("wgmma", "wmma"):
                _check_backward_route(cuda, shape[:6], dtype, 256, route)


def test_forced_route_refuses_what_it_does_not_take(cuda):
    """fp32 and head_dim 32 have no wgmma kernel: forcing that route raises
    before any launch. The backward at head_dim 256 has one: forced, it
    launches on wgmma and forced onto wmma on wmma, both within the bound."""
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        bwd_rounding_bound, flash_attention_bwd, flash_attention_bwd_reference)

    before = dict(LAUNCH_COUNTS)
    for dtype, d in ((torch.float32, 64), (torch.bfloat16, 32)):
        q, k, v, o, lse, do = _bwd_inputs(1, 64, 64, 2, 2, d, True, dtype, cuda)
        with pytest.raises(ValueError, match="route"):
            flash_attention_fwd(q, k, v, _route="wgmma")
        with pytest.raises(ValueError, match="route"):
            flash_attention_bwd(q, k, v, o, lse, do, _route="wgmma")
    assert dict(LAUNCH_COUNTS) == before
    args = _bwd_inputs(1, 64, 64, 2, 2, 256, True, torch.bfloat16, cuda)
    refs = flash_attention_bwd_reference(*args)
    bounds = bwd_rounding_bound(*args, refs)
    for route in ("wgmma", "wmma"):
        before = dict(LAUNCH_COUNTS)
        grads = flash_attention_bwd(*args, _route=route)
        torch.cuda.synchronize()
        assert LAUNCH_COUNTS["flash_attention_bwd"] == before["flash_attention_bwd"] + 1
        assert (LAUNCH_COUNTS["flash_attention_bwd_wgmma"]
                == before["flash_attention_bwd_wgmma"] + (route == "wgmma"))
        for g, r, bound in zip(grads, refs, bounds):
            assert ((g.float() - r.float()).abs() <= 1e-5 + bound).all(), route


def test_padded_columns_never_reach_an_output(cuda):
    """At head_dim 80 and 96 the wgmma kernels read 128 columns a row, the
    columns past d zero-filled by TMA. q, k, v, o and dO here are views of
    the first d columns of wider buffers (128 columns; 384 at head_dim 256,
    whose tiles are whole panels) whose other columns hold NaN: the forward
    (with lse) and the backward must match the plain versions on the same
    views, every output finite, on the wgmma route; bf16 and fp16. The
    block-sparse forward and backward too, at blocks of 64 and 128 (s_q <
    s_kv, causal)."""
    for d in (80, 96, 256):
        for dtype in (torch.bfloat16, torch.float16):
            _check_padded_columns(cuda, dtype, d)
            for block in (64, 128):
                _check_sparse_padded_columns(cuda, dtype, d, block)


def _check_sparse_padded_columns(cuda, dtype, d, block):
    """The block-sparse half of ``test_padded_columns_never_reach_an_output``:
    the fixed pattern at ``block``, s_q 3 blocks < s_kv 5, causal."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        block_sparse_attention_bwd, block_sparse_attention_fwd)

    lists, q, k, v, do = _sparse_case("fixed", block, True, 3 * block, 5 * block, 1, 2, d, dtype,
                                      cuda)
    width = 128 if d < 128 else 384

    def view(t):
        wide = torch.full(t.shape[:3] + (width,), float("nan"), dtype=dtype, device=cuda)
        wide[..., :d] = t
        return wide[..., :d]

    q, k, v, do = (view(t) for t in (q, k, v, do))
    before = dict(LAUNCH_COUNTS)
    out, lse = block_sparse_attention_fwd(q, k, v, lists, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and torch.isfinite(lse).all()
    _assert_sparse_fwd_matches_plain(out, lse, q, k, v, lists, True, f"padded d{d} b{block}")
    o = view(out)
    _check_sparse_grads(block_sparse_attention_bwd(q, k, v, o, lse, do, lists, causal=True),
                        q, k, v, o, lse, do, lists, True, f"padded d{d} b{block}")
    for part in ("fwd", "bwd"):
        name = f"block_sparse_attention_{part}_wgmma"
        assert LAUNCH_COUNTS[name] == before[name] + 1, part


def _check_padded_columns(cuda, dtype, d):
    """``test_padded_columns_never_reach_an_output`` at one dtype and d."""
    from deepspeed_tpu_torch.ops.cuda.flash_attention import (
        bwd_rounding_bound, flash_attention_bwd, flash_attention_bwd_reference)

    b, s_q, s_kv, h, kvh = 1, 200, 333, 4, 2
    width = 128 if d < 128 else 384

    def view(t):
        wide = torch.full(t.shape[:3] + (width,), float("nan"), dtype=dtype, device=cuda)
        wide[..., :d] = t
        return wide[..., :d]

    q, k, v, o, lse, do = _bwd_inputs(b, s_q, s_kv, h, kvh, d, True, dtype, cuda)
    q, k, v, o, do = (view(t) for t in (q, k, v, o, do))
    assert q.stride(2) == width and not q.is_contiguous()
    before = dict(LAUNCH_COUNTS)
    out, out_lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    grads = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["flash_attention_fwd_wgmma"] == before["flash_attention_fwd_wgmma"] + 1
    assert LAUNCH_COUNTS["flash_attention_bwd_wgmma"] == before["flash_attention_bwd_wgmma"] + 1
    assert torch.isfinite(out).all() and torch.isfinite(out_lse).all()
    _assert_matches_plain(out, q, k, v, True)
    _, ref_lse = flash_attention_reference(q, k, v, causal=True, return_lse=True)
    assert ((out_lse - ref_lse).abs() <= 1e-5 + 1e-5 * ref_lse.abs()).all()
    refs = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    bounds = bwd_rounding_bound(q, k, v, o, lse, do, refs, causal=True)
    for name, g, r, bound in zip(("dq", "dk", "dv"), grads, refs, bounds):
        assert torch.isfinite(g).all(), name
        diff = (g.float() - r.float()).abs()
        worst = (diff / (1e-5 + bound)).max().item()
        assert worst <= 1.0, f"{name}: max abs err {diff.max().item()}, {worst:.2f} of the limit"


# -- fused cross-entropy forward ---------------------------------------------------

def _ce_inputs(tokens, d, vocab, dtype, device, bias=False, seed=0):
    r = np.random.RandomState(seed)
    x = torch.tensor(r.randn(tokens, d), dtype=torch.float32).to(device, dtype)
    emb = torch.tensor(0.02 * r.randn(vocab, d), dtype=torch.float32).to(device)
    labels = torch.tensor(r.randint(0, vocab, tokens), device=device)
    b = torch.tensor(r.randn(vocab), dtype=torch.float32, device=device) if bias else None
    return x, emb, labels, b


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("shape", [
    (256, 128, 1024, False),    # whole tiles
    (300, 64, 1031, True),      # ragged tokens, a prime vocab's tail, a head bias
    (64, 1024, 50257, False),   # GPT-2's vocab at d 1024
], ids=["tiles", "ragged-bias", "gpt2-vocab"])
def test_ce_kernel_matches_plain(cuda, dtype, shape):
    """fp32 outputs on both sides; 16-bit inputs make exact fp32 products,
    so kernel and plain differ in summation order only: within 1e-5 +
    ``accumulation_bound``. fp32 inputs: 2e-5 + 2e-5 |plain|."""
    from deepspeed_tpu_torch.ops.cuda.cross_entropy import (
        accumulation_bound, fused_ce_forward, fused_ce_forward_reference)

    tokens, d, vocab, bias = shape
    x, emb, labels, b = _ce_inputs(tokens, d, vocab, dtype, cuda, bias=bias)
    before = LAUNCH_COUNTS["fused_ce_forward"]
    lse, lab = fused_ce_forward(x, emb, labels, b)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_ce_forward"] == before + 1
    ref_lse, ref_lab = fused_ce_forward_reference(x, emb, labels, b)
    for name, got, ref in (("lse", lse, ref_lse), ("label_logit", lab, ref_lab)):
        assert got.dtype == torch.float32 and got.shape == (tokens,)
        if dtype == torch.float32:
            limit = 2e-5 + 2e-5 * ref.abs()
        else:
            limit = 1e-5 + accumulation_bound(x, emb, ref_lse)
        worst = ((got - ref).abs() / limit).max().item()
        assert worst <= 1.0, f"{name}: max abs err {(got - ref).abs().max().item()}"


def test_ce_kernel_refuses_what_it_does_not_take(cuda):
    from deepspeed_tpu_torch.ops.cuda.cross_entropy import fused_ce_forward

    x, emb, labels, _ = _ce_inputs(64, 72, 256, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="multiple"):
        fused_ce_forward(x[:, :36], emb[:, :36], labels)     # 72 bytes a row
    x, emb, labels, _ = _ce_inputs(64, 64, 256, torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        fused_ce_forward(x.double(), emb, labels)
    with pytest.raises(TypeError, match="bias"):
        fused_ce_forward(x, emb, labels, torch.zeros(256, device=cuda).half())
    with pytest.raises(ValueError, match="aligned"):
        fused_ce_forward(x[:, 1:57], emb[:, 1:57], labels)


@pytest.mark.parametrize("head", ["tied", "untied"])
def test_fused_cross_entropy_on_the_card_matches_the_cpu(cuda, head):
    """``fused_cross_entropy(impl="pallas")`` with bf16 x and an fp32 master
    embedding: the card (the CE kernel, then fp32-output cuBLAS GEMMs in the
    chunked backward) against the CPU (the plain forward, fp32 GEMMs of the
    same bf16 values). The loss within 1e-5 relative; dx in bf16 within one
    bf16 rounding (rtol 1e-2, atol 1e-6); dE within 1e-3 relative of its
    largest element (the dlogits rounded to bf16 from fp32 values summed in
    another order). An untied head hands in emb as the transposed view of
    its [d, V] kernel."""
    from deepspeed_tpu_torch.ops.cross_entropy import fused_cross_entropy

    x, emb, labels, _ = _ce_inputs(512, 128, 1031, torch.float32, "cpu", seed=3)
    labels[:17] = -100
    out = {}
    for dev in ("cpu", cuda):
        xt = x.to(dev, torch.bfloat16).requires_grad_()
        et = (emb.T.contiguous() if head == "untied" else emb).to(dev).detach().requires_grad_()
        before = LAUNCH_COUNTS["fused_ce_forward"]
        loss = fused_cross_entropy(xt, et.T if head == "untied" else et, labels.to(dev),
                                   impl="pallas")
        loss.backward()
        assert LAUNCH_COUNTS["fused_ce_forward"] == before + (dev != "cpu")
        de = et.grad.T if head == "untied" else et.grad
        out[str(dev)] = (loss.item(), xt.grad.float().cpu(), de.cpu())
    (l_cpu, dx_cpu, de_cpu), (l_card, dx_card, de_card) = out["cpu"], out["cuda"]
    assert abs(l_card - l_cpu) <= 1e-5 * abs(l_cpu)
    torch.testing.assert_close(dx_card, dx_cpu, rtol=1e-2, atol=1e-6)
    assert (de_card - de_cpu).abs().max() <= 1e-3 * de_cpu.abs().max()


def test_training_engine_on_the_card(cuda):
    """``initialize`` on the card (no ``device``) trains a small GPT-2 with
    head_dim 64 in bf16 through both flash kernels and the CE kernel:
    exactly n_layers + n_layers + 1 launches per step, finite falling losses
    on a fixed batch."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, gpt2_config

    cfg = gpt2_config("tiny", vocab_size=1000, attention_impl="flash", fused_ce_impl="pallas")
    engine, *_ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), config={
        "train_batch_size": 4, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}}})
    assert engine.device.type == "cuda" and cfg.head_dim == 64
    batch = {"input_ids": np.random.RandomState(0).randint(0, 1000, (4, 128))}
    losses = []
    for _ in range(4):
        before = dict(LAUNCH_COUNTS)
        losses.append(engine.train_batch(batch=batch).item())
        assert {k: LAUNCH_COUNTS[k] - before[k] for k in
                ("flash_attention_fwd", "flash_attention_bwd", "fused_ce_forward")} == {
            "flash_attention_fwd": cfg.n_layers, "flash_attention_bwd": cfg.n_layers,
            "fused_ce_forward": 1}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# -- the weight-only quantized matmul and the int8 paged pool ----------------------

def _qmm_inputs(m, k, n, group, bits, dtype, device, seed=0):
    """x [m, k] and a weight quantized by ``quantize_per_channel`` (packed for
    bits 4), with the scale in x's dtype as the model hands it over."""
    from deepspeed_tpu_torch.ops.quantizer import pack_int4, quantize_per_channel

    r = np.random.RandomState(seed)
    x = torch.tensor(r.randn(m, k), dtype=torch.float32).to(device, dtype)
    w = torch.tensor(r.randn(k, n) * 0.02, dtype=torch.float32, device=device)
    q, scale = quantize_per_channel(w, bits=bits, group_size=group)
    if bits == 4:
        q = pack_int4(q)
    return x, q, scale.to(dtype)


def _assert_qmm_matches_plain(y, x, q, scale, bits):
    """fp32: summation order only, 2e-5 + 2e-5 |plain|. 16-bit: within
    ``rounding_bound`` (both sides dequantize to the same weights; each sum
    in its own order and one output rounding on each side)."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import (quantized_matmul_reference,
                                                               rounding_bound)

    ref = quantized_matmul_reference(x, q, scale, bits=bits)
    assert y.dtype == x.dtype and y.shape == ref.shape
    diff = (y.float() - ref.float()).abs()
    if x.dtype == torch.float32:
        limit = 2e-5 + 2e-5 * ref.float().abs()
    else:
        limit = rounding_bound(x, q, scale, ref, bits=bits)
    worst = (diff / limit).max().item()
    assert worst <= 1.0, f"max abs err {diff.max().item()}, {worst:.2f} of the limit"


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [
    (8, 4096, 11008, 64),      # Llama-7B up/gate projection, decode
    (1, 256, 384, 64),         # one row
    (40, 320, 200, 64),        # m not a multiple of 16, n not of 64
    (517, 1024, 1000, 128),    # several m tiles, ragged m and n
    (5, 200, 72, 40),          # k tail (200 is not a multiple of the k step)
    (33, 210, 130, 35),        # an odd group (int4: the TPU kernel refused it)
    (3, 210, 130, 35),         # the decode GEMV: odd group, n not a multiple of 4
    (16, 1024, 4096, 64),      # the GEMV's largest m, several k splits
    (64, 4096, 4096, 64),      # a short prefill: few tiles, k split across blocks
], ids=["llama7b-decode", "one-row", "ragged-mn", "multi-tile", "k-tail", "odd-group",
        "gemv-ragged", "gemv-m16", "split-tiles"])
def test_qmm_kernel_matches_plain(cuda, dtype, bits, shape):
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul

    m, k, n, group = shape
    x, q, scale = _qmm_inputs(m, k, n, group, bits, dtype, cuda)
    name = f"quantized_matmul_int{bits}"
    before = LAUNCH_COUNTS[name]
    y = quantized_matmul(x, q, scale, bits=bits)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS[name] == before + 1
    _assert_qmm_matches_plain(y, x, q, scale, bits)


def test_qmm_kernel_refuses_what_it_does_not_take(cuda):
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul

    x, q, scale = _qmm_inputs(4, 128, 96, 64, 8, torch.bfloat16, cuda)
    with pytest.raises(TypeError, match="scale"):
        quantized_matmul(x, q, scale.float(), bits=8)          # scale not in x's dtype
    wide = torch.empty((2, 1, 192), dtype=scale.dtype, device=cuda)
    wide[:, :, ::2] = scale
    with pytest.raises(ValueError, match="contiguous"):
        quantized_matmul(x, q, wide[:, :, ::2], bits=8)         # a strided scale
    with pytest.raises(TypeError, match="uint8"):
        quantized_matmul(x, q[:64], scale, bits=4)             # int8 storage for bits 4
    with pytest.raises(ValueError, match="input rows"):
        quantized_matmul(x[:, :64], q, scale, bits=8)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group", [64, 128])
@pytest.mark.parametrize("m", [17, 64, 2048, 4096])
def test_qmm_wgmma_route_matches_plain(cuda, m, group, bits):
    """The TMA + wgmma route at Llama-7B's gate/up projection (k 4096, n
    11008) from the least prefill m to beyond the longest: within
    ``rounding_bound``, one launch counted under the route's key too."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import kernel_route, quantized_matmul

    x, q, scale = _qmm_inputs(m, 4096, 11008, group, bits, torch.bfloat16, cuda)
    assert kernel_route(m, 11008, 4096, group, torch.bfloat16, bits) == "wgmma"
    before = dict(LAUNCH_COUNTS)
    y = quantized_matmul(x, q, scale, bits=bits)
    torch.cuda.synchronize()
    for name in (f"quantized_matmul_int{bits}", f"quantized_matmul_int{bits}_wgmma"):
        assert LAUNCH_COUNTS[name] == before[name] + 1
    _assert_qmm_matches_plain(y, x, q, scale, bits)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape,dtype,route", [
    ((16, 4096, 4096, 64), torch.float16, "gemv"),      # m: the decode GEMV's largest
    ((16, 4096, 4096, 64), torch.bfloat16, "mma"),      # m: the mma decode kernel's largest
    ((17, 4096, 4096, 64), torch.bfloat16, "wgmma"),    # and one row more
    ((8, 4096, 4104, 64), torch.bfloat16, "gemv"),      # n: 8 past a multiple of 16
    ((8, 4128, 1024, 32), torch.bfloat16, "gemv"),      # k: 32 past a multiple of 64
    ((200, 4096, 4104, 64), torch.bfloat16, "wmma"),    # n: 8 past a multiple of 16
    ((200, 4096, 4112, 64), torch.bfloat16, "wgmma"),   # n: a multiple of 16
    ((200, 4128, 1024, 32), torch.bfloat16, "wmma"),    # k: 32 past a multiple of 64
    ((200, 4160, 1024, 32), torch.bfloat16, "wgmma"),   # k: a multiple of 64
    ((200, 4032, 1024, 96), torch.bfloat16, "wmma"),    # a group neither side of 64 divides
    ((200, 4096, 1024, 8), torch.bfloat16, "wgmma"),    # the least group it takes
    ((200, 4096, 1024, 64), torch.float16, "wmma"),     # fp16 x: fp32 FMA
], ids=["gemv-m16", "mma-m16", "wgmma-m17", "gemv-n4104", "gemv-k4128", "wmma-n4104",
        "wgmma-n4112", "wmma-k4128", "wgmma-k4160", "wmma-g96", "wgmma-g8", "wmma-fp16"])
def test_qmm_route_boundary(cuda, shape, dtype, route, bits):
    """Shapes on each side of the Hopper routes' boundary take the route
    ``kernel_route`` names (the wgmma and mma keys count only their
    launches) and match the plain version."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import kernel_route, quantized_matmul

    m, k, n, group = shape
    assert kernel_route(m, n, k, group, dtype, bits) == route
    x, q, scale = _qmm_inputs(m, k, n, group, bits, dtype, cuda)
    keys = {r: f"quantized_matmul_int{bits}_{r}" for r in ("wgmma", "mma")}
    before = {r: LAUNCH_COUNTS[key] for r, key in keys.items()}
    y = quantized_matmul(x, q, scale, bits=bits)
    torch.cuda.synchronize()
    for r, key in keys.items():
        assert LAUNCH_COUNTS[key] == before[r] + (route == r)
    _assert_qmm_matches_plain(y, x, q, scale, bits)


def test_qmm_wgmma_route_takes_an_unaligned_x(cuda):
    """TMA reads from 16-byte aligned addresses: an x whose storage starts 2
    bytes in is copied once by the wrapper, and the product is the plain
    version's."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul

    x, q, scale = _qmm_inputs(100, 4096, 1024, 64, 8, torch.bfloat16, cuda)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    before = LAUNCH_COUNTS["quantized_matmul_int8_wgmma"]
    y = quantized_matmul(shifted, q, scale, bits=8)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["quantized_matmul_int8_wgmma"] == before + 1
    _assert_qmm_matches_plain(y, x, q, scale, 8)


def test_qmm_forced_routes(cuda):
    """The old tiled route still computes a wgmma shape (``chip_smoke.py``
    times the two side by side); a route that cannot take a shape raises."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul

    x, q, scale = _qmm_inputs(300, 4096, 1024, 64, 8, torch.bfloat16, cuda)
    before = LAUNCH_COUNTS["quantized_matmul_int8_wgmma"]
    y = quantized_matmul(x, q, scale, bits=8, route="wmma")
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["quantized_matmul_int8_wgmma"] == before
    _assert_qmm_matches_plain(y, x, q, scale, 8)
    x, q, scale = _qmm_inputs(300, 4096, 1000, 64, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="route"):
        quantized_matmul(x, q, scale, bits=8, route="wgmma")


@pytest.mark.parametrize("group", [32, 64, 128])
@pytest.mark.parametrize("kn", [(4096, 4096), (4096, 11008), (11008, 4096)],
                         ids=["k4096-n4096", "k4096-n11008", "k11008-n4096"])
@pytest.mark.parametrize("m", [1, 4, 8, 9, 16])
@pytest.mark.parametrize("bits", [8, 4])
def test_qmm_mma_route_matches_plain(cuda, bits, m, kn, group):
    """The mma decode kernel at Llama-7B's linears for every decode m (one
    and two n8 halves): within ``rounding_bound``, one launch counted under
    the route's key too, and a second launch bitwise equal to the first
    (the splits are added in order by the strip's last block)."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import kernel_route, quantized_matmul

    k, n = kn
    x, q, scale = _qmm_inputs(m, k, n, group, bits, torch.bfloat16, cuda)
    assert kernel_route(m, n, k, group, torch.bfloat16, bits) == "mma"
    before = dict(LAUNCH_COUNTS)
    y = quantized_matmul(x, q, scale, bits=bits)
    again = quantized_matmul(x, q, scale, bits=bits)
    torch.cuda.synchronize()
    for name in (f"quantized_matmul_int{bits}", f"quantized_matmul_int{bits}_mma"):
        assert LAUNCH_COUNTS[name] == before[name] + 2
    assert LAUNCH_COUNTS[f"quantized_matmul_int{bits}_wgmma"] == (
        before[f"quantized_matmul_int{bits}_wgmma"])
    assert torch.equal(y, again)
    _assert_qmm_matches_plain(y, x, q, scale, bits)


def test_qmm_mma_forced_routes(cuda):
    """The old split-k GEMV still computes an mma shape (``chip_smoke.py``
    times the two in turns); mma forced on fp16 x, or at m 17, raises; the
    mma kernel takes an x that starts 2 bytes in (copied once)."""
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul

    x, q, scale = _qmm_inputs(8, 4096, 11008, 64, 8, torch.bfloat16, cuda)
    before = dict(LAUNCH_COUNTS)
    y = quantized_matmul(x, q, scale, bits=8, route="gemv")
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["quantized_matmul_int8_mma"] == before["quantized_matmul_int8_mma"]
    assert LAUNCH_COUNTS["quantized_matmul_int8"] == before["quantized_matmul_int8"] + 1
    _assert_qmm_matches_plain(y, x, q, scale, 8)
    shifted = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:].view(x.shape)
    shifted.copy_(x)
    assert shifted.data_ptr() % 16
    _assert_qmm_matches_plain(quantized_matmul(shifted, q, scale, bits=8), x, q, scale, 8)
    x16, q16, scale16 = _qmm_inputs(8, 4096, 4096, 64, 8, torch.float16, cuda)
    with pytest.raises(ValueError, match="route"):
        quantized_matmul(x16, q16, scale16, bits=8, route="mma")
    x17, q17, scale17 = _qmm_inputs(17, 4096, 4096, 64, 8, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="route"):
        quantized_matmul(x17, q17, scale17, bits=8, route="mma")


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_linear_launches_at_any_m(cuda, bits):
    """linear_apply on a quantized linear reaches the kernel at a prefill m
    above the TPU kernel's 2048 gate, with the bias added after."""
    from deepspeed_tpu_torch.models.layers import linear_apply

    x, q, scale = _qmm_inputs(2100, 256, 192, 64, bits, torch.bfloat16, cuda)
    bias = torch.randn(192, device=cuda)
    p = {"kernel_q4" if bits == 4 else "kernel_q": q, "kernel_scale": scale.float(),
         "bias": bias}
    before = LAUNCH_COUNTS[f"quantized_matmul_int{bits}"]
    y = linear_apply(p, x.reshape(3, 700, 256), compute_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS[f"quantized_matmul_int{bits}"] == before + 1
    assert y.shape == (3, 700, 192) and y.dtype == torch.bfloat16
    from deepspeed_tpu_torch.ops.cuda.quantized_matmul import quantized_matmul_reference

    # the product is held to the plain version by test_qmm_kernel_matches_plain;
    # here a bf16 sum and a bf16 bias add: up to one ulp of each, 2^-6 relative
    ref = quantized_matmul_reference(x, q, scale, bits=bits) + bias.to(torch.bfloat16)
    torch.testing.assert_close(y.reshape(2100, 192).float(), ref.float(), rtol=2 ** -6, atol=1e-2)


def _int8_pool(args):
    """``_paged_inputs`` with its pool quantized to int8 + per-(token, head)
    scales (the garbage block's 1e4 poison survives as 127 * 1e4 / 127)."""
    from deepspeed_tpu_torch.comm.collectives import quantize_blockwise

    q, k_new, v_new, kc, vc, table, pos = args
    kq, ks = quantize_blockwise(kc.float(), block=kc.shape[-1])
    vq, vs = quantize_blockwise(vc.float(), block=vc.shape[-1])
    return (q, k_new, v_new, kq, vq, table, pos), dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("shape", [
    (8, 32, 32, 128, 16, 128, False, None),   # Llama-7B decode, the kernel's own splits
    (4, 32, 8, 128, 16, 32, True, 4),         # GQA 32/8, alibi, 4 splits
    (3, 6, 2, 64, 8, 8, True, 1),             # hq 3, head_dim 64, one split
], ids=["llama7b", "gqa-alibi", "hq3-one-split"])
def test_paged_int8_kernel_matches_plain(cuda, dtype, shape):
    """The int8 pool against the plain version: fp32 within 2e-5 + 2e-5
    |plain|; 16-bit within ``rounding_bound`` on the dequantized values."""
    from deepspeed_tpu_torch.ops.cuda.paged_attention import (
        paged_flash_decode, paged_flash_decode_reference, rounding_bound)

    s_dim, n_heads, kvh, dh, bs, nb_cols, alibi, splits = shape
    args, scales = _int8_pool(_paged_inputs(s_dim, n_heads, kvh, dh, bs, nb_cols, dtype, cuda))
    slopes = (0.5 ** torch.arange(1, n_heads + 1, dtype=torch.float32, device=cuda)
              if alibi else None)
    before = dict(LAUNCH_COUNTS)
    out = paged_flash_decode(*args, **scales, alibi_slopes=slopes, kv_splits=splits)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["paged_flash_decode_int8"] == before["paged_flash_decode_int8"] + 1
    assert LAUNCH_COUNTS["paged_flash_decode"] == before["paged_flash_decode"]
    ref = paged_flash_decode_reference(*args, **scales, alibi_slopes=slopes,
                                       kv_splits=splits or 4)
    assert out.dtype == dtype and out.shape == ref.shape
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        limit = 2e-5 + 2e-5 * ref.float().abs()
    else:
        limit = 1e-5 + rounding_bound(*args, ref, **scales, alibi_slopes=slopes)
    worst = (diff / limit).max().item()
    assert worst <= 1.0, f"max abs err {diff.max().item()}, {worst:.2f} of the limit"


def test_paged_int8_kernel_refuses_bad_scales(cuda):
    from deepspeed_tpu_torch.ops.cuda.paged_attention import paged_flash_decode

    args, scales = _int8_pool(_paged_inputs(2, 4, 4, 64, 8, 4, torch.bfloat16, cuda))
    ks, vs = scales["k_scale"], scales["v_scale"]
    with pytest.raises(TypeError, match="fp32"):
        paged_flash_decode(*args, k_scale=ks.half(), v_scale=vs.half())
    strided = lambda s: torch.cat([s, s], dim=-1)[..., :1]
    with pytest.raises(ValueError, match="contiguous"):
        paged_flash_decode(*args, k_scale=strided(ks), v_scale=strided(vs))
    with pytest.raises(ValueError, match="k_scale and v_scale"):
        paged_flash_decode(*args)


# -- block-sparse attention: forward, dQ and dK/dV ---------------------------------

def _sparse_case(pattern, block, causal, s_q, s_kv, b, h, d, dtype, device, seed=0):
    """The active lists of ``pattern`` (a sparse_pattern name, default kwargs)
    on ``device`` and q, k, v, dO [b, s, h, d]."""
    from deepspeed_tpu_torch.ops import sparse_attention as SA

    lists = SA.BlockSparseAttention(SA.PATTERNS[pattern](block=block), s_q, s_kv, causal=causal,
                                    device=device).lists
    q, k, v = _qkv(b, s_q, s_kv, h, h, d, dtype, device, seed=seed)
    do = torch.tensor(np.random.RandomState(seed + 1).randn(b, s_q, h, d),
                      dtype=torch.float32).to(device, dtype)
    return lists, q, k, v, do


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float32],
                         ids=["bf16", "fp16", "fp32"])
@pytest.mark.parametrize("case", [
    ("fixed", 128, True, 1024, 1024, 2, 4, 64),      # the training layout, tiles of 64
    ("bigbird", 64, False, 512, 512, 1, 2, 128),     # random blocks, non-causal
    ("bslongformer", 32, True, 256, 256, 2, 2, 64),  # 32-row tiles
    ("variable", 16, False, 128, 128, 1, 2, 128),    # 16-row tiles
    ("fixed", 48, True, 192, 384, 1, 2, 64),         # s_q < s_kv, a block of 48
    # the registry's other widths (d 256: 32-row tiles, two per block)
    ("fixed", 64, True, 256, 256, 1, 2, 32),
    ("fixed", 64, True, 256, 256, 1, 2, 80),
    ("bigbird", 64, False, 256, 256, 1, 2, 96),
    ("fixed", 64, True, 256, 256, 1, 2, 256),
], ids=["fixed128", "bigbird64-noncausal", "longformer32", "variable16-noncausal",
        "sq<skv-block48", "fixed64-d32", "fixed64-d80", "bigbird64-noncausal-d96",
        "fixed64-d256"])
def test_block_sparse_kernels_match_plain(cuda, dtype, case):
    """Forward (o and lse) and backward against the plain versions: 16-bit
    within 1e-5 + ``rounding_bound`` / ``bwd_rounding_bound`` (the kernels
    round P and dS to the input type; both sides round the outputs); fp32
    within 2e-5 + 2e-5 |plain| (summation order only); lse within 1e-5 +
    1e-5 |lse|. One launch of each wrapper."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        block_sparse_attention_bwd, block_sparse_attention_bwd_reference,
        block_sparse_attention_fwd, block_sparse_attention_fwd_reference,
        bwd_rounding_bound, rounding_bound)

    pattern, block, causal, s_q, s_kv, b, h, d = case
    lists, q, k, v, do = _sparse_case(pattern, block, causal, s_q, s_kv, b, h, d, dtype, cuda)
    before = dict(LAUNCH_COUNTS)
    out, lse = block_sparse_attention_fwd(q, k, v, lists, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["block_sparse_attention_fwd"] == before["block_sparse_attention_fwd"] + 1
    ref, ref_lse = block_sparse_attention_fwd_reference(q, k, v, lists, causal=causal,
                                                        return_lse=True)
    assert out.dtype == dtype and out.shape == q.shape and lse.shape == (b, h, s_q)
    assert ((lse - ref_lse).abs() <= 1e-5 + 1e-5 * ref_lse.abs()).all()
    diff = (out.float() - ref.float()).abs()
    bound = rounding_bound(q, k, v, ref, lists, causal=causal)
    limit = 2e-5 + 2e-5 * ref.float().abs() if bound is None else 1e-5 + bound
    worst = (diff / limit).max().item()
    assert worst <= 1.0, f"forward: max abs err {diff.max().item()}, {worst:.2f} of the limit"

    grads = block_sparse_attention_bwd(q, k, v, ref, ref_lse, do, lists, causal=causal)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["block_sparse_attention_bwd"] == before["block_sparse_attention_bwd"] + 1
    refs = block_sparse_attention_bwd_reference(q, k, v, ref, ref_lse, do, lists, causal=causal)
    bounds = bwd_rounding_bound(q, k, v, ref, ref_lse, do, refs, lists, causal=causal)
    for i, (name, g, r) in enumerate(zip(("dq", "dk", "dv"), grads, refs)):
        assert g.dtype == dtype and g.shape == r.shape, name
        diff = (g.float() - r.float()).abs()
        limit = (2e-5 + 2e-5 * r.float().abs()) if bounds is None else 1e-5 + bounds[i]
        worst = (diff / limit).max().item()
        assert worst <= 1.0, f"{name}: max abs err {diff.max().item()}, {worst:.2f} of the limit"


def test_block_sparse_kernel_zeroes_unattended_kv_blocks(cuda):
    """A non-causal layout in which some kv block no query attends: its dK
    and dV come back zero (the TPU kernel's ``_untouched`` step)."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        SparseLayout, block_sparse_attention_bwd, block_sparse_attention_fwd)

    layout = np.zeros((4, 4), bool)
    layout[:, 0] = True
    layout[3, 3] = True  # kv blocks 1 and 2 are attended by nobody
    lists = SparseLayout(layout, 64, cuda)
    q, k, v = _qkv(1, 256, 256, 2, 2, 64, torch.bfloat16, cuda)
    o, lse = block_sparse_attention_fwd(q, k, v, lists, causal=False, return_lse=True)
    dq, dk, dv = block_sparse_attention_bwd(q, k, v, o, lse, torch.ones_like(q), lists,
                                            causal=False)
    assert (dk[:, 64:192] == 0).all() and (dv[:, 64:192] == 0).all()
    assert dv[:, :64].abs().sum() > 0 and dv[:, 192:].abs().sum() > 0


def test_block_sparse_kernel_refuses_what_it_does_not_take(cuda):
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        SparseLayout, block_sparse_attention_bwd, block_sparse_attention_fwd)

    lists, q, k, v, do = _sparse_case("fixed", 64, True, 256, 256, 1, 2, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="lse"):
        block_sparse_attention_bwd(q, k, v, q, None, do, lists)
    with pytest.raises(ValueError, match="multiple of 16"):
        block_sparse_attention_fwd(q, k, v, SparseLayout(np.tril(np.ones((32, 32), bool)), 8,
                                                         cuda))
    with pytest.raises(ValueError, match="lists are on"):
        block_sparse_attention_fwd(q, k, v, SparseLayout(lists.layout, 64, "cpu"))
    with pytest.raises(ValueError, match="head_dim"):
        block_sparse_attention_fwd(q[..., :48], k[..., :48], v[..., :48], lists)
    with pytest.raises(ValueError, match="one head count"):
        block_sparse_attention_fwd(q, k[:, :, :1], v[:, :, :1], lists)


def test_block_sparse_wrapper_raises_when_the_library_cannot_load(cuda, monkeypatch):
    """A build that fails raises from the wrapper: no quiet switch to the
    plain version or to dense attention."""
    import deepspeed_tpu_torch.ops.cuda.block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops import op_builder

    def broken(self):
        raise RuntimeError("nvcc failed building block_sparse_attention (test)")

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.delitem(op_builder._LOADED, "block_sparse_attention", raising=False)
    monkeypatch.setattr(op_builder.BlockSparseAttentionBuilder, "build", broken)
    monkeypatch.setattr(bsa, "block_sparse_attention_fwd_reference", plain)
    lists, q, k, v, do = _sparse_case("fixed", 64, True, 256, 256, 1, 2, 64, torch.bfloat16, cuda)
    before = dict(LAUNCH_COUNTS)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bsa.block_sparse_attention_fwd(q, k, v, lists)
    assert LAUNCH_COUNTS == before


def test_block_sparse_autograd_never_reaches_the_plain_version(cuda, monkeypatch):
    """``BlockSparseAttention`` under autograd on CUDA tensors: one forward
    and one backward launch, the plain versions never called, and the
    gradients those of the wrappers called directly (bitwise)."""
    import deepspeed_tpu_torch.ops.cuda.block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.sparse_attention import (BlockSparseAttention,
                                                          FixedSparsityConfig)

    attn = BlockSparseAttention(FixedSparsityConfig(block=64), 512, device=cuda)
    q, k, v = (t.requires_grad_() for t in _qkv(2, 512, 512, 4, 4, 64, torch.bfloat16, cuda))
    do = torch.randn(2, 512, 4, 64, device=cuda).to(torch.bfloat16)

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(bsa, "block_sparse_attention_fwd_reference", plain)
    monkeypatch.setattr(bsa, "block_sparse_attention_bwd_reference", plain)
    before = dict(LAUNCH_COUNTS)
    attn(q, k, v).backward(do)
    torch.cuda.synchronize()
    delta = {n: LAUNCH_COUNTS[n] - before[n] for n in LAUNCH_COUNTS}
    assert delta["block_sparse_attention_fwd"] == 1 and delta["block_sparse_attention_bwd"] == 1
    assert delta["flash_attention_fwd"] == delta["flash_attention_bwd"] == 0
    o, lse = bsa.block_sparse_attention_fwd(q.detach(), k.detach(), v.detach(), attn.lists,
                                            return_lse=True)
    for g, w in zip((q.grad, k.grad, v.grad),
                    bsa.block_sparse_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse,
                                                   do, attn.lists)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_block_sparse_training_engine_on_the_card(cuda):
    """``initialize`` on the card trains a small GPT-2 with
    ``attention_impl="block_sparse"`` (fixed pattern, block 32) in bf16:
    exactly n_layers forward and n_layers backward block-sparse launches
    and one CE launch per step, no flash launch, finite falling losses."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import CausalLM, gpt2_config

    cfg = gpt2_config("tiny", vocab_size=1000, attention_impl="block_sparse", sparse_block=32,
                      sparse_pattern_config={"num_local_blocks": 2, "num_global_blocks": 1},
                      fused_ce_impl="pallas")
    engine, *_ = deepspeed_tpu_torch.initialize(model=CausalLM(cfg), config={
        "train_batch_size": 4, "bf16": {"enabled": True}, "gradient_clipping": 1.0,
        "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}}})
    batch = {"input_ids": np.random.RandomState(0).randint(0, 1000, (4, 128))}
    names = ("block_sparse_attention_fwd", "block_sparse_attention_bwd", "fused_ce_forward",
             "flash_attention_fwd", "flash_attention_bwd")
    losses = []
    for _ in range(4):
        before = dict(LAUNCH_COUNTS)
        losses.append(engine.train_batch(batch=batch).item())
        assert {n: LAUNCH_COUNTS[n] - before[n] for n in names} == {
            "block_sparse_attention_fwd": cfg.n_layers, "block_sparse_attention_bwd": cfg.n_layers,
            "fused_ce_forward": 1, "flash_attention_fwd": 0, "flash_attention_bwd": 0}
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


# -- the TMA + wgmma routes of the CE forward and the block-sparse backward --------

_CE_ROUTE_SHAPES = [
    # (tokens, d, vocab, bias, ignored rows)
    (1000, 64, 50257, False, 0),            # ragged tokens, GPT-2's vocab, d 64
    (12288 + 37, 1024, 129, True, 37),      # ragged past the training tokens, a 129 vocab
    (1000, 4096, 1000, True, 0),            # Llama's width
    (1000, 1024, 50257, False, 100),        # GPT-2 medium's width, ignored rows
    (12288 + 37, 64, 1000, False, 0),
]
_CE_ROUTE_IDS = ["t1000-d64-v50257", "t12325-d1024-v129-bias-ignored", "t1000-d4096-v1000-bias",
                 "t1000-d1024-v50257-ignored", "t12325-d64-v1000"]


@pytest.mark.parametrize("route", ["wgmma", "wmma"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("shape", _CE_ROUTE_SHAPES, ids=_CE_ROUTE_IDS)
def test_ce_routes_match_plain(cuda, shape, dtype, route):
    """Both routes of the CE forward against the plain version at ragged
    token counts and vocabularies, with and without a bias, with ignored
    rows (made safe as ``fused_cross_entropy`` passes them), at d 64, 1024
    and 4096: within 1e-5 + ``accumulation_bound``. The wgmma route is the
    one ``ce_route`` picks; each launch counts on its route."""
    from deepspeed_tpu_torch.ops.cuda.cross_entropy import (
        accumulation_bound, ce_route, fused_ce_forward, fused_ce_forward_reference)

    tokens, d, vocab, bias, ignored = shape
    x, emb, labels, b = _ce_inputs(tokens, d, vocab, dtype, cuda, bias=bias)
    labels[:ignored] = -100
    safe = torch.where(labels != -100, labels, 0)
    assert ce_route(dtype, d) == "wgmma"
    before = dict(LAUNCH_COUNTS)
    lse, lab = fused_ce_forward(x, emb, safe, b, _route=route)
    torch.cuda.synchronize()
    assert LAUNCH_COUNTS["fused_ce_forward"] == before["fused_ce_forward"] + 1
    assert LAUNCH_COUNTS["fused_ce_forward_wgmma"] == (before["fused_ce_forward_wgmma"]
                                                       + (route == "wgmma"))
    ref_lse, ref_lab = fused_ce_forward_reference(x, emb, safe, b)
    limit = 1e-5 + accumulation_bound(x, emb, ref_lse)
    for name, got, ref in (("lse", lse, ref_lse), ("label_logit", lab, ref_lab)):
        assert got.dtype == torch.float32 and got.shape == (tokens,)
        worst = ((got - ref).abs() / limit).max().item()
        assert worst <= 1.0, f"{name}: max abs err {(got - ref).abs().max().item()}"


def test_ce_wgmma_route_is_deterministic(cuda):
    """Two launches of the wgmma CE give bitwise-equal outputs: the vocab
    slices' partials are combined in slice order, with no atomics."""
    from deepspeed_tpu_torch.ops.cuda.cross_entropy import fused_ce_forward

    x, emb, labels, b = _ce_inputs(2000, 1024, 50257, torch.bfloat16, cuda, bias=True)
    first = fused_ce_forward(x, emb, labels, b)
    second = fused_ce_forward(x, emb, labels, b)
    for f, s in zip(first, second):
        assert torch.equal(f, s)


def test_ce_forced_route_refuses_what_it_does_not_take(cuda):
    from deepspeed_tpu_torch.ops.cuda.cross_entropy import fused_ce_forward

    x, emb, labels, _ = _ce_inputs(64, 72, 256, torch.bfloat16, cuda)
    with pytest.raises(ValueError, match="route"):
        fused_ce_forward(x, emb, labels, _route="wgmma")        # d 72
    x, emb, labels, _ = _ce_inputs(64, 64, 256, torch.float32, cuda)
    with pytest.raises(ValueError, match="route"):
        fused_ce_forward(x, emb, labels, _route="wgmma")        # fp32


_SPARSE_PATTERNS = ["dense", "fixed", "bigbird", "bslongformer", "variable"]


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("mode", ["causal", "causal-sq<skv", "noncausal"])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("pattern", _SPARSE_PATTERNS)
def test_block_sparse_bwd_routes_match_plain(cuda, pattern, block, mode, dtype, d):
    """Both routes of the block-sparse backward against the plain version
    for every pattern at blocks 128 and 256, causal (s_q = s_kv and s_q <
    s_kv) and not: within 1e-5 + ``bwd_rounding_bound``. The wgmma route is
    the one ``block_sparse_route`` picks; each launch counts on its route."""
    _check_block_sparse_bwd_routes(cuda, pattern, block, mode, dtype, d)


def _check_sparse_grads(grads, q, k, v, o, lse, do, lists, causal, what):
    """dq, dk, dv within 1e-5 + ``bwd_rounding_bound`` of the plain version,
    each finite."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        block_sparse_attention_bwd_reference, bwd_rounding_bound)

    refs = block_sparse_attention_bwd_reference(q, k, v, o, lse, do, lists, causal=causal)
    bounds = bwd_rounding_bound(q, k, v, o, lse, do, refs, lists, causal=causal)
    for name, g, r, bound in zip(("dq", "dk", "dv"), grads, refs, bounds):
        assert g.dtype == q.dtype and g.shape == r.shape, (what, name)
        assert torch.isfinite(g).all(), (what, name)
        diff = (g.float() - r.float()).abs()
        worst = (diff / (1e-5 + bound)).max().item()
        assert worst <= 1.0, (f"{what} {name}: max abs err {diff.max().item()}, "
                              f"{worst:.2f} of the limit")


def _check_block_sparse_bwd_routes(device, pattern, block, mode, dtype, d):
    """Both routes of the block-sparse backward against the plain version
    (``_check_sparse_grads``): the wgmma route is the one
    ``block_sparse_route`` picks, and each launch counts on its route."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        block_sparse_attention_bwd, block_sparse_attention_fwd_reference, block_sparse_route)

    causal = mode != "noncausal"
    s_kv = 8 * block
    s_q = s_kv - block if mode == "causal-sq<skv" else s_kv
    lists, q, k, v, do = _sparse_case(pattern, block, causal, s_q, s_kv, 1, 2, d, dtype, device)
    assert block_sparse_route(dtype, d, block, "bwd") == "wgmma"
    o, lse = block_sparse_attention_fwd_reference(q, k, v, lists, causal=causal, return_lse=True)
    o = o.to(dtype)
    for route in ("wgmma", "wmma"):
        before = dict(LAUNCH_COUNTS)
        grads = block_sparse_attention_bwd(q, k, v, o, lse, do, lists, causal=causal,
                                           _route=route)
        torch.cuda.synchronize()
        assert LAUNCH_COUNTS["block_sparse_attention_bwd"] == (
            before["block_sparse_attention_bwd"] + 1)
        assert LAUNCH_COUNTS["block_sparse_attention_bwd_wgmma"] == (
            before["block_sparse_attention_bwd_wgmma"] + (route == "wgmma"))
        _check_sparse_grads(grads, q, k, v, o, lse, do, lists, causal,
                            f"{pattern} {block} {mode} {dtype} d{d} {route}")


def test_block_sparse_wgmma_bwd_zeroes_unattended_kv_blocks(cuda):
    """A non-causal layout in which kv blocks 1 and 2 are attended by no
    query, and q block 2 attends nothing: their dK, dV and dQ come back zero
    on the wgmma route, the rest within its bound; at blocks of 128 and 64
    (where a 128-row tile's other half keeps the tile walked) and at every
    wgmma width."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        SparseLayout, block_sparse_attention_bwd, block_sparse_attention_fwd_reference)

    layout = np.zeros((4, 4), bool)
    layout[:, 0] = True
    layout[3, 3] = True
    layout[2, :] = False
    for blk in (128, 64):
        lists = SparseLayout(layout, blk, cuda)
        for d in (64, 80, 96, 128, 256):
            q, k, v = _qkv(1, 4 * blk, 4 * blk, 2, 2, d, torch.bfloat16, cuda)
            do = torch.ones_like(q)
            o, lse = block_sparse_attention_fwd_reference(q, k, v, lists, causal=False,
                                                          return_lse=True)
            o = o.to(q.dtype)
            before = LAUNCH_COUNTS["block_sparse_attention_bwd_wgmma"]
            dq, dk, dv = block_sparse_attention_bwd(q, k, v, o, lse, do, lists, causal=False)
            torch.cuda.synchronize()
            assert LAUNCH_COUNTS["block_sparse_attention_bwd_wgmma"] == before + 1
            assert (dk[:, blk:3 * blk] == 0).all() and (dv[:, blk:3 * blk] == 0).all()
            assert (dq[:, 2 * blk:3 * blk] == 0).all()
            assert dv[:, :blk].abs().sum() > 0 and dv[:, 3 * blk:].abs().sum() > 0
            _check_sparse_grads((dq, dk, dv), q, k, v, o, lse, do, lists, False,
                                f"block {blk} d{d}")


def test_block_sparse_wgmma_bwd_skips_blocks_past_the_diagonal(cuda):
    """A causal layout that keeps every block, those wholly past the causal
    diagonal too (the patterns' causal rule never lists them; the kernel
    does not rely on it): the wgmma backward skips them and holds the plain
    version, which masks them."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        SparseLayout, block_sparse_attention_bwd, block_sparse_attention_bwd_reference,
        block_sparse_attention_fwd_reference, bwd_rounding_bound)

    for blk, d in ((128, 128), (64, 128), (64, 256)):
        for s_q in (512, 384, 448):
            if s_q % blk:
                continue
            l = SparseLayout(np.ones((s_q // blk, 512 // blk), bool), blk, cuda)
            q, k, v = _qkv(1, s_q, 512, 2, 2, d, torch.float16, cuda)
            do = torch.randn_like(q)
            o, lse = block_sparse_attention_fwd_reference(q, k, v, l, causal=True,
                                                          return_lse=True)
            o = o.to(q.dtype)
            grads = block_sparse_attention_bwd(q, k, v, o, lse, do, l, causal=True,
                                               _route="wgmma")
            refs = block_sparse_attention_bwd_reference(q, k, v, o, lse, do, l, causal=True)
            bounds = bwd_rounding_bound(q, k, v, o, lse, do, refs, l, causal=True)
            for g, r, bnd in zip(grads, refs, bounds):
                assert ((g.float() - r.float()).abs() <= 1e-5 + bnd).all(), (blk, d, s_q)


def test_block_sparse_wgmma_bwd_is_deterministic(cuda):
    """Two launches of the wgmma backward give bitwise-equal gradients
    (every output tile is owned by one block; no atomics)."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        block_sparse_attention_bwd, block_sparse_attention_fwd)

    lists, q, k, v, do = _sparse_case("fixed", 128, True, 1024, 1024, 2, 4, 64, torch.bfloat16,
                                      cuda)
    o, lse = block_sparse_attention_fwd(q, k, v, lists, causal=True, return_lse=True)
    first = block_sparse_attention_bwd(q, k, v, o, lse, do, lists, causal=True)
    second = block_sparse_attention_bwd(q, k, v, o, lse, do, lists, causal=True)
    for f, s in zip(first, second):
        assert torch.equal(f, s)


def test_block_sparse_wgmma_bwd_under_autograd(cuda, monkeypatch):
    """``BlockSparseAttention`` at 128-token blocks under autograd (whose
    backward runs on a thread of its own, where the TMA descriptors are
    encoded): one wgmma backward launch, the plain versions never called,
    and the gradients those of the wrapper called directly (bitwise)."""
    import deepspeed_tpu_torch.ops.cuda.block_sparse_attention as bsa
    from deepspeed_tpu_torch.ops.sparse_attention import (BlockSparseAttention,
                                                          FixedSparsityConfig)

    attn = BlockSparseAttention(FixedSparsityConfig(block=128), 1024, device=cuda)
    q, k, v = (t.requires_grad_() for t in _qkv(2, 1024, 1024, 4, 4, 128, torch.bfloat16, cuda))
    do = torch.randn(2, 1024, 4, 128, device=cuda).to(torch.bfloat16)

    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(bsa, "block_sparse_attention_fwd_reference", plain)
    monkeypatch.setattr(bsa, "block_sparse_attention_bwd_reference", plain)
    before = dict(LAUNCH_COUNTS)
    attn(q, k, v).backward(do)
    torch.cuda.synchronize()
    delta = {n: LAUNCH_COUNTS[n] - before[n] for n in LAUNCH_COUNTS}
    assert delta["block_sparse_attention_bwd"] == delta["block_sparse_attention_bwd_wgmma"] == 1
    o, lse = bsa.block_sparse_attention_fwd(q.detach(), k.detach(), v.detach(), attn.lists,
                                            return_lse=True)
    for g, w in zip((q.grad, k.grad, v.grad),
                    bsa.block_sparse_attention_bwd(q.detach(), k.detach(), v.detach(), o, lse,
                                                   do, attn.lists)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_block_sparse_forced_route_refuses_what_it_does_not_take(cuda):
    """A forced wgmma route raises where the kernel has none: blocks of 32
    and 48, fp32, head_dim 32; at head_dim 80, 96 and 256 with blocks of 64
    and 128 both kernels take it, forced or not."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        block_sparse_attention_bwd, block_sparse_attention_fwd)

    for block, dtype, d in ((32, torch.bfloat16, 64), (128, torch.float32, 64),
                            (32, torch.bfloat16, 80), (48, torch.float16, 96),
                            (32, torch.bfloat16, 256), (64, torch.bfloat16, 32)):
        lists, q, k, v, do = _sparse_case("fixed", block, True, 384, 384, 1, 2, d, dtype, cuda)
        o, lse = block_sparse_attention_fwd(q, k, v, lists, causal=True, return_lse=True)
        with pytest.raises(ValueError, match="route"):
            block_sparse_attention_bwd(q, k, v, o, lse, do, lists, _route="wgmma")
        with pytest.raises(ValueError, match="route"):
            block_sparse_attention_fwd(q, k, v, lists, causal=True, _route="wgmma")
    for d in (80, 96, 256):
        for block in (128, 64):
            lists, q, k, v, do = _sparse_case("fixed", block, True, 512, 512, 1, 2, d,
                                              torch.bfloat16, cuda)
            before = dict(LAUNCH_COUNTS)
            o, lse = block_sparse_attention_fwd(q, k, v, lists, causal=True, return_lse=True,
                                                _route="wgmma")
            grads = block_sparse_attention_bwd(q, k, v, o, lse, do, lists, _route="wgmma")
            torch.cuda.synchronize()
            for part in ("fwd", "bwd"):
                name = f"block_sparse_attention_{part}_wgmma"
                assert LAUNCH_COUNTS[name] == before[name] + 1, (d, block, part)
            _assert_sparse_fwd_matches_plain(o, lse, q, k, v, lists, True, f"forced d{d}")
            _check_sparse_grads(grads, q, k, v, o, lse, do, lists, True, f"forced d{d}")


# -- the block-sparse forward's two routes -------------------------------------------

def _assert_sparse_fwd_matches_plain(out, lse, q, k, v, lists, causal, what):
    """o within 1e-5 + ``rounding_bound`` of the plain version, lse (when
    given) within 1e-5 + 1e-5 |lse|."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (
        block_sparse_attention_fwd_reference, rounding_bound)

    ref, ref_lse = block_sparse_attention_fwd_reference(q, k, v, lists, causal=causal,
                                                        return_lse=True)
    assert out.dtype == q.dtype and out.shape == q.shape, what
    diff = (out.float() - ref.float()).abs()
    worst = (diff / (1e-5 + rounding_bound(q, k, v, ref, lists, causal=causal))).max().item()
    assert worst <= 1.0, f"{what}: max abs err {diff.max().item()}, {worst:.2f} of the limit"
    if lse is not None:
        assert lse.shape == ref_lse.shape, what
        assert ((lse - ref_lse).abs() <= 1e-5 + 1e-5 * ref_lse.abs()).all(), what


def _check_block_sparse_fwd_routes(device, pattern, block, mode, dtype, d):
    """Both routes of the block-sparse forward against the plain version:
    o within 1e-5 + ``rounding_bound``, lse within 1e-5 + 1e-5 |lse|, the
    output without lse bitwise that with it; the wgmma route is the one
    ``block_sparse_route`` picks, and each launch counts on its route."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (block_sparse_attention_fwd,
                                                                     block_sparse_route)

    causal = mode != "noncausal"
    s_kv = 8 * block
    s_q = s_kv - block if mode == "causal-sq<skv" else s_kv
    lists, q, k, v, _ = _sparse_case(pattern, block, causal, s_q, s_kv, 1, 2, d, dtype, device)
    assert block_sparse_route(dtype, d, block, "fwd") == "wgmma"
    for route in ("wgmma", "wmma"):
        forced = None if route == "wgmma" else route
        before = dict(LAUNCH_COUNTS)
        out, lse = block_sparse_attention_fwd(q, k, v, lists, causal=causal, return_lse=True,
                                              _route=forced)
        bare = block_sparse_attention_fwd(q, k, v, lists, causal=causal, _route=forced)
        torch.cuda.synchronize()
        assert LAUNCH_COUNTS["block_sparse_attention_fwd"] == (
            before["block_sparse_attention_fwd"] + 2)
        assert LAUNCH_COUNTS["block_sparse_attention_fwd_wgmma"] == (
            before["block_sparse_attention_fwd_wgmma"] + 2 * (route == "wgmma"))
        assert torch.equal(out, bare), route
        _assert_sparse_fwd_matches_plain(out, lse, q, k, v, lists, causal,
                                         f"{pattern} {block} {mode} {dtype} d{d} {route}")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
@pytest.mark.parametrize("mode", ["causal", "causal-sq<skv", "noncausal"])
@pytest.mark.parametrize("block", [128, 256])
@pytest.mark.parametrize("pattern", _SPARSE_PATTERNS)
def test_block_sparse_fwd_routes_match_plain(cuda, pattern, block, mode, dtype, d):
    """Both routes of the block-sparse forward against the plain version for
    every pattern at blocks 128 and 256, causal (s_q = s_kv and s_q < s_kv)
    and not, with and without lse (``_check_block_sparse_fwd_routes``)."""
    _check_block_sparse_fwd_routes(cuda, pattern, block, mode, dtype, d)


def test_block_sparse_fwd_routes_match_plain_at_the_preset_widths(cuda):
    """The same, and the backward's two routes
    (``_check_block_sparse_bwd_routes``), at head_dim 80 and 96 (two panels,
    the second zero-filled) and 256 (64-row kv tiles; the backward's 32-row
    dQ tiles and split dK/dV block), every pattern, blocks 64, 128 and 256,
    causal (s_q = s_kv and s_q < s_kv: at block 64 a last q tile of one
    half) and not, bf16 and fp16; at head_dim 64 and 128 with blocks of 64
    (the union walks: bigbird's and variable's halves list different
    blocks)."""
    for d in (64, 80, 96, 128, 256):
        for pattern in _SPARSE_PATTERNS:
            for block in (64, 128, 256) if d in (80, 96, 256) else (64,):
                for mode in ("causal", "causal-sq<skv", "noncausal"):
                    for dtype in (torch.bfloat16, torch.float16):
                        _check_block_sparse_fwd_routes(cuda, pattern, block, mode, dtype, d)
                        _check_block_sparse_bwd_routes(cuda, pattern, block, mode, dtype, d)


def test_block_sparse_wgmma_fwd_writes_empty_rows_as_the_plain_version(cuda):
    """A non-causal layout in which q block 2 attends nothing: its rows come
    back o = 0 and lse = -1e30 (the plain version's), the rest within the
    bound, in bf16 and fp16 at every wgmma width, at blocks of 128 and 64
    (where q block 2 shares its 128-row tile with q block 3, whose list the
    tile walks)."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (SparseLayout,
                                                                     block_sparse_attention_fwd)

    layout = np.zeros((4, 4), bool)
    layout[:, 0] = True
    layout[3, 3] = True
    layout[2, :] = False
    for blk in (128, 64):
        lists = SparseLayout(layout, blk, cuda)
        for dtype in (torch.bfloat16, torch.float16):
            for d in (64, 80, 96, 128, 256):
                q, k, v = _qkv(2, 4 * blk, 4 * blk, 2, 2, d, dtype, cuda)
                before = LAUNCH_COUNTS["block_sparse_attention_fwd_wgmma"]
                out, lse = block_sparse_attention_fwd(q, k, v, lists, causal=False,
                                                      return_lse=True)
                torch.cuda.synchronize()
                assert LAUNCH_COUNTS["block_sparse_attention_fwd_wgmma"] == before + 1
                rows = slice(2 * blk, 3 * blk)
                assert (out[:, rows] == 0).all() and (lse[:, :, rows] == -1e30).all()
                _assert_sparse_fwd_matches_plain(out, lse, q, k, v, lists, False,
                                                 f"block {blk} {dtype} d{d}")


def test_block_sparse_wgmma_fwd_skips_blocks_past_the_diagonal(cuda):
    """A causal layout that keeps every block, those wholly past the causal
    diagonal too: the wgmma forward skips them and holds the plain version,
    which masks them (s_q = s_kv and s_q < s_kv)."""
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import (SparseLayout,
                                                                     block_sparse_attention_fwd)

    for blk in (128, 64):
        for s_q in (512, 384, 448):
            if s_q % blk:
                continue
            lists = SparseLayout(np.ones((s_q // blk, 512 // blk), bool), blk, cuda)
            q, k, v = _qkv(1, s_q, 512, 2, 2, 128, torch.float16, cuda)
            out, lse = block_sparse_attention_fwd(q, k, v, lists, causal=True, return_lse=True,
                                                  _route="wgmma")
            _assert_sparse_fwd_matches_plain(out, lse, q, k, v, lists, True,
                                             f"block {blk} s_q {s_q}")


def test_block_sparse_wgmma_fwd_at_s4096_is_deterministic(cuda):
    """Phase 8's pattern (fixed, 128-token blocks, 4 local, 1 global) on b 3
    x s 4096 bf16 (the training step's tokens as long sequences): within the
    bound, and two launches bitwise equal."""
    from deepspeed_tpu_torch.ops import sparse_attention as SA
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import block_sparse_attention_fwd

    lists = SA.BlockSparseAttention(SA.PATTERNS["fixed"](block=128, num_local_blocks=4,
                                                         num_global_blocks=1), 4096,
                                    device=cuda).lists
    q, k, v = _qkv(3, 4096, 4096, 16, 16, 64, torch.bfloat16, cuda)
    first, lse = block_sparse_attention_fwd(q, k, v, lists, return_lse=True)
    second = block_sparse_attention_fwd(q, k, v, lists)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    _assert_sparse_fwd_matches_plain(first, lse, q, k, v, lists, True, "b3 s4096")
