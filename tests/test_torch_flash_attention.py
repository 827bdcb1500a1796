"""The plain version of the port's flash-attention kernel against the TPU
kernel (``pallas_flash_attention`` in interpret mode, as the JAX package's
own tests run it on the CPU), and the port's dispatch on CPU tensors."""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.flash_attention import _chunked_attention as jax_chunked
from deepspeed_tpu.ops.pallas.flash_attention import pallas_flash_attention
from deepspeed_tpu_torch.models.registry import MODEL_CONFIGS
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda import block_sparse_attention as cuda_bsa
from deepspeed_tpu_torch.ops.cuda import flash_attention as cuda_flash
from deepspeed_tpu_torch.ops.cuda.flash_attention import (flash_attention_fwd,
                                                          flash_attention_reference,
                                                          rounding_bound)
from deepspeed_tpu_torch.ops.flash_attention import flash_attention


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _qkv(b, s_q, s_kv, h, d, seed, kvh=None):
    r = np.random.RandomState(seed)
    return (r.randn(b, s_q, h, d).astype(np.float32),
            r.randn(b, s_kv, kvh or h, d).astype(np.float32),
            r.randn(b, s_kv, kvh or h, d).astype(np.float32))


# block_kv == s_kv runs the single-kv-tile TPU kernel (_fwd_kernel_single);
# smaller block_kv the kv-tile loop (_fwd_kernel). head_dim 32 throughout,
# and the registry's widths no other case has (80, 96, 256) over kv tiles.
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s_q,s_kv,bq,bkv,d", [
    (128, 128, 64, 128, 32),   # single kv tile
    (128, 128, 32, 32, 32),    # multi kv tile
    (64, 128, 32, 64, 32),     # s_q < s_kv (causal aligned to the kv end)
    (128, 128, 64, 64, 80),
    (128, 128, 64, 64, 96),
    (128, 128, 64, 64, 256),
], ids=["single-tile", "multi-tile", "sq<skv", "d80", "d96", "d256"])
def test_plain_matches_pallas_interpret(causal, s_q, s_kv, bq, bkv, d):
    """rtol/atol 2e-5, the tolerance of tests/unit/test_flash_attention.py."""
    q, k, v = _qkv(1, s_q, s_kv, 2, d, seed=7)
    ref = np.asarray(pallas_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                            causal=causal, block_q=bq, block_kv=bkv,
                                            interpret=True))
    got = flash_attention_reference(torch.as_tensor(q), torch.as_tensor(k),
                                    torch.as_tensor(v), causal=causal).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_causal_sq_greater_than_skv_raises_like_pallas():
    q, k, v = _qkv(1, 128, 64, 2, 32, seed=1)
    with pytest.raises(ValueError, match="s_q <= s_kv"):
        pallas_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                               block_q=32, block_kv=32, interpret=True)
    with pytest.raises(ValueError, match="s_q <= s_kv"):
        flash_attention_reference(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                  causal=True)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_gqa_and_ragged_match_jax_chunked(causal):
    """Unrepeated GQA heads and a length no tile divides, against the JAX
    plain flash math on repeated heads: 2e-5."""
    q, k, v = _qkv(2, 40, 72, 4, 8, seed=3, kvh=2)
    rep = lambda a: np.repeat(a, 2, axis=2)
    ref = np.asarray(jax_chunked(jnp.asarray(q), jnp.asarray(rep(k)), jnp.asarray(rep(v)),
                                 causal=causal, block_size=16))
    got = flash_attention_reference(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                    causal=causal, block_size=16).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper and the dispatch compute the plain version and
    never count a kernel launch; bf16 in, bf16 out."""
    q, k, v = (torch.as_tensor(a).to(torch.bfloat16) for a in _qkv(1, 48, 48, 2, 64, seed=5))
    before = LAUNCH_COUNTS["flash_attention_fwd"]
    a = flash_attention_fwd(q, k, v, causal=True)
    b = flash_attention(q, k, v, causal=True, block_size=16)
    assert LAUNCH_COUNTS["flash_attention_fwd"] == before
    assert a.dtype == torch.bfloat16
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(a, flash_attention_reference(q, k, v, causal=True), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16], ids=["bf16", "fp16"])
def test_rounding_bound_covers_the_kernels_rounding(dtype):
    """A model of the kernel's 16-bit arithmetic (64-key tiles, P rounded to
    the input type before P.V, the output rounded) stays within
    ``rounding_bound`` of the plain version; past the first tile the bound
    falls below 1% of the largest output."""
    q, k, v = (torch.as_tensor(a).to(dtype) for a in _qkv(1, 200, 200, 2, 64, seed=0))
    ref = flash_attention_reference(q, k, v, causal=True)
    qf, kf, vf = (t.float().transpose(1, 2) for t in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) / 8.0
    allowed = torch.arange(200)[None, :] <= torch.arange(200)[:, None]
    m = torch.full((1, 2, 200), -1e30)
    l = torch.zeros(1, 2, 200)
    acc = torch.zeros(1, 2, 200, 64)
    for t0 in range(0, 200, 64):
        st = s[..., t0:t0 + 64].masked_fill(~allowed[:, t0:t0 + 64], float("-inf"))
        m_new = torch.maximum(m, st.amax(-1))
        p = torch.exp(st - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p.to(dtype).float(),
                                                   vf[:, :, t0:t0 + 64])
        m = m_new
    out = (acc / l[..., None]).transpose(1, 2).to(dtype)
    limit = 1e-5 + rounding_bound(q, k, v, ref, causal=True)
    assert ((out.float() - ref.float()).abs() <= limit).all()
    late = ref.float()[:, 64:]
    assert (limit[:, 64:] < 0.01 * late.abs().max()).any()
    assert rounding_bound(q.float(), k.float(), v.float(), ref.float()) is None


def _registry_head_dims():
    """{(family, size): head_dim} of every preset the port's registry builds:
    each family's sizes are the keys of its ``presets`` table, read from the
    registry's source; presets whose features are not ported raise and are
    left out."""
    dims = {}
    for family, make in MODEL_CONFIGS.items():
        tree = ast.parse(inspect.getsource(make))
        sizes = [key.value for node in ast.walk(tree) if isinstance(node, ast.Assign)
                 and getattr(node.targets[0], "id", None) == "presets" for key in node.value.keys]
        assert sizes, family
        for size in sizes:
            try:
                cfg = make(size)
            except NotImplementedError:
                continue
            dims[(family, size)] = cfg.head_dim
    return dims


def test_every_preset_head_dim_is_a_kernel_width():
    """The flash kernels (forward and backward) and the block-sparse kernels
    take the head_dim of every preset the registry builds (the sets are the
    wrappers' own gates): the card serves and trains every one."""
    dims = _registry_head_dims()
    assert {("opt", "2.7b"), ("gpt_neox", "20b"), ("gptj", "6b"), ("llama", "tiny")} <= set(dims)
    for name, gate in (("flash", cuda_flash._KERNEL_HEAD_DIMS),
                       ("block-sparse", cuda_bsa._KERNEL_HEAD_DIMS)):
        missing = {k: d for k, d in dims.items() if d not in gate}
        assert not missing, f"{name} kernels refuse {missing}"
        assert all(d % 16 == 0 for d in gate)  # wmma's fragment depth


def test_attention_route_is_fixed_by_dtype_and_head_dim():
    """bf16 and fp16 at head_dim 64 and 128 (Llama-7B's and GPT-2 medium's
    widths) take the TMA + wgmma kernels; fp32 and the other widths the
    wmma kernels; what no kernel takes has no route."""
    route = cuda_flash.attention_route
    for dtype in (torch.bfloat16, torch.float16):
        assert route(dtype, 64) == route(dtype, 128) == "wgmma"
        for d in (32, 80, 96, 256):
            assert route(dtype, d) == "wmma"
    for d in cuda_flash._KERNEL_HEAD_DIMS:
        assert route(torch.float32, d) == "wmma"
    assert route(torch.bfloat16, 48) is None
    assert route(torch.float64, 64) is None


def test_every_preset_head_dim_has_a_route():
    """Every preset of the registry maps to a route in each kernel dtype,
    and the main paths' models (Llama-7B bf16, GPT-2 medium bf16) to wgmma."""
    dims = _registry_head_dims()
    for dtype in (torch.bfloat16, torch.float16, torch.float32):
        missing = {k: d for k, d in dims.items() if cuda_flash.attention_route(dtype, d) is None}
        assert not missing, f"{dtype}: no route for {missing}"
    assert cuda_flash.attention_route(torch.bfloat16, dims[("llama", "7b")]) == "wgmma"
    assert cuda_flash.attention_route(torch.bfloat16, dims[("gpt2", "medium")]) == "wgmma"


def test_forced_route_the_shape_cannot_take_raises():
    """``_route`` forces a route (for timing one against the other); one
    that cannot take the dtype and head_dim raises, on CPU tensors too,
    and the route it can take still gives the plain version."""
    q, k, v = (torch.tensor(x) for x in _qkv(1, 16, 16, 2, 32, 0))
    for route in ("wgmma", "tiled"):
        with pytest.raises(ValueError, match="route"):
            flash_attention_fwd(q, k, v, _route=route)
    with pytest.raises(ValueError, match="route"):
        flash_attention_fwd(q[..., :24], k[..., :24], v[..., :24], _route="wmma")
    q16, k16, v16 = (t.to(torch.bfloat16) for t in (q, k, v))
    with pytest.raises(ValueError, match="route"):
        flash_attention_fwd(q16, k16, v16, _route="wgmma")
    torch.testing.assert_close(flash_attention_fwd(q, k, v, _route="wmma"),
                               flash_attention_reference(q, k, v), rtol=0, atol=0)


def test_builder_signature_sees_the_included_headers(tmp_path):
    """A kernel library's cache key hashes the ``csrc`` headers its sources
    include (through other headers too), so an edit to a shared header
    builds anew instead of loading a stale library; no nvcc needed."""
    import shutil

    from deepspeed_tpu_torch.ops.op_builder import ALL_OPS

    csrc = tmp_path / "csrc"
    shutil.copytree(ALL_OPS["flash_attention_fwd"]().csrc_dir, csrc)
    builders = {}
    hopper = ("flash_attention_fwd", "flash_attention_bwd", "quantized_matmul",
              "fused_ce_forward", "block_sparse_attention")
    for name in hopper + ("paged_flash_decode",):
        builders[name] = ALL_OPS[name]()
        builders[name].csrc_dir = str(csrc)
    shared = csrc / "sm90_utils.cuh"
    for name in hopper:
        assert str(shared) in builders[name].headers(), name
    # the backward kernels both flash routes' libraries share, and through it sm90_utils
    for name in ("flash_attention_bwd", "block_sparse_attention"):
        assert str(csrc / "flash_bwd_sm90.cuh") in builders[name].headers(), name
    before = {name: b._signature() for name, b in builders.items()}
    shared.write_text(shared.read_text() + "\n// an edit\n")
    after = {name: b._signature() for name, b in builders.items()}
    for name in hopper:
        assert after[name] != before[name], name
    assert after["paged_flash_decode"] == before["paged_flash_decode"]
    bwd = csrc / "flash_bwd_sm90.cuh"
    bwd.write_text(bwd.read_text() + "\n// an edit\n")
    again = {name: b._signature() for name, b in builders.items()}
    for name in hopper:
        assert (again[name] != after[name]) == (name in ("flash_attention_bwd",
                                                         "block_sparse_attention")), name
    # a header that a header includes counts too
    (csrc / "inner.cuh").write_text("// v1\n")
    shared.write_text('#include "inner.cuh"\n' + shared.read_text())
    b = builders["flash_attention_fwd"]
    assert str(csrc / "inner.cuh") in b.headers()
    sig = b._signature()
    (csrc / "inner.cuh").write_text("// v2\n")
    assert b._signature() != sig
