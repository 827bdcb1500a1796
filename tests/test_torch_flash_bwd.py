"""The plain version of the port's flash backward (and the forward's lse)
against the TPU kernels (``pallas_flash_attention`` in interpret mode, as
the JAX package's own tests run it on the CPU), and the autograd dispatch
on CPU tensors."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.pallas.flash_attention import _flash_fwd, pallas_flash_attention
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda.flash_attention import (bwd_rounding_bound,
                                                          flash_attention_bwd,
                                                          flash_attention_bwd_reference,
                                                          flash_attention_reference)
from deepspeed_tpu_torch.ops.flash_attention import flash_attention

# fp32 on both sides; the sums run in other orders: rtol/atol 5e-5 (the
# grads are O(1); observed differences are O(1e-6))
TOL = dict(rtol=5e-5, atol=5e-5)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(b, s_q, s_kv, h, kvh, d, seed):
    r = np.random.RandomState(seed)
    return (r.randn(b, s_q, h, d).astype(np.float32), r.randn(b, s_kv, kvh, d).astype(np.float32),
            r.randn(b, s_kv, kvh, d).astype(np.float32), r.randn(b, s_q, h, d).astype(np.float32))


def _jax_grads(q, k, v, do, causal, bq, bkv):
    """(out, dq, dk, dv) of the TPU kernels in interpret mode; the backward
    tiles are (bq, bkv) too."""
    f = lambda q_, k_, v_: pallas_flash_attention(q_, k_, v_, causal, None, bq, bkv, True,
                                                  bq, bkv)
    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return (np.asarray(out), *(np.asarray(g) for g in vjp(jnp.asarray(do))))


def _port_grads(q, k, v, do, causal, block_size=512):
    t = [torch.as_tensor(a) for a in (q, k, v, do)]
    o, lse = flash_attention_reference(*t[:3], causal=causal, block_size=block_size,
                                       return_lse=True)
    return (o, *flash_attention_bwd_reference(*t[:3], o, lse, t[3], causal=causal,
                                              block_size=block_size))


# (bq, bkv) = (64, s_kv) runs the single-tile TPU kernels (_dq_kernel_single,
# _dkv_kernel_single with one q block when bq = s_q); smaller tiles the
# tile loops (_dq_kernel, _dkv_kernel).
# head_dim 32 throughout, and the registry's widths no other case has (80,
# 96, 256) over q and kv tiles
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s_q,s_kv,bq,bkv,d", [
    (128, 128, 128, 128, 32),  # single q and kv tile
    (128, 128, 32, 32, 32),    # several q and kv tiles
    (64, 128, 32, 64, 32),     # s_q < s_kv (causal aligned to the kv end)
    (128, 128, 64, 64, 80),
    (128, 128, 64, 64, 96),
    (128, 128, 64, 64, 256),
], ids=["single-tile", "multi-tile", "sq<skv", "d80", "d96", "d256"])
def test_plain_bwd_matches_pallas_interpret(causal, s_q, s_kv, bq, bkv, d):
    q, k, v, do = _inputs(1, s_q, s_kv, 2, 2, d, seed=11)
    ref = _jax_grads(q, k, v, do, causal, bq, bkv)
    got = _port_grads(q, k, v, do, causal, block_size=32)
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_bwd_gqa_matches_pallas_on_repeated_kv(causal):
    """The port returns dk/dv with the kv heads; JAX repeats kv before the
    kernel, and the repeat's transpose sums the query heads' grads."""
    q, k, v, do = _inputs(2, 64, 64, 4, 2, 32, seed=5)
    rep = lambda a: np.repeat(a, 2, axis=2)
    out, dq, dk, dv = _jax_grads(q, rep(k), rep(v), do, causal, 32, 32)
    fold = lambda g: g.reshape(2, 64, 2, 2, 32).sum(3)
    got = _port_grads(q, k, v, do, causal, block_size=16)
    for name, g, r in zip(("out", "dq", "dk", "dv"), got, (out, dq, fold(dk), fold(dv))):
        np.testing.assert_allclose(g.numpy(), r, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_plain_lse_matches_pallas_forward_lse(causal):
    """The forward's lse (the residual the TPU forward emits under its vjp,
    lane-broadcast there; [b, h, s_q] here): 2e-5."""
    q, k, v, _ = _inputs(2, 64, 128, 2, 2, 32, seed=3)
    _, lse = _flash_fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal, None, 32, 64,
                        True, need_lse=True)
    _, got = flash_attention_reference(torch.as_tensor(q), torch.as_tensor(k),
                                       torch.as_tensor(v), causal=causal, return_lse=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(lse).reshape(2, 2, 64),
                               rtol=2e-5, atol=2e-5)


def test_autograd_dispatch_on_cpu_is_the_plain_backward():
    """With grad on, ``flash_attention`` saves the forward's lse and its
    backward is the plain backward on CPU tensors: the same grads as
    autograd through dense attention (1e-5), and no kernel launch counted."""
    q, k, v, do = (torch.as_tensor(a) for a in _inputs(1, 40, 72, 4, 2, 16, seed=9))
    q, k, v = (t.clone().requires_grad_() for t in (q, k, v))
    before = dict(LAUNCH_COUNTS)
    flash_attention(q, k, v, causal=True, block_size=16).backward(do)
    assert LAUNCH_COUNTS == before
    q2, k2, v2 = (t.detach().clone().requires_grad_() for t in (q, k, v))
    kr, vr = (t.repeat_interleave(2, dim=2) for t in (k2, v2))
    s = torch.einsum("bqhd,bkhd->bhqk", q2, kr) / math.sqrt(16)
    mask = torch.arange(72)[None, :] <= torch.arange(40)[:, None] + 32
    out = torch.einsum("bhqk,bkhd->bqhd", s.masked_fill(~mask, float("-inf")).softmax(-1), vr)
    out.backward(do)
    for name, a, b in (("dq", q.grad, q2.grad), ("dk", k.grad, k2.grad), ("dv", v.grad, v2.grad)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5, msg=name)


def test_bwd_wrapper_needs_the_forward_lse():
    q, k, v, do = (torch.as_tensor(a) for a in _inputs(1, 8, 8, 2, 2, 16, seed=0))
    o = flash_attention_reference(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        flash_attention_bwd(q, k, v, o, None, do)
    with pytest.raises(ValueError, match="s_q <= s_kv"):
        flash_attention_bwd(q, k[:, :4], v[:, :4], o, torch.zeros(1, 2, 8), do)


def test_bwd_rounding_bound_covers_a_model_of_the_kernels_rounding():
    """P and dS rounded to bf16 before the products (as the kernel rounds
    them), fp32 sums, outputs rounded: within 1e-5 + ``bwd_rounding_bound``
    of the plain version; fp32 inputs have no bound."""
    q, k, v, do = (torch.as_tensor(a).to(torch.bfloat16) for a in _inputs(1, 96, 96, 2, 2, 64, 4))
    o, lse = flash_attention_reference(q, k, v, causal=True, return_lse=True)
    refs = flash_attention_bwd_reference(q, k, v, o, lse, do, causal=True)
    f = lambda t: t.float().transpose(1, 2)
    qf, kf, vf, dof = f(q), f(k), f(v), f(do)
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kf) / 8.0 - lse[..., None])
    p = p.masked_fill(~(torch.arange(96)[None, :] <= torch.arange(96)[:, None]), 0.0)
    delta = (o.float() * do.float()).sum(-1).transpose(1, 2)
    ds = p * (torch.einsum("bhqd,bhkd->bhqk", dof, vf) - delta[..., None]) / 8.0
    p16, ds16 = p.to(torch.bfloat16).float(), ds.to(torch.bfloat16).float()
    model = (torch.einsum("bhqk,bhkd->bhqd", ds16, kf), torch.einsum("bhqk,bhqd->bhkd", ds16, qf),
             torch.einsum("bhqk,bhqd->bhkd", p16, dof))
    bounds = bwd_rounding_bound(q, k, v, o, lse, do, refs, causal=True)
    for name, m, r, bd in zip(("dq", "dk", "dv"), model, refs, bounds):
        got = m.transpose(1, 2).to(torch.bfloat16).float()
        assert ((got - r.float()).abs() <= 1e-5 + bd).all(), name
    assert bwd_rounding_bound(q.float(), k.float(), v.float(), o.float(), lse, do.float(),
                              refs) is None


def test_bwd_forced_route_the_shape_cannot_take_raises():
    """``_route`` on the backward: ``wgmma`` raises for fp32 and for a
    16-bit head_dim outside 64/128, an unknown name raises, and ``wmma``
    (which takes every kernel shape) gives the plain backward on CPU."""
    q, k, v, do = (torch.as_tensor(a) for a in _inputs(1, 16, 16, 2, 2, 32, seed=2))
    o, lse = flash_attention_reference(q, k, v, causal=True, return_lse=True)
    args = (q, k, v, o, lse, do)
    for route in ("wgmma", "fast"):
        with pytest.raises(ValueError, match="route"):
            flash_attention_bwd(*args, _route=route)
    with pytest.raises(ValueError, match="route"):
        flash_attention_bwd(*(t.to(torch.bfloat16) if t is not lse else t for t in args),
                            _route="wgmma")
    for got, want in zip(flash_attention_bwd(*args, _route="wmma"),
                         flash_attention_bwd_reference(*args)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
