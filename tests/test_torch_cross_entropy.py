"""The port's fused cross-entropy against the JAX package: the plain CE
forward against the TPU kernel (``pallas_ce_forward`` in interpret mode),
and ``fused_cross_entropy``'s loss and gradients against JAX's custom vjp
for ``impl`` xla and pallas."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.cross_entropy import fused_cross_entropy as jax_fused_ce
from deepspeed_tpu.ops.pallas.cross_entropy import pallas_ce_forward
from deepspeed_tpu_torch.ops.cross_entropy import _chunking, fused_cross_entropy
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda.cross_entropy import (accumulation_bound, fused_ce_forward,
                                                        fused_ce_forward_reference)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _inputs(tokens, d, vocab, seed, bias=False):
    r = np.random.RandomState(seed)
    x = r.randn(tokens, d).astype(np.float32)
    emb = (0.5 * r.randn(vocab, d)).astype(np.float32)
    labels = r.randint(0, vocab, tokens).astype(np.int32)
    b = r.randn(vocab).astype(np.float32) if bias else None
    return x, emb, labels, b


@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
@pytest.mark.parametrize("vocab,block_v", [(256, 64), (257, 64)], ids=["whole-tiles", "padded"])
def test_plain_forward_matches_pallas_interpret(vocab, block_v, bias):
    """(lse, label logit) in fp32 on both sides: rtol/atol 1e-5."""
    x, emb, labels, b = _inputs(32, 16, vocab, seed=1, bias=bias)
    ref = pallas_ce_forward(jnp.asarray(x), jnp.asarray(emb), jnp.asarray(labels),
                            None if b is None else jnp.asarray(b), block_t=16,
                            block_v=block_v, interpret=True)
    got = fused_ce_forward_reference(torch.as_tensor(x), torch.as_tensor(emb),
                                     torch.as_tensor(labels),
                                     None if b is None else torch.as_tensor(b), block_v=48)
    for name, g, r in zip(("lse", "label_logit"), got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5, err_msg=name)


def test_cpu_wrapper_takes_the_plain_version():
    x, emb, labels, _ = (torch.as_tensor(a) if a is not None else None
                         for a in _inputs(8, 16, 40, seed=2))
    before = dict(LAUNCH_COUNTS)
    got = fused_ce_forward(x.to(torch.bfloat16), emb, labels)
    assert LAUNCH_COUNTS == before
    ref = fused_ce_forward_reference(x.to(torch.bfloat16), emb.to(torch.bfloat16), labels)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert (accumulation_bound(x, emb, ref[0]) > 0).all()


@pytest.mark.parametrize("vocab,n_chunks", [(257, 8), (50257, 8), (64, 3)])
def test_chunking_is_uniform_and_padded(vocab, n_chunks):
    from deepspeed_tpu.ops.cross_entropy import _chunking as jax_chunking

    assert _chunking(vocab, n_chunks) == jax_chunking(vocab, n_chunks)
    nc, chunk, padded = _chunking(vocab, n_chunks)
    assert nc == min(n_chunks, vocab) and padded >= vocab and padded - vocab < nc


def _jax_ce(x, emb, labels, b, ignore_index, n_chunks, impl):
    """loss and grads (dx, dE[, dbias]) of the JAX fused CE."""
    args = [jnp.asarray(x), jnp.asarray(emb)]
    argnums = (0, 1)
    if b is not None:
        args.append(jnp.asarray(b))
        argnums = (0, 1, 2)

    def f(*a):
        bias = a[2] if len(a) > 2 else None
        return jax_fused_ce(a[0], a[1], jnp.asarray(labels), bias, ignore_index, n_chunks, impl,
                            impl == "pallas")

    loss, grads = jax.value_and_grad(f, argnums=argnums)(*args)
    return float(loss), [np.asarray(g, dtype=np.float32) for g in grads]


def _port_ce(x, emb, labels, b, ignore_index, n_chunks, impl, x_dtype=torch.float32):
    xt = torch.as_tensor(x).to(x_dtype).requires_grad_()
    et = torch.as_tensor(emb).requires_grad_()
    bt = None if b is None else torch.as_tensor(b).requires_grad_()
    loss = fused_cross_entropy(xt, et, torch.as_tensor(labels).long(), bt, ignore_index,
                               n_chunks, impl)
    loss.backward()
    grads = [xt.grad, et.grad] + ([bt.grad] if bt is not None else [])
    return loss.detach(), grads


CASES = {
    "plain": dict(vocab=64, n_ignore=0, bias=False),
    "ignore": dict(vocab=64, n_ignore=9, bias=False),
    "all-ignored": dict(vocab=64, n_ignore=24, bias=False),
    "prime-vocab": dict(vocab=257, n_ignore=3, bias=False),
    "bias": dict(vocab=61, n_ignore=2, bias=True),
}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_ce_loss_and_grads_match_jax(case, impl):
    """fp32: loss rtol 1e-6, grads rtol 1e-5 / atol 1e-7 (sums in other
    orders). A prime vocab runs padded uniform chunks on both sides."""
    c = CASES[case]
    x, emb, labels, b = _inputs(24, 16, c["vocab"], seed=4, bias=c["bias"])
    labels[:c["n_ignore"]] = -100
    ref_loss, ref_grads = _jax_ce(x, emb, labels, b, -100, 8, impl)
    loss, grads = _port_ce(x, emb, labels, b, -100, 8, impl)
    assert loss.dtype == torch.float32
    np.testing.assert_allclose(float(loss), ref_loss, rtol=1e-6, atol=1e-7)
    if c["n_ignore"] == 24:
        assert float(loss) == 0.0
    for name, g, r in zip(("dx", "demb", "dbias"), grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_bf16_x_with_fp32_master_emb(impl):
    """bf16 activations, fp32 master embedding (the tied head in training):
    the products run in the compute dtype with fp32 sums on both sides.
    dx comes back in bf16 (within one bf16 rounding of JAX's, rtol 1e-2),
    dE in fp32 (rtol 1e-3, atol 1e-6: each chunk's dlogits are rounded to
    bf16 on both sides, from fp32 values that differ in summation order)."""
    x, emb, labels, _ = _inputs(32, 16, 257, seed=6)
    labels[:4] = -100
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    f = lambda xx, ee: jax_fused_ce(xx, ee, jnp.asarray(labels), None, -100, 8, impl,
                                    impl == "pallas")
    ref_loss, (rdx, rde) = jax.value_and_grad(f, argnums=(0, 1))(xj, jnp.asarray(emb))
    loss, (dx, de) = _port_ce(x, emb, labels, None, -100, 8, impl, x_dtype=torch.bfloat16)
    assert dx.dtype == torch.bfloat16 and de.dtype == torch.float32
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(dx.float().numpy(), np.asarray(rdx, dtype=np.float32),
                               rtol=1e-2, atol=1e-5)
    np.testing.assert_allclose(de.numpy(), np.asarray(rde), rtol=1e-3, atol=1e-6)


def test_unknown_impl_raises():
    x, emb, labels, _ = _inputs(4, 8, 16, seed=0)
    with pytest.raises(ValueError, match="impl"):
        fused_cross_entropy(torch.as_tensor(x), torch.as_tensor(emb),
                            torch.as_tensor(labels).long(), impl="triton")
