"""The port's quantizers (``ops/quantizer.py``, ``comm/collectives.py``)
against the JAX package's, on the CPU: every quantizer and its inverse is
BITWISE equal, on inputs that land exactly on .5 steps (round half to even
on both sides) and on all-zero groups (a zero scale divides by 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.comm import collectives as jcoll
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu_torch.comm import collectives as tcoll
from deepspeed_tpu_torch.ops import quantizer as tq

# The JAX references run op by op, as the JAX engine calls them: under jit
# XLA may turn the divide by qmax into a multiply by its reciprocal, which
# is not bitwise the same function.


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _weights(bits, lead=(), in_dim=32, out=24, seed=0):
    """[..., in, out] fp32 with, in column 0, a group whose absmax makes the
    scale exactly 1 and whose values sit on .5 steps; column 1 all zeros."""
    rng = np.random.RandomState(seed)
    w = rng.randn(*lead, in_dim, out).astype(np.float32)
    qmax = 2 ** (bits - 1) - 1
    steps = np.arange(qmax) + 0.5                         # 0.5, 1.5, .. qmax - 0.5
    halves = np.concatenate([[qmax], np.resize(np.stack([steps, -steps], 1).reshape(-1),
                                               in_dim - 1)]).astype(np.float32)
    w[..., :, 0] = halves
    w[..., :, 1] = 0.0
    return w


def _eq(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group_size", [0, 8, 32, 12],
                         ids=["per-channel", "g8", "g-whole", "g-not-dividing"])
def test_quantize_per_channel_bitwise(bits, group_size):
    w = _weights(bits, (3,))                              # stacked [L, in, out]
    jqv, js = jq.quantize_per_channel(jnp.asarray(w), bits=bits, group_size=group_size)
    tqv, ts = tq.quantize_per_channel(torch.tensor(w), bits=bits, group_size=group_size)
    _eq(tqv, jqv)
    _eq(ts, js)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tq.dequantize_per_channel(tqv, ts, dtype).float()
        _eq(got, jq.dequantize_per_channel(jqv, js, jdt).astype(jnp.float32))


def test_half_steps_round_to_even():
    w = _weights(8)
    q, scale = tq.quantize_per_channel(torch.tensor(w), bits=8)
    assert float(scale[0, 0, 0]) == 1.0
    # 0.5 -> 0, 1.5 -> 2, -0.5 -> 0, -1.5 -> -2: half to even, as jnp.round
    col = w[:, 0]
    for v in (0.5, 1.5, -0.5, -1.5):
        (i,) = np.nonzero(col == v)[0][:1]
        assert int(q[i, 0]) == int(np.round(v))
    assert bool((q[:, 1] == 0).all()) and float(scale[0, 0, 1]) == 0.0


def test_pack_unpack_int4_bitwise():
    w = _weights(4, (2, 3))
    jqv, _ = jq.quantize_per_channel(jnp.asarray(w), bits=4, group_size=8)
    tqv, _ = tq.quantize_per_channel(torch.tensor(w), bits=4, group_size=8)
    jp, tp = jq.pack_int4(jqv), tq.pack_int4(tqv)
    _eq(tp, jp)
    assert tp.shape[-2] == w.shape[-2] // 2
    _eq(tq.unpack_int4(tp), jq.unpack_int4(jp))
    _eq(tq.unpack_int4(tp), jqv)
    with pytest.raises(ValueError, match="even in-dim"):
        tq.pack_int4(tqv[..., :-1, :])


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("group_size", [64, 7, 0], ids=["g64", "g-not-dividing", "g0"])
def test_quantize_dequantize_and_error_bitwise(bits, group_size):
    w = _weights(bits, (2,))
    jqv, js, jmeta = jq.quantize(jnp.asarray(w), bits=bits, group_size=group_size)
    tqv, ts, tmeta = tq.quantize(torch.tensor(w), bits=bits, group_size=group_size)
    _eq(tqv, jqv)
    _eq(ts, js)
    assert tmeta == {**jmeta, "shape": tuple(jmeta["shape"])}
    _eq(tq.dequantize(tqv, ts, tmeta), jq.dequantize(jqv, js, jmeta))
    # a mean of squares: the same terms, summed in another order
    np.testing.assert_allclose(
        float(tq.quantization_error(torch.tensor(w), bits=bits, group_size=group_size)),
        float(jq.quantization_error(jnp.asarray(w), bits=bits, group_size=group_size)),
        rtol=1e-5)


def test_fake_quantize_forward_and_straight_through_grad():
    w = _weights(8, (2,))
    jw = jnp.asarray(w)
    _eq(tq.fake_quantize(torch.tensor(w)), jq.fake_quantize(jw))
    x = torch.tensor(w, requires_grad=True)
    g = torch.tensor(np.random.RandomState(1).randn(*w.shape).astype(np.float32))
    (tq.fake_quantize(x) * g).sum().backward()
    jg = jax.grad(lambda a: (jq.fake_quantize(a) * jnp.asarray(g.numpy())).sum())(jw)
    _eq(x.grad, jg)


@pytest.mark.parametrize("block", [16, 64, 10], ids=["b16", "b-whole-row", "b-not-dividing"])
def test_quantize_blockwise_bitwise(block):
    """The int8 KV pool's quantizer: [..., n] rows, one scale per block."""
    rng = np.random.RandomState(3)
    x = rng.randn(2, 5, 3, 64).astype(np.float32)
    x[0, 0, 0] = 0.0                                      # an all-zero block
    x[1, 0, 0, :16] = np.arange(16) - 7.5                 # .5 steps...
    x[1, 0, 0, 0] = 127.0                                 # ...at scale exactly 1
    jqv, js = jcoll.quantize_blockwise(jnp.asarray(x), block=block)
    tqv, ts = tcoll.quantize_blockwise(torch.tensor(x), block=block)
    _eq(tqv, jqv)
    _eq(ts, js)
    for dtype, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        got = tcoll.dequantize_blockwise(tqv, ts, dtype).float()
        _eq(got, jcoll.dequantize_blockwise(jqv, js, jdt).astype(jnp.float32))
    assert tcoll._effective_block(64, block) == jcoll._effective_block(64, block)
