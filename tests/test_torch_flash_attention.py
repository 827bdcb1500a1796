"""The plain version of the port's flash-attention kernel against the TPU
kernel (``pallas_flash_attention`` in interpret mode, as the JAX package's
own tests run it on the CPU), and the port's dispatch on CPU tensors."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.flash_attention import _chunked_attention as jax_chunked
from deepspeed_tpu.ops.pallas.flash_attention import pallas_flash_attention
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
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
# smaller block_kv the kv-tile loop (_fwd_kernel).
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("s_q,s_kv,bq,bkv", [
    (128, 128, 64, 128),   # single kv tile
    (128, 128, 32, 32),    # multi kv tile
    (64, 128, 32, 64),     # s_q < s_kv (causal aligned to the kv end)
], ids=["single-tile", "multi-tile", "sq<skv"])
def test_plain_matches_pallas_interpret(causal, s_q, s_kv, bq, bkv):
    """rtol/atol 2e-5, the tolerance of tests/unit/test_flash_attention.py."""
    q, k, v = _qkv(1, s_q, s_kv, 2, 32, seed=7)
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
