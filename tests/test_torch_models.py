"""The port's model forward, cached decoding and weight converter against
the JAX package, on tiny fp32 models on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu.models import layers as jL
from deepspeed_tpu_torch.interop import from_jax, to_jax
from deepspeed_tpu_torch.models import decoding as tdec
from deepspeed_tpu_torch.models import layers as tL
from deepspeed_tpu_torch.models.layers import flatten_tree
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from tests.torch_port_util import VARIANTS, jax_model, jax_values, pair, port_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _ids(seed, shape, vocab=64):
    return np.random.RandomState(seed).randint(0, vocab, shape).astype(np.int32)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_logits_match_jax_apply(name):
    """Training-style forward: rtol 2e-4 / atol 2e-5 (the JAX package's own
    prefill-vs-forward tolerance; fp32 matmuls summed in another order)."""
    jm, values, pm = pair(VARIANTS[name], seed=0)
    ids = _ids(0, (2, 12))
    ref = np.asarray(jm.apply(values, jnp.asarray(ids)))
    with torch.no_grad():
        got = pm(torch.as_tensor(ids, dtype=torch.int64)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("prefill_flash", [True, False], ids=["flash", "dense"])
@pytest.mark.parametrize("name", list(VARIANTS))
def test_prefill_and_decode_match_jax_cache(name, prefill_flash):
    """Prefill 8 tokens, then 4 single-token decode steps, against JAX
    forward_with_cache on the same params: 5e-4 / 5e-5 (the JAX package's
    decode-vs-forward tolerance). prefill_flash=True sends the port's
    prefill through the flash kernel's plain version on the CPU (JAX: its
    chunked flash); alibi stays on the dense path in both."""
    kw = dict(VARIANTS[name], prefill_flash=prefill_flash)
    jm, values, pm = pair(kw, seed=1)
    full = _ids(1, (2, 12))
    max_len = 16
    # one compiled program per phase, as the JAX engine runs it (pos traced)
    jfwd = jax.jit(lambda v, ids, cache, pos, prefill=False: jdec.forward_with_cache(
        jm, v, ids, cache, pos, max_len, prefill=prefill), static_argnames=("prefill",))
    jcache = jdec.init_cache(jm.config, 2, max_len)
    jlog, jcache = jfwd(values, jnp.asarray(full[:, :8]), jcache, 0, prefill=True)
    tcache = tdec.init_cache(pm.config, 2, max_len)
    before = LAUNCH_COUNTS["flash_attention_fwd"]
    with torch.no_grad():
        tlog = tdec.forward_with_cache(pm, pm.params, torch.as_tensor(full[:, :8]).long(),
                                       tcache, 0, max_len, prefill=True)
    assert LAUNCH_COUNTS["flash_attention_fwd"] == before  # CPU: never the kernel
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=5e-4, atol=5e-5)
    for s in ("k", "v"):
        np.testing.assert_allclose(tcache[s].numpy(), np.asarray(jcache[s]), rtol=5e-4,
                                   atol=5e-5)
    for i in range(4):
        tok = full[:, 8 + i:9 + i]
        jlog, jcache = jfwd(values, jnp.asarray(tok), jcache, 8 + i)
        with torch.no_grad():
            tlog = tdec.forward_with_cache(pm, pm.params, torch.as_tensor(tok).long(),
                                           tcache, 8 + i, max_len)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), rtol=5e-4, atol=5e-5)


def test_converter_round_trip_uses_every_key():
    """JAX params -> port -> numpy: every key used, every value exact."""
    jm, values, pm = pair(VARIANTS["gptj-partial"], seed=2)
    flat_j = flatten_tree(values)
    flat_p = flatten_tree(to_jax(pm.params))
    assert set(flat_j) == set(flat_p) == set(pm.param_shapes())
    for k in flat_j:
        np.testing.assert_array_equal(flat_p[k], flat_j[k])
    assert {k.replace(".", "/") for k in pm.state_dict()} == set(flat_j)
    # stacked block leaves keep the leading layer axis; kernels stay [in, out]
    assert flat_p["blocks/attn/q/kernel"].shape == (2, 16, 16)
    assert flat_p["blocks/mlp/fc/kernel"].shape == (2, 16, 32)


def test_converter_refuses_mismatched_params():
    _, values, pm = pair(VARIANTS["gpt2ish"], seed=3)
    missing = dict(values)
    del missing["ln_f"]
    with pytest.raises(ValueError, match="missing"):
        from_jax(missing, pm)
    extra = dict(values, lm_head={"kernel": np.zeros((16, 64), np.float32)})
    with pytest.raises(ValueError, match="unexpected"):
        from_jax(extra, pm)
    bad = jax_values(pair(dict(d_ff=48))[0], 0)
    with pytest.raises(ValueError, match="blocks/mlp/fc/(kernel|bias): JAX shape"):
        from_jax(bad, pm)


def test_random_init_matches_jax_distributions():
    """Same tree, shapes and dtypes as JAX init; the same distributions
    (normal with the configured std, residual projections scaled by
    1/sqrt(2L), norms at one/zero), though not the same draws."""
    kw = dict(n_layers=4, d_model=64, n_heads=4, d_ff=256, vocab_size=512)
    jv = jax_values(jax_model(**kw), 0)
    pm = port_model(**kw)
    params = pm.init(torch.Generator().manual_seed(0))
    flat_j, flat_t = flatten_tree(jv), flatten_tree(params)
    assert {k: v.shape for k, v in flat_j.items()} == {k: tuple(v.shape) for k, v in flat_t.items()}
    for k in flat_j:
        np.testing.assert_allclose(flat_t[k].std().item(), np.std(flat_j[k]), rtol=0.15,
                                   atol=1e-7, err_msg=k)


@pytest.mark.parametrize("interleaved", [False, True])
def test_layers_match_jax(interleaved):
    """Norms (fp32 inside, eps from the caller), tanh gelu, partial rotary."""
    r = np.random.RandomState(4)
    x = r.randn(2, 5, 3, 8).astype(np.float32)
    pos = np.arange(5)[None].repeat(2, 0)
    jc, js = jL.rotary_embedding(jnp.asarray(pos), 4)
    tc, ts = tL.rotary_embedding(torch.as_tensor(pos), 4)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        tL.apply_rotary(torch.as_tensor(x), tc, ts, 4, interleaved).numpy(),
        np.asarray(jL.apply_rotary(jnp.asarray(x), jc, js, 4, interleaved)),
        rtol=1e-6, atol=1e-6)
    for name in ("gelu", "gelu_exact", "gelu_new", "quick_gelu", "relu", "silu"):
        np.testing.assert_allclose(tL.ACTIVATIONS[name](torch.as_tensor(x)).numpy(),
                                   np.asarray(jL.ACTIVATIONS[name](jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    p = {"scale": r.randn(8).astype(np.float32), "bias": r.randn(8).astype(np.float32)}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    np.testing.assert_allclose(tL.layernorm_apply(tp, torch.as_tensor(x), eps=1e-3).numpy(),
                               np.asarray(jL.layernorm_apply(p, jnp.asarray(x), eps=1e-3)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tL.rmsnorm_apply(tp, torch.as_tensor(x), eps=1e-3).numpy(),
                               np.asarray(jL.rmsnorm_apply(p, jnp.asarray(x), eps=1e-3)),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tL.alibi_slopes(6).numpy(), np.asarray(jL.alibi_slopes(6)),
                               rtol=1e-7)
