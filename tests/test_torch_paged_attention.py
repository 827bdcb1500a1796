"""The port's paged flash-decode (the plain version its CUDA kernel is held
against) and its paged decode path against the JAX package's, on the CPU.

The JAX Pallas kernel runs in interpret mode, as the JAX package's own
tests run it, on the fixture of ``tests/unit/test_paged_attention.py``:
ragged cursors (mid-block, inside the first block, a block boundary), a
garbage block poisoned with 1e4 (any read of an unbound column or a row past
the cursor explodes the output), GQA, alibi and 1/2/4 splits.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import decoding as jdec
from deepspeed_tpu.ops.pallas.paged_attention import paged_flash_decode as jax_paged_flash_decode
from deepspeed_tpu_torch.models import decoding as tdec
from deepspeed_tpu_torch.models import TransformerConfig
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda.paged_attention import (fused_decode_supported,
                                                          paged_flash_decode,
                                                          paged_flash_decode_reference,
                                                          rounding_bound)
from tests.torch_port_util import BASE, VARIANTS, pair

# summation order only: both sides accumulate in fp32
ATOL, RTOL = 2e-5, 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _fixture(kvh=2, hq=2, dh=16):
    """tests/unit/test_paged_attention.py:_kernel_fixture (non-int8)."""
    rng = np.random.RandomState(0)
    S, NB, bs, n_blocks = 4, 4, 8, 9
    nh = kvh * hq
    kc = rng.randn(n_blocks, bs, kvh, dh).astype(np.float32)
    vc = rng.randn(n_blocks, bs, kvh, dh).astype(np.float32)
    kc[0] = 1e4
    vc[0] = 1e4
    table = np.zeros((S, NB), np.int32)
    table[0, :2] = [3, 5]
    table[1] = [1, 2, 4, 6]
    table[2, :1] = [7]
    table[3, :3] = [8, 3, 1]
    pos = np.asarray([9, 31, 1, 24], np.int32)
    q = rng.randn(S, nh, dh).astype(np.float32)
    k_new = rng.randn(S, kvh, dh).astype(np.float32)
    v_new = rng.randn(S, kvh, dh).astype(np.float32)
    return q, k_new, v_new, kc, vc, table, pos


def _int8_fixture(kvh=2, hq=2, dh=16):
    """tests/unit/test_paged_attention.py:_kernel_fixture(int8=True): int8
    payloads with per-(token, head) fp32 scales; returns (arrays, scales)."""
    rng = np.random.RandomState(0)
    S, NB, bs, n_blocks = 4, 4, 8, 9
    nh = kvh * hq
    kc = rng.randint(-127, 127, (n_blocks, bs, kvh, dh)).astype(np.int8)
    vc = rng.randint(-127, 127, (n_blocks, bs, kvh, dh)).astype(np.int8)
    ks = np.abs(rng.randn(n_blocks, bs, kvh, 1)).astype(np.float32) * .01
    vs = np.abs(rng.randn(n_blocks, bs, kvh, 1)).astype(np.float32) * .01
    table = np.zeros((S, NB), np.int32)
    table[0, :2] = [3, 5]
    table[1] = [1, 2, 4, 6]
    table[2, :1] = [7]
    table[3, :3] = [8, 3, 1]
    pos = np.asarray([9, 31, 1, 24], np.int32)
    q = rng.randn(S, nh, dh).astype(np.float32)
    k_new = rng.randn(S, kvh, dh).astype(np.float32)
    v_new = rng.randn(S, kvh, dh).astype(np.float32)
    return (q, k_new, v_new, kc, vc, table, pos), {"k_scale": ks, "v_scale": vs}


def _both(arrays, kv_splits, slopes=None, scales=None):
    scales = scales or {}
    ref = jax_paged_flash_decode(*(jnp.asarray(a) for a in arrays), kv_splits=kv_splits,
                                 alibi_slopes=None if slopes is None else jnp.asarray(slopes),
                                 interpret=True,
                                 **{k: jnp.asarray(v) for k, v in scales.items()})
    before = dict(LAUNCH_COUNTS)
    got = paged_flash_decode(*(torch.tensor(a) for a in arrays), kv_splits=kv_splits,
                             alibi_slopes=None if slopes is None else torch.tensor(slopes),
                             **{k: torch.tensor(v) for k, v in scales.items()})
    assert LAUNCH_COUNTS == before  # CPU tensors take the plain version, no launch
    return got.numpy(), np.asarray(ref)


@pytest.mark.parametrize("kv_splits", [1, 2, 4])
def test_plain_matches_jax_kernel(kv_splits):
    got, ref = _both(_fixture(), kv_splits)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert np.abs(got).max() < 10  # the poisoned garbage block was never read


@pytest.mark.parametrize("kv_splits", [1, 2, 4])
def test_plain_matches_jax_kernel_gqa_alibi(kv_splits):
    arrays = _fixture(kvh=2, hq=2, dh=16)
    slopes = (0.5 ** np.arange(1, arrays[0].shape[1] + 1)).astype(np.float32)
    got, ref = _both(arrays, kv_splits, slopes)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_plain_matches_jax_kernel_odd_gqa_group():
    arrays = _fixture(kvh=2, hq=3, dh=8)
    slopes = (0.5 ** np.arange(1, 7)).astype(np.float32)
    got, ref = _both(arrays, 2, slopes)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("kv_splits,alibi", [(2, False), (4, True)], ids=["2-splits", "4-alibi"])
def test_plain_int8_pool_matches_jax_kernel(kv_splits, alibi):
    """The int8 pool (the Pallas kernel's int8 branch, dequantized on the
    tile): fp32 within 2e-5 + 2e-5 |ref|."""
    arrays, scales = _int8_fixture()
    slopes = (0.5 ** np.arange(1, arrays[0].shape[1] + 1)).astype(np.float32) if alibi else None
    got, ref = _both(arrays, kv_splits, slopes, scales)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


def test_plain_cursor_zero_is_the_fresh_row():
    q, k_new, v_new, kc, vc, table, _ = _fixture()
    zero = np.zeros(4, np.int32)
    got, ref = _both((q, k_new, v_new, kc, vc, table, zero), 2)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, np.repeat(v_new, 2, axis=1), atol=1e-6)


def test_wrapper_refusals_and_rounding_bound():
    arrays = [torch.tensor(a) for a in _fixture()]
    # scales come with an int8 pool only, both of them, fp32 [n_blocks, bs, kvh, 1]
    with pytest.raises(TypeError, match="int8 pool"):
        paged_flash_decode(*arrays, k_scale=torch.ones(9, 8, 2, 1), v_scale=torch.ones(9, 8, 2, 1))
    i8, scales = _int8_fixture()
    i8 = [torch.tensor(a) for a in i8]
    scales = {k: torch.tensor(v) for k, v in scales.items()}
    with pytest.raises(ValueError, match="needs k_scale"):
        paged_flash_decode(*i8)
    with pytest.raises(ValueError, match="both"):
        paged_flash_decode(*i8, k_scale=scales["k_scale"])
    with pytest.raises(ValueError, match="pool scales"):
        paged_flash_decode(*i8, k_scale=scales["k_scale"][..., 0], v_scale=scales["v_scale"])
    out = paged_flash_decode(*i8, **scales)
    assert out.shape == arrays[0].shape and bool(torch.isfinite(out).all())
    with pytest.raises(ValueError, match="fresh rows"):
        paged_flash_decode(arrays[0], arrays[1][:, :1], *arrays[2:])
    # fp32: the kernel does not round P, so there is no rounding bound
    ref = paged_flash_decode_reference(*arrays)
    assert rounding_bound(*arrays, ref) is None
    half = [a.to(torch.bfloat16) if a.is_floating_point() else a for a in arrays]
    bound = rounding_bound(*half, paged_flash_decode_reference(*half))
    assert bound.shape == ref.shape and bool((bound > 0).all())


def _cfg(**kw):
    return TransformerConfig(**{**BASE, **kw, "compute_dtype": torch.float32})


def test_fused_decode_supported():
    ok = lambda cfg, **kw: fused_decode_supported(cfg, 16, **kw)[0]
    # shapes the port's model config itself refuses (banded local attention
    # is A.9), as plain geometry
    geo = lambda **kw: types.SimpleNamespace(**{
        "local_attention_window": 0, "n_heads": 4, "kv_heads": 4, "head_dim": 128,
        "compute_dtype": torch.bfloat16, **kw})
    assert not ok(geo(local_attention_window=4), device="cpu")
    assert not ok(geo(kv_heads=3), device="cpu")
    assert ok(geo(), device="cuda")
    # the CPU admits any head_dim (the plain version runs there, as JAX's
    # interpret mode); the card only the kernel's
    assert ok(_cfg(), device="cpu")
    assert not ok(_cfg(), device="cuda")                       # head_dim 4
    assert ok(_cfg(d_model=512, n_heads=4), device="cuda")     # head_dim 128
    assert ok(_cfg(d_model=256, n_heads=4, n_kv_heads=2), device="cuda")  # 64, GQA
    assert not ok(_cfg(d_model=512, n_heads=4), device="cuda", dtype=torch.float64)
    # an int8 pool is staged in the compute dtype, which the kernel must take
    assert ok(_cfg(d_model=512, n_heads=4), device="cuda", dtype=torch.int8)
    assert not ok(TransformerConfig(**{**BASE, "d_model": 512, "n_heads": 4,
                                       "compute_dtype": torch.float64}),
                  device="cuda", dtype=torch.int8)
    reason = fused_decode_supported(_cfg(), 16, device="cuda")[1]
    assert "head_dim" in reason


def _forward_parity(kw, steps=5, plen=10, bs=16, max_len=64):
    """Decode ``steps`` tokens on two slots from the same prefilled pool
    through JAX's gather path and the port's gather and fused paths."""
    if kw.get("kv_dtype") == "int8":
        return _forward_parity_int8({k: v for k, v in kw.items() if k != "kv_dtype"}, steps,
                                    plen, bs, max_len)
    jm, values, pm = pair(kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, values)
    cfg, jcfg = pm.config, jm.config
    ids = np.random.RandomState(2).randint(0, 64, (2, plen)).astype(np.int32)
    jcache = jdec.init_cache(jcfg, 2, max_len, jnp.float32)
    jlogits, jcache = jdec.forward_with_cache(jm, jparams, jnp.asarray(ids), jcache, 0, max_len)
    tcache = tdec.init_cache(cfg, 2, max_len, torch.float32)
    with torch.no_grad():
        tdec.forward_with_cache(pm, pm.params, torch.tensor(ids, dtype=torch.int64), tcache, 0,
                                max_len)
    jpool = jdec.init_paged_cache(jcfg, 9, bs, jnp.float32)
    tpools = {b: tdec.init_paged_cache(cfg, 9, bs, torch.float32) for b in ("gather", "fused")}
    for s in range(2):
        one = {k: v[:, s:s + 1] for k, v in jcache.items()}
        for i in range(max_len // bs):
            jpool = jdec.insert_block_kv(jpool, one, 1 + s * 4 + i, i * bs, bs)
        for pool in tpools.values():
            tdec.insert_block_kv(pool, {k: v[:, s:s + 1] for k, v in tcache.items()},
                                 [1 + s * 4 + i for i in range(max_len // bs)], 0, bs)
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    tok = np.argmax(np.asarray(jlogits[:, plen - 1]), -1).astype(np.int32)
    pos = np.asarray([plen, plen - 3], np.int32)   # ragged cursors
    for _ in range(steps):
        ref, jpool = jdec.forward_with_paged_cache(jm, jparams, jnp.asarray(tok[:, None]), jpool,
                                                   jnp.asarray(table), jnp.asarray(pos), bs)
        ref = np.asarray(ref)
        for backend, pool in tpools.items():
            with torch.no_grad():
                got = tdec.forward_with_paged_cache(
                    pm, pm.params, torch.tensor(tok[:, None], dtype=torch.int64), pool,
                    torch.tensor(table), torch.tensor(pos), bs,
                    attention_backend=backend).numpy()
            # ROADMAP's decode tolerance: fp32 on both sides, another order
            np.testing.assert_allclose(got, ref, rtol=5e-4, atol=5e-5, err_msg=backend)
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        tok = ref[:, 0].argmax(-1).astype(np.int32)
        pos = pos + 1
    # both backends wrote the same pool rows as JAX's gather path
    for pool in tpools.values():
        np.testing.assert_allclose(pool["k"].numpy(), np.asarray(jpool["k"]), rtol=5e-4,
                                   atol=5e-5)


@pytest.mark.parametrize("variant", ["gpt2ish", "gqa", "bloomish", "gptjish", "llamaish"],
                         ids=["plain", "rope-gqa", "alibi", "parallel-attn", "llama"])
def test_forward_with_paged_cache_fused_gather_jax(variant):
    _forward_parity(VARIANTS[variant])


def test_forward_with_paged_cache_refuses_verify_and_prefill():
    _, _, pm = pair(VARIANTS["gpt2ish"])
    pool = tdec.init_paged_cache(pm.config, 3, 16, torch.float32)
    table = torch.ones((1, 4), dtype=torch.int32)
    pos = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP.md A.3"):
        tdec.forward_with_paged_cache(pm, pm.params, torch.zeros((1, 3), dtype=torch.int64),
                                      pool, table, pos, 16, draft_len=torch.tensor([2]))
    with pytest.raises(ValueError, match="one token per slot"):
        tdec.forward_with_paged_cache(pm, pm.params, torch.zeros((1, 3), dtype=torch.int64),
                                      pool, table, pos, 16)
    # the int8 pool: int8 rows and one fp32 scale per (token, head)
    pool = tdec.init_paged_cache(pm.config, 3, 16, kv_dtype="int8")
    cfg = pm.config
    assert pool["k"].dtype == pool["v"].dtype == torch.int8
    assert pool["k"].shape == (cfg.n_layers, 3, 16, cfg.kv_heads, cfg.head_dim)
    assert pool["k_scale"].dtype == torch.float32
    assert pool["k_scale"].shape == pool["v_scale"].shape == pool["k"].shape[:-1] + (1,)


def _forward_parity_int8(kw, steps, plen, bs, max_len):
    """The int8 pool: each port backend against the SAME JAX backend (JAX's
    gather path attends the view it dequantized, its fused path dequantizes
    on the kernel tile; the two are not bitwise equal, JAX pins them within
    2e-4). Logits within rtol 2e-4 / atol 2e-5, greedy tokens equal; the
    written pools within one int8 step and rtol 5e-4 on the scales."""
    jm, values, pm = pair(kw)
    jparams = jax.tree_util.tree_map(jnp.asarray, values)
    cfg, jcfg = pm.config, jm.config
    ids = np.random.RandomState(2).randint(0, 64, (2, plen)).astype(np.int32)
    jcache = jdec.init_cache(jcfg, 2, max_len, jnp.float32)
    jlogits, jcache = jdec.forward_with_cache(jm, jparams, jnp.asarray(ids), jcache, 0, max_len)
    tcache = tdec.init_cache(cfg, 2, max_len, torch.float32)
    with torch.no_grad():
        tdec.forward_with_cache(pm, pm.params, torch.tensor(ids, dtype=torch.int64), tcache, 0,
                                max_len)
    backends = ("gather", "fused")
    jpool = jdec.init_paged_cache(jcfg, 9, bs, jnp.float32, "int8")
    tpools = {b: tdec.init_paged_cache(cfg, 9, bs, torch.float32, "int8") for b in backends}
    for s in range(2):
        one = {k: v[:, s:s + 1] for k, v in jcache.items()}
        for i in range(max_len // bs):
            jpool = jdec.insert_block_kv(jpool, one, 1 + s * 4 + i, i * bs, bs)
        for b in backends:
            tdec.insert_block_kv(tpools[b], {k: v[:, s:s + 1] for k, v in tcache.items()},
                                 [1 + s * 4 + i for i in range(max_len // bs)], 0, bs)
    jpools = {b: jpool for b in backends}     # JAX arrays are immutable: one start for both
    table = np.asarray([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    tok = np.argmax(np.asarray(jlogits[:, plen - 1]), -1).astype(np.int32)
    pos = np.asarray([plen, plen - 3], np.int32)   # ragged cursors
    for _ in range(steps):
        for b in backends:
            ref, jpools[b] = jdec.forward_with_paged_cache(
                jm, jparams, jnp.asarray(tok[:, None]), jpools[b], jnp.asarray(table),
                jnp.asarray(pos), bs, attention_backend=b)
            ref = np.asarray(ref)
            with torch.no_grad():
                got = tdec.forward_with_paged_cache(
                    pm, pm.params, torch.tensor(tok[:, None], dtype=torch.int64), tpools[b],
                    torch.tensor(table), torch.tensor(pos), bs, attention_backend=b).numpy()
            np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5, err_msg=b)
            np.testing.assert_array_equal(got.argmax(-1), ref.argmax(-1))
        tok = ref[:, 0].argmax(-1).astype(np.int32)
        pos = pos + 1
    for b in backends:
        for name in ("k", "v"):
            diff = np.abs(tpools[b][name].numpy().astype(np.int32)
                          - np.asarray(jpools[b][name]).astype(np.int32))
            assert diff.max() <= 1, (b, name)
            np.testing.assert_allclose(tpools[b][name + "_scale"].numpy(),
                                       np.asarray(jpools[b][name + "_scale"]), rtol=5e-4,
                                       atol=1e-9)


def test_forward_with_paged_cache_int8_pool_each_backend_vs_jax():
    _forward_parity({**VARIANTS["gqa"], "kv_dtype": "int8"}, steps=3)
