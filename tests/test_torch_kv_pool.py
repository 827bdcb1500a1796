"""The port's ``KVPoolManager`` (host-side paged-pool allocator and prefix
cache) against the JAX package's: the same seeded sequence of operations
gives the same block ids, scrub order and ``stats()`` at every step."""

import numpy as np
import pytest

from deepspeed_tpu.config import KVPoolConfig as JaxKVPoolConfig
from deepspeed_tpu.config.base import ConfigError as JaxConfigError
from deepspeed_tpu.serving.kv_pool import KVPoolManager as JaxKVPoolManager
from deepspeed_tpu.serving.kv_pool import prefix_chain_keys as jax_prefix_chain_keys
from deepspeed_tpu_torch.config import ConfigError, KVPoolConfig
from deepspeed_tpu_torch.serving.kv_pool import GARBAGE_BLOCK, KVPoolManager, prefix_chain_keys


def _managers(n_slots=4, max_len=64, **pool):
    pool = {"enabled": True, "block_size": 8, **pool}
    j = JaxKVPoolManager(JaxKVPoolConfig(**pool), n_slots, max_len)
    t = KVPoolManager(KVPoolConfig.from_dict(pool), n_slots, max_len)
    scrubbed = ([], [])
    j._scrub, t._scrub = scrubbed[0].append, scrubbed[1].append
    return j, t, scrubbed


def _drive(mgr, ops):
    """Run a request lifecycle script against ``mgr``; returns what every
    operation returned, and the stats after it."""
    out, bound = [], {}
    for op, slot, prompt, max_new in ops:
        if op == "admit" and slot not in bound:
            shared_len, shared = mgr.acquire_prefix(prompt)
            need = mgr.blocks_for(len(prompt), max_new)
            if mgr.can_allocate(need - len(shared)):
                mgr.reserve(need)
                mgr.consume_reservation(need)
                blocks = shared + mgr.alloc(need - len(shared))
                mgr.bind_slot(slot, blocks, len(prompt) + max_new - 1)
                mgr.register_prefix(prompt, blocks)
                bound[slot] = len(prompt)
                res = ("bound", shared_len, blocks)
            else:
                mgr.release_blocks(shared)
                res = ("wait", shared_len, shared)
        elif op == "grow" and slot in bound:
            res = ("grew", mgr.grow_slot(slot, live_tokens=bound[slot] + 8)) \
                if mgr.can_allocate(1) else ("full",)
        elif op == "free" and slot in bound:
            mgr.free_slot(slot)
            del bound[slot]
            res = ("freed",)
        else:
            res = ("skip",)
        out.append((res, mgr.stats(), mgr.fits_ever(len(prompt), max_new)))
    return out


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("prefix_cache", [True, False], ids=["prefix", "no-prefix"])
@pytest.mark.parametrize("n_blocks", [14, 9], ids=["roomy", "tight"])
def test_same_operations_same_blocks_and_stats(seed, prefix_cache, n_blocks):
    """A tight pool (9 blocks for 4 slots of up to 8) keeps admissions
    waiting for blocks."""
    rng = np.random.RandomState(seed)
    # prompts drawn from a few shared system prompts, so prefixes repeat
    families = [rng.randint(0, 64, (int(rng.randint(8, 30)),)).astype(np.int32)
                for _ in range(3)]
    ops = []
    for _ in range(120):
        fam = families[rng.randint(len(families))]
        tail = rng.randint(0, 64, (int(rng.randint(1, 12)),)).astype(np.int32)
        ops.append((("admit", "admit", "grow", "free")[rng.randint(4)], int(rng.randint(4)),
                    np.concatenate([fam, tail]), int(rng.randint(1, 20))))
    j, t, scrubbed = _managers(n_blocks=n_blocks, prefix_cache=prefix_cache)
    got, ref = _drive(t, ops), _drive(j, ops)
    assert got == ref
    assert scrubbed[1] == scrubbed[0]
    assert list(t._free) == list(j._free) and t._ref == j._ref
    assert list(t._prefix.items()) == list(j._prefix.items())
    kinds = {r[0][0] for r in got}
    assert {"bound", "freed"} <= kinds  # the script exercised the pool
    if n_blocks == 9:
        assert "wait" in kinds
    if prefix_cache:
        assert got[-1][1]["prefix_hit_requests"] > 0


@pytest.mark.parametrize("block_size", [1, 4, 16])
def test_prefix_chain_keys_equal(block_size):
    rng = np.random.RandomState(block_size)
    for n in (0, 3, 16, 37):
        prompt = rng.randint(0, 32000, (n,)).astype(np.int32)
        for limit in (None, 0, n - 1, n):
            assert prefix_chain_keys(prompt, block_size, limit) == \
                jax_prefix_chain_keys(prompt, block_size, limit)


def test_geometry_errors_and_auto_size_match_jax():
    for args in ((4, 60, {"block_size": 8}), (4, 64, {"block_size": 8, "n_blocks": 1})):
        with pytest.raises(JaxConfigError):
            JaxKVPoolManager(JaxKVPoolConfig(**args[2]), args[0], args[1])
        with pytest.raises(ConfigError):
            KVPoolManager(KVPoolConfig.from_dict(args[2]), args[0], args[1])
    j, t, _ = _managers(n_slots=3, max_len=64)
    assert t.n_blocks == j.n_blocks == 3 * 8 + 1
    assert t.blocks_per_slot == j.blocks_per_slot == 8
    assert GARBAGE_BLOCK == 0 and 0 not in t._free


def test_kv_dtype_int8_parses_like_jax():
    """``kv_dtype="int8"`` (the int8 pool) parses to JAX's value; any other
    non-empty kv_dtype is a ConfigError on both sides."""
    block = {"enabled": True, "kv_dtype": "int8"}
    assert KVPoolConfig.from_dict(block).kv_dtype == JaxKVPoolConfig(**block).kv_dtype == "int8"
    with pytest.raises(JaxConfigError):
        JaxKVPoolConfig(enabled=True, kv_dtype="int4")
    with pytest.raises(ConfigError):
        KVPoolConfig.from_dict({"enabled": True, "kv_dtype": "int4"})


def test_int8_pool_block_ops_match_jax():
    """The int8 pool's block operations on the same dense cache: insert
    (quantize per token and head), the prefix seed (dequantize), the scrub
    (payload and scales to zero), each bitwise equal to JAX's."""
    import jax.numpy as jnp
    import torch

    from deepspeed_tpu.models import decoding as jdec
    from deepspeed_tpu_torch.models import decoding as tdec
    from tests.torch_port_util import jax_model, port_model

    jcfg, tcfg = jax_model().config, port_model().config
    bs, nb = 8, 6
    dense = np.random.RandomState(3).randn(tcfg.n_layers, 1, 4 * bs, tcfg.kv_heads,
                                           tcfg.head_dim).astype(np.float32)
    dense[:, :, 5] = 0.0                                  # an all-zero token row
    jpool = jdec.init_paged_cache(jcfg, nb, bs, jnp.float32, "int8")
    for i, b in enumerate((2, 4, 5)):
        jpool = jdec.insert_block_kv(jpool, {"k": jnp.asarray(dense), "v": jnp.asarray(-dense)},
                                     b, i * bs, bs)
    tpool = tdec.init_paged_cache(tcfg, nb, bs, torch.float32, "int8")
    tdec.insert_block_kv(tpool, {"k": torch.tensor(dense), "v": torch.tensor(-dense)},
                         [2, 4, 5], 0, bs)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]), name)
    row = [4, 2, 0, 5]
    jseed = jdec.gather_slot_cache(jcfg, jpool, np.asarray(row), jnp.float32)
    tseed = tdec.gather_slot_cache(tcfg, tpool, row, torch.float32)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tseed[name].numpy(), np.asarray(jseed[name]), name)
    jpool = jdec.reset_block_kv(jpool, 4)
    tdec.reset_block_kv(tpool, 4)
    for name in ("k", "v", "k_scale", "v_scale"):
        np.testing.assert_array_equal(tpool[name].numpy(), np.asarray(jpool[name]), name)
        assert not tpool[name][:, 4].any()
