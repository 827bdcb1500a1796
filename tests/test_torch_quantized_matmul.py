"""Weight-only int8/int4 serving in the port against the JAX package, on the
CPU: the dequant-matmul's plain version (what the CUDA kernel is held
against on the card) against the Pallas TPU kernel in interpret mode,
``linear_apply`` against JAX's with its kernel off and in interpret mode,
the engine's ``_quantize_weights`` against JAX's, and ``generate()`` on
tiny fp32 models with JAX's own quantized weights.

Tolerances:
- fp32 products: 2e-5 + 2e-5 |ref| (summation order only);
- bf16: 1e-5 + 2^-8 |ref| + k 2^-24 sum|x||w| per the design (the dequantized
  bf16 weights are bitwise equal, so the fp32 sums differ only in order and
  each side rounds once to bf16); where the two roundings land on
  neighbouring bf16 values they differ by one ulp, up to 2^-7 |ref|, so the
  |ref| term is taken at 2^-7;
- model logits: rtol 2e-4 / atol 2e-5 (ROADMAP's fp32 logits tolerance),
  greedy streams equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.models import layers as jlayers
from deepspeed_tpu.models import transformer as jtransformer
from deepspeed_tpu.ops import quantizer as jq
from deepspeed_tpu.ops.pallas.quantized_matmul import quantized_matmul as jax_qmm
from deepspeed_tpu_torch.models import layers as tlayers
from deepspeed_tpu_torch.models import transformer as ttransformer
from deepspeed_tpu_torch.models.layers import flatten_tree
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda import quantized_matmul as tqmm
from deepspeed_tpu_torch.ops.quantizer import pack_int4, quantize_per_channel
from tests.torch_port_util import VARIANTS, jax_model, jax_values, port_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _operands(m, k, n, group, bits, seed=0):
    """numpy x [m, k] and JAX-quantized (q, scale) of a [k, n] weight."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) * 0.05).astype(np.float32)
    q, scale = jq.quantize_per_channel(jnp.asarray(w), bits=bits, group_size=group)
    if bits == 4:
        q = jq.pack_int4(q)
    return x, np.asarray(q), np.asarray(scale)


def _bf16_limit(x, q, scale, bits, ref):
    w = tqmm.dequantized_weight(torch.tensor(q), torch.tensor(scale).to(torch.bfloat16), bits)
    w = w.to(torch.bfloat16).float()
    xa = torch.tensor(x).to(torch.bfloat16).float().abs()
    return (1e-5 + 2.0 ** -7 * np.abs(ref)
            + x.shape[1] * 2.0 ** -24 * (xa @ w.abs()).numpy())


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel_interpret(bits, dtype):
    """At a tileable shape (the Pallas kernel's 128-lane tiles, two k tiles,
    two n tiles): the plain version against the TPU kernel in interpret mode."""
    x, q, scale = _operands(8, 256, 256, 64, bits)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    # the scale in x's dtype on both sides, as the models' casts hand it over
    ref = jax_qmm(jx, jnp.asarray(q), jnp.asarray(scale, jx.dtype), bits=bits, block_k=128,
                  block_n=128, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    tx = torch.tensor(x).to(getattr(torch, dtype))
    before = dict(LAUNCH_COUNTS)
    got = tqmm.quantized_matmul(tx, torch.tensor(q), torch.tensor(scale).to(tx.dtype), bits=bits)
    assert LAUNCH_COUNTS == before  # CPU tensors: the plain version, no launch
    assert got.dtype == tx.dtype and got.shape == (8, 256)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    else:
        limit = _bf16_limit(x, q, scale, bits, ref)
        assert (np.abs(got - ref) <= limit).all(), np.abs(got - ref).max()


def test_kernel_route_takes_every_prefill_linear_to_wgmma(monkeypatch):
    """``kernel_route`` and ``kernel_splits`` are pure functions of the shape
    (the SM count aside, pinned here to the H100's 132): every Llama-7B
    linear at every token count m > 16 that ``chip_smoke.py``'s quantized
    serving phase runs takes the TMA + wgmma route, in int8 and int4; the
    decode batches take the mma decode kernel; the ragged case and fp16/fp32
    x take the wmma route; a long prefill takes 256-row blocks and does not
    split k, a short one takes 128-row blocks and splits k when they are few."""
    import chip_smoke

    monkeypatch.setattr(tqmm, "_sm_count", lambda index: 132)
    ms = chip_smoke.qmm_main_ms()
    assert any(m <= 16 for m in ms) and any(m > 16 for m in ms)
    for bits in (8, 4):
        for k, n in chip_smoke.LLAMA_LINEARS:
            for m in ms:
                want = "wgmma" if m > 16 else "mma"
                assert tqmm.kernel_route(m, n, k, 64, torch.bfloat16, bits) == want, (m, k, n)
        assert tqmm.kernel_route(37, 4000, 4094, 23, torch.bfloat16, bits) == "wmma"
        for dtype in (torch.float16, torch.float32):
            assert tqmm.kernel_route(2048, 11008, 4096, 64, dtype, bits) == "wmma"
    rows = lambda m, n: tqmm.wgmma_block_rows(m, n, "cuda:0")
    assert rows(2048, 11008) == rows(1024, 4096) == 256   # 344 and 128 blocks of 256 rows
    assert rows(512, 4096) == rows(64, 11008) == 128      # 64 and 86: under 3/4 of 132
    splits = lambda m, n, k: tqmm.kernel_splits("wgmma", m, n, k, torch.bfloat16, "cuda:0")
    assert splits(2048, 11008, 4096) == splits(64, 11008, 4096) == 1
    assert splits(64, 4096, 4096) == 5              # 32 blocks: 5 splits reach 132
    assert splits(64, 4096, 4096) == splits(64, 4096, 4096)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("shape", [(3, 70, 50, 7), (2100, 32, 16, 16)],
                         ids=["ragged-odd-group", "m-over-2048"])
def test_linear_apply_matches_jax(bits, shape, monkeypatch):
    """Shapes the Pallas kernel refuses (ragged with an odd group, m > 2048):
    the port's quantized linear against JAX's dequant path, 3-D x + bias."""
    m, k, n, group = shape
    x, q, scale = _operands(m, k, n, group, bits)
    bias = np.random.RandomState(1).randn(n).astype(np.float32)
    key = "kernel_q4" if bits == 4 else "kernel_q"
    monkeypatch.setenv("DS_TPU_QMM", "off")
    ref = jlayers.linear_apply({key: jnp.asarray(q), "kernel_scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)},
                               jnp.asarray(x).reshape(1, m, k), compute_dtype=jnp.float32)
    got = tlayers.linear_apply({key: torch.tensor(q), "kernel_scale": torch.tensor(scale),
                                "bias": torch.tensor(bias)},
                               torch.tensor(x).reshape(1, m, k), compute_dtype=torch.float32)
    assert got.shape == (1, m, n)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_linear_apply_matches_jax_kernel_path(bits, monkeypatch):
    """JAX's linear_apply routed through its Pallas kernel (interpret)."""
    x, q, scale = _operands(6, 128, 128, 64, bits)
    bias = np.random.RandomState(2).randn(128).astype(np.float32)
    key = "kernel_q4" if bits == 4 else "kernel_q"
    monkeypatch.setenv("DS_TPU_QMM", "interpret")
    ref = jlayers.linear_apply({key: jnp.asarray(q), "kernel_scale": jnp.asarray(scale),
                                "bias": jnp.asarray(bias)},
                               jnp.asarray(x).reshape(2, 3, 128), compute_dtype=jnp.float32)
    got = tlayers.linear_apply({key: torch.tensor(q), "kernel_scale": torch.tensor(scale),
                                "bias": torch.tensor(bias)},
                               torch.tensor(x).reshape(2, 3, 128), compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_bf16_forward_sees_the_scale_in_bf16(monkeypatch):
    """The reference's per-forward cast takes floating leaves to the compute
    dtype, so in bf16 serving the dequant reads a bf16-rounded scale; the
    port's casts do the same, and the kernel gets its scale in bf16."""
    from deepspeed_tpu.models import TransformerConfig as JaxConfig
    from deepspeed_tpu_torch.interop.jax_params import to_jax
    from tests.torch_port_util import BASE

    te = deepspeed_tpu_torch.init_inference(port_model(), dtype="bfloat16", max_tokens=32,
                                            quant={"enabled": True}, device="cpu")
    # the reference's cast, on the same quantized layer stored as the JAX engine stores it
    # (scales fp32, payloads int8, the rest in the serving dtype)
    stored = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a[0], jnp.bfloat16 if a.dtype == np.float32 and a.ndim < 4
                              else a.dtype), to_jax(te.params["blocks"]))
    jblocks = jtransformer._cast_block_params(JaxConfig(**BASE, compute_dtype=jnp.bfloat16),
                                              stored)
    for p in (ttransformer._cast_block_params(te.module.config,
                                              ttransformer.layer_params(te.params["blocks"], 0)),
              ttransformer.unstack_layers(te.module.config, te.params["blocks"])[0]):
        got = {k: v.dtype for k, v in flatten_tree(p).items() if "kernel" in k}
        want = {k: str(v.dtype) for k, v in flatten_tree(jblocks).items() if "kernel" in k}
        assert set(got) == set(want)
        for k in got:
            assert str(got[k]).replace("torch.", "") == want[k], k
    seen = []
    real = tqmm.quantized_matmul
    monkeypatch.setattr(tqmm, "quantized_matmul",
                        lambda x, q, s, bits: seen.append(s.dtype) or real(x, q, s, bits=bits))
    te.generate(np.zeros((1, 4), np.int64), max_new_tokens=2)
    assert seen and set(seen) == {torch.bfloat16}


PAIRS = {"int8-gpt2ish": (8, VARIANTS["gpt2ish"], 8),
         # an odd in-dim (d_ff 35): its 4-bit values are int8-stored, with an odd group
         "int4-llamaish-odd-dff": (4, {**VARIANTS["llamaish"], "d_ff": 35}, 7)}


@pytest.fixture(scope="module")
def quantized_pairs():
    """name -> (JAX engine whose weights its own _quantize_weights quantized,
    port engine serving JAX's quantized tree as it is, the float weights,
    the quantized tree), built on first use."""
    built = {}

    def get(name):
        if name not in built:
            bits, kw, group = PAIRS[name]
            jm = jax_model(**kw)
            values = jax_values(jm, 0)
            config = {"dtype": "float32", "max_tokens": 32}
            quant = {"enabled": True, "bits": bits, "group_size": group}
            je = deepspeed_tpu.init_inference(jm, config=dict(config))
            je.params = values
            je._config.quant = type(je._config.quant)(**quant)
            je._quantize_weights()
            jq_values = jax.tree_util.tree_map(np.asarray, je.params)
            te = deepspeed_tpu_torch.init_inference(port_model(**kw), device="cpu",
                                                    config={**config, "quant": quant})
            te.params = jq_values
            built[name] = (je, te, values, jq_values)
        return built[name]
    return get


@pytest.mark.parametrize("name", list(PAIRS))
def test_generate_with_jax_quantized_weights(quantized_pairs, name):
    bits, kw, group = PAIRS[name]
    je, te, values, jq_values = quantized_pairs(name)
    flat = flatten_tree(te.params)
    for path, leaf in flatten_tree(jq_values).items():
        assert flat[path].dtype == getattr(torch, str(leaf.dtype)), path
    if bits == 4:
        assert any(p.endswith("kernel_q4") for p in flat)      # even in-dims packed
        assert any(p.endswith("kernel_q") for p in flat)       # the odd d_ff is not
    ids = np.random.RandomState(5).randint(0, 64, (2, 7)).astype(np.int32)
    np.testing.assert_allclose(te.forward(ids).numpy(), np.asarray(je.forward(jnp.asarray(ids))),
                               rtol=2e-4, atol=2e-5)
    got = te.generate(ids, max_new_tokens=6, greedy=True).numpy()
    ref = np.asarray(je.generate(jnp.asarray(ids), max_new_tokens=6, greedy=True))
    np.testing.assert_array_equal(got, ref)

    # the port's own _quantize_weights on the same float weights gives JAX's tree, bitwise
    own = deepspeed_tpu_torch.init_inference(port_model(**kw), dtype="float32", max_tokens=32,
                                             device="cpu")
    own.params = values
    own._config.quant.bits, own._config.quant.group_size = bits, group
    own._quantize_weights()
    mine = flatten_tree(own.params)
    assert set(mine) == set(flat)
    for path, leaf in flat.items():
        assert torch.equal(mine[path], leaf), path


def test_quantize_weights_needs_blocks_and_skips_routers():
    from deepspeed_tpu_torch.config import ConfigError
    from deepspeed_tpu_torch.models.layers import ParamTree

    class Bare(ParamTree):
        config = None

        def load_params(self, params):
            self.set_tree(params)

    eng = deepspeed_tpu_torch.init_inference(port_model(), dtype="float32", device="cpu")
    bare = Bare()
    bare.load_params({"w": {"kernel": torch.zeros(4, 4)}})
    eng.module = bare
    with pytest.raises(ConfigError, match="blocks"):
        eng._quantize_weights()
    eng.module = port_model()
    eng.module.load_params(eng.module.init(torch.Generator().manual_seed(0)))
    eng.module.blocks.mlp.register_module("router", ParamTree())
    eng.module.blocks.mlp.router.set_tree({"kernel": torch.ones(2, 16, 4)})
    eng._quantize_weights()
    assert "kernel" in dict(eng.module.blocks.mlp.router.named_parameters())
    assert "kernel_q" in dict(eng.module.blocks.mlp.fc.named_parameters())


def test_from_jax_keeps_integer_payloads():
    from deepspeed_tpu_torch.interop.jax_params import from_jax, to_jax

    w = np.random.RandomState(0).randn(2, 16, 16).astype(np.float32)
    q, scale = quantize_per_channel(torch.tensor(w), bits=4, group_size=8)
    pm = port_model()
    tree = to_jax(pm.init(torch.Generator().manual_seed(0)))
    del tree["blocks"]["attn"]["o"]["kernel"]
    tree["blocks"]["attn"]["o"]["kernel_q4"] = pack_int4(q).numpy()
    tree["blocks"]["attn"]["o"]["kernel_scale"] = scale.numpy()
    back = from_jax(tree, pm, dtype=torch.bfloat16)
    o = back["blocks"]["attn"]["o"]
    assert o["kernel_q4"].dtype == torch.uint8 and o["kernel_scale"].dtype == torch.float32
    assert back["blocks"]["attn"]["q"]["kernel"].dtype == torch.bfloat16
    three = np.concatenate([scale.numpy(), scale.numpy()[:, :1]], axis=1)  # 3 groups of 16 rows
    tree["blocks"]["attn"]["o"]["kernel_scale"] = three
    with pytest.raises(ValueError, match="kernel_scale"):
        from_jax(tree, pm)


def test_quantized_weights_on_int8_pool_serve_like_jax(quantized_pairs):
    """The slice as a whole: JAX's int4 weights served through the fused
    backend on an int8 KV pool, under the virtual clock: greedy streams and
    ``metrics.snapshot()`` equal JAX's."""
    from deepspeed_tpu.config import ServingConfig as JaxServingConfig
    from deepspeed_tpu.serving import Request as JaxRequest
    from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
    from deepspeed_tpu.serving import VirtualClock as JaxVirtualClock
    from deepspeed_tpu_torch.config import ServingConfig
    from deepspeed_tpu_torch.serving import Request, ServingEngine, VirtualClock

    je, te, _, _ = quantized_pairs("int4-llamaish-odd-dff")
    block = {"virtual_clock": True, "n_slots": 2,
             "kv_pool": {"enabled": True, "block_size": 8, "kv_dtype": "int8",
                         "attention_backend": "fused"}}
    rng = np.random.RandomState(5)
    spec = [(rng.randint(0, 64, (int(rng.randint(4, 14)),)).astype(np.int32),
             int(rng.randint(3, 9)), i * 0.5) for i in range(4)]
    jsv = JaxServingEngine(je, serving_config=JaxServingConfig(**block), clock=JaxVirtualClock())
    tsv = ServingEngine(te, serving_config=ServingConfig.from_dict(block), clock=VirtualClock())
    assert tsv.attn_backend == "fused" and tsv.int8_pool
    jreqs = [JaxRequest(prompt=p, max_new_tokens=n, arrival_time=a) for p, n, a in spec]
    treqs = [Request(prompt=p, max_new_tokens=n, arrival_time=a) for p, n, a in spec]
    list(jsv.serve(jreqs))
    list(tsv.serve(treqs))
    for jr, tr in zip(jreqs, treqs):
        assert len(tr.tokens) == tr.max_new_tokens
        assert tr.tokens == [int(t) for t in jr.tokens]
    assert tsv.metrics.snapshot() == jsv.metrics.snapshot()
