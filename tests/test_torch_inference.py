"""The port's ``init_inference(...).generate`` against the JAX package's,
on the same params, on the CPU; its config against the JAX config."""

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.base import ConfigError as JaxConfigError
from deepspeed_tpu_torch.config import ConfigError
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from tests.torch_port_util import VARIANTS, jax_model, jax_values, port_model


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _engines(kw, seed, **config):
    """A JAX engine and a CPU port engine on the same (JAX-initialised) params."""
    config = {"dtype": "float32", "max_tokens": 64, **config}
    jm = jax_model(**kw)
    values = jax_values(jm, seed)
    je = deepspeed_tpu.init_inference(jm, config=dict(config))
    je.params = values
    te = deepspeed_tpu_torch.init_inference(port_model(**kw), config=dict(config), device="cpu")
    te.params = values
    return je, te


@pytest.mark.parametrize("name", ["gpt2ish", "llamaish", "bloomish", "gqa"])
def test_greedy_generate_matches_jax(name):
    """Prompt bucketing (pow2 from 16: 11 -> 16) with prefill_flash on, so
    the port's prefill goes through the flash kernel's plain version."""
    je, te = _engines(dict(VARIANTS[name], prefill_flash=True), 0, prompt_bucket_size=16)
    prompt = np.random.RandomState(1).randint(0, 64, (2, 11)).astype(np.int32)
    ref = np.asarray(je.generate(prompt, max_new_tokens=6, greedy=True))
    got = te.generate(prompt, max_new_tokens=6, greedy=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_batch_bucket_and_eos_match_jax():
    """3 rows padded to the 4-row bucket, eos early stop and truncation."""
    je, te = _engines(VARIANTS["gpt2ish"], 2, batch_bucket_size=4)
    prompt = np.random.RandomState(3).randint(0, 64, (3, 6)).astype(np.int32)
    plain = np.asarray(je.generate(prompt, max_new_tokens=8, greedy=True))
    np.testing.assert_array_equal(te.generate(prompt, max_new_tokens=8).numpy(), plain)
    eos = int(plain[0, 9])  # a token row 0 emits mid-stream
    ref = np.asarray(je.generate(prompt, max_new_tokens=8, greedy=True, eos_token_id=eos))
    got = te.generate(prompt, max_new_tokens=8, greedy=True, eos_token_id=eos).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got[0, 10:] == eos).all()


def test_bucketed_equals_unbucketed_and_scoring():
    """Bucketed prompts give the unbucketed stream; forward() pads the
    sequence and returns exact logits."""
    kw = VARIANTS["llamaish"]
    eng = deepspeed_tpu_torch.init_inference(port_model(**kw), dtype="float32",
                                             max_tokens=64, prompt_bucket_size=16,
                                             device="cpu")
    raw = deepspeed_tpu_torch.init_inference(port_model(**kw), dtype="float32",
                                             max_tokens=64, prompt_bucket_size=1,
                                             device="cpu")
    raw.params = eng.params
    r = np.random.RandomState(7)
    for n in (6, 11):
        p = r.randint(0, 64, (2, n))
        torch.testing.assert_close(eng.generate(p, max_new_tokens=4),
                                   raw.generate(p, max_new_tokens=4), rtol=0, atol=0)
    assert eng._bucket_prompt_len(6, 60) == eng._bucket_prompt_len(11, 60) == 16
    ids = r.randint(0, 64, (2, 10))
    la, lb = eng.forward(ids), raw.forward(ids)
    assert la.shape == lb.shape == (2, 10, 64)
    torch.testing.assert_close(la, lb, rtol=2e-5, atol=2e-6)


def test_sampled_streams_seeded_port_against_port():
    """JAX's threefry stream cannot be reproduced: sampled streams are held
    port against port. Two identical requests draw different streams; the
    same seed and request sequence, or an explicit generator, reproduce."""
    kw = VARIANTS["gpt2ish"]

    def engine():
        e = deepspeed_tpu_torch.init_inference(port_model(**kw), dtype="float32",
                                               max_tokens=64, seed=5, device="cpu")
        return e

    prompt = np.random.RandomState(12).randint(0, 64, (2, 6))
    e1, e2 = engine(), engine()
    a = e1.generate(prompt, max_new_tokens=8, greedy=False, temperature=1.0, top_k=8)
    b = e1.generate(prompt, max_new_tokens=8, greedy=False, temperature=1.0, top_k=8)
    assert not torch.equal(a, b)
    torch.testing.assert_close(e2.generate(prompt, max_new_tokens=8, greedy=False, top_k=8), a,
                               rtol=0, atol=0)
    c = e1.generate(prompt, max_new_tokens=8, greedy=False,
                    generator=torch.Generator().manual_seed(42))
    d = e1.generate(prompt, max_new_tokens=8, greedy=False,
                    generator=torch.Generator().manual_seed(42))
    torch.testing.assert_close(c, d, rtol=0, atol=0)
    # temperature 0 is greedy, whatever the flag says
    torch.testing.assert_close(e1.generate(prompt, max_new_tokens=4, greedy=False,
                                           temperature=0.0),
                               e1.generate(prompt, max_new_tokens=4), rtol=0, atol=0)


def test_sample_token_filters():
    from deepspeed_tpu_torch.models.decoding import sample_token

    logits = torch.tensor(np.random.RandomState(0).randn(3, 50), dtype=torch.float32)
    np.testing.assert_array_equal(sample_token(logits, greedy=True).numpy(),
                                  np.argmax(logits.numpy(), -1))
    tied = torch.zeros(1, 5)
    assert int(sample_token(tied, greedy=True)) == 0  # first index wins ties
    gen = torch.Generator().manual_seed(0)
    top5 = np.argsort(logits.numpy(), axis=-1)[:, -5:]
    top1p = np.argmax(logits.numpy(), -1)
    for _ in range(5):
        s = sample_token(logits, gen, temperature=0.8, top_k=5).numpy()
        assert all(s[i] in top5[i] for i in range(3))
        np.testing.assert_array_equal(sample_token(logits * 50, gen, top_p=0.01).numpy(), top1p)


@pytest.mark.parametrize("bad", [
    {"dtype": "float64"},
    {"prompt_bucket_policy": "fib"},
], ids=["dtype", "bucket-policy"])
def test_config_errors_match_jax(bad):
    from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxConfig

    with pytest.raises(JaxConfigError):
        JaxConfig.from_dict(bad)
    with pytest.raises(ConfigError):
        DeepSpeedInferenceConfig.from_dict(bad)


def test_same_json_same_values_and_overflow_error():
    from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxConfig

    js = {"dtype": "float16", "max_tokens": "256", "prompt_bucket_size": 32.0,
          "prompt_bucket_policy": "multiple", "batch_bucket_size": 2, "seed": 3,
          "tensor_parallel": {"tp_size": 1}, "quant": {"enabled": False}}
    jc, tc = JaxConfig.from_dict(js), DeepSpeedInferenceConfig.from_dict(js)
    for k in ("dtype", "max_tokens", "prompt_bucket_size", "prompt_bucket_policy",
              "batch_bucket_size", "seed", "compile_cache_size", "min_tokens"):
        assert getattr(tc, k) == getattr(jc, k), k
    je, te = _engines(VARIANTS["gpt2ish"], 0, max_tokens=16)
    prompt = np.zeros((1, 12), np.int32)
    with pytest.raises(JaxConfigError, match="exceeds max_tokens"):
        je.generate(prompt, max_new_tokens=8)
    with pytest.raises(ConfigError, match="exceeds max_tokens"):
        te.generate(prompt, max_new_tokens=8)


@pytest.mark.parametrize("block,ported", [
    ({"serving": {"n_slots": 4, "speculative": {"enabled": True}}}, False),
    ({"telemetry": {"enabled": True}}, False),
    ({"quant": {"enabled": True, "bits": 4, "group_size": 32}}, True),
    ({"tensor_parallel": {"tp_size": 2}}, False),
], ids=["serving", "telemetry", "quant", "tp"])
def test_unported_blocks_raise_naming_the_roadmap(block, ported):
    """Each unported block raises naming its ROADMAP item; a block ported
    since (``quant``, weight-only int8/int4) parses to the JAX package's
    values."""
    if ported:
        from deepspeed_tpu.inference.config import DeepSpeedInferenceConfig as JaxConfig

        tc, jc = DeepSpeedInferenceConfig.from_dict(block), JaxConfig.from_dict(block)
        for k in ("enabled", "bits", "group_size"):
            assert getattr(tc.quant, k) == getattr(jc.quant, k), k
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md A"):
        DeepSpeedInferenceConfig.from_dict(block)
    # blocks that leave their feature off parse
    DeepSpeedInferenceConfig.from_dict({"telemetry": {"enabled": False}, "serving": {}})


def test_unported_entry_points_raise():
    eng = deepspeed_tpu_torch.init_inference(port_model(), dtype="float32", device="cpu")
    for call in (lambda: eng.serving.trace_decode(), lambda: eng.load_checkpoint("x"),
                 lambda: eng.decode_program_report(),
                 lambda: deepspeed_tpu_torch.init_inference("path/to/ckpt", device="cpu")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md A"):
            call()
    with pytest.raises(NotImplementedError, match="ROADMAP.md A"):
        port_model(n_experts=4)


def test_warmup_counts_bucket_shapes():
    eng = deepspeed_tpu_torch.init_inference(port_model(), dtype="float32", max_tokens=64,
                                             prompt_bucket_size=16, device="cpu")
    assert eng.warmup([6, 11, 20], max_new_tokens=4) == 2
    assert set(eng.last_timing.seconds()) == {"prefill", "decode"}
