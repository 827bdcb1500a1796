"""The port's continuous-batching ``ServingEngine`` against the JAX package's,
on the same params, on the CPU, under a virtual clock.

Virtual time depends only on the schedule, so with equal token streams the
two engines' ``metrics.snapshot()`` (TTFT, TPOT, tokens/s, sheds, the
``kv_pool`` block) must be equal exactly. Greedy streams are held token for
token against the port's own ``generate()`` and the JAX engine's streams on
the dense, gather and fused backends; sampled streams (threefry is not
reproduced) are held port against port.
"""

import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config import ServingConfig as JaxServingConfig
from deepspeed_tpu.serving import Request as JaxRequest
from deepspeed_tpu.serving import ServingEngine as JaxServingEngine
from deepspeed_tpu.serving import VirtualClock as JaxVirtualClock
from deepspeed_tpu_torch.config import ServingConfig
from deepspeed_tpu_torch.inference.config import DeepSpeedInferenceConfig
from deepspeed_tpu_torch.models import decoding as tdec
from deepspeed_tpu_torch.serving import (Request, RequestState, SamplingParams, ServingEngine,
                                         VirtualClock)
from tests.torch_port_util import jax_model, jax_values, port_model

BACKENDS = {"dense": None,
            "gather": {"enabled": True, "block_size": 16, "attention_backend": "gather"},
            "fused": {"enabled": True, "block_size": 16, "attention_backend": "fused"}}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _engine_pair(bucket=16, seed=0):
    config = {"dtype": "float32", "max_tokens": 64, "prompt_bucket_size": bucket}
    jm = jax_model()
    values = jax_values(jm, seed)
    je = deepspeed_tpu.init_inference(jm, config=dict(config))
    je.params = values
    te = deepspeed_tpu_torch.init_inference(port_model(), config=dict(config), device="cpu")
    te.params = values
    return je, te


@pytest.fixture(scope="module")
def engines():
    return _engine_pair()


def _serving(eng, jax_side, kv_pool=None, **kw):
    block = {"virtual_clock": True, "n_slots": 2, **kw}
    if kv_pool:
        block["kv_pool"] = dict(kv_pool)
    if jax_side:
        return JaxServingEngine(eng, serving_config=JaxServingConfig(**block),
                                clock=JaxVirtualClock())
    return ServingEngine(eng, serving_config=ServingConfig.from_dict(block),
                         clock=VirtualClock())


def _requests(cls, spec):
    """spec: [(prompt, max_new_tokens, arrival, extra kwargs)] -> fresh requests."""
    return [cls(prompt=p, max_new_tokens=n, arrival_time=a, **kw) for p, n, a, kw in spec]


def _staggered(seed, n, gap=0.5, max_new=(3, 9), plen=(4, 14)):
    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 64, (int(rng.randint(*plen)),)).astype(np.int32),
             int(rng.randint(*max_new)), i * gap, {}) for i in range(n)]


def _serve_both(engines, spec, kv_pool=None, **kw):
    """Serve the same requests through the JAX and the port engine."""
    je, te = engines
    out = []
    for jax_side, eng, cls in ((True, je, JaxRequest), (False, te, Request)):
        sv = _serving(eng, jax_side, kv_pool=kv_pool, **kw)
        reqs = _requests(cls, spec)
        events = list(sv.serve(reqs))
        out.append((sv, reqs, events))
    return out


def _generate(te, prompt, n):
    return te.generate(prompt[None, :], max_new_tokens=n, greedy=True)[0, len(prompt):].tolist()


@pytest.mark.parametrize("backend", list(BACKENDS))
def test_greedy_streams_match_generate_and_jax(engines, backend):
    """6 staggered requests through 2 slots (slots freed and refilled
    mid-flight): every stream equals the port's generate() and the JAX
    ServingEngine's stream on the same backend, the event streams are
    complete and ordered, and the virtual-clock snapshots are equal."""
    je, te = engines
    spec = _staggered(0, 6)
    (jsv, jreqs, _), (tsv, treqs, events) = _serve_both(engines, spec,
                                                        kv_pool=BACKENDS[backend])
    assert all(r.state is RequestState.FINISHED for r in treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == _generate(te, tr.prompt, tr.max_new_tokens)
        assert tr.tokens == [int(t) for t in jr.tokens]
    by_req = {}
    for ev in events:
        assert ev.index == len(by_req.setdefault(ev.request_id, []))
        by_req[ev.request_id].append(ev.token)
    assert all(by_req[r.request_id] == r.tokens for r in treqs)
    snap = tsv.metrics.snapshot()
    assert snap == jsv.metrics.snapshot()
    if backend != "dense":
        assert snap["kv_pool"]["attention_backend"] == backend


def test_prefix_hit_saves_like_jax():
    """A shared 16-token prefix under bucket 64 in a 64 window: the suffix
    bucket ceiling shrinks by the shared length (64 + 16 would overrun the
    window), the hit saves the same positions as in JAX, and the streams
    equal generate() and JAX's."""
    engines = _engine_pair(bucket=64)
    rng = np.random.RandomState(11)
    shared = rng.randint(0, 64, (16,)).astype(np.int32)
    tails = [np.random.RandomState(s).randint(0, 64, (8,)).astype(np.int32) for s in (1, 2)]
    spec = [(np.concatenate([shared, t]), 6, float(i * 20), {}) for i, t in enumerate(tails)]
    (jsv, jreqs, _), (tsv, treqs, _) = _serve_both(engines, spec, kv_pool=BACKENDS["gather"])
    assert tsv.pool_mgr.stats()["prefix_hit_requests"] == 1
    assert treqs[1].prefix_saved_tokens == jreqs[1].prefix_saved_tokens == 16
    assert tsv.metrics.snapshot() == jsv.metrics.snapshot()
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == [int(t) for t in jr.tokens] == \
            _generate(engines[1], tr.prompt, 6)


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_chunked_prefill_matches_jax(engines, backend):
    """30-40 token prompts prefilled in 8-token chunks interleaved with
    decode steps: the same schedule, streams and snapshot as JAX."""
    spec = _staggered(3, 4, gap=1.0, plen=(30, 40), max_new=(4, 10))
    (jsv, jreqs, _), (tsv, treqs, _) = _serve_both(
        engines, spec, kv_pool=BACKENDS[backend],
        chunked_prefill={"enabled": True, "chunk_size": 8})
    assert all(r.chunks >= 4 for r in treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == [int(t) for t in jr.tokens] == \
            _generate(engines[1], tr.prompt, tr.max_new_tokens)
    assert tsv.metrics.snapshot() == jsv.metrics.snapshot()


def test_growth_preemption_resumes_bitwise(engines):
    """A pool tight enough that on-demand growth must preempt: greedy and
    sampled streams equal those of an unpressured pool, the preemption
    count and snapshot equal JAX's, and the greedy streams equal JAX's."""
    rng = np.random.RandomState(4)
    spec = [(rng.randint(0, 64, (int(rng.randint(8, 14)),)).astype(np.int32), 30, 0.0,
             {"sampling": {"temperature": 0.9, "top_k": 16, "seed": i} if i % 2 else None})
            for i in range(3)]
    tight = {"enabled": True, "block_size": 8, "n_blocks": 9, "on_demand_growth": True}
    (jsv, jreqs, _), (tsv, treqs, _) = _serve_both(engines, spec, kv_pool=tight, n_slots=3)
    assert tsv.pool_mgr.preempted_requests > 0
    assert sum(r.preemptions for r in treqs) == sum(r.preemptions for r in jreqs)
    roomy = _serving(engines[1], False, n_slots=3,
                     kv_pool={"enabled": True, "block_size": 8, "on_demand_growth": True})
    calm = _requests(Request, spec)
    list(roomy.serve(calm))
    assert roomy.pool_mgr.preempted_requests == 0
    for jr, tr, cr in zip(jreqs, treqs, calm):
        assert tr.state is RequestState.FINISHED and len(tr.tokens) == 30
        assert tr.tokens == cr.tokens
        if tr.sampling.temperature == 0:
            assert tr.tokens == [int(t) for t in jr.tokens]
    # no eos: the schedule, and with it virtual time, does not depend on
    # the sampled values
    assert tsv.metrics.snapshot() == jsv.metrics.snapshot()


def test_shed_reasons_match_jax(engines):
    """queue_full under a burst, prompt_too_long and no_free_blocks at
    submit: the same reasons and counts as JAX; accepted work completes."""
    je, te = engines
    rng = np.random.RandomState(3)
    spec = [(rng.randint(0, 64, (6,)).astype(np.int32), 4, 0.0, {}) for _ in range(8)]
    (jsv, jreqs, _), (tsv, treqs, events) = _serve_both(engines, spec, n_slots=1,
                                                        max_queue_depth=2)
    rejected = [r for r in treqs if r.state is RequestState.REJECTED]
    assert rejected and all(r.reject_reason == "queue_full" for r in rejected)
    assert sum(e.finish_reason == "rejected:queue_full" for e in events) == len(rejected)
    assert [r.state.name for r in treqs] == [r.state.name for r in jreqs]
    for sv in (jsv, tsv):
        too_long = sv.submit(rng.randint(0, 64, (40,)).astype(np.int32), max_new_tokens=40)
        assert too_long.reject_reason == "prompt_too_long"
    assert tsv.metrics.snapshot()["shed"] == jsv.metrics.snapshot()["shed"]

    small = {"enabled": True, "block_size": 16, "n_blocks": 3}
    for jax_side, eng, cls in ((True, je, JaxRequest), (False, te, Request)):
        sv = _serving(eng, jax_side, kv_pool=small)
        big = sv.submit(cls(prompt=np.arange(40, dtype=np.int32) % 64, max_new_tokens=10))
        assert big.reject_reason == "no_free_blocks"
        assert sv.metrics.snapshot()["shed"]["no_free_blocks"] == 1


@pytest.mark.parametrize("backend", ["dense", "gather"])
@pytest.mark.parametrize("scrub", [False, True], ids=["no-scrub", "scrub"])
def test_slot_reuse_cannot_leak_stale_kv(engines, backend, scrub):
    """A short request reusing a long request's slot (and blocks) decodes
    exactly as on a never-used pool, with and without the scrub."""
    te = engines[1]
    rng = np.random.RandomState(1)
    long_prompt = rng.randint(0, 64, (12,)).astype(np.int32)
    short_prompt = rng.randint(0, 64, (5,)).astype(np.int32)
    kw = dict(n_slots=1, kv_pool=BACKENDS[backend], scrub_freed_slots=scrub)
    sv = _serving(te, False, **kw)
    list(sv.serve([Request(prompt=long_prompt, max_new_tokens=20)]))
    reused = Request(prompt=short_prompt, max_new_tokens=6)
    list(sv.serve([reused]))
    pristine = Request(prompt=short_prompt, max_new_tokens=6)
    list(_serving(te, False, **kw).serve([pristine]))
    assert reused.tokens == pristine.tokens == _generate(te, short_prompt, 6)
    if backend != "dense" and scrub:
        assert sv.pool_mgr.stats()["scrubbed_blocks"] > 0
        assert float(sv._state["k"].abs().sum()) == 0.0  # every freed block zeroed


def test_sampling_isolation(engines):
    """A seeded request's sampled stream is the same alone or co-batched,
    different seeds diverge, a greedy row next to a sampled row stays the
    exact argmax, and the first-token and slot streams are distinct."""
    te = engines[1]
    rng = np.random.RandomState(4)
    prompt = rng.randint(0, 64, (6,)).astype(np.int32)
    other = rng.randint(0, 64, (9,)).astype(np.int32)
    seeded = lambda seed: Request(prompt=prompt, max_new_tokens=8,
                                  sampling=SamplingParams(temperature=1.0, top_k=8, seed=seed))
    alone = seeded(7)
    list(_serving(te, False).serve([alone]))
    cobatched = seeded(7)
    list(_serving(te, False).serve([cobatched, Request(
        prompt=other, max_new_tokens=8, sampling=SamplingParams(temperature=0.7, seed=123))]))
    assert cobatched.tokens == alone.tokens
    a, b = seeded(7), seeded(8)
    list(_serving(te, False, kv_pool=BACKENDS["fused"]).serve([a, b]))
    assert a.tokens == alone.tokens and a.tokens != b.tokens
    greedy = Request(prompt=prompt, max_new_tokens=6)
    list(_serving(te, False).serve([greedy, seeded(9)]))
    assert greedy.tokens == _generate(te, prompt, 6)


def test_uniforms_never_reach_zero_or_one():
    """The per-slot draws stay strictly inside (0, 1) at the extreme bit
    patterns, so the Gumbel noise is finite and no filtered logit can win."""
    bits = torch.tensor([0, 0x1FF, 0xFFFFFE00, 0xFFFFFFFF], dtype=torch.int64)
    u = tdec._unit_interval(bits)
    assert bool((u > 0).all()) and bool((u < 1).all())
    assert bool(torch.isfinite(-torch.log(-torch.log(u))).all())


def test_top_k_one_sampled_rows_take_the_argmax():
    """top_k=1 leaves one candidate per row: every sampled row, at any
    temperature and stream position, returns its argmax (vocab 32000, as
    Llama's)."""
    rows, vocab = 64, 32000
    logits = torch.from_numpy(np.random.RandomState(11).randn(rows, vocab).astype(np.float32))
    rng = torch.stack([torch.arange(rows, dtype=torch.int64) * 7919,
                       torch.arange(rows, dtype=torch.int64)], dim=1)
    temp = torch.linspace(0.1, 3.0, rows)
    tok = tdec.sample_token_per_request(logits, rng, temperature=temp,
                                        top_k=torch.ones(rows, dtype=torch.int64),
                                        top_p=torch.ones(rows))
    assert torch.equal(tok, torch.argmax(logits, dim=-1))


def test_eos_and_stop_match_generate(engines):
    """EOS and host-side stop ids hold against generate() (the JAX serving
    EOS test is a known failure of the reference, so not against it)."""
    te = engines[1]
    rng = np.random.RandomState(5)
    prompt = rng.randint(0, 64, (6,)).astype(np.int32)
    ref = _generate(te, prompt, 10)
    eos = ref[4]
    cut = ref.index(eos) + 1
    gen_eos = te.generate(prompt[None, :], max_new_tokens=10, eos_token_id=eos)[0, 6:].tolist()
    assert gen_eos[:cut] == ref[:cut] and set(gen_eos[cut:]) <= {eos}
    for backend in ("dense", "fused"):
        req = Request(prompt=prompt, max_new_tokens=10, eos_token_id=eos)
        filler = Request(prompt=rng.randint(0, 64, (8,)).astype(np.int32), max_new_tokens=12)
        list(_serving(te, False, kv_pool=BACKENDS[backend]).serve([req, filler]))
        assert req.finish_reason == "eos" and req.tokens == ref[:cut]
        assert filler.finish_reason == "length" and len(filler.tokens) == 12
        stopped = Request(prompt=prompt, max_new_tokens=10, stop_token_ids=(ref[3],))
        neighbour = Request(prompt=prompt, max_new_tokens=8)
        list(_serving(te, False, kv_pool=BACKENDS[backend]).serve([stopped, neighbour]))
        assert stopped.finish_reason == "stop" and stopped.tokens == ref[:ref.index(ref[3]) + 1]
        assert neighbour.tokens == ref[:8]


def test_init_inference_serve_frontend():
    """init_inference with a serving block: engine.serve() streams events
    incrementally (a late short request interleaves with a long one) and
    destroy() drops the slot pool."""
    rng = np.random.RandomState(7)
    eng = deepspeed_tpu_torch.init_inference(
        port_model(), dtype="float32", max_tokens=64, prompt_bucket_size=16, device="cpu",
        serving={"n_slots": 2, "virtual_clock": True,
                 "kv_pool": {"enabled": True, "attention_backend": "fused"}})
    long_req = Request(prompt=rng.randint(0, 64, (6,)).astype(np.int32), max_new_tokens=12)
    late_req = Request(prompt=rng.randint(0, 64, (5,)).astype(np.int32), max_new_tokens=3,
                       arrival_time=2.0)
    seen = [ev.request_id for ev in eng.serve([long_req, late_req])]
    assert late_req.request_id in seen[seen.index(late_req.request_id):]
    assert long_req.request_id in seen[seen.index(late_req.request_id):]
    assert eng.serving.attn_backend == "fused"
    eng.destroy()
    assert eng._serving is None


@pytest.mark.parametrize("block,item", [
    ({"router": {"enabled": True}}, "A.3"),
    ({"speculative": {"enabled": True, "k": 4}}, "A.3"),
    ({"migration": {"enabled": True}}, "A.3"),
    ({"pools": {"enabled": True}}, "A.3"),
    ({"rebalance": {"enabled": True}}, "A.3"),
    ({"autoscaler": {"enabled": True}}, "A.3"),
    ({"tenants": {"enabled": True}}, "A.3"),
    ({"degraded": {"enabled": True}}, "A.3"),
    ({"policy": "weighted_fair"}, "A.3"),
    ({"kv_pool": {"enabled": True, "kv_dtype": "int8"}}, None),
], ids=["router", "speculative", "migration", "pools", "rebalance", "autoscaler",
        "tenants", "degraded", "weighted_fair", "int8"])
def test_unported_serving_blocks_raise(block, item):
    """Each unported block raises naming its ROADMAP item; a block whose
    feature has been ported since (item None: the int8 KV pool) parses to
    the JAX package's values."""
    if item is None:
        cfg = DeepSpeedInferenceConfig.from_dict({"serving": block}).serving
        assert cfg.kv_pool.kv_dtype == JaxServingConfig(**block).kv_pool.kv_dtype == "int8"
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        DeepSpeedInferenceConfig.from_dict({"serving": block})


def test_serving_config_matches_jax():
    js = {"n_slots": 3, "max_len": 48, "max_queue_depth": 5, "hol_bypass_limit": 2,
          "kv_pool": {"enabled": True, "block_size": 8, "n_blocks": 20,
                      "on_demand_growth": True, "attention_backend": "fused"},
          "chunked_prefill": {"enabled": True, "chunk_size": 16},
          "slo": {"ttft_p99_ms": 250.0}, "router": {"enabled": False}}
    jc, tc = JaxServingConfig(**js), ServingConfig.from_dict(js)
    for k in ("n_slots", "max_len", "max_queue_depth", "hol_bypass_limit",
              "max_prefills_per_step", "virtual_decode_step_cost",
              "virtual_prefill_cost_per_token", "monitor_interval", "retry_limit"):
        assert getattr(tc, k) == getattr(jc, k), k
    for sub, keys in (("kv_pool", ("enabled", "block_size", "n_blocks", "on_demand_growth",
                                   "attention_backend", "prefix_cache", "kv_dtype")),
                      ("chunked_prefill", ("enabled", "chunk_size",
                                           "decode_steps_between_chunks")),
                      ("slo", ("ttft_p99_ms", "tpot_p99_ms", "queue_wait_p99_ms"))):
        for k in keys:
            assert getattr(getattr(tc, sub), k) == getattr(getattr(jc, sub), k), (sub, k)
    from deepspeed_tpu.config.base import ConfigError as JaxConfigError
    from deepspeed_tpu_torch.config import ConfigError

    for bad in ({"n_slots": 0}, {"kv_pool": {"block_size": 0}},
                {"chunked_prefill": {"chunk_size": 0}}, {"slo": {"ttft_p99_ms": -1}},
                {"kv_pool": {"attention_backend": "magic"}}):
        with pytest.raises(JaxConfigError):
            JaxServingConfig(**bad)
        with pytest.raises(ConfigError):
            ServingConfig.from_dict(bad)


def test_unported_engine_methods_raise(engines):
    sv = _serving(engines[1], False, kv_pool=BACKENDS["gather"])
    for call, item in ((sv.trace_decode, "A.9"), (sv.lower_decode, "A.9"),
                       (lambda: sv.set_pool_role("prefill"), "A.3"),
                       (lambda: sv.capture_snapshot(None), "A.3"),
                       (lambda: sv.set_speculation(True), "A.3")):
        with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
            call()
    with pytest.raises(NotImplementedError, match="eager"):
        sv.compile_counts()


def test_continuous_beats_static_batching_like_jax(engines):
    """The static whole-batch baseline gives JAX's numbers, and the slot
    pool's tokens/s beats it on the same virtual cost model."""
    from deepspeed_tpu.serving import simulate_static_batching as jax_static
    from deepspeed_tpu_torch.serving import simulate_static_batching

    rng = np.random.RandomState(2)
    spec = [(rng.randint(0, 64, (int(rng.randint(4, 14)),)).astype(np.int32),
             3 if i % 2 == 0 else 16, None, {}) for i in range(6)]
    (jsv, _, _), (tsv, treqs, _) = _serve_both(engines, spec)
    kw = dict(prefill_cost_per_token=tsv.cfg.virtual_prefill_cost_per_token,
              decode_step_cost=tsv.cfg.virtual_decode_step_cost,
              bucket_len=lambda p: engines[1]._bucket_prompt_len(p, tsv.max_len))
    static = simulate_static_batching(_requests(Request, spec), tsv.n_slots, **kw)
    assert static == jax_static(_requests(JaxRequest, spec), jsv.n_slots, **kw)
    tokens = sum(len(r.tokens) for r in treqs)
    assert tokens == static[0]
    assert tokens / tsv.clock.now() > static[0] / static[1]


def test_unsupported_shape_serves_through_gather(engines, monkeypatch):
    """A fused request on a shape the probe refuses serves through gather,
    and the snapshot records the backend that ran."""
    from deepspeed_tpu_torch.ops.cuda import paged_attention

    monkeypatch.setattr(paged_attention, "fused_decode_supported",
                        lambda cfg, block_size, device=None, dtype=None: (False, "probe says no"))
    te = engines[1]
    sv = _serving(te, False, kv_pool=BACKENDS["fused"])
    assert sv.attn_backend == "gather"
    req = Request(prompt=np.arange(7, dtype=np.int32), max_new_tokens=5)
    list(sv.serve([req]))
    assert req.tokens == _generate(te, req.prompt, 5)
    assert sv.metrics.snapshot()["kv_pool"]["attention_backend"] == "gather"


INT8 = {"enabled": True, "block_size": 16, "kv_dtype": "int8"}


def test_int8_pool_streams_and_snapshot_match_jax(engines):
    """The int8 paged pool through the gather backend: 6 staggered requests,
    two of them sharing a 16-token prefix (a copy-on-write hit on quantized
    blocks), freed blocks scrubbed (their scales too). Greedy streams and
    the virtual-clock snapshot equal JAX's on the same backend."""
    shared = np.random.RandomState(9).randint(0, 64, (16,)).astype(np.int32)
    spec = _staggered(0, 4) + [(np.concatenate([shared, np.full(3 + i, i, np.int32)]), 5,
                                2.0 + i, {}) for i in range(2)]
    (jsv, jreqs, _), (tsv, treqs, _) = _serve_both(
        engines, spec, kv_pool={**INT8, "attention_backend": "gather"})
    assert tsv.int8_pool and tsv._state["k"].dtype == torch.int8
    assert tsv.pool_mgr.stats()["prefix_hit_requests"] >= 1
    assert all(r.state is RequestState.FINISHED for r in treqs)
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == [int(t) for t in jr.tokens]
    snap = tsv.metrics.snapshot()
    assert snap == jsv.metrics.snapshot()
    assert snap["kv_pool"]["attention_backend"] == "gather"


def test_int8_pool_growth_preemption_matches_jax(engines):
    """The fused backend on a tight int8 pool with on-demand growth: blocks
    grow, the pool runs out, requests are preempted and resume; the
    preemptions, greedy streams and snapshot equal JAX's."""
    rng = np.random.RandomState(4)
    spec = [(rng.randint(0, 64, (int(rng.randint(8, 14)),)).astype(np.int32), 30, 0.0, {})
            for _ in range(3)]
    tight = {**INT8, "block_size": 8, "n_blocks": 9, "on_demand_growth": True,
             "attention_backend": "fused"}
    (jsv, jreqs, _), (tsv, treqs, _) = _serve_both(engines, spec, kv_pool=tight, n_slots=3)
    assert tsv.attn_backend == "fused"
    assert tsv.pool_mgr.preempted_requests > 0
    assert [r.preemptions for r in treqs] == [r.preemptions for r in jreqs]
    for jr, tr in zip(jreqs, treqs):
        assert tr.tokens == [int(t) for t in jr.tokens]
    assert tsv.metrics.snapshot() == jsv.metrics.snapshot()
