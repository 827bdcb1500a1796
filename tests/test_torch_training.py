"""The port's training path against the JAX package: ``CausalLM.loss`` and
its grads, and ``initialize`` -> ``train_batch`` against
``deepspeed_tpu.initialize`` on the same weights; the engine's own
invariants (forward/backward/step, gradient accumulation, fp16 overflow,
schedulers) and the config blocks it refuses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.config.config import ConfigError as JaxConfigError
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu.runtime.dataloader import DeepSpeedDataLoader as JaxLoader
from deepspeed_tpu_torch.config import ConfigError, load_config
from deepspeed_tpu_torch.interop import from_jax
from deepspeed_tpu_torch.models import CausalLM
from deepspeed_tpu_torch.models.layers import flatten_tree
from deepspeed_tpu_torch.runtime import DeepSpeedDataLoader, RepeatingLoader
from tests.torch_port_util import jax_model, jax_values, port_model

# tiny GPT-2 and tiny GQA LLaMA at the JAX engine tests' widths
MODELS = {
    "gpt2": dict(vocab_size=97, max_seq_len=32, n_layers=2, n_heads=2, d_model=32, d_ff=64),
    "llama-gqa": dict(vocab_size=97, max_seq_len=32, n_layers=2, n_heads=4, n_kv_heads=2,
                      d_model=32, d_ff=64, position_embedding="rope", norm="rmsnorm",
                      activation="swiglu", use_bias=False, tie_embeddings=False),
}


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _batch(b=4, s=16, vocab=97, seed=0):
    return {"input_ids": np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)}


def _trainable(pm, values):
    pm.load_params(from_jax(values, pm), requires_grad=True)
    return pm


# -- the model's loss and grads --------------------------------------------------------

@pytest.mark.parametrize("model,ce,attn", [
    ("gpt2", "fused-xla", "xla"), ("gpt2", "fused-pallas", "flash"),
    ("gpt2", "materialized", "flash"), ("llama-gqa", "fused-xla", "xla"),
    ("llama-gqa", "fused-pallas", "flash"), ("llama-gqa", "materialized", "flash"),
])
def test_loss_and_grads_match_jax(model, ce, attn):
    """fp32 on the CPU: the loss within rtol 1e-5, every leaf's grad within
    rtol 1e-4 / atol 2e-6 of ``jax.value_and_grad(CausalLM.loss)``. The
    JAX flash path on the CPU is its chunked XLA attention; its Pallas CE
    runs in interpret mode."""
    kw = dict(MODELS[model], attention_impl=attn, fused_ce=ce != "materialized",
              fused_ce_impl="pallas" if ce == "fused-pallas" else "xla", fused_ce_chunks=3)
    jm = jax_model(**kw, attention_interpret=True)
    values = jax_values(jm, seed=1)
    batch = _batch()
    batch["labels"] = batch["input_ids"].copy()
    batch["labels"][:, :3] = -100
    ref_loss, ref_grads = jax.value_and_grad(lambda p: jm.loss(p, batch))(
        jax.tree_util.tree_map(jnp.asarray, values))
    pm = _trainable(port_model(**kw), values)
    loss = pm.loss(pm.params, {k: torch.as_tensor(v).long() for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_grads))
    for path, p in flatten_tree(pm.params).items():
        np.testing.assert_allclose(p.grad.numpy(), ref[path], rtol=1e-4, atol=2e-6, err_msg=path)


def test_default_labels_shift_and_remat_match():
    """Without labels the loss is next-token with the last position
    ignored, as JAX's; ``remat`` (nothing_saveable) gives the same loss and
    grads as without (1e-6)."""
    kw = MODELS["gpt2"]
    jm = jax_model(**kw)
    values = jax_values(jm, seed=2)
    batch = _batch(seed=3)
    ref = float(jm.loss(jax.tree_util.tree_map(jnp.asarray, values), batch))
    grads = []
    for remat in (False, True):
        pm = _trainable(port_model(**kw, remat=remat), values)
        loss = pm.loss(pm.params, {"input_ids": torch.as_tensor(batch["input_ids"]).long()})
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), ref, rtol=1e-5)
        grads.append({k: p.grad for k, p in flatten_tree(pm.params).items()})
    for k in grads[0]:
        torch.testing.assert_close(grads[0][k], grads[1][k], rtol=1e-6, atol=1e-7)


def test_unported_training_model_options_raise():
    with pytest.raises(NotImplementedError, match="A.9"):
        port_model(**MODELS["gpt2"], remat=True, remat_policy="minimal")
    pm = port_model(**MODELS["gpt2"], dropout=0.1)
    pm.load_params(pm.init(torch.Generator().manual_seed(0)))
    ids = torch.zeros((1, 8), dtype=torch.long)
    with pytest.raises(NotImplementedError, match="A.9"):
        pm.loss(pm.params, {"input_ids": ids}, deterministic=False)
    assert torch.isfinite(pm.loss(pm.params, {"input_ids": ids}))  # eval: no dropout


# -- the engine against the JAX engine ---------------------------------------------------

def _config(**over):
    cfg = {"train_batch_size": 4,
           "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
           "gradient_clipping": 1.0, "zero_optimization": {"stage": 0},
           "steps_per_print": 1000}
    cfg.update(over)
    return cfg


def _jax_engine(jm, seed, config):
    """The JAX engine on ONE CPU device (the tests' 8 virtual devices would
    give it dp 8), from the same init the port receives."""
    params = jm.init(jax.random.PRNGKey(seed))
    mesh = build_mesh(devices=jax.devices()[:1])
    engine, *_ = deepspeed_tpu.initialize(model=jm, config=config, model_parameters=params,
                                          mesh=mesh)
    return engine, jax.tree_util.tree_map(np.asarray,
                                          deepspeed_tpu.models.split_params_axes(params)[0])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_three_train_batch_steps_match_jax(model):
    """Three ``train_batch`` steps (AdamW, clipping, the WarmupLR schedule)
    on the same weights and batches: every step's loss within rtol 2e-5
    (each Adam step moves a weight by about lr whatever the size of its
    grad, so weights are not compared elementwise), the same lr, the same
    batch triangle and the same weight-decay mask."""
    kw = dict(MODELS[model], attention_impl="flash")
    config = _config(scheduler={"type": "WarmupLR", "params": {
        "warmup_max_lr": 1e-3, "warmup_num_steps": 3, "warmup_type": "linear"}})
    jm = jax_model(**kw)
    jeng, values = _jax_engine(jm, 4, config)
    peng, *_ = deepspeed_tpu_torch.initialize(model=port_model(**kw), config=config,
                                              model_parameters=values, device="cpu")
    assert (peng.train_batch_size(), peng.train_micro_batch_size_per_gpu(),
            peng.gradient_accumulation_steps()) == (jeng.train_batch_size(),
                                                    jeng.train_micro_batch_size_per_gpu(),
                                                    jeng.gradient_accumulation_steps())
    assert flatten_tree(peng._wd_mask) == flatten_tree(jax.tree_util.tree_map(bool,
                                                                              jeng._wd_mask))
    for step in range(3):
        batch = _batch(seed=10 + step)
        ref = float(jeng.train_batch(batch=batch))
        got = peng.train_batch(batch=batch)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), ref, rtol=2e-5, err_msg=f"step {step}")
        assert peng.get_lr() == pytest.approx(jeng.get_lr(), rel=1e-6)
    assert peng.global_steps == jeng.global_steps == 3


def _engine(config=None, seed=0, model="gpt2", **kw):
    values = jax_values(jax_model(**MODELS[model]), seed)
    eng, *_ = deepspeed_tpu_torch.initialize(model=port_model(**MODELS[model], **kw),
                                             config=config or _config(),
                                             model_parameters=values, device="cpu")
    return eng


def test_forward_backward_step_equals_train_batch():
    a, b = _engine(), _engine()
    for step in range(2):
        batch = _batch(seed=step)
        la = a.train_batch(batch=batch)
        lb = b.forward(batch)
        b.backward(lb)
        norm = b.step()
        assert la.item() == lb.item() and norm.item() > 0
    for (k, pa), pb in zip(flatten_tree(a.params).items(), flatten_tree(b.params).values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=k)
    assert b.get_global_grad_norm() == 0.0  # grads are cleared by the step


def test_gradient_accumulation_equals_one_large_batch():
    """gas 2 over two halves == one batch of 8: the mean loss within 1e-6 and
    the accumulated fp32 grads within 1e-6 before the step (compared before
    Adam, which turns tiny grad differences into lr-sized weight steps)."""
    big = _batch(b=8, seed=5)
    halves = [{"input_ids": big["input_ids"][:4]}, {"input_ids": big["input_ids"][4:]}]
    a = _engine(_config(train_batch_size=8, gradient_accumulation_steps=2))
    b = _engine(_config(train_batch_size=8))
    assert (a.micro_batch_size, a.gradient_accumulation_steps()) == (4, 2)
    la = [a.forward(h) for h in halves[:1]]
    a.backward(la[0])
    assert a.step() is None  # not a boundary yet
    la.append(a.forward(halves[1]))
    a.backward(la[1])
    lb = b.forward(big)
    b.backward(lb)
    np.testing.assert_allclose((la[0].item() + la[1].item()) / 2, lb.item(), rtol=1e-6)
    for (k, pa), pb in zip(flatten_tree(a.params).items(), flatten_tree(b.params).values()):
        torch.testing.assert_close(pa.grad, pb.grad, rtol=1e-5, atol=1e-7, msg=k)
    np.testing.assert_allclose(a.get_global_grad_norm(), b.get_global_grad_norm(), rtol=1e-6)
    a.step()
    b.step()
    assert a.global_steps == b.global_steps == 1
    c = _engine(_config(train_batch_size=8, gradient_accumulation_steps=2))
    loss = c.train_batch(data_iter=iter(halves))
    np.testing.assert_allclose(float(loss), lb.item(), rtol=1e-6)


def test_fp16_overflow_skips_the_step_and_halves_the_scale():
    """A loss scale of 2^127 overflows fp32 (the loss times the scale is
    inf), so the step is skipped: weights, optimizer state and schedule
    stay, and the scale halves. With a sane scale the next steps apply."""
    eng = _engine(_config(fp16={"enabled": True, "initial_scale_power": 127,
                                "loss_scale_window": 2},
                          scheduler={"type": "WarmupLR", "params": {"warmup_num_steps": 10}}))
    assert eng.compute_dtype == torch.float16 and eng.loss_scale == 2.0 ** 127
    before = {k: p.detach().clone() for k, p in flatten_tree(eng.params).items()}
    eng.train_batch(batch=_batch())
    assert eng.skipped_steps == 1 and eng.global_steps == 1
    assert eng.loss_scale == 2.0 ** 126 and eng.lr_scheduler.last_step == 0
    assert int(eng.optimizer_state["step"]) == 0
    for k, p in flatten_tree(eng.params).items():
        torch.testing.assert_close(p.detach(), before[k], rtol=0, atol=0, msg=k)

    eng = _engine(_config(fp16={"enabled": True, "initial_scale_power": 8,
                                "loss_scale_window": 2}))
    losses = [float(eng.train_batch(batch=_batch())) for _ in range(3)]
    assert eng.skipped_steps == 0 and losses[-1] < losses[0]
    assert eng.loss_scale == 2.0 ** 9  # doubled after 2 clean steps


def test_scheduler_from_config_and_set_lr():
    eng = _engine(_config(scheduler={"type": "WarmupDecayLR", "params": {
        "total_num_steps": 10, "warmup_num_steps": 2, "warmup_max_lr": 2e-3}}))
    sched = deepspeed_tpu_torch.ops.lr_schedules.WarmupDecayLR(10, warmup_num_steps=2,
                                                               warmup_max_lr=2e-3)
    for step in range(3):
        assert eng.get_lr()[0] == pytest.approx(float(sched.lr_at(step)))
        eng.train_batch(batch=_batch(seed=step))
    eng.set_lr(5e-3)
    assert eng.lr_scheduler.warmup_max_lr == 5e-3
    plain = _engine()
    plain.set_lr(4e-4)
    assert plain.get_lr() == [4e-4] and plain.optimizer.lr == 4e-4


def test_eval_batch_and_state_dict():
    eng = _engine()
    batch = _batch(seed=7)
    ev = eng.eval_batch(batch)
    assert not ev.requires_grad
    assert float(ev) == eng.forward(batch).item()
    sd = eng.module_state_dict()
    assert set(flatten_tree(sd)) == set(flatten_tree(eng.params))
    assert eng.eval()._train_mode is False and eng.train()._train_mode is True
    with pytest.raises(NotImplementedError, match="A.5"):
        eng.save_checkpoint("/nonexistent")
    with pytest.raises(NotImplementedError, match="A.5"):
        eng.load_checkpoint("/nonexistent")
    eng.destroy()
    assert flatten_tree(eng.module.params) == {}


def test_dataloader_matches_jax_and_engine_io():
    data = [{"input_ids": np.full(16, i, np.int32)} for i in range(10)]
    ours = [b["input_ids"] for b in DeepSpeedDataLoader(data, 4, shuffle=True, seed=3)]
    ref = [b["input_ids"] for b in JaxLoader(data, 4, shuffle=True, seed=3)]
    assert len(ours) == len(ref) == 2
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    eng, _, loader, _ = deepspeed_tpu_torch.initialize(
        model=port_model(**MODELS["gpt2"]), config=_config(train_batch_size=2),
        training_data=data, device="cpu")
    assert loader is eng.training_dataloader and loader.batch_size == 2
    it = RepeatingLoader(loader)
    losses = [float(eng.train_batch(data_iter=it)) for _ in range(6)]  # past one epoch
    assert all(np.isfinite(losses)) and eng.global_steps == 6


# -- the config ---------------------------------------------------------------------------

@pytest.mark.parametrize("bad", [
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 3},
    {"train_batch_size": 8, "train_micro_batch_size_per_gpu": 2,
     "gradient_accumulation_steps": 3},
    {"train_batch_size": 4, "fp16": {"enabled": True}, "bf16": {"enabled": True}},
    {"train_batch_size": -1},
    {},
], ids=["triangle", "triangle-3", "fp16+bf16", "negative", "no-batch"])
def test_config_errors_raise_like_jax(bad):
    from deepspeed_tpu.config.config import load_config as jax_load

    def probe(load, err):
        with pytest.raises(err):
            load(bad).resolve_batch_size(1)

    probe(jax_load, JaxConfigError)
    probe(load_config, ConfigError)


def test_missing_config_file_raises():
    with pytest.raises(ConfigError, match="not found"):
        load_config("/nonexistent/ds_config.json")


@pytest.mark.parametrize("block,item", [
    ({"zero_optimization": {"stage": 1}}, "A.7"),
    ({"zero_optimization": {"stage": 3}}, "A.7"),
    ({"mesh": {"data": 2}}, "A.7"),
    ({"mesh": {"model": 2}}, "A.7"),
    ({"elastic": {"enabled": True}}, "A.7"),
    ({"optimizer": {"type": "OneBitAdam"}}, "A.7"),
    ({"zero_optimization": {"offload_optimizer": {"device": "cpu"}}}, "A.8"),
    ({"zero_optimization": {"offload_param": {"device": "nvme"}}}, "A.8"),
    ({"telemetry": {"enabled": True}}, "A.3"),
    ({"health": {"enabled": True}}, "A.3"),
    ({"tensorboard": {"enabled": True}}, "A.3"),
    ({"wandb": {"enabled": True}}, "A.3"),
    ({"csv_monitor": {"enabled": True}}, "A.3"),
    ({"wall_clock_breakdown": True}, "A.3"),
    ({"comms_logger": {"enabled": True}}, "A.3"),
    ({"gradient_compression": {"enabled": True}}, "A.7"),
    ({"communication_data_type": "bf16"}, "A.7"),
    ({"compression_training": {"weight_quantization": {}}}, "A.9"),
    ({"curriculum_learning": {"enabled": True}}, "A.9"),
    ({"progressive_layer_drop": {"enabled": True}}, "A.9"),
    ({"hybrid_engine": {"enabled": True}}, "A.9"),
    ({"flops_profiler": {"enabled": True}}, "A.9"),
    ({"checkpoint": {"engine": "npz"}}, "A.5"),
], ids=lambda v: v if isinstance(v, str) else next(iter(v)))
def test_unported_blocks_raise_naming_their_item(block, item):
    with pytest.raises(NotImplementedError, match=item):
        deepspeed_tpu_torch.initialize(model=port_model(**MODELS["gpt2"]),
                                       config=_config(**block), device="cpu")


def test_blocks_left_off_are_accepted():
    eng = _engine(_config(tensorboard={"enabled": False}, telemetry={"output_path": "t"},
                          mesh={"data": 1},
                          zero_optimization={"stage": 0, "reduce_bucket_size": 10},
                          activation_checkpointing={"partition_activations": False}))
    assert eng.zero_optimization_stage() == 0


def test_initialize_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=CausalLM(port_model(**MODELS["gpt2"]).config),
                                       config=_config())
    with pytest.raises(ValueError, match="config"):
        deepspeed_tpu_torch.initialize(model=port_model(**MODELS["gpt2"]), device="cpu")
    with pytest.raises(NotImplementedError, match="A.7"):
        deepspeed_tpu_torch.initialize(model=port_model(**MODELS["gpt2"]), config=_config(),
                                       mesh=object(), device="cpu")
