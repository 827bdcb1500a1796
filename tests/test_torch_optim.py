"""The port's optimizers, lr schedules and fp16 loss scaler against the JAX
package's, on the same numpy params, grads and flags."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops import loss_scaler as jls
from deepspeed_tpu.ops import lr_schedules as jlr
from deepspeed_tpu.ops import optimizers as jopt
from deepspeed_tpu_torch.ops import loss_scaler as pls
from deepspeed_tpu_torch.ops import lr_schedules as plr
from deepspeed_tpu_torch.ops import optimizers as popt


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _tree(seed, scale=1.0):
    r = np.random.RandomState(seed)
    return {"w": (scale * r.randn(6, 5)).astype(np.float32),
            "blocks": {"b": (scale * r.randn(2, 5)).astype(np.float32)},
            "ln": (scale * r.randn(5)).astype(np.float32)}


MASK = {"w": True, "blocks": {"b": True}, "ln": False}

OPTIMIZERS = {
    "adamw": ("adamw", {"lr": 1e-2, "weight_decay": 0.1}),
    "adam-l2": ("adam", {"lr": 1e-2, "weight_decay": 0.1, "adam_w_mode": False}),
    "adam-nobc": ("fusedadam", {"lr": 1e-2, "bias_correction": False, "betas": (0.8, 0.9)}),
    "adagrad": ("adagrad", {"lr": 1e-2, "weight_decay": 0.05}),
    "lamb": ("lamb", {"lr": 1e-2, "weight_decay": 0.01}),
    "sgd": ("sgd", {"lr": 1e-2, "weight_decay": 0.05}),
    "sgd-momentum": ("sgd", {"lr": 1e-2, "momentum": 0.9}),
    "sgd-nesterov": ("sgd", {"lr": 1e-2, "momentum": 0.9, "nesterov": True}),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_update_matches_jax(name):
    """Three updates on the same params and per-step grads, a decay mask
    with a no-decay leaf, the lr passed at update time on the last step:
    params and state within rtol 2e-6 / atol 1e-8 (fp32, another order of
    roundings)."""
    kind, hp = OPTIMIZERS[name]
    jo, po = jopt.get_optimizer(kind, hp), popt.get_optimizer(kind, hp)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    pp = {k: (torch.tensor(v) if not isinstance(v, dict) else
              {kk: torch.tensor(vv) for kk, vv in v.items()}) for k, v in _tree(0).items()}
    js, ps = jo.init(jp), po.init(pp)
    for step in range(3):
        g = _tree(10 + step, scale=0.1 * (step + 1))
        lr = 3e-3 if step == 2 else None
        jp, js = jo.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp, lr=lr, wd_mask=MASK)
        pg = {k: (torch.tensor(v) if not isinstance(v, dict) else
                  {kk: torch.tensor(vv) for kk, vv in v.items()}) for k, v in g.items()}
        pp, ps = po.update(pg, ps, pp, lr=lr, wd_mask=MASK)
    flat_j = jax.tree_util.tree_leaves_with_path({"params": jp, "state": js})
    from deepspeed_tpu_torch.models.layers import flatten_tree

    flat_p = flatten_tree({"params": pp, "state": ps})
    assert len(flat_j) == len(flat_p)
    for path, leaf in flat_j:
        key = "/".join(str(getattr(k, "key", k)) for k in path)
        got = flat_p[key]
        np.testing.assert_allclose(np.asarray(got, dtype=np.float64), np.asarray(leaf, np.float64),
                                   rtol=2e-6, atol=1e-8, err_msg=key)
    assert int(ps["step"]) == 3


def test_get_optimizer_aliases_and_ignored_args():
    assert popt.get_optimizer("adam", {}).adam_w_mode is True
    assert popt.get_optimizer("AdamW", {"adam_w_mode": False}).adam_w_mode is True
    assert popt.get_optimizer("fused_adam", {"adam_w_mode": False}).adam_w_mode is False
    opt = popt.get_optimizer("adam", {"lr": 2e-3, "torch_adam": True, "fused": True,
                                      "amsgrad": False})
    assert opt.lr == 2e-3
    assert isinstance(popt.get_optimizer("FusedLamb", {}), popt.Lamb)
    for name in ("OneBitAdam", "zerooneadam", "onebitlamb"):
        with pytest.raises(NotImplementedError, match="A.7"):
            popt.get_optimizer(name, {})
    with pytest.raises(ValueError, match="Unknown optimizer"):
        popt.get_optimizer("rmsprop", {})
    # hyperparams as the JAX optimizer reports them
    assert opt.hyperparams() == jopt.get_optimizer("adam", {"lr": 2e-3}).hyperparams()


SCHEDULES = [
    ("WarmupLR", {"warmup_min_lr": 1e-5, "warmup_max_lr": 1e-3, "warmup_num_steps": 10}),
    ("warmup_lr", {"warmup_num_steps": 7, "warmup_type": "linear"}),
    ("WarmupDecayLR", {"total_num_steps": 30, "warmup_num_steps": 5}),
    ("WarmupDecayLR", {"total_num_steps": 30, "warmup_num_steps": 5, "warmup_type": "linear"}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 5,
                  "decay_step_size": 3, "decay_lr_rate": 0.5}),
    ("OneCycle", {"cycle_min_lr": 1e-4, "cycle_max_lr": 1e-2, "cycle_first_step_size": 4,
                  "cycle_second_step_size": 6}),
    ("LRRangeTest", {"lr_range_test_step_size": 4, "lr_range_test_staircase": True}),
    ("LRRangeTest", {"lr_range_test_min_lr": 1e-4, "lr_range_test_step_rate": 2.0}),
]


@pytest.mark.parametrize("name,params", SCHEDULES, ids=[f"{n}-{i}" for i, (n, _) in
                                                        enumerate(SCHEDULES)])
def test_lr_at_matches_jax_every_step(name, params):
    """Both evaluate the schedule's formula in fp32; libm's log may differ
    from XLA's in the last bit: rtol 1e-6 at every step 0..40."""
    js, ps = jlr.get_lr_schedule(name, params), plr.get_lr_schedule(name, params)
    for step in range(41):
        ref = float(js.lr_at(jnp.asarray(step, jnp.float32)))
        np.testing.assert_allclose(float(ps.lr_at(step)), ref, rtol=1e-6, atol=0,
                                   err_msg=f"step {step}")
    if name == "OneCycle":
        for step in range(20):
            np.testing.assert_allclose(float(ps.mom_at(step)),
                                       float(js.mom_at(jnp.asarray(step, jnp.float32))),
                                       rtol=1e-6)


def test_schedule_object_api():
    ps = plr.get_lr_schedule("WarmupLR", {"warmup_max_lr": 1e-2, "warmup_num_steps": 4,
                                          "warmup_type": "linear"})
    assert ps.get_last_lr() == [0.0]
    ps.step()
    ps.step(2)
    assert ps.last_step == 3 and ps.get_last_lr()[0] == pytest.approx(7.5e-3)
    ps.set_lr(2e-2)
    assert ps.warmup_max_lr == 2e-2
    sd = ps.state_dict()
    other = plr.WarmupLR()
    other.load_state_dict(sd)
    assert other.last_step == 3
    with pytest.raises(ValueError, match="Unknown LR schedule"):
        plr.get_lr_schedule("cosine")


def test_scaler_state_and_update_scale_match_jax():
    """A sequence of overflow flags through the dynamic scaler (window 3,
    min scale 2): the same scales and clean-step counts, exactly."""
    for static in (0.0, 128.0):
        j = jls.make_scaler_state(static, 4, 2.0)
        p = pls.make_scaler_state(static, 4, 2.0)
        assert float(p["scale"]) == float(j["scale"]) and p["_dynamic"] == j["_dynamic"]
    js, jg = jnp.asarray(16.0, jnp.float32), jnp.zeros((), jnp.int32)
    ps, pg = torch.tensor(16.0), torch.zeros((), dtype=torch.int32)
    flags = [False, True, True, True, True, False, False, False, False, False, False, True]
    for f in flags:
        js, jg = jls.update_scale(js, jg, jnp.asarray(f), loss_scale_window=3, min_scale=2.0,
                                  max_scale=64.0)
        ps, pg = pls.update_scale(ps, pg, torch.tensor(f), loss_scale_window=3, min_scale=2.0,
                                  max_scale=64.0)
        assert float(ps) == float(js) and int(pg) == int(jg)


def test_overflow_norm_and_clip_match_jax():
    g = _tree(3)
    jg = jax.tree_util.tree_map(jnp.asarray, g)
    from deepspeed_tpu_torch.models.layers import tree_map

    pg = tree_map(torch.tensor, g)
    assert not bool(pls.check_overflow(pg)) and not bool(jls.check_overflow(jg))
    for bad in (np.inf, -np.inf, np.nan):
        pb = tree_map(torch.clone, pg)
        pb["blocks"]["b"][1, 2] = bad
        assert bool(pls.check_overflow(pb))
        assert bool(pls.check_overflow([pb["w"], pb["blocks"]["b"]]))
    np.testing.assert_allclose(float(pls.global_grad_norm(pg)), float(jls.global_grad_norm(jg)),
                               rtol=1e-6)
    for max_norm in (0.5, 1e3):
        pc, pn = pls.clip_grads_by_global_norm(pg, max_norm)
        jc, jn = jls.clip_grads_by_global_norm(jg, max_norm)
        np.testing.assert_allclose(float(pn), float(jn), rtol=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves(jc),
                        [pc["blocks"]["b"], pc["ln"], pc["w"]]):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-8)
