"""The port's block-sparse attention against the JAX package's, on the CPU:
the layouts and active lists (bitwise), the kernels' plain versions against
the Pallas kernels in interpret mode (forward and backward), the model's
``attention_impl="block_sparse"`` path (loss, grads, ``train_batch``,
``generate()``) on the same weights, and the errors both sides raise."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.ops import sparse_attention as JSA
from deepspeed_tpu.ops.pallas.block_sparse_attention import _active_lists as jax_active_lists
from deepspeed_tpu.parallel.topology import build_mesh
from deepspeed_tpu_torch.interop import from_jax
from deepspeed_tpu_torch.models.layers import flatten_tree
from deepspeed_tpu_torch.ops import sparse_attention as SA
from deepspeed_tpu_torch.ops.cuda import LAUNCH_COUNTS
from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import _active_lists
from tests.torch_port_util import jax_model, jax_values, port_model

# tests/unit/test_sparse_attention.py's block, length and pattern configs
BLK, SEQ = 16, 128
PATTERNS = {
    "dense": ("DenseSparsityConfig", {}),
    "fixed": ("FixedSparsityConfig", dict(num_local_blocks=2, num_global_blocks=1)),
    "bigbird": ("BigBirdSparsityConfig", dict(num_sliding_window_blocks=3, num_global_blocks=1,
                                              num_random_blocks=1)),
    "bslongformer": ("BSLongformerSparsityConfig", dict(num_sliding_window_blocks=3,
                                                        global_block_indices=(0,))),
    "variable": ("VariableSparsityConfig", dict(local_window_blocks=(2, 3), num_global_blocks=1)),
}

# a GPT-2-ish and a GQA LLaMA-ish model; at seq 64 the fixed pattern of
# 16-token blocks (2 local, 1 global) keeps 8 of the 10 causal blocks
MODELS = {
    "gpt2": dict(vocab_size=97, max_seq_len=64, n_layers=2, n_heads=2, d_model=32, d_ff=64),
    "llama-gqa": dict(vocab_size=97, max_seq_len=64, n_layers=2, n_heads=4, n_kv_heads=2,
                      d_model=32, d_ff=64, position_embedding="rope", norm="rmsnorm",
                      activation="swiglu", use_bias=False, tie_embeddings=False),
}
SPARSE = dict(attention_impl="block_sparse", sparse_pattern="fixed", sparse_block=16,
              sparse_pattern_config={"num_local_blocks": 2, "num_global_blocks": 1})


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def _configs(name, block=BLK):
    cls, kw = PATTERNS[name]
    return getattr(JSA, cls)(block=block, **kw), getattr(SA, cls)(block=block, **kw)


def _qkv(b=1, s=SEQ, h=2, d=16, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(rng.randn(b, s, h, d).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("s", [128, 1024])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "noncausal"])
@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_layouts_and_active_lists_match_jax(name, causal, s):
    """Layouts (BigBird's seeded random blocks, the causal clip and the
    forced diagonal included) and the forward and transposed active lists
    are bitwise JAX's, and the port's class holds them on its device."""
    jcfg, pcfg = _configs(name)
    layout = pcfg.layout_for(s, s, causal=causal)
    np.testing.assert_array_equal(layout, jcfg.layout_for(s, s, causal=causal))
    for lay in (layout, layout.T):
        for got, ref in zip(_active_lists(lay), jax_active_lists(lay)):
            np.testing.assert_array_equal(got, ref)
    attn = SA.BlockSparseAttention(pcfg, s, causal=causal)
    ref = JSA.BlockSparseAttention(jcfg, s, causal=causal, interpret=True)
    assert attn.density == ref.density
    np.testing.assert_array_equal(attn.lists.fwd_idx.numpy(), ref._fwd_idx)
    np.testing.assert_array_equal(attn.lists.fwd_cnt.numpy(), ref._fwd_cnt)
    np.testing.assert_array_equal(attn.lists.bwd_idx.numpy(), ref._bwd_idx)
    np.testing.assert_array_equal(attn.lists.bwd_cnt.numpy(), ref._bwd_cnt)
    assert (attn.lists.max_a, attn.lists.max_aq) == (ref._max_a, ref._max_aq)


# every pattern causal and not at head_dim 16; the fixed pattern, causal, at
# the registry's widths no other case has (80, 96, 256). Ids as pattern-causal.
_FWD_CASES = [pytest.param(name, causal, 16, id=f"{name}-{'causal' if causal else 'noncausal'}")
              for name in sorted(PATTERNS) for causal in (True, False)]
_FWD_CASES += [pytest.param("fixed", True, d, id=f"fixed-causal-d{d}") for d in (80, 96, 256)]


@pytest.mark.parametrize("name,causal,d", _FWD_CASES)
def test_plain_forward_matches_jax_interpret(name, causal, d):
    """The plain forward (o and the per-row lse) against the Pallas kernel
    in interpret mode: rtol/atol 2e-5 (fp32; the sums run in another
    order)."""
    jcfg, pcfg = _configs(name)
    q, k, v = _qkv(d=d)
    ref = JSA.BlockSparseAttention(jcfg, SEQ, causal=causal, interpret=True)
    ref_o, ref_lse = ref._forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    from deepspeed_tpu_torch.ops.cuda.block_sparse_attention import block_sparse_attention_fwd

    attn = SA.BlockSparseAttention(pcfg, SEQ, causal=causal)
    before = dict(LAUNCH_COUNTS)
    out, lse = block_sparse_attention_fwd(torch.tensor(q), torch.tensor(k), torch.tensor(v),
                                          attn.lists, causal=causal, return_lse=True)
    assert LAUNCH_COUNTS == before  # a CPU tensor takes the plain version
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), rtol=2e-5, atol=2e-5)
    # JAX's residual lse is [b*h, s, 1]; the port's [b, h, s]
    np.testing.assert_allclose(lse.numpy().reshape(-1), np.asarray(ref_lse).reshape(-1),
                               rtol=2e-5, atol=2e-5)
    torch.testing.assert_close(attn(torch.tensor(q), torch.tensor(k), torch.tensor(v)), out,
                               rtol=0, atol=0)


@pytest.mark.parametrize("name", ["fixed", "bigbird"])
def test_plain_backward_matches_jax_grad(name):
    """Grads of sum(attn(q, k, v) ** 2) through the port's autograd Function
    (the plain dQ and dK/dV) against ``jax.grad`` through the JAX class in
    interpret mode: rtol/atol 5e-4, as the JAX test holds its kernel
    against dense attention; at the tests' 16-token blocks and at 64-token
    blocks (the wgmma route's smallest, seq 256), the outputs too (2e-5)."""
    for block, seq in ((BLK, SEQ), (64, 256)):
        jcfg, pcfg = _configs(name, block)
        q, k, v = _qkv(s=seq, seed=5)
        ref_attn = JSA.BlockSparseAttention(jcfg, seq, causal=True, interpret=True)
        ref = jax.grad(lambda q, k, v: jnp.sum(ref_attn(q, k, v) ** 2), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
        attn = SA.BlockSparseAttention(pcfg, seq, causal=True)
        qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        out = attn(qt, kt, vt)
        np.testing.assert_allclose(out.detach().numpy(),
                                   np.asarray(ref_attn(*map(jnp.asarray, (q, k, v)))),
                                   rtol=2e-5, atol=2e-5)
        (out ** 2).sum().backward()
        for r, t in zip(ref, (qt, kt, vt)):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), rtol=5e-4, atol=5e-4)


def test_dense_pattern_through_causal_lm_equals_xla_attention():
    """``sparse_pattern="dense"`` through ``CausalLM.apply`` gives the port's
    dense (xla) attention's logits within 2e-5."""
    kw = MODELS["gpt2"]
    values = jax_values(jax_model(**kw), seed=0)
    ids = torch.as_tensor(np.random.RandomState(0).randint(0, 97, (2, 64)))
    logits = {}
    for impl in ("xla", "dense"):
        extra = {} if impl == "xla" else dict(attention_impl="block_sparse",
                                              sparse_pattern="dense", sparse_block=32)
        pm = port_model(**kw, **extra)
        pm.load_params(from_jax(values, pm))
        logits[impl] = pm.apply(pm.params, ids)
    torch.testing.assert_close(logits["dense"], logits["xla"], rtol=2e-5, atol=2e-5)


def _batch(b=4, s=64, vocab=97, seed=0):
    return {"input_ids": np.random.RandomState(seed).randint(0, vocab, (b, s)).astype(np.int32)}


@pytest.mark.parametrize("model", sorted(MODELS))
def test_fixed_pattern_loss_and_grads_match_jax(model):
    """The fixed pattern through ``CausalLM.loss``: the loss within rtol
    1e-5 and every leaf's grad within rtol 1e-4 / atol 2e-6 of
    ``jax.value_and_grad`` on the same weights (the JAX kernels in
    interpret mode); the GQA model repeats its kv heads before the call on
    both sides. ``remat`` (per-block recompute) gives the same grads."""
    kw = dict(MODELS[model], **SPARSE)
    jm = jax_model(**kw, attention_interpret=True)
    values = jax_values(jm, seed=1)
    batch = _batch()
    ref_loss, ref_grads = jax.value_and_grad(lambda p: jm.loss(p, batch))(
        jax.tree_util.tree_map(jnp.asarray, values))
    ref = flatten_tree(jax.tree_util.tree_map(np.asarray, ref_grads))
    for remat in (False, True):
        pm = port_model(**kw, remat=remat)
        pm.load_params(from_jax(values, pm), requires_grad=True)
        loss = pm.loss(pm.params, {"input_ids": torch.as_tensor(batch["input_ids"]).long()})
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), float(ref_loss), rtol=1e-5)
        for path, p in flatten_tree(pm.params).items():
            np.testing.assert_allclose(p.grad.numpy(), ref[path], rtol=1e-4, atol=2e-6,
                                       err_msg=f"{path} remat={remat}")


def test_fixed_pattern_three_train_batch_steps_match_jax():
    """Three ``train_batch`` steps (AdamW, clipping) of the fixed-pattern
    GPT-2-ish model against the JAX engine on one CPU device from the same
    init: every step's loss within rtol 2e-5."""
    kw = dict(MODELS["gpt2"], **SPARSE)
    config = {"train_batch_size": 4,
              "optimizer": {"type": "adamw", "params": {"lr": 1e-3, "weight_decay": 0.01}},
              "gradient_clipping": 1.0, "zero_optimization": {"stage": 0},
              "steps_per_print": 1000}
    jm = jax_model(**kw, attention_interpret=True)
    params = jm.init(jax.random.PRNGKey(4))
    jeng, *_ = deepspeed_tpu.initialize(model=jm, config=config, model_parameters=params,
                                        mesh=build_mesh(devices=jax.devices()[:1]))
    values = jax.tree_util.tree_map(np.asarray,
                                    deepspeed_tpu.models.split_params_axes(params)[0])
    peng, *_ = deepspeed_tpu_torch.initialize(model=port_model(**kw), config=config,
                                              model_parameters=values, device="cpu")
    losses = []
    for step in range(3):
        batch = _batch(seed=10 + step)
        ref = float(jeng.train_batch(batch=batch))
        losses.append(float(peng.train_batch(batch=batch)))
        np.testing.assert_allclose(losses[-1], ref, rtol=2e-5, err_msg=f"step {step}")
    assert all(np.isfinite(losses))


def test_generate_of_a_block_sparse_config_matches_jax():
    """Serving does not read ``attention_impl`` on either side: a
    block-sparse config's ``generate()`` (dense causal prefill and decode)
    gives JAX's greedy tokens on the same weights."""
    kw = dict(MODELS["gpt2"], **SPARSE)
    config = {"dtype": "float32", "max_tokens": 64}
    jm = jax_model(**kw)
    values = jax_values(jm, 3)
    je = deepspeed_tpu.init_inference(jm, config=dict(config))
    je.params = values
    te = deepspeed_tpu_torch.init_inference(port_model(**kw), config=dict(config), device="cpu")
    te.params = values
    prompt = np.random.RandomState(1).randint(0, 97, (2, 11)).astype(np.int32)
    ref = np.asarray(je.generate(prompt, max_new_tokens=6, greedy=True))
    np.testing.assert_array_equal(te.generate(prompt, max_new_tokens=6, greedy=True).numpy(), ref)


def test_error_cases_match_jax():
    """A sequence that does not divide the block, and a layout that leaves
    a query block nothing to attend, raise ``ValueError`` on both sides."""
    jcfg, pcfg = _configs("fixed")
    for cls, cfg, kw in ((JSA.BlockSparseAttention, jcfg, {"interpret": True}),
                         (SA.BlockSparseAttention, pcfg, {})):
        with pytest.raises(ValueError, match="must divide block"):
            cls(cfg, SEQ + 8, **kw)

    def no_diag(base):
        @dataclasses.dataclass
        class NoDiag(base):
            def make_layout(self, nq, nkv):
                return np.zeros((nq, nkv), bool)

            def layout_for(self, sq, skv, causal=True):
                # skips the forced diagonal, as tests/unit/test_sparse_attention.py does
                layout = self.make_layout(sq // self.block, skv // self.block)
                if not layout.any(axis=1).all():
                    raise ValueError("sparsity layout leaves a query block with no "
                                     "attendable kv block")
                return layout
        return NoDiag(block=BLK)

    with pytest.raises(ValueError, match="no attendable"):
        JSA.BlockSparseAttention(no_diag(JSA.DenseSparsityConfig), SEQ, interpret=True)
    with pytest.raises(ValueError, match="no attendable"):
        SA.BlockSparseAttention(no_diag(SA.DenseSparsityConfig), SEQ)
    # the model path: a 40-token batch against 16-token blocks
    pm = port_model(**MODELS["gpt2"], **SPARSE)
    pm.load_params(pm.init(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="must divide block"):
        pm.apply(pm.params, torch.zeros((1, 40), dtype=torch.long))
