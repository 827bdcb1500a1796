"""Shared set-up of the parity tests between ``deepspeed_tpu`` (JAX) and
``deepspeed_tpu_torch``: one tiny model config built on both sides, the
JAX params handed to the port as numpy arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from deepspeed_tpu.models import CausalLM as JaxCausalLM
from deepspeed_tpu.models import TransformerConfig as JaxConfig
from deepspeed_tpu.models import split_params_axes
from deepspeed_tpu_torch.interop import load_jax_params
from deepspeed_tpu_torch.models import CausalLM, TransformerConfig

# the dims of tests/unit/test_inference.py:cfg_variant
BASE = dict(vocab_size=64, max_seq_len=64, n_layers=2, n_heads=4, d_model=16, d_ff=32)

VARIANTS = {
    "gpt2ish": dict(),  # learned positions, LayerNorm, gelu, biases, tied head
    "llamaish": dict(position_embedding="rope", norm="rmsnorm", activation="swiglu",
                     use_bias=False, tie_embeddings=False),
    "bloomish": dict(position_embedding="alibi"),
    "gptjish": dict(parallel_attn_mlp=True, position_embedding="rope"),
    "gqa": dict(n_kv_heads=2, position_embedding="rope"),
    # GPT-J proper: partial + interleaved rotary, biased untied head
    "gptj-partial": dict(parallel_attn_mlp=True, position_embedding="rope", rotary_dim=2,
                         rotary_interleaved=True, tie_embeddings=False, head_bias=True,
                         use_bias=False, mlp_bias=True),
}


def jax_model(**kw):
    return JaxCausalLM(JaxConfig(**{**BASE, **kw, "compute_dtype": jnp.float32}))


def port_model(**kw):
    return CausalLM(TransformerConfig(**{**BASE, **kw, "compute_dtype": torch.float32}))


def jax_values(model, seed):
    """JAX-initialised params as a nested dict of numpy arrays."""
    values, _ = split_params_axes(model.init(jax.random.PRNGKey(seed)))
    return jax.tree_util.tree_map(np.asarray, values)


def pair(kw, seed=0):
    """(jax model, numpy params, port model holding the same params)."""
    jm = jax_model(**kw)
    values = jax_values(jm, seed)
    pm = port_model(**kw)
    load_jax_params(pm, values)
    return jm, values, pm
