"""Carry weights between the JAX package and the port.

The JAX params pytree arrives as a nested dict of **numpy** arrays (the
caller does ``jax.tree_util.tree_map(np.asarray, values)``; this module
never imports JAX). Keys are the JAX pytree paths (``wte/weight``,
``blocks/attn/q/kernel``, ...); stacked block leaves carry the leading layer
axis; linear kernels are ``[in, out]`` and used as ``x @ kernel`` on both
sides, so no leaf is transposed. Missing or extra keys and shape mismatches
raise.
"""

import numpy as np
import torch

from ..models.layers import flatten_tree, tree_map, unflatten_tree


def from_jax(values, model, dtype=None, device="cpu"):
    """JAX params (nested dict of numpy arrays) -> the port's params tree of
    tensors for ``model``, in ``dtype`` (default: each leaf's own) on ``device``."""
    expected = model.param_shapes()
    flat = flatten_tree(values)
    missing = sorted(set(expected) - set(flat))
    extra = sorted(set(flat) - set(expected))
    if missing or extra:
        raise ValueError(f"JAX params do not match the model: missing {missing}, "
                         f"unexpected {extra}")
    out = {}
    for path, leaf in flat.items():
        arr = np.asarray(leaf)
        if tuple(arr.shape) != expected[path]:
            raise ValueError(f"{path}: JAX shape {tuple(arr.shape)}, port expects "
                             f"{expected[path]}")
        t = torch.from_numpy(np.array(arr, copy=True))
        out[path] = t.to(device=device, dtype=dtype or t.dtype)
    return unflatten_tree(out)


def to_jax(params):
    """The port's params tree -> nested dict of float32 numpy arrays keyed
    like the JAX pytree (what ``from_jax`` takes back)."""
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy(), params)


def load_jax_params(model, values, dtype=None, device="cpu"):
    """``from_jax`` into ``model``'s own weights."""
    model.load_params(from_jax(values, model, dtype=dtype, device=device))
    return model
