"""Carry weights between the JAX package and the port.

The JAX params pytree arrives as a nested dict of **numpy** arrays (the
caller does ``jax.tree_util.tree_map(np.asarray, values)``; this module
never imports JAX). Keys are the JAX pytree paths (``wte/weight``,
``blocks/attn/q/kernel``, ...); stacked block leaves carry the leading layer
axis; linear kernels are ``[in, out]`` and used as ``x @ kernel`` on both
sides, so no leaf is transposed. Missing or extra keys and shape mismatches
raise. A tree that the JAX engine's weight-only quantization produced
(``kernel_q`` int8, ``kernel_q4`` uint8, ``kernel_scale`` fp32 in place of a
block ``kernel``) is taken as it is: the integer payloads keep their dtype
and the scales stay fp32, as the JAX engine stores them.
"""

import numpy as np
import torch

from ..models.layers import flatten_tree, tree_map, unflatten_tree


def stored_dtype(path, leaf, dtype):
    """The dtype leaf ``path`` is kept in when a tree is cast to ``dtype``:
    integer leaves (quantized payloads) and quantization scales keep their
    own, as the JAX engine keeps them; every other leaf takes ``dtype``
    (its own when ``dtype`` is None)."""
    if not leaf.is_floating_point() or path.endswith("/kernel_scale"):
        return leaf.dtype
    return dtype or leaf.dtype


def from_jax(values, model, dtype=None, device="cpu"):
    """JAX params (nested dict of numpy arrays) -> the port's params tree of
    tensors for ``model``, in ``dtype`` (default: each leaf's own) on ``device``;
    integer leaves and quantization scales keep their own dtype."""
    flat = flatten_tree(values)
    expected = model.param_shapes(like=flat)
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
        out[path] = t.to(device=device, dtype=stored_dtype(path, t, dtype))
    return unflatten_tree(out)


def to_jax(params):
    """The port's params tree -> nested dict of numpy arrays keyed like the
    JAX pytree (what ``from_jax`` takes back): floating leaves as float32,
    integer leaves (quantized payloads) in their own dtype."""
    return tree_map(lambda t: (t.detach().cpu().float() if t.is_floating_point()
                               else t.detach().cpu()).numpy(), params)


def load_jax_params(model, values, dtype=None, device="cpu"):
    """``from_jax`` into ``model``'s own weights."""
    model.load_params(from_jax(values, model, dtype=dtype, device=device))
    return model
