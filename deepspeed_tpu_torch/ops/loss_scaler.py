"""fp16 loss scaling, overflow detection and global-norm clipping (port of ``deepspeed_tpu/ops/loss_scaler.py``).

The same functions on lists or dicts of tensors (a dict's values are its
leaves). The scaler state is a small dict of fp32 / int32 scalar tensors;
``update_scale`` is the JAX package's single-halve policy: halve on
overflow (bounded below), double after ``loss_scale_window`` clean steps
(bounded above).
"""

import torch


def _leaves(grads):
    if isinstance(grads, dict):
        from ..models.layers import flatten_tree

        return list(flatten_tree(grads).values())
    return list(grads)


def make_scaler_state(static_scale=0.0, initial_scale_power=16, min_scale=1.0):
    """Initial scaler state. ``static_scale > 0`` disables dynamic scaling
    (the ``fp16.loss_scale`` config key; 0 means dynamic)."""
    if static_scale and static_scale > 0:
        scale = float(static_scale)
        dynamic = False
    else:
        scale = float(2.0 ** initial_scale_power)
        dynamic = True
    return {
        "scale": torch.tensor(scale, dtype=torch.float32),
        "good_steps": torch.zeros((), dtype=torch.int32),
        "_dynamic": dynamic,
        "_min_scale": float(min_scale),
    }


def check_overflow(grads):
    """True (a bool tensor) iff any grad element is non-finite."""
    flags = [torch.logical_not(torch.isfinite(g).all()) for g in _leaves(grads)]
    return torch.stack(flags).any()


def update_scale(scale, good_steps, overflow, loss_scale_window=1000, hysteresis=2,
                 min_scale=1.0, max_scale=2.0 ** 32):
    """Dynamic scale update: on overflow halve (bounded below), else after
    ``loss_scale_window`` clean steps double (bounded above). Returns
    (new_scale, new_good_steps)."""
    del hysteresis  # single-halve policy, as in the JAX package
    grown = good_steps + 1 >= loss_scale_window
    new_scale = torch.where(
        overflow, torch.clamp(scale * 0.5, min=min_scale),
        torch.where(grown, torch.clamp(scale * 2.0, max=max_scale), scale))
    zero = torch.zeros_like(good_steps)
    new_good = torch.where(overflow, zero, torch.where(grown, zero, good_steps + 1))
    return new_scale, new_good


def global_grad_norm(grads, eps=1e-6):
    """fp32 L2 norm over every grad, ``sqrt(sum g^2 + eps)``."""
    sq = sum(torch.sum(torch.square(g.float())) for g in _leaves(grads))
    return torch.sqrt(sq + eps)


def clip_grads_by_global_norm(grads, max_norm, norm=None):
    """Scale every grad by ``min(1, max_norm / (norm + 1e-6))``. Returns
    (clipped grads in the input's structure, norm)."""
    if norm is None:
        norm = global_grad_norm(grads)
    factor = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
    if isinstance(grads, dict):
        from ..models.layers import tree_map

        return tree_map(lambda g: g * factor.to(g.dtype), grads), norm
    return [g * factor.to(g.dtype) for g in grads], norm
