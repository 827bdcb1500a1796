"""Optimizers (port of ``deepspeed_tpu/ops/optimizers.py``).

The JAX package's update math written on tensors: ``Adam`` (adam / adamw via
``adam_w_mode``, ``bias_correction``), ``Adagrad``, ``Lamb`` and ``SGD``,
with fp32 state (``step``, ``exp_avg``, ``exp_avg_sq``, ...) shaped like the
params. These are not ``torch.optim``: torch's AdamW applies the decay to
the weight before the Adam step (``p *= 1 - lr wd``), while the JAX package
adds ``wd * p`` to the Adam update (``p -= lr (update + wd p)``).

API as in JAX: ``state = opt.init(params)``, then
``params, state = opt.update(grads, state, params, lr=None, wd_mask=None)``
on nested dicts of tensors (``wd_mask``: the same tree of bools, True =
decay). Unlike JAX's pure functions, ``update`` writes the new params and
state into the given tensors in place (it saves a copy of every master and
moment) and returns them. Plain tensor updates outside any TPU kernel.
"""

import numpy as np
import torch

from ..models.layers import flatten_tree, tree_map
from ..utils import not_ported


def _zeros_like(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


class TorchOptimizer:
    """Base class: an update rule with tree-shaped state."""

    name = "base"

    def __init__(self, lr=1e-3, weight_decay=0.0):
        self.lr = lr
        self.weight_decay = weight_decay

    def init(self, params):
        raise NotImplementedError

    def update(self, grads, state, params, lr=None, wd_mask=None):
        raise NotImplementedError

    def hyperparams(self):
        return {k: v for k, v in self.__dict__.items() if not k.startswith("_")}

    def _leaves(self, grads, params, wd_mask, *state_trees):
        """(param, grad, decay, *state leaves) for every leaf of the trees."""
        g, p = flatten_tree(grads), flatten_tree(params)
        mask = flatten_tree(wd_mask) if wd_mask is not None else {k: True for k in p}
        states = [flatten_tree(t) for t in state_trees]
        return [(p[k], g[k], bool(mask[k]), *(s[k] for s in states)) for k in p]


class Adam(TorchOptimizer):
    """Adam / AdamW (``adam_w_mode``), as the JAX package's ``Adam``."""

    name = "adam"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0,
                 adam_w_mode=True, bias_correction=True):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.betas = tuple(betas)
        self.eps = eps
        self.adam_w_mode = adam_w_mode
        self.bias_correction = bias_correction

    def init(self, params):
        return {"step": torch.zeros((), dtype=torch.int32),
                "exp_avg": _zeros_like(params), "exp_avg_sq": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, wd_mask=None):
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        step = state["step"] + 1
        # the bias corrections in fp32, as JAX computes them, kept as host
        # floats (an fp32 value is exact as a Python float)
        n = np.float32(int(step))
        bc1 = float(np.float32(1.0) - np.float32(b1) ** n) if self.bias_correction else 1.0
        bc2 = float(np.float32(1.0) - np.float32(b2) ** n) if self.bias_correction else 1.0
        wd = self.weight_decay
        for p, g, decay, m, v in self._leaves(grads, params, wd_mask, state["exp_avg"],
                                                 state["exp_avg_sq"]):
            g32 = g.float()
            p32 = p.float()
            if not self.adam_w_mode and wd and decay:
                # classic Adam: L2 folded into the gradient
                g32 = g32 + wd * p32
            m.mul_(b1).add_((1.0 - b1) * g32)
            v.mul_(b2).add_((1.0 - b2) * g32 * g32)
            update = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            if self.adam_w_mode and wd and decay:
                update = update + wd * p32
            p.copy_(p32 - lr * update)
        state["step"] = step
        return params, state


class Adagrad(TorchOptimizer):
    name = "adagrad"

    def __init__(self, lr=1e-2, eps=1e-10, weight_decay=0.0):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.eps = eps

    def init(self, params):
        return {"step": torch.zeros((), dtype=torch.int32), "sum_sq": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, wd_mask=None):
        lr = self.lr if lr is None else lr
        for p, g, decay, s in self._leaves(grads, params, wd_mask, state["sum_sq"]):
            g32 = g.float()
            p32 = p.float()
            if self.weight_decay and decay:
                g32 = g32 + self.weight_decay * p32
            s.add_(g32 * g32)
            p.copy_(p32 - lr * g32 / (torch.sqrt(s) + self.eps))
        state["step"] = state["step"] + 1
        return params, state


class Lamb(TorchOptimizer):
    """LAMB: the Adam step rescaled per leaf by the trust ratio
    ||p|| / ||update||, clipped to [min_coeff, max_coeff]."""

    name = "lamb"

    def __init__(self, lr=1e-3, betas=(0.9, 0.999), eps=1e-6, weight_decay=0.0,
                 min_coeff=0.01, max_coeff=0.3):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.betas = tuple(betas)
        self.eps = eps
        self.min_coeff = min_coeff
        self.max_coeff = max_coeff

    def init(self, params):
        return {"step": torch.zeros((), dtype=torch.int32),
                "exp_avg": _zeros_like(params), "exp_avg_sq": _zeros_like(params)}

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, wd_mask=None):
        lr = self.lr if lr is None else lr
        b1, b2 = self.betas
        for p, g, decay, m, v in self._leaves(grads, params, wd_mask, state["exp_avg"],
                                                 state["exp_avg_sq"]):
            g32 = g.float()
            p32 = p.float()
            m.mul_(b1).add_((1.0 - b1) * g32)
            v.mul_(b2).add_((1.0 - b2) * g32 * g32)
            update = m / (torch.sqrt(v) + self.eps)
            if self.weight_decay and decay:
                update = update + self.weight_decay * p32
            w_norm = torch.linalg.vector_norm(p32)
            u_norm = torch.linalg.vector_norm(update)
            trust = torch.where((w_norm > 0) & (u_norm > 0),
                                torch.clamp(w_norm / u_norm, self.min_coeff, self.max_coeff),
                                torch.ones_like(w_norm))
            p.copy_(p32 - lr * trust * update)
        state["step"] = state["step"] + 1
        return params, state


class SGD(TorchOptimizer):
    name = "sgd"

    def __init__(self, lr=1e-2, momentum=0.0, weight_decay=0.0, nesterov=False):
        super().__init__(lr=lr, weight_decay=weight_decay)
        self.momentum = momentum
        self.nesterov = nesterov

    def init(self, params):
        if self.momentum:
            return {"step": torch.zeros((), dtype=torch.int32), "momentum": _zeros_like(params)}
        return {"step": torch.zeros((), dtype=torch.int32)}

    @torch.no_grad()
    def update(self, grads, state, params, lr=None, wd_mask=None):
        lr = self.lr if lr is None else lr
        bufs = (state["momentum"],) if self.momentum else ()
        for p, g, decay, *buf in self._leaves(grads, params, wd_mask, *bufs):
            g32 = g.float()
            p32 = p.float()
            if self.weight_decay and decay:
                g32 = g32 + self.weight_decay * p32
            if not self.momentum:
                p.copy_(p32 - lr * g32)
                continue
            buf[0].mul_(self.momentum).add_(g32)
            d = g32 + self.momentum * buf[0] if self.nesterov else buf[0]
            p.copy_(p32 - lr * d)
        state["step"] = state["step"] + 1
        return params, state


# Registry as in the JAX package: "adam" defaults to adam_w_mode=True (the
# reference FusedAdam's default); pass {"adam_w_mode": false} for L2 Adam.
OPTIMIZERS = {
    "adam": lambda params: Adam(**{"adam_w_mode": True, **params}),
    "adamw": lambda params: Adam(**{**params, "adam_w_mode": True}),
    "fusedadam": lambda params: Adam(**params),
    "lamb": lambda params: Lamb(**params),
    "fusedlamb": lambda params: Lamb(**params),
    "adagrad": lambda params: Adagrad(**params),
    "sgd": lambda params: SGD(**params),
}

_IGNORED_ARGS = {"torch_adam", "fused", "set_grad_none", "amsgrad", "freeze_step",
                 "cuda_aware", "comm_backend_name"}


def get_optimizer(name, params=None):
    """Resolve an optimizer by its config name (aliases, ignored args)."""
    key = name.lower().replace("_", "")
    if key in ("onebitadam", "zerooneadam", "onebitlamb"):
        raise not_ported(f"the 1-bit optimizer '{name}'", "A.7")
    if key not in OPTIMIZERS:
        raise ValueError(f"Unknown optimizer '{name}'. Available: {sorted(OPTIMIZERS)}")
    kwargs = {k: v for k, v in (params or {}).items() if k not in _IGNORED_ARGS}
    return OPTIMIZERS[key](kwargs)
