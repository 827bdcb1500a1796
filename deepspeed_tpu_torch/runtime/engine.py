"""Training engine (port of ``deepspeed_tpu/runtime/engine.py``) at ZeRO stage 0 on one device.

``DeepSpeedEngine`` holds the model's fp32 master weights as trainable
parameters on its device, runs each micro-batch's loss in the config's
compute dtype (bf16 / fp16 / fp32: the model casts the masters per use),
accumulates the fp32 grads on the masters through autograd, and applies the
optimizer at the accumulation boundary as the JAX engine's ``_apply_body``
does: unscale, overflow check (fp16), global norm, clip, update, skip on
overflow, loss-scale update. The lr scheduler steps only on a step that was
not skipped.

``forward`` returns a micro-batch's loss with its graph kept, ``backward``
back-propagates ``loss * scale / gas`` into the masters' grads, ``step``
applies; ``train_batch`` runs the whole accumulation window and returns the
mean micro-batch loss as a device scalar (not synchronised; fp16 reads its
overflow flag on the host each step, as the JAX engine does).

Distribution (ZeRO 1-3, the mesh, pipelines, 1-bit optimizers; ROADMAP A.7),
offload (A.8), checkpoints (A.5) and the telemetry / health / monitor blocks
(A.3) raise ``NotImplementedError`` naming their item.
"""

import gc
import json

import numpy as np
import torch

from ..accelerator import get_accelerator
from ..config.base import ConfigError
from ..config.config import load_config
from ..inference.engine import DTYPES
from ..models.layers import flatten_tree, tree_map, unflatten_tree
from ..ops.loss_scaler import (check_overflow, clip_grads_by_global_norm, global_grad_norm,
                               make_scaler_state, update_scale)
from ..ops.lr_schedules import get_lr_schedule
from ..ops.optimizers import get_optimizer
from ..utils import not_ported
from ..utils.logging import log_dist
from .dataloader import DeepSpeedDataLoader


class DeepSpeedEngine:
    def __init__(self, model, optimizer=None, model_parameters=None, training_data=None,
                 lr_scheduler=None, collate_fn=None, config=None, device=None):
        if model is None:
            raise ConfigError("deepspeed_tpu_torch.initialize: model is required")
        self.device = get_accelerator().resolve_device(device)
        self.module = model
        self.client_optimizer = optimizer
        self._config = load_config(config)
        self.dp_world_size = 1

        # -- batch triangle (one device: dp 1) -----------------------------------------
        (self.train_batch_size_, self.micro_batch_size,
         self.gradient_accumulation_steps_) = self._config.resolve_batch_size(self.dp_world_size)

        # -- precision -----------------------------------------------------------------
        self.compute_dtype = DTYPES[self._config.mixed_precision_dtype]
        if hasattr(model, "config") and hasattr(model.config, "compute_dtype"):
            model.config.compute_dtype = self.compute_dtype
        if self._config.gradient_checkpointing and hasattr(model, "config") \
                and hasattr(model.config, "remat"):
            model.config.remat = True
        self.fp16_enabled = self._config.fp16.enabled
        self.zero_stage = self._config.zero_optimization.stage

        self._init_parameters(model_parameters)
        self._configure_optimizer()

        # -- lr scheduler --------------------------------------------------------------
        self.lr_scheduler = lr_scheduler
        if self.lr_scheduler is None and self._config.scheduler.type:
            self.lr_scheduler = get_lr_schedule(self._config.scheduler.type,
                                                self._config.scheduler.params)

        # -- fp16 loss scaler ----------------------------------------------------------
        fp16 = self._config.fp16
        self._scaler_meta = make_scaler_state(
            static_scale=fp16.loss_scale, initial_scale_power=fp16.initial_scale_power,
            min_scale=fp16.min_loss_scale) if self.fp16_enabled else None
        if self.fp16_enabled:
            self._scale = self._scaler_meta["scale"].to(self.device)
            self._good_steps = self._scaler_meta["good_steps"].to(self.device)
        else:
            self._scale = torch.tensor(1.0, dtype=torch.float32, device=self.device)
            self._good_steps = torch.zeros((), dtype=torch.int32, device=self.device)

        self._cached = None  # the last forward's loss, graph kept for backward()
        self.global_steps = 0
        self.micro_steps = 0
        self.skipped_steps = 0
        self._train_mode = True
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = self.deepspeed_io(training_data, collate_fn=collate_fn)
        if self._config.dump_state:
            log_dist("config state:\n" + json.dumps(self._config.to_dict(), indent=2,
                                                   default=str), ranks=[0])
        log_dist(f"DeepSpeedEngine: device={self.device} dtype="
                 f"{self._config.mixed_precision_dtype} batch(total, micro, gas)="
                 f"({self.train_batch_size_}, {self.micro_batch_size}, "
                 f"{self.gradient_accumulation_steps_}) params "
                 f"{self.num_parameters / 1e6:.2f}M", ranks=[0])

    # ------------------------------------------------------------------------------
    def _init_parameters(self, model_parameters):
        """fp32 masters on the device: drawn from the config's seed, or the
        given params (a port tree of tensors, or the JAX params pytree of
        numpy arrays, as ``(values, axes)`` too)."""
        if isinstance(model_parameters, tuple) and len(model_parameters) == 2:
            model_parameters = model_parameters[0]
        if model_parameters is None:
            gen = torch.Generator(device=self.device).manual_seed(self._config.seed)
            with torch.no_grad():
                params = self.module.init(gen, dtype=torch.float32, device=self.device)
        elif all(isinstance(v, torch.Tensor) for v in flatten_tree(model_parameters).values()):
            # a copy: the engine updates its masters in place
            params = tree_map(lambda t: t.detach().to(self.device, torch.float32).clone(),
                              model_parameters)
        else:
            from ..interop.jax_params import from_jax

            params = from_jax(model_parameters, self.module, dtype=torch.float32,
                              device=self.device)
        self.module.load_params(params, requires_grad=True)
        self._shapes = {k: tuple(v.shape) for k, v in flatten_tree(params).items()}
        self.num_parameters = sum(int(np.prod(s)) for s in self._shapes.values())

    def _configure_optimizer(self):
        """The client optimizer, else one built from the config; its state
        on the masters. The weight-decay mask is the JAX engine's: every
        stored leaf of rank > 1 decays. Its comment says no decay on biases
        and norms, but block params are stacked [n_layers, ...], so block
        biases and LayerNorm params are rank 2 and decay too; only top-level
        1-D leaves (``ln_f``) do not. Mirrored as it is (ROADMAP.md C)."""
        if self.client_optimizer is not None:
            self.optimizer = self.client_optimizer
        else:
            opt_cfg = self._config.optimizer
            self.optimizer = get_optimizer(opt_cfg.type or "adamw", opt_cfg.params)
        self._wd_mask = unflatten_tree({k: len(s) > 1 for k, s in self._shapes.items()})
        self.optimizer_state = self.optimizer.init(self.params)

    @property
    def params(self):
        """The fp32 master weights (a tree of ``nn.Parameter``)."""
        return self.module.params

    def _to_device(self, batch):
        out = {}
        for k, v in batch.items():
            t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            if not t.is_floating_point():
                t = t.long()
            out[k] = t.to(self.device)
        return out

    def deepspeed_io(self, dataset, batch_size=None, collate_fn=None):
        """A shuffled loader of micro-batches over ``dataset``."""
        return DeepSpeedDataLoader(dataset, batch_size=batch_size or self.micro_batch_size,
                                   shuffle=True, seed=self._config.seed,
                                   collate_fn=collate_fn, rank=0, num_shards=1)

    # ------------------------------------------------------------------------------
    # train API
    # ------------------------------------------------------------------------------
    def __call__(self, batch):
        return self.forward(batch)

    def forward(self, batch):
        """One micro-batch's loss (fp32 scalar), its graph kept for ``backward``."""
        loss = self.module.loss(self.params, self._to_device(batch),
                                deterministic=not self._train_mode)
        self._cached = loss
        return loss

    def backward(self, loss=None):
        """Back-propagate the last forward's ``loss * scale / gas`` into the
        masters' fp32 grads (they accumulate over the window)."""
        if self._cached is None:
            raise RuntimeError("backward() called before forward()")
        cached, self._cached = self._cached, None
        (cached * self._scale / self.gradient_accumulation_steps_).backward()
        self.micro_steps += 1
        return loss if loss is not None else cached

    def is_gradient_accumulation_boundary(self):
        return self.micro_steps % self.gradient_accumulation_steps_ == 0

    def step(self):
        """Apply the optimizer at the accumulation boundary; returns the
        global grad norm (None off the boundary)."""
        if not self.is_gradient_accumulation_boundary():
            return None
        masters = flatten_tree(self.params)
        if all(p.grad is None for p in masters.values()):
            raise RuntimeError("step() called with no accumulated gradients")
        lr = self._current_lr()
        grads = {k: p.grad if p.grad is not None else torch.zeros_like(p)
                 for k, p in masters.items()}
        skipped, grad_norm = self._apply(grads, lr)
        for p in masters.values():
            p.grad = None
        self.global_steps += 1
        if skipped:
            self.skipped_steps += 1
            log_dist(f"step {self.global_steps}: fp16 overflow, skipping update (loss scale "
                     f"-> {float(self._scale)})", ranks=[0])
        elif self.lr_scheduler is not None:
            self.lr_scheduler.step()
        if self.global_steps % self._config.steps_per_print == 0:
            self._report_progress()
        return grad_norm

    @torch.no_grad()
    def _apply(self, grads, lr):
        """Unscale -> overflow check (fp16, read on the host) -> global norm
        -> clip -> optimizer update, skipped on overflow -> loss-scale
        update. Returns (skipped, grad norm)."""
        if self.fp16_enabled:
            inv = (1.0 / self._scale).float()
            grads = {k: g.float() * inv for k, g in grads.items()}
        else:
            # the scale is 1: unscaling would multiply by exactly 1.0
            grads = {k: g.float() for k, g in grads.items()}
        overflow = self.fp16_enabled and bool(check_overflow(grads))
        norm = global_grad_norm(grads)
        clip = self._config.gradient_clipping
        if clip > 0:
            grads, _ = clip_grads_by_global_norm(grads, clip, norm=norm)
        if not overflow:
            self.optimizer.update(unflatten_tree(grads), self.optimizer_state, self.params,
                                  lr=lr, wd_mask=self._wd_mask)
        if self.fp16_enabled and self._scaler_meta["_dynamic"]:
            fp16 = self._config.fp16
            self._scale, self._good_steps = update_scale(
                self._scale, self._good_steps, torch.tensor(overflow, device=self.device),
                loss_scale_window=fp16.loss_scale_window, min_scale=fp16.min_loss_scale)
        return overflow, norm

    def train_batch(self, data_iter=None, batch=None):
        """One optimizer step over ``gradient_accumulation_steps``
        micro-batches (``batch`` reused for each, else drawn from
        ``data_iter``); returns their mean loss as a device scalar."""
        if batch is None and data_iter is None:
            raise ValueError("train_batch needs a batch or a data iterator")
        losses = []
        for _ in range(self.gradient_accumulation_steps_):
            micro = batch if batch is not None else next(data_iter)
            loss = self.forward(micro)
            self.backward(loss)
            losses.append(loss.detach())
        self.step()
        return torch.stack(losses).mean() if len(losses) > 1 else losses[0]

    def eval_batch(self, batch):
        """The loss without grads (deterministic)."""
        with torch.no_grad():
            return self.module.loss(self.params, self._to_device(batch))

    def _current_lr(self):
        if self.lr_scheduler is not None:
            return self.lr_scheduler.get_last_lr()[0]
        return self.optimizer.lr

    def get_lr(self):
        return [self._current_lr()]

    def set_lr(self, lr):
        """Override the learning rate: the scheduler's base lr when one is
        attached, else the optimizer's; takes effect next step."""
        if self.lr_scheduler is not None and hasattr(self.lr_scheduler, "set_lr"):
            self.lr_scheduler.set_lr(lr)
        elif self.lr_scheduler is not None:
            raise ValueError(
                f"{type(self.lr_scheduler).__name__} does not support set_lr; "
                "drive the schedule through its own params")
        else:
            self.optimizer.lr = lr

    def train(self, mode=True):
        """torch-style mode flag: eval mode makes ``forward``/``train_batch``
        deterministic (no dropout)."""
        self._train_mode = bool(mode)
        return self

    def eval(self):
        return self.train(False)

    def destroy(self):
        """Release the masters, grads, optimizer state and the device memory
        they held. The engine is unusable afterwards."""
        self._cached = None
        self.optimizer_state = None
        self.module.set_tree({})
        gc.collect()
        get_accelerator().empty_cache()

    def _report_progress(self):
        log_dist(f"step={self.global_steps}, skipped={self.skipped_steps}, "
                 f"lr={self._current_lr():.3e}, loss_scale={float(self._scale):.1f}", ranks=[0])
        if self._config.memory_breakdown:
            stats = get_accelerator().memory_stats()
            if stats:
                log_dist(f"memory: {stats['bytes_in_use'] / 2**30:.2f} GiB in use / "
                         f"{stats['bytes_limit'] / 2**30:.2f} GiB", ranks=[0])

    # ------------------------------------------------------------------------------
    # config accessors
    # ------------------------------------------------------------------------------
    @property
    def config(self):
        return self._config

    def train_batch_size(self):
        return self.train_batch_size_

    def train_micro_batch_size_per_gpu(self):
        return self.micro_batch_size

    def gradient_accumulation_steps(self):
        return self.gradient_accumulation_steps_

    def zero_optimization_stage(self):
        return self.zero_stage

    @property
    def loss_scale(self):
        return float(self._scale)

    def get_global_grad_norm(self):
        """Norm of the grads accumulated so far in the window (0.0 when none)."""
        grads = [p.grad for p in flatten_tree(self.params).values() if p.grad is not None]
        return float(global_grad_norm(grads)) if grads else 0.0

    def module_state_dict(self):
        """The weights on the host, in the compute dtype, keyed like the
        params tree."""
        return tree_map(lambda p: p.detach().to("cpu", self.compute_dtype), self.params)

    def save_checkpoint(self, save_dir, tag=None, client_state=None):
        raise not_ported("DeepSpeedEngine.save_checkpoint", "A.5")

    def load_checkpoint(self, load_dir, tag=None, load_optimizer_states=True, verify=True):
        raise not_ported("DeepSpeedEngine.load_checkpoint", "A.5")
