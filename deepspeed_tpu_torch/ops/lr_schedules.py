"""Learning-rate schedules (port of ``deepspeed_tpu/ops/lr_schedules.py``).

``WarmupLR``, ``WarmupDecayLR``, ``OneCycle`` and ``LRRangeTest``: each
``lr_at(step)`` is the JAX schedule's formula evaluated in fp32, so it gives
the JAX value at every step; the object keeps the torch-scheduler-shaped
``step()`` / ``get_last_lr()`` API.
"""

import math

import torch

WARMUP_LOG_RATE = "log"
WARMUP_LINEAR_RATE = "linear"


def _f32(x):
    return torch.as_tensor(x, dtype=torch.float32)


class LRSchedule:
    """Stateful wrapper with the torch-scheduler-shaped API."""

    def __init__(self):
        self.last_step = 0

    def lr_at(self, step):
        raise NotImplementedError

    def step(self, increment=1):
        self.last_step += increment
        return self.get_last_lr()

    def get_last_lr(self):
        return [float(self.lr_at(self.last_step))]

    def state_dict(self):
        return {"last_step": self.last_step}

    def load_state_dict(self, sd):
        self.last_step = sd["last_step"]

    def set_lr(self, lr):
        """Override the schedule's peak/base lr (``engine.set_lr``)."""
        for attr in ("warmup_max_lr", "max_lr", "min_lr"):
            if hasattr(self, attr):
                setattr(self, attr, lr)
                return
        raise ValueError(f"{type(self).__name__} has no overridable base lr")


class WarmupLR(LRSchedule):
    """Linear/log warmup then constant."""

    def __init__(self, warmup_min_lr=0.0, warmup_max_lr=0.001, warmup_num_steps=1000,
                 warmup_type=WARMUP_LOG_RATE):
        super().__init__()
        self.warmup_min_lr = warmup_min_lr
        self.warmup_max_lr = warmup_max_lr
        self.warmup_num_steps = max(warmup_num_steps, 2)
        self.warmup_type = warmup_type
        self.inverse_log_warm_up = 1.0 / math.log(self.warmup_num_steps)

    def _warmup_factor(self, step):
        if self.warmup_type == WARMUP_LOG_RATE:
            return self.inverse_log_warm_up * torch.log(torch.clamp(step, min=1.0))
        return step / self.warmup_num_steps

    def lr_at(self, step):
        step = _f32(step)
        factor = torch.clamp(self._warmup_factor(step), 0.0, 1.0)
        return self.warmup_min_lr + (self.warmup_max_lr - self.warmup_min_lr) * factor


class WarmupDecayLR(WarmupLR):
    """Warmup then linear decay to zero over ``total_num_steps``."""

    def __init__(self, total_num_steps, warmup_min_lr=0.0, warmup_max_lr=0.001,
                 warmup_num_steps=1000, warmup_type=WARMUP_LOG_RATE):
        super().__init__(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)
        self.total_num_steps = total_num_steps

    def lr_at(self, step):
        step = _f32(step)
        warmup_lr = super().lr_at(step)
        decay = torch.clamp(
            (self.total_num_steps - step)
            / max(self.total_num_steps - self.warmup_num_steps, 1), 0.0, 1.0)
        return torch.where(step < self.warmup_num_steps, warmup_lr,
                           self.warmup_max_lr * decay)


class OneCycle(LRSchedule):
    """Triangular cycle then decay."""

    def __init__(self, cycle_min_lr, cycle_max_lr, cycle_first_step_size=2000,
                 cycle_second_step_size=None, decay_step_size=0,
                 decay_lr_rate=0.0, cycle_first_stair_count=0,
                 cycle_second_stair_count=None, cycle_momentum=False,
                 cycle_min_mom=0.8, cycle_max_mom=0.9, decay_mom_rate=0.0):
        super().__init__()
        self.cycle_min_lr = cycle_min_lr
        self.cycle_max_lr = cycle_max_lr
        self.first_size = cycle_first_step_size
        self.second_size = cycle_second_step_size or cycle_first_step_size
        self.decay_step_size = decay_step_size
        self.decay_lr_rate = decay_lr_rate
        self.cycle_momentum = cycle_momentum
        self.cycle_min_mom = cycle_min_mom
        self.cycle_max_mom = cycle_max_mom

    def lr_at(self, step):
        step = _f32(step)
        total_cycle = self.first_size + self.second_size
        up = torch.clamp(step / self.first_size, 0.0, 1.0)
        down = torch.clamp((step - self.first_size) / self.second_size, 0.0, 1.0)
        in_cycle_lr = torch.where(
            step <= self.first_size,
            self.cycle_min_lr + (self.cycle_max_lr - self.cycle_min_lr) * up,
            self.cycle_max_lr - (self.cycle_max_lr - self.cycle_min_lr) * down,
        )
        if self.decay_step_size > 0:
            decay_steps = torch.clamp(step - total_cycle, min=0.0) / self.decay_step_size
            decay_lr = self.cycle_min_lr / (1.0 + decay_steps * self.decay_lr_rate)
            return torch.where(step > total_cycle, decay_lr, in_cycle_lr)
        return in_cycle_lr

    def mom_at(self, step):
        step = _f32(step)
        up = torch.clamp(step / self.first_size, 0.0, 1.0)
        down = torch.clamp((step - self.first_size) / self.second_size, 0.0, 1.0)
        return torch.where(
            step <= self.first_size,
            self.cycle_max_mom - (self.cycle_max_mom - self.cycle_min_mom) * up,
            self.cycle_min_mom + (self.cycle_max_mom - self.cycle_min_mom) * down,
        )


class LRRangeTest(LRSchedule):
    """LR range test sweep."""

    def __init__(self, lr_range_test_min_lr=1e-3, lr_range_test_step_size=2000,
                 lr_range_test_step_rate=1.0, lr_range_test_staircase=False):
        super().__init__()
        self.min_lr = lr_range_test_min_lr
        self.step_size = lr_range_test_step_size
        self.step_rate = lr_range_test_step_rate
        self.staircase = lr_range_test_staircase

    def lr_at(self, step):
        step = _f32(step)
        interval = (torch.floor(step / self.step_size) if self.staircase
                    else step / self.step_size)
        return self.min_lr * (1.0 + interval * self.step_rate)


SCHEDULES = {
    "warmuplr": WarmupLR,
    "warmupdecaylr": WarmupDecayLR,
    "onecycle": OneCycle,
    "lrrangetest": LRRangeTest,
}


def get_lr_schedule(name, params=None):
    """Resolve a schedule by its config name."""
    key = name.lower().replace("_", "")
    if key not in SCHEDULES:
        raise ValueError(f"Unknown LR schedule '{name}'. Available: {sorted(SCHEDULES)}")
    return SCHEDULES[key](**(params or {}))
