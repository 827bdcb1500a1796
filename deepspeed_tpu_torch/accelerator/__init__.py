"""Accelerator selection (port of ``deepspeed_tpu/accelerator/__init__.py``)."""

from .abstract_accelerator import DeepSpeedAccelerator  # noqa: F401
from .cuda_accelerator import CUDA_Accelerator  # noqa: F401

_accelerator = None


def get_accelerator():
    global _accelerator
    if _accelerator is None:
        _accelerator = CUDA_Accelerator()
    return _accelerator


def set_accelerator(accel):
    """Register an out-of-tree accelerator BEFORE first use."""
    global _accelerator
    if _accelerator is not None and _accelerator is not accel:
        raise RuntimeError(
            "set_accelerator called after get_accelerator; register the "
            "backend before any framework component touches the platform")
    _accelerator = accel


__all__ = ["DeepSpeedAccelerator", "CUDA_Accelerator", "get_accelerator",
           "set_accelerator"]
