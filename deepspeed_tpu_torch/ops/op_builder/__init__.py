"""Kernel libraries of the port, built from ``csrc/`` at first use."""

import threading

from .builder import CUDAOpBuilder, FlashAttentionBuilder  # noqa: F401

ALL_OPS = {FlashAttentionBuilder.NAME: FlashAttentionBuilder}

_LOADED = {}
_LOCK = threading.Lock()


def load_op(name):
    """The loaded ``ctypes`` library of kernel ``name`` (built on first call)."""
    with _LOCK:
        if name not in _LOADED:
            _LOADED[name] = ALL_OPS[name]().load()
        return _LOADED[name]


def build_all():
    """Build every kernel library at once (one nvcc per library, all started
    together) and load them. Returns the builders, which carry each build's
    seconds and nvcc's ptxas report."""
    builders = [cls() for cls in ALL_OPS.values()]
    started = [b.start() for b in builders]
    for b, s in zip(builders, started):
        b.finish(s)
    with _LOCK:
        for b in builders:
            if b.NAME not in _LOADED:
                _LOADED[b.NAME] = b.load()
    return builders
