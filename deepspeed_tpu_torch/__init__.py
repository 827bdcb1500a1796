"""deepspeed_tpu_torch — the PyTorch + CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, written for an NVIDIA H100: plain
tensor code is PyTorch, and every TPU kernel on a ported path is a kernel
written by hand for Hopper (``csrc/``). It imports neither ``jax`` nor
``deepspeed_tpu``. The port goes slice by slice (ROADMAP.md queue A); this
package currently serves ``init_inference(...).generate(...)`` for the
dense decoder families.
"""

__version__ = "0.1.0"

from .accelerator import get_accelerator, set_accelerator  # noqa: F401
from .config import ConfigError  # noqa: F401


def init_inference(model=None, config=None, device=None, **kwargs):
    """Build an inference engine (counterpart of ``deepspeed_tpu.init_inference``).

    ``device`` defaults to the CUDA device and raises when there is none;
    pass ``device="cpu"`` to run on the CPU. ``device`` is a parameter of
    its own, never merged into the config, so the same JSON resolves to the
    same config values as in the JAX package.
    """
    from .inference.config import DeepSpeedInferenceConfig
    from .inference.engine import InferenceEngine
    from .utils import not_ported

    if isinstance(config, DeepSpeedInferenceConfig):
        ds_config = config
    else:
        merged = dict(config or {})
        merged.update(kwargs)
        ds_config = DeepSpeedInferenceConfig.from_dict(merged)

    if isinstance(model, str):
        raise not_ported("serving a checkpoint directory (model given as a path)", "A.5")
    return InferenceEngine(model, ds_config, device=device)
