"""deepspeed_tpu_torch — the PyTorch + CUDA port of ``deepspeed_tpu``.

A second package beside the JAX one, written for an NVIDIA H100: plain
tensor code is PyTorch, and every TPU kernel on a ported path is a kernel
written by hand for Hopper (``csrc/``). It imports neither ``jax`` nor
``deepspeed_tpu``. The port goes slice by slice (ROADMAP.md queue A); this
package currently serves ``init_inference(...).generate(...)`` and the
continuous-batching ``init_inference(...).serve(...)`` (``serving/``) for
the dense decoder families, with int8/int4 weight-only quantization
(``quant``) and an int8 paged KV pool (``kv_pool.kv_dtype="int8"``) as
options, and trains them with
``initialize(...)`` -> ``engine.train_batch(...)`` at ZeRO stage 0 on one
device (``runtime/``).
"""

__version__ = "0.1.0"

from .accelerator import get_accelerator, set_accelerator  # noqa: F401
from .config import ConfigError, DeepSpeedConfig, load_config  # noqa: F401


def initialize(args=None, model=None, optimizer=None, model_parameters=None,
               training_data=None, lr_scheduler=None, mesh=None, collate_fn=None,
               config=None, config_params=None, device=None):
    """Build a training engine (counterpart of ``deepspeed_tpu.initialize``).

    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    ``device`` defaults to the CUDA device and raises when there is none;
    pass ``device="cpu"`` to train on the CPU. A ``mesh`` is distribution
    (ROADMAP A.7)."""
    from .runtime.engine import DeepSpeedEngine
    from .utils import not_ported

    config = config if config is not None else config_params
    if config is None and args is not None:
        config = getattr(args, "deepspeed_config", None)
    if config is None:
        raise ValueError("deepspeed_tpu_torch.initialize requires a config (dict or JSON path)")
    if mesh is not None:
        raise not_ported("initialize(mesh=...) (a device mesh)", "A.7")
    engine = DeepSpeedEngine(model=model, optimizer=optimizer,
                             model_parameters=model_parameters, training_data=training_data,
                             lr_scheduler=lr_scheduler, collate_fn=collate_fn,
                             config=load_config(config), device=device)
    return engine, engine.optimizer, engine.training_dataloader, engine.lr_scheduler


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
