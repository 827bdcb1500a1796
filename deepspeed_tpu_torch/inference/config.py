"""Inference config (port of ``deepspeed_tpu/inference/config.py``).

The same keys, defaults and ``ConfigError`` cases as the JAX package. The
blocks of features this port does not serve yet still parse, but a block
that asks for anything raises ``NotImplementedError`` naming the ROADMAP
item that ports it: nothing is silently ignored.
"""

import typing

from ..config.base import ConfigError, ConfigModel, _coerce
from ..utils import not_ported


class TensorParallelConfig(ConfigModel):
    enabled: bool = True
    tp_size: int = 1


class MoEInferenceConfig(ConfigModel):
    enabled: bool = True
    ep_size: int = 1


class QuantizationConfig(ConfigModel):
    enabled: bool = False
    bits: int = 8
    group_size: int = 64


# block -> ROADMAP item. The JAX package's own config classes for these are
# large and unported; the port accepts the block's JSON and refuses any
# block that does more than leave its feature off.
_UNPORTED_BLOCKS = {
    "serving": "A.2",
    "tensorboard": "A.3",
    "wandb": "A.3",
    "csv_monitor": "A.3",
    "telemetry": "A.3",
    "health": "A.3",
}


def _block_is_off(block):
    if block is None:
        return True
    if not isinstance(block, dict):
        raise ConfigError(f"expected a dict config block, got {type(block)}")
    if set(block) - {"enabled"}:
        return False
    return not _coerce(block.get("enabled", False), bool, "enabled")


class DeepSpeedInferenceConfig(ConfigModel):
    dtype: str = "bfloat16"
    tensor_parallel: TensorParallelConfig = None
    max_tokens: int = 1024
    min_tokens: int = 1
    max_batch_size: int = 8
    # generate() pads prompts to the next bucket, so one set of shapes serves
    # every prompt length in a bucket. 1 disables bucketing.
    prompt_bucket_size: int = 64
    # "pow2": buckets are prompt_bucket_size doublings; "multiple": every
    # multiple of prompt_bucket_size is a bucket.
    prompt_bucket_policy: str = "pow2"
    # The JAX engine's cap on compiled programs per shape. Parsed and
    # validated so the same config resolves; not read, since the eager port
    # compiles no program per shape.
    compile_cache_size: int = 32
    # generate() pads the batch to a multiple of this (padded rows dropped).
    batch_bucket_size: int = 1
    serving: typing.Any = None
    tensorboard: typing.Any = None
    wandb: typing.Any = None
    csv_monitor: typing.Any = None
    telemetry: typing.Any = None
    health: typing.Any = None
    quant: QuantizationConfig = None
    moe: MoEInferenceConfig = None
    replace_with_kernel_inject: bool = False  # accepted for config compat; no-op
    injection_policy: typing.Any = None
    seed: int = 0

    def _validate(self):
        if self.tensor_parallel is None:
            self.tensor_parallel = TensorParallelConfig()
        if self.quant is None:
            self.quant = QuantizationConfig()
        if self.moe is None:
            self.moe = MoEInferenceConfig()
        if self.dtype not in ("float16", "bfloat16", "float32"):
            raise ConfigError(f"inference dtype must be fp16/bf16/fp32, got {self.dtype}")
        if self.prompt_bucket_policy not in ("pow2", "multiple"):
            raise ConfigError(
                "prompt_bucket_policy must be 'pow2' or 'multiple', got "
                f"{self.prompt_bucket_policy!r}")
        for name, item in _UNPORTED_BLOCKS.items():
            if not _block_is_off(getattr(self, name)):
                raise not_ported(f"inference config block '{name}'", item)
        if self.tensor_parallel.enabled and self.tensor_parallel.tp_size > 1:
            raise not_ported("tensor-parallel inference (tp_size > 1)", "A.7")
        if self.moe.enabled and self.moe.ep_size > 1:
            raise not_ported("expert-parallel inference (ep_size > 1)", "A.7")
        if self.quant.enabled:
            raise not_ported("weight-only quantized inference", "A.4")
        if self.injection_policy:
            raise not_ported("injection_policy", "A.7")
