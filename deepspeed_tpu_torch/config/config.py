"""The serving and training configs (copies of classes of ``deepspeed_tpu/config/config.py``).

``ServingConfig``, ``KVPoolConfig``, ``ChunkedPrefillConfig`` and ``SLOConfig``
keep the JAX package's keys, defaults and ``ConfigError`` cases, so the same
``serving`` JSON resolves to the same values on both sides. The sub-blocks
of features the port does not serve yet (router, speculative decoding,
migration, disaggregated pools, rebalancing, autoscaling, tenants, the
degraded ladder) still parse, but one that asks for anything raises
``NotImplementedError`` naming the ROADMAP item that ports it: nothing is
silently ignored.

``DeepSpeedConfig`` is the training JSON of ``initialize``: the batch
triangle, optimizer, scheduler, fp16/bf16, gradient clipping and ZeRO stage
0 on one device, with the JAX package's keys, defaults and ``ConfigError``
cases. The blocks of features the port does not train with yet parse as
their JSON, and one that turns its feature on raises ``NotImplementedError``
naming its ROADMAP item (``UNPORTED_TRAINING_BLOCKS``). Keys the JAX engine
reads nowhere (``activation_checkpointing``, ``prescale_gradients``,
``gradient_predivide_factor``, ``sparse_gradients``, ``data_types``,
``zero_allow_untested_optimizer``, the ZeRO bucket knobs) parse and do
nothing here either.
"""

import enum
import json
import os
import typing

from ..utils import not_ported
from .base import ConfigError, ConfigModel, _coerce


class KVPoolConfig(ConfigModel):
    """Paged KV cache (``serving/kv_pool.py``): the slot pool's KV memory is
    a fixed pool of token blocks plus a per-slot block table instead of one
    dense ``n_slots x max_len`` region. Blocks are allocated/freed at request
    granularity on the host; the decode step reads through the block table.
    Requests reserve ``ceil((prompt + max_new - 1) / block_size)`` blocks,
    their real footprint."""

    enabled: bool = False
    # tokens per KV block; serving max_len must be a multiple of it
    block_size: int = 16
    # physical blocks in the pool, INCLUDING the reserved garbage block 0
    # (freed slots' dead decode writes land there). 0 = auto: the dense
    # pool's token capacity, n_slots * (max_len / block_size) + 1.
    n_blocks: int = 0
    # "" = the engine serving dtype; "int8" = int8 payloads with one fp32
    # scale per (token, head), dequantized to the serving dtype on read
    kv_dtype: str = ""
    # copy-on-write shared-prefix cache: full prompt blocks are content-
    # addressed; an identical prefix maps to the SAME physical blocks
    # (refcounted) and only the suffix is prefilled
    prefix_cache: bool = True
    # reserve-as-you-decode: admission reserves only the PROMPT's blocks and
    # decode blocks are allocated as cursors advance. On pool exhaustion
    # mid-decode the newest request is preempted back to the queue (resuming
    # with the same stream) instead of OOM/shed. False = whole-footprint
    # reservation at admission.
    on_demand_growth: bool = False
    # decode-attention backend. "gather" (default): per-layer dense view of
    # the pool through the block table, then the dense attention. "fused":
    # the paged flash-decode kernel (ops/cuda/paged_attention.py) walks the
    # block table itself — no dense view. Probed at engine construction
    # (fused_decode_supported); a shape it refuses logs once and serves
    # through "gather". Prefill and insert run the gather machinery either way.
    attention_backend: str = "gather"

    def _validate(self):
        if self.block_size < 1:
            raise ConfigError(
                f"kv_pool.block_size must be >= 1, got {self.block_size}")
        if self.n_blocks < 0:
            raise ConfigError(
                f"kv_pool.n_blocks must be >= 0, got {self.n_blocks}")
        if self.kv_dtype not in ("", "int8"):
            raise ConfigError(
                f"kv_pool.kv_dtype must be '' or 'int8', got {self.kv_dtype!r}")
        if self.attention_backend not in ("gather", "fused"):
            raise ConfigError(
                f"kv_pool.attention_backend must be 'gather' or 'fused', "
                f"got {self.attention_backend!r}")


class ChunkedPrefillConfig(ConfigModel):
    """Chunked prefill (``serving/engine.py``): split a long prompt's prefill
    into fixed-token chunks interleaved with decode steps, so a single long
    arrival cannot stall the co-batched decode — a bounded-TPOT guarantee
    instead of an unbounded prefill window. Each chunk rides the
    shared-prefix suffix-prefill machinery, so chunking changes the
    SCHEDULE, never the math."""

    enabled: bool = False
    # tokens per prefill chunk (bucketed by the prompt-bucket policy)
    chunk_size: int = 64
    # decode steps run for the co-batched slots between consecutive chunks
    decode_steps_between_chunks: int = 1

    def _validate(self):
        if self.chunk_size < 1:
            raise ConfigError(
                f"chunked_prefill.chunk_size must be >= 1, got "
                f"{self.chunk_size}")
        if self.decode_steps_between_chunks < 1:
            raise ConfigError(
                "chunked_prefill.decode_steps_between_chunks must be >= 1, "
                f"got {self.decode_steps_between_chunks}")


class SLOConfig(ConfigModel):
    """Serving latency objectives (``serving.slo``): P99 targets graded
    against the streaming latency digests (``telemetry/digest.py``) that
    ``ServingMetrics`` maintains. A target of 0 disables that objective."""

    # P99 targets in milliseconds (virtual-clock units x1e3 under a
    # VirtualClock); 0 = objective off
    ttft_p99_ms: float = 0.0
    tpot_p99_ms: float = 0.0
    queue_wait_p99_ms: float = 0.0

    def _validate(self):
        for field in ("ttft_p99_ms", "tpot_p99_ms", "queue_wait_p99_ms"):
            if getattr(self, field) < 0:
                raise ConfigError(
                    f"slo.{field} must be >= 0 (0 disables), got "
                    f"{getattr(self, field)}")

    def targets_ms(self):
        """The evaluate_slo() input dict (keys carry the _p99_ms suffix)."""
        return {"ttft_p99_ms": self.ttft_p99_ms,
                "tpot_p99_ms": self.tpot_p99_ms,
                "queue_wait_p99_ms": self.queue_wait_p99_ms}

    @property
    def armed(self):
        return any(v > 0 for v in self.targets_ms().values())


# sub-block -> ROADMAP item. Each parses as its JSON; None, an empty block
# or {"enabled": false} leaves its feature off, anything else raises.
UNPORTED_SERVING_BLOCKS = {
    "router": "A.3",
    "speculative": "A.3",
    "migration": "A.3",
    "pools": "A.3",
    "rebalance": "A.3",
    "autoscaler": "A.3",
    "tenants": "A.3",
    "degraded": "A.3",
}


def _leaves_feature_off(block):
    if block is None:
        return True
    if not isinstance(block, dict):
        raise ConfigError(f"expected a dict config block, got {type(block)}")
    if set(block) - {"enabled"}:
        return False
    return not _coerce(block.get("enabled", False), bool, "enabled")


class ServingConfig(ConfigModel):
    """Continuous-batching serving (Orca-style slot scheduler over one decode
    step for the whole slot pool). Consumed by ``serving/engine.py`` via the
    inference config's ``serving`` block."""

    # fixed decode batch-slot pool: finished requests free their slot
    # mid-flight and queued ones are spliced in
    n_slots: int = 8
    # per-slot KV window (prompt + generation); 0 = inference max_tokens
    max_len: int = 0
    # admission control: requests beyond this queue depth are shed with a
    # reason instead of growing until OOM
    max_queue_depth: int = 64
    # prefill/decode interleaving: at most this many prefills per scheduler
    # step, so a burst of arrivals can't starve running decodes (TPOT)
    max_prefills_per_step: int = 1
    # admission policy: "fcfs" (strict arrival order + bounded HOL bypass);
    # "weighted_fair" is ROADMAP A.3 in the port
    policy: str = "fcfs"
    # deterministic virtual-clock mode (tests/simulation): scheduler time
    # advances by the cost model below instead of the wall clock
    virtual_clock: bool = False
    virtual_decode_step_cost: float = 1.0
    virtual_prefill_cost_per_token: float = 0.0625  # ~flash prefill vs decode
    # zero freed KV memory when a request finishes (the causal mask and
    # whole-row/whole-block insert already prevent stale-KV leaks; hygiene/
    # debug knob). Dense pool: zero the slot's rows; paged pool: zero each
    # physical block as its refcount hits zero (block-granularity scrub).
    scrub_freed_slots: bool = False
    # emit Serving/* monitor events every N scheduler steps (0 disables)
    monitor_interval: int = 32
    # paged KV cache with shared-prefix reuse (kv_pool.enabled)
    kv_pool: KVPoolConfig = None
    # chunked prefill: interleave fixed-token prefill chunks with decode
    # steps for a bounded co-batched TPOT (chunked_prefill.enabled)
    chunked_prefill: ChunkedPrefillConfig = None
    # latency SLO targets graded against the streaming digests; 0 = none
    slo: SLOConfig = None
    # head-of-line bypass under block-aware admission: when the queue head's
    # KV footprint cannot fit, up to this many later requests that DO fit may
    # be admitted past it before admissions stop until the head clears
    # (bounded starvation). 0 = strict FCFS, nothing ever overtakes the head.
    hol_bypass_limit: int = 0
    # the fleet and QoS sub-blocks, unported (UNPORTED_SERVING_BLOCKS)
    router: typing.Any = None
    speculative: typing.Any = None
    migration: typing.Any = None
    pools: typing.Any = None
    rebalance: typing.Any = None
    autoscaler: typing.Any = None
    tenants: typing.Any = None
    degraded: typing.Any = None
    # cross-replica retry budget of the Router (parsed and validated as in
    # the JAX package; a single engine never reads it)
    retry_limit: int = 1

    def _validate(self):
        if self.kv_pool is None:
            self.kv_pool = KVPoolConfig()
        if self.chunked_prefill is None:
            self.chunked_prefill = ChunkedPrefillConfig()
        if self.slo is None:
            self.slo = SLOConfig()
        for name, item in UNPORTED_SERVING_BLOCKS.items():
            if not _leaves_feature_off(getattr(self, name)):
                raise not_ported(f"serving config block '{name}'", item)
        if self.retry_limit < 0:
            raise ConfigError(
                f"serving.retry_limit must be >= 0, got {self.retry_limit}")
        if self.hol_bypass_limit < 0:
            raise ConfigError(
                f"serving.hol_bypass_limit must be >= 0, got "
                f"{self.hol_bypass_limit}")
        if self.n_slots < 1:
            raise ConfigError(f"serving.n_slots must be >= 1, got {self.n_slots}")
        if self.max_queue_depth < 1:
            raise ConfigError(
                f"serving.max_queue_depth must be >= 1, got {self.max_queue_depth}")
        if self.policy not in ("fcfs", "weighted_fair"):
            raise ConfigError(
                f"serving.policy must be 'fcfs' or 'weighted_fair', got "
                f"{self.policy!r}")
        if self.policy == "weighted_fair":
            raise not_ported("serving.policy='weighted_fair' (tenant fair queuing)", "A.3")
        if self.max_prefills_per_step < 1:
            raise ConfigError("serving.max_prefills_per_step must be >= 1")


# ---------------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------------
class OffloadDeviceEnum(str, enum.Enum):
    none = "none"
    cpu = "cpu"
    nvme = "nvme"


class OptimizerConfig(ConfigModel):
    type: str = "adamw"
    params: dict = {}


class SchedulerConfig(ConfigModel):
    type: str = ""
    params: dict = {}


class FP16Config(ConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0


class BF16Config(ConfigModel):
    enabled: bool = False


class DeepSpeedZeroOffloadParamConfig(ConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: str = ""
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False


class DeepSpeedZeroOffloadOptimizerConfig(ConfigModel):
    device: OffloadDeviceEnum = OffloadDeviceEnum.none
    nvme_path: str = ""
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False


class ZeroConfig(ConfigModel):
    """ZeRO. The port trains at stage 0 on one device; stages 1-3 are
    ROADMAP A.7 and offload A.8, each raising when asked for."""

    stage: int = 0
    zero3_gather_mode: str = "compiler"
    zero3_gather_impl: str = "constraint"
    zero3_gather_dtype: str = "auto"
    zero3_gather_block: int = 256
    grad_reduce_dtype: str = "fp32"
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: bool = True
    round_robin_gradients: bool = False
    offload_param: DeepSpeedZeroOffloadParamConfig = DeepSpeedZeroOffloadParamConfig
    offload_optimizer: DeepSpeedZeroOffloadOptimizerConfig = DeepSpeedZeroOffloadOptimizerConfig
    sub_group_size: int = 1_000_000_000
    prefetch_bucket_size: int = 50_000_000
    param_persistence_threshold: int = 100_000
    model_persistence_threshold: int = 2 ** 62
    max_live_parameters: int = 1_000_000_000
    max_reuse_distance: int = 1_000_000_000
    gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    legacy_stage1: bool = False
    elastic_checkpoint: bool = False

    deprecated_fields = {
        "stage3_gather_16bit_weights_on_model_save": "gather_16bit_weights_on_model_save",
        "stage3_max_live_parameters": "max_live_parameters",
        "stage3_max_reuse_distance": "max_reuse_distance",
        "stage3_prefetch_bucket_size": "prefetch_bucket_size",
        "stage3_param_persistence_threshold": "param_persistence_threshold",
        "cpu_offload": "offload_optimizer",
    }

    def _validate(self):
        if self.stage not in (0, 1, 2, 3):
            raise ConfigError(f"zero_optimization.stage must be in 0..3, got {self.stage}")
        if self.zero3_gather_mode not in ("compiler", "per_layer"):
            raise ConfigError(
                f"zero_optimization.zero3_gather_mode must be 'compiler' or "
                f"'per_layer', got {self.zero3_gather_mode!r}")
        if self.zero3_gather_dtype not in ("auto", "fp32", "bf16", "int8"):
            raise ConfigError(
                f"zero_optimization.zero3_gather_dtype must be one of "
                f"auto|fp32|bf16|int8, got {self.zero3_gather_dtype!r}")
        if self.zero3_gather_dtype in ("bf16", "int8"):
            if self.stage != 3:
                raise ConfigError(
                    f"zero_optimization.zero3_gather_dtype="
                    f"{self.zero3_gather_dtype!r} requires stage 3 (got stage "
                    f"{self.stage}); below stage 3 params are not partitioned "
                    f"and there is no weight gather to compress")
            if self.zero3_gather_mode != "per_layer":
                raise ConfigError(
                    f"zero_optimization.zero3_gather_dtype="
                    f"{self.zero3_gather_dtype!r} requires "
                    f"zero3_gather_mode='per_layer' (got "
                    f"{self.zero3_gather_mode!r})")
        if self.zero3_gather_block < 1:
            raise ConfigError(
                f"zero_optimization.zero3_gather_block must be >= 1, got "
                f"{self.zero3_gather_block}")
        if self.grad_reduce_dtype not in ("fp32", "bf16"):
            raise ConfigError(
                f"zero_optimization.grad_reduce_dtype must be 'fp32' or "
                f"'bf16', got {self.grad_reduce_dtype!r}")
        if self.zero3_gather_impl not in ("constraint", "shard_map"):
            raise ConfigError(
                f"zero3_gather_impl must be 'constraint' or 'shard_map', got "
                f"{self.zero3_gather_impl!r}")
        if self.stage > 0:
            raise not_ported(f"zero_optimization.stage={self.stage}", "A.7")
        for name in ("offload_param", "offload_optimizer"):
            if getattr(self, name).device != OffloadDeviceEnum.none:
                raise not_ported(f"zero_optimization.{name}", "A.8")

    @classmethod
    def from_dict(cls, d):
        d = dict(d or {})
        # legacy bool cpu_offload -> offload_optimizer section
        if isinstance(d.get("cpu_offload"), bool):
            flag = d.pop("cpu_offload")
            if flag:
                d.setdefault("offload_optimizer", {"device": "cpu"})
        return super().from_dict(d)


class ActivationCheckpointingConfig(ConfigModel):
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: int = 0
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


class MeshConfig(ConfigModel):
    """Axis sizes of the JAX package's device mesh. The port trains on one
    device: any axis larger than one is distribution (ROADMAP A.7)."""

    data: int = -1
    model: int = 1
    pipe: int = 1
    seq: int = 1
    expert: int = 1

    def _validate(self):
        big = {k: v for k, v in self.to_dict().items()
               if v != 1 and not (k == "data" and v == -1)}
        if big:
            raise not_ported(f"a mesh larger than one device ({big})", "A.7")


class PipelineConfig(ConfigModel):
    schedule: str = "1f1b"  # 1f1b | gpipe; read only with pipe > 1 (A.7)


# block -> ROADMAP item. Each parses as its JSON and turns its feature on
# with "enabled": true (off by default, as in the JAX package), which raises.
UNPORTED_TRAINING_BLOCKS = {
    "telemetry": "A.3",
    "health": "A.3",
    "tensorboard": "A.3",
    "wandb": "A.3",
    "csv_monitor": "A.3",
    "comms_logger": "A.3",
    "elastic": "A.7",
    "gradient_compression": "A.7",
    "hybrid_engine": "A.9",
    "flops_profiler": "A.9",
    "curriculum_learning": "A.9",
    "progressive_layer_drop": "A.9",
}


def _block_turns_feature_on(block):
    if block is None:
        return False
    if not isinstance(block, dict):
        raise ConfigError(f"expected a dict config block, got {type(block)}")
    return _coerce(block.get("enabled", False), bool, "enabled")


class DeepSpeedConfig(ConfigModel):
    """Top-level training config (the JAX ``DeepSpeedConfig``)."""

    train_batch_size: typing.Optional[int] = None
    train_micro_batch_size_per_gpu: typing.Optional[int] = None
    gradient_accumulation_steps: typing.Optional[int] = None
    steps_per_print: int = 10
    optimizer: OptimizerConfig = OptimizerConfig
    scheduler: SchedulerConfig = SchedulerConfig
    fp16: FP16Config = FP16Config
    bf16: BF16Config = BF16Config
    zero_optimization: ZeroConfig = ZeroConfig
    zero_allow_untested_optimizer: bool = False
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    sparse_gradients: bool = False
    activation_checkpointing: ActivationCheckpointingConfig = ActivationCheckpointingConfig
    mesh: MeshConfig = MeshConfig
    pipeline: PipelineConfig = PipelineConfig
    # the checkpoint engine block: saving and loading are ROADMAP A.5
    checkpoint: dict = {}
    hybrid_engine: typing.Any = None
    tensorboard: typing.Any = None
    wandb: typing.Any = None
    csv_monitor: typing.Any = None
    telemetry: typing.Any = None
    health: typing.Any = None
    elastic: typing.Any = None
    comms_logger: typing.Any = None
    flops_profiler: typing.Any = None
    data_types: dict = {}
    curriculum_learning: typing.Any = None
    progressive_layer_drop: typing.Any = None
    gradient_compression: typing.Any = None
    compression_training: dict = {}
    communication_data_type: typing.Optional[str] = None
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    dump_state: bool = False
    gradient_checkpointing: bool = False
    seed: int = 1234

    deprecated_fields = {"train_micro_batch_size": "train_micro_batch_size_per_gpu"}

    # -- batch triangle -------------------------------------------------------------
    def resolve_batch_size(self, dp_world_size):
        """Resolve/validate the batch-size triangle against ``dp_world_size``:
        given any subset of {train_batch_size, train_micro_batch_size_per_gpu,
        gradient_accumulation_steps}, infer the rest, and check
        ``train = micro * grad_accum * dp_world``."""
        tbs = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        for name, v in (("train_batch_size", tbs),
                        ("train_micro_batch_size_per_gpu", micro),
                        ("gradient_accumulation_steps", gas),
                        ("dp_world_size", dp_world_size)):
            if v is not None and v <= 0:
                raise ConfigError(f"{name} must be positive, got {v}")

        if tbs is not None and micro is not None and gas is None:
            gas, rem = divmod(tbs, micro * dp_world_size)
            if rem:
                raise ConfigError(
                    f"train_batch_size {tbs} is not divisible by "
                    f"micro_batch {micro} * dp_world {dp_world_size}"
                )
        elif tbs is not None and micro is None and gas is not None:
            micro, rem = divmod(tbs, gas * dp_world_size)
            if rem:
                raise ConfigError(
                    f"train_batch_size {tbs} is not divisible by "
                    f"grad_accum {gas} * dp_world {dp_world_size}"
                )
        elif tbs is not None and micro is None and gas is None:
            gas = 1
            micro, rem = divmod(tbs, dp_world_size)
            if rem:
                raise ConfigError(
                    f"train_batch_size {tbs} is not divisible by dp_world {dp_world_size}"
                )
        elif tbs is None and micro is not None:
            gas = gas or 1
            tbs = micro * gas * dp_world_size
        elif tbs is None and micro is None:
            raise ConfigError(
                "At least train_batch_size or train_micro_batch_size_per_gpu must be set"
            )

        if tbs != micro * gas * dp_world_size:
            raise ConfigError(
                f"Batch-size triangle violated: train_batch_size ({tbs}) != "
                f"micro ({micro}) * grad_accum ({gas}) * dp_world ({dp_world_size})"
            )
        if tbs <= 0 or micro <= 0 or gas <= 0:
            raise ConfigError("Batch sizes must be positive")

        self.train_batch_size = tbs
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
        return tbs, micro, gas

    def _validate(self):
        if self.fp16.enabled and self.bf16.enabled:
            raise ConfigError("fp16 and bf16 cannot both be enabled")
        for name, item in UNPORTED_TRAINING_BLOCKS.items():
            if _block_turns_feature_on(getattr(self, name)):
                raise not_ported(f"training config block '{name}'", item)
        if self.compression_training:
            raise not_ported("training config block 'compression_training'", "A.9")
        if self.checkpoint:
            raise not_ported("training config block 'checkpoint' (the checkpoint engine)",
                             "A.5")
        if self.wall_clock_breakdown:
            raise not_ported("wall_clock_breakdown (step timers)", "A.3")
        if self.communication_data_type is not None:
            raise not_ported("communication_data_type (gradient reduction dtype)", "A.7")

    @property
    def mixed_precision_dtype(self):
        if self.fp16.enabled:
            return "float16"
        if self.bf16.enabled:
            return "bfloat16"
        return "float32"


def load_config(config) -> DeepSpeedConfig:
    """Accept a path to a JSON file or an in-memory dict."""
    if isinstance(config, DeepSpeedConfig):
        return config
    if isinstance(config, str):
        if not os.path.exists(config):
            raise ConfigError(f"DeepSpeed config file not found: {config}")
        with open(config) as f:
            config = json.load(f)
    if not isinstance(config, dict):
        raise ConfigError(f"config must be a dict or JSON path, got {type(config)}")
    return DeepSpeedConfig.from_dict(config)
