"""The serving config (copy of the serving classes of ``deepspeed_tpu/config/config.py``).

``ServingConfig``, ``KVPoolConfig``, ``ChunkedPrefillConfig`` and ``SLOConfig``
keep the JAX package's keys, defaults and ``ConfigError`` cases, so the same
``serving`` JSON resolves to the same values on both sides. The sub-blocks
of features the port does not serve yet (router, speculative decoding,
migration, disaggregated pools, rebalancing, autoscaling, tenants, the
degraded ladder) still parse, but one that asks for anything raises
``NotImplementedError`` naming the ROADMAP item that ports it, as does an
int8 KV pool: nothing is silently ignored.
"""

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
    # "" = the engine serving dtype; "int8" (int8 payloads with fp32 scales)
    # is ROADMAP A.4 in the port and raises
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
        if self.kv_dtype == "int8":
            raise not_ported("kv_pool.kv_dtype='int8' (quantized KV pool)", "A.4")


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
