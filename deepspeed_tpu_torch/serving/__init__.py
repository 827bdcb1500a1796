"""Continuous-batching serving (port of ``deepspeed_tpu/serving``).

Slot-pool scheduler (requests join and leave the running decode batch
mid-flight), bounded-queue admission control, a paged KV pool with a
shared-prefix cache, streaming token events, and serving metrics. The
fleet layer (router, autoscaler, degraded ladder, speculative decoding, live
migration) is ROADMAP A.3.
"""

from .clock import VirtualClock, WallClock
from .engine import ServingEngine
from .kv_pool import GARBAGE_BLOCK, KVPoolManager, prefix_chain_keys
from .metrics import ServingMetrics, percentile
from .queue import RequestQueue
from .request import (CLASS_BATCH, CLASS_INTERACTIVE, FINISH_EOS, FINISH_LENGTH,
                      FINISH_UNHEALTHY, REJECT_ALL_REPLICAS_SATURATED, REJECT_DEGRADED,
                      REJECT_NO_FREE_BLOCKS, REJECT_PROMPT_TOO_LONG, REJECT_QUEUE_FULL,
                      REJECT_REPLICA_FAILED, Request, RequestState, SamplingParams,
                      TokenEvent, as_request)
from .scheduler import ServingScheduler, simulate_static_batching

__all__ = [
    "ServingEngine",
    "ServingScheduler",
    "ServingMetrics",
    "RequestQueue",
    "Request",
    "RequestState",
    "SamplingParams",
    "TokenEvent",
    "VirtualClock",
    "WallClock",
    "as_request",
    "percentile",
    "simulate_static_batching",
    "KVPoolManager",
    "GARBAGE_BLOCK",
    "CLASS_INTERACTIVE",
    "CLASS_BATCH",
    "prefix_chain_keys",
    "FINISH_EOS",
    "FINISH_LENGTH",
    "FINISH_UNHEALTHY",
    "REJECT_QUEUE_FULL",
    "REJECT_PROMPT_TOO_LONG",
    "REJECT_NO_FREE_BLOCKS",
    "REJECT_ALL_REPLICAS_SATURATED",
    "REJECT_REPLICA_FAILED",
    "REJECT_DEGRADED",
]
