"""Request & event types for the continuous-batching serving layer (copy of
``deepspeed_tpu/serving/request.py``; the fields, the tenant fields included,
are kept as they are so the same requests drive both packages).

A ``Request`` is the unit the scheduler moves through QUEUED -> RUNNING ->
FINISHED (or straight to REJECTED at admission); ``TokenEvent`` is the unit
the streaming API yields — one per generated token per request, tagged with
``done`` + ``finish_reason`` on the last one.
"""

import dataclasses
import enum
import typing

import numpy as np


class RequestState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    FINISHED = "finished"
    REJECTED = "rejected"


# admission-control shed reasons (reject-with-reason instead of OOM)
REJECT_QUEUE_FULL = "queue_full"
REJECT_PROMPT_TOO_LONG = "prompt_too_long"
REJECT_BAD_REQUEST = "bad_request"
# paged KV pool: the request's block footprint exceeds the pool's capacity
REJECT_NO_FREE_BLOCKS = "no_free_blocks"
# router tier: every replica is draining or at queue capacity — the
# cross-replica generalization of queue_full
REJECT_ALL_REPLICAS_SATURATED = "all_replicas_saturated"
# router tier, terminal failover fallback: the request's replica died (or
# kept failing) and the bounded retry budget (serving.retry_limit) is spent
# — or no surviving replica could take it
REJECT_REPLICA_FAILED = "replica_failed"
# degraded-mode ladder (serving.degraded): the engine is shedding this
# request's CLASS under SLO burn — batch from rung 1, interactive only at
# the last rung (per-tenant shed counters pin the ordering)
REJECT_DEGRADED = "degraded"

# tenant/priority classes (serving.tenants)
CLASS_INTERACTIVE = "interactive"
CLASS_BATCH = "batch"

FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_STOP = "stop"
# health watchdog shed: the slot's logits went non-finite mid-decode
FINISH_UNHEALTHY = "unhealthy_slot"


@dataclasses.dataclass
class SamplingParams:
    """Per-request sampling knobs, held as per-slot tensors of the slot pool
    (``models/decoding.py:sample_token_per_request``) — co-batched requests
    never share an rng stream or a temperature. ``temperature <= 0`` means
    greedy."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: typing.Optional[int] = None


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                      # [prompt_len] int32
    max_new_tokens: int = 32
    sampling: SamplingParams = None
    eos_token_id: typing.Optional[int] = None
    stop_token_ids: typing.Tuple[int, ...] = ()
    request_id: typing.Optional[int] = None  # assigned at submit if None
    # open-loop offered-load arrival, as an OFFSET from serve()/submit() time
    # (resolved against the clock at intake); None = already arrived
    arrival_time: typing.Optional[float] = None
    # set once arrival_time has been converted to an absolute clock value —
    # submit() must not re-shift a request serve() already resolved
    arrival_resolved: bool = False
    # router session affinity: requests sharing a session_id stick to one
    # replica (None = stateless, routed purely on load/prefix affinity)
    session_id: typing.Optional[str] = None
    # cross-replica trace id: every span/instant this request produces on
    # any replica carries it, so the fleet merger can stitch one lifecycle
    # from N per-replica streams (assigned at router/engine submit if None)
    trace_id: typing.Optional[str] = None
    # multi-tenant QoS (serving.tenants): the paying tenant and its
    # priority class. "interactive" rides the latency SLO (and may evict a
    # batch stream under priority preemption); "batch" is throughput
    # traffic — first shed under the degraded ladder, first evicted under
    # slot pressure. Per-tenant digests/budgets/sheds key on tenant_id.
    tenant_id: str = "default"
    tenant_class: str = CLASS_INTERACTIVE

    # -- scheduler-owned runtime fields -------------------------------------
    state: RequestState = RequestState.QUEUED
    reject_reason: typing.Optional[str] = None
    finish_reason: typing.Optional[str] = None
    tokens: list = dataclasses.field(default_factory=list)
    slot: typing.Optional[int] = None
    submit_time: typing.Optional[float] = None
    first_token_time: typing.Optional[float] = None
    finish_time: typing.Optional[float] = None
    # on-demand growth preemption: times this request was preempted back to
    # the queue, and the per-slot rng key captured at preemption so the
    # resumed stream continues bitwise-identically (greedy AND sampled)
    preemptions: int = 0
    # of those, evictions by a higher-priority (interactive) arrival under
    # serving.tenants.preempt — a subset of ``preemptions``
    priority_evictions: int = 0
    resume_rng: typing.Optional[np.ndarray] = None
    # admission-time KV block reservation held in KVPoolManager._pending
    # until the slot insert consumes it (or an early finish cancels it)
    reserved_blocks: int = 0
    # first slot-bind order (preemption victim = newest; a resumed request
    # keeps its original seniority)
    admit_seq: int = -1
    # scheduler admission time (next_admissions stamp) and first prefill
    # dispatch time — queue_wait's endpoint; survives preemption (a resume
    # replay does not reopen the queue-wait window)
    admit_time: typing.Optional[float] = None
    prefill_start_time: typing.Optional[float] = None
    # digest window epochs: ServingMetrics.window_resets at the moment each
    # latency sample was recorded, so an unhealthy-shed retraction after a
    # reset_window() cannot decrement a fresh digest's (different) sample
    ttft_epoch: int = -1
    queue_wait_epoch: int = -1
    # goodput accounting (summed into ServingMetrics.goodput, emitted in
    # the request/finish instant so the wide event carries them verbatim):
    # positions re-prefilled after a preemption, prefill bucket padding
    # beyond the true token count, positions skipped via prefix-cache hits,
    # prefill chunk dispatches, and the KV-block high-water mark
    replay_tokens: int = 0
    padding_tokens: int = 0
    prefix_saved_tokens: int = 0
    chunks: int = 0
    kv_blocks_peak: int = 0
    # speculative decoding (serving/speculative.py): candidate tokens the
    # drafter proposed for this request, how many were accepted by the
    # one-forward verify, and how many rolled back — emitted verbatim in
    # the request/finish instant so the fleet wide event reconciles with
    # the Serving/spec_* counters
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    rolled_back_tokens: int = 0
    # live KV migration (serving/migration.py): the latest portable
    # RequestSnapshot of this request's device state — captured on the
    # periodic cadence (serving.migration.snapshot_interval_tokens) or at
    # drain-by-migration; a target replica splices it instead of replaying
    migration: typing.Optional[object] = None
    # fleet recovery accounting, all counted distinctly in RouterMetrics:
    # cross-replica re-dispatches after a replica failure (bounded by
    # serving.retry_limit), cross-replica retries after an unhealthy_slot
    # shed (same budget, separate counter), and completed replica moves
    # (drain-by-migration + failover splices/replays)
    failovers: int = 0
    retries: int = 0
    migrations: int = 0
    # disaggregated fleet (serving.pools): completed first-token
    # prefill->decode handoffs, and the in-flight marker the router sets so
    # the decode-side splice emits the handoff_in instant (cleared there);
    # rebalances counts voluntary mid-flight moves off hot replicas
    handoffs: int = 0
    handoff_pending: bool = False
    rebalances: int = 0

    def __post_init__(self):
        self.prompt = np.asarray(self.prompt, np.int32).reshape(-1)
        if self.sampling is None:
            self.sampling = SamplingParams()
        elif isinstance(self.sampling, dict):
            self.sampling = SamplingParams(**self.sampling)

    @property
    def prompt_len(self):
        return int(self.prompt.shape[0])

    def reset_for_retry(self):
        """Clear the terminal state an ``unhealthy_slot`` shed left so the
        router can re-dispatch this request to a DIFFERENT replica. Safe by
        construction: the unhealthy shed fires BEFORE the first token
        streams, so nothing user-visible rewinds."""
        self.state = RequestState.QUEUED
        self.reject_reason = None
        self.finish_reason = None
        self.finish_time = None
        self.slot = None

    @property
    def start_time(self):
        """The latency zero point every per-request metric shares: resolved
        arrival if the request carried one, else submit time."""
        return self.arrival_time if self.arrival_time is not None \
            else self.submit_time

    @property
    def ttft(self):
        """Time from arrival (resolved by serve()) or submit to first token —
        queueing delay counts, as a serving frontend's user would see it."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.start_time

    @property
    def queue_wait(self):
        """Arrival (or submit) to the first prefill dispatch — the pure
        queueing component of TTFT (TTFT = queue_wait + prefill +
        first-token sample, all on the scheduler clock)."""
        if self.prefill_start_time is None:
            return None
        return self.prefill_start_time - self.start_time

    @property
    def tpot(self):
        """Mean time per output token after the first."""
        if self.finish_time is None or self.first_token_time is None \
                or len(self.tokens) < 2:
            return None
        return (self.finish_time - self.first_token_time) / (len(self.tokens) - 1)


@dataclasses.dataclass
class TokenEvent:
    """One streamed token: ``index`` is the 0-based position in the request's
    generated stream; the final event carries ``done=True`` + a reason."""

    request_id: int
    token: int
    index: int
    done: bool = False
    finish_reason: typing.Optional[str] = None
    time: float = 0.0


def as_request(obj, default_max_new_tokens=32):
    """Coerce a user-supplied request (Request | dict | array prompt)."""
    if isinstance(obj, Request):
        return obj
    if isinstance(obj, dict):
        d = dict(obj)
        d.setdefault("max_new_tokens", default_max_new_tokens)
        return Request(**d)
    return Request(prompt=np.asarray(obj),
                   max_new_tokens=default_max_new_tokens)
