"""Continuous-batching serving engine (port of ``deepspeed_tpu/serving/engine.py``).

Orca-style iteration-level scheduling over a fixed pool of batch slots. Each
slot holds one request's KV rows, cursor, last token, sampling stream and
knobs as per-slot tensors on the engine's device, so a finished request
frees its slot mid-flight and a queued one is prefilled and spliced into the
RUNNING decode batch without draining it.

The JAX engine jits one program per pool operation and donates the state to
each; here every operation is an eager function that updates the state
tensors IN PLACE (the same one-copy-of-the-pool effect donation bought
there). What a step reads back to the host is one small tensor: the sampled
tokens, the done flags and the per-slot nonfinite-logit counts.

KV memory is either the dense slot pool (``n_slots x max_len`` rows) or,
with ``kv_pool.enabled``, the paged pool of ``serving/kv_pool.py``: blocks
allocated by footprint on the host, a refcounted copy-on-write prefix cache,
optional on-demand growth with preemption back to the queue (the stream
resumes bitwise: the slot's sampling stream is captured at preemption), and
decode attention through a gathered dense view (``"gather"``) or the paged
flash-decode CUDA kernel, which walks the block table itself (``"fused"``).
With ``kv_pool.kv_dtype="int8"`` the pool holds int8 rows and one fp32
scale per (token, head), and every pool operation carries the scales.

Sampling streams: JAX keys each request with threefry and splits every
slot's key once per decode step. Threefry bits are not reproduced; a slot's
stream is a (key, counter) pair (``models/decoding.py:rng_key``), the key
derived from the request's seed (or from the engine seed and the request
id), the counter advanced once per decode step. A stream thus depends on
its own pair and its own logits only, never on its neighbours.

Not ported, each raising ``NotImplementedError`` naming its ROADMAP item:
speculative verify, live migration and snapshots, priority preemption and
tenants, the degraded ladder, pool roles and the health shed hook (A.3,
refused at config time where they are config blocks), and the static
program traces (A.9).
"""

import collections
import dataclasses

import numpy as np
import torch

from ..config.base import ConfigError
from ..models.decoding import (forward_with_cache, forward_with_paged_cache,
                               gather_slot_cache, init_cache, init_paged_cache,
                               insert_block_kv, insert_slot_kv, reset_block_kv,
                               reset_slot_kv, rng_key, sample_token_per_request,
                               unstack_layers)
from ..telemetry import SpanTracer
from ..utils import not_ported
from ..utils.logging import log_dist
from .clock import VirtualClock, WallClock
from .kv_pool import GARBAGE_BLOCK, KVPoolManager
from .metrics import ServingMetrics
from .queue import RequestQueue
from .request import (FINISH_EOS, FINISH_LENGTH, FINISH_STOP, Request,
                      RequestState, TokenEvent, as_request)
from .scheduler import ServingScheduler

# tags folded into a request's key: its first-token stream and its slot
# stream are two independent streams of one request key
_FIRST_STREAM, _SLOT_STREAM = 0, 1
_SEEDED = 0x5EED


@dataclasses.dataclass
class _PrefillJob:
    """A prompt prefill in flight across scheduler steps (chunked prefill
    and/or preemption resume). The job owns its reserved slot and the
    partially-filled dense b=1 cache between chunks; ``pos`` is the next
    prompt position to prefill (``ids`` = prompt, or prompt + already-
    generated tokens on a resume replay)."""

    req: object
    slot: int
    cache: dict
    ids: np.ndarray          # full token sequence to prefill
    pos: int                 # next position to write (starts at shared_len)
    shared_len: int
    shared_blocks: list
    resume: bool             # replaying a preempted request: no first-token
    #                          sampling, stream/metrics continue where left

    @property
    def done(self):
        return self.pos >= len(self.ids)


class ServingEngine:
    """Slot-pool continuous batching over an ``InferenceEngine``'s weights."""

    def __init__(self, engine, serving_config=None, clock=None, monitor=None,
                 tracer=None):
        if not hasattr(engine.module, "config"):
            raise ConfigError(
                "serving needs a zoo-style model (config with kv cache geometry)")
        self.engine = engine
        self.device = engine.device
        self.cfg = serving_config if serving_config is not None \
            else engine.config.serving
        self.n_slots = int(self.cfg.n_slots)
        self.max_len = int(self.cfg.max_len) or int(engine.config.max_tokens)
        if self.max_len > engine.config.max_tokens:
            raise ConfigError(
                f"serving.max_len {self.max_len} exceeds inference "
                f"max_tokens {engine.config.max_tokens}")
        self.clock = clock if clock is not None else (
            VirtualClock() if self.cfg.virtual_clock else WallClock())
        # paged KV pool (kv_pool.enabled): block allocator + prefix cache on
        # the host, the pool and the block table on the device
        self.paged = bool(self.cfg.kv_pool.enabled)
        # kv_pool.kv_dtype="int8": int8 rows with one fp32 scale per (token,
        # head); every pool operation carries the scales beside the rows
        self.int8_pool = self.paged and self.cfg.kv_pool.kv_dtype == "int8"
        self._pool_keys = ("k", "v", "k_scale", "v_scale") if self.int8_pool else ("k", "v")
        self.pool_mgr = KVPoolManager(self.cfg.kv_pool, self.n_slots,
                                      self.max_len) if self.paged else None
        # decode-attention backend: "dense" (no paging), "gather" (dense
        # per-slot view through the block table) or "fused" (the paged
        # flash-decode kernel walks the table itself). A requested "fused"
        # is probed ONCE here; a shape the probe refuses logs and serves
        # through "gather" (snapshot()["kv_pool"] records which ran). A shape
        # it admits reaches the kernel or raises.
        self.attn_backend = "dense"
        if self.paged:
            self.attn_backend = self.cfg.kv_pool.attention_backend
            if self.attn_backend == "fused":
                from ..ops.cuda.paged_attention import fused_decode_supported

                ok, reason = fused_decode_supported(
                    engine.module.config, self.pool_mgr.block_size,
                    device=self.device, dtype=torch.int8 if self.int8_pool else engine.dtype)
                if not ok:
                    log_dist(
                        "ServingEngine: kv_pool.attention_backend='fused' "
                        f"unsupported for this shape ({reason}); serving "
                        "through the gather path", ranks=[0])
                    self.attn_backend = "gather"
        if self.paged and self.cfg.scrub_freed_slots:
            # block-granularity scrub: zero each physical block as its last
            # reference drops (the dense pool's whole-row scrub generalized)
            self.pool_mgr._scrub = self._scrub_block
        # chunked prefill: long prompts prefill in fixed-token chunks
        # interleaved with decode steps; each chunk is one suffix prefill
        # against the request's partial dense cache
        self.chunked = bool(self.cfg.chunked_prefill.enabled)
        # on-demand block growth (paged only): admission reserves prompt
        # blocks, decode blocks are allocated as cursors advance, and pool
        # exhaustion preempts the newest request back to the queue
        self.growth = self.paged and bool(self.cfg.kv_pool.on_demand_growth)
        self._prefill_jobs = collections.deque()
        self._decode_steps_since_chunk = 1 << 30  # first chunk never waits
        self._admit_seq = 0    # admission order (preemption victim = newest)
        self.queue = RequestQueue(self.cfg.max_queue_depth)
        self.scheduler = ServingScheduler(
            self.queue, self.n_slots,
            max_prefills_per_step=self.cfg.max_prefills_per_step,
            policy=self.cfg.policy, hol_bypass_limit=self.cfg.hol_bypass_limit)
        self.metrics = ServingMetrics(self.n_slots, self.clock, monitor=monitor,
                                      interval=self.cfg.monitor_interval,
                                      kv_pool=self._kv_pool_stats
                                      if self.paged else None,
                                      slo=self.cfg.slo)
        # request-lifecycle tracing against the scheduler clock: the null
        # tracer unless one is given (span recording is ROADMAP A.3)
        self.tracer = tracer if tracer is not None else SpanTracer.from_config(
            getattr(engine.config, "telemetry", None), clock=self.clock.now)
        self.metrics.tracer = self.tracer

        self._slots = {}              # slot index -> running Request
        self._free_slots = list(range(self.n_slots - 1, -1, -1))  # pop() -> 0 first
        self._next_id = 0
        self._state = self._init_state()
        clock_name = "virtual" if isinstance(self.clock, VirtualClock) else "wall"
        if self.paged:
            mgr = self.pool_mgr
            cap = mgr.allocatable * mgr.block_size
            log_dist(
                f"ServingEngine: {self.n_slots} slots, paged KV pool "
                f"{mgr.allocatable} blocks x {mgr.block_size} tok = {cap} "
                f"tokens ({cap / self.max_len:.1f} max-len-equivalent slots, "
                f"kv_dtype={self.cfg.kv_pool.kv_dtype or 'engine'}, "
                f"attention={self.attn_backend}, "
                f"prefix_cache={'on' if self.cfg.kv_pool.prefix_cache else 'off'}), "
                f"queue depth {self.cfg.max_queue_depth}, clock={clock_name}",
                ranks=[0])
        else:
            log_dist(
                f"ServingEngine: {self.n_slots} slots x {self.max_len} KV window "
                f"(attention={self.attn_backend}), queue depth "
                f"{self.cfg.max_queue_depth}, clock={clock_name}", ranks=[0])

    @property
    def chunk_size(self):
        """The chunked-prefill chunk size (``chunked_prefill.chunk_size``)."""
        return self.cfg.chunked_prefill.chunk_size

    def _kv_pool_stats(self):
        """``KVPoolManager.stats()`` + the active attention backend, so every
        snapshot records WHICH decode path produced it."""
        st = self.pool_mgr.stats()
        st["attention_backend"] = self.attn_backend
        return st

    # ------------------------------------------------------------------ state
    def _init_state(self):
        cfg = self.engine.module.config
        s, dev = self.n_slots, self.device
        if self.paged:
            mgr = self.pool_mgr
            cache = init_paged_cache(cfg, mgr.n_blocks, mgr.block_size,
                                     self.engine.dtype, self.cfg.kv_pool.kv_dtype or None,
                                     device=dev)
            # every slot starts parked on the garbage block: a dead decode
            # write can never land in an allocatable block
            cache["table"] = torch.full((s, mgr.blocks_per_slot), GARBAGE_BLOCK,
                                        dtype=torch.int32, device=dev)
        else:
            cache = init_cache(cfg, s, self.max_len, self.engine.dtype, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        return dict(cache, **{
            "pos": torch.zeros(s, **i32),           # next KV write cursor
            "tok": torch.zeros(s, dtype=torch.int64, device=dev),  # last token
            "active": torch.zeros(s, dtype=torch.bool, device=dev),
            "remaining": torch.zeros(s, **i32),     # decode steps left
            "rng": torch.zeros((s, 2), dtype=torch.int64, device=dev),  # (key, counter)
            "temp": torch.zeros(s, dtype=torch.float32, device=dev),
            "top_k": torch.zeros(s, **i32),
            "top_p": torch.ones(s, dtype=torch.float32, device=dev),
            "eos": torch.full((s,), -1, **i32),     # -1 = no eos
        })

    def _pool(self):
        return {name: self._state[name] for name in self._pool_keys}

    # ------------------------------------------------------- pool operations
    # The JAX engine's jitted pool programs, as eager in-place updates.
    def _decode(self):
        """One token for EVERY slot, each at its own cursor. Inactive slots
        decode garbage into their own freed rows (dense: the slot's private
        rows, overwritten whole-row by the next insert; paged: the garbage
        block their table row points at) and are masked below. Returns the
        host copy of [3, S] (token, done, nonfinite-logit count)."""
        st = self._state
        model, params = self.engine.module, self.engine.params
        layers = unstack_layers(params, model.config.n_layers)
        if self.paged:
            logits = forward_with_paged_cache(
                model, params, st["tok"][:, None], self._pool(), st["table"],
                st["pos"], self.pool_mgr.block_size,
                attention_backend=self.attn_backend, layers=layers)
        else:
            logits = forward_with_cache(model, params, st["tok"][:, None],
                                        self._pool(), st["pos"], self.max_len,
                                        layers=layers)
        logits = logits[:, 0]
        # per-slot nonfinite-logit count (the serving leg of the numerics
        # watchdog; recorded, the shed hook is ROADMAP A.3)
        nonfinite = (~torch.isfinite(logits)).sum(dim=-1)
        nxt = sample_token_per_request(logits, st["rng"], temperature=st["temp"],
                                       top_k=st["top_k"], top_p=st["top_p"])
        active = st["active"]
        nxt = torch.where(active, nxt, st["tok"])
        remaining = st["remaining"] - active.int()
        hit_eos = (st["eos"] >= 0) & (nxt == st["eos"])
        done_now = active & (hit_eos | (remaining <= 0))
        st["pos"] += active.int()
        st["tok"] = nxt
        st["active"] = active & ~done_now
        st["remaining"] = remaining
        st["rng"][:, 1] += 1          # every slot's stream advances one draw
        return torch.stack([nxt, done_now.long(), nonfinite.long()]).cpu().numpy()

    def _insert_meta(self, slot, tok, pos, remaining, rng, s, eos, table_row=None):
        """Bind slot ``slot``'s scalars (and, paged, its block-table row)."""
        st = self._state
        if table_row is not None:
            st["table"][slot] = torch.as_tensor(table_row, dtype=torch.int32)
        st["pos"][slot] = int(pos)
        st["tok"][slot] = tok
        st["active"][slot] = True
        st["remaining"][slot] = int(remaining)
        st["rng"][slot] = torch.as_tensor(np.asarray(rng, np.int64))
        st["temp"][slot] = float(s.temperature)
        st["top_k"][slot] = int(s.top_k)
        st["top_p"][slot] = float(s.top_p)
        st["eos"][slot] = -1 if eos is None else int(eos)

    def _seed_cache(self, shared_blocks):
        """Shared-prefix hit: the slot's dense b=1 cache view from its (partly
        shared) block row — a copy, never aliasing the pool."""
        mgr = self.pool_mgr
        row = np.full((mgr.blocks_per_slot,), GARBAGE_BLOCK, np.int64)
        row[:len(shared_blocks)] = shared_blocks
        return gather_slot_cache(self.engine.module.config, self._pool(), row,
                                 self.engine.dtype)

    def _fresh_cache(self):
        """A zeroed dense b=1 cache a chunked/resumed prefill carries across
        scheduler steps."""
        return init_cache(self.engine.module.config, 1, self.max_len,
                          self.engine.dtype, device=self.device)

    def _release(self, slot):
        st = self._state
        if self.paged:
            # MANDATORY on the paged pool: the freed slot's blocks go back to
            # the allocator, so its table row must retreat to the garbage
            # block before anything reuses them — a dead decode write to a
            # reallocated block would be silent cross-request corruption
            st["table"][slot] = GARBAGE_BLOCK
            st["pos"][slot] = 0
        else:
            # the dense pool zeroes the freed rows (host-side stop or the
            # hygiene scrub); the causal mask and whole-row insert already
            # guarantee no stale-KV leak without it
            reset_slot_kv(self._pool(), slot)
        st["active"][slot] = False

    def _scrub_block(self, block_id):
        """KVPoolManager scrub hook: zero one freed physical block."""
        if self._state is not None:
            reset_block_kv(self._pool(), int(block_id))

    def _sample_first(self, logits, key, s):
        """The first token from the prefill logits [1, vocab], with the same
        nonfinite count as decode. Returns (token, nonfinite count)."""
        dev = self.device
        nonfinite = int((~torch.isfinite(logits)).sum())
        tok = sample_token_per_request(
            logits, torch.tensor([[key, 0]], dtype=torch.int64, device=dev),
            temperature=torch.tensor([float(s.temperature)], device=dev),
            top_k=torch.tensor([int(s.top_k)], dtype=torch.int32, device=dev),
            top_p=torch.tensor([float(s.top_p)], device=dev))
        return int(tok[0]), nonfinite

    def _prefill_program(self, ids, true_len):
        """Prompt prefill from position 0 into a fresh dense b=1 cache (the
        flash-attention kernel on the card). Returns (last logits, cache)."""
        model = self.engine.module
        cache = self._fresh_cache()
        logits = forward_with_cache(model, self.engine.params, ids, cache, 0,
                                    self.max_len, prefill=True)
        return logits[:, true_len - 1], cache

    def _suffix_program(self, ids, cache, start_pos, true_len):
        """Prefill ``ids`` at ``start_pos`` against a dense b=1 cache that
        already holds positions below it (a shared-prefix hit, a prefill
        chunk or a resume replay). Returns (last logits, cache)."""
        logits = forward_with_cache(self.engine.module, self.engine.params, ids,
                                    cache, int(start_pos), self.max_len)
        return logits[:, true_len - 1], cache

    # ------------------------------------------------------- not ported
    def compile_counts(self):
        """The JAX engine's census of compiled programs (decode compiles once
        per slot pool). The port runs eagerly and compiles no program per
        shape, so there is nothing to count and this is not ported."""
        raise NotImplementedError(
            "compile_counts has no meaning in the eager PyTorch port: no "
            "program is compiled per shape")

    def trace_decode(self):
        raise not_ported("ServingEngine.trace_decode (static program audit)", "A.9")

    def lower_decode(self):
        raise not_ported("ServingEngine.lower_decode (static program audit)", "A.9")

    def trace_prefill_chunk(self, chunk_tokens=None):
        raise not_ported("ServingEngine.trace_prefill_chunk (static program audit)", "A.9")

    def trace_verify(self, spec_k=None):
        raise not_ported("ServingEngine.trace_verify (static program audit)", "A.9")

    def set_pool_role(self, role, chunk_size=0, speculation=""):
        raise not_ported("disaggregated pool roles (set_pool_role)", "A.3")

    def set_speculation(self, enabled):
        raise not_ported("speculative decoding (set_speculation)", "A.3")

    def capture_snapshot(self, req):
        raise not_ported("live KV migration snapshots (capture_snapshot)", "A.3")

    def evacuate_request(self, req, instant="request/migrated_out"):
        raise not_ported("live KV migration (evacuate_request)", "A.3")

    def evacuate(self):
        raise not_ported("live KV migration (evacuate)", "A.3")

    # ------------------------------------------------------------ submission
    def submit(self, request, **kwargs):
        """Admit a request into the bounded queue (or shed it with a reason).

        ``request``: Request | dict | token array (kwargs become Request
        fields for the array form). Returns the Request; check ``.state`` —
        REJECTED means admission control shed it (``.reject_reason`` in
        {queue_full, prompt_too_long, bad_request, no_free_blocks})."""
        if kwargs and not isinstance(request, (Request, dict)):
            req = Request(prompt=np.asarray(request), **kwargs)
        else:
            req = as_request(request)
        if req.request_id is None:
            req.request_id = self._next_id
            self._next_id += 1
        if req.trace_id is None:
            req.trace_id = f"req-{req.request_id:06d}"
        req.submit_time = self.clock.now()
        if req.arrival_time is not None and not req.arrival_resolved:
            # direct submit(): arrival_time is an offset from now (same
            # contract as serve())
            req.arrival_time += req.submit_time
            req.arrival_resolved = True
        reason = self.queue.admit(
            req, self.max_len,
            kv_fits=self.pool_mgr.fits_ever if self.paged else None)
        if reason is None:
            self.metrics.record_submit(req)
            self.tracer.instant(
                "request/queued", cat="serving", request_id=req.request_id,
                trace_id=req.trace_id, prompt_len=req.prompt_len,
                start=req.start_time)
        else:
            self.metrics.record_shed(reason, req)
            self.tracer.instant("request/shed", cat="serving",
                                request_id=req.request_id,
                                trace_id=req.trace_id, reason=reason)
        return req

    # ------------------------------------------------------------- the loop
    @torch.no_grad()
    def step(self):
        """One scheduler iteration: admit queued requests into free slots,
        advance at most one pending prefill chunk (chunked prefill), grow or
        preempt paged slots whose cursor reached the end of their blocks
        (on-demand growth), then run one decode step over the pool. Returns
        the list of TokenEvents produced."""
        events = []
        can_admit = self._make_can_admit() if self.paged else None
        admitted = self.scheduler.next_admissions(len(self._free_slots),
                                                  self.clock.now(),
                                                  can_admit=can_admit)
        for req in admitted:
            self._start_request(req, events)
        if self._prefill_jobs and self._chunk_due():
            self._advance_prefill(events)
        if self.growth and self._slots:
            self._grow_or_preempt()
        if self._slots:
            self._decode_once(events)
            self._decode_steps_since_chunk += 1
        elif not admitted and not self._prefill_jobs and self.queue.depth:
            # nothing running and the queue head hasn't arrived yet (direct
            # submit with a future arrival offset): idle the clock forward to
            # it, or a virtual-clock step() loop would spin forever
            head = self.queue.peek()
            if head.arrival_time is not None:
                gap = head.arrival_time - self.clock.now()
                if gap > 0:
                    self.clock.sleep(gap)
        self.metrics.observe_step(self.queue.depth, len(self._slots))
        return events

    def _make_can_admit(self):
        """Block-aware admission predicate for the scheduler. The queue head
        waits until enough blocks are free, evictable, or unreserved; a
        granted admission RESERVES its blocks in the pool manager (chunked
        prefill opens a multi-step window between admission and slot insert,
        and growth or later admissions must not steal the head's blocks
        meanwhile). Prefix sharing is ignored here (a hit only needs FEWER
        blocks, so the check stays sound)."""
        def can_admit(req):
            if self.growth:
                need = self.pool_mgr.blocks_for_prefill(
                    self._growth_admission_len(req))
            else:
                need = self.pool_mgr.blocks_for(req.prompt_len,
                                                req.max_new_tokens)
            if not self.pool_mgr.can_allocate(need):
                return False
            self.pool_mgr.reserve(need)
            req.reserved_blocks = need
            return True

        return can_admit

    @staticmethod
    def _prefill_len(req):
        """Positions the request's prefill writes: the prompt, plus — on a
        preemption resume — every already-generated token except the last
        (which decode re-feeds at the cursor)."""
        return req.prompt_len + max(len(req.tokens) - 1, 0)

    def _growth_admission_len(self, req):
        """Positions a growth-mode admission must cover: the prefill PLUS the
        first decode write whenever the request will decode at all. Sizing
        only the prefill livelocks: a resumed request re-entering exactly at
        a block boundary would have to grow before producing a token while
        the queue head's reservation holds the pool's last blocks."""
        will_decode = bool(req.tokens) or req.max_new_tokens > 1
        return self._prefill_len(req) + (1 if will_decode else 0)

    def _unreserve(self, req):
        """Cancel an admission-time block reservation (early finish paths
        that never reach the slot insert)."""
        if req.reserved_blocks:
            self.pool_mgr.consume_reservation(req.reserved_blocks)
            req.reserved_blocks = 0

    def _chunk_due(self):
        """A pending prefill chunk runs when nothing is decoding, when
        chunking is off (preemption-resume jobs complete in one shot), or
        once the configured decode steps have run since the last chunk."""
        if not self.chunked or not self._slots:
            return True
        return (self._decode_steps_since_chunk
                >= self.cfg.chunked_prefill.decode_steps_between_chunks)

    def _request_key(self, req):
        """(first-token key, slot-stream key) of the request: from its seed,
        or from the engine seed and the request id."""
        if req.sampling.seed is not None:
            base = rng_key(_SEEDED, int(req.sampling.seed))
        else:
            base = rng_key(self.engine.config.seed, req.request_id)
        return rng_key(base, _FIRST_STREAM), rng_key(base, _SLOT_STREAM)

    def _ids_tensor(self, tokens, padded):
        ids = np.zeros((1, padded), np.int64)
        ids[0, :len(tokens)] = tokens
        return torch.as_tensor(ids, device=self.device)

    def _start_request(self, req, events):
        resume = bool(req.tokens)  # preempted request rejoining from the queue
        if resume and len(req.tokens) > 1:
            # replay prefill: prompt + every generated token except the last
            # (decode re-feeds it at the cursor) — rebuilding exactly the KV
            # coverage the preemption released
            ids_full = np.concatenate(
                [req.prompt, np.asarray(req.tokens[:-1], np.int32)])
        else:
            ids_full = req.prompt
        if req.prefill_start_time is None:
            # queue-wait window closes at the FIRST slot grant
            req.prefill_start_time = self.clock.now()
            self.metrics.record_queue_wait(req)
        shared_len, shared_blocks = 0, []
        if self.paged:
            # take refs on matched prefix blocks NOW so an eviction between
            # here and the slot insert can't dangle them
            shared_len, shared_blocks = self.pool_mgr.acquire_prefix(ids_full)
        if shared_len and not resume:
            req.prefix_saved_tokens += shared_len
            self.metrics.prefix_saved_tokens += shared_len
        if resume or (self.chunked and len(ids_full) - shared_len > self.chunk_size):
            # multi-step prefill (chunked and/or resume replay): reserve the
            # slot now, seed the partial cache, and let the step loop drive
            # chunks interleaved with decode steps (_advance_prefill)
            slot = self._free_slots.pop()
            cache = self._seed_cache(shared_blocks) if shared_len else self._fresh_cache()
            self._prefill_jobs.append(_PrefillJob(
                req=req, slot=slot, cache=cache,
                ids=np.asarray(ids_full, np.int32), pos=shared_len,
                shared_len=shared_len, shared_blocks=shared_blocks,
                resume=resume))
            return
        if shared_len:
            # shared-prefix hit: seed a dense view from the (partly shared)
            # block row and prefill ONLY the suffix. The ceiling shrinks by
            # the shared prefix: the suffix q-block is written AT
            # pos=shared_len, and a bucket past max_len would overrun the
            # window (bucket 64 + shared 16 in a 64 window)
            suffix = req.prompt[shared_len:]
            padded = self.engine._bucket_prompt_len(
                len(suffix), self.max_len - shared_len)
            req.padding_tokens += padded - len(suffix)
            self.metrics.record_prefill_work(padded, len(suffix))
            with self.tracer.span("prefill", cat="serving",
                                  request_id=req.request_id, n=len(suffix),
                                  padded_len=padded, shared_len=shared_len):
                cache = self._seed_cache(shared_blocks)
                logits, cache = self._suffix_program(
                    self._ids_tensor(suffix, padded), cache, shared_len, len(suffix))
                # the prefix-cache win in virtual time: only the suffix pays
                self.clock.advance(padded * self.cfg.virtual_prefill_cost_per_token)
        else:
            # ceiling is the full slot window: pad rows past the cursor are
            # causally masked and then overwritten one by one as decode
            # advances, so one bucket serves every max_new_tokens
            padded = self.engine._bucket_prompt_len(req.prompt_len, self.max_len)
            req.padding_tokens += padded - req.prompt_len
            self.metrics.record_prefill_work(padded, req.prompt_len)
            with self.tracer.span("prefill", cat="serving",
                                  request_id=req.request_id, n=req.prompt_len,
                                  padded_len=padded):
                logits, cache = self._prefill_program(
                    self._ids_tensor(req.prompt, padded), req.prompt_len)
                self.clock.advance(padded * self.cfg.virtual_prefill_cost_per_token)
        self._after_prefill(req, cache, shared_len, shared_blocks, logits, events)

    def _after_prefill(self, req, cache, shared_len, shared_blocks, logits,
                       events, slot=None):
        """Sample the first token from the prefill logits and either finish
        the request immediately or bind a slot. ``slot`` is the job-reserved
        slot for chunked prefills (freed back on an early finish);
        single-shot prefills pop one here."""
        first_key, chain_key = self._request_key(req)
        s = req.sampling
        t, nf = self._sample_first(logits, first_key, s)
        now = self.clock.now()
        if nf:
            self.metrics.record_health_step(1)
        req.state = RequestState.RUNNING
        req.first_token_time = now
        req.tokens.append(t)
        self.metrics.record_tokens(1, req)
        self.metrics.record_first_token(req)
        self.tracer.instant("request/first_token", cat="serving", ts=now,
                            request_id=req.request_id, trace_id=req.trace_id)

        eos = req.eos_token_id
        if (eos is not None and t == eos) or t in req.stop_token_ids \
                or req.max_new_tokens == 1:
            if eos is not None and t == eos:
                reason = FINISH_EOS
            elif t in req.stop_token_ids:
                reason = FINISH_STOP
            else:
                reason = FINISH_LENGTH
            if self.paged:
                # finished at the first token: no blocks were bound
                self.pool_mgr.release_blocks(shared_blocks)
                self._unreserve(req)
            if slot is not None:
                self._free_slots.append(slot)
            self._finish(req, reason, now)
            events.append(TokenEvent(req.request_id, t, 0, True, reason, now))
            return
        if slot is None:
            slot = self._free_slots.pop()
        self._slots[slot] = req
        req.slot = slot
        if req.admit_seq < 0:
            # preemption-victim ordering: newest admission yields first; a
            # RESUMED request keeps its original seniority
            req.admit_seq = self._admit_seq
            self._admit_seq += 1
        chain = (chain_key, 0)
        if self.paged:
            self._insert_paged(req, slot, cache, shared_len, shared_blocks,
                               t, chain, s, eos, req.max_new_tokens - 1)
        else:
            insert_slot_kv(self._pool(), cache, slot)
            self._insert_meta(slot, t, req.prompt_len, req.max_new_tokens - 1,
                              chain, s, eos)
        events.append(TokenEvent(req.request_id, t, 0, False, None, now))

    # ----------------------------------------------- chunked prefill driver
    def _advance_prefill(self, events):
        """Run ONE prefill chunk of the oldest pending job (the whole
        remaining suffix when chunking is off — preemption-resume replays).
        Each chunk is a suffix prefill: the q block is written at the job's
        cursor against its partial cache."""
        job = self._prefill_jobs[0]
        remaining = len(job.ids) - job.pos
        n = min(self.chunk_size, remaining) if self.chunked else remaining
        # ceiling shrinks by the already-prefilled prefix (the same overrun
        # guard as the shared-prefix suffix path)
        padded = self.engine._bucket_prompt_len(n, self.max_len - job.pos)
        req = job.req
        req.chunks += 1
        req.padding_tokens += padded - n
        if job.resume:
            # every replayed position is device work a preemption burned
            req.replay_tokens += n
        self.metrics.record_prefill_work(padded, n, replay=n if job.resume else 0)
        with self.tracer.span("prefill_chunk", cat="serving",
                              request_id=req.request_id, n=n, padded_len=padded,
                              start=job.pos, resume=job.resume):
            logits, job.cache = self._suffix_program(
                self._ids_tensor(job.ids[job.pos:job.pos + n], padded), job.cache,
                job.pos, n)
            self.clock.advance(padded * self.cfg.virtual_prefill_cost_per_token)
        job.pos += n
        self._decode_steps_since_chunk = 0
        if job.done:
            self._prefill_jobs.popleft()
            self._complete_job(job, logits, events)

    def _complete_job(self, job, logits, events):
        req = job.req
        if not job.resume:
            self._after_prefill(req, job.cache, job.shared_len, job.shared_blocks,
                                logits, events, slot=job.slot)
            return
        # resume: splice back at the saved cursor with the stream captured at
        # preemption — no first token is sampled (the last streamed token is
        # re-fed at the cursor), so the stream continues bitwise-identically
        slot, s, eos = job.slot, req.sampling, req.eos_token_id
        remaining = req.max_new_tokens - len(req.tokens)
        req.state = RequestState.RUNNING
        self._slots[slot] = req
        req.slot = slot
        if self.paged:
            self._insert_paged(req, slot, job.cache, job.shared_len,
                               job.shared_blocks, req.tokens[-1], req.resume_rng,
                               s, eos, remaining)
        else:
            insert_slot_kv(self._pool(), job.cache, slot)
            self._insert_meta(slot, req.tokens[-1], self._prefill_len(req),
                              remaining, req.resume_rng, s, eos)
        self.tracer.instant("request/resumed", cat="serving", ts=self.clock.now(),
                            request_id=req.request_id, trace_id=req.trace_id,
                            n_tokens=len(req.tokens), preemptions=req.preemptions,
                            replay_tokens=len(job.ids) - job.shared_len)

    # ------------------------------------------------- on-demand growth
    def _grow_or_preempt(self):
        """Reserve-as-you-decode: before the decode step, any active slot
        whose write cursor reached the end of its bound blocks grows by one
        block; when the pool can't provide one, the NEWEST-admitted running
        request is preempted back to the queue head (its blocks free, its
        stream resumes bitwise-identically later) instead of OOM/shed."""
        mgr = self.pool_mgr
        for slot in sorted(list(self._slots)):
            req = self._slots.get(slot)
            if req is None:
                continue  # preempted earlier in this same pass
            pos = req.prompt_len + len(req.tokens) - 1  # this step's write
            j = pos // mgr.block_size
            if j < mgr.slot_block_count(slot):
                continue
            preempted_self = False
            while not mgr.can_allocate(1):
                victim = max(self._slots, key=lambda s_: self._slots[s_].admit_seq)
                self._preempt(victim)
                if victim == slot:
                    preempted_self = True
                    break
            if preempted_self:
                continue
            bid = mgr.grow_slot(slot, live_tokens=pos + 1)
            req.kv_blocks_peak = max(req.kv_blocks_peak, j + 1)
            self._state["table"][slot, j] = bid

    def _preempt(self, slot):
        """Preempt-to-queue: capture the slot's sampling stream (the resume
        needs it exactly), release its blocks and table row, and push the
        request back to the QUEUE HEAD (FCFS by original admission)."""
        req = self._slots.pop(slot)
        req.resume_rng = self._state["rng"][slot].cpu().numpy().copy()
        req.preemptions += 1
        self.pool_mgr.preempted_requests += 1
        self.metrics.record_preempt()
        self._release(slot)
        self.pool_mgr.free_slot(slot)
        self._free_slots.append(slot)
        req.slot = None
        self.queue.push_front(req)
        self.tracer.instant("request/preempted", cat="serving",
                            ts=self.clock.now(), request_id=req.request_id,
                            trace_id=req.trace_id, n_tokens=len(req.tokens))

    def _insert_paged(self, req, slot, cache, shared_len, shared_blocks, tok, rng,
                      s, eos, remaining):
        """Bind a paged slot: allocate the request's footprint in blocks,
        copy the freshly-prefilled PRIVATE blocks from the dense cache
        (shared prefix blocks are refcounted, never copied — copy-on-write),
        set the slot's table row + scalars, and content-address the full
        prompt blocks for future prefix hits. Under on-demand growth the
        footprint is only the PREFILLED positions (+ the first decode write);
        decode blocks arrive via ``_grow_or_preempt``."""
        mgr = self.pool_mgr
        prefill_len = self._prefill_len(req)
        needed = mgr.blocks_for_prefill(self._growth_admission_len(req)) \
            if self.growth \
            else mgr.blocks_for(req.prompt_len, req.max_new_tokens)
        # the scheduler's can_admit reserved this; alloc may still evict
        self._unreserve(req)
        private = mgr.alloc(needed - len(shared_blocks))
        blocks = list(shared_blocks) + private
        if private:
            insert_block_kv(self._pool(), cache, private,
                            len(shared_blocks) * mgr.block_size, mgr.block_size)
        row = np.full((mgr.blocks_per_slot,), GARBAGE_BLOCK, np.int32)
        row[:len(blocks)] = blocks
        self._insert_meta(slot, tok, prefill_len, remaining, rng, s, eos,
                          table_row=row)
        mgr.bind_slot(slot, blocks,
                      self._growth_admission_len(req) if self.growth
                      else req.prompt_len + req.max_new_tokens - 1)
        req.kv_blocks_peak = max(req.kv_blocks_peak, len(blocks))
        mgr.register_prefix(req.prompt, blocks)

    def _decode_once(self, events):
        with self.tracer.span("decode_step", cat="serving", active=len(self._slots)):
            toks, done_now, nonfinite = self._decode()
            self.clock.advance(self.cfg.virtual_decode_step_cost)
        self.metrics.record_decode_dispatch()
        now = self.clock.now()
        self.metrics.record_health_step(
            sum(1 for s in self._slots if nonfinite[s] > 0))
        for slot in sorted(self._slots):
            req = self._slots[slot]
            t = int(toks[slot])
            req.tokens.append(t)
            self.metrics.record_tokens(1, req)
            self.metrics.record_decode_tokens(1)
            if done_now[slot]:
                reason = FINISH_EOS if (req.eos_token_id is not None
                                        and t == req.eos_token_id) \
                    else FINISH_LENGTH
            elif t in req.stop_token_ids:
                # stop sequences are host-side policy (a set, not the single
                # device-tracked eos id): finish here and deactivate the slot
                reason = FINISH_STOP
            else:
                events.append(TokenEvent(req.request_id, t, len(req.tokens) - 1,
                                         False, None, now))
                continue
            self._finish(req, reason, now, deactivate=(reason == FINISH_STOP))
            events.append(TokenEvent(req.request_id, t, len(req.tokens) - 1,
                                     True, reason, now))

    def _finish(self, req, reason, now, deactivate=False):
        """``deactivate``: the device doesn't know this slot finished (host-
        side stop policy) — clear its active flag so decode stops advancing
        it. EOS/length finishes already cleared it inside the decode step."""
        req.state = RequestState.FINISHED
        req.finish_reason = reason
        req.finish_time = now
        if req.slot is not None:
            del self._slots[req.slot]
            self._free_slots.append(req.slot)
            if self.paged:
                # ALWAYS release under paging: the table row must retreat to
                # the garbage block before the allocator reuses the blocks
                self._release(req.slot)
                self.pool_mgr.free_slot(req.slot)
            elif deactivate or self.cfg.scrub_freed_slots:
                self._release(req.slot)
            req.slot = None
        self.metrics.record_finish(req)
        self.tracer.instant("request/finish", cat="serving", ts=now,
                            request_id=req.request_id, trace_id=req.trace_id,
                            reason=reason, n_tokens=len(req.tokens),
                            prompt_len=req.prompt_len, queue_wait=req.queue_wait,
                            chunks=req.chunks, preemptions=req.preemptions,
                            replay_tokens=req.replay_tokens,
                            padding_tokens=req.padding_tokens,
                            prefix_saved_tokens=req.prefix_saved_tokens,
                            kv_blocks_peak=req.kv_blocks_peak)

    # ------------------------------------------------------------- frontends
    def serve(self, requests=None, yield_rejections=True):
        """Streaming frontend: feed ``requests`` (each optionally carrying an
        ``arrival_time`` offset) through the continuous-batching loop,
        yielding ``TokenEvent``s as they are produced. Runs until every
        accepted request finishes; shed requests surface as a single done
        event with ``finish_reason="rejected:<reason>"`` (and ``token ==
        -1``)."""
        pending = sorted((as_request(r) for r in (requests or [])),
                         key=lambda r: r.arrival_time or 0.0)
        t0 = self.clock.now()
        for r in pending:
            # arrival offsets -> absolute clock times (TTFT counts queueing)
            if not r.arrival_resolved:
                r.arrival_time = t0 + (r.arrival_time or 0.0)
                r.arrival_resolved = True
            elif r.arrival_time is None:
                r.arrival_time = t0
        try:
            while pending or self.queue.depth or self._slots or self._prefill_jobs:
                now = self.clock.now()
                while pending and pending[0].arrival_time <= now:
                    req = self.submit(pending.pop(0))
                    if req.state is RequestState.REJECTED and yield_rejections:
                        yield TokenEvent(req.request_id, -1, -1, True,
                                         f"rejected:{req.reject_reason}", now)
                if not self._slots and not self.queue.depth \
                        and not self._prefill_jobs:
                    if not pending:
                        break
                    # idle until the next arrival
                    self.clock.sleep(max(pending[0].arrival_time - now, 1e-4))
                    continue
                for ev in self.step():
                    yield ev
        finally:
            self.tracer.flush()
            self.metrics.emit_events()

    def run(self, requests):
        """Non-streaming convenience: serve ``requests`` to completion and
        return ``(finished, rejected, metrics_snapshot)``."""
        reqs = [as_request(r) for r in (requests or [])]
        for _ in self.serve(reqs, yield_rejections=False):
            pass
        finished = [r for r in reqs if r.state is RequestState.FINISHED]
        rejected = [r for r in reqs if r.state is RequestState.REJECTED]
        return finished, rejected, self.metrics.snapshot()

    def destroy(self):
        """Drop the slot pool (its KV memory) and any in-flight work."""
        self._state = None
        self._prefill_jobs = collections.deque()
        self._slots = {}
        self._free_slots = list(range(self.n_slots - 1, -1, -1))
        self.tracer.flush()
