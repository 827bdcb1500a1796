"""Continuous-batching scheduler policy, the Orca-style iteration loop (port of
``deepspeed_tpu/serving/scheduler.py``).

``ServingScheduler`` decides, at each scheduler step, which queued requests to
prefill into free decode slots — FCFS, with at most ``max_prefills_per_step``
prefills interleaved per step so an arrival burst can't starve running
decodes (TPOT protection). The device-side mechanics (prefill, slot insert,
decode step) live in ``serving/engine.py``; this module is pure host policy,
so it is exactly simulable under the virtual clock.

``hol_bypass_limit`` relaxes strict FCFS under block-aware admission: when
the queue head's KV footprint cannot fit but a later request's can, up to
``limit`` later requests may be admitted past the stuck head before
admissions stop until the head clears — work keeps flowing without unbounded
starvation of the big request. 0 (the default) preserves strict FCFS.

``policy="weighted_fair"`` (start-time fair queuing across tenants) is not
ported yet and raises naming its ROADMAP item.

``simulate_static_batching`` is the baseline the continuous scheduler is
measured against: classic whole-batch serving, where a batch of ``n_slots``
requests decodes until its LONGEST member finishes before any new request
starts. The shared virtual cost model (decode step / prefill token) makes
the comparison apples-to-apples.
"""

from ..utils import not_ported


class ServingScheduler:
    """FCFS admission from the bounded queue into free slots."""

    def __init__(self, queue, n_slots, max_prefills_per_step=1,
                 policy="fcfs", hol_bypass_limit=0):
        if policy == "weighted_fair":
            raise not_ported("serving.policy='weighted_fair' (tenant fair queuing)", "A.3")
        if policy != "fcfs":
            raise ValueError(f"unknown scheduling policy {policy!r}")
        self.queue = queue
        self.n_slots = n_slots
        self.policy = policy
        self.max_prefills_per_step = max(int(max_prefills_per_step), 1)
        self.hol_bypass_limit = max(int(hol_bypass_limit), 0)
        # bounded-starvation window: how many requests have overtaken the
        # CURRENT stuck head (reset whenever the head is admitted/replaced)
        self._hol_head = None
        self._hol_bypasses = 0

    def next_admissions(self, free_slots, now, can_admit=None):
        """Requests to prefill this step: bounded by free slots AND the
        per-step prefill cap. ``now`` gates open-loop arrivals that were
        queued with a future arrival_time (virtual-clock simulations).

        ``can_admit``: optional capacity predicate (the paged KV pool's
        block-availability check). A head it rejects WAITS at the front —
        FCFS — unless ``hol_bypass_limit`` grants a later arrived-and-
        fitting request one of its bounded bypass slots."""
        out = []
        budget = min(free_slots, self.max_prefills_per_step)
        while budget > 0 and len(self.queue):
            head = self.queue.peek()
            if head.arrival_time is not None and head.arrival_time > now:
                break  # FCFS: nothing behind it may jump a not-yet-arrival
            if can_admit is not None and not can_admit(head):
                bypassed = self._try_bypass(now, can_admit)
                if bypassed is None:
                    break  # hold the line until running requests free blocks
                out.append(bypassed)
                budget -= 1
                continue
            if self._hol_head == head.request_id:
                # the stuck head finally fits: its starvation window closes
                self._hol_head = None
                self._hol_bypasses = 0
            out.append(self.queue.pop())
            budget -= 1
        for req in out:
            # admission stamp for the queue-wait breakdown; a preemption-
            # resume re-admission keeps the ORIGINAL stamp (its queue-wait
            # window closed at the first prefill)
            if req.admit_time is None:
                req.admit_time = now
        return out

    def _try_bypass(self, now, can_admit):
        """One bounded-starvation bypass of a blocked head, or None.

        The window is per stuck head: once ``hol_bypass_limit`` requests have
        overtaken it, nothing more is admitted until the head itself clears
        (so the big request is delayed by at most ``limit`` overtakers, not
        forever). The caller's ``can_admit`` carries the reservation
        counter, so a granted bypass reserves its blocks exactly like a
        head admission would."""
        if self.hol_bypass_limit <= 0:
            return None
        head = self.queue.peek()
        if self._hol_head != head.request_id:
            self._hol_head = head.request_id
            self._hol_bypasses = 0
        if self._hol_bypasses >= self.hol_bypass_limit:
            return None
        for i in range(1, len(self.queue)):
            cand = self.queue.peek_at(i)
            if cand.arrival_time is not None and cand.arrival_time > now:
                break  # arrivals are time-ordered; nothing further is due
            if can_admit(cand):
                self._hol_bypasses += 1
                return self.queue.pop_at(i)
        return None


def simulate_static_batching(requests, n_slots, *, prefill_cost_per_token,
                             decode_step_cost, bucket_len):
    """Virtual cost of serving ``requests`` with static whole-batch batching.

    Requests are grouped FCFS into batches of ``n_slots``. Each batch pays
    one bucketed-prompt prefill (the batch pads to its longest prompt bucket,
    like a fixed-shape ``generate()`` call) plus ``max(max_new_tokens) - 1``
    decode steps — every short request idles its slot until the longest
    member finishes, which is exactly the utilization gap continuous batching
    closes. Returns ``(total_tokens, virtual_time)``.
    """
    total_tokens = 0
    t = 0.0
    reqs = list(requests)
    for i in range(0, len(reqs), n_slots):
        batch = reqs[i:i + n_slots]
        padded = max(bucket_len(r.prompt_len) for r in batch)
        # one batched prefill (generously: no extra cost for the extra rows),
        # whose logits yield every request's FIRST token — then decode steps
        # until the longest member is done
        t += padded * prefill_cost_per_token
        t += max(r.max_new_tokens - 1 for r in batch) * decode_step_cost
        total_tokens += sum(r.max_new_tokens for r in batch)
    return total_tokens, t
