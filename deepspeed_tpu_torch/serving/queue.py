"""Bounded FCFS request queue with load-aware admission control (copy of
``deepspeed_tpu/serving/queue.py``).

The queue is the backpressure point: depth is bounded, and a request that
would exceed the bound (or could never fit a slot's KV window) is shed at
submit time with a machine-readable reason — the serving layer degrades by
rejecting work, never by growing host/device memory until it falls over.
"""

import collections

from .request import (CLASS_BATCH, CLASS_INTERACTIVE, REJECT_BAD_REQUEST,
                      REJECT_NO_FREE_BLOCKS, REJECT_PROMPT_TOO_LONG,
                      REJECT_QUEUE_FULL, RequestState)


class RequestQueue:
    def __init__(self, max_depth):
        self.max_depth = int(max_depth)
        self._q = collections.deque()
        self.shed_counts = collections.Counter()

    def __len__(self):
        return len(self._q)

    @property
    def depth(self):
        return len(self._q)

    def admit(self, request, max_total_len, kv_fits=None):
        """Admission control: accept ``request`` into the queue or shed it.

        Returns None on admission; on shed, marks the request REJECTED and
        returns the reason string. ``max_total_len`` is the per-slot KV
        window that prompt + generation must fit. ``kv_fits`` (paged KV
        pool): (prompt_len, max_new_tokens) -> bool — False means the
        request's block footprint exceeds what the pool could EVER free, so
        queueing it would wait forever: shed ``no_free_blocks`` now."""
        reason = None
        if request.prompt_len < 1 or request.max_new_tokens < 1 \
                or request.tenant_class not in (CLASS_INTERACTIVE,
                                                CLASS_BATCH):
            reason = REJECT_BAD_REQUEST
        elif request.prompt_len + request.max_new_tokens > max_total_len:
            reason = REJECT_PROMPT_TOO_LONG
        elif kv_fits is not None and not kv_fits(request.prompt_len,
                                                request.max_new_tokens):
            reason = REJECT_NO_FREE_BLOCKS
        elif len(self._q) >= self.max_depth:
            reason = REJECT_QUEUE_FULL
        if reason is not None:
            request.state = RequestState.REJECTED
            request.reject_reason = reason
            self.shed_counts[reason] += 1
            return reason
        request.state = RequestState.QUEUED
        self._q.append(request)
        return None

    def pop(self):
        return self._q.popleft()

    def pop_at(self, index):
        """Remove and return the request at ``index`` (head-of-line bypass:
        the scheduler admits a later request past a blocked head under its
        bounded-starvation window)."""
        req = self._q[index]
        del self._q[index]
        return req

    def peek(self):
        return self._q[0] if self._q else None

    def peek_at(self, index):
        return self._q[index]

    def push_front(self, request):
        """Re-queue an ALREADY-ADMITTED request at the head (on-demand-growth
        preemption: the request was running, so it outranks everything queued
        behind it — FCFS by original admission order). Bypasses admission
        control: its footprint passed ``fits_ever`` at submit and depth
        bounds protect arrivals, not returners."""
        request.state = RequestState.QUEUED
        self._q.appendleft(request)
