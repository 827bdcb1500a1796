"""Scheduler clocks (copy of ``deepspeed_tpu/serving/clock.py``).

``WallClock`` is production serving; ``VirtualClock`` makes scheduling
deterministic for tests and simulation — time advances ONLY by the cost model
(`n` units per decode step, `m` per prefill token), so a unit test can assert
exact TTFT/throughput numbers and compare scheduling policies without touching
real time.
"""

import time


class WallClock:
    def now(self):
        return time.perf_counter()

    def advance(self, cost):
        """Real time advances by itself; scheduler cost hints are ignored."""

    def sleep(self, seconds):
        if seconds > 0:
            time.sleep(seconds)


class VirtualClock:
    def __init__(self, start=0.0):
        self._now = float(start)

    def now(self):
        return self._now

    def advance(self, cost):
        self._now += float(cost)

    def sleep(self, seconds):
        """Virtual sleep = jump forward (waiting for the next arrival)."""
        if seconds > 0:
            self._now += float(seconds)
