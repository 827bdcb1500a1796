"""Serving metrics: TTFT/TPOT histograms, throughput, occupancy, shed rate
(copy of ``deepspeed_tpu/serving/metrics.py``).

The serving loop records samples host-side; ``snapshot()`` is the
machine-readable rollup, kept key for key as in the JAX package so a run of
both on the same schedule gives equal snapshots. ``Serving/*`` scalar events
go to a ``monitor`` (an object with ``write_events``) when the caller gives
one; the port's monitor backends are ROADMAP A.3, so by default there is none.
The speculative, migration and tenancy blocks stay in the snapshot (all
zero here) so it keeps the JAX package's keys.
"""

import collections

from ..telemetry.digest import LatencyDigest, evaluate_slo
from .request import FINISH_UNHEALTHY


def percentile(samples, q):
    """Nearest-rank percentile (q in [0, 100]); None on no samples."""
    if not samples:
        return None
    s = sorted(samples)
    idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
    return s[idx]


def slo_digest_events(digests, goodput_frac, slo, step, tracer=None,
                      counter=None):
    """Digest-derived P99 + goodput scalars and the slo_violation event —
    shared by the per-replica ServingMetrics cadence and the Router's
    fleet-merged cadence (same names, different monitor). The emitted P99
    IS the digest quantile: tier-1 pins it equal to the snapshot and to a
    digest rebuilt from the merged trace. ``counter``: object whose
    ``slo_violations`` tallies emit intervals with a violated target."""
    events = []
    for name, d in digests.items():
        p99 = d.quantile_ms(99)
        if p99 is not None:
            events.append((f"Serving/{name}_p99_ms", p99, step))
    events.append(("Serving/goodput_frac", float(goodput_frac), step))
    targets = slo.targets_ms() if slo is not None else {}
    grade = evaluate_slo(targets, digests)
    if grade["configured"]:
        burn = max(grade["burn_rate"].values(), default=0.0)
        events.append(("Serving/slo_burn_rate", burn, step))
        if not grade["pass"]:
            if counter is not None:
                counter.slo_violations += 1
            if tracer is not None:
                for metric, bad in grade["violated"].items():
                    if not bad:
                        continue
                    tracer.instant(
                        "slo/violation", cat="serving", metric=metric,
                        observed_p99_ms=grade["observed_p99_ms"][metric],
                        target_ms=grade["targets_ms"][metric],
                        burn_rate=grade["burn_rate"][metric])
        if counter is not None:
            events.append(("Serving/slo_violations",
                           float(counter.slo_violations), step))
    return events


class ServingMetrics:
    def __init__(self, n_slots, clock, monitor=None, interval=32,
                 kv_pool=None, slo=None, tracer=None):
        self.n_slots = n_slots
        self.clock = clock
        self.monitor = monitor
        self.interval = int(interval)
        # paged KV pool stats source (KVPoolManager.stats): block occupancy,
        # internal fragmentation, prefix hit rate — the memory-side truth
        # the slot-occupancy number no longer tells under paging
        self.kv_pool = kv_pool
        # router stats source (Router._router_stats, installed when this
        # replica registers with a Router): snapshot()["router"] then shows
        # the cross-replica view, coherent with the Serving/router_* events
        self.router = None
        self.start_time = clock.now()
        self._started = False       # start_time re-pins at first activity
        self._window_tokens = 0     # tokens since the last reset_window()
        self.total_tokens = 0
        self.submitted = 0
        self.finished = 0
        self.shed = collections.Counter()
        self.ttft_samples = []     # seconds (or virtual units)
        self.tpot_samples = []
        self.steps = 0
        self._queue_depth = 0
        self._active_slots = 0
        self.active_slots_peak = 0   # paged pool's ">= 2x effective slots" pin
        # numerics health (fed by the decode program's in-graph
        # nonfinite-logit count; see serving/engine.py _decode_once)
        self.nonfinite_logit_steps = 0  # decode steps with >=1 bad active slot
        self.unhealthy_slots = 0        # requests shed via unhealthy_slot
        # on-demand growth: requests preempted back to the queue on pool
        # exhaustion (they resume; NOT part of the shed/finished partition)
        self.preempted = 0
        # streaming SLO percentiles: mergeable fixed-bucket digests next to
        # the exact sample lists (the lists stay the PR 4 trace==metrics
        # currency; the digests are what rolls up across replicas and what
        # the Serving/*_p99_ms events and serving.slo grading read)
        self.ttft_digest = LatencyDigest()
        self.tpot_digest = LatencyDigest()
        self.queue_wait_digest = LatencyDigest()
        # serving.slo block (None/unarmed = no objectives) + the tracer the
        # structured slo/violation events ride (set by the engine after its
        # tracer exists)
        self.slo = slo
        self.tracer = tracer
        self.slo_violations = 0   # emit intervals with >=1 violated target
        self.window_resets = 0    # reset_window() calls (warmup exclusion)
        # multi-tenant QoS: per-tenant counters + latency digests, keyed by
        # tenant_id (populated lazily — a single-tenant engine pays one
        # "default" entry). Counters are CUMULATIVE (survive reset_window,
        # like submitted/finished/shed); the digests reset with the window
        # under the same epoch guard the global digests use, so a warmup
        # cannot pollute a tenant's SLO grade. tenants_cfg (set by the
        # engine when serving.tenants is configured) supplies per-class
        # ttft_p99_ms overrides for the per-tenant grade.
        self.tenants = {}
        self.tenants_cfg = None
        # degraded-mode hook (set by the engine when serving.degraded is
        # armed): a callable returning the current ladder level, mirrored
        # as the Serving/degraded_level scalar on the emit cadence
        self.degraded = None
        # full-ladder state for snapshot()["degraded"] (level, rung,
        # residency, transitions) — set alongside ``degraded``
        self.degraded_snapshot = None
        # priority preemptions: evictions of a batch-class stream by an
        # interactive arrival (a subset of ``preempted``)
        self.priority_evictions = 0
        # goodput accounting, in DEVICE TOKENS of work (the virtual cost
        # model's currency: one prefill dispatch costs its padded length,
        # one decode step yields one token per active slot). useful = fresh
        # prefill positions + decode tokens; wasted = preemption replay +
        # bucket padding; prefix-cache savings are work NEVER dispatched
        # (reported, not part of the frac).
        self.prefill_device_tokens = 0
        self.replay_tokens = 0
        self.padding_tokens = 0
        self.prefix_saved_tokens = 0
        self.decode_tokens = 0
        # speculative decoding (serving/speculative.py): candidate tokens
        # drafted, accepted by the one-forward verify, and rolled back,
        # plus the dispatch counter accepted_tokens_per_step is measured
        # against (decode + verify program dispatches — the denominator of
        # the ">1 effective decode tokens per step" claim). Armed by the
        # engine when serving.speculative is enabled (gates the
        # Serving/spec_* monitor events).
        self.speculative_armed = False
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rolled_back_tokens = 0
        self.verify_steps = 0
        self.decode_dispatches = 0
        # live KV migration (serving/migration.py): snapshots captured on
        # this replica, requests migrated out (drain) / spliced in, and the
        # positions a splice restored WITHOUT recompute (work avoided, like
        # prefix_saved_tokens — reported, not part of the goodput frac)
        self.kv_snapshots = 0
        self.migrations_out = 0
        self.migrations_in = 0
        self.migrated_saved_tokens = 0

    # -- recording ----------------------------------------------------------
    def _mark_started(self):
        # the throughput window opens at the FIRST request, not at engine
        # construction — a server idle for an hour must not dilute tokens/s
        if not self._started:
            self.start_time = self.clock.now()
            self._started = True

    def reset_window(self):
        """Re-open the measured window (e.g. after a warmup run): tokens/s
        reflects tokens since this call, and the streaming latency digests
        + goodput counters restart — a warmup's compile-time TTFTs would
        otherwise sit in the SLO grade forever (digests cannot age samples
        out). Cumulative counters (submitted/finished/shed/samples) keep
        the engine's lifetime story."""
        self.start_time = self.clock.now()
        self._started = True
        self._window_tokens = 0
        self.ttft_digest = LatencyDigest()
        self.tpot_digest = LatencyDigest()
        self.queue_wait_digest = LatencyDigest()
        self.prefill_device_tokens = 0
        self.replay_tokens = 0
        self.padding_tokens = 0
        self.prefix_saved_tokens = 0
        self.decode_tokens = 0
        # the speculative window restarts with the goodput window: the
        # accepted-tokens-per-step ratio must cover the same steps as its
        # decode_tokens numerator
        self.drafted_tokens = 0
        self.accepted_tokens = 0
        self.rolled_back_tokens = 0
        self.verify_steps = 0
        self.decode_dispatches = 0
        # per-tenant digests restart with the window too (same epoch), but
        # the per-tenant COUNTERS survive — a warmup reset must not erase
        # who submitted/was shed, only the latency samples it polluted
        for t in self.tenants.values():
            t["ttft_digest"] = LatencyDigest()
            t["tpot_digest"] = LatencyDigest()
        # recorded so trace readers know the live digests no longer cover
        # the whole trace (fleet_report downgrades its digest-coherence
        # gate to informational when a reset happened mid-run)
        self.window_resets += 1

    def _tenant(self, request):
        t = self.tenants.get(request.tenant_id)
        if t is None:
            t = self.tenants[request.tenant_id] = {
                "class": request.tenant_class,
                "submitted": 0, "finished": 0, "tokens": 0,
                "shed": collections.Counter(),
                "ttft_digest": LatencyDigest(),
                "tpot_digest": LatencyDigest(),
            }
        return t

    def record_submit(self, request=None):
        self._mark_started()
        self.submitted += 1
        if request is not None:
            self._tenant(request)["submitted"] += 1

    def record_shed(self, reason, request=None):
        self._mark_started()
        self.shed[reason] += 1
        if request is not None:
            self._tenant(request)["shed"][reason] += 1

    def record_tokens(self, n, request=None):
        self.total_tokens += int(n)
        self._window_tokens += int(n)
        if request is not None:
            self._tenant(request)["tokens"] += int(n)

    def record_first_token(self, request):
        if request.ttft is not None:
            self.ttft_samples.append(request.ttft)
            self.ttft_digest.add(request.ttft)
            self._tenant(request)["ttft_digest"].add(request.ttft)
            request.ttft_epoch = self.window_resets

    def record_finish(self, request):
        if request.finish_reason == FINISH_UNHEALTHY:
            # accounted under shed["unhealthy_slot"]: it must not also count
            # as finished (the shed/finished split partitions offered
            # requests) and its latency samples are poison — including the
            # TTFT recorded at first-token time, before the poisoning showed
            # the wide-event partition excludes unhealthy requests from
            # EVERY latency field — the live digests must match or the
            # trace==digest coherence gate false-alarms. Epoch guards: a
            # sample recorded BEFORE a reset_window() lives in a discarded
            # digest; retracting it from the fresh one would decrement a
            # different (healthy) request's same-bucket sample instead.
            if request.ttft is not None:
                try:
                    self.ttft_samples.remove(request.ttft)
                except ValueError:
                    pass
                if request.ttft_epoch == self.window_resets:
                    self.ttft_digest.remove(request.ttft)
                    self._tenant(request)["ttft_digest"].remove(request.ttft)
            if request.queue_wait is not None \
                    and request.queue_wait_epoch == self.window_resets:
                self.queue_wait_digest.remove(request.queue_wait)
            return
        self.finished += 1
        self._tenant(request)["finished"] += 1
        if request.tpot is not None:
            self.tpot_samples.append(request.tpot)
            self.tpot_digest.add(request.tpot)
            self._tenant(request)["tpot_digest"].add(request.tpot)

    def record_queue_wait(self, request):
        """Arrival -> first prefill dispatch (recorded once per request, at
        its FIRST start; preemption resumes don't reopen the window)."""
        if request.queue_wait is not None:
            self.queue_wait_digest.add(request.queue_wait)
            request.queue_wait_epoch = self.window_resets

    def record_prefill_work(self, padded_len, true_len, replay=0):
        """One prefill dispatch: ``padded_len`` device tokens paid, of which
        ``true_len`` were real positions (``replay`` of those re-computing
        work a preemption threw away) and the rest bucket padding.
        (``prefix_saved_tokens`` is bumped at the hit site — it is work
        never dispatched, so it has no padded/true split.)"""
        self.prefill_device_tokens += int(padded_len)
        self.padding_tokens += int(padded_len) - int(true_len)
        self.replay_tokens += int(replay)

    def record_decode_tokens(self, n):
        self.decode_tokens += int(n)

    def record_decode_dispatch(self):
        """One decode-program dispatch (plain decode OR speculative
        verify): the denominator of ``accepted_tokens_per_step``."""
        self.decode_dispatches += 1

    def record_draft(self, n):
        self.drafted_tokens += int(n)

    def record_accept(self, accepted, rejected):
        self.accepted_tokens += int(accepted)
        self.rolled_back_tokens += int(rejected)

    def record_verify_step(self):
        self.verify_steps += 1

    @property
    def accept_rate(self):
        """Accepted / drafted candidate tokens (0.0 before any draft)."""
        return self.accepted_tokens / self.drafted_tokens \
            if self.drafted_tokens else 0.0

    @property
    def accepted_tokens_per_step(self):
        """Decode tokens emitted per decode-program dispatch (verify steps
        included) — strictly > 1 exactly when acceptance is doing work:
        the speculative multiplier on effective decode throughput."""
        return self.decode_tokens / self.decode_dispatches \
            if self.decode_dispatches else 0.0

    def speculative_snapshot(self):
        return {
            "drafted_tokens": self.drafted_tokens,
            "accepted_tokens": self.accepted_tokens,
            "rolled_back_tokens": self.rolled_back_tokens,
            "verify_steps": self.verify_steps,
            "decode_dispatches": self.decode_dispatches,
            "accept_rate": round(self.accept_rate, 4),
            "accepted_tokens_per_step": round(
                self.accepted_tokens_per_step, 4),
        }

    def record_snapshot(self):
        self.kv_snapshots += 1

    def record_migration_out(self):
        self.migrations_out += 1

    def record_migration_in(self, saved_tokens=0):
        self.migrations_in += 1
        self.migrated_saved_tokens += int(saved_tokens)

    def migration_snapshot(self):
        return {
            "kv_snapshots": self.kv_snapshots,
            "migrations_out": self.migrations_out,
            "migrations_in": self.migrations_in,
            "migrated_saved_tokens": self.migrated_saved_tokens,
        }

    def record_health_step(self, n_bad_slots):
        """Once per decode step (or poisoned prefill): how many ACTIVE
        computations produced non-finite logits (freed slots decode garbage
        by design and don't count)."""
        if n_bad_slots:
            self.nonfinite_logit_steps += 1

    def record_unhealthy(self):
        self.unhealthy_slots += 1

    def record_preempt(self, priority=False):
        self.preempted += 1
        if priority:
            self.priority_evictions += 1

    def observe_step(self, queue_depth, active_slots):
        """Once per scheduler step; periodically flushes monitor events."""
        self.steps += 1
        self._queue_depth = queue_depth
        self._active_slots = active_slots
        self.active_slots_peak = max(self.active_slots_peak, active_slots)
        if self.monitor is not None and getattr(self.monitor, "enabled", False) \
                and self.interval > 0 and self.steps % self.interval == 0:
            self.emit_events()

    # -- rollups ------------------------------------------------------------
    @property
    def elapsed(self):
        return max(self.clock.now() - self.start_time, 1e-9)

    @property
    def tokens_per_s(self):
        return self._window_tokens / self.elapsed

    @property
    def shed_total(self):
        return sum(self.shed.values())

    @property
    def goodput_frac(self):
        """Useful device tokens / total device tokens. Useful = fresh
        prefill positions + decode tokens; wasted = preemption replay +
        prefill bucket padding. 1.0 before any work."""
        total = self.prefill_device_tokens + self.decode_tokens
        if total == 0:
            return 1.0
        useful = total - self.replay_tokens - self.padding_tokens
        return useful / total

    def goodput_snapshot(self):
        return {
            "prefill_device_tokens": self.prefill_device_tokens,
            "decode_tokens": self.decode_tokens,
            "replay_tokens": self.replay_tokens,
            "padding_tokens": self.padding_tokens,
            "prefix_saved_tokens": self.prefix_saved_tokens,
            "wasted_tokens": self.replay_tokens + self.padding_tokens,
            "goodput_frac": round(self.goodput_frac, 4),
        }

    def latency_digests(self):
        """The metric->digest map evaluate_slo and the fleet rollup read."""
        return {"ttft": self.ttft_digest, "tpot": self.tpot_digest,
                "queue_wait": self.queue_wait_digest}

    def tenant_slo_targets(self, tenant_class):
        """SLO targets for a tenant's grade: the serving.slo targets, with
        the class's ``ttft_p99_ms`` override (serving.tenants.<class>)
        taking precedence when configured."""
        targets = dict(self.slo.targets_ms()) if self.slo is not None else {}
        if self.tenants_cfg is not None:
            cc = self.tenants_cfg.class_config(tenant_class)
            if cc is not None and cc.ttft_p99_ms > 0:
                targets["ttft_p99_ms"] = cc.ttft_p99_ms
        return targets

    def tenancy_snapshot(self):
        """Per-tenant rollup: counters, per-tenant P99s off the tenant
        digests, and an SLO grade against the class's targets — the
        ``tenancy`` block in snapshot()/fleet.json/bench artifacts."""
        out = {}
        for tid in sorted(self.tenants):
            t = self.tenants[tid]
            digests = {"ttft": t["ttft_digest"], "tpot": t["tpot_digest"]}
            out[tid] = {
                "class": t["class"],
                "submitted": t["submitted"],
                "finished": t["finished"],
                "shed": dict(t["shed"]),
                "tokens": t["tokens"],
                "ttft_p99_ms": t["ttft_digest"].quantile_ms(99),
                "tpot_p99_ms": t["tpot_digest"].quantile_ms(99),
                "slo": evaluate_slo(
                    self.tenant_slo_targets(t["class"]), digests),
            }
        return out

    def slo_eval(self):
        """Grade the digests against serving.slo (configured: False block
        when no slo config / no targets)."""
        targets = self.slo.targets_ms() if self.slo is not None else {}
        return evaluate_slo(targets, self.latency_digests())

    @property
    def shed_rate(self):
        # offered = admitted + admission-time sheds; unhealthy_slot sheds
        # were ALREADY admitted (counted in submitted), so they move a
        # request from finished to shed without growing the denominator
        total = self.submitted + self.shed_total - self.unhealthy_slots
        return self.shed_total / total if total else 0.0

    def snapshot(self):
        to_ms = lambda v: None if v is None else v * 1e3
        return {
            "submitted": self.submitted,
            "finished": self.finished,
            "shed": dict(self.shed),
            "shed_rate": round(self.shed_rate, 4),
            "total_tokens": self.total_tokens,
            "tokens_per_s": round(self.tokens_per_s, 2),
            "ttft_ms": {
                "p50": to_ms(percentile(self.ttft_samples, 50)),
                "p99": to_ms(percentile(self.ttft_samples, 99)),
            },
            "tpot_ms": {
                "p50": to_ms(percentile(self.tpot_samples, 50)),
                "p99": to_ms(percentile(self.tpot_samples, 99)),
            },
            # streaming-digest percentiles (mergeable across replicas; the
            # SAME numbers the Serving/*_p99_ms events and slo grade carry)
            "percentiles": {
                name + "_ms": d.percentiles_ms()
                for name, d in self.latency_digests().items()},
            "goodput": self.goodput_snapshot(),
            "speculative": self.speculative_snapshot(),
            "migration": self.migration_snapshot(),
            "slo": self.slo_eval(),
            "tenancy": self.tenancy_snapshot(),
            "steps": self.steps,
            "queue_depth": self._queue_depth,
            "priority_evictions": self.priority_evictions,
            "slot_occupancy": self._active_slots / max(self.n_slots, 1),
            "active_slots_peak": self.active_slots_peak,
            "preempted": self.preempted,
            "health": {
                "nonfinite_logit_steps": self.nonfinite_logit_steps,
                "unhealthy_slots": self.unhealthy_slots,
            },
            **({"degraded": self.degraded_snapshot()}
               if self.degraded_snapshot is not None else {}),
            **({"kv_pool": self.kv_pool()} if self.kv_pool is not None
               else {}),
            **({"router": self.router()} if self.router is not None
               else {}),
        }

    def emit_events(self):
        """Write Serving/* scalars through the monitor fan-out (rank 0 only,
        same as Train/* and Comm/*)."""
        if self.monitor is None:
            return
        events = [
            ("Serving/queue_depth", float(self._queue_depth), self.steps),
            ("Serving/slot_occupancy",
             self._active_slots / max(self.n_slots, 1), self.steps),
            ("Serving/tokens_per_s", self.tokens_per_s, self.steps),
            ("Serving/shed_total", float(self.shed_total), self.steps),
            ("Serving/health_nonfinite_steps",
             float(self.nonfinite_logit_steps), self.steps),
            ("Serving/health_unhealthy_slots",
             float(self.unhealthy_slots), self.steps),
        ]
        if self.kv_pool is not None:
            kv = self.kv_pool()
            events += [
                ("Serving/kv_occupancy", float(kv["occupancy"]), self.steps),
                ("Serving/kv_fragmentation", float(kv["fragmentation"]),
                 self.steps),
                ("Serving/kv_capacity_tokens",
                 float(kv["capacity_tokens"]), self.steps),
                ("Serving/prefix_hit_rate", float(kv["prefix_hit_rate"]),
                 self.steps),
                # which decode-attention path produced these numbers
                # (1 = the fused paged kernel, 0 = the gather path) —
                # coherent with snapshot()["kv_pool"]["attention_backend"]
                ("Serving/kv_attention_fused",
                 1.0 if kv.get("attention_backend") == "fused" else 0.0,
                 self.steps),
            ]
        if self.speculative_armed:
            # coherent with snapshot()["speculative"] by construction (the
            # PR 4 trace==metrics discipline, asserted tier-1)
            events.append(("Serving/spec_accept_rate",
                           float(self.accept_rate), self.steps))
            events.append(("Serving/spec_accepted_tokens_per_step",
                           float(self.accepted_tokens_per_step), self.steps))
        if self.degraded is not None:
            events.append(("Serving/degraded_level",
                           float(self.degraded()), self.steps))
        p50 = percentile(self.ttft_samples, 50)
        if p50 is not None:
            events.append(("Serving/ttft_ms", p50 * 1e3, self.steps))
        p50t = percentile(self.tpot_samples, 50)
        if p50t is not None:
            events.append(("Serving/tpot_ms", p50t * 1e3, self.steps))
        events.extend(slo_digest_events(
            self.latency_digests(), self.goodput_frac, self.slo, self.steps,
            tracer=self.tracer, counter=self))
        self.monitor.write_events(events)
