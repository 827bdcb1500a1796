"""Deterministic mergeable latency digests for streaming SLO percentiles (copy
of ``deepspeed_tpu/telemetry/digest.py``).

``LatencyDigest`` is a fixed-geometry log-bucket histogram: O(1) memory
(one int array whose geometry never depends on the data), deterministic
insertion (a value always lands in the same bucket), and EXACT merge
associativity (merging is integer bucket-count addition, so
``(a+b)+c == a+(b+c) == digest(all samples)`` bucket for bucket). That is
what lets per-replica digests roll up into one fleet digest whose
percentiles are independent of merge order or replica count — the property
sample-list percentiles and most sketches (t-digest, GK) do not have.

The quantile a digest reports is the UPPER EDGE of the nearest-rank bucket
— a canonical representative, so any two digests holding the same samples
report bit-identical percentiles no matter how the samples were sharded.
Resolution is the bucket growth factor (~7.8% relative); the tier-1
coherence pins compare digest-to-digest (exact), never digest-to-raw.

The same arithmetic reads the live metrics and, in the JAX package, the
merged fleet trace, so it lives in telemetry/; ``serving/metrics.py`` is
its reader here.
"""

import math

# one fixed geometry for every digest in the process: merges across
# replicas/tools are only defined between identical geometries, and a
# config knob here would quietly break cross-artifact comparability
DIGEST_LO = 1e-6          # values at/below this land in bucket 0
DIGEST_N_BUCKETS = 360    # 12 decades at ~7.8% relative resolution
DIGEST_GROWTH = 10.0 ** (12.0 / DIGEST_N_BUCKETS)
_LOG_GROWTH = math.log(DIGEST_GROWTH)


class LatencyDigest:
    """Fixed-bucket log histogram with exact merge.

    Values are clock units (seconds under a wall clock, virtual units under
    a ``VirtualClock``); ``quantile_ms`` applies the x1e3 display convention
    the serving metrics use.
    """

    __slots__ = ("counts", "count")

    def __init__(self):
        self.counts = [0] * DIGEST_N_BUCKETS
        self.count = 0

    @staticmethod
    def bucket_index(value):
        """The bucket a value lands in — the single canonical mapping every
        producer and consumer shares."""
        v = float(value)
        if v <= DIGEST_LO:
            return 0
        i = int(math.floor(math.log(v / DIGEST_LO) / _LOG_GROWTH))
        return min(max(i, 0), DIGEST_N_BUCKETS - 1)

    @staticmethod
    def bucket_upper(index):
        """Canonical representative of a bucket: its upper edge."""
        return DIGEST_LO * DIGEST_GROWTH ** (index + 1)

    def add(self, value):
        self.counts[self.bucket_index(value)] += 1
        self.count += 1

    def remove(self, value):
        """Retract one previously-added sample (the unhealthy-shed TTFT
        retraction path). A value never added decrements nothing."""
        i = self.bucket_index(value)
        if self.counts[i] > 0:
            self.counts[i] -= 1
            self.count -= 1

    def merge(self, other):
        """In-place exact merge (integer bucket addition)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        return self

    @classmethod
    def merged(cls, digests):
        out = cls()
        for d in digests:
            out.merge(d)
        return out

    def quantile_bucket(self, q):
        """Bucket index of the nearest-rank quantile; None when empty."""
        if self.count == 0:
            return None
        rank = max(1, int(math.ceil(q / 100.0 * self.count)))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                return i
        return DIGEST_N_BUCKETS - 1

    def quantile(self, q):
        """Nearest-rank quantile (q in [0, 100]) as the bucket upper edge;
        None when empty. Deterministic: equal bucket counts -> equal
        quantiles, regardless of how the samples were sharded or merged."""
        i = self.quantile_bucket(q)
        return None if i is None else self.bucket_upper(i)

    def quantile_ms(self, q):
        v = self.quantile(q)
        return None if v is None else v * 1e3

    def count_above(self, value):
        """Samples in buckets strictly above ``value``'s bucket (bucket
        resolution: same-bucket samples count as NOT above)."""
        i = self.bucket_index(value)
        return sum(self.counts[i + 1:])

    # ------------------------------------------------------------ snapshots
    def snapshot(self):
        """Sparse machine-readable form (the artifact/fleet.json block).
        Geometry is recorded so a reader can refuse a foreign digest."""
        return {
            "lo": DIGEST_LO,
            "growth": DIGEST_GROWTH,
            "n_buckets": DIGEST_N_BUCKETS,
            "count": self.count,
            "buckets": {str(i): c for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_snapshot(cls, snap):
        if (int(snap.get("n_buckets", -1)) != DIGEST_N_BUCKETS
                or abs(float(snap.get("lo", 0.0)) - DIGEST_LO) > 0.0
                or abs(float(snap.get("growth", 0.0)) - DIGEST_GROWTH)
                > 1e-12):
            raise ValueError("digest geometry mismatch: snapshot was not "
                             "produced by this digest version")
        d = cls()
        for i, c in snap.get("buckets", {}).items():
            d.counts[int(i)] = int(c)
        d.count = int(snap.get("count", sum(d.counts)))
        return d

    def percentiles_ms(self, qs=(50, 90, 99)):
        return {f"p{q}": self.quantile_ms(q) for q in qs}


def evaluate_slo(targets_ms, digests):
    """Grade latency digests against ``serving.slo`` targets.

    ``targets_ms``: {"ttft_p99_ms": t1, "tpot_p99_ms": t2, ...} — 0/None
    disables a target. ``digests``: {"ttft": LatencyDigest, ...} keyed by
    the metric prefix of each target. Returns the machine-readable ``slo``
    block shared by ServingMetrics events, the Router snapshot, the bench
    artifact and ``tools/fleet_report.py``:

    - ``observed_p99_ms`` per metric (digest quantile, the SAME number the
      ``Serving/<metric>_p99_ms`` monitor event carries);
    - per-metric ``violated`` (observed > target) and ``burn_rate`` — the
      fraction of samples over the target divided by the 1% error budget a
      P99 objective grants (burn_rate 1.0 = burning budget exactly as fast
      as allowed; >1 = out of budget at steady state);
    - ``pass``: no configured target violated.
    """
    out = {"configured": False, "pass": True, "targets_ms": {},
           "observed_p99_ms": {}, "violated": {}, "burn_rate": {}}
    for key, target in (targets_ms or {}).items():
        if not key.endswith("_p99_ms"):
            continue
        metric = key[:-len("_p99_ms")]
        d = digests.get(metric)
        observed = d.quantile_ms(99) if d is not None else None
        out["observed_p99_ms"][metric] = observed
        if not target or target <= 0:
            continue
        out["configured"] = True
        out["targets_ms"][metric] = float(target)
        # violation is judged at BUCKET granularity: the reported quantile
        # is a bucket's upper edge, so comparing it raw against the target
        # would flag a fleet whose every sample is under target purely from
        # the ~7.8% quantization (observed edge > target, burn rate 0.0 —
        # self-contradictory). P99's bucket must sit strictly above the
        # target's bucket, the same resolution count_above/burn_rate use.
        p99_bucket = d.quantile_bucket(99) if d is not None else None
        violated = (p99_bucket is not None
                    and p99_bucket
                    > LatencyDigest.bucket_index(float(target) / 1e3))
        out["violated"][metric] = violated
        frac_over = (d.count_above(float(target) / 1e3) / d.count
                     if d is not None and d.count else 0.0)
        out["burn_rate"][metric] = round(frac_over / 0.01, 4)
        if violated:
            out["pass"] = False
    return out
