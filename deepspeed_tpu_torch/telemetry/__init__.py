"""Telemetry of the port: latency digests and the (disabled) span tracer."""

from .digest import LatencyDigest, evaluate_slo  # noqa: F401
from .tracer import SpanTracer  # noqa: F401
