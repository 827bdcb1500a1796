"""The disabled span tracer (the part of ``deepspeed_tpu/telemetry/tracer.py``
the serving path runs).

The serving engine opens spans and instants around every request and decode
step. With no ``telemetry`` block, or a disabled one, the JAX package hands
it a null tracer whose calls cost one attribute check; that is the tracer
here. Recording spans, Chrome-trace/JSONL output and device fencing come
with ROADMAP A.3 (an enabled ``telemetry`` block raises at config time).
"""

from ..utils import not_ported


class _NullSpan:
    """Reusable no-op span."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_SPAN = _NullSpan()


class SpanTracer:
    """A tracer that records nothing: ``span`` returns a shared no-op span,
    ``instant`` and ``flush`` return at once."""

    def __init__(self, enabled=False):
        if enabled:
            raise not_ported("span tracing (an enabled SpanTracer)", "A.3")
        self.enabled = False

    @classmethod
    def from_config(cls, cfg, clock=None):
        """The tracer for a ``telemetry`` config block (a dict, as the port's
        inference config keeps it): None or disabled gives the null tracer;
        an enabled block raises (ROADMAP A.3)."""
        if not (cfg or {}).get("enabled", False):
            return cls()
        raise not_ported("telemetry span tracing", "A.3")

    def span(self, name, cat="host", sync=False, **args):
        return _NULL_SPAN

    def instant(self, name, cat="mark", ts=None, **args):
        pass

    def flush(self):
        return None
