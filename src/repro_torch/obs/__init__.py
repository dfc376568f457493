"""Observability for the port: the span tracer (a copy of ``repro.obs.tracer``)."""

from repro_torch.obs.tracer import (NULL_TRACER, CounterSample, Instant,
                                    NullTracer, Span, Tracer)

__all__ = ["Tracer", "NullTracer", "NULL_TRACER", "Span", "Instant",
           "CounterSample"]
