"""repro_torch.obs: deterministic tracing, energy attribution, SLO burn rates.

The observability layer the paper's Score-P power plug-ins played for
one node, lifted across the whole stack:

  * ``Tracer`` / ``NULL_TRACER`` — structured spans, instants and
    counter snapshots on the virtual clock, deterministic ids, zero
    cost when disabled (``repro_torch.obs.tracer``);
  * ``chrome_trace`` / ``dump_chrome_trace`` / ``dump_metrics_jsonl``
    — Perfetto-openable trace_event JSON plus a JSONL metrics stream
    (``repro_torch.obs.export``);
  * ``EnergyLedger`` / ``request_costs`` — joules and seconds joined
    onto the span tree, facility→cabinet→node→phase rollup with a
    conservation check against ``FleetTelemetry``, and per-request
    queue-wait / prefill / decode / migration decomposition
    (``repro_torch.obs.ledger``);
  * ``SLOBurnMonitor`` — windowed attainment / error-budget burn per
    SLO class, the read-only signal the autoscaler and the launcher
    scoreboard consume (``repro_torch.obs.slo_monitor``).

See ``docs/observability.md`` for the span taxonomy and how to open a
trace in Perfetto.  A copy of ``repro/obs/__init__.py``; every module
here is a copy of its namesake in ``repro/obs`` (pure Python; the port
imports nothing of ``repro``).
"""

from repro_torch.obs.export import (chrome_trace, dump_chrome_trace,
                                    dump_metrics_jsonl, metrics_jsonl)
from repro_torch.obs.ledger import EnergyLedger, RequestCost, request_costs
from repro_torch.obs.slo_monitor import SLOBurnMonitor
from repro_torch.obs.tracer import (NULL_TRACER, CounterSample, Instant,
                                    NullTracer, Span, Tracer)

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span", "Instant",
    "CounterSample",
    "chrome_trace", "dump_chrome_trace", "metrics_jsonl",
    "dump_metrics_jsonl",
    "EnergyLedger", "RequestCost", "request_costs",
    "SLOBurnMonitor",
]
