"""Synthetic power-trace generator: the paper's Fig. 1 analogue.

A copy of ``repro/core/trace.py`` for the port.

The paper sampled superchip/CPU/GPU power every 5 ms with two Score-P plug-ins
and plotted the trace over two SCF iterations, with visible power drops where
computation moves from GPU to CPU.  Here we synthesize the same trace from a
phase sequence + the analytic power model, at the same 5 ms cadence.

Since the span tracer (``obs/tracer.py``) landed, the generator is
expressed ON the span ledger: each executed phase is first emitted as a ``cat="phase"`` span
(carrying its modeled runtime, energy and chip/host power split in
``args``), then the 5 ms sampler walks those spans.  The public
dataclasses (``TracePoint`` / ``PowerTrace``) and the emitted numbers
are unchanged — ``tests/test_obs.py`` holds the output bit-identical to
the original direct loop — and passing ``tracer=`` mirrors the phase
spans into a caller's trace for Perfetto export alongside everything
else the run recorded.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.power_model import simulate_task
from repro_torch.core.tasks import Task
from repro_torch.hw.tpu import DEFAULT_SUPERCHIP, SuperchipSpec
from repro_torch.obs.tracer import Span, Tracer

#: Track name Fig. 1 phase spans are emitted on.
TRACE_TRACK = "fig1"


@dataclasses.dataclass(frozen=True)
class TracePoint:
    t: float
    p_superchip: float
    p_chip: float
    p_host: float


@dataclasses.dataclass(frozen=True)
class PowerTrace:
    points: list[TracePoint]
    energy_total: float
    energy_chip: float
    energy_host: float

    def as_arrays(self) -> dict[str, np.ndarray]:
        return {
            "t": np.array([p.t for p in self.points]),
            "superchip": np.array([p.p_superchip for p in self.points]),
            "chip": np.array([p.p_chip for p in self.points]),
            "host": np.array([p.p_host for p in self.points]),
        }


def phase_spans(phases: list[Task], cap: float,
                spec: SuperchipSpec = DEFAULT_SUPERCHIP,
                tracer: Tracer | None = None) -> list[Span]:
    """Execute ``phases`` in order under ``cap`` as a span ledger.

    Each phase becomes one completed ``cat="phase"`` span on
    ``TRACE_TRACK`` whose args carry the modeled measurement the sampler
    needs: ``seconds`` (modeled runtime), ``energy_j``, and the
    ``p_chip`` / ``p_host`` power split.  When ``tracer`` is given the
    spans are also emitted into it (for export alongside a larger run).
    """
    ledger = Tracer()
    now = 0.0
    for task in phases:
        m = simulate_task(task, cap, spec)
        if m.runtime <= 0:
            continue
        # split measured energy into chip/host components
        if task.is_idle:
            f = m.clock_fraction
            p_host = spec.host.p_idle + \
                (spec.host.p_max - spec.host.p_idle) * f**3
        else:
            p_host = spec.host.p_idle
        p_chip = max(m.avg_power - p_host, 0.0)
        args = {"seconds": m.runtime, "energy_j": m.energy,
                "p_chip": p_chip, "p_host": p_host}
        ledger.span(task.name, now, now + m.runtime, TRACE_TRACK,
                    cat="phase", args=args)
        if tracer is not None and tracer.enabled:
            tracer.span(task.name, now, now + m.runtime, TRACE_TRACK,
                        cat="phase", args=dict(args))
        now += m.runtime
    return ledger.spans


def sample_spans(spans: list[Span], sample_ms: float = 5.0,
                 jitter_sigma: float = 0.0, seed: int = 0) -> PowerTrace:
    """Sample a phase-span ledger at the paper's cadence.

    Walks the spans in emission order, reading each one's modeled
    ``seconds`` / ``p_chip`` / ``p_host`` args — the Score-P-plug-in
    view reconstructed from the structured trace instead of a parallel
    bookkeeping path.
    """
    rng = np.random.default_rng(seed)
    dt = sample_ms / 1000.0
    points: list[TracePoint] = []
    e_chip = e_host = 0.0
    for s in spans:
        seconds = float(s.args["seconds"])
        p_chip = float(s.args["p_chip"])
        p_host = float(s.args["p_host"])
        e_chip += p_chip * seconds
        e_host += p_host * seconds
        n = max(int(round(seconds / dt)), 1)
        for i in range(n):
            jc = float(rng.normal(0, jitter_sigma)) if jitter_sigma else 0.0
            jh = float(rng.normal(0, jitter_sigma * 0.3)) if jitter_sigma else 0.0
            pc, ph = max(p_chip + jc, 0.0), max(p_host + jh, 0.0)
            points.append(TracePoint(t=s.t0 + i * dt, p_superchip=pc + ph,
                                     p_chip=pc, p_host=ph))
    return PowerTrace(points=points, energy_total=e_chip + e_host,
                      energy_chip=e_chip, energy_host=e_host)


def generate_trace(phases: list[Task], cap: float,
                   spec: SuperchipSpec = DEFAULT_SUPERCHIP,
                   sample_ms: float = 5.0,
                   jitter_sigma: float = 0.0,
                   seed: int = 0,
                   tracer: Tracer | None = None) -> PowerTrace:
    """Execute ``phases`` in order under ``cap``; sample power at 5 ms."""
    return sample_spans(phase_spans(phases, cap, spec, tracer=tracer),
                        sample_ms=sample_ms, jitter_sigma=jitter_sigma,
                        seed=seed)
