"""Deterministic span/event tracer on the virtual clock.

The paper's methodology is instrumentation-first: Score-P power plug-ins
sampling the superchip at 5 ms and attributing draw to application
phases is what made the metric evaluation possible.  ``Tracer`` is that
idea lifted across the whole reproduction stack: every layer (power
manager, serving engine, fleet controller/scheduler, workload driver,
fault injector) emits SPANS (named intervals with payload args), INSTANT
events (faults, preemptions, migrations, cap writes) and COUNTER
snapshots onto one shared timeline.

Determinism is the design constraint, not an afterthought:

  * timestamps are EXPLICIT virtual seconds supplied by the caller —
    the tracer never reads a wall clock;
  * span ids are sequential integers in emission order — no uuids, no
    id randomness;
  * nothing here iterates an unordered container.

Two same-seed runs therefore emit byte-identical event lists, which the
Perfetto export (``repro.obs.export`` in the JAX package; not ported
yet) turns into byte-identical JSON —
the property ``tests/test_obs.py`` locks down, and the reason traces
compose with the bit-identical-replay guarantees from the preemption /
chaos work.

The default tracer everywhere is ``NULL_TRACER`` (``enabled`` False):
instrumentation sites guard with ``if tracer.enabled`` so a run that
never asked for a trace pays one attribute read per site and allocates
nothing.
"""

from __future__ import annotations

import dataclasses

__all__ = ["Span", "Instant", "CounterSample", "Tracer", "NullTracer",
           "NULL_TRACER"]


@dataclasses.dataclass
class Span:
    """One named interval on a track.  ``t1`` is None while open."""

    id: int
    name: str
    track: str               # timeline lane, e.g. "cab0/n00" or "fleet"
    cat: str                 # taxonomy bucket, e.g. "phase", "step"
    t0: float                # virtual seconds
    t1: float | None = None
    args: dict = dataclasses.field(default_factory=dict)

    @property
    def duration_s(self) -> float:
        return (self.t1 - self.t0) if self.t1 is not None else 0.0


@dataclasses.dataclass(frozen=True)
class Instant:
    """A zero-duration event: a fault landing, a cap write, a drop."""

    id: int
    name: str
    track: str
    cat: str
    t: float
    args: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class CounterSample:
    """One counter snapshot (``values`` is name -> number)."""

    id: int
    track: str
    t: float
    values: dict


class Tracer:
    """Collects spans/instants/counters with deterministic ids.

    Spans come in two forms: ``span(name, t0, t1, ...)`` records a
    completed interval in one call (the common case — virtual-clock
    call sites usually know both endpoints), while ``begin``/``end``
    bracket an interval whose end is not yet known; ``begin`` nests via
    a per-track stack, so ``parent`` links are exact for bracketed
    spans.  All three feeds take the timestamp explicitly — no wall
    clock.
    """

    enabled = True

    def __init__(self):
        self.spans: list[Span] = []
        self.instants: list[Instant] = []
        self.counters: list[CounterSample] = []
        self._next_id = 1
        self._open: dict[str, list[Span]] = {}   # track -> begin stack

    def _take_id(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    # -- feeds -------------------------------------------------------------
    def span(self, name: str, t0: float, t1: float, track: str,
             cat: str = "span", args: dict | None = None) -> int:
        """Record a completed interval; returns its id."""
        s = Span(id=self._take_id(), name=name, track=track, cat=cat,
                 t0=t0, t1=t1, args=args or {})
        self.spans.append(s)
        return s.id

    def begin(self, name: str, t: float, track: str,
              cat: str = "span", args: dict | None = None) -> int:
        """Open an interval (ended by ``end`` with the returned id)."""
        s = Span(id=self._take_id(), name=name, track=track, cat=cat,
                 t0=t, args=args or {})
        if self._open.setdefault(track, []):
            s.args.setdefault("parent", self._open[track][-1].id)
        self._open[track].append(s)
        self.spans.append(s)
        return s.id

    def end(self, span_id: int, t: float,
            args: dict | None = None) -> None:
        """Close the bracketed span ``span_id`` at virtual time ``t``."""
        for stack in self._open.values():
            for s in reversed(stack):
                if s.id == span_id:
                    s.t1 = t
                    if args:
                        s.args.update(args)
                    stack.remove(s)
                    return
        raise KeyError(f"no open span with id {span_id}")

    def instant(self, name: str, t: float, track: str,
                cat: str = "event", args: dict | None = None) -> int:
        ev = Instant(id=self._take_id(), name=name, track=track, cat=cat,
                     t=t, args=args or {})
        self.instants.append(ev)
        return ev.id

    def counter(self, track: str, t: float, values: dict) -> int:
        c = CounterSample(id=self._take_id(), track=track, t=t,
                          values=dict(values))
        self.counters.append(c)
        return c.id

    # -- views -------------------------------------------------------------
    def spans_by_cat(self, cat: str) -> list[Span]:
        return [s for s in self.spans if s.cat == cat]

    def instants_by_name(self, name: str) -> list[Instant]:
        return [e for e in self.instants if e.name == name]

    def tracks(self) -> list[str]:
        seen = []
        for item in (*self.spans, *self.instants, *self.counters):
            if item.track not in seen:
                seen.append(item.track)
        return sorted(seen)


class NullTracer(Tracer):
    """The zero-cost default: every feed is a no-op, ``enabled`` is
    False so hot paths skip even argument construction."""

    enabled = False

    def span(self, name, t0, t1, track, cat="span", args=None) -> int:
        return 0

    def begin(self, name, t, track, cat="span", args=None) -> int:
        return 0

    def end(self, span_id, t, args=None) -> None:
        return None

    def instant(self, name, t, track, cat="event", args=None) -> int:
        return 0

    def counter(self, track, t, values) -> int:
        return 0


#: Shared no-op instance — the default ``tracer`` everywhere.
NULL_TRACER = NullTracer()
