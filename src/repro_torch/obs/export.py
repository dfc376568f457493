"""Trace exports: Perfetto/Chrome ``trace_event`` JSON + metrics JSONL.

``chrome_trace`` turns a ``Tracer`` into the Chrome trace-event format
(the JSON object form, ``{"traceEvents": [...]}``) that Perfetto
(https://ui.perfetto.dev) and ``chrome://tracing`` open directly:

  * every track becomes a thread (``tid``) under one process, with a
    ``thread_name`` metadata event so the UI shows "cab0/n00" instead
    of a number;
  * completed spans become ``"X"`` (complete) events — nesting falls
    out of time containment (a phase span sits inside its step span
    inside its quantum span on the same track);
  * instants become ``"i"`` events, counters ``"C"`` events;
  * timestamps are virtual seconds scaled to the format's microseconds.

Everything is emitted in a deterministic order (events sorted by
(tid, ts, -dur, id); tids assigned over sorted track names) and dumped
with ``sort_keys``, so two same-seed runs produce byte-identical files
— the determinism gate ``tests/test_obs.py`` asserts and
``tools/check_trace.py`` validates structurally in CI.

``metrics_jsonl`` writes the tracer's counter snapshots (one JSON
object per line, one line per snapshot) — the stream a dashboard tails
while the Perfetto file serves the post-hoc deep dive.

A copy of ``repro/obs/export.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import json

from repro_torch.obs.tracer import Tracer

__all__ = ["chrome_trace", "dump_chrome_trace", "metrics_jsonl",
           "dump_metrics_jsonl"]

_PID = 1
_PROCESS_NAME = "repro"


def _us(t: float) -> float:
    """Virtual seconds -> trace-event microseconds (rounded so float
    noise can never differ between identical runs)."""
    return round(t * 1e6, 3)


def chrome_trace(tracer: Tracer, process_name: str = _PROCESS_NAME) -> dict:
    """The trace as a Chrome/Perfetto ``trace_event`` JSON object."""
    tids = {track: i + 1 for i, track in enumerate(tracer.tracks())}
    events: list[dict] = [{
        "ph": "M", "name": "process_name", "pid": _PID, "tid": 0,
        "args": {"name": process_name},
    }]
    for track in tracer.tracks():
        events.append({
            "ph": "M", "name": "thread_name", "pid": _PID,
            "tid": tids[track], "args": {"name": track},
        })

    body: list[tuple] = []
    for s in tracer.spans:
        t1 = s.t1 if s.t1 is not None else s.t0
        body.append((tids[s.track], _us(s.t0), -_us(t1 - s.t0), s.id, {
            "ph": "X", "name": s.name, "cat": s.cat, "pid": _PID,
            "tid": tids[s.track], "ts": _us(s.t0),
            "dur": _us(t1 - s.t0), "args": dict(s.args, span_id=s.id),
        }))
    for e in tracer.instants:
        body.append((tids[e.track], _us(e.t), 0.0, e.id, {
            "ph": "i", "name": e.name, "cat": e.cat, "pid": _PID,
            "tid": tids[e.track], "ts": _us(e.t), "s": "t",
            "args": dict(e.args, span_id=e.id),
        }))
    for c in tracer.counters:
        body.append((tids[c.track], _us(c.t), 0.0, c.id, {
            "ph": "C", "name": "counters", "cat": "counter", "pid": _PID,
            "tid": tids[c.track], "ts": _us(c.t), "args": dict(c.values),
        }))
    # parents before children at equal start (longer first), tracks
    # contiguous, ties broken by emission id — a total, reproducible order
    body.sort(key=lambda item: item[:4])
    events.extend(ev for *_, ev in body)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def dump_chrome_trace(tracer: Tracer, path: str,
                      process_name: str = _PROCESS_NAME) -> None:
    """Write the Perfetto-openable JSON file (byte-deterministic)."""
    with open(path, "w") as f:
        json.dump(chrome_trace(tracer, process_name), f,
                  sort_keys=True, separators=(",", ":"))
        f.write("\n")


def metrics_jsonl(tracer: Tracer) -> list[str]:
    """Counter snapshots as JSON lines (chronological, deterministic)."""
    lines = []
    for c in sorted(tracer.counters, key=lambda c: (c.t, c.track, c.id)):
        lines.append(json.dumps(
            {"t": c.t, "track": c.track, **c.values},
            sort_keys=True, separators=(",", ":")))
    return lines


def dump_metrics_jsonl(tracer: Tracer, path: str) -> None:
    with open(path, "w") as f:
        for line in metrics_jsonl(tracer):
            f.write(line + "\n")
