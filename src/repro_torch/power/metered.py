"""``MeteredPowerManager``: the card's live-telemetry session, the loop the
reference's ``PowerManager.observe`` exists for
(``repro/power/manager.py:380-395``) but which the reference only models.

Each ``phase(name, calls)`` brackets its body by device synchronisation:

  entry  synchronise, read the energy counter, apply the phase's cap (a
         coalesced write costs nothing), yield;
  exit   synchronise, read the counter.

The engine's phases wrap host calls that only ENQUEUE work (a decode
phase is one graph replay; the engine's one sync is its fetch after the
chunk), so without the syncs a cap written at entry would land while the
previous phase still runs, and an exit read would miss queued work.  A
CUDA-graph capture happens inside a phase's body, never at its edges, so
no sync falls inside a capture.  The syncs are counted here
(``syncs``), apart from the engine's ``sync_count``.

Measured seconds and joules accumulate per phase (``seconds``,
``joules``, ``calls``, ``entries``) and feed ``observe(name, runtime,
energy, cap=...)``, re-normalised to the registered task's canonical
call count exactly as the reference's ``phase()`` re-normalises its
modelled measurement (``manager.py:371-373``).  ``reset()`` starts a new
accounting window without touching the table or the schedule.

``metered_windows`` times functions one at a time on the same counter,
each repeated over a window of at least WINDOW_S, long enough for the
counter's period: the per-call seconds and joules of a task measured
alone.
"""

from __future__ import annotations

import contextlib
import math
import time
from typing import Callable, Iterator

from repro_torch.power.manager import PhaseRecord, PowerManager

#: the least seconds of a measured window on the energy counter (it moves
#: every ~100 ms on an H100, so a shorter window is its quantisation), and
#: the seconds a new power limit is given to take effect before one
WINDOW_S, SETTLE_S = 2.0, 0.2


class MeteredPowerManager(PowerManager):
    """A ``PowerManager`` whose phases are measured on the card.

    ``meter``: anything with ``energy_mj()`` (``NvmlBackend``); ``sync``:
    the device synchronisation (``torch.cuda.synchronize`` by default).
    Every other argument is ``PowerManager``'s; ``backend`` applies the
    caps (``NvmlBackend``, or ``LoggingBackend`` where writes are
    refused)."""

    def __init__(self, table=None, *, meter,
                 sync: Callable[[], None] | None = None, **kw):
        super().__init__(table, **kw)
        if sync is None:
            import torch
            sync = torch.cuda.synchronize
        self.meter, self._sync_fn = meter, sync
        self.syncs = 0
        self.reset()

    def reset(self) -> None:
        """Zero the measured accumulators (not the table, the schedule or
        the write counts)."""
        self.seconds: dict[str, float] = {}
        self.joules: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.entries: dict[str, int] = {}

    def _sync(self) -> None:
        self._sync_fn()
        self.syncs += 1

    @contextlib.contextmanager
    def phase(self, name: str,
              calls: int | None = None) -> Iterator[PhaseRecord]:
        cap = self.next_cap(name)
        self._sync()
        e0, t0 = self.meter.energy_mj(), time.perf_counter()
        self.apply_cap(cap)
        rec = PhaseRecord(name=name, cap=cap)
        try:
            yield rec
        finally:
            self._sync()
            e1, t1 = self.meter.energy_mj(), time.perf_counter()
            runtime, energy = t1 - t0, (e1 - e0) / 1e3
            rec.wall_s = runtime
            self.seconds[name] = self.seconds.get(name, 0.0) + runtime
            self.joules[name] = self.joules.get(name, 0.0) + energy
            self.calls[name] = self.calls.get(name, 0) + (calls or 1)
            self.entries[name] = self.entries.get(name, 0) + 1
            task = self.tasks.get(name)
            scale = 1.0 if task is None or calls in (None, 0) \
                else task.calls / calls
            self.observe(name, runtime * scale, energy * scale, cap=cap)
            self.history.append(rec)
            if len(self.history) > self.history_limit:
                del self.history[:len(self.history) - self.history_limit]

    def total_joules(self) -> float:
        return sum(self.joules.values())


def metered_windows(calls: dict[str, Callable[[], object]], meter, *,
                    window_s: float | None = None,
                    sync: Callable[[], None] | None = None) -> dict:
    """Each of ``calls`` (name -> a function of no arguments) timed alone on
    the energy counter: after one warm-up call and one timed call, the
    call is repeated back to back, from an idle card to a synchronise,
    until one window of at least ``window_s`` (WINDOW_S unless given)
    holds it (a window that
    falls short is measured again with more calls).  A counter that
    moves every ~100 ms gives a call shorter than that its joules only
    over such windows.  Returns name -> ``seconds``, ``joules`` and
    ``reps`` of the window, and per call ``s_per_call`` and
    ``j_per_call``, and the window's ``mean_w``."""
    if window_s is None:
        window_s = WINDOW_S
    if sync is None:
        import torch
        sync = torch.cuda.synchronize
    out = {}
    for name, fn in calls.items():
        fn()
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        one = max(time.perf_counter() - t0, 1e-6)
        reps = max(1, math.ceil(window_s / one))
        while True:
            sync()
            e0, t0 = meter.energy_mj(), time.perf_counter()
            for _ in range(reps):
                fn()
            sync()
            seconds = time.perf_counter() - t0
            joules = (meter.energy_mj() - e0) / 1e3
            if seconds >= window_s:
                break
            reps = math.ceil(reps * 1.1 * window_s / seconds)
        out[name] = {"seconds": seconds, "joules": joules, "reps": reps,
                     "s_per_call": seconds / reps,
                     "j_per_call": joules / reps,
                     "mean_w": joules / seconds}
    return out
