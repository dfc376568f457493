"""Fault-tolerance runtime: restart supervisor, preemption handling,
straggler watchdog.

Designed for the 1000+-node regime: every mechanism here is host-local and
O(1) in cluster size; cluster-level coordination happens through the shared
checkpoint directory (the usual pattern for TPU pod slices, where the
scheduler restarts the whole slice on any chip failure).

A copy of ``PreemptionGuard``, ``StragglerWatchdog`` and ``Supervisor`` from
``repro.runtime.supervisor`` (standard library only; the port imports
nothing of ``repro``).  ``StepwiseSupervisor`` and ``plan_mesh_shape`` come
with the distributed slice (ROADMAP queue 1 item 14).
"""

from __future__ import annotations

import dataclasses
import signal
import time
from typing import Callable


class Preemption(Exception):
    pass


class PreemptionGuard:
    """SIGTERM -> graceful checkpoint-and-exit.

    Installs a handler that flips a flag; the train loop polls
    ``should_stop`` each step and checkpoints before exiting 143 (the
    conventional preempted-exit code the supervisor recognizes as
    resumable)."""

    def __init__(self):
        self._stop = False
        self._prev = None

    def __enter__(self):
        self._prev = signal.signal(signal.SIGTERM, self._handler)
        return self

    def __exit__(self, *exc):
        signal.signal(signal.SIGTERM, self._prev)

    def _handler(self, signum, frame):
        self._stop = True

    @property
    def should_stop(self) -> bool:
        return self._stop


@dataclasses.dataclass
class StragglerWatchdog:
    """EWMA step-time monitor: flags steps slower than ``threshold`` x the
    running mean.  On a real pod the flag feeds the controller that swaps a
    slow host's data shard / triggers replacement; here it records events."""

    alpha: float = 0.1
    threshold: float = 2.0
    ewma: float | None = None
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, seconds: float) -> bool:
        slow = False
        if self.ewma is not None and seconds > self.threshold * self.ewma:
            slow = True
            self.events.append((step, seconds, self.ewma))
        self.ewma = (seconds if self.ewma is None
                     else (1 - self.alpha) * self.ewma + self.alpha * seconds)
        return slow


def _jitter_unit(seed: int, n: int) -> float:
    """Deterministic hash of (seed, n) to [0, 1) — stable across processes
    (``hash`` is salted) and free of shared-RNG ordering hazards.  Kept
    in-module: the runtime layer carries its own copy of the mix."""
    x = (seed * 0x9E3779B1 + n * 0x85EBCA6B + 0x27D4EB2F) & 0xFFFFFFFF
    x ^= x >> 15
    x = (x * 0x2C1B3C6D) & 0xFFFFFFFF
    x ^= x >> 12
    return x / 2 ** 32


@dataclasses.dataclass
class Supervisor:
    """Restart-from-checkpoint loop around a train function.

    ``train_fn(restart_count) -> exit_reason`` must itself restore from the
    newest valid checkpoint (repro_torch.ckpt.checkpoint.restore does the
    validation + fallback).  Any exception or preemption triggers a restart with
    exponential backoff, up to max_restarts."""

    max_restarts: int = 3
    backoff_s: float = 0.1
    restarts: int = 0
    history: list = dataclasses.field(default_factory=list)
    #: jitter > 0 spreads simultaneous restarts apart: the delay is
    #: multiplied by 1 + jitter * u where u in [0, 1) is a deterministic
    #: hash of (seed, restart count) — same seed, same sequence, but two
    #: jobs crashed by the same fault stop retrying in lockstep.
    jitter: float = 0.0
    seed: int = 0

    def _record_restart(self, kind: str, info) -> float:
        """Shared restart bookkeeping: append the event, enforce the
        restart budget, return the exponential-backoff delay (seconds)."""
        self.history.append((kind, info))
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"exceeded max_restarts={self.max_restarts}: "
                f"{self.history}")
        delay = self.backoff_s * 2 ** (self.restarts - 1)
        if self.jitter:
            delay *= 1.0 + self.jitter * _jitter_unit(self.seed,
                                                      self.restarts)
        return delay

    def run(self, train_fn: Callable[[int], str]) -> str:
        while True:
            try:
                reason = train_fn(self.restarts)
                self.history.append(("completed", reason))
                return reason
            except Preemption:
                delay = self._record_restart("preempted", None)
            except Exception as e:  # noqa: BLE001 - supervisor catches all
                delay = self._record_restart("crashed", repr(e))
            time.sleep(delay)
