"""Data pipeline: deterministic synthetic + file-backed token streams with
packing, host-sharding, background prefetch, and EXACT resume.

Determinism contract: batch(step) is a pure function of (seed, step, host
shard), so restart-from-checkpoint reproduces the identical token stream —
required for the checkpoint/restart equivalence test and for elastic
restarts (a host re-derives any shard).

A copy of ``repro.data.pipeline`` (numpy only; the port imports nothing of
``repro``): the same config gives the same batches as the reference.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    global_batch: int
    seq_len: int
    seed: int = 0
    num_hosts: int = 1
    host_id: int = 0
    kind: str = "synthetic"      # synthetic | file
    path: str | None = None      # token file (uint16/uint32 raw) for "file"


class TokenSource:
    """batch(step) -> dict of np arrays for this host's shard."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.num_hosts == 0
        self.local_batch = cfg.global_batch // cfg.num_hosts
        self._tokens_mm = None
        if cfg.kind == "file":
            raw = np.memmap(cfg.path, dtype=np.uint16, mode="r")
            self._tokens_mm = raw

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        if cfg.kind == "synthetic":
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
            # +1 so labels are true next-token targets
            toks = rng.integers(0, cfg.vocab,
                                size=(self.local_batch, cfg.seq_len + 1),
                                dtype=np.int32)
        else:
            # packed sequential windows, strided by step and host shard
            n = self._tokens_mm.shape[0]
            win = cfg.seq_len + 1
            base = (step * cfg.global_batch
                    + self.cfg.host_id * self.local_batch)
            idx = (np.arange(self.local_batch) + base) * win % max(n - win, 1)
            toks = np.stack([self._tokens_mm[i:i + win] for i in idx]
                            ).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class Prefetcher:
    """Background-thread prefetch so host input never stalls the step."""

    def __init__(self, source: TokenSource, start_step: int = 0, depth: int = 2):
        self.source = source
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        step = self.step
        while not self._stop.is_set():
            b = self.source.batch(step)
            while not self._stop.is_set():
                try:
                    self.q.put((step, b), timeout=0.1)
                    break
                except queue.Full:
                    continue
            step += 1

    def __next__(self):
        step, b = self.q.get()
        return step, b

    def stop(self):
        self._stop.set()


def batches(source: TokenSource, start_step: int = 0) -> Iterator[dict]:
    step = start_step
    while True:
        yield source.batch(step)
        step += 1
