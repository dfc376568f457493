"""The pre-continuous-batching serving loop, kept as the benchmark baseline.

A copy of ``repro/serving/legacy.py`` over the port's whole-batch programs
(``make_prefill_step`` / ``make_decode_step`` of ``serving/engine.py``).
``StaticServeEngine`` is the engine the reference shipped before the
continuous-batching runtime (minus its per-token host round-trips, which
were fixed separately so a benchmark's delta is attributable to the
scheduler, not to transfer hygiene).  Its restrictions are the ones the
rewrite removes:

  * equal-prompt-length bucketing (sub-full batches whenever lengths are
    ragged),
  * one host sync per generated token (the step loop is host-driven),
  * finished requests hostage to the longest request in their batch --
    slots only recycle when the WHOLE batch drains.

Each batch's prompt is prefilled whole, as one chunk at batch = the
bucket's size (pad rows zero), into a fresh dense cache; on the card that
reaches the dense cache write and the chunk attention kernel at Sq = the
prompt's length.  It runs eagerly, never as a CUDA graph.  New code
should use ``repro_torch.serving.engine.ServeEngine``.
"""

from __future__ import annotations

import contextlib
import time

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import resolve_device
from repro_torch.serving.engine import make_decode_step, make_prefill_step
from repro_torch.serving.scheduler import Request

__all__ = ["StaticServeEngine"]


class StaticServeEngine:
    """Batched serving loop with equal-prompt-length bucketing (greedy).
    Runs on ``ctx.device`` (``cuda`` by default; raises when there is no
    card, unless the Ctx names the CPU)."""

    def __init__(self, cfg: ModelConfig, run: RunConfig, ctx: Ctx, params,
                 batch_size: int = 4, max_seq: int = 256, power=None):
        self.device = resolve_device(ctx.device)
        self.cfg, self.run, self.ctx = cfg, run, ctx
        self.params = lm.prepare_params(ctx, params)
        self.batch_size, self.max_seq = batch_size, max_seq
        self.power = power   # anything with ``phase(name, calls=)``
        self.prefill = make_prefill_step(cfg, run, ctx, max_seq)
        self.decode = make_decode_step(cfg, run, ctx)
        self.sync_count = 0
        self.completion_s: dict[int, float] = {}   # uid -> wall s in generate

    def _phase(self, name: str, calls: int | None = None):
        return (self.power.phase(name, calls=calls)
                if self.power is not None else contextlib.nullcontext())

    def _take_batch(self, pending: list[Request]) -> list[Request]:
        """Next batch of equal-prompt-length requests: ragged batches
        would feed pad tokens to prefill (KV/SSM pollution) and share one
        ``index = plen`` across slots."""
        plen = len(pending[0].prompt)
        return [r for r in pending
                if len(r.prompt) == plen][:self.batch_size]

    def generate(self, requests: list[Request]) -> list[Request]:
        t0 = time.perf_counter()
        pending = sorted(requests, key=lambda r: len(r.prompt))
        done: list[Request] = []
        while pending:
            active = self._take_batch(pending)
            taken = {id(r) for r in active}
            pending = [r for r in pending if id(r) not in taken]
            plen = len(active[0].prompt)   # per-slot length, uniform batch
            rows = [r.prompt for r in active]
            rows += [[0] * plen] * (self.batch_size - len(active))
            toks = torch.tensor(rows, dtype=torch.int32).to(
                self.device, non_blocking=True)
            with self._phase("prefill"):
                cache, logits = self.prefill(self.params, {"tokens": toks})
            index = plen
            cur = torch.argmax(logits[:, 0], dim=-1).int()
            steps = max(r.max_new_tokens for r in active)
            for _ in range(steps):
                cur_host = cur.cpu().tolist()   # one sync per token step
                self.sync_count += 1
                for i, r in enumerate(active):
                    if not r.done:
                        r.generated.append(cur_host[i])
                if all(r.done for r in active):
                    break
                # one phase entry per token, accounting ONE decode call --
                # the per-token cost this engine actually pays (the
                # registered task's calls covers a whole response)
                with self._phase("decode", calls=1):
                    cache, logits = self.decode(self.params, cache,
                                                cur[:, None], index)
                cur = torch.argmax(logits, dim=-1).int()
                index += 1
            now = time.perf_counter() - t0
            for r in active:
                self.completion_s[r.uid] = now
            done.extend(active)
        return done
