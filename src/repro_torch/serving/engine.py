"""Serving: continuous-batching runtime over per-slot cache state, ported
from ``repro/serving/engine.py`` (dense and paged modes).

Three device programs make up the runtime:

  * ``make_prefill_chunk_step``: one power-of-two prompt chunk prefills
    into ONE slot's cache rows, at batch 1, through that slot's views of
    the stacked cache; every other slot's state is untouched.
  * ``make_decode_chunk_step``: K decode steps for the WHOLE batch with a
    per-slot cache-index vector ``(B,)`` and per-slot done flags, read
    from and written back into the engine's persistent lane vectors and
    ``out`` buffer.  The reference's ``lax.while_loop`` exits early once
    every slot is done; here the loop runs all K iterations, masked by
    ``done`` (a graph has a fixed length, and done lanes' writes drop):
    done lanes emit -1 and their cache writes drop (index = max_seq), so
    the token streams are the same.  One host sync per K-token chunk.
  * an admission step that arms a freshly prefilled slot's decode lane.

On the card both chunk programs are CUDA graphs (``serving/graphs.py``),
as the reference jits them (``repro/serving/engine.py:409-415``): the
decode chunk is one graph, captured after an engine's first chunk runs
eagerly on a side stream, every later chunk one replay; the prefill
chunk is one graph per chunk size (``chunk_plan``'s powers of two),
captured the same way at the size's first use.  A prefill graph cannot
take the slot and the row offset as Python ints, which it would bake in,
so it runs in the PREFILL LANE (``make_prefill_lane_step``): batch-1
tensors the engine allocates once -- one slot's worth of every dense row
and state leaf (a paged engine passes its pools whole, with a staging
table row), a (1,) row offset, a (1, size) token buffer per chunk size
and the (1, V) logits.  A request's chunks run back to back in the lane
(its state lanes zeroed first, a paged slot's table row copied in), and
the lane is then committed to the slot, one strided copy per leaf: the
reference's ``_slice_slot`` / ``_merge_slot`` (``:120-131``).
``eager=True`` runs every chunk directly on the slot's views (the
counterpart of ``jax.disable_jit``), as a CPU engine always does.

State lives on ``ctx.device``, is allocated once per engine and updated
IN PLACE: the per-slot cache views and the lane are written by the
kernels directly, and a new stream resets the same storage, so a
captured graph stays valid.

``paged=True`` replaces the per-slot cache with a block pool addressed
through per-slot block tables (``make_prefill_chunk_step_paged``; the
host-side ``BlockAllocator`` reserves each request's blocks at admission
and a ``PrefixRegistry`` shares registered prompt prefixes, copying a
partly shared tail block on write).  Table rows are set from the host with
non-blocking copies, so paged mode keeps one host sync per decode chunk.

With a power manager attached (anything with ``phase(name, calls=)``:
the port's ``repro_torch.power.PowerManager``, or on the card
``power.metered.MeteredPowerManager``, which measures each phase),
prefill and decode run under their own phase caps, entered once per
admitted request / decode chunk; ``serve_phase_tasks`` gives their
roofline tasks.

Preemption is lossless and proportional, as in the reference
(``repro/serving/engine.py:703-986``): ``drain()`` stops the stream and
returns every request as a ``SlotSnapshot`` (an in-flight slot warm, its
cache lane and decode cursor copied to the host in two syncs; a queued
request cold), ``drain(slots=...)`` sheds only the named slots while the
rest decode on bit-identically, ``checkpoint()`` exports without
releasing anything, ``abandon()`` drops the stream, and ``restore(snaps)``
installs snapshots into this or any engine of the same model config,
restored slots ahead of fresh admissions.  A drain drops only the host's
books: the device state and every graph stay, and the next stream resets
that state in place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from collections import deque

import torch

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.tasks import Task
from repro_torch.models import lm
from repro_torch.models.layers import Ctx
from repro_torch.models.params import resolve_device
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serving import graphs
from repro_torch.serving.scheduler import (BlockAllocator, PrefixRegistry,
                                           Request, SlotScheduler, chunk_plan,
                                           fewest_remaining)
from repro_torch.tree import tree_map

__all__ = ["Request", "ServeEngine", "SlotSnapshot", "serve_phase_tasks",
           "fewest_remaining", "make_prefill_step", "make_decode_step",
           "make_prefill_chunk_step", "make_prefill_chunk_step_paged",
           "make_prefill_lane_step", "make_decode_chunk_step",
           "BlockAllocator", "PrefixRegistry"]


def serve_phase_tasks(cfg: ModelConfig, batch: int, prompt: int,
                      new_tokens: int, chips: int = 1) -> list[Task]:
    """Prefill vs decode phases with analytic roofline terms — the serving
    analogue of ``train.phases.training_phase_tasks`` (a copy of
    ``repro/serving/engine.py:56-73``).  Prefill is compute-bound (wants a
    high cap per SED); decode streams the KV cache (memory-bound — a low
    cap is nearly free)."""
    from repro_torch.hw import flops as F
    n = F.active_param_count(cfg)
    prefill_flops = 2.0 * n * batch * prompt \
        + F._attention_flops_fwd(cfg, batch, prompt, prompt)
    decode_flops = 2.0 * n * batch
    cache = F._cache_bytes(cfg, batch, prompt)
    return [
        Task("prefill", flops=prefill_flops / chips,
             hbm_bytes=(2.0 * n + cache) / chips),
        Task("decode", flops=decode_flops / chips,
             hbm_bytes=(2.0 * n + cache) / chips, calls=new_tokens),
    ]


# ===========================================================================
# single-shot whole-batch programs
# ===========================================================================

def make_prefill_step(cfg: ModelConfig, run: RunConfig, ctx: Ctx,
                      max_seq: int):
    """prefill(params, batch) -> (cache, last_logits (B, 1, V))."""

    def prefill(params, batch):
        B = batch["tokens"].shape[0]
        cache = lm.init_cache(ctx, cfg, B, max_seq)
        h, _, cache = lm.forward(ctx, cfg, params, batch, cache=cache,
                                 cache_index=0)
        return cache, lm.logits_for(ctx, cfg, params, h[:, -1:, :])

    return prefill


def make_decode_step(cfg: ModelConfig, run: RunConfig, ctx: Ctx):
    """decode(params, cache, tokens (B,1), index) -> (cache, logits (B, V)).
    ``index`` is a scalar (shared offset) or a (B,) per-slot tensor."""

    def decode(params, cache, tokens, index):
        h, _, cache = lm.forward(ctx, cfg, params, {"tokens": tokens},
                                 cache=cache, cache_index=index)
        return cache, lm.logits_for(ctx, cfg, params, h)[:, 0]

    return decode


# ===========================================================================
# continuous-batching device programs
# ===========================================================================

def _slot_views(cache, slot: int):
    """One slot's lane of every key of the stacked cache (rows and state
    alike have the batch slot on axis 1), as views: writes through them
    land in the full cache."""
    return {key: {k: a[:, slot:slot + 1] for k, a in leaves.items()}
            for key, leaves in cache.items()}


def _reset_state_slot(cache, slot: int) -> None:
    """Zero one slot's recurrent (SSM and conv) state before reuse, in
    place (``repro/serving/engine.py:293-300``): unlike KV rows, which are
    masked by the slot's kv_len, Mamba state carries unconditionally and
    would leak the previous request into the next.  ``zero_`` on the lane
    is a kernel: no host sync.  A cache without Mamba state is left as it
    is."""
    for a in cache.get("mamba", {}).values():
        a[:, slot].zero_()


def make_prefill_chunk_step(cfg: ModelConfig, run: RunConfig, ctx: Ctx):
    """prefill_chunk(params, cache, tokens (1,chunk), slot, index)
    -> (cache, logits (1,V)).  Writes the chunk's KV rows into ONE slot of
    the batch cache, in place."""

    def prefill_chunk(params, cache, tokens, slot: int, index: int):
        h, _, _ = lm.forward(ctx, cfg, params, {"tokens": tokens},
                             cache=_slot_views(cache, slot),
                             cache_index=index)
        logits = lm.logits_for(ctx, cfg, params, h[:, -1:, :])
        return cache, logits[:, 0]

    return prefill_chunk


def make_prefill_chunk_step_paged(cfg: ModelConfig, run: RunConfig,
                                  ctx: Ctx):
    """Paged variant of ``make_prefill_chunk_step``.  Pools have no batch
    axis, so they are passed WHOLE with only the slot's table row (the view
    ``block_tables[slot:slot+1]``): the paged write reaches only blocks
    that row maps, so every other slot's blocks are untouched -- the same
    isolation, enforced by block ownership instead of lane slicing.  State
    keys (the hybrid's Mamba lanes) are passed as the slot's lane views."""

    spec = lm.cache_slot_spec(cfg)

    def prefill_chunk(params, cache, tokens, slot: int, index: int):
        sub = {}
        for key, leaves in cache.items():
            if key == "block_tables":
                sub[key] = leaves[slot:slot + 1]
            elif spec[key] == lm.SLOT_STATE:
                sub[key] = {k: a[:, slot:slot + 1] for k, a in leaves.items()}
            else:
                sub[key] = leaves                   # pool: passed whole
        h, _, _ = lm.forward(ctx, cfg, params, {"tokens": tokens},
                             cache=sub, cache_index=index)
        logits = lm.logits_for(ctx, cfg, params, h[:, -1:, :])
        return cache, logits[:, 0]

    return prefill_chunk


def make_prefill_lane_step(cfg: ModelConfig, run: RunConfig, ctx: Ctx):
    """prefill_lane(params, lane, tokens (1,chunk), offset (1,), logits
    (1,V)) -> logits.  The graphed engine's prefill chunk: the chunk runs
    in the prefill lane (a batch-1 cache dict, or a paged engine's pools
    with a staging table row), at the row offset the (1,) int32 tensor
    holds, and its last-token logits are written into ``logits``: every
    address is the engine's own, so one CUDA graph per chunk size serves
    every slot and offset.  The tensor offset takes the per-slot path of
    the forward, whose RoPE positions, cache rows and kv_len equal the
    int offset's bit for bit; the int path's row check is the host's
    ``_validate_requests``."""

    def prefill_lane(params, lane, tokens, offset, logits):
        h, _, _ = lm.forward(ctx, cfg, params, {"tokens": tokens},
                             cache=lane, cache_index=offset)
        return logits.copy_(lm.logits_for(ctx, cfg, params,
                                          h[:, -1:, :])[:, 0])

    return prefill_lane


def make_decode_chunk_step(cfg: ModelConfig, run: RunConfig, ctx: Ctx,
                           chunk: int, max_seq: int):
    """decode_chunk(params, cache, cur, index, rem, done, out) -> out.

    ``chunk`` iterations with per-slot state vectors (B,) int32 (``done``
    bool): ``cur`` is each slot's newest not-yet-delivered token,
    ``index`` its cache write offset, ``rem`` tokens still owed, ``done``
    the mask for finished or empty slots.  ``out`` (B, chunk) int32
    collects emitted tokens (-1 where a slot was done; every column is
    written), the only value the host needs per chunk.  The cache, the
    four vectors and ``out`` are updated IN PLACE (the vectors copied
    back at the end), so the same storage serves every call and a CUDA
    graph of the body.  Nothing here reads a device value on the host."""

    def decode_chunk(params, cache, cur, index, rem, done, out):
        tok, idx, left, fin = cur, index, rem, done
        for t in range(chunk):
            # deliver each live slot's pending token into the out buffer
            out[:, t] = torch.where(fin, -1, tok)
            left = torch.where(fin, left, left - 1)
            fin = fin | (left <= 0)
            # done slots write at max_seq: the per-slot cache write drops
            # them, so retired lanes cost no KV rows.  A Mamba lane has no
            # row to drop: a done lane's recurrent state keeps advancing on
            # token 0, as in the reference, and the reset at the next
            # admission to that slot wipes it
            widx = torch.where(fin, max_seq, idx)
            h, _, _ = lm.forward(ctx, cfg, params, {"tokens": tok[:, None]},
                                 cache=cache, cache_index=widx)
            logits = lm.logits_for(ctx, cfg, params, h)
            nxt = torch.argmax(logits[:, 0], dim=-1).int()
            tok = torch.where(fin, 0, nxt)
            idx = torch.where(fin, idx, idx + 1)
        cur.copy_(tok)
        index.copy_(idx)
        rem.copy_(left)
        done.copy_(fin)
        return out

    return decode_chunk


def _install_step(cur, index, rem, done, tok, slot: int, offset: int,
                  budget: int):
    """Arm one slot's decode lane, in place: ``tok`` is the pending (not
    yet delivered, not yet cache-written) token, a device scalar from the
    prefill logits or a restored cursor's int, ``offset`` the slot's cache
    write position, ``budget`` the tokens still owed.  The host values go
    in by ``fill_`` (a kernel argument): ``t[slot] = value`` would copy a
    host tensor and wait for the card.  Shared by fresh admission and
    snapshot restore."""
    if torch.is_tensor(tok):
        cur[slot] = tok
    else:
        cur[slot:slot + 1].fill_(tok)
    index[slot:slot + 1].fill_(offset)
    rem[slot:slot + 1].fill_(budget)
    done[slot:slot + 1].fill_(budget <= 0)
    return cur, index, rem, done


def _admit_step(cur, index, rem, done, logits, slot: int, plen: int,
                max_new: int):
    """Install a freshly prefilled request into its slot's decode lane:
    first generated token from the prefill logits (first maximum, as
    ``jnp.argmax``), cache offset at the prompt length, budget armed."""
    first = torch.argmax(logits[0]).int()
    return _install_step(cur, index, rem, done, first, slot, plen, max_new)


def _to_host(x):
    return x.cpu().numpy()


@dataclasses.dataclass
class SlotSnapshot:
    """One request's portable in-flight state: everything another engine
    needs to continue the stream bit-identically (the reference's,
    ``repro/serving/engine.py:256-290``).

    Decoding is greedy, so the cursor is ``cur``, the PENDING token
    (computed, not yet delivered nor written to the cache), ``kv_len``
    (rows valid) and ``rem`` (tokens still owed).  ``payload`` is the
    ``lm.export_slot`` cache lane as host tensors (copies, never views of
    a cache); ``None`` marks a COLD snapshot (never admitted: restoring
    re-queues it for ordinary prefill).  ``prefix_len``: leading rows NOT
    in the payload (a prefix-shared slot ships only its private suffix);
    the restoring engine rebuilds them from its prefix registry or by
    re-prefilling ``request.prompt[:prefix_len]``."""

    request: Request
    rem: int
    kv_len: int = 0
    cur: int | None = None
    payload: dict | None = None
    prefix_len: int = 0

    @property
    def warm(self) -> bool:
        return self.payload is not None

    @property
    def payload_bytes(self) -> int:
        """On-wire cost of migrating this snapshot (the cache lane only)."""
        return lm.slot_payload_bytes(self.payload) if self.warm else 0


class ServeEngine:
    """Continuous-batching serving runtime (greedy decoding).

    ``batch_size`` device-resident slots each hold one in-flight request
    at its own cache offset.  Admission happens at any step regardless of
    prompt length (chunked per-slot prefill); decode runs in
    ``decode_chunk``-token chunks with ONE host sync per chunk; a slot is
    recycled the moment its request finishes, at chunk granularity.

    Driving: ``generate(requests)`` runs to drain; ``start(requests)`` +
    ``step()`` while ``pending`` runs one admission round plus one decode
    chunk at a time; ``submit`` queues more onto a running stream.

    ``paged=True`` swaps the dense per-slot cache for a refcounted block
    pool (``block_size`` rows per block, ``n_blocks`` blocks; default =
    dense capacity).  Every slot reserves its blocks UP FRONT at admission
    (prompt + max_new_tokens rows), so a running request never meets an
    exhausted pool; admission is gated instead (FCFS).  Token streams
    equal the dense engine's.  ``prefix_sharing=True`` also registers each
    request's ``prefix_len`` leading rows after prefill; later admissions
    whose prompts start with the same tokens map the cached blocks
    (copy-on-write on the partial tail block) and skip prefilling them.
    As in the reference, an ``ssm`` model has no rows to page and refuses
    ``paged=True``, and a cache with recurrent state (ssm, hybrid) refuses
    prefix sharing; each admission zeroes the slot's Mamba state.

    The engine runs on ``ctx.device`` (``cuda`` by default; raises when
    there is no card, unless the Ctx names the CPU).  On the card every
    decode chunk after the engine's first is one replay of a CUDA graph
    of the chunk, and every prefill chunk after its size's first use one
    replay of that size's graph, run in the prefill lane
    (``serving/graphs.py``); ``eager=True`` runs each chunk directly
    instead, as a CPU engine does.  A capture or replay that fails
    raises.  The cache, the lane vectors, the prefill lane and the
    ``out`` buffer are allocated by the first stream and kept by later
    ones.

    ``drain``/``restore``/``checkpoint``/``abandon`` preempt the stream
    losslessly (see the module docstring); ``select_victims`` names a
    partial drain's slots under ``victim_policy`` (default
    ``fewest_remaining``) and ``set_slot_limit`` keeps shed lanes empty.
    ``snapshot_int8=True`` quantizes warm payloads on the device before
    they cross to the host (per-row int8 + f32 scale: about half the
    bytes, and restores no longer bit-exact).
    """

    def __init__(self, cfg: ModelConfig, run: RunConfig, ctx: Ctx, params,
                 batch_size: int = 4, max_seq: int = 256, power=None,
                 prefill_chunk: int = 32, decode_chunk: int = 8,
                 snapshot_int8: bool = False, victim_policy=None,
                 tracer=None, trace_track: str = "engine",
                 paged: bool = False, block_size: int = 16,
                 n_blocks: int | None = None, prefix_sharing: bool = False,
                 eager: bool = False):
        if prefix_sharing and not paged:
            raise ValueError("prefix_sharing requires paged=True")
        if paged:
            if cfg.family == "ssm":
                raise ValueError("ssm caches have no sequence rows to page")
            if max_seq % block_size:
                raise ValueError(f"max_seq {max_seq} must be a multiple of "
                                 f"block_size {block_size}")
            if prefix_sharing and any(
                    kind == lm.SLOT_STATE
                    for kind in lm.cache_slot_spec(cfg).values()):
                raise ValueError(
                    "prefix_sharing requires a pure-rows cache schema "
                    "(recurrent state cannot be row-shared)")
        prefill_chunk = min(prefill_chunk, max_seq)
        if prefill_chunk < 1 or prefill_chunk & (prefill_chunk - 1):
            raise ValueError(f"prefill_chunk must be a power of two, "
                             f"got {prefill_chunk}")
        if decode_chunk < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {decode_chunk}")
        self.device = resolve_device(ctx.device)
        self.cfg, self.run, self.ctx = cfg, run, ctx
        self.params = lm.prepare_params(ctx, params)
        self.batch_size, self.max_seq = batch_size, max_seq
        self.power = power
        self.prefill_chunk = prefill_chunk
        self.decode_chunk = decode_chunk
        self.snapshot_int8 = snapshot_int8
        self.victim_policy = victim_policy or fewest_remaining
        self.paged, self.block_size = paged, block_size
        self.prefix_sharing = prefix_sharing
        self.max_blocks = max_seq // block_size if paged else 0
        self.n_blocks = (n_blocks if n_blocks is not None
                         else batch_size * self.max_blocks) if paged else 0
        # paged-mode counters
        self.prefill_tokens_skipped = 0
        self.cow_copies = 0
        self.peak_used_blocks = 0
        # observability: spans/instants on a modeled virtual timebase
        # (``_vt`` advances by the modeled phase runtime when a power
        # session is attached, by 1.0 per phase otherwise)
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.trace_track = trace_track
        self._vt = 0.0
        self._prefill_step = (make_prefill_chunk_step_paged if paged
                              else make_prefill_chunk_step)(cfg, run, ctx)
        self._prefill_lane_fn = make_prefill_lane_step(cfg, run, ctx)
        self._decode_fn = make_decode_chunk_step(cfg, run, ctx, decode_chunk,
                                                 max_seq)
        # a CPU has no graphs: the caller who asks for it runs eagerly
        self.eager = eager or self.device.type != "cuda"
        self.graph = None              # the decode chunk's ChunkGraph
        self.prefill_graphs: dict[int, graphs.ChunkGraph] = {}  # by size
        self._spec = lm.cache_slot_spec(cfg)
        self._cache = None             # allocated by the first stream
        self._lane = None              # the graphed prefill's, likewise
        self._sched = None
        # warm snapshots awaiting a free slot (installed ahead of fresh
        # admissions: they carry finished work)
        self._restore_q: deque[SlotSnapshot] = deque()
        # occupancy cap surviving drain/restore cycles (a partial
        # preemption pins it below batch_size so shed lanes stay empty)
        self._slot_limit = batch_size
        # transfer seam: tests swap this for a counting double to assert
        # the one-sync-per-chunk contract
        self._fetch = _to_host
        self.sync_count = 0
        self.finished: list[Request] = []

    # -- internals ---------------------------------------------------------
    def _phase(self, name: str, calls: int | None = None):
        if self.power is None:
            return contextlib.nullcontext()
        return self.power.phase(name, calls=calls)

    def _tokens(self, toks: list[int]):
        # non_blocking: the runtime stages pageable memory, so the host
        # does not wait for the device's queue
        return torch.tensor([toks], dtype=torch.int32).to(self.device,
                                                          non_blocking=True)

    def _prefill_rows(self, tokens, sid: int, idx0: int):
        """Chunked prefill of ``tokens`` into rows [idx0, idx0 + len) of
        slot ``sid``, its Mamba state zeroed first; returns the last-token
        logits (1, V).  ``idx0 > 0`` is the prefix-shared suffix prefill
        (paged only).  Eager, every chunk writes the slot's views; graphed,
        the chunks run in the prefill lane, which is then committed to the
        slot (a dense prefill starts at row 0, so the lane's rows [0, len)
        are the request's)."""
        if self.eager:
            _reset_state_slot(self._cache, sid)
        else:
            _reset_state_slot(self._lane, 0)
            if self.paged:
                self._lane["block_tables"].copy_(
                    self._cache["block_tables"][sid:sid + 1])
        idx, logits = idx0, None
        for size in chunk_plan(len(tokens), self.prefill_chunk):
            o = idx - idx0
            logits = self._prefill_chunk(tokens[o:o + size], sid, idx)
            idx += size
        if not self.eager:
            self._commit_lane(sid, idx)
        return logits

    def _prefill_chunk(self, toks: list[int], sid: int, idx: int):
        """One prompt chunk at row ``idx`` of slot ``sid``; returns its
        last-token logits (1, V).  Eager, the chunk program on the slot's
        views.  Graphed, in the lane: the token buffer of the chunk's size
        is set by a non-blocking copy from pageable memory (the runtime
        stages it, so the host does not wait for the device's queue, and
        no reused host buffer can race the copy), the offset by ``fill_``;
        then the size's graph is replayed, or, at the size's first use,
        ``graphs.capture``'s eager warm-up runs the chunk and the graph is
        captured on the lane's shared stream and pool."""
        if self.eager:
            self._cache, logits = self._prefill_step(
                self.params, self._cache, self._tokens(toks), sid, idx)
            return logits
        buf = self._lane_tokens[len(toks)]
        buf.copy_(torch.tensor([toks], dtype=torch.int32), non_blocking=True)
        self._offset.fill_(idx)
        graph = self.prefill_graphs.get(len(toks))
        if graph is not None:
            graph.replay()
        else:
            self.prefill_graphs[len(toks)] = graphs.capture(
                lambda: self._prefill_lane_fn(self.params, self._lane, buf,
                                              self._offset, self._logits),
                self.device, share=self._share)
        return self._logits

    def _commit_lane(self, sid: int, rows: int) -> None:
        """Copy the prefill lane into slot ``sid``, one strided copy per
        leaf on the device's queue: rows [0, rows) of each dense rows
        leaf, and each state leaf whole.  A paged engine's pools were
        written in place through the staging row."""
        for key, lane in self._lane.items():
            if key == "block_tables" or lane is self._cache[key]:
                continue
            for k, a in lane.items():
                dst = self._cache[key][k][:, sid]
                if self._spec[key] == lm.SLOT_ROWS:
                    dst[:, :rows].copy_(a[:, 0, :rows])
                else:
                    dst.copy_(a[:, 0])

    # -- paged-mode block bookkeeping (host only) ----------------------------

    def _shared_credit(self, prompt, prefix_cap: int) -> int:
        """Rows a registry hit would supply for ``prompt`` right now --
        side-effect-free (the admission gate's capacity estimate)."""
        if self._registry is None or prefix_cap <= 0:
            return 0
        rows, _ = self._registry.lookup(prompt, prefix_cap, peek=True)
        return rows

    def _fits_blocks(self, prompt, total_rows: int, prefix_cap: int) -> bool:
        """Whether the pool can cover a ``total_rows``-row reservation for
        ``prompt`` -- counting full shared prefix blocks as free credit and
        evicting LRU registry prefixes when the free list falls short."""
        need_full = self._alloc.blocks_for(total_rows)
        credit = self._shared_credit(prompt, prefix_cap) // self.block_size
        if self._alloc.free_blocks >= need_full - credit:
            return True
        if self._registry is not None:
            # eviction may drop the very prefix the credit counted on --
            # re-probe after, never before, trusting the stale credit
            self._registry.evict_for(need_full)
            credit = self._shared_credit(prompt, prefix_cap) \
                // self.block_size
        return self._alloc.free_blocks >= need_full - credit

    def _can_admit(self, req: Request) -> bool:
        return self._fits_blocks(
            req.prompt, len(req.prompt) + req.max_new_tokens,
            min(req.prefix_len, len(req.prompt) - 1))

    def _set_table_row(self, sid: int, blocks) -> None:
        """Map slot ``sid``'s table row to ``blocks``, the rest of the row
        to the parking block.  non_blocking: the runtime stages the host
        row, so the host does not wait for the device's queue."""
        row = list(blocks) + [self._parking] * (self.max_blocks - len(blocks))
        self._cache["block_tables"][sid].copy_(
            torch.tensor(row, dtype=torch.int32), non_blocking=True)

    def _copy_block(self, src: int, dst: int) -> None:
        """CoW: duplicate pool block ``src`` into ``dst`` in every layer's
        pools of every rows key (a plain tensor copy, on the device's
        queue)."""
        for key, kind in self._spec.items():
            if kind == lm.SLOT_ROWS:
                for pool in self._cache[key].values():
                    pool[:, dst] = pool[:, src]

    def _map_slot_blocks(self, sid: int, total_rows: int, shared_rows: int,
                         shared_blocks) -> list[int]:
        """Reserve and table-map slot ``sid``'s blocks for a
        ``total_rows``-row lifetime: full shared prefix blocks are
        reference-mapped, a partially shared tail block is copy-on-write
        duplicated (its first write, the suffix prefill, is imminent), and
        the remainder is allocated fresh.  Returns the logical-order block
        list (also recorded in ``_slot_blocks``)."""
        bs = self.block_size
        full = shared_rows // bs
        blocks: list[int] = []
        if shared_rows:
            self._alloc.share(shared_blocks[:full])
            blocks += shared_blocks[:full]
            if shared_rows % bs:
                tail = shared_blocks[full]
                self._alloc.share([tail])           # our reference...
                priv, copied = self._alloc.ensure_private(tail)  # ...pivots
                if copied:
                    self._copy_block(tail, priv)
                    self.cow_copies += 1
                blocks.append(priv)
        blocks += self._alloc.alloc(
            self._alloc.blocks_for(total_rows) - len(blocks))
        self._slot_blocks[sid] = blocks
        self._slot_shared_rows[sid] = shared_rows
        self._set_table_row(sid, blocks)
        self.peak_used_blocks = max(self.peak_used_blocks,
                                    self._alloc.used_blocks)
        return blocks

    def _release_slot_blocks(self, sid: int) -> None:
        """Return slot ``sid``'s block references to the pool and park its
        table row (shared prefix blocks survive through their other
        holders)."""
        self._alloc.release(self._slot_blocks.pop(sid))
        self._slot_shared_rows.pop(sid, None)
        self._set_table_row(sid, [])

    def _admit_paged(self, req: Request, sid: int):
        """Paged admission: map blocks (sharing any registered prefix),
        prefill only the unshared suffix, then register the prefix for
        later admissions.  Returns the last-token logits (1, V)."""
        plen = len(req.prompt)
        cap = min(req.prefix_len, plen - 1)   # >= 1 suffix token ALWAYS
        shared_rows, shared_blocks = 0, []
        if self._registry is not None and cap > 0:
            shared_rows, shared_blocks = self._registry.lookup(
                req.prompt, cap)
        blocks = self._map_slot_blocks(sid, plen + req.max_new_tokens,
                                       shared_rows, shared_blocks)
        logits = self._prefill_rows(req.prompt[shared_rows:], sid,
                                    shared_rows)
        self.prefill_tokens_skipped += shared_rows
        if self._registry is not None and cap > 0:
            self._registry.register(req.prompt, cap,
                                    blocks[:self._alloc.blocks_for(cap)])
        return logits

    # -- stream state --------------------------------------------------------

    def _ensure_stream(self) -> None:
        """Bring up the stream state if none is active: the device state
        is allocated by the first stream and reset in place by later ones
        (a captured graph holds its addresses); the host's block books
        are made anew."""
        if self._sched is not None:
            return
        self._sched = SlotScheduler(self.batch_size)
        self._sched.set_limit(self._slot_limit)
        if self._cache is None:
            self._alloc_state()
        else:
            self._reset_state()
        if self.paged:
            self._alloc = BlockAllocator(self.n_blocks, self.block_size)
            self._registry = (PrefixRegistry(self._alloc)
                              if self.prefix_sharing else None)
            self._slot_blocks: dict[int, list[int]] = {}
            self._slot_shared_rows: dict[int, int] = {}
        else:
            self._alloc = self._registry = None

    def _alloc_state(self) -> None:
        """The engine's device state, once: the cache, the lane vectors
        and the decode chunk's ``out`` buffer."""
        B, dev = self.batch_size, self.device
        if self.paged:
            # the pool holds one PARKING block beyond the allocator's
            # arena: free and released table entries point at it, never at
            # an allocatable block
            self._parking = self.n_blocks
            self._cache = lm.init_paged_cache(
                self.ctx, self.cfg, B, self.max_seq, self.block_size,
                n_blocks=self.n_blocks + 1)
            self._cache["block_tables"].fill_(self._parking)
        else:
            self._cache = lm.init_cache(self.ctx, self.cfg, B, self.max_seq)
        self._cur = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._index = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._rem = torch.zeros((B,), dtype=torch.int32, device=dev)
        self._done = torch.ones((B,), dtype=torch.bool, device=dev)
        # every decode chunk writes all of it before the host reads it
        self._out = torch.empty((B, self.decode_chunk), dtype=torch.int32,
                                device=dev)
        if not self.eager:
            self._alloc_lane()

    def _alloc_lane(self) -> None:
        """The graphed prefill's lane, once: one slot's worth (batch 1) of
        every dense rows and state leaf, zeros (a paged engine's pools are
        the cache's own, with a (1, max_blocks) staging table row); the
        (1,) row offset; a (1, size) token buffer per chunk size; the
        (1, V) float32 logits; and, on the card, the side stream and
        private memory pool its graphs share.  Every prefill graph reads
        and writes these addresses, so no later stream reallocates them:
        each request rewrites what it reads (state lanes zeroed, table row
        copied, rows written before attention reads them)."""
        dev = self.device
        self._lane = {}
        for key, leaves in self._cache.items():
            if key == "block_tables":
                self._lane[key] = torch.zeros_like(leaves[:1])
            elif self.paged and self._spec[key] == lm.SLOT_ROWS:
                self._lane[key] = leaves                # pools: passed whole
            else:
                self._lane[key] = {k: torch.zeros(a[:, :1].shape,
                                                  dtype=a.dtype, device=dev)
                                   for k, a in leaves.items()}
        self._offset = torch.zeros((1,), dtype=torch.int32, device=dev)
        self._lane_tokens = {
            size: torch.zeros((1, size), dtype=torch.int32, device=dev)
            for size in (self.prefill_chunk >> i
                         for i in range(self.prefill_chunk.bit_length()))}
        self._logits = torch.zeros((1, self.cfg.vocab_padded),
                                   dtype=torch.float32, device=dev)
        self._share = graphs.shared(dev) if dev.type == "cuda" else None

    def _reset_state(self) -> None:
        """``_alloc_state``'s values, written over the same storage (a
        fresh engine's: a done lane still feeds the MoE router and reads
        its slot's stale rows)."""
        for key, leaves in self._cache.items():
            if key == "block_tables":
                leaves.fill_(self._parking)
            else:
                for a in leaves.values():
                    a.zero_()
        for v in (self._cur, self._index, self._rem):
            v.zero_()
        self._done.fill_(True)

    def _decode_chunk(self) -> None:
        """One decode chunk into ``_out``: the body itself when eager; on
        the card the engine's first chunk is ``graphs.capture``'s eager
        warm-up and capture, and every later chunk one replay."""
        args = (self.params, self._cache, self._cur, self._index, self._rem,
                self._done, self._out)
        if self.eager:
            self._decode_fn(*args)
        elif self.graph is None:
            self.graph = graphs.capture(lambda: self._decode_fn(*args),
                                        self.device)
        else:
            self.graph.replay()

    def _validate_requests(self, requests) -> None:
        """Reject unservable requests before any device work: rows beyond
        ``max_seq`` (the graphed prefill's tensor offset has no row check
        of its own), or (paged) a block reservation no empty pool could
        cover, which would deadlock the FCFS admission gate."""
        for req in requests:
            total = len(req.prompt) + req.max_new_tokens
            if total > self.max_seq:
                raise ValueError(
                    f"request {req.uid}: prompt {len(req.prompt)} + "
                    f"max_new_tokens {req.max_new_tokens} exceeds "
                    f"max_seq {self.max_seq}")
            if self.paged and -(-total // self.block_size) > self.n_blocks:
                raise ValueError(
                    f"request {req.uid}: needs "
                    f"{-(-total // self.block_size)} blocks but the pool "
                    f"holds {self.n_blocks}")

    def _trace_submit(self, requests) -> None:
        if self.tracer.enabled:
            for req in requests:
                self.tracer.instant("submit", self._vt, self.trace_track,
                                    cat="serving", args={"uid": req.uid})

    # -- serving loop ------------------------------------------------------
    def start(self, requests: list[Request]) -> None:
        """Install a FRESH request stream (any previous stream state is
        reset); then drive ``step()`` until ``pending`` is False."""
        self._validate_requests(requests)
        self._sched = None
        self._restore_q.clear()
        self.finished = []
        self._ensure_stream()
        self._sched.submit(requests)
        self._trace_submit(requests)

    def submit(self, requests: list[Request]) -> None:
        """Queue MORE requests onto the stream without resetting it."""
        self._validate_requests(requests)
        self._ensure_stream()
        self._sched.submit(requests)
        self._trace_submit(requests)

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot: the FCFS queue and the snapshots
        not yet re-admitted."""
        q = len(self._restore_q)
        return q + (len(self._sched.queue) if self._sched is not None else 0)

    @property
    def active_slots(self) -> int:
        """Slots currently occupied by an in-flight request."""
        return len(self._sched.active()) if self._sched is not None else 0

    @property
    def pending(self) -> bool:
        """Whether the stream still has queued, restorable or in-flight
        requests (False before ``start``/``restore`` and after a full
        ``drain``)."""
        if self._restore_q:
            return True
        return self._sched.has_work if self._sched is not None else False

    @property
    def in_flight_tokens(self) -> int:
        """Tokens already generated for requests still occupying slots:
        what a caller loses if it abandons the stream mid-stint."""
        if self._sched is None:
            return 0
        return sum(len(s.request.generated) for s in self._sched.active())

    def step(self) -> list[Request]:
        """One engine step: admit whatever fits the free slots, run one
        decode chunk, deliver the chunk's tokens.  Returns the requests
        that finished THIS step (also appended to ``self.finished``)."""
        if not self.pending:
            return []
        sched = self._sched
        tr = self.tracer if self.tracer.enabled else None
        chunk_t0 = self._vt
        # restored slots first: their work is already paid for, and a warm
        # snapshot's install is a cache write, not a prefill
        while self._restore_q:
            snap = self._restore_q[0]
            if self.paged and not self._fits_blocks(
                    snap.request.prompt, snap.kv_len + snap.rem,
                    snap.prefix_len):
                break               # FCFS: later snapshots wait too
            slot = sched.occupy(snap.request)
            if slot is None:
                break
            self._install_snapshot(self._restore_q.popleft(), slot.sid)
        can_admit = self._can_admit if self.paged else None
        for slot in sched.admit_ready(can_admit=can_admit):
            req = slot.request
            plen = len(req.prompt)
            # phase cost in chunk programs actually run: a shared prefix
            # skips its chunks
            skip = self._shared_credit(
                req.prompt, min(req.prefix_len, plen - 1)) if self.paged \
                else 0
            n_calls = len(chunk_plan(plen - skip, self.prefill_chunk))
            with self._phase("prefill", calls=n_calls) as rec:
                if self.paged:
                    logits = self._admit_paged(req, slot.sid)
                else:
                    logits = self._prefill_rows(req.prompt, slot.sid, 0)
            _admit_step(self._cur, self._index, self._rem, self._done,
                        logits, slot.sid, len(req.prompt),
                        req.max_new_tokens)
            if tr is not None:
                m = getattr(rec, "modeled", None)
                dt = m.runtime if m is not None else 1.0
                tr.span("prefill", self._vt, self._vt + dt,
                        self.trace_track, cat="phase",
                        args={"uid": req.uid,
                              "energy_j": m.energy if m is not None
                              else 0.0})
                self._vt += dt
        uids = [s.request.uid for s in sched.active()] \
            if tr is not None else None
        with self._phase("decode", calls=self.decode_chunk) as rec:
            self._decode_chunk()
        if tr is not None:
            m = getattr(rec, "modeled", None)
            dt = m.runtime if m is not None else 1.0
            tr.span("decode", self._vt, self._vt + dt, self.trace_track,
                    cat="phase",
                    args={"uids": uids,
                          "energy_j": m.energy if m is not None else 0.0})
            self._vt += dt
            tr.span("engine.chunk", chunk_t0, self._vt, self.trace_track,
                    cat="chunk", args={"active": len(uids)})
        out_host = self._fetch(self._out)     # the chunk's ONE sync
        self.sync_count += 1
        newly: list[Request] = []
        for slot in sched.active():
            row = out_host[slot.sid]
            fresh = [int(t) for t in row[:_valid_len(row)]]
            slot.request.generated.extend(fresh)
            slot.emitted += len(fresh)
            if slot.emitted >= slot.request.max_new_tokens:
                newly.append(sched.release(slot))
                if self.paged:
                    self._release_slot_blocks(slot.sid)
        self.finished.extend(newly)
        return newly

    def generate(self, requests: list[Request]) -> list[Request]:
        self.start(requests)
        while self.pending:
            self.step()
        return self.finished

    # -- preemption (``repro/serving/engine.py:703-962``) -------------------
    #
    # The device state is never freed or rebound: a full drain and
    # ``abandon`` drop only the host's books (scheduler, block allocator,
    # prefix registry), and the next stream resets the same storage.

    def _fetch_payloads(self, payloads: list[dict]) -> list[dict]:
        """Every leaf of ``payloads`` (device sources: views of the cache,
        ``lm.PoolRows``, or int8 q and scale) to the host in ONE transfer:
        each leaf is written straight into one packed device buffer (at a
        16-byte-aligned offset), the only copy on the device, ``_fetch``
        copies it to the host once, and each leaf comes back as a host
        tensor over its bytes (a copy, never a view of the cache)."""
        leaves: list = []
        for p in payloads:
            tree_map(leaves.append, p)
        sizes = [math.prod(a.shape) * a.dtype.itemsize for a in leaves]
        offsets, n = [], 0
        for size in sizes:
            offsets.append(n)
            n += -(-size // 16) * 16
        buf = torch.empty(n, dtype=torch.uint8, device=self.device)

        def over(mem, a, o, size):
            return mem[o:o + size].view(a.dtype).view(a.shape)

        for a, o, size in zip(leaves, offsets, sizes):
            dst = over(buf, a, o, size)
            if isinstance(a, lm.PoolRows):
                a.read(out=dst)
            else:
                dst.copy_(a)
        host = torch.from_numpy(self._fetch(buf))
        it = iter(over(host, a, o, size)
                  for a, o, size in zip(leaves, offsets, sizes))
        return [tree_map(lambda _: next(it), p) for p in payloads]

    def _export_payload(self, sid: int, kv_len: int):
        """One slot's snapshot payload as device sources (``lm.slot_lane``:
        views of the lane, or the pool rows a paged slot maps), with the
        same schema either way, so payloads are layout-portable; int8 on
        the device already under ``snapshot_int8``.  A prefix-shared paged
        slot ships only rows [shared, kv_len): the receiver rebuilds the
        prefix."""
        if self.paged:
            lane = lm.slot_lane(self.cfg, self._cache, sid, kv_len,
                                self._slot_shared_rows.get(sid, 0),
                                self._slot_blocks[sid], self.block_size)
        else:
            lane = lm.slot_lane(self.cfg, self._cache, sid, kv_len)
        return lm.quantize_payload(lane) if self.snapshot_int8 else lane

    def _snapshot_slots(self, slots, clone: bool) -> list[SlotSnapshot]:
        """Warm snapshots of ``slots`` in two host syncs: the stacked
        cursor vectors (kv_len sizes the payload), then every payload in
        one transfer.  ``clone``: the snapshots own copies of the
        requests (a checkpoint, which later decode must not reach)."""
        if not slots:
            return []
        cur, index, rem = self._fetch(torch.stack(
            (self._cur, self._index, self._rem)))
        payloads = self._fetch_payloads([
            self._export_payload(s.sid, int(index[s.sid])) for s in slots])
        self.sync_count += 2
        return [SlotSnapshot(
            request=s.request.clone() if clone else s.request,
            rem=int(rem[s.sid]), kv_len=int(index[s.sid]),
            cur=int(cur[s.sid]), payload=payload,
            prefix_len=(self._slot_shared_rows.get(s.sid, 0)
                        if self.paged else 0))
            for s, payload in zip(slots, payloads)]

    def _export_slots(self, sched, chosen) -> list[SlotSnapshot]:
        """Export ``chosen`` active slots as warm snapshots and release
        them from the scheduler (and, paged, their blocks)."""
        snaps = self._snapshot_slots(list(chosen), clone=False)
        for slot in list(chosen):
            sid = slot.sid
            sched.release(slot)
            if self.paged:
                self._release_slot_blocks(sid)
        return snaps

    def select_victims(self, n: int) -> list[int]:
        """Slot ids of the ``n`` partial-drain victims the engine's
        ``victim_policy`` picks (default: fewest remaining tokens first):
        the ``slots=`` argument a proportional ``drain`` wants."""
        if self._sched is None or n <= 0:
            return []
        return [s.sid for s in self.victim_policy(self._sched.active())[:n]]

    def set_slot_limit(self, limit: int) -> None:
        """Cap concurrent occupancy below ``batch_size``: a partial
        preemption sheds capacity, not just current occupants, so freed
        lanes do not refill from the queue until the cap is raised.  The
        cap survives drain/restore cycles."""
        if not 1 <= limit <= self.batch_size:
            raise ValueError(f"slot limit must be in [1, "
                             f"{self.batch_size}], got {limit}")
        self._slot_limit = limit
        if self._sched is not None:
            self._sched.set_limit(limit)

    @property
    def slot_limit(self) -> int:
        return self._slot_limit

    def drain(self, slots=None) -> list[SlotSnapshot]:
        """Stop the stream LOSSLESSLY, entirely or slot by slot.

        ``slots=None``: every in-flight slot becomes a warm snapshot,
        every queued or not yet installed request a cold one, and the
        engine is left idle (``pending`` False).  ``slots=[sid, ...]``:
        only the named slots are exported and their decode lanes masked
        (done, nothing owed, written in place by ``fill_``); every other
        slot decodes on bit-identically, since per-slot cache state is
        independent.  The stream stays up; pair with ``set_slot_limit``
        to keep the shed lanes empty."""
        sched = self._sched
        if sched is None:
            return []
        if slots is not None:
            want = set(slots)
            chosen = [s for s in sched.active() if s.sid in want]
            snaps = self._export_slots(sched, chosen)
            for slot in chosen:
                # done lanes write at max_seq (dropped) and emit nothing
                sid = slot.sid
                self._done[sid:sid + 1].fill_(True)
                self._rem[sid:sid + 1].fill_(0)
                self._cur[sid:sid + 1].fill_(0)
            return snaps
        snaps = self._export_slots(sched, sched.active())
        snaps.extend(self._restore_q)
        self._restore_q.clear()
        snaps.extend(SlotSnapshot(request=req, rem=req.max_new_tokens)
                     for req in sched.queue)
        self._sched = None          # the books go; the device state stays
        self._alloc = self._registry = None
        return snaps

    def checkpoint(self) -> list[SlotSnapshot]:
        """Snapshot the WHOLE stream non-destructively: every in-flight
        slot warm (the same two host syncs as a drain), every snapshot
        awaiting restore and every queued request in its current form,
        with the requests CLONED, so later decode on the live stream
        cannot reach the checkpoint.  Nothing is released; decoding
        continues untouched, and restoring the checkpoint replays from
        this boundary bit-identically."""
        sched = self._sched
        if sched is None:
            return []
        snaps = self._snapshot_slots(sched.active(), clone=True)
        snaps.extend(dataclasses.replace(s, request=s.request.clone())
                     for s in self._restore_q)
        snaps.extend(SlotSnapshot(request=req.clone(),
                                  rem=req.max_new_tokens)
                     for req in sched.queue)
        return snaps

    def abandon(self) -> None:
        """Crash path: drop the stream WITHOUT exporting anything.
        In-flight work not covered by an earlier ``checkpoint`` is lost;
        the engine is left idle and restarts with ``start``/``restore``."""
        self._sched = None
        self._alloc = self._registry = None
        self._restore_q.clear()

    def restore(self, snaps: list[SlotSnapshot]) -> None:
        """Admit snapshots into this engine's stream (started on demand).
        Warm ones install their cache lane and resume their cursor as a
        slot frees, ahead of fresh admissions; cold ones join the FCFS
        queue.  A snapshot this engine cannot hold raises before any
        device work."""
        for s in snaps:
            need = s.kv_len + s.rem if s.warm \
                else len(s.request.prompt) + s.request.max_new_tokens
            if need > self.max_seq:
                raise ValueError(
                    f"request {s.request.uid}: snapshot needs {need} cache "
                    f"rows but this engine holds max_seq {self.max_seq}")
            if self.paged and -(-need // self.block_size) > self.n_blocks:
                raise ValueError(
                    f"request {s.request.uid}: snapshot needs "
                    f"{-(-need // self.block_size)} blocks but the pool "
                    f"holds {self.n_blocks}")
        self._ensure_stream()
        tr = self.tracer if self.tracer.enabled else None
        for s in snaps:
            if not s.warm:
                self._sched.submit([s.request])
                self._trace_submit([s.request])
            elif s.rem <= 0:        # finished between export and restore
                self.finished.append(s.request)
            else:
                self._restore_q.append(s)
                if tr is not None:
                    tr.instant("restore", self._vt, self.trace_track,
                               cat="serving",
                               args={"uid": s.request.uid,
                                     "bytes": s.payload_bytes,
                                     "kv_len": s.kv_len})

    def _install_snapshot(self, snap: SlotSnapshot, sid: int) -> None:
        """Write a warm snapshot's cache lane into slot ``sid``, in place,
        and arm its decode lane at the restored cursor.  A prefix-trimmed
        payload (``prefix_len > 0``) has rows [0, prefix_len) rebuilt here:
        from this engine's prefix registry when it holds them, else by
        re-prefilling that prompt span (graphed: in the prefill lane, whose
        commit copies only those rows)."""
        prompt, pfx = snap.request.prompt, snap.prefix_len
        if self.paged:
            shared_rows, shared_blocks = 0, []
            if self._registry is not None and pfx > 0:
                shared_rows, shared_blocks = self._registry.lookup(
                    prompt, pfx)
            blocks = self._map_slot_blocks(sid, snap.kv_len + snap.rem,
                                           shared_rows, shared_blocks)
            _reset_state_slot(self._cache, sid)
            if shared_rows < pfx:
                n = len(chunk_plan(pfx - shared_rows, self.prefill_chunk))
                with self._phase("prefill", calls=n):
                    self._prefill_rows(prompt[shared_rows:pfx], sid,
                                       shared_rows)
            self.prefill_tokens_skipped += shared_rows
            lm.import_slot_paged(self.cfg, self._cache, snap.payload, sid,
                                 blocks, self.block_size, row_offset=pfx)
            if self._registry is not None and pfx > 0:
                self._registry.register(
                    prompt, pfx, blocks[:self._alloc.blocks_for(pfx)])
        else:
            # the dense importer overwrites the WHOLE lane (rows below
            # row_offset zeroed), so the prefix re-prefill comes AFTER it
            lm.import_slot(self.cfg, self._cache, snap.payload, sid,
                           row_offset=pfx)
            if pfx > 0:
                n = len(chunk_plan(pfx, self.prefill_chunk))
                with self._phase("prefill", calls=n):
                    self._prefill_rows(prompt[:pfx], sid, 0)
        _install_step(self._cur, self._index, self._rem, self._done,
                      snap.cur, sid, snap.kv_len, snap.rem)


def _valid_len(row) -> int:
    """Emitted tokens are a -1-terminated prefix of the chunk buffer."""
    n = 0
    for t in row:
        if t < 0:
            break
        n += 1
    return n
