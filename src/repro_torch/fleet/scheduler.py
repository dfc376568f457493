"""Power-aware job scheduling: a mixed train/serve queue onto fleet nodes.

The ``Job`` protocol is deliberately thin: a job names its recurring
phases (``repro_torch.core.tasks.Task`` roofline terms — the same
segmentations
``launch/train.py`` and ``serving.engine`` run under), weights them into
one *step*, and advances its own progress when the node executes a step.
Two implementations ship:

  * ``TrainJob`` — phases from
    ``repro_torch.train.phases.training_phase_tasks``
    (the exact per-step mix the training launcher caps); optionally wraps
    a real jitted ``step_fn`` from ``repro_torch.train.step.make_train_step``.
    Preemption rolls progress back to the last checkpoint boundary and is
    accounted through ``repro_torch.runtime.supervisor.StepwiseSupervisor`` —
    the same restart budget/backoff policy the blocking ``Supervisor``
    applies to SIGTERM'd training runs.
  * ``ServeJob`` — phases from
    ``repro_torch.serving.engine.serve_phase_tasks``
    at decode-chunk granularity; optionally wraps a real ``ServeEngine``
    driven through its incremental ``start()``/``step()`` API, so a fleet
    node actually serves requests between preemption points.

``FleetScheduler`` places the queue under the facility power envelope:
a node is only admitted when the budget still covers every busy node's
physical floor plus a useful-work margin, and when the envelope shrinks
below that, jobs are preempted (train first — they checkpoint — then
serve, LIFO) and resumed after their supervisor backoff once the budget
recovers.

A copy of ``repro/fleet/scheduler.py`` (pure Python; the port imports
nothing of ``repro``).
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from collections import deque
from typing import Protocol, runtime_checkable

from repro_torch.core.tasks import Task
from repro_torch.runtime.supervisor import StepwiseSupervisor
from repro_torch.serving.scheduler import Request


@runtime_checkable
class Job(Protocol):
    """One schedulable unit of fleet work."""

    name: str
    kind: str           # "train" | "serve"
    value: float        # worth of one of this job's tokens in the fleet
                        # objective (weighted tokens/s) and the
                        # preemption order — low value is shed first

    @property
    def done(self) -> bool:
        ...

    def phase_tasks(self) -> list[Task]:
        """The job's recurring phases with roofline terms — what the
        node's PowerManager sweeps and schedules caps for."""
        ...

    def step_phases(self) -> list[tuple[str, float]]:
        """``(phase_name, weight)`` making up ONE job step; ``weight``
        scales the phase's modeled runtime/energy (e.g. a prefill that
        recurs every Nth decode chunk amortizes at weight 1/N)."""
        ...

    def tokens_per_step(self) -> int:
        ...

    def advance(self, step_s: float, now: float | None = None) -> int:
        """Commit one executed step (``step_s`` modeled seconds, ending
        at virtual time ``now`` when the caller tracks one); returns the
        tokens actually emitted."""
        ...

    def preempt(self) -> float:
        """Cooperative preemption; returns the backoff delay (virtual
        seconds) before the job may be re-placed.  Afterwards the job
        reports what the preemption cost through three accounting
        attributes: ``last_preempt_dropped`` (tokens of work destroyed —
        to be redone), ``snapshot_tokens``/``snapshot_bytes`` (in-flight
        tokens preserved in a portable snapshot and the on-wire size a
        cross-node resume must move)."""
        ...


@dataclasses.dataclass
class TrainJob:
    """A capped training run: phases from ``training_phase_tasks``.

    ``step_fn`` optionally carries a REAL jitted train step (the callable
    ``launch/train.py`` builds via ``make_train_step``); the fleet then
    executes it once per modeled step.  Progress checkpoints every
    ``ckpt_every`` steps: a preemption rolls ``steps_done`` back to the
    last boundary (the work since is lost, exactly as a restart-from-
    checkpoint loses it) and pays the supervisor's restart backoff."""

    name: str
    cfg: object                    # repro_torch.configs.base.ModelConfig
    batch: int
    seq: int
    total_steps: int
    ckpt_every: int = 50
    chips: int = 1
    step_fn: object = None         # Optional[Callable[[int], None]]
    max_restarts: int = 8
    backoff_s: float = 0.1
    value: float = 1.0
    backoff_jitter: float = 0.0    # >0: seeded jitter de-lockstepping
                                   # simultaneous restarts (seed = name)
    kind: str = dataclasses.field(default="train", init=False)
    steps_done: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        self.supervisor = StepwiseSupervisor(
            max_restarts=self.max_restarts, backoff_s=self.backoff_s,
            jitter=self.backoff_jitter,
            seed=zlib.crc32(self.name.encode()))
        self._tasks: list[Task] | None = None
        self.last_preempt_dropped = 0   # tokens rolled back at last preempt
        self.dropped_total = 0          # cumulative rolled-back tokens
        self.snapshot_tokens = 0        # training migrates via checkpoint,
        self.snapshot_bytes = 0         # not via live state: always 0
        self.last_crash_lost = 0        # tokens a crash rolled back
        self.last_crash_replayed = 0    # training replays via real ckpt: 0

    @property
    def done(self) -> bool:
        return self.steps_done >= self.total_steps

    def phase_tasks(self) -> list[Task]:
        if self._tasks is None:
            from repro_torch.train.phases import training_phase_tasks
            self._tasks = training_phase_tasks(
                self.cfg, batch=self.batch, seq=self.seq, chips=self.chips)
        return self._tasks

    def step_phases(self) -> list[tuple[str, float]]:
        return [(t.name, 1.0) for t in self.phase_tasks()]

    def tokens_per_step(self) -> int:
        return self.batch * self.seq

    def advance(self, step_s: float, now: float | None = None) -> int:
        if self.step_fn is not None:
            self.step_fn(self.steps_done)
        self.steps_done += 1
        return self.tokens_per_step()

    def preempt(self) -> float:
        # roll back to the last checkpoint boundary: the un-checkpointed
        # tail is re-run after resume, as with a real restart
        rolled = self.steps_done % self.ckpt_every
        self.steps_done -= rolled
        self.last_preempt_dropped = rolled * self.tokens_per_step()
        self.dropped_total += self.last_preempt_dropped
        return self.supervisor.preempted()

    def on_crash(self) -> float:
        """Uncooperative death (watchdog verdict): same rollback as a
        preemption — training already restarts from its real checkpoint
        — but charged to the supervisor as a CRASH.  Raises RuntimeError
        once the restart budget is exhausted (job abandoned)."""
        rolled = self.steps_done % self.ckpt_every
        self.steps_done -= rolled
        self.last_preempt_dropped = rolled * self.tokens_per_step()
        self.dropped_total += self.last_preempt_dropped
        self.last_crash_lost = self.last_preempt_dropped
        self.last_crash_replayed = 0
        self.snapshot_tokens = self.snapshot_bytes = 0
        return self.supervisor.crashed("node crash")


@dataclasses.dataclass
class _SimSlot:
    """One modeled in-flight stream (engineless ``ServeJob``): tokens
    generated toward its current request and when that request started
    on the virtual clock (None = not yet / between requests).  In
    open-loop mode ``req`` carries the ``ArrivalEvent`` being served
    (None = idle lane) so completions know their arrival time, SLO
    class and per-request output length."""

    progress: int = 0
    started: float | None = None
    req: object = None      # Optional[repro_torch.workload.ArrivalEvent]


@dataclasses.dataclass
class ServeJob:
    """A serving stint: phases from ``serve_phase_tasks`` at decode-chunk
    granularity (one step = ``active_cap`` slots x ``decode_chunk``
    tokens, with the prefill phase amortized over each request's
    lifetime).

    ``engine`` optionally carries a real ``ServeEngine``; the job then
    drives it through ``start()``/``step()`` so each fleet step performs
    one actual admission round + decode chunk, and token counts come from
    the engine instead of the model.

    Preemption (``migrate=True``, the default) is a DRAIN, not a
    discard: the engine exports every in-flight request as a portable
    ``SlotSnapshot`` (``engine.drain()``), the job re-queues carrying the
    snapshots, and the resumed stint ``restore``s them — on the same node
    or any other whose engine accepts the payload — continuing each
    stream bit-identically.  ``snapshot_bytes`` is what a cross-node
    resume must move over the interconnect; the cluster charges that
    transfer on the virtual clock.  With ``migrate=False`` (the PR-3
    drop-and-restart baseline) a preemption destroys in-flight state:
    the lost tokens are refunded out of ``emitted``, reported through
    ``last_preempt_dropped``, and regenerated by the resumed stint.
    Fleet telemetry counts EXECUTED tokens, so dropped work appears
    twice there — exactly as a rolled-back TrainJob re-executes its
    un-checkpointed steps.

    ``partial=True`` additionally makes preemption PROPORTIONAL: when
    the envelope shortfall strands only part of the batch, the scheduler
    calls ``preempt(max_slots=k)`` and the job sheds just enough slots
    (fewest remaining tokens first) into a locally PARKED snapshot set
    while the survivors keep serving; ``grow`` re-admits parked slots as
    the budget recovers.  ``snapshot_int8=True`` compresses snapshot
    payloads at rest (per-row int8 + f32 scale), roughly halving the
    migration bytes at a bounded parity cost.

    Without an engine the same economics are modeled per slot: each of
    ``active_cap`` concurrent streams advances ``decode_chunk`` tokens
    per step, completing (and restarting) independently against the
    virtual clock — completions feed ``request_latencies``, the p50/p99
    the migration benchmark reports; per-slot snapshot bytes come from
    the analytic KV-cache model at each stream's current depth.

    ``open_loop=True`` switches the job from a fixed workload to a
    STANDING SERVICE: it serves whatever ``offer()`` feeds it (the
    ``repro_torch.workload`` arrival trace), idle lanes burn their step energy
    while emitting nothing (the waste autoscaling reclaims), ``done`` is
    never True, and each completion's latency counts from the request's
    ARRIVAL time — queue wait included — into ``request_latencies`` and
    the attached ``slo`` tracker.  ``slot_target`` (set by the
    autoscaler) caps how far the scheduler regrows a shrunken job;
    ``hibernate()`` is the voluntary park — the same lossless drain as
    ``preempt()`` but with no restart-budget charge and no backoff,
    because the job did nothing wrong."""

    name: str
    cfg: object                    # repro_torch.configs.base.ModelConfig
    batch: int
    prompt: int
    new_tokens: int                # per request
    total_requests: int
    decode_chunk: int = 8
    chips: int = 1
    # Optional[repro_torch.serving.engine.ServeEngine]
    engine: object = None
    requests: list = None          # real-engine mode: the stream to serve
    max_restarts: int = 8
    backoff_s: float = 0.1
    value: float = 1.0
    migrate: bool = True
    partial: bool = False
    snapshot_int8: bool = False
    open_loop: bool = False
    slo: object = None             # Optional[repro_torch.workload.SLOTracker]
    backoff_jitter: float = 0.0    # >0: seeded jitter de-lockstepping
                                   # simultaneous restarts (seed = name)
    kind: str = dataclasses.field(default="serve", init=False)
    emitted: int = dataclasses.field(default=0, init=False)

    def __post_init__(self):
        self.supervisor = StepwiseSupervisor(
            max_restarts=self.max_restarts, backoff_s=self.backoff_s,
            jitter=self.backoff_jitter,
            seed=zlib.crc32(self.name.encode()))
        self._tasks: list[Task] | None = None
        self._tasks_key: int | None = None
        self._started = False
        self._snapshots: list | None = None   # drained SlotSnapshots
        self._delivered_seen = 0
        self.request_latencies: list[float] = []
        self.last_preempt_dropped = 0
        self.dropped_total = 0
        self.snapshot_tokens = 0
        self.snapshot_bytes = 0
        # -- proportional-preemption state ---------------------------------
        self._active_cap = self.batch       # slots allowed to decode
        self._slots = [_SimSlot() for _ in range(self.batch)]  # modeled
        self._parked: list = []   # shed slots: _SimSlots / SlotSnapshots
        self.last_shed_slots = 0
        self.last_shed_tokens = 0
        self.last_shed_bytes = 0
        # -- open-loop (offered-traffic) state ------------------------------
        self.slot_target: int | None = None   # autoscaler's regrow ceiling
        self._pending = deque()               # modeled: offered, not placed
        self._arrivals: dict = {}             # engine: uid -> ArrivalEvent
        # -- shadow-checkpoint / crash state --------------------------------
        self._shadow: dict | None = None      # last shadow checkpoint
        self.shadow_t: float | None = None    # when it was taken
        self._done_uids: set = set()          # open-loop completions seen
        self.last_crash_lost = 0              # tokens the last crash lost
        self.last_crash_replayed = 0          # tokens replayed from shadow
        if self.engine is not None and self.snapshot_int8:
            self.engine.snapshot_int8 = True

    @property
    def total_tokens(self) -> int:
        return self.total_requests * self.new_tokens

    @property
    def done(self) -> bool:
        if self.open_loop:
            return False      # a standing service is never "done"
        if self.engine is not None:
            return (self._started and not self.engine.pending
                    and not self._parked)
        return self.emitted >= self.total_tokens

    # -- proportional-preemption surface ------------------------------------
    @property
    def capacity(self) -> int:
        """Full slot count — what ``active_cap`` regrows back to."""
        return self.batch

    @property
    def active_cap(self) -> int:
        """Slots currently allowed to decode (<= capacity; lowered by
        ``preempt(max_slots=...)``, raised by ``grow``)."""
        return self._active_cap

    @property
    def parked_slots(self) -> int:
        return len(self._parked)

    @property
    def partial_capable(self) -> bool:
        """Whether the scheduler may shed this job slot-by-slot instead
        of suspending it whole (requires the lossless drain path)."""
        return self.partial and self.migrate

    # -- open-loop feed (repro_torch.workload drives these) -------------------
    @property
    def queue_depth(self) -> int:
        """Offered requests waiting for a lane (not yet decoding)."""
        if self.engine is not None:
            if self._started:
                return self.engine.queue_depth
            return sum(1 for r in (self.requests or [])
                       if not r.done and not r.generated)
        return len(self._pending)

    @property
    def active_streams(self) -> int:
        """Requests currently occupying a decode lane."""
        if self.engine is not None:
            return self.engine.active_slots if self._started else 0
        return sum(1 for s in self._slots if s.req is not None)

    def _synth_prompt(self, ev) -> list[int]:
        """Deterministic stand-in prompt tokens for an offered arrival
        (the trace carries lengths, not text)."""
        return [(17 * ev.uid + 3 * j) % 251 + 2
                for j in range(max(ev.prompt_len, 1))]

    def offer(self, arrivals, now: float | None = None) -> None:
        """Feed offered traffic into a standing (open-loop) service.
        Modeled mode queues the events for the per-slot accounting;
        engine mode synthesizes real ``Request``s and submits them to
        the live stream (or the snapshot set, if the job is currently
        suspended mid-migration)."""
        if not self.open_loop:
            raise RuntimeError(f"{self.name} is not an open-loop job")
        if self.engine is None:
            self._pending.extend(arrivals)
            return
        from repro_torch.serving.engine import SlotSnapshot
        self.requests = self.requests if self.requests is not None else []
        for ev in arrivals:
            req = Request(uid=ev.uid, prompt=self._synth_prompt(ev),
                          max_new_tokens=ev.output_len)
            self._arrivals[ev.uid] = ev
            self.requests.append(req)
            if self._started:
                self.engine.submit([req])
            elif self._snapshots is not None:
                self._snapshots.append(
                    SlotSnapshot(request=req, rem=req.max_new_tokens))

    def _record_completion(self, ev, now: float | None) -> None:
        if ev is not None:
            self._done_uids.add(ev.uid)   # crash recovery must not replay
        if now is None or ev is None:
            return
        latency = now - ev.t
        self.request_latencies.append(latency)
        if self.slo is not None:
            self.slo.complete(ev.slo, latency, ev.output_len,
                              ev.deadline_s, now=now)

    # -- cross-job stream adoption ------------------------------------------
    @property
    def parked_streams(self) -> int:
        """Parked entries carrying live in-flight work another serve
        job could adopt (warm snapshots / occupied modeled lanes)."""
        if self.engine is not None:
            return sum(1 for s in self._parked if getattr(s, "warm", False))
        if self.open_loop:
            return sum(1 for s in self._parked if s.req is not None)
        return 0

    @property
    def free_stream_room(self) -> int:
        """Slots this job could hand to an adopted stream right now
        (free lanes beyond what its own queue is about to fill)."""
        if self.engine is not None:
            if not self._started:
                return 0
            hint = getattr(self.engine, "capacity_hint", None)
            if hint is not None:
                # paged engines bound room by block-pool headroom too —
                # sized for a typical adopted stream (half the row budget)
                room = hint(max(1, self.engine.max_seq // 2))
            else:
                room = self.engine.slot_limit - self.engine.active_slots
            return max(0, room - self.engine.queue_depth)
        if self.open_loop:
            idle = sum(1 for s in self._slots if s.req is None)
            return max(0, idle - len(self._pending))
        return 0

    def can_adopt_from(self, donor) -> bool:
        """Whether ``donor``'s parked streams may install here: same
        model config, same execution mode, and this job has a live
        stream to install into."""
        if donor is self or getattr(donor, "kind", None) != "serve":
            return False
        if (self.engine is None) != (donor.engine is None):
            return False
        if self.cfg != donor.cfg:
            return False
        if self.engine is not None:
            return self._started
        return self.open_loop and donor.open_loop

    def donate_to(self, other, max_streams: int | None = None):
        """Move up to ``max_streams`` parked in-flight streams into
        ``other``'s free slots (cross-job adoption): the stream resumes
        under the receiver instead of waiting for its origin job's
        regrow.  Donor lanes STAY parked (empty) — the donor's capacity
        shrinkage was the scheduler's decision and is not undone here.
        Returns ``(streams, tokens, bytes)`` moved."""
        room = other.free_stream_room
        n = room if max_streams is None else min(room, max_streams)
        moved = tokens = nbytes = 0
        if n <= 0:
            return moved, tokens, nbytes
        if self.engine is not None:
            for snap in [s for s in self._parked
                         if getattr(s, "warm", False)]:
                if moved >= n:
                    break
                if snap.kv_len + snap.rem > other.engine.max_seq:
                    continue
                self._parked.remove(snap)
                if snap.request in (self.requests or []):
                    self.requests.remove(snap.request)
                    self._delivered_seen -= len(snap.request.generated)
                other.requests = (other.requests
                                  if other.requests is not None else [])
                other.requests.append(snap.request)
                other.engine.restore([snap])
                other._delivered_seen += len(snap.request.generated)
                ev = self._arrivals.pop(snap.request.uid, None)
                if ev is not None:
                    other._arrivals[snap.request.uid] = ev
                moved += 1
                tokens += len(snap.request.generated)
                nbytes += snap.payload_bytes
        else:
            for s in [p for p in self._parked if p.req is not None]:
                if moved >= n:
                    break
                # the lane stays parked, just emptied of its stream
                self._parked[self._parked.index(s)] = _SimSlot()
                lane = next(l for l in other._slots if l.req is None)
                lane.req, lane.progress = s.req, s.progress
                lane.started = s.started
                moved += 1
                tokens += s.progress
                nbytes += self._slot_bytes(s.progress, s.req.prompt_len)
        return moved, tokens, nbytes

    def phase_tasks(self) -> list[Task]:
        if self._tasks is None or self._tasks_key != self._active_cap:
            from repro_torch.serving.engine import serve_phase_tasks
            self._tasks = serve_phase_tasks(
                self.cfg, batch=self._active_cap, prompt=self.prompt,
                new_tokens=self.decode_chunk, chips=self.chips)
            self._tasks_key = self._active_cap
        return self._tasks

    def step_phases(self) -> list[tuple[str, float]]:
        # decode runs every step; one prefill per request lifetime
        # (new_tokens / decode_chunk steps) amortizes across the stint
        prefill_weight = self.decode_chunk / max(self.new_tokens, 1)
        return [("prefill", prefill_weight), ("decode", 1.0)]

    def tokens_per_step(self) -> int:
        return self._active_cap * self.decode_chunk

    # -- modeled per-slot accounting (engine=None mode) ---------------------
    def _sim_remaining(self, s: _SimSlot) -> int:
        """Tokens a modeled lane still owes its current request (0 for
        an idle open-loop lane)."""
        if self.open_loop:
            return s.req.output_len - s.progress if s.req is not None else 0
        return self.new_tokens - s.progress

    def _in_flight_modeled(self) -> int:
        """Tokens generated for requests not yet complete — the state a
        drop destroys and a migration (or a parked slot) preserves."""
        return sum(s.progress for s in self._slots) \
            + sum(s.progress for s in self._parked)

    def _slot_bytes(self, progress: int,
                    prompt_len: int | None = None) -> int:
        """Analytic on-wire size of ONE stream's cache lane at its
        current depth (the engineless analogue of
        ``SlotSnapshot.payload_bytes``), int8-scaled when the job
        compresses snapshots.  Open-loop streams pass their own
        per-request prompt length; fixed workloads use the job-wide
        ``prompt``."""
        if progress <= 0:
            return 0
        plen = self.prompt if prompt_len is None else prompt_len
        from repro_torch.hw import flops as F
        raw = F._cache_bytes(self.cfg, 1, plen + progress)
        if self.snapshot_int8:
            from repro_torch.models.lm import int8_payload_ratio
            raw *= int8_payload_ratio(self.cfg)
        return int(raw)

    # -- execution ----------------------------------------------------------
    def advance(self, step_s: float, now: float | None = None) -> int:
        if self.engine is not None:
            if not self._started:
                limit = getattr(self.engine, "set_slot_limit", None)
                if limit is not None:
                    limit(min(self._active_cap, self.engine.batch_size))
                if self._snapshots is not None:
                    # lossless resume: drained snapshots re-admit, on
                    # whatever engine this job now fronts
                    self.engine.restore(self._snapshots)
                    self._snapshots = None
                else:
                    # fresh start, or drop-and-restart resume: only
                    # not-yet-finished requests go back in, partial
                    # output reset — it died with the discarded state
                    todo = [r for r in (self.requests or []) if not r.done]
                    for r in todo:
                        r.generated.clear()
                    self.engine.start(todo)
                self._started = True
                # baseline AFTER (re)start: restored requests carry their
                # preserved tokens in, cleared ones start over — either
                # way only tokens delivered from here on count as fresh
                self._delivered_seen = sum(
                    len(r.generated) for r in (self.requests or []))
            newly = self.engine.step()
            delivered = sum(len(r.generated) for r in (self.requests or []))
            fresh = delivered - self._delivered_seen
            self._delivered_seen = delivered
            self.emitted += fresh
            if self.open_loop:
                for r in newly:
                    self._record_completion(
                        self._arrivals.pop(r.uid, None), now)
            return fresh
        if self.open_loop:
            # modeled open-loop: idle lanes pull from the offered queue,
            # each stream owes its OWN output length, completions clock
            # latency from the request's arrival (queue wait included).
            # Lanes left idle emit nothing — but the step still burns
            # the full profile's energy in run_quantum, which is the
            # waste autoscaling exists to reclaim.
            fresh = 0
            for s in self._slots:
                if s.req is None:
                    if not self._pending:
                        continue
                    s.req = self._pending.popleft()
                    s.progress = 0
                    s.started = now - step_s if now is not None else None
                take = min(self.decode_chunk, s.req.output_len - s.progress)
                s.progress += take
                fresh += take
                if s.progress >= s.req.output_len:
                    self._record_completion(s.req, now)
                    s.req = None
                    s.progress = 0
                    s.started = None
            self.emitted += fresh
            return fresh
        # modeled: every active stream gains up to decode_chunk tokens,
        # completing (and restarting) independently; parked slots hold
        fresh = 0
        for s in self._slots:
            if self.emitted + fresh >= self.total_tokens:
                break
            if s.started is None and now is not None:
                s.started = now - step_s
            take = min(self.decode_chunk, self.new_tokens - s.progress,
                       self.total_tokens - self.emitted - fresh)
            s.progress += take
            fresh += take
            if s.progress >= self.new_tokens:
                if now is not None and s.started is not None:
                    self.request_latencies.append(now - s.started)
                s.progress = 0
                s.started = None
        self.emitted += fresh
        return fresh

    # -- preemption: whole, or proportional ---------------------------------
    def preempt(self, max_slots: int | None = None) -> float:
        """Cooperative preemption.  With ``max_slots=None`` the whole job
        suspends (parked slots rejoin the snapshot set and the job
        resumes at full capacity).  With ``max_slots=k`` — the minimal
        slot set the scheduler computed for the shrunk grant — only the
        surplus slots are shed into the locally parked set, the
        survivors keep serving, and NO backoff is due (the job never
        left its node); the shed cost is reported through
        ``last_shed_slots/tokens/bytes``."""
        if max_slots is not None:
            return self._shed_to(max_slots)
        self._suspend()
        self.dropped_total += self.last_preempt_dropped
        return self.supervisor.preempted()

    def hibernate(self) -> float:
        """Voluntary park (the autoscaler's idle consolidation): the
        same lossless whole-job drain as ``preempt()``, but with NO
        restart-budget charge and NO backoff — the job did nothing
        wrong, the fleet just has no traffic for it.  Returns 0.0."""
        self._suspend()
        self.dropped_total += self.last_preempt_dropped
        self.slot_target = None      # a resumed job renegotiates size
        return 0.0

    def _suspend(self) -> None:
        """Whole-job drain shared by ``preempt`` and ``hibernate``."""
        self.last_preempt_dropped = 0
        self.snapshot_tokens = self.snapshot_bytes = 0
        if self.engine is not None:
            if self._started:
                if self.migrate:
                    # parked lanes rejoin the drain: one snapshot set
                    # travels, and the job resumes at full capacity (the
                    # scheduler re-sheds under the new grant if needed).
                    # Preserved tokens are counted off the warm snapshots
                    # themselves so not-yet-re-admitted restores (the
                    # engine's restore queue) are included too.
                    self._snapshots = list(self._parked) \
                        + self.engine.drain()
                    self._parked = []
                    self._active_cap = self.batch
                    self.snapshot_tokens = sum(
                        len(s.request.generated) for s in self._snapshots
                        if s.warm)
                    self.snapshot_bytes = sum(
                        s.payload_bytes for s in self._snapshots)
                else:
                    # in-flight generation dies with the engine state; it
                    # was counted into ``emitted`` as it streamed, so give
                    # it back — the resumed stint regenerates it
                    self.last_preempt_dropped = self.engine.in_flight_tokens
                    self.emitted -= self.engine.in_flight_tokens
                self._started = False
            elif self._snapshots is not None:
                # preempted again before the resumed stint ever stepped
                # (e.g. the migration transfer ate the whole quantum):
                # the held snapshots are still the preserved state —
                # re-report them so kept-token/transfer accounting does
                # not silently record zero for work that survives
                self.snapshot_tokens = sum(
                    len(s.request.generated) for s in self._snapshots
                    if s.warm)
                self.snapshot_bytes = sum(
                    s.payload_bytes for s in self._snapshots)
        else:
            in_flight = self._in_flight_modeled()
            if self.migrate:
                self._slots = self._slots + self._parked
                self._parked = []
                self._active_cap = self.batch
                self.snapshot_tokens = in_flight
                self.snapshot_bytes = sum(
                    self._slot_bytes(
                        s.progress,
                        s.req.prompt_len if s.req is not None else None)
                    for s in self._slots)
            else:
                self.last_preempt_dropped = in_flight
                self.emitted -= in_flight
                for s in self._slots:
                    s.progress = 0
                    # the stream restarts from scratch on resume; its
                    # request's latency keeps counting from the original
                    # start (``started`` survives the drop)

    def _shed_to(self, max_slots: int) -> float:
        """Proportional shed: park slots until at most ``max_slots`` stay
        active (victims: fewest remaining tokens first).  Returns 0.0 —
        no backoff, the job keeps running where it is."""
        self.last_shed_slots = 0
        self.last_shed_tokens = self.last_shed_bytes = 0
        k = max(1, min(max_slots, self.batch))
        if k >= self._active_cap:
            return 0.0
        n_shed = self._active_cap - k
        if self.engine is not None:
            self.engine.set_slot_limit(min(k, self.engine.batch_size))
            victims = self.engine.select_victims(n_shed)
            snaps = self.engine.drain(slots=victims) if victims else []
            self._parked.extend(snaps)
            # report the lanes actually drained: the engine may hold
            # fewer occupied slots than the cap being shed
            self.last_shed_slots = len(snaps)
            self.last_shed_tokens = sum(
                len(s.request.generated) for s in snaps)
            self.last_shed_bytes = sum(s.payload_bytes for s in snaps)
        else:
            # fewest remaining tokens first (== most progress first for
            # the fixed workload; for open-loop lanes, idle lanes shed
            # first — they strand nothing — then nearly-done streams)
            order = sorted(range(len(self._slots)),
                           key=lambda i: (self._sim_remaining(
                               self._slots[i]), i))
            chosen = set(order[:n_shed])
            shed = [s for i, s in enumerate(self._slots) if i in chosen]
            self._slots = [s for i, s in enumerate(self._slots)
                           if i not in chosen]
            self._parked.extend(shed)
            self.last_shed_slots = len(shed)
            self.last_shed_tokens = sum(s.progress for s in shed)
            self.last_shed_bytes = sum(
                self._slot_bytes(
                    s.progress,
                    s.req.prompt_len if s.req is not None else None)
                for s in shed)
        self._active_cap = k
        return 0.0

    # -- shadow checkpointing & crash recovery -------------------------------
    def shadow_checkpoint(self, now: float) -> int:
        """Capture the job's CURRENT in-flight state as a shadow copy —
        non-destructively, while serving continues — so a node crash
        loses at most one checkpoint interval of decode.  Engine mode
        reuses ``ServeEngine.checkpoint`` (portable ``SlotSnapshot``s,
        int8-optional); modeled mode copies the per-lane accounting.
        Returns the payload bytes captured (what replicating the shadow
        off-node would move — the cluster charges that on the clock)."""
        if self.engine is not None:
            if not self._started:
                return 0
            snaps = self.engine.checkpoint()
            snaps += [dataclasses.replace(s, request=s.request.clone())
                      for s in self._parked]
            self._shadow = {"snaps": snaps}
            self.shadow_t = now
            return sum(s.payload_bytes for s in snaps)
        slots = [_SimSlot(s.progress, s.started, s.req)
                 for s in self._slots]
        parked = [_SimSlot(s.progress, s.started, s.req)
                  for s in self._parked]
        self._shadow = {"slots": slots, "parked": parked,
                        "pending": list(self._pending),
                        "emitted": self.emitted}
        self.shadow_t = now
        return sum(
            self._slot_bytes(s.progress,
                             s.req.prompt_len if s.req is not None else None)
            for s in slots + parked)

    def _live_events(self) -> list:
        """Open-loop arrival events currently owned by this job (in a
        lane, parked, or still pending)."""
        evs = [s.req for s in self._slots if s.req is not None]
        evs += [s.req for s in self._parked if s.req is not None]
        evs += list(self._pending)
        return evs

    def on_crash(self) -> float:
        """Uncooperative death: the node vanished mid-quantum, nothing
        was drained.  Un-checkpointed decode since the last shadow is
        LOST (refunded out of ``emitted`` — it must be redone); the
        shadow's streams are re-armed for bit-identical replay on
        whichever node adopts the job.  Without a shadow this is the
        full drop-and-restart.  Completions recorded since the shadow
        are never replayed (no double-counted SLO events).  Charges the
        supervisor as a crash — raises RuntimeError once the restart
        budget is exhausted (the scheduler then abandons the job)."""
        self.snapshot_tokens = self.snapshot_bytes = 0
        self.last_preempt_dropped = 0
        lost = replayed = 0
        if self.engine is not None:
            from repro_torch.serving.engine import SlotSnapshot
            if self._started:
                self.engine.abandon()
                self._started = False
            live = [r for r in (self.requests or []) if not r.done]
            done = [r for r in (self.requests or []) if r.done]
            shadow = (self._shadow or {}).get("snaps", [])
            if shadow:
                live_uids = {r.uid for r in live}
                snaps, ckpt_len = [], {}
                for s in shadow:
                    if s.request.uid not in live_uids:
                        continue   # finished since the shadow: stays done
                    ckpt_len[s.request.uid] = len(s.request.generated)
                    # re-clone: a SECOND crash replays the same shadow
                    snaps.append(dataclasses.replace(
                        s, request=s.request.clone()))
                covered = {s.request.uid for s in snaps}
                for r in live:
                    if r.uid not in covered:   # arrived after the shadow
                        snaps.append(SlotSnapshot(
                            request=Request(r.uid, list(r.prompt),
                                            r.max_new_tokens),
                            rem=r.max_new_tokens))
                lost = sum(len(r.generated) - ckpt_len.get(r.uid, 0)
                           for r in live)
                replayed = sum(len(s.request.generated)
                               for s in snaps if s.warm)
                self._snapshots = snaps
                self.requests = done + [s.request for s in snaps]
                self.snapshot_tokens = replayed
                self.snapshot_bytes = sum(s.payload_bytes for s in snaps)
            else:
                lost = sum(len(r.generated) for r in live)
                for r in live:
                    r.generated.clear()
                self._snapshots = None
        elif self.open_loop:
            in_flight = self._in_flight_modeled()
            if self._shadow is not None:
                def revive(lane: _SimSlot) -> _SimSlot:
                    if lane.req is not None \
                            and lane.req.uid in self._done_uids:
                        return _SimSlot()   # completed since the shadow
                    return _SimSlot(lane.progress, lane.started, lane.req)
                slots = [revive(s) for s in self._shadow["slots"]]
                slots += [revive(s) for s in self._shadow["parked"]]
                pending = deque(ev for ev in self._shadow["pending"]
                                if ev.uid not in self._done_uids)
                covered = {s.req.uid for s in slots
                           if s.req is not None}
                covered |= {ev.uid for ev in pending}
                extras = [ev for ev in self._live_events()
                          if ev.uid not in covered]
                extras.sort(key=lambda ev: (ev.t, ev.uid))
                pending.extend(extras)
                replayed = sum(s.progress for s in slots)
                lost = in_flight - replayed
                self._slots = slots
                self._pending = pending
                self.snapshot_tokens = replayed
                self.snapshot_bytes = sum(
                    self._slot_bytes(
                        s.progress,
                        s.req.prompt_len if s.req is not None else None)
                    for s in slots)
            else:
                lost = in_flight
                evs = sorted(self._live_events(),
                             key=lambda ev: (ev.t, ev.uid))
                self._pending = deque(evs)
                self._slots = [_SimSlot() for _ in range(self.batch)]
        else:
            in_flight = self._in_flight_modeled()
            if self._shadow is not None:
                self._slots = [
                    _SimSlot(s.progress, s.started, s.req)
                    for s in self._shadow["slots"] + self._shadow["parked"]]
                lost = max(0, self.emitted - self._shadow["emitted"])
                replayed = sum(s.progress for s in self._slots)
                self.snapshot_tokens = replayed
                self.snapshot_bytes = sum(
                    self._slot_bytes(s.progress) for s in self._slots)
            else:
                lost = in_flight
                self._slots = self._slots + self._parked
                for s in self._slots:
                    s.progress = 0
        self._parked = []
        self._active_cap = self.batch
        self.emitted -= lost
        self.dropped_total += lost
        self.last_crash_lost = lost
        self.last_crash_replayed = replayed
        return self.supervisor.crashed("node crash")

    def grow(self, max_slots: int) -> int:
        """Raise the active-slot cap back toward ``capacity`` and
        re-admit parked lanes (oldest first); returns the slots
        unparked.  The inverse of ``preempt(max_slots=...)``, driven by
        the scheduler as the budget recovers."""
        k = min(max_slots, self.batch)
        if k <= self._active_cap:
            return 0
        n = min(len(self._parked), k - self._active_cap)
        unparked, self._parked = self._parked[:n], self._parked[n:]
        self._active_cap = k
        if self.engine is not None:
            self.engine.set_slot_limit(min(k, self.engine.batch_size))
            if unparked and self._started:
                self.engine.restore(unparked)
            elif unparked:
                # between stints: rejoin the snapshot set for the resume
                self._snapshots = (self._snapshots or []) + unparked
        else:
            self._slots.extend(unparked)
        return n


@dataclasses.dataclass
class _Paused:
    job: Job
    eligible_at: float
    origin: str = ""     # node the job was preempted from — resuming
                         # elsewhere moves its snapshot (migration)


class FleetScheduler:
    """FCFS placement of a job queue under the facility power envelope.

    ``min_node_w`` is the watts a node must be guaranteed before placing
    work on it: its physical floor (idle draw can't be capped away) plus a
    useful-work margin.  ``margin_w`` names the margin part of that sum;
    for a partial-capable serve job the margin scales with its ACTIVE
    slots (``min_node_w - margin_w + margin_w * active/capacity``) — the
    mechanism that makes preemption proportional: shedding a slot gives
    back ``margin_w / capacity`` watts without surrendering the node.

    ``tick`` reconciles the fleet each control quantum: shed slots /
    preempt while the envelope is over-subscribed, resume eligible
    preempted jobs (snapshot carriers with placement affinity), regrow
    partially shed jobs into recovered headroom, admit fresh work."""

    def __init__(self, jobs, min_node_w: float, margin_w: float = 0.0,
                 watchdog_deadline_s: float | None = None,
                 slot_w_fn=None):
        self.queue: deque[Job] = deque(jobs)
        self.min_node_w = min_node_w
        self.margin_w = margin_w
        #: optional fitted per-slot watt cost, ``fn(node_name) -> float |
        #: None`` (the ``CurveBank.slot_watt`` fit in pareto mode): when
        #: it returns a confident positive cost, shed sizing and partial
        #: margins use the OBSERVED watts a slot gives back instead of
        #: the static ``margin_w / capacity`` share — exact drains.
        #: None (the default) preserves the historical heuristic
        #: bit-for-bit.
        self.slot_w_fn = slot_w_fn
        self.paused: list[_Paused] = []
        self.completed: list[Job] = []
        #: declare a busy node dead after this many virtual seconds
        #: without a heartbeat (``FleetNode.last_beat``); None disables
        #: the watchdog — the no-recovery baseline, where a crashed
        #: node's job hangs forever
        self.watchdog_deadline_s = watchdog_deadline_s
        self.failed: list[Job] = []   # jobs abandoned: restart budget spent

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or bool(self.paused)

    def _fitted_slot_w(self, node) -> "float | None":
        """The learned per-slot watt cost for ``node`` (clamped into
        (0, margin_w]), or None while no confident fit exists — callers
        fall back to the static ``margin_w / capacity`` share, keeping
        the default path bit-identical."""
        if self.slot_w_fn is None or self.margin_w <= 0:
            return None
        w = self.slot_w_fn(getattr(node, "name", ""))
        if w is None or w <= 0:
            return None
        return min(w, self.margin_w)

    def node_min_w(self, node) -> float:
        """Watts this busy node needs under the envelope: the full
        floor+margin, except that a partial-capable serve job only needs
        margin for the slots it actually decodes — priced at the FITTED
        per-slot cost when the curve bank has one, the static share
        otherwise."""
        job = getattr(node, "job", None)
        if (job is not None and self.margin_w > 0
                and getattr(job, "partial_capable", False)):
            cap = max(getattr(job, "capacity", 1), 1)
            k = getattr(job, "active_cap", cap)
            fitted = self._fitted_slot_w(node)
            if fitted is not None:
                return self.min_node_w - self.margin_w \
                    + min(self.margin_w, fitted * k)
            return self.min_node_w - self.margin_w \
                + self.margin_w * k / cap
        return self.min_node_w

    def _busy_need(self, cluster) -> float:
        return sum(self.node_min_w(n) for n in cluster.busy_nodes())

    def complete(self, job: Job) -> None:
        job.supervisor.completed("done")
        self.completed.append(job)

    def park(self, node, t: float, rest_s: float = 0.0) -> Job:
        """Voluntarily hibernate ``node``'s job (the autoscaler's idle
        consolidation): a lossless drain with no restart-budget charge,
        releasing the node so the cluster can power-gate it.  The job
        joins the paused set and resumes through the ordinary
        origin-affine path once eligible (``t + rest_s`` — the rest
        keeps an idle job from bouncing straight back onto a free
        node) and traffic warrants."""
        job = node.release()
        job.hibernate()
        self.paused.append(_Paused(job, eligible_at=t + rest_s,
                                   origin=node.name))
        return job

    def expedite(self, t: float) -> None:
        """Make every paused job eligible to resume at ``t`` — the
        autoscaler's scale-up override of hibernation rest (a restart
        backoff that has not yet elapsed is also waived: queue pressure
        outranks politeness)."""
        for p in self.paused:
            if p.eligible_at > t:
                p.eligible_at = t

    @staticmethod
    def _place(cluster, free, origin: str, snap_bytes: int):
        """Placement affinity: a snapshot carrier prefers its ORIGIN node
        (no transfer at all), else the free node behind the cheapest
        interconnect link from the origin (ties by name); jobs without a
        snapshot take the first free node as before."""
        if not snap_bytes or not origin:
            return free[0]
        for n in free:
            if n.name == origin:
                return n
        cost = getattr(cluster, "transfer_seconds", None)
        if cost is None:
            return free[0]
        return min(free, key=lambda n: (cost(origin, n.name, snap_bytes),
                                        n.name))

    def tick(self, t: float, cluster, budget_w: float) -> dict:
        """One scheduling round; returns ``{"admitted": [...],
        "preempted": [...], "migrations": [...], "partials": [...],
        "unparked": [...], "dropped_tokens": N, "kept_tokens": N}``
        (job names / event records, deterministic order)."""
        admitted, preempted, migrations = [], [], []
        partials, unparked = [], []
        dropped_tokens = kept_tokens = 0

        # 0. watchdog: a busy node that has missed quanta past the
        #    deadline is declared dead — its job is fenced off the node
        #    and re-queued through the supervisor's CRASH budget (shadow
        #    checkpoints bound what the crash cost; a job whose budget
        #    is spent is abandoned).  The node itself stays unassignable
        #    until repaired.  A HUNG node trips the same verdict — the
        #    watchdog cannot tell a hang from a crash, by design — and
        #    its job simply resumes elsewhere from its last shadow.
        dead = []
        if self.watchdog_deadline_s is not None:
            for node in sorted(cluster.busy_nodes(), key=lambda n: n.name):
                beat = getattr(node, "last_beat", None)
                if beat is None or t - beat <= self.watchdog_deadline_s:
                    continue
                job = node.release()
                rec = {"node": node.name, "job": job.name,
                       "replayed": 0, "lost": 0}
                on_crash = getattr(job, "on_crash", None)
                try:
                    backoff = on_crash() if on_crash is not None \
                        else job.preempt()
                    rec["replayed"] = getattr(job, "last_crash_replayed", 0)
                    rec["lost"] = getattr(job, "last_crash_lost", 0)
                    # origin stays the dead node: the shadow replica
                    # lives in its cabinet, so the adopting node pays
                    # the transfer priced from there (value-first resume
                    # via the ordinary step-2 path)
                    self.paused.append(_Paused(job, eligible_at=t + backoff,
                                               origin=node.name))
                except RuntimeError:
                    rec["abandoned"] = True
                    rec["lost"] = getattr(job, "last_crash_lost", 0)
                    self.failed.append(job)
                dead.append(rec)

        # 1. shed while the shrunken envelope can't float the busy set:
        #    lowest token-value first (a background train token is shed
        #    before a paid serve token), train before serve at equal
        #    value (they checkpoint), LIFO each.  A partial-capable
        #    victim sheds the MINIMAL slot set that fits the shortfall
        #    (ceil(deficit / margin-per-slot)) and keeps serving; only
        #    when it is down to one slot — or cannot shed — is it
        #    suspended whole.
        busy = cluster.busy_nodes()
        need = self._busy_need(cluster)
        while busy and need > budget_w + 1e-9:
            victims = sorted(
                busy, key=lambda n: (n.job.value,
                                     n.job.kind != "train", -n.assigned_at,
                                     n.name))
            node = victims[0]
            job = node.job
            k_shed = 0
            if (self.margin_w > 0
                    and getattr(job, "partial_capable", False)
                    and getattr(job, "active_cap", 1) > 1):
                fitted = self._fitted_slot_w(node)
                if fitted is not None:
                    per_slot = fitted
                else:
                    per_slot = self.margin_w / max(job.capacity, 1)
                k_shed = int(math.ceil((need - budget_w) / per_slot))
            if 0 < k_shed <= job.active_cap - 1:
                # the shortfall fits inside this victim's batch: shed the
                # minimal slot set and keep it serving.  A deeper deficit
                # (e.g. a dip below the node floor, which no shed can
                # return) suspends the victim whole instead.
                job.preempt(max_slots=job.active_cap - k_shed)
                if hasattr(node, "refit"):
                    node.refit()    # the power session re-fits the
                                    # shrunken batch's task profile
                partials.append({
                    "job": job.name, "node": node.name,
                    "slots": job.last_shed_slots,
                    "tokens": job.last_shed_tokens,
                    "bytes": job.last_shed_bytes})
                need = self._busy_need(cluster)
                continue
            node.release()
            backoff = job.preempt()
            dropped_tokens += getattr(job, "last_preempt_dropped", 0)
            kept_tokens += getattr(job, "snapshot_tokens", 0)
            self.paused.append(_Paused(job, eligible_at=t + backoff,
                                       origin=node.name))
            preempted.append(job.name)
            busy = cluster.busy_nodes()
            need = self._busy_need(cluster)

        # 2. resume eligible paused jobs ahead of fresh queue work —
        #    highest token-value first (the mirror of the preemption
        #    order: the most valuable work reclaims watts first), then
        #    oldest eligibility, then name, for determinism.  Placement
        #    is origin-affine: a snapshot carrier resumes on its origin
        #    node when free (no transfer), else on the free node behind
        #    the cheapest link — and only a cross-node landing pays the
        #    migration transfer on that node's clock.
        # ``value`` is a formal Job-protocol field (TrainJob/ServeJob
        # both carry it), so the ordering reads it directly
        self.paused.sort(key=lambda p: (-p.job.value,
                                        p.eligible_at, p.job.name))
        for p in list(self.paused):
            if p.eligible_at > t:
                continue
            free = cluster.free_nodes()
            if not free or need + self.min_node_w > budget_w + 1e-9:
                break
            snap_bytes = getattr(p.job, "snapshot_bytes", 0)
            node = self._place(cluster, free, p.origin, snap_bytes)
            self.paused.remove(p)
            node.assign(p.job, t)
            admitted.append(p.job.name)
            need += self.node_min_w(node)
            if snap_bytes and node.name != p.origin:
                if hasattr(cluster, "transfer_seconds"):
                    mig_s = cluster.transfer_seconds(p.origin, node.name,
                                                     snap_bytes)
                elif hasattr(cluster, "migration_seconds"):
                    mig_s = cluster.migration_seconds(snap_bytes)
                else:
                    mig_s = 0.0
                node.local_t += mig_s    # the transfer occupies the node
                migrations.append({
                    "job": p.job.name, "from": p.origin, "to": node.name,
                    "tokens": getattr(p.job, "snapshot_tokens", 0),
                    "bytes": snap_bytes, "seconds": mig_s})
            if hasattr(p.job, "snapshot_bytes"):
                p.job.snapshot_bytes = 0
                p.job.snapshot_tokens = 0

        # 2b. regrow partially shed jobs into recovered headroom: parked
        #     slots are paid-for in-flight work and re-admit at
        #     margin_w/capacity watts each — the proportional inverse of
        #     step 1 (an all-or-nothing resume would wait for a whole
        #     node's worth of headroom instead).
        if self.margin_w > 0:
            for node in sorted(cluster.busy_nodes(), key=lambda n: n.name):
                job = node.job
                if not getattr(job, "partial_capable", False):
                    continue
                cap = max(getattr(job, "capacity", 1), 1)
                k = getattr(job, "active_cap", cap)
                # the autoscaler's slot_target caps the regrow: a job
                # the workload shrank on purpose must not bounce back
                # to full capacity just because watts are available
                goal = getattr(job, "slot_target", None)
                goal = cap if goal is None else max(1, min(goal, cap))
                if k >= goal:
                    continue
                fitted = self._fitted_slot_w(node)
                per_slot = fitted if fitted is not None \
                    else self.margin_w / cap
                k_more = min(goal - k,
                             int((budget_w - need) / per_slot + 1e-9))
                if k_more <= 0:
                    continue
                restored = job.grow(k + k_more)
                if hasattr(node, "refit"):
                    node.refit()
                need += k_more * per_slot
                # "slots" = lanes actually re-admitted (what telemetry
                # counts); the cap may grow further than the parked list
                unparked.append({"job": job.name, "node": node.name,
                                 "slots": restored, "cap": k + k_more})

        # 2c. cross-job stream adoption: a parked in-flight stream need
        #     not wait for its origin job's regrow — any OTHER serve job
        #     fronting the same model config with free slot room takes
        #     it over (cheapest interconnect link first), paying the
        #     snapshot transfer on the receiving node's clock.  No watt
        #     accounting changes: both jobs keep their negotiated caps.
        adoptions = []
        cost = getattr(cluster, "transfer_seconds", None)
        busy_sorted = sorted(cluster.busy_nodes(), key=lambda n: n.name)
        for dn in busy_sorted:
            donor = dn.job
            if getattr(donor, "parked_streams", 0) <= 0:
                continue
            receivers = sorted(
                (rn for rn in busy_sorted
                 if rn is not dn
                 and getattr(rn.job, "can_adopt_from", None) is not None
                 and rn.job.can_adopt_from(donor)
                 and rn.job.free_stream_room > 0),
                key=lambda rn: ((cost(dn.name, rn.name, 1)
                                 if cost is not None else 0.0), rn.name))
            for rn in receivers:
                moved, tokens, nbytes = donor.donate_to(rn.job)
                if moved:
                    secs = (cost(dn.name, rn.name, nbytes)
                            if cost is not None else 0.0)
                    rn.local_t += secs    # the transfer occupies the
                    adoptions.append({    # receiving node
                        "job": donor.name, "to": rn.job.name,
                        "from_node": dn.name, "to_node": rn.name,
                        "slots": moved, "tokens": tokens,
                        "bytes": nbytes, "seconds": secs})
                if getattr(donor, "parked_streams", 0) <= 0:
                    break

        # 3. admit fresh jobs FCFS while nodes and watts allow
        while self.queue:
            free = cluster.free_nodes()
            if not free or need + self.min_node_w > budget_w + 1e-9:
                break
            job = self.queue.popleft()
            free[0].assign(job, t)
            need += self.node_min_w(free[0])
            admitted.append(job.name)

        return {"admitted": admitted, "preempted": preempted,
                "migrations": migrations, "partials": partials,
                "unparked": unparked, "adoptions": adoptions,
                "dead": dead,
                "dropped_tokens": dropped_tokens,
                "kept_tokens": kept_tokens}
