"""Slot scheduler for the continuous-batching serving runtime.

Host-side bookkeeping only — no device state lives here.  The engine owns
one fixed-size batch of ``n_slots`` device-resident cache slots; this
module decides which request occupies which slot and when:

  * admission at ANY step regardless of prompt length (no equal-length
    bucketing — each slot prefills at its own offset into its own rows),
  * immediate slot recycling the moment a request finishes (the engine
    observes completions once per decode chunk), and
  * FCFS queueing beyond the slot count.

``chunk_plan`` decomposes a prompt length into power-of-two prefill
chunks (largest-first), so any mix of prompt lengths compiles at most
``log2(max_chunk) + 1`` distinct prefill programs — killing the
per-prompt-length retrace of the bucketed engine.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from collections.abc import Iterator


@dataclasses.dataclass
class Request:
    uid: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    #: Length of the request's SHARABLE leading prompt span (a system
    #: prompt / template header).  0 = no sharable prefix.  A paged engine
    #: with prefix sharing registers these rows after prefill and later
    #: admissions whose prompts start with the same tokens map the cached
    #: blocks instead of re-prefilling them.
    prefix_len: int = 0

    @property
    def done(self) -> bool:
        return len(self.generated) >= self.max_new_tokens

    def clone(self) -> "Request":
        """Deep-enough copy for checkpointing: token lists are owned by
        the clone, so later decode on the live request cannot mutate a
        shadow snapshot taken earlier."""
        return Request(self.uid, list(self.prompt), self.max_new_tokens,
                       list(self.generated), self.prefix_len)


@dataclasses.dataclass
class Slot:
    """One running-batch lane: its request (None = free) and progress."""

    sid: int
    request: Request | None = None
    emitted: int = 0          # tokens delivered to the request so far

    @property
    def free(self) -> bool:
        return self.request is None


def chunk_plan(length: int, max_chunk: int) -> list[int]:
    """Power-of-two chunk decomposition of ``length``, largest-first
    (e.g. 13 with max_chunk=8 -> [8, 4, 1]).  Every chunk size is drawn
    from {max_chunk, max_chunk/2, ..., 1}, so the number of distinct
    prefill traces is bounded by the set size, not by how many distinct
    prompt lengths the traffic contains."""
    if length <= 0:
        raise ValueError(f"cannot chunk a length-{length} prompt")
    if max_chunk < 1 or max_chunk & (max_chunk - 1):
        raise ValueError(f"max_chunk must be a power of two, got {max_chunk}")
    plan, c, rem = [], max_chunk, length
    while rem:
        while c > rem:
            c //= 2
        plan.append(c)
        rem -= c
    return plan


def fewest_remaining(slots: list[Slot]) -> list[Slot]:
    """Default drain-victim policy: order active slots by fewest tokens
    still owed (``max_new_tokens`` minus tokens delivered), ties by slot
    id.  A nearly-done victim parks the least future work behind the
    pause, and its resume stint converts into a completion (a freed slot)
    fastest — so a proportional preemption strands the minimum owed
    tokens for the slots it sheds."""
    return sorted(slots,
                  key=lambda s: (s.request.max_new_tokens - s.emitted,
                                 s.sid))


class SlotScheduler:
    """Maps queued requests onto a fixed set of batch slots, FCFS.

    ``limit`` caps how many slots may be OCCUPIED at once (default: all
    of them).  A proportional preemption lowers the limit so drained
    lanes stay empty instead of instantly refilling from the queue —
    the engine sheds exactly the capacity the caller asked it to shed."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.slots = [Slot(i) for i in range(n_slots)]
        self.queue: deque[Request] = deque()
        self.limit = n_slots

    def set_limit(self, limit: int) -> None:
        if not 1 <= limit <= len(self.slots):
            raise ValueError(
                f"slot limit must be in [1, {len(self.slots)}], got {limit}")
        self.limit = limit

    # -- queue -------------------------------------------------------------
    def submit(self, requests) -> None:
        self.queue.extend(requests)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(not s.free for s in self.slots)

    # -- slots -------------------------------------------------------------
    def active(self) -> list[Slot]:
        return [s for s in self.slots if not s.free]

    def admit_ready(self, can_admit=None) -> Iterator[Slot]:
        """Fill free slots from the queue (FCFS) up to ``limit``, yielding
        each slot as it is admitted.  Callable at any step — admission
        never waits for the rest of the batch.

        ``can_admit(request) -> bool`` gates each admission on an external
        resource (the paged engine's block-pool headroom).  Admission
        stops at the FIRST refused request — skipping past it would break
        FCFS ordering and starve large requests behind small ones.

        Unlike the reference, which returns the round's list, this yields:
        the caller takes each admission's resources before the next gate
        check, so the gate sees them.  (The reference checks the whole
        round first, and its paged engine then raises "block pool
        exhausted" when one round's demand exceeds the pool.)"""
        n_active = len(self.active())
        for slot in self.slots:
            if not self.queue or n_active >= self.limit:
                return
            if not slot.free:
                continue
            if can_admit is not None and not can_admit(self.queue[0]):
                return
            slot.request = self.queue.popleft()
            slot.emitted = 0
            n_active += 1
            yield slot

    def occupy(self, request: Request) -> Slot | None:
        """Place ``request`` directly into a free slot, bypassing the
        FCFS queue — the restored-snapshot admission path, where the
        request arrives mid-generation and its slot state is installed
        by the engine instead of prefilled.  ``emitted`` resumes at the
        tokens already delivered.  Returns None when no slot is free
        (or the occupancy ``limit`` is reached)."""
        if len(self.active()) >= self.limit:
            return None
        for slot in self.slots:
            if slot.free:
                slot.request = request
                slot.emitted = len(request.generated)
                return slot
        return None

    def release(self, slot: Slot) -> Request:
        """Finish a slot's request and free the slot for recycling."""
        req, slot.request, slot.emitted = slot.request, None, 0
        if req is None:
            raise ValueError(f"slot {slot.sid} is already free")
        return req


class BlockAllocator:
    """Refcounted fixed-size block arena for the paged KV cache.

    Host-side mirror of the device pool: hands out pool block ids from a
    LIFO free list, counts references (a block shared by N slots + the
    prefix registry carries refcount N+1), and frees a block only when
    its last reference drops.  ``ensure_private`` is the copy-on-write
    pivot: before a slot's first WRITE into a shared block, the engine
    swaps the shared block for a fresh private one (and copies the rows
    on device).  Fully deterministic — same call sequence, same ids."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 1 or block_size < 1:
            raise ValueError(f"need >= 1 blocks of >= 1 rows, got "
                             f"{n_blocks} x {block_size}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        # LIFO: pop() yields 0, 1, 2, ... on a fresh arena
        self._free = list(range(n_blocks - 1, -1, -1))
        self._ref = [0] * n_blocks

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return self.n_blocks - len(self._free)

    def blocks_for(self, rows: int) -> int:
        """Blocks needed to hold ``rows`` sequence rows (ceil)."""
        return -(-max(rows, 0) // self.block_size)

    def refcount(self, block: int) -> int:
        return self._ref[block]

    def state(self) -> tuple:
        """Hashable full allocator state (determinism assertions)."""
        return tuple(self._free), tuple(self._ref)

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` blocks (refcount 1 each).  Raises when the pool
        cannot cover the request — callers gate admission on
        ``free_blocks`` first."""
        if n < 0:
            raise ValueError(f"cannot alloc {n} blocks")
        if n > len(self._free):
            raise RuntimeError(f"block pool exhausted: need {n}, "
                               f"have {len(self._free)} free")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._ref[b] = 1
        return out

    def share(self, blocks) -> None:
        """Add one reference to each of ``blocks`` (they must be live)."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise RuntimeError(f"cannot share free block {b}")
        for b in blocks:
            self._ref[b] += 1

    def release(self, blocks) -> None:
        """Drop one reference from each of ``blocks``; a block returns to
        the free list when its last reference drops.  Releasing an
        already-free block raises — the no-double-free invariant."""
        for b in blocks:
            if self._ref[b] <= 0:
                raise RuntimeError(f"double free of block {b}")
        for b in blocks:
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free.append(b)

    def ensure_private(self, block: int) -> tuple[int, bool]:
        """Copy-on-write pivot: return a block this caller may WRITE.

        A block with refcount 1 is already private — returned as-is.  A
        shared block is swapped for a fresh private one: the caller's
        reference moves to the new block (the shared block keeps its
        other holders) and the caller must copy the rows on device.
        Returns ``(block_id, copied)``."""
        if self._ref[block] <= 0:
            raise RuntimeError(f"cannot write free block {block}")
        if self._ref[block] == 1:
            return block, False
        [new] = self.alloc(1)
        self._ref[block] -= 1          # was >= 2, cannot hit the free list
        return new, True


class PrefixRegistry:
    """Token-hash index over registered prompt prefixes -> pool blocks.

    The registry holds its OWN allocator reference on every registered
    block, so a cached prefix survives the slot that created it.  Entries
    are collision-safe (the exact token tuple is stored and compared, the
    hash only buckets) and LRU-ordered: ``evict_for`` drops the
    least-recently-hit prefixes until the allocator can cover a demand.
    Deterministic: dict insertion order is the LRU order."""

    def __init__(self, alloc: BlockAllocator):
        self._alloc = alloc
        # (rows, hash) -> (token tuple, block ids); insertion order = LRU
        self._entries: dict[tuple, tuple] = {}
        self.hits = 0
        self.misses = 0

    def __len__(self) -> int:
        return len(self._entries)

    def register(self, tokens, rows: int, blocks) -> bool:
        """Cache ``tokens[:rows]`` as living in ``blocks`` (logical
        order, covering rows [0, rows)).  Returns False when an identical
        prefix is already registered (no reference taken)."""
        if rows < 1 or rows > len(tokens):
            raise ValueError(f"rows {rows} outside [1, {len(tokens)}]")
        need = self._alloc.blocks_for(rows)
        if len(blocks) < need:
            raise ValueError(f"{rows} rows span {need} blocks, "
                             f"got {len(blocks)}")
        head = tuple(tokens[:rows])
        key = (rows, hash(head))
        if key in self._entries and self._entries[key][0] == head:
            return False
        self._alloc.share(blocks[:need])
        self._entries[key] = (head, list(blocks[:need]))
        return True

    def lookup(self, tokens, max_rows: int, peek: bool = False):
        """Longest registered prefix of ``tokens`` spanning <= max_rows
        rows.  Returns (rows, blocks) — (0, []) on a miss — and marks
        the hit entry most-recently-used.  The caller must ``share`` the
        blocks (via the allocator) before mapping them into a slot.
        ``peek=True`` is a side-effect-free probe (no LRU touch, no
        hit/miss accounting) — the admission gate's capacity estimate."""
        best_key = None
        for key, (head, _) in self._entries.items():
            rows = key[0]
            if rows > max_rows or (best_key and rows <= best_key[0]):
                continue
            if tuple(tokens[:rows]) == head:
                best_key = key
        if best_key is None:
            if not peek:
                self.misses += 1
            return 0, []
        if peek:
            return best_key[0], list(self._entries[best_key][1])
        self.hits += 1
        head, blocks = self._entries.pop(best_key)
        self._entries[best_key] = (head, blocks)      # re-insert as MRU
        return best_key[0], list(blocks)

    def evict_for(self, n_blocks: int) -> bool:
        """Drop LRU prefixes until the allocator has ``n_blocks`` free
        (a dropped block only returns to the pool once the slots still
        reading it release their own references).  Returns whether the
        demand is now coverable."""
        while self._alloc.free_blocks < n_blocks and self._entries:
            key = next(iter(self._entries))
            _, blocks = self._entries.pop(key)
            self._alloc.release(blocks)
        return self._alloc.free_blocks >= n_blocks
