"""Host-side block allocator for the paged KV cache (vLLM-style).

The device cache is a pool of fixed-size blocks ``(n_blocks, block_size, K,
dh)`` per layer; each request owns an ordered list of physical block ids (its
*block table*) mapping logical token positions to cache rows:

    phys_row(p) = table[p // block_size] * block_size + p % block_size

Physical block 0 is reserved as the NULL/trash block: unallocated table
entries point at it, and device scatters of never-attended rows (prompt pad
rows, idle-lane draft slots) land there harmlessly.  The allocator therefore
hands out ids from ``[1, n_blocks)`` only.

Admission is *reservation-based* so serving stays preemption-free: a request
reserves its worst-case block demand up front (``can_admit``/``alloc``) but
takes physical blocks incrementally (``alloc`` then ``extend`` as the
sequence grows).  Because every physical block is interchangeable, the
reservation invariant

    sum(reserved demand over live requests) <= capacity

guarantees that ``extend`` can never fail mid-flight — a request admitted is
a request that finishes.  Requests whose demand cannot currently be reserved
wait in the scheduler queue (backpressure); since live requests retire in
finite time and ``free`` returns both blocks and reservation, the queue
always drains (no deadlock) as long as any single request's demand fits the
pool — which ``alloc`` enforces up front.

Fragmentation in this design is purely *internal* (a request's last block is
partially used); ``frag_rows``/``frag_rows_total`` account for it.

Prefix sharing adds per-block refcounts on top: a block may be owned
by several requests at once (same logical prefix positions in each table) and
by the radix prefix cache (``cache_ref``/``cache_unref``).  ``free`` then
returns only the blocks whose refcount actually dropped to zero — those are
the only ones the caller may scrub or that re-enter the free list.  Blocks
held *only* by the prefix cache (``n_cache_only``) are not reservable, so the
reservation invariant becomes

    sum(reserved demand) + n_cache_only <= capacity

Reservations deliberately over-count shared blocks (every sharer counts them
in full), which keeps the no-starvation guarantee conservative.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence

NULL_BLOCK = 0


def demand_blocks(prompt_len: int, max_new: int, width: int,
                  max_seq_len: int, block_size: int) -> int:
    """Worst-case block demand of one request: cache rows for its prompt
    plus its full token budget plus one tree width of draft slots, capped
    at max_seq_len (the scheduler's overflow-retirement bound).  This is
    THE admission/reservation formula — pool-sizing callers must use it so
    sizing and admission can never drift apart."""
    need = min(prompt_len + max_new + width, max_seq_len)
    return -(-max(int(need), 1) // block_size)


def worst_case_pool_blocks(lanes: int, prompt_len: int, max_new: int,
                           width: int, max_seq_len: int,
                           block_size: int) -> int:
    """Pool size letting ``lanes`` worst-case requests run concurrently,
    plus the reserved NULL block."""
    return 1 + lanes * demand_blocks(prompt_len, max_new, width,
                                     max_seq_len, block_size)


class BlockAllocator:
    """Free-list allocator over ``n_blocks`` KV-cache blocks of
    ``block_size`` token rows each (block 0 reserved as NULL)."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks < 2:
            raise ValueError(f"n_blocks={n_blocks}: need >= 2 (block 0 is "
                             "the reserved NULL block)")
        if block_size < 1:
            raise ValueError(f"block_size={block_size}")
        self.n_blocks = int(n_blocks)
        self.block_size = int(block_size)
        # LIFO free list: freshly freed blocks are re-used first, which keeps
        # the working set hot and makes free-then-alloc reuse easy to test.
        self._free: List[int] = list(range(self.n_blocks - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}
        self._reserved: Dict[int, int] = {}
        # Per-block owner count.  Owners are (a) each request whose table
        # contains the block and (b) the prefix cache (at most once per
        # block, tracked in _cache_held).  Absent key == free (refcount 0).
        self._ref: Dict[int, int] = {}
        self._cache_held: set = set()
        # Optional event sink (the runtime sanitizer's shadow ledger).
        # Pure observation: the allocator behaves identically with or
        # without one attached.
        self.observer = None

    def _emit(self, event: str, **kw) -> None:
        if self.observer is not None:
            self.observer.on_event(event, **kw)

    # ------------------------------------------------------------------ state
    @property
    def capacity(self) -> int:
        """Usable blocks (total minus the NULL block)."""
        return self.n_blocks - 1

    @property
    def n_free(self) -> int:
        """Physically free blocks right now."""
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return self.capacity - len(self._free)

    @property
    def n_reserved(self) -> int:
        """Blocks promised to live requests (>= n_allocated)."""
        return sum(self._reserved.values())

    @property
    def n_cache_only(self) -> int:
        """Blocks held *only* by the prefix cache (in no live table).  These
        occupy pool space without backing any reservation, so they reduce
        what new admissions may reserve; they become reservable again the
        moment the cache evicts them (or a live request shares them, at
        which point the sharer's reservation covers them)."""
        return sum(1 for b in self._cache_held if self._ref.get(b, 0) == 1)

    @property
    def available(self) -> int:
        """Blocks still reservable by new admissions."""
        return self.capacity - self.n_reserved - self.n_cache_only

    def refcount(self, block: int) -> int:
        """Current owner count of a physical block (0 == free)."""
        return self._ref.get(int(block), 0)

    def owns(self, rid: int) -> bool:
        """True while ``rid`` holds a block table (allocated, not freed)."""
        return rid in self._tables

    def table(self, rid: int) -> List[int]:
        return list(self._tables[rid])

    def n_blocks_of(self, rid: int) -> int:
        return len(self._tables[rid])

    def reserved_of(self, rid: int) -> int:
        return self._reserved[rid]

    def blocks_for_tokens(self, n_tokens: int) -> int:
        """ceil(n_tokens / block_size)."""
        return -(-max(int(n_tokens), 0) // self.block_size)

    # ------------------------------------------------------------- life cycle
    def can_admit(self, demand_blocks: int) -> bool:
        """True iff a request with this worst-case demand can be admitted
        without ever starving a live request's extend."""
        return 0 < demand_blocks <= self.available

    def alloc(self, rid: int, n_initial: int, *,
              reserve: Optional[int] = None,
              shared: Optional[Sequence[int]] = None) -> List[int]:
        """Admit ``rid``: reserve its worst-case demand and hand out the
        first ``n_initial`` physical blocks.  ``shared`` (prefix-cache hits)
        are adopted at the head of the table by refcount increment — they
        count against the reservation like any other block but consume no
        free-list entry.  Returns the freshly allocated ids only."""
        if rid in self._tables:
            raise ValueError(f"request {rid} already has a block table")
        shared = list(shared) if shared else []
        reserve = n_initial if reserve is None else int(reserve)
        if reserve < n_initial:
            raise ValueError(f"reserve={reserve} < n_initial={n_initial}")
        if reserve > self.capacity:
            raise ValueError(
                f"request {rid} demands {reserve} blocks; pool capacity is "
                f"{self.capacity} (n_blocks={self.n_blocks}, "
                f"block_size={self.block_size})")
        if not self.can_admit(reserve):
            raise RuntimeError(
                f"cannot admit request {rid}: demand {reserve} blocks, "
                f"available {self.available} (backpressure)")
        if n_initial < len(shared):
            raise ValueError(f"n_initial={n_initial} < {len(shared)} shared")
        self._reserved[rid] = reserve
        self._tables[rid] = []
        self._emit("alloc", rid=rid, reserve=reserve)
        if shared:
            self.share(rid, shared)
        return self.extend(rid, n_initial - len(shared))

    def share(self, rid: int, blocks: Sequence[int]) -> None:
        """Append already-resident blocks to ``rid``'s table (refcount++).
        The blocks must be live (refcount > 0) — sharing a free block would
        hand out rows another admission can claim."""
        table = self._tables.get(rid)
        if table is None:
            raise KeyError(f"unknown request {rid}")
        blocks = [int(b) for b in blocks]
        for b in blocks:
            if self._ref.get(b, 0) <= 0:
                raise ValueError(f"block {b} is not live; cannot share")
        if len(table) + len(blocks) > self._reserved[rid]:
            raise RuntimeError(
                f"request {rid}: sharing {len(blocks)} blocks exceeds its "
                f"reservation of {self._reserved[rid]}")
        for b in blocks:
            self._ref[b] += 1
            table.append(b)
        self._emit("share", rid=rid, blocks=list(blocks))

    def extend(self, rid: int, n_more: int) -> List[int]:
        """Grow ``rid``'s table by ``n_more`` physical blocks.  Never fails
        for an admitted request staying within its reservation (the
        reservation invariant keeps that many blocks physically free)."""
        table = self._tables.get(rid)
        if table is None:
            raise KeyError(f"unknown request {rid}")
        if n_more < 0:
            raise ValueError(f"n_more={n_more}")
        if len(table) + n_more > self._reserved[rid]:
            raise RuntimeError(
                f"request {rid}: extend to {len(table) + n_more} blocks "
                f"exceeds its reservation of {self._reserved[rid]}")
        assert n_more <= len(self._free), "reservation invariant violated"
        new = [self._free.pop() for _ in range(n_more)]
        for b in new:
            assert self._ref.get(b, 0) == 0, f"free-list block {b} is live"
            self._ref[b] = 1
        table.extend(new)
        self._emit("extend", rid=rid, blocks=list(new))
        return new

    def fork_cow(self, rid: int, src_block: int) -> int:
        """Copy-on-write fork: allocate a fresh block (from ``rid``'s own
        reservation) destined to receive a device copy of ``src_block`` — a
        partially-filled boundary block whose KV rows ``rid`` shares but
        must extend.  The source must be live (shared or cache-held); the
        caller performs the actual device copy and the suffix overwrite."""
        src_block = int(src_block)
        if self._ref.get(src_block, 0) <= 0:
            raise ValueError(f"block {src_block} is not live; nothing to fork")
        return self.extend(rid, 1)[0]

    def free(self, rid: int) -> List[int]:
        """Retire ``rid``: drop one reference on each of its physical blocks
        and release its reservation.  Returns ONLY the blocks whose refcount
        reached zero — blocks still shared with the prefix cache or with a
        co-resident request stay out of the free list, so the caller can
        never scrub or re-allocate KV another owner depends on.  Freed ids
        must be scrubbed BEFORE re-allocation (reset-slot hygiene)."""
        if rid in self._tables:
            self._emit("free_enter", rid=rid, table=list(self._tables[rid]))
        table = self._tables.pop(rid, None)
        if table is None:
            raise KeyError(f"unknown request {rid}")
        del self._reserved[rid]
        freed: List[int] = []
        for b in table:
            n = self._ref[b] - 1
            if n == 0:
                del self._ref[b]
                freed.append(b)
            else:
                self._ref[b] = n
        self._free.extend(freed)
        self._emit("free", rid=rid, freed=list(freed))
        return freed

    # ---------------------------------------------------------- prefix cache
    def cache_ref(self, blocks: Iterable[int]) -> None:
        """The prefix cache takes (at most one) ownership reference on each
        block, pinning it out of the free list across request retirement."""
        taken: List[int] = []
        for b in blocks:
            b = int(b)
            if b in self._cache_held:
                raise ValueError(f"block {b} already cache-held")
            if self._ref.get(b, 0) <= 0:
                raise ValueError(f"block {b} is not live; cannot cache_ref")
            self._ref[b] += 1
            self._cache_held.add(b)
            taken.append(b)
        self._emit("cache_ref", blocks=taken)

    def cache_unref(self, blocks: Iterable[int]) -> List[int]:
        """Release the prefix cache's reference (eviction).  Returns the
        blocks that became free as a result — the caller must scrub those
        before they can be re-allocated."""
        freed: List[int] = []
        dropped: List[int] = []
        for b in blocks:
            b = int(b)
            if b not in self._cache_held:
                raise ValueError(f"block {b} is not cache-held")
            self._cache_held.discard(b)
            dropped.append(b)
            n = self._ref[b] - 1
            if n == 0:
                del self._ref[b]
                freed.append(b)
            else:
                self._ref[b] = n
        self._free.extend(freed)
        self._emit("cache_unref", blocks=dropped, freed=list(freed))
        return freed

    # ---------------------------------------------------------- fragmentation
    def frag_rows(self, rid: int, used_rows: int) -> int:
        """Internal fragmentation of one request: allocated-but-unused token
        rows (its partially-filled tail block plus any pre-extended ones)."""
        return len(self._tables[rid]) * self.block_size - int(used_rows)

    def frag_rows_total(self, used_rows: Dict[int, int]) -> int:
        """Aggregate internal fragmentation over live requests; ``used_rows``
        maps rid -> committed token rows."""
        return sum(self.frag_rows(rid, used_rows.get(rid, 0))
                   for rid in self._tables)


__all__ = ["BlockAllocator", "NULL_BLOCK", "demand_blocks",
           "worst_case_pool_blocks"]
