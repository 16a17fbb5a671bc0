"""Runtime sanitizer: shadow checks for the serving engine (opt-in) — the
PyTorch port's copy of ``repro.analysis.sanitizer``.  Two parts differ: the
poison probe reads device memory (one gather and one pull a check), and a
"retrace" is a new input-shape signature of a session member.

Enabled with ``EngineConfig(sanitize=True)`` / ``serve.py --sanitize`` (or
``ContinuousScheduler(..., sanitize=True)`` directly).  Three monitors:

* :class:`LifecycleMonitor` — a per-request state machine
  (queued → admitted → active → retiring → drained).  Every scheduler
  transition is recorded; an out-of-order transition raises
  :class:`InvariantViolation` carrying the request's full history.  This
  is the check that pins the cancel-of-pending shape: a cancelled
  overlap admission must sit in ``retiring`` (blocks still owned) until
  the deferred drain moves it to ``drained``.

* :class:`ShadowLedger` — an independent replica of the
  ``BlockAllocator``'s per-block refcounts, built purely from the
  allocator's observer events.  Catches double frees (a block's shadow
  refcount going negative), frees of requests that are not retiring
  (the use-after-free window: blocks re-enter the free list while a
  dispatch may still write into them), refcount desyncs, and — under
  ``scrub_freed`` — poison-on-free: scrubbed free blocks are probed
  against the actual device KV rows and must still be all-zero when the
  pool hands them out again.  The probe gathers every armed block of
  ``k`` and ``v`` where the cache lives, reduces each block to one flag
  there and pulls the flags once.  On a card it is queued on the current
  stream, the one the session's members run and replay their graphs on:
  it reads after the captured ``reset_blocks`` replay that scrubbed those
  blocks and after every write queued before it, and its pull waits for
  it.

* :class:`RetraceMonitor` — snapshots each StepFns member's signature
  count (``_cache_size``) at attach and asserts the *delta* stays within
  a declared manifest (one per member per scheduler shape; one per suffix
  bucket for ``prefill_suffix``).  On the card a retrace is a new input
  signature, and with it a new captured CUDA graph (the reference's new
  XLA executable); the session counts signatures on the CPU too.
  Deltas, not absolutes: sessions are shared across schedulers in tests,
  and each distinct lane count legitimately adds one signature.

All checks raise :class:`InvariantViolation` the moment they trip — a
sanitized fuzz run passing means zero ledger violations, not a report to
read.  Everything here is observation: with ``sanitize=False`` none of
this module is even imported, and outputs are bit-identical either way.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Set, Tuple

import numpy as np
import torch


class InvariantViolation(AssertionError):
    """A runtime invariant of the serving engine was broken."""


PROBE_CHUNK = 64      # blocks a poison probe gathers at once (memory bound)


def dirty_blocks(cache, blocks: List[int]) -> np.ndarray:
    """(2, n) host bools: whether block ``blocks[i]`` holds a nonzero
    ``k`` (row 0) or ``v`` (row 1) entry in any layer.  The blocks are
    gathered and reduced where the cache lives (``PROBE_CHUNK`` at a
    time) and the flags cross to the host in one pull; on a card the
    block ids go up through pinned memory without waiting, so that pull
    is the probe's only sync."""
    k = torch.as_tensor(cache["k"])
    ids = torch.tensor(blocks, dtype=torch.long)
    if k.device.type == "cuda":
        ids = ids.pin_memory().to(k.device, non_blocking=True)
    flags = []
    for leaf in ("k", "v"):
        x = torch.as_tensor(cache[leaf])          # (L, nb, bs, K, dh)
        flags.append(torch.cat([
            x.index_select(1, ids[i:i + PROBE_CHUNK]).ne(0)
            .flatten(2).any(2).any(0)
            for i in range(0, len(blocks), PROBE_CHUNK)]))
    return torch.stack(flags).cpu().numpy()


# --------------------------------------------------------------- lifecycle
QUEUED = "queued"
ADMITTED = "admitted"
ACTIVE = "active"
RETIRING = "retiring"
DRAINED = "drained"

# queued can retire directly (cancel while waiting); admitted can retire
# without ever going active (finish-at-prefill, cancel-of-pending)
ALLOWED_TRANSITIONS: Set[Tuple[Optional[str], str]] = {
    (None, QUEUED),
    (QUEUED, ADMITTED),
    (QUEUED, RETIRING),
    (ADMITTED, ACTIVE),
    (ADMITTED, RETIRING),
    (ACTIVE, RETIRING),
    (RETIRING, DRAINED),
}


class LifecycleMonitor:
    """Per-request lifecycle state machine with full history retention."""

    def __init__(self):
        self._state: Dict[int, str] = {}
        self._history: Dict[int, List[str]] = {}

    def state(self, rid: int) -> Optional[str]:
        return self._state.get(rid)

    def history(self, rid: int) -> List[str]:
        return list(self._history.get(rid, []))

    def transition(self, rid: int, new: str) -> None:
        cur = self._state.get(rid)
        if (cur, new) not in ALLOWED_TRANSITIONS:
            hist = " -> ".join(self._history.get(rid, ["<never seen>"]))
            raise InvariantViolation(
                f"request {rid}: illegal lifecycle transition "
                f"{cur!r} -> {new!r} (history: {hist})")
        self._state[rid] = new
        self._history.setdefault(rid, []).append(new)

    def assert_all_drained(self) -> None:
        stuck = {rid: st for rid, st in self._state.items()
                 if st != DRAINED}
        if stuck:
            detail = ", ".join(
                f"rid {rid} in {st!r} (history: "
                f"{' -> '.join(self._history[rid])})"
                for rid, st in sorted(stuck.items()))
            raise InvariantViolation(
                f"{len(stuck)} request(s) not drained at idle: {detail}")


# ------------------------------------------------------------ shadow ledger
class ShadowLedger:
    """Independent replica of the allocator's block ownership, fed by its
    observer events (``BlockAllocator.observer``).  The ledger never
    consults the allocator's own refcounts while running — desyncs are
    caught by :meth:`assert_matches` at idle."""

    def __init__(self, lifecycle: Optional[LifecycleMonitor] = None):
        self.lifecycle = lifecycle
        self._ref: Dict[int, int] = {}       # block -> shadow refcount
        self._live_rids: Set[int] = set()
        self._cache_held: Set[int] = set()
        self.poisoned: Set[int] = set()      # scrubbed-while-free blocks
        self._free_zeroed: List[int] = []    # transient, free_enter->free
        self.probes = 0                      # poison checks that pulled
        self.probed_blocks = 0               # blocks they read, summed

    # --------------------------------------------------------------- events
    def on_event(self, event: str, **kw) -> None:
        handler = getattr(self, f"_on_{event}", None)
        if handler is None:
            raise InvariantViolation(f"unknown allocator event {event!r}")
        handler(**kw)

    def _on_alloc(self, rid: int, reserve: int) -> None:
        if rid in self._live_rids:
            raise InvariantViolation(
                f"request {rid} allocated twice (already live)")
        self._live_rids.add(rid)

    def _on_extend(self, rid: int, blocks: List[int]) -> None:
        if rid not in self._live_rids:
            raise InvariantViolation(
                f"extend for request {rid} which holds no allocation")
        for b in blocks:
            if self._ref.get(b, 0) != 0:
                raise InvariantViolation(
                    f"block {b} handed out while shadow refcount is "
                    f"{self._ref[b]} (allocating a live block)")
            self._ref[b] = 1
            self.poisoned.discard(b)

    def _on_share(self, rid: int, blocks: List[int]) -> None:
        for b in blocks:
            if self._ref.get(b, 0) <= 0:
                raise InvariantViolation(
                    f"block {b} shared while free (shadow refcount 0)")
            self._ref[b] += 1

    def _on_free_enter(self, rid: int, table: List[int]) -> None:
        if rid not in self._live_rids:
            raise InvariantViolation(
                f"double free: request {rid} holds no allocation")
        if self.lifecycle is not None and \
                self.lifecycle.state(rid) not in (None, RETIRING):
            raise InvariantViolation(
                f"use-after-free window: request {rid} freed while "
                f"{self.lifecycle.state(rid)!r} (history: "
                f"{' -> '.join(self.lifecycle.history(rid))}); a dispatch "
                "may still write into its blocks — frees belong in the "
                "retire/drain path")
        self._free_zeroed = []
        for b in table:
            n = self._ref.get(b, 0) - 1
            if n < 0:
                raise InvariantViolation(
                    f"double free of block {b} (shadow refcount went "
                    "negative)")
            if n == 0:
                del self._ref[b]
                self._free_zeroed.append(b)
            else:
                self._ref[b] = n

    def _on_free(self, rid: int, freed: List[int]) -> None:
        self._live_rids.discard(rid)
        if sorted(freed) != sorted(self._free_zeroed):
            raise InvariantViolation(
                f"request {rid}: allocator freed blocks {sorted(freed)} "
                f"but the shadow ledger expected "
                f"{sorted(self._free_zeroed)} to reach refcount zero")
        self._free_zeroed = []

    def _on_cache_ref(self, blocks: List[int]) -> None:
        for b in blocks:
            if b in self._cache_held:
                raise InvariantViolation(
                    f"block {b} cache-referenced twice")
            if self._ref.get(b, 0) <= 0:
                raise InvariantViolation(
                    f"free block {b} pinned by the prefix cache")
            self._ref[b] += 1
            self._cache_held.add(b)

    def _on_cache_unref(self, blocks: List[int],
                        freed: List[int]) -> None:
        zeroed = []
        for b in blocks:
            if b not in self._cache_held:
                raise InvariantViolation(
                    f"cache_unref of block {b} the cache never held")
            self._cache_held.discard(b)
            n = self._ref.get(b, 0) - 1
            if n < 0:
                raise InvariantViolation(
                    f"double free of cache block {b}")
            if n == 0:
                del self._ref[b]
                zeroed.append(b)
            else:
                self._ref[b] = n
        if sorted(freed) != sorted(zeroed):
            raise InvariantViolation(
                f"cache_unref freed {sorted(freed)} but the shadow "
                f"ledger expected {sorted(zeroed)}")

    # ------------------------------------------------------ poison-on-free
    def on_scrubbed(self, blocks: Iterable[int]) -> None:
        """Freed blocks were zeroed on device: arm the poison check."""
        for b in blocks:
            if self._ref.get(int(b), 0) == 0:
                self.poisoned.add(int(b))

    def check_poison(self, cache) -> None:
        """Probe every armed block's actual KV rows: a scrubbed free block
        must still be all-zero when it can next be handed out — a nonzero
        row means something wrote into memory it no longer owns.  One
        gather and one pull a check (``dirty_blocks``), where the
        reference pulls each block and leaf."""
        if cache is None or not self.poisoned:
            return
        blocks = sorted(self.poisoned)
        dirty = dirty_blocks(cache, blocks)
        self.probes += 1
        self.probed_blocks += len(blocks)
        hits = np.argwhere(dirty)
        if len(hits):
            leaf, i = hits[0]
            raise InvariantViolation(
                f"use-after-free write detected: freed+scrubbed "
                f"block {blocks[i]} has nonzero {('k', 'v')[leaf]!r} rows "
                "— some dispatch wrote into memory it no longer owns")

    # ------------------------------------------------------------ idle gate
    def assert_matches(self, allocator) -> None:
        """Shadow-vs-real refcount comparison (ledger desync check)."""
        real = dict(getattr(allocator, "_ref"))
        if self._ref != real:
            raise InvariantViolation(
                f"shadow ledger desync: shadow refcounts {self._ref} != "
                f"allocator refcounts {real}")
        if self._cache_held != set(getattr(allocator, "_cache_held")):
            raise InvariantViolation("shadow ledger desync on cache-held "
                                     "block set")

    def assert_idle(self, allocator) -> None:
        """At scheduler idle every live block must be explained by the
        prefix cache; anything else leaked."""
        self.assert_matches(allocator)
        leaked = {b: n for b, n in self._ref.items()
                  if b not in self._cache_held}
        if leaked:
            raise InvariantViolation(
                f"block leak at idle: {len(leaked)} block(s) still "
                f"referenced by no live request or cache: {leaked}")
        if self._live_rids:
            raise InvariantViolation(
                f"requests still hold allocations at idle: "
                f"{sorted(self._live_rids)}")


# ---------------------------------------------------------------- retraces
# StepFns members whose signature counters (``_cache_size``) we watch
_COUNTED_MEMBERS = ("prefill", "prefill_into_slot", "prefill_suffix",
                    "tree_step", "fused_step", "commit", "copy_block",
                    "reset_blocks", "reset_slot")


class RetraceMonitor:
    """Asserts observed signature-count *deltas* against a manifest."""

    def __init__(self, fns, manifest: Optional[Dict[str, int]] = None):
        self.fns = fns
        self.manifest = (dict(manifest) if manifest is not None
                         else self.default_manifest(fns))
        self._base = self._counts()

    @staticmethod
    def default_manifest(fns) -> Dict[str, int]:
        """The compile-once contract (I2): one signature (on the card, one
        captured graph) per member per scheduler shape; the suffix-prefill
        bucket ladder adds one per bucket."""
        manifest = {name: 1 for name in _COUNTED_MEMBERS}
        buckets = getattr(fns, "suffix_buckets", ()) or ()
        manifest["prefill_suffix"] = max(len(buckets), 1)
        return manifest

    def _counts(self) -> Dict[str, int]:
        out = {}
        for name in _COUNTED_MEMBERS:
            member = getattr(self.fns, name, None)
            counter = getattr(member, "_cache_size", None)
            if counter is not None:
                out[name] = int(counter())
        return out

    def check(self) -> None:
        for name, now in self._counts().items():
            delta = now - self._base[name]
            budget = self.manifest.get(name, 1)
            if delta > budget:
                raise InvariantViolation(
                    f"retrace: StepFns.{name} saw {delta} new input "
                    f"signature(s) under this scheduler; the manifest "
                    f"allows {budget} (a shape is drifting call-to-call)")


# ------------------------------------------------------------------ facade
class Sanitizer:
    """The bundle a sanitized scheduler owns: lifecycle machine, shadow
    ledger (paged layouts only), retrace monitor."""

    def __init__(self, lifecycle: LifecycleMonitor,
                 ledger: Optional[ShadowLedger],
                 retrace: RetraceMonitor):
        self.lifecycle = lifecycle
        self.ledger = ledger
        self.retrace = retrace

    @classmethod
    def attach(cls, scheduler) -> "Sanitizer":
        """Wire a sanitizer onto a scheduler under construction: installs
        the shadow ledger as the allocator's observer."""
        lifecycle = LifecycleMonitor()
        ledger = None
        if scheduler.allocator is not None:
            ledger = ShadowLedger(lifecycle)
            scheduler.allocator.observer = ledger
        return cls(lifecycle, ledger, RetraceMonitor(scheduler.fns))

    def transition(self, rid: int, state: str) -> None:
        self.lifecycle.transition(rid, state)

    def on_scrubbed(self, blocks: Iterable[int]) -> None:
        if self.ledger is not None:
            self.ledger.on_scrubbed(blocks)

    def check_poison(self, cache) -> None:
        if self.ledger is not None:
            self.ledger.check_poison(cache)

    def verify_idle(self, scheduler) -> None:
        """The full idle-state audit; run() calls this after draining."""
        self.lifecycle.assert_all_drained()
        if scheduler._retired or scheduler._pending:
            raise InvariantViolation(
                "scheduler idle with deferred retirements or pending "
                f"admissions: retired={len(scheduler._retired)} "
                f"pending={sorted(scheduler._pending)}")
        if self.ledger is not None and scheduler.allocator is not None:
            self.ledger.assert_idle(scheduler.allocator)
            self.ledger.check_poison(scheduler.cache)
        self.retrace.check()


__all__ = ["InvariantViolation", "LifecycleMonitor", "ShadowLedger",
           "dirty_blocks", "PROBE_CHUNK",
           "RetraceMonitor", "Sanitizer", "QUEUED", "ADMITTED", "ACTIVE",
           "RETIRING", "DRAINED", "ALLOWED_TRANSITIONS"]
