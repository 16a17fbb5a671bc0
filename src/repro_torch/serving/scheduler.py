"""Slot-based continuous-batching scheduler (the production serving loop).

The paper's deployment setting ("serve heavy traffic" — Alipay production
since April 2023) needs the device batch to stay full: lock-step batching
leaves lanes idle as soon as the shortest request of a batch finishes, and
with mixed ``max_new_tokens`` most device steps run mostly-empty.  The
scheduler instead owns a fixed pool of ``lanes`` KV-cache slots plus an
admission queue:

  * a submitted request waits in the queue until a lane frees up,
  * the first admission batch-prefills one cohort (``StepFns.prefill`` at
    (lanes, prefill_len) — the dense-FLOPs phase keeps its batching);
    afterwards admission prefills the prompt *into* the freed lane only
    (``StepFns.prefill_into_slot`` — one (1, prefill_len) forward; every
    other lane keeps decoding, its cache untouched),
  * each decode step drives ALL lanes through one fixed-shape
    ``tree_step``/``commit`` pair; idle lanes carry a placeholder draft and
    commit zero tokens (masked out, never stalling anyone),
  * a request leaves its lane on EOS / budget / cache-overflow and the next
    queued request is admitted on the following scheduler iteration.  Stale
    KV rows of a freed lane are left in place — they are never attended
    (invariant I3); ``scrub_freed=True`` zeroes them at free time for
    debugging/inspection, not for correctness.

With a paged StepFns (``kv_layout == "paged"``; DESIGN.md §Paged KV cache)
the scheduler additionally owns a ``BlockAllocator``: admission requires a
free lane AND a reservable worst-case block demand (otherwise the FIFO
queue waits — preemption-free backpressure), block tables ride inside the
cache dict and are extended after each commit to cover the next tree step,
and a retiring request's blocks are freed — and, under ``scrub_freed``,
zeroed by physical id BEFORE they can be re-allocated (lane-keyed scrubbing
after reuse would destroy the next request's KV).

Slot lifecycle (DESIGN.md §Scheduler slot lifecycle):

    FREE --admit(prefill_into_slot)--> ACTIVE --accept*--> DRAINED --release--> FREE

Invariants the implementation maintains (and tests assert):

  I1  Losslessness is per-request: a request's tokens equal
      ``reference_decode`` output regardless of arrival order, lane
      assignment, or what else is co-batched (greedy and position-keyed
      sample mode alike — sampling keys fold the request's own absolute
      output position, never the lane or step index).
  I2  Fixed shapes: every device call after construction uses the same
      (lanes, T) / (1, prefill_len) shapes ⇒ each StepFns member compiles
      exactly once per scheduler.
  I3  A lane's committed cache prefix [0, lens[lane]) is always exactly the
      KV of its request's prompt ⧺ accepted tokens; rows beyond it are
      garbage and never attended.
  I4  Trie bookkeeping is slot-agnostic: prompt branches are inserted at
      admission and eliminated at retirement, output branches stream in as
      tokens are accepted — identical transitions to the lock-step loop.

Speculation is pluggable (DESIGN.md §Draft sources): each request's
resolved ``DraftPolicy`` names the draft sources feeding its trees
(default: the trie source alone — bit-identical to the old hardwired
path), the trie namespace isolating its scenario, and whether its draft
budget adapts to its accepted-length EMA.  All of it is host-side; the
device ``StepFns`` and every invariant above are untouched.
"""
from __future__ import annotations

import dataclasses
import math
import time
import weakref
from collections import deque
from typing import (TYPE_CHECKING, Callable, Deque, Dict, List,
                    MutableMapping, Optional, Sequence)

import numpy as np
import torch

from repro_torch.core.autotune import AutoTuner
from repro_torch.core.draft_sources import (AdaptiveBudget, DraftPolicy,
                                            DraftSource, TrieSource,
                                            build_draft_from_policy,
                                            make_source)
from repro_torch.core.request import (Request, RequestResult, RequestState,
                                      SamplingParams, StepFns,
                                      cache_token_limit, idle_tree)
from repro_torch.core.strategies import LookaheadConfig
from repro_torch.core.trie import TrieTree
from repro_torch.core.verify import verify_accept_batch
from repro_torch.serving.block_allocator import BlockAllocator, demand_blocks
from repro_torch.serving.prefix_cache import PrefixCache

if TYPE_CHECKING:   # avoid a load-time cycle: api.py imports the scheduler
    from repro_torch.serving.api import RequestHandle


class NamespaceStats:
    """Per-tenant slice of the serving-loop statistics (SLO reporting:
    latency percentiles, lane occupancy, per-source acceptance)."""

    def __init__(self):
        self.submitted = 0
        self.finished = 0          # includes cancelled
        self.cancelled = 0
        self.tokens = 0
        self.lane_steps = 0        # decode steps x lanes this tenant held
        self.latencies: List[float] = []
        self.ttfts: List[float] = []
        self.queue_waits: List[float] = []
        self.source_drafted: Dict[str, int] = {}
        self.source_accepted: Dict[str, int] = {}

    @staticmethod
    def _pct(xs: List[float], q: float) -> float:
        if not xs:
            return 0.0
        ys = sorted(xs)
        return ys[min(int(round(q * (len(ys) - 1))), len(ys) - 1)]

    def p50_latency(self) -> float:
        return self._pct(self.latencies, 0.50)

    def p99_latency(self) -> float:
        return self._pct(self.latencies, 0.99)

    def source_acceptance(self) -> Dict[str, float]:
        return {n: self.source_accepted.get(n, 0) / max(d, 1)
                for n, d in self.source_drafted.items()}

    def summary(self, decode_steps: int, lanes: int) -> Dict[str, float]:
        return {"submitted": self.submitted, "finished": self.finished,
                "cancelled": self.cancelled, "tokens": self.tokens,
                "occupancy": self.lane_steps / max(decode_steps * lanes, 1),
                "p50_latency_s": self.p50_latency(),
                "p99_latency_s": self.p99_latency(),
                "p50_ttft_s": self._pct(self.ttfts, 0.50),
                "p99_ttft_s": self._pct(self.ttfts, 0.99),
                "p99_queue_s": self._pct(self.queue_waits, 0.99)}

    # ---- fleet rollup (repro.fleet): raw samples travel, not percentiles —
    # a fleet p99 must be computed over the union of every replica's
    # latencies, never averaged from per-replica percentiles.
    def snapshot(self) -> Dict[str, object]:
        return {"submitted": self.submitted, "finished": self.finished,
                "cancelled": self.cancelled, "tokens": self.tokens,
                "lane_steps": self.lane_steps,
                "latencies": list(self.latencies),
                "ttfts": list(self.ttfts),
                "queue_waits": list(self.queue_waits),
                "source_drafted": dict(self.source_drafted),
                "source_accepted": dict(self.source_accepted)}

    def merge(self, other: Dict[str, object]) -> None:
        """Accumulate another replica's snapshot of the same namespace."""
        self.submitted += int(other["submitted"])
        self.finished += int(other["finished"])
        self.cancelled += int(other["cancelled"])
        self.tokens += int(other["tokens"])
        self.lane_steps += int(other["lane_steps"])
        self.latencies.extend(float(x) for x in other["latencies"])
        self.ttfts.extend(float(x) for x in other["ttfts"])
        self.queue_waits.extend(float(x) for x in other["queue_waits"])
        for k, v in dict(other["source_drafted"]).items():
            self.source_drafted[k] = self.source_drafted.get(k, 0) + int(v)
        for k, v in dict(other["source_accepted"]).items():
            self.source_accepted[k] = self.source_accepted.get(k, 0) + int(v)


class SchedulerStats:
    """Aggregate serving-loop statistics (occupancy is the continuous-
    batching win: mean fraction of lanes doing useful work per step)."""

    def __init__(self, lanes: int):
        self.lanes = lanes
        self.decode_steps = 0
        self.active_lane_steps = 0
        self.admitted = 0
        self.finished = 0
        self.block_waits = 0     # admissions deferred for blocks, not lanes
        self.peak_blocks = 0     # max physical blocks allocated at once
        # ---- per-step latency breakdown (totals over decode steps)
        self.host_draft_ms = 0.0     # draft retrieval/merging + tree packing
        self.device_step_ms = 0.0    # dispatch -> packed result on the host
        self.accept_commit_ms = 0.0  # accept bookkeeping, retire, tables
        self.hidden_host_ms = 0.0    # host work run while a step was in
        #                              flight on device (overlap mode only)
        self.host_syncs = 0          # every device->host pull the loop makes
        self.decode_syncs = 0        # pulls on the decode hot path only
        # ---- prefix cache (zeros when disabled)
        self.prefix_lookups = 0
        self.prefix_hits = 0          # admissions with >= 1 cached token
        self.prefix_hit_tokens = 0    # prompt tokens whose prefill was skipped
        self.prefix_prompt_tokens = 0  # prompt tokens presented to lookup
        self.prefix_cow_forks = 0
        self.prefix_evicted_blocks = 0
        # ---- per-tenant slices (keyed by trie namespace); created lazily
        self.namespaces: Dict[str, NamespaceStats] = {}

    def ns(self, namespace: str) -> NamespaceStats:
        s = self.namespaces.get(namespace)
        if s is None:
            s = self.namespaces[namespace] = NamespaceStats()
        return s

    def namespace_summary(self) -> Dict[str, Dict[str, float]]:
        """namespace -> SLO summary (percentiles, occupancy, counts)."""
        return {name: st.summary(self.decode_steps, self.lanes)
                for name, st in sorted(self.namespaces.items())}

    def snapshot(self) -> Dict[str, object]:
        """Portable stats snapshot for the fleet rollup (plain data only —
        crosses the subprocess-replica boundary as JSON-able payload)."""
        return {"lanes": self.lanes, "decode_steps": self.decode_steps,
                "active_lane_steps": self.active_lane_steps,
                "admitted": self.admitted, "finished": self.finished,
                "prefix_lookups": self.prefix_lookups,
                "prefix_hits": self.prefix_hits,
                "prefix_hit_tokens": self.prefix_hit_tokens,
                "namespaces": {ns: st.snapshot()
                               for ns, st in self.namespaces.items()}}

    @property
    def occupancy(self) -> float:
        return self.active_lane_steps / max(self.decode_steps * self.lanes, 1)

    @property
    def prefix_hit_rate(self) -> float:
        """Fraction of looked-up admissions that matched a cached prefix."""
        return self.prefix_hits / max(self.prefix_lookups, 1)

    @property
    def prefill_tokens_saved(self) -> float:
        """Fraction of presented prompt tokens served from the cache."""
        return self.prefix_hit_tokens / max(self.prefix_prompt_tokens, 1)

    @property
    def syncs_per_decode_step(self) -> float:
        """Host syncs per decode step (1.0 on the fused hot path)."""
        return self.decode_syncs / max(self.decode_steps, 1)

    def breakdown(self) -> Dict[str, float]:
        """Mean per-decode-step latency split in milliseconds."""
        d = max(self.decode_steps, 1)
        return {"host_draft_ms": self.host_draft_ms / d,
                "device_step_ms": self.device_step_ms / d,
                "accept_commit_ms": self.accept_commit_ms / d,
                "hidden_host_ms": self.hidden_host_ms / d,
                "syncs_per_step": self.syncs_per_decode_step}


class ContinuousScheduler:
    """Fixed-lane continuous-batching serving loop over ``StepFns``.

    Drive it either as a batch runner (``submit`` everything, then ``run()``)
    or as an online loop (``submit`` as requests arrive, call ``step()``
    repeatedly; each call returns the requests that finished in it).
    """

    def __init__(self, fns: StepFns, config: LookaheadConfig, *,
                 lanes: int, trie: Optional[TrieTree] = None,
                 eos_id: int = -1, prefill_len: Optional[int] = None,
                 rid_start: int = 0, scrub_freed: bool = False,
                 default_params: Optional[SamplingParams] = None,
                 draft_policy: Optional[DraftPolicy] = None,
                 sources: Optional[Dict[str, DraftSource]] = None,
                 overlap_drafts: bool = False,
                 record_breakdown: bool = False,
                 prefix_cache: bool = False,
                 prefix_cache_blocks: Optional[int] = None,
                 lane_shares: Optional[Dict[str, float]] = None,
                 draft_budget_caps: Optional[Dict[str, int]] = None,
                 autotune=False, sanitize: bool = False):
        if not fns.supports_slot_serving:
            raise ValueError("StepFns lack prefill_into_slot/init_cache; "
                             "continuous batching needs per-slot admission")
        if overlap_drafts and fns.fused_step is None:
            raise ValueError("overlap_drafts needs StepFns.fused_step (the "
                             "single-dispatch step the overlap window hides "
                             "host work behind)")
        self.overlap_drafts = bool(overlap_drafts)
        self.record_breakdown = bool(record_breakdown)
        self.step_breakdown: List[Dict[str, float]] = []
        # overlap mode: requests retired at step k whose heavy bookkeeping
        # (trie elimination, block free + scrub, handle finalize) is deferred
        # into step k+1's in-flight window, and admissions whose
        # prefill_into_slot was dispatched but whose first-token pull is
        # deferred until the other lanes' drafts are built
        self._retired: List[RequestState] = []
        self._pending: Dict[int, RequestState] = {}
        self._pending_chosen: Dict[int, object] = {}
        self.fns = fns
        self.config = config
        self.eos_id = eos_id
        self.lanes = int(lanes)
        self.scrub_freed = bool(scrub_freed)
        self.prefill_len = int(prefill_len or fns.prefill_len or 0)
        if self.prefill_len <= 0:
            raise ValueError("prefill_len must be set (fixed prompt pad "
                             "length; compile-once admission)")
        # ---- draft sources (DESIGN.md §Draft sources): requests speculate
        # through the sources their resolved DraftPolicy names; the trie
        # source always exists (the default policy and the compat ``trie``
        # surface), wrapping the passed trie when one is handed over so a
        # caller-owned trie stays warm across scheduler instances.
        self.default_policy = (draft_policy if draft_policy is not None
                               else DraftPolicy()).validate()
        self.sources: Dict[str, DraftSource] = (
            sources if sources is not None else {})
        if "trie" not in self.sources:
            self.sources["trie"] = TrieSource(config, trie=trie)
        if config.strategy == "none" or config.decoding_length == 0:
            self.width = 1
        else:
            self.width = fns.slots
        if self.prefill_len + self.width > fns.max_seq_len:
            # the first tree step after admitting a full-length prompt would
            # scatter draft KV past the cache end (silently dropped rows ⇒
            # garbage logits ⇒ a losslessness violation, not an error)
            raise ValueError(
                f"prefill_len={self.prefill_len} + tree width={self.width} "
                f"exceeds max_seq_len={fns.max_seq_len}")
        # ---- multi-tenant control layer (DESIGN.md §Multi-tenant SLOs):
        # per-namespace admission queues (each tenant's own queue stays FIFO
        # — I1 losslessness is per-request, so only cross-tenant order may
        # change), stride-scheduled when lane shares are configured, global
        # FIFO by rid otherwise (bit-identical to the single-queue code).
        self.lane_shares: Dict[str, float] = {
            str(k): float(v) for k, v in (lane_shares or {}).items()}
        for nsn, share in self.lane_shares.items():
            if not 0.0 < share <= 1.0:
                raise ValueError(f"lane share for namespace {nsn!r} is "
                                 f"{share}; need a pool fraction in (0, 1]")
        self.draft_budget_caps: Dict[str, int] = {
            str(k): int(v) for k, v in (draft_budget_caps or {}).items()}
        for nsn, cap in self.draft_budget_caps.items():
            if cap < 0:
                raise ValueError(f"draft budget cap for namespace {nsn!r} "
                                 f"is {cap}; need >= 0")
        self.autotuner: Optional[AutoTuner] = (
            autotune if isinstance(autotune, AutoTuner)
            else (AutoTuner() if autotune else None))
        self.queues: Dict[str, Deque[RequestState]] = {}
        self._q_pass: Dict[str, float] = {}   # stride pass per namespace
        self._vtime = 0.0                     # virtual time = last served pass
        self.cache = None          # allocated by the first admission batch
        self.lens = np.zeros((self.lanes,), dtype=np.int32)
        self.states: List[Optional[RequestState]] = [None] * self.lanes
        self.results: Dict[int, RequestResult] = {}
        # a live request's handle is held weakly, so that a caller who drops
        # it (or the whole engine) with the request in flight leaves no
        # cycle (handle -> scheduler -> handle) that keeps the session, its
        # KV cache and graphs on the card until the cycle collector runs;
        # its on_token callbacks are held here and fire all the same
        self.handles: MutableMapping[int, "RequestHandle"] = \
            weakref.WeakValueDictionary()
        self.callbacks: Dict[int, List[Callable[[List[int]], None]]] = {}
        self._order: List[int] = []
        self.next_rid = int(rid_start)
        self.stats = SchedulerStats(self.lanes)
        # ---- per-lane sampling params (request-centric API): device-step
        # inputs, refreshed at admission; idle lanes keep the session default.
        # ``default_params`` (EngineConfig's) wins over the session-level
        # ones baked by make_session_fns (which carry no max_new_tokens)
        self._defaults = (default_params if default_params is not None
                          else fns.default_params)
        self.lane_greedy = np.full((self.lanes,), not self._defaults.sample)
        self.lane_temp = np.full((self.lanes,), self._defaults.temperature,
                                 dtype=np.float32)
        self.lane_seed = np.full((self.lanes,),
                                 np.uint32(self._defaults.seed),
                                 dtype=np.uint32)
        # ---- paged KV layout: host-side block tables + allocator
        self.kv_layout = getattr(fns, "kv_layout", "dense")
        self.allocator: Optional[BlockAllocator] = None
        if self.kv_layout == "paged":
            bpl = fns.blocks_per_lane
            nb = fns.n_blocks or 1 + self.lanes * bpl
            self.allocator = BlockAllocator(nb, fns.block_size)
            self.tables = np.zeros((self.lanes, bpl), dtype=np.int32)
            self._tables_dirty = True
        # ---- radix prefix cache (DESIGN.md §Prefix cache): lookup at
        # admission, insert at retire; shares pool blocks by refcount.
        self.prefix: Optional[PrefixCache] = None
        if prefix_cache:
            if self.allocator is None:
                raise ValueError("prefix_cache requires kv_layout='paged' "
                                 "(block sharing needs the paged pool)")
            if fns.prefill_suffix is None or fns.copy_block is None:
                raise ValueError("these StepFns lack prefill_suffix/"
                                 "copy_block; rebuild the session to enable "
                                 "the prefix cache")
            self.prefix = PrefixCache(self.allocator,
                                      max_blocks=prefix_cache_blocks)
        # transient per-admission hit info: rid -> (n_cached, cow_src,
        # cow_dst); written by _claim_blocks, consumed by the same _admit
        self._hits: Dict[int, tuple] = {}
        # block ids evicted before the first prefill created the cache:
        # scrubbing needs a cache to dispatch against, so the ids wait here
        # and flush right after cache creation (satellite: silent scrub skip)
        self._scrub_backlog: List[int] = []
        # ---- runtime sanitizer (DESIGN.md §Invariants & analysis): opt-in
        # shadow checks — request lifecycle machine, block-ownership ledger
        # on the allocator's observer hook, retrace monitor.  Default-off
        # costs nothing: the module is not even imported.
        self.sanitizer = None
        if sanitize:
            from repro_torch.analysis.sanitizer import Sanitizer
            self.sanitizer = Sanitizer.attach(self)

    # ------------------------------------------------------------------ state
    @property
    def n_active(self) -> int:
        return sum(1 for s in self.states if s is not None)

    @property
    def n_queued(self) -> int:
        return sum(len(q) for q in self.queues.values())

    @property
    def queue(self) -> List[RequestState]:
        """Flat view of every queued request in global FIFO (rid) order
        (read-only compat/introspection surface; admission order itself is
        the per-namespace picker's business)."""
        return sorted((rs for q in self.queues.values() for rs in q),
                      key=lambda rs: rs.rid)

    @property
    def idle(self) -> bool:
        return (self.n_active == 0 and self.n_queued == 0
                and not self._pending and not self._retired)

    # -------------------------------------------------- weighted-fair picking
    def _ns_weight(self, nsn: str) -> float:
        """Stride weight of a namespace: its configured share, or — for a
        namespace the operator did not list — the smallest configured share
        (unlisted tenants never outweigh provisioned ones)."""
        w = self.lane_shares.get(nsn)
        if w is not None:
            return w
        return min(self.lane_shares.values()) if self.lane_shares else 1.0

    def _ns_lane_cap(self, nsn: str) -> int:
        """Hard cap on lanes a namespace may hold at once: ceil(lanes x
        share) for listed namespaces (floor 1 — a share never starves its
        own tenant outright), the whole pool for unlisted ones."""
        share = self.lane_shares.get(nsn)
        if share is None:
            return self.lanes
        return max(1, int(math.ceil(self.lanes * share)))

    def _lanes_in_use(self) -> Dict[str, int]:
        """Lanes currently held per namespace (active + in-flight pending)."""
        used: Dict[str, int] = {}
        for rs in self.states:
            if rs is not None:
                used[rs.draft.namespace] = used.get(rs.draft.namespace,
                                                    0) + 1
        for rs in self._pending.values():
            used[rs.draft.namespace] = used.get(rs.draft.namespace, 0) + 1
        return used

    def _pick_ns(self, in_use: Dict[str, int]) -> Optional[str]:
        """The namespace whose queue head admits next.

        No lane shares configured: global FIFO across tenants — the head
        with the lowest rid (rids are submit-monotonic), bit-identical to
        the old single-queue scheduler.  With shares: stride scheduling —
        the eligible non-empty queue with the smallest pass value (ties
        break by name, deterministically); namespaces at their lane cap are
        skipped.  Within a namespace order is always FIFO.
        """
        best = None
        for nsn, q in self.queues.items():
            if not q:
                continue
            if self.lane_shares:
                if in_use.get(nsn, 0) >= self._ns_lane_cap(nsn):
                    continue
                key = (self._q_pass.get(nsn, 0.0), nsn)
            else:
                key = (q[0].rid, nsn)
            if best is None or key < best[0]:
                best = (key, nsn)
        return None if best is None else best[1]

    def _take_queued(self, nsn: str) -> RequestState:
        """Dequeue the namespace's head and charge its stride pass."""
        rs = self.queues[nsn].popleft()
        if self.sanitizer is not None:
            self.sanitizer.transition(rs.rid, "admitted")
        if self.lane_shares:
            pas = max(self._q_pass.get(nsn, 0.0), self._vtime)
            self._vtime = pas
            self._q_pass[nsn] = pas + 1.0 / self._ns_weight(nsn)
        return rs

    def _pull(self, x, *, decode: bool = False) -> np.ndarray:
        """THE device->host transfer point: every pull the loop makes goes
        through here so tests can assert the per-step sync count (fused
        decode: exactly one packed pull per step)."""
        self.stats.host_syncs += 1
        if decode:
            self.stats.decode_syncs += 1
        return x.cpu().numpy() if isinstance(x, torch.Tensor) \
            else np.asarray(x)

    # ---------------------------------------------------------- draft sources
    @property
    def trie(self) -> TrieTree:
        """Default-namespace trie of the trie source (compat surface:
        engine warmup, stats printing, tests)."""
        return self.sources["trie"].trie

    def _resolve_sources(self, policy: DraftPolicy) -> List[DraftSource]:
        """The policy's source instances, instantiating registry entries on
        first use (shared across every request of this scheduler — and, when
        a ``sources`` dict was passed in, across schedulers)."""
        out = []
        for name in policy.sources:
            src = self.sources.get(name)
            if src is None:
                src = self.sources[name] = make_source(name, self.config)
            out.append(src)
        return out

    def _observe_prompt(self, rs: RequestState) -> None:
        for src in self._resolve_sources(rs.draft):
            src.observe_prompt(rs.rid, rs.prompt,
                               namespace=rs.draft.namespace)

    def _observe_output(self, rs: RequestState) -> None:
        for src in self._resolve_sources(rs.draft):
            src.observe_output(rs.rid, rs.output,
                               namespace=rs.draft.namespace)

    def _retire_sources(self, rs: RequestState) -> None:
        for src in self._resolve_sources(rs.draft):
            src.retire(rs.rid, namespace=rs.draft.namespace)

    # ------------------------------------------------------------------ paged
    def _demand_blocks(self, plen: int, max_new: int) -> int:
        """Worst-case block demand (the shared admission formula), reserved
        at admission so mid-flight ``extend`` can never fail
        (preemption-free backpressure; DESIGN.md §Paged KV cache)."""
        return demand_blocks(plen, max_new, self.width,
                             self.fns.max_seq_len, self.fns.block_size)

    def _claim_blocks(self, rs: RequestState, lane: int) -> bool:
        """Reserve + allocate initial blocks for ``rs``; False = not enough
        reservable blocks right now (request stays queued — backpressure).

        With the prefix cache enabled: look up the prompt first and PIN the
        matched nodes, so the eviction pass that makes room for this very
        admission cannot evict the blocks it is about to share; adopt
        matched full blocks into the table head by refcount, allocate a COW
        fork target for a partially-matched boundary block, and only then
        take fresh blocks for the uncached tail."""
        if self.sanitizer is not None:
            # poison-on-free: before blocks can be handed back out, every
            # freed+scrubbed block must still hold all-zero KV rows
            self.sanitizer.check_poison(self.cache)
        demand = self._demand_blocks(len(rs.prompt), rs.max_new_tokens)
        match = None
        if self.prefix is not None:
            match = self.prefix.lookup(rs.prompt,
                                       namespace=rs.draft.namespace)
            self.stats.prefix_lookups += 1
            self.stats.prefix_prompt_tokens += len(rs.prompt)
        if not self.allocator.can_admit(demand):
            # cache-only blocks are reclaimable: LRU-evict before declaring
            # backpressure (matched nodes are pinned, so a hit keeps its
            # shared blocks even under pool pressure)
            if self.prefix is not None:
                evicted = self.prefix.evict(demand)
                self.stats.prefix_evicted_blocks += len(evicted)
                self._scrub_blocks(evicted)
            if not self.allocator.can_admit(demand):
                if match is not None:
                    self.prefix.unpin(match)
                self.stats.block_waits += 1
                return False
        initial = min(self.allocator.blocks_for_tokens(
            len(rs.prompt) + self.width), demand)
        shared = match.blocks if match is not None else []
        cow_dst = None
        if match is not None and match.cow_block is not None:
            self.allocator.alloc(rs.rid, len(shared), reserve=demand,
                                 shared=shared)
            cow_dst = self.allocator.fork_cow(rs.rid, match.cow_block)
            self.allocator.extend(rs.rid, initial - len(shared) - 1)
        else:
            self.allocator.alloc(rs.rid, initial, reserve=demand,
                                 shared=shared)
        if match is not None:
            self.prefix.unpin(match)
            if match.n_tokens > 0:
                rs.stats.cached_prompt_tokens = match.n_tokens
                self.stats.prefix_hits += 1
                self.stats.prefix_hit_tokens += match.n_tokens
                self.stats.prefix_cow_forks += int(cow_dst is not None)
                self._hits[rs.rid] = (match.n_tokens, match.cow_block,
                                      cow_dst)
        table = self.allocator.table(rs.rid)
        self.tables[lane, :] = 0
        self.tables[lane, :len(table)] = table
        self._tables_dirty = True
        self.stats.peak_blocks = max(self.stats.peak_blocks,
                                     self.allocator.n_allocated)
        return True

    def _scrub_blocks(self, freed: Sequence[int]) -> None:
        """Zero freed blocks on device (hygiene) — only ids whose refcount
        actually reached zero may ever be passed here.  Chunked to the
        block-table width so one reset executable serves every call.

        Before the first prefill there is no cache to dispatch against:
        prefix-cache evictions made while claiming the initial cohort are
        queued and flushed right after cache creation (they used to be
        silently dropped under ``scrub_freed=True``)."""
        if not (self.scrub_freed and freed
                and self.fns.reset_blocks is not None):
            return
        if self.cache is None:
            self._scrub_backlog.extend(int(b) for b in freed)
            return
        bpl = self.fns.blocks_per_lane
        for i in range(0, len(freed), bpl):
            ids = np.zeros((bpl,), dtype=np.int32)
            chunk = freed[i:i + bpl]
            ids[:len(chunk)] = np.asarray(chunk, dtype=np.int32)
            self.cache = self.fns.reset_blocks(self.cache, ids)
        if self.sanitizer is not None:
            self.sanitizer.on_scrubbed(int(b) for b in freed)

    def _sync_tables(self) -> None:
        """Push host-side block-table edits into the device cache dict (the
        tables ride along as a regular input of every step fn).  The table
        is copied at once (into pinned memory on a card, then uploaded
        without waiting), so the upload neither blocks the host nor sees
        later host edits of ``self.tables``."""
        if (self.allocator is not None and self._tables_dirty
                and self.cache is not None):
            dev = self.cache["k"].device
            staged = torch.from_numpy(self.tables.copy())
            if dev.type == "cuda":
                staged = staged.pin_memory().to(dev, non_blocking=True)
            self.cache["block_tables"] = staged
            self._tables_dirty = False

    # ------------------------------------------------------------ lane params
    def _set_lane_params(self, lane: int, params: SamplingParams) -> None:
        self.lane_greedy[lane] = not params.sample
        self.lane_temp[lane] = params.temperature
        self.lane_seed[lane] = np.uint32(params.seed)

    def _lane_params_all(self):
        """(lanes,) per-lane sampling vectors for a full-batch device step."""
        return {"greedy": self.lane_greedy.copy(),
                "temp": self.lane_temp.copy(),
                "seed": self.lane_seed.copy()}

    @staticmethod
    def _lane_params_one(params: SamplingParams):
        """(1,) vectors for a single-lane ``prefill_into_slot``."""
        return {"greedy": np.asarray([not params.sample]),
                "temp": np.asarray([params.temperature], dtype=np.float32),
                "seed": np.asarray([np.uint32(params.seed)],
                                   dtype=np.uint32)}

    # ----------------------------------------------------------------- submit
    def submit(self, prompt: Sequence[int], max_new_tokens: int) -> int:
        """Queue a request under the session's default params (legacy
        positional surface); returns its request id."""
        params = dataclasses.replace(self._defaults,
                                     max_new_tokens=int(max_new_tokens))
        return self.submit_request(Request(prompt=list(prompt),
                                           params=params)).rid

    def submit_request(self, request: Request) -> "RequestHandle":
        """Queue a ``Request`` and return its streaming ``RequestHandle``
        (incremental token deltas, ``.result()``, ``.cancel()``)."""
        from repro_torch.serving.api import RequestHandle
        params = (request.params if request.params is not None
                  else self._defaults).validate()
        prompt = [int(t) for t in request.prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > self.prefill_len:
            raise ValueError(f"prompt length {len(prompt)} exceeds "
                             f"prefill_len={self.prefill_len}")
        if params.sample and self.fns.sampling == "greedy":
            raise ValueError(
                "this session was built with sampling='greedy' (argmax-only"
                " executables); rebuild with sampling='mixed' to serve "
                "sampled requests")
        if not self.fns.per_lane_params and (
                params.sample != self._defaults.sample
                or (params.sample
                    and (params.temperature != self._defaults.temperature
                         or params.seed != self._defaults.seed))):
            raise ValueError(
                "these StepFns predate per-lane sampling params; requests "
                "must keep the session-level sample/temperature/seed")
        if self.allocator is not None:
            demand = self._demand_blocks(len(prompt), params.max_new_tokens)
            if demand > self.allocator.capacity:
                raise ValueError(
                    f"request demands {demand} KV blocks; pool capacity is "
                    f"{self.allocator.capacity} (it could never be admitted "
                    "— deadlock)")
        policy = (params.draft if params.draft is not None
                  else self.default_policy).validate()
        self._resolve_sources(policy)   # unknown names fail at submit time
        rid = self.next_rid
        self.next_rid += 1
        request.rid = rid
        rs = RequestState(rid=rid, prompt=prompt,
                          max_new_tokens=params.max_new_tokens,
                          eos_id=self.eos_id, params=params,
                          draft=policy,
                          token_limit=cache_token_limit(
                              self.fns.max_seq_len, self.width, len(prompt)))
        if policy.adaptive and self.width > 1:
            rs.budget_ctl = AdaptiveBudget.from_policy(
                policy, min(self.config.decoding_length, self.width - 1))
        rs.submit_t = time.perf_counter()
        if self.sanitizer is not None:
            self.sanitizer.transition(rid, "queued")
        nsn = policy.namespace
        q = self.queues.get(nsn)
        if q is None:
            q = self.queues[nsn] = deque()
        if not q:
            # empty -> backlogged: a returning tenant resumes at the current
            # virtual time, not at credit hoarded while it was idle
            self._q_pass[nsn] = max(self._q_pass.get(nsn, 0.0), self._vtime)
        q.append(rs)
        self.stats.ns(nsn).submitted += 1
        self._order.append(rid)
        handle = RequestHandle(rs, self)
        self.handles[rid] = handle
        return handle

    # ------------------------------------------------------------------- loop
    def step(self) -> List[RequestResult]:
        """One scheduler iteration: admit into free lanes, then one masked
        decode step across all lanes.  Returns requests finished this call."""
        finished = self._admit()
        finished.extend(self._decode())
        return finished

    def run(self) -> List[RequestResult]:
        """Drain queue + lanes; results in submission order."""
        while not self.idle:
            self.step()
        if self.sanitizer is not None:
            self.sanitizer.verify_idle(self)
        return [self.results[rid] for rid in self._order
                if rid in self.results]

    # -------------------------------------------------------------- admission
    def _admit(self) -> List[RequestResult]:
        if self.cache is None and self.n_queued:
            return self._admit_initial_cohort()
        finished: List[RequestResult] = []
        fns = self.fns
        in_use = self._lanes_in_use()
        for lane in range(self.lanes):
            if lane in self._pending:
                continue
            while self.states[lane] is None:
                nsn = self._pick_ns(in_use)
                if nsn is None:
                    break
                rs = self.queues[nsn][0]
                if self.allocator is not None and \
                        not self._claim_blocks(rs, lane):
                    # not enough reservable blocks: ALL admission waits (the
                    # blocked head keeps its turn — bounded wait; no
                    # overtaking within or across tenants under backpressure,
                    # so losslessness stays order-free and nothing starves)
                    return finished
                self._take_queued(nsn)
                in_use[nsn] = in_use.get(nsn, 0) + 1
                rs.lane = lane
                rs.admit_t = time.perf_counter()
                self._set_lane_params(lane, rs.params)
                self._observe_prompt(rs)
                self._sync_tables()
                hit = self._hits.pop(rs.rid, None)
                if hit is not None:
                    # prefix-cache hit: COW-fork the boundary block if the
                    # match ends mid-block, then prefill only the uncached
                    # suffix (the shared blocks are already wired into the
                    # lane's table, so attention sees the full prefix)
                    n_cached, cow_src, cow_dst = hit
                    if cow_dst is not None:
                        self.cache = fns.copy_block(self.cache, cow_src,
                                                    cow_dst)
                    suffix = np.asarray([rs.prompt[n_cached:]],
                                        dtype=np.int32)
                    self.cache, chosen = fns.prefill_suffix(
                        self.cache, lane, suffix, n_cached,
                        lane_params=self._lane_params_one(rs.params))
                else:
                    toks = np.full((1, self.prefill_len), fns.pad_id,
                                   dtype=np.int32)
                    toks[0, :len(rs.prompt)] = np.asarray(rs.prompt,
                                                          dtype=np.int32)
                    plen = np.asarray([len(rs.prompt)], dtype=np.int32)
                    if fns.per_lane_params:
                        self.cache, chosen = fns.prefill_into_slot(
                            self.cache, lane, toks, plen,
                            lane_params=self._lane_params_one(rs.params))
                    else:
                        self.cache, chosen = fns.prefill_into_slot(
                            self.cache, lane, toks, plen)
                if self.overlap_drafts:
                    # leave the prefill in flight: its first-token pull is
                    # deferred until _decode has built the other lanes'
                    # drafts (host draft work overlaps the prefill)
                    self._pending[lane] = rs
                    self._pending_chosen[lane] = chosen
                    break
                if not self._settle(rs, int(self._pull(chosen)[0]), lane):
                    finished.append(self._finish(rs))
                    in_use[nsn] -= 1   # finished at prefill: lane still free
        return finished

    def _admit_initial_cohort(self) -> List[RequestResult]:
        """First admission: one batched (lanes, prefill_len) prefill builds
        the cache and fills as many lanes as the queue covers — the
        FLOPs-dense phase keeps its batching; per-slot prefill only pays for
        mid-flight admissions."""
        fns = self.fns
        cohort: List[RequestState] = []
        in_use: Dict[str, int] = {}
        while len(cohort) < self.lanes:
            nsn = self._pick_ns(in_use)
            if nsn is None:
                break
            rs = self.queues[nsn][0]
            if self.allocator is not None and \
                    not self._claim_blocks(rs, len(cohort)):
                break
            self._take_queued(nsn)
            in_use[nsn] = in_use.get(nsn, 0) + 1
            cohort.append(rs)
        if not cohort:
            return []
        toks = np.full((self.lanes, self.prefill_len), fns.pad_id,
                       dtype=np.int32)
        lens = np.ones((self.lanes,), dtype=np.int32)   # dummy rows: 1 pad
        now = time.perf_counter()
        for lane, rs in enumerate(cohort):
            rs.lane = lane
            rs.admit_t = now
            self._set_lane_params(lane, rs.params)
            self._observe_prompt(rs)
            toks[lane, :len(rs.prompt)] = np.asarray(rs.prompt,
                                                     dtype=np.int32)
            lens[lane] = len(rs.prompt)
        lane_kw = ({"lane_params": self._lane_params_all()}
                   if fns.per_lane_params else {})
        if self.allocator is not None:
            self.cache, chosen = fns.prefill(toks, lens, self.tables.copy(),
                                             **lane_kw)
            self._tables_dirty = False
        else:
            self.cache, chosen = fns.prefill(toks, lens, **lane_kw)
        if self._scrub_backlog:
            # prefix-cache evictions made while claiming THIS cohort (no
            # cache existed to scrub against): flush now that it does.  Ids
            # the cohort itself re-allocated are skipped — their rows were
            # just prefilled and a scrub would destroy live KV; only
            # still-free blocks carry stale rows worth zeroing.
            backlog = [b for b in self._scrub_backlog
                       if self.allocator.refcount(b) == 0]
            self._scrub_backlog.clear()
            self._scrub_blocks(backlog)
        chosen = self._pull(chosen)
        finished: List[RequestResult] = []
        for lane, rs in enumerate(cohort):
            if not self._settle(rs, int(chosen[lane]), lane):
                finished.append(self._finish(rs))
        return finished

    def _settle(self, rs: RequestState, first_token: int, lane: int) -> bool:
        """Common post-prefill bookkeeping; returns False if the request
        already finished at prefill (budget 1 / instant EOS) — its lane
        stays free for the next scheduler iteration."""
        rs.start(first_token)
        rs.first_token_t = time.perf_counter()
        rs.stats.host_syncs += 1        # the first-token pull
        self.stats.admitted += 1
        self._emit(rs, rs.output)
        if rs.done:
            self._observe_output(rs)
            return False
        if self.sanitizer is not None:
            self.sanitizer.transition(rs.rid, "active")
        self.states[lane] = rs
        self.lens[lane] = len(rs.prompt)
        return True

    # ----------------------------------------------------------------- decode
    def _build_tree(self, rs: RequestState):
        # adaptive lanes draft at their controller's current budget; the
        # remaining slots ride as padding (fixed W — no retrace).  The
        # namespace's draft-budget cap bounds it further (a hot tenant's
        # wide trees are host cost co-residents pay for), and the autotune
        # controller gates which sources retrieve at all — every knob here
        # is host-side draft construction, so outputs never change (I1) and
        # no compiled shape moves (I2).
        budget = (rs.budget_ctl.value if rs.budget_ctl is not None
                  else None)
        cap = self.draft_budget_caps.get(rs.draft.namespace)
        if cap is not None:
            budget = min(self.config.decoding_length if budget is None
                         else budget, cap)
        sources = self._resolve_sources(rs.draft)
        quotas = None
        if self.autotuner is not None and len(sources) > 1:
            eff = (self.config.decoding_length if budget is None else budget)
            eff = max(min(eff, self.width - 1), 1)
            base = [rs.draft.quota(i, eff) for i in range(len(sources))]
            keep, quotas = self.autotuner.select(
                rs.draft.namespace, [s.name for s in sources], base)
            sources = [sources[i] for i in keep]
            # fold the bandit's kept-quota total into the lane width: a
            # namespace whose sources are mostly gated off shrinks its tree
            # instead of padding dead slots.  With no explicit quotas each
            # kept source may fill the whole budget (total >= eff — no
            # shrink), so only provisioned policies are affected.
            total = sum(int(q) for q in quotas)
            if total < eff:
                if rs.budget_ctl is not None:
                    budget = rs.budget_ctl.cap(total)
                else:
                    budget = min(eff if budget is None else budget, total)
            elif rs.budget_ctl is not None:
                rs.budget_ctl.quota_cap = None   # sources recovered
        return build_draft_from_policy(
            sources, rs.draft, self.config, rs.rid,
            rs.context, self.fns.pad_id, self.width, budget=budget,
            quotas=quotas)

    def _decode(self) -> List[RequestResult]:
        fns, W = self.fns, self.width
        finished: List[RequestResult] = []
        if self.n_active == 0 and not self._pending:
            # nothing to step: flush deferred retirements so run() can end
            self._drain_retired(finished)
            return finished
        fused = fns.fused_step is not None
        t0 = time.perf_counter()
        # ---- host draft building.  In overlap mode any admission prefill
        # dispatched by _admit is still in flight here: draft retrieval /
        # merging for the established lanes runs behind that device work.
        trees: List = [None] * self.lanes
        for l in range(self.lanes):
            if self.states[l] is not None:
                trees[l] = self._build_tree(self.states[l])
        # settle deferred admissions (their first-token pull was hidden
        # behind the draft building above); a request finishing at prefill
        # leaves its lane free until the next scheduler iteration
        for lane in sorted(self._pending):
            rs = self._pending.get(lane)
            if rs is None:
                # cancelled out of _pending by a co-resident's stream
                # callback earlier in this very loop; its teardown is done
                # and its block free already rides in _retired
                continue
            chosen = self._pending_chosen[lane]
            if self._settle(rs, int(self._pull(chosen)[0]), lane):
                trees[lane] = self._build_tree(rs)
            elif rs.rid not in self.results:
                finished.append(self._finish(rs))
            # else: cancel() finalized it mid-settle (a stream callback of
            # its own first token); only its deferred block free remains
        self._pending.clear()
        self._pending_chosen.clear()
        active = [l for l in range(self.lanes) if self.states[l] is not None]
        if not active:
            self._drain_retired(finished)
            return finished
        # requests riding THIS step (captured before retirement clears
        # lanes): each accrues the step's measured wall-clock split — exact
        # per-step sums, not global means (satellite: telemetry skew)
        riders = [self.states[l] for l in active]
        for l in range(self.lanes):
            if trees[l] is None:
                trees[l] = idle_tree(W, fns.pad_id)
        tok = np.stack([t.tokens for t in trees])                     # (B,W)
        pos = (self.lens[:, None]
               + np.stack([t.depth for t in trees])).astype(np.int32)
        mask = np.stack([t.tree_mask for t in trees])                 # (B,W,W)
        self._sync_tables()
        lane_kw = ({"lane_params": self._lane_params_all()}
                   if fns.per_lane_params else {})
        t1 = time.perf_counter()
        drained = 0.0
        new_lens = self.lens.copy()
        if fused:
            # ---- single-dispatch hot path: tree forward + token choice +
            # device accept walk + commit in ONE jitted call; ONE packed
            # (B, 1+2W) pull crosses the host boundary per step.  The
            # device accepts untruncated; host-side truncation (budget /
            # EOS / stop) always retires the lane, so the extra committed
            # rows are garbage that is never attended (I3).
            parent = np.stack([t.parent for t in trees]).astype(np.int32)
            n_live = np.asarray(
                [t.n_slots if self.states[l] is not None else 0
                 for l, t in enumerate(trees)], dtype=np.int32)
            self.cache, packed = fns.fused_step(
                self.cache, self.lens, tok, pos, mask, parent, n_live,
                **lane_kw)
            if self._retired:
                # overlap window: the step is in flight — run the previous
                # step's deferred heavy retirement behind it
                td = time.perf_counter()
                self._drain_retired(finished)
                drained = time.perf_counter() - td
                self.stats.hidden_host_ms += drained * 1e3
            packed = self._pull(packed, decode=True)   # THE one sync point
            t2 = time.perf_counter()
            accepted = [packed[l, 1:1 + packed[l, 0]]
                        for l in range(self.lanes)]
            kv_slots = [packed[l, 1 + W:1 + W + packed[l, 0]]
                        for l in range(self.lanes)]
            for l in active:
                rs = self.states[l]
                n_before = len(rs.output)
                ks = rs.accept(accepted[l], kv_slots[l], trees[l].n_slots,
                               slot_sources=trees[l].slot_source)
                new_lens[l] += len(ks)
                rs.stats.host_syncs += 1
                self._emit(rs, rs.output[n_before:])
        else:
            # ---- legacy two-dispatch path (StepFns without fused_step):
            # chosen pull -> host accept walk -> commit -> new_lens pull
            if fns.per_lane_params:
                self.cache, chosen = fns.tree_step(
                    self.cache, self.lens, tok, pos, mask, **lane_kw)
            else:
                self.cache, chosen = fns.tree_step(self.cache, self.lens,
                                                   tok, pos, mask)
            chosen = self._pull(chosen, decode=True)
            t2 = time.perf_counter()
            accepted, kv_slots = verify_accept_batch(trees, chosen)
            gather = np.zeros((self.lanes, W), dtype=np.int32)
            n_acc = np.zeros((self.lanes,), dtype=np.int32)
            for l in active:
                rs = self.states[l]
                n_before = len(rs.output)
                ks = rs.accept(accepted[l], kv_slots[l], trees[l].n_slots,
                               slot_sources=trees[l].slot_source)
                gather[l, :len(ks)] = np.asarray(ks, dtype=np.int32)
                n_acc[l] = len(ks)
                rs.stats.host_syncs += 2
                self._emit(rs, rs.output[n_before:])
            self.cache, lens_dev = fns.commit(self.cache, self.lens, gather,
                                              n_acc)
            new_lens = self._pull(lens_dev, decode=True).astype(
                np.int32).copy()
        self.lens = new_lens
        self.stats.decode_steps += 1
        self.stats.active_lane_steps += len(active)
        for rs in riders:
            self.stats.ns(rs.draft.namespace).lane_steps += 1

        for l in active:
            rs = self.states[l]
            self._observe_output(rs)
            # backstop: the token-granular ``token_limit`` retires a request
            # BEFORE the cache can overflow (cache_token_limit — shared with
            # the lock-step loop so both retire at the same token); this
            # device-safety check stays as a last line against a mis-set cap
            if self.lens[l] + W >= fns.max_seq_len and not rs.done:
                rs.done = True
                rs.finish_reason = rs.finish_reason or "cache"
            if rs.done:
                if self.overlap_drafts:
                    # free the lane now; the heavy bookkeeping runs in the
                    # next step's in-flight window (_drain_retired)
                    self._release_lane(rs, l)
                else:
                    finished.append(self._finish(rs))
                    self.states[l] = None
                    self.lens[l] = 0
        if self.allocator is not None:
            self._extend_tables(active)
        t3 = time.perf_counter()
        hd = (t1 - t0) * 1e3
        dv = (t2 - t1 - drained) * 1e3
        ac = (t3 - t2) * 1e3
        hh = drained * 1e3
        self.stats.host_draft_ms += hd
        self.stats.device_step_ms += dv
        self.stats.accept_commit_ms += ac
        # per-request breakdown: every rider of this step accrues the step's
        # actual split (a short request co-resident with long ones reports
        # only the steps it rode — not a whole-run mean — and the hidden
        # host work drained behind its flight window is no longer dropped)
        for rs in riders:
            rst = rs.stats
            rst.host_draft_ms += hd
            rst.device_step_ms += dv
            rst.accept_commit_ms += ac
            rst.hidden_host_ms += hh
        if self.record_breakdown:
            self.step_breakdown.append({
                "step": self.stats.decode_steps,
                "active": len(active),
                "host_draft_ms": hd,
                "device_step_ms": dv,
                "accept_commit_ms": ac,
                "hidden_host_ms": hh,
                "syncs": 1 if fused else 2})
        return finished

    def _extend_tables(self, active: List[int]) -> None:
        """Grow surviving lanes' block tables to cover the next tree step
        (lens + W rows).  Never fails: admission reserved each request's
        worst-case demand up front."""
        W = self.width
        for l in active:
            rs = self.states[l]
            if rs is None:
                continue
            needed = self.allocator.blocks_for_tokens(int(self.lens[l]) + W)
            cur = self.allocator.n_blocks_of(rs.rid)
            if needed > cur:
                new = self.allocator.extend(rs.rid, needed - cur)
                self.tables[l, cur:needed] = new
                self._tables_dirty = True
        self.stats.peak_blocks = max(self.stats.peak_blocks,
                                     self.allocator.n_allocated)

    # ------------------------------------------------------------- streaming
    def _emit(self, rs: RequestState, delta: Sequence[int]) -> None:
        """Push this step's accepted-token delta to the request's handle."""
        if not delta:
            return
        h = self.handles.get(rs.rid)
        if h is not None:
            h._push(list(delta))
        for cb in self.callbacks.get(rs.rid, ()):
            cb(list(delta))

    # ----------------------------------------------------------------- cancel
    def cancel(self, rid: int) -> bool:
        """Cancel a request mid-flight (or while queued).

        An active request leaves through the regular retire path — trie
        elimination, block free (+ scrub under ``scrub_freed``), lane
        release — so co-resident requests are untouched (I1 is per-request).
        Returns False if the request already finished.
        """
        for q in self.queues.values():           # still queued: nothing held
            for i, rs in enumerate(q):
                if rs.rid == rid:
                    del q[i]
                    rs.cancel()
                    if self.sanitizer is not None:
                        # held nothing: queued requests retire directly
                        self.sanitizer.transition(rid, "retiring")
                        self.sanitizer.transition(rid, "drained")
                    rs.finish_t = time.perf_counter()
                    res = rs.result()
                    self.results[rid] = res
                    nst = self.stats.ns(rs.draft.namespace)
                    nst.cancelled += 1
                    self.callbacks.pop(rid, None)
                    h = self.handles.pop(rid, None)
                    if h is not None:
                        h._finalize(res)
                    return True
        for lane in range(self.lanes):
            rs = self.states[lane]
            if rs is not None and rs.rid == rid:
                rs.cancel()
                self._finish(rs)
                self.states[lane] = None
                self.lens[lane] = 0
                return True
        for lane, rs in list(self._pending.items()):
            # overlap mode: the admission prefill may still be IN FLIGHT on
            # device.  Tear down the host-visible side now (the handle's
            # cancel() must return a finalized result) but route the block
            # free through _retired/_drain_retired: freeing here would let a
            # same-iteration re-admission be handed these very block ids
            # while the in-flight prefill still writes into them
            # (use-after-free window — satellite bugfix).  The lane-keyed
            # cleanup runs now, like _release_lane: the lane may be
            # re-admitted before the deferred free drains.
            if rs.rid == rid:
                del self._pending[lane]
                del self._pending_chosen[lane]
                rs.cancel()
                if self.sanitizer is not None:
                    # retiring, NOT drained: the blocks stay owned until
                    # the deferred drain (the in-flight prefill may still
                    # write into them — a use-after-free window)
                    self.sanitizer.transition(rid, "retiring")
                rs.finish_t = time.perf_counter()
                rs.lane = -1
                if self.allocator is not None:
                    self.tables[lane, :] = 0
                    self._tables_dirty = True
                elif (self.scrub_freed and self.fns.reset_slot is not None
                        and self.cache is not None):
                    self.cache = self.fns.reset_slot(self.cache, lane)
                self._retire_sources(rs)
                self._finalize_result(rs)
                self._retired.append(rs)
                return True
        for i, rs in enumerate(self._retired):
            # already done, heavy retirement still deferred: finalize now so
            # the caller sees a result immediately
            if rs.rid == rid:
                self._finish_retire(self._retired.pop(i))
                return False
        return False

    # ----------------------------------------------------------------- retire
    def _release_lane(self, rs: RequestState, lane: int) -> None:
        """Overlap mode: free the lane for next-iteration admission NOW;
        the heavy bookkeeping (trie elimination, block free + scrub, handle
        finalize) is deferred into the next step's in-flight window.

        The lane-keyed pieces must run here — the lane may be re-admitted
        before the deferred work drains: the table row is zeroed (the
        physical blocks stay owned by this rid until the deferred free, so
        they cannot be reallocated in between) and the dense lane scrub
        fires (a scrub after reuse would destroy the next request's KV)."""
        if self.sanitizer is not None:
            self.sanitizer.transition(rs.rid, "retiring")
        rs.finish_t = time.perf_counter()
        rs.lane = -1
        self.states[lane] = None
        self.lens[lane] = 0
        if self.allocator is not None:
            self.tables[lane, :] = 0
            self._tables_dirty = True
        elif (self.scrub_freed and self.fns.reset_slot is not None
                and self.cache is not None):
            self.cache = self.fns.reset_slot(self.cache, lane)
        self._retired.append(rs)

    def _drain_retired(self, finished: List[RequestResult]) -> None:
        """Run the deferred heavy retirement work (overlap mode).  Called
        while the next step is in flight on device — or, when no step is in
        flight, before run() can go idle."""
        while self._retired:
            finished.append(self._finish_retire(self._retired.pop(0)))

    def _finish(self, rs: RequestState) -> RequestResult:
        """Immediate retire (serial mode, cancel, finish-at-prefill)."""
        if self.sanitizer is not None:
            self.sanitizer.transition(rs.rid, "retiring")
        rs.finish_t = time.perf_counter()
        lane = rs.lane
        rs.lane = -1
        if self.allocator is not None and lane >= 0:
            self.tables[lane, :] = 0
            self._tables_dirty = True
        elif (self.scrub_freed and self.fns.reset_slot is not None
                and lane >= 0 and self.cache is not None):
            self.cache = self.fns.reset_slot(self.cache, lane)
        return self._finish_retire(rs)

    def _finish_retire(self, rs: RequestState) -> RequestResult:
        # cancel() of a pending overlap admission already finalized the
        # host-visible side (result, handle, telemetry) — only the deferred
        # block free and scrub reach here, once, via _drain_retired
        already = rs.rid in self.results
        if not already:
            self._retire_sources(rs)
        if self.allocator is not None and self.allocator.owns(rs.rid):
            # Promote the prompt's blocks into the prefix cache BEFORE the
            # free: the tree takes its own reference on each adopted block,
            # so the free below just drops this request's reference and the
            # cached KV stays resident.  Cancelled requests may have been
            # torn down before their prefill landed — skip them.
            if self.prefix is not None and not rs.cancelled and rs.prompt:
                nb_prompt = self.allocator.blocks_for_tokens(len(rs.prompt))
                table = self.allocator.table(rs.rid)
                self._scrub_blocks(self.prefix.insert(
                    rs.prompt, table[:nb_prompt],
                    namespace=rs.draft.namespace))
            # free-list first, scrub second — but always BEFORE the next
            # admission can reach the allocator, so a scrub can never hit a
            # block that already belongs to a newly admitted request.
            # ``free`` returns ONLY refcount-zero blocks: ids still shared
            # with the prefix cache or a co-resident request are never
            # scrubbed or re-allocated here (satellite: refcount-aware
            # deferred retirement).
            freed = self.allocator.free(rs.rid)
            self._scrub_blocks(freed)
        if self.sanitizer is not None:
            self.sanitizer.transition(rs.rid, "drained")
        if already:
            return self.results[rs.rid]
        return self._finalize_result(rs)

    def _finalize_result(self, rs: RequestState) -> RequestResult:
        """Build + record the result, accrue the namespace's SLO slice,
        feed the autotune controller, finalize the handle."""
        res = rs.result()
        self.results[rs.rid] = res
        self.stats.finished += 1
        nst = self.stats.ns(rs.draft.namespace)
        nst.finished += 1
        if rs.cancelled:
            nst.cancelled += 1
        nst.tokens += len(rs.output)
        nst.latencies.append(res.latency_s)
        nst.ttfts.append(res.ttft_s)
        nst.queue_waits.append(res.queue_s)
        for k, v in rs.stats.source_drafted.items():
            nst.source_drafted[k] = nst.source_drafted.get(k, 0) + v
        for k, v in rs.stats.source_accepted.items():
            nst.source_accepted[k] = nst.source_accepted.get(k, 0) + v
        if self.autotuner is not None:
            # retire-time observation: the request's per-source counters are
            # complete, and the call is a pure function of token history —
            # deterministic, so autotune on/off stays bit-identical (I1)
            self.autotuner.observe(rs.draft.namespace,
                                   rs.stats.source_drafted,
                                   rs.stats.source_accepted)
        self.callbacks.pop(rs.rid, None)
        h = self.handles.pop(rs.rid, None)   # pop: a long-running server
        if h is not None:                    # must not accrete dead handles
            h._finalize(res)
        return res


__all__ = ["ContinuousScheduler", "NamespaceStats", "SchedulerStats"]
