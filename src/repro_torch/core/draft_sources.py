"""Pluggable draft sources (DESIGN.md §Draft sources).

The paper's trie retrieval is ONE member of a family of *lossless* draft
generators: any procedure that proposes candidate continuations is safe,
because the device tree step verifies every draft token against the model's
own choices (core/verify.py) — a bad draft costs slots, never correctness.
This module turns the speculation layer into a registry of such generators,
mirroring the attention-backend registry (repro_torch.models.attention):

  * ``DraftSource`` — the protocol: ``retrieve(rid, context, budget)``
    returns candidate branches, ``observe_prompt`` / ``observe_output`` feed
    it tokens, ``retire(rid)`` drops per-request state.
  * ``TrieSource`` — wraps the paper's ``TrieTree`` behind a namespace-scoped
    ``TrieForest`` (per-scenario tries, shared node-capacity accounting).
    The default source; with one namespace it is bit-identical to the old
    hardwired trie path.
  * ``PromptCopySource`` — LLMA-style ("Inference with Reference", Yang et
    al.): copy the continuation of the longest context-suffix match found
    earlier in the request's OWN prompt/output.  Strong on RAG /
    summarization workloads, and inherently per-request — nothing leaks into
    a shared structure.
  * ``NgramSource`` — ANPD-style (Ou et al.) adaptive order-k n-gram model
    with backoff, shared across requests; a cheap fallback when neither the
    trie nor the prompt has a match.
  * ``merge_branches`` — interleaves branches from several sources into one
    candidate list under the shared ``decoding_length`` token budget with
    per-source quotas and dedup against already-merged prefixes.
  * ``AdaptiveBudget`` — per-lane controller shrinking/growing a request's
    effective draft budget from its accepted-length EMA (paper §5.2
    warmup/CDL behavior; the compiled step width never changes).
  * ``DraftPolicy`` — the per-request spec (sources, quotas, trie namespace,
    adaptive on/off) carried on ``SamplingParams`` / ``EngineConfig``.

Everything here is host-side: the device ``StepFns`` are untouched, so every
source and every combination inherits the existing verification
losslessness (I1) and the compile-once shapes (I2).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .draft import BUILDERS, DraftTree, _finalize, repad
from .strategies import LookaheadConfig
from .trie import TrieForest, TrieTree

# (branches, scores): each branch is a root-path of draft tokens (excluding
# the committed context), scores rank branches for budget truncation — the
# contract of TrieTree.retrieve, now shared by every source.
Branches = Tuple[List[List[int]], List[float]]


# ----------------------------------------------------------------- DraftPolicy
@dataclass(frozen=True)
class DraftPolicy:
    """Per-request speculation spec (the API surface of this module).

    sources:   draft-source names tried in priority order (merge order).
    quotas:    per-source cap on NEW draft tokens contributed to one tree;
               () = every source may fill the whole budget (first come,
               first served under the round-robin interleave).
    namespace: trie scenario scope — requests in different namespaces never
               see each other's branches (TrieSource only; per-request and
               global sources ignore it).
    adaptive:  per-lane adaptive draft budget from the accepted-length EMA
               (paper §5.2 warmup/CDL); off = the full decoding_length every
               step.  min_budget / ema_alpha / headroom tune the controller.
    """
    sources: Tuple[str, ...] = ("trie",)
    quotas: Tuple[int, ...] = ()
    namespace: str = ""
    adaptive: bool = False
    min_budget: int = 4
    ema_alpha: float = 0.3
    headroom: float = 1.5

    def __post_init__(self):
        object.__setattr__(self, "sources",
                           tuple(str(s) for s in self.sources))
        object.__setattr__(self, "quotas",
                           tuple(int(q) for q in self.quotas))

    def validate(self) -> "DraftPolicy":
        if not self.sources:
            raise ValueError("DraftPolicy.sources is empty; every request "
                             "needs at least one draft source (use "
                             "strategy='none' for plain decoding)")
        if len(set(self.sources)) != len(self.sources):
            raise ValueError(f"duplicate draft sources in {self.sources}")
        known = available_sources()
        for name in self.sources:
            if name not in known:
                raise ValueError(f"unknown draft source {name!r} "
                                 f"(registry: {', '.join(known)})")
        if self.quotas and len(self.quotas) != len(self.sources):
            raise ValueError(
                f"quotas lists one cap per source: got {len(self.quotas)} "
                f"quotas for {len(self.sources)} sources")
        for q in self.quotas:
            if q < 1:
                raise ValueError(f"quota {q}: each source needs >= 1 slot "
                                 "(drop the source instead)")
        if self.min_budget < 1:
            raise ValueError(f"min_budget={self.min_budget}: need >= 1")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha={self.ema_alpha}: need (0, 1]")
        if self.headroom <= 0.0:
            raise ValueError(f"headroom={self.headroom}: need > 0")
        return self

    def quota(self, i: int, budget: int) -> int:
        """Source i's new-token cap for one tree of ``budget`` slots."""
        return min(self.quotas[i], budget) if self.quotas else budget


# ------------------------------------------------------------------- protocol
class DraftSource:
    """Base class / protocol of a lossless draft generator.

    Lifecycle (driven by the serving loop, slot-agnostic like the trie
    bookkeeping it generalizes):

        observe_prompt(rid, prompt)   at admission
        observe_output(rid, output)   after each accept (full output so far)
        retrieve(rid, context, budget=..)  before each tree step
        retire(rid)                   at retirement (free per-request state)

    ``namespace`` scopes shared state per scenario; sources without shared
    state may ignore it.  Implementations must be deterministic pure
    functions of their observed-token history — branch CONTENT never affects
    outputs (verification is lossless), but determinism keeps perf runs
    reproducible.
    """

    name = "null"

    def __init__(self, config: LookaheadConfig):
        self.config = config

    # ---- lifecycle
    def observe_prompt(self, rid: int, prompt: Sequence[int],
                       namespace: str = "") -> None:
        pass

    def observe_output(self, rid: int, output: Sequence[int],
                       namespace: str = "") -> None:
        pass

    def retire(self, rid: int, namespace: str = "") -> None:
        pass

    # ---- retrieval
    def retrieve(self, rid: int, context: Sequence[int], *, budget: int,
                 namespace: str = "") -> Branches:
        return [], []

    # ---- warm-state persistence (repro.fleet)
    # Shared (cross-request) statistics only: per-request state dies with the
    # request and must never be serialized.  Sources with no shared state
    # return {} and accept only {} back — a stateless source presented with a
    # donor payload signals a source-name collision, not a silent no-op.
    def state_dict(self) -> Dict[str, object]:
        return {}

    def load_state_dict(self, state: Dict[str, object]) -> None:
        if state:
            raise ValueError(
                f"draft source {self.name!r} holds no shared state but was "
                f"given a non-empty warm-state payload")

    def merge_state(self, state: Dict[str, object]) -> None:
        self.load_state_dict(state)


# ------------------------------------------------------------------ TrieSource
class TrieSource(DraftSource):
    """The paper's trie retrieval behind the DraftSource protocol.

    Wraps a ``TrieForest``: the default namespace ``""`` is the old global
    trie (bit-identical behavior — same inserts, same windows, same
    retire-time prune trigger), additional namespaces isolate co-resident
    scenarios while sharing the one node-capacity budget.
    """

    name = "trie"

    def __init__(self, config: LookaheadConfig,
                 trie: Optional[TrieTree] = None):
        super().__init__(config)
        self.forest = TrieForest(capacity=config.trie_capacity,
                                 prompt_boost=config.prompt_boost,
                                 decay=config.decay, root=trie)
        self._upto: Dict[int, int] = {}   # rid -> output tokens streamed in

    @property
    def trie(self) -> TrieTree:
        """Default-namespace trie (compat: warmup, stats, tests)."""
        return self.forest.tree("")

    def observe_prompt(self, rid, prompt, namespace=""):
        if self.config.insert_prompt:
            self.forest.tree(namespace).insert_ngrams(
                prompt, self.config.branch_length, request_id=rid)
            self.forest.check_capacity()

    def observe_output(self, rid, output, namespace=""):
        """Generated-branch streaming (paper Algorithm 1 lines 5-9): insert
        the window since the last high-water mark, overlapped by one branch
        length so n-grams straddling the previous boundary exist too."""
        if not self.config.insert_output:
            return
        lo = max(self._upto.get(rid, 0) - self.config.branch_length, 0)
        if len(output) - lo >= 2:
            self.forest.tree(namespace).insert_ngrams(
                output[lo:], self.config.branch_length)
            self._upto[rid] = len(output)
            self.forest.check_capacity()

    def retire(self, rid, namespace=""):
        """Branch Eliminating within the request's own namespace, then the
        shared capacity-triggered prune (identical cadence to the old
        ``trie_retire`` when one namespace exists)."""
        self._upto.pop(rid, None)
        if self.config.eliminate:
            t = self.forest.get(namespace)
            if t is not None:
                t.eliminate(rid)
        if self.config.prune and len(self.forest) > self.forest.capacity:
            self.forest.prune_all()

    def retrieve(self, rid, context, *, budget, namespace=""):
        t = self.forest.get(namespace)
        if t is None:
            return [], []
        return t.retrieve(context, decoding_length=budget,
                          max_prefix_len=self.config.max_prefix_len,
                          min_matched_tokens=self.config.min_matched_tokens)

    # ---- warm-state persistence
    def state_dict(self):
        return {"kind": self.name, "forest": self.forest.state_dict()}

    def _forest_state(self, state) -> Dict[str, object]:
        if not isinstance(state, dict) or state.get("kind") != self.name:
            raise ValueError(f"not a {self.name!r} source state: "
                             f"{type(state).__name__}")
        forest = state.get("forest")
        if not isinstance(forest, dict):
            raise ValueError("trie source state missing 'forest'")
        return forest

    def load_state_dict(self, state):
        self.forest.load_state_dict(self._forest_state(state))

    def merge_state(self, state):
        self.forest.merge_state(self._forest_state(state))


# ------------------------------------------------------------ PromptCopySource
class PromptCopySource(DraftSource):
    """LLMA-style longest-suffix copy from the request's own prompt/context.

    RAG and summarization responses quote their reference documents — which
    already sit in the request's context.  Retrieval matches the longest
    suffix of the context (down to ``copy_min_match`` tokens) against every
    EARLIER occurrence in that same context and proposes each occurrence's
    continuation as a branch, most recent sites first.

    Entirely per-request: nothing is inserted into any shared structure, so
    a prompt-copy tenant can never pollute the trie of its co-residents.
    The context passed to ``retrieve`` is prompt ⧺ output, so no observe
    state is needed at all — the request carries its own reference.
    """

    name = "prompt_copy"

    def retrieve(self, rid, context, *, budget, namespace=""):
        cfg = self.config
        ctx = [int(t) for t in context]
        n = len(ctx)
        min_match = max(cfg.copy_min_match, 1)
        if n < min_match + 1:
            return [], []
        branch_len = min(cfg.branch_length, budget)
        if branch_len < 1:
            return [], []
        # ONE pass over the context: find every site where the min-match
        # suffix ends (j == n is the suffix itself — search strictly
        # earlier), then extend each match backward up to max_prefix_len.
        # This runs per lane per decode step; the per-length rescans of the
        # naive multi-stage search are O(max_prefix_len) passes too many.
        max_match = min(cfg.max_prefix_len, n - 1)
        last = ctx[n - 1]
        sites: List[Tuple[int, int]] = []      # (match_len, end position)
        for j in range(n - 1, min_match - 1, -1):
            if ctx[j - 1] != last:             # cheap reject before slicing
                continue
            if ctx[j - min_match:j] != ctx[n - min_match:]:
                continue
            length = min_match
            while (length < max_match and j - length - 1 >= 0
                   and ctx[j - length - 1] == ctx[n - length - 1]):
                length += 1
            sites.append((length, j))
        if not sites:
            return [], []
        # longest match first (most context agreement), then most recent
        sites.sort(key=lambda s: (-s[0], -s[1]))
        branches, scores = [], []
        for rank, (length, j) in enumerate(sites[:cfg.copy_max_branches]):
            cont = ctx[j:j + branch_len]
            if cont:
                branches.append(cont)
                # small recency tie-break keeps ordering deterministic
                scores.append(float(length) - 1e-3 * rank)
        return (branches, scores) if branches else ([], [])


# ----------------------------------------------------------------- NgramSource
class NgramSource(DraftSource):
    """ANPD-style adaptive n-gram fallback (shared across requests).

    Maintains backoff count tables of order 1..k-1 over every observed
    prompt/output token and drafts one greedy highest-count chain.  Where
    the trie needs an exact suffix hit and prompt-copy needs a literal
    earlier occurrence, the n-gram model generalizes across requests — a
    low-precision, always-available source meant to ride along under a
    small quota.  The count table is capped (``ngram_max_entries``) with
    halving decay, mirroring the trie's node pruning.
    """

    name = "ngram"

    def __init__(self, config: LookaheadConfig):
        super().__init__(config)
        self.order = max(int(config.ngram_order), 2)
        self._counts: Dict[Tuple[int, ...], Dict[int, float]] = {}
        self._upto: Dict[int, int] = {}

    def _decay(self) -> None:
        for key in list(self._counts):
            d = self._counts[key]
            for t in list(d):
                d[t] *= 0.5
                if d[t] < 1.0:
                    del d[t]
            if not d:
                del self._counts[key]

    def _absorb(self, tokens: Sequence[int], start: int = 1) -> None:
        """Count every n-gram ENDING at index >= ``start`` (conditioning
        contexts may reach before it — that is why callers pass an
        overlapped window — but each ending position is counted once)."""
        toks = [int(t) for t in tokens]
        k = self.order
        for i in range(max(int(start), 1), len(toks)):
            for o in range(1, k):
                if i - o < 0:
                    break
                key = tuple(toks[i - o:i])
                d = self._counts.get(key)
                if d is None:
                    if len(self._counts) >= self.config.ngram_max_entries:
                        self._decay()
                    d = self._counts.setdefault(key, {})
                d[toks[i]] = d.get(toks[i], 0.0) + 1.0

    def observe_prompt(self, rid, prompt, namespace=""):
        self._absorb(prompt)

    def observe_output(self, rid, output, namespace=""):
        # window back by ``order`` so grams straddling the previous boundary
        # get their full conditioning context, but count only NEW endings
        # (>= the high-water mark — unlike the trie's frequency semantics,
        # a count table must not double-count the overlap)
        upto = self._upto.get(rid, 0)
        if len(output) <= max(upto, 1):
            return
        lo = max(upto - self.order, 0)
        self._absorb(output[lo:], start=upto - lo)
        self._upto[rid] = len(output)

    def retire(self, rid, namespace=""):
        self._upto.pop(rid, None)   # the model itself persists (adaptivity)

    def _predict(self, ctx: List[int]) -> Optional[int]:
        for o in range(self.order - 1, 0, -1):
            if len(ctx) < o:
                continue
            d = self._counts.get(tuple(ctx[-o:]))
            if d:
                # deterministic: highest count, lowest token id on ties
                return max(d.items(), key=lambda kv: (kv[1], -kv[0]))[0]
        return None

    def retrieve(self, rid, context, *, budget, namespace=""):
        cur = [int(t) for t in context]
        chain: List[int] = []
        for _ in range(min(self.config.branch_length, budget)):
            nxt = self._predict(cur)
            if nxt is None:
                break
            chain.append(nxt)
            cur.append(nxt)
        if not chain:
            return [], []
        return [chain], [1.0]

    # ---- warm-state persistence
    def state_dict(self):
        # tuple keys -> nested lists (JSON-portable); insertion order kept
        return {"kind": self.name, "order": self.order,
                "entries": [[list(key), [[int(t), float(c)]
                                         for t, c in d.items()]]
                            for key, d in self._counts.items()]}

    @staticmethod
    def _state_entries(state) -> List[list]:
        if not isinstance(state, dict) or state.get("kind") != "ngram":
            raise ValueError(f"not an ngram source state: "
                             f"{type(state).__name__}")
        entries = state.get("entries")
        if not isinstance(entries, list):
            raise ValueError("ngram source state missing 'entries'")
        return entries

    def load_state_dict(self, state):
        entries = self._state_entries(state)
        counts: Dict[Tuple[int, ...], Dict[int, float]] = {}
        for key, pairs in entries:
            counts[tuple(int(t) for t in key)] = {
                int(t): float(c) for t, c in pairs}
        self._counts = counts

    def merge_state(self, state):
        """Count-max merge (the same CRDT-join semantics as the trie, so
        repeated gossip echoes never inflate counts); halving decay
        restores the entry cap (the same pressure valve ``_absorb``
        applies to organic growth)."""
        entries = self._state_entries(state)
        for key, pairs in entries:
            d = self._counts.setdefault(tuple(int(t) for t in key), {})
            for t, c in pairs:
                d[int(t)] = max(d.get(int(t), 0.0), float(c))
        while len(self._counts) > self.config.ngram_max_entries:
            before = len(self._counts)
            self._decay()
            if len(self._counts) >= before:
                break


# ------------------------------------------------------------------- registry
_REGISTRY: Dict[str, Callable[..., DraftSource]] = {}


def register_source(name: str, factory: Callable[..., DraftSource]) -> None:
    """Register a source factory ``factory(config) -> DraftSource`` under
    ``name`` (last wins, like the attention-backend registry)."""
    _REGISTRY[name] = factory


def make_source(name: str, config: LookaheadConfig, **kwargs) -> DraftSource:
    try:
        factory = _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown draft source {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None
    return factory(config, **kwargs)


def available_sources() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_source("trie", TrieSource)
register_source("prompt_copy", PromptCopySource)
register_source("ngram", NgramSource)


# --------------------------------------------------------------------- merger
def _known_prefix_len(path: Tuple[int, ...], prefixes: set) -> int:
    """Longest leading prefix of ``path`` already merged (prefix membership
    is monotone — every merged branch registered ALL its prefixes)."""
    d = len(path)
    while d > 0 and path[:d] not in prefixes:
        d -= 1
    return d


def merge_branches(per_source: Sequence[Tuple[str, List[List[int]],
                                              List[float]]],
                   budget: int, quotas: Sequence[int]
                   ) -> Tuple[List[List[int]], List[float], List[str]]:
    """Interleave branches from several sources into one candidate list.

    Round-robin over sources in policy order: each turn a source contributes
    its next branch that still adds NEW tokens (dedup against every
    already-merged prefix — a trie branch that prompt-copy already proposed
    costs nothing and is skipped).  A branch's cost is its new-token count;
    it is charged against the source's ``quota`` and the shared ``budget``,
    and truncated to whatever still fits.  Returns (branches, scores,
    source_tags) ready for the tree builders.
    """
    S = len(per_source)
    prefixes: set = set()
    out_b: List[List[int]] = []
    out_s: List[float] = []
    out_t: List[str] = []
    ptr = [0] * S
    used = [0] * S
    total = 0
    progressed = True
    while total < budget and progressed:
        progressed = False
        for si in range(S):
            if total >= budget:
                break
            name, branches, scores = per_source[si]
            while ptr[si] < len(branches):
                path = tuple(int(t) for t in branches[ptr[si]])
                score = (float(scores[ptr[si]])
                         if ptr[si] < len(scores) else 0.0)
                ptr[si] += 1
                known = _known_prefix_len(path, prefixes)
                cost = len(path) - known
                if cost == 0:
                    continue            # fully covered already — dedup skip
                allow = min(quotas[si] - used[si], budget - total)
                if allow <= 0:
                    ptr[si] = len(branches)     # quota spent: source done
                    break
                if cost > allow:
                    path = path[:known + allow]
                    cost = allow
                for d in range(known + 1, len(path) + 1):
                    prefixes.add(path[:d])
                out_b.append(list(path))
                out_s.append(score)
                out_t.append(name)
                used[si] += cost
                total += cost
                progressed = True
                break                   # one contribution per turn
    return out_b, out_s, out_t


# ----------------------------------------------------------- adaptive budget
class AdaptiveBudget:
    """Per-lane draft-budget controller (paper §5.2 warmup/CDL behavior).

    The compiled step width T never changes — the controller only bounds how
    many draft tokens the HOST builds into the tree; the remaining slots
    ride as padding (never verified).  Shrinking therefore never retraces
    (I2) and never changes outputs (I1: verification is lossless for any
    draft) — it trades draft-build/verify work and acceptance odds.

    Warmup: start at ``min_budget`` (a cold trie earns nothing from a wide
    tree).  After each step the accepted-length EMA scales the budget by
    ``headroom`` — accept runs near the budget push it up toward
    ``max_budget``; dry steps decay it back toward the floor.
    """

    def __init__(self, max_budget: int, *, min_budget: int = 4,
                 alpha: float = 0.3, headroom: float = 1.5):
        self.max_budget = max(int(max_budget), 1)
        self.min_budget = min(max(int(min_budget), 1), self.max_budget)
        self.alpha = float(alpha)
        self.headroom = float(headroom)
        self.ema: Optional[float] = None
        self.value = self.min_budget
        # autotune quota ceiling (see ``cap``); None = unconstrained
        self.quota_cap: Optional[int] = None

    @classmethod
    def from_policy(cls, policy: DraftPolicy,
                    max_budget: int) -> "AdaptiveBudget":
        return cls(max_budget, min_budget=policy.min_budget,
                   alpha=policy.ema_alpha, headroom=policy.headroom)

    def update(self, accepted_len: int) -> int:
        a = float(accepted_len)
        self.ema = a if self.ema is None else (
            (1.0 - self.alpha) * self.ema + self.alpha * a)
        want = int(math.ceil(self.ema * self.headroom))
        self.value = min(max(want, self.min_budget), self.max_budget)
        if self.quota_cap is not None:
            self.value = min(self.value, self.quota_cap)
        return self.value

    def cap(self, quota_total: int) -> int:
        """Clamp the lane's width to the autotune bandit's kept-quota total.

        A namespace whose sources are mostly gated off cannot fill a wide
        tree — the kept sources' quotas bound the useful slot count, so the
        lane shrinks instead of padding dead slots.  The ceiling overrides
        ``min_budget`` (a probe-only lane should draft exactly the probe
        quota) and is refreshed every gated build, so a recovering source
        lifts it again.  Host-side only: outputs stay bit-identical (I1).
        """
        self.quota_cap = max(int(quota_total), 1)
        self.value = min(self.value, self.quota_cap)
        return self.value


# ----------------------------------------------------------------- tree build
def build_draft_from_policy(sources: Sequence[DraftSource],
                            policy: DraftPolicy, cfg: LookaheadConfig,
                            rid: int, context: Sequence[int], pad_id: int,
                            width: int,
                            budget: Optional[int] = None,
                            quotas: Optional[Sequence[int]] = None
                            ) -> DraftTree:
    """Retrieve from every policy source, merge, and build one ``DraftTree``
    padded to exactly ``width`` slots.

    The single-source path feeds retrieval straight into the strategy
    builder — for the default policy (TrieSource alone, full budget) the
    produced tree is identical, slot for slot, to the old hardwired
    ``build_draft_tree``.

    ``quotas`` overrides the policy's per-source caps (parallel to
    ``sources``) — the autotune controller passes the gated subset of a
    policy's sources with its own quota decisions (core/autotune.py).
    """
    root = int(context[-1])
    eff = cfg.decoding_length if budget is None else int(budget)
    eff = min(eff, max(width - 1, 0))
    if cfg.strategy == "none" or eff <= 0 or width <= 1:
        return _finalize([root], [-1], max(width, 1), pad_id)
    ns = policy.namespace
    if len(sources) == 1:
        src = sources[0]
        # a single-source quota still caps the tree (same semantics as the
        # merge path, where the quota bounds the source's new-token spend)
        eff = min(eff, policy.quota(0, eff) if quotas is None
                  else min(int(quotas[0]), eff))
        branches, scores = src.retrieve(rid, context, budget=eff,
                                        namespace=ns)
        tags: List[str] = [src.name] * len(branches)
    else:
        per = [(s.name,) + tuple(s.retrieve(rid, context, budget=eff,
                                            namespace=ns))
               for s in sources]
        caps = ([policy.quota(i, eff) for i in range(len(sources))]
                if quotas is None
                else [min(int(q), eff) for q in quotas])
        branches, scores, tags = merge_branches(per, eff, caps)
    tree = BUILDERS[cfg.strategy](root, branches, scores, eff, pad_id,
                                  sources=tags)
    return repad(tree, width, pad_id)


__all__ = ["DraftPolicy", "DraftSource", "TrieSource", "PromptCopySource",
           "NgramSource", "register_source", "make_source",
           "available_sources", "merge_branches", "AdaptiveBudget",
           "build_draft_from_policy"]
