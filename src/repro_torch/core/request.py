"""Per-request serving primitives shared by the lock-step loop and the
continuous-batching scheduler.

The lookahead step decomposes into host-side pieces that are *per request*
(draft build, verify/accept bookkeeping, trie updates) and device pieces
that are *per batch* (``StepFns``).  ``RequestState`` owns the former so a
request can live in any slot of any serving loop: the lock-step
``LookaheadEngine.generate_batch_lockstep`` and the slot-based
``repro_torch.serving.scheduler.ContinuousScheduler`` drive the exact same state
transitions, which is what makes per-request losslessness independent of
batch composition (see DESIGN.md §Scheduler).

Lifecycle::

    submitted --admit--> prefilled (start) --accept*--> done (retire)

``start`` consumes the prefill's chosen root token; every subsequent
``accept`` consumes the verified tokens of one tree step and returns the KV
slot indices to commit (truncated at the request's budget / EOS).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .draft import BUILDERS, DraftTree, _finalize, repad
from .draft_sources import AdaptiveBudget, DraftPolicy
from .strategies import LookaheadConfig
from .trie import TrieTree


# ----------------------------------------------------------- request surface
@dataclass(frozen=True)
class SamplingParams:
    """Per-request generation parameters (the request-centric API surface).

    One co-batched scheduler run may mix greedy and sampled requests at
    distinct temperatures/seeds: the device step takes per-lane
    (greedy, temperature, seed) vectors as traced inputs, so honoring these
    never retraces (I2).  Sampled streams are position-keyed off ``seed``
    (Gumbel key = fold_in(key(seed), absolute position)), which keeps
    losslessness (I1): the token at output position p is a pure function of
    (seed, p, logits), independent of batching or accept granularity.

    ``stop_token_ids`` behave like extra EOS ids (the stop token is kept in
    the output).  ``stop_sequences`` are token-id subsequences matched
    against the *generated output* host-side, token by token, AFTER each
    multi-token accept — a tree step may verify past the match, but the
    output is truncated to exactly what step-by-step decoding through the
    same params would have emitted (the matched sequence is kept).
    """
    max_new_tokens: int = 64
    sample: bool = False
    temperature: float = 1.0
    seed: int = 0
    stop_token_ids: Tuple[int, ...] = ()
    stop_sequences: Tuple[Tuple[int, ...], ...] = ()
    # speculation spec: which draft sources feed this request's trees, their
    # quotas, the trie namespace, adaptive budget on/off.  None = the
    # engine's default policy.  Drafts never change outputs (verification is
    # lossless), so this knob is pure performance/isolation — it is safe to
    # vary per request inside one lane pool.
    draft: Optional[DraftPolicy] = None

    def __post_init__(self):
        # normalize list inputs so params hash/compare by value
        object.__setattr__(self, "stop_token_ids",
                           tuple(int(t) for t in self.stop_token_ids))
        object.__setattr__(self, "stop_sequences",
                           tuple(tuple(int(t) for t in s)
                                 for s in self.stop_sequences))

    def validate(self) -> "SamplingParams":
        if self.max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens={self.max_new_tokens}: must be >= 1 (the "
                "prefill itself emits the first token)")
        if self.sample and self.temperature <= 0:
            raise ValueError(
                f"temperature={self.temperature}: sampled requests need a "
                "positive temperature (use sample=False for greedy)")
        for s in self.stop_sequences:
            if not s:
                raise ValueError("empty stop sequence (would match "
                                 "everywhere); drop it or pass tokens")
        if self.draft is not None:
            self.draft.validate()
        return self


@dataclass
class Request:
    """A serving request: prompt + params + caller metadata.

    ``params=None`` means "the engine's session defaults" — resolved at
    submit time, so the same Request object is portable across engines.
    ``rid`` is assigned by the scheduler at submit; ``metadata`` is carried
    through untouched (SLO tags, trace ids, ...).
    """
    prompt: List[int]
    params: Optional[SamplingParams] = None
    metadata: Dict[str, Any] = field(default_factory=dict)
    rid: int = -1


@dataclass
class StepFns:
    """Device functions the serving loops drive (all jit-compiled, fixed
    shapes — one compile per engine; see DESIGN.md §Compile-once shapes).

    prefill(tokens(B,S) i32, lens(B,) i32) -> (cache, chosen_root(B,) i32)
    tree_step(cache, cache_lens(B,), tokens(B,T), pos(B,T), mask(B,T,T))
        -> (cache, chosen(B,T) i32)
    commit(cache, cache_lens(B,), gather_idx(B,T), n_accept(B,))
        -> (cache, new_lens(B,))
    fused_step(cache, cache_lens(B,), tokens(B,T), pos(B,T), mask(B,T,T),
               parent(B,T), n_live(B,)) -> (cache, packed(B, 1+2T) i32)
        — optional single-dispatch decode step: tree forward + token choice
        + device accept walk + commit, returning one packed array
        ``[n_acc | acc_tokens(T) | kv_slots(T)]`` per lane instead of
        logits/chosen crossing the host boundary (DESIGN.md §Step
        pipeline).  ``n_live`` is the lane's live draft-slot count
        (0 = idle placeholder lane, accepts nothing).  The scheduler
        prefers it when present; ``tree_step``/``commit`` stay as the
        unfused parity oracle and the lock-step loop's surface.

    Slot-serving extensions (optional; required by ContinuousScheduler):

    init_cache(lanes) -> cache                      — allocate a B-lane cache
    prefill_into_slot(cache, lane, tokens(1,S), lens(1,))
        -> (cache, chosen_root(1,))                 — admit one request
    reset_slot(cache, lane) -> cache                — zero a freed lane
    prefill_len: fixed prompt pad length (compile prefill once); None keeps
        the legacy pad-to-batch-max behaviour.

    Paged-KV extensions (kv_layout == "paged"; DESIGN.md §Paged KV cache):
    the cache dict additionally carries per-lane ``block_tables`` the
    scheduler maintains through a host-side BlockAllocator; ``prefill``
    takes them as a third argument (the cache does not exist yet at cohort
    admission), and lane-keyed ``reset_slot`` is replaced by the
    block-keyed ``reset_blocks(cache, block_ids) -> cache`` (scrubbing by
    lane after a table was reused would destroy the next request's KV).
    """
    prefill: Callable
    tree_step: Callable
    commit: Callable
    slots: int            # T = 1 + decoding_length
    max_seq_len: int
    pad_id: int = 0
    fused_step: Optional[Callable] = None
    init_cache: Optional[Callable] = None
    prefill_into_slot: Optional[Callable] = None
    reset_slot: Optional[Callable] = None
    prefill_len: Optional[int] = None
    kv_layout: str = "dense"
    block_size: int = 0               # paged: KV rows per block
    n_blocks: Optional[int] = None    # paged: pool size (None = dense-equiv)
    reset_blocks: Optional[Callable] = None
    # Prefix-cache extensions (paged only; DESIGN.md §Prefix cache):
    # prefill_suffix(cache, lane, tokens(1,n), offset) -> (cache, chosen(1,))
    #     — prefill only the uncached prompt tail, attending the shared
    #     prefix blocks already wired into the lane's block table; the
    #     wrapper pads n up to a fixed suffix bucket (compile-once).
    # copy_block(cache, src, dst) -> cache — COW fork of a boundary block.
    prefill_suffix: Optional[Callable] = None
    copy_block: Optional[Callable] = None
    suffix_buckets: Tuple[int, ...] = ()
    # --- request-centric API extensions
    # per_lane_params: prefill/prefill_into_slot/tree_step accept a trailing
    # ``lane_params`` dict of (B,) device vectors {greedy, temp, seed} so one
    # co-batched step honors mixed per-request SamplingParams without
    # retracing.  False = legacy session-level constants only; the scheduler
    # then rejects requests whose params deviate from ``session_defaults``.
    per_lane_params: bool = False
    # session-level defaults applied to requests submitted without params
    # (max_new_tokens is a per-call override; see scheduler.submit)
    session_defaults: Optional["SamplingParams"] = None
    # "mixed" = per-request greedy/sample honored; "greedy" = argmax-only
    # session (skips the sampling lane entirely — fastest pure-greedy path)
    sampling: str = "mixed"

    @property
    def default_params(self) -> "SamplingParams":
        return self.session_defaults or SamplingParams()

    @property
    def supports_slot_serving(self) -> bool:
        return (self.prefill_into_slot is not None
                and self.init_cache is not None)

    @property
    def blocks_per_lane(self) -> int:
        """Block-table width for the paged layout (0 when dense)."""
        if self.kv_layout != "paged" or not self.block_size:
            return 0
        return -(-self.max_seq_len // self.block_size)


@dataclass
class GenStats:
    steps: int = 0
    tokens: int = 0
    dropped_slots: int = 0    # draft tokens computed but rejected
    # per-draft-source speculation telemetry (paper Table 3-style reporting
    # + the adaptive controller's input): how many draft tokens each source
    # placed into trees, and how many of those the model verified.  The one
    # free token per step (the model's own root prediction) belongs to no
    # source, so sum(source_accepted) == tokens - steps when every slot is
    # tagged.
    source_drafted: Dict[str, int] = field(default_factory=dict)
    source_accepted: Dict[str, int] = field(default_factory=dict)
    # per-step latency breakdown (scheduler runs only): each decode step's
    # measured wall-clock split accrues onto EVERY request riding that step
    # — exact per-step sums, not batch-level means, so co-resident requests
    # of different lengths report their own step mix.  host_syncs counts
    # device->host pulls attributed to it (fused path: exactly one per
    # decode step it participated in).
    host_draft_ms: float = 0.0     # draft build + tree packing per step
    device_step_ms: float = 0.0    # dispatch -> packed result on host
    accept_commit_ms: float = 0.0  # accept bookkeeping + retire + tables
    hidden_host_ms: float = 0.0    # deferred retirement drained behind the
    #                                step's device flight window (overlap)
    host_syncs: int = 0
    # prompt tokens served from the prefix cache (prefill compute skipped)
    cached_prompt_tokens: int = 0

    @property
    def edl(self) -> float:
        """Mean accepted tokens per step (paper: effective decoding length)."""
        return self.tokens / max(self.steps, 1)

    def source_acceptance(self) -> Dict[str, float]:
        """Accepted / drafted rate per source (0.0 when nothing drafted)."""
        return {name: self.source_accepted.get(name, 0) / max(n, 1)
                for name, n in self.source_drafted.items()}


@dataclass
class RequestResult:
    tokens: List[int]
    stats: GenStats
    rid: int = -1
    latency_s: float = 0.0    # submit -> finish (scheduler runs only)
    ttft_s: float = 0.0       # submit -> first token (scheduler runs only)
    queue_s: float = 0.0      # submit -> admission (scheduler runs only)
    # why generation ended: "eos" | "stop" (stop token/sequence) | "length"
    # (max_new_tokens) | "cache" (KV capacity) | "cancelled"
    finish_reason: str = ""
    cancelled: bool = False


@dataclass
class RequestState:
    """Host-side state of one in-flight request (slot-agnostic)."""
    rid: int
    prompt: List[int]
    max_new_tokens: int
    eos_id: int = -1
    params: Optional[SamplingParams] = None
    # token-granular KV-capacity budget: max output tokens the cache can
    # commit before the next tree step would scatter past max_seq_len
    # (= max_seq_len - width - len(prompt) + 1, set by the serving loop).
    # Retirement at this cap is per-TOKEN, so the truncation point is
    # identical across serving disciplines regardless of how many draft
    # tokens the final step happened to verify (the lockstep-vs-continuous
    # overflow divergence fix).  None = no cache cap (budget/EOS only).
    token_limit: Optional[int] = None
    # resolved per-request speculation policy (set by the serving loop at
    # submit; None = the loop's trie-only legacy path) and, when the policy
    # asks for it, the per-lane adaptive draft-budget controller
    draft: Optional[DraftPolicy] = None
    budget_ctl: Optional[AdaptiveBudget] = None
    output: List[int] = field(default_factory=list)
    context: List[int] = field(default_factory=list)   # prompt ⧺ output
    stats: GenStats = field(default_factory=GenStats)
    done: bool = False
    cancelled: bool = False
    finish_reason: str = ""
    inserted_upto: int = 0    # output tokens already streamed into the trie
    lane: int = -1            # scheduler slot currently occupied (-1 = none)
    submit_t: float = 0.0
    admit_t: float = 0.0
    first_token_t: float = 0.0
    finish_t: float = 0.0

    @property
    def _limit(self) -> int:
        """Effective output-token budget: caller budget ∧ cache capacity
        (floor 1 — the prefill emits a token without needing tree scratch)."""
        lim = self.max_new_tokens
        if self.token_limit is not None:
            lim = min(lim, self.token_limit)
        return max(lim, 1)

    def _stop_reason_at(self, token: int) -> Optional[str]:
        """Stop classification for the just-appended ``token`` (output
        already includes it) — checked token-by-token so truncation matches
        step-by-step decoding exactly."""
        if token == self.eos_id:
            return "eos"
        p = self.params
        if p is None:
            return None
        if token in p.stop_token_ids:
            return "stop"
        for seq in p.stop_sequences:
            if (len(self.output) >= len(seq)
                    and self.output[-len(seq):] == list(seq)):
                return "stop"
        return None

    def _finish_if_exhausted(self) -> None:
        if not self.done and len(self.output) >= self._limit:
            self.done = True
            self.finish_reason = ("length"
                                  if self._limit >= self.max_new_tokens
                                  else "cache")

    def start(self, first_token: int) -> None:
        """Consume the prefill's chosen root (the first output token)."""
        first_token = int(first_token)
        self.output = [first_token]
        self.context = list(self.prompt) + [first_token]
        self.stats.steps += 1
        self.stats.tokens += 1
        reason = self._stop_reason_at(first_token)
        if reason:
            self.done = True
            self.finish_reason = reason
        self._finish_if_exhausted()

    def accept(self, accepted: Sequence[int], kv_slots: Sequence[int],
               n_tree_slots: int,
               slot_sources: Optional[Sequence[Optional[str]]] = None
               ) -> List[int]:
        """Absorb one verified step; returns the KV slots to commit.

        Tokens are absorbed one at a time against the budget / cache cap /
        EOS / stop conditions, exactly like step-by-step decoding would —
        the committed prefix (and the truncation point) therefore never
        depends on how many draft tokens happened to verify.

        ``slot_sources`` is the tree's per-slot provenance
        (``DraftTree.slot_source``); when given, per-source drafted/accepted
        counters accrue on ``stats`` (slot 0 is the model's own root
        prediction — no source gets credit for it).
        """
        limit = self._limit
        n = 0
        for t in accepted:
            if len(self.output) >= limit:
                break
            t = int(t)
            self.output.append(t)
            self.context.append(t)
            n += 1
            reason = self._stop_reason_at(t)
            if reason:
                self.done = True
                self.finish_reason = reason
                break
        ks = list(kv_slots[:n])
        st = self.stats
        st.steps += 1
        st.tokens += n
        st.dropped_slots += n_tree_slots - n
        if slot_sources is not None:
            for i in range(1, n_tree_slots):
                src = slot_sources[i]
                if src is not None:
                    st.source_drafted[src] = st.source_drafted.get(src, 0) + 1
            for slot in ks[1:]:
                src = slot_sources[slot]
                if src is not None:
                    st.source_accepted[src] = (
                        st.source_accepted.get(src, 0) + 1)
        if self.budget_ctl is not None:
            self.budget_ctl.update(n)
        self._finish_if_exhausted()
        return ks

    def cancel(self) -> None:
        """Mark the request cancelled (the serving loop releases its lane /
        blocks through the regular retire path)."""
        self.done = True
        self.cancelled = True
        self.finish_reason = "cancelled"

    def result(self) -> RequestResult:
        return RequestResult(
            tokens=self.output, stats=self.stats, rid=self.rid,
            latency_s=max(self.finish_t - self.submit_t, 0.0),
            ttft_s=max(self.first_token_t - self.submit_t, 0.0),
            queue_s=max(self.admit_t - self.submit_t, 0.0),
            finish_reason=self.finish_reason, cancelled=self.cancelled)


def cache_token_limit(max_seq_len: int, width: int, prompt_len: int) -> int:
    """Output tokens a request can commit before the next ``width``-slot
    tree step would scatter past ``max_seq_len``.  THE retirement bound both
    serving loops set as ``RequestState.token_limit`` — sharing it is what
    makes overflow truncation identical across disciplines."""
    return max(int(max_seq_len) - int(width) - int(prompt_len) + 1, 1)


# ------------------------------------------------------------------- drafting
def build_draft_tree(trie: TrieTree, cfg: LookaheadConfig,
                     context: Sequence[int], pad_id: int,
                     width: int) -> DraftTree:
    """Retrieve + build a draft tree padded to exactly ``width`` slots."""
    root = int(context[-1])
    if cfg.strategy == "none" or cfg.decoding_length == 0 or width <= 1:
        return _finalize([root], [-1], max(width, 1), pad_id)
    branches, scores = trie.retrieve(
        context, decoding_length=cfg.decoding_length,
        max_prefix_len=cfg.max_prefix_len,
        min_matched_tokens=cfg.min_matched_tokens)
    tree = BUILDERS[cfg.strategy](root, branches, scores,
                                  cfg.decoding_length, pad_id,
                                  sources=["trie"] * len(branches))
    return repad(tree, width, pad_id)


@functools.lru_cache(maxsize=16)
def idle_tree(width: int, pad_id: int) -> DraftTree:
    """Placeholder tree for an empty slot (masked out: n_accept == 0)."""
    return _finalize([pad_id], [-1], max(width, 1), pad_id)


# ------------------------------------------------------------ trie bookkeeping
def trie_admit(trie: TrieTree, cfg: LookaheadConfig, rid: int,
               prompt: Sequence[int]) -> None:
    """Prompt-branch inserting at admission (per request id, eliminable)."""
    if cfg.insert_prompt:
        trie.insert_ngrams(prompt, cfg.branch_length, request_id=rid)


def trie_stream(trie: TrieTree, cfg: LookaheadConfig,
                state: RequestState) -> None:
    """Generated-branch inserting on-the-fly (paper Algorithm 1 lines 5-9)."""
    if not cfg.insert_output:
        return
    out = state.output
    lo = max(state.inserted_upto - cfg.branch_length, 0)
    if len(out) - lo >= 2:
        trie.insert_ngrams(out[lo:], cfg.branch_length)
        state.inserted_upto = len(out)


def trie_retire(trie: TrieTree, cfg: LookaheadConfig, rid: int, *,
                prune: bool = True) -> None:
    """Branch eliminating for a finished request (+ capacity pruning)."""
    if cfg.eliminate:
        trie.eliminate(rid)
    if prune and cfg.prune and len(trie) > trie.capacity:
        trie.prune()


__all__ = ["SamplingParams", "Request", "StepFns", "GenStats",
           "RequestResult", "RequestState", "cache_token_limit",
           "build_draft_tree", "idle_tree", "trie_admit", "trie_stream",
           "trie_retire", "DraftPolicy"]
