"""LookaheadEngine — the legacy serving entry point tying trie, draft, model
and VA together.

The engine is model-agnostic: it drives jitted device functions built by
``repro_torch.serving.session.make_session_fns`` (or any object satisfying
``StepFns``), and owns the host-side state (trie, per-request bookkeeping,
statistics).  One engine instance serves many requests and keeps its trie warm
across them (paper Appendix D).

Step anatomy (greedy; sample mode replaces argmax with position-keyed sample):

    root r at position m   (cache holds KV for positions < m)
    tree  = draft(trie.retrieve(output_suffix))           # host, ~µs
    chosen = tree_step(cache, m, [r, draft...], pos, mask)  # device
    accepted, kv_slots = verify_accept(tree, chosen)       # host walk, O(L_d)
    cache = commit(cache, m, kv_slots)                     # device gather
    m += len(accepted); r = accepted[-1]

Worst case: no draft matched ⇒ accepted == [chosen[root]] ⇒ identical to
step-by-step decoding.  Best case: len(accepted) == 1 + draft tree depth.

``generate`` / ``generate_batch`` are thin *compat wrappers* over the
request-centric API (``repro_torch.serving.api``): each prompt becomes a
``Request`` with per-request ``SamplingParams``, served by the slot-based
``ContinuousScheduler``; ``generate_batch_lockstep`` keeps the legacy
all-requests-step-together loop (the baseline the continuous-batching
benchmark compares against).  Both loops share the per-request primitives in
core/request.py — including the token-granular ``cache_token_limit``
retirement bound — so losslessness AND the cache-overflow truncation point
hold identically on either path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from .draft_sources import DraftPolicy, DraftSource, TrieSource
from .request import (GenStats, Request, RequestResult, RequestState,
                      SamplingParams, StepFns, build_draft_tree,
                      cache_token_limit, idle_tree, trie_admit, trie_retire,
                      trie_stream)
from .strategies import LookaheadConfig
from .trie import TrieTree
from .verify import verify_accept_batch

MaxNew = Union[int, Sequence[int]]
ParamSpec = Union[SamplingParams, Sequence[SamplingParams], None]


def _host(x) -> np.ndarray:
    """Device result -> host array.  The port's device values are torch
    tensors, which ``np.asarray`` cannot read off the card."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def _budgets(max_new_tokens: MaxNew, n: int) -> List[int]:
    if isinstance(max_new_tokens, (int, np.integer)):
        return [int(max_new_tokens)] * n
    budgets = [int(m) for m in max_new_tokens]
    if len(budgets) != n:
        raise ValueError(
            f"max_new_tokens lists one budget per prompt: got "
            f"{len(budgets)} budgets for {n} prompts")
    return budgets


def _per_request_params(fns: StepFns, n: int, max_new_tokens: Optional[MaxNew],
                        params: ParamSpec) -> List[SamplingParams]:
    """Normalize the compat surface to one ``SamplingParams`` per request:
    explicit params win; otherwise the session defaults with the per-call
    budgets."""
    if params is None:
        if max_new_tokens is None:
            raise ValueError("pass max_new_tokens or per-request params")
        defaults = fns.default_params
        return [dataclasses.replace(defaults, max_new_tokens=b)
                for b in _budgets(max_new_tokens, n)]
    if max_new_tokens is not None:
        raise ValueError("pass either max_new_tokens or params, not both "
                         "(params carry their own max_new_tokens)")
    if isinstance(params, SamplingParams):
        return [params.validate()] * n
    plist = list(params)
    if len(plist) != n:
        raise ValueError(f"params lists one spec per prompt: got "
                         f"{len(plist)} specs for {n} prompts")
    return [p.validate() for p in plist]


class LookaheadEngine:
    def __init__(self, fns: StepFns, config: LookaheadConfig,
                 eos_id: int = -1,
                 draft_policy: Optional[DraftPolicy] = None):
        self.fns = fns
        self.config = config
        self.eos_id = eos_id
        self.trie = TrieTree(capacity=config.trie_capacity,
                             prompt_boost=config.prompt_boost,
                             decay=config.decay)
        # default speculation policy for the scheduler-backed generate paths
        # (the lock-step loop stays on the hardwired trie — it is the legacy
        # baseline the continuous-batching benchmarks compare against).
        # Source instances persist across generate_batch calls so adaptive
        # sources (trie, ngram) stay warm like the trie always has.
        self.draft_policy = (draft_policy if draft_policy is not None
                             else DraftPolicy()).validate()
        self._sources: Dict[str, DraftSource] = {
            "trie": TrieSource(config, trie=self.trie)}
        self._next_request_id = 0

    # ------------------------------------------------------------------ warm
    def warmup(self, corpora: Sequence[Sequence[int]]) -> None:
        """Pre-load responses into the trie (paper Appendix D)."""
        if not self.config.insert_output:
            return
        for toks in corpora:
            self.trie.insert_ngrams(toks, self.config.branch_length)

    # ------------------------------------------------------------------ width
    @property
    def tree_width(self) -> int:
        """Device step width T the engine drives (1 in plain-decoding mode)."""
        cfg = self.config
        if cfg.strategy == "none" or cfg.decoding_length == 0:
            return 1
        return self.fns.slots

    # --------------------------------------------------------------- generate
    def generate(self, prompt: Sequence[int],
                 max_new_tokens: Optional[int] = None,
                 params: Optional[SamplingParams] = None) -> RequestResult:
        res = self.generate_batch([prompt], max_new_tokens, params=params)
        return res[0]

    def generate_batch(self, prompts: Sequence[Sequence[int]],
                       max_new_tokens: Optional[MaxNew] = None,
                       params: ParamSpec = None) -> List[RequestResult]:
        """Serve ``prompts`` to completion; per-request budgets or full
        per-request ``SamplingParams`` allowed.

        Compat wrapper over the request-centric API: each prompt becomes a
        ``Request`` submitted to the continuous scheduler (one lane per
        prompt, all admitted up front) when the StepFns support slot
        serving; otherwise falls back to the legacy lock-step loop.  Output
        tokens are identical either way (lossless per request).
        """
        plist = _per_request_params(self.fns, len(prompts), max_new_tokens,
                                    params)
        if not self.fns.supports_slot_serving:
            return self.generate_batch_lockstep(prompts, params=plist)
        prefill_len = self.fns.prefill_len or max(len(p) for p in prompts)
        if prefill_len + self.tree_width > self.fns.max_seq_len:
            # near-max-length prompts: the scheduler refuses admission
            # (no room for a tree step); the lock-step loop degrades
            # gracefully to a 1-token result instead
            if getattr(self.fns, "kv_layout", "dense") == "paged":
                raise ValueError(
                    f"prompts padded to {prefill_len} leave no room for a "
                    f"{self.tree_width}-slot tree step within max_seq_len="
                    f"{self.fns.max_seq_len}, and the paged layout has no "
                    "lock-step fallback — shorten the prompt, raise "
                    "max_seq_len, or use kv_layout='dense'")
            return self.generate_batch_lockstep(prompts, params=plist)
        from repro_torch.serving.scheduler import ContinuousScheduler
        sched = ContinuousScheduler(
            self.fns, self.config, lanes=len(prompts), trie=self.trie,
            eos_id=self.eos_id, prefill_len=prefill_len,
            rid_start=self._next_request_id,
            draft_policy=self.draft_policy, sources=self._sources)
        handles = [sched.submit_request(Request(prompt=list(p), params=pp))
                   for p, pp in zip(prompts, plist)]
        sched.run()
        self._next_request_id = sched.next_rid
        return [h.result() for h in handles]

    # --------------------------------------------------------------- lockstep
    def generate_batch_lockstep(self, prompts: Sequence[Sequence[int]],
                                max_new_tokens: Optional[MaxNew] = None,
                                params: ParamSpec = None
                                ) -> List[RequestResult]:
        """Legacy loop: all requests step together; finished requests idle in
        their slot until the slowest request of the batch drains."""
        cfg, fns = self.config, self.fns
        if getattr(fns, "kv_layout", "dense") == "paged":
            raise ValueError(
                "the lock-step loop drives the dense KV layout only; paged "
                "sessions are served by ContinuousScheduler (which owns the "
                "block allocator)")
        B = len(prompts)
        W = self.tree_width
        plist = _per_request_params(fns, B, max_new_tokens, params)
        states = [RequestState(rid=self._next_request_id + i,
                               prompt=list(prompts[i]),
                               max_new_tokens=plist[i].max_new_tokens,
                               eos_id=self.eos_id, params=plist[i],
                               token_limit=cache_token_limit(
                                   fns.max_seq_len, W, len(prompts[i])))
                  for i in range(B)]
        self._next_request_id += B

        for rs in states:
            trie_admit(self.trie, cfg, rs.rid, rs.prompt)

        # per-lane sampling vectors (lane i <-> request i, fixed for the
        # whole batch); legacy StepFns without per-lane support fall back to
        # their session-level constants
        lane_kw = {}
        if fns.per_lane_params:
            lane_kw["lane_params"] = {
                "greedy": np.asarray([not p.sample for p in plist]),
                "temp": np.asarray([p.temperature for p in plist],
                                   dtype=np.float32),
                "seed": np.asarray([np.uint32(p.seed) for p in plist],
                                   dtype=np.uint32)}

        # --- prefill (pad to a common fixed length when configured)
        S = fns.prefill_len or max(len(p) for p in prompts)
        toks = np.full((B, S), fns.pad_id, dtype=np.int32)
        lens = np.zeros((B,), dtype=np.int32)
        for b, p in enumerate(prompts):
            if len(p) > S:
                raise ValueError(
                    f"prompt {b} has {len(p)} tokens but the session pads "
                    f"prompts to prefill_len={S}; shorten the prompt or "
                    "rebuild the session with a larger prefill_len")
            toks[b, :len(p)] = np.asarray(p, dtype=np.int32)
            lens[b] = len(p)
        cache, chosen_root = fns.prefill(toks, lens, **lane_kw)
        chosen_root = _host(chosen_root)
        cache_lens = lens.copy()
        for b, rs in enumerate(states):
            rs.start(int(chosen_root[b]))
            # backstop (cache_token_limit already caps the budget): a first
            # tree step would scatter past the cache end — stop at the
            # prefill token rather than commit garbage
            if cache_lens[b] + W > fns.max_seq_len:
                rs.done = True
                rs.finish_reason = rs.finish_reason or "cache"

        while any(not rs.done for rs in states):
            trees = [build_draft_tree(self.trie, cfg, rs.context,
                                      fns.pad_id, W)
                     if not rs.done else idle_tree(W, fns.pad_id)
                     for rs in states]
            tok = np.stack([t.tokens for t in trees])                 # (B,W)
            pos = (cache_lens[:, None]
                   + np.stack([t.depth for t in trees])).astype(np.int32)
            mask = np.stack([t.tree_mask for t in trees])             # (B,W,W)
            cache, chosen = fns.tree_step(cache, cache_lens, tok, pos, mask,
                                          **lane_kw)
            chosen = _host(chosen)

            accepted, kv_slots = verify_accept_batch(trees, chosen)
            gather = np.zeros((B, W), dtype=np.int32)
            n_acc = np.zeros((B,), dtype=np.int32)
            stepped = [b for b in range(B) if not states[b].done]
            for b in stepped:
                ks = states[b].accept(accepted[b], kv_slots[b],
                                      trees[b].n_slots,
                                      slot_sources=trees[b].slot_source)
                gather[b, :len(ks)] = np.asarray(ks, dtype=np.int32)
                n_acc[b] = len(ks)
            cache, cache_lens = fns.commit(cache, cache_lens, gather, n_acc)
            cache_lens = _host(cache_lens)

            for b in stepped:
                trie_stream(self.trie, cfg, states[b])
                # backstop: token_limit retires before overflow is possible
                if cache_lens[b] + W >= fns.max_seq_len \
                        and not states[b].done:
                    states[b].done = True
                    states[b].finish_reason = \
                        states[b].finish_reason or "cache"

        for rs in states:
            trie_retire(self.trie, cfg, rs.rid, prune=False)
        if cfg.prune and len(self.trie) > self.trie.capacity:
            self.trie.prune()

        return [rs.result() for rs in states]


def reference_decode(fns: StepFns, prompt: Sequence[int],
                     max_new_tokens: Optional[int] = None,
                     eos_id: int = -1, pad_id: int = 0,
                     params: Optional[SamplingParams] = None, *,
                     lanes: Optional[int] = None) -> List[int]:
    """Plain step-by-step decoding through the *same* device functions
    (width-1 step with an empty draft), honoring the request's own
    ``SamplingParams``.  Ground truth for lossless tests.

    ``lanes`` (port only) decodes at the serving batch shape instead: the
    request runs in lane 0 of a ``lanes``-lane scheduler at the session's
    full tree width, every tree holding the root alone (draft budget 0), so
    still one token per step — but every device call has the shapes
    serving gives it.  On the card a matrix product may round a row
    differently at another batch shape, and a sampled (or unguided greedy)
    choice can rest on those last bits; at the serving shapes the row sees
    the same kernels and the same bits.  With nothing drafted, the request's
    draft source is its own prompt copy rather than the shared trie, whose
    insertion of a long prompt costs time quadratic in its length (it
    prunes the whole trie at each n-gram once past its capacity)."""
    if lanes is None:
        cfg = LookaheadConfig(strategy="none", decoding_length=0)
        engine = LookaheadEngine(fns, cfg, eos_id=eos_id)
        return engine.generate(prompt, max_new_tokens, params=params).tokens
    from repro_torch.serving.scheduler import ContinuousScheduler
    (sp,) = _per_request_params(fns, 1, max_new_tokens, params)
    sched = ContinuousScheduler(
        fns, LookaheadConfig(decoding_length=fns.slots - 1), lanes=lanes,
        eos_id=eos_id, prefill_len=fns.prefill_len or len(prompt),
        draft_policy=DraftPolicy(sources=("prompt_copy",)),
        draft_budget_caps={"": 0})
    handle = sched.submit_request(Request(
        prompt=list(prompt), params=dataclasses.replace(sp, draft=None)))
    sched.run()
    return handle.result().tokens


__all__ = ["LookaheadEngine", "StepFns", "GenStats", "RequestResult",
           "RequestState", "reference_decode"]
