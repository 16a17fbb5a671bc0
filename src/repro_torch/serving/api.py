"""Request-centric serving API (DESIGN.md §Serving API) — PyTorch port of
``repro.serving.api``.  The port serves greedy, sampled and mixed requests
on the dense and the paged KV layout, with or without the prefix cache,
under the opt-in runtime sanitizer, and persists and merges warm draft
state (``repro_torch.fleet``).

The production surface over the continuous-batching stack:

  * ``SamplingParams`` / ``Request`` (repro_torch.core.request) — per-request
    generation spec: greedy/sample, temperature, seed, stop token ids, stop
    sequences, max_new_tokens.  One co-batched scheduler run may mix them
    freely; the device step takes per-lane param vectors as traced inputs,
    so nothing retraces (I2) and every request stays bit-identical to
    ``reference_decode`` under its own params (I1).
  * ``RequestHandle`` — returned by ``submit``: incremental token stream
    (iterator or callback), ``.result()``, ``.cancel()``.
  * ``EngineConfig`` — one validated spec consolidating the kwargs that used
    to be threaded separately through ``make_session_fns``,
    ``ContinuousScheduler.__init__``, ``launch/serve.py`` argparse and
    ``benchmarks/common.py``.
  * ``build_engine(cfg, model_cfg, params)`` — the single entry point:
    session + scheduler + handle plumbing as one ``ServingEngine``.

Single-threaded by design: handles *pump* the scheduler when the caller
blocks on them (``result()`` / iteration), so a plain script can stream
without an event loop; a server loop instead calls ``engine.step()`` itself
and consumes handle callbacks.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional, Sequence,
                    Union)

from repro_torch.core.draft_sources import DraftPolicy
from repro_torch.core.request import (Request, RequestResult, RequestState,
                                      SamplingParams, StepFns)
from repro_torch.core.strategies import LookaheadConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.session import make_session_fns


# ---------------------------------------------------------------- EngineConfig
@dataclass(frozen=True)
class EngineConfig:
    """Validated spec of one serving engine (lanes + session + layout).

    Everything the serving stack used to take as scattered kwargs lives
    here; ``validate()`` rejects inconsistent combinations up front instead
    of at trace or admission time.
    """
    # scheduling; prefill_len None = legacy pad-to-batch-max (retraces per
    # prompt length — one-shot scripts only; the scheduler requires it set)
    lanes: int = 4
    prefill_len: Optional[int] = 128
    scrub_freed: bool = False
    # lookahead drafting
    decoding_length: int = 32
    branch_length: int = 12
    strategy: str = "hierarchical"
    # vocabulary ids
    eos_id: int = -1                    # -1 = arch defines no EOS
    pad_id: int = 0
    # attention backends (None = the model config's per-phase defaults)
    backend: Optional[str] = None
    prefill_backend: Optional[str] = None
    decode_backend: Optional[str] = None
    # KV-cache layout
    kv_layout: str = "dense"
    block_size: int = 64
    n_blocks: Optional[int] = None      # paged: None = dense-equivalent pool
    # sampling: "mixed" honors per-request params; "greedy" compiles the
    # argmax-only fast path and rejects sampled requests at submit
    sampling: str = "mixed"
    # overlap host work with the in-flight device step (DESIGN.md §Step
    # pipeline): admission first-token pulls settle after draft building,
    # and heavy retirement (trie elimination, block frees, handle finalize)
    # drains inside the next step's flight window.  Bit-identical outputs
    # to the serial path (losslessness is draft- and timing-independent).
    overlap_drafts: bool = False
    # radix-tree prefix caching over the paged pool (DESIGN.md §Prefix
    # cache): requests whose prompt prefix is already resident skip that
    # portion of prefill via refcounted copy-on-write block sharing.
    # Outputs stay bit-identical to the uncached path.  prefix_cache_blocks
    # caps the tree's resident blocks (None = bounded by pool pressure).
    prefix_cache: bool = False
    prefix_cache_blocks: Optional[int] = None
    # session defaults for requests submitted without their own params
    default_params: SamplingParams = field(default_factory=SamplingParams)
    # default speculation policy (draft sources / quotas / trie namespace /
    # adaptive budget) for requests whose params carry draft=None; purely
    # host-side, so any policy serves on the same compiled executables
    draft_policy: DraftPolicy = field(default_factory=DraftPolicy)
    # ---- multi-tenant SLO controls (DESIGN.md §Multi-tenant SLOs).  All
    # host-side admission/draft policy: outputs stay bit-identical (I1) and
    # nothing retraces (I2).
    # lane_shares: namespace -> fraction of the lane pool in (0, 1] it may
    # hold at once (weighted-fair admission; unlisted namespaces weigh like
    # the smallest listed share and are uncapped).  None/{} = global FIFO.
    lane_shares: Optional[Dict[str, float]] = None
    # draft_budget_caps: namespace -> max draft tokens per tree (bounds a
    # hot tenant's host-side draft cost; the compiled width is untouched)
    draft_budget_caps: Optional[Dict[str, int]] = None
    # autotune: per-namespace EMA bandit over draft-source quotas — sources
    # that never verify on a namespace get their quota driven to zero and
    # their retrieve cost skipped (core/autotune.py)
    autotune: bool = False
    # sanitize: opt-in runtime sanitizer (repro_torch.analysis.sanitizer) —
    # per-request lifecycle state machine, shadow block-ownership ledger,
    # retrace monitor.  Debug/CI tool: adds host work and device probes
    # but never changes outputs; default-off costs nothing.
    sanitize: bool = False

    @property
    def slots(self) -> int:
        """Device tree width T = 1 + decoding_length (1 in plain mode)."""
        if self.strategy == "none" or self.decoding_length == 0:
            return 1
        return 1 + self.decoding_length

    def lookahead(self) -> LookaheadConfig:
        return LookaheadConfig(
            decoding_length=self.decoding_length,
            branch_length=self.branch_length, strategy=self.strategy,
            sample=self.default_params.sample,
            temperature=self.default_params.temperature)

    def validate(self) -> "EngineConfig":
        if self.lanes < 1:
            raise ValueError(f"lanes={self.lanes}: need >= 1")
        if self.prefill_len is not None and self.prefill_len < 1:
            raise ValueError(f"prefill_len={self.prefill_len}: need >= 1 "
                             "(fixed prompt pad length, compile-once)")
        if self.decoding_length < 0 or self.branch_length < 1:
            raise ValueError(
                f"decoding_length={self.decoding_length} / "
                f"branch_length={self.branch_length} out of range")
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout={self.kv_layout!r}: expected "
                             "'dense' or 'paged'")
        if self.kv_layout == "paged" and self.block_size < 1:
            raise ValueError(f"block_size={self.block_size}: need >= 1")
        if self.prefix_cache and self.kv_layout != "paged":
            raise ValueError("prefix_cache=True requires kv_layout='paged' "
                             "(block sharing needs the paged pool)")
        if self.prefix_cache_blocks is not None \
                and self.prefix_cache_blocks < 0:
            raise ValueError(
                f"prefix_cache_blocks={self.prefix_cache_blocks}")
        if self.sampling not in ("mixed", "greedy"):
            raise ValueError(f"sampling={self.sampling!r}: expected 'mixed' "
                             "or 'greedy'")
        if self.sampling == "greedy" and self.default_params.sample:
            raise ValueError("sampling='greedy' (argmax-only executables) "
                             "conflicts with default_params.sample=True")
        from repro_torch.models.attention import available_backends
        names = available_backends()
        for b in (self.backend, self.prefill_backend, self.decode_backend):
            if b is not None and b not in names:
                raise ValueError(f"unknown attention backend {b!r} "
                                 f"(registry: {', '.join(names)})")
        for nsn, share in (self.lane_shares or {}).items():
            if not 0.0 < float(share) <= 1.0:
                raise ValueError(f"lane_shares[{nsn!r}]={share}: need a "
                                 "pool fraction in (0, 1]")
        for nsn, cap in (self.draft_budget_caps or {}).items():
            if int(cap) < 0:
                raise ValueError(f"draft_budget_caps[{nsn!r}]={cap}: "
                                 "need >= 0")
        self.default_params.validate()
        self.draft_policy.validate()
        return self


def build_session_fns(cfg: EngineConfig, model_cfg, params, *,
                      logits_transform: Optional[Callable] = None,
                      device=None, cuda_graphs: bool = True) -> StepFns:
    """Build the ``StepFns`` an ``EngineConfig`` describes, on ``device``
    (None = CUDA; raises when CUDA is missing); ``cuda_graphs=False``
    builds the eager twin (``make_session_fns``)."""
    cfg.validate()
    if cfg.prefill_len is not None \
            and cfg.prefill_len + cfg.slots > model_cfg.max_seq_len:
        raise ValueError(
            f"prefill_len={cfg.prefill_len} + tree width {cfg.slots} "
            f"exceeds the model's max_seq_len={model_cfg.max_seq_len}; "
            "shorten prefill_len, shrink decoding_length, or raise "
            "max_seq_len")
    dp = cfg.default_params
    return make_session_fns(
        model_cfg, params, sample=dp.sample, temperature=dp.temperature,
        seed=dp.seed, sampling=cfg.sampling, slots=cfg.slots,
        pad_id=cfg.pad_id, prefill_len=cfg.prefill_len,
        logits_transform=logits_transform, backend=cfg.backend,
        prefill_backend=cfg.prefill_backend,
        decode_backend=cfg.decode_backend, kv_layout=cfg.kv_layout,
        block_size=cfg.block_size if cfg.kv_layout == "paged" else None,
        n_blocks=cfg.n_blocks, device=device, cuda_graphs=cuda_graphs)


# --------------------------------------------------------------- RequestHandle
class RequestHandle:
    """Streaming handle of one submitted request.

    Tokens arrive as per-step accepted deltas (a lookahead step may emit
    several at once).  Three consumption styles:

      * iterate: ``for tok in handle: ...`` — pumps the scheduler while the
        request is unfinished, yields tokens in order;
      * callback: ``handle.on_token(fn)`` — ``fn(delta_tokens)`` fires on
        every accepted delta (the backlog is replayed at registration);
      * block: ``handle.result()`` — pumps to completion, returns the
        ``RequestResult``.

    ``cancel()`` retires the request immediately through the scheduler's
    regular retire path (lane + KV blocks released, co-resident requests
    untouched); the result carries ``cancelled=True`` and the tokens
    streamed so far.
    """

    def __init__(self, state: RequestState, scheduler: ContinuousScheduler):
        self._state = state
        self._scheduler = scheduler
        self.rid = state.rid
        self._tokens: List[int] = []
        self._result: Optional[RequestResult] = None

    # ---- scheduler-side plumbing (the scheduler fires the callbacks)
    def _push(self, delta: List[int]) -> None:
        self._tokens.extend(delta)

    def _finalize(self, result: RequestResult) -> None:
        self._result = result

    # ---- caller surface
    @property
    def done(self) -> bool:
        return self._result is not None

    @property
    def cancelled(self) -> bool:
        return self._result is not None and self._result.cancelled

    @property
    def tokens(self) -> List[int]:
        """Tokens streamed so far (a copy; grows until ``done``)."""
        return list(self._tokens)

    def on_token(self, callback: Callable[[List[int]], None]) -> None:
        """Register a per-delta callback; already-streamed tokens are
        replayed immediately so late registration never drops output."""
        if self._tokens:
            callback(list(self._tokens))
        if self._result is None:
            self._scheduler.callbacks.setdefault(self.rid, []).append(
                callback)

    def _pump(self) -> None:
        if self._scheduler.idle:
            raise RuntimeError(
                f"request {self.rid} never finished but the scheduler is "
                "idle (internal error)")
        self._scheduler.step()

    def result(self) -> RequestResult:
        """Drive the scheduler until this request finishes; returns its
        ``RequestResult`` (co-batched requests keep progressing too)."""
        while self._result is None:
            self._pump()
        return self._result

    def cancel(self) -> RequestResult:
        """Stop generating, release the lane and KV blocks; returns the
        partial result.  No-op if already finished."""
        if self._result is None:
            self._scheduler.cancel(self.rid)
        return self._result

    def __iter__(self) -> Iterator[int]:
        """Yield output tokens incrementally, pumping the scheduler as
        needed.  Ends when the request finishes (or is cancelled)."""
        i = 0
        while True:
            while i < len(self._tokens):
                yield self._tokens[i]
                i += 1
            if self._result is not None:
                return
            self._pump()


# ---------------------------------------------------------------- ServingEngine
class ServingEngine:
    """One serving engine: session + continuous scheduler + handles.

    Drive it blocking (``submit`` everything, ``run()`` or
    ``handle.result()``) or as an online loop (``submit`` as requests
    arrive, call ``step()`` repeatedly).
    """

    def __init__(self, fns: StepFns, config: EngineConfig, *, trie=None):
        self.fns = fns
        self.config = config.validate()
        self.scheduler = ContinuousScheduler(
            fns, config.lookahead(), lanes=config.lanes,
            eos_id=config.eos_id, prefill_len=config.prefill_len,
            scrub_freed=config.scrub_freed, trie=trie,
            default_params=config.default_params,
            draft_policy=config.draft_policy,
            overlap_drafts=config.overlap_drafts,
            prefix_cache=config.prefix_cache,
            prefix_cache_blocks=config.prefix_cache_blocks,
            lane_shares=config.lane_shares,
            draft_budget_caps=config.draft_budget_caps,
            autotune=config.autotune, sanitize=config.sanitize)

    # ---- request surface
    def submit(self, request: Union[Request, Sequence[int]],
               params: Optional[SamplingParams] = None,
               **param_overrides: Any) -> RequestHandle:
        """Submit a ``Request`` — or a raw token prompt plus
        ``SamplingParams`` / keyword overrides of the engine defaults
        (e.g. ``submit(prompt, max_new_tokens=64, temperature=0.7,
        sample=True)``)."""
        if not isinstance(request, Request):
            if params is None:
                params = dataclasses.replace(self.config.default_params,
                                             **param_overrides)
            elif param_overrides:
                raise ValueError("pass params= or keyword overrides, "
                                 "not both")
            request = Request(prompt=list(request), params=params)
        elif params is not None or param_overrides:
            raise ValueError("a Request already carries its params")
        return self.scheduler.submit_request(request)

    def step(self) -> List[RequestResult]:
        """One scheduler iteration (admission + one masked decode step)."""
        return self.scheduler.step()

    def run(self) -> List[RequestResult]:
        """Drain queue + lanes; results in submission order."""
        return self.scheduler.run()

    def warmup(self, corpora: Sequence[Sequence[int]]) -> None:
        """Pre-load responses into the trie (paper Appendix D)."""
        la = self.scheduler.config
        if not la.insert_output:
            return
        for toks in corpora:
            self.scheduler.trie.insert_ngrams(toks, la.branch_length)

    # ---- warm draft-state persistence (repro_torch.fleet; lazy imports
    # keep the fleet package out of the engine's import graph until first
    # use)
    def draft_state(self, *, max_prefix_keys: Optional[int] = 64
                    ) -> Dict[str, Any]:
        """Snapshot the shared draft statistics (trie forests, n-gram
        tables, hot prefix keys) as a plain-data payload."""
        from repro_torch.fleet.persist import collect_draft_state
        return collect_draft_state(self.scheduler,
                                   max_prefix_keys=max_prefix_keys)

    def merge_draft_state(self, payload: Dict[str, Any]) -> None:
        """Gossip: freq-sum another replica's payload into this engine's
        draft sources (capacity budgets re-enforced after the merge)."""
        from repro_torch.fleet.persist import install_draft_state
        install_draft_state(self.scheduler, payload, merge=True)

    def save_draft_state(self, path: str, *,
                         max_prefix_keys: Optional[int] = 64
                         ) -> Dict[str, Any]:
        """Persist the warm draft state to ``path`` (atomic, versioned,
        checksummed); returns the payload written."""
        from repro_torch.fleet.persist import save_draft_state
        payload = self.draft_state(max_prefix_keys=max_prefix_keys)
        save_draft_state(path, payload)
        return payload

    def load_draft_state(self, path: str, *,
                         prime_prefix: bool = True) -> Dict[str, Any]:
        """Resume with a donor's branch statistics (the continuous version
        of the paper's Appendix D warmup).

        Replaces the shared state of every source the file names, then —
        when this engine runs a prefix cache and ``prime_prefix`` is set —
        re-prefills each persisted hot prefix key as a 1-token priming
        request so the retire-time insert repopulates the radix tree
        through the regular machinery (KV blocks are device-resident and
        never travel in the file).  Priming requests run through the
        normal scheduler — on the card through its captured members, as
        any request does — and show up in its stats.  Must be called on an
        idle engine, before serving traffic.
        """
        from repro_torch.fleet.persist import (install_draft_state,
                                               load_draft_state)
        if not self.idle:
            raise RuntimeError("load_draft_state needs an idle engine "
                               "(warm state must precede traffic)")
        payload = load_draft_state(path)
        install_draft_state(self.scheduler, payload)
        prefix_keys = payload.get("prefix", {})
        if prime_prefix and self.scheduler.prefix is not None and prefix_keys:
            plen = self.scheduler.prefill_len
            for ns, keys in prefix_keys.items():
                policy = dataclasses.replace(self.config.draft_policy,
                                             namespace=str(ns))
                params = dataclasses.replace(self.config.default_params,
                                             max_new_tokens=1, draft=policy)
                for toks in keys:
                    toks = [int(t) for t in toks][:plen]
                    if toks:
                        self.submit(Request(prompt=toks, params=params))
            self.run()
        return payload

    # ---- state passthrough
    @property
    def idle(self) -> bool:
        return self.scheduler.idle

    @property
    def stats(self):
        return self.scheduler.stats

    @property
    def trie(self):
        return self.scheduler.trie


def build_engine(cfg: EngineConfig, model_cfg, params, *,
                 logits_transform: Optional[Callable] = None,
                 trie=None, device=None,
                 cuda_graphs: bool = True) -> ServingEngine:
    """THE entry point: build a session for ``(model_cfg, params)`` under
    ``cfg`` on ``device`` (None = CUDA; raises when CUDA is missing) and
    wrap it in a ``ServingEngine``.  On the card its step functions replay
    captured CUDA graphs; ``cuda_graphs=False`` builds the eager twin that
    the on-card checks hold them against."""
    fns = build_session_fns(cfg, model_cfg, params,
                            logits_transform=logits_transform, device=device,
                            cuda_graphs=cuda_graphs)
    return ServingEngine(fns, cfg, trie=trie)


__all__ = ["EngineConfig", "RequestHandle", "ServingEngine",
           "build_session_fns", "build_engine", "Request", "SamplingParams",
           "DraftPolicy"]
