"""Build the ``StepFns`` driving a Lookahead engine for a transformer LM
(PyTorch port of ``repro.serving.session``, dense and paged KV layouts).

Each member turns the host's numpy inputs into device tensors without
waiting (through pinned staging buffers), runs the step with torch ops (and
the port's CUDA kernels) and returns device tensors: no member syncs the
host — the serving loop pulls one packed result per decode step through
its own ``_pull``.  The KV cache dict is updated in place (the port's
stand-in for JAX's buffer donation) and returned, as the reference's
donated functions return the new cache.

Per-request sampling: every token-choosing member (``prefill``,
``prefill_into_slot``, ``tree_step``, ``fused_step``, ``prefill_suffix``)
takes a trailing ``lane_params`` dict of per-lane vectors
``{"greedy": (B,) bool, "temp": (B,) f32, "seed": (B,) uint32}``, uploaded
like every other input, so one session serves a lane pool that mixes greedy
and sampled requests at distinct temperatures and seeds.  Call sites that
omit it get the session's default params.

CUDA graphs, the port's ``jax.jit``.  On a CUDA session every member but
``init_cache`` is one CUDA graph per input-shape signature and KV cache,
replayed over static input buffers (``_Member``); the lane, block and
offset indices are runtime inputs, as traced scalars are in the
reference, so one graph serves every lane.  The first call for a signature
and cache runs eagerly (it loads the kernels and sets up cuBLAS), the
second captures, every later one copies its inputs into the static
buffers and replays: a decode step is one ``cudaGraphLaunch``.
``make_session_fns(cuda_graphs=False)`` builds the eager twin (the
counterpart of ``jax.disable_jit``); CPU sessions always run eagerly.

Every member exposes ``_cache_size()`` — the number of distinct input-shape
signatures it has seen (the reference's compiled executables) — so the
compile-once checks of the serving loop (each member sees one shape per
engine, I2) read the same surface as on JAX.  The paged layout's suffix
prefill pads the prompt tail to a doubling bucket ladder (8, 16, ...,
prefill_len), so its ``_cache_size()`` counts the buckets touched.
"""
from __future__ import annotations

import dataclasses
import functools
import time
import weakref
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.core.request import SamplingParams, StepFns
from repro_torch.models import attention as attn_backends
from repro_torch.models import transformer as tx
from repro_torch.models.params import resolve_device
from repro_torch.serving.sampler import (choose_tokens_lanes, greedy_choice,
                                         seed_from_key)

MAX_GRAPHS = 4        # graphs a member keeps (least recently used dropped)
_SEEN = object()      # a key's first call ran eagerly; the next captures
_CACHE = object()     # where a captured body returned the caller's cache


def _signature(x: Any):
    """Shape signature of a call argument (values never count: the lane
    index and lengths are runtime inputs, as traced scalars are in JAX)."""
    if isinstance(x, (torch.Tensor, np.ndarray)):
        return (tuple(x.shape), str(x.dtype))
    if isinstance(x, dict):
        return tuple((k, _signature(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return tuple(_signature(v) for v in x)
    return type(x).__name__


def _host(x, dtype: torch.dtype) -> torch.Tensor:
    """A call argument as a tensor of ``dtype``: a tensor stays on its
    device, host data become a CPU tensor."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(x))
    return t.to(dtype)


def _index(i) -> torch.Tensor:
    """A lane or block index as a (1,) int32 input."""
    return torch.tensor([int(i)], dtype=torch.int32)


def _unview(x, view):
    """A captured body's outputs with the cache dict it was given replaced
    by ``_CACHE``: the graph keeps no reference to the caller's cache."""
    if view is not None and x is view:
        return _CACHE
    if isinstance(x, dict):
        return {k: _unview(v, view) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_unview(v, view) for v in x)
    return x


def _fresh(x, cache):
    """A captured call's outputs for its caller: the cache the graph
    updated in place is the caller's own dict; every other tensor is a
    copy of the graph's static output, which the next replay overwrites."""
    if x is _CACHE:
        return cache
    if isinstance(x, dict):
        return {k: _fresh(v, cache) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(_fresh(v, cache) for v in x)
    if isinstance(x, torch.Tensor):
        return x.clone()
    return x


@dataclasses.dataclass
class _Graph:
    """One captured call: the graph, the static buffers it reads (inputs,
    and the paged block table), its static outputs (``_CACHE`` where the
    body returned the cache dict it was given) and the kernel launches it
    replays."""
    graph: Any
    inputs: Tuple[torch.Tensor, ...]
    table: Optional[torch.Tensor]
    out: Any
    launches: Dict[str, int]


class _Member:
    """A step function plus the compile-once introspection surface and, on
    a CUDA session, its graph cache.

    ``stage(*args, **kwargs) -> (cache, inputs)`` splits a call into the KV
    cache it updates (None for the cohort prefill, which makes one) and a
    tuple of tensors (host data as CPU tensors); ``body(cache, *inputs)``
    runs the step on device tensors alone.  Eager, the inputs are uploaded
    (``put``) and the body runs.  With ``stream`` (the capture stream of a
    CUDA session) a member keeps one ``_Graph`` per key — the inputs'
    shapes and dtypes, the cache's signature and the storage of the cache
    tensors the body writes — at most ``MAX_GRAPHS``, the least recently
    used dropped.  A key's first call runs eagerly, its second captures,
    and every call copies its inputs into the graph's static buffers (host
    data through pinned memory, without waiting) and replays.  The paged
    block table is not keyed: the scheduler replaces the tensor whenever
    a table changes, so each replay first copies the current one into the
    graph's own, on the stream, after its upload.  A body that cannot be
    captured (it syncs, or calls what capture forbids) raises; nothing
    falls back to eager on the card.  A key holds the cache tensors the
    graph writes only weakly: once one of them is gone the key is dropped
    at the member's next call, before its storage, part of the key, can
    key another cache's call, and a graph never keeps a dead session's KV
    cache in memory.

    Capture does not sync the host: it runs on ``stream`` after a
    stream-ordered ``wait_stream``, not under ``torch.cuda.graph``, whose
    entry synchronises the device to free memory, so a capture may happen
    inside the serving loop's no-sync window.  For the same reason the
    allocator cannot hand its cached free blocks back to the card while a
    capture is under way (``torch.cuda.graph`` empties the cache on entry):
    a capture that runs out of memory empties the cache (outside the
    capture) and captures once more.  Kernel launch counters are set back
    after a capture (nothing ran) and advanced by the captured launches on
    every replay (``repro_torch.kernels.add``)."""

    def __init__(self, name: str, body: Callable,
                 stage: Optional[Callable] = None,
                 put: Optional[Callable] = None, stream=None):
        self.name = name
        self._body, self._stage, self._put = body, stage, put
        self._stream = stream
        self._sigs = set()
        self._graphs: Dict[Any, Any] = {}
        self.captures = []        # (capture s, pool bytes) of every capture

    def __call__(self, *args, **kwargs):
        self._sigs.add(_signature(args))
        if self._stage is None:
            return self._body(*args, **kwargs)
        cache, inputs = self._stage(*args, **kwargs)
        if self._stream is None:
            return self._body(cache, *(self._put(x) for x in inputs))
        return self._captured(cache, inputs)

    def _cache_size(self) -> int:
        return len(self._sigs)

    def _n_graphs(self) -> int:
        return sum(isinstance(g, _Graph) for _, g in self._graphs.values())

    def _captured(self, cache, inputs):
        written = () if cache is None else tuple(
            t for n, t in sorted(cache.items()) if n != "block_tables")
        key = (tuple((tuple(x.shape), x.dtype) for x in inputs),
               _signature(cache), tuple(t.data_ptr() for t in written))
        for k in [k for k, (refs, _) in self._graphs.items()
                  if any(r() is None for r in refs)]:
            del self._graphs[k]       # its cache is gone
        _, g = self._graphs.pop(key, (None, None))
        refs = tuple(weakref.ref(t) for t in written)
        self._graphs[key] = (refs, _SEEN if g is None else g)  # recent last
        while len(self._graphs) > MAX_GRAPHS:
            del self._graphs[next(iter(self._graphs))]
        if g is None:
            return self._body(cache, *(self._put(x) for x in inputs))
        if g is _SEEN:          # a capture that fails raises on every call
            g = self._capture(cache, inputs)
            self._graphs[key] = (refs, g)
        return self._replay(g, cache, inputs)

    def _capture(self, cache, inputs) -> _Graph:
        try:
            return self._capture_once(cache, inputs)
        except RuntimeError as exc:
            if not isinstance(exc.__cause__, torch.cuda.OutOfMemoryError):
                raise
        torch.cuda.empty_cache()
        return self._capture_once(cache, inputs)

    def _capture_once(self, cache, inputs) -> _Graph:
        dev = self._stream.device
        reserved = torch.cuda.memory_reserved(dev)
        static = tuple(torch.empty(x.shape, dtype=x.dtype, device=dev)
                       for x in inputs)
        view = table = None
        if cache is not None:
            view = dict(cache)
            if "block_tables" in cache:
                table = view["block_tables"] = torch.empty_like(
                    cache["block_tables"])
        graph = torch.cuda.CUDAGraph()
        before = kernels.snapshot()
        t0 = time.perf_counter()
        self._stream.wait_stream(torch.cuda.current_stream(dev))
        try:
            with torch.cuda.stream(self._stream):
                graph.capture_begin()
                try:
                    out = self._body(view, *static)
                finally:
                    graph.capture_end()
        except Exception as exc:
            kernels.add(kernels.diff(kernels.snapshot(), before), -1)
            raise RuntimeError(f"session member {self.name!r} cannot be "
                               f"captured as a CUDA graph: {exc}") from exc
        torch.cuda.current_stream(dev).wait_stream(self._stream)
        launches = kernels.diff(kernels.snapshot(), before)
        kernels.add(launches, -1)
        self.captures.append((time.perf_counter() - t0,
                              torch.cuda.memory_reserved(dev) - reserved))
        return _Graph(graph, static, table, _unview(out, view), launches)

    def _replay(self, g: _Graph, cache, inputs):
        for buf, x in zip(g.inputs, inputs):
            if x.device.type == "cpu":
                x = x.pin_memory()
            buf.copy_(x, non_blocking=True)
        if g.table is not None:
            g.table.copy_(cache["block_tables"], non_blocking=True)
        g.graph.replay()
        kernels.add(g.launches)
        return _fresh(g.out, cache)


def make_session_fns(cfg: tx.TransformerConfig, params: tx.Params, *,
                     sample: bool = False, temperature: float = 1.0,
                     base_key: Optional[Sequence[int]] = None,
                     seed: Optional[int] = None,
                     sampling: str = "mixed",
                     slots: int = 1, pad_id: int = 0,
                     prefill_len: Optional[int] = None,
                     logits_transform: Optional[Callable] = None,
                     backend: Optional[str] = None,
                     prefill_backend: Optional[str] = None,
                     decode_backend: Optional[str] = None,
                     kv_layout: Optional[str] = None,
                     block_size: Optional[int] = None,
                     n_blocks: Optional[int] = None,
                     device=None, cuda_graphs: bool = True) -> StepFns:
    """Step functions over ``params`` on ``device`` (None = CUDA; raises when
    CUDA is missing).  ``params`` are moved there if they live elsewhere.

    ``slots`` is the tree width T = 1 + decoding_length the serving loop pads
    every draft to; ``prefill_len`` fixes the prompt pad length.
    ``logits_transform(logits, tokens, positions)`` optionally rewrites the
    step logits before token choice (the guided bench model) — it must stay
    a pure function of (token, position) to preserve losslessness, and on
    the card it runs inside the captured graph.
    ``backend`` overrides both attention phases at once, ``prefill_backend``
    / ``decode_backend`` one phase ("dense" | "cuda"; bad names fail here).

    ``sample`` / ``temperature`` / ``seed`` set the *session defaults* a
    request inherits when submitted without its own ``SamplingParams``
    (``base_key``, the raw uint32 words of a JAX key, is the deprecated
    spelling of ``seed``: its words are XORed into one).  ``sampling``
    selects the token choice: "mixed" (default) honors per-request params
    through per-lane vectors (the sampled lanes through the Gumbel-argmax
    kernel on the card); "greedy" builds an argmax-only session — no Gumbel
    kernel runs, and sampled requests are rejected at submit.

    ``kv_layout`` ("dense" | "paged") / ``block_size`` override the config's
    KV-cache layout; for the paged layout ``n_blocks`` sizes the shared
    block pool (None = lanes * ceil(max_seq_len / block_size) + 1 NULL
    block).

    ``cuda_graphs`` (CUDA only): replay each member as a captured CUDA
    graph (the default); False builds the eager twin, the counterpart of
    ``jax.disable_jit``, for holding the graphs against it.
    """
    overrides = {}
    if backend is not None:
        overrides["prefill_backend"] = backend
        overrides["decode_backend"] = backend
    if prefill_backend is not None:
        overrides["prefill_backend"] = prefill_backend
    if decode_backend is not None:
        overrides["decode_backend"] = decode_backend
    if kv_layout is not None:
        overrides["kv_layout"] = kv_layout
    if block_size is not None:
        overrides["kv_block_size"] = int(block_size)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    attn_backends.get_backend(cfg.prefill_backend)
    attn_backends.get_backend(cfg.decode_backend)
    if cfg.kv_layout not in ("dense", "paged"):
        raise ValueError(f"unknown kv_layout {cfg.kv_layout!r}")
    if cfg.kv_layout == "paged" and cfg.kv_block_size < 1:
        raise ValueError(f"kv_block_size={cfg.kv_block_size}")
    if sampling not in ("mixed", "greedy"):
        raise ValueError(f"sampling={sampling!r}: expected 'mixed' or "
                         "'greedy'")
    if sampling == "greedy" and sample:
        raise ValueError("sampling='greedy' builds an argmax-only session; "
                         "it cannot default to sample=True")
    if seed is None:
        seed = seed_from_key(base_key) if base_key is not None else 0
    dev = resolve_device(device)
    params = _to_device(params, dev)
    defaults = SamplingParams(sample=sample, temperature=float(temperature),
                              seed=int(seed)).validate()
    stream = (torch.cuda.Stream(dev)
              if cuda_graphs and dev.type == "cuda" else None)

    def put(t: torch.Tensor) -> torch.Tensor:
        """Input -> device tensor, host data staged through pinned memory
        so the copy neither blocks the host nor races a later host
        write."""
        if t.device == dev:
            return t
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def member(name, body, stage=None):
        return _Member(name, body, stage, put, stream)

    def lane_inputs(lane_params, n) -> Tuple[torch.Tensor, ...]:
        """The (n,) per-lane vectors (greedy, temp, seed): the caller's, or
        the session defaults; none for an argmax-only session."""
        if sampling == "greedy":
            return ()
        if lane_params is None:
            lane_params = {"greedy": np.full((n,), not defaults.sample),
                           "temp": np.full((n,), defaults.temperature,
                                           np.float32),
                           "seed": np.full((n,), defaults.seed, np.uint32)}
        return (_host(np.asarray(lane_params["greedy"], np.bool_),
                      torch.bool),
                _host(np.asarray(lane_params["temp"], np.float32),
                      torch.float32),
                _host(np.asarray(lane_params["seed"], np.uint32)
                      .astype(np.int64), torch.int64))

    def choose(logits, tokens, pos, lanes):
        """Token choice for the slots at positions ``pos``: each predicts
        output position pos + 1."""
        if logits_transform is not None:
            logits = logits_transform(logits, tokens, pos)
        if not lanes:
            return greedy_choice(logits)
        greedy, temp, seed_ = lanes
        return choose_tokens_lanes(logits, pos + 1, {
            "greedy": greedy, "temp": temp, "seed": seed_})

    def choose_last(tokens, lens, last_logits, lanes):
        last_tok = tokens.gather(1, (lens - 1)[:, None].long())
        return choose(last_logits[:, None, :], last_tok,
                      (lens - 1)[:, None], lanes)[:, 0]

    i32 = functools.partial(_host, dtype=torch.int32)
    paged = cfg.kv_layout == "paged"
    if paged:
        tree_fn, slot_fn = tx.tree_step_paged, tx.prefill_into_slot_paged
        commit_fn = functools.partial(tx.commit_paged_cache, cfg)
    else:
        tree_fn, slot_fn = tx.tree_step, tx.prefill_into_slot
        commit_fn = tx.commit_cache

    def stage_slot(cache, slot, tokens, lens, lane_params=None):
        # the request runs in row ``slot`` of a batch padded to the cache's
        # lane count: the cohort prefill's shape, so on the card its rows
        # round as they would in a cohort (and as reference_decode's do)
        slot = int(slot)
        lanes = (cache["block_tables"].shape[0] if paged
                 else cache["k"].shape[1])
        tokens = np.asarray(tokens, np.int32)
        padded = np.full((lanes, tokens.shape[1]), pad_id, np.int32)
        padded[slot] = tokens[0]
        plens = np.ones((lanes,), np.int32)
        plens[slot] = np.asarray(lens, np.int32)[0]
        return cache, (_index(slot), i32(padded), i32(plens),
                       *lane_inputs(lane_params, 1))

    def prefill_into_slot(cache, slot, tokens, lens, *lanes):
        cache, last_logits = slot_fn(cfg, params, cache, slot, tokens, lens)
        row = slot.long()
        return cache, choose_last(tokens.index_select(0, row),
                                  lens.index_select(0, row), last_logits,
                                  lanes)

    def stage_tree(cache, cache_lens, tokens, pos, mask, *rest,
                   lane_params=None):
        pos = i32(pos)
        return cache, (i32(cache_lens), i32(tokens), pos,
                       _host(mask, torch.bool), *(i32(x) for x in rest),
                       *lane_inputs(lane_params, pos.shape[0]))

    def tree_step(cache, cache_lens, tokens, pos, mask, *lanes):
        cache, logits = tree_fn(cfg, params, cache, cache_lens, tokens, pos,
                                mask)
        return cache, choose(logits, tokens, pos, lanes)

    def fused_step(cache, cache_lens, tokens, pos, mask, parent, n_live,
                   *lanes):
        cache, logits = tree_fn(cfg, params, cache, cache_lens, tokens, pos,
                                mask)
        chosen = choose(logits, tokens, pos, lanes)
        n_acc, acc_tok, kv_slots = tx.verify_accept_device(
            tokens, parent, n_live, chosen)
        cache, _ = commit_fn(cache, cache_lens, kv_slots, n_acc)
        return cache, tx.pack_step_result(n_acc, acc_tok, kv_slots)

    def stage_commit(cache, cache_lens, gather_idx, n_accept):
        return cache, (i32(cache_lens), i32(gather_idx), i32(n_accept))

    def stage_fused(cache, cache_lens, tokens, pos, mask, parent, n_live,
                    lane_params=None):
        return stage_tree(cache, cache_lens, tokens, pos, mask, parent,
                          n_live, lane_params=lane_params)

    def stage_tree_step(cache, cache_lens, tokens, pos, mask,
                        lane_params=None):
        return stage_tree(cache, cache_lens, tokens, pos, mask,
                          lane_params=lane_params)

    common = dict(
        tree_step=member("tree_step", tree_step, stage_tree_step),
        fused_step=member("fused_step", fused_step, stage_fused),
        commit=member("commit", commit_fn, stage_commit),
        prefill_into_slot=member("prefill_into_slot", prefill_into_slot,
                                 stage_slot),
        slots=slots, max_seq_len=cfg.max_seq_len, pad_id=pad_id,
        prefill_len=prefill_len, per_lane_params=True,
        session_defaults=defaults, sampling=sampling)
    if paged:
        return _paged_fns(cfg, params, dev, member, lane_inputs, choose,
                          choose_last, common, n_blocks=n_blocks)

    def stage_prefill(tokens, lens, lane_params=None):
        lens = i32(lens)
        return None, (i32(tokens), lens,
                      *lane_inputs(lane_params, lens.shape[0]))

    def prefill(_, tokens, lens, *lanes):
        # the cache is made inside the body: captured, it lives in the
        # graph's pool and every call returns a fresh copy of it
        cache = tx.init_cache(cfg, tokens.shape[0], device=dev)
        cache, last_logits = tx.prefill(cfg, params, tokens, lens, cache)
        return cache, choose_last(tokens, lens, last_logits, lanes)

    def stage_reset_slot(cache, slot):
        return cache, (_index(slot),)

    def init_cache(lanes: int):
        return tx.init_cache(cfg, lanes, device=dev)

    return StepFns(prefill=member("prefill", prefill, stage_prefill),
                   init_cache=member("init_cache", init_cache),
                   reset_slot=member("reset_slot", tx.reset_slot,
                                     stage_reset_slot), **common)


def _paged_fns(cfg, params, dev, member, lane_inputs, choose, choose_last,
               common, *, n_blocks) -> StepFns:
    """The paged layout's own members: the cohort prefill (which takes the
    block tables: the cache does not exist yet), the block scrub, and the
    prefix cache's suffix prefill and block copy; ``common`` holds the
    members both layouts share."""
    i32 = functools.partial(_host, dtype=torch.int32)

    def stage_prefill(tokens, lens, block_tables, lane_params=None):
        lens = i32(lens)
        return None, (i32(tokens), lens, i32(block_tables),
                      *lane_inputs(lane_params, lens.shape[0]))

    def prefill(_, tokens, lens, block_tables, *lanes):
        cache = tx.init_paged_cache(cfg, tokens.shape[0], n_blocks,
                                    device=dev)
        cache["block_tables"] = block_tables
        cache, last_logits = tx.prefill_paged(cfg, params, tokens, lens,
                                              cache)
        return cache, choose_last(tokens, lens, last_logits, lanes)

    def stage_reset_blocks(cache, block_ids):
        return cache, (i32(block_ids),)

    def stage_suffix(cache, slot, tokens, offset, slen, lane_params=None):
        return cache, (_index(slot), i32(tokens), i32(offset), i32(slen),
                       *lane_inputs(lane_params, 1))

    def suffix(cache, slot, tokens, offset, slen, *lanes):
        # at the uncached admission's (lanes, cap) shapes: the tail's rows
        # then round as they would with the cache off
        cache, last_logits = tx.prefill_from_offset_paged(
            cfg, params, cache, slot, tokens, offset, slen, prefill_len=cap)
        last_tok = tokens.gather(1, (slen - 1)[:, None].long())
        return cache, choose(last_logits[:, None, :], last_tok,
                             (offset + slen - 1)[:, None], lanes)[:, 0]

    def stage_copy(cache, src, dst):
        return cache, (_index(src), _index(dst))

    # the suffix prefill pads the uncached prompt tail to the smallest of a
    # doubling ladder of buckets, so its input shapes (the reference's
    # compiled executables, the port's graphs) are the buckets touched,
    # never the requests
    cap = common["prefill_len"] or cfg.max_seq_len
    suffix_buckets, b = [], 8
    while b < cap:
        suffix_buckets.append(b)
        b *= 2
    suffix_buckets = tuple(suffix_buckets + [cap])
    # preallocated host scratch: staging copies it into fresh pinned memory
    # before the asynchronous upload, so reusing it across calls is safe
    pad_id = common["pad_id"]
    pad_bufs = {b: np.full((1, b), pad_id, np.int32) for b in suffix_buckets}
    off_buf = np.zeros((1,), np.int32)
    len_buf = np.zeros((1,), np.int32)
    suffix_member = member("prefill_suffix", suffix, stage_suffix)

    def prefill_suffix(cache, slot, tokens, offset, lane_params=None):
        """tokens (1, n): the UN-padded prompt suffix; offset: the cached
        prefix length.  Pads n up to the smallest suffix bucket."""
        tokens = np.asarray(tokens, np.int32)
        n = tokens.shape[1]
        bucket = next(b for b in suffix_buckets if b >= n)
        padded = pad_bufs[bucket]
        padded[0, :n] = tokens[0]
        padded[0, n:] = pad_id
        off_buf[0] = offset
        len_buf[0] = n
        return suffix_member(cache, slot, padded, off_buf, len_buf,
                             lane_params=lane_params)

    prefill_suffix._cache_size = suffix_member._cache_size
    prefill_suffix.member = suffix_member

    def init_cache(lanes: int):
        return tx.init_paged_cache(cfg, lanes, n_blocks, device=dev)

    return StepFns(prefill=member("prefill", prefill, stage_prefill),
                   init_cache=member("init_cache", init_cache),
                   reset_slot=None, kv_layout="paged",
                   block_size=cfg.kv_block_size, n_blocks=n_blocks,
                   reset_blocks=member("reset_blocks", tx.reset_blocks,
                                       stage_reset_blocks),
                   prefill_suffix=prefill_suffix,
                   copy_block=member("copy_block", tx.copy_paged_block,
                                     stage_copy),
                   suffix_buckets=suffix_buckets, **common)


def _to_device(params, dev: torch.device):
    if isinstance(params, dict):
        return {k: _to_device(v, dev) for k, v in params.items()}
    return params.to(dev)


__all__ = ["make_session_fns", "MAX_GRAPHS"]
