"""Build the ``StepFns`` driving a Lookahead engine for a transformer LM
(PyTorch port of ``repro.serving.session``, dense and paged KV layouts).

Each member takes the host's numpy inputs, moves them to the device through
pinned staging buffers without waiting, runs the step with torch ops (and
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

PyTorch runs eagerly, so there is nothing to compile; every member still
exposes ``_cache_size()`` — the number of distinct input-shape signatures
it has seen — so the compile-once checks of the serving loop (each member
sees one shape per engine, I2) read the same surface as on JAX.  The paged
layout's suffix prefill pads the prompt tail to a doubling bucket ladder
(8, 16, ..., prefill_len), so its ``_cache_size()`` counts the buckets
touched.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.request import SamplingParams, StepFns
from repro_torch.models import attention as attn_backends
from repro_torch.models import transformer as tx
from repro_torch.models.params import resolve_device
from repro_torch.serving.sampler import (choose_tokens_lanes, greedy_choice,
                                         seed_from_key)


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


class _Member:
    """A step function plus the compile-once introspection surface."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self._sigs = set()

    def __call__(self, *args, **kwargs):
        self._sigs.add(_signature(args))
        return self._fn(*args, **kwargs)

    def _cache_size(self) -> int:
        return len(self._sigs)


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
                     device=None) -> StepFns:
    """Step functions over ``params`` on ``device`` (None = CUDA; raises when
    CUDA is missing).  ``params`` are moved there if they live elsewhere.

    ``slots`` is the tree width T = 1 + decoding_length the serving loop pads
    every draft to; ``prefill_len`` fixes the prompt pad length.
    ``logits_transform(logits, tokens, positions)`` optionally rewrites the
    step logits before token choice (the guided bench model) — it must stay
    a pure function of (token, position) to preserve losslessness.
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

    def put(x, dtype=None):
        """Host input -> device tensor, staged through pinned memory so the
        copy neither blocks the host nor races a later host write."""
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(x))
        if dtype is not None:
            t = t.to(dtype)
        if t.device == dev:
            return t
        if dev.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(dev, non_blocking=True)

    def lane_vectors(lane_params, n):
        """The (n,) per-lane vectors on the device: the caller's, or the
        session defaults."""
        if lane_params is None:
            lane_params = {"greedy": np.full((n,), not defaults.sample),
                           "temp": np.full((n,), defaults.temperature,
                                           np.float32),
                           "seed": np.full((n,), defaults.seed, np.uint32)}
        return {"greedy": put(np.asarray(lane_params["greedy"], np.bool_)),
                "temp": put(np.asarray(lane_params["temp"], np.float32)),
                "seed": put(np.asarray(lane_params["seed"], np.uint32)
                            .astype(np.int64))}

    def choose(logits, tokens, pos, lane_params):
        """Token choice for the slots at positions ``pos``: each predicts
        output position pos + 1."""
        if logits_transform is not None:
            logits = logits_transform(logits, tokens, pos)
        if sampling == "greedy":
            return greedy_choice(logits)
        return choose_tokens_lanes(logits, pos + 1,
                                   lane_vectors(lane_params, pos.shape[0]))

    def choose_last(tokens, lens, last_logits, lane_params):
        last_tok = tokens.gather(1, (lens - 1)[:, None].long())
        return choose(last_logits[:, None, :], last_tok,
                      (lens - 1)[:, None], lane_params)[:, 0]

    paged = cfg.kv_layout == "paged"
    if paged:
        tree_fn, slot_fn = tx.tree_step_paged, tx.prefill_into_slot_paged
        commit_fn = functools.partial(tx.commit_paged_cache, cfg)
    else:
        tree_fn, slot_fn = tx.tree_step, tx.prefill_into_slot
        commit_fn = tx.commit_cache

    def _prefill_into_slot(cache, slot, tokens, lens, lane_params=None):
        # the request runs in row ``slot`` of a batch padded to the cache's
        # lane count: the cohort prefill's shape, so on the card its rows
        # round as they would in a cohort (and as reference_decode's do)
        slot = int(slot)
        lanes = (cache["block_tables"].shape[0] if paged
                 else cache["k"].shape[1])
        tokens = np.asarray(tokens, np.int32)
        lens = np.asarray(lens, np.int32)
        padded = np.full((lanes, tokens.shape[1]), pad_id, np.int32)
        padded[slot] = tokens[0]
        plens = np.ones((lanes,), np.int32)
        plens[slot] = lens[0]
        tokens, lens = put(padded, torch.int32), put(plens, torch.int32)
        cache, last_logits = slot_fn(cfg, params, cache, slot, tokens, lens)
        return cache, choose_last(tokens[slot:slot + 1], lens[slot:slot + 1],
                                  last_logits, lane_params)

    def _forward(cache, cache_lens, tokens, pos, mask, lane_params):
        cache_lens = put(cache_lens, torch.int32)
        tokens, pos = put(tokens, torch.int32), put(pos, torch.int32)
        cache, logits = tree_fn(cfg, params, cache, cache_lens, tokens, pos,
                                put(mask, torch.bool))
        return cache, cache_lens, tokens, choose(logits, tokens, pos,
                                                 lane_params)

    def _tree_step(cache, cache_lens, tokens, pos, mask, lane_params=None):
        cache, _, _, chosen = _forward(cache, cache_lens, tokens, pos, mask,
                                       lane_params)
        return cache, chosen

    def _commit(cache, cache_lens, gather_idx, n_accept):
        return commit_fn(cache, put(cache_lens, torch.int32),
                         put(gather_idx, torch.int32),
                         put(n_accept, torch.int32))

    def _fused_step(cache, cache_lens, tokens, pos, mask, parent, n_live,
                    lane_params=None):
        cache, cache_lens, tokens, chosen = _forward(
            cache, cache_lens, tokens, pos, mask, lane_params)
        n_acc, acc_tok, kv_slots = tx.verify_accept_device(
            tokens, put(parent, torch.int32), put(n_live, torch.int32),
            chosen)
        cache, _ = commit_fn(cache, cache_lens, kv_slots, n_acc)
        return cache, tx.pack_step_result(n_acc, acc_tok, kv_slots)

    common = dict(tree_step=_Member(_tree_step),
                  fused_step=_Member(_fused_step), commit=_Member(_commit),
                  prefill_into_slot=_Member(_prefill_into_slot), slots=slots,
                  max_seq_len=cfg.max_seq_len, pad_id=pad_id,
                  prefill_len=prefill_len, per_lane_params=True,
                  session_defaults=defaults, sampling=sampling)
    if paged:
        return _paged_fns(cfg, params, dev, put, choose, choose_last, common,
                          n_blocks=n_blocks)

    def _prefill(tokens, lens, lane_params=None):
        tokens, lens = put(tokens, torch.int32), put(lens, torch.int32)
        cache = tx.init_cache(cfg, tokens.shape[0], device=dev)
        cache, last_logits = tx.prefill(cfg, params, tokens, lens, cache)
        return cache, choose_last(tokens, lens, last_logits, lane_params)

    def _reset_slot(cache, slot):
        return tx.reset_slot(cache, int(slot))

    def _init_cache(lanes: int):
        return tx.init_cache(cfg, lanes, device=dev)

    return StepFns(prefill=_Member(_prefill),
                   init_cache=_Member(_init_cache),
                   reset_slot=_Member(_reset_slot), **common)


def _paged_fns(cfg, params, dev, put, choose, choose_last, common, *,
               n_blocks) -> StepFns:
    """The paged layout's own members: the cohort prefill (which takes the
    block tables: the cache does not exist yet), the block scrub, and the
    prefix cache's suffix prefill and block copy; ``common`` holds the
    members both layouts share."""

    def _prefill(tokens, lens, block_tables, lane_params=None):
        tokens, lens = put(tokens, torch.int32), put(lens, torch.int32)
        cache = tx.init_paged_cache(cfg, tokens.shape[0], n_blocks,
                                    device=dev)
        cache["block_tables"] = put(block_tables, torch.int32)
        cache, last_logits = tx.prefill_paged(cfg, params, tokens, lens,
                                              cache)
        return cache, choose_last(tokens, lens, last_logits, lane_params)

    def _reset_blocks(cache, block_ids):
        return tx.reset_blocks(cache, put(block_ids, torch.int32))

    def _prefill_suffix(cache, slot, tokens, offset, slen, lane_params=None):
        tokens = put(tokens, torch.int32)
        offset, slen = put(offset, torch.int32), put(slen, torch.int32)
        # at the uncached admission's (lanes, cap) shapes: the tail's rows
        # then round as they would with the cache off
        cache, last_logits = tx.prefill_from_offset_paged(
            cfg, params, cache, int(slot), tokens, offset, slen,
            prefill_len=cap)
        last_tok = tokens.gather(1, (slen - 1)[:, None].long())
        return cache, choose(last_logits[:, None, :], last_tok,
                             (offset + slen - 1)[:, None], lane_params)[:, 0]

    def _copy_block(cache, src, dst):
        return tx.copy_paged_block(cache, int(src), int(dst))

    # the suffix prefill pads the uncached prompt tail to the smallest of a
    # doubling ladder of buckets, so its input shapes (the reference's
    # compiled executables) are the buckets touched, never the requests
    cap = common["prefill_len"] or cfg.max_seq_len
    suffix_buckets, b = [], 8
    while b < cap:
        suffix_buckets.append(b)
        b *= 2
    suffix_buckets = tuple(suffix_buckets + [cap])
    # preallocated host scratch: ``put`` copies it into fresh pinned memory
    # before the asynchronous upload, so reusing it across calls is safe
    pad_id = common["pad_id"]
    pad_bufs = {b: np.full((1, b), pad_id, np.int32) for b in suffix_buckets}
    off_buf = np.zeros((1,), np.int32)
    len_buf = np.zeros((1,), np.int32)
    suffix_member = _Member(_prefill_suffix)

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

    def _init_cache(lanes: int):
        return tx.init_paged_cache(cfg, lanes, n_blocks, device=dev)

    return StepFns(prefill=_Member(_prefill),
                   init_cache=_Member(_init_cache), reset_slot=None,
                   kv_layout="paged", block_size=cfg.kv_block_size,
                   n_blocks=n_blocks, reset_blocks=_Member(_reset_blocks),
                   prefill_suffix=prefill_suffix,
                   copy_block=_Member(_copy_block),
                   suffix_buckets=suffix_buckets, **common)


def _to_device(params, dev: torch.device):
    if isinstance(params, dict):
        return {k: _to_device(v, dev) for k, v in params.items()}
    return params.to(dev)


__all__ = ["make_session_fns"]
