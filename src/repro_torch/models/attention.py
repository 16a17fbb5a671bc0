"""Pluggable attention backends for the transformer serving stack (PyTorch
port of ``repro.models.attention``).

A backend implements the two serving phases:

  * ``prefill_attention(cfg, q, k, v, positions, len_mask)`` —
    full-sequence causal attention (``prefill`` / ``prefill_into_slot``):
    q (B, S, H, dh), k/v (B, S, K, dh) -> (B, S, H, dh).
  * ``make_tree_attend(cfg, cache_lens, tree_mask, S_max, layout=None)``
    — returns the per-layer tree-decode closure
    ``attend(q, k_new, v_new, k_cache, v_cache) -> out`` that writes the T
    draft-slot KV rows at ``cache_len + slot`` of the layer's cache (in
    place, where JAX donates the buffer) and attends the slots against the
    whole cache.
  * ``make_paged_tree_attend(cfg, block_tables, cache_lens, tree_mask,
    slot_valid=None, layout=None)`` — the same closure over the paged
    layout, whose per-layer caches are the (n_blocks, block_size, K, dh)
    block pool reached through each lane's block table.

``layout`` is the model's ``transformer.Layout`` of the call (None without
a mesh): where a rank computes every KV head but its query heads read
some of them (a ``model`` axis that splits a head), the closure writes
every head and attends through ``layout.per_kv_head``: each run of query
heads on the one cache head it reads.

Registered here:

  dense — plain torch GQA over the full cache (reference semantics;
          materializes the (B, T, S) scores per layer); on the paged
          layout it gathers each lane's blocks first (the parity oracle)
  cuda  — the port's CUDA kernels: kernels/flash_prefill for prefill,
          kernels/tree_attention for the decode step on the dense layout
          and its paged twin on the paged layout (the plain versions when
          the tensors lie on the CPU)
  flash_decode — sequence-parallel decode over a mesh's ranks
          (repro_torch.distributed.flash_decode); dense without a mesh,
          and dense for prefill and the paged layout

Both keep the reference's invariants: the mask semantics of
``build_full_tree_mask``, draft slot i's KV at row ``cache_len + i`` of
its lane (the committed prefix is untouched), and shapes that depend on
nothing but the input shapes.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.layers import (causal_prefill_mask, gqa_attention,
                                       gqa_attention_chunked)


# ------------------------------------------------------------ shared helpers
def scatter_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
               cache_lens: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write the (B, T) draft-slot KV rows at ``cache_len + slot`` of the
    (B, S, K, dh) caches, in place."""
    B, T = k.shape[:2]
    bidx = torch.arange(B, device=k.device)[:, None]
    sidx = cache_lens.long()[:, None] + torch.arange(T, device=k.device)
    k_cache[bidx, sidx] = k.to(k_cache.dtype)
    v_cache[bidx, sidx] = v.to(v_cache.dtype)
    return k_cache, v_cache


def scatter_kv_paged(k_cache: torch.Tensor, v_cache: torch.Tensor,
                     slot_rows: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paged twin of ``scatter_kv``: write the (B, T) draft-slot KV rows at
    precomputed physical rows of the (n_blocks, block_size, K, dh) pool, in
    place.  Rows are distinct across lanes (block ownership is exclusive);
    only NULL-block garbage of idle lanes or pad slots ever collides."""
    nb, bs, K, dh = k_cache.shape
    flat = slot_rows.reshape(-1)
    k_cache.view(nb * bs, K, dh)[flat] = k.reshape(-1, K, dh).to(
        k_cache.dtype)
    v_cache.view(nb * bs, K, dh)[flat] = v.reshape(-1, K, dh).to(
        v_cache.dtype)
    return k_cache, v_cache


def build_full_tree_mask(cache_lens: torch.Tensor, tree_mask: torch.Tensor,
                         S_max: int) -> torch.Tensor:
    """(B, T, T) ancestor-closure -> (B, T, S_max): past or tree block."""
    B, T = tree_mask.shape[:2]
    j = torch.arange(S_max, device=tree_mask.device)[None, None, :]
    lens = cache_lens.long()[:, None, None]
    past = j < lens
    rel = j - lens                                         # slot index
    in_block = (rel >= 0) & (rel < T)
    relc = rel.clamp(0, T - 1).expand(B, T, S_max)
    tm = tree_mask.bool().gather(2, relc)    # tm[b,i,s] = tree[b,i,relc[b,s]]
    return past | (in_block & tm)


def dense_prefill_attention(cfg, q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, positions: torch.Tensor,
                            len_mask: torch.Tensor) -> torch.Tensor:
    """Reference causal prefill: the query-chunked loop when
    ``cfg.q_chunk`` divides S and S > q_chunk (the train config's 512),
    else one (B, T, S) mask (the serving configs' q_chunk 0)."""
    T = q.shape[1]
    if cfg.q_chunk and T % cfg.q_chunk == 0 and T > cfg.q_chunk:
        return gqa_attention_chunked(q, k, v, positions, len_mask,
                                     cfg.q_chunk)
    return gqa_attention(q, k, v, causal_prefill_mask(positions, len_mask))


def _per_kv_head(layout) -> Callable:
    """``by(attend, q, k, v)``: ``layout.per_kv_head`` (each run of a
    rank's query heads against the KV head it reads), ``attend(q, k, v)``
    without a layout."""
    if layout is None:
        return lambda attend, q, k, v: attend(q, k, v)
    return layout.per_kv_head


# ---------------------------------------------------------------- backends
class AttentionBackend:
    """Base class doubling as the ``dense`` reference backend."""

    name = "dense"

    def prefill_attention(self, cfg, q, k, v, positions, len_mask
                          ) -> torch.Tensor:
        return dense_prefill_attention(cfg, q, k, v, positions, len_mask)

    def make_tree_attend(self, cfg, cache_lens: torch.Tensor,
                         tree_mask: torch.Tensor, S_max: int,
                         layout=None) -> Callable:
        full_mask = build_full_tree_mask(cache_lens, tree_mask, S_max)
        by = _per_kv_head(layout)

        def attend(q, k, v, k_cache, v_cache):
            scatter_kv(k_cache, v_cache, cache_lens, k, v)
            return by(lambda q, k, v: gqa_attention(
                q, k, v, full_mask, softmax_in_f32=cfg.attn_score_f32),
                q, k_cache, v_cache)

        return attend

    def _paged_geometry(self, cfg, block_tables: torch.Tensor,
                        cache_lens: torch.Tensor, tree_mask: torch.Tensor,
                        slot_valid=None):
        """Shared paged-decode precompute: the (B, T, S_virtual) full mask
        and the physical rows of the draft-slot scatter.

        slot_valid (B, T) bool: slots to actually scatter; invalid slots'
        KV writes redirect to the NULL block (row 0).  Used by the bucketed
        suffix prefill, whose pad slots may sit past the lane's table
        coverage, where ``paged_row_index`` clipping would otherwise alias
        them onto the last real block — committed KV."""
        from repro_torch.models.transformer import paged_row_index
        T = tree_mask.shape[1]
        S_virtual = block_tables.shape[1] * cfg.kv_block_size
        full_mask = build_full_tree_mask(cache_lens, tree_mask, S_virtual)
        slots = cache_lens.long()[:, None] + torch.arange(
            T, device=tree_mask.device)
        slot_rows = paged_row_index(block_tables, slots, cfg.kv_block_size)
        if slot_valid is not None:
            slot_rows = torch.where(slot_valid, slot_rows,
                                    torch.zeros_like(slot_rows))
        return full_mask, slot_rows

    def make_paged_tree_attend(self, cfg, block_tables: torch.Tensor,
                               cache_lens: torch.Tensor,
                               tree_mask: torch.Tensor,
                               slot_valid=None, layout=None) -> Callable:
        """Tree-decode closure over the paged cache.  Reference semantics:
        gather each lane's blocks back into a contiguous (B, S_virtual)
        window and reuse the dense math (the parity oracle of the paged
        kernel; positions beyond a lane's coverage resolve to NULL-block
        garbage and are masked)."""
        from repro_torch.models.transformer import paged_row_index
        full_mask, slot_rows = self._paged_geometry(
            cfg, block_tables, cache_lens, tree_mask, slot_valid)
        B, _, S_virtual = full_mask.shape
        all_pos = torch.arange(S_virtual, device=full_mask.device)
        flat = paged_row_index(block_tables, all_pos[None].expand(
            B, S_virtual), cfg.kv_block_size).reshape(-1)
        by = _per_kv_head(layout)

        def attend(q, k, v, k_cache, v_cache):
            scatter_kv_paged(k_cache, v_cache, slot_rows, k, v)
            nb, bs, K, dh = k_cache.shape
            kg = k_cache.view(nb * bs, K, dh)[flat].reshape(B, S_virtual, K,
                                                            dh)
            vg = v_cache.view(nb * bs, K, dh)[flat].reshape(B, S_virtual, K,
                                                            dh)
            return by(lambda q, k, v: gqa_attention(
                q, k, v, full_mask, softmax_in_f32=cfg.attn_score_f32),
                q, kg, vg)

        return attend


class CudaBackend(AttentionBackend):
    """The port's CUDA kernels for both phases (twin of the reference's
    ``PallasBackend``).

    The flash-prefill kernel is causal over the buffer index; the serving
    prefill paths satisfy ``positions == arange(S)``, and pad rows sit
    causally *after* every real query, so ``len_mask`` needs no separate
    treatment — real rows see exactly the dense mask, pad rows only feed
    cache rows beyond ``lens`` (garbage, never attended).
    """

    name = "cuda"

    def prefill_attention(self, cfg, q, k, v, positions, len_mask
                          ) -> torch.Tensor:
        from repro_torch.kernels.flash_prefill.ops import flash_prefill
        return flash_prefill(q, k, v)

    def make_tree_attend(self, cfg, cache_lens, tree_mask, S_max,
                         layout=None):
        from repro_torch.kernels.tree_attention.ops import tree_attention
        full_mask = build_full_tree_mask(cache_lens, tree_mask, S_max)
        by = _per_kv_head(layout)

        def attend(q, k, v, k_cache, v_cache):
            scatter_kv(k_cache, v_cache, cache_lens, k, v)
            return by(lambda q, k, v: tree_attention(q, k, v, full_mask),
                      q, k_cache, v_cache)

        return attend

    def make_paged_tree_attend(self, cfg, block_tables, cache_lens,
                               tree_mask, slot_valid=None, layout=None):
        """The paged kernel reads each lane's keys through its block table:
        no contiguous per-lane cache is gathered (a CUDA call the kernel
        cannot take raises; it never falls back to the gather)."""
        from repro_torch.kernels.tree_attention.paged import \
            paged_tree_attention
        full_mask, slot_rows = self._paged_geometry(
            cfg, block_tables, cache_lens, tree_mask, slot_valid)
        by = _per_kv_head(layout)

        def attend(q, k, v, k_cache, v_cache):
            scatter_kv_paged(k_cache, v_cache, slot_rows, k, v)
            return by(lambda q, k, v: paged_tree_attention(
                q, k, v, block_tables, full_mask), q, k_cache, v_cache)

        return attend


# ---------------------------------------------------------------- registry
_REGISTRY: Dict[str, AttentionBackend] = {}


def register_backend(backend) -> None:
    """Register a backend instance under ``backend.name`` (last wins)."""
    _REGISTRY[backend.name] = backend


def get_backend(name: str):
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown attention backend {name!r}; registered: "
            f"{', '.join(sorted(_REGISTRY))}") from None


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register_backend(AttentionBackend())           # "dense"
register_backend(CudaBackend())

from repro_torch.distributed.flash_decode import FlashDecodeBackend  # noqa: E402

register_backend(FlashDecodeBackend())

__all__ = ["AttentionBackend", "CudaBackend", "register_backend",
           "get_backend", "available_backends", "scatter_kv",
           "scatter_kv_paged", "build_full_tree_mask",
           "dense_prefill_attention"]
