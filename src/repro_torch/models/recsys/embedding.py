"""Embedding primitives for recsys (PyTorch port of
``repro.models.recsys.embedding``): lookups, fixed-shape and ragged bags,
the quotient-remainder hashed lookup, table init.

Lookups follow ``jnp.take`` (an id in [-V, 0) wraps, one out of range gives
a NaN row).  The ``sum`` and ``mean`` bags go through the fused EmbeddingBag
kernel (``repro_torch.kernels.embedding_bag``: CUDA on the card, its plain
version on the CPU); a stacked (F, V, D) table with ids (..., F, L) bags
every field in one launch.  The reference's ``shard_table`` is not ported:
it only constrains a sharding, a no-op without a mesh (multi-GPU is ROADMAP
A16).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.embedding_bag.ops import (embedding_bag_fused,
                                                   fold_weights, take_rows)
from .common import normal


def lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table (V, D), ids (...) -> (..., D)."""
    return take_rows(table, ids)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  weights: Optional[torch.Tensor] = None,
                  mask: Optional[torch.Tensor] = None,
                  combiner: str = "sum") -> torch.Tensor:
    """Fixed-shape multi-hot bag: ids (..., L) -> (..., D); or a stacked
    table (F, V, D) with ids (..., F, L) -> (..., F, D).

    ``mask`` (..., L) marks valid slots (padding excluded); ``weights`` are
    optional per-sample weights.
    """
    if combiner == "sum":
        return embedding_bag_fused(table, ids, mask, weights)
    if combiner == "mean":
        denom = fold_weights(ids, mask, weights).sum(-1, keepdim=True)
        return (embedding_bag_fused(table, ids, mask, weights)
                / denom.clamp_min(1.0).to(table.dtype))
    if combiner == "max":
        emb = take_rows(table, ids)                      # (..., L, D)
        w = fold_weights(ids, mask, weights).to(emb.dtype)
        emb = emb * w[..., None]
        neg = torch.where(w[..., None] > 0, emb,
                          torch.full((), float("-inf"), dtype=emb.dtype,
                                     device=emb.device))
        out = neg.amax(dim=-2)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    raise ValueError(combiner)


def embedding_bag_ragged(table: torch.Tensor, flat_ids: torch.Tensor,
                         segment_ids: torch.Tensor, num_segments: int,
                         weights: Optional[torch.Tensor] = None,
                         combiner: str = "sum") -> torch.Tensor:
    """Ragged bag: flat_ids (N,), segment_ids (N,) -> (num_segments, D).
    Segment ids outside [0, num_segments) are dropped, as
    ``jax.ops.segment_sum`` drops them; an empty segment sums to 0 and has
    the max -inf."""
    emb = take_rows(table, flat_ids)                     # (N, D)
    if weights is not None:
        emb = emb * weights[:, None].to(emb.dtype)
    seg = segment_ids.long()
    keep = ((seg >= 0) & (seg < num_segments))[:, None]
    seg = seg.clamp(0, max(num_segments - 1, 0))

    def seg_sum(x):
        x = torch.where(keep, x, torch.zeros_like(x))
        return torch.zeros((num_segments, x.shape[-1]), dtype=x.dtype,
                           device=x.device).index_add_(0, seg, x)

    if combiner == "sum":
        return seg_sum(emb)
    if combiner == "mean":
        n = seg_sum(torch.ones_like(emb[:, :1]))
        return seg_sum(emb) / n.clamp_min(1.0)
    if combiner == "max":
        neg_inf = torch.full((), float("-inf"), dtype=emb.dtype,
                             device=emb.device)
        x = torch.where(keep, emb, neg_inf)
        out = torch.full((num_segments, emb.shape[-1]), float("-inf"),
                         dtype=emb.dtype,
                         device=emb.device)
        return out.scatter_reduce_(0, seg[:, None].expand_as(x), x, "amax")
    raise ValueError(combiner)


def hashed_lookup(q_table: torch.Tensor, r_table: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """Quotient-remainder trick [arXiv:1909.02107]: O(2·sqrt(V)) rows serve a
    vocab of size V.  q_table (Vq, D), r_table (Vr, D)."""
    vr = r_table.shape[0]
    ids = ids.long()
    q = take_rows(q_table, torch.div(ids, vr, rounding_mode="floor"))
    r = take_rows(r_table, torch.remainder(ids, vr))
    return q * r


def init_table(gen: torch.Generator, rows: int, dim: int,
               scale: float = 0.01, dtype: torch.dtype = torch.float32
               ) -> torch.Tensor:
    """N(0, scale^2) rows drawn in f32 with ``gen`` on its own device (the
    reference's distribution; another generator, so other numbers)."""
    return normal(gen, (rows, dim), scale, dtype)


__all__ = ["lookup", "embedding_bag", "embedding_bag_ragged", "hashed_lookup",
           "init_table"]
