"""Plain PyTorch version of the fused EmbeddingBag kernel (twin of
``repro.kernels.embedding_bag.ref.embedding_bag_ref``).

Row lookups follow ``jnp.take(table, ids, axis=0)``, which the reference's
model path and its oracle use: an id in [-V, 0) wraps to id + V, and an id
at or past V or below -V gives a NaN row — which stays NaN under a zero
weight (NaN * 0).  A stacked (F, V, D) table serves F fields at once: bag
(..., f, :) reads rows of table[f], and an id out of field f's range never
reads another field's row.
"""
from __future__ import annotations

import torch


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: table (V, D) and ids (...) ->
    (..., D); or a stacked table (F, V, D) and ids (..., F, L) ->
    (..., F, L, D), field f's ids into table[f]."""
    stacked = table.dim() == 3
    V = table.shape[-2]
    ids = ids.long()
    idx = torch.where(ids < 0, ids + V, ids)
    ok = (idx >= 0) & (idx < V)
    idx = idx.clamp(0, V - 1)
    if stacked:
        F = table.shape[0]
        idx = idx + V * torch.arange(F, device=ids.device)[:, None]
    rows = table.reshape(-1, table.shape[-1])[idx]
    return torch.where(ok[..., None], rows,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """table (V, D), ids (..., L), weights (..., L) f32 -> (..., D); or
    table (F, V, D), ids (..., F, L) -> (..., F, D): the weighted sum of
    each bag's rows in f32, slot by slot in l order from 0 (each product
    rounded, then added: the kernel's order, so the two agree bit for bit),
    rounded once to the table's dtype."""
    emb = take_rows(table, ids).float()
    w = weights.float()
    acc = torch.zeros(emb.shape[:-2] + emb.shape[-1:], dtype=torch.float32,
                      device=emb.device)
    for l in range(emb.shape[-2]):
        acc = acc + emb[..., l, :] * w[..., l, None]
    return acc.to(table.dtype)


__all__ = ["embedding_bag_ref", "take_rows"]
