"""Plain PyTorch version of the fused EmbeddingBag kernel (twin of
``repro.kernels.embedding_bag.ref.embedding_bag_ref``).

Row lookups follow ``jnp.take(table, ids, axis=0)``, which the reference's
model path and its oracle use: an id in [-V, 0) wraps to id + V, and an id
at or past V or below -V gives a NaN row — which stays NaN under a zero
weight (NaN * 0).  A stacked (F, V, D) table serves F fields at once: bag
(..., f, :) reads rows of table[f], and an id out of field f's range never
reads another field's row.

A row window (``row_start``, ``n_rows``): the table is one rank's block,
rows [row_start, row_start + V_local) of a table of ``n_rows`` rows split
over ranks.  An id wraps by ``n_rows``; one in the window reads row
id - row_start of the block, one in [0, n_rows) outside it gives a zero
row, one out of [0, n_rows) the NaN row, so that the ranks' results sum
to the whole table's (the CUDA kernel's window does the same).
"""
from __future__ import annotations

from typing import Optional

import torch


def window_index(ids: torch.Tensor, n_rows: int, row_start: int,
                 local_rows: int):
    """(index into the block, clamped; in the window; in [0, n_rows)) of
    ``ids`` wrapped as ``jnp.take`` wraps them."""
    ids = ids.long()
    idx = torch.where(ids < 0, ids + n_rows, ids)
    ok = (idx >= 0) & (idx < n_rows)
    idx = idx - row_start
    mine = ok & (idx >= 0) & (idx < local_rows)
    return idx.clamp(0, local_rows - 1), mine, ok


def take_rows(table: torch.Tensor, ids: torch.Tensor, row_start: int = 0,
              n_rows: Optional[int] = None) -> torch.Tensor:
    """``jnp.take(table, ids, axis=0)``: table (V, D) and ids (...) ->
    (..., D); or a stacked table (F, V, D) and ids (..., F, L) ->
    (..., F, L, D), field f's ids into table[f].  With a row window
    (``n_rows`` the whole table's rows), an id another rank's rows hold
    gives a zero row."""
    stacked = table.dim() == 3
    V = table.shape[-2]
    n_rows = V if n_rows is None else n_rows
    idx, mine, ok = window_index(ids, n_rows, row_start, V)
    if stacked:
        F = table.shape[0]
        idx = idx + V * torch.arange(F, device=ids.device)[:, None]
    rows = table.reshape(-1, table.shape[-1])[idx]
    fill = torch.where(ok, 0.0, float("nan")).to(table.dtype)
    return torch.where(mine[..., None], rows, fill[..., None])


def embedding_bag_ref(table: torch.Tensor, ids: torch.Tensor,
                      weights: torch.Tensor, row_start: int = 0,
                      n_rows: Optional[int] = None) -> torch.Tensor:
    """table (V, D), ids (..., L), weights (..., L) f32 -> (..., D); or
    table (F, V, D), ids (..., F, L) -> (..., F, D): the weighted sum of
    each bag's rows in f32, slot by slot in l order from 0 (each product
    rounded, then added: the kernel's order, so the two agree bit for bit),
    rounded once to the table's dtype.  ``row_start`` / ``n_rows``: a row
    window, as ``take_rows``'s."""
    emb = take_rows(table, ids, row_start, n_rows).float()
    w = weights.float()
    acc = torch.zeros(emb.shape[:-2] + emb.shape[-1:], dtype=torch.float32,
                      device=emb.device)
    for l in range(emb.shape[-2]):
        acc = acc + emb[..., l, :] * w[..., l, None]
    return acc.to(table.dtype)


__all__ = ["embedding_bag_ref", "take_rows", "window_index"]
