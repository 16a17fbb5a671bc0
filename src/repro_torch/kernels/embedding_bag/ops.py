"""Wrapper of the fused EmbeddingBag CUDA kernel (``csrc/embedding_bag.cu``),
the port of ``repro.kernels.embedding_bag.ops.embedding_bag_fused``.

A tensor on the card launches the kernel, after the checks of
``_build.check_cuda`` and of the shapes; anything the kernel does not take
raises. A tensor on the CPU, or on ``meta`` (the dry-run's shape trace, which
launches nothing), takes the plain version (``ref.py``) on the weights
``fold_weights`` makes; the kernel takes the mask and the weights as they are
and folds them itself, to the same f32 values. ``embedding_bag_fused.launches``
counts kernel launches only.

The gradient comes from a ``torch.autograd.Function`` around both: its
forward is the kernel (or the plain version), its backward plain torch —
the reference's gradient here is XLA's transpose of ``jnp.take``, not a
Pallas kernel.  The table's gradient scatter-adds ``w[n, l] * grad[n]``
into row ``ids[n, l]`` of its field (ids in [-V, 0) wrap as in the
forward; ids out of range are dropped, as XLA's scatter drops them) with
``index_add_``, which on the card adds with atomics in no fixed order: it
matches the CPU's to a tolerance, not bit for bit.  Float ``weights`` get
``<grad[n], table[ids[n, l]]>`` (times the mask); a bool or uint8 mask
gets none.

A row window (``row_start``, ``n_rows``; ``ref.py`` says what it reads)
serves a table whose rows are split over ranks: the forward is this
rank's partial bag, the kernel's ``embedding_bag_window_launch`` on the
card, and the backward scatters into this rank's rows only (an id another
rank holds, or out of range, adds nothing to the block).
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .ref import embedding_bag_ref, take_rows, window_index


def fold_weights(ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-slot f32 weights: ones, times ``weights``, times ``mask``
    (the plain version's input, and the ``mean`` combiner's
    denominator)."""
    w = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    if weights is not None:
        w = w * weights.float()
    if mask is not None:
        w = w * mask.float()
    return w


def embedding_bag_fused(table: torch.Tensor, ids: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        weights: Optional[torch.Tensor] = None,
                        row_start: int = 0, n_rows: Optional[int] = None
                        ) -> torch.Tensor:
    """table (V, D) f32 or bf16, ids (..., L) int, optional mask / weights
    (..., L) -> (..., D): ``out[n] = sum_l w[n, l] * table[ids[n, l]]``
    accumulated in f32 in l order, rounded to the table's dtype, with
    ``w = weights * mask`` as ``fold_weights`` makes it.  A stacked table
    (F, V, D) with ids (..., F, L) gives (..., F, D), every field's bags in
    one launch.  Ids follow ``jnp.take`` (see ``ref.py``).

    ``mask`` and ``weights`` must have the ids' shape: any other shape
    raises ValueError, with no broadcast.  On the card the kernel forms the
    slot weights itself: a bool or uint8 mask is read as its bytes (no copy
    when contiguous), weights as float32 (converted from another dtype), and
    a mask of another dtype is folded into the weights first.

    ``row_start`` / ``n_rows``: the table is rows [row_start, row_start +
    V) of a table of ``n_rows`` rows (this rank's block of a row split);
    the result is the bag over the ids in that window, ids another rank
    holds adding exactly 0 (``ref.take_rows``).  ``n_rows`` None: the
    whole table."""
    for name, t in (("mask", mask), ("weights", weights)):
        if t is not None and t.shape != ids.shape:
            raise ValueError(f"embedding_bag: {name} {tuple(t.shape)} must "
                             f"have the ids' shape {tuple(ids.shape)}")
    if mask is not None and mask.dtype not in (torch.bool, torch.uint8):
        mask, weights = None, fold_weights(ids, mask, weights)
    V = table.shape[-2]
    n_rows = V if n_rows is None else int(n_rows)
    if not 0 <= row_start <= n_rows - V:
        raise ValueError(f"embedding_bag: rows [{row_start}, {row_start} + "
                         f"{V}) are not a window of {n_rows} rows")
    return _EmbeddingBag.apply(table, ids, mask, weights, int(row_start),
                               n_rows)


class _EmbeddingBag(torch.autograd.Function):
    """``embedding_bag_fused`` with a gradient for the table and for float
    weights; the mask is bool or uint8 (a float mask is folded into the
    weights first, so its gradient flows through ``fold_weights``)."""

    @staticmethod
    def forward(ctx, table, ids, mask, weights, row_start, n_rows):
        ctx.save_for_backward(table, ids, mask, weights)
        ctx.window = (row_start, n_rows)
        return _forward(table, ids, mask, weights, row_start, n_rows)

    @staticmethod
    def backward(ctx, grad):
        table, ids, mask, weights = ctx.saved_tensors
        row_start, n_rows = ctx.window
        g = grad.float()[..., None, :]                   # (..., 1, D)
        w = fold_weights(ids, mask, weights)             # (..., L)
        d_table = d_weights = None
        if ctx.needs_input_grad[0]:
            V, D = table.shape[-2:]
            idx, ok, _ = window_index(ids, n_rows, row_start, V)
            if table.dim() == 3:
                idx = idx + V * torch.arange(table.shape[0],
                                             device=ids.device)[:, None]
            vals = torch.where(ok[..., None], w[..., None] * g,
                               torch.zeros((), device=g.device))
            d_table = torch.zeros((table.numel() // D, D),
                                  dtype=torch.float32, device=table.device)
            d_table.index_add_(0, idx.reshape(-1), vals.reshape(-1, D))
            d_table = d_table.reshape(table.shape).to(table.dtype)
        if ctx.needs_input_grad[3]:
            dw = (take_rows(table, ids, row_start, n_rows).float()
                  * g).sum(-1)
            if mask is not None:
                dw = dw * mask.float()
            d_weights = dw.to(weights.dtype)
        return d_table, None, None, d_weights, None, None


def _forward(table, ids, mask, weights, row_start=0, n_rows=None):
    """The forward: the kernel on the card, the plain version on the CPU
    and on ``meta``."""
    if table.device.type in ("cpu", "meta"):
        return embedding_bag_ref(table, ids, fold_weights(ids, mask, weights),
                                 row_start, n_rows)
    stacked = table.dim() == 3
    if table.dim() not in (2, 3) or ids.dim() < (3 if stacked else 2) \
            or (stacked and ids.shape[-2] != table.shape[0]):
        raise ValueError(f"embedding_bag: table {tuple(table.shape)} and ids "
                         f"{tuple(ids.shape)}: need (V, D) with (..., L) or "
                         "(F, V, D) with (..., F, L)")
    _build.check_cuda("embedding_bag", table, aligned=False)
    for name, t in (("ids", ids), ("mask", mask), ("weights", weights)):
        if t is not None and t.device != table.device:
            raise ValueError(f"embedding_bag: {name} on {t.device}, table on "
                             f"{table.device}")
    ids = ids.to(torch.int32).contiguous()
    if mask is not None:
        mask = mask.contiguous().view(torch.uint8)
    if weights is not None:
        weights = weights.to(torch.float32).contiguous()
    F = table.shape[0] if stacked else 1
    V, D = table.shape[-2:]
    n_rows = V if n_rows is None else n_rows
    L = ids.shape[-1]
    n_bags = ids.numel() // max(L, 1)
    out = torch.empty(ids.shape[:-1] + (D,), dtype=table.dtype,
                      device=table.device)
    if n_bags * D == 0:
        return out.zero_()
    if n_bags >= 2**31 or n_rows >= 2**31:
        raise ValueError(f"embedding_bag: {n_bags} bags of a {V}-row table: "
                         "counts must stay under 2^31")
    lib = _build.load("embedding_bag")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    ptrs = (table.data_ptr(), ids.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr())
    with torch.cuda.device(table.device):
        # the whole table is the window of all n_rows rows from row 0
        rc = lib.embedding_bag_window_launch(
            *ptrs, n_bags, L, F, n_rows, row_start, V, D,
            _build.DTYPE_CODE[table.dtype], stream)
    _build.check_status("embedding_bag", rc)
    embedding_bag_fused.launches += 1
    return out


embedding_bag_fused.launches = 0

__all__ = ["embedding_bag_fused", "embedding_bag_ref", "fold_weights",
           "take_rows"]
