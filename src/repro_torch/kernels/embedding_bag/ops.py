"""Wrapper of the fused EmbeddingBag CUDA kernel (``csrc/embedding_bag.cu``),
the port of ``repro.kernels.embedding_bag.ops.embedding_bag_fused``.

A tensor on the card launches the kernel, after the checks of
``_build.check_cuda`` and of the shapes; anything the kernel does not take
raises.  A tensor on the CPU takes the plain version (``ref.py``) on the
weights ``fold_weights`` makes; the kernel takes the mask and the weights
as they are and folds them itself, to the same f32 values.
``embedding_bag_fused.launches`` counts kernel launches only.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .ref import embedding_bag_ref, take_rows


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
                        weights: Optional[torch.Tensor] = None
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
    a mask of another dtype is folded into the weights first."""
    for name, t in (("mask", mask), ("weights", weights)):
        if t is not None and t.shape != ids.shape:
            raise ValueError(f"embedding_bag: {name} {tuple(t.shape)} must "
                             f"have the ids' shape {tuple(ids.shape)}")
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, fold_weights(ids, mask, weights))
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
    if mask is not None and mask.dtype not in (torch.bool, torch.uint8):
        mask, weights = None, fold_weights(ids, mask, weights)
    if mask is not None:
        mask = mask.contiguous().view(torch.uint8)
    if weights is not None:
        weights = weights.to(torch.float32).contiguous()
    F = table.shape[0] if stacked else 1
    V, D = table.shape[-2:]
    L = ids.shape[-1]
    n_bags = ids.numel() // max(L, 1)
    out = torch.empty(ids.shape[:-1] + (D,), dtype=table.dtype,
                      device=table.device)
    if n_bags * D == 0:
        return out.zero_()
    if n_bags >= 2**31 or V >= 2**31:
        raise ValueError(f"embedding_bag: {n_bags} bags of a {V}-row table: "
                         "counts must stay under 2^31")
    lib = _build.load("embedding_bag")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    with torch.cuda.device(table.device):
        rc = lib.embedding_bag_launch(
            table.data_ptr(), ids.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if weights is None else weights.data_ptr(), out.data_ptr(),
            n_bags, L, F, V, D, _build.DTYPE_CODE[table.dtype], stream)
    _build.check_status("embedding_bag", rc)
    embedding_bag_fused.launches += 1
    return out


embedding_bag_fused.launches = 0

__all__ = ["embedding_bag_fused", "embedding_bag_ref", "fold_weights",
           "take_rows"]
