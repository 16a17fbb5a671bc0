"""Wrapper of the fused EmbeddingBag CUDA kernel (``csrc/embedding_bag.cu``),
the port of ``repro.kernels.embedding_bag.ops.embedding_bag_fused``.

A tensor on the card launches the kernel, after the checks of
``_build.check_cuda`` and of the shapes; anything the kernel does not take
raises.  A tensor on the CPU takes the plain version (``ref.py``).
``embedding_bag_fused.launches`` counts kernel launches only.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import _build
from .ref import embedding_bag_ref, take_rows


def fold_weights(ids: torch.Tensor, mask: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The per-slot f32 weights: ones, times ``weights``, times ``mask``."""
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
    accumulated in f32 in l order, rounded to the table's dtype.  A stacked
    table (F, V, D) with ids (..., F, L) gives (..., F, D), every field's
    bags in one launch.  Ids follow ``jnp.take`` (see ``ref.py``)."""
    w = fold_weights(ids, mask, weights)
    if table.device.type == "cpu":
        return embedding_bag_ref(table, ids, w)
    stacked = table.dim() == 3
    if table.dim() not in (2, 3) or ids.dim() < (3 if stacked else 2) \
            or (stacked and ids.shape[-2] != table.shape[0]):
        raise ValueError(f"embedding_bag: table {tuple(table.shape)} and ids "
                         f"{tuple(ids.shape)}: need (V, D) with (..., L) or "
                         "(F, V, D) with (..., F, L)")
    _build.check_cuda("embedding_bag", table)
    ids = ids.to(torch.int32).contiguous()
    w = w.contiguous()
    for name, t in (("ids", ids), ("weights", w)):
        if t.device != table.device:
            raise ValueError(f"embedding_bag: {name} on {t.device}, table on "
                             f"{table.device}")
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
            table.data_ptr(), ids.data_ptr(), w.data_ptr(), out.data_ptr(),
            n_bags, L, F, V, D, _build.DTYPE_CODE[table.dtype], stream)
    _build.check_status("embedding_bag", rc)
    embedding_bag_fused.launches += 1
    return out


embedding_bag_fused.launches = 0

__all__ = ["embedding_bag_fused", "embedding_bag_ref", "fold_weights",
           "take_rows"]
