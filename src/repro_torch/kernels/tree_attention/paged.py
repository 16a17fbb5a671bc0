"""Wrapper of the paged tree-attention CUDA kernel
(``csrc/paged_tree_attention.cu``).

A tensor on the card launches the kernel, after the checks of
``_build.check_cuda`` and of the shapes, the int32 table and the bool mask;
anything the kernel does not take raises — there is no fallback to a gather on
the card. A tensor on the CPU, or on ``meta`` (the dry-run's shape trace, which
launches nothing), takes the plain version (``ref.py``: gather each lane's
blocks, then the dense plain version). ``paged_tree_attention.launches`` counts
kernel launches only.

Table entries are not read on the host (that would wait for the card): the
kernel clamps an entry outside the pool into it, for memory safety, where
the plain version raises.  The serving path writes only valid entries.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import paged_tree_attention_reference


def paged_tree_attention(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_tables: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, dh); k/v pool (n_blocks, bs, K, dh); block_tables
    (B, bpl) int32; mask (B, T, bpl * bs) bool -> (B, T, H, dh) in q's
    dtype."""
    if q.device.type in ("cpu", "meta"):
        return paged_tree_attention_reference(q, k_pool, v_pool,
                                              block_tables, mask)
    B, T, H, dh = q.shape
    n_blocks, bs, K = k_pool.shape[:3]
    _build.check_cuda("paged_tree_attention", q, k_pool, v_pool)
    if k_pool.shape != (n_blocks, bs, K, dh) or v_pool.shape != k_pool.shape:
        raise ValueError(f"paged_tree_attention: k/v pool "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("paged_tree_attention: q, k and v must share a "
                         "dtype")
    for name, t, dtype in (("block_tables", block_tables, torch.int32),
                           ("mask", mask, torch.bool)):
        if t.device != q.device or not t.is_contiguous() or t.dtype != dtype:
            raise ValueError(f"paged_tree_attention: {name} must be a "
                             f"contiguous {dtype} tensor on {q.device}, got "
                             f"{t.dtype} on {t.device}")
    if block_tables.dim() != 2 or block_tables.shape[0] != B:
        raise ValueError(f"paged_tree_attention: block_tables must be "
                         f"({B}, bpl), got {tuple(block_tables.shape)}")
    bpl = block_tables.shape[1]
    if mask.shape != (B, T, bpl * bs):
        raise ValueError(f"paged_tree_attention: mask must be "
                         f"{(B, T, bpl * bs)}, got {tuple(mask.shape)}")
    if H % K or not (8 <= dh <= 256 and dh % 8 == 0) or bpl < 1:
        raise ValueError(f"paged_tree_attention: H={H}, K={K}, dh={dh}, "
                         f"bpl={bpl} not supported (H % K == 0, dh in "
                         "[8, 256], dh % 8 == 0, bpl >= 1)")
    out = torch.empty_like(q)
    lib = _build.load("paged_tree_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.paged_tree_attention_launch(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_tables.data_ptr(), mask.data_ptr(), out.data_ptr(), B, T,
            n_blocks, bs, bpl, H, K, dh, _build.DTYPE_CODE[q.dtype], stream)
    _build.check_status("paged_tree_attention", rc)
    paged_tree_attention.launches += 1
    return out


paged_tree_attention.launches = 0

__all__ = ["paged_tree_attention", "paged_tree_attention_reference"]
