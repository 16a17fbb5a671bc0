"""Wrapper of the tree-attention CUDA kernel (``csrc/tree_attention.cu``).

A tensor on the card launches the kernel, after the checks of
``_build.check_cuda`` and of the shapes; anything the kernel does not take
raises.  A tensor on the CPU takes the plain version (``ref.py``) — the only
path the CPU tests can run.  ``tree_attention.launches`` counts kernel
launches (never plain-version calls), so a run can show that the serving
path went through the kernel.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import tree_attention_ref, tree_attention_reference


def tree_attention(q: torch.Tensor, k_cache: torch.Tensor,
                   v_cache: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q (B, T, H, dh); k/v (B, S, K, dh); mask (B, T, S) bool
    -> (B, T, H, dh) in q's dtype."""
    if q.device.type == "cpu":
        return tree_attention_reference(q, k_cache, v_cache, mask)
    B, T, H, dh = q.shape
    S, K = k_cache.shape[1], k_cache.shape[2]
    _build.check_cuda("tree_attention", q, k_cache, v_cache, mask)
    if k_cache.shape != (B, S, K, dh) or v_cache.shape != k_cache.shape:
        raise ValueError(f"tree_attention: k/v {tuple(k_cache.shape)} / "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if mask.shape != (B, T, S) or mask.dtype != torch.bool:
        raise ValueError(f"tree_attention: mask must be bool {(B, T, S)}, "
                         f"got {mask.dtype} {tuple(mask.shape)}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("tree_attention: q, k and v must share a dtype")
    if H % K or not (16 <= dh <= 256 and dh % 8 == 0):
        raise ValueError(f"tree_attention: H={H}, K={K}, dh={dh} not "
                         "supported (H % K == 0, dh in [16, 256], "
                         "dh % 8 == 0)")
    out = torch.empty_like(q)
    lib = _build.load("tree_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        rc = lib.tree_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            mask.data_ptr(), out.data_ptr(), B, T, S, H, K, dh,
            _build.DTYPE_CODE[q.dtype], stream)
    _build.check_status("tree_attention", rc)
    tree_attention.launches += 1
    return out


tree_attention.launches = 0

__all__ = ["tree_attention", "tree_attention_ref", "tree_attention_reference"]
