"""Wrapper of the causal flash-prefill CUDA kernels: ``csrc/flash_prefill.cu``
and, with ``triangular=True``, ``csrc/flash_prefill_tri.cu`` (the same
attention and bits on a longest-first schedule; the reference's op reaches
its triangular-grid Pallas kernel the same way, and no model path does).

A tensor on the card launches the kernel, after the checks of
``_build.check_cuda`` and of the shapes; anything the kernel does not take
raises. A tensor on the CPU, or on ``meta`` (the dry-run's shape trace, which
launches nothing), takes the plain version (``ref.py``), which computes the
same function for both. ``flash_prefill.launches`` and
``flash_prefill.tri_launches`` count kernel launches only.

The triangular kernel's persistent blocks take their work from an int32
counter: a fresh one per call, which the launch zeroes on the stream.
"""
from __future__ import annotations

import torch

from .. import _build
from .ref import flash_prefill_ref, flash_prefill_reference


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  triangular: bool = False) -> torch.Tensor:
    """q (B, S, H, dh); k/v (B, S, K, dh) -> causal attention (B, S, H, dh)
    in q's dtype; ``triangular`` selects the longest-first kernel."""
    if q.device.type in ("cpu", "meta"):
        return flash_prefill_ref(q, k, v)
    B, S, H, dh = q.shape
    K = k.shape[2]
    _build.check_cuda("flash_prefill", q, k, v)
    if k.shape != (B, S, K, dh) or v.shape != k.shape:
        raise ValueError(f"flash_prefill: k/v {tuple(k.shape)} / "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_prefill: q, k and v must share a dtype")
    if H % K or not (16 <= dh <= 256 and dh % 8 == 0):
        raise ValueError(f"flash_prefill: H={H}, K={K}, dh={dh} not "
                         "supported (H % K == 0, dh in [16, 256], "
                         "dh % 8 == 0)")
    out = torch.empty_like(q)
    name = "flash_prefill_tri" if triangular else "flash_prefill"
    launch = getattr(_build.load(name), f"{name}_launch")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
    with torch.cuda.device(q.device):
        if triangular:
            counter = torch.empty(1, dtype=torch.int32, device=q.device)
            ptrs.append(counter.data_ptr())
        rc = launch(*ptrs, B, S, H, K, dh, _build.DTYPE_CODE[q.dtype],
                    stream)
    _build.check_status(name, rc)
    if triangular:
        flash_prefill.tri_launches += 1
    else:
        flash_prefill.launches += 1
    return out


flash_prefill.launches = 0
flash_prefill.tri_launches = 0

__all__ = ["flash_prefill", "flash_prefill_ref", "flash_prefill_reference"]
