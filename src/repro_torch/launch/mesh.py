"""The card's constants for the roofline (the counterpart of
``repro.launch.mesh``'s v5e constants).

H100 SXM5 80 GB, from NVIDIA's H100 data sheet at its 700 W limit: dense
rates (no 2:4 sparsity), HBM3 bandwidth and capacity.  The port runs on one
card, so there is no mesh: ``make_production_mesh``/``make_host_mesh`` and
the reference's ``ICI_BW`` have no counterpart until the multi-GPU slice
(ROADMAP A16) ports ``distributed/*`` to ``torch.distributed``.
"""
from __future__ import annotations

import torch

PEAK_FLOPS_BF16 = 989e12        # bf16 / fp16 tensor cores, dense
PEAK_FLOPS_TF32 = 495e12        # TF32 tensor cores, dense
PEAK_FLOPS_F32 = 67e12          # f32 outside the tensor cores
HBM_BW = 3.35e12                # bytes/s
HBM_PER_CHIP = 80e9             # bytes

# FLOP/s of a product by its operands' dtype.  f32 runs at the CUDA-core
# rate: the port keeps TF32 off (``torch.backends.cuda.matmul.allow_tf32``
# stays False in every path that is timed).
PEAK_FLOPS = {torch.bfloat16: PEAK_FLOPS_BF16, torch.float16: PEAK_FLOPS_BF16,
              torch.float32: PEAK_FLOPS_F32}


def peak_flops(dtype) -> float:
    """Peak FLOP/s for products in ``dtype`` (a ``torch.dtype`` or its name,
    e.g. ``"bfloat16"``); f64 and integer products at the f32 rate."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return PEAK_FLOPS.get(dtype, PEAK_FLOPS_F32)


__all__ = ["PEAK_FLOPS_BF16", "PEAK_FLOPS_TF32", "PEAK_FLOPS_F32", "HBM_BW",
           "HBM_PER_CHIP", "PEAK_FLOPS", "peak_flops"]
