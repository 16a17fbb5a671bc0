"""Mesh builders over the ``torch.distributed`` world and the card's
constants for the roofline (the counterpart of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; ``pod`` is an outer
data-parallel axis.

Functions (never module-level constants), so importing this module
touches no process group; each builds a ``repro_torch.distributed.Mesh``
over the world that ``init_process_group`` set up.  The reference's
``ICI_BW`` (v5e links) has no counterpart yet: the NVLink constant and its
source come with the roofline's collective term (ROADMAP A16b).

H100 SXM5 80 GB, from NVIDIA's H100 data sheet at its 700 W limit: dense
rates (no 2:4 sparsity), HBM3 bandwidth and capacity.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) with ``pod``; the
    world must have exactly 256 (512) ranks."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    need = 512 if multi_pod else 256
    if _world_size() != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks; this one has {_world_size()}")
    return Mesh(shape)


def make_host_mesh(data: int = 1, model: int = 1, device=None) -> Mesh:
    """Small (data, model) mesh over whatever ranks exist (tests / local
    runs), with the reference's clamps; data × model must then be the
    world size."""
    n = _world_size()
    data = min(data, n)
    model = min(model, max(n // data, 1))
    return Mesh({"data": data, "model": model}, device=device)


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


__all__ = ["make_production_mesh", "make_host_mesh", "PEAK_FLOPS_BF16",
           "PEAK_FLOPS_TF32", "PEAK_FLOPS_F32", "HBM_BW", "HBM_PER_CHIP",
           "PEAK_FLOPS", "peak_flops"]
