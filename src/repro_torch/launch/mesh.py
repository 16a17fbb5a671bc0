"""Mesh builders over the ``torch.distributed`` world and the constants
of the port's model of an H100 cluster for the roofline (the counterpart
of ``repro.launch.mesh``).

Single pod: (data=16, model=16) = 256 ranks.
Multi-pod:  (pod=2, data=16, model=16) = 512 ranks; ``pod`` is an outer
data-parallel axis.

Functions (never module-level constants), so importing this module
touches no process group; each builds a ``repro_torch.distributed.Mesh``
over the world that ``init_process_group`` set up, or, given a ``rank``,
that rank of the production mesh traced without a world
(``TracedMesh``: the dry-run's mesh legs).

The cluster the roofline prices: H100 SXM5 80 GB cards, from NVIDIA's
H100 data sheet at its 700 W limit (dense rates, no 2:4 sparsity; HBM3
bandwidth and capacity), eight to a node on NVLink, each node's cards on
the network through one ConnectX-7 port a card (a DGX H100).  It stands
in for the reference's single ``ICI_BW`` (a v5e link): a collective over
a group whose ranks lie in one node of eight consecutive ranks runs at the
NVLink rate, any other group at the network's (``link_rate``).  Ranks lie
on the mesh in row-major order, so on (16, 16) a ``model`` group (16
consecutive ranks) spans two nodes and a ``data`` group (stride 16)
sixteen: both are priced at the network's rate.
"""
from __future__ import annotations

from typing import Iterable, Optional

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import Mesh, TracedMesh


def _world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_production_mesh(*, multi_pod: bool = False,
                         rank: Optional[int] = None) -> Mesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) with ``pod``.  Without
    ``rank`` the world must have exactly 256 (512) ranks; with it, that
    rank of the mesh traced without a world (``TracedMesh``, on the meta
    device)."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi_pod else \
        {"data": 16, "model": 16}
    if rank is not None:
        return TracedMesh(shape, rank)
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


# The links.  NVLink 4 on H100 SXM5: 900 GB/s a card, both directions
# together, 450 GB/s each way (NVIDIA H100 Tensor Core GPU data sheet).
NVLINK_BW = 450e9               # bytes/s each way, inside a node
# Between nodes: one 400 Gb/s ConnectX-7 port a card (NVIDIA DGX H100 data
# sheet: eight single-port ConnectX-7 for the cluster network), 50 GB/s
# each way.
NET_BW = 50e9                   # bytes/s each way, across nodes
GPUS_PER_NODE = 8               # DGX H100: eight H100 SXM5 a node


def link_rate(ranks: Iterable[int]) -> float:
    """Bytes/s each way a rank of a collective over the global ``ranks``:
    NVLink's where they lie in one node of GPUS_PER_NODE consecutive
    ranks, the network's otherwise."""
    return NVLINK_BW if len({r // GPUS_PER_NODE for r in ranks}) == 1 \
        else NET_BW


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


__all__ = ["make_production_mesh", "make_host_mesh", "NVLINK_BW", "NET_BW",
           "GPUS_PER_NODE", "link_rate", "PEAK_FLOPS_BF16",
           "PEAK_FLOPS_TF32", "PEAK_FLOPS_F32", "HBM_BW", "HBM_PER_CHIP",
           "PEAK_FLOPS", "peak_flops"]
