"""Graph networks (PyTorch port of ``repro.models.gnn``): EquiformerV2's
eSCN attention, its SO(3) machinery and the host-side fanout sampler."""
from . import equiformer, sampler, so3

__all__ = ["equiformer", "sampler", "so3"]
