"""Shared cell-building helpers for the dry-run (the counterpart of
``repro.configs.common``).

A cell's arguments are ``meta`` tensors: shapes and dtypes with no storage,
as the reference's ``jax.ShapeDtypeStruct``s are.  ``launch.dryrun`` runs
``cell.fn(*cell.args)`` on them to count its products, bytes and live
memory.  A cell carries the reference's logical ``axes`` of its arguments
and its ``rules``; ``build_cell(shape, mesh)`` makes its arguments one
rank's blocks as the port keeps them under ``sharding_ctx(mesh, rules)``
(``Cell.shardings``: the parameters by ``placement``, the optimizer state
as its parameters (``opt_state_axes``), a cache by its sharding, the
inputs whole).  Every cell is placed.  The port updates its caches in
place, so a cell donates nothing.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.distributed.sharding import (DEFAULT_RULES, NamedSharding,
                                              PartitionSpec, ShardingRules,
                                              placement)
from repro_torch.training.optimizer import AdamWState


def abstract(shape: Sequence[int], dtype) -> torch.Tensor:
    """A ``meta`` tensor of ``shape`` and ``dtype`` (a ``torch.dtype`` or
    its name, e.g. ``"int32"``): the counterpart of the reference's
    ``sds``."""
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def pad_to_multiple(n: int, mult: int) -> int:
    return -(-n // mult) * mult


def opt_state_axes(param_axes: Any) -> AdamWState:
    """Logical axes for ``AdamWState(step, mu, nu)``: the step whole, each
    moment placed as its parameter (the reference's)."""
    return AdamWState(step=(), mu=param_axes, nu=param_axes)


def tensor_leaves(tree: Any):
    """The tensors of a nested dict / list / tuple (NamedTuples too)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensor_leaves(v)


class Cell:
    """One (arch × shape) dry-run cell: ``fn(*args)`` on meta tensors.

    ``fn`` is the program the cost is counted on.  ``memory_fn``, where it
    is given, is the program that runs and whose live memory counts, on the
    same arguments: the reference's two builds of a cell (its ``fast``
    build for memory, the other for cost), which differ only for train_4k
    (4 microbatches against the whole batch at once).

    ``axes`` is the tree of the arguments' logical axes (a leaf a tuple of
    names, or a ``PartitionSpec`` where the cache's sharding is not a
    logical one), ``rules`` the cell's sharding rules.  Under a mesh
    ``args`` are this rank's blocks and ``global_args`` the whole
    arguments (``args`` itself without one)."""

    def __init__(self, arch: str, shape: str, kind: str, fn: Callable,
                 args: Tuple, meta: Optional[Dict] = None,
                 memory_fn: Optional[Callable] = None, axes: Any = None,
                 rules: Optional[ShardingRules] = None):
        self.arch = arch
        self.shape = shape
        self.kind = kind          # train | decode | prefill | score
        self.fn = fn
        self.args = self.global_args = args
        self.meta = meta or {}
        self.memory_fn = memory_fn
        self.axes = axes
        self.rules = rules or DEFAULT_RULES

    def arg_bytes(self) -> int:
        """Bytes of every argument tensor (parameters, optimizer state,
        caches, inputs), each storage once."""
        seen = {}
        for t in tensor_leaves(self.args):
            s = t.untyped_storage()
            seen[StorageWeakRef(s).cdata] = s.nbytes()
        return sum(seen.values())

    def shardings(self, mesh, rules: Optional[ShardingRules] = None):
        """The ``NamedSharding`` of each global argument on ``mesh`` as the
        port keeps it, in ``global_args``' structure: a leaf with logical
        axes by ``placement`` under ``rules`` (the cell's by default), so
        its "fsdp", "tensor" and "expert" dims split and every other dim
        (an input's batch: every rank passes the whole inputs) whole; a
        ``PartitionSpec`` leaf as it says."""
        rules = rules or self.rules

        def rec(a, ax):
            if isinstance(a, torch.Tensor):
                if isinstance(ax, PartitionSpec):
                    return NamedSharding(mesh, ax)
                return placement(mesh, ax or (None,) * a.dim(),
                                 tuple(a.shape), rules)
            if isinstance(a, dict):
                return {k: rec(v, ax[k]) for k, v in a.items()}
            vals = [rec(v, x) for v, x in zip(a, ax)]
            return type(a)(*vals) if hasattr(a, "_fields") else type(a)(vals)

        return rec(self.global_args, self.axes)


__all__ = ["abstract", "pad_to_multiple", "opt_state_axes", "tensor_leaves",
           "Cell"]
