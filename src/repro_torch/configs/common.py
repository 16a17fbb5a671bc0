"""Shared cell-building helpers for the dry-run (the counterpart of
``repro.configs.common``).

A cell's arguments are ``meta`` tensors: shapes and dtypes with no storage,
as the reference's ``jax.ShapeDtypeStruct``s are.  ``launch.dryrun`` runs
``cell.fn(*cell.args)`` on them to count its products, bytes and live
memory, on one device: a cell carries no shardings (the port places its
tensors under ``sharding_ctx`` by their logical axes, whose tree for the
optimizer state is ``opt_state_axes``).  The port updates its caches in
place, so a cell donates nothing.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef

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
    (4 microbatches against the whole batch at once)."""

    def __init__(self, arch: str, shape: str, kind: str, fn: Callable,
                 args: Tuple, meta: Optional[Dict] = None,
                 memory_fn: Optional[Callable] = None):
        self.arch = arch
        self.shape = shape
        self.kind = kind          # train | decode | prefill | score
        self.fn = fn
        self.args = args
        self.meta = meta or {}
        self.memory_fn = memory_fn

    def arg_bytes(self) -> int:
        """Bytes of every argument tensor (parameters, optimizer state,
        caches, inputs), each storage once."""
        seen = {}
        for t in tensor_leaves(self.args):
            s = t.untyped_storage()
            seen[StorageWeakRef(s).cdata] = s.nbytes()
        return sum(seen.values())


__all__ = ["abstract", "pad_to_multiple", "opt_state_axes", "tensor_leaves",
           "Cell"]
