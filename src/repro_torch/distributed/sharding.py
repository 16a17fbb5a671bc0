"""Logical-axis sharding rules (MaxText-style) over ``torch.distributed``
(PyTorch port of ``repro.distributed.sharding``).

Model code names tensor dimensions by *logical* axes; the launcher activates
a (mesh, rules) context and ``logical_spec`` translates the names to mesh
axes.  Outside a context every hook is a no-op, so one process on one
device runs unchanged.

Mesh axes (``launch/mesh.py``):
  * ``pod``   — outer data parallelism across pods
  * ``data``  — FSDP / batch / sequence sharding inside a pod
  * ``model`` — tensor parallelism (heads, ffn, vocab, experts)

The reference's three ``shard_map`` programs (``distributed/flash_decode``,
``models/moe.moe_ep``, ``serving/sampler._sharded_argmax``) become explicit
SPMD code here: each rank takes its block of the global inputs
(``NamedSharding.local``), runs the local body with collectives over the
axis groups (``Mesh.all_reduce`` / ``all_gather`` / ``all_to_all``), and
gathers outputs that the reference shards back to global
(``NamedSharding.gather``).  The expert weights and the flash-decode KV
cache are truly sharded: a rank allocates and keeps only its block.
Everything else — the dense weights, the activations, the recsys tables
and the GNN — stays replicated on every rank in the port: GSPMD's
placement of the dense weights from the rules (FSDP × TP), the dry-run's
multi-chip legs and ogb_products are ROADMAP A16b.  So ``constrain``
returns its tensor unchanged, and ``placement`` (the one rule for where a
weight lives: its "expert" dims split, the rest whole) places parameters
and checkpoint leaves.

A ``Mesh`` covers the initialized world (``init_process_group``), rank r
at the row-major coordinates of r in the mesh shape (as
``Mesh(np.array(devices).reshape(shape), names)`` places device r).  A
group over some axes holds the ranks that share this rank's coordinates on
the others; torch orders a group's ranks by global rank, which is
row-major order over the group's axes.  gloo (torch 2.11) takes CUDA
tensors for every collective used here (``all_reduce`` SUM and MAX,
``all_gather_into_tensor``, ``all_to_all_single``; ``chip_smoke.py
--phases dist`` checks it), so several gloo ranks can share one card; an
NCCL mesh needs a card a rank.
"""
from __future__ import annotations

import contextlib
import math
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

Axes = Union[None, str, Tuple[str, ...]]


class PartitionSpec(tuple):
    """Per-dimension mesh axes: None (replicated), an axis name, or a tuple
    of names (major first) — the shape of ``jax.sharding.PartitionSpec``,
    which also writes a one-name tuple as the name, so ``tuple(spec)``
    compares with the reference's."""

    def __new__(cls, *parts: Axes) -> "PartitionSpec":
        return super().__new__(cls, (
            p[0] if isinstance(p, tuple) and len(p) == 1 else p
            for p in parts))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def dim_axes(entry: Axes) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, as a tuple (major first)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


class Mesh:
    """A named grid over the ranks of the initialized ``torch.distributed``
    world.  ``shape`` maps axis name to size, in order (the reference's
    ``Mesh.shape``); their product must be the world size.  ``device`` is
    where the mesh's tensors live: by default ``cuda`` on NCCL and ``cpu``
    on gloo; a gloo mesh may name a CUDA device."""

    def __init__(self, shape: Union[Dict[str, int],
                                    Sequence[Tuple[str, int]]],
                 device: Union[str, torch.device, None] = None):
        if not dist.is_initialized():
            raise RuntimeError("Mesh needs an initialized torch.distributed "
                               "world (init_process_group)")
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks; the "
                             f"world has {world}")
        self.rank = dist.get_rank()
        self.backend = dist.get_backend()
        if device is None:
            device = "cuda" if self.backend == "nccl" else "cpu"
        self.device = torch.device(device)
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        self._coords: Dict[int, Dict[str, int]] = {}
        # host seconds inside collectives, accumulated while ``timing`` is
        # set (each call then synchronizes the device before and after)
        self.timing = False
        self.collective_s = 0.0

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, backend={self.backend}, "
                f"device={self.device})")

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """Axis name -> index of ``rank`` (default: this rank)."""
        r = self.rank if rank is None else rank
        if r not in self._coords:   # every block placement asks: keep them
            idx = np.unravel_index(r, tuple(self.shape.values()))
            self._coords[r] = {a: int(i) for a, i in zip(self.axis_names,
                                                         idx)}
        return self._coords[r]

    def axis_index(self, name: str) -> int:
        return self.coords()[name]

    def group(self, axes: Iterable[str]) -> Tuple[object, List[int]]:
        """(process group, its global ranks) over ``axes`` through this
        rank.  Every rank builds every group of the partition in the same
        order the first time any rank asks (``new_group`` is collective
        over the world), so all ranks must ask for the same axes in the
        same order — which SPMD code does."""
        axes = {axes} if isinstance(axes, str) else set(axes)
        key = tuple(a for a in self.axis_names if a in axes)
        if key not in self._groups:
            others = [a for a in self.axis_names if a not in key]
            blocks: Dict[Tuple[int, ...], List[int]] = {}
            for r in range(self.size):
                c = self.coords(r)
                blocks.setdefault(tuple(c[a] for a in others), []).append(r)
            mine = None
            for ranks in blocks.values():
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = (g, ranks)
            self._groups[key] = mine
        return self._groups[key]

    # ------------------------------------------------------------ collectives
    def _run(self, fn, out: torch.Tensor, *ins: torch.Tensor
             ) -> torch.Tensor:
        """Run collective ``fn(out, *ins)``; time it while ``timing`` is
        set."""
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        fn(out, *ins)
        if self.timing:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self.collective_s += time.perf_counter() - t0
        return out

    # A group of one rank has nothing to exchange: each collective below
    # then returns its input's values without calling torch.distributed,
    # whose calls cost host time and nothing else there.

    def all_reduce(self, x: torch.Tensor, op: str, axes: Iterable[str]
                   ) -> torch.Tensor:
        """A new tensor: ``x`` reduced over the group of ``axes``; ``op`` is
        "sum" or "max"."""
        g, ranks = self.group(axes)
        if len(ranks) == 1:
            return x.clone()
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        return self._run(lambda o: dist.all_reduce(o, op=red, group=g),
                         x.contiguous().clone())

    def all_gather(self, x: torch.Tensor, axes: Iterable[str]
                   ) -> torch.Tensor:
        """(n, *x.shape): every member's ``x``, in group-rank order.  The
        bytes move as uint8, so any dtype goes."""
        g, ranks = self.group(axes)
        if len(ranks) == 1:
            return x[None]
        src = x.contiguous().view(-1).view(torch.uint8)
        out = torch.empty(len(ranks) * src.numel(), dtype=torch.uint8,
                          device=x.device)
        self._run(lambda o, i: dist.all_gather_into_tensor(o, i, group=g),
                  out, src)
        return out.view(x.dtype).view(len(ranks), *x.shape)

    def all_to_all(self, x: torch.Tensor, axes: Iterable[str]
                   ) -> torch.Tensor:
        """x split into n equal chunks along dim 0, chunk j sent to group
        rank j; returns x's shape with chunk j received from group rank j
        (as uint8, so any dtype goes)."""
        g, ranks = self.group(axes)
        n = len(ranks)
        if n == 1:
            return x
        if x.shape[0] % n:
            raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} is no "
                             f"multiple of the group's {n} ranks")
        src = x.contiguous().view(-1).view(torch.uint8)
        out = torch.empty_like(src)
        self._run(lambda o, i: dist.all_to_all_single(o, i, group=g),
                  out, src)
        return out.view(x.dtype).view(x.shape)

    def barrier(self) -> None:
        g, _ = self.group(self.axis_names)
        if self.backend == "nccl":
            dist.barrier(group=g, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=g)


@dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> tuple of mesh axis names (applied in order)."""
    rules: Dict[str, Tuple[str, ...]] = field(default_factory=dict)

    def mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        return self.rules.get(logical, ())

    def override(self, **kw: Tuple[str, ...]) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(d)


DEFAULT_RULES = ShardingRules({
    # activations
    "batch":      ("pod", "data"),
    "seq":        (),                  # seq replicated by default
    "residual_seq": (),                # train cells override to ("model",)
    "kv_seq":     ("pod", "data"),     # long-context decode: KV sequence shard
    "heads":      ("model",),
    "kv_heads":   ("model",),
    "embed":      (),
    "ffn_act":    ("model",),
    "vocab_act":  ("model",),
    # weights: 2-D fsdp x tp
    "fsdp":       ("data",),
    "tensor":     ("model",),
    "expert":     ("model",),
    # graph / recsys
    "edges":      ("pod", "data", "model"),
    "nodes":      ("pod", "data"),
    "table_rows": ("model",),
    "candidates": ("pod", "data", "model"),
})


# --------------------------------------------------------------------- context
_ACTIVE: list = []


@contextlib.contextmanager
def sharding_ctx(mesh: Optional[Mesh], rules: ShardingRules = DEFAULT_RULES):
    """Activate (mesh, rules) for the sharded paths and ``logical_spec``."""
    _ACTIVE.append((mesh, rules))
    try:
        yield
    finally:
        _ACTIVE.pop()


def active_mesh() -> Optional[Mesh]:
    if _ACTIVE and _ACTIVE[-1][0] is not None:
        return _ACTIVE[-1][0]
    return None


def _active() -> Tuple[Optional[Mesh], ShardingRules]:
    if _ACTIVE:
        return _ACTIVE[-1]
    return None, DEFAULT_RULES


def logical_spec(logical_axes: Sequence[Optional[str]],
                 shape: Optional[Sequence[int]] = None,
                 mesh: Optional[Mesh] = None,
                 rules: Optional[ShardingRules] = None) -> PartitionSpec:
    """Translate per-dim logical names to a PartitionSpec.

    Mesh axes missing from the mesh are dropped; if ``shape`` is given, axes
    that do not divide the dim are dropped too (robustness for odd configs).
    Only ``mesh.shape`` is read.
    """
    m, r = _active()
    mesh = mesh or m
    rules = rules or r
    spec = []
    used: set = set()
    for d, name in enumerate(logical_axes):
        axes = []
        size = 1
        for ax in rules.mesh_axes(name):
            if mesh is None or ax not in mesh.shape or ax in used:
                continue
            nsz = size * mesh.shape[ax]
            if shape is not None and shape[d] % nsz != 0:
                continue
            axes.append(ax)
            used.add(ax)
            size = nsz
        spec.append(tuple(axes) if len(axes) > 1 else (axes[0] if axes else None))
    return P(*spec)


def constrain(x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
    """The reference's activation hook, which only promises unchanged
    values: activations are replicated on every rank in the port, so ``x``
    comes back as it is.  No model code calls it."""
    return x


class NamedSharding:
    """(mesh, spec): how a global tensor's blocks lie on the mesh's ranks
    (the counterpart of ``jax.sharding.NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = P(*spec)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh.shape}, {self.spec!r})"

    def _parts(self, ndim: int) -> List[Tuple[str, ...]]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec!r} has more dims than {ndim}")
        return [dim_axes(e) for e in self.spec] + [()] * (ndim - len(
            self.spec))

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec shards over, in mesh order."""
        used = {a for e in self.spec for a in dim_axes(e)}
        return tuple(a for a in self.mesh.axis_names if a in used)

    def _blocks(self, ndim: int) -> List[int]:
        return [math.prod(self.mesh.shape[a] for a in p)
                for p in self._parts(ndim)]

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """The shape of one rank's block of a global ``shape``."""
        out = []
        for s, n in zip(shape, self._blocks(len(shape))):
            if s % n:
                raise ValueError(f"dim {s} of {tuple(shape)} does not split "
                                 f"into {n} blocks ({self.spec!r})")
            out.append(s // n)
        return tuple(out)

    def _index(self, ndim: int, rank: Optional[int] = None) -> List[int]:
        c = self.mesh.coords(rank)
        out = []
        for p in self._parts(ndim):
            i = 0
            for a in p:
                i = i * self.mesh.shape[a] + c[a]
            out.append(i)
        return out

    def _slices(self, shape: Sequence[int], rank: Optional[int] = None):
        block = self.shard_shape(shape)
        return tuple(slice(i * b, (i + 1) * b)
                     for i, b in zip(self._index(len(shape), rank), block))

    def local(self, x):
        """This rank's block of the global ``x`` (a torch tensor or a numpy
        array; a view where slicing gives one)."""
        return x[self._slices(x.shape)]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global tensor from every rank's block ``x`` (an all-gather
        over the spec's axes; replicated on each rank)."""
        axes = tuple(a for a in self.axes() if self.mesh.shape[a] > 1)
        if not axes:
            return x
        parts = self.mesh.all_gather(x, axes)
        _, ranks = self.mesh.group(axes)
        shape = [s * n for s, n in zip(x.shape, self._blocks(x.dim()))]
        out = x.new_empty(shape)
        for part, r in zip(parts, ranks):
            out[self._slices(shape, r)] = part
        return out


def named_sharding(mesh: Mesh, logical_axes: Sequence[Optional[str]],
                   shape: Optional[Sequence[int]] = None,
                   rules: ShardingRules = DEFAULT_RULES) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(logical_axes, shape, mesh, rules))


# The logical axes whose dims the port splits over ranks; a dim under any
# other name stays whole on every rank (ROADMAP A16b).
PLACED_AXES = frozenset({"expert"})


def placement(mesh: Mesh, logical_axes: Sequence[Optional[str]],
              shape: Optional[Sequence[int]] = None,
              rules: ShardingRules = DEFAULT_RULES) -> NamedSharding:
    """Where the port keeps a tensor with these logical axes on ``mesh``:
    split along the dims named in ``PLACED_AXES`` (by ``rules``), whole
    along the others.  ``init_params(mesh=)``, ``shard_params`` and the
    checkpoint's ``save(mesh=)`` / ``restore(mesh=)`` all place by it.
    With ``shape``, a split dim that the mesh axes do not divide raises
    (``moe_ep`` needs E a multiple of the ``model`` axis)."""
    kept = [a if a in PLACED_AXES else None for a in logical_axes]
    sh = NamedSharding(mesh, logical_spec(kept, None, mesh, rules))
    if shape is not None:
        sh.shard_shape(shape)
    return sh


def axis_size(name: str) -> int:
    """Size of a named axis of the active mesh (the reference's size of an
    axis inside ``shard_map``)."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(f"axis_size({name!r}) outside a sharding_ctx")
    return mesh.shape[name]


# ------------------------------------------------ differentiable data movement
class _Shard(torch.autograd.Function):
    """This rank's block of a replicated tensor; the backward gathers the
    blocks' gradients, so each rank gets the whole replicated gradient."""

    @staticmethod
    def forward(ctx, x, sharding):
        ctx.sharding = sharding
        return sharding.local(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.sharding.gather(g.contiguous()), None


class _Unshard(torch.autograd.Function):
    """The global tensor from the blocks; the gradient, alike on every rank,
    is sliced back to this rank's block."""

    @staticmethod
    def forward(ctx, x, sharding):
        ctx.sharding = sharding
        return sharding.gather(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.sharding.local(g).contiguous(), None


class _SumGrad(torch.autograd.Function):
    """Identity whose backward sums the gradient over ``axes``: a tensor
    replicated over those axes and used by each rank on its own share of
    the work (the transpose of a replicated ``shard_map`` input)."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g, "sum", ctx.axes), None, None


def shard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    return _Shard.apply(x, sharding)


def unshard(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    return _Unshard.apply(x, sharding)


def sum_grad(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
             ) -> torch.Tensor:
    axes = tuple(axes)
    if not axes or not x.requires_grad:
        return x
    return _SumGrad.apply(x, mesh, axes)


__all__ = ["Mesh", "PartitionSpec", "P", "NamedSharding", "ShardingRules",
           "DEFAULT_RULES", "sharding_ctx", "constrain", "active_mesh",
           "logical_spec", "named_sharding", "placement", "PLACED_AXES",
           "axis_size", "shard", "unshard",
           "sum_grad", "dim_axes"]
