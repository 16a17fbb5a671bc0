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

GSPMD's partitioning of the reference is written out as explicit SPMD
code: each rank holds its block of every global tensor
(``NamedSharding.local``), runs the local body, and calls the collectives
GSPMD would insert over the axis groups (``Mesh.all_reduce`` /
``all_gather`` / ``all_to_all``).  ``placement`` is the one rule for where
a weight lives: its "fsdp", "tensor" and "expert" dims split over the
mesh axes the rules give them, a dim those axes do not divide whole (as
``logical_spec(shape=)`` drops them; an "expert" dim raises instead,
since ``moe_ep`` needs E to divide).  ``init_params(mesh=)``,
``shard_params`` and the checkpoint's ``save`` / ``restore(mesh=)`` place
parameters by it, and the dense LM (``models/transformer.Layout``) computes
on those blocks: column-parallel products on the "tensor" block, a
row-parallel product followed by ``reduce_sum`` over ``model``, a
layer's "fsdp" blocks gathered over ``data`` before its products
(``gather_blocks``), lanes split over the "batch" axes and gathered back
where the host reads them; on the train path under rules that map
``residual_seq`` to live axes, the residual's sequence blocks gathered
before the column-parallel products and the row-parallel partial sums
reduce-scattered back to them (``reduce_scatter``: sequence
parallelism).  Each of these moves is an ``autograd.Function`` with its
transpose.  The recommenders' tables split their rows over the
"table_rows" axes (``row_window``: a lookup is a masked local take summed
over those ranks, ``sum_rows``), and a recsys call takes its rows of the
inputs' "batch" and "candidates" dims (``placement(inputs=True)``).  A
graph call (``graph_split``) takes its rows of the edge arrays over the
live "edges" axes and holds its block of the node rows over the live
"nodes" axes; the node features it gathers are summed back over the edge
axes (``gather_blocks(sum_axes=)``) and its per-edge partial sums
reduce-scattered over them onto its node block (``reduce_scatter(
sum_axes=)``).  ``constrain`` returns its tensor unchanged: the model's
activations are blocks by construction.

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

Every collective goes through ``Mesh._run``, which counts it: the calls
and the bytes handed to the backend, by kind and group (``counts``,
``collective_records``).  A ``TracedMesh`` is one rank of a world that
need not exist: it builds no process group, its collectives call nothing
and return tensors of the shapes the real ones return (so the model runs
on ``meta`` tensors under it), and it counts the same calls and bytes.
``ring_bytes`` turns the counts into each rank's ring traffic with the
reference's formulas (``repro.launch.roofline``).
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


# The kinds a collective is counted under: the reference's HLO names
# (``repro.launch.roofline``), and "gather" for ``gather_first`` (one rank
# receives), which the reference's programs do not call.
COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute", "gather")


def ring_traffic(kind: str, group: int, nbytes: float) -> float:
    """One rank's ring traffic for a collective over ``group`` ranks that
    is handed ``nbytes`` (the operand's bytes; an all-gather's and a
    gather's: the result's), by the reference's formulas: all-reduce
    2(g-1)/g of the operand, all-gather (g-1)/g of the result,
    reduce-scatter and all-to-all (g-1)/g of the operand, a
    collective-permute the operand; a gather as an all-gather."""
    if group <= 1:
        return 0.0
    frac = (group - 1) / group
    if kind == "all-reduce":
        return 2 * frac * nbytes
    if kind == "collective-permute":
        return float(nbytes)
    return frac * nbytes


def ring_bytes(records: Iterable[Dict]) -> Tuple[float, Dict[str, float]]:
    """(bytes a rank, bytes by kind) of ``collective_records``' records
    under ``ring_traffic``: the reference's ``parse_collectives`` totals."""
    per_kind = {k: 0.0 for k in COLLECTIVE_KINDS}
    for r in records:
        per_kind[r["kind"]] += ring_traffic(r["kind"], r["group"],
                                            r["bytes"])
    return sum(per_kind.values()), per_kind


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
        backend = dist.get_backend()
        if device is None:
            device = "cuda" if backend == "nccl" else "cpu"
        self._setup(shape, dist.get_rank(), backend, device)
        world = dist.get_world_size()
        if self.size != world:
            raise ValueError(f"mesh {self.shape} has {self.size} ranks; the "
                             f"world has {world}")

    def _setup(self, shape, rank: int, backend: str, device) -> None:
        self.shape: Dict[str, int] = dict(shape)
        self.axis_names = tuple(self.shape)
        self.size = math.prod(self.shape.values())
        self.rank, self.backend = rank, backend
        self.device = torch.device(device)
        self._groups: Dict[Tuple[str, ...], Tuple[object, List[int]]] = {}
        self._coords: Dict[int, Dict[str, int]] = {}
        # host seconds inside collectives, accumulated while ``timing`` is
        # set (each call then synchronizes the device before and after)
        self.timing = False
        self.collective_s = 0.0
        # (kind, the group's global ranks) -> [calls, bytes handed over]
        self.counts: Dict[Tuple[str, Tuple[int, ...]], List[int]] = {}

    def __repr__(self) -> str:
        return (f"{type(self).__name__}({self.shape}, rank={self.rank}, "
                f"backend={self.backend}, device={self.device})")

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

    def _partition(self, key: Tuple[str, ...]) -> List[List[int]]:
        """The groups over the axes ``key``: the global ranks that share
        their coordinates on every other axis, each in rank order."""
        others = [a for a in self.axis_names if a not in key]
        blocks: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            blocks.setdefault(tuple(c[a] for a in others), []).append(r)
        return list(blocks.values())

    def _key(self, axes: Iterable[str]) -> Tuple[str, ...]:
        axes = {axes} if isinstance(axes, str) else set(axes)
        return tuple(a for a in self.axis_names if a in axes)

    def group(self, axes: Iterable[str]) -> Tuple[object, List[int]]:
        """(process group, its global ranks) over ``axes`` through this
        rank.  Every rank builds every group of the partition in the same
        order the first time any rank asks (``new_group`` is collective
        over the world), so all ranks must ask for the same axes in the
        same order — which SPMD code does."""
        key = self._key(axes)
        if key not in self._groups:
            mine = None
            for ranks in self._partition(key):
                g = dist.new_group(ranks)
                if self.rank in ranks:
                    mine = (g, ranks)
            self._groups[key] = mine
        return self._groups[key]

    # ------------------------------------------------------------- counts
    def reset_counts(self) -> None:
        self.counts = {}

    def _count(self, kind: str, ranks: Sequence[int], nbytes: int) -> None:
        c = self.counts.setdefault((kind, tuple(ranks)), [0, 0])
        c[0] += 1
        c[1] += int(nbytes)

    def collective_records(self) -> List[Dict]:
        """The counts as records: kind, the group's size and global ranks,
        calls, and the bytes handed to the backend (an all-gather's and a
        gather's result, else the operand), summed over the calls."""
        return [{"kind": kind, "group": len(ranks), "ranks": list(ranks),
                 "calls": calls, "bytes": nbytes}
                for (kind, ranks), (calls, nbytes)
                in sorted(self.counts.items())]

    # ------------------------------------------------------------ collectives
    def _run(self, kind: str, ranks: Sequence[int], nbytes: int, fn,
             out: Optional[torch.Tensor], *ins: torch.Tensor
             ) -> Optional[torch.Tensor]:
        """Count collective ``fn(out, *ins)`` (``kind`` over the group of
        ``ranks``, handed ``nbytes``), then run it; time it while
        ``timing`` is set."""
        self._count(kind, ranks, nbytes)
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
        out = x.contiguous().clone()
        return self._run("all-reduce", ranks, _nbytes(out),
                         lambda o: dist.all_reduce(o, op=red, group=g), out)

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
        self._run("all-gather", ranks, _nbytes(out),
                  lambda o, i: dist.all_gather_into_tensor(o, i, group=g),
                  out, src)
        return out.view(x.dtype).view(len(ranks), *x.shape)

    def gather_first(self, x: torch.Tensor, axes: Iterable[str]
                     ) -> Optional[torch.Tensor]:
        """(n, *x.shape): every member's ``x``, in group-rank order, on
        the group's first rank; None on the others, which only send (the
        checkpoint's save, on host tensors under gloo)."""
        g, ranks = self.group(axes)
        if len(ranks) == 1:
            return x[None]
        out = (x.new_empty((len(ranks),) + tuple(x.shape))
               if self.rank == ranks[0] else None)
        return self._run("gather", ranks, len(ranks) * _nbytes(x),
                         lambda o, i: dist.gather(
                             i, None if o is None else list(o.unbind(0)),
                             dst=ranks[0], group=g), out, x.contiguous())

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
        self._run("all-to-all", ranks, _nbytes(src),
                  lambda o, i: dist.all_to_all_single(o, i, group=g),
                  out, src)
        return out.view(x.dtype).view(x.shape)

    def barrier(self) -> None:
        g, _ = self.group(self.axis_names)
        if self.backend == "nccl":
            dist.barrier(group=g, device_ids=[self.device.index or 0])
        else:
            dist.barrier(group=g)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class TracedMesh(Mesh):
    """Rank ``rank`` of a mesh of ``shape`` with no world behind it: the
    dry-run's production meshes (``launch.mesh.make_production_mesh(
    rank=)``), whose 256 or 512 ranks no host has.  It builds no process
    group and its collectives call nothing: each returns a tensor of the
    shape the real one returns (an all-reduce this rank's values, the
    others uninitialized), so the model runs under it on ``meta`` tensors
    (``device``) and every rank's program is this rank's.  It counts each
    call as ``Mesh`` does, so its ``collective_records`` are what the real
    rank would hand its backend."""

    def __init__(self, shape: Union[Dict[str, int],
                                    Sequence[Tuple[str, int]]],
                 rank: int = 0, device: Union[str, torch.device] = "meta"):
        self._setup(shape, int(rank), "traced", device)
        if not 0 <= self.rank < self.size:
            raise ValueError(f"rank {rank} is not in the mesh {self.shape} "
                             f"of {self.size} ranks")

    def group(self, axes: Iterable[str]) -> Tuple[object, List[int]]:
        """(None, the global ranks of this rank's group over ``axes``)."""
        key = self._key(axes)
        if key not in self._groups:
            self._groups[key] = next((None, ranks)
                                     for ranks in self._partition(key)
                                     if self.rank in ranks)
        return self._groups[key]

    def _run(self, kind, ranks, nbytes, fn, out, *ins):
        self._count(kind, ranks, nbytes)
        return out

    def barrier(self) -> None:
        pass


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


def active_rules() -> ShardingRules:
    """The rules of the innermost ``sharding_ctx`` (``DEFAULT_RULES``
    outside one)."""
    return _active()[1]


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
    values: the port's model code lays its activations out explicitly
    (``models/transformer.Layout``), so ``x`` comes back as it is.  No
    model code calls it."""
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

    def gather(self, x: torch.Tensor, first: bool = False
               ) -> Optional[torch.Tensor]:
        """The global tensor from every rank's block ``x`` (an all-gather
        over the spec's axes; replicated on each rank).  With ``first``,
        only the first rank of each group over those axes (rank 0's
        group: rank 0) receives it, the others None."""
        axes = tuple(a for a in self.axes() if self.mesh.shape[a] > 1)
        if not axes:
            return x
        parts = (self.mesh.gather_first(x, axes) if first
                 else self.mesh.all_gather(x, axes))
        if parts is None:
            return None
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


# The logical axes of parameters whose dims the port splits over ranks; a
# dim under any other name stays whole on every rank.  A recsys or graph
# call also splits the dims of its inputs named in INPUT_AXES
# (``placement(inputs=True)``; a graph's node rows by ``graph_split``); the
# LM's inputs are whole, and ``models/transformer.Layout`` takes their
# lanes.
PLACED_AXES = frozenset({"fsdp", "tensor", "expert", "table_rows"})
INPUT_AXES = frozenset({"batch", "candidates", "edges"})


def placement(mesh: Mesh, logical_axes: Sequence[Optional[str]],
              shape: Optional[Sequence[int]] = None,
              rules: ShardingRules = DEFAULT_RULES,
              inputs: bool = False) -> NamedSharding:
    """Where the port keeps a tensor with these logical axes on ``mesh``:
    split along the dims named in ``PLACED_AXES`` (by ``rules``), whole
    along the others.  ``init_params(mesh=)``, ``shard_params`` and the
    checkpoint's ``save(mesh=)`` / ``restore(mesh=)`` all place by it.
    With ``shape``, a mesh axis that does not divide its "fsdp", "tensor",
    "table_rows" (or input) dim is dropped, as ``logical_spec(shape=)``
    drops it (that dim stays whole), and an "expert" dim that the axes do
    not divide raises (``moe_ep`` needs E a multiple of the ``model``
    axis).  ``inputs``: the dims named in ``INPUT_AXES`` split too — the
    block of a recsys input a rank computes on."""
    names = PLACED_AXES | INPUT_AXES if inputs else PLACED_AXES
    kept = [a if a in names else None for a in logical_axes]
    spec = logical_spec(kept, None, mesh, rules)
    if shape is not None:
        fit = logical_spec([None if a == "expert" else a for a in kept],
                           shape, mesh, rules)
        spec = P(*(e if a == "expert" else f
                   for a, e, f in zip(kept, spec, fit)))
    sh = NamedSharding(mesh, spec)
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


REDUCE_DTYPE = torch.float32    # partial sums are summed in it, then cast


class _ReduceSum(torch.autograd.Function):
    """All-reduce (SUM) over ``axes`` of per-rank partial sums, in
    REDUCE_DTYPE and cast back (the all-reduce GSPMD puts after a
    row-parallel product); the gradient, alike on every rank, passes
    unchanged."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x.to(REDUCE_DTYPE), "sum", axes).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherBlocks(torch.autograd.Function):
    """The global tensor from the blocks, as ``_Unshard``, for a block
    that every rank then uses on its own share of the work (an FSDP
    weight on each rank's lanes, the sequence blocks of the residual
    before a column-parallel product, a graph's node features on each
    rank's edges); the transpose is a reduce-scatter: the ranks'
    gradients summed over ``sum_axes``, each rank keeping its block.
    Ranks that differ only along an axis left out of ``sum_axes`` did the
    same work (lanes replicated over it): each already holds the whole
    gradient, which a sum would count once a rank."""

    @staticmethod
    def forward(ctx, x, sharding, sum_axes):
        ctx.sharding, ctx.sum_axes = sharding, sum_axes
        return sharding.gather(x)

    @staticmethod
    def backward(ctx, g):
        sh = ctx.sharding
        total = sh.mesh.all_reduce(g.contiguous(), "sum", ctx.sum_axes)
        return sh.local(total).contiguous(), None, None


class _ReduceScatter(torch.autograd.Function):
    """Per-rank partial sums of a global tensor summed over ``sum_axes``
    (in REDUCE_DTYPE, cast back), each rank keeping its block under
    ``sharding``: the reduce-scatter that ends a row-parallel product
    under sequence parallelism (``sum_axes`` the sharding's own), or a
    graph's per-edge sums onto a rank's node block (the edge axes).  It
    runs as an all-reduce and a slice: what the model runs on CUDA
    tensors keeps to the four collectives that gloo is checked to take
    there (``chip_smoke.py --phases dist``).  The transpose is the
    all-gather of the blocks' gradients."""

    @staticmethod
    def forward(ctx, x, sharding, sum_axes):
        ctx.sharding = sharding
        total = sharding.mesh.all_reduce(x.to(REDUCE_DTYPE), "sum",
                                         sum_axes)
        return sharding.local(total).to(x.dtype).contiguous()

    @staticmethod
    def backward(ctx, g):
        return ctx.sharding.gather(g.contiguous()), None, None


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


def _live(mesh: Mesh, axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in axes if mesh.shape.get(a, 1) > 1)


def reduce_sum(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
               ) -> torch.Tensor:
    """``x`` summed over the ranks of ``axes`` (each holding a partial sum),
    in REDUCE_DTYPE, cast back to ``x``'s dtype; ``x`` itself where the
    axes hold one rank."""
    axes = _live(mesh, axes)
    if not axes:
        return x
    return _ReduceSum.apply(x, mesh, axes)


def gather_blocks(x: torch.Tensor, sharding: NamedSharding,
                  sum_axes: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The global tensor from this rank's block (see ``_GatherBlocks``).
    The transpose sums over ``sum_axes``: the axes along which the ranks
    did different work with the whole tensor (a graph's edge axes), by
    default the sharding's own; an axis left out is one along which the
    ranks used it on the same work, whose gradient it takes once.  Where
    the sharding splits nothing, ``x`` itself, its gradient summed over
    ``sum_axes`` (``sum_grad``)."""
    mesh = sharding.mesh
    sum_axes = _live(mesh, sharding.axes() if sum_axes is None else sum_axes)
    if not _live(mesh, sharding.axes()):
        return sum_grad(x, mesh, sum_axes)
    return _GatherBlocks.apply(x, sharding, sum_axes)


def reduce_scatter(x: torch.Tensor, sharding: NamedSharding,
                   sum_axes: Optional[Sequence[str]] = None
                   ) -> torch.Tensor:
    """Partial sums of the global ``x`` summed over the ranks of
    ``sum_axes`` (by default the sharding's axes), this rank's block of
    the total under ``sharding`` kept (see ``_ReduceScatter``); where the
    sharding splits nothing, the sum itself (``reduce_sum``: ``x`` where
    the axes hold one rank)."""
    mesh = sharding.mesh
    sum_axes = _live(mesh, sharding.axes() if sum_axes is None else sum_axes)
    if not _live(mesh, sharding.axes()):
        return reduce_sum(x, mesh, sum_axes)
    return _ReduceScatter.apply(x, sharding, sum_axes)


@dataclass(frozen=True)
class RowWindow:
    """This rank's rows [start, start + rows) of a table of ``n_rows``
    rows whose "table_rows" dim splits over ``axes`` of ``mesh``."""
    mesh: Mesh
    axes: Tuple[str, ...]
    start: int
    rows: int
    n_rows: int


def row_window(table: torch.Tensor, n_rows: int, row_dim: int = -2
               ) -> Optional[RowWindow]:
    """The window of ``table``'s rows (dim ``row_dim``) on the active
    mesh: None where it holds all ``n_rows`` rows (no mesh, a whole
    table, or rules that keep "table_rows" whole), else this rank's block
    under ``placement`` of ("table_rows",) by the active rules; a table
    that is neither raises."""
    mesh, rules = _active()
    rows = table.shape[row_dim]
    if mesh is None or rows == n_rows:
        return None
    sh = placement(mesh, ("table_rows",), (n_rows,), rules)
    axes = _live(mesh, dim_axes(sh.spec[0]))
    if not axes or sh.shard_shape((n_rows,))[0] != rows:
        raise ValueError(
            f"a table of {rows} rows is neither whole ({n_rows}) nor this "
            f"rank's block of them under the active rules ({sh.spec!r}); "
            "place it inside the sharding_ctx it is used in")
    return RowWindow(mesh, axes, sh._index(1)[0] * rows, rows, n_rows)


def sum_rows(partial: torch.Tensor, window: Optional[RowWindow]
             ) -> torch.Tensor:
    """A lookup over a row split: every rank's partial result (its window's
    rows, zeros for the ids the other ranks hold) summed over the window's
    axes, the all-reduce GSPMD puts after the reference's masked local
    gather.  The transpose is the identity: the output's gradient is alike
    on the ranks of those axes, and each scatters it into its own rows
    only, so a table's gradient is summed over the ranks of the batch
    (``sum_grad``) and never over these.  ``partial`` itself without a
    window."""
    if window is None:
        return partial
    return reduce_sum(partial, window.mesh, window.axes)


@dataclass(frozen=True)
class GraphSplit:
    """How a graph call lies on the mesh (``graph_split``): this rank's
    rows [edge_start, edge_start + edge_rows) of the edge arrays, split
    over the live ``edge_axes``, and its block [node_start, node_start +
    node_rows) of the node rows, split over the live ``node_axes``; no
    axes and all the rows where the mesh (None without one) leaves them
    whole."""
    mesh: Optional[Mesh]
    edge_axes: Tuple[str, ...]
    node_axes: Tuple[str, ...]
    edge_start: int
    edge_rows: int
    node_start: int
    node_rows: int

    @property
    def node_sharding(self) -> NamedSharding:
        """A node array's dim 0 split over the node axes."""
        return NamedSharding(self.mesh, P(self.node_axes or None))

    def edges(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a global (E, ...) edge array."""
        return x[self.edge_start:self.edge_start + self.edge_rows]

    def nodes(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's block of a global (N, ...) node array."""
        return x[self.node_start:self.node_start + self.node_rows]


def graph_split(n_nodes: int, n_edges: int) -> GraphSplit:
    """A graph call of ``n_nodes`` nodes and ``n_edges`` edges on the
    active mesh: the reference's ``constrain(src, "edges")`` and its
    node-sharded residual (``constrain(x, "nodes", ...)``) written out.
    The live axes are those that ``logical_spec(shape=)`` keeps for
    ("edges",) over E and ("nodes",) over N under the active rules, so an
    axis that does not divide its dim is dropped, as the reference's
    ``constrain`` drops it; they are not read off the rules."""
    mesh, rules = _active()
    if mesh is None:
        return GraphSplit(None, (), (), 0, n_edges, 0, n_nodes)

    def rows(sh: NamedSharding, n: int):
        block = sh.shard_shape((n,))[0]
        return _live(mesh, sh.axes()), sh._index(1)[0] * block, block

    e_axes, e0, ne = rows(placement(mesh, ("edges",), (n_edges,), rules,
                                    inputs=True), n_edges)
    n_axes, n0, nn = rows(named_sharding(mesh, ("nodes",), (n_nodes,),
                                         rules), n_nodes)
    return GraphSplit(mesh, e_axes, n_axes, e0, ne, n0, nn)


def block_sharding(what: str, shape: Sequence[int], axes: Sequence,
                   global_shape: Sequence[int], mesh: Mesh,
                   rules: ShardingRules) -> NamedSharding:
    """``placement`` of a leaf with logical ``axes`` and ``global_shape``
    on ``mesh``, checked against the leaf's ``shape``: a leaf that is not
    this rank's block under the rules (a whole leaf where they split it,
    a block placed under other rules) raises, naming it (``what``)."""
    sh = placement(mesh, axes, tuple(global_shape), rules)
    block = sh.shard_shape(global_shape)
    if tuple(shape) != block:
        raise ValueError(
            f"{what} has shape {tuple(shape)}, not this rank's block "
            f"{block} of {tuple(global_shape)} under {sh.spec!r} (the "
            "active rules): pass the blocks placed inside the sharding_ctx "
            "they were placed in")
    return sh


__all__ = ["Mesh", "TracedMesh", "COLLECTIVE_KINDS", "ring_traffic",
           "ring_bytes", "PartitionSpec", "P", "NamedSharding", "ShardingRules",
           "DEFAULT_RULES", "sharding_ctx", "constrain", "active_mesh",
           "active_rules", "logical_spec", "named_sharding", "placement",
           "PLACED_AXES", "axis_size", "shard", "unshard", "sum_grad",
           "reduce_sum", "REDUCE_DTYPE", "gather_blocks", "reduce_scatter",
           "block_sharding", "dim_axes", "INPUT_AXES", "RowWindow",
           "row_window", "sum_rows", "GraphSplit", "graph_split"]
