"""Dry-run: trace every (arch × shape) cell on PyTorch's ``meta`` device and
record its counted cost, its live memory and its H100 roofline terms (the
counterpart of ``repro.launch.dryrun``).

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-1.5b \\
      --shape decode_32k [--single-pod | --multi-pod | --both-meshes] \\
      [--rank R] [--out build/dryrun_results.json]

Without ``--arch``: sweeps the 40 assigned cells (``--include-antglm`` adds
AntGLM-10B's four), writing after each cell so an interrupted sweep resumes
where it stopped (a key already ``ok`` is skipped).

The legs: one card (``1xH100``, the default), and the reference's
production meshes, (data 16, model 16) (``--single-pod``, key
``arch/shape/16x16``) and (pod 2, data 16, model 16) (``--multi-pod``,
``2x16x16``); ``--both-meshes`` runs the two.  A mesh leg traces one rank
(``--rank``, 0 by default) of the mesh with no world behind it
(``launch.mesh.make_production_mesh(rank=)``, a ``TracedMesh``): the cell's
arguments are that rank's blocks (``build_cell(shape, mesh)``), its
function runs under ``sharding_ctx(mesh, cell.rules)``, and the mesh
records each collective the rank would call, which the roofline prices
(``collective_s``).  Memory, cost and the collectives are that rank's;
every cell is placed.

Nothing runs on a device.  The reference lowers and compiles each cell on
abstract values and reads XLA's cost and memory analyses; the port runs the
cell's function on meta tensors, which carry shapes and dtypes and no data,
under a dispatch mode that sees every aten op the function (and autograd's
backward) reaches.  It is a shape trace on any host, not a CPU fallback of
the program: no kernel launches, and the kernel wrappers take their plain
versions there without moving a launch counter.
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from collections import defaultdict
from typing import Dict, Iterable, Optional, Sequence

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch import configs as cfgreg
from repro_torch.configs.common import Cell, tensor_leaves
from repro_torch.distributed.sharding import sharding_ctx
from repro_torch.launch.mesh import HBM_PER_CHIP, make_production_mesh
from repro_torch.launch.roofline import roofline

MESH = "1xH100"
MESHES = {"16x16": False, "2x16x16": True}    # leg -> multi_pod
aten = torch.ops.aten

# ops that keep their input's values (a copy, a selection, a reshape), so
# an f32 tensor made from bf16 values by an upcast stays bf16-valued
_VALUE_KEEPING = {aten.clone, aten._unsafe_view, aten.cat, aten.index,
                  aten.index_select, aten.gather, aten.embedding,
                  aten.repeat}
# ops that allocate a tensor and write nothing into it
_ALLOCATING = {aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided}
_WIDTH = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4,
          torch.float64: 8}
# the products ``flop_registry`` leaves out: matrix-vector and dot
_VECTOR_FLOPS = {
    aten.mv: lambda m, v, *a, **k: 2 * m.shape[0] * m.shape[1],
    aten.addmv: lambda b, m, v, *a, **k: 2 * m.shape[0] * m.shape[1],
    aten.dot: lambda x, y, *a, **k: 2 * x.numel(),
    aten.vdot: lambda x, y, *a, **k: 2 * x.numel(),
}
_BIAS_FIRST = {aten.addmm, aten.baddbmm, aten.addmv}


def _product_flops(packet, args, kwargs, out):
    """(FLOPs, operand tensors) of a product op, or None for other ops."""
    if packet in _VECTOR_FLOPS:
        f = _VECTOR_FLOPS[packet](*args, **kwargs)
    elif packet in flop_registry:
        f = flop_registry[packet](*args, **kwargs, out_val=out)
    else:
        return None
    operands = args[1:3] if packet in _BIAS_FIRST else args[:2]
    return f, [t for t in operands if isinstance(t, torch.Tensor)]


def _key(t: torch.Tensor) -> int:
    return StorageWeakRef(t.untyped_storage()).cdata


def _tensors(*trees) -> list:
    flat, _ = tree_flatten(trees)
    return [t for t in flat if isinstance(t, torch.Tensor)]


class LiveTracker:
    """Live bytes by storage, exactly at op boundaries.

    A storage counts from the first time it is seen (``add``) until it
    dies: a ``StorageWeakRef`` expires when the last tensor, view or
    autograd-saved alias of the storage is gone, whichever Python object
    held it.  ``upper`` is the live total with dead storages not yet swept;
    a sweep runs only when that exceeds the peak so far, so the peak is the
    exact maximum of the live bytes after each op (its inputs still held)."""

    def __init__(self):
        self._refs: Dict[int, tuple] = {}
        self.upper = 0
        self.peak = 0

    def add(self, t: torch.Tensor) -> None:
        s = t.untyped_storage()
        ref = StorageWeakRef(s)
        if ref.cdata in self._refs:
            return
        self._refs[ref.cdata] = (ref, s.nbytes())
        self.upper += s.nbytes()

    def sweep(self) -> int:
        """Drop the dead storages; returns the exact live bytes."""
        for k, (ref, n) in list(self._refs.items()):
            if ref.expired():
                del self._refs[k]
                self.upper -= n
        return self.upper

    def observe(self) -> None:
        if self.upper > self.peak:
            self.peak = max(self.peak, self.sweep())


class CostMode(TorchDispatchMode):
    """Counts what a function does, op by op, under ``with CostMode():``.

    * ``flops``: the products' FLOPs (``torch.utils.flop_counter``'s
      formulas: mm, addmm, bmm, baddbmm, convolutions, attention; and mv,
      addmv, dot), by the dtype they need.  That is the wider of the two operands' value
      dtypes, where an f32 tensor upcast from bf16 (``.float()``) and the
      copies, selections and reshapes of it count as bf16: its product runs
      on bf16 tensor cores with f32 accumulation (the CUDA kernels do
      exactly that).  XLA's ``flops`` also counts elementwise ops; this
      count does not.
    * ``raw_bytes``: every op that moves data reads each input once and
      writes each output once: the unfused count, the counterpart of XLA's
      "bytes accessed".  Views, ops whose output aliases an input without
      writing it, and allocations (``empty_like``) move nothing; an
      ``out=`` tensor is written, not read.
    * ``live``: a ``LiveTracker`` of the storages the ops make."""

    def __init__(self, live: LiveTracker = None):
        super().__init__()
        self.flops = defaultdict(float)
        self.raw_bytes = 0.0
        self.n_ops = 0
        self.live = live or LiveTracker()
        self._narrow: Dict[int, tuple] = {}   # storage -> (ref, dtype)

    def _value_dtype(self, t: torch.Tensor) -> torch.dtype:
        hit = self._narrow.get(_key(t))
        if hit is not None and not hit[0].expired():
            return hit[1]
        return t.dtype

    def _tag(self, out: torch.Tensor, dt: torch.dtype) -> None:
        if dt != out.dtype and out.is_floating_point():
            s = out.untyped_storage()
            self._narrow[StorageWeakRef(s).cdata] = (StorageWeakRef(s), dt)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        packet = func._overloadpacket
        ins = _tensors(args, kwargs)
        outs = _tensors(out)
        prod = _product_flops(packet, args, kwargs, out)
        if prod is not None:
            f, operands = prod
            dt = max((self._value_dtype(t) for t in operands),
                     key=lambda d: _WIDTH.get(d, 4))
            self.flops[str(dt).replace("torch.", "")] += f
        mutates = func._schema.is_mutable
        in_keys = {_key(t) for t in ins}
        aliases = func.is_view or all(_key(t) in in_keys for t in outs)
        if (mutates or not aliases) and packet not in _ALLOCATING:
            dests = {id(t) for t in _tensors(kwargs.get("out"))}
            reads = [t for t in ins if id(t) not in dests]
            self.raw_bytes += sum(t.numel() * t.element_size()
                                  for t in reads + outs)
        if mutates:
            for t in ins:      # a write may store other values
                self._narrow.pop(_key(t), None)
        elif packet is aten._to_copy and ins and outs:
            src = self._value_dtype(ins[0])
            if ins[0].is_floating_point() and \
                    _WIDTH.get(src, 8) < _WIDTH.get(outs[0].dtype, 0):
                self._tag(outs[0], src)
        elif packet in _VALUE_KEEPING and outs:
            dts = [self._value_dtype(t) for t in ins
                   if t.is_floating_point()]
            if dts:
                self._tag(outs[0], max(dts, key=lambda d: _WIDTH.get(d, 4)))
        for t in outs:
            self.live.add(t)
        self.live.observe()
        return out


def _trace_cell(cell: Cell, fn=None) -> Dict:
    """Run ``cell.fn(*cell.args)`` (or ``fn(*cell.args)``) on its meta
    tensors under ``CostMode`` (the counterpart of ``_compile_cell``).  The
    arguments count as live from the start."""
    live = LiveTracker()
    for t in tensor_leaves(cell.args):
        live.add(t)
    arg_bytes = live.upper
    live.observe()
    mode = CostMode(live)
    with mode:
        out = (fn or cell.fn)(*cell.args)
    out_bytes = sum(t.numel() * t.element_size() for t in _tensors(out))
    del out
    return {"flops_by_dtype": dict(mode.flops),
            "flops": float(sum(mode.flops.values())),
            "bytes accessed": float(mode.raw_bytes),
            "n_ops": mode.n_ops,
            "argument_size_in_bytes": arg_bytes,
            "output_size_in_bytes": out_bytes,
            "peak_memory_in_bytes": live.peak}


def record_roofline(rec: Dict, meta: Dict) -> Dict:
    """The roofline of a record's counts per card over its ``n_chips``,
    with the rank's collectives."""
    return roofline(rec["cost"], rec["n_chips"], meta=meta,
                    collectives=rec.get("collectives", ()))


def run_cell(arch: str, shape: str, mesh: Optional[str] = None,
             rank: int = 0) -> Dict:
    """Trace a cell's cost on ``cell.fn`` and its memory on the program
    that runs, ``cell.memory_fn`` where the cell has one (train_4k's 4
    microbatches; the reference compiles a ``fast`` build for that), else
    on the same trace.  ``mesh``: None for one card, or a leg of
    ``MESHES``, traced at ``rank``; the collectives are the cost
    program's."""
    t0 = time.time()
    traced = None if mesh is None else make_production_mesh(
        multi_pod=MESHES[mesh], rank=rank)
    cell = cfgreg.get_arch(arch).build_cell(shape, traced)
    with sharding_ctx(traced, cell.rules):
        tr = _trace_cell(cell)
        records = traced.collective_records() if traced is not None else []
        mem = _trace_cell(cell, cell.memory_fn) if cell.memory_fn else tr
    cost = {k: tr[k] for k in ("flops", "bytes accessed", "flops_by_dtype",
                               "n_ops")}
    memory = {k: mem[k] for k in ("argument_size_in_bytes",
                                  "output_size_in_bytes",
                                  "peak_memory_in_bytes")}
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh or MESH,
        "n_chips": traced.size if traced is not None else 1,
        "ok": True,
        "trace_s": round(time.time() - t0, 1),
        "memory": memory,
        "fits_80gb": memory["peak_memory_in_bytes"] < HBM_PER_CHIP,
        "cost": cost,
        "meta": cell.meta,
    }
    if traced is not None:
        rec.update(rank=rank, placed=True, collectives=records)
    rec["roofline"] = record_roofline(rec, cell.meta)
    return rec


def sweep(cells: Iterable, out: str, meshes: Sequence[Optional[str]] = (
        None,), rank: int = 0) -> Dict[str, Dict]:
    """Run ``cells`` ((arch, shape) pairs) on each leg of ``meshes`` (None:
    one card), resuming from ``out``."""
    results: Dict[str, Dict] = {}
    if os.path.exists(out):
        with open(out) as f:
            results = json.load(f)
    for arch, shape in cells:
        for mesh in meshes:
            key = f"{arch}/{shape}/{mesh or MESH}"
            if results.get(key, {}).get("ok"):
                print(f"[skip] {key}")
                continue
            print(f"[run ] {key} ...", flush=True)
            try:
                rec = run_cell(arch, shape, mesh, rank)
                rf = rec["roofline"]
                print(f"[ ok ] {key}: trace={rec['trace_s']}s "
                      f"bottleneck={rf['bottleneck']} "
                      f"peak={rec['memory']['peak_memory_in_bytes'] / 1e9:.2f}"
                      f"GB collective="
                      f"{rf['collective_bytes_per_chip'] / 1e9:.3f}GB",
                      flush=True)
            except Exception as e:  # noqa: BLE001
                rec = {"arch": arch, "shape": shape, "ok": False,
                       "mesh": mesh or MESH,
                       "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:]}
                print(f"[FAIL] {key}: {rec['error'][:200]}", flush=True)
            results[key] = rec
            os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
            with open(out, "w") as f:
                json.dump(results, f, indent=1)
    return results


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="dryrun_results.json")
    ap.add_argument("--include-antglm", action="store_true")
    ap.add_argument("--single-pod", action="store_true",
                    help="the (16, 16) mesh leg alone")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 16, 16) mesh leg alone")
    ap.add_argument("--both-meshes", action="store_true",
                    help="both mesh legs")
    ap.add_argument("--rank", type=int, default=0,
                    help="the mesh rank a mesh leg traces")
    args = ap.parse_args(argv)
    if args.arch:
        shapes = [args.shape] if args.shape else \
            cfgreg.get_arch(args.arch).SHAPES
        cells = [(args.arch, s) for s in shapes]
    else:
        cells = cfgreg.assigned_cells()
        if args.include_antglm:
            cells += [("antglm_10b", s)
                      for s in cfgreg.get_arch("antglm_10b").SHAPES]
    meshes = ([m for m, on in (("16x16", args.single_pod),
                               ("2x16x16", args.multi_pod)) if on]
              or [None])
    if args.both_meshes:
        meshes = list(MESHES)
    results = sweep(cells, args.out, meshes, args.rank)
    n_ok = sum(1 for r in results.values() if r.get("ok"))
    print(f"\n{n_ok}/{len(results)} cells OK -> {args.out}")


if __name__ == "__main__":
    main()
