"""Fault-tolerant checkpointing in the reference's format (PyTorch port of
``repro.training.checkpoint``): atomic writes, retention, resume-latest.

Format: one ``arrays.npz`` per checkpoint (flat ``{path: array}``, a
``None`` leaf as ``<path>#none``) plus a ``manifest.json`` with the step,
the sorted keys, a sha256 digest over each key and its array's bytes, and
the logical axes of each leaf (``save(logical_axes=)``, flattened as the
reference does; null without them).  Writes go to ``<dir>/tmp.<step>`` and
are renamed to ``<dir>/step_<step:010d>``, so a crash mid-write never
corrupts the latest checkpoint.  The same state saved by either package
gives the same keys and digest, and restores in the other.

ELASTIC resharding: ``restore(mesh=)`` returns each leaf that has logical
axes as this rank's block under ``placement`` on that mesh and the active
rules (``sharding_ctx``; ``DEFAULT_RULES`` outside one, as in the
reference: the "fsdp", "tensor" and "expert" dims split, a dim the axes
do not divide whole), whatever mesh saved it; ``save(mesh=)`` takes such
blocks with their global shapes, gathers them from the ranks, and rank 0
writes the whole arrays.  A train state's moments are placed like their
parameters: save it with ``{"p": axes, "o": opt_state_axes(axes)}``
(``configs.common``), which the manifest records per key (``o/0``, the
step, as ``[]``: whole).

Tensors are pulled to host numpy in ``save``, before a non-blocking write's
thread starts (as the reference's ``_flatten`` does), so the caller may go
on to change or free them.  ``restore`` returns numpy arrays in the
template's structure; ``repro_torch.models.params.tree_to_torch`` moves
them to a device.  A bfloat16 tensor has no numpy dtype without
``ml_dtypes``, so ``save`` refuses one and names it rather than widening
it; the train states here are float32 and int32.
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import (Mesh, active_rules,
                                              block_sharding, placement)

_NUMPY_DTYPES = (torch.float64, torch.float32, torch.float16, torch.int64,
                 torch.int32, torch.int16, torch.int8, torch.uint8,
                 torch.bool)


def _to_numpy(leaf: Any, key: str) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    if leaf.dtype not in _NUMPY_DTYPES:
        raise TypeError(f"checkpoint leaf {key!r} is {leaf.dtype}, which "
                        "numpy cannot hold; cast it (e.g. to float32) "
                        "before saving")
    return leaf.detach().cpu().numpy()


def _flatten(tree: Any, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is None:
        out[prefix[:-1] + "#none"] = np.zeros((0,))
    else:
        out[prefix[:-1]] = _to_numpy(tree, prefix[:-1])
    return out


def _unflatten(flat: Dict[str, np.ndarray], template: Any, prefix: str = ""
               ) -> Any:
    if isinstance(template, dict):
        return {k: _unflatten(flat, template[k], f"{prefix}{k}/")
                for k in template}
    if isinstance(template, (list, tuple)):
        vals = [_unflatten(flat, v, f"{prefix}{i}/")
                for i, v in enumerate(template)]
        return type(template)(vals) if not hasattr(template, "_fields") \
            else type(template)(*vals)
    if template is None:
        return None
    return flat[prefix[:-1]]


def _digest(flat: Dict[str, np.ndarray]) -> str:
    """sha256 over each key and its array's C-order bytes, in key order
    (the reference's); the bytes are hashed in place, not copied."""
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(flat[k]).reshape(-1).view(
            np.uint8))
    return digest.hexdigest()


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._async_thread: Optional[threading.Thread] = None

    # ----------------------------------------------------------------- save
    def save(self, step: int, tree: Any, *, logical_axes: Any = None,
             mesh: Optional[Mesh] = None, shapes: Any = None,
             blocking: bool = True) -> str:
        """Write ``tree``; ``logical_axes`` (a tree of per-dim names beside
        it, e.g. ``{"p": param_logical_axes(cfg), "o": None}``) goes into
        the manifest.  With ``mesh``, every rank calls this, every array
        leaf needs logical axes (a whole leaf: ``None`` for each dim),
        and ``shapes`` (a tree of global shapes beside ``tree``, e.g.
        ``{"p": param_shapes(cfg)}``) gives each leaf its global shape:
        the leaf must be this rank's block of it under ``placement`` on
        the mesh by the active rules (as ``init_params(mesh=)`` and
        ``shard_params`` place parameters), and anything else raises
        before any rank gathers or writes; the blocks are gathered and
        rank 0 writes, the other ranks wait for it when ``blocking``."""
        if mesh is not None:
            tree = _gather_blocks(tree, _flatten_axes(logical_axes), mesh,
                                  _flatten_axes(shapes) or {})
        flat = _flatten(tree)
        path = os.path.join(self.dir, f"step_{step:010d}")
        if self._async_thread is not None:
            self._async_thread.join()        # one in-flight write max
            self._async_thread = None
        if mesh is not None and mesh.rank != 0:
            if blocking:
                mesh.barrier()
            return path
        if blocking:
            self._write(step, flat, logical_axes)
            if mesh is not None:
                mesh.barrier()
            return path
        self._async_thread = threading.Thread(
            target=self._write, args=(step, flat, logical_axes), daemon=True)
        self._async_thread.start()
        return path

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray],
               logical_axes: Any = None) -> str:
        with self._lock:
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            # the digest on a thread beside the write: hashing and the
            # zip's CRC and file writes release the GIL
            digest: List[str] = []
            hasher = threading.Thread(
                target=lambda: digest.append(_digest(flat)), daemon=True)
            hasher.start()
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            hasher.join()
            manifest = {
                "step": step,
                "keys": sorted(flat.keys()),
                "digest": digest[0],
                "logical_axes": _flatten_axes(logical_axes),
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._retain()
            return final

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"),
                          ignore_errors=True)

    # -------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            m = re.fullmatch(r"step_(\d+)", name)
            if m and os.path.exists(os.path.join(self.dir, name,
                                                 "manifest.json")):
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Any, step: Optional[int] = None,
                mesh: Optional[Mesh] = None) -> Tuple[Any, int]:
        """Restore into the structure of ``template`` (its leaves only mark
        where arrays go) as numpy arrays.  With ``mesh`` and saved logical
        axes, each leaf that has axes is this rank's block under
        ``placement`` by the active rules, as ``shard_params`` would cut it
        — the elastic path: the mesh that saved it does not matter, only
        the logical names."""
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"restore(mesh=) takes a repro_torch Mesh, not "
                            f"{type(mesh).__name__}")
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        with np.load(os.path.join(path, "arrays.npz"),
                     allow_pickle=False) as npz:
            data = dict(npz)
        if _digest(data) != manifest["digest"]:
            raise IOError(f"checkpoint {path} failed integrity check")
        tree = _unflatten(data, template)
        axes = manifest.get("logical_axes")
        if mesh is not None and axes:
            rules = active_rules()
            placed = {}
            for key, leaf in _flatten(tree).items():
                ax = axes.get(key)
                # a 0-d leaf (the optimizer's step) is whole: kept as it is
                placed[key] = leaf if ax is None or leaf.ndim == 0 else \
                    np.ascontiguousarray(placement(mesh, ax, leaf.shape,
                                                   rules).local(leaf))
            tree = _unflatten(placed, template)
        return tree, step


def _flatten_axes(axes: Any) -> Optional[Dict[str, Any]]:
    """The reference's flattening of a logical-axes tree: ``{path: list of
    names}``, a subtree of None as one None entry.  A NamedTuple
    (``opt_state_axes``' ``AdamWState``) is a node, its fields numbered
    as ``_flatten`` numbers the state's; the reference's flattening keeps
    it as one entry, which its restore without a mesh ignores."""
    if axes is None:
        return None
    flat = {}

    def rec(t, prefix=""):
        if isinstance(t, dict):
            for k in sorted(t):
                rec(t[k], f"{prefix}{k}/")
        elif isinstance(t, (list,)) or hasattr(t, "_fields") or (
                isinstance(t, tuple) and t and isinstance(t[0], (dict,
                                                                 list))):
            for i, v in enumerate(t):
                rec(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = list(t) if isinstance(t, tuple) else t

    rec(axes)
    return flat


def _gather_blocks(tree: Any, axes: Optional[Dict[str, Any]], mesh: Mesh,
                   shapes: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The flat global arrays of ``tree``, whose leaves are this rank's
    blocks of the global ``shapes`` under ``placement`` by their logical
    axes and the active rules: all ranks gather each split block (in key
    order).  An array leaf without axes (a rank's block or a whole array:
    nothing tells which) or without its global shape, or of another shape
    than its block, raises before anything is gathered."""
    rules = active_rules()
    flat = _flatten(tree)
    placed = {}
    for key, leaf in flat.items():
        if key.endswith("#none"):
            continue
        ax = (axes or {}).get(key)
        if ax is None:
            raise ValueError(f"checkpoint leaf {key!r} has no logical axes: "
                             "save(mesh=) needs them for every array (None "
                             "for each dim of a whole one; a train state's "
                             "moments: opt_state_axes)")
        glob = shapes.get(key)
        if glob is None:
            raise ValueError(f"checkpoint leaf {key!r}: save(mesh=) "
                             "needs its global shape in shapes= (e.g. "
                             "param_shapes(cfg))")
        placed[key] = block_sharding(f"checkpoint leaf {key!r}", leaf.shape,
                                     ax, glob, mesh, rules)
    # the blocks are host arrays already: gloo gathers them there (an NCCL
    # mesh gathers on its device), and only to rank 0, which writes
    dev = "cpu" if mesh.backend == "gloo" else mesh.device
    out = {}
    for key, leaf in flat.items():
        sh = placed.get(key)
        if sh is not None and sh.axes():
            whole = sh.gather(torch.as_tensor(leaf, device=dev), first=True)
            leaf = whole.cpu().numpy() if mesh.rank == 0 else None
        out[key] = leaf
    return out


__all__ = ["CheckpointManager"]
