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
writes the whole arrays.

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

from repro_torch.distributed.sharding import Mesh, active_rules, placement

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
    digest = hashlib.sha256()
    for k in sorted(flat):
        digest.update(k.encode())
        digest.update(np.ascontiguousarray(flat[k]).tobytes())
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
        the manifest.  With ``mesh``, every rank calls this, and
        ``shapes`` (a tree of global shapes beside ``tree``, e.g.
        ``{"p": param_shapes(cfg)}``) gives each leaf with axes its global
        shape: the leaf must be this rank's block of it under
        ``placement`` on the mesh by the active rules (as
        ``init_params(mesh=)`` and ``shard_params`` place parameters), and
        anything else raises; the blocks are gathered and rank 0 writes,
        the other ranks wait for it when ``blocking``."""
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
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {
                "step": step,
                "keys": sorted(flat.keys()),
                "digest": _digest(flat),
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
                placed[key] = leaf if ax is None else np.ascontiguousarray(
                    placement(mesh, ax, leaf.shape, rules).local(leaf))
            tree = _unflatten(placed, template)
        return tree, step


def _flatten_axes(axes: Any) -> Optional[Dict[str, Any]]:
    """The reference's flattening of a logical-axes tree: ``{path: list of
    names}``, a subtree of None as one None entry."""
    if axes is None:
        return None
    flat = {}

    def rec(t, prefix=""):
        if isinstance(t, dict):
            for k in sorted(t):
                rec(t[k], f"{prefix}{k}/")
        elif isinstance(t, (list,)) or (isinstance(t, tuple)
                                        and t and isinstance(t[0], (dict,
                                                                    list))):
            for i, v in enumerate(t):
                rec(v, f"{prefix}{i}/")
        else:
            flat[prefix[:-1]] = list(t) if isinstance(t, tuple) else t

    rec(axes)
    return flat


def _gather_blocks(tree: Any, axes: Optional[Dict[str, Any]], mesh: Mesh,
                   shapes: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """The flat global arrays of ``tree``, whose leaves with axes are this
    rank's blocks of the global ``shapes`` under ``placement`` by the
    active rules: all ranks gather each split block (in key order).  A
    leaf without its global shape, or of another shape than its block,
    raises."""
    rules = active_rules()
    out = {}
    for key, leaf in _flatten(tree).items():
        ax = (axes or {}).get(key)
        if ax is not None:
            glob = shapes.get(key)
            if glob is None:
                raise ValueError(f"checkpoint leaf {key!r}: save(mesh=) "
                                 "needs its global shape in shapes= (e.g. "
                                 "param_shapes(cfg))")
            sh = placement(mesh, ax, tuple(glob), rules)
            if tuple(leaf.shape) != sh.shard_shape(glob):
                raise ValueError(
                    f"checkpoint leaf {key!r} has shape {tuple(leaf.shape)}"
                    f", not this rank's block {sh.shard_shape(glob)} of "
                    f"{tuple(glob)} under {sh.spec!r} (the active rules): "
                    "save the blocks placed inside the sharding_ctx they "
                    "were placed in")
            if sh.axes():
                block = torch.as_tensor(leaf, device=mesh.device)
                leaf = sh.gather(block).cpu().numpy()
        out[key] = leaf
    return out


__all__ = ["CheckpointManager"]
