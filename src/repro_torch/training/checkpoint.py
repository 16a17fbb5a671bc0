"""Fault-tolerant checkpointing in the reference's format (PyTorch port of
``repro.training.checkpoint``): atomic writes, retention, resume-latest.

Format: one ``arrays.npz`` per checkpoint (flat ``{path: array}``, a
``None`` leaf as ``<path>#none``) plus a ``manifest.json`` with the step,
the sorted keys, a sha256 digest over each key and its array's bytes, and
``logical_axes: null`` (the axes come with multi-GPU, ROADMAP A16).  Writes go to ``<dir>/tmp.<step>`` and are renamed to
``<dir>/step_<step:010d>``, so a crash mid-write never corrupts the latest
checkpoint.  The same state saved by either package gives the same keys and
digest, and restores in the other.

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
    def save(self, step: int, tree: Any, *, blocking: bool = True) -> str:
        flat = _flatten(tree)
        if self._async_thread is not None:
            self._async_thread.join()        # one in-flight write max
            self._async_thread = None
        if blocking:
            return self._write(step, flat)
        self._async_thread = threading.Thread(
            target=self._write, args=(step, flat), daemon=True)
        self._async_thread.start()
        return os.path.join(self.dir, f"step_{step:010d}")

    def wait(self) -> None:
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> str:
        with self._lock:
            tmp = os.path.join(self.dir, f"tmp.{step}")
            final = os.path.join(self.dir, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {
                "step": step,
                "keys": sorted(flat.keys()),
                "digest": _digest(flat),
                "logical_axes": None,
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
                mesh=None) -> Tuple[Any, int]:
        """Restore into the structure of ``template`` (its leaves only mark
        where arrays go) as numpy arrays.  Resharding onto a mesh
        (``mesh=``) belongs to multi-GPU (ROADMAP A16) and raises."""
        if mesh is not None:
            raise NotImplementedError(
                "restore(mesh=...): elastic resharding is not yet ported to "
                "repro_torch (ROADMAP A16, multi-GPU)")
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
        return _unflatten(data, template), step


__all__ = ["CheckpointManager"]
