"""Build the port's CUDA kernels with ``nvcc`` at first use and load them
with ``ctypes``.

Each kernel source (``<module>/csrc/<kernel>.cu``, plus the shared headers
in ``kernels/csrc/``) compiles into its own shared library with a plain C
interface — no PyTorch headers, so a build takes seconds.  Libraries land in
``build/kernels/`` at the repository root (listed in ``.gitignore``), named
by a hash of their sources and flags, so an edited source rebuilds and an
unchanged one loads straight away.  ``build()`` starts one ``nvcc`` per
source, all at once.  Nothing but the repository's own sources is compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"
HEADERS = _PKG / "csrc"
SOURCES: Dict[str, Path] = {
    "tree_attention": _PKG / "tree_attention" / "csrc" / "tree_attention.cu",
    "flash_prefill": _PKG / "flash_prefill" / "csrc" / "flash_prefill.cu",
    "paged_tree_attention": (_PKG / "tree_attention" / "csrc"
                             / "paged_tree_attention.cu"),
    "flash_prefill_tri": (_PKG / "flash_prefill" / "csrc"
                          / "flash_prefill_tri.cu"),
    "gumbel_argmax": _PKG / "gumbel_argmax" / "csrc" / "gumbel_argmax.cu",
    "embedding_bag": _PKG / "embedding_bag" / "csrc" / "embedding_bag.cu",
}
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry point and argtypes per library: every pointer and the stream as
# c_void_p (a plain int argument would be cut to 32 bits), sizes as c_int
_ENTRY = {
    "tree_attention": ("tree_attention_launch",
                       [_P, _P, _P, _P, _P] + [_I] * 7 + [_P]),
    "flash_prefill": ("flash_prefill_launch",
                      [_P, _P, _P, _P] + [_I] * 6 + [_P]),
    "paged_tree_attention": ("paged_tree_attention_launch",
                             [_P] * 6 + [_I] * 9 + [_P]),
    "flash_prefill_tri": ("flash_prefill_tri_launch",
                          [_P] * 5 + [_I] * 6 + [_P]),
    "gumbel_argmax": ("gumbel_argmax_launch", [_P] * 8 + [_I] * 5 + [_P]),
    "embedding_bag": ("embedding_bag_launch", [_P] * 5 + [_I] * 6 + [_P]),
}
# further C entry points of a library: name -> argtypes
_EXTRA = {"gumbel_argmax": {"gumbel_noise_launch": [_P] * 4 + [_I] * 2
                                                   + [_P]},
          "embedding_bag": {"embedding_bag_window_launch": [_P] * 5
                            + [_I] * 8 + [_P]}}
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default install."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from source on the machine with the card")


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in [SOURCES[name]] + sorted(HEADERS.glob("*.cuh")):
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` process per source, all started together.  Returns each built
    library's compiler log (ptxas register and shared-memory report); raises
    with the log if any compile fails."""
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(HEADERS), "-o", str(tmp),
               str(SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)          # atomic: a concurrent build may race
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built on first use and loaded once."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        fn_name, argtypes = _ENTRY[name]
        for fn_name, argtypes in [(fn_name, argtypes),
                                  *_EXTRA.get(name, {}).items()]:
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


# where a gradient comes from instead, per kernel: none has a backward
_NO_BACKWARD = {
    "tree_attention": "decode_backend='dense'",
    "paged_tree_attention": "decode_backend='dense'",
    "flash_prefill": "prefill_backend='dense' (the reference trains through "
                     "it)",
    "gumbel_argmax": "nothing: token choice has no gradient; call it under "
                     "torch.no_grad()",
    "embedding_bag": "embedding_bag_fused, whose autograd.Function has the "
                     "backward",
}


def check_cuda(kernel: str, *tensors: torch.Tensor,
               aligned: bool = True) -> None:
    """Reject what the kernels do not take: an input that requires grad
    while grad mode is on (no kernel has a backward, and its output would
    silently carry no gradient), tensors off the card or on different
    cards, non-contiguous storage, storage that is not 16-byte aligned (the
    kernels read 16-byte vectors; ``aligned=False`` for a kernel that takes
    any alignment), and dtypes other than one shared float32/bfloat16."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: an input requires grad, and the CUDA kernel has no "
            f"backward (its output would carry no gradient); for a gradient "
            f"use {_NO_BACKWARD[kernel]}")
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: expected CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{kernel}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: tensors must be contiguous")
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{kernel}: tensor storage is not 16-byte "
                             "aligned")
    dt = tensors[0].dtype
    if dt not in DTYPE_CODE:
        raise ValueError(f"{kernel}: dtype {dt} not supported "
                         "(float32 or bfloat16)")


def check_status(kernel: str, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{rc}")


__all__ = ["build", "load", "library_path", "nvcc", "check_cuda",
           "check_status", "BUILD_DIR", "SOURCES", "DTYPE_CODE"]
