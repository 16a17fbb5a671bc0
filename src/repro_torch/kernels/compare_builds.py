"""Check that the attention kernels give the same bits when built from
another checkout of the repository — for a change to the shared tile body
that must not move them.

    PYTHONPATH=src python -m repro_torch.kernels.compare_builds OTHER_ROOT

builds the tree-attention (dense and paged) and flash-prefill kernels from
this checkout and from ``OTHER_ROOT`` (each with its own ``_build``, in its
own ``build/kernels``), runs both builds on the same inputs on the card —
the serving path's shapes and the shapes of ``tests/test_kernels.py`` /
``tests/test_paged_cache.py``, in f32 and bf16 — and exits non-zero unless
every output pair is equal bit for bit.  The triangular-schedule prefill
kernel is held against the other checkout's own build of it where that
checkout has one, else against its plain flash-prefill kernel (same C
interface, same function, same bits).  The C interfaces must be the same in
both checkouts.  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from . import _build

NAMES = ("tree_attention", "paged_tree_attention", "flash_prefill",
         "flash_prefill_tri")
# (B, T, H, K, dh, bs, bpl) of the paged cases: the decode path and the
# tests' small pools
PAGED = [(4, 33, 12, 2, 128, 64, 8), (1, 128, 12, 2, 128, 64, 8),
         (3, 5, 4, 2, 16, 8, 6), (2, 9, 8, 1, 64, 16, 5)]
TREE = [(4, 33, 12, 2, 128, 512), (1, 1, 4, 4, 64, 128),
        (2, 5, 8, 4, 64, 256), (1, 9, 4, 1, 96, 512),
        (2, 65, 12, 2, 128, 1024), (1, 33, 16, 16, 128, 384)]
PREFILL = [(4, 128, 12, 2, 128), (1, 128, 12, 2, 128), (2, 256, 4, 2, 64),
           (1, 512, 8, 8, 96), (2, 256, 6, 2, 128), (1, 128, 2, 1, 80),
           (1, 4096, 12, 2, 128)]


def other_libraries(root: str) -> dict:
    """Build the kernels of ``NAMES`` that ``root`` has with its own build
    module, in a subprocess, and return their library paths."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {root + '/src'!r})\n"
            "from repro_torch.kernels import _build\n"
            f"names = [n for n in {list(NAMES)!r} if n in _build.SOURCES]\n"
            "_build.build(names)\n"
            "print(json.dumps({n: str(_build.library_path(n)) for n in "
            "names}))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=root).stdout
    return json.loads(out.strip().splitlines()[-1])


def launcher(path: str, name: str):
    lib = ctypes.CDLL(path)
    fn_name, argtypes = _build._ENTRY[name]
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def run(fn, dtype, *tensors_and_sizes, n_out):
    stream = torch.cuda.current_stream().cuda_stream
    tensors = tensors_and_sizes[:n_out]
    out = torch.empty_like(tensors[0])
    ptrs = [t.data_ptr() for t in tensors]
    rc = fn(*ptrs, out.data_ptr(), *tensors_and_sizes[n_out:],
            _build.DTYPE_CODE[dtype], stream)
    _build.check_status("compare_builds", rc)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernels."
                                 "compare_builds")
    ap.add_argument("other_root", help="root of the other checkout")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("compare_builds: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build(list(NAMES))
    mine = {n: launcher(str(_build.library_path(n)), n) for n in NAMES}
    theirs = {n: launcher(p, n)
              for n, p in other_libraries(args.other_root).items()}
    if "flash_prefill_tri" not in theirs:
        theirs["flash_prefill_tri"] = theirs["flash_prefill"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_equal = n_cases = 0

    def compare(name, dtype, shape, *args, n_in):
        nonlocal n_equal, n_cases
        outs = [run(fn[name], dtype, *args, n_out=n_in)
                for fn in (mine, theirs)]
        same = torch.equal(*outs)
        n_equal += same
        n_cases += 1
        print(f"{name} {str(dtype)[6:]} {shape}: "
              f"{'bit-equal' if same else 'DIFFERENT'}")

    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * 0.3).to(dtype)

        for B, T, H, K, dh, S in TREE:
            q, k, v = rnd(B, T, H, dh), rnd(B, S, K, dh), rnd(B, S, K, dh)
            mask = torch.rand((B, T, S), generator=gen, device="cuda") > 0.4
            mask[:, :, 0] = True
            compare("tree_attention", dtype, (B, T, H, K, dh, S), q, k, v,
                    mask, B, T, S, H, K, dh, n_in=4)
        for B, T, H, K, dh, bs, bpl in PAGED:
            nb = 1 + B * bpl
            q, kp, vp = rnd(B, T, H, dh), rnd(nb, bs, K, dh), \
                rnd(nb, bs, K, dh)
            bt = (torch.randperm(nb - 1, generator=gen, device="cuda")
                  [:B * bpl] + 1).reshape(B, bpl).int()
            mask = torch.rand((B, T, bpl * bs), generator=gen,
                              device="cuda") > 0.4
            mask[:, :, 0] = True
            compare("paged_tree_attention", dtype,
                    (B, T, H, K, dh, bs, bpl), q, kp, vp, bt, mask, B, T,
                    nb, bs, bpl, H, K, dh, n_in=5)
        for B, S, H, K, dh in PREFILL:
            q, k, v = rnd(B, S, H, dh), rnd(B, S, K, dh), rnd(B, S, K, dh)
            for name in ("flash_prefill", "flash_prefill_tri"):
                compare(name, dtype, (B, S, H, K, dh), q, k, v, B, S, H, K,
                        dh, n_in=3)
    torch.cuda.synchronize()
    print(f"compare_builds: {n_equal}/{n_cases} outputs bit-equal to "
          f"{args.other_root}'s build")
    return 0 if n_equal == n_cases else 1


if __name__ == "__main__":
    sys.exit(main())
