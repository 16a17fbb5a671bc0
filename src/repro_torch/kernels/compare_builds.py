"""Check that the dense kernels (tree attention, flash prefill) give the same
bits when built from another checkout of the repository — for a change to
the shared tile body that must not move them.

    PYTHONPATH=src python -m repro_torch.kernels.compare_builds OTHER_ROOT

builds ``tree_attention`` and ``flash_prefill`` from this checkout and from
``OTHER_ROOT`` (each with its own ``_build``, in its own ``build/kernels``),
runs both builds on the same inputs on the card — the serving path's
shapes and the shapes of ``tests/test_kernels.py``, in f32 and bf16 — and
exits non-zero unless every output pair is equal bit for bit.  The two
kernels' C interfaces must be the same in both checkouts.  Needs a card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from . import _build

NAMES = ("tree_attention", "flash_prefill")
TREE = [(4, 33, 12, 2, 128, 512), (1, 1, 4, 4, 64, 128),
        (2, 5, 8, 4, 64, 256), (1, 9, 4, 1, 96, 512),
        (2, 65, 12, 2, 128, 1024), (1, 33, 16, 16, 128, 384)]
PREFILL = [(4, 128, 12, 2, 128), (1, 128, 12, 2, 128), (2, 256, 4, 2, 64),
           (1, 512, 8, 8, 96), (2, 256, 6, 2, 128), (1, 128, 2, 1, 80)]


def other_libraries(root: str) -> dict:
    """Build the dense kernels with ``root``'s own build module, in a
    subprocess, and return their library paths."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {root + '/src'!r})\n"
            "from repro_torch.kernels import _build\n"
            f"_build.build({list(NAMES)!r})\n"
            "print(json.dumps({n: str(_build.library_path(n)) for n in "
            f"{list(NAMES)!r}}}))\n")
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
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n_equal = n_cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        def rnd(*shape):
            return (torch.randn(shape, generator=gen, device="cuda")
                    * 0.3).to(dtype)

        for B, T, H, K, dh, S in TREE:
            q, k, v = rnd(B, T, H, dh), rnd(B, S, K, dh), rnd(B, S, K, dh)
            mask = torch.rand((B, T, S), generator=gen, device="cuda") > 0.4
            mask[:, :, 0] = True
            outs = [run(fn["tree_attention"], dtype, q, k, v, mask,
                        B, T, S, H, K, dh, n_out=4) for fn in (mine, theirs)]
            same = torch.equal(*outs)
            n_equal += same
            n_cases += 1
            print(f"tree_attention {str(dtype)[6:]} {(B, T, H, K, dh, S)}: "
                  f"{'bit-equal' if same else 'DIFFERENT'}")
        for B, S, H, K, dh in PREFILL:
            q, k, v = rnd(B, S, H, dh), rnd(B, S, K, dh), rnd(B, S, K, dh)
            outs = [run(fn["flash_prefill"], dtype, q, k, v, B, S, H, K, dh,
                        n_out=3) for fn in (mine, theirs)]
            same = torch.equal(*outs)
            n_equal += same
            n_cases += 1
            print(f"flash_prefill {str(dtype)[6:]} {(B, S, H, K, dh)}: "
                  f"{'bit-equal' if same else 'DIFFERENT'}")
    torch.cuda.synchronize()
    print(f"compare_builds: {n_equal}/{n_cases} outputs bit-equal to "
          f"{args.other_root}'s build")
    return 0 if n_equal == n_cases else 1


if __name__ == "__main__":
    sys.exit(main())
