"""Hold the attention kernels of this checkout against another checkout's
build of them: their bits, and their device time.

    PYTHONPATH=src python -m repro_torch.kernels.compare_builds OTHER_ROOT \
        [--dtypes float32,bfloat16] [--time]

builds the tree-attention (dense and paged) and flash-prefill kernels from
this checkout and from ``OTHER_ROOT`` (each with its own ``_build``, in its
own ``build/kernels``) and runs both builds on the same inputs on the card:
the serving path's shapes and the shapes of ``tests/test_kernels.py`` /
``tests/test_paged_cache.py``, in each dtype of ``--dtypes``.  Every output
pair is reported as bit-equal or by its largest absolute difference, and the
exit code is non-zero unless every pair compared is bit-equal — so
``--dtypes float32`` checks a change that must not move the f32 bits, while
bf16 pairs differ by design after a change to the bf16 arithmetic.  The
triangular-schedule prefill kernel is held against the other checkout's own
build of it where that checkout has one, else against its plain
flash-prefill kernel (same C interface, same function, same bits).

``--time`` then prints each build's device time per call (torch.profiler)
of every kernel at the serving path's shapes in bf16, taken in turns (other,
this, this, other) in one process on one card, each call on one of 28
layer-sized buffers (8 for the long prompt) as the decode layers see them.

The C interfaces must be the same in both checkouts, but for one: a
triangular-schedule kernel without the work-counter argument (a build from
before the persistent grid) is bound as the plain prefill kernel is.  That
binding (``n_args`` below) serves comparisons against such builds only, and
goes once no build worth comparing against lacks the counter.  Needs a card
and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from . import _build
from .timing import device_ms, path_mask

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
           (1, 4096, 12, 2, 128), (2, 4096, 12, 2, 128),
           (2, 1000, 12, 2, 128), (1, 2333, 8, 1, 64),
           (1, 4000, 6, 6, 96), (1, 1500, 4, 2, 256)]
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
N_LAYERS = 28


def other_libraries(root: str) -> dict:
    """Build the kernels of ``NAMES`` that ``root`` has with its own build
    module, in a subprocess, and return each one's library path and the
    number of arguments of its C entry point."""
    code = ("import json, sys\n"
            f"sys.path.insert(0, {root + '/src'!r})\n"
            "from repro_torch.kernels import _build\n"
            f"names = [n for n in {list(NAMES)!r} if n in _build.SOURCES]\n"
            "_build.build(names)\n"
            "print(json.dumps({n: [str(_build.library_path(n)), "
            "len(_build._ENTRY[n][1])] for n in names}))\n")
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, cwd=root).stdout
    return json.loads(out.strip().splitlines()[-1])


def launcher(path: str, name: str, n_args: Optional[int] = None):
    """fn(pointers, sizes, dtype code, stream) of the kernel ``name`` in the
    library at ``path`` whose entry point takes ``n_args`` arguments (this
    checkout's count by default); a triangular kernel gets a work counter,
    device scratch that each launch zeroes."""
    lib = ctypes.CDLL(path)
    fn_name, argtypes = _build._ENTRY[name]
    if n_args is not None and n_args != len(argtypes):
        argtypes = _build._ENTRY["flash_prefill"][1]   # no work counter
    fn = getattr(lib, fn_name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    counter = []
    if argtypes == _build._ENTRY["flash_prefill_tri"][1]:
        counter = [torch.empty(1, dtype=torch.int32, device="cuda")]

    def call(ptrs, sizes, code, stream):
        return fn(*ptrs, *(c.data_ptr() for c in counter), *sizes, code,
                  stream)
    return call


def run(fn, dtype, *tensors_and_sizes, n_out):
    stream = torch.cuda.current_stream().cuda_stream
    tensors = tensors_and_sizes[:n_out]
    out = torch.empty_like(tensors[0])
    ptrs = [t.data_ptr() for t in tensors] + [out.data_ptr()]
    rc = fn(ptrs, tensors_and_sizes[n_out:], _build.DTYPE_CODE[dtype],
            stream)
    _build.check_status("compare_builds", rc)
    return out


def timing_cases(gen):
    """(label, kernel name, n calls, args(i)) at the serving path's shapes in
    bf16: each call i on buffer i % n of n layer-sized buffers."""
    dt = torch.bfloat16

    def rnd(*shape):
        return (torch.randn(shape, generator=gen, device="cuda")
                * 0.3).to(dt)

    L = N_LAYERS
    B, T, H, K, dh, S = TREE[0]
    q, k, v = rnd(L, B, T, H, dh), rnd(L, B, S, K, dh), rnd(L, B, S, K, dh)
    mask = path_mask(B, T, S, seed=1)
    yield ("tree_attention", "tree_attention", L,
           lambda i, B=B, T=T, H=H, K=K, dh=dh, S=S: (
               q[i % L], k[i % L], v[i % L], mask, B, T, S, H, K, dh))
    B, T, H, K, dh, bs, bpl = PAGED[0]
    nb = 1 + B * bpl
    qp, kp, vp = (rnd(L, B, T, H, dh), rnd(L, nb, bs, K, dh),
                  rnd(L, nb, bs, K, dh))
    bt = (torch.randperm(nb - 1, generator=gen, device="cuda")[:B * bpl]
          + 1).reshape(B, bpl).int()
    pmask = path_mask(B, T, bs * bpl, seed=1)
    yield ("paged_tree_attention", "paged_tree_attention", L,
           lambda i, B=B, T=T, H=H, K=K, dh=dh: (
               qp[i % L], kp[i % L], vp[i % L], bt, pmask, B, T, nb, bs, bpl,
               H, K, dh))
    for (B, S, H, K, dh), n in (((4, 128, 12, 2, 128), L),
                                ((1, 4096, 12, 2, 128), 8)):
        qf, kf, vf = (rnd(n, B, S, H, dh), rnd(n, B, S, K, dh),
                      rnd(n, B, S, K, dh))
        for name in ("flash_prefill", "flash_prefill_tri"):
            yield (f"{name} {(B, S)}", name, n,
                   lambda i, qf=qf, kf=kf, vf=vf, B=B, S=S, H=H, K=K,
                   dh=dh, n=n: (qf[i % n], kf[i % n], vf[i % n], B, S, H, K,
                                dh))


def time_builds(builds: dict, gen) -> None:
    """Device ms per call of each kernel in each build, in turns: the
    builds in order, then in reverse."""
    order = list(builds) + list(builds)[::-1]
    for label, name, n, args in timing_cases(gen):
        n_in = {"paged_tree_attention": 5, "tree_attention": 4}.get(name, 3)
        times = {b: [] for b in builds if name in builds[b]}
        for b in order:
            if b in times:
                fn = builds[b][name]
                times[b].append(device_ms(
                    lambda i: run(fn, torch.bfloat16, *args(i), n_out=n_in),
                    n))
        print(f"time {label} bf16, device ms per call: " + "; ".join(
            f"{b} {np.mean(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
            for b, t in times.items()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernels."
                                 "compare_builds")
    ap.add_argument("other_root", help="root of the other checkout")
    ap.add_argument("--dtypes", default="float32,bfloat16",
                    help="comma-separated dtypes to compare (float32, "
                         "bfloat16)")
    ap.add_argument("--time", action="store_true",
                    help="also time both builds at the path's shapes")
    args = ap.parse_args(argv)
    dtypes = [DTYPES[d] for d in args.dtypes.split(",") if d]
    if not torch.cuda.is_available():
        print("compare_builds: needs a CUDA card", file=sys.stderr)
        return 1
    _build.build(list(NAMES))
    mine = {n: launcher(str(_build.library_path(n)), n) for n in NAMES}
    theirs = {n: launcher(p, n, n_args)
              for n, (p, n_args) in other_libraries(args.other_root).items()}
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
        diff = (outs[0].float() - outs[1].float()).abs().max().item()
        n_equal += same
        n_cases += 1
        print(f"{name} {str(dtype)[6:]} {shape}: "
              f"{'bit-equal' if same else f'differs, max|diff| {diff:.3e}'}")

    for dtype in dtypes:
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
    print(f"compare_builds: {n_equal}/{n_cases} outputs "
          f"({', '.join(str(d)[6:] for d in dtypes)}) bit-equal to "
          f"{args.other_root}'s build")
    if args.time:
        print(f"card: {torch.cuda.get_device_name(0)}")
        time_builds({"other": theirs, "this": mine}, gen)
    return 0 if n_equal == n_cases else 1


if __name__ == "__main__":
    sys.exit(main())
