"""Hold the attention kernels and the fused EmbeddingBag kernel (B5) of
this checkout against another checkout's build of them: their bits, and
their device time.

    PYTHONPATH=src python -m repro_torch.kernels.compare_builds OTHER_ROOT \
        [--dtypes float32,bfloat16] [--time]

builds the tree-attention (dense and paged), flash-prefill and EmbeddingBag
kernels from this checkout and from ``OTHER_ROOT`` (each with its own
``_build``, in its own ``build/kernels``) and runs both builds on the same
inputs on the card, in each dtype of ``--dtypes``: the attention kernels at
the serving path's shapes and the shapes of ``tests/test_kernels.py`` /
``tests/test_paged_cache.py``; B5 at ``chip_smoke.py``'s and
``tests/test_torch_cuda.py``'s shapes (masked slots, weights, negative and
out-of-range ids) and on Wide & Deep's deep (40, 10^6, 32) and wide (40,
10^6, 1) tables at the serve_p99 and serve_bulk ids.  Every output pair is
reported as bit-equal (B5: NaN in the same places) or by its largest
absolute difference, and the exit code is non-zero unless every pair
compared is bit-equal — so ``--dtypes float32`` checks a change that must
not move the f32 bits, while bf16 pairs differ by design after a change to
the bf16 arithmetic.  The triangular-schedule prefill kernel is held
against the other checkout's own build of it where that checkout has one,
else against its plain flash-prefill kernel (same C interface, same
function, same bits).

``--time`` then prints each build's device time per call (torch.profiler)
taken in turns (other, this, this, other) in one process on one card: every
attention kernel at the serving path's shapes in bf16, each call on one of
28 layer-sized buffers (8 for the long prompt) as the decode layers see
them; B5 in f32 at the four Wide & Deep shapes (serve_p99 rotating over 8
id sets), each build both on the mask, as the model calls it, and on the
folded f32 weights (an old entry point on the folded weights only); and
Wide & Deep's whole forward at serve_p99 and serve_bulk, each checkout's
own package (its model, wrapper and kernel) on the same parameters and
inputs, as median ms of CUDA-event-timed calls (host dispatch included)
and as device ms per call.

The C interfaces must be the same in both checkouts, but for two: a
triangular-schedule kernel without the work-counter argument (a build from
before the persistent grid) is bound as the plain prefill kernel is, and a
B5 entry point without the mask argument (a build from before the kernel
folded the mask and weights itself) gets the folded f32 weights.  Those
bindings (``n_args`` below) serve comparisons against such builds only, and
go once no build worth comparing against lacks the arguments.  Needs a card
and ``nvcc``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import importlib
import json
import os
import subprocess
import sys
from typing import Optional

import numpy as np
import torch

from . import _build
from .embedding_bag.ops import fold_weights
from .timing import device_ms, path_mask

NAMES = ("tree_attention", "paged_tree_attention", "flash_prefill",
         "flash_prefill_tri", "embedding_bag")
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
# B5 (F, V, D, N, L), F = 0 a plain (V, D) table: chip_smoke.py's EB_SWEEP,
# D = 1 and stacked case, and tests/test_torch_cuda.py's EB_SHAPES and
# EB_CASES shapes; every one with masked slots, weights, and ids in
# [-V - 3, V + 3)
EB = [(0, 100, 128, 16, 4), (0, 500, 256, 8, 7), (0, 64, 128, 32, 3),
      (0, 1000, 128, 4, 1), (0, 300, 1, 64, 4), (0, 300, 33, 64, 7),
      (3, 50, 8, 64, 4), (40, 1000, 32, 512, 4), (40, 1000, 1, 512, 4),
      (0, 97, 1, 37, 4), (0, 97, 3, 37, 4), (0, 97, 8, 37, 3),
      (0, 97, 32, 37, 4), (0, 97, 33, 37, 7), (0, 97, 256, 13, 9),
      (0, 97, 32, 37, 9), (0, 97, 1, 37, 9), (40, 61, 32, 29, 4),
      (40, 61, 1, 29, 4), (3, 50, 1, 33, 4), (6, 1 << 20, 1, 100, 4),
      (3, 1 << 18, 16, 50, 7)]
EB_INPUTS = ("both", "mask", "weights", "neither")
# Wide & Deep's bags: 40 fields of 10^6 rows, deep D 32 and wide D 1, bags
# of 4 at the serve_p99 and serve_bulk batches
WD_F, WD_V, WD_L = 40, 10**6, 4
WD_BATCHES = {"serve_p99": 512, "serve_bulk": 262144}
N_ID_SETS = 8          # serve_p99 timing rotates over 8 id sets (> L2)
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


def eb_launcher(path: str, n_args: Optional[int] = None):
    """fn(table, ids, mask, weights, folded) -> out of the B5 library at
    ``path``: ids int32, mask uint8 and weights f32 (each or None), and
    ``folded`` = fold_weights(ids, mask, weights), which an entry point
    without the mask argument (``n_args`` other than this checkout's) takes
    in their place."""
    lib = ctypes.CDLL(path)
    fn = lib.embedding_bag_launch
    argtypes = _build._ENTRY["embedding_bag"][1]
    old = n_args is not None and n_args != len(argtypes)
    fn.argtypes = [ctypes.c_void_p] * 4 + argtypes[-7:] if old else argtypes
    fn.restype = ctypes.c_int

    def call(table, ids, mask, weights, folded):
        F = table.shape[0] if table.dim() == 3 else 1
        V, D = table.shape[-2:]
        L = ids.shape[-1]
        out = torch.empty(ids.shape[:-1] + (D,), dtype=table.dtype,
                          device=table.device)
        ptrs = ((folded.data_ptr(),) if old else tuple(
            None if t is None else t.data_ptr() for t in (mask, weights)))
        rc = fn(table.data_ptr(), ids.data_ptr(), *ptrs, out.data_ptr(),
                ids.numel() // L, L, F, V, D, _build.DTYPE_CODE[table.dtype],
                torch.cuda.current_stream().cuda_stream)
        _build.check_status("compare_builds embedding_bag", rc)
        return out
    call.old = old
    return call


def launcher(path: str, name: str, n_args: Optional[int] = None):
    """fn(pointers, sizes, dtype code, stream) of the kernel ``name`` in the
    library at ``path`` whose entry point takes ``n_args`` arguments (this
    checkout's count by default); a triangular kernel gets a work counter,
    device scratch that each launch zeroes.  B5 has its own call
    (``eb_launcher``)."""
    if name == "embedding_bag":
        return eb_launcher(path, n_args)
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


def eb_inputs(gen, shape, V, inputs, lo):
    """(ids, mask, weights, folded) on the card: int32 ids in [lo, V + 3)
    (all in range for lo = 0), a uint8 mask with about a quarter of the
    slots masked and randn f32 weights, each given where ``inputs`` names
    it (else None), and the f32 weights ``fold_weights`` makes of them."""
    hi = V + 3 if lo < 0 else V
    ids = torch.randint(lo, hi, shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    mask = (torch.rand(shape, generator=gen, device="cuda") > 0.25
            ).view(torch.uint8) if inputs in ("mask", "both") else None
    weights = torch.randn(shape, generator=gen, device="cuda") \
        if inputs in ("weights", "both") else None
    return ids, mask, weights, fold_weights(ids, mask, weights)


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bits, NaN in the same places (any NaN payload)."""
    nan = torch.isnan(a)
    if not torch.equal(nan, torch.isnan(b)):
        return False
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return torch.equal(a.masked_fill(nan, 0).view(ints),
                       b.masked_fill(nan, 0).view(ints))


def eb_cases(gen, dtypes):
    """(dtype, label, table, (ids, mask, weights, folded)) of every B5
    comparison: the small shapes of ``EB`` with each of ``EB_INPUTS``,
    then Wide & Deep's tables at both batches with the mask (the model's
    call) and with mask and weights."""
    for dtype in dtypes:
        for F, V, D, N, L in EB:
            t = torch.randn((F, V, D) if F else (V, D), generator=gen,
                            device="cuda").to(dtype)
            for inputs in EB_INPUTS:
                yield (dtype, (F, V, D, N, L, inputs), t,
                       eb_inputs(gen, (N, F, L) if F else (N, L), V, inputs,
                                 -V - 3))
        for D in (32, 1):
            t = (torch.randn((WD_F, WD_V, D), generator=gen, device="cuda")
                 * 0.01).to(dtype)
            for batch, B in WD_BATCHES.items():
                for inputs in ("mask", "both"):
                    yield (dtype, (WD_F, WD_V, D, batch, inputs), t,
                           eb_inputs(gen, (B, WD_F, WD_L), WD_V, inputs, 0))
            del t


def time_eb(builds: dict, gen) -> None:
    """B5's device ms per call in f32 at Wide & Deep's four shapes, in
    turns (the builds in order, then in reverse).  ``builds`` maps a label
    to (launcher, on_weights): on_weights passes the folded f32 weights and
    no mask, else the mask alone (an old entry point takes the folded
    weights either way)."""
    order = list(builds) + list(builds)[::-1]
    for part, D in (("deep", 32), ("wide", 1)):
        t = torch.randn((WD_F, WD_V, D), generator=gen, device="cuda") * 0.01
        for batch, B in WD_BATCHES.items():
            k = N_ID_SETS if batch == "serve_p99" else 1
            sets = [eb_inputs(gen, (B, WD_F, WD_L), WD_V, "mask", 0)
                    for _ in range(k)]
            times = {b: [] for b in builds}
            for b in order:
                fn, on_weights = builds[b]

                def call(i, fn=fn, on_weights=on_weights):
                    ids, mask, _, folded = sets[i % k]
                    return fn(t, ids, None, folded, folded) if on_weights \
                        else fn(t, ids, mask, None, folded)
                times[b].append(device_ms(call, 20 if k > 1 else 10))
            print(f"time embedding_bag {part} {tuple(t.shape)} {batch} ids "
                  f"{(B, WD_F, WD_L)} f32, device ms per call: " + "; ".join(
                      f"{b} {np.mean(x):.5f} "
                      f"({', '.join(f'{y:.5f}' for y in x)})"
                      for b, x in times.items()))
            del sets
        del t


def _package() -> dict:
    """The modules of ``repro_torch`` now in ``sys.modules``."""
    return {k: m for k, m in sys.modules.items()
            if k == "repro_torch" or k.startswith("repro_torch.")}


@contextlib.contextmanager
def package(modules: dict):
    """Run with ``modules`` as the ``repro_torch`` package in
    ``sys.modules`` (imports made inside functions then find them), and
    put back what was there."""
    saved = _package()
    for k in saved:
        del sys.modules[k]
    sys.modules.update(modules)
    try:
        yield
    finally:
        for k in _package():
            del sys.modules[k]
        sys.modules.update(saved)


def other_package(root: str) -> dict:
    """The ``repro_torch`` package of the checkout at ``root``, imported
    beside this one's under the same name: its Wide & Deep model with what
    that imports (its wrapper, and a kernel built by its own ``_build``)."""
    with package({}):
        sys.path.insert(0, root + "/src")
        try:
            importlib.import_module("repro_torch.models.recsys.wide_deep")
            return _package()
        finally:
            sys.path.remove(root + "/src")


def time_wd(other_root: str, reps: int = 3) -> None:
    """Wide & Deep's forward at serve_p99 (8 input sets in turn) and
    serve_bulk through each checkout's own package, on one set of full-size
    parameters and inputs (this checkout's), f32 with TF32 off, in turns
    (other, this, this, other; ``reps`` rounds): the median ms of calls
    timed by CUDA events one by one (host dispatch included, as a serving
    caller sees a call) and the device ms per call from torch.profiler."""
    from ..configs import wide_deep as wd_config
    from ..configs.recsys_common import BATCHES
    from ..training import data
    torch.backends.cuda.matmul.allow_tf32 = False
    pkgs = {"other": other_package(other_root), "this": _package()}
    fwd = {b: p["repro_torch.models.recsys.wide_deep"].forward
           for b, p in pkgs.items()}
    cfg = wd_config.full_config()
    params = wd_config.model.init_params(cfg, seed=0)
    F, V, L = cfg.n_sparse, cfg.rows_per_table, cfg.multi_hot

    def inputs(B, seed):
        b = data.wide_deep_batch(np.random.RandomState(seed), B, F, V, L,
                                 cfg.n_dense)
        return tuple(torch.from_numpy(b[k]).cuda() for k in
                     ("sparse_ids", "sparse_mask", "dense"))

    for shape, k, n in (("serve_p99", N_ID_SETS, 100), ("serve_bulk", 1, 5)):
        sets = [inputs(BATCHES[shape], 100 + i) for i in range(k)]
        outs = {}
        times = {b: ([], []) for b in pkgs}
        for b in ["other", "this", "this", "other"] * reps:
            with package(pkgs[b]):
                def call(i, f=fwd[b]):
                    return f(cfg, params, *sets[i % k])
                for i in range(2):
                    call(i)
                torch.cuda.synchronize()
                ev = [(torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
                      for _ in range(n)]
                for i, (e0, e1) in enumerate(ev):
                    e0.record()
                    call(i)
                    e1.record()
                torch.cuda.synchronize()
                times[b][0].append(float(np.median(
                    [e0.elapsed_time(e1) for e0, e1 in ev])))
                times[b][1].append(device_ms(call, n))
                outs[b] = call(0)
        same = same_bits(outs["other"], outs["this"])
        print(f"time wide-deep forward {shape} (B {BATCHES[shape]}) f32: "
              + "; ".join(f"{b} median {np.mean(c):.4f} ms a call "
                          f"({', '.join(f'{x:.4f}' for x in c)}), device "
                          f"{np.mean(d):.4f} ({', '.join(f'{x:.4f}' for x in d)})"
                          for b, (c, d) in times.items())
              + f"; logits {'bit-equal' if same else 'differ'}")
        del sets, outs
    del params
    torch.cuda.empty_cache()


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
    args.other_root = os.path.abspath(args.other_root)
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
    tally = {n: [0, 0] for n in ("attention", "embedding_bag")}

    def report(name, dtype, shape, outs, same):
        diff = (outs[0].float() - outs[1].float()).abs().nan_to_num(
            float("inf")).max().item()
        count = tally["embedding_bag" if name == "embedding_bag"
                      else "attention"]
        count[0] += same
        count[1] += 1
        print(f"{name} {str(dtype)[6:]} {shape}: "
              f"{'bit-equal' if same else f'differs, max|diff| {diff:.3e}'}")

    def compare(name, dtype, shape, *args, n_in):
        outs = [run(fn[name], dtype, *args, n_out=n_in)
                for fn in (mine, theirs)]
        report(name, dtype, shape, outs, torch.equal(*outs))

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
    if "embedding_bag" in theirs:
        for dtype, label, t, ins in eb_cases(gen, dtypes):
            outs = [fn["embedding_bag"](t, *ins) for fn in (mine, theirs)]
            report("embedding_bag", dtype, label, outs, same_bits(*outs))
            del outs, ins
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    for what, (n_equal, n_cases) in tally.items():
        print(f"compare_builds: {what} {n_equal}/{n_cases} outputs "
              f"({', '.join(str(d)[6:] for d in dtypes)}) bit-equal to "
              f"{args.other_root}'s build")
    if args.time:
        print(f"card: {torch.cuda.get_device_name(0)}")
        time_builds({"other": theirs, "this": mine}, gen)
        if "embedding_bag" in theirs:
            other = theirs["embedding_bag"]
            builds = {"other": (other, other.old)}
            if not other.old:
                builds["other, f32 weights"] = (other, True)
            time_eb(dict(builds, **{
                "this": (mine["embedding_bag"], False),
                "this, f32 weights": (mine["embedding_bag"], True)}), gen)
            time_wd(args.other_root)
    return 0 if all(e == n for e, n in tally.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
