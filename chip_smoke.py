#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. the card: its name and power limit from ``nvidia-smi``;
2. the build: the three CUDA kernels compiled from this checkout's sources,
   one ``nvcc`` each, in parallel;
3. the kernels: each held against its plain PyTorch version on the card in
   f32 and bf16 — at the serving path's shapes and at the shapes of
   ``tests/test_kernels.py`` / ``tests/test_paged_cache.py`` — and the
   paged kernel against the dense one, bit for bit, on the same logical
   K/V; then each timed beside its plain version, the one PyTorch library
   call that computes the same function where there is one (timed here
   only, never called by the port) and its bound (bytes over 3.35 TB/s or
   operations over the peak rate for the input type, whichever is larger);
4. the model: Qwen2-1.5B at full width with 2 layers, the cuda backend's
   logits against the dense backend's in f32 on both KV layouts (and the
   suffix prefill), and in bf16 both against the f32 path, with a limit
   that kernels made 3 % wrong must fail (the main path's guided logits do
   not depend on attention values);
5. the main path: Qwen2-1.5B at full width in bf16 with random weights from
   a seed, served through ``build_engine`` with the serve CLI's defaults and
   a guided logits transform (drafts verify, and token choice never rests on
   a near tie), first on the dense KV layout, then on the paged layout —
   the same requests, and a shared-prefix workload with the prefix cache on
   and off.  Every output must equal the port's ``reference_decode`` (and
   the other layout's / the other run's), each kernel must have launched on
   its path (the paged kernel on every paged decode step and suffix
   prefill, the dense one never there), each decode step must pull exactly
   one packed result to the host, and no step function may sync the host.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  The script imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12              # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core rate
              torch.float32: 67e12}    # f32 outside the tensor cores
# Kernel vs plain version.  Both sum in f32 and round once to the output
# dtype, so in bf16 they differ by at most about one output ulp (2^-7 of the
# value, relative): rtol 1.6e-2 is two of them, and atol 1e-4 covers the f32
# sum-order noise near zero.  Typical |out| at the tested shapes is 1e-2 to
# 4e-2, so an error of a few percent of the output fails.
TOL = {torch.float32: dict(atol=3e-5, rtol=1e-4),   # order of f32 sums
       torch.bfloat16: dict(atol=1e-4, rtol=1.6e-2)}
PATH_TREE = (4, 33, 12, 2, 128, 512)   # (B, T, H, K, dh, S) of fused_step
PATH_PREFILL = [(4, 128, 12, 2, 128), (1, 128, 12, 2, 128)]  # (B,S,H,K,dh)
# (B, T, H, K, dh, bs, bpl) of the paged fused_step: a 33-block pool
PATH_PAGED = (4, 33, 12, 2, 128, 64, 8)
SUFFIX_BUCKETS = (8, 16, 32, 64, 128)  # the suffix prefill's T (B = 1)
SHARED_HEAD, SHARED_TAIL, N_SHARED = 80, 16, 16   # shared-prefix workload
BF16_LOGIT_RATIO = 1.25                # cuda vs dense, each against f32
N_LAYERS = 28                          # timing rotates over 28 layer caches
N_REQUESTS, MAX_NEW = 8, 48


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


# ------------------------------------------------------------------ inputs
def randn(gen, shape, dtype, scale=0.3):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def tree_mask_path(B, T, S, seed=0):
    """Serving-like (B, T, S) mask: a committed prefix per lane plus the
    ancestor closure of a random draft tree at rows [len, len+T)."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((B, T, S), bool)
    for b in range(B):
        n = int(rng.randint(96, S - T - MAX_NEW))
        parent = [-1] + [int(rng.randint(0, i)) for i in range(1, T)]
        for i in range(T):
            j = i
            while j >= 0:
                mask[b, i, n + j] = True
                j = parent[j]
        mask[b, :, :n] = True
    return torch.from_numpy(mask).cuda()


def tree_mask_tests(B, T, S, kind):
    """The masks of tests/test_kernels.py: prefix + tril block ("sweep") or
    random with key 0 always visible ("random")."""
    rng = np.random.RandomState(B * 1000 + T * 10 + S)
    if kind == "random":
        mask = rng.rand(B, T, S) > 0.4
        mask[:, :, 0] = True
        return torch.from_numpy(mask).cuda()
    mask = np.zeros((B, T, S), bool)
    lens = rng.randint(S // 4, S // 2, size=(B,))
    for b in range(B):
        mask[b, :, :lens[b]] = True
        mask[b, :, lens[b]:lens[b] + T] = np.tril(np.ones((T, T), bool))
    return torch.from_numpy(mask).cuda()


def shuffled_tables(n_used, bpl, seed=0):
    """(B, bpl) int32 tables: lane b's first n_used[b] logical blocks on
    distinct physical blocks 1.. in a shuffled order, the rest of its table
    NULL (block 0)."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(np.arange(1, 1 + sum(n_used)))
    bt = np.zeros((len(n_used), bpl), np.int32)
    for b, n in enumerate(n_used):
        bt[b, :n], ids = ids[:n], ids[n:]
    return torch.from_numpy(bt).cuda()


def paged_case(gen, B, T, H, K, dh, bs, bpl, dtype, mask, n_used=None,
               seed=0):
    """q, a pool of 1 + sum(n_used) blocks, tables and ``mask`` for B2;
    every lane's blocks allocated by default."""
    n_used = n_used or [bpl] * B
    nb = 1 + sum(n_used)
    return (randn(gen, (B, T, H, dh), dtype),
            randn(gen, (nb, bs, K, dh), dtype),
            randn(gen, (nb, bs, K, dh), dtype),
            shuffled_tables(n_used, bpl, seed), mask)


def suffix_mask(T, offset, S):
    """The suffix prefill's (1, T, S) mask: the cached prefix plus causal
    within the suffix."""
    from repro_torch.models.attention import build_full_tree_mask
    tril = torch.ones((1, T, T), dtype=torch.bool, device="cuda").tril()
    return build_full_tree_mask(
        torch.tensor([offset], device="cuda"), tril, S)


def paged_kernel_cases(gen, dtype):
    """(label, q, k_pool, v_pool, tables, mask) of every B2 case: the
    decode path (fully allocated, and with NULL tails), every suffix bucket
    at the shared-prefix offset, and the shapes of tests/test_paged_cache.py
    (dh 8/16, blocks of 8 to 32 rows, NULL entries, blocks out of order)."""
    B, T, H, K, dh, bs, bpl = PATH_PAGED
    S = bs * bpl
    mask = tree_mask_path(B, T, S)
    yield ("decode", *paged_case(gen, B, T, H, K, dh, bs, bpl, dtype, mask))
    last = (torch.arange(S, device="cuda") * mask).amax(dim=(1, 2))
    n_used = [int(x) // bs + 1 for x in last.tolist()]
    yield ("decode, NULL tails", *paged_case(gen, B, T, H, K, dh, bs, bpl,
                                             dtype, mask, n_used, seed=1))
    for Tb in SUFFIX_BUCKETS:
        m = suffix_mask(Tb, SHARED_HEAD, S)
        n = -(-(SHARED_HEAD + Tb) // bs)
        yield (f"suffix T={Tb}", *paged_case(gen, 1, Tb, H, K, dh, bs, bpl,
                                             dtype, m, [n], seed=Tb))
    rng = np.random.RandomState(0)
    for dh_, bs_ in [(8, 16), (16, 8), (8, 32)]:
        B_, T_, H_, K_, nb, bpl_ = 3, 5, 4, 2, 9, 4
        lens = torch.tensor([bs_ + 3, 2 * bs_ + 1, 4], device="cuda")
        tree = np.zeros((B_, T_, T_), bool)
        for b in range(B_):
            tree[b] = np.tril(rng.rand(T_, T_) < 0.7) | np.eye(T_, dtype=bool)
        from repro_torch.models.attention import build_full_tree_mask
        m = build_full_tree_mask(lens, torch.from_numpy(tree).cuda(),
                                 bpl_ * bs_)
        bt = torch.tensor([[6, 2, 3, 0], [4, 1, 8, 7], [5, 0, 0, 0]],
                          dtype=torch.int32, device="cuda")
        yield (f"tests/test_paged_cache.py dh={dh_} bs={bs_}",
               randn(gen, (B_, T_, H_, dh_), dtype),
               randn(gen, (nb, bs_, K_, dh_), dtype),
               randn(gen, (nb, bs_, K_, dh_), dtype), bt, m)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


# ----------------------------------------------------------------- timing
def time_ms(fn, iters=40, warmup=5) -> float:
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------- phase 3
def kernel_phase(gen):
    from repro_torch.kernels.flash_prefill.ops import (flash_prefill,
                                                       flash_prefill_ref)
    from repro_torch.kernels.tree_attention.ops import (
        tree_attention, tree_attention_reference)
    from repro_torch.kernels.tree_attention.paged import (
        paged_tree_attention, paged_tree_attention_reference)
    from repro_torch.kernels.tree_attention.ref import paged_gather
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def hold(name, out, ref, dtype, shape):
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        ok = torch.allclose(out.float(), ref.float(), **TOL[dtype])
        typ = ref.float().abs().mean().item()
        print(f"  {name} {str(dtype)[6:]:8s} {shape}: max|err| {err:.3e} "
              f"mean|ref| {typ:.3e} {'ok' if ok else 'FAIL'} ({TOL[dtype]})")
        check(ok, f"{name} disagrees with its plain version at {shape} "
                  f"{dtype}: max abs err {err}")
        return err

    errs = {"tree_attention": 0.0, "flash_prefill": 0.0,
            "paged_tree_attention": 0.0}
    tree_cases = ([(PATH_TREE, "path")]
                  + [(s, "sweep") for s in [
                      (1, 1, 4, 4, 64, 128), (2, 5, 8, 4, 64, 256),
                      (1, 9, 4, 1, 96, 512), (2, 65, 12, 2, 128, 1024),
                      (1, 33, 16, 16, 128, 384)]]
                  + [(s, "random") for s in [
                      (2, 5, 4, 2, 64, 320), (1, 9, 4, 4, 96, 200),
                      (2, 7, 8, 2, 64, 640), (2, 7, 4, 2, 64, 256)]])
    for dtype in (torch.float32, torch.bfloat16):
        for (B, T, H, K, dh, S), kind in tree_cases:
            q = randn(gen, (B, T, H, dh), dtype)
            k = randn(gen, (B, S, K, dh), dtype)
            v = randn(gen, (B, S, K, dh), dtype)
            mask = (tree_mask_path(B, T, S) if kind == "path"
                    else tree_mask_tests(B, T, S, kind))
            out = tree_attention(q, k, v, mask)
            torch.cuda.synchronize()
            e = hold("tree_attention", out,
                     tree_attention_reference(q, k, v, mask), dtype,
                     (B, T, H, K, dh, S))
            if kind == "path" and dtype == torch.bfloat16:
                errs["tree_attention"] = e
        for (B, S, H, K, dh) in PATH_PREFILL + [
                (2, 256, 4, 2, 64), (1, 512, 8, 8, 96), (2, 256, 6, 2, 128),
                (1, 128, 2, 1, 80), (2, 320, 4, 2, 64), (1, 300, 6, 3, 80),
                (1, 256, 4, 2, 64), (2, 512, 4, 4, 128), (1, 384, 6, 2, 96)]:
            q = randn(gen, (B, S, H, dh), dtype)
            k = randn(gen, (B, S, K, dh), dtype)
            v = randn(gen, (B, S, K, dh), dtype)
            out = flash_prefill(q, k, v)
            torch.cuda.synchronize()
            e = hold("flash_prefill", out, flash_prefill_ref(q, k, v), dtype,
                     (B, S, H, K, dh))
            if (B, S, H, K, dh) == PATH_PREFILL[0] and dtype == torch.bfloat16:
                errs["flash_prefill"] = e
        # B2 against its plain version, then against B1 on the same logical
        # K/V (each lane's blocks gathered into a dense cache): bit for bit
        n_bits = 0
        for label, q, k, v, bt, mask in paged_kernel_cases(gen, dtype):
            out = paged_tree_attention(q, k, v, bt, mask)
            torch.cuda.synchronize()
            e = hold("paged_tree_attention", out,
                     paged_tree_attention_reference(q, k, v, bt, mask), dtype,
                     f"{label} q{tuple(q.shape)} pool{tuple(k.shape)} "
                     f"tables{tuple(bt.shape)}")
            if label == "decode" and dtype == torch.bfloat16:
                errs["paged_tree_attention"] = e
            if q.shape[-1] >= 16:
                dense = tree_attention(q, paged_gather(k, bt).contiguous(),
                                       paged_gather(v, bt).contiguous(), mask)
                check(torch.equal(out, dense),
                      f"paged_tree_attention {label} {dtype}: not bit-equal "
                      "to tree_attention on the same logical K/V")
                n_bits += 1
        print(f"  paged_tree_attention {str(dtype)[6:]}: bit-equal to "
              f"tree_attention on the same logical K/V in {n_bits} cases")

    # ---- timing at the path's shapes in bf16, rotating over 28 layer-sized
    # caches (56 MiB of K/V: more than L2, as the 28 decode layers see it)
    dt = torch.bfloat16
    rows = {}
    B, T, H, K, dh, S = PATH_TREE
    q = randn(gen, (N_LAYERS, B, T, H, dh), dt)
    kc = randn(gen, (N_LAYERS, B, S, K, dh), dt)
    vc = randn(gen, (N_LAYERS, B, S, K, dh), dt)
    mask = tree_mask_path(B, T, S, seed=1)
    L = N_LAYERS
    ms = time_ms(lambda i: tree_attention(q[i % L], kc[i % L], vc[i % L],
                                          mask))
    plain = time_ms(lambda i: tree_attention_reference(
        q[i % L], kc[i % L], vc[i % L], mask), iters=10)
    m4 = mask[:, None]
    lib = time_ms(lambda i: sdpa(q[i % L].transpose(1, 2),
                                 kc[i % L].transpose(1, 2),
                                 vc[i % L].transpose(1, 2), attn_mask=m4,
                                 enable_gqa=True))
    # what this mask needs: each lane's K/V rows up to its last visible key,
    # q and the output, the mask; products over the visible (t, s) pairs
    last = torch.arange(S, device="cuda")[None, None] * mask
    n_keys = (last.amax(dim=(1, 2)) + 1).sum().item()
    es = 2
    nbytes = (2 * q[0].numel() * es + mask.numel()
              + 2 * n_keys * K * dh * es)
    flops = 4.0 * mask.sum().item() * H * dh
    b_ms, b_by = bound(nbytes, flops, dt)
    rows["tree_attention"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                  bound_ms=b_ms, bound_by=b_by)
    print(f"  tree_attention bf16 {PATH_TREE}: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}: {nbytes/1e6:.3f} MB, {flops/1e9:.3f} GFLOP)")

    # B2 at the paged decode shape, each call on one of 28 layer pools
    # (60 MiB of K/V), beside its plain version, the library's nearest
    # (a gather of each lane's blocks, then sdpa: no one PyTorch call reads
    # paged K/V) and B1 on the gathered caches
    B, T, H, K, dh, bs, bpl = PATH_PAGED
    S = bs * bpl
    mask = tree_mask_path(B, T, S, seed=1)
    bt = shuffled_tables([bpl] * B, bpl, seed=2)
    nb = 1 + B * bpl
    q = randn(gen, (N_LAYERS, B, T, H, dh), dt)
    kp = randn(gen, (N_LAYERS, nb, bs, K, dh), dt)
    vp = randn(gen, (N_LAYERS, nb, bs, K, dh), dt)
    ms = time_ms(lambda i: paged_tree_attention(q[i % L], kp[i % L],
                                                vp[i % L], bt, mask))
    plain = time_ms(lambda i: paged_tree_attention_reference(
        q[i % L], kp[i % L], vp[i % L], bt, mask), iters=10)
    m4 = mask[:, None]
    gather_sdpa = time_ms(lambda i: sdpa(
        q[i % L].transpose(1, 2),
        paged_gather(kp[i % L], bt).transpose(1, 2),
        paged_gather(vp[i % L], bt).transpose(1, 2), attn_mask=m4,
        enable_gqa=True))
    kd = torch.stack([paged_gather(kp[i], bt) for i in range(L)])
    vd = torch.stack([paged_gather(vp[i], bt) for i in range(L)])
    dense_ms = time_ms(lambda i: tree_attention(q[i % L], kd[i % L],
                                                vd[i % L], mask))
    del kd, vd
    last = torch.arange(S, device="cuda")[None, None] * mask
    n_keys = (last.amax(dim=(1, 2)) + 1).sum().item()
    nbytes = (2 * q[0].numel() * es + mask.numel() + bt.numel() * 4
              + 2 * n_keys * K * dh * es)
    flops = 4.0 * mask.sum().item() * H * dh
    b_ms, b_by = bound(nbytes, flops, dt)
    rows["paged_tree_attention"] = dict(
        ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms, bound_by=b_by,
        gather_sdpa_ms=gather_sdpa, tree_attention_ms=dense_ms)
    print(f"  paged_tree_attention bf16 {PATH_PAGED}: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, gather+sdpa (3 calls: two gathers, one "
          f"sdpa) {gather_sdpa:.4f} ms, tree_attention on the gathered "
          f"caches {dense_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{nbytes/1e6:.3f} MB, {flops/1e9:.3f} GFLOP)")

    B, S, H, K, dh = PATH_PREFILL[0]
    q = randn(gen, (N_LAYERS, B, S, H, dh), dt)
    k = randn(gen, (N_LAYERS, B, S, K, dh), dt)
    v = randn(gen, (N_LAYERS, B, S, K, dh), dt)
    ms = time_ms(lambda i: flash_prefill(q[i % L], k[i % L], v[i % L]))
    plain = time_ms(lambda i: flash_prefill_ref(q[i % L], k[i % L],
                                                v[i % L]), iters=10)
    lib = time_ms(lambda i: sdpa(q[i % L].transpose(1, 2),
                                 k[i % L].transpose(1, 2),
                                 v[i % L].transpose(1, 2), is_causal=True,
                                 enable_gqa=True))
    nbytes = (2 * q[0].numel() + 2 * k[0].numel()) * 2
    flops = 4.0 * B * H * dh * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, flops, dt)
    rows["flash_prefill"] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                                 bound_ms=b_ms, bound_by=b_by)
    print(f"  flash_prefill bf16 {PATH_PREFILL[0]}: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}: {nbytes/1e6:.3f} MB, {flops/1e9:.3f} GFLOP)")
    return errs, rows


# --------------------------------------------------------------- phase 4
def guided_transform(vocab: int, phase: int = 2, seed: int = 0,
                     span: int = 512):
    """The benchmarks' guided model (benchmarks/common.py), from numpy: a
    deterministic continuation bias G[position % phase, token] added to the
    logits, so outputs revisit shared chains that drafts can verify.  The
    successors are drawn from the first ``span`` ids, the benchmarks' vocab
    (over all 151936 ids a walk would not repeat within a request)."""
    rng = np.random.RandomState(seed + 1000 * phase)
    base = rng.randint(2, span, size=(vocab,))
    spec = rng.randint(2, span, size=(phase, vocab))
    shared = rng.rand(phase, vocab) < 0.7
    guide = torch.from_numpy(
        np.where(shared, base[None, :], spec).astype(np.int64)).cuda()

    def bias(logits, tokens, positions):
        nxt = guide[positions.long() % phase, tokens.long()]
        return logits.scatter_add(
            -1, nxt[..., None],
            torch.full(nxt.shape + (1,), 1e4, dtype=logits.dtype,
                       device=logits.device))

    return bias


def no_sync(member):
    """``member`` run with torch's CUDA sync check set to raise."""
    def call(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return member(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return call


def model_inputs(vocab, B=4, S=128, T=33, seed=0):
    """Path-like inputs of one cohort prefill and one tree step: B prompts
    padded to S with random lengths, then a random draft tree of T slots
    whose positions are each lane's length plus the node's depth."""
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(2, vocab, (B, S))).cuda()
    lens = torch.from_numpy(rng.randint(S // 2, S + 1, (B,))).cuda()
    tree = torch.from_numpy(rng.randint(2, vocab, (B, T))).cuda()
    tm = np.zeros((B, T, T), bool)
    for b in range(B):
        parent = [-1] + [int(rng.randint(0, i)) for i in range(1, T)]
        for i in range(T):
            j = i
            while j >= 0:
                tm[b, i, j] = True
                j = parent[j]
    tm = torch.from_numpy(tm).cuda()
    pos = lens[:, None] + tm.sum(-1) - 1
    return toks, lens, tree, pos, tm


def model_logits(cfg, params, ins, backend):
    """(last-token logits of the prefill, tree-step logits), in f32."""
    from repro_torch.models import transformer as tx
    c = dataclasses.replace(cfg, prefill_backend=backend,
                            decode_backend=backend)
    toks, lens, tree, pos, tm = ins
    cache = tx.init_cache(c, toks.shape[0], device="cuda")
    cache, last = tx.prefill(c, params, toks, lens, cache)
    _, lg = tx.tree_step(c, params, cache, lens, tree, pos, tm)
    return last.float(), lg.float()


def paged_model_logits(cfg, params, ins, backend):
    """The same inputs on the paged layout (blocks of 64, shuffled tables),
    in f32: (prefill logits, suffix-prefill logits of lane 1's last 16
    prompt tokens at their offset, tree-step logits)."""
    from repro_torch.models import transformer as tx
    bs = PATH_PAGED[5]
    c = dataclasses.replace(cfg, prefill_backend=backend,
                            decode_backend=backend, kv_layout="paged",
                            kv_block_size=bs)
    toks, lens, tree, pos, tm = ins
    B = toks.shape[0]
    cache = tx.init_paged_cache(c, B, device="cuda")
    cache["block_tables"] = shuffled_tables([tx.blocks_per_lane(c)] * B,
                                            tx.blocks_per_lane(c), seed=3)
    cache, last = tx.prefill_paged(c, params, toks, lens, cache)
    n = int(lens[1])
    cache, suffix = tx.prefill_from_offset_paged(
        c, params, cache, 1, toks[1:2, n - 16:n].contiguous(),
        lens[1:2] - 16, torch.tensor([16], device="cuda"))
    _, lg = tx.tree_step_paged(c, params, cache, lens, tree, pos, tm)
    return last.float(), suffix.float(), lg.float()


def register_scaled_backend(factor, name="cuda_scaled"):
    """Register the cuda backend with both kernels' outputs multiplied by
    ``factor`` under ``name``: kernels that are wrong by a known amount."""
    from repro_torch.models.attention import CudaBackend, register_backend

    class Scaled(CudaBackend):
        def prefill_attention(self, *args):
            return super().prefill_attention(*args) * factor

        def make_tree_attend(self, *args):
            attend = super().make_tree_attend(*args)
            return lambda *a: attend(*a) * factor

    Scaled.name = name
    register_backend(Scaled())
    return name


def model_phase():
    """Full width, 2 layers, path-like inputs: the cuda backend's logits
    against the dense backend's.  In f32 they agree to atol 1e-3.  In bf16
    both are held against the f32 dense path on the same bf16-rounded
    weights: the cuda backend's RMS logit error may be at most
    BF16_LOGIT_RATIO times the dense backend's, and kernels made wrong by
    3 % must fail that same limit (else it could not tell a wrong kernel)."""
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.models.params import init_params
    cfg32 = dataclasses.replace(full_config(), n_layers=2)
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16",
                                param_dtype="bfloat16")
    p16 = init_params(cfg16, seed=1, device="cuda")
    p32 = tree_map(lambda t: t.float(), p16)
    ins = model_inputs(cfg32.vocab_size)
    names = ("prefill", "tree_step")
    ref = model_logits(cfg32, p32, ins, "dense")
    got = model_logits(cfg32, p32, ins, "cuda")
    for name, a, b in zip(names, got, ref):
        err = (a - b).abs().max().item()
        print(f"  full-width 2-layer f32 {name} logits, cuda vs dense "
              f"backend: max|err| {err:.3e} (atol 1e-3)")
        check(bool(torch.isfinite(a).all()) and err < 1e-3,
              f"{name} logits: cuda backend vs dense max err {err}")
    for name, a, b in zip(("paged prefill", "suffix prefill",
                           "paged tree_step"),
                          paged_model_logits(cfg32, p32, ins, "cuda"),
                          paged_model_logits(cfg32, p32, ins, "dense")):
        err = (a - b).abs().max().item()
        print(f"  full-width 2-layer f32 {name} logits, cuda vs dense "
              f"backend: max|err| {err:.3e} (atol 1e-3)")
        check(bool(torch.isfinite(a).all()) and err < 1e-3,
              f"{name} logits: cuda backend vs dense max err {err}")

    def rms(a, b):
        return (a - b).pow(2).mean().sqrt().item()

    dense = model_logits(cfg16, p16, ins, "dense")
    cuda = model_logits(cfg16, p16, ins, "cuda")
    wrong = model_logits(cfg16, p16, ins, register_scaled_backend(1.03))
    for i, name in enumerate(names):
        e_dense, e_cuda, e_wrong = (rms(x[i], ref[i])
                                    for x in (dense, cuda, wrong))
        limit = BF16_LOGIT_RATIO * e_dense
        print(f"  full-width 2-layer bf16 {name} logits vs the f32 path: "
              f"RMS err dense {e_dense:.4e}, cuda {e_cuda:.4e}, cuda with "
              f"kernels 3% off {e_wrong:.4e}; limit {limit:.4e} "
              f"({BF16_LOGIT_RATIO} x dense; |logits| RMS "
              f"{ref[i].pow(2).mean().sqrt().item():.4f})")
        check(bool(torch.isfinite(cuda[i]).all()) and e_cuda <= limit,
              f"bf16 {name} logits: cuda RMS err {e_cuda} over {limit}")
        check(e_wrong > limit, f"bf16 {name} logits: kernels 3% off give "
                               f"RMS err {e_wrong}, within {limit}")
    del p16, p32


def path_model():
    """Qwen2-1.5B at full width in bf16, random weights from seed 0."""
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(full_config(), dtype="bfloat16",
                              param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  qwen2-1.5b full width bf16: {cfg.n_params()/1e9:.3f} B "
          f"params made on the card in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def path_phase(cfg, params):
    """The dense-layout main path; returns its kernel launches, prompts and
    outputs."""
    from repro_torch.core import reference_decode
    from repro_torch.core.request import SamplingParams
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.tree_attention.ops import tree_attention
    from repro_torch.serving.api import (EngineConfig, ServingEngine,
                                         build_engine)
    from repro_torch.training.data import PROFILES, SyntheticCorpus

    ecfg = EngineConfig(default_params=SamplingParams(max_new_tokens=MAX_NEW))
    transform = guided_transform(cfg.vocab_size)
    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=0)
    prompts = [corpus.sample()[0][:96] for _ in range(N_REQUESTS)]
    sp = SamplingParams(max_new_tokens=MAX_NEW)

    # warm-up engine (allocator, cuBLAS handles) whose step functions run
    # with torch's sync check set to "error": a member that made the host
    # wait for the card would raise here (the scheduler's own _pull runs
    # outside them); then a fresh engine for the measured run
    warm = build_engine(ecfg, cfg, params, logits_transform=transform,
                        device="cuda")
    fns = warm.fns
    warm = ServingEngine(dataclasses.replace(
        fns, prefill=no_sync(fns.prefill),
        prefill_into_slot=no_sync(fns.prefill_into_slot),
        fused_step=no_sync(fns.fused_step)), ecfg)
    for p in prompts[:ecfg.lanes + 2]:
        warm.submit(p, max_new_tokens=8)
    warm.run()
    check(warm.stats.admitted == ecfg.lanes + 2, "warm-up admissions")
    print(f"  no step function synced the host ({warm.stats.decode_steps} "
          "decode steps, cohort and lane admissions under "
          "torch.cuda.set_sync_debug_mode('error'))")
    del warm, fns

    engine = build_engine(ecfg, cfg, params, logits_transform=transform,
                          device="cuda")
    outs, launches, wall, tps, edl, fused = serve_counted(
        engine, prompts, sp, {"tree_attention": tree_attention,
                              "flash_prefill": flash_prefill})
    st = engine.stats
    print(f"  served {N_REQUESTS} requests: {sum(map(len, outs))} tokens in "
          f"{wall:.3f} s -> {tps:.1f} tokens/s; EDL {edl:.3f}; "
          f"{st.decode_steps} decode steps, median fused_step {fused:.3f} ms "
          f"(dispatch to packed pull); launches {launches}")
    check(all(v > 0 for v in launches.values()),
          f"a kernel never launched on the main path: {launches}")
    check(launches["tree_attention"] == cfg.n_layers * st.decode_steps,
          f"tree_attention launched {launches['tree_attention']} times for "
          f"{st.decode_steps} steps x {cfg.n_layers} layers")
    check(st.decode_syncs == st.decode_steps,
          f"{st.decode_syncs} decode syncs for {st.decode_steps} steps")
    check(engine.fns.fused_step._cache_size() == 1
          and engine.fns.prefill._cache_size() == 1
          and engine.fns.prefill_into_slot._cache_size() <= 1,
          "a step function saw more than one input shape")
    check(all(len(o) == MAX_NEW for o in outs), "short outputs")

    for i, (p, o) in enumerate(zip(prompts, outs)):
        ref = reference_decode(engine.fns, list(p), params=sp)
        check(o == ref, f"request {i}: served output ({len(o)} tokens) "
                        f"differs from reference_decode ({len(ref)})")
    print(f"  all {N_REQUESTS} outputs equal reference_decode")

    # prefill times (cohort (4, 128) and one lane (1, 128)), synchronized
    fns = engine.fns
    toks = np.zeros((ecfg.lanes, ecfg.prefill_len), np.int32)
    lens = np.zeros((ecfg.lanes,), np.int32)
    for b, p in enumerate(prompts[:ecfg.lanes]):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    pre, slot = [], []
    cache = None
    for _ in range(5):
        t0 = time.perf_counter()
        cache, chosen = fns.prefill(toks, lens)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        cache, chosen = fns.prefill_into_slot(cache, 1, toks[1:2], lens[1:2])
        torch.cuda.synchronize()
        slot.append((time.perf_counter() - t0) * 1e3)
    print(f"  median prefill (4, 128): {float(np.median(pre)):.3f} ms; "
          f"prefill_into_slot (1, 128): {float(np.median(slot)):.3f} ms")
    profile_decode(ecfg, cfg, params, transform, prompts, sp)
    return launches, prompts, outs


def serve_counted(engine, prompts, sp, counters):
    """Serve ``prompts`` to the end with every kernel counter in
    ``counters`` set to 0 just before and read just after; returns
    (outputs, launches, wall s, tokens/s, EDL, median fused_step ms)."""
    from repro_torch.core.request import Request
    engine.scheduler.record_breakdown = True
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    handles = [engine.submit(Request(prompt=list(p), params=sp))
               for p in prompts]
    engine.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    outs = [h.result().tokens for h in handles]
    n_tok = sum(len(o) for o in outs)
    n_steps = sum(h.result().stats.steps for h in handles)
    fused = float(np.median([b["device_step_ms"]
                             for b in engine.scheduler.step_breakdown]))
    return outs, launches, wall, n_tok / wall, n_tok / max(n_steps, 1), fused


def paged_phase(cfg, params, prompts, dense_outs):
    """The paged layout at full width: the dense path's 8 requests, then a
    shared-prefix workload with the prefix cache on and off.  Every output
    must equal the dense path's / the other run's and reference_decode on
    the paged step functions; B2 must carry every paged decode step and
    suffix prefill (28 launches each) and B1 none; one decode sync per
    step; no paged member may sync the host.  Then the dense and the
    paged layout serve the 8 requests in turns, for a paired step time.
    Returns the kernels' launches over the three checked runs."""
    from repro_torch.core import reference_decode
    from repro_torch.core.request import SamplingParams
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.tree_attention.ops import tree_attention
    from repro_torch.kernels.tree_attention.paged import paged_tree_attention
    from repro_torch.serving.api import (EngineConfig, ServingEngine,
                                         build_engine)
    from repro_torch.training.data import PROFILES, SyntheticCorpus

    L = cfg.n_layers
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    ecfg = EngineConfig(kv_layout="paged", block_size=PATH_PAGED[5],
                        default_params=sp)
    transform = guided_transform(cfg.vocab_size)
    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=1)
    head = corpus.sample()[0][:SHARED_HEAD]
    shared = [head + corpus.sample()[0][:SHARED_TAIL]
              for _ in range(N_SHARED)]
    check(all(len(p) == SHARED_HEAD + SHARED_TAIL for p in shared),
          "shared-prefix prompts too short")
    counters = {"paged_tree_attention": paged_tree_attention,
                "tree_attention": tree_attention,
                "flash_prefill": flash_prefill}

    # warm-up engine, prefix cache and scrub on, whose paged members run
    # under torch's sync check set to "error"; the workload reaches every
    # member: cohort prefill, a cold admission (an unrelated prompt), cache
    # hits (suffix prefill after a copy-on-write fork), scrubs at retire
    wcfg = dataclasses.replace(ecfg, prefix_cache=True, scrub_freed=True)
    fns = build_engine(wcfg, cfg, params, logits_transform=transform,
                       device="cuda").fns
    calls = {}

    def watched(name):
        member = no_sync(getattr(fns, name))

        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return member(*args, **kwargs)
        return call

    names = ("prefill", "prefill_into_slot", "fused_step", "prefill_suffix",
             "copy_block", "reset_blocks")
    warm = ServingEngine(dataclasses.replace(
        fns, **{n: watched(n) for n in names}), wcfg)
    for p in shared[:ecfg.lanes] + [prompts[0]] + shared[4:6]:
        warm.submit(p, max_new_tokens=8)
    warm.run()
    check(all(calls.get(n, 0) > 0 for n in names),
          f"the warm-up did not reach every paged member: {calls}")
    print(f"  no paged member synced the host (calls {calls} under "
          "torch.cuda.set_sync_debug_mode('error'))")
    del warm, fns

    # 1. the dense path's requests on the paged layout
    engine = build_engine(ecfg, cfg, params, logits_transform=transform,
                          device="cuda")
    outs, launches, wall, tps, edl, fused = serve_counted(
        engine, prompts, sp, counters)
    st = engine.stats
    total = dict(launches)
    print(f"  paged, {len(prompts)} requests: {tps:.1f} tokens/s "
          f"({wall:.3f} s), EDL {edl:.3f}; {st.decode_steps} decode steps, "
          f"median fused_step {fused:.3f} ms; launches {launches}")
    check(launches["paged_tree_attention"] == L * st.decode_steps,
          f"paged_tree_attention launched {launches['paged_tree_attention']}"
          f" times for {st.decode_steps} steps x {L} layers")
    check(launches["tree_attention"] == 0 and launches["flash_prefill"] > 0,
          f"paged run launches {launches}")
    check(st.decode_syncs == st.decode_steps,
          f"{st.decode_syncs} decode syncs for {st.decode_steps} steps")
    check(engine.fns.fused_step._cache_size() == 1,
          "paged fused_step saw more than one input shape")
    check(outs == dense_outs, "paged outputs differ from the dense path's")
    for i, (p, o) in enumerate(zip(prompts, outs)):
        check(o == reference_decode(engine.fns, list(p), params=sp),
              f"paged request {i} differs from reference_decode")
    print(f"  all {len(prompts)} paged outputs equal the dense path's and "
          "reference_decode")

    # 2. shared-prefix workload, prefix cache on, then off
    runs = {}
    for on in (True, False):
        engine = build_engine(dataclasses.replace(ecfg, prefix_cache=on),
                              cfg, params, logits_transform=transform,
                              device="cuda")
        outs, launches, wall, tps, edl, fused = serve_counted(
            engine, shared, sp, counters)
        st = engine.stats
        for n, c in launches.items():
            total[n] += c
        n_suffix = st.prefix_hits
        print(f"  shared prefix ({N_SHARED} x {SHARED_HEAD}+{SHARED_TAIL} "
              f"tokens), cache {'on' if on else 'off'}: {tps:.1f} tokens/s "
              f"({wall:.3f} s), EDL {edl:.3f}; {st.decode_steps} decode "
              f"steps, median fused_step {fused:.3f} ms; {n_suffix} suffix "
              f"prefills; launches {launches}")
        check(launches["paged_tree_attention"]
              == L * (st.decode_steps + n_suffix),
              f"paged_tree_attention launched "
              f"{launches['paged_tree_attention']} times for "
              f"{st.decode_steps} steps + {n_suffix} suffix prefills x {L}")
        check(launches["tree_attention"] == 0,
              f"tree_attention launched on the paged path: {launches}")
        check(st.decode_syncs == st.decode_steps,
              f"{st.decode_syncs} decode syncs for {st.decode_steps} steps")
        check(engine.fns.fused_step._cache_size() == 1,
              "paged fused_step saw more than one input shape")
        runs[on] = (engine, outs)
    engine, outs = runs[True]
    st = engine.stats
    fns = engine.fns
    check(st.prefix_hits > 0 and st.prefix_cow_forks > 0,
          f"prefix hits {st.prefix_hits}, COW forks {st.prefix_cow_forks}")
    cached = [engine.scheduler.results[rid].stats.cached_prompt_tokens
              for rid in range(N_SHARED)]     # a fresh engine's rids: 0..
    touched = {next(b for b in fns.suffix_buckets if b >= len(p) - n)
               for p, n in zip(shared, cached) if n}
    check(fns.prefill_suffix._cache_size() == len(touched),
          f"prefill_suffix saw {fns.prefill_suffix._cache_size()} shapes "
          f"for buckets {sorted(touched)}")
    print(f"  prefix cache: {st.prefix_hits}/{st.prefix_lookups} lookups hit"
          f" (hit rate {st.prefix_hit_rate:.3f}), {st.prefix_hit_tokens}/"
          f"{st.prefix_prompt_tokens} prefill tokens saved "
          f"({st.prefill_tokens_saved:.3f}), {st.prefix_cow_forks} COW "
          f"forks; suffix buckets touched {sorted(touched)}")
    check(outs == runs[False][1], "prefix cache on and off differ")
    for i, (p, o) in enumerate(zip(shared, outs)):
        check(o == reference_decode(fns, list(p), params=sp),
              f"shared-prefix request {i} differs from reference_decode")
    print(f"  all {N_SHARED} shared-prefix outputs equal with the cache on "
          "and off, and equal reference_decode")

    # suffix prefill (1 x 16 after an 80-token hit) against the full
    # one-lane prefill (1 x 128), synchronized, on the run's cache
    cache = engine.scheduler.cache
    toks = np.zeros((1, ecfg.prefill_len), np.int32)
    toks[0, :len(shared[0])] = shared[0]
    lens = np.asarray([len(shared[0])], np.int32)
    tail = np.asarray([shared[0][SHARED_HEAD:]], np.int32)
    suf, full = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        cache, _ = fns.prefill_suffix(cache, 1, tail, SHARED_HEAD)
        torch.cuda.synchronize()
        suf.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        cache, _ = fns.prefill_into_slot(cache, 1, toks, lens)
        torch.cuda.synchronize()
        full.append((time.perf_counter() - t0) * 1e3)
    print(f"  median suffix prefill (1, {SHARED_TAIL} -> bucket "
          f"{min(b for b in fns.suffix_buckets if b >= SHARED_TAIL)}) "
          f"{float(np.median(suf)):.3f} ms against prefill_into_slot "
          f"(1, {ecfg.prefill_len}) {float(np.median(full)):.3f} ms")
    del runs, engine, fns, cache

    # the two layouts in turns on the dense path's requests: the host-bound
    # step time drifts within a call, so only alternating runs compare them
    paired = {"dense": [], "paged": []}
    for layout in ("dense", "paged", "paged", "dense") * 2:
        engine = build_engine(dataclasses.replace(ecfg, kv_layout=layout),
                              cfg, params, logits_transform=transform,
                              device="cuda")
        outs, _, _, tps, _, fused = serve_counted(engine, prompts, sp, {})
        check(outs == dense_outs, f"{layout} outputs changed between runs")
        paired[layout].append((fused, tps))
    for layout, runs in paired.items():
        print(f"  in turns, {layout}: median fused_step "
              f"{float(np.median([r[0] for r in runs])):.3f} ms "
              f"(runs {', '.join(f'{r[0]:.3f}' for r in runs)}), tokens/s "
              f"{', '.join(f'{r[1]:.1f}' for r in runs)}")
    profile_decode(ecfg, cfg, params, transform, prompts, sp)
    return total


def profile_decode(ecfg, cfg, params, transform, prompts, sp, steps=5):
    """Where a decode step's time goes: a torch.profiler window over
    ``steps`` scheduler iterations that are pure decode (all lanes busy, no
    admission): wall time, device busy time and idle share, kernel launches
    per step, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.api import build_engine
    engine = build_engine(ecfg, cfg, params, logits_transform=transform,
                          device="cuda")
    for p in prompts[:ecfg.lanes]:
        engine.submit(list(p), params=sp)
    engine.step()                       # cohort prefill + first decode step
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    print(f"  profile of {steps} decode steps ({ecfg.kv_layout} layout, "
          f"{ecfg.lanes} lanes, T={ecfg.slots}): wall "
          f"{wall:.2f} ms, device busy {busy:.2f} ms, idle share "
          f"{1 - busy / wall:.3f}, {n_launch / steps:.0f} kernel launches "
          f"per step")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count / steps:6.0f} launches/step  {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run from "
              "the repository root", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(_build.SOURCES))})")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  [{name}] {line.strip()}")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    print("kernels:")
    errs, rows = kernel_phase(gen)
    print("model, full width, 2 layers:")
    model_phase()
    print("main path, dense layout:")
    cfg, params = path_model()
    launches, prompts, outs = path_phase(cfg, params)
    print("main path, paged layout and prefix cache:")
    paged = paged_phase(cfg, params, prompts, outs)
    launches["paged_tree_attention"] = paged["paged_tree_attention"]

    src = {"tree_attention": (
               "src/repro_torch/kernels/tree_attention/csrc/tree_attention.cu",
               "src/repro/kernels/tree_attention/tree_attention.py:31"),
           "paged_tree_attention": (
               "src/repro_torch/kernels/tree_attention/csrc/"
               "paged_tree_attention.cu",
               "src/repro/kernels/tree_attention/paged.py:31"),
           "flash_prefill": (
               "src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
               "src/repro/kernels/flash_prefill/flash_prefill.py:24")}
    table = [dict(name=n, route="cuda", source=src[n][0], replaces=src[n][1],
                  launches=launches[n], max_abs_err=errs[n], **rows[n])
             for n in src]
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeError, RuntimeError, ValueError, subprocess.SubprocessError,
            OSError) as exc:
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
