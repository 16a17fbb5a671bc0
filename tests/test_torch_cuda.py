"""The port's CUDA kernels on the card, held against their plain PyTorch
versions (which tests/test_torch_kernels.py, tests/test_torch_paged.py,
tests/test_torch_sampler.py and tests/test_torch_sampling_serving.py hold
against the JAX package), the paged kernel against the dense one and the
triangular-schedule prefill against the plain prefill kernel, bit for bit.

Needs an NVIDIA card with nvcc: every test is marked ``gpu`` and skips
without CUDA.  Imports no JAX, so it runs on the card's machine:
``PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py``.
Tolerance: f32 atol=3e-5, rtol=1e-4; bf16 atol=1e-4, rtol=1.6e-2.  Both
sides sum in f32 and round once to bf16, so they differ by about one output
ulp (2^-7 relative); rtol is two ulps and atol covers f32 sum-order noise
near zero, while typical |outputs| here are 1e-2 to 1e-1.  The
Gumbel-argmax kernel's raw bits equal the plain generator's, its Gumbel
values agree to 2e-6 (two logf calls), and its choices equal the plain
version's wherever the plain top-two gap of z + g exceeds 1e-5.  The fused
EmbeddingBag kernel equals its plain version bit for bit, NaN in the same
places (ids out of range, Inf or NaN rows): both add the rounded f32
products in l order from 0 and round once.  The sanitizer's poison probe
reads the paged cache on the card after captured ``reset_blocks`` replays
(one pull a check), and a spawned fleet replica builds its engine on the
card.
"""
import dataclasses
import gc
import weakref

import numpy as np
import pytest
import torch

from repro_torch.kernels.embedding_bag.ops import (embedding_bag_fused,
                                                   embedding_bag_ref)
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.gumbel_argmax import ref as gref
from repro_torch.kernels.gumbel_argmax.ops import gumbel_argmax, gumbel_noise
from repro_torch.kernels.tree_attention.ops import tree_attention
from repro_torch.kernels.tree_attention.paged import paged_tree_attention

pytestmark = [pytest.mark.torch_port, pytest.mark.gpu]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
TREE_SHAPES = [(1, 1, 4, 4, 64, 128), (2, 5, 8, 4, 64, 256),
               (1, 9, 4, 1, 96, 512), (2, 65, 12, 2, 128, 1024),
               (1, 33, 16, 16, 128, 384), (4, 33, 12, 2, 128, 512),
               (1, 3, 4, 2, 16, 40), (1, 4, 8, 2, 256, 100)]
# (B, T, H, K, dh, bs, bpl): decode and suffix-prefill shapes of the path,
# MQA to MHA, dh 8 to 256, blocks of 8 to 64 rows
PAGED_SHAPES = [(4, 33, 12, 2, 128, 64, 8), (1, 128, 12, 2, 128, 64, 8),
                (3, 5, 4, 2, 16, 8, 6), (2, 9, 8, 1, 64, 16, 5),
                (2, 7, 4, 4, 96, 32, 3), (1, 4, 8, 2, 256, 8, 12),
                (2, 17, 6, 3, 80, 64, 2), (3, 5, 4, 2, 8, 32, 4)]
PREFILL_SHAPES = [(2, 256, 4, 2, 64), (1, 512, 8, 8, 96),
                  (2, 256, 6, 2, 128), (1, 128, 2, 1, 80),
                  (4, 128, 12, 2, 128), (1, 300, 6, 3, 80),
                  (1, 70, 2, 2, 256)]


def _tol(dtype):
    return dict(atol=1e-4, rtol=1.6e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels build and run "
                    "only there")
    return torch.device("cuda")


def _t(x, dtype, dev):
    return torch.from_numpy(x.astype(np.float32)).to(dev, DTYPES[dtype])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,K,dh,S", TREE_SHAPES)
def test_tree_attention_kernel_matches_plain(cuda, B, T, H, K, dh, S, dtype):
    rng = np.random.RandomState(0)
    q = _t(rng.randn(B, T, H, dh) * 0.3, dtype, cuda)
    k = _t(rng.randn(B, S, K, dh) * 0.3, dtype, cuda)
    v = _t(rng.randn(B, S, K, dh) * 0.3, dtype, cuda)
    lens = rng.randint(S // 4, S // 2, size=(B,))
    mask = np.zeros((B, T, S), bool)
    for b in range(B):
        mask[b, :, :lens[b]] = True
        mask[b, :, lens[b]:lens[b] + T] = np.tril(np.ones((T, T), bool))
    mask[0, -1] = False                  # one row that sees no key -> 0
    mask = torch.from_numpy(mask).to(cuda)
    n0 = tree_attention.launches
    out = tree_attention(q, k, v, mask)
    torch.cuda.synchronize()
    assert tree_attention.launches == n0 + 1
    assert torch.count_nonzero(out[0, -1]) == 0
    ref = tree_attention(q.cpu(), k.cpu(), v.cpu(), mask.cpu())
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,K,dh", PREFILL_SHAPES)
def test_flash_prefill_kernel_matches_plain(cuda, B, S, H, K, dh, dtype):
    rng = np.random.RandomState(1)
    q, k, v = (_t(rng.randn(B, S, n, dh) * 0.3, dtype, cuda)
               for n in (H, K, K))
    n0 = flash_prefill.launches
    out = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert flash_prefill.launches == n0 + 1
    ref = flash_prefill(q.cpu(), k.cpu(), v.cpu())
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().numpy(), **_tol(dtype))


def _paged_inputs(B, T, H, K, dh, bs, bpl, dtype, dev, seed=2):
    """A pool with every lane's blocks out of order and NULL entries in
    each table tail, a prefix-plus-tree mask, and one row that sees no
    key."""
    rng = np.random.RandomState(seed)
    n_used = [max(1, bpl - 1 - b % 2) for b in range(B)]
    nb = 1 + sum(n_used) + 2
    q = _t(rng.randn(B, T, H, dh) * 0.3, dtype, dev)
    k = _t(rng.randn(nb, bs, K, dh) * 0.3, dtype, dev)
    v = _t(rng.randn(nb, bs, K, dh) * 0.3, dtype, dev)
    ids = rng.permutation(np.arange(1, nb))
    bt = np.zeros((B, bpl), np.int32)
    S = bpl * bs
    mask = np.zeros((B, T, S), bool)
    for b in range(B):
        bt[b, :n_used[b]] = ids[:n_used[b]]
        ids = ids[n_used[b]:]
        n = max(1, min(n_used[b] * bs - T, int(rng.randint(1, S))))
        mask[b, :, :n] = True
        mask[b, :, n:n + T] = np.tril(np.ones((T, T), bool))[:, :S - n]
    mask[0, -1] = False                  # one row that sees no key -> 0
    return (q, k, v, torch.from_numpy(bt).to(dev),
            torch.from_numpy(mask).to(dev))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,K,dh,bs,bpl", PAGED_SHAPES)
def test_paged_tree_attention_kernel_matches_plain(cuda, B, T, H, K, dh, bs,
                                                   bpl, dtype):
    q, k, v, bt, mask = _paged_inputs(B, T, H, K, dh, bs, bpl, dtype, cuda)
    n0 = paged_tree_attention.launches
    out = paged_tree_attention(q, k, v, bt, mask)
    torch.cuda.synchronize()
    assert paged_tree_attention.launches == n0 + 1
    assert torch.count_nonzero(out[0, -1]) == 0
    ref = paged_tree_attention(q.cpu(), k.cpu(), v.cpu(), bt.cpu(),
                               mask.cpu())
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().numpy(), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,K,dh,bs,bpl",
                         [s for s in PAGED_SHAPES if s[4] >= 16])
def test_paged_kernel_equals_dense_kernel_bitwise(cuda, B, T, H, K, dh, bs,
                                                  bpl, dtype):
    """B2 on the pool gives B1's bits on the same logical K/V (each lane's
    blocks gathered into a dense cache): key tiles sit on logical
    positions in both.  (B1's wrapper takes dh >= 16.)"""
    from repro_torch.kernels.tree_attention.ref import paged_gather
    q, k, v, bt, mask = _paged_inputs(B, T, H, K, dh, bs, bpl, dtype, cuda)
    paged = paged_tree_attention(q, k, v, bt, mask)
    dense = tree_attention(q, paged_gather(k, bt).contiguous(),
                           paged_gather(v, bt).contiguous(), mask)
    torch.cuda.synchronize()
    assert torch.equal(paged, dense)


# The properties of the bf16 tile body the serving path relies on, bit for
# bit: a row's output does not depend on the other rows of its call.
def _tree_case(rng, B, T, H, K, dh, S, dev):
    q = _t(rng.randn(B, T, H, dh) * 0.3, "bfloat16", dev)
    k = _t(rng.randn(B, S, K, dh) * 0.3, "bfloat16", dev)
    v = _t(rng.randn(B, S, K, dh) * 0.3, "bfloat16", dev)
    mask = np.zeros((B, T, S), bool)
    for b in range(B):
        n = int(rng.randint(1, S - T))
        parent = [-1] + [int(rng.randint(0, i)) for i in range(1, T)]
        mask[b, :, :n] = True
        for i in range(T):
            j = i
            while j >= 0:
                mask[b, i, n + j] = True
                j = parent[j]
    return q, k, v, torch.from_numpy(mask).to(dev)


@pytest.mark.parametrize("B,T,H,K,dh,S", [(4, 33, 12, 2, 128, 512),
                                          (3, 17, 8, 2, 64, 300)])
def test_tree_kernel_lane_rows_same_alone_and_in_batch(cuda, B, T, H, K, dh,
                                                       S):
    """A lane's B1 rows in a (1, T) call equal its rows inside the (B, T)
    call, bit for bit."""
    q, k, v, mask = _tree_case(np.random.RandomState(5), B, T, H, K, dh, S,
                               cuda)
    full = tree_attention(q, k, v, mask)
    for b in range(B):
        one = tree_attention(q[b:b + 1].clone(), k[b:b + 1].clone(),
                             v[b:b + 1].clone(), mask[b:b + 1].clone())
        torch.cuda.synchronize()
        assert torch.equal(one[0], full[b]), f"lane {b}"


@pytest.mark.parametrize("B,T,H,K,dh,S", [(4, 33, 12, 2, 128, 512),
                                          (2, 33, 4, 4, 96, 200)])
def test_tree_kernel_row_same_at_width_1_and_33(cuda, B, T, H, K, dh, S):
    """A row's output at tree width 1 equals its output inside a width-33
    call when it sees the same keys."""
    q, k, v, mask = _tree_case(np.random.RandomState(6), B, T, H, K, dh, S,
                               cuda)
    full = tree_attention(q, k, v, mask)
    for i in (0, 1, T // 2, T - 1):
        one = tree_attention(q[:, i:i + 1].clone(), k, v,
                             mask[:, i:i + 1].clone())
        torch.cuda.synchronize()
        assert torch.equal(one[:, 0], full[:, i]), f"row {i}"


@pytest.mark.parametrize("T,S,off", [(8, 128, 80), (16, 128, 80),
                                     (32, 128, 80), (64, 128, 80),
                                     (128, 128, 80), (100, 4096, 1000),
                                     (128, 4096, 2000), (77, 1000, 900)])
def test_suffix_prefill_rows_equal_causal_prefill_rows(cuda, T, S, off):
    """B2 at (1, T) under the suffix prefill's mask (an ``off``-token cached
    prefix, causal within the suffix) gives B3's rows off ... of the same
    lane at (4, S), on the same K/V — the rows B3 has (off + i < S).  The
    long prompts run B3 with its key groups in sequence, and their suffixes
    cross 64-key tiles and B3's 128-row tiles."""
    from repro_torch.models.attention import build_full_tree_mask
    B, H, K, dh, bs, lane = 4, 12, 2, 128, 64, 2
    bpl = -(-S // bs)
    rng = np.random.RandomState(T + S)
    q, k, v = (_t(rng.randn(B, S, n, dh) * 0.3, "bfloat16", cuda)
               for n in (H, K, K))
    b3 = flash_prefill(q, k, v)
    # the lane's K/V in a pool, logical blocks shuffled, the rest random
    nb = 1 + bpl
    pool_k = _t(rng.randn(nb, bs, K, dh) * 0.3, "bfloat16", cuda)
    pool_v = _t(rng.randn(nb, bs, K, dh) * 0.3, "bfloat16", cuda)
    ids = rng.permutation(np.arange(1, nb)).astype(np.int32)
    for j in range(bpl):
        n_j = min(bs, S - j * bs)
        pool_k[ids[j], :n_j] = k[lane, j * bs:j * bs + n_j]
        pool_v[ids[j], :n_j] = v[lane, j * bs:j * bs + n_j]
    bt = torch.from_numpy(ids[None]).to(cuda)
    qs = _t(rng.randn(1, T, H, dh) * 0.3, "bfloat16", cuda)
    n = min(T, S - off)
    qs[0, :n] = q[lane, off:off + n]
    tril = torch.ones((1, T, T), dtype=torch.bool, device=cuda).tril()
    mask = build_full_tree_mask(torch.tensor([off], device=cuda), tril,
                                bs * bpl).contiguous()
    b2 = paged_tree_attention(qs, pool_k, pool_v, bt, mask)
    torch.cuda.synchronize()
    assert torch.equal(b2[0, :n], b3[lane, off:off + n])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("dh,S,bs", [(16, 77, 7), (64, 200, 8), (80, 333, 37),
                                     (96, 130, 10), (128, 455, 65)])
def test_tree_kernels_match_plain_across_dh_ragged_s(cuda, dh, S, bs, dtype):
    """B1 and B2 against their plain versions at dh 16 to 128, S not a
    multiple of the key tile (B2: S = bpl * bs with odd block sizes)."""
    rng = np.random.RandomState(dh + S)
    B, T, H, K = 3, 9, 6, 2
    q = _t(rng.randn(B, T, H, dh) * 0.3, dtype, cuda)
    k = _t(rng.randn(B, S, K, dh) * 0.3, dtype, cuda)
    v = _t(rng.randn(B, S, K, dh) * 0.3, dtype, cuda)
    mask = torch.from_numpy(rng.rand(B, T, S) > 0.3).to(cuda)
    out = tree_attention(q, k, v, mask)
    ref = tree_attention(q.cpu(), k.cpu(), v.cpu(), mask.cpu())
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().numpy(), **_tol(dtype))
    bpl = -(-S // bs)
    q2, kp, vp, bt, m2 = _paged_inputs(B, T, H, K, dh, bs, bpl, dtype, cuda,
                                       seed=dh)
    out = paged_tree_attention(q2, kp, vp, bt, m2)
    ref = paged_tree_attention(q2.cpu(), kp.cpu(), vp.cpu(), bt.cpu(),
                               m2.cpu())
    torch.cuda.synchronize()
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().numpy(), **_tol(dtype))


def test_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 4, 16, device=cuda)
    k = torch.zeros(1, 8, 2, 16, device=cuda)
    mask = torch.ones(1, 2, 8, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        tree_attention(q.half(), k.half(), k.half(), mask)
    with pytest.raises(ValueError, match="contiguous"):
        tree_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k,
                       k, mask)
    kv = torch.zeros(1, 2, 2, 12, device=cuda)          # dh = 12 < 16
    with pytest.raises(ValueError, match="dh=12"):
        flash_prefill(q[..., :12].contiguous(), kv, kv)
    with pytest.raises(ValueError, match="mask"):
        tree_attention(q, k, k, mask.int())
    pool = torch.zeros(3, 4, 2, 16, device=cuda)
    bt = torch.zeros(1, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="block_tables"):
        paged_tree_attention(q, pool, pool, bt.long(), mask)
    with pytest.raises(ValueError, match="block_tables"):
        paged_tree_attention(q, pool, pool, bt.cpu(), mask)
    with pytest.raises(ValueError, match="mask must be"):
        paged_tree_attention(q, pool, pool, bt, mask[..., :4].contiguous())


# (B, S, H, K, dh): the cohort prefill, a long prompt, tests/test_kernels.py's
# triangular-grid shapes, and ragged S
TRI_SHAPES = [(4, 128, 12, 2, 128), (1, 4096, 12, 2, 128), (1, 256, 4, 2, 64),
              (2, 512, 4, 4, 128), (1, 384, 6, 2, 96), (1, 300, 6, 3, 80)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,K,dh", TRI_SHAPES)
def test_triangular_prefill_kernel_matches_plain_and_b3_bitwise(
        cuda, B, S, H, K, dh, dtype):
    rng = np.random.RandomState(3)
    q, k, v = (_t(rng.randn(B, S, n, dh) * 0.3, dtype, cuda)
               for n in (H, K, K))
    n0, t0 = flash_prefill.launches, flash_prefill.tri_launches
    out = flash_prefill(q, k, v, triangular=True)
    b3 = flash_prefill(q, k, v)
    torch.cuda.synchronize()
    assert flash_prefill.tri_launches == t0 + 1
    assert flash_prefill.launches == n0 + 1
    assert torch.equal(out, b3)
    ref = flash_prefill(q.cpu(), k.cpu(), v.cpu(), triangular=True)
    np.testing.assert_allclose(out.float().cpu().numpy(),
                               ref.float().numpy(), **_tol(dtype))


# (B, S, H, K, dh) at the causal kernels' edges: S ragged against the
# 64-key tile and the 64- and 128-row tiles, G 1, 6 and 8, dh 64 to 256, S
# up to 4096; both kernels (the key groups in sequence at dh 128 where the
# 128-row blocks fill the card: the first four, G 6, 8 and 1)
CAUSAL_EDGES = [(1, 4096, 12, 2, 128), (2, 1000, 12, 2, 128),
                (1, 2333, 8, 1, 128), (4, 1100, 4, 4, 128),
                (1, 4001, 8, 1, 64), (2, 3000, 4, 4, 96),
                (1, 1500, 16, 2, 96), (1, 1337, 8, 1, 256),
                (3, 333, 6, 1, 64), (1, 70, 8, 8, 128), (2, 190, 12, 2, 256)]


@pytest.mark.parametrize("B,S,H,K,dh", CAUSAL_EDGES)
def test_causal_prefill_bf16_edges_match_plain_and_b4_equals_b3(cuda, B, S,
                                                                H, K, dh):
    """B3 and B4 in bf16 against the plain version (on the card), and B4
    against B3 bit for bit."""
    from repro_torch.kernels.flash_prefill.ref import flash_prefill_ref
    rng = np.random.RandomState(S + dh)
    q, k, v = (_t(rng.randn(B, S, n, dh) * 0.3, "bfloat16", cuda)
               for n in (H, K, K))
    b3 = flash_prefill(q, k, v)
    b4 = flash_prefill(q, k, v, triangular=True)
    ref = flash_prefill_ref(q, k, v)
    torch.cuda.synchronize()
    assert torch.equal(b3, b4)
    np.testing.assert_allclose(b3.float().cpu().numpy(),
                               ref.float().cpu().numpy(), **_tol("bfloat16"))


@pytest.fixture(scope="module")
def wgmma_probe():
    """tests/csrc/wgmma_probe.cu built with the kernels' flags into the
    kernels' build directory; its C entry point."""
    import ctypes
    import subprocess
    from pathlib import Path
    from repro_torch.kernels import _build
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the probe builds and runs only "
                    "there")
    src = Path(__file__).resolve().parent / "csrc" / "wgmma_probe.cu"
    out = _build.BUILD_DIR / "wgmma_probe.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.HEADERS), "-o", str(out), str(src)],
                   check=True, capture_output=True)
    fn = ctypes.CDLL(str(out)).wgmma_probe_launch
    fn.argtypes = [ctypes.c_void_p] * 10
    fn.restype = ctypes.c_int
    return fn


@pytest.mark.parametrize("seed", range(8))
def test_wgmma_gives_mma_sync_bits(cuda, wgmma_probe, seed):
    """Hopper's warpgroup product (wgmma.m64nNk16, A from registers, B from
    shared memory) against mma.sync.m16n8k16, through the causal kernel's
    own functions: S = Q.K^T into a zeroed accumulator, and C + P.V with P
    as bf16 hi + lo into a nonzero f32 C, on random operands.  The kernel
    may run a product on wgmma only where both give the same f32 bits.
    Both sides are also held against a float64 product (rtol 1e-3), so a
    fault of layout would show as such."""
    rng = np.random.RandomState(seed)
    q, k, v = (_t(rng.randn(64, 128) * 0.5, "bfloat16", cuda)
               for _ in range(3))
    p = 2.0 ** (-rng.rand(64, 64) * 12) * (rng.rand(64, 64) > 0.2)
    p = torch.from_numpy(p.astype(np.float32)).to(cuda)
    c = rng.randn(64, 128) * 10.0 ** rng.uniform(-3, 1, (64, 128))
    c = torch.from_numpy(c.astype(np.float32)).to(cuda)
    outs = [torch.empty(64, n, device=cuda) for n in (64, 64, 128, 128)]
    rc = wgmma_probe(*(t.data_ptr() for t in (q, k, v, p, c, *outs)),
                     torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    s_mma, s_wg, o_mma, o_wg = outs
    hi = p.bfloat16()
    lo = (p - hi.float()).bfloat16()
    s_ref = q.double() @ k.double().T
    o_ref = c.double() + (hi.double() + lo.double()) @ v.double()
    for got, ref in ((s_mma, s_ref), (s_wg, s_ref), (o_mma, o_ref),
                     (o_wg, o_ref)):
        assert (got.double() - ref).abs().max() <= 1e-3 * ref.abs().max()
    for a, b in ((s_mma, s_wg), (o_mma, o_wg)):
        n = int((a != b).sum())
        assert n == 0, (f"{n} of {a.numel()} f32 results differ, max "
                        f"{(a - b).abs().max().item():.3e}")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,V", [(4, 33, 151936), (3, 5, 1000),
                                   (2, 1, 4097)])
def test_gumbel_argmax_kernel_matches_plain(cuda, B, T, V, dtype):
    rng = np.random.RandomState(4)
    logits = _t(rng.randn(B, T, V) * 2.0, dtype, cuda)
    pos = torch.from_numpy(rng.randint(0, 513, (B, T))).to(cuda)
    greedy = torch.tensor([b % 2 == 0 for b in range(B)], device=cuda)
    temp = torch.tensor([0.7, 1.3, 0.5, 1.0][:B], device=cuda)
    seed = torch.tensor([0, 2**32 - 1, 7, 1][:B], device=cuda)
    rows = seed[:, None].expand(B, T).reshape(-1)
    bits, g = gumbel_noise(rows, pos.reshape(-1), V)
    key = gref.fold_in(gref.random_key(rows), pos.reshape(-1).long())
    assert torch.equal(bits, gref.random_bits32(key, V))
    ref_g = gref.gumbel(key, V)
    assert (g - ref_g).abs().max().item() <= 2e-6
    n0 = gumbel_argmax.launches
    got = gumbel_argmax(logits, pos, temp, seed, greedy)
    torch.cuda.synchronize()
    assert gumbel_argmax.launches == n0 + 1
    plain = gref.gumbel_argmax_ref(logits, pos, temp, seed, greedy)
    z = logits.float() / temp.clamp_min(1e-6)[:, None, None]
    top2 = (z + ref_g.view(B, T, V)).topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1] > 1e-5) | greedy[:, None]
    assert torch.equal(got[clear], plain[clear])
    assert torch.count_nonzero(got[greedy]) == 0


def test_gumbel_argmax_refuses_what_it_does_not_take(cuda):
    logits = torch.zeros(2, 3, 10, device=cuda)
    pos = torch.zeros(2, 3, dtype=torch.int32, device=cuda)
    lane = (torch.ones(2, device=cuda), torch.zeros(2, dtype=torch.int64,
                                                    device=cuda),
            torch.zeros(2, dtype=torch.bool, device=cuda))
    with pytest.raises(ValueError, match="dtype"):
        gumbel_argmax(logits.half(), pos, *lane)
    with pytest.raises(ValueError, match="pred_positions"):
        gumbel_argmax(logits, pos[:, :2], *lane)
    with pytest.raises(ValueError, match="temp"):
        gumbel_argmax(logits, pos, lane[0].cpu(), *lane[1:])


# (F, V, D, N, L): tests/test_kernels.py:66-67's (V, D, N, L) on plain
# tables (F = 0), Wide & Deep's deep and wide bags on stacked tables at a
# cut row count, and D = 1
EB_SHAPES = [(0, 100, 128, 16, 4), (0, 500, 256, 8, 7), (0, 64, 128, 32, 3),
             (0, 1000, 128, 4, 1), (0, 300, 1, 64, 4), (40, 1000, 32, 512, 4),
             (40, 1000, 1, 512, 4), (3, 50, 8, 64, 4)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("F,V,D,N,L", EB_SHAPES)
def test_embedding_bag_kernel_matches_plain(cuda, F, V, D, N, L, dtype):
    """Masked slots, weights, and (on the small stacked table) negative and
    out-of-range ids: NaN bags where the plain version has them."""
    rng = np.random.RandomState(F + V + D)
    shape = (F, V, D) if F else (V, D)
    t = _t(rng.randn(*shape), dtype, cuda)
    ids_shape = (N, F, L) if F else (N, L)
    lo, hi = (-V - 4, V + 4) if F == 3 else (0, V)
    ids = torch.from_numpy(rng.randint(lo, hi, ids_shape)).to(cuda)
    m = torch.from_numpy(rng.rand(*ids_shape) > 0.3).to(cuda)
    w = torch.from_numpy(rng.rand(*ids_shape).astype(np.float32)).to(cuda)
    n0 = embedding_bag_fused.launches
    out = embedding_bag_fused(t, ids, m, w)
    torch.cuda.synchronize()
    assert embedding_bag_fused.launches == n0 + 1
    ref = embedding_bag_ref(t, ids, w * m)
    if F == 3:
        assert torch.isnan(ref).any()
    _assert_same_bits(out, ref)


def _assert_same_bits(out, ref):
    """Equal bits, NaN in the same places (any NaN payload)."""
    assert out.dtype == ref.dtype and out.shape == ref.shape
    nan = torch.isnan(out)
    assert torch.equal(nan, torch.isnan(ref))
    ints = torch.int32 if out.dtype == torch.float32 else torch.int16
    assert torch.equal(out.masked_fill(nan, 0).view(ints),
                       ref.masked_fill(nan, 0).view(ints))


# (dtype, F, V, D, N, L, inputs): the kernel's paths — 16-byte slices (D a
# multiple of 4 f32 / 8 bf16) and the scalar slice (D = 1, 3, 33), bags of
# 4 read as vectors and other L in chunks of 8 rows (9 crosses a chunk),
# mask and weights given or not, 40 stacked tables, bag counts that are
# not a multiple of the bags a warp takes, tables walked a tile of fields
# at a time (4 MB fields: tiles of 4, the last one ragged; 16 MB fields:
# one field a tile); "special" puts negative weights
# under masked slots (-0.0), Inf and NaN rows under zero weights, and
# negative and out-of-range ids in one batch
EB_CASES = [("float32", 0, 97, 1, 37, 4, "both"),
            ("float32", 0, 97, 3, 37, 4, "mask"),
            ("float32", 0, 97, 8, 37, 3, "weights"),
            ("float32", 0, 97, 32, 37, 4, "neither"),
            ("float32", 0, 97, 33, 37, 7, "both"),
            ("float32", 0, 97, 256, 13, 9, "both"),
            ("bfloat16", 0, 97, 8, 37, 4, "both"),
            ("float32", 0, 97, 32, 37, 1, "mask"),
            ("float32", 0, 97, 32, 37, 7, "weights"),
            ("float32", 0, 97, 32, 37, 9, "both"),
            ("float32", 0, 97, 1, 37, 9, "mask"),
            ("float32", 40, 61, 32, 29, 4, "mask"),
            ("float32", 40, 61, 1, 29, 4, "mask"),
            ("bfloat16", 40, 61, 32, 29, 4, "both"),
            ("float32", 3, 50, 8, 33, 4, "special"),
            ("bfloat16", 3, 50, 1, 33, 4, "special"),
            ("float32", 6, 1 << 20, 1, 100, 4, "both"),
            ("float32", 3, 1 << 18, 16, 50, 7, "mask")]


@pytest.mark.parametrize("dtype,F,V,D,N,L,inputs", EB_CASES)
def test_embedding_bag_kernel_cases_equal_plain_bitwise(cuda, dtype, F, V, D,
                                                        N, L, inputs):
    rng = np.random.RandomState(V + D + N + L)
    shape = (F, V, D) if F else (V, D)
    table = rng.randn(*shape).astype(np.float32)
    ids_shape = (N, F, L) if F else (N, L)
    ids = rng.randint(0, V, ids_shape)
    m = rng.rand(*ids_shape) > 0.3
    w = rng.randn(*ids_shape).astype(np.float32)
    if inputs == "special":
        ids = rng.randint(-V - 3, V + 3, ids_shape)
        table[:, 5], table[:, 7, 0] = np.inf, np.nan
        ids[:8, :, 0] = 5                   # an Inf row under weight 0
        ids[8:16, :, 1] = 7                 # a NaN element under weight 0
        m[:16, :, :2] = False
        w[:16, :, :2] = -np.abs(w[:16, :, :2])  # -w * 0 = -0.0
    t = _t(table, dtype, cuda)
    ids_t = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    m_t = torch.from_numpy(m).to(cuda)
    w_t = torch.from_numpy(w).to(cuda)
    mask = m_t if inputs in ("mask", "both", "special") else None
    weights = w_t if inputs in ("weights", "both", "special") else None
    n0 = embedding_bag_fused.launches
    out = embedding_bag_fused(t, ids_t, mask, weights)
    torch.cuda.synchronize()
    assert embedding_bag_fused.launches == n0 + 1
    w_ref = torch.ones_like(w_t)
    if weights is not None:
        w_ref = w_ref * w_t
    if mask is not None:
        w_ref = w_ref * m_t.float()
    ref = embedding_bag_ref(t, ids_t, w_ref)
    if inputs == "special":
        assert torch.isnan(ref).any() and not torch.isnan(ref).all()
    _assert_same_bits(out, ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_embedding_bag_misaligned_table_takes_the_scalar_slice(cuda, dtype):
    """A table view whose data pointer is not 16-byte aligned (a storage
    offset of one element) is taken, through the scalar slice, with the
    plain version's bits."""
    rng = np.random.RandomState(5)
    V, D, N, L = 64, 32, 37, 4
    flat = _t(rng.randn(V * D + 1), dtype, cuda)
    t = flat[1:].view(V, D)
    assert t.data_ptr() % 16 and t.is_contiguous()
    ids = torch.from_numpy(rng.randint(-V, V, (N, L))).to(cuda)
    m = torch.from_numpy(rng.rand(N, L) > 0.3).to(cuda)
    n0 = embedding_bag_fused.launches
    out = embedding_bag_fused(t, ids, m)
    torch.cuda.synchronize()
    assert embedding_bag_fused.launches == n0 + 1
    _assert_same_bits(out, embedding_bag_ref(t, ids, m.float()))


def test_embedding_bag_refuses_mask_or_weights_of_another_shape(cuda):
    t = torch.zeros(10, 4, device=cuda)
    ids = torch.zeros(3, 2, dtype=torch.int32, device=cuda)
    ones = torch.ones(3, 2, dtype=torch.bool, device=cuda)
    for bad in (ones[:, :1], ones[0], ones[None]):
        with pytest.raises(ValueError, match="ids' shape"):
            embedding_bag_fused(t, ids, bad)
        with pytest.raises(ValueError, match="ids' shape"):
            embedding_bag_fused(t, ids, ones, bad.float())
    assert embedding_bag_fused(t, ids, ones, ones.float()).shape == (3, 4)


def test_embedding_bag_mask_of_another_dtype_folds_into_the_weights(cuda):
    """A mask that is neither bool nor uint8 is folded into the weights by
    the wrapper: the same bits as the bool mask, in one launch."""
    rng = np.random.RandomState(9)
    t = _t(rng.randn(40, 8), "float32", cuda)
    ids = torch.from_numpy(rng.randint(0, 40, (21, 4))).to(cuda)
    m = torch.from_numpy(rng.rand(21, 4) > 0.3).to(cuda)
    w = torch.from_numpy(rng.randn(21, 4).astype(np.float32)).to(cuda)
    want = embedding_bag_fused(t, ids, m, w)
    n0 = embedding_bag_fused.launches
    for mask in (m.float(), m.to(torch.int64)):
        _assert_same_bits(embedding_bag_fused(t, ids, mask, w), want)
    assert embedding_bag_fused.launches == n0 + 2


def test_embedding_bag_refuses_what_it_does_not_take(cuda):
    t = torch.zeros(10, 4, device=cuda)
    ids = torch.zeros(3, 2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        embedding_bag_fused(t.half(), ids)
    with pytest.raises(ValueError, match="ids on cpu"):
        embedding_bag_fused(t, ids.cpu())
    with pytest.raises(ValueError, match="need"):
        embedding_bag_fused(t, ids[0])                 # ids without L
    with pytest.raises(ValueError, match="need"):
        embedding_bag_fused(t.view(2, 5, 4), ids[:, None].expand(3, 3, 2))
    with pytest.raises(ValueError, match="contiguous"):
        embedding_bag_fused(torch.zeros(4, 10, device=cuda).t(), ids)


# ------------------------------------------------------------ CUDA graphs
# The session's members captured as CUDA graphs against the eager twin
# (make_session_fns(cuda_graphs=False)) on a small bf16 model: the same
# inputs must give the same bits, call after call (a key's first call runs
# eagerly, its second captures, later ones replay).  Whole caches are
# compared, the paged NULL block excepted (duplicate garbage writes land
# there in any order).
GRAPH_LANES, GRAPH_S, GRAPH_T, GRAPH_V, GRAPH_BS = 4, 64, 9, 1024, 16


@pytest.fixture(scope="module")
def graph_lm():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: CUDA graphs capture only there")
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import TransformerConfig
    cfg = TransformerConfig(vocab_size=GRAPH_V, d_model=256, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=512,
                            max_seq_len=256, dtype="bfloat16",
                            param_dtype="bfloat16", kv_block_size=GRAPH_BS)
    return cfg, init_params(cfg, seed=3, device="cuda")


def _graph_fns(graph_lm, layout, sampling, graphs):
    from repro_torch.serving.session import make_session_fns
    cfg, params = graph_lm
    return make_session_fns(cfg, params, slots=GRAPH_T,
                            prefill_len=GRAPH_S, sampling=sampling,
                            kv_layout=layout, device="cuda",
                            cuda_graphs=graphs)


def _lane_params(mixed, lanes=None):
    if not mixed:
        return {}
    lp = {"greedy": np.asarray([True, False, True, False]),
          "temp": np.asarray([1.0, 0.7, 1.0, 1.3], np.float32),
          "seed": np.asarray([11, 12, 13, 2**32 - 1], np.uint32)}
    if lanes is not None:
        lp = {k: v[lanes] for k, v in lp.items()}
    return {"lane_params": lp}


def _draft(rng, cache_lens):
    """A random draft tree a lane: tokens, positions (length + depth), the
    ancestor-closure mask, parents; lane 3 idle (n_live 0)."""
    B, T = len(cache_lens), GRAPH_T
    tok = rng.randint(2, GRAPH_V, (B, T)).astype(np.int32)
    mask = np.zeros((B, T, T), bool)
    parent = np.full((B, T), -1, np.int32)
    for b in range(B):
        for i in range(1, T):
            parent[b, i] = rng.randint(0, i)
        for i in range(T):
            j = i
            while j >= 0:
                mask[b, i, j] = True
                j = parent[b, j]
    pos = (cache_lens[:, None] + mask.sum(-1) - 1).astype(np.int32)
    n_live = np.asarray([T, T, 5, 0], np.int32)
    return tok, pos, mask, parent, n_live


def _snap(out, label, cache, *xs):
    state = {k: v.clone() for k, v in cache.items()}
    if "block_tables" in cache:
        state = {k: (v[:, 1:] if k in ("k", "v") else v)
                 for k, v in state.items()}
    out.append((label, state, [x.clone() for x in xs]))


def _member_script(fns, paged, mixed):
    """Every member three or more times on inputs from a numpy seed;
    returns (label, cache, outputs) after each call."""
    rng = np.random.RandomState(0)
    B, S = GRAPH_LANES, GRAPH_S
    out, kw = [], _lane_params(mixed)
    toks = rng.randint(2, GRAPH_V, (B, S)).astype(np.int32)
    lens = rng.randint(S // 2, S + 1, (B,)).astype(np.int32)
    bpl = 256 // GRAPH_BS
    tables = (1 + rng.permutation(B * bpl)).reshape(B, bpl).astype(np.int32)
    for i in range(3):
        args = (toks, lens, tables) if paged else (toks, lens)
        cache, chosen = fns.prefill(*args, **kw)
        _snap(out, f"prefill {i}", cache, chosen)
    cache_lens = lens.copy()
    for i in range(3):
        cache, packed = fns.fused_step(cache, cache_lens,
                                       *_draft(rng, cache_lens), **kw)
        _snap(out, f"fused_step {i}", cache, packed)
        cache_lens = cache_lens + packed[:, 0].cpu().numpy().astype(np.int32)
    for i in range(3):
        tok, pos, mask, _, _ = _draft(rng, cache_lens)
        cache, chosen = fns.tree_step(cache, cache_lens, tok, pos, mask, **kw)
        _snap(out, f"tree_step {i}", cache, chosen)
        gather = np.tile(np.arange(GRAPH_T, dtype=np.int32), (B, 1))
        n_acc = np.asarray([1, 3, 2, 0], np.int32)
        cache, new_lens = fns.commit(cache, cache_lens, gather, n_acc)
        _snap(out, f"commit {i}", cache, new_lens)
        cache_lens = new_lens.cpu().numpy().astype(np.int32)
    for lane in (0, 1, 2, 3, 0):
        cache, chosen = fns.prefill_into_slot(
            cache, lane, toks[lane:lane + 1], lens[lane:lane + 1],
            **_lane_params(mixed, slice(lane, lane + 1)))
        _snap(out, f"prefill_into_slot {lane}", cache, chosen)
    if paged:
        for n in (5, 5, 5, 12, 12, 12):          # buckets 8 and 16
            cache, chosen = fns.prefill_suffix(
                cache, 1, toks[1:2, 20:20 + n], 20,
                **_lane_params(mixed, slice(1, 2)))
            _snap(out, f"prefill_suffix {n}", cache, chosen)
        for src, dst in ((3, 60), (4, 61), (5, 62)):
            cache = fns.copy_block(cache, src, dst)
            _snap(out, f"copy_block {src}", cache)
        for first in (60, 61, 62):
            ids = np.zeros((bpl,), np.int32)
            ids[:2] = (first, first - 30)
            cache = fns.reset_blocks(cache, ids)
            _snap(out, f"reset_blocks {first}", cache)
    else:
        for lane in (0, 2, 3):
            cache = fns.reset_slot(cache, lane)
            _snap(out, f"reset_slot {lane}", cache)
    torch.cuda.synchronize()
    return out


def _same_bits(got, want):
    assert [g[0] for g in got] == [w[0] for w in want]
    for (label, gc, gx), (_, wc, wx) in zip(got, want):
        for k in wc:
            assert torch.equal(gc[k], wc[k]), f"{label}: cache {k}"
        for i, (a, b) in enumerate(zip(gx, wx)):
            assert torch.equal(a, b), f"{label}: output {i}"


@pytest.mark.parametrize("sampling", ["greedy", "mixed"])
@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_captured_members_equal_eager_bitwise(graph_lm, layout, sampling):
    paged, mixed = layout == "paged", sampling == "mixed"
    fns = _graph_fns(graph_lm, layout, sampling, True)
    got = _member_script(fns, paged, mixed)
    want = _member_script(_graph_fns(graph_lm, layout, sampling, False),
                          paged, mixed)
    _same_bits(got, want)
    names = ["prefill", "fused_step", "tree_step", "commit",
             "prefill_into_slot"]
    names += ["copy_block", "reset_blocks"] if paged else ["reset_slot"]
    for n in names:
        assert getattr(fns, n)._n_graphs() >= 1, n
    if paged:
        assert fns.prefill_suffix.member._n_graphs() == 2   # two buckets
    assert fns.fused_step._cache_size() == 1
    assert not fns.init_cache._graphs


def test_two_interleaved_caches_on_one_fns(graph_lm):
    """Two live caches on one session, stepped in turn: each key captures
    its own graph, and each cache gets the eager twin's bits."""
    runs = []
    for graphs in (True, False):
        fns = _graph_fns(graph_lm, "dense", "mixed", graphs)
        rng = np.random.RandomState(1)
        out, caches = [], []
        for _ in range(2):
            toks = rng.randint(2, GRAPH_V, (GRAPH_LANES, GRAPH_S)).astype(
                np.int32)
            lens = rng.randint(20, GRAPH_S, (GRAPH_LANES,)).astype(np.int32)
            cache, _ = fns.prefill(toks, lens, **_lane_params(True))
            caches.append([cache, lens])
        for i in range(4):
            for j, entry in enumerate(caches):
                cache, lens = entry
                cache, packed = fns.fused_step(cache, lens, *_draft(rng, lens),
                                               **_lane_params(True))
                _snap(out, f"cache {j} step {i}", cache, packed)
                entry[1] = lens + packed[:, 0].cpu().numpy().astype(np.int32)
        if graphs:
            assert fns.fused_step._n_graphs() == 2
            assert caches[0][0]["k"].data_ptr() != caches[1][0]["k"].data_ptr()
        runs.append(out)
    _same_bits(*runs)


def test_block_table_edit_reaches_the_next_replay(graph_lm):
    """The scheduler replaces cache["block_tables"] when a table changes;
    a replay must read the new table (lane 0's blocks moved to free
    ones between replays)."""
    runs = []
    for graphs in (True, False):
        fns = _graph_fns(graph_lm, "paged", "greedy", graphs)
        rng = np.random.RandomState(2)
        bpl = 256 // GRAPH_BS
        tables = np.arange(1, 1 + GRAPH_LANES * bpl, dtype=np.int32).reshape(
            GRAPH_LANES, bpl)
        toks = rng.randint(2, GRAPH_V, (GRAPH_LANES, GRAPH_S)).astype(np.int32)
        lens = np.full((GRAPH_LANES,), 40, np.int32)
        cache, _ = fns.prefill(toks, lens, tables)
        out = []
        for i in range(5):
            if i == 3:                   # lane 0's first 4 blocks move
                tables = tables.copy()
                tables[0, :4] = tables[3, 12:16]
                cache["block_tables"] = torch.from_numpy(tables).cuda()
            cache, packed = fns.fused_step(cache, lens, *_draft(rng, lens))
            _snap(out, f"step {i}", cache, packed)
        runs.append(out)
    _same_bits(*runs)


def test_counters_after_replays_equal_captured_launches(graph_lm):
    from repro_torch import kernels
    cfg, _ = graph_lm
    fns = _graph_fns(graph_lm, "dense", "mixed", True)
    rng = np.random.RandomState(4)
    toks = rng.randint(2, GRAPH_V, (GRAPH_LANES, GRAPH_S)).astype(np.int32)
    lens = np.full((GRAPH_LANES,), 30, np.int32)
    cache, _ = fns.prefill(toks, lens, **_lane_params(True))
    before = kernels.snapshot()
    n = 6
    for _ in range(n):
        cache, _ = fns.fused_step(cache, lens, *_draft(rng, lens),
                                  **_lane_params(True))
    torch.cuda.synchronize()
    ran = kernels.diff(kernels.snapshot(), before)
    assert ran == {"tree_attention": n * cfg.n_layers, "gumbel_argmax": n}
    from repro_torch.serving.session import _Graph
    (g,) = [g for _, g in fns.fused_step._graphs.values()
            if isinstance(g, _Graph)]
    assert g.launches == {"tree_attention": cfg.n_layers, "gumbel_argmax": 1}
    assert fns.fused_step.captures and fns.fused_step.captures[0][1] >= 0


def _graph_steps(fns, seed):
    """A cohort prefill and four fused steps on a fresh cache (the second
    step captures); returns the cache."""
    rng = np.random.RandomState(seed)
    toks = rng.randint(2, GRAPH_V, (GRAPH_LANES, GRAPH_S)).astype(np.int32)
    lens = np.full((GRAPH_LANES,), 30, np.int32)
    cache, _ = fns.prefill(toks, lens)
    for _ in range(4):
        cache, _ = fns.fused_step(cache, lens, *_draft(rng, lens))
    torch.cuda.synchronize()
    return cache


def test_graph_frees_a_dropped_cache_without_the_cycle_collector(graph_lm):
    """With the cycle collector off, a cache that the caller drops is freed
    although a graph was captured on it, and the member's next call drops
    that graph's key."""
    fns = _graph_fns(graph_lm, "dense", "greedy", True)
    gc.collect()
    gc.disable()
    try:
        cache = _graph_steps(fns, 6)
        assert fns.fused_step._n_graphs() == 1
        k = weakref.ref(cache["k"])
        held = torch.cuda.memory_allocated()
        nbytes = sum(t.numel() * t.element_size() for t in cache.values())
        del cache
        assert k() is None
        assert held - torch.cuda.memory_allocated() >= nbytes
        _graph_steps(fns, 7)
        assert fns.fused_step._n_graphs() == 1
    finally:
        gc.enable()


def _captured_session(graph_lm, layout):
    """A mixed session on ``layout`` that has captured a graph on a cache
    and still holds it; returns the session."""
    fns = _graph_fns(graph_lm, layout, "mixed", True)
    if layout == "dense":
        cache = _graph_steps(fns, 8)
        assert fns.fused_step._n_graphs() == 1
    else:
        toks = np.ones((GRAPH_LANES, GRAPH_S), np.int32)
        lens = np.full((GRAPH_LANES,), 30, np.int32)
        tables = np.arange(1, 1 + GRAPH_LANES * 16, dtype=np.int32).reshape(
            GRAPH_LANES, 16)
        cache, _ = fns.prefill(toks, lens, tables)
        fns.prefill(toks, lens, cache["block_tables"])
        assert fns.prefill._n_graphs() == 1
    del cache
    torch.cuda.synchronize()
    return fns


def test_dropped_session_frees_its_graphs_without_the_cycle_collector(
        graph_lm):
    """With the cycle collector off, dropping a captured session and its
    caches gives back every byte it allocated (cuBLAS's per-stream
    workspaces aside, cleared on both sides; one session of each layout
    runs first, for what torch and the kernels set up once a process),
    and emptying the cache hands its graphs' pools back to the card."""
    for layout in ("dense", "paged"):
        _captured_session(graph_lm, layout)
    gc.collect()
    gc.disable()
    try:
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        for layout in ("dense", "paged", "dense", "paged"):
            fns = _captured_session(graph_lm, layout)
            assert torch.cuda.memory_allocated() > base
            del fns
            torch._C._cuda_clearCublasWorkspaces()
            assert torch.cuda.memory_allocated() == base, layout
            torch.cuda.empty_cache()
            assert torch.cuda.memory_reserved() <= reserved, layout
    finally:
        gc.enable()


def test_capture_out_of_memory_empties_the_cache_and_captures_again(cuda):
    """The allocator cannot give its cached free blocks back to the card
    while a capture is under way: a member whose capture needs memory
    that only the cache holds empties the cache and captures once more,
    then replays."""
    from repro_torch.serving.session import _Member
    n = 2 << 30

    def body(cache, x):
        big = torch.empty(n, dtype=torch.uint8, device=x.device)
        big.fill_(1)
        return x + big[:4].int()

    def stage(x):
        return None, (torch.from_numpy(np.asarray(x, np.int32)),)

    def hog():
        """Leave under 1 GiB free on the card, the rest in the cache."""
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info()
        t = torch.empty(free - (1 << 30), dtype=torch.uint8, device=cuda)
        del t
        assert torch.cuda.mem_get_info()[0] < n

    m = _Member("big", body, stage, put=lambda t: t.cuda(),
                stream=torch.cuda.Stream())
    try:
        assert m(np.arange(4)).tolist() == [1, 2, 3, 4]       # eager
        hog()
        assert m(np.arange(4) + 1).tolist() == [2, 3, 4, 5]   # captures
        assert m._n_graphs() == 1
        hog()
        assert m(np.arange(4) + 2).tolist() == [3, 4, 5, 6]   # replays
    finally:
        del m
        torch.cuda.empty_cache()


def test_b4_persistent_launch_captured_and_replayed_equals_eager(cuda):
    """B4's persistent grid zeroes its work counter with cudaMemsetAsync on
    the stream: captured, the memset replays with the launch, so two
    replays both give the eager bits."""
    rng = np.random.RandomState(5)
    q, k, v = (_t(rng.randn(1, 4096, n, 128) * 0.3, "bfloat16", cuda)
               for n in (12, 2, 2))
    eager = flash_prefill(q, k, v, triangular=True)
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        out = flash_prefill(q, k, v, triangular=True)
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager)


def test_member_that_syncs_raises_at_capture(cuda):
    """A body that makes the host wait cannot be captured: the member
    raises on the capturing call and every one after it, and never runs
    it eagerly on the card again."""
    from repro_torch.serving.session import _Member
    ran = []

    def body(cache, x):
        ran.append(torch.cuda.is_current_stream_capturing())
        return x * int(x.sum().item())

    def stage(x):
        return None, (torch.from_numpy(np.asarray(x, np.int32)),)

    m = _Member("syncs", body, stage, put=lambda t: t.cuda(),
                stream=torch.cuda.Stream())
    assert m(np.ones(4)).sum().item() == 16
    for _ in range(2):
        with pytest.raises(RuntimeError, match="cannot be captured"):
            m(np.ones(4))
    assert ran == [False, True, True]    # eager once, then captures only
    assert torch.ones(3, device=cuda).sum().item() == 3


def _scrubbed_paged_cache(graph_lm):
    """A paged session's cohort cache on the card with three calls of
    ``reset_blocks`` on it — eager, captured, replayed — and the blocks
    they scrubbed after nonzero KV rows had been written into them."""
    fns = _graph_fns(graph_lm, "paged", "greedy", True)
    rng = np.random.RandomState(5)
    B, S, bpl = GRAPH_LANES, GRAPH_S, 256 // GRAPH_BS
    toks = rng.randint(2, GRAPH_V, (B, S)).astype(np.int32)
    lens = np.full((B,), S, np.int32)
    tables = (1 + np.arange(B * bpl)).reshape(B, bpl).astype(np.int32)
    cache, _ = fns.prefill(toks, lens, tables)
    scrubbed = []
    for first in (10, 20, 30):
        ids = np.zeros((bpl,), np.int32)
        ids[:3] = (first, first + 1, first + 2)
        for name in ("k", "v"):
            cache[name][:, ids[:3]] = 0.5
        cache = fns.reset_blocks(cache, ids)
        scrubbed.extend(ids[:3].tolist())
    assert fns.reset_blocks._n_graphs() == 1     # the last two replayed
    return fns, cache, scrubbed


def test_device_poison_probe_sees_captured_scrub_and_planted_write(
        graph_lm):
    """The sanitizer's probe reads the paged KV cache on the card after
    the captured reset_blocks replays that scrubbed its blocks: clean, it
    passes; a write into one of them afterwards raises."""
    from repro_torch.analysis.sanitizer import (InvariantViolation,
                                                ShadowLedger)
    _, cache, scrubbed = _scrubbed_paged_cache(graph_lm)
    ledger = ShadowLedger()
    ledger.on_scrubbed(scrubbed)
    ledger.check_poison(cache)
    assert ledger.probed_blocks == len(scrubbed) == 9
    cache["v"][1, scrubbed[4], 3] = 1
    with pytest.raises(InvariantViolation,
                       match=f"block {scrubbed[4]} has nonzero 'v'"):
        ledger.check_poison(cache)


def test_device_poison_probe_makes_one_pull_a_check(graph_lm):
    """One check over more blocks than one gather chunk makes exactly one
    synchronizing call (its pull), where the reference pulls each block
    and leaf."""
    import warnings

    from repro_torch.analysis.sanitizer import PROBE_CHUNK, ShadowLedger
    _, cache, _ = _scrubbed_paged_cache(graph_lm)
    blocks = list(range(cache["k"].shape[1]))
    assert len(blocks) > PROBE_CHUNK
    for name in ("k", "v"):
        cache[name][:, blocks] = 0
    ledger = ShadowLedger()
    ledger.on_scrubbed(blocks)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            ledger.check_poison(cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    assert len(syncs) == 1, [str(w.message) for w in caught]
    assert ledger.probes == 1 and ledger.probed_blocks == len(blocks)


def test_subprocess_replica_builds_on_the_card(cuda):
    """A spawned replica whose builder leaves the device at None builds
    its engine on the card inside the child (its own CUDA context and
    graphs) and gives the in-process replica's tokens; closing it ends
    the child."""
    import functools

    from repro_torch.core import DraftPolicy, SamplingParams
    from repro_torch.fleet import EngineReplica
    from torch_fleet_tiny import CARD_CFG, build_tiny
    rng = np.random.RandomState(0)
    reqs = [(rng.randint(1, CARD_CFG.vocab_size, size=12).tolist(),
             SamplingParams(max_new_tokens=6, draft=DraftPolicy(
                 namespace=ns).validate())) for ns in ("a", "b", "a")]
    builder = functools.partial(build_tiny, None, CARD_CFG)
    inproc = EngineReplica(builder, replica_id="a")
    rids = [inproc.submit(p, sp) for p, sp in reqs]
    inproc.drain()
    ref = [inproc.result(r)["tokens"] for r in rids]
    sub = EngineReplica(builder, replica_id="b", mode="subprocess")
    proc = sub._proc
    try:
        rids = [sub.submit(p, sp) for p, sp in reqs]
        sub.drain()
        assert [sub.result(r)["tokens"] for r in rids] == ref
    finally:
        sub.close()
    assert not proc.is_alive() and sub.exitcode == 0


# ----------------------------------------------------------------- MoE FFN
def test_moe_ref_on_the_card_matches_the_cpu(cuda):
    """``moe_ref``, and ``moe_local`` at a capacity factor of E / top_k
    (nothing dropped), in f32 with TF32 off on the card against the same
    calls on the CPU: the same routing, outputs within atol 1e-5, rtol
    1e-4 (f32 products of 256 and 128 terms summed in another order;
    outputs ~1e-2)."""
    from repro_torch.models import moe
    rng = np.random.RandomState(0)
    N, d, E, F, k = 132, 256, 16, 128, 4
    cpu = [torch.from_numpy((rng.randn(*shape) * s).astype(np.float32))
           for shape, s in (((N, d), 1.0), ((d, E), 0.1), ((E, d, F), 0.05),
                            ((E, d, F), 0.05), ((E, F, d), 0.05))]
    card = [t.to(cuda) for t in cpu]
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _, idx_cpu = moe.router_topk(cpu[0], cpu[1], k)
        _, idx_card = moe.router_topk(card[0], card[1], k)
        assert torch.equal(idx_card.cpu(), idx_cpu)
        for fn in (lambda *a: moe.moe_ref(*a, k),
                   lambda *a: moe.moe_local(*a, k, E / k)):
            torch.testing.assert_close(fn(*card).cpu(), fn(*cpu),
                                       atol=1e-5, rtol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_init_params_draws_experts_a_layer_at_a_time(cuda):
    """The (L, E, ...) expert tensors are drawn one layer at a time: the
    draw's peak exceeds the weights by one layer's f32 scratch (64 MiB
    here), not the whole tensor's (256 MiB), and every layer gets its own
    numbers."""
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import TransformerConfig
    L, d, E, F = 4, 1024, 16, 1024
    cfg = TransformerConfig(n_layers=L, d_model=d, n_heads=8, n_kv_heads=8,
                            d_ff=0, vocab_size=256, moe=True, n_experts=E,
                            top_k=2, moe_d_ff=F, dtype="bfloat16",
                            param_dtype="bfloat16")
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, seed=0, device=cuda)
    torch.cuda.synchronize()
    leaves = [*params["layers"].values(),
              *(v for key, v in params.items() if key != "layers")]
    assert sum(t.numel() for t in leaves) == cfg.n_params()
    weights = sum(t.numel() * t.element_size() for t in leaves)
    over = torch.cuda.max_memory_allocated() - base - weights
    layer_f32 = E * d * F * 4
    # 1 MiB for the allocator's rounding of each block to 512 bytes
    assert over <= layer_f32 + (1 << 20), (over, layer_f32)
    for name in ("we_gate", "we_up", "we_down"):
        w = params["layers"][name]
        assert all(not torch.equal(w[i], w[i + 1]) for i in range(L - 1))
        assert abs(w.float().std().item() - 0.02) < 0.002


# ---------------------------------------------------------------- training
def _guarded_calls(dev):
    """Each kernel's wrapper on small card inputs: name -> (call, inputs
    that may require grad)."""
    rng = np.random.RandomState(0)
    q = _t(rng.randn(1, 3, 4, 16) * 0.3, "float32", dev)
    k = _t(rng.randn(1, 40, 2, 16) * 0.3, "float32", dev)
    v = _t(rng.randn(1, 40, 2, 16) * 0.3, "float32", dev)
    mask = torch.ones((1, 3, 40), dtype=torch.bool, device=dev)
    pk = _t(rng.randn(1, 64, 2, 16) * 0.3, "float32", dev)
    logits = _t(rng.randn(1, 3, 512), "float32", dev)
    lane = (torch.zeros((1, 3), dtype=torch.int32, device=dev),
            torch.ones(1, device=dev), torch.zeros(1, dtype=torch.int64,
                                                   device=dev),
            torch.zeros(1, dtype=torch.bool, device=dev))
    return {
        "tree_attention": (lambda a, b, c: tree_attention(a, b, c, mask),
                           (q, k, v)),
        "flash_prefill": (flash_prefill, (pk, pk.clone(), pk.clone())),
        "flash_prefill_tri": (
            lambda a, b, c: flash_prefill(a, b, c, triangular=True),
            (pk, pk.clone(), pk.clone())),
        "gumbel_argmax": (lambda x: gumbel_argmax(x, *lane), (logits,)),
    }


@pytest.mark.parametrize("kernel", ["tree_attention", "flash_prefill",
                                    "flash_prefill_tri", "gumbel_argmax"])
def test_kernels_refuse_inputs_that_require_grad(cuda, kernel):
    """No kernel has a backward: an input that requires grad raises, naming
    the kernel and where a gradient comes from, instead of returning an
    output without one; under no_grad, or without such inputs, it
    launches."""
    fn, ins = _guarded_calls(cuda)[kernel]
    name = "flash_prefill" if kernel.startswith("flash") else kernel
    for i in range(len(ins)):
        live = [t.clone().requires_grad_(j == i) for j, t in enumerate(ins)]
        with pytest.raises(RuntimeError, match=f"{name}: an input requires "
                                               "grad.*no backward"):
            fn(*live)
        with torch.no_grad():
            fn(*live)
    fn(*ins)
    torch.cuda.synchronize()


def test_lm_loss_through_the_cuda_prefill_raises_naming_b3(cuda):
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.models import transformer as ttx
    from repro_torch.models.params import init_params
    cfg = qwen2_1_5b.smoke_config()
    assert cfg.prefill_backend == "cuda"
    params = init_params(cfg, seed=0, device=cuda)
    params["embed"].requires_grad_(True)
    toks = torch.randint(0, cfg.vocab_size, (2, 32), device=cuda)
    with pytest.raises(RuntimeError, match="flash_prefill.*prefill_backend="
                                           "'dense'"):
        ttx.lm_loss(cfg, params, toks, toks)


def test_embedding_bag_backward_on_the_card_matches_the_cpu(cuda):
    """B5's autograd.Function: the kernel's forward and the plain backward
    on the card against the CPU's (plain forward), f32, with wrapped and
    out-of-range ids, weights and a mask.  The forward bit for bit; the
    table gradient is summed by atomics in no fixed order and the weights'
    over D in another order: atol 1e-6, rtol 1e-5, NaN in the same
    places."""
    rng = np.random.RandomState(3)
    F, V, D, N, L = 4, 300, 32, 512, 4
    table = torch.from_numpy(rng.randn(F, V, D).astype(np.float32) * 0.1)
    ids = rng.randint(0, V, (N, F, L)).astype(np.int32)
    ids.flat[::7] -= V
    ids.flat[3::29] = V + 5
    ids = torch.from_numpy(ids)
    mask = torch.from_numpy(rng.rand(N, F, L) > 0.25)
    w = torch.from_numpy(rng.randn(N, F, L).astype(np.float32))
    g = torch.from_numpy(rng.randn(N, F, D).astype(np.float32))
    res = {}
    for dev in ("cpu", cuda):
        t = table.to(dev).detach().requires_grad_(True)
        ww = w.to(dev).detach().requires_grad_(True)
        n0 = embedding_bag_fused.launches
        out = embedding_bag_fused(t, ids.to(dev), mask.to(dev), ww)
        out.backward(g.to(dev))
        assert embedding_bag_fused.launches == n0 + (dev != "cpu")
        res[str(dev)] = [x.detach().cpu() for x in (out, t.grad, ww.grad)]
    cpu, card = res["cpu"], res[str(cuda)]
    _assert_same_bits(card[0], cpu[0])
    torch.testing.assert_close(card[1], cpu[1], atol=1e-6, rtol=1e-5)
    torch.testing.assert_close(card[2], cpu[2], atol=1e-6, rtol=1e-5,
                               equal_nan=True)


def test_smoke_train_step_on_the_card_matches_the_cpu(cuda):
    """The Qwen2 smoke config in f32 through the dense backend (TF32 off),
    from the same parameters on the card and on the CPU: every gradient
    leaf of lm_loss within 1e-5 of its largest entry (rtol 1e-4); one
    make_train_step step's loss and gradient norm rtol 1e-5 and parameters
    atol lr / 10 (Adam's first update, lr * g / (|g| + eps), is continuous
    in g; a wrong one moves entries by lr / 2 or more)."""
    import dataclasses

    from repro_torch.configs import qwen2_1_5b
    from repro_torch.models import transformer as ttx
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import (adamw_init, tree_leaves,
                                                tree_map)
    from repro_torch.training.train_step import make_train_step
    cfg = dataclasses.replace(qwen2_1_5b.smoke_config(),
                              prefill_backend="dense")
    params = init_params(cfg, seed=0, device="cpu")
    rng = np.random.RandomState(4)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 64))
                                 .astype(np.int32))
             for k in ("tokens", "labels")}
    loss = lambda p, b: ttx.lm_loss(cfg, p, b["tokens"], b["labels"])  # noqa: E731
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = {}
        for dev in ("cpu", cuda):
            p = tree_map(lambda t: t.to(dev), params)
            b = {k: v.to(dev) for k, v in batch.items()}
            live = tree_map(lambda t: t.detach().requires_grad_(True), p)
            grads = torch.autograd.grad(loss(live, b), tree_leaves(live))
            newp, _, m = make_train_step(loss, lr=1e-3)(p, adamw_init(p), b)
            out[str(dev)] = ([g.cpu() for g in grads], m,
                             [t.cpu() for t in tree_leaves(newp)])
        (gc_, mc, pc), (gg, mg, pg) = out["cpu"], out[str(cuda)]
        for a, b in zip(gg, gc_):
            torch.testing.assert_close(a, b, rtol=1e-4,
                                       atol=1e-5 * float(b.abs().max()))
        for key in ("loss", "grad_norm"):
            torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=1e-5,
                                       atol=0)
        for a, b in zip(pg, pc):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


# ------------------------------------------------------------------ the GNN
def _gnn_case(dev, chunk):
    """EquiformerV2's smoke config in f32 on one random geometric graph
    (64 nodes, 256 edge slots) on ``dev``: the forward's outputs, the
    node-class loss and its gradient leaves, on the CPU."""
    from repro_torch.configs import equiformer_v2 as ecfg
    from repro_torch.models.gnn import equiformer as eq
    from repro_torch.training import data
    from repro_torch.training.optimizer import tree_leaves, tree_map
    cfg = dataclasses.replace(ecfg.smoke_config(), edge_chunk=chunk)
    rng = np.random.RandomState(0)
    g = data.random_geometric_graph(rng, 64, cfg.d_feat_in, cutoff=0.6,
                                    max_edges=256)
    g["labels"] = rng.randint(-1, cfg.n_out, 64).astype(np.int32)
    p = tree_map(lambda t: t.to(dev).requires_grad_(True),
                 eq.init_params(cfg, seed=0, device="cpu"))
    b = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
    out = eq.forward(cfg, p, b["node_feat"], b["positions"], b["edges"],
                     b["edge_mask"])
    loss = eq.node_class_loss(cfg, p, b)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return ([out[k].detach().cpu() for k in sorted(out)], loss.detach().cpu(),
            [x.cpu() for x in grads])


def _gnn_close(got, want):
    """f32 sums in another order (index_add_ adds with atomics on the
    card): rtol 1e-4, atol 1e-5 of each output's largest |value| and of
    the whole gradient's."""
    for a, b in zip(got[0] + [got[1]], want[0] + [want[1]]):
        torch.testing.assert_close(a, b, rtol=1e-4,
                                   atol=1e-5 * float(b.abs().max()))
    scale = max(float(b.abs().max()) for b in want[2])
    for a, b in zip(got[2], want[2]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale)


def test_gnn_on_the_card_matches_the_cpu(cuda):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _gnn_close(_gnn_case(cuda, 0), _gnn_case("cpu", 0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def test_gnn_chunked_equals_dense_on_the_card(cuda):
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        _gnn_close(_gnn_case(cuda, 64), _gnn_case(cuda, 0))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
