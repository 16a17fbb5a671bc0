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
products in l order from 0 and round once.
"""
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
