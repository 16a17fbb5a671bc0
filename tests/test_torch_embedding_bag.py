"""The port's fused EmbeddingBag module (``repro_torch.kernels.embedding_bag``,
kernel B5) against the JAX package's on the CPU.

On CPU tensors ``embedding_bag_fused`` takes its plain PyTorch version; these
tests hold it against the JAX wrapper in Pallas interpret mode and the JAX
oracle ``embedding_bag_ref`` on the shapes of tests/test_kernels.py, at
D = 1 (Wide & Deep's wide tables), on stacked per-field tables (one launch
for every field on the card, the reference's vmap over fields here) and on
the id semantics of ``jnp.take`` that the reference's model path and oracle
use: an id in [-V, 0) wraps, an id at or past V or below -V gives a NaN row,
NaN under a zero weight too.  Tolerance: f32 atol=3e-5, rtol=1e-4 (f32 sums
in another order); bf16 atol=rtol=2e-2 (as ``_tol`` in tests/test_kernels.py:
both round an f32 sum to bf16 once, so at most an output ulp apart).  The
CUDA kernel is held against this plain version on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag.ops import embedding_bag_fused as j_fused
from repro.kernels.embedding_bag.ref import embedding_bag_ref as j_ref
from repro_torch.kernels.embedding_bag.ops import (embedding_bag_fused,
                                                   embedding_bag_ref,
                                                   take_rows)

pytestmark = pytest.mark.torch_port

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SWEEP = [(100, 128, 16, 4), (500, 256, 8, 7), (64, 128, 32, 3),
         (1000, 128, 4, 1)]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


def _table(rng, shape, dtype):
    """The same table in both frameworks: numpy f32 -> JAX at ``dtype``,
    and the JAX array's exact values -> torch at ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(rng.randn(*shape), jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("V,D,N,L", SWEEP + [(300, 1, 64, 4), (50, 1, 5, 2)])
def test_plain_matches_jax_kernel_and_oracle(V, D, N, L, dtype):
    rng = np.random.RandomState(V + D + N + L)
    jt, tt = _table(rng, (V, D), dtype)
    ids = rng.randint(0, V, (N, L)).astype(np.int32)
    m = rng.rand(N, L) > 0.3
    w = rng.rand(N, L).astype(np.float32)
    n0 = embedding_bag_fused.launches
    out = embedding_bag_fused(tt, torch.from_numpy(ids), torch.from_numpy(m),
                              torch.from_numpy(w))
    assert embedding_bag_fused.launches == n0       # CPU: the plain version
    assert out.dtype == tt.dtype and out.shape == (N, D)
    jk = j_fused(jt, jnp.asarray(ids), jnp.asarray(m), jnp.asarray(w),
                 interpret=True)
    jr = j_ref(jt, jnp.asarray(ids), jnp.asarray(w * m))
    np.testing.assert_allclose(_np(out), _np(jk), **_tol(dtype))
    np.testing.assert_allclose(_np(out), _np(jr), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("F,V,D,B,L", [(6, 64, 8, 5, 3), (40, 50, 32, 3, 4),
                                       (40, 50, 1, 3, 4)])
def test_stacked_tables_bag_each_field_in_its_own_table(F, V, D, B, L, dtype):
    """A stacked (F, V, D) table with ids (B, F, L): field f's bags read
    table[f] — the reference's vmap of the oracle over the field axis."""
    rng = np.random.RandomState(F * V + D)
    jt, tt = _table(rng, (F, V, D), dtype)
    ids = rng.randint(0, V, (B, F, L)).astype(np.int32)
    m = rng.rand(B, F, L) > 0.25
    w = rng.rand(B, F, L).astype(np.float32)
    out = embedding_bag_fused(tt, torch.from_numpy(ids), torch.from_numpy(m),
                              torch.from_numpy(w))
    assert out.shape == (B, F, D)
    bag = jax.vmap(lambda t, i, ww: j_ref(t, i, ww), in_axes=(0, 1, 1),
                   out_axes=1)
    want = bag(jt, jnp.asarray(ids), jnp.asarray(w * m))
    np.testing.assert_allclose(_np(out), _np(want), **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_id_semantics_follow_jnp_take(dtype):
    """Negative ids in [-V, 0) wrap; ids >= V or < -V give a NaN row, which
    stays NaN under a zero weight; bags without such an id are finite."""
    V, D = 20, 4
    rng = np.random.RandomState(7)
    jt, tt = _table(rng, (V, D), dtype)
    ids = np.array([[1, -1, 5], [-20, 19, 0], [20, 2, 3], [4, -21, 6],
                    [7, 8, 25], [-5, -5, 9]], np.int32)
    w = np.ones(ids.shape, np.float32)
    w[2, 0] = 0.0                  # out of range under a zero weight
    w[4] = [0.5, 2.0, 0.0]
    out = embedding_bag_fused(tt, torch.from_numpy(ids),
                              weights=torch.from_numpy(w))
    want = np.asarray(j_ref(jt, jnp.asarray(ids), jnp.asarray(w)),
                      np.float32)
    got = _np(out)
    nan_rows = np.isnan(want).any(-1)
    assert nan_rows.tolist() == [False, False, True, True, True, False]
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got[~nan_rows], want[~nan_rows],
                               **_tol(dtype))
    # row-wise lookups too
    rows = take_rows(tt, torch.from_numpy(ids))
    np.testing.assert_array_equal(
        _np(rows), np.asarray(jnp.take(jt, jnp.asarray(ids), axis=0),
                              np.float32))


def test_stacked_out_of_range_id_never_reads_the_next_field():
    """Id V in field 0 of a stacked table is out of range (NaN), not row 0
    of field 1; id -1 wraps inside its own field."""
    F, V, D = 3, 5, 2
    t = torch.arange(F * V * D, dtype=torch.float32).reshape(F, V, D)
    ids = torch.tensor([[[V], [-1], [0]]], dtype=torch.int32)   # (1, F, 1)
    out = embedding_bag_fused(t, ids)
    assert torch.isnan(out[0, 0]).all()
    assert torch.equal(out[0, 1], t[1, V - 1])
    assert torch.equal(out[0, 2], t[2, 0])


def test_weights_and_mask_fold_into_f32_weights():
    rng = np.random.RandomState(3)
    t = torch.from_numpy(rng.randn(30, 6).astype(np.float32))
    ids = torch.from_numpy(rng.randint(0, 30, (7, 5)))
    m = torch.from_numpy(rng.rand(7, 5) > 0.5)
    w = torch.from_numpy(rng.rand(7, 5)).double()     # any float dtype
    out = embedding_bag_fused(t, ids, m, w)
    ref = embedding_bag_ref(t, ids, (w * m).float())
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    assert torch.equal(embedding_bag_fused(t, ids[:0]), torch.zeros(0, 6))


def _round_bf16(x):
    """float32 -> the nearest bfloat16 (ties to even), as float32 (no NaN)."""
    u = x.view(np.uint32).astype(np.uint64)
    u = ((u + 0x7FFF + ((u >> 16) & 1)) >> 16) << 16
    return u.astype(np.uint32).view(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_sums_in_l_order_bit_for_bit(dtype):
    """The plain version, which the CUDA kernel is held to bit for bit on
    the card, equals a numpy loop that adds each slot's rounded f32 product
    in l order from 0 and rounds once to the table's dtype.  Rows and
    weights span eight decades and some bags cancel, so another order of
    the adds moves bits, in bf16 too."""
    F, V, D, N, L = 3, 40, 8, 50, 9
    rng = np.random.RandomState(11)
    scale = 10.0 ** rng.uniform(-4, 4, (F, V, 1))
    tt = torch.from_numpy((rng.randn(F, V, D) * scale).astype(np.float32)
                          ).to(DTYPES[dtype][1])
    tab = tt.float().numpy()
    ids = rng.randint(-V, V, (N, F, L)).astype(np.int32)  # negatives wrap
    w = (rng.randn(N, F, L) * 10.0 ** rng.uniform(-3, 3, (N, F, L))
         * (rng.rand(N, F, L) > 0.2)).astype(np.float32)
    # cancellation in the first bags: slot 2 takes back slot 0's product,
    # so what is left of slot 1 depends on the order of the adds
    ids[:20, :, 2] = ids[:20, :, 0]
    w[:20, :, :3] = [1e6, 1.0, -1e6]
    want = np.zeros((N, F, D), np.float32)
    for n in range(N):
        for f in range(F):
            for l in range(L):
                want[n, f] = want[n, f] + tab[f, ids[n, f, l] % V] * w[n, f, l]
    if dtype == "bfloat16":
        want = _round_bf16(want)
    got = embedding_bag_fused(tt, torch.from_numpy(ids),
                              weights=torch.from_numpy(w))
    assert got.dtype == tt.dtype
    np.testing.assert_array_equal(got.float().numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("n_win", [2, 16])
@pytest.mark.parametrize("stacked", [False, True])
def test_row_window_sums_to_the_whole_table(n_win, stacked):
    """B5's plain version over a rank's window of rows (``row_start``,
    ``n_rows``; the table its block, as a table split over ``model`` 2 or
    16 is held): the windows' bags sum to the whole table's bag (f32, an
    order of sums apart), an id another window holds adds exactly 0 (a
    window's bag of ids it does not hold is 0, never NaN), the ids at
    each window's edges (``row_start - 1``, ``row_start``, ``row_start +
    V_local - 1``) and ids in [-V, 0) that wrap into another window read
    their rows, an id out of range gives NaN in every window, and the
    backward scatters into the window's rows only: the windows'
    gradients side by side are the whole table's."""
    rng = np.random.RandomState(n_win)
    F, V, D, N, L = (3 if stacked else 1), 64, 4, 10, 4
    Vl = V // n_win
    table = torch.from_numpy(rng.randn(F, V, D).astype(np.float32))
    lead = (N, F) if stacked else (N,)
    ids = rng.randint(0, V, lead + (L,)).astype(np.int32)
    edges = [Vl - 1, Vl, 2 * Vl - 1, V - Vl]
    ids[0, ..., :] = edges
    ids[1, ..., :] = [-1, -Vl - 1, -V, 1]           # wrap into windows
    ids[2, ..., 0] = V + 3                          # out of range: NaN
    ids[3, ..., 1] = -V - 2
    ids = torch.from_numpy(ids)
    mask = torch.from_numpy(rng.rand(*ids.shape) > 0.2)
    mask[0], mask[1] = True, True
    t = table if stacked else table[0]
    g = torch.from_numpy(rng.randn(*ids.shape[:-1], D).astype(np.float32))
    whole = t.clone().requires_grad_(True)
    want = embedding_bag_fused(whole, ids, mask)
    want.backward(g)
    total = torch.zeros_like(want)
    grads = []
    for r in range(n_win):
        block = t[..., r * Vl:(r + 1) * Vl, :].clone().requires_grad_(True)
        part = embedding_bag_fused(block, ids, mask, row_start=r * Vl,
                                   n_rows=V)
        ok = torch.ones(ids.shape[:-1], dtype=torch.bool)
        ok[2], ok[3] = False, False
        assert not part[ok].isnan().any()
        assert part[~ok].isnan().all()
        part.backward(g)
        grads.append(block.grad)
        total = total + part
        held = ((ids.long() % V) // Vl == r)[0]     # row 0's edges
        if not held.any():
            assert torch.equal(part[0], torch.zeros_like(part[0]))
    torch.testing.assert_close(total, want, atol=3e-6, rtol=1e-6,
                               equal_nan=True)
    assert torch.equal(torch.cat(grads, dim=-2), whole.grad)
    rows = take_rows(t[..., Vl:2 * Vl, :], ids, row_start=Vl, n_rows=V)
    full = take_rows(t, ids)
    mine = ((ids.long() % V) // Vl == 1) & (ids >= -V) & (ids < V)
    assert torch.equal(rows[mine], full[mine])
    assert torch.equal(rows[~mine & (ids >= -V) & (ids < V)],
                       torch.zeros_like(rows[~mine & (ids >= -V)
                                             & (ids < V)]))


def test_row_window_out_of_its_table_raises():
    t = torch.zeros(8, 4)
    with pytest.raises(ValueError, match="window"):
        embedding_bag_fused(t, torch.zeros((2, 3), dtype=torch.int32),
                            row_start=9, n_rows=16)
