"""Parity of the port's kernel modules (repro_torch.kernels) against the JAX
package's kernels.

On the CPU a wrapper takes its kernel's plain PyTorch version; these tests
hold that plain version against the JAX wrapper in Pallas interpret mode and
against the JAX oracle, on the small shapes of tests/test_kernels.py.
Tolerance: f32 atol=3e-5, rtol=1e-4; bf16 atol=rtol=2e-2 (as _tol there).
The CUDA kernels themselves are held against these plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_prefill.ops import flash_prefill as j_flash_prefill
from repro.kernels.flash_prefill.ops import flash_prefill_reference as j_fp_ref
from repro.kernels.tree_attention.ops import tree_attention as j_tree
from repro.kernels.tree_attention.ops import \
    tree_attention_reference as j_tree_ref
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.kernels.tree_attention.ops import tree_attention

pytestmark = pytest.mark.torch_port

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
TREE_SHAPES = [(1, 1, 4, 4, 64, 128), (2, 5, 8, 4, 64, 256),
               (1, 9, 4, 1, 96, 512), (2, 65, 12, 2, 128, 1024),
               (1, 33, 16, 16, 128, 384)]
# the shapes of tests/test_kernels.py, and long ragged prompts (S not a
# multiple of the key tile nor of the CUDA kernels' row tiles)
PREFILL_SHAPES = [(2, 256, 4, 2, 64), (1, 512, 8, 8, 96),
                  (2, 256, 6, 2, 128), (1, 128, 2, 1, 80),
                  (1, 1000, 12, 2, 128), (2, 333, 6, 1, 64)]


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


def _pair(x, dtype):
    """The same values in both frameworks: numpy f32 -> JAX at ``dtype``,
    and the JAX array's exact values -> torch at ``dtype``."""
    jd, td = DTYPES[dtype]
    j = jnp.asarray(x, jd)
    return j, torch.from_numpy(np.array(j, np.float32)).to(td)


def _tree_inputs(B, T, H, K, dh, S, dtype, seed=0):
    rng = np.random.RandomState(seed)
    q = _pair(rng.randn(B, T, H, dh) * 0.3, dtype)
    k = _pair(rng.randn(B, S, K, dh) * 0.3, dtype)
    v = _pair(rng.randn(B, S, K, dh) * 0.3, dtype)
    lens = rng.randint(S // 4, S // 2, size=(B,))
    mask = np.zeros((B, T, S), bool)
    for b in range(B):
        mask[b, :, :lens[b]] = True
        mask[b, :, lens[b]:lens[b] + T] = np.tril(np.ones((T, T), bool))
    return q, k, v, (jnp.asarray(mask), torch.from_numpy(mask))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,T,H,K,dh,S", TREE_SHAPES)
def test_tree_attention_plain_matches_jax(B, T, H, K, dh, S, dtype):
    q, k, v, m = _tree_inputs(B, T, H, K, dh, S, dtype)
    out = tree_attention(q[1], k[1], v[1], m[1])        # CPU: plain version
    assert out.dtype == q[1].dtype and out.shape == q[1].shape
    got = out.float().numpy()
    interp = j_tree(q[0], k[0], v[0], m[0], block_s=128, interpret=True)
    oracle = j_tree_ref(q[0], k[0], v[0], m[0])
    for ref in (interp, oracle):
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   **_tol(dtype))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,S,H,K,dh", PREFILL_SHAPES)
def test_flash_prefill_plain_matches_jax(B, S, H, K, dh, dtype):
    rng = np.random.RandomState(1)
    q, k, v = (_pair(rng.randn(B, S, n, dh) * 0.3, dtype)
               for n in (H, K, K))
    out = flash_prefill(q[1], k[1], v[1])
    assert out.dtype == q[1].dtype and out.shape == q[1].shape
    got = out.float().numpy()
    interp = j_flash_prefill(q[0], k[0], v[0], block_q=64, block_k=128,
                             interpret=True)
    oracle = j_fp_ref(q[0], k[0], v[0])
    for ref in (interp, oracle):
        np.testing.assert_allclose(got, np.asarray(ref, np.float32),
                                   **_tol(dtype))


def test_tree_attention_row_without_keys_is_zero():
    """A row that sees no key returns 0, as the JAX kernel does (the dense
    gqa_attention would average V instead)."""
    q, k, v, m = _tree_inputs(1, 3, 4, 2, 16, 40, "float32")
    mask = m[1].clone()
    mask[0, 1] = False
    out = tree_attention(q[1], k[1], v[1], mask)
    assert torch.count_nonzero(out[0, 1]) == 0
    ref = j_tree(q[0], k[0], v[0], jnp.asarray(mask.numpy()), block_s=128,
                 interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **_tol("f32"))


def test_cpu_tensors_take_plain_version_and_do_not_count():
    q, k, v, m = _tree_inputs(1, 2, 4, 2, 16, 32, "float32")
    n0, p0 = tree_attention.launches, flash_prefill.launches
    tree_attention(q[1], k[1], v[1], m[1])
    flash_prefill(k[1], k[1], v[1])
    assert (tree_attention.launches, flash_prefill.launches) == (n0, p0)


def test_wrappers_refuse_non_cuda_devices():
    """Off the CPU the wrappers launch the kernel or raise: no silent
    fallback (a meta tensor stands in for a device the kernel refuses)."""
    q, k, v, m = _tree_inputs(1, 2, 4, 2, 16, 32, "float32")
    meta = [t.to("meta") for t in (q[1], k[1], v[1], m[1])]
    with pytest.raises(ValueError, match="CUDA"):
        tree_attention(*meta)
    with pytest.raises(ValueError, match="CUDA"):
        flash_prefill(meta[1], meta[1], meta[2])


@pytest.mark.parametrize("B,T,S", [(4, 33, 512), (1, 8, 256)])
def test_path_mask_is_a_prefix_plus_an_ancestor_closed_tree(B, T, S):
    """The timing mask of the on-card checks: each lane sees a committed
    prefix of at least 96 keys, each tree row sees itself, and a row that
    sees a tree key sees everything that key's row sees (ancestor-closed),
    with room for 48 new keys after the tree."""
    from repro_torch.kernels.timing import path_mask
    mask = path_mask(B, T, S, seed=1, device="cpu").numpy()
    assert mask.shape == (B, T, S) and mask.dtype == bool
    for b in range(B):
        n = int(mask[b, 0].argmin()) - 1      # row 0 sees the prefix, itself
        assert 96 <= n <= S - T - 48
        assert mask[b, :, :n].all() and not mask[b, :, n + T:].any()
        tree = mask[b, :, n:n + T]
        assert tree.diagonal().all()
        for i in range(T):
            for j in np.flatnonzero(tree[i]):
                assert (tree[j] <= tree[i]).all()
