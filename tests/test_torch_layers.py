"""Op parity of the PyTorch port's layers (repro_torch.models.layers)
against the JAX reference (repro.models.layers), at f32 on the CPU.

Inputs are made with numpy from a seed and handed to both frameworks.
Tolerance: atol=1e-5 (f32; the two frameworks sum in different orders).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro_torch.models import layers as tl

pytestmark = pytest.mark.torch_port

TOL = dict(atol=1e-5, rtol=1e-5)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TOL))


def test_rms_norm():
    rng = _rng(0)
    x = rng.randn(2, 5, 64).astype(np.float32) * 3
    s = rng.rand(64).astype(np.float32) + 0.5
    _close(tl.rms_norm(torch.from_numpy(x), torch.from_numpy(s), 1e-6),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(s), 1e-6))


@pytest.mark.parametrize("theta", [10000.0, 1_000_000.0])
def test_rope(theta):
    rng = _rng(1)
    pos = rng.randint(0, 500, size=(2, 7)).astype(np.int32)
    x = rng.randn(2, 7, 4, 16).astype(np.float32)
    tc, ts = tl.rope_angles(torch.from_numpy(pos), 16, theta)
    jc, js = jl.rope_angles(jnp.asarray(pos), 16, theta)
    _close(tc, jc, atol=1e-4, rtol=1e-5)    # cos/sin of angles up to ~500
    _close(ts, js, atol=1e-4, rtol=1e-5)
    _close(tl.apply_rope(torch.from_numpy(x), torch.from_numpy(np.array(jc)),
                         torch.from_numpy(np.array(js))),
           jl.apply_rope(jnp.asarray(x), jc, js))


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_acts(name):
    x = _rng(2).randn(3, 50).astype(np.float32) * 4
    _close(tl.ACTS[name](torch.from_numpy(x)), jl.ACTS[name](jnp.asarray(x)))


def test_causal_prefill_mask():
    rng = _rng(3)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    lm = rng.rand(2, 9) > 0.3
    np.testing.assert_array_equal(
        tl.causal_prefill_mask(torch.from_numpy(pos),
                               torch.from_numpy(lm)).numpy(),
        np.asarray(jl.causal_prefill_mask(jnp.asarray(pos),
                                          jnp.asarray(lm))))


@pytest.mark.parametrize("H,K", [(4, 2), (4, 4), (6, 1)])
def test_gqa_attention(H, K):
    rng = _rng(4)
    B, T, S, dh = 2, 5, 24, 16
    q = rng.randn(B, T, H, dh).astype(np.float32)
    k = rng.randn(B, S, K, dh).astype(np.float32)
    v = rng.randn(B, S, K, dh).astype(np.float32)
    mask = rng.rand(B, T, S) > 0.5
    mask[:, :, 0] = True
    _close(tl.gqa_attention(*map(torch.from_numpy, (q, k, v, mask))),
           jl.gqa_attention(*map(jnp.asarray, (q, k, v, mask))))


def test_swiglu():
    rng = _rng(5)
    x = rng.randn(2, 3, 32).astype(np.float32)
    wg, wu = (rng.randn(32, 48).astype(np.float32) * 0.2 for _ in range(2))
    wd = rng.randn(48, 32).astype(np.float32) * 0.2
    for name in ("silu", "gelu"):
        _close(tl.swiglu(*map(torch.from_numpy, (x, wg, wu, wd)),
                         tl.ACTS[name]),
               jl.swiglu(*map(jnp.asarray, (x, wg, wu, wd)), jl.ACTS[name]))
