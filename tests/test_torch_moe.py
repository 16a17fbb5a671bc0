"""The port's MoE FFN (repro_torch.models.moe) against the JAX package's
(repro.models.moe), f32 on the CPU, inputs from numpy seeds.

  * ``router_topk``: weights allclose (atol 1e-6, rtol 1e-5: one f32
    product, softmax and division), indices equal;
  * ``_dispatch_local``: ``buf``, ``src``, ``dest`` and ``wflat`` equal
    JAX's exactly at a capacity factor of 1.25 that drops rows (the
    dispatch only sorts, counts, copies and selects);
  * ``moe_ref`` and ``moe_local`` (capacity factors 1.25 and 8.0)
    allclose to JAX's, and ``moe_local`` at 8.0 (nothing dropped) to
    ``moe_ref``: atol 2e-6, rtol 1e-5 (f32 products and sums in another
    order; outputs are ~1e-3);
  * ``_ffn`` with a shared expert, every ``moe_impl`` the port takes,
    against the JAX ``_ffn``: the same tolerance;
  * a mirror of ``tests/test_lossless.py::test_lossless_moe`` with its own
    config (E 4, top-2, one shared expert, ``moe_impl="ref"``): Lookahead
    equals the port's ``reference_decode`` and the JAX engine's tokens on
    the same weights.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import LookaheadConfig as JLookaheadConfig
from repro.core import LookaheadEngine as JLookaheadEngine
from repro.models import moe as jmoe
from repro.models import transformer as jtx
from repro.serving.session import make_session_fns as j_make_session_fns
from repro_torch.core import LookaheadConfig, LookaheadEngine, reference_decode
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttx
from repro_torch.models.params import params_from_jax
from repro_torch.serving.session import make_session_fns

pytestmark = pytest.mark.torch_port

MOE_TOL = dict(atol=2e-6, rtol=1e-5)
N, D, E, F, K = 48, 32, 8, 16, 2


def _weights(seed, n=N, d=D, e=E, f=F, skew=0.0):
    """x (n, d), router (d, e), expert weights (e, d, f) / (e, f, d); a
    ``skew`` on the router's first column routes most rows to expert 0."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d).astype(np.float32)
    router = (rng.randn(d, e) * 0.3).astype(np.float32)
    router[:, 0] += skew * np.sign(x.mean(0))
    wg = (rng.randn(e, d, f) * 0.2).astype(np.float32)
    wu = (rng.randn(e, d, f) * 0.2).astype(np.float32)
    wd = (rng.randn(e, f, d) * 0.2).astype(np.float32)
    return x, router, wg, wu, wd


def _both(arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


def _close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or MOE_TOL))


@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_router_topk_matches_jax(top_k):
    x, router, *_ = _weights(0)
    (jx, jr), (tx_, tr) = _both((x, router))
    jw, jidx = jmoe.router_topk(jx, jr, top_k)
    tw, tidx = tmoe.router_topk(tx_, tr, top_k)
    assert tidx.dtype == torch.int64 and tw.dtype == torch.float32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    _close(tw, jw, atol=1e-6, rtol=1e-5)


def test_dispatch_local_equals_jax_where_rows_drop():
    x, router, *_ = _weights(1, skew=3.0)
    (jx, jr), (tx_, tr) = _both((x, router))
    jw, jidx = jmoe.router_topk(jx, jr, K)
    # the same routing into both dispatches: JAX's, as numpy
    w, idx = np.array(jw), np.array(jidx)
    C = 12          # moe_local's capacity for n 48, k 2, E 8 at 1.25
    j_out = jmoe._dispatch_local(jx, jnp.asarray(w), jnp.asarray(idx), E, C)
    t_out = tmoe._dispatch_local(tx_, torch.from_numpy(w),
                                 torch.from_numpy(idx).long(), E, C)
    for name, t, j in zip(("buf", "src", "dest", "wflat"), t_out, j_out):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=name)
    dropped = int((t_out[2] == E * C).sum())
    assert dropped > 0, "the skewed router drops no row at capacity 12"


def test_moe_ref_matches_jax():
    arrays = _weights(2)
    j_in, t_in = _both(arrays)
    _close(tmoe.moe_ref(*t_in, K), jmoe.moe_ref(*j_in, K))


@pytest.mark.parametrize("cf", [1.25, 8.0])
def test_moe_local_matches_jax(cf):
    arrays = _weights(3, skew=3.0 if cf < 2 else 0.0)
    j_in, t_in = _both(arrays)
    _close(tmoe.moe_local(*t_in, K, cf), jmoe.moe_local(*j_in, K, cf))


def test_moe_local_without_drops_equals_moe_ref():
    """At a capacity factor of E / top_k or more no row is dropped."""
    t_in = _both(_weights(4))[1]
    _close(tmoe.moe_local(*t_in, K, 8.0), tmoe.moe_ref(*t_in, K))


def _moe_config(**kw):
    return jtx.TransformerConfig(
        n_layers=1, d_model=D, n_heads=4, n_kv_heads=2, d_ff=0,
        vocab_size=61, moe=True, n_experts=E, top_k=K, moe_d_ff=F,
        n_shared_experts=1, **kw)


@pytest.mark.parametrize("impl", ["auto", "ref", "local"])
def test_ffn_with_shared_expert_matches_jax(impl):
    jcfg = _moe_config(moe_impl=impl, capacity_factor=8.0)
    tcfg = ttx.TransformerConfig(**dataclasses.asdict(jcfg))
    jp = jtx.init_params(jcfg, jax.random.key(5))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    assert {"ws_gate", "ws_up", "ws_down"} <= set(tp["layers"])
    h = np.random.RandomState(6).randn(3, 5, D).astype(np.float32)
    j_lp = {k: v[0] for k, v in jp["layers"].items()}
    t_lp = ttx._layer_params(tcfg, tp, 0)
    _close(ttx._ffn(tcfg, t_lp, torch.from_numpy(h)),
           jtx._ffn(jcfg, j_lp, jnp.asarray(h)))


# ---------------------------------------------------------------- lossless
def _prompts(n, lo=8, hi=40, vocab=66, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


@pytest.fixture(scope="module")
def moe_fns():
    """The reference's lossless MoE config: 2 layers, d_model 48, E 4,
    top-2, one shared expert, ``moe_ref``; both frameworks' session
    functions on the same weights, 17 slots."""
    jcfg = jtx.TransformerConfig(n_layers=2, d_model=48, n_heads=4,
                                 n_kv_heads=4, vocab_size=67,
                                 max_seq_len=320, moe=True, n_experts=4,
                                 top_k=2, moe_d_ff=32, n_shared_experts=1,
                                 moe_impl="ref")
    tcfg = ttx.TransformerConfig(**dataclasses.asdict(jcfg))
    jp = jtx.init_params(jcfg, jax.random.key(1))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return (make_session_fns(tcfg, tp, slots=17, device="cpu"),
            j_make_session_fns(jcfg, jp, slots=17))


def test_lossless_moe_matches_reference_and_jax(moe_fns):
    t_fns, j_fns = moe_fns
    for prompt in _prompts(3, seed=4):
        ref = reference_decode(t_fns, prompt, 32)
        eng = LookaheadEngine(t_fns, LookaheadConfig(decoding_length=12,
                                                     branch_length=5))
        j_eng = JLookaheadEngine(j_fns, JLookaheadConfig(decoding_length=12,
                                                         branch_length=5))
        eng.warmup([ref])
        j_eng.warmup([ref])
        out = eng.generate(prompt, 32)
        assert out.tokens == ref
        assert out.stats.steps < len(ref)          # the drafts verified
        assert [int(t) for t in j_eng.generate(prompt, 32).tokens] == ref
