"""The port's other LMs — AntGLM-10B (the paper's own model), Phi-3-mini,
Phi-3-medium and the MoE LMs Qwen3-MoE-30B-A3B and Moonlight-16B-A3B —
and the paper's baselines (LLMA single branch, step by step), held
against the JAX package on the CPU.

  * configs: ``full_config``/``smoke_config`` equal the reference's field
    for field, and so do ``n_params`` and ``n_active_params``;
    ``get_arch`` refuses the arch still to port, naming its ROADMAP item;
  * model functions at smoke size (and at head width 96 for the MHA
    archs): ``prefill`` and ``tree_step`` logits equal the JAX functions'
    on the same weights (``params_from_jax``), f32, atol 2e-5, rtol 1e-4
    (f32 sums in another order, as ``tests/test_torch_model.py``);
  * serving: the engine's token streams equal the JAX engine's and the
    port's ``reference_decode``, guided and random;
  * baselines: ``llma_config``/``baseline_config`` equal the reference's,
    and ``LookaheadEngine`` under every strategy is lossless and gives the
    JAX engine's tokens (mirrors ``tests/test_lossless.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import antglm_10b as j_antglm
from repro.configs import moonshot_v1_16b_a3b as j_moonlight
from repro.configs import phi3_medium_14b as j_phi3_medium
from repro.configs import phi3_mini_3_8b as j_phi3_mini
from repro.configs import qwen3_moe_30b_a3b as j_qwen3_moe
from repro.core import LookaheadConfig as JLookaheadConfig
from repro.core import LookaheadEngine as JLookaheadEngine
from repro.core import baseline_config as j_baseline
from repro.core import llma_config as j_llma
from repro.models import transformer as jtx
from repro.serving import api as japi
from repro.serving.session import make_session_fns as j_make_session_fns
from repro_torch import core as tcore
from repro_torch.configs import (antglm_10b, get_arch, moonshot_v1_16b_a3b,
                                 phi3_medium_14b, phi3_mini_3_8b,
                                 qwen3_moe_30b_a3b)
from repro_torch.core import LookaheadEngine, reference_decode
from repro_torch.core.request import SamplingParams
from repro_torch.models import transformer as ttx
from repro_torch.models.params import params_from_jax
from repro_torch.serving import api as tapi
from repro_torch.serving.session import make_session_fns

pytestmark = pytest.mark.torch_port

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
ARCHS = {"antglm-10b": (j_antglm, antglm_10b),
         "phi3-mini-3.8b": (j_phi3_mini, phi3_mini_3_8b),
         "phi3-medium-14b": (j_phi3_medium, phi3_medium_14b),
         "qwen3-moe-30b-a3b": (j_qwen3_moe, qwen3_moe_30b_a3b),
         "moonshot-v1-16b-a3b": (j_moonlight, moonshot_v1_16b_a3b)}
# the reference's fields the port sets otherwise: its attention backends
# ("cuda", the kernels)
PORT_FIELDS = {"prefill_backend", "decode_backend"}
ECFG = dict(lanes=2, prefill_len=32, decoding_length=8, branch_length=4)


def _pair(jcfg, seed):
    tcfg = ttx.TransformerConfig(**{**dataclasses.asdict(jcfg),
                                    "prefill_backend": "cuda",
                                    "decode_backend": "cuda"})
    jp = jtx.init_params(jcfg, jax.random.key(seed))
    return tcfg, jp, params_from_jax(tcfg, jax.tree.map(np.asarray, jp),
                                     "cpu")


def _guides(vocab, phase=2, seed=0):
    """The guided bench model's bias (benchmarks/common.py), one numpy
    table handed to both frameworks."""
    rng = np.random.RandomState(seed + 1000 * phase)
    base = rng.randint(2, vocab, size=(vocab,))
    spec = rng.randint(2, vocab, size=(phase, vocab))
    shared = rng.rand(phase, vocab) < 0.7
    table = np.where(shared, base[None, :], spec).astype(np.int32)
    jg, tg = jnp.asarray(table), torch.from_numpy(table).long()

    def j_bias(logits, tokens, positions):
        nxt = jg[positions % phase, tokens]
        return logits + 1e4 * jax.nn.one_hot(nxt, vocab, dtype=logits.dtype)

    def t_bias(logits, tokens, positions):
        nxt = tg[positions.long() % phase, tokens.long()]
        return logits + 1e4 * torch.nn.functional.one_hot(
            nxt, vocab).to(logits.dtype)

    return j_bias, t_bias


def _prompts(n, vocab, seed, lo=6, hi=28):
    rng = np.random.RandomState(seed)
    return [rng.randint(2, vocab, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _serve(engine, prompts, max_new):
    handles = [engine.submit(list(p), max_new_tokens=max_new)
               for p in prompts]
    engine.run()
    return [[int(t) for t in h.result().tokens] for h in handles]


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **LOGIT_TOL)


# ----------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", list(ARCHS))
def test_configs_match_reference(arch):
    j_mod, t_mod = ARCHS[arch]
    assert get_arch(arch) is t_mod and t_mod.ARCH == j_mod.ARCH == arch
    for name in ("full_config", "smoke_config"):
        jcfg, tcfg = getattr(j_mod, name)(), getattr(t_mod, name)()
        for f in dataclasses.fields(jcfg):
            if f.name not in PORT_FIELDS:
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), \
                    (name, f.name)
        assert tcfg.n_params() == jcfg.n_params(), name
        assert tcfg.n_active_params() == jcfg.n_active_params(), name
        assert tcfg.dh == jcfg.dh
    full = t_mod.full_config()
    assert full.adtype == torch.float32 and full.pdtype == torch.float32


@pytest.mark.parametrize("name,item", [("equiformer-v2", "A18")])
def test_get_arch_refuses_unported_archs(name, item):
    with pytest.raises(KeyError, match=f"not yet ported \\(ROADMAP {item}"):
        get_arch(name)


# --------------------------------------------------------- model functions
def _prompt_arrays(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = rng.randint(S // 2, S + 1, size=(B,)).astype(np.int32)
    return toks, lens


def _tree_inputs(cfg, lens, T, seed):
    rng = np.random.RandomState(seed)
    B = len(lens)
    tok = rng.randint(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    parent = [-1] + [int(rng.randint(0, i)) for i in range(1, T)]
    tm = np.zeros((T, T), bool)
    for i in range(T):
        j = i
        while j >= 0:
            tm[i, j] = True
            j = parent[j]
    pos = (lens[:, None] + tm.sum(1)[None] - 1).astype(np.int32)
    return tok, pos, np.broadcast_to(tm, (B, T, T)).copy()


@pytest.mark.parametrize("arch,head_dim", [
    ("antglm-10b", None), ("phi3-mini-3.8b", None),
    ("phi3-medium-14b", None), ("antglm-10b", 96), ("phi3-mini-3.8b", 96),
    ("qwen3-moe-30b-a3b", None), ("moonshot-v1-16b-a3b", None)])
def test_prefill_and_tree_step_logits_match_jax(arch, head_dim):
    """Smoke size; ``head_dim`` 96 (phi3-mini's own width) on the MHA archs
    puts the kernels' plain versions at dh 96 against JAX."""
    jcfg = ARCHS[arch][0].smoke_config()
    if head_dim:
        jcfg = dataclasses.replace(jcfg, head_dim=head_dim)
    tcfg, jp, tp = _pair(jcfg, seed=1)
    toks, lens = _prompt_arrays(jcfg, 3, 24, seed=2)
    jc, jl = jtx.prefill(jcfg, jp, jnp.asarray(toks), jnp.asarray(lens),
                         jtx.init_cache(jcfg, 3))
    tc, tl = ttx.prefill(tcfg, tp, torch.from_numpy(toks),
                         torch.from_numpy(lens), ttx.init_cache(tcfg, 3))
    _close(tl, jl)
    tok, pos, tm = _tree_inputs(jcfg, lens, 9, seed=3)
    jc, jl = jtx.tree_step(jcfg, jp, jc, jnp.asarray(lens), jnp.asarray(tok),
                           jnp.asarray(pos), jnp.asarray(tm))
    tc, tl = ttx.tree_step(tcfg, tp, tc, torch.from_numpy(lens),
                           torch.from_numpy(tok), torch.from_numpy(pos),
                           torch.from_numpy(tm))
    _close(tl, jl)
    # the slots' K/V rows, written at cache_len + slot (rows past each
    # prompt are never attended, I3, and differ by backend)
    for name in ("k", "v"):
        for b, n in enumerate(lens):
            _close(tc[name][:, b, n:n + 9], jc[name][:, b, n:n + 9])


# ------------------------------------------------------------------ serving
@pytest.mark.parametrize("model", ["guided", "random"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_engine_matches_jax_engine_and_reference(arch, model):
    jcfg = ARCHS[arch][0].smoke_config()
    if model == "guided":
        j_bias, t_bias = _guides(jcfg.vocab_size)
    else:
        j_bias = t_bias = None
    prompts = _prompts(4, jcfg.vocab_size, seed=4)
    tcfg, jp, tp = _pair(jcfg, seed=5)
    ecfg = dict(ECFG, default_params=SamplingParams(max_new_tokens=20))
    t_eng = tapi.build_engine(tapi.EngineConfig(**ecfg), tcfg, tp,
                              logits_transform=t_bias, device="cpu")
    j_eng = japi.build_engine(japi.EngineConfig(**ecfg), jcfg, jp,
                              logits_transform=j_bias)
    outs = _serve(t_eng, prompts, 20)
    assert outs == _serve(j_eng, prompts, 20)
    for p, o in zip(prompts, outs):
        assert o == reference_decode(t_eng.fns, p, 20)
    if model == "guided":          # the drafts verified: fewer steps
        st = t_eng.stats
        assert sum(map(len, outs)) > st.decode_steps + len(prompts)


# ---------------------------------------------------------------- baselines
@pytest.mark.parametrize("kw", [
    {}, dict(branch_length=6, decoding_length=8),
    dict(strict_prompt_only=False)])
def test_baseline_configs_match_reference(kw):
    assert tcore.llma_config(**kw).__dict__ == j_llma(**kw).__dict__
    assert tcore.baseline_config().__dict__ == j_baseline().__dict__
    assert tcore.llma_config(**kw).strategy == "single"


@pytest.fixture(scope="module")
def antglm_fns():
    """AntGLM-10B's smoke config (the paper's model) on the reference's
    lossless-test widths: both frameworks' session functions on the same
    weights, 17 slots."""
    jcfg = dataclasses.replace(j_antglm.smoke_config(), max_seq_len=320)
    tcfg, jp, tp = _pair(jcfg, seed=6)
    return (make_session_fns(tcfg, tp, slots=17, device="cpu"),
            j_make_session_fns(jcfg, jp, slots=17))


@pytest.mark.parametrize("strategy", [
    "hierarchical", "parallel", "single", "none", "llma"])
def test_lookahead_strategies_lossless_and_match_jax(antglm_fns, strategy):
    """Mirrors tests/test_lossless.py::test_lossless_greedy_all_strategies
    with step-by-step decoding (``baseline_config``) and LLMA
    (``llma_config``) beside the three tree strategies."""
    t_fns, j_fns = antglm_fns
    if strategy == "none":
        t_la, j_la = tcore.baseline_config(), j_baseline()
    elif strategy == "llma":
        t_la, j_la = (f(branch_length=6) for f in (tcore.llma_config,
                                                   j_llma))
    else:
        t_la, j_la = (c(decoding_length=16, branch_length=6,
                        strategy=strategy)
                      for c in (tcore.LookaheadConfig, JLookaheadConfig))
    rng = np.random.RandomState(3)
    for i in range(3):
        prompt = rng.randint(1, 500, size=rng.randint(8, 40)).tolist()
        ref = reference_decode(t_fns, prompt, 40)
        eng, j_eng = LookaheadEngine(t_fns, t_la), JLookaheadEngine(j_fns,
                                                                    j_la)
        eng.warmup([ref])
        j_eng.warmup([ref])
        out = eng.generate(prompt, 40)
        assert out.tokens == ref, (strategy, i)
        assert out.stats.steps <= len(ref)        # never more steps
        assert [int(t) for t in j_eng.generate(prompt, 40).tokens] == ref
