"""Sampled and mixed-sampling serving of the port on the CPU, and the
triangular-schedule prefill's plain version, against the JAX package.

  * losslessness (I1) inside the port: requests mixing greedy and sampled
    params (distinct temperatures and seeds) served through ``build_engine``
    equal the port's ``reference_decode`` — on the dense and the paged
    layout and with the prefix cache — and so does ``reference_decode`` at
    the serving batch shape (``lanes=``) and the lock-step loop;
  * parity across frameworks: the same weights (JAX ``init_params`` through
    ``params_from_jax``), unguided at temperature 0.8, give the JAX engine's
    tokens (the Gumbel values agree to 2e-6, so a token could only differ
    on a near tie, which these draws do not meet);
  * the session and API surface: ``make_session_fns(sample=True)``,
    ``EngineConfig(default_params=SamplingParams(sample=True))``,
    ``engine.submit(..., sample=True)``, ``sampling="greedy"`` (no Gumbel
    draw, sampled requests refused) and the legacy ``base_key``;
  * one-lane admission padded to the lane count gives the B = 1 result;
  * the plain version of the triangular-schedule prefill kernel against
    the JAX op ``flash_prefill(..., triangular=True)`` in Pallas interpret
    mode at the shapes of tests/test_kernels.py (f32 atol 3e-5, rtol 1e-4;
    bf16 atol = rtol = 2e-2, as ``_tol`` there);
  * the serve CLI's sampling flags on the CPU.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.request import Request as JRequest
from repro.core.request import SamplingParams as JSamplingParams
from repro.kernels.flash_prefill.ops import flash_prefill as j_flash_prefill
from repro.models import transformer as jtx
from repro.serving import api as japi
from repro_torch.core import LookaheadEngine, reference_decode
from repro_torch.core.request import Request, SamplingParams
from repro_torch.kernels.flash_prefill.ops import flash_prefill
from repro_torch.models import transformer as ttx
from repro_torch.models.params import params_from_jax
from repro_torch.serving import api as tapi
from repro_torch.serving import sampler as tsampler
from repro_torch.serving.session import make_session_fns

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
PREFILL = 32
ECFG = dict(lanes=2, prefill_len=PREFILL, decoding_length=8,
            branch_length=4)
_JCFG = jtx.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                              n_kv_heads=1, d_ff=64, vocab_size=61,
                              max_seq_len=160, qkv_bias=True)
_TCFG = ttx.TransformerConfig(**dataclasses.asdict(_JCFG))
_JP = jtx.init_params(_JCFG, jax.random.key(5))
_TP = params_from_jax(_TCFG, jax.tree.map(np.asarray, _JP), "cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models gain nothing from intra-op threads, and the suite runs
    several test processes side by side: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _workload(n, seed, all_sampled=False):
    """Prompts and params, greedy and sampled in turn (or all sampled at
    0.8), each sampled request with its own seed."""
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(2, _JCFG.vocab_size,
                           size=rng.randint(6, 28)).tolist()
               for _ in range(n)]
    params = [SamplingParams(max_new_tokens=16, sample=True,
                             temperature=0.8 if all_sampled
                             else (0.6, 1.0, 1.4)[i % 3],
                             seed=int(rng.randint(0, 2**32, dtype=np.uint64)))
              if all_sampled or i % 2 else SamplingParams(max_new_tokens=16)
              for i in range(n)]
    return prompts, params


def _serve(engine, prompts, params):
    handles = [engine.submit(Request(prompt=list(p), params=sp))
               for p, sp in zip(prompts, params)]
    engine.run()
    return [h.result().tokens for h in handles]


@pytest.mark.parametrize("layout,prefix", [("dense", False),
                                           ("paged", False),
                                           ("paged", True)])
def test_mixed_serving_equals_reference_decode(layout, prefix):
    prompts, params = _workload(6, seed=1)
    if prefix:        # a shared head, so later requests hit the cache
        prompts = [prompts[0][:12] + p[:14] for p in prompts]
    ecfg = tapi.EngineConfig(**ECFG, kv_layout=layout, block_size=8,
                             prefix_cache=prefix)
    eng = tapi.build_engine(ecfg, _TCFG, _TP, device="cpu")
    outs = _serve(eng, prompts, params)
    st = eng.stats
    assert st.decode_syncs == st.decode_steps
    assert eng.fns.fused_step._cache_size() == 1
    if prefix:
        assert st.prefix_hits > 0
    for p, sp, o in zip(prompts, params, outs):
        assert len(o) == sp.max_new_tokens
        assert o == reference_decode(eng.fns, p, params=sp)
        assert o == reference_decode(eng.fns, p, params=sp, lanes=2)
    # the sampled streams are draws, not the argmax
    greedy = [reference_decode(eng.fns, p, params=dataclasses.replace(
        sp, sample=False)) for p, sp in zip(prompts, params)]
    assert any(o != g for o, g in zip(outs, greedy))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_sampled_serving_matches_jax_engine(layout):
    prompts, params = _workload(5, seed=2, all_sampled=True)
    params[1] = SamplingParams(max_new_tokens=16)        # one greedy lane
    ecfg = dict(ECFG, kv_layout=layout, block_size=8)
    t_eng = tapi.build_engine(tapi.EngineConfig(**ecfg), _TCFG, _TP,
                              device="cpu")
    j_eng = japi.build_engine(japi.EngineConfig(**ecfg), _JCFG, _JP)
    outs = _serve(t_eng, prompts, params)
    handles = [j_eng.submit(JRequest(prompt=list(p), params=JSamplingParams(
        max_new_tokens=sp.max_new_tokens, sample=sp.sample,
        temperature=sp.temperature, seed=sp.seed)))
        for p, sp in zip(prompts, params)]
    j_eng.run()
    assert outs == [[int(t) for t in h.result().tokens] for h in handles]


def test_lockstep_sampled_equals_reference_decode():
    prompts, params = _workload(3, seed=3)
    fns = make_session_fns(_TCFG, _TP, slots=9, prefill_len=PREFILL,
                           device="cpu")
    lock = LookaheadEngine(fns, tapi.EngineConfig(**ECFG).lookahead())
    outs = lock.generate_batch_lockstep(prompts, params=params)
    for p, sp, o in zip(prompts, params, outs):
        assert o.tokens == reference_decode(fns, p, params=sp)


def test_session_sampling_defaults_and_greedy_mode(monkeypatch):
    calls = []
    real = tsampler.gumbel_argmax
    monkeypatch.setattr(tsampler, "gumbel_argmax",
                        lambda *a: calls.append(1) or real(*a))
    prompt = [3, 9, 4, 7, 11]
    fns = make_session_fns(_TCFG, _TP, sample=True, temperature=0.7,
                           seed=42, slots=9, prefill_len=PREFILL,
                           device="cpu")
    d = fns.default_params
    assert (d.sample, d.temperature, d.seed) == (True, 0.7, 42)
    assert fns.sampling == "mixed"
    sampled = reference_decode(fns, prompt, 12)
    assert sampled == reference_decode(fns, prompt, params=SamplingParams(
        max_new_tokens=12, sample=True, temperature=0.7, seed=42))
    assert calls
    # the deprecated base_key: a JAX key's raw words, XORed into the seed
    words = np.asarray([0x12345678, 0x9ABCDEF0], np.uint32)
    keyed = make_session_fns(_TCFG, _TP, sample=True, base_key=words,
                             slots=9, prefill_len=PREFILL, device="cpu")
    assert keyed.default_params.seed == 0x12345678 ^ 0x9ABCDEF0
    # an argmax-only session draws no noise and refuses sampled requests
    calls.clear()
    greedy = make_session_fns(_TCFG, _TP, sampling="greedy", slots=9,
                              prefill_len=PREFILL, device="cpu")
    assert greedy.sampling == "greedy"
    argmax = reference_decode(greedy, prompt, 12)
    assert not calls
    assert argmax == reference_decode(fns, prompt, params=SamplingParams(
        max_new_tokens=12))
    eng = tapi.ServingEngine(greedy, tapi.EngineConfig(**ECFG,
                                                       sampling="greedy"))
    with pytest.raises(ValueError, match="sampling='greedy'"):
        eng.submit(prompt, sample=True, temperature=0.7)
    with pytest.raises(ValueError, match="sampling='greedy'"):
        make_session_fns(_TCFG, _TP, sample=True, sampling="greedy",
                         device="cpu")
    with pytest.raises(ValueError, match="sampling="):
        make_session_fns(_TCFG, _TP, sampling="nucleus", device="cpu")


def test_engine_sampled_defaults_and_submit_overrides():
    ecfg = tapi.EngineConfig(**ECFG, default_params=SamplingParams(
        max_new_tokens=10, sample=True, temperature=0.9, seed=5))
    eng = tapi.build_engine(ecfg, _TCFG, _TP, device="cpu")
    prompt = [5, 6, 7, 8]
    a = eng.submit(prompt)
    b = eng.submit(prompt, sample=True, temperature=0.7, seed=6)
    c = eng.submit(prompt, sample=False)
    eng.run()
    assert a.result().tokens == reference_decode(eng.fns, prompt,
                                                 params=ecfg.default_params)
    assert b.result().tokens == reference_decode(
        eng.fns, prompt, params=dataclasses.replace(
            ecfg.default_params, temperature=0.7, seed=6))
    assert c.result().tokens == reference_decode(
        eng.fns, prompt, params=SamplingParams(max_new_tokens=10))


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_padded_admission_equals_one_row(layout):
    """prefill_into_slot's batch padded to the lane count writes only its
    lane and gives the B = 1 logits."""
    cfg = dataclasses.replace(_TCFG, kv_layout=layout, kv_block_size=8)
    rng = np.random.RandomState(6)
    tok = torch.from_numpy(rng.randint(2, 61, (1, PREFILL))).int()
    lens = torch.tensor([20], dtype=torch.int32)
    padded = torch.zeros((3, PREFILL), dtype=torch.int32)
    padded[2] = tok[0]
    plens = torch.tensor([1, 1, 20], dtype=torch.int32)

    def fresh():
        if layout == "dense":
            return ttx.init_cache(cfg, 3)
        cache = ttx.init_paged_cache(cfg, 3)
        cache["block_tables"] = torch.arange(
            1, 1 + cache["block_tables"].numel(),
            dtype=torch.int32).reshape(3, -1)
        return cache

    fn = ttx.prefill_into_slot if layout == "dense" \
        else ttx.prefill_into_slot_paged
    c1, l1 = fn(cfg, _TP, fresh(), 2, tok, lens)
    c3, l3 = fn(cfg, _TP, fresh(), 2, padded, plens)
    assert l3.shape == l1.shape == (1, cfg.vocab_size)
    torch.testing.assert_close(l3, l1, atol=1e-5, rtol=1e-5)
    for name in ("k", "v"):
        torch.testing.assert_close(c3[name], c1[name], atol=1e-5, rtol=1e-5)
    empty = fresh()
    if layout == "dense":        # the other lanes stay untouched
        assert torch.equal(c3["k"][:, :2], empty["k"][:, :2])


def _tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,K,dh,blk", [
    (1, 256, 4, 2, 64, 64), (2, 512, 4, 4, 128, 128), (1, 384, 6, 2, 96, 128),
])
def test_triangular_prefill_plain_matches_jax(B, S, H, K, dh, blk, dtype):
    rng = np.random.RandomState(7)
    jd = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    td = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    qkv = [jnp.asarray(rng.randn(B, S, n, dh) * 0.3, jd) for n in (H, K, K)]
    want = j_flash_prefill(*qkv, block_q=blk, block_k=blk, interpret=True,
                           triangular=True)
    got = flash_prefill(*(torch.from_numpy(np.array(x, np.float32)).to(td)
                          for x in qkv), triangular=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


def test_serve_cli_sampling_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
            "--device", "cpu", "--requests", "4", "--max-new", "6"]
    runs = {
        "mixed": ["--mixed-sampling", "--lanes", "2"],
        "features": ["--sample", "--temperature", "0.7", "--lanes", "2",
                     "--mixed", "--cancel-every", "3", "--overlap-drafts",
                     "--draft-sources", "trie,ngram", "--adaptive-draft",
                     "--trie-namespace-key", "tenant", "--lane-shares",
                     "t0=0.5,t1=0.5", "--draft-budget-caps", "t0=4",
                     "--autotune", "--prefill-backend", "dense",
                     "--decode-backend", "cuda"],
        "lockstep": ["--mode", "lockstep", "--sample", "--lanes", "2"],
    }
    for name, extra in runs.items():
        proc = subprocess.run(base + extra, capture_output=True, text=True,
                              env=env, cwd=str(REPO), timeout=300)
        assert proc.returncode == 0, (name, proc.stderr)
        if name == "mixed":
            assert "24 tokens / 4 requests (0 cancelled, 2 sampled" \
                in proc.stdout, proc.stdout
            assert "1.0 sync/step" in proc.stdout
        elif name == "features":
            assert "1 cancelled" in proc.stdout and "tenant t1" \
                in proc.stdout and "autotune [t0]" in proc.stdout, \
                proc.stdout
            assert "step breakdown [overlap]" in proc.stdout
        else:
            assert "lockstep: 24 tokens" in proc.stdout, proc.stdout
