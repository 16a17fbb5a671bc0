"""The port's serving slice end to end on the CPU (repro_torch.serving).

  * losslessness (I1) inside the port: engine output == the port's
    ``reference_decode``;
  * parity across frameworks: the same weights (JAX ``init_params``
    converted with ``params_from_jax``) give the JAX engine's tokens, on
    the guided bench model (a +1e4 logit bias makes token choice immune to
    framework rounding) and on a tiny random config;
  * the fused hot path: one host sync per decode step, one input shape per
    step function (``_cache_size() == 1``);
  * isolation: importing every ``repro_torch`` module loads no JAX and no
    ``repro``;
  * refusals: CUDA by default (raises without it), and the features later
    slices bring (expert-parallel MoE; the CLI's checkpoint flag) are
    refused, each naming its ROADMAP item;
  * the serve CLI on the CPU, dense and paged with the prefix cache.
"""
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtx
from repro.serving import api as japi
from repro_torch.configs import get_arch
from repro_torch.core import LookaheadEngine, reference_decode
from repro_torch.core.request import SamplingParams
from repro_torch.models import transformer as ttx
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.serving import api as tapi
from repro_torch.serving.session import make_session_fns
from repro_torch.training.checkpoint import CheckpointManager

pytestmark = pytest.mark.torch_port

REPO = Path(__file__).resolve().parents[1]
PREFILL = 32
ECFG = dict(lanes=2, prefill_len=PREFILL, decoding_length=8,
            branch_length=4)


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


@pytest.mark.parametrize("model", ["guided", "random"])
def test_engine_lossless_and_matches_jax_engine(model):
    if model == "guided":
        jcfg = jtx.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                                     n_kv_heads=2, d_ff=128, vocab_size=256,
                                     max_seq_len=192)
        j_bias, t_bias = _guides(jcfg.vocab_size)
        prompts = _prompts(5, jcfg.vocab_size, seed=3)
    else:
        jcfg = jtx.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                                     n_kv_heads=1, d_ff=64, vocab_size=61,
                                     max_seq_len=160, qkv_bias=True)
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


def test_engine_matches_jax_engine_on_long_prompts():
    """Prompts of 250 to 316 tokens at ``prefill_len`` 320 on qwen2-1.5b's
    smoke config, guided: the prefill attention spans several row and key
    tiles.  The JAX engine prefills through its Pallas kernel (interpret
    mode) and the port through its CUDA backend (the plain version on the
    CPU); the same converted weights give the same tokens, and the port's
    equal its ``reference_decode``."""
    from repro.configs.qwen2_1_5b import smoke_config
    jcfg = dataclasses.replace(smoke_config(), max_seq_len=384,
                               prefill_backend="pallas")
    tcfg, jp, tp = _pair(jcfg, seed=6)
    j_bias, t_bias = _guides(jcfg.vocab_size)
    prompts = _prompts(3, jcfg.vocab_size, seed=7, lo=250, hi=317)
    ecfg = dict(ECFG, prefill_len=320,
                default_params=SamplingParams(max_new_tokens=12))
    t_eng = tapi.build_engine(tapi.EngineConfig(**ecfg), tcfg, tp,
                              logits_transform=t_bias, device="cpu")
    j_eng = japi.build_engine(japi.EngineConfig(**ecfg), jcfg, jp,
                              logits_transform=j_bias)
    outs = _serve(t_eng, prompts, 12)
    assert outs == _serve(j_eng, prompts, 12)
    for p, o in zip(prompts, outs):
        assert o == reference_decode(t_eng.fns, p, 12)


def test_fused_path_one_sync_per_step_and_fixed_shapes():
    jcfg = jtx.TransformerConfig(n_layers=1, d_model=32, n_heads=4,
                                 n_kv_heads=2, d_ff=64, vocab_size=128,
                                 max_seq_len=160)
    tcfg, _, tp = _pair(jcfg, seed=6)
    _, t_bias = _guides(jcfg.vocab_size, phase=3)
    eng = tapi.build_engine(tapi.EngineConfig(**ECFG), tcfg, tp,
                            logits_transform=t_bias, device="cpu")
    prompts = _prompts(5, jcfg.vocab_size, seed=7)   # 5 requests, 2 lanes
    outs = _serve(eng, prompts, 12)
    st = eng.stats
    assert st.decode_syncs == st.decode_steps > 0
    assert st.host_syncs <= st.decode_steps + st.admitted
    fns = eng.fns
    assert fns.fused_step._cache_size() == 1          # (lanes, T)
    assert fns.prefill._cache_size() == 1             # (lanes, prefill_len)
    assert fns.prefill_into_slot._cache_size() == 1   # (1, prefill_len)
    assert fns.tree_step._cache_size() == 0           # parity oracle only
    assert fns.commit._cache_size() == 0
    assert all(len(o) == 12 for o in outs)


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_dropped_in_flight_is_freed_without_the_cycle_collector(
        layout):
    """An engine dropped with requests queued and in flight (and their
    handles with it) is freed at once, with the cycle collector off: no
    handle -> scheduler -> handle cycle keeps its session (on the card,
    its KV cache and captured graphs) alive.  A callback registered on a
    handle that its caller then drops still streams every token."""
    import gc
    import weakref
    tcfg = ttx.TransformerConfig(n_layers=1, d_model=32, n_heads=4,
                                 n_kv_heads=2, d_ff=64, vocab_size=128,
                                 max_seq_len=160, kv_block_size=16)
    tp = init_params(tcfg, seed=8, device="cpu")
    ecfg = tapi.EngineConfig(**ECFG, kv_layout=layout, block_size=16)
    prompts = _prompts(5, tcfg.vocab_size, seed=9)   # 5 requests, 2 lanes
    gc.collect()
    gc.disable()
    try:
        eng = tapi.build_engine(ecfg, tcfg, tp, device="cpu")
        handles = [eng.submit(p, max_new_tokens=12) for p in prompts]
        for _ in range(3):
            eng.step()
        assert not eng.idle and len(eng.scheduler.handles) == 5
        sched, cache = weakref.ref(eng.scheduler), weakref.ref(
            eng.scheduler.cache["k"])
        del eng, handles
        assert sched() is None and cache() is None
    finally:
        gc.enable()
    eng = tapi.build_engine(ecfg, tcfg, tp, device="cpu")
    streamed = {}
    for i, p in enumerate(prompts):
        eng.submit(p, max_new_tokens=12).on_token(
            lambda d, i=i: streamed.setdefault(i, []).extend(d))
    results = eng.run()
    assert [streamed[i] for i in range(5)] == [r.tokens for r in results]
    assert not eng.scheduler.handles and not eng.scheduler.callbacks


def test_lockstep_loop_matches_reference():
    """The legacy lock-step loop (tree_step + host verify + commit) on the
    port's step functions gives the same tokens as reference_decode."""
    jcfg = jtx.TransformerConfig(n_layers=1, d_model=32, n_heads=4,
                                 n_kv_heads=2, d_ff=64, vocab_size=96,
                                 max_seq_len=160)
    tcfg, _, tp = _pair(jcfg, seed=8)
    _, t_bias = _guides(jcfg.vocab_size)
    ecfg = tapi.EngineConfig(**ECFG)
    fns = tapi.build_session_fns(ecfg, tcfg, tp, logits_transform=t_bias,
                                 device="cpu")
    prompts = _prompts(3, jcfg.vocab_size, seed=9)
    lock = LookaheadEngine(fns, ecfg.lookahead())
    res = lock.generate_batch_lockstep(prompts, 10)
    for p, r in zip(prompts, res):
        assert [int(t) for t in r.tokens] == reference_decode(fns, p, 10)


def test_fused_step_matches_unfused_step():
    """One fused_step (device accept walk + commit) against tree_step +
    host verify + commit on clones of the same cache."""
    from repro_torch.core import LookaheadConfig
    from repro_torch.core.request import build_draft_tree, idle_tree
    from repro_torch.core.trie import TrieTree
    from repro_torch.core.verify import verify_accept_batch
    jcfg = jtx.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                                 n_kv_heads=2, d_ff=64, vocab_size=61,
                                 max_seq_len=128)
    tcfg, _, tp = _pair(jcfg, seed=10)
    W = 9
    fns = make_session_fns(tcfg, tp, slots=W, prefill_len=PREFILL,
                           device="cpu")
    rng = np.random.RandomState(7)
    prompts = _prompts(3, 61, seed=11, lo=8, hi=PREFILL)
    toks = np.zeros((3, PREFILL), np.int32)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    cache, _ = fns.prefill(toks, lens)
    trie = TrieTree(capacity=4096)
    for _ in range(12):
        trie.insert_ngrams(rng.randint(1, 61, size=24).tolist(), 4)
    la = LookaheadConfig(decoding_length=W - 1, branch_length=4)
    trees = [build_draft_tree(trie, la, prompts[0], 0, W),
             build_draft_tree(trie, LookaheadConfig(decoding_length=2,
                                                    branch_length=2),
                              prompts[1], 0, W),
             idle_tree(W, 0)]
    tok = np.stack([t.tokens for t in trees])
    pos = (lens[:, None] + np.stack([t.depth for t in trees])).astype(
        np.int32)
    mask = np.stack([t.tree_mask for t in trees])
    parent = np.stack([t.parent for t in trees]).astype(np.int32)
    n_live = np.asarray([trees[0].n_slots, trees[1].n_slots, 0], np.int32)
    c1 = {k: v.clone() for k, v in cache.items()}
    c1, chosen = fns.tree_step(c1, lens, tok, pos, mask)
    accepted, kv_slots = verify_accept_batch(trees, chosen.numpy())
    gather = np.zeros((3, W), np.int32)
    n_acc = np.zeros((3,), np.int32)
    for b in range(2):
        gather[b, :len(kv_slots[b])] = kv_slots[b]
        n_acc[b] = len(kv_slots[b])
    c1, _ = fns.commit(c1, lens, gather, n_acc)
    c2 = {k: v.clone() for k, v in cache.items()}
    c2, packed = fns.fused_step(c2, lens, tok, pos, mask, parent, n_live)
    packed = packed.numpy()
    for b in range(2):
        n = int(packed[b, 0])
        assert packed[b, 1:1 + n].tolist() == [int(x) for x in accepted[b]]
        assert packed[b, 1 + W:1 + W + n].tolist() == \
            [int(x) for x in kv_slots[b]]
    assert packed[2, 0] == 0
    for name in ("k", "v"):
        assert torch.equal(c1[name], c2[name])


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or "
        "n.startswith('jax.') or n.startswith('jaxlib') or n == 'repro' "
        "or n.startswith('repro.'))\n"
        "n = sum(1 for n in sys.modules if n.startswith('repro_torch'))\n"
        "print(n, bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr + proc.stdout
    assert int(proc.stdout.split()[0]) > 30    # every module was imported


def test_entry_points_default_to_cuda():
    """None resolves to CUDA; without a card the entry points raise rather
    than fall back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is the happy path")
    cfg = ttx.TransformerConfig()
    with pytest.raises(RuntimeError, match="CUDA"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        tapi.build_engine(tapi.EngineConfig(**ECFG), cfg, params)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_session_fns(cfg, params, slots=9, prefill_len=PREFILL)


@pytest.mark.parametrize("change,item", [
    (dict(moe=True, n_experts=4, top_k=2, moe_d_ff=16, d_ff=0,
          moe_impl="ep"), "A16"),
])
def test_unported_features_are_refused(change, item):
    """The MoE FFN landed (A15); its expert-parallel dispatch waits for
    multi-GPU (A16) and is refused at the first forward."""
    cfg = dataclasses.replace(ttx.TransformerConfig(n_layers=1, d_model=32,
                                                    n_heads=4, n_kv_heads=2,
                                                    d_ff=64, vocab_size=53),
                              **change)
    params = init_params(cfg, device="cpu")
    toks = torch.ones((1, 8), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        ttx.prefill(cfg, params, toks, torch.tensor([8], dtype=torch.int32),
                    ttx.init_cache(cfg, 1))
    # the sanitizer (A12) landed: its config validates
    tapi.EngineConfig(**ECFG, sanitize=True).validate()


def test_serve_cli_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    base = [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
            "--device", "cpu", "--requests", "3", "--max-new", "6"]
    proc = subprocess.run(base, capture_output=True, text=True, env=env,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "continuous [cpu]: 18 tokens / 3 requests" in proc.stdout
    assert "1.0 sync/step" in proc.stdout
    paged = base[:-4] + ["--requests", "6", "--max-new", "6", "--lanes",
                         "2", "--kv-layout", "paged", "--prefix-cache",
                         "--shared-prefix", "40"]
    proc = subprocess.run(paged, capture_output=True, text=True, env=env,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "continuous [cpu]: 36 tokens / 6 requests" in proc.stdout
    assert "kv cache [paged]" in proc.stdout
    hits = re.search(r"prefix cache: (\d+)/\d+ hits", proc.stdout)
    assert hits and int(hits.group(1)) > 0, proc.stdout
    assert "1.0 sync/step" in proc.stdout
    # --ckpt-dir (A17 landed) serves a checkpoint's {"params"}
    cfg = get_arch("qwen2-1.5b").smoke_config()
    CheckpointManager(str(tmp_path)).save(
        3, {"params": init_params(cfg, seed=1, device="cpu")})
    proc = subprocess.run(base + [f"--ckpt-dir={tmp_path}"],
                          capture_output=True, text=True, env=env,
                          cwd=str(REPO), timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "restored checkpoint step 3" in proc.stdout
    assert "continuous [cpu]: 18 tokens / 3 requests" in proc.stdout


@pytest.mark.parametrize("arch", ["antglm-10b", "phi3-mini-3.8b",
                                  "phi3-medium-14b", "qwen3-moe-30b-a3b",
                                  "moonshot-v1-16b-a3b"])
def test_serve_cli_smoke_on_cpu_other_archs(arch):
    """The serve CLI on the reference's other LMs, dense and MoE, at
    smoke size: the same tokens line and one sync a decode step."""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke",
         "--device", "cpu", "--arch", arch, "--requests", "3", "--max-new",
         "6"], capture_output=True, text=True, env=env, cwd=str(REPO),
        timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "continuous [cpu]: 18 tokens / 3 requests" in proc.stdout
    assert "1.0 sync/step" in proc.stdout
