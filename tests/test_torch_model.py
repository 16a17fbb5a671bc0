"""Model-function parity of the PyTorch port (repro_torch.models) against
the JAX package (repro.models.transformer), at f32 on the CPU.

The JAX ``init_params`` pytree is converted with ``params_from_jax``, so
both frameworks run the same weights; token inputs come from numpy.  The
port runs its default "cuda" attention backend, whose wrappers take the
kernels' plain versions on the CPU, and the "dense" backend.
Tolerance for logits: atol=2e-5, rtol=1e-4 (f32 sums in another order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import antglm_10b as j_antglm
from repro.configs import qwen2_1_5b as j_qwen
from repro.configs import qwen3_moe_30b_a3b as j_qwen3_moe
from repro.core import LookaheadConfig
from repro.core.request import build_draft_tree, idle_tree
from repro.core.trie import TrieTree
from repro.core.verify import verify_accept_batch
from repro.models import transformer as jtx
from repro_torch.configs import qwen2_1_5b as t_qwen
from repro_torch.models import transformer as ttx
from repro_torch.models.params import init_params, params_from_jax

pytestmark = pytest.mark.torch_port

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
ARCHS = {"qwen2-1.5b": j_qwen, "antglm-10b": j_antglm}


def torch_config(jcfg, **kw) -> ttx.TransformerConfig:
    """The port's config with the JAX config's fields."""
    fields = dataclasses.asdict(jcfg)
    fields.update({"prefill_backend": "cuda", "decode_backend": "cuda",
                   **kw})
    return ttx.TransformerConfig(**fields)


def _models(arch, seed=0):
    jcfg = ARCHS[arch].smoke_config()
    jp = jtx.init_params(jcfg, jax.random.key(seed))
    tp = params_from_jax(torch_config(jcfg), jax.tree.map(np.asarray, jp),
                         "cpu")
    return jcfg, jp, tp


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or LOGIT_TOL))


# ----------------------------------------------------------------- weights
def test_params_from_jax_round_trip():
    jcfg, jp, tp = _models("qwen2-1.5b")
    jl = jax.tree_util.tree_leaves_with_path(jp)
    assert len(jl) == len(jax.tree.leaves(tp))
    for path, leaf in jl:
        t = tp
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype)
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    # bf16 weights convert exactly through their f32 values
    bcfg = dataclasses.replace(jcfg, param_dtype="bfloat16")
    bp = jtx.init_params(bcfg, jax.random.key(1))
    tb = params_from_jax(torch_config(bcfg), jax.tree.map(np.asarray, bp),
                         "cpu")
    assert tb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tb["embed"].float().numpy(),
                                  np.asarray(bp["embed"], np.float32))


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_init_params_matches_jax_layout(pdtype):
    """init_params draws on the device with the reference's distributions:
    same tree, shapes and dtypes; N(0, 0.02^2) weights, unit norms, zero
    biases."""
    jcfg = dataclasses.replace(j_qwen.smoke_config(), param_dtype=pdtype)
    jp = jtx.init_params(jcfg, jax.random.key(0))
    tp = init_params(torch_config(jcfg), seed=3, device="cpu")
    flat_j = {jax.tree_util.keystr(p): l
              for p, l in jax.tree_util.tree_leaves_with_path(jp)}
    flat_t = {jax.tree_util.keystr(p): l
              for p, l in jax.tree_util.tree_leaves_with_path(tp)}
    assert flat_j.keys() == flat_t.keys()
    for key, leaf in flat_j.items():
        t = flat_t[key]
        assert tuple(t.shape) == leaf.shape, key
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
    assert torch.all(tp["ln_f"] == 1) and torch.all(tp["layers"]["bq"] == 0)
    w = tp["layers"]["w_up"].float()
    assert abs(w.std().item() - 0.02) < 0.002 and abs(w.mean().item()) < 1e-3


def _moe_smoke(pdtype="float32"):
    """Qwen3-MoE's smoke config with Moonlight's shared expert: every MoE
    key (router, we_*, ws_*) in one pytree."""
    return dataclasses.replace(j_qwen3_moe.smoke_config(),
                               n_shared_experts=1, param_dtype=pdtype)


def test_params_from_jax_round_trip_moe():
    jcfg = _moe_smoke()
    jp = jtx.init_params(jcfg, jax.random.key(2))
    tp = params_from_jax(torch_config(jcfg), jax.tree.map(np.asarray, jp),
                         "cpu")
    flat_j = {jax.tree_util.keystr(p): l
              for p, l in jax.tree_util.tree_leaves_with_path(jp)}
    flat_t = {jax.tree_util.keystr(p): l
              for p, l in jax.tree_util.tree_leaves_with_path(tp)}
    assert flat_j.keys() == flat_t.keys()
    assert "['layers']['we_gate']" in flat_t and \
        "['layers']['w_gate']" not in flat_t
    for key, leaf in flat_j.items():
        np.testing.assert_array_equal(flat_t[key].numpy(), np.asarray(leaf),
                                      err_msg=key)
    # a dense pytree does not pass for the MoE config
    dense = jtx.init_params(j_qwen.smoke_config(), jax.random.key(0))
    with pytest.raises(ValueError, match="do not match"):
        params_from_jax(torch_config(jcfg), jax.tree.map(np.asarray, dense),
                        "cpu")


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_init_params_matches_jax_layout_moe(pdtype):
    """The MoE keys replace the dense FFN's, with the reference's shapes
    and dtypes; the expert tensors, drawn a layer at a time, have the
    same distribution in every layer; the dense keys keep their bits."""
    jcfg = _moe_smoke(pdtype)
    jp = jtx.init_params(jcfg, jax.random.key(0))
    tp = init_params(torch_config(jcfg), seed=3, device="cpu")
    flat_j = {jax.tree_util.keystr(p): l
              for p, l in jax.tree_util.tree_leaves_with_path(jp)}
    flat_t = {jax.tree_util.keystr(p): l
              for p, l in jax.tree_util.tree_leaves_with_path(tp)}
    assert flat_j.keys() == flat_t.keys()
    for key, leaf in flat_j.items():
        t = flat_t[key]
        assert tuple(t.shape) == leaf.shape, key
        assert str(t.dtype).split(".")[-1] == str(leaf.dtype), key
    for name in ("we_gate", "we_up", "we_down"):
        w = tp["layers"][name].float()
        std = w.flatten(1).std(dim=1)
        assert torch.all((std - 0.02).abs() < 0.002), (name, std)
        assert not torch.equal(w[0], w[1])
    # a dense config's draw is what it was before MoE keys were drawn
    dcfg = torch_config(dataclasses.replace(j_qwen.smoke_config(),
                                            param_dtype=pdtype))
    dp = init_params(dcfg, seed=3, device="cpu")
    gen = torch.Generator().manual_seed(3)
    for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        want = (torch.randn(dp["layers"][name].shape, generator=gen)
                * 0.02).to(dcfg.pdtype)
        assert torch.equal(dp["layers"][name], want), name
    want = (torch.randn(dp["embed"].shape, generator=gen) * 0.02
            ).to(dcfg.pdtype)
    assert torch.equal(dp["embed"], want)


# --------------------------------------------------------- model functions
def _prompts(cfg, B, S, seed):
    rng = np.random.RandomState(seed)
    toks = rng.randint(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    lens = rng.randint(S // 2, S + 1, size=(B,)).astype(np.int32)
    return toks, lens


def _tree_inputs(cfg, lens, T, seed):
    rng = np.random.RandomState(seed)
    B = len(lens)
    tok = rng.randint(1, cfg.vocab_size, size=(B, T)).astype(np.int32)
    parent = [-1] + [int(rng.randint(0, i)) for i in range(1, T)]
    depth = np.zeros(T, np.int32)
    tm = np.zeros((T, T), bool)
    for i in range(T):
        j = i
        while j >= 0:
            tm[i, j] = True
            j = parent[j]
        depth[i] = tm[i].sum() - 1
    pos = (lens[:, None] + depth[None]).astype(np.int32)
    return tok, pos, np.broadcast_to(tm, (B, T, T)).copy()


@pytest.mark.parametrize("backend", ["cuda", "dense"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_logits_match_jax(arch, backend):
    jcfg, jp, tp = _models(arch)
    tcfg = torch_config(jcfg, prefill_backend=backend)
    toks, lens = _prompts(jcfg, 3, 24, seed=5)
    jc, jl = jtx.prefill(jcfg, jp, jnp.asarray(toks), jnp.asarray(lens),
                         jtx.init_cache(jcfg, 3))
    tc, tl = ttx.prefill(tcfg, tp, torch.from_numpy(toks),
                         torch.from_numpy(lens), ttx.init_cache(tcfg, 3))
    _close(tl, jl)
    # rows past each prompt are garbage (never attended, I3): the CUDA
    # kernel's pad rows attend causally where the dense mask drops pad keys
    for name in ("k", "v"):
        for b, n in enumerate(lens):
            _close(tc[name][:, b, :n], jc[name][:, b, :n])


@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_into_slot_matches_jax(arch):
    jcfg, jp, tp = _models(arch)
    tcfg = torch_config(jcfg)
    toks, lens = _prompts(jcfg, 1, 20, seed=6)
    base = np.random.RandomState(7).randn(
        jcfg.n_layers, 3, jcfg.max_seq_len, jcfg.n_kv_heads,
        jcfg.dh).astype(np.float32)
    jc = {"k": jnp.asarray(base), "v": jnp.asarray(base * 2)}
    tc = {"k": torch.from_numpy(base.copy()),
          "v": torch.from_numpy(base * 2)}
    jc, jl = jtx.prefill_into_slot(jcfg, jp, jc, 2, jnp.asarray(toks),
                                   jnp.asarray(lens))
    tc, tl = ttx.prefill_into_slot(tcfg, tp, tc, 2, torch.from_numpy(toks),
                                   torch.from_numpy(lens))
    _close(tl, jl)
    n = int(lens[0])                  # rows past the prompt are garbage (I3)
    for name in ("k", "v"):           # other lanes untouched, slot 2 filled
        _close(tc[name][:, :2], jc[name][:, :2])
        _close(tc[name][:, 2, :n], jc[name][:, 2, :n])
        _close(tc[name][:, 2, 20:], jc[name][:, 2, 20:])


@pytest.mark.parametrize("backend", ["cuda", "dense"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_tree_step_logits_match_jax(arch, backend):
    jcfg, jp, tp = _models(arch)
    tcfg = torch_config(jcfg, decode_backend=backend)
    toks, lens = _prompts(jcfg, 2, 24, seed=8)
    jc, _ = jtx.prefill(jcfg, jp, jnp.asarray(toks), jnp.asarray(lens),
                        jtx.init_cache(jcfg, 2))
    tc, _ = ttx.prefill(tcfg, tp, torch.from_numpy(toks),
                        torch.from_numpy(lens), ttx.init_cache(tcfg, 2))
    tok, pos, tm = _tree_inputs(jcfg, lens, 7, seed=9)
    jc, jl = jtx.tree_step(jcfg, jp, jc, jnp.asarray(lens), jnp.asarray(tok),
                           jnp.asarray(pos), jnp.asarray(tm))
    tc, tl = ttx.tree_step(tcfg, tp, tc, torch.from_numpy(lens),
                           torch.from_numpy(tok), torch.from_numpy(pos),
                           torch.from_numpy(tm))
    _close(tl, jl)
    for name in ("k", "v"):           # slot KV written at cache_len + slot
        _close(tc[name], jc[name])


# ------------------------------------------------------- fused epilogue
@pytest.mark.parametrize("aliased", [False, True])
def test_commit_cache_matches_jax(aliased):
    """Row m+j takes row m+gather[j], every source read before any write.
    ``aliased``: gather[j'] = j for j' < j (slot 1 reads row m+2, which
    slot 2 overwrites) — a copy that wrote as it read would race."""
    rng = np.random.RandomState(11)
    L, B, S, K, dh, T = 2, 3, 40, 2, 8, 6
    k = rng.randn(L, B, S, K, dh).astype(np.float32)
    v = rng.randn(L, B, S, K, dh).astype(np.float32)
    lens = np.asarray([5, 17, 0], np.int32)
    if aliased:
        gather = np.asarray([[0, 2, 3, 5, 0, 0], [0, 1, 2, 3, 4, 5],
                             [0, 0, 0, 0, 0, 0]], np.int32)
        n_acc = np.asarray([4, 6, 0], np.int32)
    else:
        gather = np.asarray([[0, 1, 0, 0, 0, 0], [0, 3, 0, 0, 0, 0],
                             [0, 0, 0, 0, 0, 0]], np.int32)
        n_acc = np.asarray([2, 2, 0], np.int32)
    jc, jlens = jtx.commit_cache({"k": jnp.asarray(k), "v": jnp.asarray(v)},
                                 jnp.asarray(lens), jnp.asarray(gather),
                                 jnp.asarray(n_acc))
    tc, tlens = ttx.commit_cache(
        {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy())},
        torch.from_numpy(lens), torch.from_numpy(gather),
        torch.from_numpy(n_acc))
    np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(),
                                      np.asarray(jc[name]))
    if aliased:                       # the hazard the gather-first order fixes
        np.testing.assert_array_equal(tc["k"][:, 0, 6], k[:, 0, 7])
        np.testing.assert_array_equal(tc["k"][:, 0, 7], k[:, 0, 8])


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_verify_accept_device_matches_jax_and_host(seed):
    """Mirrors tests/test_fused_step.py::test_device_walk_matches_host_verify
    on the port: trie-built trees with ragged n_slots, first-child
    tie-breaking and an idle lane; equal to the JAX device walk and to the
    host verify_accept."""
    VOCAB, W = 61, 9
    rng = np.random.RandomState(seed)
    la = LookaheadConfig(decoding_length=W - 1, branch_length=5)
    trie = TrieTree(capacity=4096)
    for _ in range(20):
        trie.insert_ngrams(rng.randint(1, VOCAB, size=30).tolist(),
                           la.branch_length)
    trees = [build_draft_tree(trie, la,
                              rng.randint(1, VOCAB,
                                          size=rng.randint(6, 30)).tolist(),
                              0, W) for _ in range(5)]
    trees.append(idle_tree(W, 0))
    B = len(trees)
    chosen = rng.randint(1, VOCAB, size=(B, W)).astype(np.int32)
    for b, t in enumerate(trees):
        for c in range(1, t.n_slots):
            if rng.rand() < 0.6:
                chosen[b, t.parent[c]] = t.tokens[c]
    accepted, kv_slots = verify_accept_batch(trees, chosen)
    tok = np.stack([t.tokens for t in trees]).astype(np.int32)
    parent = np.stack([t.parent for t in trees]).astype(np.int32)
    n_live = np.asarray([t.n_slots for t in trees[:-1]] + [0], np.int32)
    j_out = jtx.verify_accept_device(tok, parent, n_live, chosen)
    t_out = ttx.verify_accept_device(*map(torch.from_numpy,
                                          (tok, parent, n_live, chosen)))
    for t, j in zip(t_out, j_out):
        assert t.dtype == torch.int32
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    n_acc, acc_tok, kvs = (t.numpy() for t in t_out)
    for b in range(B - 1):
        n = int(n_acc[b])
        assert acc_tok[b, :n].tolist() == [int(x) for x in accepted[b]]
        assert kvs[b, :n].tolist() == [int(x) for x in kv_slots[b]]
    assert int(n_acc[B - 1]) == 0
    packed = ttx.pack_step_result(*t_out)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jtx.pack_step_result(*j_out)))


def test_smoke_config_matches_reference_numbers():
    jcfg = j_qwen.smoke_config()
    tcfg = t_qwen.smoke_config()
    skip = {"prefill_backend", "decode_backend"}
    for f in dataclasses.fields(jcfg):
        if f.name not in skip:
            assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    full_j, full_t = j_qwen.full_config(), t_qwen.full_config()
    for f in dataclasses.fields(full_j):
        if f.name not in skip:
            assert getattr(full_t, f.name) == getattr(full_j, f.name), f.name
    assert full_t.adtype == torch.float32 and full_t.n_params() == \
        full_j.n_params()
