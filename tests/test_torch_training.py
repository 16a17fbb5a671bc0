"""The port's training slice (``repro_torch.training``, ``lm_loss``, the
train CLI and the serve CLI's ``--ckpt-dir``) against the JAX package on the
CPU, in f32 at smoke size.

The JAX ``init_params`` pytree is carried over with ``params_from_jax`` and
inputs come from numpy, so both frameworks run the same weights on the same
tokens.  Tolerances, all f32 with sums in another order:

* ``lm_loss``: loss atol 2e-5; every gradient leaf within 1e-5 of the
  largest entry of its JAX leaf (relative to that leaf's scale: the leaves
  span 1e-3 to 1e1), rtol 1e-4.  Remat on equals remat off bit for bit in
  torch (the recomputed forward runs the same ops).
* ``clip_by_global_norm`` / ``adamw_update`` fed the same gradients:
  rtol 1e-6, atol 1e-9 on the clipped gradients and 1e-7 on the updated
  parameters and moments — an elementwise formula, a rounding apart.
* One ``make_train_step`` step end to end: loss and gradient norm rtol
  1e-5; parameters atol lr / 10.  Adam's first update is
  lr * g / (|g| + eps), continuous in g, so gradients that differ in their
  rounding move it far less than lr (under 6e-6 here); a wrong update (a
  missing bias correction, a halved lr) moves entries by lr / 2 or more.
  The update is also checked alone, tightly, above.
"""
import dataclasses
import functools
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import qwen2_1_5b as j_qwen
from repro.configs import qwen3_moe_30b_a3b as j_moe
from repro.models import layers as jL
from repro.models import transformer as jtx
from repro.training import checkpoint as jC
from repro.training import data as j_data
from repro.training import optimizer as jopt
from repro.training.train_step import make_train_step as j_make_step
from repro_torch.launch import serve as t_serve
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch import train as t_train
from repro_torch.models import layers as tL
from repro_torch.models import transformer as ttx
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.training import checkpoint as tC
from repro_torch.training import data as t_data
from repro_torch.training import fault_tolerance as F
from repro_torch.training import optimizer as topt
from repro_torch.training.train_step import make_train_step

pytestmark = pytest.mark.torch_port

ARCHS = {"dense": j_qwen, "moe": j_moe}
B, S = 2, 32
LR = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs several test processes side by side: one intra-op
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def torch_config(jcfg, **kw) -> ttx.TransformerConfig:
    fields = dataclasses.asdict(jcfg)
    fields.update({"prefill_backend": "dense", "decode_backend": "dense",
                   **kw})
    return ttx.TransformerConfig(**fields)


@pytest.fixture(scope="module")
def models():
    """arch -> (JAX smoke config, JAX params, the port's params)."""
    out = {}
    for arch, mod in ARCHS.items():
        jcfg = mod.smoke_config()
        jp = jtx.init_params(jcfg, jax.random.key(0))
        out[arch] = (jcfg, jp, params_from_jax(
            torch_config(jcfg), jax.tree.map(np.asarray, jp), "cpu"))
    return out


def _tokens(vocab, seed=0, b=B, s=S):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, vocab, (b, s)).astype(np.int32),
            rng.randint(0, vocab, (b, s)).astype(np.int32))


def _torch_loss_and_grads(tcfg, tp, toks, labs, mask=None):
    live = topt.tree_map(lambda p: p.detach().requires_grad_(True), tp)
    leaves = topt.tree_leaves(live)
    loss = ttx.lm_loss(tcfg, live, torch.from_numpy(toks),
                       torch.from_numpy(labs),
                       None if mask is None else torch.from_numpy(mask))
    return loss.detach(), torch.autograd.grad(loss, leaves)


def _grads_close(got, want):
    for g, j in zip(got, jax.tree.leaves(want)):
        j = np.asarray(j)
        np.testing.assert_allclose(g.numpy(), j, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(j).max()))


# ----------------------------------------------------------------- lm_loss
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("q_chunk", [0, 16])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_loss_and_every_gradient_match_jax(models, arch, q_chunk, remat):
    jcfg0, jp, tp = models[arch]
    jcfg = dataclasses.replace(jcfg0, q_chunk=q_chunk, remat=remat)
    tcfg = torch_config(jcfg)
    toks, labs = _tokens(jcfg.vocab_size)
    mask = (np.random.RandomState(1).rand(B, S) > 0.3).astype(np.float32)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jtx.lm_loss(jcfg, p, jnp.asarray(toks), jnp.asarray(labs),
                              jnp.asarray(mask))))(jp)
    tl, tg = _torch_loss_and_grads(tcfg, tp, toks, labs, mask)
    assert abs(float(tl) - float(jl)) < 2e-5
    _grads_close(tg, jg)
    if remat:       # checkpointing recomputes the same ops: the same bits
        rl, rg = _torch_loss_and_grads(
            dataclasses.replace(tcfg, remat=False), tp, toks, labs, mask)
        assert torch.equal(rl, tl)
        assert all(torch.equal(a, b) for a, b in zip(rg, tg))


def test_train_logits_match_jax(models):
    jcfg, jp, tp = models["dense"]
    toks, _ = _tokens(jcfg.vocab_size, seed=2)
    got = ttx.train_logits(torch_config(jcfg), tp, torch.from_numpy(toks))
    want = jtx.train_logits(jcfg, jp, jnp.asarray(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=1e-4)


def test_gqa_attention_chunked_matches_jax():
    rng = np.random.RandomState(3)
    q = rng.randn(2, 32, 4, 16).astype(np.float32)
    k = rng.randn(2, 32, 2, 16).astype(np.float32)
    v = rng.randn(2, 32, 2, 16).astype(np.float32)
    pos = np.broadcast_to(np.arange(32), (2, 32)).astype(np.int32)
    lm = np.ones((2, 32), bool)
    lm[1, 27:] = False
    got = tL.gqa_attention_chunked(*map(torch.from_numpy, (q, k, v, pos, lm)),
                                   q_chunk=8)
    want = jL.gqa_attention_chunked(*map(jnp.asarray, (q, k, v, pos, lm)),
                                    q_chunk=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6,
                               rtol=1e-5)
    with pytest.raises(ValueError, match="does not divide"):
        tL.gqa_attention_chunked(*map(torch.from_numpy, (q, k, v, pos, lm)),
                                 q_chunk=5)


# --------------------------------------------------------------- optimizer
def test_clip_and_adamw_update_match_jax_on_the_same_gradients(models):
    """Both packages update the same parameters with the same gradients
    (JAX's, converted), twice, so the second step's moments and bias
    corrections are exercised too."""
    jcfg, jp, tp = models["dense"]
    toks, labs = _tokens(jcfg.vocab_size, seed=4)
    jg = jax.jit(jax.grad(
        lambda p: jtx.lm_loss(jcfg, p, jnp.asarray(toks),
                              jnp.asarray(labs))))(jp)
    tg = topt.tree_map(lambda a: torch.from_numpy(np.array(a)), jg)
    jclip, jn = jax.jit(jopt.clip_by_global_norm, static_argnums=1)(jg, 0.5)
    tclip, tn = topt.clip_by_global_norm(tg, 0.5)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for a, b in zip(topt.tree_leaves(tclip), jax.tree.leaves(jclip)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-9)
    jo, to = jopt.adamw_init(jp), topt.adamw_init(tp)
    jpp, tpp = jp, tp
    j_update = jax.jit(functools.partial(jopt.adamw_update, lr=LR,
                                         max_grad_norm=0.5))
    for _ in range(2):
        jpp, jo, jm = j_update(jpp, jg, jo)
        tpp, to, tm = topt.adamw_update(tpp, tg, to, lr=LR,
                                        max_grad_norm=0.5)
    assert int(to.step) == int(jo.step) == 2 and to.step.dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    for t_tree, j_tree in ((tpp, jpp), (to.mu, jo.mu), (to.nu, jo.nu)):
        for a, b in zip(topt.tree_leaves(t_tree), jax.tree.leaves(j_tree)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
    # out of place: the inputs are untouched
    assert all(torch.equal(a, torch.from_numpy(np.asarray(b)))
               for a, b in zip(topt.tree_leaves(tp), jax.tree.leaves(jp)))


def test_grad_clip():
    g = {"a": torch.full((4,), 100.0)}
    clipped, norm = topt.clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(200.0)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                   rel=1e-4)
    bf = topt.clip_by_global_norm({"a": g["a"].bfloat16()}, 1.0)[0]["a"]
    assert bf.dtype == torch.float32            # JAX promotes, so does this


# -------------------------------------------------------------- train step
@pytest.mark.parametrize("accum,grad_dtype", [(1, None), (4, None),
                                              (4, "bfloat16")])
def test_train_step_matches_jax(models, accum, grad_dtype):
    jcfg, jp, tp = models["dense"]
    tcfg = torch_config(jcfg)
    toks, labs = _tokens(jcfg.vocab_size, seed=5, b=8, s=16)
    jstep = jax.jit(j_make_step(
        lambda p, b: jtx.lm_loss(jcfg, p, b["tokens"], b["labels"]), lr=LR,
        accum_steps=accum, grad_dtype=grad_dtype))
    tstep = make_train_step(
        lambda p, b: ttx.lm_loss(tcfg, p, b["tokens"], b["labels"]), lr=LR,
        accum_steps=accum, grad_dtype=grad_dtype)
    jpp, jo, jm = jstep(jp, jopt.adamw_init(jp),
                        {"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(labs)})
    tpp, to, tm = tstep(tp, topt.adamw_init(tp),
                        {"tokens": torch.from_numpy(toks),
                         "labels": torch.from_numpy(labs)})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    for a, b in zip(topt.tree_leaves(tpp), jax.tree.leaves(jpp)):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=LR / 10)
    assert int(to.step) == 1


# ------------------------------------- mirrors of tests/test_training_infra
@pytest.fixture(scope="module")
def tiny_lm():
    cfg = ttx.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                                n_kv_heads=2, d_ff=64, vocab_size=64,
                                prefill_backend="dense")
    params = init_params(cfg, seed=0, device="cpu")
    loss = lambda p, b: ttx.lm_loss(cfg, p, b["tokens"], b["labels"])  # noqa: E731
    return cfg, params, loss


def _batch(b, s, seed):
    return {k: torch.from_numpy(v) for k, v in
            next(t_data.lm_train_batches(64, b, s, seed=seed)).items()}


def test_overfit_single_batch(tiny_lm):
    cfg, params, loss = tiny_lm
    step = make_train_step(loss, lr=3e-3)
    opt = topt.adamw_init(params)
    b = _batch(8, 16, 0)
    first = None
    for i in range(25):
        params, opt, m = step(params, opt, b)
        first = first or float(m["loss"])
    assert float(m["loss"]) < first - 0.5


def test_grad_accum_equivalence(tiny_lm):
    cfg, params, loss = tiny_lm
    b = _batch(8, 16, 1)
    p1, _, m1 = make_train_step(loss, lr=1e-3, accum_steps=1)(
        params, topt.adamw_init(params), b)
    p2, _, m2 = make_train_step(loss, lr=1e-3, accum_steps=4)(
        params, topt.adamw_init(params), b)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-4
    d = max(float((a - c).abs().max()) for a, c in
            zip(topt.tree_leaves(p1), topt.tree_leaves(p2)))
    assert d < 1e-4, d


def test_checkpoint_roundtrip_retention_integrity(tiny_lm, tmp_path):
    cfg, params, _ = tiny_lm
    mgr = tC.CheckpointManager(str(tmp_path), keep=2)
    opt = topt.adamw_init(params)
    mgr.save(1, {"p": params, "o": opt})
    mgr.save(5, {"p": params, "o": opt}, blocking=False)
    mgr.wait()
    mgr.save(9, {"p": params, "o": opt})
    assert mgr.all_steps() == [5, 9]
    restored, step = mgr.restore({"p": params, "o": opt})
    assert step == 9 and isinstance(restored["o"], topt.AdamWState)
    for a, b in zip(topt.tree_leaves(restored["p"]),
                    topt.tree_leaves(params)):
        np.testing.assert_array_equal(a, b.numpy())
    path = tmp_path / "step_0000000009" / "arrays.npz"
    raw = bytearray(path.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    path.write_bytes(bytes(raw))
    with pytest.raises(Exception):
        mgr.restore({"p": params, "o": opt}, step=9)
    # elastic restore onto a one-rank gloo mesh: the blocks are the leaves
    with pytest.raises(TypeError, match="Mesh"):
        mgr.restore({"p": params}, mesh=object())
    mgr.save(11, {"p": params, "o": opt}, logical_axes={
        "p": ttx.param_logical_axes(cfg), "o": None})
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        out, step = mgr.restore({"p": params, "o": opt},
                                mesh=make_host_mesh())
    finally:
        dist.destroy_process_group()
    assert step == 11
    for a, b in zip(topt.tree_leaves(out), topt.tree_leaves(
            {"p": params, "o": opt})):
        np.testing.assert_array_equal(a, b.numpy())
    with pytest.raises(TypeError, match="'p/embed' is torch.bfloat16"):
        mgr.save(10, {"p": {"embed": params["embed"].bfloat16()}})


def test_resume_from_latest_continues_training(tiny_lm, tmp_path):
    cfg, params, loss = tiny_lm
    step = make_train_step(loss, lr=1e-3)
    b = _batch(4, 16, 2)
    mgr = tC.CheckpointManager(str(tmp_path))
    opt = topt.adamw_init(params)
    for i in range(3):
        params, opt, _ = step(params, opt, b)
    mgr.save(3, {"p": params, "o": opt})
    restored, st = mgr.restore({"p": params, "o": opt})
    assert st == 3
    state = topt.tree_map(torch.from_numpy, restored)
    p2, o2, m = step(state["p"], state["o"], b)
    assert np.isfinite(float(m["loss"]))
    assert int(o2.step) == 4


def test_preemption_checkpoint_flow(tiny_lm, tmp_path):
    cfg, params, loss = tiny_lm
    h = F.PreemptionHandler().install()
    try:
        step = make_train_step(loss, lr=1e-3)
        opt = topt.adamw_init(params)
        b = _batch(4, 16, 3)
        mgr = tC.CheckpointManager(str(tmp_path))
        stopped_at = None
        for i in range(10):
            params, opt, _ = step(params, opt, b)
            if i == 4:
                h.trigger()          # deliver "SIGTERM"
            if h.preempted:
                mgr.save(i + 1, {"p": params})
                stopped_at = i + 1
                break
        assert stopped_at == 5
        assert mgr.latest_step() == 5
    finally:
        h.uninstall()


def test_straggler_and_retry():
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient collective failure")
        return 42

    assert F.retry(flaky, attempts=4, base_delay=0.001) == 42
    with pytest.raises(F.StragglerTimeout):
        F.run_with_timeout(lambda: time.sleep(0.3), 0.05, retries=1)
    assert F.run_with_timeout(lambda: 7, 1.0) == 7


def test_elastic_world_shapes():
    assert F.elastic_world(512, 16, prefer_pods=2) == (2, 16, 16)
    assert F.elastic_world(384, 16, prefer_pods=2) == (2, 8, 16)
    assert F.elastic_world(16, 16) == (1, 1, 16)
    with pytest.raises(ValueError):
        F.elastic_world(8, 16)


def test_corpus_profiles_stats():
    for name, prof in t_data.PROFILES.items():
        c = t_data.SyntheticCorpus(prof, 512, seed=1)
        pr, ans = c.sample()
        assert len(pr) == prof.prompt_len
        assert len(ans) == prof.answer_len
    assert t_data.PROFILES["antrag"].copy_from_prompt > \
        t_data.PROFILES["dolly"].copy_from_prompt


def test_lm_train_batches_equal_the_reference():
    for corpus in (None, "gsm8k"):
        mk = {pkg: (pkg.SyntheticCorpus(pkg.PROFILES[corpus], 300, seed=7)
                    if corpus else None) for pkg in (t_data, j_data)}
        tb = t_data.lm_train_batches(300, 3, 40, seed=4, corpus=mk[t_data])
        jb = j_data.lm_train_batches(300, 3, 40, seed=4, corpus=mk[j_data])
        for _ in range(2):
            a, b = next(tb), next(jb)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


# ------------------------------------------------ checkpoints across packages
def test_checkpoint_state_crosses_packages(models, tmp_path):
    """The same {"p", "o"} state (after one JAX step, so the moments are
    not zero) saved by each package: equal keys and digest, and each
    restores the other's, bit for bit."""
    jcfg, jp, _ = models["dense"]
    toks, labs = _tokens(jcfg.vocab_size, seed=6)
    jstep = jax.jit(j_make_step(
        lambda p, b: jtx.lm_loss(jcfg, p, b["tokens"], b["labels"])))
    jp1, jo1, _ = jstep(jp, jopt.adamw_init(jp),
                        {"tokens": jnp.asarray(toks),
                         "labels": jnp.asarray(labs)})
    jstate = {"p": jp1, "o": jo1}
    tstate = topt.tree_map(lambda a: torch.from_numpy(np.asarray(a)),
                           jax.tree.map(np.asarray, jstate))
    tstate["o"] = topt.AdamWState(*tstate["o"])
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    axes = {"p": jtx.param_logical_axes(jcfg), "o": None}
    jC.CheckpointManager(str(jdir)).save(3, jstate, logical_axes=axes)
    tC.CheckpointManager(str(tdir)).save(3, tstate, logical_axes=axes)
    man = [json.loads((d / "step_0000000003" / "manifest.json").read_text())
           for d in (jdir, tdir)]
    assert man[0]["keys"] == man[1]["keys"]
    assert man[0]["logical_axes"] == man[1]["logical_axes"]
    assert man[1]["logical_axes"]["p/layers/wq"] == [None, "fsdp", "tensor"]
    assert "o/0" in man[0]["keys"] and "o/1/embed" in man[0]["keys"]
    assert man[0]["digest"] == man[1]["digest"]
    t_from_j, _ = tC.CheckpointManager(str(jdir)).restore(tstate)
    j_from_t, _ = jC.CheckpointManager(str(tdir)).restore(jstate)
    for a, b in zip(topt.tree_leaves(t_from_j), topt.tree_leaves(tstate)):
        np.testing.assert_array_equal(a, b.numpy())
    for a, b in zip(jax.tree.leaves(j_from_t), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ------------------------------------------------------------------- CLIs
@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """The train CLI at smoke size on the CPU: 4 steps, a checkpoint every
    2."""
    d = str(tmp_path_factory.mktemp("train_cli"))
    argv = ["--smoke", "--device", "cpu", "--ckpt-every", "2",
            "--ckpt-dir", d]
    return d, argv, t_train.main(argv + ["--steps", "4"])


def test_train_cli_smoke_and_resume(cli_run, capsys):
    d, argv, first = cli_run
    assert first["start"] == 0 and sorted(first["losses"]) == [1]
    assert np.isfinite(first["losses"][1])
    saved, step = tC.CheckpointManager(d).restore(
        {"p": first["params"], "o": first["opt"]})
    assert step == 4
    for a, b in zip(topt.tree_leaves(saved),
                    topt.tree_leaves({"p": first["params"],
                                      "o": first["opt"]})):
        np.testing.assert_array_equal(a, b.numpy())
    second = t_train.main(argv + ["--steps", "6"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "checkpoints: [2, 4, 6]" in out
    assert second["start"] == 4 and np.isfinite(second["losses"][5])
    assert int(second["opt"].step) == 6


def _served_tokens(monkeypatch, argv):
    """Run the serve CLI in process; the tokens each request got."""
    handles = []
    real = t_serve.build_engine

    def build(*a, **kw):
        engine = real(*a, **kw)
        submit = engine.submit
        engine.submit = lambda r: handles.append(submit(r)) or handles[-1]
        return engine

    monkeypatch.setattr(t_serve, "build_engine", build)
    t_serve.main(argv)
    return [list(h.result().tokens) for h in handles]


def test_serve_cli_ckpt_dir_serves_a_reference_checkpoint(monkeypatch,
                                                          tmp_path, capsys):
    """A checkpoint the reference's CheckpointManager wrote as
    {"params": ...} serves the tokens of the port given those parameters
    directly."""
    jcfg = j_qwen.smoke_config()
    jp = jtx.init_params(jcfg, jax.random.key(3))
    jC.CheckpointManager(str(tmp_path)).save(7, {"params": jp})
    argv = ["--smoke", "--device", "cpu", "--requests", "2", "--max-new",
            "5"]
    from_ckpt = _served_tokens(monkeypatch,
                               argv + ["--ckpt-dir", str(tmp_path)])
    assert "restored checkpoint step 7" in capsys.readouterr().out
    direct = params_from_jax(torch_config(jcfg),
                             jax.tree.map(np.asarray, jp), "cpu")
    monkeypatch.setattr(t_serve, "init_params", lambda *a, **kw: direct)
    assert _served_tokens(monkeypatch, argv) == from_ckpt
    assert len(from_ckpt) == 2 and all(len(t) == 5 for t in from_ckpt)


def test_train_cli_checkpoint_is_not_servable_in_either_package(cli_run,
                                                                models,
                                                                tmp_path):
    """ROADMAP §C: the train CLIs save {"p", "o"} and the serve CLIs restore
    {"params"}: KeyError on 'params/embed' in both packages."""
    d, _, _ = cli_run
    with pytest.raises(KeyError, match="params/embed"):
        t_serve.main(["--smoke", "--device", "cpu", "--requests", "1",
                      "--ckpt-dir", d])
    jcfg, jp, _ = models["dense"]
    jC.CheckpointManager(str(tmp_path)).save(
        1, {"p": jp, "o": jopt.adamw_init(jp)})
    with pytest.raises(KeyError, match="params/embed"):
        jC.CheckpointManager(str(tmp_path)).restore({"params": jp})
    assert os.listdir(tmp_path) == ["step_0000000001"]
