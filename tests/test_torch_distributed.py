"""The port's multi-rank paths (repro_torch.distributed, ``moe_ep``,
``_sharded_argmax``, the elastic checkpoint) on the CPU, against the JAX
package's sharded functions.

The rule translation (``logical_spec``, ``_derive_axes``,
``cache_partition_spec``) is held against the reference's on stand-in
meshes that have only ``.shape``.  The sharded programs run in one spawn of
8 gloo ranks on a (data 4, model 2) mesh (``tests/torch_dist_ranks.py``),
which checks them against the port's single-device paths; their outputs are
then held against the reference's ``shard_map`` programs, run once in a JAX
subprocess with 8 host devices on a mesh with Auto axes (``jax.make_mesh``
builds Explicit axes under jax 0.9, where the reference's own 8-device
tests fail).  A second spawn of 4 ranks restores the checkpoint the first
saved onto (data 2, model 2).
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp

import torch_dist_ranks as ranks
# the reference's models first: its flash_decode module imports them
from repro.models import transformer as ref_tx
from repro.distributed import flash_decode as ref_fd
from repro.distributed.sharding import DEFAULT_RULES as REF_RULES
from repro.distributed.sharding import logical_spec as ref_logical_spec
from repro_torch import configs
from repro_torch.distributed import flash_decode as fd
from repro_torch.distributed.sharding import DEFAULT_RULES, logical_spec
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh

pytestmark = [pytest.mark.torch_port]

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
LM_ARCHS = ("qwen2_1_5b", "phi3_mini_3_8b", "phi3_medium_14b",
            "qwen3_moe_30b_a3b", "moonshot_v1_16b_a3b", "antglm_10b")


class _Shape:
    """A mesh stand-in: the rule functions read ``.shape`` alone."""

    def __init__(self, **shape):
        self.shape = dict(shape)


MESHES = [dict(data=16, model=16), dict(pod=2, data=16, model=16),
          dict(data=4, model=2), dict(data=2, model=2)]


# ------------------------------------------------------------ rule translation
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(
    map(str, s.values())))
def test_logical_spec_equals_the_reference(shape):
    mesh = _Shape(**shape)
    names = sorted(REF_RULES.rules) + [None, "no_such_axis"]
    assert DEFAULT_RULES.rules == REF_RULES.rules
    for a in names:
        for b in names:
            for dims in [None, (512, 256), (7, 24), (32, 3), (2, 4096)]:
                got = logical_spec((a, b), dims, mesh, DEFAULT_RULES)
                want = ref_logical_spec((a, b), dims, mesh, REF_RULES)
                assert tuple(got) == tuple(want), (a, b, dims)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_derive_axes_and_cache_spec_equal_the_reference(arch):
    base = configs.get_arch(arch).full_config()
    for shape in MESHES:
        mesh = _Shape(**shape)
        for B, S in ((128, 32768), (1, 524288), (1, 7)):
            dims = (B, S, base.n_kv_heads, base.n_heads)
            assert fd._derive_axes(mesh, *dims) == ref_fd._derive_axes(
                mesh, *dims), (shape, dims)
            assert tuple(fd.cache_partition_spec(mesh, *dims)) == tuple(
                ref_fd.cache_partition_spec(mesh, *dims)), (shape, dims)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_logical_axes_of_params_and_cache_equal_the_reference(arch):
    from repro import configs as ref_configs
    from repro_torch.models import transformer as tx
    port, ref = (c.get_arch(arch).full_config() for c in (configs,
                                                            ref_configs))
    assert tx.param_logical_axes(port) == ref_tx.param_logical_axes(ref)
    for change in ({}, {"kv_layout": "paged"},
                   {"decode_backend": "flash_decode"}):
        assert tx.cache_logical_axes(dataclasses.replace(port, **change)) \
            == ref_tx.cache_logical_axes(dataclasses.replace(ref, **change))


def test_placement_splits_only_the_expert_dims():
    """The port's one placement rule: the dims named "expert" split over
    ``model``, every other logical axis whole (ROADMAP A16b), and E that
    the ``model`` axis does not divide raises."""
    from repro_torch.distributed.sharding import placement
    mesh = _Shape(data=4, model=2)
    assert tuple(placement(mesh, (None, "expert", "fsdp", None)).spec) == (
        None, "model", None, None)
    for axes in (("tensor", "fsdp"), ("batch", "tensor"), (None, "kv_seq")):
        assert placement(mesh, axes, (8, 8)).spec == (None, None)
    with pytest.raises(ValueError, match="does not split"):
        placement(_Shape(data=1, model=3), (None, "expert", None),
                  (2, 8, 4))


def test_production_mesh_needs_its_world_size():
    with pytest.raises(ValueError, match="256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="512 ranks"):
        make_production_mesh(multi_pod=True)
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_host_mesh(data=1, model=1)


def test_flash_decode_cells_count_the_dense_program(monkeypatch):
    """The decode cells name ``flash_decode`` as the reference's do; with
    no mesh it is the dense backend, so a traced step counts the same
    products, bytes and peak as on ``dense``."""
    flash = dryrun.run_cell("qwen2_1_5b", "long_500k")
    monkeypatch.setenv("REPRO_PERF_OVERRIDES", "decode_backend=dense")
    dense = dryrun.run_cell("qwen2_1_5b", "long_500k")
    assert flash["ok"] and dense["ok"]
    assert flash["cost"] == dense["cost"]
    assert flash["memory"] == dense["memory"]
    assert flash["meta"] == dense["meta"]


# ------------------------------------------------------------- spawned ranks
JAX_REFS = """
    import sys, dataclasses
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.models import transformer as tx, moe as M
    from repro.distributed.sharding import sharding_ctx
    from repro.serving.sampler import _sharded_argmax
    d = dict(np.load(sys.argv[1]))
    mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"))
    def tree(prefix):
        out = {}
        for k, v in d.items():
            if k.startswith(prefix + "/"):
                node = out
                parts = k[len(prefix) + 1:].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(v)
        return out
    out = {}
    for case in ("a", "b"):
        cfg = tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                   n_kv_heads=int(d[case + "/K"]), d_ff=128,
                                   vocab_size=97, max_seq_len=64)
        params = tree(case + "/params")
        cache = {n: jnp.asarray(d[f"{case}/{n}"]) for n in ("k", "v")}
        args = [jnp.asarray(d[f"{case}/{n}"])
                for n in ("lens", "toks", "pos", "mask")]
        c, l = tx.tree_step(cfg, params, dict(cache), *args)
        out[case + "/dense_logits"] = np.asarray(l)
        out[case + "/dense_k"] = np.asarray(c["k"])
        cfg2 = dataclasses.replace(cfg, decode_backend="flash_decode")
        with sharding_ctx(mesh):
            c, l = jax.jit(lambda c, *a: tx.tree_step(cfg2, params, c, *a))(
                dict(cache), *args)
        out[case + "/flash_logits"] = np.asarray(l)
        out[case + "/flash_k"] = np.asarray(c["k"])
        out[case + "/flash_v"] = np.asarray(c["v"])
    # the fused step on case b's sequence-sharded cache (cache_lens 6), and
    # prefill with cache=None, both through the reference's flash decode
    from repro.configs import lm_common as LC
    cfg = tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                               n_kv_heads=1, d_ff=128, vocab_size=97,
                               max_seq_len=64, decode_backend="flash_decode")
    params = tree("b/params")
    cache = {n: jnp.asarray(d["b/" + n]) for n in ("k", "v")}
    args = [jnp.asarray(d["commit/" + n]) for n in
            ("lens", "toks", "pos", "mask", "parent", "n_live")]
    with sharding_ctx(mesh):
        c, packed = jax.jit(LC._serve_fn(cfg))(params, dict(cache), *args)
        out["commit/packed"] = np.asarray(packed)
        out["commit/k"], out["commit/v"] = np.asarray(c["k"]), np.asarray(
            c["v"])
        c, l = jax.jit(lambda t, n: tx.prefill(cfg, params, t, n))(
            jnp.asarray(d["prefill/toks"]), jnp.asarray(d["prefill/lens"]))
        out["prefill/logits"] = np.asarray(l)
        out["prefill/k"], out["prefill/v"] = np.asarray(c["k"]), np.asarray(
            c["v"])
    x, wr, wg, wu, wd = (jnp.asarray(d["moe/" + n])
                         for n in ("x", "wr", "wg", "wu", "wd"))
    k = int(d["moe/k"])
    for cf in (8.0, 1.0):
        ep = lambda w: M.moe_ep(x, wr, w, wu, wd, k, cf, mesh)
        out[f"moe/out_{cf}"] = np.asarray(jax.jit(ep)(wg))
        out[f"moe/grad_{cf}"] = np.asarray(
            jax.jit(jax.grad(lambda w: ep(w).sum()))(wg))
    with sharding_ctx(mesh):
        out["argmax"] = np.asarray(jax.jit(_sharded_argmax)(
            jnp.asarray(d["argmax/logits"])))
    np.savez(sys.argv[2], **out)
"""


def _inputs():
    """Every input of the spawned ranks and the JAX subprocess, from one
    numpy seed (the flash cases' weights from the reference's
    ``init_params``)."""
    rng = np.random.RandomState(0)
    d = {}
    for case, K, B, lens in (("a", 4, 4, [10, 7, 33, 58]), ("b", 1, 1, [3])):
        cfg = ref_tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                       n_kv_heads=K, d_ff=128, vocab_size=97,
                                       max_seq_len=64)
        params = jax.tree.map(np.asarray, jax.jit(
            ref_tx.init_params, static_argnums=0)(cfg, jax.random.key(K)))

        def put(prefix, t):
            for k, v in t.items():
                if isinstance(v, dict):
                    put(f"{prefix}/{k}", v)
                else:
                    d[f"{prefix}/{k}"] = v
        put(f"{case}/params", params)
        T = 5
        d[f"{case}/K"] = np.array(K)
        d[f"{case}/k"] = (rng.randn(2, B, 64, K, 8) * 0.3).astype(np.float32)
        d[f"{case}/v"] = (rng.randn(2, B, 64, K, 8) * 0.3).astype(np.float32)
        d[f"{case}/lens"] = np.array(lens, np.int32)
        d[f"{case}/toks"] = rng.randint(1, 97, (B, T)).astype(np.int32)
        depth = np.array([[0, 1, 1, 2, 2]] * B, np.int32)
        d[f"{case}/pos"] = d[f"{case}/lens"][:, None] + depth
        parent = [-1, 0, 0, 1, 2]
        m = np.zeros((T, T), bool)
        for i in range(T):
            j = i
            while j >= 0:
                m[i, j] = True
                j = parent[j]
        d[f"{case}/mask"] = np.stack([m] * B)
    _commit_inputs(d)
    d["prefill/toks"] = rng.randint(1, 97, (2, 64)).astype(np.int32)
    d["prefill/lens"] = np.array([40, 23], np.int32)
    N, D, E, F, k = 96, 16, 8, 24, 2
    d["moe/x"] = rng.randn(N, D).astype(np.float32)
    d["moe/wr"] = (rng.randn(D, E) * 0.3).astype(np.float32)
    for n, shape in (("wg", (E, D, F)), ("wu", (E, D, F)), ("wd", (E, F, D))):
        d["moe/" + n] = (rng.randn(*shape) * 0.2).astype(np.float32)
    d["moe/k"] = np.array(k)
    logits = rng.randn(4, 3, 96).astype(np.float32)
    logits[0, 0, [10, 60]] = 9.0          # a tie across the vocab blocks
    logits[1, 2, [50, 51, 90]] = 9.0      # inside one block and across
    logits[3, 1, :] = 0.0                 # all equal
    d["argmax/logits"] = logits
    return d


def _commit_inputs(d):
    """The fused step's arguments for case b at cache_lens 6: a tree of 5
    slots (parents -1, 0, 0, 2, 2) whose tokens make the reference's dense
    step accept slots 0, 2, 4 (slot 1 and 3 take a token it does not
    choose)."""
    cfg = ref_tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                   n_kv_heads=1, d_ff=128, vocab_size=97,
                                   max_seq_len=64)
    params = {}
    for k, v in d.items():
        if k.startswith("b/params/"):
            node = params
            parts = k[len("b/params/"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jax.numpy.asarray(v)
    cache = {n: jax.numpy.asarray(d["b/" + n]) for n in ("k", "v")}
    T = 5
    lens = np.array([6], np.int32)
    parent = np.array([[-1, 0, 0, 2, 2]], np.int32)
    depth = np.array([[0, 1, 1, 2, 2]], np.int32)
    m = np.zeros((T, T), bool)
    for i in range(T):
        j = i
        while j >= 0:
            m[i, j] = True
            j = int(parent[0, j])
    pos = lens[:, None] + depth
    toks = np.full((1, T), 3, np.int32)
    step = jax.jit(lambda t: ref_tx.tree_step(cfg, params, dict(cache), lens,
                                              t, pos, m[None])[1])
    V = cfg.vocab_size
    for _ in range(3):          # slot 2 and 4 take the model's choice
        ch = np.asarray(step(toks)).argmax(-1)[0]
        toks[0, 1:] = [(ch[0] + 1) % V, ch[0], (ch[2] + 1) % V, ch[2]]
    for n, a in (("lens", lens), ("toks", toks), ("pos", pos),
                 ("mask", m[None]), ("parent", parent),
                 ("n_live", np.array([T], np.int32))):
        d["commit/" + n] = a


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Inputs, the JAX subprocess's references (run beside the ranks), the
    8 ranks' results and the 4 ranks' restores."""
    directory = str(tmp_path_factory.mktemp("dist"))
    d = _inputs()
    np.savez(os.path.join(directory, "inputs.npz"), **d)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    refs_path = os.path.join(directory, "refs.npz")
    jax_proc = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(JAX_REFS),
         os.path.join(directory, "inputs.npz"), refs_path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        tmp.start_processes(ranks.world8, args=(directory,), nprocs=8,
                            join=True, start_method="spawn")
        tmp.start_processes(ranks.world4, args=(directory,), nprocs=4,
                            join=True, start_method="spawn")
        out, err = jax_proc.communicate(timeout=300)
    finally:
        if jax_proc.poll() is None:
            jax_proc.kill()
            jax_proc.communicate()
    assert jax_proc.returncode == 0, out + err
    return dict(inputs=d, refs=dict(np.load(refs_path)), dir=directory,
                res=[torch.load(os.path.join(directory, f"rank{r}.pt"),
                                weights_only=False) for r in range(8)],
                restored=[torch.load(os.path.join(directory,
                                                  f"restored{r}.pt"),
                                     weights_only=False) for r in range(4)])


@pytest.mark.parametrize("case,spec", [
    ("a", (None, "data", None, "model", None)),         # B 4: batch, heads
    ("b", (None, None, ("data", "model"), None, None)),  # B 1, K 1: sequence
])
def test_flash_decode_tree_step_equals_the_references(spawned, case, spec):
    """Each rank held its flash-decode step against the port's dense
    ``tree_step`` (atol 3e-5, the reference's test's); here rank 0's
    logits and gathered cache against the JAX dense ``tree_step`` and the
    JAX flash decode on the Auto mesh, at the same tolerance.  Case b's
    cache_lens 3 leaves seven of its eight shards no visible key."""
    r0, refs = spawned["res"][0], spawned["refs"]
    assert tuple(r0[f"{case}/spec"]) == spec
    for r in spawned["res"][1:]:
        assert torch.equal(r[f"{case}/logits"], r0[f"{case}/logits"])
    got = r0[f"{case}/logits"].numpy()
    np.testing.assert_allclose(got, refs[f"{case}/dense_logits"], atol=3e-5)
    np.testing.assert_allclose(got, refs[f"{case}/flash_logits"], atol=3e-5)
    for n in ("k", "v"):
        np.testing.assert_allclose(r0[f"{case}/{n}"].numpy(),
                                   refs[f"{case}/flash_{n}"], atol=3e-5)
    np.testing.assert_allclose(r0[f"{case}/k"].numpy(),
                               refs[f"{case}/dense_k"], atol=3e-5)


def test_fused_step_commit_crosses_a_shard_boundary(spawned):
    """``lm_common._serve_fn`` on the sequence-sharded cache: the packed
    result equals the step without a mesh (each rank checked it and its
    committed rows, atol 3e-5) and the reference's ``_serve_fn`` through
    its flash decode on the Auto mesh; so do rank 0's gathered committed
    K/V rows (atol 3e-5).  The accepted slots 0, 2, 4 moved rows across
    the boundary of shards 0 and 1."""
    r0, refs = spawned["res"][0], spawned["refs"]
    packed = [r["commit/packed"] for r in spawned["res"]]
    assert all(torch.equal(p, packed[0]) for p in packed)
    T = 5
    assert packed[0][0, 0] == 3
    assert packed[0][0, 1 + T:1 + T + 3].tolist() == [0, 2, 4]
    np.testing.assert_array_equal(packed[0].numpy(), refs["commit/packed"])
    for n in ("k", "v"):
        np.testing.assert_allclose(r0[f"commit/{n}"].numpy(),
                                   refs[f"commit/{n}"], atol=3e-5)


def test_prefill_under_the_mesh_keeps_the_ranks_block(spawned):
    """Each rank's prefill kept its block of the sequence-sharded cache
    (equal to its block of the prefill without a mesh); rank 0's gathered
    cache and logits equal the reference's prefill under the Auto mesh
    (atol 3e-5)."""
    assert all(r["prefill/block_shape"] == (2, 2, 8, 1, 8)
               for r in spawned["res"])
    r0, refs = spawned["res"][0], spawned["refs"]
    for n in ("k", "v", "logits"):
        np.testing.assert_allclose(r0[f"prefill/{n}"].numpy(),
                                   refs[f"prefill/{n}"], atol=3e-5)


@pytest.mark.parametrize("cf", [8.0, 1.0])
def test_moe_ep_and_its_gradient_equal_the_reference(spawned, cf):
    """Output (atol 1e-4) and d sum / d we_gate against ``jax.grad`` of the
    reference's ``moe_ep``; at capacity factor 1.0 tokens drop (fewer rows
    fit than the router sends), and the port drops the same ones."""
    refs, d = spawned["refs"], spawned["inputs"]
    n_exp = d["moe/wg"].shape[0]
    El = n_exp // 2
    for r in spawned["res"]:
        np.testing.assert_allclose(r[f"moe/out_{cf}"].numpy(),
                                   refs[f"moe/out_{cf}"], atol=1e-4)
        m = r["moe/model_index"]
        np.testing.assert_allclose(r[f"moe/grad_{cf}"].numpy(),
                                   refs[f"moe/grad_{cf}"][m * El:(m + 1) * El],
                                   atol=1e-4)
    if cf == 1.0:       # tokens dropped: the output is not moe_ref's
        x, wr = torch.from_numpy(d["moe/x"]), torch.from_numpy(d["moe/wr"])
        from repro_torch.models import moe
        full = moe.moe_ref(x, wr, *(torch.from_numpy(d["moe/" + n])
                                    for n in ("wg", "wu", "wd")), 2)
        assert (full - spawned["res"][0]["moe/out_1.0"]).abs().max() > 1e-2


def test_sharded_argmax_takes_the_first_maximum(spawned):
    d, refs = spawned["inputs"], spawned["refs"]
    want = d["argmax/logits"].argmax(-1)
    assert want[0, 0] == 10 and want[1, 2] == 50 and want[3, 1] == 0
    for r in spawned["res"]:
        np.testing.assert_array_equal(r["argmax"].numpy(), want)
    np.testing.assert_array_equal(refs["argmax"], want)


def test_init_params_and_shard_params_give_the_expert_blocks(spawned):
    """Each rank checked its expert blocks bit for bit against the
    single-device draw, sliced."""
    assert all(r["params/we_gate_shape"] == (2, 4, 32, 16)
               for r in spawned["res"])


def test_checkpoint_saved_on_8_ranks_restores_onto_4(spawned):
    """The twin of the reference's ``test_elastic_checkpoint_reshard_8dev``,
    placed where the port keeps each leaf (``placement``): saved under
    (data 4, model 2), restored under (data 2, model 2).  The leaf with
    logical axes ("batch", "tensor"), which the reference would restore as
    (4, 4) blocks, is whole on every rank in the port and written once,
    whole.  Qwen3-MoE's smoke parameters, drawn with each rank's expert
    blocks, are written as the single-device arrays; each restoring rank
    got ``shard_params``' blocks bit for bit and ran the forward through
    ``moe_ep`` on them, equal to ``moe_ref``'s without a mesh (atol
    1e-4)."""
    from repro_torch.distributed.sharding import named_sharding
    from repro_torch.models.params import init_params
    x = np.arange(64.0).reshape(8, 8)
    with np.load(os.path.join(spawned["dir"], "ckpt", "step_0000000001",
                              "arrays.npz")) as npz:
        saved = dict(npz)
    np.testing.assert_array_equal(saved["w"], x)
    whole = init_params(ranks.ckpt_cfg(), seed=3, device="cpu")
    for name, a in whole["layers"].items():
        np.testing.assert_array_equal(saved[f"p/layers/{name}"], a.numpy())
    np.testing.assert_array_equal(saved["p/embed"], whole["embed"].numpy())
    E = ranks.ckpt_cfg().n_experts
    for r in spawned["restored"]:
        assert r["step"] == 1
        np.testing.assert_array_equal(r["w"], x)
        assert r["we_gate"][1] == E // 2
        torch.testing.assert_close(r["logits"],
                                   spawned["restored"][0]["logits"],
                                   atol=1e-4, rtol=0)
    mesh = _Shape(data=2, model=2)
    assert named_sharding(mesh, ("batch", "tensor"), (8, 8)).shard_shape(
        (8, 8)) == (4, 4)


def test_sharding_ctx_without_a_mesh_changes_nothing():
    """Under ``sharding_ctx(None)`` the flash backend, the MoE dispatch and
    the argmax are the single-device ones."""
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.models import transformer as tx
    from repro_torch.serving.sampler import _sharded_argmax
    cfg = ranks.flash_cfg(2, "flash_decode")
    with sharding_ctx(None):
        assert tx.cache_sharding(cfg, 1) is None
        assert tx.init_cache(cfg, 1)["k"].shape == (2, 1, 64, 2, 8)
        lg = torch.randn(2, 3, 10)
        assert torch.equal(_sharded_argmax(lg), lg.argmax(-1).int())
    moe_cfg = dataclasses.replace(ranks.moe_cfg(), moe_impl="ep")
    from repro_torch.models.params import init_params
    params = init_params(moe_cfg, device="cpu")
    with pytest.raises(ValueError, match="mesh"):
        tx.prefill(moe_cfg, params, torch.ones((1, 8), dtype=torch.int32),
                   torch.tensor([8], dtype=torch.int32),
                   tx.init_cache(moe_cfg, 1))
