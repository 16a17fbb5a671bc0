"""The port's multi-rank paths (repro_torch.distributed, ``moe_ep``,
``_sharded_argmax``, the dense LM's placement, the elastic checkpoint) on
the CPU, against the JAX package's sharded functions.

The rule translation (``logical_spec``, ``_derive_axes``,
``cache_partition_spec``) is held against the reference's on stand-in
meshes that have only ``.shape`` (and, for ``Layout``, a rank's
coordinates).  The sharded programs run in one spawn of 8 gloo ranks on
(data 4, model 2), (data 2, model 4) and (data 1, model 8) meshes
(``tests/torch_dist_ranks.py``), which checks them against the port's
single-device paths; their outputs are then held against the reference's
programs, run once in a JAX subprocess with 8 host devices on meshes with
Auto axes (``jax.make_mesh`` builds Explicit axes under jax 0.9, where the
reference's own 8-device tests fail): its ``shard_map`` programs, and its
prefill, tree step and fused step partitioned by GSPMD from parameters
placed with ``named_sharding`` under ``DEFAULT_RULES`` or the serve cells'
``override(fsdp=())`` (also with query heads that split off one KV
head), and its ``make_train_step`` jitted with the ``in_shardings`` of
``tree_shardings`` under the train_4k cells' rules (the residual split
along the sequence over ``model``; dense and MoE through ``moe_ep``), and
EquiformerV2 jitted under its rules, in a second JAX subprocess beside the
first (``JAX_GNN_REFS``).  A
second spawn of 4 ranks restores the checkpoints the first saved
(parameters, and a train state it then steps on), and one the JAX
package saved, onto (data 2, model 2), and runs the train CLI inside
``sharding_ctx``; a third of 2 ranks resumes that CLI run on (data 1,
model 2).
"""
import dataclasses
import json
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
from repro_torch.distributed.sharding import (DEFAULT_RULES, TracedMesh,
                                              logical_spec, ring_bytes)
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


def test_placement_splits_the_expert_fsdp_and_tensor_dims():
    """The port's one placement rule: the dims named "expert", "fsdp" and
    "tensor" split over the mesh axes the rules give them, every other
    logical axis whole; an axis that does not divide an "fsdp" or
    "tensor" dim is dropped (that dim whole), as ``logical_spec(shape=)``
    drops it, and an E that the ``model`` axis does not divide raises."""
    from repro_torch.distributed.sharding import placement
    mesh = _Shape(data=4, model=2)
    assert tuple(placement(mesh, (None, "expert", "fsdp", None)).spec) == (
        None, "model", "data", None)
    assert tuple(placement(mesh, ("tensor", "fsdp"), (8, 8)).spec) == (
        "model", "data")
    assert tuple(placement(mesh, ("tensor", "fsdp"), (97, 8)).spec) == (
        None, "data")
    assert tuple(placement(mesh, (None, "fsdp", "tensor"), (2, 6, 8),
                           DEFAULT_RULES.override(fsdp=())).spec) == (
        None, None, "model")
    for axes in (("batch", "kv_heads"), ("vocab_act", None),
                 (None, "kv_seq")):
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


def test_production_mesh_traces_a_rank_without_a_world():
    """``make_production_mesh(rank=)``: that rank of (16, 16) or (2, 16,
    16) as a ``TracedMesh``, with no world behind it: its coordinates and
    groups are row-major, as a real mesh's; its collectives return the
    real ones' shapes on meta tensors and count what they would hand the
    backend, by kind and group."""
    for multi_pod, rank, coords in ((False, 37, dict(data=2, model=5)),
                                    (True, 300, dict(pod=1, data=2,
                                                     model=12))):
        m = make_production_mesh(multi_pod=multi_pod, rank=rank)
        assert isinstance(m, TracedMesh)
        assert (m.size, m.rank, m.coords()) == (512 if multi_pod else 256,
                                                rank, coords)
        row = rank - rank % 16
        assert m.group("model") == (None, list(range(row, row + 16)))
        pod = rank - rank % 256
        assert m.group("data")[1] == [pod + rank % 16 + 16 * i
                                      for i in range(16)]
        x = torch.empty(4, 6, dtype=torch.bfloat16, device="meta")
        assert m.all_gather(x, "data").shape == (16, 4, 6)
        assert m.all_reduce(x, "sum", ("model",)).shape == (4, 6)
        assert m.all_to_all(x.repeat(4, 1), ("model",)).shape == (16, 6)
        assert m.all_reduce(x, "max", ()).shape == (4, 6)   # a group of one
        got = {(r["kind"], r["group"], r["calls"], r["bytes"])
               for r in m.collective_records()}
        assert got == {("all-gather", 16, 1, 16 * 48),
                       ("all-reduce", 16, 1, 48),
                       ("all-to-all", 16, 1, 16 * 12)}
        total, kind = ring_bytes(m.collective_records())
        assert kind["all-gather"] == 15 / 16 * 16 * 48
        assert kind["all-reduce"] == 2 * 15 / 16 * 48
        assert total == kind["all-gather"] + kind["all-reduce"] + \
            kind["all-to-all"]
        m.reset_counts()
        assert m.collective_records() == []


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
    # the dense LM placed by the rules and partitioned by GSPMD: prefill,
    # a tree step and the fused step on each placement case
    import json
    from repro.distributed.sharding import DEFAULT_RULES, named_sharding
    from repro.serving.sampler import choose_tokens
    rule_sets = {"default": DEFAULT_RULES,
                 "serve": DEFAULT_RULES.override(fsdp=())}
    tp = {n: jnp.asarray(d["tp/" + n]) for n in ("toks", "lens", "tables")}
    for name, (data, model, rname, V, K, layout, backend, H) in json.loads(
            str(d["tp/cases"])).items():
        mesh = Mesh(np.array(jax.devices()).reshape(data, model),
                    ("data", "model"))
        rules = rule_sets[rname]
        key = f"w{V}_{K}" if H == 8 else f"w{V}_{K}h{H}"
        cfg = tx.TransformerConfig(
            n_layers=2, d_model=64, n_heads=H, head_dim=8, n_kv_heads=K,
            d_ff=128, vocab_size=V, max_seq_len=64, kv_layout=layout,
            kv_block_size=16,
            decode_backend="flash_decode" if backend == "flash_decode"
            else "dense")

        def place(t, ax):
            if isinstance(t, dict):
                return {k: place(t[k], ax[k]) for k in t}
            return jax.device_put(t, named_sharding(mesh, ax, t.shape,
                                                    rules))
        params = place(tree(f"{key}/params"), tx.param_logical_axes(cfg))
        args = [jnp.asarray(d[f"{key}/{n}"])
                for n in ("ctoks", "pos", "mask", "parent", "n_live")]

        def run(params, toks, lens, tables, ctoks, pos, mask, parent,
                n_live):
            if layout == "paged":
                cache = tx.init_paged_cache(cfg, 4, 17)
                cache["block_tables"] = tables
                cache, l_pre = tx.prefill_paged(cfg, params, toks, lens,
                                                cache)
                c1, l_tree = tx.tree_step_paged(cfg, params, cache, lens,
                                                ctoks, pos, mask)
            else:
                cache, l_pre = tx.prefill(cfg, params, toks, lens)
                c1, l_tree = tx.tree_step(cfg, params, cache, lens, ctoks,
                                          pos, mask)
            chosen = choose_tokens(l_tree, pos + 1)
            n_acc, acc, kvs = tx.verify_accept_device(ctoks, parent, n_live,
                                                      chosen)
            if layout == "paged":
                c2, _ = tx.commit_paged_cache(cfg, c1, lens, kvs, n_acc)
            else:
                c2, _ = tx.commit_cache(c1, lens, kvs, n_acc)
            return (l_pre, cache["k"], cache["v"], l_tree,
                    tx.pack_step_result(n_acc, acc, kvs), c2["k"], c2["v"])
        with sharding_ctx(mesh, rules):
            got = jax.jit(run)(params, tp["toks"], tp["lens"], tp["tables"],
                               *args)
        for key, a in zip(("pre_logits", "pre_k", "pre_v", "tree_logits",
                           "packed", "k", "v"), got):
            out[f"{name}/{key}"] = np.asarray(a)
    # the train step as the reference's dry-run compiles train_4k: jitted
    # with in_shardings from tree_shardings (the moments by opt_state_axes)
    # on an Auto mesh, under the rules, two steps from adamw_init
    from repro.configs.common import opt_state_axes, tree_shardings
    from repro.training.optimizer import adamw_init
    from repro.training.train_step import make_train_step
    rule_sets["train"] = DEFAULT_RULES.override(residual_seq=("model",))
    def flat(prefix, t):
        for k, v in t.items():
            if isinstance(v, dict):
                flat(f"{prefix}/{k}", v)
            else:
                out[f"{prefix}/{k}"] = np.asarray(v)
    ttoks = d["train/toks"]
    def train_ref(tag, cfg, params, data, model, rname, accum, gdt):
        mesh = Mesh(np.array(jax.devices()).reshape(data, model),
                    ("data", "model"))
        rules = rule_sets[rname]
        opt = adamw_init(params)
        step = make_train_step(
            lambda p, b, cfg=cfg: tx.lm_loss(cfg, p, b["tokens"],
                                             b["labels"]),
            lr=3e-4, grad_dtype=gdt, accum_steps=accum)
        batches = [{"tokens": jnp.asarray(t[:, :-1]),
                    "labels": jnp.asarray(t[:, 1:])} for t in ttoks]
        p_axes = tx.param_logical_axes(cfg)
        shardings = tree_shardings(
            mesh, (params, opt, batches[0]),
            (p_axes, opt_state_axes(p_axes),
             {"tokens": ("batch", None), "labels": ("batch", None)}), rules)
        with sharding_ctx(mesh, rules):
            fn = jax.jit(step, in_shardings=shardings)
            for i, b in enumerate(batches):
                params, opt = jax.device_put((params, opt), shardings[:2])
                params, opt, m = fn(params, opt, b)
                out[f"{tag}/loss{i}"] = np.asarray(m["loss"])
                out[f"{tag}/norm{i}"] = np.asarray(m["grad_norm"])
        flat(f"{tag}/p", params)
        flat(f"{tag}/mu", opt.mu)
        flat(f"{tag}/nu", opt.nu)
        out[f"{tag}/step"] = np.asarray(opt.step)
    for name, (data, model, rname, K, accum, gdt, remat) in json.loads(
            str(d["train/cases"])).items():
        cfg = tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                   n_kv_heads=K, d_ff=128, vocab_size=96,
                                   max_seq_len=64, remat=remat)
        train_ref(f"train/{name}", cfg, tree(f"w96_{K}/params"), data,
                  model, rname, accum, gdt)
    # the MoE cases: moe_ep inside the GSPMD step (its shard_map takes the
    # global (lane, position)-ordered tokens over data x model)
    for name, (data, model, rname, shared, cf, impl) in json.loads(
            str(d["moe_train/cases"])).items():
        cfg = tx.TransformerConfig(
            n_layers=2, d_model=64, n_heads=8, n_kv_heads=4, d_ff=0,
            vocab_size=96, max_seq_len=64, moe=True, n_experts=8, top_k=2,
            moe_d_ff=32, n_shared_experts=shared, capacity_factor=cf,
            moe_impl=impl)
        train_ref(f"moe_train/{name}", cfg, tree(f"moe{shared}/params"),
                  data, model, rname, 1, None)
    # the recommenders: parameters placed by named_sharding under
    # DEFAULT_RULES (tables' rows over model, the encoders' "tensor" dims),
    # inputs on "batch" / "candidates", the serve cells and two train steps
    # jitted on the Auto mesh, as the reference's dry-run places its cells
    from repro.models.recsys import (wide_deep as RW, two_tower as RT,
                                     sasrec as RS, bert4rec as RB)
    from repro.configs import (wide_deep as CW, two_tower_retrieval as CT,
                               sasrec as CS, bert4rec as CB)
    rs_mods = {"wide_deep": (RW, CW), "two_tower_retrieval": (RT, CT),
               "sasrec": (RS, CS), "bert4rec": (RB, CB)}
    in_axes = {"user1": (None, None), "cand_emb": ("candidates", None),
               "negatives": (None,)}
    for name, (mname, data, model) in json.loads(
            str(d["rs/cases"])).items():
        mesh = Mesh(np.array(jax.devices()).reshape(data, model),
                    ("data", "model"))
        M, C = rs_mods[mname]
        cfg = C.smoke_config()
        pre = f"rs/{mname}"

        def put(t, ax):
            if isinstance(t, dict):
                return {k: put(t[k], ax[k]) for k in t}
            return jax.device_put(t, named_sharding(mesh, ax, t.shape,
                                                    DEFAULT_RULES))

        def inp(k):
            a = jnp.asarray(d[f"{pre}/{k}"])
            ax = in_axes.get(k.split("/")[-1], ("batch",) + (None,) * (
                a.ndim - 1))
            return put(a, ax)
        p_axes = M.param_logical_axes(cfg)
        params = put(tree(f"{pre}/params"), p_axes)
        with sharding_ctx(mesh, DEFAULT_RULES):
            if mname == "wide_deep":
                got = {"scores": jax.jit(
                    lambda p, *a: M.forward(cfg, p, *a))(
                        params, inp("ids"), inp("mask"), inp("dense"))}
            elif mname == "two_tower_retrieval":
                f = jax.jit(lambda p, u, i: (
                    M.user_embed(cfg, p, u), M.item_embed(cfg, p, i)))
                q, e = f(params, inp("users"), inp("items"))
                v, ix = jax.jit(lambda p, u, c: M.score_candidates(
                    cfg, p, u, c, k=int(d["rs/k"])))(params, inp("user1"),
                                                     inp("cand_emb"))
                got = {"user": q, "item": e, "paired": jnp.sum(q * e, -1),
                       "top_v": v, "top_i": ix}
            else:
                f = jax.jit(lambda p, *a: M.serve(cfg, p, *a))
                got = {"rank": f(params, inp("ids"), inp("pad"),
                                 inp("cand")),
                       "catalog": f(params, inp("ids1"), inp("pad1"))}
        for k, v in got.items():
            out[f"rs/{name}/{k}"] = np.asarray(v)
        keys = sorted(k[len(pre) + 4:] for k in d
                      if k.startswith(pre + "/t0/"))
        batches = [{k: jnp.asarray(d[f"{pre}/t{i}/{k}"]) for k in keys}
                   for i in range(2)]
        b_axes = {k: in_axes.get(k, ("batch",) + (None,) * (
            batches[0][k].ndim - 1)) for k in keys}
        tree_ = tree(f"{pre}/params")
        opt = adamw_init(tree_)
        step = make_train_step(lambda p, b: M.loss(cfg, p, b), lr=1e-3,
                               grad_dtype="bfloat16")
        shardings = tree_shardings(mesh, (tree_, opt, batches[0]),
                                   (p_axes, opt_state_axes(p_axes), b_axes),
                                   DEFAULT_RULES)
        with sharding_ctx(mesh, DEFAULT_RULES):
            fn = jax.jit(step, in_shardings=shardings)
            for i, b in enumerate(batches):
                tree_, opt = jax.device_put((tree_, opt), shardings[:2])
                tree_, opt, m = fn(tree_, opt, b)
                out[f"rs/{name}/loss{i}"] = np.asarray(m["loss"])
                out[f"rs/{name}/norm{i}"] = np.asarray(m["grad_norm"])
        flat(f"rs/{name}/p", tree_)
        flat(f"rs/{name}/mu", opt.mu)
        flat(f"rs/{name}/nu", opt.nu)
    np.savez(sys.argv[2], **out)
"""


JAX_GNN_REFS = """
    import sys, dataclasses, json
    import numpy as np, jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.configs import equiformer_v2 as CE
    from repro.configs.common import opt_state_axes, tree_shardings
    from repro.distributed.sharding import (DEFAULT_RULES, named_sharding,
                                            sharding_ctx)
    from repro.models.gnn import equiformer as EQ
    from repro.training.optimizer import adamw_init
    from repro.training.train_step import make_train_step
    d = dict(np.load(sys.argv[1]))
    out = {}

    def tree(prefix):
        res = {}
        for k, v in d.items():
            if k.startswith(prefix + "/"):
                node = res
                parts = k[len(prefix) + 1:].split("/")
                for p in parts[:-1]:
                    node = node.setdefault(p, {})
                node[parts[-1]] = jnp.asarray(v)
        return res

    def flat(prefix, t):
        for k, v in t.items():
            if isinstance(v, dict):
                flat(f"{prefix}/{k}", v)
            else:
                out[f"{prefix}/{k}"] = np.asarray(v)

    # EquiformerV2 under the reference's rules (src and dst on "edges", the
    # residual on "nodes", the SO(2) and FFN weights on "tensor"): its
    # parameters and its edge inputs placed by named_sharding under
    # DEFAULT_RULES, the node inputs whole, as its cells place them; the
    # forward, the loss and its gradient, and two train steps jitted on
    # the Auto mesh
    gnn_axes = {"edges": ("edges", None), "edge_mask": ("edges",)}
    for name, (lname, data, model, N, E, chunk) in json.loads(
            str(d["gnn/cases"])).items():
        mesh = Mesh(np.array(jax.devices()).reshape(data, model),
                    ("data", "model"))
        cfg = dataclasses.replace(CE.smoke_config(), edge_chunk=chunk)
        pre = f"gnn/{name}/"
        raw = {k[len(pre):]: jnp.asarray(v) for k, v in d.items()
               if k.startswith(pre)}
        b_axes = {k: gnn_axes.get(k, (None,) * v.ndim)
                  for k, v in raw.items()}

        def put(t, ax):
            if isinstance(t, dict):
                return {k: put(t[k], ax[k]) for k in t}
            return jax.device_put(t, named_sharding(mesh, ax, t.shape,
                                                    DEFAULT_RULES))
        p_axes = EQ.param_logical_axes(cfg)
        params, batch = put(tree("gnn/params"), p_axes), put(raw, b_axes)
        loss = lambda p, b, f=getattr(EQ, lname): f(cfg, p, b)
        G = int(d["gnn/graphs"]) if "graph_ids" in raw else 1

        def fwd_and_grad(p, b):
            return EQ.forward(cfg, p, b["node_feat"], b["positions"],
                              b["edges"], b["edge_mask"],
                              graph_ids=b.get("graph_ids"),
                              n_graphs=G), jax.value_and_grad(loss)(p, b)
        with sharding_ctx(mesh, DEFAULT_RULES):
            o, (v, g) = jax.jit(fwd_and_grad)(params, batch)
        for k in ("node_out", "graph_out", "l1_feats"):
            out[f"gnn/{name}/{k}"] = np.asarray(o[k])
        out[f"gnn/{name}/loss"] = np.asarray(v)
        flat(f"gnn/{name}/grad", g)
        tree_ = tree("gnn/params")
        opt = adamw_init(tree_)
        step = make_train_step(loss, lr=3e-4, grad_dtype="bfloat16")
        shardings = tree_shardings(mesh, (tree_, opt, raw),
                                   (p_axes, opt_state_axes(p_axes), b_axes),
                                   DEFAULT_RULES)
        with sharding_ctx(mesh, DEFAULT_RULES):
            fn = jax.jit(step, in_shardings=shardings)
            for i in range(2):
                tree_, opt = jax.device_put((tree_, opt), shardings[:2])
                tree_, opt, m = fn(tree_, opt, raw)
                out[f"gnn/{name}/loss{i}"] = np.asarray(m["loss"])
                out[f"gnn/{name}/norm{i}"] = np.asarray(m["grad_norm"])
        flat(f"gnn/{name}/p", tree_)
        flat(f"gnn/{name}/mu", opt.mu)
        flat(f"gnn/{name}/nu", opt.nu)
    np.savez(sys.argv[2], **out)
"""


def _put(d, prefix, t):
    """A nested dict of arrays into ``d`` under flat ``prefix/...`` keys."""
    for k, v in t.items():
        if isinstance(v, dict):
            _put(d, f"{prefix}/{k}", v)
        else:
            d[f"{prefix}/{k}"] = v


TREE_PARENT = [-1, 0, 0, 1, 2]


def _tree_mask(parent):
    T = len(parent)
    m = np.zeros((T, T), bool)
    for i in range(T):
        j = i
        while j >= 0:
            m[i, j] = True
            j = parent[j]
    return m


def _placement_inputs(d, rng):
    """The placement cases' inputs: the reference's ``init_params`` at each
    (V, K, H), 4 prompts of 64 tokens (lens 40, 23, 33, 58), the paged
    block tables (4 blocks of 16 a lane), and per (V, K, H) a tree step at
    cache_lens = lens whose tokens the port's single-device step accepts
    along slots 0, 1, 3 (slot 2 takes a token it does not choose; lane 3
    is idle)."""
    from repro_torch.models import transformer as tx
    from repro_torch.models.params import params_from_jax
    d["tp/toks"] = rng.randint(1, 96, (4, 64)).astype(np.int32)
    d["tp/lens"] = np.array([40, 23, 33, 58], np.int32)
    d["tp/tables"] = (1 + np.arange(16)).reshape(4, 4).astype(np.int32)
    d["tp/cases"] = np.array(json.dumps(ranks.TP_CASES))
    lens = torch.from_numpy(d["tp/lens"])
    T = len(TREE_PARENT)
    pos = d["tp/lens"][:, None] + np.array([0, 1, 1, 2, 2], np.int32)
    mask = np.stack([_tree_mask(TREE_PARENT)] * 4)
    for V, K, H in sorted({(c[3], c[4], c[7])
                           for c in ranks.TP_CASES.values()}):
        jcfg = ref_tx.TransformerConfig(n_layers=2, d_model=64, n_heads=H,
                                        head_dim=8, n_kv_heads=K, d_ff=128,
                                        vocab_size=V, max_seq_len=64)
        seed = V + K + H - 8          # H 8: the keys these cases always had
        params = jax.tree.map(np.asarray, jax.jit(
            ref_tx.init_params, static_argnums=0)(jcfg, jax.random.key(seed)))
        key = ranks.wkey(V, K, H)
        _put(d, f"{key}/params", params)
        cfg = ranks.tp_cfg(V, K, H=H)
        tp = params_from_jax(cfg, params, device="cpu")
        cache, _ = tx.prefill(cfg, tp, torch.from_numpy(d["tp/toks"]), lens)
        # H 8's tokens from the shared stream, the others' from their own
        draw = rng if H == 8 else np.random.RandomState(V + K + H)
        toks = draw.randint(1, V, (4, T)).astype(np.int32)
        for _ in range(3):
            step = {n: c.clone() for n, c in cache.items()}
            ch = tx.tree_step(cfg, tp, step, lens, torch.from_numpy(toks),
                              torch.from_numpy(pos), torch.from_numpy(mask)
                              )[1].argmax(-1).numpy()
            toks[:, 1:] = np.stack([ch[:, 0], (ch[:, 0] + 1) % V, ch[:, 1],
                                    ch[:, 2]], 1)
        for n, a in (("ctoks", toks), ("pos", pos), ("mask", mask),
                     ("parent", np.array([TREE_PARENT] * 4, np.int32)),
                     ("n_live", np.array([T, T, T, 0], np.int32))):
            d[f"{key}/{n}"] = a


def _guide_inputs(d, rng, vocab=96, phase=2):
    """The guided bench model's continuation table (benchmarks/common.py)
    and the served prompts."""
    g = np.random.RandomState(1000 * phase)
    base = g.randint(2, vocab, size=(vocab,))
    spec = g.randint(2, vocab, size=(phase, vocab))
    shared = g.rand(phase, vocab) < 0.7
    d["guide/table"] = np.where(shared, base[None, :], spec).astype(np.int32)
    d["guide/prompts"] = np.array(json.dumps(
        [rng.randint(2, vocab, size=n).tolist()
         for n in (9, 14, 6, 11, 7, 12)]))


def _inputs():
    """Every input of the spawned ranks and the JAX subprocess, from one
    numpy seed (the weights from the reference's ``init_params``)."""
    rng = np.random.RandomState(0)
    d = {}
    for case, K, B, lens in (("a", 4, 4, [10, 7, 33, 58]), ("b", 1, 1, [3])):
        cfg = ref_tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                       n_kv_heads=K, d_ff=128, vocab_size=97,
                                       max_seq_len=64)
        params = jax.tree.map(np.asarray, jax.jit(
            ref_tx.init_params, static_argnums=0)(cfg, jax.random.key(K)))
        _put(d, f"{case}/params", params)
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
    _placement_inputs(d, rng)
    _guide_inputs(d, rng)
    d["train/toks"] = rng.randint(1, 96, (2, 8, 17)).astype(np.int32)
    d["train/cases"] = np.array(json.dumps(ranks.TRAIN_CASES))
    d["moe_train/cases"] = np.array(json.dumps(ranks.MOE_TRAIN_CASES))
    _recsys_inputs(d)
    _gnn_inputs(d)
    for shared in (0, 1):
        jcfg = ref_tx.TransformerConfig(
            n_layers=2, d_model=64, n_heads=8, n_kv_heads=4, d_ff=0,
            vocab_size=96, max_seq_len=64, moe=True, n_experts=8, top_k=2,
            moe_d_ff=32, n_shared_experts=shared)
        _put(d, f"moe{shared}/params", jax.tree.map(np.asarray, jax.jit(
            ref_tx.init_params, static_argnums=0)(jcfg,
                                                  jax.random.key(11))))
    return d


def _recsys_inputs(d):
    """The recommenders' cases: the reference's smoke parameters, serve
    inputs with ids at the row windows' edges, ids in [-V, 0) that wrap
    into another rank's window and ids out of range (NaN on every path),
    64 candidates with ties across the ranks' blocks, and two train
    batches of in-range ids (some negative)."""
    from repro.configs import (bert4rec as jb, sasrec as js,
                               two_tower_retrieval as jt, wide_deep as jw)
    from repro_torch.training import data as t_data
    rng = np.random.RandomState(30)
    B = ranks.RECSYS_B
    d["rs/cases"] = np.array(json.dumps(ranks.RECSYS_CASES))
    d["rs/k"] = np.array(ranks.RECSYS_K)
    for seed, (name, jmod) in enumerate((
            ("wide_deep", jw), ("two_tower_retrieval", jt),
            ("sasrec", js), ("bert4rec", jb))):
        cfg = jmod.smoke_config()
        _put(d, f"rs/{name}/params", jax.tree.map(np.asarray, jax.jit(
            jmod.model.init_params, static_argnums=0)(cfg, jax.random.key(
                20 + seed))))
        pre = f"rs/{name}"
        if name == "wide_deep":
            V, F, L = cfg.rows_per_table, cfg.n_sparse, cfg.multi_hot
            b = t_data.wide_deep_batch(rng, B, F, V, L, cfg.n_dense)
            ids = b["sparse_ids"]
            ids[0, :, :] = [255, 256, 511]       # model 2: windows of 256
            ids[1, :, :] = [127, 128, 383]       # model 4: windows of 128
            ids[2, :, 0], ids[2, :, 1] = -1, -300    # wrap to 511, 212
            ids[3, 0, 0], ids[4, 1, 2] = V + 5, -V - 1   # out of range
            b["sparse_mask"][3, 0, 0] = False    # NaN under the mask too
            d[f"{pre}/ids"], d[f"{pre}/mask"] = ids, b["sparse_mask"]
            d[f"{pre}/dense"] = b["dense"]
            for i in range(2):
                t = t_data.wide_deep_batch(rng, B, F, V, L, cfg.n_dense)
                t["sparse_ids"][i, :, 0] = -1 - i
                _put(d, f"{pre}/t{i}", t)
        elif name == "two_tower_retrieval":
            V = cfg.rows_per_table
            b = t_data.two_tower_batch(rng, B, cfg.n_user_fields,
                                       cfg.n_item_fields, V)
            b["user_ids"][0] = [127, 128, -1]    # model 2: windows of 128
            b["item_ids"][1] = [-129, V - 1]     # -129 wraps to 127
            b["item_ids"][2, 0] = V + 3          # out of range
            d[f"{pre}/users"], d[f"{pre}/items"] = (b["user_ids"],
                                                     b["item_ids"])
            d[f"{pre}/user1"] = b["user_ids"][5:6]
            cand = rng.randn(64, cfg.tower_dims[-1]).astype(np.float32)
            cand[[9, 40, 41]] = cand[50]         # ties across the blocks
            cand[[1, 63]] = cand[2]
            d[f"{pre}/cand_emb"] = cand
            for i in range(2):
                t = t_data.two_tower_batch(rng, B, cfg.n_user_fields,
                                           cfg.n_item_fields, V)
                t["item_ids"][i, 0] = -5
                _put(d, f"{pre}/t{i}", t)
        else:
            S, V = cfg.seq_len, cfg.n_items
            causal = name == "sasrec"
            b = t_data.seq_rec_batch(rng, B, S, V, causal)
            pad = b["pad_mask"].copy()
            pad[3, S // 2:] = False
            cand = rng.randint(0, V, (B, 8)).astype(np.int32)
            cand[0, :3] = [V // 2 - 1, V // 2, V - 1]    # windows' edges
            cand[1, 0], cand[2, 1] = -1, V + 7   # wrap; out of range
            d[f"{pre}/ids"], d[f"{pre}/pad"] = b["ids"], pad
            d[f"{pre}/cand"] = cand
            d[f"{pre}/ids1"], d[f"{pre}/pad1"] = b["ids"][:1], pad[:1]
            for i in range(2):
                t = t_data.seq_rec_batch(rng, B, S, V, causal)
                t["negatives"][:2] = [-1, -V // 2]
                _put(d, f"{pre}/t{i}", t)


def _gnn_inputs(d):
    """The GNN cases: the reference's smoke parameters and a random graph
    a case, with masked edges and zero-length padding edges (0 -> 0,
    masked) at the end and on both sides of the edge blocks' first
    boundaries at 8 and 4 blocks."""
    from repro.configs import equiformer_v2 as jcfg
    from repro.models.gnn import equiformer as jeq
    rng = np.random.RandomState(31)
    d["gnn/cases"] = np.array(json.dumps(ranks.GNN_CASES))
    d["gnn/graphs"] = np.array(ranks.GNN_GRAPHS)
    _put(d, "gnn/params", jax.tree.map(np.asarray, jax.jit(
        jeq.init_params, static_argnums=0)(jcfg.smoke_config(),
                                           jax.random.key(40))))
    G = ranks.GNN_GRAPHS
    for name, (loss, _, _, N, E, _) in ranks.GNN_CASES.items():
        edges = rng.randint(0, N, (E, 2)).astype(np.int32)
        mask = rng.rand(E) > 0.2
        pad = [E // 8 - 1, E // 8, E // 4 - 1, E // 4, E - 2, E - 1]
        edges[pad], mask[pad] = 0, False
        pre = f"gnn/{name}/"
        d[pre + "node_feat"] = rng.randn(N, 8).astype(np.float32)
        d[pre + "positions"] = rng.randn(N, 3).astype(np.float32)
        d[pre + "edges"], d[pre + "edge_mask"] = edges, mask
        if loss == "energy_loss":
            d[pre + "graph_ids"] = (np.arange(N) * G // N).astype(np.int32)
            d[pre + "energies"] = rng.randn(G).astype(np.float32)
        else:
            d[pre + "labels"] = rng.randint(-1, 3, (N,)).astype(np.int32)


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
    from repro.training.checkpoint import CheckpointManager as JaxCkpt
    jcfg = ref_tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                    n_kv_heads=2, d_ff=128, vocab_size=96,
                                    max_seq_len=64)
    params = {}
    for k, v in d.items():
        if k.startswith("w96_2/params/"):
            node = params
            parts = k[len("w96_2/params/"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jax.numpy.asarray(v)
    JaxCkpt(os.path.join(directory, "jckpt")).save(
        5, {"params": params},
        logical_axes={"params": ref_tx.param_logical_axes(jcfg)})
    # XLA's CPU client runs the 8 devices' collectives on one thread pool,
    # NPROC threads (the cores by default): with several collectives in
    # flight a device, every thread can wait in a rendezvous whose other
    # members get no thread, and XLA aborts the process
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu", NPROC="64",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    refs = [os.path.join(directory, f"refs{i}.npz") for i in range(2)]
    # the GNN's references in a second process beside the first
    procs = [subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(script),
         os.path.join(directory, "inputs.npz"), path],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for script, path in zip((JAX_REFS, JAX_GNN_REFS), refs)]
    try:
        tmp.start_processes(ranks.world8, args=(directory,), nprocs=8,
                            join=True, start_method="spawn")
        tmp.start_processes(ranks.world4, args=(directory,), nprocs=4,
                            join=True, start_method="spawn")
        tmp.start_processes(ranks.world2, args=(directory,), nprocs=2,
                            join=True, start_method="spawn")
        for proc in procs:
            out, err = proc.communicate(timeout=300)
            assert proc.returncode == 0, out + err
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return dict(inputs=d, refs={k: v for path in refs
                                for k, v in np.load(path).items()},
                dir=directory,
                res=[torch.load(os.path.join(directory, f"rank{r}.pt"),
                                weights_only=False) for r in range(8)],
                restored=[torch.load(os.path.join(directory,
                                                  f"restored{r}.pt"),
                                     weights_only=False) for r in range(4)],
                cli=[torch.load(os.path.join(directory, f"cli{r}.pt"),
                                weights_only=False) for r in range(2)])


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


def test_init_params_and_shard_params_give_every_leafs_block(spawned):
    """Each rank checked every leaf of the MoE and the dense config, under
    ``DEFAULT_RULES`` and the serve rules, bit for bit against the
    single-device draw sliced by ``placement``: the expert E/ep block, the
    fsdp × tensor blocks of the dense weights, the norms whole."""
    for r in spawned["res"]:
        assert r["params/we_gate_shape"] == (2, 4, 8, 16)
    r0 = spawned["res"][0]
    # (data 4, model 2): d 64 over data, the heads and the FFN over model
    assert r0["params/dense/default/layers/wq"] == (
        (2, 16, 32), (None, "data", "model"))
    assert r0["params/dense/serve/layers/wq"] == ((2, 64, 32),
                                                  (None, None, "model"))
    assert r0["params/dense/default/layers/wk"] == (
        (2, 16, 8), (None, "data", "model"))
    assert r0["params/dense/default/layers/w_down"] == (
        (2, 64, 16), (None, "model", "data"))
    assert r0["params/dense/default/embed"] == ((48, 16), ("model", "data"))
    assert r0["params/dense/serve/layers/ln1"] == ((2, 64), (None, None))
    assert r0["params/moe/serve/layers/we_down"] == (
        (2, 4, 16, 32), (None, "model", None, None))


def test_checkpoint_saved_on_8_ranks_restores_onto_4(spawned):
    """The twin of the reference's ``test_elastic_checkpoint_reshard_8dev``,
    placed where the port keeps each leaf (``placement``): saved under
    (data 4, model 2), restored under (data 2, model 2).  The leaf with
    logical axes ("batch", "tensor") is split over ``model`` along its
    "tensor" dim ("batch" is no parameter axis; the reference would
    restore (4, 4) blocks), gathered and written whole.  Qwen3-MoE's smoke
    parameters, drawn with each rank's fsdp, tensor and expert blocks, are
    written as the single-device arrays; each restoring rank got
    ``shard_params``' blocks bit for bit and ran the forward through
    ``moe_ep`` and the placed dense weights (a head of wk split at model
    2, K 1) on them, equal to ``moe_ref``'s without a mesh (atol 1e-4)."""
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
        m = r["coords"]["model"]
        np.testing.assert_array_equal(r["w"], x[:, 4 * m:4 * (m + 1)])
        assert r["we_gate"][1] == E // 2
        torch.testing.assert_close(r["logits"],
                                   spawned["restored"][0]["logits"],
                                   atol=1e-4, rtol=0)
    mesh = _Shape(data=2, model=2)
    assert named_sharding(mesh, ("batch", "tensor"), (8, 8)).shard_shape(
        (8, 8)) == (4, 4)


def test_checkpoint_save_asks_for_a_shape_its_block_cannot_tell(spawned):
    """A (97, 8) leaf split over ``data`` along 8 (``model`` does not
    divide 97) gives (97, 2) blocks, which a (194, 8) leaf split over both
    axes gives too: ``save(mesh=)`` without the global shapes raises
    naming ``shapes=``, and with them it writes the whole leaf."""
    for r in spawned["res"]:
        assert "shapes=" in r["ckpt_no_shape"]
    with np.load(os.path.join(spawned["dir"], "ckpt_odd", "step_0000000001",
                              "arrays.npz")) as npz:
        np.testing.assert_array_equal(npz["y"],
                                      np.arange(97 * 8.0).reshape(97, 8))


def test_checkpoint_save_refuses_a_leaf_that_is_not_its_block(spawned):
    """``save(mesh=)`` under ``DEFAULT_RULES`` at (data 4, model 2) refuses
    a whole (8, 8) leaf with axes ("batch", "tensor"), whose block there
    is (8, 4) (a whole leaf would once have been written as copies of
    itself), and the smoke MoE's parameters placed under the serve rules
    (d whole, where the active rules split it over ``data``): each raises
    naming the block it expected, and nothing is written."""
    for r in spawned["res"]:
        assert "(8, 4)" in r["ckpt_refused/whole"]
        assert "not this rank's block" in r["ckpt_refused/serve"]
        assert r["ckpt_refused/written"] == []


def test_checkpoint_saved_by_the_jax_package_restores_onto_the_mesh(
        spawned):
    """The JAX package's ``CheckpointManager`` saved the V 96, K 2
    parameters with their logical axes; each of 4 ranks restored them onto
    (data 2, model 2) under ``DEFAULT_RULES``, equal bit for bit to
    ``shard_params`` of the same parameters (wq's (2, 32, 32) block)."""
    for r in spawned["restored"]:
        assert r["jax_step"] == 5
        assert r["jax_equal"]
        assert r["jax_wq"] == (2, 32, 32)


def _lane_rows(cache, tables, layout):
    """A (L, B, S, K, dh) view of a dense cache or a paged pool (read
    through the block tables)."""
    if layout != "paged":
        return cache
    bs = cache.shape[2]
    s = np.arange(tables.shape[1] * bs)
    return cache[:, tables[:, s // bs], s % bs]


def _rows_below(cache, limit):
    """The rows of each lane b below ``limit[b]`` (the rest: garbage that
    no query attends, the pad rows' K/V from a prefill backend that does
    not mask them)."""
    keep = np.arange(cache.shape[2])[None, :] < np.asarray(limit)[:, None]
    return cache[:, keep]


@pytest.mark.parametrize("case", list(ranks.TP_CASES))
def test_dense_placement_equals_the_reference(spawned, case):
    """The dense LM placed over the mesh (``ranks.TP_CASES``: (data 4,
    model 2), (data 2, model 4) and (data 1, model 8), ``DEFAULT_RULES``
    and the serve rules, V 97 whole and V 96 split, K 2 at model 4
    splitting a head, the dense and paged layouts, flash decode under TP;
    H 12 at model 8, whose wq block holds a head and a half, and H 12, K 3
    at model 2, a rank's 6 query heads on two KV heads): every rank holds
    each leaf as its ``placement`` block, and rank 0's gathered prefill
    logits and cache, tree-step logits and the session's fused step
    (packed result and committed cache) equal the reference's jitted
    functions on the Auto mesh with GSPMD-placed parameters, within 3e-5
    (the packed result exactly, and alike on every rank); on the paged
    layout each rank's suffix prefill (a prefix-cache hit) equals the
    single-device port's within 3e-5.  Where H does not divide, every
    rank attends with all H heads (q gathered); where a rank's heads read
    some of the K heads, its runs say which, and flash decode gathers q
    inside its attend (``_check_heads``)."""
    data, model, rname, V, K, layout, backend, H = ranks.TP_CASES[case]
    res, refs = spawned["res"], spawned["refs"]
    assert all(r[f"{case}/shapes_ok"] for r in res)
    r0 = res[0]
    for key in ("pre_logits", "tree_logits"):
        np.testing.assert_allclose(r0[f"{case}/{key}"].numpy(),
                                   refs[f"{case}/{key}"], atol=3e-5,
                                   err_msg=key)
    lens, tables = (spawned["inputs"][f"tp/{n}"] for n in ("lens", "tables"))
    T = len(TREE_PARENT)
    for key, limit in (("pre_k", lens), ("pre_v", lens), ("k", lens + T),
                       ("v", lens + T)):
        got, want = (_rows_below(_lane_rows(c, tables, layout), limit)
                     for c in (r0[f"{case}/{key}"].numpy(),
                               refs[f"{case}/{key}"]))
        np.testing.assert_allclose(got, want, atol=3e-5, err_msg=key)
    for r in res:
        assert torch.equal(r[f"{case}/packed"], r0[f"{case}/packed"])
    np.testing.assert_array_equal(r0[f"{case}/packed"].numpy(),
                                  refs[f"{case}/packed"])
    assert r0[f"{case}/packed"][:3, 0].tolist() == [3, 3, 3]
    for rank, r in enumerate(res):
        _check_heads(r[f"{case}/heads"], H, K, model, rank % model)
        if layout == "paged":       # the suffix prefill of a prefix hit
            assert r[f"{case}/suffix_err"] < 3e-5
    if (H, K, model) == (12, 3, 2):     # 6 heads a rank over two KV heads
        assert [len(r[f"{case}/heads"][2]) for r in res] == [2] * 8
    vocab = r0[f"{case}/logits_spec"]
    assert (vocab is not None and vocab[-1] == "model") == (V % model == 0)


PAGED_CASES = [c for c, v in ranks.TP_CASES.items() if v[5] == "paged"]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_calls_run_the_ranks_lanes_and_keep_the_pools_alike(spawned,
                                                                  case):
    """The paged layout's lanes over ``data`` (each case's mesh, (data 4,
    model 2) or (data 2, model 4)): ``Layout(paged=True)`` splits them over
    ``data``; each rank's cohort prefill, tree step, suffix prefill (its
    (lanes, prefill_len) row block) and the session's fused step ran
    TP_LANES / data lanes; and after each of those calls the pools of the
    ranks that hold the same KV heads (one ``model`` index) are equal bit
    for bit, the NULL block excepted."""
    data, model = ranks.TP_CASES[case][:2]
    res = spawned["res"]
    for r in res:
        assert r[f"{case}/lane_axes"] == ("data",)
        assert r[f"{case}/lanes"] == dict.fromkeys(
            ("prefill", "tree", "suffix", "fused"), [ranks.TP_LANES // data])
        assert len(r[f"{case}/pools"]) == 4
    for rank, r in enumerate(res):
        twin = res[rank % model]        # data index 0, the same model index
        for got, want in zip(r[f"{case}/pools"], twin[f"{case}/pools"]):
            assert torch.equal(got, want), rank


def test_traced_mesh_counts_what_the_real_mesh_hands_gloo(spawned):
    """One paged fused step and one dense prefill at (data 4, model 2)
    under ``DEFAULT_RULES``: on every rank the ``TracedMesh`` of that
    rank, run on meta copies of the arguments, records what the real
    ``Mesh`` handed gloo, to the byte and by kind and group; the paged
    step's include an all-gather over ``data`` (the FSDP gathers and the
    pool rows' exchange) and an all-reduce over ``model``."""
    for rank, r in enumerate(spawned["res"]):
        for name in ("paged_fused", "dense_prefill"):
            real, traced = (r[f"count/{name}/{t}"] for t in ("real",
                                                            "traced"))
            assert real and real == traced, (rank, name)
            assert ring_bytes(real) == ring_bytes(traced)
        kinds = {(x["kind"], x["group"]) for x in r["count/paged_fused/real"]}
        assert {("all-gather", 4), ("all-reduce", 2)} <= kinds, kinds


def _check_heads(heads, H, K, model, index):
    """``Layout``'s heads on model rank ``index``: (query heads, KV heads,
    runs, q's gather axes, the axes of a block of whole heads).  Where K
    divides, each rank's block of both; where H does not, all H gathered
    for every call; else runs covering the rank's H / model heads in
    order, each on the KV head i // G of its global heads i (flash
    decode's attend gathers q over ``q_block``)."""
    q_heads, kv_heads, runs, q_gather, q_block = heads
    if K % model == 0:
        assert (q_heads, kv_heads, runs, q_gather, q_block) == (
            H // model, K // model, None, (), ())
    elif H % model:
        assert (q_heads, kv_heads, runs, tuple(q_gather), q_block) == (
            H, K, None, ("model",), ())
    else:
        h0, G = index * q_heads, H // K
        assert (q_heads, kv_heads, tuple(q_gather), tuple(q_block)) == (
            H // model, K, (), ("model",))
        assert [h for a, b, _ in runs for h in range(a, b)] == list(
            range(q_heads))
        assert all(kv == (h0 + h) // G for a, b, kv in runs
                   for h in range(a, b))
        assert len(runs) == len({(h0 + h) // G for h in range(q_heads)})


@pytest.fixture(scope="module")
def one_device_streams(spawned):
    """The guided prompts served by the single-device port and by the JAX
    engine on the same weights (V 96, K 2)."""
    from repro.serving import api as japi
    from repro_torch.core.request import SamplingParams
    from repro_torch.models.params import params_from_jax
    from repro_torch.serving import api as tapi
    d = spawned["inputs"]
    prompts = json.loads(str(d["guide/prompts"]))
    ecfg = dict(lanes=ranks.TP_LANES, prefill_len=16, decoding_length=4,
                branch_length=2,
                default_params=SamplingParams(max_new_tokens=ranks.SERVE_NEW))
    tcfg = ranks.tp_cfg(96, 2)
    jcfg = ref_tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                    n_kv_heads=2, d_ff=128, vocab_size=96,
                                    max_seq_len=64)
    flat = {k[len("w96_2/params/"):]: v for k, v in d.items()
            if k.startswith("w96_2/params/")}
    tree = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    table = jax.numpy.asarray(d["guide/table"])

    def j_bias(logits, tokens, positions):
        nxt = table[positions % table.shape[0], tokens]
        return logits + 1e4 * jax.nn.one_hot(nxt, 96, dtype=logits.dtype)

    def serve(engine):
        hs = [engine.submit(list(p), max_new_tokens=ranks.SERVE_NEW)
              for p in prompts]
        engine.run()
        return [[int(t) for t in h.result().tokens] for h in hs]

    port = serve(tapi.build_engine(
        tapi.EngineConfig(**ecfg), tcfg,
        params_from_jax(tcfg, tree, device="cpu"),
        logits_transform=ranks.guided_bias(d["guide/table"]), device="cpu"))
    ref = serve(japi.build_engine(
        japi.EngineConfig(**ecfg), jcfg,
        jax.tree.map(jax.numpy.asarray, tree), logits_transform=j_bias))
    return port, ref


@pytest.mark.parametrize("case", list(ranks.SERVE_CASES))
def test_greedy_streams_under_the_mesh_equal_one_device_and_jax(
        spawned, one_device_streams, case):
    """Guided requests served through ``build_engine`` inside
    ``sharding_ctx`` (lanes over ``data`` on the dense layout, heads and
    vocab over ``model``; the guide on each rank's vocab block, or on the
    vocab the session gathers for it) give the single-device port's
    tokens and the JAX engine's, in both passes of the requests; each rank
    checked them equal to ``reference_decode`` under the same mesh (I1),
    and the second pass, drafting from the first's outputs, took fewer
    decode steps (its drafts accepted)."""
    port, ref = one_device_streams
    assert port == ref
    for r in spawned["res"]:
        assert r[f"serve/{case}/1"] == r[f"serve/{case}/2"] == port
    first, primed = spawned["res"][0][f"serve/{case}/steps"]
    assert primed < first


REPLICATED_LANES = "r42"       # GRAD_CASES' B 2 on data 4


@pytest.mark.parametrize("case", [c for c in ranks.GRAD_CASES
                                  if c != REPLICATED_LANES])
def test_lm_loss_gradient_under_the_mesh_equals_one_device(spawned, case):
    """``lm_loss`` under the mesh (its lanes over ``data``, the heads, FFN
    and vocab over ``model``; (data 4, model 2) with ``DEFAULT_RULES``'
    FSDP and a loss mask, (data 2, model 4) with the serve rules, a split
    head and remat, and (data 4, model 2) under the train_4k rules, whose
    residual is split along the sequence over ``model``, the loss head
    gathering it back at V 96 and running on the blocks at V 97; H 12 at
    (data 1, model 8) under the train_4k rules, q gathered from a head and
    a half a rank, and H 12, K 3 at (data 4, model 2) with remat, a rank's
    heads on two KV heads): every rank's loss is the single-device loss
    and its gradient of each parameter block is its block of the
    single-device gradient, within 3e-5."""
    for r in spawned["res"]:
        one, mesh = r[f"{case}/loss"]
        assert abs(one - mesh) < 3e-5
        assert r[f"{case}/grad_err"] < 3e-5
        assert r[f"{case}/grad_scale"] > 1e-3
    lanes, seq, head = spawned["res"][0][f"{case}/split"]
    sp = ranks.GRAD_CASES[case][2] == "train"
    assert seq == (("model",) if sp else ())
    assert head == (("model",) if sp and ranks.GRAD_CASES[case][5] == 97
                    else ())


def test_lm_loss_gradient_with_replicated_lanes_equals_one_device(spawned):
    """B 2 on (data 4, model 2): ``data`` does not divide the batch, so
    every data rank runs both lanes; the FSDP gather's transpose takes the
    replicas' gradient once (GSPMD's result for a replicated batch)
    instead of adding the 4 copies, and every rank's loss and gradient
    blocks equal the single device's within 3e-5."""
    case = REPLICATED_LANES
    for r in spawned["res"]:
        one, mesh = r[f"{case}/loss"]
        assert abs(one - mesh) < 3e-5
        assert r[f"{case}/grad_err"] < 3e-5
        assert r[f"{case}/grad_scale"] > 1e-3
        assert r[f"{case}/split"] == ((), (), ())


def test_serving_under_a_live_residual_seq_raises(spawned):
    """Sequence parallelism is ported for the train path only: a prefill
    under the train_4k rules raises, naming ROADMAP A16b."""
    for r in spawned["res"]:
        assert "A16b" in r["serve_sp_refusal"]


def test_train_residual_is_the_ranks_sequence_block(spawned):
    """Under the train_4k rules at S 16 on model 2 each rank's residual
    between layers is its (B/4, S/2, d) block, equal (atol 3e-5, checked
    on each rank) to that block of the single-device hidden states; at S
    15, which model 2 does not divide, the residual stays whole."""
    for r in spawned["res"]:
        assert r["train/residual"] == ((2, 8, 64), ("model",))
        assert r["train/odd_seq"] == ()


def test_global_norm_counts_each_block_once(spawned):
    """A (8, 8) leaf of ones split over model and data and a (4,) leaf of
    twos replicated on all 8 ranks: the norm is sqrt(64 + 16) on every
    rank (the split leaf over all of its blocks, the replicated one
    once); a whole leaf where the rules split it, and ``adamw_update``
    under the mesh without ``axes``/``shapes``, raise."""
    for r in spawned["res"]:
        assert r["norm/split"] == [("data", "model"), ()]
        assert abs(r["norm/value"] - np.sqrt(80.0)) < 1e-6
        assert "'a'" in r["norm/whole_refused"]
        assert "(4, 2)" in r["norm/whole_refused"]
        assert "axes=" in r["norm/no_axes_refused"]


# Parameters and moments after two steps, mesh against the reference and
# against one device (f32).  The gradients agree to ~1e-8 relative (their
# sums run in another order), so the moments agree to ~1e-10.  AdamW's
# update lr * m / (sqrt(v) + eps) moves with the gradient by at most
# lr * |dg| / eps, reached where |g| is near eps = 1e-8: an element's
# |dg| of 2e-10 moves it 3e-4 * 2e-10 / 1e-8 = 6e-6 (the largest
# difference measured here is 6.8e-6, microbatches on replicated lanes
# against the reference); a wrong update (a halved lr, a missing bias
# correction, a norm counted once a rank) moves entries by lr / 2 or more.
STATE_ATOL = 1e-5


def _state_err(got, want):
    """{key: max |got - want|} over the flat gathered state."""
    return {k: float(np.abs(np.asarray(got[k], np.float64)
                            - np.asarray(want[k], np.float64)).max())
            for k in want}


@pytest.fixture(scope="module")
def one_device_train(spawned):
    """Each TRAIN_CASES and MOE_TRAIN_CASES model's two steps by the
    port's single-device ``make_train_step`` on the whole parameters (the
    MoE's through ``moe_ref``, which drops nothing); ``mu1/...``: ``mu``
    after the first."""
    from repro_torch.models.params import params_from_jax
    from repro_torch.training.optimizer import adamw_init
    d, out = spawned["inputs"], {}
    cases = {name: (ranks.train_cfg(K, remat), f"w96_{K}", accum, gdt)
             for name, (_, _, _, K, accum, gdt, remat)
             in ranks.TRAIN_CASES.items()}
    cases.update({name: (ranks.moe_train_cfg(shared, cf, "ref"),
                         f"moe{shared}", 1, None)
                  for name, (_, _, _, shared, cf, _)
                  in ranks.MOE_TRAIN_CASES.items()})
    for name, (cfg, key, accum, gdt) in cases.items():
        params = params_from_jax(cfg, ranks._tree(d, f"{key}/params"),
                                 device="cpu")
        opt = adamw_init(params)
        step, metrics = ranks.train_step(cfg, accum, gdt), []
        for i in range(2):
            params, opt, m = step(params, opt, ranks.train_batch(d, i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0:
                mu1 = {f"mu1/{k}": a for k, a in ranks._leaves(opt.mu)}
        state = dict(mu1, step=opt.step)
        for tag, tree in (("p", params), ("mu", opt.mu), ("nu", opt.nu)):
            state.update({f"{tag}/{k}": a for k, a in ranks._leaves(tree)})
        out[name] = (metrics, state)
    return out


@pytest.mark.parametrize("case", list(ranks.TRAIN_CASES))
def test_train_step_under_the_mesh_equals_the_reference(
        spawned, one_device_train, case):
    """Two train steps under the mesh (``ranks.TRAIN_CASES``: the train_4k
    rules with SP at K 4, the same with bf16 gradients and remat, (data 2,
    model 4) under ``DEFAULT_RULES`` at K 2 with a split head and 2
    microbatches, and 4 microbatches of 2 lanes replicated over data 4)
    against the reference's ``make_train_step`` jitted with the
    ``tree_shardings`` of the parameters, ``opt_state_axes`` and the
    batch on an Auto mesh under the same rules, and against the port's
    single-device step: each step's loss and grad_norm within 3e-5 (alike
    on every rank), the gathered parameters and moments within
    STATE_ATOL; with bf16 gradients ``mu`` within (1 - b1) times one
    bf16 ulp of each step's gradient it carries, elementwise (either
    step's f32 gradient may round to the neighbouring bf16 value)."""
    refs = spawned["refs"]
    one_metrics, one_state = one_device_train[case]
    res = spawned["res"]
    for r in res:
        assert r[f"train/{case}/metrics"] == res[0][f"train/{case}/metrics"]
    for i, (loss, norm) in enumerate(res[0][f"train/{case}/metrics"]):
        for want in (float(refs[f"train/{case}/loss{i}"]),
                     one_metrics[i][0]):
            assert abs(loss - want) < 3e-5
        for want in (float(refs[f"train/{case}/norm{i}"]),
                     one_metrics[i][1]):
            assert abs(norm - want) < 3e-5
    got = res[0][f"train/{case}/state"]
    assert int(got["step"]) == int(refs[f"train/{case}/step"]) == 2
    want_ref = {k: refs[f"train/{case}/{k}"] for k in got if k != "step"}
    want_one = {k: one_state[k] for k in want_ref}
    bf16 = ranks.TRAIN_CASES[case][5] == "bfloat16"
    for want in (want_ref, want_one):
        err = _state_err(got, want)
        worst = max(err, key=err.get)
        if not bf16:
            assert err[worst] <= STATE_ATOL, (worst, err[worst])
            continue
        for k, e in err.items():
            if not k.startswith("mu/"):
                assert e <= STATE_ATOL, (k, e)
        # mu = b1 (1 - b1) g1 + (1 - b1) g2, the clipped bf16 gradients
        # taken from the single device's mu after each step; one bf16 ulp
        # of |g| is at most 2^-7 |g|, and the clip factors differ by ~1e-7
        b1 = 0.9
        for k, w in want.items():
            if k.startswith("mu/"):
                m1, m2 = (np.asarray(one_state[p + k[2:]], np.float64)
                          for p in ("mu1", "mu"))
                g1, g2 = m1 / (1 - b1), (m2 - b1 * m1) / (1 - b1)
                ulps = (1 - b1) * 2.0 ** -7 * (b1 * np.abs(g1) + np.abs(g2))
                diff = np.abs(np.asarray(got[k], np.float64)
                              - np.asarray(w, np.float64))
                assert (diff <= ulps + 1e-6 * np.abs(m2)).all(), k
    print(case, {tag: max(_state_err(got, w).values())
                 for tag, w in (("ref", want_ref), ("one", want_one))})


@pytest.mark.parametrize("case", list(ranks.MOE_TRAIN_CASES))
def test_moe_train_step_under_sp_equals_the_reference(
        spawned, one_device_train, case):
    """Two train steps of an MoE (8 experts, top 2, with and without a
    shared expert) under the train_4k rules on (data 4, model 2): the
    residual split along the sequence over ``model``, 2 lanes a data
    rank, ``moe_ep`` on the reference's token groups (a rank's chunk of
    its lanes' (lane, position) order, gathered from the residual's
    sequence blocks), the shared expert's products on the residual's
    blocks.  Against the reference's GSPMD train step on the Auto mesh:
    each step's loss and grad_norm within 3e-5 (alike on every rank), the
    gathered parameters and moments within STATE_ATOL.  At capacity factor
    1.25 rows drop (some rank counted more than 0), so the groups decide
    the result; at E / top_k nothing drops, and the port's single-device
    step (``moe_ref``) agrees as closely.  ``moe_ref`` under the mesh
    (every expert on a rank's tokens, their gradients summed over the
    token axes alone) drops nothing and equals one device as well;
    ``moe_local`` routes all of the call's tokens, as the reference's one
    token group, and drops rows."""
    data, model, rname, shared, cf, impl = ranks.MOE_TRAIN_CASES[case]
    refs, res = spawned["refs"], spawned["res"]
    dropped = [r[f"moe_train/{case}/dropped"] for r in res]
    cfg = ranks.moe_train_cfg(shared, cf, impl)
    no_drop = impl == "ref" or cf >= cfg.n_experts / cfg.top_k
    assert (sum(dropped) == 0) == no_drop, dropped
    assert res[0][f"moe_train/{case}/split"] == (
        ("data",), ("model",), ("model",) if shared else ())
    one_metrics, one_state = one_device_train[case]
    metrics = res[0][f"moe_train/{case}/metrics"]
    for r in res:
        assert r[f"moe_train/{case}/metrics"] == metrics
    for i, (loss, norm) in enumerate(metrics):
        want = [(float(refs[f"moe_train/{case}/loss{i}"]),
                 float(refs[f"moe_train/{case}/norm{i}"]))]
        if no_drop:
            want.append(one_metrics[i])
        for w_loss, w_norm in want:
            assert abs(loss - w_loss) < 3e-5 and abs(norm - w_norm) < 3e-5
    got = res[0][f"moe_train/{case}/state"]
    assert int(got["step"]) == int(refs[f"moe_train/{case}/step"]) == 2
    wants = [{k: refs[f"moe_train/{case}/{k}"] for k in got if k != "step"}]
    if no_drop:
        wants.append({k: one_state[k] for k in wants[0]})
    for want in wants:
        err = _state_err(got, want)
        worst = max(err, key=err.get)
        assert err[worst] <= STATE_ATOL, (worst, err[worst])
    print(case, "dropped", dropped, {
        tag: max(_state_err(got, w).values())
        for tag, w in zip(("ref", "one"), wants)})


class _RankShape(_Shape):
    """A stand-in mesh with this rank's coordinates (row-major, as
    ``Mesh.coords``), which ``Layout`` reads for a rank's heads and vocab
    block."""

    def __init__(self, rank, **shape):
        super().__init__(**shape)
        self.axis_names, self.rank = tuple(shape), rank

    def coords(self, rank=None):
        idx = np.unravel_index(self.rank if rank is None else rank,
                               tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_layout_places_every_lm_cell_of_the_reference(arch):
    """Every cell of the arch (its four shapes, each with the reference
    cell's config and rules: train_4k's ``residual_seq=("model",)``, the
    decode cells' ``fsdp=()`` and flash decode) gets a ``Layout`` on the
    reference's production mesh (data 16, model 16) and on (data 1, model
    8), at a rank whose heads span two KV heads where any does: Qwen2's H
    12 at model 8 and 16 (q gathered), Phi-3-medium's 40 heads of G 4
    (runs on two KV heads), the MoE archs' train_4k under sequence
    parallelism."""
    from repro_torch.configs import lm_common
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.models import transformer as tx
    base = configs.get_arch(arch).full_config()
    cells = {
        name: (lm_common.cell_config(base, name), lm_common.cell_rules(name),
               dict(batch=lm_common.CELL_BATCH[name],
                    **({"seq": lm_common.TRAIN_4K["seq"]}
                       if name == "train_4k" else {})))
        for name in lm_common.SHAPES}
    assert lm_common.cell_rules("train_4k") == DEFAULT_RULES.override(
        residual_seq=("model",))
    assert lm_common.cell_rules("prefill_32k") == DEFAULT_RULES
    for name in ("decode_32k", "long_500k"):
        assert lm_common.cell_rules(name) == DEFAULT_RULES.override(fsdp=())
        assert cells[name][0].decode_backend == "flash_decode"
    H, K = base.n_heads, base.n_kv_heads
    for shape in (dict(data=16, model=16), dict(data=1, model=8)):
        for name, (cfg, rules, kw) in cells.items():
            with sharding_ctx(_RankShape(1, **shape), rules):
                lay = tx.Layout(cfg, **kw)
            _check_heads((lay.q_heads, lay.kv_heads, lay.kv_runs,
                          lay.q_gather, lay.q_block), H, K, shape["model"],
                         1)
            assert lay.seq_axes == (("model",) if name == "train_4k"
                                    else ()), (shape, name)
    if arch == "phi3_medium_14b":       # rank 1's heads 5-9 at model 8
        with sharding_ctx(_RankShape(1, data=1, model=8), DEFAULT_RULES):
            assert tx.Layout(cells["prefill_32k"][0], 32).kv_runs == (
                (0, 3, 1), (3, 5, 2))


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


def test_train_state_saved_on_8_ranks_resumes_on_4(spawned):
    """The train state after step 1 on (data 4, model 2), saved through
    the CLI's ``save_state`` (the moments with their parameters' axes),
    restored by ``restore(mesh=)`` onto (data 2, model 2), where each
    moment is its parameter's block: step 2 there equals step 2 on 8
    ranks (loss and grad_norm within 3e-5, parameters and moments within
    STATE_ATOL)."""
    case = ranks.TRAIN_CKPT_CASE
    r8 = spawned["res"][0]
    for r in spawned["restored"]:
        t = r["train"]
        assert t["saved"] == 1
        assert t["mu_block"] == (2, 32, 32)       # wq's block at (2, 2)
        loss, norm = r8[f"train/{case}/metrics"][1]
        assert abs(t["metrics"][0] - loss) < 3e-5
        assert abs(t["metrics"][1] - norm) < 3e-5
    assert r8[f"train/{case}/mu_block"] == (2, 16, 32)   # at (4, 2)
    err = _state_err(spawned["restored"][0]["train"]["state"],
                     {k: v for k, v in r8[f"train/{case}/state"].items()
                      if k != "step"})
    assert max(err.values()) <= STATE_ATOL, max(err, key=err.get)


def test_reference_restores_the_sharded_train_state(spawned, tmp_path):
    """The file the 8 ranks wrote holds the keys and bytes (the same
    digest) of a one-device save of the gathered state through the same
    call; its manifest records the moments' axes (``o/1/...``,
    ``o/2/...``; the step ``o/0`` whole), where the reference's CLI writes
    null, and the JAX package's ``CheckpointManager.restore`` without a
    mesh ignores them: it reads the gathered state bit for bit."""
    from repro.training.checkpoint import CheckpointManager as JaxCkpt
    from repro.training.optimizer import adamw_init as jax_adamw_init
    from repro_torch.launch import train as train_cli
    from repro_torch.training.checkpoint import CheckpointManager
    from repro_torch.training.optimizer import AdamWState
    state = spawned["res"][0]["train/ckpt_state"]
    _, _, _, K, _, _, remat = ranks.TRAIN_CASES[ranks.TRAIN_CKPT_CASE]
    cfg = ranks.train_cfg(K, remat)

    def tree(tag):
        return ranks._tree(state, tag)

    opt = AdamWState(step=state["step"], mu=tree("mu"), nu=tree("nu"))
    train_cli.save_state(CheckpointManager(str(tmp_path)), 1, cfg, tree("p"),
                         opt)
    step_dir = "step_0000000001"
    mesh_dir = os.path.join(spawned["dir"], "train_ckpt", step_dir)
    man = [json.load(open(os.path.join(p, "manifest.json")))
           for p in (mesh_dir, str(tmp_path / step_dir))]
    assert man[0]["keys"] == man[1]["keys"]
    assert man[0]["digest"] == man[1]["digest"]
    axes = man[0]["logical_axes"]
    assert axes == man[1]["logical_axes"]
    assert axes["o/0"] == []
    assert axes["o/1/layers/wq"] == axes["o/2/layers/wq"] == [
        None, "fsdp", "tensor"]
    jcfg = ref_tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                    n_kv_heads=K, d_ff=128, vocab_size=96,
                                    max_seq_len=64)
    jp = ref_tx.init_params(jcfg, jax.random.key(0))
    got, step = JaxCkpt(os.path.join(spawned["dir"], "train_ckpt")).restore(
        {"p": jp, "o": jax_adamw_init(jp)})
    assert step == 1
    flat = {"step": got["o"].step}
    for tag, t in (("p", got["p"]), ("mu", got["o"].mu),
                   ("nu", got["o"].nu)):
        flat.update({f"{tag}/{k}": v for k, v in ranks._leaves(t)})
    assert sorted(flat) == sorted(state)
    for k, v in state.items():
        np.testing.assert_array_equal(np.asarray(flat[k]), v.numpy(),
                                      err_msg=k)


def test_save_refuses_a_train_state_without_moment_axes(spawned):
    """``save(mesh=)`` of the 8 ranks' train state with ``"o": None`` (the
    CLI's call before the moments had axes, which would write rank 0's
    moment blocks as whole arrays): it raises naming the first such key,
    and nothing is written."""
    for r in spawned["res"]:
        assert "'o/0'" in r["train/unplaced"]
        assert "no logical axes" in r["train/unplaced"]
        assert r["train/unplaced_written"] == []


@pytest.fixture(scope="module")
def one_process_cli(tmp_path_factory):
    """The train CLI's two calls of the spawned worlds in this process,
    without a mesh."""
    from repro_torch.launch import train as train_cli
    ckpt = str(tmp_path_factory.mktemp("cli_one"))
    runs = [train_cli.main(ranks.CLI_ARGS + [
        "--steps", str(n), "--ckpt-every", str(n), "--ckpt-dir", ckpt])
        for n in ranks.CLI_STEPS]
    return ckpt, runs


def test_train_cli_under_a_mesh_resumes_on_another_world(spawned,
                                                         one_process_cli):
    """``launch/train.main`` inside ``sharding_ctx`` (no mesh flag): 3
    steps with a checkpoint on 4 ranks at (data 2, model 2) under the
    train_4k rules, resumed on 2 ranks at (1, 2) to step 5 with a
    checkpoint there.  Every rank prints the same losses, within 3e-5 of
    the one-process CLI's (steps 1 and 4), the resumed ranks hold blocks,
    and the step-5 checkpoint's arrays are within STATE_ATOL of the
    one-process CLI's."""
    ckpt, (first, second) = one_process_cli
    n0, n1 = ranks.CLI_STEPS
    for r in spawned["restored"]:
        assert r["cli"]["start"] == 0
        assert r["cli"]["losses"] == spawned["restored"][0]["cli"]["losses"]
    for r in spawned["cli"]:
        assert r["start"] == n0
        assert r["losses"] == spawned["cli"][0]["losses"]
        assert r["wq"] == r["mu_wq"] == (2, 64, 32)
    got = {**spawned["restored"][0]["cli"]["losses"],
           **spawned["cli"][0]["losses"]}
    want = {**first["losses"], **second["losses"]}
    assert sorted(got) == sorted(want) == [1, n0 + 1]
    for k in want:
        assert abs(got[k] - want[k]) < 3e-5, (k, got[k], want[k])
    step_dir = f"step_{n1:010d}"
    with np.load(os.path.join(spawned["dir"], "cli", step_dir,
                              "arrays.npz")) as a, \
            np.load(os.path.join(ckpt, step_dir, "arrays.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert np.abs(a[k].astype(np.float64) - b[k]).max() \
                <= STATE_ATOL, k


# ----------------------------------------------------------- recommenders
RECSYS_TOL = dict(rtol=1e-4, atol=1e-5)     # test_torch_recsys.py's


def _nan_close(got, want, **tol):
    """allclose with NaN in the same places (and at least one compared
    value that is not)."""
    got, want = (torch.as_tensor(np.asarray(x)).double() for x in (got,
                                                                  want))
    assert torch.equal(got.isnan(), want.isnan())
    assert (~got.isnan()).any()
    torch.testing.assert_close(got, want, equal_nan=True, **tol)


@pytest.mark.parametrize("case", list(ranks.RECSYS_CASES))
def test_recsys_serve_cells_under_the_mesh_equal_the_reference(spawned,
                                                               case):
    """Every serve cell of a recommender placed over the mesh (tables'
    rows over ``model``, rows of the batch over ``data``; W&D at model 2
    and 4, B5 over a rank's window, the partial bags summed) equals, on
    every rank, the reference's program jitted on the Auto mesh with its
    parameters and inputs placed by the same rules, and the single-device
    port (``RECSYS_TOL``), NaN in the same places: an id out of range
    gives NaN on the mesh as on one device (a masked one too), ids at the
    windows' edges and ids in [-V, 0) that wrap into another rank's
    window read their rows.  Two-Tower's single-hot embeddings and paired
    scores are the single device's bit for bit (one row and zeros), and
    its merged top-k's indices equal both, ties to the lower index."""
    res, refs = spawned["res"], spawned["refs"]
    r0 = res[0][f"rs/{case}"]
    for r in res[1:]:
        for k, v in r[f"rs/{case}"]["out"].items():
            assert torch.equal(v.nan_to_num(), r0["out"][k].nan_to_num())
    for k, got in r0["out"].items():
        want = refs[f"rs/{case}/{k}"]
        if k == "top_i":
            assert torch.equal(got, torch.from_numpy(want).long())
            assert torch.equal(got, r0["one"][k])
            continue
        _nan_close(got, want, **RECSYS_TOL)
        if k in ("user", "item", "paired", "top_v"):
            torch.testing.assert_close(got, r0["one"][k], rtol=0, atol=0,
                                       equal_nan=True)
        else:
            _nan_close(got, r0["one"][k], **RECSYS_TOL)
    if case.startswith("wd"):
        nan = r0["out"]["scores"].isnan().nonzero()[:, 0].tolist()
        assert nan == [3, 4]                   # the rows out of range
    if case == "tt42":
        ties = r0["out"]["top_i"].tolist()
        for a, b in ((1, 2), (2, 63), (9, 40), (40, 41), (41, 50)):
            if a in ties and b in ties:
                assert ties.index(a) < ties.index(b)


@pytest.mark.parametrize("case", list(ranks.RECSYS_CASES))
def test_recsys_train_steps_under_the_mesh_equal_the_reference(spawned,
                                                               case):
    """Two steps of the recommender's ``train_cell`` (bf16 gradients,
    AdamW, the global norm over the blocks) on its placed parameters:
    every rank's losses and grad norms alike, equal to the reference's
    ``make_train_step`` jitted with ``in_shardings`` on the Auto mesh and
    to the single-device port's (rtol 1e-5), and the gathered parameters
    and moments within ``STATE_ATOL`` of both.  A table's gradient summed
    over ``model`` as well as ``data`` (each rank's rows counted once a
    model rank) doubles the grad norm and fails here."""
    res, refs = spawned["res"], spawned["refs"]
    r0 = res[0][f"rs/{case}"]
    for r in res[1:]:
        assert r[f"rs/{case}"]["metrics"] == r0["metrics"]
    for i, (loss, norm) in enumerate(r0["metrics"]):
        np.testing.assert_allclose(loss, refs[f"rs/{case}/loss{i}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(norm, refs[f"rs/{case}/norm{i}"],
                                   rtol=1e-5)
        np.testing.assert_allclose((loss, norm), r0["one_metrics"][i],
                                   rtol=1e-5)
    want = {k: refs[f"rs/{case}/{k}"] for k in r0["state"]}
    assert max(_state_err(r0["state"], want).values()) < STATE_ATOL
    assert max(_state_err(r0["state"], r0["one_state"]).values()) \
        < STATE_ATOL


def test_recsys_init_params_keeps_the_single_device_blocks(spawned):
    """``init_params(mesh=)`` of each recommender draws the single
    device's numbers (tables a field at a time) and keeps this rank's
    block of every leaf: W&D's tables 256 of 512 rows a rank at model 2
    and 128 at model 4, SASRec's d 16 projections split on ``model``."""
    for r in spawned["res"]:
        for case in ranks.RECSYS_CASES:
            assert r[f"rs/{case}"]["drawn_equal"], case
        assert r["rs/wd42"]["blocks"]["tables"] == (6, 256, 8)
        assert r["rs/wd24"]["blocks"]["tables"] == (6, 128, 8)
        assert r["rs/wd24"]["blocks"]["wide_tables"] == (6, 128, 1)
        assert r["rs/tt42"]["blocks"]["item_tables"] == (2, 128, 8)
        assert r["rs/sr42"]["blocks"]["item_emb"] == (150, 16)
        assert r["rs/sr42"]["blocks"]["blk0/wq"] == (16, 8)
        assert r["rs/sr42"]["blocks"]["blk0/w2"] == (32, 16)
        assert r["rs/br42"]["blocks"]["blk1/wo"] == (8, 16)


def test_recsys_train_state_saved_on_8_ranks_restores_onto_4_and_one(
        spawned):
    """W&D's train state after two steps on (data 4, model 2), saved by
    ``save(mesh=)`` with its parameters' and moments' axes, restores onto
    (data 2, model 2) (each rank's block of the tables' rows) and onto one
    device, whole: both equal the state the 8 ranks gathered, bit for
    bit, at step 2."""
    saved = spawned["res"][0][f"rs/{ranks.RECSYS_CKPT_CASE}"]["state"]
    one = spawned["restored"][0]["recsys_one"]
    for got in [r["recsys"] for r in spawned["restored"]] + [one]:
        assert got["step"] == 2 and got["opt_step"] == 2
        assert sorted(got["state"]) == sorted(saved)
        for k, a in saved.items():
            assert torch.equal(got["state"][k], a), k
    assert spawned["restored"][0]["recsys"]["block"] == (6, 256, 8)
    assert one["block"] == (6, 512, 8)


# ------------------------------------------------------------------- the GNN
GNN_RTOL, GNN_ATOL = 1e-4, 1e-5  # tests/test_torch_gnn.py's: ATOL of the
# largest |value| of each array (of the whole gradient for gradient leaves:
# attn_b's is zero but for rounding)
# case -> (edge axes, node axes, edges a rank, nodes a rank)
# (edge axes, node axes, edge rows, node rows, FFN axes, ordered sums)
GNN_SPLITS = {"g42n": (("data", "model"), ("data",), 8, 8, ("model",), False),
              "g24e": (("data", "model"), ("data",), 8, 16, ("model",),
                       False),
              "g42c": (("data", "model"), ("data",), 12, 8, ("model",),
                       False),
              "g42x": (("data",), (), 15, 30, ("model",), True)}


def _gnn_bad(got, want, scale=None):
    """The keys of ``got`` outside the GNN tolerance of ``want`` (atol of
    ``scale``, or each array's own largest |value|)."""
    bad = []
    for k, w in want.items():
        g = np.asarray(got[k], np.float64)
        w = np.asarray(w, np.float64)
        s = scale if scale is not None else max(np.abs(w).max(), 1e-30)
        if g.shape != w.shape or not np.allclose(
                g, w, rtol=GNN_RTOL, atol=GNN_ATOL * s):
            bad.append(k)
    return bad


def _gnn_grad_scale(grads):
    return max(float(np.abs(np.asarray(g)).max()) for g in grads.values())


@pytest.mark.parametrize("case", list(ranks.GNN_CASES))
def test_gnn_under_the_mesh_equals_the_reference(spawned, case):
    """EquiformerV2 placed over the mesh (``ranks.GNN_CASES``: the dense
    path with node_class_loss at (data 4, model 2), energy_loss with
    graph_ids at (2, 4), the chunked path with a rank's 12 edges in
    chunks of 8 and 4, and N no multiple of ``data`` with E one of
    ``data`` but not of data x model): each rank's live edge and node
    axes as ``logical_spec(shape=)`` keeps them; the gathered node
    outputs, the graph outputs, the loss and every gathered gradient
    leaf alike on every rank and, at the GNN tests' tolerance, equal to
    the reference's program jitted on the Auto mesh with its parameters
    and edge inputs placed by the same rules, and to the single-device
    port."""
    res, refs = spawned["res"], spawned["refs"]
    r0 = res[0][f"gnn/{case}"]
    assert r0["split"] == GNN_SPLITS[case]
    for r in res[1:]:
        x = r[f"gnn/{case}"]
        assert x["split"][:2] + x["split"][4:] == \
            r0["split"][:2] + r0["split"][4:]
        assert torch.equal(x["loss"], r0["loss"])
        for k, v in x["out"].items():
            assert torch.equal(v, r0["out"][k]), k
        for k, v in x["grads"].items():
            assert torch.equal(v, r0["grads"][k]), k
    one = r0["one"]
    outs = dict(r0["out"], loss=r0["loss"])
    want = {k: refs[f"gnn/{case}/{k}"] for k in outs}
    assert _gnn_bad(outs, want) == []
    assert _gnn_bad(outs, dict(one["out"], loss=one["loss"])) == []
    want = {k: refs[f"gnn/{case}/grad/{k}"] for k in r0["grads"]}
    assert sorted(r0["grads"]) == sorted(one["grads"])
    assert _gnn_bad(r0["grads"], want, _gnn_grad_scale(want)) == []
    assert _gnn_bad(r0["grads"], one["grads"],
                    _gnn_grad_scale(one["grads"])) == []


@pytest.mark.parametrize("case", list(ranks.GNN_CASES))
def test_gnn_train_steps_under_the_mesh_equal_the_reference(spawned, case):
    """Two steps of the config's train step (bf16 gradients, AdamW, the
    global norm over the blocks) on the placed parameters: every rank's
    losses and grad norms alike, equal to the reference's
    ``make_train_step`` jitted with ``in_shardings`` on the Auto mesh and
    to the single-device port's (rtol 1e-5), and the gathered parameters
    and moments within ``STATE_ATOL`` of both."""
    res, refs = spawned["res"], spawned["refs"]
    r0 = res[0][f"gnn/{case}"]
    for r in res[1:]:
        assert r[f"gnn/{case}"]["metrics"] == r0["metrics"]
    for i, (loss, norm) in enumerate(r0["metrics"]):
        np.testing.assert_allclose(loss, refs[f"gnn/{case}/loss{i}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(norm, refs[f"gnn/{case}/norm{i}"],
                                   rtol=1e-5)
        np.testing.assert_allclose((loss, norm), r0["one"]["metrics"][i],
                                   rtol=1e-5)
    want = {k: refs[f"gnn/{case}/{k}"] for k in r0["state"]}
    assert max(_state_err(r0["state"], want).values()) < STATE_ATOL
    assert max(_state_err(r0["state"], r0["one"]["state"]).values()) \
        < STATE_ATOL


def test_gnn_gradient_summed_over_model_too_fails(spawned):
    """The mutation that sums every node-side replicated weight's gradient
    over ``model`` as well as the node axes (the ranks along ``model``
    ran the same node block) doubles the replicated ones at model 2 (and
    adds the other rank's block to the FFN's "tensor" blocks): the check
    of the gathered gradients against the reference then fails on node-side
    leaves only, and the edge-side and SO(2) leaves stay right."""
    refs = spawned["refs"]
    case = ranks.GNN_MUTANT_CASE
    r0 = spawned["res"][0][f"gnn/{case}"]
    want = {k: refs[f"gnn/{case}/grad/{k}"] for k in r0["grads"]}
    scale = _gnn_grad_scale(want)
    assert _gnn_bad(r0["grads"], want, scale) == []
    node_side = {"w_in", "head_w1", "head_w2", "ln_f", "layers/out_proj",
                 "layers/ln1", "layers/ln2", "layers/ffn_w1",
                 "layers/ffn_gate", "layers/ffn_w2"}
    bad = set(_gnn_bad(r0["mutant_grads"], want, scale))
    assert bad and bad <= node_side, bad
    for k in node_side - {"layers/ffn_w1", "layers/ffn_gate",
                          "layers/ffn_w2"}:      # replicated: doubled
        torch.testing.assert_close(r0["mutant_grads"][k], 2 * r0["grads"][k])


def test_gnn_param_logical_axes_and_shapes_equal_the_reference():
    """``param_logical_axes`` is the reference's at the smoke and the full
    configs; ``param_shapes`` is the shape of each of the reference's
    ``init_params`` leaves."""
    from repro.configs import equiformer_v2 as jcfg
    from repro.models.gnn import equiformer as jeq
    from repro_torch.configs import equiformer_v2 as tcfg
    from repro_torch.models.gnn import equiformer as teq
    for tc, jc in ((tcfg.smoke_config(), jcfg.smoke_config()),
                   (tcfg.full_config("molecule"),
                    jcfg.full_config("molecule"))):
        assert teq.param_logical_axes(tc) == jeq.param_logical_axes(jc)
        shapes = jax.eval_shape(lambda k, c=jc: jeq.init_params(c, k),
                                jax.random.key(0))
        want = jax.tree.map(lambda a: tuple(a.shape), shapes)
        assert teq.param_shapes(tc) == want


def test_gnn_init_params_keeps_the_single_device_blocks(spawned):
    """``init_params(mesh=)`` draws one device's numbers and keeps this
    rank's block of every leaf: the SO(2) weights' output columns and the
    FFN's 2C over ``model`` (halves at model 2, quarters at 4), the rest
    whole."""
    C, L = 16, 2
    for r in spawned["res"]:
        for case, (_, _, model, _, _, _) in ranks.GNN_CASES.items():
            x = r[f"gnn/{case}"]
            assert x["drawn_equal"], case
            assert x["blocks"]["layers/w0"] == (2, 2 * (L + 1) * C,
                                                (L + 1) * C // model)
            assert x["blocks"]["layers/wi1"] == (2, 2 * L * C, L * C // model)
            assert x["blocks"]["layers/ffn_w1"] == (2, L + 1, C,
                                                    2 * C // model)
            assert x["blocks"]["layers/ffn_w2"] == (2, L + 1, 2 * C // model,
                                                    C)
            assert x["blocks"]["layers/rad_w"] == (2, 8, 2 * (L + 1) * C)


def test_traced_mesh_counts_what_gloo_is_handed_for_a_gnn_forward(spawned):
    """One GNN forward at (data 4, model 2) under ``DEFAULT_RULES``, dense
    and chunked: on every rank the ``TracedMesh`` of that rank, run on
    meta copies, records what the real ``Mesh`` handed gloo, to the byte
    and by kind and group: the node features' all-gathers over ``data``,
    the SO(2) weights' over ``model``, the segment max and the edge sums'
    all-reduces over data x model, the FFN's over ``model`` and the mean
    pool's over ``data``."""
    for rank, r in enumerate(spawned["res"]):
        for case in ranks.GNN_COUNT_CASES:
            real, traced = (r[f"gnn/{case}"][f"count/{t}"]
                            for t in ("real", "traced"))
            assert real and real == traced, (rank, case)
            kinds = {(x["kind"], x["group"]) for x in real}
            assert kinds == {("all-gather", 4), ("all-gather", 2),
                             ("all-reduce", 8), ("all-reduce", 2),
                             ("all-reduce", 4)}, kinds


def test_gnn_train_state_saved_on_8_ranks_restores_onto_4_and_one(spawned):
    """The GNN's train state after two steps on (data 4, model 2), saved by
    ``save(mesh=)`` with its parameters' and moments' axes, restores onto
    (data 2, model 2) (each rank's "tensor" blocks) and onto one device,
    whole: both equal the state the 8 ranks gathered, bit for bit, at
    step 2."""
    saved = spawned["res"][0][f"gnn/{ranks.GNN_CKPT_CASE}"]["state"]
    one = spawned["restored"][0]["gnn_one"]
    for got in [r["gnn"] for r in spawned["restored"]] + [one]:
        assert got["step"] == 2 and got["opt_step"] == 2
        assert sorted(got["state"]) == sorted(saved)
        for k, a in saved.items():
            assert torch.equal(got["state"][k], a), k
    assert spawned["restored"][0]["gnn"]["w0"] == (2, 96, 24)
    assert one["w0"] == (2, 96, 48)


@pytest.mark.parametrize("multi_pod", [False, True])
def test_graph_split_of_every_gnn_cell_on_the_production_meshes(multi_pod):
    """Rank 0's rows of each GNN cell on the reference's production meshes
    under ``DEFAULT_RULES``: every cell's padded E splits over every rank;
    full_graph_sm's N 2,708 is no multiple of ``data`` 16, so its nodes
    stay whole at (16, 16) and go over ``pod`` alone at (2, 16, 16);
    ogb_products' 2,449,408 nodes and 61,859,328 edges give a rank 153,088
    and 241,638 at (16, 16)."""
    from repro_torch.configs import equiformer_v2 as ecfg
    from repro_torch.distributed.sharding import graph_split, sharding_ctx
    mesh = make_production_mesh(multi_pod=multi_pod, rank=0)
    pod = ("pod",) if multi_pod else ()
    want = {  # shape -> (node axes, nodes a rank)
        "full_graph_sm": (pod, 1354 if multi_pod else 2708),
        "minibatch_lg": (pod + ("data",), 169_984 // (32 if multi_pod
                                                     else 16)),
        "ogb_products": (pod + ("data",), 2_449_408 // (32 if multi_pod
                                                       else 16)),
        "molecule": (pod + ("data",), 3840 // (32 if multi_pod else 16))}
    for shape, c in ecfg.CELLS.items():
        with sharding_ctx(mesh, DEFAULT_RULES):
            sp = graph_split(c["n_nodes"], c["n_edges"])
        assert sp.edge_axes == pod + ("data", "model"), shape
        assert sp.edge_rows == c["n_edges"] // mesh.size, shape
        assert (sp.node_axes, sp.node_rows) == want[shape], shape
    if not multi_pod:
        with sharding_ctx(mesh, DEFAULT_RULES):
            sp = graph_split(2_449_408, 61_859_328)
        assert (sp.node_rows, sp.edge_rows) == (153_088, 241_638)
