"""Rank bodies of ``tests/test_torch_distributed.py``: spawned gloo ranks
on the CPU that run the port's sharded paths (flash decode, the fused
step's commit, prefill, ``moe_ep`` and its gradient, ``_sharded_argmax``,
the dense LM's placement over (data 4, model 2), (data 2, model 4) and
(data 1, model 8) — prefill, tree step and the session's fused step on
both KV layouts, query heads that split off one KV head, and guided
serving through the engine — the parameter blocks of
``init_params``/``shard_params``, checkpoints saved under one mesh or
by the JAX package and restored under another, and the train step under
the mesh: ``make_train_step`` on placed parameters and AdamW state, its
checkpoint, the train CLI inside ``sharding_ctx``, and an MoE's train step
under sequence parallelism, and the four recommenders placed over the
mesh: their serve cells and train steps, and a W&D train state saved on
8 ranks and restored on 4 and on one device, and EquiformerV2 placed over
the mesh: its forward, loss, gradients and train steps on the dense and
chunked paths, and its train state saved on 8 ranks and restored on 4 and
on one device), check what they can against
the port's single-device paths, and leave their outputs in
``<dir>/rank<r>.pt`` for the test to hold against the JAX package's
sharded functions.  Imports torch and the port only, so a spawned rank
does not import JAX."""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import lm_common
from repro_torch.core import reference_decode
from repro_torch.core.request import SamplingParams
from repro_torch.distributed.flash_decode import cache_partition_spec
from repro_torch.distributed.sharding import (DEFAULT_RULES, NamedSharding,
                                              P, TracedMesh, placement,
                                              sharding_ctx, sum_grad)
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tx
from repro_torch.models.params import (init_params, params_from_jax,
                                       shard_params, tree_to_torch)
from repro_torch.serving import api
from repro_torch.serving.sampler import _sharded_argmax
from repro_torch.serving.session import make_session_fns
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.optimizer import (_norm_and_scale, adamw_init,
                                            adamw_update, split_axes,
                                            tree_map)
from repro_torch.training.train_step import make_train_step

ATOL = 3e-5           # flash decode against dense, as the reference's test
MOE_ATOL = 1e-4
COMMIT_ARGS = ("lens", "toks", "pos", "mask", "parent", "n_live")
TREE_ARGS = ("ctoks", "pos", "mask", "parent", "n_live")
TRAIN_RULES = DEFAULT_RULES.override(residual_seq=("model",))  # train_4k's
RULES = {"default": DEFAULT_RULES,
         "serve": DEFAULT_RULES.override(fsdp=()),   # the serve cells'
         "train": TRAIN_RULES}
# The dense LM's placement cases: mesh (data, model), rules, V, K, KV
# layout, decode backend, H.  V 97 keeps the vocab whole, V 96 splits it; K
# 2 at model 4 splits a head of wk/wv (each rank computes every KV head).
# H 12 at model 8: a rank's wq columns hold a head and a half (q gathered,
# every rank attends with all heads); H 12, K 3 at model 2: a rank's 6
# query heads read two KV heads (one attention call a run of heads).
TP_CASES = {
    "d42": (4, 2, "default", 97, 4, "dense", "cuda", 8),
    "p42": (4, 2, "serve", 96, 4, "paged", "cuda", 8),
    "d24": (2, 4, "default", 96, 2, "dense", "cuda", 8),
    "p24": (2, 4, "serve", 97, 4, "paged", "cuda", 8),
    "f24": (2, 4, "default", 96, 4, "dense", "flash_decode", 8),
    "g24": (2, 4, "serve", 97, 2, "dense", "flash_decode", 8),
    "s24": (2, 4, "default", 96, 2, "paged", "cuda", 8),
    "h18": (1, 8, "serve", 96, 2, "dense", "cuda", 12),
    "h42": (4, 2, "default", 97, 3, "paged", "cuda", 12),
    "f18": (1, 8, "serve", 97, 2, "dense", "flash_decode", 12),
}
WORLD8_MESHES = ((4, 2), (2, 4), (1, 8))   # (data, model) of world8
TP_LANES, TP_BLOCKS = 4, 17         # 4 lanes of 4 blocks of 16, + NULL
# guided serving under a mesh: (data, model), rules, KV layout, whether the
# guide takes the vocab offset (else the session gathers the vocab for it)
SERVE_CASES = {
    "d42": (4, 2, "serve", "dense", True),
    "p24": (2, 4, "default", "paged", False),
}
SERVE_NEW = 12


def flash_cfg(n_kv_heads: int, backend: str) -> tx.TransformerConfig:
    """The reference test's model (2 layers, d 64, 8 heads of 8), f32."""
    return tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                n_kv_heads=n_kv_heads, d_ff=128,
                                vocab_size=97, max_seq_len=64,
                                prefill_backend="dense",
                                decode_backend=backend)


def moe_cfg() -> tx.TransformerConfig:
    return tx.TransformerConfig(n_layers=2, d_model=32, n_heads=4,
                                n_kv_heads=2, d_ff=0, vocab_size=64, moe=True,
                                n_experts=8, top_k=2, moe_d_ff=16,
                                n_shared_experts=1)


def ckpt_cfg() -> tx.TransformerConfig:
    """Qwen3-MoE-30B-A3B's smoke config (8 experts, top 2) through
    ``moe_impl="auto"`` at capacity factor E / top_k, where nothing drops,
    so ``moe_ep`` under a mesh equals ``moe_ref`` without one."""
    from repro_torch.configs import qwen3_moe_30b_a3b
    cfg = qwen3_moe_30b_a3b.smoke_config()
    return dataclasses.replace(cfg, moe_impl="auto",
                               capacity_factor=cfg.n_experts / cfg.top_k)


def tp_cfg(V: int, K: int, kv_layout: str = "dense",
           backend: str = "cuda", H: int = 8) -> tx.TransformerConfig:
    """The flash test's model at vocab V, K KV heads and H query heads of
    8, f32; the cuda backends take their plain versions on the CPU."""
    return tx.TransformerConfig(n_layers=2, d_model=64, n_heads=H,
                                head_dim=8, n_kv_heads=K, d_ff=128,
                                vocab_size=V, max_seq_len=64,
                                prefill_backend="cuda",
                                decode_backend=backend, kv_layout=kv_layout,
                                kv_block_size=16)


def wkey(V: int, K: int, H: int = 8) -> str:
    """The inputs' key of ``tp_cfg``'s weights and tree-step arguments."""
    return f"w{V}_{K}" if H == 8 else f"w{V}_{K}h{H}"


def moe_train_cfg(shared: int, cf: float, impl: str = "auto"
                  ) -> tx.TransformerConfig:
    """The MoE train cases' model: 8 experts of d_ff 32, top 2, with
    ``shared`` shared experts, capacity factor ``cf``, trained through the
    dense attention and ``moe_impl`` ``impl`` ("auto": ``moe_ep`` under a
    mesh)."""
    return tx.TransformerConfig(n_layers=2, d_model=64, n_heads=8,
                                n_kv_heads=4, d_ff=0, vocab_size=96,
                                max_seq_len=64, moe=True, n_experts=8,
                                top_k=2, moe_d_ff=32, n_shared_experts=shared,
                                capacity_factor=cf, prefill_backend="dense",
                                moe_impl=impl)


def guided_bias(table: np.ndarray):
    """The guided bench model's +1e4 bias on the continuation
    ``table[position % phase, token]``; it takes the first id of a vocab
    block (``vocab_offset``), so under a mesh it biases the rank's own
    block."""
    guide = torch.from_numpy(table).long()
    phase = guide.shape[0]

    def bias(logits, tokens, positions, vocab_offset=0):
        nxt = guide[positions.long() % phase, tokens.long()] - vocab_offset
        inside = (nxt >= 0) & (nxt < logits.shape[-1])
        return logits.scatter_add(-1, nxt.clamp(0, logits.shape[-1] - 1)[
            ..., None], (inside * 1e4).to(logits.dtype)[..., None])

    return bias


def _init(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=240))


def _tree(d, prefix):
    """A nested dict of numpy arrays from the flat ``prefix/...`` keys."""
    out = {}
    for k, v in d.items():
        if not k.startswith(prefix + "/"):
            continue
        node = out
        parts = k[len(prefix) + 1:].split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return out


def _flash_case(mesh, ins, case, res):
    cfg = flash_cfg(int(ins[f"{case}/K"]), "dense")
    fcfg = dataclasses.replace(cfg, decode_backend="flash_decode")
    params = params_from_jax(cfg, _tree(ins, f"{case}/params"), device="cpu")
    cache = {n: torch.from_numpy(ins[f"{case}/{n}"]) for n in ("k", "v")}
    args = [torch.from_numpy(ins[f"{case}/{n}"])
            for n in ("lens", "toks", "pos", "mask")]
    B = args[0].shape[0]
    dense = {n: c.clone() for n, c in cache.items()}
    _, l_dense = tx.tree_step(cfg, params, dense, *args)
    spec = cache_partition_spec(mesh, B, cfg.max_seq_len, cfg.n_kv_heads,
                                cfg.n_heads)
    sh = NamedSharding(mesh, spec)
    with sharding_ctx(mesh):
        assert tx.cache_sharding(fcfg, B).spec == spec
        block = {n: sh.local(c).clone() for n, c in cache.items()}
        _, l_flash = tx.tree_step(fcfg, params, block, *args)
        l_flash = _whole(tx.Layout(fcfg, B).logits, l_flash)
    torch.testing.assert_close(l_flash, l_dense, atol=ATOL, rtol=0)
    for n in ("k", "v"):
        torch.testing.assert_close(block[n], sh.local(dense[n]), atol=ATOL,
                                   rtol=0)
    res[f"{case}/spec"] = tuple(spec)
    res[f"{case}/logits"] = l_flash
    res[f"{case}/k"] = sh.gather(block["k"])
    res[f"{case}/v"] = sh.gather(block["v"])


def _whole(sharding, x):
    """The global tensor of a block (itself where nothing is split)."""
    return x if sharding is None else sharding.gather(x)


def _commit_case(mesh, ins, res):
    """The fused step (``lm_common._serve_fn``) on the sequence-sharded
    cache of case b (K 1: 8 shards of 8 rows), cache_lens 6, a tree whose
    accepted path is slots 0, 2, 4 (tokens chosen by the test's inputs):
    commit moves row 8 (shard 1) to row 7 (shard 0) and row 10 to row 8."""
    cfg = flash_cfg(1, "dense")
    fcfg = dataclasses.replace(cfg, decode_backend="flash_decode")
    params = params_from_jax(cfg, _tree(ins, "b/params"), device="cpu")
    cache = {n: torch.from_numpy(ins[f"b/{n}"]) for n in ("k", "v")}
    args = tuple(torch.from_numpy(ins[f"commit/{n}"]) for n in COMMIT_ARGS)
    T = args[1].shape[1]
    dense = {n: c.clone() for n, c in cache.items()}
    dense, packed = lm_common._serve_fn(cfg)(params, dense, *args)
    assert packed[0, 0].item() == 3, packed
    assert packed[0, 1 + T:1 + T + 3].tolist() == [0, 2, 4], packed
    with sharding_ctx(mesh):
        sh = tx.cache_sharding(fcfg, 1)
        assert tuple(sh.spec) == (None, None, ("data", "model"), None, None)
        block = {n: sh.local(c).clone() for n, c in cache.items()}
        block, p_flash = lm_common._serve_fn(fcfg)(params, block, *args)
    assert torch.equal(p_flash, packed), (p_flash, packed)
    for n in ("k", "v"):
        torch.testing.assert_close(block[n], sh.local(dense[n]), atol=ATOL,
                                   rtol=0)
        res[f"commit/{n}"] = sh.gather(block[n])
    res["commit/packed"] = p_flash


def _prefill_case(mesh, ins, res):
    """prefill(cache=None) under the mesh keeps this rank's block, within
    ATOL of its block of the prefill without a mesh (the heads and the FFN
    are split over ``model``, whose partial sums add in another order)."""
    cfg = flash_cfg(1, "flash_decode")
    params = params_from_jax(cfg, _tree(ins, "b/params"), device="cpu")
    toks = torch.from_numpy(ins["prefill/toks"])
    lens = torch.from_numpy(ins["prefill/lens"])
    whole, l_whole = tx.prefill(cfg, params, toks, lens)
    with sharding_ctx(mesh):
        block, l_block = tx.prefill(cfg, params, toks, lens)
        sh = tx.cache_sharding(cfg, 2)
        l_block = _whole(tx.Layout(cfg, 2).logits_sharding(2), l_block)
    torch.testing.assert_close(l_block, l_whole, atol=ATOL, rtol=0)
    for n in ("k", "v"):
        torch.testing.assert_close(block[n], sh.local(whole[n]), atol=ATOL,
                                   rtol=0)
        res[f"prefill/{n}"] = sh.gather(block[n])
    res["prefill/logits"] = l_block
    res["prefill/block_shape"] = tuple(block["k"].shape)


def _moe_case(mesh, ins, res):
    x, wr = (torch.from_numpy(ins[f"moe/{n}"]) for n in ("x", "wr"))
    full = [torch.from_numpy(ins[f"moe/{n}"]) for n in ("wg", "wu", "wd")]
    k = int(ins["moe/k"])
    experts = NamedSharding(mesh, P("model", None, None))
    wg, wu, wd = (experts.local(w).clone() for w in full)
    ref = moe.moe_ref(x, wr, *full, k)
    for cf in (8.0, 1.0):
        out = moe.moe_ep(x, wr, wg, wu, wd, k, cf, mesh)
        if cf == 8.0:
            torch.testing.assert_close(out, ref, atol=MOE_ATOL, rtol=0)
        res[f"moe/out_{cf}"] = out
        w = wg.clone().requires_grad_(True)
        moe.moe_ep(x, wr, w, wu, wd, k, cf, mesh).sum().backward()
        res[f"moe/grad_{cf}"] = w.grad
    res["moe/model_index"] = mesh.axis_index("model")


def _argmax_case(mesh, ins, res):
    """The (4, 3, 96) logits as vocab-sharded blocks, the lanes over
    ``data``: each rank's choice for its lanes, gathered."""
    logits = torch.from_numpy(ins["argmax/logits"])
    sh = NamedSharding(mesh, P("data", None, "model"))
    got = _sharded_argmax(sh.local(logits), sh)
    got = NamedSharding(mesh, P("data", None)).gather(got)
    assert torch.equal(got, logits.argmax(-1).int()), (got, logits.argmax(-1))
    res["argmax"] = got


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _params_case(mesh, res):
    """``init_params(mesh=)`` and ``shard_params`` give every leaf its
    block under each rule set (the expert E/ep block, the fsdp × tensor
    blocks of the dense weights, the norms whole), bit for bit the
    single-device draw's."""
    for cfg in (moe_cfg(), tp_cfg(96, 2)):
        whole = init_params(cfg, seed=0, device="cpu")
        axes, shapes = tx.param_logical_axes(cfg), tx.param_shapes(cfg)
        flat_axes, flat_shapes = dict(_leaves(axes)), dict(_leaves(shapes))
        for rname, rules in RULES.items():
            with sharding_ctx(mesh, rules):
                mine = dict(_leaves(init_params(cfg, seed=0, device="cpu",
                                                mesh=mesh)))
                cut = dict(_leaves(shard_params(cfg, whole, mesh)))
            for name, a in _leaves(whole):
                pl = placement(mesh, flat_axes[name], flat_shapes[name],
                               rules)
                want = pl.local(a)
                assert tuple(mine[name].shape) == pl.shard_shape(a.shape)
                assert torch.equal(mine[name], want), (rname, name)
                assert torch.equal(cut[name], want), (rname, name)
                kind = "moe" if cfg.moe else "dense"
                res[f"params/{kind}/{rname}/{name}"] = (
                    tuple(mine[name].shape), tuple(pl.spec))
    res["params/we_gate_shape"] = res["params/moe/default/layers/we_gate"][0]


@contextlib.contextmanager
def _lanes_run(log):
    """Append to ``log`` the lanes (rows of the token block) of each model
    forward this rank runs: ``tx._self_forward`` (the prefills) and
    ``tx._tree_forward`` (the tree steps and the suffix prefill)."""
    saved = tx._self_forward, tx._tree_forward

    def wrap(fn, i):
        def run(*a, **k):
            log.append(int(a[i].shape[0]))
            return fn(*a, **k)
        return run
    tx._self_forward, tx._tree_forward = wrap(saved[0], 2), wrap(saved[1], 3)
    try:
        yield log
    finally:
        tx._self_forward, tx._tree_forward = saved


def _pool(cache):
    """A copy of this rank's paged K and V, the NULL block excepted."""
    return torch.stack([cache["k"][:, 1:], cache["v"][:, 1:]]).clone()


def _tp_case(meshes, ins, name, res):
    """One placement case (``TP_CASES``): the parameters cut by
    ``shard_params`` (every leaf's shape its ``placement`` block), the
    cohort prefill (the dense cache made by ``prefill(cache=None)``, the
    paged pool through the block tables), on the paged pool a suffix
    prefill (``_suffix_err``), a tree step on a copy of that cache, and
    the session's fused step on it (greedy choice through
    ``_sharded_argmax``, the sampled branch's vocab gather run alongside,
    its lanes greedy).  Logits and caches are gathered for the test; on
    the paged pool the lanes each call ran on this rank and the rank's
    pool after each call that writes it are kept too."""
    data, model, rname, V, K, layout, backend, H = TP_CASES[name]
    mesh, rules = meshes[(data, model)], RULES[rname]
    cfg = tp_cfg(V, K, layout, backend, H)
    paged = layout == "paged"
    whole = params_from_jax(cfg, _tree(ins, f"{wkey(V, K, H)}/params"),
                            device="cpu")
    toks, lens, tables = (torch.from_numpy(ins[f"tp/{n}"])
                          for n in ("toks", "lens", "tables"))
    tree = {n: ins[f"{wkey(V, K, H)}/{n}"] for n in TREE_ARGS}
    ct = {n: torch.from_numpy(a) for n, a in tree.items()}
    lanes = {c: [] for c in ("prefill", "tree", "suffix", "fused")}
    pools = []
    with sharding_ctx(mesh, rules):
        params = shard_params(cfg, whole, mesh)
        axes = dict(_leaves(tx.param_logical_axes(cfg)))
        shapes = dict(_leaves(tx.param_shapes(cfg)))
        shapes_ok = all(
            tuple(a.shape) == placement(mesh, axes[k], shapes[k],
                                        rules).shard_shape(shapes[k])
            for k, a in _leaves(params))
        lay = tx.Layout(cfg, TP_LANES, paged)
        if paged:
            cache = tx.init_paged_cache(cfg, TP_LANES, TP_BLOCKS,
                                        device="cpu")
            cache["block_tables"] = tables
            with _lanes_run(lanes["prefill"]):
                cache, l_pre = tx.prefill_paged(cfg, params, toks, lens,
                                                cache)
            pools.append(_pool(cache))
            held, step = tx.paged_sharding(cfg), tx.tree_step_paged
        else:
            cache, l_pre = tx.prefill(cfg, params, toks, lens)
            held, step = lay.cache, tx.tree_step
        res[f"{name}/block"] = tuple(cache["k"].shape)
        res[f"{name}/pre_logits"] = _whole(lay.logits_sharding(2), l_pre)
        for n in ("k", "v"):
            res[f"{name}/pre_{n}"] = held.gather(cache[n])
        copy = dict(cache, k=cache["k"].clone(), v=cache["v"].clone())
        with _lanes_run(lanes["tree"]):
            _, l_tree = step(cfg, params, copy, lens, ct["ctoks"],
                             ct["pos"], ct["mask"])
        res[f"{name}/tree_logits"] = _whole(lay.logits, l_tree)
        if paged:
            pools.append(_pool(copy))
            res[f"{name}/suffix_err"] = _suffix_err(
                cfg, whole, params, cache, lay, toks, lens, tables,
                lanes["suffix"], pools)
        fns = make_session_fns(cfg, params, slots=ct["ctoks"].shape[1],
                               device="cpu")
        with _lanes_run(lanes["fused"]):
            cache, packed = fns.fused_step(cache, ins["tp/lens"],
                                           *(tree[n] for n in TREE_ARGS))
        res[f"{name}/packed"] = packed
        for n in ("k", "v"):
            res[f"{name}/{n}"] = held.gather(cache[n])
        if paged:
            pools.append(_pool(cache))
            res[f"{name}/lanes"] = lanes
            res[f"{name}/pools"] = pools
    res[f"{name}/shapes_ok"] = shapes_ok
    res[f"{name}/lane_axes"] = lay.lane_axes
    res[f"{name}/heads"] = (lay.q_heads, lay.kv_heads, lay.kv_runs,
                            lay.q_gather, lay.q_block)
    res[f"{name}/logits_spec"] = (None if lay.logits is None
                                  else tuple(lay.logits.spec))


def _suffix_err(cfg, whole, params, cache, lay, toks, lens, tables, lanes,
                pools):
    """The suffix prefill (a prefix-cache hit: lane 1's last 8 prompt
    tokens at their offset, on a copy of the pool the cohort prefill
    filled) under the mesh against the single-device port's on the whole
    parameters and pool: max |difference| of the logits, each rank's K/V
    rows checked within ATOL too, the NULL block's garbage excepted (a
    rank that does not hold the lane writes its pad slots there).  The
    mesh call's lanes go to ``lanes``, its pool to ``pools``."""
    n = int(lens[1])

    def suffix(p, c):
        c = dict(c, k=c["k"].clone(), v=c["v"].clone())
        c, logits = tx.prefill_from_offset_paged(
            cfg, p, c, 1, toks[1:2, n - 8:n].contiguous(), lens[1:2] - 8,
            torch.tensor([8]), prefill_len=toks.shape[1])
        return c, logits

    with _lanes_run(lanes):
        blocks, got = suffix(params, cache)
    pools.append(_pool(blocks))
    got = _whole(lay.logits_sharding(2), got)
    with sharding_ctx(None):
        one = tx.init_paged_cache(cfg, TP_LANES, TP_BLOCKS, device="cpu")
        one["block_tables"] = tables
        one, _ = tx.prefill_paged(cfg, whole, toks, lens, one)
        one, want = suffix(whole, one)
    for k in ("k", "v"):
        torch.testing.assert_close(
            tx.paged_sharding(cfg).gather(blocks[k])[:, 1:], one[k][:, 1:],
            atol=ATOL, rtol=0)
    return (got - want).abs().max().item()


def _meta(tree):
    """A copy of a dict of tensors (nested, a cache too) on the meta
    device."""
    if isinstance(tree, dict):
        return {k: _meta(v) for k, v in tree.items()}
    return tree.to("meta")


def _count_case(mesh, ins, res):
    """What this rank hands gloo (``Mesh.collective_records``) for one
    paged fused step (``lm_common._serve_fn``: the FSDP gathers over
    ``data``, the row-parallel sums over ``model``, the vocab argmax, the
    pool rows' exchange over ``data``) and for one dense prefill, both
    under ``DEFAULT_RULES`` at the world's mesh, and what a
    ``TracedMesh`` of the same shape at this rank records for the same
    calls on meta copies of the same arguments."""
    traced = TracedMesh(mesh.shape, mesh.rank)
    pcfg, dcfg = tp_cfg(96, 4, "paged"), tp_cfg(96, 4)
    whole = params_from_jax(dcfg, _tree(ins, "w96_4/params"), device="cpu")
    toks, lens, tables = (torch.from_numpy(ins[f"tp/{n}"])
                          for n in ("toks", "lens", "tables"))
    tree = [torch.from_numpy(ins[f"w96_4/{n}"]) for n in TREE_ARGS]
    with sharding_ctx(mesh, DEFAULT_RULES):
        params = shard_params(pcfg, whole, mesh)
        pool = tx.init_paged_cache(pcfg, TP_LANES, TP_BLOCKS, device="cpu")
        pool["block_tables"] = tables
        pool, _ = tx.prefill_paged(pcfg, params, toks, lens, pool)

    def paged_fused(on):
        return lm_common._serve_fn(pcfg)(on(params), on(pool),
                                         *(on(x) for x in [lens] + tree))

    def dense_prefill(on):
        return tx.prefill(dcfg, on(params), on(toks), on(lens),
                          tx.init_cache(dcfg, TP_LANES,
                                        device=on(lens).device))

    for name, call in (("paged_fused", paged_fused),
                       ("dense_prefill", dense_prefill)):
        for tag, m, on in (("real", mesh, lambda x: x),
                           ("traced", traced, _meta)):
            with sharding_ctx(m, DEFAULT_RULES):
                m.reset_counts()
                call(on)
                res[f"count/{name}/{tag}"] = m.collective_records()


def _serve_case(meshes, ins, name, res):
    """Guided serving under the mesh through ``api.build_engine`` inside
    ``sharding_ctx`` (the lanes over ``data`` on the dense layout, the
    heads and vocab over ``model``), the requests served twice (the second
    pass drafts from the first's outputs): every output equals
    ``reference_decode`` through the same session under the same mesh."""
    data, model, rname, layout, offset = SERVE_CASES[name]
    mesh, rules = meshes[(data, model)], RULES[rname]
    cfg = tp_cfg(96, 2)
    bias = guided_bias(ins["guide/table"])
    transform = bias if offset else (lambda lg, t, p: bias(lg, t, p))
    prompts = json.loads(str(ins["guide/prompts"]))
    with sharding_ctx(mesh, rules):
        params = shard_params(cfg, params_from_jax(
            cfg, _tree(ins, "w96_2/params"), device="cpu"), mesh)
        engine = api.build_engine(api.EngineConfig(
            lanes=TP_LANES, prefill_len=16, decoding_length=4,
            branch_length=2, kv_layout=layout, block_size=16,
            default_params=SamplingParams(max_new_tokens=SERVE_NEW)),
            cfg, params, logits_transform=transform, device="cpu")
        steps = []
        for _ in range(2):     # the second pass drafts from the first's
            before = engine.stats.decode_steps
            handles = [engine.submit(list(p), max_new_tokens=SERVE_NEW)
                       for p in prompts]
            engine.run()
            outs = [[int(t) for t in h.result().tokens] for h in handles]
            steps.append(engine.stats.decode_steps - before)
            res[f"serve/{name}/{len(steps)}"] = outs
        refs = [reference_decode(engine.fns, p, SERVE_NEW) for p in prompts]
    assert outs == refs, (outs, refs)
    res[f"serve/{name}/steps"] = steps


GRAD_CASES = {  # mesh (data, model), rules, remat, with a loss mask, V, B,
    #              K, H
    "g42": (4, 2, "default", False, True, 96, 4, 2, 8),
    "g24": (2, 4, "serve", True, False, 96, 4, 2, 8),
    # the train_4k rules: the residual split over model (SP), the vocab
    # split (the head gathers the sequence) or whole (the head on blocks)
    "s42": (4, 2, "train", False, True, 96, 4, 2, 8),
    "s42v": (4, 2, "train", True, False, 97, 4, 2, 8),
    # B 2 on data 4: every data rank runs both lanes (replicated lanes)
    "r42": (4, 2, "default", False, True, 96, 2, 2, 8),
    # TP_CASES' head shapes: q gathered (under SP), runs of heads
    "h18": (1, 8, "train", False, True, 96, 4, 2, 12),
    "h42": (4, 2, "default", True, False, 97, 4, 3, 12),
}
# The train step under a mesh: mesh (data, model), rules, K, microbatches,
# grad_dtype, remat; the reference's train_4k step (lr 3e-4) on the
# placement cases' V 96 weights, 2 steps of B 8 x S 16
TRAIN_CASES = {
    "t42": (4, 2, "train", 4, 1, None, False),
    "b42": (4, 2, "train", 4, 1, "bfloat16", True),
    "t24": (2, 4, "default", 2, 2, None, False),
    "a42": (4, 2, "train", 4, 4, None, False),   # microbatches of 2 lanes
}
# The MoE train cases: the train_4k rules on (data 4, model 2), the
# placement cases' B 8 (2 lanes a data rank) x S 16, with or without a
# shared expert, at capacity factor 1.25, where rows drop and the token
# groups decide which (``moe_ep``'s are the reference's: a rank's chunk of
# its lanes' (lane, position) order, not the residual's sequence block),
# and at E / top_k = 4, where nothing drops and one device's ``moe_ref``
# computes the same function.  ``moe_ref`` and ``moe_local`` under the mesh
# run every expert on a rank's tokens (``moe_local`` routing all of the
# call's, whose capacity decides which rows drop): mesh (data, model),
# rules, shared experts, capacity factor, moe_impl
MOE_TRAIN_CASES = {
    "m42": (4, 2, "train", 1, 1.25, "auto"),
    "n42": (4, 2, "train", 0, 1.25, "auto"),
    "m42x": (4, 2, "train", 1, 4.0, "auto"),
    "n42x": (4, 2, "train", 0, 4.0, "auto"),
    "r42": (4, 2, "train", 1, 1.25, "ref"),
    "l42": (4, 2, "train", 0, 1.25, "local"),
}
TRAIN_LR = 3e-4
TRAIN_CKPT_CASE = "t42"    # saved after step 1 on 8 ranks, resumed on 4
# the train CLI on Qwen2's smoke config (K 1: a head of wk split at model
# 2): 3 steps and a checkpoint on mesh (2, 2), resumed to step 5 on (1, 2)
CLI_ARGS = ["--smoke", "--device", "cpu", "--seq", "32", "--accum", "2"]
CLI_STEPS = (3, 5)


def _grad_case(meshes, ins, name, res):
    """``lm_loss`` and its gradient under the mesh (B lanes of 16 tokens,
    the dense attention): each rank's gradient of each of its parameter
    blocks against its block of the single-device gradient, and the loss
    against the single-device loss."""
    data, model, rname, remat, masked, V, B, K, H = GRAD_CASES[name]
    mesh, rules = meshes[(data, model)], RULES[rname]
    cfg = dataclasses.replace(tp_cfg(V, K, H=H), prefill_backend="dense",
                              remat=remat)
    whole = params_from_jax(cfg, _tree(ins, f"{wkey(V, K, H)}/params"),
                            device="cpu")
    toks = torch.from_numpy(ins["tp/toks"][:B, :17])
    mask = (torch.arange(16)[None, :] < torch.tensor([[16], [9], [12], [5]])
            [:B]).float() if masked else None

    def grads(params):
        params = {k: ({n: a.detach().clone().requires_grad_()
                       for n, a in v.items()} if isinstance(v, dict)
                      else v.detach().clone().requires_grad_())
                  for k, v in params.items()}
        loss = tx.lm_loss(cfg, params, toks[:, :16], toks[:, 1:], mask)
        loss.backward()
        return loss.detach(), dict((k, a.grad) for k, a in _leaves(params))

    loss1, g1 = grads(whole)
    axes = dict(_leaves(tx.param_logical_axes(cfg)))
    with sharding_ctx(mesh, rules):
        loss2, g2 = grads(shard_params(cfg, whole, mesh))
    err = max((g2[k] - placement(mesh, axes[k], g1[k].shape, rules).local(
        g1[k])).abs().max().item() for k in g1)
    res[f"{name}/loss"] = (float(loss1), float(loss2))
    res[f"{name}/grad_err"] = err
    res[f"{name}/grad_scale"] = max(g.abs().max().item() for g in g1.values())
    with sharding_ctx(mesh, rules):
        lay = tx.Layout(cfg, B, seq=16)
    res[f"{name}/split"] = (lay.lane_axes, lay.seq_axes, lay.head_seq)


def _refusals(meshes, res):
    """A serving call under the train_4k rules (a live ``residual_seq``)
    raises, naming ROADMAP A16b."""
    cfg = tp_cfg(96, 2)
    params = init_params(cfg, seed=0, device="cpu")
    toks = torch.ones((2, cfg.max_seq_len), dtype=torch.int32)
    with sharding_ctx(meshes[(4, 2)], TRAIN_RULES):
        params = shard_params(cfg, params, meshes[(4, 2)])
        try:
            tx.prefill(cfg, params, toks, torch.tensor([8, 8]))
        except NotImplementedError as exc:
            res["serve_sp_refusal"] = str(exc)


def train_cfg(K: int, remat: bool) -> tx.TransformerConfig:
    """The placement cases' model at V 96 and K KV heads, trained through
    the dense attention."""
    return dataclasses.replace(tp_cfg(96, K), prefill_backend="dense",
                               remat=remat)


def train_batch(ins, i):
    """Step i's global batch: 8 rows of 16 tokens and their labels."""
    t = torch.from_numpy(ins["train/toks"][i])
    return {"tokens": t[:, :-1].contiguous(), "labels": t[:, 1:].contiguous()}


def train_step(cfg, accum, grad_dtype):
    return make_train_step(
        lambda p, b: tx.lm_loss(cfg, p, b["tokens"], b["labels"]),
        lr=TRAIN_LR, accum_steps=accum, grad_dtype=grad_dtype,
        axes=tx.param_logical_axes(cfg), shapes=tx.param_shapes(cfg))


def gathered_state(mesh, cfg, params, opt, rules):
    """The whole parameters and moments (``p/...``, ``mu/...``,
    ``nu/...``) and the step, gathered from this rank's blocks."""
    axes = dict(_leaves(tx.param_logical_axes(cfg)))
    shapes = dict(_leaves(tx.param_shapes(cfg)))
    out = {"step": opt.step.clone()}
    for tag, tree in (("p", params), ("mu", opt.mu), ("nu", opt.nu)):
        for k, a in _leaves(tree):
            out[f"{tag}/{k}"] = placement(mesh, axes[k], shapes[k],
                                          rules).gather(a)
    return out


def _residual_case(mesh, ins, whole, cfg, res):
    """Under the train_4k rules a rank's residual after the layers (what
    remat saves between them) is its (B/4, S/2, d) block of lanes and
    sequence, equal to that block of the single-device hidden states."""
    toks = train_batch(ins, 0)["tokens"]
    one = tx._train_hidden(cfg, whole, toks)
    with sharding_ctx(mesh, TRAIN_RULES):
        lay = tx.Layout(cfg, toks.shape[0], seq=toks.shape[1])
        h = tx._train_hidden(cfg, shard_params(cfg, whole, mesh),
                             lay.local(toks), lay)
    B, S = toks.shape
    assert tuple(h.shape) == (B // 4, S // 2, cfg.d_model), h.shape
    torch.testing.assert_close(h, lay.residual.local(lay.local(one)),
                               atol=ATOL, rtol=0)
    res["train/residual"] = (tuple(h.shape), lay.seq_axes)
    with sharding_ctx(mesh, TRAIN_RULES):        # model 2 does not divide 15
        res["train/odd_seq"] = tx.Layout(cfg, B, seq=S - 1).seq_axes


def _train_case(meshes, ins, name, directory, res):
    """Two train steps under the mesh (``TRAIN_CASES``) from the placed
    parameters and ``adamw_init`` of them: each step's loss and grad_norm
    (alike on every rank), then the gathered parameters and moments.  The
    checkpoint case saves the state after step 1 through the CLI's save
    call, and refuses the save the CLI made before moments had axes."""
    data, model, rname, K, accum, gdt, remat = TRAIN_CASES[name]
    mesh, rules = meshes[(data, model)], RULES[rname]
    cfg = train_cfg(K, remat)
    whole = params_from_jax(cfg, _tree(ins, f"w96_{K}/params"), device="cpu")
    if name == TRAIN_CKPT_CASE:
        _residual_case(mesh, ins, whole, cfg, res)
    step = train_step(cfg, accum, gdt)
    metrics = []
    with sharding_ctx(mesh, rules):
        params = shard_params(cfg, whole, mesh)
        opt = adamw_init(params)
        for i in range(2):
            params, opt, m = step(params, opt, train_batch(ins, i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
            if i == 0 and name == TRAIN_CKPT_CASE:
                train_cli.save_state(CheckpointManager(os.path.join(
                    directory, "train_ckpt")), 1, cfg, params, opt)
                saved = gathered_state(mesh, cfg, params, opt, rules)
                if mesh.rank == 0:
                    res["train/ckpt_state"] = saved
                _unplaced_save(mesh, cfg, params, opt, directory, res)
        state = gathered_state(mesh, cfg, params, opt, rules)
    res[f"train/{name}/metrics"] = metrics
    res[f"train/{name}/mu_block"] = tuple(opt.mu["layers"]["wq"].shape)
    if mesh.rank == 0:
        res[f"train/{name}/state"] = state


def _moe_train_case(meshes, ins, name, res):
    """Two train steps of an MoE (``MOE_TRAIN_CASES``) under the mesh
    from its placed parameters: each step's loss and grad_norm, the
    gathered state, and the rows ``moe_local`` dropped on this rank
    (``moe_local.dropped``)."""
    data, model, rname, shared, cf, impl = MOE_TRAIN_CASES[name]
    mesh, rules = meshes[(data, model)], RULES[rname]
    cfg = moe_train_cfg(shared, cf, impl)
    whole = params_from_jax(cfg, _tree(ins, f"moe{shared}/params"),
                            device="cpu")
    step, metrics = train_step(cfg, 1, None), []
    moe.moe_local.dropped = drops = []
    try:
        with sharding_ctx(mesh, rules):
            params = shard_params(cfg, whole, mesh)
            opt = adamw_init(params)
            for i in range(2):
                params, opt, m = step(params, opt, train_batch(ins, i))
                metrics.append((float(m["loss"]), float(m["grad_norm"])))
            state = gathered_state(mesh, cfg, params, opt, rules)
            lay = tx.Layout(cfg, 8, seq=16)
    finally:
        moe.moe_local.dropped = None
    res[f"moe_train/{name}/metrics"] = metrics
    res[f"moe_train/{name}/dropped"] = int(sum(drops))
    res[f"moe_train/{name}/split"] = (lay.lane_axes, lay.seq_axes,
                                      lay.ffn_axes)
    if mesh.rank == 0:
        res[f"moe_train/{name}/state"] = state


def _unplaced_save(mesh, cfg, params, opt, directory, res):
    """``save(mesh=)`` of the train state with the moments' axes None (as
    the CLI saved before): the moment blocks would be written as whole
    arrays, so it raises naming the key, and nothing is written."""
    axes, shapes = tx.param_logical_axes(cfg), tx.param_shapes(cfg)
    bad = CheckpointManager(os.path.join(directory, "train_unplaced"))
    try:
        bad.save(1, {"p": params, "o": opt}, logical_axes={"p": axes,
                                                           "o": None},
                 shapes={"p": shapes, "o": None}, mesh=mesh)
    except ValueError as exc:
        res["train/unplaced"] = str(exc)
    res["train/unplaced_written"] = bad.all_steps()


def _norm_case(mesh, res):
    """The global norm under ``DEFAULT_RULES`` on (data 4, model 2): a
    (8, 8) leaf of ones split over model and data (each rank's (4, 2)
    block) and a (4,) leaf of twos replicated on every rank give
    sqrt(64 + 16); a whole leaf where the rules split it raises, and so
    does ``adamw_update`` under the mesh without the placements."""
    axes = {"a": ("tensor", "fsdp"), "b": (None,)}
    shapes = {"a": (8, 8), "b": (4,)}
    grads = {"a": torch.ones(4, 2), "b": torch.full((4,), 2.0)}
    with sharding_ctx(mesh):
        split = split_axes(grads, axes, shapes)
        res["norm/split"] = split
        res["norm/value"] = float(_norm_and_scale(grads, 1.0, split)[0])
        try:
            split_axes(dict(grads, a=torch.ones(8, 8)), axes, shapes)
        except ValueError as exc:
            res["norm/whole_refused"] = str(exc)
        try:
            adamw_update(grads, grads, adamw_init(grads))
        except ValueError as exc:
            res["norm/no_axes_refused"] = str(exc)


def _checkpoint_saves(mesh, directory, res):
    """``save(mesh=)`` under ``DEFAULT_RULES`` (no ``sharding_ctx``): a
    leaf split over model (its "batch" dim is no parameter axis) and the
    smoke MoE's parameters with each rank's blocks, written whole; a
    (97, 8) leaf's (97, 2) block (also the block of a (194, 8) one)
    refused without its global shape and written with it; a whole leaf
    that the rules split, and parameters placed under the serve rules,
    refused."""
    x = torch.arange(64.0).reshape(8, 8)
    cfg = ckpt_cfg()
    CheckpointManager(os.path.join(directory, "ckpt")).save(
        1, {"w": NamedSharding(mesh, P(None, "model")).local(x),
            "p": init_params(cfg, seed=3, device="cpu", mesh=mesh)},
        logical_axes={"w": ("batch", "tensor"),
                      "p": tx.param_logical_axes(cfg)},
        shapes={"w": (8, 8), "p": tx.param_shapes(cfg)}, mesh=mesh)
    y = torch.arange(97 * 8.0).reshape(97, 8)
    yb = placement(mesh, ("tensor", "fsdp"), (97, 8)).local(y)
    odd = CheckpointManager(os.path.join(directory, "ckpt_odd"))
    try:
        odd.save(1, {"y": yb}, logical_axes={"y": ("tensor", "fsdp")},
                 mesh=mesh)
    except ValueError as exc:
        res["ckpt_no_shape"] = str(exc)
    odd.save(1, {"y": yb}, logical_axes={"y": ("tensor", "fsdp")},
             mesh=mesh, shapes={"y": (97, 8)})
    with sharding_ctx(mesh, RULES["serve"]):
        served = init_params(cfg, seed=3, device="cpu", mesh=mesh)
    refused = CheckpointManager(os.path.join(directory, "ckpt_refused"))
    for name, tree, axes, shapes in (
            ("whole", {"w": x}, {"w": ("batch", "tensor")},
             {"w": (8, 8)}),
            ("serve", {"p": served}, {"p": tx.param_logical_axes(cfg)},
             {"p": tx.param_shapes(cfg)})):
        try:
            refused.save(1, tree, logical_axes=axes, shapes=shapes,
                         mesh=mesh)
        except ValueError as exc:
            res[f"ckpt_refused/{name}"] = str(exc)
    res["ckpt_refused/written"] = refused.all_steps()


def world8(rank: int, directory: str) -> None:
    """Mesh (data 4, model 2) over 8 gloo ranks."""
    _init(rank, 8, os.path.join(directory, "store8"))
    try:
        mesh = make_host_mesh(data=4, model=2)
        ins = dict(np.load(os.path.join(directory, "inputs.npz")))
        res = {}
        for case in ("a", "b"):
            _flash_case(mesh, ins, case, res)
        _commit_case(mesh, ins, res)
        _prefill_case(mesh, ins, res)
        _moe_case(mesh, ins, res)
        _argmax_case(mesh, ins, res)
        _params_case(mesh, res)
        meshes = {(4, 2): mesh}
        meshes.update({(d, m): make_host_mesh(data=d, model=m)
                       for d, m in WORLD8_MESHES if (d, m) not in meshes})
        for name in TP_CASES:
            _tp_case(meshes, ins, name, res)
        _count_case(mesh, ins, res)
        for name in SERVE_CASES:
            _serve_case(meshes, ins, name, res)
        for name in GRAD_CASES:
            _grad_case(meshes, ins, name, res)
        _refusals(meshes, res)
        _checkpoint_saves(mesh, directory, res)
        _norm_case(mesh, res)
        for name in TRAIN_CASES:
            _train_case(meshes, ins, name, directory, res)
        for name in MOE_TRAIN_CASES:
            _moe_train_case(meshes, ins, name, res)
        for name in RECSYS_CASES:
            _recsys_case(meshes, ins, name, directory, res)
        for name in GNN_CASES:
            _gnn_case(meshes, ins, name, directory, res)
        torch.save(res, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def world4(rank: int, directory: str) -> None:
    """The checkpoint of ``world8`` restored onto (data 2, model 2): the
    parameters equal ``shard_params`` of the single-device draw bit for
    bit, and the fused step's forward runs on them through ``moe_ep``
    (the experts split over ``model``, the dense weights placed, a head
    of wk split); then the checkpoint the JAX package saved of the
    placement cases' V 96, K 2 parameters, restored onto the same mesh,
    equals ``shard_params`` of them."""
    _init(rank, 4, os.path.join(directory, "store4"))
    try:
        mesh = make_host_mesh(data=2, model=2)
        cfg = ckpt_cfg()
        whole = init_params(cfg, seed=3, device="cpu")
        x = np.arange(64.0).reshape(8, 8)
        out, saved = CheckpointManager(os.path.join(directory, "ckpt")
                                       ).restore({"w": x, "p": whole},
                                                 mesh=mesh)
        params = tree_to_torch(out["p"], torch.device("cpu"))
        want = shard_params(cfg, whole, mesh)
        for name, a in want["layers"].items():
            assert torch.equal(params["layers"][name], a), name
        for name in ("embed", "ln_f"):
            assert torch.equal(params[name], want[name]), name
        B, T = 2, 4
        toks = torch.from_numpy(np.random.RandomState(7).randint(
            1, cfg.vocab_size, (B, 12)).astype(np.int32))
        lens = torch.tensor([12, 9], dtype=torch.int32)
        tree = (lens, toks[:, :T], lens[:, None] + torch.arange(T),
                torch.ones((B, T, T), dtype=torch.bool).tril())

        def forward(p):
            cache, _ = tx.prefill(cfg, p, toks, lens,
                                  tx.init_cache(cfg, B, device="cpu"))
            return tx.tree_step(cfg, p, cache, *tree)[1]

        ref = forward(whole)                    # moe_ref, no mesh
        with sharding_ctx(mesh):
            got = _whole(tx.Layout(cfg, B).logits, forward(params))  # moe_ep
        torch.testing.assert_close(got, ref, atol=MOE_ATOL, rtol=0)
        ins = dict(np.load(os.path.join(directory, "inputs.npz")))
        tcfg = tp_cfg(96, 2)
        jwhole = params_from_jax(tcfg, _tree(ins, "w96_2/params"),
                                 device="cpu")
        jout, jstep = CheckpointManager(os.path.join(directory, "jckpt")
                                        ).restore({"params": jwhole},
                                                  mesh=mesh)
        jwant = dict(_leaves(shard_params(tcfg, jwhole, mesh)))
        jgot = dict(_leaves(tree_to_torch(jout["params"],
                                          torch.device("cpu"))))
        jsame = sorted(jgot) == sorted(jwant) and all(
            torch.equal(jgot[k], jwant[k]) for k in jwant)
        res = {"w": out["w"], "step": saved, "coords": mesh.coords(),
               "we_gate": tuple(params["layers"]["we_gate"].shape),
               "logits": got, "jax_step": jstep, "jax_equal": jsame,
               "jax_wq": tuple(jgot["layers/wq"].shape)}
        _resumed_train(mesh, ins, directory, res)
        with sharding_ctx(mesh, TRAIN_RULES):
            cli = train_cli.main(CLI_ARGS + [
                "--steps", str(CLI_STEPS[0]), "--ckpt-every",
                str(CLI_STEPS[0]), "--ckpt-dir", os.path.join(directory,
                                                               "cli")])
        res["cli"] = {"losses": cli["losses"], "start": cli["start"]}
        res["recsys"] = recsys_restored(mesh, directory)
        res["gnn"] = gnn_restored(mesh, directory)
        if rank == 0:
            res["recsys_one"] = recsys_restored(None, directory)
            res["gnn_one"] = gnn_restored(None, directory)
        torch.save(res, os.path.join(directory, f"restored{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _resumed_train(mesh, ins, directory, res):
    """The train state that ``world8`` saved after step 1 on (data 4,
    model 2), restored onto (data 2, model 2) by ``restore(mesh=)`` (the
    moments placed as their parameters), takes step 2."""
    data, model, rname, K, accum, gdt, remat = TRAIN_CASES[TRAIN_CKPT_CASE]
    rules, cfg = RULES[rname], train_cfg(K, remat)
    with sharding_ctx(mesh, rules):
        blocks = init_params(cfg, device="cpu", mesh=mesh)
        state, saved = CheckpointManager(os.path.join(
            directory, "train_ckpt")).restore(
                {"p": blocks, "o": adamw_init(blocks)}, mesh=mesh)
        state = tree_map(lambda a: tree_to_torch(a, torch.device("cpu")),
                         state)
        params, opt, m = train_step(cfg, accum, gdt)(
            state["p"], state["o"], train_batch(ins, 1))
        state = gathered_state(mesh, cfg, params, opt, rules)
        res["train"] = {"saved": saved, "metrics": (float(m["loss"]),
                                                    float(m["grad_norm"])),
                        "mu_block": tuple(opt.mu["layers"]["wq"].shape),
                        "state": state if mesh.rank == 0 else None}


def world2(rank: int, directory: str) -> None:
    """The train CLI's run of ``world4`` resumed on mesh (data 1, model 2)
    under the train_4k rules to step CLI_STEPS[1], checkpointing there."""
    _init(rank, 2, os.path.join(directory, "store2"))
    try:
        with sharding_ctx(make_host_mesh(data=1, model=2), TRAIN_RULES):
            cli = train_cli.main(CLI_ARGS + [
                "--steps", str(CLI_STEPS[1]), "--ckpt-every",
                str(CLI_STEPS[1]), "--ckpt-dir", os.path.join(directory,
                                                               "cli")])
        torch.save({"losses": cli["losses"], "start": cli["start"],
                    "wq": tuple(cli["params"]["layers"]["wq"].shape),
                    "mu_wq": tuple(cli["opt"].mu["layers"]["wq"].shape)},
                   os.path.join(directory, f"cli{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------ recommenders
# The recommenders placed over a mesh (ROADMAP A16b 6.3): case -> (config
# module, data, model).  W&D at model 2 and 4 (windows of 256 and 128 of
# its 512 rows a table), the others at (data 4, model 2).
RECSYS_CASES = {"wd42": ("wide_deep", 4, 2), "wd24": ("wide_deep", 2, 4),
                "tt42": ("two_tower_retrieval", 4, 2),
                "sr42": ("sasrec", 4, 2), "br42": ("bert4rec", 4, 2)}
RECSYS_B = 16               # serve and train rows
RECSYS_K = 16               # Two-Tower's top-k over 64 candidates
RECSYS_CKPT_CASE = "wd42"   # its train state saved on 8 ranks


def recsys_module(name):
    from repro_torch import configs
    return configs.get_arch(name)


def recsys_serve(name, cfg, params, t):
    """Every serve cell of config module ``name`` at the smoke size on
    ``params`` (blocks under the active mesh), inputs ``t(key)``; returns
    the whole outputs (gathered from the ranks' rows)."""
    from repro_torch.models.recsys.common import Lanes
    mod = recsys_module(name)
    M, lanes = mod.model, Lanes(RECSYS_B)
    if name == "wide_deep":
        return {"scores": lanes.gather(M.forward(cfg, params, t("ids"),
                                                 t("mask"), t("dense")))}
    if name == "two_tower_retrieval":
        values, idx = M.score_candidates(cfg, params, t("user1"),
                                         t("cand_emb"), k=RECSYS_K)
        return {"user": lanes.gather(M.user_embed(cfg, params, t("users"))),
                "item": lanes.gather(M.item_embed(cfg, params, t("items"))),
                "paired": lanes.gather(mod.paired_score(
                    cfg, params, t("users"), t("items"))),
                "top_v": values, "top_i": idx}
    return {"rank": lanes.gather(M.serve(cfg, params, t("ids"), t("pad"),
                                         t("cand"))),
            "catalog": M.serve(cfg, params, t("ids1"), t("pad1"))}


def recsys_gathered(mesh, axes, shapes, tree, prefix=""):
    """The whole leaves of a tree of this rank's blocks, flat by key."""
    out = {}
    for k, a in _leaves(tree):
        ax, shape = dict(_leaves(axes))[k], dict(_leaves(shapes))[k]
        out[prefix + k] = placement(mesh, ax, shape).gather(a)
    return out


def _recsys_case(meshes, ins, name, directory, res):
    """One ``RECSYS_CASES`` case: the reference's smoke parameters placed
    by ``shard_params`` (= ``init_params(mesh=)``'s blocks of the port's
    own draw, checked), every serve cell under the mesh, and two train
    steps of the config's ``train_cell`` from the blocks and
    ``adamw_init`` of them (each step's loss and grad norm, then the
    gathered state); the checkpoint case saves that state.  The
    single-device port's outputs beside them."""
    from repro_torch.configs.common import opt_state_axes
    from repro_torch.models.recsys import recsys_params_from_jax, shard_params
    mname, data, model = RECSYS_CASES[name]
    mesh, mod = meshes[(data, model)], recsys_module(mname)
    cfg, M = mod.smoke_config(), mod.model
    axes, shapes = M.param_logical_axes(cfg), M.param_shapes(cfg)
    whole = recsys_params_from_jax(_tree(ins, f"rs/{mname}/params"), "cpu")
    pre = f"rs/{mname}"

    def t(k):
        return torch.from_numpy(ins[f"{pre}/{k}"])

    step = mod.train_cell(cfg, batch=RECSYS_B).step
    keys = [k[len(pre) + 4:] for k in ins if k.startswith(pre + "/t0/")]

    def batch(i):
        return {k: t(f"t{i}/{k}") for k in keys}

    with sharding_ctx(mesh):
        params = shard_params(whole, axes, mesh)
        drawn = init_params_of(M, cfg, mesh)
        out = recsys_serve(mname, cfg, params, t)
        opt, metrics = adamw_init(params), []
        for i in range(2):
            params, opt, m = step(params, opt, batch(i))
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        state = recsys_gathered(mesh, axes, shapes, params, "p/")
        state.update(recsys_gathered(mesh, axes, shapes, opt.mu, "mu/"))
        state.update(recsys_gathered(mesh, axes, shapes, opt.nu, "nu/"))
        if name == RECSYS_CKPT_CASE:
            CheckpointManager(os.path.join(directory, "rs_ckpt")).save(
                2, {"p": params, "o": opt},
                logical_axes={"p": axes, "o": opt_state_axes(axes)},
                shapes={"p": shapes, "o": opt_state_axes(shapes)},
                mesh=mesh)
    mine = init_params_of(M, cfg, None)
    same = all(torch.equal(drawn[k], placement(
        mesh, dict(_leaves(axes))[k], a.shape).local(a))
        for k, a in _leaves(mine))
    one = recsys_serve(mname, cfg, whole, t)
    p1, o1, m1 = whole, adamw_init(whole), []
    for i in range(2):
        p1, o1, m = step(p1, o1, batch(i))
        m1.append((float(m["loss"]), float(m["grad_norm"])))
    res[f"rs/{name}"] = {
        "out": out, "one": one, "metrics": metrics, "one_metrics": m1,
        "state": state if mesh.rank == 0 else None,
        "one_state": ({f"p/{k}": a for k, a in _leaves(p1)}
                      | {f"mu/{k}": a for k, a in _leaves(o1.mu)}
                      | {f"nu/{k}": a for k, a in _leaves(o1.nu)})
        if mesh.rank == 0 else None,
        "drawn_equal": same,
        "blocks": {k: tuple(a.shape) for k, a in _leaves(params)}}


def init_params_of(M, cfg, mesh):
    """The port's own draw (seed 1), whole or this rank's blocks, flat."""
    return dict(_leaves(M.init_params(cfg, seed=1, device="cpu",
                                      mesh=mesh)))


def recsys_restored(mesh, directory):
    """``RECSYS_CKPT_CASE``'s train state restored under ``mesh`` (None:
    one device, whole), gathered, flat."""
    from repro_torch.configs.common import opt_state_axes
    mname = RECSYS_CASES[RECSYS_CKPT_CASE][0]
    mod = recsys_module(mname)
    cfg, M = mod.smoke_config(), mod.model
    axes, shapes = M.param_logical_axes(cfg), M.param_shapes(cfg)
    with sharding_ctx(mesh):
        blocks = M.init_params(cfg, device="cpu", mesh=mesh)
        state, step = CheckpointManager(os.path.join(
            directory, "rs_ckpt")).restore({"p": blocks,
                                            "o": adamw_init(blocks)},
                                           mesh=mesh)
        state = tree_map(lambda a: tree_to_torch(a, torch.device("cpu")),
                         state)
        p, o = state["p"], state["o"]
        if mesh is None:
            flat = {f"{t}/{k}": a for t, tree in (("p", p), ("mu", o.mu),
                                                   ("nu", o.nu))
                    for k, a in _leaves(tree)}
        else:
            flat = recsys_gathered(mesh, axes, shapes, p, "p/")
            flat.update(recsys_gathered(mesh, axes, shapes, o.mu, "mu/"))
            flat.update(recsys_gathered(mesh, axes, shapes, o.nu, "nu/"))
        return {"step": step, "opt_step": int(o.step), "state": flat,
                "block": tuple(p["tables"].shape)}


# --------------------------------------------------------------- the GNN
# EquiformerV2 placed over a mesh (ROADMAP A16b 6.3b): case -> (loss,
# data, model, N, E, edge_chunk), at the smoke config.  g42n: the nodes
# over data (8 a rank), the edges over data x model (8 a rank); g24e the
# same at (2, 4) with graph_ids; g42c the chunked path, 12 edges a rank in
# chunks of 8 and 4 (12 chunks of the global E); g42x: N 30 is no multiple
# of data (the nodes whole on every rank), E 60 one of data but not of
# data x model (the edges over data alone).
GNN_CASES = {"g42n": ("node_class_loss", 4, 2, 32, 64, 0),
             "g24e": ("energy_loss", 2, 4, 32, 64, 0),
             "g42c": ("node_class_loss", 4, 2, 32, 96, 8),
             "g42x": ("energy_loss", 4, 2, 30, 60, 0)}
GNN_GRAPHS = 4              # graphs of the energy cases
GNN_COUNT_CASES = ("g42n", "g42c")   # one forward counted, real vs traced
GNN_CKPT_CASE = "g42n"      # its train state saved on 8 ranks
GNN_MUTANT_CASE = "g42n"    # its gradient with node-side sums over model too
GNN_INPUTS = ("node_feat", "positions", "edges", "edge_mask")


def gnn_cfg(chunk):
    from repro_torch.configs import equiformer_v2 as ecfg
    return dataclasses.replace(ecfg.smoke_config(), edge_chunk=chunk)


def gnn_step(cfg, loss_name):
    """The config's train step (lr 3e-4, bf16 gradients, the global norm
    over the blocks) for the case's loss."""
    from repro_torch.configs import equiformer_v2 as ecfg
    shape = "molecule" if loss_name == "energy_loss" else "full_graph_sm"
    return ecfg.train_cell(shape, cfg).step


def gnn_batch(ins, name):
    pre = f"gnn/{name}/"
    return {k[len(pre):]: torch.from_numpy(v) for k, v in ins.items()
            if k.startswith(pre)}


def gnn_forward(cfg, params, b):
    """forward on the batch: graph_out pooled by graph_ids where the batch
    has them, else the mean; the node outputs gathered whole."""
    from repro_torch.models.gnn import equiformer as eq
    ids = b.get("graph_ids")
    out = eq.forward(cfg, params, *(b[k] for k in GNN_INPUTS),
                     graph_ids=ids,
                     n_graphs=GNN_GRAPHS if ids is not None else 1)
    g = eq.Graph(cfg, b["node_feat"].shape[0], b["edges"].shape[0])
    return {"node_out": g.gather(out["node_out"]),
            "l1_feats": g.gather(out["l1_feats"]),
            "graph_out": out["graph_out"]}


def gnn_loss_grads(cfg, loss_name, params, b, mesh=None):
    """(loss, every gradient leaf flat, gathered whole under ``mesh``)."""
    from repro_torch.models.gnn import equiformer as eq
    live = tree_map(lambda p: p.detach().requires_grad_(True), params)
    keys, leaves = zip(*_leaves(live))
    loss = getattr(eq, loss_name)(cfg, live, b)
    flat = dict(zip(keys, torch.autograd.grad(loss, leaves)))
    if mesh is not None:
        axes = dict(_leaves(eq.param_logical_axes(cfg)))
        shapes = dict(_leaves(eq.param_shapes(cfg)))
        flat = {k: placement(mesh, axes[k], shapes[k]).gather(g)
                for k, g in flat.items()}
    return loss.detach(), flat


def gnn_train(cfg, loss_name, params, b, mesh=None):
    """Two train steps on the batch from ``adamw_init``: ((loss, grad
    norm) a step, the state flat (``p/``, ``mu/``, ``nu/``), gathered
    whole under ``mesh``), and the last params and state."""
    from repro_torch.models.gnn import equiformer as eq
    step, opt, metrics = gnn_step(cfg, loss_name), adamw_init(params), []
    for _ in range(2):
        params, opt, m = step(params, opt, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    if mesh is None:
        state = {f"{t}/{k}": a for t, tree in (("p", params), ("mu", opt.mu),
                                                ("nu", opt.nu))
                 for k, a in _leaves(tree)}
    else:
        axes, shapes = eq.param_logical_axes(cfg), eq.param_shapes(cfg)
        state = {}
        for t, tree in (("p", params), ("mu", opt.mu), ("nu", opt.nu)):
            state.update(recsys_gathered(mesh, axes, shapes, tree, t + "/"))
    return metrics, state, params, opt


def _gnn_case(meshes, ins, name, directory, res):
    """One ``GNN_CASES`` case: the reference's smoke parameters placed by
    ``shard_params`` under ``DEFAULT_RULES``, the forward (gathered), the
    loss and every gathered gradient leaf, and two train steps under the
    mesh; the port's own draw by ``init_params(mesh=)`` against one
    device's blocks; one forward's collectives on the real mesh and on a
    ``TracedMesh`` (``GNN_COUNT_CASES``); the gradient with the node-side
    weights' sums taken over ``model`` too (``GNN_MUTANT_CASE``); the
    checkpoint case saves its state.  Rank 0 adds the single-device
    port's results."""
    from repro_torch.configs.common import opt_state_axes
    from repro_torch.models.gnn import equiformer as eq
    from repro_torch.models.recsys import shard_params as place_tree
    loss_name, data, model, N, E, chunk = GNN_CASES[name]
    mesh, cfg = meshes[(data, model)], gnn_cfg(chunk)
    axes, shapes = eq.param_logical_axes(cfg), eq.param_shapes(cfg)
    whole = eq.equiformer_params_from_jax(cfg, _tree(ins, "gnn/params"),
                                          device="cpu")
    b = gnn_batch(ins, name)
    r = {}
    with sharding_ctx(mesh, DEFAULT_RULES):
        params = place_tree(whole, axes, mesh)
        graph = eq.Graph(cfg, N, E)
        split = graph.split
        r["split"] = (split.edge_axes, split.node_axes, split.edge_rows,
                      split.node_rows, graph.ffn_axes, graph.ordered)
        r["out"] = gnn_forward(cfg, params, b)
        r["loss"], r["grads"] = gnn_loss_grads(cfg, loss_name, params, b,
                                               mesh)
        r["metrics"], state, p2, o2 = gnn_train(cfg, loss_name, params, b,
                                                mesh)
        r["state"] = state if mesh.rank == 0 else None
        drawn = dict(_leaves(eq.init_params(cfg, seed=1, device="cpu",
                                            mesh=mesh)))
        r["blocks"] = {k: tuple(a.shape) for k, a in drawn.items()}
        if name in GNN_COUNT_CASES:
            traced = TracedMesh(mesh.shape, mesh.rank)
            for tag, m, on in (("real", mesh, lambda x: x),
                               ("traced", traced, _meta)):
                with sharding_ctx(m, DEFAULT_RULES):
                    m.reset_counts()
                    eq.forward(cfg, on(params), *(on(b[k])
                                                  for k in GNN_INPUTS))
                    r[f"count/{tag}"] = m.collective_records()
        if name == GNN_MUTANT_CASE:
            sound = eq.Graph.node_weight

            def over_model(self, w):     # a replicated weight summed twice
                return sum_grad(w, self.split.mesh,
                                self.split.node_axes + ("model",))
            eq.Graph.node_weight = over_model
            try:
                r["mutant_grads"] = gnn_loss_grads(cfg, loss_name, params, b,
                                                   mesh)[1]
            finally:
                eq.Graph.node_weight = sound
        if name == GNN_CKPT_CASE:
            CheckpointManager(os.path.join(directory, "gnn_ckpt")).save(
                2, {"p": p2, "o": o2},
                logical_axes={"p": axes, "o": opt_state_axes(axes)},
                shapes={"p": shapes, "o": opt_state_axes(shapes)},
                mesh=mesh)
    mine = dict(_leaves(eq.init_params(cfg, seed=1, device="cpu")))
    r["drawn_equal"] = sorted(mine) == sorted(drawn) and all(
        torch.equal(drawn[k], placement(mesh, dict(_leaves(axes))[k],
                                        a.shape).local(a))
        for k, a in mine.items())
    if mesh.rank == 0:
        r["one"] = {"out": gnn_forward(cfg, whole, b)}
        r["one"]["loss"], r["one"]["grads"] = gnn_loss_grads(
            cfg, loss_name, whole, b)
        r["one"]["metrics"], r["one"]["state"], _, _ = gnn_train(
            cfg, loss_name, whole, b)
    res[f"gnn/{name}"] = r


def gnn_restored(mesh, directory):
    """``GNN_CKPT_CASE``'s train state restored under ``mesh`` (None: one
    device, whole), gathered, flat."""
    from repro_torch.models.gnn import equiformer as eq
    cfg = gnn_cfg(GNN_CASES[GNN_CKPT_CASE][5])
    axes, shapes = eq.param_logical_axes(cfg), eq.param_shapes(cfg)
    with sharding_ctx(mesh):
        blocks = eq.init_params(cfg, device="cpu", mesh=mesh)
        state, step = CheckpointManager(os.path.join(
            directory, "gnn_ckpt")).restore({"p": blocks,
                                             "o": adamw_init(blocks)},
                                            mesh=mesh)
        state = tree_map(lambda a: tree_to_torch(a, torch.device("cpu")),
                         state)
        p, o = state["p"], state["o"]
        flat = {}
        for t, tree in (("p", p), ("mu", o.mu), ("nu", o.nu)):
            if mesh is None:
                flat.update({f"{t}/{k}": a for k, a in _leaves(tree)})
            else:
                flat.update(recsys_gathered(mesh, axes, shapes, tree,
                                            t + "/"))
        return {"step": step, "opt_step": int(o.step), "state": flat,
                "w0": tuple(p["layers"]["w0"].shape)}
