"""Rank bodies of ``tests/test_torch_distributed.py``: spawned gloo ranks
on the CPU that run the port's sharded paths (flash decode, the fused
step's commit, prefill, ``moe_ep`` and its gradient, ``_sharded_argmax``,
the expert blocks of ``init_params``/``shard_params``, and a checkpoint
saved under one mesh and restored under another), check what they can
against the port's single-device paths, and leave their outputs in
``<dir>/rank<r>.pt`` for the test to hold against the JAX package's
sharded functions.  Imports torch and the port only, so a spawned rank
does not import JAX."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import lm_common
from repro_torch.distributed.flash_decode import cache_partition_spec
from repro_torch.distributed.sharding import NamedSharding, P, sharding_ctx
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import moe
from repro_torch.models import transformer as tx
from repro_torch.models.params import (init_params, params_from_jax,
                                       shard_params, tree_to_torch)
from repro_torch.serving.sampler import _sharded_argmax
from repro_torch.training.checkpoint import CheckpointManager

ATOL = 3e-5           # flash decode against dense, as the reference's test
MOE_ATOL = 1e-4
COMMIT_ARGS = ("lens", "toks", "pos", "mask", "parent", "n_live")


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


def _init(rank: int, world: int, store: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)


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
    torch.testing.assert_close(l_flash, l_dense, atol=ATOL, rtol=0)
    for n in ("k", "v"):
        torch.testing.assert_close(block[n], sh.local(dense[n]), atol=ATOL,
                                   rtol=0)
    res[f"{case}/spec"] = tuple(spec)
    res[f"{case}/logits"] = l_flash
    res[f"{case}/k"] = sh.gather(block["k"])
    res[f"{case}/v"] = sh.gather(block["v"])


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
    """prefill(cache=None) under the mesh keeps this rank's block."""
    cfg = flash_cfg(1, "flash_decode")
    params = params_from_jax(cfg, _tree(ins, "b/params"), device="cpu")
    toks = torch.from_numpy(ins["prefill/toks"])
    lens = torch.from_numpy(ins["prefill/lens"])
    whole, l_whole = tx.prefill(cfg, params, toks, lens)
    with sharding_ctx(mesh):
        block, l_block = tx.prefill(cfg, params, toks, lens)
        sh = tx.cache_sharding(cfg, 2)
    assert torch.equal(l_block, l_whole)
    for n in ("k", "v"):
        assert torch.equal(block[n], sh.local(whole[n])), n
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
    logits = torch.from_numpy(ins["argmax/logits"])
    with sharding_ctx(mesh):
        got = _sharded_argmax(logits)
    assert torch.equal(got, logits.argmax(-1).int()), (got, logits.argmax(-1))
    res["argmax"] = got


def _params_case(mesh, res):
    cfg = moe_cfg()
    whole = init_params(cfg, seed=0, device="cpu")
    mine = init_params(cfg, seed=0, device="cpu", mesh=mesh)
    cut = shard_params(cfg, whole, mesh)
    m = mesh.axis_index("model")
    El = cfg.n_experts // mesh.shape["model"]
    for name, a in whole["layers"].items():
        want = a[:, m * El:(m + 1) * El] if name.startswith("we_") else a
        assert torch.equal(mine["layers"][name], want), name
        assert torch.equal(cut["layers"][name], want), name
    assert torch.equal(mine["embed"], whole["embed"])
    res["params/we_gate_shape"] = tuple(mine["layers"]["we_gate"].shape)


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
        # a leaf the port keeps whole on every rank, and the smoke MoE's
        # parameters with each rank's expert blocks
        x = torch.arange(64.0).reshape(8, 8)
        cfg = ckpt_cfg()
        CheckpointManager(os.path.join(directory, "ckpt")).save(
            1, {"w": x, "p": init_params(cfg, seed=3, device="cpu",
                                         mesh=mesh)},
            logical_axes={"w": ("batch", "tensor"),
                          "p": tx.param_logical_axes(cfg)}, mesh=mesh)
        torch.save(res, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def world4(rank: int, directory: str) -> None:
    """The checkpoint of ``world8`` restored onto (data 2, model 2): the
    parameters equal ``shard_params`` of the single-device draw bit for
    bit, and the fused step's forward runs on them through ``moe_ep``
    (the experts split over ``model``)."""
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
            got = forward(params)               # moe_ep
        torch.testing.assert_close(got, ref, atol=MOE_ATOL, rtol=0)
        torch.save({"w": out["w"], "step": saved, "coords": mesh.coords(),
                    "we_gate": tuple(params["layers"]["we_gate"].shape),
                    "logits": got},
                   os.path.join(directory, f"restored{rank}.pt"))
    finally:
        dist.destroy_process_group()
