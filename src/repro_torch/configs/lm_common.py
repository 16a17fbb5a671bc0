"""Shared cell builders of the LM archs, dense and MoE (the counterpart of
``repro.configs.lm_common``).

Shapes (assignment):
  train_4k     seq 4096,   global_batch 256   → train_step
  prefill_32k  seq 32768,  global_batch 32    → prefill (KV-cache fill)
  decode_32k   seq 32768,  global_batch 128   → serve_step (lookahead tree,
                                                1+64 slots, KV cache 32k)
  long_500k    seq 524288, global_batch 1     → serve_step

Decode cells trace the *lookahead* fused serve step; T = 65 slots = 1 root
+ decoding_length 64.  ``build_cell`` gives each as a ``Cell`` over meta
tensors for ``launch.dryrun``; ``smoke_config`` is the reduced config of
the CPU tests, ``train_4k_config``/``train_4k_step`` the train_4k cell's
config and step that ``chip_smoke.py`` runs at a cut batch.

The decode cells take the ``flash_decode`` tree backend, as the
reference's: it shards the KV sequence over a mesh's ranks
(``repro_torch.distributed.flash_decode``) and is the ``dense`` backend
without one, so the dry-run's one-card traces count the dense program.
Each cell carries the reference cell's rules (``cell_rules``); the
reference's ``REPRO_SERVE_FSDP`` switch is a sharding rule and has no
counterpart.  MoE archs keep ``moe_impl="auto"``, which one device serves
as ``moe_ref`` (every expert computes every token) and a mesh with a
``model`` axis as ``moe_ep``; the one-card counts show the former, the
mesh legs the latter.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch

from repro_torch.configs.common import Cell, abstract, opt_state_axes
from repro_torch.distributed.sharding import (DEFAULT_RULES, ShardingRules,
                                              sharding_ctx)
from repro_torch.models import transformer as tx
from repro_torch.models.params import init_params
from repro_torch.models.transformer import TransformerConfig
from repro_torch.serving.sampler import choose_tokens
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import make_train_step

SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
LA_SLOTS = 65              # 1 + decoding_length(64); ≤ CDL (paper Fig. 1)
TRAIN_4K = {"batch": 256, "seq": 4096}      # the reference's global batch
CELL_BATCH = {"train_4k": TRAIN_4K["batch"], "prefill_32k": 32,
              "decode_32k": 128, "long_500k": 1}


def smoke_config(base: TransformerConfig) -> TransformerConfig:
    """2 layers, d_model 64, 4 heads of 16, d_ff 128 (0 with MoE), vocab
    512, f32; keeps the GQA ratio, the QKV bias, the activation, the
    tying and the MoE topology: 8 experts of d_ff 32, top-k up to 2, at
    most one shared expert, the all-experts ``moe_ref`` dispatch."""
    return dataclasses.replace(
        base, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, base.n_kv_heads * 4 // base.n_heads),
        d_ff=128 if not base.moe else 0, vocab_size=512, head_dim=16,
        max_seq_len=128, q_chunk=0, remat=False, dtype="float32",
        param_dtype="float32",
        n_experts=8 if base.moe else 0, top_k=min(base.top_k, 2),
        moe_d_ff=32 if base.moe else 0,
        n_shared_experts=min(base.n_shared_experts, 1), moe_impl="ref")


def train_4k_config(base: TransformerConfig) -> TransformerConfig:
    """The train_4k cell's config: bf16 activations over f32 master
    weights, remat, query chunks of 512, S 4096, dense attention."""
    return dataclasses.replace(base, dtype="bfloat16", remat=True,
                               q_chunk=512, max_seq_len=TRAIN_4K["seq"],
                               prefill_backend="dense", moe_impl="auto")


def train_4k_step(cfg: TransformerConfig, accum_steps: int = 1):
    """The train_4k cell's step, ``step(params, opt_state, {"tokens",
    "labels"})``: lr 3e-4, bf16 gradients (the reference's memory build
    runs 4 microbatches, its cost build 1), the parameters' axes and
    shapes given for the global norm under a mesh."""
    loss = lambda p, b: tx.lm_loss(cfg, p, b["tokens"], b["labels"])  # noqa: E731
    return make_train_step(loss, lr=3e-4, grad_dtype="bfloat16",
                           accum_steps=accum_steps,
                           axes=tx.param_logical_axes(cfg),
                           shapes=tx.param_shapes(cfg))


def _serve_fn(cfg: TransformerConfig):
    # The serving hot path is the FUSED step (one dispatch per decode step):
    # forward + token choice + device accept walk + KV commit, returning
    # only the packed (B, 1+2T) accept array, so the cell's trace matches
    # what serving actually runs.
    def serve_step(params, cache, cache_lens, tokens, pos, mask,
                   parent, n_live):
        return tx.fused_step(
            cfg, params, cache, cache_lens, tokens, pos, mask, parent,
            n_live, lambda logits, _, p, lay: choose_tokens(
                logits, p + 1, sharding=lay.logits))
    return serve_step


def _prefill_fn(cfg: TransformerConfig):
    def prefill_step(params, tokens, lens, cache):
        return tx.prefill(cfg, params, tokens, lens, cache)
    return prefill_step


def _attn_scan_correction(cfg, B, S, kind) -> Dict[str, float]:
    """The reference's analytic correction for the q-chunked attention's
    ``lax.scan``, whose body XLA's cost analysis counts once: TOTAL flops
    and bytes to add.  Kept in the meta for parity; the port's trace runs
    every chunk of its Python loop, so ``launch.roofline`` adds neither."""
    if not cfg.q_chunk or S <= cfg.q_chunk:
        return {"flops_correction": 0.0, "bytes_correction": 0.0}
    nc = S // cfg.q_chunk
    H, dh, K = cfg.n_heads, cfg.dh, cfg.n_kv_heads
    attn_flops = 4.0 * B * H * S * S * dh          # scores + weighted sum
    score_bytes = 2.0 * B * H * S * S * 2 * 2      # write+read scores
    kv_bytes = 2.0 * B * S * K * dh * 2 * nc       # K,V re-read per chunk
    mult = 4.0 if kind == "train" else 1.0         # remat fwd+recompute+bwd
    frac = (nc - 1) / nc
    return {"flops_correction": cfg.n_layers * mult * frac * attn_flops,
            "bytes_correction": cfg.n_layers * mult * frac
            * (score_bytes + kv_bytes)}


def _perf_overrides(cfg: TransformerConfig) -> TransformerConfig:
    """REPRO_PERF_OVERRIDES="k=v,k=v" patches the dry-run config (e.g.
    attn_score_f32=0, q_chunk=2048), as in the reference."""
    ov = os.environ.get("REPRO_PERF_OVERRIDES", "")
    if not ov:
        return cfg
    kw = {}
    for item in ov.split(","):
        k, v = item.split("=")
        cur = getattr(cfg, k)
        if isinstance(cur, bool):
            kw[k] = v not in ("0", "false", "False")
        elif isinstance(cur, int):
            kw[k] = int(v)
        elif isinstance(cur, float):
            kw[k] = float(v)
        else:
            kw[k] = v
    return dataclasses.replace(cfg, **kw)


def decode_args(cfg: TransformerConfig, B: int, T: int, device="meta"):
    """The fused step's arguments but the parameters, zeroed on ``device``
    (meta: shapes only): the (L, B, S, K, dh) cache (the activation dtype,
    bf16 in the cells) of
    ``cfg.max_seq_len`` rows, cache_lens, tokens, positions, the (B, T, T)
    tree mask, parents and n_live."""
    def z(shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)
    cache = tx.init_cache(cfg, B, device=torch.device(device))
    return (cache, z((B,)), z((B, T)), z((B, T)), z((B, T, T), torch.bool),
            z((B, T)), z((B,)))


def cell_rules(shape: str) -> ShardingRules:
    """The reference cell's sharding rules: train_4k's residual split
    along the sequence over ``model`` (Megatron's sequence parallelism),
    the decode cells' weights without FSDP (``fsdp=()``: at TP 16 the
    serve weights fit, and FSDP would only add gathers), prefill_32k's
    ``DEFAULT_RULES``."""
    if shape == "train_4k":
        return DEFAULT_RULES.override(residual_seq=("model",))
    if shape in ("decode_32k", "long_500k"):
        return DEFAULT_RULES.override(fsdp=())
    return DEFAULT_RULES


def cell_config(base: TransformerConfig, shape: str) -> TransformerConfig:
    """The cell's config on the reference's backends (``dense``;
    ``flash_decode`` for the decode cells), before any
    ``REPRO_PERF_OVERRIDES``."""
    if shape == "train_4k":
        return train_4k_config(base)
    if shape == "prefill_32k":
        return dataclasses.replace(base, dtype="bfloat16",
                                   param_dtype="bfloat16", q_chunk=1024,
                                   max_seq_len=32768, moe_impl="auto",
                                   prefill_backend="dense")
    if shape in ("decode_32k", "long_500k"):
        return dataclasses.replace(
            base, dtype="bfloat16", param_dtype="bfloat16",
            max_seq_len=524288 if shape == "long_500k" else 32768,
            prefill_backend="dense", decode_backend="flash_decode",
            moe_impl="auto")
    raise KeyError(shape)


def build_cell(arch: str, base: TransformerConfig, shape: str,
               mesh=None) -> Cell:
    """The (arch, shape) cell over meta tensors, on the reference's
    backends and rules, as in the reference's dry-run.  train_4k counts
    its cost on the whole batch at once and its memory on the 4
    microbatches that run (``memory_fn``; the reference's cost and
    ``fast`` builds).  With ``mesh`` (a ``TracedMesh`` rank of the
    production mesh) the arguments are that rank's blocks, made by the
    port's own calls under ``sharding_ctx(mesh, cell.rules)``: the
    parameters by ``init_params(mesh=)``, the AdamW state from them, the
    cache by ``init_cache`` (its ``cache_sharding`` block), the inputs
    whole; the cell's function must then run in that context."""
    cfg = _perf_overrides(cell_config(base, shape))
    rules = cell_rules(shape)
    B = CELL_BATCH[shape]
    p_axes = tx.param_logical_axes(cfg)

    def arguments(m):
        with sharding_ctx(m, rules):
            params = init_params(cfg, device="meta", mesh=m)
            if shape == "train_4k":
                S = TRAIN_4K["seq"]
                return (params, adamw_init(params),
                        {"tokens": abstract((B, S), "int32"),
                         "labels": abstract((B, S), "int32")})
            if shape == "prefill_32k":
                # cache=None: the stacked per-layer KV IS the returned cache
                return (params,
                        {"tokens": abstract((B, cfg.max_seq_len), "int32")},
                        abstract((B,), "int32"))
            return (params,) + decode_args(cfg, B, LA_SLOTS)

    args = arguments(None)
    if shape == "train_4k":
        S = TRAIN_4K["seq"]
        meta = _meta(cfg, tokens_per_step=B * S, kind="train", seq=S,
                     batch=B)
        meta.update(_attn_scan_correction(cfg, B, S, "train"))
        axes = (p_axes, opt_state_axes(p_axes),
                {"tokens": ("batch", None), "labels": ("batch", None)})
        cell = Cell(arch, shape, "train", train_4k_step(cfg, accum_steps=1),
                    args, meta, memory_fn=train_4k_step(cfg, accum_steps=4),
                    axes=axes, rules=rules)
    elif shape == "prefill_32k":
        S = cfg.max_seq_len
        fn = lambda p, b, l: _prefill_fn(cfg)(p, b["tokens"], l, None)  # noqa: E731
        meta = _meta(cfg, tokens_per_step=B * S, kind="prefill", seq=S,
                     batch=B)
        meta.update(_attn_scan_correction(cfg, B, S, "prefill"))
        cell = Cell(arch, shape, "prefill", fn, args, meta,
                    axes=(p_axes, {"tokens": ("batch", None)}, ("batch",)),
                    rules=rules)
    else:
        meta = _meta(cfg, tokens_per_step=B * LA_SLOTS, kind="decode",
                     seq=cfg.max_seq_len, batch=B)
        cache_axes = tx.cache_logical_axes(cfg)
        if mesh is not None:
            with sharding_ctx(mesh, rules):
                spec = tx.cache_sharding(cfg, B).spec
            cache_axes = {"k": spec, "v": spec}
        axes = (p_axes, cache_axes, ("batch",), ("batch", None),
                ("batch", None), ("batch", None, None), ("batch", None),
                ("batch",))                      # draft parents, n_live
        cell = Cell(arch, shape, "decode", _serve_fn(cfg), args, meta,
                    axes=axes, rules=rules)
    if mesh is not None:
        cell.args = arguments(mesh)
    return cell


def _meta(cfg: TransformerConfig, tokens_per_step: int, kind: str,
          seq: int, batch: int) -> Dict:
    """The reference's cell meta, number for number."""
    n = cfg.n_params()
    na = cfg.n_active_params()
    L, d, V = cfg.n_layers, cfg.d_model, cfg.vocab_size
    K, dh = cfg.n_kv_heads, cfg.dh
    T = tokens_per_step // batch
    # analytic HBM floor: what the step must stream at least once
    if kind == "decode":
        # the fused step's only output besides the cache (updated in place)
        # is the packed (B, 1+2T) i32 accept array
        step_out = batch * (1 + 2 * T) * 4
        floor = (n * 2                                  # weight stream (bf16)
                 + L * 2 * K * dh * seq * batch * 2     # KV cache read
                 + step_out                             # packed accept out
                 + L * batch * T * d * 2 * 10)          # residual stream
    elif kind == "prefill":
        floor = (n * 2
                 + L * 2 * K * dh * batch * seq * 2 * 2  # KV write+read
                 + L * batch * seq * d * 2 * 12
                 + batch * V * 4)
    else:  # train
        floor = (na * 16                                 # p/g/m/v f32 streams
                 + L * batch * seq * d * 2 * 30          # fwd+bwd activations
                 + batch * seq * V * 4 * 3)              # logits + bwd
    return {
        "bytes_floor": float(floor),
        "n_params": n,
        "n_active_params": na,
        # 6·N_active·D tokens (train fwd+bwd); decode/prefill 2·N_active·D
        "model_flops": (6 if kind == "train" else 2) * na * tokens_per_step,
        "tokens_per_step": tokens_per_step,
        "seq": seq,
        "batch": batch,
        "weight_bytes": (n if kind != "train" else na) * (4 if kind == "train" else 2),
        "kv_bytes_per_step": (cfg.n_layers * 2 * cfg.n_kv_heads * cfg.dh
                              * seq * batch * 2 if kind == "decode" else 0),
        # bytes the step hands back: decode the packed accept array,
        # prefill the chosen roots
        "step_output_bytes": (batch * (1 + 2 * T) * 4 if kind == "decode"
                              else batch * 4 if kind == "prefill" else 0),
    }


__all__ = ["SHAPES", "LA_SLOTS", "TRAIN_4K", "CELL_BATCH", "smoke_config",
           "train_4k_config", "train_4k_step", "cell_rules", "cell_config",
           "build_cell", "decode_args"]
