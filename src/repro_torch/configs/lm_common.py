"""What the LM archs share, dense and MoE: the reduced same-family
config of the CPU tests (the numbers of
``repro.configs.lm_common.smoke_config``) and the train_4k cell's config
and step (the reference's ``build_cell(..., "train_4k")``).  The
reference's other cell builders lower XLA programs for the dry-run
(ROADMAP A19) and are not here."""
from __future__ import annotations

import dataclasses

from repro_torch.models import transformer as tx
from repro_torch.models.transformer import TransformerConfig
from repro_torch.training.train_step import make_train_step

TRAIN_4K = {"batch": 256, "seq": 4096}      # the reference's global batch


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
    runs 4 microbatches, its cost build 1)."""
    loss = lambda p, b: tx.lm_loss(cfg, p, b["tokens"], b["labels"])  # noqa: E731
    return make_train_step(loss, lr=3e-4, grad_dtype="bfloat16",
                           accum_steps=accum_steps)


__all__ = ["smoke_config", "train_4k_config", "train_4k_step", "TRAIN_4K"]
