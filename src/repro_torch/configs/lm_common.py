"""What the LM archs share, dense and MoE: the reduced same-family
config of the CPU tests (the numbers of
``repro.configs.lm_common.smoke_config``).  The reference's cell
builders lower XLA programs for the dry-run (ROADMAP A19) and are not
here."""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import TransformerConfig


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


__all__ = ["smoke_config"]
