"""What the LM archs share: the reduced same-family config of the CPU
tests (the numbers of ``repro.configs.lm_common.smoke_config``).  The
reference's cell builders lower XLA programs for the dry-run (ROADMAP
A19) and are not here."""
from __future__ import annotations

import dataclasses

from repro_torch.models.transformer import TransformerConfig


def smoke_config(base: TransformerConfig) -> TransformerConfig:
    """2 layers, d_model 64, 4 heads of 16, d_ff 128, vocab 512, f32;
    keeps the GQA ratio, the QKV bias, the activation and the tying."""
    return dataclasses.replace(
        base, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, base.n_kv_heads * 4 // base.n_heads), d_ff=128,
        vocab_size=512, head_dim=16, max_seq_len=128, q_chunk=0,
        remat=False, dtype="float32", param_dtype="float32")


__all__ = ["smoke_config"]
