"""qwen2-1.5b [arXiv:2407.10671; hf:Qwen/Qwen2-1.5B]: 28L d_model=1536 12H
(GQA kv=2) d_ff=8960 vocab=151936 — QKV bias, tied embeddings (the numbers
of ``repro.configs.qwen2_1_5b``)."""
import dataclasses

from repro_torch.models.transformer import TransformerConfig

ARCH = "qwen2-1.5b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH, n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, head_dim=128, qkv_bias=True,
        rope_theta=1_000_000.0, act="silu", tie_embeddings=True)


def smoke_config() -> TransformerConfig:
    """Reduced same-family config (the numbers of the reference's
    ``lm_common.smoke_config``): keeps the GQA ratio and the QKV bias."""
    base = full_config()
    return dataclasses.replace(
        base, n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=max(1, base.n_kv_heads * 4 // base.n_heads), d_ff=128,
        vocab_size=512, head_dim=16, max_seq_len=128, q_chunk=0,
        remat=False, dtype="float32", param_dtype="float32")
