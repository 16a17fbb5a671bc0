"""qwen2-1.5b [arXiv:2407.10671; hf:Qwen/Qwen2-1.5B]: 28L d_model=1536 12H
(GQA kv=2) d_ff=8960 vocab=151936 — QKV bias, tied embeddings (the numbers
of ``repro.configs.qwen2_1_5b``)."""
from repro_torch.configs import lm_common
from repro_torch.models.transformer import TransformerConfig

ARCH = "qwen2-1.5b"
SHAPES = lm_common.SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH, n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2,
        d_ff=8960, vocab_size=151936, head_dim=128, qkv_bias=True,
        rope_theta=1_000_000.0, act="silu", tie_embeddings=True)


def smoke_config() -> TransformerConfig:
    return lm_common.smoke_config(full_config())


def build_cell(shape: str, mesh=None):
    """The dry-run cell (``lm_common.build_cell``; with ``mesh``, a rank's
    blocks)."""
    return lm_common.build_cell(ARCH, full_config(), shape, mesh)
