"""phi3-mini-3.8b [arXiv:2404.14219]: 32L d_model=3072 32H (MHA, kv=32)
head_dim=96 d_ff=8192 vocab=32064 — RoPE, SwiGLU, untied lm_head (the
numbers of ``repro.configs.phi3_mini_3_8b``)."""
from repro_torch.configs import lm_common
from repro_torch.models.transformer import TransformerConfig

ARCH = "phi3-mini-3.8b"
SHAPES = lm_common.SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH, n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab_size=32064, head_dim=96, rope_theta=10000.0,
        act="silu", tie_embeddings=False)


def smoke_config() -> TransformerConfig:
    return lm_common.smoke_config(full_config())


def build_cell(shape: str, mesh=None):
    """The dry-run cell (``lm_common.build_cell``; with ``mesh``, a rank's
    blocks)."""
    return lm_common.build_cell(ARCH, full_config(), shape, mesh)
