"""phi3-medium-14b [arXiv:2404.14219]: 40L d_model=5120 40H (GQA kv=10)
d_ff=17920 vocab=100352 — RoPE, SwiGLU, untied lm_head (the numbers of
``repro.configs.phi3_medium_14b``)."""
from repro_torch.configs import lm_common
from repro_torch.models.transformer import TransformerConfig

ARCH = "phi3-medium-14b"
SHAPES = lm_common.SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH, n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10,
        d_ff=17920, vocab_size=100352, head_dim=128, rope_theta=10000.0,
        act="silu", tie_embeddings=False)


def smoke_config() -> TransformerConfig:
    return lm_common.smoke_config(full_config())


def build_cell(shape: str, mesh=None):
    """The dry-run cell (``lm_common.build_cell``; with ``mesh``, a rank's
    blocks)."""
    return lm_common.build_cell(ARCH, full_config(), shape, mesh)
