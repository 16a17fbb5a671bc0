"""moonshot-v1-16b-a3b [hf:moonshotai/Moonlight-16B-A3B]: 48L d_model=2048
16H (kv=16) per-expert d_ff=1408 vocab=163840, MoE 64e top-6 (+2 shared
experts per the HF config), untied lm_head (the numbers of
``repro.configs.moonshot_v1_16b_a3b``)."""
from repro_torch.configs import lm_common
from repro_torch.models.transformer import TransformerConfig

ARCH = "moonshot-v1-16b-a3b"
SHAPES = lm_common.SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH, n_layers=48, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=0, vocab_size=163840, head_dim=128, rope_theta=50000.0,
        act="silu", tie_embeddings=False,
        moe=True, n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
        capacity_factor=1.25)


def smoke_config() -> TransformerConfig:
    return lm_common.smoke_config(full_config())


def build_cell(shape: str, mesh=None):
    """The dry-run cell (``lm_common.build_cell``; with ``mesh``, a rank's
    blocks)."""
    return lm_common.build_cell(ARCH, full_config(), shape, mesh)
