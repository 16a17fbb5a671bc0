"""qwen3-moe-30b-a3b [hf:Qwen/Qwen3-30B-A3B]: 48L d_model=2048 32H (GQA kv=4)
per-expert d_ff=768 vocab=151936, MoE 128 experts top-8, untied lm_head
(the numbers of ``repro.configs.qwen3_moe_30b_a3b``)."""
from repro_torch.configs import lm_common
from repro_torch.models.transformer import TransformerConfig

ARCH = "qwen3-moe-30b-a3b"
SHAPES = lm_common.SHAPES


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH, n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=0, vocab_size=151936, head_dim=128, rope_theta=1_000_000.0,
        act="silu", tie_embeddings=False,
        moe=True, n_experts=128, top_k=8, moe_d_ff=768, n_shared_experts=0,
        capacity_factor=1.25)


def smoke_config() -> TransformerConfig:
    return lm_common.smoke_config(full_config())


def build_cell(shape: str, mesh=None):
    """The dry-run cell (``lm_common.build_cell``; with ``mesh``, a rank's
    blocks)."""
    return lm_common.build_cell(ARCH, full_config(), shape, mesh)
