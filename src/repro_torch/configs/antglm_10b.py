"""AntGLM-10B, the paper's own deployment model (GLM structure [arXiv:
2103.10360]; paper Table 9): 48L d_model=4096 32H (MHA) d_ff=16384
vocab=115328 — modelled as a decoder-only LM with GeGLU and tied
embeddings (the numbers of ``repro.configs.antglm_10b``)."""
from repro_torch.configs import lm_common
from repro_torch.models.transformer import TransformerConfig

ARCH = "antglm-10b"


def full_config() -> TransformerConfig:
    return TransformerConfig(
        name=ARCH, n_layers=48, d_model=4096, n_heads=32, n_kv_heads=32,
        d_ff=16384, vocab_size=115328, head_dim=128, rope_theta=10000.0,
        act="gelu", tie_embeddings=True)


def smoke_config() -> TransformerConfig:
    return lm_common.smoke_config(full_config())
