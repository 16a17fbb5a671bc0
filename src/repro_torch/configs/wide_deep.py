"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed_dim=32,
MLP 1024-512-256, concat interaction.  Tables: 1M rows/field (the numbers
of ``repro.configs.wide_deep``)."""
from repro_torch.configs import recsys_common as rc
from repro_torch.configs.recsys_common import Input, ServeCell
from repro_torch.models.recsys import wide_deep as model

ARCH = "wide-deep"
SHAPES = rc.SHAPES


def full_config() -> model.WideDeepConfig:
    return model.WideDeepConfig(n_sparse=40, embed_dim=32,
                                rows_per_table=1_000_000, multi_hot=4,
                                mlp_dims=(1024, 512, 256), n_dense=13)


def smoke_config() -> model.WideDeepConfig:
    return model.WideDeepConfig(n_sparse=6, embed_dim=8, rows_per_table=512,
                                multi_hot=3, mlp_dims=(32, 16), n_dense=5)


def serve_cell(shape: str, cfg: model.WideDeepConfig = None) -> ServeCell:
    """``forward`` over B contexts (retrieval_cand: 1M candidate contexts
    scored for one user)."""
    rc.check_serve_shape(shape)
    cfg = cfg or full_config()
    B = 1_000_000 if shape == "retrieval_cand" else rc.BATCHES[shape]
    F, L = cfg.n_sparse, cfg.multi_hot
    return ServeCell(model.forward, (
        Input("sparse_ids", (B, F, L), "int32"),
        Input("sparse_mask", (B, F, L), "bool"),
        Input("dense", (B, cfg.n_dense), "float32")))
