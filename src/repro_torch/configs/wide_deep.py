"""wide-deep [arXiv:1606.07792]: 40 sparse fields, embed_dim=32,
MLP 1024-512-256, concat interaction.  Tables: 1M rows/field (the numbers
of ``repro.configs.wide_deep``)."""
import sys

from repro_torch.configs import recsys_common as rc
from repro_torch.configs.common import Cell
from repro_torch.configs.recsys_common import (BAG, ROW, Input,
                                              ServeCell, TrainCell)
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
        Input("sparse_ids", (B, F, L), "int32", BAG),
        Input("sparse_mask", (B, F, L), "bool", BAG),
        Input("dense", (B, cfg.n_dense), "float32", ROW)))


def train_cell(cfg: model.WideDeepConfig = None,
               batch: int = rc.BATCHES["train_batch"]) -> TrainCell:
    """``loss`` (BCE on the click labels) over a batch of contexts; the bags
    run in B5 on the card, whose ``autograd.Function`` gives the tables
    their gradient."""
    cfg = cfg or full_config()
    F, L = cfg.n_sparse, cfg.multi_hot
    return rc.train_cell(cfg, model, (
        Input("sparse_ids", (batch, F, L), "int32", BAG),
        Input("sparse_mask", (batch, F, L), "bool", BAG),
        Input("dense", (batch, cfg.n_dense), "float32", ROW),
        Input("labels", (batch,), "float32", ("batch",))))


def cell_meta(cfg: model.WideDeepConfig, shape: str) -> dict:
    """The reference's cell meta."""
    B = rc.BATCHES[shape]
    if shape == "retrieval_cand":
        B = 1_000_000       # scoring 1M candidate contexts for one user
    mult = 3 if shape == "train_batch" else 1
    return {"n_params": cfg.n_params(), "n_active_params": cfg.n_params(),
            "model_flops": _flops(cfg, B, train=(shape == "train_batch")),
            "tokens_per_step": B, "batch": B,
            "weight_bytes": cfg.n_params() * 4,
            "bytes_floor": float(
                B * cfg.n_sparse * cfg.multi_hot * cfg.embed_dim * 4 * mult
                + B * sum(cfg.mlp_dims) * 4 * mult
                + (cfg.n_params() * 16 if mult == 3 else 0))}


def build_cell(shape: str, mesh=None) -> Cell:
    """The dry-run cell (``recsys_common.build_cell``)."""
    return rc.build_cell(sys.modules[__name__], shape, mesh)


def _flops(cfg, B, train):
    dims = (cfg.n_sparse * cfg.embed_dim + cfg.n_dense,) + cfg.mlp_dims
    mlp = sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))
    per = mlp + cfg.n_sparse * cfg.multi_hot * cfg.embed_dim * 2
    return B * per * (3 if train else 1)
