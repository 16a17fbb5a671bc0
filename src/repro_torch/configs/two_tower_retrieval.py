"""two-tower-retrieval [RecSys'19 YouTube]: embed_dim=256, towers
1024-512-256, dot interaction, sampled softmax; retrieval scores 1M
candidates via a batched dot + top-k (the numbers of
``repro.configs.two_tower_retrieval``)."""
import torch

from repro_torch.configs import recsys_common as rc
from repro_torch.configs.recsys_common import Input, ServeCell
from repro_torch.models.recsys import two_tower as model

ARCH = "two-tower-retrieval"
SHAPES = rc.SHAPES
N_CAND = 1_000_000
TOP_K = 128


def full_config() -> model.TwoTowerConfig:
    return model.TwoTowerConfig(embed_dim=256, feat_dim=64,
                                n_user_fields=8, n_item_fields=4,
                                rows_per_table=1_000_000,
                                tower_dims=(1024, 512, 256))


def smoke_config() -> model.TwoTowerConfig:
    return model.TwoTowerConfig(embed_dim=16, feat_dim=8, n_user_fields=3,
                                n_item_fields=2, rows_per_table=256,
                                tower_dims=(32, 16))


def paired_score(cfg, params, user_ids, item_ids) -> torch.Tensor:
    """serve_p99 / serve_bulk: each user's score for its paired item."""
    q = model.user_embed(cfg, params, user_ids)
    e = model.item_embed(cfg, params, item_ids)
    return torch.sum(q * e, dim=-1)


def retrieve(cfg, params, user_ids, cand_emb):
    """retrieval_cand: one user against N_CAND candidates, top TOP_K."""
    return model.score_candidates(cfg, params, user_ids, cand_emb, k=TOP_K)


def serve_cell(shape: str, cfg: model.TwoTowerConfig = None) -> ServeCell:
    rc.check_serve_shape(shape)
    cfg = cfg or full_config()
    if shape == "retrieval_cand":
        return ServeCell(retrieve, (
            Input("user_ids", (1, cfg.n_user_fields), "int32"),
            Input("cand_emb", (N_CAND, cfg.tower_dims[-1]), "float32")))
    B = rc.BATCHES[shape]
    return ServeCell(paired_score, (
        Input("user_ids", (B, cfg.n_user_fields), "int32"),
        Input("item_ids", (B, cfg.n_item_fields), "int32")))
