"""Two-tower retrieval model [Yi et al., RecSys'19 (YouTube)] (PyTorch port
of ``repro.models.recsys.two_tower``).

User tower and item tower: sparse-feature embeddings → MLP 1024-512-256 →
L2-normalized 256-dim embeddings; dot-product score; in-batch sampled
softmax (+ logQ correction hook).  ``score_candidates`` scores one query
against a candidate matrix with one product and a top-k whose ties go to
the lower index, as ``jax.lax.top_k``'s do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.models.params import Device
from . import embedding as E
from .common import (generator, in_batch_softmax_loss, init_mlp, mlp,
                     torch_dtype)


@dataclass(frozen=True)
class TwoTowerConfig:
    name: str = "two-tower-retrieval"
    embed_dim: int = 256            # final tower output dim
    feat_dim: int = 64              # per-field embedding dim
    n_user_fields: int = 8
    n_item_fields: int = 4
    rows_per_table: int = 100_000
    tower_dims: Tuple[int, ...] = (1024, 512, 256)
    dtype: str = "float32"

    def n_params(self) -> int:
        emb = (self.n_user_fields + self.n_item_fields) \
            * self.rows_per_table * self.feat_dim
        ud = (self.n_user_fields * self.feat_dim,) + self.tower_dims
        it = (self.n_item_fields * self.feat_dim,) + self.tower_dims
        tower = sum(a * b + b for a, b in zip(ud[:-1], ud[1:]))
        tower += sum(a * b + b for a, b in zip(it[:-1], it[1:]))
        return emb + tower


def init_params(cfg: TwoTowerConfig, seed: int = 0,
                device: Device = None) -> Dict:
    gen = generator(seed, device)
    dt = torch_dtype(cfg.dtype)
    V, D = cfg.rows_per_table, cfg.feat_dim
    return {
        "user_tables": E.init_table(gen, cfg.n_user_fields * V, D, dtype=dt
                                    ).reshape(cfg.n_user_fields, V, D),
        "item_tables": E.init_table(gen, cfg.n_item_fields * V, D, dtype=dt
                                    ).reshape(cfg.n_item_fields, V, D),
        "user_mlp": init_mlp(gen, (cfg.n_user_fields * D,) + cfg.tower_dims,
                             dt),
        "item_mlp": init_mlp(gen, (cfg.n_item_fields * D,) + cfg.tower_dims,
                             dt),
    }


def _tower(tables: torch.Tensor, mlp_p: Dict, ids: torch.Tensor
           ) -> torch.Tensor:
    """ids (B, F) single-hot per field -> (B, embed_dim) L2-normalized."""
    B = ids.shape[0]
    emb = E.lookup(tables, ids[..., None])[..., 0, :]          # (B, F, D)
    out = mlp(mlp_p, emb.reshape(B, -1))
    norm = torch.linalg.vector_norm(out.float(), dim=-1, keepdim=True)
    return out / norm.clamp_min(1e-6).to(out.dtype)


def user_embed(cfg: TwoTowerConfig, params: Dict, user_ids: torch.Tensor
               ) -> torch.Tensor:
    return _tower(params["user_tables"], params["user_mlp"], user_ids)


def item_embed(cfg: TwoTowerConfig, params: Dict, item_ids: torch.Tensor
               ) -> torch.Tensor:
    return _tower(params["item_tables"], params["item_mlp"], item_ids)


def loss(cfg: TwoTowerConfig, params: Dict, batch: Dict) -> torch.Tensor:
    q = user_embed(cfg, params, batch["user_ids"])
    c = item_embed(cfg, params, batch["item_ids"])
    return in_batch_softmax_loss(q, c, batch.get("logq"))


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest, ties to the lower index (a
    stable descending sort: ``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(scores, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def score_candidates(cfg: TwoTowerConfig, params: Dict,
                     user_ids: torch.Tensor, cand_emb: torch.Tensor,
                     k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retrieval scoring: user_ids (1, F); cand_emb (N, D).  One product
    (not a loop) + top-k."""
    q = user_embed(cfg, params, user_ids)                      # (1, D)
    scores = (cand_emb @ q[0]).float()                         # (N,)
    return top_k(scores, k)


__all__ = ["TwoTowerConfig", "init_params", "user_embed", "item_embed",
           "loss", "score_candidates", "top_k"]
