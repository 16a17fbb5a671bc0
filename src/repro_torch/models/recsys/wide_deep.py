"""Wide & Deep CTR model [arXiv:1606.07792] (PyTorch port of
``repro.models.recsys.wide_deep``).

40 sparse fields → 32-dim embeddings → concat → deep MLP 1024-512-256;
wide part = per-field 1-dim embeddings (linear over the raw categorical
crosses) + dense features.  The embedding-bag lookup over the multi-hot
fields is the hot path: one launch of the fused EmbeddingBag kernel bags
all 40 fields of the deep tables, one more the wide tables.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.models.params import Device
from . import embedding as E
from .common import bce_loss, generator, init_mlp, mlp, normal, torch_dtype


@dataclass(frozen=True)
class WideDeepConfig:
    name: str = "wide-deep"
    n_sparse: int = 40
    embed_dim: int = 32
    rows_per_table: int = 100_000
    multi_hot: int = 4              # ids per field (bag size)
    mlp_dims: Tuple[int, ...] = (1024, 512, 256)
    n_dense: int = 13
    dtype: str = "float32"

    def n_params(self) -> int:
        emb = self.n_sparse * self.rows_per_table * (self.embed_dim + 1)
        dims = (self.n_sparse * self.embed_dim + self.n_dense,) + self.mlp_dims
        deep = sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return emb + deep + dims[-1] + 1 + self.n_dense


def init_params(cfg: WideDeepConfig, seed: int = 0,
                device: Device = None) -> Dict:
    """Parameters drawn on ``device`` (None: the card) with a torch
    generator, in the reference's layout and distributions."""
    gen = generator(seed, device)
    dt = torch_dtype(cfg.dtype)
    F, V = cfg.n_sparse, cfg.rows_per_table
    deep_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    return {
        # one stacked table per part: (F, V, D)
        "tables": E.init_table(gen, F * V, cfg.embed_dim, dtype=dt
                               ).reshape(F, V, cfg.embed_dim),
        "wide_tables": E.init_table(gen, F * V, 1, dtype=dt).reshape(F, V, 1),
        "wide_dense": torch.zeros((cfg.n_dense,), dtype=dt,
                                  device=gen.device),
        "deep": init_mlp(gen, (deep_in,) + cfg.mlp_dims, dt),
        "head": normal(gen, (cfg.mlp_dims[-1], 1), 0.05, dt),
        "bias": torch.zeros((1,), dtype=dt, device=gen.device),
    }


def forward(cfg: WideDeepConfig, params: Dict, sparse_ids: torch.Tensor,
            sparse_mask: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """sparse_ids (B, F, L) int, sparse_mask (B, F, L), dense (B, n_dense)
    -> logits (B,)."""
    B = sparse_ids.shape[0]
    emb = E.embedding_bag(params["tables"], sparse_ids,
                          mask=sparse_mask)                   # (B, F, D)
    wide = E.embedding_bag(params["wide_tables"], sparse_ids,
                           mask=sparse_mask)                  # (B, F, 1)
    deep_in = torch.cat([emb.reshape(B, -1), dense.to(emb.dtype)], dim=-1)
    deep_out = mlp(params["deep"], deep_in, final_act=True)
    logit = (deep_out @ params["head"])[:, 0]
    logit = logit + wide.sum(dim=(1, 2)) + dense @ params["wide_dense"]
    return logit + params["bias"][0]


def loss(cfg: WideDeepConfig, params: Dict, batch: Dict) -> torch.Tensor:
    logits = forward(cfg, params, batch["sparse_ids"], batch["sparse_mask"],
                     batch["dense"])
    return bce_loss(logits, batch["labels"])


__all__ = ["WideDeepConfig", "init_params", "forward", "loss"]
