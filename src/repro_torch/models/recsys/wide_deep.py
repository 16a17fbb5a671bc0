"""Wide & Deep CTR model [arXiv:1606.07792] (PyTorch port of
``repro.models.recsys.wide_deep``).

40 sparse fields → 32-dim embeddings → concat → deep MLP 1024-512-256;
wide part = per-field 1-dim embeddings (linear over the raw categorical
crosses) + dense features.  The embedding-bag lookup over the multi-hot
fields is the hot path: one launch of the fused EmbeddingBag kernel bags
all 40 fields of the deep tables, one more the wide tables.

Under a mesh (``sharding_ctx``) the stacked tables lie on (None,
"table_rows", None): a rank holds its window of every field's rows, B5
bags the window and the partial bags are summed over ``model``
(``embedding.embedding_bag(rows=)``).  The rows of ``sparse_ids``, the
mask and ``dense`` split over "batch" (``Lanes``); the deep MLP, the head
and the wide weights are whole on every rank, their gradients summed
over the rows' ranks.  ``forward`` returns this rank's rows of the
logits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import Mesh, row_window
from repro_torch.models.params import Device
from . import embedding as E
from .common import (Lanes, bce_loss, generator, init_mlp, mlp,
                     mlp_logical_axes, normal, place, torch_dtype)


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


TABLE_AXES = (None, "table_rows", None)


def init_params(cfg: WideDeepConfig, seed: int = 0, device: Device = None,
                mesh: Mesh = None) -> Dict:
    """Parameters drawn on ``device`` (None: the card) with a torch
    generator, in the reference's layout and distributions; the tables a
    field at a time.  With ``mesh`` each rank keeps its block of the
    tables (``placement`` under the active rules) and draws the same
    numbers, never holding more of a table than one field."""
    gen = generator(seed, device)
    dt = torch_dtype(cfg.dtype)
    F, V, D = cfg.n_sparse, cfg.rows_per_table, cfg.embed_dim
    deep_in = cfg.n_sparse * cfg.embed_dim + cfg.n_dense
    return {
        # one stacked table per part: (F, V, D)
        "tables": E.init_fields(gen, F, V, D, place(mesh, (F, V, D),
                                                    TABLE_AXES), dtype=dt),
        "wide_tables": E.init_fields(gen, F, V, 1, place(mesh, (F, V, 1),
                                                         TABLE_AXES),
                                     dtype=dt),
        "wide_dense": torch.zeros((cfg.n_dense,), dtype=dt,
                                  device=gen.device),
        "deep": init_mlp(gen, (deep_in,) + cfg.mlp_dims, dt),
        "head": normal(gen, (cfg.mlp_dims[-1], 1), 0.05, dt),
        "bias": torch.zeros((1,), dtype=dt, device=gen.device),
    }


def param_logical_axes(cfg: WideDeepConfig) -> Dict:
    """The reference's: the tables' rows on "table_rows", the rest
    replicated."""
    return {"tables": TABLE_AXES, "wide_tables": TABLE_AXES,
            "wide_dense": (None,), "deep": mlp_logical_axes(
                len(cfg.mlp_dims)), "head": (None, None), "bias": (None,)}


def param_shapes(cfg: WideDeepConfig) -> Dict:
    F, V = cfg.n_sparse, cfg.rows_per_table
    dims = (F * cfg.embed_dim + cfg.n_dense,) + cfg.mlp_dims
    deep = {f"w{i}": (a, b) for i, (a, b) in enumerate(zip(dims[:-1],
                                                          dims[1:]))}
    deep.update({f"b{i}": (b,) for i, b in enumerate(dims[1:])})
    return {"tables": (F, V, cfg.embed_dim), "wide_tables": (F, V, 1),
            "wide_dense": (cfg.n_dense,), "deep": deep,
            "head": (cfg.mlp_dims[-1], 1), "bias": (1,)}


def forward(cfg: WideDeepConfig, params: Dict, sparse_ids: torch.Tensor,
            sparse_mask: torch.Tensor, dense: torch.Tensor) -> torch.Tensor:
    """sparse_ids (B, F, L) int, sparse_mask (B, F, L), dense (B, n_dense)
    -> logits (B,) (under a mesh this rank's rows of them)."""
    lanes = Lanes(sparse_ids.shape[0])
    ids, mask, dense = (lanes.local(x) for x in (sparse_ids, sparse_mask,
                                                 dense))
    p = lanes.weight(params)
    B, V = ids.shape[0], cfg.rows_per_table
    emb = E.embedding_bag(p["tables"], ids, mask=mask,
                          rows=row_window(p["tables"], V))    # (B, F, D)
    wide = E.embedding_bag(p["wide_tables"], ids, mask=mask,
                           rows=row_window(p["wide_tables"], V))  # (B, F, 1)
    deep_in = torch.cat([emb.reshape(B, -1), dense.to(emb.dtype)], dim=-1)
    deep_out = mlp(p["deep"], deep_in, final_act=True)
    logit = (deep_out @ p["head"])[:, 0]
    logit = logit + wide.sum(dim=(1, 2)) + dense @ p["wide_dense"]
    return logit + p["bias"][0]


def loss(cfg: WideDeepConfig, params: Dict, batch: Dict) -> torch.Tensor:
    lanes = Lanes(batch["labels"].shape[0])
    logits = forward(cfg, params, batch["sparse_ids"], batch["sparse_mask"],
                     batch["dense"])
    return bce_loss(logits, lanes.local(batch["labels"]), lanes)


__all__ = ["WideDeepConfig", "init_params", "param_logical_axes",
           "param_shapes", "forward", "loss"]
