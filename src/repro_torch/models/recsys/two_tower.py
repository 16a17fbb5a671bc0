"""Two-tower retrieval model [Yi et al., RecSys'19 (YouTube)] (PyTorch port
of ``repro.models.recsys.two_tower``).

User tower and item tower: sparse-feature embeddings → MLP 1024-512-256 →
L2-normalized 256-dim embeddings; dot-product score; in-batch sampled
softmax (+ logQ correction hook).  ``score_candidates`` scores one query
against a candidate matrix with one product and a top-k whose ties go to
the lower index, as ``jax.lax.top_k``'s do.

Under a mesh (``sharding_ctx``) the per-field tables lie on (None,
"table_rows", None): a single-hot lookup is the rank's masked take summed
over ``model`` (one row and zeros: exact, ``field_rows``).  The towers
run on this rank's
rows of the ids (``Lanes``), their MLPs whole, gradients summed over the
rows' ranks.  The in-batch softmax gathers every rank's item embeddings,
as GSPMD gathers them, so the loss is the whole batch's.
``score_candidates`` scores this rank's block of the candidates (their
"candidates" axes: every rank), takes its top-k, gathers the ranks'
(value, global index) pairs and merges them in one stable top-k, ties to
the lower global index.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import (Mesh, active_mesh,
                                              active_rules, placement,
                                              row_window)
from repro_torch.models.params import Device
from . import embedding as E
from .common import (Lanes, generator, in_batch_softmax_loss, init_mlp, mlp,
                     mlp_logical_axes, place, torch_dtype)


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


TABLE_AXES = (None, "table_rows", None)


def init_params(cfg: TwoTowerConfig, seed: int = 0, device: Device = None,
                mesh: Mesh = None) -> Dict:
    """The tables drawn a field at a time; with ``mesh`` each rank keeps
    its block of their rows (the same numbers)."""
    gen = generator(seed, device)
    dt = torch_dtype(cfg.dtype)
    V, D = cfg.rows_per_table, cfg.feat_dim
    Fu, Fi = cfg.n_user_fields, cfg.n_item_fields
    return {
        "user_tables": E.init_fields(gen, Fu, V, D, place(
            mesh, (Fu, V, D), TABLE_AXES), dtype=dt),
        "item_tables": E.init_fields(gen, Fi, V, D, place(
            mesh, (Fi, V, D), TABLE_AXES), dtype=dt),
        "user_mlp": init_mlp(gen, (Fu * D,) + cfg.tower_dims, dt),
        "item_mlp": init_mlp(gen, (Fi * D,) + cfg.tower_dims, dt),
    }


def param_logical_axes(cfg: TwoTowerConfig) -> Dict:
    m = mlp_logical_axes(len(cfg.tower_dims))
    return {"user_tables": TABLE_AXES, "item_tables": TABLE_AXES,
            "user_mlp": dict(m), "item_mlp": dict(m)}


def param_shapes(cfg: TwoTowerConfig) -> Dict:
    V, D = cfg.rows_per_table, cfg.feat_dim

    def tower(F):
        dims = (F * D,) + cfg.tower_dims
        t = {f"w{i}": (a, b) for i, (a, b) in enumerate(zip(dims[:-1],
                                                            dims[1:]))}
        t.update({f"b{i}": (b,) for i, b in enumerate(dims[1:])})
        return t
    return {"user_tables": (cfg.n_user_fields, V, D),
            "item_tables": (cfg.n_item_fields, V, D),
            "user_mlp": tower(cfg.n_user_fields),
            "item_mlp": tower(cfg.n_item_fields)}


def field_rows(cfg: TwoTowerConfig, tables: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """ids (B, F) single-hot per field -> each field's row (B, F, D)
    (under a mesh: this rank's rows of the batch, from the row split's
    lookup, which sums one row with zeros: exact)."""
    lanes = Lanes(ids.shape[0])
    tables = lanes.weight(tables)
    return E.lookup(tables, lanes.local(ids)[..., None], row_window(
        tables, cfg.rows_per_table))[..., 0, :]


def _tower(cfg: TwoTowerConfig, tables: torch.Tensor, mlp_p: Dict,
           ids: torch.Tensor) -> torch.Tensor:
    """ids (B, F) single-hot per field -> (B, embed_dim) L2-normalized
    (under a mesh: this rank's rows)."""
    emb = field_rows(cfg, tables, ids)                         # (B, F, D)
    out = mlp(Lanes(ids.shape[0]).weight(mlp_p),
              emb.reshape(emb.shape[0], -1))
    norm = torch.linalg.vector_norm(out.float(), dim=-1, keepdim=True)
    return out / norm.clamp_min(1e-6).to(out.dtype)


def user_embed(cfg: TwoTowerConfig, params: Dict, user_ids: torch.Tensor
               ) -> torch.Tensor:
    return _tower(cfg, params["user_tables"], params["user_mlp"], user_ids)


def item_embed(cfg: TwoTowerConfig, params: Dict, item_ids: torch.Tensor
               ) -> torch.Tensor:
    return _tower(cfg, params["item_tables"], params["item_mlp"], item_ids)


def loss(cfg: TwoTowerConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """In-batch sampled softmax.  Under a mesh each rank scores its rows'
    queries against every rank's items (gathered; their gradients go
    back to the rank that made them) and the loss sums over the ranks."""
    q = user_embed(cfg, params, batch["user_ids"])
    c = item_embed(cfg, params, batch["item_ids"])
    lanes = Lanes(batch["user_ids"].shape[0])
    if not lanes.axes:
        return in_batch_softmax_loss(q, c, batch.get("logq"))
    scores = q.float() @ lanes.gather_blocks(c).float().T      # (B_l, B)
    if batch.get("logq") is not None:
        scores = scores - batch["logq"][None, :]
    logp = torch.log_softmax(scores, dim=-1)
    diag = logp[torch.arange(q.shape[0], device=q.device),
                lanes.start + torch.arange(q.shape[0], device=q.device)]
    return -lanes.total(diag.sum()) / lanes.batch


def top_k(scores: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest, ties to the lower index (a
    stable descending sort: ``torch.topk`` promises no order among ties)."""
    values, idx = torch.sort(scores, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def score_candidates(cfg: TwoTowerConfig, params: Dict,
                     user_ids: torch.Tensor, cand_emb: torch.Tensor,
                     k: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Retrieval scoring: user_ids (1, F); cand_emb (N, D).  One product
    (not a loop) + top-k; under a mesh each rank's block of the
    candidates, merged."""
    q = Lanes(user_ids.shape[0]).gather(user_embed(cfg, params, user_ids))
    mesh = active_mesh()
    sh = None if mesh is None else placement(
        mesh, ("candidates", None), tuple(cand_emb.shape), active_rules(),
        inputs=True)
    axes = () if sh is None else tuple(
        a for a in sh.axes() if mesh.shape[a] > 1)
    if not axes:
        return top_k((cand_emb @ q[0]).float(), k)
    block = sh.local(cand_emb)
    n = block.shape[0]
    values, idx = top_k((block @ q[0]).float(), min(k, n))
    idx = idx + sh._index(2)[0] * n                             # global
    values = mesh.all_gather(values, axes).reshape(-1)
    idx = mesh.all_gather(idx, axes).reshape(-1)
    # the ranks' pairs by global index, then a stable sort by value: ties
    # to the lower global index, whatever order the ranks came in
    idx, order = torch.sort(idx, stable=True)
    values, top = top_k(values[order], k)
    return values, idx[top]


__all__ = ["TwoTowerConfig", "init_params", "param_logical_axes",
           "param_shapes", "field_rows", "user_embed", "item_embed", "loss",
           "score_candidates", "top_k"]
