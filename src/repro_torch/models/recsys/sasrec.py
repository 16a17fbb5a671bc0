"""SASRec [arXiv:1808.09781]: causal self-attention sequential recommender
(PyTorch port of ``repro.models.recsys.sasrec``).

Next-item objective; ``serve`` exposes single-step next-item scoring.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.distributed.sharding import Mesh
from repro_torch.models.params import Device
from .common import Lanes, generator, torch_dtype
from .seq_common import (catalog_scores, encode, encoder_logical_axes,
                         encoder_shapes, init_encoder, last_hidden, placed,
                         sampled_softmax_nll)


@dataclass(frozen=True)
class SasRecConfig:
    name: str = "sasrec"
    n_items: int = 50_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50
    dtype: str = "float32"

    def n_params(self) -> int:
        d = self.embed_dim
        return (self.n_items * d + self.seq_len * d
                + self.n_blocks * (4 * d * d + 8 * d * d) + d)


def init_params(cfg: SasRecConfig, seed: int = 0, device: Device = None,
                mesh: Mesh = None) -> Dict:
    """With ``mesh`` each rank keeps its block of every leaf, the same
    numbers (``seq_common.init_encoder``)."""
    return init_encoder(generator(seed, device), cfg.n_items, cfg.embed_dim,
                        cfg.n_blocks, cfg.n_heads, cfg.seq_len,
                        torch_dtype(cfg.dtype), mesh)


def param_logical_axes(cfg: SasRecConfig) -> Dict:
    return encoder_logical_axes(cfg.n_blocks)


def param_shapes(cfg: SasRecConfig) -> Dict:
    return encoder_shapes(cfg.n_items, cfg.embed_dim, cfg.n_blocks,
                          cfg.seq_len)


def hidden(cfg: SasRecConfig, params: Dict, ids: torch.Tensor,
           pad_mask: torch.Tensor, lanes: Lanes = None) -> torch.Tensor:
    """(B, S, d); under a mesh this rank's rows (``params`` as the rank
    uses them: ``placed``)."""
    if lanes is None:
        lanes, params = placed(params, ids.shape[0])
    return encode(params, lanes.local(ids), cfg.n_blocks, cfg.n_heads,
                  causal=True, pad_mask=lanes.local(pad_mask),
                  n_items=cfg.n_items)


def loss(cfg: SasRecConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Next-item objective with SAMPLED softmax over a shared negative set.

    batch: ids (B,S), labels (B,S) (-1 pad), negatives (NS,), pad_mask."""
    lanes, params = placed(params, batch["ids"].shape[0])
    h = hidden(cfg, params, batch["ids"], batch["pad_mask"], lanes)
    return sampled_softmax_nll(h, params["item_emb"],
                               lanes.local(batch["labels"]),
                               batch["negatives"], cfg.n_items, lanes)


def serve(cfg: SasRecConfig, params: Dict, ids: torch.Tensor,
          pad_mask: torch.Tensor, cand_ids=None) -> torch.Tensor:
    """Next-item scores at the last valid position; cand_ids (B,C) for
    ranking-stage candidate scoring, None for full catalog (retrieval)."""
    lanes, params = placed(params, ids.shape[0])
    hl = last_hidden(hidden(cfg, params, ids, pad_mask, lanes),
                     lanes.local(pad_mask))
    return catalog_scores(params, hl, lanes.local(cand_ids), cfg.n_items)


__all__ = ["SasRecConfig", "init_params", "param_logical_axes",
           "param_shapes", "hidden", "loss", "serve"]
