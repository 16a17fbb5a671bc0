"""SASRec [arXiv:1808.09781]: causal self-attention sequential recommender
(PyTorch port of ``repro.models.recsys.sasrec``).

Next-item objective; ``serve`` exposes single-step next-item scoring.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.models.params import Device
from .common import generator, torch_dtype
from .seq_common import (catalog_scores, encode, init_encoder, last_hidden,
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


def init_params(cfg: SasRecConfig, seed: int = 0,
                device: Device = None) -> Dict:
    return init_encoder(generator(seed, device), cfg.n_items, cfg.embed_dim,
                        cfg.n_blocks, cfg.n_heads, cfg.seq_len,
                        torch_dtype(cfg.dtype))


def hidden(cfg: SasRecConfig, params: Dict, ids: torch.Tensor,
           pad_mask: torch.Tensor) -> torch.Tensor:
    return encode(params, ids, cfg.n_blocks, cfg.n_heads, causal=True,
                  pad_mask=pad_mask)


def loss(cfg: SasRecConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Next-item objective with SAMPLED softmax over a shared negative set.

    batch: ids (B,S), labels (B,S) (-1 pad), negatives (NS,), pad_mask."""
    h = hidden(cfg, params, batch["ids"], batch["pad_mask"])
    return sampled_softmax_nll(h, params["item_emb"], batch["labels"],
                               batch["negatives"])


def serve(cfg: SasRecConfig, params: Dict, ids: torch.Tensor,
          pad_mask: torch.Tensor, cand_ids=None) -> torch.Tensor:
    """Next-item scores at the last valid position; cand_ids (B,C) for
    ranking-stage candidate scoring, None for full catalog (retrieval)."""
    hl = last_hidden(hidden(cfg, params, ids, pad_mask), pad_mask)
    return catalog_scores(params, hl, cand_ids)


__all__ = ["SasRecConfig", "init_params", "hidden", "loss", "serve"]
