"""BERT4Rec [arXiv:1904.06690]: bidirectional transformer over item
sequences, cloze (masked-item) objective (PyTorch port of
``repro.models.recsys.bert4rec``).  Encoder-only: serve = last-position
scoring."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.models.params import Device
from .common import generator, torch_dtype, wrap_index
from .seq_common import (catalog_scores, encode, init_encoder, last_hidden,
                         sampled_softmax_nll)


@dataclass(frozen=True)
class Bert4RecConfig:
    name: str = "bert4rec"
    n_items: int = 50_000
    embed_dim: int = 64
    n_blocks: int = 2
    n_heads: int = 2
    seq_len: int = 200
    mask_id: int = 1                 # reserved item id for [MASK]
    dtype: str = "float32"

    def n_params(self) -> int:
        d = self.embed_dim
        return (self.n_items * d + self.seq_len * d
                + self.n_blocks * (4 * d * d + 8 * d * d) + d)


def init_params(cfg: Bert4RecConfig, seed: int = 0,
                device: Device = None) -> Dict:
    return init_encoder(generator(seed, device), cfg.n_items, cfg.embed_dim,
                        cfg.n_blocks, cfg.n_heads, cfg.seq_len,
                        torch_dtype(cfg.dtype))


def hidden(cfg: Bert4RecConfig, params: Dict, ids: torch.Tensor,
           pad_mask: torch.Tensor) -> torch.Tensor:
    return encode(params, ids, cfg.n_blocks, cfg.n_heads, causal=False,
                  pad_mask=pad_mask)


def loss(cfg: Bert4RecConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Cloze objective with SAMPLED softmax.

    batch: ids (B,S) with mask_id at cloze slots, masked_pos (B,M),
    masked_labels (B,M) (-1 = pad), negatives (NS,) shared sample,
    pad_mask (B,S).  Target = index 0 of [label ⧺ negatives]."""
    h = hidden(cfg, params, batch["ids"], batch["pad_mask"])
    pos = wrap_index(batch["masked_pos"], h.shape[1])
    hm = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[-1]))
    return sampled_softmax_nll(hm, params["item_emb"],
                               batch["masked_labels"], batch["negatives"])


def serve(cfg: Bert4RecConfig, params: Dict, ids: torch.Tensor,
          pad_mask: torch.Tensor, cand_ids=None) -> torch.Tensor:
    """Last-position scoring.  cand_ids (B, C): ranking-stage candidate
    scoring; None: full-catalog scores (B, n_items) — retrieval stage."""
    hl = last_hidden(hidden(cfg, params, ids, pad_mask), pad_mask)
    return catalog_scores(params, hl, cand_ids)


__all__ = ["Bert4RecConfig", "init_params", "hidden", "loss", "serve"]
