"""BERT4Rec [arXiv:1904.06690]: bidirectional transformer over item
sequences, cloze (masked-item) objective (PyTorch port of
``repro.models.recsys.bert4rec``).  Encoder-only: serve = last-position
scoring."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import torch

from repro_torch.distributed.sharding import Mesh
from repro_torch.models.params import Device
from .common import Lanes, generator, torch_dtype, wrap_index
from .seq_common import (catalog_scores, encode, encoder_logical_axes,
                         encoder_shapes, init_encoder, last_hidden, placed,
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


def init_params(cfg: Bert4RecConfig, seed: int = 0, device: Device = None,
                mesh: Mesh = None) -> Dict:
    """With ``mesh`` each rank keeps its block of every leaf, the same
    numbers (``seq_common.init_encoder``)."""
    return init_encoder(generator(seed, device), cfg.n_items, cfg.embed_dim,
                        cfg.n_blocks, cfg.n_heads, cfg.seq_len,
                        torch_dtype(cfg.dtype), mesh)


def param_logical_axes(cfg: Bert4RecConfig) -> Dict:
    return encoder_logical_axes(cfg.n_blocks)


def param_shapes(cfg: Bert4RecConfig) -> Dict:
    return encoder_shapes(cfg.n_items, cfg.embed_dim, cfg.n_blocks,
                          cfg.seq_len)


def hidden(cfg: Bert4RecConfig, params: Dict, ids: torch.Tensor,
           pad_mask: torch.Tensor, lanes: Lanes = None) -> torch.Tensor:
    """(B, S, d); under a mesh this rank's rows (``params`` as the rank
    uses them: ``placed``)."""
    if lanes is None:
        lanes, params = placed(params, ids.shape[0])
    return encode(params, lanes.local(ids), cfg.n_blocks, cfg.n_heads,
                  causal=False, pad_mask=lanes.local(pad_mask),
                  n_items=cfg.n_items)


def loss(cfg: Bert4RecConfig, params: Dict, batch: Dict) -> torch.Tensor:
    """Cloze objective with SAMPLED softmax.

    batch: ids (B,S) with mask_id at cloze slots, masked_pos (B,M),
    masked_labels (B,M) (-1 = pad), negatives (NS,) shared sample,
    pad_mask (B,S).  Target = index 0 of [label ⧺ negatives]."""
    lanes, params = placed(params, batch["ids"].shape[0])
    h = hidden(cfg, params, batch["ids"], batch["pad_mask"], lanes)
    pos = wrap_index(lanes.local(batch["masked_pos"]), h.shape[1])
    hm = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[-1]))
    return sampled_softmax_nll(hm, params["item_emb"],
                               lanes.local(batch["masked_labels"]),
                               batch["negatives"], cfg.n_items, lanes)


def serve(cfg: Bert4RecConfig, params: Dict, ids: torch.Tensor,
          pad_mask: torch.Tensor, cand_ids=None) -> torch.Tensor:
    """Last-position scoring.  cand_ids (B, C): ranking-stage candidate
    scoring; None: full-catalog scores (B, n_items) — retrieval stage."""
    lanes, params = placed(params, ids.shape[0])
    hl = last_hidden(hidden(cfg, params, ids, pad_mask, lanes),
                     lanes.local(pad_mask))
    return catalog_scores(params, hl, lanes.local(cand_ids), cfg.n_items)


__all__ = ["Bert4RecConfig", "init_params", "param_logical_axes",
           "param_shapes", "hidden", "loss", "serve"]
