"""Shared sequential-recommender transformer encoder (BERT4Rec / SASRec)
(PyTorch port of ``repro.models.recsys.seq_common``)."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.models.layers import ACTS, gqa_attention, rms_norm
from . import embedding as E
from .common import normal, wrap_index

GELU = ACTS["gelu"]     # jax.nn.gelu's default: the tanh approximation


def init_encoder(gen: torch.Generator, n_items: int, d: int, n_blocks: int,
                 n_heads: int, seq_len: int,
                 dtype: torch.dtype = torch.float32) -> Dict:
    dev = gen.device

    def ones():
        return torch.ones((d,), dtype=dtype, device=dev)

    p = {"item_emb": normal(gen, (n_items, d), 0.02, dtype),
         "pos_emb": normal(gen, (seq_len, d), 0.02, dtype),
         "ln_f": ones()}
    for b in range(n_blocks):
        p[f"blk{b}"] = {
            "ln1": ones(), "ln2": ones(),
            **{w: normal(gen, (d, d), 0.02, dtype)
               for w in ("wq", "wk", "wv", "wo")},
            "w1": normal(gen, (d, 4 * d), 0.02, dtype),
            "w2": normal(gen, (4 * d, d), 0.02, dtype),
        }
    return p


def encode(params: Dict, ids: torch.Tensor, n_blocks: int, n_heads: int,
           causal: bool, pad_mask: torch.Tensor) -> torch.Tensor:
    """ids (B, S) -> hidden (B, S, d).  pad_mask (B, S) True=valid."""
    B, S = ids.shape
    d = params["item_emb"].shape[1]
    dh = d // n_heads
    h = E.lookup(params["item_emb"], ids) + params["pos_emb"][None, :S]
    attn_mask = pad_mask.bool()[:, None, :].expand(B, S, S)
    if causal:
        ar = torch.arange(S, device=ids.device)
        attn_mask = attn_mask & (ar[None, :, None] >= ar[None, None, :])
    for b in range(n_blocks):
        p = params[f"blk{b}"]
        hn = rms_norm(h, p["ln1"])
        q = (hn @ p["wq"]).reshape(B, S, n_heads, dh)
        k = (hn @ p["wk"]).reshape(B, S, n_heads, dh)
        v = (hn @ p["wv"]).reshape(B, S, n_heads, dh)
        a = gqa_attention(q, k, v, attn_mask).reshape(B, S, d)
        h = h + a @ p["wo"]
        hn = rms_norm(h, p["ln2"])
        h = h + GELU(hn @ p["w1"]) @ p["w2"]
    return rms_norm(h, params["ln_f"])


def last_hidden(h: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """Hidden state at each row's last valid position, (B, d): the count of
    valid slots minus one, and -1 (a fully padded row) wraps to the last
    position, as ``jnp.take_along_axis`` does."""
    B, S = pad_mask.shape
    last = wrap_index(pad_mask.long().sum(dim=1) - 1, S)
    return h[torch.arange(B, device=h.device), last]


def catalog_scores(params: Dict, hl: torch.Tensor, cand_ids=None
                   ) -> torch.Tensor:
    """Scores of the last hidden states hl (B, d): against the full catalog
    (B, n_items) when ``cand_ids`` is None, else against each row's
    candidates (B, C)."""
    if cand_ids is None:
        return hl @ params["item_emb"].T
    cand = E.lookup(params["item_emb"], cand_ids)              # (B, C, d)
    return torch.einsum("bd,bcd->bc", hl, cand)


def sampled_softmax_nll(h: torch.Tensor, item_emb: torch.Tensor,
                        labels: torch.Tensor, negatives: torch.Tensor
                        ) -> torch.Tensor:
    """Mean negative log-likelihood of each label (index 0 of [label ⧺
    shared negatives]) over the slots whose label is >= 0; h (B, M, d),
    labels (B, M), negatives (NS,)."""
    pos_emb = E.lookup(item_emb, labels.clamp_min(0))          # (B, M, d)
    neg_emb = E.lookup(item_emb, negatives)
    pos_score = torch.sum(h * pos_emb, dim=-1, keepdim=True)
    neg_score = torch.einsum("bmd,nd->bmn", h, neg_emb)
    scores = torch.cat([pos_score, neg_score], dim=-1)
    logp = torch.log_softmax(scores.float(), dim=-1)
    lm = (labels >= 0).float()
    return -torch.sum(logp[..., 0] * lm) / lm.sum().clamp_min(1.0)


__all__ = ["init_encoder", "encode", "last_hidden", "catalog_scores",
           "sampled_softmax_nll"]
