"""Plain PyTorch version of the tree-attention decode kernel (mirrors
``tree_attention_ref`` / ``tree_attention_reference`` of the JAX package)."""
from __future__ import annotations

import torch


def tree_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """q (B, K, TG, dh) grouped; k/v (B, S, K, dh); mask (B, T, S) bool,
    TG = T*G.  Returns (B, K, TG, dh) in q.dtype; softmax in f32, masked
    probabilities zeroed (a row with no visible key returns 0)."""
    B, K, TG, dh = q.shape
    T = mask.shape[1]
    g = TG // T
    s = torch.einsum("bktd,bskd->bkts", q.float(), k.float()) * (dh ** -0.5)
    m = mask.repeat_interleave(g, dim=1)[:, None]          # (B, 1, TG, S)
    s = torch.where(m, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    p = torch.where(m, p, torch.zeros_like(p))
    out = torch.einsum("bkts,bskd->bktd", p, v.float())
    return out.to(q.dtype)


def tree_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, mask: torch.Tensor
                             ) -> torch.Tensor:
    """The plain version at the public layout: q (B, T, H, dh); k/v
    (B, S, K, dh); mask (B, T, S) -> (B, T, H, dh)."""
    B, T, H, dh = q.shape
    K = k_cache.shape[2]
    G = H // K
    qg = q.reshape(B, T, K, G, dh).permute(0, 2, 1, 3, 4) \
        .reshape(B, K, T * G, dh)
    out = tree_attention_ref(qg, k_cache, v_cache, mask)
    out = out.reshape(B, K, T, G, dh).permute(0, 2, 1, 3, 4)
    return out.reshape(B, T, H, dh)


__all__ = ["tree_attention_ref", "tree_attention_reference"]
