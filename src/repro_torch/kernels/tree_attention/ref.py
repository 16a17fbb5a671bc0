"""Plain PyTorch versions of the tree-attention kernels, dense and paged
(mirror ``tree_attention_ref`` / ``tree_attention_reference`` of the JAX
package, and the gather the reference's paged tests hold its paged kernel
against)."""
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


def paged_gather(pool: torch.Tensor, block_tables: torch.Tensor
                 ) -> torch.Tensor:
    """Each lane's blocks of the (n_blocks, bs, K, dh) pool in table order:
    (B, bpl * bs, K, dh), logical position p of lane b at row p."""
    B, bpl = block_tables.shape
    _, bs, K, dh = pool.shape
    return pool[block_tables.long()].reshape(B, bpl * bs, K, dh)


def paged_tree_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                   v_pool: torch.Tensor,
                                   block_tables: torch.Tensor,
                                   mask: torch.Tensor) -> torch.Tensor:
    """The plain version of the paged kernel: gather each lane's blocks,
    then the dense plain version.  q (B, T, H, dh); k/v pool (n_blocks,
    bs, K, dh); block_tables (B, bpl) int; mask (B, T, bpl * bs)
    -> (B, T, H, dh)."""
    return tree_attention_reference(q, paged_gather(k_pool, block_tables),
                                    paged_gather(v_pool, block_tables), mask)


__all__ = ["tree_attention_ref", "tree_attention_reference", "paged_gather",
           "paged_tree_attention_reference"]
