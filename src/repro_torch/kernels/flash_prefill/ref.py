"""Plain PyTorch version of the causal flash-prefill kernel (mirrors
``flash_prefill_ref`` of the JAX package)."""
from __future__ import annotations

import torch


def flash_prefill_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                      ) -> torch.Tensor:
    """q (B, S, H, dh); k/v (B, S, K, dh) -> (B, S, H, dh), causal GQA
    attention with the softmax in f32, output in q.dtype."""
    B, S, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) \
        * (dh ** -0.5)
    causal = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
    s = torch.where(causal, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


flash_prefill_reference = flash_prefill_ref

__all__ = ["flash_prefill_ref", "flash_prefill_reference"]
