"""Shared neural building blocks: RMSNorm, RoPE, GQA attention, SwiGLU
(PyTorch port of ``repro.models.layers``; same math, same dtypes)."""
from __future__ import annotations

import functools
from typing import Callable, Tuple

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    dt = x.dtype
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def rope_angles(positions: torch.Tensor, head_dim: int, theta: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions (..., T) -> cos/sin (..., T, head_dim//2), f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    inv = float(theta) ** exps     # scalar base: no host-to-device copy
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x (B,T,H,dh); cos/sin (B,T,dh/2). LLaMA-style rotate-half."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(dt)


ACTS: dict = {
    "silu": F.silu,
    "gelu": functools.partial(F.gelu, approximate="tanh"),
    "relu": F.relu,
}


def causal_prefill_mask(positions: torch.Tensor, len_mask: torch.Tensor
                        ) -> torch.Tensor:
    """(B, T) positions + (B, S) valid-key mask -> (B, T, S) causal mask."""
    causal = positions[:, :, None] >= positions[:, None, :]
    return causal & len_mask[:, None, :]


def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor, *, softmax_in_f32: bool = True
                  ) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, T, H, dh); k, v: (B, S, K, dh); mask: (B, T, S) bool (True =
    attend).  H must be a multiple of K.  Returns (B, T, H, dh).  Masked
    scores are NEG_INF before the softmax, so a row with no visible key
    averages V (unlike the kernels, which return 0 there).
    """
    B, T, H, dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = dh ** -0.5
    qg = q.reshape(B, T, K, G, dh)
    if softmax_in_f32:
        scores = torch.einsum("btkgh,bskh->bkgts", qg.float(), k.float())
    else:
        scores = torch.einsum("btkgh,bskh->bkgts", qg, k)
    scores = scores * scale
    scores = torch.where(mask[:, None, None], scores,
                         torch.full_like(scores, NEG_INF))
    p = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgts,bskh->btkgh", p, v)
    return out.reshape(B, T, H, dh)


def gqa_attention_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_positions: torch.Tensor,
                          kv_len_mask: torch.Tensor, q_chunk: int
                          ) -> torch.Tensor:
    """Memory-bounded causal attention: a loop over query chunks (the
    reference's ``lax.scan``), so the score tensor is (B, K, G, q_chunk, S)
    instead of (B, K, G, T, S).

    q_positions (B, T): absolute position of each query token; kv_len_mask
    (B, S) bool: valid (non-pad) key positions.  A query attends to keys
    whose buffer index is at most its own position.
    """
    T = q.shape[1]
    if T % q_chunk:
        raise ValueError(f"q_chunk {q_chunk} does not divide T={T}")
    kpos = torch.arange(k.shape[1], device=q.device)[None, None, :]
    outs = []
    for c in range(0, T, q_chunk):
        pc = q_positions[:, c:c + q_chunk]
        m = (kpos <= pc[:, :, None]) & kv_len_mask[:, None, :]
        outs.append(gqa_attention(q[:, c:c + q_chunk], k, v, m))
    return torch.cat(outs, dim=1)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor, act: Callable = F.silu) -> torch.Tensor:
    return (act(x @ w_gate) * (x @ w_up)) @ w_down


__all__ = ["rms_norm", "rope_angles", "apply_rope", "causal_prefill_mask",
           "gqa_attention", "gqa_attention_chunked", "swiglu", "ACTS",
           "NEG_INF"]
