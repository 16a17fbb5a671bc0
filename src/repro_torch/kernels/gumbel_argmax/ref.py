"""Plain PyTorch version of the Gumbel-argmax kernel, and the random-bit
generator it rests on: ``jax.random``'s threefry2x32 in the partitionable
bit layout of jax 0.9 (key, fold-in, raw bits, uniform, Gumbel), in torch
integer ops — int64 tensors holding uint32 values, masked after every add
and shift, since torch's uint32 supports only part of the arithmetic.  The
bits and uniforms equal ``jax.random``'s bit for bit; the Gumbel values go
through two ``log`` calls and agree to 2e-6 (f32, absolute)."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_KS_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
F32_TINY = float(np.finfo(np.float32).tiny)
MIN_TEMP = 1e-6


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter words (x0, x1) under
    key (k0, k1).  Every argument is an int64 tensor (or int) of uint32
    values; they broadcast.  Returns the two output words, int64."""
    k0, k1, x0, x1 = (torch.as_tensor(a, dtype=torch.int64)
                      for a in (k0, k1, x0, x1))
    ks = (k0, k1, k0 ^ k1 ^ _KS_PARITY)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def random_key(seed) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.key(seed)`` for a uint32 seed: the words (0, seed)."""
    seed = torch.as_tensor(seed, dtype=torch.int64) & M32
    return torch.zeros_like(seed), seed


def fold_in(key, p) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in(key, p)``: the hash of the counter (0, p)."""
    k0, k1 = key
    p = torch.as_tensor(p, dtype=torch.int64) & M32
    return threefry2x32(k0, k1, torch.zeros_like(p), p)


def random_bits32(key, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` in the partitionable layout:
    element i is ``y0 ^ y1`` of the hash of the counter (0, i).  ``key``
    words may carry leading batch dimensions: the result is (..., n)."""
    k0, k1 = (torch.as_tensor(w, dtype=torch.int64)[..., None] for w in key)
    i = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0, k1, torch.zeros_like(i), i)
    return y0 ^ y1


def uniform_tiny_one(key, n: int) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), f32, minval=tiny, maxval=1)``: the top
    23 bits as the mantissa of a float in [1, 2), minus one, floored at the
    smallest normal f32 (f32)."""
    bits = random_bits32(key, n)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return f.clamp_min(F32_TINY)


def gumbel(key, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), f32)`` (mode "low"):
    ``-log(-log(u))`` of ``uniform_tiny_one``."""
    return -torch.log(-torch.log(uniform_tiny_one(key, n)))


def gumbel_argmax_ref(logits: torch.Tensor, pred_positions: torch.Tensor,
                      temp: torch.Tensor, seed: torch.Tensor,
                      greedy: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version of the sampled branch: row (b, t) takes
    ``argmax_v(logits[b, t, v] / max(temp[b], 1e-6) + g[v])`` with ``g``
    drawn from ``fold_in(key(seed[b]), pred_positions[b, t])``.  Rows of
    lanes with ``greedy[b]`` hold 0, as the kernel leaves them.
    Materialises the (B, T, V) noise in int64: the CPU path only."""
    B, T, V = logits.shape
    key = fold_in(random_key(seed.long()[:, None]), pred_positions.long())
    g = gumbel(key, V)                                          # (B, T, V)
    tau = temp.float().clamp_min(MIN_TEMP)
    z = logits.float() / tau[:, None, None]
    samp = (z + g).argmax(dim=-1).int()
    if greedy is not None:
        samp = torch.where(greedy.bool()[:, None], torch.zeros_like(samp),
                           samp)
    return samp


__all__ = ["threefry2x32", "random_key", "fold_in", "random_bits32",
           "uniform_tiny_one", "gumbel", "gumbel_argmax_ref", "F32_TINY",
           "MIN_TEMP", "M32"]
