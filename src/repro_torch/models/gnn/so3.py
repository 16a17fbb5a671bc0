"""SO(3) machinery for eSCN-style equivariant networks (PyTorch port of
``repro.models.gnn.so3``).

* real spherical harmonics up to l_max (associated-Legendre recursion),
* real Wigner-D rotation blocks via the Ivanic–Ruedenberg recursion
  (J. Phys. Chem. 1996 + 1998 erratum) — D¹ is the rotation itself in the
  (y, z, x) real-SH ordering; higher degrees are built recursively, fully
  vectorized over edges,
* ``rotation_to_z`` — the per-edge frame used by the eSCN trick.

The recursion is the reference's, entry by entry: each entry of D² … D^l_max
is a few elementwise products of (E,) vectors, so eagerly it is a few
thousand small kernels a call (the GNN phase of ``chip_smoke.py`` counts
them).  Conventions are held by tests: orthogonality, composition
D(R₁R₂)=D(R₁)D(R₂), and the action property Y(R·r) = D(R)·Y(r).
"""
from __future__ import annotations

import math
from typing import List

import torch


# ------------------------------------------------------------------ real SH
def real_sph_harm(vecs: torch.Tensor, l_max: int) -> torch.Tensor:
    """vecs (..., 3) unit vectors -> (..., (l_max+1)^2) real SH values.

    Ordering: blocks of m = -l..l per degree.  Normalization: orthonormal
    (∫ Y² = 1).  Cartesian convention: θ polar from +z, φ azimuth from +x.
    """
    x, y, z = vecs[..., 0], vecs[..., 1], vecs[..., 2]
    ct = z.clamp(-1.0, 1.0)
    st = (1.0 - ct * ct).clamp_min(0.0).sqrt()
    phi = torch.atan2(y, x)

    # associated Legendre P_l^m(ct) via stable recursion
    P = {(0, 0): torch.ones_like(ct)}
    for m in range(1, l_max + 1):
        P[(m, m)] = -(2 * m - 1) * st * P[(m - 1, m - 1)]
    for m in range(0, l_max):
        P[(m + 1, m)] = (2 * m + 1) * ct * P[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            P[(l, m)] = ((2 * l - 1) * ct * P[(l - 1, m)]
                         - (l + m - 1) * P[(l - 2, m)]) / (l - m)

    out = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            N = math.sqrt((2 * l + 1) / (4 * math.pi)
                          * math.factorial(l - am) / math.factorial(l + am))
            # (-1)^m cancels the Condon–Shortley phase carried by P_l^m,
            # matching the standard real-SH convention (Y_{1,-1} ∝ +y).
            cs = (-1.0) ** am
            if m == 0:
                out.append(N * P[(l, 0)])
            elif m > 0:
                out.append(cs * math.sqrt(2.0) * N * P[(l, m)]
                           * torch.cos(m * phi))
            else:
                out.append(cs * math.sqrt(2.0) * N * P[(l, am)]
                           * torch.sin(am * phi))
    return torch.stack(out, dim=-1)


# ------------------------------------------------------------------ Wigner-D
_PERM = [1, 2, 0]     # real-SH m = (-1, 0, 1) is Cartesian (y, z, x)


def wigner_blocks(R: torch.Tensor, l_max: int) -> List[torch.Tensor]:
    """R (..., 3, 3) rotation matrices -> [D^0, D^1, ..., D^l_max] with
    D^l shaped (..., 2l+1, 2l+1), real-SH basis (m = -l..l)."""
    batch = R.shape[:-2]
    perm = torch.tensor(_PERM, device=R.device)
    D1 = R.index_select(-2, perm).index_select(-1, perm)
    blocks = [torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device), D1]

    def d1(i, j):  # i, j in {-1, 0, 1}
        return D1[..., i + 1, j + 1]

    for l in range(2, l_max + 1):
        Dp = blocks[-1]       # (..., 2l-1, 2l-1)

        def dp(mu, m):        # mu, m in [-(l-1), l-1]
            return Dp[..., mu + l - 1, m + l - 1]

        def Pf(i, mu, m):
            if abs(m) < l:
                return d1(i, 0) * dp(mu, m)
            if m == l:
                return d1(i, 1) * dp(mu, l - 1) - d1(i, -1) * dp(mu, -(l - 1))
            return d1(i, 1) * dp(mu, -(l - 1)) + d1(i, -1) * dp(mu, l - 1)

        rows = []
        for mp in range(-l, l + 1):
            row = []
            for m in range(-l, l + 1):
                denom = (l + m) * (l - m) if abs(m) < l else (2 * l) * (2 * l - 1)
                u = math.sqrt((l + mp) * (l - mp) / denom)
                v = 0.5 * math.sqrt((1.0 + (mp == 0)) * (l + abs(mp) - 1)
                                    * (l + abs(mp)) / denom) \
                    * (1.0 - 2.0 * (mp == 0))
                w = -0.5 * math.sqrt((l - abs(mp) - 1) * (l - abs(mp))
                                     / denom) * (1.0 - (mp == 0))
                terms = 0.0
                if u != 0.0:
                    terms = terms + u * Pf(0, mp, m)
                if v != 0.0:
                    if mp == 0:
                        V = Pf(1, 1, m) + Pf(-1, -1, m)
                    elif mp > 0:
                        V = (Pf(1, mp - 1, m) * math.sqrt(1.0 + (mp == 1))
                             - Pf(-1, -mp + 1, m) * (1.0 - (mp == 1)))
                    else:
                        V = (Pf(1, mp + 1, m) * (1.0 - (mp == -1))
                             + Pf(-1, -mp - 1, m) * math.sqrt(1.0 + (mp == -1)))
                    terms = terms + v * V
                if w != 0.0:
                    if mp > 0:
                        W = Pf(1, mp + 1, m) + Pf(-1, -mp - 1, m)
                    else:
                        W = Pf(1, mp - 1, m) - Pf(-1, -mp + 1, m)
                    terms = terms + w * W
                row.append(terms)
            rows.append(torch.stack(row, dim=-1))
        blocks.append(torch.stack(rows, dim=-2))
    return blocks


def _apply(blocks, feats, transpose):
    outs = []
    off = 0
    for l, D in enumerate(blocks):
        n = 2 * l + 1
        blk = feats[..., off:off + n, :]
        outs.append(torch.matmul(D.transpose(-1, -2) if transpose else D, blk))
        off += n
    return torch.cat(outs, dim=-2)


class _ApplyFixedBlocks(torch.autograd.Function):
    """``_apply`` where only the features take a gradient: the backward is
    the transposed rotation of the incoming gradient, and only the blocks
    are kept for it, not the (..., lsq, C) features autograd would keep
    for the products."""

    @staticmethod
    def forward(ctx, feats, transpose, *blocks):
        ctx.transpose = transpose
        ctx.save_for_backward(*blocks)
        return _apply(blocks, feats, transpose)

    @staticmethod
    def backward(ctx, grad):
        blocks = ctx.saved_tensors
        return ((_apply(blocks, grad, not ctx.transpose),)
                + (None,) * (1 + len(blocks)))


def apply_blocks(blocks: List[torch.Tensor], feats: torch.Tensor,
                 transpose: bool = False) -> torch.Tensor:
    """Apply block-diagonal Wigner-D to irreps features.

    blocks[l] (..., 2l+1, 2l+1); feats (..., lsq, C) with lsq = (l_max+1)².
    One batched product a degree.  When the blocks take no gradient (the
    model's edge frames: positions are not trained) the backward keeps
    only the blocks.
    """
    if any(D.requires_grad for D in blocks) or not (
            torch.is_grad_enabled() and feats.requires_grad):
        return _apply(blocks, feats, transpose)
    return _ApplyFixedBlocks.apply(feats, transpose, *blocks)


def rotation_to_z(vec: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """vec (..., 3) unit vectors -> R (..., 3, 3) with R @ vec = ẑ.

    Rodrigues rotation about axis = vec × ẑ; the ±ẑ singularities fall back
    to identity / rotation about x̂ by π.  A zero vector (a padding edge)
    has cosθ = 0 and axis 0, so its R is the identity.
    """
    v = vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True).clamp_min(eps)
    z = torch.zeros_like(v)
    z[..., 2] = 1.0
    axis = torch.linalg.cross(v, z, dim=-1)
    s = torch.linalg.vector_norm(axis, dim=-1, keepdim=True)    # sinθ
    c = v[..., 2:3]                                             # cosθ
    k = axis / s.clamp_min(eps)
    zero = torch.zeros_like(k[..., 0])
    K = torch.stack([
        torch.stack([zero, -k[..., 2], k[..., 1]], -1),
        torch.stack([k[..., 2], zero, -k[..., 0]], -1),
        torch.stack([-k[..., 1], k[..., 0], zero], -1),
    ], -2)
    eye = torch.eye(3, dtype=vec.dtype, device=vec.device).expand(K.shape)
    R = eye + s[..., None] * K + (1.0 - c[..., None]) * (K @ K)
    # v ≈ -ẑ: rotate π about x̂;  v ≈ +ẑ: identity
    flipx = torch.diag(torch.tensor([1.0, -1.0, -1.0], dtype=vec.dtype,
                                    device=vec.device)).expand(K.shape)
    R = torch.where((c < 1.0 - eps)[..., None], R, eye)
    R = torch.where((c > -1.0 + eps)[..., None], R, flipx)
    return R


def lsq(l_max: int) -> int:
    return (l_max + 1) ** 2


__all__ = ["real_sph_harm", "wigner_blocks", "apply_blocks", "rotation_to_z",
           "lsq"]
