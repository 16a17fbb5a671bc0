"""EquiformerV2-style equivariant graph attention via eSCN SO(2) convolutions
[arXiv:2306.12059] (PyTorch port of ``repro.models.gnn.equiformer``).

Core compute pattern (the irrep tensor-product regime of the taxonomy):
  per edge e = (s → t):
    1. rotate irreps features of s, t into the edge frame (Wigner-D blocks,
       edge aligned with ẑ)                                — O(L³) per edge
    2. SO(2) convolution: block-diagonal in m, |m| ≤ m_max  — the eSCN trick
       that replaces the O(L⁶) Clebsch-Gordan tensor product
    3. attention: logits from invariant (l=0) channels + radial basis,
       segment-softmax over incoming edges
    4. rotate messages back, scatter-sum into target nodes

Feature layout: x (N, (l_max+1)², C) with m-major blocks per l.

Two execution paths, chosen as the reference chooses them:
  * dense    — all edge tensors materialized (small/medium graphs),
  * chunked  — a loop over edge chunks with a two-pass segment softmax
               (memory-bounded; giant graphs).

The segment max is ``scatter_reduce(..., "amax")`` into a -inf start and the
segment sums are ``index_add_``.  On the card ``index_add_`` adds with
atomics in no fixed order, so its bits vary from run to run (and a bf16
accumulator rounds at every add): results on the card agree with another
run or device within a tolerance, never bit for bit.  The softmax does not
depend on the segment max mathematically, so the port takes no gradient
through it (it is detached); the reference differentiates through
``segment_max``, and the tests hold the gradients against
``jax.value_and_grad``.  The reference's ``param_logical_axes`` and
``constrain`` calls are not ported: they only place shardings, a no-op
without a mesh (multi-GPU is ROADMAP A16).  No kernel of the port runs on
this path: the reference reaches no Pallas kernel here either.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.params import Device, resolve_device, tree_to_torch
from repro_torch.models.recsys.common import generator, normal, torch_dtype
from .so3 import apply_blocks, lsq, rotation_to_z, wigner_blocks

Params = Dict


@dataclass(frozen=True)
class EquiformerConfig:
    """The reference's fields.  ``scan_layers`` has no effect in the port:
    the layers run in a Python loop either way (the reference scans or
    unrolls them).  ``remat`` checkpoints each layer's body."""
    name: str = "equiformer-v2"
    n_layers: int = 12
    channels: int = 128              # d_hidden: channels per irrep component
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_feat_in: int = 128             # scalar input features per node
    n_rbf: int = 32
    cutoff: float = 5.0
    n_out: int = 1                   # graph targets or node classes
    node_level: bool = False         # True: per-node outputs (classification)
    edge_chunk: int = 0              # >0: chunked path with this chunk size
    scan_layers: bool = True         # no effect in the port (see above)
    remat: bool = False              # checkpoint each layer (training)
    dtype: str = "float32"

    @property
    def lsq(self) -> int:
        return lsq(self.l_max)

    def n_params(self) -> int:
        C, L, M = self.channels, self.l_max, self.m_max
        n0 = L + 1
        so2 = (2 * n0 * C) * (n0 * C)                    # m=0
        for m in range(1, M + 1):
            nl = L + 1 - m
            so2 += 2 * (2 * nl * C) * (nl * C)           # W_r, W_i
        per_layer = (so2 + self.n_rbf * (L + 1) * 2 * C  # radial scale
                     + (2 * C + self.n_rbf) * self.n_heads  # attn mlp
                     + C * C                              # out proj
                     + 2 * (L + 1) * C                    # norms
                     + (L + 1) * C * 2 * C + C * 2 * C + (L + 1) * 2 * C * C)
        return (self.d_feat_in * C + self.n_layers * per_layer
                + C * C + C * self.n_out)


def _m_indices(l_max: int) -> Dict[int, Tuple[List[int], List[int]]]:
    """For each m: (plus-component indices, minus-component indices) into the
    lsq layout, over degrees l >= m."""
    out = {}
    for m in range(0, l_max + 1):
        plus = [l * l + l + m for l in range(m, l_max + 1)]
        minus = [l * l + l - m for l in range(m, l_max + 1)]
        out[m] = (plus, minus)
    return out


def _layer_shapes(cfg: EquiformerConfig) -> Dict[str, Tuple[Tuple, float]]:
    """Each stacked layer tensor's shape and its init scale (0: zeros, None:
    ones), in the reference's order of draws."""
    C, L, nL = cfg.channels, cfg.l_max, cfg.n_layers
    layer = {"w0": ((nL, (L + 1) * 2 * C, (L + 1) * C), 0.02)}
    for m in range(1, cfg.m_max + 1):
        nl = L + 1 - m
        layer[f"wr{m}"] = ((nL, nl * 2 * C, nl * C), 0.02)
        layer[f"wi{m}"] = ((nL, nl * 2 * C, nl * C), 0.02)
    layer.update({
        "rad_w": ((nL, cfg.n_rbf, (L + 1) * 2 * C), 0.05),
        "attn_w": ((nL, 2 * C + cfg.n_rbf, cfg.n_heads), 0.05),
        "attn_b": ((nL, cfg.n_heads), 0.0),
        "out_proj": ((nL, C, C), 0.02),
        "ln1": ((nL, L + 1, C), None),
        "ln2": ((nL, L + 1, C), None),
        # FFN: per-l linear C->2C, invariant gate, per-l linear 2C->C
        "ffn_w1": ((nL, L + 1, C, 2 * C), 0.02),
        "ffn_gate": ((nL, C, 2 * C), 0.02),
        "ffn_w2": ((nL, L + 1, 2 * C, C), 0.02),
    })
    return layer


def init_params(cfg: EquiformerConfig, seed: int = 0,
                device: Device = None) -> Params:
    """Random parameters made on ``device`` (None: the card) in the
    reference's layout and distributions: N(0, scale²) drawn in f32 and
    cast to ``cfg.dtype``, norm scales 1, the attention bias 0, stacked
    (n_layers, ...) layer tensors.  The numbers differ from JAX's for the
    same seed (another generator); tests that compare the two convert the
    reference's parameters with ``equiformer_params_from_jax``."""
    gen = generator(seed, device)
    dt = torch_dtype(cfg.dtype)
    C, L = cfg.channels, cfg.l_max

    def make(shape, scale):
        if scale is None:
            return torch.ones(shape, dtype=dt, device=gen.device)
        if scale == 0.0:
            return torch.zeros(shape, dtype=dt, device=gen.device)
        return normal(gen, shape, scale, dt)

    return {"w_in": make((cfg.d_feat_in, C), 0.02),
            "layers": {k: make(*v) for k, v in _layer_shapes(cfg).items()},
            "head_w1": make((C, C), 0.02),
            "head_w2": make((C, cfg.n_out), 0.02),
            "ln_f": make((L + 1, C), None)}


def equiformer_params_from_jax(cfg: EquiformerConfig, tree,
                               device: Device = None) -> Params:
    """The reference's ``init_params`` pytree as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``) as torch tensors of the same
    shapes and dtypes on ``device`` (None: the card)."""
    params = tree_to_torch(tree, resolve_device(device))
    want = {k: v[0] for k, v in _layer_shapes(cfg).items()}
    got = {k: tuple(v.shape) for k, v in params["layers"].items()}
    if got != want:
        raise ValueError(f"pytree layers {got} do not match the config's "
                         f"{want}")
    return params


# ------------------------------------------------------------------- pieces
_INDEX: Dict[Tuple, Dict[str, torch.Tensor]] = {}


def _so2_index(cfg: EquiformerConfig, device: torch.device
               ) -> Dict[str, torch.Tensor]:
    """The SO(2) convolution's gathers and its scatter as index tensors,
    built once per (l_max, m_max, device): ``m0`` and ``plus{m}`` /
    ``minus{m}`` pick components of z; ``place`` takes the concatenated
    outputs [y0, y+1, y-1, ..., zeros] to the lsq layout (the components
    with |m| > m_max are zero)."""
    key = (cfg.l_max, cfg.m_max, str(device))
    if key not in _INDEX:
        midx = _m_indices(cfg.l_max)
        order = list(midx[0][0])
        idx = {"m0": midx[0][0]}
        for m in range(1, cfg.m_max + 1):
            idx[f"plus{m}"], idx[f"minus{m}"] = midx[m]
            order += midx[m][0] + midx[m][1]
        place = [0] * cfg.lsq
        for k, c in enumerate(order):
            place[c] = k
        for k, c in enumerate(sorted(set(range(cfg.lsq)) - set(order))):
            place[c] = len(order) + k
        idx["place"] = place
        _INDEX[key] = {k: torch.tensor(v, dtype=torch.long, device=device)
                       for k, v in idx.items()}
    return _INDEX[key]


def _rbf(dist: torch.Tensor, n: int, cutoff: float) -> torch.Tensor:
    mu = torch.linspace(0.0, cutoff, n, device=dist.device)
    beta = (n / cutoff) ** 2
    return torch.exp(-beta * (dist[..., None] - mu) ** 2)


class _EqNormBlock(torch.autograd.Function):
    """One l-block of ``_eq_norm``: (blk * rsqrt(mean(blk²) + eps)) * scale,
    the mean square in f32 and its rsqrt cast to blk's dtype before the
    multiply, as the reference computes it.  The backward is autograd's
    chain written out; it keeps blk (the layer's input, alive anyway), the
    rsqrt and the scale, where autograd would keep blk's f32 copy and the
    (blk * rsqrt) product, two more tensors of x's size."""

    @staticmethod
    def forward(ctx, blk, scale, eps):
        ms = blk.float().square().mean(dim=(-2, -1), keepdim=True)
        r = torch.rsqrt(ms + eps).to(blk.dtype)
        ctx.eps = eps
        ctx.save_for_backward(blk, r, scale)
        return (blk * r) * scale[..., None, :]

    @staticmethod
    def backward(ctx, grad):
        blk, r, scale = ctx.saved_tensors
        d_scale = (grad * (blk * r)).sum(dim=tuple(range(grad.dim() - 1)))
        d_y = grad * scale[..., None, :]
        d_r = (d_y * blk).sum(dim=(-2, -1), keepdim=True)
        xf = blk.float()
        rf = torch.rsqrt(xf.square().mean(dim=(-2, -1), keepdim=True)
                         + ctx.eps)
        d_ms = d_r.float() * (-0.5) * rf * rf * rf
        n = blk.shape[-2] * blk.shape[-1]
        d_blk = d_y * r + (d_ms * (2.0 / n) * xf).to(blk.dtype)
        return d_blk, d_scale.reshape(scale.shape), None


def _eq_norm(x: torch.Tensor, scale: torch.Tensor, l_max: int,
             eps: float = 1e-6) -> torch.Tensor:
    """Equivariant RMS norm: normalize each l-block by its RMS over (m, C)
    (``_EqNormBlock``)."""
    return torch.cat([_EqNormBlock.apply(x[..., l * l:(l + 1) * (l + 1), :],
                                         scale[..., l, :], eps)
                      for l in range(l_max + 1)], dim=-2)


def _so2_conv(z: torch.Tensor, lp: Dict, cfg: EquiformerConfig
              ) -> torch.Tensor:
    """z (E, lsq, 2C) rotated concat features -> (E, lsq, C) messages.
    Block-diagonal in m; components with |m| > m_max are truncated (eSCN).
    The reference's exact ``.at[:, idx].set`` writes are one gather of the
    concatenated outputs (``place``)."""
    E = z.shape[0]
    C, L = cfg.channels, cfg.l_max
    idx = _so2_index(cfg, z.device)
    # m = 0
    z0 = z.index_select(1, idx["m0"]).reshape(E, -1)
    ys = [(z0 @ lp["w0"]).reshape(E, L + 1, C)]
    # 1 <= m <= m_max
    for m in range(1, cfg.m_max + 1):
        nl = L + 1 - m
        zp = z.index_select(1, idx[f"plus{m}"]).reshape(E, -1)
        zm = z.index_select(1, idx[f"minus{m}"]).reshape(E, -1)
        wr, wi = lp[f"wr{m}"], lp[f"wi{m}"]
        ys.append((zp @ wr - zm @ wi).reshape(E, nl, C))
        ys.append((zm @ wr + zp @ wi).reshape(E, nl, C))
    n_zero = cfg.lsq - sum(y.shape[1] for y in ys)
    ys.append(z.new_zeros((E, n_zero, C)))
    return torch.cat(ys, dim=1).index_select(1, idx["place"])


class _Gather(torch.autograd.Function):
    """x[idx] along the first axis.  Its backward scatter-adds the gradient
    with ``index_add_`` (atomics on the card), where autograd's backward of
    indexing sorts the indices first (1.21 s of a minibatch_lg step's 8.28
    s of device time on the H100, PERF.md §6)."""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.n = x.shape[0]
        return x.index_select(0, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        out = grad.new_zeros((ctx.n,) + tuple(grad.shape[1:]))
        return out.index_add_(0, idx, grad), None


def _edge_messages(lp: Dict, cfg: EquiformerConfig, xn: torch.Tensor,
                   src: torch.Tensor, dst: torch.Tensor,
                   blocks: List[torch.Tensor], rbf: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full per-edge message + attention logits.

    Returns (msg (E, lsq, C) — rotated back, logits (E, H) f32).  The
    gathered and rotated (E, lsq, C) features are not kept by name once
    they are used, so that a forward without grad holds as few of them as
    the products allow."""
    xs, xt = _Gather.apply(xn, src), _Gather.apply(xn, dst)
    inv = torch.cat([xs[:, 0, :], xt[:, 0, :], rbf.to(xn.dtype)], dim=-1)
    logits = (inv @ lp["attn_w"] + lp["attn_b"]).float()
    z = torch.cat([apply_blocks(blocks, xs), apply_blocks(blocks, xt)],
                  dim=-1)                                     # (E, lsq, 2C)
    del xs, xt
    # radial modulation per (l, 2C), broadcast over m within l (one
    # product a degree: no (E, lsq, 2C) copy of the radial factors)
    rad = (rbf @ lp["rad_w"]).reshape(rbf.shape[0], cfg.l_max + 1,
                                      2 * cfg.channels)
    z = torch.cat([z[:, l * l:(l + 1) * (l + 1)] * rad[:, l:l + 1]
                   for l in range(cfg.l_max + 1)], dim=1)
    msg = _so2_conv(z, lp, cfg)
    del z
    msg = apply_blocks(blocks, msg, transpose=True)             # rotate back
    return msg, logits


def _segment_max(logits: torch.Tensor, dst: torch.Tensor, n_nodes: int
                 ) -> torch.Tensor:
    """jax.ops.segment_max: -inf where a segment has no entry."""
    out = torch.full((n_nodes, logits.shape[1]), -math.inf,
                     dtype=logits.dtype, device=logits.device)
    idx = dst.long()[:, None].expand_as(logits)
    return out.scatter_reduce(0, idx, logits.detach(), "amax")


class _SegmentSum(torch.autograd.Function):
    """jax.ops.segment_sum: ``index_add`` into zeros (atomics on the card:
    the sum order is not fixed).  Its backward is a gather of the
    gradient and keeps only the index; autograd of ``index_add`` would
    keep the summed values too."""

    @staticmethod
    def forward(ctx, vals, idx, n_nodes):
        ctx.save_for_backward(idx)
        out = vals.new_zeros((n_nodes,) + tuple(vals.shape[1:]))
        return out.index_add_(0, idx, vals)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        return grad.index_select(0, idx), None, None


def _segment_sum(vals: torch.Tensor, dst: torch.Tensor, n_nodes: int
                 ) -> torch.Tensor:
    return _SegmentSum.apply(vals, dst.long(), n_nodes)


def _attention_dense(lp: Dict, cfg: EquiformerConfig, x: torch.Tensor,
                     src: torch.Tensor, dst: torch.Tensor,
                     blocks: List[torch.Tensor], rbf: torch.Tensor,
                     edge_mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    xn = _eq_norm(x, lp["ln1"], cfg.l_max)
    msg, logits = _edge_messages(lp, cfg, xn, src, dst, blocks, rbf)
    logits = torch.where(edge_mask[:, None], logits, -1e30)
    seg_max = _segment_max(logits, dst, n_nodes).clamp_min(-1e30)
    w = torch.exp(logits - seg_max[dst]) * edge_mask[:, None]
    denom = _segment_sum(w, dst, n_nodes)
    H = cfg.n_heads
    ch = cfg.channels // H
    wmsg = (msg.reshape(msg.shape[0], cfg.lsq, H, ch)
            * w[:, None, :, None].to(msg.dtype))
    del msg
    num = _segment_sum(wmsg, dst, n_nodes)
    del wmsg
    agg = num / denom.clamp_min(1e-20)[:, None, :, None].to(num.dtype)
    agg = agg.reshape(n_nodes, cfg.lsq, cfg.channels)
    return x + agg @ lp["out_proj"]


def _edge_frames(edge_vec: torch.Tensor, cfg: EquiformerConfig,
                 dtype: torch.dtype) -> List[torch.Tensor]:
    """The Wigner-D blocks of each edge's frame (edge along ẑ), in
    ``dtype``."""
    R = rotation_to_z(edge_vec)
    return [b.to(dtype) for b in wigner_blocks(R, cfg.l_max)]


def _attention_chunked(lp: Dict, cfg: EquiformerConfig, x: torch.Tensor,
                       src: torch.Tensor, dst: torch.Tensor,
                       edge_vec: torch.Tensor, rbf: torch.Tensor,
                       edge_mask: torch.Tensor, n_nodes: int
                       ) -> torch.Tensor:
    """Two-pass chunked attention: pass A computes logits (cheap —
    invariants only) and the segment max; pass B streams the full SO(2)
    messages into a ``num`` accumulator in ``x.dtype`` and a ``den`` one in
    f32.  Wigner blocks recomputed per chunk (flops-for-memory)."""
    E = src.shape[0]
    ck = cfg.edge_chunk
    nchunk = E // ck
    assert E % ck == 0, (E, ck)
    H = cfg.n_heads
    xn = _eq_norm(x, lp["ln1"], cfg.l_max)
    inv = xn[:, 0, :]

    def logits_chunk(s, d, r, m):
        z = torch.cat([inv[s], inv[d], r.to(inv.dtype)], dim=-1)
        lg = (z @ lp["attn_w"] + lp["attn_b"]).float()
        return torch.where(m[:, None], lg, -1e30)

    chunks = [slice(i * ck, (i + 1) * ck) for i in range(nchunk)]
    smax = torch.full((n_nodes, H), -math.inf, dtype=torch.float32,
                      device=x.device)
    for c in chunks:                                            # pass A
        lg = logits_chunk(src[c], dst[c], rbf[c], edge_mask[c])
        smax = torch.maximum(smax, _segment_max(lg, dst[c], n_nodes))
    smax = smax.clamp_min(-1e30)

    ch = cfg.channels // H
    num = x.new_zeros((n_nodes, cfg.lsq, H, ch))
    den = torch.zeros((n_nodes, H), dtype=torch.float32, device=x.device)
    for c in chunks:                                            # pass B
        s, d, m = src[c], dst[c], edge_mask[c]
        blocks = _edge_frames(edge_vec[c], cfg, x.dtype)
        msg, lg = _edge_messages(lp, cfg, xn, s, d, blocks, rbf[c])
        lg = torch.where(m[:, None], lg, -1e30)
        w = torch.exp(lg - smax[d]) * m[:, None]
        den = den + _segment_sum(w, d, n_nodes)
        wmsg = (msg.reshape(ck, cfg.lsq, H, ch)
                * w[:, None, :, None].to(msg.dtype))
        del msg
        num = num + _segment_sum(wmsg, d, n_nodes)
        del wmsg
    agg = num / den.clamp_min(1e-20)[:, None, :, None].to(x.dtype)
    agg = agg.reshape(n_nodes, cfg.lsq, cfg.channels)
    return x + agg @ lp["out_proj"]


def _ffn(lp: Dict, cfg: EquiformerConfig, x: torch.Tensor) -> torch.Tensor:
    xn = _eq_norm(x, lp["ln2"], cfg.l_max)
    gate = torch.sigmoid(xn[:, 0, :] @ lp["ffn_gate"])          # (N, 2C)
    outs = []
    for l in range(cfg.l_max + 1):
        blk = xn[:, l * l:(l + 1) * (l + 1), :]
        h = (blk @ lp["ffn_w1"][l]) * gate[:, None, :]
        outs.append(h @ lp["ffn_w2"][l])
    return x + torch.cat(outs, dim=-2)


# ------------------------------------------------------------------- forward
def forward(cfg: EquiformerConfig, params: Params, node_feat: torch.Tensor,
            positions: torch.Tensor, edges: torch.Tensor,
            edge_mask: torch.Tensor, graph_ids: Optional[torch.Tensor] = None,
            n_graphs: int = 1) -> Dict[str, torch.Tensor]:
    """node_feat (N, d_feat), positions (N, 3), edges (E, 2) int32 [src, dst],
    edge_mask (E,) bool.  Returns dict with 'node_out' (N, n_out),
    'graph_out' (n_graphs, n_out) (mean-pooled) and 'l1_feats' (N, 3, C).

    The chunked path runs when ``cfg.edge_chunk`` divides E into more than
    one chunk, else the dense path: the reference's condition, under which
    a padded E that is no multiple of the chunk runs dense."""
    N = node_feat.shape[0]
    C = cfg.channels
    dt = torch_dtype(cfg.dtype)
    h0 = node_feat.to(dt) @ params["w_in"]
    x = torch.cat([h0[:, None, :], h0.new_zeros((N, cfg.lsq - 1, C))], dim=1)

    src, dst = edges[:, 0].long(), edges[:, 1].long()
    rel = positions[src] - positions[dst]
    dist = torch.linalg.vector_norm(rel.float(), dim=-1).clamp_min(1e-6)
    rbf = _rbf(dist, cfg.n_rbf, cfg.cutoff).to(dt)
    edge_vec = (rel / dist[:, None]).float()

    use_chunk = cfg.edge_chunk > 0 and src.shape[0] % cfg.edge_chunk == 0 \
        and src.shape[0] > cfg.edge_chunk
    if not use_chunk:
        blocks = _edge_frames(edge_vec, cfg, dt)

    names = list(params["layers"])

    def layer_body(x, *weights):
        lp = {n: w.to(x.dtype) for n, w in zip(names, weights)}
        if use_chunk:
            x = _attention_chunked(lp, cfg, x, src, dst, edge_vec, rbf,
                                   edge_mask, N)
        else:
            x = _attention_dense(lp, cfg, x, src, dst, blocks, rbf,
                                 edge_mask, N)
        return _ffn(lp, cfg, x)

    per_layer = [w.unbind(0) for w in params["layers"].values()]
    for i in range(cfg.n_layers):
        weights = [w[i] for w in per_layer]
        if cfg.remat:       # no layer draws random numbers: no RNG state
            x = checkpoint(layer_body, x, *weights, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = layer_body(x, *weights)
    x = _eq_norm(x, params["ln_f"], cfg.l_max)
    inv = torch.nn.functional.silu(x[:, 0, :] @ params["head_w1"])
    node_out = inv @ params["head_w2"]
    if graph_ids is None:
        graph_out = node_out.mean(dim=0, keepdim=True)
    else:
        s = _segment_sum(node_out, graph_ids, n_graphs)
        n = _segment_sum(node_out.new_ones((N, 1)), graph_ids, n_graphs)
        graph_out = s / n.clamp_min(1.0)
    return {"node_out": node_out, "graph_out": graph_out,
            "l1_feats": x[:, 1:4, :]}


def node_class_loss(cfg: EquiformerConfig, params: Params, batch: Dict
                    ) -> torch.Tensor:
    """Mean f32 cross-entropy over the nodes whose label is >= 0."""
    out = forward(cfg, params, batch["node_feat"], batch["positions"],
                  batch["edges"], batch["edge_mask"])
    logits = out["node_out"].float()
    labels = batch["labels"].long()
    lm = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, labels.clamp_min(0)[:, None])[:, 0]
    return (nll * lm).sum() / lm.sum().clamp_min(1)


def energy_loss(cfg: EquiformerConfig, params: Params, batch: Dict
                ) -> torch.Tensor:
    """Mean squared error of the mean-pooled graph outputs, in f32."""
    out = forward(cfg, params, batch["node_feat"], batch["positions"],
                  batch["edges"], batch["edge_mask"],
                  graph_ids=batch["graph_ids"],
                  n_graphs=batch["energies"].shape[0])
    pred = out["graph_out"][:, 0].float()
    return (pred - batch["energies"].float()).square().mean()


__all__ = ["EquiformerConfig", "init_params", "equiformer_params_from_jax",
           "forward", "node_class_loss", "energy_loss"]
