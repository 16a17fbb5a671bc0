"""Shared sequential-recommender transformer encoder (BERT4Rec / SASRec)
(PyTorch port of ``repro.models.recsys.seq_common``).

Under a mesh (``sharding_ctx``) the leaves lie as the reference's
``encoder_logical_axes`` put them: ``item_emb``'s rows on "table_rows"
(a lookup is the rank's masked take summed over ``model``; the full
catalog's scores are the rank's rows', gathered), the projections'
columns and ``wo`` / ``w2``'s rows on "tensor" wherever the ``model``
axis divides them (``placement`` keeps a dim whole otherwise, so SASRec's
d 52 splits at model 2 and not at 16).  The attention then runs on the
rank's heads, or, where its columns split a head, on every head with q,
k and v gathered over ``model`` (each rank keeps the output columns its
rows of ``wo`` multiply); the row-parallel products are summed over
``model`` and their inputs' gradients summed over it (Megatron's f and
g).  The caller gives the rows of the batch (``Lanes``) and the leaves
as each rank uses them (``Lanes.weight``)."""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.distributed.sharding import (P, Mesh, NamedSharding,
                                              active_mesh, active_rules,
                                              gather_blocks, placement,
                                              reduce_sum, row_window,
                                              sum_grad, unshard)
from repro_torch.models.layers import ACTS, gqa_attention, rms_norm
from . import embedding as E
from .common import Lanes, keep, normal, place, wrap_index

GELU = ACTS["gelu"]     # jax.nn.gelu's default: the tanh approximation


def encoder_logical_axes(n_blocks: int) -> Dict:
    """The reference's logical axes of the encoder's leaves."""
    p = {"item_emb": ("table_rows", None), "pos_emb": (None, None),
         "ln_f": (None,)}
    for b in range(n_blocks):
        p[f"blk{b}"] = {"ln1": (None,), "ln2": (None,),
                        "wq": (None, "tensor"), "wk": (None, "tensor"),
                        "wv": (None, "tensor"), "wo": ("tensor", None),
                        "w1": (None, "tensor"), "w2": ("tensor", None)}
    return p


def encoder_shapes(n_items: int, d: int, n_blocks: int, seq_len: int
                   ) -> Dict:
    p = {"item_emb": (n_items, d), "pos_emb": (seq_len, d), "ln_f": (d,)}
    for b in range(n_blocks):
        p[f"blk{b}"] = {"ln1": (d,), "ln2": (d,), "wq": (d, d),
                        "wk": (d, d), "wv": (d, d), "wo": (d, d),
                        "w1": (d, 4 * d), "w2": (4 * d, d)}
    return p


def init_encoder(gen: torch.Generator, n_items: int, d: int, n_blocks: int,
                 n_heads: int, seq_len: int,
                 dtype: torch.dtype = torch.float32,
                 mesh: Optional[Mesh] = None) -> Dict:
    """Every leaf drawn whole, in the reference's order; with ``mesh``
    each rank keeps its block (``placement`` under the active rules)."""
    dev = gen.device
    axes = encoder_logical_axes(n_blocks)

    def ones():
        return torch.ones((d,), dtype=dtype, device=dev)

    def put(t, ax):
        return keep(place(mesh, t.shape, ax), t)

    p = {"item_emb": put(normal(gen, (n_items, d), 0.02, dtype),
                         axes["item_emb"]),
         "pos_emb": normal(gen, (seq_len, d), 0.02, dtype),
         "ln_f": ones()}
    for b in range(n_blocks):
        ax = axes[f"blk{b}"]
        p[f"blk{b}"] = {
            "ln1": ones(), "ln2": ones(),
            **{w: put(normal(gen, (d, d), 0.02, dtype), ax[w])
               for w in ("wq", "wk", "wv", "wo")},
            "w1": put(normal(gen, (d, 4 * d), 0.02, dtype), ax["w1"]),
            "w2": put(normal(gen, (4 * d, d), 0.02, dtype), ax["w2"]),
        }
    return p


class _Split:
    """The ``model`` axes that split a column-parallel weight of global
    shape (d, n) as the rank holds it (none where it is whole), and the
    rank's block index over them."""

    def __init__(self, mesh, w: torch.Tensor, n: int):
        self.mesh, self.axes, self.index = mesh, (), 0
        if mesh is None or w.shape[1] == n:
            return
        sh = placement(mesh, (None, "tensor"), (w.shape[0], n),
                       active_rules())
        if sh.shard_shape((w.shape[0], n))[1] != w.shape[1]:
            raise ValueError(f"a weight of shape {tuple(w.shape)} is neither "
                             f"whole ({w.shape[0]}, {n}) nor this rank's "
                             f"block under {sh.spec!r}")
        self.axes = tuple(a for a in sh.axes() if mesh.shape[a] > 1)
        self.index = sh._index(2)[1]

    def fan_in(self, x: torch.Tensor) -> torch.Tensor:
        """The input of the rank's columns: its gradient summed over them
        (Megatron's f)."""
        return sum_grad(x, self.mesh, self.axes) if self.axes else x

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums summed (Megatron's g)."""
        return reduce_sum(x, self.mesh, self.axes) if self.axes else x


def encode(params: Dict, ids: torch.Tensor, n_blocks: int, n_heads: int,
           causal: bool, pad_mask: torch.Tensor,
           n_items: Optional[int] = None) -> torch.Tensor:
    """ids (B, S) -> hidden (B, S, d).  pad_mask (B, S) True=valid.
    ``n_items``: the catalog's rows, where ``item_emb`` may be a rank's
    block of them."""
    B, S = ids.shape
    mesh = active_mesh()
    item = params["item_emb"]
    d = item.shape[1]
    dh = d // n_heads
    rows = row_window(item, n_items or item.shape[0], row_dim=0)
    h = E.lookup(item, ids, rows) + params["pos_emb"][None, :S]
    attn_mask = pad_mask.bool()[:, None, :].expand(B, S, S)
    if causal:
        ar = torch.arange(S, device=ids.device)
        attn_mask = attn_mask & (ar[None, :, None] >= ar[None, None, :])
    for b in range(n_blocks):
        p = params[f"blk{b}"]
        att, ffn = _Split(mesh, p["wq"], d), _Split(mesh, p["w1"], 4 * d)
        hn = att.fan_in(rms_norm(h, p["ln1"]))
        q, k, v = (hn @ p[w] for w in ("wq", "wk", "wv"))
        cols = q.shape[-1]
        whole = bool(att.axes) and cols % dh != 0
        if whole:       # the rank's columns split a head: every head
            sh = NamedSharding(mesh, P(None, None, att.axes))
            q, k, v = (gather_blocks(x, sh) for x in (q, k, v))
        heads = q.shape[-1] // dh
        a = gqa_attention(*(x.reshape(B, S, heads, dh) for x in (q, k, v)),
                          attn_mask).reshape(B, S, -1)
        if whole:
            a = a[..., att.index * cols:(att.index + 1) * cols]
        h = h + att.rows(a @ p["wo"])
        hn = ffn.fan_in(rms_norm(h, p["ln2"]))
        h = h + ffn.rows(GELU(hn @ p["w1"]) @ p["w2"])
    return rms_norm(h, params["ln_f"])


def placed(params: Dict, batch: int):
    """(``Lanes`` of a call over ``batch`` rows, the leaves as each rank
    uses them)."""
    lanes = Lanes(batch)
    return lanes, lanes.weight(params)


def last_hidden(h: torch.Tensor, pad_mask: torch.Tensor) -> torch.Tensor:
    """Hidden state at each row's last valid position, (B, d): the count of
    valid slots minus one, and -1 (a fully padded row) wraps to the last
    position, as ``jnp.take_along_axis`` does."""
    B, S = pad_mask.shape
    last = wrap_index(pad_mask.long().sum(dim=1) - 1, S)
    return h[torch.arange(B, device=h.device), last]


def catalog_scores(params: Dict, hl: torch.Tensor, cand_ids=None,
                   n_items: Optional[int] = None) -> torch.Tensor:
    """Scores of the last hidden states hl (B, d): against the full catalog
    (B, n_items) when ``cand_ids`` is None, else against each row's
    candidates (B, C).  Over a row split of ``item_emb``: the rank's rows
    of the catalog, gathered over their ranks; the candidates by the
    masked lookup."""
    item = params["item_emb"]
    rows = row_window(item, n_items or item.shape[0], row_dim=0)
    if cand_ids is None:
        scores = hl @ item.T
        if rows is None:
            return scores
        return unshard(scores, NamedSharding(rows.mesh, P(None, rows.axes)))
    cand = E.lookup(item, cand_ids, rows)                      # (B, C, d)
    return torch.einsum("bd,bcd->bc", hl, cand)


def sampled_softmax_nll(h: torch.Tensor, item_emb: torch.Tensor,
                        labels: torch.Tensor, negatives: torch.Tensor,
                        n_items: Optional[int] = None, lanes=None
                        ) -> torch.Tensor:
    """Mean negative log-likelihood of each label (index 0 of [label ⧺
    shared negatives]) over the slots whose label is >= 0; h (B, M, d),
    labels (B, M), negatives (NS,).  Under a mesh (``lanes``, this rank's
    rows) the sums are the ranks' totals."""
    rows = row_window(item_emb, n_items or item_emb.shape[0], row_dim=0)
    pos_emb = E.lookup(item_emb, labels.clamp_min(0), rows)    # (B, M, d)
    neg_emb = E.lookup(item_emb, negatives, rows)
    pos_score = torch.sum(h * pos_emb, dim=-1, keepdim=True)
    neg_score = torch.einsum("bmd,nd->bmn", h, neg_emb)
    scores = torch.cat([pos_score, neg_score], dim=-1)
    logp = torch.log_softmax(scores.float(), dim=-1)
    lm = (labels >= 0).float()
    num, den = torch.sum(logp[..., 0] * lm), lm.sum()
    if lanes is not None and lanes.axes:
        num, den = lanes.total(num), lanes.total(den)
    return -num / den.clamp_min(1.0)


__all__ = ["init_encoder", "encode", "last_hidden", "catalog_scores",
           "sampled_softmax_nll", "encoder_logical_axes", "encoder_shapes",
           "placed"]
