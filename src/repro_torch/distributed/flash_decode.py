"""Sequence-parallel tree-decode attention, flash-decoding style (PyTorch
port of ``repro.distributed.flash_decode``).

Axis assignment is derived from the global shapes:

  * batch → (pod, data) when divisible (decode_32k: B=128);
  * KV heads / Q heads → model when divisible (phi3-mini K=32, moonshot 16);
  * otherwise the KV **sequence** absorbs the leftover axes — batch=1
    long-context decode shards S over (pod, data[, model]), and GQA archs
    whose K doesn't divide TP=16 (qwen2 K=2, phi3-medium K=10, qwen3 K=4)
    shard S over model.  Partial attention per shard is combined with the
    numerically-stable log-sum-exp trick:

      M = max(m_l);  S = sum(e^{m_l-M} s_l);  O = sum(e^{m_l-M} o_l)

    one ``all_reduce(MAX)`` and one ``all_reduce(SUM)`` of (s, o) packed
    together over the sequence axes' group, independent of S.

The reference's ``shard_map`` is written out: each rank holds its block of
the (L, B, S, K, dh) cache (``cache_partition_spec``), takes its batch and
head block of q, k_new and v_new, attends locally in f32 as the reference
does, and the outputs are gathered over the batch and head axes, so the
layer's activations stay replicated.  The local attention is the
reference's einsum, not a kernel: plain torch.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch

from repro_torch.distributed.sharding import (Mesh, NamedSharding, P,
                                              active_mesh)

NEG_INF = -1e30     # models.layers.NEG_INF; importing models here would cycle


def _derive_axes(mesh: Mesh, B: int, S: int, K: int, H: int):
    """Returns (batch_axes, seq_axes, head_axis)."""
    dp_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    dp = 1
    for a in dp_axes:
        dp *= mesh.shape[a]
    tp = mesh.shape.get("model", 1)
    heads_ok = tp > 1 and K % tp == 0 and H % tp == 0
    if dp > 1 and B % dp == 0 and B >= dp:
        batch_axes, seq_dp = dp_axes, ()
    else:
        batch_axes, seq_dp = (), dp_axes
    seq_axes = tuple(seq_dp)
    if not heads_ok and tp > 1:
        seq_axes = seq_axes + ("model",)
    # drop seq sharding if not divisible
    nseq = 1
    for a in seq_axes:
        nseq *= mesh.shape[a]
    if nseq <= 1 or S % nseq != 0:
        seq_axes = ()
    head_ax = "model" if heads_ok else None
    return batch_axes, seq_axes, head_ax


def cache_partition_spec(mesh: Mesh, B: int, S: int, K: int, H: int) -> P:
    """PartitionSpec for a (L, B, S, K, dh) cache consistent with attend."""
    batch_axes, seq_axes, h_ax = _derive_axes(mesh, B, S, K, H)
    return P(None, batch_axes if batch_axes else None,
             seq_axes if seq_axes else None, h_ax, None)


def seq_offset(mesh: Mesh, seq_axes: Tuple[str, ...], Sl: int) -> int:
    """Global row of this rank's first local KV row."""
    idx = 0
    for a in seq_axes:
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    return idx * Sl


def write_rows(buf: torch.Tensor, start: torch.Tensor, new: torch.Tensor,
               lead: int = 0) -> None:
    """Write ``new[..., b, t]`` at local row ``start[b] + t`` of
    ``buf[..., b, :]`` in place, dropping rows outside [0, Sl) — the
    reference's ``.at[...].set(..., mode="drop")`` after it redirects
    negative rows to Sl (torch indexing, too, would wrap them).

    ``buf`` (*lead, Bl, Sl, ...), ``new`` (*lead, Bl, T, ...), ``start``
    (Bl,).  Without a host sync: every slot writes the clamped row
    ``clamp(start + t, 0, Sl-1)`` and the value that row must end with —
    the new row of the slot that lands there, else the row's old value —
    so the slots that collide write the same bits."""
    Bl, Sl = buf.shape[lead], buf.shape[lead + 1]
    T = new.shape[lead + 1]
    dev = buf.device
    t = torch.arange(T, device=dev)
    start = start.long()[:, None]
    row = (start + t).clamp(0, Sl - 1)                             # (Bl, T)
    own = row - start               # the slot whose row this is, if < T
    owned = (own >= 0) & (own < T)
    bidx = torch.arange(Bl, device=dev)[:, None]
    pre = (slice(None),) * lead
    fresh = new[pre + (bidx, own.clamp(0, T - 1))]
    old = buf[pre + (bidx, row)]
    keep = owned.reshape(owned.shape + (1,) * (fresh.dim() - lead - 2))
    buf[pre + (bidx, row)] = torch.where(keep, fresh.to(buf.dtype), old)


def make_flash_attend(mesh: Mesh, cache_lens: torch.Tensor,
                      tree_mask: torch.Tensor, S: int,
                      score_f32: bool = True) -> Callable:
    """Returns attend(q, k_new, v_new, k_cache, v_cache) -> attn_out over
    this rank's (B_l, S_l, K_l, dh) cache blocks of a global (B, S, K, dh)
    cache, written in place; q, k_new, v_new, cache_lens, tree_mask and
    the output are global (replicated)."""

    def attend(q: torch.Tensor, k_new: torch.Tensor, v_new: torch.Tensor,
               k_cache: torch.Tensor, v_cache: torch.Tensor) -> torch.Tensor:
        B, T, H, dh = q.shape
        K = k_new.shape[2]
        batch_axes, seq_axes, h_ax = _derive_axes(mesh, B, S, K, H)
        ba = batch_axes if batch_axes else None
        sa = seq_axes if seq_axes else None
        act = NamedSharding(mesh, P(ba, None, h_ax, None))
        want = NamedSharding(mesh, P(ba, sa, h_ax, None)).shard_shape(
            (B, S, K, dh))
        if tuple(k_cache.shape) != want:
            raise ValueError(f"flash decode: cache block {tuple(k_cache.shape)}"
                             f" is not this rank's {want} of ({B}, {S}, {K}, "
                             f"{dh}) (init_cache under the mesh makes it)")
        out = _local_attend(
            act.local(q), act.local(k_new), act.local(v_new), k_cache,
            v_cache, NamedSharding(mesh, P(ba)).local(cache_lens),
            NamedSharding(mesh, P(ba, None, None)).local(tree_mask),
            mesh=mesh, seq_axes=seq_axes, T=T, scale=dh ** -0.5,
            score_f32=score_f32)
        return act.gather(out)

    return attend


def _local_attend(q, k_new, v_new, k_c, v_c, cache_lens, tree_mask, *,
                  mesh: Mesh, seq_axes: Tuple[str, ...], T: int, scale: float,
                  score_f32: bool = True) -> torch.Tensor:
    B, _, Hl, dh = q.shape
    Sl, Kl = k_c.shape[1], k_c.shape[2]
    G = Hl // Kl
    dev = q.device
    offset = seq_offset(mesh, seq_axes, Sl)
    lens = cache_lens.long()

    # scatter the new draft KV rows that land in this shard
    write_rows(k_c, lens - offset, k_new)
    write_rows(v_c, lens - offset, v_new)

    # mask over local rows
    jglob = offset + torch.arange(Sl, device=dev)
    past = jglob[None, None, :] < lens[:, None, None]
    rel = jglob[None, None, :] - lens[:, None, None]                # (B,1,Sl)
    relc = rel.clamp(0, T - 1).expand(B, T, Sl)
    tm = tree_mask.bool().gather(2, relc)
    mask = past | ((rel >= 0) & (rel < T) & tm)                     # (B,T,Sl)

    qg = q.reshape(B, T, Kl, G, dh)
    if score_f32:
        s = torch.einsum("btkgh,bskh->bkgts", qg.float(), k_c.float())
    else:
        s = torch.einsum("btkgh,bskh->bkgts", qg, k_c).float()
    s = s * scale
    s = torch.where(mask[:, None, None], s, torch.full_like(s, NEG_INF))
    m_l = s.amax(dim=-1).clamp_min(-1e30)                           # (B,K,G,T)
    p = torch.where(mask[:, None, None], torch.exp(s - m_l[..., None]),
                    torch.zeros_like(s))
    del s
    s_l = p.sum(dim=-1)
    o_l = torch.einsum("bkgts,bskh->bkgth", p.to(v_c.dtype), v_c).float()
    if seq_axes:
        M = mesh.all_reduce(m_l, "max", seq_axes)
        c = torch.exp(m_l - M)
        both = mesh.all_reduce(
            torch.cat([(s_l * c)[..., None], o_l * c[..., None]], dim=-1),
            "sum", seq_axes)
        s_g, o_g = both[..., 0], both[..., 1:]
    else:
        s_g, o_g = s_l, o_l
    out = o_g / s_g[..., None].clamp_min(1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, T, Hl, dh)
    return out.to(q.dtype)


class FlashDecodeBackend:
    """Attention backend (registry name ``flash_decode``) wrapping the
    sequence-parallel decode above.

    Prefill is the dense reference math; the decode phase takes the
    sharded path whenever a mesh is active and is the dense backend
    otherwise — identical semantics.  The paged pool is lane-agnostic, so
    the paged path is dense paged, as the reference's is.  Imports of the
    registry module are deferred to call time (``models/attention.py``
    imports this module to register the backend)."""

    name = "flash_decode"

    def prefill_attention(self, cfg, q, k, v, positions, len_mask):
        from repro_torch.models.attention import dense_prefill_attention
        return dense_prefill_attention(cfg, q, k, v, positions, len_mask)

    def make_tree_attend(self, cfg, cache_lens, tree_mask, S_max):
        """``S_max`` is the local cache's length; under a mesh the global
        one is ``cfg.max_seq_len``, which ``init_cache`` allocates."""
        from repro_torch.models.attention import get_backend
        mesh = active_mesh()
        if mesh is None:
            return get_backend("dense").make_tree_attend(cfg, cache_lens,
                                                         tree_mask, S_max)
        return make_flash_attend(mesh, cache_lens, tree_mask,
                                 cfg.max_seq_len,
                                 score_f32=cfg.attn_score_f32)

    def make_paged_tree_attend(self, cfg, block_tables, cache_lens,
                               tree_mask, slot_valid=None):
        from repro_torch.models.attention import get_backend
        return get_backend("dense").make_paged_tree_attend(
            cfg, block_tables, cache_lens, tree_mask, slot_valid)


__all__ = ["make_flash_attend", "cache_partition_spec", "FlashDecodeBackend",
           "write_rows", "seq_offset"]
