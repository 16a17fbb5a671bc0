"""Mixture-of-Experts FFN (PyTorch port of ``repro.models.moe``).

* ``moe_ref``   — dense all-experts products; exact, O(E·N·D·F).  The path
  a model on one device serves (``moe_impl`` "auto" or "ref"): it has no
  atomics, so its bits do not depend on the order of a launch's threads,
  and each row's result depends on that row alone.
* ``moe_local`` — sort-based dispatch into per-expert capacity blocks,
  per-expert products, weighted combine.  With a capacity factor of at
  least E / top_k nothing is dropped and it equals ``moe_ref`` up to the
  order of f32 sums.  Its capacity couples rows (a row can be dropped
  for another's sake), so one device serves ``moe_ref``.  The combine
  puts each token's k contributions back in (token, slot) order and sums
  them there, not with atomic adds, so its bits are the same run to run
  (the reference adds them with a scatter-add).

* ``moe_ep``    — expert parallelism over a mesh of ``torch.distributed``
  ranks (the reference's ``shard_map``, written out): tokens split over
  every mesh axis, each rank's ``moe_local`` dispatches its tokens into
  capacity blocks for all E experts, an all-to-all over ``model`` moves
  each block to the rank that holds its experts (each rank keeps its E/ep
  experts: ``init_params(mesh=)``), the expert products run there, the
  reverse all-to-all brings the rows back, and the outputs are gathered
  to every rank.  The all-to-all has a gradient (its transpose is another
  all-to-all), and a replicated weight's gradient is summed over the ranks
  that share it.

Routing: softmax → top-k → renormalized top-k weights (Qwen/Mixtral
style), in f32.  Every op here is free of host syncs, so the functions
run inside a captured step.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (Mesh, NamedSharding, P, shard,
                                              sum_grad, unshard)


def router_topk(x: torch.Tensor, w_router: torch.Tensor, top_k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D) -> (weights (N, k) f32 normalized, idx (N, k) int64)."""
    logits = x.float() @ w_router.float()
    gates = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(gates, top_k, dim=-1)
    return w / w.sum(dim=-1, keepdim=True), idx


def moe_ref(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
            w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
            act: Callable = F.silu) -> torch.Tensor:
    """Exact reference: every expert computes every token.  x (N, D)."""
    N = x.shape[0]
    E = w_router.shape[-1]
    w, idx = router_topk(x, w_router, top_k)
    # (N, E): each (n, e) gets at most one of the k weights, so these are
    # the bits of the reference's one-hot einsum
    comb = torch.zeros((N, E), dtype=torch.float32,
                       device=x.device).scatter_(1, idx, w)
    # the reference's "nd,edf->enf" as x broadcast over the experts: a
    # batched product that reads each expert's (D, F) weights in place
    # (torch.einsum would first copy the (E, D, F) weights into (D, E*F))
    g = torch.matmul(x, w_gate)
    u = torch.matmul(x, w_up)
    h = act(g) * u
    y = torch.einsum("enf,efd->end", h, w_down)
    return torch.einsum("ne,end->nd", comb.to(x.dtype), y)


def _dispatch_local(x: torch.Tensor, w: torch.Tensor, idx: torch.Tensor,
                    E: int, capacity: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               torch.Tensor]:
    """Sort-based local dispatch.

    x (n, D); idx/w (n, k).  Returns
      buf (E, C, D)      — tokens grouped per expert (zero-padded / dropped),
      src (n*k,) int64   — source token per sorted element,
      dest (n*k,) int64  — flat destination slot (E*C = dropped),
      wflat (n*k,) f32   — combine weight per sorted element (0 if dropped).
    """
    n, k = idx.shape
    D = x.shape[-1]
    flat_e = idx.reshape(-1)
    flat_w = w.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(E, dtype=sorted_e.dtype, device=x.device
                         ).scatter_add_(0, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, dim=0) - counts
    pos = torch.arange(n * k, device=x.device) - starts[sorted_e]
    keep = pos < capacity
    dest = torch.where(keep,
                       sorted_e * capacity + pos.clamp(0, capacity - 1),
                       E * capacity)
    src = order // k
    buf = torch.zeros((E * capacity + 1, D), dtype=x.dtype, device=x.device)
    buf.index_copy_(0, dest, x[src])     # unique dests (except the drop row)
    buf = buf[:-1].reshape(E, capacity, D)
    wflat = torch.where(keep, flat_w[order], torch.zeros_like(flat_w))
    return buf, src, dest, wflat


def _expert_ffn(buf: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
                w_down: torch.Tensor, act: Callable) -> torch.Tensor:
    """buf (E, C, D) × per-expert weights (E, D, F) -> (E, C, D)."""
    g = torch.einsum("ecd,edf->ecf", buf, w_gate)
    u = torch.einsum("ecd,edf->ecf", buf, w_up)
    return torch.einsum("ecf,efd->ecd", act(g) * u, w_down)


class _AllToAll(torch.autograd.Function):
    """``Mesh.all_to_all`` over ``axes``; with equal chunks its transpose
    is the same all-to-all, so the backward sends the gradient back."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_to_all(x, axes)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_to_all(g.contiguous(), ctx.axes), None, None


def moe_local(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
              capacity_factor: float, act: Callable = F.silu,
              ep_group: Optional[Tuple[Mesh, str]] = None) -> torch.Tensor:
    """MoE through capacity blocks on one device, or on one rank of an
    expert-parallel group.

    ``ep_group`` (mesh, axis): the expert dimension of the weights is this
    rank's block of the axis's ep ranks (E = ep × the local count), and two
    all-to-alls move the capacity blocks to and from the ranks that own
    them.  C comes from the local token count n, as the reference's."""
    n, D = x.shape
    ep = ep_group[0].shape[ep_group[1]] if ep_group is not None else 1
    E = w_gate.shape[0] * ep            # global expert count
    # static per-expert capacity, the reference's formula
    C = max(4, math.ceil(top_k * n / E * capacity_factor))
    C = -(-C // 4) * 4

    rw, ridx = router_topk(x, w_router, top_k)
    buf, src, dest, wflat = _dispatch_local(x, rw, ridx, E, C)
    if ep_group is not None:
        # (E, C, D) -> (E/ep, ep*C, D): each rank keeps its expert slice,
        # receiving that slice's rows from every peer (peer j at rows j*C)
        El = E // ep
        buf = _AllToAll.apply(buf, ep_group[0], (ep_group[1],))
        buf = buf.view(ep, El, C, D).transpose(0, 1).reshape(El, ep * C, D)
    y = _expert_ffn(buf, w_gate, w_up, w_down, act)
    if ep_group is not None:
        y = y.reshape(El, ep, C, D).transpose(0, 1).contiguous()
        y = _AllToAll.apply(y, ep_group[0], (ep_group[1],)).view(E, C, D)
    yflat = torch.cat([y.reshape(E * C, D), y.new_zeros((1, D))], dim=0)
    contrib = yflat[dest] * wflat[:, None].to(y.dtype)
    # sorted element i is token src[i]'s slot order[i] % k: put each back
    # in (token, slot) order and sum the k slots
    order = torch.argsort(ridx.reshape(-1), stable=True)
    per_slot = torch.empty_like(contrib).index_copy_(0, order, contrib)
    return per_slot.view(n, top_k, D).sum(dim=1)


def moe_ep(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
           w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
           capacity_factor: float, mesh: Mesh, act: Callable = F.silu
           ) -> torch.Tensor:
    """Expert-parallel MoE over a (pod?, data, model) mesh.  x (N, D)
    global, the same on every rank; ``w_router`` whole; the expert weights
    this rank's E/ep block along ``model``.

    Tokens are split over every mesh axis (N padded to a multiple of the
    mesh size); experts live on ``model``.  Returns the global (N, D)
    output on every rank."""
    N, D = x.shape
    pad = (-N) % mesh.size
    if pad:
        x = torch.cat([x, x.new_zeros((pad, D))], dim=0)
    dp_axes = tuple(a for a in ("pod", "data", "model") if a in mesh.shape)
    tokens = NamedSharding(mesh, P(dp_axes, None))
    others = tuple(a for a in mesh.axis_names if a != "model")
    wg, wu, wd = (sum_grad(w, mesh, others) for w in (w_gate, w_up, w_down))
    out = moe_local(shard(x, tokens), sum_grad(w_router, mesh, dp_axes), wg,
                    wu, wd, top_k, capacity_factor, act,
                    ep_group=(mesh, "model"))
    out = unshard(out, tokens)
    return out[:N] if pad else out


__all__ = ["router_topk", "moe_ref", "moe_local", "moe_ep"]
