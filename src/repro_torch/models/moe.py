"""Mixture-of-Experts FFN (PyTorch port of ``repro.models.moe``).

* ``moe_ref``   — dense all-experts products; exact, O(E·N·D·F).  The path
  a model on one device serves (``moe_impl`` "auto" or "ref"): it has no
  atomics, so its bits do not depend on the order of a launch's threads,
  and each row's result depends on that row alone.
* ``moe_local`` — sort-based dispatch into per-expert capacity blocks,
  per-expert products, weighted combine.  With a capacity factor of at
  least E / top_k nothing is dropped and it equals ``moe_ref`` up to the
  order of f32 sums.  Its capacity couples rows (a row can be dropped
  for another's sake) and its combine adds with ``index_add_``, so it is
  held as a module and not served.

The reference's expert-parallel ``moe_ep`` (a ``shard_map`` over a mesh
with two all-to-alls) waits for the port's multi-GPU item, ROADMAP A16.

Routing: softmax → top-k → renormalized top-k weights (Qwen/Mixtral
style), in f32.  Every op here is free of host syncs, so the functions
run inside a captured step.
"""
from __future__ import annotations

import math
from typing import Callable, Tuple

import torch
import torch.nn.functional as F


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


def moe_local(x: torch.Tensor, w_router: torch.Tensor, w_gate: torch.Tensor,
              w_up: torch.Tensor, w_down: torch.Tensor, top_k: int,
              capacity_factor: float, act: Callable = F.silu
              ) -> torch.Tensor:
    """Single-device MoE through capacity blocks (the reference's
    ``moe_local`` without ``ep_axis``)."""
    n, D = x.shape
    E = w_gate.shape[0]
    # static per-expert capacity, the reference's formula
    C = max(4, math.ceil(top_k * n / E * capacity_factor))
    C = -(-C // 4) * 4

    rw, ridx = router_topk(x, w_router, top_k)
    buf, src, dest, wflat = _dispatch_local(x, rw, ridx, E, C)
    y = _expert_ffn(buf, w_gate, w_up, w_down, act)
    yflat = torch.cat([y.reshape(E * C, D), y.new_zeros((1, D))], dim=0)
    contrib = yflat[dest] * wflat[:, None].to(y.dtype)
    return torch.zeros_like(x).index_add_(0, src, contrib)


__all__ = ["router_topk", "moe_ref", "moe_local"]
