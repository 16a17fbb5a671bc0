"""Fanout neighbor sampler (GraphSAGE-style) — real sampler, host-side numpy
(port-local copy of ``repro.models.gnn.sampler``: the same ``RandomState``
gives the reference's arrays bit for bit).

Builds a CSR adjacency once, then samples k-hop neighborhoods with per-hop
fanouts and emits a padded subgraph (fixed shapes for jit): node list,
re-indexed edges, edge mask, and the seed positions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


@dataclass
class CSRGraph:
    indptr: np.ndarray    # (N+1,)
    indices: np.ndarray   # (E,) neighbor ids (incoming edges: col indices)
    n_nodes: int

    @staticmethod
    def from_edges(edges: np.ndarray, n_nodes: int) -> "CSRGraph":
        """edges (E, 2) [src, dst] -> CSR over dst (incoming neighbors)."""
        order = np.argsort(edges[:, 1], kind="stable")
        src = edges[order, 0].astype(np.int64)
        dst = edges[order, 1].astype(np.int64)
        counts = np.bincount(dst, minlength=n_nodes)
        indptr = np.zeros(n_nodes + 1, np.int64)
        np.cumsum(counts, out=indptr[1:])
        return CSRGraph(indptr=indptr, indices=src, n_nodes=n_nodes)


def sample_subgraph(g: CSRGraph, seeds: np.ndarray, fanouts: Sequence[int],
                    rng: np.random.RandomState,
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sample a fanout neighborhood.

    Returns (nodes, edges, edge_mask, seed_slots):
      nodes (M,)            — global node ids (padded with 0),
      edges (Epad, 2) int32 — LOCAL indices into ``nodes`` [src, dst],
      edge_mask (Epad,)     — False on padding,
      seed_slots (B,)       — local positions of the seeds.
    Fixed output sizes: M = B·Π(1+fanout terms) upper bound; Epad = B·Σ…
    """
    B = len(seeds)
    frontier = np.asarray(seeds, np.int64)
    all_nodes: List[np.ndarray] = [frontier]
    all_edges: List[np.ndarray] = []
    for f in fanouts:
        srcs, dsts = [], []
        for v in frontier:
            lo, hi = g.indptr[v], g.indptr[v + 1]
            deg = hi - lo
            if deg == 0:
                continue
            pick = g.indices[lo + rng.randint(0, deg, size=f)]
            srcs.append(pick)
            dsts.append(np.full(f, v, np.int64))
        if srcs:
            e = np.stack([np.concatenate(srcs), np.concatenate(dsts)], axis=1)
            all_edges.append(e)
            frontier = np.unique(np.concatenate(srcs))
            all_nodes.append(frontier)
        else:
            frontier = np.zeros((0,), np.int64)

    nodes = np.unique(np.concatenate(all_nodes)) if all_nodes else frontier
    local = {int(v): i for i, v in enumerate(nodes)}
    # fixed-size caps
    max_nodes = _cap_nodes(B, fanouts)
    max_edges = _cap_edges(B, fanouts)
    nodes_pad = np.zeros(max_nodes, np.int64)
    nodes_pad[:len(nodes)] = nodes
    if all_edges:
        e = np.concatenate(all_edges, axis=0)
        e_local = np.stack([[local[int(s)] for s in e[:, 0]],
                            [local[int(d)] for d in e[:, 1]]], axis=1)
    else:
        e_local = np.zeros((0, 2), np.int64)
    e_pad = np.zeros((max_edges, 2), np.int32)
    mask = np.zeros(max_edges, bool)
    n_e = min(len(e_local), max_edges)
    e_pad[:n_e] = e_local[:n_e]
    mask[:n_e] = True
    seed_slots = np.array([local[int(s)] for s in seeds], np.int32)
    return nodes_pad, e_pad, mask, seed_slots


def _cap_nodes(B: int, fanouts: Sequence[int]) -> int:
    n, layer = B, B
    for f in fanouts:
        layer = layer * f
        n += layer
    return n


def _cap_edges(B: int, fanouts: Sequence[int]) -> int:
    e, layer = 0, B
    for f in fanouts:
        e += layer * f
        layer = layer * f
    return e


__all__ = ["CSRGraph", "sample_subgraph"]
