"""Hierarchical / parallel / single-branch draft construction (paper §4.2).

Converts retrieved trie branches into the fixed-shape tensors a jitted
tree-decode step consumes:

  slot 0                : the last committed token (the "root"),
  slots 1..decoding_len : draft tokens arranged as a tree,
  parent[i]             : slot index of i's parent (root's parent = -1),
  depth[i]              : tree depth (0 for root) → position_id offset,
  tree_mask[i, j]       : 1 iff j is an ancestor of i or j == i.

Three strategies (paper Figure 2/3):
  * hierarchical — shared prefixes merged (one trie node = one slot),
  * parallel     — branches laid out independently (no prefix sharing),
  * single       — one branch only (LLMA-style baseline).

All outputs are padded to a fixed ``1 + decoding_length`` so the device step
compiles once.  Padded slots have ``parent = 0``, ``token = pad_id``, mask =
self+root only, and are never matched during verification (they are excluded
via ``n_slots``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@dataclass
class DraftTree:
    """Host-side draft tree, ready to be shipped to the device step."""
    tokens: np.ndarray      # (T,) int32  — slot 0 = root token
    parent: np.ndarray      # (T,) int32  — -1 for root, else parent slot
    depth: np.ndarray       # (T,) int32  — 0 for root
    tree_mask: np.ndarray   # (T, T) bool — ancestor-closure (incl. self)
    n_slots: int            # live slots (<= T), root included
    children: List[List[int]]  # adjacency (host verification walk)
    # provenance: the draft-source name that contributed each slot (None for
    # the root and padded slots).  Host-side only — never shipped to the
    # device — and feeds the per-source acceptance telemetry.
    slot_source: List[Optional[str]] = None

    @property
    def size(self) -> int:
        return int(self.tokens.shape[0])


def _finalize(tokens: List[int], parent: List[int], total: int,
              pad_id: int, slot_src: Optional[List[Optional[str]]] = None
              ) -> DraftTree:
    n = len(tokens)
    assert n >= 1 and n <= total, (n, total)
    tok = np.full((total,), pad_id, dtype=np.int32)
    par = np.zeros((total,), dtype=np.int32)
    tok[:n] = np.asarray(tokens, dtype=np.int32)
    par[:n] = np.asarray(parent, dtype=np.int32)
    par[0] = -1
    depth = np.zeros((total,), dtype=np.int32)
    for i in range(1, n):
        depth[i] = depth[par[i]] + 1
    # padded slots: children of root at depth 1 (harmless, never verified)
    depth[n:] = 1
    mask = np.zeros((total, total), dtype=bool)
    for i in range(total):
        mask[i, i] = True
        j = par[i] if i < n else 0
        while j >= 0:
            mask[i, j] = True
            j = par[j] if j > 0 else -1
    children: List[List[int]] = [[] for _ in range(total)]
    for i in range(1, n):
        children[par[i]].append(i)
    src_full: List[Optional[str]] = [None] * total
    if slot_src is not None:
        for i in range(min(len(slot_src), n)):
            src_full[i] = slot_src[i]
    return DraftTree(tokens=tok, parent=par, depth=depth, tree_mask=mask,
                     n_slots=n, children=children, slot_source=src_full)


def build_hierarchical(root_token: int, branches: Sequence[Sequence[int]],
                       scores: Optional[Sequence[float]],
                       decoding_length: int, pad_id: int = 0, *,
                       sources: Optional[Sequence[Optional[str]]] = None
                       ) -> DraftTree:
    """Merge shared prefixes: one slot per distinct trie node (paper §4.2.2).

    ``branches`` are root-paths from retrieval (may be prefixes of each
    other); insertion order respects ``scores`` (already sorted by retrieval).
    Token budget: at most ``decoding_length`` draft slots beyond the root.
    ``sources`` optionally names the draft source of each branch; a shared
    slot keeps the first contributor (merge order = priority).
    """
    total = 1 + decoding_length
    tokens: List[int] = [int(root_token)]
    parent: List[int] = [-1]
    srcs: List[Optional[str]] = [None]
    # map path-prefix -> slot
    slot_of: Dict[Tuple[int, ...], int] = {(): 0}
    order = range(len(branches))
    for bi in order:
        path = tuple(int(t) for t in branches[bi])
        tag = sources[bi] if sources is not None else None
        for d in range(len(path)):
            key = path[:d + 1]
            if key in slot_of:
                continue
            if len(tokens) >= total:
                break
            parent_slot = slot_of.get(key[:-1])
            if parent_slot is None:
                break  # budget cut the prefix earlier; skip the tail
            slot_of[key] = len(tokens)
            tokens.append(key[-1])
            parent.append(parent_slot)
            srcs.append(tag)
        if len(tokens) >= total:
            break
    return _finalize(tokens, parent, total, pad_id, slot_src=srcs)


def build_parallel(root_token: int, branches: Sequence[Sequence[int]],
                   scores: Optional[Sequence[float]],
                   decoding_length: int, pad_id: int = 0, *,
                   sources: Optional[Sequence[Optional[str]]] = None
                   ) -> DraftTree:
    """Parallel multi-branch: no prefix merging (paper §4.2.1).

    Branch lists coming from trie retrieval include every prefix path; keep
    only maximal paths so parallel layout does not duplicate pure prefixes.
    """
    total = 1 + decoding_length
    paths = [tuple(int(t) for t in b) for b in branches]
    src_of: Dict[Tuple[int, ...], Optional[str]] = {}
    if sources is not None:
        for p, s in zip(paths, sources):
            src_of.setdefault(p, s)
    maximal = _maximal_paths(paths)
    tokens: List[int] = [int(root_token)]
    parent: List[int] = [-1]
    srcs: List[Optional[str]] = [None]
    for path in maximal:
        tag = src_of.get(path)
        if len(tokens) + len(path) > total:
            path = path[: max(0, total - len(tokens))]
        prev = 0
        for t in path:
            tokens.append(t)
            parent.append(prev)
            srcs.append(tag)
            prev = len(tokens) - 1
        if len(tokens) >= total:
            break
    return _finalize(tokens, parent, total, pad_id, slot_src=srcs)


def build_single(root_token: int, branches: Sequence[Sequence[int]],
                 scores: Optional[Sequence[float]],
                 decoding_length: int, pad_id: int = 0, *,
                 sources: Optional[Sequence[Optional[str]]] = None
                 ) -> DraftTree:
    """Single-branch (LLMA-style): longest/highest-score single chain."""
    total = 1 + decoding_length
    all_paths = [tuple(int(t) for t in b) for b in branches]
    paths = _maximal_paths(all_paths)
    tokens: List[int] = [int(root_token)]
    parent: List[int] = [-1]
    srcs: List[Optional[str]] = [None]
    if paths:
        best = paths[0]
        tag = None
        if sources is not None:
            for p, s in zip(all_paths, sources):
                if p == best:
                    tag = s
                    break
        for i, t in enumerate(best[:decoding_length]):
            tokens.append(t)
            parent.append(i)  # chain: slot i+1's parent is slot i
            srcs.append(tag)
    return _finalize(tokens, parent, total, pad_id, slot_src=srcs)


def repad(tree: DraftTree, total: int, pad_id: int = 0) -> DraftTree:
    """Re-pad a draft tree to exactly ``total`` slots (fixed device shapes).

    The serving loops compile their tree step for one width T; a config whose
    ``decoding_length`` is smaller than the compiled width just carries extra
    padded slots (never verified, mask = self+root only).
    """
    if tree.size == total:
        return tree
    n = min(tree.n_slots, total)
    src = tree.slot_source[:n] if tree.slot_source is not None else None
    return _finalize(list(tree.tokens[:n]), list(tree.parent[:n]), total,
                     pad_id, slot_src=src)


def _maximal_paths(paths: Sequence[Tuple[int, ...]]) -> List[Tuple[int, ...]]:
    """Drop paths that are proper prefixes of another path; keep input order.

    Prefix-set walk: one pass collects every proper prefix of every path,
    a second keeps the paths absent from that set — O(total tokens) hash
    work instead of the all-pairs O(n²·len) scan (this runs per lane per
    decode step on the host hot path of both serving loops)."""
    prefixes = set()
    for p in paths:
        for d in range(1, len(p)):
            prefixes.add(p[:d])
    out: List[Tuple[int, ...]] = []
    seen = set()
    for p in paths:
        if p and p not in seen and p not in prefixes:
            seen.add(p)
            out.append(p)
    return out


BUILDERS = {
    "hierarchical": build_hierarchical,
    "parallel": build_parallel,
    "single": build_single,
}

__all__ = ["DraftTree", "build_hierarchical", "build_parallel",
           "build_single", "repad", "BUILDERS"]
