"""Radix-tree prefix cache over the paged KV block pool.

Maps token prefixes to resident KV blocks so a request whose prompt prefix
was already prefilled by an earlier request skips that portion of prefill
(SGLang-style RadixAttention on a vLLM-style paged pool).

Structure
---------
One tree per namespace (composing with ``TrieForest`` scenario scoping: the
``DraftPolicy.namespace`` that isolates draft tries also isolates prefix
reuse, so co-resident tenants never share KV).  Each node covers exactly one
KV block: its ``key`` is the token chunk written into that block (full
``block_size`` tokens for interior nodes, possibly fewer for a leaf holding
a partially-filled boundary block).  Children are keyed by their first
token; a parent chain of full nodes spells out a block-aligned prefix.

Ownership
---------
The cache holds exactly one allocator reference per resident block
(``BlockAllocator.cache_ref``).  Blocks shared into a live request's table
additionally carry that request's reference, so LRU eviction of a node can
never free KV a live request still attends (the refcount just drops).
Eviction only touches *leaves* with ``lock == 0`` — ``lookup`` pins every
matched node so an admission-triggered eviction pass cannot evict the very
blocks it is about to share.

Lookup semantics
----------------
``lookup`` walks full-block exact matches, then inspects one more child for
a partially-matching boundary block: if the child's key and the remaining
prompt share a non-empty common prefix, the child's block is returned as a
copy-on-write fork source (the request copies it into a fresh block of its
own and overwrites rows past the match).  The total match is capped at
``len(tokens) - 1`` — at least one real token must run through prefill to
produce next-token logits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .block_allocator import BlockAllocator


class _Node:
    __slots__ = ("key", "block", "children", "parent", "last_access", "lock")

    def __init__(self, key: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]):
        self.key = key
        self.block = block
        self.children: Dict[int, "_Node"] = {}
        self.parent = parent
        self.last_access = 0
        self.lock = 0


@dataclass
class PrefixMatch:
    """Result of a cache lookup.

    ``blocks``: full shared blocks covering ``len(blocks) * block_size``
    prompt tokens (adopt via ``BlockAllocator.alloc(shared=...)``).
    ``cow_block``/``cow_tokens``: optional partially-matched boundary block
    to fork (device copy) plus how many of its rows are valid prompt KV.
    ``nodes``: the matched (and pinned) tree nodes — release with
    ``PrefixCache.unpin`` once the blocks are adopted or the admission is
    abandoned.
    """
    blocks: List[int] = field(default_factory=list)
    cow_block: Optional[int] = None
    cow_tokens: int = 0
    nodes: List[_Node] = field(default_factory=list)
    n_tokens: int = 0


@dataclass
class PrefixCacheStats:
    lookups: int = 0
    hits: int = 0              # lookups matching >= 1 token
    hit_tokens: int = 0        # prompt tokens served from cache (== prefill saved)
    lookup_tokens: int = 0     # prompt tokens presented to lookup
    inserts: int = 0
    inserted_blocks: int = 0   # novel blocks adopted by the tree
    evicted_blocks: int = 0
    cow_forks: int = 0

    @property
    def hit_rate(self) -> float:
        return self.hits / max(self.lookups, 1)

    @property
    def token_hit_rate(self) -> float:
        return self.hit_tokens / max(self.lookup_tokens, 1)


class PrefixCache:
    """Namespace-scoped radix tree of resident prompt-prefix KV blocks."""

    def __init__(self, allocator: BlockAllocator, *,
                 max_blocks: Optional[int] = None):
        self.allocator = allocator
        self.block_size = allocator.block_size
        # None = bounded only by pool pressure (admission-driven eviction).
        self.max_blocks = max_blocks
        self._roots: Dict[str, _Node] = {}
        self._tick = 0
        self.n_blocks = 0          # blocks the cache holds a reference on
        self.stats = PrefixCacheStats()

    # ------------------------------------------------------------------ utils
    def _root(self, namespace: str) -> _Node:
        root = self._roots.get(namespace)
        if root is None:
            root = _Node((), -1, None)
            self._roots[namespace] = root
        return root

    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.last_access = self._tick

    @staticmethod
    def _lcp(a: Sequence[int], b: Sequence[int]) -> int:
        n = 0
        for x, y in zip(a, b):
            if x != y:
                break
            n += 1
        return n

    # ----------------------------------------------------------------- lookup
    def lookup(self, tokens: Sequence[int],
               namespace: str = "") -> PrefixMatch:
        """Match the longest cached prefix of ``tokens`` (capped one short
        of the full prompt).  Matched nodes are pinned against eviction —
        call ``unpin(match)`` after adopting the blocks."""
        tokens = [int(t) for t in tokens]
        bs = self.block_size
        self.stats.lookups += 1
        self.stats.lookup_tokens += len(tokens)
        match = PrefixMatch()
        node = self._root(namespace)
        i = 0
        cap = len(tokens) - 1  # leave >= 1 token to prefill for logits
        while i + bs <= cap:
            child = node.children.get(tokens[i])
            if child is None or len(child.key) != bs or \
                    tuple(tokens[i:i + bs]) != child.key:
                break
            node = child
            node.lock += 1
            self._touch(node)
            match.nodes.append(node)
            match.blocks.append(node.block)
            i += bs
        # Boundary: one more child may cover part of the remaining tokens —
        # either a partial leaf, or a full block we cannot consume whole
        # (divergence mid-block, or the cap).  Fork it copy-on-write.
        if i <= cap:
            child = node.children.get(tokens[i])
            if child is not None:
                p = self._lcp(child.key, tokens[i:i + len(child.key)])
                p = min(p, cap - i)
                if p > 0:
                    child.lock += 1
                    self._touch(child)
                    match.nodes.append(child)
                    match.cow_block = child.block
                    match.cow_tokens = p
        match.n_tokens = len(match.blocks) * bs + match.cow_tokens
        if match.n_tokens > 0:
            self.stats.hits += 1
            self.stats.hit_tokens += match.n_tokens
        return match

    def unpin(self, match: PrefixMatch) -> None:
        """Release the eviction pins taken by ``lookup``."""
        for node in match.nodes:
            assert node.lock > 0
            node.lock -= 1
        match.nodes = []

    # ----------------------------------------------------------------- insert
    def insert(self, tokens: Sequence[int], blocks: Sequence[int],
               namespace: str = "") -> List[int]:
        """Promote a retiring request's prompt into the tree.  ``blocks`` is
        the request's block table covering at least ``tokens`` (extra tail
        entries ignored).  Novel blocks are adopted by ``cache_ref`` —
        sharing them with the (still-live) request until its ``free`` drops
        its own reference.  Dedup keeps the tree's existing block where the
        path already exists; a partial leaf whose key is a prefix of ours
        is *upgraded* in place to our fuller block.  Divergence inside a
        partial block cannot be represented (one block, two token chunks),
        so insertion stops there.  Returns blocks freed by upgrades or by
        the post-insert capacity trim (caller must scrub them)."""
        tokens = [int(t) for t in tokens]
        bs = self.block_size
        self.stats.inserts += 1
        freed: List[int] = []
        node = self._root(namespace)
        i = 0
        while i < len(tokens):
            chunk = tuple(tokens[i:i + bs])
            blk = int(blocks[i // bs])
            child = node.children.get(chunk[0])
            if child is None:
                child = _Node(chunk, blk, node)
                self.allocator.cache_ref([blk])
                self.n_blocks += 1
                self.stats.inserted_blocks += 1
                node.children[chunk[0]] = child
                self._touch(child)
                node = child
            elif child.key == chunk:
                self._touch(child)          # dedup: keep the tree's block
                node = child
            elif len(child.key) < len(chunk) and \
                    chunk[:len(child.key)] == child.key and not child.children:
                # Upgrade a shorter partial leaf to our fuller block.  Any
                # live sharer of the old block keeps its own reference.
                freed.extend(self.allocator.cache_unref([child.block]))
                self.allocator.cache_ref([blk])
                self.stats.inserted_blocks += 1
                del node.children[child.key[0]]
                child.key, child.block = chunk, blk
                node.children[chunk[0]] = child
                self._touch(child)
                node = child
            else:
                break  # intra-block divergence (or longer existing partial)
            i += bs
        freed.extend(self._trim())
        return freed

    # --------------------------------------------------------------- eviction
    def _leaves(self) -> List[_Node]:
        out = []
        stack = list(self._roots.values())
        while stack:
            n = stack.pop()
            kids = list(n.children.values())
            stack.extend(kids)
            if not kids and n.parent is not None:
                out.append(n)
        return out

    def _evict_node(self, node: _Node) -> List[int]:
        assert node.lock == 0 and not node.children
        del node.parent.children[node.key[0]]
        self.n_blocks -= 1
        freed = self.allocator.cache_unref([node.block])
        self.stats.evicted_blocks += 1
        return freed

    def evict(self, n_needed: int) -> List[int]:
        """LRU-evict unlocked leaves until the allocator can hand out
        ``n_needed`` more reservation blocks (or nothing evictable is
        left).  Returns freed block ids for the caller to scrub."""
        freed: List[int] = []
        while self.allocator.available < n_needed:
            victims = [n for n in self._leaves() if n.lock == 0]
            if not victims:
                break
            freed.extend(self._evict_node(
                min(victims, key=lambda n: n.last_access)))
        return freed

    def _trim(self) -> List[int]:
        """Enforce the ``max_blocks`` cap after an insert."""
        freed: List[int] = []
        while self.max_blocks is not None and self.n_blocks > self.max_blocks:
            victims = [n for n in self._leaves() if n.lock == 0]
            if not victims:
                break
            freed.extend(self._evict_node(
                min(victims, key=lambda n: n.last_access)))
        return freed

    # ------------------------------------------------------------- warm state
    def hot_keys(self, max_keys: Optional[int] = None
                 ) -> Dict[str, List[List[int]]]:
        """Hottest resident prefix token-chains per namespace, most recently
        used first (``max_keys`` caps each namespace's list).

        Warm-state persistence (repro.fleet) serializes KEYS only: the KV
        blocks behind them are device-resident and cannot survive a restart.
        A warm-restarted engine re-prefills each key once (priming requests)
        and the retire-time insert repopulates the tree through the regular
        machinery — recovering hit rate without trusting foreign KV bytes.
        """
        out: Dict[str, List[List[int]]] = {}
        for ns, root in self._roots.items():
            chains: List[Tuple[int, List[int]]] = []
            stack: List[Tuple[_Node, List[int]]] = [
                (ch, list(ch.key)) for ch in root.children.values()]
            while stack:
                node, toks = stack.pop()
                kids = list(node.children.values())
                if not kids:
                    chains.append((node.last_access, toks))
                    continue
                stack.extend((ch, toks + list(ch.key)) for ch in kids)
            chains.sort(key=lambda c: -c[0])
            if max_keys is not None:
                chains = chains[:max_keys]
            if chains:
                out[ns] = [toks for _, toks in chains]
        return out

    def clear(self) -> List[int]:
        """Drop every cached prefix (all namespaces); returns freed ids.
        Post-order: repeatedly strip unlocked leaves."""
        freed: List[int] = []
        while True:
            victims = [n for n in self._leaves() if n.lock == 0]
            if not victims:
                break
            for v in victims:
                freed.extend(self._evict_node(v))
        return freed


__all__ = ["PrefixCache", "PrefixMatch", "PrefixCacheStats"]
