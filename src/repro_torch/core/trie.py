"""Trie tree for lossless draft retrieval (paper §4.3).

The trie records n-grams of prompt tokens and generated tokens.  Each node is a
token id; a root→node path is a candidate draft branch.  Node frequencies drive
branch ranking; prompt-derived branches carry a separate per-request frequency
so they can be *eliminated* when the request finishes (paper: "Branch
Eliminating") while output-derived branches persist across requests.

Pure host-side data structure: retrieval/update cost is O(branch_length) per
op and measured in microseconds (paper Table 4: ~1ms for much larger tries).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass
class _Node:
    token: int
    # Persistent frequency (from generated outputs and retained statistics).
    freq: float = 0.0
    # Per-request prompt frequency keyed by request id; removed on eliminate().
    prompt_freq: Dict[int, float] = field(default_factory=dict)
    children: Dict[int, "_Node"] = field(default_factory=dict)

    def total_freq(self, prompt_boost: float) -> float:
        return self.freq + prompt_boost * sum(self.prompt_freq.values())


class TrieTree:
    """Global trie with insert / eliminate / decay-prune / retrieve.

    Parameters
    ----------
    capacity: max node count before pruning triggers (paper: 16 * decoding_len).
    prompt_boost: multiplier applied to prompt-branch frequencies when ranking
        (paper §4.3.2 "Branch Weighting": amplify prompt branches).
    decay: multiplicative frequency decay applied during pruning.
    """

    def __init__(self, capacity: int = 1024, prompt_boost: float = 8.0,
                 decay: float = 0.5):
        self.root = _Node(token=-1)
        self.capacity = int(capacity)
        self.prompt_boost = float(prompt_boost)
        self.decay = float(decay)
        self._n_nodes = 0

    # ------------------------------------------------------------------ sizes
    def __len__(self) -> int:
        return self._n_nodes

    # ---------------------------------------------------------------- updates
    def insert(self, tokens: Sequence[int], *, request_id: Optional[int] = None,
               freq: float = 1.0) -> None:
        """Insert one branch.  request_id=None → persistent (output) branch;
        otherwise a prompt branch attributed to that request."""
        node = self.root
        for t in tokens:
            t = int(t)
            child = node.children.get(t)
            if child is None:
                child = _Node(token=t)
                node.children[t] = child
                self._n_nodes += 1
            if request_id is None:
                child.freq += freq
            else:
                child.prompt_freq[request_id] = (
                    child.prompt_freq.get(request_id, 0.0) + freq)
            node = child
        if self._n_nodes > self.capacity:
            self.prune()

    def insert_ngrams(self, tokens: Sequence[int], branch_length: int, *,
                      request_id: Optional[int] = None, stride: int = 1) -> None:
        """Slide a window of ``branch_length`` over ``tokens`` and insert every
        n-gram (paper Algorithm 1 lines 5-9)."""
        toks = [int(t) for t in tokens]
        for i in range(0, max(len(toks) - 1, 0), stride):
            self.insert(toks[i:i + branch_length], request_id=request_id)

    def eliminate(self, request_id: int) -> None:
        """Branch Eliminating: drop the prompt frequencies of a finished
        request; nodes whose every frequency reaches zero are removed."""
        self._eliminate(self.root, request_id)

    def _eliminate(self, node: _Node, request_id: int) -> None:
        dead: List[int] = []
        for tok, child in node.children.items():
            child.prompt_freq.pop(request_id, None)
            self._eliminate(child, request_id)
            if child.freq <= 0.0 and not child.prompt_freq and not child.children:
                dead.append(tok)
        for tok in dead:
            del node.children[tok]
            self._n_nodes -= 1

    def prune(self) -> None:
        """Node Pruning: decay frequencies and drop nodes with freq < 1
        (paper §4.3.1).  Prompt frequencies of live requests are preserved."""
        self._decay_prune(self.root)

    def _decay_prune(self, node: _Node) -> None:
        dead: List[int] = []
        for tok, child in node.children.items():
            child.freq *= self.decay
            self._decay_prune(child)
            if (child.freq < 1.0 and not child.prompt_freq
                    and not child.children):
                dead.append(tok)
        for tok in dead:
            del node.children[tok]
            self._n_nodes -= 1

    # -------------------------------------------------------------- retrieval
    def match(self, prefix: Sequence[int]) -> Optional[_Node]:
        """Walk ``prefix``; return the node it lands on (sub-trie root)."""
        node = self.root
        for t in prefix:
            node = node.children.get(int(t))
            if node is None:
                return None
        return node

    def retrieve(self, context: Sequence[int], *, decoding_length: int,
                 max_prefix_len: int = 8, min_matched_tokens: int = 2,
                 ) -> Tuple[List[List[int]], List[float]]:
        """Multi-stage retrieval (paper §4.3.2).

        Try the longest suffix of ``context`` as a prefix; shorten until the
        matched sub-trie holds enough tokens.  Returns up to
        ``decoding_length`` draft tokens organised as branches
        (list of token-id lists, each a root-path *excluding* the prefix)
        plus a parallel list of branch scores.
        """
        ctx = [int(t) for t in context]
        best: Optional[_Node] = None
        for plen in range(min(max_prefix_len, len(ctx)), 0, -1):
            node = self.match(ctx[-plen:])
            if node is None or not node.children:
                continue
            size = self._subtree_token_count(node, decoding_length)
            best = node
            if size >= min(min_matched_tokens, decoding_length):
                # Enough tokens behind this (longer ⇒ more relevant) prefix.
                break
        if best is None:
            return [], []
        return self._top_branches(best, decoding_length)

    def _subtree_token_count(self, node: _Node, cap: int) -> int:
        n, stack = 0, list(node.children.values())
        while stack and n < cap:
            cur = stack.pop()
            n += 1
            stack.extend(cur.children.values())
        return n

    def _top_branches(self, node: _Node, budget: int
                      ) -> Tuple[List[List[int]], List[float]]:
        """Greedy highest-frequency expansion of the sub-trie under ``node``
        into ≤ ``budget`` tokens, returned as branches sorted by score."""
        # Expand nodes in order of frequency until the token budget is used.
        # Each selected trie-node = one draft token.
        import heapq
        boost = self.prompt_boost
        counter = 0
        # order: high frequency first; on ties prefer DEPTH (deep chains
        # dominate EDL for low-entropy continuations — single-branch drafts
        # become a strict subset of the hierarchical draft)
        heap: List[Tuple[float, int, int, _Node, Tuple[int, ...]]] = []
        for ch in node.children.values():
            heap.append((-ch.total_freq(boost), -1, counter, ch,
                         (ch.token,)))
            counter += 1
        heapq.heapify(heap)
        chosen: List[Tuple[Tuple[int, ...], float]] = []
        taken = 0
        while heap and taken < budget:
            negf, negd, _, cur, path = heapq.heappop(heap)
            chosen.append((path, -negf))
            taken += 1
            for ch in cur.children.values():
                heapq.heappush(
                    heap, (-ch.total_freq(boost), negd - 1, counter, ch,
                           path + (ch.token,)))
                counter += 1
        # Keep only maximal paths as branches but remember every selected node;
        # the draft builder needs the *set* of selected nodes (tree), so return
        # all selected paths — draft.py reconstructs the tree from them.
        branches = [list(p) for p, _ in chosen]
        scores = [s for _, s in chosen]
        return branches, scores

    # ---------------------------------------------------------- serialization
    def state_dict(self) -> Dict[str, list]:
        """Flatten the persistent trie into parallel arrays.

        Nodes are emitted in preorder, children in dict-insertion order —
        ``_top_branches`` breaks frequency ties by heap insertion order, so
        a rebuilt trie must iterate children in the same order as the live
        one for retrieval to stay bit-identical.  Per-request prompt
        frequencies are transient (eliminated at retire) and are not
        serialized.
        """
        tokens: List[int] = []
        parents: List[int] = []
        freqs: List[float] = []
        # Explicit stack; push children reversed so pops preserve insertion
        # order.  parent == -1 means "child of root".
        stack: List[Tuple[_Node, int]] = [
            (ch, -1) for ch in reversed(list(self.root.children.values()))]
        while stack:
            node, parent = stack.pop()
            idx = len(tokens)
            tokens.append(int(node.token))
            parents.append(int(parent))
            freqs.append(float(node.freq))
            for ch in reversed(list(node.children.values())):
                stack.append((ch, idx))
        return {"tokens": tokens, "parents": parents, "freqs": freqs}

    @staticmethod
    def _validate_state(state: Dict[str, list]) -> Tuple[list, list, list]:
        if not isinstance(state, dict):
            raise ValueError("trie state must be a dict")
        try:
            tokens, parents, freqs = (
                state["tokens"], state["parents"], state["freqs"])
        except (KeyError, TypeError) as e:
            raise ValueError(f"trie state missing array: {e}") from e
        if not (len(tokens) == len(parents) == len(freqs)):
            raise ValueError("trie state arrays have mismatched lengths")
        for i, p in enumerate(parents):
            if not (-1 <= int(p) < i):
                raise ValueError(
                    f"trie state is not preorder (parents[{i}]={p})")
        return tokens, parents, freqs

    def load_state_dict(self, state: Dict[str, list]) -> None:
        """Rebuild from ``state_dict`` output, replacing current contents.

        Raises ``ValueError`` on malformed arrays (wrong lengths, parent
        index out of preorder range, duplicate siblings).
        """
        tokens, parents, freqs = self._validate_state(state)
        root = _Node(token=-1)
        nodes: List[_Node] = []
        n = 0
        for t, p, f in zip(tokens, parents, freqs):
            parent = root if p == -1 else nodes[int(p)]
            tok = int(t)
            if tok in parent.children:
                raise ValueError("trie state has duplicate sibling tokens")
            child = _Node(token=tok, freq=float(f))
            parent.children[tok] = child
            nodes.append(child)
            n += 1
        self.root = root
        self._n_nodes = n

    def merge_state(self, state: Dict[str, list]) -> None:
        """Freq-max merge of a serialized trie into this one (gossip).

        Element-wise max is a CRDT join: idempotent, commutative and
        associative, so repeated all-to-all gossip converges instead of
        double-counting (a sum-merge re-adds A's own frequencies every
        time they echo back through B, inflating them exponentially with
        the exchange count — which drowns the prompt-frequency boost and
        stalls decay-pruning).  Walks the arrays directly instead of going
        through ``insert`` so a single bulk merge does not fire the
        per-insert prune trigger midway (callers enforce capacity once,
        after the merge).
        """
        tokens, parents, freqs = self._validate_state(state)
        nodes: List[_Node] = []
        for t, p, f in zip(tokens, parents, freqs):
            parent = self.root if p == -1 else nodes[int(p)]
            tok = int(t)
            child = parent.children.get(tok)
            if child is None:
                child = _Node(token=tok)
                parent.children[tok] = child
                self._n_nodes += 1
            child.freq = max(child.freq, float(f))
            nodes.append(child)

    # -------------------------------------------------------------- estimates
    def memory_bytes(self) -> int:
        """Rough host memory estimate of the trie."""
        # dict entry ≈ 100B, node object ≈ 120B
        return self._n_nodes * 220


class TrieForest:
    """Scenario-scoped tries under ONE shared node-capacity budget.

    The paper deploys *per-scenario* tries at Alipay: co-resident tenants
    must not cross-contaminate branch frequencies (tenant A's hot responses
    would otherwise outrank tenant B's own continuations), but host memory
    is still one budget.  The forest maps a namespace string to an isolated
    ``TrieTree`` — insert / retrieve / eliminate never cross namespaces —
    while capacity accounting sums nodes over every namespace and pruning
    decays all of them together.

    The default namespace ``""`` is THE trie of a single-tenant deployment:
    with no other namespace ever touched, every operation is bit-identical
    to driving that ``TrieTree`` directly (the forest adds no extra prune
    triggers on a single tree — see ``check_capacity``).
    """

    def __init__(self, capacity: int = 1024, prompt_boost: float = 8.0,
                 decay: float = 0.5, root: Optional[TrieTree] = None):
        self.capacity = int(root.capacity if root is not None else capacity)
        self.prompt_boost = float(root.prompt_boost if root is not None
                                  else prompt_boost)
        self.decay = float(root.decay if root is not None else decay)
        self._tries: Dict[str, TrieTree] = {
            "": root if root is not None else TrieTree(
                capacity=self.capacity, prompt_boost=self.prompt_boost,
                decay=self.decay)}

    # ------------------------------------------------------------- namespaces
    def tree(self, namespace: str = "") -> TrieTree:
        """The namespace's trie, created on first touch.  Every namespace
        inherits the shared capacity so the per-insert prune trigger of an
        individual trie still bounds pathological single-tenant growth."""
        t = self._tries.get(namespace)
        if t is None:
            t = self._tries[namespace] = TrieTree(
                capacity=self.capacity, prompt_boost=self.prompt_boost,
                decay=self.decay)
        return t

    def get(self, namespace: str = "") -> Optional[TrieTree]:
        """The namespace's trie, or None if never touched (retrieval from an
        unknown namespace must not create state)."""
        return self._tries.get(namespace)

    def namespaces(self) -> Tuple[str, ...]:
        return tuple(sorted(self._tries))

    # --------------------------------------------------------------- capacity
    def __len__(self) -> int:
        """Total node count across every namespace (the shared budget)."""
        return sum(len(t) for t in self._tries.values())

    def prune_all(self) -> None:
        for t in self._tries.values():
            t.prune()

    def check_capacity(self) -> None:
        """Shared accounting: when the SUM of namespace nodes exceeds the
        one capacity, decay-prune every namespace.  Single-namespace forests
        skip this — ``TrieTree.insert`` already prunes at the same capacity,
        and an extra trigger here would change the default deployment's trie
        evolution (it must stay bit-identical to the pre-forest scheduler)."""
        if len(self._tries) > 1 and len(self) > self.capacity:
            self.prune_all()

    def memory_bytes(self) -> int:
        return sum(t.memory_bytes() for t in self._tries.values())

    # ---------------------------------------------------------- serialization
    def state_dict(self) -> Dict[str, object]:
        """Per-namespace serialized tries (empty namespaces are skipped)."""
        return {"namespaces": {ns: t.state_dict()
                               for ns, t in self._tries.items() if len(t)}}

    @staticmethod
    def _state_namespaces(state: Dict[str, object]) -> Dict[str, dict]:
        if not isinstance(state, dict):
            raise ValueError("forest state must be a dict")
        ns_map = state.get("namespaces")
        if not isinstance(ns_map, dict):
            raise ValueError("forest state missing 'namespaces' map")
        return ns_map

    def load_state_dict(self, state: Dict[str, object]) -> None:
        """Replace every namespace with the serialized forest's contents.
        The local capacity/boost/decay configuration wins over the donor's."""
        ns_map = self._state_namespaces(state)
        self._tries = {"": TrieTree(capacity=self.capacity,
                                    prompt_boost=self.prompt_boost,
                                    decay=self.decay)}
        for ns, tree_state in ns_map.items():
            self.tree(str(ns)).load_state_dict(tree_state)

    def merge_state(self, state: Dict[str, object]) -> None:
        """Gossip merge: freq-max each donor namespace into the local forest,
        then decay-prune until the shared capacity budget holds again."""
        ns_map = self._state_namespaces(state)
        for ns, tree_state in ns_map.items():
            self.tree(str(ns)).merge_state(tree_state)
        # Merged branches carry no live prompt_freq, so repeated decay always
        # makes progress on them; the no-progress guard covers a forest pinned
        # by live requests' prompt branches.
        while len(self) > self.capacity:
            before = len(self)
            self.prune_all()
            if len(self) >= before:
                break


__all__ = ["TrieTree", "TrieForest"]
