"""Verification-and-Accept (paper §4.1, Algorithm 1 line 21).

Given per-slot *chosen* token ids (greedy argmax, or deterministic
position-keyed sample — computed on device, shipped as a tiny int array) and
the host-side draft tree, find the longest root-path whose node tokens match
the chosen id of their parent.  Acceptance rules:

  * the chosen id of slot 0 (the root = last committed token) is ALWAYS
    accepted — this is the model's own next-token prediction, so the step
    never emits fewer tokens than step-by-step decoding (worst case == 1);
  * a draft node ``c`` (child of ``p``) is verified iff
    ``tokens[c] == chosen[p]``; walking matched nodes extends the output by
    ``chosen[c]`` and commits slot ``c``'s KV entry.

Returns both the accepted tokens and the slot indices whose KV entries must
be compacted into the cache (slot 0 plus every matched node, in path order).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .draft import DraftTree


def verify_accept(tree: DraftTree, chosen: np.ndarray
                  ) -> Tuple[List[int], List[int]]:
    """Longest-match walk.

    Parameters
    ----------
    tree:    host draft tree (slot 0 = root).
    chosen:  (T,) int array — model-chosen token per slot.

    Returns
    -------
    accepted_tokens: the new output tokens (len >= 1).
    kv_slots:        slot indices whose KV becomes part of the committed
                     context, in order (always starts with 0).  Note
                     ``len(kv_slots) == len(accepted_tokens)``: the last
                     accepted token has no KV yet — it is next step's root.
    """
    chosen = np.asarray(chosen)
    accepted = [int(chosen[0])]
    kv_slots = [0]
    cur = 0
    while True:
        nxt = -1
        want = int(chosen[cur])
        for c in tree.children[cur]:
            if c < tree.n_slots and int(tree.tokens[c]) == want:
                nxt = c
                break
        if nxt < 0:
            break
        cur = nxt
        kv_slots.append(cur)
        accepted.append(int(chosen[cur]))
    return accepted, kv_slots


def verify_accept_batch(trees: Sequence[DraftTree], chosen: np.ndarray
                        ) -> Tuple[List[List[int]], List[List[int]]]:
    """Batched wrapper: ``chosen`` is (B, T)."""
    acc, slots = [], []
    for b, tree in enumerate(trees):
        a, s = verify_accept(tree, chosen[b])
        acc.append(a)
        slots.append(s)
    return acc, slots


__all__ = ["verify_accept", "verify_accept_batch"]
