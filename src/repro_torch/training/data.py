"""Synthetic data (port-local copy of ``repro.training.data``'s
``CorpusProfile`` / ``PROFILES`` / ``SyntheticCorpus``, its LM training
batches and its recsys batch generators, numpy only): RAG-style prompts
whose answers copy spans from the prompt and from a shared phrase pool —
the redundancy a Lookahead trie exploits — and LM and recommender batches
drawn in the reference's order of ``RandomState`` calls, so the same seed
gives the same arrays."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np


# ------------------------------------------------------------------ LM corpus
@dataclass(frozen=True)
class CorpusProfile:
    """Controls the n-gram structure a Lookahead trie can exploit."""
    name: str
    prompt_len: int            # mean prompt tokens (paper Table 8)
    answer_len: int            # mean answer tokens
    copy_from_prompt: float    # P(next phrase is copied from the prompt)
    pool_reuse: float          # P(next phrase comes from the shared pool)
    phrase_len: int = 8
    pool_size: int = 64


PROFILES = {
    # paper Table 8 statistics; copy rates tuned to reproduce Table 2 ordering
    "antrag": CorpusProfile("antrag", 241, 82, 0.70, 0.20),
    "dolly": CorpusProfile("dolly", 301, 105, 0.15, 0.25),
    "gsm8k": CorpusProfile("gsm8k", 68, 132, 0.10, 0.45),
    "humaneval": CorpusProfile("humaneval", 140, 82, 0.25, 0.55),
}


class SyntheticCorpus:
    """Generates (prompt, answer) token pairs with profile-controlled reuse."""

    def __init__(self, profile: CorpusProfile, vocab_size: int,
                 seed: int = 0, reserved: int = 2):
        self.p = profile
        self.vocab = vocab_size
        self.rng = np.random.RandomState(seed)
        self.reserved = reserved   # 0 = pad, 1 = eos
        self.pool = [self._rand_phrase() for _ in range(profile.pool_size)]

    def _rand_phrase(self) -> List[int]:
        return list(self.rng.randint(self.reserved, self.vocab,
                                     size=self.p.phrase_len))

    def sample(self) -> Tuple[List[int], List[int]]:
        p = self.p
        prompt: List[int] = []
        # prompt = mixture of pool phrases (shared doc store) + noise
        while len(prompt) < p.prompt_len:
            if self.rng.rand() < 0.5:
                prompt += self.pool[self.rng.randint(len(self.pool))]
            else:
                prompt += self._rand_phrase()
        prompt = prompt[:p.prompt_len]
        answer: List[int] = []
        while len(answer) < p.answer_len:
            r = self.rng.rand()
            if r < p.copy_from_prompt and len(prompt) > p.phrase_len:
                s = self.rng.randint(0, len(prompt) - p.phrase_len)
                answer += prompt[s:s + p.phrase_len]
            elif r < p.copy_from_prompt + p.pool_reuse:
                answer += self.pool[self.rng.randint(len(self.pool))]
            else:
                answer += self._rand_phrase()
        return prompt, answer[:p.answer_len]

    def dataset(self, n: int) -> List[Tuple[List[int], List[int]]]:
        return [self.sample() for _ in range(n)]


def lm_train_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                     corpus: Optional[SyntheticCorpus] = None
                     ) -> Iterator[Dict[str, np.ndarray]]:
    """Next-token LM batches of int32 ``tokens`` / ``labels`` (B, seq):
    uniform ids in [2, vocab), or a corpus's documents streamed end to end
    (prompt, answer, eos 1) when one is given."""
    rng = np.random.RandomState(seed)
    while True:
        if corpus is None:
            toks = rng.randint(2, vocab, size=(batch, seq + 1))
        else:
            rows = []
            for _ in range(batch):
                doc: List[int] = []
                while len(doc) < seq + 1:
                    pr, ans = corpus.sample()
                    doc += pr + ans + [1]
                rows.append(doc[:seq + 1])
            toks = np.asarray(rows)
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}


# ------------------------------------------------------------------- recsys
def wide_deep_batch(rng: np.random.RandomState, batch: int, n_sparse: int,
                    rows: int, multi_hot: int, n_dense: int
                    ) -> Dict[str, np.ndarray]:
    return {
        "sparse_ids": rng.randint(0, rows, (batch, n_sparse, multi_hot)
                                  ).astype(np.int32),
        "sparse_mask": (rng.rand(batch, n_sparse, multi_hot) > 0.25),
        "dense": rng.randn(batch, n_dense).astype(np.float32),
        "labels": rng.randint(0, 2, (batch,)).astype(np.float32),
    }


def two_tower_batch(rng: np.random.RandomState, batch: int, n_user: int,
                    n_item: int, rows: int) -> Dict[str, np.ndarray]:
    return {"user_ids": rng.randint(0, rows, (batch, n_user)).astype(np.int32),
            "item_ids": rng.randint(0, rows, (batch, n_item)).astype(np.int32)}


def seq_rec_batch(rng: np.random.RandomState, batch: int, seq: int,
                  n_items: int, causal: bool, n_neg: int = 64
                  ) -> Dict[str, np.ndarray]:
    ids = rng.randint(2, n_items, (batch, seq)).astype(np.int32)
    pad = np.ones((batch, seq), bool)
    negatives = rng.randint(2, n_items, (n_neg,)).astype(np.int32)
    if causal:   # sasrec: next-item labels + shared negatives
        labels = np.concatenate([ids[:, 1:], -np.ones((batch, 1), np.int32)],
                                axis=1).astype(np.int32)
        return {"ids": ids, "labels": labels, "negatives": negatives,
                "pad_mask": pad}
    # bert4rec: cloze — fixed count of masked slots per row
    M = max(seq // 5, 1)
    mpos = np.stack([rng.choice(seq, M, replace=False)
                     for _ in range(batch)]).astype(np.int32)
    mlab = np.take_along_axis(ids, mpos, axis=1).astype(np.int32)
    ids_masked = ids.copy()
    np.put_along_axis(ids_masked, mpos, 1, axis=1)   # [MASK]=1
    return {"ids": ids_masked, "masked_pos": mpos, "masked_labels": mlab,
            "negatives": negatives, "pad_mask": pad}


__all__ = ["CorpusProfile", "PROFILES", "SyntheticCorpus", "lm_train_batches",
           "wide_deep_batch", "two_tower_batch", "seq_rec_batch"]
