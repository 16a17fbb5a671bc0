"""Configuration for the Lookahead decoding strategies."""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class LookaheadConfig:
    """Hyper-parameters of the lookahead generation mode (paper §4, §5.2.2/5.2.3).

    strategy:
      * "hierarchical" — trie-merged multi-branch draft (the paper's method)
      * "parallel"     — multi-branch without prefix merging (ablation)
      * "single"       — single-branch (LLMA-style baseline)
      * "none"         — plain step-by-step decoding (baseline)
    """
    decoding_length: int = 64        # L_d: draft token budget per step (<= CDL)
    branch_length: int = 12          # L_b: n-gram length inserted into the trie
    strategy: str = "hierarchical"
    # trie
    capacity_factor: int = 16        # node capacity = factor * decoding_length
    prompt_boost: float = 8.0        # branch-weighting amplifier for prompt branches
    decay: float = 0.5               # pruning frequency decay
    max_prefix_len: int = 8          # multi-stage retrieval: longest suffix tried
    min_matched_tokens: int = 2      # retry with shorter prefix below this
    # draft-source retrieval tuning (core/draft_sources.py); which sources a
    # request actually uses is the per-request DraftPolicy, these shape HOW
    # each source retrieves once selected
    copy_min_match: int = 2          # PromptCopySource: shortest suffix matched
    copy_max_branches: int = 4       # PromptCopySource: copy sites per retrieve
    ngram_order: int = 3             # NgramSource: max conditioning order k
    ngram_max_entries: int = 65536   # NgramSource: count-table cap before decay
    # ablation switches (paper Table 3)
    insert_prompt: bool = True
    insert_output: bool = True
    eliminate: bool = True
    prune: bool = True
    # sampling
    sample: bool = False             # False = greedy; True = position-keyed sample
    temperature: float = 1.0

    @property
    def trie_capacity(self) -> int:
        # capacity_factor × decoding_length *n-grams* (each up to
        # branch_length nodes); floor keeps one prompt+response resident.
        return max(self.capacity_factor * max(self.decoding_length, 1)
                   * max(self.branch_length, 1), 2048)

    @property
    def slots(self) -> int:
        """Device step width: root + draft budget."""
        return 1 + (self.decoding_length if self.strategy != "none" else 0)


__all__ = ["LookaheadConfig"]
