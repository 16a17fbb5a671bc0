"""Lookahead core: trie-based lossless multi-branch speculative decoding."""
from .autotune import AutoTuneConfig, AutoTuner, NamespaceController
from .draft import (BUILDERS, DraftTree, build_hierarchical, build_parallel,
                    build_single, repad)
from .draft_sources import (AdaptiveBudget, DraftPolicy, DraftSource,
                            NgramSource, PromptCopySource, TrieSource,
                            available_sources, build_draft_from_policy,
                            make_source, merge_branches, register_source)
from .engine import LookaheadEngine, reference_decode
from .request import (GenStats, Request, RequestResult, RequestState,
                      SamplingParams, StepFns, build_draft_tree,
                      cache_token_limit, idle_tree, trie_admit, trie_retire,
                      trie_stream)
from .single_branch import baseline_config, llma_config
from .strategies import LookaheadConfig
from .trie import TrieForest, TrieTree
from .verify import verify_accept, verify_accept_batch

__all__ = [
    "BUILDERS", "DraftTree", "build_hierarchical", "build_parallel",
    "build_single", "repad", "GenStats", "LookaheadEngine", "Request",
    "RequestResult", "RequestState", "SamplingParams", "StepFns",
    "build_draft_tree", "cache_token_limit", "idle_tree", "trie_admit",
    "trie_retire", "trie_stream", "reference_decode", "baseline_config",
    "llma_config", "LookaheadConfig", "TrieTree", "TrieForest",
    "verify_accept", "verify_accept_batch",
    "AdaptiveBudget", "DraftPolicy", "DraftSource", "NgramSource",
    "PromptCopySource", "TrieSource", "available_sources",
    "build_draft_from_policy", "make_source", "merge_branches",
    "register_source",
    "AutoTuneConfig", "AutoTuner", "NamespaceController",
]
