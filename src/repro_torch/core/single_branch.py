"""Single-branch (LLMA-style) baseline configuration (paper Table 2 column)
— a copy of ``repro.core.single_branch``.

LLMA [Yang et al. 2023] retrieves a single draft by prefix-matching against
the input prompt (or a document store).  In this framework it is exactly the
lookahead engine with ``strategy="single"`` and output-branch insertion
disabled only if one wants the strict prompt-copy variant; the default below
matches the paper's LLMA baseline setting (prompt branches only are what LLMA
can see, single chain per step).
"""
from __future__ import annotations

from .strategies import LookaheadConfig


def llma_config(branch_length: int = 16, decoding_length: int = 16,
                strict_prompt_only: bool = True) -> LookaheadConfig:
    return LookaheadConfig(
        strategy="single",
        decoding_length=decoding_length,
        branch_length=branch_length,
        insert_prompt=True,
        insert_output=not strict_prompt_only,
    )


def baseline_config() -> LookaheadConfig:
    """Plain step-by-step decoding (transformers baseline in Table 2)."""
    return LookaheadConfig(strategy="none", decoding_length=0)


__all__ = ["llma_config", "baseline_config"]
