"""Token choice, greedy (PyTorch port of ``repro.serving.sampler``).

The port serves greedy requests only: position-keyed Gumbel sampling,
bit-exact to the reference's ``jax.random`` stream, is ROADMAP item A10.
``argmax`` takes the first index on a tie, as ``jnp.argmax`` does.
"""
from __future__ import annotations

from typing import Dict

import torch

LaneParams = Dict[str, object]     # {"greedy": (B,), "temp": (B,),
                                   #  "seed": (B,)} — ignored while greedy


def choose_tokens(logits: torch.Tensor, pred_positions: torch.Tensor
                  ) -> torch.Tensor:
    """logits (B, T, V); pred_positions (B, T) — the output position each
    slot's logits predict.  Returns (B, T) int32 argmax ids."""
    del pred_positions    # greedy choice does not depend on the position
    return logits.argmax(dim=-1).int()


def choose_tokens_lanes(logits: torch.Tensor, pred_positions: torch.Tensor,
                        lane_params: LaneParams) -> torch.Tensor:
    """Per-lane token choice, greedy branch: every lane argmaxes (sampled
    lanes are refused before they reach the device)."""
    del lane_params
    return choose_tokens(logits, pred_positions)


__all__ = ["choose_tokens", "choose_tokens_lanes", "LaneParams"]
