"""Token choice: greedy argmax or *position-keyed* sampling, per lane
(PyTorch port of ``repro.serving.sampler``).

Lossless sampling for tree verification needs the token sampled at output
position ``p`` to be a pure function of (seed, p, logits), independent of
how many tokens each step accepted.  The rule is Gumbel-argmax with a
per-request key folded on the position:
``argmax(logits / tau_b + gumbel(fold_in(key(seed_b), p)))``.  Step-by-step
decoding with the same rule gives the same stream, which is what the
lossless tests assert.

The reference draws its noise with ``jax.random`` (threefry2x32, the
partitionable bit layout of jax 0.9).  This module carries that generator
in torch integer ops — int64 tensors holding uint32 values, masked after
every add and shift — so the key, fold-in, raw bits and uniforms equal the
reference's bit for bit (``kernels/gumbel_argmax/ref.py``, re-exported
here).  The Gumbel values go through two ``log`` calls,
whose last bits differ between XLA and torch: they agree to 2e-6 (absolute,
f32), so a sampled token matches the reference wherever the top two values
of ``z + g`` are further apart than that.

``choose_tokens_lanes`` is the serving entry point: per-lane ``greedy``,
``temp`` and ``seed`` vectors (device tensors, so one step function serves a
lane pool mixing greedy and sampled requests).  On a CUDA tensor the sampled
branch runs the Gumbel-argmax kernel (``kernels/gumbel_argmax``), which
never materialises the (B, T, V) noise; its plain version is the CPU path
and the kernel's yardstick.  ``argmax`` takes the first index on a
tie, as ``jnp.argmax`` does.

Under a mesh the model's logits are this rank's block: its lanes and its
vocab block (``models/transformer.Layout.logits``, passed as
``sharding``).  The greedy choice is then ``_sharded_argmax``, as in the
reference: each rank's argmax over its vocab block, one all-gather of
(value, index) pairs over the vocab axes.  The sampled branch draws its
noise at global vocab indices, so it gathers the logits over the vocab
axes first (a Gumbel kernel that takes a vocab offset is ROADMAP
perf work); a session built with ``sampling="greedy"`` never gathers.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from repro_torch.distributed.sharding import NamedSharding, P, dim_axes
from repro_torch.kernels.gumbel_argmax.ops import gumbel_argmax
from repro_torch.kernels.gumbel_argmax.ref import (  # noqa: F401
    F32_TINY, M32, MIN_TEMP, fold_in, gumbel, gumbel_argmax_ref, random_bits32,
    random_key, threefry2x32, uniform_tiny_one)


LaneParams = Dict[str, torch.Tensor]   # {"greedy": (B,) bool, "temp": (B,)
                                       #  f32, "seed": (B,) uint32 in int64}


def seed_from_key(words: Sequence[int]) -> int:
    """The reference session's legacy ``base_key`` collapse: XOR of every
    uint32 word of the key's raw data (``jax.random.key_data``)."""
    w = np.asarray(words, dtype=np.uint32).ravel()
    return int(np.bitwise_xor.reduce(w)) if w.size else 0


# ---------------------------------------------------------------- token choice
def greedy_choice(logits: torch.Tensor) -> torch.Tensor:
    """(B, T, V) -> (B, T) int32 argmax ids, first index on a tie."""
    return logits.argmax(dim=-1).int()


def _vocab_axes(sharding) -> tuple:
    """The live mesh axes of ``sharding``'s last (vocab) dim."""
    if sharding is None:
        return ()
    return tuple(a for a in dim_axes(sharding.spec[-1])
                 if sharding.mesh.shape[a] > 1)


def _sharded_argmax(logits: torch.Tensor, sharding=None) -> torch.Tensor:
    """(B, T, V) -> (B, T) int32 argmax over vocab-sharded logits.
    ``logits`` is this rank's block under ``sharding`` (a
    ``NamedSharding`` of the global logits; None: whole): each rank takes
    the argmax of its vocab block, offsets it, the (n, B_l, T) values and
    ids are gathered over the vocab axes and the first maximum wins — the
    first index on a tie, as ``argmax``.  Returns this rank's lanes of the
    (B, T) result (the lanes of ``logits``).  Plain argmax where the vocab
    is whole."""
    axes = _vocab_axes(sharding)
    if not axes:
        return greedy_choice(logits)
    mesh = sharding.mesh
    li = logits.argmax(dim=-1)
    lv = logits.gather(-1, li[..., None])[..., 0]
    nd = logits.dim()
    block = NamedSharding(mesh, P(*((None,) * (nd - 1)), axes))._index(nd)
    gi = li + block[-1] * logits.shape[-1]
    vs = mesh.all_gather(lv, axes)                          # (n, B_l, T)
    gs = mesh.all_gather(gi, axes)
    w = vs.argmax(dim=0)
    return gs.gather(0, w[None])[0].int()


def whole_vocab(logits: torch.Tensor, sharding=None) -> torch.Tensor:
    """``logits`` (this rank's block under ``sharding``) gathered over the
    vocab axes: this rank's lanes, every vocab id."""
    axes = _vocab_axes(sharding)
    if not axes:
        return logits
    return NamedSharding(sharding.mesh, P(*((None,) * (logits.dim() - 1)),
                                          axes)).gather(logits)


def choose_tokens(logits: torch.Tensor, pred_positions: torch.Tensor,
                  sample: bool = False, temperature: float = 1.0,
                  seed: int = 0, sharding=None) -> torch.Tensor:
    """logits (B, T, V); pred_positions (B, T) — the output position each
    slot's logits predict.  Returns (B, T) int32 chosen ids: the argmax, or
    with ``sample`` one Gumbel-argmax draw per row under one seed.
    ``sharding``: the logits are this rank's block (see module doc)."""
    if not sample:
        return _sharded_argmax(logits, sharding)
    B = logits.shape[0]
    dev = logits.device
    return choose_tokens_lanes(logits, pred_positions, {
        "greedy": torch.zeros((B,), dtype=torch.bool, device=dev),
        "temp": torch.full((B,), float(temperature), dtype=torch.float32,
                           device=dev),
        "seed": torch.full((B,), int(seed) & M32, dtype=torch.int64,
                           device=dev)}, sharding)


def choose_tokens_lanes(logits: torch.Tensor, pred_positions: torch.Tensor,
                        lane_params: LaneParams, sharding=None
                        ) -> torch.Tensor:
    """Per-lane token choice: lane b argmaxes when ``greedy[b]``, else draws
    by Gumbel-argmax at ``temp[b]`` with the key fold_in(key(seed[b]), p).

    logits (B, T, V); pred_positions (B, T) absolute output positions.
    Returns (B, T) int32.  Both branches run and ``where`` selects per lane
    (the lane vectors live on the device: reading them would sync); a
    session built with ``sampling="greedy"`` calls ``_sharded_argmax``
    alone.  Under a mesh (``sharding``) every argument holds this rank's
    lanes."""
    arg = _sharded_argmax(logits, sharding)
    greedy = lane_params["greedy"]
    samp = gumbel_argmax(whole_vocab(logits, sharding), pred_positions,
                         lane_params["temp"], lane_params["seed"], greedy)
    return torch.where(greedy.bool()[:, None], arg, samp)


__all__ = ["threefry2x32", "random_key", "fold_in", "random_bits32",
           "uniform_tiny_one", "gumbel", "seed_from_key", "greedy_choice",
           "gumbel_argmax_ref", "choose_tokens", "choose_tokens_lanes",
           "whole_vocab",
           "LaneParams", "F32_TINY", "MIN_TEMP"]
