"""Wrapper of the Gumbel-argmax CUDA kernel (``csrc/gumbel_argmax.cu``): the
sampled branch of ``repro_torch.serving.sampler.choose_tokens_lanes``.

A tensor on the card launches the kernel, after the checks of
``_build.check_cuda`` and of the shapes and dtypes; anything the kernel does
not take raises. A tensor on the CPU, or on ``meta`` (the dry-run's shape
trace, which launches nothing), takes the plain version (``ref.py``).
``gumbel_argmax.launches`` counts kernel launches only."""
from __future__ import annotations

import torch

from .. import _build
from .ref import gumbel_argmax_ref

CHUNK = 4096          # vocab entries per block of the kernel's first pass


def gumbel_argmax(logits: torch.Tensor, pred_positions: torch.Tensor,
                  temp: torch.Tensor, seed: torch.Tensor,
                  greedy: torch.Tensor) -> torch.Tensor:
    """logits (B, T, V) f32 or bf16; pred_positions (B, T) int; temp (B,)
    f32; seed (B,) int64 holding uint32 values; greedy (B,) bool ->
    (B, T) int32: row (b, t) is
    ``argmax_v(logits / max(temp[b], 1e-6) + gumbel(fold_in(key(seed[b]),
    pred_positions[b, t]))[v])``, and 0 on the rows of greedy lanes."""
    if logits.device.type in ("cpu", "meta"):
        return gumbel_argmax_ref(logits, pred_positions, temp, seed, greedy)
    B, T, V = logits.shape
    pos = pred_positions.to(torch.int32).contiguous()
    temp = temp.to(torch.float32).contiguous()
    seed = seed.to(torch.int64).contiguous()
    greedy = greedy.to(torch.bool).contiguous()
    _build.check_cuda("gumbel_argmax", logits)
    for name, t, shape in (("pred_positions", pos, (B, T)),
                           ("temp", temp, (B,)), ("seed", seed, (B,)),
                           ("greedy", greedy, (B,))):
        if t.device != logits.device or tuple(t.shape) != shape:
            raise ValueError(f"gumbel_argmax: {name} must be {shape} on "
                             f"{logits.device}, got {tuple(t.shape)} on "
                             f"{t.device}")
    if B * T > 65535:
        raise ValueError(f"gumbel_argmax: B*T={B * T} rows over 65535")
    n_chunks = -(-V // CHUNK)
    pval = torch.empty((B * T, n_chunks), dtype=torch.float32,
                       device=logits.device)
    pidx = torch.empty((B * T, n_chunks), dtype=torch.int32,
                       device=logits.device)
    out = torch.empty((B, T), dtype=torch.int32, device=logits.device)
    lib = _build.load("gumbel_argmax")
    stream = torch.cuda.current_stream(logits.device).cuda_stream
    with torch.cuda.device(logits.device):
        rc = lib.gumbel_argmax_launch(
            logits.data_ptr(), pos.data_ptr(), temp.data_ptr(),
            seed.data_ptr(), greedy.data_ptr(), pval.data_ptr(),
            pidx.data_ptr(), out.data_ptr(), B, T, V, n_chunks,
            _build.DTYPE_CODE[logits.dtype], stream)
    _build.check_status("gumbel_argmax", rc)
    gumbel_argmax.launches += 1
    return out


gumbel_argmax.launches = 0


def gumbel_noise(seed: torch.Tensor, pred_positions: torch.Tensor, V: int):
    """The kernel's generator alone, for checking it: seed (R,) int64 and
    pred_positions (R,) int on the card -> (raw bits (R, V) as int64 holding
    uint32 values, Gumbel values (R, V) f32), as the sampled pass draws them.
    Not a serving path: it is not counted."""
    R = seed.shape[0]
    seed = seed.to(torch.int64).contiguous()
    pos = pred_positions.to(torch.int32).contiguous()
    if seed.device.type != "cuda" or pos.device != seed.device:
        raise ValueError("gumbel_noise: seed and positions must be on one "
                         "CUDA device")
    bits = torch.empty((R, V), dtype=torch.int32, device=seed.device)
    g = torch.empty((R, V), dtype=torch.float32, device=seed.device)
    lib = _build.load("gumbel_argmax")
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    with torch.cuda.device(seed.device):
        rc = lib.gumbel_noise_launch(seed.data_ptr(), pos.data_ptr(),
                                     bits.data_ptr(), g.data_ptr(), R, V,
                                     stream)
    _build.check_status("gumbel_noise", rc)
    return bits.long() & 0xFFFFFFFF, g


__all__ = ["gumbel_argmax", "gumbel_noise", "gumbel_argmax_ref", "CHUNK"]
