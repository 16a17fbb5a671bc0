"""Shared recsys helpers: MLP towers, losses (PyTorch port of
``repro.models.recsys.common``), differentiable: the train cells take
their gradients through them (``configs/*::train_cell``)."""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.models.params import Device, resolve_device

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """A config's dtype name (``"float32"``) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else _DTYPES[name]


class _NoDraws:
    """The generator of ``device="meta"``: a device and no state, so that
    ``init_params`` gives the parameters' shapes and dtypes alone (the
    counterpart of ``jax.eval_shape(init_params)``)."""
    device = torch.device("meta")


def generator(seed: int, device: Device = None) -> torch.Generator:
    """A torch generator seeded with ``seed`` on the resolved device (the
    card unless the caller asks for the CPU); on ``meta`` one that draws
    nothing."""
    dev = resolve_device(device)
    if dev.type == "meta":
        return _NoDraws()
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    return gen


def normal(gen: torch.Generator, shape, scale: float,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """N(0, scale^2) drawn in f32 on the generator's device, cast to
    ``dtype`` (on ``meta``: an empty tensor of that shape and dtype)."""
    if gen.device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=gen.device)
    t = torch.randn(shape, generator=gen, device=gen.device,
                    dtype=torch.float32)
    return t.mul_(scale).to(dtype)


def init_mlp(gen: torch.Generator, dims: Sequence[int],
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """He-normal weights ``w{i}`` (a, b) and zero biases ``b{i}``."""
    p = {}
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        p[f"w{i}"] = normal(gen, (a, b), (2.0 / a) ** 0.5, dtype)
        p[f"b{i}"] = torch.zeros((b,), dtype=dtype, device=gen.device)
    return p


def mlp(p: Dict[str, torch.Tensor], x: torch.Tensor, final_act: bool = False
        ) -> torch.Tensor:
    n = sum(1 for k in p if k.startswith("w"))
    for i in range(n):
        x = x @ p[f"w{i}"] + p[f"b{i}"]
        if i < n - 1 or final_act:
            x = F.relu(x)
    return x


def bce_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    z = logits.float()
    y = labels.float()
    return torch.mean(z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs())))


def in_batch_softmax_loss(q: torch.Tensor, c: torch.Tensor,
                          logq: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """Sampled-softmax with in-batch negatives + optional logQ correction.
    q, c: (B, D) matched pairs (row i of c is the positive for row i of q)."""
    scores = q.float() @ c.float().T
    if logq is not None:
        scores = scores - logq[None, :]
    logp = torch.log_softmax(scores, dim=-1)
    return -torch.mean(torch.diagonal(logp))


def wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Negative indices wrapped as ``jnp.take_along_axis`` wraps them (-1 is
    the last of ``n``); torch's gather would raise on them."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


__all__ = ["init_mlp", "mlp", "bce_loss", "in_batch_softmax_loss",
           "torch_dtype", "generator", "normal", "wrap_index"]
