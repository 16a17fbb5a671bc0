"""Shared recsys helpers: MLP towers, losses (PyTorch port of
``repro.models.recsys.common``), differentiable: the train cells take
their gradients through them (``configs/*::train_cell``); ``Lanes``, how
a recsys call lies on a mesh."""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (P, NamedSharding, active_mesh,
                                              active_rules, gather_blocks,
                                              placement, reduce_sum,
                                              sum_grad, unshard)
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


def mlp_logical_axes(n_layers: int) -> Dict:
    """An ``init_mlp`` tree's logical axes: replicated, as the
    reference's."""
    return {**{f"w{i}": (None, None) for i in range(n_layers)},
            **{f"b{i}": (None,) for i in range(n_layers)}}


def place(mesh, shape, axes):
    """This rank's ``placement`` of a leaf of ``shape`` and logical
    ``axes`` under the active rules, or None without a mesh."""
    if mesh is None:
        return None
    return placement(mesh, axes, tuple(shape), active_rules())


def keep(block, t: torch.Tensor) -> torch.Tensor:
    """``t`` (whole) as this rank's block under ``block`` (a copy where it
    splits, else ``t`` itself)."""
    if block is None or not block.axes():
        return t
    return block.local(t).clone()


def bce_loss(logits: torch.Tensor, labels: torch.Tensor,
             lanes: Optional["Lanes"] = None) -> torch.Tensor:
    """Mean binary cross-entropy of the logits; under a mesh (``lanes``
    splitting the rows) this rank's rows summed, summed over the ranks,
    over the whole batch."""
    z = logits.float()
    y = labels.float()
    terms = z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs()))
    if lanes is None or not lanes.axes:
        return torch.mean(terms)
    return lanes.total(terms.sum()) / lanes.batch


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


class Lanes:
    """How one recsys call lies on the active mesh for a batch of
    ``batch`` rows: the reference's ``constrain(x, "batch", ...)`` written
    out.  Every rank passes the whole inputs; the call computes on this
    rank's rows (``local``: ``placement(inputs=True)`` of the "batch" dim,
    whole where its axes do not divide ``batch``) and returns their block
    of the output (``gather`` for the whole).  ``weight`` marks a leaf that
    every rank uses on its own rows, so its gradient is summed over the
    rows' axes (``sum_grad``); ``total`` sums per-rank partial sums over
    them (a loss).  Without a mesh every method is the identity."""

    def __init__(self, batch: int):
        self.mesh, self.batch = active_mesh(), batch
        self.axes: tuple = ()
        self.sharding: Optional[NamedSharding] = None
        self.start = 0
        if self.mesh is None:
            return
        sh = placement(self.mesh, ("batch",), (batch,), active_rules(),
                       inputs=True)
        self.axes = tuple(a for a in sh.axes() if self.mesh.shape[a] > 1)
        if self.axes:
            self.sharding = NamedSharding(self.mesh, P(self.axes))
            self.start = sh._index(1)[0] * sh.shard_shape((batch,))[0]

    def local(self, x: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        """This rank's rows of a global (batch, ...) input."""
        if x is None or self.sharding is None:
            return x
        return self.sharding.local(x)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The global (batch, ...) output from every rank's rows."""
        return x if self.sharding is None else unshard(x, self.sharding)

    def gather_blocks(self, x: torch.Tensor) -> torch.Tensor:
        """The global rows from every rank's, as an input of this rank's
        work (the transpose sums the ranks' gradients and keeps this
        rank's rows)."""
        return x if self.sharding is None else gather_blocks(x,
                                                             self.sharding)

    def weight(self, tree: Any) -> Any:
        """``tree``'s leaves, each used on this rank's rows: its gradient
        summed over the rows' axes."""
        if isinstance(tree, dict):
            return {k: self.weight(v) for k, v in tree.items()}
        if self.mesh is None:
            return tree
        return sum_grad(tree, self.mesh, self.axes)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """A 0-d partial sum over this rank's rows summed over the ranks."""
        if not self.axes:
            return x
        return reduce_sum(x.reshape(1), self.mesh, self.axes)[0]


def wrap_index(idx: torch.Tensor, n: int) -> torch.Tensor:
    """Negative indices wrapped as ``jnp.take_along_axis`` wraps them (-1 is
    the last of ``n``); torch's gather would raise on them."""
    idx = idx.long()
    return torch.where(idx < 0, idx + n, idx)


__all__ = ["init_mlp", "mlp", "bce_loss", "in_batch_softmax_loss",
           "torch_dtype", "generator", "normal", "wrap_index", "Lanes",
           "mlp_logical_axes", "place", "keep"]
