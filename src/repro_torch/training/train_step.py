"""Generic train step factory: loss + gradient + AdamW, with optional
microbatch gradient accumulation and a cast of the gradients to
``grad_dtype`` (PyTorch port of ``repro.training.train_step``).

The step runs eagerly: the reference jits it, and a captured train step is
a later item (ROADMAP §A).  It returns its metrics as tensors on the
parameters' device and pulls nothing to the host; the caller pulls the loss
when it prints it.

Under a mesh (``sharding_ctx``, the parameters and the AdamW state this
rank's blocks: ``init_params(mesh=)``, ``shard_params`` or
``CheckpointManager.restore(mesh=)``) every rank calls the step with the
same global batch, as the reference's jitted step takes it: each
microbatch is a global slice of it, whose lanes the loss takes
(``lm_loss`` runs this rank's lanes, or all of them where ``data`` does
not divide the microbatch); the gradients are this rank's blocks, the
``grad_dtype`` cast applies to them, and ``adamw_update`` clips by the
norm over every block (``axes`` / ``shapes``) and updates the blocks.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from .optimizer import AdamWState, adamw_update, tree_leaves, tree_map


def make_train_step(loss_fn: Callable[[Any, Dict], torch.Tensor], *,
                    lr: float = 1e-3, weight_decay: float = 0.01,
                    max_grad_norm: float = 1.0, accum_steps: int = 1,
                    grad_dtype: Optional[str] = None, axes: Any = None,
                    shapes: Any = None) -> Callable:
    """loss_fn(params, batch) -> scalar tensor.

    Returns step(params, opt_state, batch) -> (params, opt_state, metrics)
    with metrics ``{"loss", "grad_norm"}``.  The gradient is
    ``torch.autograd.grad`` with respect to the floating leaves of
    ``params`` (non-floating leaves get none).  With accum_steps > 1 every
    array in ``batch`` is split along its leading axis into ``accum_steps``
    microbatches, run one after another; their gradients are summed in f32
    and divided, and so are their losses, as the reference's ``lax.scan``
    does.  ``grad_dtype`` (e.g. "bfloat16") casts the gradients before the
    update (round to nearest even, as JAX's cast).  Nothing is updated in
    place: the step returns new parameters and state.  ``axes`` /
    ``shapes`` (the parameters' logical axes and global shapes) place the
    gradients for the global norm under a mesh (``adamw_update``).
    """

    def grads_of(params, batch):
        live = tree_map(lambda p: p.detach().requires_grad_(True)
                        if p.is_floating_point() else p, params)
        leaves = [p for p in tree_leaves(live) if p.requires_grad]
        with torch.enable_grad():
            loss = loss_fn(live, batch)
            # a leaf the loss does not reach gets zeros, as under JAX
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        by_leaf = {id(p): g for p, g in zip(leaves, grads)}
        return loss.detach(), tree_map(lambda p: by_leaf.get(id(p)), live)

    def step(params, opt_state: AdamWState, batch: Dict):
        if accum_steps == 1:
            loss, grads = grads_of(params, batch)
        else:
            loss, grads = 0.0, None
            for i in range(accum_steps):
                micro = {k: v.reshape((accum_steps, v.shape[0] // accum_steps)
                                      + v.shape[1:])[i]
                         for k, v in batch.items()}
                ls, g = grads_of(params, micro)
                loss = loss + ls
                if grads is None:
                    grads = tree_map(lambda x: x.float(), g)
                else:
                    tree_map(lambda a, x: a.add_(x), grads, g)
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = loss / accum_steps
        if grad_dtype is not None:
            dt = getattr(torch, grad_dtype)          # e.g. torch.bfloat16
            grads = tree_map(lambda g: g.to(dt) if g.is_floating_point()
                             else g, grads)
        params, opt_state, om = adamw_update(
            params, grads, opt_state, lr=lr, weight_decay=weight_decay,
            max_grad_norm=max_grad_norm, axes=axes, shapes=shapes)
        return params, opt_state, {"loss": loss, **om}

    return step


__all__ = ["make_train_step"]
