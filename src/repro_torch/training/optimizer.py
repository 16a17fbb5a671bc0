"""AdamW + global-norm clipping on nested dicts of tensors (PyTorch port of
``repro.training.optimizer``).

Plain functions under ``torch.no_grad()``, in the reference's order of
operations and rounding: bias corrections in f32 from an int32 step,
``delta = mh / (sqrt(vh) + eps) + wd * p``, and ``None`` moments for a
non-floating leaf.  Not ``torch.optim.AdamW``: the state is the reference's
``AdamWState(step, mu, nu)``, so a checkpoint's keys (``o/0``, ``o/1/...``,
``o/2/...``) are the reference's.

The update is out of place: it returns new tensors and never writes the
ones it was given, as the JAX step (which donates nothing) does.  It
writes the new tensors ``UPDATE_CHUNK`` elements at a time, so that its
temporaries are a chunk's, not a large leaf's.
``run_with_timeout`` abandons a slow step on its thread and retries from
the same parameters; an update in place could then be applied twice.

Under a mesh (``sharding_ctx``) the parameters, gradients and moments are
this rank's blocks (``distributed.sharding.placement``), so the moments
are placed like the parameters (ZeRO-style sharding of the optimizer
state, as the reference's jit gives it).  The update is elementwise on
the blocks; only the global norm crosses ranks: each leaf's sum of
squares is summed over the ranks that hold distinct blocks of it, a
replicated leaf counted once (``adamw_update(axes=, shapes=)``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.distributed.sharding import (active_mesh, active_rules,
                                              block_sharding)


# Elements of a leaf that the update takes at a time: its temporaries (the
# f32 gradient, the bias-corrected step) are a chunk's (256 MB in f32), not
# a large leaf's (a recommender's table).
UPDATE_CHUNK = 1 << 26


class AdamWState(NamedTuple):
    step: torch.Tensor          # () int32
    mu: Any
    nu: Any


def tree_leaves(tree: Any) -> List[Any]:
    """The leaves in ``jax.tree.leaves`` order (dict keys sorted, ``None``
    leaves skipped)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, the structure kept; ``None`` leaves of ``tree`` stay
    ``None``."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        vals = [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    return None if tree is None else fn(tree, *rest)


def adamw_init(params: Any) -> AdamWState:
    zeros = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32)
                     if p.is_floating_point() else None, params)
    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return AdamWState(step=step, mu=zeros, nu=tree_map(torch.zeros_like,
                                                       zeros))


def _placed(grads: Any, axes: Any, shapes: Any, path: str = ""):
    """(key, gradient, logical axes, global shape) of each leaf, in
    ``tree_leaves`` order; ``axes`` and ``shapes`` are trees beside
    ``grads`` (``param_logical_axes`` / ``param_shapes``)."""
    if isinstance(grads, dict):
        for k in sorted(grads):
            yield from _placed(grads[k], axes[k], shapes[k], f"{path}{k}/")
    elif grads is not None:
        yield path[:-1], grads, axes, shapes


def split_axes(grads: Any, axes: Any, shapes: Any) -> List[Tuple[str, ...]]:
    """Under the active mesh, the mesh axes (of size > 1) that split each
    leaf of ``grads`` (in ``tree_leaves`` order), from its ``placement``
    by its logical ``axes`` and global ``shapes`` under the active rules;
    a leaf that is not this rank's block raises, naming it."""
    mesh, rules = active_mesh(), active_rules()
    out = []
    for key, g, ax, shape in _placed(grads, axes, shapes):
        sh = block_sharding(f"gradient {key!r}", g.shape, ax, shape, mesh,
                            rules)
        out.append(tuple(a for a in sh.axes() if mesh.shape[a] > 1))
    return out


def _norm_and_scale(grads: Any, max_norm: float,
                    split: Optional[List[Tuple[str, ...]]] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 global norm (a Python sum of per-leaf sums of squares, in
    leaf order) and the clip factor ``min(1, max_norm / max(gn, 1e-12))``,
    both 0-d tensors on the card (no host sync).  ``split`` (under a mesh,
    ``split_axes``): the leaves are summed in groups of the axes that
    split them, and each group's sum over those axes' ranks (one f32
    all-reduce a group), so a split leaf counts all of its blocks and a
    replicated one counts once; every rank gets the same norm."""
    leaves = tree_leaves(grads)
    if split is None:
        gn = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                            for g in leaves))
    else:
        groups: Dict[Tuple[str, ...], torch.Tensor] = {}
        for g, ax in zip(leaves, split):
            sq = torch.sum(torch.square(g.float()))
            groups[ax] = groups[ax] + sq if ax in groups else sq
        mesh = active_mesh()
        gn = torch.sqrt(sum(mesh.all_reduce(s, "sum", ax) if ax else s
                            for ax, s in groups.items()))
    return gn, torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)


@torch.no_grad()
def clip_by_global_norm(grads: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale every gradient by the clip factor; the result is f32, as JAX
    promotes a bf16 gradient times the f32 factor."""
    gn, scale = _norm_and_scale(grads, max_norm)
    return tree_map(lambda g: g.float() * scale, grads), gn


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: AdamWState, *,
                 lr: float = 1e-3, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 max_grad_norm: Optional[float] = 1.0, axes: Any = None,
                 shapes: Any = None
                 ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step; returns (new params, new state, {"grad_norm"}).  The
    clip factor is applied leaf by leaf inside the update (the values of
    ``clip_by_global_norm`` without holding every clipped leaf at once).
    Under a mesh the global norm needs each leaf's placement: ``axes``
    and ``shapes``, its logical axes and global shape in trees beside
    ``params`` (``param_logical_axes(cfg)``, ``param_shapes(cfg)``);
    without them it raises.  Without a mesh they are not read."""
    split = None
    if max_grad_norm is not None and active_mesh() is not None:
        if axes is None or shapes is None:
            raise ValueError("adamw_update under a mesh clips by the global "
                             "norm of the gradients' blocks: pass axes= and "
                             "shapes= (param_logical_axes / param_shapes)")
        split = split_axes(grads, axes, shapes)
    if max_grad_norm is not None:
        gn, scale = _norm_and_scale(grads, max_grad_norm, split)
    else:
        gn = scale = None
    step = state.step + 1
    bc1 = 1.0 - torch.pow(b1, step.float())
    bc2 = 1.0 - torch.pow(b2, step.float())

    def upd(p, g, m, v):
        """(new p, m, v): new tensors, written a chunk of UPDATE_CHUNK
        elements at a time (a small leaf is one chunk)."""
        if g is None or m is None:
            return p, m, v
        out = (torch.empty_like(p), torch.empty_like(m), torch.empty_like(v))
        src = [t.reshape(-1) for t in (p, g, m, v)]
        dst = [t.view(-1) for t in out]
        for i in range(0, p.numel(), UPDATE_CHUNK):
            upd_into(*(t[i:i + UPDATE_CHUNK] for t in src),
                     [t[i:i + UPDATE_CHUNK] for t in dst])
        return out

    def upd_into(p, g, m, v, out):
        """One chunk's new p, m, v, written into ``out``'s tensors."""
        g32 = g.float() if scale is None else g.float() * scale
        m = torch.mul(m, b1, out=out[1])
        m += g32 * (1 - b1)
        v = torch.mul(v, b2, out=out[2])
        v += torch.square(g32).mul_(1 - b2)
        del g32
        delta = torch.sqrt(v / bc2)
        delta += eps
        delta = (m / bc1).div_(delta)
        p32 = p.float()
        delta += p32 * weight_decay
        delta *= lr
        if out[0].dtype == torch.float32:
            torch.sub(p32, delta, out=out[0])
        else:
            out[0].copy_(p32 - delta)

    def walk(p, g, m, v):          # -> (new p, new m, new v) subtrees
        if isinstance(p, dict):
            outs = {k: walk(p[k], g[k], m[k], v[k]) for k in p}
            return tuple({k: o[i] for k, o in outs.items()}
                         for i in range(3))
        return upd(p, g, m, v)

    new_p, new_m, new_v = walk(params, grads, state.mu, state.nu)
    return (new_p, AdamWState(step=step, mu=new_m, nu=new_v),
            {"grad_norm": gn if gn is not None
             else torch.zeros((), device=step.device)})


__all__ = ["AdamWState", "adamw_init", "adamw_update", "clip_by_global_norm",
           "split_axes", "tree_leaves", "tree_map"]
