"""Transformer parameters as torch tensors, in the JAX package's layout.

``params`` is a dict: ``embed`` (V, d), ``ln_f`` (d,), optional ``lm_head``
(d, V), and ``layers`` — per-layer weights stacked along a leading (L, ...)
axis in ``x @ W`` orientation (``wq`` (L, d, H*dh), ``wo`` (L, H*dh, d),
``w_gate``/``w_up`` (L, d, F), ``w_down`` (L, F, d), ``ln1``/``ln2``
(L, d), and ``bq``/``bk``/``bv`` with QKV bias).  An MoE config has in
place of the dense FFN ``router`` (L, d, E), ``we_gate``/``we_up``
(L, E, d, F), ``we_down`` (L, E, F, d) and, with shared experts,
``ws_gate``/``ws_up`` (L, d, F·n_shared) and ``ws_down`` (L, F·n_shared, d).

Under a mesh (``init_params(mesh=)``, ``shard_params``) each tensor lies
as ``distributed.sharding.placement`` of its ``param_logical_axes`` puts
it: the expert tensors ``we_*`` are this rank's E/ep block along
``model``, every other tensor is whole on every rank (ROADMAP A16b).
"""
from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from repro_torch.distributed.sharding import Mesh, placement
from repro_torch.models.transformer import (Params, TransformerConfig,
                                            param_logical_axes)

Device = Union[str, torch.device, None]


def resolve_device(device: Device) -> torch.device:
    """``None`` means the card: the port's entry points run on CUDA unless
    the caller asks for the CPU, and never fall back to it on their own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU (its kernels then take their plain PyTorch versions)")
    return dev


def tree_to_torch(tree: Mapping[str, Any], dev: torch.device):
    """A nested dict of numpy arrays (bf16 through ``ml_dtypes``) as torch
    tensors of the same shapes and dtypes on ``dev``, keys kept."""
    if isinstance(tree, Mapping):
        return {k: tree_to_torch(v, dev) for k, v in tree.items()}
    a = np.asarray(tree)
    if a.dtype.name == "bfloat16":     # ml_dtypes: no torch.from_numpy
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(a.copy()).to(dev)


def params_from_jax(cfg: TransformerConfig, tree: Mapping[str, Any],
                    device: Device = None) -> Params:
    """The JAX ``init_params`` pytree, as numpy arrays (e.g.
    ``jax.tree.map(np.asarray, params)``), converted to torch tensors of
    the same shapes and dtypes on ``device``."""
    params = tree_to_torch(tree, resolve_device(device))
    if set(params["layers"]) != set(_layer_shapes(cfg)):
        raise ValueError("pytree layer keys "
                         f"{sorted(params['layers'])} do not match the "
                         f"config's {sorted(_layer_shapes(cfg))}")
    return params


def _layer_shapes(cfg: TransformerConfig):
    d, dh, H, K, L = (cfg.d_model, cfg.dh, cfg.n_heads, cfg.n_kv_heads,
                      cfg.n_layers)
    shapes = {"ln1": (L, d), "ln2": (L, d), "wq": (L, d, H * dh),
              "wk": (L, d, K * dh), "wv": (L, d, K * dh),
              "wo": (L, H * dh, d)}
    if cfg.moe:
        E, F = cfg.n_experts, cfg.moe_d_ff
        shapes.update(router=(L, d, E), we_gate=(L, E, d, F),
                      we_up=(L, E, d, F), we_down=(L, E, F, d))
        if cfg.n_shared_experts:
            Fs = F * cfg.n_shared_experts
            shapes.update(ws_gate=(L, d, Fs), ws_up=(L, d, Fs),
                          ws_down=(L, Fs, d))
    else:
        shapes.update(w_gate=(L, d, cfg.d_ff), w_up=(L, d, cfg.d_ff),
                      w_down=(L, cfg.d_ff, d))
    if cfg.qkv_bias:
        shapes.update(bq=(L, H * dh), bk=(L, K * dh), bv=(L, K * dh))
    return shapes


def _local(block, a: torch.Tensor) -> torch.Tensor:
    """``a`` (whole) as this rank's block under ``block`` (a ``placement``
    or None): a copy where the placement splits it, else ``a`` itself."""
    if block is None or not block.axes():
        return a
    return block.local(a).clone()


def shard_params(cfg: TransformerConfig, params: Params, mesh: Mesh
                 ) -> Params:
    """Whole parameters (e.g. from ``params_from_jax`` or a checkpoint) as
    this rank's, each leaf by ``placement`` of its ``param_logical_axes``:
    the expert tensors sliced to the rank's E/ep block (copies), the rest
    shared with ``params``."""
    axes = param_logical_axes(cfg)
    out = {k: _local(placement(mesh, axes[k], a.shape), a)
           for k, a in params.items() if k != "layers"}
    out["layers"] = {k: _local(placement(mesh, axes["layers"][k], a.shape),
                               a) for k, a in params["layers"].items()}
    return out


def init_params(cfg: TransformerConfig, seed: int = 0,
                device: Device = None, mesh: Optional[Mesh] = None
                ) -> Params:
    """Random parameters made on ``device`` itself, with the distributions
    of the JAX ``init_params``: weights N(0, 0.02^2) drawn in f32 and cast
    to ``param_dtype``, norm scales 1, biases 0.  The numbers differ from
    JAX's for the same seed (another generator); tests that compare the two
    frameworks convert JAX's parameters with ``params_from_jax``.

    The stacked expert tensors (``we_*``, (L, E, ...)) are drawn one layer
    at a time into the ``param_dtype`` tensor, so that their f32 scratch
    is one layer's (0.81 GB at Qwen3-MoE's width) and not the whole
    tensor's (38.7 GB); every other tensor is drawn whole, in
    ``_layer_shapes`` order.  ``device="meta"`` gives the same shapes and
    dtypes with no draws (the counterpart of ``jax.eval_shape(init_params)``,
    for the dry-run).

    With ``mesh``, each tensor keeps only this rank's block under
    ``placement`` (the expert tensors' E/ep block; the rest whole): every
    layer is drawn whole, as without a mesh, and sliced, so the block
    holds the bits of the single-device tensor."""
    dev = resolve_device(device)
    pd = cfg.pdtype
    axes = param_logical_axes(cfg)

    def block(ax, shape):
        return placement(mesh, ax, shape) if mesh is not None else None
    if dev.type != "meta":
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(seed))

    def draw(shape):                     # N(0, 0.02^2) in f32
        if dev.type == "meta":
            return torch.empty(shape, dtype=torch.float32, device=dev)
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.float32).mul_(0.02)

    def normal(shape):
        return draw(shape).to(pd)

    layers = {}
    for name, shape in _layer_shapes(cfg).items():
        b = block(axes["layers"][name], shape)
        if name in ("ln1", "ln2"):
            layers[name] = _local(b, torch.ones(shape, dtype=pd, device=dev))
        elif name in ("bq", "bk", "bv"):
            layers[name] = _local(b, torch.zeros(shape, dtype=pd,
                                                 device=dev))
        elif name.startswith("we_"):
            layers[name] = torch.empty(b.shard_shape(shape) if b else shape,
                                       dtype=pd, device=dev)
            for i in range(shape[0]):
                w = draw(shape[1:])
                if b is not None:       # this rank's block of the layer
                    w = b.local(w[None])[0]
                layers[name][i].copy_(w)
                del w       # before the next layer's draw: one f32 scratch
        else:
            layers[name] = _local(b, normal(shape))
    V, d = cfg.vocab_size, cfg.d_model
    params: Params = {
        "embed": _local(block(axes["embed"], (V, d)), normal((V, d))),
        "ln_f": torch.ones((d,), dtype=pd, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = _local(block(axes["lm_head"], (d, V)),
                                   normal((d, V)))
    return params


__all__ = ["init_params", "params_from_jax", "resolve_device",
           "tree_to_torch", "shard_params"]
