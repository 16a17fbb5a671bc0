"""Recommender models (PyTorch port of ``repro.models.recsys``): scoring
paths and losses with their gradients; the Wide & Deep bags run in the
fused EmbeddingBag kernel on the card, whose ``autograd.Function`` gives
the tables their gradient."""
from typing import Any, Mapping

from repro_torch.distributed.sharding import Mesh, active_rules, placement
from repro_torch.models.params import Device, resolve_device, tree_to_torch
from . import bert4rec, embedding, sasrec, two_tower, wide_deep
from .common import keep


def recsys_params_from_jax(tree: Mapping[str, Any], device: Device = None):
    """A reference recsys parameter tree (nested dict of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tree: the same keys
    and layouts (Wide & Deep's stacked (F, V, D) tables, the encoders'
    ``blk{b}`` sub-dicts) on ``device`` (None: the card)."""
    return tree_to_torch(tree, resolve_device(device))


def shard_params(params: Mapping[str, Any], axes: Mapping[str, Any],
                 mesh: Mesh):
    """Whole recsys parameters (e.g. ``recsys_params_from_jax``) as this
    rank's blocks, each leaf by ``placement`` of its logical ``axes`` (the
    model's ``param_logical_axes``) under the active rules: the tables'
    rows and the encoders' "tensor" dims cut (copies), the rest shared."""
    if isinstance(params, Mapping):
        return {k: shard_params(v, axes[k], mesh) for k, v in params.items()}
    return keep(placement(mesh, axes, tuple(params.shape), active_rules()),
                params)


__all__ = ["bert4rec", "embedding", "sasrec", "two_tower", "wide_deep",
           "recsys_params_from_jax", "shard_params"]
