"""Recommender models (PyTorch port of ``repro.models.recsys``): scoring
paths and losses with their gradients; the Wide & Deep bags run in the
fused EmbeddingBag kernel on the card, whose ``autograd.Function`` gives
the tables their gradient."""
from typing import Any, Mapping

from repro_torch.models.params import Device, resolve_device, tree_to_torch
from . import bert4rec, embedding, sasrec, two_tower, wide_deep


def recsys_params_from_jax(tree: Mapping[str, Any], device: Device = None):
    """A reference recsys parameter tree (nested dict of numpy arrays, e.g.
    ``jax.tree.map(np.asarray, params)``) as the port's tree: the same keys
    and layouts (Wide & Deep's stacked (F, V, D) tables, the encoders'
    ``blk{b}`` sub-dicts) on ``device`` (None: the card)."""
    return tree_to_torch(tree, resolve_device(device))


__all__ = ["bert4rec", "embedding", "sasrec", "two_tower", "wide_deep",
           "recsys_params_from_jax"]
