"""equiformer-v2 [arXiv:2306.12059]: 12 layers, 128 sphere channels,
l_max=6, m_max=2, 8 heads, SO(2)-eSCN convolutions (the numbers of
``repro.configs.equiformer_v2``).

Cells: full_graph_sm (Cora-like 2,708/10,556 d=1433), minibatch_lg
(Reddit-like sampled subgraph, fanout 15-10 from batch_nodes=1024),
ogb_products (2,449,029/61,859,140 d=100), molecule (128×30-node graphs).
Positions for the non-geometric graphs are synthetic (see DESIGN.md).

Every cell is a train cell (``train_cell``: the step and its batch's
inputs); ``model_flops`` and ``bytes_floor`` are the reference's cost
figures for one step, and ``build_cell`` the dry-run ``Cell`` with the
reference's meta, the chunked path's cost corrections included.  Under a
mesh the cell's parameters and AdamW state are the rank's blocks (the
SO(2) and FFN weights' "tensor" dims over ``model``), the inputs whole
(every rank passes them; the model takes its rows of the edges and its
block of the nodes), and the cell carries the reference's logical axes
and ``DEFAULT_RULES``.
"""
from __future__ import annotations

from repro_torch.configs.common import Cell, pad_to_multiple
from repro_torch.configs.recsys_common import (Input, TrainCell,
                                               train_dryrun_cell)
from repro_torch.distributed.sharding import DEFAULT_RULES
from repro_torch.models.gnn import equiformer as model
from repro_torch.training.train_step import make_train_step

ARCH = "equiformer-v2"
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


# (n_nodes, n_edges_padded, d_feat, n_out, node_level, edge_chunk)
CELLS = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=pad_to_multiple(10556, 512),
                          d_feat=1433, n_out=7, node_level=True,
                          edge_chunk=0),
    # sampled subgraph caps for batch_nodes=1024, fanout 15-10
    "minibatch_lg": dict(n_nodes=1024 + 1024 * 15 + 1024 * 150,
                         n_edges=1024 * 15 + 1024 * 15 * 10,
                         d_feat=602, n_out=41, node_level=True,
                         edge_chunk=0),
    # E is no multiple of edge_chunk: forward runs it on the dense path
    "ogb_products": dict(n_nodes=pad_to_multiple(2_449_029, 512),
                         n_edges=pad_to_multiple(61_859_140, 512),
                         d_feat=100, n_out=47, node_level=True,
                         edge_chunk=120832),
    "molecule": dict(n_nodes=128 * 30, n_edges=128 * 64, d_feat=64,
                     n_out=1, node_level=False, edge_chunk=0,
                     n_graphs=128),
}


def full_config(shape: str = "molecule", fast: bool = False
                ) -> model.EquiformerConfig:
    c = CELLS[shape]
    return model.EquiformerConfig(
        n_layers=12, channels=128, l_max=6, m_max=2, n_heads=8,
        d_feat_in=c["d_feat"], n_rbf=32, n_out=c["n_out"],
        node_level=c["node_level"], edge_chunk=c["edge_chunk"],
        scan_layers=fast, remat=True, dtype="bfloat16")


def smoke_config() -> model.EquiformerConfig:
    return model.EquiformerConfig(n_layers=2, channels=16, l_max=2, m_max=1,
                                  n_heads=4, d_feat_in=8, n_rbf=8, n_out=3)


def train_cell(shape: str, cfg: model.EquiformerConfig = None) -> TrainCell:
    """The reference's train step for ``shape`` (lr 3e-4, bf16 gradients):
    ``energy_loss`` for molecule, ``node_class_loss`` for the others, and
    the batch's inputs at the cell's sizes with the reference's logical
    axes (``cfg`` defaults to ``full_config(shape)``; the inputs' sizes
    are the cell's whatever ``cfg`` is).  Under a mesh the global norm
    runs over the blocks of ``param_logical_axes`` / ``param_shapes``."""
    c = CELLS[shape]
    cfg = cfg or full_config(shape)
    N, E = c["n_nodes"], c["n_edges"]
    inputs = [Input("node_feat", (N, c["d_feat"]), "float32"),
              Input("positions", (N, 3), "float32"),
              Input("edges", (E, 2), "int32", ("edges", None)),
              Input("edge_mask", (E,), "bool", ("edges",))]
    if shape == "molecule":
        inputs += [Input("graph_ids", (N,), "int32"),
                   Input("energies", (c["n_graphs"],), "float32")]
        loss = model.energy_loss
    else:
        inputs += [Input("labels", (N,), "int32")]
        loss = model.node_class_loss
    return TrainCell(make_train_step(
        lambda p, b: loss(cfg, p, b), lr=3e-4, grad_dtype="bfloat16",
        axes=model.param_logical_axes(cfg), shapes=model.param_shapes(cfg)),
        tuple(inputs))


def build_cell(shape: str, mesh=None) -> Cell:
    """The dry-run cell: one train step over meta parameters, their AdamW
    state and the batch, with the reference's meta.  ogb_products gets the
    edge-chunk corrections although its E is no multiple of its
    edge_chunk and it runs dense, as in the reference (ROADMAP §C);
    ``launch.roofline`` adds no correction (the port's trace runs every
    chunk).  With ``mesh`` (a ``TracedMesh`` rank) the arguments are that
    rank's (``train_dryrun_cell``): the parameters and AdamW state its
    blocks under ``DEFAULT_RULES``, the inputs whole."""
    c = CELLS[shape]
    cfg = full_config(shape)
    N, E = c["n_nodes"], c["n_edges"]
    meta = {"n_params": cfg.n_params(), "n_active_params": cfg.n_params(),
            "model_flops": model_flops(cfg, E), "tokens_per_step": N,
            "batch": N, "weight_bytes": cfg.n_params() * 4,
            "n_edges": E, "bytes_floor": bytes_floor(cfg, N, E)}
    if cfg.edge_chunk and E > cfg.edge_chunk:
        # the reference's correction for its edge-chunk lax.scan body,
        # which XLA counts once (x4/3: forward-only to remat'd fwd+bwd)
        nc = E // cfg.edge_chunk
        fwd = model_flops(cfg, E) / 3
        meta["flops_correction"] = (nc - 1) / nc * fwd * 4
        meta["bytes_correction"] = (nc - 1) / nc * (
            4.0 * E * cfg.lsq * cfg.channels * 2 * 6)
    return train_dryrun_cell(ARCH, shape, cfg, model, train_cell(shape, cfg),
                             meta, p_axes=model.param_logical_axes(cfg),
                             rules=DEFAULT_RULES, mesh=mesh)


def model_flops(cfg: model.EquiformerConfig, E: int) -> int:
    """A train step's FLOPs (the reference's ``_flops``): per edge and
    layer the Wigner rotations in and out and the SO(2) products, x3 for
    the forward and backward."""
    C, L = cfg.channels, cfg.l_max
    rot = 2 * 2 * cfg.lsq * cfg.lsq * C
    so2 = 2 * (2 * (L + 1) * C) * ((L + 1) * C)
    for m in range(1, cfg.m_max + 1):
        nl = L + 1 - m
        so2 += 2 * 2 * (2 * nl * C) * (nl * C)
    return cfg.n_layers * E * (rot + so2) * 3


def bytes_floor(cfg: model.EquiformerConfig, N: int, E: int) -> float:
    """A train step's HBM bytes floor (the reference's
    ``meta["bytes_floor"]``): the parameter streams, plus the per-edge
    message traffic (rotate in/out and SO(2) in/out, forward, remat and
    backward) and the per-node traffic of every layer."""
    return float(cfg.n_params() * 16
                 + cfg.n_layers * E * cfg.lsq * cfg.channels * 2 * 6 * 4
                 + cfg.n_layers * N * cfg.lsq * cfg.channels * 2 * 8)


__all__ = ["ARCH", "SHAPES", "CELLS", "full_config",
           "smoke_config", "train_cell", "build_cell", "model_flops",
           "bytes_floor", "pad_to_multiple"]
