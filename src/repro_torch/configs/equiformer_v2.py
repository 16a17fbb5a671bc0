"""equiformer-v2 [arXiv:2306.12059]: 12 layers, 128 sphere channels,
l_max=6, m_max=2, 8 heads, SO(2)-eSCN convolutions (the numbers of
``repro.configs.equiformer_v2``).

Cells: full_graph_sm (Cora-like 2,708/10,556 d=1433), minibatch_lg
(Reddit-like sampled subgraph, fanout 15-10 from batch_nodes=1024),
ogb_products (2,449,029/61,859,140 d=100), molecule (128×30-node graphs).
Positions for the non-geometric graphs are synthetic (see DESIGN.md).

Every cell is a train cell (``train_cell``: the step and its batch's
inputs); ``model_flops`` and ``bytes_floor`` are the reference's cost
figures for one step.  The reference's ``Cell`` objects, abstract shapes,
logical axes and the chunked path's cost corrections belong to its
dry-run (ROADMAP A19).
"""
from __future__ import annotations

from repro_torch.configs.recsys_common import Input, TrainCell
from repro_torch.models.gnn import equiformer as model
from repro_torch.training.train_step import make_train_step

ARCH = "equiformer-v2"
SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


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
    the batch's inputs at the cell's sizes (``cfg`` defaults to
    ``full_config(shape)``; the inputs' sizes are the cell's whatever
    ``cfg`` is)."""
    c = CELLS[shape]
    cfg = cfg or full_config(shape)
    N, E = c["n_nodes"], c["n_edges"]
    inputs = [Input("node_feat", (N, c["d_feat"]), "float32"),
              Input("positions", (N, 3), "float32"),
              Input("edges", (E, 2), "int32"),
              Input("edge_mask", (E,), "bool")]
    if shape == "molecule":
        inputs += [Input("graph_ids", (N,), "int32"),
                   Input("energies", (c["n_graphs"],), "float32")]
        loss = model.energy_loss
    else:
        inputs += [Input("labels", (N,), "int32")]
        loss = model.node_class_loss
    return TrainCell(make_train_step(lambda p, b: loss(cfg, p, b), lr=3e-4,
                                     grad_dtype="bfloat16"), tuple(inputs))


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


__all__ = ["ARCH", "SHAPES", "CELLS", "full_config", "smoke_config",
           "train_cell", "model_flops", "bytes_floor", "pad_to_multiple"]
