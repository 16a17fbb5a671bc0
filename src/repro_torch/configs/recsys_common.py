"""Shared cell shapes of the recsys archs (the numbers of
``repro.configs.recsys_common``).

Shapes: train_batch 65,536 · serve_p99 512 · serve_bulk 262,144 ·
retrieval_cand (batch=1 vs 1,000,000 candidates).  Each arch's config module
gives every serve cell as a plain function and its inputs' shapes and
logical axes (``serve_cell``), and its train_batch cell as a train step and
its batch's (``train_cell``), and its cell meta (``cell_meta``);
``build_cell`` makes either a dry-run ``Cell`` over meta tensors (the
reference's ``serve_cell`` / ``train_cell``).  Under a mesh the cell's
parameters are this rank's blocks (``init_params(mesh=)``: the tables'
rows over ``model``, SASRec's and BERT4Rec's projections on "tensor"),
the inputs whole (every rank passes them, and the models take their rows
of "batch" and "candidates"), and the cell carries the reference's
logical axes and ``DEFAULT_RULES``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

from repro_torch.configs.common import Cell, abstract, opt_state_axes
from repro_torch.distributed.sharding import DEFAULT_RULES, sharding_ctx
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import make_train_step

SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]
SERVE_SHAPES = ["serve_p99", "serve_bulk", "retrieval_cand"]
ROW = ("batch", None)              # an input's logical axes: rows on batch
BAG = ("batch", None, None)
BATCHES = {"train_batch": 65536, "serve_p99": 512, "serve_bulk": 262144,
           "retrieval_cand": 1}


class Input(NamedTuple):
    """One argument of a cell: its name, shape, dtype name and the
    reference's logical axes (None: every dim whole)."""
    name: str
    shape: Tuple[int, ...]
    dtype: str
    axes: Optional[Tuple[Optional[str], ...]] = None


class ServeCell(NamedTuple):
    """A serve cell: ``fn(cfg, params, *inputs)`` and its inputs, in order."""
    fn: Callable
    inputs: Tuple[Input, ...]


class TrainCell(NamedTuple):
    """A train cell: ``step(params, opt_state, batch)`` (``batch`` a dict
    of the named inputs) and the batch's inputs."""
    step: Callable
    inputs: Tuple[Input, ...]


def check_serve_shape(shape: str) -> None:
    if shape not in SERVE_SHAPES:
        raise ValueError(f"{shape!r} is not a serve cell (have "
                         f"{SERVE_SHAPES}; train_batch is the config's "
                         "train_cell)")


def train_cell(cfg, model, inputs: Tuple[Input, ...]) -> TrainCell:
    """The reference's train step for ``model.loss(cfg, params, batch)``:
    lr 1e-3, bf16 gradients, the whole batch at once; under a mesh the
    global norm over the blocks of ``model.param_logical_axes`` /
    ``param_shapes``."""
    return TrainCell(make_train_step(
        lambda p, b: model.loss(cfg, p, b), lr=1e-3, grad_dtype="bfloat16",
        axes=model.param_logical_axes(cfg), shapes=model.param_shapes(cfg)),
        inputs)


def abstract_inputs(inputs: Tuple[Input, ...]) -> Tuple:
    """Meta tensors of the inputs' shapes and dtypes, in order."""
    return tuple(abstract(i.shape, i.dtype) for i in inputs)


def train_dryrun_cell(arch: str, shape: str, cfg, model, train: TrainCell,
                      meta: dict, p_axes=None, rules=None,
                      mesh=None) -> Cell:
    """``train.step(params, opt_state, batch)`` over meta parameters, their
    AdamW state and the batch.  With ``p_axes`` (the parameters' logical
    axes) the cell carries the state's and the batch's ``axes`` and
    ``rules``.  With ``mesh`` (a ``TracedMesh`` rank) the parameters are
    that rank's blocks, placed under ``sharding_ctx(mesh, cell.rules)``,
    and the AdamW state is made from them; the batch stays whole and
    ``global_args`` the whole arguments."""
    params = model.init_params(cfg, device="meta")
    names = [i.name for i in train.inputs]
    batch = dict(zip(names, abstract_inputs(train.inputs)))
    axes = None if p_axes is None else (
        p_axes, opt_state_axes(p_axes),
        dict(zip(names, input_axes(train.inputs))))
    cell = Cell(arch, shape, "train", train.step,
                (params, adamw_init(params), batch), meta, axes=axes,
                rules=rules)
    if mesh is not None:
        with sharding_ctx(mesh, cell.rules):
            params = model.init_params(cfg, device="meta", mesh=mesh)
        cell.args = (params, adamw_init(params), batch)
    return cell


def input_axes(inputs: Tuple[Input, ...]) -> Tuple:
    return tuple(i.axes or (None,) * len(i.shape) for i in inputs)


def build_cell(mod, shape: str, mesh=None) -> Cell:
    """The dry-run cell of the recsys config module ``mod`` (its ``ARCH``,
    ``model``, ``full_config``, ``serve_cell``, ``train_cell`` and
    ``cell_meta``): the train step at train_batch, else the serve function
    over meta parameters (``model.init_params(cfg, device="meta")``) and
    inputs.  With ``mesh`` (a ``TracedMesh`` rank) the arguments are that
    rank's: the parameters its blocks, placed under ``sharding_ctx(mesh,
    cell.rules)``, the AdamW state made from them, the inputs whole;
    ``global_args`` stay the whole arguments."""
    cfg = mod.full_config()
    meta = mod.cell_meta(cfg, shape)
    p_axes = mod.model.param_logical_axes(cfg)
    rules = DEFAULT_RULES
    if shape == "train_batch":
        return train_dryrun_cell(mod.ARCH, shape, cfg, mod.model,
                                 mod.train_cell(cfg), meta, p_axes=p_axes,
                                 rules=rules, mesh=mesh)
    serve = mod.serve_cell(shape, cfg)
    fn = lambda p, *a: serve.fn(cfg, p, *a)  # noqa: E731
    cell = Cell(mod.ARCH, shape, "score", fn,
                (mod.model.init_params(cfg, device="meta"),)
                + abstract_inputs(serve.inputs), meta,
                axes=(p_axes,) + input_axes(serve.inputs), rules=rules)
    if mesh is not None:
        with sharding_ctx(mesh, rules):
            params = mod.model.init_params(cfg, device="meta", mesh=mesh)
        cell.args = (params,) + cell.args[1:]
    return cell


def sequence_meta(cfg, shape: str) -> dict:
    """The reference's cell meta of the sequence models (SASRec, BERT4Rec).
    Its ``model_flops`` charges the full-catalog head to the ranking cells
    too, which score their candidates and never compute it (a fault of the
    reference kept for parity, ROADMAP §C); ``launch.roofline``'s bound
    rests on the counted FLOPs instead."""
    B, d, S = BATCHES[shape], cfg.embed_dim, cfg.seq_len
    mult = 3 if shape == "train_batch" else 1
    blocks = cfg.n_blocks * (8 * d * d * S + 4 * S * S * d + 16 * d * d * S)
    head = 2 * S * d * cfg.n_items
    return {"n_params": cfg.n_params(), "n_active_params": cfg.n_params(),
            "model_flops": B * (blocks + head) * mult,
            "tokens_per_step": B * S, "batch": B,
            "weight_bytes": cfg.n_params() * 4,
            "bytes_floor": float(B * (d * S * 8) * 4 * mult
                                 + (cfg.n_params() * 16 if mult == 3 else 0))}


__all__ = ["SHAPES", "SERVE_SHAPES", "BATCHES", "ROW", "BAG", "Input",
           "ServeCell", "TrainCell", "check_serve_shape", "train_cell", "abstract_inputs",
           "input_axes", "train_dryrun_cell", "build_cell",
           "sequence_meta"]
