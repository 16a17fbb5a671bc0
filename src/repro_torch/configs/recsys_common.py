"""Shared cell shapes of the recsys archs (the numbers of
``repro.configs.recsys_common``).

Shapes: train_batch 65,536 · serve_p99 512 · serve_bulk 262,144 ·
retrieval_cand (batch=1 vs 1,000,000 candidates).  Each arch's config module
gives every serve cell as a plain function and its inputs' shapes
(``serve_cell``), and its train_batch cell as a train step and its batch's
shapes (``train_cell``), and its cell meta (``cell_meta``); ``build_cell``
makes either a dry-run ``Cell`` over meta tensors (the reference's
``serve_cell`` / ``train_cell``).  The port does not place the recsys
cells on a mesh yet (ROADMAP A16b 6.3): under one each rank holds every
argument whole and runs the whole cell, and the cell names the logical
axes the reference places there (``whole_axes``, from each config's
``WHOLE_AXES``).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

from repro_torch.configs.common import Cell, abstract
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_step import make_train_step

SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]
SERVE_SHAPES = ["serve_p99", "serve_bulk", "retrieval_cand"]
BATCHES = {"train_batch": 65536, "serve_p99": 512, "serve_bulk": 262144,
           "retrieval_cand": 1}


class Input(NamedTuple):
    """One argument of a serve cell: its name, shape and dtype name."""
    name: str
    shape: Tuple[int, ...]
    dtype: str


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


def train_cell(cfg, loss_fn: Callable, inputs: Tuple[Input, ...]
               ) -> TrainCell:
    """The reference's train step for ``loss_fn(cfg, params, batch)``: lr
    1e-3, bf16 gradients, the whole batch at once."""
    return TrainCell(make_train_step(lambda p, b: loss_fn(cfg, p, b),
                                     lr=1e-3, grad_dtype="bfloat16"), inputs)


def abstract_inputs(inputs: Tuple[Input, ...]) -> Tuple:
    """Meta tensors of the inputs' shapes and dtypes, in order."""
    return tuple(abstract(i.shape, i.dtype) for i in inputs)


def train_dryrun_cell(arch: str, shape: str, cfg, model, train: TrainCell,
                      meta: dict, whole_axes=()) -> Cell:
    """``train.step(params, opt_state, batch)`` over meta parameters, their
    AdamW state and the batch; ``whole_axes`` as ``Cell``'s."""
    params = model.init_params(cfg, device="meta")
    batch = dict(zip((i.name for i in train.inputs),
                     abstract_inputs(train.inputs)))
    return Cell(arch, shape, "train", train.step,
                (params, adamw_init(params), batch), meta,
                whole_axes=whole_axes)


def build_cell(mod, shape: str, mesh=None) -> Cell:
    """The dry-run cell of the recsys config module ``mod`` (its ``ARCH``,
    ``model``, ``full_config``, ``serve_cell``, ``train_cell``,
    ``cell_meta`` and ``WHOLE_AXES``): the train step at train_batch, else
    the serve function over meta parameters (``model.init_params(cfg,
    device="meta")``) and inputs.  Under ``mesh`` the arguments stay
    whole and the cell names the axes left so (ROADMAP A16b 6.3)."""
    cfg = mod.full_config()
    meta = mod.cell_meta(cfg, shape)
    whole = mod.WHOLE_AXES[shape] if mesh is not None else ()
    if shape == "train_batch":
        return train_dryrun_cell(mod.ARCH, shape, cfg, mod.model,
                                 mod.train_cell(cfg), meta, whole)
    serve = mod.serve_cell(shape, cfg)
    params = mod.model.init_params(cfg, device="meta")
    fn = lambda p, *a: serve.fn(cfg, p, *a)  # noqa: E731
    return Cell(mod.ARCH, shape, "score", fn,
                (params,) + abstract_inputs(serve.inputs), meta,
                whole_axes=whole)


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


__all__ = ["SHAPES", "SERVE_SHAPES", "BATCHES", "Input", "ServeCell",
           "TrainCell", "check_serve_shape", "train_cell", "abstract_inputs",
           "train_dryrun_cell", "build_cell", "sequence_meta"]
