"""Shared cell shapes of the recsys archs (the numbers of
``repro.configs.recsys_common``).

Shapes: train_batch 65,536 · serve_p99 512 · serve_bulk 262,144 ·
retrieval_cand (batch=1 vs 1,000,000 candidates).  Each arch's config module
gives every serve cell as a plain function and its inputs' shapes
(``serve_cell``), and its train_batch cell as a train step and its batch's
shapes (``train_cell``); the reference's ``Cell`` objects, abstract shapes
and shardings belong to its dry-run (ROADMAP A19).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

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


__all__ = ["SHAPES", "SERVE_SHAPES", "BATCHES", "Input", "ServeCell",
           "TrainCell", "check_serve_shape", "train_cell"]
