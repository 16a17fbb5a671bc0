"""Shared cell shapes of the recsys archs (the numbers of
``repro.configs.recsys_common``).

Shapes: train_batch 65,536 · serve_p99 512 · serve_bulk 262,144 ·
retrieval_cand (batch=1 vs 1,000,000 candidates).  Each arch's config module
gives every serve cell as a plain function and its inputs' shapes
(``serve_cell``); the reference's ``Cell`` objects, abstract shapes and
shardings belong to its dry-run (ROADMAP A19), and its train cells to
training (A17).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

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


def check_serve_shape(shape: str) -> None:
    if shape not in SERVE_SHAPES:
        raise ValueError(f"{shape!r} is not a serve cell (have "
                         f"{SERVE_SHAPES}; train_batch waits for ROADMAP A17)")


__all__ = ["SHAPES", "SERVE_SHAPES", "BATCHES", "Input", "ServeCell",
           "check_serve_shape"]
