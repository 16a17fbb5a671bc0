"""Training launcher of the PyTorch port for the LM archs, with the
reference's fault-tolerance loop: checkpoint/resume, preemption handling,
straggler timeout (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 40

runs on the card (``--device cuda``, the default; ``--smoke --device cpu``
trains a reduced config on the CPU).  The model trains through the
``dense`` attention backend, as the reference's does: the CUDA attention
kernels have no backward and refuse inputs that require grad.  A restart
with the same ``--ckpt-dir`` resumes from the latest checkpoint, whose
format is the reference's (``training/checkpoint.py``): either package
resumes the other's.  Checkpoints record the parameters' logical axes, as
the reference's do, so ``CheckpointManager.restore(mesh=)`` can place them
on any mesh.  SIGTERM checkpoints at the next step boundary and exits.

The step runs eagerly (the reference jits it).  A step syncs the host only
where it prints the loss and where it pulls a checkpoint.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch import configs as cfgreg
from repro_torch.models import transformer as tx
from repro_torch.models.transformer import TransformerConfig
from repro_torch.models.params import (init_params, resolve_device,
                                       tree_to_torch)
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import lm_train_batches
from repro_torch.training.fault_tolerance import (PreemptionHandler,
                                                  run_with_timeout)
from repro_torch.training.optimizer import adamw_init, tree_map
from repro_torch.training.train_step import make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--step-timeout", type=float, default=600.0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs on the CPU")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    """Train; returns the final ``params`` and ``opt`` state, the printed
    ``losses`` by step, the ``start`` step and the checkpoint timings
    (``restore_s``, ``pull_s`` of the last save, ``write_wait_s``) for
    callers in the same process."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    mod = cfgreg.get_arch(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    if not isinstance(cfg, TransformerConfig):
        raise SystemExit(f"{args.arch} is not an LM arch; recsys and GNN "
                         "archs train through their config's train_cell")
    cfg = dataclasses.replace(cfg, prefill_backend="dense")
    print(f"{args.arch}: {cfg.n_params()/1e6:.0f}M params")
    loss = lambda p, b: tx.lm_loss(cfg, p, b["tokens"], b["labels"])  # noqa: E731
    step = make_train_step(loss, lr=args.lr, accum_steps=args.accum)
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    params = init_params(cfg, seed=0, device=dev)
    opt = adamw_init(params)
    start, out = 0, {"losses": {}, "restore_s": None, "pull_s": None}
    if mgr.latest_step() is not None:
        t0 = time.perf_counter()
        state, start = mgr.restore({"p": params, "o": opt})
        del params, opt
        state = tree_map(lambda a: tree_to_torch(a, dev), state)
        params, opt = state["p"], state["o"]
        out["restore_s"] = time.perf_counter() - t0
        print(f"resumed from step {start}")
    handler = PreemptionHandler().install()
    axes = tx.param_logical_axes(cfg)
    batches = lm_train_batches(cfg.vocab_size, args.batch, args.seq,
                               seed=start)
    try:
        for i in range(start, args.steps):
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in next(batches).items()}
            params, opt, m = run_with_timeout(step, args.step_timeout,
                                              params, opt, b, retries=1)
            if (i + 1) % 10 == 0 or i == start:
                # the loss print: the step's one host sync when it prints
                out["losses"][i + 1] = float(m["loss"])  # repro-lint: disable=R1
                print(f"step {i+1}: loss {out['losses'][i + 1]:.4f}")
            if (i + 1) % args.ckpt_every == 0 or handler.preempted:
                t0 = time.perf_counter()
                # save pulls the state to host numpy: a sync, by design
                mgr.save(i + 1, {"p": params, "o": opt},  # repro-lint: disable=R1
                         logical_axes={"p": axes, "o": None},
                         blocking=handler.preempted)
                out["pull_s"] = time.perf_counter() - t0
            if handler.preempted:
                print("preempted — checkpointed, exiting for restart")
                break
        t0 = time.perf_counter()
        mgr.wait()
        out["write_wait_s"] = time.perf_counter() - t0
    finally:
        handler.uninstall()
    print(f"checkpoints: {mgr.all_steps()}")
    return dict(out, params=params, opt=opt, start=start)


if __name__ == "__main__":
    main()
