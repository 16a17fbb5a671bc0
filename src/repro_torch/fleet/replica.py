"""EngineReplica — one ServingEngine behind a uniform command surface (the
PyTorch port's copy of ``repro.fleet.replica``).

The router and gossip coordinator speak to replicas through a small
message-shaped API (submit / step / drain / queue_depth / result / stats /
draft-state ops) so the same fleet code drives two execution modes:

  * ``mode="inproc"`` — the engine lives in this process.  Deterministic
    and cheap: tests and CI smokes run whole fleets in one interpreter,
    and bit-identity against a single-replica reference is exact.
  * ``mode="subprocess"`` — the engine lives in a spawned worker process
    (its own device context), commands travel over a pipe.  The builder
    callable must be picklable (a module-level function or
    ``functools.partial`` of one); the engine is constructed inside the
    child, so device buffers never cross the process boundary: on the card
    the child makes its own CUDA context, session and captured graphs, and
    a builder that leaves ``device`` at None raises there without a card,
    as every entry point of the port does.  ``close`` waits for the child
    to exit, which frees its device memory.

Results and stats cross the boundary as plain dicts — the same shapes the
in-process mode returns, so callers never branch on the mode.
"""
from __future__ import annotations

import multiprocessing as mp
from typing import Any, Callable, Dict, List, Optional, Sequence

from repro_torch.core.request import Request, RequestResult, SamplingParams


class ReplicaError(RuntimeError):
    """A replica worker failed executing a command."""


def _result_payload(res: RequestResult) -> Dict[str, Any]:
    return {"rid": res.rid, "tokens": list(res.tokens),
            "finish_reason": res.finish_reason, "cancelled": res.cancelled,
            "latency_s": res.latency_s, "ttft_s": res.ttft_s,
            "queue_s": res.queue_s}


def _dispatch(engine, cmd: str, args: tuple):
    """Execute one replica command against an engine (both modes share
    this, so inproc and subprocess can never drift apart)."""
    sch = engine.scheduler
    if cmd == "submit":
        prompt, params = args
        return sch.submit_request(Request(prompt=list(prompt),
                                          params=params)).rid
    if cmd == "step":
        return [r.rid for r in engine.step()]
    if cmd == "drain":
        return [r.rid for r in engine.run()]
    if cmd == "queue_depth":
        return sch.n_queued + sch.n_active + len(sch._pending)
    if cmd == "idle":
        return engine.idle
    if cmd == "result":
        (rid,) = args
        res = sch.results.get(rid)
        if res is None:
            raise ReplicaError(f"no result for rid {rid} yet")
        return _result_payload(res)
    if cmd == "stats":
        snap = sch.stats.snapshot()
        snap["trie_nodes"] = len(sch.sources["trie"].forest)
        return snap
    if cmd == "draft_state":
        (max_prefix_keys,) = args
        return engine.draft_state(max_prefix_keys=max_prefix_keys)
    if cmd == "merge_draft_state":
        (payload,) = args
        engine.merge_draft_state(payload)
        return None
    if cmd == "save_draft_state":
        (path,) = args
        engine.save_draft_state(path)
        return None
    if cmd == "load_draft_state":
        path, prime_prefix = args
        engine.load_draft_state(path, prime_prefix=prime_prefix)
        return None
    raise ReplicaError(f"unknown replica command {cmd!r}")


def _worker(conn, builder: Callable[[], Any]) -> None:
    """Subprocess loop: build the engine, serve commands until 'close'."""
    try:
        engine = builder()
        conn.send(("ok", None))
    except BaseException as e:          # construction failed: report + exit
        conn.send(("err", f"{type(e).__name__}: {e}"))
        return
    while True:
        try:
            cmd, args = conn.recv()
        except EOFError:
            return
        if cmd == "close":
            conn.send(("ok", None))
            return
        try:
            conn.send(("ok", _dispatch(engine, cmd, args)))
        except Exception as e:
            conn.send(("err", f"{type(e).__name__}: {e}"))


class EngineReplica:
    """One engine of a fleet, addressable through replica commands."""

    def __init__(self, builder: Callable[[], Any], *,
                 replica_id: str = "r0", mode: str = "inproc"):
        if mode not in ("inproc", "subprocess"):
            raise ValueError(f"mode={mode!r}: expected 'inproc' or "
                             "'subprocess'")
        self.replica_id = str(replica_id)
        self.mode = mode
        self.engine = None
        self._conn = None
        self._proc = None
        self.exitcode = None        # the worker's, once close() has run
        if mode == "inproc":
            self.engine = builder()
        else:
            ctx = mp.get_context("spawn")   # fresh interpreter: device-safe
            self._conn, child = ctx.Pipe()
            self._proc = ctx.Process(target=_worker, args=(child, builder),
                                     daemon=True)
            self._proc.start()
            child.close()
            self._check(self._conn.recv())  # construction ack

    # ------------------------------------------------------------- plumbing
    def _check(self, reply):
        status, value = reply
        if status != "ok":
            raise ReplicaError(f"replica {self.replica_id}: {value}")
        return value

    def _call(self, cmd: str, *args):
        if self.engine is not None:
            return _dispatch(self.engine, cmd, args)
        self._conn.send((cmd, args))
        return self._check(self._conn.recv())

    # -------------------------------------------------------------- surface
    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None) -> int:
        """Queue a request; returns its replica-local rid."""
        return self._call("submit", list(prompt), params)

    def step(self) -> List[int]:
        """One scheduler iteration; returns rids finished by it."""
        return self._call("step")

    def drain(self) -> List[int]:
        """Run until idle; returns every finished rid in submit order."""
        return self._call("drain")

    @property
    def queue_depth(self) -> int:
        """Requests held right now (queued + active + pending admissions)
        — the router's backpressure signal."""
        return self._call("queue_depth")

    @property
    def idle(self) -> bool:
        return self._call("idle")

    def result(self, rid: int) -> Dict[str, Any]:
        return self._call("result", rid)

    def stats_snapshot(self) -> Dict[str, Any]:
        return self._call("stats")

    # ---- warm state / gossip
    def draft_state(self, *, max_prefix_keys: Optional[int] = 64
                    ) -> Dict[str, Any]:
        return self._call("draft_state", max_prefix_keys)

    def merge_draft_state(self, payload: Dict[str, Any]) -> None:
        self._call("merge_draft_state", payload)

    def save_draft_state(self, path: str) -> None:
        self._call("save_draft_state", path)

    def load_draft_state(self, path: str, *,
                         prime_prefix: bool = True) -> None:
        self._call("load_draft_state", path, prime_prefix)

    # ---- lifecycle
    def close(self) -> None:
        if self._proc is not None:
            try:
                self._conn.send(("close", ()))
                self._conn.recv()
            except (OSError, EOFError):
                pass
            self._proc.join(timeout=10)
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join()
            self.exitcode = self._proc.exitcode
            self._conn.close()
            self._proc = None
            self._conn = None


__all__ = ["EngineReplica", "ReplicaError"]
