"""Fault-tolerance runtime pieces (port-local copy of
``repro.training.fault_tolerance``, pure Python):

* PreemptionHandler — SIGTERM/SIGINT sets a flag; the train loop checkpoints
  at the next step boundary and exits cleanly (TPU preemption notice).
* run_with_timeout — straggler mitigation: a step that exceeds its deadline
  is abandoned and retried (on real fleets: after re-forming the mesh without
  the straggler; here the retry path is exercised directly).
* retry — transient-failure wrapper with exponential backoff for collectives
  that died mid-flight.
* elastic_world — recompute the largest usable (pods, data, model) mesh from
  a surviving device count, preserving the model axis (TP degree must match
  the checkpointed layout; data/pod axes absorb the loss).
"""
from __future__ import annotations

import signal
import threading
import time
from concurrent.futures import ThreadPoolExecutor, TimeoutError as _Timeout
from typing import Callable, Optional, Tuple


class PreemptionHandler:
    def __init__(self, signals=(signal.SIGTERM,)):
        self._flag = threading.Event()
        self._prev = {}
        self._signals = signals

    def install(self) -> "PreemptionHandler":
        for s in self._signals:
            self._prev[s] = signal.signal(s, self._on_signal)
        return self

    def uninstall(self) -> None:
        for s, h in self._prev.items():
            signal.signal(s, h)
        self._prev.clear()

    def _on_signal(self, signum, frame):
        self._flag.set()

    @property
    def preempted(self) -> bool:
        return self._flag.is_set()

    def trigger(self) -> None:         # test hook
        self._flag.set()


class StragglerTimeout(Exception):
    pass


def run_with_timeout(fn: Callable, timeout_s: float, *args, retries: int = 1,
                     on_timeout: Optional[Callable] = None, **kwargs):
    """Run fn; if it exceeds timeout_s, call on_timeout() and retry.
    Raises StragglerTimeout after ``retries`` consecutive timeouts."""
    for attempt in range(retries + 1):
        with ThreadPoolExecutor(max_workers=1) as ex:
            fut = ex.submit(fn, *args, **kwargs)
            try:
                return fut.result(timeout=timeout_s)
            except _Timeout:
                if on_timeout is not None:
                    on_timeout()
                if attempt == retries:
                    raise StragglerTimeout(
                        f"step exceeded {timeout_s}s x{retries + 1}")


def retry(fn: Callable, *args, attempts: int = 3, base_delay: float = 0.05,
          retriable=(RuntimeError, IOError), **kwargs):
    for i in range(attempts):
        try:
            return fn(*args, **kwargs)
        except retriable:
            if i == attempts - 1:
                raise
            time.sleep(base_delay * (2 ** i))


def elastic_world(n_devices: int, model_parallel: int,
                  prefer_pods: int = 1) -> Tuple[int, int, int]:
    """Largest (pods, data, model) with pods*data*model <= n_devices, model
    fixed (checkpoint TP layout), data a power of two."""
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot host model_parallel={model_parallel}")
    rest = n_devices // model_parallel
    pods = prefer_pods
    while pods > 1 and rest % pods != 0:
        pods -= 1
    per_pod = rest // pods
    data = 1
    while data * 2 <= per_pod:
        data *= 2
    return pods, data, model_parallel


__all__ = ["PreemptionHandler", "StragglerTimeout", "run_with_timeout",
           "retry", "elastic_world"]
