"""Device time of kernel calls, and the serving path's tree mask, for the
on-card checks (``chip_smoke.py``) and ``compare_builds``.

``device_ms`` reads torch.profiler's device time.  The profiler now and then
records fewer launches than a window made, and a window that lost launches
reads low, so every window's launches are counted against the calls it made
and a window that does not add up is taken again.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def path_mask(B: int, T: int, S: int, seed: int = 0, max_new: int = 48,
              device="cuda") -> torch.Tensor:
    """A serving-like (B, T, S) bool mask: a committed prefix of random
    length per lane, plus the ancestor closure of a random draft tree at
    rows [len, len + T), leaving ``max_new`` keys of room at the end."""
    rng = np.random.RandomState(seed)
    mask = np.zeros((B, T, S), bool)
    for b in range(B):
        n = int(rng.randint(96, S - T - max_new))
        parent = [-1] + [int(rng.randint(0, i)) for i in range(1, T)]
        for i in range(T):
            j = i
            while j >= 0:
                mask[b, i, n + j] = True
                j = parent[j]
        mask[b, :, :n] = True
    return torch.from_numpy(mask).to(device)


def _window(fn: Callable[[int], object], calls: int,
            match: Optional[str]):
    """One profiler window over fn(0..calls-1): (launches, device us) of
    the kernels whose name holds ``match``, or of every kernel."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and (match is None or match in e.key)]
    return (sum(e.count for e in kernels),
            sum(e.self_device_time_total for e in kernels))


def device_ms(fn: Callable[[int], object], calls: int,
              match: Optional[str] = None, attempts: int = 4) -> float:
    """Device time per call, in ms, of fn(i) over ``calls`` calls from
    torch.profiler: the kernels whose name holds ``match``, or every kernel
    the calls launch.

    A first call warms up unprofiled; profiled single calls, until two
    agree, count the launches per call (raised where a window of
    ``calls`` calls holds a whole larger number a call, as single calls
    can lose a launch too).  A window whose launches are not ``calls``
    times that count is taken again, up to ``attempts`` windows in all,
    after which this raises."""
    fn(0)
    torch.cuda.synchronize()
    counts = []
    for _ in range(attempts):
        c = _window(fn, 1, match)[0]
        if c and c in counts:
            break
        counts.append(c)
    per_call = max(counts)
    if per_call == 0:
        raise RuntimeError(f"the profiler saw no launch of a call "
                           f"({match or 'any kernel'}) in {attempts} windows")
    seen = []
    for _ in range(attempts):
        n, us = _window(fn, calls, match)
        # the profiler loses launches and never adds one: a window that
        # holds more a call than the single calls did shows the true count
        if n % calls == 0 and n // calls > per_call:
            per_call = n // calls
        if n == calls * per_call:
            return us / 1e3 / calls
        seen.append(n)
    raise RuntimeError(f"the profiler recorded {seen} launches "
                       f"({match or 'any kernel'}) in {attempts} windows "
                       f"of {calls} calls, not {calls * per_call}")


__all__ = ["device_ms", "path_mask"]
