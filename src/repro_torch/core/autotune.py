"""Per-namespace draft-source auto-tuning (DESIGN.md §Multi-tenant SLOs).

The per-source drafted/accepted telemetry on ``GenStats`` measures
which draft sources actually verify on which workload — the paper's Alipay
deployment serves many *scenarios* from one process, and a source that pays
off on one (prompt-copy on RAG traffic, say) can be pure host-side overhead
on another.  This module closes the loop: an ``AutoTuner`` keeps one
``NamespaceController`` per trie namespace, folds every retiring request's
per-source counters into an acceptance-rate EMA, and *gates* retrieval —
sources whose EMA stays under ``drop_rate`` after ``min_trials`` drafted
tokens get their quota driven to zero and their ``retrieve`` call skipped
entirely.  A deterministic counter-based probe re-admits a disabled source
with a tiny quota every ``probe_period`` gate decisions, so a source that
starts verifying again (workload drift, a now-warm trie) earns its quota
back.

Everything here is host-side policy over which draft tokens get *built*:
the device step verifies whatever tree it is handed, so gating can never
change an output token (I1), and no shape depends on the controller's
state, so it can never retrace (I2).  Decisions are pure functions of the
observed token history — no wall clock, no RNG — which keeps perf runs
reproducible and lets the lossless fuzz assert autotune-on == autotune-off
bit-for-bit.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class AutoTuneConfig:
    """Controller knobs (shared by every namespace of one AutoTuner).

    min_trials:   drafted tokens a source must accumulate on a namespace
                  before it may be disabled (cold-start protection).
    drop_rate:    acceptance-rate EMA below which a trialed source is
                  disabled (and above-or-equal which a probe re-enables it).
    ema_alpha:    weight of each retiring request's acceptance rate.
    probe_period: gate decisions between probes of a disabled source.
    probe_quota:  new-token quota a probe grants (small: the probe must be
                  cheap when the source is still useless).
    """
    min_trials: int = 64
    drop_rate: float = 0.05
    ema_alpha: float = 0.2
    probe_period: int = 32
    probe_quota: int = 1

    def validate(self) -> "AutoTuneConfig":
        if self.min_trials < 1:
            raise ValueError(f"min_trials={self.min_trials}: need >= 1")
        if not 0.0 <= self.drop_rate < 1.0:
            raise ValueError(f"drop_rate={self.drop_rate}: need [0, 1)")
        if not 0.0 < self.ema_alpha <= 1.0:
            raise ValueError(f"ema_alpha={self.ema_alpha}: need (0, 1]")
        if self.probe_period < 1:
            raise ValueError(f"probe_period={self.probe_period}: need >= 1")
        if self.probe_quota < 1:
            raise ValueError(f"probe_quota={self.probe_quota}: need >= 1")
        return self


@dataclass
class SourceStat:
    """Per-(namespace, source) controller state."""
    drafted: int = 0          # draft tokens placed into trees (lifetime)
    accepted: int = 0         # of those, tokens the model verified
    ema: Optional[float] = None   # acceptance-rate EMA over observations
    enabled: bool = True
    disables: int = 0         # times the controller zeroed the quota
    probes: int = 0           # probe retrievals granted while disabled
    _since_probe: int = 0     # gate decisions since the last probe

    @property
    def rate(self) -> float:
        """Lifetime acceptance rate (EMA drives decisions; this is for
        reporting)."""
        return self.accepted / max(self.drafted, 1)


class NamespaceController:
    """EMA bandit over one namespace's draft sources."""

    def __init__(self, config: AutoTuneConfig):
        self.config = config
        self.sources: Dict[str, SourceStat] = {}
        self.observations = 0

    def stat(self, name: str) -> SourceStat:
        s = self.sources.get(name)
        if s is None:
            s = self.sources[name] = SourceStat()
        return s

    # ------------------------------------------------------------- observe
    def observe(self, drafted: Dict[str, int],
                accepted: Dict[str, int]) -> None:
        """Fold one retiring request's per-source counters in.  Sources the
        request never drafted through contribute nothing (a disabled
        source's EMA only moves when a probe actually drafts)."""
        cfg = self.config
        moved = False
        for name, d in drafted.items():
            if d <= 0:
                continue
            moved = True
            st = self.stat(name)
            a = accepted.get(name, 0)
            st.drafted += int(d)
            st.accepted += int(a)
            r = a / d
            st.ema = r if st.ema is None else (
                (1.0 - cfg.ema_alpha) * st.ema + cfg.ema_alpha * r)
            if st.enabled:
                if st.drafted >= cfg.min_trials and st.ema < cfg.drop_rate:
                    st.enabled = False
                    st.disables += 1
                    st._since_probe = 0
            elif st.ema >= cfg.drop_rate:
                st.enabled = True      # a probe paid off: quota restored
        if moved:
            self.observations += 1

    # ---------------------------------------------------------------- gate
    def gate(self, names: Sequence[str],
             quotas: Sequence[int]) -> Tuple[List[int], List[int]]:
        """One retrieval decision: which of ``names`` draft this tree, at
        what new-token quota.  Returns (kept indices, kept quotas).

        Enabled sources keep their policy quota.  Disabled sources are
        skipped — their retrieve cost is not paid — except every
        ``probe_period``-th decision, when they ride along at
        ``probe_quota`` so recovery stays possible.  If everything is
        disabled the first source is kept at full quota: a request must
        never be stripped of speculation entirely by its own controller.
        """
        cfg = self.config
        keep: List[int] = []
        kq: List[int] = []
        for i, name in enumerate(names):
            st = self.stat(name)
            if st.enabled:
                keep.append(i)
                kq.append(int(quotas[i]))
                continue
            st._since_probe += 1
            if st._since_probe >= cfg.probe_period:
                st._since_probe = 0
                st.probes += 1
                keep.append(i)
                kq.append(min(cfg.probe_quota, int(quotas[i])))
        if not keep:
            keep, kq = [0], [int(quotas[0])]
        return keep, kq

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {name: {"drafted": st.drafted, "accepted": st.accepted,
                       "rate": st.rate,
                       "ema": st.ema if st.ema is not None else -1.0,
                       "enabled": st.enabled, "disables": st.disables,
                       "probes": st.probes}
                for name, st in self.sources.items()}


class AutoTuner:
    """Per-namespace controller registry the scheduler drives.

    ``observe`` at request retirement (the per-request counters are
    complete and the call is deterministic — no mid-flight sampling),
    ``select`` before each tree build (filters the policy's source list and
    quotas down to what this namespace has earned).
    """

    def __init__(self, config: Optional[AutoTuneConfig] = None):
        self.config = (config if config is not None
                       else AutoTuneConfig()).validate()
        self.namespaces: Dict[str, NamespaceController] = {}

    def controller(self, namespace: str) -> NamespaceController:
        c = self.namespaces.get(namespace)
        if c is None:
            c = self.namespaces[namespace] = NamespaceController(self.config)
        return c

    def observe(self, namespace: str, drafted: Dict[str, int],
                accepted: Dict[str, int]) -> None:
        self.controller(namespace).observe(drafted, accepted)

    def select(self, namespace: str, names: Sequence[str],
               quotas: Sequence[int]) -> Tuple[List[int], List[int]]:
        """Gate one tree build; see ``NamespaceController.gate``."""
        return self.controller(namespace).gate(names, quotas)

    def snapshot(self) -> Dict[str, Dict[str, Dict[str, float]]]:
        """namespace -> source -> controller state (stats/serving surface)."""
        return {ns: ctl.snapshot() for ns, ctl in self.namespaces.items()}


__all__ = ["AutoTuneConfig", "AutoTuner", "NamespaceController",
           "SourceStat"]
