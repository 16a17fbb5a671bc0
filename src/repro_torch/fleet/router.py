"""Namespace-affinity admission router (DESIGN.md §Fleet serving).

Retrieval-based lossless acceleration lives or dies on the warmth of its
reference store: a trie only accelerates traffic whose branch statistics
it has already seen.  Round-robin across replicas splits every scenario's
traffic N ways — N lukewarm tries instead of one hot one.  The router
therefore places requests by *namespace affinity*:

  * consistent hashing maps each trie namespace onto the replica ring
    (virtual nodes smooth the assignment; SHA-256, never Python's
    per-process-salted ``hash``), so a scenario's requests always land on
    the replica whose trie they warmed — and adding a replica only moves
    the namespaces that hash next to it;
  * backpressure: when the home replica's queue depth reaches
    ``max_queue_depth``, the request spills to the least-loaded replica
    (lowest queue depth, ties to the lowest index).  A spill trades draft
    acceptance for admission latency — gossip
    (repro_torch.fleet.gossip) warms the spill target so repeated spills
    stop being cold.

Routing never affects outputs: every replica runs the same verifier, so a
request generates bit-identical tokens wherever it lands (I1) — the router
is purely a throughput/latency policy.
"""
from __future__ import annotations

import bisect
import hashlib
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core.request import SamplingParams
from repro_torch.fleet.replica import EngineReplica
from repro_torch.serving.scheduler import NamespaceStats


def _stable_hash(key: str) -> int:
    """Process-independent 64-bit hash (routing must agree across runs
    and across replicas; builtin ``hash`` is salted per process)."""
    return int.from_bytes(
        hashlib.sha256(key.encode("utf-8")).digest()[:8], "big")


@dataclass
class Placement:
    """One routed request: where it went and why."""
    index: int            # fleet-wide submission index
    namespace: str
    replica: int          # replica index it landed on
    rid: int              # replica-local request id
    spilled: bool = False


@dataclass
class FleetStats:
    """Rollup of routing counters + per-replica scheduler snapshots."""
    routed: int = 0
    affinity_hits: int = 0
    spills: int = 0
    round_robin: int = 0
    ns_routed: Dict[str, int] = field(default_factory=dict)
    replicas: List[Dict[str, Any]] = field(default_factory=list)

    def namespace_summary(self) -> Dict[str, Dict[str, float]]:
        """Fleet-wide per-tenant SLO summary: raw latency samples from
        every replica are pooled per namespace, then summarized once —
        a fleet p99 over the union, never an average of per-replica
        percentiles."""
        merged: Dict[str, NamespaceStats] = {}
        for snap in self.replicas:
            for nsn, ns_snap in snap.get("namespaces", {}).items():
                st = merged.get(nsn)
                if st is None:
                    st = merged[nsn] = NamespaceStats()
                st.merge(ns_snap)
        # occupancy denominator: Σ decode_steps·lanes over replicas
        capacity = sum(int(s.get("decode_steps", 0)) * int(s.get("lanes", 1))
                       for s in self.replicas)
        return {nsn: st.summary(max(capacity, 1), 1)
                for nsn, st in sorted(merged.items())}

    def source_acceptance(self) -> Dict[str, Dict[str, float]]:
        """namespace -> source -> fleet-wide acceptance rate."""
        out: Dict[str, Dict[str, float]] = {}
        for nsn, summ in self._merged_counts().items():
            drafted, accepted = summ
            out[nsn] = {n: accepted.get(n, 0) / max(d, 1)
                        for n, d in drafted.items()}
        return out

    def _merged_counts(self):
        merged: Dict[str, tuple] = {}
        for snap in self.replicas:
            for nsn, ns_snap in snap.get("namespaces", {}).items():
                drafted, accepted = merged.setdefault(nsn, ({}, {}))
                for k, v in dict(ns_snap["source_drafted"]).items():
                    drafted[k] = drafted.get(k, 0) + int(v)
                for k, v in dict(ns_snap["source_accepted"]).items():
                    accepted[k] = accepted.get(k, 0) + int(v)
        return merged


class FleetRouter:
    """Places requests onto replicas; drives and rolls up the fleet."""

    def __init__(self, replicas: Sequence[EngineReplica], *,
                 policy: str = "affinity", max_queue_depth: int = 8,
                 vnodes: int = 64):
        if not replicas:
            raise ValueError("a fleet needs >= 1 replica")
        if policy not in ("affinity", "round_robin"):
            raise ValueError(f"policy={policy!r}: expected 'affinity' or "
                             "'round_robin'")
        if max_queue_depth < 1:
            raise ValueError(f"max_queue_depth={max_queue_depth}: need >= 1")
        self.replicas = list(replicas)
        self.policy = policy
        self.max_queue_depth = int(max_queue_depth)
        self.placements: List[Placement] = []
        self._rr = 0
        self._routed = 0
        self._affinity_hits = 0
        self._spills = 0
        self._ns_routed: Dict[str, int] = {}
        # consistent-hash ring: vnodes points per replica, keyed by the
        # replica's id so ring layout is stable across fleet restarts
        ring = []
        for idx, rep in enumerate(self.replicas):
            for v in range(int(vnodes)):
                ring.append((_stable_hash(f"{rep.replica_id}#{v}"), idx))
        ring.sort()
        self._ring_keys = [h for h, _ in ring]
        self._ring_vals = [i for _, i in ring]

    # -------------------------------------------------------------- placement
    def home_replica(self, namespace: str) -> int:
        """Pure affinity assignment (no load considered): the first ring
        point at or after the namespace's hash, wrapping."""
        h = _stable_hash(namespace)
        i = bisect.bisect_left(self._ring_keys, h)
        if i == len(self._ring_keys):
            i = 0
        return self._ring_vals[i]

    def _least_loaded(self) -> int:
        return min(range(len(self.replicas)),
                   key=lambda i: (self.replicas[i].queue_depth, i))

    def route(self, namespace: str) -> Placement:
        """Pick a replica for one request of ``namespace`` (no submit)."""
        ns = str(namespace)
        spilled = False
        if self.policy == "round_robin":
            idx = self._rr % len(self.replicas)
            self._rr += 1
        else:
            idx = self.home_replica(ns)
            if self.replicas[idx].queue_depth >= self.max_queue_depth:
                alt = self._least_loaded()
                if alt != idx:
                    idx, spilled = alt, True
        self._routed += 1
        self._ns_routed[ns] = self._ns_routed.get(ns, 0) + 1
        if self.policy == "affinity":
            if spilled:
                self._spills += 1
            else:
                self._affinity_hits += 1
        return Placement(index=len(self.placements), namespace=ns,
                         replica=idx, rid=-1, spilled=spilled)

    @staticmethod
    def namespace_of(params: Optional[SamplingParams],
                     default: str = "") -> str:
        if params is not None and params.draft is not None:
            return params.draft.namespace
        return default

    def submit(self, prompt: Sequence[int],
               params: Optional[SamplingParams] = None, *,
               namespace: Optional[str] = None) -> Placement:
        """Route + submit one request; returns its ``Placement`` (the
        fleet-wide index keys ``result``/``results``)."""
        ns = (str(namespace) if namespace is not None
              else self.namespace_of(params))
        p = self.route(ns)
        p.rid = self.replicas[p.replica].submit(prompt, params)
        self.placements.append(p)
        return p

    # ------------------------------------------------------------------ drive
    def step_all(self) -> List[Placement]:
        """One scheduler iteration on every replica; returns placements
        finished by this sweep."""
        done: List[Placement] = []
        for ridx, rep in enumerate(self.replicas):
            finished = set(rep.step())
            if finished:
                done.extend(p for p in self.placements
                            if p.replica == ridx and p.rid in finished)
        return done

    def drain(self) -> None:
        """Drive every replica until the whole fleet is idle."""
        for rep in self.replicas:
            rep.drain()

    @property
    def idle(self) -> bool:
        return all(rep.idle for rep in self.replicas)

    # ---------------------------------------------------------------- results
    def result(self, index: int) -> Dict[str, Any]:
        p = self.placements[index]
        return self.replicas[p.replica].result(p.rid)

    def results(self) -> List[Dict[str, Any]]:
        """Every routed request's result, in fleet submission order."""
        return [self.result(i) for i in range(len(self.placements))]

    # ------------------------------------------------------------------ stats
    def fleet_stats(self) -> FleetStats:
        return FleetStats(routed=self._routed,
                          affinity_hits=self._affinity_hits,
                          spills=self._spills,
                          round_robin=(self._routed if self.policy ==
                                       "round_robin" else 0),
                          ns_routed=dict(self._ns_routed),
                          replicas=[rep.stats_snapshot()
                                    for rep in self.replicas])

    def close(self) -> None:
        for rep in self.replicas:
            rep.close()


__all__ = ["FleetRouter", "FleetStats", "Placement"]
