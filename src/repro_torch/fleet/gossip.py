"""Gossip: periodic snapshot-merge of draft state between replicas.

Affinity routing keeps a namespace's traffic on one warm replica — until
backpressure spills it onto a cold one, where acceptance collapses to the
cold-start rate.  Gossip closes that gap: every ``every`` fleet rounds,
each replica's shared draft state (trie forests, n-gram tables) is
snapshotted and freq-sum merged into every other replica.  The merge rides
the structures' own hygiene — the trie forest re-enforces its shared
capacity budget with decay-pruning after the merge, the n-gram table its
entry cap — so gossip warms a replica instead of flooding it.

Prefix-cache keys are NOT gossiped: they point at device-resident KV
blocks that exist only on the donor, and re-prefilling them mid-serving
would steal lanes from live traffic.  They travel only through the
persist/restart path, where the engine is idle.

Losslessness: merged state only changes what a replica *proposes*; the
verifier guarantees outputs (I1), so gossip on/off/any-cadence produces
bit-identical generations — it moves acceptance rate, not tokens.
"""
from __future__ import annotations

from typing import List, Sequence

from repro_torch.fleet.replica import EngineReplica


class GossipCoordinator:
    """All-to-all draft-state exchange on a fixed round cadence."""

    def __init__(self, replicas: Sequence[EngineReplica], *,
                 every: int = 0):
        if every < 0:
            raise ValueError(f"every={every}: need >= 0 (0 = disabled)")
        self.replicas = list(replicas)
        self.every = int(every)
        self.rounds = 0
        self.exchanges = 0

    def tick(self) -> bool:
        """Count one fleet round; runs an exchange when the cadence hits.
        Returns True if an exchange ran."""
        self.rounds += 1
        if self.every > 0 and len(self.replicas) > 1 \
                and self.rounds % self.every == 0:
            self.exchange()
            return True
        return False

    def exchange(self) -> None:
        """Snapshot every replica once, then merge each snapshot into every
        OTHER replica (snapshots are taken up front so a merge never feeds
        back into a donor's own snapshot within one exchange)."""
        snaps: List[dict] = [rep.draft_state(max_prefix_keys=0)
                             for rep in self.replicas]
        for i, rep in enumerate(self.replicas):
            for j, payload in enumerate(snaps):
                if i != j and payload.get("sources"):
                    rep.merge_draft_state(payload)
        self.exchanges += 1


__all__ = ["GossipCoordinator"]
