"""repro_torch.fleet — replicated serving (DESIGN.md §Fleet serving), the
PyTorch port's copy of ``repro.fleet``: no module here touches the device,
so only the imports differ, and a warm-state file written by either package
loads in the other.

The paper's headline numbers come from a fleet deployment: many engine
replicas per scenario, each fast only because its trie has already seen
traffic like the request in front of it.  This package adds the three
pieces a single-process engine lacks:

  * ``persist`` — versioned, checksummed serialization of warm draft state
    (trie forests, n-gram tables, hot prefix-cache keys) so a restarted or
    newly spawned replica resumes with a donor's branch statistics — the
    continuous version of the paper's Appendix D warmup.
  * ``replica`` — ``EngineReplica``: one ``ServingEngine`` behind a uniform
    command surface, in-process (deterministic tests/CI) or in a
    subprocess.
  * ``router`` — ``FleetRouter``: namespace-affinity admission (consistent
    hashing keeps a scenario's traffic on the replica whose trie it
    warmed; queue-depth backpressure spills to the least-loaded replica),
    with a ``FleetStats`` rollup over per-replica ``SchedulerStats``.
  * ``gossip`` — ``GossipCoordinator``: periodic freq-summing merge of
    per-namespace draft state between replicas, so spilled traffic warms a
    cold replica instead of being wasted on it.

None of this touches the device step: draft state only ever *proposes*
tokens and the verifier guarantees outputs (I1), so any routing decision,
any merge, and any warm/cold state produce bit-identical generations.
"""
from repro_torch.fleet.gossip import GossipCoordinator
from repro_torch.fleet.persist import (DraftStateError,
                                       collect_draft_state,
                                       install_draft_state, load_draft_state,
                                       save_draft_state)
from repro_torch.fleet.replica import EngineReplica
from repro_torch.fleet.router import FleetRouter, FleetStats

__all__ = ["DraftStateError", "collect_draft_state", "install_draft_state",
           "load_draft_state", "save_draft_state", "EngineReplica",
           "FleetRouter", "FleetStats", "GossipCoordinator"]
