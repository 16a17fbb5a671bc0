"""repro_torch.fleet and the port's warm draft state, on the CPU: the
tests of tests/test_fleet.py whose subject the port copies, on the port.

Property tests cover every state_dict/load_state_dict pair of the port's
copies (round-trips must be bit-identical down to retrieval order), the
file format's corruption/version rejects, and the gossip-merge CRDT-join
laws.  The end-to-end tests drive a real 2-replica in-process fleet on a
tiny model and assert every output token matches a single-replica engine
(I1: routing, gossip and warm state are pure performance policies), and a
spawned replica builds its engine in the child.  Across frameworks: the
JAX engine and the port's serve the same requests on the same weights
(``params_from_jax``) and collect equal draft-state payloads, the two
packages write the same file byte for byte, and a file saved by either
engine loads into the other and retrieves the same branches.
"""
import functools
import json
import types

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import DraftPolicy, Request, SamplingParams
from repro_torch.core.draft_sources import (AdaptiveBudget, NgramSource,
                                            PromptCopySource, TrieSource)
from repro_torch.core.strategies import LookaheadConfig
from repro_torch.core.trie import TrieForest, TrieTree
from repro_torch.fleet import (DraftStateError, EngineReplica, FleetRouter,
                               GossipCoordinator)
from repro_torch.fleet.persist import (collect_draft_state,
                                       install_draft_state, load_draft_state,
                                       save_draft_state)
from repro_torch.fleet.replica import ReplicaError
from repro_torch.models.params import init_params, params_from_jax
from repro_torch.serving.api import (EngineConfig, ServingEngine,
                                     build_engine, build_session_fns)

from torch_fleet_tiny import TINY_CFG as _CFG, TINY_ECFG as _ECFG, build_tiny

pytestmark = [pytest.mark.torch_port, pytest.mark.fleet]

_CHAIN = st.lists(st.integers(1, 30), min_size=1, max_size=6)
_CHAINS = st.lists(_CHAIN, min_size=1, max_size=12)


def _cfg() -> LookaheadConfig:
    return LookaheadConfig(decoding_length=8, branch_length=4)


def _walk(tree: TrieTree):
    """{root-path: freq} snapshot of a trie."""
    out = {}
    stack = [((), tree.root)]
    while stack:
        path, node = stack.pop()
        for tok, child in node.children.items():
            p = path + (tok,)
            out[p] = child.freq
            stack.append((p, child))
    return out


# ------------------------------------------------------ state round-trips
@settings(max_examples=25)
@given(_CHAINS)
def test_trie_state_roundtrip_bit_identical(chains):
    t = TrieTree(capacity=10_000)
    for c in chains:
        t.insert(c)
    sd = t.state_dict()
    t2 = TrieTree(capacity=10_000)
    t2.load_state_dict(sd)
    assert t2.state_dict() == sd          # serialization is a fixed point
    for ctx in chains + [[1], [2, 3], [30]]:
        assert t.retrieve(ctx, decoding_length=8) == \
            t2.retrieve(ctx, decoding_length=8)


@settings(max_examples=15)
@given(_CHAINS, _CHAINS)
def test_forest_state_roundtrip(chains_a, chains_b):
    f = TrieForest(capacity=10_000)
    for c in chains_a:
        f.tree("a").insert(c)
    for c in chains_b:
        f.tree("b").insert(c)
    sd = f.state_dict()
    f2 = TrieForest(capacity=10_000)
    f2.load_state_dict(sd)
    assert f2.state_dict() == sd
    assert len(f2) == len(f)
    for ctx in chains_a[:3]:
        assert f.tree("a").retrieve(ctx, decoding_length=8) == \
            f2.tree("a").retrieve(ctx, decoding_length=8)


def test_trie_source_roundtrip():
    src = TrieSource(_cfg())
    src.observe_prompt(1, [5, 6, 7, 8], namespace="docs")
    src.observe_output(1, [9, 10, 11], namespace="docs")
    sd = src.state_dict()
    s2 = TrieSource(_cfg())
    s2.load_state_dict(sd)
    assert s2.state_dict() == sd
    assert s2.retrieve(2, [9, 10], budget=8, namespace="docs") == \
        src.retrieve(2, [9, 10], budget=8, namespace="docs")


def test_ngram_source_roundtrip():
    src = NgramSource(_cfg())
    rng = np.random.RandomState(3)
    for rid in range(4):
        toks = rng.randint(1, 20, size=24).tolist()
        src.observe_prompt(rid, toks)
        src.observe_output(rid, toks[::-1])
    sd = src.state_dict()
    s2 = NgramSource(_cfg())
    s2.load_state_dict(sd)
    assert s2.state_dict() == sd
    for ctx in ([1, 2, 3], [5, 6], [19]):
        assert s2.retrieve(9, ctx, budget=6) == src.retrieve(9, ctx, budget=6)


def test_stateless_source_rejects_foreign_state():
    src = PromptCopySource(_cfg())
    assert src.state_dict() == {}
    src.load_state_dict({})                      # empty is fine
    with pytest.raises(ValueError):
        src.load_state_dict({"kind": "trie", "forest": {}})


def test_trie_load_rejects_malformed():
    t = TrieTree()
    with pytest.raises(ValueError):
        t.load_state_dict({"tokens": [1], "parents": [], "freqs": [1.0]})
    with pytest.raises(ValueError):
        # parent pointing forward breaks the preorder contract
        t.load_state_dict({"tokens": [1, 2], "parents": [1, -1],
                           "freqs": [1.0, 1.0]})


# ----------------------------------------------------------- file format
def _payload():
    src = TrieSource(_cfg())
    src.observe_output(1, [3, 4, 5], namespace="docs")
    return {"sources": {"trie": src.state_dict()}}


def test_save_load_file_roundtrip(tmp_path):
    path = str(tmp_path / "state.json")
    save_draft_state(path, _payload())
    assert load_draft_state(path) == _payload()


def test_load_rejects_corruption(tmp_path):
    path = str(tmp_path / "state.json")
    save_draft_state(path, _payload())
    doc = json.loads(open(path).read())
    doc["payload"]["sources"]["trie"]["forest"]["namespaces"] = {}
    open(path, "w").write(json.dumps(doc))       # checksum now stale
    with pytest.raises(DraftStateError):
        load_draft_state(path)


def test_load_rejects_truncation_and_version(tmp_path):
    path = str(tmp_path / "state.json")
    save_draft_state(path, _payload())
    text = open(path).read()
    open(path, "w").write(text[:len(text) // 2])   # torn file
    with pytest.raises(DraftStateError):
        load_draft_state(path)
    doc = json.loads(text)
    doc["version"] = 2
    open(path, "w").write(json.dumps(doc))
    with pytest.raises(DraftStateError):
        load_draft_state(path)
    open(path, "w").write(json.dumps({"format": "other", "version": 1}))
    with pytest.raises(DraftStateError):
        load_draft_state(path)
    with pytest.raises(DraftStateError):
        load_draft_state(str(tmp_path / "absent.json"))


def test_install_rejects_unknown_source():
    sch = types.SimpleNamespace(sources={}, config=_cfg(), prefix=None)
    with pytest.raises(DraftStateError):
        install_draft_state(sch, {"sources": {"no-such-source": {"x": 1}}})


def test_collect_skips_stateless_and_installs_unseen():
    cfg = _cfg()
    trie = TrieSource(cfg)
    trie.observe_output(1, [3, 4, 5])
    sch = types.SimpleNamespace(
        sources={"trie": trie, "prompt_copy": PromptCopySource(cfg)},
        config=cfg, prefix=None)
    payload = collect_draft_state(sch)
    assert set(payload["sources"]) == {"trie"}    # stateless one skipped
    sch2 = types.SimpleNamespace(sources={}, config=cfg, prefix=None)
    install_draft_state(sch2, payload)            # creates via registry
    assert sch2.sources["trie"].retrieve(2, [3, 4], budget=8) == \
        trie.retrieve(2, [3, 4], budget=8)


# ----------------------------------------------------------- gossip merge
@settings(max_examples=15)
@given(_CHAINS, _CHAINS)
def test_merge_is_crdt_join(chains_a, chains_b):
    """merge(A, B): frequency = element-wise max over the union of
    branches (idempotent — a re-echoed snapshot never inflates)."""
    ta, tb = TrieTree(capacity=10_000), TrieTree(capacity=10_000)
    for c in chains_a:
        ta.insert(c)
    for c in chains_b:
        tb.insert(c)
    merged = TrieTree(capacity=10_000)
    merged.load_state_dict(ta.state_dict())
    merged.merge_state(tb.state_dict())
    wa, wb, wm = _walk(ta), _walk(tb), _walk(merged)
    assert set(wm) == set(wa) | set(wb)
    for path, freq in wm.items():
        assert freq == max(wa.get(path, 0.0), wb.get(path, 0.0))
    merged.merge_state(tb.state_dict())
    assert _walk(merged) == wm


@settings(max_examples=10)
@given(_CHAINS, _CHAINS)
def test_forest_merge_respects_capacity(chains_a, chains_b):
    f = TrieForest(capacity=24)
    for c in chains_a:
        f.tree("a").insert(c)
    donor = TrieForest(capacity=10_000)
    for c in chains_b:
        donor.tree("a").insert(c)
        donor.tree("b").insert(c)
    f.merge_state(donor.state_dict())
    assert len(f) <= f.capacity


def test_ngram_merge_is_max():
    a, b = NgramSource(_cfg()), NgramSource(_cfg())
    a.observe_output(1, [1, 2, 3, 1, 2, 3])
    b.observe_output(2, [1, 2, 4])
    before = json.dumps(a.state_dict(), sort_keys=True)
    a.merge_state(a.state_dict())                # self-merge: no-op
    assert json.dumps(a.state_dict(), sort_keys=True) == before
    a.merge_state(b.state_dict())
    s = a.state_dict()
    a.merge_state(b.state_dict())                # idempotent
    assert a.state_dict() == s


def test_adaptive_budget_quota_cap():
    b = AdaptiveBudget(16, min_budget=4)
    for _ in range(8):
        b.update(16)
    assert b.value == 16
    assert b.cap(6) == 6
    assert b.update(16) == 6
    assert b.cap(2) == 2
    b.quota_cap = None
    assert b.update(16) == 16


# ---------------------------------------------------------------- router
class _FakeRep:
    def __init__(self, i, depth=0):
        self.replica_id = f"r{i}"
        self.queue_depth = depth


def test_home_replica_deterministic_and_stable():
    r1 = FleetRouter([_FakeRep(i) for i in range(3)])
    r2 = FleetRouter([_FakeRep(i) for i in range(3)])
    for ns in ("docs", "code", "chat", "", "tenant-42"):
        assert r1.home_replica(ns) == r2.home_replica(ns)
    r4 = FleetRouter([_FakeRep(i) for i in range(4)])
    names = [f"ns{i}" for i in range(64)]
    moved = sum(r1.home_replica(n) != r4.home_replica(n) for n in names)
    assert moved < len(names)


def test_affinity_spills_at_queue_depth():
    reps = [_FakeRep(0), _FakeRep(1)]
    router = FleetRouter(reps, policy="affinity", max_queue_depth=2)
    ns = "docs"
    home = router.home_replica(ns)
    assert router.route(ns).replica == home
    reps[home].queue_depth = 2
    p = router.route(ns)
    assert p.spilled and p.replica != home
    assert router._spills == 1 and router._affinity_hits == 1
    reps[1 - home].queue_depth = 2
    assert router.route(ns).replica in (0, 1)


def test_round_robin_rotation():
    router = FleetRouter([_FakeRep(i) for i in range(3)],
                         policy="round_robin")
    assert [router.route("x").replica for _ in range(6)] == [0, 1, 2] * 2


def test_gossip_cadence():
    calls = []

    class _Rep(_FakeRep):
        def draft_state(self, *, max_prefix_keys=64):
            calls.append(("snap", self.replica_id))
            return {"sources": {}}

        def merge_draft_state(self, payload):
            calls.append(("merge", self.replica_id))

    g = GossipCoordinator([_Rep(0), _Rep(1)], every=3)
    fired = [g.tick() for _ in range(6)]
    assert fired == [False, False, True, False, False, True]
    assert g.exchanges == 2
    assert GossipCoordinator([_Rep(0), _Rep(1)], every=0).tick() is False
    with pytest.raises(ValueError):
        GossipCoordinator([], every=-1)


# ------------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def tiny_fns():
    params = init_params(_CFG, seed=11, device="cpu")
    return build_session_fns(_ECFG, _CFG, params, device="cpu")


def _reqs(n, max_new=8, seed=0, sources=("trie",)):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        ns = ("docs", "code", "chat")[i % 3]
        policy = DraftPolicy(sources=sources, namespace=ns).validate()
        prompt = rng.randint(1, _CFG.vocab_size, size=12).tolist()
        out.append(Request(prompt=prompt, params=SamplingParams(
            max_new_tokens=max_new, draft=policy)))
    return out


def _single(fns, reqs):
    engine = ServingEngine(fns, _ECFG)
    handles = [engine.submit(Request(prompt=list(r.prompt),
                                     params=r.params)) for r in reqs]
    engine.run()
    return [h.result().tokens for h in handles]


def test_fleet_bit_identical_to_single(tiny_fns):
    reqs = _reqs(9)
    ref = _single(tiny_fns, reqs)
    for policy in ("affinity", "round_robin"):
        router = FleetRouter(
            [EngineReplica(lambda: ServingEngine(tiny_fns, _ECFG),
                           replica_id=f"r{i}") for i in range(2)],
            policy=policy)
        for r in reqs:
            router.submit(r.prompt, r.params)
        router.drain()
        assert [res["tokens"] for res in router.results()] == ref
        fs = router.fleet_stats()
        assert fs.routed == len(reqs)
        ns_sum = fs.namespace_summary()
        assert sum(row["finished"] for row in ns_sum.values()) == len(reqs)
        router.close()


def test_gossip_fleet_bit_identical(tiny_fns):
    reqs = _reqs(8)
    ref = _single(tiny_fns, reqs)
    replicas = [EngineReplica(lambda: ServingEngine(tiny_fns, _ECFG),
                              replica_id=f"r{i}") for i in range(2)]
    router = FleetRouter(replicas, policy="affinity", max_queue_depth=2)
    gossip = GossipCoordinator(replicas, every=2)
    for r in reqs:
        router.submit(r.prompt, r.params)
        router.step_all()
        gossip.tick()
    while not router.idle:
        router.step_all()
        gossip.tick()
    assert gossip.exchanges >= 1
    assert [res["tokens"] for res in router.results()] == ref
    router.close()


def test_warm_state_round_trip_through_engine(tiny_fns, tmp_path):
    path = str(tmp_path / "warm.json")
    reqs = _reqs(6)
    donor = ServingEngine(tiny_fns, _ECFG)
    handles = [donor.submit(Request(prompt=list(r.prompt),
                                    params=r.params)) for r in reqs]
    donor.run()
    ref = [h.result().tokens for h in handles]
    donor.save_draft_state(path)
    nodes = len(donor.scheduler.sources["trie"].forest)
    assert nodes > 0

    warm = ServingEngine(tiny_fns, _ECFG)
    warm.load_draft_state(path)
    assert len(warm.scheduler.sources["trie"].forest) == nodes
    handles = [warm.submit(Request(prompt=list(r.prompt),
                                   params=r.params)) for r in reqs]
    warm.run()
    assert [h.result().tokens for h in handles] == ref   # I1


def test_load_draft_state_requires_idle(tiny_fns, tmp_path):
    path = str(tmp_path / "warm.json")
    donor = ServingEngine(tiny_fns, _ECFG)
    donor.submit(_reqs(1)[0])
    donor.run()
    donor.save_draft_state(path)
    busy = ServingEngine(tiny_fns, _ECFG)
    busy.submit(_reqs(1)[0])
    with pytest.raises(RuntimeError):
        busy.load_draft_state(path)


def test_warm_prefix_priming_restores_hits(tmp_path):
    """Persisted prefix keys are re-prefilled on load, so the restarted
    engine's first requests hit the radix cache instead of re-prefilling
    the shared head from scratch."""
    params = init_params(_CFG, seed=11, device="cpu")
    ecfg = EngineConfig(lanes=2, prefill_len=32, decoding_length=8,
                        branch_length=4, kv_layout="paged", block_size=8,
                        n_blocks=64, prefix_cache=True)
    fns = build_session_fns(ecfg, _CFG, params, device="cpu")
    rng = np.random.RandomState(7)
    policy = DraftPolicy(sources=("trie",), namespace="docs").validate()
    prompts = [rng.randint(1, _CFG.vocab_size, size=24).tolist()
               for _ in range(2)]
    reqs = [Request(prompt=list(p), params=SamplingParams(
        max_new_tokens=6, draft=policy)) for p in prompts for _ in range(2)]

    donor = ServingEngine(fns, ecfg)
    handles = [donor.submit(Request(prompt=list(r.prompt),
                                    params=r.params)) for r in reqs]
    donor.run()
    ref = [h.result().tokens for h in handles]
    path = str(tmp_path / "warm.json")
    donor.save_draft_state(path)
    assert "prefix" in load_draft_state(path)

    warm = ServingEngine(fns, ecfg)
    warm.load_draft_state(path)
    base_hits = warm.scheduler.stats.prefix_hits
    handles = [warm.submit(Request(prompt=list(r.prompt),
                                   params=r.params)) for r in reqs]
    warm.run()
    assert [h.result().tokens for h in handles] == ref   # I1
    assert warm.scheduler.stats.prefix_hits > base_hits, \
        "primed prefix keys never produced a cache hit"


def test_subprocess_replica_matches_inproc():
    """One spawned-worker replica produces the same tokens as an
    in-process one; the builder builds the tiny model inside the child,
    on the device it names.  Closing it ends the child."""
    reqs = _reqs(2, max_new=4)
    builder = functools.partial(build_tiny, "cpu")
    inproc = EngineReplica(builder, replica_id="a", mode="inproc")
    rids = [inproc.submit(r.prompt, r.params) for r in reqs]
    inproc.drain()
    ref = [inproc.result(rid)["tokens"] for rid in rids]
    sub = EngineReplica(builder, replica_id="b", mode="subprocess")
    proc = sub._proc
    try:
        rids = [sub.submit(r.prompt, r.params) for r in reqs]
        sub.drain()
        assert [sub.result(rid)["tokens"] for rid in rids] == ref
        assert sub.stats_snapshot()["finished"] == len(reqs)
    finally:
        sub.close()
    assert not proc.is_alive() and sub.exitcode == 0


def test_subprocess_replica_raises_without_cuda_unless_given_cpu():
    """The port's entry points run on the card unless the caller asks for
    the CPU, in a spawned replica too: a builder that leaves the device
    at None fails in the child without a card."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default is the happy path")
    with pytest.raises(ReplicaError, match="CUDA"):
        EngineReplica(build_tiny, replica_id="c", mode="subprocess")


# ------------------------------------------------------- across frameworks
def test_draft_state_cross_loads_between_jax_and_torch(tmp_path):
    """The JAX engine and the port's serve the same requests on the same
    weights (``params_from_jax``): their payloads are equal, both packages
    write the same file byte for byte, and a file saved by either engine
    loads into the other and retrieves the same branches."""
    import dataclasses

    from repro.fleet import persist as jpersist
    from repro.models import transformer as jtx
    from repro.serving import api as japi
    from repro_torch.models import transformer as ttx

    jcfg = jtx.TransformerConfig(n_layers=1, d_model=32, n_heads=4,
                                 n_kv_heads=2, d_ff=64, vocab_size=53,
                                 max_seq_len=160)
    tcfg = ttx.TransformerConfig(**dataclasses.asdict(jcfg))
    jp = jtx.init_params(jcfg, jax.random.key(11))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    kw = dict(lanes=2, prefill_len=32, decoding_length=8, branch_length=4)
    j_engine = japi.build_engine(japi.EngineConfig(**kw), jcfg, jp)
    t_engine = build_engine(EngineConfig(**kw), tcfg, tp, device="cpu")
    reqs = _reqs(6, sources=("trie", "ngram"))
    outs = []
    for engine, req_cls, sp_cls, pol_cls in (
            (j_engine, japi.Request, japi.SamplingParams, japi.DraftPolicy),
            (t_engine, Request, SamplingParams, DraftPolicy)):
        handles = [engine.submit(req_cls(
            prompt=list(r.prompt), params=sp_cls(
                max_new_tokens=r.params.max_new_tokens,
                draft=pol_cls(sources=r.params.draft.sources,
                              namespace=r.params.draft.namespace))))
                   for r in reqs]
        engine.run()
        outs.append([h.result().tokens for h in handles])
    assert outs[0] == outs[1]
    j_payload = j_engine.draft_state()
    t_payload = t_engine.draft_state()
    assert set(t_payload["sources"]) == {"trie", "ngram"}
    assert json.loads(json.dumps(j_payload)) == \
        json.loads(json.dumps(t_payload))

    j_path, t_path = str(tmp_path / "jax.json"), str(tmp_path / "torch.json")
    jpersist.save_draft_state(j_path, j_payload)
    save_draft_state(t_path, t_payload)
    assert open(j_path, "rb").read() == open(t_path, "rb").read()

    ctxs = [list(r.prompt[-3:]) for r in reqs] + [outs[0][0][:4]]
    for donor, path, cold in (
            (j_engine, j_path, build_engine(EngineConfig(**kw), tcfg, tp,
                                            device="cpu")),
            (t_engine, t_path, japi.build_engine(japi.EngineConfig(**kw),
                                                 jcfg, jp))):
        cold.load_draft_state(path)
        for name in ("trie", "ngram"):
            want, got = donor.scheduler.sources[name], \
                cold.scheduler.sources[name]
            for ns in ("docs", "code", "chat"):
                for ctx in ctxs:
                    assert got.retrieve(99, ctx, budget=8, namespace=ns) == \
                        want.retrieve(99, ctx, budget=8, namespace=ns)
