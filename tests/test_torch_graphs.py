"""The pieces of the port's CUDA-graph session that run on the CPU: lane and
block indices as runtime inputs of the model functions, the kernels' launch
counter registry, and the session's graph-cache policy.

  * Each slot- or block-indexed function of ``repro_torch.models.
    transformer`` gives the same bits with its index as a Python int and as
    a (1,) int32 tensor (the form a captured graph reads), for the first
    and the last lane on both KV layouts, and equals the JAX function at
    smoke size in f32: logits and KV rows atol=2e-5, rtol=1e-4 (f32 sums in
    another order, the tolerance of tests/test_torch_prefix.py and
    tests/test_torch_paged.py); untouched rows exact.
  * The counter registry's snapshot / diff / add arithmetic on every
    wrapper's counter.
  * A key's first call runs eagerly, its second captures, later ones
    replay; a member keeps at most ``MAX_GRAPHS``; a capture that fails
    raises on every call (capture and replay stubbed: a graph needs the
    card, where tests/test_torch_cuda.py holds them bit for bit).
  * A CPU session builds no graph, and its ``_cache_size()`` values equal
    the JAX session's on the same workload.
"""
import dataclasses
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtx
from repro.serving import api as japi
from repro_torch import kernels
from repro_torch.core.request import SamplingParams
from repro_torch.models import transformer as ttx
from repro_torch.models.params import params_from_jax
from repro_torch.serving import api as tapi
from repro_torch.serving import session

pytestmark = [pytest.mark.torch_port]

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
LANES, BS, S = 3, 16, 32


@pytest.fixture(scope="module")
def model():
    """2 layers, d 64, GQA 4/2, dh 16; blocks of 16 rows on the paged
    layout."""
    jcfg = jtx.TransformerConfig(vocab_size=128, d_model=64, n_layers=2,
                                 n_heads=4, n_kv_heads=2, d_ff=128,
                                 max_seq_len=128, kv_block_size=BS)
    tcfg = ttx.TransformerConfig(**{**dataclasses.asdict(jcfg),
                                    "prefill_backend": "cuda",
                                    "decode_backend": "cuda"})
    jp = jtx.init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _caches(tcfg, seed):
    """A dense (L, LANES, 128, 2, 16) cache and a paged pool of 26 blocks
    with shuffled tables, filled with noise (numpy, shared by both
    frameworks)."""
    rng = np.random.RandomState(seed)
    L, K, dh = tcfg.n_layers, tcfg.n_kv_heads, tcfg.dh
    dense = {n: rng.randn(L, LANES, tcfg.max_seq_len, K, dh).astype(
        np.float32) for n in ("k", "v")}
    bpl = tcfg.max_seq_len // BS
    pool = {n: rng.randn(L, 1 + LANES * bpl, BS, K, dh).astype(np.float32)
            for n in ("k", "v")}
    pool["block_tables"] = (1 + rng.permutation(LANES * bpl)).reshape(
        LANES, bpl).astype(np.int32)
    return dense, pool


def _prompt(seed, length=S):
    rng = np.random.RandomState(seed)
    toks = np.zeros((1, length), np.int32)
    n = length - 5
    toks[0, :n] = rng.randint(1, 128, size=n)
    return toks, np.asarray([n], np.int32)


def _padded(toks, lens, slot):
    """The session's padded admission: the request in row ``slot`` of a
    (LANES, S) batch, one pad token in every other row."""
    ptoks = np.zeros((LANES, toks.shape[1]), np.int32)
    ptoks[slot] = toks[0]
    plens = np.ones((LANES,), np.int32)
    plens[slot] = lens[0]
    return ptoks, plens


def _torch_call(name, tcfg, tp, cache, slot, toks, lens):
    """Run ``name`` on a torch copy of ``cache`` with index ``slot`` (an int
    or a tensor); returns (cache, logits or None)."""
    c = {k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    t = torch.from_numpy
    if name == "prefill_into_slot":
        ptoks, plens = _padded(toks, lens, int(slot))
        return ttx.prefill_into_slot(tcfg, tp, c, slot, t(ptoks), t(plens))
    if name == "prefill_into_slot_paged":
        ptoks, plens = _padded(toks, lens, int(slot))
        return ttx.prefill_into_slot_paged(tcfg, tp, c, slot, t(ptoks),
                                           t(plens))
    if name == "prefill_from_offset_paged":
        tail = np.zeros((1, 16), np.int32)
        tail[0, :11] = toks[0, :11]
        return ttx.prefill_from_offset_paged(
            tcfg, tp, c, slot, t(tail), t(np.asarray([37], np.int32)),
            t(np.asarray([11], np.int32)))
    if name == "reset_slot":
        return ttx.reset_slot(c, slot), None
    if name == "copy_paged_block":
        return ttx.copy_paged_block(c, slot + 1, slot), None
    raise AssertionError(name)


def _jax_call(name, jcfg, jp, cache, slot, toks, lens):
    c = {k: jnp.asarray(v) for k, v in cache.items()}
    s = jnp.int32(slot)
    if name == "prefill_into_slot":
        return jtx.prefill_into_slot(jcfg, jp, c, s, jnp.asarray(toks),
                                     jnp.asarray(lens))
    if name == "prefill_into_slot_paged":
        return jtx.prefill_into_slot_paged(jcfg, jp, c, s, jnp.asarray(toks),
                                           jnp.asarray(lens))
    if name == "prefill_from_offset_paged":
        tail = np.zeros((1, 16), np.int32)
        tail[0, :11] = toks[0, :11]
        return jtx.prefill_from_offset_paged(
            jcfg, jp, c, s, jnp.asarray(tail), jnp.asarray([37], jnp.int32),
            jnp.asarray([11], jnp.int32))
    if name == "reset_slot":
        return jtx.reset_slot(c, s), None
    if name == "copy_paged_block":
        return jtx.copy_paged_block(c, jnp.int32(slot + 1), s), None
    raise AssertionError(name)


@pytest.mark.parametrize("lane", ["first", "last"])
@pytest.mark.parametrize("name", ["prefill_into_slot", "reset_slot",
                                  "prefill_into_slot_paged",
                                  "prefill_from_offset_paged",
                                  "copy_paged_block"])
def test_index_as_int_or_tensor_same_bits_and_matches_jax(model, name, lane):
    """The index as a Python int and as a (1,) int32 tensor give the same
    cache and logits bit for bit; both equal the JAX function (its index a
    traced int32 scalar) within LOGIT_TOL, and every lane or block the call
    does not own is untouched."""
    jcfg, jp, tcfg, tp = model
    paged = name.endswith("paged") or name == "copy_paged_block"
    if paged:
        jcfg = dataclasses.replace(jcfg, kv_layout="paged")
        tcfg = dataclasses.replace(tcfg, kv_layout="paged")
    slot = 0 if lane == "first" else LANES - 1
    dense, pool = _caches(tcfg, seed=slot + 3)
    cache = pool if paged else dense
    toks, lens = _prompt(seed=slot)

    c_int, l_int = _torch_call(name, tcfg, tp, cache, slot, toks, lens)
    c_t, l_t = _torch_call(name, tcfg, tp, cache,
                           torch.tensor([slot], dtype=torch.int32), toks,
                           lens)
    for k in cache:
        assert torch.equal(c_int[k], c_t[k]), k
    if l_int is not None:
        assert torch.equal(l_int, l_t)

    c_j, l_j = _jax_call(name, jcfg, jp, cache, slot, toks, lens)
    if l_int is not None:
        np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), **LOGIT_TOL)
    valid, garbage = _written_rows(name, tcfg, cache, slot, int(lens[0]))
    for k in ("k", "v"):
        shape = (tcfg.n_layers, -1) + cache[k].shape[-2:]
        got = c_t[k].numpy().reshape(shape)
        want = np.asarray(c_j[k]).reshape(shape)
        np.testing.assert_allclose(got[:, valid], want[:, valid],
                                   **LOGIT_TOL)
        kept = ~(valid | garbage)
        np.testing.assert_array_equal(got[:, kept],
                                      cache[k].reshape(shape)[:, kept])
    if paged:
        np.testing.assert_array_equal(c_t["block_tables"].numpy(),
                                      pool["block_tables"])


def _written_rows(name, tcfg, cache, slot, n):
    """Flat cache rows (lanes x positions, or blocks x block rows) that the
    call writes with real values (``valid``) and with values no one reads
    (``garbage``: prompt padding, the paged NULL block)."""
    rows = cache["k"].shape[1] * cache["k"].shape[2]
    valid = np.zeros(rows, bool)
    garbage = np.zeros(rows, bool)
    if name in ("prefill_into_slot", "reset_slot"):
        lane = slot * tcfg.max_seq_len
        end = tcfg.max_seq_len if name == "reset_slot" else n
        valid[lane:lane + end] = True
        if name == "prefill_into_slot":
            garbage[lane + n:lane + S] = True
        return valid, garbage
    garbage[:BS] = True                     # the NULL block
    if name == "copy_paged_block":
        valid[BS:] = True
        return valid, garbage
    bt = cache["block_tables"][slot]
    pos = {"prefill_into_slot_paged": np.arange(n),
           "prefill_from_offset_paged": np.arange(37, 48)}[name]
    valid[bt[pos // BS] * BS + pos % BS] = True
    if name == "prefill_into_slot_paged":
        pad = np.arange(n, S)
        garbage[bt[pad // BS] * BS + pad % BS] = True
    return valid, garbage


@pytest.mark.parametrize("name", list(kernels.COUNTERS))
def test_counter_registry_snapshot_diff_add(name):
    """add moves the wrapper's own counter attribute, diff reports only the
    kernels that moved, and add(-times) takes the launches back."""
    module, fn, attr = kernels.COUNTERS[name]
    holder = getattr(__import__(f"repro_torch.kernels.{module}",
                                fromlist=[fn]), fn)
    before = kernels.snapshot()
    assert before[name] == getattr(holder, attr)
    try:
        kernels.add({name: 7}, 3)
        after = kernels.snapshot()
        assert getattr(holder, attr) == before[name] + 21
        assert kernels.diff(after, before) == {name: 21}
        kernels.add({name: 7}, -3)
        assert kernels.snapshot() == before
        assert kernels.diff(before, before) == {}
    finally:
        setattr(holder, attr, before[name])


class _Stub:
    """Capture and replay stand-ins for the graph-cache policy: they record
    what ran, and a graph is a counter of its replays."""

    def __init__(self, member, fail=False):
        self.log = []
        member._capture = self.capture
        member._replay = self.replay
        self.fail = fail

    def capture(self, cache, inputs):
        if self.fail:
            raise RuntimeError("cannot capture")
        self.log.append("capture")
        return session._Graph(None, (), None, None, {})

    def replay(self, g, cache, inputs):
        self.log.append("replay")
        return "replayed"


def _member():
    ran = []

    def body(cache, x):
        ran.append(int(x[0]))
        return "eager"

    def stage(cache, x):
        return cache, (torch.tensor([x], dtype=torch.int32),)

    return session._Member("m", body, stage, put=lambda t: t,
                           stream=object()), ran


def test_graph_cache_first_call_eager_then_capture_then_replay():
    m, ran = _member()
    stub = _Stub(m)
    cache = {"k": torch.zeros(4), "v": torch.zeros(4)}
    assert [m(cache, i) for i in range(4)] == ["eager"] + ["replayed"] * 3
    assert ran == [0] and stub.log == ["capture", "replay", "replay",
                                       "replay"]
    assert m._cache_size() == 1 and m._n_graphs() == 1
    # another cache (other storage) is another key: eager first again
    other = {"k": torch.zeros(4), "v": torch.zeros(4)}
    assert m(other, 9) == "eager" and ran == [0, 9]
    # the block table is not keyed: a new table tensor replays
    paged = {"k": torch.zeros(4), "v": torch.zeros(4),
             "block_tables": torch.zeros(2, dtype=torch.int32)}
    m(paged, 1)
    paged["block_tables"] = torch.ones(2, dtype=torch.int32)
    assert m(paged, 2) == "replayed"


def test_graph_cache_keeps_at_most_max_graphs():
    m, ran = _member()
    stub = _Stub(m)
    caches = [{"k": torch.zeros(2)} for _ in range(session.MAX_GRAPHS + 1)]
    for c in caches:
        m(c, 0)
        m(c, 0)
    assert m._n_graphs() == session.MAX_GRAPHS
    assert stub.log.count("capture") == session.MAX_GRAPHS + 1
    assert m(caches[-1], 0) == "replayed"          # kept
    assert m(caches[0], 0) == "eager"              # dropped: eager again


def test_graph_cache_holds_no_cache_and_drops_its_key_when_it_dies():
    """A graph keeps no strong reference to the cache it writes: once the
    caller drops that cache its tensors are freed, and the member's next
    call drops the key, so a later cache (even at the same storage) runs
    eagerly first and never replays a graph written for the dead one."""
    m, ran = _member()
    stub = _Stub(m)
    cache = {"k": torch.zeros(4), "v": torch.zeros(4),
             "block_tables": torch.zeros(2, dtype=torch.int32)}
    assert [m(cache, i) for i in range(3)] == ["eager", "replayed",
                                               "replayed"]
    k = weakref.ref(cache["k"])
    del cache
    assert k() is None
    assert m._n_graphs() == 1                 # not yet pruned
    other = {"k": torch.zeros(4), "v": torch.zeros(4),
             "block_tables": torch.zeros(2, dtype=torch.int32)}
    assert m(other, 5) == "eager" and ran == [0, 5]
    assert m._n_graphs() == 0 and len(m._graphs) == 1
    assert m(other, 6) == "replayed" and m._n_graphs() == 1
    assert stub.log == ["capture", "replay", "replay", "capture", "replay"]


def test_graph_cache_failed_capture_raises_every_call():
    m, ran = _member()
    _Stub(m, fail=True)
    cache = {"k": torch.zeros(2)}
    assert m(cache, 0) == "eager"
    for _ in range(2):
        with pytest.raises(RuntimeError, match="cannot capture"):
            m(cache, 0)
    assert ran == [0]


def test_cpu_session_builds_no_graph_and_counts_like_jax(model):
    """A CPU session (cuda_graphs left on) runs every member eagerly: no
    capture stream, no graph; its compile-once counts equal the JAX
    session's on the same paged prefix-cache workload."""
    jcfg, jp, tcfg, tp = model
    sp = SamplingParams(max_new_tokens=6)

    def ecfg(api):
        return api.EngineConfig(
            lanes=2, prefill_len=64, decoding_length=4, branch_length=4,
            kv_layout="paged", block_size=BS, prefix_cache=True,
            scrub_freed=True, default_params=sp)

    rng = np.random.RandomState(5)
    head = rng.randint(1, 128, size=40).tolist()
    prompts = [head + rng.randint(1, 128, size=12).tolist()
               for _ in range(4)] + [rng.randint(1, 128, size=30).tolist()]
    teng = tapi.build_engine(ecfg(tapi), tcfg, tp, device="cpu")
    jeng = japi.build_engine(ecfg(japi), jcfg, jp)
    for eng in (teng, jeng):
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        eng.run()
    names = ("prefill", "prefill_into_slot", "fused_step", "tree_step",
             "commit", "prefill_suffix", "copy_block", "reset_blocks")
    for n in names:
        t = getattr(teng.fns, n)
        assert t._cache_size() == getattr(jeng.fns, n)._cache_size(), n
        t = getattr(t, "member", t)
        assert t._stream is None and t._n_graphs() == 0 and not t.captures
    assert teng.fns.fused_step._cache_size() == 1
    assert teng.stats.prefix_hits > 0
