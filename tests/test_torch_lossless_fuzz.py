"""Losslessness fuzz of the scheduler's feature matrix on the port's step
functions (the matrix of tests/test_lossless_fuzz.py, on torch), with
sampled lanes among the greedy ones.

Random workloads — prompts, arrival orders, per-request budgets, greedy or
sampled params (distinct temperatures and seeds), KV block sizes — go
through ``ContinuousScheduler`` on the CPU, and every request's output must
equal the port's ``reference_decode`` through the same session, across the
(kv layout x attention backend) matrix

    dense/dense   dense/cuda   paged/dense   paged/cuda

(the ``cuda`` backend's kernels take their plain versions on CPU tensors),
under overlap, block backpressure, draft-source mixes, the prefix cache,
cancellation and per-namespace autotuning.  Sessions are built once per
cell and reused; reference decodes are memoized.  Examples come from a
drawn integer seed, as in the reference suite.

Every scheduler here runs with ``sanitize=True``, as in the reference
suite: the port's runtime sanitizer (lifecycle machine, shadow block
ledger with its poison probe of the KV tensors, retrace monitor on the
session's input signatures) audits each run at idle, so a passing example
also means no ledger, lifecycle or retrace violation.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.core import DraftPolicy, LookaheadConfig, reference_decode
from repro_torch.core.request import Request, SamplingParams
from repro_torch.models.params import init_params
from repro_torch.models.transformer import TransformerConfig
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.session import make_session_fns

pytestmark = [pytest.mark.torch_port, pytest.mark.paged]

PREFILL = 32
SLOTS = 9
VOCAB = 53
BLOCK_SIZES = (8, 16)          # drawn per example for the paged cells

_CFG = TransformerConfig(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2,
                         d_ff=64, vocab_size=VOCAB, max_seq_len=160)
_PARAMS = init_params(_CFG, seed=11, device="cpu")
_SESSIONS = {}
_REFS = {}
_LA = LookaheadConfig(decoding_length=SLOTS - 1, branch_length=4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Tiny models gain nothing from intra-op threads, and the suite runs
    several test processes side by side: one thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cells(block_size):
    return (("dense", "dense", 0), ("dense", "cuda", 0),
            ("paged", "dense", block_size), ("paged", "cuda", block_size))


def _get_fns(layout, backend, block_size):
    key = (layout, backend, block_size)
    if key not in _SESSIONS:
        _SESSIONS[key] = make_session_fns(
            _CFG, _PARAMS, slots=SLOTS, prefill_len=PREFILL, backend=backend,
            kv_layout=layout, device="cpu",
            block_size=block_size if layout == "paged" else None)
    return _SESSIONS[key]


def _ref(cell_key, prompt, params):
    key = (cell_key, tuple(prompt), params)
    if key not in _REFS:
        _REFS[key] = reference_decode(_get_fns(*cell_key), prompt,
                                      params=params)
    return _REFS[key]


def _workload(rng, n_req, max_len, max_budget, min_budget=1):
    """Prompts and params: each request greedy or sampled (its own
    temperature and seed), with a random budget."""
    prompts = [rng.randint(1, VOCAB - 1,
                           size=rng.randint(1, max_len)).tolist()
               for _ in range(n_req)]
    params = []
    for _ in range(n_req):
        budget = int(rng.randint(min_budget, max_budget))
        if rng.rand() < 0.5:
            params.append(SamplingParams(max_new_tokens=budget))
        else:
            params.append(SamplingParams(
                max_new_tokens=budget, sample=True,
                temperature=float(rng.choice([0.5, 0.8, 1.3])),
                seed=int(rng.randint(0, 2**32, dtype=np.uint64))))
    return prompts, params


def _run(sched, prompts, params, order=None):
    order = range(len(prompts)) if order is None else order
    handles = {int(i): sched.submit_request(Request(prompt=list(prompts[i]),
                                                    params=params[i]))
               for i in order}
    res = sched.run()
    assert len(res) == len(prompts)
    return [handles[i].result().tokens for i in range(len(prompts))]


@pytest.mark.parametrize("overlap", [False, True])
@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(1, 4), st.integers(0, 1))
def test_fuzz_scheduler_matches_reference_decode(overlap, seed, n_req,
                                                 bs_idx):
    """Every matrix cell, serial and with overlap_drafts: each request
    equals reference_decode, every cell agrees with every other, and the
    fused step makes one host sync per decode step."""
    rng = np.random.RandomState(seed % 2**31)
    block_size = BLOCK_SIZES[bs_idx]
    prompts, params = _workload(rng, n_req, PREFILL - 4, 18)
    order = rng.permutation(n_req)
    lanes = int(rng.randint(1, 3))
    outputs = {}
    for cell in _cells(block_size):
        sched = ContinuousScheduler(_get_fns(*cell), _LA, lanes=lanes,
                                    prefill_len=PREFILL,
                                    overlap_drafts=overlap, sanitize=True)
        got = _run(sched, prompts, params, order)
        for i, toks in enumerate(got):
            assert toks == _ref(cell, prompts[i], params[i]), (cell, seed, i)
        assert sched.stats.decode_syncs == sched.stats.decode_steps
        assert not sched._retired and not sched._pending
        outputs[cell] = got
    baseline = outputs[("dense", "dense", 0)]
    for cell, got in outputs.items():
        assert got == baseline, (cell, seed)


@settings(max_examples=4, deadline=None)
@given(st.integers(0, 2**31 - 1))
def test_fuzz_paged_backpressure_lossless(seed):
    """A pool that holds one worst-case request at a time: admissions
    serialize behind block backpressure, outputs stay the same."""
    rng = np.random.RandomState(seed % 2**31)
    prompts, params = _workload(rng, int(rng.randint(2, 6)), 20, 12)
    cell = ("paged", "dense", 8)
    fns = _SESSIONS.get("small")
    if fns is None:
        fns = _SESSIONS["small"] = make_session_fns(
            _CFG, _PARAMS, slots=SLOTS, prefill_len=PREFILL,
            kv_layout="paged", block_size=8, n_blocks=7, device="cpu")
    sched = ContinuousScheduler(fns, _LA, lanes=2, prefill_len=PREFILL,
                                sanitize=True)
    for i, toks in enumerate(_run(sched, prompts, params)):
        assert toks == _ref(cell, prompts[i], params[i]), (seed, i)


_SOURCE_COMBOS = (("trie",), ("prompt_copy",), ("ngram",),
                  ("trie", "ngram"), ("trie", "prompt_copy", "ngram"))


@pytest.mark.draft
@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, len(_SOURCE_COMBOS) - 1),
       st.integers(0, 1))
def test_fuzz_draft_sources_lossless(seed, combo_idx, adaptive):
    """Random draft-source combinations, quotas, namespaces and adaptive
    budgets change only which drafts are built: outputs equal
    reference_decode on a dense and a paged/cuda cell."""
    rng = np.random.RandomState(seed % 2**31)
    sources = _SOURCE_COMBOS[combo_idx]
    quotas = ()
    if len(sources) > 1 and rng.rand() < 0.5:
        quotas = tuple(int(rng.randint(1, SLOTS)) for _ in sources)
    policy = DraftPolicy(
        sources=sources, quotas=quotas,
        namespace="" if rng.rand() < 0.5 else f"ns{rng.randint(2)}",
        adaptive=bool(adaptive), min_budget=int(rng.randint(1, SLOTS)))
    prompts, params = _workload(rng, int(rng.randint(1, 5)), PREFILL - 4, 16)
    lanes = int(rng.randint(1, 3))
    for cell in (("dense", "dense", 0), ("paged", "cuda", 8)):
        sched = ContinuousScheduler(_get_fns(*cell), _LA, lanes=lanes,
                                    prefill_len=PREFILL, draft_policy=policy,
                                    sanitize=True)
        for i, toks in enumerate(_run(sched, prompts, params)):
            assert toks == _ref(cell, prompts[i], params[i]), \
                (cell, seed, sources, i)


@pytest.mark.prefix
@pytest.mark.parametrize("overlap", [False, True])
@settings(max_examples=3, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 1))
def test_fuzz_prefix_cache_lossless(overlap, seed, bs_idx):
    """Shared-prefix prompt sets (a common head, random tails, one miss)
    through the paged cells with the prefix cache on and off: block sharing,
    copy-on-write forks and the suffix prefill change no token."""
    rng = np.random.RandomState(seed % 2**31)
    block_size = BLOCK_SIZES[bs_idx]
    shared = rng.randint(1, VOCAB - 1,
                         size=int(rng.randint(4, PREFILL - 10))).tolist()
    n_req = int(rng.randint(2, 6))
    tails, params = _workload(rng, n_req + 1, PREFILL - len(shared), 14)
    prompts = [shared + t for t in tails[:n_req]] + [tails[n_req][:8]]
    lanes = int(rng.randint(1, 3))
    for backend in ("dense", "cuda"):
        cell = ("paged", backend, block_size)
        outs = {}
        for cached in (False, True):
            sched = ContinuousScheduler(_get_fns(*cell), _LA, lanes=lanes,
                                        prefill_len=PREFILL,
                                        overlap_drafts=overlap,
                                        prefix_cache=cached, sanitize=True)
            got = _run(sched, prompts, params)
            for i, toks in enumerate(got):
                assert toks == _ref(cell, prompts[i], params[i]), \
                    (cell, seed, cached, i)
            outs[cached] = got
        assert outs[True] == outs[False], (cell, seed)


@settings(max_examples=6, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(2, 6), st.integers(0, 1))
def test_fuzz_cancel_under_overlap_lossless(seed, n_req, bs_idx):
    """Random cancellations against overlap-mode schedulers with scrubbing
    on: every survivor equals reference_decode, every victim comes back
    flagged with a prefix of it, and no deferred state outlives idle."""
    rng = np.random.RandomState(seed % 2**31)
    block_size = BLOCK_SIZES[bs_idx]
    prompts, params = _workload(rng, n_req, PREFILL - 4, 18, min_budget=2)
    lanes = int(rng.randint(1, 3))
    victims = {int(i): int(rng.randint(0, 6))
               for i in rng.choice(n_req, size=max(1, n_req // 2),
                                   replace=False)}
    for cell in (("dense", "dense", 0), ("paged", "cuda", block_size)):
        sched = ContinuousScheduler(_get_fns(*cell), _LA, lanes=lanes,
                                    prefill_len=PREFILL, overlap_drafts=True,
                                    scrub_freed=True, sanitize=True)
        rid_to_idx = {sched.submit_request(Request(
            prompt=list(p), params=sp)).rid: i
            for i, (p, sp) in enumerate(zip(prompts, params))}
        step = 0
        while not sched.idle:
            for rid, at in victims.items():
                if step == at and rid not in sched.results:
                    sched.cancel(rid)
            sched.step()
            step += 1
        assert not sched._retired and not sched._pending
        if sched.allocator is not None:
            assert not sched.allocator._tables
        assert len(sched.results) == n_req
        for rid, res in sched.results.items():
            i = rid_to_idx[rid]
            ref = _ref(cell, prompts[i], params[i])
            if res.cancelled:
                assert rid in victims and res.finish_reason == "cancelled"
                assert res.tokens == ref[:len(res.tokens)], (cell, seed, i)
            else:
                assert res.tokens == ref, (cell, seed, i)


@pytest.mark.parametrize("shares_on", [False, True])
@settings(max_examples=3, deadline=None)
@given(st.integers(0, 2**31 - 1), st.integers(0, 1))
def test_fuzz_mixed_namespace_autotune_lossless(shares_on, seed, bs_idx):
    """Mixed-namespace traffic with the per-namespace draft controller on
    and off (and weighted-fair lane shares): the controller only gates
    which drafts are built, so both runs equal reference_decode."""
    import dataclasses

    from repro_torch.core.autotune import AutoTuneConfig, AutoTuner

    rng = np.random.RandomState(seed % 2**31)
    block_size = BLOCK_SIZES[bs_idx]
    prompts, params = _workload(rng, int(rng.randint(2, 7)), PREFILL - 4, 16)
    combos = (("trie",), ("trie", "ngram"), ("trie", "prompt_copy", "ngram"))
    params = [dataclasses.replace(sp, draft=DraftPolicy(
        sources=combos[rng.randint(len(combos))],
        namespace=f"ns{rng.randint(2)}")) for sp in params]
    lanes = int(rng.randint(1, 3))
    shares = {"ns0": 0.5, "ns1": 0.5} if shares_on else None
    for cell in (("dense", "dense", 0), ("paged", "dense", block_size)):
        outs = {}
        for tune in (False, True):
            autotune = (AutoTuner(AutoTuneConfig(min_trials=2, drop_rate=0.3,
                                                 probe_period=2))
                        if tune else False)
            sched = ContinuousScheduler(_get_fns(*cell), _LA, lanes=lanes,
                                        prefill_len=PREFILL,
                                        lane_shares=shares, autotune=autotune,
                                        sanitize=True)
            got = _run(sched, prompts, params)
            for i, toks in enumerate(got):
                ref = _ref(cell, prompts[i],
                           dataclasses.replace(params[i], draft=None))
                assert toks == ref, (cell, seed, tune, i)
            outs[tune] = got
        assert outs[True] == outs[False], (cell, seed)
