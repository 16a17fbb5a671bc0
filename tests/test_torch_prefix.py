"""The port's prefix-cache device surface (suffix prefill through the
paged tables, the copy-on-write block copy, the bucketed ``prefill_suffix``)
and its serving path held against the JAX package on the CPU, mirroring the
serving half of tests/test_prefix_cache.py.

Both frameworks run the same weights (JAX ``init_params`` converted with
``params_from_jax``) on inputs made from a numpy seed.  Tolerances: logits
and KV rows atol=2e-5, rtol=1e-4 (f32 sums in another order); token
streams, untouched KV rows and compile counts exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as jtx
from repro.serving import api as japi
from repro_torch.core import reference_decode
from repro_torch.core.draft_sources import DraftPolicy
from repro_torch.core.request import Request, SamplingParams
from repro_torch.models import transformer as ttx
from repro_torch.models.params import params_from_jax
from repro_torch.serving import api as tapi

pytestmark = [pytest.mark.torch_port, pytest.mark.prefix]

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
BS = 16


@pytest.fixture(scope="module")
def small_model():
    """2 layers, d 64, GQA 4/2, dh 16, paged with 16-row blocks."""
    jcfg = jtx.TransformerConfig(vocab_size=128, d_model=64, n_layers=2,
                                 n_heads=4, n_kv_heads=2, d_ff=128,
                                 max_seq_len=256, kv_layout="paged",
                                 kv_block_size=BS)
    tcfg = ttx.TransformerConfig(**{**dataclasses.asdict(jcfg),
                                    "prefill_backend": "cuda",
                                    "decode_backend": "cuda"})
    jp = jtx.init_params(jcfg, jax.random.key(0))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _ecfg(api, *, prefix_cache, overlap=False, n_blocks=None, scrub=True,
          decode_backend=None, max_new=10):
    return api.EngineConfig(
        lanes=2, prefill_len=64, decoding_length=4, branch_length=4,
        kv_layout="paged", block_size=BS, scrub_freed=scrub,
        prefix_cache=prefix_cache, overlap_drafts=overlap,
        n_blocks=n_blocks, decode_backend=decode_backend,
        default_params=SamplingParams(max_new_tokens=max_new))


def _serve(model, prompts, namespaces=None, **kw):
    _, _, tcfg, tp = model
    eng = tapi.build_engine(_ecfg(tapi, **kw), tcfg, tp, device="cpu")
    handles = []
    for i, p in enumerate(prompts):
        draft = DraftPolicy(namespace=namespaces[i]) if namespaces else None
        sp = SamplingParams(max_new_tokens=10, draft=draft)
        handles.append(eng.submit(Request(prompt=p, params=sp)))
    eng.run()
    return [h.result().tokens for h in handles], eng


def _shared_prompts(n, seed=0, shared_len=40, tail=12):
    rng = np.random.RandomState(seed)
    shared = rng.randint(1, 128, size=shared_len).tolist()
    return [shared + rng.randint(1, 128, size=tail).tolist()
            for _ in range(n)]


def _pools(nb, seed):
    rng = np.random.RandomState(seed)
    return (rng.randn(2, nb, BS, 2, 16).astype(np.float32),
            rng.randn(2, nb, BS, 2, 16).astype(np.float32))


def _suffix_step(model, backend, bt, k, v, offset, n, bucket, seed):
    """prefill_from_offset_paged in both frameworks on lane 1 of ``bt``:
    n real suffix tokens padded to ``bucket``.  Returns the (torch, JAX)
    (cache, logits) pairs."""
    jcfg, jp, tcfg, tp = model
    tcfg = dataclasses.replace(tcfg, decode_backend=backend)
    toks = np.zeros((1, bucket), np.int32)
    toks[0, :n] = np.random.RandomState(seed).randint(1, 128, size=n)
    off = np.asarray([offset], np.int32)
    lens = np.asarray([n], np.int32)
    tc = {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
          "block_tables": torch.from_numpy(bt)}
    jc = {"k": jnp.asarray(k), "v": jnp.asarray(v),
          "block_tables": jnp.asarray(bt)}
    t = ttx.prefill_from_offset_paged(tcfg, tp, tc, 1, torch.from_numpy(toks),
                                      torch.from_numpy(off),
                                      torch.from_numpy(lens))
    j = jtx.prefill_from_offset_paged(jcfg, jp, jc, jnp.int32(1),
                                      jnp.asarray(toks), jnp.asarray(off),
                                      jnp.asarray(lens))
    return t, j


# ------------------------------------------------------- model functions
@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_prefill_from_offset_paged_matches_jax(small_model, backend):
    """Suffix prefill at offset 37 (mid-block), 11 real tokens in a 16-slot
    bucket: logits and the pool after the scatter (NULL block excepted)."""
    bt = np.zeros((2, 16), np.int32)
    bt[0, :2] = [9, 4]
    bt[1, :4] = [6, 2, 11, 3]             # out of order, NULL tail
    k, v = _pools(12, seed=1)
    (tc, tl), (jc, jl) = _suffix_step(small_model, backend, bt, k, v,
                                      offset=37, n=11, bucket=16, seed=2)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **LOGIT_TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(tc[name][:, 1:].numpy(),
                                   np.asarray(jc[name])[:, 1:], **LOGIT_TOL)
    # lane 0's blocks and the unused blocks are untouched
    for blk in (9, 4, 1, 5, 7, 8, 10):
        assert torch.equal(tc["k"][:, blk], torch.from_numpy(k[:, blk]))


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_suffix_pad_slots_never_touch_committed_kv(small_model, backend):
    """Pad slots past the table's span clip onto the lane's last block
    (``paged_row_index``); ``slot_valid`` redirects them to the NULL block,
    so the committed rows of that block survive.  Offset 253 on a full
    table, 2 real tokens in an 8-slot bucket: pad positions 255..260 reach
    past max_seq_len 256."""
    bt = np.zeros((2, 16), np.int32)
    bt[1] = np.arange(1, 17)                  # every block allocated
    k, v = _pools(17, seed=3)
    (tc, _), (jc, _) = _suffix_step(small_model, backend, bt, k, v,
                                    offset=253, n=2, bucket=8, seed=4)
    last = 16                                  # logical block 15
    for name, base in (("k", k), ("v", v)):
        got = tc[name][:, last]
        # rows 0..12 (positions 240..252) committed; 13, 14 the suffix
        assert torch.equal(got[:, :13], torch.from_numpy(base[:, last, :13]))
        assert not torch.equal(got[:, 13:15],
                               torch.from_numpy(base[:, last, 13:15]))
        np.testing.assert_allclose(tc[name][:, 1:].numpy(),
                                   np.asarray(jc[name])[:, 1:], **LOGIT_TOL)


# ------------------------------------------------------------- serving
def test_serving_bit_identical_saves_prefill_and_matches_jax(small_model):
    """Cache on == cache off == reference_decode == the JAX engine with the
    cache on; hits, a COW fork and prefill tokens saved."""
    jcfg, jp, _, _ = small_model
    prompts = _shared_prompts(6) + [list(range(1, 31))]   # hits + one miss
    off, _ = _serve(small_model, prompts, prefix_cache=False)
    on, eng = _serve(small_model, prompts, prefix_cache=True)
    assert on == off
    st = eng.stats
    assert st.prefix_hits >= 3 and st.prefix_cow_forks >= 1
    assert st.prefill_tokens_saved >= 0.30
    for i in (0, 3, len(prompts) - 1):
        assert reference_decode(eng.fns, prompts[i], 10) == on[i]
    j_eng = japi.build_engine(_ecfg(japi, prefix_cache=True), jcfg, jp)
    hs = [j_eng.submit(list(p), max_new_tokens=10) for p in prompts]
    j_eng.run()
    assert [[int(t) for t in h.result().tokens] for h in hs] == on
    assert j_eng.stats.prefix_hits == st.prefix_hits
    assert j_eng.stats.prefix_cow_forks == st.prefix_cow_forks


@pytest.mark.parametrize("variant", ["overlap", "dense_decode"])
def test_serving_variants_identical(small_model, variant):
    """The draft/device overlap, and the dense (gather) decode backend,
    give the uncached path's tokens with the cache on."""
    prompts = _shared_prompts(8, seed=3)
    kw = (dict(overlap=True) if variant == "overlap"
          else dict(decode_backend="dense"))
    off, _ = _serve(small_model, prompts, prefix_cache=False)
    on, eng = _serve(small_model, prompts, prefix_cache=True, **kw)
    assert on == off and eng.stats.prefix_hits > 0


def test_suffix_buckets_count_the_buckets_touched(small_model):
    """The suffix prefill sees one input shape per bucket touched — never
    one per request — and every other member one shape."""
    rng = np.random.RandomState(5)
    shared = rng.randint(1, 128, size=40).tolist()
    tails = [3, 12, 9, 20, 5, 14, 2]         # suffixes of 3..20 tokens
    prompts = [shared + rng.randint(1, 128, size=t).tolist() for t in tails]
    _, eng = _serve(small_model, prompts, prefix_cache=True)
    fns = eng.fns
    assert fns.suffix_buckets == (8, 16, 32, 64)
    touched = set()
    for r in eng.scheduler.results.values():
        n_cached = r.stats.cached_prompt_tokens
        if n_cached:
            n = len(prompts[r.rid]) - n_cached
            touched.add(next(b for b in fns.suffix_buckets if b >= n))
    assert len(touched) >= 2
    assert fns.prefill_suffix._cache_size() == len(touched)
    assert fns.copy_block._cache_size() == 1
    assert fns.prefill._cache_size() == 1
    assert fns.prefill_into_slot._cache_size() <= 1
    assert fns.fused_step._cache_size() == 1


@pytest.mark.parametrize("overlap", [False, True])
def test_finish_admit_interleave_shared_prefix_scrub(small_model, overlap):
    """B shares A's promoted prefix blocks; C finishes and is scrubbed
    while B still decodes; B's own retire must not scrub the cache-held
    blocks.  With scrub_freed any violation destroys resident KV and breaks
    token equality; serial and with the overlap."""
    rng = np.random.RandomState(6)
    shared = rng.randint(1, 128, size=40).tolist()
    prompts = ([shared + rng.randint(1, 128, size=12).tolist()
                for _ in range(5)]
               + [rng.randint(1, 128, size=20).tolist()]   # unrelated C
               + [shared + rng.randint(1, 128, size=12).tolist()
                  for _ in range(3)])
    off, _ = _serve(small_model, prompts, prefix_cache=False)
    on, eng = _serve(small_model, prompts, prefix_cache=True,
                     overlap=overlap)
    assert on == off
    a = eng.scheduler.allocator
    assert not a._tables                           # all requests retired
    assert all(a.refcount(b) == 1 for b in a._cache_held)
    assert a.n_cache_only == eng.scheduler.prefix.n_blocks


def test_namespace_isolation_and_backpressure_eviction(small_model):
    """Two namespaces share no KV, and a pool so small that admissions must
    evict cached blocks still drains; outputs equal the uncached path."""
    prompts = _shared_prompts(8, seed=8)
    ns = ["a" if i % 2 == 0 else "b" for i in range(len(prompts))]
    off, _ = _serve(small_model, prompts, namespaces=ns, prefix_cache=False)
    on, eng = _serve(small_model, prompts, namespaces=ns, prefix_cache=True)
    assert on == off
    assert set(eng.scheduler.prefix._roots) >= {"a", "b"}
    # worst case per request ceil((52 + 10 + 5) / 16) = 5 blocks: 2 lanes
    # take 10 of the 10 usable, leaving the cache nothing of its own
    off, _ = _serve(small_model, prompts, prefix_cache=False, n_blocks=11)
    on, eng = _serve(small_model, prompts, prefix_cache=True, n_blocks=11)
    assert on == off
    assert eng.stats.prefix_evicted_blocks > 0


# ------------------------------------- suffix prefill at the admission shape
def test_suffix_prefill_rows_match_padded_admission(small_model):
    """The suffix prefill's last-token logits and the tail's K/V rows in
    every layer equal the uncached admission's (the request in row ``slot``
    of a (lanes, prefill_len) batch) — on the card bit for bit
    (chip_smoke.py), here within f32 sum-order noise, because the two
    attention paths sum over other key counts on the CPU.  A 40-token head
    (mid-block) and a 23-token tail in a 32-slot bucket: the bucket's pad
    slots reach past prefill_len 64."""
    _, _, tcfg, tp = small_model
    rng = np.random.RandomState(9)
    head, tail, slot, plen = 40, 23, 1, 64
    prompt = rng.randint(1, 128, size=head + tail)
    bt = np.zeros((2, 16), np.int32)
    bt[0, :3] = [7, 8, 9]
    bt[1, :4] = [6, 2, 11, 3]

    def admit(n):
        cache = ttx.init_paged_cache(tcfg, 2, n_blocks=12)
        cache["block_tables"] = torch.from_numpy(bt)
        toks = np.zeros((2, plen), np.int32)
        toks[slot, :n] = prompt[:n]
        lens = np.asarray([1, 1], np.int32)
        lens[slot] = n
        return ttx.prefill_into_slot_paged(tcfg, tp, cache, slot,
                                           torch.from_numpy(toks),
                                           torch.from_numpy(lens))

    full_cache, full_logits = admit(head + tail)
    cache, _ = admit(head)
    toks = np.zeros((1, 32), np.int32)
    toks[0, :tail] = prompt[head:]
    cache, logits = ttx.prefill_from_offset_paged(
        tcfg, tp, cache, slot, torch.from_numpy(toks),
        torch.tensor([head], dtype=torch.int32),
        torch.tensor([tail], dtype=torch.int32), prefill_len=plen)
    np.testing.assert_allclose(logits.numpy(), full_logits.numpy(),
                               **LOGIT_TOL)
    rows = ttx.paged_row_index(torch.from_numpy(bt[slot:slot + 1]),
                               torch.arange(head, head + tail)[None], BS)[0]
    for name in ("k", "v"):
        got = cache[name].flatten(1, 2)[:, rows]
        want = full_cache[name].flatten(1, 2)[:, rows]
        np.testing.assert_allclose(got.numpy(), want.numpy(), **LOGIT_TOL)
        # the head's rows are the head-only admission's, untouched
        head_rows = ttx.paged_row_index(torch.from_numpy(bt[slot:slot + 1]),
                                        torch.arange(head)[None], BS)[0]
        assert torch.equal(cache[name].flatten(1, 2)[:, head_rows],
                           full_cache[name].flatten(1, 2)[:, head_rows])


@pytest.mark.parametrize("lanes", [2, 3])
def test_sampled_shared_prefix_cache_on_equals_off_and_reference(
        small_model, lanes):
    """Sampled requests (temperature 0.8, distinct seeds, unguided) that
    share a 40-token head: with the prefix cache on they draw the tokens
    they draw with it off, and those of ``reference_decode`` at the serving
    batch shape; the suffix prefill sees one input shape per bucket
    touched."""
    _, _, tcfg, tp = small_model
    rng = np.random.RandomState(10)
    shared = rng.randint(1, 128, size=40).tolist()
    tails = [12, 3, 9, 20, 5, 14, 7, 16]
    prompts = [shared + rng.randint(1, 128, size=t).tolist() for t in tails]
    sps = [SamplingParams(max_new_tokens=10, sample=True, temperature=0.8,
                          seed=300 + i) for i in range(len(prompts))]
    outs = {}
    for on in (False, True):
        ecfg = dataclasses.replace(_ecfg(tapi, prefix_cache=on), lanes=lanes)
        eng = tapi.build_engine(ecfg, tcfg, tp, device="cpu")
        hs = [eng.submit(Request(prompt=p, params=sp))
              for p, sp in zip(prompts, sps)]
        eng.run()
        outs[on] = [h.result().tokens for h in hs]
    assert outs[True] == outs[False]
    st, fns = eng.stats, eng.fns
    assert st.prefix_hits >= 3
    for p, sp, o in zip(prompts, sps, outs[True]):
        assert o == reference_decode(fns, p, params=sp, lanes=lanes)
    touched = set()
    for r in eng.scheduler.results.values():
        n_cached = r.stats.cached_prompt_tokens
        if n_cached:
            n = len(prompts[r.rid]) - n_cached
            touched.add(next(b for b in fns.suffix_buckets if b >= n))
    assert fns.prefill_suffix._cache_size() == len(touched) >= 1
