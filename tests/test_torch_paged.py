"""The port's paged KV layout (repro_torch, kernel B2's plain version, the
paged model functions and the paged serving path) held against the JAX
package on the CPU, mirroring tests/test_paged_cache.py.

Both frameworks run the same weights (JAX ``init_params`` converted with
``params_from_jax``) on inputs made from a numpy seed.  Tolerances:

  * kernel B2's plain version against the JAX Pallas kernel in interpret
    mode: f32 atol=3e-5, rtol=1e-4 (f32 sums in another order);
  * logits and KV rows of the model functions: atol=2e-5, rtol=1e-4;
  * token streams, block tables and scrubbed rows: exact.

The CUDA kernel itself is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import reference_decode as j_reference_decode
from repro.core.strategies import LookaheadConfig as JLookaheadConfig
from repro.models import transformer as jtx
from repro.models.attention import build_full_tree_mask as j_full_mask
from repro.serving.scheduler import ContinuousScheduler as JScheduler
from repro.serving.session import make_session_fns as j_make_session_fns
from repro_torch.core import LookaheadConfig, LookaheadEngine, \
    reference_decode
from repro_torch.kernels.tree_attention.paged import paged_tree_attention
from repro_torch.models import transformer as ttx
from repro_torch.models.params import params_from_jax
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.serving.session import make_session_fns

pytestmark = [pytest.mark.torch_port, pytest.mark.paged]

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
KERNEL_TOL = dict(atol=3e-5, rtol=1e-4)
PREFILL = 32
BS = 16


def _model(seed=0, max_seq_len=160, **kw):
    """2 layers, d 64, GQA 4/2, dh 16, in both frameworks."""
    jcfg = jtx.TransformerConfig(n_layers=2, d_model=64, n_heads=4,
                                 n_kv_heads=2, d_ff=128, vocab_size=53,
                                 max_seq_len=max_seq_len, **kw)
    tcfg = ttx.TransformerConfig(**{**dataclasses.asdict(jcfg),
                                    "prefill_backend": "cuda",
                                    "decode_backend": "cuda"})
    jp = jtx.init_params(jcfg, jax.random.key(seed))
    tp = params_from_jax(tcfg, jax.tree.map(np.asarray, jp), "cpu")
    return jcfg, jp, tcfg, tp


def _paged(cfg, **kw):
    return dataclasses.replace(cfg, kv_layout="paged", kv_block_size=BS,
                               **kw)


def _prompts(n, lo=4, hi=24, vocab=52, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, vocab, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or LOGIT_TOL))


def _tables():
    """(3, 10) tables of a 16-block pool: out of order, shared NULL tails,
    lane 2 mostly NULL."""
    bt = np.zeros((3, 10), np.int32)
    bt[0, :4] = [7, 2, 11, 5]
    bt[1, :3] = [3, 14, 9]
    bt[2, :1] = [12]
    return bt


def _pools(nb, K, dh, seed=1, L=2):
    rng = np.random.RandomState(seed)
    return (rng.randn(L, nb, BS, K, dh).astype(np.float32),
            rng.randn(L, nb, BS, K, dh).astype(np.float32))


def _jcache(k, v, bt):
    return {"k": jnp.asarray(k), "v": jnp.asarray(v),
            "block_tables": jnp.asarray(bt)}


def _tcache(k, v, bt):
    return {"k": torch.from_numpy(k.copy()), "v": torch.from_numpy(v.copy()),
            "block_tables": torch.from_numpy(bt.copy())}


def _tree(B, T, lens, seed):
    rng = np.random.RandomState(seed)
    parent = [-1] + [int(rng.randint(0, i)) for i in range(1, T)]
    tm = np.zeros((T, T), bool)
    for i in range(T):
        j = i
        while j >= 0:
            tm[i, j] = True
            j = parent[j]
    depth = tm.sum(-1) - 1
    tok = rng.randint(1, 52, size=(B, T)).astype(np.int32)
    pos = (np.asarray(lens)[:, None] + depth[None]).astype(np.int32)
    return tok, pos, np.broadcast_to(tm, (B, T, T)).copy()


# ------------------------------------------------------------------- layout
def test_init_paged_cache_shapes_match_jax():
    jcfg, _, tcfg, _ = _model()
    jcfg, tcfg = _paged(jcfg), _paged(tcfg)
    assert ttx.blocks_per_lane(tcfg) == jtx.blocks_per_lane(jcfg) == 10
    for n_blocks in (7, None):
        jc = jtx.init_paged_cache(jcfg, lanes=3, n_blocks=n_blocks)
        tc = ttx.init_paged_cache(tcfg, lanes=3, n_blocks=n_blocks,
                                  device="cpu")
        for name in ("k", "v", "block_tables"):
            assert tuple(tc[name].shape) == jc[name].shape
            assert not tc[name].any()
        assert tc["block_tables"].dtype == torch.int32
    # the default pool: every lane's worst case plus the NULL block 0
    assert ttx.init_paged_cache(tcfg, lanes=2)["k"].shape[1] == 1 + 2 * 10


def test_paged_row_index_matches_jax_including_clip():
    """Same rows as the reference, also for positions past the table's
    span, which clip to the lane's LAST entry (not to the NULL block)."""
    bt = _tables()
    rng = np.random.RandomState(2)
    pos = np.concatenate([rng.randint(0, 10 * BS, size=(3, 24)),
                          np.full((3, 1), 10 * BS),          # first past
                          rng.randint(10 * BS, 14 * BS, size=(3, 7))],
                         axis=1).astype(np.int32)
    j = jtx.paged_row_index(jnp.asarray(bt), jnp.asarray(pos), BS)
    t = ttx.paged_row_index(torch.from_numpy(bt), torch.from_numpy(pos), BS)
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    # the clip lands on the last table entry's block (the NULL block here,
    # as the tails are unallocated) ...
    assert (t[:, 24:].numpy() // BS == bt[:, -1:]).all()
    # ... and on a real block when the table is full: the aliasing hazard
    full = np.arange(1, 11, dtype=np.int32)[None]
    row = ttx.paged_row_index(torch.from_numpy(full),
                              torch.tensor([[10 * BS + 3]]), BS)
    assert int(row) == 10 * BS + 3


# ------------------------------------------------------------ kernel parity
@pytest.mark.parametrize("dh,bs", [(8, 16), (16, 8), (8, 32)])
def test_paged_plain_matches_jax_kernel(dh, bs):
    """Kernel B2's plain version (the CPU path of the wrapper) against the
    JAX Pallas kernel in interpret mode, with NULL entries and blocks out of
    order in the tables."""
    from repro.kernels.tree_attention.paged import \
        paged_tree_attention as j_paged
    rng = np.random.RandomState(0)
    B, T, H, K, nb, bpl = 3, 5, 4, 2, 9, 4
    q = rng.randn(B, T, H, dh).astype(np.float32)
    k = rng.randn(nb, bs, K, dh).astype(np.float32)
    v = rng.randn(nb, bs, K, dh).astype(np.float32)
    bt = np.asarray([[6, 2, 3, 0], [4, 1, 8, 7], [5, 0, 0, 0]], np.int32)
    lens = np.asarray([bs + 3, 2 * bs + 1, 4], np.int32)
    tree = np.zeros((B, T, T), bool)
    for b in range(B):
        tree[b] = np.tril(rng.rand(T, T) < 0.7) | np.eye(T, dtype=bool)
    mask = np.array(j_full_mask(jnp.asarray(lens), jnp.asarray(tree),
                                bpl * bs))
    want = j_paged(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(bt), jnp.asarray(mask))
    n0 = paged_tree_attention.launches
    got = paged_tree_attention(*(torch.from_numpy(x)
                                 for x in (q, k, v, bt, mask)))
    assert paged_tree_attention.launches == n0    # the plain version ran
    _close(got, want, **KERNEL_TOL)


# ------------------------------------------------------ model functions
@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_prefill_paged_rows_equal_dense_rows(backend):
    """Batched paged prefill: the logits of JAX ``prefill_paged``, and each
    prompt's rows below its length equal to the port's dense prefill rows,
    through the block permutation."""
    jcfg, jp, tcfg, tp = _model()
    tcfg = dataclasses.replace(tcfg, prefill_backend=backend)
    pj, pt = _paged(jcfg), _paged(tcfg)
    prompts = _prompts(2, lo=10, hi=30, seed=5)
    toks = np.zeros((2, PREFILL), np.int32)
    lens = np.asarray([len(p) for p in prompts], np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    bt = np.zeros((2, 10), np.int32)
    bt[0, :3] = [2, 7, 1]
    bt[1, :3] = [5, 3, 8]
    dense, dense_last = ttx.prefill(tcfg, tp, torch.from_numpy(toks),
                                    torch.from_numpy(lens),
                                    ttx.init_cache(tcfg, 2))
    tc = ttx.init_paged_cache(pt, lanes=2, n_blocks=9)
    tc["block_tables"] = torch.from_numpy(bt)
    tc, tl = ttx.prefill_paged(pt, tp, torch.from_numpy(toks),
                               torch.from_numpy(lens), tc)
    jc = jtx.init_paged_cache(pj, lanes=2, n_blocks=9)
    jc["block_tables"] = jnp.asarray(bt)
    jc, jl = jtx.prefill_paged(pj, jp, jnp.asarray(toks), jnp.asarray(lens),
                               jc)
    _close(tl, jl)
    assert torch.equal(tl, dense_last)
    rows = ttx.paged_row_index(torch.from_numpy(bt),
                               torch.arange(PREFILL)[None].repeat(2, 1), BS)
    for name in ("k", "v"):
        flat = tc[name].reshape(2, 9 * BS, 2, 16)
        jflat = np.asarray(jc[name]).reshape(2, 9 * BS, 2, 16)
        for b in range(2):
            r = rows[b, :int(lens[b])]
            assert torch.equal(flat[:, r], dense[name][:, b, :len(r)])
            _close(flat[:, r], jflat[:, r.numpy()])


def test_prefill_into_slot_paged_matches_jax():
    """One lane's prompt lands through its own table row; every other
    block of the pool is untouched."""
    jcfg, jp, tcfg, tp = _model()
    pj, pt = _paged(jcfg), _paged(tcfg)
    bt = _tables()
    k, v = _pools(16, 2, 16)
    toks = np.zeros((1, PREFILL), np.int32)
    toks[0, :20] = _prompts(1, lo=20, hi=21, seed=6)[0]
    lens = np.asarray([20], np.int32)
    jc, jl = jtx.prefill_into_slot_paged(pj, jp, _jcache(k, v, bt), 1,
                                         jnp.asarray(toks),
                                         jnp.asarray(lens))
    tc, tl = ttx.prefill_into_slot_paged(pt, tp, _tcache(k, v, bt), 1,
                                         torch.from_numpy(toks),
                                         torch.from_numpy(lens))
    _close(tl, jl)
    rows = ttx.paged_row_index(torch.from_numpy(bt[1:2]),
                               torch.arange(20)[None], BS)[0]
    for name, base in (("k", k), ("v", v)):
        flat = tc[name].reshape(2, -1, 2, 16)
        _close(flat[:, rows], np.asarray(jc[name]).reshape(
            2, -1, 2, 16)[:, rows.numpy()])
        untouched = np.setdiff1d(np.arange(1, 16), bt[1, :3])
        assert torch.equal(tc[name][:, untouched],
                           torch.from_numpy(base[:, untouched]))


@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_tree_step_paged_matches_jax(backend):
    """Logits and the pool after the draft-slot scatter (the NULL block,
    where idle rows collide, excepted)."""
    jcfg, jp, tcfg, tp = _model()
    pj = _paged(jcfg)
    pt = _paged(tcfg, decode_backend=backend)
    bt = _tables()
    k, v = _pools(16, 2, 16, seed=3)
    lens = np.asarray([37, 29, 5], np.int32)
    tok, pos, tm = _tree(3, 7, lens, seed=9)
    jc, jl = jtx.tree_step_paged(pj, jp, _jcache(k, v, bt),
                                 jnp.asarray(lens), jnp.asarray(tok),
                                 jnp.asarray(pos), jnp.asarray(tm))
    tc, tl = ttx.tree_step_paged(pt, tp, _tcache(k, v, bt),
                                 torch.from_numpy(lens),
                                 torch.from_numpy(tok),
                                 torch.from_numpy(pos), torch.from_numpy(tm))
    _close(tl, jl)
    for name in ("k", "v"):
        _close(tc[name][:, 1:], np.asarray(jc[name])[:, 1:])


@pytest.mark.parametrize("aliased", [False, True])
def test_commit_paged_cache_matches_jax(aliased):
    """Row m+j takes row m+gather[j] through the tables, every source read
    before any write.  ``aliased``: gather[j'] = j for j' < j (slot 1 reads
    the row slot 2 overwrites); lens straddle block boundaries."""
    jcfg, _, tcfg, _ = _model()
    pj, pt = _paged(jcfg), _paged(tcfg)
    bt = _tables()
    k, v = _pools(16, 2, 16, seed=4)
    lens = np.asarray([14, 44, 3], np.int32)
    if aliased:
        gather = np.asarray([[0, 2, 3, 5, 0, 0], [0, 1, 2, 3, 4, 5],
                             [0, 0, 0, 0, 0, 0]], np.int32)
        n_acc = np.asarray([4, 6, 0], np.int32)
    else:
        gather = np.asarray([[0, 1, 4, 0, 0, 0], [0, 3, 0, 0, 0, 0],
                             [0, 0, 0, 0, 0, 0]], np.int32)
        n_acc = np.asarray([3, 2, 1], np.int32)
    jc, jl = jtx.commit_paged_cache(pj, _jcache(k, v, bt), jnp.asarray(lens),
                                    jnp.asarray(gather), jnp.asarray(n_acc))
    tc, tl = ttx.commit_paged_cache(pt, _tcache(k, v, bt),
                                    torch.from_numpy(lens),
                                    torch.from_numpy(gather),
                                    torch.from_numpy(n_acc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


def test_reset_blocks_scrubs_only_freed_and_copy_block():
    """reset_blocks zeroes exactly the named physical blocks (NULL-padded
    ids are harmless); copy_paged_block copies one block, all layers."""
    k, v = _pools(6, 2, 16, seed=5)
    bt = np.zeros((2, 10), np.int32)
    out = ttx.reset_blocks(_tcache(k, v, bt),
                           torch.tensor([2, 4, 0, 0], dtype=torch.int32))
    for name, base in (("k", k), ("v", v)):
        assert not out[name][:, [0, 2, 4]].any()
        assert torch.equal(out[name][:, [1, 3, 5]],
                           torch.from_numpy(base[:, [1, 3, 5]]))
    jc = jtx.copy_paged_block(_jcache(k, v, bt), jnp.int32(3), jnp.int32(1))
    tc = ttx.copy_paged_block(_tcache(k, v, bt), 3, 1)
    for name in ("k", "v"):
        np.testing.assert_array_equal(tc[name].numpy(), np.asarray(jc[name]))


# ------------------------------------------------------------- serving
@pytest.mark.parametrize("backend", ["cuda", "dense"])
def test_paged_serving_lossless_and_matches_jax(backend):
    """Paged serving equals the port's reference_decode through the same
    backend, the dense layout's output, and the JAX paged engine's."""
    jcfg, jp, tcfg, tp = _model(seed=3)
    prompts = _prompts(4, seed=21)
    la = LookaheadConfig(decoding_length=8, branch_length=4)
    outs = {}
    for layout in ("dense", "paged"):
        fns = make_session_fns(tcfg, tp, slots=9, prefill_len=PREFILL,
                               backend=backend, kv_layout=layout,
                               block_size=BS, device="cpu")
        sched = ContinuousScheduler(fns, la, lanes=2, prefill_len=PREFILL)
        for p in prompts:
            sched.submit(p, 12)
        res = [r.tokens for r in sched.run()]
        for p, r in zip(prompts, res):
            assert r == reference_decode(fns, p, 12), (layout, backend)
        outs[layout] = res
    assert outs["paged"] == outs["dense"]
    jfns = j_make_session_fns(jcfg, jp, slots=9, prefill_len=PREFILL,
                              kv_layout="paged", block_size=BS)
    jsched = JScheduler(jfns, JLookaheadConfig(decoding_length=8,
                                               branch_length=4),
                        lanes=2, prefill_len=PREFILL)
    for p in prompts:
        jsched.submit(p, 12)
    assert [[int(t) for t in r.tokens] for r in jsched.run()] \
        == outs["paged"]
    assert j_reference_decode(jfns, prompts[0], 12) == outs["paged"][0]


@pytest.mark.parametrize("overlap", [False, True])
def test_paged_finish_admit_interleave_with_scrub(overlap):
    """With scrub-on-free and a pool so small that a finishing request's
    blocks go straight to the next admission, the scrub (by physical id, at
    free time) must not destroy the new request's KV; serial and with the
    draft/device overlap."""
    _, _, tcfg, tp = _model(seed=4)
    prompts = _prompts(6, lo=4, hi=20, seed=33)
    budgets = [2, 10, 1, 8, 3, 6]      # instant finishes interleave admits
    la = LookaheadConfig(decoding_length=8, branch_length=4)
    fns = make_session_fns(tcfg, tp, slots=9, prefill_len=PREFILL,
                           kv_layout="paged", block_size=BS, n_blocks=7,
                           device="cpu")
    refs = [reference_decode(fns, p, m) for p, m in zip(prompts, budgets)]
    sched = ContinuousScheduler(fns, la, lanes=2, prefill_len=PREFILL,
                                scrub_freed=True, overlap_drafts=overlap)
    for p, m in zip(prompts, budgets):
        sched.submit(p, m)
    res = sched.run()
    assert [r.tokens for r in res] == refs
    assert sched.stats.admitted == len(prompts)
    assert sched.stats.peak_blocks <= 6       # blocks really were recycled
    assert fns.reset_slot is None and fns.reset_blocks is not None
    assert fns.reset_blocks._cache_size() == 1


def test_paged_near_max_prompt_raises_clearly():
    """The paged layout has no lock-step fallback: a prompt that leaves no
    room for a tree step is refused with an actionable error."""
    _, _, tcfg, tp = _model(max_seq_len=64)
    la = LookaheadConfig(decoding_length=14, branch_length=4)
    fns = make_session_fns(tcfg, tp, slots=la.slots, kv_layout="paged",
                           block_size=BS, device="cpu")
    with pytest.raises(ValueError, match="paged layout has no lock-step"):
        LookaheadEngine(fns, la).generate(list(range(1, 51)), 8)


def test_paged_step_fns_fixed_shapes():
    """Block-table edits change values, never shapes: one input signature
    per step function across varied workloads."""
    _, _, tcfg, tp = _model(seed=5)
    fns = make_session_fns(tcfg, tp, slots=9, prefill_len=PREFILL,
                           kv_layout="paged", block_size=BS, device="cpu")
    la = LookaheadConfig(decoding_length=8, branch_length=4)
    for seed, n, budget in [(40, 5, 12), (41, 3, 7)]:
        sched = ContinuousScheduler(fns, la, lanes=2, prefill_len=PREFILL)
        for p in _prompts(n, lo=4, hi=30, seed=seed):
            sched.submit(p, budget)
        sched.run()
        assert sched.stats.decode_syncs == sched.stats.decode_steps
    assert fns.prefill._cache_size() == 1
    assert fns.prefill_into_slot._cache_size() == 1
    assert fns.fused_step._cache_size() == 1
    assert fns.tree_step._cache_size() == 0   # unfused parity oracle only
    assert fns.commit._cache_size() == 0


def test_device_tables_follow_host_tables():
    """``_sync_tables``: before every device step the cache's table equals
    the scheduler's host table after each admission and each extension,
    and it is a copy — a later host edit does not reach it."""
    _, _, tcfg, tp = _model(seed=6)
    fns = make_session_fns(tcfg, tp, slots=9, prefill_len=PREFILL,
                           kv_layout="paged", block_size=BS, device="cpu")
    seen = []

    def checked(member):
        def call(cache, *args, **kw):
            host = sched.tables.copy()
            assert np.array_equal(cache["block_tables"].numpy(), host)
            seen.append(host)
            return member(cache, *args, **kw)
        return call

    fns = dataclasses.replace(
        fns, fused_step=checked(fns.fused_step),
        prefill_into_slot=checked(fns.prefill_into_slot))
    sched = ContinuousScheduler(fns, LookaheadConfig(decoding_length=8,
                                                     branch_length=4),
                                lanes=2, prefill_len=PREFILL)
    for p, m in zip(_prompts(4, lo=10, hi=30, seed=7), [40, 6, 30, 9]):
        sched.submit(p, m)
    sched.step()
    sched._tables_dirty = True
    sched._sync_tables()
    table = sched.cache["block_tables"]
    before = table.clone()
    sched.tables[:] = 99                      # a host edit after the upload
    assert torch.equal(table, before)
    sched.tables[:] = before.numpy()
    sched.run()
    # admissions and extensions both changed the table along the way
    distinct = {t.tobytes() for t in seen}
    assert len(distinct) >= 4
    grew = [int((t != 0).sum()) for t in seen]
    assert max(grew) > grew[0]
