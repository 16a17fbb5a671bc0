"""The port's recommender models (``repro_torch.models.recsys``), configs and
batch generators against the JAX package on the CPU.

Each arch runs at its ``smoke_config`` and at its full published widths with
the rows (tables) or items (catalog) cut to 1,000, on the reference's own
parameters (``init_params`` of the JAX package, carried over with
``recsys_params_from_jax``) and on inputs made with numpy from a seed:
Wide & Deep ``forward``, Two-Tower's paired score and ``score_candidates``
(indices equal, ties included), SASRec and BERT4Rec ``serve`` with and
without candidates (a left-padded and a fully padded row among them), and
every ``loss`` value.  Tolerance: scores and losses rtol=1e-4, atol=1e-5 —
f32 on both sides, sums in another order (MLP products of up to 1,293 terms,
attention, the 40-field concat); indices, generator arrays and lookups
exact.  The Wide & Deep bags take the fused EmbeddingBag kernel's plain
version here; the card runs the kernel (chip_smoke.py, recsys phase).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert4rec as j_bert_cfg
from repro.configs import sasrec as j_sas_cfg
from repro.configs import two_tower_retrieval as j_tt_cfg
from repro.configs import wide_deep as j_wd_cfg
from repro.models.recsys import bert4rec as j_bert
from repro.models.recsys import embedding as jE
from repro.models.recsys import sasrec as j_sas
from repro.models.recsys import two_tower as j_tt
from repro.models.recsys import wide_deep as j_wd
from repro.training import data as j_data
from repro_torch.configs import bert4rec as t_bert_cfg
from repro_torch.configs import get_arch
from repro_torch.configs import sasrec as t_sas_cfg
from repro_torch.configs import two_tower_retrieval as t_tt_cfg
from repro_torch.configs import wide_deep as t_wd_cfg
from repro_torch.kernels.embedding_bag.ops import embedding_bag_fused
from repro_torch.models.recsys import bert4rec as t_bert
from repro_torch.models.recsys import embedding as tE
from repro_torch.models.recsys import recsys_params_from_jax
from repro_torch.models.recsys import sasrec as t_sas
from repro_torch.models.recsys import two_tower as t_tt
from repro_torch.models.recsys import wide_deep as t_wd
from repro_torch.training import data as t_data

pytestmark = pytest.mark.torch_port

TOL = dict(rtol=1e-4, atol=1e-5)
CUT = 1_000          # rows per table / catalog items at full width
B = 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs several test processes side by side: one intra-op
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(j_cfg_mod, t_cfg_mod, size_field):
    """(JAX config, port config) at the smoke size and at full width with
    ``size_field`` cut to CUT."""
    smoke = j_cfg_mod.smoke_config()
    full = dataclasses.replace(j_cfg_mod.full_config(), **{size_field: CUT})
    port = {"smoke": t_cfg_mod.smoke_config(),
            "full": dataclasses.replace(t_cfg_mod.full_config(),
                                        **{size_field: CUT})}
    return {"smoke": (smoke, port["smoke"]), "full": (full, port["full"])}


def _params(j_model, jcfg, seed=0):
    jp = j_model.init_params(jcfg, jax.random.key(seed))
    return jp, recsys_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")


def _t(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


SIZES = ["smoke", "full"]


# ------------------------------------------------------------ Wide & Deep
@pytest.mark.parametrize("size", SIZES)
def test_wide_deep_forward_and_loss(size):
    jcfg, tcfg = _configs(j_wd_cfg, t_wd_cfg, "rows_per_table")[size]
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jp, tp = _params(j_wd, jcfg)
    batch = t_data.wide_deep_batch(np.random.RandomState(1), B,
                                   tcfg.n_sparse, tcfg.rows_per_table,
                                   tcfg.multi_hot, tcfg.n_dense)
    tb, jb = _t(batch), _j(batch)
    n0 = embedding_bag_fused.launches
    got = t_wd.forward(tcfg, tp, tb["sparse_ids"], tb["sparse_mask"],
                       tb["dense"])
    assert embedding_bag_fused.launches == n0       # CPU: plain version
    want = j_wd.forward(jcfg, jp, jb["sparse_ids"], jb["sparse_mask"],
                        jb["dense"])
    assert got.shape == (B,)
    _close(got, want)
    _close(t_wd.loss(tcfg, tp, tb), j_wd.loss(jcfg, jp, jb))


# -------------------------------------------------------------- Two-Tower
@pytest.mark.parametrize("size", SIZES)
def test_two_tower_paired_score_and_loss(size):
    jcfg, tcfg = _configs(j_tt_cfg, t_tt_cfg, "rows_per_table")[size]
    jp, tp = _params(j_tt, jcfg)
    batch = t_data.two_tower_batch(np.random.RandomState(2), B,
                                   tcfg.n_user_fields, tcfg.n_item_fields,
                                   tcfg.rows_per_table)
    tb, jb = _t(batch), _j(batch)
    got = t_tt_cfg.paired_score(tcfg, tp, tb["user_ids"], tb["item_ids"])
    q = j_tt.user_embed(jcfg, jp, jb["user_ids"])
    e = j_tt.item_embed(jcfg, jp, jb["item_ids"])
    _close(got, jnp.sum(q * e, axis=-1))
    _close(t_tt.loss(tcfg, tp, tb), j_tt.loss(jcfg, jp, jb))
    logq = np.random.RandomState(3).rand(B).astype(np.float32)
    _close(t_tt.loss(tcfg, tp, {**tb, "logq": torch.from_numpy(logq)}),
           j_tt.loss(jcfg, jp, {**jb, "logq": jnp.asarray(logq)}))


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("size", SIZES)
def test_two_tower_score_candidates_indices(size, ties):
    """Top-k indices equal the JAX ``lax.top_k``'s; with ties (candidate rows
    repeated) the lower index comes first in both."""
    jcfg, tcfg = _configs(j_tt_cfg, t_tt_cfg, "rows_per_table")[size]
    jp, tp = _params(j_tt, jcfg)
    rng = np.random.RandomState(4)
    user = rng.randint(0, tcfg.rows_per_table,
                       (1, tcfg.n_user_fields)).astype(np.int32)
    D = tcfg.tower_dims[-1]
    cand = rng.randn(400, D).astype(np.float32)
    if ties:
        q = t_tt.user_embed(tcfg, tp, torch.from_numpy(user))[0].numpy()
        for i in (7, 31, 200, 399):          # the best row, four times
            cand[i] = 3.0 * q
        cand[250] = cand[100] = cand[5]      # and a tie further down
    k = 24
    tv, ti = t_tt.score_candidates(tcfg, tp, torch.from_numpy(user),
                                   torch.from_numpy(cand), k=k)
    jv, ji = j_tt.score_candidates(jcfg, jp, jnp.asarray(user),
                                   jnp.asarray(cand), k=k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    _close(tv, jv)
    if ties:
        assert ti[:4].tolist() == [7, 31, 200, 399]
    # the config's retrieval cell: one user against the candidates, top 128
    fn = t_tt_cfg.serve_cell("retrieval_cand", tcfg).fn
    v128, i128 = fn(tcfg, tp, torch.from_numpy(user), torch.from_numpy(cand))
    assert i128.shape == (t_tt_cfg.TOP_K,)
    np.testing.assert_array_equal(i128[:k].numpy(), ti.numpy())


# ---------------------------------------------------- SASRec / BERT4Rec
SEQ = {"sasrec": (j_sas, t_sas, j_sas_cfg, t_sas_cfg, True),
       "bert4rec": (j_bert, t_bert, j_bert_cfg, t_bert_cfg, False)}


def _seq_inputs(cfg, causal, seed):
    batch = t_data.seq_rec_batch(np.random.RandomState(seed), B,
                                 cfg.seq_len, cfg.n_items, causal)
    pad = batch["pad_mask"].copy()
    pad[1, :3] = False                       # left-padded
    pad[2, :] = False                        # fully padded: index -1 wraps
    pad[3, cfg.seq_len // 2:] = False        # right-padded
    batch["pad_mask"] = pad
    return batch


@pytest.mark.parametrize("arch", list(SEQ))
@pytest.mark.parametrize("size", SIZES)
def test_seq_serve_with_and_without_candidates(arch, size):
    j_model, t_model, j_cfg_mod, t_cfg_mod, causal = SEQ[arch]
    jcfg, tcfg = _configs(j_cfg_mod, t_cfg_mod, "n_items")[size]
    jp, tp = _params(j_model, jcfg)
    batch = _seq_inputs(tcfg, causal, seed=5)
    cand = np.random.RandomState(6).randint(
        0, tcfg.n_items, (B, 17)).astype(np.int32)
    tb, jb = _t(batch), _j(batch)
    for c in (None, cand):
        got = t_model.serve(tcfg, tp, tb["ids"], tb["pad_mask"],
                            None if c is None else torch.from_numpy(c))
        want = j_model.serve(jcfg, jp, jb["ids"], jb["pad_mask"],
                             None if c is None else jnp.asarray(c))
        assert got.shape == ((B, tcfg.n_items) if c is None else (B, 17))
        _close(got, want)
    _close(t_model.hidden(tcfg, tp, tb["ids"], tb["pad_mask"]),
           j_model.hidden(jcfg, jp, jb["ids"], jb["pad_mask"]))


@pytest.mark.parametrize("arch", list(SEQ))
@pytest.mark.parametrize("size", SIZES)
def test_seq_loss(arch, size):
    j_model, t_model, j_cfg_mod, t_cfg_mod, causal = SEQ[arch]
    jcfg, tcfg = _configs(j_cfg_mod, t_cfg_mod, "n_items")[size]
    jp, tp = _params(j_model, jcfg)
    batch = t_data.seq_rec_batch(np.random.RandomState(7), B, tcfg.seq_len,
                                 tcfg.n_items, causal)
    _close(t_model.loss(tcfg, tp, _t(batch)),
           j_model.loss(jcfg, jp, _j(batch)))


# ----------------------------------------------------- configs, generators
ARCH_MODS = {"wide-deep": (j_wd_cfg, t_wd_cfg),
             "two-tower-retrieval": (j_tt_cfg, t_tt_cfg),
             "sasrec": (j_sas_cfg, t_sas_cfg),
             "bert4rec": (j_bert_cfg, t_bert_cfg)}


@pytest.mark.parametrize("arch", list(ARCH_MODS))
def test_configs_and_serve_cells_match_the_reference(arch):
    """The configs carry the reference's numbers, and each serve cell's
    inputs have the shapes and dtypes of the reference cell's arguments."""
    j_mod, t_mod = ARCH_MODS[arch]
    assert get_arch(arch) is t_mod and t_mod.ARCH == j_mod.ARCH
    assert t_mod.SHAPES == j_mod.SHAPES
    for name in ("full_config", "smoke_config"):
        assert dataclasses.asdict(getattr(t_mod, name)()) == \
            dataclasses.asdict(getattr(j_mod, name)())
    for shape in ("serve_p99", "serve_bulk", "retrieval_cand"):
        cell = j_mod.build_cell(shape)
        want = [(tuple(a.shape), str(a.dtype)) for a in cell.args[1:]]
        got = [(i.shape, i.dtype) for i in t_mod.serve_cell(shape).inputs]
        assert got == want, (arch, shape)
    with pytest.raises(ValueError, match="train_batch"):
        t_mod.serve_cell("train_batch")


def test_batch_generators_equal_the_reference_bit_for_bit():
    for seed in (0, 11):
        cases = [
            ("wide_deep_batch", (5, 7, 100, 3, 4)),
            ("two_tower_batch", (9, 4, 2, 1000)),
            ("seq_rec_batch", (4, 12, 300, True)),
            ("seq_rec_batch", (4, 24, 500, False)),
        ]
        for name, args in cases:
            a = getattr(t_data, name)(np.random.RandomState(seed), *args)
            b = getattr(j_data, name)(np.random.RandomState(seed), *args)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype, (name, k)
                np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch", list(ARCH_MODS))
def test_init_params_tree_matches_the_reference(arch):
    """The port's own init (a torch generator, on the CPU when asked) gives
    the reference tree's keys, shapes and dtypes; the default device is the
    card."""
    j_mod, t_mod = ARCH_MODS[arch]
    model = {"wide-deep": (j_wd, t_wd), "two-tower-retrieval": (j_tt, t_tt),
             "sasrec": (j_sas, t_sas), "bert4rec": (j_bert, t_bert)}[arch]
    jcfg, tcfg = j_mod.smoke_config(), t_mod.smoke_config()
    jp = jax.tree.map(np.asarray, model[0].init_params(jcfg,
                                                      jax.random.key(0)))
    tp = model[1].init_params(tcfg, seed=0, device="cpu")

    def walk(a, b):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k])
            else:
                assert tuple(a[k].shape) == b[k].shape, k
                assert str(b[k].dtype) == "torch." + str(a[k].dtype), k
    walk(jp, tp)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            model[1].init_params(tcfg)


# ------------------------------------------------------------- embeddings
@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_embedding_bag_combiners_match_jax(combiner):
    rng = np.random.RandomState(0)
    t = rng.randn(50, 8).astype(np.float32)
    ids = rng.randint(0, 50, (6, 4)).astype(np.int32)
    m = rng.rand(6, 4) > 0.3
    m[2] = False                              # an empty bag
    w = rng.rand(6, 4).astype(np.float32)
    got = tE.embedding_bag(torch.from_numpy(t), torch.from_numpy(ids),
                           weights=torch.from_numpy(w),
                           mask=torch.from_numpy(m), combiner=combiner)
    want = jE.embedding_bag(jnp.asarray(t), jnp.asarray(ids),
                            weights=jnp.asarray(w), mask=jnp.asarray(m),
                            combiner=combiner)
    _close(got, want, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("combiner", ["sum", "mean", "max"])
def test_embedding_bag_ragged_matches_jax(combiner):
    """tests/test_gnn_recsys.py's case (segments [1, 2], [3, 4, 5], empty),
    weighted, and a segment id out of range that both drop."""
    rng = np.random.RandomState(0)
    t = rng.randn(30, 4).astype(np.float32)
    flat = np.asarray([1, 2, 3, 4, 5, 6], np.int32)
    seg = np.asarray([0, 0, 1, 1, 1, 7], np.int32)
    w = rng.rand(6).astype(np.float32)
    for weights in (None, w):
        got = tE.embedding_bag_ragged(
            torch.from_numpy(t), torch.from_numpy(flat),
            torch.from_numpy(seg), 3,
            None if weights is None else torch.from_numpy(weights),
            combiner)
        want = jE.embedding_bag_ragged(
            jnp.asarray(t), jnp.asarray(flat), jnp.asarray(seg), 3,
            None if weights is None else jnp.asarray(weights), combiner)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if combiner == "sum":
        out = tE.embedding_bag_ragged(torch.from_numpy(t),
                                      torch.from_numpy(flat[:5]),
                                      torch.from_numpy(seg[:5]), 3)
        np.testing.assert_allclose(out[0].numpy(), t[1] + t[2], atol=1e-6)
        np.testing.assert_allclose(out[1].numpy(), t[3] + t[4] + t[5],
                                   atol=1e-6)
        np.testing.assert_allclose(out[2].numpy(), 0.0, atol=1e-6)


def test_hashed_lookup_matches_jax():
    rng = np.random.RandomState(0)
    q = rng.randn(16, 8).astype(np.float32)
    r = rng.randn(10, 8).astype(np.float32)
    ids = np.asarray([0, 9, 17, 159, -3], np.int32)
    got = tE.hashed_lookup(torch.from_numpy(q), torch.from_numpy(r),
                           torch.from_numpy(ids))
    want = jE.hashed_lookup(jnp.asarray(q), jnp.asarray(r), jnp.asarray(ids))
    assert got.shape == (5, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert torch.equal(got, tE.hashed_lookup(torch.from_numpy(q),
                                             torch.from_numpy(r),
                                             torch.from_numpy(ids)))


@pytest.mark.parametrize("arch", list(ARCH_MODS))
def test_serve_cli_rejects_recsys_archs(arch):
    """The LM serving CLI refuses a recommender arch, as the reference's
    does (recsys scoring runs through the configs' serve cells)."""
    from repro_torch.launch import serve
    with pytest.raises(SystemExit, match="not an LM arch"):
        serve.main(["--arch", arch, "--smoke", "--device", "cpu"])
