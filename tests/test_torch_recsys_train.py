"""The port's recsys train cells and B5's gradient against the JAX package
on the CPU, in f32.

* ``embedding_bag_fused``'s ``autograd.Function`` (forward: B5's plain
  version here, the kernel on the card) against ``jax.vjp`` of the
  reference's ``embedding_bag`` (``jnp.take`` and a weighted sum), on one
  table and on stacked per-field tables (the reference's vmap over fields,
  as Wide & Deep runs it), with float weights, a bool mask, ids that wrap
  (negative) and ids out of range: their rows are NaN in the forward, their
  table gradient is dropped and their weight gradient NaN, in both.
  Tolerance: table gradient atol 1e-6, rtol 1e-5 (f32 sums of a few
  products in another order; on the card ``index_add_`` adds them with
  atomics); weight gradient the same, NaN in the same places.
* One step of each arch's ``train_cell`` at smoke size on the reference's
  parameters (``recsys_params_from_jax``) against the reference's
  ``train_cell`` step (lr 1e-3, bf16 gradients, AdamW with clipping) on the
  same batch from the same generators: loss and gradient norm rtol 1e-5,
  parameters atol lr / 10 (Adam's first update, lr * g / (|g| + eps), is
  continuous in g, so gradients that differ in their rounding move it far
  less than lr, under 1e-6 here; a wrong update moves entries by lr / 2 or
  more; the update alone is held tightly in tests/test_torch_training.py),
  and every parameter tree moves.
* The train cells' inputs: the names, shapes and dtypes of the reference's
  ``build_cell("train_batch")`` batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import bert4rec as j_bert_cfg
from repro.configs import recsys_common as j_rc
from repro.configs import sasrec as j_sas_cfg
from repro.configs import two_tower_retrieval as j_tt_cfg
from repro.configs import wide_deep as j_wd_cfg
from repro.models.recsys import bert4rec as j_bert
from repro.models.recsys import embedding as jE
from repro.models.recsys import sasrec as j_sas
from repro.models.recsys import two_tower as j_tt
from repro.models.recsys import wide_deep as j_wd
from repro.training.optimizer import adamw_init as j_adamw_init
from repro_torch.configs import bert4rec as t_bert_cfg
from repro_torch.configs import sasrec as t_sas_cfg
from repro_torch.configs import two_tower_retrieval as t_tt_cfg
from repro_torch.configs import wide_deep as t_wd_cfg
from repro_torch.kernels.embedding_bag.ops import embedding_bag_fused
from repro_torch.models.recsys import recsys_params_from_jax
from repro_torch.training import data as t_data
from repro_torch.training.optimizer import adamw_init, tree_leaves

pytestmark = pytest.mark.torch_port

GRAD_TOL = dict(atol=1e-6, rtol=1e-5)
LR = 1e-3
B = 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs several test processes side by side: one intra-op
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------ B5's gradient
def _bag_inputs(rng, lead, V, L):
    ids = rng.randint(0, V, lead + (L,)).astype(np.int32)
    ids.flat[::7] -= V                          # wrap: [-V, 0)
    ids.flat[3::11] = V + 2                     # out of range: dropped
    ids.flat[5::13] = -V - 1
    w = rng.randn(*lead, L).astype(np.float32)
    mask = rng.rand(*lead, L) > 0.25
    return ids, w, mask


@pytest.mark.parametrize("stacked", [False, True])
def test_embedding_bag_gradient_matches_jax_vjp(stacked):
    rng = np.random.RandomState(0)
    V, D, L, N, Fn = 40, 8, 5, 6, 3
    table = rng.randn(*((Fn,) if stacked else ()), V, D).astype(np.float32)
    ids, w, mask = _bag_inputs(rng, (N, Fn) if stacked else (N,), V, L)
    g = rng.randn(*ids.shape[:-1], D).astype(np.float32)

    def j_bag(t, ww):
        bag = lambda tt, i, m, x: jE.embedding_bag(tt, i, weights=x,  # noqa: E731
                                                   mask=m)
        if stacked:
            bag = jax.vmap(bag, in_axes=(0, 1, 1, 1), out_axes=1)
        return bag(t, jnp.asarray(ids), jnp.asarray(mask), ww)

    j_out, vjp = jax.vjp(j_bag, jnp.asarray(table), jnp.asarray(w))
    j_dt, j_dw = vjp(jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    n0 = embedding_bag_fused.launches
    out = embedding_bag_fused(tt, torch.from_numpy(ids),
                              torch.from_numpy(mask), tw)
    out.backward(torch.from_numpy(g))
    assert embedding_bag_fused.launches == n0        # CPU: plain version
    assert torch.isnan(out).any()                    # the rows out of range
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **GRAD_TOL)
    assert np.isfinite(np.asarray(j_dt)).all()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(j_dt), **GRAD_TOL)
    assert np.isnan(np.asarray(j_dw)).any()
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(j_dw), **GRAD_TOL)


def test_embedding_bag_gradient_with_mask_only_and_float_mask():
    """No weights: only the table gets a gradient; a float mask is folded
    into the weights, so its gradient flows like the weights'."""
    rng = np.random.RandomState(1)
    V, D, L = 30, 4, 3
    table = rng.randn(V, D).astype(np.float32)
    ids, _, mask = _bag_inputs(rng, (5,), V, L)
    ids = np.where((ids >= V) | (ids < -V), 0, ids).astype(np.int32)
    fmask = mask.astype(np.float32) * 0.5
    g = rng.randn(5, D).astype(np.float32)
    j_dt, j_dm = jax.vjp(
        lambda t, m: jE.embedding_bag(t, jnp.asarray(ids), mask=m),
        jnp.asarray(table), jnp.asarray(fmask))[1](jnp.asarray(g))
    tt = torch.from_numpy(table).requires_grad_(True)
    tm = torch.from_numpy(fmask).requires_grad_(True)
    embedding_bag_fused(tt, torch.from_numpy(ids), tm).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(j_dt), **GRAD_TOL)
    np.testing.assert_allclose(tm.grad.numpy(), np.asarray(j_dm), **GRAD_TOL)
    tt.grad = None
    embedding_bag_fused(tt, torch.from_numpy(ids),
                        torch.from_numpy(mask)).backward(torch.from_numpy(g))
    j_dt = jax.vjp(lambda t: jE.embedding_bag(t, jnp.asarray(ids),
                                              mask=jnp.asarray(mask)),
                   jnp.asarray(table))[1](jnp.asarray(g))[0]
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(j_dt), **GRAD_TOL)


# --------------------------------------------------------- train cells
def _wd_batch(rng, cfg):
    return t_data.wide_deep_batch(rng, B, cfg.n_sparse, cfg.rows_per_table,
                                  cfg.multi_hot, cfg.n_dense)


def _tt_batch(rng, cfg):
    return t_data.two_tower_batch(rng, B, cfg.n_user_fields,
                                  cfg.n_item_fields, cfg.rows_per_table)


def _seq_batch(causal):
    return lambda rng, cfg: t_data.seq_rec_batch(rng, B, cfg.seq_len,
                                                 cfg.n_items, causal=causal)


# arch -> (JAX config module, JAX model, port config module, batch maker)
CELLS = {"wide-deep": (j_wd_cfg, j_wd, t_wd_cfg, _wd_batch),
         "two-tower-retrieval": (j_tt_cfg, j_tt, t_tt_cfg, _tt_batch),
         "sasrec": (j_sas_cfg, j_sas, t_sas_cfg, _seq_batch(True)),
         "bert4rec": (j_bert_cfg, j_bert, t_bert_cfg, _seq_batch(False))}


@pytest.mark.parametrize("arch", list(CELLS))
def test_train_cell_step_matches_the_reference(arch):
    j_cfg_mod, j_model, t_cfg_mod, make_batch = CELLS[arch]
    jcfg, tcfg = j_cfg_mod.smoke_config(), t_cfg_mod.smoke_config()
    jp = j_model.init_params(jcfg, jax.random.key(0))
    tp = recsys_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    batch = make_batch(np.random.RandomState(5), tcfg)
    j_step = jax.jit(j_rc.train_cell(arch, jcfg, j_model.init_params,
                                     j_model.loss, None, None, None, {}).fn)
    jpp, _, jm = j_step(jp, j_adamw_init(jp),
                        {k: jnp.asarray(v) for k, v in batch.items()})
    cell = t_cfg_mod.train_cell(tcfg, batch=B)
    assert [i.name for i in cell.inputs] == list(batch)
    tpp, to, tm = cell.step(tp, adamw_init(tp),
                            {k: torch.from_numpy(v) for k, v in
                             batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert int(to.step) == 1
    for new, old, want in zip(tree_leaves(tpp), tree_leaves(tp),
                              jax.tree.leaves(jpp)):
        np.testing.assert_allclose(new.numpy(), np.asarray(want), rtol=0,
                                   atol=LR / 10)
    for name in tp:                      # every parameter tree moves
        assert any(not torch.equal(a, b) for a, b in
                   zip(tree_leaves(tpp[name]), tree_leaves(tp[name]))), name


@pytest.mark.parametrize("arch", list(CELLS))
def test_train_cell_inputs_are_the_reference_batch(arch):
    j_cfg_mod, _, t_cfg_mod, _ = CELLS[arch]
    want = j_cfg_mod.build_cell("train_batch").args[2]
    got = t_cfg_mod.train_cell().inputs
    assert [i.name for i in got] == list(want)
    for i in got:
        assert i.shape == want[i.name].shape, i.name
        assert i.dtype == str(want[i.name].dtype), i.name
