"""The port's GNN (``repro_torch.models.gnn``: EquiformerV2, its SO(3)
machinery and the fanout sampler), its config and graph generators against
the JAX package on the CPU, in f32.

* ``so3``: real SH and the Wigner-D blocks at l_max 6, ``apply_blocks``
  both ways and ``rotation_to_z`` (the poles and a zero vector included)
  against the reference's functions, atol 1e-5 (f32 products in another
  order); the reference's own properties on the port alone, in float64
  (orthogonality, composition, the action on the SH), atol 1e-8.
* The sampler and both graph generators: the reference's arrays bit for
  bit from the same ``RandomState``.
* ``forward`` (``node_out``, ``graph_out``, ``l1_feats``),
  ``node_class_loss`` and ``energy_loss`` and every gradient leaf against
  ``jax.value_and_grad``, on the reference's parameters
  (``equiformer_params_from_jax``), at ``smoke_config()`` and at l_max 6,
  m_max 2 with 8 channels, on the dense and the chunked path (edge_chunk
  20, three chunks), on a graph with masked edges and zero-length padding
  edges.  Tolerance rtol 1e-4 and atol 1e-5 of the largest |value| of each
  array: f32 sums in another order (segment sums, 2-layer products).  The
  JAX references are jitted once each in a module fixture: unjitted, the
  Wigner recursion at l_max 6 costs tens of seconds a call here.
* On the port alone: masked junk edges change nothing, the outputs are
  invariant to a rotation and a translation of the positions, and
  ``remat=True`` gives ``remat=False``'s gradients (atol 1e-6).
* ``full_config`` for every shape (fields, ``n_params``, ``CELLS``,
  ``model_flops``, ``bytes_floor``) equals the reference's; one
  ``train_cell`` step at smoke size against the reference's
  ``make_train_step`` (loss and grad_norm rtol 1e-5, parameters atol
  lr / 10, as in tests/test_torch_recsys_train.py), and the cells' inputs
  against ``build_cell``'s batch.
* Both of the port's CLIs reject the GNN up front; the reference's crash
  on the same arguments (ROADMAP §C).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import equiformer_v2 as j_cfg
from repro.models.gnn import equiformer as jeq
from repro.models.gnn import sampler as jsmp
from repro.models.gnn import so3 as jso3
from repro.training import data as j_data
from repro.training.optimizer import adamw_init as j_adamw_init
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.configs import equiformer_v2 as t_cfg
from repro_torch.configs import get_arch
from repro_torch.models.gnn import equiformer as teq
from repro_torch.models.gnn import sampler as tsmp
from repro_torch.models.gnn import so3 as tso3
from repro_torch.training import data as t_data
from repro_torch.training.optimizer import adamw_init, tree_leaves

pytestmark = pytest.mark.torch_port

RTOL, ATOL = 1e-4, 1e-5          # ATOL is relative to the array's max |value|
LR = 3e-4
N_NODES, N_EDGES, N_GRAPHS, CHUNK = 20, 60, 4, 20
FIELDS = ("node_feat", "positions", "edges", "edge_mask")
CONFIGS = {"smoke": t_cfg.smoke_config(),
           "l6": teq.EquiformerConfig(n_layers=2, channels=8, l_max=6,
                                      m_max=2, n_heads=2, d_feat_in=8,
                                      n_rbf=8, n_out=3)}
# (config, path) -> the losses whose value and gradient are held there;
# "forward_loss" is the node-class cross-entropy of the forward's outputs
# (``_forward_loss``), one trace of the model where the Wigner recursion at
# l_max 6 is costly to compile
CASES = {("smoke", "dense"): ("node_class_loss", "energy_loss"),
         ("smoke", "chunked"): ("node_class_loss",),
         ("l6", "dense"): ("forward_loss",),
         ("l6", "chunked"): ()}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The suite runs several test processes side by side: one intra-op
    thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=ATOL * max(np.abs(want).max(), 1e-30),
                               err_msg=what)


def _graph(seed=0):
    """N_NODES nodes in N_GRAPHS graphs, N_EDGES edges: random ones, some
    masked, and the last four (0, 0) padding edges (zero length)."""
    rng = np.random.RandomState(seed)
    edges = rng.randint(0, N_NODES, (N_EDGES, 2)).astype(np.int32)
    edges[-4:] = 0
    mask = rng.rand(N_EDGES) > 0.2
    mask[-4:] = False
    return {"node_feat": rng.randn(N_NODES, 8).astype(np.float32),
            "positions": rng.randn(N_NODES, 3).astype(np.float32),
            "edges": edges, "edge_mask": mask,
            "labels": rng.randint(-1, 3, (N_NODES,)).astype(np.int32),
            "graph_ids": np.repeat(np.arange(N_GRAPHS),
                                   N_NODES // N_GRAPHS).astype(np.int32),
            "energies": rng.randn(N_GRAPHS).astype(np.float32)}


def _cfg(name, path):
    return dataclasses.replace(CONFIGS[name],
                               edge_chunk=CHUNK if path == "chunked" else 0)


def _forward_args(batch, lib):
    return ([lib(batch[k]) for k in FIELDS]
            + [lib(batch["graph_ids"]), N_GRAPHS])


def _forward_loss(out, labels, xp):
    """``node_class_loss``'s cross-entropy, on ``forward``'s outputs (numpy
    namespace ``xp``: jax.numpy or torch) plus the graph outputs' and the
    l=1 features' sums, so that every output carries a gradient."""
    logits = out["node_out"]
    lm = labels >= 0
    if xp is torch:
        nll = -torch.log_softmax(logits, -1).gather(
            -1, labels.long().clamp_min(0)[:, None])[:, 0]
    else:
        nll = -jnp.take_along_axis(jax.nn.log_softmax(logits, -1),
                                   jnp.maximum(labels, 0)[:, None], -1)[:, 0]
    return ((nll * lm).sum() / lm.sum() + out["graph_out"].sum()
            + 1e-2 * out["l1_feats"].sum())


@pytest.fixture(scope="module")
def refs():
    """Per case: the reference's parameters (numpy) and, from one jitted
    program, its forward outputs and each held loss's value and
    gradient."""
    batch = _graph()
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {}
    for (name, path), losses in CASES.items():
        cfg = jeq.EquiformerConfig(**dataclasses.asdict(_cfg(name, path)))

        def run(key, cfg=cfg, losses=losses):
            p = jeq.init_params(cfg, key)

            def fwd(q):
                return jeq.forward(cfg, q, *_forward_args(jb, jnp.asarray))

            if "forward_loss" in losses:
                def loss_and_out(q):
                    o = fwd(q)
                    return _forward_loss(o, jb["labels"], jnp), o
                (v, o), g = jax.value_and_grad(loss_and_out, has_aux=True)(p)
                return p, {"forward": o, "forward_loss": (v, g)}
            res = {"forward": fwd(p)}
            for loss in losses:
                res[loss] = jax.value_and_grad(
                    lambda q, f=getattr(jeq, loss): f(cfg, q, jb))(p)
            return p, res

        out[(name, path)] = jax.tree.map(
            np.asarray, jax.jit(run)(jax.random.key(0)))
    return batch, out


def _port(refs, name, path):
    batch, out = refs
    jp, res = out[(name, path)]
    cfg = _cfg(name, path)
    return cfg, teq.equiformer_params_from_jax(cfg, jp, "cpu"), batch, res


# ------------------------------------------------------------------- so3
def _rand_rot(n, rng):
    A = rng.randn(n, 3, 3)
    Q = np.linalg.qr(A)[0]
    Q[:, :, 0] *= np.sign(np.linalg.det(Q))[:, None]
    return Q


def _unit(rng, n):
    v = rng.randn(n, 3)
    v[:4] = [[0, 0, 1], [0, 0, -1], [0, 0, 1 - 1e-12], [1e-7, 0, -1]]
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_so3_functions_match_reference():
    rng = np.random.RandomState(0)
    v = _unit(rng, 24).astype(np.float32)
    _close(tso3.real_sph_harm(torch.from_numpy(v), 6),
           jso3.real_sph_harm(jnp.asarray(v), 6), "real_sph_harm")
    vz = np.concatenate([v, np.zeros((1, 3), np.float32)])
    R = tso3.rotation_to_z(torch.from_numpy(vz))
    _close(R, jso3.rotation_to_z(jnp.asarray(vz)), "rotation_to_z")
    assert torch.equal(R[-1], torch.eye(3)), "a zero vector's frame"
    Rs = _rand_rot(16, rng).astype(np.float32)
    tb = tso3.wigner_blocks(torch.from_numpy(Rs), 6)
    jb = jso3.wigner_blocks(jnp.asarray(Rs), 6)
    for l, (a, b) in enumerate(zip(tb, jb)):
        _close(a, b, f"D^{l}")
    feats = rng.randn(16, 49, 5).astype(np.float32)
    for tr in (False, True):
        _close(tso3.apply_blocks(tb, torch.from_numpy(feats), transpose=tr),
               jso3.apply_blocks(jb, jnp.asarray(feats), transpose=tr),
               f"apply_blocks transpose={tr}")


def test_so3_properties_on_the_port():
    rng = np.random.RandomState(1)
    R1 = torch.from_numpy(_rand_rot(4, rng))
    R2 = torch.from_numpy(_rand_rot(4, rng))
    b1, b2 = tso3.wigner_blocks(R1, 6), tso3.wigner_blocks(R2, 6)
    b12 = tso3.wigner_blocks(R1 @ R2, 6)
    r = torch.from_numpy(_unit(rng, 5))
    Y = tso3.real_sph_harm(r, 6)
    YR = tso3.real_sph_harm(torch.einsum("eij,nj->eni", R1, r), 6)
    off = 0
    for l in range(7):
        n = 2 * l + 1
        eye = torch.eye(n, dtype=torch.float64).expand(4, n, n)
        torch.testing.assert_close(b1[l] @ b1[l].transpose(-1, -2), eye,
                                   rtol=0, atol=1e-8)
        torch.testing.assert_close(b1[l] @ b2[l], b12[l], rtol=0, atol=1e-8)
        torch.testing.assert_close(
            YR[..., off:off + n],
            torch.einsum("eij,nj->eni", b1[l], Y[:, off:off + n]),
            rtol=0, atol=1e-8)
        off += n
    v = torch.from_numpy(_unit(rng, 10))
    Rz = tso3.rotation_to_z(v)
    torch.testing.assert_close(torch.einsum("eij,ej->ei", Rz, v),
                               torch.tensor([0, 0, 1.0],
                                            dtype=torch.float64).expand(10, 3),
                               rtol=0, atol=1e-6)
    torch.testing.assert_close(torch.linalg.det(Rz),
                               torch.ones(10, dtype=torch.float64),
                               rtol=0, atol=1e-8)


# ------------------------------------------------- sampler and generators
def test_sampler_matches_reference_bit_for_bit():
    full = np.random.RandomState(1).randint(0, 300, (4000, 2))
    full[:40, 1] = 7                               # a high in-degree node
    jg = jsmp.CSRGraph.from_edges(full, 310)       # ten isolated nodes
    tg = tsmp.CSRGraph.from_edges(full, 310)
    np.testing.assert_array_equal(tg.indptr, jg.indptr)
    np.testing.assert_array_equal(tg.indices, jg.indices)
    seeds = np.array([7, 305, 3, 11, 300, 42, 0, 299])
    for fanouts in ([5, 3], [15, 10], [4]):
        want = jsmp.sample_subgraph(jg, seeds, fanouts,
                                    np.random.RandomState(2))
        got = tsmp.sample_subgraph(tg, seeds, fanouts,
                                   np.random.RandomState(2))
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert tsmp._cap_nodes(8, fanouts) == jsmp._cap_nodes(8, fanouts)
        assert tsmp._cap_edges(8, fanouts) == jsmp._cap_edges(8, fanouts)


@pytest.mark.parametrize("make", [
    lambda d: d.random_geometric_graph(np.random.RandomState(3), 60, 5,
                                       cutoff=0.6),
    lambda d: d.random_geometric_graph(np.random.RandomState(3), 60, 5,
                                       cutoff=0.6, max_edges=64),
    lambda d: d.random_geometric_graph(np.random.RandomState(3), 60, 5,
                                       cutoff=0.6, max_edges=4096),
    lambda d: d.batched_molecules(np.random.RandomState(4), 5, 30, 6, 64)],
    ids=["uncapped", "capped", "padded", "molecules"])
def test_graph_generators_match_reference_bit_for_bit(make):
    want, got = make(j_data), make(t_data)
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------- model vs the reference
@pytest.mark.parametrize("name,path", list(CASES))
def test_forward_matches_reference(refs, name, path):
    cfg, params, batch, res = _port(refs, name, path)
    out = teq.forward(cfg, params, *_forward_args(batch, torch.from_numpy))
    assert set(out) == set(res["forward"])
    for k, want in res["forward"].items():
        _close(out[k], want, k)


@pytest.mark.parametrize("name,path,loss", [
    (n, p, loss) for (n, p), losses in CASES.items() for loss in losses])
def test_loss_and_gradients_match_reference(refs, name, path, loss):
    cfg, params, batch, res = _port(refs, name, path)
    want_loss, want_grads = res[loss]
    leaves = [t.requires_grad_(True) for t in tree_leaves(params)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    if loss == "forward_loss":
        value = _forward_loss(teq.forward(cfg, params, *_forward_args(
            batch, torch.from_numpy)), tb["labels"], torch)
    else:
        value = getattr(teq, loss)(cfg, params, tb)
    grads = torch.autograd.grad(value, leaves)
    _close(value, want_loss, loss)
    want = jax.tree.leaves(want_grads)
    assert len(want) == len(grads)
    # atol from the largest entry of the whole gradient: attn_b's gradient
    # is zero but for rounding (the softmax ignores a per-head shift)
    scale = max(np.abs(w).max() for w in want)
    for i, (g, w) in enumerate(zip(grads, want)):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL,
                                   atol=ATOL * scale,
                                   err_msg=f"{loss} gradient leaf {i}")


@pytest.mark.parametrize("path", ["dense", "chunked"])
def test_masked_junk_edges_change_nothing(refs, path):
    """The port's twin of tests/test_gnn_recsys.py's padding test: junk
    edges (random ones and (0, 0) padding edges), all masked, change no
    output."""
    cfg, params, batch, _ = _port(refs, "smoke", path)
    rng = np.random.RandomState(5)
    junk = rng.randint(0, N_NODES, (CHUNK, 2)).astype(np.int32)
    junk[::2] = 0
    b2 = dict(batch, edges=np.concatenate([batch["edges"], junk]),
              edge_mask=np.concatenate([batch["edge_mask"],
                                        np.zeros(CHUNK, bool)]))
    o1 = teq.forward(cfg, params, *_forward_args(batch, torch.from_numpy))
    o2 = teq.forward(cfg, params, *_forward_args(b2, torch.from_numpy))
    for k in o1:
        assert torch.isfinite(o2[k]).all(), k
        torch.testing.assert_close(o2[k], o1[k], rtol=RTOL, atol=1e-6)


def test_outputs_invariant_to_rotation_and_translation(refs):
    cfg, params, batch, _ = _port(refs, "l6", "dense")
    args = _forward_args(batch, torch.from_numpy)
    out = teq.forward(cfg, params, *args)
    Q = torch.from_numpy(_rand_rot(1, np.random.RandomState(6))[0]
                         .astype(np.float32))
    shift = torch.tensor([3.0, -1.0, 2.0])
    for pos in (args[1] @ Q.T, args[1] + shift):
        moved = teq.forward(cfg, params, args[0], pos, *args[2:])
        for k in ("node_out", "graph_out"):
            torch.testing.assert_close(moved[k], out[k], rtol=0, atol=5e-4)


def test_remat_gives_the_same_gradients(refs):
    cfg, params, batch, _ = _port(refs, "smoke", "dense")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    grads = {}
    for remat in (False, True):
        leaves = [t.detach().requires_grad_(True)
                  for t in tree_leaves(params)]
        p = jax.tree.unflatten(jax.tree.structure(params), leaves)
        c = dataclasses.replace(cfg, remat=remat)
        grads[remat] = torch.autograd.grad(teq.node_class_loss(c, p, tb),
                                           leaves)
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


# ------------------------------------------------------------ configs, cells
@pytest.mark.parametrize("shape", t_cfg.SHAPES)
def test_full_config_matches_reference(shape):
    assert get_arch("equiformer-v2") is t_cfg
    assert t_cfg.SHAPES == j_cfg.SHAPES and t_cfg.CELLS == j_cfg.CELLS
    for fast in (False, True):
        jc, tc = j_cfg.full_config(shape, fast), t_cfg.full_config(shape, fast)
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.n_params() == jc.n_params()
    meta = j_cfg.build_cell(shape).meta
    c = t_cfg.CELLS[shape]
    tc = t_cfg.full_config(shape)
    assert t_cfg.model_flops(tc, c["n_edges"]) == meta["model_flops"]
    assert t_cfg.bytes_floor(tc, c["n_nodes"], c["n_edges"]) \
        == meta["bytes_floor"]
    assert dataclasses.asdict(t_cfg.smoke_config()) \
        == dataclasses.asdict(j_cfg.smoke_config())


@pytest.mark.parametrize("shape", t_cfg.SHAPES)
def test_train_cell_inputs_are_the_reference_batch(shape):
    want = j_cfg.build_cell(shape).args[2]
    got = t_cfg.train_cell(shape).inputs
    assert [i.name for i in got] == list(want)
    for i in got:
        assert i.shape == want[i.name].shape, i.name
        assert i.dtype == str(want[i.name].dtype), i.name


@pytest.mark.parametrize("shape", ["full_graph_sm"])
def test_train_cell_step_matches_reference(refs, shape):
    cfg, params, batch, _ = _port(refs, "smoke", "dense")
    jcfg = jeq.EquiformerConfig(**dataclasses.asdict(cfg))
    loss = jeq.energy_loss if shape == "molecule" else jeq.node_class_loss
    cell = t_cfg.train_cell(shape, cfg)
    names = [i.name for i in cell.inputs]
    b = {k: batch[k] for k in names}
    jp = jax.tree.map(jnp.asarray, refs[1][("smoke", "dense")][0])
    j_step = jax.jit(j_make_train_step(lambda p, x: loss(jcfg, p, x),
                                       lr=LR, grad_dtype="bfloat16"))
    jpp, _, jm = j_step(jp, j_adamw_init(jp),
                        {k: jnp.asarray(v) for k, v in b.items()})
    tpp, to, tm = cell.step(params, adamw_init(params),
                            {k: torch.from_numpy(v) for k, v in b.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    assert int(to.step) == 1
    for new, want in zip(tree_leaves(tpp), jax.tree.leaves(jpp)):
        np.testing.assert_allclose(new.numpy(), np.asarray(want), rtol=0,
                                   atol=LR / 10)


# ------------------------------------------------------------------- CLIs
@pytest.mark.parametrize("cli,msg", [
    ("serve", "serving loop is for autoregressive decoders"),
    ("train", "recsys and GNN archs train through their config's "
              "train_cell")])
def test_port_clis_reject_the_gnn_up_front(cli, msg):
    import importlib
    main = importlib.import_module(f"repro_torch.launch.{cli}").main
    with pytest.raises(SystemExit, match="equiformer-v2 is not an LM arch; "
                       + msg):
        main(["--arch", "equiformer-v2", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("cli,exc,msg", [
    ("serve", TypeError, "unexpected keyword argument 'max_seq_len'"),
    ("train", AttributeError, "no attribute 'd_model'")])
def test_reference_clis_crash_on_the_gnn(monkeypatch, tmp_path, cli, exc,
                                        msg):
    """ROADMAP §C: the reference's CLIs let the GNN through their
    ``hasattr(cfg, "n_layers")`` check and fail further on."""
    import importlib
    main = importlib.import_module(f"repro.launch.{cli}").main
    monkeypatch.setattr(sys, "argv", [cli, "--arch", "equiformer-v2",
                                      "--smoke", "--ckpt-dir",
                                      str(tmp_path)])
    with pytest.raises(exc, match=msg):
        main()
