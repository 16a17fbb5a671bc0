"""The port's cost tooling (repro_torch.launch.{dryrun,roofline,report,
fixup_rooflines}, repro_torch.configs' ``build_cell``) on the CPU: every
cell's meta against the reference's, the roofline's terms against the
reference's roofline scaled by the peak ratios, the meta trace's product
counts against counts written out here and against the same trace on CPU
tensors, the live-memory tracker on a hand-made sequence, abstract
parameters, the kernel wrappers on meta, full-width cells and the CLIs.
Nothing here runs on a device: the traces run on PyTorch's meta device.
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import repro.configs as ref_configs
from repro.launch import roofline as ref_roofline
from repro_torch import configs, kernels
from repro_torch.configs import lm_common, qwen2_1_5b
from repro_torch.configs.common import Cell, abstract, tensor_leaves
from repro_torch.launch import dryrun, fixup_rooflines, report
from repro_torch.launch.dryrun import CostMode, LiveTracker, _trace_cell
from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
from repro_torch.launch.roofline import roofline
from repro_torch.models import transformer as tx
from repro_torch.models.params import init_params

pytestmark = [pytest.mark.torch_port]

ALL_CELLS = configs.assigned_cells() + [
    ("antglm_10b", s) for s in configs.get_arch("antglm_10b").SHAPES]


@pytest.fixture(scope="module")
def metas():
    """(port meta, reference meta) of all 44 cells."""
    return {(a, s): (configs.get_arch(a).build_cell(s).meta,
                     ref_configs.get_arch(a).build_cell(s).meta)
            for a, s in ALL_CELLS}


# ----------------------------------------------------------- cells, metas
def test_assigned_cells_match_the_reference():
    assert configs.assigned_cells() == ref_configs.assigned_cells()
    assert len(ALL_CELLS) == 44


def test_cell_meta_equals_the_reference_on_all_44_cells(metas):
    for cell, (port, ref) in metas.items():
        assert set(port) == set(ref), cell
        for k, v in ref.items():
            if isinstance(v, int):
                assert port[k] == v, (cell, k)
            else:
                assert port[k] == pytest.approx(v, rel=1e-12), (cell, k)


def test_roofline_is_the_references_scaled_by_the_peaks(metas):
    """The same count (bf16) and meta, n_chips 1: compute_s · 989e12 is the
    reference's compute_s · 197e12 (less the reference's scan correction,
    which the port's trace needs none of) and memory_s · 3.35e12 the
    reference's · 819e9."""
    F, B = 3.7e15, 2.9e12
    for cell, (meta, _) in metas.items():
        mine = roofline({"flops_by_dtype": {"bfloat16": F},
                         "bytes accessed": B}, 1, meta=meta)
        ref = ref_roofline.roofline({"flops": F, "bytes accessed": B}, "",
                                    1, meta=meta)
        corr = meta.get("flops_correction", 0.0)
        assert mine["compute_s"] * PEAK_FLOPS_BF16 == pytest.approx(
            ref["compute_s"] * ref_roofline.PEAK_FLOPS_BF16 - corr,
            rel=1e-12), cell
        bcorr = meta.get("bytes_correction", 0.0)
        assert mine["memory_s"] * HBM_BW == pytest.approx(
            ref["memory_s"] * ref_roofline.HBM_BW
            - (0.0 if meta.get("bytes_floor") else bcorr), rel=1e-12), cell
        assert mine["memory_raw_s"] * HBM_BW == pytest.approx(
            ref["memory_raw_s"] * ref_roofline.HBM_BW - bcorr, rel=1e-12)
        assert mine["collective_s"] == ref["collective_s"] == 0.0
        assert mine.get("step_output_bytes") == ref.get("step_output_bytes")
        if not corr:
            assert mine["useful_flops_ratio"] == ref["useful_flops_ratio"]
        assert set(ref) <= set(mine)


def test_roofline_prices_each_dtype_at_its_peak():
    rf = roofline({"flops_by_dtype": {"bfloat16": 989e12, "float32": 67e12},
                   "bytes accessed": 0.0}, 1, meta={"bytes_floor": 3.35e12})
    assert rf["compute_s"] == pytest.approx(2.0, rel=1e-12)
    assert rf["memory_s"] == pytest.approx(1.0, rel=1e-12)
    assert rf["bottleneck"] == "compute"


# ------------------------------------------------------------ the counts
def _smoke():
    return lm_common.smoke_config(qwen2_1_5b.full_config())


def _layer_products(cfg, N, attn):
    d, H, K, dh, F = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                      cfg.d_ff)
    return cfg.n_layers * (2 * N * d * (H * dh + 2 * K * dh)   # q, k, v
                           + 2 * N * H * dh * d                 # wo
                           + 3 * 2 * N * d * F                  # swiglu
                           + attn)


def _count(fn, *args):
    mode = CostMode()
    with mode:
        fn(*args)
    return dict(mode.flops)


def test_counted_products_of_prefill_step_and_train_at_smoke_size():
    """Qwen2-1.5B's smoke config (2 layers, d 64, 4 heads of 16, 1 KV
    head, d_ff 128, vocab 512, f32): the products written out, on meta and
    on CPU tensors alike."""
    cfg = _smoke()
    d, H, dh, V, S_max = (cfg.d_model, cfg.n_heads, cfg.dh, cfg.vocab_size,
                          cfg.max_seq_len)
    B, S, T = 2, 16, 5
    dense = dataclasses.replace(cfg, prefill_backend="dense",
                                decode_backend="dense")
    prefill = (_layer_products(cfg, B * S, 4 * B * H * S * S * dh)
               + 2 * B * d * V)                    # last token's logits
    step = (_layer_products(cfg, B * T, 4 * B * H * T * S_max * dh)
            + 2 * B * T * d * V)
    train = 3 * (_layer_products(cfg, B * S, 4 * B * H * S * S * dh)
                 + 2 * B * S * d * V)              # forward, 2x backward
    train_step = lm_common.train_4k_step(dense)
    for dev in ("meta", "cpu"):
        params = init_params(dense, seed=0, device=dev)
        g = torch.Generator().manual_seed(0)
        toks = torch.randint(0, V, (B, S), generator=g).to(dev)
        lens = torch.full((B,), S, dtype=torch.int32, device=dev)
        cache = tx.init_cache(dense, B, device=torch.device(dev))
        assert _count(lm_common._prefill_fn(dense), params, toks, lens,
                      cache) == {"float32": prefill}
        args = list(lm_common.decode_args(dense, B, T, device=dev))
        args[2] = toks[:, :T].int()
        args[6].fill_(T)
        assert _count(lm_common._serve_fn(dense), params, *args) == \
            {"float32": step}
        from repro_torch.training.optimizer import adamw_init
        assert _count(train_step, params, adamw_init(params),
                      {"tokens": toks, "labels": toks}) == {"float32": train}


def test_train_4k_cell_counts_the_whole_batch_and_holds_the_microbatches():
    """train_4k's cell (at the smoke config's widths, the cell's batch 256
    x 4,096): its cost program takes the batch at once, its memory program
    (``memory_fn``, the reference's ``fast`` build) in 4 microbatches: the
    same products in less live memory.  The other cells have one program."""
    cell = lm_common.build_cell("qwen2-1.5b", _smoke(), "train_4k")
    assert cell.memory_fn is not None
    cost, mem = _trace_cell(cell), _trace_cell(cell, cell.memory_fn)
    assert cost["flops_by_dtype"] == mem["flops_by_dtype"]
    assert mem["peak_memory_in_bytes"] < cost["peak_memory_in_bytes"]
    assert lm_common.build_cell("qwen2-1.5b", _smoke(),
                                "prefill_32k").memory_fn is None


def test_bf16_upcasts_count_as_bf16_products():
    """``x.float() @ w.float()`` of bf16 values runs on bf16 tensor cores
    with f32 sums; a product with a genuine f32 operand does not."""
    a = torch.empty(8, 16, dtype=torch.bfloat16, device="meta")
    b = torch.empty(16, 4, dtype=torch.bfloat16, device="meta")
    c = torch.empty(16, 4, dtype=torch.float32, device="meta")
    assert _count(lambda: a.float() @ b.float()) == {"bfloat16": 2 * 8 * 16 * 4}
    assert _count(lambda: torch.einsum("ik,kj->ij", a.float(), b.float())
                  ) == {"bfloat16": 2 * 8 * 16 * 4}
    assert _count(lambda: a.float() @ c) == {"float32": 2 * 8 * 16 * 4}
    assert _count(lambda: (a.float() * 2) @ b.float()) == \
        {"float32": 2 * 8 * 16 * 4}
    v = torch.empty(16, dtype=torch.float32, device="meta")
    assert _count(lambda: c.t() @ v) == {"float32": 2 * 16 * 4}


def _raw_bytes(fn):
    mode = CostMode()
    with mode:
        fn()
    return mode.raw_bytes


def test_raw_bytes_charge_no_allocation_and_write_an_out_tensor():
    """An allocation moves nothing; ``out=`` writes its tensor without
    reading it, so it moves what the functional form moves; an in-place
    op reads and writes its tensor.  AdamW's update into new tensors a
    chunk at a time moves what one chunk at once moves, and each further
    chunk reads the three 0-d tensors (the clip scale, the two bias
    corrections) again."""
    from repro_torch.training import optimizer as topt
    m = torch.empty(1000, device="meta")
    o = torch.empty(1000, device="meta")
    assert _raw_bytes(lambda: torch.empty_like(m)) == 0
    assert _raw_bytes(lambda: torch.mul(m, 2.0, out=o)) == \
        _raw_bytes(lambda: m * 2.0) == 8000
    assert _raw_bytes(lambda: o.add_(m)) == 12000
    params = {"t": torch.empty(7, 5, 3, device="meta")}
    grads = {"t": torch.empty(7, 5, 3, dtype=torch.bfloat16,
                              device="meta")}
    state = topt.adamw_init(params)
    one = _raw_bytes(lambda: topt.adamw_update(params, grads, state,
                                               lr=1e-3))
    old, topt.UPDATE_CHUNK = topt.UPDATE_CHUNK, 16
    try:
        chunked = _raw_bytes(lambda: topt.adamw_update(params, grads, state,
                                                       lr=1e-3))
    finally:
        topt.UPDATE_CHUNK = old
    n_chunks = -(-7 * 5 * 3 // 16)
    assert one > 0 and chunked == one + (n_chunks - 1) * 3 * 4


def test_live_tracker_peak_is_exact_on_a_hand_made_sequence():
    """Arguments live from the start; a view keeps its storage alive after
    the tensor it was taken from dies; a storage is freed once, when its
    last tensor goes."""
    a = torch.empty(1000, device="meta")             # 4,000 B argument
    live = LiveTracker()
    live.add(a)
    live.observe()
    mode = CostMode(live)
    with mode:
        b = a * 2                                    # + 4,000
        c = b.view(10, 100)                          # a view: + 0
        del b                                        # kept alive by c
        d = torch.cat([c, c, c]).flatten()           # + 12,000 -> 20,000
        del c                                        # b's storage dies
        e = d[:1000] * 1                             # + 4,000 -> 20,000
        f = torch.cat([e, e])                        # + 8,000 -> 28,000
        del d, e
        g = f * 3                                    # - 16,000 + 8,000
    assert live.peak == 28000
    assert live.sweep() == 4000 + 8000 + 8000        # a, f, g
    del f, g
    assert live.sweep() == 4000


def test_trace_cell_counts_arguments_outputs_and_the_peak():
    p = abstract((64, 32), "float32")
    x = abstract((8, 64), "float32")
    cell = Cell("toy", "mm", "score", lambda p, x: torch.relu(x @ p),
                (p, x))
    tr = _trace_cell(cell)
    assert tr["flops_by_dtype"] == {"float32": 2 * 8 * 64 * 32}
    assert tr["argument_size_in_bytes"] == cell.arg_bytes() == \
        (64 * 32 + 8 * 64) * 4
    assert tr["output_size_in_bytes"] == 8 * 32 * 4
    assert tr["peak_memory_in_bytes"] == (64 * 32 + 8 * 64 + 2 * 8 * 32) * 4
    # mm reads p and x and writes its output; relu reads that, writes one
    assert tr["bytes accessed"] == (64 * 32 + 8 * 64 + 3 * 8 * 32) * 4


# ---------------------------------------------------- abstract parameters
def _layout(tree):
    return [(tuple(t.shape), t.dtype) for t in tensor_leaves(tree)]


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "wide_deep", "sasrec",
                                  "equiformer_v2"])
def test_init_params_on_meta_has_the_cpu_layout(arch):
    mod = configs.get_arch(arch)
    cfg = mod.smoke_config()
    model = getattr(mod, "model", None)
    make = model.init_params if model else init_params
    meta = make(cfg, seed=0, device="meta")
    cpu = make(cfg, seed=0, device="cpu")
    assert _layout(meta) == _layout(cpu)
    assert all(t.device.type == "meta" for t in tensor_leaves(meta))


# --------------------------------------------------- the wrappers on meta
def _wrapper_cases():
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_fused
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.gumbel_argmax.ops import gumbel_argmax
    from repro_torch.kernels.tree_attention.ops import tree_attention
    from repro_torch.kernels.tree_attention.paged import paged_tree_attention
    g = torch.Generator().manual_seed(0)

    def rn(*s, dtype=torch.bfloat16):
        return torch.randn(s, generator=g).to(dtype)

    B, T, H, K, dh, S = 2, 5, 4, 2, 16, 32
    mask = torch.ones(B, T, S, dtype=torch.bool)
    tables = torch.tensor([[1, 2], [3, 0]], dtype=torch.int32)
    return [
        ("tree_attention", tree_attention,
         (rn(B, T, H, dh), rn(B, S, K, dh), rn(B, S, K, dh), mask), {}),
        ("paged_tree_attention", paged_tree_attention,
         (rn(B, T, H, dh), rn(4, 16, K, dh), rn(4, 16, K, dh), tables,
          mask), {}),
        ("flash_prefill", flash_prefill,
         (rn(B, S, H, dh), rn(B, S, K, dh), rn(B, S, K, dh)), {}),
        ("flash_prefill_tri", flash_prefill,
         (rn(B, S, H, dh), rn(B, S, K, dh), rn(B, S, K, dh)),
         {"triangular": True}),
        ("gumbel_argmax", gumbel_argmax,
         (rn(B, T, 50, dtype=torch.float32),
          torch.arange(B * T).reshape(B, T), torch.ones(B),
          torch.arange(B), torch.zeros(B, dtype=torch.bool)), {}),
        ("embedding_bag", embedding_bag_fused,
         (rn(3, 20, 8, dtype=torch.float32),
          torch.randint(0, 20, (B, 3, 4), generator=g),
          torch.ones(B, 3, 4, dtype=torch.bool)), {}),
    ]


@pytest.mark.parametrize("case", range(6))
def test_kernel_wrapper_on_meta_gives_the_plain_layout_and_no_launch(case):
    name, fn, args, kw = _wrapper_cases()[case]
    cpu = fn(*args, **kw)
    before = kernels.snapshot()
    out = fn(*(a.to("meta") for a in args), **kw)
    assert kernels.snapshot() == before, name
    assert out.device.type == "meta"
    assert (tuple(out.shape), out.dtype) == (tuple(cpu.shape), cpu.dtype)


# ---------------------------------------------------- full-width cells
def test_run_cell_at_full_width():
    """decode_32k's KV cache alone is 120 GB (28 layers, B 128, S 32,768, 2
    KV heads of 128, bf16): it does not fit one card; Wide & Deep's
    serve_p99 does; EquiformerV2's molecule step traces."""
    rec = dryrun.run_cell("qwen2_1_5b", "decode_32k")
    assert rec["ok"] and rec["mesh"] == "1xH100" and rec["n_chips"] == 1
    kv = 28 * 128 * 32768 * 2 * 128 * 2 * 2
    assert rec["memory"]["argument_size_in_bytes"] >= kv
    assert not rec["fits_80gb"]
    assert rec["meta"]["kv_bytes_per_step"] == kv
    assert set(rec["cost"]["flops_by_dtype"]) == {"bfloat16"}
    wd = dryrun.run_cell("wide_deep", "serve_p99")
    assert wd["fits_80gb"] and wd["roofline"]["bottleneck"] == "compute"
    assert set(wd["cost"]["flops_by_dtype"]) == {"float32"}
    mol = dryrun.run_cell("equiformer_v2", "molecule")
    assert mol["fits_80gb"] and mol["cost"]["flops"] > 0
    assert mol["roofline"]["memory_s"] == pytest.approx(
        mol["meta"]["bytes_floor"] / HBM_BW)


def test_dryrun_cli_writes_resumes_and_skips(tmp_path, capsys):
    out = tmp_path / "dry.json"
    argv = ["--arch", "wide-deep", "--shape", "serve_p99", "--out", str(out)]
    dryrun.main(argv)
    first = capsys.readouterr().out
    assert "[ ok ] wide-deep/serve_p99/1xH100" in first
    res = json.loads(out.read_text())
    assert res["wide-deep/serve_p99/1xH100"]["ok"]
    dryrun.main(argv)
    again = capsys.readouterr().out
    assert "[skip] wide-deep/serve_p99/1xH100" in again
    assert "1/1 cells OK" in again


def test_report_and_fixup_round_trip(tmp_path):
    rec = dryrun.run_cell("sasrec", "serve_p99")
    results = {"sasrec/serve_p99/1xH100": rec,
               "x/y/1xH100": {"arch": "x", "shape": "y", "ok": False,
                              "mesh": "1xH100", "error": "KeyError: y"}}
    text = report.render(results)
    assert "**1/2** cells traced OK, **1** fit" in text
    assert "| sasrec | serve_p99 |" in text and "`x/y/1xH100`" in text
    want = json.loads(json.dumps(rec["roofline"]))
    broken = json.loads(json.dumps(results))
    broken["sasrec/serve_p99/1xH100"]["roofline"]["compute_s"] = 1.0
    path = tmp_path / "r.json"
    path.write_text(json.dumps(broken))
    fixup_rooflines.main(str(path))
    fixed = json.loads(path.read_text())["sasrec/serve_p99/1xH100"]
    assert fixed["roofline"] == want
    assert np.isclose(fixed["roofline"]["compute_s"],
                      sum(fixed["cost"]["flops_by_dtype"].values()) / 67e12)


# ------------------------------------------------------- the mesh legs
HLO = """
  %ar = f32[8,128]{1,0} all-reduce(f32[8,128]{1,0} %x), replica_groups={{0,1,2,3}}, to_apply=%add
  %ag = bf16[16,64]{1,0} all-gather(bf16[4,64]{1,0} %y), replica_groups={{0,1,2,3}}, dimensions={0}
  %rs = f32[2,128]{1,0} reduce-scatter(f32[8,128]{1,0} %z), replica_groups={{0,1,2,3}}, dimensions={0}, to_apply=%add
  %aa = bf16[32,64]{1,0} all-to-all(bf16[32,64]{1,0} %w), replica_groups={{0,1,2,3,4,5,6,7}}, dimensions={0}
"""


def test_ring_formulas_equal_the_references_parse_collectives():
    """One op of each kind the port can count, written as the reference's
    HLO and as the records a ``Mesh`` keeps (the bytes handed over: the
    all-gather's result, else the operand): the same bytes by kind and in
    all."""
    from repro_torch.distributed.sharding import ring_bytes
    total, per_kind, _ = ref_roofline.parse_collectives(HLO, 8)
    records = [
        {"kind": "all-reduce", "group": 4, "bytes": 8 * 128 * 4},
        {"kind": "all-gather", "group": 4, "bytes": 16 * 64 * 2},
        {"kind": "reduce-scatter", "group": 4, "bytes": 8 * 128 * 4},
        {"kind": "all-to-all", "group": 8, "bytes": 32 * 64 * 2}]
    mine_total, mine = ring_bytes(records)
    assert all(per_kind[k] > 0 for k in per_kind
               if k != "collective-permute")
    for k, v in per_kind.items():
        assert mine[k] == pytest.approx(v, rel=1e-12), k
    assert mine_total == pytest.approx(total, rel=1e-12)


def test_roofline_prices_each_group_at_its_link():
    """A group inside one node of 8 ranks at NVLink's rate, any other at
    the network's; the collective term enters the bound."""
    from repro_torch.launch.mesh import NET_BW, NVLINK_BW, link_rate
    from repro_torch.launch.roofline import bound_seconds
    assert link_rate(range(8, 16)) == NVLINK_BW == 450e9
    assert link_rate(range(4, 12)) == link_rate(range(0, 256, 16)) == \
        NET_BW == 50e9
    rf = roofline({"flops_by_dtype": {"bfloat16": 989e9},
                   "bytes accessed": 0.0}, 2, collectives=[
        {"kind": "all-reduce", "group": 8, "ranks": list(range(8)),
         "calls": 1, "bytes": 450e9},
        {"kind": "all-gather", "group": 2, "ranks": [0, 8], "calls": 1,
         "bytes": 100e9}])
    assert rf["collective_s"] == pytest.approx(2 * 7 / 8 + 0.5 * 100 / 50)
    assert rf["bottleneck"] == "collective"
    assert bound_seconds(rf) == rf["collective_s"]
    assert rf["collective_bytes_per_chip"] == pytest.approx(
        2 * 7 / 8 * 450e9 + 0.5 * 100e9)


def _leaf_bytes(tree, shardings):
    leaves = list(tensor_leaves(tree))
    shs = [s for s in _sharding_leaves(shardings)]
    assert len(leaves) == len(shs)
    return sum(math.prod(sh.shard_shape(t.shape)) * t.element_size()
               for t, sh in zip(leaves, shs))


def _sharding_leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _sharding_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _sharding_leaves(v)
    else:
        yield tree


def test_mesh_leg_holds_the_ranks_blocks_at_full_width():
    """Qwen2-1.5B's decode_32k traced at rank 5 of (16, 16): its argument
    bytes are the blocks ``placement`` gives the parameters under the
    serve rules, the cache's flash-decode block (``Cell.shardings``) and
    the whole inputs;
    the rank calls collectives over ``model`` (a group across two nodes,
    priced at the network's rate) and the collective term is non-zero."""
    from repro_torch.distributed.sharding import placement
    from repro_torch.launch.mesh import NET_BW, make_production_mesh
    rec = dryrun.run_cell("qwen2_1_5b", "decode_32k", "16x16", rank=5)
    assert rec["ok"] and rec["placed"] and rec["n_chips"] == 256
    mesh = make_production_mesh(rank=5)
    cell = qwen2_1_5b.build_cell("decode_32k", mesh)
    rules = lm_common.cell_rules("decode_32k")
    cfg = lm_common.cell_config(qwen2_1_5b.full_config(), "decode_32k")
    axes, shapes = tx.param_logical_axes(cfg), tx.param_shapes(cfg)
    flat = [(axes[k], shapes[k]) for k in axes if k != "layers"] + [
        (axes["layers"][k], shapes["layers"][k]) for k in axes["layers"]]
    params = sum(math.prod(placement(mesh, a, s, rules).shard_shape(s)) * 2
                 for a, s in flat)
    want = _leaf_bytes(cell.global_args, cell.shardings(mesh))
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert cell.arg_bytes() == want
    B, T, L, S = 128, lm_common.LA_SLOTS, cfg.n_layers, cfg.max_seq_len
    # the serve rules keep the weights whole over data: a 16th of the
    # heads, FFN and vocab a rank (wk/wv whole: 2 KV heads on 16 ranks)
    assert params < cfg.n_params() * 2 / 8
    # lens and n_live, tokens, positions and parents, the bool tree mask
    inputs = B * 4 * 2 + B * T * 4 * 3 + B * T * T
    # the flash-decode block: lanes over data, the sequence over model
    assert cell.axes[1]["k"] == (None, "data", "model", None, None)
    cache = 2 * L * B * S * cfg.n_kv_heads * cfg.dh * 2 // 256
    assert want == params + cache + inputs
    rf = rec["roofline"]
    assert rf["collective_s"] > 0
    groups = {len(x["ranks"]) for x in rec["collectives"]}
    assert 16 in groups
    assert all(g["rate"] == NET_BW for g in rf["collective_groups"])


def test_recsys_cells_under_a_mesh_are_placed_and_count_collectives():
    """The recsys cells are placed (ROADMAP A16b 6.3): under a mesh a
    rank holds its blocks of the tables' rows (``Cell.shardings``) and the
    whole inputs, computes its rows of the batch, and counts the
    collectives a rank calls (the row-split lookups' sums over ``model``;
    Two-Tower's merged top-k gathers over ``data``); its peak is below
    the whole cell's on one card and its roofline has a collective
    term."""
    one = dryrun.run_cell("sasrec", "serve_p99")
    rec = dryrun.run_cell("sasrec", "serve_p99", "16x16")
    assert rec["ok"] and rec["placed"] is True and "whole_axes" not in rec
    assert rec["n_chips"] == 256
    kinds = {(c["kind"], c["group"]) for c in rec["collectives"]}
    assert ("all-reduce", 16) in kinds
    assert rec["roofline"]["collective_s"] > 0
    peak = rec["memory"]["peak_memory_in_bytes"]
    assert peak < one["memory"]["peak_memory_in_bytes"] / 8
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(rank=0)
    cell = configs.get_arch("sasrec").build_cell("serve_p99", mesh)
    want = _leaf_bytes(cell.global_args, cell.shardings(mesh))
    assert rec["memory"]["argument_size_in_bytes"] == want
    # item_emb: a 16th of its 10^6 rows a rank; the inputs whole
    assert cell.args[0]["item_emb"].shape == (62_500, 52)
    assert cell.args[1].shape == (512, 50)
    tt = dryrun.run_cell("two_tower_retrieval", "retrieval_cand", "16x16")
    assert tt["placed"] and ("all-gather", 16) in {
        (c["kind"], c["group"]) for c in tt["collectives"]}


def test_gnn_under_a_mesh_names_the_axes_left_whole():
    """The GNN's cells are placed (ROADMAP A16b 6.3b), so no record names
    axes left whole: under a mesh a rank of molecule at (16, 16) holds
    its "tensor" blocks of the SO(2) and FFN weights (``Cell.shardings``)
    and the whole inputs, runs its edges and node block, and counts the
    collectives a rank calls (the node features' all-gathers, the edge
    sums' all-reduces over every rank); its peak is below one card's
    record and its roofline has a collective term.  No cell and no record
    carries ``whole_axes`` any more."""
    mod = configs.get_arch("equiformer_v2")
    assert not hasattr(mod, "WHOLE_AXES")
    one = dryrun.run_cell("equiformer_v2", "molecule")
    rec = dryrun.run_cell("equiformer_v2", "molecule", "16x16")
    assert rec["ok"] and rec["placed"] is True and "whole_axes" not in rec
    assert rec["n_chips"] == 256
    kinds = {(c["kind"], c["group"]) for c in rec["collectives"]}
    assert {("all-gather", 16), ("all-reduce", 256)} <= kinds, kinds
    assert rec["roofline"]["collective_s"] > 0
    assert rec["memory"]["peak_memory_in_bytes"] \
        < one["memory"]["peak_memory_in_bytes"]
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(rank=0)
    cell = mod.build_cell("molecule", mesh)
    assert not hasattr(cell, "whole_axes")
    want = _leaf_bytes(cell.global_args, cell.shardings(mesh))
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert cell.arg_bytes() == want
    layers = cell.args[0]["layers"]
    # 12 layers; l_max 6, C 128: a 16th of the "tensor" dims a rank
    assert layers["w0"].shape == (12, 1792, 56)
    assert layers["wr2"].shape == (12, 1280, 40)
    assert layers["ffn_w1"].shape == (12, 7, 128, 16)
    assert layers["ffn_w2"].shape == (12, 7, 16, 128)
    assert layers["rad_w"].shape == (12, 32, 1792)
    assert cell.args[2]["edges"].shape == (8192, 2)


def test_dryrun_cli_runs_resumes_and_skips_the_mesh_legs(tmp_path, capsys):
    """``--both-meshes`` writes the 16x16 and 2x16x16 keys, a second run
    skips them, ``--single-pod`` alone finds its key done; the report
    renders both legs and ``fixup_rooflines`` recomputes the collective
    term from the stored records."""
    out = tmp_path / "dry.json"
    argv = ["--arch", "qwen2-1.5b", "--shape", "long_500k", "--out",
            str(out)]
    dryrun.main(argv + ["--both-meshes"])
    first = capsys.readouterr().out
    for leg in ("16x16", "2x16x16"):
        assert f"[ ok ] qwen2-1.5b/long_500k/{leg}" in first
    res = json.loads(out.read_text())
    assert sorted(res) == ["qwen2-1.5b/long_500k/16x16",
                           "qwen2-1.5b/long_500k/2x16x16"]
    assert res["qwen2-1.5b/long_500k/2x16x16"]["n_chips"] == 512
    dryrun.main(argv + ["--single-pod"])
    assert "[skip] qwen2-1.5b/long_500k/16x16" in capsys.readouterr().out
    dryrun.main(argv + ["--both-meshes"])
    again = capsys.readouterr().out
    assert again.count("[skip]") == 2 and "2/2 cells OK" in again
    text = report.render(res)
    assert "### Mesh 16x16 (256 ranks" in text
    assert "### Mesh 2x16x16 (512 ranks" in text
    want = res["qwen2-1.5b/long_500k/16x16"]["roofline"]["collective_s"]
    assert want > 0
    broken = json.loads(out.read_text())
    broken["qwen2-1.5b/long_500k/16x16"]["roofline"]["collective_s"] = 0.0
    out.write_text(json.dumps(broken))
    fixup_rooflines.main(str(out))
    fixed = json.loads(out.read_text())["qwen2-1.5b/long_500k/16x16"]
    assert fixed["roofline"]["collective_s"] == want
