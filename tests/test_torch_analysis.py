"""The port's analysis layer (repro_torch.analysis) on the CPU: the torch
sync-discipline rule (R1), the recapture rule (R4) and the copied R3/R6
against known-bad and
known-good snippets, the linter's gate over the port, the sanitizer's
units (lifecycle, shadow ledger, the poison probe on torch tensors,
retrace manifest) as tests/test_analysis.py holds the reference's, and the
serving-level integration: a sanitized scheduler run on the port's session
equals an unsanitized one and passes its idle audit, and with sanitize off
the sanitizer module is not even imported.
"""
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.analysis.lint import (lint_file, lint_source,
                                       main as lint_main)
from repro_torch.analysis.sanitizer import (ADMITTED, DRAINED, PROBE_CHUNK,
                                            InvariantViolation,
                                            LifecycleMonitor,
                                            RetraceMonitor, ShadowLedger)
from repro_torch.serving.block_allocator import BlockAllocator

pytestmark = [pytest.mark.torch_port, pytest.mark.analysis]

REPO = Path(__file__).resolve().parents[1]
ENV = dict(os.environ, PYTHONPATH=str(REPO / "src"))


def _rules(source, rule_id):
    """Findings of one snippet, filtered to one rule."""
    return [f for f in lint_source(textwrap.dedent(source))
            if f.rule == rule_id]


# ------------------------------------------------------------ R1 on torch
R1_SCHED = """
    import numpy as np
    import torch

    class Sched:
        def _pull(self, x):
            return x.cpu().numpy()

        def step(self):
            cache, packed = self.fns.fused_step(self.cache, self.lens)
            return {form}
"""

PULL_FORMS = ["packed.item()", "packed.tolist()", "packed.cpu()",
              "packed[0].numpy()", "packed.to('cpu')",
              "packed.to(device='cpu')", "packed.to(torch.device('cpu'))",
              "np.asarray(packed)", "np.array(packed)", "int(packed[0])",
              "float(packed[0, 1])", "bool(packed[0])",
              "torch.cuda.synchronize()", "self.stream.synchronize()",
              "self.done.synchronize()"]


@pytest.mark.parametrize("form", PULL_FORMS)
def test_r1_flags_each_pull_form_on_step_results(form):
    found = _rules(R1_SCHED.format(form=form), "R1")
    assert len(found) == 1, (form, found)
    assert found[0].line == 11


def test_r1_accepts_pull_choke_point_and_host_values():
    # laundering through _pull() makes the name host data again; host
    # values (the prompt list, a device move of host data) are fine
    src = """
        import numpy as np

        class Sched:
            def _pull(self, x):
                return x.cpu().numpy()

            def step(self):
                cache, packed = self.fns.fused_step(self.cache, self.lens)
                packed = self._pull(packed)
                toks = np.asarray(self.prompt, dtype=np.int32)
                lens = self.lens.to("cuda")
                return int(packed[0]), packed.tolist(), toks, lens
    """
    assert _rules(src, "R1") == []


def test_r1_accepts_module_host_choke_point():
    """A module that defines ``_host`` (the lock-step loop's choke point)
    is scanned whole; results laundered through ``_host`` are host data."""
    src = """
        import numpy as np

        def _host(x):
            return x.cpu().numpy()

        class Loop:
            def go(self, fns, toks, lens):
                cache, chosen = fns.prefill(toks, lens)
                chosen = _host(chosen)
                cache, more = fns.tree_step(cache, lens, toks)
                return int(chosen[0]), more.cpu()
    """
    found = _rules(src, "R1")
    assert [f.line for f in found] == [12]      # more.cpu() only


def test_r1_engine_pulls_go_through_host():
    """The port's lock-step loop lints clean because its pulls go through
    ``_host``; the same loop with one raw pull in its place is flagged."""
    path = REPO / "src" / "repro_torch" / "core" / "engine.py"
    src = path.read_text()
    assert src.count("_host(") >= 4                  # def + three pulls
    assert _rules(src, "R1") == []
    bad = src.replace("chosen = _host(chosen)", "chosen = chosen.cpu()", 1)
    assert bad != src
    line = bad.splitlines().index("            chosen = chosen.cpu()") + 1
    found = _rules(bad, "R1")
    assert found and found[0].line == line
    assert ".cpu()" in found[0].message


def test_r1_ignores_code_without_pull_contract():
    src = """
        import torch

        class NotAScheduler:
            def step(self):
                out = self.fns.fused_step(self.cache)
                torch.cuda.synchronize()
                return int(out[0])
    """
    assert _rules(src, "R1") == []


def test_r1_suppression_comment():
    src = """
        class Sched:
            def _pull(self, x):
                return x.cpu().numpy()

            def warmup(self):
                c, chosen = self.fns.prefill(self.toks, self.lens)
                return chosen.item()  # repro-lint: disable=R1
    """
    assert _rules(src, "R1") == []


# ------------------------------------------------------- R3 / R6 (copies)
def test_r3_flags_dropped_free_result_and_unpaired_acquire():
    src = """
        class Sched:
            def cancel_pending(self, rid, lane):
                del self._pending[lane]
                self.alloc.free(rid)

        class PrefixAdopter:
            def adopt(self, rid, blocks):
                self.alloc.share(rid, blocks)
    """
    found = _rules(src, "R3")
    assert len(found) == 2
    assert "dropped on the floor" in found[0].message
    assert "share" in found[1].message


def test_r3_accepts_paired_and_consumed():
    src = """
        class Sched:
            def admit(self, rid, blocks):
                self.alloc.share(rid, blocks)

            def retire(self, rid):
                freed = self.alloc.free(rid)
                self.scrub(freed)

        class BlockAllocator:
            def free(self, rid):
                return []

            def share(self, rid, blocks):
                self.noop(blocks)
    """
    assert _rules(src, "R3") == []


def test_r6_flags_unpaired_and_accepts_suppressed():
    src = """
        class SaveOnly:
            def state_dict(self):
                return {}

        class LoadOnly:
            def load_state_dict(self, state):
                pass

        class Justified:
            def load_state_dict(self, state):  # repro-lint: disable=R6
                pass
    """
    found = _rules(src, "R6")
    assert len(found) == 2
    assert "never be restored" in found[0].message
    assert "never donates" in found[1].message


# ------------------------------------------------------------------- R4
def test_r4_flags_value_dependent_shapes_into_captured_members():
    """The torch twin of tests/test_analysis.py's R4 case: a name bound to
    a member (the session's ``member`` helper or ``_Member``) fed a
    Python-length array, numpy's or torch's."""
    src = """
        import numpy as np
        import torch

        step = member("fused_step", lambda t: t)
        other = _Member("prefill", lambda t: t)

        def go(toks, n):
            a = step(np.asarray(toks[:n]))
            b = other(torch.zeros((len(toks),)))
            return a, b
    """
    assert len(_rules(src, "R4")) == 2


def test_r4_accepts_fixed_buckets():
    src = """
        import torch

        step = member("fused_step", lambda t: t)

        def go(toks, n, buf):
            buf[0, :n] = torch.as_tensor(toks[:n])   # host staging: fine
            return step(buf)
    """
    assert _rules(src, "R4") == []


def test_r4_flags_step_fns_calls_and_honours_suppression():
    """The port reaches its members through ``StepFns`` fields, so those
    calls are checked; ``prefill_suffix`` (the padding layer) and a
    receiver that is not ``fns`` are not."""
    src = """
        import numpy as np

        class Sched:
            def admit(self, fns, toks, n):
                a = fns.prefill(np.asarray(toks[:n]), n)
                b = self.fns.prefill_into_slot(self.cache, 0, toks[:n])
                c = fns.prefill_suffix(self.cache, 0, toks[n:])
                d = self.engine.prefill(toks[:n])
                e = fns.fused_step(toks[:n])  # repro-lint: disable=R4
                return a, b, c, d, e
    """
    assert [f.line for f in _rules(src, "R4")] == [6, 7]


def test_r4_covers_the_step_fns_members_and_the_ports_call_sites():
    """R4's member fields are StepFns' callables but the padding
    ``prefill_suffix``, and over the port the rule sees the scheduler's and
    the engine's member calls (so its clean result checks them)."""
    import ast
    import dataclasses
    from repro_torch.analysis.rules.retrace import (STEP_MEMBERS,
                                                    _captured_callee,
                                                    _collect_member_names)
    from repro_torch.core.request import StepFns
    fields = {f.name for f in dataclasses.fields(StepFns)
              if "Callable" in str(f.type)}
    assert STEP_MEMBERS == fields - {"prefill_suffix"}
    seen = 0
    for rel in ("serving/scheduler.py", "core/engine.py",
                "serving/session.py"):
        tree = ast.parse((REPO / "src" / "repro_torch" / rel).read_text())
        members = _collect_member_names(tree)
        seen += sum(1 for n in ast.walk(tree) if isinstance(n, ast.Call)
                    and _captured_callee(n, members))
    assert seen >= 15
    assert [f for f in lint_main_findings() if f.rule == "R4"] == []


def lint_main_findings():
    from repro_torch.analysis.rules import all_rules
    out = []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        out += lint_file(path, all_rules())
    return out


# ------------------------------------------------------- runner / port gate
def test_port_lints_clean():
    """The gate: ``python -m repro_torch.analysis.lint src/repro_torch``
    exits 0 (and the runner imports no torch)."""
    assert lint_main([str(REPO / "src" / "repro_torch")]) == 0
    proc = subprocess.run(
        [sys.executable, "-c",
         "import sys; from repro_torch.analysis.lint import main; "
         "rc = main(['src/repro_torch']); "
         "assert 'torch' not in sys.modules; sys.exit(rc)"],
        capture_output=True, text=True, cwd=str(REPO), env=ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_lint_cli_exit_codes(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("class S:\n    def _pull(self, x):\n        return x\n\n"
                   "    def go(self):\n"
                   "        return self.fns.fused_step(self.c).item()\n")
    cmd = [sys.executable, "-m", "repro_torch.analysis.lint"]
    proc = subprocess.run(cmd + [str(bad)], capture_output=True, text=True,
                          cwd=str(REPO), env=ENV)
    assert proc.returncode == 1 and "R1" in proc.stdout
    proc = subprocess.run(cmd + ["src/repro_torch"], capture_output=True,
                          text=True, cwd=str(REPO), env=ENV)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    proc = subprocess.run(cmd + ["--list-rules"], capture_output=True,
                          text=True, cwd=str(REPO), env=ENV)
    assert proc.returncode == 0
    assert [line.split()[0] for line in proc.stdout.splitlines()] == \
        ["R1", "R3", "R4", "R6"]


def test_lint_file_select(tmp_path):
    from repro_torch.analysis.rules import all_rules
    bad = tmp_path / "bad.py"
    bad.write_text("class A:\n    def state_dict(self):\n        return {}\n")
    only_r1 = [r for r in all_rules() if r.rule_id == "R1"]
    assert lint_file(bad, only_r1) == []
    assert len(lint_file(bad)) == 1


# ----------------------------------------------------------- lifecycle unit
def test_lifecycle_legal_path():
    mon = LifecycleMonitor()
    for state in ("queued", "admitted", "active", "retiring", "drained"):
        mon.transition(7, state)
    assert mon.state(7) == DRAINED
    mon.assert_all_drained()


def test_lifecycle_out_of_order_raises_with_history():
    mon = LifecycleMonitor()
    mon.transition(3, "queued")
    mon.transition(3, "admitted")
    with pytest.raises(InvariantViolation) as exc:
        mon.transition(3, "drained")    # skipped retiring
    assert "queued -> admitted" in str(exc.value)
    assert mon.state(3) == ADMITTED     # rejected transition did not apply


def test_lifecycle_stuck_request_fails_idle_audit():
    mon = LifecycleMonitor()
    mon.transition(1, "queued")
    mon.transition(1, "admitted")
    with pytest.raises(InvariantViolation, match="not drained"):
        mon.assert_all_drained()


# -------------------------------------------------------------- ledger unit
def _allocated_pair():
    alloc = BlockAllocator(8, 4)
    ledger = ShadowLedger()
    alloc.observer = ledger
    return alloc, ledger


def test_ledger_mirrors_clean_lifecycle():
    alloc, ledger = _allocated_pair()
    alloc.alloc(0, 2, reserve=3)
    alloc.extend(0, 1)
    alloc.free(0)
    ledger.assert_idle(alloc)


def test_ledger_double_free():
    alloc, ledger = _allocated_pair()
    blocks = alloc.alloc(0, 2)
    alloc.free(0)
    with pytest.raises(InvariantViolation, match="double free"):
        ledger.on_event("free_enter", rid=0, table=blocks)


def test_ledger_leak_at_idle():
    alloc, ledger = _allocated_pair()
    alloc.alloc(0, 2)
    with pytest.raises(InvariantViolation, match="leak|allocations"):
        ledger.assert_idle(alloc)


def test_ledger_free_while_request_active():
    lifecycle = LifecycleMonitor()
    alloc = BlockAllocator(8, 4)
    ledger = ShadowLedger(lifecycle)
    alloc.observer = ledger
    lifecycle.transition(5, "queued")
    alloc.alloc(5, 2)
    lifecycle.transition(5, "admitted")
    with pytest.raises(InvariantViolation, match="use-after-free"):
        alloc.free(5)       # never transitioned to retiring


def test_ledger_cache_ref_pairing():
    alloc, ledger = _allocated_pair()
    blocks = alloc.alloc(0, 2)
    alloc.cache_ref(blocks)
    assert alloc.free(0) == []          # cache still holds both
    assert sorted(alloc.cache_unref(blocks)) == sorted(blocks)
    ledger.assert_idle(alloc)


@pytest.mark.parametrize("kind", ["torch", "numpy"])
def test_ledger_poison_probe(kind):
    ledger = ShadowLedger()
    make = (lambda: torch.zeros((2, 8, 4, 2, 4), dtype=torch.bfloat16)) \
        if kind == "torch" else (lambda: np.zeros((2, 8, 4, 2, 4)))
    cache = {"k": make(), "v": make()}
    ledger.on_scrubbed([3])
    ledger.check_poison(cache)          # all-zero: clean
    assert (ledger.probes, ledger.probed_blocks) == (1, 1)
    cache["k"][0, 3, 1] = 1.0           # stray write into freed block
    with pytest.raises(InvariantViolation, match="use-after-free write"):
        ledger.check_poison(cache)


def test_poison_probe_names_the_block_and_leaf_past_a_chunk():
    """The probe gathers the armed blocks in chunks of ``PROBE_CHUNK`` and
    reduces them to one flag a block and leaf: a write anywhere in a later
    chunk names that block and leaf; -0.0 counts as zero, as in the
    reference's ``np.any``."""
    nb = 2 * PROBE_CHUNK + 8
    cache = {n: torch.zeros((2, nb, 4, 2, 4)) for n in ("k", "v")}
    ledger = ShadowLedger()
    ledger.on_scrubbed(range(1, nb))
    cache["v"][1, 5, 0, 0, 0] = -0.0
    ledger.check_poison(cache)
    assert ledger.probed_blocks == nb - 1
    cache["v"][1, nb - 3, 3, 1, 2] = float("nan")
    with pytest.raises(InvariantViolation,
                       match=f"block {nb - 3} has nonzero 'v'"):
        ledger.check_poison(cache)


# ------------------------------------------------------------- retrace unit
def _fake_fns(counts):
    def member(name):
        fn = lambda *a, **k: None                      # noqa: E731
        fn._cache_size = lambda: counts[name]
        return fn
    return types.SimpleNamespace(
        prefill=member("prefill"), fused_step=member("fused_step"),
        suffix_buckets=())


def test_retrace_monitor_deltas():
    counts = {"prefill": 1, "fused_step": 1}
    mon = RetraceMonitor(_fake_fns(counts))
    mon.check()
    counts["fused_step"] += 1           # one new signature: within manifest
    mon.check()
    counts["fused_step"] += 1           # a second: retrace
    with pytest.raises(InvariantViolation, match="retrace"):
        mon.check()


def test_retrace_manifest_override():
    counts = {"prefill": 0, "fused_step": 0}
    mon = RetraceMonitor(_fake_fns(counts), manifest={"prefill": 3})
    counts["prefill"] = 3
    mon.check()
    counts["prefill"] = 4
    with pytest.raises(InvariantViolation):
        mon.check()


# ------------------------------------------------- serving-level integration
_TINY = dict(n_layers=1, d_model=32, n_heads=4, n_kv_heads=2, d_ff=64,
             vocab_size=53, max_seq_len=160)


def _paged_fns():
    from repro_torch.models.params import init_params
    from repro_torch.models.transformer import TransformerConfig
    from repro_torch.serving.session import make_session_fns
    cfg = TransformerConfig(**_TINY)
    return make_session_fns(cfg, init_params(cfg, seed=11, device="cpu"),
                            slots=9, prefill_len=32, kv_layout="paged",
                            block_size=8, device="cpu")


@pytest.fixture(scope="module")
def paged_fns():
    return _paged_fns()


def _mk_sched(fns, **kw):
    from repro_torch.core import LookaheadConfig
    from repro_torch.serving.scheduler import ContinuousScheduler
    la = LookaheadConfig(decoding_length=8, branch_length=4)
    return ContinuousScheduler(fns, la, lanes=2, prefill_len=32, **kw)


def _prompts(n, seed):
    rng = np.random.RandomState(seed)
    return [rng.randint(1, 52, size=rng.randint(4, 26)).tolist()
            for _ in range(n)]


def test_retrace_monitor_reads_the_session_members(paged_fns):
    """On the port's session a retrace is a new input signature: a cohort
    prefill at a second lane count is within the manifest (one a
    scheduler), a third is not."""
    mon = RetraceMonitor(paged_fns)
    toks = np.ones((2, 32), np.int32)
    lens = np.full((2,), 4, np.int32)
    paged_fns.prefill(toks, lens, np.ones((2, 20), np.int32))
    mon.check()
    paged_fns.prefill(toks[:1], lens[:1], np.ones((1, 20), np.int32))
    with pytest.raises(InvariantViolation, match="StepFns.prefill"):
        mon.check()


def test_sanitized_run_bit_identical_and_audited(paged_fns):
    """sanitize=True changes nothing about outputs, and a full run ends
    with the idle audit (lifecycles drained, ledger matched, retrace
    manifest honored, the poison probe run on scrubbed blocks)."""
    prompts = _prompts(5, seed=21)
    outs = {}
    for sanitize in (False, True):
        sched = _mk_sched(paged_fns, sanitize=sanitize, scrub_freed=True,
                          overlap_drafts=True, prefix_cache=True)
        rids = [sched.submit(p, 12) for p in prompts]
        sched.run()
        outs[sanitize] = [sched.results[r].tokens for r in rids]
    assert outs[True] == outs[False]
    san = sched.sanitizer
    assert san.ledger.probes > 0 and san.ledger.probed_blocks > 0
    assert all(san.lifecycle.state(r) == DRAINED for r in rids)


def test_planted_write_into_a_scrubbed_block_is_caught(paged_fns):
    """A write into a freed, scrubbed block raises at the next admission,
    before the pool can hand the block out again."""
    sched = _mk_sched(paged_fns, sanitize=True, scrub_freed=True)
    for p in _prompts(3, seed=24):
        sched.submit(p, 8)
    sched.run()
    poisoned = sorted(sched.sanitizer.ledger.poisoned)
    assert poisoned
    sched.cache["k"][0, poisoned[-1]] = 1
    sched.submit(_prompts(1, seed=25)[0], 8)
    with pytest.raises(InvariantViolation,
                       match=f"block {poisoned[-1]} has nonzero 'k'"):
        sched.step()


def test_sanitizer_default_off_not_even_imported():
    code = textwrap.dedent(f"""
        import sys
        import numpy as np
        from repro_torch.core import LookaheadConfig
        from repro_torch.models.params import init_params
        from repro_torch.models.transformer import TransformerConfig
        from repro_torch.serving.scheduler import ContinuousScheduler
        from repro_torch.serving.session import make_session_fns
        cfg = TransformerConfig(**{_TINY!r})
        fns = make_session_fns(cfg, init_params(cfg, seed=11, device="cpu"),
                               slots=9, prefill_len=32, kv_layout="paged",
                               block_size=8, device="cpu")
        sched = ContinuousScheduler(
            fns, LookaheadConfig(decoding_length=8, branch_length=4),
            lanes=2, prefill_len=32, scrub_freed=True, prefix_cache=True)
        rng = np.random.RandomState(26)
        for _ in range(3):
            sched.submit(rng.randint(1, 52, size=20).tolist(), 6)
        sched.run()
        assert sched.sanitizer is None
        assert sched.allocator.observer is None
        assert not any(m.startswith("repro_torch.analysis")
                       for m in sys.modules), sorted(sys.modules)
    """)
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=str(REPO), env=ENV, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cancel_of_pending_holds_blocks_until_deferred_drain(paged_fns):
    """Cancelling an overlap admission whose prefill is still in flight
    leaves the request in `retiring` WITH its blocks still owned; the
    deferred drain then frees the blocks and moves it to `drained`."""
    prompts = _prompts(3, seed=22)
    sched = _mk_sched(paged_fns, sanitize=True, scrub_freed=True,
                      overlap_drafts=True)
    r0 = sched.submit(prompts[0], 12)
    sched.step()                         # initial cohort: r0 active
    r1 = sched.submit(prompts[1], 12)
    sched._admit()                       # overlap: r1's prefill in flight
    assert 1 in sched._pending and sched._pending[1].rid == r1
    assert sched.cancel(r1)
    san = sched.sanitizer
    assert san.lifecycle.state(r1) == "retiring"
    assert sched.allocator.owns(r1)
    assert r1 in sched.results and sched.results[r1].cancelled
    sched.run()                          # deferred drain runs + idle audit
    assert san.lifecycle.history(r1) == ["queued", "admitted", "retiring",
                                         "drained"]
    assert not sched.allocator.owns(r1)
    assert sched.results[r0].tokens


def test_premature_free_of_pending_raises(paged_fns):
    """Freeing a pending admission's blocks at cancel time (instead of
    deferring to the drain) trips the ledger's use-after-free gate."""
    prompts = _prompts(2, seed=23)
    sched = _mk_sched(paged_fns, sanitize=True, scrub_freed=True,
                      overlap_drafts=True)
    sched.submit(prompts[0], 12)
    sched.step()
    r1 = sched.submit(prompts[1], 12)
    sched._admit()
    assert sched._pending[1].rid == r1
    with pytest.raises(InvariantViolation, match="use-after-free"):
        sched.allocator.free(r1)
