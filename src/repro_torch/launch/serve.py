"""Serving launcher of the PyTorch port: drive the request-centric serving
engine (or the lock-step loop) over an arch config with a synthetic arrival
stream.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --requests 8 --lanes 4

runs on the card (``--device cuda``, the default; ``--smoke --device cpu``
runs a reduced config on the CPU).  ``--kv-layout paged`` serves from a
block pool sized to the workload's worst case, ``--prefix-cache`` adds the
radix prefix cache on it, and ``--shared-prefix N`` gives every request the
same N-token head (the reference's shared system-prompt workload):

    PYTHONPATH=src python -m repro_torch.launch.serve --kv-layout paged \
        --prefix-cache --shared-prefix 80

Requests carry their own ``SamplingParams``: ``--sample --temperature T``
samples every request, ``--mixed-sampling`` alternates greedy and sampled
requests (distinct temperatures and seeds) in one lane pool, ``--mixed``
alternates short and long budgets, and ``--cancel-every N`` cancels every
Nth request mid-flight through its handle:

    PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu \
        --mixed-sampling --lanes 2

The scheduler's host-side features are flags too: ``--overlap-drafts``,
``--draft-sources``, ``--adaptive-draft``, ``--trie-namespace-key`` (with
``--lane-shares`` and ``--draft-budget-caps`` per namespace) and
``--autotune``; ``--prefill-backend`` / ``--decode-backend`` pick one
attention phase's backend.

Weights are random, made on the device from a seed.  Reports throughput
(tokens/s), EDL, lane occupancy, the per-step time split, the KV pool and
prefix-cache counts, and per-request latency percentiles (per tenant when
requests carry namespaces).  ``--rate 0`` submits every request at t=0; a
positive rate draws Poisson inter-arrival gaps and the scheduler admits
mid-flight.

``--sanitize`` runs the runtime sanitizer (lifecycle machine, shadow block
ledger with the device poison probe, retrace monitor) and closes with its
audit line.  ``--replicas N`` serves through N in-process engine replicas
behind the namespace-affinity router (``--routing``, ``--fleet-queue-depth``,
``--gossip-every``; ``--verify-fleet`` re-runs the workload on one engine and
requires equal outputs), and ``--warm-state PATH`` loads a draft-state file
at start when it exists and saves one at exit:

    PYTHONPATH=src python -m repro_torch.launch.serve --replicas 2 \
        --trie-namespace-key tenant --gossip-every 2 --verify-fleet \
        --kv-layout paged --prefix-cache --shared-prefix 80 \
        --warm-state warm.json

``--ckpt-dir DIR`` serves the parameters of the latest checkpoint in DIR,
restored as ``{"params": ...}`` as the reference's CLI does (a checkpoint
``CheckpointManager.save(step, {"params": params})`` wrote, in either
package).  The train CLIs save ``{"p", "o"}``, which this restore cannot
read: a fault of the reference that the port keeps (ROADMAP §C).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time
from typing import List

import numpy as np

from repro_torch import configs as cfgreg
from repro_torch.core import (DraftPolicy, LookaheadEngine, Request,
                              SamplingParams)
from repro_torch.core.draft_sources import available_sources
from repro_torch.models import attention as attn_backends
from repro_torch.models.params import (init_params, resolve_device,
                                       tree_to_torch)
from repro_torch.serving.api import EngineConfig, build_engine
from repro_torch.serving.block_allocator import worst_case_pool_blocks
from repro_torch.training.checkpoint import CheckpointManager
from repro_torch.training.data import PROFILES, SyntheticCorpus


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


def _request_params(args, i: int) -> SamplingParams:
    """Per-request SamplingParams for request i of the synthetic stream."""
    max_new = args.max_new if (not args.mixed or i % 2) else \
        max(args.max_new // 4, 2)
    if args.mixed_sampling:
        # alternate greedy / sampled at cycling temperatures, one seed per
        # request — a co-batched mix the per-lane param vectors must honor
        if i % 2:
            return SamplingParams(max_new_tokens=max_new, sample=True,
                                  temperature=(0.5, 0.8, 1.1)[i % 3],
                                  seed=1000 + i)
        return SamplingParams(max_new_tokens=max_new)
    return SamplingParams(max_new_tokens=max_new, sample=args.sample,
                          temperature=args.temperature, seed=0)


def _ns_map(spec, cast):
    """``ns=value,...`` -> {ns: cast(value)} (None when unset)."""
    if not spec:
        return None
    out = {}
    for cell in spec.split(","):
        ns, sep, val = cell.partition("=")
        if not sep:
            raise SystemExit(f"bad ns=value cell {cell!r}")
        out[ns] = cast(val)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--lanes", type=int, default=4,
                    help="KV-cache slots held on device (continuous mode)")
    ap.add_argument("--mode", choices=["continuous", "lockstep"],
                    default="continuous")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="mean arrivals/s (Poisson); 0 = all at t0")
    ap.add_argument("--max-new", type=int, default=48)
    ap.add_argument("--mixed", action="store_true",
                    help="mixed-length workload: alternate max_new/4 and "
                         "max_new budgets (the continuous-batching case)")
    ap.add_argument("--mixed-sampling", action="store_true",
                    help="mixed per-request sampling: alternate greedy and "
                         "sampled (distinct temperatures/seeds) requests in "
                         "the same lane pool")
    ap.add_argument("--cancel-every", type=int, default=0,
                    help="cancel every Nth request mid-flight through its "
                         "RequestHandle (0 = never)")
    ap.add_argument("--overlap-drafts", action="store_true",
                    help="overlap host work with the in-flight device step "
                         "(deferred retirement + admission settles after "
                         "draft building); the same outputs as the serial "
                         "path")
    ap.add_argument("--prefill-len", type=int, default=128,
                    help="fixed prompt pad length")
    ap.add_argument("--decoding-length", type=int, default=32)
    ap.add_argument("--branch-length", type=int, default=12)
    ap.add_argument("--draft-sources", default="trie",
                    help="comma-separated draft sources feeding every "
                         "request's trees, in merge-priority order "
                         f"(registry: {', '.join(available_sources())})")
    ap.add_argument("--adaptive-draft", action="store_true",
                    help="per-lane adaptive draft budget from the "
                         "accepted-length EMA")
    ap.add_argument("--trie-namespace-key", default=None,
                    help="request-metadata key whose value scopes the trie "
                         "namespace (the synthetic stream tags requests "
                         "with 'tenant')")
    ap.add_argument("--lane-shares", default=None,
                    help="per-namespace lane shares as ns=frac,... (e.g. "
                         "t0=0.5,t1=0.5): weighted-fair admission with a "
                         "lane-occupancy cap of ceil(lanes*frac) each")
    ap.add_argument("--draft-budget-caps", default=None,
                    help="per-namespace draft budget caps as ns=int,...")
    ap.add_argument("--autotune", action="store_true",
                    help="per-namespace draft-source auto-tuning (EMA "
                         "acceptance controller; outputs unchanged)")
    ap.add_argument("--sample", action="store_true",
                    help="sample every request (Gumbel-argmax, seed 0)")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="EOS token id ending generation early (-1 = none)")
    ap.add_argument("--backend", default=None,
                    choices=attn_backends.available_backends(),
                    help="attention backend for both phases (default: the "
                         "config's, i.e. the CUDA kernels)")
    ap.add_argument("--prefill-backend", default=None,
                    choices=attn_backends.available_backends(),
                    help="prefill-phase attention backend override")
    ap.add_argument("--decode-backend", default=None,
                    choices=attn_backends.available_backends(),
                    help="tree-decode-phase attention backend override")
    ap.add_argument("--kv-layout", default="dense",
                    choices=["dense", "paged"],
                    help="KV-cache layout: dense (lanes, max_seq_len) rows "
                         "or a paged block pool with per-lane block tables")
    ap.add_argument("--block-size", type=int, default=64,
                    help="paged layout: KV rows per block")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="paged layout: total pool blocks (0 = size the "
                         "pool to the workload's worst-case footprint)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix-tree prefix caching on the paged pool "
                         "(copy-on-write block sharing; same outputs)")
    ap.add_argument("--prefix-cache-blocks", type=int, default=0,
                    help="cap on blocks the prefix cache may keep resident "
                         "(0 = bounded only by pool pressure)")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="give every request a shared system-prompt prefix "
                         "of this many tokens")
    ap.add_argument("--sanitize", action="store_true",
                    help="runtime sanitizer: shadow block-ownership "
                         "ledger with a device poison probe, per-request "
                         "lifecycle state machine, retrace monitor; raises "
                         "on any invariant violation, outputs unchanged")
    ap.add_argument("--replicas", type=int, default=1,
                    help="serve through N in-process engine replicas behind "
                         "the namespace-affinity router (1 = one engine)")
    ap.add_argument("--routing", default="affinity",
                    choices=["affinity", "round_robin"],
                    help="fleet placement policy: consistent-hash namespace "
                         "affinity or round-robin (the cold baseline)")
    ap.add_argument("--gossip-every", type=int, default=0,
                    help="fleet rounds between all-to-all draft-state "
                         "merges (0 = gossip off)")
    ap.add_argument("--fleet-queue-depth", type=int, default=8,
                    help="per-replica queue depth at which affinity "
                         "routing spills to the least-loaded replica")
    ap.add_argument("--warm-state", default=None,
                    help="draft-state file: loaded at start when it exists "
                         "(warm restart), saved at exit")
    ap.add_argument("--verify-fleet", action="store_true",
                    help="re-run the fleet workload on one engine and "
                         "require equal outputs")
    ap.add_argument("--ckpt-dir", default=None,
                    help="serve the latest checkpoint's {'params'} here")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args = ap.parse_args(argv)
    if args.prefix_cache and args.kv_layout != "paged":
        ap.error("--prefix-cache requires --kv-layout paged")
    if args.kv_layout == "paged" and args.mode == "lockstep":
        ap.error("--kv-layout paged requires --mode continuous (the "
                 "scheduler owns the block allocator)")
    if (args.lane_shares or args.draft_budget_caps) \
            and not args.trie_namespace_key:
        ap.error("--lane-shares/--draft-budget-caps key on the request "
                 "namespace; set --trie-namespace-key (e.g. tenant) so "
                 "requests carry one")
    if args.mode == "lockstep" and (
            args.draft_sources != "trie" or args.adaptive_draft
            or args.trie_namespace_key or args.autotune):
        ap.error("--draft-sources/--adaptive-draft/--trie-namespace-key/"
                 "--autotune require --mode continuous (the lock-step loop "
                 "is the hardwired-trie baseline)")
    if args.replicas > 1 and args.mode != "continuous":
        ap.error("--replicas requires --mode continuous")
    if args.replicas > 1 and args.cancel_every:
        ap.error("--cancel-every is a single-engine exercise; drop it with "
                 "--replicas")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    lane_shares = _ns_map(args.lane_shares, float)
    draft_caps = _ns_map(args.draft_budget_caps, int)
    draft_policy = DraftPolicy(
        sources=tuple(args.draft_sources.split(",")),
        adaptive=args.adaptive_draft).validate()
    mod = cfgreg.get_arch(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    if not hasattr(cfg, "n_layers"):
        raise SystemExit(f"{args.arch} is not an LM arch; serving loop is "
                         "for autoregressive decoders (see DESIGN.md "
                         "§Arch-applicability)")
    if args.smoke:
        cfg = type(cfg)(**{**cfg.__dict__, "max_seq_len": 768})
    params = init_params(cfg, seed=0, device=args.device)
    if args.ckpt_dir:
        state, step = CheckpointManager(args.ckpt_dir).restore(
            {"params": params})
        params = tree_to_torch(state["params"],
                               resolve_device(args.device))
        print(f"restored checkpoint step {step}")
    n_blocks = None
    if args.kv_layout == "paged":
        # the pool the workload's worst case needs, by the formula the
        # scheduler admits by (the paged layout's memory win)
        n_blocks = args.kv_blocks or worst_case_pool_blocks(
            args.lanes, args.prefill_len, args.max_new,
            1 + args.decoding_length, cfg.max_seq_len, args.block_size)
    ecfg = EngineConfig(
        lanes=args.lanes, prefill_len=args.prefill_len,
        decoding_length=args.decoding_length,
        branch_length=args.branch_length, eos_id=args.eos_id,
        backend=args.backend, prefill_backend=args.prefill_backend,
        decode_backend=args.decode_backend, kv_layout=args.kv_layout,
        block_size=args.block_size, n_blocks=n_blocks,
        default_params=SamplingParams(
            max_new_tokens=args.max_new, sample=args.sample,
            temperature=args.temperature),
        draft_policy=draft_policy, overlap_drafts=args.overlap_drafts,
        prefix_cache=args.prefix_cache,
        prefix_cache_blocks=args.prefix_cache_blocks or None,
        lane_shares=lane_shares, draft_budget_caps=draft_caps,
        autotune=args.autotune, sanitize=args.sanitize)

    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=0)
    prompt_cap = min(96, args.prefill_len)
    system_prompt = (corpus.sample()[0][:min(args.shared_prefix, prompt_cap)]
                     if args.shared_prefix > 0 else [])

    def _prompt():
        tail_cap = max(prompt_cap - len(system_prompt), 1)
        return list(system_prompt) + corpus.sample()[0][:tail_cap]

    reqs = [Request(prompt=_prompt(), params=_request_params(args, i),
                    metadata={"i": i, "tenant": f"t{i % 2}"})
            for i in range(args.requests)]
    if args.trie_namespace_key:
        # scenario-scoped tries: each request speculates inside the trie
        # namespace its metadata names (per-request DraftPolicy override)
        for r in reqs:
            ns = str(r.metadata.get(args.trie_namespace_key, ""))
            r.params = dataclasses.replace(
                r.params,
                draft=dataclasses.replace(draft_policy, namespace=ns))
    if args.replicas > 1:
        _run_fleet(args, ecfg, cfg, params, reqs)
        return
    engine = build_engine(ecfg, cfg, params, device=args.device)
    if args.warm_state and os.path.exists(args.warm_state):
        engine.load_draft_state(args.warm_state)
        print(f"warm state loaded from {args.warm_state} "
              f"(trie={len(engine.scheduler.sources['trie'].forest)} nodes)")

    if args.mode == "lockstep":
        lock = LookaheadEngine(engine.fns, ecfg.lookahead(),
                               eos_id=ecfg.eos_id)
        t0 = time.time()
        tok = steps = 0
        for i in range(0, len(reqs), args.lanes):
            chunk = reqs[i:i + args.lanes]
            outs = lock.generate_batch_lockstep(
                [r.prompt for r in chunk], params=[r.params for r in chunk])
            for o in outs:
                tok += len(o.tokens)
                steps += o.stats.steps
        dt = time.time() - t0
        print(f"lockstep: {tok} tokens / {steps} steps "
              f"(EDL {tok/max(steps,1):.2f}) in {dt:.1f}s "
              f"-> {tok/dt:.1f} tok/s; trie={len(lock.trie)} nodes")
        return

    rng = np.random.RandomState(0)
    arrivals = (np.cumsum(rng.exponential(1.0 / args.rate, size=len(reqs)))
                if args.rate > 0 else np.zeros(len(reqs)))
    streamed = [0]          # tokens observed through handle callbacks
    handles, cancelled = [], []
    t0 = time.time()
    nxt = 0
    while nxt < len(reqs) or not engine.idle:
        now = time.time() - t0
        while nxt < len(reqs) and arrivals[nxt] <= now:
            h = engine.submit(reqs[nxt])
            h.on_token(lambda delta: streamed.__setitem__(
                0, streamed[0] + len(delta)))
            handles.append(h)
            if args.cancel_every and (nxt % args.cancel_every
                                      == args.cancel_every - 1):
                cancelled.append(h)
            nxt += 1
        if engine.idle:
            time.sleep(min(max(arrivals[nxt] - now, 0.0), 0.05))
            continue
        engine.step()
        for h in cancelled:
            if not h.done:
                h.cancel()
    dt = time.time() - t0
    results = [h.result() for h in handles]

    live = [r for r in results if not r.cancelled]
    tok = sum(len(r.tokens) for r in live)
    steps = sum(r.stats.steps for r in live)
    st = engine.stats
    sched = engine.scheduler
    n_sampled = sum(1 for r in reqs if r.params.sample)
    print(f"continuous [{args.device}]: {tok} tokens / {len(live)} "
          f"requests ({len(results) - len(live)} cancelled, {n_sampled} "
          f"sampled, {streamed[0]} streamed tokens, {st.decode_steps} "
          f"device steps, EDL {tok/max(steps,1):.2f}, occupancy "
          f"{st.occupancy:.2f}) in {dt:.1f}s -> {tok/dt:.1f} tok/s")
    cache = sched.cache
    if cache is not None:
        extra = (f", peak {st.peak_blocks} blocks, {st.block_waits} "
                 "block-waits" if args.kv_layout == "paged" else "")
        print(f"kv cache [{args.kv_layout}]: "
              f"{sum(v.nbytes for v in cache.values()) / 2**20:.1f} MiB"
              f"{extra}")
    if args.prefix_cache:
        print(f"prefix cache: {st.prefix_hits}/{st.prefix_lookups} hits "
              f"({st.prefix_hit_rate:.0%}), "
              f"{st.prefix_hit_tokens}/{st.prefix_prompt_tokens} prefill "
              f"tokens saved ({st.prefill_tokens_saved:.0%}), "
              f"{st.prefix_cow_forks} COW forks, "
              f"{sched.prefix.n_blocks} resident blocks, "
              f"{st.prefix_evicted_blocks} evicted")
    br = st.breakdown()
    mode = "overlap" if args.overlap_drafts else "serial"
    print(f"step breakdown [{mode}]: draft {br['host_draft_ms']:.2f} ms   "
          f"device {br['device_step_ms']:.2f} ms   "
          f"accept {br['accept_commit_ms']:.2f} ms   "
          f"hidden {br['hidden_host_ms']:.2f} ms   "
          f"{br['syncs_per_step']:.1f} sync/step")
    # pooled percentiles would let a hot tenant's volume dilute a cold
    # tenant's p99, so multi-tenant runs report per namespace instead
    ns_sum = st.namespace_summary()
    if not (lane_shares or len(ns_sum) > 1):
        lat = [r.latency_s for r in live]
        ttft = [r.ttft_s for r in live]
        print(f"latency  p50 {_pct(lat, 50)*1e3:7.1f} ms   "
              f"p95 {_pct(lat, 95)*1e3:7.1f} ms   "
              f"p99 {_pct(lat, 99)*1e3:7.1f} ms")
        print(f"ttft     p50 {_pct(ttft, 50)*1e3:7.1f} ms   "
              f"p95 {_pct(ttft, 95)*1e3:7.1f} ms   "
              f"p99 {_pct(ttft, 99)*1e3:7.1f} ms")
    else:
        for ns, row in ns_sum.items():
            print(f"tenant {ns or '<default>'!s:10s} "
                  f"fin {row['finished']:3d}/{row['submitted']:3d} "
                  f"({row['cancelled']} cancelled) "
                  f"occ {row['occupancy']:.2f}  "
                  f"p50 {row['p50_latency_s']*1e3:7.1f} ms  "
                  f"p99 {row['p99_latency_s']*1e3:7.1f} ms  "
                  f"ttft-p99 {row['p99_ttft_s']*1e3:7.1f} ms  "
                  f"queue-p99 {row['p99_queue_s']*1e3:7.1f} ms")
    forest = sched.sources["trie"].forest
    print(f"trie={len(forest)} nodes across {len(forest.namespaces())} "
          "namespace(s)")
    drafted, accepted = {}, {}
    for r in results:
        for k, v in r.stats.source_drafted.items():
            drafted[k] = drafted.get(k, 0) + v
        for k, v in r.stats.source_accepted.items():
            accepted[k] = accepted.get(k, 0) + v
    if drafted:
        cells = [f"{name} {accepted.get(name, 0)}/{n} "
                 f"({accepted.get(name, 0) / max(n, 1):.0%})"
                 for name, n in sorted(drafted.items())]
        print(f"draft sources (accepted/drafted): {'   '.join(cells)}")
    if sched.autotuner is not None:
        for ns, srcs in sorted(sched.autotuner.snapshot().items()):
            cells = [f"{name} {'on' if s['enabled'] else 'OFF'} "
                     f"ema {s['ema']:.2f} ({s['accepted']}/{s['drafted']}, "
                     f"{s['probes']} probes)"
                     for name, s in sorted(srcs.items())]
            print(f"autotune [{ns or '<default>'}]: {'   '.join(cells)}")
    if sched.sanitizer is not None:
        # reaching this line means every shadow check passed (violations
        # raise); report the audit so smoke logs show it actually ran
        n_tracked = len(sched.sanitizer.lifecycle._state)
        print(f"sanitizer: clean — {n_tracked} request lifecycles "
              "drained, block ledger and retrace manifest verified")
    if args.warm_state:
        engine.save_draft_state(args.warm_state)
        print(f"warm state saved to {args.warm_state}")


def _run_fleet(args, ecfg, cfg, params, reqs) -> None:
    """Drive the synthetic arrival stream through an N-replica fleet
    (``repro_torch.fleet``): in-process replicas sharing one set of
    weights, namespace-affinity or round-robin routing, optional gossip
    cadence, warm-state load at start / save at exit, and an optional
    check of every output against one engine's."""
    from repro_torch.fleet import EngineReplica, FleetRouter, GossipCoordinator

    def _builder():
        return build_engine(ecfg, cfg, params, device=args.device)

    replicas = [EngineReplica(_builder, replica_id=f"r{i}")
                for i in range(args.replicas)]
    if args.warm_state and os.path.exists(args.warm_state):
        for rep in replicas:
            rep.load_draft_state(args.warm_state)
        print(f"warm state loaded from {args.warm_state} "
              f"(all {args.replicas} replicas)")
    router = FleetRouter(replicas, policy=args.routing,
                         max_queue_depth=args.fleet_queue_depth)
    gossip = GossipCoordinator(replicas, every=args.gossip_every)

    rng = np.random.RandomState(0)
    arrivals = (np.cumsum(rng.exponential(1.0 / args.rate, size=len(reqs)))
                if args.rate > 0 else np.zeros(len(reqs)))
    t0 = time.time()
    nxt = 0
    while nxt < len(reqs) or not router.idle:
        now = time.time() - t0
        while nxt < len(reqs) and arrivals[nxt] <= now:
            router.submit(reqs[nxt].prompt, reqs[nxt].params)
            nxt += 1
        if router.idle:
            time.sleep(min(max(arrivals[nxt] - now, 0.0), 0.05))
            continue
        router.step_all()
        gossip.tick()
    dt = time.time() - t0

    results = router.results()
    tok = sum(len(r["tokens"]) for r in results)
    fs = router.fleet_stats()
    print(f"fleet [{args.replicas}x {args.routing}, {args.device}]: {tok} "
          f"tokens / {len(results)} requests in {dt:.1f}s -> "
          f"{tok/dt:.1f} tok/s; routed {fs.routed} ({fs.affinity_hits} "
          f"affinity, {fs.spills} spills), {gossip.exchanges} gossip "
          "exchanges")
    for i, snap in enumerate(fs.replicas):
        print(f"  replica r{i}: {snap['finished']} finished / "
              f"{snap['admitted']} admitted, {snap['decode_steps']} device "
              f"steps, trie={snap['trie_nodes']} nodes")
    # per-tenant percentiles over the union of every replica's samples
    # (never pooled across tenants, never averaged across replicas)
    for ns, row in fs.namespace_summary().items():
        print(f"tenant {ns or '<default>'!s:10s} "
              f"fin {row['finished']:3d}/{row['submitted']:3d} "
              f"occ {row['occupancy']:.2f}  "
              f"p50 {row['p50_latency_s']*1e3:7.1f} ms  "
              f"p99 {row['p99_latency_s']*1e3:7.1f} ms  "
              f"ttft-p99 {row['p99_ttft_s']*1e3:7.1f} ms")
    for ns, accs in sorted(fs.source_acceptance().items()):
        cells = [f"{name} {rate:.0%}" for name, rate in sorted(accs.items())]
        print(f"acceptance [{ns or '<default>'}]: {'   '.join(cells)}")
    if args.sanitize:
        router.drain()      # an idle replica's run() is its idle audit
        print(f"sanitizer: clean — {len(results)} requests over "
              f"{args.replicas} replicas, each replica's idle audit passed")

    if args.verify_fleet:
        single = _builder()
        handles = [single.submit(Request(prompt=list(r.prompt),
                                         params=r.params)) for r in reqs]
        single.run()
        bad = sum(1 for h, res in zip(handles, results)
                  if h.result().tokens != res["tokens"])
        if bad:
            raise SystemExit(f"fleet outputs differ from one engine's on "
                             f"{bad}/{len(reqs)} requests (losslessness "
                             "violation)")
        print(f"verify: fleet outputs equal one engine's on all "
              f"{len(reqs)} requests")

    if args.warm_state:
        if len(replicas) > 1:
            gossip.exchange()   # fold every replica's warmth into one file
        replicas[0].save_draft_state(args.warm_state)
        print(f"warm state saved to {args.warm_state}")


if __name__ == "__main__":
    main()
