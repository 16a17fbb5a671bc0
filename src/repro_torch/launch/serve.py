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

Weights are random, made on the device from a seed.  Reports throughput
(tokens/s), EDL, lane occupancy, the per-step time split, the KV pool and
prefix-cache counts, and per-request latency percentiles.  ``--rate 0``
submits every request at t=0; a positive rate draws Poisson inter-arrival
gaps and the scheduler admits mid-flight.

The port serves greedy requests; the reference CLI's other flags exit
with "not yet ported".
"""
from __future__ import annotations

import argparse
import time
from typing import List

import numpy as np

from repro_torch import configs as cfgreg
from repro_torch.core import LookaheadEngine, Request, SamplingParams
from repro_torch.models import attention as attn_backends
from repro_torch.models.params import init_params
from repro_torch.serving.api import EngineConfig, build_engine
from repro_torch.serving.block_allocator import worst_case_pool_blocks
from repro_torch.training.data import PROFILES, SyntheticCorpus

# flags of repro.launch.serve that later slices bring
NOT_PORTED = (
    "--mixed", "--mixed-sampling", "--cancel-every", "--overlap-drafts",
    "--draft-sources", "--adaptive-draft", "--trie-namespace-key",
    "--lane-shares", "--draft-budget-caps", "--autotune", "--sanitize",
    "--ckpt-dir", "--sample", "--temperature", "--prefill-backend",
    "--decode-backend", "--replicas", "--routing", "--gossip-every", "--fleet-queue-depth",
    "--warm-state", "--verify-fleet")


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


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
    ap.add_argument("--prefill-len", type=int, default=128,
                    help="fixed prompt pad length")
    ap.add_argument("--decoding-length", type=int, default=32)
    ap.add_argument("--branch-length", type=int, default=12)
    ap.add_argument("--eos-id", type=int, default=-1,
                    help="EOS token id ending generation early (-1 = none)")
    ap.add_argument("--backend", default=None,
                    choices=attn_backends.available_backends(),
                    help="attention backend for both phases (default: the "
                         "config's, i.e. the CUDA kernels)")
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
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain "
                         "versions")
    args, unknown = ap.parse_known_args(argv)
    for tok in unknown:
        flag = tok.split("=", 1)[0]
        if flag in NOT_PORTED:
            ap.exit(2, f"{flag}: not yet ported to repro_torch (see "
                       "ROADMAP.md)\n")
    if unknown:
        ap.error(f"unrecognized arguments: {' '.join(unknown)}")
    if args.prefix_cache and args.kv_layout != "paged":
        ap.error("--prefix-cache requires --kv-layout paged")
    if args.kv_layout == "paged" and args.mode == "lockstep":
        ap.error("--kv-layout paged requires --mode continuous (the "
                 "scheduler owns the block allocator)")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    mod = cfgreg.get_arch(args.arch)
    cfg = mod.smoke_config() if args.smoke else mod.full_config()
    if args.smoke:
        cfg = type(cfg)(**{**cfg.__dict__, "max_seq_len": 768})
    params = init_params(cfg, seed=0, device=args.device)
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
        backend=args.backend, kv_layout=args.kv_layout,
        block_size=args.block_size, n_blocks=n_blocks,
        prefix_cache=args.prefix_cache,
        prefix_cache_blocks=args.prefix_cache_blocks or None,
        default_params=SamplingParams(max_new_tokens=args.max_new))

    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=0)
    prompt_cap = min(96, args.prefill_len)
    system_prompt = (corpus.sample()[0][:min(args.shared_prefix, prompt_cap)]
                     if args.shared_prefix > 0 else [])

    def _prompt():
        tail_cap = max(prompt_cap - len(system_prompt), 1)
        return list(system_prompt) + corpus.sample()[0][:tail_cap]

    reqs = [Request(prompt=_prompt(),
                    params=SamplingParams(max_new_tokens=args.max_new),
                    metadata={"i": i})
            for i in range(args.requests)]
    engine = build_engine(ecfg, cfg, params, device=args.device)

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
    handles = []
    t0 = time.time()
    nxt = 0
    while nxt < len(reqs) or not engine.idle:
        now = time.time() - t0
        while nxt < len(reqs) and arrivals[nxt] <= now:
            handles.append(engine.submit(reqs[nxt]))
            nxt += 1
        if engine.idle:
            time.sleep(min(max(arrivals[nxt] - now, 0.0), 0.05))
            continue
        engine.step()
    dt = time.time() - t0
    results = [h.result() for h in handles]

    tok = sum(len(r.tokens) for r in results)
    steps = sum(r.stats.steps for r in results)
    st = engine.stats
    print(f"continuous [{args.device}]: {tok} tokens / {len(results)} "
          f"requests ({st.decode_steps} device steps, EDL "
          f"{tok/max(steps,1):.2f}, occupancy {st.occupancy:.2f}) in "
          f"{dt:.1f}s -> {tok/dt:.1f} tok/s")
    cache = engine.scheduler.cache
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
              f"{engine.scheduler.prefix.n_blocks} resident blocks, "
              f"{st.prefix_evicted_blocks} evicted")
    br = st.breakdown()
    print(f"step breakdown: draft {br['host_draft_ms']:.2f} ms   "
          f"device {br['device_step_ms']:.2f} ms   "
          f"accept {br['accept_commit_ms']:.2f} ms   "
          f"{br['syncs_per_step']:.1f} sync/step")
    lat = [r.latency_s for r in results]
    ttft = [r.ttft_s for r in results]
    print(f"latency  p50 {_pct(lat, 50)*1e3:7.1f} ms   "
          f"p95 {_pct(lat, 95)*1e3:7.1f} ms   "
          f"p99 {_pct(lat, 99)*1e3:7.1f} ms")
    print(f"ttft     p50 {_pct(ttft, 50)*1e3:7.1f} ms   "
          f"p95 {_pct(ttft, 95)*1e3:7.1f} ms   "
          f"p99 {_pct(ttft, 99)*1e3:7.1f} ms")


if __name__ == "__main__":
    main()
