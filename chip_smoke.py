#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py [--phases kernels,model,...]

Phases, in order; any failure exits non-zero:

1. the card: its name and power limit from ``nvidia-smi``;
2. the build: the six CUDA kernels compiled from this checkout's sources,
   one ``nvcc`` each, in parallel; each attention kernel's registers and
   spills from ptxas, and a check of the SASS (``cuobjdump``) of every bf16
   attention kernel (tree and causal): tensor-core products (HMMA),
   asynchronous copies (LDGSTS), no spills; B5's eight instantiations'
   registers, no spills;
3. the kernels: each held against its plain PyTorch version on the card in
   f32 and bf16 — at the serving path's shapes and at the shapes of
   ``tests/test_kernels.py`` / ``tests/test_paged_cache.py`` — the paged
   kernel against the dense one and the triangular-schedule prefill (B4)
   against the plain prefill kernel (B3), bit for bit; the Gumbel-argmax
   kernel's raw bits against the plain threefry2x32 bit for bit, its Gumbel
   values within 2e-6 and its choices against the plain version's wherever
   the top-two gap of z + g exceeds 1e-5; the fused EmbeddingBag (B5) bit
   for bit, on both of its slices (16-byte and scalar), with masked slots
   and negative and out-of-range ids too; then each timed
   beside its plain version, the one PyTorch library call that computes the
   same function where there is one (timed here only, never called by the
   port) and its bound (bytes over 3.35 TB/s or operations over the peak
   rate for the input type, whichever is larger; the Gumbel kernel's
   operations are the SASS instructions of its loop per drawn entry over
   the SMs' issue rate at their maximum clock, an issue-rate bound of its
   SASS, with the function's own operation count beside it) — by CUDA
   events around a loop of calls (host dispatch included) and by device
   time from torch.profiler (``device_ms``, ``library_device_ms``);
4. the model: Qwen2-1.5B at full width with 2 layers, the cuda backend's
   logits against the dense backend's in f32 on both KV layouts (and the
   suffix prefill), and in bf16 both against the f32 path, with a limit
   that kernels made 3 % wrong must fail;
4b. recsys scoring: Wide & Deep, Two-Tower, SASRec and BERT4Rec at their
   full published configurations in f32, each serve cell through its
   config's serve function (Wide & Deep serve_p99, serve_bulk and
   retrieval_cand (10^6 candidate contexts), Two-Tower
   serve_p99 and retrieval_cand, SASRec and BERT4Rec serve_p99 and
   retrieval_cand), timed, with B5 launched exactly twice per Wide & Deep
   forward and never elsewhere, and the scores held against the same
   function computed in float64 on the card (Two-Tower's top-128 indices
   against the float64 ranking wherever neighbours are further apart than
   the tolerance); B5 held against its plain version bit for bit at Wide &
   Deep's bag shapes in f32 and bf16 and timed there on the model's call
   (ids and mask), with a second bound that counts the distinct 32-byte
   sectors that the distinct rows read lie in;
5. the main path: Qwen2-1.5B at full width in bf16 with random weights from
   a seed, served through ``build_engine`` (its members captured CUDA
   graphs, replayed; launch counts add the captured launches on every
   replay) with the serve CLI's defaults and
   a guided logits transform (drafts verify, and token choice never rests on
   a near tie), first on the dense KV layout, then on the paged layout —
   the same requests, and a shared-prefix workload with the prefix cache on
   and off.  Every output must equal the port's ``reference_decode`` (and
   the other layout's / the other run's), each kernel must have launched on
   its path (the paged kernel on every paged decode step and suffix
   prefill, the dense one never there), each decode step must pull exactly
   one packed result to the host, and no step function may sync the host;
6. batch-shape invariance: how many logits rows of one request differ in
   bits between the serving shapes and the B = 1 shapes (a finding); the
   padded one-lane admission and the prefix cache's suffix prefill (its
   last-token logits and the tail's K/V rows in every layer) must give the
   uncached admission's bits (a check);
7. sampled serving, unguided: one lane on the dense layout (all sampled),
   four lanes on the paged layout (greedy and sampled mixed), and sampled
   requests sharing a cached prefix with the prefix cache on and off; every
   output must equal ``reference_decode`` at the serving batch shape (and
   the cached run the uncached one), the Gumbel-argmax kernel must carry the
   choices, one sync per decode step, and no sampled member may sync the
   host;
8. overlap: the guided dense path with ``overlap_drafts`` equals the serial
   run, with no sync inside the dispatch;
8b. graphs: every serving phase runs its step functions as captured CUDA
   graphs (the session's default on the card); this phase holds them
   against the eager twin (``cuda_graphs=False``) on the guided dense and
   paged cells and the mixed sampled cell, Qwen2-1.5B's depth cut to
   GRAPHS_LAYERS (its first layers) — every member call (cohort
   prefill, fused steps, the padded admission in each lane, each suffix
   bucket) gives the same outputs, step logits and K/V rows below each
   lane's length — serves each cell in turns (captured, eager, eager,
   captured) with equal outputs, and prints the median fused_step,
   tokens/s, EDL, a profile of decode steps each way (device busy, idle
   share, device kernels and host launch calls a step), each member's
   capture time and graph pool memory, and the prefill's device time with
   the prefix cache on and off;
8c. fleet: two in-process replicas behind the namespace-affinity router
   (two namespaces, a queue depth that makes one spill, gossip every two
   rounds) serve the guided dense cell: outputs equal one engine's and
   ``reference_decode`` at the serving batch shape, B1 launches once a
   layer a decode step summed over both replicas; the serve CLI with
   ``--replicas 2 --verify-fleet --warm-state`` on the paged layout with
   the prefix cache; its warm-state file loaded into a fresh paged engine
   gives prefix hits on the first requests that share a persisted prefix,
   with the outputs of an engine without it; a replica in a spawned
   process builds its engine on the card and gives the in-process
   replica's tokens, and closing it ends the child and frees its memory;
   the fleet's tokens/s beside one engine's, cold and warm, with and
   without gossip (a finding);
8d. sanitize: the guided paged cell with the prefix cache and the mixed
   sampled paged cell, both scrubbing freed blocks, served without and
   with the runtime sanitizer: equal outputs, a clean idle audit, the
   poison probe run on scrubbed blocks, and a write planted into a freed,
   scrubbed block raising at the next admission; the median fused_step
   each way (the sanitizer's cost, a finding);
9. the long prompt: the dense main path at ``prefill_len`` 4096 with two
   requests of about 4,000 tokens; outputs equal ``reference_decode``, B3
   launches once a layer per prefill, one pull per decode step; the
   prefill's device time and B3's share of it, and a decode step's tree
   attention over ~4,000 keys;
10. the other archs: AntGLM-10B, Phi-3-mini and Phi-3-medium at full width
   in bf16, their depth cut to 1/ARCH_DEPTH_DIV (named on a line before
   each arch's), (weights from seed 0, each freed before the next; parameter
   count and peak memory printed), each served guided on the dense and the
   paged layout (6 requests on 4 lanes, so two are admitted into a lane
   mid-flight; the serve CLI's defaults, captured members): outputs equal
   ``reference_decode`` at the serving batch shape and each other, B1
   (dense) or B2 (paged) once a layer a decode step and the other never,
   B3 once a layer a prefill, one pull a decode step, no member syncs; a
   profile of decode steps and the cohort prefill's device time with B3's
   share.  AntGLM-10B (the paper's model) also runs the default Lookahead
   config, LLMA's single branch and step by step on the same requests and
   two primers whose prompts hold the walk their partners generate, so
   that LLMA's drafts verify (outputs equal; median fused_step, EDL and
   tokens/s of each), and a sampled paged cell at temperatures 0.6 to 1.5
   through the Gumbel kernel, which runs once a decode step and a prefill.
   The kernels phase holds B1, B2 and B3 (and B4 against B3) at these
   archs' shapes too and times them, and holds the Gumbel kernel at the
   sampled arch's vocabulary;
11. the MoE LMs (``--phases moe``): Qwen3-MoE-30B-A3B and Moonlight-16B-A3B
   served as the other archs are (``archs_phase``, the depth cut too),
   after two checks of
   the MoE FFN: the draw (expert tensors a layer at a time) may exceed
   the weights by at most 1.5 GB, and at one layer's full width on layer
   0's weights ``moe_ref`` in bf16 agrees with a per-token f32 formula
   (each token's top-k experts, SwiGLU in f32, the same router) and
   ``moe_local`` without drops with ``moe_ref``, within MOE_TOL; then the
   device time of a decode step's MoE FFNs.  The kernels phase holds and
   times B1, B2 and B3 at their heads, (32, 4, 128) (G = 8) and
   (16, 16, 128).

12. training (``--phases train``): Qwen2-1.5B at full width through the
   train CLI (``launch/train.main``, its defaults: f32, batch 8, seq 128,
   dense attention; its depth cut to TRAIN_CLI_LAYERS, which cuts the
   checkpoint) for 20 steps with a checkpoint at the last, some of
   whose arrays must be the trained state's bits; a second ``main``
   resumes from it (its restore checks the sha256 of every array it reads
   against the manifest's, taken from the saved arrays) and takes 2 more
   steps; the CLI's step on one repeated batch must lower the loss by 0.5
   in 10 steps (timed: median step, tokens/s, TFLOP/s from 6 N tokens,
   peak memory); the reference's train_4k config (bf16 over f32 master
   weights, remat, q_chunk 512, S 4096, bf16 gradients) with the global
   batch cut from 256 to 8 in 4 microbatches, 3 timed steps after a
   warm-up, and one microbatch's peak with remat on and off at 4 layers;
   one smoke step on the card against the CPU in f32; ``lm_loss`` through
   the cuda prefill with grad on must raise, naming B3; Wide & Deep's
   train_batch at full size (B 65,536), 5 steps, B5 twice a forward, its
   forward bit for bit against its plain version at that shape, and its
   table gradient (the ``autograd.Function``'s plain backward) against
   autograd of the plain version; Two-Tower, SASRec and BERT4Rec two steps
   each at full width, the batch cut as ``RECSYS_TRAIN_CUTS`` names.  The train
   paths launch B5 and no other kernel; its launches there join the
   kernel line's.
13. the GNN (``--phases gnn``): EquiformerV2 (12 layers, 128 channels,
   l_max 6, m_max 2, 8 heads, bf16, remat; weights from seed 0): the
   smoke config in f32 on the card against the port on the CPU (forward,
   node_class_loss, every gradient leaf) and the chunked path against the
   dense one; the train cells full_graph_sm (a random geometric graph of
   2,708 nodes and ~10,550 edges), molecule (128 graphs of 30 nodes) and
   minibatch_lg (``sample_subgraph`` of 1,024 seeds, fanouts 15-10, from a
   synthetic Reddit-sized graph with its in-degree cut to 50, its depth
   to GNN_LG_LAYERS): each forward timed, GNN_STEPS train steps on one
   repeated batch (the loss must
   fall), median step, nodes/s, edges/s, TFLOP/s from ``model_flops``,
   the bound (``model_flops`` over 989 TFLOP/s or ``bytes_floor`` over
   3.35 TB/s), peak memory, a profiled step's idle share and launches and
   its device time by op class; the chunked path at full width
   (ogb_products' d, classes and edge_chunk, two chunks, its depth cut to
   GNN_WIDE_LAYERS) against the
   dense path in f32 and both timed in bf16; ogb_products itself is not
   run (one line says why).  No kernel of the port launches on this path.
14. the dry-run's roofline against the card (``--phases cost``): 15 cells
   (Wide & Deep's four, Two-Tower, SASRec and BERT4Rec at serve_p99 and
   retrieval_cand, EquiformerV2's molecule step (COST_GNN),
   Qwen2-1.5B's prefill and fused step at the serving shapes, its prefill
   of one 4,096-token prompt through B3, and the reference's long_500k
   step, B 1 at S 524,288 through B1, B1 held against its plain version at
   the last layer and the step's logits, B1's and the dense backend's in
   bf16, each against the dense step's in f32) each traced on the meta device
   (``repro_torch.launch.dryrun``) and run on the card: counted TFLOP by
   dtype, raw and floor bytes, the bound (``launch.roofline``), the
   measured ms (its share of the bound at most COST_SHARE_MAX) and the
   device ms and their share, and the meta trace's peak beside the card's.
15. the multi-rank paths (``--phases dist``; ROADMAP A16), each world's
   ranks spawned, every rank on cuda:0, each naming its backend on its
   first line: (a) 2 gloo ranks: which collectives gloo takes on CUDA
   tensors (all four the Mesh uses must run), then long_500k (Qwen2-1.5B,
   bf16, B 1, S 524,288, T 65) through flash decode on mesh (data 2, model
   1), the KV sequence split over the ranks: the packed result equal to
   the single-device B1 step's (a differing choice only as a near tie, its
   top-two gaps printed), the logits under ``long_logits``' rule against
   the dense f32 step, ms a step a rank and the collectives' share; (b) 1
   NCCL rank: Qwen3-MoE-30B-A3B at full width, its depth cut to
   DIST_MOE_LAYERS, its prefill and decode step with ``moe_impl="ep"`` on
   mesh (data 1, model 1) bit for bit against ``moe_local`` without a
   mesh; (c) 2 gloo ranks, mesh (data 1, model 2): ``moe_ep`` at one
   layer's full width (N 132 and 512, capacity factor 1.25) against each
   token half's ``moe_local`` with all 128 experts, then the prefill and
   step at (b)'s depth with the experts split over the ranks (the dense
   weights whole: ``ep_rules``): timed at capacity factor 1.25 (its
   agreement with world 1 printed: capacity drops follow the token
   split), and at E / top_k, where nothing drops, held against world 1's
   ``moe_local`` at that factor (``moe_world_rule``: the RMS logit
   difference at most 1.25 x
   ``moe_ref``'s, packed equal up to near ties); ``_sharded_argmax`` over
   the step's logits cut into V/2 blocks equals argmax; then Qwen3-MoE
   cut to DIST_MOE_TP_LAYERS under the serve rules (heads, vocab and
   experts over ``model``, no token dropped): its gathered prefill and
   step logits within BF16_LOGIT_RATIO of the dense bf16 path's RMS error
   against the dense f32 path (``moe_ref``; ``moe_tp_rule``).  (b) also
   profiles one ep and one local step and prints the ops where ep spends
   more.  (d) 2 gloo ranks, mesh (data 1, model 2), the serve rules
   (tensor parallelism): Qwen2-1.5B at full width cut to
   DIST_TP_D_LAYERS, bf16, each rank holding its blocks of the dense
   weights (heads, FFN, vocab),
   DIST_TP_PROMPTS guided requests served twice through ``build_engine``
   inside ``sharding_ctx`` on the dense and the paged layout (the second
   pass, drafting from the first's outputs, in fewer steps), their tokens
   equal to the single-device session's; the gathered prefill and step
   logits
   within BF16_LOGIT_RATIO of the dense bf16 path's RMS error against the
   dense f32 path; B1 at the rank's heads against its plain version; the
   dense weights and the peak a rank, and the dtype the row-parallel
   partial sums are reduced in; the session itself on both layouts
   (``session_state``: a cohort prefill, DIST_STATE_STEPS guided fused
   steps whose drafts accept along a branch, one unguided step): the
   committed K and V rows below each lane's length, gathered, and the
   unguided step's logits within BF16_LOGIT_RATIO of the single-device
   session's RMS error against the f32 session (``state_rule``).  (e)
   the same on 4 gloo ranks, mesh (data
   2, model 2), ``DEFAULT_RULES`` (each layer's FSDP blocks gathered over
   ``data``, the lanes split over it on both layouts), Qwen2-1.5B cut
   to DIST_TP_E_LAYERS layers, DIST_TP_E_PROMPTS requests of DIST_TP_E_NEW
   tokens; its paged pass also prints the lanes each model forward ran a
   rank (half the engine's), checks the pools of the ranks that hold the
   same KV heads bit-equal after it (the NULL block excepted) and holds
   the collectives a rank's ``Mesh`` handed gloo for one paged fused step
   against what a ``TracedMesh`` at that rank records for the same call on
   meta tensors, to the byte by kind and group (``paged_count``).  B1 and
   B3 launch on (b) to (e), B2 on (d) and (e), on every
   rank.  (f) the train step under a mesh (``dist_train_world``): the
   train CLI (``launch/train.main``, Qwen2-1.5B at full width cut to
   TRAIN_CLI_LAYERS, f32, its batch 8 x 128) inside ``sharding_ctx`` on 4
   gloo ranks, mesh (data 2, model 2), under the train_4k rules (FSDP
   over ``data``, TP and the sequence-parallel residual over ``model``):
   TRAIN_CLI_STEPS[0] steps with a checkpoint every TRAIN_CLI_EVERY,
   then resumed on 2 ranks, mesh (data 1, model 2), to TRAIN_CLI_STEPS[1];
   the parent runs the same two CLI calls on one device (the train
   phase's, where it ran: ``one_device_cli``)
   (``dist_train_rule``: every rank's losses alike and within
   DIST_TRAIN_LOSS_RTOL of one device's, the final checkpoint's moments
   and parameters within DIST_TRAIN_MOMENT_RTOL / DIST_TRAIN_PARAM_FRAC
   of one device's, the state a rank holds equal to its ``placement``
   count to the byte); step times, the collectives' share of a timed
   step and the peak a rank are printed.  No port kernel launches
   there.  (f)'s MoE (``dist_moe_train_world``): Moonlight-16B-A3B at
   full width cut to DIST_MOE_TRAIN_LAYERS, f32, on 4 gloo ranks at (2,
   2) under the train_4k rules (``moe_ep`` on the reference's token
   groups, gathered from the residual's sequence blocks; the shared
   experts' products on those blocks), DIST_MOE_TRAIN_STEPS steps at
   capacity factor E / top_k (losses and grad norms within
   DIST_TRAIN_LOSS_RTOL of one device's ``moe_ref``, no row dropped) and
   at 1.25 (the rows dropped and the step seconds printed), the state a
   rank equal to its ``placement`` count.  (g) query heads that split off one KV head
   (``dist_heads_world``): 8 gloo ranks, mesh (data 1, model 8), the
   serve rules, Qwen2-1.5B (H 12: q gathered, every rank attends with
   all heads) then Phi-3-medium (5 heads a rank in runs on two KV
   heads), each cut to DIST_HEADS_LAYERS, (d)'s checks without the
   session state, B1, B2 and B3 held at each (query, KV) head shape of
   a rank's attention calls, once a shape (``heads_holds``).  (h) the
   recommenders placed (``dist_recsys_world``): 4 gloo ranks, mesh
   (data 2, model 2), ``DEFAULT_RULES``, W&D, Two-Tower, SASRec and
   BERT4Rec at their full configs in f32 (the tables' rows over
   ``model``: B5 over a rank's window), each arch's serve_p99 and
   retrieval_cand, W&D's serve_bulk once (gloo's share printed) and
   DIST_RECSYS_TRAIN_STEPS W&D train_batch steps; rank 0 then alone
   holds them against one device (``dist_recsys_rule``: W&D's scores and
   first loss against float64, its losses and grad norms against one
   device's, Two-Tower's looked-up rows bit for bit, its embeddings on
   rank 0's rows bit for bit against one device's on those rows, on the
   whole batch and its top-128 values within RECSYS_TOL and its indices
   equal, SASRec's and
   BERT4Rec's scores within RECSYS_TOL); B5 twice a W&D forward; one
   serve_p99 forward's gloo records equal a ``TracedMesh``'s.  The
   recsys phase also holds B5's window form (EB_WINDOW_MODELS) and runs
   SASRec's serve_bulk once.  (i) EquiformerV2 placed
   (``dist_gnn_world``): 4 gloo ranks, mesh (data 2, model 2),
   ``DEFAULT_RULES``, full_graph_sm and molecule at full width (12
   layers, bf16, remat; the gnn phase's graphs, weights from seed 0:
   each rank's edges and node block, the SO(2) and FFN weights' "tensor"
   halves), one f32 and one bf16 forward, DIST_GNN_STEPS train steps and
   the loss after them a cell, and full_graph_sm cut to
   DIST_GNN_REPEAT_LAYERS layers on a graph whose edges split over
   ``data`` alone (``gnn_repeat_cell``: the ranks along ``model`` repeat
   them); rank 0 then alone holds them against one device
   (``dist_gnn_rule``: the f32 outputs within GNN_WIDE_TOL, the bf16
   outputs' RMS error from one device's f32 at most BF16_LOGIT_RATIO times
   one device's bf16's, the losses and grad norms the same on every rank,
   within DIST_GNN_STEP_RTOL of one device's and the loss falling, the
   repeat cell's f32 outputs the same bits on every rank); one molecule
   forward's gloo records equal a ``TracedMesh``'s.  No port kernel
   launches there.  ``--gnn-controls`` runs (i) alone, then under two
   faults (``gnn_control``), and prints what its checks see of them.

The second-to-last line is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  ``--phases`` runs a subset and prints
no result line.  The script imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

try:        # the H100's data-sheet rates, one source with the roofline
    from repro_torch.launch.mesh import HBM_BW as HBM_BYTES_PER_S
    from repro_torch.launch.mesh import PEAK_FLOPS
except ImportError:     # main() says the port is missing and exits non-zero
    HBM_BYTES_PER_S, PEAK_FLOPS = None, {}
# Kernel vs plain version.  Both sum in f32 and round once to the output
# dtype, so in bf16 they differ by at most about one output ulp (2^-7 of the
# value, relative): rtol 1.6e-2 is two of them, and atol 1e-4 covers the f32
# sum-order noise near zero.  Typical |out| at the tested shapes is 1e-2 to
# 4e-2, so an error of a few percent of the output fails.
TOL = {torch.float32: dict(atol=3e-5, rtol=1e-4),   # order of f32 sums
       torch.bfloat16: dict(atol=1e-4, rtol=1.6e-2)}
PATH_TREE = (4, 33, 12, 2, 128, 512)   # (B, T, H, K, dh, S) of fused_step
PATH_PREFILL = [(4, 128, 12, 2, 128), (1, 128, 12, 2, 128)]  # (B,S,H,K,dh)
# (B, T, H, K, dh, bs, bpl) of the paged fused_step: a 33-block pool
PATH_PAGED = (4, 33, 12, 2, 128, 64, 8)
# the reference's other dense LMs, served at full width by the archs phase
OTHER_ARCHS = ("antglm-10b", "phi3-mini-3.8b", "phi3-medium-14b")
# the archs and moe phases serve each arch at full width with its depth cut
# to an eighth, which leaves the dist phase's worlds the script's time
ARCH_DEPTH_DIV = 16      # a sixteenth: cut from an eighth for (h)'s time
# its MoE LMs, served at full width by the moe phase
MOE_ARCHS = ("qwen3-moe-30b-a3b", "moonshot-v1-16b-a3b")
# moe_ref in bf16 at one layer's full width against a per-token f32
# formula: bf16 rounds the expert products g and u, h, each expert's
# output, the combine weights and the output (2^-9 relative each); at
# mean |out| 0.08-0.13 (max 0.5-1.0) that leaves errors up to ~5e-3 at
# the largest outputs (one output ulp), while a wrong expert or weight
# moves an output by ~2e-2.  The same limit holds moe_local (capacity
# blocks, a bf16 combine) to moe_ref.
MOE_TOL = dict(atol=4e-3, rtol=1.6e-2)
MOE_DRAW_OVER = 1.5e9   # the draw's peak over the weights: the largest
                        # tensor drawn whole in f32 (the untied head,
                        # 1.24-1.34 GB), not the (L, E, ...) experts
SUFFIX_BUCKETS = (8, 16, 32, 64, 128)  # the suffix prefill's T (B = 1)
# the long-prompt cell: 2 lanes, prompts of ~4,000 tokens (a RAG service's
# retrieved context), a dense cache of 4,224 rows (0.24 GB at full width)
LONG_LANES, LONG_REQUESTS, LONG_PROMPT = 2, 2, 4000
LONG_PREFILL, LONG_MAX_SEQ = 4096, 4224
# (B, S, H, K, dh) of B3 in that cell's prefill, at Qwen2-1.5B's heads
LONG_ATTN = (LONG_LANES, LONG_PREFILL, 12, 2, 128)
SHARED_HEAD, SHARED_TAIL, N_SHARED = 80, 16, 16   # shared-prefix workload
BF16_LOGIT_RATIO = 1.25                # cuda vs dense, each against f32
N_LAYERS = 28                          # timing rotates over 28 layer caches
N_REQUESTS, MAX_NEW = 8, 48
# B4 (the triangular-schedule prefill): the cohort prefill, a long prompt at
# Qwen2-1.5B's heads, and the shapes of tests/test_kernels.py:131-133
PATH_TRI = [(4, 128, 12, 2, 128), (1, 4096, 12, 2, 128)]
TEST_TRI = [(1, 256, 4, 2, 64), (2, 512, 4, 4, 128), (1, 384, 6, 2, 96)]
# the Gumbel-argmax kernel at the fused step's token choice
GUMBEL_SHAPE = (4, 33, 151936)
SAMPLED_ARCHS = ("antglm-10b",)        # the archs phase's sampled cells
# its bound counts issue slots: the SASS instructions of gumbel_partial's
# loop per drawn entry (threefry2x32's integer adds, rotates and xors, the
# uniform, two logf, the IEEE division, the compare), read from the built
# library, over what the SMs issue: 4 warp instructions (128 lanes) a
# clock on each SM, at the SM clock nvidia-smi reports as its maximum.
# That is an issue-rate bound of the kernel's current SASS; beside it, the
# lane operations the function itself needs per drawn entry, counted from
# its definition (csrc/gumbel_argmax.cu::draw and libdevice's logf):
GUMBEL_OPS_NEEDED = {
    "threefry2x32": 2 + 20 * 3 + 5 * 2,  # key adds, 20 add/rotate/xor
                                         # rounds, 5 key injections
    "uniform": 4,                        # xor of the words, shift, or, -1
    "two logf": 2 * 23,                  # range reduction, 10 FMAs, the
                                         # special-case checks, each
    "ieee division": 8,                  # check, reciprocal, 4 FMAs, fixup
    "load, add, compare": 6,             # bf16 to f32, + g, max with index
}
LANES_PER_SM_CLOCK = 128
GUMBEL_GAP = 1e-5                      # token agreement below this gap of z+g
GUMBEL_ATOL = 2e-6                     # Gumbel values: two logf calls
SAMPLED_TEMP = 0.8
N_SHARED_SAMPLED, MAX_NEW_SHARED_SAMPLED = 8, 24  # sampled prefix-cache hits
# B5 (the fused EmbeddingBag): the shapes of tests/test_kernels.py:66-67
EB_SWEEP = [(100, 128, 16, 4), (500, 256, 8, 7), (64, 128, 32, 3),
            (1000, 128, 4, 1)]
# recsys scores (f32, TF32 off) against the same function in float64: f32
# rounding of sums of up to 1,293 products and of the softmax, far below
RECSYS_TOL = dict(rtol=1e-4, atol=1e-5)
RECSYS_BULK_CHECK_ROWS = 16384         # serve_bulk rows held against float64
N_ID_SETS = 8     # serve_p99 timing rotates over 8 input sets: 84 MB of
                  # Wide & Deep rows, more than the 50 MB L2


class SmokeError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeError(what)


# ------------------------------------------------------------------ inputs
def randn(gen, shape, dtype, scale=0.3):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(dtype)


def tree_mask_tests(B, T, S, kind):
    """The masks of tests/test_kernels.py: prefix + tril block ("sweep") or
    random with key 0 always visible ("random")."""
    rng = np.random.RandomState(B * 1000 + T * 10 + S)
    if kind == "random":
        mask = rng.rand(B, T, S) > 0.4
        mask[:, :, 0] = True
        return torch.from_numpy(mask).cuda()
    mask = np.zeros((B, T, S), bool)
    lens = rng.randint(S // 4, S // 2, size=(B,))
    for b in range(B):
        mask[b, :, :lens[b]] = True
        mask[b, :, lens[b]:lens[b] + T] = np.tril(np.ones((T, T), bool))
    return torch.from_numpy(mask).cuda()


def shuffled_tables(n_used, bpl, seed=0):
    """(B, bpl) int32 tables: lane b's first n_used[b] logical blocks on
    distinct physical blocks 1.. in a shuffled order, the rest of its table
    NULL (block 0)."""
    rng = np.random.RandomState(seed)
    ids = rng.permutation(np.arange(1, 1 + sum(n_used)))
    bt = np.zeros((len(n_used), bpl), np.int32)
    for b, n in enumerate(n_used):
        bt[b, :n], ids = ids[:n], ids[n:]
    return torch.from_numpy(bt).cuda()


def paged_case(gen, B, T, H, K, dh, bs, bpl, dtype, mask, n_used=None,
               seed=0):
    """q, a pool of 1 + sum(n_used) blocks, tables and ``mask`` for B2;
    every lane's blocks allocated by default."""
    n_used = n_used or [bpl] * B
    nb = 1 + sum(n_used)
    return (randn(gen, (B, T, H, dh), dtype),
            randn(gen, (nb, bs, K, dh), dtype),
            randn(gen, (nb, bs, K, dh), dtype),
            shuffled_tables(n_used, bpl, seed), mask)


def suffix_mask(T, offset, S):
    """The suffix prefill's (1, T, S) mask: the cached prefix plus causal
    within the suffix."""
    from repro_torch.models.attention import build_full_tree_mask
    tril = torch.ones((1, T, T), dtype=torch.bool, device="cuda").tril()
    return build_full_tree_mask(
        torch.tensor([offset], device="cuda"), tril, S)


def paged_kernel_cases(gen, dtype):
    """(label, q, k_pool, v_pool, tables, mask) of every B2 case: the
    decode path (fully allocated, and with NULL tails), every suffix bucket
    at the shared-prefix offset, and the shapes of tests/test_paged_cache.py
    (dh 8/16, blocks of 8 to 32 rows, NULL entries, blocks out of order)."""
    from repro_torch.kernels.timing import path_mask
    B, T, H, K, dh, bs, bpl = PATH_PAGED
    S = bs * bpl
    mask = path_mask(B, T, S, max_new=MAX_NEW)
    yield ("decode", *paged_case(gen, B, T, H, K, dh, bs, bpl, dtype, mask))
    last = (torch.arange(S, device="cuda") * mask).amax(dim=(1, 2))
    n_used = [int(x) // bs + 1 for x in last.tolist()]
    yield ("decode, NULL tails", *paged_case(gen, B, T, H, K, dh, bs, bpl,
                                             dtype, mask, n_used, seed=1))
    for Tb in SUFFIX_BUCKETS:
        m = suffix_mask(Tb, SHARED_HEAD, S)
        n = -(-(SHARED_HEAD + Tb) // bs)
        yield (f"suffix T={Tb}", *paged_case(gen, 1, Tb, H, K, dh, bs, bpl,
                                             dtype, m, [n], seed=Tb))
    rng = np.random.RandomState(0)
    for dh_, bs_ in [(8, 16), (16, 8), (8, 32)]:
        B_, T_, H_, K_, nb, bpl_ = 3, 5, 4, 2, 9, 4
        lens = torch.tensor([bs_ + 3, 2 * bs_ + 1, 4], device="cuda")
        tree = np.zeros((B_, T_, T_), bool)
        for b in range(B_):
            tree[b] = np.tril(rng.rand(T_, T_) < 0.7) | np.eye(T_, dtype=bool)
        from repro_torch.models.attention import build_full_tree_mask
        m = build_full_tree_mask(lens, torch.from_numpy(tree).cuda(),
                                 bpl_ * bs_)
        bt = torch.tensor([[6, 2, 3, 0], [4, 1, 8, 7], [5, 0, 0, 0]],
                          dtype=torch.int32, device="cuda")
        yield (f"tests/test_paged_cache.py dh={dh_} bs={bs_}",
               randn(gen, (B_, T_, H_, dh_), dtype),
               randn(gen, (nb, bs_, K_, dh_), dtype),
               randn(gen, (nb, bs_, K_, dh_), dtype), bt, m)


def tree_map(fn, tree):
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v)
            for k, v in tree.items()}


def tree_leaves(tree):
    for v in tree.values():
        yield from (tree_leaves(v) if isinstance(v, dict) else (v,))


# ----------------------------------------------------------------- timing
def time_ms(fn, iters=40, warmup=5) -> float:
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def distinct_sectors(table: torch.Tensor, rows: torch.Tensor) -> int:
    """How many distinct 32-byte sectors of ``table``'s storage hold the
    rows ``rows`` (sorted distinct indices of its flattened rows): each
    row's span of sectors, less what it shares with the row before it (the
    spans come in address order, so a sector is shared only with that
    one)."""
    row_bytes = table.shape[-1] * table.element_size()
    start = table.data_ptr() + rows.long() * row_bytes
    first, last = start // 32, (start + row_bytes - 1) // 32
    shared = (last[:-1] - first[1:] + 1).clamp_min(0)
    return int((last - first + 1).sum().item() - shared.sum().item())


# --------------------------------------------------------------- phase 2
ATTN_LIBS = ("tree_attention", "paged_tree_attention", "flash_prefill",
             "flash_prefill_tri")


def ptxas_report(log: str) -> dict:
    """{kernel: (registers, spill store bytes, spill load bytes)} from an
    nvcc -Xptxas -v log."""
    out, cur, spills = {}, None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur, spills = m.group(1), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur] = (int(m.group(1)), *spills)
    return out


def attn_label(mangled: str) -> tuple:
    """('bf16 ND', 8) / ('bf16 ND seq', 8) / ('f32 NC', 4) for an attention
    kernel's mangled name: its arithmetic (and, for the causal bf16 kernel
    of its own, that its key groups run in sequence, at ND 8) and its dh
    template argument."""
    m = re.search(r"mma_attention_kernelILi(\d+)E", mangled)
    if m:
        return "bf16 ND", int(m.group(1))
    if re.search(r"prefill_kernelILb[01]E", mangled):
        return "bf16 ND seq", 8
    m = re.search(r"attention_kernelIfLi(\d+)E", mangled)
    return ("f32 NC", int(m.group(1))) if m else (mangled[:60], 0)


def sass_phase(_build):
    """Registers and spills of every attention kernel from ptxas, and the
    SASS of the bf16 attention kernels (B1-B4): every instantiation must
    hold tensor-core products (HMMA or HGMMA) and asynchronous copies
    (LDGSTS or UTMALDG), and spill nothing; then B5's registers, no
    spills."""
    sass = sass_functions(*(_build.library_path(n) for n in ATTN_LIBS))
    for name, funcs in zip(ATTN_LIBS, sass):
        lib = _build.library_path(name)
        report = ptxas_report(lib.with_suffix(".log").read_text())
        check(bool(report), f"{name}: no ptxas report in the build log")
        line = ", ".join(
            "%s=%d %d regs" % (*attn_label(k), r)
            + (f" SPILL {st}/{ld} B" if st or ld else "")
            for k, (r, st, ld) in sorted(report.items(),
                                         key=lambda kv: attn_label(kv[0])))
        print(f"  [{name}] {line}")
        mma = {k: v for k, v in report.items() if attn_label(k)[0]
               .startswith("bf16")}
        check(bool(mma) and all(st == ld == 0 for _, st, ld in mma.values()),
              f"{name}: bf16 kernels missing or spilling: {mma}")
        bf16 = {fn: body for fn, body in funcs.items()
                if attn_label(fn)[0].startswith("bf16")}
        check(len(bf16) == len(mma), f"{name}: {len(bf16)} bf16 kernels in "
                                     f"the SASS, {len(mma)} in ptxas's log")
        for fn, body in bf16.items():
            n_mma = len(re.findall(r"\b(?:HMMA|HGMMA)\b", body))
            n_cp = len(re.findall(r"\b(?:LDGSTS|UTMALDG)\b", body))
            check(n_mma > 0 and n_cp > 0,
                  f"{name} {attn_label(fn)}: {n_mma} tensor-core and {n_cp} "
                  "asynchronous-copy instructions in its SASS")
        ops = {op: re.compile(r"\b%s\b" % op)
               for op in ("HMMA", "HGMMA", "LDGSTS", "UTMALDG")}
        at128 = "; ".join(
            f"{attn_label(f)[0]}: " + ", ".join(
                f"{len(pat.findall(body))} {op}" for op, pat in ops.items())
            for f, body in sorted(bf16.items()) if attn_label(f)[1] == 8)
        print(f"  [{name}] SASS: all {len(bf16)} bf16 kernels hold "
              f"HMMA/HGMMA and LDGSTS/UTMALDG (dh 128: {at128}); no "
              "spills")
    b5_build_report(_build)


def sass_functions(*libs) -> list:
    """[{mangled name: SASS text}] of built libraries (cuobjdump -sass, one
    process a library, all started together)."""
    from repro_torch.kernels import _build
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    procs = [subprocess.Popen([cuobjdump, "-sass", str(lib)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for lib in libs]
    out = []
    for lib, proc in zip(libs, procs):
        sass, err = proc.communicate()
        if proc.returncode:
            raise subprocess.CalledProcessError(proc.returncode, cuobjdump,
                                                sass, err)
        funcs = {}
        for part in sass.split("Function : ")[1:]:
            fn, _, body = part.partition("\n")
            funcs[fn.strip()] = body
        out.append(funcs)
    return out


def loop_per_load(body: str) -> tuple:
    """(instructions, global loads) of the loop in a function's SASS that
    holds the most global loads (a loop is the span from a backward
    branch's target to the branch; NOPs left out): with one load an entry,
    instructions / loads is what the loop issues per entry."""
    ins = [(int(m.group(1), 16), m.group(2)) for m in re.finditer(
        r"/\*([0-9a-f]{4,})\*/\s+([^;]*?)\s*;", body)]
    best = (0, 0)
    for addr, text in ins:
        m = re.search(r"\bBRA\b[^;]*?0x([0-9a-f]+)", text)
        if not m or int(m.group(1), 16) > addr:
            continue
        span = [t for a, t in ins if int(m.group(1), 16) <= a <= addr
                and not t.startswith("NOP")]
        loads = sum(1 for t in span if re.search(r"\bLDG\b", t))
        if loads > best[1] or (loads == best[1] and len(span) < best[0]):
            best = (len(span), loads)
    return best


def b5_label(mangled: str) -> str:
    """'f32 x4 L4' for B5's mangled name: dtype, elements a lane slice
    holds, and whether the bag size is 4 (vector slot loads) or any."""
    m = re.search(r"embedding_bag_kernelI(f|13__nv_bfloat16)Li(\d+)ELb([01])E",
                  mangled)
    if not m:
        return mangled[:60]
    return (f"{'f32' if m.group(1) == 'f' else 'bf16'} x{m.group(2)} "
            f"{'L4' if m.group(3) == '1' else 'any L'}")


def b5_build_report(_build):
    """B5's instantiations from ptxas: registers, no spills."""
    report = ptxas_report(_build.library_path("embedding_bag")
                          .with_suffix(".log").read_text())
    check(len(report) == 8 and all(st == ld == 0
                                   for _, st, ld in report.values()),
          f"embedding_bag: 8 spill-free instantiations expected: {report}")
    print("  [embedding_bag] " + ", ".join(
        f"{b5_label(k)} {r} regs" for k, (r, _, _) in sorted(
            report.items(), key=lambda kv: b5_label(kv[0]))) + "; no spills")


# --------------------------------------------------------------- phase 3
def arch_kernel_shapes():
    """arch -> the (B1, B2, B3) shapes its serving path gives the kernels:
    its heads at the main path's lanes, tree width, cache length, blocks
    and prompt pad length."""
    from repro_torch.configs import get_arch
    B, T, _, _, _, S = PATH_TREE
    shapes = {}
    for name in OTHER_ARCHS + MOE_ARCHS:
        cfg = get_arch(name).full_config()
        heads = (cfg.n_heads, cfg.n_kv_heads, cfg.dh)
        shapes[name] = ((B, T, *heads, S), (B, T, *heads, *PATH_PAGED[5:]),
                        (*PATH_PREFILL[0][:2], *heads))
    return shapes


def kernel_phase(gen):
    from repro_torch.kernels.timing import path_mask
    from repro_torch.kernels.flash_prefill.ops import (flash_prefill,
                                                       flash_prefill_ref)
    from repro_torch.kernels.tree_attention.ops import (
        tree_attention, tree_attention_reference)
    from repro_torch.kernels.tree_attention.paged import (
        paged_tree_attention, paged_tree_attention_reference)
    from repro_torch.kernels.tree_attention.ref import paged_gather

    errs = {"tree_attention": 0.0, "flash_prefill": 0.0,
            "paged_tree_attention": 0.0}
    arch_errs = {kern: {} for kern in errs}
    tree_cases = ([(PATH_TREE, "path")]
                  + [(s, "sweep") for s in [
                      (1, 1, 4, 4, 64, 128), (2, 5, 8, 4, 64, 256),
                      (1, 9, 4, 1, 96, 512), (2, 65, 12, 2, 128, 1024),
                      (1, 33, 16, 16, 128, 384)]]
                  + [(s, "random") for s in [
                      (2, 5, 4, 2, 64, 320), (1, 9, 4, 4, 96, 200),
                      (2, 7, 8, 2, 64, 640), (2, 7, 4, 2, 64, 256)]])
    for dtype in (torch.float32, torch.bfloat16):
        for (B, T, H, K, dh, S), kind in tree_cases:
            q = randn(gen, (B, T, H, dh), dtype)
            k = randn(gen, (B, S, K, dh), dtype)
            v = randn(gen, (B, S, K, dh), dtype)
            mask = (path_mask(B, T, S, max_new=MAX_NEW) if kind == "path"
                    else tree_mask_tests(B, T, S, kind))
            out = tree_attention(q, k, v, mask)
            torch.cuda.synchronize()
            e = hold("tree_attention", out,
                     tree_attention_reference(q, k, v, mask), dtype,
                     (B, T, H, K, dh, S))
            if kind == "path" and dtype == torch.bfloat16:
                errs["tree_attention"] = e
        for (B, S, H, K, dh) in PATH_PREFILL + [
                LONG_ATTN, (2, 256, 4, 2, 64), (1, 512, 8, 8, 96),
                (2, 256, 6, 2, 128), (1, 128, 2, 1, 80), (2, 320, 4, 2, 64),
                (1, 300, 6, 3, 80), (1, 256, 4, 2, 64), (2, 512, 4, 4, 128),
                (1, 384, 6, 2, 96)]:
            q = randn(gen, (B, S, H, dh), dtype)
            k = randn(gen, (B, S, K, dh), dtype)
            v = randn(gen, (B, S, K, dh), dtype)
            out = flash_prefill(q, k, v)
            torch.cuda.synchronize()
            e = hold("flash_prefill", out, flash_prefill_ref(q, k, v), dtype,
                     (B, S, H, K, dh))
            if (B, S, H, K, dh) == PATH_PREFILL[0] and dtype == torch.bfloat16:
                errs["flash_prefill"] = e
        # B2 against its plain version, then against B1 on the same logical
        # K/V (each lane's blocks gathered into a dense cache): bit for bit
        n_bits = 0
        for label, q, k, v, bt, mask in paged_kernel_cases(gen, dtype):
            out = paged_tree_attention(q, k, v, bt, mask)
            torch.cuda.synchronize()
            e = hold("paged_tree_attention", out,
                     paged_tree_attention_reference(q, k, v, bt, mask), dtype,
                     f"{label} q{tuple(q.shape)} pool{tuple(k.shape)} "
                     f"tables{tuple(bt.shape)}")
            if label == "decode" and dtype == torch.bfloat16:
                errs["paged_tree_attention"] = e
            if q.shape[-1] >= 16:
                dense = tree_attention(q, paged_gather(k, bt).contiguous(),
                                       paged_gather(v, bt).contiguous(), mask)
                check(torch.equal(out, dense),
                      f"paged_tree_attention {label} {dtype}: not bit-equal "
                      "to tree_attention on the same logical K/V")
                n_bits += 1
        print(f"  paged_tree_attention {str(dtype)[6:]}: bit-equal to "
              f"tree_attention on the same logical K/V in {n_bits} cases")
        # each other arch's heads on the path: B1 on a serving-like mask,
        # B2 on a shuffled pool (and bit for bit against B1), B3 causal
        for name, (tree, paged, prefill) in arch_kernel_shapes().items():
            B, T, H, K, dh, S = tree
            q, k, v = (randn(gen, shp, dtype) for shp in
                       ((B, T, H, dh), (B, S, K, dh), (B, S, K, dh)))
            mask = path_mask(B, T, S, max_new=MAX_NEW)
            e1 = hold("tree_attention", tree_attention(q, k, v, mask),
                      tree_attention_reference(q, k, v, mask), dtype,
                      f"{name} {tree}")
            B, T, H, K, dh, bs, bpl = paged
            q, kp, vp, bt, mask = paged_case(gen, B, T, H, K, dh, bs, bpl,
                                             dtype, mask)
            out = paged_tree_attention(q, kp, vp, bt, mask)
            e2 = hold("paged_tree_attention", out,
                      paged_tree_attention_reference(q, kp, vp, bt, mask),
                      dtype, f"{name} {paged}")
            check(torch.equal(out, tree_attention(
                q, paged_gather(kp, bt).contiguous(),
                paged_gather(vp, bt).contiguous(), mask)),
                f"paged_tree_attention {name} {dtype}: not bit-equal to "
                "tree_attention on the same logical K/V")
            B, S, H, K, dh = prefill
            q, k, v = (randn(gen, shp, dtype) for shp in
                       ((B, S, H, dh), (B, S, K, dh), (B, S, K, dh)))
            e3 = hold("flash_prefill", flash_prefill(q, k, v),
                      flash_prefill_ref(q, k, v), dtype, f"{name} {prefill}")
            if dtype == torch.bfloat16:
                for kern, e in (("tree_attention", e1),
                                ("paged_tree_attention", e2),
                                ("flash_prefill", e3)):
                    arch_errs[kern][name] = e

    # ---- timing at the path's shapes in bf16, each call on one of 28
    # layer-sized caches (more K/V than L2 holds, as the decode layers see
    # it): Qwen2-1.5B's, then each other arch's
    rows = {"tree_attention": time_tree(gen, PATH_TREE),
            "paged_tree_attention": time_paged(gen, PATH_PAGED),
            "flash_prefill": time_prefill(gen, PATH_PREFILL[0])}
    for name, (tree, paged, prefill) in arch_kernel_shapes().items():
        for kern, row in (("tree_attention", time_tree(gen, tree)),
                          ("paged_tree_attention", time_paged(gen, paged)),
                          ("flash_prefill", time_prefill(gen, prefill))):
            rows[kern].setdefault("archs", {})[name] = dict(
                row, max_abs_err=arch_errs[kern][name])
    return errs, rows


def time_tree(gen, shape):
    """B1 in bf16 at ``shape`` (B, T, H, K, dh, S) on a serving-like mask,
    beside its plain version and sdpa (event and device time), and its
    bound; the row of the kernel table."""
    from repro_torch.kernels.timing import device_ms, path_mask
    from repro_torch.kernels.tree_attention.ops import (
        tree_attention, tree_attention_reference)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt, L = torch.bfloat16, N_LAYERS
    B, T, H, K, dh, S = shape
    q = randn(gen, (L, B, T, H, dh), dt)
    kc = randn(gen, (L, B, S, K, dh), dt)
    vc = randn(gen, (L, B, S, K, dh), dt)
    mask = path_mask(B, T, S, seed=1, max_new=MAX_NEW)
    ms = time_ms(lambda i: tree_attention(q[i % L], kc[i % L], vc[i % L],
                                          mask))
    plain = time_ms(lambda i: tree_attention_reference(
        q[i % L], kc[i % L], vc[i % L], mask), iters=10)
    m4 = mask[:, None]

    def b1_lib(i):
        return sdpa(q[i % L].transpose(1, 2), kc[i % L].transpose(1, 2),
                    vc[i % L].transpose(1, 2), attn_mask=m4, enable_gqa=True)

    lib = time_ms(b1_lib)
    dev = device_ms(lambda i: tree_attention(q[i % L], kc[i % L], vc[i % L],
                                             mask), L)
    lib_dev = device_ms(b1_lib, L)
    # what this mask needs: each lane's K/V rows up to its last visible key,
    # q and the output, the mask; products over the visible (t, s) pairs
    last = torch.arange(S, device="cuda")[None, None] * mask
    n_keys = (last.amax(dim=(1, 2)) + 1).sum().item()
    es = 2
    nbytes = (2 * q[0].numel() * es + mask.numel()
              + 2 * n_keys * K * dh * es)
    flops = 4.0 * mask.sum().item() * H * dh
    b_ms, b_by = bound(nbytes, flops, dt)
    print(f"  tree_attention bf16 {shape}: kernel {ms:.4f} ms, plain "
          f"{plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}: {nbytes/1e6:.3f} MB, {flops/1e9:.3f} GFLOP); device "
          f"time: kernel {dev:.4f} ms, sdpa {lib_dev:.4f} ms")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, device_ms=dev, library_device_ms=lib_dev)


def time_paged(gen, shape):
    """B2 in bf16 at ``shape`` (B, T, H, K, dh, bs, bpl), every lane's
    blocks allocated in a shuffled pool, beside its plain version, the
    library's nearest (a gather of each lane's blocks, then sdpa: no one
    PyTorch call reads paged K/V) and B1 on the gathered caches."""
    from repro_torch.kernels.timing import device_ms, path_mask
    from repro_torch.kernels.tree_attention.ops import tree_attention
    from repro_torch.kernels.tree_attention.paged import (
        paged_tree_attention, paged_tree_attention_reference)
    from repro_torch.kernels.tree_attention.ref import paged_gather
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt, L = torch.bfloat16, N_LAYERS
    B, T, H, K, dh, bs, bpl = shape
    S = bs * bpl
    mask = path_mask(B, T, S, seed=1, max_new=MAX_NEW)
    bt = shuffled_tables([bpl] * B, bpl, seed=2)
    nb = 1 + B * bpl
    q = randn(gen, (L, B, T, H, dh), dt)
    kp = randn(gen, (L, nb, bs, K, dh), dt)
    vp = randn(gen, (L, nb, bs, K, dh), dt)
    ms = time_ms(lambda i: paged_tree_attention(q[i % L], kp[i % L],
                                                vp[i % L], bt, mask))
    plain = time_ms(lambda i: paged_tree_attention_reference(
        q[i % L], kp[i % L], vp[i % L], bt, mask), iters=10)
    m4 = mask[:, None]

    def b2_lib(i):
        return sdpa(q[i % L].transpose(1, 2),
                    paged_gather(kp[i % L], bt).transpose(1, 2),
                    paged_gather(vp[i % L], bt).transpose(1, 2),
                    attn_mask=m4, enable_gqa=True)

    gather_sdpa = time_ms(b2_lib)
    dev = device_ms(lambda i: paged_tree_attention(q[i % L], kp[i % L],
                                                   vp[i % L], bt, mask), L)
    lib_dev = device_ms(b2_lib, L)
    kd = torch.stack([paged_gather(kp[i], bt) for i in range(L)])
    vd = torch.stack([paged_gather(vp[i], bt) for i in range(L)])
    dense_ms = time_ms(lambda i: tree_attention(q[i % L], kd[i % L],
                                                vd[i % L], mask))
    del kd, vd
    last = torch.arange(S, device="cuda")[None, None] * mask
    n_keys = (last.amax(dim=(1, 2)) + 1).sum().item()
    es = 2
    nbytes = (2 * q[0].numel() * es + mask.numel() + bt.numel() * 4
              + 2 * n_keys * K * dh * es)
    flops = 4.0 * mask.sum().item() * H * dh
    b_ms, b_by = bound(nbytes, flops, dt)
    print(f"  paged_tree_attention bf16 {shape}: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, gather+sdpa (3 calls: two gathers, one "
          f"sdpa) {gather_sdpa:.4f} ms, tree_attention on the gathered "
          f"caches {dense_ms:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
          f"{nbytes/1e6:.3f} MB, {flops/1e9:.3f} GFLOP); device time: "
          f"kernel {dev:.4f} ms, gather+sdpa {lib_dev:.4f} ms")
    return dict(ms=ms, plain_ms=plain, library_ms=None, bound_ms=b_ms,
                bound_by=b_by, device_ms=dev, library_device_ms=lib_dev,
                gather_sdpa_ms=gather_sdpa, tree_attention_ms=dense_ms)


def time_prefill(gen, shape):
    """B3 in bf16 at ``shape`` (B, S, H, K, dh), causal, beside its plain
    version and sdpa, and its bound."""
    from repro_torch.kernels.timing import device_ms
    from repro_torch.kernels.flash_prefill.ops import (flash_prefill,
                                                       flash_prefill_ref)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    dt, L = torch.bfloat16, N_LAYERS
    B, S, H, K, dh = shape
    q = randn(gen, (L, B, S, H, dh), dt)
    k = randn(gen, (L, B, S, K, dh), dt)
    v = randn(gen, (L, B, S, K, dh), dt)
    ms = time_ms(lambda i: flash_prefill(q[i % L], k[i % L], v[i % L]))
    plain = time_ms(lambda i: flash_prefill_ref(q[i % L], k[i % L],
                                                v[i % L]), iters=10)

    def b3_lib(i):
        return sdpa(q[i % L].transpose(1, 2), k[i % L].transpose(1, 2),
                    v[i % L].transpose(1, 2), is_causal=True, enable_gqa=True)

    lib = time_ms(b3_lib)
    dev = device_ms(lambda i: flash_prefill(q[i % L], k[i % L], v[i % L]), L)
    lib_dev = device_ms(b3_lib, L)
    nbytes = (2 * q[0].numel() + 2 * k[0].numel()) * 2
    flops = 4.0 * B * H * dh * S * (S + 1) / 2
    b_ms, b_by = bound(nbytes, flops, dt)
    print(f"  flash_prefill bf16 {shape}: kernel {ms:.4f} ms, "
          f"plain {plain:.4f} ms, sdpa {lib:.4f} ms, bound {b_ms:.5f} ms "
          f"({b_by}: {nbytes/1e6:.3f} MB, {flops/1e9:.3f} GFLOP); device "
          f"time: kernel {dev:.4f} ms, sdpa {lib_dev:.4f} ms")
    return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                bound_by=b_by, device_ms=dev, library_device_ms=lib_dev)


def hold(name, out, ref, dtype, shape):
    """Check a kernel's output against its plain version within TOL."""
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    ok = torch.allclose(out.float(), ref.float(), **TOL[dtype])
    typ = ref.float().abs().mean().item()
    print(f"  {name} {str(dtype)[6:]:8s} {shape}: max|err| {err:.3e} "
          f"mean|ref| {typ:.3e} {'ok' if ok else 'FAIL'} ({TOL[dtype]})")
    check(ok, f"{name} disagrees with its plain version at {shape} "
              f"{dtype}: max abs err {err}")
    return err


def tri_phase(gen):
    """B4, the triangular-schedule prefill behind flash_prefill(...,
    triangular=True): against its plain version and bit for bit against B3
    at every listed shape in f32 and bf16; then the op's own path (one call
    per shape, counted); then timed in bf16 beside B3, the plain version and
    scaled_dot_product_attention at both path shapes."""
    import repro_torch.kernels.flash_prefill as fp_pkg
    from repro_torch.kernels.timing import device_ms
    from repro_torch.kernels.flash_prefill.ops import (flash_prefill,
                                                       flash_prefill_ref)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    err = 0.0
    cases = (PATH_TRI + [LONG_ATTN] + TEST_TRI
             + [p for _, _, p in arch_kernel_shapes().values()])
    for dtype in (torch.float32, torch.bfloat16):
        for (B, S, H, K, dh) in cases:
            q = randn(gen, (B, S, H, dh), dtype)
            k = randn(gen, (B, S, K, dh), dtype)
            v = randn(gen, (B, S, K, dh), dtype)
            out = flash_prefill(q, k, v, triangular=True)
            e = hold("flash_prefill_tri", out, flash_prefill_ref(q, k, v),
                     dtype, (B, S, H, K, dh))
            if (B, S, H, K, dh) == PATH_TRI[0] and dtype == torch.bfloat16:
                err = e
            check(torch.equal(out, flash_prefill(q, k, v)),
                  f"flash_prefill_tri {(B, S, H, K, dh)} {dtype}: not "
                  "bit-equal to flash_prefill")
    print(f"  flash_prefill_tri: bit-equal to flash_prefill at all "
          f"{2 * len(cases)} cases")

    # the op's own path: the entry point a user calls, once per shape
    ins = [tuple(randn(gen, shp, torch.bfloat16) for shp in
                 ((B, S, H, dh), (B, S, K, dh), (B, S, K, dh)))
           for (B, S, H, K, dh) in PATH_TRI + TEST_TRI]
    torch.cuda.synchronize()
    flash_prefill.tri_launches = 0
    outs = [fp_pkg.flash_prefill(*x, triangular=True) for x in ins]
    torch.cuda.synchronize()
    launches = flash_prefill.tri_launches
    check(launches == len(ins) and all(bool(torch.isfinite(o).all())
                                       for o in outs),
          f"flash_prefill(..., triangular=True) path: {launches} launches")
    del ins, outs

    dt = torch.bfloat16
    rows = []
    for (B, S, H, K, dh), n_buf in zip(PATH_TRI, (N_LAYERS, 8)):
        q = randn(gen, (n_buf, B, S, H, dh), dt)
        k = randn(gen, (n_buf, B, S, K, dh), dt)
        v = randn(gen, (n_buf, B, S, K, dh), dt)
        L = n_buf
        # in turns (B3, B4, B4, B3): the two differ in schedule only
        turns = {False: [], True: []}
        for tri in (False, True, True, False):
            turns[tri].append(time_ms(lambda i: flash_prefill(
                q[i % L], k[i % L], v[i % L], triangular=tri)))
        ms, b3 = (float(np.mean(turns[t])) for t in (True, False))
        plain = time_ms(lambda i: flash_prefill_ref(q[i % L], k[i % L],
                                                    v[i % L]),
                        iters=5 if S > 1024 else 10, warmup=2)

        def lib_fn(i):
            return sdpa(q[i % L].transpose(1, 2), k[i % L].transpose(1, 2),
                        v[i % L].transpose(1, 2), is_causal=True,
                        enable_gqa=True)

        lib = time_ms(lib_fn)
        dev = {tri: device_ms(lambda i: flash_prefill(
            q[i % L], k[i % L], v[i % L], triangular=tri), L)
            for tri in (True, False)}
        lib_dev = device_ms(lib_fn, L)
        nbytes = (2 * q[0].numel() + 2 * k[0].numel()) * 2
        flops = 4.0 * B * H * dh * S * (S + 1) / 2
        b_ms, b_by = bound(nbytes, flops, dt)
        rows.append(dict(shape=[B, S, H, K, dh], ms=ms, flash_prefill_ms=b3,
                         plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                         bound_by=b_by, device_ms=dev[True],
                         flash_prefill_device_ms=dev[False],
                         library_device_ms=lib_dev))
        print(f"  flash_prefill_tri bf16 {(B, S, H, K, dh)}: kernel {ms:.4f} "
              f"ms (in turns {turns[True][0]:.4f}, {turns[True][1]:.4f}), "
              f"flash_prefill {b3:.4f} ms ({turns[False][0]:.4f}, "
              f"{turns[False][1]:.4f}), plain {plain:.4f} ms, sdpa "
              f"{lib:.4f} ms, bound {b_ms:.5f} ms ({b_by}: "
              f"{nbytes/1e6:.3f} MB, {flops/1e9:.3f} GFLOP); device time: "
              f"kernel {dev[True]:.4f} ms, flash_prefill {dev[False]:.4f} "
              f"ms, sdpa {lib_dev:.4f} ms")
        del q, k, v
    row = dict(rows[0], long_prompt=rows[1])
    return err, row, launches


def lane_vectors(greedy, temp, seed):
    """Per-lane token-choice vectors on the card, as the session uploads
    them."""
    return {"greedy": torch.tensor(greedy, device="cuda"),
            "temp": torch.tensor(temp, dtype=torch.float32, device="cuda"),
            "seed": torch.tensor(seed, dtype=torch.int64, device="cuda")}


def gumbel_shapes():
    """The fused step's (lanes, tree width) at the Qwen path's vocabulary
    (GUMBEL_SHAPE) and at each vocabulary of SAMPLED_ARCHS."""
    from repro_torch.configs import get_arch
    B, T, _ = GUMBEL_SHAPE
    return [GUMBEL_SHAPE] + [(B, T, get_arch(a).full_config().vocab_size)
                             for a in SAMPLED_ARCHS]


def gumbel_hold(gen, shape):
    """The Gumbel-argmax kernel at ``shape``, bf16 logits, two greedy and
    two sampled lanes (temperatures 0.7 and 1.3, seeds 0 and 2^32 - 1),
    positions up to max_seq_len: its generator's raw bits equal the plain
    version's bit for bit and its Gumbel values agree to GUMBEL_ATOL; its
    choices (through choose_tokens_lanes) equal the plain version's
    wherever the plain top-two gap of z + g exceeds GUMBEL_GAP.  Returns
    (max Gumbel error, logits, positions, lane vectors, greedy rows)."""
    from repro_torch.kernels.gumbel_argmax.ops import gumbel_noise
    from repro_torch.kernels.gumbel_argmax.ref import (fold_in, gumbel,
                                                       gumbel_argmax_ref,
                                                       random_bits32,
                                                       random_key)
    from repro_torch.serving.sampler import choose_tokens_lanes
    B, T, V = shape
    lp = lane_vectors([True, False, True, False], [1.0, 0.7, 1.0, 1.3],
                      [5, 0, 6, 2**32 - 1])
    logits = (torch.randn((B, T, V), generator=gen, device="cuda")
              * 2.0).to(torch.bfloat16)
    pos = torch.randint(0, 513, (B, T), generator=gen, device="cuda",
                        dtype=torch.int32)

    # the generator: every row's bits and Gumbel values
    seeds = lp["seed"][:, None].expand(B, T).reshape(-1)
    bits, g = gumbel_noise(seeds, pos.reshape(-1), V)
    key = fold_in(random_key(seeds), pos.reshape(-1).long())
    ref_bits = random_bits32(key, V)
    ref_g = gumbel(key, V)
    torch.cuda.synchronize()
    check(torch.equal(bits, ref_bits), f"gumbel_argmax at {shape}: raw "
                                       "bits differ from the plain "
                                       "threefry2x32")
    g_err = (g - ref_g).abs().max().item()
    n_diff = int((g != ref_g).sum().item())
    print(f"  gumbel_argmax generator {B * T} rows x {V} ({V // 4096} "
          f"chunks of 4096 and a tail of {V % 4096}): raw bits (and so "
          f"the uniforms) equal bit for bit; Gumbel values max|err| "
          f"{g_err:.3e} ({n_diff} of {B * T * V} differ; atol "
          f"{GUMBEL_ATOL})")
    check(g_err <= GUMBEL_ATOL, f"Gumbel values at {shape} differ by "
                                f"{g_err}")
    del bits, g, ref_bits

    # the choice, through the serving entry point, against the plain one
    got = choose_tokens_lanes(logits, pos, lp)
    greedy = lp["greedy"][:, None].expand(B, T)
    z = logits.float() / lp["temp"].clamp_min(1e-6)[:, None, None]
    top2 = (z + ref_g.view(B, T, V)).topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    plain = torch.where(greedy, logits.argmax(-1).int(),
                        gumbel_argmax_ref(logits, pos, lp["temp"],
                                          lp["seed"], lp["greedy"]))
    torch.cuda.synchronize()
    near = (~greedy) & (gap <= GUMBEL_GAP)
    bad = (got != plain) & ~near
    print(f"  gumbel_argmax choices at {shape} bf16: "
          f"{int((got == plain).sum())}/{B * T} equal the plain version; "
          f"{int(near.sum())} sampled rows have a top-two gap of z + g "
          f"under {GUMBEL_GAP} (smallest gap {gap[~greedy].min().item():.3e})")
    check(not bool(bad.any()), f"gumbel_argmax at {shape}: "
                               f"{int(bad.sum())} choices differ above the "
                               "gap")
    return g_err, logits, pos, lp, greedy


def gumbel_phase(gen):
    """The Gumbel-argmax kernel held against its plain version
    (``gumbel_hold``) at the fused step's shape, then timed beside it
    there, then held at each sampled arch's vocabulary."""
    from repro_torch.kernels.gumbel_argmax.ops import gumbel_argmax
    from repro_torch.kernels.gumbel_argmax.ref import gumbel_argmax_ref
    from repro_torch.kernels.timing import device_ms
    B, T, V = GUMBEL_SHAPE
    g_err, logits, pos, lp, greedy = gumbel_hold(gen, GUMBEL_SHAPE)

    # timing, each call on one of 8 logits buffers (320 MB: beyond L2)
    L = 8
    lg = torch.stack([logits] + [
        (torch.randn((B, T, V), generator=gen, device="cuda") * 2.0)
        .to(torch.bfloat16) for _ in range(L - 1)])
    args = (pos, lp["temp"], lp["seed"], lp["greedy"])
    ms = time_ms(lambda i: gumbel_argmax(lg[i % L], *args))
    dev = device_ms(lambda i: gumbel_argmax(lg[i % L], *args), L)
    plain = time_ms(lambda i: gumbel_argmax_ref(lg[i % L], *args), iters=5,
                    warmup=2)
    n_rows = int((~greedy).sum().item())
    nbytes = n_rows * V * 2 + pos.numel() * 4 + B * (4 + 8 + 1) \
        + B * T * 4
    from repro_torch.kernels import _build
    fn, body = next((f, b) for f, b in sass_functions(
        _build.library_path("gumbel_argmax"))[0].items()
        if "gumbel_partialI13__nv_bfloat16E" in f)
    n_ins, n_ld = loop_per_load(body)
    check(n_ld > 0, f"gumbel_partial: no loop with a global load in {fn}")
    per_entry = n_ins / n_ld
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.splitlines()[0].split(",")
    sm_hz = float(clocks[0]) * 1e6
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    lanes_per_s = n_sm * LANES_PER_SM_CLOCK * sm_hz
    t_ops = n_rows * V * per_entry / lanes_per_s * 1e3
    needed = sum(GUMBEL_OPS_NEEDED.values())
    t_needed = n_rows * V * needed / lanes_per_s * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
    print(f"  gumbel_argmax bf16 {GUMBEL_SHAPE}, {n_rows} sampled rows: "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, issue-rate bound of "
          f"the SASS {b_ms:.5f} ms ({b_by}: {n_ins} SASS instructions a "
          f"loop of {n_ld} entries, {per_entry:.2f} an entry, x "
          f"{n_rows * V} entries over {n_sm} SMs x {LANES_PER_SM_CLOCK} "
          f"lanes a clock at the maximum SM clock {clocks[0].strip()} MHz "
          f"(now {clocks[1].strip()} MHz); {nbytes / 1e6:.3f} MB); device "
          f"time {dev:.4f} ms: the bound is {b_ms / dev:.3f} of it; the "
          f"function's own {needed} operations an entry "
          f"({GUMBEL_OPS_NEEDED}) give {t_needed:.5f} ms, "
          f"{t_needed / dev:.3f} of it")
    del lg, logits
    for shape in gumbel_shapes()[1:]:
        g_err = max(g_err, gumbel_hold(gen, shape)[0])
    return g_err, dict(ms=ms, plain_ms=plain, library_ms=None,
                       bound_ms=b_ms, bound_by=b_by, device_ms=dev,
                       library_device_ms=None, sass_per_entry=per_entry,
                       ops_needed_per_entry=needed,
                       ops_needed_bound_ms=t_needed)


# --------------------------------------------------------------- phase 4
def guided_transform(vocab: int, phase: int = 2, seed: int = 0,
                     span: int = 512):
    """The benchmarks' guided model (benchmarks/common.py), from numpy: a
    deterministic continuation bias G[position % phase, token] added to the
    logits, so outputs revisit shared chains that drafts can verify.  The
    successors are drawn from the first ``span`` ids, the benchmarks' vocab
    (over all 151936 ids a walk would not repeat within a request)."""
    rng = np.random.RandomState(seed + 1000 * phase)
    base = rng.randint(2, span, size=(vocab,))
    spec = rng.randint(2, span, size=(phase, vocab))
    shared = rng.rand(phase, vocab) < 0.7
    table = np.where(shared, base[None, :], spec).astype(np.int64)
    guide = torch.from_numpy(table).cuda()

    def bias(logits, tokens, positions, vocab_offset=0):
        # under a mesh the session passes a vocab block and its first id
        nxt = guide[positions.long() % phase, tokens.long()] - vocab_offset
        inside = (nxt >= 0) & (nxt < logits.shape[-1])
        return logits.scatter_add(
            -1, nxt.clamp(0, logits.shape[-1] - 1)[..., None],
            (inside * 1e4).to(logits.dtype)[..., None])

    bias.table = table         # [position % phase, token] -> next token
    return bias


def no_sync(member):
    """``member`` run with torch's CUDA sync check set to raise."""
    def call(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return member(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return call


def model_inputs(vocab, B=4, S=128, T=33, seed=0):
    """Path-like inputs of one cohort prefill and one tree step: B prompts
    padded to S with random lengths, then a random draft tree of T slots
    whose positions are each lane's length plus the node's depth."""
    rng = np.random.RandomState(seed)
    toks = torch.from_numpy(rng.randint(2, vocab, (B, S))).cuda()
    lens = torch.from_numpy(rng.randint(S // 2, S + 1, (B,))).cuda()
    tree = torch.from_numpy(rng.randint(2, vocab, (B, T))).cuda()
    tm = np.zeros((B, T, T), bool)
    for b in range(B):
        parent = [-1] + [int(rng.randint(0, i)) for i in range(1, T)]
        for i in range(T):
            j = i
            while j >= 0:
                tm[b, i, j] = True
                j = parent[j]
    tm = torch.from_numpy(tm).cuda()
    pos = lens[:, None] + tm.sum(-1) - 1
    return toks, lens, tree, pos, tm


def model_logits(cfg, params, ins, backend):
    """(last-token logits of the prefill, tree-step logits), in f32."""
    from repro_torch.models import transformer as tx
    c = dataclasses.replace(cfg, prefill_backend=backend,
                            decode_backend=backend)
    toks, lens, tree, pos, tm = ins
    cache = tx.init_cache(c, toks.shape[0], device="cuda")
    cache, last = tx.prefill(c, params, toks, lens, cache)
    _, lg = tx.tree_step(c, params, cache, lens, tree, pos, tm)
    return last.float(), lg.float()


def paged_model_logits(cfg, params, ins, backend):
    """The same inputs on the paged layout (blocks of 64, shuffled tables),
    in f32: (prefill logits, suffix-prefill logits of lane 1's last 16
    prompt tokens at their offset, tree-step logits)."""
    from repro_torch.models import transformer as tx
    bs = PATH_PAGED[5]
    c = dataclasses.replace(cfg, prefill_backend=backend,
                            decode_backend=backend, kv_layout="paged",
                            kv_block_size=bs)
    toks, lens, tree, pos, tm = ins
    B = toks.shape[0]
    cache = tx.init_paged_cache(c, B, device="cuda")
    cache["block_tables"] = shuffled_tables([tx.blocks_per_lane(c)] * B,
                                            tx.blocks_per_lane(c), seed=3)
    cache, last = tx.prefill_paged(c, params, toks, lens, cache)
    n = int(lens[1])
    cache, suffix = tx.prefill_from_offset_paged(
        c, params, cache, 1, toks[1:2, n - 16:n].contiguous(),
        lens[1:2] - 16, torch.tensor([16], device="cuda"),
        prefill_len=toks.shape[1])
    _, lg = tx.tree_step_paged(c, params, cache, lens, tree, pos, tm)
    return last.float(), suffix.float(), lg.float()


def register_scaled_backend(factor, name="cuda_scaled"):
    """Register the cuda backend with both kernels' outputs multiplied by
    ``factor`` under ``name``: kernels that are wrong by a known amount."""
    from repro_torch.models.attention import CudaBackend, register_backend

    class Scaled(CudaBackend):
        def prefill_attention(self, *args):
            return super().prefill_attention(*args) * factor

        def make_tree_attend(self, *args, **kwargs):
            attend = super().make_tree_attend(*args, **kwargs)
            return lambda *a: attend(*a) * factor

    Scaled.name = name
    register_backend(Scaled())
    return name


def model_phase():
    """Full width, 2 layers, path-like inputs: the cuda backend's logits
    against the dense backend's.  In f32 they agree to atol 1e-3.  In bf16
    both are held against the f32 dense path on the same bf16-rounded
    weights: the cuda backend's RMS logit error may be at most
    BF16_LOGIT_RATIO times the dense backend's, and kernels made wrong by
    3 % must fail that same limit (else it could not tell a wrong kernel)."""
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.models.params import init_params
    cfg32 = dataclasses.replace(full_config(), n_layers=2)
    cfg16 = dataclasses.replace(cfg32, dtype="bfloat16",
                                param_dtype="bfloat16")
    p16 = init_params(cfg16, seed=1, device="cuda")
    p32 = tree_map(lambda t: t.float(), p16)
    ins = model_inputs(cfg32.vocab_size)
    names = ("prefill", "tree_step")
    ref = model_logits(cfg32, p32, ins, "dense")
    got = model_logits(cfg32, p32, ins, "cuda")
    for name, a, b in zip(names, got, ref):
        err = (a - b).abs().max().item()
        print(f"  full-width 2-layer f32 {name} logits, cuda vs dense "
              f"backend: max|err| {err:.3e} (atol 1e-3)")
        check(bool(torch.isfinite(a).all()) and err < 1e-3,
              f"{name} logits: cuda backend vs dense max err {err}")
    for name, a, b in zip(("paged prefill", "suffix prefill",
                           "paged tree_step"),
                          paged_model_logits(cfg32, p32, ins, "cuda"),
                          paged_model_logits(cfg32, p32, ins, "dense")):
        err = (a - b).abs().max().item()
        print(f"  full-width 2-layer f32 {name} logits, cuda vs dense "
              f"backend: max|err| {err:.3e} (atol 1e-3)")
        check(bool(torch.isfinite(a).all()) and err < 1e-3,
              f"{name} logits: cuda backend vs dense max err {err}")

    def rms(a, b):
        return (a - b).pow(2).mean().sqrt().item()

    dense = model_logits(cfg16, p16, ins, "dense")
    cuda = model_logits(cfg16, p16, ins, "cuda")
    wrong = model_logits(cfg16, p16, ins, register_scaled_backend(1.03))
    for i, name in enumerate(names):
        e_dense, e_cuda, e_wrong = (rms(x[i], ref[i])
                                    for x in (dense, cuda, wrong))
        limit = BF16_LOGIT_RATIO * e_dense
        print(f"  full-width 2-layer bf16 {name} logits vs the f32 path: "
              f"RMS err dense {e_dense:.4e}, cuda {e_cuda:.4e}, cuda with "
              f"kernels 3% off {e_wrong:.4e}; limit {limit:.4e} "
              f"({BF16_LOGIT_RATIO} x dense; |logits| RMS "
              f"{ref[i].pow(2).mean().sqrt().item():.4f})")
        check(bool(torch.isfinite(cuda[i]).all()) and e_cuda <= limit,
              f"bf16 {name} logits: cuda RMS err {e_cuda} over {limit}")
        check(e_wrong > limit, f"bf16 {name} logits: kernels 3% off give "
                               f"RMS err {e_wrong}, within {limit}")
    del p16, p32


def path_model():
    """Qwen2-1.5B at full width in bf16, random weights from seed 0."""
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.models.params import init_params
    cfg = dataclasses.replace(full_config(), dtype="bfloat16",
                              param_dtype="bfloat16")
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    print(f"  qwen2-1.5b full width bf16: {cfg.n_params()/1e9:.3f} B "
          f"params made on the card in {time.perf_counter() - t0:.1f} s")
    return cfg, params


def path_prompts(vocab):
    """The guided cells' N_REQUESTS prompts of 96 tokens."""
    from repro_torch.training.data import PROFILES, SyntheticCorpus
    corpus = SyntheticCorpus(PROFILES["antrag"], vocab, seed=0)
    return [corpus.sample()[0][:96] for _ in range(N_REQUESTS)]


def path_phase(cfg, params):
    """The dense-layout main path (``guided_cell``, reference_decode at
    B = 1); returns its kernel launches, prompts and outputs."""
    from repro_torch.core.request import SamplingParams
    from repro_torch.serving.api import EngineConfig

    ecfg = EngineConfig(default_params=SamplingParams(max_new_tokens=MAX_NEW))
    transform = guided_transform(cfg.vocab_size)
    prompts = path_prompts(cfg.vocab_size)
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    outs, launches, _, engine = guided_cell("qwen2-1.5b", ecfg, cfg, params,
                                            transform, prompts, sp)
    launches = {k: launches[k] for k in ("tree_attention", "flash_prefill")}

    # prefill times (cohort (4, 128) and one lane (1, 128)), synchronized
    fns = engine.fns
    toks = np.zeros((ecfg.lanes, ecfg.prefill_len), np.int32)
    lens = np.zeros((ecfg.lanes,), np.int32)
    for b, p in enumerate(prompts[:ecfg.lanes]):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    pre, slot = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        cache, chosen = fns.prefill(toks, lens)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    for _ in range(5):           # one cache: its first call eager, then
        t0 = time.perf_counter()  # a capture, then replays
        cache, chosen = fns.prefill_into_slot(cache, 1, toks[1:2], lens[1:2])
        torch.cuda.synchronize()
        slot.append((time.perf_counter() - t0) * 1e3)
    print(f"  median prefill (4, 128): {float(np.median(pre)):.3f} ms; "
          f"prefill_into_slot (1, 128): {float(np.median(slot)):.3f} ms "
          "(synchronized, captured)")
    profile_decode(ecfg, cfg, params, transform, prompts, sp)
    return launches, prompts, outs


def serve_counted(sched, prompts, sp, counters):
    """Serve ``prompts`` to the end on the ContinuousScheduler ``sched``
    (an engine's ``.scheduler``, or one built from any LookaheadConfig)
    with every kernel counter in ``counters`` set to 0 just before and
    read just after; ``sp`` is one SamplingParams for every request or a
    list, one per request.  Returns (outputs, launches, wall s, tokens/s,
    EDL, median fused_step ms)."""
    from repro_torch.core.request import Request
    sched.record_breakdown = True
    torch.cuda.synchronize()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    sps = sp if isinstance(sp, list) else [sp] * len(prompts)
    handles = [sched.submit_request(Request(prompt=list(p), params=q))
               for p, q in zip(prompts, sps)]
    sched.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: fn.launches for n, fn in counters.items()}
    outs = [h.result().tokens for h in handles]
    n_tok = sum(len(o) for o in outs)
    n_steps = sum(h.result().stats.steps for h in handles)
    fused = float(np.median([b["device_step_ms"]
                             for b in sched.step_breakdown]))
    return outs, launches, wall, n_tok / wall, n_tok / max(n_steps, 1), fused


def counted_calls(fns, names):
    """``fns`` with each member in ``names`` wrapped to count its calls,
    and the dict of counts."""
    calls = dict.fromkeys(names, 0)

    def counted(name):
        member = getattr(fns, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return member(*args, **kwargs)
        return call
    return dataclasses.replace(fns, **{n: counted(n) for n in names}), calls


def guided_cell(label, ecfg, cfg, params, transform, prompts, sp,
                ref_lanes=None):
    """The guided cell on ``ecfg``'s layout.  A warm-up engine whose
    members run under torch's sync check set to "error" serves
    lanes + 2 of ``prompts`` (cohort, lane admissions, fused steps) — a
    member that made the host wait for the card would raise (the
    scheduler's own _pull runs outside them).  The members are captured
    CUDA graphs: each key's first call (eager), its capture and its
    replays all run inside the check (the session captures on a side
    stream after a wait_stream, not under torch.cuda.graph, whose entry
    synchronises the device).  Then a fresh engine serves ``prompts``
    (more than the lanes: some are admitted into a lane mid-flight) with
    every kernel counter and its prefill calls counted.  Each decode step
    must launch the layout's tree kernel (B1 dense, B2 paged) once a layer
    and the other never, each prefill B3 once a layer; one pull a decode
    step; one input shape a step function; every output must equal
    reference_decode (at the serving batch shape with ``ref_lanes``).
    Returns (outputs, launches, numbers, engine)."""
    from repro_torch.core import reference_decode
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.tree_attention.ops import tree_attention
    from repro_torch.kernels.tree_attention.paged import paged_tree_attention
    from repro_torch.serving.api import ServingEngine, build_session_fns
    L, layout, lanes = cfg.n_layers, ecfg.kv_layout, ecfg.lanes
    check(len(prompts) > lanes, f"{label}: {len(prompts)} requests do not "
                                f"outnumber the {lanes} lanes")
    fns = build_session_fns(ecfg, cfg, params, logits_transform=transform,
                            device="cuda")
    warm = ServingEngine(dataclasses.replace(
        fns, prefill=no_sync(fns.prefill),
        prefill_into_slot=no_sync(fns.prefill_into_slot),
        fused_step=no_sync(fns.fused_step)), ecfg)
    for p in prompts[:lanes + 2]:
        warm.submit(p, max_new_tokens=8)
    warm.run()
    check(warm.stats.admitted == lanes + 2, f"{label}: warm-up admissions")
    del warm, fns

    fns = build_session_fns(ecfg, cfg, params, logits_transform=transform,
                            device="cuda")
    counting, calls = counted_calls(fns, ("prefill", "prefill_into_slot"))
    engine = ServingEngine(counting, ecfg)
    outs, launches, wall, tps, edl, fused = serve_counted(
        engine.scheduler, prompts, sp,
        {"tree_attention": tree_attention,
         "paged_tree_attention": paged_tree_attention,
         "flash_prefill": flash_prefill})
    st = engine.stats
    n_prefill = sum(calls.values())
    print(f"  {label}, guided {layout}: {len(prompts)} requests, "
          f"{sum(map(len, outs))} tokens in {wall:.3f} s -> {tps:.1f} "
          f"tokens/s; EDL {edl:.3f}; {st.decode_steps} decode steps, "
          f"median fused_step {fused:.3f} ms (dispatch to packed pull); "
          f"{n_prefill} prefill calls ({calls}); launches {launches}")
    tree, other = (("paged_tree_attention", "tree_attention")
                   if layout == "paged" else
                   ("tree_attention", "paged_tree_attention"))
    check(launches[tree] == L * st.decode_steps > 0,
          f"{label} {layout}: {tree} launched {launches[tree]} times for "
          f"{st.decode_steps} steps x {L} layers")
    check(launches[other] == 0,
          f"{label} {layout}: {other} launched {launches[other]} times")
    check(calls["prefill_into_slot"] > 0,
          f"{label} {layout}: no request was admitted into a lane ({calls})")
    check(launches["flash_prefill"] == L * n_prefill,
          f"{label} {layout}: flash_prefill launched "
          f"{launches['flash_prefill']} times for {n_prefill} prefills x {L}")
    check(st.decode_syncs == st.decode_steps,
          f"{label} {layout}: {st.decode_syncs} decode syncs for "
          f"{st.decode_steps} steps")
    check(fns.fused_step._cache_size() == 1
          and fns.prefill._cache_size() == 1
          and fns.prefill_into_slot._cache_size() == 1,
          f"{label} {layout}: a step function saw more than one input shape")
    check(all(len(o) == MAX_NEW for o in outs), f"{label}: short outputs")
    for i, (p, o) in enumerate(zip(prompts, outs)):
        ref = reference_decode(fns, list(p), params=sp, lanes=ref_lanes)
        check(o == ref, f"{label} {layout}, request {i}: served output "
                        "differs from reference_decode (first difference "
                        f"at token {first_difference(o, ref)})")
    print(f"  {label}, guided {layout}: all {len(prompts)} outputs equal "
          f"reference_decode(..., lanes={ref_lanes}); no member synced the "
          f"host (warm-up: {lanes + 2} admissions under "
          "torch.cuda.set_sync_debug_mode('error'))")
    return outs, launches, dict(
        fused_ms=fused, tokens_per_s=tps, edl=edl,
        decode_steps=st.decode_steps, launches=launches,
        prefills=n_prefill, lane_admissions=calls["prefill_into_slot"]), \
        engine


def paged_phase(cfg, params, prompts, dense_outs):
    """The paged layout at full width: the dense path's 8 requests, then a
    shared-prefix workload with the prefix cache on and off.  Every output
    must equal the dense path's / the other run's and reference_decode on
    the paged step functions; B2 must carry every paged decode step and
    suffix prefill (28 launches each) and B1 none; one decode sync per
    step; no paged member may sync the host.  Then the dense and the
    paged layout serve the 8 requests in turns, for a paired step time.
    Returns the kernels' launches over the three checked runs."""
    from repro_torch.core import reference_decode
    from repro_torch.core.request import SamplingParams
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.tree_attention.ops import tree_attention
    from repro_torch.kernels.tree_attention.paged import paged_tree_attention
    from repro_torch.serving.api import (EngineConfig, ServingEngine,
                                         build_engine)
    from repro_torch.training.data import PROFILES, SyntheticCorpus

    L = cfg.n_layers
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    ecfg = EngineConfig(kv_layout="paged", block_size=PATH_PAGED[5],
                        default_params=sp)
    transform = guided_transform(cfg.vocab_size)
    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=1)
    head = corpus.sample()[0][:SHARED_HEAD]
    shared = [head + corpus.sample()[0][:SHARED_TAIL]
              for _ in range(N_SHARED)]
    check(all(len(p) == SHARED_HEAD + SHARED_TAIL for p in shared),
          "shared-prefix prompts too short")
    counters = {"paged_tree_attention": paged_tree_attention,
                "tree_attention": tree_attention,
                "flash_prefill": flash_prefill}

    # warm-up engine, prefix cache and scrub on, whose paged members run
    # under torch's sync check set to "error"; the workload reaches every
    # member: cohort prefill, a cold admission (an unrelated prompt), cache
    # hits (suffix prefill after a copy-on-write fork), scrubs at retire
    wcfg = dataclasses.replace(ecfg, prefix_cache=True, scrub_freed=True)
    fns = build_engine(wcfg, cfg, params, logits_transform=transform,
                       device="cuda").fns
    names = ("prefill", "prefill_into_slot", "fused_step", "prefill_suffix",
             "copy_block", "reset_blocks")
    watched, calls = counted_calls(dataclasses.replace(
        fns, **{n: no_sync(getattr(fns, n)) for n in names}), names)
    warm = ServingEngine(watched, wcfg)
    for p in shared[:ecfg.lanes] + [prompts[0]] + shared[4:6]:
        warm.submit(p, max_new_tokens=8)
    warm.run()
    check(all(calls.get(n, 0) > 0 for n in names),
          f"the warm-up did not reach every paged member: {calls}")
    print(f"  no paged member synced the host (calls {calls} under "
          "torch.cuda.set_sync_debug_mode('error'))")
    del warm, fns

    # 1. the dense path's requests on the paged layout
    outs, launches, _, engine = guided_cell("qwen2-1.5b", ecfg, cfg, params,
                                            transform, prompts, sp)
    total = dict(launches)
    check(outs == dense_outs, "paged outputs differ from the dense path's")
    print(f"  all {len(prompts)} paged outputs equal the dense path's")
    del engine

    # 2. shared-prefix workload, prefix cache on, then off
    runs = {}
    for on in (True, False):
        engine = build_engine(dataclasses.replace(ecfg, prefix_cache=on),
                              cfg, params, logits_transform=transform,
                              device="cuda")
        outs, launches, wall, tps, edl, fused = serve_counted(
            engine.scheduler, shared, sp, counters)
        st = engine.stats
        for n, c in launches.items():
            total[n] += c
        n_suffix = st.prefix_hits
        print(f"  shared prefix ({N_SHARED} x {SHARED_HEAD}+{SHARED_TAIL} "
              f"tokens), cache {'on' if on else 'off'}: {tps:.1f} tokens/s "
              f"({wall:.3f} s), EDL {edl:.3f}; {st.decode_steps} decode "
              f"steps, median fused_step {fused:.3f} ms; {n_suffix} suffix "
              f"prefills; launches {launches}")
        check(launches["paged_tree_attention"]
              == L * (st.decode_steps + n_suffix),
              f"paged_tree_attention launched "
              f"{launches['paged_tree_attention']} times for "
              f"{st.decode_steps} steps + {n_suffix} suffix prefills x {L}")
        check(launches["tree_attention"] == 0,
              f"tree_attention launched on the paged path: {launches}")
        check(st.decode_syncs == st.decode_steps,
              f"{st.decode_syncs} decode syncs for {st.decode_steps} steps")
        check(engine.fns.fused_step._cache_size() == 1,
              "paged fused_step saw more than one input shape")
        runs[on] = (engine, outs)
    engine, outs = runs[True]
    st = engine.stats
    fns = engine.fns
    check(st.prefix_hits > 0 and st.prefix_cow_forks > 0,
          f"prefix hits {st.prefix_hits}, COW forks {st.prefix_cow_forks}")
    cached = [engine.scheduler.results[rid].stats.cached_prompt_tokens
              for rid in range(N_SHARED)]     # a fresh engine's rids: 0..
    touched = {next(b for b in fns.suffix_buckets if b >= len(p) - n)
               for p, n in zip(shared, cached) if n}
    check(fns.prefill_suffix._cache_size() == len(touched),
          f"prefill_suffix saw {fns.prefill_suffix._cache_size()} shapes "
          f"for buckets {sorted(touched)}")
    print(f"  prefix cache: {st.prefix_hits}/{st.prefix_lookups} lookups hit"
          f" (hit rate {st.prefix_hit_rate:.3f}), {st.prefix_hit_tokens}/"
          f"{st.prefix_prompt_tokens} prefill tokens saved "
          f"({st.prefill_tokens_saved:.3f}), {st.prefix_cow_forks} COW "
          f"forks; suffix buckets touched {sorted(touched)}")
    check(outs == runs[False][1], "prefix cache on and off differ")
    # every other request against reference_decode (the cohort's misses
    # and the hits alike); all 16 already equal the uncached run's
    for i, (p, o) in list(enumerate(zip(shared, outs)))[::2]:
        check(o == reference_decode(fns, list(p), params=sp),
              f"shared-prefix request {i} differs from reference_decode")
    print(f"  all {N_SHARED} shared-prefix outputs equal with the cache on "
          f"and off; the {N_SHARED // 2} even-numbered equal "
          "reference_decode")

    # suffix prefill (1 x 16 after an 80-token hit) against the full
    # one-lane prefill (1 x 128), synchronized, on the run's cache
    cache = engine.scheduler.cache
    toks = np.zeros((1, ecfg.prefill_len), np.int32)
    toks[0, :len(shared[0])] = shared[0]
    lens = np.asarray([len(shared[0])], np.int32)
    tail = np.asarray([shared[0][SHARED_HEAD:]], np.int32)
    suf, full = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        cache, _ = fns.prefill_suffix(cache, 1, tail, SHARED_HEAD)
        torch.cuda.synchronize()
        suf.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        cache, _ = fns.prefill_into_slot(cache, 1, toks, lens)
        torch.cuda.synchronize()
        full.append((time.perf_counter() - t0) * 1e3)
    print(f"  median suffix prefill (1, {SHARED_TAIL} -> bucket "
          f"{min(b for b in fns.suffix_buckets if b >= SHARED_TAIL)}) "
          f"{float(np.median(suf)):.3f} ms against prefill_into_slot "
          f"(1, {ecfg.prefill_len}) {float(np.median(full)):.3f} ms")
    del runs, engine, fns, cache

    # the two layouts in turn on the dense path's requests, one run each
    # (two each until the recsys phase needed the time): the host-bound step
    # time drifts within a call, so only adjacent runs compare them
    paired = {"dense": [], "paged": []}
    for layout in ("paged", "dense"):
        engine = build_engine(dataclasses.replace(ecfg, kv_layout=layout),
                              cfg, params, logits_transform=transform,
                              device="cuda")
        outs, _, _, tps, _, fused = serve_counted(engine.scheduler, prompts,
                                                  sp, {})
        check(outs == dense_outs, f"{layout} outputs changed between runs")
        paired[layout].append((fused, tps))
    for layout, runs in paired.items():
        print(f"  in turns, {layout}: median fused_step "
              f"{float(np.median([r[0] for r in runs])):.3f} ms "
              f"(runs {', '.join(f'{r[0]:.3f}' for r in runs)}), tokens/s "
              f"{', '.join(f'{r[1]:.1f}' for r in runs)}")
    profile_decode(ecfg, cfg, params, transform, prompts, sp)
    return total


def invariance_phase(cfg, params):
    """Batch-shape invariance.  Findings: the same request's logits row
    computed at the serving shapes — a 4-lane cohort prefill (4, 128) and a
    4-lane fused step (4, 33) — and at the B = 1 shapes of one-lane
    admission (1, 128) and of a width-1 reference decode (1, 1), (4, 1) and
    (1, 33) besides; prints how many rows differ in any bit and the largest
    difference.  Checks: the padded one-lane admission's row, and the prefix
    cache's suffix prefill — its last-token logits row and the tail's K/V
    rows in every layer — against the uncached admission: 0 rows may
    differ."""
    from repro_torch.models import transformer as tx
    from repro_torch.training.data import PROFILES, SyntheticCorpus
    B, S, T = 4, 128, 33
    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=2)
    toks = torch.zeros((B, S), dtype=torch.int32, device="cuda")
    lens = torch.zeros((B,), dtype=torch.int32, device="cuda")
    for b in range(B):
        p = corpus.sample()[0][:96 - 8 * b]
        toks[b, :len(p)] = torch.tensor(p, device="cuda")
        lens[b] = len(p)
    found = {}

    def compare(label, a, b):
        a, b = a.float().reshape(-1, a.shape[-1]), \
            b.float().reshape(-1, b.shape[-1])
        rows = int((a != b).any(dim=-1).sum().item())
        diff = (a - b).abs().max().item()
        found[label] = (rows, a.shape[0], diff)
        print(f"  {label}: {rows}/{a.shape[0]} logits rows differ in bits, "
              f"max|diff| {diff:.4e}")

    cache, last = tx.prefill(cfg, params, toks, lens,
                             tx.init_cache(cfg, B, device="cuda"))
    alone = torch.cat([tx.prefill(cfg, params, toks[b:b + 1],
                                  lens[b:b + 1],
                                  tx.init_cache(cfg, 1, device="cuda"))[1]
                       for b in range(B)])
    compare("prefill, lane of a (4, 128) cohort vs alone at (1, 128)",
            last, alone)
    padded = []
    for b in range(B):            # the port's one-lane admission
        ptoks = torch.zeros_like(toks)
        ptoks[b] = toks[b]
        plens = torch.ones_like(lens)
        plens[b] = lens[b]
        padded.append(tx.prefill_into_slot(
            cfg, params, tx.init_cache(cfg, B, device="cuda"), b, ptoks,
            plens)[1])
    label = "prefill, lane of a (4, 128) cohort vs admission padded to 4 lanes"
    compare(label, last, torch.cat(padded))
    check(found[label][0] == 0, "the padded admission's logits rows differ "
                                "from the cohort's")

    rng = np.random.RandomState(3)
    tree = torch.from_numpy(rng.randint(2, cfg.vocab_size, (B, T))).cuda()
    tree[:, 0] = last.argmax(-1)
    tm = np.zeros((B, T, T), bool)
    for b in range(B):
        parent = [-1] + [int(rng.randint(0, i)) for i in range(1, T)]
        for i in range(T):
            j = i
            while j >= 0:
                tm[b, i, j] = True
                j = parent[j]
    tm = torch.from_numpy(tm).cuda()
    pos = (lens[:, None] + tm.sum(-1) - 1).int()

    def step(lanes, width):
        c = {k: v[:, lanes].clone() for k, v in cache.items()}
        return tx.tree_step(cfg, params, c, lens[lanes],
                            tree[lanes, :width].contiguous(),
                            pos[lanes, :width].contiguous(),
                            tm[lanes, :width, :width].contiguous())[1]

    full, narrow = step(list(range(B)), T), step(list(range(B)), 1)
    one_full = torch.cat([step([b], T) for b in range(B)])
    one_one = torch.cat([step([b], 1) for b in range(B)])
    compare("step, (4, 33) vs (1, 33), every slot", full, one_full)
    compare("step root slot, (4, 33) vs (1, 1) (serving vs width-1 "
            "reference_decode)", full[:, :1], one_one)
    compare("step root slot, (4, 1) vs (1, 1)", narrow, one_one)
    compare("step root slot, (4, 33) vs (4, 1)", full[:, :1], narrow)
    del cache, full, narrow, one_full, one_one

    # the prefix cache's suffix prefill (a check, not a finding): after an
    # 80-token cached head, the tail (1, 16) computed at the padded
    # admission's row shapes must give the admission's last-token logits row
    # and tail K/V rows in every layer bit for bit — lane 1 of 4, (4, 128)
    pcfg = dataclasses.replace(cfg, kv_layout="paged",
                               kv_block_size=PATH_PAGED[5])
    n = int(lens[0])
    head, tail, slot = SHARED_HEAD, n - SHARED_HEAD, 1
    tables = shuffled_tables([tx.blocks_per_lane(pcfg)] * B,
                             tx.blocks_per_lane(pcfg), seed=4)

    def admit(length):
        c = tx.init_paged_cache(pcfg, B, device="cuda")
        c["block_tables"] = tables
        ptoks = torch.zeros_like(toks)
        ptoks[slot, :length] = toks[0, :length]
        plens = torch.ones_like(lens)
        plens[slot] = length
        return tx.prefill_into_slot_paged(pcfg, params, c, slot, ptoks,
                                          plens)

    full_cache, full_row = admit(n)
    c, _ = admit(head)
    c, suffix_row = tx.prefill_from_offset_paged(
        pcfg, params, c, slot, toks[:1, head:n].contiguous(),
        torch.tensor([head], device="cuda"),
        torch.tensor([tail], device="cuda"), prefill_len=S)
    label = (f"prefill, padded admission (4, 128) vs suffix prefill (1, "
             f"{tail}) after a {head}-token cached head")
    compare(label, full_row, suffix_row)
    rows = tx.paged_row_index(tables[slot:slot + 1],
                              torch.arange(head, n, device="cuda")[None],
                              pcfg.kv_block_size)[0]
    kv_rows = 0
    for name in ("k", "v"):
        a = full_cache[name].flatten(1, 2)[:, rows]       # (L, tail, K, dh)
        b = c[name].flatten(1, 2)[:, rows]
        kv_rows += int((a != b).flatten(2).any(-1).sum().item())
    print(f"  tail K/V, padded admission vs suffix prefill: {kv_rows}/"
          f"{2 * cfg.n_layers * tail} rows (K and V, {cfg.n_layers} layers "
          f"x {tail} positions) differ in bits")
    check(found[label][0] == 0 and kv_rows == 0,
          f"the suffix prefill's rows differ from the admission's: "
          f"{found[label][0]} logits rows, {kv_rows} K/V rows")
    found["suffix K/V rows"] = (kv_rows, 2 * cfg.n_layers * tail, 0.0)
    return found


def first_difference(a, b) -> int:
    """Index of the first token where two outputs differ (len if none)."""
    return next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                min(len(a), len(b)))


def sampled_requests(vocab, n, seed, mixed):
    """n prompts of 96 tokens and their params: every request sampled at
    SAMPLED_TEMP with its own seed, or (``mixed``) greedy and sampled in
    turn at distinct temperatures and seeds."""
    from repro_torch.core.request import SamplingParams
    from repro_torch.training.data import PROFILES, SyntheticCorpus
    corpus = SyntheticCorpus(PROFILES["antrag"], vocab, seed=seed)
    prompts = [corpus.sample()[0][:96] for _ in range(n)]
    if not mixed:
        return prompts, [SamplingParams(max_new_tokens=MAX_NEW, sample=True,
                                        temperature=SAMPLED_TEMP,
                                        seed=101 + i) for i in range(n)]
    temps = (0.6, 0.9, 1.2, 1.5)
    return prompts, [SamplingParams(max_new_tokens=MAX_NEW)
                     if i % 2 == 0 else
                     SamplingParams(max_new_tokens=MAX_NEW, sample=True,
                                    temperature=temps[i // 2 % 4],
                                    seed=2**32 - 1 - i)
                     for i in range(n)]


def sampled_phase(cfg, params):
    """Sampled and mixed serving, unguided, at full width in bf16: (a) one
    lane on the dense layout, 4 requests all sampled; (b) four lanes on the
    paged layout, 8 requests half greedy and half sampled.  Every output
    must equal reference_decode at the serving batch shape, the Gumbel
    kernel must carry the sampled choices, and each decode step must make
    one host sync.  First every sampled member (cohort prefill, admission,
    fused step, suffix prefill) is warmed with torch's sync check set to
    "error".  Returns the Gumbel kernel's launches over (a) and (b)."""
    from repro_torch.core import reference_decode
    from repro_torch.core.request import Request
    from repro_torch.kernels.gumbel_argmax.ops import gumbel_argmax
    from repro_torch.serving.api import (EngineConfig, ServingEngine,
                                         build_engine)
    prompts, sps = sampled_requests(cfg.vocab_size, N_REQUESTS, 4, True)

    wcfg = EngineConfig(kv_layout="paged", block_size=PATH_PAGED[5],
                        prefix_cache=True)
    fns = build_engine(wcfg, cfg, params, device="cuda").fns
    calls = {}

    def watched(name):
        member = no_sync(getattr(fns, name))

        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return member(*args, **kwargs)
        return call

    names = ("prefill", "prefill_into_slot", "fused_step", "prefill_suffix")
    warm = ServingEngine(dataclasses.replace(
        fns, **{n: watched(n) for n in names}), wcfg)
    # the cohort, a cold admission, then two hits on the first prompt's head
    head = prompts[0][:80]
    for i, p in enumerate(prompts[:wcfg.lanes + 1]
                          + [head + prompts[5][:16], head + prompts[6][:16]]):
        warm.submit(Request(prompt=list(p), params=dataclasses.replace(
            sps[1 if i % 2 else 0], max_new_tokens=8)))
    warm.run()
    check(all(calls.get(n, 0) > 0 for n in names),
          f"the warm-up did not reach every sampled member: {calls}")
    print(f"  no sampled member synced the host (calls {calls} under "
          "torch.cuda.set_sync_debug_mode('error'))")
    del warm, fns

    total = 0
    runs = (("one lane, dense, all sampled", EngineConfig(lanes=1),
             sampled_requests(cfg.vocab_size, 4, 5, False)),
            ("four lanes, paged, mixed", EngineConfig(
                kv_layout="paged", block_size=PATH_PAGED[5]),
             (prompts, sps)))
    for label, ecfg, (ps, params_list) in runs:
        engine = build_engine(ecfg, cfg, params, device="cuda")
        engine.scheduler.record_breakdown = True
        torch.cuda.synchronize()
        gumbel_argmax.launches = 0
        t0 = time.perf_counter()
        handles = [engine.submit(Request(prompt=list(p), params=sp))
                   for p, sp in zip(ps, params_list)]
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = gumbel_argmax.launches
        total += launches
        st = engine.stats
        outs = [h.result().tokens for h in handles]
        n_tok = sum(map(len, outs))
        n_steps = sum(h.result().stats.steps for h in handles)
        fused = float(np.median([b["device_step_ms"]
                                 for b in engine.scheduler.step_breakdown]))
        print(f"  sampled, {label}: {len(ps)} requests ({sum(sp.sample for sp in params_list)} "
              f"sampled), {n_tok} tokens in {wall:.3f} s -> "
              f"{n_tok / wall:.1f} tokens/s; EDL {n_tok / n_steps:.3f}; "
              f"{st.decode_steps} decode steps, median fused_step "
              f"{fused:.3f} ms; gumbel_argmax launches {launches}")
        check(launches > 0, f"{label}: the Gumbel kernel never launched")
        check(st.decode_syncs == st.decode_steps,
              f"{label}: {st.decode_syncs} decode syncs for "
              f"{st.decode_steps} steps")
        check(all(len(o) == MAX_NEW for o in outs), f"{label}: short outputs")
        for i, (p, sp, o) in enumerate(zip(ps, params_list, outs)):
            ref = reference_decode(engine.fns, list(p), params=sp,
                                   lanes=ecfg.lanes)
            check(o == ref, f"{label}, request {i}: served output differs "
                            "from reference_decode at the serving shapes "
                            f"(first difference at token "
                            f"{first_difference(o, ref)})")
        print(f"  all {len(ps)} outputs equal reference_decode at the "
              "serving batch shape")
        if ecfg.lanes > 1:
            profile_decode(ecfg, cfg, params, None, ps,
                           list(params_list[:ecfg.lanes]))
        if ecfg.lanes == 1:
            # the finding behind that repair: the width-1 reference rounds
            # its rows at (1, 1), serving at (1, 33)
            firsts = [first_difference(o, reference_decode(
                engine.fns, list(p), params=sp))
                for p, sp, o in zip(ps, params_list, outs)]
            n_diff = sum(f < MAX_NEW for f in firsts)
            print(f"  (finding) against the width-1 reference_decode: "
                  f"{n_diff}/{len(ps)} outputs differ, first differences "
                  f"at tokens {firsts}")
    return total + shared_sampled_run(cfg, params)


def shared_sampled_run(cfg, params):
    """Sampled requests with prefix-cache hits: N_SHARED_SAMPLED prompts
    sharing an 80-token head (16-token tails), all sampled at SAMPLED_TEMP
    with distinct seeds, unguided, on the paged layout with four lanes (one
    lane can wait forever on a shared prefix, ROADMAP §C), prefix cache on
    and then off.  The outputs must be equal, and equal reference_decode at
    the serving batch shape.  Returns the Gumbel kernel's launches."""
    from repro_torch.core import reference_decode
    from repro_torch.core.request import Request, SamplingParams
    from repro_torch.kernels.gumbel_argmax.ops import gumbel_argmax
    from repro_torch.serving.api import EngineConfig, build_engine
    from repro_torch.training.data import PROFILES, SyntheticCorpus
    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=6)
    head = corpus.sample()[0][:SHARED_HEAD]
    prompts = [head + corpus.sample()[0][:SHARED_TAIL]
               for _ in range(N_SHARED_SAMPLED)]
    sps = [SamplingParams(max_new_tokens=MAX_NEW_SHARED_SAMPLED, sample=True,
                          temperature=SAMPLED_TEMP, seed=501 + i)
           for i in range(N_SHARED_SAMPLED)]
    outs, total = {}, 0
    for on in (True, False):
        ecfg = EngineConfig(kv_layout="paged", block_size=PATH_PAGED[5],
                            prefix_cache=on)
        engine = build_engine(ecfg, cfg, params, device="cuda")
        torch.cuda.synchronize()
        gumbel_argmax.launches = 0
        t0 = time.perf_counter()
        handles = [engine.submit(Request(prompt=list(p), params=sp))
                   for p, sp in zip(prompts, sps)]
        engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        total += gumbel_argmax.launches
        st = engine.stats
        outs[on] = [h.result().tokens for h in handles]
        print(f"  sampled shared prefix ({N_SHARED_SAMPLED} x {SHARED_HEAD}+"
              f"{SHARED_TAIL} tokens, {ecfg.lanes} lanes, paged), cache "
              f"{'on' if on else 'off'}: {sum(map(len, outs[on]))} tokens in "
              f"{wall:.3f} s; {st.prefix_hits} hits; gumbel_argmax launches "
              f"{gumbel_argmax.launches}")
        check(st.decode_syncs == st.decode_steps,
              f"{st.decode_syncs} decode syncs for {st.decode_steps} steps")
        if on:
            check(st.prefix_hits > 0, "the sampled shared-prefix run had no "
                                      "prefix-cache hit")
            fns, lanes = engine.fns, ecfg.lanes
    check(outs[True] == outs[False], "sampled outputs differ with the prefix "
                                     "cache on and off: " + str([
                                         first_difference(a, b) for a, b in
                                         zip(outs[True], outs[False])]))
    for i, (p, sp, o) in enumerate(zip(prompts, sps, outs[True])):
        ref = reference_decode(fns, list(p), params=sp, lanes=lanes)
        check(o == ref, f"sampled shared-prefix request {i} differs from "
                        "reference_decode at the serving shapes (first "
                        f"difference at token {first_difference(o, ref)})")
    print(f"  all {N_SHARED_SAMPLED} sampled shared-prefix outputs equal with "
          f"the cache on and off and equal reference_decode(..., "
          f"lanes={lanes})")
    return total


def overlap_phase(cfg, params, prompts, dense_outs):
    """The guided dense path's 8 requests with overlap_drafts on: outputs
    equal the serial run's, no step function syncs the host, one decode
    sync per step."""
    from repro_torch.core.request import SamplingParams
    from repro_torch.serving.api import (EngineConfig, ServingEngine,
                                         build_engine)
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    ecfg = EngineConfig(overlap_drafts=True, default_params=sp)
    fns = build_engine(ecfg, cfg, params,
                       logits_transform=guided_transform(cfg.vocab_size),
                       device="cuda").fns
    engine = ServingEngine(dataclasses.replace(
        fns, prefill=no_sync(fns.prefill),
        prefill_into_slot=no_sync(fns.prefill_into_slot),
        fused_step=no_sync(fns.fused_step)), ecfg)
    outs, _, wall, tps, edl, fused = serve_counted(engine.scheduler, prompts,
                                                   sp, {})
    st = engine.stats
    print(f"  overlap_drafts, {len(prompts)} requests: {tps:.1f} tokens/s "
          f"({wall:.3f} s), EDL {edl:.3f}; {st.decode_steps} decode steps, "
          f"median fused_step {fused:.3f} ms; hidden host "
          f"{st.breakdown()['hidden_host_ms']:.3f} ms/step")
    check(outs == dense_outs, "overlap outputs differ from the serial run's")
    check(st.decode_syncs == st.decode_steps,
          f"{st.decode_syncs} decode syncs for {st.decode_steps} steps")
    print("  overlap outputs equal the serial run's; no step function "
          "synced the host")


def long_prompt_phase(cfg, params):
    """The dense main path at a long prompt: Qwen2-1.5B at full width in
    bf16, guided, ``prefill_len`` LONG_PREFILL and ``max_seq_len``
    LONG_MAX_SEQ through ``build_engine``, LONG_LANES lanes, LONG_REQUESTS
    requests of about 4,000 tokens, drafted by copying from their own
    prompts (the shared trie's insertion of such a prompt takes minutes of
    host time: ROADMAP §C).  Checks: every output equals
    ``reference_decode`` at the serving batch shape, B3 launches once a
    layer per prefill, one packed pull per decode step, and no step function
    syncs the host.  Findings: the prefill's device time and B3's share of
    it (torch.profiler), tokens/s, and a decode step's tree attention (B1)
    over a cache of ~4,000 keys.  Returns B3's launches in the served run."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import reference_decode
    from repro_torch.core.draft_sources import DraftPolicy
    from repro_torch.core.request import SamplingParams
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.serving.api import (EngineConfig, ServingEngine,
                                         build_engine)
    from repro_torch.training.data import PROFILES, SyntheticCorpus
    cfg = dataclasses.replace(cfg, max_seq_len=LONG_MAX_SEQ)
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    ecfg = EngineConfig(lanes=LONG_LANES, prefill_len=LONG_PREFILL,
                        default_params=sp,
                        draft_policy=DraftPolicy(sources=("prompt_copy",)))
    transform = guided_transform(cfg.vocab_size)
    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=3)
    prompts = []
    for i in range(LONG_REQUESTS):
        p = []
        while len(p) < LONG_PROMPT - 40 * i:
            p += corpus.sample()[0]
        prompts.append(p[:LONG_PROMPT - 40 * i])
    fns = build_engine(ecfg, cfg, params, logits_transform=transform,
                       device="cuda").fns
    calls = {}

    def watched(name):
        member = no_sync(getattr(fns, name))

        def call(*args, **kwargs):
            calls[name] = calls.get(name, 0) + 1
            return member(*args, **kwargs)
        return call

    names = ("prefill", "prefill_into_slot", "fused_step")
    engine = ServingEngine(dataclasses.replace(
        fns, **{n: watched(n) for n in names}), ecfg)
    outs, launches, wall, tps, edl, fused = serve_counted(
        engine.scheduler, prompts, sp, {"flash_prefill": flash_prefill})
    st = engine.stats
    n_prefill = calls.get("prefill", 0) + calls.get("prefill_into_slot", 0)
    print(f"  {LONG_REQUESTS} requests of {[len(p) for p in prompts]} "
          f"tokens, {LONG_LANES} lanes, prefill_len {LONG_PREFILL}: "
          f"{sum(map(len, outs))} tokens in {wall:.3f} s -> {tps:.1f} "
          f"tokens/s; EDL {edl:.3f}; {st.decode_steps} decode steps, median "
          f"fused_step {fused:.3f} ms; {n_prefill} prefills, B3 launches "
          f"{launches['flash_prefill']}; no step function synced the host "
          f"(calls {calls})")
    check(n_prefill > 0 and launches["flash_prefill"]
          == cfg.n_layers * n_prefill,
          f"B3 launched {launches['flash_prefill']} times for {n_prefill} "
          f"prefills x {cfg.n_layers} layers")
    check(st.decode_syncs == st.decode_steps,
          f"{st.decode_syncs} decode syncs for {st.decode_steps} steps")
    check(all(len(o) == MAX_NEW for o in outs), "short outputs")
    for i, (p, o) in enumerate(zip(prompts, outs)):
        ref = reference_decode(fns, list(p), params=sp, lanes=LONG_LANES)
        check(o == ref, f"long prompt {i}: served output differs from "
                        f"reference_decode (first difference at token "
                        f"{first_difference(o, ref)})")
    print(f"  all {LONG_REQUESTS} outputs equal reference_decode at the "
          "serving batch shape")

    # the cohort prefill's device time, and B3's share of it
    toks = np.zeros((LONG_LANES, LONG_PREFILL), np.int32)
    lens = np.zeros((LONG_LANES,), np.int32)
    for b, p in enumerate(prompts[:LONG_LANES]):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    fns.prefill(toks, lens)
    torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        fns.prefill(toks, lens)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        fns.prefill(toks, lens)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    b3 = [e for e in kernels if "prefill_kernel" in e.key]
    b3_ms = sum(e.self_device_time_total for e in b3) / 1e3
    print(f"  cohort prefill ({LONG_LANES}, {LONG_PREFILL}): median "
          f"{float(np.median(walls)):.3f} ms (synchronized), device busy "
          f"{busy:.3f} ms over {sum(e.count for e in kernels)} launches; "
          f"B3 {b3_ms:.3f} ms over {sum(e.count for e in b3)} launches, "
          f"share {b3_ms / busy:.3f}")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in top[:5]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d} launches  {e.key[:90]}")
    del engine, fns
    profile_decode(ecfg, cfg, params, transform, prompts, sp, steps=3)
    return launches["flash_prefill"]


HOST_LAUNCH_APIS = ("Launch", "Memcpy", "Memset")   # runtime API names


def profile_decode(ecfg, cfg, params, transform, prompts, sp, steps=5,
                   cuda_graphs=True, label=""):
    """Where a decode step's time goes: a torch.profiler window over
    ``steps`` scheduler iterations that are pure decode (all lanes busy, no
    admission), after three (the cohort prefill and a step run eagerly, a
    step captures): wall time, device busy time and idle share, kernels
    a step on the device, the host's CUDA runtime calls that launch work (a
    kernel, a graph, a copy or a memset) a step, and the kernels that take
    the most device time (and the Gumbel-argmax kernel's).  ``sp`` is one
    SamplingParams for every lane or a list, one per lane.  Returns those
    numbers per step."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.api import build_engine
    from repro_torch.core.request import Request
    engine = build_engine(ecfg, cfg, params, logits_transform=transform,
                          device="cuda", cuda_graphs=cuda_graphs)
    sps = sp if isinstance(sp, list) else [sp] * ecfg.lanes
    for p, q in zip(prompts[:ecfg.lanes], sps):
        engine.submit(Request(prompt=list(p), params=q))
    for _ in range(3):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    api = {e.key: e.count for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("cu")
           and any(w in e.key for w in HOST_LAUNCH_APIS)}
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    n_launch = sum(e.count for e in kernels)
    n_api = sum(api.values())
    print(f"  profile of {steps} decode steps ({label or ''}"
          f"{ecfg.kv_layout} layout, {ecfg.lanes} lanes, T={ecfg.slots}, "
          f"{'captured' if cuda_graphs else 'eager'}): wall {wall:.2f} ms, "
          f"device busy {busy:.2f} ms, idle share {1 - busy / wall:.3f}, "
          f"{n_launch / steps:.0f} device kernels and {n_api / steps:.1f} "
          f"host launch calls per step "
          f"({', '.join(f'{k} {v / steps:.1f}' for k, v in sorted(api.items()))})")
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for e in top[:8] + [e for e in top[8:] if "gumbel" in e.key]:
        print(f"    {e.self_device_time_total / 1e3 / steps:8.3f} ms/step "
              f"{e.count / steps:6.0f} launches/step  {e.key[:90]}")
    # B1 / B2 (no prefill runs in this window, so every attention kernel is
    # tree attention)
    attn = [e for e in kernels if "attention_kernel" in e.key]
    attn_ms = sum(e.self_device_time_total for e in attn) / 1e3 / steps
    print(f"    tree attention (B1/B2): {attn_ms:.3f} ms/step over "
          f"{sum(e.count for e in attn) / steps:.0f} launches/step")
    return dict(wall=wall / steps, busy=busy / steps, idle=1 - busy / wall,
                kernels=n_launch / steps, host_launches=n_api / steps,
                attention=attn_ms)


# --------------------------------------------------------------- graphs
def logits_recorder(transform):
    """A logits transform that copies each call's step logits (before
    ``transform``) into a buffer of their shape, so that the logits of a
    member call can be read after it, captured or eager: captured, the copy
    is a node of the graph and fills the same buffer on every replay.  A
    shape's buffer is made on its first call, which runs eagerly (a key's
    first call always does)."""
    sinks = {}

    def fn(logits, tokens, positions):
        buf = sinks.get(tuple(logits.shape))
        if buf is None:
            buf = sinks[tuple(logits.shape)] = torch.empty_like(logits)
        buf.copy_(logits)
        return logits if transform is None else transform(logits, tokens,
                                                          positions)
    return fn, sinks


def kv_rows(cache, lane, lo, hi, bs):
    """Lane ``lane``'s K and V rows at positions [lo, hi), every layer."""
    if "block_tables" not in cache:
        return [cache[n][:, lane, lo:hi] for n in ("k", "v")]
    from repro_torch.models import transformer as tx
    pos = torch.arange(lo, hi, device=cache["k"].device)[None]
    rows = tx.paged_row_index(cache["block_tables"][lane:lane + 1], pos,
                              bs)[0]
    return [cache[n].flatten(1, 2)[:, rows] for n in ("k", "v")]


def random_drafts(rng, lens, T, vocab):
    """A random draft tree per lane (root at the lane's next position):
    tokens, positions, ancestor-closure mask, parents, live slots."""
    B = len(lens)
    tok = rng.randint(2, vocab, (B, T)).astype(np.int32)
    mask = np.zeros((B, T, T), bool)
    parent = np.full((B, T), -1, np.int32)
    for b in range(B):
        for i in range(1, T):
            parent[b, i] = rng.randint(0, i)
        for i in range(T):
            j = i
            while j >= 0:
                mask[b, i, j] = True
                j = parent[b, j]
    pos = (lens[:, None] + mask.sum(-1) - 1).astype(np.int32)
    return tok, pos, mask, parent, np.full((B,), T, np.int32)


def member_bits(label, ecfg, cfg, params, transform, prompts, sps):
    """Every member of a captured session against its eager twin on the
    same inputs, each call made three or more times (a key's first call
    runs eagerly, the second captures, later ones replay): the cohort
    prefill, fused steps, tree steps and commits, the padded admission in
    every lane (lane 0 twice), then, paged, three calls at each suffix
    bucket, three block copies and three block scrubs, or, dense, three
    lane scrubs.  Each call's outputs (chosen tokens, the packed step
    result, the new lengths) and step logits must be equal, and so must
    every K/V row the lanes hold below their length (after a copy or a
    scrub: the whole cache, the paged NULL block excepted, where duplicate
    garbage writes land in any order).  Returns (calls compared, the
    captured session)."""
    from repro_torch.serving.api import build_session_fns
    paged = ecfg.kv_layout == "paged"
    B, S, T = ecfg.lanes, ecfg.prefill_len, ecfg.slots
    sessions = []
    for graphs in (True, False):
        fn, sinks = logits_recorder(transform)
        sessions.append((build_session_fns(ecfg, cfg, params,
                                           logits_transform=fn,
                                           device="cuda",
                                           cuda_graphs=graphs), sinks))
    lp_all = {"greedy": np.asarray([not q.sample for q in sps[:B]]),
              "temp": np.asarray([q.temperature for q in sps[:B]],
                                 np.float32),
              "seed": np.asarray([q.seed for q in sps[:B]], np.uint32)}

    def lp(lanes):
        return {"lane_params": {k: v[lanes] for k, v in lp_all.items()}}

    toks = np.zeros((B, S), np.int32)
    lens = np.zeros((B,), np.int32)
    for b, p in enumerate(prompts[:B]):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    bpl = -(-cfg.max_seq_len // ecfg.block_size)
    tables = shuffled_tables([bpl] * B, bpl, seed=5).cpu().numpy()
    caches = [None, None]
    n_calls = 0

    def call(what, fn_name, rows, *args, **kw):
        """Run ``fn_name`` on both sessions (after the cache, if it takes
        one); compare outputs, logits and the K/V rows [lo, hi) of each
        (lane, lo, hi) that ``rows(result)`` lists, or the whole cache."""
        nonlocal n_calls
        outs = []
        for i, (fns, sinks) in enumerate(sessions):
            a = args if fn_name == "prefill" else (caches[i],) + args
            res = getattr(fns, fn_name)(*a, **kw)
            caches[i] = res[0] if isinstance(res, tuple) else res
            outs.append((res, {k: v.clone() for k, v in sinks.items()}))
        (rg, sg), (re_, se) = outs
        if isinstance(rg, tuple):
            for x, y in zip(rg[1:], re_[1:]):
                check(torch.equal(x, y), f"{label}, {what}: output differs "
                                         "captured vs eager")
        for k in se:
            check(torch.equal(sg[k], se[k]), f"{label}, {what}: logits "
                                             f"{k} differ captured vs eager")
        if rows is None:
            for name in ("k", "v"):
                x, y = caches[0][name], caches[1][name]
                if paged:
                    x, y = x[:, 1:], y[:, 1:]
                check(torch.equal(x, y), f"{label}, {what}: {name} cache "
                                         "differs captured vs eager")
        else:
            for lane, lo, hi in rows(rg):
                for x, y in zip(*(kv_rows(c, lane, lo, hi, ecfg.block_size)
                                  for c in caches)):
                    check(torch.equal(x, y), f"{label}, {what}: lane {lane} "
                                             f"K/V rows [{lo}, {hi}) differ")
        n_calls += 1
        return rg

    def below(extra):
        return lambda res: [(b, 0, int(lens[b] + extra(res)[b]))
                            for b in range(B)]

    for i in range(3):
        args = (toks, lens, tables) if paged else (toks, lens)
        call(f"cohort prefill {i}", "prefill", below(lambda r: [0] * B),
             *args, **lp(slice(0, B)))
    rng = np.random.RandomState(7)
    for i in range(3):
        res = call(f"fused step {i}", "fused_step",
                   below(lambda r: r[1][:, 0].cpu().numpy()), lens,
                   *random_drafts(rng, lens, T, cfg.vocab_size),
                   **lp(slice(0, B)))
        lens = lens + res[1][:, 0].cpu().numpy().astype(np.int32)
    n_acc = np.asarray([1, 2, 3, 0][:B] + [1] * (B - 4), np.int32)
    gather = np.tile(np.arange(T, dtype=np.int32), (B, 1))
    for i in range(3):
        tok, pos, mask, _, _ = random_drafts(rng, lens, T, cfg.vocab_size)
        call(f"tree step {i}", "tree_step", below(lambda r: [T] * B), lens,
             tok, pos, mask, **lp(slice(0, B)))
        res = call(f"commit {i}", "commit", below(lambda r: n_acc), lens,
                   gather, n_acc)
        lens = res[1].cpu().numpy().astype(np.int32)
    for lane in list(range(B)) + [0]:
        n = len(prompts[lane])
        call(f"admission in lane {lane}", "prefill_into_slot",
             lambda res, lane=lane, n=n: [(lane, 0, n)], lane,
             toks[lane:lane + 1], np.asarray([n], np.int32),
             **lp(slice(lane, lane + 1)))
        lens[lane] = n
    if paged:
        src = prompts[1]
        for bucket in sessions[0][0].suffix_buckets:
            n = bucket - 3
            offset = S - bucket
            tail = np.asarray([(src * 2)[offset:offset + n]], np.int32)
            for i in range(3):
                call(f"suffix bucket {bucket} ({i})", "prefill_suffix",
                     lambda res, o=offset, n=n: [(1, o, o + n)], 1, tail,
                     offset, **lp(slice(1, 2)))
        for i in range(3):
            call(f"block copy {i}", "copy_block", None,
                 int(tables[0, i]), int(tables[B - 1, bpl - 1 - i]))
        for i in range(3):
            ids = np.zeros((bpl,), np.int32)
            ids[:2] = tables[B - 1, bpl - 1 - i], tables[B - 1, bpl - 4 - i]
            call(f"block scrub {i}", "reset_blocks", None, ids)
    else:
        for lane in (B - 1, B - 2, B - 1):
            call(f"lane scrub {lane}", "reset_slot", None, lane)
    torch.cuda.synchronize()
    return n_calls, sessions[0][0]


ATTENTION_KERNELS = ("attention_kernel", "prefill_kernel")  # B1-B4's names


def profiled_ms(fn, calls=6):
    """Device time a call of ``fn(i)`` in one torch.profiler window of
    ``calls`` calls after a warm one: every device event (kernels and
    copies), the events a call, and the attention kernels' device time a
    call."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    attn = [e for e in ev if any(n in e.key for n in ATTENTION_KERNELS)]
    return (sum(e.self_device_time_total for e in ev) / 1e3 / calls,
            sum(e.count for e in ev) / calls,
            sum(e.self_device_time_total for e in attn) / 1e3 / calls)


def serve_turns(label, ecfg, cfg, params, transform, prompts, sps):
    """One cell served by the captured session and its eager twin in
    turns: a warm-up run each, then captured, eager (one timed run a
    side: cut from two for (h)'s time).
    Every run must give the same outputs and one decode sync a step.
    Returns (captured, eager) lists of (median fused_step ms, tokens/s,
    EDL), and the captured session."""
    from repro_torch.serving.api import ServingEngine, build_session_fns
    fns = {g: build_session_fns(ecfg, cfg, params, logits_transform=transform,
                                device="cuda", cuda_graphs=g)
           for g in (True, False)}
    first, runs = None, {True: [], False: []}
    for i, graphs in enumerate((True, False, True, False)):
        engine = ServingEngine(fns[graphs], ecfg)
        outs, _, _, tps, edl, fused = serve_counted(engine.scheduler,
                                                    prompts, sps, {})
        first = outs if first is None else first
        check(outs == first, f"{label}: outputs differ between the captured "
                             "and the eager session's runs")
        st = engine.stats
        check(st.decode_syncs == st.decode_steps,
              f"{label}: {st.decode_syncs} decode syncs for "
              f"{st.decode_steps} steps")
        if i >= 2:                          # the two warm-up runs excluded
            runs[graphs].append((fused, tps, edl))
    return runs[True], runs[False], fns[True]


GRAPHS_LAYERS = 7             # the graphs phase's depth cut 28 -> 7 (time)


def graphs_turns(label, ecfg, cfg, params, transform, ps, sps):
    """One cell served in turns captured and eager (``serve_turns``) and a
    profile of decode steps each way, printed; returns the captured
    session."""
    captured, eager, fns = serve_turns(label, ecfg, cfg, params, transform,
                                       ps, sps)
    prof = {g: profile_decode(ecfg, cfg, params, transform, ps,
                              sps[:ecfg.lanes], cuda_graphs=g,
                              label=f"{label}, ")
            for g in (True, False)}
    med = {g: float(np.median([r[0] for r in runs]))
           for g, runs in ((True, captured), (False, eager))}
    for g, runs in ((True, captured), (False, eager)):
        print(f"  {label}, {'captured' if g else 'eager'} in turns: "
              f"median fused_step {med[g]:.3f} ms (runs "
              f"{', '.join(f'{r[0]:.3f}' for r in runs)}), tokens/s "
              f"{', '.join(f'{r[1]:.1f}' for r in runs)}, EDL "
              f"{runs[0][2]:.3f}; profile: busy {prof[g]['busy']:.3f} "
              f"ms, idle {prof[g]['idle']:.3f}, "
              f"{prof[g]['kernels']:.0f} device kernels and "
              f"{prof[g]['host_launches']:.1f} host launch calls a step")
    print(f"  {label}: captured / eager median fused_step "
          f"{med[True] / med[False]:.3f}")
    return fns


def graphs_phase(cfg, params):
    """Captured members against the eager twin (``cuda_graphs=False``) on
    the guided dense and paged cells and the mixed sampled cell: member
    bits (``member_bits``), serving in turns (``serve_turns``: outputs
    equal; median fused_step, tokens/s, EDL), a profile of decode steps
    each way (device busy, idle share, device kernels and host launch calls
    a step), each captured member's capture time and graph pool memory,
    and the prefill's device time with the prefix cache on (suffix
    prefill) and off (padded admission) beside the cohort prefill's; the
    model's depth cut to GRAPHS_LAYERS (its first layers)."""
    from repro_torch.core.request import SamplingParams
    from repro_torch.serving.api import EngineConfig
    print(f"  [graphs: depth cut to {GRAPHS_LAYERS} of {cfg.n_layers} "
          "layers]")
    cfg = dataclasses.replace(cfg, n_layers=GRAPHS_LAYERS)
    params = dict(params, layers={k: v[:GRAPHS_LAYERS]
                                  for k, v in params["layers"].items()})
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    guided = guided_transform(cfg.vocab_size)
    prompts = path_prompts(cfg.vocab_size)
    mixed_prompts, mixed_sps = sampled_requests(cfg.vocab_size, N_REQUESTS,
                                                4, True)
    paged = dict(kv_layout="paged", block_size=PATH_PAGED[5])
    cells = (("guided dense", EngineConfig(default_params=sp), guided,
              prompts, [sp] * len(prompts)),
             ("guided paged", EngineConfig(default_params=sp, **paged),
              guided, prompts, [sp] * len(prompts)),
             ("mixed sampled paged", EngineConfig(**paged), None,
              mixed_prompts, mixed_sps))
    for label, ecfg, transform, ps, sps in cells:
        n, bits_fns = member_bits(label, ecfg, cfg, params, transform, ps,
                                  sps)
        print(f"  {label}: {n} member calls bit-equal captured vs eager "
              "(outputs, step logits, K/V rows below each lane's length; "
              "the whole cache after copies and scrubs)")
        fns = graphs_turns(label, ecfg, cfg, params, transform, ps, sps)
        for name in ("prefill", "prefill_into_slot", "fused_step",
                     "tree_step", "commit", "prefill_suffix", "copy_block",
                     "reset_blocks", "reset_slot"):
            caps = []
            for f in (bits_fns, fns):
                m = getattr(f, name, None)
                caps += getattr(getattr(m, "member", m), "captures", [])
            if caps:
                s = [c[0] * 1e3 for c in caps]
                mb = [c[1] / 2**20 for c in caps]
                print(f"    {name}: {len(s)} captures, capture ms median "
                      f"{float(np.median(s)):.1f} (max {max(s):.1f}), graph "
                      f"pool MB median {float(np.median(mb)):.1f} (max "
                      f"{max(mb):.1f})")
        del bits_fns, fns

    # the prefill's device time with the prefix cache off (the padded
    # admission, (4, 128)) and on (the suffix prefill of a 16-token tail
    # after an 80-token hit, bucket 16), beside the cohort prefill
    from repro_torch.serving.api import build_session_fns
    ecfg = cells[1][1]
    B, S = ecfg.lanes, ecfg.prefill_len
    toks = np.zeros((B, S), np.int32)
    lens = np.zeros((B,), np.int32)
    for b, p in enumerate(prompts[:B]):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    bpl = -(-cfg.max_seq_len // ecfg.block_size)
    tables = shuffled_tables([bpl] * B, bpl, seed=6).cpu().numpy()
    tail = np.asarray([list(prompts[1][SHARED_HEAD:SHARED_HEAD
                                        + SHARED_TAIL])], np.int32)
    for graphs in (True, False):
        fns = build_session_fns(ecfg, cfg, params, logits_transform=guided,
                                device="cuda", cuda_graphs=graphs)
        for _ in range(2):       # eager, then captured: outside the windows
            cache, _ = fns.prefill(toks, lens, tables)
        for _ in range(2):
            fns.prefill_into_slot(cache, 1, toks[1:2], lens[1:2])
            fns.prefill_suffix(cache, 1, tail, SHARED_HEAD)
        ms = dict(
            cohort=profiled_ms(lambda i: fns.prefill(toks, lens, tables)),
            off=profiled_ms(lambda i: fns.prefill_into_slot(
                cache, 1, toks[1:2], lens[1:2])),
            on=profiled_ms(lambda i: fns.prefill_suffix(
                cache, 1, tail, SHARED_HEAD)))
        print(f"  prefill device time, {'captured' if graphs else 'eager'} "
              f"(guided paged): cohort ({B}, {S}) {ms['cohort'][0]:.3f} ms "
              f"({ms['cohort'][1]:.0f} device events); admission with the "
              f"prefix cache off (padded ({B}, {S})) {ms['off'][0]:.3f} ms "
              f"({ms['off'][1]:.0f}), on (suffix of {SHARED_TAIL} after "
              f"{SHARED_HEAD} cached, bucket 16) {ms['on'][0]:.3f} ms "
              f"({ms['on'][1]:.0f})")
        del fns, cache


# --------------------------------------------------------------- fleet
FLEET_NS = ("docs", "code")     # homes r1 and r0 on a 2-replica ring
FLEET_QUEUE_DEPTH = 3           # the hot namespace's home fills and spills
FLEET_GOSSIP_EVERY = 2
N_SUBPROCESS = 4                # requests served by the spawned replica


def fleet_engine():
    """The fleet phase's replica: Qwen2-1.5B at full width in bf16 with
    weights from seed 0, guided, captured members, the serve CLI's
    defaults.  A module-level function, so that a spawned replica can
    unpickle it and build the engine in its own process; the device is left
    at None (the card: it raises without one)."""
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.core.request import SamplingParams
    from repro_torch.models.params import init_params
    from repro_torch.serving.api import EngineConfig, build_engine
    cfg = dataclasses.replace(full_config(), dtype="bfloat16",
                              param_dtype="bfloat16")
    return build_engine(
        EngineConfig(default_params=SamplingParams(max_new_tokens=MAX_NEW)),
        cfg, init_params(cfg, seed=0), logits_transform=guided_transform(
            cfg.vocab_size))


def fleet_requests(vocab):
    """The guided cells' 8 prompts in two namespaces, unevenly (6 and 2),
    each request drafting from its namespace's trie."""
    from repro_torch.core import DraftPolicy
    from repro_torch.core.request import SamplingParams
    ns = [FLEET_NS[0] if i % 4 else FLEET_NS[1] for i in range(N_REQUESTS)]
    return path_prompts(vocab), [
        SamplingParams(max_new_tokens=MAX_NEW,
                       draft=DraftPolicy(namespace=n).validate())
        for n in ns]


def drive_fleet(router, gossip, prompts, sps):
    """Submit every request at once, then step the fleet and tick gossip
    until it is idle; returns (these requests' outputs in submission
    order, wall s, s spent in gossip ticks)."""
    torch.cuda.synchronize()
    n0 = len(router.placements)
    t_gossip = 0.0
    t0 = time.perf_counter()
    for p, sp in zip(prompts, sps):
        router.submit(p, sp)
    while not router.idle:
        router.step_all()
        t1 = time.perf_counter()
        gossip.tick()
        t_gossip += time.perf_counter() - t1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return [router.result(i)["tokens"]
            for i in range(n0, len(router.placements))], wall, t_gossip


def fleet_phase(cfg, params):
    """Fleet serving (``repro_torch.fleet``) at full width, guided, on
    captured members.  (a) Two in-process replicas behind the affinity
    router, two namespaces, a queue depth that makes the hot namespace
    spill, gossip every 2 rounds: every output equals one engine's and
    reference_decode at the serving batch shape, and B1 launches 28 times
    a decode step summed over both replicas (the counters are per
    process).  Each side then serves the requests again, its graphs
    captured and its tries warm, for the tokens/s finding, and a fleet
    without gossip serves them twice.  (b) The
    serve CLI with --replicas 2 --verify-fleet
    --warm-state --sanitize on the paged layout with the prefix cache.
    (c) That warm-state file loads into a fresh paged engine with the
    prefix cache on: its first requests that share a persisted prefix hit
    the cache, and their outputs equal an engine's without warm state.
    (d) One
    replica in a spawned process builds its engine on the card and serves
    4 requests with the in-process replica's tokens; closing it ends the
    child and frees its memory.  Tokens/s of the fleet beside one
    engine's are a finding."""
    from repro_torch.core import reference_decode
    from repro_torch.core.request import Request
    from repro_torch.fleet import (EngineReplica, FleetRouter,
                                   GossipCoordinator, load_draft_state)
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.tree_attention.ops import tree_attention
    from repro_torch.kernels.tree_attention.paged import paged_tree_attention
    from repro_torch.launch import serve
    from repro_torch.serving.api import EngineConfig, build_engine
    from repro_torch.core.request import SamplingParams

    L = cfg.n_layers
    transform = guided_transform(cfg.vocab_size)
    ecfg = EngineConfig(default_params=SamplingParams(max_new_tokens=MAX_NEW))
    prompts, sps = fleet_requests(cfg.vocab_size)

    def builder():
        return build_engine(ecfg, cfg, params, logits_transform=transform,
                            device="cuda")

    # (a) one engine, then the 2-replica fleet on the same requests
    single = builder()
    outs, _, wall1, tps1, edl1, fused1 = serve_counted(
        single.scheduler, prompts, sps, {})
    print(f"  one engine, {len(prompts)} requests in 2 namespaces: "
          f"{sum(map(len, outs))} tokens in {wall1:.3f} s -> {tps1:.1f} "
          f"tokens/s; EDL {edl1:.3f}; {single.stats.decode_steps} decode "
          f"steps, median fused_step {fused1:.3f} ms")
    replicas = [EngineReplica(builder, replica_id=f"r{i}") for i in range(2)]
    router = FleetRouter(replicas, policy="affinity",
                         max_queue_depth=FLEET_QUEUE_DEPTH)
    gossip = GossipCoordinator(replicas, every=FLEET_GOSSIP_EVERY)
    for fn in (tree_attention, paged_tree_attention, flash_prefill):
        fn.launches = 0
    fleet_outs, wall2, t_gossip = drive_fleet(router, gossip, prompts, sps)
    launches = {n: fn.launches for n, fn in (
        ("tree_attention", tree_attention),
        ("paged_tree_attention", paged_tree_attention),
        ("flash_prefill", flash_prefill))}
    fs = router.fleet_stats()
    steps = [int(s["decode_steps"]) for s in fs.replicas]
    n_tok = sum(map(len, fleet_outs))
    print(f"  fleet, 2 in-process replicas (affinity, queue depth "
          f"{FLEET_QUEUE_DEPTH}, gossip every {FLEET_GOSSIP_EVERY}): "
          f"{n_tok} tokens in {wall2:.3f} s -> {n_tok / wall2:.1f} tokens/s "
          f"({n_tok / wall2 / tps1:.3f} of one engine's); routed "
          f"{fs.routed} ({fs.affinity_hits} at home, {fs.spills} spilled), "
          f"{gossip.exchanges} gossip exchanges in {t_gossip * 1e3:.1f} ms; "
          f"decode steps {steps}; "
          f"finished {[s['finished'] for s in fs.replicas]}; trie nodes "
          f"{[s['trie_nodes'] for s in fs.replicas]}; launches {launches}")
    for ns, accs in sorted(fs.source_acceptance().items()):
        print(f"    acceptance [{ns}]: "
              + ", ".join(f"{k} {v:.3f}" for k, v in sorted(accs.items())))
    check(fs.spills >= 1, f"no request spilled at queue depth "
                          f"{FLEET_QUEUE_DEPTH}: {fs.ns_routed}")
    check(gossip.exchanges >= 1, "gossip never ran")
    check(all(n > 0 for n in steps), f"a replica never stepped: {steps}")
    check(launches["tree_attention"] == L * sum(steps) > 0,
          f"tree_attention launched {launches['tree_attention']} times for "
          f"{sum(steps)} decode steps x {L} layers over both replicas")
    check(launches["paged_tree_attention"] == 0,
          f"paged_tree_attention launched on the dense fleet: {launches}")
    check(fleet_outs == outs, "fleet outputs differ from one engine's: "
          + str([first_difference(a, b) for a, b in zip(fleet_outs, outs)]))
    for i, (p, sp, o) in enumerate(zip(prompts, sps, outs)):
        ref = reference_decode(single.fns, list(p), params=sp,
                               lanes=ecfg.lanes)
        check(o == ref, f"fleet request {i} differs from reference_decode "
                        f"(first difference at {first_difference(o, ref)})")
    print(f"  all {len(prompts)} fleet outputs equal one engine's and "
          f"reference_decode(..., lanes={ecfg.lanes})")
    # the same requests again on each side, graphs captured, tries warm
    outs2, _, wall1, tps1, edl1, fused1 = serve_counted(
        single.scheduler, prompts, sps, {})
    n_ex = gossip.exchanges
    fleet2, wall2, t_gossip = drive_fleet(router, gossip, prompts, sps)
    check(outs2 == outs and fleet2 == outs, "a second pass changed outputs")
    n_tok = sum(map(len, outs))
    n_ex = gossip.exchanges - n_ex
    steps = [int(s["decode_steps"]) - n for s, n in
             zip(router.fleet_stats().replicas, steps)]
    print(f"  second pass, warm: one engine {tps1:.1f} tokens/s ({wall1:.3f} "
          f"s, EDL {edl1:.3f}, median fused_step {fused1:.3f} ms); fleet "
          f"{n_tok / wall2:.1f} tokens/s ({wall2:.3f} s, "
          f"{n_tok / wall2 / tps1:.3f} of one engine's, decode steps "
          f"{steps}), {n_ex} gossip exchanges in {t_gossip * 1e3:.1f} ms "
          f"({t_gossip * 1e3 / max(n_ex, 1):.2f} ms each)")
    router.close()
    # the same two passes through a fleet without gossip (ROADMAP §C:
    # gossip during serving keeps the tries cold)
    quiet = [EngineReplica(builder, replica_id=f"r{i}") for i in range(2)]
    qrouter = FleetRouter(quiet, policy="affinity",
                          max_queue_depth=FLEET_QUEUE_DEPTH)
    qsteps = []
    for _ in range(2):
        before = [int(s["decode_steps"])
                  for s in qrouter.fleet_stats().replicas]
        q_outs, q_wall, _ = drive_fleet(
            qrouter, GossipCoordinator(quiet, every=0), prompts, sps)
        check(q_outs == outs, "the fleet without gossip changed outputs")
        qsteps.append([int(s["decode_steps"]) - b for s, b in
                       zip(qrouter.fleet_stats().replicas, before)])
    print(f"  without gossip: decode steps {qsteps[0]} then {qsteps[1]}; "
          f"second pass {n_tok / q_wall:.1f} tokens/s "
          f"({n_tok / q_wall / tps1:.3f} of one engine's)")
    qrouter.close()
    del router, gossip, replicas, qrouter, quiet, single

    # (b) the serve CLI: 2 replicas, verify, warm state saved at exit
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(ROOT, "build", "fleet_warm_state.json")
    if os.path.exists(path):
        os.remove(path)
    argv = ["--replicas", "2", "--routing", "affinity", "--gossip-every",
            str(FLEET_GOSSIP_EVERY), "--fleet-queue-depth",
            str(FLEET_QUEUE_DEPTH), "--verify-fleet", "--warm-state", path,
            "--trie-namespace-key", "tenant", "--kv-layout", "paged",
            "--block-size", str(PATH_PAGED[5]), "--prefix-cache",
            "--shared-prefix", str(SHARED_HEAD), "--requests",
            str(N_REQUESTS), "--max-new", str(MAX_NEW), "--sanitize"]
    print(f"  serve CLI: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    serve.main(argv)
    print(f"  serve CLI: {time.perf_counter() - t0:.1f} s")
    payload = load_draft_state(path)
    keys = payload.get("prefix", {})
    check(bool(keys) and set(payload["sources"]) >= {"trie"},
          f"the CLI's warm state holds no prefix keys or no trie: "
          f"{sorted(payload)} {sorted(keys)}")

    # (c) the file into a fresh paged engine with the prefix cache on
    pcfg = EngineConfig(kv_layout="paged", block_size=PATH_PAGED[5],
                        prefix_cache=True,
                        default_params=SamplingParams(max_new_tokens=MAX_NEW))
    from repro_torch.core import DraftPolicy
    from repro_torch.training.data import PROFILES, SyntheticCorpus
    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=7)
    warm_reqs = [(list(chains[0][:SHARED_HEAD])
                  + corpus.sample()[0][:SHARED_TAIL],
                  SamplingParams(max_new_tokens=MAX_NEW, draft=DraftPolicy(
                      namespace=ns).validate()))
                 for ns, chains in sorted(keys.items()) for _ in range(2)]
    runs = {}
    for warm in (True, False):
        engine = build_engine(pcfg, cfg, params, logits_transform=transform,
                              device="cuda")
        if warm:
            engine.load_draft_state(path)
        base = engine.stats.prefix_hits
        handles = [engine.submit(Request(prompt=p, params=sp))
                   for p, sp in warm_reqs]
        engine.run()
        runs[warm] = ([h.result().tokens for h in handles],
                      engine.stats.prefix_hits - base,
                      engine.stats.prefix_hit_tokens)
        print(f"  warm state {'loaded' if warm else 'absent'}: "
              f"{len(warm_reqs)} requests sharing a persisted prefix "
              f"({', '.join(sorted(keys))}); {runs[warm][1]} prefix hits")
    check(runs[True][1] > 0, "the warm engine's first requests never hit a "
                             "primed prefix")
    check(runs[True][0] == runs[False][0], "outputs with warm state differ "
                                           "from the engine without it")
    print("  warm-state outputs equal the engine's without warm state")
    del engine

    # (d) one replica in a spawned process, built on the card there
    sp_sub = sps[:N_SUBPROCESS]

    def serve_twice(rep):
        """The 4 requests twice (the second pass with graphs captured):
        (outputs of each pass, s a pass)."""
        outs, secs = [], []
        for _ in range(2):
            rids = [rep.submit(p, sp) for p, sp in zip(prompts, sp_sub)]
            t0 = time.perf_counter()
            rep.drain()
            secs.append(time.perf_counter() - t0)
            outs.append([rep.result(r)["tokens"] for r in rids])
        return outs, secs

    inproc = EngineReplica(fleet_engine, replica_id="in")
    ref, t_in = serve_twice(inproc)
    del inproc
    t0 = time.perf_counter()
    sub = EngineReplica(fleet_engine, replica_id="sub", mode="subprocess")
    t_spawn = time.perf_counter() - t0
    proc = sub._proc
    try:
        got, t_sub = serve_twice(sub)
        free_open = torch.cuda.mem_get_info()[0]
    finally:
        sub.close()
    free_closed = torch.cuda.mem_get_info()[0]
    n_tok = sum(map(len, got[0]))
    print(f"  subprocess replica (pid {proc.pid}): built in {t_spawn:.1f} s "
          f"(spawn, imports, weights, engine); {N_SUBPROCESS} requests, "
          f"{n_tok} tokens in {t_sub[0]:.3f} s (first calls capture), "
          f"then {t_sub[1]:.3f} s, against {t_in[0]:.3f} and {t_in[1]:.3f} "
          f"s in process; device memory free "
          f"{free_open / 2**30:.2f} GiB before close, "
          f"{free_closed / 2**30:.2f} GiB after")
    check(got == ref, "the subprocess replica's tokens differ from the "
                      "in-process replica's")
    check(not proc.is_alive() and sub.exitcode == 0,
          f"the subprocess replica did not exit cleanly ({sub.exitcode})")
    check(free_closed - free_open > 2**30, "closing the subprocess replica "
                                           "freed under 1 GiB on the card")
    print(f"  the subprocess replica's {N_SUBPROCESS} outputs equal the "
          "in-process replica's; the child exited and its memory is free")


# --------------------------------------------------------------- sanitize
def sanitize_phase(cfg, params):
    """The runtime sanitizer on the card, captured members: the guided
    paged cell with the prefix cache on (the shared-prefix workload) and
    the mixed sampled paged cell, both with ``scrub_freed``, served
    without and with ``sanitize=True``.  Outputs must be equal bit for
    bit, the idle audit must pass (lifecycles drained, shadow ledger equal
    to the allocator, retrace deltas within the manifest), and the poison
    probe must have read scrubbed blocks.  Then a write planted into a
    freed, scrubbed block on the card must raise InvariantViolation at the
    next admission.  The sanitized median fused_step beside the
    unsanitized one is a finding (the sanitizer's cost)."""
    from repro_torch.analysis.sanitizer import InvariantViolation
    from repro_torch.core.request import SamplingParams
    from repro_torch.serving.api import EngineConfig, build_engine
    from repro_torch.training.data import PROFILES, SyntheticCorpus
    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=1)
    head = corpus.sample()[0][:SHARED_HEAD]
    shared = [head + corpus.sample()[0][:SHARED_TAIL]
              for _ in range(N_SHARED)]
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    mixed, mixed_sps = sampled_requests(cfg.vocab_size, N_REQUESTS, 4, True)
    cells = (("guided paged, prefix cache", dict(prefix_cache=True),
              guided_transform(cfg.vocab_size), shared, sp),
             ("mixed sampled paged", {}, None, mixed, mixed_sps))
    for label, extra, transform, prompts, sps in cells:
        runs = {}
        for sanitize in (False, True):
            ecfg = EngineConfig(kv_layout="paged", block_size=PATH_PAGED[5],
                                scrub_freed=True, sanitize=sanitize,
                                default_params=sp, **extra)
            engine = build_engine(ecfg, cfg, params,
                                  logits_transform=transform, device="cuda")
            outs, _, wall, tps, edl, fused = serve_counted(
                engine.scheduler, prompts, sps, {})
            runs[sanitize] = (outs, fused, tps)
        san = engine.scheduler.sanitizer
        led = san.ledger
        deltas = {n: c - san.retrace._base[n]
                  for n, c in san.retrace._counts().items()
                  if c > san.retrace._base[n]}
        print(f"  {label}, {len(prompts)} requests: median fused_step "
              f"{runs[False][1]:.3f} ms unsanitized, {runs[True][1]:.3f} ms "
              f"sanitized; tokens/s {runs[False][2]:.1f} / "
              f"{runs[True][2]:.1f}; audit clean: "
              f"{len(san.lifecycle._state)} lifecycles drained, "
              f"{led.probes} poison probes read {led.probed_blocks} "
              f"scrubbed blocks, new signatures {deltas} within the "
              "manifest")
        check(runs[True][0] == runs[False][0],
              f"{label}: sanitized outputs differ from the unsanitized run")
        check(led.probed_blocks > 0, f"{label}: the poison probe never ran")
    # a write planted into a freed, scrubbed block of the last engine
    sched = engine.scheduler
    poisoned = sorted(led.poisoned)
    check(bool(poisoned), "no freed, scrubbed block to plant a write in")
    b = poisoned[len(poisoned) // 2]
    sched.cache["k"][cfg.n_layers // 2, b] = 1
    engine.submit(mixed[0], params=mixed_sps[0])
    try:
        engine.step()
    except InvariantViolation as exc:
        check(f"block {b} has nonzero 'k'" in str(exc),
              f"the planted write raised for another block: {exc}")
        print(f"  a write planted into freed, scrubbed block {b} (of "
              f"{len(poisoned)}) raised at the next admission: {exc}")
    else:
        raise SmokeError("a write into a freed, scrubbed block was not "
                         "caught at the next admission")


# --------------------------------------------------------------- archs
ARCH_TEMPS = (0.6, 0.78, 0.96, 1.14, 1.32, 1.5)   # AntGLM's sampled cell
N_PRIMED = 2            # strategies cell: requests served beside a primer


def archs_phase(names=OTHER_ARCHS):
    """The reference's other LMs (``OTHER_ARCHS``: AntGLM-10B, Phi-3-mini,
    Phi-3-medium; ``MOE_ARCHS``: Qwen3-MoE-30B-A3B, Moonlight-16B-A3B),
    one after another, at full width in bf16 with weights drawn from seed
    0 on the card, each freed before the next.  Returns each arch's
    numbers."""
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    print(f"  {base / 1e9:.2f} GB allocated and "
          f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved before the "
          "first arch")
    rows = {}
    for name in names:
        t0 = time.perf_counter()
        rows[name] = serve_arch(name)
        left = torch.cuda.memory_allocated() - base
        torch.cuda.empty_cache()
        print(f"  [{name}: {time.perf_counter() - t0:.1f} s; "
              f"{left / 1e9:.3f} GB still allocated after it; "
              f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved]")
        check(left < 1e9, f"{name}: {left / 1e9:.2f} GB not freed")
    return rows


def serve_arch(name):
    """One arch: (a) the guided dense cell, (b) the same requests paged
    (``guided_cell``, reference_decode at the serving batch shape), each
    with a profile of decode steps, and the cohort prefill's device time;
    for AntGLM-10B (the paper's model) also (c) the default Lookahead
    config, LLMA's single branch and step by step on (a)'s requests and
    (d) a sampled paged cell, unguided; for an MoE arch first the MoE
    module at one layer's full width (``moe_module``)."""
    from repro_torch.configs import get_arch
    from repro_torch.core.request import SamplingParams
    from repro_torch.models.params import init_params
    from repro_torch.serving.api import EngineConfig
    full = get_arch(name).full_config()
    cfg = dataclasses.replace(full, dtype="bfloat16", param_dtype="bfloat16",
                              n_layers=full.n_layers // ARCH_DEPTH_DIV)
    print(f"  [{name}: depth cut to {cfg.n_layers} of {full.n_layers} "
          "layers]")
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n = sum(t.numel() for t in [*params["layers"].values(),
                                *(v for k, v in params.items()
                                  if k != "layers")])
    print(f"  {name} full width bf16: {n / 1e9:.3f} B params "
          f"({2 * n / 1e9:.2f} GB) made on the card in "
          f"{time.perf_counter() - t0:.1f} s; peak memory while drawing "
          f"them {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(n == cfg.n_params(), f"{name}: {n} parameters drawn, the config "
                               f"counts {cfg.n_params()}")
    row = {"params": n}
    if cfg.moe:
        over = torch.cuda.max_memory_allocated() - before - 2 * n
        print(f"  {name}: the draw's peak exceeds the weights (and the "
              f"{before / 1e9:.3f} GB allocated before it) by "
              f"{over / 1e9:.3f} GB (expert tensors drawn a layer at a time)")
        check(over < MOE_DRAW_OVER, f"{name}: the draw's peak exceeds the "
                                    f"weights by {over / 1e9:.2f} GB")
        row["module"] = moe_module(name, cfg, params)
    sp = SamplingParams(max_new_tokens=MAX_NEW)
    transform = guided_transform(cfg.vocab_size)
    dense = EngineConfig(default_params=sp)
    prompts = path_prompts(cfg.vocab_size)[:dense.lanes + 2]
    for ecfg in (dense, dataclasses.replace(dense, kv_layout="paged",
                                            block_size=PATH_PAGED[5])):
        got, _, row[ecfg.kv_layout], engine = guided_cell(
            name, ecfg, cfg, params, transform, prompts, sp,
            ref_lanes=ecfg.lanes)
        del engine
        row[ecfg.kv_layout].update(profile_decode(
            ecfg, cfg, params, transform, prompts, sp, label=f"{name}, "))
        if ecfg is dense:
            outs = got
    check(got == outs, f"{name}: paged outputs differ from dense")
    print(f"  {name}: paged outputs equal the dense layout's")
    row["prefill"] = arch_prefill(name, dense, cfg, params, transform,
                                  prompts)
    if name in SAMPLED_ARCHS:
        row["strategies"] = strategies_cell(name, cfg, params, transform,
                                            prompts, sp, outs)
        row["sampled"] = arch_sampled_cell(name, cfg, params)
    row["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {name}: peak memory {row['peak_gb']:.2f} GB")
    return row


def moe_module(name, cfg, params):
    """The MoE FFN at one layer's full width on layer 0's weights, at a
    decode step's rows (4 lanes x T 33 = 132), bf16: ``moe_ref`` against
    a per-token f32 formula (each token's top-k experts gathered, their
    SwiGLU in f32 weighted by the same f32 router's weights and summed),
    and ``moe_local`` at a capacity factor of E / top_k (capacity >= the
    rows, so nothing is dropped) against ``moe_ref``, within MOE_TOL.
    Then the device time of a decode step's MoE FFNs: every layer's
    ``_ffn`` (router, experts, shared experts) at (4, 33, d)."""
    from repro_torch.models import moe
    from repro_torch.models.transformer import _ffn
    silu = torch.nn.functional.silu
    B, T = PATH_TREE[:2]
    N, E, k = B * T, cfg.n_experts, cfg.top_k
    lp = {key: a[0] for key, a in params["layers"].items()}
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    x = randn(gen, (N, cfg.d_model), torch.bfloat16, scale=1.0)
    args = (x, lp["router"], lp["we_gate"], lp["we_up"], lp["we_down"], k)
    out = moe.moe_ref(*args)
    w, idx = moe.router_topk(x, lp["router"], k)
    xf, ref = x.float(), torch.zeros((N, cfg.d_model), device="cuda")
    for e in range(E):
        rows, slot = (idx == e).nonzero(as_tuple=True)
        xe = xf[rows]
        h = silu(xe @ lp["we_gate"][e].float()) * (xe @ lp["we_up"][e].float())
        ref.index_add_(0, rows,
                       (h @ lp["we_down"][e].float()) * w[rows, slot, None])
    local = moe.moe_local(*args, capacity_factor=E / k)
    torch.cuda.synchronize()
    err = (out.float() - ref).abs().max().item()
    err_local = (local.float() - out.float()).abs().max().item()
    print(f"  {name}: moe_ref bf16 (N {N}, d {cfg.d_model}, E {E}, F "
          f"{cfg.moe_d_ff}, top-{k}) against the per-token f32 formula: "
          f"max|err| {err:.3e}, mean|ref| {ref.abs().mean().item():.3e}, "
          f"max|ref| {ref.abs().max().item():.3e} ({MOE_TOL}); moe_local "
          f"at capacity factor {E / k:.3f} against moe_ref: max|diff| "
          f"{err_local:.3e}")
    check(torch.allclose(out.float(), ref, **MOE_TOL),
          f"{name}: moe_ref disagrees with the per-token formula: {err}")
    check(torch.allclose(local.float(), out.float(), **MOE_TOL),
          f"{name}: moe_local without drops disagrees with moe_ref: "
          f"{err_local}")
    h = randn(gen, (B, T, cfg.d_model), torch.bfloat16, scale=1.0)
    layers = [{key: a[i] for key, a in params["layers"].items()}
              for i in range(cfg.n_layers)]

    def step_ffns(_):
        for lp_i in layers:
            _ffn(cfg, lp_i, h)
    ms, events, _ = profiled_ms(step_ffns, calls=3)
    print(f"  {name}: a decode step's MoE FFNs ({cfg.n_layers} layers at "
          f"({B}, {T}, {cfg.d_model}), eager): device {ms:.3f} ms "
          f"({events:.0f} device events)")
    return dict(max_abs_err=err, local_max_abs_diff=err_local,
                ffn_device_ms=ms)


def arch_prefill(name, ecfg, cfg, params, transform, prompts):
    """The cohort prefill at (lanes, prefill_len), captured: its device
    time and B3's share of it."""
    from repro_torch.serving.api import build_session_fns
    B, S = ecfg.lanes, ecfg.prefill_len
    toks = np.zeros((B, S), np.int32)
    lens = np.zeros((B,), np.int32)
    for b, p in enumerate(prompts[:B]):
        toks[b, :len(p)] = p
        lens[b] = len(p)
    fns = build_session_fns(ecfg, cfg, params, logits_transform=transform,
                            device="cuda")
    for _ in range(2):           # eager, then captured: outside the window
        fns.prefill(toks, lens)
    ms, events, b3 = profiled_ms(lambda i: fns.prefill(toks, lens))
    print(f"  {name}: cohort prefill ({B}, {S}) device time {ms:.3f} ms "
          f"({events:.0f} device events), B3 {b3:.3f} ms (share "
          f"{b3 / ms:.3f}), captured")
    return dict(device_ms=ms, events=events, b3_ms=b3)


def strategies_cell(name, cfg, params, transform, prompts, sp, outs):
    """(a)'s requests, the first N_PRIMED of them each after a primer: a
    request whose prompt is that request's prompt followed by the start of
    its output (a), cut to the prompt pad length.  Served under the
    default Lookahead config (the serve CLI's: hierarchical, decoding
    length 32), LLMA's single branch (``llma_config``: branches from the
    prompts alone, 16 a step) and step by step (``baseline_config``),
    each on a session of its own tree width, twice (the first run
    captures).  While a primer is live its prompt holds the walk its
    partner is generating, so LLMA's prompt-only drafts can verify: LLMA
    must accept some (EDL above 1).  The outputs must equal across the
    three; (a)'s requests must give (a)'s outputs, which equal
    reference_decode, and the primers' must equal reference_decode."""
    from repro_torch.core import baseline_config, llma_config
    from repro_torch.core import reference_decode
    from repro_torch.serving.api import EngineConfig, build_session_fns
    from repro_torch.serving.scheduler import ContinuousScheduler
    base = EngineConfig(default_params=sp)
    requests, primers = [], []
    for i, p in enumerate(prompts):
        if i < N_PRIMED:
            primers.append(len(requests))
            requests.append((list(p) + outs[i])[:base.prefill_len])
        requests.append(list(p))
    rows, first, ref_fns = {}, None, None
    for label, la in (("lookahead", base.lookahead()),
                      ("llma", llma_config()),
                      ("step by step", baseline_config())):
        ecfg = dataclasses.replace(
            base, strategy=la.strategy, decoding_length=la.decoding_length,
            branch_length=la.branch_length)
        fns = build_session_fns(ecfg, cfg, params,
                                logits_transform=transform, device="cuda")
        for _ in range(2):
            sched = ContinuousScheduler(fns, la, lanes=ecfg.lanes,
                                        prefill_len=ecfg.prefill_len,
                                        default_params=sp)
            got, _, _, tps, edl, fused = serve_counted(sched, requests, sp,
                                                       {})
        first = got if first is None else first
        check(got == first, f"{name}, {label}: outputs differ from the "
                            "default config's")
        check([o for i, o in enumerate(got) if i not in primers] == outs,
              f"{name}, {label}: (a)'s requests differ from (a)'s outputs")
        st = sched.stats
        check(st.decode_syncs == st.decode_steps,
              f"{name}, {label}: {st.decode_syncs} decode syncs for "
              f"{st.decode_steps} steps")
        rows[label] = dict(fused_ms=fused, edl=edl, tokens_per_s=tps,
                           width=ecfg.slots, decode_steps=st.decode_steps)
        print(f"  {name}, {label} ({la.strategy}, tree width {ecfg.slots}, "
              f"{len(requests)} requests, {len(primers)} of them primers): "
              f"median fused_step {fused:.3f} ms, EDL {edl:.3f}, "
              f"{tps:.1f} tokens/s ({st.decode_steps} decode steps; guided "
              "model: acceptance is not a real model's)")
        if label == "llma":
            check(edl > 1.0, f"{name}: LLMA accepted no draft token")
        ref_fns = ref_fns or fns        # the default config's session
        del fns, sched
    for i in primers:
        ref = reference_decode(ref_fns, requests[i], params=sp,
                               lanes=base.lanes)
        check(first[i] == ref, f"{name}: primer {i} differs from "
                               "reference_decode (first difference at token "
                               f"{first_difference(first[i], ref)})")
    print(f"  {name}: the three strategies' outputs equal each other; (a)'s "
          f"requests give (a)'s outputs and the {len(primers)} primers "
          "equal reference_decode")
    return rows


def arch_sampled_cell(name, cfg, params):
    """Paged, 4 lanes, unguided: 6 requests sampled at temperatures 0.6 to
    1.5 with their own seeds (two admitted into a lane mid-flight).  Every
    output must equal reference_decode at the serving batch shape, and
    the Gumbel-argmax kernel (at this vocabulary, a tail chunk) must run
    once in each decode step and each prefill, and nowhere else."""
    from repro_torch.core import reference_decode
    from repro_torch.core.request import SamplingParams
    from repro_torch.kernels.gumbel_argmax.ops import gumbel_argmax
    from repro_torch.serving.api import (EngineConfig, ServingEngine,
                                         build_session_fns)
    from repro_torch.training.data import PROFILES, SyntheticCorpus
    corpus = SyntheticCorpus(PROFILES["antrag"], cfg.vocab_size, seed=7)
    prompts = [corpus.sample()[0][:96] for _ in ARCH_TEMPS]
    sps = [SamplingParams(max_new_tokens=MAX_NEW, sample=True,
                          temperature=t, seed=300 + i)
           for i, t in enumerate(ARCH_TEMPS)]
    ecfg = EngineConfig(kv_layout="paged", block_size=PATH_PAGED[5])
    fns = build_session_fns(ecfg, cfg, params, device="cuda")
    counting, calls = counted_calls(fns, ("prefill", "prefill_into_slot"))
    engine = ServingEngine(counting, ecfg)
    outs, launches, wall, tps, edl, fused = serve_counted(
        engine.scheduler, prompts, sps, {"gumbel_argmax": gumbel_argmax})
    st = engine.stats
    n_prefill = sum(calls.values())
    print(f"  {name}, sampled paged (temperatures {ARCH_TEMPS}): "
          f"{sum(map(len, outs))} tokens in {wall:.3f} s -> {tps:.1f} "
          f"tokens/s; EDL {edl:.3f}; {st.decode_steps} decode steps, "
          f"median fused_step {fused:.3f} ms; prefill calls {calls}; "
          f"launches {launches}")
    check(calls["prefill_into_slot"] > 0,
          f"{name} sampled: no request was admitted into a lane ({calls})")
    check(launches["gumbel_argmax"] == st.decode_steps + n_prefill,
          f"{name} sampled: gumbel_argmax launched "
          f"{launches['gumbel_argmax']} times for {st.decode_steps} steps "
          f"and {n_prefill} prefills")
    check(st.decode_syncs == st.decode_steps,
          f"{name} sampled: {st.decode_syncs} decode syncs for "
          f"{st.decode_steps} steps")
    check(all(len(o) == MAX_NEW for o in outs), f"{name}: short outputs")
    for i, (p, sp, o) in enumerate(zip(prompts, sps, outs)):
        ref = reference_decode(fns, list(p), params=sp, lanes=ecfg.lanes)
        check(o == ref, f"{name} sampled, request {i}: served output "
                        "differs from reference_decode at the serving shapes"
                        f" (first difference at token "
                        f"{first_difference(o, ref)})")
    print(f"  {name} sampled: all {len(prompts)} outputs equal "
          f"reference_decode(..., lanes={ecfg.lanes})")
    return dict(fused_ms=fused, tokens_per_s=tps, edl=edl,
                decode_steps=st.decode_steps, launches=launches)


# --------------------------------------------------------------- recsys
def eb_hold(out, ref, dtype, label):
    """B5 against its plain version bit for bit: NaN exactly where the
    plain version has NaN (out-of-range ids), the same bits elsewhere (both
    add the rounded f32 products in l order from 0 and round once).
    Returns the largest absolute difference, 0 when the check passes."""
    torch.cuda.synchronize()
    nan = torch.isnan(out)
    check(torch.equal(nan, torch.isnan(ref)), f"embedding_bag {label} "
                                              f"{dtype}: NaN outputs differ "
                                              "from the plain version's")
    ints = torch.int32 if dtype == torch.float32 else torch.int16
    a, b = out.masked_fill(nan, 0), ref.masked_fill(nan, 0)
    same = torch.equal(a.view(ints), b.view(ints))
    err = (a.float() - b.float()).abs().max().item() if a.numel() else 0.0
    print(f"  embedding_bag {str(dtype)[6:]:8s} {label}: "
          f"{'bit-equal' if same else 'FAIL'} to the plain version, "
          f"{int(nan.sum())} NaN outputs, max|err| {err:.3e}")
    check(same, f"embedding_bag differs from its plain version at {label} "
                f"{dtype}: max abs err {err}")
    return err


def embedding_bag_phase(gen):
    """B5 against its plain version bit for bit in f32 and bf16 at the
    shapes of tests/test_kernels.py:66-67 (16-byte slices, bags of 1 to 7),
    at D = 1 and D = 33 (the scalar slice, bags of 4 and of 7), and on a
    stacked table with masked slots and negative and out-of-range ids (NaN
    bags); the mask and the weights go to the kernel as they are."""
    from repro_torch.kernels.embedding_bag.ops import (embedding_bag_fused,
                                                       embedding_bag_ref)
    for dtype in (torch.float32, torch.bfloat16):
        for V, D, N, L in EB_SWEEP + [(300, 1, 64, 4), (300, 33, 64, 7)]:
            t = randn(gen, (V, D), dtype, scale=1.0)
            ids = torch.randint(0, V, (N, L), generator=gen, device="cuda",
                                dtype=torch.int32)
            m = torch.rand((N, L), generator=gen, device="cuda") > 0.3
            w = torch.rand((N, L), generator=gen, device="cuda")
            eb_hold(embedding_bag_fused(t, ids, m, w),
                    embedding_bag_ref(t, ids, w * m), dtype, (V, D, N, L))
        F, V, D = 3, 50, 8
        t = randn(gen, (F, V, D), dtype, scale=1.0)
        ids = torch.randint(-V - 4, V + 4, (64, F, 4), generator=gen,
                            device="cuda", dtype=torch.int32)
        m = torch.rand((64, F, 4), generator=gen, device="cuda") > 0.3
        out = embedding_bag_fused(t, ids, m)
        ref = embedding_bag_ref(t, ids, m.float())
        n_nan = int(torch.isnan(ref).any(-1).sum().item())
        check(0 < n_nan < 64 * F, f"id case: {n_nan} NaN bags")
        eb_hold(out, ref, dtype, f"stacked {(F, V, D)}, ids in [-{V + 4}, "
                                 f"{V + 4}), masked slots: {n_nan} of "
                                 f"{64 * F} bags NaN")


# B5's row window (a table's rows split over ``model``, ROADMAP A16b 6.3):
# held and timed at a rank's window of Wide & Deep's deep tables at these
# model axis sizes (500,000 and 62,500 rows a field), serve_bulk's ids
EB_WINDOW_MODELS = (2, 16)


def eb_window_row(tables, bulk, n_model):
    """B5's window form at the last rank's window of ``n_model`` over the
    (F, V, D) tables, serve_bulk's ids and mask: bit for bit against its
    plain version (NaN nowhere: every id is in range), the windows' sum
    against the whole table's bags, device ms beside the whole-table
    kernel's and the plain version's, and its bound: the ids' and mask's
    bytes, the distinct rows the window holds and the output."""
    from repro_torch.kernels.embedding_bag.ops import (embedding_bag_fused,
                                                       embedding_bag_ref)
    from repro_torch.kernels.timing import device_ms
    ids, mask, _ = bulk
    F, V, D = tables.shape
    Vl = V // n_model
    r = n_model - 1
    block = tables[:, r * Vl:(r + 1) * Vl].contiguous()
    w = mask.float()

    def kern(i):
        return embedding_bag_fused(block, ids, mask, row_start=r * Vl,
                                   n_rows=V)

    def whole(i):
        return embedding_bag_fused(tables, ids, mask)

    def plain(i):
        return embedding_bag_ref(block, ids, w, r * Vl, V)

    out = kern(0)
    err = eb_hold(out, plain(0), torch.float32,
                  f"window {r} of model {n_model} ({Vl} rows a field), "
                  f"serve_bulk ids {tuple(ids.shape)}")
    check(not torch.isnan(out).any(), "the window form gave NaN")
    if n_model == 2:
        total = out + embedding_bag_fused(tables[:, :Vl].contiguous(), ids,
                                          mask, row_start=0, n_rows=V)
        full = whole(0)
        diff = float((total - full).abs().max())
        check(torch.allclose(total, full, rtol=1e-6, atol=1e-6),
              f"the two windows' bags sum to the whole table's: {diff}")
        print(f"  embedding_bag window form, model 2: the two windows' bags "
              f"sum to the whole table's, max |diff| {diff:.3e}")
        del total, full
    del out
    ms = device_ms(kern, 3, "embedding_bag_kernel")
    whole_ms = device_ms(whole, 3, "embedding_bag_kernel")
    plain_ms = device_ms(plain, 2)
    idx = ids.long() % V - r * Vl
    mine = (idx >= 0) & (idx < Vl)
    flat = (idx + Vl * torch.arange(F, device="cuda")[:, None])[mine]
    n_rows = int(torch.unique(flat).numel())
    es = tables.element_size()
    nbytes = (n_rows * D * es + ids.numel() * (4 + 1)
              + ids.numel() // ids.shape[-1] * D * es)
    b_ms, b_by = bound(nbytes, 2.0 * int(mine.sum()) * D, torch.float32)
    print(f"  embedding_bag window form f32, model {n_model} (block "
          f"{tuple(block.shape)}, rows from {r * Vl}), serve_bulk ids "
          f"{tuple(ids.shape)}: device ms kernel {ms:.5f}, whole-table "
          f"kernel {whole_ms:.5f}, plain {plain_ms:.5f}, bound {b_ms:.5f} "
          f"({b_by}: {n_rows} distinct rows in the window, "
          f"{int(mine.sum())} of {ids.numel()} slots); max|err| {err}")
    del block
    torch.cuda.empty_cache()
    return dict(ms=ms, whole_ms=whole_ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, max_abs_err=err, rows=Vl, row_start=r * Vl,
                unique_rows=n_rows)


def time_calls(fn, n, warmup=2):
    """Median ms of ``n`` calls fn(i), each between its own pair of CUDA
    events (no host wait between calls)."""
    for i in range(warmup):
        fn(i)
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    for i, (a, b) in enumerate(ev):
        a.record()
        fn(i)
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def to_cuda(batch):
    return {k: torch.from_numpy(np.asarray(v)).cuda() for k, v in
            batch.items()}


def mlp64(p, x, final_act):
    n = sum(1 for k in p if k.startswith("w"))
    for i in range(n):
        x = x @ p[f"w{i}"].double() + p[f"b{i}"].double()
        if i < n - 1 or final_act:
            x = x.clamp_min(0)
    return x


def wide_deep64(params, ids, mask, dense):
    """Wide & Deep's forward in float64 on the card, written out: each
    field's rows gathered and summed under the mask, the deep MLP, the head,
    the wide sum and the dense linear part."""
    B, F, L = ids.shape
    f = torch.arange(F, device=ids.device)[None, :, None]
    m = mask.double()[..., None]
    emb = (params["tables"][f, ids.long()].double() * m).sum(2)
    wide = (params["wide_tables"][f, ids.long()].double() * m).sum((1, 2, 3))
    x = mlp64(params["deep"], torch.cat([emb.reshape(B, -1), dense.double()],
                                        -1), True)
    return ((x @ params["head"].double())[:, 0] + wide
            + dense.double() @ params["wide_dense"].double()
            + params["bias"].double()[0])


def tower64(tables, mlp_p, ids):
    B, F = ids.shape
    emb = tables[torch.arange(F, device=ids.device)[None], ids.long()]
    x = mlp64(mlp_p, emb.double().reshape(B, -1), False)
    return x / x.norm(dim=-1, keepdim=True).clamp_min(1e-6)


def encode64(params, ids, n_blocks, n_heads, causal, pad_mask):
    """The sequence encoder in float64, written out (RMSNorm, attention with
    masked scores at -1e30 before the softmax, tanh GELU)."""
    B, S = ids.shape
    d = params["item_emb"].shape[1]
    dh = d // n_heads

    def rms(x, g):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) \
            * g.double()

    h = (params["item_emb"][ids.long()].double()
         + params["pos_emb"][:S].double()[None])
    mask = pad_mask.bool()[:, None, :].expand(B, S, S)
    if causal:
        mask = mask & torch.ones(S, S, dtype=torch.bool,
                                 device=ids.device).tril()
    for b in range(n_blocks):
        p = {k: v.double() for k, v in params[f"blk{b}"].items()}
        hn = rms(h, p["ln1"])
        q, k, v = ((hn @ p[w]).view(B, S, n_heads, dh)
                   for w in ("wq", "wk", "wv"))
        sc = torch.einsum("bthd,bshd->bhts", q, k) * dh ** -0.5
        sc = sc.masked_fill(~mask[:, None], -1e30)
        a = torch.einsum("bhts,bshd->bthd", torch.softmax(sc, -1), v)
        h = h + a.reshape(B, S, d) @ p["wo"]
        h = h + torch.nn.functional.gelu(rms(h, p["ln2"]) @ p["w1"],
                                         approximate="tanh") @ p["w2"]
    return rms(h, params["ln_f"])


def seq_serve64(cfg, params, causal, ids, pad_mask, cand_ids=None):
    h = encode64(params, ids, cfg.n_blocks, cfg.n_heads, causal, pad_mask)
    B, S = pad_mask.shape
    last = pad_mask.long().sum(1) - 1
    hl = h[torch.arange(B, device=h.device), torch.where(last < 0, last + S,
                                                         last)]
    if cand_ids is None:
        return hl @ params["item_emb"].double().T
    return torch.einsum("bd,bcd->bc", hl,
                        params["item_emb"][cand_ids.long()].double())


def hold_scores(label, got, ref):
    """Scores against the float64 recomputation within RECSYS_TOL."""
    err = (got.double() - ref).abs().max().item()
    ok = bool(torch.isfinite(got).all()) and torch.allclose(
        got.double(), ref, **RECSYS_TOL)
    print(f"  {label}: max|err| vs float64 {err:.3e} (max|ref| "
          f"{ref.abs().max().item():.3e}) {'ok' if ok else 'FAIL'} "
          f"({RECSYS_TOL})")
    check(ok, f"{label}: scores disagree with the float64 recomputation "
              f"(max abs err {err})")


def cell_line(arch, shape, ms, rows, what="contexts"):
    print(f"  {arch} {shape}: median {ms:.4f} ms per call, "
          f"{rows / ms * 1e3:.4g} {what}/s")


def profile_cell(label, fn, calls=5, top=3):
    """Where a serve cell's time goes: a torch.profiler window over
    ``calls`` calls of fn(i) — wall time, device busy time and idle share,
    launches per call, and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    n = sum(e.count for e in kernels)
    print(f"    profile {label}: wall {wall / calls:.4f} ms/call, device busy "
          f"{busy / calls:.4f} ms/call, idle share {1 - busy / wall:.3f}, "
          f"{n / calls:.0f} launches/call")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"      {e.self_device_time_total / 1e3 / calls:8.4f} ms/call "
              f"{e.count / calls:5.0f}/call  {e.key[:80]}")


def recsys_phase(gen):
    """Recommender scoring at full width on the card, f32 (TF32 off): each
    arch's serve cells (Wide & Deep: serve_p99, serve_bulk and
    retrieval_cand) through its config's serve function, inputs from the
    port's batch generators and parameters made on the card from seed 0,
    one arch at a time.  Each cell is timed (median ms per call) with the
    fused EmbeddingBag kernel's launches counted (2 per Wide & Deep
    forward, none elsewhere) and its scores are held against the same
    function in float64; then B5 is held against its plain version at Wide
    & Deep's bag shapes in f32 and bf16 and timed beside it,
    F.embedding_bag and its bound.  Returns (B5's max error, its timing row,
    its launches on the scoring path)."""
    from repro_torch.configs import (bert4rec, sasrec, two_tower_retrieval,
                                     wide_deep)
    from repro_torch.configs.recsys_common import BATCHES
    from repro_torch.kernels.embedding_bag.ops import (embedding_bag_fused,
                                                       embedding_bag_ref)
    from repro_torch.kernels.timing import device_ms
    from repro_torch.models.recsys import two_tower as tt_model
    from repro_torch.training import data
    launches = 0

    def counted(fn, n_calls):
        nonlocal launches
        torch.cuda.synchronize()
        embedding_bag_fused.launches = 0
        ms = time_calls(fn, n_calls)
        torch.cuda.synchronize()
        launches += embedding_bag_fused.launches
        return ms, embedding_bag_fused.launches, n_calls + 2

    # ---- Wide & Deep: serve_p99 and serve_bulk
    cfg = wide_deep.full_config()
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = wide_deep.model.init_params(cfg, seed=0)
    torch.cuda.synchronize()
    print(f"  wide-deep: {cfg.n_params() / 1e9:.3f} B params made on the card "
          f"in {time.perf_counter() - t0:.2f} s")
    fn = wide_deep.serve_cell("serve_p99").fn
    F, Vr, L = cfg.n_sparse, cfg.rows_per_table, cfg.multi_hot

    def wd_inputs(B, seed):
        b = to_cuda(data.wide_deep_batch(np.random.RandomState(seed), B, F,
                                         Vr, L, cfg.n_dense))
        return b["sparse_ids"], b["sparse_mask"], b["dense"]

    p99 = [wd_inputs(BATCHES["serve_p99"], 100 + i) for i in range(N_ID_SETS)]
    bulk = wd_inputs(BATCHES["serve_bulk"], 200)
    ms, n_l, n_calls = counted(lambda i: fn(cfg, params, *p99[i % N_ID_SETS]),
                               20)
    check(n_l == 2 * n_calls, f"wide-deep serve_p99: {n_l} embedding_bag "
                              f"launches for {n_calls} forwards")
    cell_line("wide-deep", "serve_p99 (B 512)", ms, 512)
    profile_cell("wide-deep serve_p99",
                 lambda i: fn(cfg, params, *p99[i % N_ID_SETS]))
    ms_b, n_l, n_calls = counted(lambda i: fn(cfg, params, *bulk), 5)
    check(n_l == 2 * n_calls, f"wide-deep serve_bulk: {n_l} embedding_bag "
                              f"launches for {n_calls} forwards")
    cell_line("wide-deep", "serve_bulk (B 262,144)", ms_b, 262144)
    profile_cell("wide-deep serve_bulk", lambda i: fn(cfg, params, *bulk))
    hold_scores("wide-deep serve_p99 logits", fn(cfg, params, *p99[0]),
                wide_deep64(params, *p99[0]))
    n = RECSYS_BULK_CHECK_ROWS
    got = fn(cfg, params, *bulk)
    check(got.shape == (262144,), f"serve_bulk logits {tuple(got.shape)}")
    hold_scores(f"wide-deep serve_bulk logits (first {n} of 262,144)",
                got[:n], wide_deep64(params, *(x[:n] for x in bulk)))
    del got

    # ---- B5 at Wide & Deep's bag shapes: f32 and bf16 against the plain
    # version, then timed (f32, the model's dtype)
    err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        tabs = {"deep": params["tables"].to(dtype),
                "wide": params["wide_tables"].to(dtype)}
        for shape, (ids, mask, _) in (("serve_p99", p99[0]),
                                      ("serve_bulk", bulk)):
            for part, t in tabs.items():
                out = embedding_bag_fused(t, ids, mask)
                e = eb_hold(out, embedding_bag_ref(t, ids, mask.float()),
                            dtype, f"wide-deep {part} tables "
                                   f"{tuple(t.shape)}, {shape} ids "
                                   f"{tuple(ids.shape)}")
                if dtype == torch.float32 and part == "deep" \
                        and shape == "serve_p99":
                    err = e
                del out
        del tabs
    torch.cuda.empty_cache()

    def eb_row(t, sets, plain_iters):
        """B5 on the model's call (ids and the bool mask, sets rotated),
        its plain version, F.embedding_bag on the same bags (ids pre-offset
        into the flattened table, the mask as f32 per-sample weights) and
        two bounds: the guide's (each input byte once: the distinct rows,
        the ids, the mask bytes, the output) and one that counts a 32-byte
        sector for each distinct sector that the distinct rows lie in, as
        a read moves whole sectors (they differ only where a row is not a
        whole number of sectors: the wide tables' 4-byte rows, eight to a
        sector, where neighbouring rows share theirs).  ms, plain_ms and library_ms are device
        time per call from torch.profiler (B5: its kernel alone): at
        serve_p99 one call is microseconds of device work, under the host's
        dispatch time, so CUDA events around a loop of calls would time the
        host; those event times stay beside them as *_call_ms."""
        Fv, V, D = t.shape
        es = t.element_size()
        ws = [m.float() for _, m, _ in sets]
        flat = [(ids.long() + V * torch.arange(Fv, device="cuda")[:, None]
                 ).reshape(-1, ids.shape[-1]) for ids, _, _ in sets]
        tf = t.reshape(Fv * V, D)
        k = len(sets)
        n = 20 if k > 1 else 10

        def kern(i):
            return embedding_bag_fused(t, sets[i % k][0], sets[i % k][1])

        def plain_fn(i):
            return embedding_bag_ref(t, sets[i % k][0], ws[i % k])

        def lib_fn(i):
            return torch.nn.functional.embedding_bag(
                flat[i % k], tf, mode="sum",
                per_sample_weights=ws[i % k].reshape(flat[i % k].shape))

        calls = dict(call_ms=time_ms(kern, iters=n, warmup=2),
                     plain_call_ms=time_ms(plain_fn, iters=plain_iters,
                                           warmup=1),
                     library_call_ms=time_ms(lib_fn, iters=n, warmup=2))
        ms = device_ms(kern, n, "embedding_bag_kernel")
        plain = device_ms(plain_fn, plain_iters)
        lib = device_ms(lib_fn, n)
        ids = sets[0][0]
        rows = torch.unique(flat[0])
        n_rows = int(rows.numel())
        n_sectors = distinct_sectors(t, rows)
        rest = ids.numel() * (4 + 1) + ids.numel() // ids.shape[-1] * D * es
        flops = 2.0 * ids.numel() * D
        b_ms, b_by = bound(n_rows * D * es + rest, flops, torch.float32)
        return dict(ms=ms, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                    bound_by=b_by, sector_bound_ms=bound(
                        n_sectors * 32 + rest, flops, torch.float32)[0],
                    device_ms=ms, library_device_ms=lib,
                    shape=list(t.shape), ids=list(ids.shape),
                    unique_rows=n_rows, unique_sectors=n_sectors, **calls)

    rows = {}
    for part, key in (("deep", "tables"), ("wide", "wide_tables")):
        for shape, sets, it in (("serve_p99", p99, 10), ("serve_bulk",
                                                         [bulk], 3)):
            r = eb_row(params[key], sets, it)
            rows[f"{part}_{shape}"] = r
            print(f"  embedding_bag f32 {part} tables {tuple(r['shape'])}, "
                  f"{shape} ids {tuple(r['ids'])}, device ms per call: "
                  f"kernel {r['ms']:.5f}, plain {r['plain_ms']:.5f}, "
                  f"F.embedding_bag {r['library_ms']:.5f}, bound "
                  f"{r['bound_ms']:.5f} ({r['bound_by']}: "
                  f"{r['unique_rows']} distinct rows), bound counting "
                  f"their {r['unique_sectors']} distinct 32-byte sectors "
                  f"{r['sector_bound_ms']:.5f}; "
                  f"event-timed calls: kernel {r['call_ms']:.4f}, plain "
                  f"{r['plain_call_ms']:.4f}, F.embedding_bag "
                  f"{r['library_call_ms']:.4f}")
    row = dict(rows.pop("deep_serve_p99"), **rows)
    for n_model in EB_WINDOW_MODELS:
        row[f"window_model{n_model}"] = eb_window_row(
            params["tables"], bulk, n_model)

    # retrieval_cand: one user's 10^6 candidate contexts.  It runs after
    # B5's device timing above: on the H100, once this cell's profile had
    # run, the profiler recorded no B5 launch of a serve_p99 call
    cand = wd_inputs(1_000_000, 250)
    fn = wide_deep.serve_cell("retrieval_cand").fn
    ms, n_l, n_calls = counted(lambda i: fn(cfg, params, *cand), 5)
    check(n_l == 2 * n_calls, f"wide-deep retrieval_cand: {n_l} "
                              f"embedding_bag launches for {n_calls} forwards")
    cell_line("wide-deep", "retrieval_cand (10^6 candidate contexts)", ms,
              1_000_000, "candidates")
    profile_cell("wide-deep retrieval_cand", lambda i: fn(cfg, params, *cand))
    got = fn(cfg, params, *cand)
    check(got.shape == (1_000_000,), f"retrieval_cand logits "
                                     f"{tuple(got.shape)}")
    n = RECSYS_BULK_CHECK_ROWS
    hold_scores(f"wide-deep retrieval_cand logits (first {n} of 10^6)",
                got[:n], wide_deep64(params, *(x[:n] for x in cand)))
    print(f"  wide-deep: embedding_bag launched {launches} times in the "
          "timed calls, 2 per forward")
    del params, p99, bulk, cand, got
    torch.cuda.empty_cache()
    print(f"  wide-deep peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # ---- Two-Tower: serve_p99 (paired user·item) and retrieval_cand
    cfg = two_tower_retrieval.full_config()
    torch.cuda.reset_peak_memory_stats()
    params = two_tower_retrieval.model.init_params(cfg, seed=0)
    nu, ni, Vr = cfg.n_user_fields, cfg.n_item_fields, cfg.rows_per_table
    sets = [to_cuda(data.two_tower_batch(np.random.RandomState(300 + i), 512,
                                         nu, ni, Vr))
            for i in range(N_ID_SETS)]
    fn = two_tower_retrieval.serve_cell("serve_p99").fn
    ms, n_l, _ = counted(lambda i: fn(cfg, params, sets[i % N_ID_SETS][
        "user_ids"], sets[i % N_ID_SETS]["item_ids"]), 20)
    check(n_l == 0, f"two-tower serve_p99 launched embedding_bag {n_l} times")
    cell_line("two-tower", "serve_p99 (B 512, paired)", ms, 512)
    profile_cell("two-tower serve_p99", lambda i: fn(
        cfg, params, sets[i % N_ID_SETS]["user_ids"],
        sets[i % N_ID_SETS]["item_ids"]))
    u, it = sets[0]["user_ids"], sets[0]["item_ids"]
    hold_scores("two-tower serve_p99 scores", fn(cfg, params, u, it),
                (tower64(params["user_tables"], params["user_mlp"], u)
                 * tower64(params["item_tables"], params["item_mlp"], it)
                 ).sum(-1))
    cat = data.two_tower_batch(np.random.RandomState(301), two_tower_retrieval
                               .N_CAND, nu, ni, Vr)["item_ids"]
    cand = torch.cat([tt_model.item_embed(cfg, params, torch.from_numpy(
        cat[i:i + 2**18]).cuda()) for i in range(0, len(cat), 2**18)])
    user = to_cuda(data.two_tower_batch(np.random.RandomState(302), 1, nu,
                                        ni, Vr))["user_ids"]
    fn = two_tower_retrieval.serve_cell("retrieval_cand").fn
    ms, n_l, _ = counted(lambda i: fn(cfg, params, user, cand), 10)
    check(n_l == 0, f"two-tower retrieval launched embedding_bag {n_l} times")
    cell_line("two-tower", "retrieval_cand (1 user, 10^6 candidates, top "
              f"{two_tower_retrieval.TOP_K})", ms, two_tower_retrieval.N_CAND,
              "candidates")
    profile_cell("two-tower retrieval_cand", lambda i: fn(cfg, params, user,
                                                          cand))
    vals, idx = fn(cfg, params, user, cand)
    s64 = cand.double() @ tower64(params["user_tables"], params["user_mlp"],
                                  user)[0]
    hold_scores("two-tower retrieval_cand top scores", vals, s64[idx])
    k = two_tower_retrieval.TOP_K
    v64, i64 = torch.sort(s64, descending=True, stable=True)
    gap = (v64[:k] - v64[1:k + 1]).abs()
    tol = RECSYS_TOL["atol"] + RECSYS_TOL["rtol"] * v64[:k + 1].abs()
    clear = (gap > tol[:k]) & torch.cat([torch.ones(1, dtype=torch.bool,
                                                    device="cuda"),
                                         gap[:-1] > tol[:k - 1]])
    bad = int(((idx != i64[:k]) & clear).sum().item())
    print(f"  two-tower top-{k} indices: {int(clear.sum())} positions whose "
          f"float64 neighbours lie further apart than the tolerance; "
          f"{bad} of them differ from the float64 ranking")
    check(bad == 0, f"two-tower top-{k}: {bad} indices differ")
    del params, sets, cand, s64, v64, i64
    torch.cuda.empty_cache()
    print(f"  two-tower peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # ---- SASRec and BERT4Rec: serve_p99 (512 candidates) and retrieval_cand
    for mod, causal in ((sasrec, True), (bert4rec, False)):
        cfg = mod.full_config()
        torch.cuda.reset_peak_memory_stats()
        params = mod.model.init_params(cfg, seed=0)
        S, n_items = cfg.seq_len, cfg.n_items

        def seq_inputs(B, seed, cands):
            rng = np.random.RandomState(seed)
            b = to_cuda(data.seq_rec_batch(rng, B, S, n_items, causal))
            ins = (b["ids"], b["pad_mask"])
            if cands:
                ins += (torch.from_numpy(rng.randint(
                    2, n_items, (B, mod.N_CAND)).astype(np.int32)).cuda(),)
            return ins

        sets = [seq_inputs(512, 400 + i, True) for i in range(N_ID_SETS)]
        # a left-padded and a fully padded row (its index -1 wraps)
        sets[0][1][1, :3] = False
        sets[0][1][2] = False
        fn = mod.serve_cell("serve_p99").fn
        ms, n_l, _ = counted(lambda i: fn(cfg, params, *sets[i % N_ID_SETS]),
                             10)
        check(n_l == 0, f"{cfg.name} launched embedding_bag {n_l} times")
        cell_line(cfg.name, f"serve_p99 (B 512, {mod.N_CAND} candidates)", ms,
                  512)
        profile_cell(f"{cfg.name} serve_p99",
                     lambda i: fn(cfg, params, *sets[i % N_ID_SETS]))
        hold_scores(f"{cfg.name} serve_p99 scores", fn(cfg, params, *sets[0]),
                    seq_serve64(cfg, params, causal, *sets[0]))
        one = seq_inputs(1, 500, False)
        fn = mod.serve_cell("retrieval_cand").fn
        ms, n_l, _ = counted(lambda i: fn(cfg, params, *one), 10)
        check(n_l == 0, f"{cfg.name} launched embedding_bag {n_l} times")
        cell_line(cfg.name, "retrieval_cand (B 1, full catalog)", ms, n_items,
                  "items")
        profile_cell(f"{cfg.name} retrieval_cand",
                     lambda i: fn(cfg, params, *one))
        got = fn(cfg, params, *one)
        check(got.shape == (1, n_items), f"{cfg.name} retrieval scores "
                                         f"{tuple(got.shape)}")
        hold_scores(f"{cfg.name} retrieval_cand scores", got,
                    seq_serve64(cfg, params, causal, *one))
        if mod is sasrec:
            sasrec_bulk(cfg, params, seq_inputs, counted)
        del params, sets, one, got
        torch.cuda.empty_cache()
        print(f"  {cfg.name} peak device memory "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return err, row, launches


def sasrec_bulk(cfg, params, seq_inputs, counted):
    """SASRec's serve_bulk once at full size (B 262,144, 512 candidates a
    row): ms a call, its peak, and its first RECSYS_BULK_CHECK_ROWS rows'
    scores against float64."""
    from repro_torch.configs import sasrec
    from repro_torch.configs.recsys_common import BATCHES
    B = BATCHES["serve_bulk"]
    ins = seq_inputs(B, 450, True)
    fn = sasrec.serve_cell("serve_bulk").fn
    torch.cuda.reset_peak_memory_stats()
    ms, n_l, _ = counted(lambda i: fn(cfg, params, *ins), 2)
    check(n_l == 0, f"sasrec serve_bulk launched embedding_bag {n_l} times")
    peak = torch.cuda.max_memory_allocated() / 1e9
    cell_line(cfg.name, f"serve_bulk (B {B:,}, {sasrec.N_CAND} candidates)",
              ms, B)
    n = RECSYS_BULK_CHECK_ROWS
    got = fn(cfg, params, *ins)
    check(got.shape == (B, sasrec.N_CAND), f"serve_bulk scores "
                                           f"{tuple(got.shape)}")
    hold_scores(f"{cfg.name} serve_bulk scores (first {n} of {B:,})",
                got[:n], seq_serve64(cfg, params, True,
                                     *(x[:n] for x in ins)))
    print(f"  {cfg.name} serve_bulk: {ms:.2f} ms a call, peak {peak:.2f} GB "
          "(parameters and inputs included)")
    del got, ins


# ---------------------------------------------------------------- training
TRAIN_CLI_STEPS = (2, 4)      # the CLI run, then its resumed run (the
                              # one-device side of dist's (f), which reuses
                              # them in the same process)
TRAIN_CLI_EVERY = 2           # a checkpoint every 2 steps
TRAIN_CLI_LAYERS = 2          # the CLI run's depth cut 28 -> 2: its f32
                              # checkpoint (weights and both AdamW moments)
                              # 18.5 -> 3.9 GB
# leaves of the checkpoint compared bit for bit with the trained state
CKPT_SPOT_KEYS = ("p/embed", "p/ln_f", "p/layers/wq", "p/layers/bq", "o/0",
                  "o/1/embed", "o/2/layers/w_down")
OVERFIT_STEPS = 10
OVERFIT_MARGIN = 0.5          # nats the loss must fall on one repeated batch
                              # (the margin of the reference's
                              # test_overfit_single_batch)
TRAIN_4K_BATCH = 8            # the train_4k cell's global batch 256, cut
TRAIN_4K_ACCUM = 4            # microbatches (the reference's memory build)
TRAIN_4K_TIMED = 1            # timed steps after one warm-up (cut from 3
                              # for (h)'s time)
REMAT_LAYERS = 4              # depth of the remat on/off peak comparison:
                              # off keeps ~4 GB of attention a layer at
                              # (2, 4096), which 28 layers would not fit
WD_TRAIN_STEPS = 5
# card against CPU, one smoke step in f32: loss and gradient norm to rtol
# 1e-5 (f32 sums in another order); parameters to atol lr / 10.  Adam's
# first update is lr * g / (|g| + eps), continuous in g, so the two
# devices' rounding of g moves it far less than lr (1.0e-5 measured on the
# H100); a wrong update (a missing bias correction, a halved lr) moves
# entries by lr / 2 or more
TRAIN_LR = 1e-3
TRAIN_PARAM_ATOL = 1e-4
# B5's table gradient, the autograd.Function's backward (plain index_add_)
# against autograd of the plain version: both scatter-add with atomics in
# no fixed order, cotangents ~1e-3
B5_GRAD_TOL = dict(atol=1e-9, rtol=1e-5)
# arch -> (batch, the cut): two steps each at full width, the batch cut
# and never split (the reference's accumulation would split the shared
# negatives too, ROADMAP C), so every row keeps the cell's work: its
# in-batch negatives, or all 8,192 shared ones
RECSYS_TRAIN_CUTS = {
    "two-tower-retrieval": (
        32768, "B 65,536 -> 32,768: the in-batch (B, B) f32 scores are "
               "17 GB a copy at 65,536, and the negatives are the batch"),
    "sasrec": (
        8192, "B 65,536 -> 8,192: the (B, 50, 8,193) f32 scores are "
              "107 GB a copy at 65,536, 13 GB at 8,192"),
    "bert4rec": (
        8192, "B 65,536 -> 8,192: the (B, 40, 8,193) f32 scores are "
              "86 GB a copy at 65,536, 11 GB at 8,192"),
}
RECSYS_TRAIN_STEPS = 2        # the first call (cold), then a warm step


def peak_gb() -> float:
    return torch.cuda.max_memory_allocated() / 1e9


def free_card():
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def timed_steps(step, state, batches, n):
    """``n`` steps on ``state`` = [params, opt], replaced in place, so that
    no caller keeps an older state alive; each step timed by the host
    clock to a synchronize, its loss pulled after it.  Returns (losses,
    seconds)."""
    losses, secs = [], []
    for i in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state[0], state[1], m = step(*state, batches[i % len(batches)])
        losses.append(float(m["loss"]))
        secs.append(time.perf_counter() - t0)
    return losses, secs


def lm_rate(cfg, tokens, secs):
    """Median step ms (first step left out), tokens/s and TFLOP/s from
    6 * N_active * tokens."""
    ms = float(np.median(secs[1:])) * 1e3
    return ms, tokens / ms * 1e3, 6 * cfg.n_active_params() * tokens \
        / ms / 1e9


# the train CLI's one-device runs (``one_device_cli``), once a process
ONE_DEVICE_CLI = {}


def one_device_cli():
    """The train CLI's two calls on one device in this process
    (``train_cli_cut``, its defaults: f32, batch 8, seq 128, dense, lr
    3e-4): TRAIN_CLI_STEPS[0] steps with a checkpoint every
    TRAIN_CLI_EVERY, whose CKPT_SPOT_KEYS arrays at the last must be the
    trained state's bits, then a second ``main`` that resumes from it (its
    restore checks the sha256 of every array it reads against the
    manifest's) to TRAIN_CLI_STEPS[1].  Run once a process: the train
    phase's CLI cell and dist's (f) share them; the checkpoints stay
    until the process exits.  Returns each run's numbers and the
    checkpoint directory."""
    if ONE_DEVICE_CLI:
        return ONE_DEVICE_CLI
    import atexit
    import shutil
    import tempfile
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    atexit.register(shutil.rmtree, ckpt, True)
    argv = ["--device", "cuda", "--ckpt-dir", ckpt, "--ckpt-every",
            str(TRAIN_CLI_EVERY)]
    runs = []
    for steps in TRAIN_CLI_STEPS:
        free_card()
        run = train_cli_cut(argv + ["--steps", str(steps)])
        path = os.path.join(ckpt, f"step_{steps:010d}")
        keep = ("losses", "start", "wall_s", "restore_s", "pull_s",
                "write_wait_s")
        runs.append(dict({k: run[k] for k in keep}, peak_gb=peak_gb(),
                         opt_step=int(run["opt"].step),
                         ckpt_bytes=os.path.getsize(os.path.join(
                             path, "arrays.npz"))))
        # the saved arrays are the trained state's bits
        with np.load(os.path.join(path, "arrays.npz")) as npz:
            state = {"p": run["params"], "o": run["opt"]}
            for key in CKPT_SPOT_KEYS:
                leaf = state
                for part in key.split("/"):
                    leaf = leaf[int(part) if part.isdigit() else part]
                check(np.array_equal(npz[key], leaf.cpu().numpy()),
                      f"checkpoint {key} differs from the trained state")
        del state, run
    free_card()
    ONE_DEVICE_CLI.update(runs=runs, dir=ckpt)
    return ONE_DEVICE_CLI


def train_cli_cell():
    """Qwen2-1.5B at full width through ``launch/train.main`` with its
    defaults, its depth cut to TRAIN_CLI_LAYERS: ``one_device_cli``'s two
    calls (a checkpoint every TRAIN_CLI_EVERY steps, resumed).
    Then the CLI's step on one repeated batch at full depth: the loss must
    fall by OVERFIT_MARGIN, and these steps are timed."""
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.models import transformer as tx
    from repro_torch.models.params import init_params
    from repro_torch.training.data import lm_train_batches
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step
    print(f"  [train CLI: depth cut to {TRAIN_CLI_LAYERS} of 28 layers]")
    first, second = one_device_cli()["runs"]
    n0, n1 = TRAIN_CLI_STEPS
    check(sorted(first["losses"]) == [1] and first["start"] == 0
          and np.isfinite(first["losses"][1]), f"train CLI: losses "
                                               f"{first['losses']}")
    print(f"  train CLI: {n0} steps in {first['wall_s']:.1f} s, peak "
          f"{first['peak_gb']:.2f} GB, loss {first['losses'][1]:.4f} (step "
          f"1); checkpoints every {TRAIN_CLI_EVERY} steps, "
          f"{first['ckpt_bytes'] / 1e9:.2f} GB: the last pulled in "
          f"{first['pull_s']:.2f} s, written (the wait at exit) in "
          f"{first['write_wait_s']:.2f} s")
    check(second["start"] == n0 and second["opt_step"] == n1
          and np.isfinite(second["losses"][n0 + 1]),
          f"resume: start {second['start']}, losses {second['losses']}")
    print(f"  resumed at step {second['start']}: restored (read, verified, "
          f"on the card) in {second['restore_s']:.2f} s, loss "
          f"{second['losses'][n0 + 1]:.4f} at step {n0 + 1}; {n1 - n0} "
          f"steps and a checkpoint in {second['wall_s']:.1f} s")

    free_card()
    cfg = dataclasses.replace(full_config(), prefill_backend="dense")
    params = init_params(cfg, seed=0, device="cuda")
    state = [params, adamw_init(params)]
    del params
    step = make_train_step(
        lambda p, b: tx.lm_loss(cfg, p, b["tokens"], b["labels"]), lr=3e-4)
    batch = to_cuda(next(lm_train_batches(cfg.vocab_size, 8, 128, seed=0)))
    losses, secs = timed_steps(step, state, [batch], OVERFIT_STEPS)
    check(losses[-1] < losses[0] - OVERFIT_MARGIN,
          f"one repeated batch: loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    ms, tok_s, tflops = lm_rate(cfg, 8 * 128, secs)
    print(f"  {cfg.name} f32 (the CLI's step), one batch x {OVERFIT_STEPS}: "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}; median step "
          f"{ms:.1f} ms, {tok_s:.0f} tokens/s, {tflops:.1f} TFLOP/s "
          f"(6 N tokens), peak {peak_gb():.2f} GB")
    profile_cell(f"{cfg.name} train step (f32, 8 x 128, eager)",
                 lambda i: step(*state, batch), calls=2)


def train_4k_cell():
    """The reference's train_4k config on Qwen2-1.5B at full width (bf16
    activations over f32 master weights, remat, q_chunk 512, S 4096, bf16
    gradients) with the global batch cut from 256 to TRAIN_4K_BATCH in
    TRAIN_4K_ACCUM microbatches; then the peak of one microbatch's loss and
    gradient with remat on and off at REMAT_LAYERS layers."""
    from repro_torch.configs import lm_common
    from repro_torch.configs.qwen2_1_5b import full_config
    from repro_torch.models import transformer as tx
    from repro_torch.models.params import init_params
    from repro_torch.training.data import lm_train_batches
    from repro_torch.training.optimizer import (adamw_init, tree_leaves,
                                                tree_map)
    free_card()
    cfg = lm_common.train_4k_config(full_config())
    S = lm_common.TRAIN_4K["seq"]
    params = init_params(cfg, seed=0, device="cuda")
    state = [params, adamw_init(params)]
    del params
    batch = to_cuda(next(lm_train_batches(cfg.vocab_size, TRAIN_4K_BATCH, S,
                                          seed=0)))
    step = lm_common.train_4k_step(cfg, accum_steps=TRAIN_4K_ACCUM)
    losses, secs = timed_steps(step, state, [batch], 1 + TRAIN_4K_TIMED)
    check(all(np.isfinite(losses)), f"train_4k losses {losses}")
    ms, tok_s, tflops = lm_rate(cfg, TRAIN_4K_BATCH * S, secs)
    print(f"  train_4k (batch {TRAIN_4K_BATCH} = {TRAIN_4K_ACCUM} x "
          f"{TRAIN_4K_BATCH // TRAIN_4K_ACCUM}, S {S}, bf16, remat, q_chunk "
          f"{cfg.q_chunk}): losses {[round(v, 4) for v in losses]}; median "
          f"step {ms:.1f} ms, {tok_s:.0f} tokens/s, {tflops:.1f} TFLOP/s "
          f"(6 N tokens), peak {peak_gb():.2f} GB")
    del state
    mb = {k: v[:TRAIN_4K_BATCH // TRAIN_4K_ACCUM] for k, v in batch.items()}
    peaks = {}
    for remat in (True, False):
        free_card()
        c = dataclasses.replace(cfg, n_layers=REMAT_LAYERS, remat=remat)
        p = tree_map(lambda t: t.requires_grad_(True),
                     init_params(c, seed=0, device="cuda"))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loss = tx.lm_loss(c, p, mb["tokens"], mb["labels"])
        grads = torch.autograd.grad(loss, tree_leaves(p))
        torch.cuda.synchronize()
        peaks[remat] = (torch.cuda.max_memory_allocated() - base) / 1e9
        del p, loss, grads
    check(peaks[True] < peaks[False], f"remat peaks {peaks}")
    print(f"  one microbatch ({TRAIN_4K_BATCH // TRAIN_4K_ACCUM}, {S}) at "
          f"{REMAT_LAYERS} layers, loss and gradient: peak over the weights "
          f"{peaks[True]:.2f} GB with remat, {peaks[False]:.2f} GB without")


def train_card_cpu_cell():
    """One make_train_step step of the Qwen2 smoke config in f32 (dense,
    TF32 off) from the same parameters on the card and on the CPU."""
    from repro_torch.configs.qwen2_1_5b import smoke_config
    from repro_torch.models import transformer as tx
    from repro_torch.models.params import init_params
    from repro_torch.training.data import lm_train_batches
    from repro_torch.training.optimizer import (adamw_init, tree_leaves,
                                                tree_map)
    from repro_torch.training.train_step import make_train_step
    cfg = dataclasses.replace(smoke_config(), prefill_backend="dense")
    params = init_params(cfg, seed=0, device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in
             next(lm_train_batches(cfg.vocab_size, 4, 64, seed=0)).items()}
    step = make_train_step(
        lambda p, b: tx.lm_loss(cfg, p, b["tokens"], b["labels"]),
        lr=TRAIN_LR)
    out = {}
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        newp, _, m = step(p, adamw_init(p),
                          {k: v.to(dev) for k, v in batch.items()})
        out[dev] = ({k: float(v) for k, v in m.items()},
                    [t.cpu() for t in tree_leaves(newp)])
    (mc, pc), (mg, pg) = out["cpu"], out["cuda"]
    rel = {k: abs(mg[k] - mc[k]) / abs(mc[k]) for k in mc}
    dp = max(float((a - b).abs().max()) for a, b in zip(pg, pc))
    check(all(r <= 1e-5 for r in rel.values()) and dp <= TRAIN_PARAM_ATOL,
          f"smoke step card vs CPU: relative {rel}, params {dp}")
    print(f"  smoke step, card vs CPU (f32): loss {mg['loss']:.6f} / "
          f"{mc['loss']:.6f}, relative differences {rel}, parameters "
          f"{dp:.2e} (limits rtol 1e-5, atol {TRAIN_PARAM_ATOL})")


def train_guard_cell():
    """``lm_loss`` with ``prefill_backend="cuda"`` and parameters that
    require grad must raise, naming B3, and launch nothing."""
    from repro_torch.configs.qwen2_1_5b import smoke_config
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.models import transformer as tx
    from repro_torch.models.params import init_params
    from repro_torch.training.optimizer import tree_map
    cfg = smoke_config()
    check(cfg.prefill_backend == "cuda", "the smoke config's backend")
    params = tree_map(lambda t: t.requires_grad_(True),
                      init_params(cfg, seed=0, device="cuda"))
    toks = torch.zeros((2, 32), dtype=torch.int32, device="cuda")
    n0 = flash_prefill.launches
    try:
        tx.lm_loss(cfg, params, toks, toks)
    except RuntimeError as exc:
        msg = str(exc)
    else:
        raise SmokeError("lm_loss through the cuda prefill with grad on "
                         "did not raise")
    check("flash_prefill" in msg and "no backward" in msg
          and flash_prefill.launches == n0, f"guard: {msg}")
    print(f"  guard: lm_loss through B3 with grad on raised: {msg}")


def train_wide_deep_cell():
    """Wide & Deep's train_batch cell at full size (B 65,536, 40 x 10^6 x
    32 tables, f32, bf16 gradients): WD_TRAIN_STEPS steps with B5 counted
    (2 launches a forward, nowhere else); then, on the first batch's ids,
    B5's forward held bit for bit against its plain version at this
    shape, and the tables' gradient from the autograd.Function's backward
    (plain index_add_, which reads no forward output) against autograd of
    the plain version.  Returns B5's launches on the train path."""
    from repro_torch.configs import wide_deep
    from repro_torch.configs.recsys_common import BATCHES
    from repro_torch.kernels.embedding_bag.ops import (embedding_bag_fused,
                                                       embedding_bag_ref,
                                                       fold_weights)
    from repro_torch.training import data
    from repro_torch.training.optimizer import adamw_init
    free_card()
    cfg = wide_deep.full_config()
    B, F, D = BATCHES["train_batch"], cfg.n_sparse, cfg.embed_dim
    params = wide_deep.model.init_params(cfg, seed=0, device="cuda")
    state = [params, adamw_init(params)]
    del params
    cell = wide_deep.train_cell(cfg)
    batches = [to_cuda(data.wide_deep_batch(
        np.random.RandomState(300 + i), B, F, cfg.rows_per_table,
        cfg.multi_hot, cfg.n_dense)) for i in range(WD_TRAIN_STEPS)]
    torch.cuda.synchronize()
    embedding_bag_fused.launches = 0
    losses, secs = timed_steps(cell.step, state, batches, WD_TRAIN_STEPS)
    launches = embedding_bag_fused.launches
    check(launches == 2 * WD_TRAIN_STEPS,
          f"wide-deep train: {launches} B5 launches in {WD_TRAIN_STEPS} "
          "steps")
    check(all(np.isfinite(losses)), f"wide-deep train losses {losses}")
    ms = float(np.median(secs[1:])) * 1e3
    print(f"  wide-deep train_batch (B {B}): losses "
          f"{[round(v, 4) for v in losses]}; median step {ms:.1f} ms, "
          f"{B / ms * 1e3:.0f} contexts/s, peak {peak_gb():.2f} GB; B5 "
          f"{launches} launches in {WD_TRAIN_STEPS} steps")
    profile_cell("wide-deep train step (eager)",
                 lambda i: cell.step(*state, batches[i]), calls=2)
    params = state[0]
    del state
    ids, mask = batches[0]["sparse_ids"], batches[0]["sparse_mask"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    g = torch.randn((B, F, D), generator=gen, device="cuda") * 1e-3
    table = params["tables"].detach().requires_grad_(True)
    out_kernel = embedding_bag_fused(table, ids, mask)
    out_plain = embedding_bag_ref(table, ids, fold_weights(ids, mask))
    eb_hold(out_kernel.detach(), out_plain.detach(), torch.float32,
            f"wide-deep train_batch tables {tuple(table.shape)}, ids "
            f"{tuple(ids.shape)}")
    d_kernel, = torch.autograd.grad(out_kernel, table, g)
    d_plain, = torch.autograd.grad(out_plain, table, g)
    err = float((d_kernel - d_plain).abs().max())
    check(torch.allclose(d_kernel, d_plain, **B5_GRAD_TOL),
          f"B5's table gradient vs the plain version's: max |diff| {err}")
    print(f"  B5's table gradient: the autograd.Function's plain backward "
          f"(index_add_) vs autograd of the plain version: max |diff| "
          f"{err:.3e} over {int((d_plain != 0).sum())} nonzero entries "
          f"({B5_GRAD_TOL})")
    return launches


def train_recsys_cell(name):
    """RECSYS_TRAIN_STEPS train steps of ``name`` at full width at its cut
    (RECSYS_TRAIN_CUTS) on one batch: finite losses, and every parameter
    tree moves."""
    from repro_torch import configs
    from repro_torch.training import data
    from repro_torch.training.optimizer import adamw_init, tree_leaves
    free_card()
    mod = configs.get_arch(name)
    cfg = mod.full_config()
    batch, cut = RECSYS_TRAIN_CUTS[name]
    rng = np.random.RandomState(400)
    if name == "two-tower-retrieval":
        b = data.two_tower_batch(rng, batch, cfg.n_user_fields,
                                 cfg.n_item_fields, cfg.rows_per_table)
    else:
        b = data.seq_rec_batch(rng, batch, cfg.seq_len, cfg.n_items,
                               causal=name == "sasrec", n_neg=mod.N_NEG)
    b = to_cuda(b)
    params = mod.model.init_params(cfg, seed=0, device="cuda")
    cell = mod.train_cell(cfg, batch=batch)
    state = [params, adamw_init(params)]
    losses, secs = timed_steps(cell.step, state, [b], RECSYS_TRAIN_STEPS)
    moved = [k for k in params if any(
        not torch.equal(a, c) for a, c in zip(tree_leaves(state[0][k]),
                                              tree_leaves(params[k])))]
    check(all(np.isfinite(losses)) and moved == list(params),
          f"{name} train: losses {losses}, moved {moved}")
    print(f"  {name} train_batch ({cut}): losses "
          f"{[round(v, 4) for v in losses]}; first call "
          f"{secs[0] * 1e3:.1f} ms, warm step {secs[-1] * 1e3:.1f} ms, "
          f"{batch / secs[-1]:.0f} rows/s warm, peak {peak_gb():.2f} GB; "
          "every parameter tree moved")


def train_phase():
    """Training on the card: the LM train CLI with checkpoint and resume,
    the train_4k config, card = CPU at smoke size, the gradient guard, and
    the recsys train cells.  Returns B5's launches on the train path."""
    train_cli_cell()
    train_4k_cell()
    train_card_cpu_cell()
    train_guard_cell()
    launches = train_wide_deep_cell()
    for name in RECSYS_TRAIN_CUTS:
        train_recsys_cell(name)
    free_card()
    return launches


# --------------------------------------------------------------------- GNN
GNN_STEPS = 2                 # train steps a cell on one repeated batch
                              # (cut from 3 for (h)'s time)
                              # (the first, cold, left out of the median)
# card against CPU (smoke size, f32, TF32 off) and chunked against dense:
# f32 sums in another order (index_add_ adds with atomics on the card);
# atol is taken of the largest |value| of each array (of the whole
# gradient for gradient leaves: attn_b's is zero but for rounding)
GNN_SMOKE_TOL = dict(rtol=1e-4, atol=1e-5)
# chunked against dense at full width in f32: 12 layers of the same sums,
# the chunked path's segment sums split in two
GNN_WIDE_TOL = dict(rtol=1e-3, atol=1e-4)
RGG_CUTOFF = 0.145            # random_geometric_graph(seed 0, 2,708 nodes,
                              # box 2): 10,552 directed edges (Cora 10,556)
REDDIT_NODES, REDDIT_FEAT, REDDIT_CLASSES = 232_965, 602, 41
GNN_LG_LAYERS = 4             # minibatch_lg's depth cut 12 -> 4 (time)
REDDIT_DEGREE = 50            # in-edges a node of the base graph: cut from
                              # Reddit's ~492; the sampler draws with
                              # replacement, so its padded shapes do not
                              # depend on it
MB_SEEDS, MB_FANOUTS = 1024, [15, 10]
WIDE_CHUNKS = 2               # the full-width chunked path: ogb_products'
                              # edge_chunk, two chunks of a synthetic graph
                              # with its mean in-degree
GNN_WIDE_LAYERS = 4           # its depth cut 12 -> 4 (time)
GNN_SPLIT = {                 # profiler range -> op class of the step split
    "gnn.wigner": "Wigner-D recursion (rotation_to_z, wigner_blocks)",
    "gnn.apply_blocks": "apply_blocks",
    "gnn.so2": "SO(2) products (_so2_conv)",
    "gnn.segment": "gathers and scatter-adds",
    "gnn.eq_norm": "_eq_norm",
    "gnn.ffn": "FFN",
    "gnn.adamw": "AdamW"}
GATHER_OPS = ("aten::index", "aten::index_select", "aten::index_add",
              "aten::scatter_reduce", "aten::index_put_")


def gnn_batch(cfg_mod, shape, b):
    """A numpy graph batch on the card with the cell's inputs, in order."""
    names = [i.name for i in cfg_mod.train_cell(shape).inputs]
    return {k: torch.from_numpy(np.asarray(b[k])).cuda() for k in names}


def close_tree(label, got, want, tol, scale=None):
    """Every array of ``got`` (card) against ``want``: rtol, and atol taken
    of ``scale`` or the array's own largest |value|.  Returns the largest
    error relative to that scale."""
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = g.detach().double().cpu(), w.detach().double().cpu()
        s = scale if scale is not None else float(w.abs().max())
        err = float((g - w).abs().max())
        ok = bool(torch.isfinite(g).all()) and torch.allclose(
            g, w, rtol=tol["rtol"], atol=tol["atol"] * max(s, 1e-30))
        check(ok, f"{label}: array {i} differs (max abs err {err}, scale "
                  f"{s})")
        worst = max(worst, err / max(s, 1e-30))
    return worst


def gnn_card_cpu_cell():
    """smoke_config in f32 on one random geometric graph: forward,
    node_class_loss and every gradient leaf on the card against the port
    on the CPU; then the chunked path against the dense path on the
    card."""
    from repro_torch.configs import equiformer_v2 as ecfg
    from repro_torch.models.gnn import equiformer as eq
    from repro_torch.training import data
    from repro_torch.training.optimizer import tree_leaves
    cfg = ecfg.smoke_config()
    rng = np.random.RandomState(0)
    g = data.random_geometric_graph(rng, 64, cfg.d_feat_in, cutoff=0.6,
                                    max_edges=256)
    g["labels"] = rng.randint(-1, cfg.n_out, 64).astype(np.int32)
    params = eq.init_params(cfg, seed=0, device="cpu")

    def run(dev, chunk):
        """(forward outputs, loss, gradient leaves) on ``dev``."""
        c = dataclasses.replace(cfg, edge_chunk=chunk)
        p = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                     params)
        b = {k: torch.from_numpy(v).to(dev) for k, v in g.items()}
        fwd = eq.forward(c, p, *(b[k] for k in ("node_feat", "positions",
                                                "edges", "edge_mask")))
        loss = eq.node_class_loss(c, p, b)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        return [fwd[k] for k in sorted(fwd)], loss, list(grads)

    cpu, card = run("cpu", 0), run("cuda", 0)
    for label, got, want in (
            ("card vs CPU", card, cpu),
            ("chunked (4 chunks) vs dense, card", run("cuda", 64), card)):
        e_out = close_tree(f"{label} forward", got[0], want[0],
                           GNN_SMOKE_TOL)
        e_loss = close_tree(f"{label} loss", [got[1]], [want[1]],
                            GNN_SMOKE_TOL)
        scale = max(float(w.abs().max()) for w in want[2])
        e_grad = close_tree(f"{label} gradients", got[2], want[2],
                            GNN_SMOKE_TOL, scale)
        print(f"  smoke {label} (f32, 64 nodes, 256 edge slots): forward "
              f"{e_out:.2e}, loss {e_loss:.2e}, {len(got[2])} gradient "
              f"leaves {e_grad:.2e} (largest error over the scale; "
              f"{GNN_SMOKE_TOL}, atol of the scale)")


class gnn_ranges:
    """While active, the GNN's op classes (GNN_SPLIT) run inside profiler
    ranges: the port's functions are wrapped in their modules and put back
    on exit."""
    TARGETS = (("models.gnn.equiformer", "_edge_frames", "gnn.wigner"),
               ("models.gnn.equiformer", "apply_blocks", "gnn.apply_blocks"),
               ("models.gnn.equiformer", "_so2_conv", "gnn.so2"),
               ("models.gnn.equiformer", "_segment_max", "gnn.segment"),
               ("models.gnn.equiformer", "_segment_sum", "gnn.segment"),
               ("models.gnn.equiformer", "_eq_norm", "gnn.eq_norm"),
               ("models.gnn.equiformer", "_ffn", "gnn.ffn"),
               ("training.train_step", "adamw_update", "gnn.adamw"))

    def __enter__(self):
        import importlib

        from torch.profiler import record_function
        self.saved = []
        for mod, name, rng in self.TARGETS:
            m = importlib.import_module(f"repro_torch.{mod}")
            fn = getattr(m, name)

            def wrapped(*a, _fn=fn, _rng=rng, **k):
                with record_function(_rng):
                    return _fn(*a, **k)

            self.saved.append((m, name, fn))
            setattr(m, name, wrapped)
        return self

    def __exit__(self, *exc):
        for m, name, fn in self.saved:
            setattr(m, name, fn)


def gnn_profile(label, fn):
    """One call of fn() under torch.profiler: wall time, device busy time
    and idle share, launches, the three kernels that take the most device
    time, and the device time split by op class: each kernel goes to the
    innermost GNN_SPLIT range around the op that launched it; a backward
    kernel to the class of the forward op that made its autograd node
    (sequence number and forward thread); a kernel outside them launched
    under an indexing op to the gathers and scatter-adds; the rest to
    "other" (the attention weights and aggregation, the head, casts).  The
    ranges' own spans on the device timeline are not kernels and are left
    out."""
    from torch.profiler import ProfilerActivity, profile
    with gnn_ranges():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
    events = prof.events()

    def own_class(e):
        while e is not None:
            if e.name in GNN_SPLIT:
                return GNN_SPLIT[e.name]
            if e.name in GATHER_OPS:
                return GNN_SPLIT["gnn.segment"]
            e = e.cpu_parent
        return None

    fwd_class = {}
    for e in events:
        if e.sequence_nr >= 0 and not e.name.startswith("autograd::"):
            c = own_class(e)
            if c is not None:
                fwd_class.setdefault((e.thread, e.sequence_nr), c)
    # the profiler hands an op the kernels of its correlation id, and ops
    # that share an id (~1,700 in a minibatch_lg step on the H100) each
    # get them all: each id's kernels go once, to the latest of its ops
    # to start
    launcher = {}
    for e in events:
        if e.kernels and (e.id not in launcher or e.time_range.start
                          > launcher[e.id].time_range.start):
            launcher[e.id] = e
    shared = sum(1 for e in events if e.kernels) - len(launcher)
    split, by_name = {}, {}             # class -> [ms, launches]
    for e in launcher.values():
        c = own_class(e)
        a = e
        while c is None and a is not None:
            if a.name.startswith("autograd::engine::evaluate_function"):
                c = fwd_class.get((a.fwd_thread, a.sequence_nr))
                break
            a = a.cpu_parent
        for k in e.kernels:
            if k.name in GNN_SPLIT:     # a range's span on the device
                continue
            for key, table in ((c or "other", split), (k.name, by_name)):
                row = table.setdefault(key, [0.0, 0])
                row[0] += k.duration / 1e3
                row[1] += 1
    busy = sum(ms for ms, _ in split.values())
    n = sum(k for _, k in split.values())
    device = sum(e.time_range.elapsed_us() for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name not in GNN_SPLIT) / 1e3
    print(f"    profile {label}: wall {wall:.1f} ms, device busy {device:.1f} "
          f"ms, idle share {1 - device / wall:.3f}, {n} launches; "
          f"{busy:.1f} ms of kernels attributed to ops ({shared} ops "
          "shared a correlation id)")
    for name, (ms, k) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:3]:
        print(f"      {ms:9.3f} ms {k:6d}x  {name[:80]}")
    print("      by op class: " + "; ".join(
        f"{k} {ms:.3f} ({ms / busy:.3f}, {c} kernels)"
        for k, (ms, c) in sorted(split.items(), key=lambda kv: -kv[1][0])))
    return dict(wall=wall, busy=device, launches=n, split=split)


def gnn_train_cell(shape, batch, cut=None, layers=None):
    """One GNN train cell at full width (bf16, remat, random weights from
    seed 0; its depth cut to ``layers`` where given) on ``batch``: the
    forward timed (no grad), GNN_STEPS train steps on the repeated batch
    (the loss must fall), their median, rates, TFLOP/s, the bound, peak
    memory, a profile of a step and its device time by op class.  Returns
    the cell's numbers."""
    from repro_torch.configs import equiformer_v2 as ecfg
    from repro_torch.models.gnn import equiformer as eq
    from repro_torch.training.optimizer import adamw_init
    free_card()
    cfg = ecfg.full_config(shape)
    if layers is not None:
        cut = (f"depth cut to {layers} of {cfg.n_layers} layers"
               + (f", {cut}" if cut else ""))
        cfg = dataclasses.replace(cfg, n_layers=layers)
    c = ecfg.CELLS[shape]
    N, E = c["n_nodes"], c["n_edges"]
    check(batch["edges"].shape[0] == E and batch["node_feat"].shape[0] == N,
          f"{shape}: batch {batch['node_feat'].shape[0]} nodes, "
          f"{batch['edges'].shape[0]} edges")
    n_real = int(batch["edge_mask"].sum())
    params = eq.init_params(cfg, seed=0, device="cuda")
    ins = [batch[k] for k in ("node_feat", "positions", "edges",
                              "edge_mask")]
    if shape == "molecule":
        ins += [batch["graph_ids"], c["n_graphs"]]
    with torch.no_grad():
        out = eq.forward(cfg, params, *ins)
        fwd_ms = time_calls(lambda i: eq.forward(cfg, params, *ins), 1,
                            warmup=0)
    check(all(bool(torch.isfinite(v).all()) for v in out.values())
          and out["node_out"].shape == (N, cfg.n_out),
          f"{shape}: forward outputs")
    del out
    cell = ecfg.train_cell(shape, cfg)
    state = [params, adamw_init(params)]
    del params
    torch.cuda.reset_peak_memory_stats()
    losses, secs = timed_steps(cell.step, state, [batch], GNN_STEPS)
    peak = peak_gb()
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{shape}: losses on one repeated batch {losses}")
    ms = float(np.median(secs[1:])) * 1e3
    flops = ecfg.model_flops(cfg, E)
    nbytes = ecfg.bytes_floor(cfg, N, E)
    b_ms, b_by = bound(nbytes, flops, torch.bfloat16)
    print(f"  {shape} (N {N:,}, E {E:,}: {n_real:,} real; d "
          f"{cfg.d_feat_in}, {cfg.n_out} {'classes' if cfg.node_level else 'targets'}"
          f"{'; ' + cut if cut else ''}): forward {fwd_ms:.2f} ms; train "
          f"step median {ms:.1f} ms (first {secs[0] * 1e3:.1f}), "
          f"{N / ms * 1e3:.4g} nodes/s, {E / ms * 1e3:.4g} edges/s, "
          f"{flops / ms / 1e9:.1f} TFLOP/s ({flops / 1e12:.2f} TFLOP), bound "
          f"{b_ms:.1f} ms ({b_by}: {nbytes / 1e9:.1f} GB floor) = "
          f"{b_ms / ms:.3f} of the step; peak {peak:.2f} GB; losses "
          f"{[round(v, 4) for v in losses]}")
    prof = gnn_profile(f"a {shape} train step",
                       lambda: cell.step(*state, batch))
    return dict(fwd_ms=fwd_ms, step_ms=ms, bound_ms=b_ms, peak=peak, **prof)


def reddit_like_batch():
    """minibatch_lg's batch: a synthetic base graph of Reddit's 232,965
    nodes (d 602, 41 classes) with REDDIT_DEGREE random in-edges a node,
    ``sample_subgraph`` from MB_SEEDS seeds with fanouts MB_FANOUTS (timed
    on the host), features, positions and labels of the sampled nodes;
    labels only on the seeds."""
    from repro_torch.models.gnn import sampler
    rng = np.random.RandomState(7)
    Nb = REDDIT_NODES
    t0 = time.perf_counter()
    edges = np.stack([rng.randint(0, Nb, Nb * REDDIT_DEGREE),
                      np.repeat(np.arange(Nb), REDDIT_DEGREE)], 1)
    g = sampler.CSRGraph.from_edges(edges, Nb)
    t_csr = time.perf_counter() - t0
    seeds = rng.choice(Nb, MB_SEEDS, replace=False)
    t0 = time.perf_counter()
    nodes, e, mask, slots = sampler.sample_subgraph(g, seeds, MB_FANOUTS,
                                                    rng)
    t_smp = time.perf_counter() - t0
    n_uniq = len(np.unique(nodes))
    print(f"  minibatch_lg base graph: {Nb:,} nodes, {len(edges):,} edges "
          f"(in-degree {REDDIT_DEGREE}, cut from Reddit's ~492), CSR "
          f"{t_csr:.2f} s; sample_subgraph ({MB_SEEDS} seeds, fanouts "
          f"{MB_FANOUTS}) {t_smp * 1e3:.0f} ms on the host: {len(nodes):,} "
          f"node slots ({n_uniq:,} distinct), {len(e):,} edge slots "
          f"({int(mask.sum()):,} real)")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    feats = torch.randn((Nb, REDDIT_FEAT), generator=gen, device="cuda")
    pos = torch.rand((Nb, 3), generator=gen, device="cuda") * 2.0
    base_labels = torch.randint(0, REDDIT_CLASSES, (Nb,), generator=gen,
                                device="cuda", dtype=torch.int32)
    idx = torch.from_numpy(nodes).cuda()
    labels = torch.full((len(nodes),), -1, dtype=torch.int32, device="cuda")
    s = torch.from_numpy(slots.astype(np.int64)).cuda()
    labels[s] = base_labels[torch.from_numpy(seeds).cuda()]
    return {"node_feat": feats[idx], "positions": pos[idx],
            "edges": torch.from_numpy(e).cuda(),
            "edge_mask": torch.from_numpy(mask).cuda(), "labels": labels}


def gnn_chunked_cell():
    """The chunked path at full width: ogb_products' d, classes and
    edge_chunk on a synthetic graph of WIDE_CHUNKS chunks with its mean
    in-degree; the chunked forward against the dense one in f32 (remat
    off, no grad), then both timed in bf16 with their peak memory."""
    from repro_torch.configs import equiformer_v2 as ecfg
    from repro_torch.models.gnn import equiformer as eq
    free_card()
    c = ecfg.CELLS["ogb_products"]
    cfg = dataclasses.replace(ecfg.full_config("ogb_products"), remat=False,
                              n_layers=GNN_WIDE_LAYERS)
    E = WIDE_CHUNKS * cfg.edge_chunk
    N = round(E * c["n_nodes"] / c["n_edges"])
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    ins = [torch.randn((N, cfg.d_feat_in), generator=gen, device="cuda"),
           torch.rand((N, 3), generator=gen, device="cuda") * 2.0,
           torch.randint(0, N, (E, 2), generator=gen, device="cuda",
                         dtype=torch.int32),
           torch.ones(E, dtype=torch.bool, device="cuda")]
    res = {}
    for dtype in ("float32", "bfloat16"):
        for path, chunk in (("chunked", cfg.edge_chunk), ("dense", 0)):
            cc = dataclasses.replace(cfg, dtype=dtype, edge_chunk=chunk)
            params = eq.init_params(cc, seed=0, device="cuda")
            free_card()
            base = torch.cuda.memory_allocated()
            with torch.no_grad():
                out = eq.forward(cc, params, *ins)["node_out"]
                torch.cuda.synchronize()
                peak = (torch.cuda.max_memory_allocated() - base) / 1e9
                ms = time_calls(lambda i: eq.forward(cc, params, *ins), 1,
                                warmup=0) if dtype == "bfloat16" else None
            res[(dtype, path)] = (out, ms, peak)
            del params
    err = close_tree("full-width chunked vs dense (f32)",
                     [res[("float32", "chunked")][0]],
                     [res[("float32", "dense")][0]], GNN_WIDE_TOL)
    print(f"  chunked path at full width (ogb_products' d {cfg.d_feat_in}, "
          f"{cfg.n_out} classes, edge_chunk {cfg.edge_chunk:,}, depth cut "
          f"to {cfg.n_layers} of 12 layers; synthetic "
          f"graph N {N:,}, E {E:,} = {WIDE_CHUNKS} chunks): chunked vs "
          f"dense f32 node_out {err:.2e} of max|ref| ({GNN_WIDE_TOL}); "
          f"forward peak over the weights f32 chunked "
          f"{res[('float32', 'chunked')][2]:.2f} GB, dense "
          f"{res[('float32', 'dense')][2]:.2f} GB")
    print(f"    bf16 forward (no grad): chunked "
          f"{res[('bfloat16', 'chunked')][1]:.1f} ms, peak "
          f"{res[('bfloat16', 'chunked')][2]:.2f} GB; dense "
          f"{res[('bfloat16', 'dense')][1]:.1f} ms, peak "
          f"{res[('bfloat16', 'dense')][2]:.2f} GB")
    n, e = c["n_nodes"], c["n_edges"]
    x_gb = n * cfg.lsq * cfg.channels * 2 / 1e9
    print(f"  ogb_products ({n:,} nodes, {e:,} edges) not run: one (N, 49, "
          f"128) bf16 tensor is {x_gb:.1f} GB, a forward holds at least "
          f"four (x, its norm, the num accumulator, agg: "
          f"{4 * x_gb:.0f} GB) and training keeps 12 layer inputs "
          f"({12 * x_gb:.0f} GB): it waits for multi-GPU (ROADMAP A16); "
          f"its E is no multiple of its edge_chunk "
          f"({e % c['edge_chunk']:,} over), so forward would run it dense")


def gnn_phase(card):
    """EquiformerV2 on the card (ROADMAP A18): card = CPU at smoke size,
    the train cells full_graph_sm, molecule and minibatch_lg at full width,
    and the chunked path at full width; ``card`` is nvidia-smi's name and
    power limit, printed beside the bounds.  No kernel of the port may
    launch on this path."""
    from repro_torch import kernels
    from repro_torch.configs import equiformer_v2 as ecfg
    before = kernels.snapshot()
    gnn_card_cpu_cell()
    print(f"  bounds: model_flops over {PEAK_FLOPS[torch.bfloat16] / 1e12:.0f}"
          f" TFLOP/s (bf16) or bytes_floor over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, the larger; card and power "
          f"limit: {card}")
    cells = {shape: gnn_train_cell(shape, gnn_batch(ecfg, shape,
                                                    gnn_graph(shape)))
             for shape in ("full_graph_sm", "molecule")}
    cells["minibatch_lg"] = gnn_train_cell(
        "minibatch_lg", reddit_like_batch(), layers=GNN_LG_LAYERS,
        cut=f"base graph in-degree {REDDIT_DEGREE}")
    gnn_chunked_cell()
    moved = kernels.diff(kernels.snapshot(), before)
    check(not moved, f"the GNN path launched port kernels: {moved}")
    print("  no kernel of the port launched on the GNN path")
    free_card()
    return cells

# ------------------------------------------------------------------- cost
COST_RECSYS = (("wide_deep", ("serve_p99", "serve_bulk", "retrieval_cand",
                              "train_batch")),
               ("two_tower_retrieval", ("serve_p99", "retrieval_cand")),
               ("sasrec", ("serve_p99", "retrieval_cand")),
               ("bert4rec", ("serve_p99", "retrieval_cand")))
COST_GNN = ("molecule",)      # full_graph_sm cut for time (PERF.md keeps
                              # its measured share)
COST_CALLS = 5                # timed calls a cell (GNN and train: 2)
COST_SHARE_MAX = 1.05         # bound / measured above this: the count
#                               charges work the program does not do
LONG_S, LONG_T = 524288, 65   # Qwen2-1.5B's long_500k cell: B 1, one step
COST_PREFILL = (1, LONG_PREFILL)  # (B, S) of the long prompt through B3


def cost_cell(label, cell, run, calls):
    """Trace ``cell`` on meta (``launch.dryrun._trace_cell``) and take its
    roofline, then run ``run(i)`` on the card: the median event-timed ms of
    ``calls`` calls, the device ms (torch.profiler, informative) and the
    peak memory allocated.  The share is bound / measured, at most
    COST_SHARE_MAX."""
    from repro_torch.launch.dryrun import _trace_cell
    from repro_torch.launch.roofline import bound_seconds, roofline
    t0 = time.perf_counter()
    tr = _trace_cell(cell)
    t_trace = time.perf_counter() - t0
    rf = roofline(tr, 1, meta=cell.meta)
    b_ms = bound_seconds(rf) * 1e3
    by = "operations" if rf["compute_s"] * 1e3 >= b_ms else "bytes"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = time_calls(run, calls, warmup=1)
    card_peak = peak_gb()
    dev, n_dev = device_busy_ms(run, 1 if calls <= 2 else 3)
    share, share_dev = b_ms / ms, b_ms / max(dev, 1e-9)
    tflop = ", ".join(f"{dt} {f / 1e12:.4g}" for dt, f in
                      sorted(rf["flops_by_dtype"].items()))
    print(f"  {label}: counted TFLOP {tflop}; raw {tr['bytes accessed'] / 1e9:.4g}"
          f" GB, floor {rf['floor_bytes_per_chip'] / 1e9:.4g} GB; bound "
          f"{b_ms:.4f} ms ({by}); measured {ms:.4f} ms (device {dev:.4f}, "
          f"{n_dev:.0f} launches seen a call); "
          f"share {share:.4f} (device {share_dev:.4f}); peak meta "
          f"{tr['peak_memory_in_bytes'] / 1e9:.3f} GB, card {card_peak:.3f} "
          f"GB [trace {t_trace:.1f} s, {tr['n_ops']} ops; cell "
          f"{time.perf_counter() - t0:.1f} s]")
    check(share <= COST_SHARE_MAX,
          f"{label}: the bound {b_ms:.4f} ms is over {COST_SHARE_MAX} of the "
          f"measured {ms:.4f} ms: the count charges work the program does "
          "not do")
    return dict(flops_by_dtype=rf["flops_by_dtype"],
                raw_bytes=tr["bytes accessed"],
                floor_bytes=rf["floor_bytes_per_chip"], bound_ms=b_ms,
                bound_by=by, ms=ms, device_ms=dev, share=share,
                share_device=share_dev, device_launches=n_dev,
                meta_peak_gb=tr["peak_memory_in_bytes"] / 1e9,
                card_peak_gb=card_peak)


def device_busy_ms(fn, calls):
    """(device ms, launches) per call of fn(i) in one torch.profiler window
    over ``calls`` calls, every kernel summed.  Informative only: the
    profiler can drop a small call's launches after an earlier profile in
    the process (``timing.device_ms`` checks the count of a kernel's
    launches, which a step of thousands varies by a few from call to
    call), so the gate reads the event-timed calls."""
    from torch.profiler import ProfilerActivity, profile
    fn(0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for i in range(calls):
            fn(i)
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
            sum(e.count for e in kernels) / calls)


def card_input(name, meta, cfg, gen):
    """A recsys cell's input on the card with the meta tensor's shape and
    dtype: ids in their table's range (the sequence models' items from 2,
    past PAD and MASK), masks three quarters set (``pad_mask`` all), labels
    0/1, the rest N(0, 1)."""
    shape, dev = tuple(meta.shape), "cuda"
    if meta.dtype == torch.bool:
        if name == "pad_mask":
            return torch.ones(shape, dtype=torch.bool, device=dev)
        return torch.rand(shape, generator=gen, device=dev) > 0.25
    if meta.dtype == torch.int32:
        lo, hi = ((2, cfg.n_items) if name in ("ids", "cand_ids")
                  else (0, cfg.rows_per_table))
        return torch.randint(lo, hi, shape, generator=gen, device=dev,
                             dtype=torch.int32)
    if name == "labels":
        return torch.randint(0, 2, shape, generator=gen, device=dev).float()
    return torch.randn(shape, generator=gen, device=dev)


def same_layout(label, got, want):
    """The card's inputs have the meta cell's shapes and dtypes."""
    g = [(tuple(t.shape), t.dtype) for t in got]
    w = [(tuple(t.shape), t.dtype) for t in want]
    check(g == w, f"{label}: card inputs {g} are not the traced cell's {w}")


def finite_outputs(label, out):
    from repro_torch.configs.common import tensor_leaves
    ts = [t for t in tensor_leaves(out) if torch.is_floating_point(t)]
    check(ts and all(bool(torch.isfinite(t).all()) for t in ts),
          f"{label}: non-finite output")


def cost_recsys(rows):
    """The recsys cells of COST_RECSYS: each arch's parameters made once on
    the card (f32, seed 0), the cell's inputs by name at the traced
    shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.training.optimizer import adamw_init
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for arch, shapes in COST_RECSYS:
        mod = get_arch(arch)
        cfg = mod.full_config()
        free_card()
        params = mod.model.init_params(cfg, seed=0, device="cuda")
        for shape in shapes:
            cell = mod.build_cell(shape)
            label = f"{arch} {shape}"
            train = shape == "train_batch"
            names = [i.name for i in (mod.train_cell(cfg) if train else
                                      mod.serve_cell(shape, cfg)).inputs]
            metas = ([cell.args[2][n] for n in names] if train
                     else cell.args[1:])
            ins = [card_input(n, m, cfg, gen) for n, m in zip(names, metas)]
            if train:
                opt, batch = adamw_init(params), dict(zip(names, ins))
                run = lambda i: cell.fn(params, opt, batch)  # noqa: E731
                finite_outputs(label, run(0)[2])
            else:
                run = lambda i: cell.fn(params, *ins)  # noqa: E731
                finite_outputs(label, run(0))
            rows[label] = cost_cell(label, cell, run,
                                    2 if train else COST_CALLS)
            del run, cell, ins
            opt = batch = None
        del params


def gnn_graph(shape):
    """The host graph of the GNN cell ``shape`` (full_graph_sm or
    molecule), as the gnn phase draws it."""
    from repro_torch.configs import equiformer_v2 as ecfg
    from repro_torch.training import data
    if shape == "molecule":
        return data.batched_molecules(np.random.RandomState(1), 128, 30, 64,
                                      64)
    rng = np.random.RandomState(0)
    c = ecfg.CELLS[shape]
    g = data.random_geometric_graph(rng, c["n_nodes"], c["d_feat"],
                                    cutoff=RGG_CUTOFF,
                                    max_edges=c["n_edges"])
    check(int(g["edge_mask"].sum()) < c["n_edges"],
          f"{shape}: the cutoff fills the edge cap")
    g["labels"] = rng.randint(0, c["n_out"], c["n_nodes"]).astype(np.int32)
    return g


def cost_gnn(rows):
    """EquiformerV2's COST_GNN cells: one train step (bf16, remat) on the
    graphs of the gnn phase."""
    from repro_torch.configs import equiformer_v2 as ecfg
    from repro_torch.models.gnn import equiformer as eq
    from repro_torch.training.optimizer import adamw_init
    for shape in COST_GNN:
        free_card()
        cell = ecfg.build_cell(shape)
        batch = gnn_batch(ecfg, shape, gnn_graph(shape))
        same_layout(f"equiformer-v2 {shape}", list(batch.values()),
                    [cell.args[2][k] for k in batch])
        params = eq.init_params(ecfg.full_config(shape), seed=0,
                                device="cuda")
        opt = adamw_init(params)
        run = lambda i: cell.fn(params, opt, batch)  # noqa: E731
        finite_outputs(f"equiformer-v2 {shape}", run(0)[2])
        rows[f"equiformer_v2 {shape}"] = cost_cell(
            f"equiformer_v2 {shape}", cell, run, 2)
        del run, params, opt


def cost_lm(rows):
    """Qwen2-1.5B (bf16, seed 0): the prefill and the fused step at the
    dense phase's serving shapes (4 lanes, prefill_len 128, T 33, S 512)
    and a long prompt (COST_PREFILL), traced with the dense backends and
    run through B3 and B1; then the reference's long_500k cell, one fused
    step on a zero cache with cache_lens S - T through B1, after B1 is
    held against its plain version at the last layer's K/V, and its
    logits held against the f32 dense step's (``long_logits``)."""
    from repro_torch import kernels
    from repro_torch.configs import lm_common, qwen2_1_5b
    from repro_torch.configs.common import Cell, abstract, tensor_leaves
    from repro_torch.kernels.flash_prefill.ops import flash_prefill
    from repro_torch.kernels.tree_attention.ops import (
        tree_attention, tree_attention_reference)
    from repro_torch.models import transformer as tx
    from repro_torch.models.attention import build_full_tree_mask
    from repro_torch.models.params import init_params
    free_card()
    base = dataclasses.replace(qwen2_1_5b.full_config(), dtype="bfloat16",
                               param_dtype="bfloat16")
    dense = dataclasses.replace(base, prefill_backend="dense",
                                decode_backend="dense")
    cuda = dataclasses.replace(base, prefill_backend="cuda",
                               decode_backend="cuda")
    params = init_params(cuda, seed=0, device="cuda")
    mparams = init_params(dense, device="meta")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    V, L = base.vocab_size, base.n_layers
    B, S = PATH_PREFILL[0][:2]
    T = PATH_TREE[1]

    def step_inputs(cfg, B, T, start):
        """decode_args on the card: a chain tree of T slots at cache_lens
        ``start``."""
        cache, lens, tok, pos, mask, parent, n_live = lm_common.decode_args(
            cfg, B, T, device="cuda")
        lens.fill_(start)
        tok.copy_(torch.randint(0, V, (B, T), generator=gen, device="cuda"))
        pos.copy_(start + torch.arange(T, device="cuda"))
        mask.copy_(torch.ones(T, T, dtype=torch.bool, device="cuda").tril())
        parent.copy_(torch.arange(T, device="cuda") - 1)
        n_live.fill_(T)
        return cache, lens, tok, pos, mask, parent, n_live

    # prefill (4, 128) through B3
    cell = Cell("qwen2_1_5b", "prefill (4,128)", "prefill",
                lm_common._prefill_fn(dense),
                (mparams, abstract((B, S), "int32"), abstract((B,), "int32"),
                 tx.init_cache(dense, B, device=torch.device("meta"))),
                lm_common._meta(dense, B * S, "prefill", S, B))
    toks = torch.randint(0, V, (B, S), generator=gen, device="cuda",
                         dtype=torch.int32)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    cache = tx.init_cache(cuda, B, device=torch.device("cuda"))
    same_layout("prefill (4,128)", [toks, lens, cache["k"]],
                [cell.args[1], cell.args[2], cell.args[3]["k"]])
    run = lambda i: lm_common._prefill_fn(cuda)(params, toks, lens, cache)  # noqa: E731
    n0 = flash_prefill.launches
    finite_outputs("prefill (4,128)", run(0)[1])
    check(flash_prefill.launches - n0 == L, f"prefill: "
          f"{flash_prefill.launches - n0} B3 launches, not {L}")
    rows["qwen2_1_5b prefill (4,128)"] = cost_cell(
        "qwen2_1_5b prefill (4,128)", cell, run, COST_CALLS)
    del cache, run

    # a long prompt (1, 4096) through B3: the dense program's count holds
    # the whole S x S square of scores, B3 computes its causal half
    PB, PS = COST_PREFILL
    pdense = dataclasses.replace(dense, max_seq_len=PS)
    pcuda = dataclasses.replace(cuda, max_seq_len=PS)
    label = f"qwen2_1_5b prefill ({PB},{PS})"
    cell = Cell("qwen2_1_5b", f"prefill ({PB},{PS})", "prefill",
                lm_common._prefill_fn(pdense),
                (mparams, abstract((PB, PS), "int32"),
                 abstract((PB,), "int32"),
                 tx.init_cache(pdense, PB, device=torch.device("meta"))),
                lm_common._meta(pdense, PB * PS, "prefill", PS, PB))
    toks = torch.randint(0, V, (PB, PS), generator=gen, device="cuda",
                         dtype=torch.int32)
    lens = torch.full((PB,), PS, dtype=torch.int32, device="cuda")
    cache = tx.init_cache(pcuda, PB, device=torch.device("cuda"))
    run = lambda i: lm_common._prefill_fn(pcuda)(params, toks, lens, cache)  # noqa: E731
    n0 = flash_prefill.launches
    finite_outputs(label, run(0)[1])
    check(flash_prefill.launches - n0 == L, f"{label}: "
          f"{flash_prefill.launches - n0} B3 launches, not {L}")
    rows[label] = cost_cell(label, cell, run, COST_CALLS)
    square = 4 * PB * base.n_heads * PS * PS * base.dh * L
    peak = PEAK_FLOPS[torch.bfloat16]
    print(f"  {label}: full-square attention {square / 1e12:.4g} TFLOP of "
          f"the counted {sum(rows[label]['flops_by_dtype'].values()) / 1e12:.4g};"
          f" B3's causal half would take the bound from "
          f"{rows[label]['bound_ms']:.4f} to "
          f"{rows[label]['bound_ms'] - square / 2 / peak * 1e3:.4f} ms "
          f"(share {(rows[label]['bound_ms'] - square / 2 / peak * 1e3) / rows[label]['ms']:.4f})")
    rows[label]["square_attention_flops"] = square
    del cache, run, toks, lens

    # the fused step (4, 33) at S 512 through B1
    cell = Cell("qwen2_1_5b", "fused_step (4,33)", "decode",
                lm_common._serve_fn(dense),
                (mparams,) + lm_common.decode_args(dense, B, T),
                lm_common._meta(dense, B * T, "decode", dense.max_seq_len, B))
    args = step_inputs(cuda, B, T, S)
    same_layout("fused_step (4,33)", tensor_leaves(args),
                tensor_leaves(cell.args[1:]))
    fused = lm_common._serve_fn(cuda)
    run = lambda i: fused(params, *args)  # noqa: E731
    n0 = tree_attention.launches
    _, packed = run(0)
    check(tree_attention.launches - n0 == L and packed.shape == (B, 1 + 2 * T)
          and bool((packed[:, 0] >= 1).all()),
          f"fused_step (4,33): {tree_attention.launches - n0} B1 launches, "
          f"packed {tuple(packed.shape)}")
    rows["qwen2_1_5b fused_step (4,33)"] = cost_cell(
        "qwen2_1_5b fused_step (4,33)", cell, run, COST_CALLS)
    del args, run, packed

    # long_500k: B 1, S 524,288, T 65 through B1
    free_card()
    cell = qwen2_1_5b.build_cell("long_500k")
    check(cell.meta["batch"] == 1 and cell.meta["seq"] == LONG_S
          and cell.meta["tokens_per_step"] == LONG_T,
          f"long_500k meta {cell.meta}")
    lcfg = dataclasses.replace(cuda, max_seq_len=LONG_S)
    args = step_inputs(lcfg, 1, LONG_T, LONG_S - LONG_T)
    same_layout("long_500k", tensor_leaves(args),
                tensor_leaves(cell.args[1:]))
    # B1 at the last layer's K/V (3.6e9 elements past the cache's start),
    # filled with random values, against its plain version, with the
    # kernels phase's tolerance: every key of the lane is visible
    cache, lens = args[:2]
    cmp0 = kernels.snapshot()
    kl, vl = cache["k"][L - 1], cache["v"][L - 1]
    kl.copy_(torch.randn(kl.shape, generator=gen, device="cuda"))
    vl.copy_(torch.randn(vl.shape, generator=gen, device="cuda"))
    q = torch.randn((1, LONG_T, base.n_heads, base.dh), generator=gen,
                    device="cuda").to(torch.bfloat16)
    amask = build_full_tree_mask(lens, args[4], LONG_S)
    out = tree_attention(q, kl, vl, amask)
    ref = tree_attention_reference(q, kl, vl, amask)
    hold("tree_attention", out, ref, torch.bfloat16,
         f"long_500k last layer (1, {LONG_T}, {base.n_heads}, "
         f"{base.n_kv_heads}, {base.dh}, {LONG_S})")
    b1_ms = time_calls(lambda i: tree_attention(q, kl, vl, amask), 3)
    b1_bound, b1_by = bound(2 * kl.numel() * 2 + amask.numel()
                            + 2 * q.numel() * 2,
                            4 * LONG_T * base.n_heads * LONG_S * base.dh,
                            torch.bfloat16)
    print(f"  B1 alone at long_500k's shape: {b1_ms:.4f} ms a call (bound "
          f"{b1_bound:.4f} ms, {b1_by}), {L} a step")
    kl.zero_()
    vl.zero_()
    del out, ref, q, amask, kl, vl
    # the comparison and its timing are not the path's launches
    kernels.add(kernels.diff(kernels.snapshot(), cmp0), -1)
    fused = lm_common._serve_fn(lcfg)
    run = lambda i: fused(params, *args)  # noqa: E731
    n0 = tree_attention.launches
    _, packed = run(0)
    check(tree_attention.launches - n0 == L and packed.shape == (1, 1 + 2 * LONG_T)
          and int(packed[0, 0]) >= 1,
          f"long_500k: {tree_attention.launches - n0} B1 launches, packed "
          f"{tuple(packed.shape)}")
    rows["qwen2_1_5b long_500k"] = cost_cell("qwen2_1_5b long_500k", cell,
                                             run, 3)
    del run, packed, cell, cache, lens
    held = [params, args]       # long_logits frees them as it goes
    del params, args
    rows["qwen2_1_5b long_500k"].update(long_logits(lcfg, held))
    free_card()


def long_logits(lcfg, held):
    """long_500k's logits, the whole 28-layer tree step on the same zero
    cache: B1's (bf16) and the dense backend's (bf16), each held against
    the dense backend's in f32 on the same bf16-rounded weights, as the
    model phase holds them at 2 layers: B1's RMS error at most
    BF16_LOGIT_RATIO times the dense backend's.  ``held`` is [bf16
    parameters, the fused step's arguments]; it is emptied, so the bf16
    cache is freed before the f32 one is made.  The launches of this check
    are not the path's."""
    from repro_torch import kernels
    from repro_torch.models import transformer as tx
    params, args = held
    held.clear()
    cmp0 = kernels.snapshot()
    cache, ins = args[0], args[1:5]          # cache_lens, tokens, pos, mask
    got = tx.tree_step(lcfg, params, cache, *ins)[1].float()
    del cache, args
    held_refs = [params, lcfg, ins]
    del params
    d16, ref = long_references(held_refs, got.shape)
    kernels.add(kernels.diff(kernels.snapshot(), cmp0), -1)
    return long_rule("B1", got, d16, ref, lcfg.vocab_size)


def long_references(held, shape):
    """The dense backend's bf16 and f32 logits of the long step.  ``held``
    is [bf16 parameters, a config, (cache_lens, tokens, positions, tree
    mask)] with the bf16 cache already written by the step; the dense bf16
    step runs on a fresh zero cache (the step writes its own rows), and
    ``held`` is emptied so that the bf16 weights are freed before the f32
    ones are made."""
    from repro_torch.models import transformer as tx
    params, lcfg, ins = held
    held.clear()
    ldense = dataclasses.replace(lcfg, prefill_backend="dense",
                                 decode_backend="dense")
    d16 = tx.tree_step(ldense, params, tx.init_cache(ldense, shape[0],
                                                     device="cuda"),
                       *ins)[1].float()
    free_card()
    p32 = tree_map(lambda t: t.float(), params)
    del params
    c32 = dataclasses.replace(ldense, dtype="float32", param_dtype="float32")
    ref = tx.tree_step(c32, p32, tx.init_cache(c32, shape[0], device="cuda"),
                       *ins)[1].float()
    del p32
    free_card()
    return d16, ref


def long_rule(label, got, d16, ref, vocab):
    """``long_logits``' rule: ``got``'s RMS error against the dense f32
    step at most BF16_LOGIT_RATIO times the dense bf16 step's."""
    def rms(a):
        return a.pow(2).mean().sqrt().item()

    e_got, e_dense = rms(got - ref), rms(d16 - ref)
    scale = ref.abs().max().item()
    limit = BF16_LOGIT_RATIO * e_dense
    key = label.lower().replace(" ", "_")
    out = {f"logit_rms_err_{key}": e_got, "logit_rms_err_dense_bf16": e_dense,
           f"logit_max_err_{key}_vs_dense_bf16":
               (got - d16).abs().max().item() / scale,
           "logit_max_err_dense_bf16_vs_f32":
               (d16 - ref).abs().max().item() / scale,
           f"logit_max_err_{key}_vs_f32": (got - ref).abs().max().item()
           / scale}
    print(f"  long_500k logits (1, {LONG_T}, {vocab}) vs the f32 "
          f"dense step: RMS err {label} {e_got:.4e}, dense bf16 "
          f"{e_dense:.4e}; limit {limit:.4e} ({BF16_LOGIT_RATIO} x dense; "
          f"|logits| RMS {rms(ref):.4f}, max {scale:.4f}); max err over max "
          f"|logits|: {label} vs dense bf16 "
          f"{out[f'logit_max_err_{key}_vs_dense_bf16']:.4e}, dense bf16 vs "
          f"f32 {out['logit_max_err_dense_bf16_vs_f32']:.4e}, {label} vs f32 "
          f"{out[f'logit_max_err_{key}_vs_f32']:.4e}")
    check(bool(torch.isfinite(got).all()) and e_got <= limit,
          f"long_500k logits: {label}'s RMS err {e_got} over {limit}")
    return out


def cost_phase(card):
    """The dry-run's roofline against the card (ROADMAP A19): each cell
    traced on meta and measured on the card, its share of its bound held at
    most COST_SHARE_MAX.  Returns the kernels' launches on these runs."""
    from repro_torch import kernels
    print(f"  bound: max(counted FLOPs over the peak for their dtype, "
          f"bytes_floor over {HBM_BYTES_PER_S / 1e12:.2f} TB/s), compute "
          f"alone without a floor; card and power limit: {card}")
    before = kernels.snapshot()
    rows = {}
    for part in (cost_recsys, cost_gnn, cost_lm):
        t0 = time.perf_counter()
        part(rows)
        print(f"  [{part.__name__}: {time.perf_counter() - t0:.1f} s]")
    print("  cost table: " + json.dumps(rows))
    return kernels.diff(kernels.snapshot(), before)


DIST_COLLECTIVES = ("all_reduce_sum", "all_reduce_max", "all_gather",
                    "all_to_all")
DIST_MOE_NS = (132, 512)      # moe_ep rows: a decode step's 4 x 33, a
                              # prefill's 4 x 128
DIST_MOE_CF = 1.25            # Qwen3-MoE-30B-A3B's capacity factor
DIST_STEPS = 3                # timed fused steps a world
DIST_TURNS = 6                # world 1's ep and local steps timed in turns
DIST_MOE_LAYERS = 3           # (b), (c): Qwen3-MoE's depth cut 48 -> 6
                              # -> 3 (for (h)'s time)
DIST_TP_PROMPTS = 6           # (d), (e): guided requests on 4 lanes
DIST_TP_NEW = 16              # their new tokens each (cut from 32 for
                              # (h)'s time)
DIST_TP_D_LAYERS = 4          # (d): Qwen2-1.5B's depth cut 28 -> 8 -> 4
                              # (for (h)'s time)
DIST_TP_E_LAYERS = 2          # (e): Qwen2-1.5B's depth cut 28 -> 4 -> 2
                              # (for (h)'s time),
DIST_TP_E_PROMPTS = 4         # its requests (one cohort)
DIST_TP_E_NEW = 8             # and their new tokens (cut from 12 for
                              # (h)'s time): its FSDP gathers move
                              # ~0.8 GB a step a rank through gloo
DIST_STATE_STEPS = 3          # (d), (e): guided session steps before the
                              # unguided one whose logits are held
DIST_MOE_TP_LAYERS = 4        # (c)'s serve-rules step: Qwen3-MoE's depth
                              # cut 48 -> 4
DIST_HEADS_ARCHS = ("qwen2-1.5b", "phi3-medium-14b")   # (g), mesh (1, 8):
                              # H 12 (q gathered), 5 heads a rank on 2 KV
DIST_HEADS_LAYERS = 1         # (g): depth cut 28 / 40 -> 2 -> 1 (for
                              # (h)'s time)
DIST_HEADS_PROMPTS = 4        # (g): guided requests (one cohort)
DIST_HEADS_NEW = 8            # and their new tokens (cut from 12)
DIST_MOE_TRAIN_LAYERS = 1     # (f)'s Moonlight: depth cut 48 -> 2 -> 1
                              # (for (h)'s time)
DIST_MOE_TRAIN_BATCH = (4, 128)   # (B, S): 2 lanes a data rank at (2, 2)
DIST_MOE_TRAIN_STEPS = 2
# (f) against one device, both f32.  The losses (steps 1 and 3) to a
# relative 1e-5: the same sums in another order differ by ~1e-7, and after
# 2 updates of lr 3e-4 a lost or doubled update moves the loss by ~1e-4
# relative or more.  The final checkpoint's moments to an RMS difference of
# 1e-3 of their RMS: they follow the gradients (~1e-6 apart), and a clip
# factor or a gradient wrong on some blocks moves them by its error.  Its
# parameters to an RMS difference of 1e-2 of the most the updates can move
# them (lr x steps, Adam's step being at most ~lr an element): they differ
# only where Adam's lr * g / (|g| + eps) turns on a gradient near eps,
# while a missed or doubled update moves them by ~lr a step (Adam's step
# does not see a gradient's scale: the moments check the clip).  (f)'s MoE
# holds each step's grad_norm to the same 1e-5: summed in another order
# it moves by ~1e-7, and a leaf's gradient scaled by a constant (which the
# loss after an Adam step does not see) moves it by far more
DIST_TRAIN_LOSS_RTOL = 1e-5
DIST_TRAIN_MOMENT_RTOL = 1e-3
DIST_TRAIN_PARAM_FRAC = 1e-2
DIST_TRAIN_LR = 3e-4          # the CLI's default


def dist_rank(rank, name, world, backend, directory, *args):
    """A spawned rank: joins the world (``backend``; every rank on cuda:0,
    named explicitly), runs the module-level ``name(rank, *args)`` and saves
    what it returns for the parent.  Module-level, so that spawn can
    unpickle it."""
    import torch.distributed as dist
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  [{name} rank {rank}/{world}: backend {backend}, cuda:0, pid "
          f"{os.getpid()}]", flush=True)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(directory, 'store')}",
        rank=rank, world_size=world,
        device_id=torch.device("cuda:0") if backend == "nccl" else None)
    try:
        out = globals()[name](rank, *args)
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def dist_spawn(name, world, backend, *args):
    """Spawn ``world`` ranks running ``name(rank, *args)`` (see
    ``dist_rank``) once the parent's cached memory is freed; returns each
    rank's result."""
    import shutil
    import tempfile
    import torch.multiprocessing as tmp
    from torch.multiprocessing.spawn import ProcessException
    free_card()
    directory = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    t0 = time.perf_counter()
    try:
        tmp.start_processes(dist_rank, args=(name, world, backend,
                                             directory) + args,
                            nprocs=world, join=True, start_method="spawn")
        return [torch.load(os.path.join(directory, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
    except ProcessException as exc:
        raise SmokeError(f"{name}: a rank failed: {exc}") from None
    finally:
        shutil.rmtree(directory, ignore_errors=True)
        print(f"  [{name}: world {world} on {backend}, "
              f"{time.perf_counter() - t0:.1f} s]")


def gloo_probe(rank):
    """Which collectives gloo runs on CUDA tensors, each called raw on
    cuda:0: the Mesh hands gloo its CUDA tensors for all four."""
    import torch.distributed as dist
    x = torch.arange(8, dtype=torch.float32, device="cuda") + rank
    ops = {
        "all_reduce_sum": lambda: dist.all_reduce(x.clone()),
        "all_reduce_max": lambda: dist.all_reduce(
            x.clone(), op=dist.ReduceOp.MAX),
        "all_gather": lambda: dist.all_gather_into_tensor(
            torch.empty(16, device="cuda"), x),
        "all_to_all": lambda: dist.all_to_all_single(torch.empty_like(x),
                                                     x)}
    out = {}
    for name in DIST_COLLECTIVES:
        try:
            ops[name]()
            torch.cuda.synchronize()
            out[name] = "cuda"
        except (RuntimeError, ValueError) as exc:
            out[name] = f"raises: {str(exc).splitlines()[0][:120]}"
    bad = [n for n, v in out.items() if v != "cuda"]
    check(not bad, f"gloo takes no CUDA tensor for {bad}")
    return out


def chain_inputs(args, V, start, seed=0):
    """Fill ``lm_common.decode_args``' zeroed step arguments in place: a
    chain tree of T slots at cache_lens ``start``, tokens from ``seed``."""
    cache, lens, tok, pos, mask, parent, n_live = args
    B, T = tok.shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    lens.fill_(start)
    tok.copy_(torch.randint(0, V, (B, T), generator=gen, device="cuda"))
    pos.copy_(start + torch.arange(T, device="cuda"))
    mask.copy_(torch.ones(T, T, dtype=torch.bool, device="cuda").tril())
    parent.copy_(torch.arange(T, device="cuda") - 1)
    n_live.fill_(T)
    return args


def timed_fused(fused, params, args, mesh=None):
    """DIST_STEPS fused steps, each timed by the host clock from a barrier
    to a synchronize (ms a step on this rank), then one more with the
    mesh's collectives timed: (median ms, the collectives' share, every
    step's ms)."""
    ms = []
    for _ in range(DIST_STEPS):
        if mesh is not None:
            mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused(params, *args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    share = None
    if mesh is not None:
        mesh.barrier()
        mesh.timing, mesh.collective_s = True, 0.0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused(params, *args)
        torch.cuda.synchronize()
        share = mesh.collective_s / (time.perf_counter() - t0)
        mesh.timing = False
    return float(np.median(ms)), share, ms


def dist_long(rank):
    """World 2 on gloo, both ranks on the card: long_500k (Qwen2-1.5B at
    full width and depth, bf16, B 1, S 524,288, T 65, cache_lens S - T)
    through flash decode on mesh (data 2, model 1), which shards the KV
    sequence (7.52 GB a rank).  Then on rank 0 alone the single-device
    step through B1 and the dense steps in bf16 and f32 on the same
    weights and inputs."""
    from repro_torch import kernels
    from repro_torch.configs import lm_common, qwen2_1_5b
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tx
    from repro_torch.models.params import init_params
    probe = gloo_probe(rank)
    mesh = make_host_mesh(data=2, model=1, device="cuda:0")
    base = dataclasses.replace(qwen2_1_5b.full_config(), dtype="bfloat16",
                               param_dtype="bfloat16", max_seq_len=LONG_S,
                               prefill_backend="cuda", decode_backend="cuda")
    flash = dataclasses.replace(base, decode_backend="flash_decode")
    params = init_params(base, seed=0, device="cuda")
    V, L = base.vocab_size, base.n_layers
    torch.cuda.reset_peak_memory_stats()
    before = kernels.snapshot()
    with sharding_ctx(mesh):
        args = chain_inputs(lm_common.decode_args(flash, 1, LONG_T, "cuda"),
                            V, LONG_S - LONG_T)
        block = tuple(args[0]["k"].shape)
        check(block == (L, 1, LONG_S // 2, base.n_kv_heads, base.dh),
              f"flash decode cache block {block}")
        ins = args[1:5]
        logits = tx.tree_step(flash, params, args[0], *ins)[1].float()
        fused = lm_common._serve_fn(flash)
        _, packed = fused(params, *args)
        ms, share, steps = timed_fused(fused, params, args, mesh)
    launches = kernels.diff(kernels.snapshot(), before)
    peak = peak_gb()
    out = dict(probe=probe, block=block, ms=ms, collective_share=share,
               steps=steps,
               peak_gb=peak, launches=launches, packed=packed.cpu(),
               logits=logits.cpu())
    del args, ins, logits
    free_card()
    if rank == 0:
        cmp0 = kernels.snapshot()
        args = chain_inputs(lm_common.decode_args(base, 1, LONG_T, "cuda"),
                            V, LONG_S - LONG_T)
        ins = args[1:5]
        b1 = tx.tree_step(base, params, args[0], *ins)[1].float()
        _, b1_packed = lm_common._serve_fn(base)(params, *args)
        b1_ms, _, _ = timed_fused(lm_common._serve_fn(base), params, args)
        del args
        free_card()
        held = [params, base, ins]
        del params
        d16, ref = long_references(held, b1.shape)
        kernels.add(kernels.diff(kernels.snapshot(), cmp0), -1)
        out.update(b1_packed=b1_packed.cpu(), b1_ms=b1_ms, b1=b1.cpu(),
                   d16=d16.cpu(), ref=ref.cpu())
    mesh.barrier()
    return out


def op_profile(fn):
    """One call of fn() under torch.profiler: (wall ms, device busy ms,
    {op: [host self ms, device self ms of the kernels it launched, calls]})
    over the host-side ops."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops, busy = {}, 0.0
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            busy += e.self_device_time_total / 1e3
        else:
            ops[e.key] = [e.self_cpu_time_total / 1e3,
                          e.self_device_time_total / 1e3, e.count]
    return wall, busy, ops


def print_op_diff(label, a, b, top=8):
    """Where profile ``a`` spends more than ``b`` (``op_profile``'s): the
    ops with the largest excess of host self time, then of device time."""
    (wa, ba, oa), (wb, bb, ob) = a, b
    print(f"  {label}: wall {wa:.2f} ms vs {wb:.2f}, device busy {ba:.2f} "
          f"ms vs {bb:.2f}, host self time of all ops "
          f"{sum(v[0] for v in oa.values()):.2f} ms vs "
          f"{sum(v[0] for v in ob.values()):.2f}")
    zero = [0.0, 0.0, 0]
    for col, what in ((0, "host"), (1, "device")):
        keys = sorted(set(oa) | set(ob), key=lambda k: -(
            oa.get(k, zero)[col] - ob.get(k, zero)[col]))
        for k in keys[:top]:
            x, y = oa.get(k, zero), ob.get(k, zero)
            print(f"    +{x[col] - y[col]:8.3f} ms {what} ({x[col]:.3f} in "
                  f"{x[2]} calls vs {y[col]:.3f} in {y[2]})  {k[:70]}")


def ep_rules():
    """(b) and (c)'s rules: the experts split over ``model``, the dense
    weights and the cache whole on every rank (expert parallelism alone,
    so that world 2 differs from world 1 only in the experts; (d) and (e)
    split the dense weights)."""
    from repro_torch.distributed.sharding import DEFAULT_RULES
    return DEFAULT_RULES.override(tensor=(), fsdp=(), kv_heads=())


def dist_moe_step(cfg, params, mesh=None, timed=True):
    """Qwen3-MoE's prefill (4, 128) through B3 and its decode step (4 x
    33, cache_lens 128, S 512) through B1, under ``ep_rules``: the
    prefill's and the step's logits, the packed result and the cache,
    ``run``, which runs one more step, and with ``timed`` the step's
    median ms and collective share (``timed_fused``)."""
    from repro_torch.configs import lm_common
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.models import transformer as tx
    B, T, _, _, _, S = PATH_TREE
    P0 = PATH_PREFILL[0][1]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (B, P0), generator=gen,
                         device="cuda", dtype=torch.int32)
    lens = torch.full((B,), P0, dtype=torch.int32, device="cuda")
    with sharding_ctx(mesh, ep_rules()):
        args = chain_inputs(lm_common.decode_args(cfg, B, T, "cuda"),
                            cfg.vocab_size, P0, seed=6)
        lay = tx.Layout(cfg, B)
        _, first = tx.prefill(cfg, params, toks, lens, args[0])
        logits = tx.tree_step(cfg, params, args[0], *args[1:5])[1]
        fused = lm_common._serve_fn(cfg)
        _, packed = fused(params, *args)
        out = dict(first=whole(lay.logits_sharding(2), first),
                   logits=whole(lay.logits, logits), packed=packed,
                   cache={n: c.clone() for n, c in args[0].items()})
        if timed:
            out["ms"], out["share"], out["steps"] = timed_fused(
                fused, params, args, mesh)

    def run():
        with sharding_ctx(mesh, ep_rules()):
            fused(params, *args)
    out["run"] = run
    return out


def moe_full_config(impl, cf=None):
    """Qwen3-MoE-30B-A3B at full width, its depth cut to DIST_MOE_LAYERS."""
    from repro_torch.configs import qwen3_moe_30b_a3b
    base = qwen3_moe_30b_a3b.full_config()
    return dataclasses.replace(
        base, dtype="bfloat16", param_dtype="bfloat16",
        prefill_backend="cuda", decode_backend="cuda",
        max_seq_len=PATH_TREE[5], moe_impl=impl, n_layers=DIST_MOE_LAYERS,
        capacity_factor=base.capacity_factor if cf is None else cf)


def no_drop_cf(cfg):
    """A capacity factor at which no token drops: E / top_k."""
    return cfg.n_experts / cfg.top_k


def whole(sharding, x):
    """The global tensor of a block (itself where nothing is split)."""
    return x if sharding is None else sharding.gather(x)


def small(out):
    """A ``dist_moe_step`` result for the parent: the outputs in f32 on the
    host, the cache left out."""
    return {k: (v.float().cpu() if k in ("first", "logits") else v.cpu())
            for k, v in out.items() if k in ("first", "logits", "packed")}


def dist_moe_nccl(rank):
    """World 1 on NCCL: Qwen3-MoE-30B-A3B at full width, DIST_MOE_LAYERS
    deep, its prefill and decode step under mesh (data 1, model 1) with
    ``moe_impl="ep"``, then without a mesh through ``moe_local`` on the
    same weights: a group of one exchanges nothing (the Mesh calls no
    collective for it), so every output must be the same bits.  The two
    steps are then timed in turns (ep, local, local, ep, ...; DIST_TURNS
    rounds) and one of each is profiled, to show what ep's step costs over
    local's.  Then, untimed, the no-drop references for world 2:
    ``moe_local`` and ``moe_ref`` without a mesh at capacity factor
    E / top_k."""
    from repro_torch import kernels
    from repro_torch.distributed.sharding import sharding_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.params import init_params
    mesh = make_host_mesh(data=1, model=1, device="cuda:0")
    ep = moe_full_config("ep")
    with sharding_ctx(mesh, ep_rules()):
        params = init_params(ep, seed=0, device="cuda", mesh=mesh)
    torch.cuda.reset_peak_memory_stats()
    before = kernels.snapshot()
    got = dist_moe_step(ep, params, mesh)
    launches = kernels.diff(kernels.snapshot(), before)
    peak = peak_gb()
    cmp0 = kernels.snapshot()
    want = dist_moe_step(moe_full_config("local"), params)
    turns = {"ep": [], "local": []}
    for i in range(2 * DIST_TURNS):
        name = ("ep", "local")[(i + i // 2) % 2]
        run = (got if name == "ep" else want)["run"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        turns[name].append((time.perf_counter() - t0) * 1e3)
    profiles = [op_profile(x["run"]) for x in (got, want)]
    cf = no_drop_cf(ep)
    local16 = small(dist_moe_step(moe_full_config("local", cf), params,
                                  timed=False))
    ref = small(dist_moe_step(moe_full_config("ref"), params, timed=False))
    kernels.add(kernels.diff(kernels.snapshot(), cmp0), -1)
    same = {}
    for name in ("first", "logits", "packed", "cache"):
        a, b = got[name], want[name]
        if isinstance(a, dict):
            for n in a:
                same[f"{name} {n}"] = torch.equal(a[n], b[n])
        else:
            same[name] = torch.equal(a, b)
    print(f"  world 1 (NCCL): moe_ep == moe_local bit for bit: {same}; "
          f"fused step ep {got['ms']:.3f} ms, local {want['ms']:.3f} ms "
          f"(each alone); in turns ep {np.median(turns['ep']):.3f} ms, "
          f"local {np.median(turns['local']):.3f} (medians of "
          f"{DIST_TURNS}; ep {[round(t, 2) for t in turns['ep']]}, local "
          f"{[round(t, 2) for t in turns['local']]}); peak {peak:.2f} GB "
          f"(PR 21 read 62.3)")
    print_op_diff("world 1 fused step, ep over local (one profiled step)",
                  *profiles)
    check(all(same.values()), f"moe_ep at world 1 differs from moe_local: "
          f"{same}")
    return dict(ms=got["ms"], local_ms=want["ms"], turns=turns,
                collective_share=got["share"], peak_gb=peak,
                launches=launches, **small(got), local16=local16, ref=ref)


def dist_moe_gloo(rank):
    """World 2 on gloo, mesh (data 1, model 2): ``moe_ep`` at one
    Qwen3-MoE layer's full width (E 128, top 8, d 2048, F 768, random
    weights) for N 132 and 512 at capacity factor 1.25 against the
    single-process ``moe_local`` of each rank's token half with all 128
    experts; then the prefill and decode step (DIST_MOE_LAYERS deep) with
    the experts split over the ranks (``ep_rules``: the dense weights
    whole), timed at capacity factor 1.25 and run once more
    at E / top_k, where nothing drops, for the parent to hold against
    world 1; ``_sharded_argmax`` over V/2 on the step's logits."""
    from repro_torch import kernels
    from repro_torch.distributed.sharding import NamedSharding, P, sharding_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    from repro_torch.serving.sampler import _sharded_argmax
    mesh = make_host_mesh(data=1, model=2, device="cuda:0")
    cfg = moe_full_config("ep")
    E, k, d, F = cfg.n_experts, cfg.top_k, cfg.d_model, cfg.moe_d_ff
    gen = torch.Generator(device="cuda")
    gen.manual_seed(11)
    wr = randn(gen, (d, E), torch.bfloat16, 0.02)
    full = [randn(gen, shape, torch.bfloat16, 0.02)
            for shape in ((E, d, F), (E, d, F), (E, F, d))]
    experts = NamedSharding(mesh, P("model", None, None))
    half = [experts.local(w).clone() for w in full]
    layer = {}
    for N in DIST_MOE_NS:
        x = randn(gen, (N, d), torch.bfloat16, 1.0)
        out = moe.moe_ep(x, wr, *half, k, DIST_MOE_CF, mesh)
        n = N // 2
        ref = moe.moe_local(x[rank * n:(rank + 1) * n], wr, *full, k,
                            DIST_MOE_CF)
        mine = out[rank * n:(rank + 1) * n]
        err = (mine.float() - ref.float()).abs().max().item()
        check(torch.allclose(mine.float(), ref.float(), **MOE_TOL),
              f"moe_ep N {N}, rank {rank}'s half: {err} from moe_local")
        ep_ms = time_calls(lambda i: moe.moe_ep(x, wr, *half, k, DIST_MOE_CF,
                                                mesh), 5)
        local_ms = time_calls(lambda i: moe.moe_local(x, wr, *full, k,
                                                      DIST_MOE_CF), 5)
        layer[N] = dict(max_abs_err=err, ep_ms=ep_ms, local_ms=local_ms)
    del full, half, wr, x, out, ref, mine
    free_card()
    with sharding_ctx(mesh, ep_rules()):
        params = init_params(cfg, seed=0, device="cuda", mesh=mesh)
    check(params["layers"]["we_gate"].shape[1] == E // 2,
          f"expert block {tuple(params['layers']['we_gate'].shape)}")
    torch.cuda.reset_peak_memory_stats()
    before = kernels.snapshot()
    got = dist_moe_step(cfg, params, mesh)
    launches = kernels.diff(kernels.snapshot(), before)
    peak = peak_gb()
    cmp0 = kernels.snapshot()
    nodrop = small(dist_moe_step(moe_full_config("ep", no_drop_cf(cfg)),
                                 params, mesh, timed=False))
    logits = got["logits"]
    vocab = NamedSharding(mesh, P(None, None, "model"))
    choice = NamedSharding(mesh, P(None, None)).gather(
        _sharded_argmax(vocab.local(logits), vocab))
    kernels.add(kernels.diff(kernels.snapshot(), cmp0), -1)
    check(bool(torch.isfinite(logits).all()) and torch.equal(
        choice, logits.argmax(-1).int()) and bool(
            (got["packed"][:, 0] >= 1).all()),
          "world 2 MoE step: non-finite logits, a sharded argmax that is not "
          "argmax, or an empty accept")
    out = dict(layer=layer, ms=got["ms"], collective_share=got["share"],
               steps=got["steps"], peak_gb=peak, **small(got), nodrop=nodrop)
    del params, got, logits
    free_card()
    out["tp"] = moe_tp_step(rank, mesh)
    tp = out["tp"]["launches"]
    out["launches"] = {n: launches.get(n, 0) + tp.get(n, 0)
                       for n in {*launches, *tp}}
    return out


def moe_tp_step(rank, mesh):
    """(c)'s serve-rules cell: Qwen3-MoE-30B-A3B at full width, cut to
    DIST_MOE_TP_LAYERS layers, placed under the serve rules
    (``override(fsdp=())``: the heads, the vocab and the experts over
    ``model``), capacity factor E / top_k so that no token drops: the
    prefill and tree step of ``model_inputs`` under the mesh (TP
    attention, ``moe_ep(lanes=)``, the vocab-sharded head), gathered; then
    rank 0 alone, the other waiting: the same weights drawn whole on one
    device, their logits through the dense backends and ``moe_ref`` in
    bf16 and in f32."""
    from repro_torch import kernels
    from repro_torch.distributed.sharding import DEFAULT_RULES, sharding_ctx
    from repro_torch.models import transformer as tx
    from repro_torch.models.params import init_params
    base = moe_full_config("ep")
    cfg = dataclasses.replace(base, n_layers=DIST_MOE_TP_LAYERS,
                              capacity_factor=no_drop_cf(base))
    ins = model_inputs(cfg.vocab_size)
    toks, lens, tree, pos, tm = ins
    out = {"layers": cfg.n_layers}
    with sharding_ctx(mesh, DEFAULT_RULES.override(fsdp=())):
        params = init_params(cfg, seed=1, device="cuda", mesh=mesh)
        out["weight_bytes"] = sum(t.numel() * t.element_size()
                                  for t in tree_leaves(params))
        out["experts"] = params["layers"]["we_gate"].shape[1]
        before = kernels.snapshot()
        lay = tx.Layout(cfg, toks.shape[0])
        cache, pre = tx.prefill(cfg, params, toks, lens, tx.init_cache(
            cfg, toks.shape[0], device="cuda"))
        step = tx.tree_step(cfg, params, cache, lens, tree, pos, tm)[1]
        out["launches"] = kernels.diff(kernels.snapshot(), before)
        out["heads"] = (lay.q_heads, lay.kv_heads)
        out["vocab"] = step.shape[-1]
        out["pre"] = whole(lay.logits_sharding(2), pre).float().cpu()
        out["step"] = whole(lay.logits, step).float().cpu()
        del params, cache, pre, step
    free_card()
    mesh.barrier()
    if rank == 0:
        cmp0 = kernels.snapshot()
        one = dataclasses.replace(cfg, moe_impl="ref")
        p16 = init_params(one, seed=1, device="cuda")
        out["whole_bytes"] = sum(t.numel() * t.element_size()
                                 for t in tree_leaves(p16))
        out["d16"] = [x.cpu() for x in model_logits(one, p16, ins, "dense")]
        p32 = tree_map(lambda t: t.float(), p16)
        del p16
        c32 = dataclasses.replace(one, dtype="float32", param_dtype="float32")
        out["ref"] = [x.cpu() for x in model_logits(c32, p32, ins, "dense")]
        del p32
        free_card()
        kernels.add(kernels.diff(kernels.snapshot(), cmp0), -1)
    mesh.barrier()
    return out


def moe_tp_rule(res):
    """(c)'s serve-rules cell: every rank's gathered logits alike, B1 and
    B3 launched on each rank, and the prefill and step logits within
    BF16_LOGIT_RATIO of the dense bf16 path's RMS error against the dense
    f32 path (``moe_ref`` on one device)."""
    def rms(a):
        return a.pow(2).mean().sqrt().item()

    r0 = res[0]["tp"]
    label = (f"Qwen3-MoE cut to {r0['layers']} of 48 layers, mesh (data 1, "
             "model 2), serve rules")
    for r, x in enumerate(res):
        t = x["tp"]
        check(torch.equal(t["pre"], r0["pre"]) and torch.equal(
            t["step"], r0["step"]), f"{label}: rank {r}'s gathered logits "
                                    "differ from rank 0's")
        n = t["launches"]
        check(n.get("tree_attention", 0) > 0 and n.get("flash_prefill", 0)
              > 0, f"{label} rank {r}: B1/B3 launches {n}")
        print(f"  {label} rank {r}: heads {t['heads']}, vocab block "
              f"{t['vocab']}, experts {t['experts']}, weights "
              f"{t['weight_bytes'] / 1e9:.3f} GB of "
              f"{r0['whole_bytes'] / 1e9:.3f} whole; launches B1 "
              f"{n.get('tree_attention', 0)}, B3 {n.get('flash_prefill', 0)}")
    rule = {}
    for i, name in enumerate(("prefill", "step")):
        got = r0["pre" if i == 0 else "step"]
        e_got, e_dense = (rms(x - r0["ref"][i]) for x in (got, r0["d16"][i]))
        limit = BF16_LOGIT_RATIO * e_dense
        print(f"  {label} {name} logits vs the f32 path (moe_ref): RMS err "
              f"mesh {e_got:.4e}, dense bf16 {e_dense:.4e}; limit "
              f"{limit:.4e}")
        check(bool(torch.isfinite(got).all()) and e_got <= limit,
              f"{label} {name} logits: RMS err {e_got} over {limit}")
        rule[name] = dict(rms=e_got, dense=e_dense)
    return rule


def guided_drafts(rng, table, roots, lens, T, vocab):
    """A random draft tree a lane, rooted at the lane's next token at its
    length: each node's token is, with probability 0.7, the guided model's
    choice after its parent (``table``, ``guided_transform``'s), else a
    random id, so a step accepts slots along one branch of the tree, not
    slots 0, 1, ... in order.  (tokens, positions, mask, parents, live)."""
    B, phase = len(lens), table.shape[0]
    tok = np.zeros((B, T), np.int32)
    parent = np.full((B, T), -1, np.int32)
    depth = np.zeros((B, T), np.int32)
    mask = np.zeros((B, T, T), bool)
    for b in range(B):
        tok[b, 0] = roots[b]
        for i in range(1, T):
            p = rng.randint(0, i)
            parent[b, i], depth[b, i] = p, depth[b, p] + 1
            tok[b, i] = (table[(lens[b] + depth[b, p]) % phase, tok[b, p]]
                         if rng.rand() < 0.7 else rng.randint(2, vocab))
        for i in range(T):
            j = i
            while j >= 0:
                mask[b, i, j] = True
                j = parent[b, j]
    pos = (np.asarray(lens)[:, None] + depth).astype(np.int32)
    return tok, pos, mask, parent, np.full((B,), T, np.int32)


def committed_rows(cache, lens, bs, sharding):
    """Each lane's K and V rows below its length, every layer, read through
    the block tables on the paged layout and gathered over the ranks under
    ``sharding`` (the dense cache's or the pool's; None on one device):
    (2, L, sum(lens), K, dh), f32 on the host."""
    from repro_torch.distributed.sharding import NamedSharding, P
    from repro_torch.models import transformer as tx
    dev = cache["k"].device
    smax = int(max(lens))
    lens = torch.as_tensor(np.asarray(lens), device=dev)
    pos = torch.arange(smax, device=dev)
    out = []
    for n in ("k", "v"):
        if "block_tables" in cache:
            tables = cache["block_tables"].to(dev)
            rows = tx.paged_row_index(tables, pos[None].expand(
                tables.shape[0], smax), bs)
            view = cache[n].flatten(1, 2)[:, rows]
            spec = None if sharding is None else P(None, None, None,
                                                   sharding.spec[3], None)
        else:
            view = cache[n][:, :, :smax]
            spec = None if sharding is None else sharding.spec
        if spec is not None:
            view = NamedSharding(sharding.mesh, spec).gather(
                view.contiguous())
        out.append(view[:, pos[None] < lens[:, None]].float().cpu())
    return torch.stack(out)


def session_state(cfg, params, layout, ins):
    """The serving session's state on ``model_inputs``' prompts, through
    ``make_session_fns`` (greedy, eager; under the active mesh where there
    is one): the cohort prefill, DIST_STATE_STEPS guided fused steps on
    ``guided_drafts`` (a few slots accepted a step, so the commit moves
    rows), then one fused step unguided, whose logits a transform
    records.  Returns the committed K and V rows below each lane's length
    (``committed_rows``), the unguided step's logits gathered over the
    lanes and the vocab, each lane's length and accepts a step."""
    from repro_torch.models import transformer as tx
    from repro_torch.serving.session import make_session_fns
    toks, lens = (x.cpu().numpy().astype(np.int32) for x in ins[:2])
    B, T, V, bs = toks.shape[0], PATH_TREE[1], cfg.vocab_size, PATH_PAGED[5]
    guided, rec = guided_transform(V), []

    def transform(logits, tokens, positions):
        # no vocab_offset keyword: under a mesh it sees the whole vocab
        if not rec:
            return guided(logits, tokens, positions)
        rec[0] = logits.float()
        return logits

    paged = layout == "paged"
    fns = make_session_fns(cfg, params, slots=T, sampling="greedy",
                           logits_transform=transform, kv_layout=layout,
                           block_size=bs, device="cuda", cuda_graphs=False)
    if paged:
        bpl = -(-cfg.max_seq_len // bs)
        cache, first = fns.prefill(toks, lens, shuffled_tables([bpl] * B,
                                                               bpl, seed=3))
    else:
        cache, first = fns.prefill(toks, lens)
    roots, cur, accepted = first.cpu().numpy(), lens.copy(), []
    rng = np.random.RandomState(7)
    for step in range(DIST_STATE_STEPS + 1):
        if step == DIST_STATE_STEPS:
            rec.append(None)                      # the unguided step
        drafts = guided_drafts(rng, guided.table, roots, cur, T, V)
        cache, packed = fns.fused_step(cache, cur, *drafts)
        packed = packed.cpu().numpy()
        if step < DIST_STATE_STEPS:
            n = packed[:, 0]
            accepted.append(n.tolist())
            roots, cur = packed[np.arange(B), n], cur + n
    lay = tx.Layout(cfg, B, paged)
    sharding = tx.paged_sharding(cfg) if paged else lay.cache
    return dict(rows=committed_rows(cache, cur, bs, sharding),
                logits=lay.gather(rec[0]).cpu(), lens=cur.tolist(),
                accepted=accepted)


@contextlib.contextmanager
def forward_lanes(log):
    """Add to the set ``log`` the rows of the token block of each model
    forward run inside: ``tx._self_forward`` (the prefills) and
    ``tx._tree_forward`` (the tree steps, the suffix prefill), i.e. the
    lanes the rank ran."""
    from repro_torch.models import transformer as tx
    saved = tx._self_forward, tx._tree_forward

    def wrap(fn, i):
        def run(*a, **k):
            log.add(int(a[i].shape[0]))
            return fn(*a, **k)
        return run
    tx._self_forward, tx._tree_forward = wrap(saved[0], 2), wrap(saved[1], 3)
    try:
        yield log
    finally:
        tx._self_forward, tx._tree_forward = saved


def pool_digest(cache):
    """sha256 of this rank's paged K and V bytes, the NULL block (garbage,
    never attended) excepted."""
    kv = torch.stack([cache["k"][:, 1:], cache["v"][:, 1:]]).contiguous()
    return hashlib.sha256(kv.view(torch.uint8).cpu().numpy().tobytes()
                          ).hexdigest()


def paged_count(cfg, params, ins, mesh, rules):
    """One paged fused step (``lm_common._serve_fn``) on ``model_inputs``'
    prompts, prefilled first, a chain of the tree's slots: the collectives
    this rank's ``mesh`` hands gloo for the step, and what a
    ``TracedMesh`` of the same shape at this rank records for the same
    call on meta copies of the arguments."""
    from repro_torch.configs import lm_common
    from repro_torch.distributed.sharding import TracedMesh, sharding_ctx
    from repro_torch.models import transformer as tx
    toks, lens, tree, pos, tm = ins
    B, T = tree.shape
    pcfg = dataclasses.replace(cfg, kv_layout="paged",
                               kv_block_size=PATH_PAGED[5])
    bpl = tx.blocks_per_lane(pcfg)
    parent = (torch.arange(T, device="cuda") - 1).expand(B, T).int()
    n_live = torch.full((B,), T, dtype=torch.int32, device="cuda")
    with sharding_ctx(mesh, rules):
        cache = tx.init_paged_cache(pcfg, B, device="cuda")
        cache["block_tables"] = shuffled_tables([bpl] * B, bpl, seed=3)
        cache, _ = tx.prefill_paged(pcfg, params, toks, lens, cache)
    args = [params, cache, lens, tree, pos, tm, parent, n_live]

    def meta(x):
        if isinstance(x, dict):
            return {k: meta(v) for k, v in x.items()}
        return x.to("meta")

    out = {}
    for tag, m, on in (("real", mesh, lambda x: x),
                       ("traced", TracedMesh(mesh.shape, mesh.rank), meta)):
        with sharding_ctx(m, rules):
            m.reset_counts()
            lm_common._serve_fn(pcfg)(*(on(a) for a in args))
            out[tag] = m.collective_records()
    torch.cuda.synchronize()
    return out


def dist_tp_world(rank, data, model, rules_name, n_layers=None,
                  n_prompts=DIST_TP_PROMPTS, n_new=DIST_TP_NEW,
                  arch="qwen2-1.5b", state=True, paged_checks=False):
    """A world of data x model gloo ranks, every rank on cuda:0, serving
    ``arch`` (bf16, the cuda backends, random weights from seed 0,
    ``n_layers`` deep or at full depth) placed over mesh (data, model)
    under the rules named (``DEFAULT_RULES`` or the serve cells'
    ``override(fsdp=())``): ``init_params(mesh=)`` draws each rank's
    blocks; ``n_prompts`` guided requests of ``n_new`` new tokens
    through ``build_engine`` inside ``sharding_ctx`` on the dense layout
    and on the paged one, twice each (``serve``; kernel counters read
    around the four passes); the
    prefill and step logits of ``model_inputs`` through ``tx.prefill`` and
    ``tx.tree_step`` under the mesh, gathered; B1, B2 and B3 at this
    rank's head shapes that no lower rank has, against their plain
    versions (``heads_holds``); with
    ``state``, ``session_state`` on both layouts.  Then rank 0 alone,
    every other rank waiting: the single-device session's tokens
    (captured), the single-device logits (the cuda backends in bf16, the
    dense backend in bf16 and in f32) and, with ``state``,
    ``session_state`` (in bf16 on both layouts, in f32 on the dense one)
    on the same weights.  With ``paged_checks``: the lanes each model
    forward of the paged passes ran (``forward_lanes``), the rank's pool
    after them (``pool_digest``) and ``paged_count``."""
    from repro_torch import configs, kernels
    from repro_torch.core.request import SamplingParams
    from repro_torch.distributed.sharding import DEFAULT_RULES, sharding_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tx
    from repro_torch.models.params import init_params
    from repro_torch.serving.api import EngineConfig, build_engine
    mesh = make_host_mesh(data=data, model=model, device="cuda:0")
    rules = (DEFAULT_RULES if rules_name == "default"
             else DEFAULT_RULES.override(fsdp=()))
    cfg = dataclasses.replace(configs.get_arch(arch).full_config(),
                              dtype="bfloat16", param_dtype="bfloat16")
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    V = cfg.vocab_size
    prompts = path_prompts(V)[:n_prompts]
    sp = SamplingParams(max_new_tokens=n_new)
    ins = model_inputs(V)

    def serve(params, layout, probe=None):
        """The requests served twice by one engine: the second pass drafts
        from the first's outputs in the trie, so its steps accept several
        tokens.  Returns [(tokens, wall s, decode steps)] a pass; with
        ``probe`` (a dict), the lanes the forwards ran, the engine's lanes
        and the pool's digest after the passes go into it."""
        engine = build_engine(EngineConfig(kv_layout=layout,
                                           default_params=sp),
                              cfg, params, logits_transform=guided_transform(
                                  V), device="cuda")
        passes, ran = [], set()
        with (forward_lanes(ran) if probe is not None
              else contextlib.nullcontext()):
            for _ in range(2):
                steps = engine.stats.decode_steps
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                hs = [engine.submit(list(p), max_new_tokens=n_new)
                      for p in prompts]
                engine.run()
                torch.cuda.synchronize()
                passes.append(([[int(t) for t in h.result().tokens]
                                for h in hs], time.perf_counter() - t0,
                               engine.stats.decode_steps - steps))
        if probe is not None:
            cache = engine.scheduler.cache
            probe.update(ran=sorted(ran), lanes=tx.cache_batch(cache),
                         pool=pool_digest(cache))
        return passes

    out = {"layers": cfg.n_layers, "whole_bytes": cfg.n_params() * 2}
    with sharding_ctx(mesh, rules):
        params = init_params(cfg, seed=0, device="cuda", mesh=mesh)
        out["weight_bytes"] = sum(t.numel() * t.element_size()
                                  for t in tree_leaves(params))
        free_card()
        before = kernels.snapshot()
        probe = {} if paged_checks else None
        for layout in ("dense", "paged"):
            out[layout] = serve(params, layout,
                                probe if layout == "paged" else None)
        out["launches"] = kernels.diff(kernels.snapshot(), before)
        if paged_checks:
            out["paged_probe"] = dict(probe, mesh=(data, model))
        out["peak_gb"] = peak_gb()
        cmp0 = kernels.snapshot()
        toks, lens, tree, pos, tm = ins
        lay = tx.Layout(cfg, toks.shape[0])
        cache, pre = tx.prefill(cfg, params, toks, lens,
                                tx.init_cache(cfg, toks.shape[0],
                                              device="cuda"))
        step = tx.tree_step(cfg, params, cache, lens, tree, pos, tm)[1]
        out["pre"] = whole(lay.logits_sharding(2), pre).float().cpu()
        out["step"] = whole(lay.logits, step).float().cpu()
        out["heads"] = (lay.q_heads, lay.kv_heads, lay.kv_runs,
                        lay.q_gather, lay.q_block)
        del cache
        out["holds"] = heads_holds(rank, lay, cfg.dh,
                                   cfg.n_heads // cfg.n_kv_heads)
        if paged_checks:
            out["paged_probe"]["count"] = paged_count(cfg, params, ins,
                                                      mesh, rules)
        if state:
            out["state"] = {layout: session_state(cfg, params, layout, ins)
                            for layout in ("dense", "paged")}
        kernels.add(kernels.diff(kernels.snapshot(), cmp0), -1)
        del params
    free_card()
    mesh.barrier()
    if rank == 0:
        cmp0 = kernels.snapshot()
        p16 = init_params(cfg, seed=0, device="cuda")
        out["one_device"] = serve(p16, "dense")
        free_card()
        out["one_cuda"] = [x.cpu() for x in model_logits(cfg, p16, ins,
                                                         "cuda")]
        out["d16"] = [x.cpu() for x in model_logits(cfg, p16, ins, "dense")]
        if state:
            out["state_one"] = {layout: session_state(cfg, p16, layout, ins)
                                for layout in ("dense", "paged")}
        p32 = tree_map(lambda t: t.float(), p16)
        del p16
        c32 = dataclasses.replace(cfg, dtype="float32", param_dtype="float32")
        out["ref"] = [x.cpu() for x in model_logits(c32, p32, ins, "dense")]
        if state:
            out["state_ref"] = session_state(dataclasses.replace(
                c32, prefill_backend="dense", decode_backend="dense"), p32,
                "dense", ins)
        del p32
        free_card()
        kernels.add(kernels.diff(kernels.snapshot(), cmp0), -1)
    mesh.barrier()
    return out


def head_shapes(lay, G, rank):
    """The (query heads, KV heads) of each attention call of ``rank``
    under the mesh (``lay``, the model's ``Layout``; G query heads a KV
    head): each run of query heads on the one KV head it reads
    (``kv_runs``), else all the rank's query and KV heads."""
    from repro_torch.models import transformer as tx
    if lay.kv_runs is None:
        return {(lay.q_heads, lay.kv_heads)}
    c, i = lay.mesh.coords(rank), 0
    for a in lay.q_block:               # the rank's block of query heads
        i = i * lay.mesh.shape[a] + c[a]
    return {(b - a, 1) for a, b, _ in tx._kv_runs(i * lay.q_heads,
                                                   lay.q_heads, G)}


def heads_holds(rank, lay, dh, G):
    """B1, B2 and B3 at each of this rank's ``head_shapes`` that no lower
    rank has, at the path's shapes on random bf16 inputs, each against
    its plain version (TOL): the shapes held and the largest max|err| by
    kernel."""
    from repro_torch.kernels.flash_prefill.ops import (flash_prefill,
                                                       flash_prefill_ref)
    from repro_torch.kernels.timing import path_mask
    from repro_torch.kernels.tree_attention.ops import (
        tree_attention, tree_attention_reference)
    from repro_torch.kernels.tree_attention.paged import (
        paged_tree_attention, paged_tree_attention_reference)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(rank)
    dt = torch.bfloat16
    heads = sorted(head_shapes(lay, G, rank).difference(
        *(head_shapes(lay, G, r) for r in range(rank))))
    B, T, _, _, _, S = PATH_TREE
    Bp, Tp, _, _, _, bs, bpl = PATH_PAGED
    Bf, Sf = PATH_PREFILL[0][:2]
    errs = dict.fromkeys(("tree_attention", "paged_tree_attention",
                          "flash_prefill"), 0.0)
    for H, K in heads:
        q, k, v = (randn(gen, shp, dt) for shp in
                   ((B, T, H, dh), (B, S, K, dh), (B, S, K, dh)))
        mask = path_mask(B, T, S, max_new=MAX_NEW)
        e1 = hold(f"rank {rank} tree_attention", tree_attention(
            q, k, v, mask), tree_attention_reference(q, k, v, mask), dt,
            (B, T, H, K, dh, S))
        q, kp, vp, bt, mask = paged_case(gen, Bp, Tp, H, K, dh, bs, bpl, dt,
                                         path_mask(Bp, Tp, bs * bpl,
                                                   max_new=MAX_NEW))
        e2 = hold(f"rank {rank} paged_tree_attention", paged_tree_attention(
            q, kp, vp, bt, mask), paged_tree_attention_reference(
            q, kp, vp, bt, mask), dt, (Bp, Tp, H, K, dh, bs, bpl))
        q, k, v = (randn(gen, shp, dt) for shp in
                   ((Bf, Sf, H, dh), (Bf, Sf, K, dh), (Bf, Sf, K, dh)))
        e3 = hold(f"rank {rank} flash_prefill", flash_prefill(q, k, v),
                  flash_prefill_ref(q, k, v), dt, (Bf, Sf, H, K, dh))
        for name, e in zip(errs, (e1, e2, e3)):
            errs[name] = max(errs[name], e)
    return heads, errs


def dist_heads_world(rank):
    """(g): each of DIST_HEADS_ARCHS on mesh (data 1, model 8), the serve
    rules, its depth cut to DIST_HEADS_LAYERS: query heads that split off
    one KV head (``dist_tp_world`` without the session state)."""
    return {arch: dist_tp_world(rank, 1, 8, "serve", DIST_HEADS_LAYERS,
                                DIST_HEADS_PROMPTS, DIST_HEADS_NEW,
                                arch=arch, state=False)
            for arch in DIST_HEADS_ARCHS}


# (h) (ROADMAP A16b 6.3): the four recommenders placed over mesh (data 2,
# model 2) on 4 gloo ranks sharing cuda:0, full configs in f32: the
# tables' rows over model (a rank holds half of each: W&D's 2.56 GB, B5
# over its window), the rows of the batch over data
DIST_RECSYS_MESH = (2, 2)
DIST_RECSYS_CALLS = 3          # timed calls a serve_p99 cell a rank
DIST_RECSYS_TRAIN_STEPS = 2    # W&D train_batch (B 65,536)
DIST_RECSYS_CAND_SEED = 7      # Two-Tower's unit candidates, drawn on the card
WD_CANDIDATES = 1_000_000      # W&D retrieval_cand: one user's contexts


def dist_timed(mesh, fn, n):
    """(median host ms of ``n`` calls fn(), each from a barrier of the
    mesh to a synchronize, the last call's result)."""
    ms, out = [], None
    for _ in range(n):
        out = None
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ms)), out


def close_to(got, ref, **tol):
    """(max |got - ref| in float64, allclose within ``tol`` and finite)."""
    got, ref = got.double(), ref.double()
    err = float((got - ref).abs().max())
    return err, bool(torch.isfinite(got).all()) and torch.allclose(
        got, ref, **(tol or RECSYS_TOL))


def recsys_inputs(name, cfg, B, seed, cands=True):
    """The cell inputs of recommender ``name`` for B rows from a numpy
    seed, on the card: the same on every rank."""
    from repro_torch import configs
    from repro_torch.training import data
    rng = np.random.RandomState(seed)
    if name == "wide-deep":
        b = to_cuda(data.wide_deep_batch(rng, B, cfg.n_sparse,
                                         cfg.rows_per_table, cfg.multi_hot,
                                         cfg.n_dense))
        return b["sparse_ids"], b["sparse_mask"], b["dense"]
    if name == "two-tower-retrieval":
        b = to_cuda(data.two_tower_batch(rng, B, cfg.n_user_fields,
                                         cfg.n_item_fields,
                                         cfg.rows_per_table))
        return b["user_ids"], b["item_ids"]
    b = to_cuda(data.seq_rec_batch(rng, B, cfg.seq_len, cfg.n_items,
                                   name == "sasrec"))
    ins = (b["ids"], b["pad_mask"])
    if cands:
        ins += (torch.from_numpy(rng.randint(
            2, cfg.n_items, (B, configs.get_arch(name).N_CAND)).astype(
                np.int32)).cuda(),)
    return ins


def wd_train_batch(cfg, i):
    """Step i's W&D train batch (B 65,536), the same on every rank."""
    from repro_torch.configs.recsys_common import BATCHES
    from repro_torch.training import data
    return to_cuda(data.wide_deep_batch(
        np.random.RandomState(300 + i), BATCHES["train_batch"],
        cfg.n_sparse, cfg.rows_per_table, cfg.multi_hot, cfg.n_dense))


def meta_tree(x):
    """Meta copies of a tree's tensors (dicts, lists and tuples kept)."""
    if isinstance(x, dict):
        return {k: meta_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(meta_tree(v) for v in x)
    return x.to("meta")


def unit_candidates(n, d):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(DIST_RECSYS_CAND_SEED)
    c = torch.randn((n, d), generator=gen, device="cuda")
    return c / c.norm(dim=-1, keepdim=True)


def dist_recsys_world(rank):
    """(h): every recommender's serve_p99 and retrieval_cand, W&D's
    serve_bulk once and DIST_RECSYS_TRAIN_STEPS W&D train steps, placed
    over mesh (data 2, model 2) (``init_params(mesh=)``: each rank draws
    the single device's numbers and keeps its blocks); B5 launched by the
    W&D calls (the window form) and counted; the collectives of one W&D
    serve_p99 forward on the real mesh and on a ``TracedMesh`` of the
    same rank over meta copies; gloo's share of the bulk forward.  Then
    rank 0 alone, the others waiting: the single device's results on the
    whole parameters (the same seed and numbers), against which rank 0
    holds the mesh's (nothing raises inside a rank: the parent checks)."""
    from repro_torch import configs
    from repro_torch.configs.recsys_common import BATCHES
    from repro_torch.distributed.sharding import TracedMesh, sharding_ctx
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_fused
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.recsys.common import Lanes
    from repro_torch.training.optimizer import adamw_init, tree_leaves
    mesh = make_host_mesh(*DIST_RECSYS_MESH, device="cuda:0")
    N = RECSYS_BULK_CHECK_ROWS
    torch.cuda.reset_peak_memory_stats()
    res = {"ms": {}, "gb": {}, "checks": {}, "counts": {}}
    got = {}
    embedding_bag_fused.launches = 0
    wd_calls = 0

    def gb(tree):
        return sum(a.numel() * a.element_size()
                   for a in tree_leaves(tree)) / 1e9

    # ---- Wide & Deep
    wd = configs.get_arch("wide-deep")
    cfg = wd.full_config()
    fwd = wd.serve_cell("serve_p99").fn
    with sharding_ctx(mesh):
        params = wd.model.init_params(cfg, seed=0, mesh=mesh)
        res["blocks"] = {"wide-deep": tuple(params["tables"].shape)}
        res["gb"]["wide-deep"] = gb(params)
        p99 = recsys_inputs("wide-deep", cfg, BATCHES["serve_p99"], 100)
        ms, out = dist_timed(mesh, lambda: fwd(cfg, params, *p99),
                             DIST_RECSYS_CALLS)
        wd_calls += DIST_RECSYS_CALLS
        res["ms"]["wide-deep serve_p99"] = ms
        got["wd_p99"] = Lanes(BATCHES["serve_p99"]).gather(out)
        mesh.reset_counts()
        fwd(cfg, params, *p99)
        wd_calls += 1
        res["counts"]["real"] = mesh.collective_records()
        traced = TracedMesh(mesh.shape, mesh.rank)
        with sharding_ctx(traced):
            fwd(cfg, meta_tree(params), *meta_tree(p99))
        res["counts"]["traced"] = traced.collective_records()
        bulk = recsys_inputs("wide-deep", cfg, BATCHES["serve_bulk"], 200)
        mesh.reset_counts()
        mesh.timing, mesh.collective_s = True, 0.0
        ms, out = dist_timed(mesh, lambda: fwd(cfg, params, *bulk), 1)
        mesh.timing = False
        wd_calls += 1
        res["bulk"] = dict(ms=ms, collective_s=mesh.collective_s,
                           records=mesh.collective_records(),
                           bags_gb=out.shape[0] * cfg.n_sparse
                           * (cfg.embed_dim + 1) * 4 / 1e9)
        got["wd_bulk"] = Lanes(BATCHES["serve_bulk"]).gather(out)[:N]
        del bulk, out
        cand = recsys_inputs("wide-deep", cfg, WD_CANDIDATES, 250)
        ms, out = dist_timed(mesh, lambda: fwd(cfg, params, *cand), 1)
        wd_calls += 1
        res["ms"]["wide-deep retrieval_cand"] = ms
        got["wd_cand"] = Lanes(WD_CANDIDATES).gather(out)[:N]
        del cand, out
        torch.cuda.empty_cache()
        step = wd.train_cell(cfg).step
        state = [params, adamw_init(params)]
        del params
        losses, secs = [], []
        for i in range(DIST_RECSYS_TRAIN_STEPS):
            b = wd_train_batch(cfg, i)
            ms, (p, o, m) = dist_timed(mesh, lambda: step(*state, b), 1)
            state = [p, o]
            losses.append((float(m["loss"]), float(m["grad_norm"])))
            secs.append(ms / 1e3)
            wd_calls += 1
            del p, o, m, b
        res["wd_train"] = dict(losses=losses, secs=secs,
                               state_gb=gb(state[0]) + gb(state[1].mu)
                               + gb(state[1].nu))
        del state
    res["launches"] = {"embedding_bag": embedding_bag_fused.launches}
    res["wd_forwards"] = wd_calls
    torch.cuda.empty_cache()

    # ---- Two-Tower, SASRec, BERT4Rec: serve_p99 and retrieval_cand
    for name in ("two-tower-retrieval", "sasrec", "bert4rec"):
        mod = configs.get_arch(name)
        cfg = mod.full_config()
        with sharding_ctx(mesh):
            params = mod.model.init_params(cfg, seed=0, mesh=mesh)
            res["gb"][name] = gb(params)
            ins = recsys_inputs(name, cfg, BATCHES["serve_p99"], 400)
            lanes = Lanes(BATCHES["serve_p99"])
            fn = mod.serve_cell("serve_p99").fn
            ms, out = dist_timed(mesh, lambda: fn(cfg, params, *ins),
                                 DIST_RECSYS_CALLS)
            res["ms"][f"{name} serve_p99"] = ms
            got[f"{name}_p99"] = lanes.gather(out)
            fn = mod.serve_cell("retrieval_cand").fn
            if name == "two-tower-retrieval":
                for key, tab, ids in (("user", "user_tables", ins[0]),
                                      ("item", "item_tables", ins[1])):
                    got[f"tt_{key}_rows"] = lanes.gather(
                        mod.model.field_rows(cfg, params[tab], ids))
                got["tt_user"] = lanes.gather(mod.model.user_embed(
                    cfg, params, ins[0]))
                got["tt_item"] = lanes.gather(mod.model.item_embed(
                    cfg, params, ins[1]))
                # this rank's rows of the batch, which its towers computed
                got["tt_rows"] = (lanes.start,
                                  lanes.local(ins[0]).shape[0])
                one = (recsys_inputs(name, cfg, 1, 402)[0],
                       unit_candidates(mod.N_CAND, cfg.tower_dims[-1]))
            else:
                one = recsys_inputs(name, cfg, 1, 500, cands=False)
            ms, out = dist_timed(mesh, lambda: fn(cfg, params, *one),
                                 DIST_RECSYS_CALLS)
            res["ms"][f"{name} retrieval_cand"] = ms
            got[f"{name}_cand"] = out
            del params, out, one
        torch.cuda.empty_cache()
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    mesh.barrier()
    if rank == 0:
        res["checks"] = dist_recsys_one_device(got)
    mesh.barrier()
    return res


def dist_recsys_one_device(got):
    """Rank 0 alone: the single device's results on the whole parameters
    (seed 0, the numbers the ranks' blocks hold) and float64 for W&D,
    against the mesh's ``got``: {check: (max err, ok)}."""
    from repro_torch import configs
    from repro_torch.configs.recsys_common import BATCHES
    from repro_torch.training.optimizer import adamw_init
    N = RECSYS_BULK_CHECK_ROWS
    out = {}
    wd = configs.get_arch("wide-deep")
    cfg = wd.full_config()
    params = wd.model.init_params(cfg, seed=0)
    for key, B, seed, rows in (("wd_p99", BATCHES["serve_p99"], 100, None),
                               ("wd_bulk", BATCHES["serve_bulk"], 200, N),
                               ("wd_cand", WD_CANDIDATES, 250, N)):
        ins = [x[:rows] for x in recsys_inputs("wide-deep", cfg, B, seed)]
        out[f"{key} vs float64"] = close_to(got[key],
                                            wide_deep64(params, *ins))
        del ins
    step = wd.train_cell(cfg).step
    state = [params, adamw_init(params)]
    del params
    losses = []
    for i in range(DIST_RECSYS_TRAIN_STEPS):
        b = wd_train_batch(cfg, i)
        if i == 0:
            z = wide_deep64(state[0], b["sparse_ids"], b["sparse_mask"],
                            b["dense"])
            y = b["labels"].double()
            losses.append(float(torch.mean(
                z.clamp_min(0) - z * y + torch.log1p(torch.exp(-z.abs())))))
        p, o, m = step(*state, b)
        state = [p, o]
        out[f"wd train step {i} (loss, grad norm) one device"] = (
            float(m["loss"]), float(m["grad_norm"]))
        del p, o, m, b
    out["wd train loss 0 float64"] = losses[0]
    del state
    torch.cuda.empty_cache()
    tt = configs.get_arch("two-tower-retrieval")
    cfg = tt.full_config()
    params = tt.model.init_params(cfg, seed=0)
    users, items = recsys_inputs(tt.ARCH, cfg, BATCHES["serve_p99"], 400)
    lo, n = got["tt_rows"]
    for key, fn, tab, ids in (
            ("tt_user", tt.model.user_embed, "user_tables", users),
            ("tt_item", tt.model.item_embed, "item_tables", items)):
        one = tt.model.field_rows(cfg, params[tab], ids)
        out[f"{key} field rows torch.equal"] = (
            float((got[f"{key}_rows"] - one).abs().max()),
            torch.equal(got[f"{key}_rows"], one))
        # the towers on the rank's rows alone (the products' shapes the
        # rank ran) give the rank's bits; the whole batch runs other
        # products, so the whole is held at the recsys tolerance
        mine, one = got[key][lo:lo + n], fn(cfg, params, ids[lo:lo + n])
        out[f"{key} embeddings, rows [{lo}, {lo + n}), torch.equal to one "
            f"device on those rows"] = (float((mine - one).abs().max()),
                                        torch.equal(mine, one))
        out[f"{key} embeddings vs one device"] = close_to(
            got[key], fn(cfg, params, ids))
    out["two-tower-retrieval_p99 vs one device"] = close_to(
        got["two-tower-retrieval_p99"], tt.serve_cell("serve_p99").fn(
            cfg, params, users, items))
    user = recsys_inputs(tt.ARCH, cfg, 1, 402)[0]
    cand = unit_candidates(tt.N_CAND, cfg.tower_dims[-1])
    v, i = tt.serve_cell("retrieval_cand").fn(cfg, params, user, cand)
    gv, gi = got["two-tower-retrieval_cand"]
    out["tt top-128 values vs one device"] = close_to(gv, v)
    out["tt top-128 indices equal (positions that differ)"] = (
        int((gi != i).sum()), torch.equal(gi, i))
    del params, cand
    for name in ("sasrec", "bert4rec"):
        mod = configs.get_arch(name)
        cfg = mod.full_config()
        params = mod.model.init_params(cfg, seed=0)
        ins = recsys_inputs(name, cfg, BATCHES["serve_p99"], 400)
        out[f"{name}_p99 vs one device"] = close_to(
            got[f"{name}_p99"], mod.serve_cell("serve_p99").fn(cfg, params,
                                                               *ins))
        one = recsys_inputs(name, cfg, 1, 500, cands=False)
        out[f"{name}_cand vs one device"] = close_to(
            got[f"{name}_cand"], mod.serve_cell("retrieval_cand").fn(
                cfg, params, *one))
        del params
    torch.cuda.empty_cache()
    return out


def dist_recsys_rule(res):
    """(h)'s checks on every rank's results (see ``dist_recsys_world``)."""
    r0 = res[0]
    print(f"  (h) the recommenders, 4 gloo ranks, mesh (data 2, model 2), "
          f"DEFAULT_RULES, full configs, f32: W&D's tables a rank "
          f"{r0['blocks']['wide-deep']} "
          f"(weights a rank, GB: "
          f"{', '.join(f'{k} {v:.3f}' for k, v in r0['gb'].items())})")
    for r, x in enumerate(res):
        print(f"  (h) rank {r}: "
              f"{', '.join(f'{k} {v:.2f} ms' for k, v in x['ms'].items())}; "
              f"peak {x['peak_gb']:.2f} GB; B5 "
              f"{x['launches']['embedding_bag']} launches for "
              f"{x['wd_forwards']} W&D forwards")
        check(x["launches"]["embedding_bag"] == 2 * x["wd_forwards"],
              f"(h) rank {r}: B5 launched {x['launches']['embedding_bag']} "
              f"times for {x['wd_forwards']} W&D forwards")
        check(x["counts"]["real"] == x["counts"]["traced"] and
              x["counts"]["real"], f"(h) rank {r}: gloo's records "
                                   f"{x['counts']['real']} != traced "
                                   f"{x['counts']['traced']}")
        b = x["bulk"]
        print(f"  (h) rank {r}: W&D serve_bulk once {b['ms']:.1f} ms, gloo "
              f"{b['collective_s'] * 1e3:.1f} ms of it "
              f"({b['collective_s'] * 1e3 / b['ms']:.3f}); handed "
              f"{sum(c['bytes'] for c in b['records']) / 1e9:.3f} GB in "
              f"{sum(c['calls'] for c in b['records'])} calls (the rank's "
              f"bags {b['bags_gb']:.3f} GB); train steps "
              f"{[round(t, 2) for t in x['wd_train']['secs']]} s, "
              f"(loss, grad norm) {x['wd_train']['losses']}, state a rank "
              f"{x['wd_train']['state_gb']:.3f} GB")
        check(x["wd_train"]["losses"] == r0["wd_train"]["losses"],
              f"(h) rank {r}'s train losses differ from rank 0's")
    rec = r0["counts"]["real"]
    kinds = ", ".join(f"{c['kind']} x{c['calls']} over {c['group']}"
                      for c in rec)
    print(f"  (h) one W&D serve_p99 forward hands gloo "
          f"{sum(c['calls'] for c in rec)} calls, "
          f"{sum(c['bytes'] for c in rec):,} B a rank ({kinds}) = the "
          "traced mesh's count")
    ch = r0["checks"]
    for i in range(DIST_RECSYS_TRAIN_STEPS):
        want = ch[f"wd train step {i} (loss, grad norm) one device"]
        got = r0["wd_train"]["losses"][i]
        ok = np.allclose(got, want, **RECSYS_TOL)
        print(f"  (h) W&D train step {i}: (loss, grad norm) mesh {got}, one "
              f"device {want} {'ok' if ok else 'FAIL'} ({RECSYS_TOL})")
        check(ok, f"(h) W&D train step {i}: {got} vs one device {want}")
    f64 = ch["wd train loss 0 float64"]
    ok = np.isclose(r0["wd_train"]["losses"][0][0], f64, **RECSYS_TOL)
    print(f"  (h) W&D train loss 0 vs float64 {f64:.8f}: "
          f"{'ok' if ok else 'FAIL'}")
    check(ok, f"(h) W&D train loss 0 vs float64 {f64}")
    for k, v in ch.items():
        if k.startswith("wd train"):
            continue
        err, ok = v
        what = f"{err}" if "positions" in k else f"max|err| {err:.3e}"
        print(f"  (h) {k}: {what} {'ok' if ok else 'FAIL'}")
        check(ok, f"(h) {k}: {err}")


DIST_GNN_MESH = (2, 2)
DIST_GNN_SHAPES = ("full_graph_sm", "molecule")
DIST_GNN_STEPS = 1             # train steps a cell, then the loss after
                               # them (cut from GNN_STEPS 2 for time)
DIST_GNN_COUNTED = "molecule"  # its bf16 forward's gloo records vs traced
DIST_GNN_STEP_RTOL = 1e-2      # a train step's loss and grad norm and the
                               # loss after the steps, mesh vs one device
                               # (readings and control in PERF.md §4)
DIST_GNN_REPEAT = "full_graph_sm"  # the cell whose edges the model ranks
DIST_GNN_REPEAT_LAYERS = 2         # repeat, cut from 12 layers for time


def gnn_forward_outs(eq, cfg, params, ins, graph):
    """One forward without grad: (node_out gathered whole, graph_out)."""
    with torch.no_grad():
        out = eq.forward(cfg, params, *ins)
        return graph.gather(out["node_out"]).float(), out["graph_out"].float()


def gnn_cell_inputs(shape, graph=None):
    """(the cell's batch on the card, forward's positional inputs), on
    ``graph`` (the gnn phase's by default)."""
    from repro_torch.configs import equiformer_v2 as ecfg
    batch = gnn_batch(ecfg, shape, graph or gnn_graph(shape))
    ins = [batch[k] for k in ("node_feat", "positions", "edges",
                              "edge_mask")]
    if shape == "molecule":
        ins += [batch["graph_ids"], ecfg.CELLS[shape]["n_graphs"]]
    return batch, ins


def gnn_repeat_cell():
    """(config, batch, forward's inputs) of DIST_GNN_REPEAT cut to
    DIST_GNN_REPEAT_LAYERS layers, on its graph with one more node (no
    edge, label -1) and two more masked zero-length edges: at (2, 2) its
    N is odd, so the nodes stay whole, and its E a multiple of ``data``
    but not of 4, so the edges split over ``data`` alone and the ranks
    along ``model`` repeat them (the layout of the tests' case g42x)."""
    from repro_torch.configs import equiformer_v2 as ecfg
    g = gnn_graph(DIST_GNN_REPEAT)
    n = len(g["node_feat"])
    g = dict(g, node_feat=np.concatenate([g["node_feat"],
                                          np.zeros_like(g["node_feat"][:1])]),
             positions=np.concatenate([g["positions"], g["positions"][:1]]),
             labels=np.concatenate([g["labels"], [-1]]).astype(np.int32),
             edges=np.concatenate([g["edges"], np.full((2, 2), n, np.int32)]),
             edge_mask=np.concatenate([g["edge_mask"], [False, False]]))
    cfg = dataclasses.replace(ecfg.full_config(DIST_GNN_REPEAT),
                              n_layers=DIST_GNN_REPEAT_LAYERS)
    return (cfg,) + gnn_cell_inputs(DIST_GNN_REPEAT, g)


def gnn_control(eq):
    """The controls of ``--gnn-controls``, for the rest of the process: a
    node-side replicated weight's gradient summed over ``model`` too (the
    tests' mutation), and sums in the atomics' order where the model
    ranks repeat the edges (``Graph.ordered`` off)."""
    from repro_torch.distributed.sharding import sum_grad

    def over_model(self, w):
        return sum_grad(w, self.split.mesh,
                        self.split.node_axes + ("model",))
    sound = eq.Graph.__init__

    def unordered(self, *a):
        sound(self, *a)
        self.ordered = False
    eq.Graph.node_weight, eq.Graph.__init__ = over_model, unordered


def dist_gnn_world(rank, control=False):
    """(i): EquiformerV2's DIST_GNN_SHAPES at full width placed over mesh
    (data 2, model 2) under ``DEFAULT_RULES`` (``init_params(mesh=)``:
    each rank draws the single device's numbers and keeps its "tensor"
    blocks; it runs its rows of the edges and its block of the nodes):
    an f32 and a bf16 forward (its collectives counted: DIST_GNN_COUNTED's
    also on a ``TracedMesh`` over meta copies), DIST_GNN_STEPS bf16 train
    steps (timed, the collectives timed) and the loss after them; then
    ``gnn_repeat_cell``: an f32 forward, the steps and the loss after
    them.  Then rank 0 alone, the others waiting: one device's forwards
    and steps on the whole parameters (nothing raises inside a rank: the
    parent checks).  ``control``: under ``gnn_control``."""
    from repro_torch import kernels
    from repro_torch.configs import equiformer_v2 as ecfg
    from repro_torch.distributed.sharding import TracedMesh, sharding_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.gnn import equiformer as eq
    from repro_torch.training.optimizer import tree_leaves
    if control:
        gnn_control(eq)
    mesh = make_host_mesh(*DIST_GNN_MESH, device="cuda:0")
    before = kernels.snapshot()
    torch.cuda.reset_peak_memory_stats()
    res, got = {"cells": {}}, {}
    for shape in DIST_GNN_SHAPES:
        cfg = ecfg.full_config(shape)
        c = ecfg.CELLS[shape]
        batch, ins = gnn_cell_inputs(shape)
        x, t0 = {}, time.perf_counter()
        with sharding_ctx(mesh):
            graph = eq.Graph(cfg, c["n_nodes"], c["n_edges"])
            sp = graph.split
            x["split"] = dict(edges=(sp.edge_axes, sp.edge_rows),
                              nodes=(sp.node_axes, sp.node_rows))
            p32 = eq.init_params(dataclasses.replace(cfg, dtype="float32"),
                                 seed=0, mesh=mesh)
            got[f"{shape} f32"] = gnn_forward_outs(
                eq, dataclasses.replace(cfg, dtype="float32"), p32, ins,
                graph)
            del p32
            params = eq.init_params(cfg, seed=0, mesh=mesh)
            x["blocks"] = {k: tuple(params["layers"][k].shape)
                           for k in ("w0", "wr1", "ffn_w1", "ffn_w2")}
            x["gb"] = sum(a.numel() * a.element_size()
                          for a in tree_leaves(params)) / 1e9
            mesh.reset_counts()
            with torch.no_grad():
                out = eq.forward(cfg, params, *ins)
            x["counts"] = {"real": mesh.collective_records()}
            got[f"{shape} bf16"] = (graph.gather(out["node_out"]).float(),
                                    out["graph_out"].float())
            del out
            if shape == DIST_GNN_COUNTED:
                traced = TracedMesh(mesh.shape, mesh.rank)
                with sharding_ctx(traced), torch.no_grad():
                    eq.forward(cfg, meta_tree(params), *(
                        a.to("meta") if torch.is_tensor(a) else a
                        for a in ins))
                x["counts"]["traced"] = traced.collective_records()
            x["losses"], x["secs"], x["shares"] = gnn_steps(
                ecfg, eq, shape, cfg, params, batch, mesh)
            del params
        x["cell_s"] = time.perf_counter() - t0
        torch.cuda.empty_cache()
        res["cells"][shape] = x
    cfg, batch, ins = gnn_repeat_cell()
    t0 = time.perf_counter()
    with sharding_ctx(mesh):
        graph = eq.Graph(cfg, len(batch["node_feat"]), len(batch["edges"]))
        sp = graph.split
        x = {"split": (sp.edge_axes, sp.node_axes), "ordered": graph.ordered}
        c32 = dataclasses.replace(cfg, dtype="float32")
        x["f32"] = gnn_forward_outs(eq, c32, eq.init_params(
            c32, seed=0, mesh=mesh), ins, graph)
        x["losses"] = gnn_steps(ecfg, eq, DIST_GNN_REPEAT, cfg,
                                eq.init_params(cfg, seed=0, mesh=mesh),
                                batch, mesh)[0]
    x["cell_s"] = time.perf_counter() - t0
    res["repeat"] = x
    res["launches"] = {}
    res["moved"] = kernels.diff(kernels.snapshot(), before)
    res["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    mesh.barrier()
    if rank == 0:
        res["one"] = dist_gnn_one_device()
        res["got"] = got
    mesh.barrier()
    return res


def gnn_steps(ecfg, eq, shape, cfg, params, batch, mesh=None):
    """DIST_GNN_STEPS train steps of the cell from ``params`` and
    ``adamw_init`` of them, then the loss after them (no grad): ((loss,
    grad norm) a step and the last loss with a grad norm of None, each
    step's seconds, the collectives' share of each step under ``mesh``)."""
    from repro_torch.training.optimizer import adamw_init
    step = ecfg.train_cell(shape, cfg).step
    loss_fn = eq.energy_loss if shape == "molecule" else eq.node_class_loss
    state, losses, secs, shares = [params, adamw_init(params)], [], [], []
    del params
    for _ in range(DIST_GNN_STEPS):
        if mesh is None:
            t0 = time.perf_counter()
            p, o, m = step(*state, batch)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
        else:
            mesh.timing, mesh.collective_s = True, 0.0
            ms, (p, o, m) = dist_timed(mesh, lambda: step(*state, batch), 1)
            mesh.timing = False
            secs.append(ms / 1e3)
            shares.append(mesh.collective_s * 1e3 / ms)
        state = [p, o]
        losses.append((float(m["loss"]), float(m["grad_norm"])))
        del p, o, m
    with torch.no_grad():
        losses.append((float(loss_fn(cfg, state[0], batch)), None))
    return losses, secs, shares


def dist_gnn_one_device():
    """Rank 0 alone: one device's f32 and bf16 forwards, bf16 train steps
    and the loss after them of each DIST_GNN_SHAPES cell on the whole
    parameters (seed 0, the numbers the ranks' blocks hold), and the f32
    forward and the steps of ``gnn_repeat_cell``."""
    from repro_torch.configs import equiformer_v2 as ecfg
    from repro_torch.models.gnn import equiformer as eq
    out = {}
    for shape in DIST_GNN_SHAPES:
        cfg = ecfg.full_config(shape)
        c = ecfg.CELLS[shape]
        batch, ins = gnn_cell_inputs(shape)
        graph = eq.Graph(cfg, c["n_nodes"], c["n_edges"])   # no mesh: whole
        for dt in ("float32", "bfloat16"):
            cd = dataclasses.replace(cfg, dtype=dt)
            params = eq.init_params(cd, seed=0)
            out[f"{shape} {'f32' if dt == 'float32' else 'bf16'}"] = \
                gnn_forward_outs(eq, cd, params, ins, graph)
        out[f"{shape} losses"] = gnn_steps(ecfg, eq, shape, cfg, params,
                                          batch)[0]
        del params
        torch.cuda.empty_cache()
    cfg, batch, ins = gnn_repeat_cell()
    c32 = dataclasses.replace(cfg, dtype="float32")
    out["repeat f32"] = gnn_forward_outs(
        eq, c32, eq.init_params(c32, seed=0), ins,
        eq.Graph(c32, len(batch["node_feat"]), len(batch["edges"])))
    out["repeat losses"] = gnn_steps(ecfg, eq, DIST_GNN_REPEAT, cfg,
                                     eq.init_params(cfg, seed=0), batch)[0]
    return out


def gnn_step_gaps(got, want):
    """|mesh - one device| / |one device| of the first step's loss and
    grad norm and of the loss after the steps (``gnn_steps``' first
    lists)."""
    pairs = {"loss": (got[0][0], want[0][0]),
             "grad norm": (got[0][1], want[0][1]),
             "loss after": (got[-1][0], want[-1][0])}
    return {k: abs(a - b) / abs(b) for k, (a, b) in pairs.items()}


def dist_gnn_rule(res):
    """(i)'s checks on every rank's results (see ``dist_gnn_world``)."""
    r0 = res[0]
    one, got = r0["one"], r0["got"]
    rep0 = r0["repeat"]
    for r, x in enumerate(res):
        check(not x["moved"], f"(i) rank {r} launched port kernels: "
                              f"{x['moved']}")
        for shape, c in x["cells"].items():
            print(f"  (i) rank {r} {shape}: edges {c['split']['edges']}, "
                  f"nodes {c['split']['nodes']} a rank (axes, rows); "
                  f"blocks {c['blocks']}, weights {c['gb']:.4f} GB a rank; "
                  f"train steps {[round(t, 3) for t in c['secs']]} s, "
                  f"collectives {[round(v, 4) for v in c['shares']]} of a "
                  f"step; (loss, grad norm) a step, then the loss after "
                  f"them {c['losses']}; a bf16 forward hands gloo "
                  f"{sum(v['bytes'] for v in c['counts']['real']):,} B; "
                  f"the cell {c['cell_s']:.1f} s")
            check(c["losses"] == r0["cells"][shape]["losses"],
                  f"(i) rank {r} {shape}: losses differ from rank 0's")
        rep = x["repeat"]
        print(f"  (i) rank {r} {DIST_GNN_REPEAT} at "
              f"{DIST_GNN_REPEAT_LAYERS} layers, edges repeated over model: "
              f"(edge axes, node axes) {rep['split']}, ordered sums "
              f"{rep['ordered']}; (loss, grad norm), then the loss after "
              f"{rep['losses']}; the cell {rep['cell_s']:.1f} s")
        check(rep["split"] == (("data",), ()) and rep["ordered"],
              f"(i) rank {r} repeat cell: layout {rep['split']}, ordered "
              f"{rep['ordered']}")
        check(rep["losses"] == rep0["losses"] and all(
            torch.equal(a, b) for a, b in zip(rep["f32"], rep0["f32"])),
              f"(i) rank {r} repeat cell: its outputs or losses are not "
              "rank 0's bits")
        print(f"  (i) rank {r}: peak {x['peak_gb']:.2f} GB")
        cnt = x["cells"][DIST_GNN_COUNTED]["counts"]
        check(cnt["real"] and cnt["real"] == cnt["traced"],
              f"(i) rank {r}: gloo's records {cnt['real']} != traced "
              f"{cnt['traced']}")
    for shape in DIST_GNN_SHAPES + ("repeat",):
        losses = (rep0 if shape == "repeat" else r0["cells"][shape])["losses"]
        gaps = gnn_step_gaps(losses, one[f"{shape} losses"])
        ok = all(v <= DIST_GNN_STEP_RTOL for v in gaps.values())
        print(f"  (i) {shape}: (loss, grad norm) mesh {losses}, one device "
              f"{one[f'{shape} losses']}; relative gaps "
              f"{ {k: f'{v:.3e}' for k, v in gaps.items()} } (limit "
              f"{DIST_GNN_STEP_RTOL}) {'ok' if ok else 'FAIL'}")
        check(ok, f"(i) {shape}: mesh vs one device {gaps}")
        check(all(np.isfinite(v) for pair in losses for v in pair
                  if v is not None) and losses[-1][0] < losses[0][0],
              f"(i) {shape}: the loss does not fall: {losses}")
    worst = close_tree("(i) repeat f32 mesh vs one device", rep0["f32"],
                       one["repeat f32"], GNN_WIDE_TOL)
    print(f"  (i) repeat f32 node_out, graph_out vs one device: max err "
          f"{worst:.3e} of each array's largest |value| ({GNN_WIDE_TOL}); "
          "every rank's the same bits")
    for shape in DIST_GNN_SHAPES:
        ref = one[f"{shape} f32"]
        worst = close_tree(f"(i) {shape} f32 mesh vs one device",
                           got[f"{shape} f32"], ref, GNN_WIDE_TOL)
        print(f"  (i) {shape} f32 node_out, graph_out vs one device: max "
              f"err {worst:.3e} of each array's largest |value| "
              f"({GNN_WIDE_TOL})")

        def flat(outs):
            return torch.cat([o.double().flatten().cpu() for o in outs])
        want = flat(ref)
        e_mesh = float((flat(got[f"{shape} bf16"]) - want).square().mean()
                       .sqrt())
        e_one = float((flat(one[f"{shape} bf16"]) - want).square().mean()
                      .sqrt())
        ok = e_mesh <= BF16_LOGIT_RATIO * e_one
        print(f"  (i) {shape} bf16: RMS err from one device's f32, mesh "
              f"{e_mesh:.4e}, one device {e_one:.4e} (x{e_mesh / e_one:.3f};"
              f" limit x{BF16_LOGIT_RATIO}) {'ok' if ok else 'FAIL'}")
        check(ok, f"(i) {shape} bf16: RMS err {e_mesh} > {BF16_LOGIT_RATIO}"
                  f" x {e_one}")
    rec = r0["cells"][DIST_GNN_COUNTED]["counts"]["real"]
    kinds = ", ".join(f"{c['kind']} x{c['calls']} over {c['group']}"
                      for c in rec)
    print(f"  (i) one {DIST_GNN_COUNTED} forward hands gloo "
          f"{sum(c['calls'] for c in rec)} calls, "
          f"{sum(c['bytes'] for c in rec):,} B a rank ({kinds}) = the traced "
          "mesh's count")


def gnn_control_report(res):
    """What the checks of ``dist_gnn_rule`` see of world (i) run under
    ``gnn_control``: each cell's relative gaps from one device, and the
    repeat cell's f32 outputs and losses on every rank against rank 0's
    (the elements whose bits differ)."""
    r0 = res[0]
    for shape in DIST_GNN_SHAPES + ("repeat",):
        losses = (r0["repeat"] if shape == "repeat"
                  else r0["cells"][shape])["losses"]
        gaps = gnn_step_gaps(losses, r0["one"][f"{shape} losses"])
        print(f"  (i) control {shape}: (loss, grad norm) mesh {losses}, one "
              f"device {r0['one'][f'{shape} losses']}; relative gaps "
              f"{ {k: f'{v:.3e}' for k, v in gaps.items()} } (limit "
              f"{DIST_GNN_STEP_RTOL})")
    for r, x in enumerate(res[1:], 1):
        rep, rep0 = x["repeat"], r0["repeat"]
        differ = [int((a != b).sum()) for a, b in zip(rep["f32"],
                                                      rep0["f32"])]
        print(f"  (i) control repeat rank {r} vs rank 0: f32 (node_out, "
              f"graph_out) elements whose bits differ {differ} of "
              f"{[a.numel() for a in rep['f32']]}; losses "
              f"{'equal' if rep['losses'] == rep0['losses'] else 'differ'} "
              f"{rep['losses']}")


def dist_heads_phase():
    """(g): ``dist_heads_world``, each arch held by ``dist_tp_rule``;
    returns each arch's results a rank."""
    res = dist_spawn("dist_heads_world", 8, "gloo")
    out = {arch: [r[arch] for r in res] for arch in DIST_HEADS_ARCHS}
    for arch, ranks in out.items():
        dist_tp_rule(f"(g) {arch} cut to {DIST_HEADS_LAYERS} layers, mesh "
                     "(data 1, model 8), serve rules", ranks)
    return out


def dist_tp_serve(rank):
    """(d): Qwen2-1.5B cut to DIST_TP_D_LAYERS layers on mesh (data 1,
    model 2), the serve rules (tensor parallelism only)."""
    return dist_tp_world(rank, 1, 2, "serve", DIST_TP_D_LAYERS)


def dist_tp_fsdp(rank):
    """(e): Qwen2-1.5B cut to DIST_TP_E_LAYERS layers on mesh (data 2,
    model 2), ``DEFAULT_RULES`` (the FSDP gathers over ``data``)."""
    return dist_tp_world(rank, 2, 2, "default", DIST_TP_E_LAYERS,
                         DIST_TP_E_PROMPTS, DIST_TP_E_NEW, paged_checks=True)


def dist_tp_rule(label, res):
    """The parent's checks of a placement world: every rank's tokens, on
    both layouts and in both passes, the single-device session's, the
    primed pass in fewer steps (drafts accepted); the gathered prefill and
    step logits alike on every rank and within BF16_LOGIT_RATIO of the
    dense bf16 path's RMS error against the dense f32 path; B1, B2 and B3
    launched on every rank.  Prints the weights and the peak a rank."""
    from repro_torch.distributed.sharding import REDUCE_DTYPE

    def rms(a):
        return a.pow(2).mean().sqrt().item()

    r0 = res[0]
    want = r0["one_device"][0][0]
    for r, x in enumerate(res):
        for layout in ("dense", "paged"):
            for i, (toks, wall, steps) in enumerate(x[layout]):
                check(toks == want, f"{label} rank {r} {layout} pass {i}: "
                                    "tokens differ from the single-device "
                                    "session's")
            check(x[layout][1][2] < x[layout][0][2],
                  f"{label} rank {r} {layout}: the primed pass took "
                  f"{x[layout][1][2]} steps, the first {x[layout][0][2]}")
        check(torch.equal(x["pre"], r0["pre"]) and torch.equal(
            x["step"], r0["step"]), f"{label}: rank {r}'s gathered logits "
                                    "differ from rank 0's")
        n = x["launches"]
        check(n["tree_attention"] > 0 and n["paged_tree_attention"] > 0
              and n["flash_prefill"] > 0,
              f"{label} rank {r}: B1/B2/B3 launches {n}")
        runs = "; ".join(
            f"{layout} {x[layout][0][1]:.1f} s ({x[layout][0][2]} steps), "
            f"primed {x[layout][1][1]:.1f} s ({x[layout][1][2]} steps)"
            for layout in ("dense", "paged"))
        q_heads, kv_heads, kv_runs, q_gather, _ = x["heads"]
        held, errs = x["holds"]
        heads = (f"all {q_heads} query heads (q gathered over {q_gather})"
                 if q_gather else f"{q_heads} query heads on "
                 + (f"KV runs {kv_runs}" if kv_runs
                    else f"{kv_heads} KV heads"))
        print(f"  {label} rank {r}: {heads}, weights "
              f"{x['weight_bytes'] / 1e9:.3f} GB of "
              f"{x['whole_bytes'] / 1e9:.3f} whole, peak "
              f"{x['peak_gb']:.2f} GB; {runs}; launches B1 "
              f"{n['tree_attention']}, B2 {n['paged_tree_attention']}, B3 "
              f"{n['flash_prefill']}; held at (query, KV) heads {held} "
              "(the shapes no lower rank held) max|err| "
              + ", ".join(f"{k} {e:.3e}" for k, e in errs.items()))
    one = r0["one_device"]
    print(f"  {label}: {r0['layers']} layers; tokens = the single-device "
          f"session's on both layouts, both passes ({sum(map(len, want))} "
          f"tokens a pass; the single-device captured session "
          f"{one[0][1]:.1f} s, {one[0][2]} steps, primed {one[1][1]:.1f} s, "
          f"{one[1][2]} steps); row-parallel partial sums reduced in "
          f"{str(REDUCE_DTYPE)[6:]} (the bf16 partials cast up, the sum cast "
          "back)")
    rule = {}
    for i, name in enumerate(("prefill", "step")):
        got = r0["pre" if i == 0 else "step"]
        e_got, e_dense, e_one = (rms(x - r0["ref"][i]) for x in (
            got, r0["d16"][i], r0["one_cuda"][i]))
        limit = BF16_LOGIT_RATIO * e_dense
        print(f"  {label} {name} logits vs the f32 path: RMS err mesh "
              f"{e_got:.4e}, one device cuda {e_one:.4e}, dense bf16 "
              f"{e_dense:.4e}; limit {limit:.4e}")
        check(bool(torch.isfinite(got).all()) and e_got <= limit,
              f"{label} {name} logits: RMS err {e_got} over {limit}")
        rule[name] = dict(rms=e_got, dense=e_dense, one=e_one)
    if "state" in r0:
        rule["session"] = state_rule(label, res)
    if "paged_probe" in r0:
        rule["paged"] = paged_rule(label, res)
    return rule


def paged_rule(label, res):
    """The paged pass under a mesh whose ``data`` splits the lanes
    (``paged_checks``): every model forward of every rank ran the
    engine's lanes / data; the ranks that hold the same KV heads (one
    ``model`` index) ended with bit-equal pools, the NULL block excepted;
    and every rank's ``TracedMesh`` recorded the collectives its ``Mesh``
    handed gloo for one paged fused step, to the byte by kind and
    group."""
    from repro_torch.distributed.sharding import ring_bytes
    data, model = res[0]["paged_probe"]["mesh"]
    for r, x in enumerate(res):
        p = x["paged_probe"]
        want = p["lanes"] // data
        print(f"  {label} paged rank {r}: lanes a forward {p['ran']} of the "
              f"engine's {p['lanes']}, pool sha256 {p['pool'][:16]}")
        check(p["ran"] == [want], f"{label} rank {r}: paged forwards ran "
                                  f"{p['ran']} lanes, not {want}")
        twin = res[r % model]["paged_probe"]["pool"]
        check(p["pool"] == twin, f"{label}: rank {r}'s pool differs from "
                                 f"rank {r % model}'s (the same KV heads)")
        real, traced = p["count"]["real"], p["count"]["traced"]
        check(bool(real) and real == traced,
              f"{label} rank {r}: the traced mesh counted {traced}, gloo "
              f"was handed {real}")
    total, kinds = ring_bytes(res[0]["paged_probe"]["count"]["real"])
    calls = {(x["kind"], x["group"]): (x["calls"], x["bytes"])
             for x in res[0]["paged_probe"]["count"]["real"]}
    print(f"  {label} paged: pools equal across data on every model index "
          f"(the NULL block excepted); one paged fused step, rank 0 "
          f"handed gloo (calls, bytes) by (kind, group) {calls} = the "
          f"traced mesh's to the byte; ring traffic {total / 1e6:.3f} MB "
          + ", ".join(f"{k} {v / 1e6:.3f}" for k, v in kinds.items() if v))
    return dict(lanes=[x["paged_probe"]["ran"] for x in res],
                ring_bytes=total, calls=calls)


def state_rule(label, res):
    """``session_state`` under the mesh against the single-device session
    (bf16, the cuda backends) on the same requests, each against the f32
    session (the dense backends): the same accepts a step and lengths,
    more than one slot accepted in some step (the commit moved rows), every
    rank's gathered state alike, and the committed K and V rows and the
    unguided step's logits each within BF16_LOGIT_RATIO of the
    single-device session's RMS error."""
    def rms(a):
        return a.pow(2).mean().sqrt().item()

    r0, ref, out = res[0], res[0]["state_ref"], {}
    for layout in ("dense", "paged"):
        got, one = r0["state"][layout], r0["state_one"][layout]
        for r, x in enumerate(res):
            mine = x["state"][layout]
            check(torch.equal(mine["rows"], got["rows"]) and torch.equal(
                mine["logits"], got["logits"]), f"{label} {layout}: rank "
                f"{r}'s gathered session state differs from rank 0's")
        check(got["accepted"] == one["accepted"] == ref["accepted"]
              and got["lens"] == one["lens"] == ref["lens"],
              f"{label} {layout} session: accepts {got['accepted']}, one "
              f"device {one['accepted']}, f32 {ref['accepted']}")
        check(max(max(a) for a in got["accepted"]) > 1,
              f"{label} {layout} session: no step accepted a draft")
        out[layout] = {}
        for name, what in (("rows", "committed K/V rows"),
                           ("logits", "unguided step logits")):
            e_got, e_one = (rms(x[name] - ref[name]) for x in (got, one))
            limit = BF16_LOGIT_RATIO * e_one
            print(f"  {label} {layout} session, {what} "
                  f"{tuple(got[name].shape)} vs the f32 session: RMS err "
                  f"mesh {e_got:.4e}, one device {e_one:.4e}; limit "
                  f"{limit:.4e}")
            check(bool(torch.isfinite(got[name]).all()) and e_got <= limit,
                  f"{label} {layout} session {name}: RMS err {e_got} over "
                  f"{limit}")
            out[layout][name] = dict(rms=e_got, one=e_one)
        print(f"  {label} {layout} session: accepts a step "
              f"{got['accepted']} (= one device's and the f32 session's), "
              f"lengths {got['lens']}")
    return out


def train_cli_cut(argv):
    """``launch/train.main(argv)`` on Qwen2-1.5B at full width, its depth
    cut to TRAIN_CLI_LAYERS (the arch module's ``full_config`` patched for
    the call); the result with its wall seconds."""
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.launch import train as train_cli
    full = qwen2_1_5b.full_config
    qwen2_1_5b.full_config = lambda: dataclasses.replace(
        full(), n_layers=TRAIN_CLI_LAYERS)
    try:
        t0 = time.perf_counter()
        out = train_cli.main(argv)
        out["wall_s"] = time.perf_counter() - t0
        return out
    finally:
        qwen2_1_5b.full_config = full


def dist_train_world(rank, data, model, steps, ckpt):
    """(f): a world of data x model gloo ranks, every rank on cuda:0, runs
    the train CLI inside ``sharding_ctx`` under the train_4k rules
    (``train_cli_cut``: ``steps`` steps, a checkpoint every
    TRAIN_CLI_EVERY into ``ckpt``, resuming from its latest); returns its
    losses, the state bytes this rank holds beside the count its
    ``placement`` gives, the peak, the kernel launches (none: training
    runs the dense attention), and on mesh (2, 2) one more step on the
    returned state, timed to a synchronize, its collectives timed (each
    then synchronizes the card before and after)."""
    from repro_torch import kernels
    from repro_torch.configs import qwen2_1_5b
    from repro_torch.distributed.sharding import DEFAULT_RULES, sharding_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tx
    from repro_torch.training.data import lm_train_batches
    from repro_torch.training.train_step import make_train_step
    mesh = make_host_mesh(data=data, model=model, device="cuda:0")
    rules = DEFAULT_RULES.override(residual_seq=("model",))
    cfg = dataclasses.replace(qwen2_1_5b.full_config(),
                              n_layers=TRAIN_CLI_LAYERS,
                              prefill_backend="dense")
    free_card()
    before = kernels.snapshot()
    with sharding_ctx(mesh, rules):
        run = train_cli_cut(["--device", "cuda", "--steps", str(steps),
                             "--ckpt-every", str(TRAIN_CLI_EVERY),
                             "--ckpt-dir", ckpt])
        out = {"losses": run["losses"], "start": run["start"],
               "wall_s": run["wall_s"], "restore_s": run["restore_s"],
               "pull_s": run["pull_s"], "write_wait_s": run["write_wait_s"]}
        state = [run["params"], run["opt"]]
        del run
        out["peak_gb"] = peak_gb()
        out["state_bytes"] = sum(
            t.numel() * t.element_size() for t in tree_leaves(
                {"p": state[0], "mu": state[1].mu, "nu": state[1].nu})
        ) + state[1].step.numel() * state[1].step.element_size()
        out["placement_bytes"] = state_placement_bytes(cfg, mesh, rules)
        out["launches"] = kernels.diff(kernels.snapshot(), before)
        if data > 1:
            step = make_train_step(
                lambda p, b: tx.lm_loss(cfg, p, b["tokens"], b["labels"]),
                lr=3e-4, axes=tx.param_logical_axes(cfg),
                shapes=tx.param_shapes(cfg))
            batch = to_cuda(next(lm_train_batches(cfg.vocab_size, 8, 128,
                                                  seed=steps)))
            mesh.barrier()
            torch.cuda.synchronize()
            mesh.timing, mesh.collective_s = True, 0.0
            t0 = time.perf_counter()
            state[0], state[1], m = step(*state, batch)
            float(m["loss"])
            out["step_s"] = time.perf_counter() - t0
            out["collective_share"] = mesh.collective_s / out["step_s"]
            mesh.timing = False
            out["peak_gb"] = max(out["peak_gb"], peak_gb())
        del state
    free_card()
    mesh.barrier()
    return out


def train_leaves(tree, prefix=""):
    """(key, leaf) of a nested dict whose leaves are tuples (logical axes,
    shapes)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from train_leaves(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def dist_train_phase():
    """(f): the two worlds of ``dist_train_world``, then the same two CLI
    calls on one device in this process; returns every result for
    ``dist_train_rule``."""
    import shutil
    import tempfile
    from repro_torch.configs import qwen2_1_5b
    cut = dataclasses.replace(qwen2_1_5b.full_config(),
                              n_layers=TRAIN_CLI_LAYERS)
    root = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        free = shutil.disk_usage(root).free
        print(f"  [(f): Qwen2-1.5B's depth cut to {TRAIN_CLI_LAYERS} of 28 "
              f"layers (f32 parameters and both moments "
              f"{cut.n_params() * 12 / 1e9:.2f} GB); {free / 1e9:.0f} GB "
              f"free under {tempfile.gettempdir()}]")
        mesh_dir = os.path.join(root, "mesh")
        w4 = dist_spawn("dist_train_world", 4, "gloo", 2, 2,
                        TRAIN_CLI_STEPS[0], mesh_dir)
        w2 = dist_spawn("dist_train_world", 2, "gloo", 1, 2,
                        TRAIN_CLI_STEPS[1], mesh_dir)
        last = f"step_{TRAIN_CLI_STEPS[1]:010d}"
        for name in os.listdir(mesh_dir):      # keep the final one alone
            if name != last:
                shutil.rmtree(os.path.join(mesh_dir, name))
        reused = bool(ONE_DEVICE_CLI)
        one = one_device_cli()
        one_dir = one["dir"]
        print(f"  [(f)'s one-device CLI calls: "
              f"{'the train phase' + chr(39) + 's' if reused else 'run here'}]")
        one = one["runs"]
        diffs = {}
        with np.load(os.path.join(mesh_dir, last, "arrays.npz")) as a, \
                np.load(os.path.join(one_dir, last, "arrays.npz")) as b:
            check(sorted(a.files) == sorted(b.files),
                  "(f): the final checkpoints hold other keys")
            for k in sorted(b.files):
                x, y = (torch.from_numpy(z[k]).cuda().double()
                        for z in (a, b))
                d = x - y
                diffs[k] = dict(rms=d.pow(2).mean().sqrt().item(),
                                max=d.abs().max().item() if d.numel() else 0.0,
                                ref_rms=y.pow(2).mean().sqrt().item())
                del x, y, d
        return dict(w4=w4, w2=w2, one=one, diffs=diffs)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def dist_train_rule(res):
    """(f)'s checks (the rationale above DIST_TRAIN_LOSS_RTOL): every
    rank's printed losses alike and within DIST_TRAIN_LOSS_RTOL of one
    device's; each moment of the final checkpoint within an RMS
    difference of DIST_TRAIN_MOMENT_RTOL of its RMS on one device, each
    parameter within DIST_TRAIN_PARAM_FRAC x lr x steps, the step equal,
    the RMS and largest difference of each kind printed; the state bytes
    a rank equal to its ``placement`` count; no port kernel launched."""
    w4, w2, one = res["w4"], res["w2"], res["one"]
    want = {**one[0]["losses"], **one[1]["losses"]}
    for label, world in (("mesh (2, 2)", w4), ("mesh (1, 2)", w2)):
        for r, x in enumerate(world):
            check(x["losses"] == world[0]["losses"],
                  f"(f) {label} rank {r}: losses {x['losses']} differ from "
                  f"rank 0's {world[0]['losses']}")
            check(x["state_bytes"] == x["placement_bytes"],
                  f"(f) {label} rank {r}: state {x['state_bytes']} bytes, "
                  f"placement {x['placement_bytes']}")
            check(not any(x["launches"].values()),
                  f"(f) {label} rank {r}: port kernels launched "
                  f"{x['launches']}")
            timed = ""
            if "step_s" in x:
                timed = (f"; a step {x['step_s']:.2f} s, the collectives "
                         f"{x['collective_share']:.4f} of it")
            print(f"  (f) {label} rank {r}: state {x['state_bytes'] / 1e9:.4f}"
                  f" GB (= placement's {x['placement_bytes']} bytes), peak "
                  f"{x['peak_gb']:.2f} GB; CLI from step {x['start']}: "
                  f"{x['wall_s']:.1f} s (restore {x['restore_s'] or 0:.1f} s,"
                  f" last pull {x['pull_s'] or 0:.1f} s, write wait "
                  f"{x['write_wait_s']:.1f} s){timed}")
    got = {**w4[0]["losses"], **w2[0]["losses"]}
    check(sorted(got) == sorted(want), f"(f): loss steps {sorted(got)}, one "
                                       f"device {sorted(want)}")
    for k in sorted(want):
        rel = abs(got[k] - want[k]) / abs(want[k])
        print(f"  (f) loss at step {k}: mesh {got[k]:.6f}, one device "
              f"{want[k]:.6f} (relative {rel:.3e}, limit "
              f"{DIST_TRAIN_LOSS_RTOL:g})")
        check(np.isfinite(got[k]) and rel <= DIST_TRAIN_LOSS_RTOL,
              f"(f) loss at step {k}: {got[k]} against {want[k]}")
    kinds = {}
    moved = DIST_TRAIN_LR * TRAIN_CLI_STEPS[1]
    for k, d in res["diffs"].items():
        kind = {"o/1": "mu", "o/2": "nu", "o/0": "step"}.get(k[:3], "params")
        limit = (DIST_TRAIN_PARAM_FRAC * moved if kind == "params" else
                 DIST_TRAIN_MOMENT_RTOL * d["ref_rms"])
        check(d["rms"] <= limit, f"(f) checkpoint {k}: RMS difference "
                                 f"{d['rms']:.4e} over {limit:.4e}")
        worst = kinds.setdefault(kind, dict(ratio=0.0, max=0.0))
        worst["ratio"] = max(worst["ratio"],
                             d["rms"] / limit if limit else 0.0)
        worst["max"] = max(worst["max"], d["max"])
    for kind, w in kinds.items():
        print(f"  (f) final checkpoint (step {TRAIN_CLI_STEPS[1]}), "
              f"{kind}: largest RMS difference / its limit {w['ratio']:.3e}"
              f", largest |difference| {w['max']:.3e}")
    print(f"  (f) one device: CLI {one[0]['wall_s']:.1f} s + resumed "
          f"{one[1]['wall_s']:.1f} s, peak {one[0]['peak_gb']:.2f} / "
          f"{one[1]['peak_gb']:.2f} GB")
    return dict(losses=got, one_losses=want, kinds=kinds)


def moe_train_cfg():
    """(f)'s MoE: Moonlight-16B-A3B at full width (64 experts of d_ff
    1,408, top 6, two shared experts, whose products run on the residual's
    blocks under sequence parallelism), its depth cut to
    DIST_MOE_TRAIN_LAYERS, f32, the dense attention."""
    from repro_torch.configs import moonshot_v1_16b_a3b
    return dataclasses.replace(moonshot_v1_16b_a3b.full_config(),
                               n_layers=DIST_MOE_TRAIN_LAYERS,
                               prefill_backend="dense")


def state_placement_bytes(cfg, mesh, rules):
    """The f32 parameters' and both moments' bytes a rank holds under
    ``placement`` (the whole count without a mesh), and the step's 4."""
    from repro_torch.distributed.sharding import placement
    from repro_torch.models import transformer as tx
    axes = dict(train_leaves(tx.param_logical_axes(cfg)))
    shapes = dict(train_leaves(tx.param_shapes(cfg)))
    return 3 * sum(
        4 * int(np.prod(shapes[k] if mesh is None else placement(
            mesh, axes[k], shapes[k], rules).shard_shape(shapes[k])))
        for k in axes) + 4


def moe_train_steps(cfg, mesh=None):
    """DIST_MOE_TRAIN_STEPS train steps of ``cfg`` (lr 3e-4) from seed 0's
    parameters (this rank's blocks under the active mesh, whose MoE runs
    ``moe_ep``; ``moe_ref`` without one) on ``lm_train_batches`` of
    DIST_MOE_TRAIN_BATCH: each step's loss, grad_norm and seconds (from a
    barrier to its loss on the host; the last with the collectives timed),
    the rows ``moe_local`` dropped on this rank (``moe_local.dropped``),
    the state bytes and the peak."""
    from repro_torch.models import moe
    from repro_torch.models import transformer as tx
    from repro_torch.models.params import init_params
    from repro_torch.training.data import lm_train_batches
    from repro_torch.training.optimizer import adamw_init
    from repro_torch.training.train_step import make_train_step
    free_card()
    params = init_params(cfg, seed=0, device="cuda", mesh=mesh)
    opt = adamw_init(params)
    step = make_train_step(
        lambda p, b: tx.lm_loss(cfg, p, b["tokens"], b["labels"]),
        lr=DIST_TRAIN_LR, axes=tx.param_logical_axes(cfg),
        shapes=tx.param_shapes(cfg))
    batches = lm_train_batches(cfg.vocab_size, *DIST_MOE_TRAIN_BATCH, seed=0)
    out = {"losses": [], "norms": [], "step_s": []}
    moe.moe_local.dropped = drops = []
    try:
        for i in range(DIST_MOE_TRAIN_STEPS):
            batch = to_cuda(next(batches))
            if mesh is not None:
                mesh.barrier()
                mesh.timing = i == DIST_MOE_TRAIN_STEPS - 1
                mesh.collective_s = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            out["losses"].append(float(m["loss"]))
            out["step_s"].append(time.perf_counter() - t0)
            out["norms"].append(float(m["grad_norm"]))
        if mesh is not None:
            out["collective_share"] = mesh.collective_s / out["step_s"][-1]
            mesh.timing = False
    finally:
        moe.moe_local.dropped = None
    out["dropped"] = int(sum(int(d) for d in drops))
    out["state_bytes"] = sum(
        t.numel() * t.element_size() for t in tree_leaves(
            {"p": params, "mu": opt.mu, "nu": opt.nu})) + 4
    out["peak_gb"] = peak_gb()
    del params, opt
    free_card()
    return out


def dist_moe_train_world(rank):
    """(f)'s MoE world: 4 gloo ranks on cuda:0, mesh (data 2, model 2),
    the train_4k rules (FSDP, TP, the residual split along the sequence
    over ``model``, ``moe_ep`` on the reference's token groups), each
    capacity factor's ``moe_train_steps``: E / top_k, where nothing drops,
    then the arch's 1.25."""
    from repro_torch import kernels
    from repro_torch.distributed.sharding import DEFAULT_RULES, sharding_ctx
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as tx
    mesh = make_host_mesh(data=2, model=2, device="cuda:0")
    rules = DEFAULT_RULES.override(residual_seq=("model",))
    cfg = moe_train_cfg()
    before = kernels.snapshot()
    out = {}
    with sharding_ctx(mesh, rules):
        for cf in (no_drop_cf(cfg), cfg.capacity_factor):
            out[cf] = moe_train_steps(dataclasses.replace(
                cfg, capacity_factor=cf), mesh)
        lay = tx.Layout(cfg, DIST_MOE_TRAIN_BATCH[0],
                        seq=DIST_MOE_TRAIN_BATCH[1])
        out["split"] = (lay.lane_axes, lay.seq_axes, lay.ffn_axes)
        out["placement_bytes"] = state_placement_bytes(cfg, mesh, rules)
    out["launches"] = kernels.diff(kernels.snapshot(), before)
    mesh.barrier()
    return out


def dist_moe_train_phase():
    """(f)'s MoE: ``dist_moe_train_world``, then the same steps at E /
    top_k on one device in this process (``moe_ref``); returns both for
    ``dist_moe_train_rule``."""
    cfg = moe_train_cfg()
    print(f"  [(f) MoE: Moonlight-16B-A3B's depth cut to "
          f"{DIST_MOE_TRAIN_LAYERS} of 48 layers, f32, batch "
          f"{DIST_MOE_TRAIN_BATCH} (parameters and both moments "
          f"{cfg.n_params() * 12 / 1e9:.2f} GB whole)]")
    res = dist_spawn("dist_moe_train_world", 4, "gloo")
    one = moe_train_steps(dataclasses.replace(
        cfg, capacity_factor=no_drop_cf(cfg)))
    return dict(mesh=res, one=one)


def dist_moe_train_rule(res):
    """(f)'s MoE checks: every rank's losses alike at both capacity
    factors; at E / top_k no row dropped and each step's loss and
    grad_norm within DIST_TRAIN_LOSS_RTOL of one device's (``moe_ref``: the
    same function, its sums in another order); the state bytes a rank
    equal to its
    ``placement`` count; no port kernel launched.  Prints the rows dropped
    at 1.25 (the reference's token groups decide which), each step's
    seconds, the collectives' share, the state and the peak a rank."""
    ranks, one = res["mesh"], res["one"]
    cfg = moe_train_cfg()
    nd, cf = no_drop_cf(cfg), cfg.capacity_factor
    print(f"  (f) MoE split (lanes, sequence, shared experts' products): "
          f"{ranks[0]['split']}")
    for r, x in enumerate(ranks):
        for c in (nd, cf):
            check(x[c]["losses"] == ranks[0][c]["losses"],
                  f"(f) MoE rank {r} cf {c:g}: losses {x[c]['losses']} "
                  f"differ from rank 0's {ranks[0][c]['losses']}")
            check(x[c]["state_bytes"] == x["placement_bytes"],
                  f"(f) MoE rank {r}: state {x[c]['state_bytes']} bytes, "
                  f"placement {x['placement_bytes']}")
            print(f"  (f) MoE rank {r} cf {c:g}: steps "
                  f"{[round(t, 3) for t in x[c]['step_s']]} s (collectives "
                  f"{x[c]['collective_share']:.4f} of the last), rows "
                  f"dropped {x[c]['dropped']}, state "
                  f"{x[c]['state_bytes'] / 1e9:.4f} GB (= placement's), "
                  f"peak {x[c]['peak_gb']:.2f} GB")
        check(x[nd]["dropped"] == 0,
              f"(f) MoE rank {r}: {x[nd]['dropped']} rows dropped at cf "
              f"{nd:g}")
        check(not any(x["launches"].values()),
              f"(f) MoE rank {r}: port kernels launched {x['launches']}")
    got = ranks[0][nd]["losses"]
    for key, what in (("losses", "loss"), ("norms", "grad_norm")):
        for i, (a, b) in enumerate(zip(ranks[0][nd][key], one[key])):
            rel = abs(a - b) / abs(b)
            print(f"  (f) MoE {what} at step {i + 1}, cf {nd:g}: mesh "
                  f"{a:.6f}, one device (moe_ref) {b:.6f} (relative "
                  f"{rel:.3e}, limit {DIST_TRAIN_LOSS_RTOL:g})")
            check(np.isfinite(a) and rel <= DIST_TRAIN_LOSS_RTOL,
                  f"(f) MoE {what} at step {i + 1}: {a} against {b}")
    dropped = sum(x[cf]["dropped"] for x in ranks)
    print(f"  (f) MoE cf {cf:g}: {dropped} rows dropped over the ranks in "
          f"{DIST_MOE_TRAIN_STEPS} steps, losses {ranks[0][cf]['losses']}; "
          f"one device: steps {[round(t, 3) for t in one['step_s']]} s, "
          f"state {one['state_bytes'] / 1e9:.4f} GB, peak "
          f"{one['peak_gb']:.2f} GB")
    return dict(losses=got, one_losses=one["losses"],
                norms=ranks[0][nd]["norms"], one_norms=one["norms"],
                dropped=dropped, cf_losses=ranks[0][cf]["losses"])


def moe_world_rule(w2, w1, ref, what):
    """World 2's no-drop step against world 1's ``moe_local`` at the same
    capacity factor, in bf16: the RMS difference of the prefill's and the
    step's logits at most BF16_LOGIT_RATIO times ``moe_ref``'s from that
    same ``moe_local`` (two orders of the same sums), and the packed
    result equal, or each differing choice a near tie: its top-two gap in
    both steps under 2 x BF16_LOGIT_RATIO times the largest difference of
    ``moe_ref``'s and ``moe_local``'s logits in that row (a choice can
    flip only where both gaps are under twice the largest difference of
    the two rows)."""
    def rms(a):
        return a.pow(2).mean().sqrt().item()

    out = {}
    for name, label in (("first", "prefill"), ("logits", "step")):
        e, e_ref = rms(w2[name] - w1[name]), rms(ref[name] - w1[name])
        out[name] = dict(rms=e, ref_rms=e_ref,
                         max_abs=(w2[name] - w1[name]).abs().max().item(),
                         bits=torch.equal(w2[name], w1[name]))
        print(f"  {what} {label} logits vs world 1 moe_local: RMS diff "
              f"{e:.4e} (bit-equal {out[name]['bits']}), max |diff| "
              f"{out[name]['max_abs']:.4e}; moe_ref vs moe_local RMS "
              f"{e_ref:.4e}; limit {BF16_LOGIT_RATIO * e_ref:.4e}")
        check(bool(torch.isfinite(w2[name]).all())
              and e <= BF16_LOGIT_RATIO * e_ref,
              f"{what}: {label} logits {e} from moe_local, over "
              f"{BF16_LOGIT_RATIO} x {e_ref}")
    a, b, c = w2["logits"], w1["logits"], ref["logits"]
    ca, cb = a.argmax(-1), b.argmax(-1)
    diff = (ca != cb).nonzero().tolist()
    for bi, t in diff:
        gaps = [torch.topk(lg[bi, t], 2).values for lg in (a, b)]
        gaps = [float(g[0] - g[1]) for g in gaps]
        near = 2 * BF16_LOGIT_RATIO * (c[bi, t] - b[bi, t]).abs().max().item()
        print(f"  {what} lane {bi} slot {t}: chooses {int(ca[bi, t])}, "
              f"world 1 {int(cb[bi, t])}; top-two gaps {gaps[0]:.4e} / "
              f"{gaps[1]:.4e} against {near:.4e}; max |diff| of the rows "
              f"{(a[bi, t] - b[bi, t]).abs().max().item():.4e}")
        check(max(gaps) < near, f"{what} lane {bi} slot {t}: not a near tie")
    same = torch.equal(w2["packed"], w1["packed"])
    check(same or bool(diff), f"{what}: packed differs with equal choices")
    print(f"  {what} packed result = world 1 moe_local's: {same} "
          f"({len(diff)} differing choices of {ca.numel()})")
    out["packed_equal"] = same
    return out


def dist_phase(card):
    """``--phases dist``: the multi-rank paths (ROADMAP A16, A16b) on the
    one card, each world's ranks spawned on cuda:0.  Returns the kernels'
    launches on the worlds' paths."""
    launches = {}

    def count(res):
        for r in res:
            for name, n in r["launches"].items():
                launches[name] = launches.get(name, 0) + n

    print(f"  card and power limit: {card}")
    print(f"  [Qwen3-MoE in (b) and (c): depth cut to {DIST_MOE_LAYERS} of "
          f"48 layers; (c)'s serve-rules step to {DIST_MOE_TP_LAYERS}]")
    res = dist_spawn("dist_long", 2, "gloo")
    count(res)
    print(f"  gloo on CUDA tensors (raw, torch {torch.__version__}): "
          f"{res[0]['probe']}")
    r0 = res[0]
    for r, x in enumerate(res):
        print(f"  long_500k flash decode, rank {r}: cache block {x['block']}"
              f", fused step {x['ms']:.2f} ms (steps "
              f"{[round(t, 2) for t in x['steps']]}), collectives "
              f"{x['collective_share']:.4f} of a timed step, peak "
              f"{x['peak_gb']:.2f} GB")
    print(f"  long_500k single-device B1 fused step: {r0['b1_ms']:.2f} ms "
          f"(rank 0 alone on the card)")
    check(torch.equal(res[0]["packed"], res[1]["packed"]) and torch.equal(
        res[0]["logits"], res[1]["logits"]), "the ranks' outputs differ")
    rule = long_rule("flash decode", r0["logits"], r0["d16"], r0["ref"],
                     r0["logits"].shape[-1])
    rule.update(long_rule("B1", r0["b1"], r0["d16"], r0["ref"],
                          r0["logits"].shape[-1]))
    near = max(rule["logit_rms_err_flash_decode"], rule["logit_rms_err_b1"])
    got, want = r0["packed"], r0["b1_packed"]
    if not torch.equal(got, want):
        ch_f, ch_b = r0["logits"].argmax(-1), r0["b1"].argmax(-1)
        for t in (ch_f != ch_b).nonzero()[:, 1].tolist():
            gaps = [torch.topk(lg[0, t], 2).values for lg in (r0["logits"],
                                                              r0["b1"])]
            gaps = [float(g[0] - g[1]) for g in gaps]
            print(f"  slot {t}: flash chooses {int(ch_f[0, t])}, B1 "
                  f"{int(ch_b[0, t])}; top-two gaps {gaps[0]:.4e} / "
                  f"{gaps[1]:.4e} against the logit error {near:.4e}")
            check(max(gaps) < near, f"slot {t}: not a near tie")
    print(f"  long_500k packed result flash = B1: {torch.equal(got, want)} "
          f"(n_acc {int(got[0, 0])})")
    res = dist_spawn("dist_moe_nccl", 1, "nccl")
    count(res)
    w1 = res[0]
    res = dist_spawn("dist_moe_gloo", 2, "gloo")
    count(res)
    for N in DIST_MOE_NS:
        print(f"  moe_ep (E 128, top 8, d 2048, F 768, cf {DIST_MOE_CF}) N "
              f"{N} over 2 ranks: max|err| per half "
              f"{[x['layer'][N]['max_abs_err'] for x in res]} ({MOE_TOL}); "
              f"{res[0]['layer'][N]['ep_ms']:.3f} ms a call, moe_local of "
              f"all {N} rows in one process "
              f"{res[0]['layer'][N]['local_ms']:.3f}")
    check(torch.equal(res[0]["packed"], res[1]["packed"]) and torch.equal(
        res[0]["nodrop"]["packed"], res[1]["nodrop"]["packed"]),
          "the ranks' MoE steps differ")
    for r, x in enumerate(res):
        print(f"  Qwen3-MoE world 2, rank {r}: fused step {x['ms']:.2f} ms "
              f"(steps {[round(t, 2) for t in x['steps']]}), collectives "
              f"{x['collective_share']:.4f} of a timed step, "
              f"peak {x['peak_gb']:.2f} GB")
    moe_world_rule(res[0]["nodrop"], w1["local16"], w1["ref"],
                   f"Qwen3-MoE world 2 at cf {no_drop_cf(moe_full_config('ep')):g}")
    agree = (res[0]["logits"].argmax(-1) == w1["logits"].argmax(-1)
             ).float().mean().item()
    diff = (res[0]["logits"] - w1["logits"]).abs().max().item()
    print(f"  Qwen3-MoE world 2 against world 1 at cf {DIST_MOE_CF} "
          f"(capacity drops differ with the token split: printed, the "
          f"no-drop run above is the gate): choices equal at {agree:.4f} of "
          f"the slots, max |logit diff| {diff:.4e}; the ranks' peaks sum to "
          f"{sum(x['peak_gb'] for x in res):.2f} GB")
    moe_tp_rule(res)
    res = dist_spawn("dist_tp_serve", 2, "gloo")
    count(res)
    dist_tp_rule(f"(d) Qwen2-1.5B cut to {DIST_TP_D_LAYERS} of 28 layers, "
                 "mesh (data 1, model 2), serve rules", res)
    res = dist_spawn("dist_tp_fsdp", 4, "gloo")
    count(res)
    dist_tp_rule(f"(e) Qwen2-1.5B cut to {DIST_TP_E_LAYERS} of 28 layers, "
                 "mesh (data 2, model 2), DEFAULT_RULES", res)
    res = dist_train_phase()
    count(res["w4"] + res["w2"])
    dist_train_rule(res)
    res = dist_moe_train_phase()
    count(res["mesh"])
    dist_moe_train_rule(res)
    for res in dist_heads_phase().values():
        count(res)
    res = dist_spawn("dist_recsys_world", 4, "gloo")
    count(res)
    dist_recsys_rule(res)
    res = dist_spawn("dist_gnn_world", 4, "gloo")
    count(res)
    dist_gnn_rule(res)
    return launches


def gnn_controls_main():
    """``--gnn-controls``: world (i) as the dist phase runs it, then again
    under ``gnn_control``, each reported; no result line."""
    t0 = time.perf_counter()
    dist_gnn_rule(dist_spawn("dist_gnn_world", 4, "gloo"))
    print(f"(i) {time.perf_counter() - t0:.1f} s")
    gnn_control_report(dist_spawn("dist_gnn_world", 4, "gloo", True))
    return 0


PHASES = ("kernels", "model", "recsys", "dense", "paged", "invariance",
          "sampled", "overlap", "graphs", "fleet", "sanitize", "long_prompt",
          "archs", "moe", "train", "gnn", "cost", "dist")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="chip_smoke.py")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of the phases to run "
                         f"(default: all of {', '.join(PHASES)}); the last "
                         "line's ok needs all of them")
    ap.add_argument("--gnn-controls", action="store_true",
                    help="run only world (i) of the dist phase, then (i) "
                         "again with a node-side weight's gradient summed "
                         "over model too and the repeat cell's sums in the "
                         "atomics' order, and print what its checks see "
                         "there; no result line")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import _build
    except ImportError as exc:
        print(f"chip_smoke: the port is not importable ({exc}); run from "
              "the repository root", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(smi[0])
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if args.gnn_controls:
        return gnn_controls_main()

    t0 = time.perf_counter()
    _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(sorted(_build.SOURCES))})")
    t0 = time.perf_counter()
    sass_phase(_build)
    print(f"  [sass: {time.perf_counter() - t0:.1f} s]")
    # torch.profiler's first window in a process leaves a reference cycle
    # that holds its caller's frames: open it here, not under a phase whose
    # sessions it would keep on the card until the cycle collector runs
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    errs, rows, launches = {}, {}, {}
    t_phase = [time.perf_counter()]

    def phase_done(name):
        now = time.perf_counter()
        print(f"  [{name}: {now - t_phase[0]:.1f} s]")
        t_phase[0] = now

    if "kernels" in phases:
        print("kernels:")
        errs, rows = kernel_phase(gen)
        (errs["flash_prefill_tri"], rows["flash_prefill_tri"],
         launches["flash_prefill_tri"]) = tri_phase(gen)
        # B3 at the long prompt, timed in turns with B4 there
        lp = rows["flash_prefill_tri"]["long_prompt"]
        rows["flash_prefill"]["long_prompt"] = dict(
            shape=lp["shape"], ms=lp["flash_prefill_ms"],
            device_ms=lp["flash_prefill_device_ms"], plain_ms=lp["plain_ms"],
            library_ms=lp["library_ms"],
            library_device_ms=lp["library_device_ms"],
            bound_ms=lp["bound_ms"], bound_by=lp["bound_by"])
        errs["gumbel_argmax"], rows["gumbel_argmax"] = gumbel_phase(gen)
        embedding_bag_phase(gen)
        phase_done("kernels")
    if "model" in phases:
        print("model, full width, 2 layers:")
        model_phase()
        phase_done("model")
    if "recsys" in phases:
        print("recsys scoring, full width, f32:")
        (errs["embedding_bag"], rows["embedding_bag"],
         launches["embedding_bag"]) = recsys_phase(gen)
        phase_done("recsys")
    cfg = params = prompts = outs = None
    if set(phases) & {"dense", "paged", "invariance", "sampled", "overlap",
                      "graphs", "fleet", "sanitize", "long_prompt"}:
        cfg, params = path_model()
    if set(phases) & {"dense", "paged", "overlap"}:
        print("main path, dense layout:")
        dense, prompts, outs = path_phase(cfg, params)
        launches.update(dense)
        phase_done("dense")
    if "paged" in phases:
        print("main path, paged layout and prefix cache:")
        paged = paged_phase(cfg, params, prompts, outs)
        launches["paged_tree_attention"] = paged["paged_tree_attention"]
        phase_done("paged")
    if "invariance" in phases:
        print("batch-shape invariance of the logits (findings) and of the "
              "suffix prefill (a check):")
        invariance_phase(cfg, params)
        phase_done("invariance")
    if "sampled" in phases:
        print("sampled and mixed serving, unguided:")
        launches["gumbel_argmax"] = sampled_phase(cfg, params)
        phase_done("sampled")
    if "overlap" in phases:
        print("overlap_drafts on the guided dense path:")
        overlap_phase(cfg, params, prompts, outs)
        phase_done("overlap")
    if "graphs" in phases:
        print("CUDA graphs: captured members against their eager twin:")
        graphs_phase(cfg, params)
        phase_done("graphs")
    if "fleet" in phases:
        print("fleet serving and warm draft state:")
        fleet_phase(cfg, params)
        phase_done("fleet")
    if "sanitize" in phases:
        print("the runtime sanitizer on captured members:")
        sanitize_phase(cfg, params)
        phase_done("sanitize")
    if "long_prompt" in phases:
        print(f"long prompt, dense layout, prefill_len {LONG_PREFILL}:")
        long_prompt_phase(cfg, params)
        phase_done("long_prompt")
    del cfg, params
    for phase, names, what in (
            ("archs", OTHER_ARCHS, "the other dense LMs"),
            ("moe", MOE_ARCHS, "the MoE LMs")):
        if phase not in phases:
            continue
        print(f"{what} at full width, bf16, depth cut to 1/{ARCH_DEPTH_DIV}:")
        for name, arch in archs_phase(names).items():
            for kern, n in (
                    ("tree_attention", arch["dense"]["launches"]
                     ["tree_attention"]),
                    ("paged_tree_attention", arch["paged"]["launches"]
                     ["paged_tree_attention"]),
                    ("flash_prefill",
                     arch["dense"]["launches"]["flash_prefill"]
                     + arch["paged"]["launches"]["flash_prefill"])):
                if name in rows.get(kern, {}).get("archs", {}):
                    rows[kern]["archs"][name]["launches"] = n
        phase_done(phase)

    if "train" in phases:
        print("training at full width:")
        launches["embedding_bag"] = (launches.get("embedding_bag", 0)
                                     + train_phase())
        phase_done("train")
    if "gnn" in phases:
        print("EquiformerV2 (GNN) at full width, bf16:")
        gnn_phase(smi[0])
        phase_done("gnn")
    if "cost" in phases:
        print("the dry-run's roofline against measured cells:")
        for name, n in cost_phase(smi[0]).items():
            launches[name] = launches.get(name, 0) + n
        phase_done("cost")
    if "dist" in phases:
        print("multi-rank paths (flash decode, moe_ep, sharded argmax, the "
              "dense LM's placement, the train step under a mesh, an MoE "
              "under SP, query heads off one KV head) on the one card:")
        for name, n in dist_phase(smi[0]).items():
            launches[name] = launches.get(name, 0) + n
        phase_done("dist")

    src = {"tree_attention": (
               "src/repro_torch/kernels/tree_attention/csrc/tree_attention.cu",
               "src/repro/kernels/tree_attention/tree_attention.py:31"),
           "paged_tree_attention": (
               "src/repro_torch/kernels/tree_attention/csrc/"
               "paged_tree_attention.cu",
               "src/repro/kernels/tree_attention/paged.py:31"),
           "flash_prefill": (
               "src/repro_torch/kernels/flash_prefill/csrc/flash_prefill.cu",
               "src/repro/kernels/flash_prefill/flash_prefill.py:24"),
           "flash_prefill_tri": (
               "src/repro_torch/kernels/flash_prefill/csrc/"
               "flash_prefill_tri.cu",
               "src/repro/kernels/flash_prefill/flash_prefill.py:110"),
           "gumbel_argmax": (
               "src/repro_torch/kernels/gumbel_argmax/csrc/gumbel_argmax.cu",
               "src/repro/serving/sampler.py:82"),
           "embedding_bag": (
               "src/repro_torch/kernels/embedding_bag/csrc/embedding_bag.cu",
               "src/repro/kernels/embedding_bag/embedding_bag.py:20")}
    print(f"total {time.perf_counter() - t_start:.1f} s")
    if phases != list(PHASES):
        print(f"partial run ({', '.join(phases)}): no result line")
        return 0
    table = [dict(name=n, route="cuda", source=src[n][0], replaces=src[n][1],
                  launches=launches[n], max_abs_err=errs[n], **rows[n])
             for n in src]
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeError, RuntimeError, ValueError, subprocess.SubprocessError,
            OSError) as exc:
        print(f"chip_smoke: FAILED: {type(exc).__name__}: {exc}",
              file=sys.stderr)
        sys.exit(1)
