#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failing phase raises and the script
exits non-zero; nothing is caught):

1. device   - ``nvidia-smi`` name and power limit (also printed raw, as
              nvidia-smi gives it), torch and CUDA versions.
2. build    - nvcc builds every kernel source of the port at once
              (sm_90a), seconds taken and ptxas' register and spill lines
              per source. flash_attention.cu, flash_attention_bwd.cu,
              decode_attention.cu, rwkv6_scan.cu, rglru_scan.cu and
              auction_phase.cu are rebuilt
              on every run, so their ptxas reports are always read; fails if
              any instance of any of them spills (or a report is missing).
3. kernels  - each kernel against its plain PyTorch version on the card at
              the main path's shapes (exact equality required: tolerance
              0, index mismatches 0; boundary latencies and bid rows with
              planted ties across chunk boundaries), and times: kernel and
              plain version per call by CUDA events (median of 21 runs of 10
              calls, host overhead included), the kernels' own time on the
              card from a torch.profiler trace, and the bound. The
              persistent auction phase is held to the step-wise loop
              (the host loop around the bid kernel) on the round phase's
              full-width instance (1,024 tasks, 12,500 machines), on a
              1,536-task round (the replay's largest bucket, 2,048 padded
              rows), on an 8-task round of the same width and on a price war
              (identical rows in exact mode): price, owner, assignment,
              iterations and bidder rows bit-equal to the loop on the same
              card tensors and to the loop on CPU copies (there the bid is
              its plain PyTorch version, not auction_bid.cu); per solve the
              kernel's ms (events) and device ms (profiler), the loop's ms on
              the card, iterations, us per iteration and the bidder rows
              summed over the iterations. The bound reads each row that
              bids from memory once (the active rows; a re-read of a row
              may hit the L2 and is not charged) and the slot tables once,
              against the bid's BID_OPS operations on every bidder row at
              the f32 rate. Beside it latency_ms: iterations x 2 grid
              barriers, a barrier's cost measured in this run as half the
              device time of an iteration of a price war at 64 machines on
              the same full grid.
4. round    - one full-width round (12,500 machines, 1,024 tasks): the
              cost build on the card against the numpy host reference,
              every field bit-equal. Then the migration path's pieces at
              full width: a window of 4 rounds through `place_window`,
              exogenous slots bit-equal to 4 sequential `auction` `place`
              calls and chained slots to the same calls with the host's
              slot accounting between them (4 costmap and 4 auction_phase
              launches a window); 5 what-if lanes (beta in {0, 100/3600}
              x every / every other mover, and every mover frozen), each
              bit-equal to the lane solved alone and, unmasked, to `place`
              under its params (5 launches of each kernel); the device
              latency oracle's rows for 300 roots bit-equal to the host's
              on a drifting-hotspot and regime-shift plane, at a regime
              boundary and across hotspot steps. Times (host clock, each
              call ending in a read back): the window against the 4
              sequential calls, with the window's host staging and device
              part and the calls' cost builds beside it; the 5 lanes
              against one; the oracle's rows against numpy
              `latency_rows`, and one host decomposition of a root.
5. parity   - a 1,536-machine, 60 s replay with preemption and a machine
              failure on the card and on the CPU: every SimMetrics series
              and summary() equal.
6. full     - the paper's §6 Google cluster, 12,500 machines, 90 s of the
              synthetic workload on the card: rounds, tasks, auction
              iterations, kernel launches (costmap > 0, auction_phase once
              per solve with tasks, auction_bid 0: the bid runs inside the
              phase kernel), wall time, per-round algo_s (p50, p99, max),
              the solver.auction and sim.build_state seconds, us per auction
              iteration, the slowest solves (ms, tasks, padded tasks,
              iterations), peak device memory, the card's busy share over
              the slowest solve (run again: its median host wall time,
              then its device time under torch.profiler), and the
              avg_app_perf_area next to the random baseline's on the same
              workload (paper Fig. 5).
6b. dynamic_parity - the migration controller (device latency oracle,
              what-if lanes, `benchmarks/migration_quality.py`'s settings)
              on the drifting_hotspot scenario, 1,536 machines, 60 s, on
              the card and on the CPU: every SimMetrics series (the
              controller's included), summary(), the counters and the
              controller's audit events equal; then `auction_windowed` with
              the oracle and plain migration rounds on the card equal to
              the `auction` backend with host rows.
6c. dynamic - the §6 Google cluster (12,500 machines), 120 s of the
              synthetic workload at utilisation 0.6 on the drifting_hotspot
              plane, with measured algo_s, twice, both through
              `auction_windowed` and the oracle: ON (the controller, as in
              6b) and OFF (PolicyParams(p_m=105, p_r=110), no controller).
              Each: rounds, controller rounds, lanes, migrations, reverts,
              iterations, launches (auction_phase and costmap once per
              window round and per lane, auction_bid 0), wall, algo_s p50 /
              p99 / max, sim.build_state beside the full phase's, the
              what-if calls' time, the oracle's stats (fails unless its
              floats per round are below M), peak device memory and
              avg_app_perf_area. Fails if ON ran no controller round.
6d. mcmf_parity - the paper's Quincy flow network solved by successive
              shortest paths (`MCMFBackend`, its Bellman-Ford as int32 torch
              scatters on the card), 384 machines in the Google layout (8
              racks of 48), 60 s, NoMora with preemption and migration every
              30 s, fixed_algo_s = 0, on the card and on the CPU: every
              SimMetrics series and summary() equal. Rounds, augmenting
              paths, Bellman-Ford iterations, host syncs, solver.mcmf
              seconds a round.
6e. mcmf_round - one round of the full cluster (12,500 machines, the round
              phase's synthetic state at 64 tasks) through the Quincy graph
              and MCMF on the card and through the exact auction without
              tie jitter: equal objectives, no machine over its free slots.
              Nodes, arcs, graph-build seconds (host), augmentations,
              iterations, solve seconds.
6f. trace   - (a) a `synth_trace` cursor (3,600 s windows) at 1,536
              machines, 60 s, with streaming metrics on the card and on the
              CPU: summaries equal; the cursor with full SimMetrics equal to
              `materialize(cursor)` on the card. (b) the committed Google
              cluster-data v2 fixture through `CsvTraceCursor`, card against
              CPU. (c) the `google_trace` scenario on the 12,500-machine
              cluster, 90 s, measured algo_s: wall, sim.build_state, algo_s
              p50 / p99 from the streaming quantiles, launches, peak device
              memory and the host's ru_maxrss.
6g. serving - (a) the `smoke` serving preset on the card with 8 rounds
              recorded: `verify_replay` 0 mismatches and no kernel built or
              loaded after warm-up; (b) a `ScheduleService` at 12,500
              machines in the Google layout through `auction_windowed` and
              the device latency oracle, 512-task batches, 60 s of arrivals
              at 2 jobs/s (halved once if the queue does not drain): decision
              latency p50 / p99 / mean (wall clock, measured, never
              compared), round wall p50 / p99, busy fraction, queue peak,
              and 0 builds or loads after warm-up (held).
6h. sweep   - a 2-policy (nomora:auction, random) x 2-seed grid at 384
              machines, 60 s, on the card: `run_sweep(workers=2)` (a spawn
              pool, CUDA in each worker) and shards (0, 2) + (1, 2) merged
              equal to one process's run, wall-clock fields dropped.
7. attention_kernels - flash_attention and decode_attention against their
              plain versions on the card at the qwen3-0.6b serving shapes,
              in the dtypes the serving path gives them (f32 prefill;
              f32 query against a bf16 cache in decode) and with bf16
              inputs, then both at head_dim 42 (a small shape: flash
              zero-pads it, decode takes its element path); tolerance 2e-5
              abs/rel when every input is f32 (as
              tests/test_kernels_attention.py: the sums run in another
              order), 2e-2 with bf16 inputs (one bf16 rounding of the
              output). Times as in phase 3, plus library_ms: one
              torch.nn.functional.scaled_dot_product_attention call on the
              same inputs (a yardstick only; the port never calls it).
              Flash's bound_ms with f32 inputs is that of f32-accurate
              products on the tensor cores (3 TF32 passes at 495
              TFLOP/s), with bf16 inputs the bf16 tensor cores' (989
              TFLOP/s); beside it, cuda_core_bound_ms (the bound of the
              kernel's earlier design, f32 CUDA cores at 67 TFLOP/s for
              f32 inputs) and tf32_passes (the TF32 passes per operation
              the kernel takes: 3 for f32 inputs, 1.5 for bf16). Decode
              rows also give device_ms_cold: the kernel's device time with
              the L2 flushed before each call (a 128 MB buffer zeroed and
              read back inside the timed call; neither is counted), as a
              decode step finds the cache after the other layers' weights.
              Then decode's log-sum-exp output (``return_lse``, the
              statistic that merges a sequence-sharded cache across model
              ranks) at qwen3-0.6b's and recurrentgemma-2b's serving
              shapes cut into two position shards (some rows' second shard
              empty: zero output, -inf): output and log-sum-exp against
              the plain version's within 2e-5, the two shards merged
              against the plain version over the whole cache; call and
              device ms with it, call ms without, bound, plain ms.
8. serve    - qwen3-0.6b at full width (28 layers, reduce 1), seeded
              float32 parameters and a bf16 cache: 8 requests of 1,024
              prompt tokens, 64 generated (s_max 1,088), through
              ``serve_batch`` on the card. Prefill seconds, decode ms per
              step, tokens/s, peak device memory; launches must be exactly
              28 flash and 28 * 63 decode. The kernels are checked again
              against their plain versions on layer-0 tensors captured
              from this run. The decode profile gives the device time per
              step and decode_attention's device ms per call in it.
9. serve_parity - the same path at reduce 8 with GQA restored (4 query
              heads over 2 KV heads), 2 requests, 64-token prompts, 16
              generated, the same parameters on the card and on the CPU:
              logits within 2e-3 abs/rel at every step (f32 products summed
              in another order; a K/V value may round to the neighbouring
              bf16 step) and the greedy tokens equal.
10. recurrent_kernels - rglru_scan and rwkv6_scan against their plain
              versions on the card: the RG-LRU at recurrentgemma-2b's
              prefill shape (8, 2048, 2560) f32 and at a ragged one with a
              given state, each row with bit_equal (states and final state
              equal to the plain version's bit for bit); RWKV-6 at rwkv6-7b's prefill shape (8, 64, 1024,
              64) f32, at T = 1 with the state given and updated in place
              (its decode step), at a ragged (3, 64, 1000, 64) with a given
              state, and at the prefill shape with the model's decays (w =
              exp(-exp(raw)), raw ~ N(0, 2)) and with r, k, v, w laid out
              as the rwkv block passes them (heads split out of (B, T, H N)
              projections); tolerance 1e-5 (RG-LRU) and 1e-4 (RWKV-6)
              abs/rel, as tests/test_kernels_scans.py. Flash attention at
              recurrentgemma-2b's prefill, (8, 10 / 1, 2048, 256) f32 causal,
              and decode attention at its decode, G = 10, head_dim 256, f32
              query against a bf16 ring cache of 2,048, tolerance 2e-5.
              Times and flash's two bounds as in phase 7; library_ms null
              for the scans (no single PyTorch call computes either
              recurrence).
11. serve_recurrentgemma - recurrentgemma-2b at full width (26 layers,
              d_model 2,560, MQA 10 / 1 heads of 256, window 2,048, V
              256,000), seeded f32 parameters, bf16 K/V and conv history:
              8 requests of 2,048 prompt tokens (the window, exactly), 64
              generated (s_max 2,112: every decode step writes across the
              ring's wrap). Launches exactly 18 rglru_scan, 8 flash and
              8 * 63 decode; measures and checks as phase 8.
12. serve_rwkv - rwkv6-7b at full width (32 layers, d_model 4,096, 64 heads
              of 64, d_ff 14,336, V 65,536), seeded f32 parameters: 8 x
              (1,024 + 64) tokens; launches exactly 32 + 32 * 63 rwkv6_scan.
13. recurrent_parity - each of the two at reduce 8, card against CPU on the
              same parameters, 2 requests, 16 generated (recurrentgemma
              from 160-token prompts, longer than its reduced window of 128,
              so its chunk-pair attention and ring wrap run; rwkv6 from 64):
              greedily with a float32 cache, logits within 2e-3 abs/rel at
              every step and the tokens equal; then ``serve_batch`` with its
              bf16 cache, whose logit difference and token equality are
              reported, not held (a value one f32 bit apart may round to
              the neighbouring bf16 step, and the recurrent states carry
              such steps on: rwkv6 re-rounds whole activation rows, its
              token shifts, at every step).
13b. serve_dbrx, serve_llama4, serve_vlm - dbrx-132b (d_model 6,144, 48 / 8
              heads of 128, 16 experts top-4 of d_ff 10,752, V 100,352),
              llama4-scout-17b-a16e (5,120, 40 / 8, 16 experts top-1 and a
              shared expert of d_ff 8,192, V 202,048) and
              llama-3.2-vision-11b (4,096, 32 / 8, d_ff 14,336, V 128,256,
              1,601 image tokens) at full width, depth cut: 2 MoE layers
              each, and two (dense x 3, cross, dense) superblocks. Seeded
              f32 parameters (the cross gates set to +-U(0.5, 1)), 8
              requests of 1,024 prompt tokens, 64 generated greedily: the
              MoE ones through ``serve_batch``, the VLM through
              ``LM.prefill`` (with 8 x 1,601 seeded image embeddings) and
              ``LM.decode_step`` (`generate`). Measures and checks as phase
              8, plus the share of the prefill's (token, choice) pairs
              dropped at capacity factor 1.25; launches exactly 2 flash and
              2 * 63 decode (MoE), 8 flash (the dense layers) and 10 * 63
              decode (the cross layers' against their 1,601-position image
              cache); the first cross layer's decode call is checked too.
13c. moe_vlm_parity - the three at reduce 8 (MoE at capacity factor 1.25,
              pairs dropped; the VLM with 16 image tokens), gates and norm
              scales drawn non-zero, 2 requests of 128 tokens, 16 generated,
              card against CPU from the same parameters: logits within 2e-3
              at every step, tokens equal, the same routed experts, tokens
              and kept pairs in every MoE layer of the prefill, exact
              launches; dbrx-132b served twice on the card, logits
              bit-equal.
13d. schedule - `launch/schedule.py`: NoMora places the ten LM jobs (192
              machines, 12 jobs of 8 hosts, 300 s) on the card and on the
              CPU with fixed_algo_s = 0: placements (roots, mesh orders)
              and every SimMetrics series and summary() equal; costmap and
              auction_phase launch on the card, auction_bid does not.

14. grad_kernels - the training path's autograd Functions at a full-width
              layer's shapes, f32: flash at qwen3-0.6b's (8, 16 / 8, 1,024,
              128) and at its 4,096-token training layer (4, 16 / 8, 4,096,
              128), RG-LRU at recurrentgemma-2b's (4, 2,048, 2,560), RWKV-6
              at rwkv6-7b's (8, 64, 1,024, 64) in chunks of 256. Each
              Function's gradients (and outputs) against plain autograd on
              the same card tensors: flash within FLASH_GRAD_TOL of each
              gradient's largest magnitude (its backward is a kernel of its
              own, one call a backward), RG-LRU bit for bit (its backward
              recomputes the plain version), RWKV-6 against its chunked op
              run with the plain forward, within 1e-4 (its chunk states
              come from the kernel); the kernel's launches per forward (1,
              1, 4); forward and backward ms (CUDA events) and peak memory
              of the Function and of the plain version. Flash's backward
              kernel alone at both shapes: call ms, the device ms of its Δ,
              dQ and dK/dV launches, its bound (5 products in 3 TF32
              passes, or its bytes) with the design's 7 products beside
              it, and scaled_dot_product_attention's f32 backward (a
              yardstick, never used by the port) with its gradients'
              error.
15. train, train_recurrentgemma, train_rwkv - ``launch.train.main`` at full
              width, f32, remat, depth cut inside this script
              (``dataclasses.replace(cfg, n_layers=...)`` in place of
              ``reduce_config``): qwen3-0.6b, all 28 layers, 8 x 1,024;
              recurrentgemma-2b, one (rec, rec, local_attn) superblock and
              its (rec, rec) remainder, 4 x 2,048; rwkv6-7b, 2 layers, 8 x
              1,024. 3 steps with a checkpoint at step 2, then a run
              resumed from that checkpoint alone to step 3: resumed losses
              within rtol 1e-5 of the first run's, the restored state
              byte-equal to the saved files, exact launches per step (2 for
              each superblock layer that uses a kernel: forward and remat's
              recompute; 1 for a remainder layer; RWKV-6 once per chunk of
              256). Step seconds, losses, grad norms, tokens/s, checkpoint
              save / wait / restore seconds, peak memory, and the card's
              busy and idle share in one profiled step (CUDA trace).
16. train_parity - each of the three at ``reduce_config(cfg, 8)`` (batch 2,
              sequences of 128, 128 and 512: two RWKV-6 chunks), step 1's
              gradients and 3 train steps on the card against the same on
              the CPU from the same weights and data: losses within rtol
              1e-4 at every step, every gradient leaf within 1e-3 *
              max|leaf| + 1e-6, exact launches. AdamW with eps 1 there
              (TRAIN_PARITY_ADAMW: at eps 1e-8 a first update is lr *
              sign(g), which turns rounding differences on near-zero
              gradients into full steps).
16b. roofline - the port's dry run (`repro_torch.launch.dryrun.lower_cell`:
              one rank's step on fake tensors, on the host; it launches
              nothing) of the script's own qwen3-0.6b cells on a 1x1 mesh:
              the train phase's step (28 layers, 8 x 1,024) and one decode
              step of the serve phase (8 x 1,088 cache). flops_dev,
              model_flops, the roofline terms on H100 constants
              (`launch/rooftool.py`) and the achieved rate flops_dev /
              step_s beside the step times the train and serve phases
              measured, against the f32 peak (the port's products run in
              f32, TF32 off); fails if a count is not positive or the
              achieved rate exceeds that peak.

17. dist_parity, tp_parity - ranks (`repro_torch.distributed.comm.run_ranks`;
              `phase_rank_parity`): card ranks sharing the card through
              host-staged gloo (NCCL refuses two ranks on one card), against
              the same ranks on the CPU, all at reduce 8; nothing here is
              timed, so the six spawns run at once (the CPU ranks' threads
              split the host's cores between them). dist_parity: qwen3-0.6b
              and dbrx-132b on 2x1, 3 FSDP-sharded steps and 3
              compressed-DP steps (losses within rtol 1e-4, every parameter
              leaf within 1e-3 * max|leaf| + 1e-6; AdamW as
              TRAIN_PARITY_ADAMW), the 2-stage GPipe loss and gradients on a
              pod mesh of the same ranks (qwen3-0.6b only), and the 2x1
              serve at 4 x 16 and 2 x 45 prompts (45 MoE groups straddle
              the ranks): tokens equal, logits within 2e-3. tp_parity (the
              ``model`` axis, tensor parallelism): ``--mesh 1x2`` greedy
              serving of six configs (4 x 16 prompts, 16 tokens, float32
              caches; tokens equal, logits within 2e-3), granite-20b's and
              recurrentgemma-2b's caches sequence-sharded and merged by the
              decode kernel's log-sum-exp; ``--mesh 2x2`` 3 FSDP x TP steps
              of qwen3-0.6b and dbrx-132b (the same rules), and of
              qwen3-0.6b with the residual stream split along the sequence
              (``act_seq`` on ``model``): card against CPU ranks as the
              others, and within rtol 1e-5 (step 1) / 1e-3 of the same
              ranks' steps without it. With enough cards the same over
              NCCL; else "not run: 1 card".
18. train_fsdp - ``launch.train``, qwen3-0.6b full width with its depth cut
              to 8 layers, the train phase's 8 x 1,024 batches, one chain
              of checkpoints: 4 steps on one device (the baseline of
              18-20), then ``--mesh 2x1 --dist-backend gloo``: 1 step, a
              checkpoint at 1 (its shards gathered to rank 0 alone); a
              ``--mesh 1x2`` run resumed from it (19); its final
              checkpoint (step 3) restored on one rank
              (`elastic_mesh(1, 1)`) for the fourth step; the losses
              against the baseline's (step 1 rtol 1e-5, later 1e-3); step
              ms, bytes gathered and reduce-scattered a step, each rank's
              peak memory, launches summed over the ranks.
19. train_tp - in 18's chain, ``launch.train --mesh 1x2 --dist-backend
              gloo --resume``: 2 FSDP x TP steps from the 2x1 checkpoint
              and a checkpoint gathered to rank 0; step ms, bytes per
              collective kind, peak memory, exact launches. Then, in the
              same ranks, 2 steps of ``build_train_step`` from the seed's
              weights and the first batches under rules that map
              ``act_seq`` to ``model`` (the residual stream split along
              the sequence): the same checks and numbers against the
              baseline's first steps, its launches counted from 0.
20. train_pp, train_compressed - one spawn of two ranks, the weights
              drawn once. GPipe: the same model as 2 stages of 4 layers
              over ``pod``, 4 microbatches of 2 x 1,024: the loss within
              rtol 1e-5 of the serial loss on the card, every gradient leaf
              within 1e-4 of its largest magnitude; 16 flash launches a
              rank. Then the compressed-DP step on the same two ranks, the
              same model and batches, 2 steps: step ms, the int32 payload's
              bytes against the float32 gradients', losses beside FSDP's;
              step 1's loss within rtol 1e-5 of the baseline's, and the
              norm of the synchronised step-1 gradient within the error
              feedback's bound (the ranks' mean residual norm) of the
              baseline's exact gradient norm.
21. serve_dp - ``launch.serve --mesh 2x1 --dist-backend gloo``, qwen3-0.6b
              full width, 8 requests of 1,024 + 64: prefill s, decode ms a
              step and tokens/s beside the serve phase's; exact launches;
              tokens and logits held to ``launch.serve --mesh 1x1`` of the
              same weights (logits within 2e-3 up to where the greedy runs
              first part, if they do).
22. serve_tp - ``serve_batch`` on ``--mesh 1x2`` (tensor parallelism) at
              full width, alone on the host: qwen3-0.6b (28 layers) and
              recurrentgemma-2b (5 layers, its ring sequence-sharded), 8
              requests of 1,024 / 2,048 + 16 (cut from 64 for the time
              limit), against a one-card serve of the same weights; prefill
              s, decode ms, tokens/s, bytes per collective kind, peak
              memory, exact launches and log-sum-exp launches a rank.

A ``dist_budget`` line gives the phases across ranks' seconds against
their 330 s budget. Then a ``{"kernels": [...]}`` line (one entry per
kernel: route, source,
the TPU kernel it replaces, launches in the run of its main path - the
full-width replay for the scheduler's kernels (with the dynamic ON and OFF
replays' and phases 6d-6h's and 13d's beside them), the qwen3-0.6b serve for
the attention kernels (with the recurrentgemma, MoE and VLM serves' and
parities', the phases across ranks' summed over their ranks and, for
flash, the training phases' beside them), the recurrentgemma and rwkv6 serves for the
scans (with the training phases' beside them), and for the three trained
kernels their launches per train step and grad_kernels' numbers - max abs
error and tolerance, kernel / device / plain / bound / library times at
the main shape; flash's backward kernel its own entry: its launches in
the training phases, its gradients' error and grad_kernels' times at
the 4,096-token layer) and, last, ``{"ok": true, "device": {...}}``.

Runs from a checkout (it imports ``src/repro_torch``); it needs no JAX and
no network, and exits non-zero without a CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
T_START = time.perf_counter()
if str(ROOT / "src") not in sys.path:
    sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
SEED = 0
N_REPS = 21
N_PER_REP = 10

MAIN_SHAPE = (1024, 12_500)
COSTMAP_SHAPES = ((1024, 12_500), (8, 12_500))
BID_SHAPES = ((1024, 12_500), (8, 12_500), (2048, 12_500))
# Operations per element, counted from the kernels' arithmetic.
COSTMAP_OPS = 10  # div, rint, 2 clamps, max, div, mul, rint, mul, convert
BID_OPS = 7  # 2 subs, floor max, 2 compares, 2 max/min of the merge

KERNEL_INFO = {
    "costmap": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/costmap.cu",
        "replaces": "src/repro/kernels/costmap/kernel.py:75",
    },
    "auction_bid": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/auction_bid.cu",
        "replaces": "src/repro/kernels/auction_bid/kernel.py:71",
    },
    "auction_phase": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/auction_phase.cu",
        # the bid fused with the reference's while_loop (src/repro/core/auction.py:219)
        "replaces": "src/repro/kernels/auction_bid/kernel.py:71",
    },
    "flash_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:83",
    },
    "decode_attention": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/kernel.py:67",
    },
    "rglru_scan": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan/kernel.py:59",
    },
    "rwkv6_scan": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/rwkv6_scan.cu",
        "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:66",
    },
    "flash_attention_bwd": {
        "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention_bwd.cu",
        # a pallas_call has no VJP; the reference differentiates only the
        # plain XLA form
        "replaces": None,
    },
}
SCHEDULER_KERNELS = ("costmap", "auction_bid", "auction_phase")
# Full-width auction phases: rounds of (tasks, jobs) at 12,500 machines, and
# a price war: PRICE_WAR[0] tasks with identical rows in exact mode, of which
# PRICE_WAR[1] machines are cheapest by one cost unit (one free slot each).
# The barrier probe is the same war at PRICE_WAR[0] machines on the full grid.
PHASE_ROUNDS = ((1024, 300), (1536, 450), (8, 3))
PRICE_WAR = (64, 60)
PHASE_MAX_ITERS = 500_000
# The migration path: a window of 4 full-width rounds, what-if lanes, and
# the dynamic replays under `benchmarks/migration_quality.py`'s controller
# settings on the drifting-hotspot scenario.
WINDOW_ROUNDS = 4
DYNAMIC_SCENARIO = "drifting_hotspot"
QOS = dict(qos_threshold=0.95, qos_window=2, qos_hold_s=30.0)
WHATIF_BETAS = (0.0, 100.0 / 3600.0)
# The rest of the scheduler: the MCMF replay's cluster (the Google layout,
# 8 racks of 48) and the trace cursor's window.
MCMF_PARITY_MACHINES = 384
TRACE_WINDOW_S = 3600
# Sources rebuilt on every run whose ptxas reports must show no spill.
SPILL_GATED = ("flash_attention.cu", "flash_attention_bwd.cu", "decode_attention.cu",
               "rwkv6_scan.cu", "rglru_scan.cu", "auction_phase.cu")
DECODE_KERNEL = ("decode_attention_kernel",)
L2_FLUSH_BYTES = 128 * 2**20  # more than the H100's 50 MB L2
# A small shape at a head_dim no kernel is compiled for (qwen3-0.6b's at
# --reduce 3): (B, H, KVH, S, D).
ODD_HEAD_DIM_SHAPE = (2, 6, 2, 200, 42)
SERVE_KERNELS = ("flash_attention", "decode_attention", "rglru_scan", "rwkv6_scan")

# The LM serving path: qwen3-0.6b, full width; 8 requests of 1,024 prompt
# tokens and 64 generated ones.
SERVE_ARCH = "qwen3-0.6b"
SERVE_REQUESTS, SERVE_PROMPT, SERVE_GEN = 8, 1024, 64
ATT_TOL = {"f32": 2e-5, "bf16": 2e-2}
# Flash's backward kernel against autograd through the plain version: each
# gradient within this share of its largest magnitude (f32; as
# tests/test_torch_cuda.py).
FLASH_GRAD_TOL = 1e-5
PARITY_TOL = 2e-3
# The recurrent serving paths at full width. recurrentgemma-2b's prompts
# fill its 2,048-token window: flash runs at S = 2,048 and every decode step
# writes across the ring's wrap.
RECURRENT_SERVES = {
    "recurrentgemma-2b": dict(phase="serve_recurrentgemma", requests=8, prompt_len=2048,
                              gen=64),
    "rwkv6-7b": dict(phase="serve_rwkv", requests=8, prompt_len=1024, gen=64),
}
RECURRENT_PARITY_PROMPT = {"recurrentgemma-2b": 160, "rwkv6-7b": 64}
# The MoE and VLM serving paths at full width, depth cut for the run's time
# limit: dbrx-132b and llama4-scout 2 MoE layers each, llama-3.2-vision
# two (dense x 3, cross, dense) superblocks; then each at reduce 8, card
# against CPU, and NoMora placing the ten LM jobs (launch/schedule.py).
FAMILY_SERVES = {
    "dbrx-132b": dict(phase="serve_dbrx", layers=2, requests=8, prompt_len=1024, gen=64),
    "llama4-scout-17b-a16e": dict(phase="serve_llama4", layers=2, requests=8, prompt_len=1024,
                                  gen=64),
    "llama-3.2-vision-11b": dict(phase="serve_vlm", layers=10, requests=8, prompt_len=1024,
                                 gen=64),
}
FAMILY_PARITY_PROMPT, FAMILY_PARITY_GEN = 128, 16
FAMILY_REPEAT_ARCH = "dbrx-132b"  # served twice on the card: bit-equal logits
SCHEDULE_RUN = (192, 12, 300)  # machines, jobs, seconds: schedule_ml_jobs' defaults
SCAN_TOL = {"rglru_scan": 1e-5, "rwkv6_scan": 1e-4}
RGLRU_SHAPES = ((8, 2048, 2560), (3, 1000, 2500))  # (B, T, D): prefill, ragged
RWKV_SHAPE = (8, 64, 1024, 64)  # (B, H, T, N), prefill; decode at T = 1
RWKV_RAGGED = (3, 64, 1000, 64)  # T a multiple of neither the chunk nor the ring
# Operations per element or per state entry, counted from the kernels.
RGLRU_OPS = 8  # 2*la, expm1, negate, sqrt, exp, a*h, mult*gx, add
# RWKV-6 needs 5 per state entry and step: an FMA r*S into o (2), k*v (1)
# and an FMA w*S + kv (2); the bonus sum_i r_i u_i k_i v_j factors out as
# v_j * c_t, one scalar per step and head.
RWKV_OPS = 5
# Training: each kernel's Function at a full-width layer's shapes (flash:
# qwen3-0.6b's (B, H, KVH, S, D), then its layer in qwen3-0.6b.train-4k,
# where the tensor cores' truncation showed in the backward; RG-LRU:
# recurrentgemma-2b's (B, T, D) at batch 4; RWKV-6: rwkv6-7b's (B, H, T,
# N) in chunks of 256), and the train runs at full width, depth cut:
# (arch, layers, batch, seq).
GRAD_SHAPES = {"flash_attention": (8, 16, 8, 1024, 128),
               "flash_attention.train_4k": (4, 16, 8, 4096, 128),
               "rglru_scan": (4, 2048, 2560), "rwkv6_scan": (8, 64, 1024, 64)}
FLASH_BWD_KERNELS = ("flash_bwd_delta", "flash_bwd_dq", "flash_bwd_dkdv")
GRAD_RWKV_CHUNK = 256
TRAIN_RUNS = {
    "train": ("qwen3-0.6b", 28, 8, 1024),
    "train_recurrentgemma": ("recurrentgemma-2b", 5, 4, 2048),  # (rec, rec, local_attn) + (rec, rec)
    "train_rwkv": ("rwkv6-7b", 2, 8, 1024),
}
TRAIN_STEPS, TRAIN_CKPT_AT = 3, 2  # cut from 4 for the time limit
TRAIN_RESUME_RTOL = 1e-5
TRAIN_PARITY_SEQ = {"qwen3-0.6b": 128, "recurrentgemma-2b": 128, "rwkv6-7b": 512}
TRAIN_PARITY_STEPS = 3
TRAIN_PARITY_LOSS_RTOL = 1e-4
# AdamW for the parity steps: eps = 1 keeps the update a smooth function of
# the gradient (about lr * g). At eps = 1e-8 the first update is lr *
# sign(g), and a rounding-level difference between the card's and the CPU's
# gradient on a near-zero entry becomes a full step of lr: rwkv6's losses
# then part by 5e-3 at step 3 though step 1's gradients agree.
TRAIN_PARITY_ADAMW = dict(lr=0.3, eps=1.0)
NO_SCAN_LIBRARY = (
    "no single PyTorch call computes either recurrence (a sequential scan "
    "whose decay depends on the data)"
)
NO_LIBRARY = (
    "no single PyTorch call computes a scheduler kernel's function (torch.max has no "
    "runner-up, torch.topk ignores the second slot price; none runs an auction)"
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(n_bytes: float, n_ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = N_REPS, per_rep: int = N_PER_REP, warmup: int = 3) -> float:
    """Per-launch time: CUDA events around ``per_rep`` back-to-back calls,
    divided by ``per_rep``; the median of ``reps`` such runs, after
    ``warmup`` calls. A call's host-side overhead shows where it exceeds the
    work on the card (small shapes)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(per_rep):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / per_rep)
    return float(np.median(times))


def device_ms(fn, kernel_names, n: int = N_PER_REP):
    """Mean time on the card per call of the named CUDA kernels, from a
    torch.profiler trace of ``n`` calls (host overhead excluded); None if
    the trace shows no device time for them."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = 0.0
    for evt in prof.key_averages():
        if any(k in evt.key for k in kernel_names):
            total_us += getattr(evt, "device_time_total", 0.0) or 0.0
    return total_us / n / 1e3 if total_us else None


def decode_times(q, k_cache, v_cache, lengths) -> dict:
    """Call, warm device and cold device (L2 flushed before each call) ms of
    the decode kernel on these inputs."""
    import torch

    from repro_torch.kernels.decode_attention import kernel_cuda as dec_k

    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=q.device)

    def cold():
        flush.zero_()
        flush.sum()  # read back: no dirty line is left for the call to write back
        dec_k.decode_attention_cuda(q, k_cache, v_cache, lengths)

    out = {
        "kernel_ms": time_ms(lambda: dec_k.decode_attention_cuda(q, k_cache, v_cache, lengths)),
        "device_ms": device_ms(lambda: dec_k.decode_attention_cuda(q, k_cache, v_cache, lengths),
                               DECODE_KERNEL),
        "device_ms_cold": device_ms(cold, DECODE_KERNEL),
    }
    del flush
    return out


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    info = {
        "phase": "device",
        "nvidia_smi": smi,
        "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "python": sys.version.split()[0],
    }
    emit(info)
    return info


def phase_build() -> None:
    from repro_torch.kernels import KERNELS, build

    # Rebuilt every run: the spill check below reads their ptxas reports.
    for src in SPILL_GATED:
        build.library_path(src).unlink(missing_ok=True)
    t0 = time.perf_counter()
    logs = build.build_all([src for _, _, src in KERNELS])
    seconds = time.perf_counter() - t0
    ptxas = {
        src: [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        for src, log in logs.items()
    }
    emit({"phase": "build", "seconds": seconds, "built": sorted(logs), "ptxas": ptxas})
    for src in SPILL_GATED:
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", logs[src])
        if not spills or any(n != "0" for pair in spills for n in pair):
            raise AssertionError(f"{src} spills registers (or ptxas gave no report): {spills}")


# --------------------------------------------------------------------- #
# Kernels against their plain versions


def _costmap_inputs(rng, T, M, device):
    import torch

    perf_idx = rng.integers(0, 4, size=T).astype(np.int32)
    lat = rng.uniform(0, 1400, size=(T, M)).astype(np.float32)
    # Boundary latencies: thresholds, the 45 us rounding edge, both ends of
    # the table, below zero, and exact half steps (round half to even).
    edges = np.array(
        [0.0, 39.9, 44.9, 45.0, 45.1, 55.0, 995.0, 1005.0, -3.0, 5.0, 15.0,
         25.0, 1000.0, 1400.0, 199.9, 200.1],
        np.float32,
    )
    lat[:, : len(edges)] = edges
    lat[: min(T, 4), :] = np.resize(edges, M)
    return (
        torch.from_numpy(perf_idx).to(device),
        torch.from_numpy(lat).to(device),
    )


def _bid_inputs(rng, T, C, device, chunk_cols):
    """Integer-valued float32 values and slot prices (price2 >= price1),
    with rows whose best value ties exactly across and inside column
    chunks, a row where every column ties, and price2 == price1 columns."""
    import torch

    values = rng.integers(-(2**20), 0, size=(T, C)).astype(np.float32)
    p1 = rng.integers(0, 2**16, size=C).astype(np.float32)
    p2 = np.maximum(p1, rng.integers(0, 2**17, size=C)).astype(np.float32)
    p2[::7] = p1[::7]
    top = np.float32(2**21)
    for r in range(min(T, 64)):
        a = int(rng.integers(0, C))
        b = (a + chunk_cols * int(rng.integers(1, 4))) % C  # other chunks
        c = min(C - 1, a + 1)  # same chunk
        for j in (a, b, c) if r % 2 else (b, a):
            values[r, j] = p1[j] + top
    values[T - 1, :] = p1 + np.float32(5.0)  # every column ties: index 0
    return tuple(torch.from_numpy(x).to(device) for x in (values, p1, p2))


def phase_kernels() -> dict:
    import torch

    device = "cuda"

    from repro_torch.core import perf_model
    from repro_torch.kernels.auction_bid import kernel_cuda as bid_k
    from repro_torch.kernels.auction_bid import ref as bid_ref
    from repro_torch.kernels.costmap import kernel_cuda as cm_k
    from repro_torch.kernels.costmap import ref as cm_ref

    rng = np.random.default_rng(SEED)
    lut = perf_model.perf_lut_table()
    lut_dev = lut.to(device)
    out = {"costmap": [], "auction_bid": []}

    for T, M in COSTMAP_SHAPES:
        perf_idx, lat = _costmap_inputs(rng, T, M, device)
        got = cm_k.costmap_cuda(lut_dev, perf_idx, lat)
        want = cm_ref.costmap_ref(lut_dev, perf_idx, lat)
        host = cm_ref.costmap_ref(lut, perf_idx.cpu(), lat.cpu())
        torch.cuda.synchronize()
        diff = int((got.long() - want.long()).abs().max())
        host_mismatch = int((got.cpu() != host).sum())
        nbytes = T * M * 8 + T * 4 + lut.numel() * 4
        b_ms, b_by = bound_ms(nbytes, T * M * COSTMAP_OPS)
        row = {
            "shape": [T, M],
            "max_abs_diff": diff,
            "mismatches": int((got != want).sum()),
            "cpu_plain_mismatches": host_mismatch,
            "kernel_ms": time_ms(lambda: cm_k.costmap_cuda(lut_dev, perf_idx, lat)),
            "device_ms": device_ms(lambda: cm_k.costmap_cuda(lut_dev, perf_idx, lat),
                                   ("costmap_kernel",)),
            "plain_ms": time_ms(lambda: cm_ref.costmap_ref(lut_dev, perf_idx, lat)),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        if diff or row["mismatches"] or host_mismatch:
            raise AssertionError(f"costmap kernel disagrees with its plain version: {row}")
        out["costmap"].append(row)

    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    for T, C in BID_SHAPES:
        default_chunk = bid_k.chunk_columns(T, C, n_sms)
        values, p1, p2 = _bid_inputs(rng, T, C, device, min(default_chunk, 512))
        want = bid_ref.bid_top2_ref(values, p1, p2)
        host = bid_ref.bid_top2_ref(values.cpu(), p1.cpu(), p2.cpu())
        checks = {}
        for label, chunk in (("default", None), ("chunk512", 512)):
            got = bid_k.bid_top2_cuda(values, p1, p2, chunk_cols=chunk)
            torch.cuda.synchronize()
            checks[label] = {
                "index_mismatches": int((got[0] != want[0]).sum()),
                "max_abs_diff": float(
                    max((got[k] - want[k]).abs().max() for k in (1, 2))
                ),
                "cpu_plain_mismatches": int(
                    sum((g.cpu() != h).sum() for g, h in zip(got, host))
                ),
            }
        nbytes = T * C * 4 + 2 * C * 4 + 3 * T * 4
        b_ms, b_by = bound_ms(nbytes, T * C * BID_OPS)
        row = {
            "shape": [T, C],
            "chunk_cols": default_chunk,
            "max_abs_diff": max(c["max_abs_diff"] for c in checks.values()),
            "index_mismatches": sum(c["index_mismatches"] for c in checks.values()),
            "checks": checks,
            "kernel_ms": time_ms(lambda: bid_k.bid_top2_cuda(values, p1, p2)),
            "device_ms": device_ms(lambda: bid_k.bid_top2_cuda(values, p1, p2),
                                   ("bid_chunk_kernel", "bid_merge_kernel")),
            "plain_ms": time_ms(lambda: bid_ref.bid_top2_ref(values, p1, p2)),
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
        }
        if row["max_abs_diff"] or row["index_mismatches"] or any(
            c["cpu_plain_mismatches"] for c in checks.values()
        ):
            raise AssertionError(f"auction_bid kernel disagrees with its plain version: {row}")
        out["auction_bid"].append(row)

    probe = barrier_probe()
    out["auction_phase"] = [
        check_phase(label, args, probe["barrier_us"])
        for label, args in [(f"round_{T}", phase_round_inputs(T, J)) for T, J in PHASE_ROUNDS]
        + [("price_war", price_war_inputs(*PRICE_WAR))]
    ]
    emit({"phase": "kernels", "tolerance": 0, "library_ms_null_because": NO_LIBRARY,
          "barrier_probe": probe, "kernels": out})
    return out


def phase_round_inputs(n_tasks: int, n_jobs: int, device="cuda", n_machines: int = 12_500):
    """The auction phase's inputs (price0, values, value_u, job_col, active)
    of a synthetic full-width round, built as the ``auction`` backend builds
    them: the cost build, then `solve_transportation_device`'s preparation
    (tie jitter 9, unscaled costs)."""
    import torch

    from repro_torch.core import auction, latency, perf_model, policy, topology

    topo = topology.google_topology(n_machines)
    plane = latency.LatencyPlane.synthesize(topo, 4, seed=SEED)
    state = full_width_round_state(topo, plane, n_tasks, n_jobs, 2, SEED)
    T, M, Tp = n_tasks, topo.n_machines, auction._bucket(n_tasks)
    w_m, a, *_ = policy.device_round_costs(
        state, topo, _policy(), perf_model.perf_lut_table().to(device),
        n_pad_tasks=Tp, n_pad_jobs=auction._bucket(n_jobs),
    )
    job_col = np.full(Tp, M, np.int32)
    job_col[:T] = M + state.task_job
    active = torch.from_numpy(np.arange(Tp) < T).to(device)
    vm, vu, price0, _ = auction.prepare_values_step(
        w_m, a, auction._jitter_device(Tp, M, 9, str(torch.device(device))), active,
        torch.from_numpy(state.free_slots.astype(np.int32)).to(device), 1,
        topo.slots_per_machine,
    )
    return price0, vm, vu, torch.from_numpy(job_col).to(device), active


def price_war_inputs(n_tasks: int, n_cheap: int, device="cuda", n_machines: int = 12_500,
                     n_slots: int = 8):
    """A price war: ``n_tasks`` tasks of one job with identical rows, in exact
    mode (costs scaled by T + 1, no jitter); ``n_cheap`` machines cost 10,
    the others 11, and every machine has one free slot. The tasks that find
    no cheap slot raise the cheap slots' prices by eps-sized steps until the
    next level pays as well."""
    import torch

    T, M = n_tasks, n_machines
    cost = np.full(M, 11, np.int64)
    cost[np.linspace(0, M - 1, n_cheap).astype(np.int64)] = 10
    values = np.broadcast_to((-cost * (T + 1)).astype(np.float32), (T, M)).copy()
    price0 = np.full((M, n_slots), np.float32(2.0**40), np.float32)
    price0[:, 0] = 0.0
    host = (price0, values, np.full(T, -1500 * (T + 1), np.float32), np.full(T, M, np.int32),
            np.ones(T, bool))
    return tuple(torch.from_numpy(x).to(device) for x in host)


def phase_bound(args, bidder_rows: int):
    """(bound_ms, bound_by) of a solve: each row that bids read once (every
    active row bids in the first iteration; padded rows never do), the slot
    prices read and price, owner and assignment written once, against
    BID_OPS operations per element of every bidder row."""
    price0, values, _, _, active = args
    Tp, M = values.shape
    n_bytes = (int(active.sum()) * M * 4 + Tp * (4 + 4 + 1 + 4)
               + price0.numel() * (4 + 4 + 4))
    return bound_ms(n_bytes, bidder_rows * M * BID_OPS)


def barrier_probe() -> dict:
    """A grid barrier's cost on the phase kernel's full grid: half the device
    time of an iteration of a price war whose rows are PRICE_WAR[0] machines
    wide (the work of an iteration is a few L2 round trips), launched on as
    many CTAs as can be co-resident."""
    from repro_torch.kernels.auction_phase import kernel_cuda as ph_k
    from repro_torch.kernels.auction_phase import ref as ph_ref

    n = PRICE_WAR[0]
    args = price_war_inputs(n, PRICE_WAR[1], n_machines=n)
    ctas = ph_k.max_ctas()
    got = ph_k.auction_phase_cuda(*args, 1.0, PHASE_MAX_ITERS, ctas=ctas)
    want = ph_ref.auction_phase_ref(*args, 1.0, PHASE_MAX_ITERS)
    if got[3] != want[3] or not all(
        bool((g == w).all()) for g, w in zip(got[:3], want[:3])
    ):
        raise AssertionError("auction_phase disagrees with the step-wise loop on the probe")
    dev = device_ms(lambda: ph_k.auction_phase_cuda(*args, 1.0, PHASE_MAX_ITERS, ctas=ctas),
                    ("auction_phase_kernel",))
    if dev is None:
        raise AssertionError("the profiler shows no device time for the barrier probe")
    return {"shape": list(args[1].shape), "ctas": ctas, "iterations": got[3],
            "device_ms": dev, "barrier_us": dev * 1e3 / got[3] / 2}


def check_phase(label: str, args, barrier_us: float) -> dict:
    """The persistent phase kernel against the step-wise loop on the same
    card tensors and on CPU copies (the plain bid): price, owner, assigned,
    iterations and bidder rows equal (raises otherwise); then its times
    beside the loop's, the bound and the barriers' latency."""
    import torch

    from repro_torch.kernels.auction_phase import kernel_cuda as ph_k
    from repro_torch.kernels.auction_phase import ref as ph_ref

    got = ph_k.auction_phase_cuda(*args, 1.0, PHASE_MAX_ITERS, return_bidder_rows=True)
    want = ph_ref.auction_phase_ref(*args, 1.0, PHASE_MAX_ITERS, return_bidder_rows=True)
    cpu = ph_ref.auction_phase_ref(*(a.cpu() for a in args), 1.0, PHASE_MAX_ITERS,
                                   return_bidder_rows=True)
    torch.cuda.synchronize()
    names = ("price", "owner", "assigned")
    mismatches = {n: int((g != w).sum()) for n, g, w in zip(names, got[:3], want[:3])}
    cpu_mismatches = {n: int((g.cpu() != c).sum()) for n, g, c in zip(names, got[:3], cpu[:3])}
    diff = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got[:3], want[:3]))
    iters, rows = got[3], got[4]
    row = {"label": label, "shape": list(args[1].shape), "slots": int(args[0].shape[1]),
           "max_abs_diff": diff, "mismatches": mismatches, "cpu_mismatches": cpu_mismatches,
           "iterations": iters, "loop_iterations": want[3], "cpu_iterations": cpu[3],
           "bidder_rows": rows, "loop_bidder_rows": want[4], "cpu_bidder_rows": cpu[4]}
    if (diff or any(mismatches.values()) or any(cpu_mismatches.values())
            or not iters == want[3] == cpu[3] or not rows == want[4] == cpu[4]):
        raise AssertionError(f"auction_phase kernel disagrees with the step-wise loop: {row}")
    b_ms, b_by = phase_bound(args, rows)

    def call():
        return ph_k.auction_phase_cuda(*args, 1.0, PHASE_MAX_ITERS)

    def loop():
        return ph_ref.auction_phase_ref(*args, 1.0, PHASE_MAX_ITERS)

    long_war = iters > 1000  # the loop takes seconds a solve there
    row.update(
        kernel_ms=time_ms(call, **(dict(reps=5, per_rep=2) if long_war else {})),
        device_ms=device_ms(call, ("auction_phase_kernel",)),
        plain_ms=time_ms(loop, reps=1 if long_war else 3, per_rep=1, warmup=0 if long_war else 1),
        bound_ms=b_ms, bound_by=b_by, library_ms=None,
        latency_ms=iters * 2 * barrier_us / 1e3,
    )
    row["us_per_iteration"] = row["kernel_ms"] * 1e3 / iters
    row["device_us_per_iteration"] = (row["device_ms"] * 1e3 / iters
                                      if row["device_ms"] is not None else None)
    row["plain_us_per_iteration"] = row["plain_ms"] * 1e3 / iters
    return row


# --------------------------------------------------------------------- #
# Rounds and replays


def _policy():
    from repro_torch.core.policy import PolicyParams

    return PolicyParams(p_m=105, p_r=110, preemption=True, beta_scale=1.0)


def full_width_round_state(topo, plane, n_tasks: int, n_jobs: int, t: int, seed: int):
    """A synthetic full-width round: n_tasks tasks of n_jobs jobs rooted on
    random machines, a third of them running (preemption arcs)."""
    from repro_torch.core.policy import RoundState

    rng = np.random.default_rng(seed)
    roots = rng.integers(0, topo.n_machines, size=n_jobs)
    cur = np.full(n_tasks, -1, np.int64)
    run_s = np.zeros(n_tasks, np.float32)
    k = n_tasks // 3
    cur[:k] = rng.integers(0, topo.n_machines, size=k)
    run_s[:k] = rng.uniform(0, 7200, size=k)
    return RoundState(
        task_job=np.sort(rng.integers(0, n_jobs, size=n_tasks)),
        perf_idx=rng.integers(0, 4, size=n_tasks),
        root_machine=roots,
        root_latency=plane.latency_rows(roots, t),
        wait_s=rng.uniform(0, 100, size=n_tasks).astype(np.float32),
        run_s=run_s,
        cur_machine=cur,
        free_slots=rng.integers(0, topo.slots_per_machine + 1, size=topo.n_machines).astype(np.int32),
    )


def _wall_ms(fn, reps: int = 5) -> float:
    """Median host wall time of ``fn`` (which ends in a device-to-host read,
    so in a synchronised state) over ``reps`` runs, after one warm-up run."""
    fn()
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(walls))


def _launches_of(fn) -> dict:
    """The scheduler kernels' launches during one call of ``fn``."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    fn()
    return {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}


def round_window_check(topo, plane, params, device) -> dict:
    """A window of WINDOW_ROUNDS full-width rounds through `place_window`,
    in both slot modes, against sequential `auction` backend `place` calls
    (exogenous: each round's own free slots; chained: the host's slot
    accounting between the calls, the later rounds' rows as deltas)."""
    from repro_torch.core import policy
    from repro_torch.core import scheduler_backend as sb
    from repro_torch.core.round_program import stack_round_states

    R = WINDOW_ROUNDS
    states = [full_width_round_state(topo, plane, MAIN_SHAPE[0], 300, r, SEED + r)
              for r in range(R)]
    seq = sb.AuctionBackend(params, topo, device=device)
    win = sb.WindowedAuctionBackend(params, topo, device=device)
    ctx = sb.RoundContext(rng=np.random.default_rng(SEED),
                          task_counts=np.zeros(topo.n_machines, np.int64), n_ready=0)
    out = {"rounds": R, "tasks": MAIN_SHAPE[0]}
    # Exogenous slots: bit-equal to R sequential `place` calls.
    want = [seq.place(s, ctx) for s in states]
    got = win.place_window(states)
    if not all(np.array_equal(g.cols, w.cols) and g.objective == w.objective
               for g, w in zip(got, want)):
        raise AssertionError("place_window (exogenous) differs from sequential place calls")
    out["exogenous_launches"] = _launches_of(lambda: win.place_window(states))
    # Chained slots: the later rounds' free slots are deltas on the carry.
    rng = np.random.default_rng(SEED)
    chained = [dataclasses.replace(s) for s in states]
    for s in chained[1:]:
        d = np.zeros(topo.n_machines, np.int32)
        np.add.at(d, rng.integers(0, topo.n_machines, size=200), 1)
        s.free_slots = d
    free = chained[0].free_slots.astype(np.int64)
    want_c = []
    for r, s in enumerate(chained):
        if r:
            free = free + s.free_slots
        p = seq.place(dataclasses.replace(s, free_slots=free.astype(np.int32)), ctx)
        want_c.append(p)
        np.subtract.at(free, p.cols[p.cols < topo.n_machines], 1)
    got_c = win.place_window(chained, chain=True)
    if not all(np.array_equal(g.cols, w.cols) and g.objective == w.objective
               for g, w in zip(got_c, want_c)):
        raise AssertionError("place_window (chained) differs from sequential place calls "
                             "with host slot accounting")
    if (free < 0).any():
        raise AssertionError("chained window oversubscribed a machine")
    out["chained_launches"] = _launches_of(lambda: win.place_window(chained, chain=True))
    for mode in ("exogenous", "chained"):
        n = out[f"{mode}_launches"]
        if device == "cuda" and (n["auction_phase"] != R or n["costmap"] != R
                                 or n["auction_bid"]):
            raise AssertionError(f"{mode} window launches {n}, expected {R} phases")
    out.update(
        bit_equal=["exogenous", "chained"],
        window_ms=_wall_ms(lambda: win.place_window(states)),
        chained_window_ms=_wall_ms(lambda: win.place_window(chained, chain=True)),
        sequential_place_ms=_wall_ms(lambda: [seq.place(s, ctx) for s in states]),
    )
    # Where the window's time goes: host staging (padding and stacking the
    # R rounds), then the rounds on the device with their one read back;
    # beside it the sequential calls' cost builds (staging, upload, costs).
    _, prog = win._program(MAIN_SHAPE[0], 300)

    def stack():
        return stack_round_states(states, n_pad_tasks=prog.n_pad_tasks,
                                  n_pad_jobs=prog.n_pad_jobs)

    window = stack()
    lut = seq.lut

    def cost_builds():
        for s in states:
            policy.device_round_costs(s, topo, params, lut, n_pad_tasks=prog.n_pad_tasks,
                                      n_pad_jobs=prog.n_pad_jobs)
        _sync(device)

    out.update(
        window_stack_ms=_wall_ms(stack),
        window_advance_ms=_wall_ms(
            lambda: prog.advance(prog.init_state(states[0].free_slots), window)),
        sequential_cost_build_ms=_wall_ms(cost_builds),
        iterations=[int(i) for i in prog.advance(
            prog.init_state(states[0].free_slots), window)[1].iterations],
    )
    return out


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def round_whatif_check(topo, plane, params, device) -> dict:
    """WHATIF_LANES lanes of one full-width round: beta in {0, 100/3600} x
    {every mover, every other mover}, plus a lane with every mover frozen
    (the running third of the tasks are the movers). Each lane bit-equal
    to the same lane solved alone; the unmasked lanes also to the
    `auction` backend's `place` under the lane's params."""
    from repro_torch.core import scheduler_backend as sb

    state = full_width_round_state(topo, plane, MAIN_SHAPE[0], 300, 3, SEED + 7)
    T = state.n_tasks
    movers = state.cur_machine >= 0
    every = np.ones(T, bool)
    half = every.copy()
    half[np.nonzero(movers)[0][::2]] = False
    variants, masks = [params], [~movers]  # lane 0: all movers frozen
    for b in (0.0, 100.0 / 3600.0):
        for m in (every, half):
            variants.append(dataclasses.replace(params, beta_scale=b))
            masks.append(m)
    masks = np.stack(masks)
    win = sb.WindowedAuctionBackend(params, topo, device=device)
    ctx = sb.RoundContext(rng=np.random.default_rng(SEED),
                          task_counts=np.zeros(topo.n_machines, np.int64), n_ready=0)
    res, _ = win.whatif_result(state, ctx, variants, active_masks=masks)
    _, prog = win._program(T, state.n_jobs)
    fields = ("assigned", "iterations", "per_task_cost", "per_task_true_cost",
              "per_task_stay_cost")
    for k, (v, m) in enumerate(zip(variants, masks)):
        alone = prog.what_if(state, [v], active_masks=m[None])
        if not all(np.array_equal(getattr(res, f)[k], getattr(alone, f)[0]) for f in fields):
            raise AssertionError(f"what-if lane {k} differs from its lane solved alone")
        if m.all():
            p = sb.AuctionBackend(v, topo, device=device).place(state, ctx)
            if not (np.array_equal(res.variant_cols(k), p.cols)
                    and int(res.per_task_cost[k].astype(np.int64).sum()) == p.objective):
                raise AssertionError(f"what-if lane {k} differs from place under its params")
    if not (res.assigned[0, :T][~movers] >= 0).all():
        raise AssertionError("the all-frozen lane left ready rows unsolved")
    launches = _launches_of(lambda: win.whatif_result(state, ctx, variants, active_masks=masks))
    K = len(variants)
    if device == "cuda" and (launches["auction_phase"] != K or launches["costmap"] != K
                             or launches["auction_bid"]):
        raise AssertionError(f"what-if launches {launches}, expected {K} phases")
    return {
        "lanes": K, "tasks": T, "movers": int(movers.sum()), "bit_equal": True,
        "iterations": [int(i) for i in res.iterations],
        "lane_outcomes": [int(x) for x in res.lane_outcomes()],
        "launches": launches,
        "lanes_ms": _wall_ms(lambda: win.whatif_result(state, ctx, variants,
                                                        active_masks=masks)),
        "one_lane_ms": _wall_ms(lambda: prog.what_if(state, variants[1:2])),
    }


def oracle_plane(topo, duration_s: int):
    """A drifting rack hotspot (two racks wide, 4x, one rack every 2 s)
    and two regime shifts, seed SEED."""
    from repro_torch.core import latency

    ev = latency.LatencyEvents(
        hotspots=(latency.DriftingHotspot(start_s=4.0, end_s=duration_s - 4.0, rack0=0,
                                          drift_racks_per_s=0.5, width_racks=2,
                                          multiplier=4.0),),
        regime=latency.RegimeSchedule(times=(10.0, 20.0), frac=0.5),
    )
    return latency.LatencyPlane.synthesize(topo, duration_s, seed=SEED, events=ev)


def oracle_rows_check(topo, device) -> dict:
    """Oracle rows bit-equal to `plane.latency_rows` at 12,500 machines, at
    a regime boundary and across hotspot steps; their times beside the
    host's."""
    from repro_torch.core import latency_device

    plane = oracle_plane(topo, 30)
    oracle = latency_device.DeviceLatencyOracle(plane, device=device)
    roots = np.random.default_rng(SEED).integers(0, topo.n_machines, size=300)
    times = (3, 4, 5, 9, 10, 11, 20)  # hotspot start and steps; shifts at 10 and 20
    for t in times:
        got = oracle.root_rows(roots, t).cpu().numpy()
        if not np.array_equal(got, plane.latency_rows(roots, t)):
            raise AssertionError(f"oracle rows differ from the host's at t={t}")

    def rows():
        oracle.root_rows(roots, 11)
        _sync(device)

    # A root seen for the first time (or in a new regime epoch) costs one
    # host decomposition, hashed in numpy over all M machines.
    return {"roots": len(roots), "times": list(times), "bit_equal": True,
            "oracle_rows_ms": _wall_ms(rows), "host_rows_ms": _wall_ms(
                lambda: plane.latency_rows(roots, 11), reps=3),
            "decomposition_ms": _wall_ms(lambda: plane.row_decomposition(7, 1)),
            "stats": oracle.stats()}


def phase_round(device="cuda", n_machines: int = 12_500) -> dict:
    from repro_torch.core import auction, latency, perf_model, policy, topology

    topo = topology.google_topology(n_machines)
    plane = latency.LatencyPlane.synthesize(topo, 4, seed=SEED)
    state = full_width_round_state(topo, plane, MAIN_SHAPE[0], 300, 2, SEED)
    params = _policy()
    lut = perf_model.perf_lut_table()
    host = policy.dense_costs(state, topo, params, lut)
    dev = policy.dense_costs_device(state, topo, params, lut, device=device)
    fields = {}
    for f in ("w", "col_capacity", "d", "c_rack", "b", "a"):
        h = getattr(host, f)
        d = getattr(dev, f).cpu().numpy()
        if h.shape != d.shape or h.dtype != d.dtype or not np.array_equal(h, d):
            raise AssertionError(f"full-width round: field {f} differs from the host reference")
        fields[f] = list(h.shape)
    w_m, a, *_ = policy.device_round_costs(
        state, topo, params, lut.to(device),
        n_pad_tasks=auction._bucket(state.n_tasks), n_pad_jobs=auction._bucket(state.n_jobs),
    )
    res = auction.solve_transportation_device(
        w_m, a, state.n_tasks, state.free_slots, topo.n_machines, state.task_job,
        slots_per_machine=topo.slots_per_machine, tie_jitter=9, exact=False,
        cost_bound=20_000,
    )
    cols = res.assigned_col
    placed = cols[cols < topo.n_machines]
    over = np.bincount(placed, minlength=topo.n_machines) > state.free_slots
    if over.any():
        raise AssertionError("full-width round oversubscribed a machine")
    info = {"phase": "round", "machines": n_machines, "tasks": state.n_tasks,
            "jobs": state.n_jobs, "fields_equal": fields,
            "placed": int(len(placed)), "iterations": res.iterations,
            "total_cost": res.total_cost,
            "window": round_window_check(topo, plane, params, device),
            "whatif": round_whatif_check(topo, plane, params, device),
            "oracle": oracle_rows_check(topo, device)}
    emit(info)
    return info


def replay(topo, duration_s: int, device: str, backend: str = "auction", *,
           failures=(), fixed_algo_s=None):
    from repro_torch import obs
    from repro_torch.core import latency, simulator, workload

    plane = latency.LatencyPlane.synthesize(topo, duration_s, seed=SEED)
    wl = workload.synth_workload(topo, duration_s, seed=SEED, target_utilisation=0.6)
    cfg = simulator.SimConfig(
        policy="nomora", backend=backend, device=device, seed=SEED,
        params=_policy(), migration_interval_s=30, failures=failures,
        fixed_algo_s=fixed_algo_s,
    )
    with obs.scope() as tel:
        sim = simulator.Simulator(wl, plane, cfg)
        t0 = time.perf_counter()
        metrics = sim.run()
        wall = time.perf_counter() - t0
        counters = obs.counters()
        spans: dict = {}
        for rec in tel.spans:  # host wall time by span name
            spans[rec.name] = spans.get(rec.name, 0.0) + rec.dur_ns * 1e-9
    counters["spans_s"] = spans
    return sim, metrics, wall, counters


SERIES = ("algo_runtime_s", "placement_latency_s", "response_time_s",
          "migrated_pct_per_round", "per_job_perf")
SCALARS = ("tasks_placed", "tasks_migrated", "rounds")


def phase_parity(device="cuda", n_machines: int = 1536, duration_s: int = 60) -> dict:
    from repro_torch.core.topology import Topology

    topo = Topology(n_machines, 48, 16, slots_per_machine=8)
    kw = dict(failures=((20, 7),), fixed_algo_s=0.0)
    _, card, card_s, _ = replay(topo, duration_s, device, **kw)
    _, cpu, cpu_s, _ = replay(topo, duration_s, "cpu", **kw)
    diffs = [f for f in SERIES + SCALARS if getattr(card, f) != getattr(cpu, f)]
    sa, sb = card.summary(), cpu.summary()
    diffs += [k for k in sa if not (sa[k] == sb[k] or (np.isnan(sa[k]) and np.isnan(sb[k])))]
    if diffs:
        raise AssertionError(f"parity replay: card and CPU differ in {diffs}")
    info = {"phase": "parity", "machines": n_machines, "duration_s": duration_s,
            "rounds": card.rounds, "tasks_placed": card.tasks_placed,
            "tasks_migrated": card.tasks_migrated, "card_wall_s": card_s,
            "cpu_wall_s": cpu_s, "equal": list(SERIES + SCALARS) + ["summary"]}
    emit(info)
    return info


class _Solves:
    """Wraps `auction.solve_transportation_device`: counts the solves that
    have tasks and keeps the arguments of the slowest one (host clock; the
    solve ends in a device-to-host read). Its cost tensors are kept as they
    are (a round never writes them again), host arrays copied."""

    def __init__(self, fn):
        self.fn, self.n, self.slowest_s, self.slowest = fn, 0, -1.0, None
        self.log = []  # (ms, tasks, padded tasks, iterations) of each solve with tasks

    def __call__(self, *args, **kw):
        t0 = time.perf_counter()
        res = self.fn(*args, **kw)
        dt = time.perf_counter() - t0
        if args[2] > 0:  # n_tasks
            self.n += 1
            self.log.append((dt * 1e3, int(args[2]), int(args[0].shape[0]), res.iterations))
            if dt > self.slowest_s:
                self.slowest_s = dt
                self.slowest = ([a.copy() if isinstance(a, np.ndarray) else a for a in args],
                                dict(kw))
        return res


def solve_busy_share(args, kw, reps: int = 5) -> dict:
    """One round's solve run again: its host wall time (median of ``reps``
    runs, each ending synchronised), then once under torch.profiler (CPU and
    CUDA) for the card's busy time (every device event: kernels, copies,
    fills; they run on one stream), its share of the unprofiled wall time,
    and the host operations that took the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import auction

    walls = []
    for _ in range(reps + 1):  # the first run warms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = auction.solve_transportation_device(*args, **kw)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = float(np.median(walls[1:]))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        auction.solve_transportation_device(*args, **kw)
        torch.cuda.synchronize()
    busy_us, kernels, host = 0.0, {}, {}
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue  # the port's `obs` spans (and their device-side mirrors): not work
        dev = getattr(evt, "device_time_total", 0.0) or 0.0
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            if dev > 0:
                busy_us += dev
                kernels[evt.key[:60]] = dev / 1e3
        elif evt.self_cpu_time_total > 0:
            host[evt.key[:60]] = (evt.self_cpu_time_total / 1e3, evt.count)
    busy_ms = busy_us / 1e3
    return {"tasks": int(args[2]), "iterations": res.iterations, "wall_ms": wall_ms,
            "device_busy_ms": busy_ms, "device_busy_share": busy_ms / wall_ms,
            "device_ms_by_kernel": dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:6]),
            "profiled_host_ms_calls": dict(sorted(host.items(), key=lambda kv: -kv[1][0])[:8])}


def phase_full(device="cuda", n_machines: int = 12_500, duration_s: int = 90) -> dict:
    import torch

    from repro_torch import kernels
    from repro_torch.core import auction
    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    on_card = device == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    solves = _Solves(auction.solve_transportation_device)
    auction.solve_transportation_device = solves
    try:
        kernels.reset_launch_counts()
        sim, m, wall, counters = replay(topo, duration_s, device)
        launches = {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}
    finally:
        auction.solve_transportation_device = solves.fn
    iters = int(counters.get("auction.iterations", 0))
    algo = np.asarray(m.algo_runtime_s, np.float64)
    if not (m.rounds > 0 and m.tasks_placed > 0 and np.isfinite(algo).all()):
        raise AssertionError("full-width replay produced no rounds or non-finite times")
    if (sim.free_slots < 0).any() or (sim.free_slots > topo.slots_per_machine).any():
        raise AssertionError("full-width replay broke slot accounting")
    # On the card every solve with tasks is one launch of the phase kernel,
    # which runs the bid inside it: the bid kernel itself never launches.
    if on_card and not (launches["costmap"] > 0 and solves.n > 0
                        and launches["auction_phase"] == solves.n
                        and launches["auction_bid"] == 0):
        raise AssertionError(f"kernel launches {launches} vs {solves.n} solves with tasks")
    busy = solve_busy_share(*solves.slowest) if on_card else None
    slowest_solves = sorted(solves.log, reverse=True)[:8]
    del solves
    _, rnd, rnd_wall, _ = replay(topo, duration_s, device, backend="random")
    summ = m.summary()
    spans = counters["spans_s"]
    info = {
        "phase": "full",
        "machines": n_machines,
        "duration_s": duration_s,
        "rounds": m.rounds,
        "tasks_placed": m.tasks_placed,
        "tasks_migrated": m.tasks_migrated,
        "auction_iterations": iters,
        "solves_with_tasks": launches["auction_phase"] if on_card else None,
        "launches": launches,
        "wall_s": wall,
        "algo_s_p50": float(np.median(algo)),
        "algo_s_p99": float(np.percentile(algo, 99)),
        "algo_s_max": float(algo.max()),
        "algo_s_sum": float(algo.sum()),
        "solver_auction_s": spans.get("solver.auction", 0.0),
        "sim_build_state_s": spans.get("sim.build_state", 0.0),
        "us_per_auction_iteration": spans.get("solver.auction", 0.0) * 1e6 / max(iters, 1),
        "slowest_solves_ms_tasks_padded_iterations": slowest_solves,
        "slowest_solve_profile": busy,
        "spans_s": spans,
        "max_memory_allocated": int(torch.cuda.max_memory_allocated()) if on_card else None,
        "avg_app_perf_area": summ["avg_app_perf_area"],
        "random_avg_app_perf_area": rnd.summary()["avg_app_perf_area"],
        "random_wall_s": rnd_wall,
    }
    emit(info)
    return info


# --------------------------------------------------------------------- #
# The migration path (paper §7): controller, what-if lanes, device oracle


def scenario_replay(topo, duration_s: int, device: str, mode: str, *,
                    backend: str = "auction_windowed", oracle: bool = True,
                    fixed_algo_s=None):
    """A replay of DYNAMIC_SCENARIO's plane over ``synth_workload(0.6,
    seed SEED)``. ``mode``: ``"on"`` the migration controller with
    `benchmarks/migration_quality.py`'s settings (the scenario's params and
    cadence, QoS threshold 0.95, window 2, hold 30 s, what-if betas);
    ``"off"`` that benchmark's OFF (PolicyParams(p_m=105, p_r=110), no
    controller); ``"migrate"`` the scenario's params and cadence with
    plain migration rounds. Returns (sim, metrics, wall s, counters with
    span seconds and counts, launches, audit events)."""
    from repro_torch import kernels, obs
    from repro_torch.core import latency, policy, scenarios, simulator, workload

    scn = scenarios.get_scenario(DYNAMIC_SCENARIO)
    plane = scn.plane(latency.LatencyPlane.synthesize(topo, duration_s, seed=SEED), duration_s)
    wl = workload.synth_workload(topo, duration_s, seed=SEED, target_utilisation=0.6)
    if mode == "off":
        kw = dict(params=policy.PolicyParams(p_m=105, p_r=110))
    else:
        kw = dict(params=scn.policy_params(p_m=105, p_r=110),
                  **scn.sim_config_kwargs(topo, duration_s, SEED))
        if mode == "on":
            kw.update(migration_controller=True, whatif_betas=WHATIF_BETAS, **QOS)
    cfg = simulator.SimConfig(policy="nomora", backend=backend, device=device, seed=SEED,
                              device_latency=oracle, fixed_algo_s=fixed_algo_s, **kw)
    with obs.scope() as tel:
        sim = simulator.Simulator(wl, plane, cfg)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        metrics = sim.run()
        wall = time.perf_counter() - t0
        launches = {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}
        counters = obs.counters()
        spans, n_spans = {}, {}
        for rec in tel.spans:
            spans[rec.name] = spans.get(rec.name, 0.0) + rec.dur_ns * 1e-9
            n_spans[rec.name] = n_spans.get(rec.name, 0) + 1
        audit = [{k: v for k, v in e.items() if k != "algo_s"} for e in tel.audit]
    counters["spans_s"], counters["span_counts"] = spans, n_spans
    return sim, metrics, wall, counters, launches, audit


CONTROLLER_SERIES = ("controller_improvement_per_round", "degraded_jobs_per_round")
CONTROLLER_SCALARS = ("controller_rounds",)


def _metric_diffs(a, b) -> list:
    fields = SERIES + SCALARS + CONTROLLER_SERIES + CONTROLLER_SCALARS
    diffs = [f for f in fields if getattr(a, f) != getattr(b, f)]
    sa, sb = a.summary(), b.summary()
    return diffs + [k for k in sa
                    if not (sa[k] == sb[k] or (np.isnan(sa[k]) and np.isnan(sb[k])))]


def phase_dynamic_parity(device="cuda", n_machines: int = 1536, duration_s: int = 60) -> dict:
    """The controller with the oracle and what-if lanes, card against CPU:
    every SimMetrics series (the controller's included), summary(), the
    counters and the controller's audit events equal; then the windowed
    backend fed by the oracle without the controller against the
    ``auction`` backend with host rows, on the card."""
    from repro_torch.core.topology import Topology

    topo = Topology(n_machines, 48, 16, slots_per_machine=8)
    _, card, card_s, cc, card_launches, ca = scenario_replay(topo, duration_s, device, "on",
                                                             fixed_algo_s=0.0)
    _, cpu, cpu_s, pc, _, pa = scenario_replay(topo, duration_s, "cpu", "on",
                                               fixed_algo_s=0.0)
    diffs = _metric_diffs(card, cpu)
    strip = ("spans_s", "span_counts")
    if {k: v for k, v in cc.items() if k not in strip} != {
            k: v for k, v in pc.items() if k not in strip}:
        diffs.append("counters")
    if ca != pa:
        diffs.append("audit")
    if diffs:
        raise AssertionError(f"dynamic parity: card and CPU differ in {diffs}")
    if card.controller_rounds == 0:
        raise AssertionError("dynamic parity: the controller never ran")
    _, win, win_s, _, _, _ = scenario_replay(topo, duration_s, device, "migrate",
                                             fixed_algo_s=0.0)
    _, host, host_s, _, _, _ = scenario_replay(topo, duration_s, device, "migrate",
                                               backend="auction", oracle=False,
                                               fixed_algo_s=0.0)
    diffs = _metric_diffs(win, host)
    if diffs:
        raise AssertionError(f"windowed + oracle differs from auction + host rows in {diffs}")
    info = {"phase": "dynamic_parity", "machines": n_machines, "duration_s": duration_s,
            "scenario": DYNAMIC_SCENARIO, "rounds": card.rounds,
            "controller_rounds": card.controller_rounds, "lanes": cc.get("whatif.lanes", 0),
            "tasks_migrated": card.tasks_migrated, "audit_events": len(ca),
            "launches": card_launches, "card_wall_s": card_s, "cpu_wall_s": cpu_s,
            "equal": list(SERIES + SCALARS + CONTROLLER_SERIES + CONTROLLER_SCALARS)
            + ["summary", "counters", "audit"],
            "no_controller": {"rounds": win.rounds, "tasks_migrated": win.tasks_migrated,
                              "windowed_oracle_wall_s": win_s, "auction_host_rows_wall_s": host_s,
                              "equal": True}}
    emit(info)
    return info


def phase_dynamic(device="cuda", n_machines: int = 12_500, duration_s: int = 120,
                  full: dict | None = None) -> dict:
    """The paper's §6 Google cluster under DYNAMIC_SCENARIO's drifting
    hotspot, ON (the controller) and OFF, both with the device oracle and
    measured algo_s."""
    import torch

    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    on_card = device == "cuda"
    out = {"phase": "dynamic", "machines": n_machines, "duration_s": duration_s,
           "scenario": DYNAMIC_SCENARIO}
    for mode in ("on", "off"):
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        sim, m, wall, c, launches, audit = scenario_replay(topo, duration_s, device, mode)
        algo = np.asarray(m.algo_runtime_s, np.float64)
        if not (m.rounds > 0 and m.tasks_placed > 0 and np.isfinite(algo).all()):
            raise AssertionError(f"dynamic {mode}: no rounds or non-finite times")
        if (sim.free_slots < 0).any() or (sim.free_slots > topo.slots_per_machine).any():
            raise AssertionError(f"dynamic {mode}: slot accounting broken")
        solves = int(c.get("window.rounds", 0))
        lanes = int(c.get("whatif.lanes", 0))
        if on_card and not (launches["auction_phase"] == solves + lanes
                            and launches["costmap"] == solves + lanes
                            and launches["auction_bid"] == 0):
            raise AssertionError(f"dynamic {mode}: launches {launches} vs {solves} solves "
                                 f"and {lanes} lane solves")
        st = sim.oracle.stats()
        if not st["floats_per_round"] < n_machines:
            raise AssertionError(f"dynamic {mode}: oracle uploads {st['floats_per_round']} "
                                 f"floats a round, not below M = {n_machines}")
        spans, counts = c["spans_s"], c["span_counts"]
        row = {
            "rounds": m.rounds, "controller_rounds": m.controller_rounds,
            "solves": solves, "lanes": lanes, "tasks_placed": m.tasks_placed,
            "tasks_migrated": m.tasks_migrated,
            "controller_reverts": int(c.get("controller.reverts", 0)),
            "qos_triggers": int(c.get("qos.triggers", 0)),
            "auction_iterations": int(c.get("auction.iterations", 0)),
            "launches": launches, "wall_s": wall,
            "algo_s_p50": float(np.median(algo)),
            "algo_s_p99": float(np.percentile(algo, 99)),
            "algo_s_max": float(algo.max()),
            "sim_build_state_s": spans.get("sim.build_state", 0.0),
            "full_sim_build_state_s": None if full is None else full["sim_build_state_s"],
            "whatif_s": spans.get("round_program.whatif", 0.0),
            "whatif_calls": counts.get("round_program.whatif", 0),
            "whatif_ms_per_call": (spans.get("round_program.whatif", 0.0) * 1e3
                                   / max(counts.get("round_program.whatif", 0), 1)),
            "advance_s": spans.get("round_program.advance", 0.0),
            "spans_s": spans,
            "oracle": st,
            "max_memory_allocated": int(torch.cuda.max_memory_allocated()) if on_card else None,
            "avg_app_perf_area": m.summary()["avg_app_perf_area"],
            "audit_events": len(audit),
        }
        out[mode] = row
    if out["on"]["controller_rounds"] == 0:
        raise AssertionError("dynamic: no controller round ran")
    emit(out)
    return out


# --------------------------------------------------------------------- #
# The rest of the scheduler: MCMF, trace replay with streaming metrics,
# the online ScheduleService, sweeps


def _summary_diffs(a: dict, b: dict) -> list:
    if a.keys() != b.keys():
        return ["<keys>"]
    return [k for k in a if not (a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])))]


def _counted(fn):
    """``fn()`` under fresh telemetry and launch counts: (its result, the
    counters with host seconds by span name under "spans_s", the scheduler
    kernels' launches)."""
    from repro_torch import kernels, obs

    with obs.scope() as tel:
        kernels.reset_launch_counts()
        out = fn()
        launches = {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}
        counters = obs.counters()
        spans: dict = {}
        for rec in tel.spans:
            spans[rec.name] = spans.get(rec.name, 0.0) + rec.dur_ns * 1e-9
    counters["spans_s"] = spans
    return out, counters, launches


def phase_mcmf_parity(device="cuda", n_machines: int = MCMF_PARITY_MACHINES,
                      duration_s: int = 60) -> dict:
    """The Quincy graph and MCMF (its Bellman-Ford on ``device``) in a
    replay with preemption and migration every 30 s, card against CPU:
    every SimMetrics series and summary() equal."""
    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    runs = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        (_, m, _, _), c, launches = _counted(
            lambda dev=dev: replay(topo, duration_s, dev, backend="mcmf", fixed_algo_s=0.0))
        runs[dev] = (m, time.perf_counter() - t0, c, launches)
    (card, card_s, c, launches), (cpu, cpu_s, _, _) = runs[device], runs["cpu"]
    diffs = [f for f in SERIES + SCALARS if getattr(card, f) != getattr(cpu, f)]
    diffs += _summary_diffs(card.summary(), cpu.summary())
    if diffs or card.rounds == 0:
        raise AssertionError(f"mcmf_parity: card and CPU differ in {diffs} "
                             f"(rounds {card.rounds})")
    solver_s = c["spans_s"].get("solver.mcmf", 0.0)
    info = {"phase": "mcmf_parity", "machines": n_machines, "duration_s": duration_s,
            "rounds": card.rounds, "tasks_placed": card.tasks_placed,
            "tasks_migrated": card.tasks_migrated,
            "augmenting_paths": int(c.get("mcmf.augmentations", 0)),
            "bf_iterations": int(c.get("mcmf.bf_iterations", 0)),
            "host_syncs": int(c.get("mcmf.host_syncs", 0)),
            "solver_mcmf_s": solver_s, "solver_mcmf_s_per_round": solver_s / card.rounds,
            "card_wall_s": card_s, "cpu_wall_s": cpu_s, "launches": launches,
            "equal": list(SERIES + SCALARS) + ["summary"]}
    emit(info)
    return info


def phase_mcmf_round(device="cuda", n_machines: int = 12_500, n_tasks: int = 64,
                     n_jobs: int = 19) -> dict:
    """One full-cluster round (the round phase's synthetic state at
    ``n_tasks``) through the paper's Quincy graph and MCMF on ``device``
    and through the exact auction (no tie jitter): equal objectives, no
    machine over its free slots."""
    from repro_torch.core import flow_network, latency, mcmf, perf_model, scheduler_backend
    from repro_torch.core.policy import dense_costs
    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    plane = latency.LatencyPlane.synthesize(topo, 4, seed=SEED)
    state = full_width_round_state(topo, plane, n_tasks, n_jobs, 2, SEED)
    params, lut = _policy(), perf_model.perf_lut_table()
    ctx = scheduler_backend.RoundContext(rng=np.random.default_rng(SEED),
                                         task_counts=np.zeros(n_machines, np.int64),
                                         n_ready=n_tasks)
    costs = dense_costs(state, topo, params, lut)
    t0 = time.perf_counter()
    g = flow_network.build_flow_graph(state, topo, params, costs)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (fr, c, _) = _counted(lambda: mcmf.min_cost_max_flow(
        g.src, g.dst, g.cap, g.cost, g.source, g.sink, g.n_nodes, device=device))
    solve_s = time.perf_counter() - t0
    backend = scheduler_backend.MCMFBackend(params, topo, lut, device=device)
    p_mcmf = backend.place(state, ctx)
    exact = scheduler_backend.AuctionBackend(params, topo, lut, tie_jitter=0, exact=True,
                                             device=device)
    t0 = time.perf_counter()
    (p_auc, ca, launches) = _counted(lambda: exact.place(state, ctx))
    auction_s = time.perf_counter() - t0
    if not (p_mcmf.objective == p_auc.objective == fr.total_cost
            and fr.total_flow == n_tasks):
        raise AssertionError(f"mcmf_round: objectives {p_mcmf.objective} (mcmf) vs "
                             f"{p_auc.objective} (exact auction), flow {fr.total_flow}")
    for name, p in (("mcmf", p_mcmf), ("auction", p_auc)):
        on = p.cols[(p.cols >= 0) & (p.cols < n_machines)]
        if (np.bincount(on, minlength=n_machines) > state.free_slots).any():
            raise AssertionError(f"mcmf_round: {name} overfills a machine")
    info = {"phase": "mcmf_round", "machines": n_machines, "tasks": n_tasks, "jobs": n_jobs,
            "nodes": g.n_nodes, "arcs": int(len(g.src)), "graph_build_s": build_s,
            "augmenting_paths": int(c.get("mcmf.augmentations", 0)),
            "bf_iterations": int(c.get("mcmf.bf_iterations", 0)),
            "host_syncs": int(c.get("mcmf.host_syncs", 0)), "solve_s": solve_s,
            "objective": int(p_mcmf.objective), "exact_auction_s": auction_s,
            "exact_auction_iterations": int(ca.get("auction.iterations", 0)),
            "launches": launches, "objectives_equal": True}
    emit(info)
    return info


def _trace_replay(topo, cursor, duration_s: int, device: str, **cfg):
    from repro_torch.core import latency, simulator

    plane = latency.LatencyPlane.synthesize(topo, duration_s, seed=SEED)
    config = simulator.SimConfig(policy="nomora", seed=SEED, device=device, **cfg)
    sim = simulator.Simulator(cursor, plane, config)
    t0 = time.perf_counter()
    metrics = sim.run()
    return sim, metrics, time.perf_counter() - t0


def phase_trace(device="cuda", n_machines: int = 1536, duration_s: int = 60,
                full_machines: int = 12_500, full_duration_s: int = 90) -> dict:
    """(a) A `synth_trace` cursor with streaming metrics, card against CPU
    (equal summaries), and the cursor's replay with full SimMetrics against
    the replay of `materialize(cursor)`, both on the card (equal series);
    (b) the committed cluster-data v2 fixture through `CsvTraceCursor`,
    card against CPU; (c) the `google_trace` scenario at the full cluster
    on the card: wall, sim.build_state, algo_s quantiles from the streaming
    metrics, memory."""
    import resource

    import torch

    from repro_torch.core import scenarios, trace
    from repro_torch.core.metrics_stream import StreamingSimMetrics
    from repro_torch.core.topology import google_topology

    topo = google_topology(n_machines)
    cur = trace.synth_trace(topo, duration_s, seed=SEED, target_utilisation=0.6,
                            window_s=TRACE_WINDOW_S)
    kw = dict(fixed_algo_s=0.0, params=_policy(), migration_interval_s=30)
    walls, summaries = {}, {}
    for dev in (device, "cpu"):
        _, m, walls[dev] = _trace_replay(topo, cur, duration_s, dev, streaming_metrics=True,
                                         **kw)
        if not isinstance(m, StreamingSimMetrics) or m.tasks_placed == 0:
            raise AssertionError("trace: the streamed replay placed nothing")
        summaries[dev] = m.summary()
    diffs = _summary_diffs(summaries[device], summaries["cpu"])
    _, streamed, _ = _trace_replay(topo, cur, duration_s, device, **kw)
    _, mat, _ = _trace_replay(topo, trace.materialize(cur), duration_s, device, **kw)
    diffs += [f"materialized.{f}" for f in SERIES + SCALARS
              if getattr(streamed, f) != getattr(mat, f)]
    fixture = ROOT / "tests" / "data" / "task_events_fixture.csv.gz"
    fx_topo = google_topology(96)
    fx, fx_jobs = {}, 0
    for dev in (device, "cpu"):
        csv = trace.CsvTraceCursor(topo=fx_topo, duration_s=120, paths=(str(fixture),))
        fx_sim, fx[dev], _ = _trace_replay(fx_topo, csv, 120, dev, fixed_algo_s=0.0)
        fx_jobs = fx_sim.jt.n
    diffs += [f"fixture.{f}" for f in SERIES + SCALARS
              if getattr(fx[device], f) != getattr(fx["cpu"], f)]
    if diffs or fx[device].tasks_placed == 0:
        raise AssertionError(f"trace: card and CPU (or streamed and materialized) differ "
                             f"in {diffs}")
    # (c) the paper's cluster on the google_trace scenario, measured algo_s.
    gt = scenarios.get_scenario("google_trace")
    full_topo = google_topology(full_machines)
    gcur = trace.synth_trace(full_topo, full_duration_s, seed=SEED, target_utilisation=0.6,
                             **gt.trace_kwargs)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    (sim, m, wall), c, launches = _counted(lambda: _trace_replay(
        full_topo, gcur, full_duration_s, device,
        **gt.sim_config_kwargs(full_topo, full_duration_s, SEED)))
    s = m.summary()
    if not (isinstance(m, StreamingSimMetrics) and m.rounds > 0 and m.tasks_placed > 0
            and np.isfinite(s["algo_runtime_s_p99"])):
        raise AssertionError("trace: the google_trace replay ran no rounds")
    if device == "cuda" and not (launches["costmap"] > 0 and launches["auction_phase"] > 0
                                 and launches["auction_bid"] == 0):
        raise AssertionError(f"trace: google_trace launches {launches}")
    info = {"phase": "trace",
            "streamed": {"machines": n_machines, "duration_s": duration_s,
                         "window_s": TRACE_WINDOW_S, "jobs": cur.n_jobs_hint,
                         "tasks_placed": int(summaries[device]["tasks_placed"]),
                         "card_wall_s": walls[device], "cpu_wall_s": walls["cpu"],
                         "equal": ["summary", "streamed == materialized (SimMetrics)"]},
            "fixture": {"jobs": fx_jobs, "tasks_placed": fx[device].tasks_placed,
                        "equal": "SimMetrics"},
            "google_trace": {
                "machines": full_machines, "duration_s": full_duration_s,
                "rounds": m.rounds, "tasks_placed": m.tasks_placed, "wall_s": wall,
                "sim_build_state_s": c["spans_s"].get("sim.build_state", 0.0),
                "solver_auction_s": c["spans_s"].get("solver.auction", 0.0),
                "algo_s_p50": s["algo_runtime_s_p50"], "algo_s_p99": s["algo_runtime_s_p99"],
                "algo_s_max": s["algo_runtime_s_max"],
                "avg_app_perf_area": s["avg_app_perf_area"], "launches": launches,
                "max_memory_allocated": (int(torch.cuda.max_memory_allocated())
                                         if device == "cuda" else None),
                "ru_maxrss_kb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss}}
    info["launches"] = launches
    emit(info)
    return info


def phase_serving(device="cuda", n_machines: int = 12_500, rate_jobs_s: float = 2.0,
                  horizon_s: int = 60) -> dict:
    """(a) The ``smoke`` preset on the card, 8 rounds recorded: replayed
    through a fresh per-round ``auction`` backend with 0 mismatches, and no
    kernel built or loaded after warm-up; (b) a `ScheduleService` on the
    paper's Google layout through ``auction_windowed`` and the device
    latency oracle: wall-clock decision latency (measured, never compared),
    the queue, and no kernel built or loaded after warm-up (the rate halves
    once if the queue does not drain)."""
    from repro_torch import obs
    from repro_torch.core import scenarios, serving

    smoke_cfg = serving.ServingConfig(**scenarios.get_serving_preset("smoke").config_kwargs,
                                      record_rounds=8, device=device)
    with obs.scope():
        smoke = serving.ScheduleService(smoke_cfg).run()
    if not (smoke.replay_mismatches == 0 and smoke.jit_compiles_post_warmup == 0.0
            and smoke.drained):
        raise AssertionError(f"serving: smoke {smoke}")
    rates, report = [], None
    for rate in (rate_jobs_s, rate_jobs_s / 2):
        cfg = serving.ServingConfig(
            backend="auction_windowed", device_latency=True, n_machines=n_machines,
            machines_per_rack=48, racks_per_pod=16, batch_tasks=512, horizon_s=horizon_s,
            rate_jobs_s=rate, device=device)
        report, c, launches = _counted(lambda cfg=cfg: serving.ScheduleService(cfg).run())
        rates.append(rate)
        if report.drained:
            break
    if not (report.drained and report.jit_compiles_post_warmup == 0.0):
        raise AssertionError(f"serving: {report}")
    if device == "cuda" and not (launches["auction_phase"] > 0
                                 and launches["auction_bid"] == 0):
        raise AssertionError(f"serving: launches {launches}")
    info = {"phase": "serving",
            "smoke": {"replay_mismatches": smoke.replay_mismatches,
                      "compiles_post_warmup": smoke.jit_compiles_post_warmup,
                      "tasks_placed": smoke.tasks_placed},
            "machines": n_machines, "rates_tried": rates, **dataclasses.asdict(report),
            "launches": launches, "spans_s": c["spans_s"]}
    emit(info)
    return info


def phase_sweep(device="cuda", n_machines: int = 384, duration_s: int = 60) -> dict:
    """A (policy x seed) grid: `run_sweep` with a 2-worker spawn pool (each
    worker on the card) equal to one process, and shards (0, 2) + (1, 2)
    merged equal to the single run, wall-clock fields dropped."""
    from repro_torch.core import sweep

    spec = sweep.SweepSpec(n_machines=n_machines, machines_per_rack=48, racks_per_pod=16,
                           slots_per_machine=8, duration_s=duration_s,
                           policies=("nomora:auction", "random"), seeds=(0, 1),
                           fixed_algo_s=0.0)

    def comparable(res):
        d = res.to_jsonable()
        d.pop("wall_s")
        for cell in d["cells"]:
            cell.pop("wall_s")
        return json.dumps(d, sort_keys=True)

    # Telemetry stays off: spawned workers would record none, and a cell's
    # counters are part of its saved result.
    from repro_torch import kernels

    kernels.reset_launch_counts()
    single = sweep.run_sweep(spec, device=device)
    launches = {k: kernels.launch_counts()[k] for k in SCHEDULER_KERNELS}
    t0 = time.perf_counter()
    pool = sweep.run_sweep(spec, workers=2, device=device)
    pool_s = time.perf_counter() - t0
    merged = sweep.merge_sweep_results(
        [sweep.run_sweep(spec, shard=(i, 2), device=device) for i in range(2)])
    if not comparable(single) == comparable(pool) == comparable(merged):
        raise AssertionError("sweep: workers=2 or the merged shards differ from one run")
    info = {"phase": "sweep", "machines": n_machines, "duration_s": duration_s,
            "cells": len(single.cells), "wall_s": single.wall_s, "pool_wall_s": pool_s,
            "merged_shards_wall_s": merged.wall_s, "launches": launches,
            "avg_app_perf_area": {c.policy + f"/{c.seed}": c.summary["avg_app_perf_area"]
                                  for c in single.cells},
            "equal": ["workers=2", "shards (0, 2) + (1, 2)"]}
    emit(info)
    return info


# --------------------------------------------------------------------- #
# The LM serving path: attention kernels, full-width serve, parity


_TORCH_DTYPES = {"f32": "float32", "bf16": "bfloat16"}


def _dt(name):
    import torch

    return getattr(torch, _TORCH_DTYPES[name])


def _att_peak(*dtypes) -> float:
    """Peak rate for the inputs' type: f32 CUDA cores unless all are bf16."""
    return BF16_OPS_PER_S if all(d == "bf16" for d in dtypes) else F32_OPS_PER_S


# TF32 passes per operation that flash's tensor-core products take: 3 with
# f32 inputs (3xTF32); bf16 values are exact in TF32, so 1 for Q K^T and 2
# for P V (P is f32), 1.5 on average. Reported beside the bound, not in it.
FLASH_TF32_PASSES = {"f32": 3.0, "bf16": 1.5}


def flash_bound(B, H, KVH, S, D, dt: str, causal: bool = True) -> dict:
    """bound_ms / bound_by of the function on the tensor cores: f32-accurate
    products from f32 inputs take 3 TF32 passes (495 TFLOP/s), bf16 inputs
    run at the bf16 rate. Beside it the bound of the kernel's earlier
    CUDA-core design (the same as bound_ms for bf16) and the kernel's
    TF32 passes."""
    esize = 4 if dt == "f32" else 2
    n_bytes = (2 * B * H * S * D + 2 * B * KVH * S * D) * esize  # q, o; k, v
    pairs = S * (S + 1) // 2 if causal else S * S
    ops = 4 * B * H * D * pairs
    cuda_core = bound_ms(n_bytes, ops, _att_peak(dt))
    b_ms, b_by = bound_ms(n_bytes, 3 * ops, TF32_OPS_PER_S) if dt == "f32" else cuda_core
    return {"bound_ms": b_ms, "bound_by": b_by, "tf32_passes": FLASH_TF32_PASSES[dt],
            "cuda_core_bound_ms": cuda_core[0]}


def flash_bwd_bound(B, H, KVH, S, D, causal: bool = True) -> dict:
    """bound_ms / bound_by of flash's f32 backward on the tensor cores: the
    5 products the gradients need (S and dP recomputed, dV, dK, dQ; 2 B H D
    operations a (query, key) pair each) in 3 TF32 passes, or its bytes (q,
    o, dO, dq; k, v, dk, dv; the log-sum-exp and Δ). Beside it design_ms:
    the kernel's 7 products (its dQ pass recomputes S and dP)."""
    n_bytes = (4 * B * H * S * D + 4 * B * KVH * S * D + 2 * B * H * S) * 4
    pairs = S * (S + 1) // 2 if causal else S * S
    product = 2 * B * H * D * pairs
    b_ms, b_by = bound_ms(n_bytes, 3 * 5 * product, TF32_OPS_PER_S)
    return {"bound_ms": b_ms, "bound_by": b_by,
            "design_ms": bound_ms(n_bytes, 3 * 7 * product, TF32_OPS_PER_S)[0]}


def decode_bound(H, KVH, D, lengths, q_dt: str, c_dt: str):
    csize = 4 if c_dt == "f32" else 2
    qsize = 4 if q_dt == "f32" else 2
    total = int(np.sum(lengths))
    B = len(lengths)
    n_bytes = 2 * total * KVH * D * csize + 2 * B * H * D * qsize
    return bound_ms(n_bytes, 4 * total * H * D, _att_peak(q_dt, c_dt))


def _sdpa_decode_args(q, k_cache, v_cache, lengths):
    """scaled_dot_product_attention's arguments for one-token decode: the
    cache cast to q's dtype and a boolean length mask (made here, outside
    any timed window)."""
    import torch

    S = k_cache.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None].long())
    return (q[:, :, None, :], k_cache.to(q.dtype), v_cache.to(q.dtype), mask[:, None, None, :])


def _agree(what: str, got, want, tol: float) -> dict:
    """Raises unless |got - want| <= tol + tol * |want| everywhere and got is
    finite; returns the max abs error and the tolerance."""
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    if not (bool(diff.le(tol + tol * want.float().abs()).all()) and got.isfinite().all()):
        raise AssertionError(f"{what} disagrees with its plain version: max abs err {err}, "
                             f"tolerance {tol}")
    return {"max_abs_err": err, "tolerance": tol}


def check_flash(q, k, v, dt: str) -> dict:
    from repro_torch.kernels.flash_attention import kernel_cuda, ref

    return _agree(f"flash_attention ({dt})", kernel_cuda.flash_attention_cuda(q, k, v),
                  ref.attention_ref(q, k, v), ATT_TOL[dt])


def check_decode(q, k_cache, v_cache, lengths, q_dt: str, c_dt: str) -> dict:
    from repro_torch.kernels.decode_attention import kernel_cuda, ref

    return _agree(f"decode_attention ({q_dt} q, {c_dt} cache)",
                  kernel_cuda.decode_attention_cuda(q, k_cache, v_cache, lengths),
                  ref.decode_attention_ref(q, k_cache, v_cache, lengths), ATT_TOL[q_dt])


def check_decode_lse(q, kc, vc, valid, shards: int, c_dt: str) -> dict:
    """The decode kernel with ``return_lse`` on each of ``shards`` position
    shards of a cache (as the ``model`` ranks hold a sequence-split one;
    the valid count of shard r is clamp(valid - r * S / shards, 0, S /
    shards)): output and log-sum-exp against the plain version's (-inf and
    a zero output where a shard holds nothing), and the shards merged by
    `merge_partials` against the plain version over the whole cache. Times
    shard 0's call with the log-sum-exp beside the same call without."""
    import torch

    from repro_torch.kernels.decode_attention import kernel_cuda as dec_k
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.models.attention import merge_partials

    B, H, D = q.shape
    KVH, S = kc.shape[1], kc.shape[2]
    size = S // shards
    parts, errs, empty = [], {"out": 0.0, "lse": 0.0}, 0
    for r in range(shards):
        n_np = np.clip(valid - r * size, 0, size).astype(np.int32)
        n = torch.from_numpy(n_np).to("cuda")
        ks = kc[:, :, r * size:(r + 1) * size].contiguous()
        vs = vc[:, :, r * size:(r + 1) * size].contiguous()
        o, lse = dec_k.decode_attention_cuda(q, ks, vs, n, return_lse=True)
        po, plse = dec_ref.decode_attention_ref(q, ks, vs, n, return_lse=True)
        none = torch.from_numpy(n_np == 0).to("cuda")
        empty += int(none.sum())
        if not (torch.isneginf(lse[none]).all() and not o[none].any()):
            raise AssertionError("decode_attention lse: an empty shard's row is not (0, -inf)")
        errs["out"] = max(errs["out"], _agree("decode_attention lse output", o, po,
                                              ATT_TOL["f32"])["max_abs_err"])
        errs["lse"] = max(errs["lse"], _agree("decode_attention lse", lse[~none], plse[~none],
                                              ATT_TOL["f32"])["max_abs_err"])
        parts.append((o, lse, ks, vs, n, n_np))
    merged = merge_partials(torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts]),
                            lambda t: t.amax(0, keepdim=True),
                            lambda t: t.sum(0, keepdim=True))[0]
    whole = dec_ref.decode_attention_ref(q, kc, vc, torch.from_numpy(valid).to("cuda"))
    merge_err = _agree("decode_attention merged shards", merged, whole,
                       ATT_TOL["f32"])["max_abs_err"]
    _, _, ks, vs, n, n_np = parts[0]
    total = int(n_np.sum())  # shard 0's valid positions; the lse is (B, H) float32 more
    n_bytes = 2 * total * KVH * D * (4 if c_dt == "f32" else 2) + 2 * B * H * D * 4 + B * H * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * total * H * D, _att_peak("f32", c_dt))
    return {"shape": [B, H, KVH, S, D], "shards": shards, "cache_dtype": c_dt,
            "valid": valid.tolist(), "empty_shard_rows": empty,
            "max_abs_err": max(errs.values()), "out_max_abs_err": errs["out"],
            "lse_max_abs_err": errs["lse"], "merged_max_abs_err": merge_err,
            "tolerance": ATT_TOL["f32"],
            "kernel_ms": time_ms(lambda: dec_k.decode_attention_cuda(q, ks, vs, n,
                                                                     return_lse=True)),
            "device_ms": device_ms(lambda: dec_k.decode_attention_cuda(q, ks, vs, n,
                                                                       return_lse=True),
                                   DECODE_KERNEL),
            "kernel_ms_without_lse": time_ms(lambda: dec_k.decode_attention_cuda(q, ks, vs, n)),
            "plain_ms": time_ms(lambda: dec_ref.decode_attention_ref(q, ks, vs, n,
                                                                     return_lse=True)),
            "bound_ms": b_ms, "bound_by": b_by,
            **_flex_decode_lse(q, ks, vs, n, o=parts[0][0], lse=parts[0][1])}


def _flex_decode_lse(q, ks, vs, n, o, lse) -> dict:
    """The yardstick of the log-sum-exp row: torch's ``flex_attention``
    (compiled), one call that returns the output and the log-sum-exp of
    one-token attention over a cache shard, positions at or past ``n[b]``
    masked by a block mask (made outside the timed window, so that empty
    blocks are skipped), GQA by ``enable_gqa``, the cache cast to q's
    dtype as the sdpa rows cast it. Its time, compile seconds, and its
    distance from the kernel's ``o`` and ``lse`` (rows with a valid
    position), which nothing gates: the port never calls it."""
    import torch

    # Inductor's and Triton's caches inside the checkout's ignored build/.
    os.environ.setdefault("TORCHINDUCTOR_CACHE_DIR", str(ROOT / "build" / "inductor"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    from torch.nn.attention import flex_attention as fa

    B, S = ks.shape[0], ks.shape[2]
    block_mask = fa.create_block_mask(lambda b, h, q_idx, kv_idx: kv_idx < n[b], B, None, 1, S,
                                      device=q.device)
    qf, kf, vf = q[:, :, None], ks.to(q.dtype), vs.to(q.dtype)
    flex = torch.compile(fa.flex_attention, dynamic=False)
    if hasattr(fa, "AuxRequest"):
        def call():
            out, aux = flex(qf, kf, vf, block_mask=block_mask, enable_gqa=True,
                            return_aux=fa.AuxRequest(lse=True))
            return out, aux.lse
    else:
        def call():
            return flex(qf, kf, vf, block_mask=block_mask, enable_gqa=True, return_lse=True)
    t0 = time.perf_counter()
    lo, llse = call()
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t0
    some = (n > 0)
    return {"library_ms": time_ms(call), "library": "torch.nn.attention.flex_attention "
                                                    "(torch.compile, block mask, enable_gqa, "
                                                    "log-sum-exp returned; yardstick only)",
            "library_compile_s": compile_s,
            "library_out_max_abs_diff": float((lo[:, :, 0].float() - o.float()).abs().max()),
            "library_lse_max_abs_diff": float((llse[some][..., 0].float()
                                               - lse[some].float()).abs().max())}


def phase_attention_kernels() -> dict:
    """Both attention kernels against their plain versions at the serving
    shapes; the first row of each is the dtype combination serving uses.
    Then the decode kernel's log-sum-exp and the merge of two position
    shards at qwen3-0.6b's and recurrentgemma-2b's serving shapes."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel_cuda as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref

    cfg = configs.get_config(SERVE_ARCH)
    B, H, KVH, D = SERVE_REQUESTS, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S, s_max = SERVE_PROMPT, SERVE_PROMPT + SERVE_GEN
    rng = np.random.default_rng(SEED)
    out = {"flash_attention": [], "decode_attention": []}

    def randn(shape, dt):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32)).to("cuda", _dt(dt))

    for dt in ("f32", "bf16"):
        q, k, v = randn((B, H, S, D), dt), randn((B, KVH, S, D), dt), randn((B, KVH, S, D), dt)
        row = {"shape": [B, H, KVH, S, D], "dtype": dt, "causal": True,
               **check_flash(q, k, v, dt)}
        row.update(
            kernel_ms=time_ms(lambda: fa_k.flash_attention_cuda(q, k, v)),
            device_ms=device_ms(lambda: fa_k.flash_attention_cuda(q, k, v),
                                ("flash_attention_kernel",)),
            plain_ms=time_ms(lambda: fa_ref.attention_ref(q, k, v)),
            **flash_bound(B, H, KVH, S, D, dt),
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)),
        )
        out["flash_attention"].append(row)
        del q, k, v

    # Ragged valid lengths around the serving run's (1,025 .. 1,088).
    lengths_np = rng.integers(S + 1, s_max + 1, size=B).astype(np.int32)
    lengths_np[0], lengths_np[-1] = S + 1, s_max
    lengths = torch.from_numpy(lengths_np).to("cuda")
    for q_dt, c_dt in (("f32", "bf16"), ("bf16", "bf16"), ("f32", "f32")):
        q = randn((B, H, D), q_dt)
        kc, vc = randn((B, KVH, s_max, D), c_dt), randn((B, KVH, s_max, D), c_dt)
        row = {"shape": [B, H, KVH, s_max, D], "q_dtype": q_dt, "cache_dtype": c_dt,
               "lengths": lengths_np.tolist(), **check_decode(q, kc, vc, lengths, q_dt, c_dt)}
        b_ms, b_by = decode_bound(H, KVH, D, lengths_np, q_dt, c_dt)
        lib_args = _sdpa_decode_args(q, kc, vc, lengths)
        row.update(
            **decode_times(q, kc, vc, lengths),
            plain_ms=time_ms(lambda: dec_ref.decode_attention_ref(q, kc, vc, lengths)),
            bound_ms=b_ms, bound_by=b_by,
            library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                *lib_args[:3], attn_mask=lib_args[3], enable_gqa=True)),
        )
        out["decode_attention"].append(row)
        del q, kc, vc, lib_args

    # A head_dim no kernel is compiled for: flash in f32, decode with an f32
    # query against a bf16 cache.
    B, H, KVH, S, D = ODD_HEAD_DIM_SHAPE
    q, k, v = randn((B, H, S, D), "f32"), randn((B, KVH, S, D), "f32"), randn((B, KVH, S, D), "f32")
    row = {"shape": [B, H, KVH, S, D], "dtype": "f32", "causal": True,
           **check_flash(q, k, v, "f32")}
    row.update(
        kernel_ms=time_ms(lambda: fa_k.flash_attention_cuda(q, k, v)),
        device_ms=device_ms(lambda: fa_k.flash_attention_cuda(q, k, v),
                            ("flash_attention_kernel",)),
        plain_ms=time_ms(lambda: fa_ref.attention_ref(q, k, v)),
        **flash_bound(B, H, KVH, S, D, "f32"),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)),
    )
    out["flash_attention"].append(row)
    lengths_np = np.array([S, S // 2 + 1], np.int32)
    lengths = torch.from_numpy(lengths_np).to("cuda")
    q = randn((B, H, D), "f32")
    kc, vc = randn((B, KVH, S, D), "bf16"), randn((B, KVH, S, D), "bf16")
    b_ms, b_by = decode_bound(H, KVH, D, lengths_np, "f32", "bf16")
    lib_args = _sdpa_decode_args(q, kc, vc, lengths)
    out["decode_attention"].append({
        "shape": [B, H, KVH, S, D], "q_dtype": "f32", "cache_dtype": "bf16",
        "lengths": lengths_np.tolist(), **check_decode(q, kc, vc, lengths, "f32", "bf16"),
        **decode_times(q, kc, vc, lengths),
        "plain_ms": time_ms(lambda: dec_ref.decode_attention_ref(q, kc, vc, lengths)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *lib_args[:3], attn_mask=lib_args[3], enable_gqa=True)),
    })
    del q, k, v, kc, vc, lib_args

    # Two position shards of qwen3-0.6b's cache (every query head over
    # each) and of recurrentgemma-2b's ring: rows whose valid count stops in
    # shard 0 leave shard 1 empty.
    out["decode_attention_lse"] = []
    for arch, S in ((SERVE_ARCH, SERVE_PROMPT + SERVE_GEN), ("recurrentgemma-2b", 2048)):
        c = configs.get_config(arch)
        q = randn((SERVE_REQUESTS, c.n_heads, c.head_dim), "f32")
        kc, vc = (randn((SERVE_REQUESTS, c.n_kv_heads, S, c.head_dim), "bf16")
                  for _ in range(2))
        valid = rng.integers(1, S + 1, size=SERVE_REQUESTS).astype(np.int32)
        valid[:3] = (1, S // 2 - 5, S // 2)
        valid[-1] = S
        out["decode_attention_lse"].append({"arch": arch, **check_decode_lse(
            q, kc, vc, valid, TP_SIZE, "bf16")})
        del q, kc, vc

    emit({"phase": "attention_kernels", "tolerance": ATT_TOL,
          "library": "torch.nn.functional.scaled_dot_product_attention (yardstick only)",
          "kernels": out})
    return out


def rglru_bound(B, T, D, dt: str = "f32", with_h0: bool = False):
    esize = 4 if dt == "f32" else 2
    n_bytes = 3 * B * T * D * esize + B * D * 4 * (2 if with_h0 else 1)  # la, gx, out; h
    return bound_ms(n_bytes, RGLRU_OPS * B * T * D)


def rwkv6_bound(B, H, T, N, dt: str = "f32", with_s0: bool = False):
    esize = 4 if dt == "f32" else 2
    n_bytes = (4 * esize + 4) * B * H * T * N + H * N * 4  # r, k, v, out; w; u
    n_bytes += B * H * N * N * 4 * (2 if with_s0 else 1)  # states
    return bound_ms(n_bytes, RWKV_OPS * B * H * T * N * N)


def check_rglru(la, gx, h0=None) -> dict:
    """The kernel against its plain version: within the tolerance, and
    whether states and final state are equal bit for bit (reported)."""
    import torch

    from repro_torch.kernels.rglru_scan import kernel_cuda, ref

    got, want = kernel_cuda.rglru_scan_cuda(la, gx, h0), ref.rglru_scan_ref(la, gx, h0)
    tol = SCAN_TOL["rglru_scan"]
    out = _agree("rglru_scan (states)", got[0], want[0], tol)
    out["max_abs_err"] = max(out["max_abs_err"],
                             _agree("rglru_scan (final)", got[1], want[1], tol)["max_abs_err"])
    out["bit_equal"] = bool(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
    return out


def check_rwkv6(r, k, v, w, u, s0=None) -> dict:
    """The kernel against its plain version; with ``s0`` also updated in
    place (state_out=s0 on a copy), as decode does."""
    import torch

    from repro_torch.kernels.rwkv6_scan import kernel_cuda, ref

    tol = SCAN_TOL["rwkv6_scan"]
    want = ref.rwkv6_scan_ref(r, k, v, w, u, s0)
    got = kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u, s0)
    errs = [_agree("rwkv6_scan (out)", got[0], want[0], tol)["max_abs_err"],
            _agree("rwkv6_scan (state)", got[1], want[1], tol)["max_abs_err"]]
    if s0 is not None:
        state = s0.clone()
        o2, _ = kernel_cuda.rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state)
        if not (torch.equal(o2, got[0]) and torch.equal(state, got[1])):
            raise AssertionError("rwkv6_scan in place differs from rwkv6_scan out of place")
    return {"max_abs_err": max(errs), "tolerance": tol}


def phase_recurrent_kernels() -> dict:
    """The scans, and the attention kernels at recurrentgemma-2b's shapes,
    against their plain versions; the first row of each is the serving
    path's main shape."""
    import torch
    import torch.nn.functional as F

    from repro_torch import configs
    from repro_torch.kernels.decode_attention import ref as dec_ref
    from repro_torch.kernels.flash_attention import kernel_cuda as fa_k
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import kernel_cuda as rg_k
    from repro_torch.kernels.rglru_scan import ref as rg_ref
    from repro_torch.kernels.rwkv6_scan import kernel_cuda as rk_k
    from repro_torch.kernels.rwkv6_scan import ref as rk_ref

    rng = np.random.default_rng(SEED)
    out = {"rglru_scan": [], "rwkv6_scan": [], "flash_attention": [], "decode_attention": []}

    def randn(shape, scale=1.0, dt=torch.float32):
        x = rng.normal(0, scale, shape).astype(np.float32)
        return torch.from_numpy(x).to("cuda", dt)

    def uniform(lo, hi, shape):
        return torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to("cuda")

    plain_reps = dict(reps=3, per_rep=1)  # the plain scans loop over T in Python
    for i, (B, T, D) in enumerate(RGLRU_SHAPES):
        la, gx = -uniform(0.001, 2.0, (B, T, D)), randn((B, T, D))
        h0 = randn((B, D), 0.3) if i else None
        b_ms, b_by = rglru_bound(B, T, D, with_h0=h0 is not None)
        out["rglru_scan"].append({
            "shape": [B, T, D], "h0": h0 is not None, **check_rglru(la, gx, h0),
            "kernel_ms": time_ms(lambda: rg_k.rglru_scan_cuda(la, gx, h0)),
            "device_ms": device_ms(lambda: rg_k.rglru_scan_cuda(la, gx, h0),
                                   ("rglru_scan_kernel",)),
            "plain_ms": time_ms(lambda: rg_ref.rglru_scan_ref(la, gx, h0), **plain_reps),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        del la, gx, h0

    B, H, T, N = RWKV_SHAPE
    # (shape, s0 given, state updated in place, decays, r k v w laid out as
    # the rwkv block passes them: heads split out of (B, T, H N) projections)
    rows = ((RWKV_SHAPE, False, False, "uniform", False),
            ((B, H, 1, N), True, True, "uniform", False),
            (RWKV_RAGGED, True, False, "uniform", False),
            (RWKV_SHAPE, False, False, "model", False),
            (RWKV_SHAPE, False, False, "uniform", True))
    for (B, H, t_len, N), given, in_place, decay, heads in rows:
        def operand(scale=1.0):
            if heads:
                return randn((B, t_len, H, N), scale).transpose(1, 2)
            return randn((B, H, t_len, N), scale)

        r, k, v = (operand() for _ in range(3))
        if decay == "model":  # w = exp(-exp(raw)): down to 0 and up to ~1
            w = torch.exp(-torch.exp(operand(2.0)))
        else:
            w = uniform(0.2, 0.999, (B, H, t_len, N))  # as exp(-exp(x)) gives
            if heads:
                w = w.transpose(1, 2).contiguous().transpose(1, 2)
        u = randn((H, N), 0.5)
        s0 = randn((B, H, N, N), 0.1) if given else None
        b_ms, b_by = rwkv6_bound(B, H, t_len, N, with_s0=given)
        if in_place:  # decode: the state read and written in place
            state = s0.clone()
            call = lambda: rk_k.rwkv6_scan_cuda(r, k, v, w, u, state, state_out=state)  # noqa: E731
        else:
            call = lambda: rk_k.rwkv6_scan_cuda(r, k, v, w, u, s0)  # noqa: E731
        out["rwkv6_scan"].append({
            "shape": [B, H, t_len, N], "s0": given, "in_place": in_place,
            "decay": decay, "layout": "heads of a projection" if heads else "contiguous",
            **check_rwkv6(r, k, v, w, u, s0),
            "kernel_ms": time_ms(call), "device_ms": device_ms(call, ("rwkv6_scan_kernel",)),
            "plain_ms": time_ms(lambda: rk_ref.rwkv6_scan_ref(r, k, v, w, u, s0),
                                **(plain_reps if t_len > 1 else {})),
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
        del r, k, v, w, u, s0

    cfg = configs.get_config("recurrentgemma-2b")
    serve_cfg = RECURRENT_SERVES[cfg.name]
    B, H, KVH, D = serve_cfg["requests"], cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    S = serve_cfg["prompt_len"]
    q, k, v = randn((B, H, S, D)), randn((B, KVH, S, D)), randn((B, KVH, S, D))
    out["flash_attention"].append({
        "shape": [B, H, KVH, S, D], "dtype": "f32", "causal": True,
        **check_flash(q, k, v, "f32"),
        "kernel_ms": time_ms(lambda: fa_k.flash_attention_cuda(q, k, v), reps=5, per_rep=2),
        "device_ms": device_ms(lambda: fa_k.flash_attention_cuda(q, k, v),
                               ("flash_attention_kernel",), n=3),
        "plain_ms": time_ms(lambda: fa_ref.attention_ref(q, k, v), reps=5, per_rep=2),
        **flash_bound(B, H, KVH, S, D, "f32"),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), reps=5, per_rep=2),
    })
    del q, k, v
    ring = min(cfg.local_window, S + serve_cfg["gen"])  # every slot valid in decode
    lengths_np = np.full(B, ring, np.int32)
    lengths = torch.from_numpy(lengths_np).to("cuda")
    q = randn((B, H, D))
    kc, vc = (randn((B, KVH, ring, D), dt=torch.bfloat16) for _ in range(2))
    b_ms, b_by = decode_bound(H, KVH, D, lengths_np, "f32", "bf16")
    lib_args = _sdpa_decode_args(q, kc, vc, lengths)
    out["decode_attention"].append({
        "shape": [B, H, KVH, ring, D], "q_dtype": "f32", "cache_dtype": "bf16",
        "lengths": lengths_np.tolist(), **check_decode(q, kc, vc, lengths, "f32", "bf16"),
        **decode_times(q, kc, vc, lengths),
        "plain_ms": time_ms(lambda: dec_ref.decode_attention_ref(q, kc, vc, lengths)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
            *lib_args[:3], attn_mask=lib_args[3], enable_gqa=True)),
    })
    del q, kc, vc, lib_args

    emit({"phase": "recurrent_kernels", "tolerance": {**SCAN_TOL, "attention": ATT_TOL["f32"]},
          "library_ms_null_because": NO_SCAN_LIBRARY,
          "library": "torch.nn.functional.scaled_dot_product_attention (yardstick only)",
          "kernels": out})
    return out


class _Capture:
    """Wraps an ops function: clones the arguments of the calls numbered in
    ``at`` (0-based), then calls through unchanged."""

    def __init__(self, fn, at):
        self.fn, self.at, self.n, self.got = fn, set(at), 0, {}

    def __call__(self, *args, **kw):
        import torch

        if self.n in self.at:
            self.got[self.n] = [a.clone() if torch.is_tensor(a) else a for a in args]
        self.n += 1
        return self.fn(*args, **kw)


class _Routing:
    """Wraps `blocks._moe_dispatch`: keeps, for the first ``n_prefill``
    calls (a prefill's MoE layers), the sorted experts, their tokens and
    the kept mask (device tensors, read after the run), then calls
    through unchanged."""

    def __init__(self, fn, n_prefill: int):
        self.fn, self.n_prefill, self.n, self.calls = fn, n_prefill, 0, []

    def __call__(self, cfg, router, xt):
        buf, meta = self.fn(cfg, router, xt)
        if self.n < self.n_prefill:
            e_sorted, _, keep, _, tok_sorted, _ = meta
            self.calls.append({"groups": buf.shape[0], "capacity": buf.shape[2],
                               "experts": e_sorted, "tokens": tok_sorted, "keep": keep})
        self.n += 1
        return buf, meta

    def routes(self) -> list:
        """Per prefill call: (sorted experts, their tokens, kept mask), numpy."""
        return [tuple(c[k].cpu().numpy() for k in ("experts", "tokens", "keep"))
                for c in self.calls]

    def prefill_drops(self) -> dict:
        pairs = sum(c["keep"].numel() for c in self.calls)
        dropped = sum(int((~c["keep"]).sum()) for c in self.calls)
        first = self.calls[0] if self.calls else {}
        return {"prefill_calls": len(self.calls), "groups": first.get("groups"),
                "capacity_per_group": first.get("capacity"),
                "prefill_pairs": pairs, "prefill_dropped": dropped,
                "prefill_drop_share": dropped / pairs if pairs else None}


def _set_gates(params, rng) -> list:
    """Sets every cross layer's tanh gate (zero at init, which would hide
    the cross path) to +-U(0.5, 1.0) from ``rng``; returns the values."""
    import torch

    got = []
    for key, p in params["blocks"].items():
        if key.endswith("_cross"):
            g = p["attn"]["gate"]
            vals = rng.choice([-1.0, 1.0], g.shape) * rng.uniform(0.5, 1.0, g.shape)
            g.copy_(torch.from_numpy(vals.astype(np.float32)))
            got += vals.ravel().tolist()
    return got


def _perturb_norms(params, rng) -> None:
    """Adds 0.1 N(0, 1) from ``rng`` to every norm scale (zero at init), so
    that the (1 + scale) paths are exercised."""
    import torch

    def walk(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v)
            elif "norm" in k:
                v.add_(torch.from_numpy((0.1 * rng.standard_normal(v.shape)).astype(np.float32))
                       .to(v.device))

    walk(params)


def _images(cfg, batch: int, generator):
    """Seeded N(0, 1) image embeddings (B, n_img, D) on the generator's
    device for an arch with cross layers (the reference's stub of the
    vision tower), else None."""
    import torch

    if not cfg.n_image_tokens:
        return None
    return torch.randn((batch, cfg.n_image_tokens, cfg.d_model), generator=generator,
                       device=generator.device)


def generate(lm, params, prompts, gen: int, images=None, *, timings: Optional[dict] = None,
             return_logits: bool = False):
    """Greedy serving of a batch: ``serve.serve_batch``; with ``images``,
    for the VLM, whose ``serve_batch`` takes none (as the reference's), the
    same prefill and decode loop through ``LM.prefill`` (the images in its
    batch) and ``LM.decode_step``, with the same ``timings`` and outputs."""
    import torch

    from repro_torch.launch import serve

    if images is None:
        return serve.serve_batch(lm, params, prompts, gen, timings=timings,
                                 return_logits=return_logits)
    device = params["embed"].device

    def sync():
        if timings is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    batch = {"tokens": torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=device),
             "images": images}
    logits, cache, lengths = lm.prefill(params, batch, s_max=prompts.shape[1] + gen)
    out, seen = [serve.sample(logits)], [logits]
    sync()
    t1 = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache, lengths = lm.decode_step(params, {"tokens": out[-1][:, None].long()},
                                                cache, lengths)
        out.append(serve.sample(logits))
        if return_logits:
            seen.append(logits)
    sync()
    if timings is not None:
        timings.update(prefill_s=t1 - t0, decode_s=time.perf_counter() - t1,
                       decode_steps=gen - 1)
    tokens = torch.stack(out, dim=1).cpu().numpy()
    if return_logits:
        return tokens, torch.stack(seen, dim=1).float().cpu().numpy()
    return tokens


def _serve_launches(cfg, prompt_len: int, gen: int) -> dict:
    """Exact kernel launches of one ``serve_batch`` (prefill + gen - 1 decode
    steps) on the card: flash once per self-attention layer (dense, moe, and
    local_attn where the prompt fits its window: a longer prompt takes the
    chunk-pair form; a cross layer's prefill is a plain product), decode
    once per attention layer and step (cross layers against their image
    cache), the RG-LRU scan once per rec layer (its decode step is inline),
    the RWKV-6 scan once per rwkv layer in prefill and in every step."""
    kinds = cfg.pattern * cfg.n_superblocks + cfg.remainder
    n_self = kinds.count("dense") + kinds.count("moe")
    n_attn = n_self + kinds.count("local_attn") + kinds.count("cross")
    n_flash = n_self + (kinds.count("local_attn") if prompt_len <= cfg.local_window else 0)
    return {"flash_attention": n_flash, "decode_attention": n_attn * (gen - 1),
            "rglru_scan": kinds.count("rec"), "rwkv6_scan": kinds.count("rwkv") * gen}


def _cache_bytes(cfg, batch: int, s_max: int) -> int:
    from repro_torch.models import blocks

    kinds = cfg.pattern * cfg.n_superblocks + cfg.remainder
    return sum(int(np.prod(shape)) * dt.itemsize
               for kind in kinds
               for shape, dt in blocks.cache_spec(kind, cfg, batch, s_max).values())


def phase_serve(device="cuda", reduce: int = 1, requests: int = SERVE_REQUESTS,
                prompt_len: int = SERVE_PROMPT, gen: int = SERVE_GEN, *,
                arch: str = SERVE_ARCH, phase: str = "serve",
                layers: Optional[int] = None) -> dict:
    """The serving run of ``arch`` (depth cut to ``layers`` where given);
    ``device="cpu"`` and a larger ``reduce`` rehearse its control flow on
    the CPU (no launches, no kernel checks there). The previous phase's
    tensors are freed first. An arch with cross layers (the VLM) gets
    seeded image embeddings and non-zero gates and is served through
    `generate`; an MoE arch reports the share of its prefill's (token,
    choice) pairs that capacity dropped."""
    import torch

    from repro_torch import configs, kernels
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rwkv6_scan import ops as rk_ops
    from repro_torch.launch import serve
    from repro_torch.models import LM, blocks

    t_phase = time.perf_counter()
    cfg = serve.reduce_config(configs.get_config(arch), reduce)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    lm = LM(cfg)
    B, P, G = requests, prompt_len, gen
    on_card = device == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    tf32 = bool(torch.backends.cuda.matmul.allow_tf32)
    if tf32:
        raise AssertionError("TF32 matmuls are on; the f32 projections must stay f32")
    gen_ = torch.Generator(device=device).manual_seed(SEED)
    params = lm.init(gen_, dtype=torch.float32)
    gates = _set_gates(params, np.random.default_rng(SEED))
    images = _images(cfg, B, gen_)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    prompts = np.random.default_rng(SEED).integers(0, cfg.vocab_size, size=(B, P))
    generate(lm, params, prompts[:, :64], 4, images)  # warm-up: cuBLAS, libraries
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    want = _serve_launches(cfg, P, G)
    per_step = {"decode_attention": want["decode_attention"] // max(G - 1, 1),
                "rwkv6_scan": want["rwkv6_scan"] // G}
    kinds = cfg.pattern * cfg.n_superblocks + cfg.remainder
    attn_kinds = [k for k in kinds if k in ("dense", "local_attn", "moe", "cross")]
    decode_at = {0: "first_step", per_step["decode_attention"] * (G - 2): "last_step"}
    if "cross" in attn_kinds:  # the first cross layer's call in the first step
        decode_at[attn_kinds.index("cross")] = "cross_first_step"
    # (module, function, {call number: label}): layer 0's calls.
    caps = {
        "flash_attention": (fa_ops, "flash_attention", {0: "prefill"}),
        "decode_attention": (dec_ops, "decode_attention", decode_at),
        "rglru_scan": (rg_ops, "rglru_scan", {0: "prefill"}),
        "rwkv6_scan": (rk_ops, "rwkv6_scan", {
            0: "prefill", per_step["rwkv6_scan"] * (G - 1): "last_step"}),
    }
    captures = {name: _Capture(getattr(mod, fn), at) for name, (mod, fn, at) in caps.items()}
    for name, (mod, fn, _) in caps.items():
        setattr(mod, fn, captures[name])
    routing = blocks._moe_dispatch = _Routing(blocks._moe_dispatch, kinds.count("moe"))
    try:
        kernels.reset_launch_counts()
        timings = {}
        tokens = generate(lm, params, prompts, G, images, timings=timings)
        launches = kernels.launch_counts()
    finally:
        for name, (mod, fn, _) in caps.items():
            setattr(mod, fn, captures[name].fn)
        blocks._moe_dispatch = routing.fn
    peak = int(torch.cuda.max_memory_allocated()) if on_card else None
    got = {k: launches[k] for k in want}
    if on_card and got != want:
        raise AssertionError(f"{phase} launches {got}, expected {want}")
    if tokens.shape != (B, G) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size:
        raise AssertionError(f"{phase} tokens of shape {tokens.shape} out of range")

    # The kernels against their plain versions on layer-0 tensors of this run.
    captured = {}
    for name, cap in captures.items():
        for n, label in caps[name][2].items():
            if n not in cap.got:
                continue
            args = cap.got[n]
            key = f"{name}_{label}"
            captured[key] = {"layer": 0, "call": n}
            if name == "decode_attention":
                captured[key]["lengths"] = args[3].tolist()
            if not on_card:
                continue
            if name == "flash_attention":
                captured[key].update(shape=list(args[0].shape), **check_flash(*args[:3], "f32"))
            elif name == "decode_attention":
                captured[key].update(check_decode(*args[:4], "f32", "bf16"))
            elif name == "rglru_scan":
                captured[key].update(shape=list(args[1].shape), **check_rglru(*args[:3]))
            else:
                captured[key].update(shape=list(args[0].shape), **check_rwkv6(*args[:6]))
    if on_card and len(captured) != sum(len(caps[k][2]) for k in want if want[k]):
        raise AssertionError(f"{phase}: captured {sorted(captured)} for launches {want}")
    del captures, caps
    total_s = timings["prefill_s"] + timings["decode_s"]
    profile = decode_profile(lm, params, prompts, G, images=images)
    step_ms = timings["decode_s"] * 1e3 / timings["decode_steps"]
    if profile["device_busy_ms_per_step"] is not None:
        # Against the unprofiled step time of the run above.
        profile["device_idle_share"] = 1.0 - profile["device_busy_ms_per_step"] / step_ms
    info = {
        "phase": phase,
        "arch": cfg.name,
        "layers": cfg.n_layers, "pattern": list(cfg.pattern), "remainder": list(cfg.remainder),
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads],
        "head_dim": cfg.head_dim, "vocab": cfg.vocab_size,
        "requests": B, "prompt_len": P, "gen": G, "s_max": P + G,
        "param_dtype": "float32", "cache_dtype": "bfloat16", "allow_tf32": tf32,
        "prefill_s": timings["prefill_s"],
        "decode_s": timings["decode_s"],
        "decode_ms_per_step": step_ms,
        "tokens_per_s": B * G / total_s,
        "decode_tokens_per_s": B * timings["decode_steps"] / timings["decode_s"],
        "prefill_tokens_per_s": B * P / timings["prefill_s"],
        "param_bytes": param_bytes,
        "cache_bytes": _cache_bytes(cfg, B, P + G),
        "max_memory_allocated": peak,
        "launches": got,
        "captured_checks": captured,
        "decode_profile": profile,
        "tokens_head": tokens[:2, :8].tolist(),
        "phase_s": time.perf_counter() - t_phase,
    }
    if cfg.n_experts:
        info["moe"] = {"experts": cfg.n_experts, "top_k": cfg.experts_per_token,
                       "shared_expert": cfg.shared_expert,
                       "capacity_factor": cfg.moe_capacity_factor, **routing.prefill_drops()}
    if images is not None:
        info["vlm"] = {"image_tokens": cfg.n_image_tokens, "gates": gates}
    del params, images
    emit(info)
    return info


def _kernel_calls(prof) -> dict:
    """{port kernel: {"device_ms_per_call", "calls"}} of the serving path's
    CUDA kernels in a torch.profiler trace."""
    got = {}
    for evt in prof.key_averages():
        for name in SERVE_KERNELS:
            dev = getattr(evt, "device_time_total", 0.0) or 0.0
            if f"{name}_kernel" in evt.key and dev > 0:
                ms, calls = got.get(name, (0.0, 0))
                got[name] = (ms + dev / 1e3, calls + evt.count)
    return {k: {"device_ms_per_call": ms / calls, "calls": calls} for k, (ms, calls) in got.items()}


def decode_profile(lm, params, prompts, gen: int, steps: int = 4, images=None) -> dict:
    """Where a decode step's time goes: a torch.profiler trace (CPU and
    CUDA) of ``steps`` decode steps after a fresh prefill of the same
    prompts. Host wall per step against the card's busy time per step
    (sum of kernel times; kernels do not overlap on one stream), and the
    kernels with the most device time. On the card the prefill is traced
    too (CUDA only): the port's kernels' device ms per call in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = params["embed"].device
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=device)}
    if images is not None:
        batch["images"] = images
    pre = profile(activities=[ProfilerActivity.CUDA]) if on_card else contextlib.nullcontext()
    with pre:
        logits, cache, lengths = lm.prefill(params, batch, s_max=prompts.shape[1] + gen)
        sync()
    prefill_kernels = _kernel_calls(pre) if on_card else None
    tok = logits.argmax(-1)[:, None]
    sync()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache, lengths = lm.decode_step(params, {"tokens": tok}, cache, lengths)
            tok = logits.argmax(-1)[:, None]
        sync()
        wall = time.perf_counter() - t0
    by_kernel, host, launches = {}, {}, 0
    dec_ms, dec_calls = 0.0, 0
    for evt in prof.key_averages():
        if getattr(evt, "is_user_annotation", False):
            continue  # the port's `obs` spans (and their device-side mirrors): not work
        dev = getattr(evt, "device_time_total", 0.0) or 0.0
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            if dev > 0:
                by_kernel[evt.key] = dev / steps / 1e3
                launches += evt.count
                if any(k in evt.key for k in DECODE_KERNEL):
                    dec_ms += dev / 1e3
                    dec_calls += evt.count
        elif evt.self_cpu_time_total > 0:
            host[evt.key] = (evt.self_cpu_time_total / steps / 1e3, evt.count / steps)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    top_host = sorted(host.items(), key=lambda kv: -kv[1][0])[:8]
    return {
        "steps": steps,
        "profiled_wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms_per_step": sum(by_kernel.values()) if by_kernel else None,
        "kernels_per_step": launches / steps,
        "decode_attention_device_ms_per_call": dec_ms / dec_calls if dec_calls else None,
        "decode_attention_calls_per_step": dec_calls / steps,
        "kernels_device_ms_per_call": _kernel_calls(prof) if on_card else None,
        "prefill_kernels_device_ms_per_call": prefill_kernels,
        "top_kernels_ms_per_step": [[k[:80], v] for k, v in top],
        "top_host_ops_ms_calls_per_step": [[k[:60], *v] for k, v in top_host],
    }


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def phase_serve_parity(device="cuda") -> dict:
    import torch

    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map

    cfg = dataclasses.replace(serve.reduce_config(configs.get_config(SERVE_ARCH), 8),
                              n_heads=4, n_kv_heads=2)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(SEED), dtype=torch.float32)
    prompts = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, size=(2, 64))
    t0 = time.perf_counter()
    cpu_tokens, cpu_logits = serve.serve_batch(lm, params, prompts, 16, return_logits=True)
    cpu_s = time.perf_counter() - t0
    card = tree_map(lambda t: t.to(device), params)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, logits = serve.serve_batch(lm, card, prompts, 16, return_logits=True)
    card_s = time.perf_counter() - t0
    launches = kernels.launch_counts()
    want = {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers * 15}
    got = {k: launches[k] for k in want}
    diff = np.abs(logits - cpu_logits)
    ok = bool((diff <= PARITY_TOL + PARITY_TOL * np.abs(cpu_logits)).all())
    info = {
        "phase": "serve_parity",
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                   "vocab": cfg.vocab_size},
        "requests": 2, "prompt_len": 64, "gen": 16,
        "max_abs_logit_diff": float(diff.max()),
        "max_abs_logit": float(np.abs(cpu_logits).max()),
        "tolerance": PARITY_TOL,
        "tokens_equal": bool((tokens == cpu_tokens).all()),
        "launches": got,
        "card_s": card_s, "cpu_s": cpu_s,
    }
    emit(info)
    if not (ok and info["tokens_equal"] and np.isfinite(logits).all()) or (
        device == "cuda" and got != want
    ):
        raise AssertionError(f"serve parity failed: {info}")
    return info


def greedy(lm, params, prompts, gen: int, cache_dtype):
    """``serve_batch``'s greedy loop with the decode cache in ``cache_dtype``:
    (B, gen) tokens and the (B, gen, V) float32 logits they were taken from."""
    import torch

    device = params["embed"].device
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=device)}
    logits, cache, lengths = lm.prefill(params, batch, s_max=prompts.shape[1] + gen,
                                        cache_dtype=cache_dtype)
    out, seen = [], []
    for i in range(gen):
        if i:
            logits, cache, lengths = lm.decode_step(params, {"tokens": out[-1][:, None]},
                                                    cache, lengths)
        out.append(logits.argmax(-1))
        seen.append(logits)
    return torch.stack(out, 1).cpu().numpy(), torch.stack(seen, 1).float().cpu().numpy()


def _logit_diff(logits, ref_logits) -> tuple:
    diff = np.abs(logits - ref_logits)
    ok = bool((diff <= PARITY_TOL + PARITY_TOL * np.abs(ref_logits)).all())
    return float(diff.max()), ok and bool(np.isfinite(logits).all())


def phase_recurrent_parity(arch: str, device="cuda", gen: int = 16) -> dict:
    """``arch`` at reduce 8 on the card against the CPU, same parameters:
    greedily with a float32 cache (held: logits within PARITY_TOL, tokens
    equal, exact launches), then through ``serve_batch`` with its bf16 cache
    (reported)."""
    import torch

    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map

    cfg = serve.reduce_config(configs.get_config(arch), 8)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(SEED), dtype=torch.float32)
    P = RECURRENT_PARITY_PROMPT[arch]
    prompts = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size, size=(2, P))
    t0 = time.perf_counter()
    cpu_tokens, cpu_logits = greedy(lm, params, prompts, gen, torch.float32)
    cpu_s = time.perf_counter() - t0
    card = tree_map(lambda t: t.to(device), params)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tokens, logits = greedy(lm, card, prompts, gen, torch.float32)
    card_s = time.perf_counter() - t0
    got = {k: kernels.launch_counts()[k] for k in SERVE_KERNELS}
    want = _serve_launches(cfg, P, gen)
    max_diff, ok = _logit_diff(logits, cpu_logits)
    b_cpu_tokens, b_cpu_logits = serve.serve_batch(lm, params, prompts, gen, return_logits=True)
    b_tokens, b_logits = serve.serve_batch(lm, card, prompts, gen, return_logits=True)
    if not (np.isfinite(b_logits).all() and b_tokens.shape == (2, gen)):
        raise AssertionError(f"{arch} serve_batch on the card gave non-finite logits")
    info = {
        "phase": "recurrent_parity",
        "arch": cfg.name,
        "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model, "n_heads": cfg.n_heads,
                   "n_kv_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
                   "local_window": cfg.local_window, "rwkv_head_dim": cfg.rwkv_head_dim,
                   "vocab": cfg.vocab_size},
        "requests": 2, "prompt_len": P, "gen": gen, "cache_dtype": "float32",
        "max_abs_logit_diff": max_diff,
        "max_abs_logit": float(np.abs(cpu_logits).max()),
        "tolerance": PARITY_TOL,
        "tokens_equal": bool((tokens == cpu_tokens).all()),
        "launches": got,
        "card_s": card_s, "cpu_s": cpu_s,
        "serve_batch_bf16_cache": {
            "max_abs_logit_diff": float(np.abs(b_logits - b_cpu_logits).max()),
            "tokens_equal": bool((b_tokens == b_cpu_tokens).all()),
        },
    }
    emit(info)
    if not (ok and info["tokens_equal"]) or (device == "cuda" and got != want):
        raise AssertionError(f"{arch} parity failed (launches expected {want}): {info}")
    return info


def _routed(lm, params, prompts, gen: int, images, n_prefill: int):
    """`generate` with its logits and the MoE routing of its prefill."""
    from repro_torch.models import blocks

    routing = blocks._moe_dispatch = _Routing(blocks._moe_dispatch, n_prefill)
    try:
        tokens, logits = generate(lm, params, prompts, gen, images, return_logits=True)
    finally:
        blocks._moe_dispatch = routing.fn
    return routing, tokens, logits


def phase_moe_vlm_parity(device="cuda") -> dict:
    """dbrx-132b, llama4-scout and llama-3.2-vision at reduce 8 (MoE at
    capacity factor 1.25: pairs are dropped; the VLM with seeded images),
    gates and norm scales drawn non-zero, on the card against the CPU from
    the same parameters: greedy tokens equal, logits within PARITY_TOL at
    every step (the bf16 cache of serve_batch), the same routed experts,
    tokens and kept pairs in every MoE layer of the prefill, exact
    launches; FAMILY_REPEAT_ARCH served twice on the card, bit-equal."""
    import torch

    from repro_torch import configs, kernels
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map

    t_phase = time.perf_counter()
    P, gen = FAMILY_PARITY_PROMPT, FAMILY_PARITY_GEN
    out, failed = {}, []
    for arch in FAMILY_SERVES:
        cfg = serve.reduce_config(configs.get_config(arch), 8)
        lm = LM(cfg)
        rng = np.random.default_rng(SEED)
        params = lm.init(torch.Generator().manual_seed(SEED), dtype=torch.float32)
        _set_gates(params, rng)
        _perturb_norms(params, rng)
        images = _images(cfg, 2, torch.Generator().manual_seed(SEED + 1))
        prompts = rng.integers(0, cfg.vocab_size, size=(2, P))
        n_moe = (cfg.pattern * cfg.n_superblocks + cfg.remainder).count("moe")
        t0 = time.perf_counter()
        cpu_routing, cpu_tokens, cpu_logits = _routed(lm, params, prompts, gen, images, n_moe)
        cpu_s = time.perf_counter() - t0
        card = tree_map(lambda t: t.to(device), params)
        card_images = None if images is None else images.to(device)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        routing, tokens, logits = _routed(lm, card, prompts, gen, card_images, n_moe)
        card_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        want = {k: v for k, v in _serve_launches(cfg, P, gen).items()
                if k in ("flash_attention", "decode_attention")}
        got = {k: launches[k] for k in want}
        max_diff, ok = _logit_diff(logits, cpu_logits)
        routes_equal = all(np.array_equal(a, b) for ca, cb in
                           zip(routing.routes(), cpu_routing.routes()) for a, b in zip(ca, cb))
        info = {
            "config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                       "n_heads": cfg.n_heads, "n_kv_heads": cfg.n_kv_heads,
                       "head_dim": cfg.head_dim, "n_experts": cfg.n_experts,
                       "experts_per_token": cfg.experts_per_token,
                       "capacity_factor": cfg.moe_capacity_factor,
                       "n_image_tokens": cfg.n_image_tokens, "vocab": cfg.vocab_size},
            "requests": 2, "prompt_len": P, "gen": gen,
            "max_abs_logit_diff": max_diff, "max_abs_logit": float(np.abs(cpu_logits).max()),
            "tolerance": PARITY_TOL,
            "tokens_equal": bool((tokens == cpu_tokens).all()),
            "routes_equal": routes_equal and len(routing.calls) == len(cpu_routing.calls),
            "launches": got, "card_s": card_s, "cpu_s": cpu_s,
        }
        if n_moe:
            info["moe"] = cpu_routing.prefill_drops()
            if not info["moe"]["prefill_dropped"]:
                failed.append(f"{arch}: no pair dropped, the capacity path went unchecked")
        if arch == FAMILY_REPEAT_ARCH:
            _, again = generate(lm, card, prompts, gen, card_images, return_logits=True)
            info["repeat_bit_equal"] = bool(np.array_equal(again, logits))
        out[arch] = info
        if not (ok and info["tokens_equal"] and info["routes_equal"]
                and info.get("repeat_bit_equal", True)) or (device == "cuda" and got != want):
            failed.append(f"{arch} (launches expected {want})")
        del params, card
    result = {"phase": "moe_vlm_parity", "archs": out, "phase_s": time.perf_counter() - t_phase}
    emit(result)
    if failed:
        raise AssertionError(f"moe_vlm_parity failed for {failed}: {out}")
    return result


def phase_schedule(device="cuda", run=SCHEDULE_RUN) -> dict:
    """NoMora placing the ten LM jobs (`launch/schedule.py`'s
    `schedule_ml_jobs` at its defaults) on the card and on the CPU with
    fixed_algo_s = 0: placements (roots, mesh orders, RTTs), every
    SimMetrics series and summary() equal; the card's launches."""
    import functools

    from repro_torch import kernels
    from repro_torch.launch import schedule

    config = schedule.simulator.SimConfig
    schedule.simulator.SimConfig = functools.partial(config, fixed_algo_s=0.0)
    try:
        t0 = time.perf_counter()
        cpu, cpu_m = schedule.schedule_ml_jobs(*run, device="cpu")
        cpu_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        card, card_m = schedule.schedule_ml_jobs(*run, device=device)
        card_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
    finally:
        schedule.simulator.SimConfig = config
    diffs = _metric_diffs(card_m, cpu_m)
    summary = card_m.summary()
    info = {
        "phase": "schedule", "machines": run[0], "jobs": run[1], "duration_s": run[2],
        "placed": len(card), "placements_equal": card == cpu, "metric_diffs": diffs,
        "avg_app_perf_area": summary["avg_app_perf_area"],
        "tasks_migrated": summary["tasks_migrated"], "rounds": summary["rounds"],
        "launches": {k: launches[k] for k in SCHEDULER_KERNELS},
        "first_placements": dict(list(sorted(card.items()))[:2]),
        "card_s": card_s, "cpu_s": cpu_s,
    }
    emit(info)
    if not info["placements_equal"] or diffs or len(card) != run[1]:
        raise AssertionError(f"schedule: card and CPU differ: {info}")
    if device == "cuda" and not (launches["costmap"] > 0 and launches["auction_phase"] > 0
                                 and launches["auction_bid"] == 0):
        raise AssertionError(f"schedule: launches {info['launches']}")
    return info


# --------------------------------------------------------------------- #
# Training: gradients through the kernels, full-width train steps


def _grads(fn, inputs, cots):
    """(outputs, gradients of the inputs) of ``fn`` under autograd, with the
    cotangents ``cots`` (one per output)."""
    import torch

    ins = [t.detach().requires_grad_() for t in inputs]
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    return [o.detach() for o in outs], list(torch.autograd.grad(outs, ins, cots))


def _grad_times(fn, inputs, cots, reps: int) -> dict:
    """Forward and backward ms (CUDA events, ``reps`` runs of one call) and
    the peak memory of one forward + backward."""
    import torch

    ins = [t.detach().requires_grad_() for t in inputs]
    fwd = time_ms(lambda: fn(*ins), reps=reps, per_rep=1, warmup=1)
    out = fn(*ins)
    outs = out if isinstance(out, tuple) else (out,)
    bwd = time_ms(lambda: torch.autograd.grad(outs, ins, cots, retain_graph=True),
                  reps=reps, per_rep=1, warmup=1)
    del out, outs
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn(*ins)
    torch.autograd.grad(out if isinstance(out, tuple) else (out,), ins, cots)
    torch.cuda.synchronize()
    return {"forward_ms": fwd, "backward_ms": bwd,
            "peak_bytes_over_inputs": int(torch.cuda.max_memory_allocated() - base)}


def phase_grad_kernels() -> dict:
    """Each kernel's autograd Function at a full-width layer's shapes: its
    gradients against plain autograd on the same card tensors (flash within
    FLASH_GRAD_TOL of each gradient's largest magnitude: its backward is a
    kernel; RG-LRU bit for bit: its backward is the plain one; RWKV-6
    against the chunked op run with the plain forward, within the forward's
    tolerance: its chunk states come from the kernel), the kernel's
    launches, and the forward / backward ms and peak memory of both; for
    flash's backward kernel also `_flash_backward`'s numbers."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention import ref as fa_ref
    from repro_torch.kernels.rglru_scan import ops as rg_ops
    from repro_torch.kernels.rglru_scan import ref as rg_ref
    from repro_torch.kernels.rwkv6_scan import ops as rk_ops
    from repro_torch.kernels.rwkv6_scan import ref as rk_ref

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    rng = np.random.default_rng(SEED)

    def randn(shape, scale=1.0):
        return torch.from_numpy(rng.normal(0, scale, shape).astype(np.float32)).to("cuda")

    def flash_case(name):
        B, H, KVH, S, D = GRAD_SHAPES[name]
        scale = 1.0 / D**0.5
        return (lambda q, k, v: fa_ops.flash_attention(q, k, v, causal=True, scale=scale),
                lambda q, k, v: fa_ref.attention_ref(q, k, v, causal=True, scale=scale),
                [randn((B, H, S, D)), randn((B, KVH, S, D)), randn((B, KVH, S, D))],
                (randn((B, H, S, D)),), 1, False)

    B, T, Dr = GRAD_SHAPES["rglru_scan"]
    rg_in = [-torch.from_numpy(rng.uniform(0.001, 2.0, (B, T, Dr)).astype(np.float32)).cuda(),
             randn((B, T, Dr))]
    rg_cot = (randn((B, T, Dr)), randn((B, Dr)))
    B, Hr, T, N = GRAD_SHAPES["rwkv6_scan"]
    rk_in = [randn((B, Hr, T, N)) for _ in range(3)]
    rk_in += [torch.from_numpy(rng.uniform(0.2, 0.999, (B, Hr, T, N)).astype(np.float32)).cuda(),
              randn((Hr, N), 0.5), randn((B, Hr, N, N), 0.1)]
    rk_cot = (randn((B, Hr, T, N)), randn((B, Hr, N, N)))
    chunk = GRAD_RWKV_CHUNK
    cases = {
        # name (the kernel's, then a tag): (the op as the model calls it,
        # plain autograd, inputs, cotangents, launches of one forward,
        # bit-equal?)
        "flash_attention": flash_case("flash_attention"),
        "flash_attention.train_4k": flash_case("flash_attention.train_4k"),
        "rglru_scan": (lambda la, gx: rg_ops.rglru_scan(la, gx, None),
                       lambda la, gx: rg_ref.rglru_scan_ref(la, gx, None),
                       rg_in, rg_cot, 1, True),
        "rwkv6_scan": (lambda *a: rk_ops.rwkv6_scan(*a, chunk=chunk),
                       lambda *a: rk_ops.RWKV6Scan.apply(*a, chunk, rk_ref.rwkv6_scan_ref),
                       rk_in, rk_cot, GRAD_SHAPES["rwkv6_scan"][2] // chunk, False),
    }
    out = {}
    for name, (op, plain, inputs, cots, n_launch, exact) in cases.items():
        kernel = name.split(".")[0]
        before = kernels.launch_counts()
        got_out, got = _grads(op, inputs, cots)
        after = kernels.launch_counts()
        launched = after[kernel] - before[kernel]
        want_out, want = _grads(plain, inputs, cots)
        if launched != n_launch:
            raise AssertionError(f"{name}: the Function launched {launched} kernels, "
                                 f"expected {n_launch}")
        bit_equal = all(torch.equal(a, b) for a, b in zip(got, want))
        if exact and not bit_equal:
            diffs = [float((a - b).abs().max()) for a, b in zip(got, want)]
            raise AssertionError(f"{name}: Function gradients differ from plain autograd "
                                 f"{diffs}")
        extra = {}
        if kernel == "flash_attention":
            bwd_calls = after["flash_attention_bwd"] - before["flash_attention_bwd"]
            rel = max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))
            if bwd_calls != 1 or rel > FLASH_GRAD_TOL:
                raise AssertionError(f"{name}: {bwd_calls} backward calls, gradients "
                                     f"within {rel} of their largest magnitude "
                                     f"(tolerance {FLASH_GRAD_TOL})")
            # the tolerance holds the error over each gradient's largest
            # magnitude, not the absolute error
            tol = None
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            extra = {"max_rel_err_of_largest": rel, "tolerance_of_largest": FLASH_GRAD_TOL,
                     "output_max_abs_err": max(
                         _agree(f"{name} output", a, b, ATT_TOL["f32"])["max_abs_err"]
                         for a, b in zip(got_out, want_out)),
                     "output_tolerance": ATT_TOL["f32"],
                     "backward": _flash_backward(GRAD_SHAPES[name], inputs, cots, want)}
        else:
            tol = SCAN_TOL[name]
            err = max(_agree(f"{name} gradient", a, b, tol)["max_abs_err"]
                      for a, b in zip(got + got_out, want + want_out))
        del got, want, got_out, want_out
        reps = 5 if kernel == "flash_attention" else 3
        out[name] = {
            "shape": list(GRAD_SHAPES[name]), "dtype": "f32",
            **({"chunk": chunk} if name == "rwkv6_scan" else {}),
            "launches_per_forward": launched, "bit_equal": bit_equal,
            "max_abs_err": err, "tolerance": 0.0 if exact else tol,
            "function": _grad_times(op, inputs, cots, reps),
            "plain": _grad_times(plain, inputs, cots, reps), **extra,
        }
        torch.cuda.empty_cache()
    info = {"phase": "grad_kernels",
            "plain": {"flash_attention": "autograd through ref.attention_ref",
                      "rglru_scan": "autograd through ref.rglru_scan_ref",
                      "rwkv6_scan": "RWKV6Scan with ref.rwkv6_scan_ref as its forward"},
            "kernels": out, "phase_s": time.perf_counter() - t_phase}
    emit(info)
    return info


def _flash_backward(shape, inputs, cots, want) -> dict:
    """Flash's backward kernel alone on ``inputs`` (f32 causal), from the
    forward kernel's output and log-sum-exp: ms a call (CUDA events), the
    device ms of each of its launches (torch.profiler), the bound, and
    scaled_dot_product_attention's f32 backward with ``enable_gqa`` (a
    yardstick; the port never calls it): its ms and its gradients' error
    against ``want``, autograd through the plain version."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel_cuda

    q, k, v = inputs
    (do,) = cots
    o, lse = kernel_cuda.flash_attention_cuda(q, k, v, return_lse=True)

    def call():
        return kernel_cuda.flash_attention_backward_cuda(do, q, k, v, o, lse)

    res = {"ms": time_ms(call, reps=5, per_rep=2, warmup=1),
           "device_ms": {kern: device_ms(call, (kern,), n=3) for kern in FLASH_BWD_KERNELS},
           **flash_bwd_bound(*shape)}
    res["device_ms"]["sum"] = sum(res["device_ms"].values())
    del o, lse
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                          enable_gqa=True)
    got = _grads(sdpa, inputs, cots)[1]
    res["library"] = {
        "call": "scaled_dot_product_attention(is_causal=True, enable_gqa=True), f32",
        "max_rel_err_of_largest": max(float((a - b).abs().max() / b.abs().max())
                                      for a, b in zip(got, want)),
        **_grad_times(sdpa, inputs, cots, 5)}
    del got
    torch.cuda.empty_cache()
    return res


def _train_launches(cfg, seq: int) -> dict:
    """Kernel launches of one train step with remat: the superblocks' layers
    run forward and again in the backward's recompute (2 each), the
    remainder layers once; flash for attention layers whose sequence fits
    the window, the RWKV-6 scan once per chunk."""
    from repro_torch.kernels.rwkv6_scan import ops

    chunk = ops._chunk_div(seq, ops.DEFAULT_CHUNK)

    def count(kinds):
        return {"flash_attention": kinds.count("dense") + (
                    kinds.count("local_attn") if seq <= cfg.local_window else 0),
                "rglru_scan": kinds.count("rec"),
                "rwkv6_scan": kinds.count("rwkv") * (seq // chunk)}

    sb, rem = count(cfg.pattern * cfg.n_superblocks), count(cfg.remainder)
    # flash's backward: once per attention layer (remat runs a layer's
    # forward twice, autograd its backward once).
    return {**{k: 2 * sb[k] + rem[k] for k in sb},
            "flash_attention_bwd": sb["flash_attention"] + rem["flash_attention"]}


def _train_profile(lm, batch, step_s: float) -> dict:
    """The card's busy and idle share in one train step: a torch.profiler
    trace (CUDA only: a CPU trace of the scans' per-step loops takes longer
    to read than the step) of one step from fresh weights drawn on the
    card; busy is the sum of the CUDA kernels' device time, against the
    unprofiled step's host seconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.optim import AdamW, AdamWConfig
    from repro_torch.train import build_train_step

    opt = AdamW(AdamWConfig())
    state = opt.init(lm.init(torch.Generator(device="cuda").manual_seed(SEED), torch.float32))
    step = build_train_step(lm, opt, remat=True)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, metrics = step(state, batch)
        float(metrics["loss"])
        wall = time.perf_counter() - t0
    del state
    busy, by_kernel, launches = 0.0, collections.Counter(), 0
    t0 = time.perf_counter()
    # The trace's own events: key_averages() first builds a Python event
    # tree, ~30 s for the 175,000 kernels of a recurrentgemma-2b step.
    for evt in prof.profiler.kineto_results.events():
        ms = evt.duration_ns() / 1e6
        # A span's range mirrored onto the device's timeline is no kernel.
        if (evt.device_type() == torch.autograd.DeviceType.CUDA and ms > 0
                and not evt.is_user_annotation()):
            busy += ms
            by_kernel[evt.name()] += ms
            launches += 1
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_ms": wall * 1e3, "trace_read_s": time.perf_counter() - t0,
            "device_busy_ms": busy or None,
            "device_idle_share": (1.0 - busy / (step_s * 1e3)) if busy else None,
            "kernels": launches, "top_kernels_ms": [[k[:80], v] for k, v in top]}


def _timed_manager(timing: dict):
    """`CheckpointManager` that records the seconds of its saves (the part
    the training loop waits for), waits and restores, and holds each state
    it restores byte-equal to the files it was read from (before training
    updates it in place)."""
    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import _flatten_with_paths

    class Manager(CheckpointManager):
        def save(self, step, tree, blocking=False):
            t0 = time.perf_counter()
            super().save(step, tree, blocking=blocking)
            timing["save_s"].append(time.perf_counter() - t0)

        def wait(self):
            t0 = time.perf_counter()
            super().wait()
            timing["wait_s"] += time.perf_counter() - t0

        def restore(self, template, step=None, device=None, verify=True):
            t0 = time.perf_counter()
            state = super().restore(template, step=step, device=device, verify=verify)
            timing["restore_s"] = time.perf_counter() - t0
            step = self.latest_step() if step is None else step
            d = Path(self.dir) / f"step_{step:08d}"
            with open(d / "manifest.json") as f:
                manifest = json.load(f)["leaves"]
            n_bytes = 0
            for (name, t), rec in zip(_flatten_with_paths(state), manifest):
                saved = np.load(d / rec["file"])
                if name != rec["name"] or not torch.equal(t.cpu(), torch.from_numpy(saved)):
                    raise AssertionError(f"restored {name} differs from the saved {rec['name']}")
                n_bytes += saved.nbytes
            timing["restored_bytes_equal_saved"] = n_bytes
            return state

    return Manager


def phase_train(phase: str, arch: str, n_layers: int, batch: int, seq: int,
                device="cuda") -> dict:
    """``launch.train.main`` at ``arch``'s full width with its depth cut to
    ``n_layers`` (a ``dataclasses.replace`` in place of ``reduce_config``):
    3 steps with a checkpoint at 2, then from that checkpoint alone step 2
    again. Asserts the kernels' launches per step, the resumed losses
    against the first run's (rtol 1e-5: the embedding's gradient is an
    atomic scatter on the card) and the state the resumed run restored
    byte-equal to the files saved (their crc32 also checked against the
    manifest). ``device="cpu"`` with small sizes rehearses the control flow
    (no launches, no profile there)."""
    import shutil

    import torch

    from repro_torch import configs, kernels
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    on_card = device == "cuda"
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=n_layers)
    lm = LM(cfg)
    root = ROOT / "build" / f"ckpt_{phase}"
    shutil.rmtree(root, ignore_errors=True)
    argv = ["--arch", arch, "--reduce", "1", "--steps", str(TRAIN_STEPS), "--batch", str(batch),
            "--seq", str(seq), "--ckpt-every", str(TRAIN_CKPT_AT), "--log-every", "1",
            "--device", device]
    timing = {"save_s": [], "wait_s": 0.0}
    patched = {"reduce_config": lambda c, factor: dataclasses.replace(c, n_layers=n_layers),
               "CheckpointManager": _timed_manager(timing)}
    saved = {name: getattr(train_mod, name) for name in patched}
    for name, value in patched.items():
        setattr(train_mod, name, value)
    try:
        if on_card:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        first = {}
        t0 = time.perf_counter()
        losses = train_mod.main(argv + ["--ckpt-dir", str(root / "a")], record=first)
        first_run_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        peak = int(torch.cuda.max_memory_allocated()) if on_card else None
        os.makedirs(root / "b")
        os.rename(root / "a" / f"step_{TRAIN_CKPT_AT:08d}", root / "b" / f"step_{TRAIN_CKPT_AT:08d}")
        shutil.rmtree(root / "a")
        t0 = time.perf_counter()
        resumed_rec = {}
        resumed = train_mod.main(argv + ["--ckpt-dir", str(root / "b"), "--resume"],
                                 record=resumed_rec)
        resume_run_s = time.perf_counter() - t0
    finally:
        for name, value in saved.items():
            setattr(train_mod, name, value)
        shutil.rmtree(root, ignore_errors=True)

    want = {k: TRAIN_STEPS * v for k, v in _train_launches(cfg, seq).items()}
    got = {k: launches[k] for k in want}
    if on_card and got != want:
        raise AssertionError(f"{phase} launches {got}, expected {want}")
    if not np.isfinite(losses).all():
        raise AssertionError(f"{phase}: non-finite losses {losses}")
    loss_rel = np.abs(np.asarray(resumed) - losses[TRAIN_CKPT_AT:]) / np.abs(
        losses[TRAIN_CKPT_AT:])
    if not (loss_rel <= TRAIN_RESUME_RTOL).all():
        raise AssertionError(f"{phase}: resumed losses {resumed} against {losses}")
    if "restored_bytes_equal_saved" not in timing:
        raise AssertionError(f"{phase}: the resumed run restored nothing")

    steps_s = [r["s"] for r in first["steps"]]
    step_s = float(np.median(steps_s[1:]))  # the first step includes library warm-up
    profile = None
    if on_card:
        data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                          global_batch=batch))
        tokens = torch.as_tensor(data.batch(0)["tokens"], device=device)
        t0 = time.perf_counter()
        profile = _train_profile(lm, {"tokens": tokens}, step_s)
        profile["profile_s"] = time.perf_counter() - t0
    info = {
        "phase": phase, "arch": cfg.name,
        "layers": cfg.n_layers, "pattern": list(cfg.pattern), "remainder": list(cfg.remainder),
        "d_model": cfg.d_model, "vocab": cfg.vocab_size, "params": first["n_params"],
        "batch": batch, "seq": seq, "steps": TRAIN_STEPS, "remat": True,
        "param_dtype": "float32", "allow_tf32": bool(torch.backends.cuda.matmul.allow_tf32),
        "losses": losses, "resumed_losses": resumed,
        "resumed_max_rel_diff": float(loss_rel.max()), "resume_rtol": TRAIN_RESUME_RTOL,
        "grad_norms": [r["grad_norm"] for r in first["steps"]],
        "step_s": steps_s, "step_ms": step_s * 1e3,
        "tokens_per_s": batch * seq / step_s,
        "resumed_step_s": [r["s"] for r in resumed_rec["steps"]],
        "first_run_s": first_run_s, "resume_run_s": resume_run_s, "checkpoint": timing,
        "launches": got, "launches_per_step": {k: v // TRAIN_STEPS for k, v in want.items()},
        "max_memory_allocated": peak,
        "step_profile": profile,
        "phase_s": time.perf_counter() - t_phase,
    }
    emit(info)
    return info


def _train_run(lm, params, batches, device):
    """(per-step losses, step 1's gradients on the CPU) of TRAIN_PARITY_STEPS
    steps of `build_train_step` from ``params``."""
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
    from repro_torch.train import build_train_step, loss_and_grads

    cfg = AdamWConfig(**TRAIN_PARITY_ADAMW)
    opt = AdamW(cfg, cosine_schedule(cfg.lr, warmup_steps=1, total_steps=len(batches)))
    state = opt.init(tree_map(lambda t: t.to(device, copy=True), params))
    on = [{k: v.to(device) for k, v in b.items()} for b in batches]
    grads = tree_map(lambda g: g.cpu(), loss_and_grads(lm, state.params, on[0])[1])
    step = build_train_step(lm, opt, remat=True)
    losses = [float(step(state, b)[1]["loss"]) for b in on]
    return losses, grads


def phase_train_parity(device="cuda") -> dict:
    """Each trained arch at ``reduce_config(cfg, 8)``: TRAIN_PARITY_STEPS
    steps on the card against the same steps on the CPU, from the same
    weights and data: losses within rtol 1e-4 at every step, every gradient
    leaf of step 1 within 1e-3 * max|leaf| + 1e-6."""
    import torch

    from repro_torch import configs, kernels
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import serve
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    out = {}
    for arch, seq in TRAIN_PARITY_SEQ.items():
        cfg = serve.reduce_config(configs.get_config(arch), 8)
        lm = LM(cfg)
        params = lm.init(torch.Generator().manual_seed(SEED), dtype=torch.float32)
        data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                          global_batch=2, seed=SEED + 1))
        batches = [{k: torch.from_numpy(v) for k, v in data.batch(i).items()}
                   for i in range(TRAIN_PARITY_STEPS)]
        t0 = time.perf_counter()
        cpu_losses, cpu_grads = _train_run(lm, params, batches, "cpu")
        cpu_s = time.perf_counter() - t0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        losses, grads = _train_run(lm, params, batches, device)
        card_s = time.perf_counter() - t0
        launches = kernels.launch_counts()
        loss_rel = float(np.max(np.abs(np.subtract(losses, cpu_losses)) / np.abs(cpu_losses)))
        worst = _leaf_worst(grads, cpu_grads)
        per_step = _train_launches(cfg, seq)
        # step 1's gradients (one step's launches), then the steps
        want = {k: v * (TRAIN_PARITY_STEPS + 1) for k, v in per_step.items()}
        got = {k: launches[k] for k in want}
        out[arch] = {"config": {"n_layers": cfg.n_layers, "d_model": cfg.d_model,
                                "vocab": cfg.vocab_size}, "batch": 2, "seq": seq,
                     "losses": losses, "cpu_losses": cpu_losses, "max_loss_rel_diff": loss_rel,
                     "loss_rtol": TRAIN_PARITY_LOSS_RTOL,
                     "max_grad_diff_over_tolerance": worst, "launches": got,
                     "card_s": card_s, "cpu_s": cpu_s}
        if not (loss_rel <= TRAIN_PARITY_LOSS_RTOL and worst <= 1.0 and np.isfinite(losses).all()) \
                or (device == "cuda" and got != want):
            raise AssertionError(f"train parity failed for {arch} (launches expected {want}): "
                                 f"{out[arch]}")
    info = {"phase": "train_parity", "archs": out, "phase_s": time.perf_counter() - t_phase}
    emit(info)
    return info


def phase_roofline(device_info: dict, train: dict, served: dict) -> dict:
    """The dry run's counts of the train phase's qwen3-0.6b step and of one
    decode step of the serve phase (1x1 mesh, fake tensors on the host:
    nothing is launched), beside the step times those phases measured:
    the achieved rate flops_dev / step_s against the f32 peak, the
    roofline terms on H100 constants. ``train`` / ``served``: the phases'
    lines."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import dryrun, rooftool
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    arch, layers, batch, seq = TRAIN_RUNS["train"]
    if arch != SERVE_ARCH or served["arch"] != arch:
        raise AssertionError(f"roofline: the train and serve phases run {arch} and "
                             f"{served['arch']}, not one arch")
    cfg = dataclasses.replace(configs.get_config(arch), n_layers=layers)
    mesh = make_mesh((1, 1), ("data", "model"))
    # The train phase's fastest step: its first warms up, its last overlaps
    # the checkpoint's writes (its step_ms is the median of its last two).
    cells = {"train": (ShapeSpec("train", "train", seq, batch), min(train["step_s"])),
             "decode": (ShapeSpec("decode", "decode", SERVE_PROMPT + SERVE_GEN, SERVE_REQUESTS),
                        served["decode_ms_per_step"] / 1e3)}
    out = {}
    for name, (shape, step_s) in cells.items():
        rec = dryrun.lower_cell(cfg, shape, mesh, multi_pod=False)
        flops = rec["flops_dev"]
        cell = rooftool.CellAnalysis(flops, rec["bytes_dev"], 0, rec["collectives"], 1)
        tokens = shape.global_batch * (shape.seq_len if shape.kind == "train" else 1)
        mf = rooftool.model_flops(cfg.active_param_count(), tokens, shape.kind)
        achieved = flops / step_s
        out[name] = {
            "shape": dataclasses.asdict(shape), "dry_pass_s": rec["lower_s"],
            "flops_dev": flops, "model_flops": mf, "useful_ratio": mf / flops,
            "bytes_dev": rec["bytes_dev"], "arg_bytes_dev_bf16": rec["arg_bytes_dev"],
            **{k: getattr(cell, k) for k in ("compute_s", "memory_s", "dominant", "bound_s")},
            "compute_s_at_f32_peak": flops / rooftool.PEAK_FLOPS_F32,
            "step_s_measured": step_s, "achieved_flops_per_s": achieved,
            "share_of_f32_peak": achieved / rooftool.PEAK_FLOPS_F32,
        }
        if not (flops > 0 and mf > 0 and 0 < achieved <= rooftool.PEAK_FLOPS_F32):
            raise AssertionError(f"roofline {name}: the dry run's count does not fit the "
                                 f"measured step: {out[name]}")
    info = {"phase": "roofline", "nvidia_smi": device_info["nvidia_smi"], "arch": arch,
            "layers": layers, "mesh": "1x1", "cells": out,
            "note": "FLOPs count products and the scans (kernels/shape_only.py); bytes are "
                    "eager, unfused; the dry run's parameters are bf16, the measured "
                    "steps' f32 (the FLOPs are the same)",
            "phase_s": time.perf_counter() - t_phase}
    emit(info)
    return info


# --------------------------------------------------------------------- #
# Across ranks: FSDP, compressed DP, GPipe over pod, serving over data
# --------------------------------------------------------------------- #

DIST_BACKEND = "gloo"  # one card: NCCL refuses two ranks on it
DIST_MESH = ((2, 1), ("data", "model"))
PP_MESH = ((2,), ("pod",))
DIST_PARITY_ARCHS = ("qwen3-0.6b", "dbrx-132b")  # each at reduce_config(cfg, 8)
DIST_PARITY_PP_ARCHS = ("qwen3-0.6b",)  # the GPipe sub-run (dbrx left out for time)
DIST_PARITY_BATCH = (4, 64)  # global rows x seq of the train steps
DIST_PARITY_STEPS = 3
DIST_PARITY_PP_LAYERS = 4  # 2 stages of 2 (reduce 8 leaves 3 and 5 layers)
DIST_PARITY_PROMPTS = ((4, 16), (2, 45))  # 64 MoE groups (each rank its own); 45 (straddling)
DIST_PARITY_GEN = 8
DIST_TRAIN = ("qwen3-0.6b", 8, 1024)  # arch, global batch, seq: the train phase's
# The training across ranks (train_fsdp, train_tp, train_compressed,
# train_pp) at full width with the depth cut from 28 layers to 8, and
# steps cut from the train phase's 4, for the script's time limit: at 28
# layers an FSDP step moved 4.8 GB and a checkpoint 7.2 GB through
# host-staged gloo (~0.5 GB/s on an H100 host: 20 s a step, PERF.md); the
# checkpoint's shards go to rank 0 alone (a gather). One one-card run of
# the same 8 layers (train_fsdp's) is the baseline of all four.
DIST_TRAIN_LAYERS = 8
FSDP_STEPS, FSDP_CKPT_AT = 1, 1  # then the 1x2 run resumes at step 1
COMPRESSED_STEPS = 2
DIST_FIRST_RTOL, DIST_LATER_RTOL = 1e-5, 1e-3  # step 1; later steps (AdamW eps 1e-8)
PP_MICROBATCHES = 4  # of 2 x 1,024
PP_LOSS_RTOL = 1e-5  # tests/test_pipeline.py's bound
PP_GRAD_TOL = 1e-4  # of each leaf's largest magnitude
DIST_TIMEOUT_S = 600
DIST_BUDGET_S = 330  # all phases across ranks together (reported, not enforced)
# The model axis (tensor parallelism). tp_parity: card ranks against CPU
# ranks at reduce 8; serve_tp and train_tp at full width.
TP_SIZE = 2
TP_MESH = ((1, TP_SIZE), ("data", "model"))
TP_TRAIN_MESH = ((2, TP_SIZE), ("data", "model"))
TP_PARITY_SERVE_ARCHS = ("qwen3-0.6b", "dbrx-132b", "recurrentgemma-2b", "granite-20b",
                         "rwkv6-7b", "llama-3.2-vision-11b")
TP_PARITY_PROMPTS, TP_PARITY_GEN = (4, 16), 16
TP_PARITY_TRAIN_ARCHS = ("qwen3-0.6b", "dbrx-132b")
TP_PARITY_SEQ_ARCHS = ("qwen3-0.6b",)  # again with act_seq on model
# (layers or None for all, requests, prompt tokens, generated tokens);
# recurrentgemma-2b's depth cut as train_recurrentgemma's, its 2,048-slot
# ring sequence-sharded over the two ranks.
# 16 generated tokens (cut from the serve phases' 64 for the time limit:
# host-staged gloo takes ~200 ms a qwen3-0.6b decode step, measured on one
# H100).
SERVE_TP_RUNS = {"qwen3-0.6b": (None, 8, 1024, 16), "recurrentgemma-2b": (5, 8, 2048, 16)}
TRAIN_TP_STEPS = 2  # DIST_TRAIN on --mesh 1x2 from train_fsdp's checkpoint
TRAIN_SEQ_STEPS = 2  # then, in the same ranks, with act_seq on model
DIST_CHAIN_STEPS = FSDP_STEPS + TRAIN_TP_STEPS + 1  # and the elastic step


def _act_seq_rules() -> dict:
    """``train_rules`` with the residual stream's sequence over ``model``."""
    from repro_torch.distributed import sharding

    return {**sharding.train_rules(False), "act_seq": ("model",)}


def _free_card(device) -> None:
    """Return the parent's cached blocks before ranks share the card."""
    import torch

    if device == "cuda":
        torch.cuda.empty_cache()


def _np_tree(tree):
    from repro_torch.models.layers import tree_map

    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _on(tree, device):
    import torch

    from repro_torch.models.layers import tree_map

    return tree_map(lambda a: torch.from_numpy(np.array(a)).to(device), tree)


def _dist_parity_rank(comm, inputs: dict) -> dict:
    """Each arch of ``inputs`` on this rank: 3 FSDP steps, 3 compressed-DP
    steps, the 2-stage pipeline's loss and gradients (on a pod mesh of the
    same ranks; DIST_PARITY_PP_ARCHS only) and ``serve_batch`` over
    ``data``."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.distributed.comm import Comm
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
    from repro_torch.train import build_train_step, pipeline
    from repro_torch.train.compressed_dp import build_compressed_dp_train_step
    from repro_torch.train.steps import gather_state

    torch.backends.cuda.matmul.allow_tf32 = False
    pod = Comm(make_mesh(*PP_MESH), comm.rank, backend=comm.backend, device=comm.device)
    out = {}

    def opt():
        cfg = AdamWConfig(**TRAIN_PARITY_ADAMW)
        return AdamW(cfg, cosine_schedule(cfg.lr, warmup_steps=1, total_steps=DIST_PARITY_STEPS))

    for arch, inp in inputs.items():
        cfg = serve.reduce_config(configs.get_config(arch), 8)
        lm = LM(cfg)
        res = out[arch] = {}
        o = opt()
        step, sh, _ = build_train_step(lm, o, comm, remat=True)
        state = o.init(sharding.shard_tree(_on(inp["params"], "cpu"), sh.params, comm.mesh,
                                           comm.coords, comm.device))
        res["fsdp_losses"], res["compressed_losses"] = [], []
        for b in inp["batches"]:
            state, metrics = step(state, b)
            res["fsdp_losses"].append(float(metrics["loss"]))
        full = gather_state(state, sh, comm)
        del state
        o = opt()
        cstep, init, place = build_compressed_dp_train_step(lm, o, comm, remat=True)
        cstate = place(init(_on(inp["params"], "cpu")))
        for b in inp["batches"]:
            cstate, loss = cstep(cstate, b)
            res["compressed_losses"].append(float(loss))
        if comm.rank == 0:
            res["fsdp_params"], res["compressed_params"] = full.params, cstate.inner.params
        del full, cstate
        if "pp_params" in inp:
            plm = LM(dataclasses.replace(cfg, n_layers=DIST_PARITY_PP_LAYERS))
            pp = pipeline.build_pp_loss(plm, pod, n_microbatches=2)
            res["pp_loss"], grads = pipeline.pp_value_and_grad(
                pp, pipeline.stage_params(plm, _on(inp["pp_params"], comm.device), pod),
                {"tokens": inp["batches"][0]["tokens"]}, pod)
            res["pp_loss"] = float(res["pp_loss"])
            res["pp_grads"] = grads
        params = _on(inp["params"], comm.device)
        res["serve"] = [serve.serve_batch(lm, params, p, DIST_PARITY_GEN, comm=comm,
                                          return_logits=True) for p in inp["prompts"]]
        del params
    return out


def _dist_parity_inputs() -> dict:
    import torch

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import serve
    from repro_torch.models import LM

    inputs = {}
    for arch in DIST_PARITY_ARCHS:
        cfg = serve.reduce_config(configs.get_config(arch), 8)
        lm, plm = LM(cfg), LM(dataclasses.replace(cfg, n_layers=DIST_PARITY_PP_LAYERS))
        B, S = DIST_PARITY_BATCH
        data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                          seed=SEED + 1))
        rng = np.random.default_rng(SEED)
        inputs[arch] = {
            "params": _np_tree(lm.init(torch.Generator().manual_seed(SEED), torch.float32)),
            "batches": [data.batch(i) for i in range(DIST_PARITY_STEPS)],
            "prompts": [rng.integers(0, cfg.vocab_size, shape) for shape in DIST_PARITY_PROMPTS],
        }
        if arch in DIST_PARITY_PP_ARCHS:
            inputs[arch]["pp_params"] = _np_tree(plm.init(torch.Generator().manual_seed(SEED + 1),
                                                          torch.float32))
    return inputs


def _leaf_worst(got, want) -> float:
    """The largest |diff| / (1e-3 * max|leaf| + 1e-6) over the leaves."""
    from repro_torch.optim.adamw import leaves

    worst = 0.0
    for a, b in zip(leaves(got), leaves(want)):
        worst = max(worst, float((a - b).abs().max()) / (1e-3 * float(b.abs().max()) + 1e-6))
    return worst


def _ranks_info(recs) -> dict:
    from repro_torch.distributed.comm import summed_launches

    return {"max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in recs],
            "rank_s": [r["s"] for r in recs],
            "launches": summed_launches(recs),
            "launches_by_rank": [{k: v for k, v in r["launches"].items() if v}
                                 for r in recs],
            "comm_bytes_by_rank": [r["comm_bytes"] for r in recs]}


def _compare_parity(card: list, cpu: list) -> dict:
    """Per arch: the card ranks' results against the CPU ranks'."""
    out = {}
    for arch in DIST_PARITY_ARCHS:
        a0, b0 = card[0][arch], cpu[0][arch]
        row = {}
        for kind in ("fsdp", "compressed"):
            got = [r[arch][f"{kind}_losses"] for r in card]
            want = b0[f"{kind}_losses"]
            rel = max(float(np.max(np.abs(np.subtract(g, want)) / np.abs(want))) for g in got)
            row[kind] = {"losses": got[0], "cpu_losses": want, "max_loss_rel_diff": rel,
                         "max_param_diff_over_tolerance": _leaf_worst(a0[f"{kind}_params"],
                                                                      b0[f"{kind}_params"])}
            row[kind]["ok"] = (rel <= TRAIN_PARITY_LOSS_RTOL
                               and row[kind]["max_param_diff_over_tolerance"] <= 1.0)
        if arch in DIST_PARITY_PP_ARCHS:
            pp_rel = max(abs(r[arch]["pp_loss"] - b0["pp_loss"]) / abs(b0["pp_loss"])
                         for r in card)
            pp_worst = max(_leaf_worst(r[arch]["pp_grads"], s[arch]["pp_grads"])
                           for r, s in zip(card, cpu))
            row["pp"] = {"loss": a0["pp_loss"], "cpu_loss": b0["pp_loss"],
                         "loss_rel_diff": pp_rel, "max_grad_diff_over_tolerance": pp_worst,
                         "ok": pp_rel <= TRAIN_PARITY_LOSS_RTOL and pp_worst <= 1.0}
        serves = []
        for (tok, logits), (ctok, clogits) in zip(a0["serve"], b0["serve"]):
            diff, ok = _logit_diff(logits, clogits)
            serves.append({"shape": list(tok.shape), "tokens_equal": bool((tok == ctok).all()),
                           "max_logit_diff": diff, "ok": ok and bool((tok == ctok).all())})
        row["serve"] = serves
        out[arch] = row
    return out


def _spawn(pool, fn, mesh, *args, **kw):
    """``run_ranks(fn, mesh, *args, **kw)`` on ``pool``: a future of (the
    ranks' records, seconds)."""
    from repro_torch.distributed.comm import run_ranks

    def timed():
        t0 = time.perf_counter()
        recs = run_ranks(fn, mesh, *args, timeout_s=DIST_TIMEOUT_S, **kw)
        return recs, time.perf_counter() - t0

    return pool.submit(timed)


def phase_rank_parity(device="cuda") -> tuple:
    """dist_parity and tp_parity: card ranks (host-staged gloo, sharing the
    card) held against the same ranks on the CPU, at reduce 8. Nothing in
    them is timed, so their six spawns run at once; the phases that time
    something run after, alone. Returns both lines and the seconds of the
    whole.

    - ``dist_parity``: qwen3-0.6b and dbrx-132b on ``--mesh 2x1``: 3 FSDP
      steps and 3 compressed-DP steps (losses within rtol 1e-4, every
      parameter leaf within 1e-3 * max|leaf| + 1e-6; AdamW as
      TRAIN_PARITY_ADAMW), the 2-stage GPipe loss (rtol 1e-4) and its
      gradients (the leaf rule; qwen3-0.6b only), and the serve at 4 x 16
      and 2 x 45 prompts (greedy tokens equal, logits within 2e-3 abs +
      rel).
    - ``tp_parity``: on ``--mesh 1x2`` greedy serving of
      TP_PARITY_SERVE_ARCHS at 4 x 16 prompts and 16 generated tokens with
      float32 caches (tokens equal, logits within 2e-3 abs + rel; as
      recurrent_parity, a bf16 cache would hold rwkv6-7b to its drift, not
      to the port: `PERF.md` §7); granite-20b's and recurrentgemma-2b's
      caches sequence-sharded and merged by the decode kernel's
      log-sum-exp; the VLM with images. On ``--mesh 2x2`` 3 FSDP x TP
      steps of qwen3-0.6b and dbrx-132b (the dist_parity rules), then of
      TP_PARITY_SEQ_ARCHS with the residual stream split along the
      sequence (`_act_seq_rules`): card against CPU as the others, and
      within rtol 1e-5 (step 1) / 1e-3 of the same ranks' steps without.

    Where the card count reaches a mesh's size, the same over NCCL after;
    else "not run: 1 card"."""
    import torch

    from repro_torch.distributed.comm import run_ranks, summed_launches, transport_name
    from repro_torch.launch.mesh import make_mesh

    t_phase = time.perf_counter()
    _free_card(device)
    dist_in, tp_in = _dist_parity_inputs(), _tp_parity_inputs()
    mesh, one_two, two_two = make_mesh(*DIST_MESH), make_mesh(*TP_MESH), make_mesh(*TP_TRAIN_MESH)
    # The three CPU twins run at once, so the host's cores are split
    # between them, not each spawn's over its own mesh: three quarters to
    # dist_parity's two ranks, the longest (its work scales with threads:
    # tools/rank_transport.py), the rest to the model axis's six (one
    # thread each on 8 cores).
    cores = os.cpu_count() or 1
    threads = {"dist": max(1, cores * 3 // 4 // mesh.size),
               "tp": max(1, cores // 4 // (one_two.size + two_two.size))}
    card = dict(backend=DIST_BACKEND, device=device)
    cpu = dict(backend="gloo", device="cpu")
    with ThreadPoolExecutor(max_workers=6) as pool:
        runs = {"dist_card": _spawn(pool, _dist_parity_rank, mesh, dist_in, **card),
                "dist_cpu": _spawn(pool, _dist_parity_rank, mesh, dist_in, **cpu,
                                   threads=threads["dist"]),
                "tp_serve_card": _spawn(pool, _tp_serve_rank, one_two, tp_in["serve"], **card),
                "tp_train_card": _spawn(pool, _tp_train_rank, two_two, tp_in["train"], **card),
                "tp_serve_cpu": _spawn(pool, _tp_serve_rank, one_two, tp_in["serve"], **cpu,
                                       threads=threads["tp"]),
                "tp_train_cpu": _spawn(pool, _tp_train_rank, two_two, tp_in["train"], **cpu,
                                       threads=threads["tp"])}
        got = {k: f.result() for k, f in runs.items()}
    spawn_s = {k: v[1] for k, v in got.items()}
    recs = {k: v[0] for k, v in got.items()}
    block_s = time.perf_counter() - t_phase
    results = {k: [r["result"] for r in v] for k, v in recs.items()}
    bad = []

    # --- dist_parity
    archs = _compare_parity(results["dist_card"], results["dist_cpu"])
    nccl = "not run: 1 card"
    if device == "cuda" and torch.cuda.device_count() >= mesh.size:
        n_recs = run_ranks(_dist_parity_rank, mesh, dist_in, backend="nccl", device=device,
                           timeout_s=DIST_TIMEOUT_S)
        nccl = {"transport": transport_name("nccl", device, mesh.size), **_ranks_info(n_recs),
                "archs": _compare_parity([r["result"] for r in n_recs], results["dist_cpu"])}
    dist_info = {"phase": "dist_parity",
                 "transport": transport_name(DIST_BACKEND, device, mesh.size),
                 "reference_transport": transport_name("gloo", "cpu", mesh.size),
                 "config": {"reduce": 8, "batch": list(DIST_PARITY_BATCH),
                            "steps": DIST_PARITY_STEPS, "pp_layers": DIST_PARITY_PP_LAYERS,
                            "prompts": [list(p) for p in DIST_PARITY_PROMPTS],
                            "gen": DIST_PARITY_GEN, "adamw": TRAIN_PARITY_ADAMW},
                 "archs": archs, **_ranks_info(recs["dist_card"]),
                 "card_s": spawn_s["dist_card"], "cpu_s": spawn_s["dist_cpu"],
                 "cpu_threads_a_rank": threads, "nccl": nccl,
                 "block_s": block_s, "note": "spawns at once with tp_parity's (block_s)"}
    emit(dist_info)
    bad += [(arch, k) for arch, row in archs.items() for k, v in row.items()
            if not (all(s["ok"] for s in v) if isinstance(v, list) else v["ok"])]
    if isinstance(nccl, dict):
        bad += [("nccl", arch, k) for arch, row in nccl["archs"].items() for k, v in row.items()
                if not (all(s["ok"] for s in v) if isinstance(v, list) else v["ok"])]
    if device == "cuda" and not dist_info["launches"]["flash_attention"]:
        bad.append("dist_parity: no flash launch")

    # --- tp_parity
    checks = _compare_tp(results["tp_serve_card"], results["tp_serve_cpu"],
                         results["tp_train_card"], results["tp_train_cpu"])
    tp_nccl = "not run: 1 card"
    if device == "cuda" and torch.cuda.device_count() >= one_two.size:
        serves = run_ranks(_tp_serve_rank, one_two, tp_in["serve"], backend="nccl",
                           device=device, timeout_s=DIST_TIMEOUT_S)
        on_four = torch.cuda.device_count() >= two_two.size
        trains = (run_ranks(_tp_train_rank, two_two, tp_in["train"], backend="nccl",
                            device=device, timeout_s=DIST_TIMEOUT_S)
                  if on_four else recs["tp_train_card"])
        tp_nccl = {"checks": _compare_tp([r["result"] for r in serves], results["tp_serve_cpu"],
                                         [r["result"] for r in trains],
                                         results["tp_train_cpu"]),
                   "transport": transport_name("nccl", device, one_two.size),
                   "train_2x2": on_four}
    serve_recs = recs["tp_serve_card"]
    tp_info = {
        "phase": "tp_parity",
        "transport": {"serve": transport_name(DIST_BACKEND, device, one_two.size),
                      "train": transport_name(DIST_BACKEND, device, two_two.size)},
        "reference_transport": "gloo, the same ranks on cpu",
        "config": {"reduce": 8, "serve_mesh": "1x2", "train_mesh": "2x2",
                   "prompts": list(TP_PARITY_PROMPTS), "gen": TP_PARITY_GEN,
                   "cache_dtype": "float32", "train_batch": list(DIST_PARITY_BATCH),
                   "steps": DIST_PARITY_STEPS, "adamw": TRAIN_PARITY_ADAMW,
                   "act_seq_archs": list(TP_PARITY_SEQ_ARCHS)},
        "checks": checks, "nccl": tp_nccl,
        "decode_lse_launches_by_rank": [r["decode_lse_launches"] for r in serve_recs],
        "serve_ranks": _ranks_info(serve_recs), "train_ranks": _ranks_info(recs["tp_train_card"]),
        "launches": summed_launches(serve_recs + recs["tp_train_card"]),
        "card_1x2_spawn_s": spawn_s["tp_serve_card"],
        "card_2x2_spawn_s": spawn_s["tp_train_card"],
        "cpu_1x2_spawn_s": spawn_s["tp_serve_cpu"], "cpu_2x2_spawn_s": spawn_s["tp_train_cpu"],
        "block_s": block_s, "note": "spawns at once with dist_parity's (block_s)"}
    emit(tp_info)
    bad += [k for k, v in checks.items() if not v["ok"]]
    if isinstance(tp_nccl, dict):
        bad += [("nccl", k) for k, v in tp_nccl["checks"].items() if not v["ok"]]
    if device == "cuda" and not (tp_info["launches"]["flash_attention"]
                                 and all(tp_info["decode_lse_launches_by_rank"])):
        bad.append("tp_parity: no flash launch or no log-sum-exp decode on a rank")
    if bad:
        raise AssertionError(f"rank parity failed: {bad}")
    return {"dist_parity": dist_info, "tp_parity": tp_info}, block_s


def _dist_cfg(reduce: int):
    """DIST_TRAIN's arch at ``reduce`` (full width at 1), its depth cut to
    DIST_TRAIN_LAYERS."""
    from repro_torch import configs
    from repro_torch.launch import serve

    return _cut_depth(serve.reduce_config, DIST_TRAIN_LAYERS, configs.get_config(DIST_TRAIN[0]),
                      reduce)


def _cut_depth(reduce_config, n_layers: int, cfg, factor: int):
    """``reduce_config(cfg, factor)`` with at most ``n_layers`` layers."""
    cut = reduce_config(cfg, factor)
    return dataclasses.replace(cut, n_layers=min(n_layers, cut.n_layers))


def _cut_depth_rank(n_layers: int, comm, args):
    """A rank of ``launch.train --mesh`` under `_launch_depth` (a spawned
    process: the parent's patch is not there)."""
    import functools

    from repro_torch.launch import train as train_mod

    rank_fn = train_mod._train_rank
    train_mod.reduce_config = functools.partial(_cut_depth, train_mod.reduce_config, n_layers)
    return rank_fn(comm, args)


@contextlib.contextmanager
def _launch_depth(n_layers: int):
    """``launch.train.main`` with the model's depth cut to ``n_layers`` (its
    width as ``--reduce`` gives it), on one device and in the ranks of a
    ``--mesh`` run."""
    import functools

    from repro_torch.launch import train as train_mod

    saved = train_mod.reduce_config, train_mod._train_rank
    train_mod.reduce_config = functools.partial(_cut_depth, saved[0], n_layers)
    train_mod._train_rank = functools.partial(_cut_depth_rank, n_layers)
    try:
        yield
    finally:
        train_mod.reduce_config, train_mod._train_rank = saved


def _act_seq_steps(comm, args) -> dict:
    """TRAIN_SEQ_STEPS steps of ``build_train_step`` under `_act_seq_rules`
    from the weights and batches of ``launch.train``'s rank with ``args``
    (its seed-0 draw, its `SyntheticLMData` and schedule): per step the
    loss, grad norm, host seconds and bytes moved by collective kind."""
    import torch

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
    from repro_torch.train import build_train_step

    lm = LM(train_mod.reduce_config(configs.get_config(args.arch), args.reduce))
    opt = AdamW(AdamWConfig(lr=args.lr),
                schedule=cosine_schedule(args.lr, warmup_steps=10, total_steps=args.steps))
    step_fn, sh, _ = build_train_step(lm, opt, comm, _act_seq_rules(), remat=True)
    data = SyntheticLMData(DataConfig(vocab_size=lm.cfg.vocab_size, seq_len=args.seq,
                                      global_batch=args.batch, mode=args.data_mode))
    params = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    state = opt.init(sharding.shard_tree(params, sh.params, comm.mesh, comm.coords,
                                         comm.device))
    del params
    steps = []
    for step in range(TRAIN_SEQ_STEPS):
        moved = dict(comm.bytes)
        t0 = time.perf_counter()
        state, metrics = step_fn(state, data.batch(step))
        steps.append({"step": step, "loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "s": time.perf_counter() - t0,
                      "comm_bytes": {k: v - moved.get(k, 0) for k, v in comm.bytes.items()
                                     if v > moved.get(k, 0)}})
    return {"losses": [r["loss"] for r in steps], "steps": steps}


def _tp_seq_rank(n_layers: int, comm, args):
    """A rank of train_tp's ``--mesh 1x2`` run: ``launch.train``'s
    (`_cut_depth_rank`), then `_act_seq_steps` with the launch counts and
    the peak memory set to 0 before them. Rank 0's record gets, under
    ``act_seq``, the steps and every rank's launches and peak memory of
    both runs."""
    import torch

    from repro_torch import kernels

    out = _cut_depth_rank(n_layers, comm, args)
    on_card = comm.device.type == "cuda"

    def peak():
        return torch.cuda.max_memory_allocated(comm.device) if on_card else 0

    names = sorted(kernels.launch_counts())
    runs = [(kernels.launch_counts(), peak())]
    kernels.reset_launch_counts()
    if on_card:
        torch.cuda.reset_peak_memory_stats(comm.device)
    seq = _act_seq_steps(comm, args)
    runs.append((kernels.launch_counts(), peak()))
    mine = torch.tensor([[m] + [c[k] for k in names] for c, m in runs], dtype=torch.float64)
    parts = comm.gather(mine, tuple(comm.mesh.axis_names))
    if parts is not None:
        for i, key in enumerate(("without", "with")):
            seq[f"{key}_by_rank"] = [
                {"max_memory_allocated": int(p[i, 0]),
                 "launches": {k: int(p[i, j + 1]) for j, k in enumerate(names)}}
                for p in parts]
        out["record"]["act_seq"] = seq
    return out


def phase_train_fsdp(device="cuda", reduce: int = 1, batch: int = DIST_TRAIN[1],
                     seq: int = DIST_TRAIN[2]) -> dict:
    """``launch.train.main`` of qwen3-0.6b (at full width with ``reduce``
    1), its depth cut to DIST_TRAIN_LAYERS (`_launch_depth`), the train
    phase's global batches and seed, as one chain of checkpoints:

    - one device, DIST_CHAIN_STEPS steps: the baseline of every training
      phase across ranks;
    - ``--mesh 2x1 --dist-backend gloo`` (FSDP): step 0 and a checkpoint
      at 1;
    - ``--mesh 1x2`` (tensor parallelism) resumed from that checkpoint
      alone: TRAIN_TP_STEPS steps and a checkpoint at the last, gathered
      to rank 0; in its ranks after them, TRAIN_SEQ_STEPS steps from the
      seed's weights with the residual stream split along the sequence
      (`_tp_seq_rank`);
    - the elastic restart: that checkpoint (written by two model ranks)
      restored on one rank (``elastic_mesh(1, 1)``'s shardings), and the
      next step taken on one device.

    Every loss against the one-device run's at its step (the ``act_seq``
    steps from step 0): step 1 within rtol 1e-5, later 1e-3. Emits the
    train_fsdp line (the FSDP step, the elastic one, the baseline) and the
    train_tp line (the tensor-parallel steps and, under ``act_seq``, the
    sequence-parallel ones: step ms (each run's second step), bytes a step
    per collective kind, peak memory and launches a rank, the ``act_seq``
    run's counted from 0); returns both records, train_tp's under
    ``"train_tp"``. The FSDP run's one step is its first: ``step_ms``
    includes its warm-up."""
    import functools
    import shutil

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed import sharding
    from repro_torch.distributed.elastic import elastic_mesh
    from repro_torch.launch import train as train_mod
    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import AdamW, AdamWConfig, TrainState, cosine_schedule
    from repro_torch.train import build_train_step
    from repro_torch.train.steps import train_state_shardings

    t_phase = time.perf_counter()
    _free_card(device)
    arch = DIST_TRAIN[0]
    root = ROOT / "build" / "ckpt_train_fsdp"
    shutil.rmtree(root, ignore_errors=True)
    tp_at = FSDP_CKPT_AT + TRAIN_TP_STEPS  # the tensor-parallel run's checkpoint
    # Every step lies in launch.train's 10-step warm-up, so its learning
    # rate is the one-device run's whatever --steps says.
    argv = ["--arch", arch, "--reduce", str(reduce), "--batch", str(batch), "--seq", str(seq),
            "--log-every", "1", "--device", device]
    try:
        with _launch_depth(DIST_TRAIN_LAYERS):
            one_card = {}
            t0 = time.perf_counter()
            single = {"losses": train_mod.main(argv + ["--steps", str(DIST_CHAIN_STEPS)],
                                               record=one_card)}
            single_s = time.perf_counter() - t0
            single["grad_norms"] = [r["grad_norm"] for r in one_card["steps"]]
            single["step_ms"] = float(np.median([r["s"] for r in one_card["steps"][1:]])) * 1e3
            _free_card(device)
            first = {}
            t0 = time.perf_counter()
            losses = train_mod.main(
                argv + ["--mesh", "2x1", "--dist-backend", DIST_BACKEND, "--steps",
                        str(FSDP_STEPS), "--ckpt-every", str(FSDP_CKPT_AT), "--ckpt-dir",
                        str(root / "a")], record=first)
            first_s = time.perf_counter() - t0
            os.makedirs(root / "b")
            shutil.copytree(root / "a" / f"step_{FSDP_CKPT_AT:08d}",
                            root / "b" / f"step_{FSDP_CKPT_AT:08d}")
            train_mod._train_rank = functools.partial(_tp_seq_rank, DIST_TRAIN_LAYERS)
            tp_rec = {}
            t0 = time.perf_counter()
            tp_losses = train_mod.main(
                argv + ["--mesh", "1x2", "--dist-backend", DIST_BACKEND, "--steps", str(tp_at),
                        "--ckpt-every", str(tp_at), "--ckpt-dir", str(root / "b"), "--resume"],
                record=tp_rec)
            tp_s = time.perf_counter() - t0

        # Elastic restart: the tensor-parallel run's checkpoint on one rank,
        # one step on.
        t0 = time.perf_counter()
        cfg = _dist_cfg(reduce)
        lm = LM(cfg)
        specs = lm.param_specs()
        one = elastic_mesh(1, 1)
        _, sh = train_state_shardings(lm, None, one, sharding.train_rules(False))
        index = tree_map(lambda p, s: sharding.shard_index(s, p.shape, one, one.coords(0)),
                         specs, sh.params)
        state = CheckpointManager(str(root / "b")).restore(
            TrainState(specs, specs, specs, 0), step=tp_at, device=device,
            shardings=TrainState(index, index, index, ()))
        elastic_step = int(state.step)
        lr = 3e-3  # launch.train's default
        opt = AdamW(AdamWConfig(lr=lr), cosine_schedule(lr, warmup_steps=10,
                                                         total_steps=tp_at + 1))
        data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                          global_batch=batch))
        b = {k: torch.as_tensor(v, device=device) for k, v in data.batch(tp_at).items()}
        elastic_loss = float(build_train_step(lm, opt, remat=True)(state, b)[1]["loss"])
        del state
        elastic_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # Step 0 (FSDP), steps 1 .. tp_at - 1 (TP) and the elastic one, against
    # the one-device run's.
    run = losses + tp_losses + [elastic_loss]
    want = single["losses"]
    rel = np.abs(np.subtract(run, want[:len(run)])) / np.abs(want[:len(run)])
    steps = first["steps"]
    info = {"phase": "train_fsdp", "transport": first["transport"], "arch": arch,
            "reduce": reduce, "layers": cfg.n_layers, "batch": batch, "seq": seq,
            "steps": FSDP_STEPS, "checkpoint_at": FSDP_CKPT_AT,
            "chain": "2x1 FSDP step 0 -> 1x2 TP steps 1-2 (train_tp) -> elastic step 3",
            "params": first["n_params"], "losses": losses, "chain_losses": run,
            "single_card_losses": want, "loss_rel_diff": rel.tolist(),
            "single_card_grad_norms": single["grad_norms"],
            "rtol": [DIST_FIRST_RTOL, DIST_LATER_RTOL],
            "elastic": {"mesh": one.shape, "restored_step": elastic_step, "loss": elastic_loss,
                        "s": elastic_s},
            "step_s": [r["s"] for r in steps], "step_ms": steps[0]["s"] * 1e3,
            "single_card_step_ms": single["step_ms"], "single_card_run_s": single_s,
            "tokens_per_s": batch * seq / steps[0]["s"],
            "comm_bytes_per_step": steps[-1]["comm_bytes"],
            "first_run_s": first_s, "tp_run_s": tp_s,
            "max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in first["ranks"]],
            "launches": {k: sum(r["launches"][k] for r in first["ranks"])
                         for k in first["ranks"][0]["launches"]},
            "phase_s": time.perf_counter() - t_phase}
    tp = _train_tp_line(tp_rec, tp_losses, want, tp_s, single["step_ms"], batch, seq, cfg,
                        device)
    emit(info)
    emit(tp)
    ok = (len(run) == len(want) and rel[0] <= DIST_FIRST_RTOL
          and (rel[1:] <= DIST_LATER_RTOL).all() and elastic_step == tp_at
          and np.isfinite(run).all() and tp["ok"])
    if device == "cuda":  # both ranks, every step of the FSDP run
        launches = {k: 2 * FSDP_STEPS * v for k, v in _train_launches(cfg, seq).items()}
        ok = ok and all(info["launches"][k] == v for k, v in launches.items())
    if not ok:
        raise AssertionError(f"train_fsdp / train_tp failed: {info} {tp}")
    return {**info, "train_tp": tp}


def _train_tp_line(rec: dict, losses: list, single: list, run_s: float, single_step_ms: float,
                   batch: int, seq: int, cfg, device) -> dict:
    """train_fsdp's tensor-parallel run (``rec``, from ``launch.train``'s
    ``record``; ``losses`` from its checkpoint's step on) and the
    ``act_seq`` steps of its ranks, against the one-device ``single``
    losses; ``ok`` as `phase_train_fsdp` holds them."""
    act = rec["act_seq"]
    start = rec["steps"][0]["step"]
    want = single[start:start + len(losses)]
    rel = np.abs(np.subtract(losses, want)) / np.abs(want)
    seq_want = single[:TRAIN_SEQ_STEPS]
    seq_rel = np.abs(np.subtract(act["losses"], seq_want)) / np.abs(seq_want)
    act_seq = {
        "rules": "train_rules with act_seq on model", "steps": TRAIN_SEQ_STEPS,
        "losses": act["losses"], "single_card_losses": seq_want,
        "loss_rel_diff": seq_rel.tolist(), "grad_norms": [r["grad_norm"] for r in act["steps"]],
        "step_s": [r["s"] for r in act["steps"]],
        "step_ms": min(r["s"] for r in act["steps"][1:]) * 1e3,
        "comm_bytes_per_step": act["steps"][-1]["comm_bytes"],
        "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                         for r in act["with_by_rank"]],
        "launches": {k: sum(r["launches"][k] for r in act["with_by_rank"])
                     for k in act["with_by_rank"][0]["launches"]}}
    steps = rec["steps"]
    info = {
        "phase": "train_tp", "transport": rec["transport"], "mesh": "1x2",
        "arch": DIST_TRAIN[0], "layers": cfg.n_layers, "batch": batch, "seq": seq,
        "steps": TRAIN_TP_STEPS, "resumed_from": f"train_fsdp's 2x1 checkpoint at {start}",
        "params": rec["n_params"], "losses": losses, "single_card_losses": want,
        "loss_rel_diff": rel.tolist(), "rtol": [DIST_FIRST_RTOL, DIST_LATER_RTOL],
        "step_s": [r["s"] for r in steps], "step_ms": min(r["s"] for r in steps[1:]) * 1e3,
        "single_card_step_ms": single_step_ms,
        "comm_bytes_per_step": steps[-1]["comm_bytes"], "run_s": run_s,
        "max_memory_allocated_by_rank": [r["max_memory_allocated"]
                                         for r in act["without_by_rank"]],
        "rank_s": [r["s"] for r in rec["ranks"]],
        "launches": {k: sum(r["launches"][k] for r in act["without_by_rank"])
                     for k in act["without_by_rank"][0]["launches"]},
        "act_seq": act_seq, "in_chain_of": "train_fsdp"}
    ok = (len(losses) == TRAIN_TP_STEPS and np.isfinite(losses).all()
          and (rel <= DIST_LATER_RTOL).all() and len(seq_rel) == TRAIN_SEQ_STEPS
          and np.isfinite(act["losses"]).all() and seq_rel[0] <= DIST_FIRST_RTOL
          and (seq_rel[1:] <= DIST_LATER_RTOL).all())
    if device == "cuda":  # both ranks, every step
        per = _train_launches(cfg, seq)
        ok = ok and all(info["launches"][k] == 2 * TRAIN_TP_STEPS * v
                        and act_seq["launches"][k] == 2 * TRAIN_SEQ_STEPS * v
                        for k, v in per.items())
    return {**info, "ok": bool(ok)}


def _compressed_pp_rank(comm, arch: str, reduce: int, batch: int, seq: int,
                        n_microbatches: int) -> dict:
    """Both runs of one spawn, from seed 0's weights drawn once: the
    2-stage GPipe loss and this stage's gradients on a pod mesh of the same
    ranks (rank 1 leaves out the replicated leaves: rank 0's are equal),
    then COMPRESSED_STEPS compressed-DP steps (remat) on ``comm``'s data
    mesh over the global batches of ``launch.train``'s data and its
    optimizer. After the first compressed step: the global norm of the
    synchronised gradient that AdamW was given, and the mean over the ranks
    of the norm of each rank's new error-feedback residual."""
    import torch

    from repro_torch import kernels
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed.comm import Comm
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map
    from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
    from repro_torch.optim.adamw import leaves
    from repro_torch.optim.compression import payload_bytes
    from repro_torch.train import pipeline
    from repro_torch.train.compressed_dp import build_compressed_dp_train_step

    class NormKeeping(AdamW):
        """AdamW that keeps the global norm of the gradients it is given."""

        def global_norm(self, grads):
            self.norm = super().global_norm(grads)
            return self.norm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _dist_cfg(reduce)
    lm = LM(cfg)
    params = lm.init(torch.Generator().manual_seed(0), dtype=torch.float32)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch))

    # GPipe first: it reads the weights and leaves them as they are.
    pod = Comm(make_mesh(*PP_MESH), comm.rank, backend=comm.backend, device=comm.device)
    sp = tree_map(lambda t: t.to(comm.device), pipeline.stage_params(lm, params, pod))
    t0 = time.perf_counter()
    pp_loss, grads = pipeline.pp_value_and_grad(
        pipeline.build_pp_loss(lm, pod, n_microbatches=n_microbatches), sp,
        {"tokens": data.batch(0)["tokens"]}, pod)
    pp_loss = float(pp_loss)  # waits for the device
    pp_s = time.perf_counter() - t0
    if comm.rank:
        grads = {"blocks": grads["blocks"]}
    del sp
    pp_launches = kernels.launch_counts()

    lr = 3e-3
    opt = NormKeeping(AdamWConfig(lr=lr), cosine_schedule(lr, warmup_steps=10,
                                                           total_steps=COMPRESSED_STEPS))
    step, init, place = build_compressed_dp_train_step(lm, opt, comm, remat=True)
    state = place(init(params))
    del params
    losses, secs, moved = [], [], []
    for i in range(COMPRESSED_STEPS):
        before = dict(comm.bytes)
        t0 = time.perf_counter()
        state, loss = step(state, data.batch(i))
        losses.append(float(loss))
        secs.append(time.perf_counter() - t0)
        moved.append({k: v - before.get(k, 0) for k, v in comm.bytes.items()})
        if i == 0:
            synced_norm = float(opt.norm)
            err = torch.sqrt(sum(torch.sum(torch.square(e)) for e in leaves(state.error)))
            error_norm = float(comm.all_reduce(err, "data")) / comm.axis_size("data")
    return {"pp": {"loss": pp_loss, "grads": grads, "s": pp_s, "launches": pp_launches},
            "losses": losses, "step_s": secs, "comm_bytes": moved,
            "payload": payload_bytes(state.inner.params), "synced_norm": synced_norm,
            "error_norm": error_norm}


def phase_train_compressed_pp(fsdp: dict, device="cuda", reduce: int = 1,
                              batch: int = DIST_TRAIN[1], seq: int = DIST_TRAIN[2],
                              n_microbatches: int = PP_MICROBATCHES) -> dict:
    """Two runs of one spawn of two ranks, the weights drawn once
    (`_compressed_pp_rank`); two lines, ``train_pp`` and
    ``train_compressed``.

    GPipe: train_fsdp's model (qwen3-0.6b, full width with ``reduce`` 1,
    DIST_TRAIN_LAYERS layers) as 2 stages of 4 layers over ``pod``, 4 microbatches of 2 x 1,024: the loss within rtol
    1e-5 of the serial loss on the same device (remat, the same weights and
    tokens) and every gradient leaf within 1e-4 of its largest magnitude;
    flash launches per rank.

    Compressed DP (int8 error feedback): the train_fsdp phase's model and
    batches, 2 steps (cut from 4 for the time limit): step ms (the second
    step's), the int32 payload's bytes against the float32 gradients',
    losses beside FSDP's. Held to train_fsdp's one-device run
    (``fsdp["single_card_*"]``): step 1's loss within rtol 1e-5
    (compression acts only on the update), and the norm of the
    synchronised step-1 gradient within the error feedback's own bound of
    the exact mean gradient's norm. The synchronised sum is mean(g) -
    mean(e) for the ranks' new residuals e, so the two norms differ by at
    most mean_r |e_r| (plus 1e-3 of the norm for float sums): a wrong scale
    or a missing rank's share breaks it. Returns both lines' records and
    the launches of the spawn."""
    import torch

    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.distributed.comm import run_ranks, transport_name
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM
    from repro_torch.models.layers import tree_map
    from repro_torch.optim.adamw import leaves
    from repro_torch.train import loss_and_grads

    t_phase = time.perf_counter()
    _free_card(device)
    arch = DIST_TRAIN[0]
    cfg = _dist_cfg(reduce)
    lm = LM(cfg)
    tokens = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                        global_batch=batch)).batch(0)["tokens"]
    t0 = time.perf_counter()
    params = tree_map(lambda t: t.to(device),
                      lm.init(torch.Generator().manual_seed(0), dtype=torch.float32))
    serial, grads = loss_and_grads(lm, params, {"tokens": torch.as_tensor(tokens, device=device)},
                                   remat=True)
    serial = float(serial)
    grads = tree_map(lambda g: g.cpu(), grads)
    serial_s = time.perf_counter() - t0
    del params
    _free_card(device)
    mesh = make_mesh(*DIST_MESH)
    transport = transport_name(DIST_BACKEND, device, mesh.size)
    t0 = time.perf_counter()
    recs = run_ranks(_compressed_pp_rank, mesh, arch, reduce, batch, seq, n_microbatches,
                     backend=DIST_BACKEND, device=device, timeout_s=DIST_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    ranks = _ranks_info(recs)

    half = cfg.n_superblocks // mesh.size
    worst = 0.0
    for r in recs:
        got, stage = r["result"]["pp"]["grads"], r["rank"]
        want = {**grads, "blocks": tree_map(lambda t: t[stage * half:(stage + 1) * half],
                                            grads["blocks"])}
        want = {k: want[k] for k in got}
        for a, b in zip(leaves(got), leaves(want)):
            worst = max(worst, float((a - b).abs().max()) / (PP_GRAD_TOL * float(b.abs().max())))
    pp_losses = [r["result"]["pp"]["loss"] for r in recs]
    rel = max(abs(x - serial) / abs(serial) for x in pp_losses)
    pp = {"phase": "train_pp", "transport": transport, "arch": arch, "reduce": reduce,
          "stages": mesh.size, "layers_per_stage": half, "microbatches": n_microbatches,
          "microbatch": [batch // n_microbatches, seq], "pp_loss": pp_losses[0],
          "serial_loss": serial, "loss_rel_diff": rel, "loss_rtol": PP_LOSS_RTOL,
          "max_grad_diff_over_tolerance": worst, "grad_tol": PP_GRAD_TOL,
          "pp_s": [r["result"]["pp"]["s"] for r in recs], "serial_s": serial_s,
          "flash_launches_by_rank": [r["result"]["pp"]["launches"]["flash_attention"]
                                     for r in recs],
          "spawn_s": spawn_s, "note": "one spawn with train_compressed: launches and memory "
                                      "in that line"}
    emit(pp)
    # Each stage runs its layers once per microbatch (no remat under PP).
    want_flash = [half * n_microbatches] * mesh.size
    if rel > PP_LOSS_RTOL or worst > 1.0 or (
            device == "cuda" and pp["flash_launches_by_rank"] != want_flash):
        raise AssertionError(f"train_pp failed (flash launches expected {want_flash}): {pp}")

    r0 = recs[0]["result"]
    step_s = float(np.median(r0["step_s"][1:]))
    exact_loss, exact_norm = fsdp["single_card_losses"][0], fsdp["single_card_grad_norms"][0]
    loss_rel = abs(r0["losses"][0] - exact_loss) / abs(exact_loss)
    norm_gap = abs(r0["synced_norm"] - exact_norm)
    norm_bound = r0["error_norm"] + 1e-3 * exact_norm
    info = {"phase": "train_compressed", "transport": transport,
            "arch": arch, "reduce": reduce, "batch": batch, "seq": seq,
            "steps": COMPRESSED_STEPS, "remat": True, "losses": r0["losses"],
            "fsdp_losses": fsdp["losses"], "step_s": r0["step_s"],
            "step_ms": step_s * 1e3, "fsdp_step_ms": fsdp["step_ms"],
            "tokens_per_s": batch * seq / step_s,
            "single_card_first_loss": exact_loss, "first_loss_rel_diff": loss_rel,
            "first_loss_rtol": DIST_FIRST_RTOL,
            "first_grad_norm": {"synced": r0["synced_norm"], "single_card": exact_norm,
                                "gap": norm_gap, "bound": norm_bound,
                                "mean_error_norm": r0["error_norm"]},
            "payload_bytes": r0["payload"], "comm_bytes_per_step": r0["comm_bytes"][-1],
            **ranks, "spawn_s": spawn_s, "phase_s": time.perf_counter() - t_phase}
    emit(info)
    if not (np.isfinite(r0["losses"]).all()
            and all(r["result"]["losses"] == r0["losses"] for r in recs)
            and loss_rel <= DIST_FIRST_RTOL and norm_gap <= norm_bound):
        raise AssertionError(f"train_compressed failed: {info}")
    return {"train_pp": pp, "train_compressed": info, "launches": ranks["launches"],
            "phase_s": info["phase_s"]}


def phase_serve_dp(served: Optional[dict] = None, device="cuda", reduce: int = 1,
                   requests: int = SERVE_REQUESTS, prompt_len: int = SERVE_PROMPT,
                   gen: int = SERVE_GEN) -> dict:
    """``launch.serve --mesh 2x1 --dist-backend gloo`` of qwen3-0.6b (full
    width with ``reduce`` 1): 8 requests of 1,024 prompt tokens, 64
    generated, 4 on each rank (warmed up first). Prefill seconds, decode
    ms a step and tokens/s of the slower rank, beside the single-card serve
    phase's (``served``); launches exactly twice one rank's serve. Held to
    ``launch.serve --mesh 1x1`` on the card (the same seed-0 weights and
    prompts; the serve phase draws its weights on the card, so they
    differ): in each request, the tokens up to where the two runs first
    part and the logits up to and including that step within PARITY_TOL
    (abs + rel). Two greedy runs part only where the logits they disagree
    on are that close, a near tie; a wrong gather order parts at step 0
    with logits far apart."""
    from repro_torch import configs
    from repro_torch.launch import serve

    t_phase = time.perf_counter()
    _free_card(device)
    argv = ["--arch", SERVE_ARCH, "--reduce", str(reduce), "--requests", str(requests),
            "--prompt-len", str(prompt_len), "--gen", str(gen), "--device", device]
    rec, one = {}, {}
    tokens = serve.main(argv + ["--mesh", "2x1", "--dist-backend", DIST_BACKEND], record=rec)
    one_tokens = serve.main(argv + ["--mesh", "1x1"], record=one)
    agree = _greedy_agreement(tokens, rec.pop("logits"), one_tokens, one.pop("logits"))
    _free_card(device)
    cfg = serve.reduce_config(configs.get_config(SERVE_ARCH), reduce)
    t = [r["timings"] for r in rec["ranks"]]
    prefill = max(x["prefill_s"] for x in t)
    decode = max(x["decode_s"] for x in t)
    step_ms = decode * 1e3 / t[0]["decode_steps"]
    launches = {k: sum(r["launches"][k] for r in rec["ranks"]) for k in rec["ranks"][0]["launches"]}
    per_rank = _serve_launches(cfg, prompt_len, gen)
    info = {"phase": "serve_dp", "transport": rec["transport"], "arch": cfg.name,
            "layers": cfg.n_layers, "requests": requests, "prompt_len": prompt_len, "gen": gen,
            "prefill_s": prefill, "decode_ms_per_step": step_ms,
            "tokens_per_s": requests * gen / (prefill + decode),
            "timings_by_rank": t,
            "single_card": None if served is None else {
                k: served[k] for k in ("prefill_s", "decode_ms_per_step", "tokens_per_s")},
            "max_memory_allocated_by_rank": [r["max_memory_allocated"] for r in rec["ranks"]],
            "comm_bytes_by_rank": [r["comm_bytes"] for r in rec["ranks"]],
            "launches": launches, "tokens_head": tokens[:2, :8].tolist(),
            "against_one_card": agree, "phase_s": time.perf_counter() - t_phase}
    emit(info)
    if tokens.shape != (requests, gen) or tokens.min() < 0 or tokens.max() >= cfg.vocab_size \
            or not agree["ok"] \
            or (device == "cuda" and any(launches[k] != 2 * v for k, v in per_rank.items())):
        raise AssertionError(f"serve_dp failed (launches per rank {per_rank}): {info}")
    return info


def _tp_generate(lm, params, prompts, gen: int, images, comm, cache_dtype=None):
    """Greedy serving on a rank of a model mesh, its rows the whole batch:
    `LM.prefill` (images in the batch where the arch has cross layers) and
    `LM.decode_step` under ``serve_rules`` on this rank's shards, the cache
    in ``cache_dtype``, the vocab-parallel argmax, the logits gathered once
    a step."""
    import torch

    from repro_torch.distributed import sharding
    from repro_torch.distributed.tensor_parallel import TensorParallel

    s_max = prompts.shape[1] + gen
    tp = TensorParallel(comm, comm.axis_size("model"), comm.axis_index("model"))
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.long, device=comm.device)}
    if images is not None:
        batch["images"] = images
    with sharding.activation_ctx(comm, sharding.serve_rules(False)):
        logits, cache, lengths = lm.prefill(params, batch, s_max=s_max, cache_dtype=cache_dtype)
        toks, seen = [tp.argmax(logits)], [tp.gather(logits, -1)]
        for _ in range(gen - 1):
            logits, cache, lengths = lm.decode_step(params, {"tokens": toks[-1][:, None]},
                                                    cache, lengths, s_max=s_max)
            toks.append(tp.argmax(logits))
            seen.append(tp.gather(logits, -1))
    return torch.stack(toks, 1).cpu().numpy(), torch.stack(seen, 1).float().cpu().numpy()


def _tp_parity_inputs() -> dict:
    import torch

    from repro_torch import configs
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.launch import serve
    from repro_torch.models import LM

    out = {"serve": {}, "train": {}}
    for i, arch in enumerate(TP_PARITY_SERVE_ARCHS):
        cfg = serve.reduce_config(configs.get_config(arch), 8)
        params = LM(cfg).init(torch.Generator().manual_seed(SEED + i), torch.float32)
        _set_gates(params, np.random.default_rng(SEED + i))
        _perturb_norms(params, np.random.default_rng(SEED + i))
        rng = np.random.default_rng(SEED + i)
        out["serve"][arch] = {
            "params": _np_tree(params),
            "prompts": rng.integers(0, cfg.vocab_size, TP_PARITY_PROMPTS),
            "images": (rng.normal(0, 1, (TP_PARITY_PROMPTS[0], cfg.n_image_tokens, cfg.d_model))
                       .astype(np.float32) if cfg.n_image_tokens else None)}
    for arch in TP_PARITY_TRAIN_ARCHS:
        cfg = serve.reduce_config(configs.get_config(arch), 8)
        B, S = DIST_PARITY_BATCH
        data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B,
                                          seed=SEED + 1))
        out["train"][arch] = {
            "params": _np_tree(LM(cfg).init(torch.Generator().manual_seed(SEED), torch.float32)),
            "batches": [data.batch(i) for i in range(DIST_PARITY_STEPS)]}
    return out


def _tp_serve_rank(comm, inputs: dict) -> dict:
    """Each arch of ``inputs`` served greedily on this rank's shards under
    ``serve_rules`` with a float32 cache (`_tp_generate`)."""
    import torch

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.train.steps import param_shardings

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    for arch, inp in inputs.items():
        lm = LM(serve.reduce_config(configs.get_config(arch), 8))
        specs = param_shardings(lm, comm.mesh, sharding.serve_rules(False))
        params = sharding.shard_tree(_on(inp["params"], "cpu"), specs, comm.mesh, comm.coords,
                                     comm.device)
        images = (None if inp["images"] is None
                  else torch.from_numpy(inp["images"]).to(comm.device))
        out[arch] = _tp_generate(lm, params, inp["prompts"], TP_PARITY_GEN, images, comm,
                                 torch.float32)
        del params
    return out


def _tp_train_rank(comm, inputs: dict) -> dict:
    """DIST_PARITY_STEPS FSDP x TP steps of each arch of ``inputs`` (AdamW
    as TRAIN_PARITY_ADAMW), then of each of TP_PARITY_SEQ_ARCHS under
    `_act_seq_rules` (key ``arch + "+act_seq"``); the losses, the launches
    of each run, and the gathered params on rank 0."""
    import torch

    from repro_torch import configs, kernels
    from repro_torch.distributed import sharding
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.optim import AdamW, AdamWConfig, cosine_schedule
    from repro_torch.train import build_train_step
    from repro_torch.train.steps import gather_state

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    runs = [(arch, None) for arch in inputs] + [(arch, _act_seq_rules())
                                                for arch in TP_PARITY_SEQ_ARCHS]
    for arch, rules in runs:
        inp = inputs[arch]
        lm = LM(serve.reduce_config(configs.get_config(arch), 8))
        cfg = AdamWConfig(**TRAIN_PARITY_ADAMW)
        opt = AdamW(cfg, cosine_schedule(cfg.lr, warmup_steps=1, total_steps=DIST_PARITY_STEPS))
        step, sh, _ = build_train_step(lm, opt, comm, rules, remat=True)
        state = opt.init(sharding.shard_tree(_on(inp["params"], "cpu"), sh.params, comm.mesh,
                                             comm.coords, comm.device))
        before = kernels.launch_counts()
        losses = []
        for b in inp["batches"]:
            state, metrics = step(state, b)
            losses.append(float(metrics["loss"]))
        launches = {k: v - before[k] for k, v in kernels.launch_counts().items()}
        whole = gather_state(state, sh, comm)
        out[arch if rules is None else arch + "+act_seq"] = {
            "losses": losses, "launches": launches,
            "params": whole.params if whole is not None else None}
        del state, whole
    return out


def _compare_tp(serves: list, cpu_serves: list, trains: list, cpu_trains: list) -> dict:
    """Card ranks' serves and train steps against the CPU ranks'."""
    out = {}
    for arch in TP_PARITY_SERVE_ARCHS:
        (tok, logits), (ctok, clogits) = serves[0][arch], cpu_serves[0][arch]
        diff, ok = _logit_diff(logits, clogits)
        equal = all(bool((r[arch][0] == ctok).all()) for r in serves)
        out[f"serve_{arch}"] = {"tokens_equal": equal, "max_logit_diff": diff,
                                "ok": ok and equal}
    runs = list(TP_PARITY_TRAIN_ARCHS) + [a + "+act_seq" for a in TP_PARITY_SEQ_ARCHS]
    for arch in runs:
        got = [r[arch]["losses"] for r in trains]
        want = cpu_trains[0][arch]["losses"]
        rel = max(float(np.max(np.abs(np.subtract(g, want)) / np.abs(want))) for g in got)
        worst = _leaf_worst(trains[0][arch]["params"], cpu_trains[0][arch]["params"])
        row = {"losses": got[0], "cpu_losses": want, "max_loss_rel_diff": rel,
               "max_param_diff_over_tolerance": worst,
               "launches_by_rank": [r[arch]["launches"] for r in trains],
               "ok": rel <= TRAIN_PARITY_LOSS_RTOL and worst <= 1.0}
        if arch.endswith("+act_seq"):  # against the same ranks' steps without it
            plain = trains[0][arch.split("+")[0]]["losses"]
            steps_rel = np.abs(np.subtract(got[0], plain)) / np.abs(plain)
            row.update(without_act_seq_losses=plain, loss_rel_diff_to_without=steps_rel.tolist(),
                       ok=row["ok"] and steps_rel[0] <= DIST_FIRST_RTOL
                       and bool((steps_rel[1:] <= DIST_LATER_RTOL).all()))
        out[f"train_{arch}"] = row
    return out


def _drawn(lm, seed: int, device):
    """``lm``'s float32 weights from ``seed``, drawn on ``device`` (a full
    width model in seconds on the card, where the host would take tens)."""
    import torch

    return lm.init(torch.Generator(device=device).manual_seed(seed), dtype=torch.float32)


def _tp_cfg(arch: str, reduce: int, layers):
    from repro_torch import configs
    from repro_torch.launch import serve

    cfg = serve.reduce_config(configs.get_config(arch), reduce)
    return dataclasses.replace(cfg, n_layers=layers) if layers else cfg


class _Part:
    """A rank's launches, log-sum-exp launches, bytes per collective kind,
    seconds and peak memory over one part of a spawn."""

    def __init__(self, comm):
        import torch

        from repro_torch import kernels

        self.comm, self.kernels = comm, kernels
        self.launches = kernels.launch_counts()
        self.lse = kernels.decode_lse_launches()
        self.bytes = dict(comm.bytes)
        self.t0 = time.perf_counter()
        if comm.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(comm.device)

    def moved(self) -> dict:
        return {k: v - self.bytes.get(k, 0) for k, v in self.comm.bytes.items()}

    def done(self) -> dict:
        import torch

        cuda = self.comm.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.comm.device)
        return {"launches": {k: v - self.launches[k]
                             for k, v in self.kernels.launch_counts().items()},
                "decode_lse_launches": self.kernels.decode_lse_launches() - self.lse,
                "comm_bytes": self.moved(), "s": time.perf_counter() - self.t0,
                "max_memory_allocated": (int(torch.cuda.max_memory_allocated(self.comm.device))
                                         if cuda else None)}


def _serve_tp_one(comm, arch: str, reduce: int, layers, requests: int, prompt_len: int,
                  gen: int) -> dict:
    """``serve_batch`` on this rank's shards of ``arch`` (seed SEED's
    weights drawn on the rank's device, as the one-card serve draws them):
    a warm-up of the same requests with 2 tokens, then the timed serve
    (logits returned: gathered once a step). Bytes per collective kind:
    the prefill's (the warm-up's less one decode step) and a decode step's
    ((timed - warm-up) / (gen - 2)); launches and peak memory of the timed
    serve."""
    from repro_torch.distributed import sharding
    from repro_torch.launch import serve
    from repro_torch.models import LM
    from repro_torch.train.steps import param_shardings

    lm = LM(_tp_cfg(arch, reduce, layers))
    specs = param_shardings(lm, comm.mesh, sharding.serve_rules(False))
    params = sharding.shard_tree(_drawn(lm, SEED, comm.device), specs, comm.mesh, comm.coords,
                                 comm.device)
    prompts = np.random.default_rng(SEED).integers(0, lm.cfg.vocab_size, (requests, prompt_len))
    warm = _Part(comm)
    serve.serve_batch(lm, params, prompts, 2, comm=comm, return_logits=True)
    warm_bytes = warm.moved()
    part, timings = _Part(comm), {}
    tokens, logits = serve.serve_batch(lm, params, prompts, gen, comm=comm, timings=timings,
                                       return_logits=True)
    rec = part.done()
    step = {k: (v - warm_bytes.get(k, 0)) / (gen - 2) for k, v in rec["comm_bytes"].items()}
    del params
    return {"tokens": tokens, "logits": logits if comm.rank == 0 else None, "timings": timings,
            "prefill_bytes": {k: warm_bytes.get(k, 0) - v for k, v in step.items()},
            "decode_step_bytes": step, **rec}


def _serve_tp_rank(comm, runs: dict, reduce: int) -> dict:
    """serve_tp's serves on one rank, one arch after another."""
    return {arch: _serve_tp_one(comm, arch, reduce, *run) for arch, run in runs.items()}


def phase_serve_tp(device="cuda", reduce: int = 1, runs: Optional[dict] = None) -> dict:
    """``serve_batch`` at full width on ``--mesh 1x2`` (tensor parallelism;
    host-staged gloo, two ranks sharing the card), one spawn alone on the
    host (SERVE_TP_RUNS: qwen3-0.6b at full depth, its KV heads split;
    recurrentgemma-2b at 5 layers, its 2,048-slot ring sequence-sharded),
    against a one-card serve of the same weights, prompts and tokens (a
    2-token warm-up first, as the ranks do): tokens equal or parting only
    at a near tie, logits up to it within PARITY_TOL. Prefill s, decode ms
    a step, tokens/s, bytes per collective kind (prefill, a decode step),
    peak memory, launches (exact) and log-sum-exp launches a rank."""
    from repro_torch.distributed.comm import run_ranks, transport_name
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import LM

    t_phase = time.perf_counter()
    runs = runs or SERVE_TP_RUNS
    _free_card(device)
    base = {}
    for arch, (layers, requests, prompt_len, gen) in runs.items():
        lm = LM(_tp_cfg(arch, reduce, layers))
        params = _drawn(lm, SEED, device)
        prompts = np.random.default_rng(SEED).integers(0, lm.cfg.vocab_size,
                                                       (requests, prompt_len))
        serve.serve_batch(lm, params, prompts, 2)  # warm-up
        timings = {}
        tokens, logits = serve.serve_batch(lm, params, prompts, gen, timings=timings,
                                           return_logits=True)
        base[arch] = {"tokens": tokens, "logits": logits, "timings": timings}
        del params
        _free_card(device)
    base_s = time.perf_counter() - t_phase
    mesh = make_mesh(*TP_MESH)
    t0 = time.perf_counter()
    recs = run_ranks(_serve_tp_rank, mesh, runs, reduce, backend=DIST_BACKEND, device=device,
                     timeout_s=DIST_TIMEOUT_S)
    spawn_s = time.perf_counter() - t0
    info = {"phase": "serve_tp", "transport": transport_name(DIST_BACKEND, device, mesh.size),
            "mesh": "1x2", "runs": {}, "one_card_s": base_s, "spawn_s": spawn_s}
    launches, bad = collections.Counter(), []
    for arch, (layers, requests, prompt_len, gen) in runs.items():
        res = [r["result"][arch] for r in recs]
        one = base[arch]
        agree = _greedy_agreement(res[0]["tokens"], res[0]["logits"], one["tokens"],
                                  one["logits"])
        t = [x["timings"] for x in res]
        prefill, decode = max(x["prefill_s"] for x in t), max(x["decode_s"] for x in t)
        cfg = _tp_cfg(arch, reduce, layers)
        per_rank = _serve_launches(cfg, prompt_len, gen)
        kinds = cfg.pattern * cfg.n_superblocks + cfg.remainder
        lse_want = kinds.count("local_attn") * (gen - 1) if arch == "recurrentgemma-2b" else 0
        ot = one["timings"]
        info["runs"][arch] = {
            "arch": arch, "layers": cfg.n_layers, "requests": requests,
            "prompt_len": prompt_len, "gen": gen, "prefill_s": prefill,
            "decode_ms_per_step": decode * 1e3 / t[0]["decode_steps"],
            "tokens_per_s": requests * gen / (prefill + decode),
            "one_card": {"prefill_s": ot["prefill_s"],
                         "decode_ms_per_step": ot["decode_s"] * 1e3 / ot["decode_steps"],
                         "tokens_per_s": requests * gen / (ot["prefill_s"] + ot["decode_s"])},
            "prefill_bytes_by_kind": res[0]["prefill_bytes"],
            "decode_step_bytes_by_kind": res[0]["decode_step_bytes"],
            "max_memory_allocated_by_rank": [x["max_memory_allocated"] for x in res],
            "launches_by_rank": [x["launches"] for x in res],
            "decode_lse_launches_by_rank": [x["decode_lse_launches"] for x in res],
            "decode_lse_launches_expected": lse_want, "timings_by_rank": t,
            "part_s_by_rank": [x["s"] for x in res], "against_one_card": agree}
        for x in res:
            launches.update(x["launches"])
        if not agree["ok"] or res[0]["tokens"].shape != (requests, gen):
            bad.append((arch, "tokens or logits"))
        if device == "cuda" and (
                any(x["launches"][k] != v for x in res for k, v in per_rank.items())
                or any(x["decode_lse_launches"] != lse_want for x in res)):
            bad.append((arch, f"launches, expected {per_rank}, {lse_want} lse"))
    info["launches"] = dict(launches)
    info["phase_s"] = time.perf_counter() - t_phase
    emit(info)
    if bad:
        raise AssertionError(f"serve_tp failed: {bad}")
    return info


def _greedy_agreement(tokens, logits, ref_tokens, ref_logits) -> dict:
    """Two greedy runs of the same requests: per request, the first step
    where the tokens differ (none: all equal), and the logits up to and
    including it within PARITY_TOL (abs + rel) of the reference's."""
    parted, worst, ok = [], 0.0, tokens.shape == ref_tokens.shape
    for r in range(ref_tokens.shape[0]):
        differ = np.flatnonzero(tokens[r] != ref_tokens[r]) if ok else [0]
        upto = int(differ[0]) + 1 if len(differ) else ref_tokens.shape[1]
        diff, close = _logit_diff(logits[r, :upto], ref_logits[r, :upto])
        parted.append(int(differ[0]) if len(differ) else None)
        worst, ok = max(worst, diff), ok and close
    return {"tokens_equal": all(d is None for d in parted), "first_differing_step": parted,
            "max_logit_diff": worst, "tolerance": PARITY_TOL, "ok": ok}


def _entry(name: str, main: dict, launches: int) -> dict:
    return {
        "name": name,
        **KERNEL_INFO[name],
        "launches": int(launches),
        "max_abs_err": main.get("max_abs_err", main.get("max_abs_diff")),
        "tolerance": main.get("tolerance", 0),
        "ms": main["kernel_ms"],
        "device_ms": main["device_ms"],
        "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"],
        "bound_by": main["bound_by"],
        "library_ms": main["library_ms"],
        **({"device_ms_cold": main["device_ms_cold"]} if "device_ms_cold" in main else {}),
        "shape": main["shape"],
    }


def _training(name: str, grad: dict, trains: dict, parity: dict) -> dict:
    """A trained kernel's launches in the training phases (the first run of
    each: 3 steps) and its Function's gradients' error and forward /
    backward times."""
    keys = ("shape", "bit_equal", "max_abs_err", "max_rel_err_of_largest",
            "tolerance_of_largest", "function", "plain")
    return {
        "train_launches_by_phase": {
            **{p: out["launches"][name] for p, out in trains.items()},
            **{f"train_parity_{arch}": out["launches"][name]
               for arch, out in parity["archs"].items()}},
        "train_launches_per_step": {p: out["launches_per_step"][name]
                                    for p, out in trains.items()},
        "grad": {k: grad["kernels"][name][k] for k in keys if k in grad["kernels"][name]},
    }


def _backward_entry(grad: dict, trains: dict, parity: dict, dist: dict) -> dict:
    """Flash's backward kernel: its calls in the training phases (those
    across ranks summed over the ranks), its gradients' error at both of
    grad_kernels' flash shapes, and its times at the 4,096-token layer."""
    name = "flash_attention_bwd"
    main = grad["kernels"]["flash_attention.train_4k"]
    bwd = main["backward"]
    return {
        "name": name, **KERNEL_INFO[name],
        "launches_by_phase": {
            **{p: out["launches"][name] for p, out in trains.items()},
            **{f"train_parity_{arch}": out["launches"][name]
               for arch, out in parity["archs"].items()},
            **{p: out["launches"][name] for p, out in dist.items()}},
        "train_launches_per_step": {p: out["launches_per_step"][name]
                                    for p, out in trains.items()},
        "max_rel_err_of_largest": {k: grad["kernels"][k]["max_rel_err_of_largest"]
                                   for k in ("flash_attention", "flash_attention.train_4k")},
        "tolerance_of_largest": FLASH_GRAD_TOL,
        "ms": bwd["ms"], "device_ms": bwd["device_ms"], "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"], "design_ms": bwd["design_ms"],
        "plain_ms": main["plain"]["backward_ms"],
        "library_ms": bwd["library"]["backward_ms"], "library": bwd["library"],
        "shape": main["shape"],
    }


def kernels_line(kern: dict, full: dict, dynamic: dict, att: dict, served: dict, rec: dict,
                 rec_served: dict, rest: dict, grad: dict, trains: dict, parity: dict,
                 families: dict, family_parity: dict, dist: dict) -> dict:
    """One entry per kernel at its main shape; ``rec_served`` maps an arch
    to its serve phase's output, ``rest`` the scheduler's later phases to
    theirs, ``trains`` the train phases to theirs. The scheduler's kernels
    count their launches in the full replay, with the dynamic replays' and
    the later phases' beside them; the LM kernels in their serve, with the
    other serves' (``families``: the MoE and VLM ones, and their card
    against CPU runs in ``family_parity``) and the training phases' beside
    it, and ``dist`` (the phases across ranks) theirs summed over the ranks."""
    entries = []
    for name, rows in kern.items():
        main = next(r for r in rows if tuple(r["shape"]) == MAIN_SHAPE)
        entries.append({**_entry(name, main, full["launches"][name]), "shapes": rows,
                        "launches_by_phase": {
                            "full": full["launches"][name],
                            "dynamic_on": dynamic["on"]["launches"][name],
                            "dynamic_off": dynamic["off"]["launches"][name],
                            **{phase: out["launches"][name] for phase, out in rest.items()}},
                        "library_ms_null_because": NO_LIBRARY})
    gemma = rec_served["recurrentgemma-2b"]
    trained = lambda name: _training(name, grad, trains, parity)  # noqa: E731
    lse_rows = att.get("decode_attention_lse", [])
    for name, rows in att.items():
        if name == "decode_attention_lse":
            continue
        # The dtypes the serving path uses; recurrentgemma-2b's shape after.
        entry = _entry(name, rows[0], served["launches"][name])
        by_phase = {p["phase"]: p["launches"][name]
                    for p in (served, gemma, *families.values())}
        by_phase.update({f"moe_vlm_parity_{arch}": p["launches"][name]
                         for arch, p in family_parity["archs"].items()})
        if name == "flash_attention":
            extra = trained(name)
            by_phase.update(extra.pop("train_launches_by_phase"))
            entry.update(extra)
        # The phases across ranks, summed over the ranks.
        by_phase.update({p: out["launches"][name] for p, out in dist.items()})
        if name == "decode_attention" and lse_rows:
            # The log-sum-exp output (sequence-sharded caches): its calls at
            # two shards of each serving shape, and its launches on the
            # model-axis phases, summed over the ranks.
            entry["lse"] = {
                "shapes": lse_rows,
                "launches_by_phase": {
                    "serve_tp": sum(sum(r["decode_lse_launches_by_rank"])
                                    for r in dist["serve_tp"]["runs"].values()),
                    "tp_parity": sum(dist["tp_parity"]["decode_lse_launches_by_rank"])}}
        # The MoE and VLM serves' layer-0 (and first cross layer's) calls
        # against the plain version: GQA groups 6, 5, 4; the image cache.
        entry["checks_by_phase"] = {
            p["phase"]: {k: v for k, v in p["captured_checks"].items() if k.startswith(name)}
            for p in families.values()}
        entries.append({**entry, "launches_by_phase": by_phase, "shapes": rows + rec[name]})
    for name, arch in (("rglru_scan", "recurrentgemma-2b"), ("rwkv6_scan", "rwkv6-7b")):
        extra = trained(name)
        serve = rec_served[arch]
        entries.append({**_entry(name, rec[name][0], serve["launches"][name]),
                        "launches_by_phase": {serve["phase"]: serve["launches"][name],
                                              **extra.pop("train_launches_by_phase"),
                                              **{p: out["launches"][name]
                                                 for p, out in dist.items()}},
                        **extra,
                        "library_ms_null_because": NO_SCAN_LIBRARY, "shapes": rec[name]})
    entries.append(_backward_entry(grad, trains, parity, dist))
    return {"kernels": entries}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)

    info = phase_device()
    phase_build()
    kern = phase_kernels()
    att = phase_attention_kernels()
    rec = phase_recurrent_kernels()
    phase_round()
    phase_parity()
    full = phase_full()
    phase_dynamic_parity()
    dynamic = phase_dynamic(full=full)
    rest = {"mcmf_parity": phase_mcmf_parity(), "mcmf_round": phase_mcmf_round(),
            "trace": phase_trace(), "serving": phase_serving(), "sweep": phase_sweep()}
    served = phase_serve()
    phase_serve_parity()
    rec_served = {arch: phase_serve(arch=arch, **kw) for arch, kw in RECURRENT_SERVES.items()}
    for arch in RECURRENT_SERVES:
        phase_recurrent_parity(arch)
    families = {arch: phase_serve(arch=arch, **kw) for arch, kw in FAMILY_SERVES.items()}
    family_parity = phase_moe_vlm_parity()
    rest["schedule"] = phase_schedule()
    grad = phase_grad_kernels()
    trains = {phase: phase_train(phase, *run) for phase, run in TRAIN_RUNS.items()}
    parity = phase_train_parity()
    phase_roofline(info, trains["train"], served)
    dist, parity_s = phase_rank_parity()
    dist["train_fsdp"] = phase_train_fsdp()
    dist["train_tp"] = dist["train_fsdp"].pop("train_tp")
    dist["train_tp_act_seq"] = dist["train_tp"]["act_seq"]
    dist["train_compressed_pp"] = phase_train_compressed_pp(dist["train_fsdp"])
    dist["serve_dp"] = phase_serve_dp(served)
    dist["serve_tp"] = phase_serve_tp()
    phase_s = {"dist_parity+tp_parity": parity_s,
               **{p: out["phase_s"] for p, out in dist.items() if "phase_s" in out}}
    emit({"phase": "dist_budget", "phase_s": phase_s, "total_s": sum(phase_s.values()),
          "budget_s": DIST_BUDGET_S, "script_s": time.perf_counter() - T_START})
    emit(kernels_line(kern, full, dynamic, att, served, rec, rec_served, rest, grad, trains,
                      parity, families, family_parity, dist))
    emit({"ok": True, "device": {"platform": "gpu", "kind": info["name"],
                                 "count": info["count"]}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
