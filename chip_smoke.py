#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`src/repro_torch`).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

It needs nothing but the checkout: the CUDA kernels are built from
`src/repro_torch/kernels/*/csrc/*.cu` with nvcc, one process per source,
all at once.  Phases, each of which raises (and the script exits non-zero)
on failure:

  1. device and build: the card, torch and CUDA versions, full-float32
     matmuls (no TF32), kernel build time; ptxas's registers and spills for
     the flash sources (no spill store in the CUDA-core kernel), that
     kernel's build seconds and CTAs per SM, the fused slot step's
     registers, and the sm90
     flash kernel's SASS, which must hold HGMMA (wgmma) instructions;
  2. each kernel against its plain PyTorch version on the card, random and
     tie-heavy inputs, outputs bit-identical, device times beside each
     kernel's bound: bp_slot at the fleet path's shapes (B=1512 sims, N=16,
     C=12, E=51, NC=4); bp_topk at the serve path's decode shape (T=4,
     E=32, k=8) and at (8, 32, 8), (1024, 64, 6), (4096, 32, 8), and once
     through its entry point `bp_topk_op` (its path); bp_topk_route (the
     whole gate of one MoE layer) in idx, w, counts, H_new and steps at
     those shapes in float32 and bfloat16 and at the 32k prefill's gate
     (T=32,768, bfloat16), with and without backpressure, each case
     launched twice back to back (the workspace reset), timed at the
     decode and the prefill shape; the counter-based noise kernel
     (`counter_hash.cu`) in every output form and site at the fleet
     cell's widest draw (504 x 24), the trace simulator's regulator
     (9 x 4) and the fleet path's own draws below (1,512 x 1, 51 and 4),
     bit-identical to the plain int64 chain, device times beside the
     chain's and the bound at each;
  3. the fleet path at full width: `run_fleet` over 1,512 pi3_reg sims (8
     registry families x topo_seeds 0-20 x 3 rates x 3 seeds, padded to the
     atlas hull (16, 51, 4)), T=4096, chunk=512, early stop, each chunk
     replays of one captured CUDA graph of 64 slots; results are held to
     the exact LP bound; the fused slot-step kernel (`bp_slot_step.cu`)
     launches once per slot advanced (eager launches, the 64 slots before
     the capture, plus graph replays x the launches the graph captured),
     B1 and B2 never, and the noise kernel once per draw site a slot uses
     per slot advanced; the graphed run, and a second graphed run, against
     the eager `chunk_step` loop on the same sims: every metric and verdict
     bit-identical, ms per batched slot of each; a profiler trace of one
     replay, whose bp_slot_step kernels must be the 64 slots it holds,
     gives CUDA activities and device time per slot; then
     `phase_slot_step`: the fused kernel against the
     plain slot step on the card and on the CPU, teacher-forced, 256 slots
     of the 1,512 sims and 32 slots of each other policy (pi1, pi1p, pi2
     with bound pairing, pi3bar, pi3 on wireless_grid), n*, Z and the
     integer leaves equal to both, the float leaves within 1e-5; its
     device time per launch beside its bound and the plain slot step's;
  4. determinism and lane independence: a 64-sim subset twice, and one job
     alone, must give bit-identical metrics; and the card against the
     port's plain path on the CPU, all 1,512 sims for 256 slots from one
     random state with the same counter-based noise: stepped from the same
     carry each slot, the two agree to rounding (see `phase_reference`);
  5. a short wireless_grid run, so the greedy-matching branch runs; the
     λ_max frontier (`find_lambda_max`, benchmarks/bench_fleet.py's
     FRONTIER_SMOKE: paper_grid under pi3 and pi3_reg): lam_max / bound in
     [0.90, 1.0], slots saved >= 0.30, one capture per search; the
     capacity atlas (`sweep_lambda_max`, benchmarks/bench_atlas.py's
     ATLAS_SWEEP: 504 cells, 1,512 lanes, 3 size buckets, one re-queue)
     held to that file's gates, one capture per program; in both the
     fused slot step launches once per batched slot, and the port's
     numbers print beside the reference's committed ones;
 5c. serving with admission control: benchmarks/bench_serving.py's
     SERVING_SMOKE through `serving_report` (paper_grid, pi3_reg, bursty,
     0.95x and 1.3x the bound, 2 seeds, T=4096) under that file's gates,
     beside the reference's committed rows; `run_serving` at full width
     (`phase_serving`: the main path's 1,512 lanes facing bursty_mix,
     streamed to a JSONL file): one capture, one fused slot step per
     slot, finite metrics, delivered QPS within 1.02x each bound, class
     fairness of the shedding lanes, gate flips within half the windows,
     a valid stream of one record per chunk, ms per batched slot with
     the stream off and on, per-family medians, one traced replay;
     `phase_serving_parity`: 64 lanes graphed and eager, stream off and
     on, bit-identical, a diurnal_mix run (offered rate within 2% of
     lam), the outage shed-and-recover check; `phase_stream`: the fleet
     run of phase 3, the frontier and a small atlas with the stream on,
     bit-identical to the stream off, valid records, wall times;
 5d. preemption-safe runs (`phase_resilience`, `runtime.resilience`): the
     fleet of phase 3 snapshot at every boundary, preempted after chunk 3
     and resumed in this process, every metric and the slot accounting
     bit-identical to phase 3's, no new capture, the fused launches of
     the killed and the resumed run summing to the uninterrupted run's;
     the carry's bytes, ms per snapshot (copy to host, sha256, write) and
     the run's wall with and without snapshots; `phase_serving`'s run
     killed at boundary 4 of 8 and resumed, its metrics and its stream
     (seam stripped) byte-identical; a child process running the fleet
     killed with SIGKILL, and a fresh process resuming from the newest
     intact step to phase 3's metrics with one capture; the small atlas
     of `phase_stream` killed mid-bucket and resumed to the same rows;
     on 64 lanes two injected launch failures retried, and a host
     dropout that parks every lane and plans a remesh;
  6. the MoE router (`core/router.route`) in the loop of
     benchmarks/bench_router.py: backpressure must balance better than
     plain top-k;
  7. the serve path at full width: granite-moe-1b-a400m (24 layers, 32
     experts top-8, random float32 weights from a seed), `Engine(slots=4,
     max_len=128)` answers 8 requests; every request must finish,
     bp_topk_route launch 24 times per decode step and the standalone
     bp_topk never; ms per step, tokens/s, a profiled step's activities
     (per layer too) and device-busy share, and one layer's gate traced
     alone: its activities, one bp_topk_route and no softmax;
  8. the serve path on the card against the CPU at full width and 4
     layers: the same experts in every layer, logits within 1e-4;
  9. bp_route bit for bit against its plain version at bench_kernels'
     shape (N=512, C=96, E=4096) on random and tie-heavy inputs, float32
     and bfloat16, and once through its entry point `bp_route_op`;
     device times in float32 and bfloat16 beside the bounds;
 10. flash_attention against its plain version (1e-5 float32, 2e-2
     bfloat16; bfloat16 outputs also within bf16 rounding of the plain
     version's float32 result), float32 through the CUDA-core kernel and
     bfloat16 through the sm90 kernel (the launch counters show which), at
     bench_kernels' tile (1, 8, 512, 128) with 4 kv heads, causal, window
     256; granite's heads (16 over 8, D=64) at S=2,048, causal; a ragged
     S=1,000, not causal; a ragged S=777, causal, window 100; 8 heads over
     8 (S=700) and 16 over 4 (S=600) at D=64; D=16, window 40; then at
     granite's prefill shape (B=1, S=32,768, bfloat16) 17 windows of query
     rows spread over the sequence against a plain computation within bf16
     rounding (and, in float32, within 1e-5 through the CUDA-core kernel,
     called twice: bit-identical), and device times of the sm90 kernel, of
     the CUDA-core kernel in float32, of the plain version (at S=4,096:
     its scores do not fit at 32k) and of SDPA (bf16, and float32 beside
     the CUDA-core kernel) beside the bound (both products at the bf16
     tensor-core rate) and the sm90 kernel's own floor (1.5x: P.V runs for
     p_hi and p_lo); the CUDA-core kernel at the float32 training step's
     shape (B=8, S=512) against its plain version, twice bit-identical,
     timed beside the plain version, SDPA's float32 kernel and its float32
     bound; the families' shapes in both dtypes against the plain version
     and twice bit-identical (gemma3's 32 heads over 16 at D=128 with its
     window 1,024, qwen1.5's G=1 at D=128, seamless's cross-attention
     S=1 and 512 against T=1,500, not causal; zamba's shared block at head
     dim 80, 32 heads over 32, S=512 and an odd S=1,000); the sm90 kernel
     at gemma3's global and windowed layers (B=1, S=32,768, D=128): row
     windows within bf16 rounding, device ms beside the bound and SDPA;
     both kernels at head dim 80 (zamba2-2.7b): the sm90 kernel at B=1,
     S=32,768, bf16 (row windows within bf16 rounding, twice
     bit-identical, device ms beside D=80's bound and SDPA) and the
     CUDA-core kernel at the float32 training shape (B=8, S=512; against
     the plain version, device ms beside its bound, the plain version and
     SDPA);
 11. the prefill path at full width: granite-moe-1b-a400m (24 layers,
     random float32 weights from a seed) through `make_prefill_step` at
     B=1, S=32,768, bfloat16 activations, 2 timed prefills after a short
     warm-up: finite [1, 1, 49155] logits, the sm90 flash kernel and
     bp_topk_route 24 launches each per prefill, the CUDA-core flash
     kernel and the standalone bp_topk none, one layer's gate traced
     alone (one bp_topk_route, no softmax), the new router queues finite
     and >= 0; ms per prefill,
     tokens/s, peak memory, a profiled prefill's busy share and flash
     share; then the 17 row windows' gate on the q, k and v that layer 1
     projects from the prefill's tokens;
 12. the prefill path on the card against the CPU at full width and 4
     layers (B=2, S=256, float32): the same experts in every layer, equal
     router queues, full and last-position logits within 1e-4;
 13. the bfloat16 prefill path at full width and 4 layers (B=1, S=4,096)
     through `ModelAPI.logits`: each layer's attention output, as the sm90
     kernel gave it inside the forward, within bf16 rounding of the plain
     version's float32 result on that layer's own q, k and v; finite
     logits;
 14. training at full width (`phase_train`): granite-moe-1b-a400m, 24
     layers, random float32 weights from a seed, 12 steps through the
     launcher (`launch.train.main`, float32, B=8, S=512, remat full):
     falling loss, bounded router queues, 48 launches of the CUDA-core
     flash kernel and of bp_topk_route per step and no sm90 one, every
     parameter leaf a finite, non-zero gradient after step 1; ms per
     step, tokens/s, peak memory, one profiled step; then 3 steps of
     `make_train_step` in bfloat16 (B=4, remat none): 24 sm90 flash and
     24 gate launches per step;
 15. the autograd Functions on the card (`phase_train_grads`):
     `FlashAttentionFn` (float32: dq, dk, dv within 1e-4 of autograd of
     the plain version; bfloat16: within bf16 rounding of its float32
     gradient) and `BpTopkRouteFn` (d/dlogits within 1e-6) on layer 1's
     q, k, v and router logits of the training batch; their forward and
     backward device ms beside SDPA's;
 16. one `make_train_step` step on the card against the CPU at full width
     and 4 layers (B=2, S=256, float32; `phase_train_reference`): picks
     per layer (a near-tie the devices' inputs explain teacher-forces
     its layer), the loss within 1e-5, every leaf's moments and update
     within 1e-4, equal router queues;
 17. kill and resume (`phase_train_resume`): full width, 2 layers,
     through the launcher, a background save at step 4 and a crash at
     step 6, resumed to step 8 beside an uninterrupted run: the restored
     state bit-identical to the saved one, the first resumed loss
     bit-identical, the later ones within 1e-4; checkpoint bytes and the
     ms of save and restore;
 18. gemma3-27b at full width and depth (62 layers: 10 groups of 5 local,
     window 1,024, + 1 global, and 2 local; 27 B bf16 params drawn on the
     card, the draw's peak memory printed) through `make_prefill_step` at
     B=1, S=32,768: 62 sm90 launches a prefill, none of the CUDA-core
     kernel, finite logits, ms, tokens/s, peak memory, a profiled
     prefill; the first local layer's projections against a plain
     computation with its window;
 19. the same weights behind `Engine(slots=4, max_len=128)`: 8 requests,
     no flash launch at decode, ms per decode step, a profiled step;
 20. gemma3 at 8 layers (one group and a tail of 2), float32: a forward at
     S=1,152 (8 CUDA-core launches, 7 with the window) and the same
     tokens decoded one by one across every local ring's wrap, each step
     within 2e-3 of the forward; a local and the global block
     teacher-forced, card against the CPU within 1e-5;
 21. qwen1.5-32b at 4 layers (G=1, D=128, QKV bias): a bf16 prefill at
     S=8,192 (4 sm90 launches), layer 1's block with random biases card
     against the CPU at S=512, float32;
 22. internvl2-1b at full depth: a bf16 prefill of 256 patches + 1,024
     tokens (24 sm90 launches at G=7), float32 logits card against the
     CPU, 3 float32 training steps on random patches (48 CUDA-core
     launches a step, every leaf a gradient, the projector's included),
     one launcher step on its zero patches (launches, loss; the
     non-finite gradients that batch gives at 24 layers counted);
 23. seamless-m4t-large-v2 at full depth (24 + 24 layers): a bf16 prefill
     of 4,096 frames and 1,024 tokens (72 sm90 launches), 64 float32
     decode steps against `decode_fwd` within 2e-3 (24 CUDA-core
     cross-attention launches a step at S=1, T=4,096), 3 float32 steps
     through the launcher (144 CUDA-core launches a step);
 24. zamba2-2.7b at full width and depth, nothing cut (54 mamba layers in 9
     groups of 6, the shared attention block 9 times at head dim 80;
     2,340,750,240 bf16 params drawn on the card) through
     `make_prefill_step` at B=1, S=32,768: 9 sm90 launches a prefill, none
     of the CUDA-core kernel, finite logits, ms, tokens/s, peak memory, a
     profiled prefill's device time by group, the SSD core
     (`models.mamba.ssd`) timed alone at one layer's shapes; the same
     weights behind `Engine(slots=4, max_len=128)` (8 requests, no flash
     launch);
 25. zamba trained 12 float32 steps through the launcher (B=8, S=512,
     remat full): 9 CUDA-core launches a step at D=80, falling loss, every
     leaf a gradient; then at 12 layers in float32 a forward of 320 tokens
     and the same tokens decoded one by one within 2e-3, and its first
     mamba layer and the shared block teacher-forced, card against the
     CPU within 1e-5;
 26. xlstm-350m at full width and depth, nothing cut (20 mLSTM + 4 sLSTM
     blocks, 461,919,392 bf16 params) through `make_prefill_step` at B=1,
     S=4,096 (cut from 32,768: the mLSTM's [S, S, nh] float32 tensors and
     one host step per token of the sLSTM), no flash launch (the path runs
     no TPU kernel), the sLSTM loop's share of the wall time; the Engine;
 27. xlstm trained 3 float32 steps through the launcher (B=8, S=512): the
     sLSTM loops' share of a step; at full depth in float32 a forward of
     256 tokens and the same tokens decoded one by one within 2e-3; its
     first mLSTM and sLSTM blocks teacher-forced, card against the CPU
     within 1e-5;
 28. the trace simulator (`repro_torch.sim`, `phase_paper_figures`):
     Fig. 5(b)'s C=3 sweep (B=9, T=2,500) and Fig. 5(c)'s run (B=1,
     T=4,000) under pi3 and pi3bar through `make_trace_runner`, graphed
     (one captured CUDA graph of 64 slots per runner, replayed) twice and
     eager once on the same noise: traces and final state bit-identical,
     one fused slot-step launch per slot, one capture, B1/B2 none; ms per
     batched slot of each; one profiled replay; the card against the CPU
     over 256 slots of the sweep (n* equal, traces within 1e-4
     relative); the three suites of scripts/torch_paper_figures.py at the
     paper's horizons, their claims hard checks (both knees for both
     policies, Fig. 5(c)'s convergence, the capacity table's anchors),
     rows, LP lambda* and wall seconds printed; the four
     examples/torch_*.py as processes on the card, each exiting 0 after
     its own check;
 29. the dry-run (`phase_dryrun`, `launch.dryrun`): the sweep of the 32
     cells at full width, traced on the meta device (`--all --mesh
     local`, every record "ok") beside their layout on the reference's
     meshes (`--mesh both`, every record "layout"), two processes at
     once, the trace seconds of each cell; then the trace held against
     the card at three shapes run above (granite's prefill, gemma3's
     prefill, granite's float32 training): the traced state's bytes equal
     the real state's, and the model FLOPs over the peak of the step's
     matrix dtype at most the measured time (that share printed beside
     its prediction); the trace's roofline bound against the measured
     time and its temporaries against the peak device memory, printed.

The second-to-last lines are the kernel table (one JSON object) and the
card's name and power limit; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without a CUDA device, or outside a checkout, it exits non-zero and prints
no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

B_MAIN, N_MAIN, C_MAIN, E_MAIN, NC_MAIN = 1512, 16, 12, 51, 4
FAMILIES = ("paper_grid", "random_geometric", "ring", "tree", "expander",
            "fat_tree", "ge_grid", "ge_comp_grid")
RATE_FRACS = (0.5, 0.95, 1.3)
SEEDS = (0, 1, 2)
TOPO_SEEDS = tuple(range(21))
EPS_B = 0.05
T_MAIN, CHUNK_MAIN = 4096, 512
LP_TOL = 1.02            # windowed rates may exceed the bound by drain noise
#: comp_balance_decide panels that each pairing does not read (bp_slot.cu).
BALANCE_UNREAD = {"fifo": ("x_net",), "bound": ("ca1", "ca2", "cc")}
REF_SLOTS = 256          # slots of the card-vs-CPU comparison (phase 4)
#: phase_slot_step: slots of the main batch (pi3_reg), then slots and sims
#: of each other policy's case, (scenario, policy, pad_extra,
#: fail_pattern, pairing) as in tests/test_torch_bp_slot.py's CASES.
STEP_SLOTS, STEP_CASE_SLOTS, STEP_CASE_B = 256, 32, 256
STEP_CASES = (("paper_grid", "pi1", 1, 0, "fifo"),
              ("paper_grid", "pi1p", 0, 0, "fifo"),
              ("ring", "pi2", 1, 0, "bound"),
              ("ring", "pi3bar", 3, 3, "fifo"),
              ("wireless_grid", "pi3", 0, 0, "fifo"))
#: bp_topk shapes (T, E, k): one decode step of the serve phase (4 slots,
#: granite's 32 experts top-8) first, then the kernel table's three.
TOPK_SHAPES = ((4, 32, 8), (8, 32, 8), (1024, 64, 6), (4096, 32, 8))
#: bp_topk_route: TOPK_SHAPES in float32 and bfloat16, and in bfloat16
#: the prefill's gate (B=1, S=32,768 tokens, granite's E=32 top-8), a
#: moonshot gate (E=64 top-6) at 16,384 tokens, and 16,383 tokens of
#: granite's, the last shape below the kernel's thread-per-row path.
ROUTE_PREFILL_SHAPE = (32_768, 32, 8)
ROUTE_MORE_SHAPES = ((16_384, 64, 6), (16_383, 32, 8), (16_384, 32, 8))
SERVE_ARCH = "granite-moe-1b-a400m"
SERVE_SLOTS, SERVE_MAX_LEN, SERVE_REQUESTS, SERVE_MAX_NEW = 4, 128, 8, 12
REF_LAYERS, REF_STEPS = 4, 4    # the serve path's card-vs-CPU check
LOGIT_ATOL = 1e-4               # its logits tolerance (see phase_serve_ref)
#: bp_route at bench_kernels' shape: N nodes, C classes, E links.
ROUTE_N, ROUTE_C, ROUTE_E = 512, 96, 4096
#: flash_attention cases (B, H, KH, S, D, causal, window), T = S, each in
#: float32 (the CUDA-core kernel) and bfloat16 (the sm90 kernel at D = 64
#: and 128, else the CUDA-core kernel): bench_kernels' tile, granite's
#: heads, a ragged non-causal S, a ragged windowed S at granite's head dim;
#: head groups of 1 and 4 (one CTA a group) at D = 64, and D = 16.
FLASH_CASES = ((1, 8, 4, 512, 128, True, 256),
               (1, 16, 8, 2048, 64, True, None),
               (1, 16, 8, 1000, 64, False, None),
               (1, 16, 8, 777, 64, True, 100),
               (1, 8, 8, 700, 64, True, None),
               (1, 16, 4, 600, 64, True, None),
               (1, 4, 2, 300, 16, True, 40))
FLASH_TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py:42
PREFILL_B, PREFILL_S, PREFILL_WARM_S = 1, 32_768, 1024
#: The CUDA-core kernel's shape in the float32 training step (phase_train):
#: B = 8 rows of S = 512 tokens, granite's 16 heads over 8, D = 64.
FLASH_TRAIN_SHAPE = (8, 16, 8, 512, 64)
FLASH_PLAIN_S = 4096            # the plain version's timing shape
#: Query-row windows (first row, rows) held to a plain computation at a
#: prefill of S tokens: the first 64-query block, one across the edge of
#: the first two, a ragged start, the middle across a block edge, the last
#: 256 rows; and FLASH_RANDOM_WINDOWS of 64 rows at random starts.
FLASH_RANDOM_WINDOWS = 12
#: (atol, rtol) of a bf16 output against float32 math: rounding to bf16
#: moves a value by at most 2^-8 of itself; 1e-5 covers float32 summation
#: order.
FLASH_BF16_ROUNDING = (1e-5, 2.0 ** -8)
PREFILL_REF_B, PREFILL_REF_S = 2, 256   # the prefill's card-vs-CPU check
#: The families' attention shapes (what, B, H, KH, S, T, D, causal,
#: window), each in float32 (the CUDA-core kernel) and bfloat16 (the sm90
#: kernel) against the plain version and twice bit-identical: gemma3's
#: heads (32 over 16, D=128) with its window at S=4,096; qwen1.5's 40 heads
#: over 40 (G=1) at D=128; seamless's cross-attention (16 over 16, D=64),
#: one query row and 512 against 1,500 memory rows, not causal.  Then the
#: shapes the phases' paths give the kernel (phases 20-23): gemma3 at 8
#: layers over GEMMA_DECODE_S (windowed and global); qwen1.5's prefill at
#: QWEN_PREFILL_S; internvl2's prefill (14 heads over 2, G=7, 256 patches
#: + 1,024 text rows) and its training rows (256 + 512); seamless's
#: prefill (encoder, decoder self, cross at 1,024 against 4,096 frames),
#: its decode (one row against 4,096) and its training (512 rows); zamba's
#: shared block at head dim 80 (32 heads over 32): its training rows, an
#: odd length and the float32 forward of `phase_zamba_decode`.
FLASH_FAMILY_CASES = (("gemma3 local", 1, 32, 16, 4096, 4096, 128, True, 1024),
                      ("qwen1.5", 1, 40, 40, 2048, 2048, 128, True, None),
                      ("cross S=1", 2, 16, 16, 1, 1500, 64, False, None),
                      ("cross S=512", 2, 16, 16, 512, 1500, 64, False,
                       None),
                      ("gemma3 8-layer local", 1, 32, 16, 1152, 1152, 128,
                       True, 1024),
                      ("gemma3 8-layer global", 1, 32, 16, 1152, 1152, 128,
                       True, None),
                      ("qwen1.5 prefill", 1, 40, 40, 8192, 8192, 128, True,
                       None),
                      ("internvl2 prefill", 1, 14, 2, 1280, 1280, 64, True,
                       None),
                      ("internvl2 train", 4, 14, 2, 768, 768, 64, True,
                       None),
                      ("seamless encoder", 1, 16, 16, 4096, 4096, 64, False,
                       None),
                      ("seamless decoder", 1, 16, 16, 1024, 1024, 64, True,
                       None),
                      ("seamless cross", 1, 16, 16, 1024, 4096, 64, False,
                       None),
                      ("seamless cross decode", 1, 16, 16, 1, 4096, 64,
                       False, None),
                      ("seamless train encoder", 2, 16, 16, 512, 512, 64,
                       False, None),
                      ("seamless train decoder", 2, 16, 16, 512, 512, 64,
                       True, None),
                      ("zamba train", 8, 32, 32, 512, 512, 80, True, None),
                      ("zamba odd length", 1, 32, 32, 1000, 1000, 80, True,
                       None),
                      ("zamba decode check", 1, 32, 32, 320, 320, 80, True,
                       None))
#: zamba2-2.7b's attention (its shared block: 32 heads over 32 at head dim
#: 80), timed beside its bound and SDPA: (B, H, KH, S, D), causal, at the
#: prefill (bf16, the sm90 kernel; its rows held to a plain computation,
#: the plain version's scores do not fit) and the float32 training step
#: (the CUDA-core kernel, against the plain version).
ZAMBA_FLASH_PREFILL = (1, 32, 32, 32_768, 80)
ZAMBA_FLASH_TRAIN = (8, 32, 32, 512, 80)
#: Moonlight-16B-A3B's prefill (`configs.moonlight_16b_a3b`, the cell
#: moonlight-16b-a3b.prefill_8k): B = 8 prompts of S = 8,192 tokens.  Its
#: latent attention through the sm90 kernel's (192, 128) instance at
#: (B, H, S, q/k head dim, v head dim), 16 heads each with its own k and v,
#: causal, scale 1/sqrt(192); the plain version timed beside the kernel on
#: the same inputs cut to MLA_PLAIN_S (its scores do not fit at S); the
#: gate's sigmoid mode at its prefill shape (T = B S, E, k), bfloat16.
MLA_ARCH = "moonlight-16b-a3b"
MLA_PREFILL_B, MLA_PREFILL_S = 8, 8192
MLA_FLASH_SHAPE = (MLA_PREFILL_B, 16, MLA_PREFILL_S, 192, 128)
MLA_PLAIN_S = 4096
MLA_ROUTE_SHAPE = (MLA_PREFILL_B * MLA_PREFILL_S, 64, 6)
#: gemma3's attention at the prefill length, timed beside its bound and
#: SDPA: (B, H, KH, S, D), causal, its global layer and its windowed one.
GEMMA_FLASH_SHAPE, GEMMA_WINDOW = (1, 32, 16, 32_768, 128), 1024
#: Phases 18-23, the dense family's rest, the VLM and the encoder-decoder
#: at full width: gemma3-27b at full depth in bf16 (prefill at
#: prefill_32k's length, then the Engine as phase_serve drives it); gemma3
#: at 8 layers (one 5:1 group and a tail of 2) in float32, forward and
#: decode over GEMMA_DECODE_S tokens (every local ring wraps at the window
#: 1,024); qwen1.5-32b at 4 layers; internvl2-1b and seamless at full
#: depth.
GEMMA_ARCH, QWEN_ARCH = "gemma3-27b", "qwen1.5-32b"
VLM_ARCH, ENCDEC_ARCH = "internvl2-1b", "seamless-m4t-large-v2"
GEMMA_WINDOW_LAYERS, GEMMA_DECODE_S = 8, 1152
DECODE_TOL = 2e-3               # decode against the forward (atol = rtol)
QWEN_LAYERS, QWEN_PREFILL_S, QWEN_REF_S = 4, 8192, 512
VLM_TEXT_S, VLM_REF_TEXT_S = 1024, 64
ENCDEC_FRAMES, ENCDEC_TGT, ENCDEC_DECODE_STEPS = 4096, 1024, 64
FAMILY_TRAIN_STEPS, FAMILY_TRAIN_S, FAMILY_TRAIN_B = 3, 512, 8
#: Phases 24-27, the last two families at full width: zamba2-2.7b (its
#: prefill at prefill_32k's length, the Engine, ZAMBA_TRAIN_STEPS float32
#: training steps at B=8, S=512; float32 decode against the forward over
#: ZAMBA_DECODE_S tokens at ZAMBA_DECODE_LAYERS layers, 2 groups) and
#: xlstm-350m (its prefill at XLSTM_PREFILL_S, the Engine, training,
#: float32 decode at full depth over XLSTM_DECODE_S tokens); teacher-forced
#: blocks card against the CPU at FAMILY_REF_S tokens.
ZAMBA_ARCH, XLSTM_ARCH = "zamba2-2.7b", "xlstm-350m"
ZAMBA_PARAMS, XLSTM_PARAMS = 2_340_750_240, 461_919_392
ZAMBA_TRAIN_STEPS, ZAMBA_DECODE_LAYERS, ZAMBA_DECODE_S = 12, 12, 320
XLSTM_PREFILL_S, XLSTM_TRAIN_STEPS, XLSTM_DECODE_S = 4096, 3, 256
XLSTM_PROFILE_S = 128
FAMILY_REF_S = 256
VLM_TRAIN_B, ENCDEC_TRAIN_B = 4, 2
#: Logits card against CPU at full depth (24 layers), float32: 1e-4 +
#: 1e-4 |cpu| (phase_serve_ref's LOGIT_ATOL, and as much again relative,
#: for float32 rounding carried through six times its layers).
FAMILY_LOGIT_RTOL = 1e-4
#: Training (phases 14-17): granite at full width through the launcher,
#: train_4k's batch of 256 x 4,096 cut to 8 x 512 (and its bf16 run to
#: 4 x 512); the card-vs-CPU step at 4 layers, the resume at 2.
TRAIN_ARCH = SERVE_ARCH
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_PROFILE_STEP = 8, 512, 12, 10
TRAIN_BF16_B, TRAIN_BF16_STEPS = 4, 3
TRAIN_REF_LAYERS, TRAIN_REF_B, TRAIN_REF_S = 4, 2, 256
RESUME_LAYERS, RESUME_STEPS, RESUME_EVERY, RESUME_CRASH = 2, 8, 4, 5
TRAIN_LOSS_RTOL = 1e-5          # a step's loss, card vs CPU
TRAIN_GRAD_RTOL = 1e-4          # gradients and updates, Frobenius, relative
GATE_GRAD_ATOL = 1e-6           # the gate's d/dlogits against autograd
TRAIN_RESUME_RTOL = 1e-4        # resumed losses after the first
#: Slack on a near-tie's margin beyond the devices' measured difference:
#: well above float32 rounding of a gate score in [-1, 1] (6e-8), far below
#: the typical gap between neighbouring scores (~1e-3).
NEAR_TIE_SLACK = 1e-6
LAYER_RTOL = 1e-5       # a layer's outputs, over their largest magnitude

#: benchmarks/bench_fleet.py:107-127: FRONTIER_SMOKE and its gates.
FRONTIER = dict(targets=(("paper_grid", "pi3"), ("paper_grid", "pi3_reg")),
                eps_b=0.05, seeds=(0, 1), T=4096, chunk=256, rel_tol=0.025)
FRONTIER_RATIO_BAND = (0.90, 1.0)
FRONTIER_MIN_SAVED_FRAC = 0.30
#: benchmarks/bench_atlas.py:71-144: ATLAS_SWEEP (the "full" preset) and
#: its gates.
ATLAS_PRESET = "full"
ATLAS = dict(
    families=("paper_grid", "random_geometric", "ring", "tree", "expander",
              "fat_tree", "wireless_grid", "ge_grid", "ge_comp_grid"),
    topo_seeds=tuple(range(56)),
    policy="pi3", eps_b=0.05, seeds=(0, 1, 2),
    T=4096, chunk=512, rel_tol=0.1, max_calls=8,
    n_buckets=3, max_requeues=1)
ATLAS_RATIO_BAND = (0.90, 1.0)
ATLAS_BAND_FAMILIES = ("paper_grid", "random_geometric", "ring", "tree",
                       "expander", "fat_tree")
ATLAS_MAX_BAND_WIDTH = 0.2
ATLAS_GATES = dict(min_cells=500, min_lanes=1500, max_launches=450,
                   max_bucket_launches=200, min_speedup=10.0)

#: benchmarks/bench_serving.py:39-55: SERVING_SMOKE and its gates.
SERVING_SMOKE = dict(scenario="paper_grid", policy="pi3_reg",
                     trace="bursty", rate_fracs=(0.95, 1.3),
                     seeds=(0, 1), T=4096, chunk=512, eps_b=0.05)
SERVING_MIN_RATIO = 0.9      # delivered_qps / bound_exact floor
SERVING_MAX_SHED = 0.02      # shed fraction ceiling (gate must stay open)
SERVING_P99_MAX = 512.0      # p99 sojourn ceiling, slots
SERVING_OVERLOAD_FRAC = 1.3
SERVING_OVERLOAD_MIN_SHED = 0.10
SERVING_OVERLOAD_RATE_SLACK = 1.05
#: phase_serving: the main path's 1,512 jobs facing the fairness-stress
#: trace (half bursty, half steady); tests/test_serving.py:293-308's rule:
#: a lane that sheds more than FAIR_SHED keeps its two classes' admitted
#: shares within FAIR_GAP.
SERVING_TRACE = "bursty_mix"
FAIR_SHED, FAIR_GAP = 0.1, 0.05
#: phase_serving_parity: lanes of the subset, the diurnal check's offered
#: rate tolerance, and tests/test_serving.py:310-331's outage check.
SERVING_PARITY_LANES = 64
DIURNAL_RATE_TOL = 0.02
OUTAGE = dict(scenario="outage_grid", trace="bursty", frac=0.95,
              seeds=(0, 1), T=4096, chunk=256, after_t=3072, qps_frac=0.9)
#: phase_stream: the small atlas run with the stream on and off.
STREAM_ATLAS = dict(families=("paper_grid", "ring"), topo_seeds=range(4))
#: phase_resilience: the fleet's preemption boundary, the serving run's,
#: the chunk records the child process streams before it is killed, the
#: lanes of the fault runs, and the snapshots timed per carry.
RESILIENCE_KILL, SERVING_KILL, CHILD_KILL_RECORDS = 3, 4, 3
FAULT_LANES = 64
SNAPSHOT_REPS = 5
CHILD_TIMEOUT_S = 300

#: What the phases the dry-run is held against measured on the card:
#: {"granite_prefill" | "gemma3_prefill" | "granite_train": {"ms": the
#: median step, "state_bytes": the real state's bytes, "peak_bytes":
#: the peak device memory of the timed steps}}.
MEASURED: dict = {}
#: The dry-run's cross-check: (arch, B, S, kind, RunConfig overrides, the
#: MEASURED key, the model-FLOPs share predicted from earlier times).
DRYRUN_CHECKS = (
    ("granite-moe-1b-a400m", 1, 32_768, "prefill", {}, "granite_prefill",
     0.06),
    ("gemma3-27b", 1, 32_768, "prefill", {"param_dtype": "bfloat16"},
     "gemma3_prefill", 0.51),
    ("granite-moe-1b-a400m", 8, 512, "train",
     {"activ_dtype": "float32", "remat": "full"}, "granite_train", 0.24))
DRYRUN_TAG = "smoke"
DRYRUN_BUDGET_S = 150.0         # the sweep's wall budget
DRYRUN_TIMEOUT_S = 600
#: Profiler windows a traced measurement (`device_ms`, `route_activities`,
#: `profile_graph`) tries before it gives up on lost records, and the pause
#: before each retry: on some hosts the profiler drops whole windows in
#: runs (an H100 kept 0 of 7 and 0 of 10 records in 3 windows in a row).
PROFILE_TRIES = 8
PROFILE_RETRY_S = 0.5
#: The kernel `torch.cuda._sleep` launches: `open_window` starts a traced
#: window with PROFILE_PAD of them and `settle` ends it with a few, and
#: traced measurements leave their records out.
SPIN = "spin_kernel"
PROFILE_PAD = 1024


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else \
        "nvidia-smi: no output"


def host_cpu() -> str:
    """The host CPU's model and vector extensions: the CPU side of the
    card-vs-CPU checks runs on it, and its float32 results follow MKL's
    code path for that CPU and torch's thread count."""
    lines = pathlib.Path("/proc/cpuinfo").read_text().splitlines()
    model = next((ln.split(":", 1)[1].strip() for ln in lines
                  if ln.startswith("model name")), "model not reported")
    flags = next((ln.split(":", 1)[1].split() for ln in lines
                  if ln.startswith("flags")), [])
    return " ".join([model] + [f for f in ("avx2", "avx512f", "amx_tile")
                               if f in flags])


def card_peaks(name: str):
    """The peaks the bounds use: the H100 SXM's published ones (memory
    bytes/s, float32 operations/s outside the tensor cores, dense bfloat16
    operations/s on them), from `repro_torch.launch.roofline`, the one
    source; another card's are not in this script."""
    from repro_torch.launch import roofline as rl
    check("H100" in name and "PCIe" not in name and "NVL" not in name,
          f"bounds are stated for the H100 SXM only; add the peaks of "
          f"{name!r} before measuring on it")
    return {"bytes": rl.HBM_BW, **rl.PEAK_FLOPS}


def device_ms(fn, match: str | None = None, n: int = 60,
              warm: int = 10) -> float:
    """Median device time of one call of ``fn``: the durations of the CUDA
    activities a profiler trace records for each of ``n`` calls after a
    warm-up (only those whose name contains ``match``, when given).  Host
    overhead between launches is excluded: this is the card's time.  The
    profiler can leave out the records of a few launches at the edge of a
    window (torch 2.11 on an H100: 4-5 of 60 launches of the fused slot
    step in some processes, while the runtime recorded all 60 and the
    launch counter moved 60; 1 of 2 of the CUDA-core flash kernel once),
    so with ``match``, where a call launches one matching kernel, a window
    runs max(2, n // 4) spare calls as well, and the median is over every
    call recorded, at least ``n``.  A window that
    still records fewer is logged and measured again after a pause, up to
    PROFILE_TRIES windows in all; if none holds enough records, the
    measurement fails: a time taken another way would not be the same
    quantity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    calls = n + max(2, n // 4) if match else n
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(PROFILE_RETRY_S)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            open_window()
            for _ in range(calls):
                fn()
            settle()
        evs = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and SPIN not in e.name
               and (match is None or match in e.name)]
        if len(evs) >= n:
            break
        log(f"device_ms: the profiler saw {len(evs)} device activities "
            f"for {calls} calls (match {match!r}); measuring again")
    check(len(evs) >= n, f"profiler saw {len(evs)} device activities for "
          f"{calls} calls in each of {PROFILE_TRIES} windows")
    if match:
        return statistics.median(e.device_time for e in evs) / 1e3
    if len(evs) % n:                     # calls differ: report the mean
        return sum(e.device_time for e in evs) / n / 1e3
    k = len(evs) // n
    evs.sort(key=lambda e: e.time_range.start)
    per_call = [sum(e.device_time for e in evs[i * k:(i + 1) * k])
                for i in range(n)]
    return statistics.median(per_call) / 1e3


def open_window() -> None:
    """Start a traced window with PROFILE_PAD short spin kernels (`SPIN`).
    In a long process the profiler loses the first records of a window,
    more of them the longer the process has run (an H100 lost 1 of 20 at
    64 s, 14 of 20 at 413 s, all of a window later on; a pause at the
    start did not help, a fresh process lost none), so what is measured
    comes after records the profiler may drop."""
    import torch
    for _ in range(PROFILE_PAD):
        torch.cuda._sleep(100)


def settle() -> None:
    """End a traced window: wait for the card, queue a few spin kernels
    (`SPIN`) and pause on the host before the profiler stops, so what is
    measured is not last either."""
    import torch
    torch.cuda.synchronize()
    for _ in range(8):
        torch.cuda._sleep(2000)
    torch.cuda.synchronize()
    time.sleep(0.05)


def wall_ms(fn, n: int = 60, warm: int = 10) -> float:
    """Median time of one call between CUDA events recorded around it on
    the host's stream: includes the host's launch overhead."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(n):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def phase_build_report(_build) -> None:
    """What ptxas reported for the flash sources (registers, spills; no
    spill store in the CUDA-core kernel's instantiations), that kernel's
    build seconds and CTAs per SM, the fused slot step's registers and
    shared memory, and the sm90 kernel's SASS: it must hold HGMMA (wgmma)
    instructions."""
    for name in ("flash_attention.cu", "flash_attention_sm90.cu"):
        src = next(s for s in _build.sources() if s.name == name)
        lines = _build.library_path(src).with_suffix(".log").read_text()
        log(f"ptxas, {name}: " + " | ".join(
            ln.strip() for ln in lines.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln))
        if name == "flash_attention.cu":
            spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores",
                                                 lines)]
            check(len(spills) >= 7 and not any(spills),
                  f"{name}: ptxas reports spill stores {spills} (or fewer "
                  f"than its 7 instantiations)")
            secs = re.findall(re.escape(_build.NVCC_SECONDS) + r" (\S+)",
                              lines) or ["not recorded"]
    from repro_torch.kernels.flash_attention import kernel as K
    log(f"flash_attention.cu: nvcc {secs[-1]} s (while the other sources "
        f"built beside it); CTAs of 256 threads per SM: " + ", ".join(
            f"{str(dt).split('.')[1]} D={D}: {K.occupancy(dt, D)}"
            for dt, dims in K.HEAD_DIMS.items() for D in dims))
    cuobjdump = pathlib.Path(_build.nvcc()).parent / "cuobjdump"
    src = next(s for s in _build.sources() if s.name == "bp_slot_step.cu")
    usage = subprocess.run([str(cuobjdump), "--dump-resource-usage",
                            str(_build.library_path(src))],
                           capture_output=True, text=True, timeout=300).stdout
    log("resource usage, bp_slot_step.cu: " + " | ".join(
        ln.strip() for ln in usage.splitlines() if "REG" in ln))
    src = next(s for s in _build.sources()
               if s.name == "flash_attention_sm90.cu")
    sass = subprocess.run([str(cuobjdump), "-sass",
                           str(_build.library_path(src))],
                          capture_output=True, text=True, timeout=300).stdout
    ops = [t for ln in sass.splitlines() for t in ln.split()
           if t.startswith("HGMMA")]
    check(len(ops) > 0, "the sm90 flash kernel's SASS holds no HGMMA")
    log(f"SASS of flash_attention_sm90.cu: {len(ops)} HGMMA instructions "
        f"({', '.join(sorted(set(ops)))})")


# ---------------------------------------------------------------------------
# Phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def route_inputs(gen, ties: bool, dev):
    import torch
    B, N, C, E = B_MAIN, N_MAIN, C_MAIN, E_MAIN
    if ties:
        base = torch.randint(0, 4, (B, N, C // 3), generator=gen).float()
        Qf = base.repeat(1, 1, 3)                    # duplicated columns
        Qf[:, 1] = 0.0                               # an all-zero row
    else:
        Qf = torch.rand((B, N, C), generator=gen) * 100
    m = torch.randint(0, N, (B, E), generator=gen)
    l = (m + 1 + torch.randint(0, N - 1, (B, E), generator=gen)) % N
    m[:, -3:] = 0                                    # padded self-loops
    l[:, -3:] = 0
    if ties:
        m[:, 0] = 1
        l[:, 0] = 1
    return (Qf.contiguous().to(dev), m.to(torch.int32).to(dev),
            l.to(torch.int32).to(dev))


def balance_inputs(gen, ties: bool, dev):
    import torch
    B, NC = B_MAIN, NC_MAIN

    def r(lo, hi):
        if ties:
            return torch.randint(int(lo), int(hi) + 1, (B, NC),
                                 generator=gen).float()
        return lo + torch.rand((B, NC), generator=gen) * (hi - lo)
    from repro_torch.kernels.bp_slot.ref import PANELS
    p = dict(q0=r(0, 10), q1=r(0, 10), q2=r(0, 10), H=r(0, 10),
             caps=r(1, 3), x1=r(0, 10), x2=r(0, 10), ca1=r(5, 20),
             ca2=r(5, 20), cc=r(0, 5), x_net=r(0, 10))
    p["mask"] = (torch.rand((B, NC), generator=gen) > 0.3).float()
    p["mask"][:16] = 0.0                             # all-masked sims
    p["mask"][16:32] = 1.0
    eps = torch.tensor([0.0, 0.01, 0.05, 0.3])[
        torch.randint(0, 4, (B,), generator=gen)]
    return [eps.to(dev)] + [p[k].contiguous().to(dev) for k in PANELS]


def bound_of(nbytes: int, nops: int, peaks, dtype: str = "float32"):
    """(least ms the card could take, "bytes" or "operations"): the larger
    of the bytes over the memory rate and the operations over the card's
    peak rate for the operands' ``dtype``."""
    t_bytes, t_ops = nbytes / peaks["bytes"], nops / peaks[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def bits_equal(a, b) -> bool:
    import torch
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def max_abs_err(pairs) -> float:
    err = 0.0
    for a, b in pairs:
        err = max(err, float((a.double() - b.double()).abs().max()))
    return err


def phase_kernels(dev, peaks):
    import torch
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.kernels.bp_slot import ref as R
    gen = torch.Generator().manual_seed(0)
    rows = {}

    # slot_route_decide
    errs, timing = [], None
    for ties in (False, True):
        Qf, m, l = route_inputs(gen, ties, dev)
        best, dmax = K.slot_route_decide(Qf, m, l)
        rbest, rdmax = R.slot_route_ref(Qf, m, l)
        torch.cuda.synchronize()
        check(bits_equal(best, rbest) and bits_equal(dmax, rdmax),
              f"slot_route_decide differs from its plain version "
              f"(ties={ties})")
        if ties:
            check(bool((best[:, 0] == 0).all()), "zero row must pick 0")
        check(bool((best[:, -3:] == 0).all() and (dmax[:, -3:] == 0).all()),
              "padded self-loops must pick class 0 with zero diff")
        errs += [(best, rbest), (dmax, rdmax)]
        if not ties:
            timing = (Qf, m, l)
    Qf, m, l = timing
    B, N, C = Qf.shape
    E = m.shape[1]
    # Bytes the function needs: the Qf rows some edge reads (counted on
    # this run's indices), both index arrays, and both outputs.
    read = torch.cat([m, l], 1).long() + \
        torch.arange(B, device=dev)[:, None] * N
    n_rows = int(read.unique().numel())
    nbytes = 4 * n_rows * C + 2 * 4 * B * E + (4 + 4) * B * E
    nops = 3 * B * E * C                 # subtract, |.|, compare per class
    rows["slot_route_decide"] = dict(
        name="slot_route_decide", route="cuda",
        source="src/repro_torch/kernels/bp_slot/csrc/bp_slot.cu",
        replaces="src/repro/kernels/bp_slot/kernel.py:59",
        max_abs_err=max_abs_err(errs),
        ms=device_ms(lambda: K.slot_route_decide(Qf, m, l),
                     match="slot_route_decide_kernel"),
        wrapper_ms=device_ms(lambda: K.slot_route_decide(Qf, m, l)),
        wall_ms=wall_ms(lambda: K.slot_route_decide(Qf, m, l)),
        plain_ms=device_ms(lambda: R.slot_route_ref(Qf, m, l)),
        library_ms=None, bytes=nbytes, ops=nops)

    # comp_balance_decide
    errs, timing = [], None
    for ties in (False, True):
        args = balance_inputs(gen, ties, dev)
        for pairing in ("fifo", "bound"):
            for thresholded in (False, True):
                kw = dict(pairing=pairing, thresholded=thresholded,
                          threshold=3.0)
                Z, n = K.comp_balance_decide(*args, **kw)
                rZ, rn = R.comp_balance_ref(*args, **kw)
                torch.cuda.synchronize()
                check(bits_equal(Z, rZ) and bits_equal(n, rn),
                      f"comp_balance_decide differs from its plain version "
                      f"(ties={ties}, {kw})")
                check(bool((n[:16] == 0).all()), "all-masked sims must give 0")
                errs += [(Z, rZ), (n, rn)]
        if not ties:
            timing = args
    args = timing
    NC = args[1].shape[1]
    # Timed as the main path calls it (pi3_reg: fifo pairing, no gate).
    # Bytes: eps, the panels this pairing reads, Z and n*.
    kw = dict(pairing="fifo", thresholded=False, threshold=0.0)
    n_panels = len(R.PANELS) - len(BALANCE_UNREAD[kw["pairing"]])
    nbytes = 4 * B * (1 + n_panels * NC) + 4 * B * NC + 4 * B
    nops = 16 * B * NC                   # pairs, clip, gate, score, fold
    rows["comp_balance_decide"] = dict(
        name="comp_balance_decide", route="cuda",
        source="src/repro_torch/kernels/bp_slot/csrc/bp_slot.cu",
        replaces="src/repro/kernels/bp_slot/kernel.py:138",
        max_abs_err=max_abs_err(errs),
        ms=device_ms(lambda: K.comp_balance_decide(*args, **kw),
                     match="comp_balance_decide_kernel"),
        wrapper_ms=device_ms(lambda: K.comp_balance_decide(*args, **kw)),
        wall_ms=wall_ms(lambda: K.comp_balance_decide(*args, **kw)),
        plain_ms=device_ms(lambda: R.comp_balance_ref(*args, **kw)),
        library_ms=None, bytes=nbytes, ops=nops)
    rows["bp_topk"] = phase_topk(dev, peaks)
    for r in rows.values():
        r["bound_ms"], r["bound_by"] = bound_of(r["bytes"], r["ops"], peaks)
        log(f"kernel {r['name']}: {r['ms']:.6f} ms on the card (wrapper "
            f"{r['wrapper_ms']:.6f} ms of device time, {r['wall_ms']:.6f} ms "
            f"between host events; plain {r['plain_ms']:.6f} ms on the card"
            f"), bound {r['bound_ms'] * 1e3:.4f} us by {r['bound_by']} "
            f"({r['bytes']} B, {r['ops']} ops), max_abs_err "
            f"{r['max_abs_err']}, library: no single PyTorch call")
    return rows


#: Shapes of the noise kernel's row, with the form each site there takes
#: and the slot counter's dtype: the fleet cell's widest draw (504 lanes'
#: link chain, E=24), the trace simulator's regulator (B=9, N_C=4), and
#: phase_main's draws at B_MAIN (arrivals [B, 1], link chain [B, E_MAIN],
#: comp chain and regulator [B, NC_MAIN]).  Every form and site is checked
#: at each shape; the timing takes the form named here.
HASH_SHAPES = {"": (504, 24, "uniform", "int32"),
               "regulator_": (9, 4, "bernoulli", "int64"),
               "main_arrivals_": (B_MAIN, 1, "uniform64", "int32"),
               "main_": (B_MAIN, E_MAIN, "uniform", "int32"),
               "main_chain_": (B_MAIN, NC_MAIN, "uniform", "int32"),
               "main_regulator_": (B_MAIN, NC_MAIN, "bernoulli", "int32")}


def hash_inputs(B: int, t_dtype: str, dev):
    import numpy as np
    import torch
    rng = np.random.default_rng(B)
    seed = torch.as_tensor(rng.integers(-2 ** 63, 2 ** 63 - 1, B,
                                        dtype=np.int64), device=dev)
    t = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, B),
                        dtype=getattr(torch, t_dtype), device=dev)
    eps = torch.as_tensor(rng.random(B, dtype=np.float32), device=dev)
    return seed, t, eps


def phase_counter_hash(dev, peaks):
    """The noise kernel against the plain int64 chain on the card, every
    form and site at each HASH_SHAPES shape, bit for bit; device times of
    one launch and of the chain beside the bound by bytes (it reads seed,
    t and eps and writes the draw once)."""
    from repro_torch.kernels.counter_hash import kernel as CH
    from repro_torch.kernels.counter_hash import ref as CR
    row = dict(name="counter_hash", route="cuda",
               source="src/repro_torch/kernels/counter_hash/csrc/"
                      "counter_hash.cu",
               replaces="none (the JAX package draws with threefry inside "
                        "XLA)", max_abs_err=0.0, library_ms=None)
    for key, (B, n, form, t_dtype) in HASH_SHAPES.items():
        seed, t, eps = hash_inputs(B, t_dtype, dev)
        for f in CR.FORMS:
            for site in range(1, 8):
                check(bits_equal(CH.counter_hash(seed, t, site, n, f, eps),
                                 CR.counter_hash_ref(seed, t, site, n, f,
                                                     eps)),
                      f"counter_hash differs from its plain chain at "
                      f"({B}, {n}), {f}, site {site}, t {t_dtype}")
        nbytes = B * (8 + t.element_size() + 4 * (form == "bernoulli")) + \
            B * n * CH.DTYPES[form].itemsize
        row[key + "ms"] = device_ms(
            lambda: CH.counter_hash(seed, t, 4, n, form, eps),
            match="counter_hash_kernel")
        row[key + "plain_ms"] = device_ms(
            lambda: CR.counter_hash_ref(seed, t, 4, n, form, eps))
        row[key + "bound_ms"], row["bound_by"] = bound_of(nbytes, 0, peaks)
        log(f"kernel counter_hash at ({B}, {n}), {form}, t {t_dtype}: "
            f"{row[key + 'ms']:.6f} ms on the card, the plain chain "
            f"{row[key + 'plain_ms']:.6f} ms, bound "
            f"{row[key + 'bound_ms'] * 1e3:.4f} us by bytes ({nbytes} B); "
            f"bit-identical in every form and site")
    return row


def topk_inputs(gen, T: int, E: int, ties: bool, bias: str, dev):
    """Gate logits [T, E] and bias [E]: normal logits, or integer-valued
    ones in [-2, 2] (exact ties in every row, and one all-equal row); bias
    zero, uniform [0, 0.5), or multiples of 1/8 (ties survive it)."""
    import torch
    if ties:
        s = torch.randint(-2, 3, (T, E), generator=gen).float()
        s[0] = 1.0
    else:
        s = torch.randn((T, E), generator=gen)
    if bias == "zero":
        b = torch.zeros(E)
    elif bias == "step":
        b = torch.randint(0, 2, (E,), generator=gen).float() / 8
    else:
        b = torch.rand((E,), generator=gen) * 0.5
    return s.to(dev), b.to(dev)


def phase_topk(dev, peaks):
    """bp_topk against its plain version, bit for bit, at the serving
    path's decode shape and the three shapes of the kernel table, on random
    and tie-heavy inputs; once through its entry point `bp_topk_op` with
    the launch count read around it (its path: the model routes through
    bp_topk_route); device times at each shape.  The row reported is one
    decode step's gate of `Engine(slots=4)`."""
    import torch
    from repro_torch.kernels.bp_topk import kernel as K
    from repro_torch.kernels.bp_topk.ops import bp_topk_op
    from repro_torch.kernels.bp_topk.ref import bp_topk_ref
    gen = torch.Generator().manual_seed(1)
    errs, timed = [], {}
    for T, E, k in TOPK_SHAPES:
        for ties, bias in ((False, "random"), (True, "zero"), (True, "step")):
            s, b = topk_inputs(gen, T, E, ties, bias, dev)
            idx, w = K.bp_topk(s, b, k)
            ridx, rw = bp_topk_ref(s, b, k)
            torch.cuda.synchronize()
            check(bits_equal(idx, ridx) and bits_equal(w, rw),
                  f"bp_topk differs from its plain version at T={T}, E={E}, "
                  f"k={k}, ties={ties}, bias={bias}: "
                  f"{int((idx != ridx).sum())} indices, weights by "
                  f"{float((w - rw).abs().max())}")
            if ties and bias == "zero":
                check(bool((idx[0] == torch.arange(k, device=dev)).all()),
                      "an all-equal row must pick experts 0..k-1")
            errs += [(idx, ridx), (w, rw)]
            if not ties:
                timed[(T, E, k)] = (s, b)
    # bp_topk's path: its entry point `bp_topk_op` (the counterpart of
    # the JAX package's op), once, with the launch count read around it;
    # the model routes through bp_topk_route (phase_topk_route)
    s, b = timed[TOPK_SHAPES[0]]
    K.bp_topk.launches = 0
    oidx, _ = bp_topk_op(s.reshape(2, -1, s.shape[1]), b, TOPK_SHAPES[0][2])
    torch.cuda.synchronize()
    launches = K.bp_topk.launches
    check(launches == 1, f"bp_topk_op launched bp_topk {launches} times")
    check(torch.equal(oidx.reshape(TOPK_SHAPES[0][0], -1),
                      bp_topk_ref(s, b, TOPK_SHAPES[0][2])[0]),
          "bp_topk_op differs from the plain version")
    for (T, E, k), (s, b) in timed.items():
        nbytes = 4 * T * E + 4 * E + (4 + 4) * T * k
        # max, subtract, exp, sum, divide, bias per entry; k argmax passes;
        # k adds and k divides for the weights
        nops = T * ((6 + k) * E + 2 * k)
        row = dict(
            name="bp_topk", route="cuda",
            source="src/repro_torch/kernels/bp_topk/csrc/bp_topk.cu",
            replaces="src/repro/kernels/bp_topk/kernel.py:43",
            max_abs_err=max_abs_err(errs), shape=(T, E, k),
            launches=launches, path="bp_topk_op (phase_topk)",
            ms=device_ms(lambda: K.bp_topk(s, b, k), match="bp_topk_kernel"),
            wrapper_ms=device_ms(lambda: K.bp_topk(s, b, k)),
            wall_ms=wall_ms(lambda: K.bp_topk(s, b, k)),
            plain_ms=device_ms(lambda: bp_topk_ref(s, b, k)),
            library_ms=None, bytes=nbytes, ops=nops)
        t_ms, by = bound_of(nbytes, nops, peaks)
        log(f"kernel bp_topk at T={T}, E={E}, k={k}: {row['ms']:.6f} ms on "
            f"the card (wrapper {row['wrapper_ms']:.6f} ms of device time, "
            f"{row['wall_ms']:.6f} ms between host events; plain "
            f"{row['plain_ms']:.6f} ms on the card), bound "
            f"{t_ms * 1e3:.6f} us by {by} ({nbytes} B, {nops} ops)")
        if (T, E, k) == TOPK_SHAPES[0]:
            main_row = row
    return main_row


def route_bound(T: int, E: int, k: int, itemsize: int, peaks,
                score: str = "softmax"):
    """(bytes, operations, bound ms, bound by) of one bp_topk_route call:
    the logits, H and steps read once; idx (int64), w, counts, H_new and
    steps written once.  Operations per entry: max, subtract, exp, add,
    divide (the sigmoid mode: exp, add, reciprocal), bias subtract and its
    divide, and one compare per level of the selection network (log2 E of
    them); per pick: an add and a divide (the sigmoid mode: and the routed
    scale's multiply); per expert: the H update's add, subtract and
    max."""
    nbytes = itemsize * T * E + 4 * E + 4 + (8 + itemsize) * T * k + \
        (4 + 4) * E + 4
    per_entry, per_pick = (7, 2) if score == "softmax" else (5, 3)
    nops = T * ((per_entry + max(1, math.ceil(math.log2(E)))) * E +
                per_pick * k) + 3 * E
    return (nbytes, nops) + bound_of(nbytes, nops, peaks)


def phase_topk_route(dev, peaks):
    """bp_topk_route against its plain version, bit for bit in idx, w,
    counts, H_new and steps: TOPK_SHAPES in float32 and bfloat16, and the
    32k prefill's gate and ROUTE_MORE_SHAPES in bfloat16; random and
    tie-heavy logits, with and
    without backpressure, non-zero H; each case launched twice back to
    back (the second launch must equal the first: the first left its
    workspace zero).  Device times at the decode step's shape (float32,
    the serve path's) and at the bfloat16 shapes beside their bounds (the
    last two straddle the kernel's switch to one thread per row); the row
    reported is the decode step's, with the sigmoid mode's keys
    (`topk_route_sigmoid`)."""
    import torch
    from repro_torch.kernels.bp_topk import kernel as K
    from repro_torch.kernels.bp_topk.ref import bp_topk_route_ref
    gen = torch.Generator().manual_seed(4)
    errs, n = [], 0
    cases = [(shape, dt) for shape in TOPK_SHAPES
             for dt in (torch.float32, torch.bfloat16)]
    cases += [(shape, torch.bfloat16)
              for shape in (ROUTE_PREFILL_SHAPE,) + ROUTE_MORE_SHAPES]
    timed = {}
    for (T, E, k), dt in cases:
        for ties, bp in ((False, True), (True, True), (True, False)):
            s, _ = topk_inputs(gen, T, E, ties, "zero", dev)
            s = s.to(dt)
            H = (torch.randint(0, 6, (E,), generator=gen).float() *
                 0.5).to(dev)
            steps = torch.tensor(7, dtype=torch.int32, device=dev)
            cap = T * k / E
            want = bp_topk_route_ref(s, H, steps, cap, k, bp)
            for _ in range(2):
                got = K.bp_topk_route(s, H, steps, cap, k, bp)
                torch.cuda.synchronize()
                check(all(a.dtype == b.dtype and bits_equal(a, b)
                          for a, b in zip(got, want)),
                      f"bp_topk_route differs from its plain version at "
                      f"T={T}, E={E}, k={k}, {dt}, ties={ties}, "
                      f"backpressure={bp}: "
                      f"{int((got[0] != want[0]).sum())} indices, counts "
                      f"{int((got[2] != want[2]).sum())}, steps "
                      f"{int(got[4])}/{int(want[4])}")
                n += 1
            if ties and not bp:
                check(bool((got[0][0] == torch.arange(k, device=dev)).all()),
                      "an all-equal row must pick experts 0..k-1")
            check(float(got[2].sum()) == T * k, "counts must sum to T k")
            errs += [(a.float(), b.float()) for a, b in zip(got, want)]
            if not ties:
                timed[(T, E, k, dt)] = (s, H, steps, cap, k)
    rows = []
    for key in [(*TOPK_SHAPES[0], torch.float32)] + [
            (*shape, torch.bfloat16)
            for shape in (ROUTE_PREFILL_SHAPE,) + ROUTE_MORE_SHAPES]:
        s, H, steps, cap, k = timed[key]
        T, E = s.shape
        nbytes, nops, b_ms, by = route_bound(T, E, k, s.element_size(),
                                             peaks)

        def call():
            return K.bp_topk_route(s, H, steps, cap, k, True)

        def plain():
            return bp_topk_route_ref(s, H, steps, cap, k, True)
        row = dict(
            name="bp_topk_route", route="cuda",
            source="src/repro_torch/kernels/bp_topk/csrc/bp_topk_route.cu",
            replaces="src/repro/kernels/bp_topk/kernel.py:43",
            max_abs_err=max_abs_err(errs), shape=(T, E, k),
            ms=device_ms(call, match="bp_topk_route_"),
            wrapper_ms=device_ms(call), wall_ms=wall_ms(call),
            plain_ms=device_ms(plain), library_ms=None, bytes=nbytes,
            ops=nops, bound_ms=b_ms, bound_by=by)
        log(f"kernel bp_topk_route at T={T}, E={E}, k={k}, {key[3]}: "
            f"{row['ms']:.6f} ms on the card (wrapper {row['wrapper_ms']:.6f}"
            f" ms of device time, {row['wall_ms']:.6f} ms between host "
            f"events; plain {row['plain_ms']:.6f} ms on the card), bound "
            f"{b_ms * 1e3:.6f} us by {by} ({nbytes} B, {nops} ops), "
            f"{row['ms'] / b_ms:.2f}x the bound; library: no single PyTorch "
            f"call")
        rows.append(row)
    log(f"bp_topk_route: {n} launches bit-identical to the plain version "
        f"({len(cases)} shapes x dtypes, 3 input kinds, twice each)")
    rows[0].update(topk_route_sigmoid(gen, dev, peaks))
    return rows[0]


def topk_route_sigmoid(gen, dev, peaks):
    """bp_topk_route's sigmoid mode at Moonlight's prefill gate
    (MLA_ROUTE_SHAPE, bfloat16 logits, the configuration's routed scale)
    against its plain version (`ref.bp_topk_route_ref` in the sigmoid mode,
    whose picks and weights are `ref.bp_topk_sigmoid_ref`'s), bit for bit
    in idx, w, counts, H_new and steps: random and tie-heavy logits, with
    and without backpressure, non-zero H, each launched twice back to
    back; then its device ms beside the plain version's and the bound.
    Returns the row's `sigmoid_*` keys."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.bp_topk import kernel as K
    from repro_torch.kernels.bp_topk.ref import bp_topk_route_ref
    T, E, k = MLA_ROUTE_SHAPE
    scale = get_config(MLA_ARCH).routed_scale
    n = 0
    for ties, bp in ((False, True), (True, True), (True, False)):
        s, _ = topk_inputs(gen, T, E, ties, "zero", dev)
        s = s.to(torch.bfloat16)
        H = (torch.randint(0, 6, (E,), generator=gen).float() * 0.5).to(dev)
        steps = torch.tensor(7, dtype=torch.int32, device=dev)
        cap = T * k / E
        want = bp_topk_route_ref(s, H, steps, cap, k, bp, "sigmoid", scale)
        for _ in range(2):
            got = K.bp_topk_route(s, H, steps, cap, k, bp, score="sigmoid",
                                  scale=scale)
            torch.cuda.synchronize()
            check(all(a.dtype == b.dtype and bits_equal(a, b)
                      for a, b in zip(got, want)),
                  f"bp_topk_route (sigmoid) differs from its plain version "
                  f"at T={T}, E={E}, k={k}, bf16, ties={ties}, "
                  f"backpressure={bp}: {int((got[0] != want[0]).sum())} "
                  f"indices, counts {int((got[2] != want[2]).sum())}")
            n += 1
        check(float(got[2].sum()) == T * k, "counts must sum to T k")
        if not ties:
            timed = (s, H, steps, cap)
    s, H, steps, cap = timed
    nbytes, nops, b_ms, by = route_bound(T, E, k, s.element_size(), peaks,
                                         "sigmoid")
    ms = device_ms(lambda: K.bp_topk_route(s, H, steps, cap, k, True,
                                           score="sigmoid", scale=scale),
                   match="bp_topk_route_")
    plain = device_ms(lambda: bp_topk_route_ref(s, H, steps, cap, k, True,
                                                "sigmoid", scale))
    log(f"kernel bp_topk_route (sigmoid mode, routed scale {scale}) at "
        f"Moonlight's prefill gate T={T}, E={E}, k={k}, bf16: {n} launches "
        f"bit-identical to the plain version (3 input kinds, twice each); "
        f"{ms:.6f} ms on the card (sigmoid_ms), plain {plain:.6f} ms on the "
        f"card (sigmoid_plain_ms), bound {b_ms * 1e3:.6f} us by {by} "
        f"({nbytes} B, {nops} ops; sigmoid_bound_ms), "
        f"{ms / b_ms:.2f}x the bound")
    return {"sigmoid_ms": ms, "sigmoid_plain_ms": plain,
            "sigmoid_bound_ms": b_ms}


def route_activities(cfg, p, x, H, calls: int = 10):
    """The CUDA activities of one MoE layer's gate, `moe._route` with
    ``use_kernel=True``, from a profiler trace of ``calls`` calls after a
    warm-up: (activities per call, the distinct names).  The profiler can
    drop records (see `device_ms`; one window on an H100 kept the fill
    kernels of 10 calls and none of their bp_topk_route launches), so a window that holds fewer bp_topk_route records than
    calls is traced again, up to PROFILE_TRIES windows; per call is the
    trace's activities over its bp_topk_route records."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.router import RouterState
    from repro_torch.models import moe
    G, Tg, _ = x.shape
    rs = RouterState(H=H, steps=torch.zeros((), dtype=torch.int32,
                                            device=x.device))
    moe._route(cfg, p, x, rs, use_kernel=True)
    torch.cuda.synchronize()
    best = (0, [])
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(PROFILE_RETRY_S)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_window()
            for _ in range(calls):
                moe._route(cfg, p, x, rs, use_kernel=True)
            settle()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and SPIN not in e.name]
        gates = sum("bp_topk_route_" in nm for nm in names)
        check(not any("softmax" in nm.lower() for nm in names),
              f"the backpressure gate launched a softmax: "
              f"{sorted(set(names))}")
        if gates > best[0]:
            best = (gates, names)
        if gates == calls:
            break
        log(f"route_activities: the profiler kept {gates} of {calls} "
            f"bp_topk_route records and {len(names)} activities; tracing "
            f"again")
    gates, names = best
    check(gates > 0, f"no trace of {PROFILE_TRIES} windows holds a "
          f"bp_topk_route launch of the gate's {calls} calls")
    return len(names) / gates, sorted(set(names))


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------

def reset_fused_counts(K) -> None:
    """Zero the fused slot step's counts: launches made eagerly, and
    launches made by replaying the CUDA graphs that captured it."""
    K.slot_step_fused.launches = 0
    K.slot_step_fused.replayed = 0


def draw_sites(jobs) -> int:
    """Noise draws one batched slot of ``jobs`` (one policy group) makes,
    each one launch of the noise kernel: the arrival uniforms unless every
    lane's arrivals are constant, the ON-OFF phase, the link and the comp
    chains where an event model reads them, the regulator's bits where the
    policy is regulated."""
    from repro_torch.fleet.scenarios import (COMP_NOISE_EVENTS,
                                             LINK_NOISE_EVENTS, get_scenario)
    arrivals = {get_scenario(j.scenario).arrival for j in jobs}
    events = {get_scenario(j.scenario).events for j in jobs}
    return (bool(arrivals - {"constant"}) + ("markov_onoff" in arrivals)
            + bool(events & set(LINK_NOISE_EVENTS))
            + bool(events & set(COMP_NOISE_EVENTS))
            + bool(jobs[0].policy_config().use_regulator))


def fused_launches(K) -> dict:
    """The fused slot step's launches since `reset_fused_counts`: eager
    (outside a graph; the first `GRAPH_SLOTS` slots before each capture),
    replayed (graph replays x the launches each captured), and their sum."""
    eager, replayed = K.slot_step_fused.launches, K.slot_step_fused.replayed
    return {"eager": eager, "replayed": replayed,
            "launched": eager + replayed}


def main_jobs():
    from repro_torch.fleet import FleetJob, policy_bound_exact
    jobs, bounds = [], []
    for fam in FAMILIES:
        for ts in TOPO_SEEDS:
            bound = policy_bound_exact(fam, "pi3_reg", EPS_B, topo_seed=ts)
            for frac in RATE_FRACS:
                for seed in SEEDS:
                    jobs.append(FleetJob(scenario=fam, policy="pi3_reg",
                                         lam=frac * bound, seed=seed,
                                         topo_seed=ts, eps_b=EPS_B))
                    bounds.append((bound, frac))
    return jobs, bounds


def phase_main(dev):
    import numpy as np
    import torch
    from repro_torch.fleet import PadDims, run_fleet
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.kernels.counter_hash.kernel import counter_hash
    t0 = time.perf_counter()
    jobs, bounds = main_jobs()
    log(f"main: {len(jobs)} jobs, exact LP bounds in "
        f"{time.perf_counter() - t0:.1f} s")
    check(len(jobs) == B_MAIN, f"expected {B_MAIN} jobs, got {len(jobs)}")
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    K.slot_route_decide.launches = 0
    K.comp_balance_decide.launches = 0
    reset_fused_counts(K)
    counter_hash.launches = counter_hash.replayed = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_fleet(jobs, T=T_MAIN, chunk=CHUNK_MAIN, device=dev, dims=dims,
                    early_stop=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fused = fused_launches(K)
    launches = {"bp_slot_step": fused["launched"],
                "slot_route_decide": K.slot_route_decide.launches,
                "comp_balance_decide": K.comp_balance_decide.launches,
                "counter_hash": counter_hash.launches + counter_hash.replayed}
    sites = draw_sites(jobs)
    check(launches["counter_hash"] == sites * res.slot_steps and
          counter_hash.replayed > 0,
          f"noise-kernel launches {counter_hash.launches} eager + "
          f"{counter_hash.replayed} replayed != {sites} draw sites x "
          f"{res.slot_steps} slots advanced, or none from the graph")
    check(res.n_programs == 1 and res.n_step_compiles == 1,
          f"one policy group and one capture expected: {res.n_programs} "
          f"groups, {res.n_step_compiles} captures")
    check(launches["bp_slot_step"] == res.slot_steps > 0 and
          fused["replayed"] > 0,
          f"fused slot-step launches {fused} != slots advanced "
          f"{res.slot_steps}, or none from the graph")
    check(launches["slot_route_decide"] == 0 and
          launches["comp_balance_decide"] == 0,
          f"the main path launched B1/B2 on their own: {launches}")
    useful = res.column("useful_rate")
    check(bool(np.isfinite(useful).all() and
               np.isfinite(res.column("mean_queue")).all()),
          "non-finite metrics")
    bound = np.array([b for b, _ in bounds])
    frac = np.array([f for _, f in bounds])
    over = useful > LP_TOL * bound
    worst = [(jobs[i].scenario, jobs[i].topo_seed, useful[i], bound[i])
             for i in np.flatnonzero(over)[:5]]
    check(not over.any(),
          f"{int(over.sum())} sims above {LP_TOL} x bound: {worst}")
    verdicts = res.verdicts()
    pg = [i for i, j in enumerate(jobs)
          if j.scenario == "paper_grid" and frac[i] == 0.95]
    eff = float(np.median(useful[pg] / bound[pg]))
    check(eff >= 0.9, f"paper_grid median efficiency at 0.95x is {eff}")
    stable_over = [i for i in range(len(jobs))
                   if frac[i] == 1.3 and verdicts[i] == "STABLE"]
    check(not stable_over, f"{len(stable_over)} sims at 1.3x read STABLE")
    counts = {v: verdicts.count(v) for v in ("STABLE", "UNSTABLE",
                                             "UNDECIDED")}
    sim_slots = res.slot_steps * len(jobs)
    log(f"main: {len(jobs)} sims, T={res.T}, chunk={CHUNK_MAIN}, dims "
        f"{dims}, {res.slot_steps} slots advanced, wall {wall:.3f} s, "
        f"{wall / sim_slots * 1e6:.4f} us per sim-slot, "
        f"{wall / res.slot_steps * 1e3:.4f} ms per batched slot, "
        f"verdicts {counts}, slots_saved {res.slots_saved}, "
        f"paper_grid eff@0.95 {eff:.4f}, launches {launches} ({fused})")
    by_family = {}
    for fam in FAMILIES:
        for f in RATE_FRACS:
            idx = [i for i, j in enumerate(jobs)
                   if j.scenario == fam and frac[i] == f]
            by_family[f"{fam}@{f}"] = round(float(np.median(
                useful[idx] / bound[idx])), 4)
    log("main: median efficiency by family@rate " + json.dumps(by_family))
    return res, jobs, launches, wall


def main_batch(dev):
    """The main path's 1,512 jobs as one padded batch and its run inputs."""
    from repro_torch.fleet import PadDims, engine
    from repro_torch.fleet.batching import from_leaves, pad_leaves
    from repro_torch.fleet.scenarios import arrival_code, event_code, \
        get_scenario
    jobs, _ = main_jobs()
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    leaves = {}
    for j in jobs:
        k = (j.scenario, j.topo_seed)
        if k not in leaves:
            leaves[k] = pad_leaves(get_scenario(j.scenario).build(
                j.topo_seed), dims)
    pp = from_leaves([leaves[(j.scenario, j.topo_seed)] for j in jobs],
                     dims.n_nodes, dims.n_comp, dev)
    return jobs, engine.make_inputs(
        pp, [j.lam for j in jobs], [j.eps_b for j in jobs],
        [arrival_code(get_scenario(j.scenario).arrival) for j in jobs],
        [event_code(get_scenario(j.scenario).events) for j in jobs],
        [j.seed for j in jobs])


def main_runner():
    """The runner `run_fleet` makes for the main path's jobs."""
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.fleet import engine
    return engine.make_stream_runner(
        PolicyConfig(name="pi3_reg", eps_b=EPS_B), T=T_MAIN,
        chunk=CHUNK_MAIN, verdict=engine.resolve_verdict(None, True))


def profile_graph(launch, what: str):
    """One replay of ``launch``'s captured graph, traced: its bp_slot_step
    kernels must be the slots the graph holds (what the launch counts
    multiply by; a trace that lost records is taken again, up to
    PROFILE_TRIES); CUDA activities and device time per slot.  Returns
    (activities per slot, device us per slot)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    check(launch.graph is not None, f"profile: the {what} launcher holds "
          "no captured graph")
    graph, block = launch.graph, launch.block
    for attempt in range(PROFILE_TRIES):
        if attempt:
            time.sleep(PROFILE_RETRY_S)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            open_window()
            graph.replay()
            settle()
        dev_events = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and SPIN not in e.name]
        fused = [e for e in dev_events if "bp_slot_step_kernel" in e.name]
        if len(fused) == block:
            break
        log(f"profile: a traced replay of the {what} graph kept "
            f"{len(fused)} of its {block} bp_slot_step records; tracing "
            f"again")
    captured = launch.captured["slot_step_fused"]
    check(len(fused) == block == captured,
          f"profile: one replay of the {what} graph ran {len(fused)} "
          f"bp_slot_step kernels; the graph holds {block} slots and "
          f"captured {captured}")
    per_slot = len(dev_events) / block
    dev_us = sum(e.device_time for e in dev_events) / block
    fused_us = sum(e.device_time for e in fused) / block
    kinds = {}
    for e in dev_events:
        kinds[e.name] = kinds.get(e.name, 0) + 1
    top_kinds = sorted(kinds.items(), key=lambda kv: -kv[1])[:8]
    log(f"profile: one replay of the {what} {block}-slot graph at "
        f"B={launch.batch}: {len(fused)} bp_slot_step kernels (= slots in "
        f"the graph), {per_slot:.2f} CUDA device activities per slot, "
        f"{dev_us:.2f} us of device time per slot; the fused slot step "
        f"{fused_us:.2f} us per slot, {fused_us / dev_us:.4f} of the device "
        f"time; most frequent: "
        + "; ".join(f"{n[:60]} x{c / block:.2f}" for n, c in top_kinds))
    return per_slot, dev_us


def phase_profile(dev):
    """`profile_graph` on the main path's launcher, after `phase_main`."""
    from repro_torch.fleet import engine
    _, inp = main_batch(dev)
    return profile_graph(engine.launch_for(main_runner(), inp),
                         "main path's")[0]


def phase_graph_parity(dev, res, wall_graphed: float):
    """The main path's 1,512 sims through the eager `chunk_step` loop
    (`run_fleet`'s loop without the launcher), then the graphed `run_fleet`
    again with its graph already captured: every metric and verdict of
    both graphed runs bit-identical to the eager run's; ms per batched
    slot and us per sim-slot of each, in this call."""
    import torch
    from repro_torch.core.queues import VERDICT_UNDECIDED
    from repro_torch.fleet import PadDims, run_fleet
    jobs, inp = main_batch(dev)
    runner = main_runner()
    carry = runner.init_carry(inp.pp)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    launched = 0
    while launched < runner.n_chunks:
        runner.chunk_step(inp, carry)
        launched += 1
        if launched < runner.n_chunks and bool(
                (carry.drift.verdict != VERDICT_UNDECIDED).all()):
            break
    torch.cuda.synchronize()
    wall_eager = time.perf_counter() - t0
    out = {k: v.cpu().numpy() for k, v in
           runner.finalize(inp, carry).items()}
    eager = [{k: float(v[j]) for k, v in out.items()}
             for j in range(len(jobs))]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run_fleet(jobs, T=T_MAIN, chunk=CHUNK_MAIN, device=dev,
                     dims=PadDims(N_MAIN, E_MAIN, NC_MAIN), early_stop=True)
    torch.cuda.synchronize()
    wall_warm = time.perf_counter() - t0
    slots = launched * runner.chunk
    check(slots == res.slot_steps == warm.slot_steps,
          f"graph parity: eager ran {slots} slots, graphed "
          f"{res.slot_steps} and {warm.slot_steps}")
    for name, got in (("graphed", res.metrics), ("graphed again",
                                                  warm.metrics)):
        differ = [i for i in range(len(jobs)) if got[i] != eager[i]]
        check(not differ, f"graph parity: {len(differ)} sims of the "
              f"{name} run differ from the eager run, first "
              f"{jobs[differ[0]] if differ else None}")
    check(warm.n_step_compiles == 1, "graph parity: the second graphed run "
          "captured again")
    n = len(jobs)
    times = {"graphed (capture included)": wall_graphed,
             "graphed, captured before": wall_warm, "eager": wall_eager}
    log(f"graph parity: {n} sims x {slots} slots, the graphed run_fleet "
        f"(twice) bit-identical to the eager chunk_step loop in every "
        f"metric and verdict; " + "; ".join(
            f"{k} {w:.3f} s, {w / slots * 1e3:.4f} ms per batched slot, "
            f"{w / (slots * n) * 1e6:.4f} us per sim-slot"
            for k, w in times.items())
        + f"; eager / graphed {wall_eager / wall_warm:.2f}x ({card_line()})")
    return {k: w / slots * 1e3 for k, w in times.items()}


# ---------------------------------------------------------------------------
# Phase 4: determinism and lane independence; Phase 5: wireless
# ---------------------------------------------------------------------------

def phase_determinism(dev, main_res, jobs):
    from repro_torch.fleet import PadDims, run_fleet
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    picks = list(range(0, len(jobs), len(jobs) // 64))[:64]
    sub = [jobs[i] for i in picks]
    kw = dict(T=T_MAIN, chunk=CHUNK_MAIN, device=dev, dims=dims,
              early_stop=True)
    a = run_fleet(sub, **kw)
    b = run_fleet(sub, **kw)
    check(a.metrics == b.metrics, "a repeated 64-sim run differs")
    k = 37
    alone = run_fleet([sub[k]], **kw)
    check(alone.metrics[0] == a.metrics[k],
          f"job {sub[k]} alone differs from the same job in a batch of 64: "
          f"{alone.metrics[0]} vs {a.metrics[k]}")
    same_main = sum(a.metrics[i] == main_res.metrics[p]
                    for i, p in enumerate(picks))
    check(same_main == len(picks),
          f"only {same_main}/{len(picks)} subset sims equal their lane in "
          f"the 1,512-sim run")
    log(f"determinism: 64-sim subset repeated bit-identical; one job alone "
        f"== in batch of 64; {same_main}/64 equal to the 1,512-sim run")



def on_device(x, dev):
    """A copy of a tree of frozen dataclasses with every tensor on ``dev``."""
    import dataclasses
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: on_device(getattr(x, f.name), dev)
            for f in dataclasses.fields(x)})
    return x


#: Kahan compensation leaf -> the running sum it compensates.
COMPENSATION = {"c_queue": "sum_queue", "c_q3": "sum_queue_q3",
                "c_q4": "sum_queue_q4", "delivered_c": "delivered",
                "delivered_useful_c": "delivered_useful"}
#: NetState leaves whose largest magnitude sets a sim's rounding scale.
SCALE_LEAVES = ("Q", "Ddum", "X", "Y", "H", "cum_arr", "cum_comb",
                "delivered", "delivered_useful")


def named_leaves(x, name: str = "") -> dict:
    """The tensors of a tree of dataclasses by field name (the names of a
    runner's carry are unique)."""
    import dataclasses
    if not dataclasses.is_dataclass(x):
        return {name: x}
    out = {}
    for f in dataclasses.fields(x):
        out.update(named_leaves(getattr(x, f.name), f.name))
    return out


def carry_diff(a, b):
    """How far carry ``a`` lies from carry ``b``, leaf by leaf.

    A float leaf's difference is taken over the magnitude it was computed
    at: the larger of its own and the sim's largest state value (at least
    1), since the pairs P = min(cum_arr) - cum_comb round at the scale of
    the cumulative counters.  A Kahan sum is compared as its compensated
    value (sum - c); the compensation term alone is a rounding residue and
    takes whatever value the rounding left.  Returns ({leaf: scaled
    difference}, {leaf: plain difference, relative or absolute below 1, of
    every raw leaf}, whether every non-float leaf is equal)."""
    import torch
    xa, xb = named_leaves(on_device(a, "cpu")), named_leaves(b)
    B = xb["Q"].shape[0]
    scale = torch.stack([xb[k].reshape(B, -1).abs().amax(1)
                         for k in SCALE_LEAVES]).amax(0).double().clamp(min=1)
    sums = {v: k for k, v in COMPENSATION.items()}
    scaled, plain, same = {}, {}, True
    for k, y in xb.items():
        x = xa[k]
        if not y.dtype.is_floating_point:
            same = same and torch.equal(x, y)
            continue
        if y.numel() == 0:
            continue
        plain[k] = float(((x.double() - y.double()).abs()
                          / y.double().abs().clamp(min=1.0)).max())
        if k in COMPENSATION:
            continue
        x, y = x.double(), y.double()
        if k in sums:
            x = x - xa[sums[k]].double()
            y = y - xb[sums[k]].double()
        s = torch.maximum(y.abs(), scale.view(-1, *[1] * (y.dim() - 1)))
        scaled[k] = float(((x - y).abs() / s).max())
    return scaled, plain, same


def top(d: dict, n: int = 3) -> str:
    return ", ".join(f"{k} {v:.3e}" for k, v in
                     sorted(d.items(), key=lambda kv: -kv[1])[:n])


def random_state(rng, B: int, N: int, NC: int):
    """A feasible random queue state of B sims on the CPU (dummy content
    below the processed queue), as the port's policy tests make one."""
    import numpy as np
    from repro_torch.convert import net_state_from_numpy
    Q = (rng.random((B, N, 3, NC)) * 6).astype(np.float32)
    Q[rng.random(Q.shape) < 0.3] = 0.0
    return net_state_from_numpy(dict(
        Q=Q, Ddum=(Q[:, :, 0] * rng.random((B, N, NC)) * 0.5),
        X=rng.random((B, NC, 2)) * 4, Y=rng.random((B, NC)) * 2,
        H=rng.random((B, NC)) * 3, cum_arr=10 + rng.random((B, NC, 2)) * 5,
        cum_comb=rng.random((B, NC)) * 8, delivered=np.full(B, 50.0),
        delivered_useful=np.full(B, 45.0), delivered_c=np.zeros(B),
        delivered_useful_c=np.zeros(B)), "cpu")


def phase_reference(dev):
    """The card against the port's plain path on the CPU (the slot step's
    plain version, in-order scatters), over REF_SLOTS slots of the runner
    for all 1,512 sims of the main batch, from one random state, with the
    engine's counter-based noise (the same on both devices).  On the card
    the runner's slot step is the fused kernel.

    Teacher-forced: at every slot the card and the CPU step the same carry,
    the CPU's.  Their decisions then come from the same inputs through
    kernels that decide as their plain versions (phase 2,
    `phase_slot_step`), so the two new carries may differ only by the
    rounding of sums that run in another order on the card (the fused
    kernel's reductions, the engine's statistics): every non-float leaf
    equal, every float leaf within 1e-5 as `carry_diff` scales it, at every
    slot.

    Free-running: the card also steps its own carry alongside.  Reported,
    not gated: the first slot at which it parts from the CPU's by more than
    1e-3, and how far apart the two were the slot before.  Rounding-sized
    before and decision-sized after means that slot's flip was a near-tie
    met with rounding-different inputs, not different dynamics."""
    import numpy as np
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.fleet import engine
    t0 = time.perf_counter()
    jobs, inp = main_batch("cpu")
    state0 = random_state(np.random.default_rng(0), len(jobs), N_MAIN,
                          NC_MAIN)
    runner = engine.make_stream_runner(
        PolicyConfig(name="pi3_reg", eps_b=EPS_B), T=T_MAIN,
        chunk=CHUNK_MAIN, verdict=engine.resolve_verdict(None, True))
    carry = runner.init_carry(inp.pp)
    carry = engine.Carry(state0, carry.stats, carry.drift, carry.mod,
                         carry.t)
    inp_dev = on_device(inp, dev)
    free = on_device(carry, dev)
    worst_leaf, plain_leaf = {}, {}
    parted, before = None, 0.0
    for t in range(REF_SLOTS):
        forced = runner.slot(inp_dev, on_device(carry, dev))
        free = runner.slot(inp_dev, free)
        carry = runner.slot(inp, carry)
        scaled, plain, same = carry_diff(forced, carry)
        check(same and max(scaled.values()) <= 1e-5,
              f"slot {t}: card vs CPU from the same carry: non-float leaves "
              f"equal {same}; largest scaled differences {top(scaled)}; "
              f"plain {top(plain)}")
        for k, v in scaled.items():
            worst_leaf[k] = max(worst_leaf.get(k, 0.0), v)
        for k, v in plain.items():
            plain_leaf[k] = max(plain_leaf.get(k, 0.0), v)
        apart = max(carry_diff(free, carry)[0].values())
        if parted is None and apart > 1e-3:
            parted = (t, apart)
        elif parted is None:
            before = apart
    free_note = (f"parted at slot {parted[0]} by {parted[1]:.3e} after "
                 f"{before:.3e} the slot before" if parted else
                 f"within {before:.3e} of the CPU's throughout")
    log(f"reference: {REF_SLOTS} slots x {len(jobs)} sims, card vs the "
        f"port's CPU path from one random state, "
        f"{time.perf_counter() - t0:.1f} s: "
        f"teacher-forced, non-float leaves equal and scaled differences "
        f"at most {max(worst_leaf.values()):.3e} ({top(worst_leaf)}; "
        f"plain per-leaf differences {top(plain_leaf)}); free-running, "
        f"the card's carry {free_note}")


def phase_wireless(dev):
    import numpy as np
    import torch
    from repro_torch.fleet import FleetJob, policy_bound_exact, run_fleet
    bound = policy_bound_exact("wireless_grid", "pi3", EPS_B)
    jobs = [FleetJob("wireless_grid", "pi3", lam=f * bound, seed=s,
                     eps_b=EPS_B) for f in (0.3, 0.6) for s in (0, 1, 2)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_fleet(jobs, T=512, chunk=128, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    useful = res.column("useful_rate")
    check(bool(np.isfinite(useful).all()), "wireless: non-finite metrics")
    check(bool((useful <= LP_TOL * bound).all()),
          f"wireless: useful {useful} above bound {bound}")
    check(bool((res.column("delivered_useful") > 0).all()),
          "wireless: nothing delivered")
    log(f"wireless: 6 sims x 512 slots in {wall:.3f} s "
        f"({wall / res.slot_steps * 1e3:.4f} ms per batched slot), useful "
        f"rates {np.round(useful, 3)} vs bound {bound:.3f}")


# ---------------------------------------------------------------------------
# Phase 5c: the λ_max frontier; Phase 5d: the capacity atlas
# ---------------------------------------------------------------------------

def reference_numbers(name: str) -> dict:
    """The JAX package's committed results (a JSON file of the checkout;
    nothing is imported), printed beside the port's."""
    path = ROOT / name
    return json.loads(path.read_text()) if path.is_file() else {}


def frontier_kw(dev) -> dict:
    """`find_lambda_max`'s arguments at FRONTIER_SMOKE."""
    return dict(eps_b=FRONTIER["eps_b"], seeds=FRONTIER["seeds"],
                T=FRONTIER["T"], chunk=FRONTIER["chunk"],
                rel_tol=FRONTIER["rel_tol"], device=dev)


def phase_frontier(dev):
    """benchmarks/bench_fleet.py's FRONTIER_SMOKE through the port's
    `find_lambda_max`: paper_grid under pi3 and pi3_reg.  Gates (that
    file's): lam_max / bound_exact in [0.90, 1.0] for each search, slots
    saved >= 0.30 of the full slots over both, one capture per search; and
    the fused slot step launched once per batched slot the searches ran
    (n_calls x T less the chunks early stop skipped)."""
    import torch
    from repro_torch.fleet import find_lambda_max
    from repro_torch.kernels.bp_slot import kernel as K
    ref = reference_numbers("BENCH_baseline.json").get("frontier", {})
    reset_fused_counts(K)
    saved = full = slots = 0
    out = []
    results = {}
    for scenario, policy in FRONTIER["targets"]:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = find_lambda_max(scenario, policy, **frontier_kw(dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        results[(scenario, policy)] = (r, wall)
        lo, hi = FRONTIER_RATIO_BAND
        check(lo <= r.ratio <= hi, f"frontier {scenario}/{policy}: "
              f"lam_max / bound {r.ratio} outside [{lo}, {hi}]")
        check(r.n_step_compiles == 1, f"frontier {scenario}/{policy}: "
              f"{r.n_step_compiles} captures")
        saved += r.slots_saved
        full += r.full_slots
        S = len(FRONTIER["seeds"])
        slots += r.n_calls * FRONTIER["T"] - r.launch_slots_saved // S
        j = ref.get("targets", {}).get(f"{scenario}/{policy}", {})
        out.append(f"{scenario}/{policy}: lam_max {r.lam_max:.4f} of bound "
                   f"{r.bound_exact:.4f} (ratio {r.ratio:.4f}; the "
                   f"reference {j.get('lam_max', float('nan')):.4f} of "
                   f"{j.get('bound_exact', float('nan')):.4f}), "
                   f"{r.n_calls} calls ({j.get('n_calls')}), {r.n_iters} "
                   f"halvings, slots saved {r.slots_saved_frac:.4f} "
                   f"({j.get('slots_saved_frac', float('nan')):.4f}), "
                   f"{r.n_step_compiles} capture, {wall:.3f} s "
                   f"(the reference's CPU run: {j.get('wall_s', 0):.1f} s), "
                   f"probes {[(p.rate_index, p.verdicts) for p in r.probes]}")
    check(saved >= FRONTIER_MIN_SAVED_FRAC * full,
          f"frontier: slots saved {saved} of {full} < "
          f"{FRONTIER_MIN_SAVED_FRAC}")
    fused = fused_launches(K)
    check(fused["launched"] == slots > 0 and fused["replayed"] > 0,
          f"frontier: fused launches {fused} != batched slots run {slots}")
    log("frontier: " + "; ".join(out) + f"; slots saved {saved} of {full} "
        f"({saved / full:.4f}); fused launches {fused} = batched slots; "
        f"{card_line()}")
    return fused["launched"], results


def phase_atlas(dev):
    """benchmarks/bench_atlas.py's ATLAS_SWEEP through the port's
    `sweep_lambda_max`, held to that file's gates: every cell's ratio <=
    1 + 1e-9; every cell with lam_max 0 used all its re-queues; each banded
    family's median ratio in [0.90, 1.0 + 1e-9] and its q10-q90 band at
    most 0.2 wide; >= 500 cells, >= 1,500 lanes, >= 2 buckets, <= 8
    programs, each captured once; launches within their budgets (<= 450,
    <= 200 per bucket, summing to the total) and >= 10x fewer than the
    sequential searches'; and the fused slot step launched once per
    batched slot."""
    import torch
    from repro_torch.fleet import atlas_table, registry_cells, \
        sweep_lambda_max
    from repro_torch.kernels.bp_slot import kernel as K
    ref = reference_numbers("BENCH_atlas.json").get("atlas", {})
    c = dict(ATLAS)
    cells = registry_cells(c.pop("families"), c.pop("topo_seeds"),
                           policy=c.pop("policy"), eps_b=c.pop("eps_b"))
    reset_fused_counts(K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = sweep_lambda_max(cells, device=dev, **c)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    table = atlas_table(res)
    lo, hi = ATLAS_RATIO_BAND
    for fam, row in table["families"].items():
        for cell in row["cells"]:
            check(cell["ratio"] <= 1.0 + 1e-9,
                  f"atlas {fam}/ts{cell['topo_seed']}: lam_max "
                  f"{cell['lam_max']} above the bound {cell['bound_exact']}")
            check(cell["lam_max"] > 0.0 or
                  cell["n_requeues"] == c["max_requeues"],
                  f"atlas {fam}/ts{cell['topo_seed']}: collapsed bracket "
                  f"with {cell['n_requeues']} re-queues")
    for fam in ATLAS_BAND_FAMILIES:
        row = table["families"][fam]
        med, width = row["ratio_median"], row["band"]["width"]
        check(lo <= med <= hi + 1e-9,
              f"atlas {fam}: median ratio {med} outside [{lo}, {hi}]")
        check(width <= ATLAS_MAX_BAND_WIDTH + 1e-9,
              f"atlas {fam}: band width {width} > {ATLAS_MAX_BAND_WIDTH}")
    g = ATLAS_GATES
    check(res.n_cells >= g["min_cells"] and res.n_lanes >= g["min_lanes"],
          f"atlas: {res.n_cells} cells, {res.n_lanes} lanes")
    check(res.n_buckets >= 2 and res.n_programs <= 8,
          f"atlas: {res.n_buckets} buckets, {res.n_programs} programs")
    check(res.n_step_compiles == res.n_programs,
          f"atlas: {res.n_step_compiles} captures for {res.n_programs} "
          f"programs")
    check(sum(res.bucket_launches.values()) == res.n_launches and
          res.n_launches <= g["max_launches"] and
          max(res.bucket_launches.values()) <= g["max_bucket_launches"],
          f"atlas: launches {res.n_launches} by bucket "
          f"{res.bucket_launches}")
    check(res.launch_speedup >= g["min_speedup"],
          f"atlas: launch speedup {res.launch_speedup:.1f}")
    fused = fused_launches(K)
    check(fused["launched"] == res.slot_steps > 0 and fused["replayed"] > 0,
          f"atlas: fused launches {fused} != batched slots {res.slot_steps}")
    ref_fam = ref.get("families", {})
    meds = {f: (round(row["ratio_median"], 4),
                round(ref_fam.get(f, {}).get("ratio_median", float("nan")),
                      4))
            for f, row in table["families"].items()}
    log(f"atlas ({ATLAS_PRESET}): {res.n_cells} cells, {res.n_lanes} lanes, "
        f"{res.n_buckets} buckets {[(d.n_nodes, d.n_edges, d.n_comp) for d in res.bucket_dims]}, "
        f"{res.n_programs} programs, {res.n_step_compiles} captures, "
        f"{res.n_launches} chunk launches (the reference "
        f"{ref.get('n_launches')}) by bucket {res.bucket_launches}, "
        f"{res.n_requeues} re-queues ({ref.get('n_requeues')}), "
        f"{res.n_rewrites} rewrites, launch speedup "
        f"{res.launch_speedup:.2f}x; {res.slot_steps} batched slots in "
        f"{wall:.3f} s ({wall / res.slot_steps * 1e3:.4f} ms per batched "
        f"slot, {wall / res.total_slots * 1e6:.4f} us per lane-slot; the "
        f"reference's CPU run {ref.get('wall_s', 0):.1f} s); fused launches "
        f"{fused}; {card_line()}")
    log("atlas: median lam_max / bound by family, the port's and the "
        "reference's " + json.dumps(meds))
    log("atlas: q10-q90 bands " + json.dumps(
        {f: [round(row["band"]["q10"], 4), round(row["band"]["q90"], 4)]
         for f, row in table["families"].items()}) + "; undecided at the "
        "top / re-queued " + json.dumps(
            {f: [row["n_undecided_hi"], row["n_requeued"]]
             for f, row in table["families"].items()}))
    return fused["launched"], wall


# ---------------------------------------------------------------------------
# Phase 5c: serving with admission control, and the telemetry streams
# ---------------------------------------------------------------------------

def serving_jobs(trace: str = SERVING_TRACE):
    """The main path's 1,512 (family, topo_seed, rate, seed) jobs as
    serving jobs facing ``trace``, and their (bound, frac)."""
    from repro_torch.serving import ServingJob
    jobs, bounds = main_jobs()
    return [ServingJob(scenario=j.scenario, policy=j.policy, trace=trace,
                       lam=j.lam, seed=j.seed, topo_seed=j.topo_seed,
                       eps_b=j.eps_b) for j in jobs], bounds


def differing(a, b) -> list:
    """Indices of the jobs whose metrics differ in any leaf, any bit."""
    return [i for i, (x, y) in enumerate(zip(a, b)) if x != y]


def serving_finite(res) -> bool:
    import numpy as np
    return all(np.isfinite(np.asarray(res.column(k), np.float64)).all()
               for k in res.metrics[0])


def phase_serving_smoke(dev):
    """benchmarks/bench_serving.py's SERVING_SMOKE through the port's
    `serving_report`, nothing cut, stream on, held to that file's gates:
    at 0.95x the bound delivered / bound >= 0.9, shed <= 0.02, p99 <= 512
    slots; at 1.3x shed >= 0.10 and the admitted rate <= 1.05 x the bound.
    One stream record per chunk, valid under the port's schema; the fused
    slot step launched once per batched slot, one capture.  The
    reference's committed rows (BENCH_baseline.json) print beside."""
    import torch
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.obs import schema
    from repro_torch.serving import serving_report
    ref = reference_numbers("BENCH_baseline.json").get("serving", {})
    reset_fused_counts(K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = serving_report(**SERVING_SMOKE, stream=True, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    res, bound = rep["result"], rep["bound_exact"]
    nom, over = rep["rows"]["0.95"], rep["rows"][f"{SERVING_OVERLOAD_FRAC:g}"]
    check(nom["delivered_over_bound"] >= SERVING_MIN_RATIO,
          f"serving smoke: 0.95-load delivered / bound "
          f"{nom['delivered_over_bound']:.4f} < {SERVING_MIN_RATIO}")
    check(nom["shed_frac_max"] <= SERVING_MAX_SHED,
          f"serving smoke: 0.95-load shed {nom['shed_frac_max']:.4f}")
    check(nom["p99_sojourn_max"] <= SERVING_P99_MAX,
          f"serving smoke: 0.95-load p99 {nom['p99_sojourn_max']} slots")
    check(over["shed_frac"] >= SERVING_OVERLOAD_MIN_SHED,
          f"serving smoke: {SERVING_OVERLOAD_FRAC}x shed "
          f"{over['shed_frac']:.4f} < {SERVING_OVERLOAD_MIN_SHED}")
    check(over["admitted_rate"] <= bound * SERVING_OVERLOAD_RATE_SLACK,
          f"serving smoke: admitted rate {over['admitted_rate']:.4f} > "
          f"{SERVING_OVERLOAD_RATE_SLACK} x bound {bound}")
    recs = res.stream_records
    errs = schema.validate_stream(recs)
    check(len(recs) == res.T // SERVING_SMOKE["chunk"] and not errs,
          f"serving smoke: {len(recs)} stream records, errors {errs[:3]}")
    fused = fused_launches(K)
    check(fused["launched"] == res.slot_steps > 0 and fused["replayed"] > 0
          and res.n_step_compiles == 1,
          f"serving smoke: fused launches {fused} for {res.slot_steps} "
          f"batched slots, {res.n_step_compiles} captures")
    keys = ("delivered_over_bound", "shed_frac", "p99_sojourn",
            "p99_sojourn_max", "admitted_rate", "gate_open_frac",
            "gate_flips")
    rows = {f: {k: (round(r[k], 4), ref.get("rows", {}).get(f, {}).get(k))
                for k in keys} for f, r in rep["rows"].items()}
    log(f"serving smoke (SERVING_SMOKE: paper_grid, pi3_reg, bursty, "
        f"bound {bound}, T={res.T}, chunk {SERVING_SMOKE['chunk']}, "
        f"{res.n_sims} lanes): gates pass; {len(recs)} stream records; "
        f"{wall:.3f} s (capture included); fused launches {fused}; rows, "
        f"(the port's, the reference's committed) " + json.dumps(rows))
    return fused["launched"]


def phase_serving(dev):
    """The serving path at full width: the main path's 1,512 jobs (8
    families x topo_seeds 0-20 x fracs (0.5, 0.95, 1.3) x seeds 0-2, padded
    to the hull (16, 51, 4)) facing `bursty_mix`, pi3_reg, T=4096,
    chunk=512, streamed to a JSONL file through ``stream_path``.  Gates:
    one group and one capture; fused slot-step launches (eager + replayed)
    = slots advanced, B1/B2 never alone; every metric finite; no lane's
    delivered QPS above 1.02 x its bound; at 1.3x every lane that sheds
    more than 0.1 keeps its classes' admitted shares within 0.05; gate
    flips <= windows / 2; the stream file valid with one record per chunk.
    Then the run twice more, stream off and on (graph captured before):
    metrics bit-identical, ms per batched slot of each; per-family medians
    of delivered / bound, shed and p99 at each rate; one traced replay."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.fleet import PadDims, engine
    from repro_torch.fleet.scenarios import event_code, get_scenario
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.obs import schema
    from repro_torch.serving import get_trace, make_serving_runner, \
        run_serving
    jobs, bounds = serving_jobs()
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    kw = dict(T=T_MAIN, chunk=CHUNK_MAIN, device=dev, dims=dims)
    with tempfile.TemporaryDirectory() as tmp:
        path = str(pathlib.Path(tmp) / "SERVING_stream.jsonl")
        K.slot_route_decide.launches = 0
        K.comp_balance_decide.launches = 0
        reset_fused_counts(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = run_serving(jobs, stream_path=path, **kw)
        torch.cuda.synchronize()
        walls = {"stream on, capture included": time.perf_counter() - t0}
        fused = fused_launches(K)
        b12 = (K.slot_route_decide.launches, K.comp_balance_decide.launches)
        on_file = schema.read_stream_jsonl(path)
    check(res.n_programs == 1 and res.n_step_compiles == 1,
          f"serving: {res.n_programs} groups, {res.n_step_compiles} "
          f"captures")
    check(fused["launched"] == res.slot_steps > 0 and fused["replayed"] > 0,
          f"serving: fused launches {fused} != slots {res.slot_steps}")
    check(b12 == (0, 0), f"serving: B1/B2 launched on their own: {b12}")
    check(serving_finite(res), "serving: non-finite metrics")
    bound = np.array([b for b, _ in bounds])
    frac = np.array([f for _, f in bounds])
    dq = res.column("delivered_qps")
    over = np.flatnonzero(dq > LP_TOL * bound)
    check(not over.size, f"serving: {over.size} lanes above {LP_TOL} x "
          f"bound, first {[jobs[i] for i in over[:3]]}")
    shed = res.column("shed_frac")
    cf = np.array([m["class_admit_frac"] for m in res.metrics])
    shedding = np.flatnonzero((frac == SERVING_OVERLOAD_FRAC)
                              & (shed > FAIR_SHED))
    gaps = np.abs(cf[shedding, 0] - cf[shedding, 1])
    check(shedding.size > 0 and (gaps < FAIR_GAP).all(),
          f"serving: {shedding.size} shedding lanes at "
          f"{SERVING_OVERLOAD_FRAC}x, class gap max "
          f"{gaps.max() if gaps.size else None}")
    n_windows = res.T // CHUNK_MAIN
    flips = res.column("gate_flips")
    check(flips.max() <= n_windows // 2,
          f"serving: {flips.max()} gate flips > {n_windows // 2}")
    errs = schema.validate_stream(on_file)
    check(on_file == res.stream_records and len(on_file) == n_windows
          and not errs, f"serving: stream file of {len(on_file)} records "
          f"(in memory {len(res.stream_records)}), errors {errs[:3]}")
    for name, stream in (("stream off", False), ("stream on", True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        again = run_serving(jobs, stream=stream, **kw)
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        diff = differing(again.metrics, res.metrics)
        check(not diff and again.n_step_compiles == 1,
              f"serving, {name}: {len(diff)} lanes differ from the first "
              f"run, {again.n_step_compiles} captures")
    slots = res.slot_steps
    cost = walls["stream on"] / walls["stream off"] - 1.0
    by_family = {}
    p99 = res.column("p99_sojourn")
    for fam in FAMILIES:
        for f in RATE_FRACS:
            idx = [i for i, j in enumerate(jobs)
                   if j.scenario == fam and frac[i] == f]
            by_family[f"{fam}@{f}"] = [
                round(float(np.median(dq[idx] / bound[idx])), 4),
                round(float(np.median(shed[idx])), 4),
                float(np.median(p99[idx]))]
    log(f"serving: {len(jobs)} lanes ({SERVING_TRACE}, pi3_reg), T={res.T},"
        f" chunk {CHUNK_MAIN}, dims {dims}, {slots} slots, fused launches "
        f"{fused}, 1 capture; {shedding.size} lanes shed > {FAIR_SHED} at "
        f"{SERVING_OVERLOAD_FRAC}x, class-share gap max "
        f"{float(gaps.max()):.4f}; gate flips max {flips.max():.0f}; "
        + "; ".join(f"{k} {w:.3f} s, {w / slots * 1e3:.4f} ms per batched "
                    f"slot" for k, w in walls.items())
        + f"; the stream costs {cost:+.4f} of the stream-off wall time "
        f"({card_line()})")
    log("serving: per family@rate, median [delivered / bound, shed, p99 "
        "slots] " + json.dumps(by_family))
    runner = make_serving_runner(jobs[0].policy_config(),
                                 get_trace(SERVING_TRACE), T_MAIN,
                                 chunk=CHUNK_MAIN)
    codes = tuple(sorted({event_code(get_scenario(j.scenario).events)
                          for j in jobs}))
    launch = engine.make_group_launch(
        runner, len(jobs), dims,
        torch.device("cuda", torch.cuda.current_device()), codes)
    profile_graph(launch, f"serving path's ({SERVING_TRACE})")
    return fused["launched"], walls, res


def phase_serving_parity(dev):
    """A 64-lane subset of `phase_serving`'s jobs four ways: graphed
    (`run_serving`) and through the eager `chunk_step` loop, each with the
    stream off and on: every metric bit-identical, and the eager stream's
    records equal to the graphed stream's.  A `diurnal_mix` run of the
    same lanes (the in-slot Poisson CDF): finite, the lanes' median
    offered rate ((admitted + shed) / T) within 2% of lam.  The outage
    check of tests/test_serving.py:310-331 on the card: outage_grid,
    bursty, 0.95x, seeds (0, 1), T=4096, chunk=256: shed > 0.05, the gate
    reopened, >= 2 flips, every record after t=3072 at qps_med >= 0.9 x
    the bound."""
    import dataclasses as dc
    import numpy as np
    import torch
    from repro_torch.fleet import PadDims, policy_bound_exact
    from repro_torch.fleet.batching import from_leaves, pad_leaves
    from repro_torch.fleet.scenarios import event_code, get_scenario
    from repro_torch.obs.emitter import ChunkEmitter, StreamSink
    from repro_torch.serving import (ServingJob, get_trace,
                                     make_serving_runner, run_serving)
    from repro_torch.serving.engine import metric_rows
    all_jobs, _ = serving_jobs()
    step = len(all_jobs) // SERVING_PARITY_LANES
    jobs = all_jobs[::step][:SERVING_PARITY_LANES]
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    kw = dict(T=T_MAIN, chunk=CHUNK_MAIN, device=dev, dims=dims)
    runs, walls = {}, {}
    for stream in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = run_serving(jobs, stream=stream, **kw)
        torch.cuda.synchronize()
        walls[f"graphed, stream {'on' if stream else 'off'}"] = \
            time.perf_counter() - t0
        runs[("graphed", stream)] = (r.metrics, r.stream_records)
    runner = make_serving_runner(jobs[0].policy_config(),
                                 get_trace(SERVING_TRACE), T_MAIN,
                                 chunk=CHUNK_MAIN)
    pp = from_leaves([pad_leaves(get_scenario(j.scenario).build(
        j.topo_seed), dims) for j in jobs], dims.n_nodes, dims.n_comp, dev)
    inp = runner.make_inputs(
        pp, [j.lam for j in jobs], [j.eps_b for j in jobs],
        [event_code(get_scenario(j.scenario).events) for j in jobs],
        [j.seed for j in jobs])
    for stream in (False, True):
        carry = runner.init_carry(inp.pp)
        sink = StreamSink() if stream else None
        em = ChunkEmitter("serving", 0, len(jobs), runner, sink) \
            if stream else None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(runner.n_chunks):
            runner.chunk_step(inp, carry)
            if em is not None:
                em.emit(runner.probe(carry))
        if em is not None:
            em.close()
        torch.cuda.synchronize()
        walls[f"eager, stream {'on' if stream else 'off'}"] = \
            time.perf_counter() - t0
        runs[("eager", stream)] = (
            metric_rows(runner.finalize(inp, carry)),
            sink.records if sink is not None else [])
    base = runs[("graphed", False)][0]
    for key, (m, _) in runs.items():
        diff = differing(m, base)
        check(not diff, f"serving parity: {key} differs from graphed with "
              f"the stream off in {len(diff)} lanes, first "
              f"{jobs[diff[0]] if diff else None}")
    check(runs[("eager", True)][1] == runs[("graphed", True)][1]
          and len(runs[("graphed", True)][1]) == runner.n_chunks,
          "serving parity: the eager stream's records differ from the "
          "graphed stream's")
    slots = runner.T
    log(f"serving parity: {len(jobs)} lanes x {slots} slots, graphed and "
        f"eager, stream off and on: bit-identical metrics, equal records; "
        + "; ".join(f"{k} {w:.3f} s ({w / slots * 1e3:.4f} ms per batched "
                    f"slot)" for k, w in walls.items()))

    djobs = [dc.replace(j, trace="diurnal_mix") for j in jobs]
    d = run_serving(djobs, **kw)
    check(serving_finite(d), "diurnal_mix: non-finite metrics")
    offered = (d.column("admitted_total") + d.column("shed_total")) / d.T
    ratio = float(np.median(offered / np.array([j.lam for j in djobs])))
    check(abs(ratio - 1.0) <= DIURNAL_RATE_TOL,
          f"diurnal_mix: median offered / lam {ratio:.4f}")
    log(f"serving parity: diurnal_mix, {len(djobs)} lanes: finite; median "
        f"offered / lam {ratio:.4f} (within {DIURNAL_RATE_TOL}); "
        f"{d.n_step_compiles} capture")

    o = OUTAGE
    bound = policy_bound_exact(o["scenario"], "pi3_reg", EPS_B, 0)
    ojobs = [ServingJob(scenario=o["scenario"], trace=o["trace"],
                        lam=o["frac"] * bound, seed=s) for s in o["seeds"]]
    r = run_serving(ojobs, T=o["T"], chunk=o["chunk"], device=dev,
                    stream=True)
    tail = [x for x in r.stream_records if x["t"] > o["after_t"]]
    check(np.all(r.column("shed_frac") > 0.05)
          and np.all(r.column("gate") == 1.0)
          and np.all(r.column("gate_flips") >= 2.0),
          f"outage: shed {r.column('shed_frac')}, gate "
          f"{r.column('gate')}, flips {r.column('gate_flips')}")
    check(tail and all(x["qps_med"] >= o["qps_frac"] * bound for x in tail),
          f"outage: records after t={o['after_t']}: "
          f"{[x['qps_med'] for x in tail]} against bound {bound}")
    log(f"serving parity: outage ({o['scenario']}, bound {bound}): shed "
        f"{r.column('shed_frac').round(4).tolist()}, flips "
        f"{r.column('gate_flips').tolist()}, gate reopened; qps_med after "
        f"t={o['after_t']}: {[x['qps_med'] for x in tail]}")


def phase_stream(dev, main_res, jobs, frontier_results):
    """The telemetry plane on the fleet paths.  `run_fleet` on the main
    path's 1,512 jobs with the stream on: bit-identical to `phase_main`'s
    run, no extra capture, one fleet record per chunk launched; then with
    the stream off again, for the wall time in this call.  The frontier
    (FRONTIER_SMOKE's first target) with ``stream_log``: the same result
    as `phase_frontier`'s, valid records.  A small atlas (two families x 4
    topo_seeds, ATLAS's other settings), stream on against off: the same
    rows, launches and captures, one valid record per launch.  Returns
    the wall times and the stream-off atlas result."""
    import torch
    from repro_torch.fleet import (PadDims, find_lambda_max, run_fleet,
                                   sweep_lambda_max)
    from repro_torch.obs import schema
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    walls = {}
    runs = {}
    for stream in (True, False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[stream] = run_fleet(jobs, T=T_MAIN, chunk=CHUNK_MAIN,
                                 device=dev, dims=dims, early_stop=True,
                                 stream=stream)
        torch.cuda.synchronize()
        walls[f"fleet, stream {'on' if stream else 'off'}"] = \
            time.perf_counter() - t0
    on = runs[True]
    diff = differing(on.metrics, main_res.metrics)
    errs = schema.validate_stream(on.stream_records)
    check(not diff and not differing(runs[False].metrics, main_res.metrics),
          f"stream: {len(diff)} fleet sims differ from phase_main's run")
    check(on.n_step_compiles == 1 and
          len(on.stream_records) == on.slot_steps // CHUNK_MAIN and not errs,
          f"stream: {on.n_step_compiles} captures, "
          f"{len(on.stream_records)} records for "
          f"{on.slot_steps // CHUNK_MAIN} chunks, errors {errs[:3]}")

    target = FRONTIER["targets"][0]
    seen = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f_on = find_lambda_max(*target, **frontier_kw(dev), stream_log=seen.append)
    torch.cuda.synchronize()
    walls["frontier, stream_log on"] = time.perf_counter() - t0
    f_off, walls["frontier, stream off (phase_frontier)"] = \
        frontier_results[target]
    bad = [r for r in seen if schema.validate_record(r)]
    check(f_on == f_off and seen and not bad and
          sum(r["chunk"] == 0 for r in seen) == f_on.n_calls,
          f"stream: the frontier with stream_log differs ({len(seen)} "
          f"records, {len(bad)} invalid)")

    cells, a = stream_atlas()
    atlas = {}
    for stream in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        atlas[stream] = sweep_lambda_max(cells, device=dev, stream=stream,
                                         **a)
        torch.cuda.synchronize()
        walls[f"atlas, stream {'on' if stream else 'off'}"] = \
            time.perf_counter() - t0
    x, y = atlas[False], atlas[True]
    errs = schema.validate_stream(y.stream_records)
    check(x.rows == y.rows and (x.n_launches, x.n_step_compiles) ==
          (y.n_launches, y.n_step_compiles) and
          len(y.stream_records) == y.n_launches and not errs,
          f"stream: atlas on/off differ or records bad ({errs[:3]})")
    log(f"stream: run_fleet ({len(jobs)} sims) bit-identical with the "
        f"stream on, {len(on.stream_records)} records, 1 capture; frontier "
        f"{target} with stream_log: same result, {len(seen)} records; "
        f"atlas ({len(cells)} cells, {y.n_launches} launches): same rows, "
        f"{len(y.stream_records)} records; wall "
        + "; ".join(f"{k} {w:.3f} s" for k, w in walls.items())
        + f" ({card_line()})")
    return walls, x


def stream_atlas():
    """The small atlas of `phase_stream` and `phase_resilience`:
    STREAM_ATLAS's cells with ATLAS's other settings."""
    from repro_torch.fleet import registry_cells
    a = dict(ATLAS)
    cells = registry_cells(STREAM_ATLAS["families"],
                           STREAM_ATLAS["topo_seeds"],
                           policy=a.pop("policy"), eps_b=a.pop("eps_b"))
    for k in ("families", "topo_seeds"):
        a.pop(k)
    return cells, a


def carry_bytes(ckpt_dir) -> int:
    """Bytes of the carry in the newest step of a checkpoint directory
    that holds one (a group's end marker holds none), from its manifest's
    shapes and dtypes."""
    import numpy as np
    for step in sorted(pathlib.Path(ckpt_dir).glob("step_*"), reverse=True):
        m = json.loads((step / "manifest.json").read_text())
        if m["n_arrays"]:
            break
    return int(sum(np.dtype("uint16" if d == "bfloat16" else d).itemsize
                   * math.prod(shape)
                   for d, shape in zip(m["dtypes"], m["shapes"])))


def snapshot_ms(carry, where) -> dict:
    """Median milliseconds of SNAPSHOT_REPS `Checkpointer.save` calls of
    ``carry``: the copy to host memory, the sha256 digests and the disk
    write, each apart."""
    from repro_torch.checkpoint import Checkpointer
    ck = Checkpointer(where, keep=2)
    ms = []
    for i in range(SNAPSHOT_REPS):
        ck.save(i, carry)
        ms.append(dict(ck.last_ms))
    return {k: round(statistics.median(m[k] for m in ms), 4)
            for k in ("copy", "sha256", "write")}


def fleet_child_argv(ckpt, stream, out, go=None) -> list:
    return [sys.executable, str(ROOT / "chip_smoke.py"),
            "--resilience-child", str(ckpt), str(stream), str(out)] + \
        ([str(go)] if go is not None else [])


def resilience_child(ckpt: str, stream: str, out: str,
                     go: str | None = None) -> int:
    """The child process of `phase_resilience`'s real kill: the main
    path's fleet with a snapshot at every boundary, written on a
    background thread, streamed to ``stream``; it resumes from ``ckpt``
    when a snapshot is there.  With ``go`` it sets itself up (torch, the
    card, the jobs) and then waits for that file before it runs.  Writes
    its metrics, accounting and set-up and run seconds to ``out`` as
    JSON."""
    t0 = time.perf_counter()
    sys.path.insert(0, str(SRC))
    import torch
    from repro_torch.fleet import PadDims, run_fleet
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.runtime import ResilienceConfig
    if not torch.cuda.is_available():
        print("resilience child: no CUDA device", file=sys.stderr)
        return 1
    torch.zeros(1, device="cuda")
    jobs, _ = main_jobs()
    setup_s = time.perf_counter() - t0
    if go is not None:
        while not pathlib.Path(go).exists():
            if time.perf_counter() - t0 > CHILD_TIMEOUT_S:
                print("resilience child: no go", file=sys.stderr)
                return 1
            time.sleep(0.005)
    t1 = time.perf_counter()
    reset_fused_counts(K)
    res = run_fleet(jobs, T=T_MAIN, chunk=CHUNK_MAIN, device="cuda",
                    dims=PadDims(N_MAIN, E_MAIN, NC_MAIN), early_stop=True,
                    stream_path=stream,
                    resilience=ResilienceConfig(checkpoint_dir=ckpt,
                                                every=1, blocking=False))
    torch.cuda.synchronize()
    pathlib.Path(out).write_text(json.dumps({
        "metrics": res.metrics, "resumed_from": res.resumed_from,
        "n_step_compiles": res.n_step_compiles,
        "slots_saved": res.slots_saved,
        "launch_slots_saved": res.launch_slots_saved,
        "launched": fused_launches(K)["launched"],
        "setup_s": setup_s, "run_s": time.perf_counter() - t1}))
    return 0


def real_kill(tmp: pathlib.Path, out: dict) -> None:
    """`phase_resilience`'s real kill, run on a thread: child A runs the
    fleet until its stream holds CHILD_KILL_RECORDS chunk records and
    gets SIGKILL; child B, started beside it and set up while A runs,
    then resumes from A's checkpoints.  Fills ``out`` (``error`` on a
    failure); every child is stopped before it returns."""
    import os
    import signal
    ck, stream = tmp / "child", tmp / "FLEET_stream.jsonl"
    go = tmp / "child_go"
    t0 = time.perf_counter()
    with open(tmp / "child_a.err", "w") as ea, \
            open(tmp / "child_b.err", "w") as eb:
        a = subprocess.Popen(fleet_child_argv(ck, stream, tmp / "a.json"),
                             stdout=subprocess.DEVNULL, stderr=ea)
        b = subprocess.Popen(fleet_child_argv(ck, stream, tmp / "b.json",
                                              go),
                             stdout=subprocess.DEVNULL, stderr=eb)
        try:
            n_recs = 0
            while a.poll() is None and \
                    time.perf_counter() - t0 < CHILD_TIMEOUT_S:
                if stream.exists():
                    n_recs = stream.read_text().count('"kind": "fleet"')
                    if n_recs >= CHILD_KILL_RECORDS:
                        break
                time.sleep(0.005)
            if a.poll() is not None or n_recs < CHILD_KILL_RECORDS:
                out["error"] = (f"child A ended (rc {a.poll()}) or timed "
                                f"out with {n_recs} records before the "
                                f"kill: {(tmp / 'child_a.err').read_text()[-2000:]}")
                return
            os.kill(a.pid, signal.SIGKILL)
            a.wait(timeout=60)
            out.update(n_recs=n_recs, kill_s=time.perf_counter() - t0,
                       steps=sorted(p.name for p in ck.glob("step_*")))
            go.touch()
            rc = b.wait(timeout=CHILD_TIMEOUT_S)
            if rc != 0:
                out["error"] = (f"child B failed (rc {rc}): "
                                f"{(tmp / 'child_b.err').read_text()[-2000:]}")
                return
            out.update(json.loads((tmp / "b.json").read_text()),
                       wall_s=time.perf_counter() - t0)
        except Exception as e:          # reported by phase_resilience
            out["error"] = repr(e)
        finally:
            for c in (a, b):
                if c.poll() is None:
                    c.kill()
                    c.wait()


def phase_resilience(dev, main_res, jobs, serving_res, atlas_base):
    """Preemption-safe runs (`runtime.resilience`) at full width.

    1. The main path's 1,512 jobs with a snapshot at every boundary and a
       preemption after chunk RESILIENCE_KILL, then resumed in this
       process: every metric, slots_saved and launch_slots_saved equal to
       `phase_main`'s, resumed from that boundary, no new capture, and
       the fused launches of the killed and the resumed run summing to
       the uninterrupted run's.  The carry's bytes, ms per snapshot (the
       copy to host memory, sha256, the write) and the wall of the run
       without resilience, with a blocking snapshot per boundary and with
       a background write.
    2. `phase_serving`'s 1,512 lanes, streamed, killed at boundary
       SERVING_KILL of 8 and resumed: metrics equal to `phase_serving`'s,
       and its stream, the seam stripped, that run's byte for byte.
    3. A real kill (`real_kill`, on a thread beside items 2, 4 and 5): a
       child process runs item 1's fleet (snapshots written in the
       background) and gets SIGKILL once its stream file holds
       CHILD_KILL_RECORDS chunk records; a second child resumes from the
       newest intact step: item 1's metrics, one capture.
    4. The small atlas of `phase_stream`, killed mid-bucket and resumed:
       its rows, launches, bucket launches and re-queues; one capture per
       program in all.
    5. Faults on FAULT_LANES lanes: two injected launch failures retried
       to the same metrics; the dropout of host 0 parks every lane (one
       device), the run finishes, every job degraded, the plan a remesh.
    Returns the fused slot-step launches of the runs above."""
    import shutil
    import tempfile
    import threading
    import torch
    from repro_torch.fleet import PadDims, engine, run_fleet, \
        sweep_lambda_max
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.obs import schema
    from repro_torch.runtime import FaultPlane, Preempted, ResilienceConfig
    from repro_torch.serving import get_trace, make_serving_runner, \
        run_serving
    from repro_torch.fleet.scenarios import event_code, get_scenario
    dims = PadDims(N_MAIN, E_MAIN, NC_MAIN)
    kw = dict(T=T_MAIN, chunk=CHUNK_MAIN, device=dev, dims=dims,
              early_stop=True)
    total = 0

    def counted(fn, *a, **k):
        nonlocal total
        reset_fused_counts(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            return fn(*a, **k)
        finally:
            torch.cuda.synchronize()
            counted.wall = time.perf_counter() - t0
            counted.launched = fused_launches(K)["launched"]
            total += counted.launched

    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="resilience_"))
    killer = None
    try:
        # -- 1. the fleet, killed and resumed in this process -------------
        plain = counted(run_fleet, jobs, **kw)
        walls = {"no resilience": counted.wall}
        check(not differing(plain.metrics, main_res.metrics) and
              counted.launched == main_res.slot_steps,
              "resilience: the plain fleet run differs from phase_main's")
        captured = K.slot_step_fused.captured
        ck = tmp / "fleet"
        try:
            counted(run_fleet, jobs, **kw, resilience=ResilienceConfig(
                checkpoint_dir=str(ck), every=1,
                fault_plane=FaultPlane.preempt_after(RESILIENCE_KILL)))
            check(False, "resilience: the fleet run was not preempted")
        except Preempted:
            pass
        killed = counted.launched
        res = counted(run_fleet, jobs, **kw,
                      resilience=ResilienceConfig(checkpoint_dir=str(ck)))
        resumed = counted.launched
        diff = differing(res.metrics, main_res.metrics)
        check(not diff and res.slots_saved == main_res.slots_saved and
              res.launch_slots_saved == main_res.launch_slots_saved and
              res.resumed_from == RESILIENCE_KILL,
              f"resilience: the resumed fleet differs in {len(diff)} sims, "
              f"slots_saved {res.slots_saved} / {main_res.slots_saved}, "
              f"launch_slots_saved {res.launch_slots_saved} / "
              f"{main_res.launch_slots_saved}, from {res.resumed_from}")
        check(K.slot_step_fused.captured == captured,
              "resilience: the killed or resumed fleet captured anew")
        check(killed > 0 and resumed > 0 and
              killed + resumed == main_res.slot_steps,
              f"resilience: fused launches killed {killed} + resumed "
              f"{resumed} != {main_res.slot_steps}")
        fleet_bytes = carry_bytes(ck)
        for name, blocking in (("every=1, blocking", True),
                               ("every=1, background write", False)):
            r = counted(run_fleet, jobs, **kw, resilience=ResilienceConfig(
                checkpoint_dir=str(tmp / f"wall_{blocking}"),
                blocking=blocking))
            walls[name] = counted.wall
            check(not differing(r.metrics, main_res.metrics),
                  f"resilience: fleet with {name} differs")
        _, inp = main_batch(dev)
        fleet_snap = snapshot_ms(engine.launch_for(main_runner(), inp).carry,
                                 tmp / "snap_fleet")
        n_chunks = main_res.slot_steps // CHUNK_MAIN
        log(f"resilience: fleet ({len(jobs)} sims, {n_chunks} chunks) "
            f"killed after chunk {RESILIENCE_KILL} and resumed: every "
            f"metric bit-identical, no new capture, fused launches {killed}"
            f" + {resumed} = {main_res.slot_steps}; carry {fleet_bytes} B "
            f"per snapshot, ms per snapshot {json.dumps(fleet_snap)}; wall "
            + "; ".join(f"{k} {w:.4f} s ({w / walls['no resilience'] - 1:+.4f})"
                        for k, w in walls.items())
            + f" ({card_line()})")

        # -- 3. a real kill, on a thread beside items 2, 4 and 5 ---------
        killed_child: dict = {}
        killer = threading.Thread(target=real_kill, args=(tmp, killed_child),
                                  daemon=True)
        killer.start()

        # -- 2. serving, killed at boundary SERVING_KILL and resumed ------
        sjobs, _ = serving_jobs()
        skw = dict(T=T_MAIN, chunk=CHUNK_MAIN, device=dev, dims=dims)
        path, sck = tmp / "SERVING_stream.jsonl", tmp / "serving"
        try:
            counted(run_serving, sjobs, **skw, stream_path=str(path),
                    resilience=ResilienceConfig(
                        checkpoint_dir=str(sck),
                        fault_plane=FaultPlane.preempt_after(SERVING_KILL)))
            check(False, "resilience: the serving run was not preempted")
        except Preempted:
            pass
        s_killed = counted.launched
        s_wall = counted.wall
        sres = counted(run_serving, sjobs, **skw, stream_path=str(path),
                       resilience=ResilienceConfig(checkpoint_dir=str(sck)))
        s_wall += counted.wall
        diff = differing(sres.metrics, serving_res.metrics)
        lines = path.read_text().splitlines()
        recs = [json.loads(x) for x in lines]
        kept = [x for x, r in zip(lines, recs) if r["kind"] != "resume"]
        seams = [r for r in recs if r["kind"] == "resume"]
        check(not diff and sres.resumed_from == SERVING_KILL,
              f"resilience: resumed serving differs in {len(diff)} lanes")
        check(kept == [schema.jsonl_line(r)
                       for r in serving_res.stream_records]
              and len(seams) == 1 and not schema.validate_stream(recs),
              "resilience: the resumed serving stream, seam stripped, is "
              "not phase_serving's")
        check(s_killed + counted.launched == serving_res.slot_steps,
              f"resilience: serving fused launches {s_killed} + "
              f"{counted.launched} != {serving_res.slot_steps}")
        serving_bytes = carry_bytes(sck)
        runner = make_serving_runner(sjobs[0].policy_config(),
                                     get_trace(SERVING_TRACE), T_MAIN,
                                     chunk=CHUNK_MAIN)
        codes = tuple(sorted({event_code(get_scenario(j.scenario).events)
                              for j in sjobs}))
        slaunch = engine.make_group_launch(
            runner, len(sjobs), dims,
            torch.device("cuda", torch.cuda.current_device()), codes)
        serving_snap = snapshot_ms(slaunch.carry, tmp / "snap_serving")
        log(f"resilience: serving ({len(sjobs)} lanes, {SERVING_TRACE}) "
            f"killed at boundary {SERVING_KILL} of {sres.T // CHUNK_MAIN} "
            f"and resumed: metrics bit-identical, the stream (seam "
            f"stripped) byte-identical, {len(recs)} records with the seam;"
            f" {s_wall:.3f} s both runs; carry {serving_bytes} B per "
            f"snapshot, ms per snapshot {json.dumps(serving_snap)}")

        # -- 4. the small atlas, killed mid-bucket and resumed -------------
        cells, a = stream_atlas()
        b0 = min(b for b, n in atlas_base.bucket_launches.items() if n)
        kill = max(1, atlas_base.bucket_launches[b0] // 2)
        ack = tmp / "atlas"
        captured = K.slot_step_fused.captured
        try:
            counted(sweep_lambda_max, cells, device=dev, **a,
                    resilience=ResilienceConfig(
                        checkpoint_dir=str(ack),
                        fault_plane=FaultPlane.preempt_after(kill)))
            check(False, "resilience: the atlas was not preempted")
        except Preempted:
            pass
        a_wall = counted.wall
        ares = counted(sweep_lambda_max, cells, device=dev, **a,
                       resilience=ResilienceConfig(checkpoint_dir=str(ack)))
        a_wall += counted.wall
        check(ares.rows == atlas_base.rows and
              ares.n_launches == atlas_base.n_launches and
              ares.bucket_launches == atlas_base.bucket_launches and
              ares.n_requeues == atlas_base.n_requeues and
              ares.resumed_from == kill,
              f"resilience: the resumed atlas differs (launches "
              f"{ares.n_launches} / {atlas_base.n_launches}, buckets "
              f"{ares.bucket_launches} / {atlas_base.bucket_launches})")
        check(ares.n_step_compiles == ares.n_programs and
              K.slot_step_fused.captured == captured,
              f"resilience: atlas {ares.n_step_compiles} captures for "
              f"{ares.n_programs} programs, or captured anew")
        log(f"resilience: atlas ({len(cells)} cells, {ares.n_launches} "
            f"launches, buckets {ares.bucket_launches}) killed after launch"
            f" {kill} (mid-bucket {b0}) and resumed: rows, launches and "
            f"re-queues equal, {ares.n_step_compiles} captures for "
            f"{ares.n_programs} programs; {a_wall:.3f} s both runs")

        # -- 5. faults --------------------------------------------------
        fjobs = jobs[::len(jobs) // FAULT_LANES][:FAULT_LANES]
        fbase = counted(run_fleet, fjobs, **kw)
        fail = counted(run_fleet, fjobs, **kw, resilience=ResilienceConfig(
            fault_plane=FaultPlane.launch_fail(at_launch=1, fails=2)))
        check(not differing(fail.metrics, fbase.metrics) and
              fail.n_fault_retries == 2 and fail.degraded == {},
              f"resilience: the retried run differs or retried "
              f"{fail.n_fault_retries} times")
        drop = counted(run_fleet, fjobs, **kw, resilience=ResilienceConfig(
            fault_plane=FaultPlane.host_dropout(host=0, at_launch=2)))
        plan = drop.recovery_plan
        check(len(drop.metrics) == len(fjobs) and
              drop.degraded == {i: "host_dropout:host0"
                                for i in range(len(fjobs))} and
              drop.verdicts() == ["UNSTABLE"] * len(fjobs) and
              plan is not None and plan.action == "remesh" and
              plan.evict == ("host0",),
              f"resilience: host dropout: {len(drop.degraded)} degraded, "
              f"plan {plan}")
        log(f"resilience: {len(fjobs)} lanes: 2 injected launch failures "
            f"retried, metrics bit-identical; host 0 dropped at launch 2: "
            f"every lane parked, {len(drop.degraded)} jobs degraded, plan "
            f"{plan.action} evict {plan.evict} ({plan.note})")

        # -- 3, read -----------------------------------------------------
        killer.join()
        got = killed_child
        check("error" not in got, f"resilience: real kill: "
              f"{got.get('error')}")
        diff = differing(got["metrics"], main_res.metrics)
        crecs = schema.read_stream_jsonl(str(tmp / "FLEET_stream.jsonl"))
        check(not diff and got["resumed_from"] is not None and
              got["n_step_compiles"] == 1 and got["launched"] > 0 and
              got["launch_slots_saved"] == main_res.launch_slots_saved,
              f"resilience: the resumed child differs in {len(diff)} sims "
              f"(from {got['resumed_from']}, {got['n_step_compiles']} "
              f"captures)")
        check(any(r["kind"] == "resume" for r in crecs) and
              not schema.validate_stream(crecs),
              "resilience: the child's merged stream is not valid")
        total += got["launched"]
        log(f"resilience: a child killed (SIGKILL) after {got['n_recs']} "
            f"chunk records, {got['kill_s']:.1f} s after its start, with "
            f"{got['steps']} on disk; a second process, set up beside it "
            f"in {got['setup_s']:.1f} s, resumed from step "
            f"{got['resumed_from']} in {got['run_s']:.2f} s: every metric "
            f"bit-identical, 1 capture, {got['launched']} fused launches; "
            f"merged stream valid ({len(crecs)} records); both children "
            f"{got['wall_s']:.1f} s, beside items 2, 4 and 5")
        log(f"resilience: phase {time.perf_counter() - t_phase:.1f} s")
    finally:
        if killer is not None:
            killer.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return total


# ---------------------------------------------------------------------------
# Phase 28: the trace simulator on the card, the paper's figures, examples
# ---------------------------------------------------------------------------

#: scripts/torch_paper_figures.py: the suites of Fig. 5(b), Fig. 5(c) and
#: the capacity table, each run(emit, device, T=None) -> dict.
FIGURES = ROOT / "scripts" / "torch_paper_figures.py"
#: The card against the CPU: slots of Fig. 5(b)'s C=3 sweep, and the
#: float traces' relative tolerance (over each trace's largest magnitude).
FIG_REF_SLOTS = 256
FIG_REF_RTOL = 1e-4
#: The shapes the suites capture, one graph each: Fig. 5(b)'s pi3 and
#: pi3bar sweeps (B=9), Fig. 5(c)'s pi3 run (B=1), the table's pi3bar runs
#: (B=1; the fifo pairing is Fig. 5(b)'s config at another batch) and its
#: bound-pairing run (B=1).
FIG_CAPTURES = 5
#: The port's examples, run as processes on the card at the originals'
#: sizes, all at once, and a line each prints once its check has passed.
EXAMPLES = (("torch_quickstart.py", "pi3 = backpressure routing"),
            ("torch_moe_backpressure.py", "The backpressure router keeps"),
            ("torch_serve_backpressure.py", "served 6 requests"),
            ("torch_train_lm.py", "OK: resumed training"))
EXAMPLE_TIMEOUT_S = 420


def load_figures():
    """scripts/torch_paper_figures.py as a module."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("torch_paper_figures",
                                                  FIGURES)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def trace_equal(a, b) -> bool:
    """Every trace and every final-state leaf of two SimResults equal."""
    import torch
    from repro_torch.device import tree_leaves
    return all(torch.equal(x, y) for x, y in zip(a[1:], b[1:])) and all(
        torch.equal(x, y) for x, y in zip(tree_leaves(a.final_state),
                                          tree_leaves(b.final_state)))


def graphed_against_eager(dev, problem, cfg, lams, T: int, seed: int,
                          what: str) -> dict:
    """One shape's runner on the card: a first graphed run (the eager
    first block, the capture, replays), a second (replays only), then the
    eager loop of the same slot step on the same arrivals and noise.
    Traces and final state bit-identical; one fused slot-step launch per
    slot in each, B1/B2 none, one capture.  Returns ms per batched slot
    and the launch counts."""
    import torch
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.sim import build_step, make_trace_runner, workload
    pp, _ = build_step(problem, cfg, dev)
    arr = workload.poisson_arrivals(lams, T, seed=seed, device=dev)
    run = make_trace_runner(pp, cfg)
    K.slot_route_decide.launches = 0
    K.comp_balance_decide.launches = 0
    walls, outs, counts = [], [], []
    for mode in ("graphed", "graphed", "eager"):
        reset_fused_counts(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs.append(run(arr, seed) if mode == "graphed" else
                    run.eager(arr, seed))
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        counts.append(fused_launches(K))
    launch = run.launch
    captured = launch.captured["slot_step_fused"]
    check(launch.n_captures == 1 and captured == launch.block,
          f"{what}: {launch.n_captures} captures of {captured} "
          f"fused launches; one of {launch.block} expected")
    for c in counts:
        check(c["launched"] == T, f"{what}: {c} fused launches for {T} "
              f"slots")
    check(counts[1]["eager"] == T % launch.block and
          counts[2]["replayed"] == 0,
          f"{what}: the warm graphed run launched {counts[1]} (eager only "
          f"past the last whole block), the eager loop {counts[2]}")
    check(K.slot_route_decide.launches == 0 and
          K.comp_balance_decide.launches == 0,
          f"{what}: B1/B2 launched on their own")
    check(trace_equal(outs[0], outs[2]) and trace_equal(outs[1], outs[2]),
          f"{what}: the graphed runs differ from the eager loop")
    ms = {"graphed": walls[1] / T * 1e3, "eager": walls[2] / T * 1e3,
          "graphed_first": walls[0] / T * 1e3}
    log(f"paper figures: {what}, B={len(lams)}, T={T}: the graphed "
        f"runner (one capture, {launch.replays} replays over both runs, "
        f"{captured} fused launches each) bit-identical to the "
        f"eager loop in every trace and the final state; fused launches "
        f"per run {[c['launched'] for c in counts]} = slots (eager + "
        f"replayed: {[(c['eager'], c['replayed']) for c in counts]}), B1/B2 "
        f"0; ms per batched slot: graphed {ms['graphed']:.4f} (first run, "
        f"capture included, {ms['graphed_first']:.4f}), eager "
        f"{ms['eager']:.4f}, eager / graphed "
        f"{ms['eager'] / ms['graphed']:.2f}x ({card_line()})")
    return {"ms": ms, "launched": sum(c["launched"] for c in counts),
            "launch": launch}


def card_against_cpu(dev, problem, cfg, lams, seed: int, what: str) -> None:
    """FIG_REF_SLOTS slots of one runner on the card and on the CPU (the
    plain slot step), on the same arrivals and regulator bits (the
    counter-based stream draws alike on both), free-running: n* equal,
    every float trace within FIG_REF_RTOL of the CPU's over its largest
    magnitude.  The fused kernel scatters in the CPU's order, so the
    states that decide n* are equal bit for bit; only the backlog sum
    (total_queue) rounds apart."""
    import torch
    from repro_torch.sim import build_step, make_trace_runner, workload
    out = {}
    for d in (dev, "cpu"):
        pp, _ = build_step(problem, cfg, d)
        arr = workload.poisson_arrivals(lams, FIG_REF_SLOTS, seed=seed,
                                        device=d)
        out[str(d)] = make_trace_runner(pp, cfg)(arr, seed)
    card, cpu = out[str(dev)], out["cpu"]
    errs = {}
    for k in ("total_queue", "delivered", "delivered_useful", "computed"):
        a, b = getattr(card, k).cpu().double(), getattr(cpu, k).double()
        errs[k] = float((a - b).abs().max() /
                        max(float(b.abs().max()), 1e-30))
    check(torch.equal(card.n_star.cpu(), cpu.n_star) and
          max(errs.values()) <= FIG_REF_RTOL,
          f"paper figures: card vs CPU, {what}: n* equal "
          f"{torch.equal(card.n_star.cpu(), cpu.n_star)}, relative "
          f"differences {errs}")
    log(f"paper figures: card vs CPU, {what}, B={len(lams)}, "
        f"{FIG_REF_SLOTS} slots free-running: n* equal, relative "
        f"differences { {k: f'{v:.3e}' for k, v in errs.items()} }")


def run_examples(dev) -> None:
    """The port's four examples as processes on the card, all at once, at
    the originals' sizes: each must exit 0 after its own check."""
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    procs = {}
    for script, _ in EXAMPLES:
        procs[script] = subprocess.Popen(
            [sys.executable, str(ROOT / "examples" / script)], cwd=ROOT,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    results = {}
    try:
        for script, _ in EXAMPLES:
            out, err = procs[script].communicate(timeout=EXAMPLE_TIMEOUT_S)
            results[script] = (procs[script].returncode, out, err,
                               time.perf_counter() - t0)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    for script, expect in EXAMPLES:
        rc, out, err, secs = results[script]
        check(rc == 0 and expect in out,
              f"example {script}: exit {rc}\n{out[-1500:]}\n{err[-3000:]}")
        log(f"paper figures: example {script} passed its check, exit 0, "
            f"done at {secs:.1f} s; its last lines: "
            + " | ".join(ln for ln in out.strip().splitlines()[-3:]))
    log(f"paper figures: the four examples in "
        f"{time.perf_counter() - t0:.1f} s, run at once")


def phase_paper_figures(dev) -> int:
    """The trace simulator (`repro_torch.sim`) on the card and the paper's
    figures through it.

    1. Fig. 5(b)'s C=3 sweep (B=9, T=2,500) under pi3 and pi3bar, and
       Fig. 5(c)'s run (C=2, pi3, lambda=6, B=1, T=4,000) under both
       policies: the graphed runner twice, then the eager loop on the same
       arrivals and regulator draws (`graphed_against_eager`): bit-identical
       traces and final states, one fused slot-step launch per slot (eager
       + replays x captured), one capture per runner, B1/B2 never; ms per
       batched slot of each; one profiled replay of the sweep's pi3 graph
       (`profile_graph`: the fused kernel's share of a replayed block).
    2. The card against the CPU at FIG_REF_SLOTS slots of the C=3 sweep,
       both policies (`card_against_cpu`).
    3. The three suites of scripts/torch_paper_figures.py at the paper's
       horizons, their claims hard checks (Fig. 5(b)'s knees at C=2 and
       C=3 for both policies, Fig. 5(c)'s convergence, the table's
       anchors), every row printed, the LP lambda* 8 and 10, each suite's
       wall seconds; one fused launch per simulated slot, FIG_CAPTURES
       captures.
    4. The four examples as processes on the card (`run_examples`).

    Returns the fused slot-step launches of steps 1 and 3."""
    import torch
    from repro_torch.core import PolicyConfig, paper_grid_problem
    from repro_torch.fleet.capture import GRAPH_SLOTS
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.sim import simulator
    t_phase = time.perf_counter()
    figs = load_figures()
    simulator.make_trace_launch.cache_clear()
    grid3, grid2 = paper_grid_problem(C=3.0), paper_grid_problem(C=2.0)
    launched, ms = 0, {}
    for name in ("pi3", "pi3bar"):
        cfg = PolicyConfig(name=name, eps_b=0.01)
        r9 = graphed_against_eager(dev, grid3, cfg, figs.LAMS[3.0],
                                   figs.FIG5B_T, 7, f"fig5b C=3 {name}")
        r1 = graphed_against_eager(dev, grid2, cfg, [figs.FIG5C_LAM],
                                   figs.FIG5C_T, 11, f"fig5c C=2 {name}")
        launched += r9["launched"] + r1["launched"]
        ms[name] = {"B=9": r9["ms"], "B=1": r1["ms"]}
        if name == "pi3":
            profile_graph(r9["launch"], "trace runner's (fig5b C=3 pi3)")
    for name in ("pi3", "pi3bar"):
        card_against_cpu(dev, grid3, PolicyConfig(name=name, eps_b=0.01),
                         figs.LAMS[3.0], 7, f"fig5b C=3 {name}")
    log("paper figures: ms per batched slot " + json.dumps(
        {p: {b: {k: round(v, 4) for k, v in m.items()}
             for b, m in d.items()} for p, d in ms.items()})
        + f" ({card_line()})")

    simulator.make_trace_launch.cache_clear()
    reset_fused_counts(K)
    K.slot_step_fused.captured = 0
    K.slot_route_decide.launches = 0
    K.comp_balance_decide.launches = 0
    suite_s = {}
    for name, suite in figs.SUITES.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            out = suite(log, dev)
        except AssertionError as e:
            raise SmokeFailure(f"paper figures: {name}: a claim failed at "
                               f"the paper's horizon: {e}") from e
        torch.cuda.synchronize()
        suite_s[name] = time.perf_counter() - t0
        check(out["checks"] and all(out["checks"].values()),
              f"paper figures: {name}: claims {out['checks']}")
        log(f"paper figures: suite {name} ok in {suite_s[name]:.3f} s, "
            f"claims {out['checks']}")
        if name == "fig5b":
            check(abs(out["lam_star"][2.0] - 8.0) < 1e-6 and
                  abs(out["lam_star"][3.0] - 10.0) < 1e-6,
                  f"paper figures: LP lambda* {out['lam_star']}")
    slots = (4 * figs.FIG5B_T + figs.FIG5C_T + 4 * figs.TABLE_T)
    fused = fused_launches(K)
    check(fused["launched"] == slots,
          f"paper figures: suites launched {fused} fused slot steps for "
          f"{slots} batched slots")
    check(K.slot_step_fused.captured == FIG_CAPTURES * GRAPH_SLOTS,
          f"paper figures: {K.slot_step_fused.captured} captured launches, "
          f"{FIG_CAPTURES} captures of {GRAPH_SLOTS} expected")
    check(K.slot_route_decide.launches == 0 and
          K.comp_balance_decide.launches == 0,
          "paper figures: B1/B2 launched on their own in the suites")
    launched += fused["launched"]
    log(f"paper figures: suites {json.dumps({k: round(v, 3) for k, v in suite_s.items()})} "
        f"s, {sum(suite_s.values()):.3f} s in all; {slots} batched slots, "
        f"fused launches {fused}, {FIG_CAPTURES} captures ({card_line()})")

    run_examples(dev)
    log(f"phase_paper_figures: {time.perf_counter() - t_phase:.1f} s")
    return launched


# ---------------------------------------------------------------------------
# Phase 5b: the fused slot step against its plain version
# ---------------------------------------------------------------------------

#: What `phase_slot_step` compares of one slot step: the new queue state
#: and the slot's two decisions (Z [B, NC], n* [B] int32).  Made without
#: annotations, so the script also loads as a module outside sys.modules.
SlotOut = dataclasses.make_dataclass("SlotOut", ("state", "Z", "n_star"),
                                     frozen=True)


def step_case(row, B: int, seed: int):
    """(pp, cfg, state) of a STEP_CASES row on the CPU: B copies of the
    padded problem with comp nodes failed as the row says (through
    `with_capacity_scales`), and B random states."""
    import numpy as np
    import torch
    from repro_torch.core.policies import PolicyConfig
    from repro_torch.fleet.batching import PadDims, from_leaves, pad_leaves
    from repro_torch.fleet.scenarios import get_scenario
    scen, policy, pad_extra, fail, pairing = row
    problem = get_scenario(scen).build(0)
    dims = PadDims(problem.graph.n_nodes + pad_extra,
                   problem.graph.n_edges + 2 * pad_extra,
                   problem.n_comp + pad_extra)
    pp = from_leaves([pad_leaves(problem, dims)] * B, dims.n_nodes,
                     dims.n_comp, "cpu")
    comp_scale = torch.tensor(
        [0.0 if (fail >> (i % 3)) & 1 and i > 0 else 1.0
         for i in range(dims.n_comp)]).expand(B, -1)
    pp = pp.with_capacity_scales(torch.ones(B, dims.n_edges), comp_scale)
    cfg = PolicyConfig(name=policy, eps_b=EPS_B, pairing=pairing,
                       threshold=1.5, wireless=get_scenario(scen).wireless)
    return pp, cfg, random_state(np.random.default_rng(seed), B,
                                 dims.n_nodes, dims.n_comp)


def slot_noise(rng, pp, lam):
    """One slot's inputs for every sim, on the CPU: Poisson(lam) arrivals,
    Bernoulli(EPS_B) regulator draws, and capacity scales (a link out with
    probability 0.1, else at 0.5-1 of its rate; a comp node failed with
    probability 0.1), applied to ``pp``."""
    import numpy as np
    import torch
    B, E, NC = pp.batch, pp.n_edges, pp.n_comp
    es = np.where(rng.random((B, E)) < 0.1, 0.0,
                  0.5 + 0.5 * rng.random((B, E))).astype(np.float32)
    cs = (rng.random((B, NC)) >= 0.1).astype(np.float32)
    return (pp.with_capacity_scales(torch.from_numpy(es),
                                    torch.from_numpy(cs)),
            torch.from_numpy(rng.poisson(lam).astype(np.float32)),
            torch.from_numpy((rng.random((B, NC)) < EPS_B)
                             .astype(np.float32)),
            torch.full((B,), EPS_B))


def step_args(pp, cfg, state, arr, draws, eps, dev):
    """The kernel-level arguments of one slot step on ``dev``: (state
    leaves, problem leaves, arrivals, draws, eps), and the policy flags."""
    from repro_torch.kernels.bp_slot import ref as R
    args = ({k: getattr(state, k).to(dev) for k in R.STATE_LEAVES},
            {k: getattr(pp, k).to(dev) for k in R.PROBLEM_LEAVES},
            arr.to(dev), draws.to(dev) if cfg.use_regulator else None,
            eps.to(dev))
    return args, dict(load_balance=cfg.load_balance,
                      fixed_node=cfg.fixed_node, regulated=cfg.use_regulator,
                      pairing=cfg.pairing, thresholded=cfg.thresholded,
                      threshold=cfg.threshold, wireless=cfg.wireless)


def phase_slot_step(dev, peaks):
    """The fused slot-step kernel against its plain version
    (`slot_step_ref`: `ref.slot_step_plain` with B1 and B2 through their
    wrappers) on the card, and against the plain version on the CPU:
    STEP_SLOTS slots of the main batch (1,512 pi3_reg sims, one random
    state, random link outages and comp failures every slot), then
    STEP_CASE_SLOTS slots of STEP_CASE_B sims for each STEP_CASES row.

    Teacher-forced: every slot, all three step the CPU's carry.  Gates,
    against both: the decisions n* and Z and every non-float leaf equal bit
    for bit, and every float leaf within 1e-5 as `carry_diff` scales it.
    Also reported: per leaf, the share of values bit-identical to the
    CPU's.  Then the device time of one launch of the fused kernel and of
    one plain slot step on the card at the main batch."""
    import numpy as np
    import torch
    from repro_torch.core.queues import NetState
    from repro_torch.kernels.bp_slot import kernel as K
    from repro_torch.kernels.bp_slot import ref as R
    t_start = time.perf_counter()
    jobs, inp = main_batch("cpu")
    main_pp = inp.pp
    rng = np.random.default_rng(1)
    runs = [("main pi3_reg", main_pp, jobs[0].policy_config(),
             random_state(rng, len(jobs), N_MAIN, NC_MAIN),
             inp.lam.numpy(), STEP_SLOTS)]
    for i, row in enumerate(STEP_CASES):
        pp, cfg, state = step_case(row, STEP_CASE_B, seed=10 + i)
        runs.append((f"{row[0]} {row[1]} {row[4]}", pp, cfg, state,
                     np.full(STEP_CASE_B, 2.0), STEP_CASE_SLOTS))
    decide = dict(route=K.slot_route_decide, balance=K.comp_balance_decide)
    worst, max_err, launches, main_state = {}, 0.0, None, None
    for name, pp0, cfg, state, lam, slots in runs:
        same_bits = {}
        if launches is None:
            K.slot_route_decide.launches = K.comp_balance_decide.launches = 0
            K.slot_step_fused.launches = 0
        for t in range(slots):
            pp, arr, draws, eps = slot_noise(rng, pp0, lam)
            a_cpu, flags = step_args(pp, cfg, state, arr, draws, eps, "cpu")
            a_dev, _ = step_args(pp, cfg, state, arr, draws, eps, dev)
            outs = {}
            for what, step, args, kw in (
                    ("cpu", R.slot_step_plain, a_cpu, decide),
                    ("card", R.slot_step_plain, a_dev, decide),
                    ("fused", K.slot_step_fused, a_dev, {})):
                new, m = step(*args, **flags, **kw)
                outs[what] = SlotOut(NetState(**new), m["Z"], m["n_star"])
            fused = on_device(outs["fused"], "cpu")
            card = on_device(outs["card"], "cpu")
            for ref_name, ref in (("card", card), ("CPU", outs["cpu"])):
                scaled, plain, same = carry_diff(fused, ref)
                check(same and max(scaled.values()) <= 1e-5,
                      f"{name}, slot {t}: fused vs the plain slot step on "
                      f"the {ref_name}: n* equal {same}; largest scaled "
                      f"differences {top(scaled)}; plain {top(plain)}")
                for k, v in scaled.items():
                    worst[(ref_name, k)] = max(worst.get((ref_name, k), 0.0),
                                               v)
                check(bits_equal(fused.Z, ref.Z),
                      f"{name}, slot {t}: fused Z differs from the plain "
                      f"slot step's on the {ref_name}")
            xa, xb = named_leaves(fused), named_leaves(outs["cpu"])
            xc = named_leaves(card)
            for k, y in xb.items():
                x = xa[k]
                eq = x.view(torch.int32) == y.view(torch.int32) \
                    if y.is_floating_point() else x == y
                same_bits[k] = same_bits.get(k, 0) + int(eq.sum())
                if y.is_floating_point():
                    max_err = max(max_err, float(
                        (x.double() - xc[k].double()).abs().max()))
            state = outs["cpu"].state
        if launches is None:
            torch.cuda.synchronize()
            launches = {"bp_slot_step": K.slot_step_fused.launches,
                        "slot_route_decide": K.slot_route_decide.launches,
                        "comp_balance_decide": K.comp_balance_decide.launches}
            check(launches == {"bp_slot_step": slots,
                               "slot_route_decide": slots,
                               "comp_balance_decide": 2 * slots},
                  f"{name}: launches {launches} over {slots} slots")
            main_state = state
        total = {k: v.numel() * slots for k, v in xb.items()}
        log(f"slot step, {name}: {slots} slots x {pp0.batch} sims gated; "
            f"bit-identical to the CPU's plain path: " +
            ", ".join(f"{k} {same_bits[k] / total[k]:.4f}"
                      for k in total))
    log("slot step: largest scaled differences, vs the card / vs the CPU: "
        + ", ".join(f"{k} {worst[('card', k)]:.3e} / "
                    f"{worst[('CPU', k)]:.3e}"
                    for k in sorted({k for _, k in worst})))

    # Timing at the main batch, from its last carry.
    _, pp0, cfg, _, lam, _ = runs[0]
    pp, arr, draws, eps = slot_noise(rng, pp0, lam)
    args, flags = step_args(pp, cfg, main_state, arr, draws, eps, dev)
    new, m = K.slot_step_fused(*args, **flags)
    nbytes = sum(t.numel() * t.element_size() for t in
                 [*args[0].values(), *args[1].values(), *args[2:],
                  *new.values(), m["total_queue"], m["routed"],
                  m["computed"], m["Z"], m["n_star"]] if t is not None)
    B, N, NC, E = pp.batch, pp.n_nodes, pp.n_comp, pp.n_edges
    C, QK = 3 * NC, N * 3 * NC
    # Operations per sim, counted from the kernel's phases: the B1 fold (3
    # per class per link), the allocation and the caps (~20 per link), the
    # scatters and sums (one add per queue entry and per update), the
    # load-balance and combine decisions (~20 per comp node).
    nops = B * (3 * C * E + 20 * E + 2 * QK + 4 * E + 20 * NC)
    row = dict(
        name="bp_slot_step", route="cuda",
        source="src/repro_torch/kernels/bp_slot/csrc/bp_slot_step.cu",
        replaces="src/repro/kernels/bp_slot/kernel.py:59, "
                 "src/repro/kernels/bp_slot/kernel.py:138",
        max_abs_err=max_err,
        ms=device_ms(lambda: K.slot_step_fused(*args, **flags),
                     match="bp_slot_step_kernel"),
        wall_ms=wall_ms(lambda: K.slot_step_fused(*args, **flags)),
        plain_ms=device_ms(lambda: R.slot_step_plain(*args, **flags,
                                                     **decide), n=20, warm=3),
        plain_wall_ms=wall_ms(lambda: R.slot_step_plain(*args, **flags,
                                                        **decide),
                              n=20, warm=3),
        library_ms=None, bytes=nbytes, ops=nops,
        smem=K.slot_step_smem_bytes(N, NC, E))
    row["bound_ms"], row["bound_by"] = bound_of(nbytes, nops, peaks)
    log(f"kernel bp_slot_step at B={B}, N={N}, NC={NC}, E={E}: "
        f"{row['ms']:.6f} ms of device time per launch "
        f"({row['wall_ms']:.6f} ms between host events), bound "
        f"{row['bound_ms'] * 1e3:.4f} us by {row['bound_by']} "
        f"({nbytes} B, {nops} ops), {row['smem']} B of shared memory per "
        f"block; the plain slot step on the card {row['plain_ms']:.6f} ms "
        f"of device time per slot ({row['plain_wall_ms']:.6f} ms between "
        f"host events); max_abs_err against it {max_err:.3e}; phase "
        f"{time.perf_counter() - t_start:.1f} s")
    return row, launches


# ---------------------------------------------------------------------------
# Phase 6: the MoE router; Phase 7: serving at full width; Phase 8: the
# serve path on the card against the CPU
# ---------------------------------------------------------------------------

def phase_router(dev):
    """The loop of benchmarks/bench_router.py on the card: E=64, T=1024,
    K=6, 40 steps of skewed logits (4 hot experts), plain / aux /
    backpressure.  Backpressure must balance better than plain."""
    import torch
    from repro_torch.core.router import (RouterConfig, init_router_state,
                                         load_violation, route)
    E, T, K, STEPS = 64, 1024, 6, 40
    gen = torch.Generator(device=dev).manual_seed(0)
    base = torch.randn((T, E), generator=gen, device=dev) * 0.5
    skew = torch.zeros(E, device=dev)
    skew[:4] += 3.0
    noise = [torch.randn((T, E), generator=gen, device=dev)
             for _ in range(STEPS)]
    out = {}
    for mode, beta in (("plain", 0.0), ("aux", 0.0), ("backpressure", 2.0)):
        cfg = RouterConfig(n_experts=E, k=K, mode=mode, beta=beta)
        state = init_router_state(E, device=dev)
        loads = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(STEPS):
            r = route(cfg, state, base + skew[None, :] + 0.1 * noise[i])
            state = r.new_state
            loads.append(r.load)
        torch.cuda.synchronize()
        us = (time.perf_counter() - t0) / STEPS * 1e6
        out[mode] = float(load_violation(torch.stack(loads[-10:]).mean(0)))
        log(f"router/{mode}: load_violation {out[mode]:.4f}, {us:.1f} us per "
            f"routing call (host clock)")
    check(out["backpressure"] < out["plain"],
          f"backpressure does not balance better than plain: {out}")
    return out


def serve_model(dev, n_layers=None, seed: int = 0):
    """(config, params) of the serving arch at full width (depth cut to
    ``n_layers`` when given), float32 weights drawn on ``dev``."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, split_tree
    cfg = get_config(SERVE_ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, _ = split_tree(get_model(cfg).init(gen))
    return cfg, params


def state_bytes(tree) -> int:
    """Bytes of a real state's tensors (dicts, NamedTuples), each storage
    once: what the dry-run's abstract state must hold byte for byte."""
    from repro_torch.launch.dryrun import tree_bytes
    return tree_bytes(tree)


def tree_numel(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_numel(v) for v in tree.values())
    return tree.numel()


def phase_serve(dev):
    """granite-moe-1b-a400m at full width on the card through
    `Engine.run_until_done`: 8 requests drawn as the JAX CLI draws them,
    every MoE layer's gate one bp_topk_route launch (24 per decode step)
    and the standalone bp_topk never; then the step time, one profiled
    step's activities (per layer too) and device-busy share, and the
    activities of one layer's gate at the decode shape (no softmax)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.bp_topk import kernel as K
    from repro_torch.launch.serve import Engine
    from repro_torch.models.transformer import layer
    t0 = time.perf_counter()
    cfg, params = serve_model(dev)
    torch.cuda.synchronize()
    n_params = tree_numel(params)
    log(f"serve: {cfg.name} full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, expert "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}), {n_params:,} float32 params "
        f"drawn on the card in {time.perf_counter() - t0:.2f} s")
    eng = Engine(cfg, params, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                 device=dev)
    rng = np.random.default_rng(0)
    for _ in range(SERVE_REQUESTS):
        plen = int(rng.integers(4, 16))
        eng.submit(list(rng.integers(0, cfg.vocab, plen)), SERVE_MAX_NEW)
    K.bp_topk.launches = 0
    K.bp_topk_route.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    finished = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, steps = K.bp_topk_route.launches, eng.steps
    check(K.bp_topk.launches == 0, f"the serve path launched the standalone "
          f"bp_topk {K.bp_topk.launches} times")
    check(sorted(finished) == list(range(SERVE_REQUESTS)),
          f"served {sorted(finished)} of {SERVE_REQUESTS} requests")
    outs = [finished[r].out for r in sorted(finished)]
    check(all(len(o) == SERVE_MAX_NEW and all(0 <= t < cfg.vocab for t in o)
              for o in outs), f"malformed outputs {outs}")
    check(launches == cfg.n_layers * steps > 0,
          f"bp_topk_route launched {launches} times in {steps} decode "
          f"steps, expected {cfg.n_layers} per step")
    n_tok = sum(len(o) for o in outs)
    ms_step = wall / steps * 1e3

    # one more decode step, unprofiled and then profiled
    toks = eng._last_tok.copy()
    step_ms = []
    for _ in range(10):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = eng._step(toks)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
    check(tuple(logits.shape) == (SERVE_SLOTS, cfg.vocab) and
          bool(torch.isfinite(logits).all()), "non-finite or misshapen logits")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._step(toks)
        torch.cuda.synchronize()
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    med = statistics.median(step_ms)
    if evs:
        dev_ms = sum(e.device_time for e in evs) / 1e3
        kinds = {}
        for e in evs:
            kinds[e.name] = kinds.get(e.name, 0) + e.device_time / 1e3
        topk = sorted(kinds.items(), key=lambda kv: -kv[1])[:6]
        gate = sum(1 for e in evs if "bp_topk_route_" in e.name)
        busy = (f"{len(evs)} CUDA device activities "
                f"({len(evs) / cfg.n_layers:.2f} per layer; {gate} "
                f"bp_topk_route), {dev_ms:.4f} ms of "
                f"device time per decode step, busy {dev_ms / med:.4f} of "
                f"the unprofiled step's {med:.4f} ms; most time: " + "; ".join(
                    f"{n[:50]} {t:.4f} ms" for n, t in topk))
    else:
        busy = "device-busy share not measured (no device activity traced)"
    n_gate, gate_names = route_activities(
        cfg, layer(params["stack"]["layers"], 0)["moe"],
        torch.randn((SERVE_SLOTS, 1, cfg.d_model), device=dev),
        torch.zeros((cfg.n_experts,), device=dev))
    log(f"serve: {len(finished)} requests, {n_tok} tokens, {steps} decode "
        f"steps (prefill included) in {wall:.3f} s: {ms_step:.4f} ms per "
        f"decode step (unprofiled step alone {med:.4f} ms), "
        f"{n_tok / wall:.2f} generated tokens/s; bp_topk_route "
        f"launches {launches} = {cfg.n_layers} x {steps}, bp_topk 0; "
        f"{busy}; one layer's gate at the decode shape: {n_gate:.2f} CUDA "
        f"activities per call ({', '.join(nm[:40] for nm in gate_names)}); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB")
    for rid in sorted(finished)[:2]:
        log(f"  req {rid}: out={finished[rid].out}")
    return launches


def phase_serve_reference(dev):
    """The serve path on the card against the port's plain path on the
    CPU, at full width and REF_LAYERS layers, from the same weights and
    the same empty caches, REF_STEPS decode steps fed the same tokens.

    Every layer's selected experts must be equal (a differing row prints
    its margin between the k-th and (k+1)-th sel and fails).  The logits
    must agree within LOGIT_ATOL: float32 sums in another order differ by
    ~1e-6 here, while a TF32 matmul (10-bit mantissa) in the unembedding
    alone would be off by ~3e-4 (32 random-signed terms of 0.02 x 2^-11 per
    logit), so the gate catches a lost float32."""
    import numpy as np
    import torch
    from repro_torch.models import get_model, moe
    cfg, params = serve_model(dev, n_layers=REF_LAYERS, seed=1)
    cpu = torch.device("cpu")
    params_cpu = to_device_tree(params, cpu)
    api = get_model(cfg)
    caches = {d: api.init_decode(SERVE_SLOTS, SERVE_MAX_LEN, torch.float32,
                                 device=d) for d in (dev, cpu)}
    H = {d: api.init_state(device=d).router_H for d in (dev, cpu)}
    rng = np.random.default_rng(2)
    routed = []
    original = moe._route

    def recording_route(cfg_, p, x_flat, rs, *, use_kernel=False):
        out = original(cfg_, p, x_flat, rs, use_kernel=use_kernel)
        routed.append((out[0], x_flat, p["router"], rs.H))
        return out
    worst = 0.0
    t0 = time.perf_counter()
    moe._route = recording_route
    try:
        for step in range(REF_STEPS):
            toks = rng.integers(0, cfg.vocab, SERVE_SLOTS)
            logits = {}
            for d, p in ((dev, params), (cpu, params_cpu)):
                routed.clear()
                logits[d], caches[d] = api.decode_step(
                    p, caches[d], {"tokens": torch.as_tensor(toks, device=d)},
                    activ_dtype=torch.float32, router_H=H[d])
                logits[d] = logits[d].cpu()
                if d == dev:
                    card_routes = [r[0].cpu() for r in routed]
                else:
                    cpu_routes = list(routed)
            check(len(card_routes) == len(cpu_routes) == cfg.n_layers,
                  f"{len(card_routes)}/{len(cpu_routes)} routing calls for "
                  f"{cfg.n_layers} layers")
            for layer, (ci, (ri, x, wr, h)) in enumerate(zip(card_routes,
                                                             cpu_routes)):
                if torch.equal(ci, ri):
                    continue
                row = int((ci != ri).any(-1).reshape(-1).nonzero()[0])
                lg = (x.reshape(-1, x.shape[-1])[row] @ wr).double()
                cap = max(x.shape[0] * x.shape[1] * cfg.top_k / cfg.n_experts,
                          1.0)
                sel = torch.softmax(lg, -1) - h.double() / cap
                srt = torch.sort(sel, descending=True).values
                raise SmokeFailure(
                    f"serve reference: step {step}, layer {layer}, row {row}: "
                    f"card picked {ci.reshape(-1, cfg.top_k)[row].tolist()}, "
                    f"CPU {ri.reshape(-1, cfg.top_k)[row].tolist()}; margin "
                    f"between the k-th and (k+1)-th sel "
                    f"{float(srt[cfg.top_k - 1] - srt[cfg.top_k]):.3e}")
            diff = float((logits[dev] - logits[cpu]).abs().max())
            scale = float(logits[cpu].abs().max())
            check(diff <= LOGIT_ATOL, f"serve reference: step {step}: logits "
                  f"differ by {diff:.3e} > {LOGIT_ATOL} (max |logit| "
                  f"{scale:.3f})")
            worst = max(worst, diff)
    finally:
        moe._route = original
    log(f"serve reference: {cfg.name} full width at {REF_LAYERS} layers, "
        f"{REF_STEPS} decode steps x {SERVE_SLOTS} slots, card vs CPU from "
        f"the same weights and caches ({time.perf_counter() - t0:.1f} s): "
        f"every layer's experts equal, logits within {worst:.3e} (gate "
        f"{LOGIT_ATOL}, max |logit| {scale:.3f})")


# ---------------------------------------------------------------------------
# Phase 9: bp_route; Phase 10: flash attention; Phase 11: the prefill path
# at full width; Phase 12: the prefill path on the card against the CPU
# ---------------------------------------------------------------------------

def bp_route_inputs(gen, ties: bool, dtype, dev):
    """Q [N, C], edges [E, 2] without self-loops, cap [E] = 5 (bench_
    kernels' draw); ``ties``: integer backlogs in [0, 3] with duplicated
    column blocks, and link 0 between two equal rows (all-zero diff)."""
    import torch
    N, C, E = ROUTE_N, ROUTE_C, ROUTE_E
    if ties:
        Q = torch.randint(0, 4, (N, C // 3), generator=gen).float().repeat(
            1, 3)
        Q[1] = Q[0]
    else:
        Q = torch.rand((N, C), generator=gen) * 100
    m = torch.randint(0, N, (E,), generator=gen)
    l = (m + 1 + torch.randint(0, N - 1, (E,), generator=gen)) % N
    if ties:
        m[0], l[0] = 0, 1
    return (Q.to(dtype).to(dev), torch.stack([m, l], 1).to(dev),
            torch.full((E,), 5.0, device=dev))


def phase_route(dev, peaks):
    """bp_route bit for bit against its plain version, then once through
    its entry point `bp_route_op` with the launch count read around it (no
    model or engine path calls this kernel: the op is its path, as in
    benchmarks/bench_kernels.py); device times at bench_kernels' shape."""
    import torch
    from repro_torch.kernels.bp_route import kernel as K
    from repro_torch.kernels.bp_route.ops import bp_route_op
    from repro_torch.kernels.bp_route.ref import bp_route_ref
    gen = torch.Generator().manual_seed(3)
    errs = []
    for dtype in (torch.float32, torch.bfloat16):
        for ties in (False, True):
            Q, edges, cap = bp_route_inputs(gen, ties, dtype, dev)
            qm, ql = Q[edges[:, 0]], Q[edges[:, 1]]
            got = K.bp_route_decide(qm, ql, cap)
            want = bp_route_ref(qm, ql, cap)
            torch.cuda.synchronize()
            check(all(bits_equal(a, b) for a, b in zip(got, want)),
                  f"bp_route differs from its plain version ({dtype}, "
                  f"ties={ties})")
            if ties:
                check(int(got[0][0]) == 0 and float(got[1][0]) == 0.0 and
                      int(got[2][0]) == -1, "a zero row must pick class 0 "
                      "with no rate and direction -1")
            errs += list(zip(got, want))
    Q, edges, cap = bp_route_inputs(gen, False, torch.float32, dev)
    K.bp_route_decide.launches = 0
    cls, rate, dirn = bp_route_op(Q, edges, cap)
    torch.cuda.synchronize()
    launches = K.bp_route_decide.launches
    check(launches == 1, f"bp_route_op launched the kernel {launches} times")
    check(bool((rate == 5.0).all()), "random backlogs: every link moves")
    qm, ql = Q[edges[:, 0]], Q[edges[:, 1]]
    E, C = qm.shape
    row = dict(
        name="bp_route_decide", route="cuda",
        source="src/repro_torch/kernels/bp_route/csrc/bp_route.cu",
        replaces="src/repro/kernels/bp_route/kernel.py:31",
        launches=launches, max_abs_err=max_abs_err(errs),
        ms=device_ms(lambda: K.bp_route_decide(qm, ql, cap),
                     match="bp_route_kernel"),
        wall_ms=wall_ms(lambda: K.bp_route_decide(qm, ql, cap)),
        plain_ms=device_ms(lambda: bp_route_ref(qm, ql, cap)),
        library_ms=None, bytes=2 * 4 * E * C + 4 * E + 12 * E,
        ops=3 * E * C)
    row["bound_ms"], row["bound_by"] = bound_of(row["bytes"], row["ops"],
                                                peaks)
    qm16, ql16 = qm.to(torch.bfloat16), ql.to(torch.bfloat16)
    ms16 = device_ms(lambda: K.bp_route_decide(qm16, ql16, cap),
                     match="bp_route_kernel")
    b16, by16 = bound_of(2 * 2 * E * C + 4 * E + 12 * E, 3 * E * C, peaks)
    log(f"kernel bp_route_decide at E={E}, C={C} (N={ROUTE_N}): "
        f"{row['ms']:.6f} ms on the card ({row['wall_ms']:.6f} ms between "
        f"host events; plain {row['plain_ms']:.6f} ms on the card), bound "
        f"{row['bound_ms'] * 1e3:.4f} us by {row['bound_by']} "
        f"({row['bytes']} B, {row['ops']} ops), "
        f"{row['ms'] / row['bound_ms']:.2f}x the bound; bfloat16 "
        f"{ms16:.6f} ms, bound {b16 * 1e3:.4f} us by {by16}; bit-identical "
        f"on 4 cases; bp_route_op launched it once; library: no single "
        f"PyTorch call")
    return row


def flash_inputs(gen, B, H, KH, S, D, dtype, dev):
    import torch
    return tuple(torch.randn(shape, generator=gen, device=dev).to(dtype)
                 for shape in ((B, H, S, D), (B, KH, S, D), (B, KH, S, D)))


def flash_rows_ref(q, k, v, r0: int, rows: int, window=None):
    """Query rows r0 .. r0 + rows - 1 of causal attention (with a sliding
    ``window`` when given), computed plainly in float32 over the keys they
    see (the plain version's scores do not fit at the prefill length)."""
    import torch
    B, H, S, D = q.shape
    G = H // k.shape[1]
    r1 = r0 + rows
    qt = q[:, :, r0:r1].float()
    kk = k[:, :, :r1].repeat_interleave(G, dim=1).float()
    s = torch.einsum("bhsd,bhtd->bhst", qt, kk) / math.sqrt(D)
    qi = torch.arange(r0, r1, device=q.device)[:, None]
    kj = torch.arange(r1, device=q.device)[None, :]
    hidden = kj > qi
    if window is not None:
        hidden |= kj <= qi - window
    s = s.masked_fill(hidden, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p,
                        v[:, :, :r1].repeat_interleave(G, dim=1).float())


def within(out, ref, atol: float, rtol: float) -> bool:
    """assert_allclose's rule: |out - ref| <= atol + rtol |ref|."""
    return bool(((out.float() - ref.float()).abs()
                 <= atol + rtol * ref.float().abs()).all())


def flash_windows(S: int):
    """The fixed windows at S and FLASH_RANDOM_WINDOWS 64-row windows at
    random starts (seed 5): (first row, rows) pairs."""
    import numpy as np
    starts = np.random.default_rng(5).integers(0, S - 64,
                                               FLASH_RANDOM_WINDOWS)
    return ((0, 64), (32, 64), (4001, 64), (S // 2 - 32, 64),
            (S - 256, 256)) + tuple((int(r), 64) for r in starts)


def check_windows(out, q, k, v, what: str, tol=FLASH_BF16_ROUNDING,
                  window=None):
    """Hold the rows of `flash_windows` of a causal ``out`` (with a sliding
    ``window`` when given) to a plain float32 computation within ``tol`` =
    (atol, rtol) (for bf16, bf16 rounding); returns (max abs error,
    largest share of the gate), and the windows."""
    atol, rtol = tol
    windows = flash_windows(q.shape[2])
    rows_err, rows_use = 0.0, 0.0
    for r0, n in windows:
        got = out[:, :, r0:r0 + n].float()
        ref = flash_rows_ref(q, k, v, r0, n, window)
        err = (got - ref).abs()
        rows_err = max(rows_err, float(err.max()))
        rows_use = max(rows_use, float((err / (atol + rtol * ref.abs()))
                                       .max()))
        check(within(got, ref, atol, rtol),
              f"flash_attention on {what}: rows {r0}..{r0 + n - 1} differ "
              f"from the plain computation by {float(err.max()):.3e}, more "
              f"than {atol} + {rtol} |ref|")
    return rows_err, rows_use, windows


def phase_flash(dev, peaks):
    """flash_attention against its plain version on FLASH_CASES in float32
    (the CUDA-core kernel) and bfloat16 (the sm90 kernel; its outputs also
    against the plain version's float32 result, within
    FLASH_BF16_ROUNDING), each case through the kernel its dtype selects;
    at granite's prefill shape, the rows of `flash_windows` against a
    plain computation under the same rule, then device times of the sm90
    kernel, of the CUDA-core kernel in float32, of the plain version (at
    FLASH_PLAIN_S) and of SDPA (the library column, timed only; in bf16,
    and in float32 beside the CUDA-core kernel) beside the bound.  The
    CUDA-core kernel in float32 also at the prefill shape (its row windows
    within FLASH_TOL of a plain computation) and at the training step's
    FLASH_TRAIN_SHAPE (against the plain version), each called twice with
    bit-identical results, and timed at the training shape beside SDPA's
    float32 kernel and its own float32 bound.  Then the families' shapes
    (`flash_families`, `flash_gemma`, `flash_zamba`) and Moonlight's
    (192, 128) instance (`flash_mla`)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(device=dev).manual_seed(4)
    atol, rtol = FLASH_BF16_ROUNDING
    errs, worst = [], {}
    for B, H, KH, S, D, causal, window in FLASH_CASES:
        for name, tol in FLASH_TOL.items():
            dtype = getattr(torch, name)
            q, k, v = flash_inputs(gen, B, H, KH, S, D, dtype, dev)
            before = (K.flash_attention.launches,
                      K.flash_attention.launches_sm90)
            out = K.flash_attention(q, k, v, causal=causal, window=window)
            ref = flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            sm90 = K.uses_sm90(dtype, D)
            check((K.flash_attention.launches,
                   K.flash_attention.launches_sm90) ==
                  (before[0] + (not sm90), before[1] + sm90),
                  f"flash_attention at {(B, H, KH, S, D)} {name} did not "
                  f"launch the {'sm90' if sm90 else 'CUDA-core'} kernel")
            err = max_abs_err([(out, ref)])
            check(out.dtype == dtype and within(out, ref, tol, tol),
                  f"flash_attention differs from its plain version at "
                  f"{(B, H, KH, S, D, causal, window)} {name}: max abs "
                  f"{err:.3e} (tolerance {tol})")
            if dtype == torch.bfloat16:
                ref32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                            causal=causal, window=window)
                check(within(out, ref32, atol, rtol),
                      f"flash_attention at {(B, H, KH, S, D, causal, window)}"
                      f" bf16: off the float32 plain result by more than "
                      f"bf16 rounding ({max_abs_err([(out, ref32)]):.3e})")
            errs.append((out, ref))
            worst[f"S={S},D={D},{name}"] = err
    log("flash cases, max abs error against the plain version (float32: "
        "CUDA-core kernel, bfloat16: sm90 kernel): " +
        json.dumps({k: f"{v:.3e}" for k, v in worst.items()}))

    B, H, KH, D = PREFILL_B, 16, 8, 64                 # granite's heads
    S = PREFILL_S
    q, k, v = flash_inputs(gen, B, H, KH, S, D, torch.bfloat16, dev)
    out = K.flash_attention(q, k, v)
    rows_err, rows_use, windows = check_windows(out, q, k, v,
                                                f"randn at S={S}")
    ms = device_ms(lambda: K.flash_attention(q, k, v),
                   match="flash_attention_sm90_kernel<", n=5, warm=2)
    lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True), n=5, warm=2)
    q32, k32, v32 = (t.float() for t in (q, k, v))
    f32_tol = (FLASH_TOL["float32"], FLASH_TOL["float32"])
    out32 = K.flash_attention(q32, k32, v32)
    check(bits_equal(out32, K.flash_attention(q32, k32, v32)),
          f"the CUDA-core kernel at S={S}, float32: two calls differ")
    rows32_err, rows32_use, _ = check_windows(out32, q32, k32, v32,
                                              f"float32 randn at S={S}",
                                              f32_tol)
    del out32
    simt_ms = device_ms(lambda: K.flash_attention(q32, k32, v32),
                        match="flash_attention_kernel<", n=2, warm=1)
    # SDPA's float32 kernel (memory-efficient) takes no grouped heads: the
    # kv heads are repeated before the timed call, and the backend is
    # pinned so that no call falls back to materialising the scores.
    k32, v32 = (t.repeat_interleave(H // KH, dim=1) for t in (k32, v32))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib32_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q32, k32, v32, is_causal=True), n=2, warm=1)
    del q32, k32, v32
    train = flash_train(gen, dev, peaks, f32_tol)
    errs.append(train.pop("pair"))
    families = flash_families(gen, dev)
    errs.extend(families.pop("pairs"))
    families.update(flash_gemma(gen, dev, peaks))
    zamba = flash_zamba(gen, dev, peaks)
    errs.extend(zamba.pop("pairs"))
    families.update(zamba)
    families.update(flash_mla(gen, dev, peaks))
    q4, k4, v4 = (t[:, :, :FLASH_PLAIN_S] for t in (q, k, v))
    ms4 = device_ms(lambda: K.flash_attention(q4, k4, v4),
                    match="flash_attention_sm90_kernel<", n=5, warm=1)
    plain4 = device_ms(lambda: flash_attention_ref(q4, k4, v4), n=5, warm=1)
    nops = 4 * B * H * D * S * (S + 1) // 2      # causal pairs, 2 dots each
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KH * S * D)
    row = dict(
        name="flash_attention", route="cuda",
        kernel="flash_attention_sm90_kernel",
        source="src/repro_torch/kernels/flash_attention/csrc/"
               "flash_attention_sm90.cu",
        replaces="src/repro/kernels/flash_attention/kernel.py:74",
        max_abs_err=max_abs_err(errs), ms=ms, plain_ms=plain4,
        plain_S=FLASH_PLAIN_S, ms_at_plain_S=ms4, simt_f32_ms=simt_ms,
        library_ms=lib_ms, library_f32_ms=lib32_ms, bytes=nbytes, ops=nops,
        **train, **families)
    # The operands are bf16: both products at the tensor cores' bf16 rate
    # (QK^T of bf16 operands is exact in float32 accumulation; P.V at that
    # rate takes P in bf16, as SDPA does), the least the card could take.
    # The kernel's own floor runs P.V twice (p_hi and p_lo): 1.5x the work;
    # it is logged beside the bound, which alone goes into the table.
    row["bound_ms"], row["bound_by"] = bound_of(nbytes, nops, peaks,
                                                "bfloat16")
    # The CUDA-core kernel's float32 bound: the same operations at the
    # card's float32 rate (twice the bytes), what rule 2 ranks it by.
    row["simt_f32_bound_ms"], simt_by = bound_of(2 * nbytes, nops, peaks,
                                                 "float32")
    split_p_floor_ms = 1.5 * nops / peaks["bfloat16"] * 1e3
    log(f"kernel flash_attention (sm90) at B={B}, H={H}, KH={KH}, S={S}, "
        f"D={D}, bf16, causal: {ms:.4f} ms on the card ({nops / ms / 1e9:.2f}"
        f" TFLOP/s), bound {row['bound_ms']:.4f} ms by {row['bound_by']} "
        f"({nops} flops at the bf16 tensor-core rate, {nbytes} B), the "
        f"design's split-P floor {split_p_floor_ms:.4f} ms; SDPA (library, "
        f"is_causal, enable_gqa) {lib_ms:.4f} ms; the CUDA-core kernel in "
        f"float32 at the same shape {simt_ms:.4f} ms (simt_f32_ms; its "
        f"float32 bound {row['simt_f32_bound_ms']:.4f} ms by {simt_by}, "
        f"simt_f32_bound_ms), SDPA "
        f"in float32 there (memory-efficient backend, kv heads repeated "
        f"before the call) {lib32_ms:.4f} ms (library_f32_ms); float32 "
        f"row windows within {rows32_err:.3e} of a plain computation (at "
        f"most {rows32_use:.3f} of the {FLASH_TOL['float32']} gate), two "
        f"calls bit-identical; "
        f"{len(windows)} row windows ({sum(n for _, n in windows)} rows, "
        f"first rows {[r for r, _ in windows]}) within {rows_err:.3e} of a "
        f"plain computation, at most {rows_use:.3f} of the bf16 rounding "
        f"gate.  At S={FLASH_PLAIN_S} (plain_S): kernel {ms4:.4f} ms "
        f"(ms_at_plain_S), plain version {plain4:.4f} ms (plain_ms; its "
        f"scores do not fit at S={S})")
    return row


def flash_train(gen, dev, peaks, tol):
    """The CUDA-core kernel at the float32 training step's shape
    (FLASH_TRAIN_SHAPE, causal): against the plain version within ``tol``,
    two calls bit-identical; its device time beside the plain version's,
    SDPA's float32 kernel (memory-efficient backend, kv heads repeated
    before the timed call) and its float32 bound.  Returns the row's
    `simt_f32_train_*` and `plain_f32_train_ms` keys and the (out, plain)
    pair."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, H, KH, S, D = FLASH_TRAIN_SHAPE
    q, k, v = flash_inputs(gen, B, H, KH, S, D, torch.float32, dev)
    before = K.flash_attention.launches
    out = K.flash_attention(q, k, v)
    again = K.flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    check(K.flash_attention.launches == before + 2,
          "the training shape did not launch the CUDA-core kernel twice")
    check(bits_equal(out, again),
          f"the CUDA-core kernel at {FLASH_TRAIN_SHAPE}: two calls differ")
    err = max_abs_err([(out, ref)])
    check(within(out, ref, *tol), f"the CUDA-core kernel at "
          f"{FLASH_TRAIN_SHAPE} float32 differs from its plain version by "
          f"{err:.3e} (tolerance {tol[0]})")
    ms = device_ms(lambda: K.flash_attention(q, k, v),
                   match="flash_attention_kernel<")
    plain_ms = device_ms(lambda: flash_attention_ref(q, k, v), n=20, warm=3)
    kr, vr = (t.repeat_interleave(H // KH, dim=1) for t in (k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib_ms = device_ms(lambda: F.scaled_dot_product_attention(
            q, kr, vr, is_causal=True))
    nops = 4 * B * H * D * S * (S + 1) // 2
    nbytes = 4 * (2 * B * H * S * D + 2 * B * KH * S * D)
    bound, by = bound_of(nbytes, nops, peaks, "float32")
    log(f"the CUDA-core kernel at the training shape {FLASH_TRAIN_SHAPE} "
        f"(B, H, KH, S, D), float32, causal: {ms:.4f} ms on the card "
        f"(simt_f32_train_ms; {nops / ms / 1e9:.2f} TFLOP/s), bound "
        f"{bound:.4f} ms by {by} ({nops} flops, {nbytes} B; "
        f"simt_f32_train_bound_ms), plain version {plain_ms:.4f} ms "
        f"(plain_f32_train_ms), SDPA float32 {lib_ms:.4f} ms "
        f"(library_f32_train_ms); within {err:.3e} of the plain version, "
        f"two calls bit-identical")
    return dict(simt_f32_train_ms=ms, plain_f32_train_ms=plain_ms,
                library_f32_train_ms=lib_ms, simt_f32_train_bound_ms=bound,
                pair=(out, ref))


def flash_families(gen, dev):
    """FLASH_FAMILY_CASES through the kernel each dtype selects (the
    counters must show it), each against the plain version within
    FLASH_TOL, bfloat16 also within bf16 rounding of the float32 plain
    result, and each called twice with bit-identical outputs.  Returns the
    largest errors by case and the (out, plain) pairs."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    atol, rtol = FLASH_BF16_ROUNDING
    pairs, worst = [], {}
    for what, B, H, KH, S, T, D, causal, window in FLASH_FAMILY_CASES:
        for name, tol in FLASH_TOL.items():
            dtype = getattr(torch, name)
            q = torch.randn((B, H, S, D), generator=gen, device=dev).to(dtype)
            k, v = (torch.randn((B, KH, T, D), generator=gen,
                                device=dev).to(dtype) for _ in range(2))
            before = (K.flash_attention.launches,
                      K.flash_attention.launches_sm90)
            out = K.flash_attention(q, k, v, causal=causal, window=window)
            again = K.flash_attention(q, k, v, causal=causal, window=window)
            ref = flash_attention_ref(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            sm90 = K.uses_sm90(dtype, D)
            check((K.flash_attention.launches,
                   K.flash_attention.launches_sm90) ==
                  (before[0] + 2 * (not sm90), before[1] + 2 * sm90),
                  f"flash_attention, {what} {name}: not two launches of the "
                  f"{'sm90' if sm90 else 'CUDA-core'} kernel")
            check(bits_equal(out, again),
                  f"flash_attention, {what} {name}: two calls differ")
            err = max_abs_err([(out, ref)])
            shape = (B, H, KH, S, T, D, causal, window)
            check(within(out, ref, tol, tol),
                  f"flash_attention, {what} {shape} {name}: max abs "
                  f"{err:.3e} from the plain version (tolerance {tol})")
            if dtype == torch.bfloat16:
                ref32 = flash_attention_ref(q.float(), k.float(), v.float(),
                                            causal=causal, window=window)
                check(within(out, ref32, atol, rtol),
                      f"flash_attention, {what} bf16: off the float32 plain "
                      f"result by more than bf16 rounding "
                      f"({max_abs_err([(out, ref32)]):.3e})")
            pairs.append((out, ref))
            worst[f"{what},{name}"] = err
    log("flash, the families' shapes (FLASH_FAMILY_CASES: gemma3 window "
        "1024 at D=128, qwen1.5 G=1 at D=128, seamless cross-attention S=1 "
        "and 512 against T=1,500, and the shapes of phases 20-23's paths), "
        "max abs error against the plain version, two calls bit-identical: "
        + json.dumps({k: f"{v:.3e}" for k, v in worst.items()}))
    return {"pairs": pairs}


def flash_gemma(gen, dev, peaks):
    """The sm90 kernel at gemma3's prefill shape (GEMMA_FLASH_SHAPE, bf16),
    its global layer (causal) and its windowed one (GEMMA_WINDOW): the rows
    of `flash_windows` against a plain computation within bf16 rounding,
    device ms beside the bound (the pairs this input's masks keep, both
    products at the bf16 tensor-core rate) and beside SDPA (global:
    is_causal, enable_gqa; windowed: an explicit boolean mask, kv heads
    repeated, the memory-efficient backend pinned, the only one that takes
    a mask without materialising the scores; where it does not run, its
    time is None and the reason logged).  Returns the row's `gemma_*`
    keys."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import key_mask
    B, H, KH, S, D = GEMMA_FLASH_SHAPE
    q, k, v = flash_inputs(gen, B, H, KH, S, D, torch.bfloat16, dev)
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KH * S * D)
    out = {}
    for name, window in (("global", None), ("window", GEMMA_WINDOW)):
        o = K.flash_attention(q, k, v, window=window)
        err, use, windows = check_windows(o, q, k, v, f"gemma3's {name} "
                                          f"layer shape", window=window)
        del o
        ms = device_ms(lambda: K.flash_attention(q, k, v, window=window),
                       match="flash_attention_sm90_kernel<", n=5, warm=2)
        W = S if window is None else window
        pairs = W * (W + 1) // 2 + (S - W) * W
        nops = 4 * B * H * D * pairs
        bound, by = bound_of(nbytes, nops, peaks, "bfloat16")
        if window is None:
            lib = device_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), n=5, warm=2)
            lib_how = "is_causal, enable_gqa"
        else:
            lib_how = ("boolean mask, kv heads repeated, memory-efficient "
                       "backend")
            try:
                kr, vr = (t.repeat_interleave(H // KH, dim=1)
                          for t in (k, v))
                mask = key_mask(S, S, causal=True, window=window, device=dev)
                with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                    lib = device_ms(lambda: F.scaled_dot_product_attention(
                        q, kr, vr, attn_mask=mask), n=5, warm=2)
            except (torch.OutOfMemoryError, RuntimeError) as e:
                lib = None
                lib_how += f": did not run ({str(e)[:120]})"
            kr = vr = mask = None
            torch.cuda.empty_cache()
        out.update({f"gemma_{name}_ms": ms, f"gemma_{name}_bound_ms": bound,
                    f"gemma_{name}_library_ms": lib})
        log(f"kernel flash_attention (sm90) at gemma3's {name} layer "
            f"(B={B}, H={H}, KH={KH}, S={S}, D={D}, bf16, causal, window "
            f"{window}): {ms:.4f} ms on the card ({nops / ms / 1e9:.2f} "
            f"TFLOP/s), bound {bound:.4f} ms by {by} ({nops} flops over "
            f"{pairs} (query, key) pairs at the bf16 tensor-core rate, "
            f"{nbytes} B); SDPA ({lib_how}) "
            f"{'not measured' if lib is None else f'{lib:.4f} ms'}; "
            f"{len(windows)} row windows within {err:.3e} of a plain "
            f"computation, at most {use:.3f} of the bf16 rounding gate")
    return out


def flash_zamba(gen, dev, peaks):
    """Both kernels at head dim 80, zamba's shared block (32 heads over
    32): the sm90 kernel at ZAMBA_FLASH_PREFILL (bf16, causal), twice
    bit-identical, the rows of `flash_windows` against a plain float32
    computation within bf16 rounding (inside FLASH_TOL's 2e-2), device ms
    beside its bound (D=80's own work at the bf16 tensor-core rate; the
    kernel runs a 128-column tile) and SDPA (bf16, is_causal); the
    CUDA-core kernel at ZAMBA_FLASH_TRAIN (float32, causal) against the
    plain version within FLASH_TOL, twice bit-identical, device ms beside
    its float32 bound, the plain version and SDPA's float32 kernel.
    Returns the row's `zamba_*` keys and the (out, plain) pairs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, H, KH, S, D = ZAMBA_FLASH_PREFILL
    q, k, v = flash_inputs(gen, B, H, KH, S, D, torch.bfloat16, dev)
    before = K.flash_attention.launches_sm90
    out = K.flash_attention(q, k, v)
    check(bits_equal(out, K.flash_attention(q, k, v)) and
          K.flash_attention.launches_sm90 == before + 2,
          f"the sm90 kernel at {ZAMBA_FLASH_PREFILL}: two calls differ or "
          f"did not launch it twice")
    err, use, windows = check_windows(out, q, k, v, "zamba's prefill shape")
    del out
    ms = device_ms(lambda: K.flash_attention(q, k, v),
                   match="flash_attention_sm90_kernel<", n=5, warm=2)
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), n=5, warm=2)
    nops = 4 * B * H * D * S * (S + 1) // 2
    nbytes = 2 * (2 * B * H * S * D + 2 * B * KH * S * D)
    bound, by = bound_of(nbytes, nops, peaks, "bfloat16")
    log(f"kernel flash_attention (sm90) at zamba's prefill shape (B={B}, "
        f"H={H}, KH={KH}, S={S}, D={D}, bf16, causal; the D=128 tile over "
        f"80 columns): {ms:.4f} ms on the card ({nops / ms / 1e9:.2f} "
        f"TFLOP/s of D=80's work), bound {bound:.4f} ms by {by} ({nops} "
        f"flops, {nbytes} B; zamba_prefill_bound_ms); SDPA (is_causal) "
        f"{lib:.4f} ms (zamba_prefill_library_ms); {len(windows)} row "
        f"windows within {err:.3e} of a plain computation, at most "
        f"{use:.3f} of the bf16 rounding gate; two calls bit-identical")
    del q, k, v
    B, H, KH, S, D = ZAMBA_FLASH_TRAIN
    q, k, v = flash_inputs(gen, B, H, KH, S, D, torch.float32, dev)
    before = K.flash_attention.launches
    out = K.flash_attention(q, k, v)
    again = K.flash_attention(q, k, v)
    ref = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    check(K.flash_attention.launches == before + 2 and
          bits_equal(out, again), f"the CUDA-core kernel at "
          f"{ZAMBA_FLASH_TRAIN}: two calls differ or did not launch it twice")
    err32 = max_abs_err([(out, ref)])
    tol = FLASH_TOL["float32"]
    check(within(out, ref, tol, tol), f"the CUDA-core kernel at "
          f"{ZAMBA_FLASH_TRAIN} differs from its plain version by "
          f"{err32:.3e} (tolerance {tol})")
    ms32 = device_ms(lambda: K.flash_attention(q, k, v),
                     match="flash_attention_kernel<")
    plain32 = device_ms(lambda: flash_attention_ref(q, k, v), n=20, warm=3)
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        lib32 = device_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
    nops32 = 4 * B * H * D * S * (S + 1) // 2
    bound32, by32 = bound_of(4 * (2 * B * H * S * D + 2 * B * KH * S * D),
                             nops32, peaks, "float32")
    log(f"the CUDA-core kernel at zamba's training shape "
        f"{ZAMBA_FLASH_TRAIN} (B, H, KH, S, D), float32, causal: "
        f"{ms32:.4f} ms on the card ({nops32 / ms32 / 1e9:.2f} TFLOP/s; "
        f"{K.occupancy(torch.float32, D)} CTA an SM), bound {bound32:.4f} ms "
        f"by {by32} ({nops32} flops; zamba_train_f32_bound_ms), plain "
        f"version {plain32:.4f} ms, SDPA float32 {lib32:.4f} ms; within "
        f"{err32:.3e} of the plain version, two calls bit-identical")
    return {"zamba_prefill_ms": ms, "zamba_prefill_bound_ms": bound,
            "zamba_prefill_library_ms": lib, "zamba_train_f32_ms": ms32,
            "zamba_train_f32_bound_ms": bound32,
            "zamba_train_plain_f32_ms": plain32,
            "zamba_train_library_f32_ms": lib32, "pairs": [(out, ref)]}


def flash_mla(gen, dev, peaks):
    """The sm90 kernel's (192, 128) instance at Moonlight's latent
    attention (MLA_FLASH_SHAPE, bf16, causal; the scale 1/sqrt(192) the
    q/k head dim sets), on the sm90 path, twice bit-identical; the rows of
    `flash_windows` against a plain float32 computation on the same bf16
    inputs within bf16 rounding (the other sm90 instances' gate); device
    ms beside the bound (both products at the bf16 tensor-core rate over
    the causal pairs; q, k, v and o once) and beside SDPA (is_causal, its
    own choice of backend); and at MLA_PLAIN_S the kernel and the plain
    version (`flash_attention_ref`, float32 math) on the same inputs.
    Returns the row's `mla_*` keys."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    B, H, S, D, Dv = MLA_FLASH_SHAPE
    q, k, v = (torch.randn((B, H, S, d), generator=gen, device=dev)
               .to(torch.bfloat16) for d in (D, D, Dv))
    before = flash_launches()
    out = K.flash_attention(q, k, v)
    torch.cuda.synchronize()
    got = flash_launches()
    check(got == {"sm90": before["sm90"] + 1, "simt": before["simt"]} and
          tuple(out.shape) == (B, H, S, Dv) and out.dtype == torch.bfloat16,
          f"flash_attention at q/k {D}, v {Dv}: launches {before} -> {got}, "
          f"output {tuple(out.shape)} {out.dtype}; expected one sm90 launch "
          f"and a bf16 [B, H, S, {Dv}] output")
    check(bits_equal(out, K.flash_attention(q, k, v)),
          f"the sm90 kernel at {MLA_FLASH_SHAPE}: two calls differ")
    err, use, windows = check_windows(out, q, k, v, "Moonlight's MLA shape")
    del out
    ms = device_ms(lambda: K.flash_attention(q, k, v),
                   match="flash_attention_sm90_kernel<", n=5, warm=2)
    lib = device_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), n=5, warm=2)
    nops = 2 * B * H * (D + Dv) * S * (S + 1) // 2
    nbytes = 2 * B * H * S * (2 * D + 2 * Dv)
    bound, by = bound_of(nbytes, nops, peaks, "bfloat16")
    q4, k4, v4 = (t[:, :, :MLA_PLAIN_S] for t in (q, k, v))
    ms4 = device_ms(lambda: K.flash_attention(q4, k4, v4),
                    match="flash_attention_sm90_kernel<", n=5, warm=1)
    plain4 = device_ms(lambda: flash_attention_ref(q4, k4, v4), n=3, warm=1)
    log(f"kernel flash_attention (sm90) at Moonlight's MLA (B={B}, H={H}, "
        f"S={S}, q/k {D}, v {Dv}, bf16, causal): {ms:.4f} ms on the card "
        f"({nops / ms / 1e9:.2f} TFLOP/s, {bound / ms:.4f} of the bound), "
        f"bound {bound:.4f} ms by {by} ({nops} flops at the bf16 "
        f"tensor-core rate, {nbytes} B; mla_bound_ms); SDPA (is_causal) "
        f"{lib:.4f} ms (mla_library_ms); {len(windows)} row windows within "
        f"{err:.3e} of a plain float32 computation, at most {use:.3f} of "
        f"the bf16 rounding gate; two calls bit-identical.  At "
        f"S={MLA_PLAIN_S}, all {B} rows, the same inputs: kernel "
        f"{ms4:.4f} ms (mla_ms_at_plain_S), plain version {plain4:.4f} ms "
        f"(mla_plain_ms)")
    return {"mla_ms": ms, "mla_bound_ms": bound, "mla_library_ms": lib,
            "mla_plain_ms": plain4, "mla_ms_at_plain_S": ms4}


def first_layer(params):
    """The first block's params of a decoder stack: layer 0 of "layers",
    or the first local layer of the local/global pattern."""
    from repro_torch.models.transformer import layer
    stack = params["stack"]
    if "layers" in stack:
        return layer(stack["layers"], 0)
    return layer(layer(stack["local"], 0), 0)


def phase_flash_projections(cfg, params, toks):
    """The rows of `flash_windows` held to a plain computation within
    FLASH_BF16_ROUNDING on the q, k and v that the first layer of ``cfg``
    projects (norm, projections, RoPE) from ``toks`` in bfloat16, passed
    as the attention layer passes them, with that layer's window."""
    import torch
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.models.attention import _project_qkv
    from repro_torch.models.common import embed, norm
    window = cfg.window              # the first layer's (a local one's)
    with torch.inference_mode():
        x = embed(cfg, params["embed"], toks, torch.bfloat16)
        p0 = first_layer(params)
        pos = torch.arange(toks.shape[1], device=toks.device)[None, :]
        q, k, v = (t.contiguous().transpose(1, 2) for t in _project_qkv(
            cfg, p0["attn"], norm(cfg, x, p0.get("ln1")), pos))
        before = K.flash_attention.launches_sm90
        out = K.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        check(K.flash_attention.launches_sm90 == before + 1,
              "layer 1's projections did not go through the sm90 kernel")
        err, use, windows = check_windows(
            out, q, k, v, f"{cfg.name} layer 1's projections",
            window=window)
    log(f"flash_attention (sm90) on {cfg.name} layer 1's q, k, v at "
        f"S={toks.shape[1]}, window {window} (|q| max "
        f"{float(q.abs().max()):.3f}, |k| max "
        f"{float(k.abs().max()):.3f}): {len(windows)} row windows within "
        f"{err:.3e} of a plain computation, at most {use:.3f} of the bf16 "
        f"rounding gate")


def phase_prefill(dev):
    """granite-moe-1b-a400m at full width through `make_prefill_step` at
    B=PREFILL_B, S=PREFILL_S, bfloat16 activations: a warm-up at a short
    S, 2 timed prefills with the launch counters read around them (every
    attention through the sm90 flash kernel, none through the CUDA-core
    one), then one profiled prefill through `ModelAPI.logits` (the
    function the step wraps), which also returns the new router queues;
    last, `phase_flash_projections` on the same weights and tokens."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.kernels.bp_topk import kernel as TK
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.models import get_model
    from repro_torch.models.transformer import layer
    from repro_torch.runtime.step import make_prefill_step
    t0 = time.perf_counter()
    cfg, params = serve_model(dev)
    api = get_model(cfg)
    rcfg = RunConfig(cfg, SHAPES["prefill_32k"])
    check(rcfg.activ_dtype == "bfloat16", "the run's default activations")
    step = make_prefill_step(rcfg)
    H = api.init_state(device=dev).router_H
    rng = np.random.default_rng(0)
    warm = torch.as_tensor(rng.integers(0, cfg.vocab, (PREFILL_B,
                                                       PREFILL_WARM_S)),
                           device=dev)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (PREFILL_B,
                                                       PREFILL_S)),
                           device=dev)
    step(params, {"tokens": warm}, H)
    torch.cuda.synchronize()
    log(f"prefill: {cfg.name} full width ({cfg.n_layers} layers), weights "
        f"and a warm-up at S={PREFILL_WARM_S} in "
        f"{time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    FK.flash_attention.launches = 0
    FK.flash_attention.launches_sm90 = 0
    TK.bp_topk.launches = 0
    TK.bp_topk_route.launches = 0
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = step(params, {"tokens": toks}, H)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    launches = {"flash_attention_sm90": FK.flash_attention.launches_sm90,
                "flash_attention": FK.flash_attention.launches,
                "bp_topk_route": TK.bp_topk_route.launches,
                "bp_topk": TK.bp_topk.launches}
    check(launches == {"flash_attention_sm90": 2 * cfg.n_layers,
                       "flash_attention": 0,
                       "bp_topk_route": 2 * cfg.n_layers, "bp_topk": 0},
          f"launches {launches} in 2 prefills, expected {cfg.n_layers} of "
          f"the sm90 flash kernel and of bp_topk_route per prefill, none of "
          f"the CUDA-core flash kernel or of the standalone bp_topk")
    check(tuple(logits.shape) == (PREFILL_B, 1, cfg.vocab) and
          logits.dtype == torch.bfloat16 and
          bool(torch.isfinite(logits).all()),
          f"prefill logits {tuple(logits.shape)} {logits.dtype} not finite "
          f"or misshapen")
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            again, H_new, _ = api.logits(params, {"tokens": toks},
                                         activ_dtype=torch.bfloat16,
                                         remat="none", router_H=H,
                                         last_only=True)
        torch.cuda.synchronize()
    check(tuple(H_new.shape) == (cfg.n_layers, cfg.n_experts) and
          bool(torch.isfinite(H_new).all()) and bool((H_new >= 0).all()),
          "the new router queues must be finite and >= 0")
    med = statistics.median(walls)
    MEASURED["granite_prefill"] = {
        "ms": med, "state_bytes": state_bytes(params),
        "peak_bytes": peak * 2**30}
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if evs:
        dev_ms = sum(e.device_time for e in evs) / 1e3
        kinds = {}
        for e in evs:
            kinds[e.name] = kinds.get(e.name, 0) + e.device_time / 1e3
        top = sorted(kinds.items(), key=lambda kv: -kv[1])[:6]
        flash = sum(t for n, t in kinds.items() if "flash_attention" in n)
        gate = sum(t for n, t in kinds.items() if "bp_topk_route_" in n)
        busy = (f"{len(evs)} CUDA device activities, {dev_ms:.4f} ms of "
                f"device time, busy {dev_ms / med:.4f} of the unprofiled "
                f"prefill's {med:.4f} ms; flash attention {flash:.4f} ms "
                f"({flash / dev_ms:.4f} of the device time); bp_topk_route "
                f"{gate:.4f} ms; most time: " +
                "; ".join(f"{n[:50]} {t:.4f} ms" for n, t in top))
    else:
        busy = "device-busy share not measured (no device activity traced)"
    n_gate, gate_names = route_activities(
        cfg, layer(params["stack"]["layers"], 0)["moe"],
        torch.randn((PREFILL_B, PREFILL_S, cfg.d_model), device=dev,
                    dtype=torch.bfloat16),
        torch.zeros((cfg.n_experts,), device=dev))
    log(f"prefill: one layer's gate at the prefill shape (bf16): "
        f"{n_gate:.2f} CUDA activities per call "
        f"({', '.join(nm[:40] for nm in gate_names)})")
    log(f"prefill: B={PREFILL_B}, S={PREFILL_S}, bf16 activations, 2 "
        f"prefills {', '.join(f'{w:.4f}' for w in walls)} ms: {med:.4f} ms "
        f"per prefill, {PREFILL_B * PREFILL_S / med * 1e3:.2f} prefill "
        f"tokens/s; launches {launches}; peak device memory {peak:.2f} GiB; "
        f"profiled prefill: {busy}; its logits within "
        f"{max_abs_err([(again, logits)]):.3e} of the step's; new router "
        f"queues sum {float(H_new.sum()):.1f}, max {float(H_new.max()):.1f}, "
        f"{int((H_new > 0).sum())} of {H_new.numel()} positive")
    phase_flash_projections(cfg, params, toks)
    return launches


def recorded_sel(rec, cfg):
    """(picks [T, k], float64 sel [T, E]) of one recorded routing call
    (idx, x_flat, router weights, H): sel = softmax(x W) - H / C_e, the
    gate's selection score, recomputed on the CPU from the call's own
    float32 inputs."""
    import torch
    idx, x, w, h = (t.cpu() for t in rec)
    G, Tg, _ = x.shape
    cap = max(G * Tg * cfg.top_k / cfg.n_experts, 1.0)
    sel = torch.softmax(x.double() @ w.double(), -1) - h.double() / cap
    return idx.reshape(-1, cfg.top_k), sel.reshape(-1, cfg.n_experts)


def compare_routes(rec_dev, rec_cpu, cfg):
    """Rows whose picks differ between the card and the CPU, and whether
    each is a near-tie that the two devices' inputs explain: its smallest
    gap between adjacent sel values among the CPU's top k+1 is at most
    2 delta + NEAR_TIE_SLACK, delta the largest difference of any sel
    between the two devices in this call (two values cannot trade places
    unless their gap is below the sum of their changes).  Returns (rows,
    margins, delta, all explained)."""
    import torch
    i_d, s_d = recorded_sel(rec_dev, cfg)
    i_c, s_c = recorded_sel(rec_cpu, cfg)
    delta = float((s_d - s_c).abs().max())
    rows = (i_d != i_c).any(-1).nonzero()[:, 0]
    top = torch.sort(s_c[rows], -1, descending=True).values[:, :cfg.top_k + 1]
    margins = (top[:, :-1] - top[:, 1:]).min(-1).values
    ok = bool((margins <= 2 * delta + NEAR_TIE_SLACK).all())
    return rows, margins, delta, ok


def phase_prefill_reference(dev):
    """The prefill path on the card (flash attention, bp_topk_route)
    against the port's plain path on the CPU (sdpa, bp_topk_route's plain
    version), at full
    width and REF_LAYERS layers, B=PREFILL_REF_B, S=PREFILL_REF_S, float32,
    from the same weights and tokens.

    Teacher-forced, gated: layer by layer, both devices run `block_fwd`
    on the CPU's hidden state.  Every token picks the same experts on both,
    except a near-tie that the two devices' router inputs explain
    (`compare_routes`), which is counted and printed; every other token's
    output agrees within LAYER_RTOL of the layer's largest |output| (at
    these random weights the expert sums reach ~1e2, and float32 rounding
    of them is ~1e-6 of that); the new router queues are equal where
    no pick differs; and the logits of the CPU's final hidden state agree
    within LOGIT_ATOL (see phase_serve_ref for why 1e-4 catches a lost
    float32).

    Free-running, through the entry points (`ModelAPI.logits` and
    `make_prefill_step`): when no pick differs in any layer, the new
    router queues must be equal and the full and last-position logits
    within LOGIT_ATOL; a differing pick must be an explained near-tie, and
    then the logits, which the other expert changes for that token and,
    through attention, for the later ones, are reported only.  The card's
    forward, run again, must repeat bit for bit.  Why near-ties flip on
    one host and not another (`scripts/torch_prefill_repeat.py`): the card
    repeats itself bit for bit, also across processes, but the CPU's
    float32 results move with torch's thread count and MKL's code path,
    and these inputs hold gate scores 3e-8 to 3e-7 apart, less than the
    two devices' score difference."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.models import get_model, moe
    from repro_torch.models.common import embed, norm, unembed
    from repro_torch.models.transformer import block_fwd, layer
    from repro_torch.runtime.step import make_prefill_step
    t0 = time.perf_counter()
    cfg, params = serve_model(dev, n_layers=REF_LAYERS, seed=2)
    cpu = torch.device("cpu")
    params_cpu = to_device_tree(params, cpu)
    api = get_model(cfg)
    step = make_prefill_step(RunConfig(cfg, SHAPES["prefill_32k"],
                                       activ_dtype="float32"))
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (PREFILL_REF_B,
                                                            PREFILL_REF_S))
    f32 = torch.float32
    routed = []
    original = moe._route

    def recording_route(cfg_, p, x_flat, rs, *, use_kernel=False):
        out = original(cfg_, p, x_flat, rs, use_kernel=use_kernel)
        routed.append((out[0], x_flat, p["router"], rs.H))
        return out

    def run(fn, *args, **kw):
        routed.clear()
        out = fn(*args, **kw)
        return out, list(routed)

    moe._route = recording_route
    try:
        # teacher-forced
        H0 = api.init_state(device=cpu).router_H
        x = embed(cfg, params_cpu["embed"], torch.as_tensor(toks), f32)
        pos = torch.arange(PREFILL_REF_S)[None].expand(PREFILL_REF_B, -1)
        near, worst = [], 0.0
        for i in range(cfg.n_layers):
            (yc, Hc, _), rc = run(block_fwd, cfg, layer(
                params_cpu["stack"]["layers"], i), x, pos,
                window=cfg.window, router_H=H0[i])
            (yd, Hd, _), rd = run(block_fwd, cfg, layer(
                params["stack"]["layers"], i), x.to(dev), pos.to(dev),
                window=cfg.window, router_H=H0[i].to(dev))
            rows, margins, delta, ok = compare_routes(rd[0], rc[0], cfg)
            check(ok, f"prefill reference, teacher-forced layer {i}: "
                  f"{len(rows)} tokens pick other experts on the card, "
                  f"margins {margins.tolist()} against 2 x {delta:.3e}")
            near += [(i, int(r), float(m), delta)
                     for r, m in zip(rows, margins)]
            keep = torch.ones(PREFILL_REF_B * PREFILL_REF_S, dtype=bool)
            keep[rows] = False
            scale = float(yc.abs().max())
            d = max_abs_err([(yd.cpu().reshape(-1, cfg.d_model)[keep],
                              yc.reshape(-1, cfg.d_model)[keep])]) / scale
            check(d <= LAYER_RTOL, f"prefill reference, teacher-forced "
                  f"layer {i}: outputs differ by {d:.3e} of their largest "
                  f"magnitude {scale:.3f}")
            check(len(rows) > 0 or torch.equal(Hd.cpu(), Hc),
                  f"layer {i}: router queues differ with equal picks")
            worst = max(worst, d)
            x = yc
        lc = unembed(cfg, params_cpu["embed"], norm(
            cfg, x, params_cpu.get("ln_f")))
        xd = x.to(dev)
        ld = unembed(cfg, params["embed"], norm(cfg, xd, params.get("ln_f")))
        d_tf = max_abs_err([(ld.cpu(), lc)])
        check(d_tf <= LOGIT_ATOL, f"prefill reference, teacher-forced: "
              f"logits differ by {d_tf:.3e}")
        # free-running, through the entry points
        out, recs = {}, {}
        for d, p in ((dev, params), (cpu, params_cpu)):
            batch = {"tokens": torch.as_tensor(toks, device=d)}
            H0d = api.init_state(device=d).router_H
            (full, H, _), r1 = run(api.logits, p, batch, activ_dtype=f32,
                                   router_H=H0d)
            last, r2 = run(step, p, batch, H0d)
            out[d] = (full.cpu(), H.cpu(), last.cpu())
            recs[d] = r1 + r2
    finally:
        moe._route = original
    again, H_again, _ = api.logits(
        params, {"tokens": torch.as_tensor(toks, device=dev)},
        activ_dtype=f32, router_H=api.init_state(device=dev).router_H)
    check(bits_equal(again.cpu(), out[dev][0]) and
          bits_equal(H_again.cpu(), out[dev][1]),
          "prefill reference: the card's forward does not repeat bit for bit")
    check(len(recs[dev]) == len(recs[cpu]) == 2 * cfg.n_layers,
          f"{len(recs[dev])}/{len(recs[cpu])} routing calls")
    flips = []
    for i, (a, b) in enumerate(zip(recs[dev], recs[cpu])):
        rows, margins, delta, ok = compare_routes(a, b, cfg)
        check(ok, f"prefill reference, free-running call {i // cfg.n_layers}"
              f" layer {i % cfg.n_layers}: {len(rows)} tokens pick other "
              f"experts, margins {margins.tolist()} against 2 x "
              f"{delta:.3e}")
        flips += [(i // cfg.n_layers, i % cfg.n_layers, int(r), float(m),
                   delta) for r, m in zip(rows, margins)]
    (fa, Ha, la), (fb, Hb, lb) = out[dev], out[cpu]
    d_full, d_last = max_abs_err([(fa, fb)]), max_abs_err([(la, lb)])
    if not flips:
        check(torch.equal(Ha, Hb), f"router queues differ by "
              f"{float((Ha - Hb).abs().max())}")
        check(d_full <= LOGIT_ATOL and d_last <= LOGIT_ATOL,
              f"prefill reference: logits differ by {d_full:.3e} (full), "
              f"{d_last:.3e} (last position) > {LOGIT_ATOL}")
    log(f"prefill reference: {cfg.name} full width at {REF_LAYERS} layers, "
        f"B={PREFILL_REF_B}, S={PREFILL_REF_S}, float32, card vs CPU "
        f"({time.perf_counter() - t0:.1f} s).  Teacher-forced: outputs "
        f"within {worst:.3e} of each layer's largest |output| (gate "
        f"{LAYER_RTOL}), logits within {d_tf:.3e} (gate {LOGIT_ATOL}); "
        f"{len(near)} near-tie picks (layer, token, margin, delta) "
        f"{near[:8]}.  Free-running: {len(flips)} near-tie picks (call, "
        f"layer, token, margin, delta) {flips[:8]}; the card's forward "
        f"repeats bit for bit; router queues "
        f"{'equal' if torch.equal(Ha, Hb) else 'differ'}; logits within "
        f"{d_full:.3e} (full) and {d_last:.3e} (last position)"
        + ("" if flips else " (gated)") +
        f"; max |logit| {float(fb.abs().max()):.3f}")


def phase_prefill_bf16_layers(dev):
    """The bfloat16 prefill path at full width and REF_LAYERS layers, B=1,
    S=FLASH_PLAIN_S, through `ModelAPI.logits`.  Teacher-forced: each
    layer's attention output, as the sm90 kernel gave it inside the
    forward, is held to the plain version's float32 result on that layer's
    own q, k and v within FLASH_BF16_ROUNDING; every layer's attention
    must go through the sm90 kernel and the logits must be finite."""
    import numpy as np
    import torch
    from repro_torch.kernels.flash_attention import kernel as K
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models import attention as A
    from repro_torch.models import get_model
    t0 = time.perf_counter()
    cfg, params = serve_model(dev, n_layers=REF_LAYERS, seed=6)
    api = get_model(cfg)
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, FLASH_PLAIN_S)), device=dev)
    calls = []
    original = A.flash_attention_op

    def recording(q, k, v, **kw):
        out = original(q, k, v, **kw)
        calls.append((q, k, v, out, kw))
        return out

    atol, rtol = FLASH_BF16_ROUNDING
    before = (K.flash_attention.launches, K.flash_attention.launches_sm90)
    A.flash_attention_op = recording
    try:
        with torch.inference_mode():
            logits, _, _ = api.logits(
                params, {"tokens": toks}, activ_dtype=torch.bfloat16,
                router_H=api.init_state(device=dev).router_H)
            torch.cuda.synchronize()
    finally:
        A.flash_attention_op = original
    check((K.flash_attention.launches, K.flash_attention.launches_sm90) ==
          (before[0], before[1] + cfg.n_layers) and
          len(calls) == cfg.n_layers,
          f"bf16 prefill: {len(calls)} attention calls, launches "
          f"{K.flash_attention.launches - before[0]} (CUDA-core) and "
          f"{K.flash_attention.launches_sm90 - before[1]} (sm90), expected "
          f"{cfg.n_layers} sm90 launches only")
    errs, uses = [], []
    with torch.inference_mode():
        for i, (q, k, v, out, kw) in enumerate(calls):
            ref = flash_attention_ref(q.float(), k.float(), v.float(), **kw)
            err = (out.float() - ref).abs()
            errs.append(float(err.max()))
            uses.append(float((err / (atol + rtol * ref.abs())).max()))
            check(out.dtype == torch.bfloat16 and
                  within(out, ref, atol, rtol),
                  f"bf16 prefill, layer {i}: attention differs from the "
                  f"plain float32 result on its own q, k, v by "
                  f"{errs[-1]:.3e}, more than bf16 rounding ({atol} + "
                  f"{rtol} |ref|)")
            del ref, err
    check(tuple(logits.shape) == (1, FLASH_PLAIN_S, cfg.vocab) and
          bool(torch.isfinite(logits).all()),
          f"bf16 prefill logits {tuple(logits.shape)} not finite or "
          f"misshapen")
    log(f"bf16 prefill layers: {cfg.name} full width at {REF_LAYERS} layers,"
        f" B=1, S={FLASH_PLAIN_S}, bfloat16 activations "
        f"({time.perf_counter() - t0:.1f} s): each layer's sm90 attention "
        f"within {', '.join(f'{e:.3e}' for e in errs)} of the plain float32 "
        f"result on its own q, k, v, at most "
        f"{', '.join(f'{u:.3f}' for u in uses)} of the bf16 rounding gate; "
        f"logits finite, max |logit| {float(logits.abs().max()):.3f}")


# ---------------------------------------------------------------------------
# Phases 14-17: training
# ---------------------------------------------------------------------------

def tree_paths(tree, prefix: str = "") -> dict:
    """The leaves of a value tree (nested dicts) by "/"-joined key path."""
    if tree is None:
        return {}
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(tree_paths(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def rel_frobenius(a, b) -> float:
    """||a - b|| / ||b|| in float64 (||a - b|| when b is 0)."""
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    nb = float(b.norm())
    return float((a - b).norm()) / (nb if nb else 1.0)


def model_counts():
    """(CUDA-core flash, sm90 flash, bp_topk_route) launch counters."""
    from repro_torch.kernels.bp_topk import kernel as TK
    from repro_torch.kernels.flash_attention import kernel as FK
    return (FK.flash_attention.launches, FK.flash_attention.launches_sm90,
            TK.bp_topk_route.launches)


#: Kernel-name fragments by which a training step's device time is
#: grouped (first match wins; the rest is "other").
STEP_GROUPS = (("gemm", ("gemm", "Kernel2<cutlass", "nvjet")),
               ("flash", ("flash_attention",)),
               ("gate", ("bp_topk_route",)),
               ("index", ("index", "gather", "scatter")),
               ("reduce", ("reduce", "softmax", "logsumexp")),
               ("elementwise", ("elementwise", "vectorized")))


def profile_summary(prof, wall_ms: float, top_n: int = 5) -> str:
    """Activities, device ms, busy share of ``wall_ms`` (an unprofiled
    step's), device ms by STEP_GROUPS and the ``top_n`` kernels by device
    time of a profiler trace."""
    import torch
    evs = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return "device-busy share not measured (no device activity traced)"
    dev_ms = sum(e.device_time for e in evs) / 1e3
    kinds, groups = {}, {}
    for e in evs:
        kinds[e.name] = kinds.get(e.name, 0) + e.device_time / 1e3
        g = next((g for g, keys in STEP_GROUPS
                  if any(k in e.name for k in keys)), "other")
        groups[g] = groups.get(g, 0) + e.device_time / 1e3
    top = sorted(kinds.items(), key=lambda kv: -kv[1])[:top_n]
    return (f"{len(evs)} CUDA device activities, {dev_ms:.4f} ms of device "
            f"time, busy {dev_ms / wall_ms:.4f} of an unprofiled step's "
            f"{wall_ms:.4f} ms; by group: " +
            ", ".join(f"{g} {t:.4f} ms ({t / dev_ms:.4f})" for g, t in
                      sorted(groups.items(), key=lambda kv: -kv[1])) +
            "; top kernels: " +
            "; ".join(f"{n[:60]} {t:.4f} ms ({t / dev_ms:.4f})"
                      for n, t in top))


class StepRecorder:
    """Wraps a `make_train_step` (``record(make_train_step)``) so that each
    step is timed on the host clock around a synchronised step, its flash
    and gate launches counted and its loss kept.  After the first step
    every leaf's first AdamW moment is read: m = (1 - b1) * clip * g after
    one step from zero, so a finite, non-zero m is a finite, non-zero
    gradient.  The step numbered ``profile_at`` (from 0) runs under the
    profiler; its time is kept apart."""

    def __init__(self, profile_at=None):
        self.ms, self.losses, self.launches = [], [], []
        self.m_after_1, self.H, self.prof = None, None, None
        self.profile_at, self.profiled_ms = profile_at, None
        self.state_bytes = None

    def record(self, original):
        import torch
        from torch.profiler import ProfilerActivity, profile

        def make_train_step(rcfg, optimizer=None):
            step = original(rcfg, optimizer)

            def recorded(state, batch):
                n = len(self.losses)
                if n == 0:
                    self.state_bytes = state_bytes(state)
                torch.cuda.synchronize()
                before = model_counts()
                t0 = time.perf_counter()
                if n == self.profile_at:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as p:
                        new, m = step(state, batch)
                        torch.cuda.synchronize()
                    self.prof = p
                    self.profiled_ms = (time.perf_counter() - t0) * 1e3
                else:
                    new, m = step(state, batch)
                    torch.cuda.synchronize()
                    self.ms.append((time.perf_counter() - t0) * 1e3)
                self.launches.append(tuple(
                    a - b for a, b in zip(model_counts(), before)))
                self.losses.append(float(m["loss"]))
                if n == 0:
                    self.m_after_1 = {
                        k: (bool(torch.isfinite(v).all()),
                            float(v.abs().max()), float(v.norm()),
                            v.numel())
                        for k, v in tree_paths(new.opt.m).items()}
                if new.router_H is not None:
                    self.H = new.router_H.clone()
                return new, m
            return recorded
        return make_train_step


def phase_train(dev):
    """granite-moe-1b-a400m at full width (24 layers, random float32
    weights from a seed) trained TRAIN_STEPS steps through the launcher
    (`launch.train.main`: float32 activations, B=TRAIN_B, S=TRAIN_S, remat
    full): finite losses, the mean of the last 4 below the mean of the
    first 4; the router queues finite, >= 0 and below steps x B x S x top_k
    (`tests/test_system.py:72`); every step 2 x 24 launches of the
    CUDA-core flash kernel and of bp_topk_route (full remat runs each
    block's forward again in the backward) and none of the sm90 kernel;
    after step 1 every parameter leaf's gradient finite and non-zero (read
    from its first moment).  Prints ms per step, tokens/s, peak memory and
    one profiled step.  Then `make_train_step` with RunConfig's default
    bfloat16 activations, remat none, B=TRAIN_BF16_B, TRAIN_BF16_STEPS
    steps: 24 launches of the sm90 kernel and of the gate per step, none
    of the CUDA-core kernel, finite losses.  Returns each kernel's
    launches in both runs."""
    import torch
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.launch import train as T
    from repro_torch.runtime.step import init_train_state, make_train_step
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    L = cfg.n_layers
    rec = StepRecorder(profile_at=TRAIN_PROFILE_STEP)
    original = T.make_train_step
    T.make_train_step = rec.record(original)
    torch.cuda.reset_peak_memory_stats()
    try:
        losses = T.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                         "--batch", str(TRAIN_B), "--seq", str(TRAIN_S),
                         "--remat", "full", "--log-every", "1"])
    finally:
        T.make_train_step = original
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(losses == rec.losses and len(losses) == TRAIN_STEPS and
          all(math.isfinite(x) for x in losses),
          f"training losses not finite: {losses}")
    first, last = statistics.mean(losses[:4]), statistics.mean(losses[-4:])
    check(last < first, f"the loss did not fall: mean of the first 4 steps "
          f"{first:.5f}, of the last 4 {last:.5f}")
    H = rec.H
    bound = TRAIN_STEPS * TRAIN_B * TRAIN_S * cfg.top_k
    check(bool(torch.isfinite(H).all()) and bool((H >= 0).all()) and
          float(H.max()) < bound,
          f"router queues: max {float(H.max())} (bound {bound}), min "
          f"{float(H.min())}")
    want = (2 * L, 0, 2 * L)
    check(all(n == want for n in rec.launches),
          f"launches per step (CUDA-core flash, sm90 flash, bp_topk_route) "
          f"{rec.launches}, expected {want} each")
    bad = sorted(k for k, v in rec.m_after_1.items()
                 if not (v[0] and v[1] > 0))
    check(not bad, f"after step 1 these leaves have a zero or non-finite "
          f"gradient: {bad}")
    named = {k: v for k, v in rec.m_after_1.items()
             if k.rsplit("/", 1)[-1] in ("wq", "wk", "wv", "router")}
    check(len(named) == 4, f"leaves named: {sorted(named)}")
    ms = statistics.median(rec.ms[1:])
    MEASURED["granite_train"] = {"ms": ms, "state_bytes": rec.state_bytes,
                                 "peak_bytes": peak * 2**30}
    log(f"train: {cfg.name} full width ({L} layers), float32, B={TRAIN_B}, "
        f"S={TRAIN_S}, remat full, {TRAIN_STEPS} steps through "
        f"launch.train.main ({time.perf_counter() - t0:.1f} s): losses "
        f"{', '.join(f'{x:.5f}' for x in losses)} (first 4 mean "
        f"{first:.5f}, last 4 {last:.5f}); {ms:.4f} ms per step (median of "
        f"the unprofiled steps 2-{TRAIN_STEPS}; step 1 {rec.ms[0]:.1f} ms; "
        f"all {', '.join(f'{x:.1f}' for x in rec.ms)}), "
        f"{TRAIN_B * TRAIN_S / ms * 1e3:.2f} tokens/s; peak device memory "
        f"{peak:.2f} GiB; launches per step {want} (CUDA-core flash, sm90 "
        f"flash, bp_topk_route); router queues max {float(H.max()):.1f} "
        f"(bound {bound}), sum {float(H.sum()):.1f}")
    log(f"train: after step 1 all {len(rec.m_after_1)} parameter leaves "
        f"have a finite, non-zero gradient; clip x |g| = |m| / (1 - b1) "
        f"for " + "; ".join(f"{k}: max {v[1] / 0.1:.3e}, norm "
                            f"{v[2] / 0.1:.3e}" for k, v in
                            sorted(named.items())))
    log(f"train: profiled step {TRAIN_PROFILE_STEP + 1} "
        f"({rec.profiled_ms:.1f} ms under the profiler): "
        f"{profile_summary(rec.prof, ms)}")
    launches = {"flash_attention": TRAIN_STEPS * 2 * L,
                "bp_topk_route": TRAIN_STEPS * 2 * L}
    del rec
    torch.cuda.empty_cache()

    t1 = time.perf_counter()
    rcfg = RunConfig(cfg, ShapeConfig("train", TRAIN_S, TRAIN_BF16_B,
                                      "train"), remat="none")
    check(rcfg.activ_dtype == "bfloat16", "RunConfig's default activations")
    state, _ = init_train_state(
        rcfg, torch.Generator(device=dev).manual_seed(1), device=dev)
    rec16 = StepRecorder()
    step = rec16.record(make_train_step)(rcfg)
    data = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_S,
                                  global_batch=TRAIN_BF16_B, seed=1))
    for i in range(TRAIN_BF16_STEPS):
        state, _ = step(state, data.batch(i))
    check(all(math.isfinite(x) for x in rec16.losses),
          f"bf16 training losses not finite: {rec16.losses}")
    check(all(n == (0, L, L) for n in rec16.launches),
          f"bf16 launches per step {rec16.launches}, expected {(0, L, L)}")
    log(f"train, bf16: make_train_step, RunConfig's default bfloat16 "
        f"activations, remat none, B={TRAIN_BF16_B}, S={TRAIN_S}, "
        f"{TRAIN_BF16_STEPS} steps ({time.perf_counter() - t1:.1f} s): "
        f"losses {', '.join(f'{x:.5f}' for x in rec16.losses)}; ms per step "
        f"{', '.join(f'{x:.1f}' for x in rec16.ms)}; launches per step "
        f"{rec16.launches[0]} (CUDA-core flash, sm90 flash, bp_topk_route)")
    del state, step
    torch.cuda.empty_cache()
    launches["flash_attention_sm90"] = TRAIN_BF16_STEPS * L
    launches["bp_topk_route"] += TRAIN_BF16_STEPS * L
    return launches


def fwd_bwd_ms(fn, inputs, grad, kernel: str):
    """(forward ms, backward ms) on the card of ``fn`` on ``inputs``: the
    forward is the one launch of ``kernel`` (`device_ms` with a match,
    which tolerates a record the profiler drops), the backward all the
    device activities of `torch.autograd.grad` of one retained forward
    with ``grad``, per call."""
    import torch
    leaves = [t.detach().requires_grad_() for t in inputs]
    with torch.no_grad():
        fwd = device_ms(lambda: fn(*inputs), match=kernel, n=5, warm=2)
    out = fn(*leaves)
    out = out[1] if isinstance(out, tuple) else out
    bwd = device_ms(lambda: torch.autograd.grad(out, leaves, grad,
                                                retain_graph=True),
                    n=10, warm=2)
    return fwd, bwd


def fwd_and_bwd_ms(fn, inputs, grad):
    """Device ms per call of ``fn``'s forward and backward together (all
    their activities)."""
    import torch
    leaves = [t.detach().requires_grad_() for t in inputs]
    return device_ms(lambda: torch.autograd.grad(fn(*leaves), leaves, grad),
                     n=10, warm=2)


def phase_train_grads(dev):
    """Each autograd Function of the training path on the card against
    autograd of its plain version on the card, on the q, k, v and router
    logits that layer 1 of granite at full width projects from the
    training batch (B=TRAIN_B, S=TRAIN_S, float32 weights from a seed):
    `FlashAttentionFn` in float32 (the CUDA-core kernel forward) with dq,
    dk, dv within TRAIN_GRAD_RTOL (Frobenius, relative); in bfloat16 (the
    sm90 kernel forward) within bf16 rounding, FLASH_BF16_ROUNDING, of the
    plain version's float32 gradient on the same values (the Function
    widens to float32 and rounds each gradient once); `BpTopkRouteFn`
    (bp_topk_route forward) with the same picks and weights bit for bit
    and d/dlogits within GATE_GRAD_ATOL.  Device ms of each forward and
    backward, beside SDPA's forward+backward at the same shapes, are
    printed as information."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.kernels.bp_topk.ops import bp_topk_route_fn
    from repro_torch.kernels.bp_topk.ref import bp_topk_route_ref
    from repro_torch.kernels.flash_attention.ops import flash_attention_fn
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    from repro_torch.models.attention import _project_qkv, attention
    from repro_torch.models.common import embed, norm
    from repro_torch.models.transformer import layer
    t0 = time.perf_counter()
    cfg, params = serve_model(dev, n_layers=1, seed=3)
    toks = torch.as_tensor(TokenStream(DataConfig(
        vocab=cfg.vocab, seq_len=TRAIN_S, global_batch=TRAIN_B)).batch(
        0)["tokens"][:, :-1], device=dev)
    p0 = layer(params["stack"]["layers"], 0)
    with torch.no_grad():
        x = embed(cfg, params["embed"], toks, torch.float32)
        pos = torch.arange(TRAIN_S, device=dev)[None].expand(TRAIN_B, -1)
        h = norm(cfg, x, p0.get("ln1"))
        q, k, v = (t.contiguous().transpose(1, 2)
                   for t in _project_qkv(cfg, p0["attn"], h, pos))
        x = x + attention(cfg, p0["attn"], h, pos)
        logits = (norm(cfg, x, p0.get("ln2")).reshape(-1, cfg.d_model)
                  @ p0["moe"]["router"]).contiguous()
    gen = torch.Generator(device=dev).manual_seed(5)
    g = torch.randn(q.shape, generator=gen, device=dev)

    def grads(fn, inputs, grad):
        leaves = [t.detach().requires_grad_() for t in inputs]
        out = fn(*leaves)
        return out.detach(), torch.autograd.grad(out, leaves, grad)

    def fn(*a):
        return flash_attention_fn(*a, causal=True)

    def ref(*a):
        return flash_attention_ref(*a, causal=True)

    before = model_counts()
    out, d_fn = grads(fn, (q, k, v), g)
    check(model_counts()[:2] == (before[0] + 1, before[1]),
          "the float32 Function did not launch the CUDA-core kernel once")
    out_ref, d_ref = grads(ref, (q, k, v), g)
    f32_err = [rel_frobenius(a, b) for a, b in zip(d_fn, d_ref)]
    check(max(f32_err) <= TRAIN_GRAD_RTOL and
          within(out, out_ref, FLASH_TOL["float32"], FLASH_TOL["float32"]),
          f"FlashAttentionFn float32: dq, dk, dv off the plain version's by "
          f"{f32_err} (Frobenius, relative; gate {TRAIN_GRAD_RTOL}), forward "
          f"by {max_abs_err([(out, out_ref)]):.3e}")
    qb, kb, vb, gb = (t.to(torch.bfloat16) for t in (q, k, v, g))
    before = model_counts()
    out_b, d_b = grads(fn, (qb, kb, vb), gb)
    check(model_counts()[:2] == (before[0], before[1] + 1),
          "the bf16 Function did not launch the sm90 kernel once")
    _, d_32 = grads(ref, (qb.float(), kb.float(), vb.float()), gb.float())
    atol, rtol = FLASH_BF16_ROUNDING
    bf16_err = [max_abs_err([(a, b)]) for a, b in zip(d_b, d_32)]
    check(all(a.dtype == torch.bfloat16 and within(a, b, atol, rtol)
              for a, b in zip(d_b, d_32)),
          f"FlashAttentionFn bf16: gradients off the float32 plain gradient "
          f"by {bf16_err}, more than bf16 rounding ({atol} + {rtol} |ref|)")
    rounded = all(torch.equal(a, b.to(torch.bfloat16))
                  for a, b in zip(d_b, d_32))

    E, kk, T = cfg.n_experts, cfg.top_k, logits.shape[0]
    H = torch.arange(E, dtype=torch.float32, device=dev) * (T * kk / E / E)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    gw = torch.randn((T, kk), generator=gen, device=dev)

    def gate(lg):
        return bp_topk_route_fn(lg, H, steps, T * kk / E, kk, True)

    def gate_ref(lg):
        return bp_topk_route_ref(lg, H, steps, T * kk / E, kk, True)

    before = model_counts()[2]
    lk = logits.detach().requires_grad_()
    idx_k, w_k = gate(lk)[:2]
    (d_k,) = torch.autograd.grad(w_k, lk, gw)
    check(model_counts()[2] == before + 1,
          "BpTopkRouteFn did not launch bp_topk_route once")
    lr_ = logits.detach().requires_grad_()
    idx_r, w_r = gate_ref(lr_)[:2]
    (d_r,) = torch.autograd.grad(w_r, lr_, gw)
    gate_err = max_abs_err([(d_k, d_r)])
    check(torch.equal(idx_k, idx_r) and bits_equal(w_k, w_r) and
          gate_err <= GATE_GRAD_ATOL,
          f"BpTopkRouteFn: picks equal {torch.equal(idx_k, idx_r)}, weights "
          f"bit-equal {bits_equal(w_k, w_r)}, d/dlogits off autograd of the "
          f"plain version by {gate_err:.3e} (gate {GATE_GRAD_ATOL})")
    log(f"train grads: layer 1 of {cfg.name} at full width, B={TRAIN_B}, "
        f"S={TRAIN_S} ({time.perf_counter() - t0:.1f} s so far). "
        f"FlashAttentionFn float32 (CUDA-core forward): dq, dk, dv within "
        f"{', '.join(f'{e:.3e}' for e in f32_err)} of autograd of the plain "
        f"version (Frobenius, relative; gate {TRAIN_GRAD_RTOL}); bfloat16 "
        f"(sm90 forward): within {', '.join(f'{e:.3e}' for e in bf16_err)} "
        f"(max abs) of the float32 plain gradient, inside bf16 rounding "
        f"({atol} + {rtol} |ref|), "
        f"{'equal to it rounded to bf16 bit for bit' if rounded else 'not bit-equal to it rounded'}; "
        f"BpTopkRouteFn at T={T}, E={E}, k={kk}: picks and weights "
        f"bit-identical, d/dlogits within {gate_err:.3e} (gate "
        f"{GATE_GRAD_ATOL}), max |d/dlogits| {float(d_r.abs().max()):.3e}")

    times = {
        "FlashAttentionFn f32": fwd_bwd_ms(fn, (q, k, v), g,
                                           "flash_attention_kernel<"),
        "FlashAttentionFn bf16": fwd_bwd_ms(fn, (qb, kb, vb), gb,
                                            "flash_attention_sm90_kernel<"),
        "BpTopkRouteFn": fwd_bwd_ms(gate, (logits,), gw, "bp_topk_route_")}
    sdpa = {"bf16": fwd_and_bwd_ms(
        lambda a, b, c: F.scaled_dot_product_attention(
            a, b, c, is_causal=True, enable_gqa=True), (qb, kb, vb), gb)}
    k4, v4 = (t.repeat_interleave(cfg.n_heads // cfg.n_kv_heads, dim=1)
              for t in (k, v))
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        sdpa["f32 (memory-efficient, kv heads repeated)"] = fwd_and_bwd_ms(
            lambda a, b, c: F.scaled_dot_product_attention(
                a, b, c, is_causal=True), (q, k4, v4), g)
    log(f"train grads, device ms at these shapes (information): " +
        "; ".join(f"{k_} forward {a:.4f}, backward {b:.4f}"
                  for k_, (a, b) in times.items()) +
        "; SDPA forward+backward " + "; ".join(
            f"{k_} {t:.4f}" for k_, t in sdpa.items()) +
        f" ({time.perf_counter() - t0:.1f} s in all)")


def forced_route(cfg, p, x_flat, rs, idx):
    """`moe._route`'s output with the picks ``idx`` given (teacher
    forcing): the weights, counts and queues those picks imply, in plain
    torch, differentiable in the weights."""
    import torch
    from repro_torch.core.router import RouterState, expert_counts
    G, Tg, _ = x_flat.shape
    E, k = cfg.n_experts, cfg.top_k
    logits = torch.einsum("gtd,de->gte", x_flat,
                          p["router"].to(x_flat.dtype))
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    w = torch.gather(probs, -1, idx)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    counts = expert_counts(idx, E)
    cap = torch.full((), G * Tg * k / E, dtype=torch.float32,
                     device=x_flat.device)
    H_new = torch.clamp(rs.H + counts - cap, min=0.0)
    return (idx, w.to(x_flat.dtype), RouterState(H=H_new,
                                                 steps=rs.steps + 1),
            torch.zeros((), dtype=torch.float32, device=x_flat.device),
            counts)


def phase_train_reference(dev):
    """One `make_train_step` step on the card against the port's CPU path,
    at full width and TRAIN_REF_LAYERS layers, B=TRAIN_REF_B,
    S=TRAIN_REF_S, float32, remat none, from the same state and tokens.
    The picks of every layer are compared as `phase_prefill_reference`
    compares them: a differing pick must be a near-tie the two devices'
    router inputs explain (`compare_routes`); it is counted and printed,
    and that layer is teacher-forced to the CPU's picks on the card (the
    step runs again from the same state).  Then: the loss within
    TRAIN_LOSS_RTOL (relative), every leaf's first moment (the clipped
    gradient times 1 - b1), second moment and updated value within
    TRAIN_GRAD_RTOL (Frobenius, relative), the new router queues equal."""
    import dataclasses
    import torch
    from repro_torch.checkpoint.checkpointer import flatten, unflatten
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.data import DataConfig, TokenStream
    from repro_torch.models import moe
    from repro_torch.runtime.step import init_train_state, make_train_step
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH),
                              n_layers=TRAIN_REF_LAYERS)
    rcfg = RunConfig(cfg, ShapeConfig("train", TRAIN_REF_S, TRAIN_REF_B,
                                      "train"), activ_dtype="float32",
                     remat="none")
    state0, _ = init_train_state(
        rcfg, torch.Generator(device=dev).manual_seed(7), device=dev)

    def copy_of(d):
        return unflatten(state0, [t.to(d, copy=True)
                                  for t in flatten(state0)[0]])

    toks = TokenStream(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_REF_S,
                                  global_batch=TRAIN_REF_B, seed=7)).batch(0)
    step = make_train_step(rcfg)
    routed, forced = [], {}
    original = moe._route

    def route(cfg_, p, x_flat, rs, *, use_kernel=False):
        i = len(routed)
        out = original(cfg_, p, x_flat, rs, use_kernel=use_kernel)
        routed.append((out[0], x_flat.detach(), p["router"].detach(), rs.H))
        if i in forced:
            return forced_route(cfg_, p, x_flat, rs,
                                forced[i].to(x_flat.device))
        return out

    def run(d):
        routed.clear()
        new, m = step(copy_of(d), toks)
        return new, float(m["loss"]), list(routed)

    cpu = torch.device("cpu")
    moe._route = route
    try:
        new_c, loss_c, rec_c = run(cpu)
        near = []
        for _ in range(cfg.n_layers + 1):
            new_d, loss_d, rec_d = run(dev)
            check(len(rec_d) == len(rec_c) == cfg.n_layers,
                  f"{len(rec_d)}/{len(rec_c)} routing calls")
            flips = {}
            for i, (a, b) in enumerate(zip(rec_d, rec_c)):
                if i in forced:
                    continue
                rows, margins, delta, ok = compare_routes(a, b, cfg)
                check(ok, f"train reference, layer {i}: {len(rows)} tokens "
                      f"pick other experts on the card, margins "
                      f"{margins.tolist()} against 2 x {delta:.3e}")
                if len(rows):
                    flips[i] = rec_c[i][0]
                    near += [(i, int(r), float(mg), delta)
                             for r, mg in zip(rows, margins)]
            if not flips:
                break
            forced.update(flips)          # teacher-force and step again
    finally:
        moe._route = original
    check(abs(loss_d - loss_c) <= TRAIN_LOSS_RTOL * abs(loss_c),
          f"train reference: loss {loss_d!r} on the card, {loss_c!r} on the "
          f"CPU (gate {TRAIN_LOSS_RTOL} relative)")
    errs = {}
    for what, a, b in (("m", new_d.opt.m, new_c.opt.m),
                       ("v", new_d.opt.v, new_c.opt.v),
                       ("params", new_d.params, new_c.params)):
        for name, t in tree_paths(a).items():
            errs[f"{what}:{name}"] = rel_frobenius(t, tree_paths(b)[name])
    worst = max(errs.items(), key=lambda kv: kv[1])
    check(worst[1] <= TRAIN_GRAD_RTOL,
          f"train reference: {worst[0]} differs by {worst[1]:.3e} "
          f"(Frobenius, relative; gate {TRAIN_GRAD_RTOL})")
    check(torch.equal(new_d.router_H.cpu(), new_c.router_H) and
          int(new_d.step) == int(new_c.step) == 1,
          "train reference: router queues or step differ")
    log(f"train reference: {cfg.name} full width at {cfg.n_layers} layers, "
        f"B={TRAIN_REF_B}, S={TRAIN_REF_S}, float32, one make_train_step "
        f"step card vs CPU ({time.perf_counter() - t0:.1f} s): loss "
        f"{loss_d!r} / {loss_c!r} (relative {abs(loss_d - loss_c) / abs(loss_c):.3e}, "
        f"gate {TRAIN_LOSS_RTOL}); worst leaf {worst[0]} {worst[1]:.3e} "
        f"(gate {TRAIN_GRAD_RTOL}); m (gradients) worst "
        f"{max(v for k_, v in errs.items() if k_.startswith('m:')):.3e}; "
        f"router queues equal; {len(near)} near-tie picks (layer, token, "
        f"margin, delta) {near[:8]}, layers teacher-forced "
        f"{sorted(forced)}")


def phase_train_resume(dev):
    """Preemption-safe training at full width and RESUME_LAYERS layers
    through the launcher (float32, B=TRAIN_B, S=TRAIN_S): an uninterrupted
    run of RESUME_STEPS steps, then a run that saves every RESUME_EVERY
    steps (in the background) and crashes at step RESUME_CRASH, then
    ``--resume`` to RESUME_STEPS.  The restored TrainState equals the saved
    one bit for bit (the sha256 of every restored leaf, read back from the
    card, against the checkpoint's manifest); the first resumed loss equals
    the uninterrupted run's and the crashed run's at that step bit for bit,
    the later ones the uninterrupted run's within TRAIN_RESUME_RTOL.
    Prints the checkpoint's bytes and the ms of its save and restore."""
    import dataclasses
    import json as _json
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import checkpointer as C
    from repro_torch.launch import train as T
    t0 = time.perf_counter()
    base = T.get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(base, n_layers=RESUME_LAYERS)
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="train_resume_"))
    made = []

    class Recording(C.Checkpointer):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)
            self.restored = None

        def restore(self, like, step=None, fallback=False, into=None):
            t1 = time.perf_counter()
            out = super().restore(like, step=step, fallback=fallback,
                                  into=into)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t1) * 1e3
            s = self.latest_step() if step is None else step
            manifest = _json.loads((self.dir / f"step_{s:08d}" /
                                    "manifest.json").read_text())
            digests = [C._sha256(C._to_host(x)[0])
                       for x in C.flatten(out)[0]]
            self.restored = (s, ms, digests == manifest["sha256"],
                             len(digests))
            return out

    common = ["--arch", TRAIN_ARCH, "--batch", str(TRAIN_B), "--seq",
              str(TRAIN_S), "--steps", str(RESUME_STEPS), "--log-every",
              "100"]
    ck = ["--ckpt-dir", str(tmp), "--ckpt-every", str(RESUME_EVERY)]
    recs = [StepRecorder() for _ in range(3)]
    originals = (T.get_config, T.make_train_step, T.Checkpointer)
    T.get_config = lambda arch: cfg if arch == TRAIN_ARCH else \
        originals[0](arch)
    T.Checkpointer = Recording
    try:
        T.make_train_step = recs[0].record(originals[1])
        full = T.main(common)
        T.make_train_step = recs[1].record(originals[1])
        crash = None
        try:
            T.main(common + ck + ["--crash-at", str(RESUME_CRASH)])
        except SystemExit as e:
            crash = str(e)
        check(crash == f"simulated crash at step {RESUME_CRASH}",
              f"the crashing run ended with {crash!r}")
        saved = made[-1]
        save_ms = dict(saved.last_ms)
        saved_step = saved.latest_step()
        nbytes = sum(f.stat().st_size for f in
                     (tmp / f"step_{saved_step:08d}").iterdir())
        T.make_train_step = recs[2].record(originals[1])
        resumed = T.main(common + ck + ["--resume"])
    finally:
        T.get_config, T.make_train_step, T.Checkpointer = originals
        shutil.rmtree(tmp, ignore_errors=True)
    restored = made[-1].restored
    check(saved_step == RESUME_EVERY and restored is not None and
          restored[0] == RESUME_EVERY and restored[2],
          f"saved step {saved_step}, restore {restored}: the restored state "
          f"must equal the saved one bit for bit")
    n_res = RESUME_STEPS - RESUME_EVERY
    first = RESUME_EVERY
    check(len(full) == RESUME_STEPS and len(resumed) == n_res and
          len(recs[1].losses) == RESUME_CRASH + 1,
          f"losses: {len(full)} uninterrupted, {len(recs[1].losses)} before "
          f"the crash, {len(resumed)} resumed")
    check(resumed[0] == full[first] == recs[1].losses[first],
          f"the first resumed loss {resumed[0]!r} against the uninterrupted "
          f"run's {full[first]!r} and the crashed run's "
          f"{recs[1].losses[first]!r} at step {first + 1}: not bit-identical")
    later = [abs(a - b) / abs(b) for a, b in zip(resumed[1:],
                                                  full[first + 1:])]
    check(max(later) <= TRAIN_RESUME_RTOL,
          f"resumed losses {resumed[1:]} against {full[first + 1:]}: "
          f"relative {later} (gate {TRAIN_RESUME_RTOL})")
    n_params = sum(v[3] for v in recs[0].m_after_1.values())
    log(f"train resume: {cfg.name} full width at {cfg.n_layers} layers "
        f"({n_params / 1e6:.2f}M params), B={TRAIN_B}, S={TRAIN_S}, float32 "
        f"({time.perf_counter() - t0:.1f} s): crashed at step "
        f"{RESUME_CRASH + 1} after a background save at step {saved_step}; "
        f"the checkpoint {nbytes} B, saved in copy {save_ms.get('copy', 0):.1f}"
        f" + sha256 {save_ms.get('sha256', 0):.1f} + write "
        f"{save_ms.get('write', 0):.1f} ms, restored in place in "
        f"{restored[1]:.1f} ms, its {restored[3]} leaves bit-identical to "
        f"the saved ones (sha256); first resumed loss {resumed[0]!r} equal "
        f"bit for bit to the uninterrupted and the crashed run's; later "
        f"losses within {', '.join(f'{x:.3e}' for x in later)} (gate "
        f"{TRAIN_RESUME_RTOL}; bit-identical: "
        f"{resumed[1:] == full[first + 1:]}); uninterrupted losses "
        f"{', '.join(f'{x:.5f}' for x in full)}")


# ---------------------------------------------------------------------------
# Phases 18-23: the dense family's rest, the VLM and the encoder-decoder
# ---------------------------------------------------------------------------

def family_model(arch: str, dev, *, n_layers=None, dtype: str = "bfloat16",
                 seed: int = 0):
    """(config, params) of ``arch`` at full width (depth cut to
    ``n_layers`` when given), weights drawn on ``dev`` in ``dtype`` from
    ``seed``; logs the draw's time and its peak device memory."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import get_model, split_tree
    cfg = get_config(arch)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(seed)
    params, _ = split_tree(get_model(cfg).init(
        gen, dtype=getattr(torch, dtype)))
    torch.cuda.synchronize()
    log(f"{cfg.name}: {cfg.n_layers} layers at full width (d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads over {cfg.n_kv_heads}, head dim "
        f"{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}), "
        f"{tree_numel(params):,} {dtype} params drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; peak device memory during the "
        f"draw {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, held "
        f"after it {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    return cfg, params


def reset_flash():
    from repro_torch.kernels.flash_attention import kernel as FK
    FK.flash_attention.launches = 0
    FK.flash_attention.launches_sm90 = 0


def flash_launches() -> dict:
    from repro_torch.kernels.flash_attention import kernel as FK
    return {"sm90": FK.flash_attention.launches_sm90,
            "simt": FK.flash_attention.launches}


def timed_prefills(step, params, batch, warm_batch, n: int = 2):
    """A warm-up prefill, then ``n`` timed ones with the flash counters set
    to 0 just before and read just after: (logits, wall ms each,
    launches, peak GiB of the timed ones)."""
    import torch
    step(params, warm_batch, None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash()
    walls = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = step(params, batch, None)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    launches = flash_launches()
    return (logits, walls, launches,
            torch.cuda.max_memory_allocated() / 2**30)


def check_prefill(cfg, logits, launches, want_sm90: int, what: str):
    import torch
    check(launches == {"sm90": want_sm90, "simt": 0},
          f"{what}: flash launches {launches} in 2 prefills, expected "
          f"{want_sm90} of the sm90 kernel and none of the CUDA-core one")
    check(tuple(logits.shape) == (1, 1, cfg.vocab) and
          logits.dtype == torch.bfloat16 and
          bool(torch.isfinite(logits).all()),
          f"{what}: logits {tuple(logits.shape)} {logits.dtype} not finite "
          f"or misshapen")


def phase_gemma3_prefill(dev):
    """gemma3-27b at full width and full depth (62 layers: 10 groups of 5
    local + 1 global, a tail of 2 local), 27 B bf16 params drawn on the
    card, through `make_prefill_step` at B=1, S=32,768 (prefill_32k's
    length), bf16: a warm-up at S=PREFILL_WARM_S, 2 timed prefills, each
    62 sm90 launches (52 of them with the window 1,024) and no CUDA-core
    one, finite [1, 1, 262,144] logits; a profiled prefill; then
    `phase_flash_projections` on the first local layer's q, k, v (row
    windows, with its window).  Returns (cfg, params, sm90 launches); the
    weights stay for `phase_family_serve`."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.models import get_model
    from repro_torch.models.transformer import _pattern
    from repro_torch.runtime.step import make_prefill_step
    t0 = time.perf_counter()
    cfg, params = family_model(GEMMA_ARCH, dev)
    check(_pattern(cfg) == (10, 5, 2) and cfg.window == GEMMA_WINDOW,
          f"gemma3's pattern {_pattern(cfg)}, window {cfg.window}")
    S = SHAPES["prefill_32k"].seq_len
    step = make_prefill_step(RunConfig(cfg, SHAPES["prefill_32k"]))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (1, S)), device=dev)
    warm = toks[:, :PREFILL_WARM_S]
    logits, walls, launches, peak = timed_prefills(
        step, params, {"tokens": toks}, {"tokens": warm})
    check_prefill(cfg, logits, launches, 2 * cfg.n_layers, "gemma3 prefill")
    med = statistics.median(walls)
    MEASURED["gemma3_prefill"] = {
        "ms": med, "state_bytes": state_bytes(params),
        "peak_bytes": peak * 2**30}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            again, _, _ = get_model(cfg).logits(
                params, {"tokens": toks}, activ_dtype=torch.bfloat16,
                remat="none", last_only=True)
        torch.cuda.synchronize()
    log(f"gemma3 prefill: B=1, S={S}, bf16, {cfg.n_layers} layers, 2 "
        f"prefills {', '.join(f'{w:.4f}' for w in walls)} ms: {med:.4f} ms "
        f"per prefill, {S / med * 1e3:.2f} prefill tokens/s; launches "
        f"{launches} (sm90, CUDA-core); peak device memory {peak:.2f} GiB "
        f"({time.perf_counter() - t0:.1f} s with the draw); profiled "
        f"prefill: {profile_summary(prof, med, top_n=6)}; its logits within "
        f"{max_abs_err([(again, logits)]):.3e} of the step's")
    phase_flash_projections(cfg, params, toks)
    return cfg, params, launches["sm90"]


def phase_moonlight_prefill(dev):
    """Moonlight-16B-A3B at full width and depth (27 layers: one dense,
    26 MoE with 64 experts top-6 and the shared experts; latent attention),
    16 B bf16 params drawn on the card, through `make_prefill_step` at
    B=MLA_PREFILL_B, S=MLA_PREFILL_S, bf16: a warm-up at S=PREFILL_WARM_S,
    then 2 prefills with the counters set to 0 just before and read just
    after: each 27 launches of the sm90 flash kernel (its (192, 128)
    instance) and 26 of bp_topk_route (its sigmoid mode), none of the
    CUDA-core flash kernel or of the standalone bp_topk; finite
    [B, 1, 163,840] logits.  Returns (sm90 launches, bp_topk_route
    launches)."""
    import numpy as np
    import torch
    from repro_torch.configs.base import RunConfig, ShapeConfig
    from repro_torch.kernels.bp_topk import kernel as TK
    from repro_torch.models import get_model
    from repro_torch.runtime.step import make_prefill_step
    t0 = time.perf_counter()
    cfg, params = family_model(MLA_ARCH, dev)
    B, S = MLA_PREFILL_B, MLA_PREFILL_S
    moe_layers = cfg.n_layers - cfg.first_dense_layers
    step = make_prefill_step(RunConfig(
        cfg, ShapeConfig("prefill_8k", S, B, "prefill")))
    H = get_model(cfg).init_state(device=dev).router_H
    check(tuple(H.shape) == (moe_layers, cfg.n_experts),
          f"Moonlight's router queues {tuple(H.shape)}, expected "
          f"{(moe_layers, cfg.n_experts)}")
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)), device=dev)
    step(params, {"tokens": toks[:, :PREFILL_WARM_S]}, H)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_flash()
    TK.bp_topk.launches = 0
    TK.bp_topk_route.launches = 0
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        logits = step(params, {"tokens": toks}, H)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t1) * 1e3)
    launches = {**flash_launches(),
                "bp_topk_route": TK.bp_topk_route.launches,
                "bp_topk": TK.bp_topk.launches}
    check(launches == {"sm90": 2 * cfg.n_layers, "simt": 0,
                       "bp_topk_route": 2 * moe_layers, "bp_topk": 0},
          f"Moonlight prefill: launches {launches} in 2 prefills, expected "
          f"{cfg.n_layers} of the sm90 flash kernel and {moe_layers} of "
          f"bp_topk_route per prefill, none of the CUDA-core flash kernel "
          f"or of the standalone bp_topk")
    check(tuple(logits.shape) == (B, 1, cfg.vocab) and
          logits.dtype == torch.bfloat16 and
          bool(torch.isfinite(logits).all()),
          f"Moonlight prefill logits {tuple(logits.shape)} {logits.dtype} "
          f"not finite or misshapen")
    peak = torch.cuda.max_memory_allocated() / 2**30
    med = statistics.median(walls)
    log(f"Moonlight prefill: B={B}, S={S}, bf16, {cfg.n_layers} layers "
        f"({moe_layers} MoE), 2 prefills "
        f"{', '.join(f'{w:.4f}' for w in walls)} ms: {med:.4f} ms per "
        f"prefill, {B * S / med * 1e3:.2f} prefill tokens/s; per prefill "
        f"{launches['sm90'] // 2} sm90 flash launches (q/k 192, v 128) and "
        f"{launches['bp_topk_route'] // 2} bp_topk_route launches (sigmoid "
        f"mode), counted from 0 over both: {launches}; peak device memory "
        f"{peak:.2f} GiB ({time.perf_counter() - t0:.1f} s with the draw)")
    return launches["sm90"], launches["bp_topk_route"]


def phase_family_serve(dev, cfg, params):
    """The Engine (`Engine(slots=4, max_len=128)`, float32 activations, as
    the reference's) at a family's full depth on the bf16 weights of its
    prefill phase (gemma3-27b, zamba2-2.7b, xlstm-350m): 8 requests drawn
    as `phase_serve` draws them; every request finishes with valid tokens,
    and no flash launch (decode attends through the einsum `sdpa`, as the
    reference does; the recurrent blocks step their states).  Prints ms
    per decode step and a profiled step's activities.  Returns the decode
    steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import Engine
    t0 = time.perf_counter()
    what = f"{cfg.name} serve"
    eng = Engine(cfg, params, slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
                 device=dev)
    rng = np.random.default_rng(0)
    for _ in range(SERVE_REQUESTS):
        plen = int(rng.integers(4, 16))
        eng.submit(list(rng.integers(0, cfg.vocab, plen)), SERVE_MAX_NEW)
    torch.cuda.synchronize()
    reset_flash()
    t1 = time.perf_counter()
    finished = eng.run_until_done()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches, steps = flash_launches(), eng.steps
    check(launches == {"sm90": 0, "simt": 0},
          f"{what}: flash launches {launches} at decode, expected none")
    check(sorted(finished) == list(range(SERVE_REQUESTS)),
          f"{what}: served {sorted(finished)} of {SERVE_REQUESTS}")
    outs = [finished[r].out for r in sorted(finished)]
    check(all(len(o) == SERVE_MAX_NEW and all(0 <= t < cfg.vocab for t in o)
              for o in outs), f"{what}: malformed outputs {outs}")
    toks = eng._last_tok.copy()
    step_ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        logits = eng._step(toks)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t2) * 1e3)
    check(tuple(logits.shape) == (SERVE_SLOTS, cfg.vocab) and
          bool(torch.isfinite(logits).all()),
          f"{what}: non-finite or misshapen logits")
    med = statistics.median(step_ms)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng._step(toks)
        torch.cuda.synchronize()
    n_act = sum(1 for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA)
    n_tok = sum(len(o) for o in outs)
    log(f"{what}: {len(finished)} requests, {n_tok} tokens, {steps} "
        f"decode steps (prefill included) in {wall:.3f} s: "
        f"{wall / steps * 1e3:.4f} ms per decode step (unprofiled steps "
        f"alone {', '.join(f'{x:.4f}' for x in step_ms)} ms), "
        f"{n_tok / wall:.2f} generated tokens/s; {n_act} CUDA activities "
        f"per step ({n_act / cfg.n_layers:.2f} per layer); profiled step: "
        f"{profile_summary(prof, med)}; flash launches 0; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"({time.perf_counter() - t0:.1f} s)")
    for rid in sorted(finished)[:2]:
        log(f"  req {rid}: out={finished[rid].out}")
    return steps


def block_against_cpu(cfg, p, x, *, window, what: str) -> float:
    """`block_fwd` of one layer's params ``p`` on the card and on the CPU
    from the same input ``x`` (teacher-forced), float32: the outputs
    within LAYER_RTOL of their largest magnitude.  Returns that share."""
    import torch
    from repro_torch.models.transformer import block_fwd
    cpu = torch.device("cpu")
    S = x.shape[1]
    pos = torch.arange(S, device=x.device)[None].expand(x.shape[0], S)
    with torch.inference_mode():
        yd, _, _ = block_fwd(cfg, p, x, pos, window=window)
        yc, _, _ = block_fwd(cfg, to_device_tree(p, cpu), x.cpu(),
                             pos.cpu(), window=window)
    scale = float(yc.abs().max())
    d = max_abs_err([(yd.cpu(), yc)]) / scale
    check(d <= LAYER_RTOL, f"{what}: card and CPU differ by {d:.3e} of the "
          f"output's largest magnitude {scale:.3f} (gate {LAYER_RTOL})")
    return d


def phase_gemma3_window(dev):
    """gemma3 at full width, depth cut to GEMMA_WINDOW_LAYERS (one 5:1
    group and a tail of 2), float32 weights: the forward at
    S=GEMMA_DECODE_S > the window (the CUDA-core kernel at D=128, window
    1,024 in 7 of its 8 launches), then the same tokens decoded one by one
    (every local ring wraps at 1,024): each step's logits within
    DECODE_TOL of the forward's; then the first local block and the global
    block, teacher-forced on the card's hidden state, card against the
    CPU (`block_against_cpu`).  Returns the CUDA-core launches of the
    forward."""
    import numpy as np
    import torch
    from repro_torch.models import get_model
    from repro_torch.models.common import embed
    from repro_torch.models.transformer import _pattern, block_fwd, layer
    t0 = time.perf_counter()
    cfg, params = family_model(GEMMA_ARCH, dev,
                               n_layers=GEMMA_WINDOW_LAYERS,
                               dtype="float32", seed=1)
    check(_pattern(cfg) == (1, 5, 2), f"pattern {_pattern(cfg)}")
    S, f32 = GEMMA_DECODE_S, torch.float32
    api = get_model(cfg)
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, S)), device=dev)
    reset_flash()
    with torch.inference_mode():
        full, _, _ = api.logits(params, {"tokens": toks}, activ_dtype=f32)
        torch.cuda.synchronize()
        fwd = flash_launches()
        check(fwd == {"sm90": 0, "simt": cfg.n_layers},
              f"gemma3 window forward: flash launches {fwd}, expected "
              f"{cfg.n_layers} of the CUDA-core kernel")
        caches = api.init_decode(1, S, f32, device=dev)
        ok = torch.ones(S, dtype=torch.bool, device=dev)
        diff = torch.zeros(S, device=dev)
        t1 = time.perf_counter()
        for t in range(S):
            lt, caches = api.decode_step(params, caches,
                                         {"tokens": toks[:, t]},
                                         activ_dtype=f32)
            ref = full[:, t]
            err = (lt - ref).abs()
            diff[t] = err.max()
            ok[t] = (err <= DECODE_TOL + DECODE_TOL * ref.abs()).all()
        torch.cuda.synchronize()
        dec_s = time.perf_counter() - t1
    bad = torch.nonzero(~ok).flatten().tolist()
    check(not bad, f"gemma3 decode: steps {bad[:10]} differ from the forward "
          f"by more than {DECODE_TOL} (max {float(diff.max()):.3e})")
    check(flash_launches() == fwd, "gemma3 decode launched flash attention")
    kpos = caches["local"].kpos
    check(int(kpos.min()) == S - cfg.window and int(kpos.max()) == S - 1 and
          int(caches["global"].kpos.min()) == 0,
          f"gemma3 decode: local rings hold positions {int(kpos.min())}.."
          f"{int(kpos.max())}, expected {S - cfg.window}..{S - 1}")
    del caches, full
    stack = params["stack"]
    with torch.inference_mode():
        x = embed(cfg, params["embed"], toks, f32)
        d_local = block_against_cpu(cfg, layer(layer(stack["local"], 0), 0),
                                    x, window=cfg.window,
                                    what="gemma3 local block 1")
        pos = torch.arange(S, device=dev)[None]
        for j in range(cfg.local_global):
            x, _, _ = block_fwd(cfg, layer(layer(stack["local"], 0), j), x,
                                pos, window=cfg.window)
        d_global = block_against_cpu(cfg, layer(stack["global"], 0), x,
                                     window=None,
                                     what="gemma3 global block 6")
    log(f"gemma3 window: {cfg.n_layers} layers float32, forward at S={S} "
        f"(launches {fwd}), {S} decode steps in {dec_s:.2f} s "
        f"({dec_s / S * 1e3:.4f} ms per step): every step within "
        f"{float(diff.max()):.3e} of the forward (gate {DECODE_TOL}); local "
        f"rings hold positions {S - cfg.window}..{S - 1} after the wrap; "
        f"teacher-forced blocks card vs CPU: local {d_local:.3e}, global "
        f"{d_global:.3e} of their largest output (gate {LAYER_RTOL}) "
        f"({time.perf_counter() - t0:.1f} s)")
    return fwd["simt"]


def phase_qwen15(dev):
    """qwen1.5-32b at full width (40 heads over 40, D=128, QKV bias),
    depth cut to QWEN_LAYERS, bf16 weights: `make_prefill_step` at B=1,
    S=QWEN_PREFILL_S, one sm90 launch a layer and no CUDA-core one, finite
    logits; then layer 1's block in float32 with random QKV biases,
    card against the CPU at S=QWEN_REF_S (`block_against_cpu`; the
    CUDA-core kernel at G=1, D=128).  Returns the sm90 launches."""
    import numpy as np
    import torch
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.models.common import embed, tree_map
    from repro_torch.models.transformer import layer
    from repro_torch.runtime.step import make_prefill_step
    t0 = time.perf_counter()
    cfg, params = family_model(QWEN_ARCH, dev, n_layers=QWEN_LAYERS, seed=2)
    check(cfg.n_heads == cfg.n_kv_heads and cfg.qkv_bias,
          "qwen1.5: multi-head attention with a QKV bias")
    step = make_prefill_step(RunConfig(cfg, SHAPES["prefill_32k"]))
    toks = torch.as_tensor(np.random.default_rng(2).integers(
        0, cfg.vocab, (1, QWEN_PREFILL_S)), device=dev)
    logits, walls, launches, peak = timed_prefills(
        step, params, {"tokens": toks}, {"tokens": toks[:, :PREFILL_WARM_S]})
    check_prefill(cfg, logits, launches, 2 * cfg.n_layers, "qwen1.5 prefill")
    gen = torch.Generator(device=dev).manual_seed(7)
    p0 = tree_map(lambda t: t.float(), layer(params["stack"]["layers"], 0))
    for b in ("bq", "bk", "bv"):
        p0["attn"][b] = 0.1 * torch.randn(p0["attn"][b].shape, generator=gen,
                                          device=dev)
    with torch.inference_mode():
        x = embed(cfg, {"table": params["embed"]["table"].float()},
                  toks[:, :QWEN_REF_S], torch.float32)
    d = block_against_cpu(cfg, p0, x, window=None, what="qwen1.5 block 1")
    med = statistics.median(walls)
    log(f"qwen1.5: {cfg.n_layers} layers bf16, B=1, S={QWEN_PREFILL_S}, 2 "
        f"prefills {', '.join(f'{w:.4f}' for w in walls)} ms: {med:.4f} ms "
        f"per prefill, {QWEN_PREFILL_S / med * 1e3:.2f} tokens/s; launches "
        f"{launches}; peak {peak:.2f} GiB; block 1 in float32 with random "
        f"QKV biases at S={QWEN_REF_S}, card vs CPU {d:.3e} of its largest "
        f"output (gate {LAYER_RTOL}) ({time.perf_counter() - t0:.1f} s)")
    return launches["sm90"]


def train_family(arch: str, batch: int, want: tuple, *,
                 steps: int = FAMILY_TRAIN_STEPS, every_leaf: bool = True):
    """``steps`` float32 steps of ``arch`` at full width through
    `launch.train.main` (B=``batch``, S=FAMILY_TRAIN_S, remat full), each
    step's launches (CUDA-core flash, sm90 flash, bp_topk_route) counted
    by `StepRecorder`: every step ``want``, the first loss finite and,
    with ``every_leaf``, every loss finite and after step 1 a finite,
    non-zero gradient on every leaf.  Returns (losses, ms per step, the
    first moments' summary, the CUDA-core launches of all steps as
    counted)."""
    import torch
    from repro_torch.launch import train as T
    rec = StepRecorder()
    original = T.make_train_step
    T.make_train_step = rec.record(original)
    try:
        losses = T.main(["--arch", arch, "--steps", str(steps),
                         "--batch", str(batch), "--seq", str(FAMILY_TRAIN_S),
                         "--remat", "full", "--log-every", "1"])
    finally:
        T.make_train_step = original
    check(len(losses) == steps and math.isfinite(losses[0]) and
          (not every_leaf or all(math.isfinite(x) for x in losses)),
          f"{arch} training: losses {losses}")
    check(all(n == want for n in rec.launches),
          f"{arch} training: launches per step {rec.launches}, expected "
          f"{want} (CUDA-core flash, sm90 flash, bp_topk_route)")
    bad = sorted(k for k, v in rec.m_after_1.items()
                 if not (v[0] and v[1] > 0))
    check(not (every_leaf and bad), f"{arch} training: after step 1 these "
          f"leaves have a zero or non-finite gradient: {bad}")
    torch.cuda.empty_cache()
    return losses, rec.ms, rec.m_after_1, sum(n[0] for n in rec.launches)


def phase_vlm(dev):
    """internvl2-1b at full width and depth (24 layers, G=7, D=64): a bf16
    `make_prefill_step` over VLM_TEXT_S text tokens behind its 256 patch
    embeddings, 24 sm90 launches a prefill; the float32 logits of 64 text
    tokens behind random patches, card against the CPU within LOGIT_ATOL +
    FAMILY_LOGIT_RTOL |cpu|; FAMILY_TRAIN_STEPS float32 steps of
    `make_train_step` (what the launcher runs; remat full) on random patch
    embeddings: 48 CUDA-core launches a step, finite losses, after step 1
    a finite, non-zero gradient on every leaf, the projector's included.
    Then one step through the launcher (`launch.train.main`) on its own
    batch, the reference's zero patch embeddings: 48 launches and a finite
    loss; the non-finite gradients that batch gives at this depth (zero
    prefix rows stay zero through every layer, and each norm's backward
    at a zero row scales by rsqrt(eps) = 1e3; the reference's launcher
    does the same on the CPU) are counted and printed.  Returns (sm90,
    CUDA-core) launches of the prefills and the training steps."""
    import torch
    from repro_torch.configs import SHAPES, RunConfig, ShapeConfig
    from repro_torch.models import get_model
    from repro_torch.runtime.step import (init_train_state,
                                          make_prefill_step, make_train_step)
    t0 = time.perf_counter()
    cfg, params = family_model(VLM_ARCH, dev, seed=3)
    P, d, L = cfg.n_patches, cfg.d_model, cfg.n_layers
    gen = torch.Generator(device=dev).manual_seed(3)

    def vlm_batch(B, S_text):
        return {"patch_embeds": torch.randn((B, P, d), generator=gen,
                                            device=dev),
                "tokens": torch.randint(0, cfg.vocab, (B, S_text),
                                        generator=gen, device=dev)}
    step = make_prefill_step(RunConfig(cfg, SHAPES["prefill_32k"]))
    logits, walls, launches, peak = timed_prefills(
        step, params, vlm_batch(1, VLM_TEXT_S), vlm_batch(1, 128))
    check_prefill(cfg, logits, launches, 2 * L, "VLM prefill")
    del params
    cfg, p32 = family_model(VLM_ARCH, dev, dtype="float32", seed=4)
    api = get_model(cfg)
    b = vlm_batch(1, VLM_REF_TEXT_S)
    with torch.inference_mode():
        ld, _, _ = api.logits(p32, b, activ_dtype=torch.float32)
        lc, _, _ = api.logits(to_device_tree(p32, torch.device("cpu")),
                              to_device_tree(b, torch.device("cpu")),
                              activ_dtype=torch.float32)
    err = max_abs_err([(ld.cpu(), lc)])
    check(tuple(ld.shape) == (1, P + VLM_REF_TEXT_S, cfg.vocab) and
          within(ld.cpu(), lc, LOGIT_ATOL, FAMILY_LOGIT_RTOL),
          f"VLM logits card vs CPU: max abs {err:.3e} (gate {LOGIT_ATOL} + "
          f"{FAMILY_LOGIT_RTOL} |cpu|)")
    del p32, ld, lc
    rcfg = RunConfig(cfg, ShapeConfig("train", FAMILY_TRAIN_S, VLM_TRAIN_B,
                                      "train"), activ_dtype="float32",
                     remat="full")
    state, _ = init_train_state(
        rcfg, torch.Generator(device=dev).manual_seed(5), device=dev)
    rec = StepRecorder()
    train_step = rec.record(make_train_step)(rcfg)
    for _ in range(FAMILY_TRAIN_STEPS):
        state, _ = train_step(state, vlm_batch(VLM_TRAIN_B,
                                               FAMILY_TRAIN_S + 1))
    want = (2 * L, 0, 0)
    check(all(math.isfinite(x) for x in rec.losses) and
          all(n == want for n in rec.launches),
          f"VLM training: losses {rec.losses}, launches per step "
          f"{rec.launches}, expected {want}")
    bad = sorted(k for k, v in rec.m_after_1.items()
                 if not (v[0] and v[1] > 0))
    proj = [v[1] for k, v in rec.m_after_1.items()
            if k.startswith("projector")]
    check(not bad and len(proj) == 3, f"VLM training: after step 1 these "
          f"leaves have a zero or non-finite gradient: {bad}")
    simt = sum(n[0] for n in rec.launches)
    del state, train_step
    torch.cuda.empty_cache()
    zl, zms, zm, zsimt = train_family(VLM_ARCH, VLM_TRAIN_B, want, steps=1,
                                      every_leaf=False)
    nonfinite = sorted(k for k, v in zm.items() if not v[0])
    med = statistics.median(walls)
    log(f"VLM: {cfg.name}, {L} layers, bf16 prefill of {P} patches + "
        f"{VLM_TEXT_S} text tokens {', '.join(f'{w:.4f}' for w in walls)} ms "
        f"({(P + VLM_TEXT_S) / med * 1e3:.2f} tokens/s), launches {launches}, "
        f"peak {peak:.2f} GiB; float32 logits of {P} + {VLM_REF_TEXT_S} "
        f"tokens card vs CPU within {err:.3e}; make_train_step (float32, "
        f"B={VLM_TRAIN_B}, S={FAMILY_TRAIN_S} + {P} random patches, remat "
        f"full): losses {', '.join(f'{x:.5f}' for x in rec.losses)}, ms per "
        f"step {', '.join(f'{x:.1f}' for x in rec.ms)}, {want} launches a "
        f"step, every leaf a gradient (the projector's max |m| "
        f"{max(proj):.3e}); the launcher's step on its zero patches: loss "
        f"{zl[0]:.5f}, {zms[0]:.1f} ms, {want} launches, {len(nonfinite)} "
        f"of {len(zm)} leaves with a non-finite gradient "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches["sm90"], simt + zsimt


def phase_encdec(dev):
    """seamless-m4t-large-v2 at full width and depth (24 encoder + 24
    decoder layers, 16 heads over 16, D=64): a bf16 `make_prefill_step`
    with ENCDEC_FRAMES frames and ENCDEC_TGT target tokens, 72 sm90
    launches a prefill (24 encoder, not causal, S=T=4,096; 24 decoder self,
    causal; 24 cross, not causal, S=1,024 against T=4,096); in float32 the
    encoder's memory, `build_cross_cache` and ENCDEC_DECODE_STEPS decode
    steps, each 24 CUDA-core cross-attention launches at S=1 against
    T=4,096 and its logits within DECODE_TOL of `decode_fwd`'s; then
    FAMILY_TRAIN_STEPS float32 steps through the launcher, 144 CUDA-core
    launches a step under full remat.  Returns (sm90 launches of the
    prefills, CUDA-core launches of decode and training)."""
    import torch
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.models import encdec, get_model
    from repro_torch.runtime.step import make_prefill_step
    t0 = time.perf_counter()
    cfg, params = family_model(ENCDEC_ARCH, dev, seed=5)
    L = cfg.dec_layers
    gen = torch.Generator(device=dev).manual_seed(5)

    def ed_batch(S_src, S_tgt):
        return {"frames": torch.randn((1, S_src, cfg.d_model), generator=gen,
                                      device=dev),
                "tokens": torch.randint(0, cfg.vocab, (1, S_tgt),
                                        generator=gen, device=dev)}
    step = make_prefill_step(RunConfig(cfg, SHAPES["prefill_32k"]))
    logits, walls, launches, peak = timed_prefills(
        step, params, ed_batch(ENCDEC_FRAMES, ENCDEC_TGT), ed_batch(512, 128))
    check_prefill(cfg, logits, launches, 2 * (cfg.enc_layers + 2 * L),
                  "encdec prefill")
    del params
    cfg, p32 = family_model(ENCDEC_ARCH, dev, dtype="float32", seed=6)
    api, f32 = get_model(cfg), torch.float32
    b = ed_batch(ENCDEC_FRAMES, ENCDEC_DECODE_STEPS)
    toks = b["tokens"]
    with torch.inference_mode():
        memory = encdec.encode(cfg, p32, b["frames"], remat="none")
        full = encdec.decode_fwd(cfg, p32, toks, memory, activ_dtype=f32,
                                 remat="none")
        caches = encdec.build_cross_cache(cfg, p32, memory,
                                          ENCDEC_DECODE_STEPS, f32)
        n = ENCDEC_DECODE_STEPS
        ok = torch.ones(n, dtype=torch.bool, device=dev)
        diff = torch.zeros(n, device=dev)
        torch.cuda.synchronize()
        reset_flash()
        t1 = time.perf_counter()
        for t in range(n):
            lt, caches = api.decode_step(p32, caches, {"tokens": toks[:, t]},
                                         activ_dtype=f32)
            err = (lt - full[:, t]).abs()
            diff[t] = err.max()
            ok[t] = (err <= DECODE_TOL + DECODE_TOL * full[:, t].abs()).all()
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t1) / n * 1e3
        dec = flash_launches()
    bad = torch.nonzero(~ok).flatten().tolist()
    check(not bad, f"encdec decode: steps {bad[:10]} differ from decode_fwd "
          f"by more than {DECODE_TOL} (max {float(diff.max()):.3e})")
    check(dec == {"sm90": 0, "simt": n * L},
          f"encdec decode: flash launches {dec}, expected {L} CUDA-core "
          f"cross-attention launches per step")
    del p32, memory, full, caches
    torch.cuda.empty_cache()
    want = 2 * (cfg.enc_layers + 2 * L)
    losses, ms, _, simt = train_family(ENCDEC_ARCH, ENCDEC_TRAIN_B,
                                       (want, 0, 0))
    med = statistics.median(walls)
    log(f"encdec: {cfg.name}, {cfg.enc_layers} + {L} layers, bf16 prefill "
        f"of {ENCDEC_FRAMES} frames and {ENCDEC_TGT} target tokens "
        f"{', '.join(f'{w:.4f}' for w in walls)} ms ({med:.4f} ms per "
        f"prefill), launches {launches}, peak {peak:.2f} GiB; float32 decode "
        f"of {n} steps against {ENCDEC_FRAMES} memory rows, {dec_ms:.4f} ms "
        f"per step, every step within {float(diff.max()):.3e} of decode_fwd "
        f"(gate {DECODE_TOL}), launches {dec}; training through the launcher "
        f"(float32, B={ENCDEC_TRAIN_B}, S={FAMILY_TRAIN_S}, remat full): "
        f"losses {', '.join(f'{x:.5f}' for x in losses)}, ms per step "
        f"{', '.join(f'{x:.1f}' for x in ms)}, {want} CUDA-core launches a "
        f"step ({time.perf_counter() - t0:.1f} s)")
    return launches["sm90"], dec["simt"] + simt


def zamba_blocks_against_cpu(cfg, params, x, what: str):
    """zamba's first mamba layer (its norm and `mamba_fwd`, residual
    added) and the shared block (`block_fwd`, the flash kernel at D=80 on
    the card), teacher-forced on ``x``, card against the CPU, float32:
    each within LAYER_RTOL of its output's largest magnitude.  Returns
    the two shares."""
    import torch
    from repro_torch.models.transformer import layer
    from repro_torch.models.zamba import _mamba_body
    lp = layer(layer(params["stack"]["mamba"], 0), 0)
    cpu = torch.device("cpu")
    with torch.inference_mode():
        yd = _mamba_body(cfg, lp, x)
        yc = _mamba_body(cfg, to_device_tree(lp, cpu), x.cpu())
    scale = float(yc.abs().max())
    d_mamba = max_abs_err([(yd.cpu(), yc)]) / scale
    check(d_mamba <= LAYER_RTOL, f"{what}, mamba layer 1: card and CPU "
          f"differ by {d_mamba:.3e} of the output's largest magnitude "
          f"{scale:.3f} (gate {LAYER_RTOL})")
    d_shared = block_against_cpu(cfg, params["stack"]["shared"], x,
                                 window=None, what=f"{what}, shared block")
    return d_mamba, d_shared


def decode_against_forward(api, params, toks, what: str):
    """The float32 forward of ``toks`` [1, S], then the same tokens decoded
    one by one from empty caches: each step's logits within DECODE_TOL +
    DECODE_TOL |forward| of the forward's.  Returns (max abs difference,
    ms per decode step, the forward's flash launches, the decode's)."""
    import torch
    f32, S, dev = torch.float32, toks.shape[1], toks.device
    reset_flash()
    with torch.inference_mode():
        full, _, _ = api.logits(params, {"tokens": toks}, activ_dtype=f32)
        torch.cuda.synchronize()
        fwd = flash_launches()
        reset_flash()
        caches = api.init_decode(1, S, f32, device=dev)
        ok = torch.ones(S, dtype=torch.bool, device=dev)
        diff = torch.zeros(S, device=dev)
        t1 = time.perf_counter()
        for t in range(S):
            lt, caches = api.decode_step(params, caches,
                                         {"tokens": toks[:, t]},
                                         activ_dtype=f32)
            err = (lt - full[:, t]).abs()
            diff[t] = err.max()
            ok[t] = (err <= DECODE_TOL + DECODE_TOL * full[:, t].abs()).all()
        torch.cuda.synchronize()
        dec_ms = (time.perf_counter() - t1) / S * 1e3
    bad = torch.nonzero(~ok).flatten().tolist()
    check(not bad, f"{what}: decode steps {bad[:10]} differ from the forward "
          f"by more than {DECODE_TOL} (max {float(diff.max()):.3e})")
    return float(diff.max()), dec_ms, fwd, flash_launches()


def phase_zamba_prefill(dev):
    """zamba2-2.7b at full width and depth, nothing cut (54 mamba layers in
    9 groups of 6, the shared attention block applied 9 times, H = KH = 32
    at head dim 80; 2,340,750,240 params drawn in bf16 on the card) through
    `make_prefill_step` at B=1, S=32,768 (prefill_32k's length), bf16: a
    warm-up at S=PREFILL_WARM_S, 2 timed prefills, each 9 sm90 launches
    (the kernel's D=80 path) and no CUDA-core one, finite [1, 1, 32,000]
    logits; ms, tokens/s, peak memory, a profiled prefill's device time by
    group (the SSD's float32 passes fall in "elementwise") and busy share,
    and the SSD core's device ms at one layer's shapes (`ssd_device_ms`).
    Returns (cfg, params, sm90 launches); the weights stay for
    `phase_family_serve`."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.models import get_model
    from repro_torch.models.zamba import _groups
    from repro_torch.runtime.step import make_prefill_step
    t0 = time.perf_counter()
    cfg, params = family_model(ZAMBA_ARCH, dev, seed=7)
    n_groups, k = _groups(cfg)
    check(tree_numel(params) == ZAMBA_PARAMS and (n_groups, k) == (9, 6) and
          cfg.head_dim == 80 and cfg.n_heads == cfg.n_kv_heads == 32,
          f"zamba: {tree_numel(params)} params, groups {(n_groups, k)}, "
          f"head dim {cfg.head_dim}")
    S = SHAPES["prefill_32k"].seq_len
    step = make_prefill_step(RunConfig(cfg, SHAPES["prefill_32k"]))
    toks = torch.as_tensor(np.random.default_rng(7).integers(
        0, cfg.vocab, (1, S)), device=dev)
    logits, walls, launches, peak = timed_prefills(
        step, params, {"tokens": toks}, {"tokens": toks[:, :PREFILL_WARM_S]})
    check_prefill(cfg, logits, launches, 2 * n_groups, "zamba prefill")
    med = statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            get_model(cfg).logits(params, {"tokens": toks},
                                  activ_dtype=torch.bfloat16, remat="none",
                                  last_only=True)
        torch.cuda.synchronize()
    ssd_ms = ssd_device_ms(cfg, S, dev)
    log(f"zamba prefill: B=1, S={S}, bf16, {cfg.n_layers} mamba layers in "
        f"{n_groups} groups + the shared block {n_groups} times, 2 prefills "
        f"{', '.join(f'{w:.4f}' for w in walls)} ms: {med:.4f} ms per "
        f"prefill, {S / med * 1e3:.2f} prefill tokens/s; launches {launches} "
        f"(sm90 at D=80, CUDA-core); peak device memory {peak:.2f} GiB "
        f"({time.perf_counter() - t0:.1f} s with the draw); profiled "
        f"prefill (the SSD's float32 passes are in elementwise): "
        f"{profile_summary(prof, med, top_n=8)}; the SSD core alone "
        f"(`models.mamba.ssd`, one layer's shapes, bf16 inputs) "
        f"{ssd_ms:.4f} ms a layer on the card, {cfg.n_layers} layers "
        f"{cfg.n_layers * ssd_ms:.2f} ms, "
        f"{cfg.n_layers * ssd_ms / med:.4f} of a prefill")
    return cfg, params, launches["sm90"]


def ssd_device_ms(cfg, S: int, dev) -> float:
    """Device ms of one call of `models.mamba.ssd` at one zamba layer's
    shapes at sequence length ``S`` (B=1), on random bf16 inputs and
    float32 log decays of a softplus'd dt's size."""
    import torch
    from repro_torch.models.mamba import dims, ssd
    _, nh, ns, hd = dims(cfg)
    gen = torch.Generator(device=dev).manual_seed(11)
    xbar = torch.randn((1, S, nh, hd), generator=gen, device=dev).bfloat16()
    Bm, Cm = (torch.randn((1, S, ns), generator=gen, device=dev).bfloat16()
              for _ in range(2))
    loga = -torch.nn.functional.softplus(torch.randn(
        (1, S, nh), generator=gen, device=dev))
    with torch.inference_mode():
        return device_ms(lambda: ssd(xbar, Bm, Cm, loga, cfg.ssm_chunk),
                         n=3, warm=1)


def phase_zamba_train(dev):
    """zamba2-2.7b at full width trained ZAMBA_TRAIN_STEPS float32 steps
    through the launcher (`launch.train.main`: B=FAMILY_TRAIN_B, S=512,
    remat full; params, gradients and AdamW moments ≈ 37 GB): 9 CUDA-core
    flash launches a step at D=80 (the shared block is not rematerialized,
    as in the reference; its backward is plain torch), none of the sm90
    kernel, finite losses falling (the last below the first), after step 1
    a finite, non-zero gradient on every leaf.  Returns the CUDA-core
    launches of all steps."""
    import torch
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    losses, ms, _, simt = train_family(ZAMBA_ARCH, FAMILY_TRAIN_B, (9, 0, 0),
                                       steps=ZAMBA_TRAIN_STEPS)
    check(losses[-1] < losses[0], f"zamba training: losses {losses} do not "
          f"fall")
    med = statistics.median(ms[1:])
    tokens = FAMILY_TRAIN_B * FAMILY_TRAIN_S
    log(f"zamba train: float32, B={FAMILY_TRAIN_B}, S={FAMILY_TRAIN_S}, "
        f"remat full, {ZAMBA_TRAIN_STEPS} steps through launch.train.main: "
        f"losses {', '.join(f'{x:.5f}' for x in losses)}; {med:.4f} ms per "
        f"step (median of steps 2-{ZAMBA_TRAIN_STEPS}; all "
        f"{', '.join(f'{x:.1f}' for x in ms)}), {tokens / med * 1e3:.2f} "
        f"tokens/s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; 9 CUDA-core "
        f"flash launches a step (D=80), every leaf a finite, non-zero "
        f"gradient after step 1 ({time.perf_counter() - t0:.1f} s)")
    return simt


def phase_zamba_decode(dev):
    """zamba2-2.7b at full width, depth cut to ZAMBA_DECODE_LAYERS (2
    groups), float32: the forward of ZAMBA_DECODE_S tokens (2 CUDA-core
    launches at D=80; the length pads the last 128-token chunk) and the
    same tokens decoded one by one, each step within DECODE_TOL of the
    forward, no flash launch at decode; then the first mamba layer and the
    shared block teacher-forced on the embedded tokens, card against the
    CPU within LAYER_RTOL.  Returns the forward's CUDA-core launches."""
    import numpy as np
    import torch
    from repro_torch.models import get_model
    from repro_torch.models.common import embed
    t0 = time.perf_counter()
    cfg, params = family_model(ZAMBA_ARCH, dev, n_layers=ZAMBA_DECODE_LAYERS,
                               dtype="float32", seed=8)
    toks = torch.as_tensor(np.random.default_rng(8).integers(
        0, cfg.vocab, (1, ZAMBA_DECODE_S)), device=dev)
    diff, dec_ms, fwd, dec = decode_against_forward(get_model(cfg), params,
                                                    toks, "zamba")
    n_groups = cfg.n_layers // cfg.attn_every
    check(fwd == {"sm90": 0, "simt": n_groups} and
          dec == {"sm90": 0, "simt": 0},
          f"zamba decode: flash launches {fwd} in the forward (expected "
          f"{n_groups} CUDA-core), {dec} at decode (expected none)")
    with torch.inference_mode():
        x = embed(cfg, params["embed"], toks[:, :FAMILY_REF_S],
                  torch.float32)
    d_mamba, d_shared = zamba_blocks_against_cpu(cfg, params, x,
                                                 "zamba teacher-forced")
    log(f"zamba decode: {cfg.n_layers} layers float32, forward at "
        f"S={ZAMBA_DECODE_S} (launches {fwd}), {ZAMBA_DECODE_S} decode steps "
        f"at {dec_ms:.4f} ms a step, every step within {diff:.3e} of the "
        f"forward (gate {DECODE_TOL}); teacher-forced at S={FAMILY_REF_S}, "
        f"card vs CPU: mamba layer 1 {d_mamba:.3e}, the shared block "
        f"{d_shared:.3e} of their largest output (gate {LAYER_RTOL}) "
        f"({time.perf_counter() - t0:.1f} s)")
    return fwd["simt"]


class ScanTimer:
    """Wraps `models.xlstm.slstm_scan` (``with ScanTimer() as t:``): each
    call's wall ms, synchronised before and after, in ``t.ms``."""

    def __enter__(self):
        import torch
        from repro_torch.models import xlstm
        self.ms, self.original = [], xlstm.slstm_scan

        def timed_scan(*args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.original(*args)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            return out
        xlstm.slstm_scan = timed_scan
        return self

    def __exit__(self, *exc):
        from repro_torch.models import xlstm
        xlstm.slstm_scan = self.original


def phase_xlstm(dev):
    """xlstm-350m at full width and depth, nothing cut (4 groups of 5
    mLSTM + 1 sLSTM blocks, 461,919,392 params drawn in bf16): a bf16
    `make_prefill_step` at B=1, S=XLSTM_PREFILL_S (cut from 32,768: the
    mLSTM's parallel form holds [S, S, nh] float32 tensors, 17.2 GB each
    there, and the sLSTM steps once per token), 2 timed prefills, no flash
    launch (this path runs no TPU kernel: both blocks are plain torch, as
    they are plain JAX in the reference), finite logits; the sLSTM loop's
    share of a prefill's wall time (`ScanTimer`), a profiled prefill of
    XLSTM_PROFILE_S tokens; then
    `phase_family_serve` on the same weights.  Returns the Engine's
    decode steps."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import SHAPES, RunConfig
    from repro_torch.models import get_model
    from repro_torch.models.xlstm import _groups
    from repro_torch.runtime.step import make_prefill_step
    t0 = time.perf_counter()
    cfg, params = family_model(XLSTM_ARCH, dev, seed=9)
    check(tree_numel(params) == XLSTM_PARAMS and _groups(cfg) == (4, 5),
          f"xlstm: {tree_numel(params)} params, groups {_groups(cfg)}")
    S = XLSTM_PREFILL_S
    step = make_prefill_step(RunConfig(cfg, SHAPES["prefill_32k"]))
    toks = torch.as_tensor(np.random.default_rng(9).integers(
        0, cfg.vocab, (1, S)), device=dev)
    with ScanTimer() as scan:
        logits, walls, launches, peak = timed_prefills(
            step, params, {"tokens": toks}, {"tokens": toks[:, :256]})
    check_prefill(cfg, logits, launches, 0, "xlstm prefill")
    n_s = cfg.n_layers // cfg.slstm_every
    loop = [sum(scan.ms[i:i + n_s]) for i in range(n_s, 3 * n_s, n_s)]
    med = statistics.median(walls)
    # Profiled at XLSTM_PROFILE_S tokens: a whole prefill traces ~400,000
    # activities (25 a token per sLSTM block), and the trace costs minutes.
    short = toks[:, :XLSTM_PROFILE_S]
    with torch.inference_mode():
        get_model(cfg).logits(params, {"tokens": short},
                              activ_dtype=torch.bfloat16, remat="none",
                              last_only=True)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    with torch.inference_mode():
        get_model(cfg).logits(params, {"tokens": short},
                              activ_dtype=torch.bfloat16, remat="none",
                              last_only=True)
    torch.cuda.synchronize()
    short_ms = (time.perf_counter() - t1) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode():
            get_model(cfg).logits(params, {"tokens": short},
                                  activ_dtype=torch.bfloat16, remat="none",
                                  last_only=True)
        torch.cuda.synchronize()
    log(f"xlstm prefill: B=1, S={S}, bf16, {cfg.n_layers} blocks (4 x (5 "
        f"mLSTM + 1 sLSTM)), 2 prefills {', '.join(f'{w:.4f}' for w in walls)}"
        f" ms: {med:.4f} ms per prefill, {S / med * 1e3:.2f} prefill "
        f"tokens/s; the sLSTM loops ({n_s} x {S} steps) "
        f"{', '.join(f'{x:.4f}' for x in loop)} ms, "
        f"{', '.join(f'{x / w:.4f}' for x, w in zip(loop, walls))} of the "
        f"prefills' wall time; launches {launches}: this path runs no TPU "
        f"kernel (the reference's xLSTM is plain JAX); peak device memory "
        f"{peak:.2f} GiB ({time.perf_counter() - t0:.1f} s with the draw); "
        f"a prefill of {XLSTM_PROFILE_S} tokens, {short_ms:.4f} ms, "
        f"profiled: {profile_summary(prof, short_ms, top_n=6)}")
    steps = phase_family_serve(dev, cfg, params)
    del params
    return steps


def phase_xlstm_train(dev):
    """xlstm-350m at full width trained XLSTM_TRAIN_STEPS float32 steps
    through the launcher (B=FAMILY_TRAIN_B, S=512, remat full): no flash
    launch, finite losses, after step 1 a finite, non-zero gradient on
    every leaf; the sLSTM loops' share of each step's wall time (their
    forward passes, twice a step under full remat; the loop's backward runs
    in autograd and is not in it); then xlstm at full depth in float32:
    the forward of XLSTM_DECODE_S tokens and the same tokens decoded one by
    one, each step within DECODE_TOL of the forward; the first mLSTM and
    sLSTM blocks teacher-forced on the embedded tokens, card against the
    CPU within LAYER_RTOL."""
    import numpy as np
    import torch
    from repro_torch.models import get_model
    from repro_torch.models.common import embed
    from repro_torch.models.transformer import layer
    from repro_torch.models.xlstm import mlstm_fwd, slstm_fwd
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = get_config(XLSTM_ARCH)
    torch.cuda.reset_peak_memory_stats()
    with ScanTimer() as scan:
        losses, ms, _, _ = train_family(XLSTM_ARCH, FAMILY_TRAIN_B,
                                        (0, 0, 0), steps=XLSTM_TRAIN_STEPS)
    n_loops = 2 * (cfg.n_layers // cfg.slstm_every)  # twice a step each
    per_step = [sum(scan.ms[i:i + n_loops])
                for i in range(0, len(scan.ms), n_loops)]
    tokens = FAMILY_TRAIN_B * FAMILY_TRAIN_S
    peak = torch.cuda.max_memory_allocated() / 2**30
    cfg, params = family_model(XLSTM_ARCH, dev, dtype="float32", seed=10)
    toks = torch.as_tensor(np.random.default_rng(10).integers(
        0, cfg.vocab, (1, XLSTM_DECODE_S)), device=dev)
    diff, dec_ms, fwd, dec = decode_against_forward(get_model(cfg), params,
                                                    toks, "xlstm")
    check(fwd == dec == {"sm90": 0, "simt": 0},
          f"xlstm decode: flash launches {fwd}, {dec}, expected none")
    stack = params["stack"]
    with torch.inference_mode():
        x = embed(cfg, params["embed"], toks[:, :FAMILY_REF_S],
                  torch.float32)
    shares = []
    for name, fwd_fn, lp in (
            ("mLSTM block 1", mlstm_fwd, layer(layer(stack["mlstm"], 0), 0)),
            ("sLSTM block 6", slstm_fwd, layer(stack["slstm"], 0))):
        with torch.inference_mode():
            yd = fwd_fn(cfg, lp, x)
            yc = fwd_fn(cfg, to_device_tree(lp, torch.device("cpu")),
                        x.cpu())
        scale = float(yc.abs().max())
        d = max_abs_err([(yd.cpu(), yc)]) / scale
        check(d <= LAYER_RTOL, f"xlstm {name}: card and CPU differ by "
              f"{d:.3e} of the output's largest magnitude {scale:.3f} (gate "
              f"{LAYER_RTOL})")
        shares.append(f"{name} {d:.3e}")
    log(f"xlstm train: float32, B={FAMILY_TRAIN_B}, S={FAMILY_TRAIN_S}, "
        f"remat full, {XLSTM_TRAIN_STEPS} steps through launch.train.main: "
        f"losses {', '.join(f'{x:.5f}' for x in losses)}; ms per step "
        f"{', '.join(f'{x:.1f}' for x in ms)} "
        f"({tokens / statistics.median(ms) * 1e3:.2f} tokens/s at the "
        f"median); the sLSTM loops' forward passes "
        f"{', '.join(f'{x:.1f}' for x in per_step)} ms a step, "
        f"{', '.join(f'{x / w:.4f}' for x, w in zip(per_step, ms))} of its "
        f"wall time; peak device memory {peak:.2f} GiB; no flash launch; "
        f"float32 decode at full depth: forward at S={XLSTM_DECODE_S}, "
        f"{XLSTM_DECODE_S} decode steps at {dec_ms:.4f} ms a step, every "
        f"step within {diff:.3e} of the forward (gate {DECODE_TOL}); "
        f"teacher-forced at S={FAMILY_REF_S}, card vs CPU: "
        f"{', '.join(shares)} of their largest output (gate {LAYER_RTOL}) "
        f"({time.perf_counter() - t0:.1f} s)")


def dryrun_sweep() -> dict:
    """`python -m repro_torch.launch.dryrun --all --force` on the local
    mesh and on both logical meshes, two processes at once; every record
    must come out "ok" (local) or "layout" (single, multi).  Returns the
    records by (arch, shape, mesh)."""
    from repro_torch.configs import cells
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import report
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs = {mesh: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
         "--mesh", mesh, "--force", "--tag", DRYRUN_TAG],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for mesh in ("local", "both")}
    outs = {}
    try:
        for mesh, proc in procs.items():
            outs[mesh] = proc.communicate(timeout=DRYRUN_TIMEOUT_S)[0]
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    for mesh, proc in procs.items():
        check(proc.returncode == 0,
              f"dry-run --mesh {mesh} exited {proc.returncode}:\n"
              f"{outs[mesh][-3000:]}")
    recs = {(r["arch"], r["shape"], r["mesh"]): r
            for r in report.load(DRYRUN_TAG)}
    want = {"local": "ok", "single": "layout", "multi": "layout"}
    for arch, shape in cells():
        for mesh, status in want.items():
            r = recs.get((arch, shape, mesh))
            check(r is not None and r["status"] == status,
                  f"dry-run {arch} x {shape} x {mesh}: "
                  f"{r and r['status']} {r and r.get('error')}")
    local = [recs[(a, s, "local")] for a, s in cells()]
    log(f"dryrun: {len(local)} cells traced on the meta device (local) and "
        f"{2 * len(local)} laid out on the 256- and 512-chip meshes in "
        f"{wall:.1f} s (two processes at once; budget "
        f"{DRYRUN_BUDGET_S:.0f} s); trace seconds: " + ", ".join(
            f"{r['arch']} x {r['shape']} {r['trace_s']}" + (
                f" (+ sLSTM correction {r['slstm_correction']['seconds']})"
                if "slstm_correction" in r else "") for r in local))
    log("dryrun: local records (the plain path at the H100 peaks; its "
        "dominant term upper-bounds the kernel path's): " + "; ".join(
        f"{r['arch']} x {r['shape']}: compute {r['roofline']['compute_s']:.6g} "
        f"s, memory {r['roofline']['memory_s']:.6g} s, "
        f"{r['roofline']['dominant']}, 6ND/traced "
        f"{r['useful_flops_ratio']:.4f}, args "
        f"{r['memory']['argument_size_in_bytes'] / 2**30:.3f} GiB, temp "
        f"{r['memory']['temp_size_in_bytes'] / 2**30:.3f} GiB"
        for r in local))
    check(wall <= DRYRUN_BUDGET_S, f"the dry-run sweep took {wall:.1f} s, "
          f"over its budget of {DRYRUN_BUDGET_S:.0f} s")
    return recs


def phase_dryrun(dev) -> None:
    """The dry-run stack on the card's host: the sweep (`dryrun_sweep`),
    then the trace of each DRYRUN_CHECKS shape held against what its phase
    measured (MEASURED): (a) the traced state's bytes (params for a
    prefill; params, AdamW moments and count, step and router queues for
    training) equal the real state's; (b) the model FLOPs over the peak of
    the step's matrix dtype (its activation dtype; TF32 is off) are at
    most the measured time, that share printed beside its prediction;
    (c) the trace's bound (its compute and memory terms' larger) against
    the measured time and (d) its temporaries (and arguments) against the
    peak device memory, printed."""
    import torch
    from repro_torch.configs import RunConfig, ShapeConfig, get_config
    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import roofline as rl
    from repro_torch.models import get_model
    from repro_torch.runtime.step import init_train_state
    check(not torch.backends.cuda.matmul.allow_tf32,
          "the roofline prices float32 products at the CUDA-core peak")
    dryrun_sweep()
    for arch, B, S, kind, over, key, predicted in DRYRUN_CHECKS:
        got = MEASURED[key]
        shape = ShapeConfig(f"smoke_{kind}", S, B, kind)
        cfg = get_config(arch)
        rec = dr.run_cell(arch, shape, rcfg_overrides=over, tag=DRYRUN_TAG)
        check(rec["status"] == "ok", f"dry-run {key}: {rec['status']}")
        rcfg = RunConfig(model=cfg, shape=shape, **over)
        specs, _ = get_model(cfg).batch_specs(shape)
        state, _ = init_train_state(rcfg, abstract=True)
        extra = dr.tree_bytes(specs)
        if kind == "prefill":
            extra += dr.tree_bytes(state.router_H)
        traced = rec["memory"]["argument_size_in_bytes"] - extra
        check(traced == got["state_bytes"],
              f"dry-run {key}: traced state {traced} bytes, the card's "
              f"{got['state_bytes']}")
        gemm = rcfg.activ_dtype
        floor_s = rec["model_flops"] / rl.PEAK_FLOPS[gemm]
        share = floor_s / (got["ms"] / 1e3)
        check(share <= 1.0, f"dry-run {key}: model FLOPs at the {gemm} peak "
              f"take {floor_s:.6g} s, more than the measured "
              f"{got['ms'] / 1e3:.6g} s")
        roof = rec["roofline"]
        bound = max(roof["compute_s"], roof["memory_s"])
        mem = rec["memory"]
        log(f"dryrun check {key}: {arch} B={B} S={S} {kind} "
            f"({rcfg.activ_dtype} activations, {rcfg.param_dtype} params; "
            f"trace {rec['trace_s']} s, {rec['trace_ops']} ops): (a) state "
            f"{traced} bytes traced = {got['state_bytes']} on the card; (b) "
            f"model FLOPs {rec['model_flops']:.6g} / {gemm} peak = "
            f"{floor_s:.6g} s, {share:.4f} of the measured "
            f"{got['ms'] / 1e3:.6g} s (predicted {predicted}); (c) traced "
            f"FLOPs {roof['flops_per_device']:.6g} ({roof['flops_by_dtype']}), "
            f"bytes {roof['bytes_per_device']:.6g}: compute "
            f"{roof['compute_s']:.6g} s, memory {roof['memory_s']:.6g} s, "
            f"bound {bound:.6g} s = {bound / (got['ms'] / 1e3):.4f} of the "
            f"measured time, {roof['dominant']} on the plain path; (d) "
            f"temporaries "
            f"{mem['temp_size_in_bytes'] / 2**30:.4f} GiB + arguments "
            f"{mem['argument_size_in_bytes'] / 2**30:.4f} GiB against the "
            f"card's peak {got['peak_bytes'] / 2**30:.4f} GiB")


def to_device_tree(tree, dev):
    if isinstance(tree, dict):
        return {k: to_device_tree(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke test runs only on the "
              "card", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              f"root of a checkout", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    card = card_line()
    peaks = card_peaks(name)
    log(f"device: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}; host CPU {host_cpu()}, "
        f"{torch.get_num_threads()} torch threads; bounds use the H100 SXM "
        f"peaks {peaks['bytes'] / 1e12:.2f} TB/s, {peaks['float32'] / 1e12:.0f} "
        f"TFLOP/s f32, {peaks['bfloat16'] / 1e12:.0f} TFLOP/s bf16")

    # Router logits feed a top-k: a TF32 matmul would flip selections.
    check(torch.get_float32_matmul_precision() == "highest" and
          not torch.backends.cuda.matmul.allow_tf32,
          "float32 matmuls must run in full float32 (no TF32)")

    from repro_torch.kernels import _build
    secs = _build.build_all()
    log(f"build: {len(_build.sources())} source(s) with nvcc in parallel in "
        f"{secs:.2f} s")
    phase_build_report(_build)

    rows = phase_kernels(dev, peaks)
    rows["counter_hash"] = phase_counter_hash(dev, peaks)
    rows["bp_topk_route"] = phase_topk_route(dev, peaks)
    rows["bp_route_decide"] = phase_route(dev, peaks)
    rows["flash_attention"] = phase_flash(dev, peaks)
    res, jobs, launches, wall = phase_main(dev)
    phase_graph_parity(dev, res, wall)
    phase_profile(dev)
    rows["bp_slot_step"], plain_launches = phase_slot_step(dev, peaks)
    # B1 and B2 run on the plain slot step's path only (0 launches in the
    # fleet run, phase_main checks); their launches are that path's.
    for k in ("slot_route_decide", "comp_balance_decide"):
        launches[k] = plain_launches[k]
        rows[k]["path"] = ("core.policies.slot_step_ref on the card, "
                           f"{STEP_SLOTS} slots (phase_slot_step)")
    phase_reference(dev)
    phase_determinism(dev, res, jobs)
    phase_wireless(dev)
    frontier_launches, frontier_results = phase_frontier(dev)
    atlas_launches, _ = phase_atlas(dev)
    smoke_launches = phase_serving_smoke(dev)
    serving_launches, _, serving_res = phase_serving(dev)
    phase_serving_parity(dev)
    _, stream_atlas_res = phase_stream(dev, res, jobs, frontier_results)
    resilience_launches = phase_resilience(dev, res, jobs, serving_res,
                                           stream_atlas_res)
    slot_path = (
        f"find_lambda_max, {frontier_launches} (phase_frontier); "
        f"sweep_lambda_max, {atlas_launches} (phase_atlas); run_serving, "
        f"{smoke_launches} (phase_serving_smoke) and {serving_launches} "
        f"(phase_serving); resumed runs, {resilience_launches} "
        f"(phase_resilience)")
    phase_router(dev)
    launches["bp_topk_route"] = phase_serve(dev)
    phase_serve_reference(dev)
    launches["flash_attention"] = phase_prefill(dev)["flash_attention_sm90"]
    phase_prefill_reference(dev)
    phase_prefill_bf16_layers(dev)
    t_train, phase_s = time.perf_counter(), {}
    train_launches = phase_train(dev)
    phase_s["phase_train"] = time.perf_counter() - t_train
    for fn in (phase_train_grads, phase_train_reference, phase_train_resume):
        t_phase = time.perf_counter()
        fn(dev)
        phase_s[fn.__name__] = time.perf_counter() - t_phase
    log("training phases: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in phase_s.items()) +
        f"; {time.perf_counter() - t_train:.1f} s in all")
    launches["flash_attention"] += train_launches["flash_attention_sm90"]
    simt_launches = train_launches["flash_attention"]

    # Phases 18-23: each family's path, its counters set to 0 just before
    # it is driven and read just after (inside each phase).
    t_fam, phase_s = time.perf_counter(), {}

    def timed(fn, *args, label=None):
        gc.collect()
        torch.cuda.empty_cache()
        t_phase = time.perf_counter()
        out = fn(*args)
        phase_s[label or fn.__name__] = time.perf_counter() - t_phase
        return out

    cfg_g, params_g, gemma_sm90 = timed(phase_gemma3_prefill, dev)
    timed(phase_family_serve, dev, cfg_g, params_g)
    del params_g
    simt_launches += timed(phase_gemma3_window, dev)
    qwen_sm90 = timed(phase_qwen15, dev)
    vlm_sm90, vlm_simt = timed(phase_vlm, dev)
    ed_sm90, ed_simt = timed(phase_encdec, dev)
    cfg_z, params_z, zamba_sm90 = timed(phase_zamba_prefill, dev)
    timed(phase_family_serve, dev, cfg_z, params_z, label="zamba_serve")
    del params_z
    zamba_simt = timed(phase_zamba_train, dev)
    zamba_simt += timed(phase_zamba_decode, dev)
    timed(phase_xlstm, dev)
    timed(phase_xlstm_train, dev)
    mla_sm90, mla_gate = timed(phase_moonlight_prefill, dev)
    log("family phases: " + ", ".join(
        f"{k} {v:.1f} s" for k, v in phase_s.items()) +
        f"; {time.perf_counter() - t_fam:.1f} s in all")
    launches["flash_attention"] += gemma_sm90 + qwen_sm90 + vlm_sm90 + \
        ed_sm90 + zamba_sm90 + mla_sm90
    simt_launches += vlm_simt + ed_simt + zamba_simt
    rows["flash_attention"]["simt_f32_launches"] = simt_launches
    rows["flash_attention"]["path"] = (
        "sm90 (launches): 24 per prefill (phase_prefill), 24 per bfloat16 "
        "training step (phase_train, make_train_step); gemma3-27b 62 per "
        "prefill at S=32,768 (phase_gemma3_prefill), qwen1.5-32b 4 "
        "(phase_qwen15), internvl2-1b 24 (phase_vlm), seamless 72 "
        "(phase_encdec). CUDA-core (simt_f32_launches): 48 per float32 "
        "training step under full remat (phase_train, launch.train.main); "
        "gemma3 at 8 layers, 8 per float32 forward (phase_gemma3_window); "
        "internvl2-1b 48 per float32 training step (phase_vlm); seamless "
        "24 cross-attention launches per decode step and 144 per float32 "
        "training step (phase_encdec); zamba2-2.7b at head dim 80: sm90 9 "
        "per prefill at S=32,768 (phase_zamba_prefill), CUDA-core 9 per "
        "float32 training step (phase_zamba_train) and 2 per float32 "
        "forward at 12 layers (phase_zamba_decode); xlstm-350m launches "
        "none (its blocks are plain torch, phase_xlstm); moonlight-16b-a3b "
        "27 per prefill at B=8, S=8,192 through the (192, 128) instance "
        "(phase_moonlight_prefill)")
    launches["bp_topk_route"] += train_launches["bp_topk_route"] + mla_gate
    rows["bp_topk_route"]["path"] = (
        "Engine decode steps (phase_serve); 24 more per prefill "
        "(phase_prefill); training (phase_train): 48 per float32 step under "
        "full remat, 24 per bfloat16 step; moonlight-16b-a3b 26 per prefill "
        "in the sigmoid mode (phase_moonlight_prefill)")
    # The trace simulator's path (phase 28, run after the model phases so
    # its cached graphs hold no memory while they run): its counts set to
    # 0 and read inside.
    gc.collect()
    torch.cuda.empty_cache()
    paper_launches = phase_paper_figures(dev)
    launches["bp_slot_step"] += paper_launches
    rows["bp_slot_step"]["path"] = (
        f"run_fleet, graphed (phase_main); the trace simulator, "
        f"{paper_launches} (phase_paper_figures: simulate and sweep_rates "
        f"graphed and eager, the three figure suites); these two are the "
        f"launches counted; besides, " + slot_path)
    rows["counter_hash"]["path"] = (
        "run_fleet, graphed (phase_main): one launch per draw site per "
        "batched slot, eager and replayed; every CUDA draw of the port")
    launches["bp_route_decide"] = rows["bp_route_decide"]["launches"]
    launches["bp_topk"] = rows["bp_topk"]["launches"]
    for k, r in rows.items():
        r["launches"] = launches[k]
        check(r["launches"] > 0, f"{k}: no launch on its path")
    t_dry = time.perf_counter()
    phase_dryrun(dev)
    log(f"phase_dryrun: {time.perf_counter() - t_dry:.1f} s")
    log(f"total: {time.perf_counter() - t_start:.1f} s")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    # A plain version timed at another shape than the kernel says which;
    # flash attention also names its kernel and the CUDA-core kernel's
    # float32 time, bound and training launches, and SDPA's float32 time,
    # at the prefill shape and at the training shape (`_train_`, with the
    # plain version's time there), and the sm90 kernel's time, bound and
    # SDPA's at gemma3's global and windowed layers (`gemma_`) and at
    # zamba's head dim 80, the sm90 kernel at its prefill and the
    # CUDA-core kernel at its float32 training step (`zamba_`), and its
    # (192, 128) instance at Moonlight's prefill, with SDPA's time and the
    # plain version's beside the kernel's at `plain_S` (`mla_`); the gate's
    # sigmoid mode at Moonlight's prefill gate (`sigmoid_`); the noise
    # kernel's time, plain time and bound at the trace simulator's
    # regulator draw (`regulator_`); the bp_slot, bp_topk, flash and noise
    # rows name the paths that launched them.
    shape = ("plain_S", "ms_at_plain_S", "kernel", "simt_f32_ms",
             "simt_f32_bound_ms", "simt_f32_launches", "library_f32_ms",
             "simt_f32_train_ms", "plain_f32_train_ms",
             "library_f32_train_ms", "simt_f32_train_bound_ms",
             "gemma_global_ms", "gemma_global_bound_ms",
             "gemma_global_library_ms", "gemma_window_ms",
             "gemma_window_bound_ms", "gemma_window_library_ms",
             "zamba_prefill_ms", "zamba_prefill_bound_ms",
             "zamba_prefill_library_ms", "zamba_train_f32_ms",
             "zamba_train_f32_bound_ms", "zamba_train_plain_f32_ms",
             "zamba_train_library_f32_ms", "mla_ms", "mla_bound_ms",
             "mla_library_ms", "mla_plain_ms", "mla_ms_at_plain_S",
             "sigmoid_ms", "sigmoid_plain_ms", "sigmoid_bound_ms",
             "regulator_ms", "regulator_plain_ms", "regulator_bound_ms",
             "path")
    table = {"kernels": [{k: r[k] for k in keys + shape if k in r}
                         for r in rows.values()]}
    for r in table["kernels"]:
        for k in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            check(math.isfinite(r[k]), f"{r['name']}: {k} not finite")
    print(json.dumps(table))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--resilience-child"]:
        sys.exit(resilience_child(*sys.argv[2:6]))
    sys.exit(main())
