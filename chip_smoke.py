#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ggs_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure (no exception is caught):
1. device: a CUDA card is required; prints nvidia-smi's name and power limit.
2. build: compiles csrc/walk.cu, csrc/walk_grad.cu and csrc/scatter.cu with
   nvcc for sm_90a (one nvcc each, all at once); prints ptxas' report and a
   WALK line: each forward walk kernel's registers, static shared memory,
   spill bytes and resident blocks a SM.
3. kernels: K1 (fitness_tiles) and K2 (render_tiles) against their plain
   PyTorch versions on bit-identical lists, at the GA main path's shapes
   (512x512, N=512, B=32, 64x128 tiles, exact-tight and highest), on an odd
   canvas, and with bin_capacity truncating the lists; K6 (bwd_tiles) and
   K7 (lossgrad_tiles) against theirs at run_grad's shape (B=1, N=2000,
   512x512, 16x128 tiles, and the same genomes on 8-, 32- and 64-row list
   tiles) and the memetic elite batch (B=8, N=512), with K7's num against
   K1 on the same lists, K6 against K7 and a second launch of each for the
   same bits (each of the 9 gradient rows against its own largest value);
   the walk's bf16x2 add, subtract and multiply on the card against the f32
   result rounded to bf16 (random, tie and subnormal pairs, bit for bit);
   plus the entry points (fitness, canvas, fused and unfused genome
   gradients) on a small input against the dense oracle on the CPU.
4. main paths, each with every launch count set to 0 before and read after:
   `python -m ggs_tpu_torch.run_ga` at its defaults (synthetic 512x512
   target, N=512, P=32, exact-tight) for GENERATIONS generations: the best
   fitness must fall, K1 launch at least once a generation, K2 for the
   export; `python -m ggs_tpu_torch.run_grad` at its defaults (N=2000,
   512x512, exact-tight, mask 0.7) for GRAD_STEPS Adam steps: the loss must
   fall, K7 launch once a step, K2 for the rescore and export; the unfused
   gradient (autograd through gradient.make_loss_fn: K2 forward, K6
   backward) for UNFUSED_STEPS Adam steps at the same shape; under the fast
   tier's corner cull (eps 8e-2) fused_value_and_grad (K7 once) and
   autograd through render_diff (K2 and K6 once) on JAX's list tile (64
   rows at N=2000), the two within FITNESS_RTOL (loss) and GRAD_SCALED_ATOL
   (gradients over their largest); and run_ga with
   --memetic-every 10 --memetic-steps 5 for 50 generations: the best must
   fall and stay monotone, K7 launch 25 times.
5. times: K1 at B=32 and B=512, K2 at B=1 and B=32 and on run_grad's lists
   (K2', RenderDiff's forward), K6 and K7 at both gradient shapes and on
   each list tile height, K6 with d(init) and K2' from the init canvas on
   grad-10k-1024's last chained pass, with CUDA events over many launches
   after a warm-up,
   their plain versions, the port's evaluate in renders/s at B=512, the GA
   in generations/s over several blocks, and Adam steps/s at run_grad's
   defaults and at bench.py's gradient configuration, one Adam block under
   torch.cuda's sync debug mode (no host sync allowed); each kernel's bound
   is computed from this run's lists.
6. profile: one GA block and one Adam block under torch.profiler, with the
   device time split between the walk kernel, sorting (the dense binning)
   and the other kernels; and one fast GA block (walk, K4, sort, other);
   the device launches a GA generation (exact-tight, fast) and an Adam step
   may not exceed LAUNCH_LIMITS, counted exactly as the kernel, copy and
   fill nodes of each block captured in a CUDA graph (`graph_launches`;
   torch.profiler's counts, which can lose records, printed beside them).
The fast tier adds, in the same phases: K3 (fitness_tiles_fast,
render_tiles_fast) and K4 (prep_fast) against their plain versions at the
fast GA's shapes (B=32, N=512, 512x512, eps 2e-3 and 8e-2, corner cull) and
on the odd canvas (K4 also timed at B=512 and by its device time, beside
an empty kernel's), K1-bf16 (fitness_tiles_bf16) at the bf16 GA's, and
evaluate/render_genomes on the card against the CPU plain route; the main
paths `run_ga --precision fast` (FAST_GENS generations: K4 and K3 at least
once a generation, K1 once for the exact rescore), the fast memetic GA
(--cull-eps 8e-2, K7 25 times over eps-culled lists), `run_grad
--precision fast` (K7 once a step) and `run_ga --precision bf16` (K1-bf16
once a generation); the selection fidelity of fast scoring on 20
populations of 64 (benchmarks/eps_sweep.py: the largest exact-fitness gap
inverted, under 1.5e-2); K3/K4/K1-bf16 times with their bounds, renders/s
under fast and bf16, and fast GA generations/s in blocks alternating with
exact-tight's.
The large-canvas path (the JAX package's benchmarks/suite.py configurations
grad-10k-1024, big-10k-1024 and canvas-4k, and the GA at 2048x2048 with
N=10,000) adds: K1/K2, K3 (both epilogues) and K1-bf16 from an init canvas
against their plain versions, K6 with d(init) against its plain version,
each from a seeded canvas and on the last pass of a two-pass chain built as
its main path builds it (K1/K2 and K3 with the corner cull at the 2048x2048
GA's B=32, K1-bf16 at big-10k-1024, K6 at grad-10k-1024), and
K5 (bin_splats_scatter) against bin_splats_scatter_plain (integer-equal idx,
cnt and largest true count) at the first pass of the 2048x2048 GA (512
tiles, exact-tight and fast with the corner cull), of canvas-4k (2,048
tiles), at 1024x1024 on the gradient tiles, and with the overflow fallback
forced by coincident splats, and against bin_splats_dense without the cull;
also at the exact lists the main paths bin with K5 below 256 tiles (512x512
at P=32 and 512 on 32 tiles, run_grad's 128 tiles of 16x128, the flagship's
first pass at B=1024 on 128 tiles, and the fast tier's boxes without the
corner cull, dead ones included), each against both (K5 is the whole binning of a pass from the boxes: its band stage, also
held against its plain version, computes the band lists and, under the
corner cull, the band column ranges on the card);
chained passes against one pass at N=10,000 (bit for bit, exact tiers); the
main paths run_grad at grad-10k-1024 (BIG_GRAD_STEPS steps: K5, K2 and K6
twice a step, once each from an init canvas), run_ga at 2048x2048, N=10,000,
P=32, exact-tight and fast (BIG_GA_GENS generations: K5 twice and the
chained fitness walk once a generation), the canvas-4k render in three tiers
(7 passes, K5 and its band stage each, at most C4K_K5_LAUNCHES_PER_PASS K5
launches a pass by the wrappers' counters, and no call of the plain route's
band helpers) and the bf16 fitness at
big-10k-1024 (K2, then K1-bf16 from its canvas); K5's times (CUDA events
and device time) beside its bound, its plain route and the dense sort it
replaces, at the GA's pass (exact, and fast, where its overflow fallback
rebuilds the lists; the fallback's launches are counted apart), canvas-4k's
(exact and fast with the corner cull) and grad-10k-1024's, renders/s at
big-10k-1024 and canvas-4k, Adam
steps/s at grad-10k-1024, and one chained Adam step with no host sync.
The SA slice (`sa_paths`, and last `sa_checks_and_times`) adds the main
paths `python -m
ggs_tpu_torch.run_sa` at its defaults (synthetic 512x512, N=512, 8 tries,
exact-tight; SA_ITERS iterations: the best must fall and stay monotone, K1
once an iteration at B=8, K2 for the export), with `--proposal-mode
sequential` (K1 eight times an iteration at B=1), `--replicas 4` (parallel
tempering: K1 once an iteration at B=32), `--precision fast` (K4 and K3
once an iteration, K1 once for the rescore) and `--metric ssim` (K2 once an
iteration, no K1), `--precision bf16` (K1-bf16 once an iteration) and
`--precision highest --metric mix --replicas 2` (K2 once an iteration, no
rescore), `run_grad --metric mix` (K2' and K6 once a step, no K7;
the loss must fall) and `run_ga --metric ssim`, each with objective.evaluate's
batch sizes counted; one SA and one PT block under torch.cuda's sync debug
mode; the SSIM of 8 rendered 512x512 canvases on the card with both TF32
flags on, against the same function in float64 on the CPU (within
SSIM_F64_ATOL, the same bits with the flags off); and SA, sequential SA and
PT iterations/s (medians of host-timed blocks), launches an iteration and
SSIM-metric renders/s at B=8 on an `SA TIMES` line beside the card. Each
kernel's entry in the `kernels` line also gives its launches on these paths.
The pipeline slice (`pipeline_paths` after the SA paths, and
`pipeline_checks_and_times` before `sa_checks_and_times`) adds the main
paths `python -m ggs_tpu_torch.run_pipeline` on the photo at its widths
(512x512, N=512, P=32, elite 8; PIPE_ARGV cuts the budgets): every growth
stage (N 64 -> 512), the GA best monotone within each, K1 once an
evaluation at each stage's N, K2 once a growth (and a recycle), a frame
and an export, K7 once an Adam step, the Adam loss falling and
`ga_anim.apng` decoding to the frame PNGs; `run_ga --anneal-sigma0 8` (K1
once a generation and twice a sigma step), `run_grad --anneal-sigma0 8`
(K7 once a step) and `run_ga --grow-stages 3 --precision fast` (K4 and K3
once an evaluation at each N, K3's canvas once a growth); the plain checks
at the stages' shapes (K1/K2 at B=32 and N=64-256, K3/K4 at N=128 and
256, K6/K7 at B=1 and N=512); an annealed GA block and an annealed Adam
block with no host sync, the annealed GA's launches a generation within
LAUNCH_LIMITS["ga_exact_tight"] + BLUR_LAUNCHES, and a `PIPELINE TIMES`
line (annealed against plain generations/s and Adam steps/s in turns, one
`blur_image` at sigma 8, one `grow_population`).
The checkpoint / island / profile slice (`slice_paths` after the pipeline
paths, and `slice_checks_and_times` after the profile phase) adds the main
paths `run_ga --islands 4 --migrate-every 10 --migrate-k 2` at run_ga's
defaults (ISLAND_GENS generations: the best falls and is monotone, K1 once
a generation plus the init and the rescore) and under `--precision fast`
(ISLAND_FAST_GENS: K4 and K3 once an evaluation); run_ga with
`--checkpoint-every 50` stopped right after its 100-generation checkpoint
and resumed with `--resume`, whose `ga_best_genome.npy` and curves must
equal an uninterrupted 200-generation run's in bits (K1 102: the template's
init, 100 generations, the rescore); `run_ga --profile-dir` over three
blocks, whose one Chrome trace must name the walk's `fitness_kernel`; one
island equal in bits to ga.step on the same draws; a 3-generation island
block under the sync debug mode; block resumes on the card (GA exact-tight
and fast, the island GA, SA, PT, Adam): run(10) equal in bits (genomes,
fits, best, the generator's state, Adam's moments) to run(5) -> save ->
load into a fresh template -> run(5); and a `SLICE TIMES` line (island
against plain generations/s in turns, the island's exact launches a
generation, one save's ms and bytes at P=32, N=512 with a 500-generation
curve).
The sharding slice (`slab_checks` and `shard_checks_and_times`, last) adds:
each kernel of the sharded paths launched from a row slab's lists (shifted
boxes, the bottom slab, splats above it) against its plain version under
the gates above (K1/K2 exact-tight and highest, K3, K1-bf16 at B=16 on a
256-row slab of 512x512, K2 at B=32, K6/K7 at run_grad's shape, K5 on a
1024-row slab of the 2048x2048 GA's first pass, exact and fast, and on a
512-row one, exact, against bin_splats_dense too); the slab
partials summed against the full fitness (rtol 1e-6, atol 1e-7, also at
2048x2048 with N=10,000 over 2 and 4 slabs), render_rows against the full
canvas's rows (CANVAS_ATOL; bits reported), the slab gradients summed
against the full canvas's (GRAD_ROW_REL); then worlds of 2 and 4 gloo
ranks, all on cuda:0, spawned as `chip_smoke.py --shard-worker` after the
build: the sharded evaluate over 1x2, 2x1, 2x2 and 1x4 in every tier and
metric and the 2048x2048 GA's at tile 2 (256 tiles) and 4 (128; K5 at
both) against the unsharded one (rtol 2e-5, atol 1e-6; fast 2e-3), the
same bits on every rank; 20-generation GA blocks whose states hash equal
on every rank after each block, pop-only equal in bits to one process;
the tile-sharded Adam gradient (rtol 2e-4, atol 1e-6 mse / 2e-6 mix); a
2x2 island GA migrating over the pop shards; save_checkpoint_distributed
then a resume equal in bits; run_ga (exact-tight, fast, bf16) at 2x2,
run_ga --metric ssim and run_grad (mse, mix) at 1x2 through the runners,
with launch counts; and
`torchrun ... run_ga --pop-shards 2 --tile-shards 2` for 100 generations
(exit 0, the artifacts written once); a `SHARD TIMES` line (generations/s
of one process against 2x1, 1x2 and 2x2, Adam steps/s against 1x2, the
bytes a rank puts into collectives a generation).
The flagship slice (`flagship_checks_and_times`, last) runs the JAX
package's multi-host headline (BASELINE.json configs[4]: pop 4096, 10,000
splats, 1024x1024) through `run_ga --image natural:1024x1024
--work-max-side 1024 --n-splats 10000 --pop-size 4096 --eval-chunk 1024
--no-video` for FLAG_GENS generations, exact-tight with one checkpoint and
`--precision fast --cull-eps 8e-2` (K1 / K3 once a chunk from the first
pass's canvas, K2 / K3's canvas once a chunk, K2 exactly once more for
the rescore and once a pass for the export; the best falls); scores the
saved population again at B=4096 in chunks of 1024 (CUDA events, the peak
memory) equal in bits to the fits it was saved with, 8 of its candidates
at B=8 and 1000 in chunks of 512 equal in bits, 2 through the plain walks
within FITNESS_RTOL; the same in the fast tier at eps 8e-2 (8 candidates
at B=8 equal in bits to B=4096's, 2 through the plain K3 walks within
FITNESS_RTOL); sums the 512-row slab partials at B_loc = 1024 against the
whole (rtol 1e-6, atol 1e-7); resumes the checkpoint for one generation
equal in bits to the run's; profiles one generation; and runs the
tile-sharded 10k Adam step in a world of 2 gloo ranks on cuda:0
(`chip_smoke.py --shard-worker 2 RANK STORE OUT flagship`) against one
process (rtol 2e-4, atol 1e-6; loss 2e-5; each gene row within
GRAD_ROW_REL of its largest magnitude), the ranks' states equal by hash;
a `FLAGSHIP` line (renders/s at B=4096, generations/s in
both tiers, the peak bytes at chunks 1024 and 512, the sort's ms a pass,
K1's and K2's ms a chunk, launches a generation, the checkpoint's bytes and
ms).
The run-block graph slice (`run_block_graphs`, after the profile phase)
holds ga, gradient, sa and pt.make_run_block, ga.make_memetic_run_block
and island.make_run_block, replayed as CUDA graphs, to their eager bodies
in bits after every block over RBG_BLOCKS (a shorter last block): the GA
exact-tight, fast, bf16 and annealed (a sigma step between blocks), Adam
at run_grad's defaults and under --metric mix, batched and sequential SA
and PT (swaps inside blocks and on their boundaries), the memetic block
(K7 refinements; under --metric mix K2' and K6; fast) and the island block
at ISLAND_ARGV (exact-tight and fast), refinements and migrations inside
blocks and on their boundaries; each replayed graph's kernel, copy and
fill nodes equal to graph_launches' count of the same eager block (for
the memetic and island blocks, of each phase); a resume through graphed
blocks against the unbroken run; run_ga with frames, recycles and
checkpoints, run_ga --memetic-every and run_ga with ISLAND_ARGV graphed
against the eager body of their run block (best genome, curves and launch
counts equal); a replay without host sync (GA and memetic) and a host
copy refused at capture; a `RUN BLOCK GRAPHS` line (generations/s, Adam
steps/s, SA / PT iterations/s, memetic and island generations/s graphed
against eager in turns, each one's busy share under torch.profiler).
Every runner's GA, memetic, island, Adam, SA and PT blocks replay as CUDA
graphs, so the main paths above run them graphed,
and their launch counts add each replay's kernels (profiling.COUNTS,
which holds chip_smoke's evaluate counts too); the flagship's chunked
evaluate stays eager, and a `FLAGSHIP GRAPH` line gives one generation's
graph peak in each tier, or its capture that does not fit.
Prints a `GRAD KERNELS` line (K6/K7 times, bounds and launches, blocks a
SM, Adam steps/s at both gradient configurations, beside the card), one
`kernels` JSON line, the card line, and last the device line.
Imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# the GA main path's length; the launch check needs at least 100
GENERATIONS = 200
GA_BLOCKS, GA_BLOCK_GENS = 5, 100  # generations/s: timed blocks of the GA
GRAD_STEPS = 200  # run_grad's main path: Adam steps, one K7 launch each
UNFUSED_STEPS = 10  # the unfused gradient (K2 + K6) at run_grad's shape
MEMETIC_GENS, MEMETIC_EVERY, MEMETIC_STEPS = 50, 10, 5
ADAM_BLOCKS, ADAM_BLOCK_STEPS = 5, 20  # Adam steps/s: timed blocks

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit). The f32
# rate counts an FMA as 2 operations; the walk is built with -fmad=false,
# so the rate its one-operation instructions can reach is half of it.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# f32 operations the walk in csrc/walk.cu executes, each counted as 1 and
# expf counted as 1 (the accurate expf is several instructions):
# per (splat, pixel) pair inside the box: 2 y compares, qy, qx*qy, nsxy*,
# +, qy*qy, nsyy*, +, exp, *a, 1-f, and 3 x (2 mul + 1 add) for the blend
OPS_PER_PAIR_PIXEL = 21
# per (splat, column) pair inside the box, hoisted out of the row loop:
# 2 x compares, qx, qx*qx, nsxx*
OPS_PER_PAIR_COLUMN = 5
# per pixel: K1 clamps (6), 3 sub, 3 squares, 2 add, *w, += (16); K2 clamps
OPS_PER_PIXEL_K1 = 16
OPS_PER_PIXEL_K2 = 6
# the fast walk (K3, walk.cu mode 1) per (splat, pixel) pair inside the box:
# 2 y compares, qy, qx*qy, nsxy*, qy*qy, nsyy*, +log2a, +, +txx, exp2, and
# 3 x (c - C, f*, C +) for the blend; per column as the exact walk's 5
OPS_PER_PAIR_PIXEL_FAST = 20
# K1-bf16 runs the exact walk with the roundings as conversions, not
# operations of the function. Per pair-pixel, 17 of the 21 are bf16 (qx*qy,
# nsxy*, +, qy*qy, nsyy*, +, *a, 1-f and the 9 of the blend) and count at the
# card's packed bf16x2 rate outside the tensor cores (NVIDIA H100 white
# paper: 133.8 TFLOP/s, twice f32's); the 2 y compares, qy's subtraction and
# exp stay f32. Per column, qx*qx and nsxx* are bf16, the 2 x compares and
# qx f32; the loss epilogue is f32.
PEAK_BF16_FLOPS = 133.8e12
BF16_OPS_PER_PAIR_PIXEL, BF16_OPS_PER_PAIR_COLUMN = 17, 2
# K4 per splat: ~80 operations (clips, exp x2, log, log2, sqrt x2, the
# precision fold, boxes), against 36 bytes read and 13 x 4 + 16 written
OPS_PER_SPLAT_K4 = 80
# The gradient walks (K6, K7) count what the function needs, not the
# replay csrc/walk_grad.cu chose (pass A, then B1 and B2 each recomputing e):
# per (splat, pixel) pair in the box one forward step, 23 (2 y compares, qy,
# 2*sxy, qx*qy, *, +, qy*qy, syy*, +, -0.5*, exp, *a, 1-f, 3 x 3 blend), and
# one backward step given its e and f, 45 (3 gT, 8 dL/df, 2 dL/dq, 6 + 6 + 3
# + 4 + 3 for the geometry sums, 6 colour, 2 alpha, 2 for T)
OPS_PER_PAIR_PIXEL_GRAD = 23 + 45
OPS_PER_PAIR_COLUMN_GRAD = 5  # one walk: 2 x compares, qx, qx*qx, sxx*
# per pixel, K7's loss head: 6 clamps, 3 sub, 5 for the squared norm, *w, +=,
# scale*w, 3 cotangent products
OPS_PER_PIXEL_K7 = 20
# K5's overflow fallback per (tile, splat) pair: render_cuda._corner_keep's
# f32 operations (4 clamped edge offsets of 2, rx and ry of 3, the two
# clamped vertices of 2 + 3, the two quadratics of 7, max, add, compare)
OPS_CORNER_TEST = 41
# K5's band column range per (band, splat) of a row list under the band
# cull: render_cuda._corner_band_xranges' f32 operations, each compare,
# select, min, max, floor and sqrt counted as 1 (the band's dy limits 7, L
# 1, two quadratic intervals of 22, ry 3, four half-planes of 15, the vertex
# piece 15, the union of three pieces 21, the band test 3, xlo and xhi 10,
# txh's test 2)
OPS_BAND_RANGE = 166
# canvas-4k under the corner cull: K5 launches at most this many kernels a
# pass (band stage, tile stage, overflow fallback), counted by the wrapper's
# own counters, and the plain route's band helpers run no time on the card
C4K_K5_LAUNCHES_PER_PASS = 3

CANVAS_ATOL = 2e-6
FITNESS_RTOL = 5e-5
BF16_RTOL = 1e-5  # K1-bf16 vs its plain version: bf16 roundings of equal inputs
# K1-bf16 vs K1 on the same lists: the bf16 roundings must show, far above
# BF16_RTOL, so a walk that skipped them cannot pass
BF16_MIN_GAP = 10 * BF16_RTOL
K4_ULPS = 2  # K4's table vs its plain version, finite entries
FIDELITY_MAX_GAP = 1.5e-2  # tests/test_tpu_exactness.py:175-178
FIDELITY_POPS, FIDELITY_B = 20, 64  # benchmarks/eps_sweep.py's rank rounds
# device launches a GA generation (exact-tight, fast) and an Adam step at
# run_grad's defaults, under torch.profiler, at the commit before the walk
# redesign (PERF.md section 5): no change to the walk may add one
LAUNCH_LIMITS = {"ga_exact_tight": 312.1, "ga_fast": 268.1, "adam": 442.1}
FAST_GENS, FAST_MEMETIC_GENS, BF16_GENS = 200, 50, 50
# kernel vs plain gradients: each of the 9 rows (a field over every image
# and splat) within GRAD_ROW_REL of that row's largest plain magnitude
GRAD_ROW_REL = 1e-5
GRAD_SCALED_ATOL = 2e-6  # K6 vs K7, each row divided by its largest value
# The large-canvas path, at the JAX package's own large configurations
# (benchmarks/suite.py): grad-10k-1024 (Adam, B=1, N=10,000, 1024x1024),
# big-10k-1024 (fused fitness, B=4, N=10,000, 1024x1024) and canvas-4k
# (render, B=1, N=50,000, 4096x4096, min_scale 1, max_scale 0.02), and the
# GA at 2048x2048 with N=10,000 and a population of 32. Depth only is cut:
# BIG_GRAD_STEPS Adam steps, BIG_GA_GENS generations.
BIG_GRAD_STEPS, BIG_GA_GENS = 30, 8
BIG_N, BIG_SIDE, BIG_B = 10_000, 1024, 4
GA_SIDE, GA_P = 2048, 32
C4K_SIDE, C4K_N, C4K_SCALES, C4K_EPS = 4096, 50_000, (1.0, 0.02), 8e-2
# The SA slice's main paths at run_sa's defaults (synthetic 512x512, N=512,
# 8 tries, exact-tight), cut in depth only: iterations of batched SA (K1 once
# an iteration at B=8), sequential SA (eight times at B=1), PT with 4
# replicas (once at B=32), the fast tier and the SSIM metric; Adam steps of
# run_grad --metric mix and generations of run_ga --metric ssim
SA_ITERS, SA_SEQ_ITERS, PT_ITERS, PT_K = 300, 30, 200, 4
SA_FAST_ITERS, SA_SSIM_ITERS, GRAD_MIX_STEPS, GA_SSIM_GENS = 200, 100, 30, 30
SA_SHORT_ITERS = 50  # run_sa under bf16, and under highest with the mix metric and PT
SA_BLOCKS, SA_BLOCK_ITERS, SA_SEQ_BLOCK_ITERS = 5, 20, 4  # iterations/s: timed blocks
PROFILE_ATTEMPTS = 3  # torch.profiler sessions a profile may take when one records no kernel
SSIM_B = 8  # SSIM-metric renders/s: the batch of run_sa --metric ssim
SSIM_F64_ATOL = 1e-6  # the card's f32 SSIM against the same function in f64 on the CPU
# The pipeline slice at the widths of run_pipeline's defaults (512x512, N=512,
# P=32, elite 8) on the photo, budgets cut: grow-auto from N=64 doubling to
# 512, a stage ending after PIPE_GROW_PATIENCE generations without a better
# best (read at 100-generation blocks), recycles every 100, frames every 2 in
# the last stage, then the Adam polish
PIPE_ARGV = ["--image", "photo", "--ga-generations", "600", "--grow-patience", "20",
             "--recycle-every", "100", "--adam-steps", "40"]
PIPE_NS, PIPE_P = [64, 128, 256, 512], 32  # the stages' splats, and run_ga's population
ADAM_N = 2000  # run_grad's default splats: the annealed Adam block
ANNEAL_SIGMA0, ANNEAL_GA_GENS, ANNEAL_GRAD_STEPS = 8.0, 300, 40
GROW_FAST_GENS, GROW_FAST_NS = 300, [128, 256, 512]  # run_ga --grow-stages 3 --precision fast
# the annealed GA's launches a generation above the plain GA's: its one
# blur_genome_axes of the offspring, 17 elementwise kernels (7 mul, 2 exp,
# 2 add, 2 log, 2 div, sqrt, cat; torch.profiler's op count on the CPU)
BLUR_LAUNCHES = 17
RATE_PAIRS, RATE_GA_GENS, RATE_ADAM_STEPS = 3, 50, 20  # annealed vs plain, in turns
GROW_P, GROW_N_NEW = 32, 256  # grow_population's time: the 256 -> 512 growth
# the checkpoint / island / profile slice
ISLAND_ARGV = ["--islands", "4", "--migrate-every", "10", "--migrate-k", "2"]
ISLANDS, ISLAND_EVERY, ISLAND_K = (int(x) for x in ISLAND_ARGV[1::2])
ISLAND_GENS, ISLAND_FAST_GENS = 200, 50  # run_ga --islands 4, exact-tight and fast
RESUME_GENS, RESUME_EVERY = 200, 50  # run_ga stopped after its RESUME_GENS // 2 checkpoint
RESUME_K = 5  # block resumes: run(2k) == run(k) -> save -> load -> run(k)
PROFILE_ARGV = ["--generations", "30", "--log-every", "10"]  # run_ga --profile-dir: 3 blocks


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


_T0 = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _T0:.1f} s)", flush=True)


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms: CUDA events around `reps` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def make_case(B, N, H, W, precision, cap=None, tile_h=64, tile_w=128, seed=0, device="cuda",
              cull_eps=None, y_origin=0, rows=None):
    """Random population (seeded) -> the walk's inputs at these shapes. Under
    "fast": fast fitness's route (K4's table and boxes, corner-culled lists).
    With `rows`: the lists of the row slab [y_origin, y_origin + rows) of the
    H x W canvas, as fitness_partial builds them (shifted boxes, under "fast"
    the shifted table and the corner cull; no K4), and the slab's rows of
    the target and mask."""
    import torch

    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, mask, render_cuda, screen
    from ggs_tpu_torch.utils import io

    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    g9 = codec.genome_to_renderer(genome.new_population(gen, B, N, H, W, device=dev))
    slab = rows is not None
    rows = H if rows is None else rows
    n_tx, n_ty = -(-W // tile_w), -(-rows // tile_h)
    t = screen.tier(precision, cull_eps, True)
    if t.mode == "fast" and not slab:
        cnt, idx, feats = render_cuda._k4_pass(g9, H, W, 3.0, cap, tile_h, tile_w, t)
    else:
        p = screen.screen(g9, H, W, 3.0, t, y_origin)
        cnt, idx, feats = render_cuda._pass_lists(p, n_tx, n_ty, tile_h, tile_w, cap, t)
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device=dev)
    w = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
    tgt, w = tgt[y_origin:y_origin + rows], w[y_origin:y_origin + rows]
    tgt_p, w_p = render_cuda.pad_planes(tgt, w, n_ty * tile_h, n_tx * tile_w)
    return dict(cnt=cnt, idx=idx, feats=feats, tgt_p=tgt_p, w_p=w_p, n_tx=n_tx,
                tile_h=tile_h, tile_w=tile_w, g9=g9, H=H, W=W, precision=precision,
                cull_eps=cull_eps)


def pair_counts(c):
    """(pixels, columns) of the tile inside a listed splat's box, summed
    over every (candidate, tile, k < cnt): the walk's data-dependent work.
    The fast table holds the open thresholds x0-1, x1+1, y0-1, y1+1."""
    import torch

    cnt, idx, feats = c["cnt"], c["idx"], c["feats"]
    B, T, L = idx.shape
    n_tx, th, tw = c["n_tx"], c["tile_h"], c["tile_w"]
    boxes = torch.gather(
        feats[:, 9:13, :], 2, idx.long().reshape(B, 1, T * L).expand(B, 4, T * L)
    ).reshape(B, 4, T, L)
    if c.get("precision") == "fast":
        boxes = boxes + torch.tensor([1.0, -1.0, 1.0, -1.0], device=boxes.device)[None, :, None, None]
    t = torch.arange(T, device=idx.device)
    tx0 = ((t % n_tx) * tw).float()[None, :, None]
    ty0 = ((t // n_tx) * th).float()[None, :, None]
    wx = torch.minimum(boxes[:, 1], tx0 + tw - 1) - torch.maximum(boxes[:, 0], tx0) + 1
    hy = torch.minimum(boxes[:, 3], ty0 + th - 1) - torch.maximum(boxes[:, 2], ty0) + 1
    valid = torch.arange(L, device=idx.device)[None, None, :] < cnt[:, :, None]
    wx, hy = wx.clamp_min(0).double() * valid, hy.clamp_min(0).double()
    cols = wx * (hy > 0)
    return int((wx * hy).sum().item()), int(cols.sum().item())


def bound(c, kernel: str):
    """(bound_ms, bound_by) for one launch on these inputs: the larger of
    operations over the peak rate of their type (f32; K1-bf16's bf16 part
    at the bf16 rate) and bytes (inputs read once, outputs written once;
    only the cnt entries of each list) over memory rate."""
    B, T, _ = c["idx"].shape
    Hp, Wp = c["w_p"].shape
    n_list = int(c["cnt"].sum().item())
    pixels = B * Hp * Wp
    pair_px, pair_cols = pair_counts(c)
    walk_ops = pair_px * OPS_PER_PAIR_PIXEL + pair_cols * OPS_PER_PAIR_COLUMN
    in_bytes = 4 * (B * T + n_list + c["feats"].numel())
    bf16_ops = 0
    if kernel in ("K6", "K7"):
        N = c["feats"].shape[2] - 1
        ops = pair_px * OPS_PER_PAIR_PIXEL_GRAD + pair_cols * OPS_PER_PAIR_COLUMN_GRAD
        nbytes = in_bytes + 4 * 9 * B * N  # + the gradients
        if kernel == "K7":
            ops += pixels * OPS_PER_PIXEL_K7
            nbytes += 4 * (4 * Hp * Wp) + 4 * B * T  # target, weights; num
        else:
            nbytes += 4 * 3 * pixels  # the image cotangent
            if c.get("init") is not None:  # init read, d(init) = g * T_total written
                ops += 3 * pixels
                nbytes += 2 * 4 * 3 * pixels
    elif kernel in ("K1", "K1-bf16"):
        ops = walk_ops + pixels * OPS_PER_PIXEL_K1
        nbytes = in_bytes + 4 * (4 * Hp * Wp) + 4 * B * T
        if kernel == "K1-bf16":
            bf16_ops = pair_px * BF16_OPS_PER_PAIR_PIXEL + pair_cols * BF16_OPS_PER_PAIR_COLUMN
            ops -= bf16_ops
    elif kernel in ("K3", "K3-canvas"):
        ops = pair_px * OPS_PER_PAIR_PIXEL_FAST + pair_cols * OPS_PER_PAIR_COLUMN
        if kernel == "K3":
            ops += pixels * OPS_PER_PIXEL_K1
            nbytes = in_bytes + 4 * (4 * Hp * Wp) + 4 * B * T
        else:
            ops += pixels * OPS_PER_PIXEL_K2
            nbytes = in_bytes + 4 * 3 * pixels
    else:
        ops = walk_ops + pixels * OPS_PER_PIXEL_K2
        nbytes = in_bytes + 4 * 3 * pixels
    t_ops = ops / PEAK_FP32_FLOPS + bf16_ops / PEAK_BF16_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def run_k1(c):
    from ggs_tpu_torch.ops import render_cuda as rc

    return rc.fitness_tiles(c["cnt"], c["idx"], c["feats"], c["tgt_p"], c["w_p"], c["n_tx"],
                            c["tile_h"], c["tile_w"], (1.0, 1.0, 1.0))


def run_k1_plain(c):
    from ggs_tpu_torch.ops import render_cuda as rc

    return rc.fitness_tiles_plain(c["cnt"], c["idx"], c["feats"], c["tgt_p"], c["w_p"],
                                  c["n_tx"], c["tile_h"], c["tile_w"], (1.0, 1.0, 1.0))


def run_k2(c):
    from ggs_tpu_torch.ops import render_cuda as rc

    return rc.render_tiles(c["cnt"], c["idx"], c["feats"], c["n_tx"], c["tile_h"],
                           c["tile_w"], (1.0, 1.0, 1.0))


def run_k2_plain(c):
    from ggs_tpu_torch.ops import render_cuda as rc

    return rc.render_tiles_plain(c["cnt"], c["idx"], c["feats"], c["n_tx"], c["tile_h"],
                                 c["tile_w"], (1.0, 1.0, 1.0))


def k4_bound(B: int, N: int):
    """(bound_ms, bound_by) of one K4 launch: the genome read once, the fast
    table [B, 13, N+1] and boxes [B, 4, N] written once."""
    nbytes = 4 * (9 * B * N + 13 * B * (N + 1) + 4 * B * N)
    t_ops, t_bytes = OPS_PER_SPLAT_K4 * B * N / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def run_k3(c, plain=False):
    from ggs_tpu_torch.ops import render_cuda as rc

    args = (c["cnt"], c["idx"], c["feats"], c["tgt_p"], c["w_p"], c["n_tx"], c["tile_h"],
            c["tile_w"], (1.0, 1.0, 1.0))
    return rc.fitness_tiles_plain(*args, mode="fast") if plain else rc.fitness_tiles_fast(*args)


def run_k3_canvas(c, plain=False):
    from ggs_tpu_torch.ops import render_cuda as rc

    args = (c["cnt"], c["idx"], c["feats"], c["n_tx"], c["tile_h"], c["tile_w"], (1.0, 1.0, 1.0))
    if plain:
        return rc.render_tiles_plain(*args, mode="fast")
    return rc.render_tiles_fast(*args)


def run_k1_bf16(c, plain=False):
    from ggs_tpu_torch.ops import render_cuda as rc

    args = (c["cnt"], c["idx"], c["feats"], c["tgt_p"], c["w_p"], c["n_tx"], c["tile_h"],
            c["tile_w"], (1.0, 1.0, 1.0))
    return rc.fitness_tiles_plain(*args, mode="bf16") if plain else rc.fitness_tiles_bf16(*args)


def run_k4(c, plain=False):
    from ggs_tpu_torch.ops import render_cuda as rc

    fn = rc.prep_fast_plain if plain else rc.prep_fast
    return fn(c["g9"], c["H"], c["W"], 3.0, c["cull_eps"])


def rel_err(got, want):
    """max |got - want| / |want| of two fitness sums [B]."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() / w.abs().clamp_min(1e-30)).max())


def compare_fast(c, label: str) -> dict:
    """K3 (both epilogues) and K4 against their plain versions: the walk on
    bit-identical lists (K4's own table and boxes), K4's table within
    K4_ULPS ulp with its -inf entries equal and its boxes equal."""
    import torch

    k3c, p3c = run_k3_canvas(c), run_k3_canvas(c, plain=True)
    k3, p3 = run_k3(c), run_k3(c, plain=True)
    (ff, fi), (ff_p, fi_p) = run_k4(c), run_k4(c, plain=True)
    torch.cuda.synchronize()
    canvas_err = float((k3c - p3c).abs().max())
    fit_rel = rel_err(k3.sum(1), p3.sum(1))
    part_err = float((k3 - p3).abs().max())
    same = torch.equal(k3, run_k3(c))
    fin = torch.isfinite(ff_p)
    ulps = (ff.view(torch.int32).long() - ff_p.view(torch.int32).long()).abs()[fin]
    k4_ulps = int(ulps.max()) if ulps.numel() else 0
    inf_same = torch.equal(torch.isneginf(ff), torch.isneginf(ff_p))
    fi_diff = int((fi != fi_p).sum())
    k4_err = float((ff - ff_p)[fin].abs().max())
    print(f"CHECK {label}: K3 canvas max abs {canvas_err:.3e} (<= {CANVAS_ATOL}), K3 fitness "
          f"max rel {fit_rel:.3e} (<= {FITNESS_RTOL}), same bits twice {same}; K4 table max "
          f"{k4_ulps} ulp (<= {K4_ULPS}), -inf equal {inf_same}, boxes differing {fi_diff}; "
          f"max cnt {int(c['cnt'].max())}, pairs {int(c['cnt'].sum())}", flush=True)
    check(canvas_err <= CANVAS_ATOL, f"{label}: K3 canvas differs by {canvas_err}")
    check(fit_rel <= FITNESS_RTOL, f"{label}: K3 fitness differs by {fit_rel}")
    check(same, f"{label}: K3 is not the same bits on a second launch")
    check(k4_ulps <= K4_ULPS and inf_same, f"{label}: K4's table differs by {k4_ulps} ulp")
    check(fi_diff == 0, f"{label}: K4's boxes differ in {fi_diff} entries")
    return {"canvas": canvas_err, "fitness_rel": fit_rel, "partials": part_err, "k4_ulps": k4_ulps,
            "k4_abs": k4_err}


def compare_bf16(c, label: str) -> dict:
    """K1-bf16 against its plain version (torch bf16 on the card), and
    against K1 (the f32 walk) on the same lists, from which it must differ."""
    import torch

    k, p = run_k1_bf16(c), run_k1_bf16(c, plain=True)
    torch.cuda.synchronize()
    fit_rel = rel_err(k.sum(1), p.sum(1))
    f32_gap = rel_err(k.sum(1), run_k1(c).sum(1))
    same = torch.equal(k, run_k1_bf16(c))
    print(f"CHECK {label}: K1-bf16 fitness max rel {fit_rel:.3e} (<= {BF16_RTOL}), partials max "
          f"abs {float((k - p).abs().max()):.3e}, same bits twice {same}; vs K1 (f32) max rel "
          f"{f32_gap:.3e} (>= {BF16_MIN_GAP})", flush=True)
    check(fit_rel <= BF16_RTOL, f"{label}: K1-bf16 fitness differs by {fit_rel}")
    check(same, f"{label}: K1-bf16 is not the same bits on a second launch")
    check(f32_gap >= BF16_MIN_GAP, f"{label}: K1-bf16 is within {f32_gap} of the f32 walk")
    return {"fitness_rel": fit_rel, "partials": float((k - p).abs().max()), "vs_f32": f32_gap}


def check_fast_entry_points() -> None:
    """evaluate (fast at both eps, bf16) and render_genomes (fast) on the
    card against the same calls on the CPU (the plain route)."""
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import mask, objective
    from ggs_tpu_torch.utils import io

    import torch

    H, W = 40, 200
    g = genome.new_population(torch.Generator().manual_seed(17), 3, 24, H, W, 1.0, 0.3, "cpu")
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device="cpu")
    wm = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
    worst = {}
    for prec, eps, rtol in (("fast", 2e-3, FITNESS_RTOL), ("fast", 8e-2, FITNESS_RTOL),
                            ("bf16", None, BF16_RTOL)):
        obj = objective.Objective(H=H, W=W, precision=prec, cull_eps=eps)
        got = objective.evaluate(obj, g.cuda(), tgt.cuda(), wm.cuda(), device="cuda").cpu()
        want = objective.evaluate(obj, g, tgt, wm, device="cpu")
        worst[f"{prec}_{eps}"] = rel = rel_err(got, want)
        check(rel <= rtol, f"{prec} eps={eps}: evaluate on the card differs by {rel}")
    obj = objective.Objective(H=H, W=W, precision="fast", cull_eps=8e-2)
    img = objective.render_genomes(obj, g.cuda(), device="cuda").cpu()
    img_err = float((img - objective.render_genomes(obj, g, device="cpu")).abs().max())
    print(f"CHECK fast/bf16 entry points on the card vs the CPU plain route (B=3 N=24 40x200): "
          f"fitness max rel {fmt(worst.values())} {list(worst)}, fast canvas max abs "
          f"{img_err:.3e}", flush=True)
    check(img_err <= 2 * CANVAS_ATOL, f"fast render on the card differs by {img_err}")


def selection_fidelity(tgt, wm) -> dict:
    """benchmarks/eps_sweep.py on the card: FIDELITY_POPS random populations
    of FIDELITY_B at N=512 on the 512x512 target with the importance mask;
    per eps, the largest exact-fitness gap that fast scoring inverts, over
    the mean exact fitness, and the populations with any rank change."""
    import torch

    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import objective

    H, W, dev = tgt.shape[0], tgt.shape[1], tgt.device
    pops = [genome.new_population(torch.Generator(device=dev).manual_seed(100 + r),
                                  FIDELITY_B, 512, H, W, device=dev)
            for r in range(FIDELITY_POPS)]
    exact = [objective.evaluate(objective.Objective(H=H, W=W), p, tgt, wm, device=dev)
             for p in pops]
    out = {}
    for eps in (2e-3, 8e-2):
        obj = objective.Objective(H=H, W=W, precision="fast", cull_eps=eps)
        gap, moved = 0.0, 0
        for p, fe in zip(pops, exact):
            ff = objective.evaluate(obj, p, tgt, wm, device=dev)
            moved += int(not torch.equal(torch.argsort(ff), torch.argsort(fe)))
            inverted = (ff[:, None] - ff[None, :] > 0) & (fe[:, None] - fe[None, :] < 0)
            g = torch.where(inverted, fe[None, :] - fe[:, None], 0.0) / fe.mean()
            gap = max(gap, float(g.max()))
        out[str(eps)] = {"max_inverted_rel_gap": gap, "rank_changed_pops": moved}
    print("FIDELITY " + json.dumps({"pops": FIDELITY_POPS, "B": FIDELITY_B, **out}), flush=True)
    for eps, r in out.items():
        check(r["max_inverted_rel_gap"] < FIDELITY_MAX_GAP,
              f"eps={eps}: fast scoring inverts an exact gap of {r['max_inverted_rel_gap']}")
    return out


def compare(c, label: str) -> dict:
    """K1 and K2 against their plain versions on the same lists."""
    import torch

    k2, p2 = run_k2(c), run_k2_plain(c)
    k1, p1 = run_k1(c), run_k1_plain(c)
    torch.cuda.synchronize()
    canvas_err = float((k2 - p2).abs().max())
    f_k, f_p = k1.sum(1).double(), p1.sum(1).double()
    fit_rel = float(((f_k - f_p).abs() / f_p.abs().clamp_min(1e-30)).max())
    part_err = float((k1 - p1).abs().max())
    again = run_k1(c)
    print(f"CHECK {label}: K2 canvas max abs {canvas_err:.3e} (<= {CANVAS_ATOL}), "
          f"K1 fitness max rel {fit_rel:.3e} (<= {FITNESS_RTOL}), K1 partials max abs "
          f"{part_err:.3e}, max cnt {int(c['cnt'].max())}", flush=True)
    check(canvas_err <= CANVAS_ATOL, f"{label}: K2 canvas differs by {canvas_err}")
    check(fit_rel <= FITNESS_RTOL, f"{label}: K1 fitness differs by {fit_rel}")
    check(torch.equal(again, k1), f"{label}: K1 is not the same bits on a second launch")
    return {"canvas": canvas_err, "fitness_rel": fit_rel, "partials": part_err}


def make_grad_case(B, N, H, W, seed=0, device="cuda", tile_h=None, y_origin=0, rows=None):
    """Random genomes (seeded) -> the gradient walks' inputs: exact-tight
    lists on list tiles tile_h x 128 (default the port's GRAD_TILE_H), the
    raw and folded tables, the padded target and mask, and K6's image
    cotangent (K7's own head); with `rows`, those of a row slab (make_case)."""
    import torch

    from ggs_tpu_torch.ops import codec, render_cuda as rc, render_grad as rg

    th, tw = tile_h or rg.GRAD_TILE_H, rg.GRAD_TILE_W
    c = make_case(B, N, H, W, "exact-tight", tile_h=th, tile_w=tw, seed=seed, device=device,
                  y_origin=y_origin, rows=rows)
    p = codec.tighten_boxes_exact(
        rc.shift_rows(codec.preprocess(c["g9"], H, W, 3.0), y_origin), 3.0)
    c["feats_fast"], c["feats"] = c["feats"], rg._splat_feats(p)
    canvas = run_k2(dict(c, feats=c["feats_fast"]))
    c["g_img"] = (2.0 * c["w_p"] * (torch.clamp(canvas, 0.0, 1.0) - c["tgt_p"][None])).contiguous()
    return c


def run_k6(c, plain=False):
    from ggs_tpu_torch.ops import render_grad as rg

    fn = rg.bwd_tiles_plain if plain else rg.bwd_tiles
    grads, _ = fn(c["cnt"], c["idx"], c["feats"], c["g_img"], c["n_tx"], c["tile_h"], c["tile_w"],
                  (1.0, 1.0, 1.0))
    return grads


def run_k7(c, plain=False):
    from ggs_tpu_torch.ops import render_grad as rg

    fn = rg.lossgrad_tiles_plain if plain else rg.lossgrad_tiles
    return fn(c["cnt"], c["idx"], c["feats"], c["tgt_p"], c["w_p"], c["n_tx"], c["tile_h"],
              c["tile_w"], (1.0, 1.0, 1.0), 2.0)


def row_err(got, want):
    """[9]: max |got - want| of each gradient row (one field over every
    image and splat of [B, 9, N]) over that row's largest |want|."""
    scale = want.abs().amax(dim=(0, 2)).clamp_min(1e-30)
    return (got - want).abs().amax(dim=(0, 2)) / scale


def compare_grad(c, label: str) -> dict:
    """K6 and K7 against their plain versions on the same lists, K7's num
    against K1, K6 against K7 (fed K7's own cotangent), and the same bits
    on a second launch."""
    import torch

    num, g7 = run_k7(c)
    num_p, g7_p = run_k7(c, plain=True)
    g6, g6_p = run_k6(c), run_k6(c, plain=True)
    k1 = run_k1(dict(c, feats=c["feats_fast"]))
    torch.cuda.synchronize()
    err7 = float((g7 - g7_p).abs().max())
    err6 = float((g6 - g6_p).abs().max())
    rows7, rows6 = row_err(g7, g7_p).tolist(), row_err(g6, g6_p).tolist()
    n_k, n_1 = num.sum(1).double(), k1.sum(1).double()
    num_rel = float(((n_k - n_1).abs() / n_1.abs().clamp_min(1e-30)).max())
    num_plain_rel = float(((n_k - num_p.sum(1).double()).abs() / n_1.abs()).max())
    k6_k7 = float(row_err(g6, g7).max())
    num2, g7b = run_k7(c)
    same7 = torch.equal(num, num2) and torch.equal(g7, g7b)
    same6 = torch.equal(g6, run_k6(c))
    row_max = g7_p.abs().amax(dim=(0, 2)).tolist()
    print(f"CHECK {label}: per gradient row, max|plain| {fmt(row_max)}, K7 err/row max "
          f"{fmt(rows7)}, K6 {fmt(rows6)} (each <= {GRAD_ROW_REL}); max abs K7 {err7:.3e} K6 "
          f"{err6:.3e}; K7 num vs K1 max rel {num_rel:.3e} (<= {FITNESS_RTOL}), vs plain "
          f"{num_plain_rel:.3e}; K6 vs K7 per row {k6_k7:.3e} (<= {GRAD_SCALED_ATOL}); same bits "
          f"K6 {same6} K7 {same7}; max cnt {int(c['cnt'].max())}", flush=True)
    check(max(rows7) <= GRAD_ROW_REL, f"{label}: K7 gradients differ from the plain version")
    check(max(rows6) <= GRAD_ROW_REL, f"{label}: K6 gradients differ from the plain version")
    check(num_rel <= FITNESS_RTOL, f"{label}: K7 num differs from K1 by {num_rel}")
    check(num_plain_rel <= FITNESS_RTOL, f"{label}: K7 num differs from its plain version")
    check(k6_k7 <= GRAD_SCALED_ATOL, f"{label}: K6 and K7 gradients differ by {k6_k7}")
    check(same6 and same7, f"{label}: K6/K7 are not the same bits on a second launch")
    return {"K7": err7, "K6": err6, "K7_rows": rows7, "K6_rows": rows6, "num_rel": num_rel,
            "K6_vs_K7": k6_k7}


BG = (1.0, 1.0, 1.0)


def init_canvas(B, Hp, Wp, seed, device="cuda"):
    """A seeded canvas [B, 3, Hp, Wp] in [0.05, 0.95]: what a chained pass
    starts from."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.rand((B, 3, Hp, Wp), generator=gen, device=device) * 0.9 + 0.05


def compare_init(c, mode: str, label: str, init_must_show: bool = True) -> dict:
    """K1/K2 (mode "exact"), K3 (both epilogues, "fast") or K1-bf16 ("bf16")
    from an init canvas against its plain version from the same canvas: the
    case's own (a chained pass's) or a seeded one; the same tolerances as
    from the background, the same bits twice, and (init_must_show) the init
    must change the result."""
    import torch

    from ggs_tpu_torch.ops import render_cuda as rc

    init = c.get("init")
    if init is None:
        init = init_canvas(c["idx"].shape[0], *c["w_p"].shape, seed=40, device=c["idx"].device)
    fit = {"exact": rc.fitness_tiles, "fast": rc.fitness_tiles_fast,
           "bf16": rc.fitness_tiles_bf16}[mode]
    args = (c["cnt"], c["idx"], c["feats"], c["tgt_p"], c["w_p"], c["n_tx"], c["tile_h"],
            c["tile_w"], BG)
    k = fit(*args, init=init)
    p = rc.fitness_tiles_plain(*args, mode=mode, init=init)
    torch.cuda.synchronize()
    rel, part = rel_err(k.sum(1), p.sum(1)), float((k - p).abs().max())
    same = torch.equal(k, fit(*args, init=init))
    moved = not torch.equal(k, fit(*args))
    canvas_err = 0.0
    if mode != "bf16":
        walk = rc.render_tiles_fast if mode == "fast" else rc.render_tiles
        kc = walk(*args[:3], *args[5:], init=init)
        pc = rc.render_tiles_plain(*args[:3], *args[5:], mode=mode, init=init)
        canvas_err = float((kc - pc).abs().max())
        same = same and torch.equal(kc, walk(*args[:3], *args[5:], init=init))
        del kc, pc
    B, T, _ = c["idx"].shape
    rtol = BF16_RTOL if mode == "bf16" else FITNESS_RTOL
    print(f"CHECK init canvas, {mode} walk, {label} (B={B} T={T} max cnt {int(c['cnt'].max())}): "
          f"fitness max rel {rel:.3e} (<= {rtol}), partials max abs {part:.3e}, canvas max abs "
          f"{canvas_err:.3e} (<= {CANVAS_ATOL}), same bits twice {same}, the init changes the "
          f"fitness {moved}", flush=True)
    check(rel <= rtol and canvas_err <= CANVAS_ATOL, f"{mode} walk from an init canvas, {label}")
    check(same, f"{mode} walk from an init canvas, {label}: not the same bits twice")
    check(moved or not init_must_show, f"{mode} walk from an init canvas, {label}: init ignored")
    return {"fitness_rel": rel, "partials": part, "canvas": canvas_err, "init_shows": moved}


def faint(c) -> dict:
    """The case with every alpha / 32 (row 8 of its table: alpha, or
    log2(alpha) in the fast table): the same lists and shapes, with an init
    canvas showing through a pass of many layers."""
    f = c["feats"].clone()
    if c.get("precision") == "fast":
        f[:, 8] -= 5.0
    else:
        f[:, 8] *= 1.0 / 32
    return dict(c, feats=f)


def chained_case(g9, tgt, wm, precision, cull_eps=None, corner_cull=False, tile_h=64):
    """The last pass of a chained fitness at a main path's shape, built as
    render_cuda.fitness builds it (tile_w 128): its lists (K5 from 256
    tiles) and table, and as `init` the canvas the passes before it leave
    (K2's, or K3's under "fast")."""
    from ggs_tpu_torch.ops import render_cuda as rc, screen

    H, W = tgt.shape[0], tgt.shape[1]
    n_tx, n_ty = -(-W // 128), -(-H // tile_h)
    t = screen.tier(precision, cull_eps, corner_cull)
    p = screen.screen(g9, H, W, 3.0, t)
    init, (cnt, idx, feats) = rc._chunked_passes(p, H, W, tile_h, 128, BG, None, True, t)
    check(init is not None, "the chained case has one pass")
    tgt_p, w_p = rc.pad_planes(tgt, wm, n_ty * tile_h, n_tx * 128)
    return dict(cnt=cnt, idx=idx, feats=feats, tgt_p=tgt_p, w_p=w_p, n_tx=n_tx, tile_h=tile_h,
                tile_w=128, init=init, precision=precision)


def chained_grad_case(g9, tgt, wm):
    """The second of two passes of render_diff at run_grad's exact-tight
    boxes, built as render_grad.RenderDiff builds it: the pass's lists on
    the gradient tiles (K5 from 256 tiles), its raw table (and the folded
    one K2' walks, `feats_fast`), `init` the first pass's K2 canvas, and the
    image cotangent of the weighted SSE of the chained canvas."""
    import torch

    from ggs_tpu_torch.ops import render_cuda as rc, render_grad as rg, screen

    H, W = tgt.shape[0], tgt.shape[1]
    t = screen.box_tier("tight")
    with torch.no_grad():
        p = screen.screen(g9, H, W, 3.0, t)
    pcs = screen.passes(p)
    check(len(pcs) == 2, f"the gradient case chains {len(pcs)} passes, not 2")
    init = None
    for i, pc in enumerate(pcs):
        geom = rg._geometry(H, W, pc.cx.shape[1], None, BG, t)
        n_tx, n_ty, th, tw = geom[:4]
        idx, cnt = rg._bin(pc, geom)
        canvas = rc.render_tiles(cnt, idx, rc._splat_feats_fast(pc), n_tx, th, tw, BG, init=init)
        if i < len(pcs) - 1:
            first = canvas
        init = canvas
    tgt_p, w_p = rc.pad_planes(tgt, wm, n_ty * th, n_tx * tw)
    g_img = (2.0 * w_p * (torch.clamp(canvas, 0.0, 1.0) - tgt_p[None])).contiguous()
    return dict(cnt=cnt, idx=idx, feats=rg._splat_feats(pc), g_img=g_img, n_tx=n_tx, tile_h=th,
                tile_w=tw, w_p=w_p, init=first, feats_fast=rc._splat_feats_fast(pc))


def compare_grad_init(c, label: str, init_must_show: bool = True) -> dict:
    """K6 from an init canvas (the case's own, a chained pass's, or a seeded
    one) against its plain version: each gradient row and d(init) = g *
    T_total within GRAD_ROW_REL of their largest plain magnitude; the same
    bits twice; and (init_must_show) d(init) not 0 everywhere."""
    import torch

    from ggs_tpu_torch.ops import render_grad as rg

    init = c.get("init")
    if init is None:
        init = init_canvas(c["idx"].shape[0], *c["w_p"].shape, seed=41, device=c["idx"].device)
    args = (c["cnt"], c["idx"], c["feats"], c["g_img"], c["n_tx"], c["tile_h"], c["tile_w"], BG)
    g6, d6 = rg.bwd_tiles(*args, init=init)
    g6_p, d6_p = rg.bwd_tiles_plain(*args, init=init)
    torch.cuda.synchronize()
    rows = row_err(g6, g6_p).tolist()
    d_max = float(d6_p.abs().max())
    d_rel = float((d6 - d6_p).abs().max()) / max(d_max, 1e-30)
    g6b, d6b = rg.bwd_tiles(*args, init=init)
    same = torch.equal(g6, g6b) and torch.equal(d6, d6b)
    B, T, L = c["idx"].shape
    print(f"CHECK K6 from an init canvas, {label} (B={B} T={T} list width {L} max cnt "
          f"{int(c['cnt'].max())}): err/row {fmt(rows)}, d(init) max rel {d_rel:.3e} (each <= "
          f"{GRAD_ROW_REL}), max |d(init)| {d_max:.3e}, same bits twice {same}", flush=True)
    check(max(rows) <= GRAD_ROW_REL and d_rel <= GRAD_ROW_REL, f"K6 from an init canvas, {label}")
    check(same, f"K6 with init, {label}: not the same bits on a second launch")
    check(d_max > 0.0 or not init_must_show, f"K6 with init, {label}: d(init) is 0 everywhere")
    return {"rows": rows, "dinit_rel": d_rel, "max_abs": float((g6 - g6_p).abs().max()),
            "dinit_max": d_max}


def scatter_case(B, N, side, tile_h, precision, eps=None, chunk=None, scales=(3.0, 0.1), seed=0,
                 coincident=0, pad_slots=8, device="cuda", y_origin=0, rows=None, cull=True):
    """Seeded genomes -> K5's arguments for the first pass (`chunk` splats)
    of a chained render at this shape: the tier's boxes, the corner
    parameters under "fast" (none with cull=False: the eps-tight boxes
    alone, the dead ones empty, x1 = -1); `coincident` splats of candidate 0 at the
    canvas centre (sigma 4 px) force the overflow fallback. With `rows`, the
    pass of the row slab [y_origin, y_origin + rows) (shifted boxes)."""
    import torch

    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, render_cuda as rc, screen

    gen = torch.Generator(device=device).manual_seed(seed)
    g = genome.new_population(gen, B, N, side, side, *scales, device=device)
    if coincident:
        g[0, :coincident] = torch.tensor([0.5, 0.5, 1.4, 1.4, 0.0, 128.0, 128.0, 128.0, 200.0],
                                         device=device)
    p = screen.screen(codec.genome_to_renderer(g), side, side, 3.0, screen.tier(precision, eps),
                      y_origin)
    if chunk is not None:
        p = rc._split_screen(p, 0, chunk)
    corner = rc._corner_params(p, eps) if eps is not None and cull else None
    n = p.cx.shape[1]
    n_t = -(-side // 128), -(-(rows or side) // tile_h)
    args = rc.scatter_args(p.x0, p.x1, p.y0, p.y1, *n_t, tile_h, 128, n, pad_slots, corner=corner)
    check(args is not None, "the scatter rules chose the dense route")
    return {"args": args, "p": p, "corner": corner, "pad_slots": pad_slots}


def run_k5(sc):
    """K5 on the card: the binning of the pass from its boxes (and corner
    parameters) -> (idx, cnt, tmax)."""
    from ggs_tpu_torch.ops import render_cuda as rc

    a, p = sc["args"], sc["p"]
    return rc.bin_splats_scatter(p.x0, p.x1, p.y0, p.y1, a["n_tx"], a["n_ty"], a["tile_h"],
                                 a["tile_w"], a["cap"], sc["pad_slots"], sc["corner"])


def compare_scatter(sc, label, dense=False) -> dict:
    """K5, its whole route from the boxes on the card, against its plain
    route (scatter_args, then bin_splats_scatter_plain): idx over its whole
    width, cnt and the largest true count integer-equal; the same bits
    twice; with bands, the band stage's entries and counts equal to its
    plain version's (under the cull its column ranges are
    _corner_band_xranges'); with dense=True (no corner cull) also equal to
    bin_splats_dense."""
    import torch

    from ggs_tpu_torch.ops import render_cuda as rc

    args, p = sc["args"], sc["p"]
    idx, cnt, tmax = run_k5(sc)
    idx_p, cnt_p, tmax_p = rc.bin_splats_scatter_plain(**args)
    torch.cuda.synchronize()
    diff = int((idx != idx_p).sum()) + int((cnt != cnt_p).sum())
    err = int((idx.long() - idx_p.long()).abs().max())
    again = run_k5(sc)
    same = torch.equal(again[0], idx) and torch.equal(again[1], cnt)
    overflow = args["fallback"] is not None and int(tmax) > args["cap_s"]
    band_diff = None
    if args["gl"] is not None:
        band = (p.x0, p.x1, p.y0, p.y1, args["n_tx"], args["n_ty"], args["tile_h"],
                args["tile_w"], args["rpg"], sc["corner"] if args["cxr"] is not None else None)
        ent, ec = rc.scatter_band_entries(*band)
        ent_p, ec_p = rc.scatter_band_entries_plain(*band)
        valid = torch.arange(ent.shape[3], device=ec.device) < ec[..., None]
        band_diff = int((ec != ec_p).sum()) + int(((ent != ent_p) & valid[..., None]).sum())
    dense_diff = None
    if dense:
        di, dc = rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, args["n_tx"], args["n_ty"],
                                     args["tile_h"], args["tile_w"], args["cap"])
        dense_diff = int((di != idx).sum()) + int((dc != cnt).sum())
    B, T, cap = idx.shape
    print(f"CHECK K5 {label}: B={B} T={T} cap={cap} cap_s={args['cap_s']} rpg={args['rpg']} "
          f"bands {args['gl'] is not None} band cull {args['cxr'] is not None}: entries differing "
          f"from plain {diff}, true max {int(tmax)} (plain {int(tmax_p)}), overflow fallback "
          f"{overflow}, same bits twice {same}, band entries differing from plain {band_diff}, "
          f"differing from dense {dense_diff}, pairs {int(cnt.sum())}", flush=True)
    check(diff == 0 and int(tmax) == int(tmax_p), f"K5 {label}: differs from its plain version")
    check(same, f"K5 {label}: not the same bits on a second launch")
    check(band_diff in (None, 0), f"K5 {label}: the band stage differs from its plain version")
    check(dense_diff in (None, 0), f"K5 {label}: differs from the dense binning")
    return {"max_abs_err": err, "overflow": overflow, "tmax": int(tmax), "pairs": int(cnt.sum())}


def scatter_bound(x0, x1, y0, y1, n_tx, n_ty, tile_h, tile_w, cap, rpg, corner=None,
                  overflow=False):
    """(bound_ms, bound_by) of the binning of one pass, from the pixel boxes
    [B, N] to the lists, whatever implements it: the boxes (4 words a
    splat) and, under the band cull (`corner`), the six corner parameters
    read once; the lists padded to cap, the counts and the largest count
    written once; OPS_BAND_RANGE f32 operations per (band, splat) of the
    row lists under the cull and, where the overflow fallback takes over
    (overflow), OPS_CORNER_TEST per (tile, splat) pair inside the box's
    tile range. Band lists and column ranges are intermediates."""
    import torch

    B, N = x0.shape
    words = B * n_tx * n_ty * (cap + 1) + 1 + B * N * (4 + (6 if corner is not None else 0))
    tx0, tx1, ty0, ty1 = (torch.div(v, d, rounding_mode="floor")
                          for v, d in ((x0, tile_w), (x1, tile_w), (y0, tile_h), (y1, tile_h)))
    ops = 0
    if corner is not None:
        a = torch.div(ty0.clamp(min=0), rpg, rounding_mode="floor")
        z = torch.div(ty1.clamp(max=n_ty - 1), rpg, rounding_mode="floor")
        ops += OPS_BAND_RANGE * int((z - a + 1).clamp(min=0).long().sum())
    if overflow:
        nx = (tx1.clamp(max=n_tx - 1) - tx0.clamp(min=0) + 1).clamp(min=0)
        ny = (ty1.clamp(max=n_ty - 1) - ty0.clamp(min=0) + 1).clamp(min=0)
        ops += OPS_CORNER_TEST * int((nx.long() * ny.long()).sum())
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, 4 * words / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops > t_bytes else "bytes")


def kernel_device_ms(fn, n: int, name: str) -> float:
    """Device time a call of fn of the kernels whose name holds `name`,
    under torch.profiler (the wrapper's host time is not in it)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and name in e.key:
            t = getattr(e, "self_device_time_total", None)
            us += e.self_cuda_time_total if t is None else t
    return us / 1e3 / n


def walk_report(kern) -> dict:
    """csrc/walk.cu's walk kernels as ptxas built them (registers, static
    shared memory, spill bytes) and the blocks of each that one SM holds
    (cudaOccupancyMaxActiveBlocksPerMultiprocessor)."""
    import re

    # mangled name -> (label, fitness epilogue, blend mode)
    names = {"fitness_kernelILi0E": ("fitness_kernel<0> (K1)", 1, 0),
             "fitness_kernelILi1E": ("fitness_kernel<1> (K3)", 1, 1),
             "fitness_kernelILi2E": ("fitness_kernel<2> (K1-bf16)", 1, 2),
             "render_kernelILi0E": ("render_kernel<0> (K2, K2')", 0, 0),
             "render_kernelILi1E": ("render_kernel<1> (K3 canvas)", 0, 1)}
    out, cur = {}, None
    for line in kern.logs["walk"].splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            hit = next((v for k, v in names.items() if k in m.group(1)), None)
            cur = hit[0] if hit else None
            if hit:
                out[cur] = {"blocks_per_sm": kern.lib.ggs_walk_blocks_per_sm(*hit[1:])}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m:
            out[cur].update(registers=int(m.group(1)), smem_bytes=int(m.group(2)))
    print("WALK " + json.dumps(out), flush=True)
    check(len(out) == len(names), f"ptxas reported {sorted(out)}, not every walk kernel")
    for name, r in out.items():
        check(r.get("blocks_per_sm", 0) > 0, f"{name}: no block fits a SM ({r})")
    return out


def bf16x2_pairs(n: int, seed: int):
    """bf16 operand pairs (a, b) [3n + 4] on the CPU: random finite bit
    patterns; pairs whose exact sum or product lies halfway between two
    bf16 values (ties); and pairs of subnormals and of normals near the
    subnormal range (results that are subnormal)."""
    import torch

    gen = torch.Generator().manual_seed(seed)

    def bits(lo, hi, k):
        u = torch.randint(lo, hi, (k,), generator=gen, dtype=torch.int32)
        sign = torch.randint(0, 2, (k,), generator=gen, dtype=torch.int32) << 15
        return (u | sign).to(torch.int16).view(torch.bfloat16)

    rand = bits(0, 0x7F80, n), bits(0, 0x7F80, n)  # every finite magnitude
    m = bits(0x3F80, 0x4000, n)  # [1, 2): a + 2^-8 * (odd) ties in the sum
    half = torch.full((n,), 2.0 ** -8, dtype=torch.bfloat16)
    tiny = bits(0, 0x0180, n), bits(0, 0x0180, n)  # subnormals and the smallest normals
    a = torch.cat([rand[0], m, tiny[0], torch.tensor([3.0, 1.0078125, 2.0 ** -126, 1.5],
                                                       dtype=torch.bfloat16)])
    b = torch.cat([rand[1], half, tiny[1], torch.tensor([2.0 ** -8, 1.0078125, -(2.0 ** -127),
                                                         2.0 ** -127], dtype=torch.bfloat16)])
    return a, b


def check_bf16x2(kern) -> dict:
    """The walk's bf16x2 add, subtract and multiply on the card (walk.cu's
    own helpers, through ggs_bf16x2_probe) against the f32 result rounded to
    bf16 on the CPU, bit for bit, on bf16x2_pairs: each half correctly
    rounded, ties to even, subnormals kept (not flushed to 0)."""
    import torch

    a, b = bf16x2_pairs(4096, 3)
    n2 = a.numel() // 2 * 2
    a, b = a[:n2], b[:n2]
    ref = {0: a.float() + b.float(), 1: a.float() - b.float(), 2: a.float() * b.float()}
    out = {}
    ad, bd = a.cuda(), b.cuda()
    for op, name in ((0, "add"), (1, "sub"), (2, "mul")):
        res = torch.empty_like(ad)
        rc = kern.lib.ggs_bf16x2_probe(op, ad.data_ptr(), bd.data_ptr(), res.data_ptr(), n2 // 2,
                                       torch.cuda.current_stream().cuda_stream)
        kern.check(rc, "bf16x2 probe")
        want = ref[op].to(torch.bfloat16)
        got = res.cpu()
        differ = int((got.view(torch.int16) != want.view(torch.int16)).sum())
        sub = want.float().abs() < 2.0 ** -126
        out[name] = {"pairs": n2, "differ": differ,
                     "subnormal_results": int((sub & (want.float() != 0)).sum())}
    print("CHECK bf16x2 on the card vs f32 rounded to bf16 (random, ties, subnormals): "
          + json.dumps(out), flush=True)
    for name, r in out.items():
        check(r["differ"] == 0 and r["subnormal_results"] > 0, f"bf16x2 {name}: {r}")
    return out


def fmt(xs) -> str:
    return "[" + " ".join(f"{x:.2e}" for x in xs) + "]"


def check_grad_entry_points() -> None:
    """fused_value_and_grad (K7) and autograd through render_diff (K2 + K6)
    on the card against torch autograd through the dense oracle on the CPU."""
    import torch

    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, fitness, mask, oracle, render_grad as rg
    from ggs_tpu_torch.utils import io

    H, W = 40, 200
    g = genome.new_population(torch.Generator().manual_seed(8), 2, 24, H, W, 1.0, 0.3, "cpu")
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device="cpu")
    wm = mask.compute_importance_mask(tgt, H, W, smooth=3, strength=0.7)
    gc = g.clone().requires_grad_(True)
    img = oracle.render_dense(codec.genome_to_renderer(gc), H, W, box="tight")
    (ref,) = torch.autograd.grad(fitness.fitness_from_images(img, tgt, wm).mean(), gc)
    _, fused = rg.fused_value_and_grad(g.cuda(), tgt.cuda(), wm.cuda(), H, W, box="tight")
    gd = g.cuda().requires_grad_(True)
    img_d = rg.render_diff(codec.genome_to_renderer(gd), H, W, box="tight")
    (unfused,) = torch.autograd.grad(
        fitness.fitness_from_images(img_d, tgt.cuda(), wm.cuda()).mean(), gd
    )
    worst = 0.0
    for got in (fused.cpu(), unfused.cpu()):
        worst = max(worst, float(((got - ref).abs() / (1e-7 + 1e-3 * ref.abs())).max()))
    print(f"CHECK gradient entry points vs CPU dense-oracle autograd (B=2 N=24 40x200): "
          f"worst |diff| / (1e-7 + 1e-3 |ref|) = {worst:.3f} (<= 1)", flush=True)
    check(worst <= 1.0, "gradient entry points disagree with the oracle's autograd")


def check_corner_grad_entry_points(tgt, wm) -> dict:
    """fused_value_and_grad (K7) and autograd through render_diff (K2 + K6)
    under the fast tier's corner cull at run_grad's shape (B=1, N=2000,
    512x512, eps 8e-2), on JAX's list tile (64x128 there): each launch
    counted, and the two paths' losses within FITNESS_RTOL and gradients
    (divided by their largest magnitude) within GRAD_SCALED_ATOL."""
    import torch

    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import codec, fitness, render_grad as rg, screen

    H, W = tgt.shape[0], tgt.shape[1]
    N, eps = 2000, 8e-2
    tile_h = rg._geometry(H, W, N, None, BG, screen.box_tier("reference", eps, True))[2]
    check(tile_h == rg.list_tile_h(N) == 64, f"the corner-culled tile is {tile_h} rows, not JAX's")
    g = genome.new_population(torch.Generator(device="cuda").manual_seed(15), 1, N, H, W,
                              device="cuda")
    reset_kernel_counts()
    (loss_f, _), grads_f = rg.fused_value_and_grad(g, tgt, wm, H, W, cull_eps=eps, corner_cull=True)
    torch.cuda.synchronize()
    fused_counts = read_kernel_counts()
    reset_kernel_counts()
    gd = g.clone().requires_grad_(True)
    img = rg.render_diff(codec.genome_to_renderer(gd), H, W, cull_eps=eps, corner_cull=True)
    loss_u = fitness.fitness_from_images(img, tgt, wm).mean()
    (grads_u,) = torch.autograd.grad(loss_u, gd)
    torch.cuda.synchronize()
    unfused_counts = read_kernel_counts()
    loss_rel = abs(float(loss_f) - float(loss_u)) / float(loss_u)
    scale = float(grads_u.abs().max())
    grad_err = float((grads_f - grads_u).abs().max()) / scale
    print(f"CHECK corner-culled entry points (B=1 N={N} {H}x{W} eps {eps}, {tile_h}x128 lists): "
          f"fused vs unfused loss rel {loss_rel:.3e} (<= {FITNESS_RTOL}), gradients max abs / max "
          f"{grad_err:.3e} (<= {GRAD_SCALED_ATOL}); launches fused K7 {fused_counts['K7']}, "
          f"unfused K2 {unfused_counts['K2']} K6 {unfused_counts['K6']}", flush=True)
    check(fused_counts["K7"] == 1 and fused_counts["K6"] == 0, f"fused launches {fused_counts}")
    check(unfused_counts["K2"] == 1 and unfused_counts["K6"] == 1 and unfused_counts["K7"] == 0,
          f"unfused launches {unfused_counts}")
    check(loss_rel <= FITNESS_RTOL, f"corner-culled fused and unfused losses differ by {loss_rel}")
    check(grad_err <= GRAD_SCALED_ATOL, f"corner-culled gradients differ by {grad_err}")
    return {"tile_h": tile_h, "loss_rel": loss_rel, "grad_scaled_err": grad_err,
            "launches_fused": fused_counts["K7"],
            "launches_unfused": {"K2": unfused_counts["K2"], "K6": unfused_counts["K6"]}}


def adam_steps_per_s(obj, tgt, wm, n_splats: int, seed: int) -> tuple:
    """Host-timed Adam blocks at B=1 (each ending in a synchronize) after a
    warm-up block -> (median steps/s, per-block rates)."""
    import torch

    from ggs_tpu_torch.config import GenomeConfig, GradConfig
    from ggs_tpu_torch.models import genome, gradient

    gnm = GenomeConfig(n_splats=n_splats)
    make_opt, step = gradient.make_fit_step(obj, gnm, GradConfig(lr=1e-2))
    g0 = genome.new_population(torch.Generator(device="cuda").manual_seed(seed), 1, n_splats,
                               obj.H, obj.W, device="cuda")
    st, _ = gradient.run_block(gradient.init_state(make_opt, g0), step, tgt, wm, ADAM_BLOCK_STEPS)
    torch.cuda.synchronize()
    rates = []
    for _ in range(ADAM_BLOCKS):
        t0 = time.perf_counter()
        st, fits = gradient.run_block(st, step, tgt, wm, ADAM_BLOCK_STEPS)
        fits.cpu()
        torch.cuda.synchronize()
        rates.append(ADAM_BLOCK_STEPS / (time.perf_counter() - t0))
    return sorted(rates)[ADAM_BLOCKS // 2], rates, st, step


def check_no_sync(fn, what: str) -> None:
    """fn() must issue its work without waiting for the card: under
    torch.cuda.set_sync_debug_mode("error") any synchronizing call raises."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print(f"CHECK {what}: no host sync", flush=True)


def graph_launches(fn, steps: int, generators=(), optimizers=(), prepare=None) -> dict:
    """The device work of one fn() (`steps` generations or Adam steps) as the
    nodes of a CUDA graph that captures it: kernels, copies and fills, each
    a node, so no profiler trace can drop or add one. fn runs once first on
    the capture stream (so first-use allocations and per-stream buffers
    stay out of the graph); the generators it draws from are registered
    with the graph, and each optimizer's capture check is lifted for the
    capture (torch.optim refuses a graph of a non-capturable step, which
    launches the same kernels as the eager step counted here; the graph is
    never replayed). prepare(), when given, runs before each fn() outside
    the capture (a run block's counter fill). Returns the nodes by kind and
    the kernels, copies and fills a step ("per_step")."""
    import torch

    from ggs_tpu_torch.utils import block_graph

    s = torch.cuda.Stream()
    if prepare is not None:
        prepare()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        fn()
    torch.cuda.synchronize()
    if prepare is not None:
        prepare()
        torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    for gen in generators:
        g.register_generator_state(gen)
    checks = ("_accelerator_graph_capture_health_check", "_cuda_graph_capture_health_check")
    lifted = [(opt, name) for opt in optimizers for name in checks
              if hasattr(type(opt), name) and name not in opt.__dict__]
    for opt, name in lifted:
        setattr(opt, name, lambda: None)
    try:
        with torch.cuda.graph(g, stream=s, capture_error_mode="relaxed"):
            fn()
    finally:
        for opt, name in lifted:
            delattr(opt, name)
    kinds, _ = block_graph.graph_nodes(g.raw_cuda_graph())
    del g
    work = kinds["KERNEL"] + kinds["MEMCPY"] + kinds["MEMSET"]
    check(work > 0, f"the captured graph holds no device work: {dict(kinds)}")
    return {"per_step": work / steps, "steps": steps, "nodes": dict(kinds)}


@contextlib.contextmanager
def count_calls(module, name: str, key=None):
    """Counts the calls of module.name while the block runs, by key(*args,
    **kw) when given (callers that look the name up on the module at call
    time are counted). A run block replayed as a CUDA graph makes no call:
    each call is counted through profiling.count, so each replay adds the
    calls its capture made. The Counter yielded holds the block's calls by
    key once the block ends."""
    from ggs_tpu_torch.utils import profiling

    tag = ("calls", module.__name__, name)

    def mine() -> collections.Counter:
        return collections.Counter({k[1]: v for k, v in profiling.COUNTS.items()
                                    if isinstance(k, tuple) and k[0] == tag})

    seen, before = collections.Counter(), mine()
    plain = getattr(module, name)

    def counted(*args, **kw):
        profiling.count((tag, name if key is None else key(*args, **kw)))
        return plain(*args, **kw)

    setattr(module, name, counted)
    try:
        yield seen
    finally:
        setattr(module, name, plain)
        seen.update(mine() - before)


def evaluate_batches(by_n: bool = False):
    """Counts objective.evaluate's calls by batch size (with by_n, by (batch
    size, splats)), each one walk launch at that B (no chunking on these
    paths)."""
    from ggs_tpu_torch.ops import objective

    def key(obj, g, *args, **kw):
        b, n = (int(g.shape[0]), int(g.shape[1])) if len(g.shape) == 3 else (1, int(g.shape[0]))
        return (b, n) if by_n else b

    return count_calls(objective, "evaluate", key)


@contextlib.contextmanager
def launches_within(module, name: str, kernel: str):
    """Calls of module.name while the block runs, and the launches of
    `kernel` (a key of profiling.COUNTS) made inside them."""
    from ggs_tpu_torch.utils import profiling

    stats = {"calls": 0, "launches": 0}
    plain = getattr(module, name)

    def counted(*args, **kw):
        before = profiling.COUNTS[kernel]
        out = plain(*args, **kw)
        stats["calls"] += 1
        stats["launches"] += profiling.COUNTS[kernel] - before
        return out

    setattr(module, name, counted)
    try:
        yield stats
    finally:
        setattr(module, name, plain)


def sa_paths(drive, ga_path, tgt) -> dict:
    """The SA slice's main paths: run_sa (batched, sequential, PT, fast, bf16,
    SSIM, highest with mix) and run_grad / run_ga under the SSIM metrics,
    each with its launch counts and evaluate's batch sizes."""
    import torch

    from ggs_tpu_torch import run_grad, run_sa

    out = {"launches": {}, "batches": {}}
    H, W = tgt.shape[:2]

    def sa_path(tag, outdir, iters, argv):
        with evaluate_batches() as seen:
            res, counts, wall = drive(tag, run_sa, outdir, [
                "--iterations", str(iters), "--log-every", str(max(1, iters // 3)), "--no-video",
                *argv])
        best = res["curves"]["best"]
        print(f"MAIN PATH {tag} " + json.dumps({
            "iterations": iters, "seconds": wall, "best_first": best[0], "best_last": best[-1],
            "exact_rescore": res["best_fit"], "launches": counts,
            "evaluate_batches": dict(seen),
        }), flush=True)
        check(len(best) == iters + 1, f"{tag}: curve length")
        check(best[-1] < best[0], f"{tag}: the best did not fall ({best[0]} -> {best[-1]})")
        check(all(b1 <= b0 for b0, b1 in zip(best, best[1:])), f"{tag}: the best is not monotone")
        check(math.isfinite(res["best_fit"]) and res["best_fit"] > 0, f"{tag}: rescored energy")
        check(tuple(res["final"].shape) == (H, W, 3) and bool(torch.isfinite(res["final"]).all()),
              f"{tag}: export render")
        out["launches"][tag], out["batches"][tag] = counts, dict(seen)
        return counts, seen

    n = SA_ITERS
    c, b = sa_path("run_sa", "chip_smoke_sa", n, [])
    check(c["K1"] == n + 2 and b == {8: n, 1: 2} and c["K2"] >= 1 and c["K3"] + c["K4"] == 0,
          f"run_sa: K1 once an iteration at B=8, the init and the rescore at B=1: {c}, {b}")
    n = SA_SEQ_ITERS
    c, b = sa_path("run_sa sequential", "chip_smoke_sa_seq", n, ["--proposal-mode", "sequential"])
    check(c["K1"] == 8 * n + 2 and b == {1: 8 * n + 2}, f"run_sa sequential: {c}, {b}")
    n = PT_ITERS
    c, b = sa_path("run_sa pt", "chip_smoke_pt", n, ["--replicas", str(PT_K)])
    check(c["K1"] == n + 2 and b == {8 * PT_K: n, PT_K: 1, 1: 1}, f"run_sa --replicas: {c}, {b}")
    n = SA_FAST_ITERS
    c, b = sa_path("run_sa fast", "chip_smoke_sa_fast", n, ["--precision", "fast"])
    check(c["K4"] == n + 1 and c["K3"] == n + 1 and c["K1"] == 1,
          f"run_sa fast: K4 and K3 once an iteration, K1 once for the rescore: {c}")
    n = SA_SSIM_ITERS
    c, b = sa_path("run_sa ssim", "chip_smoke_sa_ssim", n, ["--metric", "ssim"])
    check(c["K2"] == n + 3 and c["K1"] == 0 and b == {8: n, 1: 2},
          f"run_sa ssim: K2 once an iteration, the init, the rescore and the export: {c}, {b}")
    n = SA_SHORT_ITERS
    c, b = sa_path("run_sa bf16", "chip_smoke_sa_bf16", n, ["--precision", "bf16"])
    check(c["K1-bf16"] == n + 1 and c["K1"] == 1, f"run_sa bf16: K1-bf16 once an iteration: {c}")
    c, b = sa_path("run_sa highest mix", "chip_smoke_sa_mix", n,
                   ["--precision", "highest", "--metric", "mix", "--replicas", "2"])
    check(c["K2"] == n + 2 and c["K1"] == 0 and b == {16: n, 2: 1},
          f"run_sa highest mix (PT, no rescore): K2 once an iteration, the init and the export: "
          f"{c}, {b}")

    res, c, wall = drive("run_grad --metric mix", run_grad, "chip_smoke_grad_mix", [
        "--steps", str(GRAD_MIX_STEPS), "--log-every", "10", "--metric", "mix"])
    curve = res["curve"]
    print("MAIN PATH run_grad mix " + json.dumps({
        "steps": GRAD_MIX_STEPS, "seconds": wall, "loss_first": curve[0], "loss_last": curve[-1],
        "highest_rescore": res["best_loss"], "launches": c,
    }), flush=True)
    check(len(curve) == GRAD_MIX_STEPS and curve[-1] < curve[0],
          f"run_grad mix: the loss did not fall ({curve[0]} -> {curve[-1]})")
    check(c["K6"] == GRAD_MIX_STEPS and c["K2"] == GRAD_MIX_STEPS + 2 and c["K7"] == 0,
          f"run_grad mix: K2' and K6 once a step (K2 also the rescore and export), no K7: {c}")
    out["launches"]["run_grad mix"] = c
    _, c = ga_path("run_ga --metric ssim", "ga ssim", "chip_smoke_ga_ssim", GA_SSIM_GENS,
                   ["--metric", "ssim"])
    check(c["K2"] == GA_SSIM_GENS + 3 and c["K1"] == 0, f"run_ga ssim launches {c}")
    out["launches"]["run_ga ssim"] = c

    return out


def frames_match_animation(frames_dir: str, prefix: str, anim: str) -> int:
    """The APNG decodes, frame by frame, to the frame PNGs -> their count."""
    import glob

    import numpy as np
    from PIL import Image

    frames = sorted(glob.glob(os.path.join(frames_dir, f"{prefix}_*.png")))
    im = Image.open(anim)
    check(len(frames) >= 2 and im.n_frames == len(frames),
          f"{anim}: {im.n_frames} frames for {len(frames)} PNGs")
    for i, f in enumerate(frames):
        im.seek(i)
        check(np.array_equal(np.asarray(im.convert("RGB")), np.asarray(Image.open(f).convert("RGB"))),
              f"{anim}: frame {i} differs from {f}")
    return len(frames)


def sigma_steps(gens: int, block: int) -> tuple:
    """(the times sigma changes, the generation of the last change) in an
    annealed run of `gens` generations (or steps) read in blocks of `block`:
    each change rescores (genetic_approx) or blurs the target again
    (fit_adam)."""
    from ggs_tpu_torch.ops import anneal

    cur, n, last = 0.0, 0, 0
    for g in range(0, gens, block):
        s = anneal.sigma_schedule(g, gens, ANNEAL_SIGMA0)
        if s != cur:
            n, cur, last = n + 1, s, g
    return n, last


def pipeline_paths(drive) -> dict:
    """The pipeline slice's main paths: run_pipeline (grow-auto GA with
    recycles and frames, then the Adam polish), run_ga and run_grad with
    --anneal-sigma0, and run_ga --grow-stages 3 --precision fast, each with
    its launch counts and evaluate's (batch, splats)."""
    from ggs_tpu_torch import run_ga, run_grad, run_pipeline
    from ggs_tpu_torch.models import grow
    from ggs_tpu_torch.ops import render_cuda as rc
    from ggs_tpu_torch.utils import io

    out = {"launches": {}}
    outdir = os.path.join(HERE, "output", "chip_smoke_pipeline")
    shutil.rmtree(outdir, ignore_errors=True)  # the animation takes every frame in its folder
    with evaluate_batches(by_n=True) as evals, \
            launches_within(grow, "grow_population", "K2") as grows, \
            launches_within(grow, "recycle_population", "K2") as recs, \
            launches_within(io, "save_frame_png", "K2") as frames:
        res, c, wall = drive("run_pipeline", run_pipeline, "chip_smoke_pipeline", PIPE_ARGV)
    stages, curve = res["ga"]["stages"], res["grad"]["curve"]
    n_frames = frames_match_animation(os.path.join(outdir, "video_frames"), "ga",
                                      os.path.join(outdir, "ga_anim.apng"))
    print("MAIN PATH run_pipeline " + json.dumps({
        "seconds": wall, "stages": [{k: st[k] for k in ("n_splats", "generations", "best_fit")}
                                    for st in stages],
        "adam_loss_first": curve[0], "adam_loss_last": curve[-1],
        "final_loss": res["grad"]["best_loss"], "launches": c,
        "evaluate_batch_and_n": {f"{b}x{n}": v for (b, n), v in sorted(evals.items())},
        "growths": grows, "recycles": recs, "frames": frames, "apng_frames": n_frames,
    }), flush=True)
    check([st["n_splats"] for st in stages] == PIPE_NS, f"run_pipeline stages {stages}")
    for st in stages:
        best = st["curves"]["best"]
        check(len(best) == st["generations"] + 1
              and all(b1 <= b0 for b0, b1 in zip(best, best[1:])),
              f"run_pipeline: the GA best is not monotone in the N={st['n_splats']} stage")
        # K1 once a generation at the stage's N (and the stage's first scoring,
        # and each recycle's), one evaluate at B=32 each
        check(evals[(PIPE_P, st["n_splats"])] >= st["generations"] + 1,
              f"run_pipeline: {evals[(PIPE_P, st['n_splats'])]} evaluations at N={st['n_splats']}")
    check(c["K1"] == sum(evals.values()), f"run_pipeline: K1 {c['K1']} for {dict(evals)}")
    # K2 once a growth (3 stages, and inside each recycle), once a frame, and
    # 3 more: run_ga's export, run_grad's "highest" rescore (K2' in
    # render_diff) and its export
    check(recs["calls"] >= 1 and grows["calls"] == len(PIPE_NS) - 1 + recs["calls"]
          and grows["launches"] == grows["calls"] and frames["launches"] == frames["calls"] >= 2
          and n_frames == frames["calls"]
          and c["K2"] == grows["launches"] + frames["launches"] + 3,
          f"run_pipeline K2: {c['K2']}, growths {grows}, recycles {recs}, frames {frames}")
    adam_steps = int(PIPE_ARGV[PIPE_ARGV.index("--adam-steps") + 1])
    check(c["K7"] == adam_steps and c["K6"] == 0, f"run_pipeline: K7 once an Adam step: {c}")
    check(len(curve) == adam_steps and curve[-1] < curve[0],
          f"run_pipeline: the Adam loss did not fall ({curve[0]} -> {curve[-1]})")
    out["launches"]["run_pipeline"] = c
    out["pipeline_seconds"] = wall

    steps, last_step = sigma_steps(ANNEAL_GA_GENS, 50)  # run_ga's --log-every 50
    with evaluate_batches(by_n=True) as evals:
        res, c, wall = drive("run_ga --anneal-sigma0", run_ga, "chip_smoke_anneal", [
            "--generations", str(ANNEAL_GA_GENS), "--anneal-sigma0", str(ANNEAL_SIGMA0),
            "--no-video"])
    best = res["curves"]["best"]
    print("MAIN PATH run_ga anneal " + json.dumps({
        "generations": ANNEAL_GA_GENS, "seconds": wall, "sigma_steps": steps,
        "best_first": best[0], "best_last": best[-1], "exact_rescore": res["best_fit"],
        "launches": c, "evaluate_batch_and_n": {f"{b}x{n}": v for (b, n), v in evals.items()},
    }), flush=True)
    # K1 once a generation, the init, twice a sigma step (the population and
    # the best rescored) and the exact rescore
    n = PIPE_NS[-1]
    check(evals == {(PIPE_P, n): ANNEAL_GA_GENS + 1 + steps, (1, n): steps + 1}
          and c["K1"] == ANNEAL_GA_GENS + 2 + 2 * steps,
          f"run_ga anneal: K1 {c['K1']}, evaluations {dict(evals)}, {steps} sigma steps")
    tail = best[last_step + 1:]  # the generations after the last sigma step, at sigma 0
    check(all(math.isfinite(b) for b in best) and all(b1 <= b0 for b0, b1 in zip(tail, tail[1:]))
          and math.isfinite(res["best_fit"]), "run_ga anneal: curve")
    out["launches"]["run_ga anneal"] = c

    res, c, wall = drive("run_grad --anneal-sigma0", run_grad, "chip_smoke_anneal_grad", [
        "--steps", str(ANNEAL_GRAD_STEPS), "--log-every", "10",
        "--anneal-sigma0", str(ANNEAL_SIGMA0)])
    curve = res["curve"]
    print("MAIN PATH run_grad anneal " + json.dumps({
        "steps": ANNEAL_GRAD_STEPS, "seconds": wall, "sigma_steps": sigma_steps(ANNEAL_GRAD_STEPS, 10)[0],
        "loss_first": curve[0], "loss_last": curve[-1], "highest_rescore": res["best_loss"],
        "launches": c}), flush=True)
    check(c["K7"] == ANNEAL_GRAD_STEPS and c["K6"] == 0 and c["K2"] == 2,
          f"run_grad anneal: K7 once a step, K2 for the rescore and export: {c}")
    check(len(curve) == ANNEAL_GRAD_STEPS and all(math.isfinite(x) for x in curve)
          and math.isfinite(res["best_loss"]), "run_grad anneal: curve")
    out["launches"]["run_grad anneal"] = c

    with evaluate_batches(by_n=True) as evals:
        res, c, wall = drive("run_ga --grow-stages 3 --precision fast", run_ga,
                             "chip_smoke_grow_fast", [
                                 "--generations", str(GROW_FAST_GENS), "--grow-stages", "3",
                                 "--precision", "fast", "--no-video"])
    stages = res["stages"]
    print("MAIN PATH run_ga grow-stages fast " + json.dumps({
        "seconds": wall, "stages": [{k: st[k] for k in ("n_splats", "generations", "best_fit")}
                                    for st in stages],
        "exact_rescore": res["best_fit"], "launches": c,
        "evaluate_batch_and_n": {f"{b}x{n}": v for (b, n), v in evals.items()},
    }), flush=True)
    check([st["n_splats"] for st in stages] == GROW_FAST_NS, f"grow-stages fast: {stages}")
    fast_evals = sum(st["generations"] + 1 for st in stages)
    check(all(evals[(PIPE_P, st["n_splats"])] == st["generations"] + 1 for st in stages)
          and c["K4"] == c["K3"] == fast_evals and c["K1"] == 1 and evals[(1, PIPE_NS[-1])] == 1
          and c["K3-canvas"] == len(stages) - 1 and c["K2"] == 1,
          f"grow-stages fast: K4 and K3 once a scoring at each N, K3's canvas once a growth, "
          f"K1 the exact rescore, K2 the export: {c}, {dict(evals)}")
    out["launches"]["run_ga grow-stages fast"] = c
    return out


def pipeline_checks_and_times(tgt, wm, card) -> dict:
    """The pipeline slice's blocks with no host sync (an annealed GA block and
    an annealed Adam block), the annealed GA's launches a generation, and
    its times: generations/s and Adam steps/s annealed against plain in
    turns, one blur_image at sigma ANNEAL_SIGMA0, one grow_population."""
    import torch

    from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig
    from ggs_tpu_torch.models import ga, genome, gradient, grow
    from ggs_tpu_torch.ops import anneal, objective

    phase("pipeline slice: annealed blocks with no host sync, annealed launches")
    H, W = tgt.shape[:2]
    dev = tgt.device
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    cfg, gnm = GAConfig(pop_size=PIPE_P), GenomeConfig(n_splats=PIPE_NS[-1])
    sig = torch.full((), ANNEAL_SIGMA0, dtype=torch.float32, device=dev)
    radius = anneal.default_radius(ANNEAL_SIGMA0)
    tgt_b = anneal.blur_image(tgt, sig, radius)
    st = ga.init(torch.Generator(device=dev).manual_seed(60), obj, tgt, wm, cfg, gnm)
    st, _ = ga.run_block(st, obj, tgt_b, wm, cfg, gnm, 5, blur_sigma=sig)  # warm-up
    check_no_sync(lambda: ga.run_block(st, obj, tgt_b, wm, cfg, gnm, 5, blur_sigma=sig),
                  f"a 5-generation annealed GA block (sigma {ANNEAL_SIGMA0})")
    make_opt, step = gradient.make_fit_step(obj, GenomeConfig(n_splats=ADAM_N),
                                            GradConfig(lr=1e-2))
    g0 = genome.new_population(torch.Generator(device=dev).manual_seed(61), 1, ADAM_N, H, W,
                               device=dev)
    gst, _ = gradient.run_block(gradient.init_state(make_opt, g0), step, tgt_b, wm, 3,
                                blur_sigma=sig)
    check_no_sync(lambda: gradient.run_block(gst, step, tgt_b, wm, 3, blur_sigma=sig),
                  f"a 3-step annealed Adam block (N={ADAM_N}, sigma {ANNEAL_SIGMA0})")
    prof = profile_split(
        lambda: ga.run_block(st, obj, tgt_b, wm, cfg, gnm, 20, blur_sigma=sig)[1].cpu(), 20)
    st_x = ga.init(torch.Generator(device=dev).manual_seed(63), obj, tgt, wm, cfg, gnm)
    exact = graph_launches(lambda: ga.run_block(st_x, obj, tgt_b, wm, cfg, gnm, 20,
                                                blur_sigma=sig), 20, generators=[st_x.rng])
    prof["exact_launches_per_step"] = exact["per_step"]
    limit = LAUNCH_LIMITS["ga_exact_tight"] + BLUR_LAUNCHES
    print("PROFILE GA annealed " + json.dumps(prof), flush=True)
    check(round(exact["per_step"] * exact["steps"]) <= round(limit * exact["steps"]),
          f"annealed GA: {exact['per_step']} launches a generation (exactly), above {limit}")

    phase("times: annealed against plain, blur_image, grow_population")

    def rate(run, n):
        t0 = time.perf_counter()
        m = run(n)
        m.cpu()
        torch.cuda.synchronize()
        return n / (time.perf_counter() - t0)

    state = {"ga": st, "adam": gst}

    def ga_run(sigma):
        def run(n):
            state["ga"], m = ga.run_block(state["ga"], obj, tgt if sigma is None else tgt_b, wm,
                                          cfg, gnm, n, blur_sigma=sigma)
            return m
        return run

    def adam_run(sigma):
        def run(n):
            state["adam"], f = gradient.run_block(state["adam"], step,
                                                  tgt if sigma is None else tgt_b, wm, n,
                                                  blur_sigma=sigma)
            return f
        return run

    rates = {"ga_plain": [], "ga_annealed": [], "adam_plain": [], "adam_annealed": []}
    for i in range(RATE_PAIRS):
        for mode in (("plain", "annealed") if i % 2 == 0 else ("annealed", "plain")):
            sigma = None if mode == "plain" else sig
            rates[f"ga_{mode}"].append(rate(ga_run(sigma), RATE_GA_GENS))
            rates[f"adam_{mode}"].append(rate(adam_run(sigma), RATE_ADAM_STEPS))
    n = PIPE_NS[-1]
    pop = state["ga"].pop[:GROW_P, : n - GROW_N_NEW].contiguous()  # 256 splats -> 512
    rng = torch.Generator(device=dev).manual_seed(62)
    times = {
        "card": card,
        f"ga_generations_per_s_P{PIPE_P}_N{n}": {k[3:]: sorted(v)[len(v) // 2] for k, v in rates.items()
                                          if k.startswith("ga_")},
        f"adam_steps_per_s_N{ADAM_N}": {k[5:]: sorted(v)[len(v) // 2] for k, v in rates.items()
                                   if k.startswith("adam_")},
        "blocks": rates,
        f"blur_image_ms_{H}x{W}_sigma{ANNEAL_SIGMA0:g}_radius{radius}": cuda_ms(
            lambda: anneal.blur_image(tgt, sig, radius), 20),
        f"grow_population_ms_P{GROW_P}_{H}x{W}_n_new{GROW_N_NEW}": cuda_ms(
            lambda: grow.grow_population(pop, GROW_N_NEW, tgt, obj, wm, rng=rng), 10),
        "annealed_ga_launches_per_generation": exact["per_step"],
        "annealed_ga_launches_per_generation_profiler": prof["kernels_per_step"],
        "annealed_ga_device_busy_share": prof["device_busy_share"],
    }
    print("PIPELINE TIMES " + json.dumps(times), flush=True)
    return times


def slice_paths(drive, ga_path) -> dict:
    """The checkpoint / island / profile slice's main paths: run_ga --islands
    4 (exact-tight for ISLAND_GENS generations, fast for ISLAND_FAST_GENS),
    run_ga stopped right after its RESUME_GENS // 2 checkpoint (a
    KeyboardInterrupt raised after that save, which the host loop takes as a
    Ctrl-C) and resumed with --resume, against an uninterrupted run of the
    same flags, and run_ga --profile-dir; each with its launch counts."""
    import numpy as np

    from ggs_tpu_torch import run_ga
    from ggs_tpu_torch.utils import checkpoint

    out = {"launches": {}}
    _, c = ga_path("run_ga --islands 4", "islands", "chip_smoke_islands", ISLAND_GENS,
                   ISLAND_ARGV, monotone=True)
    check(c["K1"] == ISLAND_GENS + 2 and c["K2"] == 1 and c["K3"] + c["K4"] == 0,
          f"run_ga --islands: K1 once a generation, the init and the rescore: {c}")
    out["launches"]["islands"] = c
    _, c = ga_path("run_ga --islands 4 --precision fast", "islands fast",
                   "chip_smoke_islands_fast", ISLAND_FAST_GENS,
                   ISLAND_ARGV + ["--precision", "fast"], monotone=True)
    check(c["K4"] == c["K3"] == ISLAND_FAST_GENS + 1 and c["K1"] == 1 and c["K2"] == 1,
          f"run_ga --islands --precision fast: K4 and K3 once an evaluation: {c}")
    out["launches"]["islands_fast"] = c

    argv = ["--generations", str(RESUME_GENS), "--log-every", str(RESUME_EVERY), "--no-video"]
    full_dir = os.path.join(HERE, "output", "chip_smoke_resume_full")
    stop_dir = os.path.join(HERE, "output", "chip_smoke_resume")
    shutil.rmtree(stop_dir, ignore_errors=True)
    full, c_full, _ = drive("run_ga uninterrupted (the resume's reference)", run_ga,
                            "chip_smoke_resume_full", argv)
    save = checkpoint.save_checkpoint

    def stop(path, state, meta=None):
        save(path, state, meta)
        if meta["gen"] == RESUME_GENS // 2:
            raise KeyboardInterrupt

    checkpoint.save_checkpoint = stop
    try:
        drive(f"run_ga --checkpoint-every {RESUME_EVERY}, stopped after its "
              f"{RESUME_GENS // 2}-generation checkpoint", run_ga, "chip_smoke_resume",
              argv + ["--checkpoint-every", str(RESUME_EVERY)])
    finally:
        checkpoint.save_checkpoint = save
    ck = os.path.join(stop_dir, "ga_ckpt.npz")
    res, c, wall = drive("run_ga --resume", run_ga, "chip_smoke_resume", argv + ["--resume", ck])
    a = np.load(os.path.join(full_dir, "ga_best_genome.npy"))
    b = np.load(os.path.join(stop_dir, "ga_best_genome.npy"))
    same = a.shape == b.shape and bool((a.view(np.uint32) == b.view(np.uint32)).all())
    print("MAIN PATH run_ga resume " + json.dumps({
        "generations": RESUME_GENS, "resumed_at": RESUME_GENS // 2, "seconds": wall,
        "best_genome_same_bits": same, "curves_equal": res["curves"] == full["curves"],
        "best_last": res["curves"]["best"][-1], "launches": c,
        "launches_uninterrupted": c_full}), flush=True)
    check(same, "run_ga --resume: ga_best_genome.npy differs from the uninterrupted run's")
    check(res["curves"] == full["curves"], "run_ga --resume: the curves differ")
    check(c["K1"] == RESUME_GENS // 2 + 2 and c_full["K1"] == RESUME_GENS + 2,
          f"run_ga --resume: K1 {c['K1']} (the template's init, {RESUME_GENS // 2} "
          f"generations, the rescore); uninterrupted {c_full['K1']}")
    out["launches"]["resume"] = c

    prof_dir = os.path.join(HERE, "output", "chip_smoke_profile_trace")
    shutil.rmtree(prof_dir, ignore_errors=True)
    _, c, wall = drive("run_ga --profile-dir", run_ga, "chip_smoke_profile",
                       PROFILE_ARGV + ["--no-video", "--profile-dir", prof_dir])
    traces = sorted(f for f in os.listdir(prof_dir) if f.endswith(".json"))
    check(len(traces) == 1, f"run_ga --profile-dir wrote {traces}, not one trace")
    path = os.path.join(prof_dir, traces[0])
    with open(path) as f:
        text = f.read()
    print("MAIN PATH run_ga profile " + json.dumps({
        "seconds": wall, "trace": os.path.relpath(path, HERE), "trace_bytes": len(text),
        "fitness_kernel_events": text.count("fitness_kernel"), "launches": c}), flush=True)
    check("fitness_kernel" in text, "the profile trace does not name the walk's fitness_kernel")
    out["launches"]["profile"] = c
    return out


def _same_state(a, b) -> bool:
    """Two states equal in bits: every tensor (genomes, fits, best), the
    ints, the generator's state and Adam's moments and step."""
    import torch

    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            same = x.dtype == y.dtype and torch.equal(x, y)
        elif isinstance(x, torch.Generator):
            same = torch.equal(x.get_state(), y.get_state())
        elif isinstance(x, torch.optim.Optimizer):
            sx, sy = x.state[a.g], y.state[b.g]
            same = sx.keys() == sy.keys() and all(torch.equal(sx[k], sy[k]) for k in sx)
        else:
            same = x == y
        if not same:
            return False
    return True


def slice_checks_and_times(tgt, wm, card) -> dict:
    """The checkpoint / island / profile slice's checks and times: one island
    equal in bits to ga.run_block on the same draws; an island block with no
    host sync; block resumes bit-equal to the uninterrupted blocks (the GA
    exact-tight and fast, the island GA, SA, PT and Adam); the island's
    launches a generation, exactly, and its generations/s against the plain
    block's in turns; one save's ms and bytes at run_ga's defaults."""
    import tempfile

    import torch

    from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig, MutSigma, SAConfig
    from ggs_tpu_torch.models import ga, genome, gradient, pt, sa
    from ggs_tpu_torch.ops import objective
    from ggs_tpu_torch.parallel import island
    from ggs_tpu_torch.utils import checkpoint

    phase("checkpoint / island slice: one island, no host sync, resumes in bits")
    H, W = tgt.shape[:2]
    dev = tgt.device
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    obj_fast = objective.Objective(H=H, W=W, precision="fast")
    cfg, gnm = GAConfig(pop_size=32, generations=500_000), GenomeConfig(n_splats=512)
    sig_max, sig_min = MutSigma.max_defaults().__dict__, MutSigma.min_defaults().__dict__

    def fresh_ga(o, seed=80):
        return ga.init(torch.Generator(device=dev).manual_seed(seed), o, tgt, wm, cfg, gnm)

    # one island is ga.step on the same draws (the permutation the stable
    # argsort of the shuffle's uniforms)
    a = b = fresh_ga(obj)
    rng = torch.Generator(device=dev).manual_seed(81)
    for _ in range(3):
        d = island.draw_island(rng, 1, cfg.pop_size, gnm.n_splats, cfg.tour_k, dev)
        gd = {"sel": d["sel"][0], "perm": torch.argsort(d["u_shuf"][0], stable=True),
              "u_cx": d["u_cx"][0], "u_cxm": d["u_cxm"][0], "mut": d["mut"]}
        a, ma = island.step(a, obj, tgt, wm, cfg, gnm, sig_max, sig_min, 1, draws=d)
        b, mb = ga.step(b, obj, tgt, wm, cfg, gnm, sig_max, sig_min, draws=gd)
    check(all(torch.equal(x, y) for x, y in zip(a[:5], b[:5])) and torch.equal(ma, mb),
          "one island differs from ga.step on the same draws")
    print("CHECK one island equals ga.step on the same draws, bit for bit (3 generations)",
          flush=True)

    run_isl = island.make_run_block(obj, cfg, gnm, ISLANDS, ISLAND_EVERY, ISLAND_K)
    st_i, _ = run_isl(fresh_ga(obj, 82), tgt, wm, 3)  # warm-up and capture
    st_e = fresh_ga(obj, 82)
    check_no_sync(lambda: run_isl.eager(st_e, tgt, wm, 3),
                  "an eager 3-generation island block (I=4)")
    check_no_sync(lambda: run_isl(st_i, tgt, wm, 3), "a replayed 3-generation island block")

    # resumes on the card: run(2k) == run(k) -> save -> load into a fresh template -> run(k)
    sa_cfg, sa_gnm = SAConfig(), GenomeConfig()
    make_opt, step = gradient.make_fit_step(obj, GenomeConfig(n_splats=ADAM_N), GradConfig(lr=1e-2))

    def adam_state():
        g0 = genome.new_population(torch.Generator(device=dev).manual_seed(83), 1, ADAM_N, H, W,
                                   device=dev)
        return gradient.init_state(make_opt, g0)

    cases = {
        "ga_exact_tight": (lambda: fresh_ga(obj),
                           lambda s, k: ga.run_block(s, obj, tgt, wm, cfg, gnm, k)[0]),
        "ga_fast": (lambda: fresh_ga(obj_fast),
                    lambda s, k: ga.run_block(s, obj_fast, tgt, wm, cfg, gnm, k)[0]),
        "islands": (lambda: fresh_ga(obj), lambda s, k: run_isl(s, tgt, wm, k)[0]),
        "sa": (lambda: sa.init(torch.Generator(device=dev).manual_seed(84), obj, tgt, wm, sa_gnm),
               lambda s, k: sa.make_run_block(obj, sa_cfg, sa_gnm)(s, tgt, wm, k)[0]),
        "pt": (lambda: pt.init(torch.Generator(device=dev).manual_seed(85), obj, tgt, wm, sa_gnm,
                               PT_K, t_cold=sa_cfg.t0, t_hot=100.0 * sa_cfg.t0),
               lambda s, k: pt.make_run_block(obj, sa_cfg, sa_gnm)(s, tgt, wm, k)[0]),
        "adam": (adam_state, lambda s, k: gradient.run_block(s, step, tgt, wm, k)[0]),
    }
    resumes = {}
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "ckpt.npz")
        for name, (make, run) in cases.items():
            full = run(make(), 2 * RESUME_K)
            checkpoint.save_checkpoint(path, run(make(), RESUME_K), meta={"gen": RESUME_K})
            resumed = run(checkpoint.load_checkpoint(path, make())[0], RESUME_K)
            torch.cuda.synchronize()
            resumes[name] = _same_state(full, resumed)
            check(resumes[name], f"{name}: the resumed block differs from the uninterrupted one")
        print(f"CHECK resumes on the card equal the uninterrupted blocks in bits "
              f"(run({2 * RESUME_K}) == run({RESUME_K}) -> save -> load -> run({RESUME_K})): "
              + json.dumps(resumes), flush=True)

        # one save at run_ga's defaults (P=32, N=512) with a 500-generation
        # curve in its meta, as genetic_approx writes it
        st = fresh_ga(obj)
        curves = {k: [0.1 + 1e-3 * i for i in range(501)] for k in ("best", "mean", "median")}
        save_ms = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            checkpoint.save_checkpoint(path, st, meta={"gen": 500, "curves": curves})
            save_ms.append(1e3 * (time.perf_counter() - t0))
        save_bytes = os.path.getsize(path)

    phase("times: island generations/s against plain, launches a generation")
    plain = {"st": fresh_ga(obj, 86)}
    isl = {"st": fresh_ga(obj, 87)}
    plain["st"], _ = ga.run_block(plain["st"], obj, tgt, wm, cfg, gnm, 5)
    isl["st"], _ = run_isl.eager(isl["st"], tgt, wm, 5)
    rates = {"plain": [], "islands": []}
    for i in range(RATE_PAIRS):
        for mode in (("plain", "islands") if i % 2 == 0 else ("islands", "plain")):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if mode == "plain":
                plain["st"], m = ga.run_block(plain["st"], obj, tgt, wm, cfg, gnm, RATE_GA_GENS)
            else:
                isl["st"], m = run_isl.eager(isl["st"], tgt, wm, RATE_GA_GENS)
            m.cpu()
            torch.cuda.synchronize()
            rates[mode].append(RATE_GA_GENS / (time.perf_counter() - t0))
    st_g = fresh_ga(obj, 88)
    exact = graph_launches(lambda: run_isl.loop(st_g, tgt, wm, 20), 20, generators=[st_g.rng],
                           prepare=lambda: run_isl.prepare(st_g, 20))
    times = {
        "card": card,
        "ga_generations_per_s_P32_N512": {k: sorted(v)[len(v) // 2] for k, v in rates.items()},
        "blocks": rates,
        "islands_launches_per_generation": exact["per_step"],
        "islands_graph_nodes_20_generations": exact["nodes"],
        "save_ms_P32_N512_500_generations": sorted(save_ms)[len(save_ms) // 2],
        "save_ms_all": save_ms,
        "save_bytes": save_bytes,
        "resumes_equal": resumes,
    }
    print("SLICE TIMES " + json.dumps(times), flush=True)
    return times


def conv2d_filter2(img_hwc, taps):
    """ssim._filter2 as one depthwise F.conv2d of the 2-D window outer(taps,
    taps), [..., H, W, C] -> [..., H-k+1, W-k+1, C]: the contrast to the
    port's shifted sums, subject to the TF32 flags where cuDNN applies them."""
    import torch
    import torch.nn.functional as F

    g = torch.tensor(taps, dtype=img_hwc.dtype, device=img_hwc.device)
    k = g.numel()
    *lead, H, W, C = img_hwc.shape
    x = img_hwc.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    y = F.conv2d(x, torch.outer(g, g).expand(C, 1, k, k).contiguous(), groups=C)
    return y.permute(0, 2, 3, 1).reshape(*lead, H - k + 1, W - k + 1, C)


def sa_checks_and_times(tgt, wm, card) -> dict:
    """The SA slice's checks and times, run after every other phase: SA and
    PT blocks with no host sync; the SSIM on the card under the TF32 flags
    against float64; iterations/s, launches an iteration and SSIM-metric
    renders/s. (In the one run that profiled these blocks before the
    large-canvas path, its fast canvas-4k profile recorded no kernel; the
    cause is not known, hence the order and profile_split's retry.)"""
    import torch

    from ggs_tpu_torch.config import GenomeConfig, SAConfig
    from ggs_tpu_torch.models import genome, pt, sa
    from ggs_tpu_torch.ops import objective, ssim

    H, W = tgt.shape[:2]
    dev = tgt.device
    phase("SA and PT blocks: no host sync; SSIM on the card")
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    gnm = GenomeConfig()
    cfgs = {"batched": SAConfig(), "sequential": SAConfig(proposal_mode="sequential")}
    runs = {mode: sa.make_run_block(obj, cfg, gnm) for mode, cfg in cfgs.items()}
    runs["pt"] = pt.make_run_block(obj, SAConfig(), gnm)
    states = {mode: sa.init(torch.Generator(device=dev).manual_seed(41), obj, tgt, wm, gnm)
              for mode in cfgs}
    states["pt"] = pt.init(torch.Generator(device=dev).manual_seed(42), obj, tgt, wm, gnm,
                           PT_K, 1e-3, 1e-1)
    block = {"batched": SA_BLOCK_ITERS, "sequential": SA_SEQ_BLOCK_ITERS, "pt": SA_BLOCK_ITERS}
    for mode in runs:  # warm-up
        states[mode], _ = runs[mode](states[mode], tgt, wm, block[mode])
    check_no_sync(lambda: runs["batched"](states["batched"], tgt, wm, 5),
                  "a 5-iteration SA block (batched, exact-tight)")
    check_no_sync(lambda: runs["pt"](states["pt"], tgt, wm, 5),
                  f"a 5-iteration PT block ({PT_K} replicas)")

    pop8 = genome.new_population(torch.Generator(device=dev).manual_seed(43), SSIM_B, 512, H, W,
                                 device=dev)
    imgs = objective.render_genomes(obj, pop8, device=dev)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        s_card = ssim.ssim(imgs, tgt)
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        same_bits = torch.equal(ssim.ssim(imgs, tgt), s_card)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    s_ref = ssim.ssim(imgs.double().cpu(), tgt.double().cpu())
    err = float((s_card.double().cpu() - s_ref).abs().max())
    ssim_check = {
        "canvases": f"{SSIM_B} x {H}x{W}", "ssim": s_card.tolist(), "max_abs_vs_f64": err,
        "same_bits_tf32_on_and_off": same_bits,
    }
    # the contrast, not a check: the same SSIM with the window as one
    # depthwise F.conv2d (what the port does not use), TF32 flags on and off
    port_filter = ssim._filter2
    try:
        ssim._filter2 = conv2d_filter2
        for tf32 in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = tf32
            s_conv = ssim.ssim(imgs, tgt).double().cpu()
            key = "conv2d_tf32" if tf32 else "conv2d_f32"
            ssim_check[key + "_max_abs_vs_f64"] = float((s_conv - s_ref).abs().max())
    finally:
        ssim._filter2 = port_filter
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    print("SSIM CHECK " + json.dumps(ssim_check), flush=True)
    check(err <= SSIM_F64_ATOL and same_bits,
          f"the card's SSIM under the TF32 flags: {err} from float64 (limit {SSIM_F64_ATOL})")

    phase("times: SA and PT iterations/s, SSIM-metric renders/s")
    rates = {}
    for mode in runs:
        rs = []
        for _ in range(SA_BLOCKS):
            t0 = time.perf_counter()
            states[mode], m = runs[mode](states[mode], tgt, wm, block[mode])
            m.cpu()
            torch.cuda.synchronize()
            rs.append(block[mode] / (time.perf_counter() - t0))
        rates[mode] = {"median": sorted(rs)[SA_BLOCKS // 2], "blocks": rs}
    prof = {mode: profile_split(
        lambda: runs[mode](states[mode], tgt, wm, block[mode])[1].cpu(), block[mode])
        for mode in runs}
    obj_ssim = obj._replace(metric="ssim")
    ssim_ms = cuda_ms(lambda: objective.evaluate(obj_ssim, pop8, tgt, wm, device=dev), 20)
    mse_ms = cuda_ms(lambda: objective.evaluate(obj, pop8, tgt, wm, device=dev), 20)
    render_ms = cuda_ms(lambda: objective.render_genomes(obj, pop8, device=dev), 20)
    energy_ms = cuda_ms(lambda: ssim.mixed_energy(imgs, tgt, wm, ssim_weight=1.0), 20)
    times = {
        "card": card,
        "sa_iterations_per_s": {k: v["median"] for k, v in rates.items()},
        "sa_iterations_per_s_blocks": {k: v["blocks"] for k, v in rates.items()},
        "launches_per_iteration": {k: p["kernels_per_step"] for k, p in prof.items()},
        "device_busy_share": {k: p["device_busy_share"] for k, p in prof.items()},
        "device_ms_per_iteration": {k: {n: v / p["steps"] for n, v in p["device_ms"].items()}
                                    for k, p in prof.items()},
        f"ssim_renders_per_s_B{SSIM_B}": SSIM_B / (ssim_ms / 1e3),
        f"mse_renders_per_s_B{SSIM_B}": SSIM_B / (mse_ms / 1e3),
        "ssim_evaluate_ms": ssim_ms, "render_ms": render_ms, "ssim_energy_ms": energy_ms,
    }
    print("SA TIMES " + json.dumps(times), flush=True)
    return times


def profile_split(fn, n_gens: int, walk: str = "fitness_kernel") -> dict:
    """Device time of one fn() (n_gens GA generations or Adam steps) under
    torch.profiler, split between the walk kernel, K4 (prep), K5 (the
    scatter binning), sort kernels (the dense binning and the band lists)
    and the rest, with the device's busy share of the host-timed window.
    A session that records no device kernel at all is a lost trace, not a
    reading (the fast canvas-4k render, which launches 276 kernels, once
    read 0): fn() is profiled again, up to PROFILE_ATTEMPTS times, and
    "attempts" says how many it took."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        split = {"walk": 0.0, "prep": 0.0, "scatter": 0.0, "sort": 0.0, "other": 0.0}
        by_name = []
        for e in prof.key_averages():
            # user annotations (torch.optim's "Optimizer.step#Adam.step") span
            # kernels counted on their own
            if e.device_type != DeviceType.CUDA or e.is_user_annotation:
                continue
            us = getattr(e, "self_device_time_total", None)
            us = e.self_cuda_time_total if us is None else us
            key = ("walk" if walk in e.key else "prep" if "prep_fast_kernel" in e.key
                   else "scatter" if "ggs_scatter" in e.key
                   else "sort" if "sort" in e.key.lower() or "radix" in e.key.lower() else "other")
            split[key] += us / 1e3
            by_name.append((us / 1e3, e.count, e.key[:90]))
        if by_name:
            break
        print(f"PROFILE note: attempt {attempt} recorded no device kernel", flush=True)
    busy = sum(split.values())
    by_name.sort(reverse=True)
    return {
        "steps": n_gens,
        "walk_kernel": walk,
        "attempts": attempt,
        "wall_ms_under_profiler": wall_ms,
        "device_ms": split,
        "device_busy_share": busy / wall_ms,
        "kernels_per_step": sum(n for _, n, _ in by_name) / n_gens,
        "top": [{"ms": ms, "count": n, "name": k} for ms, n, k in by_name[:8]],
    }


# ------------------------------------------------------------ the run-block graph slice

# make_run_block's CUDA graphs against the eager body from equal states:
# three blocks of one length (the first runs eagerly and is captured, the
# next two replay), then shorter ones (the first captured, then replays).
# A fresh Adam's first block makes its moments eagerly, so Adam runs one
# block more. PT at run_sa's swap_every 10: its 20-iteration blocks swap
# inside (iteration 9) and on their boundary (19), at both parities; its
# graphs are kept per it % 20, so the 10-iteration blocks at 60, 70 and 80
# make two graphs and replay one.
# The memetic and island blocks refine / migrate every 10 generations
# (MEMETIC_EVERY, ISLAND_ARGV): their 15-generation blocks start at phases 0
# and 5 of that cycle, so a refinement or a migration falls inside a block
# and on a block's last generation, and each of the two graphs replays once;
# the memetic block under --metric mix, and under --precision fast
# --cull-eps 8e-2, refines every RBG_MIX_EVERY inside and at the end of its
# 10-generation blocks, one graph replayed twice.
RBG_BLOCKS = {"ga": (10, 10, 10, 5, 5), "adam": (5, 5, 5, 5, 2, 2),
              "sa": (10, 10, 10, 5, 5), "sa_sequential": (4, 4, 4, 2, 2),
              "pt": (20, 20, 20, 10, 10, 10), "memetic": (15, 15, 15, 15),
              "memetic_mix": (10, 10, 10), "memetic_fast": (10, 10, 10),
              "islands": (15, 15, 15, 15)}
RBG_MIX_EVERY = 5
RBG_SIGMAS = (4.0, 4.0, 2.0, 2.0, 1.0)  # the annealed GA's blur sigma a block: 2 steps between
RBG_RESUME_BLOCKS, RBG_RESUME_GENS = 3, 20  # GA blocks before and after the checkpoint
# run_ga at its defaults with frames (every 50 generations), recycles and
# checkpoints (every 100), graphed against ga.make_run_block's eager body
RBG_GA_ARGV = ["--generations", "300", "--log-every", "50", "--fps", "2", "--video-len", "3",
               "--recycle-every", "100", "--recycle-k", "16", "--checkpoint-every", "100"]
# run_ga --memetic-every MEMETIC_EVERY --memetic-steps MEMETIC_STEPS and run_ga
# with ISLAND_ARGV, graphed against their run blocks' eager bodies
# (without frames: a frame every generation would cut the blocks to one)
RBG_MEMETIC_ARGV = ["--generations", "100", "--log-every", "25", "--checkpoint-every", "50",
                    "--no-video", "--memetic-every", str(MEMETIC_EVERY), "--memetic-steps",
                    str(MEMETIC_STEPS)]
RBG_ISLAND_ARGV = ["--generations", "100", "--log-every", "25", "--checkpoint-every", "50",
                   "--no-video", *ISLAND_ARGV]
RBG_RATE_STEPS = {"ga": 20, "ga_fast": 20, "adam": 20, "sa": 20, "pt": 20, "memetic": 20,
                  "islands": 20}  # a timed block
RBG_RATE_BLOCKS = 5
RBG_PROFILE_STEPS = 10  # an eager block under torch.profiler (a graphed one: RBG_RATE_STEPS)


def run_block_graphs(tgt, wm, card) -> dict:
    """RUN BLOCK GRAPHS: ga, gradient, sa and pt.make_run_block,
    ga.make_memetic_run_block and island.make_run_block replayed as CUDA
    graphs against their eager bodies (`run.eager`) from equal states and
    equal generator states, in bits after every block (genomes, fits, best,
    the stall count, Adam's moments and step, the metrics and the
    generator's get_state()), over RBG_BLOCKS (a shorter last block): the GA
    exact-tight, fast, bf16 and annealed (a sigma step, the target blurred
    again and the state rescored, between blocks), Adam at run_grad's
    defaults (K7) and under --metric mix (K2' and K6), batched and
    sequential SA and PT, the memetic block (mse, mix and fast) and the
    island block (exact-tight and fast). Each replayed graph's kernel, copy
    and fill nodes equal graph_launches' count of the same eager block (of
    each phase of the memetic and island blocks). One GA resume through
    graphed blocks (a fresh run block after the load, as a resumed process
    has) equal in bits to the unbroken run; run_ga at its defaults with
    frames, recycles and checkpoints, memetic and with islands equal (best
    genome and curves in bits) to the same run with its run block's eager
    body; a replay issues no host sync; a block that copies from host
    memory is refused at its capture. Then generations/s, Adam steps/s, SA /
    PT iterations/s and memetic and island generations/s graphed against
    eager in turns (medians of RBG_RATE_BLOCKS host-timed blocks) and each
    one's device busy share under torch.profiler."""
    import numpy as np
    import torch

    from ggs_tpu_torch import run_ga
    from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig, SAConfig
    from ggs_tpu_torch.models import ga, genome, gradient, pt, sa
    from ggs_tpu_torch.ops import anneal, objective
    from ggs_tpu_torch.parallel import island
    from ggs_tpu_torch.utils import block_graph, checkpoint

    H, W = tgt.shape[:2]
    dev = tgt.device
    phase("run block graphs: replays against the eager body")
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    cfg, gnm = GAConfig(pop_size=32, generations=500_000), GenomeConfig(n_splats=512)
    sa_gnm, adam_gnm = GenomeConfig(), GenomeConfig(n_splats=ADAM_N)
    out = {"card": card, "replays": {}, "nodes_per_step": {}, "graph_nodes": {}}

    def rng(seed):
        return torch.Generator(device=dev).manual_seed(seed)

    def work(kinds) -> int:
        return kinds["KERNEL"] + kinds["MEMCPY"] + kinds["MEMSET"]

    def held(tag, run, st_g, st_e, blocks, call, between=None, fresh=None, phase_of=None):
        """The graphed and the eager blocks from equal states, equal in bits
        after each; the first replay's nodes (with phase_of(gen), those of
        the first replay of each (length, phase)) against graph_launches'
        count of the eager block from a throwaway state fresh(n, gen)."""
        replays, eager_work = 0, {}
        for i, n in enumerate(blocks):
            known, gen0 = run.graphs.replays, st_g[-1]  # the state's step count
            st_g, m_g = call(run, st_g, n, i)
            st_e, m_e = call(run.eager, st_e, n, i)
            check(_same_state(st_g, st_e) and torch.equal(m_g, m_e),
                  f"{tag}: block {i} ({n} steps) graphed differs from eager")
            if run.graphs.replays > known:
                replays += 1
                kinds = run.graphs.last.nodes
                key = None if phase_of is None else (n, phase_of(gen0))
                label = f"{tag}_{n}" if key is None else f"{tag}_{n}_phase{key[1]}"
                out["nodes_per_step"][label] = work(kinds) / n
                out["graph_nodes"][label] = dict(kinds)
                if key not in eager_work:
                    st_x, gens, opts = fresh(n, gen0)
                    eager_work[key] = graph_launches(
                        lambda: call(run.loop, st_x, n, i), n, generators=gens,
                        optimizers=opts, prepare=lambda: run.prepare(st_x, n))
                    check(work(kinds) == round(eager_work[key]["per_step"] * n),
                          f"{tag}: the replayed {label} graph holds {dict(kinds)}, the eager "
                          f"block {eager_work[key]['nodes']}")
            if between is not None:
                st_g, st_e = between(i, st_g), between(i, st_e)
        check(replays >= 2, f"{tag}: {replays} replays")
        out["replays"][tag] = replays
        print(f"CHECK {tag}: {len(blocks)} blocks {list(blocks)} replayed ({replays} replays) "
              "equal in bits to the eager body", flush=True)
        return st_g

    # the GA in three tiers, and annealed
    def ga_call(target_of=lambda i: tgt, sigma_of=lambda i: None):
        return lambda run, st, n, i: run(st, target_of(i), wm, n, blur_sigma=sigma_of(i))

    for tier in ("exact-tight", "fast", "bf16"):
        o = obj._replace(precision=tier)
        st0 = ga.init(rng(70), o, tgt, wm, cfg, gnm)
        run = ga.make_run_block(o, cfg, gnm)
        held(f"ga_{tier}", run, st0._replace(rng=rng(71)), st0._replace(rng=rng(71)),
             RBG_BLOCKS["ga"], ga_call(),
             fresh=lambda n, gen: (lambda s: (s, [s.rng], []))(st0._replace(rng=rng(72))))
    sigmas = [torch.full((), s, dtype=torch.float32, device=dev) for s in RBG_SIGMAS]
    blurred = [anneal.blur_image(tgt, s, anneal.default_radius(float(s))) for s in sigmas]

    def rescore(i, st):  # the sigma step genetic_approx takes between blocks
        if i + 1 < len(RBG_SIGMAS) and RBG_SIGMAS[i + 1] != RBG_SIGMAS[i]:
            return ga._rescore(st, obj, blurred[i + 1], wm, sigmas[i + 1])
        return st

    st0 = ga._rescore(ga.init(rng(73), obj, tgt, wm, cfg, gnm), obj, blurred[0], wm, sigmas[0])
    run = ga.make_run_block(obj, cfg, gnm)
    held("ga_annealed", run, st0._replace(rng=rng(74)), st0._replace(rng=rng(74)),
         RBG_BLOCKS["ga"], ga_call(lambda i: blurred[i], lambda i: sigmas[i]), between=rescore,
         fresh=lambda n, gen: (lambda s: (s, [s.rng], []))(st0._replace(rng=rng(75))))

    # Adam: run_grad's defaults (K7) and --metric mix (K2' forward, K6 backward)
    def plain_call(run, st, n, i):
        return run(st, tgt, wm, n)

    for tag, o in (("adam", obj), ("adam_mix", obj._replace(metric="mix"))):
        run = gradient.make_run_block(o, adam_gnm, GradConfig(lr=1e-2))
        g0 = adam_genome()

        def fresh(n, gen, run=run, g0=g0):
            st = gradient.init_state(run.make_opt, g0)
            st, _ = run.eager(st, tgt, wm, 1)  # the moments exist, as in a graphed block
            return st, [], [st.opt]

        held(tag, run, gradient.init_state(run.make_opt, g0), gradient.init_state(run.make_opt, g0),
             RBG_BLOCKS["adam"], plain_call, fresh=fresh)

    # SA (batched, sequential) and PT at run_sa's defaults
    for tag, c in (("sa", SAConfig()), ("sa_sequential", SAConfig(proposal_mode="sequential"))):
        st0 = sa.init(rng(76), obj, tgt, wm, sa_gnm)
        run = sa.make_run_block(obj, c, sa_gnm)
        held(tag, run, st0._replace(rng=rng(77)), st0._replace(rng=rng(77)), RBG_BLOCKS[tag],
             plain_call,
             fresh=lambda n, gen: (lambda s: (s, [s.rng], []))(st0._replace(rng=rng(78))))
    st0 = pt.init(rng(79), obj, tgt, wm, sa_gnm, PT_K, 1e-3, 1e-1)
    run = pt.make_run_block(obj, SAConfig(), sa_gnm, swap_every=10)
    held("pt", run, st0._replace(rng=rng(80)), st0._replace(rng=rng(80)), RBG_BLOCKS["pt"],
         plain_call, fresh=lambda n, gen: (lambda s: (s, [s.rng], []))(st0._replace(rng=rng(81))))

    # the memetic block at run_ga's defaults (K7 in its refinements), under
    # --metric mix (K2' and K6) and under --precision fast --cull-eps 8e-2
    # (K3/K4, and K7 on corner-culled lists), and the island block at
    # ISLAND_ARGV in the exact-tight and fast tiers: each (length, phase)
    # graph's nodes checked
    def ga_fresh(st0, seed):
        return lambda n, gen: (lambda s: (s, [s.rng], []))(st0._replace(rng=rng(seed), gen=gen))

    for tag, o, every in (("memetic", obj, MEMETIC_EVERY),
                          ("memetic_mix", obj._replace(metric="mix"), RBG_MIX_EVERY),
                          ("memetic_fast", obj._replace(precision="fast", cull_eps=8e-2),
                           RBG_MIX_EVERY)):
        st0 = ga.init(rng(110), o, tgt, wm, cfg, gnm)
        run = ga.make_memetic_run_block(o, cfg, gnm, GradConfig(lr=1e-2), every, MEMETIC_STEPS)
        held(tag, run, st0._replace(rng=rng(111)), st0._replace(rng=rng(111)), RBG_BLOCKS[tag],
             plain_call, fresh=ga_fresh(st0, 112), phase_of=lambda gen, every=every: gen % every)
    for tier in ("exact-tight", "fast"):
        o = obj._replace(precision=tier)
        st0 = ga.init(rng(113), o, tgt, wm, cfg, gnm)
        run = island.make_run_block(o, cfg, gnm, ISLANDS, ISLAND_EVERY, ISLAND_K)
        held(f"islands_{tier}", run, st0._replace(rng=rng(114)), st0._replace(rng=rng(114)),
             RBG_BLOCKS["islands"], plain_call, fresh=ga_fresh(st0, 115),
             phase_of=lambda gen: gen % ISLAND_EVERY)

    # a replay issues no host sync; a block copying from host memory is refused
    run = ga.make_run_block(obj, cfg, gnm)
    st = ga.init(rng(82), obj, tgt, wm, cfg, gnm)
    for _ in range(2):
        st, _ = run(st, tgt, wm, 5)
    check_no_sync(lambda: run(st, tgt, wm, 5), "a replayed 5-generation GA block")
    run = ga.make_memetic_run_block(obj, cfg, gnm, GradConfig(lr=1e-2), MEMETIC_EVERY,
                                    MEMETIC_STEPS)
    st = ga.init(rng(116), obj, tgt, wm, cfg, gnm)
    for _ in range(2):
        st, _ = run(st, tgt, wm, MEMETIC_EVERY)
    check_no_sync(lambda: run(st, tgt, wm, MEMETIC_EVERY),
                  f"a replayed {MEMETIC_EVERY}-generation memetic block (one refinement)")
    one = torch.ones(1, pin_memory=True)
    refused = block_graph.BlockGraphs(
        lambda inp, n, host, r: inp["x"] + one.to(dev, non_blocking=True))
    try:  # the first call runs the body eagerly, then captures it
        refused({"x": torch.zeros(1, device=dev)}, 1, 0)
        check(False, "a block copying from pinned host memory was captured")
    except RuntimeError as e:
        check("copies from host memory" in str(e), f"the host-copy refusal: {e}")
    print("CHECK a replay issues no host sync; a captured host copy is refused", flush=True)
    del refused

    # one resume through graphed blocks against the unbroken run
    phase("run block graphs: resume, run_ga graphed against eager")
    path = os.path.join(HERE, "output", "run_block_graphs", "ga_ckpt.npz")
    st0 = ga.init(rng(83), obj, tgt, wm, cfg, gnm)
    run = ga.make_run_block(obj, cfg, gnm)
    whole = st0._replace(rng=rng(84))
    for _ in range(2 * RBG_RESUME_BLOCKS):
        whole, _ = run(whole, tgt, wm, RBG_RESUME_GENS)
    run = ga.make_run_block(obj, cfg, gnm)
    half = st0._replace(rng=rng(84))
    for _ in range(RBG_RESUME_BLOCKS):
        half, _ = run(half, tgt, wm, RBG_RESUME_GENS)
    checkpoint.save_checkpoint(path, half, meta={"gen": half.gen})
    loaded, _ = checkpoint.load_checkpoint(path, ga.init(rng(85), obj, tgt, wm, cfg, gnm))
    run = ga.make_run_block(obj, cfg, gnm)
    for _ in range(RBG_RESUME_BLOCKS):
        loaded, _ = run(loaded, tgt, wm, RBG_RESUME_GENS)
    check(_same_state(loaded, whole),
          "a resume through graphed blocks differs from the unbroken graphed run")
    print(f"CHECK a graphed GA resumed after {RBG_RESUME_BLOCKS} blocks of {RBG_RESUME_GENS} "
          "equals the unbroken run in bits", flush=True)

    # run_ga at its defaults (frames, recycles, checkpoints), memetic and with
    # islands: graphed against the eager body of the run block it builds
    out["launches"] = {}
    for name, module, maker, argv in (
            ("run_ga", ga, "make_run_block", RBG_GA_ARGV),
            ("run_ga memetic", ga, "make_memetic_run_block", RBG_MEMETIC_ARGV),
            ("run_ga islands", island, "make_run_block", RBG_ISLAND_ARGV)):
        plain_make, res = getattr(module, maker), {}
        for mode in ("graphed", "eager"):
            if mode == "eager":
                setattr(module, maker, lambda *a, plain_make=plain_make, **kw:
                        plain_make(*a, **kw).eager)
            try:
                reset_kernel_counts()
                res[mode] = run_ga.main(["--image", "synthetic", *argv, "--output-dir",
                                         os.path.join(HERE, "output",
                                                      f"rbg_{name.replace(' ', '_')}_{mode}"),
                                         "--device", str(dev)])
                torch.cuda.synchronize()
                out["launches"][f"{name} {mode}"] = read_kernel_counts()
            finally:
                setattr(module, maker, plain_make)
        bg, be = np.asarray(res["graphed"]["best"]), np.asarray(res["eager"]["best"])
        check(bg.shape == be.shape and bool((bg.view(np.uint32) == be.view(np.uint32)).all())
              and res["graphed"]["curves"] == res["eager"]["curves"],
              f"{name} {argv}: graphed and eager runs differ")
        cg, ce = out["launches"][f"{name} graphed"], out["launches"][f"{name} eager"]
        gens = int(argv[argv.index("--generations") + 1])
        check(cg == ce and cg["K1"] >= gens, f"{name}'s launch counts: graphed {cg}, eager {ce}")
        print(f"CHECK {name} {' '.join(argv)} graphed equals eager: best genome, curves and "
              f"launch counts ({cg['K1']} K1, {cg['K2']} K2, {cg['K7']} K7)", flush=True)
    want_k7 = (int(RBG_MEMETIC_ARGV[1]) // MEMETIC_EVERY) * MEMETIC_STEPS
    check(out["launches"]["run_ga memetic graphed"]["K7"] == want_k7,
          f"the graphed memetic run_ga launched K7 "
          f"{out['launches']['run_ga memetic graphed']['K7']} times, not {want_k7}")

    # rates, graphed against eager in turns, and the device's busy share
    phase("run block graphs: graphed against eager, rates and busy shares")
    obj_fast = obj._replace(precision="fast")
    fams = {}
    for tag, o in (("ga", obj), ("ga_fast", obj_fast)):
        st0 = ga.init(rng(86), o, tgt, wm, cfg, gnm)
        fams[tag] = (ga.make_run_block(o, cfg, gnm), st0, st0._replace(rng=rng(87)),
                     lambda run, st, n: run(st, tgt, wm, n))
    run = gradient.make_run_block(obj, adam_gnm, GradConfig(lr=1e-2))
    fams["adam"] = (run, gradient.init_state(run.make_opt, adam_genome()),
                    gradient.init_state(run.make_opt, adam_genome(69)),
                    lambda run, st, n: run(st, tgt, wm, n))
    st0 = sa.init(rng(88), obj, tgt, wm, sa_gnm)
    fams["sa"] = (sa.make_run_block(obj, SAConfig(), sa_gnm), st0, st0._replace(rng=rng(89)),
                  lambda run, st, n: run(st, tgt, wm, n))
    st0 = pt.init(rng(90), obj, tgt, wm, sa_gnm, PT_K, 1e-3, 1e-1)
    fams["pt"] = (pt.make_run_block(obj, SAConfig(), sa_gnm, swap_every=10), st0,
                  st0._replace(rng=rng(91)), lambda run, st, n: run(st, tgt, wm, n))
    st0 = ga.init(rng(117), obj, tgt, wm, cfg, gnm)
    fams["memetic"] = (ga.make_memetic_run_block(obj, cfg, gnm, GradConfig(lr=1e-2),
                                                 MEMETIC_EVERY, MEMETIC_STEPS),
                       st0, st0._replace(rng=rng(118)), lambda run, st, n: run(st, tgt, wm, n))
    st0 = ga.init(rng(119), obj, tgt, wm, cfg, gnm)
    fams["islands"] = (island.make_run_block(obj, cfg, gnm, ISLANDS, ISLAND_EVERY, ISLAND_K),
                       st0, st0._replace(rng=rng(120)), lambda run, st, n: run(st, tgt, wm, n))
    rates, busy = {}, {}
    for tag, (run, st_g, st_e, call) in fams.items():
        n = RBG_RATE_STEPS[tag]
        box = {"graphed": st_g, "eager": st_e}
        fn = {"graphed": run, "eager": run.eager}
        for mode in ("graphed", "graphed", "graphed", "eager"):  # the graph's capture, replays
            box[mode], m = call(fn[mode], box[mode], n)
            m.cpu()
        torch.cuda.synchronize()
        got = {"graphed": [], "eager": []}
        for i in range(RBG_RATE_BLOCKS):
            for mode in (("graphed", "eager") if i % 2 == 0 else ("eager", "graphed")):
                t0 = time.perf_counter()
                box[mode], m = call(fn[mode], box[mode], n)
                m.cpu()
                torch.cuda.synchronize()
                got[mode].append(n / (time.perf_counter() - t0))
        rates[tag] = {mode: {"median": sorted(r)[RBG_RATE_BLOCKS // 2], "blocks": r}
                      for mode, r in got.items()}

        def profiled(mode, p):
            def fn_once():
                box[mode], m = call(fn[mode], box[mode], p)
                m.cpu()
            return profile_split(fn_once, p)

        # a replay of the timed length; the eager share barely depends on it
        busy[tag] = {"graphed": profiled("graphed", n), "eager": profiled("eager", RBG_PROFILE_STEPS)}
    out["steps_per_s"] = {t: {m: r[m]["median"] for m in r} for t, r in rates.items()}
    out["steps_per_s_blocks"] = {t: {m: r[m]["blocks"] for m in r} for t, r in rates.items()}
    out["speedup"] = {t: r["graphed"]["median"] / r["eager"]["median"] for t, r in rates.items()}
    out["device_busy_share"] = {t: {m: p["device_busy_share"] for m, p in b.items()}
                                for t, b in busy.items()}
    out["device_ms_per_step"] = {t: {m: sum(p["device_ms"].values()) / p["steps"]
                                     for m, p in b.items()} for t, b in busy.items()}
    out["profiler_kernels_per_step"] = {t: {m: p["kernels_per_step"] for m, p in b.items()}
                                        for t, b in busy.items()}
    out["rate_steps"] = RBG_RATE_STEPS
    print("RUN BLOCK GRAPHS " + json.dumps(out), flush=True)
    limit, key = LAUNCH_LIMITS["ga_exact_tight"], f"ga_exact-tight_{RBG_BLOCKS['ga'][0]}"
    check(out["nodes_per_step"][key] <= limit,
          f"the replayed GA graph holds {out['nodes_per_step'][key]} launches a generation, "
          f"above {limit}")
    return out


# ------------------------------------------------------------ the sharding slice


SHARD_GA_CFG = dict(pop_size=32, generations=500_000, elite_k=8)  # run_ga's defaults
SHARD_BLOCKS, SHARD_BLOCK_GENS = 2, 10  # the sharded GA blocks whose states are hashed
SHARD_TIME_BLOCKS, SHARD_TIME_GENS = 3, 20  # generations/s: timed blocks after a warm-up
SHARD_ADAM_STEPS = 20  # Adam steps/s: one timed block after a warm-up
SHARD_PATH_GENS = 40  # the in-world run_ga main paths (20 under fast and bf16)
SHARD_GRAD_STEPS = 20  # the in-world run_grad main paths (10 under mix)
SHARD_TORCHRUN_GENS = 100  # torchrun ... run_ga --pop-shards 2 --tile-shards 2
SHARD_TIMEOUT = 480  # seconds a world of ranks may take before it is killed
# the JAX package's sharding tolerances (tests/test_sharding.py:48, :115,
# :289, :339, :175-177, :229-234) and the slab sum's (:142)
SHARD_RTOL, SHARD_ATOL, SHARD_FAST_ATOL = 2e-5, 1e-6, 2e-3
SHARD_GRAD_RTOL, SHARD_GRAD_ATOL = 2e-4, {"mse": 1e-6, "mix": 2e-6}
SLAB_SUM_RTOL, SLAB_SUM_ATOL = 1e-6, 1e-7


# what read_kernel_counts reads from profiling.COUNTS, in its order: launches
# per kernel, as "<kernel>-init" those from an init canvas, K5's band stages
# and calls that also launched its fallback, bin_splats' calls by route, and
# K6's and K7's launches whose blocks took items from the queue
KERNEL_COUNTS = ("K1", "K2", "K3", "K3-canvas", "K4", "K1-bf16", "K5", "K6", "K7", "K1-init",
                 "K2-init", "K3-init", "K3-canvas-init", "K1-bf16-init", "K6-init", "K5-band",
                 "K5-fallback", "bin.dense", "bin.k5", "K6-queue", "K7-queue")


def reset_kernel_counts() -> None:
    """Zeroes the counts read_kernel_counts reads (and no caller's own)."""
    from ggs_tpu_torch.utils import profiling

    for k in KERNEL_COUNTS:
        profiling.COUNTS.pop(k, None)


def read_kernel_counts() -> dict:
    """KERNEL_COUNTS' counts since reset_kernel_counts."""
    from ggs_tpu_torch.utils import profiling

    return {k: profiling.COUNTS[k] for k in KERNEL_COUNTS}


def allclose_excess(got, want, rtol: float, atol: float) -> float:
    """max(|got - want| - (atol + rtol |want|)): <= 0 where every element is
    within numpy's allclose(rtol, atol)."""
    g, w = got.double(), want.double()
    return float(((g - w).abs() - (atol + rtol * w.abs())).max())


def tensor_hash(*xs) -> str:
    import hashlib

    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def ga_state_hash(st) -> str:
    return tensor_hash(st.pop, st.fits, st.best, st.best_fit, st.no_improve,
                       st.rng.get_state()) + f"@{st.gen}"


def ga_hashed_blocks(obj, tgt, wm, seed: int = 42):
    """SHARD_BLOCKS GA blocks from a seeded init -> (the state's hash after
    the init and after each block, the metrics' best column)."""
    import torch

    from ggs_tpu_torch.config import GAConfig, GenomeConfig
    from ggs_tpu_torch.models import ga

    cfg, gnm = GAConfig(**SHARD_GA_CFG), GenomeConfig(n_splats=512)
    st = ga.init(torch.Generator(device=tgt.device).manual_seed(seed), obj, tgt, wm, cfg, gnm)
    hashes, best = [ga_state_hash(st)], []
    for _ in range(SHARD_BLOCKS):
        st, m = ga.run_block(st, obj, tgt, wm, cfg, gnm, SHARD_BLOCK_GENS)
        hashes.append(ga_state_hash(st))
        best.extend(m[:, 0].tolist())
    return hashes, best


def ga_rate(obj, tgt, wm, counter=None) -> dict:
    """Generations/s of ga.run_block at run_ga's defaults: the median of
    SHARD_TIME_BLOCKS host-timed blocks of SHARD_TIME_GENS after a warm-up
    block; with `counter` (comm.BYTES), the bytes this rank put into
    collectives a generation."""
    import statistics

    import torch

    from ggs_tpu_torch.config import GAConfig, GenomeConfig
    from ggs_tpu_torch.models import ga

    cfg, gnm = GAConfig(**SHARD_GA_CFG), GenomeConfig(n_splats=512)
    st = ga.init(torch.Generator(device=tgt.device).manual_seed(7), obj, tgt, wm, cfg, gnm)
    st, _ = ga.run_block(st, obj, tgt, wm, cfg, gnm, SHARD_TIME_GENS)
    torch.cuda.synchronize()
    before = dict(counter) if counter is not None else None
    rates = []
    for _ in range(SHARD_TIME_BLOCKS):
        t0 = time.perf_counter()
        st, m = ga.run_block(st, obj, tgt, wm, cfg, gnm, SHARD_TIME_GENS)
        m.cpu()
        rates.append(SHARD_TIME_GENS / (time.perf_counter() - t0))
    out = {"gens_per_s": statistics.median(rates), "blocks": rates}
    if counter is not None:
        gens = SHARD_TIME_BLOCKS * SHARD_TIME_GENS
        out["collective_bytes_per_gen"] = {k: (counter[k] - before[k]) / gens for k in counter}
    return out


def adam_rate(obj, tgt, wm, g0) -> float:
    """Adam steps/s: one host-timed block of SHARD_ADAM_STEPS after a warm-up."""
    import torch

    from ggs_tpu_torch.config import GenomeConfig, GradConfig
    from ggs_tpu_torch.models import gradient

    make_opt, step = gradient.make_fit_step(obj, GenomeConfig(n_splats=g0.shape[1]), GradConfig())
    st = gradient.init_state(make_opt, g0)
    st, _ = gradient.run_block(st, step, tgt, wm, 3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st, fits = gradient.run_block(st, step, tgt, wm, SHARD_ADAM_STEPS)
    fits.cpu()
    return SHARD_ADAM_STEPS / (time.perf_counter() - t0)


def adam_genome(seed: int = 68):
    """run_grad's default genome batch: one seeded genome of 2000 splats at 512x512."""
    import torch

    from ggs_tpu_torch.models import genome

    gen = torch.Generator(device="cuda").manual_seed(seed)
    return genome.new_population(gen, 1, 2000, 512, 512, device="cuda")


def shard_inputs(side: int, P: int, N: int, seed: int):
    """run_ga's synthetic target and importance mask at side x side, and a
    seeded population [P, N, 9] on the card."""
    import torch

    from ggs_tpu_torch.config import MaskConfig
    from ggs_tpu_torch.models import genome
    from ggs_tpu_torch.ops import mask
    from ggs_tpu_torch.utils import io

    tgt = io.ensure_hw(io.synthetic_target(side, side), side, side, device="cuda")
    wm = mask.mask_from_config(tgt, side, side, MaskConfig())
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return tgt, wm, genome.new_population(gen, P, N, side, side, device="cuda")


def slab_checks() -> dict:
    """The row slabs in one process: each kernel of the sharded paths
    launched from a slab's lists (shifted boxes; the bottom slab, splats
    above it) against its plain version on those lists, under the gates
    the kernels have; the slab partials summed against the full fitness
    (rtol 1e-6, atol 1e-7); render_rows against the full canvas's rows
    (bits reported, CANVAS_ATOL); the slab gradients, summed as the psum
    and the gradient all-reduce sum them, against the full canvas's
    (GRAD_ROW_REL per gradient row)."""
    import torch

    from ggs_tpu_torch.ops import codec, fitness, render_cuda as rc, render_grad as rg

    phase("sharding slice: kernels vs plain from row slabs")
    out = {}
    # run_ga's defaults at pop 2 x tile 2: 16 candidates a rank, 256-row slabs
    for prec in ("exact-tight", "highest"):
        out[f"K1_K2_{prec}"] = compare(
            make_case(16, 512, 512, 512, prec, seed=60, y_origin=256, rows=256),
            f"slab 256+256 of 512x512, B=16 N=512 {prec}")
    out["K3"] = compare_fast(
        make_case(16, 512, 512, 512, "fast", seed=61, cull_eps=2e-3, y_origin=256, rows=256),
        "slab 256+256 of 512x512, B=16 N=512 fast eps=0.002 corner cull")
    out["K1-bf16"] = compare_bf16(
        make_case(16, 512, 512, 512, "bf16", seed=62, y_origin=256, rows=256),
        "slab 256+256 of 512x512, B=16 N=512 bf16")
    # run_ga --metric ssim at tile 2: K2 at B=32 on the top slab
    out["K2_top"] = compare(make_case(32, 512, 512, 512, "exact-tight", seed=63, rows=256),
                            "slab 0+256 of 512x512, B=32 N=512 exact-tight")
    # run_grad at tile 2: K6 (and K7) on the bottom slab's 16-row list tiles
    out["K6"] = compare_grad(make_grad_case(1, 2000, 512, 512, seed=64, y_origin=256, rows=256),
                             "K6/K7 slab 256+256 of 512x512, B=1 N=2000 exact-tight")
    # the 2048x2048 GA at tile 2: the bottom slab's first pass, 256 tiles: K5
    for key, prec, eps in (("exact", "exact-tight", None), ("fast", "fast", 2e-3)):
        sc = scatter_case(GA_P, BIG_N, GA_SIDE, 64, prec, eps, chunk=BIG_N // 2, seed=65,
                          y_origin=GA_SIDE // 2, rows=GA_SIDE // 2)
        out[f"K5_{key}"] = compare_scatter(sc, f"slab 1024+1024 of the 2048 GA, {prec}",
                                           dense=eps is None)
    # at tile 4: the bottom 512-row slab, 128 tiles, exact lists: K5 on the card
    sc = scatter_case(GA_P, BIG_N, GA_SIDE, 64, "exact-tight", chunk=BIG_N // 2, seed=65,
                      y_origin=GA_SIDE * 3 // 4, rows=GA_SIDE // 4)
    out["K5_exact_t4"] = compare_scatter(sc, "slab 1536+512 of the 2048 GA, exact-tight",
                                         dense=True)
    tiles_t4 = (GA_SIDE // 128) * (GA_SIDE // 4 // 64)
    check(tiles_t4 < rc.SCATTER_TILES, f"a 512-row slab of 2048 has {tiles_t4} tiles")

    phase("sharding slice: slab partials, rows and gradients against the full canvas")
    tgt, wm, pop = shard_inputs(512, 32, 512, 66)
    g9 = codec.genome_to_renderer(pop)
    w_eff, denom = fitness.weff_denom(wm, False, 1.0, 512, 512)
    sums, rows = {}, {}
    for prec in ("exact-tight", "highest", "bf16"):
        full = rc.fitness(g9, tgt, wm, 512, 512, precision=prec) * denom
        parts = sum(rc.fitness_partial(g9, tgt[y:y + 256], w_eff[y:y + 256], 512, 512, y,
                                       precision=prec) for y in (0, 256))
        sums[prec] = allclose_excess(parts, full, SLAB_SUM_RTOL, SLAB_SUM_ATOL)
        check(sums[prec] <= 0, f"{prec}: the slab partials' sum is off the full fitness")
    for prec in ("exact-tight", "highest", "fast"):
        img = rc.render(g9, 512, 512, precision=prec, corner_cull=True)
        got = torch.cat([rc.render_rows(g9, 512, 512, y, 256, precision=prec, corner_cull=True)
                         for y in (0, 256)], 1)
        rows[prec] = {"max_abs": float((got - img).abs().max()), "bits": torch.equal(got, img)}
        check(rows[prec]["max_abs"] <= CANVAS_ATOL, f"{prec}: render_rows is off the canvas")
    # the 2048x2048 GA's chained passes (N=10,000) from slabs of tile 2 (256
    # tiles) and tile 4 (128), B=4
    tgt_b, wm_b, pop_b = shard_inputs(GA_SIDE, 4, BIG_N, 67)
    g9b = codec.genome_to_renderer(pop_b)
    w_b, denom_b = fitness.weff_denom(wm_b, False, 1.0, GA_SIDE, GA_SIDE)
    full = rc.fitness(g9b, tgt_b, wm_b, GA_SIDE, GA_SIDE, precision="exact-tight") * denom_b
    for nt in (2, 4):
        hs = GA_SIDE // nt
        parts = sum(rc.fitness_partial(g9b, tgt_b[y:y + hs], w_b[y:y + hs], GA_SIDE, GA_SIDE, y,
                                       precision="exact-tight") for y in range(0, GA_SIDE, hs))
        sums[f"ga2048_tile{nt}"] = allclose_excess(parts, full, SLAB_SUM_RTOL, SLAB_SUM_ATOL)
        check(sums[f"ga2048_tile{nt}"] <= 0, f"2048 GA tile {nt}: slab partials off the fitness")
    del tgt_b, wm_b, pop_b, g9b, w_b
    # run_grad's defaults: the slab gradients summed against the full canvas's
    g1 = adam_genome()

    def grads(**kw):
        g = g1.detach().requires_grad_(True)
        img = rg.render_diff(codec.genome_to_renderer(g), 512, 512, box="tight", **kw)
        y0 = kw.get("y_origin", 0)
        d2 = torch.sum((img - tgt[y0:y0 + img.shape[1]]) ** 2, -1) * wm[y0:y0 + img.shape[1]]
        (gr,) = torch.autograd.grad(torch.sum(d2) / denom, g)
        return gr

    full_g = grads()
    slab_g = sum(grads(y_origin=y, out_rows=256) for y in (0, 256))
    scale = full_g.abs().amax(dim=(0, 1)).clamp_min(1e-30)
    grad_rows = ((slab_g - full_g).abs().amax(dim=(0, 1)) / scale).tolist()
    check(max(grad_rows) <= GRAD_ROW_REL, f"slab gradients off the full canvas's: {grad_rows}")
    out.update({"slab_sum_excess": sums, "rows": rows, "grad_rows": grad_rows})
    print("SLABS " + json.dumps({k: out[k] for k in ("slab_sum_excess", "rows", "grad_rows")}),
          flush=True)
    return out


def shard_worker(argv) -> int:
    """One rank of a gloo world of ranks sharing the one card:
    `python3 chip_smoke.py --shard-worker WORLD RANK STORE OUT_DIR`. Joins
    the world through a FileStore, loads the kernels the parent built, runs
    the sharded paths and their unsharded references and writes what it
    found to OUT_DIR/rank<RANK>.json for the parent to check. With a fifth
    argument "flagship" the rank runs flagship_worker instead."""
    world, rank, store, out_dir = int(argv[0]), int(argv[1]), argv[2], argv[3]
    if argv[4:] == ["flagship"]:
        return flagship_worker(world, rank, store, out_dir)
    import torch

    sys.path.insert(0, HERE)
    from ggs_tpu_torch import run_ga, run_grad
    from ggs_tpu_torch.config import GAConfig, GenomeConfig
    from ggs_tpu_torch.models import ga
    from ggs_tpu_torch.models import gradient
    from ggs_tpu_torch.ops import objective, render_cuda as rc
    from ggs_tpu_torch.parallel import comm, island, mesh as mesh_mod
    from ggs_tpu_torch.utils import checkpoint

    rc.build()  # loads the libraries the parent built
    init = dict(init_method="file://" + store, world_size=world, rank=rank)
    grids = {"1x2": (1, 2), "2x1": (2, 1)} if world == 2 else {"2x2": (2, 2), "1x4": (1, 4)}
    meshes = {k: mesh_mod.make_mesh(p, t, device="cuda", **init)
              for k, (p, t) in grids.items()}
    res = {"rank": rank, "world": world, "backend": meshes[next(iter(meshes))].backend,
           "device": str(meshes[next(iter(meshes))].device), "eval": {}, "ga": {}, "paths": {}}
    tgt, wm, pop = shard_inputs(512, 32, 512, 70)

    # evaluate over each mesh against the unsharded evaluate on this rank
    cases = [("mse", p) for p in ("exact-tight", "highest", "fast", "bf16")] + [
        ("ssim", "exact-tight"), ("mix", "exact-tight"), ("mix", "fast")]
    for tag, m in meshes.items():
        for metric, prec in cases:
            obj = objective.Objective(H=512, W=512, metric=metric, precision=prec)
            want = objective.evaluate(obj, pop, tgt, wm)
            got = objective.evaluate(obj._replace(mesh=m), pop, tgt, wm)
            atol = SHARD_FAST_ATOL if prec == "fast" else SHARD_ATOL
            res["eval"][f"{tag} {metric} {prec}"] = {
                "excess": allclose_excess(got, want, SHARD_RTOL, atol), "atol": atol,
                "max_rel": rel_err(got, want), "hash": tensor_hash(got)}
    # the 2048x2048 GA's evaluation (N=10,000, P=32): tile 2 (256 tiles), tile 4 (128)
    tile_mesh = meshes["1x2"] if world == 2 else meshes["1x4"]
    tgt_b, wm_b, pop_b = shard_inputs(GA_SIDE, GA_P, BIG_N, 30)
    for prec in ("exact-tight", "fast"):
        obj = objective.Objective(H=GA_SIDE, W=GA_SIDE, precision=prec)
        want = objective.evaluate(obj, pop_b, tgt_b, wm_b)
        reset_kernel_counts()
        got = objective.evaluate(obj._replace(mesh=tile_mesh), pop_b, tgt_b, wm_b)
        torch.cuda.synchronize()
        atol = SHARD_FAST_ATOL if prec == "fast" else SHARD_ATOL
        res["eval"][f"ga2048 tile{tile_mesh.tile_shards} {prec}"] = {
            "excess": allclose_excess(got, want, SHARD_RTOL, atol), "atol": atol,
            "max_rel": rel_err(got, want), "hash": tensor_hash(got),
            "launches": read_kernel_counts()}
    del tgt_b, wm_b, pop_b
    torch.cuda.empty_cache()

    # GA blocks: the state's hash after each (the parent compares ranks)
    obj = objective.Objective(H=512, W=512, precision="exact-tight")
    for tag, m in meshes.items():
        hashes, best = ga_hashed_blocks(obj._replace(mesh=m), tgt, wm)
        res["ga"][tag] = {"hashes": hashes, "best": best}
    gm = meshes["1x2"] if world == 2 else meshes["2x2"]
    res["rate"] = ga_rate(obj._replace(mesh=gm), tgt, wm, comm.BYTES)
    if world == 2:
        res["rate_pop"] = ga_rate(obj._replace(mesh=meshes["2x1"]), tgt, wm, comm.BYTES)
        # the tile-sharded Adam at run_grad's defaults against the unsharded
        gnm = GenomeConfig(n_splats=2000)
        g1 = adam_genome()
        res["adam"] = {}
        for metric in ("mse", "mix"):
            o = objective.Objective(H=512, W=512, metric=metric, precision="exact-tight")
            (l0, _), g0 = gradient.make_value_and_grad(o, gnm)(g1, tgt, wm)
            (l1, _), gs = gradient.make_value_and_grad(o._replace(mesh=gm), gnm)(g1, tgt, wm)
            res["adam"][metric] = {
                "loss_rel": abs(float(l1) - float(l0)) / abs(float(l0)),
                "grad_excess": allclose_excess(gs, g0, SHARD_GRAD_RTOL, SHARD_GRAD_ATOL[metric]),
                "grad_max_abs": float((gs - g0).abs().max()), "hash": tensor_hash(gs)}
        o = objective.Objective(H=512, W=512, precision="exact-tight")
        res["adam_steps_per_s"] = adam_rate(o._replace(mesh=gm), tgt, wm, g1)
    else:
        # the island GA with migration over the pop shards, and the resume
        cfg, gnm = GAConfig(**SHARD_GA_CFG), GenomeConfig(n_splats=512)
        objm = obj._replace(mesh=gm)
        run = island.make_run_block(objm, cfg, gnm, 4, 5, 2, mesh=gm)
        st = ga.init(torch.Generator(device="cuda").manual_seed(43), objm, tgt, wm, cfg, gnm)
        st, mt = run(st, tgt, wm, 20)
        res["islands"] = {"hash": ga_state_hash(st), "best": mt[:, 0].tolist()}
        path = os.path.join(out_dir, "ga_ckpt.npz")

        def fresh():
            return ga.init(torch.Generator(device="cuda").manual_seed(44), objm, tgt, wm, cfg,
                           gnm)

        full, _ = ga.run_block(fresh(), objm, tgt, wm, cfg, gnm, 20)
        half, _ = ga.run_block(fresh(), objm, tgt, wm, cfg, gnm, 10)
        checkpoint.save_checkpoint_distributed(path, half, {"gen": 10}, mesh=gm)
        loaded, meta = checkpoint.load_checkpoint(path, fresh())
        resumed, _ = ga.run_block(loaded, objm, tgt, wm, cfg, gnm, 10)
        res["resume"] = {"same_bits": ga_state_hash(resumed) == ga_state_hash(full),
                         "gen": meta["gen"], "hash": ga_state_hash(resumed)}

    # the sharded main paths through the runners, counts read on every rank
    def drive(tag, runner, argv):
        reset_kernel_counts()
        t0 = time.perf_counter()
        out = runner.main(["--image", "synthetic", *argv, "--output-dir",
                           os.path.join(out_dir, tag), "--device", "cuda"])
        torch.cuda.synchronize()
        entry = {"launches": read_kernel_counts(), "seconds": time.perf_counter() - t0}
        if "curves" in out:
            best = out["curves"]["best"]
            entry.update(best_first=best[0], best_last=best[-1], n=len(best) - 1,
                         best_fit=out["best_fit"])
        else:
            entry.update(loss_first=out["curve"][0], loss_last=out["curve"][-1],
                         n=len(out["curve"]), best_loss=out["best_loss"])
        res["paths"][tag] = entry

    if world == 2:
        g = str(SHARD_PATH_GENS // 2)
        drive("run_ga_ssim_1x2", run_ga, ["--tile-shards", "2", "--metric", "ssim",
                                          "--generations", g, "--log-every", g, "--no-video"])
        drive("run_grad_1x2", run_grad, ["--tile-shards", "2", "--steps", str(SHARD_GRAD_STEPS),
                                         "--log-every", str(SHARD_GRAD_STEPS)])
        drive("run_grad_mix_1x2", run_grad, ["--tile-shards", "2", "--metric", "mix", "--steps",
                                             str(SHARD_GRAD_STEPS // 2), "--log-every", "5"])
    else:
        for tag, gens, argv in (("run_ga_2x2", SHARD_PATH_GENS, []),
                                ("run_ga_fast_2x2", SHARD_PATH_GENS // 2, ["--precision", "fast"]),
                                ("run_ga_bf16_2x2", SHARD_PATH_GENS // 2, ["--precision", "bf16"])):
            drive(tag, run_ga, ["--pop-shards", "2", "--tile-shards", "2", "--generations",
                                str(gens), "--log-every", str(gens // 2), "--no-video", *argv])
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    torch.distributed.destroy_process_group()  # gloo's threads torn down before exit
    return 0


def run_world(n: int, out_dir: str, *mode: str) -> list:
    """Spawns n shard_worker ranks (gloo, all on cuda:0; `mode` "flagship"
    runs flagship_worker instead) and waits for them (killed at
    SHARD_TIMEOUT) -> each rank's results."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    store = os.path.join(out_dir, "store")
    env = dict(os.environ, PYTHONPATH=HERE, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--shard-worker",
                               str(n), str(r), store, out_dir, *mode], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SHARD_TIMEOUT)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-6000:], flush=True)
        check(p.returncode == 0, f"rank {r} of the {n}-rank world exited {p.returncode}")
    out = []
    for r in range(n):
        with open(os.path.join(out_dir, f"rank{r}.json")) as fh:
            out.append(json.load(fh))
    return out


def shard_checks_and_times(card) -> dict:
    """The sharding slice across processes, on the one card: worlds of 2
    and 4 gloo ranks (shard_worker), the checks on what they found, and
    `torchrun ... run_ga --pop-shards 2 --tile-shards 2` at run_ga's
    defaults. Single-process references are run here first, alone on the
    card."""
    import torch

    from ggs_tpu_torch.ops import objective

    phase("sharding slice: single-process references")
    tgt, wm, pop = shard_inputs(512, 32, 512, 70)
    obj = objective.Objective(H=512, W=512, precision="exact-tight")
    single_hashes, single_best = ga_hashed_blocks(obj, tgt, wm)
    single_rate = ga_rate(obj, tgt, wm)
    single_adam = adam_rate(obj, tgt, wm, adam_genome())
    del tgt, wm, pop
    torch.cuda.empty_cache()

    worlds = {}
    for n in (2, 4):
        phase(f"sharding slice: a world of {n} gloo ranks on cuda:0")
        worlds[n] = run_world(n, os.path.join(HERE, "output", f"shard_world{n}"))
    checks = {}
    for n, ranks in worlds.items():
        r0 = ranks[0]
        check(all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks),
              f"world {n}: {[(r['backend'], r['device']) for r in ranks]}")
        for key, e in r0["eval"].items():
            same = all(r["eval"][key]["hash"] == e["hash"] for r in ranks)
            print(f"CHECK sharded evaluate {key} (world {n}): max rel {e['max_rel']:.3e}, excess "
                  f"over rtol {SHARD_RTOL} atol {e['atol']} {e['excess']:.3e} (<= 0), the same "
                  f"bits on every rank {same}", flush=True)
            check(e["excess"] <= 0 and same, f"sharded evaluate {key} (world {n})")
            checks[f"eval {key}"] = e["max_rel"]
        for tag, g in r0["ga"].items():
            same = all(r["ga"][tag]["hashes"] == g["hashes"] for r in ranks)
            check(same, f"GA blocks over {tag}: the ranks' states differ")
            checks[f"ga {tag} ranks equal"] = same
            if tag == "2x1":
                bits = g["hashes"] == single_hashes
                gap = max(abs(a - b) / abs(b) for a, b in zip(g["best"], single_best))
                checks["ga 2x1 equals single process in bits"] = bits
                checks["ga 2x1 best max rel gap"] = gap
                check(bits or gap <= SHARD_RTOL, f"pop-only GA off the single process: {gap}")
            else:  # reported: a rounding apart in a fit can change a selection
                checks[f"ga {tag} best max rel gap to single"] = max(
                    abs(a - b) / abs(b) for a, b in zip(g["best"], single_best))
        for tag, p in r0["paths"].items():
            c = p["launches"]
            first, last = (p["best_first"], p["best_last"]) if "best_first" in p else (
                p["loss_first"], p["loss_last"])
            print(f"MAIN PATH {tag} (rank 0 of {n}) " + json.dumps(p), flush=True)
            check(last < first, f"{tag}: did not fall ({first} -> {last})")
            check(all(r["paths"][tag]["launches"] == c for r in ranks),
                  f"{tag}: the ranks launched different kernels")
            gens = p["n"]
            if tag.startswith("run_grad"):
                check(c["K6"] == gens and c["K2"] >= gens and c["K7"] == 0,
                      f"{tag}: K2'/K6 not once a step from the slab: {c}")
            elif "fast" in tag:
                check(c["K3"] >= gens and c["K4"] == 0, f"{tag}: K3 not once a generation: {c}")
            elif "bf16" in tag:
                check(c["K1-bf16"] >= gens, f"{tag}: K1-bf16 not once a generation: {c}")
            elif "ssim" in tag:
                check(c["K2"] >= gens and c["K1"] == 0, f"{tag}: K2 not once a generation: {c}")
            else:
                check(c["K1"] >= gens, f"{tag}: K1 not once a generation: {c}")
    w2, w4 = worlds[2][0], worlds[4][0]
    for metric, a in w2["adam"].items():
        print(f"CHECK tile-sharded Adam {metric} (1x2): loss rel {a['loss_rel']:.3e} (<= "
              f"{SHARD_RTOL}), gradient excess over rtol {SHARD_GRAD_RTOL} atol "
              f"{SHARD_GRAD_ATOL[metric]} {a['grad_excess']:.3e} (<= 0), max abs "
              f"{a['grad_max_abs']:.3e}", flush=True)
        check(a["loss_rel"] <= SHARD_RTOL and a["grad_excess"] <= 0, f"tile-sharded Adam {metric}")
        check(all(r["adam"][metric]["hash"] == a["hash"] for r in worlds[2]),
              f"tile-sharded Adam {metric}: the ranks' gradients differ")
    check(all(r["islands"]["hash"] == w4["islands"]["hash"] for r in worlds[4]),
          "the 2x2 island GA: the ranks' states differ")
    check(all(r["resume"]["same_bits"] and r["resume"]["gen"] == 10 for r in worlds[4]),
          "save_checkpoint_distributed -> resume is not the uninterrupted run in bits")
    k5 = w2["eval"]["ga2048 tile2 exact-tight"]["launches"]
    k5_t4 = w4["eval"]["ga2048 tile4 exact-tight"]["launches"]
    # exact lists: K5 on the 256 tiles of a 1024-row slab and the 128 of a
    # 512-row one, once a pass
    check(k5["K5"] >= 2 and k5_t4["K5"] == k5_t4["bin.k5"] == 2
          and k5_t4["bin.dense"] == 0,
          f"2048 GA: K5 {k5['K5']} launches at tile 2, {k5_t4['K5']} at tile 4: {k5_t4}")

    phase("sharding slice: torchrun run_ga --pop-shards 2 --tile-shards 2")
    out_tr = os.path.join(HERE, "output", "shard_torchrun")
    shutil.rmtree(out_tr, ignore_errors=True)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
         "-m", "ggs_tpu_torch.run_ga", "--image", "synthetic", "--pop-shards", "2",
         "--tile-shards", "2", "--generations", str(SHARD_TORCHRUN_GENS), "--log-every", "50",
         "--no-video", "--output-dir", out_tr],
        env=dict(os.environ, PYTHONPATH=HERE), capture_output=True, text=True,
        timeout=SHARD_TIMEOUT, cwd=HERE)
    torchrun_s = time.perf_counter() - t0
    print(proc.stdout[-3000:], flush=True)
    if proc.returncode != 0:
        print(proc.stderr[-6000:], flush=True)
    check(proc.returncode == 0, f"torchrun run_ga exited {proc.returncode}")
    written = sorted(os.listdir(out_tr))
    check(proc.stdout.count("Saved full resolution result") == 1
          and proc.stdout.count("mesh: pop=2 x tile=2 over 4 ranks, backend gloo") == 1
          and {"ga_splats.png", "ga_best_genome.npy", "ga_loss.csv"} <= set(written),
          f"torchrun run_ga: artifacts {written}")

    rates = {"single": single_rate["gens_per_s"], "2x1": w2["rate_pop"]["gens_per_s"],
             "1x2": w2["rate"]["gens_per_s"], "2x2": w4["rate"]["gens_per_s"]}
    times = {
        "card": card, "ga_generations_per_s": rates,
        "adam_steps_per_s": {"single": single_adam, "1x2": w2["adam_steps_per_s"]},
        "collective_bytes_per_generation_per_rank": {
            "2x1": w2["rate_pop"]["collective_bytes_per_gen"],
            "1x2": w2["rate"]["collective_bytes_per_gen"],
            "2x2": w4["rate"]["collective_bytes_per_gen"]},
        "torchrun_run_ga_seconds": torchrun_s, "torchrun_generations": SHARD_TORCHRUN_GENS,
    }
    print("SHARD TIMES " + json.dumps(times), flush=True)
    print("SHARD CHECKS " + json.dumps(checks), flush=True)
    launches = {tag: p["launches"] for w in (w2, w4) for tag, p in w["paths"].items()}
    launches["eval_ga2048_tile2"] = k5
    launches["eval_ga2048_tile4"] = k5_t4
    return {"times": times, "launches": launches}


# ------------------------------------------------------------ the flagship slice

# BASELINE.json configs[4], the JAX package's multi-host headline
# (tests/test_flagship_aot.py:30): pop 4096, 10,000 splats (two 5,000-splat
# passes), 1024x1024 (128 tiles of 64x128: K5, the dense binning under the
# fast tier's corner cull), scored in
# chunks of FLAG_CHUNK, the JAX flagship's per-device batch
# (tests/test_tpu_exactness.py:229). Only depth is cut: FLAG_GENS
# generations in each tier.
FLAG_P, FLAG_N, FLAG_SIDE, FLAG_CHUNK, FLAG_SMALL_CHUNK = 4096, 10_000, 1024, 1024, 512
FLAG_GENS, FLAG_FAST_EPS = 3, 8e-2
FLAG_SAMPLE = (0, 1, 1023, 1024, 2047, 2048, 3071, 4095)  # scored again at B=8
FLAG_PLAIN_B = 2  # candidates scored through the plain walks
FLAG_SMALL_B = 1000  # chunks of 512: the last padded
FLAG_SLAB_B = 1024  # B_loc of the pop 4 x tile 2 flagship mesh, on 512-row slabs
FLAG_ADAM_STEPS = 2  # the tile-sharded 10k Adam steps a rank takes


def flagship_inputs():
    """run_ga's target and importance mask at the flagship's canvas, as
    `run_ga --image natural:1024x1024` builds them."""
    from ggs_tpu_torch.config import MaskConfig
    from ggs_tpu_torch.ops import mask
    from ggs_tpu_torch.utils import io

    S = FLAG_SIDE
    tgt = io.ensure_hw(io.load_image(f"natural:{S}x{S}"), S, S, device="cuda")
    return tgt, mask.mask_from_config(tgt, S, S, MaskConfig())


@contextlib.contextmanager
def plain_walks():
    """K1, K2 and both epilogues of K3 replaced by their plain PyTorch
    versions (on the card's tensors, from the same lists, tables and init
    canvases) while the block runs."""
    from ggs_tpu_torch.ops import render_cuda as rc

    names = ("fitness_tiles", "render_tiles", "fitness_tiles_fast", "render_tiles_fast")
    saved = {n: getattr(rc, n) for n in names}
    for mode, sfx in (("exact", ""), ("fast", "_fast")):
        setattr(rc, "fitness_tiles" + sfx,
                lambda cnt, idx, feats, tp, wp, n_tx, th, tw, bg, init=None, mode=mode: (
                    rc.fitness_tiles_plain(cnt, idx, feats, tp, wp, n_tx, th, tw, bg, mode=mode,
                                           init=init)))
        setattr(rc, "render_tiles" + sfx,
                lambda cnt, idx, feats, n_tx, th, tw, bg, init=None, mode=mode: (
                    rc.render_tiles_plain(cnt, idx, feats, n_tx, th, tw, bg, mode=mode,
                                          init=init)))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(rc, n, fn)


def flagship_worker(world: int, rank: int, store: str, out_dir: str) -> int:
    """One rank of the tile-sharded 10k Adam step (the counterpart of
    tests/test_flagship_aot.py:65-86) in a gloo world of `world` ranks on
    cuda:0: one genome [1, FLAG_N, 9] at the flagship's canvas, its loss and
    gradient over 1024 / world-row slabs (K5 on the shifted boxes of 256
    16x128 gradient tiles, then K2' and K6 with d(init)) against the
    unsharded ones on this rank, then FLAG_ADAM_STEPS Adam steps whose state
    the parent compares across ranks by hash."""
    import torch

    sys.path.insert(0, HERE)
    from ggs_tpu_torch.config import GenomeConfig, GradConfig
    from ggs_tpu_torch.models import genome, gradient
    from ggs_tpu_torch.ops import objective, render_cuda as rc
    from ggs_tpu_torch.parallel import mesh as mesh_mod

    rc.build()  # loads the libraries the parent built
    m = mesh_mod.make_mesh(1, world, device="cuda", init_method="file://" + store,
                           world_size=world, rank=rank)
    S = FLAG_SIDE
    tgt, wm = flagship_inputs()
    g1 = genome.new_population(torch.Generator(device="cuda").manual_seed(69), 1, FLAG_N, S, S,
                               device="cuda")
    gnm = GenomeConfig(n_splats=FLAG_N)
    obj = objective.Objective(H=S, W=S, precision="exact-tight")
    (l0, _), g0 = gradient.make_value_and_grad(obj, gnm)(g1, tgt, wm)
    reset_kernel_counts()
    (l1, _), gs = gradient.make_value_and_grad(obj._replace(mesh=m), gnm)(g1, tgt, wm)
    torch.cuda.synchronize()
    launches = read_kernel_counts()
    make_opt, step = gradient.make_fit_step(obj._replace(mesh=m), gnm, GradConfig())
    st, fits = gradient.run_block(gradient.init_state(make_opt, g1), step, tgt, wm,
                                  FLAG_ADAM_STEPS)
    moments = st.opt.state[st.g]
    # each of the 9 gene rows against its largest unsharded magnitude
    scale = g0.abs().amax(dim=(0, 1))
    res = {"rank": rank, "backend": m.backend, "device": str(m.device), "launches": launches,
           "loss_rel": abs(float(l1) - float(l0)) / abs(float(l0)),
           "grad_excess": allclose_excess(gs, g0, SHARD_GRAD_RTOL, SHARD_GRAD_ATOL["mse"]),
           "grad_max_abs": float((gs - g0).abs().max()), "grad_scale": float(scale.max()),
           "grad_rows": ((gs - g0).abs().amax(dim=(0, 1)) / scale.clamp_min(1e-30)).tolist(),
           "grad_hash": tensor_hash(gs),
           "state_hash": tensor_hash(st.g, *(moments[k] for k in sorted(moments))),
           "fits": fits[:, 0].tolist()}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
        json.dump(res, fh)
    torch.distributed.destroy_process_group()
    return 0


def flagship_checks_and_times(card) -> dict:
    """The flagship population on the one card: `run_ga --image
    natural:1024x1024 --work-max-side 1024 --n-splats 10000 --pop-size 4096
    --eval-chunk 1024 --no-video` for FLAG_GENS generations, exact-tight
    (with `--checkpoint-every`, saving once) and `--precision fast
    --cull-eps 8e-2` (the chained K3 route: N > MAX_SPLATS keeps K4 off),
    each generation host-timed and the best falling; the saved population
    scored again at B=4096 in chunks of 1024 (CUDA events, the peak memory)
    equal in bits to the fits it was saved with, 8 of its candidates at B=8
    and 1000 in chunks of 512 (the last padded; that peak) equal in bits, 2
    through the plain walks within FITNESS_RTOL, and the fast tier's chunked
    evaluate timed (K3 once a chunk; its peak), 8 of its candidates at B=8
    equal in bits and 2 through the plain K3 walks within FITNESS_RTOL (no
    walk kernel launched there); the 512-row slab partials of
    its first 1024 (B_loc of the pop 4 x tile 2 mesh) summed against the
    whole (rtol 1e-6, atol 1e-7); the resume: the checkpoint loaded and one
    generation run, equal in bits to the run's own last generation; one
    generation under torch.profiler (the sort, K1, K2 and the rest); and
    the tile-sharded 10k Adam step in a world of 2 gloo ranks
    (flagship_worker) against one process (each gene row within
    GRAD_ROW_REL), the ranks' states equal by hash. Prints a `FLAGSHIP`
    line."""
    import statistics

    import torch

    from ggs_tpu_torch import run_ga
    from ggs_tpu_torch.config import GAConfig, GenomeConfig
    from ggs_tpu_torch.models import ga
    from ggs_tpu_torch.ops import codec, fitness, objective, render_cuda as rc
    from ggs_tpu_torch.utils import checkpoint

    S, n_chunks = FLAG_SIDE, FLAG_P // FLAG_CHUNK
    n_passes = -(-FLAG_N // rc.MAX_SPLATS)  # the chained passes of each render
    out_dir = os.path.join(HERE, "output", "flagship")
    shutil.rmtree(out_dir, ignore_errors=True)
    argv = ["--image", f"natural:{S}x{S}", "--work-max-side", str(S), "--n-splats", str(FLAG_N),
            "--pop-size", str(FLAG_P), "--eval-chunk", str(FLAG_CHUNK), "--no-video",
            "--generations", str(FLAG_GENS), "--log-every", "1", "--device", "cuda"]
    tiers = {"exact-tight": ["--checkpoint-every", str(FLAG_GENS - 1)],
             "fast": ["--precision", "fast", "--cull-eps", str(FLAG_FAST_EPS)]}
    runs, launches = {}, {}
    for tier, extra in tiers.items():
        phase(f"flagship: run_ga --pop-size {FLAG_P} --n-splats {FLAG_N} {S}x{S} "
              f"--eval-chunk {FLAG_CHUNK} {' '.join(extra)}")
        gen_s, saves, last = [], [], {}
        plain_make, plain_save = ga.make_run_block, checkpoint.save_checkpoint

        def timed_make(*a, **kw):
            """ga.make_run_block whose blocks (eager: the chunked evaluate)
            are each host-timed."""
            run = plain_make(*a, **kw)

            def timed_block(*ra, **rkw):
                t0 = time.perf_counter()
                st, m = run(*ra, **rkw)
                torch.cuda.synchronize()
                gen_s.append(time.perf_counter() - t0)
                last["state"] = st
                return st, m

            return timed_block

        def timed_save(path, *a, **kw):
            t0 = time.perf_counter()
            plain_save(path, *a, **kw)
            saves.append({"ms": 1e3 * (time.perf_counter() - t0), "bytes": os.path.getsize(path),
                          "path": path})

        ga.make_run_block, checkpoint.save_checkpoint = timed_make, timed_save
        try:
            reset_kernel_counts()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = run_ga.main(argv + extra + ["--output-dir", os.path.join(out_dir, tier)])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            ga.make_run_block, checkpoint.save_checkpoint = plain_make, plain_save
        c = launches[f"run_ga_{tier}"] = read_kernel_counts()
        best = res["curves"]["best"]
        # a copy: a graphed run's last state would lie in its output buffers
        st = last.pop("state")
        runs[tier] = {"seconds": wall, "generation_seconds": gen_s,
                      "gens_per_s": 1.0 / statistics.median(gen_s), "best_first": best[0],
                      "best_last": best[-1], "exact_rescore": res["best_fit"], "saves": saves,
                      "run_peak_bytes": torch.cuda.max_memory_allocated(),
                      "state": st._replace(**{f: getattr(st, f).clone() for f in st._fields[:5]})}
        del st
        print(f"MAIN PATH flagship {tier} " + json.dumps(
            {k: v for k, v in runs[tier].items() if k != "state"} | {"launches": c}), flush=True)
        final = res["final"]
        check(len(best) == FLAG_GENS + 1 and len(gen_s) == FLAG_GENS, f"flagship {tier}: curve")
        check(all(math.isfinite(b) for b in best) and best[-1] < best[0],
              f"flagship {tier}: the best did not fall ({best[0]} -> {best[-1]})")
        check(math.isfinite(res["best_fit"]) and res["best_fit"] > 0,
              f"flagship {tier}: rescored fitness")
        check(tuple(final.shape) == (S, S, 3) and bool(torch.isfinite(final).all())
              and float(final.min()) >= 0.0 and float(final.max()) <= 1.0,
              f"flagship {tier}: export render")
        evals = (FLAG_GENS + 1) * n_chunks  # the init and each generation, in chunks
        # after the run, both tiers: the exact-tight rescore of the best
        # (K2 then K1) and the export render (K2 for each pass, the last from
        # an init canvas); every exact list is K5's (128 tiles, no corner
        # cull), the fast tier's corner-culled ones stay dense
        tail_k2 = 1 + n_passes
        if tier == "fast":
            check(c["K3"] == c["K3-init"] == evals and c["K3-canvas"] == evals and c["K4"] == 0
                  and c["K1"] == c["K1-init"] == 1 and c["K2"] == tail_k2
                  and c["K2-init"] == n_passes - 1
                  and c["K5"] == c["bin.k5"] == 2 * n_passes
                  and c["bin.dense"] == 2 * evals,
                  f"flagship fast: K3 not once a chunk from K3's canvas: {c}")
        else:
            check(c["K1"] == c["K1-init"] == evals + 1 and c["K2"] == evals + tail_k2
                  and c["K2-init"] == n_passes - 1
                  and c["K5"] == c["bin.k5"] == c["K1"] + c["K2"]
                  and c["bin.dense"] == 0,
                  f"flagship exact-tight: K1 not once a chunk from K2's canvas: {c}")
            check(len(saves) == 1, f"flagship: {len(saves)} checkpoints saved, not one")
    ref_state = runs["exact-tight"].pop("state")
    del runs["fast"]["state"], res, final
    torch.cuda.empty_cache()

    phase("flagship: the saved population scored again; the slabs; the resume")
    tgt, wm = flagship_inputs()
    obj = objective.Objective(H=S, W=S, chunk=FLAG_CHUNK, precision="exact-tight")
    cfg, gnm = GAConfig(pop_size=FLAG_P, generations=FLAG_GENS), GenomeConfig(n_splats=FLAG_N)
    save = runs["exact-tight"]["saves"][0]
    template = ga.GAState(
        pop=torch.empty_like(ref_state.pop), fits=torch.empty_like(ref_state.fits),
        best=torch.empty_like(ref_state.best), best_fit=torch.empty_like(ref_state.best_fit),
        no_improve=torch.empty_like(ref_state.no_improve), rng=torch.Generator(device="cuda"),
        gen=0)
    t0 = time.perf_counter()
    loaded, meta = checkpoint.load_checkpoint(save["path"], template)
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    check(loaded.gen == meta["gen"] == FLAG_GENS - 1, f"the checkpoint holds generation {meta}")
    pop = loaded.pop

    def peak_of(fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end), torch.cuda.max_memory_allocated(), base

    reset_kernel_counts()
    fits, eval_ms, peak_1024, base_1024 = peak_of(lambda: objective.evaluate(obj, pop, tgt, wm))
    c = read_kernel_counts()
    check(c["K1"] == c["K1-init"] == n_chunks and c["K2"] == n_chunks,
          f"the chunked evaluate: K1 and K2 not once a chunk: {c}")
    same_saved = torch.equal(fits, loaded.fits)
    idx = torch.tensor(FLAG_SAMPLE, device="cuda")
    same_b8 = torch.equal(objective.evaluate(obj, pop[idx], tgt, wm), fits[idx])
    small, _, peak_512, base_512 = peak_of(lambda: objective.evaluate(
        obj._replace(chunk=FLAG_SMALL_CHUNK), pop[:FLAG_SMALL_B], tgt, wm))
    same_512 = torch.equal(small, fits[:FLAG_SMALL_B])
    fast_obj = obj._replace(precision="fast", cull_eps=FLAG_FAST_EPS)
    reset_kernel_counts()
    fits_fast, fast_ms, peak_fast, base_fast = peak_of(lambda: objective.evaluate(
        fast_obj, pop, tgt, wm))
    c = read_kernel_counts()
    check(c["K3"] == c["K3-init"] == c["K3-canvas"] == n_chunks and c["K4"] == 0
          and tuple(fits_fast.shape) == (FLAG_P,) and bool(torch.isfinite(fits_fast).all()),
          f"the chunked fast evaluate: K3 not once a chunk from K3's canvas: {c}")
    same_b8_fast = torch.equal(objective.evaluate(fast_obj, pop[idx], tgt, wm), fits_fast[idx])
    reset_kernel_counts()
    with plain_walks():
        plain_rel = rel_err(objective.evaluate(obj, pop[:FLAG_PLAIN_B], tgt, wm),
                            fits[:FLAG_PLAIN_B])
        plain_fast_rel = rel_err(objective.evaluate(fast_obj, pop[:FLAG_PLAIN_B], tgt, wm),
                                 fits_fast[:FLAG_PLAIN_B])
    c = read_kernel_counts()
    print(f"CHECK flagship evaluate B={FLAG_P} chunk {FLAG_CHUNK}: the saved fits in bits "
          f"{same_saved}; {len(FLAG_SAMPLE)} candidates at B=8 in bits {same_b8}, fast "
          f"{same_b8_fast}; {FLAG_SMALL_B} in chunks of {FLAG_SMALL_CHUNK} in bits {same_512}; "
          f"{FLAG_PLAIN_B} through the plain walks max rel {plain_rel:.3e}, fast eps "
          f"{FLAG_FAST_EPS} {plain_fast_rel:.3e} (each <= {FITNESS_RTOL})", flush=True)
    check(same_saved and same_b8 and same_512 and same_b8_fast,
          "flagship fits depend on the batch they are in")
    check(plain_rel <= FITNESS_RTOL, f"flagship fits off the plain walks by {plain_rel}")
    check(plain_fast_rel <= FITNESS_RTOL,
          f"flagship fast fits off the plain walks by {plain_fast_rel}")
    check(not any(c[k] for k in ("K1", "K2", "K3", "K3-canvas")),
          f"a walk kernel launched under plain_walks: {c}")

    # one rank's share of the pop 4 x tile 2 mesh: B_loc = 1024 on 512-row slabs
    g9 = codec.genome_to_renderer(pop[:FLAG_SLAB_B])
    w_eff, denom = fitness.weff_denom(wm, False, 1.0, S, S)
    hs = S // 2
    reset_kernel_counts()
    parts = sum(rc.fitness_partial(g9, tgt[y:y + hs], w_eff[y:y + hs], S, S, y,
                                   precision="exact-tight") for y in (0, hs))
    launches["slabs_B1024"] = read_kernel_counts()
    slab_excess = allclose_excess(parts, fits[:FLAG_SLAB_B] * denom, SLAB_SUM_RTOL,
                                  SLAB_SUM_ATOL)
    print(f"CHECK flagship slabs B={FLAG_SLAB_B}, rows 0-{hs - 1} and {hs}-{S - 1}: excess over "
          f"rtol {SLAB_SUM_RTOL} atol {SLAB_SUM_ATOL} {slab_excess:.3e} (<= 0), max rel "
          f"{rel_err(parts, fits[:FLAG_SLAB_B] * denom):.3e}; launches "
          f"{launches['slabs_B1024']}", flush=True)
    check(slab_excess <= 0, "the flagship's slab partials are off the whole fitness")
    check(launches["slabs_B1024"]["K1-init"] == 2
          and launches["slabs_B1024"]["K5"] == launches["slabs_B1024"]["bin.k5"]
          == 2 * n_passes, f"flagship slabs: {launches['slabs_B1024']}")
    del g9, parts

    reset_kernel_counts()
    resumed, _ = ga.run_block(loaded, obj, tgt, wm, cfg, gnm, 1)
    launches["resumed_generation"] = read_kernel_counts()
    same_resume = _same_state(resumed, ref_state)
    print(f"CHECK flagship resume: generation {FLAG_GENS - 1} saved ({save['bytes']} bytes, "
          f"{save['ms']:.1f} ms), loaded ({load_ms:.1f} ms), one generation run: equal in bits "
          f"to the run's own {same_resume}", flush=True)
    check(same_resume, "the flagship's resumed generation differs from the run's")
    del loaded, pop, ref_state, small, fits_fast

    # a CUDA graph of one flagship generation in each tier, though the rule
    # (block_graph.stays_eager) keeps the chunked evaluate eager: the peak
    # with its private pool, or the capture that does not fit
    phase("flagship: one generation captured as a CUDA graph, each tier")
    graph_peak = {}
    for tier, o in (("exact-tight", obj), ("fast", fast_obj)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        run = ga.make_run_block(o, cfg, gnm)
        check(not run.use_graphs, f"flagship {tier}: the chunked evaluate's block is not eager")
        try:
            st, _ = run.graphed(resumed, tgt, wm, 1)  # the eager warm-up, then the capture
            graph_peak[tier] = {"captured": True, "peak_bytes": torch.cuda.max_memory_allocated()}
            del st
        except RuntimeError as e:
            check("out of memory" in str(e), f"flagship {tier}: the capture failed: {e}")
            graph_peak[tier] = {"captured": False, "peak_bytes": torch.cuda.max_memory_allocated(),
                                "error": str(e)[:300]}
        del run
    gc.collect()
    torch.cuda.empty_cache()
    print("FLAGSHIP GRAPH " + json.dumps(graph_peak), flush=True)

    phase("flagship: one generation under torch.profiler")
    prof = profile_split(lambda: ga.run_block(resumed, obj, tgt, wm, cfg, gnm, 1)[1].cpu(), 1)
    print("PROFILE flagship generation " + json.dumps(prof), flush=True)
    k2_ms = sum(e["ms"] for e in prof["top"] if "render_kernel" in e["name"])
    del resumed, fits
    torch.cuda.empty_cache()

    phase("flagship: the tile-sharded 10k Adam step, a world of 2 gloo ranks on cuda:0")
    ranks = run_world(2, os.path.join(HERE, "output", "flagship_world2"), "flagship")
    r0 = ranks[0]
    launches["adam_tile2_rank0"] = r0["launches"]
    same = all(r["state_hash"] == r0["state_hash"] and r["grad_hash"] == r0["grad_hash"]
               for r in ranks)
    print(f"CHECK flagship tile-sharded Adam (1x2, N={FLAG_N}, {S}x{S}): loss rel "
          f"{r0['loss_rel']:.3e} (<= {SHARD_RTOL}), gradient excess over rtol {SHARD_GRAD_RTOL} "
          f"atol {SHARD_GRAD_ATOL['mse']} {r0['grad_excess']:.3e} (<= 0), max abs "
          f"{r0['grad_max_abs']:.3e} of max |g| {r0['grad_scale']:.3e}, per gene row of its "
          f"largest {max(r0['grad_rows']):.3e} (<= {GRAD_ROW_REL}); the ranks' states after "
          f"{FLAG_ADAM_STEPS} steps equal by hash {same}; launches {r0['launches']}", flush=True)
    check(all(r["backend"] == "gloo" and r["device"] == "cuda:0" for r in ranks),
          f"flagship world: {[(r['backend'], r['device']) for r in ranks]}")
    check(all(r["loss_rel"] <= SHARD_RTOL and r["grad_excess"] <= 0
              and max(r["grad_rows"]) <= GRAD_ROW_REL for r in ranks),
          "the flagship's tile-sharded Adam gradient is off one process's")
    check(same, "the flagship's tile-sharded Adam: the ranks' states differ")
    a = r0["launches"]
    check(a["K5"] == a["K6"] == 2 and a["K6-init"] == 1 and a["K2-init"] == 1 and a["K7"] == 0,
          f"the flagship's tile-sharded gradient: K5, K2' and K6 not once a pass: {a}")

    gen_prof = prof["device_ms"]
    times = {
        "card": card, "pop": FLAG_P, "n_splats": FLAG_N, "side": S, "chunk": FLAG_CHUNK,
        "renders_per_s_B4096": FLAG_P / eval_ms * 1e3, "evaluate_ms_B4096": eval_ms,
        f"renders_per_s_B4096_fast_{FLAG_FAST_EPS}": FLAG_P / fast_ms * 1e3,
        "gens_per_s": {"exact-tight": runs["exact-tight"]["gens_per_s"],
                       f"fast_{FLAG_FAST_EPS}": runs["fast"]["gens_per_s"]},
        "generation_seconds": {t: r["generation_seconds"] for t, r in runs.items()},
        "run_ga_seconds": {t: r["seconds"] for t, r in runs.items()},
        # run_ga's whole run (its blocks eager: the chunked evaluate), and
        # one generation captured as a CUDA graph in each tier
        "run_peak_bytes": {t: r["run_peak_bytes"] for t, r in runs.items()},
        "graph_of_a_generation": graph_peak,
        "peak_bytes": {f"chunk{FLAG_CHUNK}": peak_1024, f"chunk{FLAG_SMALL_CHUNK}": peak_512,
                       f"chunk{FLAG_CHUNK}_fast": peak_fast},
        "allocated_before_bytes": {f"chunk{FLAG_CHUNK}": base_1024,
                                   f"chunk{FLAG_SMALL_CHUNK}": base_512,
                                   f"chunk{FLAG_CHUNK}_fast": base_fast},
        "sort_device_ms_per_pass": gen_prof["sort"] / (2 * n_chunks),
        "K1_device_ms_per_chunk": gen_prof["walk"] / n_chunks,
        "K2_device_ms_per_chunk": k2_ms / n_chunks,
        "generation_device_ms": gen_prof, "generation_busy_share": prof["device_busy_share"],
        "launches_per_generation": {"device_profiler": prof["kernels_per_step"],
                                    **{k: n for k, n in launches["resumed_generation"].items()
                                       if n}},
        "checkpoint": {"bytes": save["bytes"], "save_ms": save["ms"], "load_ms": load_ms},
    }
    print("FLAGSHIP " + json.dumps(times), flush=True)
    return {"times": times, "launches": launches}


def main() -> int:
    import torch

    # 1. device
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from ggs_tpu_torch import run_ga, run_grad
    from ggs_tpu_torch.config import GAConfig, GenomeConfig, GradConfig, MaskConfig
    from ggs_tpu_torch.models import ga, genome, gradient
    from ggs_tpu_torch.ops import codec, mask, objective, oracle, render_cuda as rc
    from ggs_tpu_torch.ops import render_grad as rg
    from ggs_tpu_torch.utils import io

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    print(card, flush=True)

    # 2. build
    phase("build")
    t0 = time.perf_counter()
    kern = rc.build()
    built = ", ".join(os.path.relpath(path, HERE) for path in kern.paths.values())
    print(f"built {built} in {time.perf_counter() - t0:.2f} s; K6/K7 blocks a SM "
          f"{kern.grad.ggs_grad_blocks_per_sm(0)}/{kern.grad.ggs_grad_blocks_per_sm(1)}")
    for name, log in kern.logs.items():
        print(f"  {name}:")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("    " + line.strip())
    walk_build = walk_report(kern)

    # 3. kernels against their plain versions
    phase("kernels vs plain")
    errs = {}
    main_case = {}
    for precision in ("exact-tight", "highest"):
        c = make_case(32, 512, 512, 512, precision)
        errs[precision] = compare(c, f"B=32 N=512 512x512 {precision}")
        main_case[precision] = c
    c_odd = make_case(4, 256, 200, 328, "exact-tight", seed=1)
    compare(c_odd, "B=4 N=256 200x328 exact-tight (odd canvas)")
    cap = int(c_odd["cnt"].max()) // 2
    c_cap = make_case(4, 256, 200, 328, "highest", cap=cap, seed=1)
    check(int(c_cap["cnt"].max()) == cap, "bin_capacity did not truncate")
    compare(c_cap, f"B=4 N=256 200x328 highest bin_capacity={cap}")
    # the SA slice's shapes: run_sa's tries (B=8: K1, and K2 under --metric
    # ssim), sequential SA and the highest rescore (B=1), and PT with 2
    # replicas under highest with the mix metric (K2 at B=16); PT with 4
    # replicas and run_ga --metric ssim walk B=32, checked above
    for B, precision in ((8, "exact-tight"), (1, "exact-tight"), (1, "highest"), (16, "highest")):
        compare(make_case(B, 512, 512, 512, precision, seed=24),
                f"B={B} N=512 512x512 {precision} (run_sa)")

    # the pipeline slice's GA stages below N=512: run_pipeline's grow-auto
    # (B=32: K1, and K2 for each growth) and --grow-stages 3 --precision fast
    # (B=32: K3 both epilogues, K4) below
    for N in PIPE_NS[:-1]:
        compare(make_case(32, N, 512, 512, "exact-tight", seed=50 + N // 64),
                f"B=32 N={N} 512x512 exact-tight (growth stage)")

    # the entry points on a small input against the dense oracle on the CPU
    gen = torch.Generator(device="cuda").manual_seed(7)
    g_small = genome.new_population(gen, 2, 16, 40, 200, min_scale=1.0, max_scale=0.3,
                                    device="cuda")
    tgt_small = io.ensure_hw(io.synthetic_target(40, 200), 40, 200, device="cuda")
    obj_small = objective.Objective(H=40, W=200, precision="exact-tight")
    f_gpu = objective.evaluate(obj_small, g_small, tgt_small, device="cuda").double().cpu()
    f_ref = objective.evaluate(obj_small._replace(impl="oracle"), g_small.cpu(),
                               tgt_small.cpu(), device="cpu").double()
    rel = float(((f_gpu - f_ref).abs() / f_ref).max())
    img_gpu = objective.render_genomes(obj_small, g_small, device="cuda").cpu()
    img_ref = oracle.render_dense(codec.genome_to_renderer(g_small.cpu()), 40, 200, box="tight")
    img_err = float((img_gpu - img_ref).abs().max())
    print(f"CHECK entry points vs CPU dense oracle (B=2 N=16 40x200): fitness max rel "
          f"{rel:.3e}, canvas max abs {img_err:.3e}")
    check(rel <= FITNESS_RTOL and img_err <= CANVAS_ATOL, "entry points disagree with the oracle")

    # K6 and K7 at run_grad's shape and at the memetic elite batch
    grad_cases = {
        "B1_N2000": make_grad_case(1, 2000, 512, 512, seed=10),
        "B8_N512": make_grad_case(8, 512, 512, 512, seed=11),
    }
    grad_errs = {k: compare_grad(c, f"K6/K7 {k} 512x512 exact-tight 16x128 tiles")
                 for k, c in grad_cases.items()}
    # the same genomes on every list tile height the kernels walk
    tile_cases = {th: make_grad_case(1, 2000, 512, 512, seed=10, tile_h=th)
                  for th in rg.GRAD_TILE_HS if th != rg.GRAD_TILE_H}
    tile_cases[rg.GRAD_TILE_H] = grad_cases["B1_N2000"]
    for th, c in tile_cases.items():
        if th != rg.GRAD_TILE_H:
            grad_errs[f"B1_N2000_th{th}"] = compare_grad(
                c, f"K6/K7 B1_N2000 512x512 exact-tight {th}x128 tiles")
    # K1/K2 against plain on every list tile height the walks take (the
    # gradient paths' 8-64 x 128 lists: 2-16 sub-tiles a tile), from the
    # background and from a seeded canvas
    for th, c in sorted(tile_cases.items()):
        cf = dict(c, feats=c["feats_fast"])
        errs[f"tiles_{th}"] = compare(cf, f"B=1 N=2000 512x512 exact-tight {th}x128 tiles")
        compare_init(cf, "exact", f"seeded canvas, B=1 N=2000 {th}x128 tiles")
    # K6/K7 at the pipeline's Adam polish (B=1, N=512)
    grad_errs["B1_N512"] = compare_grad(make_grad_case(1, 512, 512, 512, seed=13),
                                        "K6/K7 B1_N512 512x512 exact-tight 16x128 tiles (polish)")
    check_grad_entry_points()

    # K3 (both epilogues) and K4 at the fast GA's shapes, at both eps with the
    # corner cull, on the odd canvas; K1-bf16 at the bf16 GA's
    fast_cases, fast_errs = {}, {}
    for eps in (2e-3, 8e-2):
        c = fast_cases[eps] = make_case(32, 512, 512, 512, "fast", seed=20, cull_eps=eps)
        fast_errs[eps] = compare_fast(c, f"B=32 N=512 512x512 fast eps={eps} corner cull")
    compare_fast(make_case(4, 256, 200, 328, "fast", seed=21, cull_eps=8e-2),
                 "B=4 N=256 200x328 fast eps=0.08 (odd canvas)")
    compare_fast(make_case(4, 256, 200, 328, "fast", tile_h=16, seed=21, cull_eps=8e-2),
                 "B=4 N=256 200x328 fast eps=0.08, 16x128 tiles")
    compare_bf16(make_case(4, 256, 200, 328, "bf16", tile_h=16, seed=23),
                 "B=4 N=256 200x328 bf16, 16x128 tiles")
    bf16_case = make_case(32, 512, 512, 512, "bf16", seed=22)
    bf16_err = compare_bf16(bf16_case, "B=32 N=512 512x512 bf16")
    # run_sa's tries under --precision fast (K4, K3) and bf16 (K1-bf16)
    compare_fast(make_case(8, 512, 512, 512, "fast", seed=25, cull_eps=2e-3),
                 "B=8 N=512 512x512 fast eps=0.002 corner cull (run_sa)")
    compare_bf16(make_case(8, 512, 512, 512, "bf16", seed=26), "B=8 N=512 512x512 bf16 (run_sa)")
    for N in GROW_FAST_NS[:-1]:
        compare_fast(make_case(32, N, 512, 512, "fast", seed=56 + N // 128, cull_eps=2e-3),
                     f"B=32 N={N} 512x512 fast eps=0.002 corner cull (growth stage)")
    bf16x2 = check_bf16x2(kern)
    check_fast_entry_points()

    # the large-canvas path: every walk from an init canvas (a chained
    # pass), K6 with d(init), and K5 at the shapes of its main paths. First
    # from a seeded canvas at the earlier shapes, then on the last pass of a
    # two-pass chain as each main path builds it: the 2048x2048 GA (B=32,
    # 5,000-splat passes, 512 tiles; exact-tight K1/K2, fast K3 with the
    # corner cull), big-10k-1024 (B=4, K1-bf16 from the f32 pass's canvas)
    # and grad-10k-1024 (B=1, K6 with d(init) on 512 gradient tiles). Each
    # chained case runs on its own data, where the last pass's hundreds of
    # layers may hide the init canvas, and on its faint copy (alphas / 32,
    # the same lists), where the init shows and must move the result
    phase("kernels vs plain: init canvases and chained passes")
    init_errs = {mode: compare_init(c, mode, "seeded canvas, B=32 N=512 512x512")
                 for mode, c in (("exact", main_case["exact-tight"]), ("fast", fast_cases[2e-3]),
                                 ("bf16", bf16_case))}
    compare_grad_init(grad_cases["B1_N2000"], "seeded canvas, B=1 N=2000 512x512")

    def chained_init(key, c, mode, label):
        own = compare_init(c, mode, label, init_must_show=False)
        fnt = compare_init(faint(c), mode, label + ", alphas / 32")
        init_errs[key] = {k: max(own[k], fnt[k]) for k in ("fitness_rel", "partials", "canvas")}
        init_errs[key]["init_shows_in_own_data"] = own["init_shows"]

    gen = torch.Generator(device="cuda").manual_seed(30)
    g9_ga = codec.genome_to_renderer(
        genome.new_population(gen, GA_P, BIG_N, GA_SIDE, GA_SIDE, device="cuda"))
    tgt_ga = io.ensure_hw(io.synthetic_target(GA_SIDE, GA_SIDE), GA_SIDE, GA_SIDE, device="cuda")
    wm_ga = mask.mask_from_config(tgt_ga, GA_SIDE, GA_SIDE, MaskConfig())
    ga_label = f"2048x2048 GA's 2nd pass, N={BIG_N}"
    chained_init("ga_exact", chained_case(g9_ga, tgt_ga, wm_ga, "exact-tight"), "exact", ga_label)
    eps = rc.DEFAULT_CULL_EPS  # the fast GA's, with Objective's corner cull
    chained_init("ga_fast", chained_case(g9_ga, tgt_ga, wm_ga, "fast", eps, corner_cull=True),
                 "fast", f"{ga_label}, eps {eps} corner cull")
    del g9_ga, tgt_ga, wm_ga
    gen = torch.Generator(device="cuda").manual_seed(34)  # the bf16 main path's population
    g9_b = codec.genome_to_renderer(
        genome.new_population(gen, BIG_B, BIG_N, BIG_SIDE, BIG_SIDE, device="cuda"))
    tgt_b = io.ensure_hw(io.synthetic_target(BIG_SIDE, BIG_SIDE), BIG_SIDE, BIG_SIDE,
                         device="cuda")
    chained_init("big_bf16", chained_case(g9_b, tgt_b, None, "bf16"), "bf16",
                 f"big-10k-1024's 2nd pass, N={BIG_N}")
    gen = torch.Generator(device="cuda").manual_seed(32)
    g9_g = codec.genome_to_renderer(genome.new_population(gen, 1, BIG_N, BIG_SIDE, BIG_SIDE,
                                                          device="cuda"))
    wm_b = mask.mask_from_config(tgt_b, BIG_SIDE, BIG_SIDE, MaskConfig())
    cg = chained_grad_case(g9_g, tgt_b, wm_b)
    grad_label = f"grad-10k-1024's 2nd pass, N={BIG_N}"
    own = compare_grad_init(cg, grad_label, init_must_show=False)
    fnt = compare_grad_init(faint(cg), grad_label + ", alphas / 32")
    big_grad_init_err = {"dinit_rel": max(own["dinit_rel"], fnt["dinit_rel"]),
                         "rows": [max(a, b) for a, b in zip(own["rows"], fnt["rows"])]}
    big_grad_case = cg  # timed with the kernels
    del g9_b, g9_g, tgt_b, wm_b, cg
    phase("kernels vs plain: K5")
    chunk = BIG_N // 2  # the first of two passes
    scatter_cases = {
        "ga_exact": scatter_case(GA_P, BIG_N, GA_SIDE, 64, "exact-tight", chunk=chunk, seed=30),
        "ga_fast": scatter_case(GA_P, BIG_N, GA_SIDE, 64, "fast", 2e-3, chunk=chunk, seed=30),
        "c4k_exact": scatter_case(1, C4K_N, C4K_SIDE, 64, "highest", chunk=C4K_N // 7,
                                  scales=C4K_SCALES, seed=31),
        "c4k_fast": scatter_case(1, C4K_N, C4K_SIDE, 64, "fast", C4K_EPS, chunk=C4K_N // 7,
                                 scales=C4K_SCALES, seed=31),
        "grad_1024": scatter_case(1, BIG_N, BIG_SIDE, rg.GRAD_TILE_H, "exact-tight", chunk=chunk,
                                  seed=32, pad_slots=rg.GRAD_SCATTER_PAD),
        "c4k_overflow": scatter_case(1, C4K_N, C4K_SIDE, 64, "fast", C4K_EPS, chunk=C4K_N // 7,
                                     scales=C4K_SCALES, seed=33, coincident=300),
    }
    # the exact lists the main paths bin with K5 below 256 tiles: run_ga's
    # 512x512 (32 tiles of 64x128) at P=32 and 512, run_grad's (128 tiles of
    # 16x128), the flagship's first pass (B=1024, 128 tiles) and the fast
    # tier's eps-tight boxes without the corner cull (dead boxes x1 = -1)
    small_k5 = {
        "ga512_p32": scatter_case(32, 512, 512, 64, "exact-tight", seed=35),
        "ga512_p512": scatter_case(512, 512, 512, 64, "exact-tight", seed=36),
        "grad_512": scatter_case(1, 2000, 512, rg.GRAD_TILE_H, "exact-tight", seed=37,
                                 pad_slots=rg.GRAD_SCATTER_PAD),
        "flagship_pass": scatter_case(FLAG_CHUNK, FLAG_N, FLAG_SIDE, 64, "exact-tight",
                                      chunk=FLAG_N // 2, seed=38),
        # eps 0.8 empties about a third of a fresh population's boxes (alphas from 0.71)
        "ga512_fast_no_cull": scatter_case(32, 512, 512, 64, "fast", 0.8, seed=39, cull=False),
    }
    for k, sc in small_k5.items():
        a, n = sc["args"], sc["p"].x0.shape
        check(rc.bin_route(n[0], a["n_tx"], a["n_ty"], a["cap"], n[1], sc["pad_slots"], None,
                           "cuda") == "k5", f"{k}: bin_splats does not take K5 here")
    dead = int((small_k5["ga512_fast_no_cull"]["p"].x1 < 0).sum())
    print(f"CHECK K5 ga512_fast_no_cull: {dead} dead boxes (x1 = -1)", flush=True)
    check(dead > 0, "the fast tier's boxes without the corner cull hold no dead box")
    scatter_errs = {k: compare_scatter(sc, k, dense=sc["corner"] is None)
                    for k, sc in {**scatter_cases, **small_k5}.items()}
    del small_k5
    # the fallback forced, and absent (at the GA's first pass a tile may hold
    # more than cap_s = 703 splats: JAX's rule then takes the per-tile lists)
    check(scatter_errs["c4k_overflow"]["overflow"], "the coincident splats did not overflow cap_s")
    check(not scatter_errs["c4k_fast"]["overflow"], "canvas-4k's band lists overflowed")


    # 4. the main paths, each driven with every launch count set to 0 just
    # before and read just after
    def drive(label, runner, out, argv):
        phase(f"main path: {label}")
        reset_kernel_counts()
        t0 = time.perf_counter()
        res = runner.main(["--image", "synthetic", *argv, "--output-dir",
                           os.path.join(HERE, "output", out), "--device", "cuda"])
        torch.cuda.synchronize()
        return res, read_kernel_counts(), time.perf_counter() - t0

    def ga_path(label, tag, out, gens, argv, monotone=False):
        res, counts, wall = drive(label, run_ga, out, [
            "--generations", str(gens), "--log-every", str(min(50, gens // 2)), "--no-video",
            *argv])
        best = res["curves"]["best"]
        print(f"MAIN PATH {tag}".rstrip() + " " + json.dumps({
            "generations": gens, "seconds": wall, "best_first": best[0], "best_last": best[-1],
            "exact_rescore": res["best_fit"], "launches": counts,
        }), flush=True)
        check(len(best) == gens + 1, f"{label}: curve length")
        check(best[-1] < best[0], f"{label}: the best did not fall ({best[0]} -> {best[-1]})")
        check(math.isfinite(res["best_fit"]) and res["best_fit"] > 0, f"{label}: rescored fitness")
        if monotone:
            check(all(b1 <= b0 + 1e-9 for b0, b1 in zip(best, best[1:])),
                  f"{label}: the best is not monotone")
        return res, counts

    def grad_path(label, tag, out, argv):
        res, counts, wall = drive(label, run_grad, out,
                                  ["--steps", str(GRAD_STEPS), "--log-every", "50", *argv])
        curve = res["curve"]
        print(f"MAIN PATH {tag} " + json.dumps({
            "steps": GRAD_STEPS, "seconds": wall, "loss_first": curve[0], "loss_last": curve[-1],
            "highest_rescore": res["best_loss"], "launches": counts,
        }), flush=True)
        check(len(curve) == GRAD_STEPS, f"{label}: curve length")
        check(curve[-1] < curve[0], f"{label}: the loss did not fall ({curve[0]} -> {curve[-1]})")
        check(math.isfinite(res["best_loss"]) and res["best_loss"] > 0, f"{label}: rescored loss")
        check(tuple(res["final"].shape) == (512, 512, 3) and bool(torch.isfinite(res["final"]).all()),
              f"{label}: export render")
        check(counts["K7"] >= GRAD_STEPS, f"{label}: K7 launched {counts['K7']} times")
        check(counts["K2"] >= 1, f"{label}: K2 was not launched by the rescore and export")
        return counts

    res, launches = ga_path("run_ga", "", "chip_smoke", GENERATIONS, [])
    final = res["final"]
    check(tuple(final.shape) == (512, 512, 3) and bool(torch.isfinite(final).all())
          and float(final.min()) >= 0.0 and float(final.max()) <= 1.0, "final render")
    check(launches["K1"] >= GENERATIONS, f"K1 launched {launches['K1']} times")
    check(launches["K2"] >= 1, "K2 was not launched by the export render")

    grad_launches = grad_path("run_grad", "run_grad", "chip_smoke_grad", [])

    # the unfused gradient at run_grad's shape: autograd through make_loss_fn
    phase("main path: unfused gradient")
    H = W = 512
    tgt = io.ensure_hw(io.synthetic_target(H, W), H, W, device="cuda")
    wm = mask.mask_from_config(tgt, H, W, MaskConfig())
    obj_grad = objective.Objective(H=H, W=W, precision="exact-tight")
    gnm_grad = GenomeConfig(n_splats=2000)
    loss_fn = gradient.make_loss_fn(obj_grad, gnm_grad)
    g_un = genome.new_population(torch.Generator(device="cuda").manual_seed(12), 1, 2000, H, W,
                                 device="cuda")
    opt = gradient.make_adam(g_un, GradConfig())
    reset_kernel_counts()
    losses = []
    for _ in range(UNFUSED_STEPS):
        gq = g_un.detach().requires_grad_(True)
        loss, _ = loss_fn(gq, tgt, wm)
        (g_un.grad,) = torch.autograd.grad(loss, gq)
        opt.step()
        with torch.no_grad():
            g_un.copy_(codec.clamp_genome(g_un, H, W, gnm_grad.min_scale, gnm_grad.max_scale))
        losses.append(loss.item())
    unfused_launches = read_kernel_counts()
    (fused_loss, _), _ = rg.fused_value_and_grad(g_un, tgt, wm, H, W, box="tight")
    loss_last, _ = loss_fn(g_un, tgt, wm)
    fused_rel = abs(float(fused_loss) - float(loss_last)) / float(loss_last)
    print("MAIN PATH unfused " + json.dumps({
        "steps": UNFUSED_STEPS, "loss_first": losses[0], "loss_last": losses[-1],
        "fused_vs_unfused_loss_rel": fused_rel, "launches": unfused_launches,
    }), flush=True)
    check(losses[-1] < losses[0], "the unfused Adam loss did not fall")
    check(fused_rel <= FITNESS_RTOL, f"fused and unfused losses differ by {fused_rel}")
    check(unfused_launches["K6"] == UNFUSED_STEPS and unfused_launches["K2"] >= UNFUSED_STEPS,
          f"unfused launches {unfused_launches}")

    corner_grad = check_corner_grad_entry_points(tgt, wm)

    memetic = ["--memetic-every", str(MEMETIC_EVERY), "--memetic-steps", str(MEMETIC_STEPS)]
    _, memetic_launches = ga_path("memetic run_ga", "memetic", "chip_smoke_memetic",
                                  MEMETIC_GENS, memetic, monotone=True)
    want_k7 = (MEMETIC_GENS // MEMETIC_EVERY) * MEMETIC_STEPS
    check(memetic_launches["K7"] == want_k7,
          f"K7 launched {memetic_launches['K7']} times in the memetic run, not {want_k7}")
    check(memetic_launches["K1"] >= MEMETIC_GENS, "K1 launched less than once a generation")

    # the fast tier's main paths: run_ga and run_grad under --precision fast,
    # the memetic GA over eps-culled lists, and run_ga under bf16
    _, fast_launches = ga_path("run_ga --precision fast", "fast", "chip_smoke_fast",
                               FAST_GENS, ["--precision", "fast"])
    check(fast_launches["K4"] >= FAST_GENS and fast_launches["K3"] >= FAST_GENS,
          f"fast launches {fast_launches}")
    check(fast_launches["K1"] == 1 and fast_launches["K2"] >= 1,
          f"K1 must launch once (the exact rescore), K2 for the export: {fast_launches}")

    _, fm_launches = ga_path(
        "memetic run_ga --precision fast --cull-eps 8e-2", "fast memetic",
        "chip_smoke_fast_memetic", FAST_MEMETIC_GENS,
        ["--precision", "fast", "--cull-eps", "8e-2", *memetic], monotone=True,
    )
    want_k7 = (FAST_MEMETIC_GENS // MEMETIC_EVERY) * MEMETIC_STEPS
    check(fm_launches["K7"] == want_k7, f"K7 launched {fm_launches['K7']} times, not {want_k7}")
    check(fm_launches["K3"] >= FAST_MEMETIC_GENS and fm_launches["K4"] >= FAST_MEMETIC_GENS,
          f"fast memetic launches {fm_launches}")

    grad_path("run_grad --precision fast", "run_grad fast", "chip_smoke_fast_grad",
              ["--precision", "fast"])

    _, bf16_launches = ga_path("run_ga --precision bf16", "bf16", "chip_smoke_bf16", BF16_GENS,
                                  ["--precision", "bf16"])
    check(bf16_launches["K1-bf16"] >= BF16_GENS, f"bf16 launches {bf16_launches}")

    # the SA slice: SA, PT and the SSIM metrics through run_sa, run_grad, run_ga
    sa_out = sa_paths(drive, ga_path, tgt)
    # the pipeline slice: run_pipeline, annealing and staged growth
    pipe_out = pipeline_paths(drive)
    # the checkpoint / island / profile slice: islands, resume, the trace
    slice_out = slice_paths(drive, ga_path)

    # the large-canvas main paths: chained passes, K5 from 256 tiles
    phase("chained equals one pass")
    gen = torch.Generator(device="cuda").manual_seed(34)
    g_big = genome.new_population(gen, BIG_B, BIG_N, BIG_SIDE, BIG_SIDE, device="cuda")
    g9_big = codec.genome_to_renderer(g_big)
    tgt_big = io.ensure_hw(io.synthetic_target(BIG_SIDE, BIG_SIDE), BIG_SIDE, BIG_SIDE,
                           device="cuda")
    # the random population's second pass hides the first wherever the
    # transmittance through its hundreds of layers rounds to 0; with every
    # alpha / 32 ("faint") the first pass shows through, so a chain that
    # dropped its init canvas would differ from one pass there
    g9_faint = g9_big.clone()
    g9_faint[..., 8] *= 1.0 / 32  # the renderer genome's alpha, 0..255
    for pop, g9c in (("random", g9_big), ("faint", g9_faint)):
        for precision in ("highest", "exact-tight"):
            reset_kernel_counts()
            img_c = rc.render(g9c[:1], BIG_SIDE, BIG_SIDE, precision=precision)
            fit_c = rc.fitness(g9c, tgt_big, None, BIG_SIDE, BIG_SIDE, precision=precision)
            torch.cuda.synchronize()
            chained_counts = read_kernel_counts()
            pass_size, rc.MAX_SPLATS = rc.MAX_SPLATS, BIG_N  # one pass
            img_1 = rc.render(g9c[:1], BIG_SIDE, BIG_SIDE, precision=precision)
            fit_1 = rc.fitness(g9c, tgt_big, None, BIG_SIDE, BIG_SIDE, precision=precision)
            rc.MAX_SPLATS = pass_size
            same = torch.equal(img_c, img_1) and torch.equal(fit_c, fit_1)
            # the first pass's share of the canvas: against the last pass alone
            shows = float((img_c - rc.render(g9c[:1, BIG_N // 2:], BIG_SIDE, BIG_SIDE,
                                             precision=precision)).abs().max())
            print(f"CHECK chained (2 passes) vs one pass, N={BIG_N} {BIG_SIDE}x{BIG_SIDE} {pop} "
                  f"{precision}: canvas and fitness bit-equal {same}; max abs canvas "
                  f"{float((img_c - img_1).abs().max()):.3e}, fitness "
                  f"{fmt((fit_c - fit_1).tolist())}; the first pass moves the canvas by up to "
                  f"{shows:.3e}; chained launches {chained_counts}", flush=True)
            check(same, f"{pop} {precision}: the chained render differs from one pass")
            check(chained_counts["K2-init"] == 1 and chained_counts["K1-init"] == 1,
                  f"the chain did not walk from an init canvas: {chained_counts}")
            check(pop == "random" or shows > 1e-2, f"faint {precision}: the first pass is hidden")
    del g9_faint

    res, big_grad_launches, wall = drive(
        f"run_grad {BIG_SIDE}x{BIG_SIDE} N={BIG_N} (grad-10k-1024)", run_grad,
        "chip_smoke_grad_10k",
        ["--image", f"synthetic:{BIG_SIDE}x{BIG_SIDE}", "--work-max-side", str(BIG_SIDE),
         "--n-splats", str(BIG_N), "--steps", str(BIG_GRAD_STEPS), "--log-every", "10"],
    )
    curve = res["curve"]
    print("MAIN PATH run_grad 10k " + json.dumps({
        "steps": BIG_GRAD_STEPS, "seconds": wall, "loss_first": curve[0], "loss_last": curve[-1],
        "highest_rescore": res["best_loss"], "launches": big_grad_launches,
    }), flush=True)
    want = 2 * BIG_GRAD_STEPS  # two passes a step
    check(len(curve) == BIG_GRAD_STEPS and curve[-1] < curve[0],
          f"run_grad big: the loss did not fall ({curve[0]} -> {curve[-1]})")
    check(tuple(res["final"].shape) == (BIG_SIDE, BIG_SIDE, 3)
          and bool(torch.isfinite(res["final"]).all()), "run_grad big: export render")
    check(big_grad_launches["K5"] >= want and big_grad_launches["K2"] >= want
          and big_grad_launches["K6"] == want and big_grad_launches["K2-init"] >= want // 2
          and big_grad_launches["K6-init"] == want // 2 and big_grad_launches["K7"] == 0
          and big_grad_launches["K6-queue"] == want,  # 2,048 items a pass, past the blocks
          f"run_grad big launches {big_grad_launches}")

    ga_big = ["--image", f"synthetic:{GA_SIDE}x{GA_SIDE}", "--work-max-side", str(GA_SIDE),
              "--n-splats", str(BIG_N), "--pop-size", str(GA_P)]
    _, ga_big_launches = ga_path(f"run_ga {GA_SIDE}x{GA_SIDE} N={BIG_N} P={GA_P}", "ga 2048",
                                 "chip_smoke_ga_2048", BIG_GA_GENS, ga_big)
    check(ga_big_launches["K5"] >= 2 * BIG_GA_GENS and ga_big_launches["K1-init"] >= BIG_GA_GENS
          and ga_big_launches["K2"] >= BIG_GA_GENS and ga_big_launches["K5-fallback"] == 0,
          f"GA 2048 launches {ga_big_launches}")
    _, ga_big_fast_launches = ga_path(
        f"run_ga {GA_SIDE}x{GA_SIDE} N={BIG_N} P={GA_P} --precision fast", "ga 2048 fast",
        "chip_smoke_ga_2048_fast", BIG_GA_GENS, [*ga_big, "--precision", "fast"],
    )
    check(ga_big_fast_launches["K5"] >= 2 * BIG_GA_GENS
          and ga_big_fast_launches["K3-init"] >= BIG_GA_GENS
          and ga_big_fast_launches["K3-canvas"] >= BIG_GA_GENS and ga_big_fast_launches["K4"] == 0
          # the fallback launches with each of the fast fitness's two passes
          # (not with the exact rescore's and the export's K5 calls)
          and ga_big_fast_launches["K5-fallback"] == 2 * ga_big_fast_launches["K3"],
          f"fast GA 2048 launches {ga_big_fast_launches}")

    phase(f"main path: canvas-4k render (N={C4K_N}, {C4K_SIDE}x{C4K_SIDE})")
    gen = torch.Generator(device="cuda").manual_seed(35)
    g9_4k = codec.genome_to_renderer(
        genome.new_population(gen, 1, C4K_N, C4K_SIDE, C4K_SIDE, *C4K_SCALES, device="cuda"))
    c4k_tiers = {"exact": dict(precision="highest"),
                 "fast": dict(precision="fast", cull_eps=C4K_EPS),
                 "fast+corner": dict(precision="fast", cull_eps=C4K_EPS, corner_cull=True)}
    c4k_imgs, c4k_launches = {}, {}
    n_pass = -(-C4K_N // rc.MAX_SPLATS)
    for tier, kw in c4k_tiers.items():
        reset_kernel_counts()
        # no per-band host loop: the plain route's band helpers never run here
        with count_calls(rc, "_corner_band_xranges") as xr, count_calls(rc, "_band_lists") as bl:
            img = rc.render(g9_4k, C4K_SIDE, C4K_SIDE, **kw)
            torch.cuda.synchronize()
        c4k_launches[tier] = counts = read_kernel_counts()
        counts["band_helper_calls"] = sum(xr.values()) + sum(bl.values())
        walk = "K3-canvas" if tier != "exact" else "K2"
        check(tuple(img.shape) == (1, C4K_SIDE, C4K_SIDE, 3) and bool(torch.isfinite(img).all())
              and float(img.min()) >= 0.0 and float(img.max()) <= 1.0, f"canvas-4k {tier} render")
        check(counts["K5"] == n_pass and counts["K5-band"] == n_pass and counts[walk] == n_pass
              and counts[f"{walk}-init"] == n_pass - 1, f"canvas-4k {tier} launches {counts}")
        k5 = counts["K5"] + counts["K5-band"] + counts["K5-fallback"]
        check(k5 <= C4K_K5_LAUNCHES_PER_PASS * n_pass and counts["band_helper_calls"] == 0,
              f"canvas-4k {tier}: K5 launched {k5} kernels in {n_pass} passes (at most "
              f"{C4K_K5_LAUNCHES_PER_PASS} a pass), the band helpers ran "
              f"{counts['band_helper_calls']} times (none on the card)")
        c4k_imgs[tier] = img
    corner_gap = float((c4k_imgs["fast+corner"] - c4k_imgs["fast"]).abs().max())
    fast_gap = float((c4k_imgs["fast"] - c4k_imgs["exact"]).abs().max())
    print("MAIN PATH canvas-4k " + json.dumps({
        "passes": n_pass, "launches": c4k_launches, "fast_corner_vs_fast_max_abs": corner_gap,
        "fast_vs_exact_max_abs": fast_gap,
    }), flush=True)
    # the JAX suite's bound for the band cull (test_render_pallas.py:679)
    check(corner_gap <= 1.5 * C4K_EPS, f"canvas-4k: the band cull moved the canvas by {corner_gap}")
    del c4k_imgs

    phase(f"main path: bf16 fitness, B={BIG_B} N={BIG_N} {BIG_SIDE}x{BIG_SIDE} (big-10k-1024)")
    reset_kernel_counts()
    f_bf16 = rc.fitness(g9_big, tgt_big, None, BIG_SIDE, BIG_SIDE, precision="bf16")
    torch.cuda.synchronize()
    bf16_big_launches = read_kernel_counts()
    f_high = rc.fitness(g9_big, tgt_big, None, BIG_SIDE, BIG_SIDE, precision="highest")
    bf16_gap = rel_err(f_bf16, f_high)
    print("MAIN PATH bf16 10k " + json.dumps({
        "fitness_bf16": f_bf16.tolist(), "fitness_highest": f_high.tolist(), "max_rel": bf16_gap,
        "launches": bf16_big_launches,
    }), flush=True)
    check(bf16_big_launches["K2"] == 1 and bf16_big_launches["K2-init"] == 0
          and bf16_big_launches["K1-bf16"] == 1 and bf16_big_launches["K1-bf16-init"] == 1,
          f"bf16 10k launches {bf16_big_launches}")
    # tests/test_torch_fast.py's bounds: within 2e-2 of "highest", and the
    # bf16 roundings must show
    check(BF16_MIN_GAP < bf16_gap <= 2e-2, f"bf16 10k fitness vs highest: {bf16_gap}")

    # selection fidelity of fast scoring (benchmarks/eps_sweep.py)
    phase("selection fidelity")
    H = W = 512
    fid_tgt = torch.rand((H, W, 3), generator=torch.Generator(device="cuda").manual_seed(1),
                         device="cuda")
    fidelity = selection_fidelity(fid_tgt, mask.compute_importance_mask(fid_tgt, H, W, smooth=3,
                                                                        strength=0.7))

    # 5. times
    phase("times")
    c32 = main_case["exact-tight"]
    c512 = make_case(512, 512, 512, 512, "exact-tight", seed=2)
    c1 = make_case(1, 512, 512, 512, "exact-tight", seed=3)
    t = {
        "K1_B32": cuda_ms(lambda: run_k1(c32), 50),
        "K1_B512": cuda_ms(lambda: run_k1(c512), 10),
        "K2_B1": cuda_ms(lambda: run_k2(c1), 100),
        "K2_B32": cuda_ms(lambda: run_k2(c32), 50),
        "K1_plain_B32": cuda_ms(lambda: run_k1_plain(c32), 3, warmup=1),
        "K1_plain_B512": cuda_ms(lambda: run_k1_plain(c512), 1, warmup=1),
        "K2_plain_B1": cuda_ms(lambda: run_k2_plain(c1), 5, warmup=1),
        "K2_plain_B32": cuda_ms(lambda: run_k2_plain(c32), 3, warmup=1),
    }
    # K2' (RenderDiff's forward) on run_grad's 16x128 lists
    c2p = dict(grad_cases["B1_N2000"], feats=grad_cases["B1_N2000"]["feats_fast"])
    t["K2p_B1_N2000"] = cuda_ms(lambda: run_k2(c2p), 100)
    t["K2p_plain_B1_N2000"] = cuda_ms(lambda: run_k2_plain(c2p), 3, warmup=1)
    for k, c in grad_cases.items():
        reps = 20 if k == "B1_N2000" else 10
        t[f"K7_{k}"] = cuda_ms(lambda: run_k7(c), reps)
        t[f"K6_{k}"] = cuda_ms(lambda: run_k6(c), reps)
        t[f"K7_plain_{k}"] = cuda_ms(lambda: run_k7(c, plain=True), 1, warmup=1)
        t[f"K6_plain_{k}"] = cuda_ms(lambda: run_k6(c, plain=True), 1, warmup=1)
    bounds = {
        "K1_B32": bound(c32, "K1"), "K1_B512": bound(c512, "K1"),
        "K2_B1": bound(c1, "K2"), "K2_B32": bound(c32, "K2"),
    }
    bounds["K2p_B1_N2000"] = bound(c2p, "K2")
    for k, c in grad_cases.items():
        bounds[f"K7_{k}"] = bound(c, "K7")
        bounds[f"K6_{k}"] = bound(c, "K6")
    # K6/K7 on each list tile height (the same genomes), and K6 with d(init)
    # at grad-10k-1024's last chained pass
    for th, c in tile_cases.items():
        t[f"K7_B1_N2000_th{th}"] = cuda_ms(lambda: run_k7(c), 20)
        t[f"K6_B1_N2000_th{th}"] = cuda_ms(lambda: run_k6(c), 20)
    bg_args = tuple(big_grad_case[f] for f in ("cnt", "idx", "feats", "g_img", "n_tx", "tile_h",
                                                "tile_w"))
    t["K6_grad_10k_1024_init"] = cuda_ms(
        lambda: rg.bwd_tiles(*bg_args, BG, init=big_grad_case["init"]), 10)
    bounds["K6_grad_10k_1024_init"] = bound(big_grad_case, "K6")
    # K2' (RenderDiff's forward) on the same pass, from the first pass's canvas
    k2p_big = dict(big_grad_case, feats=big_grad_case["feats_fast"])
    k2p_args = tuple(k2p_big[f] for f in ("cnt", "idx", "feats", "n_tx", "tile_h", "tile_w"))
    t["K2p_grad_10k_1024_init"] = cuda_ms(
        lambda: rc.render_tiles(*k2p_args, BG, init=k2p_big["init"]), 10)
    bounds["K2p_grad_10k_1024_init"] = bound(k2p_big, "K2")
    del c512, tile_cases

    phase("times: the fast tier")
    f32c = fast_cases[2e-3]  # the fast GA's shapes (eps 2e-3, corner cull)
    f512 = make_case(512, 512, 512, 512, "fast", seed=2, cull_eps=2e-3)
    f1 = make_case(1, 512, 512, 512, "fast", seed=3, cull_eps=2e-3)
    t.update({
        "K3_B32": cuda_ms(lambda: run_k3(f32c), 50),
        "K3_B512": cuda_ms(lambda: run_k3(f512), 10),
        "K3_canvas_B1": cuda_ms(lambda: run_k3_canvas(f1), 100),
        "K4_B32": cuda_ms(lambda: run_k4(f32c), 200),
        "K4_B512": cuda_ms(lambda: run_k4(f512), 200),
        "K4_device_B32": kernel_device_ms(lambda: run_k4(f32c), 50, "prep_fast_kernel"),
        "K4_device_B512": kernel_device_ms(lambda: run_k4(f512), 50, "prep_fast_kernel"),
        # the launch floor K4's device time is read against
        "empty_kernel_device": kernel_device_ms(
            lambda: kern.check(kern.lib.ggs_empty_launch(torch.cuda.current_stream().cuda_stream),
                               "empty kernel"), 200, "empty_kernel"),
        "K1_bf16_B32": cuda_ms(lambda: run_k1_bf16(bf16_case), 20),
        "K3_plain_B32": cuda_ms(lambda: run_k3(f32c, plain=True), 3, warmup=1),
        "K3_plain_B512": cuda_ms(lambda: run_k3(f512, plain=True), 1, warmup=1),
        "K3_canvas_plain_B1": cuda_ms(lambda: run_k3_canvas(f1, plain=True), 5, warmup=1),
        "K4_plain_B32": cuda_ms(lambda: run_k4(f32c, plain=True), 20),
        "K1_bf16_plain_B32": cuda_ms(lambda: run_k1_bf16(bf16_case, plain=True), 3, warmup=1),
        # K1 on the bf16 case's lists (the reference box): K1-bf16's f32 twin
        "K1_B32_reference_box": cuda_ms(lambda: run_k1(bf16_case), 50),
    })
    bounds.update({
        "K3_B32": bound(f32c, "K3"), "K3_B512": bound(f512, "K3"),
        "K3_canvas_B1": bound(f1, "K3-canvas"), "K4_B32": k4_bound(32, 512),
        "K4_B512": k4_bound(512, 512),
        "K1_bf16_B32": bound(bf16_case, "K1-bf16"),
    })
    fast_pairs = {"B32_eps2e-3": pair_counts(f32c), "B32_eps8e-2": pair_counts(fast_cases[8e-2]),
                  "B32_exact_tight": pair_counts(c32), "B32_reference_box": pair_counts(bf16_case)}
    del f512

    phase("times: renders/s, GA generations/s, Adam steps/s")
    # evaluate() end to end (codec, boxes, binning, K1) at bench.py's batch
    obj = objective.Objective(H=H, W=W, precision="exact-tight")
    gen = torch.Generator(device="cuda").manual_seed(5)
    pop512 = genome.new_population(gen, 512, 512, H, W, device="cuda")
    eval_ms = cuda_ms(lambda: objective.evaluate(obj, pop512, tgt, wm), 10)
    renders_per_s = 512 / (eval_ms / 1e3)
    obj_fast = objective.Objective(H=H, W=W, precision="fast")
    tier_renders_per_s = {}
    for name, o in (("fast_eps2e-3", obj_fast), ("fast_eps8e-2", obj_fast._replace(cull_eps=8e-2)),
                    ("bf16", objective.Objective(H=H, W=W, precision="bf16"))):
        ms = cuda_ms(lambda: objective.evaluate(o, pop512, tgt, wm), 10)
        tier_renders_per_s[name] = 512 / (ms / 1e3)
    del pop512

    # GA generations/s at the main path's configuration, host-timed per
    # block; exact-tight and fast blocks alternate (E F F E ...)
    cfg = GAConfig(pop_size=32, generations=500_000)
    gnm = GenomeConfig(n_splats=512)
    st = ga.init(torch.Generator(device="cuda").manual_seed(9), obj, tgt, wm, cfg, gnm)
    st, _ = ga.run_block(st, obj, tgt, wm, cfg, gnm, 20)
    st_fast = ga.init(torch.Generator(device="cuda").manual_seed(9), obj_fast, tgt, wm, cfg, gnm)
    st_fast, _ = ga.run_block(st_fast, obj_fast, tgt, wm, cfg, gnm, 20)
    torch.cuda.synchronize()
    block_rates, fast_block_rates = [], []
    for i in range(GA_BLOCKS):
        for tier in (("exact", "fast") if i % 2 == 0 else ("fast", "exact")):
            t0 = time.perf_counter()
            if tier == "exact":
                st, m = ga.run_block(st, obj, tgt, wm, cfg, gnm, GA_BLOCK_GENS)
            else:
                st_fast, m = ga.run_block(st_fast, obj_fast, tgt, wm, cfg, gnm, GA_BLOCK_GENS)
            m.cpu()
            torch.cuda.synchronize()
            rate = GA_BLOCK_GENS / (time.perf_counter() - t0)
            (block_rates if tier == "exact" else fast_block_rates).append(rate)
    gens_per_s = sorted(block_rates)[GA_BLOCKS // 2]
    fast_gens_per_s = sorted(fast_block_rates)[GA_BLOCKS // 2]

    # Adam steps/s: run_grad's defaults, and bench.py's gradient configuration
    # (B=1, N=2000, 512x512, precision "highest", no mask)
    adam_rate, adam_rates, adam_st, adam_step = adam_steps_per_s(obj_grad, tgt, wm, 2000, 13)
    bench_rate, bench_rates, _, _ = adam_steps_per_s(
        objective.Objective(H=H, W=W), tgt, None, 2000, 14
    )
    check_no_sync(lambda: gradient.run_block(adam_st, adam_step, tgt, wm, ADAM_BLOCK_STEPS),
                  f"a {ADAM_BLOCK_STEPS}-step Adam block at run_grad's defaults")

    times = {
        "card": card,
        "walk_build": walk_build,
        "ms": t,
        "bound_ms": {k: v[0] for k, v in bounds.items()},
        "bound_by": {k: v[1] for k, v in bounds.items()},
        "evaluate_B512_exact_tight_ms": eval_ms,
        "renders_per_s_B512": renders_per_s,
        "ga_generations_per_s_P32_N512_512x512_exact_tight": gens_per_s,
        "ga_generations_per_s_blocks": block_rates,
        "ga_generations_per_s_P32_N512_512x512_fast": fast_gens_per_s,
        "ga_generations_per_s_fast_blocks": fast_block_rates,
        "renders_per_s_B512_fast_and_bf16": tier_renders_per_s,
        "pairs_fast_tier": fast_pairs,
        "adam_steps_per_s_run_grad_defaults": adam_rate,
        "adam_steps_per_s_run_grad_blocks": adam_rates,
        "adam_steps_per_s_bench_grad_config": bench_rate,
        "adam_steps_per_s_bench_blocks": bench_rates,
        "sum_cnt": {"B32": int(c32["cnt"].sum()), "B1": int(c1["cnt"].sum()),
                    **{f"grad_{k}": int(c["cnt"].sum()) for k, c in grad_cases.items()}},
        "grad_pairs": {k: pair_counts(c) for k, c in grad_cases.items()},
    }
    print("TIMES " + json.dumps(times), flush=True)

    phase("times: the large-canvas path")
    lt, lb = {}, {}
    for k in ("ga_exact", "ga_fast", "c4k_exact", "c4k_fast", "grad_1024"):
        sc = scatter_cases[k]
        args, p, corner = sc["args"], sc["p"], sc["corner"]
        geo = (args["n_tx"], args["n_ty"], args["tile_h"], args["tile_w"], args["cap"])
        # K5 is the whole route from the boxes; its plain route is
        # scatter_args then bin_splats_scatter_plain
        lt[f"K5_{k}"] = cuda_ms(lambda: run_k5(sc), 20)
        lt[f"K5_device_{k}"] = kernel_device_ms(lambda: run_k5(sc), 5, "ggs_scatter")
        lt[f"K5_plain_{k}"] = cuda_ms(lambda: rc.bin_splats_scatter_plain(**rc.scatter_args(
            p.x0, p.x1, p.y0, p.y1, *geo, sc["pad_slots"], corner=corner)), 2, warmup=1)
        if k in ("ga_exact", "ga_fast", "c4k_exact"):  # the dense sort K5 replaces
            lt[f"dense_{k}"] = cuda_ms(
                lambda: rc.bin_splats_dense(p.x0, p.x1, p.y0, p.y1, *geo, corner=corner), 3,
                warmup=1)
        lb[f"K5_{k}"] = scatter_bound(p.x0, p.x1, p.y0, p.y1, *geo, args["rpg"],
                                      corner if args["cxr"] is not None else None,
                                      scatter_errs[k]["overflow"])
    obj_big = {pr: objective.Objective(H=BIG_SIDE, W=BIG_SIDE, precision=pr)
               for pr in ("highest", "exact-tight")}
    big_renders_per_s = {
        pr: BIG_B / (cuda_ms(lambda: objective.evaluate(o, g_big, tgt_big, None), 5) / 1e3)
        for pr, o in obj_big.items()
    }
    c4k_renders_per_s = {
        tier: 1e3 / cuda_ms(lambda: rc.render(g9_4k, C4K_SIDE, C4K_SIDE, **kw), 3, warmup=1)
        for tier, kw in c4k_tiers.items()
    }
    prof_c4k = {
        tier: profile_split(lambda: rc.render(g9_4k, C4K_SIDE, C4K_SIDE, **c4k_tiers[tier]), 1,
                            walk="render_kernel")
        for tier in c4k_tiers
    }
    del g9_4k
    # torch.profiler's kernel counts a render are printed with the PROFILE
    # lines, not checked: they were seen unsteady (PERF.md §7); the launch
    # gate is the exact counts of the canvas-4k main path above
    big_adam, big_adam_rates, big_st, big_step = adam_steps_per_s(obj_big["highest"], tgt_big,
                                                                  None, BIG_N, 36)
    check_no_sync(lambda: gradient.run_block(big_st, big_step, tgt_big, None, 1),
                  f"one chained Adam step at grad-10k-1024 (N={BIG_N}, two passes)")
    prof_big_adam = profile_split(
        lambda: gradient.run_block(big_st, big_step, tgt_big, None, 5)[1].cpu(), 5,
        walk="grad_kernel")
    times_large = {
        "card": card,
        "ms": lt,
        "bound_ms": {k: v[0] for k, v in lb.items()},
        "bound_by": {k: v[1] for k, v in lb.items()},
        "scatter_pairs": {k: e["pairs"] for k, e in scatter_errs.items()},
        "renders_per_s_big_10k_1024_B4": big_renders_per_s,
        "full_canvas_renders_per_s_canvas_4k": c4k_renders_per_s,
        "adam_steps_per_s_grad_10k_1024": big_adam,
        "adam_steps_per_s_grad_10k_1024_blocks": big_adam_rates,
    }
    print("TIMES LARGE " + json.dumps(times_large), flush=True)
    for tier, prof in prof_c4k.items():
        print(f"PROFILE canvas-4k {tier} " + json.dumps(prof), flush=True)
    print("PROFILE ADAM grad-10k-1024 " + json.dumps(prof_big_adam), flush=True)
    grad_keys = ["K7_B1_N2000", "K6_B1_N2000", "K7_B8_N512", "K6_B8_N512",
                 "K6_grad_10k_1024_init"]
    grad_keys += [f"K{k}_B1_N2000_th{th}" for th in rg.GRAD_TILE_HS for k in (7, 6)]
    print("GRAD KERNELS " + json.dumps({
        "card": card,
        "blocks_per_sm": {"K6": kern.grad.ggs_grad_blocks_per_sm(0),
                          "K7": kern.grad.ggs_grad_blocks_per_sm(1)},
        "ms": {k: t[k] for k in grad_keys},
        "bound_ms": {k: bounds[k][0] for k in grad_keys if k in bounds},
        "launches": {"K7_run_grad": grad_launches["K7"],
                     "K6_grad_10k_1024": big_grad_launches["K6"],
                     "K6_grad_10k_1024_init": big_grad_launches["K6-init"]},
        "adam_steps_per_s_run_grad_defaults": adam_rate,
        "adam_steps_per_s_grad_10k_1024": big_adam,
        "corner_culled_entry_points": corner_grad,
    }), flush=True)

    # 6. profile
    phase("profile")
    prof = profile_split(lambda: ga.run_block(st, obj, tgt, wm, cfg, gnm, 20)[1].cpu(), 20)
    print("PROFILE GA " + json.dumps(prof), flush=True)
    prof_fast = profile_split(
        lambda: ga.run_block(st_fast, obj_fast, tgt, wm, cfg, gnm, 20)[1].cpu(), 20
    )
    print("PROFILE GA fast " + json.dumps(prof_fast), flush=True)
    prof_adam = profile_split(
        lambda: gradient.run_block(adam_st, adam_step, tgt, wm, 20)[1].cpu(), 20,
        walk="grad_kernel",
    )
    print("PROFILE ADAM " + json.dumps(prof_adam), flush=True)
    # device launches a generation and a step may not rise above the
    # parent's counts for the same code path: counted exactly, as the nodes
    # of each block captured in a CUDA graph (from states of their own); the
    # profiler's counts, which can lose records, are printed beside them
    st_x, st_xf = (ga.init(torch.Generator(device="cuda").manual_seed(90), o, tgt, wm, cfg, gnm)
                   for o in (obj, obj_fast))
    make_opt, adam_x_step = gradient.make_fit_step(obj_grad, GenomeConfig(n_splats=2000),
                                                   GradConfig(lr=1e-2))
    adam_x = gradient.init_state(make_opt, genome.new_population(
        torch.Generator(device="cuda").manual_seed(91), 1, 2000, H, W, device="cuda"))
    exact_launches = {
        "ga_exact_tight": graph_launches(
            lambda: ga.run_block(st_x, obj, tgt, wm, cfg, gnm, 20), 20, generators=[st_x.rng]),
        "ga_fast": graph_launches(
            lambda: ga.run_block(st_xf, obj_fast, tgt, wm, cfg, gnm, 20), 20,
            generators=[st_xf.rng]),
        "adam": graph_launches(lambda: gradient.run_block(adam_x, adam_x_step, tgt, wm, 20), 20,
                               optimizers=[adam_x.opt]),
    }
    launch_rates = {}
    for key, p in (("ga_exact_tight", prof), ("ga_fast", prof_fast), ("adam", prof_adam)):
        x = exact_launches[key]
        launch_rates[key] = {"exact": x["per_step"], "profiler": p["kernels_per_step"],
                             "graph_nodes": x["nodes"]}
        limit = LAUNCH_LIMITS[key]
        check(round(x["per_step"] * x["steps"]) <= round(limit * x["steps"]),
              f"{key}: {x['per_step']} launches a step, above {limit}")
    print("LAUNCHES per GA generation / Adam step " + json.dumps(
        {"measured": launch_rates, "limit": LAUNCH_LIMITS}), flush=True)

    rbg_out = run_block_graphs(tgt, wm, card)
    slice_checks_and_times(tgt, wm, card)
    pipe_times = pipeline_checks_and_times(tgt, wm, card)
    pipe_times["pipeline_seconds"] = pipe_out["pipeline_seconds"]
    sa_checks_and_times(tgt, wm, card)
    slab_out = slab_checks()
    shard_out = shard_checks_and_times(card)
    flagship_out = flagship_checks_and_times(card)

    kernels = [
        {
            "name": "K1 fitness_tiles (fused walk + weighted SSE partials)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/walk.cu",
            "replaces": "ggs_tpu/ops/render_pallas.py:1460",
            "launches": launches["K1"],
            "max_abs_err": errs["exact-tight"]["partials"],
            "ms": t["K1_B32"],
            "plain_ms": t["K1_plain_B32"],
            "bound_ms": bounds["K1_B32"][0],
            "bound_by": bounds["K1_B32"][1],
            "library_ms": None,
            "note": "takes an init canvas on the last pass above 8000 splats "
                    f"({ga_big_launches['K1-init']} init launches in the 2048x2048 GA; there, "
                    "on its 2nd pass, fitness max rel "
                    f"{init_errs['ga_exact']['fitness_rel']} and K2 canvas max abs "
                    f"{init_errs['ga_exact']['canvas']} against plain)",
        },
        {
            "name": "K2 render_tiles (walk + clamped canvas)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/walk.cu",
            "replaces": "ggs_tpu/ops/render_pallas.py:118",
            "launches": launches["K2"],
            "max_abs_err": errs["exact-tight"]["canvas"],
            "ms": t["K2_B1"],
            "plain_ms": t["K2_plain_B1"],
            "bound_ms": bounds["K2_B1"][0],
            "bound_by": bounds["K2_B1"][1],
            "library_ms": None,
            "note": "K2' (the custom-VJP forward, render_grad.py:386) is this render_kernel, "
                    "launched from render_grad.RenderDiff; takes an init canvas on every pass "
                    f"but the first ({big_grad_launches['K2-init']} init launches in "
                    "run_grad at grad-10k-1024)",
            "K2p_run_grad": {
                "launches": unfused_launches["K2"],
                "ms": t["K2p_B1_N2000"],
                "plain_ms": t["K2p_plain_B1_N2000"],
                "bound_ms": bounds["K2p_B1_N2000"][0],
                "bound_by": bounds["K2p_B1_N2000"][1],
            },
            "K2p_grad_10k_1024": {
                "launches": big_grad_launches["K2"],
                "from_init": big_grad_launches["K2-init"],
                "ms": t["K2p_grad_10k_1024_init"],
                "bound_ms": bounds["K2p_grad_10k_1024_init"][0],
                "bound_by": bounds["K2p_grad_10k_1024_init"][1],
            },
        },
        {
            "name": "K3 fitness_tiles_fast / render_tiles_fast (exp2 fast-tier walk)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/walk.cu",
            "replaces": "ggs_tpu/ops/render_pallas.py:1460",
            "launches": fast_launches["K3"] + fast_launches["K3-canvas"],
            "max_abs_err": fast_errs[2e-3]["partials"],
            "ms": t["K3_B32"],
            "plain_ms": t["K3_plain_B32"],
            "bound_ms": bounds["K3_B32"][0],
            "bound_by": bounds["K3_B32"][1],
            "library_ms": None,
            "note": "turbo=True at both pallas_calls (render_pallas.py:1460 fitness, :118 "
                    "canvas); times are the fitness epilogue at B=32; init canvas launches in "
                    f"the fast 2048x2048 GA: {ga_big_fast_launches['K3-init']}; there, on its "
                    f"2nd pass, fitness max rel {init_errs['ga_fast']['fitness_rel']} and "
                    f"canvas max abs {init_errs['ga_fast']['canvas']} against plain",
        },
        {
            "name": "K4 prep_fast (genome -> fast table + eps-tight boxes)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/walk.cu",
            "replaces": "ggs_tpu/ops/render_pallas.py:334",
            "launches": fast_launches["K4"],
            "max_abs_err": fast_errs[2e-3]["k4_abs"],
            "ms": t["K4_B32"],
            "plain_ms": t["K4_plain_B32"],
            "bound_ms": bounds["K4_B32"][0],
            "bound_by": bounds["K4_B32"][1],
            "library_ms": None,
            "note": "ms by CUDA events includes the wrapper's host time; device_ms under "
                    "torch.profiler, beside an empty kernel's device time (the launch floor)",
            "device_ms": t["K4_device_B32"],
            "empty_kernel_device_ms": t["empty_kernel_device"],
            "B512": {"ms": t["K4_B512"], "device_ms": t["K4_device_B512"],
                     "bound_ms": bounds["K4_B512"][0], "bound_by": bounds["K4_B512"][1]},
        },
        {
            "name": "K1-bf16 fitness_tiles_bf16 (the walk in bf16)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/walk.cu",
            "replaces": "ggs_tpu/ops/render_pallas.py:1460",
            "launches": bf16_launches["K1-bf16"],
            "max_abs_err": bf16_err["partials"],
            "ms": t["K1_bf16_B32"],
            "plain_ms": t["K1_bf16_plain_B32"],
            "bound_ms": bounds["K1_bf16_B32"][0],
            "bound_by": bounds["K1_bf16_B32"][1],
            "library_ms": None,
            "note": "compute_dtype=bfloat16 at render_pallas.py:1460; from an init canvas "
                    f"at big-10k-1024 ({bf16_big_launches['K1-bf16-init']} launch; there, on its "
                    f"2nd pass, fitness max rel {init_errs['big_bf16']['fitness_rel']} against "
                    "plain); packed bf16x2, the card's add/sub/mul equal to the f32 result "
                    f"rounded on {bf16x2['mul']['pairs']} pairs each; K1 (f32) on the same "
                    f"lists: {t['K1_B32_reference_box']} ms",
        },
        {
            "name": "K5 bin_splats_scatter (pair-scatter binning from the boxes, >= 256 tiles)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/scatter.cu",
            "replaces": "ggs_tpu/ops/render_pallas.py:986",
            "launches": ga_big_launches["K5"],
            "max_abs_err": max(e["max_abs_err"] for e in scatter_errs.values()),
            "ms": lt["K5_ga_exact"],
            "plain_ms": lt["K5_plain_ga_exact"],
            "bound_ms": lb["K5_ga_exact"][0],
            "bound_by": lb["K5_ga_exact"][1],
            "library_ms": None,
            "note": f"the whole binning of a pass from the boxes (band stage, tile stage, and "
                    f"the overflow fallback where it applies); B={GA_P}, a {BIG_N // 2}-splat "
                    f"pass at {GA_SIDE}x{GA_SIDE}, 512 tiles, exact-tight; the dense sort it "
                    f"replaces there: {lt['dense_ga_exact']} ms; band stages in the GA: "
                    f"{ga_big_launches['K5-band']}; ga_fast: the same pass under the fast GA's "
                    "corner cull, where the batch overflows cap_s and the fallback rebuilds the "
                    "lists by the per-tile test",
            "device_ms": lt["K5_device_ga_exact"],
            **{k: {"launches": n, "ms": lt[f"K5_{k}"], "device_ms": lt[f"K5_device_{k}"],
                   "plain_ms": lt[f"K5_plain_{k}"], "bound_ms": lb[f"K5_{k}"][0],
                   "bound_by": lb[f"K5_{k}"][1], "overflow": scatter_errs[k]["overflow"]}
               for k, n in (("ga_fast", ga_big_fast_launches["K5"]),
                            ("c4k_exact", c4k_launches["exact"]["K5"]),
                            ("c4k_fast", c4k_launches["fast+corner"]["K5"]),
                            ("grad_1024", big_grad_launches["K5"]))},
            "ga_fast_fallbacks": ga_big_fast_launches["K5-fallback"],
        },
        {
            "name": "K6 bwd_tiles (backward walk, 9 gradients per splat)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/walk_grad.cu",
            "replaces": "ggs_tpu/ops/render_grad.py:436",
            "launches": unfused_launches["K6"],
            "max_abs_err": grad_errs["B1_N2000"]["K6"],
            "ms": t["K6_B1_N2000"],
            "plain_ms": t["K6_plain_B1_N2000"],
            "bound_ms": bounds["K6_B1_N2000"][0],
            "bound_by": bounds["K6_B1_N2000"][1],
            "library_ms": None,
            "note": "with an init canvas it also writes d(init) = g * T_total "
                    f"({big_grad_launches['K6-init']} init launches in run_grad at "
                    "grad-10k-1024; there, on its 2nd pass, d(init) max rel "
                    f"{big_grad_init_err['dinit_rel']} and gradient rows max rel "
                    f"{max(big_grad_init_err['rows'])} against plain)",
            "grad_10k_1024": {
                "launches": big_grad_launches["K6"],
                "from_init": big_grad_launches["K6-init"],
                "ms": t["K6_grad_10k_1024_init"],
                "bound_ms": bounds["K6_grad_10k_1024_init"][0],
                "bound_by": bounds["K6_grad_10k_1024_init"][1],
            },
        },
        {
            "name": "K7 lossgrad_tiles (forward walk + loss head + backward walk)",
            "route": "cuda",
            "source": "ggs_tpu_torch/csrc/walk_grad.cu",
            "replaces": "ggs_tpu/ops/render_grad.py:556",
            "launches": grad_launches["K7"],
            "max_abs_err": grad_errs["B1_N2000"]["K7"],
            "ms": t["K7_B1_N2000"],
            "plain_ms": t["K7_plain_B1_N2000"],
            "bound_ms": bounds["K7_B1_N2000"][0],
            "bound_by": bounds["K7_B1_N2000"][1],
            "library_ms": None,
        },
    ]
    # each kernel's launches on the SA slice's main paths, and against its
    # plain version from a row slab (K4 and K7 are on no slab path; K7's
    # error is its check beside K6's on the slab)
    slab_errs = {
        "K1": slab_out["K1_K2_exact-tight"]["partials"], "K2": slab_out["K2_top"]["canvas"],
        "K3": slab_out["K3"]["partials"], "K4": None,
        "K1-bf16": slab_out["K1-bf16"]["partials"],
        "K5": max(slab_out["K5_exact"]["max_abs_err"], slab_out["K5_fast"]["max_abs_err"]),
        "K6": slab_out["K6"]["K6"], "K7": slab_out["K6"]["K7"]}
    for entry in kernels:
        key = entry["name"].split()[0]
        entry["launches_sa_slice"] = {tag: c[key] for tag, c in sa_out["launches"].items()}
        entry["launches_pipeline_slice"] = {tag: c[key]
                                            for tag, c in pipe_out["launches"].items()}
        entry["launches_checkpoint_island_slice"] = {tag: c[key]
                                                     for tag, c in slice_out["launches"].items()}
        # rank 0's launches on the sharded paths (each rank launches the same)
        entry["launches_sharding_slice"] = {tag: c[key]
                                            for tag, c in shard_out["launches"].items()}
        entry["launches_flagship_slice"] = {tag: c[key]
                                            for tag, c in flagship_out["launches"].items()}
        # run_ga with frames, recycles and checkpoints, its blocks replayed
        # as CUDA graphs and run eagerly (the counts must be equal)
        entry["launches_run_block_graph_slice"] = {tag: c[key]
                                                   for tag, c in rbg_out["launches"].items()}
        entry["slab_max_abs_err"] = slab_errs[key]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--shard-worker":
        sys.exit(shard_worker(sys.argv[2:]))
    sys.exit(main())
