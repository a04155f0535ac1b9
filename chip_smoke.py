#!/usr/bin/env python3
"""Drive the PyTorch port's render and training paths once on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits nonzero without printing the final result line:

  1. Device: requires CUDA; prints the card's name and power limit
     (nvidia-smi) and turns TF32 off for matmuls and convolutions.
  2. Build: compiles the kernels under mojosplat_tpu_torch/csrc/ with nvcc
     for sm_90a (one nvcc per source, in parallel) and prints the build
     time and each kernel's registers and spills (the 45 probe
     instantiations of B9 summarised in one line).
  3. Golden: renders tests/golden/render_3dgs.npz's inputs on the "cuda"
     route and holds image and depth to the committed vectors
     (rtol 5e-5, atol 5e-6).
  4. Kernels: at the trained scene's own shapes (inputs from one "torch"
     route binning), each kernel against its plain PyTorch version on the
     card: B4 (on every capacity column) and B5 exactly equal; B1 within
     1e-5 on at least 99.99% of pixel-channels and within 5e-3 everywhere,
     and bit-equal with and without its backward residual; B2 (with a seeded
     output cotangent) within 1e-4 of each gradient row's scale on at least
     99.999% of values and within 1e-3 of it everywhere; B3 on the route's
     real sorted keys (the slot ids, dropped past each tile's count), B2's
     rows read through the sort's perm as the gather's adjoint calls it,
     bit-equal to its plain version on CPU copies of the sorted payload
     (index_add_ on the CPU adds in row order, as B3 does), also without
     perm. B2 and B3 must be bitwise equal across two runs. B1's row test:
     the kernel's count of skipped (warp, slot) pairs equal to the plain
     mirror's, no skipped pair that a pixel keeps (brute
     force), and the shares of pairs no pixel keeps; B1's and B2's ptxas
     lines and B2's launch shape (cluster, threads, blocks per SM). Times
     each with CUDA events (median of 20 runs after 3 warm-ups; 3 runs after
     1 for B2's plain version), the least time the card could take (bound:
     B1 and B2 need the per-pair work only on the walked pairs whose (warp,
     slot) pair the row test keeps, plus the row tests), and one PyTorch
     call computing the same function where there is one
     (library); B3, B4, B5 and the library calls of B3 and B4 also per call
     over 20 calls queued back to back (the device's time once the host's
     launch path overlaps it). B3's launch shape (threads, registers,
     shared and local bytes, blocks per SM), its time on the sorted payload
     without perm, and the whole gather adjoint's time at the step's shapes
     (the sort, B3, the zeroed pad rows; by autograd.grad).
  5. Render: the trained 1M-gaussian scene (assets/trained_scene_1m.npz)
     at 1920x1080 with bench.py's preset 6 budgets (tile_size 32,
     max_tile_span 4, 8x intersection capacity, tile_capacity 512,
     tight_cull), on the "cuda" route under no_grad. Checks a finite image,
     that B1, B4 and B5 were launched during that render and no backward
     kernel, residual or probe, and agreement with the "torch" route by the
     B1 rule; prints the drop counters, the median render time of 10 runs,
     pixels/s and peak device memory; and once the counters and time of
     the same render without tight_cull.
  6. Golden gradients: tests/test_golden.py's loss on the "cuda" route;
     every parameter's gradient against the committed vectors at
     rtol 5e-5 and atol 5e-6 x max|g|.
  7. Training: the same scene and budgets at 1920x1080, SH degree 3. The
     target is the "cuda"-route render of the scene; the raw parameters
     are perturbed by seeded numpy noise and take 10 train_steps with Adam.
     Checks a finite loss at every step and a lower loss after the last
     step than at the first, that all five kernels were launched during
     one step, bitwise-equal gradients from two backward passes on
     identical inputs, and every parameter's gradient on the "cuda" route
     against the "torch" route at a quarter of the resolution and of the
     gaussians (the B2 rule). Prints the median step time, steps/s, peak
     device memory of one step and the drop counters.

  8. 2DGS golden: tests/golden/render_2dgs.npz on the "cuda" route, the
     image, depth, normal and distortion maps and every parameter's
     gradient, at the golden tolerances.
  9. 2DGS kernels: the trained scene read as disks (the first two
     log-scales, as bench.py does for 2DGS), its slot tables with and
     without the maps; B6 and B7 against their plain version by the B1
     rule (the depth moments relative to their row's largest value) and
     bit-equal with and without the residual, their stop indices equal to
     the plain serial walk's (surfel_stop_plain) on all but STOP_MAX_SHARE
     of the pixels; their per-row skip: output and residual bit-equal to
     the full walk's, its count of skipped (row, slot) pairs equal to the
     plain mirror's, and by brute force over every pixel no skipped pair
     that a pixel keeps; their ptxas lines and launch shapes (threads a
     block, registers, shared memory, local bytes, blocks per SM); B8 (the
     maps' variant, which
     training runs) against its plain version by the B2 rule with a seeded
     cotangent, bitwise equal across two runs; B8's ptxas line and launch
     shape (cluster, threads, registers, shared memory, spills). Times as
     in phase 4 (the plain versions 3 runs after 1). Then B3 at the 2DGS
     adjoint's shapes: B8's 18 rows through the sort of the disks' slot
     keys, bit-equal to the plain version on the CPU and across two runs,
     its times (single and queued) and the gather adjoint's time.
 10. 2DGS render: the disks at 1920x1080 with the same budgets under
     no_grad on the "cuda" route, with the maps (B7, B4 and B5 launched,
     no backward kernel, no residual) and without (B6); drop counters equal
     to the "torch" route's and the route rule below on every output; the
     median render time of 10, pixels/s and peak device memory.
 11. 2DGS training: 10 train_step_surfel steps with Adam (normal weight
     0.05, distortion weight 100) from the perturbed raw disks towards the
     "cuda"-route render of the unperturbed ones. Checks a finite loss that
     falls, that B3, B4, B5, B7 and B8 were launched in one step,
     bitwise-equal gradients from two backward passes, and the route rule
     on the two routes' gradients at a quarter of the resolution and of
     the disks. Prints the median step time, steps/s and peak memory.

 12. B9, the blend-variant probe (scripts/port_kernel_probe.py's
     configuration: 1M seeded random gaussians, 1080p, tile_size 16): each
     of the nine variants launched once by the probe's path (its counter
     set to 0 just before); full bit-equal to B1; every variant against
     its plain version (B1's rule; blend1/blend3 at an atol of BF16_ATOL,
     and their plain versions moved from full on at least BF16_MIN_MOVED
     of the values; blend/memonly within ROW_SUM_MAX_REL of the row's
     scale); the parity line; each variant's time, with B1's bound.
 13. Density control at 1M capacity (ROADMAP's acceptance run): every
     other gaussian of the trained scene padded to 2^20 slots trains
     towards the render of the whole scene at 960x540 with preset 6's
     budgets: 500 steps of train_step_with_densify_stats (absgrad, Adam)
     with densify_and_prune every 100, then 100 MCMC steps (the
     regularizer in the loss, position noise each step, mcmc_relocate every
     50). Prints each event's metrics and alive counts before and after,
     the losses, the median step times, the peak memory and the launches;
     fails on a non-finite loss or parameter or an alive count above the
     capacity. Before the MCMC steps, the relocation, the position noise
     and the MCMC loss's gradients must each repeat bit for bit from one
     state and generator state (and the line says how many draws
     torch.multinomial moves between two such runs).
 14. The camera models (the phase 14 constants below), on the trained scene at
     1920x1080, preset 6 with tight_cull, the "cuda" route: renders through
     the pinhole in EWA and in UT mode, the fisheye, the rolling-shutter
     pinhole and the ortho camera, each with its median time of 10, drop
     counters, launches of B1-B5 (B4, B5, B1 and no other) and peak memory,
     held to the "torch" route by the B1 rule with equal counters; ten Adam
     steps of the perturbed gaussians and a learnable (6,) pose delta
     (apply_pose_delta) on the rolling-shutter fisheye started off by
     POSE_ERROR: a finite, falling loss, the median step time and peak
     memory, B1-B5 launched in a step, bitwise-equal gradients of the
     gaussians and the delta from two backward passes, and both routes'
     gradients, the delta's among them, by the B2 rule at a quarter of the
     resolution and of the gaussians; ortho disks without the maps: B6 and
     B8 (aux=False) on the ortho records against their plain versions (B1
     and B2 rules), B6's row skip bit-equal to the full walk with its
     count the mirror's and no kept pair skipped (brute force), B8 bitwise
     repeatable, their times; the render on both routes by the route rule
     (B4, B5 and B6 launched), its time; the backward of a seeded cotangent
     at a quarter of the size (B3-B6 and B8 launched), the "cuda" route's
     gradients against the "torch" route's in float64 by the route rule
     (disks ~1.5 px across there, so one pixel's threshold flip in f32
     moves a disk's gradient by up to a few percent of the row's largest;
     the f32 "torch" route's distance from float64 is printed beside it);
     the fisheye, and ortho with the maps, raising
     NotImplementedError on the "cuda" route; the fisheye's maps on the
     "torch" route at a reduced size (FISHEYE_DISK_STRIDE, a quarter of the
     resolution).

 15. The COLMAP capture path (the phase 15 constants below), through the
     port's entry points: a capture at 1920x1080 (16 views about the
     scene camera, the "cuda" route's renders of the trained scene as
     targets, 200,000 of its gaussians as the SfM cloud, observed in every
     view that sees them) written with the port's writers; the native IO
     built from mojosplat_tpu_torch/native/io_native.c, its readers equal
     to the Python ones on the capture (both parse times printed); the KNN
     init's time (the Morton path); train_colmap.main on the "cuda" route:
     3DGS with MCMC at 1M slots, tight culling, the depth loss and the
     pose, exposure and bilateral-grid refinements (relocating every 100
     steps: none falls in the run), checkpointed at step 100, then
     --resume to step 150; 2DGS with MCMC, 30 steps. Every step
     must launch B1-B5 (3DGS) or B3-B5, B7 and B8 (2DGS) exactly once and
     nothing else; the losses must be finite and the mean of the last 10
     below that of the first 10; the view parameters must leave identity;
     the checkpoint must restore bit-equal to the state it saved and the
     final PLY to the final parameters. Prints each run's median step
     time, steps/s, peak memory and MCMC relocations. eval_colmap on every
     4th view of the final PLY with a 20-step bilateral-grid appearance
     fit, and of the SfM initialisation: the trained mean PSNR must lie
     above the initial one.
 16. The scene tools (the phase 16 constants below), each CLI through its
     main(argv) on the "cuda" route at its defaults, with the launches of
     every kernel counted per render, frame, request, view or step (each
     path's kernels once, nothing else): the trained scene written as a
     3DGS PLY and its disks as a 2DGS PLY; render_sample (10k, 1080p), its
     PNG equal to a direct render; orbit_demo on the PLY at 1080p, 24
     frames, frame 0 equal to a direct render, the median frame time, and
     compilation_count unchanged by a second image size; the viewer's
     /render body for five poses, each PNG equal to a direct render, the
     median request time, and one request on the disks (B6);
     compress_scene to .npz with --verify (the PSNR, sizes, time) and back,
     the round trip equal to load_compressed_scene; extract_mesh on the
     disks (16 views at 640x480, 192^3): the stage times, the observed
     share, the mesh's counts and face indices, one view's alpha and
     expected depth against the "torch" route by the route rule, and the
     card's TSDF against the CPU's; tests/test_mesh.py's surfel sphere
     reconstructed on the card within that test's radius bounds;
     train_demo (defaults, and with MCMC every 100 steps),
     train_surfel_demo and train_blender (a Blender capture of the trained
     scene at 800x800, MCMC, 300 steps), each fitted or test PSNR above the
     initial one, with the median step time; a torch.profiler trace of one
     phase-7 train_step holding its annotated region, roofline_report of
     that step on the H100's peaks, amortized_ms of the 1080p render
     against cuda_ms_queued, and the dense oracle against the "cuda" route
     by the B1 rule.

 17. The sharded paths of parallel/ (the phase 17 constants below), at
     1920x1152 on the trained scene (preset 6 with tight_cull) and its
     disks, SGD at lr 1 with each step's gradient (its .grad) held to the
     single device's by the B2 rule and the loss within 1e-5: (a) in this
     process, 2 and 4 slabs (viewport_rows) against the full render, at
     preset 6 printed (a slab clamps a gaussian's tile rectangle before
     the span cut, ROADMAP Queue C) and each slab held to the "torch"
     route's slab (the disks with the maps by the route rule, their
     distortion relative to the depth squared it cancels); at PAR_EXACT
     (no rectangle cut) held to the full render by the B1 rule and the
     summed slab losses' gradients by the B2 rule, with each slab's
     launches; (b) a world of 1 on NCCL: train_step_sharded (with and
     without ZeRO-1), train_step_sharded_surfel, render_gaussians_sharded
     and train_step_gauss_sharded against train_step / train_step_surfel /
     render_gaussians, first-call and steady step times, and the
     benchmark_scaling CLI at its defaults in a world of one; after a
     ZeRO-1 step, here and in (c), the replicated parameters must be
     bitwise p - grad, the replicated update from the same all-reduced
     gradient (the replicas' .grad, itself held to the single device's);
     (c) two spawned ranks in a
     gloo world on the one card (gloo takes the card's tensors, so nothing
     is staged through the host): render_batch_sharded (both families),
     train_step_sharded with ZeRO-1 and train_step_sharded_surfel on a
     (1, 2) mesh at PAR_EXACT, its halo crossing row 576, and
     render_gaussians_sharded with its RouteAux and PAR_GAUSS_STEPS steps
     of train_step_gauss_sharded on make_gauss_mesh(2) at preset 6, 524,288
     gaussians a rank; each rank writes its blocks, gradients, counts,
     times and peak memory under build/parallel, and this process holds
     them to (b)'s single-device results (the surfel step's gradient to
     twice the single device's: the reference's n_dev x, ROADMAP Queue C).
     A rank that fails or outlives PAR_TIMEOUT_S fails the phase.
 18. The tools (the phase 18 constants below), each through its CLI's
     main(argv) on the card: (a) benchmark_proj, EWA and UT at
     1920x1080 over TOOLS_PROJ_COUNTS, six finite, positive results and
     no kernel launched; (b) benchmark at its defaults (100k gaussians,
     800x608) on both routes, then at TOOLS_BENCH_N at 1920x1080 on
     "cuda", every stage's launches counted through its time_stage hook:
     BENCH_STAGE_KERNELS on "cuda" (B4 in the binning, B5 and B1 in the
     rasterization, B4, B5, B1 in the forward, and B2 and B3 as well in
     the forward + backward), once a call, and nothing on "torch";
     num_isects equal on both routes at 100k; (c) make_synth_colmap at its
     defaults (512x512, 28 views, 30,000 SfM points, ~150k gaussians)
     under TOOLS_DIR, B4, B5 and B1 once a view and nothing else; view 0
     re-rendered with the maker's config and camera on both routes by the
     B1 rule, its PNG equal to to_uint8 of the "cuda" render byte for
     byte; resample_sfm to TOOLS_RESAMPLE points (host only, no kernel),
     the count read back with load_scene; train_colmap for
     TOOLS_TRAIN_STEPS steps on that capture at full size, B1-B5 once a
     step and nothing else, finite losses and a non-empty PLY; (d)
     record_parity into TOOLS_DIR, one family a call (each call resumes
     the file): the 3DGS records' forward by the B1 rule and their largest
     relative gradient difference within GRAD_MAX_REL (the record keeps
     each gradient's maximum only), the 2DGS record by the route rule; the
     launches of each record (B6 and B8 on the disks, whose render has no
     maps) and the record's JSON printed. Times are printed, not gated.

The route rule: the two routes compute the surfel alpha in different
coordinates (normalised on the "torch" route, intrinsics-primed in the
kernels), so a few values near a threshold may flip. Each output row is
scaled by its largest value (at least 1); at most ROUTE_MAX_SHARE of the
values may differ by more than BLEND_ATOL and none by more than
ROUTE_MAX_ERR. Gradients: at most ROUTE_GRAD_MAX_SHARE of the values may
differ by more than GRAD_REL_ATOL of their row's scale and none by more
than ROUTE_GRAD_MAX_REL of it.

The line before the last is a JSON object with each kernel's launches in
one training step of its path (B6: in the render without maps; B9: in the
probe's run, one entry per variant; launches_cameras: in one pose step of
phase 14 for B1-B5, in the ortho disks' backward for B6 and B8;
launches_capture_3dgs / _2dgs: in each step of phase 15's runs;
launches_scene_tools: per unit of each phase 16 tool that runs it;
launches_sharded: per rank and step of each phase 17 (c) path;
launches_cli_tools: per stage call, view, step or record of each phase 18
tool), its max
abs error against the plain version, its times and its bound (for B6-B8,
as for B1 and B2, counting the per-pair work only on the walked pairs
whose (pixel row, slot) pair the row test keeps, plus the row tests; B9
keeps B1's full-walk bound at the probe's shapes). The last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import io
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
GOLDEN = ROOT / "tests" / "golden" / "render_3dgs.npz"
GOLDEN_2DGS = ROOT / "tests" / "golden" / "render_2dgs.npz"
GOLDEN_RTOL, GOLDEN_ATOL = 5e-5, 5e-6
# The blend kernel multiplies T sequentially in f32 where the plain version
# takes a chunked cumprod; the ~1e-6 difference can flip the alpha-threshold
# or stop decision of a slot on a boundary pixel, so a few pixel-channels
# may differ by up to ~alpha_threshold * colour.
BLEND_ATOL, BLEND_MAX_ERR, BLEND_MAX_SHARE = 1e-5, 5e-3, 1e-4
# B6/B7's stop index against the plain serial walk: the same flips move at
# most this share of the pixels' stops.
STOP_MAX_SHARE = 1e-3
# Gradients, per row (a pdata field, or a parameter) with scale = max |plain|:
# the f32 sums over pixels run in other orders (readings on an H100: max
# 9.8e-7 of the scale for B2, 5.2e-7 for the two routes, none over 1e-4),
# and a boundary flip like B1's would move one pixel's share of a sum.
GRAD_REL_ATOL, GRAD_MAX_REL, GRAD_MAX_SHARE = 1e-4, 1e-3, 1e-5
# Peaks of one H100 SXM (NVIDIA's H100 datasheet): HBM bytes/s
# and f32 operations/s outside the tensor cores; and the exponentials/s of
# its special-function units, 16 per clock per SM (NVIDIA's arithmetic
# throughput table for compute capability 9.0) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S, F32_OPS_PER_S, SFU_EXP_PER_S = 3.35e12, 67e12, 16 * 132 * 1.98e9
# f32 operations per (pixel, slot) pair a blend function needs, one exp
# among them: B1's alpha (15 with the exp), T update (2), weight (1) and
# 4-channel accumulate (8); B2's adjoint, the replayed alpha and T (17)
# and d alpha, the 6 geometry and 4 channel gradients and its pixel sums
# (~48). (The B2 kernel computes the alpha twice to save registers; that
# is its choice, not work the function needs.)
B1_OPS_PER_PAIR, B2_OPS_PER_PAIR = 25, 65
# The surfel kernels, with two exponentials per pair: B6's alpha (the 2x2
# system 12, its determinant and solve 10 with two divisions, s2 and the
# filter 9, max, raw and clamp 4, the keep test 1), T update (2), weight
# (1) and 4-channel accumulate (8); B7 adds two channels (4), the depth z
# (4) and the two moments (4); B8's adjoint (the maps' variant) replays the
# alpha and T (~48), then d alpha and the carry (6), cv over 6 channels and
# the moments (16), the branch and filter terms (8), the solve's adjoint
# with its two divisions (24), the depth chain (12) and the 18 rows' pixel
# sums (18).
B6_OPS_PER_PAIR, B7_OPS_PER_PAIR, B8_OPS_PER_PAIR = 48, 60, 132
# B8's variant without the maps (phase 14's ortho disks) has no moments
# and no depth chain: the replay (~48), d alpha and the carry (6), cv over 3
# channels (8), the branch and filter terms (8), the solve's adjoint (24)
# and the 16 rows' pixel sums (16).
B8_PLAIN_OPS_PER_PAIR = 110
# A blend needs the per-pair work only where some pixel of the row may
# keep the slot: the row tests (ms_row_may_apply, ms_surfel_row_may_apply)
# prove the rest unkept at a cost per (pixel row, slot) pair, so a bound
# counts the walked pairs the row test keeps at the per-pair cost, and
# each row test the kernel makes at its own. B1's test, per pixel row of
# a warp: the clamped vertex with its division (11), the quadratic and the
# linear term (8), the margin's magnitude (13), the margin, exponential
# and compare (8), with one exponential. The surfel test: lam and its
# margin (9), the filter's least exponent (11), the row terms (5), each
# end's solve numerators and their magnitudes (2 x 25), the ends' phi, B
# and margin (26), the vertex (21), with a log and three square roots on
# the special-function units.
B1_ROW_TEST_OPS, B1_ROW_TEST_SFU = 40, 1
SURFEL_ROW_TEST_OPS, SURFEL_ROW_TEST_SFU = 122, 4
# The route rule of phases 10 and 11 (see above), with room above the
# readings at the disks' 1080p shapes on an H100 (NVIDIA H100 80GB HBM3,
# 700 W): renders 1.6e-4 to 2.5e-4 of the values off by more than 1e-5 of
# the map's scale, at most 4.1e-3; gradients at most 8.9e-6 of the values
# off by more than 1e-4 of the row's scale, at most 1.8e-3 of it. Both f32
# routes sit as far from an f64 blend (on a subsampled view of the same
# scene): the surfel alpha chain turns f32 rounding into threshold flips.
ROUTE_MAX_SHARE, ROUTE_MAX_ERR = 1e-3, 2e-2
ROUTE_GRAD_MAX_SHARE, ROUTE_GRAD_MAX_REL = 1e-4, 1e-2
SURFEL_WEIGHTS = dict(normal_weight=0.05, distortion_weight=100.0)
H, W = 1080, 1920
# Preset 6 of bench.py: its budgets with tight culling.
SCENE_BUDGETS = dict(
    tile_size=32, max_tile_span=4, isect_padding_multiplier=8,
    tile_capacity=512, tight_cull=True,
)
BACKGROUND = (0.1, 0.1, 0.1)
TRAIN_SEED, TRAIN_STEPS, TRAIN_LR = 0, 10, 1e-3
# Standard deviation of the noise added to each raw parameter before
# training (the scene's gaussians are ~0.015 world units across).
PERTURB = dict(means3d=2e-3, scales=0.05, quats=0.02, opacities_raw=0.2, features=0.02)
KEYS = ("means3d", "scales", "quats", "opacities", "features")
# Phase 12, B9: the plain blend1 and blend3 walk the kernel's f32
# transmittance chain and every bf16 product is exact in f32, so the kernel
# meets them at f32 rounding: the B1 rule with an atol of BF16_ATOL of the
# row's scale. The bf16 product moves blend3 from full by at most ~1e-5 of
# the scale, so this atol, not the B1 rule's, tells it from full; the plain
# version must differ from full (B1's output) by more than BF16_ATOL on at
# least BF16_MIN_MOVED of the values, or the compare could not tell a
# kernel that skipped the rounding. The raw-row sums of blend and memonly
# add at most 512 positive terms in another order, so they lie within 512
# f32 ulps (3e-5) of their row's scale.
BF16_ATOL, BF16_MIN_MOVED, ROW_SUM_MAX_REL = 1e-7, 1e-2, 3e-5
# Phase 13, ROADMAP's density-control acceptance: half the trained scene
# padded to 2^20 slots, 960x540, 500 ADC steps (absgrad, Adam) with an event
# every 100, then 100 MCMC steps with a relocation every 50.
DENSIFY_H, DENSIFY_W, DENSIFY_CAPACITY, DENSIFY_SEED = 540, 960, 1 << 20, 0
ADC_STEPS, ADC_EVERY, MCMC_STEPS, MCMC_EVERY = 500, 100, 100, 50
# The ADC threshold at each event: this quantile of the live gaussians' mean
# statistic, so about 1% of them are candidates whatever the statistic's
# units; the scene extent is 1.1 x the evaluation view's orbit radius (the
# reference recipe's camera extent).
DENSIFY_QUANTILE, SCENE_EXTENT = 0.99, 1.1 * 3.9

# Phase 14, the camera models at the trained scene's view: a fisheye of a
# 60 degree half-width (fx = fy = 960 / (pi / 3) at 1920 wide) with the
# coefficients of tests/test_camera_models.py, the rolling-shutter velocity
# of tests/test_rolling_shutter.py, and an ortho camera whose fx makes the
# spread of the centres' camera-frame x between its 1st and 99th
# percentiles fill ORTHO_FILL of the width. The pose refinement starts the
# rolling fisheye off by POSE_ERROR (a few pixels at its focal length) and
# learns a (6,) delta at examples/train_colmap.py's --pose-lr beside the
# gaussians. The fisheye disks with the maps render on the "torch" route
# only, at every FISHEYE_DISK_STRIDE-th disk and 1/4 of the resolution.
FISHEYE_K = (0.08, -0.01, 0.002, -0.0005)
RS_VEL = (0.05, 0.08, 0.02, 0.1, -0.05, 0.2)
ORTHO_FILL = 0.9
POSE_ERROR, POSE_LR = (2e-3, -1.5e-3, 1e-3, 4e-3, -3e-3, 2e-3), 1e-4
FISHEYE_DISK_STRIDE = 16

# Phase 15, the COLMAP capture path: a capture at the sizes users train on
# (a Tanks and Temples capture: 1957x1091, ~136k SfM points; 3DGS-MCMC at a
# 1M cap), written under build/capture with the port's writers: one
# PINHOLE camera at H x W with the scene camera's intrinsics, CAPTURE_VIEWS
# poses within CAPTURE_SPAN_DEG of the scene camera about its look-at point
# (a yaw row of 8 at each of two pitches), the "cuda"-route renders of the
# trained scene as the targets, and CAPTURE_POINTS of its gaussians (drawn
# with CAPTURE_SEED) as the SfM cloud, coloured by their SH DC and observed
# in every view where they project in frame at z > 0. The runs are the
# train_colmap CLI's (CAPTURE_3DGS, then --resume to CAPTURE_RESUME_STEPS;
# CAPTURE_2DGS) and eval_colmap on every CAPTURE_EVAL_EVERY-th view. The
# 3DGS run relocates every 100 steps, so none of its 150 steps does (the
# CLI skips an event at a run's last step): a relocation at step 50 moves
# the 848,576 padded slots onto the 200,000 points, and the CLI's position
# noise, --lr x 5e5 x the opacity gate as in the reference (0.17 at the
# copies' opacity of ~0.02), flings the copies and the loss rises from
# 0.07 to 0.25 and is still 0.16 at step 150 (ROADMAP Queue C; PERF.md
# section 6, PR 10). Phase 13 relocates at 1M slots.
CAPTURE_VIEWS, CAPTURE_SPAN_DEG, CAPTURE_POINTS, CAPTURE_SEED = 16, 10.0, 200_000, 0
CAPTURE_3DGS = ["--downscale", "1", "--max-gaussians", "1048576", "--tight-cull",
                "--strategy", "mcmc", "--densify-every", "100", "--depth-loss", "0.05",
                "--pose-opt", "--exposure-opt", "--bilagrid"]
CAPTURE_STEPS, CAPTURE_RESUME_STEPS = 100, 150  # checkpointed at CAPTURE_STEPS
CAPTURE_2DGS = ["--downscale", "1", "--primitive", "2dgs", "--strategy", "mcmc", "--steps", "30"]
CAPTURE_EVAL_EVERY, CAPTURE_EVAL_STEPS = 4, 20

# Phase 16, the scene tools, each CLI at its defaults through main(argv) on
# the "cuda" route. The scene files are the trained scene's 3DGS PLY and
# its disks' 2DGS PLY (the first two log-scales, as phase 9 reads them).
# train_blender trains on a Blender capture at NeRF-synthetic's frame size
# (800x800 RGBA; the public lego split has 100 train and 200 test views,
# cut to BLENDER_TEST for the phase's time): the "cuda"-route renders of the
# trained scene, their alpha 1 - T, from poses within BLENDER_YAW_DEG /
# BLENDER_PITCH_DEG of the scene camera about its look-at point (a golden-
# ratio spread), at the scene camera's focal (0.72 W), for BLENDER_STEPS
# steps with MCMC. The viewer answers VIEWER_POSES (azimuth, elevation) at
# its start radius. tsdf_fuse on the card against the CPU: the TSDF within
# TSDF_ATOL where the weights agree, the weights differing on under
# TSDF_MAX_FLIP_SHARE of the voxels (a 1e-7 sample difference flips a
# threshold). amortized_ms within AMORTIZED_MAX_REL of cuda_ms_queued. The
# dense oracle at ORACLE_HW^2 with ORACLE_N seeded gaussians (B1's rule).
BLENDER_SIZE, BLENDER_TRAIN, BLENDER_TEST, BLENDER_STEPS = 800, 100, 25, 300
BLENDER_YAW_DEG, BLENDER_PITCH_DEG = 30.0, 10.0
VIEWER_POSES = ((0.0, 0.25), (0.8, 0.1), (1.6, -0.2), (3.0, 0.4), (4.5, 0.0))
TSDF_ATOL, TSDF_MAX_FLIP_SHARE = 1e-5, 1e-4
AMORTIZED_MAX_REL = 0.1
ORACLE_HW, ORACLE_N = 256, 2000

# Phase 17, the sharded paths of parallel/, on the trained scene and its
# disks at full width: 1080 rows rounded up to whole slabs of 4 x 32 rows
# (as examples/benchmark_scaling.py:76-77 rounds: 36 tile rows, so 2 and 4
# slabs divide). (c) runs PAR_GAUSS_STEPS steps of the gaussian-sharded
# trainer; its ranks write under PAR_DIR and must end within PAR_TIMEOUT_S.
PAR_H, PAR_W = 1152, 1920
# Preset 6's budgets with no tile rectangle cut: at 1920x1152 the trained
# scene's rectangles span at most 22 tile rows (their AABBs, 4,344,290
# slots, within the 8x capacity); tight_cull takes spans up to 8 only.
PAR_EXACT = dict(SCENE_BUDGETS, tight_cull=False, max_tile_span=36)
PAR_GAUSS_STEPS = 3
PAR_DIR = ROOT / "build" / "parallel"
PAR_TIMEOUT_S = 420

# Phase 18, the tools through their CLIs: benchmark_proj over
# TOOLS_PROJ_COUNTS at H x W; benchmark at its defaults on both routes,
# then at TOOLS_BENCH_N gaussians at H x W on "cuda", each stage launching
# BENCH_STAGE_KERNELS on "cuda" and nothing on "torch"; the capture maker
# at its defaults under TOOLS_DIR, its SfM cloud resampled to
# TOOLS_RESAMPLE points, and TOOLS_TRAIN_STEPS train_colmap steps on it;
# record_parity's three records. Times are printed, never gated.
TOOLS_PROJ_COUNTS, TOOLS_BENCH_N = (1_000, 100_000, 1_000_000), 1_000_000
TOOLS_RESAMPLE, TOOLS_TRAIN_STEPS = 200_000, 10
TOOLS_DIR = ROOT / "build" / "tools"
BENCH_STAGE_KERNELS = {"projection": (), "binning": ("B4",), "rasterization": ("B5", "B1"),
                       "e2e_forward": ("B4", "B5", "B1"),
                       "e2e_fwd_bwd": ("B4", "B5", "B1", "B2", "B3")}


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def cuda_ms(fn, runs: int, warmup: int) -> float:
    """Median milliseconds of ``fn()`` over ``runs`` runs, each between two
    CUDA events and a synchronize, after ``warmup`` untimed runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def cuda_ms_queued(fn, runs: int, warmup: int) -> float:
    """Milliseconds per call of ``fn()`` over ``runs`` calls queued back to
    back between two CUDA events, after ``warmup`` untimed calls: the
    device's time per call once the host's launch path overlaps the
    previous call (cuda_ms also counts the device waiting for the launch)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(runs):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / runs


def bound(nbytes: float, ops: float, exps: float = 0.0) -> dict:
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations, the f32 ones over the f32 rate or the
    exponentials over the special-function units' rate, whichever is
    longer."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / F32_OPS_PER_S, exps / SFU_EXP_PER_S) * 1e3
    if t_bytes >= t_ops:
        return dict(bound_ms=t_bytes, bound_by="bytes")
    return dict(bound_ms=t_ops, bound_by="operations")


def b3_bit_equal(name: str, got: torch.Tensor, sorted_cols: torch.Tensor,
                 keys: torch.Tensor, n: int) -> float:
    """B3's sums against its plain version on CPU copies of the sorted
    payload, bit for bit (index_add_ on the CPU adds in row order from 0, as
    B3 does). Returns the max abs difference, 0."""
    from mojosplat_tpu_torch.ops.segsum_cuda import segment_sum_cols_plain

    want = segment_sum_cols_plain(sorted_cols.cpu(), keys.cpu(), n)
    got = got.cpu()
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: {int((got != want).sum())} sums differ from the plain "
                             f"version on the CPU (max {float((got - want).abs().max()):.3e})")
    return float((got - want).abs().max())


def adjoint_ms(slot_gids, counts, g, nfields: int, n: int) -> dict:
    """The slot gather's adjoint (raster_cuda._GatherRows.backward: the
    sort, B3, the pad rows) for the cotangent ``g`` (rows, n_slots) of a
    gather of ``slot_gids`` with ``counts`` from ``n`` columns: ms of one
    call and per call over 20 queued back to back, by autograd.grad on a
    graph kept."""
    from mojosplat_tpu_torch.ops.raster_cuda import gather_slots

    with torch.enable_grad():
        packed = torch.zeros((g.shape[0], n), device=g.device, requires_grad=True)
        out = gather_slots(packed, slot_gids, counts, nfields)

        def run():
            torch.autograd.grad(out, packed, g, retain_graph=True)

        return dict(ms=cuda_ms(run, 20, 3), ms_queued=cuda_ms_queued(run, 20, 3))


def ptxas_report(log: str) -> list[tuple[str, int, str, int]]:
    """(mangled kernel name, registers, spill line, static shared bytes) of
    each kernel in ptxas's -v report."""
    out, name, spills = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif "spill stores" in line:
            spills = line.strip()
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((name, int(m.group(1)), spills, int(smem.group(1)) if smem else 0))
            name = None
    return out


def blend_skip_counts(pdata, counts, ts: int, tw: int, config) -> dict:
    """B1's per-row skip at these inputs. The kernel's count of skipped
    (warp, slot) pairs must equal the plain mirror's (row_may_apply_plain
    from B1's own stop indices); by brute force over every pixel (the
    per-pixel rule's keep), the row test must skip no pair a pixel of the
    warp keeps. Returns the pairs walked (slot below the pixel's stop),
    those of them no pixel keeps (alpha below the threshold or sigma < 0)
    and those whose (warp, slot) pair the row test keeps, the (warp, slot)
    pairs below the count, those no pixel of the warp keeps and those the
    row test skips, and the pairs B1 tested and skipped."""
    from mojosplat_tpu_torch.ops.raster_cuda import (
        B1_WARP_PIXELS, raster_tiles_skips, row_may_apply_plain, skipped_pairs_plain)
    from mojosplat_tpu_torch.ops.rasterization import _pixel_terms, tile_pixel_centers

    n_tiles, rows = counts.shape[0], pdata.shape[0]
    cap, P, W = pdata.shape[1] // n_tiles, ts * ts, B1_WARP_PIXELS
    nw = -(-P // W)
    skipped, stop = raster_tiles_skips(pdata, counts, ts, tw, config)
    may = row_may_apply_plain(pdata, n_tiles, ts, tw, config)
    mirror = skipped_pairs_plain(may, counts, stop)
    if not torch.equal(skipped, mirror):
        raise AssertionError(f"B1 skipped {int(skipped.sum())} (warp, slot) pairs, the plain "
                             f"mirror {int(mirror.sum())}")
    out = dict(walked=0, walked_unkept=0, walked_may=0, warp_slots=0, warp_slots_unkept=0,
               warp_slots_skipped=0, missed=0,
               tested=int(skipped_pairs_plain(torch.zeros_like(may), counts, stop).sum()),
               skipped=int(skipped.sum()))
    pd = pdata.reshape(rows, n_tiles, cap)
    slot = torch.arange(cap, device=pdata.device)
    group = 16  # tiles at a time: (group, ts * ts, cap) per-pixel terms
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=pdata.device)
        G = tiles.shape[0]
        px, py = tile_pixel_centers(tiles, ts, tw, torch.float32)
        live = slot[None, :] < counts[tiles, None]
        keep = _pixel_terms(px, py, pd[0:2, tiles].permute(1, 2, 0),
                            pd[2:5, tiles].permute(1, 2, 0), pd[5, tiles], live, config)[1]
        walked = slot[None, None, :] < stop[tiles][..., None]
        out["walked"] += int(walked.sum())
        out["walked_unkept"] += int((walked & ~keep).sum())
        wkeep = torch.nn.functional.pad(keep, (0, 0, 0, nw * W - P)).reshape(
            G, nw, W, cap).any(dim=2)
        wlive = live[:, None, :].expand(G, nw, cap)
        wmay = may[g0 : g0 + G]
        out["walked_may"] += int((torch.nn.functional.pad(walked, (0, 0, 0, nw * W - P))
                                  .reshape(G, nw, W, cap) & wmay[:, :, None, :]).sum())
        out["warp_slots"] += int(wlive.sum())
        out["warp_slots_unkept"] += int((wlive & ~wkeep).sum())
        out["warp_slots_skipped"] += int((wlive & ~wmay).sum())
        out["missed"] += int((wkeep & ~wmay).sum())
    if out["missed"]:
        raise AssertionError(f"B1's row test skipped {out['missed']} kept (warp, slot) pairs")
    return out


def surfel_skip_counts(pdata, counts, ts: int, tw: int, config, aux: bool, out, resid) -> dict:
    """B6's or B7's per-row skip at these inputs. The skip's output and
    residual (out, resid from the same kernel) must equal the full walk's
    bit for bit (T where a chunk starts below the stop), its count of
    skipped (pixel row, slot) pairs the plain mirror's
    (surfel_row_may_apply_plain from the kernel's own stops); by brute force
    over every pixel, the row test must skip no pair a pixel of the row
    keeps. Returns the (row, slot) pairs the warps tested and skipped, the
    (row, slot) pairs below the counts, those no pixel keeps and those the
    row test skips, and the walked (pixel, slot) pairs, those of them no
    pixel keeps and those whose (pixel row, slot) pair the row test keeps."""
    from mojosplat_tpu_torch.ops.raster_cuda import RESID_CHUNK
    from mojosplat_tpu_torch.ops.surfel_cuda import (
        _surfel_geometry, raster_surfel_tiles_check, surfel_row_may_apply_plain,
        surfel_skipped_pairs_plain)

    n_tiles, rows = counts.shape[0], pdata.shape[0]
    cap = pdata.shape[1] // n_tiles
    tchunk, stop = resid
    live = (torch.arange(tchunk.shape[1], device=pdata.device)[None, :, None]
            * RESID_CHUNK) < stop[:, None, :]
    skip = raster_surfel_tiles_check(pdata, counts, ts, tw, config, aux)
    full = raster_surfel_tiles_check(pdata, counts, ts, tw, config, aux, walk_all=True)
    for o_c, tc_c, st_c in (skip[:3], full[:3]):
        if not (torch.equal(o_c.view(torch.int32), out.view(torch.int32))
                and torch.equal(st_c, stop)
                and torch.equal(tc_c.view(torch.int32)[live], tchunk.view(torch.int32)[live])):
            raise AssertionError("the row skip's output or residual differs from the full walk's")
    del full, live
    may = surfel_row_may_apply_plain(pdata, n_tiles, ts, tw, config)
    mirror = surfel_skipped_pairs_plain(may, counts, stop)
    if not torch.equal(skip[3], mirror):
        raise AssertionError(f"the kernel skipped {int(skip[3].sum())} (row, slot) pairs, the "
                             f"plain mirror {int(mirror.sum())}")
    out_d = dict(tested=int(surfel_skipped_pairs_plain(torch.zeros_like(may), counts,
                                                      stop).sum()),
                 skipped=int(skip[3].sum()), row_slots=0, row_slots_unkept=0,
                 row_slots_skipped=0, missed=0, walked=0, walked_unkept=0, walked_may=0)
    del skip
    pd = pdata.reshape(rows, n_tiles, cap)
    slot = torch.arange(cap, device=pdata.device)
    group = 16  # tiles at a time: (group, ts * ts, cap) per-pixel terms
    for g0 in range(0, n_tiles, group):
        tiles = torch.arange(g0, min(g0 + group, n_tiles), device=pdata.device)
        G = tiles.shape[0]
        keep = _surfel_geometry(tiles, pd, 0, cap, counts, ts, tw, config, aux)[2]["keep"]
        rkeep = keep.reshape(G, ts, ts, cap).any(dim=2)
        rlive = (slot[None, :] < counts[tiles, None])[:, None, :].expand(G, ts, cap)
        rmay = may[g0 : g0 + G]
        walked = slot[None, None, :] < stop[tiles][..., None]
        out_d["row_slots"] += int(rlive.sum())
        out_d["row_slots_unkept"] += int((rlive & ~rkeep).sum())
        out_d["row_slots_skipped"] += int((rlive & ~rmay).sum())
        out_d["missed"] += int((rkeep & ~rmay).sum())
        out_d["walked"] += int(walked.sum())
        out_d["walked_unkept"] += int((walked & ~keep).sum())
        out_d["walked_may"] += int((walked.reshape(G, ts, ts, cap) & rmay[:, :, None, :]).sum())
        del keep, walked
    if out_d["missed"]:
        raise AssertionError(f"the row test skipped {out_d['missed']} kept (row, slot) pairs")
    return out_d


def blend_agreement(name: str, got: torch.Tensor, want: torch.Tensor, scale=1.0,
                    max_share: float = BLEND_MAX_SHARE, max_err: float = BLEND_MAX_ERR,
                    atol: float = BLEND_ATOL) -> float:
    """Apply the B1 rule (or another share, max and atol) to |got - want| /
    scale; print the differing count and the max; return the max abs
    diff."""
    raw = (got - want).abs()
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite output")
    diff = raw / scale
    n_diff = int((diff > atol).sum())
    worst = float(diff.max())
    share = n_diff / diff.numel()
    phase(name, f"{n_diff} of {diff.numel()} values differ by more than "
          f"{atol} ({share:.3e}); max diff {worst:.3e}, max abs diff "
          f"{float(raw.max()):.3e}")
    if share > max_share or worst > max_err:
        raise AssertionError(
            f"{name}: disagrees (share {share:.3e} > {max_share} or max {worst:.3e} > "
            f"{max_err})")
    return float(raw.max())


def row_scale(x: torch.Tensor, dim) -> torch.Tensor:
    """Each row's largest magnitude, at least 1 (maps in scene units such as
    depth and its square are held relative to their scale)."""
    return x.abs().amax(dim=dim, keepdim=True).clamp(min=1.0)


def grad_agreement(name: str, got: torch.Tensor, want: torch.Tensor,
                   max_share: float = GRAD_MAX_SHARE, max_rel: float = GRAD_MAX_REL) -> float:
    """Apply the gradient rule (or another share and max) to rows of ``got``
    against ``want`` (the first axis indexes rows); print the share, the
    max; return the max abs diff."""
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite gradient")
    got2, want2 = got.reshape(got.shape[0], -1), want.reshape(want.shape[0], -1)
    diff = (got2 - want2).abs()
    rel = diff / (want2.abs().amax(dim=1, keepdim=True) + 1e-30)
    n_off = int((rel > GRAD_REL_ATOL).sum())
    share, worst = n_off / rel.numel(), float(rel.max())
    phase(name, f"{n_off} of {rel.numel()} values off by more than {GRAD_REL_ATOL} "
          f"of their row's scale ({share:.3e}); max {worst:.3e} of the scale, "
          f"max abs diff {float(diff.max()):.3e}")
    if share > max_share or worst > max_rel:
        raise AssertionError(
            f"{name}: disagrees (share {share:.3e} > {max_share} or max "
            f"{worst:.3e} > {max_rel} of the row scale)")
    return float(diff.max())


def drop_counters(aux) -> dict:
    """A RenderAux's binning counters and tile_overflow, as ints."""
    out = {k: int(v) for k, v in aux.binning._asdict().items()}
    out["tile_overflow"] = int(aux.raster.tile_overflow)
    return out


def perturbed_leaves(raw: dict, dev) -> dict:
    """Trainable copies of the raw parameters with seeded numpy noise of
    standard deviation PERTURB[name] added."""
    rng = np.random.default_rng(TRAIN_SEED)
    return {
        k: torch.from_numpy(v + rng.standard_normal(v.shape, dtype=np.float32) * PERTURB[k])
        .to(dev).requires_grad_(True)
        for k, v in raw.items()
    }


def train_steps(step, reset_counters, read_counters, dev):
    """TRAIN_STEPS calls of ``step()`` (which returns the loss), each timed
    between two CUDA events and a synchronize. The counters and the peak
    memory are reset before the first step and read after it. Returns
    (losses, step ms, the first step's launches, its peak memory)."""
    losses, step_ms = [], []
    for i in range(TRAIN_STEPS):
        if i == 0:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counters()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step()
        end.record()
        torch.cuda.synchronize()
        if i == 0:
            launched, peak = read_counters(), torch.cuda.max_memory_allocated(dev)
        step_ms.append(start.elapsed_time(end))
        losses.append(float(loss))
    return losses, step_ms, launched, peak


def check_bitwise(grads_of, name: str) -> None:
    """Two backward passes on identical inputs give bitwise-equal gradients."""
    g1, g2 = grads_of(), grads_of()
    for k in g1:
        if not torch.equal(g1[k], g2[k]):
            raise AssertionError(f"{name}: two backward passes differ in d {k}")
    phase(name, "two backward passes on identical inputs: bitwise equal gradients")


def surfel_phases(raw: dict, sh_degree: int, cam, gcam, gcfg, kernels: list) -> None:
    """Phases 8-11: the 2DGS surfel path. Appends B6, B7 and B8 to
    ``kernels`` and gives B3, B4 and B5 their launches in a 2DGS step."""
    from mojosplat_tpu_torch import RenderConfig, _kernels
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.ops.binning import num_tiles
    from mojosplat_tpu_torch.ops.expand_cuda import segment_expand_offsets
    from mojosplat_tpu_torch.ops.raster_cuda import raster_tiles, raster_tiles_bwd
    from mojosplat_tpu_torch.ops.segsum_cuda import segment_sum_cols
    from mojosplat_tpu_torch.ops.sh import sh_to_color
    from mojosplat_tpu_torch.ops.slice_cuda import segment_slice_gather
    from mojosplat_tpu_torch.ops.surfel_cuda import (
        raster_surfel_tiles, raster_surfel_tiles_bwd, raster_surfel_tiles_bwd_plain,
        raster_surfel_tiles_fwd, raster_surfel_tiles_plain, surfel_bwd_shape, surfel_fwd_shape,
        surfel_stop_plain)
    from mojosplat_tpu_torch.surfel import bin_surfels, pack_surfel_tiles, render_surfels
    from mojosplat_tpu_torch.train import (
        activate, make_optimizer, surfel_loss, train_step_surfel)
    from mojosplat_tpu_torch.utils.scenes import scene_camera

    dev = torch.device("cuda", 0)

    # ---- 8. The 2DGS golden, forward and gradients, on the "cuda" route
    with np.load(GOLDEN_2DGS) as z:
        golden = {k: z[k] for k in z.files}
    gp = params_from_numpy({k[3:]: v for k, v in golden.items() if k.startswith("in_")}, dev)

    def render_golden(p):
        return render_surfels(*(p[k] for k in KEYS), gcam, sh_degree=2,
                              background_color=(0.15, 0.05, 0.25), config=gcfg,
                              return_depth=True, return_normals=True, return_distortion=True)

    with torch.no_grad():
        out = [x.cpu().numpy() for x in render_golden(gp)]
    worst = []
    for name, got in zip(("image", "depth", "normal", "distortion"), out):
        want = golden["image" if name == "image" else f"aux_{name}"]
        atol = GOLDEN_ATOL * (1.0 if name == "image" else float(np.abs(want).max()) + 1.0)
        np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL, atol=atol,
                                   err_msg=f"2DGS golden {name}")
        worst.append(f"{name} {np.abs(got - want).max():.3e}")
    leaves = {k: v.clone().requires_grad_(True) for k, v in gp.items()}
    img, *maps = render_golden(leaves)
    loss = torch.mean(img**2)
    for m in maps:
        loss = loss + 1e-3 * torch.mean(m**2)
    loss.backward()
    for k in KEYS:
        g, want = leaves[k].grad.cpu().numpy(), golden[f"grad_{k}"]
        np.testing.assert_allclose(g, want, rtol=GOLDEN_RTOL,
                                   atol=GOLDEN_ATOL * float(np.abs(want).max()),
                                   err_msg=f"2DGS golden gradient {k}")
        worst.append(f"d {k} {np.abs(g - want).max():.3e}")
    phase("2dgs-golden", "max abs diff " + ", ".join(worst) + ": ok")

    # ---- 9. B6, B7 and B8 against their plain versions at the disks' shapes
    disks = dict(raw, scales=np.ascontiguousarray(raw["scales"][:, :2]))
    disks_dev = params_from_numpy(disks, dev)
    params = activate(disks_dev)
    cfg_cuda = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS)
    # tile_batch bounds the plain blenders' memory; it changes no result.
    cfg_torch = RenderConfig(raster_impl="torch", tile_batch=256, **SCENE_BUDGETS)
    cfg_plain = RenderConfig(raster_impl="cuda", tile_batch=128, **SCENE_BUDGETS)
    ts = cfg_cuda.tile_size
    th, tw = num_tiles(H, W, ts)
    n_tiles, P = th * tw, ts * ts
    geometry = [params[k] for k in ("means3d", "scales", "quats", "opacities")]
    with torch.no_grad():
        bins = bin_surfels(*geometry, cam, cfg_cuda)
        colors = sh_to_color(params["features"], params["means3d"], cam.position, sh_degree)
        for aux, kid in ((False, "B6"), (True, "B7")):
            pdata, counts = pack_surfel_tiles(*geometry, colors, cam, bins, cfg_cuda, aux)
            rows = pdata.shape[0]
            out = raster_surfel_tiles(pdata, counts, ts, tw, cfg_cuda, aux)
            ref = raster_surfel_tiles_plain(pdata, counts, ts, tw, cfg_plain, aux)
            err = blend_agreement(kid, out, ref, row_scale(ref, (0, 2)))
            out_r, resid = raster_surfel_tiles_fwd(pdata, counts, ts, tw, cfg_cuda, aux, True)
            if not torch.equal(out_r, out):
                raise AssertionError(f"{kid}: the output changes when the residual is written")
            stop_want = surfel_stop_plain(pdata, counts, ts, tw, cfg_plain, aux)
            n_flip = int((resid[1] != stop_want).sum())
            if n_flip > STOP_MAX_SHARE * stop_want.numel():
                raise AssertionError(f"{kid}: {n_flip} of {stop_want.numel()} stop indices "
                                     f"differ from the plain serial walk's")
            walked = torch.minimum(resid[1], counts[:, None])
            pairs, slots = int(walked.sum()), int(counts.sum())
            skips = surfel_skip_counts(pdata, counts, ts, tw, cfg_cuda, aux, out, resid)
            # The work the row test leaves: the walked pairs of the (pixel
            # row, slot) pairs it keeps, and each (row, slot) pair tested.
            need = skips["walked_may"]
            kernels.append(dict(
                name=f"{kid} raster_surfel_tiles ({'with' if aux else 'without'} maps)",
                route="cuda", source="mojosplat_tpu_torch/csrc/surfel_fwd.cu",
                replaces="mojosplat_tpu/ops/surfel_pallas.py:392",
                max_abs_err=err,
                ms=cuda_ms(lambda: raster_surfel_tiles(pdata, counts, ts, tw, cfg_cuda, aux),
                           20, 3),
                ms_with_residual=cuda_ms(lambda: raster_surfel_tiles_fwd(
                    pdata, counts, ts, tw, cfg_cuda, aux, True), 20, 3),
                plain_ms=cuda_ms(lambda: raster_surfel_tiles_plain(
                    pdata, counts, ts, tw, cfg_plain, aux), 3, 1),
                **bound(4 * (rows * slots + n_tiles + out.numel()),
                        (B7_OPS_PER_PAIR if aux else B6_OPS_PER_PAIR) * need
                        + SURFEL_ROW_TEST_OPS * skips["tested"],
                        2 * need + SURFEL_ROW_TEST_SFU * skips["tested"]),
                library_ms=None, skips=skips,
            ))
            phase(kid, f"pdata {tuple(pdata.shape)}, {slots} slots, {pairs} (pixel, slot) "
                  f"pairs walked, {need} of them in (row, slot) pairs the row test keeps; "
                  f"bit-equal with the residual written; stop indices equal to "
                  f"the plain serial walk's on all but {n_flip} of {stop_want.numel()} pixels")
            for name, regs, spills, smem in ptxas_report(_kernels.build()[1]):
                if f"surfel_fwd_kernelILb{int(aux)}E" in name:
                    phase(kid, f"ptxas {name}: {regs} registers, {smem} bytes smem, {spills}")
            phase(kid, f"row test: skipped {skips['skipped']} of the {skips['tested']} (pixel "
                  f"row, slot) pairs its warps tested ({skips['skipped'] / skips['tested']:.4f}), "
                  f"equal to the plain mirror's count; output and residual bit-equal to the full "
                  f"walk's; of the {skips['row_slots']} (row, slot) pairs below the counts no "
                  f"pixel keeps {skips['row_slots_unkept']} "
                  f"({skips['row_slots_unkept'] / skips['row_slots']:.4f}) and the row test skips "
                  f"{skips['row_slots_skipped']} "
                  f"({skips['row_slots_skipped'] / skips['row_slots']:.4f}), none kept; of the "
                  f"{skips['walked']} walked (pixel, slot) pairs {skips['walked_unkept']} "
                  f"({skips['walked_unkept'] / skips['walked']:.4f}) are not kept")
            shapes = {r: surfel_fwd_shape(aux, ts, r) for r in (False, True)}
            kernels[-1]["shape"] = shapes[False]
            for r, shape in shapes.items():
                phase(kid, f"launch shape{' with the residual' if r else ''}: "
                      f"{n_tiles * -(-P // shape['threads'])} blocks of "
                      f"{shape['threads']} threads (a pixel a thread), {shape['registers']} "
                      f"registers, {shape['local_bytes']} local bytes a thread, "
                      f"{shape['shared_bytes']} shared bytes a block, {shape['blocks_per_sm']} "
                      f"blocks ({shape['blocks_per_sm'] * shape['threads'] // 32} warps) per SM")
            del ref, out_r, stop_want

        # B8, the maps' variant that training runs: pdata's blended slots,
        # gout, the residual's walked chunks and stop, counts, and d pdata.
        rng = np.random.default_rng(2)
        gout = torch.from_numpy(
            rng.standard_normal((n_tiles, 9, P), dtype=np.float32)).to(dev)
        d_pdata = raster_surfel_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda, True)
        d_want = raster_surfel_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg_plain, True)
        err = grad_agreement("B8", d_pdata, d_want)
        if not torch.equal(raster_surfel_tiles_bwd(pdata, counts, gout, resid, ts, tw,
                                                   cfg_cuda, True), d_pdata):
            raise AssertionError("B8: two runs differ")
        chunk_reads = int(((walked + 15) // 16).sum())
        kernels.append(dict(
            name="B8 raster_surfel_tiles_bwd (with maps)", route="cuda",
            source="mojosplat_tpu_torch/csrc/surfel_bwd.cu",
            replaces="mojosplat_tpu/ops/surfel_pallas.py:441",
            max_abs_err=err,
            ms=cuda_ms(lambda: raster_surfel_tiles_bwd(pdata, counts, gout, resid, ts, tw,
                                                       cfg_cuda, True), 20, 3),
            plain_ms=cuda_ms(lambda: raster_surfel_tiles_bwd_plain(
                pdata, counts, gout, ts, tw, cfg_plain, True), 3, 1),
            **bound(4 * (rows * slots + gout.numel() + chunk_reads + resid[1].numel()
                         + n_tiles + d_pdata.numel()),
                    B8_OPS_PER_PAIR * need + SURFEL_ROW_TEST_OPS * skips["tested"],
                    2 * need + SURFEL_ROW_TEST_SFU * skips["tested"]),
            library_ms=None,
        ))
        shape = surfel_bwd_shape(True, ts)
        kernels[-1]["shape"] = shape
        for name, regs, spills, smem in ptxas_report(_kernels.build()[1]):
            if "surfel_bwd_kernel" in name:
                phase("B8", f"ptxas {name}: {regs} registers, {smem} bytes smem, {spills}")
        phase("B8", f"d pdata {tuple(d_pdata.shape)} from a seeded gout; two runs bitwise "
              f"equal; launch shape: clusters of {shape['cluster']} blocks of "
              f"{shape['threads']} threads per tile, {shape['registers']} registers, "
              f"{shape['local_bytes']} local bytes a thread, {shape['shared_bytes']} shared "
              f"bytes a block, {shape['blocks_per_sm']} blocks per SM, {shape['clusters']} "
              f"clusters resident")
        for k in kernels[-3:]:
            phase("time", f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
                  f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), library none")

        # B3 at the 2DGS adjoint's shapes: B8's 18 rows read through the sort
        # of the disks' slot keys, as train_step_surfel's adjoint calls it.
        n = params["means3d"].shape[0]
        cap = cfg_cuda.tile_capacity
        slot_gids = segment_slice_gather(
            bins.gaussian_ids, bins.tile_ranges.reshape(-1, 2)[:, 0].contiguous(), cap)
        live = (torch.arange(cap, device=dev)[None, :] < counts[:, None]).reshape(-1)
        keys, perm = torch.sort(torch.where(live, slot_gids.clamp(0, n - 1), n), stable=True)
        cols = d_pdata.index_select(1, perm).contiguous()
        seg = segment_sum_cols(d_pdata, keys, n, perm=perm)
        err = b3_bit_equal("B3 (2DGS)", seg, cols, keys, n)
        if not torch.equal(segment_sum_cols(d_pdata, keys, n, perm=perm), seg):
            raise AssertionError("B3 (2DGS): two runs differ")
        n_live, nf = int(live.sum()), d_pdata.shape[0]
        routed = nf * n_live
        b3 = next(k for k in kernels if k["name"].startswith("B3"))
        b3["fields_18"] = dict(
            fields=nf, live=n_live, max_abs_err=err,
            ms=cuda_ms(lambda: segment_sum_cols(d_pdata, keys, n, perm=perm), 20, 3),
            ms_queued=cuda_ms_queued(
                lambda: segment_sum_cols(d_pdata, keys, n, perm=perm), 20, 3),
            **bound(4 * (routed + 2 * n_live + keys.numel() + nf * n), routed),
            adjoint_ms=adjoint_ms(slot_gids, counts, d_pdata, nf, n))
        f18 = b3["fields_18"]
        phase("B3", f"at the 2DGS adjoint's shapes: {nf} x {keys.shape[0]} values through "
              f"perm ({n_live} live) -> {n} segments: bit-equal to the plain version on the "
              f"CPU, two runs bitwise equal; {f18['ms']:.4f} ms, queued {f18['ms_queued']:.4f} "
              f"ms a call, bound {f18['bound_ms']:.4f} ms; "
              f"the gather adjoint {f18['adjoint_ms']['ms']:.4f} ms a call, "
              f"{f18['adjoint_ms']['ms_queued']:.4f} queued")
        del bins, colors, pdata, counts, out, resid, gout, d_pdata, d_want
        del slot_gids, live, keys, perm, cols, seg

    # ---- 10. The main path, serving: render the disks on the "cuda" route
    counters = {"B4": segment_expand_offsets, "B5": segment_slice_gather, "B1": raster_tiles,
                "B2": raster_tiles_bwd, "B3": segment_sum_cols, "B8": raster_surfel_tiles_bwd}

    def reset_counters():
        for fn in counters.values():
            fn.launches = 0
        raster_surfel_tiles_fwd.launches = raster_surfel_tiles_fwd.launches_maps = 0
        raster_surfel_tiles_fwd.residuals = 0

    def read_counters():
        out = {k: fn.launches for k, fn in counters.items()}
        out["B6"] = raster_surfel_tiles_fwd.launches
        out["B7"] = raster_surfel_tiles_fwd.launches_maps
        out["residuals"] = raster_surfel_tiles_fwd.residuals
        return out

    def render(p, config, camera=cam, background=BACKGROUND, maps=True, **kw):
        return render_surfels(*(p[k] for k in KEYS), camera, sh_degree=sh_degree,
                              background_color=background, config=config, return_depth=maps,
                              return_normals=maps, return_distortion=maps, **kw)

    def expect(what, launched, launched_set, silent):
        if min(launched[k] for k in launched_set) < 1 or max(launched[k] for k in silent):
            raise AssertionError(f"{what}: launches {launched}; expected {launched_set} "
                                 f"and none of {silent}")

    names = ("image", "depth", "normals", "distortion", "final T")
    launches = {}
    with torch.no_grad():
        for maps in (True, False):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counters()
            outs = render(params, cfg_cuda, maps=maps, return_aux=True)
            torch.cuda.synchronize()
            launched = read_counters()
            peak = torch.cuda.max_memory_allocated(dev)
            kid = "B7" if maps else "B6"
            launches[kid] = launched[kid]
            phase("2dgs-render", f"{'with' if maps else 'without'} maps, launches {launched}")
            expect("2dgs-render", launched, ("B4", "B5", kid),
                   ("B6" if maps else "B7", "B8", "B1", "B2", "B3", "residuals"))
            if outs[0].shape != (H, W, 3) or not all(bool(torch.isfinite(x).all())
                                                     for x in outs[:-1]):
                raise AssertionError("2dgs-render: bad image shape or non-finite output")
            counts_cuda = drop_counters(outs[-1])
            outs_t = render(params, cfg_torch, maps=maps, return_aux=True)
            counts_torch = drop_counters(outs_t[-1])
            if counts_torch != counts_cuda:
                raise AssertionError(f"route counters differ: {counts_torch} vs {counts_cuda}")
            phase("2dgs-render", "counters " + json.dumps(counts_cuda) + ", both routes")
            got = list(outs[:-1]) + [outs[-1].raster.final_transmittance]
            want = list(outs_t[:-1]) + [outs_t[-1].raster.final_transmittance]
            for name, a, b in zip(names if maps else names[:1] + names[-1:], got, want):
                blend_agreement(f"2dgs {name} vs torch route", a, b, row_scale(b, (0, 1)),
                                ROUTE_MAX_SHARE, ROUTE_MAX_ERR)
            del outs_t, got, want
            ms = cuda_ms(lambda: render(params, cfg_cuda, maps=maps), 10, 1)
            torch_ms = cuda_ms(lambda: render(params, cfg_torch, maps=maps), 3, 1)
            phase("2dgs-render", f"{'with' if maps else 'without'} maps: median of 10 "
                  f"{ms:.3f} ms ({H * W / (ms / 1e3):.1f} pixels/s), torch route {torch_ms:.3f} "
                  f"ms (median of 3); peak memory of one cuda-route render {peak} bytes")
        # train_step_surfel renders on the default (black) background.
        target = render(params, cfg_cuda, background=None, maps=False)

    # ---- 11. The main path, training: 10 Adam steps on the disks
    leaves = perturbed_leaves(disks, dev)
    opt = make_optimizer(leaves, lr=TRAIN_LR)
    phase("2dgs-train", f"Adam lr {TRAIN_LR}, {json.dumps(SURFEL_WEIGHTS)}; the disks' raw "
          f"parameters perturbed as in phase 7; target: the cuda-route render of the "
          f"unperturbed disks")
    losses, step_ms, launched_step, peak_step = train_steps(
        lambda: train_step_surfel(leaves, opt, [cam], target[None], sh_degree=sh_degree,
                                  config=cfg_cuda, **SURFEL_WEIGHTS),
        reset_counters, read_counters, dev)
    with torch.no_grad():
        final = float(surfel_loss(leaves, [cam], target[None], sh_degree, cfg_cuda,
                                  **SURFEL_WEIGHTS))
    phase("2dgs-train", "loss per step " + ", ".join(f"{x:.6e}" for x in losses)
          + f"; after step {TRAIN_STEPS}: {final:.6e}")
    phase("2dgs-train", f"launches during one step: {launched_step}")
    if not all(np.isfinite(losses)) or not np.isfinite(final) or not final < losses[0]:
        raise AssertionError("2dgs-train: the loss is not finite or did not fall")
    expect("2dgs-train", launched_step, ("B3", "B4", "B5", "B7", "B8"), ("B1", "B2", "B6"))
    med = statistics.median(step_ms)
    phase("2dgs-train", f"step time median of {TRAIN_STEPS} {med:.3f} ms (steps "
          + ", ".join(f"{x:.3f}" for x in step_ms) + f"), {1e3 / med:.3f} steps/s; "
          f"peak memory of one step {peak_step} bytes")

    def grads_of(p, config, camera, tgt):
        for t in p.values():
            t.grad = None
        surfel_loss(p, [camera], tgt[None], sh_degree, config, **SURFEL_WEIGHTS).backward()
        return {k: t.grad.clone() for k, t in p.items()}

    check_bitwise(lambda: grads_of(leaves, cfg_cuda, cam, target), "2dgs-train")
    del opt

    # Both routes at a quarter of the resolution and every 4th disk.
    small = {k: v.detach()[::4].contiguous() for k, v in leaves.items()}
    cam_s = scene_camera(H // 4, W // 4, device=dev)
    with torch.no_grad():
        target_s = render(activate({k: v[::4] for k, v in disks_dev.items()}), cfg_cuda, cam_s,
                          background=None, maps=False)
    routes = {}
    for name, config in (("cuda", cfg_cuda), ("torch", cfg_torch)):
        p = {k: v.clone().requires_grad_(True) for k, v in small.items()}
        routes[name] = grads_of(p, config, cam_s, target_s)
    for k in routes["cuda"]:
        grad_agreement(f"2dgs-train d {k} cuda vs torch route ({small['means3d'].shape[0]} "
                       f"disks, {H // 4}x{W // 4})", routes["cuda"][k][None],
                       routes["torch"][k][None], ROUTE_GRAD_MAX_SHARE, ROUTE_GRAD_MAX_REL)
    del routes, small, leaves

    for k in kernels:
        kid = k["name"][:2]
        if kid in ("B3", "B4", "B5"):
            k["launches_2dgs_step"] = launched_step[kid]
        elif kid == "B6":
            k["launches"] = launches["B6"]  # its path: the render without maps
        elif kid in ("B7", "B8"):
            k["launches"] = launched_step[kid]
            if kid == "B7":
                k["launches_render"] = launches["B7"]


def probe_phase(kernels: list) -> None:
    """Phase 12: B9, the blend-variant probe, at the reference probe's
    configuration (scripts/port_kernel_probe.py). The probe's path runs each
    variant once, its counter set to 0 just before; then each variant's
    output is held against its plain version and timed. Appends one
    kernels entry per variant, each with B1's bound at these shapes."""
    from mojosplat_tpu_torch.ops.raster_cuda import raster_tiles, raster_tiles_fwd
    from mojosplat_tpu_torch.ops.raster_probe import (
        PROBE_CHUNK, VARIANTS, raster_variant, raster_variant_plain)

    spec = importlib.util.spec_from_file_location(
        "port_kernel_probe", ROOT / "scripts" / "port_kernel_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    dev = torch.device("cuda", 0)
    pdata, counts, ts, tw, cfg = probe.probe_inputs(dev)
    rows, n_tiles = pdata.shape[0], counts.shape[0]
    with torch.no_grad():
        raster_variant.launches = 0
        outs, launched = {}, {}
        for v in VARIANTS:
            before = raster_variant.launches
            outs[v] = raster_variant(v, pdata, counts, ts, tw, cfg, PROBE_CHUNK)
            launched[v] = raster_variant.launches - before
        torch.cuda.synchronize()
        phase("B9", f"pdata {tuple(pdata.shape)}, {int(counts.sum())} slots; launches of the "
              f"probe's path {json.dumps(launched)}")
        if min(launched.values()) < 1:
            raise AssertionError("B9: a variant of the probe was not launched")
        if not torch.equal(outs["full"], raster_tiles(pdata, counts, ts, tw, cfg)):
            raise AssertionError("B9: the probe's full variant differs from B1")
        phase("B9", "parity " + " ".join(f"{k}={v:.3e}" for k, v in probe.parity(outs).items()))
        _, resid = raster_tiles_fwd(pdata, counts, ts, tw, cfg, residual=True)
        pairs = int(torch.minimum(resid[1], counts[:, None]).sum())
        b1_bound = bound(4 * (rows * int(counts.sum()) + n_tiles + outs["full"].numel()),
                         B1_OPS_PER_PAIR * pairs, pairs)
        del resid
        for v in VARIANTS:
            want = raster_variant_plain(v, pdata, counts, ts, tw, cfg, PROBE_CHUNK)
            scale = want.abs().amax(dim=(0, 2), keepdim=True).clamp(min=1e-30)
            rule = {}
            if v in ("blend", "memonly"):
                rule = dict(max_share=0.0, max_err=ROW_SUM_MAX_REL)
            elif v in ("blend1", "blend3"):
                rule = dict(atol=BF16_ATOL)
                moved, moved_b1 = (float(((want - outs["full"]).abs() / scale > a).float().mean())
                                   for a in (BF16_ATOL, BLEND_ATOL))
                phase(f"B9 {v}", f"the plain version differs from full by more than "
                      f"{BF16_ATOL} of the scale on {moved:.4e} of the values, by more than "
                      f"{BLEND_ATOL} on {moved_b1:.4e}")
                if moved < BF16_MIN_MOVED:
                    raise AssertionError(f"B9 {v}: the compare cannot tell it from full")
            err = blend_agreement(f"B9 {v}", outs[v], want, scale, **rule)
            del want
            kernels.append(dict(
                name=f"B9 raster_variant ({v})", route="cuda",
                source="mojosplat_tpu_torch/csrc/raster_fwd.cu",
                replaces="scripts/dev_kernel_probe.py:177",
                launches=launched[v], launches_train=0, max_abs_err=err,
                ms=cuda_ms(lambda v=v: raster_variant(v, pdata, counts, ts, tw, cfg,
                                                      PROBE_CHUNK), 20, 3),
                plain_ms=cuda_ms(lambda v=v: raster_variant_plain(
                    v, pdata, counts, ts, tw, cfg, PROBE_CHUNK), 3, 1),
                **b1_bound, library_ms=None,
            ))
            k = kernels[-1]
            phase("time", f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
                  f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), library none")
    del outs, pdata, counts


def mcmc_repeats(leaves: dict, gen, cam, target, sh_degree: int, cfg, mcfg) -> None:
    """Each part of an MCMC step run twice from the same state and
    generator state must give bitwise-equal results: the relocation, the
    position noise and the loss's gradients. Also prints how many of
    torch.multinomial's draws move between two runs on the relocation's
    weights (the port draws through densify._categorical instead). Leaves
    ``leaves`` and ``gen`` as they were."""
    from mojosplat_tpu_torch import render_gaussians
    from mojosplat_tpu_torch.densify import (
        mcmc_position_noise, mcmc_regularization, mcmc_relocate)
    from mojosplat_tpu_torch.train import activate, l2_image_loss

    def twice(fn):
        out = []
        for _ in range(2):
            g = torch.Generator(device=gen.device)
            g.set_state(gen.get_state())
            out.append(fn(g))
        return out

    a, b = twice(lambda g: mcmc_relocate(leaves, g, mcfg)[0])
    a2, b2 = twice(lambda g: mcmc_position_noise(leaves, g, TRAIN_LR, mcfg))
    for what, x, y in (("mcmc_relocate", a, b), ("mcmc_position_noise", a2, b2)):
        if any(not torch.equal(x[k], y[k]) for k in x):
            raise AssertionError(f"densify: two runs of {what} differ")
    del a, b, a2, b2

    def grads(_):
        for t in leaves.values():
            t.grad = None
        p = activate(leaves)
        img = render_gaussians(*(p[k] for k in KEYS), cam, sh_degree=sh_degree, config=cfg)
        (l2_image_loss(img, target) + mcmc_regularization(leaves, mcfg)).backward()
        out = {k: t.grad.clone() for k, t in leaves.items()}
        for t in leaves.values():
            t.grad = None
        return out

    g1, g2 = twice(grads)
    if any(not torch.equal(g1[k], g2[k]) for k in g1):
        raise AssertionError("densify: two backward passes of the MCMC loss differ")
    with torch.no_grad():
        opac = torch.sigmoid(leaves["opacities_raw"])
        w = torch.where(opac >= mcfg.min_opacity, opac.clamp(min=1e-12), torch.zeros_like(opac))
    d1, d2 = twice(lambda g: torch.multinomial(w, w.numel(), replacement=True, generator=g))
    phase("densify", "two runs from one state and generator state: mcmc_relocate, "
          "mcmc_position_noise and the MCMC loss's gradients bitwise equal; "
          f"torch.multinomial on the relocation's weights: {int((d1 != d2).sum())} of "
          f"{d1.numel()} draws differ")


def densify_phase(raw: dict, sh_degree: int, counters: dict) -> dict:
    """Phase 13: density control at 1M capacity. Every other gaussian of
    the trained scene, padded to DENSIFY_CAPACITY slots, trains towards the
    "cuda"-route render of the whole scene at DENSIFY_W x DENSIFY_H: ADC
    steps of train_step_with_densify_stats (absgrad, Adam) with a
    densify_and_prune event every ADC_EVERY steps, then MCMC steps
    (train_step with mcmc_regularization in the loss, mcmc_position_noise
    after each step, mcmc_relocate every MCMC_EVERY). The optimizer starts
    afresh after each event. Fails on a non-finite loss or parameter or an
    alive count above the capacity. Returns each kernel's launches during
    the phase (counters: name -> wrapper)."""
    from mojosplat_tpu_torch import RenderConfig, render_gaussians
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.densify import (
        DensifyConfig, DensifyState, MCMCConfig, alive_mask, densify_and_prune,
        mcmc_position_noise, mcmc_regularization, mcmc_relocate, pad_to_capacity)
    from mojosplat_tpu_torch.train import (
        activate, make_optimizer, train_step, train_step_with_densify_stats)
    from mojosplat_tpu_torch.utils.scenes import scene_camera

    dev = torch.device("cuda", 0)
    cfg = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS)
    cam = scene_camera(DENSIFY_H, DENSIFY_W, device=dev)
    with torch.no_grad():
        full = activate(params_from_numpy(raw, dev))
        target = render_gaussians(*(full[k] for k in KEYS), cam, sh_degree=sh_degree,
                                  config=cfg)
        del full
    half = params_from_numpy({k: v[::2] for k, v in raw.items()}, dev)
    leaves = {k: v.requires_grad_(True)
              for k, v in pad_to_capacity(half, DENSIFY_CAPACITY).items()}
    gen = torch.Generator(device=dev).manual_seed(DENSIFY_SEED)
    phase("densify", f"{half['means3d'].shape[0]} gaussians padded to {DENSIFY_CAPACITY} "
          f"slots, {DENSIFY_W}x{DENSIFY_H}, target: the cuda-route render of the "
          f"{raw['means3d'].shape[0]}-gaussian scene; Adam lr {TRAIN_LR}")
    del half

    def assign(new):
        with torch.no_grad():
            for k, t in leaves.items():
                t.copy_(new[k])

    def check(what):
        bad = [k for k, t in leaves.items() if not bool(torch.isfinite(t).all())]
        alive = int(alive_mask(leaves).sum())
        if bad or alive > DENSIFY_CAPACITY:
            raise AssertionError(f"densify: {what}: non-finite {bad} or {alive} alive")
        return alive

    def timed(step):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step()
        end.record()
        torch.cuda.synchronize()
        if not np.isfinite(float(loss)):
            raise AssertionError(f"densify: non-finite loss {float(loss)}")
        return float(loss), start.elapsed_time(end)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in counters.values():
        fn.launches = 0
    opt = make_optimizer(leaves, lr=TRAIN_LR)
    dstate = DensifyState.zero(DENSIFY_CAPACITY, dev)
    adc_losses, adc_ms = [], []
    for i in range(1, ADC_STEPS + 1):
        def adc_step():
            nonlocal dstate
            dstate, loss = train_step_with_densify_stats(
                leaves, opt, dstate, [cam], target[None], sh_degree=sh_degree, config=cfg,
                absgrad=True)
            return loss
        loss, ms = timed(adc_step)
        adc_losses.append(loss)
        adc_ms.append(ms)
        if i % ADC_EVERY == 0:
            before = check(f"before the ADC event at step {i}")
            seen = alive_mask(leaves) & (dstate.count > 0)
            mean = (dstate.grad_accum / dstate.count.clamp(min=1))[seen]
            threshold = float(torch.quantile(mean, DENSIFY_QUANTILE)) if mean.numel() else 1.0
            new, dstate, m = densify_and_prune(leaves, dstate, gen, SCENE_EXTENT,
                                               DensifyConfig(grad_threshold=threshold))
            assign(new)
            del new
            opt = make_optimizer(leaves, lr=TRAIN_LR)
            alive = check(f"ADC event at step {i}")
            m = {k: int(v) for k, v in m.items()}
            # The reference's ADC fills the free slots in index order, so a
            # clone or split child written into a slot pruned in the same
            # event dies with it (its split parent still shrinks).
            lost = before - m["pruned"] + m["cloned"] + m["split"] - alive
            phase("densify", f"ADC event after step {i}: grad_threshold {threshold:.4e}, "
                  + ", ".join(f"{k} {v}" for k, v in m.items())
                  + f"; alive {before} -> {alive}; written gaussians lost to the same "
                  f"event's prune {lost}")
    mcfg = MCMCConfig()
    launched = {k: fn.launches for k, fn in counters.items()}
    mcmc_repeats(leaves, gen, cam, target, sh_degree, cfg, mcfg)
    for k, fn in counters.items():  # the check's launches are not the path's
        fn.launches = launched[k]
    mcmc_losses, mcmc_ms = [], []
    for i in range(1, MCMC_STEPS + 1):
        def mcmc_step():
            loss = train_step(leaves, opt, [cam], target[None], sh_degree=sh_degree, config=cfg,
                              loss_extra=lambda p: mcmc_regularization(p, mcfg))
            assign(mcmc_position_noise(leaves, gen, TRAIN_LR, mcfg))
            return loss
        loss, ms = timed(mcmc_step)
        mcmc_losses.append(loss)
        mcmc_ms.append(ms)
        if i % MCMC_EVERY == 0:
            before = check(f"before the MCMC event at step {i}")
            new, m = mcmc_relocate(leaves, gen, mcfg)
            assign(new)
            del new
            opt = make_optimizer(leaves, lr=TRAIN_LR)
            alive = check(f"MCMC event at step {i}")
            phase("densify", f"MCMC relocation after step {i}: "
                  + ", ".join(f"{k} {int(v)}" for k, v in m.items())
                  + f" (above min_opacity before the move); alive by the mask {before} -> "
                  f"{alive}")
    torch.cuda.synchronize()
    launched = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    check("the end")
    phase("densify", f"ADC loss {adc_losses[0]:.6e} at step 1 -> {adc_losses[-1]:.6e} at step "
          f"{ADC_STEPS}; MCMC loss {mcmc_losses[0]:.6e} -> {mcmc_losses[-1]:.6e}")
    phase("densify", f"median step: ADC {statistics.median(adc_ms):.3f} ms, MCMC "
          f"{statistics.median(mcmc_ms):.3f} ms (CUDA events; the MCMC step includes the "
          f"position noise); peak memory {peak} bytes; launches during the phase "
          f"{json.dumps(launched)}")
    if min(launched[k] for k in ("B1", "B2", "B3", "B4", "B5")) < 1 or launched["B9"]:
        raise AssertionError(f"densify: launches {launched}")
    del leaves, opt, dstate, target
    return launched


def camera_phase(raw: dict, sh_degree: int, counters: dict, kernels: list, smi: str) -> dict:
    """Phase 14: the camera models on the trained scene at H x W, preset 6
    with tight_cull, on the "cuda" route. Renders the pinhole (EWA and UT),
    the fisheye, the rolling-shutter pinhole and the ortho camera, each
    against the "torch" route; trains ten Adam steps of the gaussians and a
    pose delta on the rolling fisheye; and renders ortho disks without the
    maps through B6 and B8. Returns the launches of B1-B5 in one pose step
    and of B6 and B8 on the ortho disks' path (counters: name -> wrapper
    of B4, B5, B1, B2, B3, B9)."""
    from mojosplat_tpu_torch import (
        Camera, RenderConfig, apply_pose_delta, render_gaussians, render_surfels)
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.ops.binning import num_tiles
    from mojosplat_tpu_torch.ops.sh import sh_to_color
    from mojosplat_tpu_torch.ops.surfel_cuda import (
        raster_surfel_tiles, raster_surfel_tiles_bwd, raster_surfel_tiles_bwd_plain,
        raster_surfel_tiles_fwd, raster_surfel_tiles_plain)
    from mojosplat_tpu_torch.surfel import bin_surfels, pack_surfel_tiles
    from mojosplat_tpu_torch.train import activate, l2_image_loss
    from mojosplat_tpu_torch.utils.scenes import scene_camera

    dev = torch.device("cuda", 0)
    cfg_cuda = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS)
    cfg_torch = RenderConfig(raster_impl="torch", tile_batch=256, **SCENE_BUDGETS)
    cfg_plain = RenderConfig(raster_impl="cuda", tile_batch=128, **SCENE_BUDGETS)
    ut = dict(projection_mode="ut")
    raw_dev = params_from_numpy(raw, dev)
    params = activate(raw_dev)
    base = scene_camera(H, W, device=dev)
    with torch.no_grad():
        xc = params["means3d"] @ base.R.T + base.T
        lo, hi = (float(v) for v in torch.quantile(
            xc[:, 0], torch.tensor([0.01, 0.99], device=dev)))
        mid_y = float(torch.median(xc[:, 1]))
        del xc
    ortho_f = ORTHO_FILL * W / (hi - lo)

    def cameras(h, w):
        """The scene camera's pose with each camera model at h x w (the
        focal lengths scale with w)."""
        s = w / W
        pose = dict(R=base.R, T=base.T, H=h, W=w, device=dev)
        pin = dict(fx=base.fx * s, fy=base.fy * s, cx=w / 2, cy=h / 2)
        fish = dict(fx=(w / 2) / (math.pi / 3), fy=(w / 2) / (math.pi / 3), cx=w / 2,
                    cy=h / 2, camera_model="fisheye", dist=FISHEYE_K + (0.0,))
        return {
            "pinhole": Camera.create(**pose, **pin),
            "fisheye": Camera.create(**pose, **fish),
            "rolling": Camera.create(**pose, **pin, shutter="rolling", rs_vel=RS_VEL),
            "ortho": Camera.create(**pose, fx=ortho_f * s, fy=ortho_f * s,
                                   cx=w / 2 - ortho_f * s * (lo + hi) / 2,
                                   cy=h / 2 - ortho_f * s * mid_y, camera_model="ortho"),
            "rolling fisheye": Camera.create(**pose, **fish, shutter="rolling", rs_vel=RS_VEL),
        }

    cams = cameras(H, W)
    phase("cameras", f"{smi}; {H}x{W}, preset 6 with tight_cull; fisheye fx = fy = "
          f"{float(cams['fisheye'].fx):.3f} (60 degrees at the edge), k = {FISHEYE_K}; rolling "
          f"shutter rs_vel = {RS_VEL}; ortho fx = fy = {ortho_f:.3f} px per world unit (the "
          f"centres' x spread {hi - lo:.4f} between its 1st and 99th percentiles fills "
          f"{ORTHO_FILL} of the width)")

    def reset():
        for fn in counters.values():
            fn.launches = 0
        raster_surfel_tiles_fwd.launches = raster_surfel_tiles_fwd.launches_maps = 0
        raster_surfel_tiles_bwd.launches = 0

    def read():
        out = {k: fn.launches for k, fn in counters.items()}
        out["B6"] = raster_surfel_tiles_fwd.launches
        out["B7"] = raster_surfel_tiles_fwd.launches_maps
        out["B8"] = raster_surfel_tiles_bwd.launches
        return out

    def expect(what, launched, needed, silent):
        if min(launched[k] for k in needed) < 1 or max(launched[k] for k in silent):
            raise AssertionError(f"{what}: launches {launched}; expected {needed} and none "
                                 f"of {silent}")

    def render(p, camera, config, background=BACKGROUND, **kw):
        return render_gaussians(*(p[k] for k in KEYS), camera, sh_degree=sh_degree,
                                background_color=background, config=config, **kw)

    # The renders, each against the "torch" route.
    with torch.no_grad():
        for name, cam_name, extra in (("pinhole EWA", "pinhole", {}), ("pinhole UT", "pinhole", ut),
                                      ("fisheye", "fisheye", {}), ("rolling", "rolling", {}),
                                      ("ortho", "ortho", {})):
            camera = cams[cam_name]
            config = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS, **extra)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset()
            image, aux = render(params, camera, config, return_aux=True)
            torch.cuda.synchronize()
            launched, peak = read(), torch.cuda.max_memory_allocated(dev)
            expect(f"cameras {name}", launched, ("B4", "B5", "B1"),
                   ("B2", "B3", "B9", "B6", "B7", "B8"))
            if image.shape != (H, W, 3) or not bool(torch.isfinite(image).all()):
                raise AssertionError(f"cameras {name}: bad image or non-finite")
            counts_cuda = drop_counters(aux)
            config_t = dataclasses.replace(config, raster_impl="torch", tile_batch=256)
            image_t, aux_t = render(params, camera, config_t, return_aux=True)
            if drop_counters(aux_t) != counts_cuda:
                raise AssertionError(f"cameras {name}: route counters differ: "
                                     f"{drop_counters(aux_t)} vs {counts_cuda}")
            err = blend_agreement(f"cameras {name} vs torch route", image, image_t)
            del image_t, aux_t
            ms = cuda_ms(lambda: render(params, camera, config), 10, 1)
            phase("cameras", f"{name}: median of 10 {ms:.3f} ms ({H * W / (ms / 1e3):.1f} "
                  f"pixels/s); launches B4 {launched['B4']}, B5 {launched['B5']}, B1 "
                  f"{launched['B1']}, B2 {launched['B2']}, B3 {launched['B3']}; counters "
                  f"{json.dumps(counts_cuda)}; peak memory {peak} bytes; max abs diff from "
                  f"the torch route {err:.3e}; image mean {float(image.mean()):.5f}")
        del image, aux

    # Pose refinement: the gaussians and a (6,) pose delta, ten Adam steps.
    cam_true = cams["rolling fisheye"]
    error = torch.tensor(POSE_ERROR, device=dev)
    with torch.no_grad():
        target = render(params, cam_true, cfg_cuda, background=None)
    cam_bad = apply_pose_delta(cam_true, error)
    leaves = perturbed_leaves(raw, dev)
    delta = torch.zeros(6, device=dev, requires_grad=True)
    opt = torch.optim.Adam([{"params": list(leaves.values()), "lr": TRAIN_LR},
                            {"params": [delta], "lr": POSE_LR}])

    def pose_loss(p, d, camera, config, tgt):
        return l2_image_loss(render(activate(p), apply_pose_delta(camera, d), config,
                                    background=None), tgt)

    def pose_step():
        opt.zero_grad(set_to_none=True)
        loss = pose_loss(leaves, delta, cam_bad, cfg_cuda, target)
        loss.backward()
        opt.step()
        return loss.detach()

    phase("cameras-pose", f"the rolling fisheye started off by {POSE_ERROR}; Adam lr "
          f"{TRAIN_LR} on the perturbed gaussians (as phase 7), {POSE_LR} on the pose delta; "
          f"target: the cuda-route render through the true camera")
    losses, step_ms, launched_pose, peak_pose = train_steps(pose_step, reset, read, dev)
    with torch.no_grad():
        final = float(pose_loss(leaves, delta, cam_bad, cfg_cuda, target))
    med = statistics.median(step_ms)
    phase("cameras-pose", "loss per step " + ", ".join(f"{x:.6e}" for x in losses)
          + f"; after step {TRAIN_STEPS}: {final:.6e}; delta "
          + ", ".join(f"{float(x):.3e}" for x in delta.detach()))
    phase("cameras-pose", f"step time median of {TRAIN_STEPS} {med:.3f} ms (steps "
          + ", ".join(f"{x:.3f}" for x in step_ms) + f"), {1e3 / med:.3f} steps/s; peak memory "
          f"of one step {peak_pose} bytes; launches during one step {json.dumps(launched_pose)}")
    if not all(np.isfinite(losses)) or not np.isfinite(final) or not final < losses[0]:
        raise AssertionError("cameras-pose: the loss is not finite or did not fall")
    expect("cameras-pose", launched_pose, ("B4", "B5", "B1", "B2", "B3"),
           ("B9", "B6", "B7", "B8"))

    def pose_grads(p, d, camera, config, tgt):
        for t in list(p.values()) + [d]:
            t.grad = None
        pose_loss(p, d, camera, config, tgt).backward()
        grads = {k: t.grad.clone() for k, t in p.items()}
        grads["pose"] = d.grad.clone()
        return grads

    check_bitwise(lambda: pose_grads(leaves, delta, cam_bad, cfg_cuda, target), "cameras-pose")
    del opt, target
    # Both routes at a quarter of the resolution and every 4th gaussian.
    small = {k: v.detach()[::4].contiguous() for k, v in leaves.items()}
    cams_s = cameras(H // 4, W // 4)
    cam_bad_s = apply_pose_delta(cams_s["rolling fisheye"], error)
    with torch.no_grad():
        target_s = render(activate({k: v[::4] for k, v in raw_dev.items()}),
                          cams_s["rolling fisheye"], cfg_cuda, background=None)
    routes = {}
    for name, config in (("cuda", cfg_cuda), ("torch", cfg_torch)):
        p = {k: v.clone().requires_grad_(True) for k, v in small.items()}
        d = delta.detach().clone().requires_grad_(True)
        routes[name] = pose_grads(p, d, cam_bad_s, config, target_s)
    for k in routes["cuda"]:
        grad_agreement(f"cameras-pose d {k} cuda vs torch route ({small['means3d'].shape[0]} "
                       f"gaussians, {H // 4}x{W // 4})", routes["cuda"][k][None],
                       routes["torch"][k][None])
    del routes, small, leaves, target_s

    # Ortho disks without the maps: B6 and B8 (aux=False) on ortho records.
    disks = params_from_numpy(dict(raw, scales=np.ascontiguousarray(raw["scales"][:, :2])), dev)
    dparams = activate(disks)
    cam_o = cams["ortho"]
    geometry = [dparams[k] for k in ("means3d", "scales", "quats", "opacities")]
    ts = cfg_cuda.tile_size
    th, tw = num_tiles(H, W, ts)
    n_tiles, P = th * tw, ts * ts
    with torch.no_grad():
        bins = bin_surfels(*geometry, cam_o, cfg_cuda)
        colors = sh_to_color(dparams["features"], dparams["means3d"], cam_o.position, sh_degree)
        pdata, counts = pack_surfel_tiles(*geometry, colors, cam_o, bins, cfg_cuda, False)
        if not bool((pdata[5] == 0).all() and (pdata[8] == 0).all()):
            raise AssertionError("cameras-2dgs: the ortho records' a2, b2 rows are not 0")
        b6 = raster_surfel_tiles(pdata, counts, ts, tw, cfg_cuda, False)
        ref = raster_surfel_tiles_plain(pdata, counts, ts, tw, cfg_plain, False)
        err6 = blend_agreement("cameras-2dgs B6 (ortho)", b6, ref, row_scale(ref, (0, 2)))
        b6_r, resid = raster_surfel_tiles_fwd(pdata, counts, ts, tw, cfg_cuda, False, True)
        if not torch.equal(b6_r, b6):
            raise AssertionError("cameras-2dgs B6: the output changes when the residual is "
                                 "written")
        skips = surfel_skip_counts(pdata, counts, ts, tw, cfg_cuda, False, b6, resid)
        phase("cameras-2dgs", f"B6 on the ortho records: pdata {tuple(pdata.shape)}, "
              f"{int(counts.sum())} slots; row test skipped {skips['skipped']} of the "
              f"{skips['tested']} (pixel row, slot) pairs its warps tested, equal to the plain "
              f"mirror's count; output and residual bit-equal to the full walk's; of the "
              f"{skips['row_slots']} (row, slot) pairs below the counts no pixel keeps "
              f"{skips['row_slots_unkept']} and the row test skips {skips['row_slots_skipped']}, "
              f"none kept (brute force)")
        gout = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (n_tiles, 5, P), dtype=np.float32)).to(dev)
        d_pdata = raster_surfel_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda, False)
        d_want = raster_surfel_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg_plain, False)
        err8 = grad_agreement("cameras-2dgs B8 (ortho, without maps)", d_pdata, d_want)
        if not torch.equal(raster_surfel_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda,
                                                   False), d_pdata):
            raise AssertionError("cameras-2dgs B8: two runs differ")
        # The bounds as phase 9 counts them, on these records.
        rows, slots, need = pdata.shape[0], int(counts.sum()), skips["walked_may"]
        walked = torch.minimum(resid[1], counts[:, None])
        chunk_reads = int(((walked + 15) // 16).sum())
        row_tests = SURFEL_ROW_TEST_OPS * skips["tested"]
        row_sfu = SURFEL_ROW_TEST_SFU * skips["tested"]
        ortho_k = {
            "B6": dict(
                max_abs_err=err6, skips=skips,
                ms=cuda_ms(lambda: raster_surfel_tiles(pdata, counts, ts, tw, cfg_cuda, False),
                           20, 3),
                plain_ms=cuda_ms(lambda: raster_surfel_tiles_plain(
                    pdata, counts, ts, tw, cfg_plain, False), 3, 1),
                **bound(4 * (rows * slots + n_tiles + b6.numel()),
                        B6_OPS_PER_PAIR * need + row_tests, 2 * need + row_sfu)),
            "B8": dict(
                max_abs_err=err8,
                ms=cuda_ms(lambda: raster_surfel_tiles_bwd(
                    pdata, counts, gout, resid, ts, tw, cfg_cuda, False), 20, 3),
                plain_ms=cuda_ms(lambda: raster_surfel_tiles_bwd_plain(
                    pdata, counts, gout, ts, tw, cfg_plain, False), 3, 1),
                **bound(4 * (rows * slots + gout.numel() + chunk_reads + resid[1].numel()
                             + n_tiles + d_pdata.numel()),
                        B8_PLAIN_OPS_PER_PAIR * need + row_tests, 2 * need + row_sfu)),
        }
        phase("cameras-2dgs", "ortho records: " + ", ".join(
            f"{kid} {k['ms']:.4f} ms (plain {k['plain_ms']:.4f}, bound {k['bound_ms']:.4f} ms, "
            f"{k['bound_by']})" for kid, k in ortho_k.items())
            + "; kernels median of 20, plain of 3; B8 two runs bitwise equal")
        del bins, colors, pdata, counts, b6, ref, b6_r, resid, gout, d_pdata, d_want, walked

        # The render on both routes at full size.
        def render_disks(p, camera, config, **kw):
            return render_surfels(*(p[k] for k in KEYS), camera, sh_degree=sh_degree,
                                  background_color=BACKGROUND, config=config, **kw)

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        img, aux = render_disks(dparams, cam_o, cfg_cuda, return_aux=True)
        torch.cuda.synchronize()
        launched_render, peak = read(), torch.cuda.max_memory_allocated(dev)
        expect("cameras-2dgs render", launched_render, ("B4", "B5", "B6"),
               ("B7", "B8", "B1", "B2", "B3"))
        img_t, aux_t = render_disks(dparams, cam_o, cfg_torch, return_aux=True)
        if drop_counters(aux_t) != drop_counters(aux):
            raise AssertionError("cameras-2dgs: route counters differ")
        for name, a, b in (("image", img, img_t), ("final T", aux.raster.final_transmittance,
                                                    aux_t.raster.final_transmittance)):
            blend_agreement(f"cameras-2dgs ortho {name} vs torch route", a, b,
                            row_scale(b, (0, 1)), ROUTE_MAX_SHARE, ROUTE_MAX_ERR)
        del img_t, aux_t
        ms_disks = cuda_ms(lambda: render_disks(dparams, cam_o, cfg_cuda), 10, 1)
        phase("cameras-2dgs", f"ortho disks without maps: median of 10 {ms_disks:.3f} ms "
              f"({H * W / (ms_disks / 1e3):.1f} pixels/s); launches {json.dumps(launched_render)};"
              f" counters {json.dumps(drop_counters(aux))}; peak memory {peak} bytes")
        del img, aux
        # The "cuda" route raises where the reference's "pallas" route does.
        for what, camera, maps in (("fisheye", cams["fisheye"], False),
                                   ("ortho with the maps", cam_o, True)):
            try:
                render_disks(dparams, camera, cfg_cuda, return_depth=maps)
            except NotImplementedError:
                phase("cameras-2dgs", f"{what} on the cuda route: NotImplementedError, as the "
                      f"reference's pallas route")
            else:
                raise AssertionError(f"cameras-2dgs: {what} rendered on the cuda route")
        # The fisheye with the maps on the "torch" route, reduced.
        few = {k: v[::FISHEYE_DISK_STRIDE] for k, v in dparams.items()}
        fish_s = cameras(H // 4, W // 4)["fisheye"]
        outs = render_disks(few, fish_s, dataclasses.replace(cfg_torch, tile_batch=None),
                            return_depth=True, return_normals=True, return_distortion=True)
        if not all(bool(torch.isfinite(x).all()) for x in outs):
            raise AssertionError("cameras-2dgs: the fisheye's maps are not finite")
        phase("cameras-2dgs", f"fisheye with the maps on the torch route (reduced: every "
              f"{FISHEYE_DISK_STRIDE}th disk, {H // 4}x{W // 4}): finite; image mean "
              f"{float(outs[0].mean()):.5f}, depth max {float(outs[1].max()):.4f}")
        del few, outs

    # The backward of a seeded cotangent, both routes, a quarter of the size.
    # The "cuda" route is held to the "torch" route in float64: ortho disks
    # a quarter of the resolution are about 1.5 px across, so one pixel that
    # f32 rounding flips at a threshold moves a disk's gradient by up to a
    # few percent of the row's largest, in either f32 route.
    small = {k: v.detach()[::4].contiguous() for k, v in disks.items()}
    cot = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (H // 4, W // 4, 3), dtype=np.float32)).to(dev)
    routes = {}
    for name, config, dtype in (("cuda", cfg_cuda, torch.float32),
                                ("torch", cfg_torch, torch.float32),
                                ("float64", cfg_torch, torch.float64)):
        p = {k: v.to(dtype).clone().requires_grad_(True) for k, v in small.items()}
        camera = dataclasses.replace(cams_s["ortho"], **{
            f.name: getattr(cams_s["ortho"], f.name).to(dtype)
            for f in dataclasses.fields(cams_s["ortho"])
            if isinstance(getattr(cams_s["ortho"], f.name), torch.Tensor)})
        reset()
        (render_disks(activate(p), camera, config) * cot.to(dtype)).sum().backward()
        torch.cuda.synchronize()
        if name == "cuda":
            launched_bwd = read()
            expect("cameras-2dgs backward", launched_bwd, ("B3", "B4", "B5", "B6", "B8"),
                   ("B7", "B1", "B2"))
        routes[name] = {k: t.grad for k, t in p.items()}
    for k in routes["cuda"]:
        exact = routes["float64"][k]
        own = float(((routes["torch"][k].double() - exact).abs().max()
                     / (exact.abs().max() + 1e-30)))
        grad_agreement(f"cameras-2dgs ortho d {k} cuda route vs torch route in float64 "
                       f"({small['means3d'].shape[0]} disks, {H // 4}x{W // 4}; the f32 torch "
                       f"route's own distance from float64 {own:.3e} of the scale)",
                       routes["cuda"][k][None].double(), exact[None],
                       ROUTE_GRAD_MAX_SHARE, ROUTE_GRAD_MAX_REL)
    phase("cameras-2dgs", f"launches during the ortho disks' backward {json.dumps(launched_bwd)}")
    del routes, small, disks, dparams

    for k in kernels:
        kid = k["name"][:2]
        if kid in ortho_k:
            k["ortho_without_maps"] = ortho_k[kid]
    launches = {kid: launched_pose[kid] for kid in ("B1", "B2", "B3", "B4", "B5")}
    launches.update(B6=launched_bwd["B6"], B8=launched_bwd["B8"])
    return launches


def state_equal(got, want, path: str = "state") -> None:
    """Raise unless two nested training states (dicts, lists, tensors,
    numbers) are equal bit for bit, dtypes included."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{path}: keys {sorted(got)} != {sorted(want)}")
        for k in want:
            state_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{path}: {len(got)} items != {len(want)}")
        for j, (a, b) in enumerate(zip(got, want)):
            state_equal(a, b, f"{path}[{j}]")
    elif isinstance(want, torch.Tensor):
        if got.dtype != want.dtype or not torch.equal(got.to(want.device), want):
            raise AssertionError(f"{path}: tensors differ")
    elif got != want:
        raise AssertionError(f"{path}: {got!r} != {want!r}")


def rotmat_to_qvec(R: np.ndarray) -> np.ndarray:
    """A rotation matrix -> COLMAP's wxyz quaternion (w >= 0)."""
    w = math.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    x = math.copysign(math.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2.0,
                      R[2, 1] - R[1, 2])
    y = math.copysign(math.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2.0,
                      R[0, 2] - R[2, 0])
    z = math.copysign(math.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2.0,
                      R[1, 0] - R[0, 1])
    return np.array([w, x, y, z])


def write_capture(root: Path, raw: dict, sh_degree: int) -> dict:
    """Phase 15's capture (see its constants) under ``root``: the sparse
    model in root/sparse/0 and the targets in root/images, written with the
    port's own writers. Returns the view poses and the cloud."""
    from mojosplat_tpu_torch import Camera, RenderConfig, render_gaussians
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.ops.sh import _C0
    from mojosplat_tpu_torch.train import activate
    from mojosplat_tpu_torch.utils.colmap import (qvec_to_rotmat, write_cameras_bin,
                                                  write_images_bin, write_points3d_bin)
    from mojosplat_tpu_torch.utils.image import save_png
    from mojosplat_tpu_torch.utils.scenes import scene_camera

    dev = torch.device("cuda", 0)
    base = scene_camera(H, W, device="cpu")
    fx, cx, cy = float(base.fx), float(base.cx), float(base.cy)
    target = np.array([0.0, 0.4, 0.0])
    eye0 = (-base.R.double().T @ base.T.double()).numpy()
    poses = []
    for j in range(CAPTURE_VIEWS):
        yaw = math.radians(np.linspace(-CAPTURE_SPAN_DEG, CAPTURE_SPAN_DEG, 8)[j % 8])
        pitch = math.radians((-0.5, 0.5)[j // 8 % 2] * CAPTURE_SPAN_DEG)
        ry = np.array([[math.cos(yaw), 0, math.sin(yaw)], [0, 1, 0],
                       [-math.sin(yaw), 0, math.cos(yaw)]])
        rx = np.array([[1, 0, 0], [0, math.cos(pitch), -math.sin(pitch)],
                       [0, math.sin(pitch), math.cos(pitch)]])
        eye = target + ry @ rx @ (eye0 - target)
        forward = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(forward, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(forward, right), forward])
        q = rotmat_to_qvec(R)
        poses.append((f"view_{j:02d}.png", q, -qvec_to_rotmat(q) @ eye))

    sparse = root / "sparse" / "0"
    (root / "images").mkdir(parents=True, exist_ok=True)
    sparse.mkdir(parents=True, exist_ok=True)
    write_cameras_bin(str(sparse / "cameras.bin"), [(1, 1, W, H, (fx, fx, cx, cy))])

    # The SfM cloud: CAPTURE_POINTS of the scene's gaussians, their SH DC
    # as colour, each observed in every view where it projects in frame.
    n = raw["means3d"].shape[0]
    pick = np.random.default_rng(CAPTURE_SEED).choice(n, CAPTURE_POINTS, replace=False)
    xyz = raw["means3d"][pick].astype(np.float64)
    rgb = np.round(np.clip(raw["features"][pick, 0] * _C0 + 0.5, 0, 1) * 255).astype(np.uint8)
    tracks = [[] for _ in range(CAPTURE_POINTS)]
    images = []
    for j, (name, q, t) in enumerate(poses):
        pc = xyz @ qvec_to_rotmat(q).T + t
        z = pc[:, 2]
        u = fx * pc[:, 0] / np.where(z > 0, z, 1.0) + cx
        v = fx * pc[:, 1] / np.where(z > 0, z, 1.0) + cy
        seen = np.flatnonzero((z > 0) & (u >= 0) & (u < W) & (v >= 0) & (v < H))
        images.append((j + 1, q, t, 1, name, np.stack([u[seen], v[seen]], -1), seen + 1))
        for k, p in enumerate(seen):
            tracks[p].append((j + 1, k))
    write_images_bin(str(sparse / "images.bin"), images)
    write_points3d_bin(str(sparse / "points3D.bin"), xyz, rgb,
                       ids=np.arange(1, CAPTURE_POINTS + 1), tracks=tracks)

    # The targets: the "cuda" route's renders of the whole scene.
    p = activate(params_from_numpy(raw, dev))
    cfg = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS)
    for name, q, t in poses:
        cam = Camera.create(R=qvec_to_rotmat(q).astype(np.float32), T=t.astype(np.float32),
                            H=H, W=W, fx=fx, fy=fx, cx=cx, cy=cy, device=dev)
        with torch.no_grad():
            img = render_gaussians(*(p[k] for k in KEYS), cam, sh_degree=sh_degree, config=cfg)
        save_png(img.cpu().numpy(), str(root / "images" / name))
    return dict(xyz=xyz, rgb=rgb, views=len(poses),
                observations=sum(len(tr) for tr in tracks))


def capture_phase(raw: dict, sh_degree: int, counters: dict, smi: str) -> dict:
    """Phase 15: the COLMAP capture path through the port's entry points
    (see the constants above). Returns the launches of B1-B5 in a 3DGS step
    and of B3-B5, B7 and B8 in a 2DGS step (counters: name -> wrapper of
    B4, B5, B1, B2, B3, B9)."""
    from mojosplat_tpu_torch import native
    from mojosplat_tpu_torch.examples import eval_colmap, train_colmap
    from mojosplat_tpu_torch.ops.surfel_cuda import raster_surfel_tiles_bwd, raster_surfel_tiles_fwd
    from mojosplat_tpu_torch.utils import colmap as cm
    from mojosplat_tpu_torch.utils.checkpoint import restore_checkpoint
    from mojosplat_tpu_torch.utils.ply import load_gaussian_ply, save_gaussian_ply

    dev = torch.device("cuda", 0)
    counters = dict(counters, B8=raster_surfel_tiles_bwd)
    lib = native.get_native()
    if lib is None:
        raise AssertionError("capture: the native IO did not build (see the warning above)")
    phase("capture", f"native IO {Path(lib.__file__).relative_to(ROOT)}")
    root = ROOT / "build" / "capture"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    info = write_capture(root, raw, sh_degree)
    phase("capture", f"{info['views']} views at {W}x{H}, {CAPTURE_POINTS} SfM points, "
          f"{info['observations']} observations, written in {time.perf_counter() - t0:.2f} s "
          f"({sum(f.stat().st_size for f in root.rglob('*') if f.is_file()) / 1e6:.1f} MB)")

    # The readers: native against pure Python, bit for bit.
    sparse = str(root / "sparse" / "0")
    t0 = time.perf_counter()
    nat = (cm.read_cameras_bin(sparse + "/cameras.bin"), cm.read_images_bin(sparse + "/images.bin"),
           cm.read_points3d_bin(sparse + "/points3D.bin"))
    t_nat = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = (cm._read_cameras_python(sparse + "/cameras.bin"),
          cm._read_images_python(sparse + "/images.bin"),
          cm._read_points_python(sparse + "/points3D.bin"))
    t_py = time.perf_counter() - t0
    for a, b in zip(nat[0], py[0]):
        assert (a.camera_id, a.model_id, a.width, a.height) == (
            b.camera_id, b.model_id, b.width, b.height) and np.array_equal(a.params, b.params)
    for a, b in zip(nat[1], py[1]):
        assert (a.image_id, a.camera_id, a.name) == (b.image_id, b.camera_id, b.name)
        assert np.array_equal(a.qvec, b.qvec) and np.array_equal(a.tvec, b.tvec)
    assert len(nat[1]) == len(py[1]) == info["views"]
    for a, b in zip(nat[2], py[2]):
        assert np.array_equal(a, b)
    assert np.array_equal(nat[2][0], info["xyz"]) and np.array_equal(nat[2][1], info["rgb"])
    phase("capture", f"parsed: native readers {t_nat * 1e3:.1f} ms, Python readers "
          f"{t_py * 1e3:.1f} ms, equal arrays")
    scene = cm.load_scene(sparse)
    t0 = time.perf_counter()
    init = cm.init_gaussians_from_points(scene.points_xyz, scene.points_rgb, sh_degree=3)
    phase("capture", f"KNN init of {CAPTURE_POINTS} points (the Morton-window path past "
          f"131072): {time.perf_counter() - t0:.3f} s")

    # The runs, through main(argv) on the "cuda" route, each step's
    # launches read (and the counters set to 0) after it.
    def run(argv, kernels):
        log = dict(ms=[], launches=[])

        def reset():
            for fn in counters.values():
                fn.launches = 0
            raster_surfel_tiles_fwd.launches = raster_surfel_tiles_fwd.launches_maps = 0

        def on_step(step, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            launched = {k: fn.launches for k, fn in counters.items()}
            launched["B6"] = raster_surfel_tiles_fwd.launches
            launched["B7"] = raster_surfel_tiles_fwd.launches_maps
            if any(launched[k] != (1 if k in kernels else 0) for k in launched):
                raise AssertionError(f"capture: step {step} launched {launched}; "
                                     f"expected one each of {kernels} and nothing else")
            log["ms"].append((now - log["t"]) * 1e3)
            log["t"] = now
            reset()

        reset()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        log["t"] = time.perf_counter()
        result = train_colmap.main(["--data", str(root)] + argv, on_step=on_step)
        result["peak"] = torch.cuda.max_memory_allocated(dev)
        result.update(log)
        losses = np.array(result["losses"])
        if not np.isfinite(losses).all():
            raise AssertionError(f"capture: a non-finite loss in {losses}")
        med = statistics.median(log["ms"])
        phase("capture", f"{len(losses)} steps: median step {med:.2f} ms ({1e3 / med:.2f} "
              f"steps/s), peak device memory {result['peak'] / 2**30:.2f} GiB; events "
              + json.dumps(result["events"]) + f"; {smi}")
        return result

    out3 = root / "out_3dgs"
    kernels3 = ("B1", "B2", "B3", "B4", "B5")
    first = run(CAPTURE_3DGS + ["--out-dir", str(out3), "--steps", str(CAPTURE_STEPS),
                                "--ckpt-every", str(CAPTURE_STEPS)], kernels3)
    state_equal(restore_checkpoint(str(out3 / "ckpt"), dev), first["state"])
    phase("capture", f"the checkpoint at step {CAPTURE_STEPS} restores bit-equal: every "
          "parameter, the Adam and view-optimizer states, the view parameters and the "
          "generator (MCMC keeps no DensifyState)")
    second = run(CAPTURE_3DGS + ["--out-dir", str(out3), "--steps", str(CAPTURE_RESUME_STEPS),
                                 "--resume"], kernels3)
    losses = first["losses"] + second["losses"]
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    relocated = [f"{e['relocated']} at step {e['step']}"
                 for e in first["events"] + second["events"]]
    phase("capture", f"3DGS losses: first 10 mean {head:.6f}, last 10 mean {tail:.6f}; "
          f"MCMC relocations: {', '.join(relocated) or 'none'}")
    if not tail < head:
        raise AssertionError("capture: the 3DGS loss did not fall")
    vp = second["state"]["view_params"]
    moved = {"pose": float(vp["pose"].abs().max()),
             "expo": float((vp["expo"] - torch.eye(3, 4, device=dev)).abs().max()),
             "bgrid": float((vp["bgrid"] - vp["bgrid"].new_tensor(
                 [1, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0])).abs().max())}
    phase("capture", "view parameters off identity by (max abs) " + json.dumps(moved))
    if min(moved.values()) <= 0:
        raise AssertionError("capture: a view group stayed at identity")
    ply_path = str(out3 / "scene_final.ply")
    back = load_gaussian_ply(ply_path)
    for k, v in second["state"]["params"].items():
        if not np.array_equal(back[k], v.cpu().numpy()):
            raise AssertionError(f"capture: the final PLY's {k} differs from the parameters")
    phase("capture", "the final PLY reloads bit-equal to the final parameters")

    surf = run(CAPTURE_2DGS + ["--out-dir", str(root / "out_2dgs")],
               ("B3", "B4", "B5", "B7", "B8"))
    head2, tail2 = float(np.mean(surf["losses"][:10])), float(np.mean(surf["losses"][-10:]))
    phase("capture", f"2DGS losses: first 10 mean {head2:.6f}, last 10 mean {tail2:.6f}")
    if not tail2 < head2:
        raise AssertionError("capture: the 2DGS loss did not fall")

    evals = {}
    init_ply = str(root / "init.ply")
    save_gaussian_ply(init_ply, init)
    for name, ply, extra in (
            ("trained", ply_path, ["--appearance-opt", "bilagrid", "--appearance-steps",
                                   str(CAPTURE_EVAL_STEPS)]),
            ("initial SfM gaussians", init_ply, [])):
        t0 = time.perf_counter()
        evals[name] = eval_colmap.main(["--data", str(root), "--ply", ply, "--downscale", "1",
                                        "--every", str(CAPTURE_EVAL_EVERY)] + extra)
        phase("capture", f"eval, {name}, in {time.perf_counter() - t0:.2f} s: "
              + json.dumps(evals[name]))
    if not evals["trained"]["mean_psnr"] > evals["initial SfM gaussians"]["mean_psnr"]:
        raise AssertionError("capture: the trained scene's PSNR is not above the initial one")
    return {"3dgs": dict.fromkeys(kernels3, 1),
            "2dgs": dict.fromkeys(("B3", "B4", "B5", "B7", "B8"), 1)}


def write_blender_capture(root: Path, raw: dict, sh_degree: int) -> None:
    """Phase 16's Blender capture (see its constants) under ``root``: the
    "cuda" route's renders of the trained scene as straight-alpha RGBA."""
    from mojosplat_tpu_torch import Camera, RenderConfig, render_gaussians
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.train import activate
    from mojosplat_tpu_torch.utils.image import to_uint8
    from mojosplat_tpu_torch.utils.scenes import scene_camera
    from torch_scene_tools_cases import write_blender_split

    dev = torch.device("cuda", 0)
    S = BLENDER_SIZE
    base = scene_camera(S, S, device="cpu")
    target = np.array([0.0, 0.4, 0.0])
    eye0 = (-base.R.double().T @ base.T.double()).numpy()
    poses = []
    for j in range(BLENDER_TRAIN + BLENDER_TEST):
        yaw = math.radians(BLENDER_YAW_DEG * (2.0 * ((j * 0.6180339887) % 1.0) - 1.0))
        pitch = math.radians(BLENDER_PITCH_DEG * (2.0 * ((j * 0.7548776662 + 0.5) % 1.0) - 1.0))
        ry = np.array([[math.cos(yaw), 0, math.sin(yaw)], [0, 1, 0],
                       [-math.sin(yaw), 0, math.cos(yaw)]])
        rx = np.array([[1, 0, 0], [0, math.cos(pitch), -math.sin(pitch)],
                       [0, math.sin(pitch), math.cos(pitch)]])
        eye = target + ry @ rx @ (eye0 - target)
        forward = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(forward, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(forward, right), forward])
        poses.append((R.astype(np.float32), (-R @ eye).astype(np.float32)))
    p = activate(params_from_numpy(raw, dev))
    cfg = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS)
    fx = float(base.fx)

    def frame(R, T):
        cam = Camera.create(R=R, T=T, H=S, W=S, fx=fx, fy=fx, cx=S / 2, cy=S / 2, device=dev)
        with torch.no_grad():
            img, aux = render_gaussians(*(p[k] for k in KEYS), cam, sh_degree=sh_degree,
                                        config=cfg, return_aux=True)
        alpha = 1.0 - aux.raster.final_transmittance
        rgb = torch.clamp(img / torch.clamp(alpha, min=1e-6)[..., None], 0.0, 1.0)
        return to_uint8(torch.cat([rgb, alpha[..., None]], dim=-1).cpu().numpy())

    angle_x = 2.0 * math.atan(0.5 * S / fx)
    for split, sel in (("train", poses[:BLENDER_TRAIN]), ("test", poses[BLENDER_TRAIN:])):
        write_blender_split(str(root), split, sel, [frame(R, T) for R, T in sel], angle_x)


def scene_tools_phase(raw: dict, sh_degree: int, counters: dict, smi: str) -> dict:
    """Phase 16: the scene tools through their CLIs' ``main(argv)`` on the
    "cuda" route (see the constants above), and the profiling and metrics
    utilities. Returns, per kernel, its launches per unit of each tool
    that runs it (a render, frame, request, view or view-step; every count
    is checked exactly) (counters: name -> wrapper of B4, B5, B1, B2, B3,
    B9)."""
    sys.path.insert(0, str(ROOT / "tests"))  # the shared cases: numpy, no JAX
    from PIL import Image

    from mojosplat_tpu_torch import Camera, RenderConfig, look_at, render_gaussians
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.examples import (
        compress_scene, extract_mesh, orbit_demo, render_sample, train_blender, train_demo,
        train_surfel_demo, viewer)
    from mojosplat_tpu_torch.ops.binning import bin_gaussians_to_tiles
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.ops.rasterization import rasterize_dense_oracle, rasterize_gaussians
    from mojosplat_tpu_torch.ops.surfel_cuda import raster_surfel_tiles_bwd, raster_surfel_tiles_fwd
    from mojosplat_tpu_torch.train import activate, make_optimizer, train_step
    from mojosplat_tpu_torch.utils import (
        amortized_ms, annotate, compilation_count, load_gaussian_ply, roofline_report,
        save_gaussian_ply, to_uint8, trace)
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.mesh import tsdf_fuse
    from mojosplat_tpu_torch.utils.profiling import CHIP_PEAKS
    from mojosplat_tpu_torch.utils.scenes import scene_camera
    from torch_scene_tools_cases import (
        SPHERE_MEDIAN_VOXELS, SPHERE_P90_VOXELS, reconstruct_sphere)

    dev = torch.device("cuda", 0)
    fns = dict(counters, B8=raster_surfel_tiles_bwd)
    peaks = CHIP_PEAKS["h100"]
    if (peaks["hbm_gbps"] * 1e9, peaks["vpu_tflops"] * 1e12) != (HBM_BYTES_PER_S, F32_OPS_PER_S):
        raise AssertionError("tools: utils.profiling's H100 peaks differ from bound()'s")
    root = ROOT / "build" / "scene_tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    per_unit = {}

    def reset():
        for fn in fns.values():
            fn.launches = 0
        raster_surfel_tiles_fwd.launches = raster_surfel_tiles_fwd.launches_maps = 0

    def launched() -> dict:
        out = {k: fn.launches for k, fn in fns.items()}
        out["B6"] = raster_surfel_tiles_fwd.launches
        out["B7"] = raster_surfel_tiles_fwd.launches_maps
        return out

    def expect(name, got, per, kernels, tool=None):
        want = {k: per if k in kernels else 0 for k in got}
        if got != want:
            raise AssertionError(f"{name}: launched {got}; expected {per} each of {kernels} "
                                 "and nothing else")
        if tool:
            for k in kernels:
                per_unit.setdefault(k, {})[tool] = 1

    def read_png(src) -> np.ndarray:
        return np.asarray(Image.open(src).convert("RGB"))

    def stepper(name, per, kernels, tool):
        """An on_step hook: every step after the first (whose count also
        holds the CLI's target and initial renders) launches ``per`` of each
        of ``kernels`` and nothing else; each step's time."""
        log = dict(ms=[], t=0.0)

        def on_step(step, loss):
            torch.cuda.synchronize()
            now = time.perf_counter()
            if step:
                expect(f"{name} step {step}", launched(), per, kernels, tool)
            log["ms"].append((now - log["t"]) * 1e3)
            log["t"] = now
            reset()

        reset()
        torch.cuda.synchronize()
        log["t"] = time.perf_counter()
        return log, on_step

    # ---- The scene files, with the port's writers
    ply3, ply2 = str(root / "scene_3dgs.ply"), str(root / "scene_2dgs.ply")
    t0 = time.perf_counter()
    save_gaussian_ply(ply3, raw)
    save_gaussian_ply(ply2, dict(raw, scales=raw["scales"][:, :2]))
    phase("tools", f"scene PLYs written in {time.perf_counter() - t0:.2f} s: 3DGS "
          f"{Path(ply3).stat().st_size / 1e6:.1f} MB, 2DGS "
          f"{Path(ply2).stat().st_size / 1e6:.1f} MB")
    p3 = activate(params_from_numpy(load_gaussian_ply(ply3), dev))

    # ---- render_sample at its defaults
    d = render_sample.build_parser().parse_args([])
    reset()
    out = render_sample.main(["--out", str(root / "render_sample.png")])
    expect("render_sample", launched(), out["renders"], ("B4", "B5", "B1"),
           "render_sample per render")
    demo = render_sample.random_scene(d.gaussians, d.seed, device=dev)
    with torch.no_grad():
        direct = render_gaussians(*(demo[k] for k in KEYS),
                                  render_sample.demo_camera(d.height, d.width, device=dev),
                                  background_color=render_sample.BACKGROUND,
                                  config=render_sample.demo_config("cuda"))
    if not np.array_equal(read_png(root / "render_sample.png"), to_uint8(direct.cpu().numpy())):
        raise AssertionError("render_sample: the PNG differs from the direct render")
    phase("tools", f"render_sample ({d.gaussians} gaussians, {d.width}x{d.height}): first render "
          f"{out['seconds'][0] * 1e3:.1f} ms, steady {out['seconds'][1] * 1e3:.1f} ms (host "
          f"clock, fenced); the PNG equals the direct render; B4, B5, B1 once a render; {smi}")

    # ---- orbit_demo on the 3DGS PLY at 1080p, then another image size
    builds = compilation_count()
    reset()
    orbit = orbit_demo.main(["--ply", ply3, "--height", str(H), "--width", str(W),
                             "--out-dir", str(root / "orbit")])
    expect("orbit", launched(), orbit["frames"], ("B4", "B5", "B1"), "orbit per frame")
    cam0 = orbit_demo.orbit_camera(0.0, 5.0, H, W, 0.7 * W, device=dev)
    frame0 = orbit_demo.render_frame(p3, cam0, sh_degree, orbit_demo.orbit_config("cuda"))
    if not np.array_equal(read_png(root / "orbit" / "frame_000.png"),
                          to_uint8(frame0.cpu().numpy())):
        raise AssertionError("orbit: frame 0 differs from the direct render")
    orbit_demo.main(["--ply", ply3, "--frames", "4", "--out-dir", str(root / "orbit_small")])
    if compilation_count() != builds:
        raise AssertionError(f"orbit: another image size grew compilation_count "
                             f"({builds} -> {compilation_count()})")
    phase("tools", f"orbit ({raw['means3d'].shape[0]} gaussians, {W}x{H}, {orbit['frames']} "
          f"frames, PNG written): median frame {statistics.median(orbit['frame_ms']):.1f} ms (host clock; render, readback "
          f"and PNG), first {orbit['frame_ms'][0]:.1f} ms; frame 0 equals the direct render; "
          f"B4, B5, B1 once a frame; compilation_count {builds} before and after 640x360; {smi}")

    # ---- viewer: five requests on the 3DGS PLY, one on the disks
    v = viewer.build_viewer(["--ply", ply3])
    vcfg = RenderConfig(raster_impl="cuda", tile_capacity=512, chunk_size=64)
    req_ms = []
    for az, el in VIEWER_POSES:
        reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        body = v.png(az, el, v.radius0)
        req_ms.append((time.perf_counter() - t0) * 1e3)
        expect("viewer request", launched(), 1, ("B4", "B5", "B1"), "viewer per request")
        eye = v.center + v.radius0 * np.array(
            [math.sin(az) * math.cos(el), math.sin(el), math.cos(az) * math.cos(el)])
        R, T = look_at(eye=eye.astype(np.float32), target=v.center.astype(np.float32),
                       up=[0.0, 1.0, 0.0], device=dev)
        cam = Camera.create(R=R, T=T, H=v.H, W=v.W, fx=v.focal, fy=v.focal, cx=v.W / 2,
                            cy=v.H / 2, device=dev)
        with torch.no_grad():
            want = render_gaussians(*(p3[k] for k in KEYS), cam, sh_degree=sh_degree,
                                    background_color=viewer.BACKGROUND, config=vcfg)
        if not np.array_equal(read_png(io.BytesIO(body)), to_uint8(want.cpu().numpy())):
            raise AssertionError(f"viewer: the PNG at ({az}, {el}) differs from the direct render")
    vsize = f"{v.W}x{v.H}"
    del v
    v2 = viewer.build_viewer(["--ply", ply2])
    reset()
    body2 = v2.png(0.5, 0.2, v2.radius0)
    expect("viewer (disks)", launched(), 1, ("B4", "B5", "B6"), "viewer per request")
    del v2
    phase("tools", f"viewer ({vsize}): {len(VIEWER_POSES)} requests, median "
          f"{statistics.median(req_ms):.1f} ms (host clock, render and PNG encode), each PNG "
          f"equal to the direct render, B4, B5, B1 once a request; the disks' PLY: one request "
          f"through B6 ({len(body2)} bytes); {smi}")

    # ---- compress_scene: PLY -> .npz with --verify, then back
    npz = str(root / "scene.npz")
    t0 = time.perf_counter()
    stats = compress_scene.main([ply3, npz, "--verify"])
    t_all = time.perf_counter() - t0
    rt = str(root / "roundtrip.ply")
    compress_scene.main([npz, rt])
    back, want = load_gaussian_ply(rt), load_compressed_scene(npz)
    for k in want:
        if not np.array_equal(back[k], want[k]):
            raise AssertionError(f"compress: the round trip's {k} differs from the .npz's")
    phase("tools", f"compress_scene: {Path(ply3).stat().st_size / 1e6:.1f} MB PLY -> "
          f"{Path(npz).stat().st_size / 1e6:.2f} MB .npz ({stats['ratio']:.2f}x against float32) "
          f"in {t_all:.2f} s with the verify ({stats['verify_s']:.2f} s); render PSNR "
          f"{stats['psnr']:.2f} dB; the .npz -> PLY round trip equals load_compressed_scene")

    # ---- extract_mesh on the disks' PLY at its defaults
    d = extract_mesh.build_parser().parse_args([ply2, "mesh.ply"])
    reset()
    mesh = extract_mesh.main([ply2, str(root / "mesh.ply")])
    views = len(mesh["cameras"])
    expect("extract_mesh", launched(), views, ("B4", "B5", "B7"), "extract_mesh per view")
    faces = mesh["faces"]
    if not (len(faces) and faces.min() >= 0 and faces.max() < len(mesh["verts"])):
        raise AssertionError("extract_mesh: empty mesh or a face index out of range")
    times = mesh["times"]
    phase("tools", f"extract_mesh ({raw['means3d'].shape[0]} disks, {views} views at "
          f"{d.width}x{d.height}, {d.res}^3): render "
          f"{times['render']:.2f} s, fuse {times['fuse']:.2f} s, extract {times['extract']:.2f} s "
          f"(host clock); {mesh['observed'] * 100:.1f}% observed; {len(mesh['verts'])} verts, "
          f"{len(faces)} faces; B4, B5, B7 once a view; {smi}")
    pd = activate(params_from_numpy(load_gaussian_ply(ply2), dev))
    ed_t, al_t = extract_mesh.depth_view(pd, mesh["cameras"][0], sh_degree,
                                         extract_mesh.mesh_config("torch"))
    ed_c, al_c = mesh["depths"][0], mesh["alphas"][0]
    blend_agreement("tools extract_mesh alpha vs torch route", al_c, al_t,
                    row_scale(al_t, (0, 1)), ROUTE_MAX_SHARE, ROUTE_MAX_ERR)
    both = (al_c > 1e-3) & (al_t > 1e-3)
    one = int(((al_c > 1e-3) != (al_t > 1e-3)).sum())
    if one > ROUTE_MAX_SHARE * al_t.numel():
        raise AssertionError(f"extract_mesh: {one} pixels covered on one route only")
    blend_agreement("tools extract_mesh expected depth vs torch route (both covered)",
                    ed_c[both], ed_t[both], row_scale(ed_t[both], 0), ROUTE_MAX_SHARE,
                    ROUTE_MAX_ERR)
    t0 = time.perf_counter()
    tsdf_h, w_h, _, _ = tsdf_fuse([d.cpu() for d in mesh["depths"]],
                                  [a.cpu() for a in mesh["alphas"]],
                                  [dataclasses.replace(c, **{
                                      f.name: getattr(c, f.name).cpu()
                                      for f in dataclasses.fields(c)
                                      if isinstance(getattr(c, f.name), torch.Tensor)})
                                   for c in mesh["cameras"]], mesh["bounds"], d.res,
                                  alpha_floor=d.alpha_floor)
    t_cpu = time.perf_counter() - t0
    flips = int((w_h != mesh["weight"]).sum())
    same = w_h == mesh["weight"]
    err = float(np.abs(tsdf_h[same] - mesh["tsdf"][same]).max())
    phase("tools", f"tsdf_fuse on the card against the CPU ({t_cpu:.2f} s there): {one} pixels "
          f"covered on one route only; {flips} of {w_h.size} voxels' weights differ; TSDF max "
          f"abs diff {err:.3e} where they agree")
    if flips >= TSDF_MAX_FLIP_SHARE * w_h.size or err > TSDF_ATOL:
        raise AssertionError("extract_mesh: the card's TSDF disagrees with the CPU's")
    del mesh, pd, ed_t, al_t

    # ---- The quality check: tests/test_mesh.py's surfel sphere
    sphere = reconstruct_sphere("cuda", dev)
    phase("tools", f"surfel sphere on the card: {len(sphere['verts'])} verts, "
          f"{len(sphere['faces'])} faces, radius error median {sphere['median_voxels']:.3f} "
          f"voxels (bound {SPHERE_MEDIAN_VOXELS}), 90th percentile {sphere['p90_voxels']:.3f} "
          f"(bound {SPHERE_P90_VOXELS})")
    if not (sphere["median_voxels"] < SPHERE_MEDIAN_VOXELS
            and sphere["p90_voxels"] < SPHERE_P90_VOXELS and len(sphere["faces"]) > 1000):
        raise AssertionError("tools: the sphere's reconstruction misses tests/test_mesh.py's "
                             "bounds")

    # ---- The training demos
    d = train_demo.build_parser().parse_args([])
    for extra in ([], ["--densify-every", "100", "--strategy", "mcmc"]):
        log, hook = stepper("train_demo", d.views, ("B1", "B2", "B3", "B4", "B5"),
                            "train_demo per view-step")
        res = train_demo.main(["--out-dir", str(root / "train_demo")] + extra, on_step=hook)
        phase("tools", f"train_demo {' '.join(extra) or '(defaults)'}: PSNR "
              f"{res['initial_psnr']:.2f} -> {res['final_psnr']:.2f} dB, median step "
              f"{statistics.median(log['ms'][1:]):.2f} ms ({d.views} views at "
              f"{d.width}x{d.height}, host clock), "
              f"events {json.dumps(res['events'])}; B1-B5 once a view-step; {smi}")
        if not res["final_psnr"] > res["initial_psnr"]:
            raise AssertionError("train_demo: the PSNR did not rise")
    d = train_surfel_demo.build_parser().parse_args([])
    log, hook = stepper("train_surfel_demo", d.views, ("B3", "B4", "B5", "B7", "B8"),
                        "train_surfel_demo per view-step")
    res = train_surfel_demo.main(["--out-dir", str(root / "train_surfel_demo")], on_step=hook)
    phase("tools", f"train_surfel_demo: PSNR {res['initial_psnr']:.2f} -> "
          f"{res['final_psnr']:.2f} dB, median step {statistics.median(log['ms'][1:]):.2f} ms "
          f"({d.views} views at {d.width}x{d.height}); B3-B5, B7, B8 once a view-step; {smi}")
    if not res["final_psnr"] > res["initial_psnr"]:
        raise AssertionError("train_surfel_demo: the PSNR did not rise")

    blender = root / "blender"
    t0 = time.perf_counter()
    write_blender_capture(blender, raw, sh_degree)
    phase("tools", f"Blender capture: {BLENDER_TRAIN} + {BLENDER_TEST} views at "
          f"{BLENDER_SIZE}x{BLENDER_SIZE} RGBA written in {time.perf_counter() - t0:.2f} s")
    argv = ["--data", str(blender), "--steps", str(BLENDER_STEPS), "--strategy", "mcmc",
            "--out-dir", str(root / "train_blender")]
    log, hook = stepper("train_blender", 1, ("B1", "B2", "B3", "B4", "B5"),
                        "train_blender per step")
    res = train_blender.main(argv, on_step=hook)
    args = train_blender.build_parser().parse_args(argv)
    psnr0 = train_blender.eval_test(res["initial"], args, train_blender.blender_config(args),
                                    dev)[0]
    phase("tools", f"train_blender ({BLENDER_STEPS} steps, MCMC, downscale {args.downscale}, "
          f"{args.gaussians} gaussians, SH {args.sh_degree}): test PSNR {psnr0:.2f} -> "
          f"{res['test_psnr']:.2f} dB over {BLENDER_TEST} views, median step {statistics.median(log['ms'][1:]):.2f} ms, relocations "
          f"{json.dumps(res['events'])}; B1-B5 once a step; {smi}")
    if not res["test_psnr"] > psnr0:
        raise AssertionError("train_blender: the test PSNR did not rise")

    # ---- The utilities on the trained scene at 1080p (phase 7's step)
    cam = scene_camera(H, W, device=dev)
    cfg = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS)
    leaves = perturbed_leaves(raw, dev)
    opt = make_optimizer(leaves, lr=TRAIN_LR)
    with torch.no_grad():
        target = render_gaussians(*(p3[k] for k in KEYS), cam, sh_degree=sh_degree, config=cfg)
        _, aux = render_gaussians(*(activate(leaves)[k] for k in KEYS), cam,
                                  sh_degree=sh_degree, config=cfg, return_aux=True)

    def step():
        return train_step(leaves, opt, [cam], target[None], sh_degree=sh_degree, config=cfg)

    step()
    logdir = root / "trace"
    with trace(str(logdir)):
        with annotate("train_step"):
            step()
        torch.cuda.synchronize()
    events = json.loads((logdir / "trace.json").read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    if not any(e.get("name") == "train_step" for e in events):
        raise AssertionError("tools: the trace holds no annotated region")
    phase("tools", f"trace of one train_step: {len(events)} events, the 'train_step' region, "
          f"{len(kernels)} device kernels ({sum(e.get('dur', 0) for e in kernels) / 1e3:.3f} ms "
          f"of kernel time)")
    step_ms = cuda_ms(step, 5, 0)
    report = roofline_report(step_ms, H * W, int(aux.binning.num_isects), raw["means3d"].shape[0],
                             sh_bases=(sh_degree + 1) ** 2, tile_size=cfg.tile_size)
    phase("tools", "roofline_report(chip='h100') of phase 7's step (median of 5 "
          f"{step_ms:.3f} ms): " + json.dumps(report.as_dict()) + f"; {smi}")
    del leaves, opt

    p_args = tuple(p3[k] for k in KEYS)

    def render(*a):
        return render_gaussians(*a, cam, sh_degree=sh_degree, background_color=BACKGROUND,
                                config=cfg)

    with torch.no_grad():
        amort = amortized_ms(render, p_args, 20)
        queued = cuda_ms_queued(lambda: render(*p_args), 20, 3)
    phase("tools", f"amortized_ms of the 1080p render {amort:.3f} ms, cuda_ms_queued "
          f"{queued:.3f} ms ({abs(amort - queued) / queued * 100:.2f}% apart)")
    if abs(amort - queued) > AMORTIZED_MAX_REL * queued:
        raise AssertionError("tools: amortized_ms disagrees with cuda_ms_queued")

    rng = np.random.default_rng(7)
    n = ORACLE_N
    means = np.concatenate([rng.normal(0, 1.0, (n, 2)), rng.uniform(2.0, 6.0, (n, 1))], 1)
    og = {k: torch.from_numpy(v.astype(np.float32)).to(dev) for k, v in dict(
        means3d=means, scales=rng.normal(-2.6, 0.4, (n, 3)), quats=rng.normal(size=(n, 4)),
        opacities=rng.uniform(0.05, 0.95, n), features=rng.uniform(0, 1, (n, 3))).items()}
    S = ORACLE_HW
    ocam = Camera.create(R=np.eye(3), T=np.zeros(3), H=S, W=S, fx=200.0, fy=200.0, cx=S / 2,
                         cy=S / 2, device=dev)
    ocfg = RenderConfig(raster_impl="cuda", isect_padding_multiplier=16)
    with torch.no_grad():
        proj = project_gaussians(og["means3d"], og["scales"], og["quats"], og["opacities"],
                                 ocam, ocfg)
        bins = bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths, S, S, ocfg)
        bg = torch.tensor(BACKGROUND, device=dev)
        img, oaux = rasterize_gaussians(proj.means2d, proj.conics, og["features"],
                                        og["opacities"], bg, bins, S, S, ocfg)
        oracle = rasterize_dense_oracle(proj.means2d, proj.conics, og["features"],
                                        og["opacities"], bg, proj.depths, proj.radii, S, S, ocfg)
    if int(oaux.tile_overflow) or int(bins.aux.capacity_overflow):
        raise AssertionError("tools: the oracle's scene overflows a budget")
    blend_agreement(f"tools dense oracle vs cuda route ({n} gaussians, {S}x{S})", img, oracle)
    return per_unit



# ---- Phase 17: the sharded paths of parallel/


def kernel_wrappers() -> dict:
    """Each kernel's wrapper and the attribute counting its launches (B6
    and B7 share one wrapper)."""
    from mojosplat_tpu_torch.ops.expand_cuda import segment_expand_offsets
    from mojosplat_tpu_torch.ops.raster_cuda import raster_tiles, raster_tiles_bwd
    from mojosplat_tpu_torch.ops.raster_probe import raster_variant
    from mojosplat_tpu_torch.ops.segsum_cuda import segment_sum_cols
    from mojosplat_tpu_torch.ops.slice_cuda import segment_slice_gather
    from mojosplat_tpu_torch.ops.surfel_cuda import raster_surfel_tiles_bwd, raster_surfel_tiles_fwd

    return {"B1": (raster_tiles, "launches"), "B2": (raster_tiles_bwd, "launches"),
            "B3": (segment_sum_cols, "launches"), "B4": (segment_expand_offsets, "launches"),
            "B5": (segment_slice_gather, "launches"),
            "B6": (raster_surfel_tiles_fwd, "launches"),
            "B7": (raster_surfel_tiles_fwd, "launches_maps"),
            "B8": (raster_surfel_tiles_bwd, "launches"), "B9": (raster_variant, "launches")}


def counted(fn, expect: tuple, what: str):
    """Run ``fn()`` with every launch count set to 0 just before and read
    just after (synchronised); raise unless each kernel in ``expect`` was
    launched and no other was. Returns (result, counts, ms on the host
    clock)."""
    wrappers = kernel_wrappers()
    torch.cuda.synchronize()
    for wrapper, attr in wrappers.values():
        setattr(wrapper, attr, 0)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = {k: getattr(wrapper, attr) for k, (wrapper, attr) in wrappers.items()}
    if any(counts[k] < 1 for k in expect) or any(v for k, v in counts.items() if k not in expect):
        raise AssertionError(f"{what}: launches {counts}; expected {expect} and no other")
    return out, counts, ms


def host_ms(fn) -> float:
    """Milliseconds of ``fn()`` on the host clock between two synchronises."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def sgd_step(leaves: dict, step) -> tuple:
    """(the loss, each leaf's gradient) of one ``step(leaves, optimizer)``
    with SGD at lr 1, which moves each leaf by its gradient. The gradient
    is read from the leaf (``.grad``, what the update applied): the
    change itself, a difference of f32 parameters of order 1, would carry
    their rounding (6e-8) into gradients of 1e-6."""
    loss = step(leaves, torch.optim.SGD(list(leaves.values()), lr=1.0))
    return float(loss), {k: v.grad.detach().clone() for k, v in leaves.items()}


def par_scene(raw: dict, dev) -> dict:
    """Phase 17's inputs, the same in every process: the scene's and the
    disks' perturbed raw leaves (phase 7's noise), their unperturbed
    "cuda"-route renders on a black background as targets, and the
    camera."""
    from mojosplat_tpu_torch import RenderConfig, render_gaussians, render_surfels
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.train import activate
    from mojosplat_tpu_torch.utils.scenes import scene_camera

    sh_degree = int(round(raw["features"].shape[1] ** 0.5)) - 1
    cam = scene_camera(PAR_H, PAR_W, device=dev)
    cfg = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS)
    disks = dict(raw, scales=np.ascontiguousarray(raw["scales"][:, :2]))
    with torch.no_grad():
        p = activate(params_from_numpy(raw, dev))
        target = render_gaussians(*(p[k] for k in KEYS), cam, sh_degree=sh_degree, config=cfg)
        p = activate(params_from_numpy(disks, dev))
        target_d = render_surfels(*(p[k] for k in KEYS), cam, sh_degree=sh_degree, config=cfg)
    return dict(sh_degree=sh_degree, cam=cam, cfg=cfg, target=target, target_d=target_d,
                leaves=perturbed_leaves(raw, dev), disks=perturbed_leaves(disks, dev))


def _rank_main(rank: int, port: int, out: str) -> None:
    """One rank of phase 17 (c): a gloo world of 2 on the one card. Writes
    its blocks, shards, losses, counts, times and peak memory to
    ``out/rank<r>.pt``."""
    import os

    sys.path.insert(0, str(ROOT))
    os.environ.update(MOJOSPLAT_COORDINATOR=f"127.0.0.1:{port}", MOJOSPLAT_NUM_PROCESSES="2",
                      MOJOSPLAT_PROCESS_ID=str(rank))
    import torch.distributed as dist

    from mojosplat_tpu_torch import RenderConfig
    from mojosplat_tpu_torch.parallel import (
        init_multihost, make_gauss_mesh, make_mesh, render_batch_sharded,
        render_gaussians_sharded, train_step_gauss_sharded)
    from mojosplat_tpu_torch.parallel.sharding import batch_block
    from mojosplat_tpu_torch.train import (
        activate, train_step_sharded, train_step_sharded_surfel, zero1_rows)
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    init_multihost(backend="gloo")
    raw = load_compressed_scene(str(ROOT / TRAINED_SCENE))
    s = par_scene(raw, dev)
    sh, cam, cfg = s["sh_degree"], s["cam"], s["cfg"]
    cfg_exact = RenderConfig(raster_impl="cuda", **PAR_EXACT)  # the slab paths'
    res = dict(rank=rank, counts={}, ms={})
    torch.cuda.reset_peak_memory_stats(dev)

    mesh = make_mesh(1, 2)
    with torch.no_grad():
        for prim, key in (("3dgs", "leaves"), ("2dgs", "disks")):
            p = activate(s[key])
            expect = ("B4", "B5", "B1") if prim == "3dgs" else ("B4", "B5", "B6")
            block, res["counts"][f"render_{prim}"], res["ms"][f"render_{prim}"] = counted(
                lambda: render_batch_sharded(p, [cam], mesh, sh_degree=sh, config=cfg_exact,
                                             primitive=prim), expect, f"render {prim}")
            res[f"block_{prim}"] = block.cpu()

    leaves = s["leaves"]
    before = {k: v.detach().clone() for k, v in leaves.items()}
    shards = zero1_rows(leaves, mesh)
    loss, res["counts"]["dp_sp_zero1"], res["ms"]["dp_sp_zero1"] = counted(
        lambda: train_step_sharded(leaves, torch.optim.SGD(list(shards.values()), lr=1.0), [cam],
                                   batch_block(s["target"][None], mesh), mesh, sh_degree=sh,
                                   config=cfg_exact, zero1=shards),
        ("B4", "B5", "B1", "B2", "B3"), "train_step_sharded")
    res["dp_sp_loss"] = float(loss)
    res["dp_sp_update_off"] = zero1_update_off(before, leaves)
    del before
    # The replicas after the all-gather: the same on both ranks.
    res["dp_sp_checksum"] = [float(v.detach().double().sum()) for v in leaves.values()]
    if rank == 0:
        res["dp_sp_grad"] = {k: v.grad.cpu() for k, v in leaves.items()}
    opt = torch.optim.SGD(list(shards.values()), lr=1e-3)
    res["ms"]["dp_sp_zero1_more"] = [host_ms(lambda: train_step_sharded(
        leaves, opt, [cam], batch_block(s["target"][None], mesh), mesh, sh_degree=sh,
        config=cfg_exact, zero1=shards)) for _ in range(2)]
    del shards, opt

    disks = s["disks"]
    loss, res["counts"]["surfel"], res["ms"]["surfel"] = counted(
        lambda: train_step_sharded_surfel(disks, torch.optim.SGD(list(disks.values()), lr=1.0),
                                          [cam], batch_block(s["target_d"][None], mesh), mesh,
                                          sh_degree=sh, config=cfg_exact, **SURFEL_WEIGHTS),
        ("B3", "B4", "B5", "B7", "B8"), "train_step_sharded_surfel")
    res["surfel_loss"] = float(loss)
    if rank == 0:
        res["surfel_grad"] = {k: v.grad.cpu() for k, v in disks.items()}
    opt = torch.optim.SGD(list(disks.values()), lr=1e-3)
    res["ms"]["surfel_more"] = [host_ms(lambda: train_step_sharded_surfel(
        disks, opt, [cam], batch_block(s["target_d"][None], mesh), mesh, sh_degree=sh,
        config=cfg_exact, **SURFEL_WEIGHTS)) for _ in range(2)]

    gmesh = make_gauss_mesh(2)
    n = next(iter(s["leaves"].values())).shape[0] // 2
    rows = slice(rank * n, (rank + 1) * n)
    fresh = perturbed_leaves(raw, dev)
    shard = {k: v.detach()[rows].clone().requires_grad_(True) for k, v in fresh.items()}
    del fresh, s["leaves"], s["disks"], leaves, disks
    with torch.no_grad():
        (slab, aux), res["counts"]["gauss_render"], res["ms"]["gauss_render"] = counted(
            lambda: render_gaussians_sharded(activate(shard), cam, gmesh, sh_degree=sh,
                                             config=cfg, return_aux=True),
            ("B4", "B5", "B1"), "render_gaussians_sharded")
    res["gauss_slab"], res["gauss_aux"] = slab.cpu(), [int(x) for x in aux]
    res["gauss_rows"] = n
    slab_target = s["target"][rank * PAR_H // 2:(rank + 1) * PAR_H // 2]
    opt = torch.optim.SGD(list(shard.values()), lr=1.0)
    res["gauss_losses"], res["counts"]["gauss_step"], res["ms"]["gauss_step"] = [], [], []
    for i in range(PAR_GAUSS_STEPS):
        loss, counts, ms = counted(
            lambda: train_step_gauss_sharded(shard, opt, cam, slab_target, gmesh, sh_degree=sh,
                                             config=cfg),
            ("B4", "B5", "B1", "B2", "B3"), "train_step_gauss_sharded")
        if i == 0:
            res["gauss_grad"] = {k: v.grad.cpu() for k, v in shard.items()}
        res["gauss_losses"].append(float(loss))
        res["counts"]["gauss_step"].append(counts)
        res["ms"]["gauss_step"].append(ms)
    res["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    torch.save(res, Path(out) / f"rank{rank}.pt")
    dist.destroy_process_group()


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_ranks(n: int, out: Path, timeout_s: float) -> list:
    """Start n ranks of ``_rank_main`` (spawned), wait; a rank that fails or
    outlives ``timeout_s`` fails the phase, and every rank is stopped."""
    import torch.multiprocessing as mp

    out.mkdir(parents=True, exist_ok=True)
    port = free_port()
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, port, str(out))) for r in range(n)]
    for p in procs:
        p.start()
    t0 = time.perf_counter()
    try:
        while any(p.is_alive() for p in procs):
            failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
            if failed or time.perf_counter() - t0 > timeout_s:
                raise AssertionError(f"parallel: a rank failed or timed out (exit codes "
                                     f"{[p.exitcode for p in procs]})")
            time.sleep(0.5)
        if any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"parallel: rank exit codes {[p.exitcode for p in procs]}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(n)]


def grads_agree(name: str, got: dict, want: dict, scale: float = 1.0) -> None:
    for k in want:
        grad_agreement(f"{name} d {k}", got[k].to(want[k].device)[None],
                       (scale * want[k])[None])


def zero1_update_off(before: dict, params: dict) -> int:
    """The number of values where a ZeRO-1 step at SGD lr 1 did not leave
    the replicated parameters bitwise at ``before - grad``, the replicated
    step's update from the same all-reduced gradient (the replicas'
    ``.grad``): the row slice and the all-gather's order put every updated
    row back in place."""
    return sum(int((params[k].detach() != before[k] - params[k].grad).sum()) for k in before)


def parallel_phase(raw: dict, smi: str) -> dict:
    """Phase 17: the sharded paths at 1920 x 1152 on the trained scene
    (preset 6 with tight_cull) and its disks. (a) slabs in this process;
    (b) a world of 1 on NCCL; (c) two spawned ranks in a gloo world on the
    one card. Returns each kernel's launches per rank and step of each
    sharded path."""
    import os

    import torch.distributed as dist

    from mojosplat_tpu_torch import RenderConfig, render_gaussians, render_surfels
    from mojosplat_tpu_torch.parallel import (
        init_multihost, make_gauss_mesh, make_mesh, render_gaussians_sharded,
        train_step_gauss_sharded)
    from mojosplat_tpu_torch.train import (
        activate, train_step, train_step_sharded, train_step_sharded_surfel,
        train_step_surfel, zero1_rows)

    t_phase = time.perf_counter()
    dev = torch.device("cuda", 0)
    s = par_scene(raw, dev)
    sh, cam, cfg = s["sh_degree"], s["cam"], s["cfg"]
    # tile_batch bounds the plain blender's memory; it changes no result.
    cfg_torch = RenderConfig(raster_impl="torch", tile_batch=256, **SCENE_BUDGETS)
    leaves, disks = s["leaves"], s["disks"]
    phase("parallel", f"{smi}; {PAR_W}x{PAR_H} (1080 rounded up to 4 slabs of whole 32-px "
          f"tile rows), {leaves['means3d'].shape[0]} gaussians, SH {sh}, preset 6 with "
          f"tight_cull (PAR_EXACT where slabs are held to the full render); SGD at lr 1, "
          f"each step's gradient held to the single device's")

    # ---- (a) Slabs in one process, the "cuda" route
    def l2(img, tgt):
        return torch.sum((img - tgt) ** 2) / s["target"].numel()

    def render_slab(family, p, rows=None, config=cfg, **kw):
        if family == "3dgs":
            return render_gaussians(*(p[k] for k in KEYS), cam, sh_degree=sh, config=config,
                                    viewport_rows=rows, **kw)
        return render_surfels(*(p[k] for k in KEYS), cam, sh_degree=sh, config=config,
                              return_depth=True, return_normals=True, return_distortion=True,
                              viewport_rows=rows, **kw)

    def slab_run(family, n_slab, config):
        """The family's images and the gradient of the summed losses over
        n_slab slabs (the full render for 1), with each slab's launches."""
        src = leaves if family == "3dgs" else disks
        tgt_full = s["target"] if family == "3dgs" else s["target_d"]
        p = {k: v.detach().clone().requires_grad_(True) for k, v in src.items()}
        h = PAR_H // n_slab
        imgs, per_slab = [], []
        for i in range(n_slab):
            rows, tgt = (i * h, h), tgt_full[i * h:(i + 1) * h]

            def one():
                out = render_slab(family, activate(p), rows, config)
                img = out if family == "3dgs" else out[0]
                loss = l2(img, tgt)
                if family == "2dgs":
                    loss = loss + 1e-3 * torch.sum(out[1] ** 2) / tgt_full[..., 0].numel()
                loss.backward()
                return img.detach()

            expect = (("B4", "B5", "B1", "B2", "B3") if family == "3dgs"
                      else ("B4", "B5", "B7", "B8", "B3"))
            img, counts, _ = counted(one, expect, f"{family} slab {i}")
            imgs.append(img)
            per_slab.append(counts)
        return torch.cat(imgs), {k: v.grad for k, v in p.items()}, per_slab

    # At preset 6 a gaussian whose tile rectangle spans more than
    # max_tile_span rows is cut to a window centred on it, and a slab clamps
    # the rectangle at its own edges first, so slabs keep other windows of
    # such gaussians than the full render (the reference's contract,
    # ROADMAP Queue C). Printed here; each slab is held to the "torch"
    # route's slab, the same contract, by B1's rule (the route rule for
    # the disks with the maps).
    with torch.no_grad():
        for family in ("3dgs", "2dgs"):
            src = activate(leaves if family == "3dgs" else disks)
            full = render_slab(family, src, return_aux=True)
            img_full = full[0]
            for n_slab in (2, 4):
                h = PAR_H // n_slab
                outs = [render_slab(family, src, (i * h, h), return_aux=True)
                        for i in range(n_slab)]
                img = torch.cat([o[0] for o in outs])
                off = float(((img - img_full).abs() > BLEND_ATOL).float().mean())
                counters = {k: sum(drop_counters(o[-1])[k] for o in outs)
                            for k in drop_counters(full[-1])}
                phase("parallel", f"{family} preset 6, {n_slab} slabs against the full render: "
                      f"{off:.3e} of the values differ by more than {BLEND_ATOL}; counters "
                      f"summed over the slabs {json.dumps(counters)}, full render "
                      f"{json.dumps(drop_counters(full[-1]))}")
            for i in range(2):
                h = PAR_H // 2
                got = render_slab(family, src, (i * h, h))
                want = render_slab(family, src, (i * h, h), cfg_torch)
                if family == "3dgs":
                    blend_agreement(f"parallel 3dgs preset 6 slab {i} of 2 vs torch route", got,
                                    want)
                    continue
                # The distortion 2 (alpha m2 - m1^2) cancels terms of the
                # order of the depth squared, and a slab's shifted record
                # rows carry one more rounding (ROADMAP Queue C): it is held
                # relative to the terms it cancels.
                scales = [row_scale(b, (0, 1)) for b in want[:3]]
                scales.append(scales[1] ** 2)
                for name, a, b, sc in zip(("image", "depth", "normals", "distortion"), got,
                                          want, scales):
                    blend_agreement(f"parallel 2dgs preset 6 slab {i} of 2 {name} vs torch "
                                    f"route", a, b, sc, ROUTE_MAX_SHARE, ROUTE_MAX_ERR)
            del full, outs, img, got, want
    # With no rectangle cut (PAR_EXACT), the slabs are the full render's rows
    # but for the y shift's rounding: B1's rule, and B2's on the gradients.
    cfg_exact = RenderConfig(raster_impl="cuda", **PAR_EXACT)
    for family in ("3dgs", "2dgs"):
        img_full, g_full, _ = slab_run(family, 1, cfg_exact)
        for n_slab in (2, 4):
            img, g, per_slab = slab_run(family, n_slab, cfg_exact)
            blend_agreement(f"parallel {family} {n_slab} slabs vs the full render", img,
                            img_full, row_scale(img_full, (0, 1)))
            grads_agree(f"parallel {family} {n_slab} slabs' loss vs the full render's", g,
                        g_full)
            phase("parallel", f"{family}, {n_slab} slabs: launches of each slab (forward and "
                  f"backward) {json.dumps(per_slab)}")
        del img_full, g_full, img, g

    # ---- (b) A world of 1 on NCCL, in this process
    os.environ.update(MOJOSPLAT_COORDINATOR=f"127.0.0.1:{free_port()}",
                      MOJOSPLAT_NUM_PROCESSES="1", MOJOSPLAT_PROCESS_ID="0")
    if not init_multihost():
        raise AssertionError("parallel: init_multihost did not start the NCCL world")
    mesh, gmesh = make_mesh(1, 1), make_gauss_mesh(1)
    ref = {}
    target = s["target"]

    def fresh(src):
        return {k: v.detach().clone().requires_grad_(True) for k, v in src.items()}

    # Single-device references: train_step (the L2 mean) and train_step_surfel.
    (ref["loss"], ref["grad"]), _, ms_single = counted(
        lambda: sgd_step(fresh(leaves), lambda p, o: train_step(
            p, o, [cam], target[None], sh_degree=sh, config=cfg)),
        ("B4", "B5", "B1", "B2", "B3"), "train_step")
    (ref["surfel_loss"], ref["surfel_grad"]), _, ms_single_s = counted(
        lambda: sgd_step(fresh(disks), lambda p, o: train_step_surfel(
            p, o, [cam], s["target_d"][None], sh_degree=sh, config=cfg, **SURFEL_WEIGHTS)),
        ("B3", "B4", "B5", "B7", "B8"), "train_step_surfel")
    times = dict(train_step=ms_single, train_step_surfel=ms_single_s)
    runs = {
        "train_step_sharded": lambda p, o: train_step_sharded(
            p, o, [cam], target[None], mesh, sh_degree=sh, config=cfg),
        "train_step_gauss_sharded": lambda p, o: train_step_gauss_sharded(
            p, o, cam, target, gmesh, sh_degree=sh, config=cfg),
    }
    for name, run in runs.items():
        (loss, grad), counts, times[name] = counted(
            lambda: sgd_step(fresh(leaves), run), ("B4", "B5", "B1", "B2", "B3"), name)
        rel = abs(loss - ref["loss"]) / ref["loss"]
        if rel > 1e-5:
            raise AssertionError(f"{name}: loss {loss} against {ref['loss']}")
        grads_agree(f"parallel world 1 {name}", grad, ref["grad"])
    # ZeRO-1: the replicas' all-reduced gradient held to the single
    # device's (B2's rule), and the parameters after the step bitwise at
    # the replicated update from that gradient.
    p = fresh(leaves)
    before = {k: v.detach().clone() for k, v in p.items()}
    shards = zero1_rows(p, mesh)
    _, _, times["train_step_sharded zero1"] = counted(
        lambda: train_step_sharded(p, torch.optim.SGD(list(shards.values()), lr=1.0), [cam],
                                   target[None], mesh, sh_degree=sh, config=cfg, zero1=shards),
        ("B4", "B5", "B1", "B2", "B3"), "train_step_sharded zero1")
    grads_agree("parallel world 1 train_step_sharded zero1",
                {k: v.grad for k, v in p.items()}, ref["grad"])
    off = zero1_update_off(before, p)
    phase("parallel", f"world 1 train_step_sharded zero1: {off} parameter values off the "
          f"replicated update p - grad")
    if off:
        raise AssertionError("train_step_sharded zero1: the update is not the replicated one")
    del p, shards, before
    (loss, grad), _, times["train_step_sharded_surfel"] = counted(
        lambda: sgd_step(fresh(disks), lambda p, o: train_step_sharded_surfel(
            p, o, [cam], s["target_d"][None], mesh, sh_degree=sh, config=cfg,
            **SURFEL_WEIGHTS)), ("B3", "B4", "B5", "B7", "B8"), "train_step_sharded_surfel")
    if abs(loss - ref["surfel_loss"]) > 1e-5 * ref["surfel_loss"]:
        raise AssertionError(f"train_step_sharded_surfel: loss {loss} against "
                             f"{ref['surfel_loss']}")
    grads_agree("parallel world 1 train_step_sharded_surfel", grad, ref["surfel_grad"])
    with torch.no_grad():
        q = activate(leaves)
        ref["image"] = render_slab("3dgs", q)
        (img, aux), _, times["render_gaussians_sharded"] = counted(
            lambda: render_gaussians_sharded(q, cam, gmesh, sh_degree=sh, config=cfg,
                                             return_aux=True), ("B4", "B5", "B1"),
            "render_gaussians_sharded")
        blend_agreement("parallel world 1 render_gaussians_sharded", img, ref["image"])
        # (c)'s slab paths run at PAR_EXACT: their single-device renders.
        ref["image_x"] = render_slab("3dgs", q, config=cfg_exact)
        ref["image_d_x"] = render_surfels(*(activate(disks)[k] for k in KEYS), cam,
                                          sh_degree=sh, config=cfg_exact)
    (ref["loss_x"], ref["grad_x"]), _, _ = counted(
        lambda: sgd_step(fresh(leaves), lambda p, o: train_step(
            p, o, [cam], target[None], sh_degree=sh, config=cfg_exact)),
        ("B4", "B5", "B1", "B2", "B3"), "train_step")
    (ref["surfel_loss_x"], ref["surfel_grad_x"]), _, _ = counted(
        lambda: sgd_step(fresh(disks), lambda p, o: train_step_surfel(
            p, o, [cam], s["target_d"][None], sh_degree=sh, config=cfg_exact,
            **SURFEL_WEIGHTS)), ("B3", "B4", "B5", "B7", "B8"), "train_step_surfel")
    phase("parallel", f"world 1 (NCCL): RouteAux {json.dumps(aux._asdict(), default=int)}")
    phase("parallel", f"world 1 (NCCL), {smi}: ms on the host clock, synchronised, the "
          f"first call of each: " + ", ".join(f"{k} {v:.1f}" for k, v in times.items()))

    def steady(step, src, zero1=False):
        """Median ms of 3 steps (SGD at lr 1e-3) after one untimed."""
        p = fresh(src)
        held = zero1_rows(p, mesh) if zero1 else p
        opt = torch.optim.SGD(list(held.values()), lr=1e-3)
        ms = [host_ms(lambda: step(p, opt, held if zero1 else None)) for _ in range(4)]
        return statistics.median(ms[1:])

    tgt_d = s["target_d"][None]
    steady_ms = {
        "train_step": steady(lambda p, o, z: train_step(
            p, o, [cam], target[None], sh_degree=sh, config=cfg), leaves),
        "train_step_sharded": steady(lambda p, o, z: train_step_sharded(
            p, o, [cam], target[None], mesh, sh_degree=sh, config=cfg), leaves),
        "train_step_sharded zero1": steady(lambda p, o, z: train_step_sharded(
            p, o, [cam], target[None], mesh, sh_degree=sh, config=cfg, zero1=z), leaves, True),
        "train_step_gauss_sharded": steady(lambda p, o, z: train_step_gauss_sharded(
            p, o, cam, target, gmesh, sh_degree=sh, config=cfg), leaves),
        "train_step_surfel": steady(lambda p, o, z: train_step_surfel(
            p, o, [cam], tgt_d, sh_degree=sh, config=cfg, **SURFEL_WEIGHTS), disks),
        "train_step_sharded_surfel": steady(lambda p, o, z: train_step_sharded_surfel(
            p, o, [cam], tgt_d, mesh, sh_degree=sh, config=cfg, **SURFEL_WEIGHTS), disks),
    }
    phase("parallel", f"world 1 (NCCL), {smi}: steady ms (median of 3 steps after one, host "
          f"clock, synchronised): " + ", ".join(f"{k} {v:.2f}" for k, v in steady_ms.items()))
    dist.destroy_process_group()
    for k in ("MOJOSPLAT_COORDINATOR", "MOJOSPLAT_NUM_PROCESSES", "MOJOSPLAT_PROCESS_ID"):
        del os.environ[k]
    del img, grad
    # The scaling sweep's CLI at its defaults: on one card, d = 1 of both
    # pipelines in a world of one (no rendezvous set: init_multihost's
    # world_of_one).
    from mojosplat_tpu_torch.examples import benchmark_scaling

    sweep = benchmark_scaling.main(["--pipeline", "both"])
    if [r["pipeline"] for r in sweep] != ["dp-sp", "gauss"]:
        raise AssertionError(f"benchmark_scaling: {sweep}")

    # ---- (c) Two ranks on the one card, a gloo world
    t0 = time.perf_counter()
    ranks = run_ranks(2, PAR_DIR, PAR_TIMEOUT_S)
    phase("parallel", f"2 ranks (gloo, both on cuda:0) in {time.perf_counter() - t0:.1f} s; "
          f"no host staging: gloo took the card's tensors for all_reduce, all_gather and "
          f"all_to_all_single (a one-off probe, and every collective here)")
    for r in ranks:
        phase("parallel", f"rank {r['rank']}: peak memory {r['peak_bytes']} bytes; launches "
              + json.dumps({k: v for k, v in r["counts"].items() if k != "gauss_step"})
              + f"; gauss step {json.dumps(r['counts']['gauss_step'][0])}; ms "
              + json.dumps({k: (round(v, 1) if isinstance(v, float) else
                                [round(x, 1) for x in v]) for k, v in r["ms"].items()}))
    # The slab paths at PAR_EXACT (see (a)), the gaussian-sharded one at
    # preset 6: it bins each shard against the whole tile grid.
    blend_agreement("parallel 2 ranks render_batch_sharded 3dgs",
                    torch.cat([r["block_3dgs"][0] for r in ranks]).to(dev), ref["image_x"])
    blend_agreement("parallel 2 ranks render_batch_sharded 2dgs",
                    torch.cat([r["block_2dgs"][0] for r in ranks]).to(dev), ref["image_d_x"])
    if ranks[0]["dp_sp_checksum"] != ranks[1]["dp_sp_checksum"]:
        raise AssertionError("parallel: the ranks' ZeRO-1 replicas differ")
    # Each rank's parameters after the ZeRO-1 step, bitwise at the replicated
    # update from its all-reduced gradient; rank 0's gradient is held to the
    # single device's below.
    off = [r["dp_sp_update_off"] for r in ranks]
    phase("parallel", f"2 ranks train_step_sharded zero1: {off} parameter values off the "
          f"replicated update p - grad (rank 0, rank 1)")
    if any(off):
        raise AssertionError("train_step_sharded zero1: the update is not the replicated one")
    for name, key, scale in (("train_step_sharded zero1", "dp_sp", 1.0),
                             ("train_step_sharded_surfel (the reference's n_dev x)", "surfel",
                              2.0)):
        want = ref["loss_x" if key == "dp_sp" else "surfel_loss_x"]
        for r in ranks:
            if abs(r[f"{key}_loss"] - want) > 1e-5 * want:
                raise AssertionError(f"{name}: rank {r['rank']} loss {r[key + '_loss']} "
                                     f"against {want}")
        grads_agree(f"parallel 2 ranks {name}", ranks[0][f"{key}_grad"],
                    ref["grad_x" if key == "dp_sp" else "surfel_grad_x"], scale)
    blend_agreement("parallel 2 ranks render_gaussians_sharded",
                    torch.cat([r["gauss_slab"] for r in ranks]).to(dev), ref["image"])
    grad = {k: torch.cat([r["gauss_grad"][k] for r in ranks]) for k in ref["grad"]}
    grads_agree("parallel 2 ranks train_step_gauss_sharded step 1", grad, ref["grad"])
    losses = ranks[0]["gauss_losses"]
    if abs(losses[0] - ref["loss"]) > 1e-5 * ref["loss"] or not all(np.isfinite(losses)):
        raise AssertionError(f"train_step_gauss_sharded: losses {losses} against {ref['loss']}")
    aux = dict(zip(("num_isects", "capacity_overflow", "span_truncated", "route_overflow",
                    "tile_overflow"), ranks[0]["gauss_aux"]))
    phase("parallel", f"2 ranks: {ranks[0]['gauss_rows']} gaussians a rank; RouteAux "
          f"{json.dumps(aux)}; gauss losses {', '.join(f'{x:.6e}' for x in losses)}")
    phase("parallel", f"phase 17 in {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(PAR_DIR, ignore_errors=True)
    r0 = ranks[0]["counts"]
    return {"dp_sp": r0["dp_sp_zero1"], "surfel": r0["surfel"],
            "gauss": r0["gauss_step"][0], "render_3dgs": r0["render_3dgs"],
            "render_2dgs": r0["render_2dgs"]}


# ---- Phase 18: the tools


def tools_phase(smi: str) -> dict:
    """Phase 18: the tools through their CLIs' ``main(argv)`` on the card
    (see the phase 18 constants above). Returns, per kernel, its launches
    per unit of each tool that runs it (a stage call, a view, a record; each
    checked exactly)."""
    from PIL import Image

    from mojosplat_tpu_torch.examples import (
        benchmark, benchmark_proj, make_synth_colmap, record_parity, resample_sfm, train_colmap)
    from mojosplat_tpu_torch.utils import colmap as cm
    from mojosplat_tpu_torch.utils.image import to_uint8
    from mojosplat_tpu_torch.utils.metrics import amortized_ms
    from mojosplat_tpu_torch.ops.surfel_cuda import raster_surfel_tiles_fwd

    dev = torch.device("cuda", 0)
    t_phase = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    per_unit = {}

    def note(kid: str, tool: str, count: int, units: int) -> None:
        if count % units:
            raise AssertionError(f"tools: {tool}: {kid} launched {count} times in {units} units")
        per_unit.setdefault(kid, {})[tool] = count // units

    # ---- (a) benchmark_proj: no kernel, EWA and UT at 1080p
    argv = ["--impls", "ewa", "ut", "--gaussians", *map(str, TOOLS_PROJ_COUNTS),
            "--height", str(H), "--width", str(W)]
    out, _, ms = counted(lambda: benchmark_proj.main(argv), (), "benchmark_proj")
    res = out["results"]
    if len(res) != 2 * len(TOOLS_PROJ_COUNTS) or not all(
            math.isfinite(v) and v > 0 for r in res for v in (r.mean_ms, r.min_ms, r.max_ms)):
        raise AssertionError(f"benchmark_proj: results {res}")
    phase("tools-18", f"benchmark_proj at {W}x{H} in {ms / 1e3:.1f} s: " + ", ".join(
        f"{r.name} {r.n_gaussians} {r.mean_ms:.4f} ms" for r in res) + f"; {smi}")

    # ---- (b) benchmark: every stage's launches on both routes
    def time_stage(impl, name, fn, fn_args, iters):
        expect = BENCH_STAGE_KERNELS[name] if impl == "cuda" else ()
        t, counts, _ = counted(lambda: amortized_ms(fn, fn_args, iters), expect,
                               f"benchmark {impl} {name}")
        for kid in expect:  # an untimed call, one call and ``iters`` calls
            note(kid, f"benchmark {name} per call", counts[kid], iters + 2)
        return t

    tables = {}
    for argv in (["--impls", "torch", "cuda"],
                 ["--impls", "cuda", "--gaussians", str(TOOLS_BENCH_N), "--height", str(H),
                  "--width", str(W)]):
        t0 = time.perf_counter()
        table = benchmark.main(argv, time_stage=time_stage)
        tables.update(table)
        for (n, impl), r in table.items():
            phase("tools-18", f"benchmark {impl} {n} gaussians: " + ", ".join(
                f"{k} {v:.4f} ms" if k != "num_isects" else f"{k} {v}" for k, v in r.items())
                + f"; {smi}")
        phase("tools-18", f"benchmark {' '.join(argv)}: {time.perf_counter() - t0:.1f} s")
    d = benchmark.build_parser().parse_args([])
    n0 = d.gaussians[0]
    if tables[(n0, "torch")]["num_isects"] != tables[(n0, "cuda")]["num_isects"]:
        raise AssertionError(f"benchmark: num_isects differ across the routes at {n0}")

    # ---- (c) the capture maker at its defaults, the resampler, train_colmap
    cap = TOOLS_DIR / "synth_scene"
    m = make_synth_colmap.build_parser().parse_args(["--out", str(cap)])
    t0 = time.perf_counter()
    made, counts, _ = counted(lambda: make_synth_colmap.main(["--out", str(cap)]),
                              ("B4", "B5", "B1"), "make_synth_colmap")
    for kid in ("B4", "B5", "B1"):
        note(kid, "make_synth_colmap per view", counts[kid], made["views"])
    phase("tools-18", f"make_synth_colmap: {made['gaussians']} gaussians, {made['views']} views "
          f"at {m.width}x{m.height}, {made['sfm_points']} SfM points in "
          f"{time.perf_counter() - t0:.1f} s; seconds a view (render and PNG) median "
          f"{statistics.median(made['seconds']):.4f}, first {made['seconds'][0]:.4f}; qvec->R "
          f"round trip {made['r_err']:.2e}; {smi}")
    gt = make_synth_colmap.build_scene(np.random.default_rng(7), m.detail)
    gt = {k: torch.from_numpy(v).to(dev) for k, v in gt.items()}
    R0, T0 = make_synth_colmap.ring_cameras(m.views)[0]
    cam0 = make_synth_colmap.view_camera(R0, T0, m.height, m.width, device=dev)
    view = {impl: make_synth_colmap.render_view(gt, cam0, make_synth_colmap.render_config(impl))
            for impl in ("cuda", "torch")}
    blend_agreement("tools-18 maker view 0 cuda vs torch route", view["cuda"], view["torch"])
    png = np.asarray(Image.open(cap / "images" / "view_000.png").convert("RGB"))
    if not np.array_equal(png, to_uint8(view["cuda"].cpu().numpy())):
        raise AssertionError("make_synth_colmap: view_000.png differs from the cuda render")
    phase("tools-18", "view_000.png equals to_uint8 of the cuda-route render byte for byte")

    t0 = time.perf_counter()
    resampled, _, _ = counted(lambda: resample_sfm.main(
        ["--root", str(cap), "--sfm-points", str(TOOLS_RESAMPLE)]), (), "resample_sfm")
    scene = cm.load_scene(str(cap / "sparse" / "0"))
    if scene.points_xyz.shape[0] != TOOLS_RESAMPLE or len(scene.images) != m.views:
        raise AssertionError(f"resample_sfm: load_scene reads {scene.points_xyz.shape[0]} "
                             f"points and {len(scene.images)} views")
    phase("tools-18", f"resample_sfm to {TOOLS_RESAMPLE} points (with replacement: "
          f"{resampled['replace']}), {resampled['observations']} observations, in "
          f"{time.perf_counter() - t0:.1f} s (host)")

    kernels3 = ("B1", "B2", "B3", "B4", "B5")
    wrappers = kernel_wrappers()
    step_ms, last = [], [0.0]

    def reset():
        for wrapper, attr in wrappers.values():
            setattr(wrapper, attr, 0)

    def on_step(step, loss):
        torch.cuda.synchronize()
        now = time.perf_counter()
        launched = {k: getattr(w, a) for k, (w, a) in wrappers.items()}
        if any(launched[k] != (1 if k in kernels3 else 0) for k in launched):
            raise AssertionError(f"tools: train_colmap step {step} launched {launched}")
        step_ms.append((now - last[0]) * 1e3)
        last[0] = now
        reset()

    out_dir = TOOLS_DIR / "train"
    reset()
    torch.cuda.synchronize()
    last[0] = time.perf_counter()
    trained = train_colmap.main(["--data", str(cap), "--downscale", "1", "--steps",
                                 str(TOOLS_TRAIN_STEPS), "--out-dir", str(out_dir)],
                                on_step=on_step)
    losses = np.array(trained["losses"])
    if len(losses) != TOOLS_TRAIN_STEPS or not np.isfinite(losses).all():
        raise AssertionError(f"tools: train_colmap losses {losses}")
    if not (out_dir / "scene_final.ply").stat().st_size:
        raise AssertionError("tools: train_colmap wrote an empty PLY")
    for kid in kernels3:
        note(kid, "train_colmap per step", 1, 1)
    phase("tools-18", f"train_colmap on the maker's capture ({m.width}x{m.height}, "
          f"{TOOLS_RESAMPLE} SfM points): losses " + ", ".join(f"{x:.5f}" for x in losses)
          + f"; median step {statistics.median(step_ms[1:]):.2f} ms; PLY "
          f"{(out_dir / 'scene_final.ply').stat().st_size} bytes; {smi}")

    # ---- (d) record_parity, one family a call (each call resumes the file)
    path = TOOLS_DIR / "parity.json"
    expects = {"3dgs": kernels3, "2dgs": ("B3", "B4", "B5", "B6", "B8"),
               "3dgs_ts32_tight": kernels3}
    for name, expect in expects.items():
        raster_surfel_tiles_fwd.residuals = 0
        t0 = time.perf_counter()
        rec, counts, _ = counted(lambda: record_parity.main([str(path), name]), expect,
                                 f"record_parity {name}")
        for kid in expect:
            note(kid, f"record_parity {name} per record", counts[kid], 1)
        r = rec[name]
        numel = record_parity.H * record_parity.W * 3
        share = r["fwd_pixels_above_1e5"] / numel
        worst = max(r["grad_max_rel_exact"].values())
        surfel = name == "2dgs"
        max_share, max_err = (ROUTE_MAX_SHARE, ROUTE_MAX_ERR) if surfel else (
            BLEND_MAX_SHARE, BLEND_MAX_ERR)
        grad_max = ROUTE_GRAD_MAX_REL if surfel else GRAD_MAX_REL
        phase("tools-18", f"record_parity {name} in {time.perf_counter() - t0:.1f} s: launches "
              + json.dumps({k: v for k, v in counts.items() if v})
              + (f", B6 residuals {raster_surfel_tiles_fwd.residuals}" if surfel else "")
              + f"; forward {share:.3e} of values off by more than 1e-5 (max {max_share}), "
              f"max {r['fwd_max_abs_diff']:.3e} (max {max_err}); largest gradient difference "
              f"{worst:.3e} of its scale (max {grad_max})")
        if share > max_share or r["fwd_max_abs_diff"] > max_err or not worst <= grad_max:
            raise AssertionError(f"record_parity {name}: outside its rule: {r}")
    rec = json.loads(path.read_text())
    if set(rec) != {"git_rev", "workload", "device", "note", *expects}:
        raise AssertionError(f"record_parity: the file holds {sorted(rec)}")
    print(json.dumps(rec), flush=True)
    phase("tools-18", f"phase 18 in {time.perf_counter() - t_phase:.1f} s")
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    return per_unit


def main() -> int:
    # ---- 1. Device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, str(ROOT))
    from mojosplat_tpu_torch import Camera, RenderConfig, _kernels, render_gaussians
    from mojosplat_tpu_torch.convert import params_from_numpy
    from mojosplat_tpu_torch.ops import binning as binning_mod
    from mojosplat_tpu_torch.ops.expand_cuda import (
        segment_expand_offsets, segment_expand_offsets_plain)
    from mojosplat_tpu_torch.ops.projection import project_gaussians
    from mojosplat_tpu_torch.ops.raster_cuda import (
        B1_WARP_PIXELS, gather_tile_data, raster_bwd_shape, raster_tiles, raster_tiles_bwd,
        raster_tiles_bwd_plain, raster_tiles_fwd, raster_tiles_plain)
    from mojosplat_tpu_torch.ops.raster_probe import raster_variant
    from mojosplat_tpu_torch.ops.segsum_cuda import (
        segment_sum_cols, segment_sum_cols_plain, segsum_shape)
    from mojosplat_tpu_torch.ops.sh import sh_to_color
    from mojosplat_tpu_torch.ops.slice_cuda import (
        segment_slice_gather, segment_slice_gather_plain)
    from mojosplat_tpu_torch.train import activate, l2_image_loss, make_optimizer, train_step
    from mojosplat_tpu_torch.utils.compress import load_compressed_scene
    from mojosplat_tpu_torch.utils.scenes import TRAINED_SCENE, scene_camera

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phase("device", f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # ---- 2. Build
    t0 = time.perf_counter()
    _, log = _kernels.build()
    _kernels.library()
    phase("build", f"{time.perf_counter() - t0:.2f} s for "
          f"{', '.join(p.name for p in _kernels.sources())}")
    report = ptxas_report(log)
    probe = [r for r in report if "raster_probe_kernel" in r[0]]
    for name, regs, spills, smem in report:
        if "raster_probe_kernel" not in name:
            phase("build", f"{name}: {regs} registers, {smem} bytes smem, {spills}")
    phase("build", f"B9 raster_probe_kernel: {len(probe)} instantiations, "
          f"{min(r[1] for r in probe)}-{max(r[1] for r in probe)} registers, "
          f"{sum('0 bytes spill stores' not in r[2] for r in probe)} with spills")

    # ---- 3. Golden
    with np.load(GOLDEN) as z:
        golden = {k: z[k] for k in z.files}
    gp = params_from_numpy(
        {k[3:]: v for k, v in golden.items() if k.startswith("in_")}, dev)
    gcam = Camera.create(R=np.eye(3), T=np.zeros(3), H=64, W=64, fx=70.0,
                         fy=70.0, cx=32.0, cy=32.0, device=dev)
    gcfg = RenderConfig(tile_capacity=128, chunk_size=32, raster_impl="cuda")

    def render_golden(p):
        return render_gaussians(*(p[k] for k in KEYS), gcam, sh_degree=2,
                                background_color=(0.15, 0.05, 0.25), config=gcfg,
                                return_depth=True)

    with torch.no_grad():
        img, depth = render_golden(gp)
    img, depth = img.cpu().numpy(), depth.cpu().numpy()
    np.testing.assert_allclose(img, golden["image"], rtol=GOLDEN_RTOL, atol=GOLDEN_ATOL)
    depth_atol = GOLDEN_ATOL * (float(np.abs(golden["aux_depth"]).max()) + 1.0)
    np.testing.assert_allclose(depth, golden["aux_depth"], rtol=GOLDEN_RTOL, atol=depth_atol)
    phase("golden", f"image max abs diff {np.abs(img - golden['image']).max():.3e}, "
          f"depth {np.abs(depth - golden['aux_depth']).max():.3e}: ok")

    # ---- 4. Kernels against their plain versions at the scene's shapes
    t0 = time.perf_counter()
    raw = load_compressed_scene(str(ROOT / TRAINED_SCENE))
    raw_dev = params_from_numpy(raw, dev)
    params = activate(raw_dev)
    n = params["means3d"].shape[0]
    sh_degree = int(round(params["features"].shape[1] ** 0.5)) - 1
    cam = scene_camera(H, W, device=dev)
    torch.cuda.synchronize()
    phase("scene", f"{n} gaussians, SH degree {sh_degree}, loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    cfg_torch = RenderConfig(raster_impl="torch", **SCENE_BUDGETS)
    cfg_cuda = RenderConfig(raster_impl="cuda", **SCENE_BUDGETS)
    ts, cap = cfg_torch.tile_size, cfg_torch.tile_capacity
    th, tw = binning_mod.num_tiles(H, W, ts)
    n_tiles, P = th * tw, ts * ts

    kernels = []
    with torch.no_grad():
        proj = project_gaussians(params["means3d"], params["scales"], params["quats"],
                                 params["opacities"], cam, cfg_torch)
        colors = sh_to_color(params["features"], params["means3d"], cam.position, sh_degree)
        pre = binning_mod.presort_gaussians(proj.means2d, proj.radii, proj.depths,
                                            th, tw, cfg_torch, proj.conics, params["opacities"])
        capacity = binning_mod.isect_capacity(n, cfg_torch)
        bins = binning_mod.bin_gaussians_to_tiles(proj.means2d, proj.radii, proj.depths,
                                                  H, W, cfg_torch, conics=proj.conics,
                                                  opacities=params["opacities"])
        ranges = bins.tile_ranges.reshape(-1, 2)
        starts = ranges[:, 0].contiguous()
        counts = torch.clamp(ranges[:, 1] - ranges[:, 0], 0, cap).to(torch.int32)
        total = int(pre.total)

        # B4: (F, N) int32 read once, (F, capacity) int32 written once.
        got = segment_expand_offsets(pre.fields, capacity)
        want = segment_expand_offsets_plain(pre.fields, capacity)
        if not torch.equal(got, want):
            raise AssertionError("B4: kernel and plain version differ")
        repeats = torch.diff(pre.fields[0], append=pre.total.reshape(1))
        kernels.append(dict(
            name="B4 segment_expand_offsets", route="cuda",
            source="mojosplat_tpu_torch/csrc/expand.cu",
            replaces="mojosplat_tpu/ops/expand_pallas.py:143",
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(lambda: segment_expand_offsets(pre.fields, capacity), 20, 3),
            ms_queued=cuda_ms_queued(lambda: segment_expand_offsets(pre.fields, capacity), 20, 3),
            plain_ms=cuda_ms(lambda: segment_expand_offsets_plain(pre.fields, capacity), 20, 3),
            **bound(4 * (pre.fields.numel() + pre.fields.shape[0] * capacity), 0),
            library_ms=cuda_ms(lambda: torch.repeat_interleave(
                pre.fields, repeats, dim=1, output_size=total), 20, 3),
            library_ms_queued=cuda_ms_queued(lambda: torch.repeat_interleave(
                pre.fields, repeats, dim=1, output_size=total), 20, 3),
        ))
        phase("B4", f"{pre.fields.shape[1]} gaussians -> {capacity} slots "
              f"({total} demanded): exact on every column; 20 calls queued back to back: "
              f"{kernels[-1]['ms_queued']:.4f} ms a call, repeat_interleave "
              f"{kernels[-1]['library_ms_queued']:.4f}")

        # B5: starts, the distinct list entries the tiles' windows cover,
        # and the (n_tiles * cap,) table.
        got = segment_slice_gather(bins.gaussian_ids, starts, cap)
        want = segment_slice_gather_plain(bins.gaussian_ids, starts, cap)
        if not torch.equal(got, want):
            raise AssertionError("B5: kernel and plain version differ")
        M = bins.gaussian_ids.shape[0]
        edge = torch.zeros(M + 1, dtype=torch.int32, device=dev)
        one = torch.ones(n_tiles, dtype=torch.int32, device=dev)
        edge.index_add_(0, starts.clamp(0, M).long(), one)
        edge.index_add_(0, (starts + cap).clamp(0, M).long(), -one)
        covered = int((torch.cumsum(edge[:M], 0) > 0).sum())
        kernels.append(dict(
            name="B5 segment_slice_gather", route="cuda",
            source="mojosplat_tpu_torch/csrc/slice.cu",
            replaces="mojosplat_tpu/ops/slice_pallas.py:36",
            max_abs_err=float((got - want).abs().max()),
            ms=cuda_ms(lambda: segment_slice_gather(bins.gaussian_ids, starts, cap), 20, 3),
            ms_queued=cuda_ms_queued(
                lambda: segment_slice_gather(bins.gaussian_ids, starts, cap), 20, 3),
            plain_ms=cuda_ms(lambda: segment_slice_gather_plain(bins.gaussian_ids, starts, cap), 20, 3),
            **bound(4 * (n_tiles + covered + n_tiles * cap), 0),
            library_ms=None,
        ))
        phase("B5", f"{n_tiles} tiles x {cap} slots: exact; 20 calls queued back to back: "
              f"{kernels[-1]['ms_queued']:.4f} ms a call")
        slot_gids = got

        # B1: the slots each tile blends, counts, and the output; the pairs
        # each pixel walks up to its stop, from the residual's stop index.
        pdata = gather_tile_data(proj.means2d, proj.conics, colors, params["opacities"],
                                 slot_gids, counts)
        rows = pdata.shape[0]
        out = raster_tiles(pdata, counts, ts, tw, cfg_cuda)
        ref = raster_tiles_plain(pdata, counts, ts, tw, cfg_cuda)
        err = blend_agreement("B1", out, ref)
        out_r, resid = raster_tiles_fwd(pdata, counts, ts, tw, cfg_cuda, residual=True)
        if not torch.equal(out_r, out):
            raise AssertionError("B1: the output changes when the residual is written")
        walked = torch.minimum(resid[1], counts[:, None])
        pairs = int(walked.sum())
        slots = int(counts.sum())
        skips = blend_skip_counts(pdata, counts, ts, tw, cfg_cuda)
        # The work the row test leaves: the walked pairs of the (warp, slot)
        # pairs it keeps, and a test of each of the warp's rows per (warp,
        # slot) pair tested.
        need = skips["walked_may"]
        row_tests = max(1, B1_WARP_PIXELS // ts) * skips["tested"]
        kernels.append(dict(
            name="B1 raster_tiles (blend forward)", route="cuda",
            source="mojosplat_tpu_torch/csrc/raster_fwd.cu",
            replaces="mojosplat_tpu/ops/raster_pallas.py:491",
            max_abs_err=err,
            ms=cuda_ms(lambda: raster_tiles(pdata, counts, ts, tw, cfg_cuda), 20, 3),
            ms_with_residual=cuda_ms(
                lambda: raster_tiles_fwd(pdata, counts, ts, tw, cfg_cuda, True), 20, 3),
            plain_ms=cuda_ms(lambda: raster_tiles_plain(pdata, counts, ts, tw, cfg_cuda), 20, 3),
            **bound(4 * (rows * slots + n_tiles + out.numel()),
                    B1_OPS_PER_PAIR * need + B1_ROW_TEST_OPS * row_tests,
                    need + B1_ROW_TEST_SFU * row_tests),
            library_ms=None, skips=skips,
        ))
        phase("B1", f"pdata {tuple(pdata.shape)}, {slots} slots, {pairs} (pixel, slot) "
              f"pairs walked, {need} of them in (warp, slot) pairs the row test keeps; "
              f"bit-equal with the residual written")
        phase("B1", f"row test: B1 skipped {skips['skipped']} of the {skips['tested']} "
              f"(warp, slot) pairs its warps ({B1_WARP_PIXELS} pixels each) tested "
              f"({skips['skipped'] / skips['tested']:.4f}), equal to the plain mirror's count; "
              f"of the {skips['warp_slots']} (warp, slot) pairs below the counts no pixel "
              f"keeps {skips['warp_slots_unkept']} "
              f"({skips['warp_slots_unkept'] / skips['warp_slots']:.4f}) and the row test "
              f"skips {skips['warp_slots_skipped']} "
              f"({skips['warp_slots_skipped'] / skips['warp_slots']:.4f}), none kept; of the "
              f"{skips['walked']} walked (pixel, slot) pairs {skips['walked_unkept']} "
              f"({skips['walked_unkept'] / skips['walked']:.4f}) are not kept")
        for name, regs, spills, smem in report:
            if "raster_fwd_kernel" in name or "raster_bwd_kernel" in name:
                kid = "B1" if "raster_fwd_kernel" in name else "B2"
                phase(kid, f"ptxas {name}: {regs} registers, {smem} bytes smem, {spills}")
        del ref, out_r

        # B2: pdata's blended slots, gout, the residual's walked chunks and
        # stop, counts, and d pdata written once.
        rng = np.random.default_rng(1)
        gout = torch.from_numpy(
            rng.standard_normal((n_tiles, rows - 5, P), dtype=np.float32)).to(dev)
        d_pdata = raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda)
        cfg_plain = RenderConfig(raster_impl="cuda", tile_batch=128, **SCENE_BUDGETS)
        d_want = raster_tiles_bwd_plain(pdata, counts, gout, ts, tw, cfg_plain)
        err = grad_agreement("B2", d_pdata, d_want)
        if not torch.equal(raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda),
                           d_pdata):
            raise AssertionError("B2: two runs differ")
        chunk_reads = int(((walked + 15) // 16).sum())
        kernels.append(dict(
            name="B2 raster_tiles_bwd (blend backward)", route="cuda",
            source="mojosplat_tpu_torch/csrc/raster_bwd.cu",
            replaces="mojosplat_tpu/ops/raster_pallas.py:540",
            max_abs_err=err,
            ms=cuda_ms(lambda: raster_tiles_bwd(pdata, counts, gout, resid, ts, tw, cfg_cuda),
                       20, 3),
            plain_ms=cuda_ms(lambda: raster_tiles_bwd_plain(
                pdata, counts, gout, ts, tw, cfg_plain), 3, 1),
            **bound(4 * (rows * slots + gout.numel() + chunk_reads + resid[1].numel()
                         + n_tiles + d_pdata.numel()),
                    B2_OPS_PER_PAIR * need + B1_ROW_TEST_OPS * row_tests,
                    need + B1_ROW_TEST_SFU * row_tests),
            library_ms=None,
        ))
        shape = raster_bwd_shape(rows - 6, ts)
        kernels[-1]["shape"] = shape
        phase("B2", f"d pdata {tuple(d_pdata.shape)} from a seeded gout; two runs "
              f"bitwise equal; launch shape: clusters of {shape['cluster']} blocks of "
              f"{shape['threads']} threads per tile, {shape['registers']} registers, "
              f"{shape['local_bytes']} local bytes a thread, {shape['shared_bytes']} shared "
              f"bytes a block, {shape['blocks_per_sm']} blocks per SM, {shape['clusters']} "
              f"clusters resident")
        del d_want

        # B3: the gather adjoint's keys (the clamped slot ids, n past each
        # tile's count) sorted, with B2's first 6 + C rows read in that order
        # through the sort's perm, as the adjoint calls it; held bit for bit
        # to the plain version on CPU copies (index_add_ on the CPU adds in
        # row order, as B3 does). Bound: the live values, their perm entries
        # and the keys read once, (F, N) written once, one add per value.
        nf = 6 + colors.shape[1]
        rows_b3 = d_pdata[:nf]
        safe = slot_gids.clamp(0, n - 1)
        live = (torch.arange(cap, device=dev)[None, :] < counts[:, None]).reshape(-1)
        keys, perm = torch.sort(torch.where(live, safe, n), stable=True)
        longest = [int(torch.bincount(k).max()) for k in (safe, keys[keys < n])]
        cols = rows_b3.index_select(1, perm).contiguous()  # the sorted payload
        seg = segment_sum_cols(rows_b3, keys, n, perm=perm)
        err = b3_bit_equal("B3", seg, cols, keys, n)
        if not torch.equal(segment_sum_cols(cols, keys, n), seg):
            raise AssertionError("B3: the sorted payload's sums differ from perm's")
        if not torch.equal(segment_sum_cols(rows_b3, keys, n, perm=perm), seg):
            raise AssertionError("B3: two runs differ")
        keys64 = keys.long()
        sink = torch.zeros((nf, n + 1), device=dev)  # + the dropped key
        n_live = int(live.sum())
        routed = nf * n_live  # the values B3 reads and adds
        shape = segsum_shape()
        kernels.append(dict(
            name="B3 segment_sum_cols", route="cuda",
            source="mojosplat_tpu_torch/csrc/segsum.cu",
            replaces="mojosplat_tpu/ops/segsum_pallas.py:79",
            max_abs_err=err,
            ms=cuda_ms(lambda: segment_sum_cols(rows_b3, keys, n, perm=perm), 20, 3),
            ms_queued=cuda_ms_queued(
                lambda: segment_sum_cols(rows_b3, keys, n, perm=perm), 20, 3),
            plain_ms=cuda_ms(lambda: segment_sum_cols_plain(rows_b3, keys, n, perm), 20, 3),
            **bound(4 * (routed + 2 * n_live + keys.numel() + nf * n), routed),
            library_ms=cuda_ms(lambda: sink.index_add_(1, keys64, cols), 20, 3),
            library_ms_queued=cuda_ms_queued(lambda: sink.index_add_(1, keys64, cols), 20, 3),
            # Without perm, on the sorted payload (the reference's function;
            # its bound without the perm entries).
            ms_sorted=cuda_ms(lambda: segment_sum_cols(cols, keys, n), 20, 3),
            ms_sorted_queued=cuda_ms_queued(lambda: segment_sum_cols(cols, keys, n), 20, 3),
            bound_ms_sorted=bound(4 * (routed + keys.numel() + nf * n), routed)["bound_ms"],
            shape=shape,
        ))
        phase("B3", f"{nf} x {cols.shape[1]} values read through perm -> {n} segments "
              f"({n_live} live slots; longest segment {longest[1]}, "
              f"{longest[0]} if the slots past the counts were routed too); bit-equal to "
              f"the plain version on the CPU, with and without perm; two runs bitwise equal; "
              f"20 calls queued back to back: {kernels[-1]['ms_queued']:.4f} ms a call "
              f"({kernels[-1]['ms_sorted_queued']:.4f} on the sorted payload), index_add_ "
              f"{kernels[-1]['library_ms_queued']:.4f}")
        windows, groups = -(-n // shape["threads"]), -(-nf // 3)  # groups of <= 3 fields
        phase("B3", f"launch shape: {windows} windows of {shape['threads']} segments x "
              f"{groups} field groups = {windows * groups} blocks of {shape['threads']} threads "
              f"(a segment a thread), {shape['registers']} registers, "
              f"{shape['local_bytes']} local bytes a thread, {shape['shared_bytes']} shared "
              f"bytes a block, {shape['blocks_per_sm']} blocks per SM")
        adj = adjoint_ms(slot_gids, counts, d_pdata, nf, n)
        kernels[-1]["adjoint_ms"] = adj
        phase("B3", f"the gather adjoint at the 3DGS step's shapes ({d_pdata.shape[0]} rows, "
              f"{nf} routed): {adj['ms']:.4f} ms a call, {adj['ms_queued']:.4f} queued")
        for k in kernels:
            lib = "none" if k["library_ms"] is None else f"{k['library_ms']:.4f} ms"
            phase("time", f"{k['name']}: kernel {k['ms']:.4f} ms, plain {k['plain_ms']:.4f} ms, "
                  f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), library {lib}")
        del proj, colors, pre, bins, pdata, out, got, want, resid, gout, d_pdata
        del cols, seg, sink, keys, keys64, perm, safe, live, slot_gids, edge, repeats, rows_b3

    # ---- 5. The main path, serving: render the trained scene on the "cuda" route
    counters = (segment_expand_offsets, segment_slice_gather, raster_tiles,
                raster_tiles_bwd, segment_sum_cols, raster_variant)

    def reset_counters():
        for fn in counters:
            fn.launches = 0
        raster_tiles_fwd.residuals = 0

    def render(p, config, camera=cam, background=BACKGROUND, **kw):
        return render_gaussians(
            *(p[k] for k in KEYS), camera, sh_degree=sh_degree, background_color=background,
            config=config, **kw)

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_counters()
        image, aux = render(params, cfg_cuda, return_aux=True)
        torch.cuda.synchronize()
        launches_render = [fn.launches for fn in counters]
        peak = torch.cuda.max_memory_allocated(dev)
        phase("render", f"launches during the render: B4 {launches_render[0]}, "
              f"B5 {launches_render[1]}, B1 {launches_render[2]}, B2 {launches_render[3]}, "
              f"B3 {launches_render[4]}, B9 {launches_render[5]}; residuals written "
              f"{raster_tiles_fwd.residuals}")
        if min(launches_render[:3]) < 1:
            raise AssertionError("a kernel of the path was not launched by the render")
        if max(launches_render[3:]) or raster_tiles_fwd.residuals:  # B2, B3, B9
            raise AssertionError("the no-grad render ran a backward kernel or wrote a residual")
        if image.shape != (H, W, 3) or not bool(torch.isfinite(image).all()):
            raise AssertionError(f"render: bad image {tuple(image.shape)} or non-finite")
        counts_cuda = drop_counters(aux)
        phase("render", "counters " + json.dumps(counts_cuda))

        image_t, aux_t = render(params, cfg_torch, return_aux=True)
        counts_torch = drop_counters(aux_t)
        if counts_torch != counts_cuda:
            raise AssertionError(f"route counters differ: {counts_torch} vs {counts_cuda}")
        blend_agreement("render vs torch route", image, image_t)
        del image_t, aux_t

        render_ms = cuda_ms(lambda: render(params, cfg_cuda), 10, 1)
        torch_ms = cuda_ms(lambda: render(params, cfg_torch), 10, 1)
        phase("render", f"median of 10: cuda route {render_ms:.3f} ms "
              f"({H * W / (render_ms / 1e3):.1f} pixels/s), torch route {torch_ms:.3f} ms; "
              f"peak memory of one cuda-route render {peak} bytes")
        # Preset 6 without its culling, once, for the counters and the time.
        cfg_aabb = RenderConfig(raster_impl="cuda", **dict(SCENE_BUDGETS, tight_cull=False))
        image_a, aux_a = render(params, cfg_aabb, return_aux=True)
        aabb_ms = cuda_ms(lambda: render(params, cfg_aabb), 10, 1)
        phase("render", "without tight_cull: counters " + json.dumps(drop_counters(aux_a))
              + f", median of 10 {aabb_ms:.3f} ms; with it {render_ms:.3f} ms")
        # Under the tile cap the two keep other slots, so the images differ.
        phase("render", f"max |image with - without tight_cull| "
              f"{float((image - image_a).abs().max()):.3e}")
        del image_a, aux_a
        # train_step renders on the default (black) background.
        target = render(params, cfg_cuda, background=None)

    # ---- 6. Golden gradients on the "cuda" route
    gleaves = {k: v.clone().requires_grad_(True) for k, v in gp.items()}
    img, depth = render_golden(gleaves)
    (torch.mean(img**2) + 1e-3 * torch.mean(depth**2)).backward()
    worst = []
    for k in KEYS:
        g, want = gleaves[k].grad.cpu().numpy(), golden[f"grad_{k}"]
        np.testing.assert_allclose(g, want, rtol=GOLDEN_RTOL,
                                   atol=GOLDEN_ATOL * float(np.abs(want).max()),
                                   err_msg=f"golden gradient {k}")
        worst.append(f"{k} {np.abs(g - want).max():.3e}")
    phase("golden-grad", "max abs diff " + ", ".join(worst) + ": ok")

    # ---- 7. The main path, training: 10 Adam steps on the trained scene
    leaves = perturbed_leaves(raw, dev)
    opt = make_optimizer(leaves, lr=TRAIN_LR)
    phase("train", f"Adam lr {TRAIN_LR}; raw parameters perturbed by N(0, s^2) noise "
          f"(numpy seed {TRAIN_SEED}), s = {json.dumps(PERTURB)}; target: the cuda-route "
          f"render of the unperturbed scene")
    with torch.no_grad():
        _, aux = render(activate(leaves), cfg_cuda, background=None, return_aux=True)
    phase("train", "counters at the start " + json.dumps(drop_counters(aux)))

    losses, step_ms, launches_train, peak_train = train_steps(
        lambda: train_step(leaves, opt, [cam], target[None], sh_degree=sh_degree,
                           config=cfg_cuda),
        reset_counters, lambda: [fn.launches for fn in counters] + [raster_tiles_fwd.residuals],
        dev)
    residuals_train = launches_train.pop()
    with torch.no_grad():
        final = float(l2_image_loss(render(activate(leaves), cfg_cuda, background=None),
                                    target))
    phase("train", "loss per step " + ", ".join(f"{x:.6e}" for x in losses)
          + f"; after step {TRAIN_STEPS}: {final:.6e}")
    phase("train", f"launches during one step: B4 {launches_train[0]}, B5 {launches_train[1]}, "
          f"B1 {launches_train[2]}, B2 {launches_train[3]}, B3 {launches_train[4]}, "
          f"B9 {launches_train[5]}; "
          f"residuals written {residuals_train}")
    if not all(np.isfinite(losses)) or not np.isfinite(final) or not final < losses[0]:
        raise AssertionError("train: the loss is not finite or did not fall")
    if min(launches_train[:5]) < 1 or launches_train[5]:
        raise AssertionError("train: a kernel of the path was not launched by the step, or "
                             "the probe was")
    med = statistics.median(step_ms)
    phase("train", f"step time median of {TRAIN_STEPS} {med:.3f} ms (steps "
          + ", ".join(f"{x:.3f}" for x in step_ms) + f"), {1e3 / med:.3f} steps/s; "
          f"peak memory of one step {peak_train} bytes")

    def grads_of(p, config, camera, tgt):
        for t in p.values():
            t.grad = None
        l2_image_loss(render(activate(p), config, camera, background=None), tgt).backward()
        return {k: t.grad.clone() for k, t in p.items()}

    check_bitwise(lambda: grads_of(leaves, cfg_cuda, cam, target), "train")
    del opt

    # Both routes at a quarter of the resolution and every 4th gaussian: the
    # plain route's autograd keeps every chunk's intermediates.
    small = {k: v.detach()[::4].contiguous() for k, v in leaves.items()}
    cam_s = scene_camera(H // 4, W // 4, device=dev)
    with torch.no_grad():
        target_s = render(activate({k: v[::4] for k, v in raw_dev.items()}), cfg_cuda, cam_s,
                          background=None)
    routes = {}
    for name, config in (("cuda", cfg_cuda), ("torch", cfg_torch)):
        p = {k: v.clone().requires_grad_(True) for k, v in small.items()}
        routes[name] = grads_of(p, config, cam_s, target_s)
    for k in routes["cuda"]:
        grad_agreement(f"train d {k} cuda vs torch route ({small['means3d'].shape[0]} "
                       f"gaussians, {H // 4}x{W // 4})",
                       routes["cuda"][k][None], routes["torch"][k][None])
    del routes, small, leaves

    # ---- 8-11. The 2DGS surfel path
    surfel_phases(raw, sh_degree, cam, gcam, gcfg, kernels)

    # ---- 12. B9, the blend-variant probe
    probe_phase(kernels)

    # ---- 13. Density control at 1M capacity
    launches_densify = densify_phase(raw, sh_degree, dict(zip(
        ("B4", "B5", "B1", "B2", "B3", "B9"), counters)))

    # ---- 14. The camera models
    launches_cameras = camera_phase(raw, sh_degree, dict(zip(
        ("B4", "B5", "B1", "B2", "B3", "B9"), counters)), kernels, smi)

    # ---- 15. The COLMAP capture path
    launches_capture = capture_phase(raw, sh_degree, dict(zip(
        ("B4", "B5", "B1", "B2", "B3", "B9"), counters)), smi)

    # ---- 16. The scene tools and the profiling utilities
    launches_tools = scene_tools_phase(raw, sh_degree, dict(zip(
        ("B4", "B5", "B1", "B2", "B3", "B9"), counters)), smi)

    # ---- 17. The sharded paths of parallel/
    launches_sharded = parallel_phase(raw, smi)

    # ---- 18. The tools
    launches_cli_tools = tools_phase(smi)

    for k in kernels:
        kid = k["name"][:2]
        for family, launched in launches_capture.items():
            if kid in launched:
                k[f"launches_capture_{family}"] = launched[kid]
        if kid in launches_cameras:
            k["launches_cameras"] = launches_cameras[kid]
        if kid in launches_tools:
            k["launches_scene_tools"] = launches_tools[kid]
        if kid in launches_cli_tools:
            k["launches_cli_tools"] = launches_cli_tools[kid]
        if kid in ("B4", "B5", "B1", "B2", "B3"):
            k["launches"] = launches_train[["B4", "B5", "B1", "B2", "B3"].index(kid)]
        if kid in ("B4", "B5", "B1"):
            k["launches_render"] = launches_render[["B4", "B5", "B1"].index(kid)]
        if kid in launches_densify:
            k.setdefault("launches_densify", launches_densify[kid])
        k["launches_sharded"] = {path: counts[kid]
                                 for path, counts in launches_sharded.items() if counts[kid]}
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
