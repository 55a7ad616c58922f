#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`patchmatchnet_torch`) on one GPU.

Run from the root of a checkout: `python3 chip_smoke.py`. Phases, each
reported on its own lines; any failure exits non-zero without the final
result line:

1. device: a CUDA device is required; prints `nvidia-smi` name/power limit.
2. build: compiles `patchmatchnet_torch/csrc/*.cu` with nvcc (sm_90a) and
   the host library `csrc/hostops.cpp` with g++ (`patchmatchnet_torch.native`,
   which every image read and shrink of the later phases goes through).
3. kernel parity: K1, K2, K3, K6 and K7 against their plain PyTorch
   versions on the card, at the main paths' stage shapes, with bf16 and
   f32 payloads; kernel and plain times (median of CUDA-event timings),
   each kernel's device time (busy time per call in a torch.profiler trace
   of 10 calls) and its bound (the larger of its bytes over the card's
   memory rate and its f32 operations over its f32 rate). Fails unless K6
   equals the per-view route it replaces (4 K1 launches and the weighted
   sum), also with 64 views at stage 2's shape, and K7 on the warp
   coordinates equals K1, both to the bit; K7 on those coordinates (the
   same tiled kernel reading the coordinates K1 computes) is timed beside
   K1. One line per kernel of the main path gives its device ms per stage
   shape and per forward. Phase 12's shapes are held to the same bounds and
   timed beside them, outside the kernels line: its non-default
   configuration's (K3 and K2 at Ke = 17 (stages 3 and 1), K1, K6 (also
   against the per-view route, to the bit) and K2 at D = 20 (stage 2) and
   D = 12 (stage 1)) and the DTU preset's (1600x1200, stage maps 150x200,
   300x400 and 600x800: K1 on each of 5 sources, K6 at V = 5, also against
   the per-view route to the bit, K3 and K2), with its hand-kernel device
   ms per forward.
4. f32 golden parity: the f32 model (kernels on, TF32 off) against the
   captured reference outputs in tests/golden/.
5. main path: a 1152x864, 5-view synthetic scene through MVSDataset ->
   bf16 DepthEstimator -> save_depth_maps; checks finite maps, the GT
   error and the per-request kernel launch counts (K1 4 / K6 4 / K2 5 /
   K3 3); reports ms per map, MPix/s and peak device memory.
6. coordinate-input path: a plane sweep through `coord_group_corr` (K7) on
   the scene's bf16 features at each stage's resolution, C and G (D 64, 16,
   8; 4 source views; `dev.profile_coord.sweep_coords`): K7 launches, K7
   equal to K1 on the same coordinates to the bit, the winner-take-all
   depth against the plane, and K7's device ms per stage and per sweep on
   the sweep's coordinates.
7. backward-kernel parity: K4 and K5 against their plain versions
   (autograd through the plain forwards) at the training stage shapes of
   640x512, B=2, bf16 and f32 payloads; errors relative to the largest
   gradient entry; kernel and plain backward times and the wrapper's
   device time per launch and per train step. K4 runs on i.i.d. depths and
   on the training path's layout (stratified bins at stage 3 D64, a
   perturbed plane elsewhere), each case with its scatter count
   (`k4_scatter_counts`): the 16-byte atomics into d_src beside the design
   before's, and the runs of consecutive samples in one cell. K5 at Ke = 17
   (stages 3 and 1) and K4 at D = 20 and 12 (stages 2 and 1), phase 12's
   non-default configuration, are held to the same bounds and timed; so
   are K4 (both depth layouts) and K5 at phase 12 (b)'s B = 8, with K1 and
   K3 forward at B = 8 held to phase 3's bounds; K4's device ms per train
   step at B = 8 with 1 + 5 views is printed.
8. f32 train-step parity: one f32 train step (kernels on, TF32 off) on a
   64x80, 3-view plane batch against the same step on the CPU (plain
   versions): loss and per-leaf gradient cosine, and the step's launches.
9. training path: bf16 at 640x512, N=5, B=2 on a 12-view synthetic plane
   scene with depth_gt, warm-started from params_000007: one warm-up step
   and 6 timed train steps (finite losses, launches per step K1 20 / K4 20
   / K3 3 / K5 3 / K2 0, ms per step, samples/s, peak memory; a
   torch.profiler trace of 2 more steps: launches, device-busy time and
   device time by kernel kind and by hand kernel id per step; K4's
   scatter count over the 20 K4 calls of one more step); a
   checkpoint after the last timed step, resumed into a fresh model and
   optimizer, reproduces the next step's loss to 1e-5; then
   `run_training` for one epoch (6 steps and validation) through the
   driver, with its launch counts.
10. gather microbenchmarks (D1-D5) on the card: every section of
   `patchmatchnet_torch.dev.bench_gather` at the JAX tool's shapes (the
   `xla` row gather at the three stage shapes, D1/D2, D3, D4 and D5); each
   section holds its kernel against the plain version and `torch.gather`
   in every element. One line per case with kernel, plain, `torch.gather`
   and bound ms (CUDA events around batches of calls), and the kernel's and
   `torch.gather`'s device time from a profiler trace; launches counted
   per section.
11. reconstruction path: an 11-view 1152x864 synthetic scan whose pair.txt
   gives each reference its 10 sources best first (as DTU's): the bf16
   DepthEstimator (1 + 4 views per map) writes COLMAP .bin depth and
   confidence maps through save_depth_maps (launches 4/4/5/3 per map), and
   filter_and_fuse (FusionConfig defaults) fuses them on the card into
   fused.ply, once to warm up and once timed; prints each view's mask
   shares, the point count, fusion ms per reference view split into reads,
   consistency, mask PNGs, backprojection and the PLY write, and peak
   memory. Fails unless the PLY has points whose median |z - plane| is
   within 5% of the plane depth, and, for two reference views, the card's
   per-pixel consistent-view counts and final mask differ from the CPU's at
   most at 0.1% of the pixels and the fused points of pixels in both final
   masks agree within 1e-4 relative.
12. CLI path: `python -m patchmatchnet_torch` in its own process, each run
   with its own timeout (CLI_TIMEOUT), printing the hand-kernel launches it
   made, which must be those of its forwards and steps:
   (a) `eval` with scripts/eval.sh's DTU flags (`--num_views 5
   --image_max_dim 1600 --geo_mask_thres 3 --photo_thres 0.8`, a scan
   list of one scan) on a 7-view 1600x1200 scan: every view's depth and
   confidence maps at 1600x1200, the median |depth - plane| on each view's
   final mask and the fused points' median |z - plane| within 5% of the
   plane, ms per map and per fused view; view 0's map against
   DepthEstimator in this process (same weights, inputs and noise; every
   kernel of the forward is deterministic, so it should be equal: bound
   median 0 and at most 0.1% of the pixels off by more than 1e-3 of the
   depth range, room for another cuDNN algorithm in another process),
   then warm in-process ms per map at the same preset;
   (b) `train` with scripts/train.sh's flags that apply (`--batch_size 8
   --epochs 1`, `--image_max_dim` 640) from the released weights on a
   24-view 640x512 scan: 3 steps at 1 + 5 views, ms per step, peak MiB,
   the checkpoint set and finite losses;
   (c) the non-default configuration (VARIANT_FLAGS: propagation 4/8/16,
   evaluation 17/9/17, iterations 2/1/2, samples 8/12/16) trained one
   epoch from scratch at 640x512, B = 2, then `eval --output_type depth`
   from the `module_000000.pt` it wrote at 1152x864, 1 + 4 views.
13. export path: the kernels as the custom ops `torch.ops.pmn.*` in a
   `torch.export` program. (a) The bf16 and f32 models exported on the card
   at 1152x864, B 1, N 5 (seconds, bytes), each loaded back from its bytes
   by `ModuleEstimator`, whose graph must hold the pmn nodes K1 4 / K6 4 /
   K2 5 / K3 3; an f32 artifact exported on the CPU at 64x80 and moved to
   the card launches the kernels and equals eager f32 on the card. (b) Each
   artifact serves EXPORT_REQUESTS requests of a 1152x864 5-view scene
   beside the eager DepthEstimator of its precision at the same seed:
   launches per request K1 4 / K6 4 / K2 5 / K3 3, finite maps, f32 against
   eager at the golden bounds, bf16 at the main path's GT bound, each max
   |module - eager| printed, and ms per map of both side by side. (c) The
   command line: `export --num_views 6 --height 1200 --width 1600`, then
   `eval --input_type module` at the DTU preset on a 6-view 1600x1200 scan,
   held to `eval --input_type params --precision f32` at the same seed (each
   its own process); then in this process through `cli.main`: a module
   eval of another geometry must be refused, and `colmap-export` of the
   scan and its maps, then `colmap-import` of that workspace, must give
   back the cameras (and the workspace's patch-match.cfg the pairs).

14. data parallel (`patchmatchnet_torch.parallel`) on one card, each launch
   of ranks under DP_TIMEOUT: (a) two gloo ranks sharing the card train
   from the released weights at 640x512, 1 + 4 views, global B = 2 (one
   row each; sample 1's mask cut to half): an f32 step (TF32 off) against
   the 1-rank B = 2 step of the same batch and noise in this process
   (phase 8's bounds: loss 1e-4, cosine 0.999 on the leaves above 1e-3 of
   the largest norm, statistics 1e-4), the ranks' parameters and running
   statistics equal after it; then 4 bf16 steps: ms per step per rank,
   launches per step (must be one rank's `step_launches`), and a traced
   step's gloo all-reduces (count, host ms) beside its BatchNorm calls;
   (b) one NCCL rank through the same group, replicate and sync-BN code:
   its f32 step against the plain one, to the bit or within 1e-6 (the
   plain step's own repeat printed beside it); (c) two gloo ranks sharing
   the card run save_depth_maps on a 6-view 1152x864 scene (each view with
   its 4 nearest sources, bf16, global B = 2) for 6 references and for 5
   (a short last batch): every map written once, on the plane, equal to
   the 1-rank B = 2 maps up to another cuDNN algorithm, launches per rank
   per request K1 4 / K6 4 / K2 5 / K3 3, ms per request per rank; (d)
   `train` and `eval --num_devices 2 --device cuda` exit non-zero naming
   the card count before any work on a one-card box, or run through NCCL
   with two cards (the eval maps held to (c)'s 1-rank maps). Prints the
   phase's seconds.
15. measurement programs, each figure printed beside the card's name and
   power limit: (a) `python -m patchmatchnet_torch.bench --verbose` in
   its own process (BENCH_TIMEOUT): its stderr lines and its JSON record,
   refused unless it has `value`, `tanks_1056x1920_n7_mpix_s` and
   `train_samples_per_s`, every number positive and no key ending in
   `_error` or `_skipped`, and unless it launched K1, K6, K2, K3, K4 and
   K5; (b) the same with `--f32 --no-tanks-metric --no-train-metric`, and
   `--train`; (c) K1, K2, K3 and K6 against their plain versions (`hold`)
   at the Tanks and Temples stage shapes (1056x1920: 132x240, 264x480,
   528x960) with 1 + 6 views, bf16, and at ETH3D's stage 1 (896x1344 and
   the portrait 1344x896), K6 against the per-view route to the bit;
   event, device, plain and bound ms per launch, and the hand kernels'
   device ms per Tanks forward; (d) `dev.bench_dataset_configs` for ETH3D
   (portrait and landscape views mixed) and Tanks, DATASET_ITERS
   iterations: per-shape end-to-end, device-resident and first-call
   times, finite maps, launches K1 6 / K6 4 / K2 5 / K3 3 per forward;
   (e) `dev.bf16_accuracy` on both fixtures, f32 at the golden bounds;
   (f) `dev.bf16_scene_check` at 400x288 N=5 and 1056x1920 N=7, failing
   unless bf16's median delta to f32 is below f32's median |depth - GT|
   (the factor printed); (g) the roofline on the card: one bf16 forward
   of the bench's inputs at the DTU, Tanks and ETH3D geometries and one
   bf16 train step at 640x512, N=5, B=2 (the bench's train side):
   CUDA-event ms, device-busy ms and the device's idle share, and each
   trace group's device ms (`utils.trace.trace_group`: convolutions, each
   hand kernel,
   the rest as glue; a trace of 10 forwards, of 2 steps) beside the bound
   `dev.roofline` gives the group, with the share bound / measured, and
   `roofline_mfu`, the whole bound over the event ms. Fails if a group's
   share is over 1.05 twice (a count that is wrong; it is traced once more
   first) or if no whole trace was taken ("not measured"). Prints the
   phase's seconds.
16. training precision and the remaining CLI paths: (a) `python -m
   patchmatchnet_torch.dev.bf16_train_compare --steps 300 --log-every 1`
   in its own process (COMPARE_TIMEOUT): f32 then bf16 from scratch at
   640x512, B=2, the tool's `--num-views 5` (sources, as the JAX tool's:
   1 + 5 views a sample), the full model; its JSON record, the loss at a
   few steps, each precision's step walls (synced) and launches beside the
   card; fails unless every loss and depth error is finite, the launches
   are 600 train steps' (K1 25 / K4 25 / K3 3 / K5 3 each) and the gates
   set before its first card run hold (COMPARE_*: each precision's median
   loss of its last 10 steps at most 0.1 x its first 10's; bf16's final
   stage-0 depth error at most 1.5 x f32's + 1e-3; median relative loss
   divergence at most 0.25); then a trace of 2 steps of each precision
   from scratch (launches, device busy, idle share, device ms by kind);
   (b) `eval` at its default `--num_views 20` on a 21-view 1152x864 scene
   (texture CLI_EVAL_TEXTURE; each view lists the 20 others): launches
   per map K1 20 / K6 4 / K2 5 / K3 3, every map finite at 1152x864, ms per
   map and per fused view; view 0 against DepthEstimator in this process
   at phase 12 (a)'s bound; warm in-process ms per map; K6 at V = 20 (two
   chunks of views) at the three stage shapes against the per-view route
   to the bit and against its plain version at phase 3's bounds, its
   device ms beside the route's and its bound; (c) `train --dataset
   dtu_legacy` on a raw DTU tree of the plane (640x512 `Rectified` images
   under 7 lights, 1600x1200 `Depths_raw` maps, one reference with 4
   sources) at B = 2, `--num_views 5`, from the released weights: 3 finite
   steps and a validation, ms per step, launches of 3 steps and 4
   validation forwards. Prints the phase's seconds.
17. the eval presets beyond DTU: `bash scripts/eval_torch.sh run_eth3d`
   and `run_tanks` (scripts/eval.sh's flags), each in its own process
   (PRESET_TIMEOUT), over a scan of the plane in PNG: ETH3D's 7 landscape
   views of 6048x4032 and one portrait view of 4032x6048, which
   `--image_max_dim 2688` shrinks to 2688x1792 and 1792x2688 (the portrait
   reference's landscape sources resized to it by the dataset); Tanks' 7
   views of 1920x1080. Every reference has 6 sources. Per preset: ms per
   map (the first request apart), ms per fused view, fusion's peak device
   MiB, the fused points and their median |z - plane|, launches per map
   (K1 6 / K6 4 / K2 5 / K3 3); fails on a non-finite map or one of the
   wrong size, an empty PLY or other launches, and unless view 0's map
   equals DepthEstimator's in this process (max |diff| 0). Prints the
   phase's seconds.
18. the host library (`patchmatchnet_torch.native`, built in phase 2):
   its build seconds, the host CPU's model (lscpu) and count beside the
   card; each function held equal to the bit to its numpy twin (u8 -> f32
   and the shrink at ETH3D's 4032x6048x3 -> 1792x2688, u8 -> f32 at Tanks'
   1080x1920x3, the 4-thread batch stretch of 7 views 900x1600 -> 896x1600,
   the vertical flip) and timed against it in turns (median of HOST_REPS
   each), `F.interpolate` (bilinear, half-pixel, no antialias; torch's
   default threads) beside the resizes as the library yardstick, with its
   max |diff|; bytes read and written and the bound at the host's copy
   rate (torch `copy_` of 1 GiB); one ETH3D view (a 6048x4032 PNG read at
   --image_max_dim 2688) end to end by section, decode, u8 -> f32 and
   shrink, with the library and with the twins in turns, both equal to
   `read_image`. One `host library:` JSON line. Prints the phase's seconds.

19. CasMVSNet (`models/casmvsnet.py`), K8 (`ops.variance_volume`), K9
   (`ops.prob_conv3d`) and K10 (`ops.conv3d_block`):
   (a) K8 against its plain version (`variance_volume_reference`, one
   grid_sample per source view) on the card at the cell's stage shapes of
   1152x864 with 1 + 4 views (stage 1: D 48, C 32 at 216x288; stage 2: D
   32, C 16 at 432x576; stage 3: D 8, C 8 at 864x1152; planes about a
   slanted plane, some samples off the source images), bf16 and f32
   payloads: every value within CAS_TOL of the plain one (atol + rtol x
   |plain|: one bf16 step; leaving a view out moves the O(1) variance by
   ~0.2), max and mean |kernel - plain| printed, and each
   bf16 stage's event, device, plain and bound ms; (a') K9
   (`ops.prob_conv3d`, the CostRegNets' head) against `F.conv3d` in f32
   (TF32 off) at the heads' shapes (8 channels, D x H x W of 48 x 216 x
   288, 32 x 432 x 576, 8 x 864 x 1152), bf16 and f32 payloads, every value
   within HEAD_TOL; each bf16 stage's event and device ms beside its bound
   and cuDNN's bf16 head on the same inputs (the plain version on the card);
   (a'') K10 at every U-Net block of the cell's three CostRegNets (stage
   1: 32 channels, D 48 at 216x288; stage 2: 16, D 32 at 432x576; stage 3:
   8, D 8 at 864x1152), each block fed the one before it as the network
   runs, random weights and BatchNorm statistics: every value within
   BLOCK_TOL of the kernel's arithmetic in f32 (`conv3d_block_unrounded`), max abs
   against it and against the bf16 plain version printed; each block's
   event and device ms beside its bound and the plain version's (cuDNN's
   convolution and its glue, the path K10 replaced: `library_ms`), that
   device time split into the convolution's kernels and the glue's, by
   kernel name; totals a map; then each block on f32 payloads (the f32
   model's K10, on the CUDA cores) against the plain version in f32 (TF32
   off), every value within BLOCK_F32_TOL, its device ms beside its f32
   bound and the plain version's;
   (b) the bf16 model from `build_model` (architecture "casmvsnet") with the
   plain reference's seeded state (`pmnbench/reference_casmvsnet.py`
   `seeded_state(CAS_SEED)`) through DepthEstimator and save_depth_maps on
   a 5-view 1152x864 scene (5 maps of 1 + 4 views): the launch counts,
   zeroed just before the run, must be K8 and K9 3 each and K10 30 a map and
   nothing else; maps finite at 1152x864, depths inside the scene's range; ms per map, peak
   memory; then K8's, K9's and K10's device ms per map from a trace of
   CAS_TRACED requests beside their bounds (the sum of the three stages'
   `dev.roofline.kernel_work`), no `implicit_convolveNd_sgemm` and no
   `dgrad` kernel in it; (c) the f32 model (TF32 off) through
   DepthEstimator on CAS_F32_MAPS maps: K8 and K9 3 each and K10 30 a map
   and nothing else, depths inside the range, and in a trace of one request
   30 launches of K10's f32 kernel and no `dgrad` kernel. Prints a `kernels`
   JSON line of K8, K9 and K10 (bf16); the last line's kernels line holds
   them too.

The last line is {"ok": true, "device": {...}}; the line before it holds
the per-kernel JSON summary.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CKPT = os.path.join(REPO, "checkpoints", "params_000007.msgpack")
MAIN_H, MAIN_W, MAIN_VIEWS, REQUESTS = 864, 1152, 5, 5
# per-forward launches of each kernel on the bf16 main path: K1 on stage
# 3's first evaluation (one per source view), K6 on every later one
EXPECTED_PER_FORWARD = {"warp_group_corr": 4, "warp_group_corr_views": 4,
                        "eval_grid_score": 5, "neighbor_group_corr": 3}
# plane sweep of the coordinate-input path: stage -> hypotheses
SWEEP_DEPTHS = {3: 64, 2: 16, 1: 8}
# reconstruction path: an 11-view scan (each reference with 10 sources, as
# DTU's pair.txt), and the reference views whose fusion is held against the
# CPU's (the middle view and an end view)
RECON_VIEWS = 11
FUSION_CHECK_VIEWS = (5, 0)
# the command line (phase 12): scripts/eval.sh's DTU preset on a 7-view scan
# at DTU's test image size (each reference with 6 sources, 5 taken), and
# scripts/train.sh's batch on a 24-view 640x512 scan (3 steps of 8)
DTU_EVAL_FLAGS = ["--num_views", "5", "--image_max_dim", "1600", "--geo_mask_thres", "3",
                  "--photo_thres", "0.8"]
CLI_EVAL_SCAN, CLI_EVAL_VIEWS, CLI_EVAL_SOURCES, CLI_EVAL_H, CLI_EVAL_W = "scan1", 7, 5, 1200, 1600
# The preset keeps pixels of photometric confidence > 0.8, a stage-1 score
# peaked on few of its 8 close hypotheses, which takes texture of a few
# pixels' period, as DTU's surfaces have. The smooth texture of the other
# phases (scale 8) leaves the stage-1 score nearly flat (confidence 0.50-0.55:
# no pixel passes); scale 128 gives a period of ~4.6 px at 1600x1200.
CLI_EVAL_TEXTURE = 128.0
CLI_TRAIN_SCAN, CLI_TRAIN_VIEWS, CLI_TRAIN_BATCH = "scan2", 24, 8
CLI_TIMEOUT = 300  # seconds, each CLI process
# the export path (phase 13): requests per estimator at the main path's
# geometry; the command line's artifact at the DTU preset (1 + 5 views of
# 1600x1200) over a 6-view scan; the small artifact exported on the CPU and
# moved to the card (1 + 2 views of 64x80)
EXPORT_REQUESTS = 3
EXPORT_CLI_VIEWS = 6
MOVED_H, MOVED_W, MOVED_VIEWS = 64, 80, 3
# CasMVSNet (phase 19): 1 + 4 views at the main path's 1152x864 (the cell
# cas-dtu-maps' geometry); K8's stage shapes (planes, channels, image pixels
# a feature pixel, planes' spacing in base intervals); the requests traced
# for K8's device time, the seeded state's seed; K8 against
# its plain version, (atol, rtol) of every value by payload (those of
# tests/test_torch_casmvsnet.py): f32 the sums' order, bf16 one rounding
# step either way
CAS_VIEWS, CAS_TRACED, CAS_SEED, CAS_F32_MAPS = 5, 3, 7, 2
CAS_STAGES = ((48, 32, 4, 4.0), (32, 16, 2, 2.0), (8, 8, 1, 1.0))
CAS_TOL = {"f32": (1e-3, 1e-3), "bf16": (1e-2, 1e-2)}
# K9 against F.conv3d in f32 (TF32 off) on the same inputs, (atol, rtol):
# the same 216 products a voxel summed in another order
HEAD_TOL = (1e-4, 1e-4)
# K10 against its arithmetic in f32 (`conv3d_block_unrounded`), (atol, rtol): one
# bf16 rounding of the result and the f32 sums' order (those of
# tests/test_torch_conv3d_block.py)
BLOCK_TOL = (2e-3, 2 ** -8)
# K10 on f32 payloads against the plain version in f32 (TF32 off): the same
# products summed in another order
BLOCK_F32_TOL = (1e-4, 1e-4)
# a CostRegNet's blocks in the order it runs them: (block, its input, its skip)
COST_REG_BLOCKS = (("conv0", "x", None), ("conv1", "conv0", None), ("conv2", "conv1", None),
                   ("conv3", "conv2", None), ("conv4", "conv3", None), ("conv5", "conv4", None),
                   ("conv6", "conv5", None), ("conv7", "conv6", "conv4"),
                   ("conv9", "conv7", "conv2"), ("conv11", "conv9", "conv0"))
# the source views' x baselines of the parity rig (the first is the reference)
RIG_BASELINES = (0.0, 0.35, -0.35, 0.7, -0.7)
# the rig of phase 12 (a)'s kernel shapes: 1 + 5 views
DTU_RIG_BASELINES = RIG_BASELINES + (1.05,)
# K6 beyond a block's chunk of views (csrc/group_corr.cu `kViewChunk`): views,
# at stage 2's shape
MANY_VIEWS = 64
# training geometry (the JAX trainer's DTU configuration)
TRAIN_H, TRAIN_W, TRAIN_VIEWS, TRAIN_BATCH, TRAIN_SCENE_VIEWS = 512, 640, 5, 2, 12
# data parallel (phase 14): ranks sharing the card and each launch's time
# limit; (a)'s global batch at the training geometry (one row per rank) and
# its timed bf16 steps; (c)'s scene of the main path's geometry, whose pair
# file gives each of its views its 4 nearest sources, served at a global
# batch of 2: 6 references (3 full batches) and 5 (a short last batch that
# leaves rank 1 no row)
DP_RANKS, DP_TIMEOUT, DP_BATCH, DP_TIMED_STEPS = 2, 300, 2, 4
DP_EVAL_VIEWS, DP_EVAL_BATCH, DP_EVAL_REFS = 6, 2, (6, 5)
TIMED_STEPS = 6
# per-train-step launches at N=5 (K2 has no backward; the training tail is plain)
EXPECTED_PER_STEP = {"warp_group_corr": 20, "warp_group_corr_backward": 20,
                     "neighbor_group_corr": 3, "neighbor_group_corr_backward": 3,
                     "eval_grid_score": 0}
# The non-default configuration of phase 12 (c) and what it gives the
# kernels at each stage of the main path's shape: stage -> (Ke, D of its
# evaluations). D = 20 (12 + 8 propagated) and 12 (8 + 4) are new depths;
# K3 and K5 take Ke = 17 in two blocks of neighbours.
VARIANT_FLAGS = ["--propagate_neighbors", "4", "8", "16", "--evaluate_neighbors", "17", "9", "17",
                 "--patchmatch_iteration", "2", "1", "2", "--patchmatch_num_sample", "8", "12",
                 "16"]
VARIANT_STAGES = {3: (17, (64, 32)), 2: (9, (20,)), 1: (17, (12, 8))}
# the kernel cases held and timed outside the kernels line: phase 12's
# shapes that the main paths of phases 5 and 9 do not give
VARIANT = "variant configuration (phase 12 (c))"
DTU_PRESET = "DTU preset (phase 12 (a))"
CLI_BATCH = "B 8 (phase 12 (b))"
KERNEL_INFO = {
    "warp_group_corr": ("patchmatchnet_torch/csrc/group_corr.cu",
                        "patchmatchnet_tpu/ops/pallas/windowed_similarity.py:419"),
    "eval_grid_score": ("patchmatchnet_torch/csrc/eval_tail.cu",
                        "patchmatchnet_tpu/ops/pallas/eval_tail.py:112"),
    "neighbor_group_corr": ("patchmatchnet_torch/csrc/group_corr.cu",
                            "patchmatchnet_tpu/ops/pallas/similarity_kernel.py:88"),
    "warp_group_corr_backward": ("patchmatchnet_torch/csrc/group_corr_bwd.cu",
                                 "patchmatchnet_tpu/ops/pallas/windowed_similarity.py:743"),
    "neighbor_group_corr_backward": ("patchmatchnet_torch/csrc/group_corr_bwd.cu",
                                     "patchmatchnet_tpu/ops/pallas/similarity_kernel.py:187"),
    "warp_group_corr_views": ("patchmatchnet_torch/csrc/group_corr.cu",
                              "patchmatchnet_tpu/ops/pallas/windowed_similarity.py:942"),
    "coord_group_corr": ("patchmatchnet_torch/csrc/group_corr.cu",
                         "patchmatchnet_tpu/ops/pallas/windowed_similarity.py:375"),
    # K8, CasMVSNet's variance cost volume, and K9, its CostRegNets' head: the
    # JAX package has no such kernel
    "variance_volume": ("patchmatchnet_torch/csrc/variance_volume.cu", None),
    "prob_conv3d": ("patchmatchnet_torch/csrc/prob_conv3d.cu", None),
    # K10, the CostRegNets' U-Net blocks
    "conv3d_block": ("patchmatchnet_torch/csrc/conv3d_block.cu", None),
}
# The gather microbenchmarks' kernels, one entry per TPU kernel of
# tools/dev/bench_gather.py: id -> (kernel, section of the port's tool,
# the pallas_call it replaces). D1 and D2 are one function on the card (the
# JAX D1 writes only the first block of each 8 of its grid step).
GATHER_KERNELS = {
    "D1": ("gather_lanes", "lane", "tools/dev/bench_gather.py:96"),
    "D2": ("gather_lanes", "lane", "tools/dev/bench_gather.py:112"),
    "D3": ("gather_lanes", "biglane", "tools/dev/bench_gather.py:145"),
    "D4": ("gather_sublanes", "sublane", "tools/dev/bench_gather.py:180"),
    "D5": ("gather_rows", "onehot", "tools/dev/bench_gather.py:219"),
}
GATHER_SOURCE = "patchmatchnet_torch/csrc/gather.cu"
# how the kernels line's ms, plain_ms, device_ms and library_ms were taken
KERNEL_TIMING = ("ms and plain_ms: median of 20 single calls between two CUDA events, host "
                 "work included; device_ms: device busy time per call in a profiler trace of "
                 "10 calls")
GATHER_TIMING = ("median of 20 CUDA-event samples of 10 calls in a row, per call; "
                 "device_ms and library_device_ms: device busy time per call in a "
                 "profiler trace of 10 calls")
INFERENCE_KERNELS = ("warp_group_corr", "eval_grid_score", "neighbor_group_corr",
                     "warp_group_corr_views", "coord_group_corr")
BACKWARD_KERNELS = ("warp_group_corr_backward", "neighbor_group_corr_backward")
# Kernel vs plain version: the same f32 math in another summation order.
# K1/K3/K6/K7: the plain version goes through F.grid_sample's normalized
# coordinates, which moves a sample by up to ~1 ulp of its pixel coordinate
# (6e-5 px at x ~ 500) against per-pixel feature jumps of O(1) in these
# random inputs. K2: that shift of the sampled x_norm (random per pixel, so
# also O(1) jumps) enters the sigmoid depth weight multiplied by
# 2 / interval, so its max bound scales with 1 / interval: 2e-5 / interval
# is 8e-4, 1.6e-3 and 4e-3 at stages 3, 2 and 1. It scales with that ulp
# too, which doubles where a side of the map passes 1024 px (ETH3D's stage
# 1, 896x1344, phase 15): `size`, the larger side, sets the factor, 1 up to
# 1024 px, so every map of phases 3 and 7 keeps its bound.


# the measurement programs (phase 15): each bench process's time limit; the
# Tanks and Temples evaluation geometry (1 + 6 views) and ETH3D's landscape
# one; the estimator runs' iterations; the plane scene checks (H, W, views)
BENCH_TIMEOUT = 300
TANKS_H, TANKS_W, ETH3D_H, ETH3D_W = 1056, 1920, 1792, 2688
TANKS_RIG_BASELINES = DTU_RIG_BASELINES + (-1.05,)
DATASET_ITERS = 2
SCENE_CHECKS = ((288, 400, 5), (1056, 1920, 7))
# phase 15 (g): a trace group's device ms may not be below the roofline's
# bound for it; a share (bound / measured) above this is a count that is
# wrong, with room for the profiler's clock
ROOFLINE_SHARE_MAX = 1.05
# training precision and the remaining CLI paths (phase 16): (a) the
# f32-against-bf16 comparison at its defaults (640x512, N=5, B=2, from
# scratch) for 300 steps, with its gates, set before its first run on the
# card: each precision's median loss over its last 10 steps at most
# COMPARE_DROP x its median over its first 10; bf16's final stage-0 depth
# error at most COMPARE_ERR_FACTOR x f32's + COMPARE_ERR_SLACK; the median
# relative loss divergence at most COMPARE_DIV_MEDIAN; (b) the CLI's eval at
# its default --num_views 20 on a 21-view scene at the main path's size
# (each view's pair.txt entry lists the 20 others, so K6 stages two chunks
# of views: 16 and 4); (c) the raw DTU layout's training at 640x512, 1 + 4
# views (`--num_views 5` counts the reference), B = 2: one reference of 5
# views under 7 lights, 7 samples, 3 steps
COMPARE_STEPS, COMPARE_TIMEOUT = 300, 600
# the tool's --num-views default, which counts source views as MVSDataset
# does (as in the JAX tool): 1 + 5 views a sample
COMPARE_SOURCES = 5
COMPARE_DROP, COMPARE_ERR_FACTOR, COMPARE_ERR_SLACK, COMPARE_DIV_MEDIAN = 0.1, 1.5, 1e-3, 0.25
MANY_SOURCES = 20
RAW_DTU_VIEWS, RAW_DTU_LIGHTS, RAW_DTU_STEPS = 5, 7, 3
# the eval presets beyond DTU (phase 17): scripts/eval_torch.sh's run_eth3d
# and run_tanks, each over a scan of the plane whose references have 6
# sources (1 + 6 views a map, the presets' 7 asked for and 6 listed). ETH3D:
# 7 landscape views at its 6048x4032 sensor size and one portrait view
# (4032 wide) placed above the rig, a reference with the 6 nearest landscape
# views; a landscape reference lists only landscape sources, since fusion
# stacks a reference's source maps, which must share a size (in the JAX
# package too). Tanks: 7 views at 1920x1080. PNG images (JPG's 4:2:0 chroma
# would bias the plane), written fast (zlib level 1). The texture keeps
# phase 12 (a)'s period of ~4.6 px at the evaluated size (the preset keeps
# pixels of confidence > 0.6 and 0.8).
PRESET_SOURCES = 6
# the sensors' sizes and the presets' --image_max_dim
ETH3D_SENSOR_H, ETH3D_SENSOR_W, ETH3D_MAX_DIM = 4032, 6048, 2688
TANKS_VIDEO_H, TANKS_VIDEO_W, TANKS_MAX_DIM = 1080, 1920, 2048
PRESET_TIMEOUT = 400  # seconds, each preset's process
# the host library (phase 18): runs of each function and its twin, in turns;
# the batch stretch of run_tanks' 1 + 6 views read at --image_max_dim 1600
# (1920x1080 -> 1600x900, stretched to 1600x896: round(112.5) is 112); the copy that gives the
# host's memory rate (torch's copy_ on its default threads, 1 GiB, the
# fastest of HOST_REPS)
HOST_REPS = 5
HOST_BATCH_VIEWS, HOST_BATCH_MAX_DIM = 7, 1600
HOST_COPY_BYTES = 1 << 30


def parity_tol(name: str, interval: float, size: int = 0):
    """(max abs, mean abs) bound of kernel vs plain version on O(1) outputs;
    `size` is the larger side of the map (0: at most 1024 px)."""
    if name == "eval_grid_score":
        ulps = max(1.0, math.ulp(float(size - 1)) / math.ulp(1023.0))
        return 2e-5 / interval * ulps, 2e-5
    return 2e-3, 2e-5


def new_summary(names):
    return {name: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "device_ms": 0.0,
                   "bytes": 0, "ops": 0}
            for name in names}


def add_time(entry, name, args, out, launches, ms, plain_ms, dev_ms):
    """Add `launches` calls of `name` at these inputs to a summary entry
    (its device_ms becomes None once a device time is missing)."""
    from patchmatchnet_torch.dev.roofline import kernel_work

    work_bytes, work_ops = kernel_work(name, args, out)
    entry["ms"] += ms * launches
    entry["plain_ms"] += plain_ms * launches
    entry["device_ms"] = (None if dev_ms is None or entry["device_ms"] is None
                          else entry["device_ms"] + dev_ms * launches)
    entry["bytes"] += work_bytes * launches
    entry["ops"] += work_ops * launches


def hold(name: str, label: str, got, want, interval: float, size: int = 0) -> float:
    """Print a kernel's error against its plain version and fail outside
    `parity_tol`; returns the max abs error."""
    err = (got - want).abs()
    max_abs, mean_abs = err.max().item(), err.mean().item()
    tol_max, tol_mean = parity_tol(name, interval, size)
    print(f"{name} {label}: max_abs {max_abs:.3e} mean_abs {mean_abs:.3e}", flush=True)
    if not (max_abs <= tol_max and mean_abs <= tol_mean):
        fail(f"{name} {label} exceeds max {tol_max} / mean {tol_mean}")
    return max_abs


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


_START = time.perf_counter()


def phase(name: str) -> None:
    print(f"== {name} (at {time.perf_counter() - _START:.1f} s)", flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median device time of fn() over `reps` runs (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rig_cameras(h: int, w: int, f: float, baselines=RIG_BASELINES[:2]):
    """Projections [1, len(baselines), 4, 4] of the rig at focal length `f`
    for an h x w image, one camera per x baseline."""
    import torch

    k = torch.tensor([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]])
    projs = []
    for tx in baselines:
        p = torch.eye(4)
        p[:3, :4] = k @ torch.tensor([[1.0, 0, 0, tx], [0, 1, 0, 0], [0, 0, 1, 0]])
        projs.append(p)
    return torch.stack(projs)[None]


def per_view_route(src, mats, depth, ref, view_weights, groups):
    """What K6 replaces, its reference on the card: K1 per source view, each
    volume times its weights, added to a zeroed sum in view order (as
    models/patchmatch.py `Evaluation` does where K6 cannot run)."""
    import torch

    from patchmatchnet_torch import ops

    b, _, h, w = view_weights.shape
    out = torch.zeros((b, groups, depth.shape[1], h, w), dtype=torch.float32,
                      device=src.device)
    for v in range(src.shape[1]):
        sim = ops.warp_group_corr(src[:, v], mats[:, v].contiguous(), depth, ref, groups)
        out = out + sim * view_weights[:, v, None, None]
    return out


def kernel_parity(device):
    """Phase 3: returns {kernel: {"max_abs_err", "ms", "plain_ms",
    "device_ms", "bytes", "ops"}} with times and work summed over the
    kernel's launches per pass of its path (bf16 payloads): a forward of the
    main path for K1, K2, K3 and K6, a plane sweep for K7. Fails unless K6
    equals the per-view route (also with MANY_VIEWS views at stage 2, and
    at V = 5 at the DTU preset's shapes) and K7 on the warp coordinates
    equals K1, to the bit, in bf16 and f32."""
    import torch

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.dev.profile_coord import rig_mats
    from patchmatchnet_torch.dev.roofline import bound, kernel_work
    from patchmatchnet_torch.models.patchmatch import (
        STAGE_CONFIG,
        build_offset_grid,
        evaluation_offsets,
    )
    from patchmatchnet_torch.ops.warp import warp_coords, warp_proj_coeffs
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

    gen = torch.Generator(device=device).manual_seed(0)
    # (stage, C, G, scale, [(D, launches per forward of K1, of K2)],
    #  [(D, launches per forward of K6)])
    stages = [
        (3, 64, 8, 8, [(64, 4, 1), (32, 0, 1)], [(32, 1)]),
        (2, 32, 8, 4, [(16, 0, 2)], [(16, 2)]),
        (1, 16, 4, 2, [(8, 0, 1)], [(8, 1)]),
    ]
    summary = new_summary(INFERENCE_KERNELS)
    route = {"ms": 0.0, "max_abs_diff": 0.0}  # K6 against the per-view route
    k7_vs_k1 = [0.0]
    # K1 against K7 on K1's warp coordinates (one tiled kernel, the cell
    # warped or read), device ms per forward of the main path
    baseline = {"k1": 0.0, "k7": 0.0}
    # device ms per call of each timed (bf16) case: kernel -> [(label, ms, launches)]
    per_stage = {name: [] for name in INFERENCE_KERNELS}
    # cases outside the kernels line: set -> [(kernel, label, device ms, launches per forward)]
    extra_rows = {VARIANT: [], DTU_PRESET: []}
    variant_grids = {}  # stage -> (eval grid, feature weights) at the variant's Ke
    vgen = torch.Generator(device=device).manual_seed(10)  # leaves gen's draws as they were

    def record(name, label, args, got, want, launches, timed, fn, plain_fn, interval,
               extra=None):
        """Hold a kernel's output against its plain version; time the bf16
        cases of the main path (`launches` per pass) and of the sets of
        `extra_rows` (`extra`: printed, not summed into the pass)."""
        err = (got - want).abs()
        max_abs, mean_abs = err.max().item(), err.mean().item()
        tol_max, tol_mean = parity_tol(name, interval)
        ok = max_abs <= tol_max and mean_abs <= tol_mean
        line = f"{name} {label}: max_abs {max_abs:.3e} mean_abs {mean_abs:.3e}"
        s = summary[name]
        s["max_abs_err"] = max(s["max_abs_err"], max_abs)
        if timed and (launches or extra):
            ms, plain_ms, dev_ms = time_ms(fn), time_ms(plain_fn), device_ms(fn)
            if extra:
                extra_rows[extra].append((name, label.split(" (")[0], dev_ms, launches))
            else:
                add_time(s, name, args, got, launches, ms, plain_ms, dev_ms)
                per_stage[name].append((label.split(" (")[0], dev_ms, launches))
            work_ms, by = bound(*kernel_work(name, args, got))
            line += (f" | kernel {ms:.4f} ms device {fmt_ms(dev_ms)} plain {plain_ms:.4f} ms "
                     f"bound {work_ms:.4f} ms ({by})"
                     + (f" (x{launches}/pass)" if not extra else
                        f" ({extra}" + (f", x{launches}/forward)" if launches else ")")))
        print(line, flush=True)
        if not ok:
            fail(f"{name} {label} exceeds max {tol_max} / mean {tol_mean}")

    for stage, c, g, scale, k1_depths, k6_depths in stages:
        h, w = MAIN_H // scale, MAIN_W // scale
        cfg = STAGE_CONFIG[stage]
        projs = rig_cameras(h, w, 1.1 * max(MAIN_H, MAIN_W) / scale, RIG_BASELINES).to(device)
        mats = warp_proj_coeffs(projs[:, 1:], projs[:, :1]).contiguous()  # [1, 4, 12]
        mat12 = mats[:, 0].contiguous()
        offset = torch.randn((1, h, w, 18), generator=gen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((1, 1 + mats.shape[1], h, w, c), generator=gen, device=device)
        vw = torch.rand((1, mats.shape[1], h, w), generator=gen, device=device)
        fw = torch.rand((1, 9, h, w), generator=gen, device=device) * 0.9 + 0.1
        ke = VARIANT_STAGES[stage][0]
        voffset = torch.randn((1, h, w, 2 * ke), generator=vgen, device=device) * 2.0
        variant_grids[stage] = (
            build_offset_grid(voffset, evaluation_offsets(cfg.propagation_range, ke), h, w),
            torch.rand((1, ke, h, w), generator=vgen, device=device) * 0.9 + 0.1)
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            tag = "bf16" if timed else "f32"
            ref, src = feats[:, 0].to(dtype), feats[:, 1].to(dtype)
            stack = feats[:, 1:].to(dtype).contiguous()
            for i, (d, launches, _) in enumerate(k1_depths):
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
                depth[:, -1, :4] = -1.0  # behind the source camera: pz <= 1e-3
                args = (src, mat12, depth, ref, g)
                label = f"stage{stage} C{c} G{g} D{d} {h}x{w} {tag}"
                k1 = ops.warp_group_corr(*args)
                record("warp_group_corr", label, args, k1, ops.warp_group_corr_reference(*args),
                       launches, timed, lambda: ops.warp_group_corr(*args),
                       lambda: ops.warp_group_corr_reference(*args), cfg.interval_scale)
                # K7 on the warp coordinates is K1; on jittered coordinates
                # (off-image too) it is held against its plain version
                ix, iy = warp_coords(mat12, depth, h, w)
                same = (ops.coord_group_corr(src, ix, iy, ref, g) - k1).abs().max().item()
                k7_vs_k1[0] = max(k7_vs_k1[0], same)
                if timed:
                    k1_fn = lambda: ops.warp_group_corr(*args)  # noqa: E731
                    k7_fn = lambda: ops.coord_group_corr(src, ix, iy, ref, g)  # noqa: E731
                    k7_ms, k1_ms, k1_dev, k7_dev = (time_ms(k7_fn), time_ms(k1_fn),
                                                    device_ms(k1_fn), device_ms(k7_fn))
                    print(f"K1 against K7 (tiled, mode kCoords) on K1's warp coordinates "
                          f"{label}: K1 {k1_ms:.4f} ms "
                          f"device {fmt_ms(k1_dev)}, K7 {k7_ms:.4f} ms device {fmt_ms(k7_dev)} "
                          f"(x{launches}/forward)", flush=True)
                    for key, dev in (("k1", k1_dev), ("k7", k7_dev)):
                        if baseline[key] is not None:
                            baseline[key] = None if dev is None else baseline[key] + dev * launches
                jx = ix + 1.5 * torch.randn(ix.shape, generator=gen, device=device)
                jy = iy + 1.5 * torch.randn(iy.shape, generator=gen, device=device)
                args = (src, jx, jy, ref, g)
                record("coord_group_corr", f"{label} (K7 on the warp coordinates: max "
                       f"|K7 - K1| {same:.3e})", args, ops.coord_group_corr(*args),
                       ops.coord_group_corr_reference(*args), 4 if i == 0 else 0, timed,
                       lambda: ops.coord_group_corr(*args),
                       lambda: ops.coord_group_corr_reference(*args), cfg.interval_scale)
            for d, launches in k6_depths:
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
                depth[:, -1, :4] = -1.0
                args = (stack, mats, depth, ref, vw, g)
                got = ops.warp_group_corr_views(*args)
                diff = (got - per_view_route(*args)).abs().max().item()
                route["max_abs_diff"] = max(route["max_abs_diff"], diff)
                label = f"stage{stage} C{c} G{g} D{d} V{mats.shape[1]} {h}x{w} {tag}"
                if timed:
                    route_ms = time_ms(lambda: per_view_route(*args))
                    route["ms"] += route_ms * launches
                    label += f" (per-view route {route_ms:.4f} ms, max |K6 - route| {diff:.3e})"
                else:
                    label += f" (max |K6 - per-view route| {diff:.3e})"
                record("warp_group_corr_views", label, args, got,
                       ops.warp_group_corr_views_reference(*args), launches, timed,
                       lambda: ops.warp_group_corr_views(*args),
                       lambda: ops.warp_group_corr_views_reference(*args), cfg.interval_scale)
            if stage == 2:  # K6 over more views than a block stages at once
                d = k6_depths[0][0]
                mats_many = rig_mats(h, w, scale, MANY_VIEWS).to(device)
                stack_many = torch.randn((1, MANY_VIEWS, h, w, c), generator=gen,
                                         device=device).to(dtype)
                vw_many = torch.rand((1, MANY_VIEWS, h, w), generator=gen, device=device)
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
                depth[:, -1, :4] = -1.0
                args = (stack_many, mats_many, depth, ref, vw_many, g)
                got = ops.warp_group_corr_views(*args)
                diff = (got - per_view_route(*args)).abs().max().item()
                route["max_abs_diff"] = max(route["max_abs_diff"], diff)
                plain = (got - ops.warp_group_corr_views_reference(*args)).abs().max().item()
                dev = fmt_ms(device_ms(lambda: ops.warp_group_corr_views(*args))) if timed else "-"
                print(f"warp_group_corr_views stage{stage} C{c} G{g} D{d} V{MANY_VIEWS} {h}x{w} "
                      f"{tag}: max |K6 - per-view route| {diff:.3e}, max |K6 - plain| {plain:.3e} "
                      f"(not gated); device {dev}", flush=True)
                del stack_many, args, got
            args = (ref, grid, g)
            record("neighbor_group_corr", f"stage{stage} C{c} G{g} K9 {h}x{w} {tag}", args,
                   ops.neighbor_group_corr(*args), ops.neighbor_group_corr_reference(*args),
                   1, timed, lambda: ops.neighbor_group_corr(*args),
                   lambda: ops.neighbor_group_corr_reference(*args), cfg.interval_scale)
            for d, _, launches in k1_depths:
                x_norm = torch.rand((1, h, w, d), generator=gen, device=device)
                cost = (torch.randn((1, h, w, d), generator=gen, device=device)).to(dtype)
                args = (x_norm, cost, grid, fw, cfg.interval_scale)
                record("eval_grid_score", f"stage{stage} D{d} {h}x{w} cost {tag}", args,
                       ops.eval_grid_score(*args), ops.eval_grid_score_reference(*args),
                       launches, timed, lambda: ops.eval_grid_score(*args),
                       lambda: ops.eval_grid_score_reference(*args), cfg.interval_scale)
            # the variant configuration (phase 12 (c)) at this stage's shape:
            # K3 and K2 on its eval grid, K1 and K6 at its new depths
            ke, variant_depths = VARIANT_STAGES[stage]
            vgrid, vfw = variant_grids[stage]
            if ke != 9:
                args = (ref, vgrid, g)
                record("neighbor_group_corr", f"variant stage{stage} C{c} G{g} K{ke} {h}x{w} {tag}",
                       args, ops.neighbor_group_corr(*args),
                       ops.neighbor_group_corr_reference(*args), 0, timed,
                       lambda: ops.neighbor_group_corr(*args),
                       lambda: ops.neighbor_group_corr_reference(*args), cfg.interval_scale,
                       extra=VARIANT)
            for d in variant_depths:
                if all(d != k1_d for k1_d, _, _ in k1_depths):
                    depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=vgen, device=device)
                    depth[:, -1, :4] = -1.0
                    args = (src, mat12, depth, ref, g)
                    record("warp_group_corr", f"variant stage{stage} C{c} G{g} D{d} {h}x{w} {tag}",
                           args, ops.warp_group_corr(*args),
                           ops.warp_group_corr_reference(*args), 0, timed,
                           lambda: ops.warp_group_corr(*args),
                           lambda: ops.warp_group_corr_reference(*args), cfg.interval_scale,
                           extra=VARIANT)
                    args = (stack, mats, depth, ref, vw, g)
                    got = ops.warp_group_corr_views(*args)
                    diff = (got - per_view_route(*args)).abs().max().item()
                    route["max_abs_diff"] = max(route["max_abs_diff"], diff)
                    record("warp_group_corr_views",
                           f"variant stage{stage} C{c} G{g} D{d} V{mats.shape[1]} {h}x{w} {tag} "
                           f"(max |K6 - per-view route| {diff:.3e})", args, got,
                           ops.warp_group_corr_views_reference(*args), 0, timed,
                           lambda: ops.warp_group_corr_views(*args),
                           lambda: ops.warp_group_corr_views_reference(*args),
                           cfg.interval_scale, extra=VARIANT)
                x_norm = torch.rand((1, h, w, d), generator=vgen, device=device)
                cost = (torch.randn((1, h, w, d), generator=vgen, device=device)).to(dtype)
                args = (x_norm, cost, vgrid, vfw, cfg.interval_scale)
                record("eval_grid_score", f"variant stage{stage} K{ke} D{d} {h}x{w} cost {tag}",
                       args, ops.eval_grid_score(*args), ops.eval_grid_score_reference(*args),
                       0, timed, lambda: ops.eval_grid_score(*args),
                       lambda: ops.eval_grid_score_reference(*args), cfg.interval_scale,
                       extra=VARIANT)
    # phase 12 (a)'s shapes: the DTU preset at 1600x1200 with 1 + 5 views
    # (stage maps 150x200, 300x400, 600x800; K1 on each of 5 sources, K6
    # at V = 5, also against the per-view route), bf16 timed and f32
    dgen = torch.Generator(device=device).manual_seed(12)
    for stage, c, g, scale, k1_depths, k6_depths in stages:
        h, w = CLI_EVAL_H // scale, CLI_EVAL_W // scale
        cfg = STAGE_CONFIG[stage]
        projs = rig_cameras(h, w, 1.1 * max(CLI_EVAL_H, CLI_EVAL_W) / scale,
                            DTU_RIG_BASELINES).to(device)
        mats = warp_proj_coeffs(projs[:, 1:], projs[:, :1]).contiguous()  # [1, 5, 12]
        views = mats.shape[1]
        offset = torch.randn((1, h, w, 18), generator=dgen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((1, 1 + views, h, w, c), generator=dgen, device=device)
        vw = torch.rand((1, views, h, w), generator=dgen, device=device)
        fw = torch.rand((1, 9, h, w), generator=dgen, device=device) * 0.9 + 0.1
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16
            tag = "bf16" if timed else "f32"
            ref, stack = feats[:, 0].to(dtype), feats[:, 1:].to(dtype).contiguous()
            for d, launches, _ in k1_depths:
                if not launches:
                    continue
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=dgen, device=device)
                depth[:, -1, :4] = -1.0
                for v in range(views):
                    args = (stack[:, v].contiguous(), mats[:, v].contiguous(), depth, ref, g)
                    record("warp_group_corr", f"stage{stage} C{c} G{g} D{d} {h}x{w} {tag} "
                           f"(source {v + 1} of {views})", args, ops.warp_group_corr(*args),
                           ops.warp_group_corr_reference(*args), views if v == 0 else 0,
                           timed and v == 0, lambda: ops.warp_group_corr(*args),
                           lambda: ops.warp_group_corr_reference(*args), cfg.interval_scale,
                           extra=DTU_PRESET)
            for d, launches in k6_depths:
                depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=dgen, device=device)
                depth[:, -1, :4] = -1.0
                args = (stack, mats, depth, ref, vw, g)
                got = ops.warp_group_corr_views(*args)
                diff = (got - per_view_route(*args)).abs().max().item()
                route["max_abs_diff"] = max(route["max_abs_diff"], diff)
                record("warp_group_corr_views", f"stage{stage} C{c} G{g} D{d} V{views} {h}x{w} "
                       f"{tag} (max |K6 - per-view route| {diff:.3e})", args, got,
                       ops.warp_group_corr_views_reference(*args), launches, timed,
                       lambda: ops.warp_group_corr_views(*args),
                       lambda: ops.warp_group_corr_views_reference(*args), cfg.interval_scale,
                       extra=DTU_PRESET)
            args = (ref, grid, g)
            record("neighbor_group_corr", f"stage{stage} C{c} G{g} K9 {h}x{w} {tag}", args,
                   ops.neighbor_group_corr(*args), ops.neighbor_group_corr_reference(*args),
                   1, timed, lambda: ops.neighbor_group_corr(*args),
                   lambda: ops.neighbor_group_corr_reference(*args), cfg.interval_scale,
                   extra=DTU_PRESET)
            for d, _, launches in k1_depths:
                x_norm = torch.rand((1, h, w, d), generator=dgen, device=device)
                cost = (torch.randn((1, h, w, d), generator=dgen, device=device)).to(dtype)
                args = (x_norm, cost, grid, fw, cfg.interval_scale)
                record("eval_grid_score", f"stage{stage} D{d} {h}x{w} cost {tag}", args,
                       ops.eval_grid_score(*args), ops.eval_grid_score_reference(*args),
                       launches, timed, lambda: ops.eval_grid_score(*args),
                       lambda: ops.eval_grid_score_reference(*args), cfg.interval_scale,
                       extra=DTU_PRESET)
        del feats, stack, args, got
    k6 = summary["warp_group_corr_views"]
    print(f"K6 per forward: {k6['ms']:.4f} ms (device {fmt_ms(k6['device_ms'])}) against the "
          f"per-view route it replaces (16 K1 launches and the weighted sum) {route['ms']:.4f} "
          f"ms; max |K6 - per-view route| {route['max_abs_diff']:.3e} (bf16 and f32, 4, 5 and "
          f"{MANY_VIEWS} views); max |K7 - K1| on the warp coordinates {k7_vs_k1[0]:.3e}; K1 per "
          f"forward device {fmt_ms(baseline['k1'])}, K7 (tiled) on K1's coordinates "
          f"{fmt_ms(baseline['k7'])}", flush=True)
    for name in ("warp_group_corr", "warp_group_corr_views", "eval_grid_score",
                 "neighbor_group_corr"):
        print(f"{name} device ms per stage: " + "; ".join(
            f"{label} {fmt_ms(dev)} x{n}" for label, dev, n in per_stage[name])
            + f"; per forward {fmt_ms(summary[name]['device_ms'])}", flush=True)
    for extra, rows in extra_rows.items():
        per_forward = (None if any(dev is None for _, _, dev, _ in rows)
                       else sum(dev * n for _, _, dev, n in rows))
        print(f"{extra} device ms per call: " + "; ".join(
            f"{name} {label} {fmt_ms(dev)}" + (f" x{n}" if n else "")
            for name, label, dev, n in rows)
            + (f"; hand kernels per forward {fmt_ms(per_forward)}" if extra == DTU_PRESET
               else ""), flush=True)
    if route["max_abs_diff"] != 0.0:
        fail(f"K6 differs from the per-view route by {route['max_abs_diff']:.3e}")
    if k7_vs_k1[0] != 0.0:
        fail(f"K7 on the warp coordinates differs from K1 by {k7_vs_k1[0]:.3e}")
    return summary


GOLDEN_CASES = (("forward_96x128", 0.25), ("forward_288x400_n5_dtu", None))
# (stage, iteration) of the per-stage depths; stage 0 is the refined depth
STAGES = ((3, 0), (3, 1), (2, 0), (2, 1), (1, 0), (0, 0))


def golden_parity(device, model_f32):
    """Phase 4: the f32 model on the card against the captured goldens, at
    the bounds of tests/test_model_golden.py."""
    import numpy as np
    import torch

    for name, conf_max in GOLDEN_CASES:
        g = np.load(os.path.join(REPO, "tests", "golden", f"{name}.npz"))
        with torch.inference_mode():
            depth, conf, dp = model_f32(
                torch.from_numpy(g["images"])[None].to(device),
                torch.from_numpy(g["intrinsics"])[None].to(device),
                torch.from_numpy(g["extrinsics"])[None].to(device),
                torch.tensor([float(g["depth_min"])], device=device),
                torch.tensor([float(g["depth_max"])], device=device),
                init_noise=torch.from_numpy(g["noise"]).to(device),
            )
        rng = float(g["depth_max"] - g["depth_min"])
        for stage, it in STAGES:
            diff = np.abs(dp[stage][it].cpu().numpy() - g[f"stage{stage}_iter{it}"])
            print(f"{name} stage{stage} iter{it}: max/range {diff.max() / rng:.3e} "
                  f"mean/range {diff.mean() / rng:.3e}", flush=True)
            if diff.max() >= 2e-3 * rng or diff.mean() >= 2e-4 * rng:
                fail(f"{name} stage{stage} iter{it} exceeds 2e-3 max / 2e-4 mean of range")
        if np.abs(depth.cpu().numpy() - g["depth"]).max() > 2e-3 * rng:
            fail(f"{name} final depth exceeds 2e-3 of range")
        cdiff = np.abs(conf.cpu().numpy() - g["confidence"])
        print(f"{name} confidence: frac>5e-3 {(cdiff > 5e-3).mean():.3e} "
              f"median {np.median(cdiff):.3e} max {cdiff.max():.3e}", flush=True)
        if (cdiff > 5e-3).mean() >= 1e-3 or np.median(cdiff) >= 1e-4:
            fail(f"{name} confidence outside the golden bounds")
        if conf_max is not None and cdiff.max() >= conf_max:
            fail(f"{name} confidence max diff {cdiff.max():.3e} >= {conf_max}")


def main_path(device, state_dict, scene):
    """Phase 5: the scene through the bf16 DepthEstimator and
    save_depth_maps. Returns (the run's launch counts, estimator)."""
    import numpy as np
    import torch

    from patchmatchnet_torch.data import PLANE_Z, BatchLoader, MVSDataset, read_pfm
    from patchmatchnet_torch.infer import DepthEstimator, save_depth_maps
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build

    model = PatchmatchNet(compute_dtype=torch.bfloat16)
    model.load_state_dict(state_dict, strict=True)
    estimator = DepthEstimator(model, device=device)

    class Timed:
        """Times each request to the estimator (it returns host arrays, so
        the device work is done when it returns)."""

        def __init__(self, inner):
            self.inner, self.device, self.ms = inner, inner.device, []

        def __call__(self, batch, generator):
            start = time.perf_counter()
            out = self.inner(batch, generator)
            self.ms.append((time.perf_counter() - start) * 1e3)
            return out

    dataset = MVSDataset(scene, num_views=MAIN_VIEWS - 1, image_extension=".png")
    if len(dataset) < REQUESTS:
        fail(f"scene has {len(dataset)} samples, need {REQUESTS}")
    loader = BatchLoader(dataset, batch_size=1)  # default prefetching loader
    # warm-up request: cuDNN algorithm selection, allocator growth
    warm = next(iter(BatchLoader(dataset, batch_size=1, num_threads=1)))
    estimator(warm, torch.Generator(device=device).manual_seed(123))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    timed = Timed(estimator)
    out_dir = tempfile.mkdtemp(prefix="out_", dir=scene)
    cuda_build.reset_launch_counts()
    written = save_depth_maps(timed, loader, out_dir, seed=0)
    counts = cuda_build.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    if written != REQUESTS:
        fail(f"wrote {written} depth maps, expected {REQUESTS}")
    errs = []
    for i in range(REQUESTS):
        depth = read_pfm(os.path.join(out_dir, "depth_est", f"{i:08d}.pfm"))[..., 0]
        if depth.shape != (MAIN_H, MAIN_W) or not np.isfinite(depth).all():
            fail(f"depth map {i}: shape {depth.shape}, finite {np.isfinite(depth).all()}")
        errs.append(float(np.median(np.abs(depth - PLANE_Z))))
    shutil.rmtree(out_dir, ignore_errors=True)

    ms = statistics.median(timed.ms)
    print(f"requests {REQUESTS}, ms per depth map: " + " ".join(f"{t:.2f}" for t in timed.ms),
          flush=True)
    print(f"median ms/map {ms:.2f}, {MAIN_W * MAIN_H / (ms * 1e3):.3f} MPix/s, "
          f"peak memory {peak / 2**20:.1f} MiB, median |depth - GT| per map "
          + " ".join(f"{e:.4f}" for e in errs) + f" (plane at {PLANE_Z})", flush=True)
    print(f"launch counts: {counts}", flush=True)
    for name, per in EXPECTED_PER_FORWARD.items():
        if counts.get(name, 0) != per * REQUESTS:
            fail(f"{name} launched {counts.get(name, 0)} times, expected {per} x {REQUESTS}")
    if set(counts) - set(EXPECTED_PER_FORWARD):
        fail(f"launches of kernels off this path: {counts}")
    if max(errs) > 0.05 * PLANE_Z:
        fail(f"median depth error {max(errs):.4f} above 5% of the plane depth")
    return counts, estimator


def coordinate_path(device, model, scene):
    """Phase 6: a plane sweep through `coord_group_corr` (K7) on the scene's
    first batch: the bf16 FeatureNet's features of each stage, the warp
    coordinates of SWEEP_DEPTHS[stage] hypotheses uniform in inverse depth
    over the scene's range, K7 per source view, and the winner-take-all
    depth of the view-summed correlation. Returns the K7 launch counts."""
    import numpy as np
    import torch

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.data import PLANE_Z, BatchLoader, MVSDataset
    from patchmatchnet_torch.dev.profile_coord import sweep_coords
    from patchmatchnet_torch.models.patchmatch import STAGE_CONFIG
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

    batch = next(iter(BatchLoader(MVSDataset(scene, MAIN_VIEWS - 1, ".png"), num_threads=1)))
    images, intr, extr, dmin, dmax = [
        torch.as_tensor(np.asarray(batch[k])).to(device).float()
        for k in ("images", "intrinsics", "extrinsics", "depth_min", "depth_max")]
    n = images.shape[1]
    with torch.inference_mode():
        feats = model.feature(images[0].permute(0, 3, 1, 2))  # {stage: [N, C, h, w]}
    cases = []
    for stage, d in SWEEP_DEPTHS.items():
        f = feats[stage].permute(0, 2, 3, 1).contiguous()  # [N, h, w, C]
        h, w = f.shape[1:3]
        # mats [N - 1, 12], hyp [D] far to near
        mats, depth, hyp, coords = sweep_coords(intr[0], extr[0], dmin[0], dmax[0], stage, d,
                                                h, w)
        cases.append((stage, f, mats, depth, hyp, coords))

    cuda_build.reset_launch_counts()
    sims = [[ops.coord_group_corr(f[v + 1:v + 2], ix, iy, f[:1], STAGE_CONFIG[stage].groups)
             for v, (ix, iy) in enumerate(coords)]
            for stage, f, mats, depth, hyp, coords in cases]
    counts = cuda_build.launch_counts()

    for (stage, f, mats, depth, hyp, coords), per_view in zip(cases, sims):
        g = STAGE_CONFIG[stage].groups
        k1_diff = max((sim - ops.warp_group_corr(f[v + 1:v + 2], mats[v:v + 1].contiguous(),
                                                  depth, f[:1], g)).abs().max().item()
                      for v, sim in enumerate(per_view))
        volume = torch.stack(per_view).sum(0).sum(1)[0]  # [D, h, w]
        if not torch.isfinite(volume).all():
            fail(f"coordinate path stage {stage}: non-finite similarity")
        wta = hyp[volume.argmax(0)]
        err = (wta - PLANE_Z).abs().median().item()
        print(f"plane sweep stage{stage} C{f.shape[-1]} G{g} D{depth.shape[1]} "
              f"{f.shape[1]}x{f.shape[2]}, {n - 1} views: median |WTA depth - GT| {err:.4f} "
              f"(plane at {PLANE_Z}); max |K7 - K1| {k1_diff:.3e}", flush=True)
        if k1_diff != 0.0:
            fail(f"K7 on the warp coordinates differs from K1 at stage {stage}")
        if err > 0.05 * PLANE_Z:
            fail(f"plane sweep stage {stage}: median depth error above 5% of the plane")
    # K7's device ms on the sweep's own coordinates (fronto-parallel planes:
    # smooth, unlike phase 3's jittered ones), all source views per stage
    per_stage = [(stage, device_ms(lambda f=f, coords=coords, g=STAGE_CONFIG[stage].groups: [
        ops.coord_group_corr(f[v + 1:v + 2], ix, iy, f[:1], g)
        for v, (ix, iy) in enumerate(coords)])) for stage, f, _, _, _, coords in cases]
    sweep_ms = (None if any(ms is None for _, ms in per_stage)
                else sum(ms for _, ms in per_stage))
    print("coord_group_corr device ms on the sweep's coordinates, per stage (x"
          f"{n - 1} views): " + "; ".join(f"stage{stage} {fmt_ms(ms)}" for stage, ms in per_stage)
          + f"; per sweep {fmt_ms(sweep_ms)}", flush=True)
    want = len(SWEEP_DEPTHS) * (n - 1)
    print(f"coordinate path launch counts: {counts}", flush=True)
    if counts != {"coord_group_corr": want}:
        fail(f"coordinate path launched {counts}, expected coord_group_corr {want}")
    return counts


def backward_tol(dtype):
    """(max abs, mean abs) bound of backward kernel vs plain version,
    relative to the largest plain gradient entry. Both sum in f32 in another
    order (atomics on both sides for the source gradient, so neither is
    deterministic), and the plain warp reaches its coordinates through
    F.grid_sample's normalize/unnormalize, ~1 ulp away (as for K1); bf16
    results are then rounded to bf16, 2^-9 of an entry, and a different
    f32 sum can round to the neighbouring bf16 value."""
    return (2e-3, 2e-5) if dtype.itemsize == 4 else (8e-3, 5e-4)


def scatter_line(counts) -> str:
    """K4's scatter count (`k4_scatter_counts`) as printed."""
    atomics, before = counts["global_atomics"], counts["parent_atomics"]
    return (f"16-byte f32 atomics into d_src {atomics:,} (design before {before:,}, "
            f"x{before / max(atomics, 1):.1f}); {counts['samples']:,} samples with a valid "
            f"corner in {counts['merged_cells']:,} runs of one cell")


def backward_parity(device):
    """Phase 7: K4 and K5 vs autograd through their plain forwards at the
    640x512 B=2 training stage shapes. Returns {kernel: {"max_abs_err",
    "ms", "plain_ms", "bytes", "ops"}} with times summed over a train step's launches
    (bf16 payloads; K4 on the i.i.d. depths). The bounds are relative to the largest entry;
    max_abs_err is the absolute error. "ms" is the wrapper's time, as the
    train step calls it: zeroing the f32 source-gradient buffer, the launch,
    and its cast to the payload dtype. K4 then runs on the training path's
    layout of the depths at each stage shape (`dev.profile_backward`
    `path_depth`), held to the same bounds; its device ms per train step
    is printed beside the i.i.d. cases'."""
    import torch

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.dev.profile_backward import path_depth
    from patchmatchnet_torch.dev.roofline import bound, kernel_work
    from patchmatchnet_torch.models.patchmatch import (
        STAGE_CONFIG,
        build_offset_grid,
        evaluation_offsets,
    )
    from patchmatchnet_torch.ops.warp import warp_proj_coeffs
    from patchmatchnet_torch.ops.warp_similarity import k4_scatter_counts
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

    gen = torch.Generator(device=device).manual_seed(1)
    path_gen = torch.Generator(device=device).manual_seed(2)  # leaves gen's draws as they were
    b = TRAIN_BATCH
    # (stage, C, G, scale, [(D, K4 launches per train step at N=5)])
    stages = [(3, 64, 8, 8, [(64, 4), (32, 4)]), (2, 32, 8, 4, [(16, 8)]),
              (1, 16, 4, 2, [(8, 4)])]
    summary = new_summary(BACKWARD_KERNELS)
    # K4 device ms per train step by layout, at B = 2 and at phase 12 (b)'s B = 8
    per_step = {"iid": 0.0, "path": 0.0, "B8 iid": 0.0, "B8 path": 0.0}
    variant_grids = {}  # stage -> eval grid at the variant configuration's Ke
    vgen = torch.Generator(device=device).manual_seed(11)  # leaves gen's draws as they were

    def check(name, label, got, want, dtype):
        tol_max, tol_mean = backward_tol(dtype)
        for g, w in zip(got, want):
            scale = w.float().abs().max().item()
            err = (g.float() - w.float()).abs()
            abs_max = err.max().item()
            rel_max, rel_mean = abs_max / scale, err.mean().item() / scale
            print(f"{name} {label}: max_abs {abs_max:.3e} max_abs/max {rel_max:.3e} "
                  f"mean_abs/max {rel_mean:.3e} (largest entry {scale:.3e})", flush=True)
            if rel_max > tol_max or rel_mean > tol_mean:
                fail(f"{name} {label} exceeds max {tol_max} / mean {tol_mean} of the largest entry")
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"], abs_max)

    def timed(name, label, launches, args, kernel_fn, plain_fn, layout=None):
        """layout: None or "iid" (the kernels line's cases), "path" (K4 on
        the training path's depths), "variant" (phase 12 (c)'s shapes,
        printed only) or "B8", "B8 iid", "B8 path" (phase 12 (b)'s batch,
        printed only)."""
        out = kernel_fn()
        ms, plain_ms, dev_ms = time_ms(kernel_fn), time_ms(plain_fn), device_ms(kernel_fn)
        if layout in (None, "iid"):  # the kernels line keeps the i.i.d. cases
            add_time(summary[name], name, args, out, launches, ms, plain_ms, dev_ms)
        if layout in per_step and per_step[layout] is not None:
            per_step[layout] = None if dev_ms is None else per_step[layout] + dev_ms * launches
        work_ms, by = bound(*kernel_work(name, args, out))
        print(f"{name} {label}: wrapper {ms:.4f} ms device {fmt_ms(dev_ms)} plain "
              f"{plain_ms:.4f} ms bound {work_ms:.4f} ms ({by}) "
              + (f"({VARIANT})" if layout == "variant" else
                 f"({CLI_BATCH}, x{launches}/train step)" if (layout or "").startswith("B8") else
                 f"(x{launches}/train step)"), flush=True)

    for stage, c, g, scale, depths in stages:
        h, w = TRAIN_H // scale, TRAIN_W // scale
        cfg = STAGE_CONFIG[stage]
        f = 1.1 * max(TRAIN_H, TRAIN_W) / scale
        projs = rig_cameras(h, w, f).to(device)
        mat12 = warp_proj_coeffs(projs[:, 1], projs[:, 0]).expand(b, 12).contiguous()
        offset = torch.randn((b, h, w, 18), generator=gen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((2, b, h, w, c), generator=gen, device=device)
        ke = VARIANT_STAGES[stage][0]
        voffset = torch.randn((b, h, w, 2 * ke), generator=vgen, device=device) * 2.0
        variant_grids[stage] = build_offset_grid(
            voffset, evaluation_offsets(cfg.propagation_range, ke), h, w)
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            ref, src = feats[0].to(dtype), feats[1].to(dtype)
            for d, launches in depths:
                depth = 4.8 + 3.0 * torch.rand((b, d, h, w), generator=gen, device=device)
                depth[:, -1, :4] = -1.0  # behind the source camera
                dout = torch.randn((b, g, d, h, w), generator=gen, device=device)
                for layout in ("iid", "path"):
                    if layout == "path":
                        depth = path_depth(stage, b, d, h, w, path_gen, device)
                    args = (src, mat12, depth, ref, g, dout)
                    label = f"stage{stage} C{c} G{g} D{d} B{b} {h}x{w} {tag} {layout}"
                    check("warp_group_corr_backward", label, ops.warp_group_corr_backward(*args),
                          ops.warp_group_corr_backward_reference(*args), dtype)
                    print(f"warp_group_corr_backward {label}: "
                          f"{scatter_line(k4_scatter_counts(*args))}", flush=True)
                    if dtype == torch.bfloat16:
                        s_ = src.detach().requires_grad_(True)
                        r_ = ref.detach().requires_grad_(True)
                        out = ops.warp_group_corr_reference(s_, mat12, depth, r_, g)
                        timed("warp_group_corr_backward", label, launches, args,
                              lambda: ops.warp_group_corr_backward(*args),
                              lambda: torch.autograd.grad(out, (s_, r_), dout, retain_graph=True),
                              layout)
            dout = torch.randn((b, g, 9, h, w), generator=gen, device=device)
            args = (ref, grid, g, dout)
            label = f"stage{stage} C{c} G{g} K9 B{b} {h}x{w} {tag}"
            check("neighbor_group_corr_backward", label, ops.neighbor_group_corr_backward(*args),
                  ops.neighbor_group_corr_backward_reference(*args), dtype)
            if dtype == torch.bfloat16:
                gx, gy = (t.detach().requires_grad_(True) for t in grid)
                out = ops.neighbor_group_corr_reference(ref, (gx, gy), g)
                timed("neighbor_group_corr_backward", label, 1, args,
                      lambda: ops.neighbor_group_corr_backward(*args),
                      lambda: torch.autograd.grad(out, (gx, gy), dout, retain_graph=True))
            # the variant configuration (phase 12 (c)) at this stage's training
            # shape: K5 on its Ke = 17 eval grid, K4 at its new depths
            ke, variant_depths = VARIANT_STAGES[stage]
            vgrid = variant_grids[stage]
            if ke != 9:
                dout = torch.randn((b, g, ke, h, w), generator=vgen, device=device)
                args = (ref, vgrid, g, dout)
                label = f"variant stage{stage} C{c} G{g} K{ke} B{b} {h}x{w} {tag}"
                check("neighbor_group_corr_backward", label,
                      ops.neighbor_group_corr_backward(*args),
                      ops.neighbor_group_corr_backward_reference(*args), dtype)
                if dtype == torch.bfloat16:
                    gx, gy = (t.detach().requires_grad_(True) for t in vgrid)
                    out = ops.neighbor_group_corr_reference(ref, (gx, gy), g)
                    timed("neighbor_group_corr_backward", label, 0, args,
                          lambda: ops.neighbor_group_corr_backward(*args),
                          lambda: torch.autograd.grad(out, (gx, gy), dout, retain_graph=True),
                          "variant")
            for d in variant_depths:
                if any(d == main_d for main_d, _ in depths):
                    continue
                depth = 4.8 + 3.0 * torch.rand((b, d, h, w), generator=vgen, device=device)
                depth[:, -1, :4] = -1.0
                dout = torch.randn((b, g, d, h, w), generator=vgen, device=device)
                args = (src, mat12, depth, ref, g, dout)
                label = f"variant stage{stage} C{c} G{g} D{d} B{b} {h}x{w} {tag}"
                check("warp_group_corr_backward", label, ops.warp_group_corr_backward(*args),
                      ops.warp_group_corr_backward_reference(*args), dtype)
                if dtype == torch.bfloat16:
                    s_ = src.detach().requires_grad_(True)
                    r_ = ref.detach().requires_grad_(True)
                    out = ops.warp_group_corr_reference(s_, mat12, depth, r_, g)
                    timed("warp_group_corr_backward", label, 0, args,
                          lambda: ops.warp_group_corr_backward(*args),
                          lambda: torch.autograd.grad(out, (s_, r_), dout, retain_graph=True),
                          "variant")
    # phase 12 (b)'s batch: K1, K3, K4 and K5 at B = 8 with 1 + 5 views (K1
    # and K4 5 launches per evaluation), bf16 timed and f32; printed only
    bgen = torch.Generator(device=device).manual_seed(13)
    b = CLI_TRAIN_BATCH
    stages = [(3, 64, 8, 8, [(64, 5), (32, 5)]), (2, 32, 8, 4, [(16, 10)]),
              (1, 16, 4, 2, [(8, 5)])]
    for stage, c, g, scale, depths in stages:
        h, w = TRAIN_H // scale, TRAIN_W // scale
        cfg = STAGE_CONFIG[stage]
        projs = rig_cameras(h, w, 1.1 * max(TRAIN_H, TRAIN_W) / scale).to(device)
        mat12 = warp_proj_coeffs(projs[:, 1], projs[:, 0]).expand(b, 12).contiguous()
        offset = torch.randn((b, h, w, 18), generator=bgen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((2, b, h, w, c), generator=bgen, device=device)
        for dtype in (torch.bfloat16, torch.float32):
            tag = "bf16" if dtype == torch.bfloat16 else "f32"
            ref, src = feats[0].to(dtype), feats[1].to(dtype)
            for d, launches in depths:
                for layout in ("iid", "path"):
                    if layout == "iid":
                        depth = 4.8 + 3.0 * torch.rand((b, d, h, w), generator=bgen, device=device)
                        depth[:, -1, :4] = -1.0
                    else:
                        depth = path_depth(stage, b, d, h, w, bgen, device)
                    label = f"stage{stage} C{c} G{g} D{d} B{b} {h}x{w} {tag} {layout}"
                    fwd = (src, mat12, depth, ref, g)
                    hold("warp_group_corr", label, ops.warp_group_corr(*fwd),
                         ops.warp_group_corr_reference(*fwd), cfg.interval_scale)
                    dout = torch.randn((b, g, d, h, w), generator=bgen, device=device)
                    args = fwd + (dout,)
                    check("warp_group_corr_backward", label, ops.warp_group_corr_backward(*args),
                          ops.warp_group_corr_backward_reference(*args), dtype)
                    if dtype == torch.bfloat16:
                        s_ = src.detach().requires_grad_(True)
                        r_ = ref.detach().requires_grad_(True)
                        out = ops.warp_group_corr_reference(s_, mat12, depth, r_, g)
                        timed("warp_group_corr_backward", label, launches, args,
                              lambda: ops.warp_group_corr_backward(*args),
                              lambda: torch.autograd.grad(out, (s_, r_), dout, retain_graph=True),
                              f"B8 {layout}")
                        del out
            label = f"stage{stage} C{c} G{g} K9 B{b} {h}x{w} {tag}"
            hold("neighbor_group_corr", label, ops.neighbor_group_corr(ref, grid, g),
                 ops.neighbor_group_corr_reference(ref, grid, g), cfg.interval_scale)
            dout = torch.randn((b, g, 9, h, w), generator=bgen, device=device)
            args = (ref, grid, g, dout)
            check("neighbor_group_corr_backward", label, ops.neighbor_group_corr_backward(*args),
                  ops.neighbor_group_corr_backward_reference(*args), dtype)
            if dtype == torch.bfloat16:
                gx, gy = (t.detach().requires_grad_(True) for t in grid)
                out = ops.neighbor_group_corr_reference(ref, (gx, gy), g)
                timed("neighbor_group_corr_backward", label, 1, args,
                      lambda: ops.neighbor_group_corr_backward(*args),
                      lambda: torch.autograd.grad(out, (gx, gy), dout, retain_graph=True), "B8")
                del out
        del feats, ref, src, args, dout
    print(f"warp_group_corr_backward device ms per train step: i.i.d. depths "
          f"{fmt_ms(per_step['iid'])}, the training path's layout {fmt_ms(per_step['path'])}; "
          f"at {CLI_BATCH} with 1 + 5 views: i.i.d. depths {fmt_ms(per_step['B8 iid'])}, the "
          f"training path's layout {fmt_ms(per_step['B8 path'])}", flush=True)
    return summary


def _cosine(a, b) -> float:
    a, b = a.double().ravel(), b.double().ravel()
    return float(a @ b / (a.norm() * b.norm() + 1e-30))


def train_step_parity(device, state_dict):
    """Phase 8: one f32 train step on the card (kernels on, TF32 off) vs the
    same step on the CPU (plain versions), 64x80, N=3, B=2 plane batch."""
    import torch

    from patchmatchnet_torch.data import plane_batch
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step

    batch = plane_batch(2, 3, 64, 80)
    results = {}
    for dev in (torch.device("cpu"), device):
        model = PatchmatchNet().to(dev)
        model.load_state_dict(state_dict, strict=True)
        cuda_build.reset_launch_counts()
        metrics, _ = train_step(model, make_optimizer(model.parameters(), 0.0),
                                batch_to_device(batch, dev), 0.0,
                                torch.from_numpy(batch["noise"]).to(dev), with_grads=True)
        results[dev.type] = (float(metrics["loss"]),
                             {k: v.cpu() for k, v in metrics["grads"].items()},
                             cuda_build.launch_counts())
    (cpu_loss, cpu_grads, _), (gpu_loss, gpu_grads, counts) = results["cpu"], results["cuda"]
    rel = abs(gpu_loss - cpu_loss) / abs(cpu_loss)
    top = max(float(g.norm()) for g in cpu_grads.values())
    cos = {k: _cosine(cpu_grads[k], gpu_grads[k]) for k, g in cpu_grads.items()
           if float(g.norm()) >= 1e-3 * top}
    worst = min(cos, key=cos.get)
    print(f"f32 train step 64x80 N=3 B=2: loss card {gpu_loss:.7f} cpu {cpu_loss:.7f} "
          f"rel {rel:.3e}; {len(cos)} gradient leaves above 1e-3 of the largest norm, "
          f"min cosine {cos[worst]:.6f} ({worst}), median "
          f"{statistics.median(cos.values()):.6f}; launches {counts}", flush=True)
    if not (rel < 1e-4 and cos[worst] > 0.999):
        fail("f32 train step on the card disagrees with the CPU step "
             "(bounds: loss 1e-4 relative, cosine 0.999)")
    want = {"warp_group_corr": 10, "warp_group_corr_backward": 10, "neighbor_group_corr": 3,
            "neighbor_group_corr_backward": 3}
    if any(counts.get(k, 0) != v for k, v in want.items()) or counts.get("eval_grid_score"):
        fail(f"f32 train step launches {counts}, expected {want} and no eval_grid_score")


def trace_steps(step, steps: int, path: str) -> None:
    """Profile `steps` calls of step() and print launches, device-busy time,
    idle share of the traced span and device time by kernel kind, per call."""
    from patchmatchnet_torch.utils.trace import (
        busy_union_us,
        hand_kernel_id,
        kernel_kind,
        trace_device_events,
    )

    events = trace_device_events(step, steps, path)
    if not events:
        print("trace: no device events recorded", flush=True)
        return
    busy = busy_union_us((s, s + d) for _, _, s, d in events)
    span = max(s + d for _, _, s, d in events) - min(s for _, _, s, _ in events)
    kinds, hand = {}, {}
    launches = 0
    for cat, name, _, dur in events:
        if cat == "kernel":
            launches += 1
            for table, key in ((kinds, kernel_kind(name)), (hand, hand_kernel_id(name))):
                if key is not None:
                    k = table.setdefault(key, [0.0, 0])
                    k[0] += dur
                    k[1] += 1
    print(f"trace of {steps} steps: {launches / steps:.0f} kernel launches per step, device "
          f"busy {busy / steps / 1e3:.2f} ms of {span / steps / 1e3:.2f} ms traced span per step "
          f"(idle share {1 - busy / span:.3f}); device ms per step by kind: "
          + ", ".join(f"{name} {us / steps / 1e3:.2f} ({n / steps:.0f})"
                      for name, (us, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])),
          flush=True)
    print("hand kernels per step (device ms, launches): "
          + ", ".join(f"{kid} {us / steps / 1e3:.4f} ({n / steps:.0f})"
                      for kid, (us, n) in sorted(hand.items())), flush=True)


def step_scatter(step) -> None:
    """Run step() once with K4's calls recorded and print K4's scatter count
    (`k4_scatter_counts`) summed over them."""
    from patchmatchnet_torch.dev.profile_backward import record_calls
    from patchmatchnet_torch.ops.warp_similarity import k4_scatter_counts

    calls = [args for kid, args in record_calls(step) if kid == "K4"]
    total = {}
    for args in calls:
        for key, v in k4_scatter_counts(*args).items():
            total[key] = total.get(key, 0) + v
    print(f"K4 scatter over one train step's {len(calls)} calls: {scatter_line(total)}",
          flush=True)
    if len(calls) != EXPECTED_PER_STEP["warp_group_corr_backward"]:
        fail(f"one train step made {len(calls)} K4 calls, expected "
             f"{EXPECTED_PER_STEP['warp_group_corr_backward']}")


def training_path(device, scratch):
    """Phase 9: the bf16 training path at 640x512, N=5, B=2. Returns the
    launch counts of the driver's run."""
    import torch

    from patchmatchnet_torch.config import Config
    from patchmatchnet_torch.data import BatchLoader, MVSDataset, make_synthetic_scene
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.train import (
        batch_to_device,
        load_train_checkpoint,
        make_optimizer,
        run_training,
        save_train_checkpoint,
        train_step,
    )
    from patchmatchnet_torch.train.driver import load_any_checkpoint, step_noise

    scene = os.path.join(scratch, "train_scene")
    make_synthetic_scene(scene, num_views=TRAIN_SCENE_VIEWS, height=TRAIN_H, width=TRAIN_W,
                         texture_scale=8.0)
    dataset = MVSDataset(scene, TRAIN_VIEWS - 1, ".png")
    loader = BatchLoader(dataset, TRAIN_BATCH, shuffle=True, drop_last=True, seed=1)
    batches = [batch_to_device(b, device) for b in loader]  # 6 batches of 2
    if len(batches) < TIMED_STEPS:
        fail(f"the scene gives {len(batches)} batches, need {TIMED_STEPS}")

    def fresh():
        model = PatchmatchNet(compute_dtype=torch.bfloat16).to(device)
        model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
        return model, make_optimizer(model.parameters(), 1e-3)

    model, opt = fresh()
    train_step(model, opt, batches[0], 1e-3, step_noise(batches[0], 1, 0))  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    cuda_build.reset_launch_counts()
    ms, losses = [], []
    for i in range(1, TIMED_STEPS + 1):
        batch = batches[i % len(batches)]
        start = time.perf_counter()
        metrics, _ = train_step(model, opt, batch, 1e-3, step_noise(batch, 1, i))
        losses.append(float(metrics["loss"]))  # waits for the step
        ms.append((time.perf_counter() - start) * 1e3)
    counts = cuda_build.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    med = statistics.median(ms)
    print(f"timed steps {TIMED_STEPS}, ms per step: " + " ".join(f"{t:.2f}" for t in ms),
          flush=True)
    print(f"median ms/step {med:.2f}, {TRAIN_BATCH * 1e3 / med:.3f} samples/s, peak memory "
          f"{peak / 2**20:.1f} MiB, losses " + " ".join(f"{v:.5f}" for v in losses),
          flush=True)
    print(f"launch counts over {TIMED_STEPS} steps: {counts}", flush=True)
    trace_steps(lambda: train_step(model, opt, batches[1], 1e-3, step_noise(batches[1], 1, 1)),
                2, os.path.join(scratch, "train_trace.json"))
    step_scatter(lambda: train_step(model, opt, batches[2], 1e-3, step_noise(batches[2], 1, 2)))
    if not all(math.isfinite(v) for v in losses):
        fail(f"non-finite training loss: {losses}")
    for name, per in EXPECTED_PER_STEP.items():
        if counts.get(name, 0) != per * TIMED_STEPS:
            fail(f"{name} launched {counts.get(name, 0)} times, expected {per} x {TIMED_STEPS}")

    # resume: the checkpoint after step k takes step k + 1 as the
    # uninterrupted run does: the same loss (the parameters), the same
    # update (the Adam moments and step count; the backward's atomics make
    # it equal only to rounding) and the same running statistics
    ckpt = os.path.join(scratch, "resume", "params_000000.ckpt.pt")
    k = TIMED_STEPS
    save_train_checkpoint(ckpt, model, opt, step=k + 1, epoch=0)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    nxt = batches[(k + 1) % len(batches)]
    noise = step_noise(nxt, 1, k + 1)
    want = float(train_step(model, opt, nxt, 1e-3, noise)[0]["loss"])
    model2, opt2 = fresh()
    load_train_checkpoint(ckpt, model2, opt2)
    got = float(train_step(model2, opt2, nxt, 1e-3, noise)[0]["loss"])
    rel = abs(got - want) / abs(want)

    def norm(tensors):
        return math.sqrt(sum(float(t.double().square().sum()) for t in tensors))

    after = {n: p.detach() for n, p in model.named_parameters()}
    after2 = {n: p.detach() for n, p in model2.named_parameters()}
    update = norm(after[n] - before[n] for n in after)
    update_rel = norm(after2[n] - after[n] for n in after) / update
    buffers2 = dict(model2.named_buffers())
    stats_rel = norm(buffers2[n] - b for n, b in model.named_buffers()) / norm(
        b for _, b in model.named_buffers())
    print(f"resume: step {k + 1} loss {want:.7f}, from the checkpoint {got:.7f} "
          f"(rel {rel:.3e}); update |resumed - uninterrupted| / |update| {update_rel:.3e} "
          f"(|update| {update:.3e}); running statistics rel {stats_rel:.3e}", flush=True)
    if rel > 1e-5 or update_rel > 1e-2 or stats_rel > 1e-5:
        fail("the resumed step differs from the uninterrupted one (bounds: loss 1e-5, "
             "update 1e-2, running statistics 1e-5 relative)")
    del model, opt, model2, opt2, batches, before

    # the driver: one epoch of the same scene
    cfg = Config()
    cfg.data.input_folder = scene
    cfg.data.num_views = TRAIN_VIEWS - 1
    cfg.data.image_extension = ".png"
    cfg.data.batch_size = TRAIN_BATCH
    cfg.train.output_folder = os.path.join(scratch, "run")
    cfg.train.checkpoint_path = CKPT
    cfg.train.epochs = 1
    cfg.train.summary_freq = 1
    cuda_build.reset_launch_counts()
    history = run_training(cfg)
    counts = cuda_build.launch_counts()
    steps = len(history)
    val = len(dataset) // TRAIN_BATCH  # validation forwards (running statistics)
    print(f"run_training: {steps} steps, losses "
          + " ".join(f"{r['loss']:.5f}" for r in history) + ", ms per step "
          + " ".join(f"{r['step_ms']:.2f}" for r in history) + f"; launches {counts}", flush=True)
    want = {name: per * steps for name, per in EXPECTED_PER_STEP.items()}
    for name, per in EXPECTED_PER_FORWARD.items():
        want[name] = want.get(name, 0) + per * val
    if counts != {k: v for k, v in want.items() if v}:
        fail(f"run_training launched {counts}, expected {want}")
    if not all(math.isfinite(r["loss"]) for r in history):
        fail("run_training produced a non-finite loss")
    if not os.path.isfile(os.path.join(cfg.train.output_folder, "params_000000.ckpt.pt")):
        fail("run_training wrote no checkpoint")
    return counts


def gather_phase(device):
    """Phase 10: each section of the port's gather tool at the JAX tool's
    shapes (it raises if a kernel differs from its plain version or from
    `torch.gather` in one element). Returns the D1-D5 entries of the
    kernels line: per section the kernel's launches, and times and bytes
    summed over the section's cases (a gather does no arithmetic: bound by
    bytes)."""
    import torch

    from patchmatchnet_torch.dev import bench_gather
    from patchmatchnet_torch.dev.roofline import bound
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.utils.trace import fmt_ms

    def sum_or_none(values):
        values = list(values)
        return None if None in values else sum(values)

    results, launches = {}, {}
    for section, bench in bench_gather.SECTIONS.items():
        cuda_build.reset_launch_counts()
        try:
            cases = bench(device=device)
        except RuntimeError as e:
            fail(f"gather section {section}: {e}")
        launches[section] = cuda_build.launch_counts()
        torch.cuda.empty_cache()
        for c in cases:
            bound_ms, by = bound(c["bytes"], 0)
            print(f"{section} {c['case']}: kernel {c['ms']:.4f} ms plain {c['plain_ms']:.4f} ms "
                  f"torch.gather {c['library_ms']:.4f} ms bound {bound_ms:.4f} ms ({by}, "
                  f"{c['bytes'] / 1e6:.1f} MB); device time kernel {fmt_ms(c['device_ms'])} "
                  f"torch.gather {fmt_ms(c['library_device_ms'])}; "
                  f"max_abs {c['max_abs_err']:.1e}", flush=True)
        results[section] = cases
    print(f"gather launches per section: {launches}", flush=True)
    entries = []
    for did, (kernel, section, replaces) in GATHER_KERNELS.items():
        cases = results[section]
        n = launches[section].get(kernel, 0)
        if n == 0 or set(launches[section]) != {kernel}:
            fail(f"gather section {section} launched {launches[section]}, expected {kernel}")
        bound_ms, bound_by = bound(sum(c["bytes"] for c in cases), 0)
        entries.append({
            "name": f"{kernel}_{did.lower()}", "route": "cuda", "source": GATHER_SOURCE,
            "replaces": replaces, "launches": n,
            "max_abs_err": max(c["max_abs_err"] for c in cases),
            "ms": sum(c["ms"] for c in cases), "plain_ms": sum(c["plain_ms"] for c in cases),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": sum(c["library_ms"] for c in cases), "timing": GATHER_TIMING,
            "device_ms": sum_or_none(c["device_ms"] for c in cases),
            "library_device_ms": sum_or_none(c["library_device_ms"] for c in cases)})
    return entries


def reconstruction_path(device, state_dict, scene, smi):
    """Phase 11: an 11-view scan from images to a fused, coloured PLY. The
    bf16 DepthEstimator writes every view's depth and confidence maps as
    COLMAP .bin (1 + 4 views per map, as phase 5); `filter_and_fuse` fuses
    them on the card, each reference with 10 sources, twice (the first run
    warms up, the second is timed and checked). Then, for FUSION_CHECK_VIEWS,
    the consistency of the reference with its sources and the backprojected
    points on the card against the same on the CPU."""
    import numpy as np
    import torch
    from PIL import Image

    from patchmatchnet_torch.data import (
        PLANE_Z,
        BatchLoader,
        MVSDataset,
        make_synthetic_scene,
        read_cam_file,
        read_map,
        read_pair_file,
        read_ply,
    )
    from patchmatchnet_torch.geometry import backproject_to_world
    from patchmatchnet_torch.infer import DepthEstimator, FusionConfig, save_depth_maps
    from patchmatchnet_torch.infer.fusion import consistency_all_sources, filter_and_fuse
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build

    make_synthetic_scene(scene, num_views=RECON_VIEWS, height=MAIN_H, width=MAIN_W,
                         texture_scale=8.0)
    best_first_pairs(scene)
    pairs = dict(read_pair_file(os.path.join(scene, "pair.txt")))

    model = PatchmatchNet(compute_dtype=torch.bfloat16)
    model.load_state_dict(state_dict, strict=True)
    estimator = DepthEstimator(model, device=device)
    dataset = MVSDataset(scene, num_views=MAIN_VIEWS - 1, image_extension=".png")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    start = time.perf_counter()
    cuda_build.reset_launch_counts()
    written = save_depth_maps(estimator, BatchLoader(dataset, batch_size=1), scene, seed=0,
                              file_format=".bin")
    counts = cuda_build.launch_counts()
    maps_s = time.perf_counter() - start
    maps_peak = torch.cuda.max_memory_allocated(device)
    del estimator, model
    torch.cuda.empty_cache()
    print(f"depth maps: {written} of {RECON_VIEWS} views as .bin in {maps_s:.2f} s, peak "
          f"memory {maps_peak / 2**20:.1f} MiB; launch counts: {counts}", flush=True)
    if written != RECON_VIEWS:
        fail(f"wrote {written} depth maps, expected {RECON_VIEWS}")
    if counts != {name: per * RECON_VIEWS for name, per in EXPECTED_PER_FORWARD.items()}:
        fail(f"depth maps launched {counts}, expected {EXPECTED_PER_FORWARD} x {RECON_VIEWS}")

    cfg = FusionConfig(file_format=".bin", image_extension=".png")
    runs = []
    for timed in (False, True):  # the second run overwrites the first's outputs
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        held = torch.cuda.memory_allocated(device)
        timings = {}
        start = time.perf_counter()
        ply = filter_and_fuse(scene, scene, "", cfg, verbose=timed, device=device,
                              timings=timings)
        runs.append((ply, time.perf_counter() - start, timings,
                     torch.cuda.max_memory_allocated(device) - held))
    ply, total_s, timings, fusion_peak = runs[-1]
    per_view = {k: v * 1e3 / RECON_VIEWS for k, v in timings.items()}
    print(f"fusion on the card, {RECON_VIEWS} reference views x {len(pairs[0])} sources, "
          f"{MAIN_W}x{MAIN_H}: {total_s * 1e3 / RECON_VIEWS:.2f} ms per reference view "
          f"(warm-up run {runs[0][1] * 1e3 / RECON_VIEWS:.2f}); host ms per view: "
          + ", ".join(f"{k} {v:.2f}" for k, v in per_view.items())
          + f"; peak memory {fusion_peak / 2**20:.1f} MiB above what the process held "
          f"before (depth maps: peak {maps_peak / 2**20:.1f} MiB); card {smi}", flush=True)

    xyz, _ = read_ply(ply)
    if xyz.shape[0] == 0 or not np.isfinite(xyz).all():
        fail(f"fused.ply holds {xyz.shape[0]} points (finite {np.isfinite(xyz).all()})")
    z_err = float(np.median(np.abs(xyz[:, 2] - PLANE_Z)))
    print(f"fused points {xyz.shape[0]} ({xyz.shape[0] / (RECON_VIEWS * MAIN_H * MAIN_W):.4f} "
          f"of the pixels); median |z - plane| {z_err:.4f} (plane at {PLANE_Z})", flush=True)
    if z_err > 0.05 * PLANE_Z:
        fail(f"fused points: median |z - plane| {z_err:.4f} above 5% of the plane depth")

    # the card against the CPU on the same maps, for FUSION_CHECK_VIEWS
    finals = {v: np.asarray(Image.open(os.path.join(scene, "mask", f"{v:08d}_final.png"))) > 0
              for v in pairs}
    offsets = dict(zip(pairs, np.cumsum([0] + [f.sum() for f in finals.values()])))

    def load(v, folder):
        return torch.from_numpy(read_map(os.path.join(scene, folder, f"{v:08d}.bin"))[..., 0])

    for ref in FUSION_CHECK_VIEWS:
        cams = {v: [torch.from_numpy(a) for a in read_cam_file(
            os.path.join(scene, "cams", f"{v:08d}_cam.txt"))[:2]] for v in [ref] + pairs[ref]}
        photo = load(ref, "confidence") > cfg.photo_thres
        res = []
        for dev in (device, torch.device("cpu")):
            ref_depth = load(ref, "depth_est").to(dev)
            geo_sum, reproj_sum = consistency_all_sources(
                ref_depth, *cams[ref],
                torch.stack([load(s, "depth_est") for s in pairs[ref]]).to(dev),
                torch.stack([cams[s][0] for s in pairs[ref]]),
                torch.stack([cams[s][1] for s in pairs[ref]]),
                cfg.geo_pixel_thres, cfg.geo_depth_thres)
            final = (geo_sum >= cfg.geo_mask_thres) & photo.to(dev)
            world = backproject_to_world((reproj_sum + ref_depth) / (geo_sum + 1), *cams[ref])
            res.append((geo_sum.cpu().numpy(), final.cpu().numpy(), world.cpu().numpy()))
        (g_sum, g_final, _), (c_sum, c_final, c_world) = res
        sum_diff, final_diff = (g_sum != c_sum).mean(), (g_final != c_final).mean()
        both = g_final & c_final
        fused = xyz[offsets[ref]:offsets[ref] + g_final.sum()]
        rel = (np.linalg.norm(fused[both[g_final]] - c_world[both], axis=1)
               / np.linalg.norm(c_world[both], axis=1))
        print(f"ref view {ref}: card vs CPU geo_sum differs at {sum_diff:.2e} and the final "
              f"mask at {final_diff:.2e} of the pixels; fused points of {both.sum()} pixels in "
              f"both final masks, max relative difference {rel.max():.2e}", flush=True)
        if not np.array_equal(g_final, finals[ref]):
            fail(f"ref view {ref}: the card's final mask differs from its fusion run's")
        if sum_diff > 1e-3 or final_diff > 1e-3 or both.sum() == 0 or rel.max() > 1e-4:
            fail(f"ref view {ref}: card and CPU fusion disagree")


def run_module(label: str, module: str, argv, timeout: int):
    """Run `python -m <module> <argv>` from the checkout, killed at
    `timeout` s. Returns (the completed process, seconds); fails on a
    non-zero exit or a timeout."""
    return run_command(label, [sys.executable, "-m", module, *argv], timeout)


def run_command(label: str, command, timeout: int):
    """Run `command` from the checkout with this interpreter first on the
    PATH (scripts call `python`), killed at `timeout` s. Returns (the
    completed process, seconds); fails on a non-zero exit or a timeout."""
    env = dict(os.environ, PATH=os.path.dirname(sys.executable) + os.pathsep
               + os.environ.get("PATH", ""))
    start = time.perf_counter()
    try:
        proc = subprocess.run(command, cwd=REPO, env=env, capture_output=True, text=True,
                              timeout=timeout)
    except subprocess.TimeoutExpired:
        fail(f"{label}: no result within {timeout} s")
    seconds = time.perf_counter() - start
    if proc.returncode != 0:
        print("\n".join((proc.stdout + proc.stderr).splitlines()[-30:]), flush=True)
        fail(f"{label} exited with {proc.returncode}")
    return proc, seconds


def printed_launches(text: str) -> dict:
    """The hand-kernel launches a process printed ("kernel launches: {...}")."""
    import ast

    counts = {}
    for line in text.splitlines():
        if line.startswith("kernel launches: "):
            counts = ast.literal_eval(line[len("kernel launches: "):])
    return counts


# eval's summary line (`cli.cmd_eval`): maps, seconds, ms per map, the first
# request's ms and the median of the others
WROTE_MAPS = re.compile(r"Wrote (\d+) depth/confidence map pairs in ([\d.]+) s \(([\d.]+) ms per "
                        r"map\); request ms: first ([\d.]+) \(set-up included\), then median "
                        r"([\d.]+)")


def run_cli(label: str, argv, timeout: int):
    """Run `python -m patchmatchnet_torch <argv>` from the checkout, killed
    at `timeout` s. Returns (stdout, the kernel launches it printed,
    seconds); fails on a non-zero exit or a timeout."""
    proc, seconds = run_module(f"CLI {label}", "patchmatchnet_torch", argv, timeout)
    counts = printed_launches(proc.stdout)
    print(f"CLI {label}: {seconds:.2f} s in all (process start, model, kernels' library load "
          f"included); kernel launches {counts}", flush=True)
    return proc.stdout, counts, seconds


def forward_launches(views: int, evaluations: int) -> dict:
    """Hand-kernel launches of one inference forward: K1 per source view on
    the first evaluation, K6 on every later one, K2 on every one, K3 once a
    stage."""
    return {"warp_group_corr": views, "warp_group_corr_views": evaluations - 1,
            "eval_grid_score": evaluations, "neighbor_group_corr": 3}


def step_launches(views: int, evaluations: int) -> dict:
    """Hand-kernel launches of one train step: K1 and K4 per source view on
    every evaluation, K3 and K5 once a stage (the training tail is plain)."""
    return {"warp_group_corr": views * evaluations,
            "warp_group_corr_backward": views * evaluations,
            "neighbor_group_corr": 3, "neighbor_group_corr_backward": 3}


def expect_launches(label: str, counts, parts) -> None:
    """Fail unless `counts` is the sum of (times, launches) parts."""
    want = {}
    for times, launches in parts:
        for name, n in launches.items():
            want[name] = want.get(name, 0) + times * n
    want = {k: v for k, v in want.items() if v}
    if counts != want:
        fail(f"CLI {label} launched {counts}, expected {want}")


def best_first_pairs(scene: str) -> None:
    """Rewrite a synthetic scene's pair.txt with each reference's sources
    best first (score 10 - |s - v|), as DTU's pair.txt lists them."""
    from patchmatchnet_torch.data import read_pair_file, save_pair_file

    path = os.path.join(scene, "pair.txt")
    save_pair_file(path, [(v, [(s, 10.0 - abs(s - v))
                               for s in sorted(srcs, key=lambda s: abs(s - v))])
                          for v, srcs in read_pair_file(path)])


def cli_path(device, scratch, smi) -> None:
    """Phase 12: the command line on the card, three runs of
    `python -m patchmatchnet_torch`, each its own process with its own
    timeout. (a) eval at scripts/eval.sh's DTU preset on a 7-view 1600x1200
    scan: every map, the fused cloud near the plane, and the CLI's map of
    view 0 against DepthEstimator in this process; (b) train with
    scripts/train.sh's flags that apply (B = 8, one epoch of 3 steps,
    640x512) from the released weights; (c) the variant configuration
    (VARIANT_FLAGS) trained one epoch from scratch at 640x512, B = 2, then
    evaluated from the module it wrote at 1152x864, 1 + 4 views."""
    import numpy as np
    import torch
    from PIL import Image

    from patchmatchnet_torch.config import Config
    from patchmatchnet_torch.data import (
        PLANE_Z,
        BatchLoader,
        MVSDataset,
        make_synthetic_scene,
        read_pfm,
        read_ply,
    )
    from patchmatchnet_torch.infer import DepthEstimator
    from patchmatchnet_torch.train.driver import build_model, load_any_checkpoint

    # (a) eval, DTU preset: 7 views of 1600x1200, 1 + 5 views per map
    root = os.path.join(scratch, "dtu")
    scan = os.path.join(root, CLI_EVAL_SCAN)
    make_synthetic_scene(scan, num_views=CLI_EVAL_VIEWS, height=CLI_EVAL_H, width=CLI_EVAL_W,
                         texture_scale=CLI_EVAL_TEXTURE)
    best_first_pairs(scan)
    scan_list = os.path.join(root, "test.txt")
    with open(scan_list, "w") as f:
        f.write(CLI_EVAL_SCAN + "\n")
    out = os.path.join(scratch, "dtu_out")
    stdout, counts, seconds = run_cli(
        "eval (DTU preset)", ["eval", "--input_folder", root, "--output_folder", out,
                              "--checkpoint_path", CKPT, "--scan_list", scan_list,
                              "--image_extension", ".png", *DTU_EVAL_FLAGS], CLI_TIMEOUT)
    maps = WROTE_MAPS.search(stdout)
    fused = re.search(r"Fused (\S+) in ([\d.]+) s", stdout)
    if not maps or not fused or int(maps.group(1)) != CLI_EVAL_VIEWS:
        fail(f"CLI eval printed no map or fusion timing for {CLI_EVAL_VIEWS} views")
    expect_launches("eval (DTU preset)", counts,
                    [(CLI_EVAL_VIEWS, forward_launches(CLI_EVAL_SOURCES, 5))])
    errs = []
    for v in range(CLI_EVAL_VIEWS):
        depth = read_pfm(os.path.join(out, CLI_EVAL_SCAN, "depth_est", f"{v:08d}.pfm"))[..., 0]
        conf = read_pfm(os.path.join(out, CLI_EVAL_SCAN, "confidence", f"{v:08d}.pfm"))[..., 0]
        for name, m in (("depth", depth), ("confidence", conf)):
            if m.shape != (CLI_EVAL_H, CLI_EVAL_W) or not np.isfinite(m).all():
                fail(f"CLI eval view {v}: {name} map {m.shape}, finite {np.isfinite(m).all()}")
        final = np.asarray(Image.open(os.path.join(out, CLI_EVAL_SCAN, "mask",
                                                   f"{v:08d}_final.png"))) > 0
        errs.append((float(np.median(np.abs(depth[final] - PLANE_Z))) if final.any()
                     else float("nan"), float(final.mean())))
    xyz, _ = read_ply(fused.group(1))
    z_err = float(np.median(np.abs(xyz[:, 2] - PLANE_Z))) if xyz.shape[0] else float("inf")
    print(f"CLI eval {CLI_EVAL_W}x{CLI_EVAL_H}, {CLI_EVAL_VIEWS} views, 1 + {CLI_EVAL_SOURCES} "
          f"views per map: {float(maps.group(3)):.2f} ms per map ({maps.group(2)} s for "
          f"{maps.group(1)} maps; requests: the first {maps.group(4)} ms with its set-up, then "
          f"median {maps.group(5)} ms); fusion "
          f"{float(fused.group(2)) * 1e3 / CLI_EVAL_VIEWS:.2f} ms per fused view "
          f"({fused.group(2)} s); "
          f"{xyz.shape[0]} points, median |z - plane| {z_err:.4f}; median |depth - plane| on the "
          "final mask (mask share) per view: "
          + " ".join(f"{e:.4f} ({m:.2f})" for e, m in errs) + f"; card {smi}", flush=True)
    if not all(math.isfinite(e) and e <= 0.05 * PLANE_Z for e, _ in errs):
        fail("CLI eval: a view's median depth error on its final mask is above 5% of the plane")
    if xyz.shape[0] == 0 or z_err > 0.05 * PLANE_Z:
        fail(f"CLI eval: fused.ply has {xyz.shape[0]} points, median |z - plane| {z_err:.4f}")

    # view 0 through DepthEstimator in this process: the same weights,
    # inputs and noise (seed 0, the first draw)
    model = build_model(Config(), inference=True)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    estimator = DepthEstimator(model, device=device)
    dataset = MVSDataset(root, CLI_EVAL_SOURCES, ".png", max_dim=CLI_EVAL_W, scan_list=scan_list)
    batch = next(iter(BatchLoader(dataset, 1, num_threads=1)))
    depth = estimator(batch, torch.Generator(device=device).manual_seed(0))[0][0]
    cli_depth = read_pfm(os.path.join(out, CLI_EVAL_SCAN, "depth_est", "00000000.pfm"))[..., 0]
    diff = np.abs(depth - cli_depth)
    off = float((diff > 1e-3 * (1.3 - 0.8) * PLANE_Z).mean())
    print(f"CLI view 0 against DepthEstimator in this process: max |diff| {diff.max():.3e}, "
          f"median {np.median(diff):.3e}, share of pixels off by more than 1e-3 of the depth "
          f"range {off:.2e}", flush=True)
    if np.median(diff) != 0.0 or off > 1e-3:
        fail("CLI view 0 differs from DepthEstimator (bounds: median 0, at most 0.1% of the "
             "pixels off by more than 1e-3 of the depth range)")
    # this process's steady state at the same preset, beside the CLI's
    ms = []
    for batch in BatchLoader(dataset, 1):
        torch.cuda.synchronize()
        start = time.perf_counter()
        estimator(batch, torch.Generator(device=device).manual_seed(0))
        ms.append((time.perf_counter() - start) * 1e3)
    print("DepthEstimator in this process, same preset, warm: ms per map "
          + " ".join(f"{t:.2f}" for t in ms) + f" (median {statistics.median(ms):.2f})",
          flush=True)
    del estimator, model
    torch.cuda.empty_cache()

    # (b) train, scripts/train.sh's flags that apply: B = 8, one epoch
    train_root = os.path.join(scratch, "train")
    make_synthetic_scene(os.path.join(train_root, CLI_TRAIN_SCAN), num_views=CLI_TRAIN_VIEWS,
                         height=TRAIN_H, width=TRAIN_W, texture_scale=8.0)
    best_first_pairs(os.path.join(train_root, CLI_TRAIN_SCAN))
    train_list = os.path.join(train_root, "train.txt")
    with open(train_list, "w") as f:
        f.write(CLI_TRAIN_SCAN + "\n")
    lists = ["--train_list", train_list, "--test_list", train_list]
    out = os.path.join(scratch, "train_out")
    _, counts, _ = run_cli("train (B 8)", [
        "train", "--input_folder", train_root, "--output_folder", out, *lists,
        "--image_extension", ".png", "--batch_size", str(CLI_TRAIN_BATCH), "--epochs", "1",
        "--checkpoint_path", CKPT, "--summary_freq", "1"], CLI_TIMEOUT)
    steps = CLI_TRAIN_VIEWS // CLI_TRAIN_BATCH
    records = read_training_run(out, steps)
    print(f"CLI train {TRAIN_W}x{TRAIN_H}, 1 + 5 views, B {CLI_TRAIN_BATCH}, {steps} steps: ms per "
          "step " + " ".join(f"{r['step_ms']:.2f}" for r in records) + ", losses "
          + " ".join(f"{r['loss']:.5f}" for r in records)
          + f", peak {records[-1].get('peak_mib', float('nan')):.1f} MiB; card {smi}", flush=True)
    expect_launches("train (B 8)", counts, [(steps, step_launches(5, 5)),
                                            (steps, forward_launches(5, 5))])

    # (c) the variant configuration: one epoch from scratch, B = 2, then
    # eval from the module it wrote at 1152x864, 1 + 4 views
    out = os.path.join(scratch, "variant_out")
    _, counts, _ = run_cli("train (variant)", [
        "train", "--input_folder", train_root, "--output_folder", out, *lists,
        "--image_extension", ".png", "--batch_size", "2", "--epochs", "1", "--summary_freq", "1",
        *VARIANT_FLAGS], CLI_TIMEOUT)
    steps = CLI_TRAIN_VIEWS // 2
    records = read_training_run(out, steps)
    expect_launches("train (variant)", counts, [(steps, step_launches(5, 5)),
                                                (steps, forward_launches(5, 5))])
    eval_root = os.path.join(scratch, "variant_scene")
    make_synthetic_scene(eval_root, num_views=MAIN_VIEWS, height=MAIN_H, width=MAIN_W,
                         texture_scale=8.0)
    eval_out = os.path.join(scratch, "variant_eval")
    stdout, counts, _ = run_cli("eval (variant)", [
        "eval", "--input_folder", eval_root, "--output_folder", eval_out, "--output_type", "depth",
        "--checkpoint_path", os.path.join(out, "module_000000.pt"), "--num_views",
        str(MAIN_VIEWS - 1), "--image_extension", ".png", *VARIANT_FLAGS], CLI_TIMEOUT)
    expect_launches("eval (variant)", counts,
                    [(MAIN_VIEWS, forward_launches(MAIN_VIEWS - 1, 5))])
    errs = []
    for v in range(MAIN_VIEWS):
        depth = read_pfm(os.path.join(eval_out, "depth_est", f"{v:08d}.pfm"))[..., 0]
        if depth.shape != (MAIN_H, MAIN_W) or not np.isfinite(depth).all():
            fail(f"CLI variant eval view {v}: depth map {depth.shape}, finite "
                 f"{np.isfinite(depth).all()}")
        errs.append(float(np.median(np.abs(depth - PLANE_Z))))
    maps = re.search(r"then median ([\d.]+)", stdout)
    print("CLI variant: train losses " + " ".join(f"{r['loss']:.5f}" for r in records)
          + f" ({steps} steps, one epoch from scratch), eval "
          f"{MAIN_W}x{MAIN_H} 1 + {MAIN_VIEWS - 1} views, requests after the first: median "
          f"{maps.group(1) if maps else '?'} ms per map; median |depth - plane| per map (not "
          "gated: one epoch of training) "
          + " ".join(f"{e:.4f}" for e in errs), flush=True)


def golden_bounds(label: str, got, want, depth_range: float) -> None:
    """Fail unless (depth, confidence) `got` meets `want` at the bounds of
    tests/test_model_golden.py (depth max 2e-3 of the range; confidence: at
    most 0.1% of the pixels off by more than 5e-3, median below 1e-4)."""
    import numpy as np

    ddiff, cdiff = np.abs(got[0] - want[0]), np.abs(got[1] - want[1])
    print(f"{label}: max |depth diff| {ddiff.max():.3e} ({ddiff.max() / depth_range:.3e} of the "
          f"range), confidence max {cdiff.max():.3e}, share > 5e-3 {(cdiff > 5e-3).mean():.2e}, "
          f"median {np.median(cdiff):.3e}", flush=True)
    if (ddiff.max() >= 2e-3 * depth_range or (cdiff > 5e-3).mean() >= 1e-3
            or np.median(cdiff) >= 1e-4):
        fail(f"{label}: outside the golden bounds")


def export_path(device, state_dict, scratch, smi) -> None:
    """Phase 13: export on the card, ModuleEstimator beside DepthEstimator,
    and export / eval --input_type module / colmap-export / colmap-import
    through the command line."""
    import numpy as np
    import torch
    from PIL import Image

    from patchmatchnet_torch.compat import export_inference, kernel_nodes
    from patchmatchnet_torch.data import (
        PLANE_Z,
        BatchLoader,
        MVSDataset,
        make_synthetic_scene,
        read_cam_file,
        read_map,
        read_pfm,
    )
    from patchmatchnet_torch.infer import DepthEstimator, ModuleEstimator
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.ops import cuda_build

    def eager(dtype):
        model = PatchmatchNet(compute_dtype=dtype)
        model.load_state_dict(state_dict, strict=True)
        return DepthEstimator(model, device=device)

    # (a) both precisions exported on the card, loaded back from the bytes
    precisions = (("bf16", torch.bfloat16), ("f32", None))
    modules = {}
    for name, dtype in precisions:
        start = time.perf_counter()
        blob = export_inference(state_dict, 1, MAIN_VIEWS, MAIN_H, MAIN_W,
                                model=PatchmatchNet(compute_dtype=dtype), device=device)
        seconds = time.perf_counter() - start
        start = time.perf_counter()
        modules[name] = ModuleEstimator(blob, device)
        nodes = kernel_nodes(modules[name].exported.program)
        print(f"export {name} {MAIN_W}x{MAIN_H}, B 1, N {MAIN_VIEWS}: {seconds:.2f} s, "
              f"{len(blob)} bytes; loaded from the bytes in {time.perf_counter() - start:.2f} s; "
              f"pmn nodes {nodes}; card {smi}", flush=True)
        if nodes != EXPECTED_PER_FORWARD:
            fail(f"the {name} program holds pmn nodes {nodes}, expected {EXPECTED_PER_FORWARD}")

    # an f32 artifact exported on the CPU, moved to the card by the loader
    small = os.path.join(scratch, "small")
    make_synthetic_scene(small, num_views=MOVED_VIEWS, height=MOVED_H, width=MOVED_W,
                         texture_scale=8.0)
    batch = next(iter(BatchLoader(MVSDataset(small, MOVED_VIEWS - 1, ".png"), 1,
                                  num_threads=1)))
    moved = ModuleEstimator(export_inference(state_dict, 1, MOVED_VIEWS, MOVED_H, MOVED_W,
                                             device="cpu"), device)
    cuda_build.reset_launch_counts()
    got = moved(batch, torch.Generator(device=device).manual_seed(0))
    counts = cuda_build.launch_counts()
    want = eager(None)(batch, torch.Generator(device=device).manual_seed(0))
    print(f"f32 artifact exported on the CPU at {MOVED_W}x{MOVED_H}, N {MOVED_VIEWS}, run on "
          f"{moved.exported.device}: launches {counts}", flush=True)
    if counts != forward_launches(MOVED_VIEWS - 1, 5):
        fail(f"the moved artifact launched {counts}, expected "
             f"{forward_launches(MOVED_VIEWS - 1, 5)}")
    golden_bounds("moved f32 artifact vs eager f32 on the card", got, want,
                  (1.3 - 0.8) * PLANE_Z)

    # (b) each artifact beside the eager estimator of its precision, the
    # same requests and noise (one generator seeded 0 per estimator, as
    # save_depth_maps draws it)
    scene = os.path.join(scratch, "main")
    make_synthetic_scene(scene, num_views=MAIN_VIEWS, height=MAIN_H, width=MAIN_W,
                         texture_scale=8.0)
    loader = BatchLoader(MVSDataset(scene, MAIN_VIEWS - 1, ".png"), 1, num_threads=1)
    batches = [b for _, b in zip(range(EXPORT_REQUESTS), loader)]
    for name, dtype in precisions:
        runs = {"module": modules.pop(name), "eager": eager(dtype)}
        for est in runs.values():  # warm-up: cuDNN algorithms, allocator
            est(batches[0], torch.Generator(device=device).manual_seed(123))
        gens = {k: torch.Generator(device=device).manual_seed(0) for k in runs}
        ms = {k: [] for k in runs}
        maps = {k: [] for k in runs}
        for batch in batches:
            for kind, est in runs.items():
                torch.cuda.synchronize()
                cuda_build.reset_launch_counts()
                start = time.perf_counter()
                out = est(batch, gens[kind])
                ms[kind].append((time.perf_counter() - start) * 1e3)
                counts = cuda_build.launch_counts()
                if counts != EXPECTED_PER_FORWARD:
                    fail(f"{name} {kind} request launched {counts}, expected "
                         f"{EXPECTED_PER_FORWARD}")
                if out[0].shape != (1, MAIN_H, MAIN_W) or not all(
                        np.isfinite(m).all() for m in out):
                    fail(f"{name} {kind} maps: shape {out[0].shape}, not all finite")
                maps[kind].append(out)
        print(f"{name} ms per map, module | eager: "
              + " ".join(f"{m:.2f}|{e:.2f}" for m, e in zip(ms["module"], ms["eager"]))
              + f" (median {statistics.median(ms['module']):.2f} | "
              f"{statistics.median(ms['eager']):.2f}); launches per request "
              f"{EXPECTED_PER_FORWARD}; card {smi}", flush=True)
        for i, (got, want) in enumerate(zip(maps["module"], maps["eager"])):
            if name == "f32":
                golden_bounds(f"f32 module vs eager, request {i}", got, want,
                              (1.3 - 0.8) * PLANE_Z)
                continue
            err = float(np.median(np.abs(got[0] - PLANE_Z)))
            print(f"bf16 module vs eager, request {i}: max |depth diff| "
                  f"{np.abs(got[0] - want[0]).max():.3e}, max |confidence diff| "
                  f"{np.abs(got[1] - want[1]).max():.3e}; module median |depth - GT| "
                  f"{err:.4f}", flush=True)
            if err > 0.05 * PLANE_Z:
                fail(f"bf16 module request {i}: median depth error {err:.4f} above 5% of the "
                     "plane depth")
        del runs
    torch.cuda.empty_cache()

    # (c) the command line at the DTU preset: export, eval the module and
    # the params at the same seed, a module eval of another geometry
    root = os.path.join(scratch, "dtu")
    scan = os.path.join(root, CLI_EVAL_SCAN)
    make_synthetic_scene(scan, num_views=EXPORT_CLI_VIEWS, height=CLI_EVAL_H, width=CLI_EVAL_W,
                         texture_scale=CLI_EVAL_TEXTURE)
    best_first_pairs(scan)
    scan_list = os.path.join(root, "test.txt")
    with open(scan_list, "w") as f:
        f.write(CLI_EVAL_SCAN + "\n")
    artifact = os.path.join(scratch, "dtu_f32.pt2")
    stdout, counts, seconds = run_cli("export (DTU preset)", [
        "export", "--checkpoint_path", CKPT, "--output", artifact, "--num_views",
        str(EXPORT_CLI_VIEWS), "--height", str(CLI_EVAL_H), "--width", str(CLI_EVAL_W)],
        CLI_TIMEOUT)
    print(stdout.strip().splitlines()[-1], flush=True)
    if counts:
        fail(f"CLI export launched kernels: {counts}")
    common = ["eval", "--input_folder", root, "--scan_list", scan_list, "--image_extension",
              ".png", "--output_type", "depth", *DTU_EVAL_FLAGS]
    outs = {}
    for kind, flags in (("module", ["--input_type", "module", "--checkpoint_path", artifact]),
                        ("params", ["--checkpoint_path", CKPT, "--precision", "f32"])):
        outs[kind] = os.path.join(scratch, f"dtu_{kind}")
        stdout, counts, _ = run_cli(f"eval --input_type {kind}",
                                    common + ["--output_folder", outs[kind], *flags],
                                    CLI_TIMEOUT)
        expect_launches(f"eval --input_type {kind}", counts,
                        [(EXPORT_CLI_VIEWS, forward_launches(CLI_EVAL_SOURCES, 5))])
        wrote = [line for line in stdout.splitlines() if line.startswith("Wrote")]
        print(f"CLI eval --input_type {kind}: " + (wrote[-1] if wrote else "no maps"),
              flush=True)
    for v in range(EXPORT_CLI_VIEWS):
        got, want = ([read_pfm(os.path.join(outs[k], CLI_EVAL_SCAN, folder, f"{v:08d}.pfm"))
                      [..., 0] for folder in ("depth_est", "confidence")]
                     for k in ("module", "params"))
        if got[0].shape != (CLI_EVAL_H, CLI_EVAL_W) or not np.isfinite(got[0]).all():
            fail(f"CLI module eval view {v}: depth map {got[0].shape}, not all finite")
        golden_bounds(f"CLI view {v}, module vs params (f32, seed 0)", got, want,
                      (1.3 - 0.8) * PLANE_Z)
    # the same command at another geometry, in this process (cli.main, as
    # `python -m patchmatchnet_torch` runs it): the ValueError that makes
    # the process exit 1
    from patchmatchnet_torch import cli

    try:
        cli.main([*common, "--image_max_dim", str(MAIN_W), "--output_folder",
                  os.path.join(scratch, "refused"), "--input_type", "module",
                  "--checkpoint_path", artifact, "--device", str(device)])
        fail("a module eval of another geometry was not refused")
    except ValueError as err:
        if "re-export" not in str(err):
            raise
        print(f"CLI module eval at --image_max_dim {MAIN_W}: refused: {err}", flush=True)

    # colmap-export of the scan (JPEG images, as COLMAP's workspace names
    # them) with the module's maps, then colmap-import of that workspace
    for v in range(EXPORT_CLI_VIEWS):
        png = os.path.join(scan, "images", f"{v:08d}.png")
        Image.open(png).convert("RGB").save(png[:-4] + ".jpg")
        os.remove(png)
    workspace, back = os.path.join(scratch, "colmap_ws"), os.path.join(scratch, "colmap_back")
    start = time.perf_counter()
    cli.main(["colmap-export", "--input_folder", scan, "--results_folder",
              os.path.join(outs["module"], CLI_EVAL_SCAN), "--output_folder", workspace])
    cli.main(["colmap-import", "--input_folder", workspace, "--output_folder", back,
              "--model_ext", ".txt"])
    print(f"colmap-export + colmap-import (cli.main in this process): "
          f"{time.perf_counter() - start:.2f} s", flush=True)
    worst = 0.0
    for v in range(EXPORT_CLI_VIEWS):
        k0, e0, _ = read_cam_file(os.path.join(scan, "cams", f"{v:08d}_cam.txt"))
        k1, e1, _ = read_cam_file(os.path.join(back, "cams", f"{v:08d}_cam.txt"))
        worst = max(worst, float(np.abs(k1 - k0).max()), float(np.abs(e1 - e0).max()))
    with open(os.path.join(scan, "pair.txt")) as f:
        lines = f.read().split("\n")
    pairs = [(int(lines[1 + 2 * i]), [int(x) for x in lines[2 + 2 * i].split()[1::2]])
             for i in range(int(lines[0]))]
    with open(os.path.join(workspace, "stereo", "patch-match.cfg")) as f:
        cfg = f.read().split("\n")
    cfg_pairs = [(cfg[2 * i], cfg[2 * i + 1].split(", ")) for i in range(len(pairs))]
    want_cfg = [(f"{r:08d}.jpg", [f"{s:08d}.jpg" for s in srcs]) for r, srcs in pairs]
    print(f"colmap-export -> colmap-import of {EXPORT_CLI_VIEWS} views: max |camera difference| "
          f"{worst:.3e}; patch-match.cfg pairs equal pair.txt: {cfg_pairs == want_cfg}",
          flush=True)
    if worst > 1e-5 or cfg_pairs != want_cfg:
        fail("colmap-export / colmap-import did not round-trip the cameras and pairs")
    for v in range(EXPORT_CLI_VIEWS):
        depth = read_pfm(os.path.join(outs["module"], CLI_EVAL_SCAN, "depth_est",
                                      f"{v:08d}.pfm"))
        ws_depth = read_map(os.path.join(workspace, "stereo", "depth_maps",
                                         f"{v:08d}.jpg.geometric.bin"))
        if not np.array_equal(depth, ws_depth):
            fail(f"the workspace's depth map {v} differs from the module's")


def same_maps(label: str, got, want) -> None:
    """Fail unless (depth, confidence) `got` equals `want` up to another
    cuDNN algorithm in another process or at another batch size: at most
    0.1% of the pixels off by more than 1e-3 of the depth range, or by 5e-3
    in confidence (the share bounds of phase 12 (a) and of the goldens; a
    bf16 forward at B = 1 and at B = 2 may round otherwise)."""
    from patchmatchnet_torch.dev.profile_parallel import map_difference

    d = map_difference(got, want)
    print(f"{label}: {'equal to the bit' if not d['depth_max'] and not d['conf_max'] else 'differ'}"
          f"; depth max |diff| {d['depth_max']:.3e}, median {d['depth_median']:.3e}, share off "
          f"by more than 1e-3 of the range {d['depth_share']:.2e}; confidence max "
          f"{d['conf_max']:.3e}, median {d['conf_median']:.3e}, share > 5e-3 "
          f"{d['conf_share']:.2e}", flush=True)
    if d["depth_share"] > 1e-3 or d["conf_share"] > 1e-3:
        fail(f"{label}: the maps differ (bounds: at most 0.1% of the pixels off)")


def data_parallel_path(device, scratch, smi) -> None:
    """Phase 14: data parallel on one card, through the rank functions of
    `patchmatchnet_torch.dev.profile_parallel`. (a) two ranks sharing it
    over gloo, training: an f32 step against the 1-rank step of the same
    global batch and noise (phase 8's bounds), the ranks' state equal after
    it, then bf16 steps (ms, launches, collectives); (b) one NCCL rank
    through the same group, replicate and sync-BN code against the plain
    step, to the bit or within 1e-6; (c) two ranks sharing the card over
    gloo, eval: save_depth_maps at the main path's geometry against one
    rank; (d) the command line's `--num_devices 2 --device cuda`, refused
    on a one-card box before any work, run through NCCL on two cards."""
    import numpy as np
    import torch

    from patchmatchnet_torch.data import PLANE_Z
    from patchmatchnet_torch.dev.profile_parallel import (
        bit_equal,
        check_cli_run,
        cli_num_devices,
        eval_rank,
        eval_scene,
        one_rank_maps,
        plain_f32_step,
        read_maps,
        relative_errors,
        train_rank,
    )
    from patchmatchnet_torch.parallel import launch

    started = time.perf_counter()
    print(f"card: {smi}; {DP_RANKS} ranks on one card time-slice it: their times are no "
          "scaling figure", flush=True)
    # twice: the spread of the plain step itself (K4's atomics)
    plain = [plain_f32_step(DP_BATCH, device) for _ in range(2)]
    floor = relative_errors(plain[1], plain[0])
    print(f"plain f32 step {TRAIN_W}x{TRAIN_H} 1+{TRAIN_VIEWS - 1} views B={DP_BATCH}: loss "
          f"{plain[0][0]:.7f}; its repeat: bit-equal {bit_equal(plain[1], plain[0])}, loss rel "
          f"{floor[0]:.3e}, gradient rel {floor[1]:.3e}, statistics rel {floor[3]:.3e}",
          flush=True)

    # (a) two ranks sharing the card over gloo: training
    t0 = time.perf_counter()
    ranks = [r.value for r in launch(train_rank, DP_RANKS, (DP_BATCH, DP_TIMED_STEPS),
                                     devices=[device] * DP_RANKS, backend="gloo",
                                     timeout=DP_TIMEOUT)]
    loss, grad, cos, stats = relative_errors(ranks[0]["f32"], plain[0])
    print(f"(a) gloo, {DP_RANKS} ranks on {device}, launch {time.perf_counter() - t0:.1f} s: f32 "
          f"step loss {ranks[0]['f32'][0]:.7f} (rel {loss:.3e}), gradient rel {grad:.3e}, min "
          f"cosine {cos:.6f}, statistics rel {stats:.3e} against one rank", flush=True)
    if not (loss < 1e-4 and cos > 0.999 and stats < 1e-4):
        fail("(a) the 2-rank f32 step misses the 1-rank step (bounds: loss 1e-4, cosine 0.999, "
             "statistics 1e-4)")
    a, b = ranks[0]["f32"][2], ranks[1]["f32"][2]
    if not all(torch.equal(a[k], b[k]) for k in a):
        fail("(a) the ranks' parameters or running statistics differ after the f32 step")
    want = step_launches(TRAIN_VIEWS - 1, 5)
    for rank, r in enumerate(ranks):
        per_step = {k: v / DP_TIMED_STEPS for k, v in r["counts"].items()}
        n, host_ms = r["collectives"].get("gloo:all_reduce", (0, 0.0))
        print(f"(a) rank {rank} bf16 steps: ms " + " ".join(f"{t:.2f}" for t in r["ms"])
              + f" (median {statistics.median(r['ms']):.2f}), losses "
              + " ".join(f"{v:.5f}" for v in r["losses"]) + f"; launches per step {per_step}; "
              f"traced step: {n} gloo all-reduces, {host_ms:.2f} host ms in them, "
              f"{r['bn_calls']} BatchNorm calls; all collectives {r['collectives']}", flush=True)
        if per_step != {k: float(v) for k, v in want.items()}:
            fail(f"(a) rank {rank} launched {per_step} per step, one rank launches {want}")
        if not all(math.isfinite(v) for v in r["losses"]):
            fail(f"(a) rank {rank}: non-finite bf16 loss {r['losses']}")
        buckets = n - 2 * r["bn_calls"] - 2
        print(f"(a) rank {rank} all-reduces per step {n} = 2 x {r['bn_calls']} BatchNorm calls "
              f"(forward, backward) + 2 (loss counts, metrics) + {buckets} DDP bucket(s)",
              flush=True)
        if buckets < 1:
            fail(f"(a) rank {rank}: {n} all-reduces leave no DDP gradient bucket")

    # (b) one NCCL rank through the same group, replicate and sync-BN code
    t0 = time.perf_counter()
    nccl = launch(train_rank, 1, (DP_BATCH, 0), devices=[device], backend="nccl",
                  timeout=DP_TIMEOUT)[0].value["f32"]
    loss, grad, cos, stats = relative_errors(nccl, plain[0])
    equal = bit_equal(nccl, plain[0])
    print(f"(b) nccl, 1 rank on {device}, launch {time.perf_counter() - t0:.1f} s: f32 step "
          f"{'equal to the plain step to the bit' if equal else 'not bit-equal'}: loss rel "
          f"{loss:.3e}, gradient rel {grad:.3e}, min cosine {cos:.9f}, statistics rel "
          f"{stats:.3e}", flush=True)
    if not equal and not (loss <= 1e-6 and grad <= 1e-6 and stats <= 1e-6):
        fail("(b) the NCCL rank's step differs from the plain step by more than 1e-6")

    # (c) two ranks sharing the card over gloo: eval at the main path's geometry
    scene = os.path.join(scratch, "dp_scene")
    eval_scene(scene, DP_EVAL_VIEWS)
    one = os.path.join(scratch, "dp_one")
    for refs in DP_EVAL_REFS:
        one_rank_maps(scene, os.path.join(one, f"refs{refs}"), DP_EVAL_BATCH, refs, device)
    t0 = time.perf_counter()
    two = os.path.join(scratch, "dp_two")
    ranks = [r.value for r in launch(eval_rank, DP_RANKS,
                                     (scene, two, DP_EVAL_BATCH, DP_EVAL_REFS),
                                     devices=[device] * DP_RANKS, backend="gloo",
                                     timeout=DP_TIMEOUT)]
    print(f"(c) gloo, {DP_RANKS} ranks on {device}, launch {time.perf_counter() - t0:.1f} s",
          flush=True)
    for refs in DP_EVAL_REFS:
        written = sum(r[refs][0] for r in ranks)
        if written != refs:
            fail(f"(c) {refs} references: the ranks wrote {written} maps")
        for view in range(refs):
            got = read_maps(os.path.join(two, f"refs{refs}"), view)
            if not np.isfinite(got[0]).all() or np.median(
                    np.abs(got[0] - PLANE_Z)) > 0.05 * PLANE_Z:
                fail(f"(c) {refs} references, view {view}: depth off the plane")
            same_maps(f"(c) {refs} references, view {view}: 2 ranks vs 1", got,
                      read_maps(os.path.join(one, f"refs{refs}"), view))
        for rank, r in enumerate(ranks):
            n, request_ms, counts, _ = r[refs]
            want = {k: v * len(request_ms) for k, v in forward_launches(MAIN_VIEWS - 1, 5).items()}
            later = request_ms[1:] or request_ms
            print(f"(c) {refs} references, rank {rank}: {n} maps in {len(request_ms)} requests, "
                  f"ms per request " + " ".join(f"{t:.2f}" for t in request_ms)
                  + f" (median after the first {statistics.median(later):.2f} ms per map); "
                  f"launches {counts}", flush=True)
            if counts != want:
                fail(f"(c) rank {rank} launched {counts}, expected {want} (K1 4 / K6 4 / K2 5 / "
                     "K3 3 per request)")

    # (d) the command line: --num_devices 2 on the card(s)
    cards = torch.cuda.device_count()
    results = cli_num_devices(scene, scratch, DP_RANKS, DP_EVAL_BATCH)
    if cards < DP_RANKS:
        print(f"(d) branch: {cards} card(s), so --num_devices {DP_RANKS} --device cuda must be "
              "refused", flush=True)
        for cmd, (_, stderr, rc, out) in results.items():
            last = (stderr.strip().splitlines() or [""])[-1]
            print(f"(d) CLI {cmd}: exit code {rc}: {last}", flush=True)
            if rc == 0 or f"device_count() is {cards}" not in stderr:
                fail(f"(d) CLI {cmd} --num_devices {DP_RANKS} was not refused naming the card "
                     "count")
            if os.path.exists(out):
                fail(f"(d) CLI {cmd} wrote {out} before refusing")
    else:
        print(f"(d) branch: {cards} cards, --num_devices {DP_RANKS} runs through NCCL",
              flush=True)
        try:
            worst = check_cli_run(results, os.path.join(one, f"refs{DP_EVAL_VIEWS}"),
                                  DP_EVAL_VIEWS, DP_EVAL_VIEWS // DP_EVAL_BATCH)
        except RuntimeError as err:
            fail(f"(d) {err}")
        print(f"(d) CLI train and eval --num_devices {DP_RANKS}: ran; worst map difference vs "
              f"1 rank {worst}", flush=True)
    print(f"data parallel phase: {time.perf_counter() - started:.1f} s", flush=True)

def bench_run(label: str, argv, smi: str) -> dict:
    """Phase 15 (a), (b): `python -m patchmatchnet_torch.bench <argv>` in
    its own process; prints its stderr lines and its JSON record beside the
    card, and fails unless every number of the record is positive and no
    key ends in `_error` or `_skipped` (the bench records a failed side
    section so, which would hide a failed kernel). Returns the record with
    the launches it printed under "launches"."""
    proc, seconds = run_module(f"bench {label}", "patchmatchnet_torch.bench",
                               ["--verbose", *argv], BENCH_TIMEOUT)
    for line in proc.stderr.splitlines():
        print(f"  {line}", flush=True)
    lines = proc.stdout.strip().splitlines()
    try:
        record = json.loads(lines[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"bench {label}: no JSON line in {proc.stdout[-500:]!r}")
    print(f"bench {label} ({seconds:.1f} s in all; {smi}): {json.dumps(record)}", flush=True)
    bad = [k for k in record if k.endswith(("_error", "_skipped"))]
    if bad:
        fail(f"bench {label}: {', '.join(f'{k} = {record[k]!r}' for k in bad)}")
    numbers = {k: v for k, v in record.items() if isinstance(v, (int, float))}
    if not numbers or not all(math.isfinite(v) and v > 0 for v in numbers.values()):
        fail(f"bench {label}: numbers not all positive: {numbers}")
    record["launches"] = printed_launches(proc.stderr)
    return record


def require_launched(label: str, counts, names) -> None:
    missing = [n for n in names if not counts.get(n)]
    if missing:
        fail(f"{label}: no launch of {missing} (launches {counts})")


def tanks_kernel_parity(device, smi) -> None:
    """Phase 15 (c): K1, K2, K3 and K6 against their plain versions at the
    Tanks and Temples geometry's stage shapes (1056x1920: 132x240,
    264x480, 528x960) with 1 + 6 views and bf16 payloads, at phase 3's
    tolerances (`hold`), K6 against the per-view route to the bit; then at
    ETH3D's stage 1 (1792x2688: 896x1344 and the portrait 1344x896), the
    largest shapes the measurement programs give the kernels. Prints each
    case's event ms, device ms per launch, plain ms and bound, and the
    hand kernels' device ms and bound per Tanks forward."""
    import torch

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.dev.roofline import bound, kernel_work
    from patchmatchnet_torch.models.patchmatch import (
        STAGE_CONFIG,
        build_offset_grid,
        evaluation_offsets,
    )
    from patchmatchnet_torch.ops.warp import warp_proj_coeffs
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

    gen = torch.Generator(device=device).manual_seed(15)
    views = len(TANKS_RIG_BASELINES) - 1
    per_forward = {name: {"launches": 0, "device_ms": 0.0, "bound_ms": 0.0}
                   for name in INFERENCE_KERNELS if name != "coord_group_corr"}
    route_diff = 0.0

    def case(name, label, args, got, want, interval, launches):
        hold(name, f"{label} bf16", got, want, interval, max(h, w))
        fn = {"warp_group_corr": ops.warp_group_corr,
              "warp_group_corr_views": ops.warp_group_corr_views,
              "eval_grid_score": ops.eval_grid_score,
              "neighbor_group_corr": ops.neighbor_group_corr}[name]
        plain = getattr(ops, f"{name}_reference")
        ms, plain_ms = time_ms(lambda: fn(*args), reps=10), time_ms(lambda: plain(*args), reps=5)
        dev = device_ms(lambda: fn(*args))
        bound_ms, by = bound(*kernel_work(name, args, got))
        print(f"  {name} {label}: kernel {ms:.4f} ms, device {fmt_ms(dev)} per launch, plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({by})"
              + (f", x{launches}/forward" if launches else "") + f" [{smi}]", flush=True)
        if launches:
            entry = per_forward[name]
            entry["launches"] += launches
            entry["bound_ms"] += bound_ms * launches
            entry["device_ms"] = (None if dev is None or entry["device_ms"] is None
                                  else entry["device_ms"] + dev * launches)

    # (stage, C, G, scale, [(D, K1 launches, K2 launches)], [(D, K6 launches)])
    # per Tanks forward; ETH3D's stage 1 follows, outside the sum
    stages = [(3, 64, 8, 8, [(64, views, 1), (32, 0, 1)], [(32, 1)], TANKS_H, TANKS_W),
              (2, 32, 8, 4, [(16, 0, 2)], [(16, 2)], TANKS_H, TANKS_W),
              (1, 16, 4, 2, [(8, 0, 1)], [(8, 1)], TANKS_H, TANKS_W),
              (1, 16, 4, 2, [(8, 0, 0)], [(8, 0)], ETH3D_H, ETH3D_W),
              (1, 16, 4, 2, [(8, 0, 0)], [(8, 0)], ETH3D_W, ETH3D_H)]
    for stage, c, g, scale, k1_depths, k6_depths, full_h, full_w in stages:
        h, w = full_h // scale, full_w // scale
        tanks = (full_h, full_w) == (TANKS_H, TANKS_W)
        cfg = STAGE_CONFIG[stage]
        projs = rig_cameras(h, w, 1.1 * max(full_h, full_w) / scale,
                            TANKS_RIG_BASELINES).to(device)
        mats = warp_proj_coeffs(projs[:, 1:], projs[:, :1]).contiguous()  # [1, 6, 12]
        offset = torch.randn((1, h, w, 18), generator=gen, device=device) * 2.0
        grid = build_offset_grid(offset, evaluation_offsets(cfg.propagation_range), h, w)
        feats = torch.randn((1, 1 + views, h, w, c), generator=gen, device=device)
        ref, stack = feats[:, 0].bfloat16(), feats[:, 1:].bfloat16().contiguous()
        del feats
        vw = torch.rand((1, views, h, w), generator=gen, device=device)
        fw = torch.rand((1, 9, h, w), generator=gen, device=device) * 0.9 + 0.1
        shape = f"stage{stage} {h}x{w} ({'Tanks' if tanks else 'ETH3D'} {full_w}x{full_h})"
        for d, k1_launches, k2_launches in k1_depths:
            depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
            depth[:, -1, :4] = -1.0  # behind the source camera: pz <= 1e-3
            if k1_launches or not tanks:
                for v in range(views):  # every source of the rig, timed on the first
                    args = (stack[:, v].contiguous(), mats[:, v].contiguous(), depth, ref, g)
                    label = f"{shape} C{c} G{g} D{d} source {v + 1} of {views}"
                    if v:
                        hold("warp_group_corr", f"{label} bf16", ops.warp_group_corr(*args),
                             ops.warp_group_corr_reference(*args), cfg.interval_scale)
                    else:
                        case("warp_group_corr", label, args, ops.warp_group_corr(*args),
                             ops.warp_group_corr_reference(*args), cfg.interval_scale,
                             k1_launches)
            x_norm = torch.rand((1, h, w, d), generator=gen, device=device)
            cost = torch.randn((1, h, w, d), generator=gen, device=device).bfloat16()
            args = (x_norm, cost, grid, fw, cfg.interval_scale)
            case("eval_grid_score", f"{shape} D{d} cost", args, ops.eval_grid_score(*args),
                 ops.eval_grid_score_reference(*args), cfg.interval_scale, k2_launches)
        for d, launches in k6_depths:
            depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
            depth[:, -1, :4] = -1.0
            args = (stack, mats, depth, ref, vw, g)
            got = ops.warp_group_corr_views(*args)
            diff = (got - per_view_route(*args)).abs().max().item()
            route_diff = max(route_diff, diff)
            case("warp_group_corr_views", f"{shape} C{c} G{g} D{d} V{views} (max |K6 - "
                 f"per-view route| {diff:.3e})", args, got,
                 ops.warp_group_corr_views_reference(*args), cfg.interval_scale, launches)
        args = (ref, grid, g)
        case("neighbor_group_corr", f"{shape} C{c} G{g} K9", args,
             ops.neighbor_group_corr(*args), ops.neighbor_group_corr_reference(*args),
             cfg.interval_scale, 1 if tanks else 0)
        del stack, ref, args, got
    total = None if any(e["device_ms"] is None for e in per_forward.values()) else sum(
        e["device_ms"] for e in per_forward.values())
    print(f"hand kernels per Tanks forward ({TANKS_W}x{TANKS_H}, 1 + {views} views, bf16; "
          f"{smi}): " + "; ".join(
              f"{name} x{e['launches']} device {fmt_ms(e['device_ms'])}, bound "
              f"{e['bound_ms']:.4f} ms" for name, e in per_forward.items())
          + f"; all {fmt_ms(total)}", flush=True)
    if route_diff != 0.0:
        fail(f"K6 at V = {views} differs from the per-view route by {route_diff:.3e}")


def hold_roofline(label: str, fn, calls: int, rows, event_ms: float, smi: str) -> None:
    """Phase 15 (g): trace `calls` calls of fn() and print, beside the
    card, each trace group's device ms (`utils.trace.device_ms_by_group`)
    next to the roofline's bound for the group (`dev.roofline` rows) and the
    share bound / measured, the device busy and idle share, and
    `roofline_mfu` over `event_ms`. A group whose share is over
    ROOFLINE_SHARE_MAX (a count that is wrong) is traced once more before
    the phase fails; a trace that dropped events prints "not measured" and
    fails the phase."""
    from patchmatchnet_torch.dev.roofline import roofline_mfu, summary
    from patchmatchnet_torch.utils.trace import device_ms_by_group

    total = summary(rows)
    for attempt in (1, 2):
        traced = device_ms_by_group(fn, calls)
        if traced is None:
            print(f"  {label}: device time by group not measured (every trace of {calls} calls "
                  f"dropped events) [{smi}]", flush=True)
            fail(f"{label}: no whole trace for the roofline's groups")
        busy, measured = traced
        shares = {g: (b / measured[g] if measured.get(g) else math.inf)
                  for g, b in total["groups"].items()}
        print(f"  {label}: {event_ms:.2f} ms by events, device busy {busy:.4f} ms, idle share "
              f"{1.0 - busy / event_ms:.3f}; bound {total['bound_ms']:.4f} ms, roofline_mfu "
              f"{roofline_mfu(total['bound_ms'], event_ms):.4f} [{smi}]", flush=True)
        for g in sorted(set(total["groups"]) | set(measured)):
            bound_ms = total["groups"].get(g, 0.0)
            got = measured.get(g)
            share = f"{shares[g]:.3f}" if g in shares else "-"
            print(f"    {g}: device {'not measured' if got is None else f'{got:.4f} ms'}, "
                  f"bound {bound_ms:.4f} ms, share {share}", flush=True)
        over = {g: v for g, v in shares.items() if v > ROOFLINE_SHARE_MAX}
        if not over:
            return
        print(f"  {label}: share over {ROOFLINE_SHARE_MAX} in {sorted(over)}"
              + ("; tracing once more" if attempt == 1 else ""), flush=True)
    fail(f"{label}: roofline share over {ROOFLINE_SHARE_MAX}: {over}")


def device_busy_per_forward(device, smi) -> None:
    """Phase 15 (g): the bf16 forward of the bench's inputs at the DTU,
    Tanks and ETH3D geometries and one bf16 train step of the bench's train
    side (640x512, N=5, B=2) against the roofline (`dev.roofline`): the
    CUDA-event ms (median of 10 single forwards, of 5 steps; the host's
    launches included), device busy and the idle share, each trace group's
    device ms beside its bound and share (a trace of 10 forwards, of 2
    steps), and `roofline_mfu`, the whole bound over the event ms
    (`hold_roofline`)."""
    import torch

    from patchmatchnet_torch.bench import (
        TRAIN_LR,
        build_inputs,
        forward,
        load_model,
        seeded_model,
        train_batch,
    )
    from patchmatchnet_torch.dev.roofline import GEOMETRIES, count
    from patchmatchnet_torch.models import PatchmatchNet
    from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step

    model = load_model(True, device)
    for key in ("dtu", "tanks", "eth3d"):
        h, w, views, batch, _ = geometry = GEOMETRIES[key]
        arrays = build_inputs(batch, views, h, w)
        inputs = [torch.from_numpy(a).to(device) for a in arrays[:5]]
        noise = torch.from_numpy(arrays[5]).to(device)
        ms = time_ms(lambda: forward(model, inputs, noise), reps=10)
        hold_roofline(f"bf16 forward at {key} {w}x{h} N={views}",
                      lambda: forward(model, inputs, noise), 10, count(geometry, "bf16"), ms,
                      smi)
        del inputs, noise
    del model
    h, w, views, batch, _ = geometry = GEOMETRIES["train"]
    tensors = batch_to_device(train_batch(batch, views, h, w), device)
    model = seeded_model(torch.bfloat16).to(device)
    optimizer = make_optimizer(model.parameters(), TRAIN_LR)
    gen = torch.Generator(device=device).manual_seed(2)

    def step():
        noise = torch.rand(PatchmatchNet.noise_shape(batch, h, w), generator=gen, device=device)
        return train_step(model, optimizer, tensors, TRAIN_LR, noise)

    ms = time_ms(step, reps=5, warmup=2)
    hold_roofline(f"bf16 train step at {w}x{h} N={views} B={batch}", step, 2,
                  count(geometry, "bf16"), ms, smi)


def measurement_programs(device, scratch, smi) -> None:
    """Phase 15: the port's measurement programs on the card. (a) the
    bench, `python -m patchmatchnet_torch.bench --verbose` (bf16 DTU
    1152x864 N=5, Tanks 1056x1920 N=7, the bf16 train step); (b) the bench
    in f32 alone and `--train`; (c) K1, K2, K3 and K6 against their plain
    versions at the Tanks stage shapes with V = 6 (and ETH3D's stage 1),
    K6 against the per-view route to the bit; (d) `dev.bench_dataset_configs`
    for ETH3D (portrait and landscape views mixed) and Tanks, 2 iterations;
    (e) `dev.bf16_accuracy` on both fixtures, f32 at the golden bounds; (f)
    `dev.bf16_scene_check` at 400x288 N=5 and 1056x1920 N=7, bf16 against
    f32 below f32's own median |depth - GT|; (g) device-busy ms and the
    idle share of one bf16 forward at the DTU, Tanks and ETH3D
    geometries."""
    import numpy as np
    import torch

    from patchmatchnet_torch.dev import bench_dataset_configs, bf16_accuracy, bf16_scene_check
    from patchmatchnet_torch.ops import cuda_build

    started = time.perf_counter()
    torch.cuda.empty_cache()
    forward_kernels = ("warp_group_corr", "warp_group_corr_views", "eval_grid_score",
                       "neighbor_group_corr")
    train_kernels = ("warp_group_corr", "warp_group_corr_backward", "neighbor_group_corr",
                     "neighbor_group_corr_backward")
    record = bench_run("bf16 (DTU, Tanks, train)", [], smi)
    for key in ("value", "tanks_1056x1920_n7_mpix_s", "train_samples_per_s"):
        if key not in record:
            fail(f"bench: no {key} in {record}")
    require_launched("bench bf16", record["launches"], forward_kernels + train_kernels)
    record = bench_run("f32 (DTU alone)", ["--f32", "--no-tanks-metric", "--no-train-metric"], smi)
    require_launched("bench f32", record["launches"], forward_kernels)
    record = bench_run("--train (bf16 trainer)", ["--train"], smi)
    require_launched("bench --train", record["launches"], train_kernels)

    tanks_kernel_parity(device, smi)

    for name in ("eth3d", "tanks"):
        num_views, shapes, bucket = bench_dataset_configs.CONFIGS[name]
        cuda_build.reset_launch_counts()
        res = bench_dataset_configs.run_config(name, iters=DATASET_ITERS, device=str(device))
        counts = cuda_build.launch_counts()
        for s, (depth, conf) in zip(res["per_shape"], res["maps"]):
            h, w = s["shape"]
            print(f"  {name} {h}x{w} N={num_views} (bucket {bucket}): e2e "
                  f"{s['ms_per_map_e2e']:.2f} ms/map, device-resident "
                  f"{s['ms_per_map_device']:.2f} ms/map = {s['mpix_s_device']:.3f} MPix/s, "
                  f"first call {s['first_call_s']:.2f} s; depth {depth.min():.1f}-"
                  f"{depth.max():.1f}, confidence median {np.median(conf):.3f} [{smi}]",
                  flush=True)
            if depth.shape != (h, w) or not (np.isfinite(depth).all() and np.isfinite(conf).all()):
                fail(f"bench_dataset_configs {name} {h}x{w}: maps {depth.shape}, not finite")
        forwards = len(shapes) * 2 * (1 + DATASET_ITERS)
        print(f"  {name}: {res['mpix_s_device']:.3f} MPix/s device-resident over its shapes; "
              f"padded shapes {res['padded_shapes']}; launches {counts} over {forwards} "
              f"forwards", flush=True)
        want = {k: forwards * n for k, n in forward_launches(num_views - 1, 5).items()}
        if counts != want:
            fail(f"bench_dataset_configs {name} launched {counts}, expected {want}")

    for fixture in bf16_accuracy.FIXTURES:
        report = bf16_accuracy.run(fixture, device=str(device))
        worst = max(row["f32_vs_torch_max"] for row in report["stages"].values())
        worst_mean = max(row["f32_vs_torch_mean"] for row in report["stages"].values())
        conf = report["confidence"]["f32"]
        print(f"  {fixture} f32 on the card: stage max {worst:.3e} mean {worst_mean:.3e} of "
              f"the range, depth max {report['depth']['f32_vs_torch_max']:.3e}, confidence "
              f"share > 5e-3 {conf['share_above_5e-3']:.2e} median {conf['median']:.2e}; bf16 "
              f"vs f32 depth mean {report['depth']['bf16_vs_f32_mean']:.3e} [{smi}]",
              flush=True)
        if (worst >= 2e-3 or worst_mean >= 2e-4 or report["depth"]["f32_vs_torch_max"] >= 2e-3
                or conf["share_above_5e-3"] >= 1e-3 or conf["median"] >= 1e-4):
            fail(f"bf16_accuracy {fixture}: f32 outside the golden bounds")

    for h, w, views in SCENE_CHECKS:
        report = bf16_scene_check.run(h, w, views, device=str(device), scratch=scratch)
        gt_err, delta = report["f32"]["median"], report["bf16_vs_f32"]["median"]
        factor = gt_err / delta if delta > 0 else math.inf
        print(f"  bf16_scene_check {w}x{h} N={views}: f32 median |depth - GT| {gt_err:.4e}, "
              f"bf16 vs f32 median {delta:.4e}: {factor:.1f}x below [{smi}]", flush=True)
        if not delta < gt_err:
            fail(f"bf16_scene_check {w}x{h}: bf16 vs f32 {delta:.4e} not below the f32 "
                 f"|depth - GT| {gt_err:.4e}")

    device_busy_per_forward(device, smi)
    print(f"measurement programs phase: {time.perf_counter() - started:.1f} s", flush=True)


def write_raw_dtu(root: str, views: int, lights: int, texture: float) -> str:
    """The raw DTU training layout (`Rectified/`, `Depths_raw/`,
    `Cameras_1/`, as tests/test_dtu_legacy.py writes it) of the textured
    plane: `lights` 640x512 PNG images per view (the plane at light-scaled
    brightness), cam files at 1/4 resolution, 1600x1200 depth maps of the
    plane and visual masks (an interior rectangle); pair.txt lists the
    middle view with the others as sources. Returns the scan list."""
    import numpy as np

    from patchmatchnet_torch.data import (
        PLANE_Z,
        save_cam_file,
        save_image,
        save_pair_file,
        save_pfm,
    )
    from patchmatchnet_torch.data.synthetic import world_texture

    scan = "scan1"
    for folder in ("Cameras_1/train", f"Rectified/{scan}_train", f"Depths_raw/{scan}"):
        os.makedirs(os.path.join(root, folder), exist_ok=True)
    f = 1.1 * max(TRAIN_H, TRAIN_W)
    k = np.array([[f, 0, TRAIN_W / 2.0], [0, f, TRAIN_H / 2.0], [0, 0, 1]], np.float32)
    k_quarter = k.copy()
    k_quarter[:2] /= 4.0
    uu, vv = np.meshgrid(np.arange(TRAIN_W), np.arange(TRAIN_H))
    visual = np.zeros((1200, 1600), np.float32)
    visual[200:1000, 200:1400] = 1.0
    for v in range(views):
        e = np.eye(4, dtype=np.float32)
        e[0, 3] = 0.35 * (v - (views - 1) / 2.0)
        save_cam_file(os.path.join(root, "Cameras_1", "train", f"{v:08d}_cam.txt"), k_quarter,
                      e, [0.8 * PLANE_Z, 1.3 * PLANE_Z])
        img = world_texture((uu - k[0, 2]) / k[0, 0] * PLANE_Z - e[0, 3],
                            (vv - k[1, 2]) / k[1, 1] * PLANE_Z, texture)
        for light in range(lights):
            save_image(os.path.join(root, "Rectified", f"{scan}_train",
                                    f"rect_{v + 1:03d}_{light}_r5000.png"),
                       img * (0.7 + 0.05 * light))
        save_pfm(os.path.join(root, "Depths_raw", scan, f"depth_map_{v:04d}.pfm"),
                 np.full((1200, 1600), PLANE_Z, np.float32))
        save_image(os.path.join(root, "Depths_raw", scan, f"depth_visual_{v:04d}.png"), visual)
    mid = views // 2
    save_pair_file(os.path.join(root, "Cameras_1", "pair.txt"),
                   [(mid, [(s, 10.0 - abs(s - mid)) for s in sorted(
                       (s for s in range(views) if s != mid), key=lambda s: abs(s - mid))])])
    list_file = os.path.join(root, "train.txt")
    with open(list_file, "w") as fh:
        fh.write(scan + "\n")
    return list_file


def compare_curves(stderr: str):
    """The per-step lines of `dev.bf16_train_compare --log-every 1`:
    {precision: (losses, stage-0 depth errors, step walls in ms)}."""
    curves = {"f32": ([], [], []), "bf16": ([], [], [])}
    pattern = re.compile(r"^\[(f32|bf16)\] step\s+(\d+) loss (\S+) depth-err (\S+) "
                         r"wall (\S+) ms$")
    for line in stderr.splitlines():
        m = pattern.match(line)
        if m:
            losses, errs, walls = curves[m.group(1)]
            if int(m.group(2)) != len(losses):
                fail(f"bf16_train_compare: {m.group(1)} step {m.group(2)} out of order")
            losses.append(float(m.group(3)))
            errs.append(float(m.group(4)))
            walls.append(float(m.group(5)))
    return curves


def precision_and_cli_paths(device, scratch, smi) -> None:
    """Phase 16: (a) `python -m patchmatchnet_torch.dev.bf16_train_compare`
    at its defaults for COMPARE_STEPS steps in its own process: every loss
    finite, the gates (COMPARE_*), its launches, step walls; then a trace of
    2 train steps of each precision from scratch in this process; (b) the
    CLI's eval at its default --num_views 20 on a 21-view 1152x864 scene:
    launches, finite maps, view 0 against DepthEstimator in this process at
    phase 12 (a)'s bound, warm in-process ms per map; K6 at V = 20 at the
    three stage shapes against the per-view route to the bit and its plain
    version at phase 3's bounds; (c) `train --dataset dtu_legacy` at 640x512,
    B = 2, 1 + 4 views, 3 steps from the released weights."""
    import numpy as np
    import torch
    from PIL import Image

    from patchmatchnet_torch import ops
    from patchmatchnet_torch.bench import seeded_model
    from patchmatchnet_torch.config import Config
    from patchmatchnet_torch.dev.roofline import bound, kernel_work
    from patchmatchnet_torch.data import (
        PLANE_Z,
        BatchLoader,
        MVSDataset,
        make_synthetic_scene,
        read_pfm,
        read_ply,
    )
    from patchmatchnet_torch.dev import bf16_train_compare
    from patchmatchnet_torch.dev.profile_coord import rig_mats
    from patchmatchnet_torch.infer import DepthEstimator
    from patchmatchnet_torch.models.patchmatch import STAGE_CONFIG
    from patchmatchnet_torch.train import batch_to_device, make_optimizer, train_step
    from patchmatchnet_torch.train.driver import build_model, load_any_checkpoint
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

    started = time.perf_counter()
    torch.cuda.empty_cache()

    # (a) f32 against bf16, from scratch, at the tool's defaults
    proc, seconds = run_module("bf16_train_compare", "patchmatchnet_torch.dev.bf16_train_compare",
                               ["--steps", str(COMPARE_STEPS), "--log-every", "1"],
                               COMPARE_TIMEOUT)
    try:
        record = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        fail(f"bf16_train_compare: no JSON line in {proc.stdout[-500:]!r}")
    curves = compare_curves(proc.stderr)
    for line in proc.stderr.splitlines():
        if not line.startswith(("[f32] step", "[bf16] step")):
            print(f"  {line}", flush=True)
    print(f"bf16_train_compare, {TRAIN_W}x{TRAIN_H}, 1 + {COMPARE_SOURCES} views, B={TRAIN_BATCH}, "
          f"{COMPARE_STEPS} steps from scratch ({seconds:.1f} s in all; {smi}): "
          f"{json.dumps(record)}", flush=True)
    gates = []
    for name, (losses, errs, walls) in curves.items():
        if len(losses) != COMPARE_STEPS or not all(map(math.isfinite, losses + errs)):
            fail(f"bf16_train_compare {name}: {len(losses)} steps logged, finite "
                 f"{all(map(math.isfinite, losses + errs))}")
        first, last = statistics.median(losses[:10]), statistics.median(losses[-10:])
        later = walls[1:]
        print(f"  {name}: loss at steps 0, 10, 50, 100, 200, {COMPARE_STEPS - 1}: "
              + " ".join(f"{losses[i]:.4e}" for i in (0, 10, 50, 100, 200, COMPARE_STEPS - 1))
              + f"; median of the first / last 10 {first:.4e} / {last:.4e} (ratio "
              f"{last / first:.4e}); stage-0 depth error at the end {errs[-1]:.4e}; step wall "
              f"(synced) median {statistics.median(later):.2f} ms, p10 "
              f"{float(np.percentile(later, 10)):.2f}, p90 {float(np.percentile(later, 90)):.2f}, "
              f"first {walls[0]:.1f} [{smi}]", flush=True)
        gates.append((f"{name} last-10 median loss <= {COMPARE_DROP} x first-10",
                      last <= COMPARE_DROP * first))
    for key, want in (("f32_final_loss", curves["f32"][0][-1]),
                      ("bf16_final_loss", curves["bf16"][0][-1]),
                      ("f32_final_depth_err", curves["f32"][1][-1]),
                      ("bf16_final_depth_err", curves["bf16"][1][-1])):
        if not math.isclose(record[key], want, rel_tol=1e-5):
            fail(f"bf16_train_compare: {key} {record[key]} against its last logged {want}")
    gates.append((f"bf16 final depth error <= {COMPARE_ERR_FACTOR} x f32's + {COMPARE_ERR_SLACK}",
                  record["bf16_final_depth_err"]
                  <= COMPARE_ERR_FACTOR * record["f32_final_depth_err"] + COMPARE_ERR_SLACK))
    gates.append((f"median relative loss divergence <= {COMPARE_DIV_MEDIAN}",
                  record["rel_loss_div_median"] <= COMPARE_DIV_MEDIAN))
    print("  gates: " + "; ".join(f"{label}: {'held' if ok else 'MISSED'}"
                                  for label, ok in gates), flush=True)
    counts = printed_launches(proc.stderr)
    want = {k: 2 * COMPARE_STEPS * n for k, n in step_launches(COMPARE_SOURCES, 5).items()}
    if counts != want:
        fail(f"bf16_train_compare launched {counts}, expected {want}")
    missed = [label for label, ok in gates if not ok]
    if missed:
        fail("bf16_train_compare: " + "; ".join(missed))

    # launches and device time per step of each precision, from scratch:
    # 2 steps traced after 2
    batch = batch_to_device(bf16_train_compare.build_batch(TRAIN_H, TRAIN_W, TRAIN_BATCH,
                                                           COMPARE_SOURCES), device)
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        model = seeded_model(dtype).to(device)
        opt = make_optimizer(model.parameters(), 1e-3)
        step_i = [0]

        def step():
            noise = bf16_train_compare.step_noise(batch, step_i[0])
            step_i[0] += 1
            return train_step(model, opt, batch, 1e-3, noise)[0]["loss"]

        for _ in range(2):
            float(step())
        print(f"  {name} trainer:", flush=True)
        trace_steps(step, 2, os.path.join(scratch, f"compare_{name}_trace.json"))
        del model, opt
    del batch
    torch.cuda.empty_cache()

    # (b) the CLI's eval at its default --num_views 20
    scene = os.path.join(scratch, "many")
    views = MANY_SOURCES + 1
    make_synthetic_scene(scene, num_views=views, height=MAIN_H, width=MAIN_W,
                         texture_scale=CLI_EVAL_TEXTURE)
    out = os.path.join(scratch, "many_out")
    stdout, counts, seconds = run_cli(
        f"eval ({MANY_SOURCES} sources)", ["eval", "--input_folder", scene, "--output_folder",
                                           out, "--checkpoint_path", CKPT,
                                           "--image_extension", ".png"], CLI_TIMEOUT)
    maps = WROTE_MAPS.search(stdout)
    fused = re.search(r"Fused (\S+) in ([\d.]+) s", stdout)
    if not maps or not fused or int(maps.group(1)) != views:
        fail(f"CLI eval ({MANY_SOURCES} sources) printed no map or fusion timing for {views} "
             "views")
    expect_launches(f"eval ({MANY_SOURCES} sources)", counts,
                    [(views, forward_launches(MANY_SOURCES, 5))])
    errs = []
    for v in range(views):
        depth = read_pfm(os.path.join(out, "depth_est", f"{v:08d}.pfm"))[..., 0]
        conf = read_pfm(os.path.join(out, "confidence", f"{v:08d}.pfm"))[..., 0]
        for name, m in (("depth", depth), ("confidence", conf)):
            if m.shape != (MAIN_H, MAIN_W) or not np.isfinite(m).all():
                fail(f"CLI eval ({MANY_SOURCES} sources) view {v}: {name} map {m.shape}, finite "
                     f"{np.isfinite(m).all()}")
        final = np.asarray(Image.open(os.path.join(out, "mask", f"{v:08d}_final.png"))) > 0
        errs.append((float(np.median(np.abs(depth - PLANE_Z))), float(final.mean())))
    xyz, _ = read_ply(fused.group(1))
    z_err = float(np.median(np.abs(xyz[:, 2] - PLANE_Z))) if xyz.shape[0] else float("nan")
    print(f"CLI eval {MAIN_W}x{MAIN_H}, {views} views, 1 + {MANY_SOURCES} views per map: "
          f"{float(maps.group(3)):.2f} ms per map ({maps.group(2)} s for {maps.group(1)} maps; "
          f"requests: the first {maps.group(4)} ms with its set-up, then median "
          f"{maps.group(5)} ms); fusion {float(fused.group(2)) * 1e3 / views:.2f} ms per fused "
          f"view ({fused.group(2)} s), {xyz.shape[0]} points, median |z - plane| {z_err:.4f}; "
          "median |depth - plane| (final-mask share) per view, not gated: "
          + " ".join(f"{e:.4f} ({m:.2f})" for e, m in errs) + f"; card {smi}", flush=True)

    model = build_model(Config(), inference=True)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    estimator = DepthEstimator(model, device=device)
    dataset = MVSDataset(scene, MANY_SOURCES, ".png")
    batch = next(iter(BatchLoader(dataset, 1, num_threads=1)))
    if batch["images"].shape[1] != views:
        fail(f"the dataset gives {batch['images'].shape[1]} views a sample, expected {views}")
    depth = estimator(batch, torch.Generator(device=device).manual_seed(0))[0][0]
    cli_depth = read_pfm(os.path.join(out, "depth_est", "00000000.pfm"))[..., 0]
    diff = np.abs(depth - cli_depth)
    off = float((diff > 1e-3 * (1.3 - 0.8) * PLANE_Z).mean())
    print(f"CLI view 0 ({MANY_SOURCES} sources) against DepthEstimator in this process: max "
          f"|diff| {diff.max():.3e}, median {np.median(diff):.3e}, share of pixels off by more "
          f"than 1e-3 of the depth range {off:.2e}", flush=True)
    if np.median(diff) != 0.0 or off > 1e-3:
        fail(f"CLI view 0 ({MANY_SOURCES} sources) differs from DepthEstimator (bounds: median "
             "0, at most 0.1% of the pixels off by more than 1e-3 of the depth range)")
    ms = []
    for i, batch in enumerate(BatchLoader(dataset, 1)):
        if i == 5:
            break
        torch.cuda.synchronize()
        start = time.perf_counter()
        estimator(batch, torch.Generator(device=device).manual_seed(0))
        ms.append((time.perf_counter() - start) * 1e3)
    print(f"DepthEstimator in this process, 1 + {MANY_SOURCES} views, warm: ms per map "
          + " ".join(f"{t:.2f}" for t in ms) + f" (median {statistics.median(ms):.2f}) [{smi}]",
          flush=True)
    del estimator, model
    torch.cuda.empty_cache()

    # K6 at V = 20 (two chunks of views) at the main path's stage shapes
    gen = torch.Generator(device=device).manual_seed(16)
    route_diff, dev_total = 0.0, 0.0
    for stage, c, g, scale, d, launches in ((3, 64, 8, 8, 32, 1), (2, 32, 8, 4, 16, 2),
                                            (1, 16, 4, 2, 8, 1)):
        h, w = MAIN_H // scale, MAIN_W // scale
        mats = rig_mats(h, w, scale, MANY_SOURCES).to(device)
        ref = torch.randn((1, h, w, c), generator=gen, device=device).to(torch.bfloat16)
        stack = torch.randn((1, MANY_SOURCES, h, w, c), generator=gen,
                            device=device).to(torch.bfloat16)
        vw = torch.rand((1, MANY_SOURCES, h, w), generator=gen, device=device)
        depth = 4.8 + 3.0 * torch.rand((1, d, h, w), generator=gen, device=device)
        depth[:, -1, :4] = -1.0  # behind the source camera: pz <= 1e-3
        args = (stack, mats, depth, ref, vw, g)
        got = ops.warp_group_corr_views(*args)
        diff = (got - per_view_route(*args)).abs().max().item()
        route_diff = max(route_diff, diff)
        label = f"stage{stage} C{c} G{g} D{d} V{MANY_SOURCES} {h}x{w} bf16"
        hold("warp_group_corr_views", f"{label} (max |K6 - per-view route| {diff:.3e})", got,
             ops.warp_group_corr_views_reference(*args), STAGE_CONFIG[stage].interval_scale)
        dev = device_ms(lambda: ops.warp_group_corr_views(*args))
        route_dev = device_ms(lambda: per_view_route(*args))
        dev_total = None if dev is None or dev_total is None else dev_total + dev * launches
        work_ms, by = bound(*kernel_work("warp_group_corr_views", args, got))
        print(f"  K6 {label}: device {fmt_ms(dev)} (x{launches}/forward), the per-view route "
              f"{fmt_ms(route_dev)}, bound {work_ms:.4f} ms ({by})", flush=True)
        del stack, args, got
    print(f"K6 at V = {MANY_SOURCES}: max |K6 - per-view route| {route_diff:.3e} over the three "
          f"stage shapes; device ms per forward {fmt_ms(dev_total)} [{smi}]", flush=True)
    if route_diff != 0.0:
        fail(f"K6 at V = {MANY_SOURCES} differs from the per-view route")
    torch.cuda.empty_cache()

    # (c) the raw DTU layout's training at 640x512
    root = os.path.join(scratch, "raw_dtu")
    list_file = write_raw_dtu(root, RAW_DTU_VIEWS, RAW_DTU_LIGHTS, 8.0)
    out = os.path.join(scratch, "raw_dtu_out")
    _, counts, seconds = run_cli("train (dtu_legacy)", [
        "train", "--input_folder", root, "--output_folder", out, "--dataset", "dtu_legacy",
        "--train_list", list_file, "--test_list", list_file, "--num_views", str(RAW_DTU_VIEWS),
        "--batch_size", str(TRAIN_BATCH), "--epochs", "1", "--checkpoint_path", CKPT,
        "--summary_freq", "1"], CLI_TIMEOUT)
    records = read_training_run(out, RAW_DTU_STEPS)
    val = -(-RAW_DTU_LIGHTS // TRAIN_BATCH)  # validation batches (the last one short)
    print(f"CLI train --dataset dtu_legacy {TRAIN_W}x{TRAIN_H}, 1 + {RAW_DTU_VIEWS - 1} views, "
          f"B {TRAIN_BATCH}, {RAW_DTU_STEPS} steps: ms per step "
          + " ".join(f"{r['step_ms']:.2f}" for r in records) + ", losses "
          + " ".join(f"{r['loss']:.5f}" for r in records)
          + f", peak {records[-1].get('peak_mib', float('nan')):.1f} MiB; card {smi}", flush=True)
    expect_launches("train (dtu_legacy)", counts,
                    [(RAW_DTU_STEPS, step_launches(RAW_DTU_VIEWS - 1, 5)),
                     (val, forward_launches(RAW_DTU_VIEWS - 1, 5))])
    print(f"training precision and CLI paths phase: {time.perf_counter() - started:.1f} s",
          flush=True)


def write_plane_scan(root: str, cameras, texture: float) -> None:
    """A scan of the textured plane (`data.synthetic`'s world texture at
    z = PLANE_Z, depth range 0.8-1.3 x PLANE_Z) for `cameras`, one
    (height, width, x, y) per view (identity rotation, centre (x, y, 0),
    focal length 1.1 x the longer side), with pair.txt giving each
    reference its PRESET_SOURCES nearest views of its own size, or for a
    portrait reference of the landscape views, best first. Images are PNG
    at zlib level 1, rendered on threads."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from PIL import Image

    from patchmatchnet_torch.data import PLANE_Z, save_cam_file, save_pair_file
    from patchmatchnet_torch.data.synthetic import world_texture

    for folder in ("images", "cams"):
        os.makedirs(os.path.join(root, folder), exist_ok=True)

    def write(v):
        h, w, tx, ty = cameras[v]
        f = 1.1 * max(h, w)
        k = np.array([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], dtype=np.float32)
        e = np.eye(4, dtype=np.float32)
        e[0, 3], e[1, 3] = -tx, -ty
        # the texture is separable in x and y: rows and columns back-projected once
        xs = (np.arange(w) - k[0, 2]) / k[0, 0] * PLANE_Z + tx
        ys = (np.arange(h) - k[1, 2]) / k[1, 1] * PLANE_Z + ty
        image = world_texture(xs[None, :], ys[:, None], texture)
        Image.fromarray((image * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"{v:08d}.png"), compress_level=1)
        save_cam_file(os.path.join(root, "cams", f"{v:08d}_cam.txt"), k, e,
                      [0.8 * PLANE_Z, 1.3 * PLANE_Z])

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, range(len(cameras))))
    def source(v, s):  # a view of v's size; for a portrait v, a landscape view
        (h, w), (sh, sw) = cameras[v][:2], cameras[s][:2]
        return s != v and ((sh, sw) == (h, w) or sh < sw and h > w)

    pairs = []
    for v, (_, _, tx, ty) in enumerate(cameras):
        dist = sorted((math.hypot(cameras[s][2] - tx, cameras[s][3] - ty), s)
                      for s in range(len(cameras)) if source(v, s))
        pairs.append((v, [(s, 10.0 - d) for d, s in dist[:PRESET_SOURCES]]))
    save_pair_file(os.path.join(root, "pair.txt"), pairs)


def eval_preset(device, scratch, smi, preset: str, cameras, max_dim: int) -> float:
    """One preset of scripts/eval_torch.sh (phase 17) over a scan of the
    plane at `cameras`' sizes, in its own process: its maps and fused.ply,
    ms per map (the first request apart) and per fused view, fusion's peak
    device MiB, the points and their median |z - plane|, launches per map
    (`forward_launches` of PRESET_SOURCES sources); view 0 against
    DepthEstimator in this process (max |diff| 0). Returns its seconds."""
    import numpy as np
    import torch

    from patchmatchnet_torch.config import Config
    from patchmatchnet_torch.data import (
        PLANE_Z,
        BatchLoader,
        MVSDataset,
        read_pfm,
        read_ply,
        scaled_dims,
    )
    from patchmatchnet_torch.infer import DepthEstimator
    from patchmatchnet_torch.train.driver import build_model, load_any_checkpoint

    started = time.perf_counter()
    scan = "scan1"
    root = os.path.join(scratch, preset)
    write_plane_scan(os.path.join(root, scan), cameras, CLI_EVAL_TEXTURE * max_dim / CLI_EVAL_W)
    written = time.perf_counter() - started
    scan_list = os.path.join(root, "scans.txt")
    with open(scan_list, "w") as f:
        f.write(scan + "\n")
    out = os.path.join(scratch, f"{preset}_out")
    proc, seconds = run_command(
        f"scripts/eval_torch.sh {preset}", ["bash", "scripts/eval_torch.sh", preset, root, out,
                                            scan_list, "--image_extension", ".png"],
        PRESET_TIMEOUT)
    stdout = proc.stdout
    counts = printed_launches(stdout)
    maps = WROTE_MAPS.search(stdout)
    fused = re.search(r"Fused (\S+) in ([\d.]+) s \(peak device memory ([\d.]+) MiB\)", stdout)
    views = len(cameras)
    if not maps or not fused or int(maps.group(1)) != views:
        print(stdout[-2000:], flush=True)
        fail(f"{preset} printed no map, fusion timing or peak memory for {views} views")
    expect_launches(preset, counts, [(views, forward_launches(PRESET_SOURCES, 5))])
    errs = []
    for v, (h, w, _, _) in enumerate(cameras):
        shape = scaled_dims(h, w, max_dim)
        depth = read_pfm(os.path.join(out, scan, "depth_est", f"{v:08d}.pfm"))[..., 0]
        conf = read_pfm(os.path.join(out, scan, "confidence", f"{v:08d}.pfm"))[..., 0]
        for name, m in (("depth", depth), ("confidence", conf)):
            if m.shape != shape or not np.isfinite(m).all():
                fail(f"{preset} view {v}: {name} map {m.shape} (expected {shape}), finite "
                     f"{np.isfinite(m).all()}")
        errs.append(float(np.median(np.abs(depth - PLANE_Z))))
    xyz, _ = read_ply(fused.group(1))
    z_err = float(np.median(np.abs(xyz[:, 2] - PLANE_Z))) if xyz.shape[0] else float("nan")
    sizes = sorted({(w, h) for h, w, _, _ in cameras})
    shown = " and ".join(f"{w}x{h} (at {scaled_dims(h, w, max_dim)[1]}x"
                         f"{scaled_dims(h, w, max_dim)[0]})" for w, h in sizes)
    print(f"{preset} ({shown} images at --image_max_dim {max_dim}"
          f"; {views} maps of 1 + {PRESET_SOURCES} views): {float(maps.group(3)):.2f} ms per "
          f"map ({maps.group(2)} s in all; requests: the first {maps.group(4)} ms with its "
          f"set-up, then median {maps.group(5)} ms); fusion "
          f"{float(fused.group(2)) * 1e3 / views:.2f} ms per fused view ({fused.group(2)} s), "
          f"peak device memory {fused.group(3)} MiB at {PRESET_SOURCES} sources per reference; "
          f"{xyz.shape[0]} points, median |z - plane| {z_err:.4f}; launches {counts} = {views} x "
          f"{forward_launches(PRESET_SOURCES, 5)}; median |depth - plane| per map (not gated) "
          + " ".join(f"{e:.4f}" for e in errs)
          + f"; process {seconds:.1f} s, scene written in {written:.1f} s [{smi}]", flush=True)
    if xyz.shape[0] == 0:
        fail(f"{preset}: fused.ply has no points")

    model = build_model(Config(), inference=True)
    model.load_state_dict(load_any_checkpoint(CKPT), strict=True)
    estimator = DepthEstimator(model, device=device)
    dataset = MVSDataset(root, PRESET_SOURCES + 1, ".png", max_dim=max_dim, scan_list=scan_list)
    batch = next(iter(BatchLoader(dataset, 1, num_threads=1)))
    if batch["images"].shape[1] != PRESET_SOURCES + 1:
        fail(f"{preset}: {batch['images'].shape[1]} views a sample, expected "
             f"{PRESET_SOURCES + 1}")
    depth = estimator(batch, torch.Generator(device=device).manual_seed(0))[0][0]
    cli_depth = read_pfm(os.path.join(out, scan, "depth_est", "00000000.pfm"))[..., 0]
    diff = float(np.abs(depth - cli_depth).max())
    print(f"{preset} view 0 against DepthEstimator in this process: max |diff| {diff:.3e}",
          flush=True)
    if diff != 0.0:
        fail(f"{preset}: the CLI's view 0 differs from DepthEstimator by {diff:.3e}")
    del estimator, model
    torch.cuda.empty_cache()
    return time.perf_counter() - started


def eval_presets_path(device, scratch, smi) -> None:
    """Phase 17: scripts/eval_torch.sh's run_eth3d over 7 landscape views of
    ETH3D's 6048x4032 and one portrait view (evaluated at 2688x1792 and
    1792x2688), and run_tanks over 7 views of 1920x1080 (`eval_preset`)."""
    started = time.perf_counter()
    baseline = 0.35
    landscape = [(ETH3D_SENSOR_H, ETH3D_SENSOR_W, baseline * (v - 3), 0.0) for v in range(7)]
    portrait = [(ETH3D_SENSOR_W, ETH3D_SENSOR_H, baseline / 2, baseline)]
    eth3d = eval_preset(device, scratch, smi, "run_eth3d", landscape + portrait, ETH3D_MAX_DIM)
    tanks = eval_preset(device, scratch, smi, "run_tanks",
                        [(TANKS_VIDEO_H, TANKS_VIDEO_W, baseline * (v - 3), 0.0)
                         for v in range(7)], TANKS_MAX_DIM)
    print(f"eval presets phase: {time.perf_counter() - started:.1f} s (run_eth3d {eth3d:.1f}, "
          f"run_tanks {tanks:.1f})", flush=True)


def host_cpu() -> str:
    """The host CPU's model name (lscpu; with its vendor, family and model
    numbers where a virtual machine hides the name) and os.cpu_count()."""
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, check=True).stdout
    except (OSError, subprocess.CalledProcessError) as e:
        return f"lscpu failed ({e}), {os.cpu_count()} CPUs"
    fields = dict(line.split(":", 1) for line in out.splitlines() if ":" in line)
    fields = {key.strip(): value.strip() for key, value in fields.items()}
    model = fields.get("Model name", "unknown")
    if model == "unknown":
        model += (f" ({fields.get('Vendor ID', '?')} family {fields.get('CPU family', '?')} "
                  f"model {fields.get('Model', '?')})")
    return f"{model}, {os.cpu_count()} CPUs"


def host_turns(fns, reps: int = HOST_REPS):
    """Median ms of each host function of `fns` (name -> fn), run in turns:
    in order, then reversed, `reps` rounds (twin, lib, lib, twin, ...)."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(reps):
        for name in names if r % 2 == 0 else names[::-1]:
            start = time.perf_counter()
            fns[name]()
            times[name].append((time.perf_counter() - start) * 1e3)
    return {name: statistics.median(t) for name, t in times.items()}


def host_library_path(scratch, smi, host) -> None:
    """Phase 18: the host library against its numpy twins at ETH3D's and
    Tanks' sizes, `F.interpolate` beside the resizes, and one ETH3D view by
    section (module docstring)."""
    import numpy as np
    import torch
    import torch.nn.functional as F
    from PIL import Image

    from patchmatchnet_torch import native
    from patchmatchnet_torch.data import read_image, scaled_dims

    started = time.perf_counter()
    tag = f"[{smi}; host {host}; torch threads {torch.get_num_threads()}]"
    built = native.build_seconds()
    print(f"host library {native.library_path().relative_to(REPO)}: "
          + (f"built by g++ in {built:.2f} s (phase 2)" if built is not None else "reused")
          + f" {tag}", flush=True)
    src = torch.ones(HOST_COPY_BYTES // 4)  # written first: no page faults in the copies
    dst = torch.zeros_like(src)
    copies = []
    for _ in range(2 + HOST_REPS):  # the first two wake torch's thread pool
        start = time.perf_counter()
        dst.copy_(src)
        copies.append((time.perf_counter() - start) * 1e3)
    copy_ms = min(copies[2:])  # the bound takes the fastest copy
    rate = 2 * HOST_COPY_BYTES / (copy_ms * 1e-3)  # bytes read + written per second
    del src, dst
    print(f"host copy rate: {rate / 1e9:.3f} GB/s (torch copy_ of {HOST_COPY_BYTES >> 20} MiB, "
          f"fastest of {HOST_REPS}: {copy_ms:.3f} ms; all "
          + " ".join(f"{t:.3f}" for t in copies[2:]) + ")", flush=True)

    def interpolate(images, out_h, out_w):  # [N, H, W, C] viewed as channels-last NCHW
        t = torch.from_numpy(images).permute(0, 3, 1, 2)
        return F.interpolate(t, size=(out_h, out_w), mode="bilinear", align_corners=False,
                             antialias=False).permute(0, 2, 3, 1)

    rng = np.random.default_rng(18)
    rows = []

    def case(name, shape, lib, twin, args, out_shape, yardstick=None):
        got, want = lib(*args), twin(*args)
        if got.shape != out_shape or not np.array_equal(got, want):
            fail(f"host library {name} at {shape}: {got.shape} against {out_shape}, max |diff| "
                 f"{np.abs(got.astype(np.float64) - want).max():.3e} (must be equal)")
        fns = {"twin": lambda: twin(*args), "lib": lambda: lib(*args)}
        row = {"name": name, "shape": shape, "max_abs_err": 0.0,
               "bytes": int(sum(a.nbytes for a in args if isinstance(a, np.ndarray))
                            + got.nbytes)}
        if yardstick is not None:
            fns["interpolate"] = lambda: yardstick(*args)
            row["interpolate_max_abs_diff"] = float(np.abs(
                yardstick(*args).numpy().reshape(got.shape) - got).max())
        ms = host_turns(fns)
        row.update({"lib_ms": ms["lib"], "twin_ms": ms["twin"],
                    "interpolate_ms": ms.get("interpolate"),
                    "bound_ms": row["bytes"] / rate * 1e3})
        rows.append(row)
        print(f"host {name} {shape}: lib {ms['lib']:.3f} ms, twin {ms['twin']:.3f} ms"
              + (f", F.interpolate {ms['interpolate']:.3f} ms (max |diff| "
                 f"{row['interpolate_max_abs_diff']:.3e})" if yardstick is not None else "")
              + f"; equal to the twin; {row['bytes']} bytes, bound {row['bound_ms']:.3f} ms "
              f"at the copy rate {tag}", flush=True)

    out_h, out_w = scaled_dims(ETH3D_SENSOR_H, ETH3D_SENSOR_W, ETH3D_MAX_DIM)
    levels = rng.integers(0, 256, (ETH3D_SENSOR_H, ETH3D_SENSOR_W, 3), dtype=np.uint8)
    image = native.u8_to_f32_reference(levels)
    case("u8_to_f32", f"ETH3D {ETH3D_SENSOR_H}x{ETH3D_SENSOR_W}x3", native.u8_to_f32,
         native.u8_to_f32_reference, (levels,), levels.shape)
    case("resize_bilinear", f"ETH3D {ETH3D_SENSOR_H}x{ETH3D_SENSOR_W}x3 -> {out_h}x{out_w}",
         native.resize_bilinear, native.resize_bilinear_reference, (image, out_h, out_w),
         (out_h, out_w, 3), lambda im, h, w: interpolate(im[None], h, w)[0])
    del image
    tanks = rng.integers(0, 256, (TANKS_VIDEO_H, TANKS_VIDEO_W, 3), dtype=np.uint8)
    case("u8_to_f32", f"Tanks {TANKS_VIDEO_H}x{TANKS_VIDEO_W}x3", native.u8_to_f32,
         native.u8_to_f32_reference, (tanks,), tanks.shape)
    in_h, in_w = scaled_dims(TANKS_VIDEO_H, TANKS_VIDEO_W, HOST_BATCH_MAX_DIM)
    new_h, new_w = int(round(in_h / 8)) * 8, int(round(in_w / 8)) * 8
    views = native.u8_to_f32_reference(rng.integers(
        0, 256, (HOST_BATCH_VIEWS, in_h, in_w, 3), dtype=np.uint8))
    case("resize_bilinear_batch (4 threads)",
         f"{HOST_BATCH_VIEWS} x {in_h}x{in_w}x3 -> {new_h}x{new_w}",
         native.resize_bilinear_batch, native.resize_bilinear_batch_reference,
         (views, new_h, new_w), (HOST_BATCH_VIEWS, new_h, new_w, 3), interpolate)
    depth = rng.random((out_h, out_w, 1), dtype=np.float32)
    flipped = np.empty_like(depth)
    native.get_lib().flip_vertical_f32(depth, out_h, out_w, flipped)
    if not np.array_equal(flipped, np.flipud(depth)):
        fail("host library flip_vertical_f32 differs from np.flipud")
    print(f"host flip_vertical_f32 {out_h}x{out_w}x1: equal to np.flipud (no path calls it)",
          flush=True)

    # one ETH3D view as the image path reads it: decode, u8 -> f32, shrink
    root = os.path.join(scratch, "eth3d_view")
    write_plane_scan(root, [(ETH3D_SENSOR_H, ETH3D_SENSOR_W, 0.0, 0.0)],
                     CLI_EVAL_TEXTURE * ETH3D_MAX_DIM / CLI_EVAL_W)
    path = os.path.join(root, "images", "00000000.png")
    want = read_image(path, ETH3D_MAX_DIM)
    sections = {side: {"decode": [], "u8_to_f32": [], "shrink": []} for side in ("twin", "lib")}
    routes = {"twin": (native.u8_to_f32_reference, native.resize_bilinear_reference),
              "lib": (native.u8_to_f32, native.resize_bilinear)}

    def view(side):
        convert, shrink = routes[side]
        t0 = time.perf_counter()
        with Image.open(path) as im:
            raw = np.asarray(im)
        t1 = time.perf_counter()
        f = convert(raw)
        t2 = time.perf_counter()
        out = shrink(f, out_h, out_w)
        t3 = time.perf_counter()
        for key, seconds in zip(("decode", "u8_to_f32", "shrink"), (t1 - t0, t2 - t1, t3 - t2)):
            sections[side][key].append(seconds * 1e3)
        if not np.array_equal(out, want):
            fail(f"ETH3D view through the {side} differs from read_image")

    host_turns({"twin": lambda: view("twin"), "lib": lambda: view("lib")})
    per_view = {side: {key: statistics.median(v) for key, v in secs.items()}
                for side, secs in sections.items()}
    for side in ("lib", "twin"):
        p = per_view[side]
        print(f"ETH3D view {ETH3D_SENSOR_W}x{ETH3D_SENSOR_H} PNG -> {out_w}x{out_h} through the "
              f"{side}: decode {p['decode']:.3f} ms, u8_to_f32 {p['u8_to_f32']:.3f} ms, shrink "
              f"{p['shrink']:.3f} ms, sum {sum(p.values()):.3f} ms (medians of {HOST_REPS}; "
              f"equal to read_image) {tag}", flush=True)
    print("host library: " + json.dumps({"card": smi, "host": host,
                                         "torch_threads": torch.get_num_threads(),
                                         "build_s": built, "copy_rate_gb_s": rate / 1e9,
                                         "functions": rows, "eth3d_view_ms": per_view}),
          flush=True)
    print(f"host library phase: {time.perf_counter() - started:.1f} s", flush=True)


def read_training_run(out: str, steps: int):
    """The train records of a CLI training run (metrics.jsonl), after
    checking its checkpoint set, a finite loss logged for each of its
    `steps` steps (run with --summary_freq 1) and a validation."""
    for name in ("params_000000.ckpt.pt", "module_000000.pt", "config.json", "metrics.jsonl"):
        if not os.path.isfile(os.path.join(out, name)):
            fail(f"CLI train wrote no {name}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    train = [r for r in records if r["mode"] == "train"]
    if len(train) != steps or not all(math.isfinite(r["loss"]) for r in train):
        fail(f"CLI train logged {len(train)} steps, losses {[r['loss'] for r in train]}")
    if not any(r["mode"] == "full_test" for r in records):
        fail("CLI train logged no validation")
    return train


def casmvsnet_path(device, scratch, smi):
    """Phase 19: returns ({"variance_volume", "prob_conv3d", "conv3d_block":
    summary entry}, {kernel: launches of the DepthEstimator run})."""
    import numpy as np
    import torch

    from patchmatchnet_torch.config import Config
    from patchmatchnet_torch.data import BatchLoader, MVSDataset, make_synthetic_scene, read_pfm
    from patchmatchnet_torch.dev.roofline import (
        BF16_TENSOR_OPS_PER_S,
        F32_OPS_PER_S,
        bound,
        kernel_work,
    )
    from patchmatchnet_torch.infer import DepthEstimator, save_depth_maps
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.ops.prob_conv3d import prob_conv3d, prob_conv3d_reference
    from patchmatchnet_torch.ops.variance_volume import (
        variance_volume,
        variance_volume_reference,
    )
    from patchmatchnet_torch.ops.warp import warp_proj_coeffs
    from patchmatchnet_torch.train.driver import build_model
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms, whole_trace
    from pmnbench.reference_casmvsnet import seeded_state

    name, head, block = "variance_volume", "prob_conv3d", "conv3d_block"
    summaries = new_summary([name, head, block])
    summaries[block]["ops_per_s"] = BF16_TENSOR_OPS_PER_S  # bf16 products: the tensor cores
    summary = summaries[name]
    stage_bound_ms = 0.0  # each stage bound by its own resource
    gen = torch.Generator(device=device).manual_seed(19)
    base = (935.0 - 425.0) / 191
    print(f"K8 against its plain version, 1 + {CAS_VIEWS - 1} views at {MAIN_W}x{MAIN_H}; "
          f"{smi}", flush=True)
    for d, c, scale, ratio in CAS_STAGES:
        h, w = MAIN_H // scale, MAIN_W // scale
        f = 1.8 * w
        k = torch.tensor([[f, 0, w / 2.0], [0, f, h / 2.0], [0, 0, 1]], device=device)
        proj = torch.eye(4, device=device).repeat(1, CAS_VIEWS, 1, 1)
        proj[0, 1:, 0, 3] = torch.tensor([60.0, -60.0, 120.0, -120.0], device=device)
        proj[0, 1:, 1, 3] = torch.tensor([30.0, -30.0, -60.0, 60.0], device=device)
        proj[:, :, :3, :4] = k @ proj[:, :, :3, :4]
        mats = warp_proj_coeffs(proj[:, 1:], proj[:, :1])
        slant = 520.0 + 330.0 * torch.arange(w, device=device) / w
        planes = (torch.arange(d, device=device) - (d - 1) / 2) * ratio * base
        depth = (slant.view(1, 1, 1, w) + planes.view(1, d, 1, 1)).expand(1, d, h, w)
        depth = depth.contiguous()
        for payload, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            feats = torch.randn((1, CAS_VIEWS, h, w, c), generator=gen, device=device).to(dtype)
            args = (feats[:, 0].contiguous(), feats[:, 1:].contiguous(), mats, depth)
            with torch.no_grad():
                got = variance_volume(*args)
                want = variance_volume_reference(*args)
            err = (got.float() - want.float()).abs()
            max_abs, mean_abs = err.max().item(), err.mean().item()
            atol, rtol = CAS_TOL[payload]
            outside = int((err > atol + rtol * want.float().abs()).sum())
            label = f"D {d} C {c} at {h}x{w}, {payload}"
            line = (f"{name} {label}: max_abs {max_abs:.3e} mean_abs {mean_abs:.3e} outside "
                    f"{outside}")
            summary["max_abs_err"] = max(summary["max_abs_err"], max_abs)
            if payload == "bf16":
                with torch.no_grad():
                    ms = time_ms(lambda: variance_volume(*args))
                    plain_ms = time_ms(lambda: variance_volume_reference(*args), reps=5,
                                       warmup=1)
                    dev_ms = device_ms(lambda: variance_volume(*args))
                add_time(summary, name, args, got, 1, ms, plain_ms, dev_ms)
                work_ms, by = bound(*kernel_work(name, args, got))
                stage_bound_ms += work_ms
                line += (f" | kernel {ms:.4f} ms device {fmt_ms(dev_ms)} plain {plain_ms:.4f} "
                         f"ms bound {work_ms:.4f} ms ({by})")
            print(line, flush=True)
            if outside:
                fail(f"{name} {label}: {outside} values outside atol {atol} + rtol {rtol}")
            del got, want, err, feats, args
        torch.cuda.empty_cache()
    bound_ms, by = bound(summary["bytes"], summary["ops"])
    print(f"{name} per map (3 stages): device {fmt_ms(summary['device_ms'])} bound "
          f"{stage_bound_ms:.4f} ms stage by stage ({bound_ms:.4f} ms ({by}) over the summed "
          f"work), event {summary['ms']:.4f} ms, plain {summary['plain_ms']:.4f} ms", flush=True)
    head_bound_ms, head_library_ms, head_library_dev = head_stages(
        device, smi, summaries[head], prob_conv3d, prob_conv3d_reference)
    block_bound_ms, block_library_ms, block_library_dev = block_stages(
        device, smi, summaries[block])

    model = build_model(Config(architecture="casmvsnet"), inference=True)
    model.load_state_dict(seeded_state(CAS_SEED), strict=True)
    estimator = DepthEstimator(model, device=device)
    make_synthetic_scene(scratch, num_views=CAS_VIEWS, height=MAIN_H, width=MAIN_W,
                         texture_scale=8.0)
    dataset = MVSDataset(scratch, num_views=CAS_VIEWS - 1, image_extension=".png")
    warm = next(iter(BatchLoader(dataset, batch_size=1, num_threads=1)))
    noise = torch.Generator(device=device).manual_seed(123)
    estimator(warm, noise)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    request_ms = []

    def timed(batch, generator):
        start = time.perf_counter()
        out = estimator(batch, generator)
        request_ms.append((time.perf_counter() - start) * 1e3)
        return out

    timed.device = estimator.device
    out_dir = tempfile.mkdtemp(prefix="out_", dir=scratch)
    cuda_build.reset_launch_counts()
    written = save_depth_maps(timed, BatchLoader(dataset, batch_size=1), out_dir, seed=0)
    counts = cuda_build.launch_counts()
    peak = torch.cuda.max_memory_allocated(device)
    print(f"CasMVSNet bf16, {written} maps: launch counts {counts}; ms per map "
          + " ".join(f"{t:.2f}" for t in request_ms) + f"; peak memory {peak / 2**20:.1f} MiB",
          flush=True)
    if written != CAS_VIEWS or counts != {name: 3 * written, head: 3 * written,
                                          block: 30 * written}:
        fail(f"expected {CAS_VIEWS} maps and only K8 and K9, 3 each a map, and K10, 30 a map: "
             f"{written} maps, {counts}")
    lo, hi = float(warm["depth_min"][0]), float(warm["depth_max"][0])
    for i in range(written):
        depth = read_pfm(os.path.join(out_dir, "depth_est", f"{i:08d}.pfm"))[..., 0]
        if depth.shape != (MAIN_H, MAIN_W) or not np.isfinite(depth).all():
            fail(f"CasMVSNet map {i}: shape {depth.shape}, finite {np.isfinite(depth).all()}")
        if depth.min() < lo - 1e-3 * (hi - lo) or depth.max() > hi + 1e-3 * (hi - lo):
            fail(f"CasMVSNet map {i}: depths {depth.min()}-{depth.max()} outside [{lo}, {hi}]")

    events = whole_trace(lambda: estimator(warm, noise), CAS_TRACED)
    if events is None:
        print(f"{name} on the main path: device ms not measured (no whole trace)", flush=True)
    else:
        k8 = [dur for _, kernel, _, dur in events if "variance_volume_kernel" in kernel]
        busy = sum(dur for _, _, _, dur in events)
        print(f"{name} on the main path: {len(k8) / CAS_TRACED:g} launches a map, device "
              f"{sum(k8) / CAS_TRACED / 1e3:.4f} ms a map of {busy / CAS_TRACED / 1e3:.4f} ms "
              f"of device work, bound {stage_bound_ms:.4f} ms; {smi}", flush=True)
        k9 = [dur for _, kernel, _, dur in events if "prob_conv3d_kernel" in kernel]
        sgemm = [dur for _, kernel, _, dur in events if "implicit_convolveNd_sgemm" in kernel]
        print(f"{head} on the main path: {len(k9) / CAS_TRACED:g} launches a map, device "
              f"{sum(k9) / CAS_TRACED / 1e3:.4f} ms a map, bound {head_bound_ms:.4f} ms; "
              f"implicit_convolveNd_sgemm {len(sgemm)} launches", flush=True)
        k10 = [dur for _, kernel, _, dur in events if "conv3d_block_kernel" in kernel]
        dgrad = [dur for _, kernel, _, dur in events if "dgrad" in kernel]
        print(f"{block} on the main path: {len(k10) / CAS_TRACED:g} launches a map, device "
              f"{sum(k10) / CAS_TRACED / 1e3:.4f} ms a map, bound {block_bound_ms:.4f} ms; "
              f"dgrad kernels {len(dgrad)}", flush=True)
        if (len(k8) != 3 * CAS_TRACED or len(k9) != 3 * CAS_TRACED or sgemm
                or len(k10) != 30 * CAS_TRACED or dgrad):
            fail(f"traced {len(k8)} K8, {len(k9)} K9 and {len(k10)} K10 launches in "
                 f"{CAS_TRACED} requests, expected 3, 3 and 30 each, {len(sgemm)} of cuDNN's "
                 f"generic kernel and {len(dgrad)} dgrad kernels, expected 0")
    f32_model(device, dataset, warm, noise, lo, hi)
    lines = []
    for kernel, library_ms, library_dev in ((name, None, None),
                                            (head, head_library_ms, head_library_dev),
                                            (block, block_library_ms, block_library_dev)):
        s = summaries[kernel]
        src, replaces = KERNEL_INFO[kernel]
        kernel_bound_ms, kernel_by = bound(s["bytes"], s["ops"], s.get("ops_per_s", F32_OPS_PER_S))
        lines.append({
            "name": kernel, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts[kernel], "max_abs_err": s["max_abs_err"], "ms": s["ms"],
            "plain_ms": s["plain_ms"], "bound_ms": kernel_bound_ms, "bound_by": kernel_by,
            "library_ms": library_ms, "library_device_ms": library_dev,
            "timing": KERNEL_TIMING, "device_ms": s["device_ms"]})
    print(json.dumps({"kernels": lines}), flush=True)
    return summaries, counts


def f32_model(device, dataset, warm, noise, lo, hi):
    """Phase 19 (c): the f32 model (TF32 off) with the same seeded state
    through DepthEstimator on CAS_F32_MAPS maps of the scene: K8 and K9 3
    each and K10 30 a map and nothing else, maps finite inside the scene's
    range; a trace of one request: 30 launches of K10's f32 kernel, no
    `dgrad` kernel, and K10's device ms a map."""
    import numpy as np
    import torch

    from patchmatchnet_torch.config import Config, ModelConfig
    from patchmatchnet_torch.data import BatchLoader
    from patchmatchnet_torch.infer import DepthEstimator
    from patchmatchnet_torch.ops import cuda_build
    from patchmatchnet_torch.train.driver import build_model
    from patchmatchnet_torch.utils.trace import whole_trace
    from pmnbench.reference_casmvsnet import seeded_state

    cfg = Config(model=ModelConfig(precision="f32"), architecture="casmvsnet")
    model = build_model(cfg, inference=True)
    model.load_state_dict(seeded_state(CAS_SEED), strict=True)
    estimator = DepthEstimator(model, device=device)
    estimator(warm, noise)
    torch.cuda.synchronize()
    cuda_build.reset_launch_counts()
    request_ms = []
    for i, batch in enumerate(BatchLoader(dataset, batch_size=1)):
        if i == CAS_F32_MAPS:
            break
        start = time.perf_counter()
        depth, _ = estimator(batch, noise)  # numpy, on the host
        request_ms.append((time.perf_counter() - start) * 1e3)
        if not np.isfinite(depth).all() or depth.min() < lo - 1e-3 * (hi - lo) \
                or depth.max() > hi + 1e-3 * (hi - lo):
            fail(f"CasMVSNet f32 map {i}: depths {depth.min()}-{depth.max()} outside "
                 f"[{lo}, {hi}] or not finite")
    counts = cuda_build.launch_counts()
    n = len(request_ms)
    print(f"CasMVSNet f32, {n} maps: launch counts {counts}; ms per map "
          + " ".join(f"{t:.2f}" for t in request_ms), flush=True)
    if counts != {"variance_volume": 3 * n, "prob_conv3d": 3 * n, "conv3d_block": 30 * n}:
        fail(f"CasMVSNet f32: expected K8 and K9 3 each a map and K10 30 a map, got {counts}")
    events = whole_trace(lambda: estimator(warm, noise), 1)
    if events is None:
        print("conv3d_block f32 on the main path: device ms not measured (no whole trace)",
              flush=True)
        return
    k10 = [dur for _, kernel, _, dur in events if "conv3d_block_f32_kernel" in kernel]
    dgrad = [dur for _, kernel, _, dur in events if "dgrad" in kernel]
    busy = sum(dur for _, _, _, dur in events)
    print(f"conv3d_block f32 on the main path: {len(k10)} launches a map, device "
          f"{sum(k10) / 1e3:.4f} ms a map of {busy / 1e3:.4f} ms of device work; dgrad "
          f"kernels {len(dgrad)}", flush=True)
    if len(k10) != 30 or dgrad:
        fail(f"CasMVSNet f32 traced {len(k10)} K10 f32 launches and {len(dgrad)} dgrad "
             f"kernels in one request, expected 30 and 0")


def head_stages(device, smi, summary, prob_conv3d, prob_conv3d_reference):
    """Phase 19 (a'): K9 against `F.conv3d` in f32 (TF32 off) at the stage
    shapes of the cell's CostRegNets' heads, bf16 and f32 payloads, and
    each bf16 stage's event and device ms beside its bound and cuDNN's
    bf16 head (the plain version on the card, the path K9 replaced).
    Returns (bound ms, cuDNN's event ms, cuDNN's device ms) a map."""
    import torch
    import torch.nn.functional as F

    from patchmatchnet_torch.dev.roofline import bound, kernel_work
    from patchmatchnet_torch.utils.trace import device_ms, fmt_ms

    name = "prob_conv3d"
    gen = torch.Generator(device=device).manual_seed(24)
    bound_ms = library_ms = 0.0
    library_dev = 0.0
    print(f"K9 against F.conv3d in f32 at the CostRegNets' head shapes; {smi}", flush=True)
    for d, _, scale, _ in CAS_STAGES:
        h, w = MAIN_H // scale, MAIN_W // scale
        weight = 0.1 * torch.randn((1, 8, 3, 3, 3), generator=gen, device=device)
        for payload, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = torch.randn((1, 8, d, h, w), generator=gen, device=device).to(dtype)
            x = x.to(memory_format=torch.channels_last_3d)
            allow = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
            with torch.no_grad():
                got = prob_conv3d(x, weight)
                want = F.conv3d(x.float(), weight, None, 1, 1)[:, 0]
            torch.backends.cudnn.allow_tf32 = allow
            err = (got - want).abs()
            max_abs = err.max().item()
            atol, rtol = HEAD_TOL
            outside = int((err > atol + rtol * want.abs()).sum())
            label = f"D {d} at {h}x{w}, {payload}"
            line = f"{name} {label}: max_abs {max_abs:.3e} outside {outside}"
            summary["max_abs_err"] = max(summary["max_abs_err"], max_abs)
            if payload == "bf16":
                args = (x, weight)
                with torch.no_grad():
                    ms = time_ms(lambda: prob_conv3d(*args))
                    dev_ms = device_ms(lambda: prob_conv3d(*args))
                    cudnn_ms = time_ms(lambda: prob_conv3d_reference(*args), reps=5, warmup=1)
                    cudnn_dev = device_ms(lambda: prob_conv3d_reference(*args))
                add_time(summary, name, args, got, 1, ms, cudnn_ms, dev_ms)
                work_ms, by = bound(*kernel_work(name, args, got))
                bound_ms += work_ms
                library_ms += cudnn_ms
                library_dev = None if cudnn_dev is None or library_dev is None else (
                    library_dev + cudnn_dev)
                line += (f" | kernel {ms:.4f} ms device {fmt_ms(dev_ms)} bound {work_ms:.4f} "
                         f"ms ({by}) | cuDNN bf16 {cudnn_ms:.4f} ms device {fmt_ms(cudnn_dev)}")
            print(line, flush=True)
            if outside:
                fail(f"{name} {label}: {outside} values outside atol {atol} + rtol {rtol}")
            del got, want, err, x
        torch.cuda.empty_cache()
    print(f"{name} per map (3 stages): device {fmt_ms(summary['device_ms'])} event "
          f"{summary['ms']:.4f} ms, bound {bound_ms:.4f} ms; cuDNN bf16 event {library_ms:.4f} "
          f"ms device {fmt_ms(library_dev)}", flush=True)
    return bound_ms, library_ms, library_dev


def block_stages(device, smi, summary):
    """Phase 19 (a''): K10 at every U-Net block of the cell's three
    CostRegNets, each block fed the one before it (random weights and
    BatchNorm statistics, a random bf16 volume), against its arithmetic in
    f32 (`conv3d_block_unrounded`), and each block's event and device ms beside
    its bound and the bf16 plain version's (cuDNN's convolution and its glue,
    the path K10 replaced), whose device time is split by kernel into the
    convolution's and the glue's. Returns (bound ms, the plain version's event
    ms, its device ms) a map."""
    import torch

    from patchmatchnet_torch.dev.roofline import (
        BF16_TENSOR_OPS_PER_S,
        F32_OPS_PER_S,
        bound,
        kernel_work,
    )
    from patchmatchnet_torch.models.casmvsnet import FEATURE_CHANNELS, CostRegNet
    from patchmatchnet_torch.models.net import full_f32
    from patchmatchnet_torch.ops.conv3d_block import (
        conv3d_block,
        conv3d_block_unrounded,
        conv3d_block_reference,
    )
    from patchmatchnet_torch.utils.trace import (
        CALLS,
        busy_union_us,
        device_ms,
        fmt_ms,
        trace_group,
        whole_trace,
    )

    name, bf16 = "conv3d_block", torch.bfloat16
    gen = torch.Generator(device=device).manual_seed(26)
    bound_ms = library_ms = 0.0
    library_dev = f32_dev = f32_plain = f32_bound = 0.0
    print(f"K10 at the CostRegNets' blocks of {MAIN_W}x{MAIN_H}; {smi}", flush=True)
    for stage, ((d, c, scale, _), channels) in enumerate(zip(CAS_STAGES, FEATURE_CHANNELS), 1):
        assert c == channels
        h, w = MAIN_H // scale, MAIN_W // scale
        net = CostRegNet(c, dtype=bf16).eval().to(device)
        with torch.no_grad():
            for module in net.modules():
                if hasattr(module, "bn"):
                    cout = module.bn.weight.numel()
                    fan_in = module.conv.weight[0].numel()
                    if isinstance(module.conv, torch.nn.ConvTranspose3d):
                        fan_in = module.conv.weight.numel() // (8 * cout)  # taps a parity
                    module.conv.weight.normal_(0.0, (2.0 / fan_in) ** 0.5, generator=gen)
                    module.bn.weight.uniform_(0.5, 1.5, generator=gen)
                    module.bn.bias.normal_(0.0, 0.2, generator=gen)
                    module.bn.running_mean.normal_(0.0, 0.2, generator=gen)
                    module.bn.running_var.uniform_(0.5, 1.5, generator=gen)
        acts = {"x": torch.randn((1, c, d, h, w), generator=gen, device=device).to(bf16)
                .to(memory_format=torch.channels_last_3d)}
        acts32 = {"x": acts["x"].float()}
        for block, src, skip_of in COST_REG_BLOCKS:
            module = getattr(net, block)
            args = (acts[src], module.conv, module.bn, bf16,
                    None if skip_of is None else acts[skip_of])
            with torch.no_grad():
                got = conv3d_block(*args)
                want = conv3d_block_unrounded(args[0], module.conv, module.bn, args[4])
                plain = conv3d_block_reference(*args)
            err = (got.float() - want).abs()
            max_abs = err.max().item()
            gap = (got.float() - plain.float()).abs().max().item()
            atol, rtol = BLOCK_TOL
            outside = int((err > atol + rtol * want.abs()).sum())
            summary["max_abs_err"] = max(summary["max_abs_err"], max_abs)
            with torch.no_grad():
                ms = time_ms(lambda: conv3d_block(*args))
                dev_ms = device_ms(lambda: conv3d_block(*args))
                plain_ms = time_ms(lambda: conv3d_block_reference(*args), reps=10, warmup=2)
                events = whole_trace(lambda: conv3d_block_reference(*args), CALLS)
            add_time(summary, name, args, got, 1, ms, plain_ms, dev_ms)
            work_ms, by = bound(*kernel_work(name, args, got), BF16_TENSOR_OPS_PER_S)
            bound_ms += work_ms
            library_ms += plain_ms
            split = "not measured"
            if events is None:
                library_dev = None
            else:
                plain_dev = busy_union_us((s, s + t) for _, _, s, t in events) / CALLS / 1e3
                library_dev = None if library_dev is None else library_dev + plain_dev
                conv = sum(t for _, k, _, t in events if trace_group(k) == "convolutions")
                kinds = sorted({k.split("(")[0].split("<")[0][-40:] for _, k, _, _ in events})
                split = (f"{plain_dev:.4f} (conv {conv / CALLS / 1e3:.4f}, glue "
                         f"{plain_dev - conv / CALLS / 1e3:.4f}; {len(events) // CALLS} "
                         f"kernels: {', '.join(kinds)})")
            label = (f"stage {stage} {block} "
                     f"{args[1].in_channels}->{args[1].out_channels} "
                     f"{'x'.join(map(str, got.shape[2:]))}")
            print(f"{name} {label}: max_abs {max_abs:.3e} outside {outside} | bf16 plain gap "
                  f"{gap:.3e} | kernel {ms:.4f} ms device {fmt_ms(dev_ms)} bound {work_ms:.4f} "
                  f"ms ({by}) | plain (cuDNN + glue) {plain_ms:.4f} ms device {split}",
                  flush=True)
            if outside:
                fail(f"{name} {label}: {outside} values outside atol {atol} + rtol {rtol}")
            acts[block] = got
            del got, want, plain, err
            # f32 payloads (the f32 model): K10 on the CUDA cores against the
            # plain version in f32, TF32 off
            args32 = (acts32[src], module.conv, module.bn, None,
                      None if skip_of is None else acts32[skip_of])
            with torch.no_grad(), full_f32():
                got = conv3d_block(*args32)
                plain = conv3d_block_reference(*args32)
                dev32 = device_ms(lambda: conv3d_block(*args32))
                plain32 = device_ms(lambda: conv3d_block_reference(*args32))
            err = (got - plain).abs()
            atol, rtol = BLOCK_F32_TOL
            outside = int((err > atol + rtol * plain.abs()).sum())
            f32_dev = None if None in (f32_dev, dev32) else f32_dev + dev32
            f32_plain = None if None in (f32_plain, plain32) else f32_plain + plain32
            work_ms, by = bound(*kernel_work(name, args32, got), F32_OPS_PER_S)
            f32_bound += work_ms
            print(f"{name} f32 {label}: max_abs {err.max().item():.3e} outside {outside} | "
                  f"kernel device {fmt_ms(dev32)} bound {work_ms:.4f} ms ({by}) | plain (cuDNN "
                  f"+ glue, f32) device {fmt_ms(plain32)}", flush=True)
            if outside or got.dtype != torch.float32:
                fail(f"{name} f32 {label}: {outside} values outside atol {atol} + rtol {rtol}, "
                     f"dtype {got.dtype}")
            acts32[block] = got
            del got, plain, err
        del acts, acts32, net
        torch.cuda.empty_cache()
    print(f"{name} per map (30 blocks): device {fmt_ms(summary['device_ms'])} event "
          f"{summary['ms']:.4f} ms, bound {bound_ms:.4f} ms; plain (cuDNN + glue) event "
          f"{library_ms:.4f} ms device {fmt_ms(library_dev)}", flush=True)
    print(f"{name} f32 per map (30 blocks): device {fmt_ms(f32_dev)} bound {f32_bound:.4f} ms; "
          f"plain (cuDNN + glue, f32) device {fmt_ms(f32_plain)}", flush=True)
    return bound_ms, library_ms, library_dev


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "patchmatchnet_torch")):
        fail("run from a checkout of the repository (patchmatchnet_torch/ not found)")
    sys.path.insert(0, REPO)
    import torch

    phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a GPU")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    host = host_cpu()
    print(f"card: {smi}; host: {host}; torch {torch.__version__} cuda {torch.version.cuda}",
          flush=True)

    phase("build")
    from patchmatchnet_torch.ops import cuda_build

    start = time.perf_counter()
    cuda_build.kernel_library()
    built = cuda_build.build_seconds()
    print(f"kernel library {cuda_build.library_path().relative_to(REPO)}: "
          f"{'built in %.1f s' % built if built is not None else 'reused'} "
          f"(load {time.perf_counter() - start:.1f} s)", flush=True)
    log = cuda_build.library_path().parent / "nvcc.log"
    if log.is_file():  # ptxas resource usage per kernel instantiation
        for line in log.read_text().splitlines():
            if any(k in line for k in ("Compiling entry function", "Used", "spill")):
                print("  " + line.split(":", 1)[-1].strip(), flush=True)
    from patchmatchnet_torch import native

    native.get_lib()
    built = native.build_seconds()
    print(f"host library {native.library_path().relative_to(REPO)}: "
          + (f"built by g++ in {built:.2f} s" if built is not None else "reused"), flush=True)

    phase("kernel parity (kernel vs plain version on the card)")
    summary = kernel_parity(device)

    phase("f32 golden parity (kernels on, TF32 off)")
    from patchmatchnet_torch.compat import read_flax_msgpack, state_dict_from_jax
    from patchmatchnet_torch.data import make_synthetic_scene
    from patchmatchnet_torch.models import PatchmatchNet

    state_dict = state_dict_from_jax(read_flax_msgpack(CKPT))
    model_f32 = PatchmatchNet().to(device).eval()
    model_f32.load_state_dict(state_dict, strict=True)
    golden_parity(device, model_f32)
    del model_f32

    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    scene = tempfile.mkdtemp(prefix="smoke_scene_", dir=os.path.join(REPO, "build"))
    try:
        make_synthetic_scene(scene, num_views=MAIN_VIEWS, height=MAIN_H, width=MAIN_W,
                             texture_scale=8.0)
        phase(f"main path: bf16 DepthEstimator, {MAIN_W}x{MAIN_H}, {MAIN_VIEWS} views, "
              f"{REQUESTS} requests")
        counts, estimator = main_path(device, state_dict, scene)

        phase(f"coordinate-input path: plane sweep through coord_group_corr (K7) at "
              f"{MAIN_W}x{MAIN_H}, {MAIN_VIEWS} views")
        counts.update(coordinate_path(device, estimator.model, scene))
        del estimator
    finally:
        shutil.rmtree(scene, ignore_errors=True)

    phase("backward-kernel parity (K4/K5 vs plain versions on the card)")
    summary.update(backward_parity(device))

    phase("f32 train-step parity (card with kernels, TF32 off, vs CPU)")
    train_step_parity(device, state_dict)

    phase(f"training path: bf16, {TRAIN_W}x{TRAIN_H}, {TRAIN_VIEWS} views, "
          f"batch {TRAIN_BATCH}")
    scratch = tempfile.mkdtemp(prefix="smoke_train_", dir=os.path.join(REPO, "build"))
    try:
        train_counts = training_path(device, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    # launches: K1, K2, K3 and K6 from the main path's run (phase 5), K7
    # from the coordinate-input path's (phase 6), the backward kernels from
    # the training driver's run (phase 9), D1-D5 from the gather tool's
    # sections (phase 10)
    counts.update({name: train_counts.get(name, 0) for name in BACKWARD_KERNELS})

    phase("gather microbenchmarks (D1-D5) on the card")
    gather_entries = gather_phase(device)

    phase(f"reconstruction path: {RECON_VIEWS}-view scan at {MAIN_W}x{MAIN_H}, .bin depth "
          f"maps, filter_and_fuse on the card")
    scene = tempfile.mkdtemp(prefix="smoke_recon_", dir=os.path.join(REPO, "build"))
    try:
        reconstruction_path(device, state_dict, scene, smi)
    finally:
        shutil.rmtree(scene, ignore_errors=True)

    phase("CLI path: python -m patchmatchnet_torch eval (DTU preset, 1600x1200, 1 + 5 views), "
          "train (B 8), and train + eval of a non-default configuration")
    scratch = tempfile.mkdtemp(prefix="smoke_cli_", dir=os.path.join(REPO, "build"))
    try:
        cli_path(device, scratch, smi)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase(f"export path: torch.export of the bf16 and f32 models at {MAIN_W}x{MAIN_H}, "
          f"ModuleEstimator beside DepthEstimator, export + eval --input_type module at the "
          "DTU preset, colmap-export + colmap-import")
    scratch = tempfile.mkdtemp(prefix="smoke_export_", dir=os.path.join(REPO, "build"))
    try:
        export_path(device, state_dict, scratch, smi)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase(f"data parallel: {DP_RANKS} gloo ranks sharing the card (train {TRAIN_W}x{TRAIN_H} "
          f"B {DP_BATCH}, eval {MAIN_W}x{MAIN_H}), one NCCL rank, the CLI's --num_devices")
    scratch = tempfile.mkdtemp(prefix="smoke_dp_", dir=os.path.join(REPO, "build"))
    try:
        data_parallel_path(device, scratch, smi)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase("measurement programs: python -m patchmatchnet_torch.bench (DTU, Tanks, train; f32; "
          "--train), kernels at the Tanks shapes, dev.bench_dataset_configs (ETH3D, Tanks), "
          "dev.bf16_accuracy, dev.bf16_scene_check")
    scratch = tempfile.mkdtemp(prefix="smoke_measure_", dir=os.path.join(REPO, "build"))
    try:
        measurement_programs(device, scratch, smi)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase(f"training precision and the remaining CLI paths: dev.bf16_train_compare "
          f"({COMPARE_STEPS} steps, {TRAIN_W}x{TRAIN_H}, 1 + {COMPARE_SOURCES} views, "
          f"B={TRAIN_BATCH}), eval at "
          f"{MANY_SOURCES} sources, train --dataset dtu_legacy")
    scratch = tempfile.mkdtemp(prefix="smoke_precision_", dir=os.path.join(REPO, "build"))
    try:
        precision_and_cli_paths(device, scratch, smi)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase("eval presets: scripts/eval_torch.sh run_eth3d (6048x4032 and a portrait view at "
          "--image_max_dim 2688) and run_tanks (1920x1080), 1 + 6 views a map, with fusion")
    scratch = tempfile.mkdtemp(prefix="smoke_presets_", dir=os.path.join(REPO, "build"))
    try:
        eval_presets_path(device, scratch, smi)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase("host library: patchmatchnet_torch.native against its numpy twins at ETH3D's "
          "6048x4032 and Tanks' 1920x1080, F.interpolate beside it, one ETH3D view by section")
    scratch = tempfile.mkdtemp(prefix="smoke_host_", dir=os.path.join(REPO, "build"))
    try:
        host_library_path(scratch, smi, host)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    phase(f"CasMVSNet: K8, K9 and K10 at the stage shapes of {MAIN_W}x{MAIN_H}, 1 + "
          f"{CAS_VIEWS - 1} views, and the bf16 model through DepthEstimator")
    scratch = tempfile.mkdtemp(prefix="smoke_cas_", dir=os.path.join(REPO, "build"))
    try:
        cas_summary, cas_counts = casmvsnet_path(device, scratch, smi)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    summary.update(cas_summary)
    counts.update(cas_counts)

    from patchmatchnet_torch.dev.roofline import F32_OPS_PER_S, bound

    kernels = []
    for name, (src, replaces) in KERNEL_INFO.items():
        s = summary[name]
        bound_ms, bound_by = bound(s["bytes"], s["ops"], s.get("ops_per_s", F32_OPS_PER_S))
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": counts.get(name, 0), "max_abs_err": s["max_abs_err"],
            "ms": s["ms"], "plain_ms": s["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None, "timing": KERNEL_TIMING,
            "device_ms": s["device_ms"]})
    kernels += gather_entries
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
