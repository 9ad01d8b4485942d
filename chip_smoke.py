#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (`normal_clustering_nerf_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                  # what the acceptance run does
    python3 chip_smoke.py --profile DIR    # also trace 4 steps of each march
                                           # with each field
    python3 chip_smoke.py --only distributed   # the distributed path alone
                                               # (NCCL with two or more cards)
    python3 chip_smoke.py --only cascades      # check_cascades, the cascades
                                               # path and its march times
    python3 chip_smoke.py --only k7k8          # 320 steps, then K7, K8 and
                                               # the refresh graph checked
    python3 chip_smoke.py --only k9            # 32 steps of each bench
                                               # field, then K9 checked
                                               # and timed
    python3 chip_smoke.py --only loss          # 64 steps of each bench
                                               # field, then K10 checked
                                               # at its edges and timed

Phases (any failed check raises, so the script exits non-zero):
  1. build the kernels (`csrc/*.cu`, one nvcc per source, all at once);
  2. build the trainer at the bench configuration
     (`normal_clustering_nerf_torch.bench.bench_config`: synthetic room,
     48 views at 128^2, batch 8192 as 2730 triangles, triplane field in
     bf16, 16 samples per ray with the full stratified tail, grid 128, 24
     sv intervals, the production losses), mark the invisible cells, and
     take one batch of the main path's inputs: rays of the scene, a
     refreshed occupancy grid, the march's samples and the field's outputs
     on them. H1-H4 are held against their plain PyTorch versions on
     those inputs, gradients included; H1 exact also at N - 3 rays (a
     ragged last block), one and none, and on an empty and a full
     bitfield, first-K and with the full tail; H3 and H4 also at sigmas
     scaled up per ray, so that rays terminate early and sigma*delta
     reaches its clip; H3's forward also bit for bit its serial-order
     reference (`composite_serial`), there and at K = 1, 16, 32, 33 and
     64 (and at C = 16) on random rays (N rays, one and none, with and
     without T_start); H4's forward and backward also bit for bit their
     serial-order reference (`distortion_serial`), there and at K = 1,
     16, 32, 33 and 64 on random rows (N rays, one and none);
     H3's backward also at K = 1, 16, 32, 33, 64 and 128 (BWD_KS: lane
     groups, then the long kernel's chunks) on random rays (N rays, one
     and none), its d_raws bit for bit g_rend (x) H3 forward's own ws,
     its d_sigmas bit for bit its serial order (`composite_grad_serial`)
     and exactly 0 on invalid or clipped samples; H12, the triplane's
     position gradient: H2's forward with the Jacobian (J bit for bit
     `encode_jacobian_plain`, the features bit for bit H2's without J)
     and H2's backward with its contraction (dx bit for bit
     `contract_plain` of the plain J, the table gradients within 1e-4 of
     the plain scatter's, no entry -0.0), on the batch, its cuts, the
     one-cell input and points on cell and brick faces and at 0 and 1,
     under f32 and bf16 cotangents (`check_dx`); H2's
     backward also under a bf16 cotangent read as bf16, with no
     entry -0.0; H2's forward with f32 and bf16 rows and f32 and bf16
     output, also on the batch cut to a ragged last tile, to one sample
     and to none, and with every sample in one cell; a model of the
     lines and sectors each warp load of H2's forward touches, worked out
     from the mapping of lanes to loads (not read from hardware counters),
     for a thread a sample (the baseline) and for the kernel's own (a warp
     a table, lane = term). On a random 20% occupancy with solid blocks:
     K1 (the sv march: its training launcher on the batch, its test-round
     launcher on the 65,536 rays of the 4 held-out views, three rounds),
     where rays exceed the 24-interval budget, and both launchers on an
     adversarial set (axis-parallel rays, tied crossings at supervoxel
     edges and corners, t0 at or past t_end, more occupied runs than the
     budget with and without the stratified tail, a supervoxel re-entered
     across an invalid piece; every kind must occur); H9 (the bitfield march over 1024 steps, and
     the two-level march with a 4-block budget, where rays truncate), H11
     (the flat budget, half of it, the one ray with the most samples, an
     all-empty batch, and rows of 13 steps, which H11 reads a byte at a
     time, bit for bit), H10 (three rounds of each mode over
     the held-out rays, three of the first-K mode at K 48 and at K = the
     window, and the full window at the Pallas probe P2's (8192, 1024)
     block, beside P2's own form in torch); H9 (both marches)
     and H10 (both modes) again at scene scale 0.3, where the mip bound is
     not a power of two and the plain versions must divide by it as the
     kernels do (`ops/ray_march.py:_div`); H1, H9 (dense, and flat
     through H11) and H10 (three rounds of each mode) at the scene scales
     past 0.5 of CASCADE_SCALES (2, 2, 3 and 6 cascades, the geometric
     step grid) on random rays inside and outside the box and a random
     occupancy of every cascade, and on adversarial rays (the camera at
     the box's centre, origins past B = hi/f, near ends just past A =
     lo/f, so that an H10 cursor reads the table of powers' step S),
     outputs identical, the share of probes at each mip logged
     (`check_cascades`). Then the training
     steps at the CPU tests' size run on the card and on the CPU from the
     same state and draws (bootstrap, sv, bitfield and flat steps; and a
     bootstrap and a bitfield step at scale 1.0): every loss and gradient
     must agree;
  3. set every launch count to 0, train STEPS (576) steps with
     `Trainer.fit`: 512 bootstrap steps, then 64 sv steps (counted apart);
     an occupancy refresh every 16 steps (every cell before step 256,
     sampled after), the clustering ramp from step 500; the steps between
     two refreshes run as one chunk, on the card replays of a CUDA graph
     of the step (three eager steps of each march, then its capture; a
     replay adds the launches its capture recorded to the counts, as
     `kernels.CountedGraph` does; the flat path's step too). Read
     the counts:
     every training launcher must have launched, K1's training launcher 64
     times, K7 (`kmeans_cluster`, the clustering loss's k-means and
     cluster selection) once a step, K8's `occ_merge_pack` and
     `occ_tables` once a refresh and `occ_compact` once a sampled refresh
     (20; from the second on, replays of the refresh's own CUDA graph),
     K9's `adamw_norm` and `adamw_step` (the optimizer's update) and
     K10's `loss_rays`, `loss_clusters` and `loss_bwd` (the loss block)
     once a step each.
     Every loss must be finite and the loss must fall;
  4. K7 against its plain version bit for bit (assign_new, assign_orig,
     every centroid, centroids3) on one training step's own normals (M
     2730) and on random sets (M = K, 4097, rotation recovery's 65,536 at
     K 30 and 30 rounds, 262,144 with the rows read from global memory,
     all rows invalid, one-ulp near-ties, K 12, 20, 33, 64 and 256,
     merge_clusters and find_opposite off), and K 257 refused; K8's
     launchers bit for bit at G 128 and `OCC_SIZES` with 1, 2 and 3
     cascades (`check_occupancy`: empty, full, random 20% with invisible
     cells, a sigma grid with NaN, every cell invisible, occ_compact's
     edge grids; occ_merge_pack also against a second launch of its own;
     occ_union on 1-4 ranks' bitfields), and on the trained grid with a
     sampled refresh's sigma grid; K10 against its plain version on a
     training step's own loss arguments (`check_loss_block`: the normals,
     K7's assignment and the members bit for bit, the terms within rtol
     1e-5 / atol 1e-7, every gradient within rtol 1e-4 / atol 1e-6; at
     full weights, weights 0, rgb and opacity alone, past norm_can_end,
     an empty cluster, snapping with the member discard, NaN and zero
     normals, patch triangles, random poses, the rays' gradients, 40
     classes, ts_bug_compat, a cotangent of every term, given normals;
     the Function bit for bit its launchers; the base case on the brick
     and tcnn fields too); K1 and H9-H11 against their plain
     versions on the trained occupancy,
     the segment launchers of H3/H4 against their plain versions and bit
     for bit against the dense launchers on the flat batch (and with
     T_start on a flat test round), H3's segment backward on segments of
     every length 0..128 (SEG_BWD_LONGEST; d_sigmas bit for bit
     `composite_grad_serial`), and with max_len at the flat march's cap
     (16, 32, 64; the bound the training step passes) on segments all shorter
     than it (bit for bit at the longest segment's bound on the flat
     batch; d_sigmas bit for bit `composite_grad_serial`, d_raws bit for
     bit g_rend (x) ws), and its segment forward on every length 0..64
     (bit for bit the serial order, with and without T_start), H4's
     segment launchers on every length 0..64 (bit for bit the serial
     order and dense H4), H3's four launchers at C = 17, 46, 48, 49, 99
     and 130 channels (WIDE_C: past the narrow backward's 16; 3 + 3 +
     NYU40's 40 classes; the wide backward's tile of 48 and one past it;
     4 forward sums a lane; past the forward's 128 sums a walk, two
     walks): the dense forward at K = 1, 16, 33, 64 with and
     without T_start and the dense backward at BWD_KS bit for bit
     their serial orders (`composite_serial`, `composite_grad_serial`),
     the segment launchers on every length 0..128 / 0..64, and H3's
     forward with T_start on the first test round's samples;
  5. validation: counts to 0, `Trainer.validate()` on the 4 held-out
     views, counts read: the test-round march, the field and the
     compositing must have launched; every metric finite and rotation
     recovery done. From the counts of phases 3 and 5, each launcher's
     launches in one bench run (512 bootstrap steps, 3488 sv steps, 4
     renders). Then H2's backward on one more training step's own bf16
     cotangent, captured from autograd, with no entry -0.0, and H2's
     forward (checks and modelled warp load counts) on that step's
     positions;
  then the bitfield path (the triplane bench configuration with
  march_coarse False: 576 counted steps, H9 64 times and K1 never, and
  `validate` through bitfield bucket rounds, H10), the flat path
  (march_layout and test_layout "flat": FLAT_STEPS (64) counted steps
  through H9, H11 and the segment launchers, the step captured as a
  "flat" CUDA graph after 3 eager steps and replayed, finite losses, and
  `validate` through flat rounds), and phases 2, 3 and 5 again at the bench
  configuration with the brick field (hash_layout "brick", kernels H5/H6)
  and with the tcnn hash grid ("tcnn", H7/H8): the encode kernels against
  their plain versions on the batch's march samples (forward in f32 and
  bf16; the table gradient under an f32, a bf16-rounded and a bf16
  cotangent, and with every sample inside one cell of level 0; no
  gradient entry -0.0) and on every cell of the grid (the refresh's
  shape), H5 also at the shape of the Pallas probe P4 (the (16, 8192,
  128) table, 262,144 points), H5 and H7 bit for bit, also on the
  ragged, one- and no-sample cuts and the one-cell input, with their
  modelled warp load counts (per load and across each warp's loads), and
  a table 8 bytes off 16-byte alignment refused;
  the step parity at the CPU tests' size; 576 counted steps through
  `Trainer.fit` (H5/H6 or H7/H8, H1, H3, H4 and K1 must launch); the
  table gradient on the cotangent of one more training step, captured
  from autograd with its zero rows, and H5 or H7 on that step's
  positions;
  `validate`;
  then the ext path (extrinsic optimisation: `optimize_ext` and
  `lr_dR_norm_glob`, EXT_OPTIM): the step parity of a bootstrap and an sv
  step with dR / dT / dR_glob for each field (every parameter after each
  step held to the CPU's); the box hits of a batch of its rays with
  direction components exactly 0, their ray gradient finite and their
  values those without a gradient (`check_flat_rays`); the bench
  configuration with EXT_OPTIM through `Trainer.fit` for 576 counted
  steps (H12, the triplane's position gradient, once a step: H2's forward
  with the Jacobian and H2's backward with its contraction, never H2's
  backward without it; K1 64 times), dR and dT moved and within 576
  Adam updates at 1e-6 of their start, dR_glob exactly 0, losses falling,
  `validate`; and 64 ext steps each of the brick (H13: H5 with the
  Jacobian, and its contraction in a launch of its own) and the tcnn
  field (H14: H7 with the Jacobian, and the same contraction body) at the
  bench configuration; phase 2
  holds H12-H14 against
  their plain versions on the batch, its cuts, the one-cell input and
  points on cell and brick faces and at 0 and 1, under f32 and bf16
  cotangents;
  then the 40-class path (`sem40_path`): the bench configuration on the
  synthetic room with its semantics relabelled into 40 classes by a fixed
  function of the pixel (C = 46), 64 counted steps through `Trainer.fit`
  (a CUDA graph captured; H3 forward and backward launched, losses
  finite) and `validate` through test rounds at 46 channels, which must
  give a miou column; then the K64 path (`k64_path`): the bench
  configuration at 64 samples a ray (the rows a rank marches at
  --num_chips 4 under the bench's global budget), H3's backward on a
  bootstrap batch's rows of 64 bit for bit its serial order, then 64
  counted steps through `Trainer.fit` (a CUDA graph captured; H3's
  backward once a step, every launch on rows of 64 samples; the loss
  falling); then the host-sampler path (`host_path`): the
  triplane bench configuration with `host_sampler` (the native
  prefetcher, built with g++ from the port's copy of raybatch.cpp), 576
  counted steps through `Trainer.fit` (K1 64 times, losses falling); then
  the cascades path (`cascades_path`): the bench configuration at scale
  1.0 (2 cascades, exp_step_factor 1/256) on the synthetic room at twice
  its width (walls in cascade 1), 576 counted steps through
  `Trainer.fit` (H1 512 times, H9 64, K1 never; losses falling), H1, H9
  and H10 against their plain versions at the path's shapes with some
  kept samples past cascade 0, `validate` through bitfield window rounds
  (psnr and norm_depth logged, no gate), a "cascades path" JSON line;
  then LPIPS with random weights on one held-out view, card against CPU
  within LPIPS_RTOL, and its time;
  then the preset path: the Hypersim preset's config
  (experiments/hyperparameters.py:hypersim_flags, the literal
  HYPERSIM_ARGV, through `TrainConfig.from_args`: the brick field, the
  all_images_triang_patch sampler, 32 samples per ray, the auto-full sv
  interval budget, the clustering losses, no distortion loss) on a
  Manhattan room traced through Hypersim's standard camera at its own
  1024 x 768, 32 train and 4 held-out views, made into scenes by the
  Hypersim loader's function on arrays (`hypersim_scene`); the
  projective marking on the card against the CPU (density marks equal,
  coverage fractions equal but on cells within EDGE_PX of an image
  edge, counted); the step parity of four samplers (patches, patches
  with random poses and keep_N_tr, same-image patches, all_images
  without depth normals) at the CPU tests' size; 576 counted steps
  through `Trainer.fit` (H1, K1 64 times, H5/H6, H3; H4 never), the
  clustering terms non-zero after step 500; K1 (both launchers) and H3
  (forward and backward) against their plain versions at the path's
  shapes, and H1, H5 and H6 there too (each variant with its bound);
  `validate` on the 4 held-out views (3.1 M rays);
  then the baselines path (`BASELINES`): the step parity of the
  "supervised" and the "regnerf" configuration at the CPU tests' size
  (a bootstrap step at step 0 and an sv step at step 3000; theta_WF after
  each); "supervised" at the bench configuration (depth, GT-normal,
  Manhattan-SDF with theta_WF, snapping with discard_far_members,
  distortion_ts_bug_compat, the 'depth' annealing, pred_norm_nn_norm, the
  exposure tonemapper): 576 counted steps through `Trainer.fit` (H4's
  backward never launches: the distortion fed ts gives no gradient), the
  loss less that term falling, theta_WF finite and moved from 0, H4 at
  ts inputs (bit for bit the serial order; the plain version within 1e-5
  of the products the loss cancels), `validate` (no gate); "regnerf"
  (8190 supervised and 8190 random-pose rays a batch): 576 counted steps,
  reg_depth on after norm_can_start;
  then the CLI path (`normal_clustering_nerf_torch.train_nerf.main`, the
  entry point a user runs, at CLI_ARGV: the Hypersim preset's argv on the
  CLI's synthetic room, 12 train and 12 held-out views at 64 x 64, one
  epoch of 1000 steps, with --save_test_vis, --save_test_preds,
  --save_train_preds and --save_checkpoint): its launches counted (H1 512
  times, K1's training launcher 488, its test-round launcher, H5/H6 and
  H3 launched, H4 never); results.csv's metric/ and param/ columns; each
  held-out view's pred and gt PNG read back (`read_png`, zlib) equal to
  the panels of the run's own arrays; the test and train archives'
  members and markers; the checkpoint; a second `main` from that
  checkpoint with --val_only giving the same metrics (within the spread
  of two `validate` calls on its trainer); a resume (`check_resume`): a
  trainer at the same configuration fits 608 steps (graphs captured),
  saves a checkpoint and fits 32 more; the checkpoint restored into that
  trainer, graphs and all, and into a fresh one: the training state
  equal to the checkpoint's bit for bit, and each of the 32 steps it
  then takes through `fit` (the refresh at step 624 included) held, as
  in 7., against three eager steps from the state it started from, the
  first step also against the uninterrupted run's first step (losses
  and parameters within 2x the eager steps' spread plus 2^-20 of the
  largest value; sampled indices and sample counts equal);
  `--eval_lpips` through `main --val_only` from the checkpoint, with a
  random-weights npz in a temporary directory ($NCNERF_LPIPS_WEIGHTS:
  results.csv holds metric/lpips) and with none (a warning, no column);
  the run's wall time by part and the checkpoint's size as a "CLI path"
  JSON line;
  then the distributed path (`distributed_path`): 2 ranks of the port's
  launcher (`parallel.launch.spawn`) sharing the one card over gloo, the
  bench configuration at 2 x 4096 rays, 48 counted steps through
  `Trainer.fit` (refreshes merged at 0, 16, 32): each rank's bootstrap
  kernels launched and `occ_union` once a merge, the loss falling,
  parameters, moments and occupancy bit-identical across the ranks; one
  step's averaged update against a one-process reference (rank 0 takes
  each rank's half-batch step from the same state and generator state,
  twice, and averages: within 2x the reference's spread + 2^-20 of the
  largest value, the spread of H2's fp32 atomics); a merge's time; with
  more than one card visible, NCCL over all of
  them: 64 counted steps with the all-reduce inside each rank's CUDA
  graph, 16 replays held to eager steps (as in 7.), the replicas again,
  a timed window of 64 steps, a traced chunk (the NCCL kernels' device
  time), the all-reduce alone, a merge's time and on rank 0 a one-card
  run of the same batch: a "multi-chip" JSON line with
  `scaling_efficiency` (`--only distributed` runs this path alone);
  every launcher must have launched on some path;
  then the sampled refresh of the triplane and the cascades path (2
  cascades): run eagerly under torch.cuda.set_sync_debug_mode("error")
  (no synchronizing call), and the trainer's replayed refresh graph equal
  to it bit for bit from the same state and generator state; the host's
  time to queue each and the card's to run it ("sampled refresh" JSON
  line);
  6. K9 against its plain version bit for bit (every parameter and
     moment, the norm, the count) on each bench field's parameters with
     theta_WF, dR, dT and dR_glob beside them, three counts each with the
     clip on and off, with contiguous gradients and with views into one
     flat buffer at odd offsets, and with a NaN gradient (`check_adamw`);
     for each path: step times and one refresh of each form; then the
     device time of each kernel, of its plain version and of its PyTorch
     yardstick (`index_select` of the rows a field's forward reads,
     `index_add_` of its backward's terms; for H5 also at P4's shape, for
     H10 P2's probe at P2's block) by CUDA events (`device_ms`); H2, H6
     and H8 also on the training step's cotangent, and their gradient
     tables' zero fill alone; the fields' forwards also on the sv step's
     positions and at the refresh shape, with the modelled warp load
     counts logged beside the times; H1 also on a full bitfield, H3's
     forward also at the first test round's shape with T_start, H3's
     four launchers at 46 channels (N 8190, K 16; "c46_*" keys), H3's
     backward on the K64 path's rows (N 8190, K 64; "k64_*" keys), the
     launchers of H12-H14 beside themselves without the position
     gradient (the variant NO_DX; the two differences added are the
     position gradient's cost, `dx_cost_ms`), and H1,
     H9 and H10 at the cascades path's shapes, each with its bound
     (logf and powf counted as operations; "cascades_*" keys);
  7. CUDA-graph chunks: for the triplane path's bootstrap and sv march, the
     bitfield path's march, the flat path's step, the brick and tcnn
     fields', the preset and
     the ext path's sv march, the two baselines' sv march (their config's
     norm_can_start, clustering ramp and anneal_steps moved into the
     chunk, after 3 eager steps and a capture at the new step table), the
     40-class path's bootstrap march, the cascades path's bitfield march
     and the host-sampler path's sv march (each replay read the host batch loaded for it, no two the same; its
     eager steps take the replay's batch), 16
     replays of the graph the training phase captured, each against 3
     eager steps from the state and generator state it started from:
     sampled indices and rm / vr / trunc counts equal, losses and
     parameters after within 2x the eager steps' spread (the fp32 atomics
     of H2/H6/H8) plus 2^-20 of the largest value;
     then graph steps against eager steps: host ms/step, the device's busy
     ms/step and launches/step (torch.profiler, over 16 replays or
     TRACED_EAGER eager steps), graph launches/step and
     the idle share (and the host sampler's prefetcher's batches/s), the
     launches of one optimizer update through K9 and through its plain
     version and the step's launches had it been the plain version's; and
     each field's optimizer update (K9, its plain version, torch's fused
     AdamW) against its byte bound; printed as a "graph steps" JSON line.

Prints the kernels' JSON line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}. Exits non-zero without a result
when CUDA is not available.
"""
import argparse
import dataclasses
import json
import logging
import math
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile as torch_profile

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, same sheet
BOOT_STEPS, SV_STEPS = 512, 64
STEPS = BOOT_STEPS + SV_STEPS   # the main path's steps: 0-575
K1_CHUNK = 16384   # rays per plain-version call (its (N, 24, 67) tensors)
K1_STEP_OPS = 30   # f32 operations per enumerated step of the sv march
TEST_ROUNDS = 3    # test rounds per K1 / H10 check, each from the last cursors
STEP_OPS = 26      # f32 operations per probed step of the bitfield march:
                   # t_k (2), three positions (6), three cells (18)
COARSE_K_BLOCKS = 4   # a tight two-level budget, so that rays truncate
P2_RAYS, P2_STEPS = 8192, 1024   # the Pallas probe P2's (rays, steps) block
FLAT_STEPS = 64    # counted steps of the flat path


MUTED = False   # a rank process of the distributed path other than rank 0


def log(msg):
    if not MUTED:
        print(f"[smoke {time.time() - T0:7.1f}s] {msg}", flush=True)


def traced(fn):
    """Run `fn` under torch.profiler; return the profile and its device
    events (kernels, fills, copies: one entry per name), which may be empty:
    the profiler's CUPTI trace can come back without device events."""
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return p, [e for e in p.key_averages()
               if e.device_type == DeviceType.CUDA]


CARD_CLOCK_HZ = 2.0e9   # above the H100's highest SM clock (1.98 GHz)
QUEUED = []   # labels of the device_ms calls not captured in a graph


def device_ms(fn, label, iters=20, warm=3):
    """Time of one call of `fn` on the card in ms, mean over `iters` calls,
    by CUDA events (not torch.profiler, whose trace can come back without
    device events). The call is captured once in a CUDA graph, and the
    graph's `iters` replays are queued behind a sleep kernel, so the card
    runs them back to back and the host's time per launch (argument
    checks, allocation, the ctypes call, longer at these sizes than most
    kernels) is not counted. A call that cannot be captured is queued
    itself, behind a sleep twice as long as the host's time to queue the
    calls, and its `label` is added to QUEUED: a call that launches more
    kernels than the launch queue holds can then still show its host
    time."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(warm):
        fn()
    host_s = (time.perf_counter() - t) / warm
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            fn()
    except RuntimeError:
        graph = None
    torch.cuda.synchronize()
    if graph is not None:
        call, sleep_s = graph.replay, 5e-3
        graph.replay()   # the first replay uploads the graph
    else:
        QUEUED.append(label)
        call, sleep_s = fn, min(2.0, 2 * host_s * iters + 1e-3)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int(sleep_s * CARD_CLOCK_HZ))
    start.record()
    for _ in range(iters):
        call()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def bound(n_bytes, n_flops):
    """Least time (ms) for the work: bytes over the memory rate or f32
    operations over the f32 rate, whichever is larger."""
    t_b, t_f = n_bytes / H100_BYTES_PER_S, n_flops / H100_F32_FLOPS
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


class Check:
    """Collects the comparisons of one phase; `done` raises on any failure."""

    def __init__(self):
        self.failures = []

    def close(self, name, got, ref, rtol_of_max):
        """|got - ref| <= rtol_of_max * max|ref| (exact when 0)."""
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max().item() if ref.numel() else 0.0
        tol = rtol_of_max * ref.abs().max().item() if ref.numel() else 0.0
        ok = err <= tol and bool(torch.isfinite(got).all())
        log(f"  {name}: max_abs_err {err:.3e} (tol {tol:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)
        return err

    def within(self, name, got, ref, tol):
        """|got - ref| <= tol elementwise (`tol` a tensor of ref's
        shape)."""
        got, ref = got.float(), ref.float()
        d = (got - ref).abs()
        err = d.max().item() if ref.numel() else 0.0
        ok = bool((d <= tol).all()) and bool(torch.isfinite(got).all())
        log(f"  {name}: max_abs_err {err:.3e} (largest tolerance "
            f"{tol.max().item() if tol.numel() else 0.0:.3e}) "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)
        return err

    def equal(self, name, got, ref, quiet=False):
        """got == ref everywhere; returns max |got - ref|. `quiet`: no
        line of its own (the caller logs one for several)."""
        bad = int((got != ref).sum())
        if not quiet:
            log(f"  {name}: {bad} of {ref.numel()} differ {'ok' if not bad else 'FAIL'}")
        if bad:
            self.failures.append(name)
        return 0.0 if not bad else float((got.float() - ref.float()).abs().max())

    def bf16_flips(self, name, got, ref, got_f32, rtol_of_max):
        """A bf16 output `got` against the plain f32 sum `ref`: it must be
        the kernel's own f32 sum `got_f32` rounded once, so it equals `ref`
        rounded to bf16 but for flips where the two f32 sums differ. A flip
        must stay within one bf16 ulp (2^-7 of the larger value) plus the
        f32 sums' tolerance (`rtol_of_max` of the largest |ref|), which
        covers a sum near 0 whose sign the summation order decides.
        Counted: the flips, and those between adjacent bf16 values.
        Returns the largest error."""
        want = ref.to(torch.bfloat16)
        gf, wf = got.float(), want.float()
        diff = got != want
        tol = rtol_of_max * ref.abs().max().item() if ref.numel() else 0.0
        lim = 2.0 ** -7 * torch.maximum(gf.abs(), wf.abs()) + tol
        bits = [torch.where(t == 0, 0, t.view(torch.int16).int())
                for t in (got, want)]
        adjacent = int((diff & ((bits[0] - bits[1]).abs() == 1)).sum())
        bad = int((got != got_f32.to(torch.bfloat16)).sum()
                  + (diff & ((got_f32 == ref) | ((gf - wf).abs() > lim)))
                  .sum())
        ok = not bad and bool(torch.isfinite(gf).all())
        err = (gf - wf).abs().max().item() if got.numel() else 0.0
        log(f"  {name}: {int(diff.sum())} of {ref.numel()} flips where the "
            f"f32 sums differ ({adjacent} between adjacent bf16 values), "
            f"{bad} other differences, max_abs_err {err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(name)
        return err

    def refused(self, name, fn):
        """`fn` must raise ValueError (a wrapper's check, before launch)."""
        try:
            fn()
            ok = False
        except ValueError:
            ok = True
        log(f"  {name}: {'refused ok' if ok else 'not refused FAIL'}")
        if not ok:
            self.failures.append(name)

    def no_negative_zero(self, name, t):
        """A table gradient starts at +0.0 and only adds: no entry may be
        -0.0."""
        bad = int((torch.signbit(t) & (t == 0)).sum())
        log(f"  {name}: {bad} entries -0.0 {'ok' if not bad else 'FAIL'}")
        if bad:
            self.failures.append(f"{name} -0.0")

    def done(self, phase):
        if self.failures:
            raise RuntimeError(f"{phase}: checks failed: {self.failures}")


# the CPU parity tests' cut of each field (tests/test_torch_model.py,
# tests/test_torch_slice_layouts.py): 2^8 bricks or 2^12 rows a level, 64
# vertices at the finest level
SMALL_FIELD = {"triplane": dict(plane_res=32, grid3d_res=16),
               "brick": dict(log2_bricks=8, finest_resolution=128),
               "tcnn": dict(log2_hashmap_size=12, finest_resolution=128)}


def small_config(layout="triplane"):
    """The bench configuration at the size of the CPU parity tests
    (tests/test_torch_common.py:slice_configs): f32 compute, the field
    cut as `SMALL_FIELD[layout]`, grid 32, batch 96 at 16 samples per
    ray."""
    from normal_clustering_nerf_torch.bench import bench_config
    cfg = bench_config(hash_layout=layout)
    batch = 96
    return cfg.replace(
        model=dataclasses.replace(cfg.model, grid_size=32,
                                  compute_dtype="float32",
                                  **SMALL_FIELD[layout]),
        render=dataclasses.replace(cfg.render, sample_budget=batch * 16),
        data=dataclasses.replace(cfg.data, batch_size=batch))


# the paper's baselines on a configuration (the bench's, or small_config):
# the field's and the loss's fields each replaces. No preset publishes
# their weights: the new terms take the clustering terms' 2e-3, depth_w
# the JAX end-to-end test's 0.05 (tests/test_train_e2e.py:67). "supervised"
# switches on every supervised term and option at once (depth-supervised
# and normal-supervised NGP, Manhattan-SDF, the clustering variants);
# "regnerf" adds the random-pose rays and RegNeRF's depth smoothness to
# the bench's clustering terms
BASELINES = {
    "supervised": dict(
        model=dict(pred_norm_nn_norm=True, use_exposure=True),
        render=dict(anneal_strategy="depth", anneal_steps=600),
        loss=dict(depth_w=0.05, norm_depth_L1_w=2e-3, norm_depth_dot_w=2e-3,
                  manhattan_nerf_w=2e-3, norm_D_C_can_dot_w=2e-3,
                  norm_D_C_can_L1_w=2e-3, discard_far_members=True,
                  distortion_ts_bug_compat=True)),
    "regnerf": dict(data=dict(random_tr_poses=True),
                    loss=dict(reg_depth_w=1e-2)),
}


def baseline_config(name, cfg):
    """`cfg` with the fields of BASELINES[name] replaced."""
    return cfg.replace(**{sub: dataclasses.replace(getattr(cfg, sub), **kw)
                          for sub, kw in BASELINES[name].items()})


def small_baseline_config(name):
    """BASELINES[name] at the CPU tests' size (`small_config`). With
    random poses the 96 rays are 48 + 48, whose 16 random-pose triangles
    the k-means draws its init from without replacement: 12 clusters."""
    cfg = baseline_config(name, small_config())
    if cfg.data.random_tr_poses:
        cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, cluster_K=12))
    return cfg


# experiments/hyperparameters.py:hypersim_flags() (the Hypersim preset,
# "ours"); tests/test_torch_config.py holds this literal equal to it
HYPERSIM_ARGV = (
    "--no_debug", "--split=train", "--split_factor=0.5", "--keep_N_tr=-1",
    "--model_name=NGPMT", "--scale=0.5", "--grid_size=128",
    "--density_tresh_decay=1.0", "--rend_max_samples=1024",
    "--rend_near_dist=0.01", "--loss_opacity_w=1e-3",
    "--loss_distortion_w=0", "--lr=1e-2", "--num_epochs=30",
    "--batch_size=8192", "--triang_max_expand=0", "--anneal_strategy=none",
    "--anneal_steps=0", "--dataset_name=hypersim", "--downsample=1.0",
    "--load_depth_gt", "--load_norm_gt",
    "--ray_sampling_strategy=all_images_triang_patch", "--pred_norm_depth",
    "--loss_norm_D_C_ort_dot_w=2e-3", "--loss_norm_D_C_centr_dot_w=2e-3",
    "--loss_norm_D_C_centr_L1_w=2e-3", "--loss_norm_can_tres=0.01",
    "--loss_norm_can_start=500", "--loss_norm_can_end=-1",
    "--loss_norm_can_grow=2500")
PRESET_WH = (1024, 768)            # Hypersim's W_ORIG x H_ORIG
PRESET_TRAIN, PRESET_TEST = 32, 4  # views of the preset path's room
ROOM_R = 2.0                       # the room's half-width, asset units


def preset_config():
    """The port's config from the Hypersim preset's argv (`from_args`)."""
    from normal_clustering_nerf_torch.config import TrainConfig
    return TrainConfig.from_args(list(HYPERSIM_ARGV))


def small_preset_config(**data):
    """The preset configuration at the CPU tests' size: the brick field
    cut as SMALL_FIELD["brick"], grid 32, batch 256 (4 patches of 8 x 8) at
    16 samples per ray, a 16-step bootstrap; `data` replaces fields of its
    DataConfig."""
    cfg = preset_config()
    batch = data.pop("batch_size", 256)
    return cfg.replace(
        model=dataclasses.replace(cfg.model, grid_size=32,
                                  **SMALL_FIELD["brick"]),
        render=dataclasses.replace(cfg.render, sample_budget=batch * 16,
                                   bootstrap_steps=16),
        data=dataclasses.replace(cfg.data, batch_size=batch, **data))


def hypersim_room(wh, n_views, seed=7):
    """A Manhattan room [-ROOM_R, ROOM_R]^3 traced through Hypersim's
    standard camera (60-degree hfov, -z forward, v flipped, distance
    depth) from `n_views` poses inside it, as tests/test_hypersim_e2e.py
    writes its files. Returns the arrays a Hypersim split holds once its
    files are read: images (n, H, W, 3), c2w poses (n, 3, 4) in asset
    units, labels {"depth" (n, H, W) in meters (1 a unit), "normals" (n,
    H, W, 3) world}, and the camera."""
    import numpy as np
    from normal_clustering_nerf_torch.datasets.hypersim import (
        HypersimCamModel, standard_cam_matrices)
    from normal_clustering_nerf_torch.datasets.synthetic import (
        _lookat_pose, _trace_room)
    W, H = wh
    cam = HypersimCamModel(H, W, *standard_cam_matrices(W, H), 1.0)
    rng = np.random.default_rng(seed)
    imgs, poses, depth, normals = [], [], [], []
    for i in range(n_views):
        pos = rng.uniform(-0.5, 0.5, 3).astype(np.float32)
        ang = 2 * np.pi * i / n_views + rng.uniform(0, 0.3)
        target = np.array([np.cos(ang), 0.2 * np.sin(2 * ang), np.sin(ang)],
                          np.float32) * ROOM_R
        # _lookat_pose's columns are [right, up, forward]; the Hypersim
        # camera looks down -z: R = [right, -up, -forward]
        p = _lookat_pose(pos, target, np.array([0.0, -1.0, 0.0]))
        R = np.stack([p[:, 0], -p[:, 1], -p[:, 2]], axis=1)
        rd = cam.ray_dirs_cc @ R.T
        rgb, d, nrm, _ = _trace_room(np.broadcast_to(pos, rd.shape), rd,
                                     ROOM_R)
        imgs.append(rgb.reshape(H, W, 3))
        poses.append(np.concatenate([R, pos[:, None]], 1))
        depth.append(d.reshape(H, W))
        normals.append(nrm.reshape(H, W, 3))
    labels = {"depth": np.stack(depth), "normals": np.stack(normals)}
    return np.stack(imgs), np.stack(poses).astype(np.float32), labels, cam


def hypersim_split(wh, n_train, n_test, seed=7):
    """(train, test) SceneData of `hypersim_room`, made by the Hypersim
    loader's function on arrays (`hypersim_scene`) over all views at once,
    so that both splits share its bounds, then split: every
    (n_train + n_test) // n_test-th view is held out."""
    import numpy as np
    from normal_clustering_nerf_torch.datasets.hypersim import hypersim_scene
    n = n_train + n_test
    imgs, poses, labels, cam = hypersim_room(wh, n, seed)
    scene = hypersim_scene(imgs, poses, labels, cam,
                           img_ids=[f"cam_00.{i:04d}" for i in range(n)])
    held = np.arange(n) % (n // n_test) == n // n_test - 1
    return tuple(dataclasses.replace(
        scene, poses=scene.poses[idx], rays=scene.rays[idx],
        labels={k: v[idx] for k, v in scene.labels.items()},
        img_ids=[scene.img_ids[i] for i in idx])
        for idx in (np.flatnonzero(~held), np.flatnonzero(held)))


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    return tree.cuda() if isinstance(tree, torch.Tensor) else tree


# the steps of the step parity: (name, bootstrap flag, render config
# changes); the brick and tcnn paths take the first two
PARITY_STEPS = (("bootstrap", True, {}), ("sv", False, {}),
                ("fine", False, dict(march_coarse=False)),
                ("flat", False, dict(march_layout="flat")))


# extrinsic optimisation, as the ext path trains it: dR / dT (H12-H14 on
# the positions' gradient) and dR_glob, which nothing reads
EXT_OPTIM = dict(optimize_ext=True, lr_dR_norm_glob=1e-4)
EXT_LAYOUT_STEPS = 64   # ext steps of the brick and the tcnn field


def ext_config(cfg):
    return cfg.replace(optim=dataclasses.replace(cfg.optim, **EXT_OPTIM))


def adam_step_bound(lr, b1=0.9, b2=0.999):
    """The most one Adam update moves a value: lr |mu_hat| / sqrt(nu_hat)
    <= lr (1 - b1) / sqrt((1 - b2) (1 - b1^2 / b2)), 7.27 lr, by
    Cauchy-Schwarz over the moments' sums (the bias corrections' ratio
    sqrt(1 - b2^t) / (1 - b1^t) is at most 1 for t >= 1, and eps only
    lowers it), whatever the gradients and the clip."""
    return lr * (1 - b1) / math.sqrt((1 - b2) * (1 - b1 * b1 / b2))


def param_tolerance(g, lr):
    """A parameter after one step on the card against the CPU's, where the
    gradients agree to 1e-3 of the largest: 1e-2 of the step's lr, and 2 lr
    where the CPU's gradient is within that tolerance of 0 (a first Adam
    step is g / (|g| + eps), whose sign such a gradient does not fix)."""
    tiny = g.abs() <= 1e-3 * g.abs().max()
    return torch.where(tiny, 2.0 * lr, 1e-2 * lr)


# a scene past scale 0.5: 2 cascades and the geometric step
# grid; the synthetic room at twice its width, its walls (|x| 0.8) in
# cascade 1
CASCADES_SCALE = 1.0
CASCADES_ROOM = dict(room_half=0.8, scale=CASCADES_SCALE)
# its step parity: the bootstrap march, then the bitfield march (no sv
# march past one cascade)
CASCADE_STEPS = (("bootstrap", True, {}), ("fine", False, {}))


def cascades_config(cfg):
    return cfg.replace(model=dataclasses.replace(cfg.model,
                                                 scale=CASCADES_SCALE))


def step_parity(layout="triplane", seed=11, ext=False, cascades=False):
    """Training steps at `small_config(layout)`, each on the card through
    the kernels and on the CPU through the plain versions, from the same
    parameters, optimizer state, occupancy and draws (made with numpy from
    `seed`): a bootstrap step, then, after a refresh that rebuilds the sv
    tables and the coarse mask, a supervoxel-run step and (triplane) a
    step of the bitfield march without the sv march and a flat-layout
    step. With `ext` (EXT_OPTIM: the position-gradient kernels H12-H14),
    the bootstrap and the sv step, and every parameter after each (dR, dT
    and dR_glob, which stays 0, among them) held to the CPU's
    (`param_tolerance`). With `cascades`, the triplane at CASCADES_SCALE
    on the CASCADES_ROOM scene: a bootstrap and a bitfield march step
    (CASCADE_STEPS). The CPU path is the one the tests hold against the
    JAX package."""
    import numpy as np
    from normal_clustering_nerf_torch.datasets.synthetic import (
        SyntheticDataset)
    from normal_clustering_nerf_torch.models.occupancy import OccupancyState
    from normal_clustering_nerf_torch.training import Trainer
    from normal_clustering_nerf_torch.training.state import constant_lr

    cfg = small_config(layout)
    if ext:
        cfg = ext_config(cfg)
    if cascades:
        cfg = cascades_config(cfg)
    scene = SyntheticDataset(split="train", img_wh=(24, 24), n_images=6,
                             **(CASCADES_ROOM if cascades else {})).load()
    cpu = Trainer(cfg, scene, device="cpu")
    cpu.mark_invisible_cells()
    cpu.occ_update(warmup=True)
    card = Trainer(cfg, scene, device="cuda")
    rng = np.random.default_rng(seed)
    n_tri = cfg.data.batch_size // 3
    chk = Check()
    steps = (CASCADE_STEPS if cascades else PARITY_STEPS
             if layout == "triplane" and not ext else PARITY_STEPS[:2])
    tag = (f"{layout}{', ext' if ext else ''}"
           f"{f', scale {CASCADES_SCALE}' if cascades else ''}")
    for name, boot, render in steps:
        for t in (cpu, card):
            t.cfg = cfg.replace(render=dataclasses.replace(cfg.render,
                                                           **render))
        card.load_state({n: p.detach().cuda() for n, p in cpu.params.items()},
                        OccupancyState(*(t.cuda() for t in cpu.occ)),
                        _to_card(cpu.opt.state), cpu.step)
        draws = {"batch": {"img": rng.integers(0, scene.n_images, n_tri),
                           "tri": rng.integers(0, len(cpu.sampler.triang.x1),
                                               n_tri)},
                 "noise": rng.random(3 * n_tri, dtype=np.float32),
                 "bg": rng.random(3, dtype=np.float32),
                 "kmeans_init": rng.choice(n_tri, cfg.loss.cluster_K,
                                           replace=False)}
        ref = cpu.train_step_core(bootstrap=boot, draws=draws)
        got = {k: v.cpu() for k, v in
               card.train_step_core(bootstrap=boot, draws=draws).items()}
        log(f"step parity, {tag}, {name} step "
            f"at grid {cfg.model.grid_size}, batch {cfg.data.batch_size}, "
            f"f32: the card against the CPU (rm/ray "
            f"{float(ref['rm_samples_per_ray']):.3f}, trunc "
            f"{float(ref['trunc_ray_frac']):.4f})")
        # the same tolerances as tests/test_torch_slice.py: sums in another
        # order (cuBLAS, the H2 atomics) through three MLP layers
        for k in sorted(ref):
            if k.startswith("loss_"):
                chk.close(k, got[k], ref[k], 1e-4)
        # the counters, compared as counts of the batch's rays: the card
        # divides a count by the ray count as a product with its
        # reciprocal, which can round the ratio one ulp off the CPU's
        n_rays = card.sampler.batch_size
        for k in ("rm_samples_per_ray", "vr_samples_per_ray",
                  "trunc_ray_frac"):
            chk.equal(k, torch.round(got[k] * n_rays),
                      torch.round(ref[k] * n_rays))
        for n, g in cpu.last_grads.items():
            chk.close(f"d {n}", card.last_grads[n].cpu(), g, 1e-3)
        if ext:
            for n, p in cpu.params.items():
                lr = constant_lr(n, cfg.optim) or cfg.optim.lr
                chk.within(f"{n} after the step", card.params[n].detach()
                           .cpu(), p.detach(),
                           param_tolerance(cpu.last_grads[n], lr))
            chk.equal("dR_glob after the step",
                      card.params["dR_glob"].detach().cpu(),
                      torch.zeros(3))
        if boot:   # the refresh that builds the sv tables and coarse mask
            cpu.occ_update(warmup=True)
            if not cascades and not int(cpu.occ.sv_mask.sum()):
                raise RuntimeError("step parity: the refresh left no "
                                   "occupied supervoxel")
    chk.done(f"step parity, {tag}")


def main_path_inputs(tr, gen):
    """One batch of the inputs the main path hands each kernel: the rays
    of a sampled batch, their march intervals, a refreshed occupancy
    bitfield (warmup form, drawn from `gen`, not stored in the trainer),
    the bootstrap march's samples and the field's outputs on them."""
    from normal_clustering_nerf_torch.datasets.ray_utils import get_rays
    from normal_clustering_nerf_torch.models.rendering import (
        field_raws, train_intervals, train_march_args)
    from normal_clustering_nerf_torch.ops.packbits import unpack_bits
    from normal_clustering_nerf_torch.ops.ray_march import (
        march_rays_train_dense_plain)
    cfg, dev = tr.cfg, tr.device
    occ = tr.occ_grid.update(tr.occ, tr.model.density,
                             tr.density_threshold(), True, generator=gen)
    batch = tr.sampler.sample(gen)
    rays_o, rays_d = get_rays(tr.scene["directions"][batch["pix_idxs"]],
                              tr.scene["poses"][batch["img_idxs"]])
    rays_o, rays_d = rays_o.contiguous(), rays_d.contiguous()
    N = rays_o.shape[0]
    march = dict(
        args=(rays_o, rays_d, train_intervals(cfg.model, cfg.render, rays_o,
                                              rays_d),
              occ.density_bitfield,
              torch.rand(N, generator=gen, device=dev)),
        kw=train_march_args(cfg.model, cfg.render, N, "bootstrap"))
    mr = march_rays_train_dense_plain(*march["args"], **march["kw"])
    K = mr.t.shape[1]
    xyz = (rays_o[:, None, :] + mr.t[..., None] * rays_d[:, None, :])
    xyz = xyz.reshape(N * K, 3)
    dirs = rays_d[:, None, :].expand(N, K, 3).reshape(N * K, 3)
    with torch.no_grad():
        sigmas, raws = field_raws(tr.model, xyz, dirs)
    s = cfg.model.scale
    return dict(march=march, mr=mr, N=N, K=K,
                x=((xyz + s) / (2.0 * s)).contiguous(),
                sigmas=sigmas.reshape(N, K).contiguous(),
                raws=raws.reshape(N, K, -1).contiguous(),
                occupied=int(unpack_bits(occ.density_bitfield).sum()))


def touched_table_bytes(x, spec):
    """Bytes of the triplane tables that this batch's samples need: the
    distinct (row, lane) values its bilinear / trilinear folds read."""
    from normal_clustering_nerf_torch.models.triplane import (
        PLANES, _lanes, grid_corners, plane_corners)
    n = 0
    for a, b in PLANES:
        row, slots, _ = plane_corners(x[:, (a, b)], spec)
        n += torch.unique(_lanes(row, slots, spec.plane_feats, 128, 16)).numel()
    row, slots, _ = grid_corners(x, spec)
    n += torch.unique(_lanes(row, slots, spec.grid3d_feats,
                             64 * spec.grid3d_feats, 64)).numel()
    return 4 * n


def triplane_terms(x, g, spec):
    """For the H2 yardsticks: the 128-value rows the encode of `x` reads
    (3 plane rows and the 2 halves of a grid3d row a sample) as rows of
    the planes' and grid3d's rows stacked (grid3d's as 2 rows of 128
    each), and the backward's 128 terms a sample, g[f] * w, with their
    indices in a flat table of both (grid3d after the planes)."""
    from normal_clustering_nerf_torch.models.triplane import (
        PLANES, _lanes, grid_corners, plane_corners)
    Fp, Fg = spec.plane_feats, spec.grid3d_feats
    n_plane = spec.nb2 ** 2
    rows, lanes, upd = [], [], []
    for pi, (a, b) in enumerate(PLANES):
        row, slots, w = plane_corners(x[:, (a, b)], spec)
        rows.append(pi * n_plane + row)
        lanes.append(pi * n_plane * 128 + _lanes(row, slots, Fp, 128, 16))
        upd.append(g[:, pi * Fp:(pi + 1) * Fp, None] * w[:, None, :])
    row, slots, w = grid_corners(x, spec)
    rows += [3 * n_plane + 2 * row, 3 * n_plane + 2 * row + 1]
    lanes.append(3 * n_plane * 128 + _lanes(row, slots, Fg, 64 * Fg, 64))
    upd.append(g[:, 3 * Fp:, None] * w[:, None, :])
    return (torch.cat(rows), torch.cat([t.reshape(-1) for t in lanes]),
            torch.cat([t.reshape(-1) for t in upd]))


# ---------------------------------------------------------------- step 1
# What a warp load instruction costs the L1: one tag lookup for each
# distinct 128-byte line its active lanes touch, and one request for each
# distinct 32-byte sector. The counts below are a model, not a reading of
# hardware counters: they restate in torch each forward encode's mapping
# of lanes to table loads (only the gathers are counted) and apply it to
# the real inputs. "thread" is the baseline mapping, a thread a sample
# (H2) or a (sample, level) (H5, H7), as those kernels were first written;
# "tile" is the kernels' own, and must be changed together with
# `csrc/triplane.cu`, `csrc/brick_hash.cu` and `csrc/hash_grid.cu`, which
# nothing here checks. For H5 and H7 the sectors are also counted across
# each warp's 8 loads (a sector that several of a warp's loads touch
# counted once, as if the L1 served the repeats). On the H100 the
# forwards' times followed the sectors, not the lines (PERF.md, section
# 6).
LINE, SECTOR = 128, 32
GRID_BASE = 1 << 40   # grid3d's byte addresses, apart from the planes'


def distinct_per_instruction(addr, active, chunk=1 << 18):
    """addr, active: (n, 32) byte addresses and masks of the lanes of n warp
    load instructions. Returns (lines, sectors): the distinct 128-byte lines
    and 32-byte sectors of each instruction's active lanes, summed."""
    n = {LINE: 0, SECTOR: 0}
    for i in range(0, addr.shape[0], chunk):
        a, m = addr[i:i + chunk], active[i:i + chunk]
        for unit in n:
            s = torch.sort(torch.where(m, a // unit, -1), dim=1).values
            n[unit] += int((s[:, 0] >= 0).sum()
                           + ((s[:, 1:] != s[:, :-1]) & (s[:, 1:] >= 0))
                           .sum())
    return n[LINE], n[SECTOR]


def distinct_per_warp(addr, active, loads=8):
    """As `distinct_per_instruction`, over each run of `loads` consecutive
    instructions (one warp's) taken together."""
    return distinct_per_instruction(addr.reshape(-1, loads * 32),
                                    active.reshape(-1, loads * 32))


def lanes_of(rows_per_sample, tile=32):
    """(M, ...) -> (ceil(M/32), 32, ...) with the padding lanes inactive:
    32 consecutive samples, one a lane."""
    M = rows_per_sample.shape[0]
    pad = -M % tile
    a = torch.cat([rows_per_sample, rows_per_sample[:pad].new_zeros(
        (pad,) + rows_per_sample.shape[1:])])
    act = torch.arange(M + pad, device=a.device) < M
    return (a.reshape(-1, tile, *a.shape[1:]),
            act.reshape(-1, tile))


def hash_grid_rows(x, spec):
    """(M, L, 8) absolute table rows of the 8 corners of every level."""
    from normal_clustering_nerf_torch.models.hash_encoding import (
        level_corners)
    return torch.stack([level_corners(x, spec, l)[0]
                        for l in range(spec.n_levels)], 1)


def brick_slots(x, spec):
    """(M, L, 8) float2 slots of the 8 corners of every level, counted in
    the whole (L, n_bricks, 64) table of float2 slots."""
    from normal_clustering_nerf_torch.models.brick_hash import level_geometry
    out = []
    for l in range(spec.n_levels):
        row, slots, _ = level_geometry(x, spec, l)
        out.append((l * spec.n_bricks + row)[:, None] * 64 + slots)
    return torch.stack(out, 1)


def hash_grid_warp_loads(rows, dense, mapping):
    """The table loads of H7 (rows: (M, L, 8) float2 rows), or of H5
    (rows: `brick_slots`, every level "dense": its corner pairs (2k, 2k +
    1) are a slot's z neighbours), as (addr, active) of (n, 32) lanes, 8
    instructions a warp in turn. "thread": a thread a (sample, level), i =
    m*L + l, 8 float2 loads; "tile": a warp a (tile of 32 samples, level),
    lane = sample; for each of the 4 corner pairs (z neighbours at a dense
    level, x neighbours at a hashed one) the float4 of the first row's
    aligned pair, then a float2 of the second row in the lanes where it
    lies elsewhere."""
    M, L, _ = rows.shape
    if mapping == "thread":
        a, act = lanes_of(rows.reshape(M * L, 8) * 8)      # (W, 32, 8)
        return (a.permute(0, 2, 1).reshape(-1, 32),
                act[:, None, :].expand(-1, 8, -1).reshape(-1, 32))
    a, act = lanes_of(rows)                                  # (T, 32, L, 8)
    addr, acts = [], []
    for l in range(L):
        S = 1 if dense[l] else 4
        for k in range(4):
            ca = 2 * k if S == 1 else k
            ra, rb = a[:, :, l, ca], a[:, :, l, ca ^ S]
            addr += [(ra >> 1) * 16, rb * 8]
            acts += [act, act & ((ra >> 1) != (rb >> 1))]
    return torch.stack(addr, 1).reshape(-1, 32), torch.stack(acts, 1).reshape(
        -1, 32)


def triplane_lanes(x, spec):
    """(M, 4, 32) flat value offsets H2 reads for each (sample, table), in
    the forward's lane order (feature, corner); grid3d's from GRID_BASE."""
    from normal_clustering_nerf_torch.models.triplane import (
        PLANES, _lanes, grid_corners, plane_corners)
    out = []
    for pi, (a, b) in enumerate(PLANES):
        row, slots, _ = plane_corners(torch.stack((x[:, a], x[:, b]), 1),
                                      spec)
        out.append(_lanes(pi * spec.nb2 ** 2 + row, slots, spec.plane_feats,
                          128, 16).reshape(-1, 32))
    row, slots, _ = grid_corners(x, spec)
    out.append(GRID_BASE // 4 + _lanes(row, slots, spec.grid3d_feats,
                                       64 * spec.grid3d_feats, 64)
               .reshape(-1, 32))
    return torch.stack(out, 1)


def triplane_warp_loads(lanes, mapping):
    """The table loads of H2 as (addr, active) of (n, 32) lanes.
    "thread": a thread a sample, 128 scalar loads (table, feature, corner);
    "tile": a warp a (tile, table), lane = term, one load a sample."""
    M = lanes.shape[0]
    if mapping == "thread":
        a, act = lanes_of(lanes.reshape(M, 128) * 4)        # (W, 32, 128)
        return (a.permute(0, 2, 1).reshape(-1, 32),
                act[:, None, :].expand(-1, 128, -1).reshape(-1, 32))
    return (lanes.reshape(-1, 32) * 4,
            torch.ones((M * 4, 32), dtype=torch.bool, device=lanes.device))


def warp_load_counts(layout, x, spec):
    """{mapping: (instructions, lines, sectors), "M": samples} of the
    forward encode of `x` (H2 for the triplane field, H5 for brick, H7 for
    tcnn); for H5 and H7 also the lines and sectors across each warp's 8
    loads, (..., warp lines, warp sectors)."""
    maps = ("thread", "tile")
    if layout == "triplane":
        lanes = triplane_lanes(x, spec)
        loads = {m: triplane_warp_loads(lanes, m) for m in maps}
    elif layout == "brick":
        slots = brick_slots(x, spec)
        loads = {m: hash_grid_warp_loads(slots, (True,) * spec.n_levels, m)
                 for m in maps}
    else:
        rows = hash_grid_rows(x, spec)
        loads = {m: hash_grid_warp_loads(rows, spec.dense, m) for m in maps}
    out = {m: (int(act.any(1).sum()), *distinct_per_instruction(a, act))
           + (distinct_per_warp(a, act) if layout != "triplane" else ())
           for m, (a, act) in loads.items()}
    out["M"] = x.shape[0]
    return out


def log_counts(name, where, counts):
    """counts: {"M": samples, mapping: (instructions, lines, sectors[,
    warp lines, warp sectors])}."""
    M = max(counts["M"], 1)
    maps = {m: c for m, c in counts.items() if m != "M"}

    def per(ln, s):
        return (f"{ln} lines ({ln / M:.2f} a sample), {s} sectors "
                f"({s / M:.2f} a sample)")
    log(f"  {name} warp table loads on {where} (M={counts['M']}; modelled "
        f"from each mapping, not read from hardware counters): "
        + "; ".join(f"{m}: {c[0]} instructions, {per(*c[1:3])}"
                    + (f"; across each warp's 8 loads {per(*c[3:])}"
                       if len(c) > 3 else "")
                    for m, c in maps.items()))


def edge_inputs(x, xc):
    """The forward encodes' extra inputs: the batch cut to a ragged last
    tile, to one sample and to none, and `xc` (all samples in one cell)."""
    M = x.shape[0]
    return ((f"M={M - 7}", x[:M - 7]), ("M=1", x[:1]), ("M=0", x[:0]),
            ("one cell", xc))


def face_inputs(x, spec, layout, gen):
    """The batch with one coordinate of 64 samples per level (per table of
    the triplane) on its cell faces and 64 on its stride-3 brick faces
    (pos = x*scale + 0.5, or x*(R-1), an integer up to f32 rounding), and
    16 samples at x = 0 and at 1.0 (where the brick and hash corners clamp
    and the triplane's clip holds)."""
    x = x.clone()
    if layout == "triplane":
        levels = [(float(r - 1), 0.0, r) for r in (spec.plane_res,
                                                   spec.grid3d_res)]
    else:
        levels = [(spec.scales[l], 0.5, spec.resolutions[l])
                  for l in range(spec.n_levels)]
    i, dev = 0, x.device
    for scale, off, res in levels:
        for step in (1, 3):
            n = step * torch.randint(0, max(res // step, 1), (64,),
                                     generator=gen, device=dev)
            a = int(torch.randint(0, 3, (1,), generator=gen, device=dev))
            v = (n.float() - off) / torch.tensor(scale, dtype=torch.float32)
            x[i:i + 64, a] = v.clamp(0.0, 1.0)
            i += 64
    x[i:i + 16] = 1.0
    x[i + 16:i + 32] = 0.0
    return x.contiguous()


def check_dx(chk, label, kern, plain, x, g, where):
    """A position gradient (H12-H14: the forward's Jacobian and its
    contraction, in the table gradient's launch or beside it) against its
    plain versions on `x` under the cotangent `g`. kern: (jac_fwd(x) -> (out,
    jac), fwd(x) -> out, grad_dx(x, g, jac) -> (*table gradients, dx));
    plain: (jacobian(x) -> jac, contract(jac, g) -> dx, grad(x, g) ->
    table gradients). The Jacobian bit for bit the plain one, dx bit for
    bit the plain contraction of the plain Jacobian with g in f32 (the
    same chains of f32 operations in the same order), the features bit
    for bit the forward's without the Jacobian, the table gradients
    within 1e-4 of their largest value of the plain scatter's (the atomics'
    order) with no entry -0.0. Returns the largest error."""
    jac_fwd, fwd, grad_dx = kern
    jacobian, contract, grad = plain
    out, jac = jac_fwd(x)
    *tabs, dx = grad_dx(x, g, jac)
    ref_jac = jacobian(x)
    ref_dx = contract(ref_jac, g.float())
    tag = f"{label} {where}, {g.dtype} cotangent"
    errs = [chk.equal(f"{tag}: J", jac, ref_jac),
            chk.equal(f"{tag}: dx", dx, ref_dx),
            chk.equal(f"{tag}: features = the forward's without J", out,
                      fwd(x))]
    for i, (got, ref) in enumerate(zip(tabs, grad(x, g.float()))):
        errs.append(chk.close(f"{tag}: table gradient {i}", got, ref, 1e-4))
        chk.no_negative_zero(f"{tag}: table gradient {i}", got)
    return max(errs)


# the launchers that carry a position gradient: the forward with its
# Jacobian, and the table gradient with the Jacobian's contraction (H12)
# or the contraction alone (H13, H14: one body)
DX_LAUNCHERS = {"triplane": ("triplane_fwd_jac", "triplane_bwd_dx"),
                "brick": ("brick_fwd_jac", "brick_contract"),
                "tcnn": ("hash_grid_fwd_jac", "hash_grid_contract")}
NO_DX = "same launcher without the position gradient"


def dx_records(layout, err, fwd, bwd, library, bound_fwd, bound_bwd):
    """The `time_kernels` records of a position gradient's two launchers:
    `fwd` and `bwd` are (kernel, the launcher without the position
    gradient or None, plain version) calls on the same inputs, `library`
    the two yardsticks. The launcher without the position gradient is
    timed beside each (variant NO_DX), and the position gradient's cost,
    each launcher's time less that variant's (all of it without one),
    becomes the second's `dx_cost_ms`."""
    f, b = DX_LAUNCHERS[layout]
    rf = dict(err=err, kernel=fwd[0], plain=fwd[2], library=library[0],
              bound=bound_fwd, variants={NO_DX: fwd[1]})
    rb = dict(err=err, kernel=bwd[0], plain=bwd[2], library=library[1],
              bound=bound_bwd, dx_pair=f)
    if bwd[1] is not None:
        rb["variants"] = {NO_DX: bwd[1]}
    return {f: rf, b: rb}


def check_triplane_fwd(chk, planes, grid3d, x, spec, where):
    """H2's forward against its plain version on `x`, with f32 and bf16
    rows and f32 and bf16 output: f32 output within 2e-6 of the largest
    value (the 4 or 8 corner products summed in another order than
    torch's sum); bf16 output its own f32 sum rounded once, so equal to
    the plain f32 sum rounded to bf16 but for flips where the two f32 sums
    differ (`Check.bf16_flips`, counted). Returns the largest error."""
    from normal_clustering_nerf_torch.models import triplane as tp
    f32, bf16 = torch.float32, torch.bfloat16
    errs = []
    for rows_bf16 in (False, True):
        ref = tp.encode_plain(planes, grid3d, x, spec, rows_bf16)
        got = tp.encode_kernel(planes, grid3d, x, spec, rows_bf16, f32)
        tag = f"H2 fwd {where}, rows bf16={rows_bf16}"
        errs.append(chk.close(f"{tag}, f32 out", got, ref, 2e-6))
        gotb = tp.encode_kernel(planes, grid3d, x, spec, rows_bf16, bf16)
        errs.append(chk.bf16_flips(f"{tag}, bf16 out", gotb, ref, got,
                                   2e-6))
    return max(errs)


def check_encode_fwd(chk, layout, table, x, spec, where):
    """H5 (brick) or H7 (tcnn) against its plain version on `x` in f32 and
    bf16 output: bit for bit (the plain version sums the 8 corner products
    in the kernel's order, each op rounded, no FMA either side). Returns
    the largest error."""
    mod, name = encode_module(layout), LABEL[FIELD_KERNELS[layout][0]]
    errs = []
    for dt in (torch.float32, torch.bfloat16):
        got = mod.encode_kernel(table, x, spec, dt)
        errs.append(chk.equal(f"{name} {where}, {dt} out", got,
                              mod.encode_plain(table, x, spec).to(dt)))
    return max(errs)


def bootstrap_bound(a, kw, mr):
    """H1's bound on the march arguments `a` (rays_o, rays_d, hits,
    bitfield, noise) and keywords `kw`, with its output `mr`: its inputs
    read and outputs written once, and STEP_OPS a step of the steps the
    rays take inside their box interval, each probed once (the kernel's
    second pass is its own design choice). Returns (bound, probes)."""
    S = kw["march_steps"]
    b = nbytes(*a[:5]) + nbytes(mr.t, mr.dt, mr.valid, mr.ray_count) + 4
    t1, t2 = a[2][:, 0], a[2][:, 1]
    lo = math.sqrt(3.0) / kw["max_samples"]
    in_box = torch.clamp(torch.ceil((t2 - (t1 + lo * a[4])) / lo), 0, S)
    probes = int(torch.where(t1 >= 0, in_box, torch.zeros_like(in_box)).sum())
    return bound(b, probes * STEP_OPS), probes


def check_kernels(tr, gen):
    """Phase 2: H1-H4 against their plain versions on the main path's
    inputs. Returns {launcher name: record} with the largest error, the
    bound, and calls of the kernel and of its plain version on the same
    inputs for `time_kernels`; and the batch's rays, box intervals and
    march noise, which K1 takes next."""
    from normal_clustering_nerf_torch import kernels
    from normal_clustering_nerf_torch.models import triplane as tp
    from normal_clustering_nerf_torch.ops import composite as cp
    from normal_clustering_nerf_torch.ops import distortion as ds
    from normal_clustering_nerf_torch.ops import ray_march as rm

    inp = main_path_inputs(tr, gen)
    chk, rec = Check(), {}
    N, K, mr = inp["N"], inp["K"], inp["mr"]
    f32, bf16 = torch.float32, torch.bfloat16

    # H1: bootstrap march. Exact: same operations, same rounding.
    log(f"H1 march: N={N} S={inp['march']['kw']['march_steps']} K={K} "
        f"G={tr.cfg.model.grid_size}, occupied cells {inp['occupied']}")
    a, kw = inp["march"]["args"], inp["march"]["kw"]
    got = rm.march_rays_train_bootstrap(*a, **kw)
    err = max(chk.equal("t", got.t, mr.t), chk.equal("dt", got.dt, mr.dt),
              chk.equal("valid", got.valid, mr.valid),
              chk.equal("ray_count", got.ray_count, mr.ray_count),
              chk.equal("rm_samples", got.rm_samples, mr.rm_samples))
    hit = int((a[2][:, 0] >= 0).sum())
    h1_bound, probes = bootstrap_bound(a, kw, mr)
    log(f"  rm/ray {float(mr.rm_samples) / N:.2f}, rays hitting the box "
        f"{hit}, steps inside it {probes}")
    # the edges: N - 3 rays (a ragged last block of the warps' blocks), one
    # and none; an empty and a full bitfield, first-K and the full tail
    bits = a[3]
    full = torch.full_like(bits, 255)
    edges = [(f"N={n}", tuple(x[:n] for x in a[:3]) + (bits, a[4][:n]), kw)
             for n in (N - 3, 1, 0)]
    edges += [(f"{name} bitfield, tail_k {tk}", a[:3] + (f, a[4]),
               dict(kw, tail_k=tk))
              for name, f in (("empty", torch.zeros_like(bits)),
                              ("full", full)) for tk in (0, 16)]
    for where, ea, ekw in edges:
        got = rm.march_rays_train_bootstrap(*ea, **ekw)
        ref = rm.march_rays_train_dense_plain(*ea, **ekw)
        log(f"H1 march, {where}: rm {int(ref.rm_samples)}")
        err = max(err, *(chk.equal(f"{f} ({where})", getattr(got, f),
                                   getattr(ref, f))
                         for f in ("t", "dt", "valid", "ray_count",
                                   "rm_samples")))
    rec["march_bootstrap"] = dict(
        err=err, kernel=(lambda: rm.march_rays_train_bootstrap(*a, **kw)),
        plain=(lambda: rm.march_rays_train_dense_plain(*a, **kw)),
        bound=h1_bound,
        variants={"full 128^3 bitfield": (
            lambda: rm.march_rays_train_bootstrap(*a[:3], full, a[4], **kw))})

    # H2: triplane encode, forward in f32 and bf16, backward (f32 atomics)
    spec = tr.model.spec
    planes = tr.model.hash_table["planes"].detach()
    grid3d = tr.model.hash_table["grid3d"].detach()
    x = inp["x"]
    M = x.shape[0]
    log(f"H2 triplane: M={M}, planes {tuple(planes.shape)}, "
        f"grid3d {tuple(grid3d.shape)}")
    # every sample inside one plane cell and one grid3d cell at the middle
    # (drawn apart, so that the later checks keep their inputs)
    own = torch.Generator(device=x.device).manual_seed(8)
    xc = 0.5 + (0.9 / (spec.plane_res - 1)) * (
        torch.rand((M, 3), generator=own, device=x.device) - 0.5)
    errs = [check_triplane_fwd(chk, planes, grid3d, xx, spec, where)
            for where, xx in (("batch", x),) + edge_inputs(x, xc)]
    counts = warp_load_counts("triplane", x, spec)
    log_counts("H2", "the bootstrap batch", counts)
    g = torch.randn((M, spec.out_dim), generator=gen, device=x.device)
    shapes = (planes.shape, grid3d.shape)
    gerrs = []
    for name, gg in (("f32", g), ("bf16-rounded f32", g.to(bf16).to(f32)),
                     ("bf16", g.to(bf16))):
        ref = tp.encode_grad_plain(x, gg.to(f32), spec, *shapes)
        got = tp.encode_grad_kernel(x, gg, spec, *shapes)
        # reductions in launch order, runs of a cell summed first, vs
        # index_add_: up to ~10^3 terms per table value in another order
        gerrs.append(max(chk.close(f"d_planes ({name} cotangent)", got[0],
                                   ref[0], 1e-4),
                         chk.close(f"d_grid ({name} cotangent)", got[1],
                                   ref[1], 1e-4)))
        chk.no_negative_zero(f"d_planes ({name} cotangent)", got[0])
        chk.no_negative_zero(f"d_grid ({name} cotangent)", got[1])
    table_b = touched_table_bytes(x, spec)
    out_dim = spec.out_dim
    fwd_flops = M * (3 * (4 + spec.plane_feats * 4 * 2)
                     + (16 + spec.grid3d_feats * 8 * 2))
    out_dt = tr.model.compute_dtype
    compute_bf16 = out_dt == bf16
    # the yardsticks: the 128-value rows H2 reads (3 plane rows and the 2
    # halves of a grid3d row a sample) by one index_select of a table of
    # all rows, and H2's 128 terms a sample by one index_add_ into a flat
    # zeroed table of both (its fill not timed)
    rows, lanes, upd = triplane_terms(x, g, spec)
    all_rows = torch.cat([planes.reshape(-1, 128), grid3d.reshape(-1, 128)])
    d_lib = torch.zeros(all_rows.numel(), dtype=f32, device=x.device)
    # the occupancy refresh's shape: every cell of the 128^3 grid
    xr = torch.rand((tr.cfg.model.grid_size ** 3, 3), generator=gen,
                    device=x.device)
    rec["triplane_fwd"] = dict(
        err=max(errs), counts={"bootstrap batch": counts},
        kernel=(lambda: tp.encode_kernel(planes, grid3d, x, spec,
                                         compute_bf16, out_dt)),
        plain=(lambda: tp.encode_plain(planes, grid3d, x, spec,
                                       compute_bf16).to(out_dt)),
        library=(lambda: torch.index_select(all_rows, 0, rows)),
        bound=bound(nbytes(x) + table_b
                    + M * out_dim * (2 if compute_bf16 else 4), fwd_flops),
        variants={f"refresh shape M={xr.shape[0]}": (
            lambda: tp.encode_kernel(planes, grid3d, xr, spec, compute_bf16,
                                     out_dt))})
    rec["triplane_bwd"] = dict(
        err=max(gerrs),
        kernel=(lambda: tp.encode_grad_kernel(x, g, spec, *shapes)),
        plain=(lambda: tp.encode_grad_plain(x, g, spec, *shapes)),
        library=(lambda: d_lib.index_add_(0, lanes, upd)),
        fill=(lambda: (torch.zeros(shapes[0], dtype=f32, device=x.device),
                       torch.zeros(shapes[1], dtype=f32, device=x.device))),
        bound=bound(nbytes(x, g) + nbytes(planes, grid3d), fwd_flops))

    # H12: the position gradient from H2's forward's Jacobian, contracted
    # in H2's backward; f32 and bf16 cotangents, on the batch, its cuts,
    # the one-cell input and the faces
    kern = (lambda xx: tp.encode_jac_kernel(planes, grid3d, xx, spec,
                                            compute_bf16, out_dt),
            lambda xx: tp.encode_kernel(planes, grid3d, xx, spec,
                                        compute_bf16, out_dt),
            lambda xx, gg, jj: tp.encode_grad_dx_kernel(xx, gg, jj, spec,
                                                        *shapes))
    plain = (lambda xx: tp.encode_jacobian_plain(planes, grid3d, xx, spec),
             lambda jj, gg: tp.contract_plain(jj, gg, spec),
             lambda xx, gg: tp.encode_grad_plain(xx, gg, spec, *shapes))
    # (drawn apart, so that the later checks keep their inputs)
    xf = face_inputs(x, spec, "triplane",
                     torch.Generator(device=x.device).manual_seed(10))
    derrs = []
    for where, xx in (("batch", x), ("faces", xf)) + edge_inputs(x, xc):
        for gg in (g[:xx.shape[0]], g[:xx.shape[0]].to(bf16)):
            derrs.append(check_dx(chk, "H12", kern, plain, xx, gg, where))
    g_dt = g.to(out_dt)   # the cotangent as a training step hands it
    jac = kern[0](x)[1]
    jac_b = M * tp.jac_width(spec) * 4
    rec.update(dx_records(
        "triplane", max(derrs),
        fwd=(lambda: kern[0](x), lambda: kern[1](x),
             lambda: (tp.encode_plain(planes, grid3d, x, spec,
                                      compute_bf16).to(out_dt),
                      plain[0](x))),
        bwd=(lambda: kern[2](x, g_dt, jac),
             lambda: tp.encode_grad_kernel(x, g_dt, spec, *shapes),
             lambda: (plain[2](x, g_dt.float()),
                      plain[1](jac, g_dt.float()))),
        library=(lambda: torch.index_select(all_rows, 0, rows),
                 lambda: d_lib.index_add_(0, lanes, upd)),
        bound_fwd=bound(nbytes(x) + table_b
                        + M * out_dim * (2 if compute_bf16 else 4) + jac_b,
                        fwd_flops + M * TRIPLANE_JAC_OPS),
        bound_bwd=bound(nbytes(x, g_dt) + nbytes(planes, grid3d) + jac_b
                        + 12 * M, fwd_flops + M * 2 * tp.jac_width(spec))))

    # H3 and H4 at two inputs: the untrained field's sigmas (the main
    # path's; no ray reaches T_threshold there), and the same sigmas scaled
    # by 10^U(0, 4) per ray, so that rays terminate early and sigma*delta
    # reaches the clip at 80
    sig, raws = inp["sigmas"], inp["raws"]
    scale = 10.0 ** (4.0 * torch.rand((N, 1), generator=gen, device=x.device))
    thr = tr.cfg.render.T_threshold
    C = raws.shape[-1]
    gs = (torch.randn(N, generator=gen, device=x.device),
          torch.randn(N, generator=gen, device=x.device),
          torch.randn((N, C), generator=gen, device=x.device),
          torch.randn((N, K), generator=gen, device=x.device))
    gl = torch.randn(N, generator=gen, device=x.device)
    errs = {k: [] for k in ("composite_fwd", "composite_bwd",
                            "distortion_fwd", "distortion_bwd")}
    for tag, s in (("main", sig), ("opaque", (sig * scale).contiguous())):
        ca = (s, raws, mr.dt, mr.t, mr.valid, thr)
        ref, got = cp.composite_plain(*ca), cp.composite_kernel(*ca)
        early = int((ref[4] < mr.ray_count).sum())
        clipped = int((mr.valid & (s * mr.dt >= cp.SIGDT_MAX)).sum())
        log(f"H3 composite, {tag} sigmas: N={N} K={K} C={C}; rays ended "
            f"early {early}, samples clipped {clipped}")
        if tag == "opaque" and not (early and clipped):
            raise RuntimeError("the opaque input reaches neither early "
                               "termination nor the clip")
        errs["composite_fwd"].append(check_composite_fwd(chk, ca, got, ref))
        errs["composite_bwd"].append(check_composite_bwd(chk, ca, gs))

        # H4: distortion loss on the composite's weights
        da = (ref[3].contiguous(), mr.dt, mr.t, mr.valid)
        log(f"H4 distortion, {tag} sigmas: N={N} K={K}")
        for k, e in zip(("distortion_fwd", "distortion_bwd"),
                        check_distortion(chk, da, gl)):
            errs[k].append(e)
        if tag == "main":   # timed and bounded at the main path's input
            ma, mda, mgot = ca, da, got
    # H3's backward at K = 1, 16 and 32 (lane groups of 1, 16 and 32) and
    # at K = 33, 64 and 128 (the long kernel: a warp a ray, two chunks of
    # 32, the second of one sample; two; four), on N rays (a ragged last
    # block at each K), one ray and none
    for k in BWD_KS:
        kca, kgs = composite_case(N, k, C, gen)
        for n in (N, 1, 0):
            cut = tuple(t[:n] for t in kca) + (thr,)
            log(f"H3 backward, random inputs: N={n} K={k} C={C}")
            errs["composite_bwd"].append(check_composite_bwd(
                chk, cut, tuple(t[:n] for t in kgs)))
    # H3's forward at K = 1, 16, 32, 33 and 64 (at C = 9 groups of 1 and
    # 16 lanes: one chunk, one of 16, two, two and a sample, four) and at
    # C = 16, K = 64 (32 lanes, two chunks), on N rays, one and none, with
    # and without T_start (an eighth of the rays just above T_threshold)
    for k, c in ((1, C), (16, C), (32, C), (33, C), (64, C), (64, 16)):
        kca, _ = composite_case(N, k, c, gen)
        T_start = torch.rand(N, generator=gen, device=x.device)
        T_start[::8] = thr * (1.0 + 2.0 * T_start[::8])
        for n in (N, 1, 0):
            for tsn in (None, T_start[:n]):
                cut = tuple(t[:n] for t in kca) + (thr,)
                cut += () if tsn is None else (tsn,)
                ref, got = cp.composite_plain(*cut), cp.composite_kernel(*cut)
                log(f"H3 forward, random inputs: N={n} K={k} C={c}"
                    f"{'' if tsn is None else ', T_start'}; rays ended early "
                    f"{int((ref[4] < cut[4].sum(1)).sum())}")
                errs["composite_fwd"].append(
                    check_composite_fwd(chk, cut, got, ref))
    # H4 at K = 1, 16, 32, 33 and 64 (chunks of 16 samples on 4 lanes: a
    # run of one sample; one chunk; two; three, the last of one sample,
    # with rows off 16-byte alignment; four) on N rays, one and none
    for k in (1, 16, 32, 33, 64):
        kda, kg = distortion_case(N, k, gen)
        for n in (N, 1, 0):
            log(f"H4 distortion, random inputs: N={n} K={k}")
            for name, e in zip(("distortion_fwd", "distortion_bwd"),
                               check_distortion(chk, tuple(t[:n] for t in kda),
                                                kg[:n])):
                errs[name].append(e)
    ca, da = ma, mda
    flops_fwd = N * K * (10 + 2 * C)
    rec["composite_fwd"] = dict(
        kernel=(lambda: cp.composite_kernel(*ca)),
        plain=(lambda: cp.composite_plain(*ca)),
        bound=bound(nbytes(*ca[:5]) + nbytes(*mgot), flops_fwd))
    rec["composite_bwd"] = dict(
        kernel=(lambda: cp.composite_grad_kernel(*ca, *gs)),
        plain=(lambda: cp.composite_grad_plain(*ca, *gs)),
        bound=bound(nbytes(*ca[:5], *gs) + nbytes(sig, raws),
                    2 * flops_fwd + N * K * C * 3))
    rec["distortion_fwd"] = dict(
        kernel=(lambda: ds.distortion_kernel(*da)),
        plain=(lambda: ds.distortion_plain(*da)),
        bound=bound(nbytes(*da) + 4 * N, N * K * 12))
    rec["distortion_bwd"] = dict(
        kernel=(lambda: ds.distortion_grad_kernel(gl, *da)),
        plain=(lambda: ds.distortion_grad_plain(gl, *da)),
        bound=bound(nbytes(gl, *da) + nbytes(da[0]), N * K * 18))
    for k, e in errs.items():
        rec[k]["err"] = max(e)
    chk.done("kernel checks")
    a = inp["march"]["args"]
    return rec, (a[0], a[1], a[2], a[4])


def composite_case(N, K, C, gen):
    """Dense composite inputs (sigmas, raws, deltas, ts, valid) and the four
    cotangents, drawn as the CPU tests draw them
    (`tests/test_torch_composite.py`): log-normal sigmas, a quarter of the
    rays 200 times denser (they end early, samples reach the clip), valid
    a random prefix of each row."""
    dev = gen.device

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def r(*shape):
        return torch.randn(shape, generator=gen, device=dev)
    sig = torch.exp(1.0 + 2.0 * r(N, K))
    sig[: N // 4] *= 200.0
    dt = 0.005 + 0.045 * u(N, K)
    count = torch.clamp((u(N) * (K + 1)).long(), max=K)
    valid = torch.arange(K, device=dev)[None] < count[:, None]
    return ((sig, r(N, K, C), dt, torch.cumsum(dt, 1), valid),
            (r(N), r(N), r(N, C), r(N, K)))


def composite_serial(sigmas, raws, deltas, ts, valid, thr, T_start=None):
    """H3's forward as its first design computed it: one thread a ray, the
    samples one after the other, in that thread's order of f32 operations
    (each torch op on the card rounds once; expf and expm1f as torch.exp
    and torch.expm1). The bit-for-bit reference of the lane-group kernel.
    Returns (opacity, depth, rend, ws, vr_samples)."""
    from normal_clustering_nerf_torch.ops.composite import SIGDT_MAX
    N, K = sigmas.shape
    csum, op, dp = (sigmas.new_zeros(N) for _ in range(3))
    acc = raws.new_zeros((N, raws.shape[-1]))
    ws = torch.zeros_like(sigmas)
    n_inc = torch.zeros(N, dtype=torch.int32, device=sigmas.device)
    early = torch.zeros(N, dtype=torch.bool, device=sigmas.device)
    for s in range(K):
        v = valid[:, s]
        x = torch.clamp(torch.where(v, sigmas[:, s] * deltas[:, s], 0.0),
                        0.0, SIGDT_MAX)
        csum = csum + x
        T = torch.exp(-(csum - x))
        if T_start is not None:
            T = T * T_start
        alpha = -torch.expm1(-x)
        inc = v & (T > thr)
        w = torch.where(inc, alpha * T, 0.0)
        ws[:, s] = w
        op = torch.where(inc, op + w, op)
        dp = torch.where(inc, dp + w * ts[:, s], dp)
        acc = torch.where(inc[:, None], acc + w[:, None] * raws[:, s], acc)
        n_inc += inc.int()
        early |= inc & (T * (1.0 - alpha) <= thr)
    return op, dp, acc, ws, n_inc - early.int()


def distortion_case(N, K, gen):
    """Dense H4 inputs (ws, deltas, ts, valid) and a cotangent on random
    rows: weights in [0, 1/K) scaled per ray (a row sums to less than 1,
    as a ray's compositing weights do), t rising along each row, valid a
    random prefix of each row with a tenth of it invalid at random."""
    dev = gen.device

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    dt = 0.005 + 0.045 * u(N, K)
    count = torch.clamp((u(N) * (K + 1)).long(), max=K)
    valid = ((torch.arange(K, device=dev)[None] < count[:, None])
             & (u(N, K) >= 0.1))
    return ((u(N, K) * (u(N, 1) / max(K, 1)), dt,
             torch.cumsum(dt, 1) + u(N, 1), valid),
            torch.randn(N, generator=gen, device=dev))


def distortion_serial(ws, deltas, ts, valid, g=None):
    """H4 as its thread-a-ray design computed it: the samples one after
    the other, in that thread's order of f32 operations (each torch op
    rounds once). The bit-for-bit reference of the lane-group kernels. Returns the (N,) loss or, given the (N,) cotangent g, the
    closed-form backward's (N, K) d_ws (0 on invalid samples)."""
    N, K = ws.shape
    W = A = out = ws.new_zeros(N)

    def w_of(s):
        return torch.where(valid[:, s], ws[:, s], 0.0)
    if g is None:
        for s in range(K):
            w = w_of(s)
            wt = w * ts[:, s]
            W, A = W + w, A + wt
            per = (2.0 * (A * (W - w) - W * (A - wt))
                   + ((1.0 / 3.0) * w) * w * deltas[:, s])
            out = torch.where(valid[:, s], out + per, out)
        return out
    Wk = Ak = ws.new_zeros(N)
    for s in range(K):
        w = w_of(s)
        Wk, Ak = Wk + w, Ak + w * ts[:, s]
    d_ws = torch.zeros_like(ws)
    for j in range(K):
        w, t = w_of(j), ts[:, j]
        head = t * W - A   # W_{j-1}, A_{j-1}
        W, A = W + w, A + w * t
        tail = (Ak - A) - t * (Wk - W)
        d = (g * 2.0) * (head + tail) + ((g * (2.0 / 3.0)) * w) * deltas[:, j]
        d_ws[:, j] = torch.where(valid[:, j], d, 0.0)
    return d_ws


def check_distortion(chk, da, g):
    """H4's dense forward and backward on the inputs `da` (ws, deltas, ts,
    valid) and the cotangent `g`: against the plain versions (within 1e-5
    and 1e-4 of the largest value: torch.cumsum and a sum in another
    order, a closed form grouped otherwise) and bit for bit against
    `distortion_serial`. Returns the forward's and the backward's largest
    errors."""
    from normal_clustering_nerf_torch.ops import distortion as ds
    loss, d_ws = ds.distortion_kernel(*da), ds.distortion_grad_kernel(g, *da)
    return (max(chk.close("loss", loss, ds.distortion_plain(*da), 1e-5),
                chk.equal("loss = serial order", loss,
                          distortion_serial(*da))),
            max(chk.close("d_ws", d_ws, ds.distortion_grad_plain(g, *da),
                          1e-4),
                chk.equal("d_ws = serial order", d_ws,
                          distortion_serial(*da, g))))


def check_composite_fwd(chk, ca, got, ref):
    """H3's forward output `got` on the inputs `ca` (sigmas, raws, deltas,
    ts, valid, T_threshold[, T_start]): against its plain version `ref`
    within 1e-5 of the largest value (running sums against torch.cumsum
    and einsum), and bit for bit against `composite_serial`. Returns the
    largest error."""
    ser = composite_serial(*ca)
    names = ("opacity", "depth", "rend", "ws")
    return max(
        *(chk.close(nm, got[i], ref[i], 1e-5) for i, nm in enumerate(names)),
        chk.equal("vr_samples", got[4], ref[4]),
        *(chk.equal(f"{nm} = serial order", got[i], ser[i])
          for i, nm in enumerate(names + ("vr_samples",))))


def check_composite_bwd(chk, ca, gs):
    """H3's backward on the inputs `ca` (sigmas, raws, deltas, ts, valid,
    T_threshold) and cotangents `gs`: against its plain version (d_sigmas
    within 1e-4 of its largest value: it subtracts a suffix sum from
    G*T*exp(-x), summed in another order than torch's cumsum; d_raws
    within 1e-5); d_raws bit for bit g_rend (x) ws with ws H3 forward's
    own output, which holds the backward's weights and inclusion mask to
    the forward's; d_sigmas exactly 0 on the samples that are invalid or
    whose sigma*delta is clipped; d_sigmas bit for bit its serial order
    (`composite_grad_serial`). Returns the largest error."""
    from normal_clustering_nerf_torch.ops import composite as cp
    sig, _, dt, _, valid, _ = ca
    ws = cp.composite_kernel(*ca)[3]
    got = cp.composite_grad_kernel(*ca, *gs)
    ref = cp.composite_grad_plain(*ca, *gs)
    raw_x = sig * dt
    off = ~(valid & (raw_x > 0) & (raw_x < cp.SIGDT_MAX))
    return max(
        chk.close("d_sigmas", got[0], ref[0], 1e-4),
        chk.equal("d_sigmas = serial order", got[0],
                  composite_grad_serial(*ca, *gs)),
        chk.close("d_raws", got[1], ref[1], 1e-5),
        chk.equal("d_raws = g_rend x H3 fwd's ws", got[1],
                  gs[2][:, None, :] * ws[:, :, None]),
        chk.equal(f"d_sigmas = 0 on {int(off.sum())} invalid or clipped "
                  f"samples", got[0][off], torch.zeros_like(got[0][off])))


# the field's launchers of each layout, and the launchers every path shares
FIELD_KERNELS = {"triplane": ("triplane_fwd", "triplane_bwd"),
                 "brick": ("brick_fwd", "brick_bwd"),
                 "tcnn": ("hash_grid_fwd", "hash_grid_bwd")}
PATH_KERNELS = ("march_bootstrap", "composite_fwd", "composite_bwd",
                "distortion_fwd", "distortion_bwd", "march_sv_train",
                "kmeans_cluster", "occ_compact", "occ_merge_pack",
                "occ_tables", "adamw_norm", "adamw_step")
# K7 a step; K8 a refresh (every 16 steps), occ_compact only in the
# sampled ones, from the warm-up's end (step 256); K9's two launchers a
# step
K7K8_LAUNCHES = {"kmeans_cluster": STEPS, "occ_merge_pack": STEPS // 16,
                 "occ_tables": STEPS // 16,
                 "occ_compact": (STEPS - 256) // 16, "adamw_norm": STEPS,
                 "adamw_step": STEPS, "loss_rays": STEPS,
                 "loss_clusters": STEPS, "loss_bwd": STEPS}
P4_POINTS = 262_144   # experiments/pallas_gather2.py: M = 8192 rays x 32
ENCODE_OPS = 60       # f32 operations per (sample, level): pos, weights, fold
# f32 operations of the Jacobians beyond the forward's: per (sample,
# level) of H13 the 3 axes' 4 weight products, each of 8 corners x 3
# axes' signed factor and its 2 features' product and sum, the scale (6);
# per (sample, level) of H14 the 3 axes' 4 weight-derivative products (2
# each) and 8 corners x 3 axes x 2 features' product and sum; per sample
# of H12 each plane's 4 corners x 2 axes (a sign) and 8 features x 2 axes
# x (4 products and sums, a scale), grid3d's 8 corners' 3 products and 4
# features x 3 axes x (8 products and sums, a scale)
BRICK_JAC_OPS = 3 * 4 + 8 * 3 * (1 + 2 * 2) + 6
HASH_JAC_OPS = 3 * 4 * 2 + 8 * 3 * 2 * 2
TRIPLANE_JAC_OPS = 3 * (4 * 2 + 8 * 2 * (4 * 2 + 1)) + (8 * 3 + 4 * 3 * (8 * 2 + 1))


def encode_module(layout):
    from normal_clustering_nerf_torch.models import (brick_hash, hash_encoding,
                                                     triplane)
    return {"brick": brick_hash, "tcnn": hash_encoding,
            "triplane": triplane}[layout]


def encode_lanes(x, spec, layout):
    """Flat table indices of the values the encode of `x` reads with a
    non-zero weight (brick: (row, slot, feature) of the 8 corners; tcnn:
    (row, feature)), and the values' weights: (M*L*8, F) each."""
    mod, F = encode_module(layout), spec.n_features
    f = torch.arange(F, device=x.device)
    lanes, ws = [], []
    for l in range(spec.n_levels):
        if layout == "brick":
            row, slots, w = mod.level_geometry(x, spec, l)
            lanes.append(((l * spec.n_bricks + row[:, None]) * 64 + slots)
                         [..., None] * F + f)
        else:
            rows, w = mod.level_corners(x, spec, l)
            lanes.append(rows[..., None] * F + f)
        ws.append(w[..., None].expand(-1, -1, F))
    return (torch.stack(lanes, 1).reshape(-1, F),
            torch.stack(ws, 1).reshape(-1, F))


def touched_encode_bytes(x, spec, layout):
    """Bytes of the table that the encode of `x` needs: the distinct values
    read with a non-zero weight."""
    lanes, w = encode_lanes(x, spec, layout)
    return 4 * torch.unique(lanes[w != 0]).numel()


def gathered_rows(x, spec):
    """Brick rows of `x` at every level, as flat rows of the (L*n_bricks,
    128) table: the rows the JAX forward and the Pallas probes gather."""
    from normal_clustering_nerf_torch.models.brick_hash import level_geometry
    return torch.cat([l * spec.n_bricks + level_geometry(x, spec, l)[0]
                      for l in range(spec.n_levels)])


def check_encoding(tr, gen):
    """Phase 2 of the brick and the tcnn path: H5/H6 (brick) or H7/H8
    (tcnn) against their plain versions on the main path's inputs (the
    bootstrap march's samples of one batch, forward in f32 and bf16; the
    table gradient under an f32 cotangent, a bf16-rounded one passed as
    f32 and the same passed as bf16) and on a refresh-sized batch (every
    cell of the grid, forward in the compute dtype); the table gradient
    also with every sample inside one cell of level 0 (the warp merge's
    worst case) and with no entry -0.0; H5 also at the Pallas probe P4's
    shape. Returns the records of both launchers for `time_kernels`, with
    the PyTorch yardsticks: `index_select` of the rows the forward reads
    (brick: whole 128-value rows, as the JAX forward and the probes gather
    them), `index_add_` of the backward's terms into a zeroed table; and
    the gradient table's zero fill alone."""
    layout = tr.cfg.model.hash_layout
    mod, (fwd, bwd) = encode_module(layout), FIELD_KERNELS[layout]
    inp = main_path_inputs(tr, gen)
    x, spec = inp["x"], tr.model.spec
    table = tr.model.hash_table.detach()
    M, L, F = x.shape[0], spec.n_levels, spec.n_features
    f32, bf16 = torch.float32, torch.bfloat16
    out_dt = tr.model.compute_dtype
    chk = Check()
    log(f"{LABEL[fwd]}/{LABEL[bwd]} {layout} encode: M={M}, L={L}, table "
        f"{tuple(table.shape)}, dense levels {sum(spec.dense)}")
    xr = torch.rand((tr.cfg.model.grid_size ** 3, 3), generator=gen,
                    device=x.device)
    refresh = f"refresh shape M={xr.shape[0]}"
    g = torch.randn((M, spec.out_dim), generator=gen, device=x.device)
    # every sample inside the cell of level 0 at the middle of the grid
    s0, c0 = spec.scales[0], spec.resolutions[0] // 2
    xc = ((c0 - 0.45 + 0.9 * torch.rand((M, 3), generator=gen,
                                         device=x.device)) / s0).contiguous()
    errs = [check_encode_fwd(chk, layout, table, xx, spec, where)
            for where, xx in (("batch", x), (refresh, xr))
            + edge_inputs(x, xc)]
    counts = warp_load_counts(layout, x, spec)
    log_counts(LABEL[fwd], "the bootstrap batch", counts)
    # H5 and H7 read slot or row pairs as 16-byte words: a table 8 bytes
    # off that alignment must be refused, not launched
    off = torch.empty(table.numel() + 2, device=x.device)[2:]
    chk.refused(f"{LABEL[fwd]}, a table 8 bytes off 16-byte alignment",
                lambda: mod.encode_kernel(off.view(table.shape), x[:32],
                                          spec, out_dt))
    gerrs = []
    for name, xx, gg in (
            ("f32 cotangent", x, g), ("bf16-rounded f32 cotangent", x,
                                      g.to(bf16).to(f32)),
            ("bf16 cotangent", x, g.to(bf16)),
            ("one level-0 cell, f32 cotangent", xc, g)):
        # float2 reductions in launch order, runs of a cell summed in
        # registers, vs index_add_: up to ~10^4 terms per value at the
        # coarse levels (M in the one-cell case), summed in another order
        got = mod.encode_grad_kernel(xx, gg, spec)
        gerrs.append(chk.close(f"d_table ({name})", got,
                               mod.encode_grad_plain(xx, gg, spec), 1e-4))
        chk.no_negative_zero(f"d_table ({name})", got)
    lanes, w = encode_lanes(x, spec, layout)
    lanes, upd = lanes.reshape(-1), (w * g.reshape(M, L, 1, F)
                                     .expand(-1, -1, 8, -1)
                                     .reshape(-1, F)).reshape(-1)
    d_lib = torch.zeros(table.numel(), dtype=f32, device=x.device)
    if layout == "brick":
        rows, src = gathered_rows(x, spec), table.view(-1, spec.row_width)
    else:
        rows, src = lanes[::F] // F, table
    touched = touched_encode_bytes(x, spec, layout)
    log(f"  table bytes the batch touches {touched} of {nbytes(table)}")
    ops = M * L * ENCODE_OPS
    rec = {fwd: dict(
        err=max(errs),
        kernel=(lambda: mod.encode_kernel(table, x, spec, out_dt)),
        plain=(lambda: mod.encode_plain(table, x, spec).to(out_dt)),
        library=(lambda: torch.index_select(src, 0, rows)),
        bound=bound(nbytes(x) + touched
                    + M * spec.out_dim * (2 if out_dt == bf16 else 4), ops),
        variants={refresh: (
            lambda: mod.encode_kernel(table, xr, spec, out_dt))},
        counts={"bootstrap batch": counts}),
        bwd: dict(
        err=max(gerrs),
        kernel=(lambda: mod.encode_grad_kernel(x, g, spec)),
        plain=(lambda: mod.encode_grad_plain(x, g, spec)),
        library=(lambda: d_lib.index_add_(0, lanes, upd)),
        fill=(lambda: torch.zeros(spec.table_shape(), dtype=f32,
                                  device=x.device)),
        bound=bound(nbytes(x, g, table), ops))}
    # H13 / H14: the position gradient, f32 and bf16 cotangents, on the
    # batch, its cuts, the one-cell input and the faces (drawn apart): the
    # forward's Jacobian (H5 / H7), contracted in a launch of its own
    xf = face_inputs(x, spec, layout,
                     torch.Generator(device=x.device).manual_seed(10))
    wheres = (("batch", x), ("faces", xf)) + edge_inputs(x, xc)
    g_dt = g.to(out_dt)   # the cotangent as a training step hands it
    label = "H13" if layout == "brick" else "H14"
    kern = (lambda xx: mod.encode_jac_kernel(table, xx, spec, out_dt),
            lambda xx: mod.encode_kernel(table, xx, spec, out_dt),
            lambda xx, gg, jj: (mod.encode_grad_kernel(xx, gg, spec),
                                mod.contract_kernel(jj, gg, spec)))
    plain = (lambda xx: mod.encode_jacobian_plain(table, xx, spec),
             mod.contract_plain,
             lambda xx, gg: (mod.encode_grad_plain(xx, gg, spec),))
    derrs = []
    for where, xx in wheres:
        for gg in (g[:xx.shape[0]], g[:xx.shape[0]].to(bf16)):
            derrs.append(check_dx(chk, label, kern, plain, xx, gg, where))
    jac = kern[0](x)[1]
    jac_b = M * 3 * spec.out_dim * 4
    jac_ops = BRICK_JAC_OPS if layout == "brick" else HASH_JAC_OPS
    rec.update(dx_records(
        layout, max(derrs),
        fwd=(lambda: kern[0](x), lambda: kern[1](x),
             lambda: (mod.encode_plain(table, x, spec).to(out_dt),
                      plain[0](x))),
        bwd=(lambda: mod.contract_kernel(jac, g_dt, spec), None,
             lambda: plain[1](jac, g_dt.float())),
        library=(lambda: torch.index_select(src, 0, rows),
                 lambda: torch.einsum("mk,mka->ma", g_dt.float(),
                                      jac.view(M, -1, 3))),
        bound_fwd=bound(nbytes(x) + touched + jac_b
                        + M * spec.out_dim * (2 if out_dt == bf16 else 4),
                        ops + M * L * jac_ops),
        bound_bwd=bound(nbytes(g_dt) + jac_b + 12 * M,
                        M * 2 * 3 * spec.out_dim)))
    if layout == "brick":
        # P4's shape: the (16, 8192, 128) table and 262,144 points, whose
        # rows P4 gathers whole into a (16, 262144, 128) f32 array
        xp = torch.rand((P4_POINTS, 3), generator=gen, device=x.device)
        rp = gathered_rows(xp, spec)
        errs.append(check_encode_fwd(chk, layout, table, xp, spec,
                                     f"P4 shape M={P4_POINTS}"))
        rec[fwd]["err"] = max(errs)
        rec[fwd]["at_p4_shape"] = dict(
            kernel=lambda: mod.encode_kernel(table, xp, spec, f32),
            library=lambda: torch.index_select(src, 0, rp),
            bound=bound(nbytes(xp) + touched_encode_bytes(xp, spec, layout)
                        + P4_POINTS * spec.out_dim * 4,
                        P4_POINTS * L * ENCODE_OPS))
    chk.done(f"{layout} encode checks")
    return rec


def step_cotangent(tr):
    """The positions and the cotangent that one training step after the
    bootstrap hands the field's table gradient (H2, H6 or H8), captured in
    the wrapper's call: g in the compute dtype, with the zero rows of the
    samples that are invalid or lie past a ray's end. The step is taken:
    the trainer's state moves on."""
    mod = encode_module(tr.cfg.model.hash_layout)
    seen, kernel = [], mod.encode_grad_kernel

    def spy(x, g, *rest):
        seen.append((x.detach().clone(), g.detach().clone()))
        return kernel(x, g, *rest)
    mod.encode_grad_kernel = spy
    try:
        tr.train_step_core(bootstrap=False)
    finally:
        mod.encode_grad_kernel = kernel
    if len(seen) != 1:
        raise RuntimeError(f"a training step called the table gradient "
                           f"{len(seen)} times, expected once")
    return seen[0]


def check_step_cotangent(tr, rec):
    """Each path after its training: the field's table gradient (H2, H6 or
    H8) against its plain version on the cotangent of one training step of
    the trained field (`step_cotangent`), with no entry -0.0; the field's
    forward (H2, H5 or H7) on that step's positions (the sv march's
    samples, which most of a bench run's forward launches see), with its
    modelled warp load counts;
    the calls are kept in `rec` for `time_kernels`."""
    layout = tr.cfg.model.hash_layout
    mod, (fwd, bwd) = encode_module(layout), FIELD_KERNELS[layout]
    x, g = step_cotangent(tr)
    spec = tr.model.spec
    if layout == "triplane":   # the tables' shapes; the 4 tables' columns
        extra = tuple(tr.model.hash_table[k].shape
                      for k in ("planes", "grid3d"))
        widths = (spec.plane_feats,) * 3 + (spec.grid3d_feats,)
    else:
        extra, widths = (), (spec.n_features,) * spec.n_levels
    zero = sum(int((part == 0).all(-1).sum())
               for part in torch.split(g, widths, dim=1))
    log(f"{LABEL[bwd]} on one training step's cotangent ({layout}, step "
        f"{tr.step - 1}): M={x.shape[0]}, {g.dtype}, {zero} of "
        f"{x.shape[0] * len(widths)} (sample, level) pairs zero")
    chk = Check()
    got = mod.encode_grad_kernel(x, g, spec, *extra)
    ref = mod.encode_grad_plain(x, g.float(), spec, *extra)
    got, ref = ((got, ref) if layout == "triplane" else ((got,), (ref,)))
    err = 0.0
    for i, (a, b) in enumerate(zip(got, ref)):
        err = max(err, chk.close(f"table {i} (step cotangent)", a, b, 1e-4))
        chk.no_negative_zero(f"table {i} (step cotangent)", a)
    rec[bwd]["err"] = max(rec[bwd]["err"], err)
    rec[bwd]["step_cotangent"] = lambda: mod.encode_grad_kernel(x, g, spec,
                                                                *extra)
    out_dt, where = tr.model.compute_dtype, f"sv step M={x.shape[0]}"
    if layout == "triplane":
        planes, grid3d = (tr.model.hash_table[k].detach()
                          for k in ("planes", "grid3d"))
        bf16 = out_dt == torch.bfloat16
        err = check_triplane_fwd(chk, planes, grid3d, x, spec, "sv step")
        fn = lambda: mod.encode_kernel(planes, grid3d, x, spec, bf16, out_dt)
    else:
        table = tr.model.hash_table.detach()
        err = check_encode_fwd(chk, layout, table, x, spec, "sv step")
        fn = lambda: mod.encode_kernel(table, x, spec, out_dt)
    chk.done(f"{LABEL[bwd]} on a step's cotangent, {LABEL[fwd]} on its "
             f"positions")
    counts = warp_load_counts(layout, x, spec)
    log_counts(LABEL[fwd], "an sv step's positions", counts)
    rec[fwd]["err"] = max(rec[fwd]["err"], err)
    rec[fwd]["counts"]["sv step"] = counts
    rec[fwd]["variants"][where] = fn


def random_occupancy(tr, gen, density=0.2):
    """An occupancy state whose cells are set at random with `density`, plus
    two solid slabs and a wall shell, so that many rays cross more occupied
    supervoxels than the interval budget holds (seeded by `gen`)."""
    from normal_clustering_nerf_torch.models.occupancy import (
        coarse_occupancy, supervoxel_tables)
    from normal_clustering_nerf_torch.ops.packbits import packbits
    G = tr.cfg.model.grid_size
    occ = torch.rand((G, G, G), generator=gen, device=tr.device) < density
    b, w = G // 4, G // 16                     # indexed [x, y, z]
    occ[b:2 * b, b:2 * b, :] = True
    occ[:, 2 * b:3 * b, b:3 * b] = True
    occ[:w] = True
    occ[-w:] = True
    bitfield = packbits(occ.permute(2, 1, 0).float(), 0.5)   # x fastest
    return tr.occ._replace(density_bitfield=bitfield,
                           coarse_occ=coarse_occupancy(bitfield, G),
                           **dict(zip(("sv_mask", "sv_payload"),
                                      supervoxel_tables(bitfield, G))))


def held_out_rays(tr):
    """The rays of the 4 held-out views (65,536 at 128^2) and their
    near-clamped box intervals, as `render_test` takes them."""
    from normal_clustering_nerf_torch.datasets.ray_utils import get_rays
    from normal_clustering_nerf_torch.models.rendering import near_intervals
    s, f32, dev = tr.scene_test, torch.float32, tr.device
    dirs = torch.as_tensor(s.directions, dtype=f32, device=dev)
    rays = [get_rays(dirs, torch.as_tensor(p, dtype=f32, device=dev))
            for p in s.poses]
    o = torch.cat([r[0] for r in rays]).contiguous()
    d = torch.cat([r[1] for r in rays]).contiguous()
    h = near_intervals(tr.cfg.model, o, d)
    return o, d, h[:, 0].contiguous(), h[:, 1].contiguous()


def sv_work(rays_o, rays_d, t0, t_end, hit, occ, cfg, RI, S):
    """What the sv march has to touch for these rays, counted with the
    plain version's phase A: one mask byte per valid interval, one 64-byte
    payload row per kept interval, and the lattice steps of the kept
    intervals that lie in [0, S) and before t_end."""
    from normal_clustering_nerf_torch.ops import ray_march as rm
    m = cfg.model
    lo = math.sqrt(3.0) / m.max_samples
    SI = rm._sv_geometry(m.scale, m.grid_size, lo)[3]
    probes = rows = steps = 0
    for i in range(0, rays_o.shape[0], K1_CHUNK):
        sl = slice(i, i + K1_CHUNK)
        A = rm.sv_intervals_plain(rays_o[sl], rays_d[sl], t0[sl], t_end[sl],
                                  hit[sl], occ.sv_mask, scale=m.scale,
                                  grid_size=m.grid_size, RI=RI)
        kept = A["ivalid"]
        probes += int(A["iv_valid"].sum())
        rows += int(kept.sum())
        b0 = torch.gather(A["b0"], 1, A["iidx"])
        k0 = torch.where(kept, torch.ceil((b0 - t0[sl, None]) / lo) - 1,
                         torch.zeros_like(b0))
        k_end = torch.clamp(torch.ceil((t_end[sl] - t0[sl]) / lo), 0, S)
        n = (torch.minimum(k0 + SI, torch.nan_to_num(k_end)[:, None])
             - torch.clamp(k0, min=0))
        steps += int(torch.where(kept, torch.clamp(n, min=0),
                                 torch.zeros_like(n)).sum())
    return probes, rows, steps


def test_round_plain(args, kw):
    """K1's test-round plain version over `K1_CHUNK` rays at a time (its
    (N, RI, SI) intermediates at 65,536 rays would take gigabytes)."""
    from normal_clustering_nerf_torch.ops import ray_march as rm
    o, d, cur, far, alive, mask, payload = args
    outs = [rm.march_rays_test_round_sv_plain(
        o[i:i + K1_CHUNK], d[i:i + K1_CHUNK], cur[i:i + K1_CHUNK],
        far[i:i + K1_CHUNK], alive[i:i + K1_CHUNK], mask, payload, **kw)
        for i in range(0, o.shape[0], K1_CHUNK)]
    return tuple(torch.cat(x) for x in zip(*outs))


def check_k1(tr, occ, train_in, test_in, tag, need_trunc, step):
    """K1 against its plain versions on one occupancy: the training
    launcher on the batch's rays with their march intervals at training
    step `step` (t, dt, valid, ray_count, rm_samples and the
    truncated-ray count identical), and TEST_ROUNDS rounds of the
    test-round launcher over the held-out rays, each round from the
    cursors the one before returned and with the K the renderer takes for
    the alive count (t, dt, valid and the next cursor identical). Returns
    the records of both launchers (the test round's at its first round)."""
    from normal_clustering_nerf_torch.models.rendering import (
        bucket_ladder, train_intervals, train_march_args)
    from normal_clustering_nerf_torch.ops import ray_march as rm
    cfg, m, chk, rec = tr.cfg, tr.cfg.model, Check(), {}
    lo, inf = math.sqrt(3.0) / m.max_samples, float("inf")

    o, d, noise = train_in[0], train_in[1], train_in[3]
    N = o.shape[0]
    hits = train_intervals(m, cfg.render, o, d, step)
    kw = train_march_args(m, cfg.render, N, "sv")
    args = (o, d, hits, occ.sv_mask, occ.sv_payload, noise)
    got = rm.march_rays_train_dense_sv(*args, **kw)
    ref = rm.march_rays_train_dense_sv_plain(*args, **kw)
    log(f"K1 train, {tag}: N={N} S={kw['march_steps']} K={ref.t.shape[1]} "
        f"RI={kw['n_intervals']}; rm/ray {int(ref.rm_samples) / N:.2f}, "
        f"rays over the interval budget {int(ref.trunc_rays)}")
    err = max(chk.equal(name, getattr(got, name), getattr(ref, name))
              for name in ("t", "dt", "valid", "ray_count", "rm_samples",
                           "trunc_rays"))
    if need_trunc and not int(ref.trunc_rays):
        raise RuntimeError("K1 check: no ray exceeded the interval budget")
    S, RI = kw["march_steps"], rm._sv_intervals(kw["n_intervals"],
                                                m.grid_size)
    t1, t2 = hits[:, 0], hits[:, 1]
    hit = t1 >= 0
    t0 = t1 + lo * noise
    t_end = torch.where(hit, torch.minimum(t2, t0 + S * lo),
                        torch.full_like(t2, -inf))
    probes, rows, steps = sv_work(o, d, t0, t_end, hit, occ, cfg, RI, S)
    log(f"  work: {probes} mask probes, {rows} payload rows, {steps} steps")
    rec["march_sv_train"] = dict(
        err=err, kernel=(lambda: rm.march_rays_train_dense_sv(*args, **kw)),
        plain=(lambda: rm.march_rays_train_dense_sv_plain(*args, **kw)),
        bound=bound(nbytes(o, d, hits, noise) + probes + 64 * rows
                    + nbytes(ref.t, ref.dt, ref.valid, ref.ray_count) + 8,
                    K1_STEP_OPS * steps))

    ro, rd, near, far = test_in
    Nt = ro.shape[0]
    cursor, alive = near, near >= 0
    rc = cfg.render
    rungs = bucket_ladder(Nt, max(1, rc.test_min_k))
    errs = []
    for r in range(TEST_ROUNDS):
        n_alive = int(alive.sum())
        K = next(k for b, k in rungs if b >= n_alive)
        tkw = dict(scale=m.scale, grid_size=m.grid_size,
                   max_samples=m.max_samples, n_steps=K,
                   n_intervals=rc.test_sv_intervals)
        targs = (ro, rd, cursor, far, alive, occ.sv_mask, occ.sv_payload)
        got = rm.march_rays_test_round_sv(*targs, **tkw)
        ref = test_round_plain(targs, tkw)
        log(f"K1 test round {r}, {tag}: N={Nt} alive {n_alive} K={K} "
            f"RI={rc.test_sv_intervals}; rays with all K samples "
            f"{int((ref[2].sum(1) == K).sum())}")
        errs += [chk.equal(name, a, b) for name, a, b in
                 zip(("t", "dt", "valid", "cursor"), got, ref)]
        if r == 0:
            hit = alive & (cursor >= 0)
            t_end = torch.where(hit, far, torch.full_like(far, -inf))
            probes, rows, steps = sv_work(ro, rd, cursor, t_end, hit, occ,
                                          cfg, rc.test_sv_intervals,
                                          m.max_samples)
            log(f"  work: {probes} mask probes, {rows} payload rows, "
                f"{steps} steps")
            rec["march_sv_test_round"] = dict(
                kernel=(lambda a=targs, k=tkw:
                        rm.march_rays_test_round_sv(*a, **k)),
                plain=(lambda a=targs, k=tkw: test_round_plain(a, k)),
                bound=bound(nbytes(ro, rd, cursor, far, alive) + probes
                            + 64 * rows + nbytes(*ref), K1_STEP_OPS * steps),
                first_round=(targs, tkw, ref))
        cursor, alive = ref[3], alive & (ref[3] < far)
    rec["march_sv_test_round"]["err"] = max(errs)
    chk.done(f"K1 checks, {tag}")
    return rec


ADV_RAYS = 512   # rays of each kind in K1's adversarial set


def adversarial_rays(tr, gen):
    """K1's adversarial set at the bench's grid, ADV_RAYS rays of each kind
    from `gen` (o, d, hits, noise): axis-parallel rays and components below
    1e-9; rays with equal x/y (and z) coordinates and directions, whose
    crossings of two or three axes tie at supervoxel edges and corners;
    hit rays whose t2 lies at or before t0 = t1 + lo*noise (t2 = t0, t2
    between t1 and t0, t2 = t1, t2 just below t1); rays along z at x = y =
    -c*1e-9, "crossing" the x and y planes through 0 together at t = c (an
    invalid piece, then the same supervoxel again) and, with d_y > 0, the x
    plane alone (two valid pieces of one supervoxel); random rays through
    the box, which cross more occupied supervoxels than the budget."""
    from normal_clustering_nerf_torch.models.rendering import near_intervals
    m, dev, n = tr.cfg.model, tr.device, ADV_RAYS
    lo = math.sqrt(3.0) / m.max_samples

    def u(*shape):
        return torch.rand(shape, generator=gen, device=dev)
    o = u(6 * n, 3) * 0.8 - 0.4
    d = torch.randn((6 * n, 3), generator=gen, device=dev)
    d = d / d.norm(dim=1, keepdim=True)
    hits = torch.tensor([0.01, 0.9], device=dev).repeat(6 * n, 1)
    noise = u(6 * n)
    k = torch.arange(n, device=dev)
    axis = torch.randint(0, 3, (n,), generator=gen, device=dev)
    sign = torch.where(u(n) < 0.5, -1.0, 1.0)
    tiny = (u(n, 3) - 0.5) * 1.8e-9 * (k % 2 == 1)[:, None]
    d[:n] = torch.where(torch.nn.functional.one_hot(axis, 3).bool(),
                        sign[:, None], tiny)
    t = slice(n, 2 * n)                      # ties
    o[t, 1] = o[t, 0]
    d[t, 1] = d[t, 0]
    o[t, 2] = torch.where(k % 2 == 0, o[t, 0], o[t, 2])
    d[t, 2] = torch.where(k % 2 == 0, d[t, 0], d[t, 2])
    t = slice(2 * n, 3 * n)                  # t0 at or past t_end
    t1 = hits[t, 0]
    t0 = t1 + lo * noise[t]
    hits[t, 1] = torch.stack([t0, t1 + 0.5 * (t0 - t1), t1, t1 - 1e-6],
                             1)[k, k % 4]
    t = slice(3 * n, 5 * n)                  # the 1e-9 denominator at x, y = 0
    o[t, :2] = (-(0.1 + 0.7 * u(2 * n)) * 1e-9)[:, None]
    o[t, 2] = -0.45
    d[t] = torch.tensor([0.0, 0.0, 1.0], device=dev)
    d[4 * n:5 * n] = torch.tensor([0.0, 0.6, 0.8], device=dev)
    o[4 * n:5 * n, 1] = -0.3
    hits[5 * n:] = near_intervals(m, o[5 * n:], d[5 * n:])
    return o.contiguous(), d.contiguous(), hits.contiguous(), noise


def check_k1_adversarial(tr, occ, gen):
    """Both K1 launchers bit-exact against their plain versions on
    `adversarial_rays`: the training launcher with the stratified tail
    (the bench's) and with first-K, TEST_ROUNDS test rounds from the
    rays' near points; every kind must occur in each. Returns the largest
    error (0.0 when exact)."""
    from normal_clustering_nerf_torch.models.rendering import train_march_args
    from normal_clustering_nerf_torch.ops import ray_march as rm
    m, rc, chk = tr.cfg.model, tr.cfg.render, Check()
    lo, inf = math.sqrt(3.0) / m.max_samples, float("inf")
    o, d, hits, noise = adversarial_rays(tr, gen)
    N = o.shape[0]
    errs, empty = [], []
    kw = train_march_args(m, rc, tr.cfg.data.batch_size, "sv")   # K 16
    for tail_k in (kw["tail_k"], 0):
        kw["tail_k"] = tail_k
        args = (o, d, hits, occ.sv_mask, occ.sv_payload, noise)
        got = rm.march_rays_train_dense_sv(*args, **kw)
        ref = rm.march_rays_train_dense_sv_plain(*args, **kw)
        S, t1, t2 = kw["march_steps"], hits[:, 0], hits[:, 1]
        hit = t1 >= 0
        t0 = t1 + lo * noise
        t_end = torch.where(hit, torch.minimum(t2, t0 + S * lo),
                            torch.full_like(t2, -inf))
        kinds = rm.sv_ray_kinds(
            o, d, t0, t_end, hit, occ.sv_mask, scale=m.scale,
            grid_size=m.grid_size,
            RI=rm._sv_intervals(kw["n_intervals"], m.grid_size))
        log(f"K1 train, adversarial set, tail_k {tail_k}: N={N}; rays of "
            f"each kind {kinds}; rm/ray {int(ref.rm_samples) / N:.2f}, "
            f"truncated {int(ref.trunc_rays)}")
        empty += [f"train tail_k {tail_k}: {k}" for k in rm.SV_RAY_KINDS
                  if not kinds[k]]
        errs += [chk.equal(name, getattr(got, name), getattr(ref, name))
                 for name in ("t", "dt", "valid", "ray_count", "rm_samples",
                              "trunc_rays")]
    cursor, far = hits[:, 0].contiguous(), hits[:, 1].contiguous()
    alive = cursor >= 0
    tkw = dict(scale=m.scale, grid_size=m.grid_size,
               max_samples=m.max_samples, n_steps=32,
               n_intervals=rc.test_sv_intervals)
    for r in range(TEST_ROUNDS):
        targs = (o, d, cursor, far, alive, occ.sv_mask, occ.sv_payload)
        got = rm.march_rays_test_round_sv(*targs, **tkw)
        ref = test_round_plain(targs, tkw)
        log(f"K1 test round {r}, adversarial set: N={N} K=32 "
            f"RI={rc.test_sv_intervals}")
        if r == 0:
            hit = alive & (cursor >= 0)
            kinds = rm.sv_ray_kinds(
                o, d, cursor, torch.where(hit, far, torch.full_like(far, -inf)),
                hit, occ.sv_mask, scale=m.scale, grid_size=m.grid_size,
                RI=rc.test_sv_intervals)
            log(f"  rays of each kind {kinds}")
            empty += [f"test round: {k}" for k in rm.SV_RAY_KINDS
                      if not kinds[k]]
        errs += [chk.equal(name, a, b) for name, a, b in
                 zip(("t", "dt", "valid", "cursor"), got, ref)]
        cursor, alive = ref[3], alive & (ref[3] < far)
    if empty:
        raise RuntimeError(f"K1 adversarial set: kinds with no ray: {empty}")
    chk.done("K1 checks, adversarial set")
    return max(errs)


def check_t_start(tr, first_round):
    """H3's forward with T_start against its plain version and its serial
    order (`check_composite_fwd`), on the samples of the held-out render's
    first round through the field, with T_start drawn per ray (an eighth
    of the rays just above T_threshold). Returns the largest error and
    the kernel's `variants` entry at this shape."""
    from normal_clustering_nerf_torch.models.rendering import field_raws
    from normal_clustering_nerf_torch.ops import composite as cp
    (ro, rd, *_), _, (t, dt, valid, _) = first_round
    Nt, K = t.shape
    with torch.no_grad():
        xyz = (ro[:, None, :] + t[..., None] * rd[:, None, :]).reshape(-1, 3)
        sig, raws = field_raws(tr.model, xyz, rd[:, None, :].expand(
            Nt, K, 3).reshape(-1, 3))
    gen = torch.Generator(device=tr.device).manual_seed(5)
    thr = tr.cfg.render.T_threshold
    T_start = torch.rand(Nt, generator=gen, device=tr.device)
    T_start[::8] = thr * (1.0 + 2.0 * T_start[::8])
    ca = (sig.reshape(Nt, K).contiguous(), raws.reshape(Nt, K, -1).contiguous(),
          dt, t, valid, thr, T_start)
    ref, got = cp.composite_plain(*ca), cp.composite_kernel(*ca)
    log(f"H3 composite with T_start: N={Nt} K={K} C={ca[1].shape[-1]}; rays "
        f"ended early {int((ref[4] < valid.sum(1)).sum())}")
    chk = Check()
    err = check_composite_fwd(chk, ca, got, ref)
    chk.done("H3 with T_start")
    return err, {f"first test round N={Nt} K={K}, T_start": (
        lambda: cp.composite_kernel(*ca))}


def steps_in(t0, t_end, hit, lo, S):
    """Per ray, the lattice steps t0 + k*lo (k < S) before t_end; 0 where
    the ray does not march."""
    n = torch.clamp(torch.ceil((t_end - t0) / lo), 0, S)
    return torch.where(hit, n, torch.zeros_like(n))


# H10's first-K cases past the renderer's ladder: K 48, not a multiple of
# 32, and K equal to the window (None)
WINDOW_KS = (48, None)


def window_rounds(chk, targs, mk, S_win, K, tag, rounds=TEST_ROUNDS):
    """H10's first-K mode at K (the window when None) over `rounds` rounds
    from the cursors of `targs` (rays_o, rays_d, cursor, t_far, alive,
    bitfield), each from the cursors the last returned: t, dt, valid and
    the cursor bit for bit the plain version's. Returns the errors."""
    from normal_clustering_nerf_torch.ops import ray_march as rm
    o, d, cursor, far, alive, bits = targs
    tkw = dict(mk, S_march=S_win, n_steps=K or S_win)
    errs = []
    for r in range(rounds):
        a = (o, d, cursor, far, alive, bits)
        got = rm.march_rays_test_round_window(*a, **tkw)
        ref = rm.march_rays_test_round_window_plain(*a, **tkw)
        log(f"H10 window round {r} at K={tkw['n_steps']}, {tag}: alive "
            f"{int(alive.sum())}, valid samples {int(ref[2].sum())}, rays "
            f"with K found {int((ref[2].sum(1) == tkw['n_steps']).sum())}")
        errs += [chk.equal(name, x, y) for name, x, y in
                 zip(("t", "dt", "valid", "cursor"), got, ref)]
        cursor = ref[3]
        alive = alive & (cursor < far)
    return errs


def window_chunks(targs, mk, S_win, K):
    """How many of the window's chunks of 32 steps the first K occupied
    steps of each ray that marches need (the K-th step's chunk; every
    chunk when the window holds fewer): a histogram over 1..ceil(S_win /
    32), from the plain full window's mask over the same steps."""
    from normal_clustering_nerf_torch.ops import ray_march as rm
    inc = rm.march_rays_test_round_dense_plain(
        *targs, **dict(mk, n_steps=S_win))[2]
    n_ch = -(-S_win // 32)
    kth = (torch.cumsum(inc.int(), 1) < K).sum(1)   # S_win when fewer
    need = torch.where(kth < S_win, kth // 32 + 1, torch.full_like(kth, n_ch))
    marches = targs[4] & (targs[2] >= 0)
    return torch.bincount(need[marches], minlength=n_ch + 1)[1:].tolist()


def check_bitfield(tr, occ, train_in, test_in, tag, need_trunc, step):
    """H9, H10 and H11 against their plain versions on one occupancy: the
    fine march (H9) on the batch's rays with their march intervals at
    training step `step`, and the two-level march with COARSE_K_BLOCKS
    candidate blocks; H11 compacting the fine march's samples into the
    flat training budget and into half the samples (a budget that drops
    the tail); TEST_ROUNDS rounds of each H10 mode over the held-out rays,
    each from the cursors the last returned (the full window of
    test_n_samples steps, compacted by H11 into its N * n_steps budget, and
    the first K of a test_march_window window with the renderer's K, and
    with K of WINDOW_KS; the chunks the first window round's rays need
    logged); and H10's full window at P2's (8192, 1024) block, beside P2's
    own form in torch. Sample sets, counts and cursors must be identical.
    Returns the records of the three launchers and the flat batch for the
    segment checks."""
    from normal_clustering_nerf_torch.models.rendering import (
        bucket_ladder, train_intervals, train_march_args)
    from normal_clustering_nerf_torch.ops import ray_march as rm
    cfg, m, rc, chk, rec = tr.cfg, tr.cfg.model, tr.cfg.render, Check(), {}
    lo = math.sqrt(3.0) / m.max_samples
    bits = occ.density_bitfield
    o, d, noise = train_in[0], train_in[1], train_in[3]
    N = o.shape[0]
    hits = train_intervals(m, rc, o, d, step)
    kw = train_march_args(m, rc, N, "fine")
    args = (o, d, hits, bits, noise)
    errs = []
    for name, extra in (("fine", {}), ("two-level", dict(
            coarse_occ=occ.coarse_occ, coarse_k_blocks=COARSE_K_BLOCKS))):
        k = dict(kw, **extra)
        got = rm.march_rays_train_dense(*args, **k)
        ref = rm.march_rays_train_dense_plain(*args, **k)
        log(f"H9 {name}, {tag}: N={N} S={k['march_steps']} "
            f"K={ref.t.shape[1]}{' KB=%d' % COARSE_K_BLOCKS if extra else ''}"
            f"; rm/ray {int(ref.rm_samples) / N:.2f}, truncated rays "
            f"{int(ref.trunc_rays)}")
        errs += [chk.equal(f, getattr(got, f), getattr(ref, f)) for f in
                 ("t", "dt", "valid", "ray_count", "rm_samples", "trunc_rays")]
        if extra and need_trunc and not int(ref.trunc_rays):
            raise RuntimeError("H9 check: the two-level budget cut no ray")
        if not extra:
            fine = ref
    S = kw["march_steps"]
    t1, t2 = hits[:, 0], hits[:, 1]
    probes = int(steps_in(t1 + lo * noise, t2, t1 >= 0, lo, S).sum())
    log(f"  work: {probes} steps inside the box")
    rec["march_fine_train"] = dict(
        err=max(errs), kernel=(lambda: rm.march_rays_train_dense(*args, **kw)),
        plain=(lambda: rm.march_rays_train_dense_plain(*args, **kw)),
        bound=bound(nbytes(o, d, hits, noise, bits, fine.t, fine.dt,
                           fine.valid, fine.ray_count) + 8,
                    STEP_OPS * probes))

    # H11: the flat training batch (the fine march's samples, H9 at the
    # per-ray cap) and a budget that drops half of them
    budget = rc.sample_budget or N * 32
    cargs = (fine.valid, fine.t, fine.dt)
    cerrs = []
    for B in (budget, int(fine.rm_samples) // 2):
        got = rm.compact_samples(*cargs, B)
        ref = rm.compact_samples_plain(*cargs, B)
        log(f"H11 compact, {tag}: N={N} S={fine.t.shape[1]} B={B}, "
            f"{int(ref.rm_samples)} samples, {int(ref.valid.sum())} kept")
        cerrs += [chk.equal(f, getattr(got, f), getattr(ref, f))
                  for f in rm.MarchResult._fields]
        if B == budget:
            flat = got
    # H11 at its edges: the one ray with the most samples, an all-empty
    # batch, and rows of 13 steps (not 16-byte rows: byte loads)
    one = int(fine.ray_count.argmax())
    S13 = 13
    for what, ca, B in (
            ("N = 1", tuple(x[one:one + 1].contiguous() for x in cargs),
             fine.t.shape[1]),
            ("all empty", (torch.zeros_like(fine.valid),) + cargs[1:], budget),
            (f"S = {S13}", tuple(x[:, :S13].contiguous() for x in cargs),
             N * S13 // 2)):
        got = rm.compact_samples(*ca, B)
        ref = rm.compact_samples_plain(*ca, B)
        log(f"H11 compact, {what}, {tag}: N={ca[0].shape[0]} "
            f"S={ca[0].shape[1]} B={B}, {int(ref.rm_samples)} samples, "
            f"{int(ref.valid.sum())} kept")
        cerrs += [chk.equal(f"{what}: {f}", getattr(got, f), getattr(ref, f))
                  for f in rm.MarchResult._fields]
    rec["compact_samples"] = dict(
        kernel=(lambda: rm.compact_samples(*cargs, budget)),
        plain=(lambda: rm.compact_samples_plain(*cargs, budget)),
        bound=bound(nbytes(*cargs) + nbytes(*flat[:6]) + 4, 0))

    # H10, both modes, over the held-out rays
    ro, rd, near, far = test_in
    Nt = ro.shape[0]
    mk = dict(cascades=m.cascades, scale=m.scale,
              exp_step_factor=m.exp_step_factor, grid_size=m.grid_size,
              max_samples=m.max_samples)
    S_win, n_steps = rc.test_march_window, rc.test_n_samples
    rungs = bucket_ladder(Nt, max(1, rc.test_min_k), S_win)
    errs = []
    for mode in ("full", "window"):
        cursor, alive = near, near >= 0
        for r in range(TEST_ROUNDS):
            n_alive = int(alive.sum())
            if mode == "full":
                tkw = dict(mk, n_steps=n_steps)
                fn, pfn = (rm.march_rays_test_round_dense,
                           rm.march_rays_test_round_dense_plain)
            else:
                K = next(k for b, k in rungs if b >= n_alive)
                tkw = dict(mk, S_march=S_win, n_steps=K)
                fn, pfn = (rm.march_rays_test_round_window,
                           rm.march_rays_test_round_window_plain)
            targs = (ro, rd, cursor, far, alive, bits)
            got, ref = fn(*targs, **tkw), pfn(*targs, **tkw)
            log(f"H10 {mode} round {r}, {tag}: N={Nt} alive {n_alive} "
                + (f"S={n_steps}" if mode == "full" else
                   f"S_march={S_win} K={tkw['n_steps']}")
                + f"; valid samples {int(ref[2].sum())}")
            errs += [chk.equal(name, a, b) for name, a, b in
                     zip(("t", "dt", "valid", "cursor"), got, ref)]
            if mode == "full" and r == 0:
                # the flat test round: H11 on the window, budget N * n_steps
                cg = rm.compact_samples(ref[2], ref[0], ref[1], Nt * n_steps)
                cr = rm.compact_samples_plain(ref[2], ref[0], ref[1],
                                              Nt * n_steps)
                cerrs += [chk.equal(f"compact {f}", getattr(cg, f),
                                    getattr(cr, f))
                          for f in rm.MarchResult._fields]
                flat_round = (targs, tkw, cg)
            if mode == "window" and r == 0:
                hit = alive & (cursor >= 0)
                probed = int(steps_in(cursor, torch.minimum(ref[3], far), hit,
                                      lo, S_win).sum())
                log(f"  work: {probed} steps probed; rays needing 1.."
                    f"{-(-S_win // 32)} chunks of 32 steps: "
                    f"{window_chunks(targs, mk, S_win, tkw['n_steps'])}")
                rec["march_fine_test_round"] = dict(
                    kernel=(lambda a=targs, k=tkw, f=fn: f(*a, **k)),
                    plain=(lambda a=targs, k=tkw, f=pfn: f(*a, **k)),
                    bound=bound(nbytes(ro, rd, cursor, far, alive, bits)
                                + nbytes(*ref), STEP_OPS * probed))
            cursor = ref[3]
            alive = alive & (cursor < far)
    for K in WINDOW_KS:
        errs += window_rounds(chk, (ro, rd, near, far, near >= 0, bits), mk,
                              S_win, K, tag)
    rec["compact_samples"]["err"] = max(cerrs)

    # H10's full window at P2's block: the first 8192 held-out rays from
    # their near ends, 1024 steps; P2's form on the int32 words and the
    # plain version's cells
    pr, pd = ro[:P2_RAYS].contiguous(), rd[:P2_RAYS].contiguous()
    pc, pf = near[:P2_RAYS].contiguous(), far[:P2_RAYS].contiguous()
    pa = pc >= 0
    pkw = dict(mk, n_steps=P2_STEPS)
    pargs = (pr, pd, pc, pf, pa, bits)
    got = rm.march_rays_test_round_dense(*pargs, **pkw)
    ref = rm.march_rays_test_round_dense_plain(*pargs, **pkw)
    G, mb = m.grid_size, min(0.5, m.scale)
    xyz = pr[:, None, :] + ref[0][..., None] * pd[:, None, :]
    cell = torch.clamp(0.5 * (xyz / mb + 1.0) * G, 0.0, G - 1.0).to(torch.int64)
    cells = ((cell[..., 2] * G + cell[..., 1]) * G + cell[..., 0]).to(
        torch.int32).contiguous()
    words = bits.view(torch.int32)

    def p2_probe():
        return (words[cells >> 5] >> (cells & 31)) & 1
    in_range = pa[:, None] & (ref[0] < pf[:, None])
    log(f"H10 full window at P2's block, {tag}: {P2_RAYS} x {P2_STEPS}, "
        f"{int(in_range.sum())} steps in range, {int(ref[2].sum())} occupied")
    errs.append(max(chk.equal(name, a, b) for name, a, b in
                    zip(("t", "dt", "valid", "cursor"), got, ref)))
    errs.append(chk.equal("P2's form, in range", (p2_probe() > 0) & in_range,
                          got[2]))
    n_in = int(in_range.sum())
    rec["march_fine_test_round"]["err"] = max(errs)
    rec["march_fine_test_round"]["at_p2_shape"] = dict(
        kernel=(lambda: rm.march_rays_test_round_dense(*pargs, **pkw)),
        library=p2_probe,
        bound=bound(nbytes(pr, pd, pc, pf, pa, bits) + nbytes(*got),
                    STEP_OPS * n_in + 2 * (P2_RAYS * P2_STEPS - n_in)))
    chk.done(f"H9-H11 checks, {tag}")
    return rec, (hits, noise, flat), flat_round


SCALE_03 = 0.3   # a scene scale whose mip bound is not a power of two


def check_scale(tr, occ, gen, scale=SCALE_03):
    """H9 (the fine and the two-level march) and H10 (a full-window and a
    window round, and TEST_ROUNDS window rounds at each K of WINDOW_KS)
    against their plain versions at scene scale `scale`,
    where the mip bound is not a power of two: the plain versions' x / mb
    (`occupancy_lookup`, `coarse_lookup`) must divide as the kernels'
    __fdiv_rn does, not as a product with the reciprocal. N rays from
    inside the box, random directions, on the occupancy `occ`. Returns
    the largest error (0: every output identical)."""
    from normal_clustering_nerf_torch.models.rendering import (
        bucket_ladder, near_intervals, train_march_args)
    from normal_clustering_nerf_torch.ops import ray_march as rm
    rc, dev, N = tr.cfg.render, tr.device, tr.sampler.batch_size
    m = dataclasses.replace(tr.cfg.model, scale=scale)
    o = ((torch.rand((N, 3), generator=gen, device=dev) * 2.0 - 1.0)
         * (0.9 * scale)).contiguous()
    d = torch.randn((N, 3), generator=gen, device=dev)
    d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    hits = near_intervals(m, o, d).contiguous()
    noise = torch.rand(N, generator=gen, device=dev)
    bits, chk, errs = occ.density_bitfield, Check(), []
    kw = train_march_args(m, rc, N, "fine")
    for name, extra in (("fine", {}), ("two-level", dict(
            coarse_occ=occ.coarse_occ, coarse_k_blocks=COARSE_K_BLOCKS))):
        k = dict(kw, **extra)
        got = rm.march_rays_train_dense(o, d, hits, bits, noise, **k)
        ref = rm.march_rays_train_dense_plain(o, d, hits, bits, noise, **k)
        log(f"H9 {name} at scale {scale}: N={N} S={k['march_steps']} "
            f"K={ref.t.shape[1]}; rm/ray {int(ref.rm_samples) / N:.2f}, "
            f"truncated rays {int(ref.trunc_rays)}")
        errs += [chk.equal(f, getattr(got, f), getattr(ref, f)) for f in
                 ("t", "dt", "valid", "ray_count", "rm_samples", "trunc_rays")]
    mk = dict(cascades=m.cascades, scale=scale,
              exp_step_factor=m.exp_step_factor, grid_size=m.grid_size,
              max_samples=m.max_samples)
    cursor, far = hits[:, 0].contiguous(), hits[:, 1].contiguous()
    alive = cursor >= 0
    K = next(k for b, k in bucket_ladder(N, max(1, rc.test_min_k),
                                         rc.test_march_window)
             if b >= int(alive.sum()))
    for mode, fn, pfn, tkw in (
            ("full", rm.march_rays_test_round_dense,
             rm.march_rays_test_round_dense_plain,
             dict(mk, n_steps=rc.test_n_samples)),
            ("window", rm.march_rays_test_round_window,
             rm.march_rays_test_round_window_plain,
             dict(mk, S_march=rc.test_march_window, n_steps=K))):
        targs = (o, d, cursor, far, alive, bits)
        got, ref = fn(*targs, **tkw), pfn(*targs, **tkw)
        log(f"H10 {mode} round at scale {scale}: N={N}, valid samples "
            f"{int(ref[2].sum())}")
        errs += [chk.equal(name, a, b) for name, a, b in
                 zip(("t", "dt", "valid", "cursor"), got, ref)]
    for K in WINDOW_KS:
        errs += window_rounds(chk, (o, d, cursor, far, alive, bits), mk,
                              rc.test_march_window, K, f"scale {scale}")
    chk.done(f"H9 / H10 at scale {scale}")
    return max(errs)


# scene scales past 0.5: 2, 2, 3 and 6 cascades, the geometric step grid;
# at 0.75 the top cascade's bound is not a power of two
CASCADE_SCALES = (0.75, 1.0, 2.0, 16.0)
# f32 operations per probed step of the general grid (`Cascades` in
# csrc/march_fine.cu), each powf or logf counted as one: t_k (at most 4,
# powf among them), calc_dt (3), three positions (6), the mip (16: |x|,
# the max, two frexp, clamps), its bound and reciprocal (3), three cells
# (18); and per ray the phase bounds (12, one logf and one powf)
CASCADE_STEP_OPS, CASCADE_RAY_OPS = 50, 12


def grid_probes(t0, t2, hit, kw, S):
    """Steps t_k (k < S) of each ray's grid from t0 (`t_step_grid` at the
    march keywords `kw`) before t2, summed over the rays that march."""
    from normal_clustering_nerf_torch.ops import ray_march as rm
    tg = rm.t_step_grid(t0, S, exp_step_factor=kw["exp_step_factor"],
                        max_samples=kw["max_samples"],
                        grid_size=kw["grid_size"], scale=kw["scale"])
    return int(((tg < t2[:, None]) & hit[:, None]).sum())


def mip_shares(o, d, t, keep, m, max_samples):
    """The share of the samples `t` (N, S) where `keep` at each cascade of
    the model config `m`, as `cell_index` places them."""
    from normal_clustering_nerf_torch.ops import ray_march as rm
    dt = rm.calc_dt(t, m.exp_step_factor, max_samples, m.grid_size, m.scale)
    xyz = o[:, None, :] + t[..., None] * d[:, None, :]
    mip = rm.cell_index(xyz, cascades=m.cascades, scale=m.scale,
                        grid_size=m.grid_size, dt=dt) // m.grid_size ** 3
    n = torch.bincount(mip[keep], minlength=m.cascades)
    return [round(float(c) / max(int(n.sum()), 1), 4) for c in n]


def cascade_march_inputs(m, N, gen, dev, density=0.2):
    """N rays for the scene scale of `m`: origins in 1.2x its box (some
    outside it, some of those missing it), random directions, their
    near-clamped box intervals, march noise, and a random occupancy of
    `density` over every cascade's cells."""
    from normal_clustering_nerf_torch.models.rendering import near_intervals
    from normal_clustering_nerf_torch.ops.packbits import packbits
    s = m.scale
    o = ((torch.rand((N, 3), generator=gen, device=dev) * 2.0 - 1.0)
         * (1.2 * s)).contiguous()
    d = torch.randn((N, 3), generator=gen, device=dev)
    d = (d / d.norm(dim=-1, keepdim=True)).contiguous()
    hits = near_intervals(m, o, d).contiguous()
    noise = torch.rand(N, generator=gen, device=dev)
    occ = torch.rand(m.cascades * m.grid_size ** 3, generator=gen,
                     device=dev) < density
    return o, d, hits, packbits(occ.float(), 0.5), noise


def cascade_adversarial_inputs(m, N, gen, dev, density=0.2):
    """N rays at the scene scale of `m` that reach the step grid's edges,
    in three groups: the camera at the box's centre (the geometric phase
    from the near end on: past 1024 steps, jB > S, at scale 16; past 128
    everywhere for the bootstrap march's grid), rays from origins past
    B = hi/f aimed at points inside the box (tA > B, jB = 0: steps of hi
    from the start), and rays from the centre whose near end is the first
    float past A = lo/f of the fine grid (kA = 0 and jB >= the test
    windows, so that an H10 cursor S steps on reads the table's last
    entry, j = S); their box intervals (the third group's near end set),
    march noise and a random occupancy of `density` over every cascade's
    cells. Returns (o, d, hits, bitfield, noise)."""
    from normal_clustering_nerf_torch.models.rendering import near_intervals
    from normal_clustering_nerf_torch.ops.packbits import packbits
    s = m.scale
    hi = math.sqrt(3.0) * 2.0 * s / m.grid_size
    lo = math.sqrt(3.0) / m.max_samples
    A, B = lo / m.exp_step_factor, hi / m.exp_step_factor
    d = torch.randn((N, 3), generator=gen, device=dev)
    d = d / d.norm(dim=-1, keepdim=True)
    n3 = N // 3
    group = torch.arange(N, device=dev) // max(n3, 1)
    far = group == 1
    aim = (torch.rand((N, 3), generator=gen, device=dev) * 1.8 - 0.9) * s
    o = torch.where(far[:, None], aim - (B + 2.0 * math.sqrt(3.0) * s) * d,
                    torch.zeros_like(d))
    o, d = o.contiguous(), d.contiguous()
    hits = near_intervals(m, o, d)
    past_a = float(np.nextafter(np.float32(A), np.float32(np.inf)))
    cursor = group >= 2
    hits[:, 0] = torch.where(cursor, torch.full_like(hits[:, 0], past_a),
                             hits[:, 0])
    hits = hits.contiguous()
    if not bool((hits[far, 0] > B).all()):
        raise RuntimeError("adversarial rays: a far ray starts before B")
    noise = torch.rand(N, generator=gen, device=dev)
    occ = torch.rand(m.cascades * m.grid_size ** 3, generator=gen,
                     device=dev) < density
    return o, d, hits, packbits(occ.float(), 0.5), noise


def check_cascades(tr, gen, scales=CASCADE_SCALES):
    """H1 (the bootstrap march), H9 (the fine march, and the flat march
    through H11) and H10 (TEST_ROUNDS rounds of each mode from the cursors
    the last returned, and of the first-K mode at each K of WINDOW_KS; H11
    on the first full window, as a flat test round compacts it; the chunks
    the first window round's rays need logged) against their plain
    versions at the scene scales
    past 0.5 (several cascades, the geometric step grid), on
    `cascade_march_inputs` and on `cascade_adversarial_inputs` at the
    bench's grid, batch and steps: outputs identical (the kernels read
    (1 + f)^j from a table that torch.pow built, the plain versions'
    own expression, and their per-ray logf and powf are CUDA's, as the
    plain versions' torch.log and torch.pow on the card). Logs the share
    of the fine march's in-range probes at each mip. Returns the largest
    error of each launcher."""
    from normal_clustering_nerf_torch.models.rendering import (
        bucket_ladder, train_march_args)
    from normal_clustering_nerf_torch.ops import ray_march as rm
    rc, dev, N = tr.cfg.render, tr.device, tr.sampler.batch_size
    errs = {k: [] for k in ("march_bootstrap", "march_fine_train",
                            "compact_samples", "march_fine_test_round")}
    chk = Check()
    for scale, rays in ((s, r) for s in scales
                        for r in ("random", "adversarial")):
        m = dataclasses.replace(tr.cfg.model, scale=scale)
        make = (cascade_march_inputs if rays == "random"
                else cascade_adversarial_inputs)
        o, d, hits, bits, noise = make(m, N, gen, dev)
        args = (o, d, hits, bits, noise)
        t1, t2 = hits[:, 0], hits[:, 1]
        log(f"scale {scale}, {rays} rays: {m.cascades} cascades, "
            f"exp_step_factor {m.exp_step_factor}, N={N}, "
            f"{int((t1 >= 0).sum())} rays hit the box")
        for kind, name, fn in (
                ("bootstrap", "march_bootstrap", rm.march_rays_train_bootstrap),
                ("fine", "march_fine_train", rm.march_rays_train_dense)):
            kw = train_march_args(m, rc, N, kind)
            if kind == "fine":
                kw["coarse_occ"] = None
            got = fn(*args, **kw)
            ref = rm.march_rays_train_dense_plain(*args, **kw)
            t0 = t1 + rm.calc_dt(t1, m.exp_step_factor, kw["max_samples"],
                                 m.grid_size, scale) * noise
            tg = rm.t_step_grid(t0, kw["march_steps"],
                                exp_step_factor=m.exp_step_factor,
                                max_samples=kw["max_samples"],
                                grid_size=m.grid_size, scale=scale)
            probed = (t1 >= 0)[:, None] & (tg < t2[:, None])
            _, _, _, jB, _ = rm.step_phases(
                t0, exp_step_factor=m.exp_step_factor,
                max_samples=kw["max_samples"], grid_size=m.grid_size,
                scale=scale)
            log(f"{'H1' if kind == 'bootstrap' else 'H9'} {kind} at scale "
                f"{scale}, {rays} rays: S={kw['march_steps']} "
                f"K={ref.t.shape[1]}; rays with jB > S "
                f"{int(((jB > kw['march_steps']) & (t1 >= 0)).sum())}; rm/ray "
                f"{int(ref.rm_samples) / N:.2f}; in-range probes "
                f"{int(probed.sum())}, by mip "
                f"{mip_shares(o, d, tg, probed, m, kw['max_samples'])}; kept "
                f"samples by mip "
                f"{mip_shares(o, d, ref.t, ref.valid, m, kw['max_samples'])}")
            errs[name] += [chk.equal(f, getattr(got, f), getattr(ref, f))
                           for f in ("t", "dt", "valid", "ray_count",
                                     "rm_samples", "trunc_rays")]
            if kind == "fine":
                fine_kw = kw
        # the flat march: H9 at the per-ray cap, compacted by H11
        budget = rc.sample_budget or N * 32
        fkw = {k: v for k, v in fine_kw.items()
               if k not in ("samples_per_ray", "coarse_occ",
                            "coarse_k_blocks")}
        got = rm.march_rays_train(*args, sample_budget=budget,
                                  per_ray_cap=fine_kw["samples_per_ray"],
                                  **fkw)
        dense = rm.march_rays_train_dense_plain(*args, **fine_kw)
        ref = rm.compact_samples_plain(dense.valid, dense.t, dense.dt, budget)
        log(f"H9 + H11 flat at scale {scale}, {rays} rays: B={budget}, "
            f"{int(ref.valid.sum())} kept")
        errs["compact_samples"] += [chk.equal(f"flat {f}", getattr(got, f),
                                              getattr(ref, f))
                                    for f in rm.MarchResult._fields]
        # H10, both modes, TEST_ROUNDS rounds each
        mk = dict(cascades=m.cascades, scale=scale,
                  exp_step_factor=m.exp_step_factor, grid_size=m.grid_size,
                  max_samples=m.max_samples)
        rungs = bucket_ladder(N, max(4, rc.test_min_k), rc.test_march_window)
        for mode in ("full", "window"):
            cursor, far = t1.contiguous(), t2.contiguous()
            alive = cursor >= 0
            for r in range(TEST_ROUNDS):
                if mode == "full":
                    tkw = dict(mk, n_steps=rc.test_n_samples)
                    fn, pfn = (rm.march_rays_test_round_dense,
                               rm.march_rays_test_round_dense_plain)
                else:
                    K = next(k for b, k in rungs if b >= int(alive.sum()))
                    tkw = dict(mk, S_march=rc.test_march_window, n_steps=K)
                    fn, pfn = (rm.march_rays_test_round_window,
                               rm.march_rays_test_round_window_plain)
                targs = (o, d, cursor, far, alive, bits)
                got, ref = fn(*targs, **tkw), pfn(*targs, **tkw)
                log(f"H10 {mode} round {r} at scale {scale}, {rays} rays: "
                    f"alive {int(alive.sum())}, valid samples "
                    f"{int(ref[2].sum())}"
                    + (f"; rays needing 1.. chunks of 32 steps "
                       f"{window_chunks(targs, mk, rc.test_march_window, K)}"
                       if mode == "window" and r == 0 else ""))
                errs["march_fine_test_round"] += [
                    chk.equal(name, a, b) for name, a, b in
                    zip(("t", "dt", "valid", "cursor"), got, ref)]
                if mode == "full" and r == 0:
                    # a flat test round: H11 on the window, N * n_steps slots
                    cb = N * tkw["n_steps"]
                    cg = rm.compact_samples(ref[2], ref[0], ref[1], cb)
                    cr = rm.compact_samples_plain(ref[2], ref[0], ref[1], cb)
                    errs["compact_samples"] += [
                        chk.equal(f"round compact {f}", getattr(cg, f),
                                  getattr(cr, f))
                        for f in rm.MarchResult._fields]
                cursor = ref[3]
                alive = alive & (cursor < far)
        for K in WINDOW_KS:
            errs["march_fine_test_round"] += window_rounds(
                chk, (o, d, t1.contiguous(), t2.contiguous(), t1 >= 0, bits),
                mk, rc.test_march_window, K, f"scale {scale}, {rays} rays")
    chk.done(f"H1 / H9 / H10 at scales {scales}")
    return {k: max(v) for k, v in errs.items()}


def dense_of(mr, x, n_rays, width):
    """The flat slots of `mr` laid out as dense (N, width) rows."""
    from normal_clustering_nerf_torch.ops.segops import (
        segment_slots, to_segments)
    pos = segment_slots(mr.ray_id, mr.ray_start)
    return to_segments(x, mr.ray_id, pos, mr.valid, n_rays,
                       width).contiguous()


def check_segments(tr, train_in, flat_in, flat_round, gen):
    """H3's and H4's segment launchers against their plain versions and,
    bit for bit, against the dense launchers on the same samples: on the
    flat training batch (the field's sigmas, and the same scaled by
    10^U(0, 4) per ray so that rays end early and sigma*delta reaches the
    clip), and the forward with T_start on the first flat test round's
    samples. The backward also at max_len = the flat march's cap (the
    bound the training step passes), bit for bit the same as at the
    longest segment's. Returns the four launchers' records (timed on the
    batch; the backward at the cap, as the training step calls it)."""
    from normal_clustering_nerf_torch.models.rendering import (
        field_raws, train_march_args)
    from normal_clustering_nerf_torch.ops import composite as cp
    from normal_clustering_nerf_torch.ops import distortion as ds
    from normal_clustering_nerf_torch.ops.ray_march import flat_cap
    o, d = train_in[0], train_in[1]
    _, _, mr = flat_in
    N, B, K = o.shape[0], mr.t.shape[0], int(mr.ray_count.max())
    m = tr.cfg.model
    cap = flat_cap(m.max_samples, train_march_args(
        m, tr.cfg.render, N, "fine")["samples_per_ray"])
    rid = mr.ray_id.long()
    with torch.no_grad():
        sig, raws = field_raws(tr.model, o[rid] + mr.t[:, None] * d[rid],
                               d[rid])
    sig, raws = sig.float().contiguous(), raws.float().contiguous()
    C, thr = raws.shape[-1], tr.cfg.render.T_threshold
    seg = (mr.ray_start, mr.ray_count)
    dense = {k: dense_of(mr, x, N, K) for k, x in
             (("dt", mr.dt), ("t", mr.t), ("valid", mr.valid))}
    scale = 10.0 ** (4.0 * torch.rand(N, generator=gen, device=o.device))
    gs = (torch.randn(N, generator=gen, device=o.device),
          torch.randn(N, generator=gen, device=o.device),
          torch.randn((N, C), generator=gen, device=o.device),
          torch.randn(B, generator=gen, device=o.device))
    gl = torch.randn(N, generator=gen, device=o.device)
    chk, errs = Check(), {k: [] for k in ("composite_seg_fwd",
                                          "composite_seg_bwd",
                                          "distortion_seg_fwd",
                                          "distortion_seg_bwd")}
    v = mr.valid
    pos = (torch.arange(B, device=o.device) - mr.ray_start.long()[rid])[v]
    at = (rid[v], pos)
    for tag, s in (("main", sig), ("opaque", (sig * scale[rid]).contiguous())):
        ca = (s, raws, mr.dt, mr.t, mr.ray_id, mr.ray_start, v, N, thr)
        ka = (s, raws, mr.dt, mr.t, *seg, v, thr)
        ref = cp.composite_compact_plain(*ca)
        got = cp.composite_compact_kernel(*ka)
        dd = (dense_of(mr, s, N, K), dense_of(mr, raws, N, K), dense["dt"],
              dense["t"], dense["valid"], thr)
        dg = cp.composite_kernel(*dd)
        log(f"H3 segments, {tag} sigmas: N={N} B={B} (longest {K}) C={C}; "
            f"rays ended early {int((ref[4] < mr.ray_count).sum())}, "
            f"samples clipped {int((v & (s * mr.dt >= cp.SIGDT_MAX)).sum())}")
        errs["composite_seg_fwd"].append(max(
            chk.close("opacity", got[0], ref[0], 1e-5),
            chk.close("depth", got[1], ref[1], 1e-5),
            chk.close("rend", got[2], ref[2], 1e-5),
            chk.close("ws", got[3], ref[3], 1e-5),
            chk.equal("vr_samples", got[4], ref[4]),
            *(chk.equal(f"{n} = dense H3", got[i], dg[i]) for n, i in
              (("opacity", 0), ("depth", 1), ("rend", 2), ("vr_samples", 4))),
            chk.equal("ws = dense H3", got[3][v], dg[3][at])))
        gref = cp.composite_compact_grad_plain(*ca, *gs)
        ggot = cp.composite_compact_grad_kernel(*ka, *gs)
        gcap = cp.composite_compact_grad_kernel(*ka, *gs, max_len=cap)
        gdn = cp.composite_grad_kernel(*dd, *gs[:3], dense_of(mr, gs[3], N, K))
        log(f"H3 segment backward, {tag} sigmas: max_len {K} (read from the "
            f"counts) and {cap} (the march's cap)")
        errs["composite_seg_bwd"].append(max(
            chk.close("d_sigmas", ggot[0], gref[0], 1e-4),
            chk.close("d_raws", ggot[1], gref[1], 1e-5),
            chk.equal("d_sigmas = dense H3", ggot[0][v], gdn[0][at]),
            chk.equal("d_raws = dense H3", ggot[1][v], gdn[1][at]),
            chk.equal("d_sigmas at max_len = cap", gcap[0], ggot[0]),
            chk.equal("d_raws at max_len = cap", gcap[1], ggot[1])))
        da = (ref[3].contiguous(), mr.dt, mr.t)
        dref = ds.distortion_compact_plain(*da, mr.ray_id, mr.ray_start, v, N)
        dgot = ds.distortion_compact_kernel(*da, v, *seg)
        ddn = (dense_of(mr, ref[3], N, K), dense["dt"], dense["t"],
               dense["valid"])
        log(f"H4 segments, {tag} sigmas: N={N} B={B}")
        errs["distortion_seg_fwd"].append(max(
            chk.close("loss", dgot, dref, 1e-5),
            chk.equal("loss = dense H4", dgot, ds.distortion_kernel(*ddn)),
            chk.equal("loss = serial order", dgot, distortion_serial(*ddn))))
        gg = ds.distortion_compact_grad_kernel(gl, *da, v, *seg)
        errs["distortion_seg_bwd"].append(max(
            chk.close("d_ws", gg, ds.distortion_compact_grad_plain(
                gl, *da, mr.ray_id, mr.ray_start, v, N), 1e-4),
            chk.equal("d_ws = dense H4", gg[v],
                      ds.distortion_grad_kernel(gl, *ddn)[at]),
            chk.equal("d_ws = serial order", gg[v],
                      distortion_serial(*ddn, gl)[at])))
        if tag == "main":
            mka, mda, mref = ka, da, ref
    errs["composite_seg_bwd"].append(check_seg_lengths(chk, C, thr, gen))
    errs["composite_seg_bwd"].append(check_seg_cap(chk, C, thr, gen))
    errs["composite_seg_fwd"].append(check_seg_fwd_lengths(chk, C, thr, gen))
    for k, e in zip(("distortion_seg_fwd", "distortion_seg_bwd"),
                    check_seg_distortion_lengths(chk, gen)):
        errs[k].append(e)
    ka, da = mka, mda
    n_valid = int(v.sum())
    flops = n_valid * (10 + 2 * C)
    in_b = nbytes(*ka[:4], v, *seg)
    rec = {
        "composite_seg_fwd": dict(
            kernel=(lambda: cp.composite_compact_kernel(*ka)),
            plain=(lambda: cp.composite_compact_plain(
                *ka[:4], mr.ray_id, mr.ray_start, v, N, thr)),
            bound=bound(in_b + nbytes(*mref), flops)),
        "composite_seg_bwd": dict(
            kernel=(lambda: cp.composite_compact_grad_kernel(
                *ka, *gs, max_len=cap)),
            plain=(lambda: cp.composite_compact_grad_plain(
                *ka[:4], mr.ray_id, mr.ray_start, v, N, thr, *gs)),
            bound=bound(in_b + nbytes(*gs) + nbytes(sig, raws),
                        2 * flops + n_valid * C * 3)),
        "distortion_seg_fwd": dict(
            kernel=(lambda: ds.distortion_compact_kernel(*da, v, *seg)),
            plain=(lambda: ds.distortion_compact_plain(
                *da, mr.ray_id, mr.ray_start, v, N)),
            bound=bound(nbytes(*da, v, *seg) + 4 * N, n_valid * 12)),
        "distortion_seg_bwd": dict(
            kernel=(lambda: ds.distortion_compact_grad_kernel(
                gl, *da, v, *seg)),
            plain=(lambda: ds.distortion_compact_grad_plain(
                gl, *da, mr.ray_id, mr.ray_start, v, N)),
            bound=bound(nbytes(gl, *da, v, *seg) + nbytes(da[0]),
                        n_valid * 18))}

    # the forward with T_start on the first flat test round's samples
    (ro, rd, *_), _, tm = flat_round
    Nt, Kt = ro.shape[0], int(tm.ray_count.max())
    trid = tm.ray_id.long()
    with torch.no_grad():
        ts_, traws = field_raws(tr.model, ro[trid] + tm.t[:, None] * rd[trid],
                                rd[trid])
    ts_, traws = ts_.float().contiguous(), traws.float().contiguous()
    T_start = torch.rand(Nt, generator=gen, device=o.device)
    T_start[::8] = thr * (1.0 + 2.0 * T_start[::8])
    got = cp.composite_compact_kernel(ts_, traws, tm.dt, tm.t, tm.ray_start,
                                      tm.ray_count, tm.valid, thr, T_start)
    ref = cp.composite_compact_plain(ts_, traws, tm.dt, tm.t, tm.ray_id,
                                     tm.ray_start, tm.valid, Nt, thr, T_start)
    dg = cp.composite_kernel(
        dense_of(tm, ts_, Nt, Kt), dense_of(tm, traws, Nt, Kt),
        dense_of(tm, tm.dt, Nt, Kt), dense_of(tm, tm.t, Nt, Kt),
        dense_of(tm, tm.valid, Nt, Kt), thr, T_start)
    log(f"H3 segments with T_start, first flat test round: N={Nt} "
        f"B={tm.t.shape[0]} (longest {Kt}); rays ended early "
        f"{int((ref[4] < tm.ray_count).sum())}")
    errs["composite_seg_fwd"].append(max(
        chk.close("opacity", got[0], ref[0], 1e-5),
        chk.close("depth", got[1], ref[1], 1e-5),
        chk.close("rend", got[2], ref[2], 1e-5),
        chk.equal("vr_samples", got[4], ref[4]),
        *(chk.equal(f"{n} = dense H3", got[i], dg[i]) for n, i in
          (("opacity", 0), ("depth", 1), ("rend", 2), ("vr_samples", 4)))))
    for k, e in errs.items():
        rec[k]["err"] = max(e)
    chk.done("segment launcher checks")
    return rec


SEG_REPEATS = 64   # rays of each segment length in `segment_case`
SEG_FWD_LONGEST = 64   # test_n_samples: the flat test round's segments


def segment_case(longest, C, gen):
    """Flat composite inputs on segments of every length 0..longest
    (SEG_REPEATS rays each, in shuffled order, a tenth of the slots
    invalid, 37 unused slots after the last segment): the (B,) slots
    (sigmas, raws, deltas, ts), the segments (count, start, ray_id, used,
    valid) and the four cotangents, drawn as `composite_case` draws."""
    dev, L = gen.device, longest + 1
    order = torch.randperm(L * SEG_REPEATS, generator=gen, device=dev)
    count = (torch.arange(L * SEG_REPEATS, device=dev) % L)[order].int()
    N = count.shape[0]
    start = (torch.cumsum(count, 0) - count).int()
    B = int(count.sum()) + 37
    (sig, raws, dt, ts, _), gs = composite_case(B, 1, C, gen)
    rid = torch.repeat_interleave(torch.arange(N, device=dev), count.long())
    used = torch.zeros(B, dtype=torch.bool, device=dev)
    used[:rid.shape[0]] = True
    rid = torch.cat([rid, rid.new_full((B - rid.shape[0],), N - 1)]).int()
    valid = used & (torch.rand(B, generator=gen, device=dev) >= 0.1)
    return ((sig[:, 0], raws[:, 0], dt[:, 0], ts[:, 0]),
            (count, start, rid, used, valid),
            (gs[0][:N], gs[1][:N], gs[2][:N], gs[3][:, 0]))


def check_seg_lengths(chk, C, thr, gen):
    """H3's segment backward on segments of every length
    0..SEG_BWD_LONGEST (`segment_case`; past 32 samples the long kernel's
    chunks) against its plain version (the tolerances of
    `check_composite_bwd`), `max_len` read from the counts as the plain
    path does; d_sigmas bit for bit `composite_grad_serial` on the
    segments laid out as dense rows and 0 outside them, d_raws bit for
    bit g_rend (x) the segment forward's own ws. Returns the largest
    error."""
    from normal_clustering_nerf_torch.ops import composite as cp
    (sig, raws, dt, ts), (count, start, rid, used, valid), g = segment_case(
        SEG_BWD_LONGEST, C, gen)
    N, B, dev = count.shape[0], sig.shape[0], gen.device
    log(f"H3 segment backward, every length 0..{SEG_BWD_LONGEST}: N={N} "
        f"B={B} C={C}")
    ref = cp.composite_compact_grad_plain(sig, raws, dt, ts, rid, start,
                                          valid, N, thr, *g)
    ws = cp.composite_compact_kernel(sig, raws, dt, ts, start, count, valid,
                                     thr)[3]
    got = cp.composite_compact_grad_kernel(sig, raws, dt, ts, start, count,
                                           valid, thr, *g)
    inside, slot = segment_slots_2d(count, start, SEG_BWD_LONGEST)
    rows = [x[slot] for x in (sig, raws, dt, ts)] + [valid[slot] & inside]
    ser = composite_grad_serial(*rows, thr, *g[:3],
                                torch.where(inside, g[3][slot], 0.0))
    want = torch.zeros(B, device=dev)
    want[slot[inside]] = ser[inside]
    return max(chk.close("d_sigmas", got[0], ref[0], 1e-4),
               chk.close("d_raws", got[1], ref[1], 1e-5),
               chk.equal("d_sigmas = serial order, 0 outside the segments",
                         got[0], want),
               chk.equal("d_raws = g_rend x H3 segment fwd's ws", got[1],
                         torch.where(used[:, None],
                                     g[2][rid.long()] * ws[:, None], 0.0)))


def segment_slots_2d(count, start, width):
    """The segments laid out as dense (N, width) rows: where row n holds a
    sample (p < count[n]) and the slot start[n] + p it comes from (0
    elsewhere)."""
    p = torch.arange(width, device=count.device)
    inside = p[None] < count[:, None]
    return inside, torch.where(inside, start[:, None] + p[None], 0).long()


# (max_len, longest segment): the flat march's cap at the bench's 16 samples
# a ray, at the 32 of a configuration without a sample budget and at the
# 64 of a rank of four cards under the bench's budget, over segments all
# shorter than it
SEG_CAP_CASES = ((16, 7), (16, 15), (32, 16), (32, 31), (64, 33), (64, 63))


def check_seg_cap(chk, C, thr, gen):
    """H3's segment backward with `max_len` at the flat march's cap, the
    bound the training step passes, on segments all shorter than it
    (`segment_case`, every length 0..longest, for each of SEG_CAP_CASES):
    against its plain version (the tolerances of `check_seg_lengths`),
    d_sigmas bit for bit `composite_grad_serial` on the segments laid out
    as dense rows and 0 outside them, d_raws bit for bit g_rend (x) the
    segment forward's own ws. Returns the largest error."""
    from normal_clustering_nerf_torch.ops import composite as cp
    err = 0.0
    for cap, longest in SEG_CAP_CASES:
        (sig, raws, dt, ts), (count, start, rid, used, valid), g = (
            segment_case(longest, C, gen))
        N, B, dev = count.shape[0], sig.shape[0], gen.device
        inside, slot = segment_slots_2d(count, start, longest)
        rows = [x[slot] for x in (sig, raws, dt, ts)] + [valid[slot] & inside]
        log(f"H3 segment backward at max_len {cap}, every length "
            f"0..{longest}: N={N} B={B} C={C}")
        got = cp.composite_compact_grad_kernel(sig, raws, dt, ts, start,
                                               count, valid, thr, *g,
                                               max_len=cap)
        ref = cp.composite_compact_grad_plain(sig, raws, dt, ts, rid, start,
                                              valid, N, thr, *g)
        ws = cp.composite_compact_kernel(sig, raws, dt, ts, start, count,
                                         valid, thr)[3]
        ser = composite_grad_serial(*rows, thr, *g[:3],
                                    torch.where(inside, g[3][slot], 0.0))
        want = torch.zeros(B, device=dev)
        want[slot[inside]] = ser[inside]
        err = max(err,
                  chk.close("d_sigmas", got[0], ref[0], 1e-4),
                  chk.close("d_raws", got[1], ref[1], 1e-5),
                  chk.equal("d_sigmas = serial order, 0 outside the "
                            "segments", got[0], want),
                  chk.equal("d_raws = g_rend x H3 segment fwd's ws", got[1],
                            torch.where(used[:, None],
                                        g[2][rid.long()] * ws[:, None], 0.0)))
    return err


def check_seg_fwd_lengths(chk, C, thr, gen):
    """H3's segment forward on segments of every length 0..SEG_FWD_LONGEST
    (`segment_case`), with and without T_start: against its plain version
    (the tolerances of `check_composite_fwd`) and bit for bit against
    `composite_serial` on the segments laid out as dense rows. Returns the
    largest error."""
    from normal_clustering_nerf_torch.ops import composite as cp
    (sig, raws, dt, ts), (count, start, rid, _, valid), _ = segment_case(
        SEG_FWD_LONGEST, C, gen)
    N, B, dev = count.shape[0], sig.shape[0], gen.device
    inside, slot = segment_slots_2d(count, start, SEG_FWD_LONGEST)
    rows = [x[slot] for x in (sig, raws, dt, ts)] + [valid[slot] & inside]
    T_start = torch.rand(N, generator=gen, device=dev)
    T_start[::8] = thr * (1.0 + 2.0 * T_start[::8])
    err = 0.0
    for tsn in (None, T_start):
        extra = () if tsn is None else (tsn,)
        log(f"H3 segment forward, every length 0..{SEG_FWD_LONGEST}: N={N} "
            f"B={B} C={C}{'' if tsn is None else ', T_start'}")
        got = cp.composite_compact_kernel(sig, raws, dt, ts, start, count,
                                          valid, thr, *extra)
        ref = cp.composite_compact_plain(sig, raws, dt, ts, rid, start, valid,
                                         N, thr, *extra)
        ser = composite_serial(*rows, thr, *extra)
        ws = torch.zeros(B, device=dev)
        ws[slot[inside]] = ser[3][inside]
        names = ("opacity", "depth", "rend", "ws", "vr_samples")
        err = max(err,
                  *(chk.close(nm, got[i], ref[i], 1e-5)
                    for i, nm in enumerate(names[:4])),
                  chk.equal("vr_samples", got[4], ref[4]),
                  *(chk.equal(f"{nm} = serial order", got[i],
                              ws if i == 3 else ser[i])
                    for i, nm in enumerate(names)))
    return err


def check_seg_distortion_lengths(chk, gen):
    """H4's segment launchers on segments of every length
    0..SEG_FWD_LONGEST (`segment_case`; as in `distortion_case`, a
    segment's weights sum to less than 1 and its t rise): against their
    plain versions (the tolerances of `check_distortion`), and bit for bit
    against `distortion_serial` and dense H4 on the segments laid out as
    dense rows; d_ws 0 outside every segment. Returns the forward's and
    the backward's largest errors."""
    from normal_clustering_nerf_torch.ops import distortion as ds
    (_, _, dt, _), (count, start, rid, _, valid), _ = segment_case(
        SEG_FWD_LONGEST, 1, gen)
    N, B, dev = count.shape[0], dt.shape[0], gen.device
    inside, slot = segment_slots_2d(count, start, SEG_FWD_LONGEST)
    ws = torch.rand(B, generator=gen, device=dev) / torch.clamp(
        count, min=1)[rid.long()]
    ts = torch.zeros(B, device=dev)
    ts[slot[inside]] = (torch.cumsum(torch.where(inside, dt[slot], 0.0), 1)
                        + torch.rand((N, 1), generator=gen,
                                     device=dev))[inside]
    g = torch.randn(N, generator=gen, device=dev)
    rows = [x[slot] for x in (ws, dt, ts)] + [valid[slot] & inside]
    seg = (start, count)
    log(f"H4 segments, every length 0..{SEG_FWD_LONGEST}: N={N} B={B}")
    loss = ds.distortion_compact_kernel(ws, dt, ts, valid, *seg)
    d_ws = ds.distortion_compact_grad_kernel(g, ws, dt, ts, valid, *seg)
    want = torch.zeros(B, device=dev)
    want[slot[inside]] = distortion_serial(*rows, g)[inside]
    return (max(chk.close("loss", loss, ds.distortion_compact_plain(
                    ws, dt, ts, rid, start, valid, N), 1e-5),
                chk.equal("loss = serial order", loss,
                          distortion_serial(*rows)),
                chk.equal("loss = dense H4", loss,
                          ds.distortion_kernel(*rows))),
            max(chk.close("d_ws", d_ws, ds.distortion_compact_grad_plain(
                    g, ws, dt, ts, rid, start, valid, N), 1e-4),
                chk.equal("d_ws = serial order, 0 outside the segments",
                          d_ws, want),
                chk.equal("d_ws = dense H4", d_ws[slot[inside]],
                          ds.distortion_grad_kernel(g, *rows)[inside])))


# ------------------------------------------------------------ many channels
# H3's channel counts past its narrow backward (16 channels): 16 + 1; 3 +
# 3 + 40, a pred_sem run on NYU40's classes; the wide backward's tile of
# BWD_TILE = 48 channels and one past it (two tiles, the second of one
# channel); 101 sums, four a forward lane, three tiles; 132 sums, past the
# forward's FWD_QMAX * 32 of one walk (two walks, the second staging a
# tile of 2 channels)
WIDE_C = (17, 46, 48, 49, 99, 130)
# H3 backward's row lengths in the checks: lane groups of 1, 16 and 32
# lanes, and the long kernel's chunks of 32 (two, the second of one
# sample; two; four)
BWD_KS = (1, 16, 32, 33, 64, 128)
SEG_BWD_LONGEST = 128   # the segment backward's longest segment
SEM_CLASSES = 40   # NYU40's classes (Hypersim's n_valid_classes_scene bound)
WIDE_TIMED = 3 + 3 + SEM_CLASSES
WIDE_ROWS = 8190   # the bench batch's rays (2730 triangles)


def composite_grad_serial(sigmas, raws, deltas, ts, valid, thr, g_op,
                          g_depth, g_rend, g_ws):
    """H3's backward d_sigmas in its order of f32 operations (each torch op
    on the card rounds once): the prefix sums in the serial order, G_s =
    ((g_op + g_depth t_s) + g_ws_s) + g_rend_0 raw_s0 + g_rend_1 raw_s1 +
    ... in channel order over the included samples, the suffix sums of G
    w back to front, dx = G T exp(-x) - suffix, times delta inside the
    clip. The bit-for-bit reference of the lane-group kernel at any C."""
    from normal_clustering_nerf_torch.ops.composite import SIGDT_MAX
    N, K = sigmas.shape
    raw_x = sigmas * deltas
    x = torch.clamp(torch.where(valid, raw_x, 0.0), 0.0, SIGDT_MAX)
    csum, T = sigmas.new_zeros(N), torch.empty_like(sigmas)
    for s in range(K):
        csum = csum + x[:, s]
        T[:, s] = torch.exp(-(csum - x[:, s]))
    inc = valid & (T > thr)
    w = torch.where(inc, -torch.expm1(-x) * T, 0.0)
    G = (g_op[:, None] + g_depth[:, None] * ts) + g_ws
    for c in range(raws.shape[-1]):
        G = G + g_rend[:, c:c + 1] * raws[:, :, c]
    G = torch.where(inc, G, 0.0)
    TE = torch.where(inc, T * torch.exp(-x), 0.0)
    gw_ = G * w
    suffix, after = sigmas.new_zeros(N), torch.empty_like(sigmas)
    for s in reversed(range(K)):
        after[:, s] = suffix
        suffix = suffix + gw_[:, s]
    inside = valid & (raw_x > 0) & (raw_x < SIGDT_MAX)
    return torch.where(inside, (G * TE - after) * deltas, 0.0)


def stop_at_chunk_edges(sig, valid, K):
    """Rows N/2 + i of a `composite_case` draw (torch or numpy) made to
    stop early on the edges of H3 forward's chunks: every sample valid,
    sigma 1 but at sample e of CHUNK_EDGES (< K) and at the row's last,
    where sigma 1e4 clips sigma*delta at 80, so that sample e is the last
    included (its T * (1 - alpha) below any threshold) and the chunk
    after includes nothing. In place; returns {row: e}."""
    stops = {}
    for i, e in enumerate(e for e in CHUNK_EDGES + (K - 1,) if e < K):
        n = sig.shape[0] // 2 + i
        sig[n], valid[n] = 1.0, True
        sig[n, e] = 1e4
        stops[n] = e
    return stops


# samples on the edges of H3 forward's chunks of 16 and 32 lanes
CHUNK_EDGES = (15, 16, 31, 32)


def wide_fwd_layout(max_len, C):
    """(gw, Q, dynamic shared memory bytes a block) of H3's forward past gw
    sums, as csrc/composite.cu's `launch_fwd` and `fwd_region` take them;
    None where the narrow kernel runs."""
    gw = 1
    while gw < min(max_len, C + 2) and gw < 32:
        gw <<= 1
    if C + 2 > gw:
        q_gw = 1
        while q_gw < -(-(C + 2) // 4) and q_gw < 32:
            q_gw <<= 1
        gw = max(gw, q_gw, 4)
    if C + 2 <= gw:
        return None
    Q = min(-(-(C + 2) // gw), 4)
    need = 2 * gw + 3 + gw * min(Q * gw, C)
    region = ((need + 3) // 4 * 4 if gw >= 32
              else (need - gw + 31) // 32 * 32 + gw)
    return gw, Q, 4 * (256 // gw) * region


def check_many_channels(rec, gen, thr):
    """H3 at each of WIDE_C channels, on random rays as phase 2 draws them
    (`composite_case`, `segment_case`): the dense forward at K = 1, 16, 33
    and 64 with and without T_start (WIDE_ROWS rays and one:
    `check_composite_fwd`, bit for bit the serial order), the dense
    backward at BWD_KS (WIDE_ROWS rays, one and none:
    `check_composite_bwd`, d_sigmas bit for bit `composite_grad_serial`),
    the segment backward on every length 0..SEG_BWD_LONGEST and the
    segment forward on every length 0..64 with and without T_start; the
    forward's rows include rows that stop on its chunks' edges
    (`stop_at_chunk_edges`), and the layout of its wide kernel (lanes a
    group, sums a lane, shared memory) is logged. Adds each launcher's
    largest error to `rec`; at WIDE_TIMED
    channels and the bench's shape (WIDE_ROWS rays, K 16; the segments
    those rows of 16 slots) gives each launcher its "wide" entry, timed
    in phase 6."""
    from normal_clustering_nerf_torch.ops import composite as cp
    N, dev = WIDE_ROWS, gen.device
    for C in WIDE_C:
        chk = Check()
        errs = {k: [] for k in ("composite_fwd", "composite_bwd",
                                "composite_seg_fwd", "composite_seg_bwd")}
        for k in (1, 16, 33, 64):
            kca, _ = composite_case(N, k, C, gen)
            edges = stop_at_chunk_edges(kca[0], kca[4], k)
            log(f"H3 forward's wide layout (gw, Q, shared bytes a block) at "
                f"C={C} K={k}: {wide_fwd_layout(k, C)}, segments "
                f"{wide_fwd_layout(C + 2, C)}; rows stopping at a sample: "
                f"{edges}")
            T_start = torch.rand(N, generator=gen, device=dev)
            T_start[::8] = thr * (1.0 + 2.0 * T_start[::8])
            for n in (N, 1):
                for tsn in (None, T_start[:n]):
                    cut = tuple(t[:n] for t in kca) + (thr,)
                    cut += () if tsn is None else (tsn,)
                    ref = cp.composite_plain(*cut)
                    got = cp.composite_kernel(*cut)
                    log(f"H3 forward, C={C}: N={n} K={k}"
                        f"{'' if tsn is None else ', T_start'}; rays ended "
                        f"early {int((ref[4] < cut[4].sum(1)).sum())}")
                    errs["composite_fwd"].append(
                        check_composite_fwd(chk, cut, got, ref))
        for k in BWD_KS:
            kca, kgs = composite_case(N, k, C, gen)
            for n in (N, 1, 0):
                log(f"H3 backward, C={C}: N={n} K={k}")
                errs["composite_bwd"].append(check_composite_bwd(
                    chk, tuple(t[:n] for t in kca) + (thr,),
                    tuple(t[:n] for t in kgs)))
        errs["composite_seg_bwd"].append(check_seg_lengths(chk, C, thr, gen))
        errs["composite_seg_fwd"].append(
            check_seg_fwd_lengths(chk, C, thr, gen))
        chk.done(f"H3 at C = {C}")
        for k, e in errs.items():
            rec[k]["err"] = max(rec[k]["err"], *e)
    C, K = WIDE_TIMED, 16
    (sig, raws, dt, ts, valid), gs = composite_case(N, K, C, gen)
    ca = (sig, raws, dt, ts, valid, thr)
    out = cp.composite_kernel(*ca)
    flops = N * K * (10 + 2 * C)
    shape = f"N {N}, K {K}, C {C}"
    rec["composite_fwd"]["wide"] = dict(
        shape=shape, kernel=(lambda: cp.composite_kernel(*ca)),
        plain=(lambda: cp.composite_plain(*ca)),
        bound=bound(nbytes(*ca[:5]) + nbytes(*out), flops))
    rec["composite_bwd"]["wide"] = dict(
        shape=shape, kernel=(lambda: cp.composite_grad_kernel(*ca, *gs)),
        plain=(lambda: cp.composite_grad_plain(*ca, *gs)),
        bound=bound(nbytes(*ca[:5], *gs) + nbytes(sig, raws),
                    2 * flops + N * K * C * 3))
    # the rows as segments of K slots: ray n's slots [n K, n K + K)
    B = N * K
    fa = (sig.reshape(B), raws.reshape(B, C), dt.reshape(B), ts.reshape(B))
    v = valid.reshape(B)
    seg = (torch.arange(0, B, K, device=dev, dtype=torch.int32),
           torch.full((N,), K, device=dev, dtype=torch.int32))
    rid = torch.arange(N, device=dev, dtype=torch.int32).repeat_interleave(K)
    sgs = gs[:3] + (gs[3].reshape(B),)
    sout = cp.composite_compact_kernel(*fa, *seg, v, thr)
    in_b = nbytes(*fa, v, *seg)
    rec["composite_seg_fwd"]["wide"] = dict(
        shape=f"B {B}, N {N}, C {C}",
        kernel=(lambda: cp.composite_compact_kernel(*fa, *seg, v, thr)),
        plain=(lambda: cp.composite_compact_plain(*fa, rid, seg[0], v, N,
                                                  thr)),
        bound=bound(in_b + nbytes(*sout), flops))
    rec["composite_seg_bwd"]["wide"] = dict(
        shape=f"B {B}, N {N}, C {C}",
        kernel=(lambda: cp.composite_compact_grad_kernel(
            *fa, *seg, v, thr, *sgs, max_len=K)),
        plain=(lambda: cp.composite_compact_grad_plain(
            *fa, rid, seg[0], v, N, thr, *sgs)),
        bound=bound(in_b + nbytes(*sgs) + nbytes(*fa[:2]),
                    2 * flops + N * K * C * 3))


# ------------------------------------------------------- K7 and K8 checks
KMEANS_SETS = (   # (label, M, K, rounds (None: the step's), kind,
                  #  merge_clusters, find_opposite)
    ("M = K", 20, 20, None, "room", True, True),
    ("M 4097", 4097, 20, None, "room", True, True),
    ("K 33", 4097, 33, None, "room", True, True),
    ("K 64", 4097, 64, None, "room", True, True),
    ("K 256 (K7's most), 3 rounds", 4097, 256, 3, "room", True, True),
    ("rotation recovery's shape", 65536, 30, 30, "room", True, True),
    ("M 262,144 (rows from global memory), 3 rounds", 262144, 20, 3,
     "room", True, True),
    ("all invalid", 4097, 20, None, "none", True, True),
    ("near-ties", 2730, 20, None, "ties", True, True),
    ("K 12", 2730, 12, None, "room", True, True),
    ("K 12, no merge, no opposite", 2730, 12, None, "room", False, False),
)


def kmeans_set(M, kind, gen, dev):
    """Normals of a rotated box room with noise (zero rows where invalid,
    as the loss hands them in), or a few directions repeated and moved by
    one ulp ("ties"), and their valid mask."""
    q, _ = torch.linalg.qr(torch.randn(3, 3, generator=gen, device=dev))
    axes = torch.cat([q, -q])
    pick = torch.randint(0, 6, (M,), generator=gen, device=dev)
    noise = 0.2 if kind == "ties" else 0.05
    n = axes[pick] + noise * torch.randn(M, 3, generator=gen, device=dev)
    n = torch.nn.functional.normalize(n, dim=-1)
    if kind == "ties":
        n = n[torch.randint(0, 8, (M,), generator=gen, device=dev)]
        step = torch.randint(-1, 2, (M, 3), generator=gen, device=dev)
        keep = torch.rand(M, 3, generator=gen, device=dev) < 0.3
        n = (n.view(torch.int32) + (step * keep).to(torch.int32)).view(
            torch.float32)
    valid = (torch.rand(M, generator=gen, device=dev) < 0.8
             if kind == "room" else
             torch.zeros(M, dtype=torch.bool, device=dev) if kind == "none"
             else torch.ones(M, dtype=torch.bool, device=dev))
    if M <= 20:
        valid[:] = True
    n = torch.where(valid[:, None], n, torch.zeros_like(n)).contiguous()
    return n, valid


def step_normals(tr):
    """The detached normals, valid mask and initial rows that one
    training step after the bootstrap hands K7, captured in the wrapper's
    call. The step is taken: the trainer's state moves on."""
    from normal_clustering_nerf_torch.ops import kmeans as km
    seen, kernel = [], km.normals_clustering_kernel

    def spy(normals, valid, init_idx, *rest):
        seen.append((normals.clone(), valid.clone(), init_idx.clone(), rest))
        return kernel(normals, valid, init_idx, *rest)
    km.normals_clustering_kernel = spy
    try:
        tr.train_step_core(bootstrap=False)
    finally:
        km.normals_clustering_kernel = kernel
    if len(seen) != 1:
        raise RuntimeError(f"a training step called K7 {len(seen)} times, "
                           f"expected once")
    return seen[0]


def kmeans_bound(M, K, niter, n_valid):
    """K7's bytes (normals, valid and the initial rows read; two int64
    assignments, the centroids written) and f32 operations (every round's
    dot products and comparisons, K x 6 a row; the sums of the valid
    rows; the renormalisations)."""
    return bound(M * 12 + M + K * 8 + 2 * M * 8 + K * 12 + 36,
                 (niter + 1) * M * K * 6 + niter * (n_valid * 3 + K * 9))


def check_kmeans(tr, rec, gen):
    """K7 against its plain version, bit for bit (assign_new, assign_orig,
    every centroid, centroids3): on one training step's own normals after
    the main path's training and on KMEANS_SETS; K 257 refused. The calls
    on the step's normals kept in `rec` for `time_kernels`."""
    from normal_clustering_nerf_torch.ops import kmeans as km
    normals, valid, init, (niter, t_sim, merge, opp) = step_normals(tr)
    chk, err = Check(), 0.0
    M, K = normals.shape[0], init.shape[0]
    n_valid = int(valid.sum())
    log(f"K7's cluster of {km.BLOCKS} blocks: the card holds "
        f"{km.cluster_occupancy(tr.device)} at once")
    log(f"K7 on a training step's normals (step {tr.step - 1}): M={M}, "
        f"K={K}, {niter} rounds, {n_valid} valid, t_similar {t_sim}")
    sets = [("a training step's normals", normals, valid, init, niter,
             merge, opp)]
    for label, m, k, rounds, kind, mg, op in KMEANS_SETS:
        n, v = kmeans_set(m, kind, gen, tr.device)
        i = km.draw_init(v, k, gen)
        sets.append((label, n, v, i, niter if rounds is None else rounds,
                     mg, op))
    for label, n, v, i, rounds, mg, op in sets:
        got, gc = km.normals_clustering_kernel(n, v, i, rounds, t_sim, mg,
                                               op)
        want, wc = km.normals_clustering_plain(
            n, v, K=i.shape[0], niter=rounds, t_similar=t_sim,
            merge_clusters=mg, find_opposite=op, init_idx=i)
        log(f"  {label}: M={n.shape[0]}, K={i.shape[0]}, {rounds} rounds, "
            f"labels {sorted(set(want.assign_new.tolist()))}")
        for name, a, b in (("assign_new", got.assign_new, want.assign_new),
                           ("assign_orig", got.assign_orig,
                            want.assign_orig),
                           ("centroids", gc, wc),
                           ("centroids3", got.centroids3, want.centroids3)):
            err = max(err, chk.equal(f"{label}: {name}", a, b))
    n, v = kmeans_set(4097, "room", gen, tr.device)
    try:
        km.normals_clustering_kernel(n, v, km.draw_init(v, 257, gen), 2,
                                     t_sim, True, True)
        log("  K 257: not refused FAIL")
        chk.failures.append("K7 took K 257, past its 256")
    except RuntimeError as e:
        log(f"  K 257: refused ok ({e})")
    chk.done("K7 against its plain version")
    args = (normals, valid, init, niter, t_sim, merge, opp)
    rec["kmeans_cluster"] = dict(
        err=err, library=None,
        kernel=lambda: km.normals_clustering_kernel(*args),
        plain=lambda: km.normals_clustering_plain(
            normals, valid, K=K, niter=niter, t_similar=t_sim,
            merge_clusters=merge, find_opposite=opp, init_idx=init),
        bound=kmeans_bound(M, K, niter, n_valid))


# grid sizes K8 is held at besides the trained grid's: Gc = G / 8 of 1, 3,
# 4, 5, 17 and 32 (occ_tables' byte and 16-byte loads; odd strides)
OCC_SIZES = (8, 24, 32, 40, 136, 256)


def occ_grids(C, G3, gen, dev, thr):
    """(label, (C, G3) density grid): none above `thr`, all above, and a
    random 20% above with a tenth of the cells invisible (-1)."""
    low = torch.rand(C, G3, generator=gen, device=dev) * thr
    high = thr + 1.0 + 10.0 * torch.rand(C, G3, generator=gen, device=dev)
    mixed = torch.where(torch.rand(C, G3, generator=gen, device=dev) < 0.2,
                        high, low)
    mixed[torch.rand(C, G3, generator=gen, device=dev) < 0.1] = -1.0
    return (("empty", low), ("full", high), ("random 20%", mixed))


def occ_edge_grids(C, G3, gen, dev, thr):
    """(label, (C, G3) density grid) at occ_compact's tiles
    (`COMPACT_TILE`): one cell above `thr` among the last 16 of each tile
    (runs of one entry at every offset from a 16-byte boundary), and
    ragged runs: tile t holds up to (7 t + 3) mod 19 cells above `thr` at
    random places, every third tile none (zero aggregates between runs)."""
    from normal_clustering_nerf_torch.models.occupancy import COMPACT_TILE
    tiles = -(-G3 // COMPACT_TILE)
    start = torch.arange(tiles, device=dev) * COMPACT_TILE
    length = torch.clamp(start + COMPACT_TILE, max=G3) - start
    low = torch.rand(C, G3, generator=gen, device=dev) * thr
    one = low.clone()
    pos = start + length - 16 + torch.randint(0, 16, (C, tiles),
                                              generator=gen, device=dev)
    one.scatter_(1, pos, thr + 1.0)
    t = torch.arange(tiles, device=dev)
    n = torch.where(t % 3 == 1, 0, (7 * t + 3) % 19)
    j = torch.arange(19, device=dev)
    pos = start[:, None] + (torch.rand(C, tiles, 19, generator=gen,
                                       device=dev)
                            * length[:, None]).long()
    pos = torch.where(j < n[:, None], pos, G3).reshape(C, -1)
    ragged = torch.cat([low, low[:, :1]], 1)
    ragged.scatter_(1, pos, thr + 1.0)
    return (("one cell in each tile's last 16", one),
            ("ragged runs", ragged[:, :G3].contiguous()))


def sparse_bitfield(G, gen, dev):
    """Cascade 0's bitfield with half the supervoxels empty and a
    twentieth of the others' cells set (the CPU tests' tables input)."""
    Gc = G // 8
    sv = torch.rand(Gc, 1, Gc, 1, Gc, 1, generator=gen, device=dev) < 0.5
    cells = (torch.rand(Gc, 8, Gc, 8, Gc, 8, generator=gen, device=dev)
             < 0.05) & sv
    from normal_clustering_nerf_torch.ops.packbits import packbits
    return packbits(cells.reshape(-1).to(torch.uint8), 0)


def refresh_tmp(tr, gen):
    """The sampled refresh's fresh sigma grid (`update`'s tmp) at the
    trained grid, from cells and jitter drawn from `gen`."""
    og = tr.occ_grid
    draws = og.draw_update_cells(tr.occ, gen)
    idx, coords = og.sample_update_cells(tr.occ, tr.density_threshold(),
                                         draws)
    jitter = torch.rand(coords.shape, generator=gen, device=tr.device)
    tmp = torch.zeros_like(tr.occ.density_grid)
    for c in range(og.cascades):
        with torch.no_grad():
            sig = tr.model.density(og.cell_world_pos(coords[c], c,
                                                     jitter[c])).float()
        tmp[c].scatter_reduce_(0, idx[c], sig, reduce="amax")
    return tmp


def check_occupancy(tr, rec, gen):
    """K8's launchers against their plain versions, bit for bit, at the
    trained grid's G and at OCC_SIZES, with 1, 2 and 3 cascades (at G 256
    and 2 or 3 cascades past what occ_merge_pack's blocks keep on the
    SMs, so that its pack re-reads grid'), on an empty, a full and a
    random 20% grid with invisible cells (`occ_grids`), the last also with
    a sigma grid holding NaN, on an all-invisible grid and on
    `occ_edge_grids` (occ_compact's counts and the first count entries of
    each list, occ_merge_pack's grid, bitfield and mean, and the same from
    a second launch on the same inputs, occ_tables' coarse mask, sv mask
    and payload on the packed bits), and occ_tables on a
    `sparse_bitfield` at each G and on bitfields 4 and 1 bytes off 16-byte
    alignment; occ_union on 1-4 ranks' bitfields at G 8 and the trained
    G; then on the trained grid and a sampled refresh's sigma grid
    (`refresh_tmp`), whose calls are kept in `rec` for `time_kernels`,
    with occ_union on two ranks' bitfields (the gloo phase's merge)."""
    from normal_clustering_nerf_torch.models import occupancy as oc
    dev, G = tr.device, tr.cfg.model.grid_size
    G3, thr = G ** 3, tr.density_threshold()
    chk, errs = Check(), {"occ_compact": 0.0, "occ_merge_pack": 0.0,
                          "occ_tables": 0.0, "occ_union": 0.0}
    log(f"K8 at G {G} and {OCC_SIZES}: occ_compact, occ_merge_pack, "
        f"occ_tables, occ_union against their plain versions")

    def same(label, name, got, want, kernel, quiet):
        if got.is_floating_point():   # NaN where the plain version has it
            got, want = (torch.where(t.isnan(), -7.0, t) for t in (got, want))
        errs[kernel] = max(errs[kernel], chk.equal(f"{label}: {name}", got,
                                                   want, quiet))

    def summary(label, since):
        bad = len(chk.failures) - since
        log(f"  {label}: {f'{bad} comparisons differ FAIL' if bad else 'ok'}")

    def tables(label, bits, G, quiet):
        got = oc.occ_tables(bits, G)
        want = (oc.coarse_occupancy(bits, G),
                *oc.supervoxel_tables(bits, G))
        for name, a, b in zip(("coarse_occ", "sv_mask", "sv_payload"),
                              got, want):
            same(label, name, a, b, "occ_tables", quiet)

    def compare(label, G, grid, tmp, quiet=False):
        since = len(chk.failures)
        lst, n = oc.occ_compact(grid, thr)
        plst, pn = oc.occ_compact_plain(grid, thr)
        same(label, "occupied counts", n, pn, "occ_compact", quiet)
        for c in range(grid.shape[0]):
            k = int(pn[c])
            same(label, f"cascade {c}'s list ({k} cells)", lst[c, :k],
                 plst[c, :k], "occ_compact", quiet)
        got = oc.occ_merge_pack(grid, tmp, 0.95, thr)
        want = oc.occ_merge_pack_plain(grid, tmp, 0.95, thr)
        again = oc.occ_merge_pack(grid, tmp, 0.95, thr)
        for name, a, b, c in zip(("grid'", "bitfield", "mean"), got, want,
                                 again):
            same(label, name, a, b, "occ_merge_pack", quiet)
            if a.is_floating_point():
                a, c = a.view(torch.int32), c.view(torch.int32)
            same(label, f"{name}, a second launch's = the first's", c, a,
                 "occ_merge_pack", quiet)
        tables(label, got[1], G, quiet)
        if quiet:
            summary(f"{label}: counts {pn.tolist()}, mean "
                    f"{float(want[2]):.6f}", since)
        return got

    def sigma(C, g3):
        return torch.where(
            torch.rand(C, g3, generator=gen, device=dev) < 0.25,
            3 * thr * torch.rand(C, g3, generator=gen, device=dev), 0.0)

    for g in (G, *OCC_SIZES):
        g3 = g ** 3
        for C in (1, 2, 3):
            grids = occ_grids(C, g3, gen, dev, thr) + occ_edge_grids(
                C, g3, gen, dev, thr)
            for label, grid in grids:
                compare(f"G {g}, C {C}, {label}", g, grid.contiguous(),
                        sigma(C, g3), quiet=g != G)
            tmp = sigma(C, g3)
            tmp[torch.rand(C, g3, generator=gen, device=dev) < 0.01] = \
                float("nan")
            compare(f"G {g}, C {C}, random 20%, sigma 1% NaN", g,
                    grids[2][1].contiguous(), tmp, quiet=g != G)
            compare(f"G {g}, C {C}, every cell invisible", g,
                    torch.full((C, g3), -1.0, device=dev), sigma(C, g3),
                    quiet=g != G)
        since = len(chk.failures)
        bits = sparse_bitfield(g, gen, dev)
        tables(f"G {g}, sparse bitfield", bits, g, True)
        for off in (4, 1):
            buf = torch.zeros(bits.numel() + 16, dtype=torch.uint8,
                              device=dev)
            view = buf[off:off + bits.numel()]
            view.copy_(bits)
            tables(f"G {g}, bitfield {off} bytes off", view, g, True)
        summary(f"G {g}, a sparse bitfield, aligned and 4 and 1 bytes off",
                since)
    since = len(chk.failures)
    for nbytes in (8 ** 3 // 8, G3 // 8):
        for world in (1, 2, 3, 4):
            rows = torch.randint(0, 256, (world, nbytes), generator=gen,
                                 device=dev, dtype=torch.uint8)
            rows[:, 0] = 1 << torch.arange(world, device=dev,
                                           dtype=torch.uint8)
            same(f"{world} ranks' {nbytes} bytes", "union", oc.occ_union(rows),
                 oc.occ_union_plain(rows), "occ_union", True)
    summary(f"occ_union of 1-4 ranks' bitfields of 64 and {G3 // 8} bytes",
            since)
    grid = tr.occ.density_grid
    tmp = refresh_tmp(tr, gen)
    bits = compare(f"the trained grid (step {tr.step})", G, grid, tmp)[1]
    chk.done("K8 against its plain versions")
    n, n_occ = grid.numel(), int(oc.occ_compact_plain(grid, thr)[1].sum())
    rec["occ_compact"] = dict(
        err=errs["occ_compact"],
        kernel=lambda: oc.occ_compact(grid, thr),
        plain=lambda: oc.occ_compact_plain(grid, thr),
        library=lambda: torch.nonzero(grid > thr),
        bound=bound(4 * n + 4 * n_occ + 4 * grid.shape[0], n))
    rec["occ_merge_pack"] = dict(
        err=errs["occ_merge_pack"], library=None,
        kernel=lambda: oc.occ_merge_pack(grid, tmp, 0.95, thr),
        plain=lambda: oc.occ_merge_pack_plain(grid, tmp, 0.95, thr),
        bound=bound(3 * 4 * n + n // 8 + 4, 5 * n))
    Gc3 = (G // 8) ** 3
    rec["occ_tables"] = dict(
        err=errs["occ_tables"], library=None,
        kernel=lambda: oc.occ_tables(bits, G),
        plain=lambda: (oc.coarse_occupancy(bits, G),
                       *oc.supervoxel_tables(bits, G)),
        bound=bound(G3 // 8 + Gc3 * (2 + 64), 0))
    # two ranks' bitfields, as the gloo phase's merge gathers them; one
    # torch call ORs two rows
    rows = torch.stack([bits, oc.occ_merge_pack(grid, sigma(1, G3), 0.95,
                                                thr)[1]])
    rec["occ_union"] = dict(
        err=errs["occ_union"],
        kernel=lambda: oc.occ_union(rows),
        plain=lambda: oc.occ_union_plain(rows),
        library=lambda: torch.bitwise_or(rows[0], rows[1]),
        bound=bound(3 * rows.shape[1], 0))
    log(f"  trained grid: {n_occ} of {n} cells above {thr:.4f}")


def check_refresh_graph(tr, path):
    """The sampled refresh with no host read: run eagerly under
    torch.cuda.set_sync_debug_mode("error") (a synchronizing call raises),
    and the trainer's replayed refresh graph (captured in its training)
    equal to it bit for bit from the same occupancy and generator state,
    the generator left in the same state. The host's time to queue each
    and the card's time to run it (means of REFRESH_REPS; the state put
    back after). Returns the times."""
    from normal_clustering_nerf_torch.training.trainer import REFRESH
    if REFRESH not in tr._graphs:
        raise RuntimeError(f"{path}: no captured refresh graph (captures: "
                           f"{[c['kind'] for c in tr.captures]})")
    chk = Check()
    start = snapshot(tr)
    tr.occ_update(warmup=False)
    sync(tr.device)
    replayed, gen_r = [t.clone() for t in tr.occ], tr.generator.get_state()
    restore(tr, start)
    sync(tr.device)
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr._refresh(False)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sync(tr.device)
    log(f"{path}: the sampled refresh ran eagerly under "
        f"set_sync_debug_mode('error') with no synchronizing call")
    for name, a, b in zip(tr.occ._fields, replayed, tr.occ):
        chk.equal(f"{path}: replayed refresh's {name} = eager", a, b)
    chk.equal(f"{path}: generator state after the replay = after the "
              f"eager refresh", gen_r, tr.generator.get_state())
    chk.done(f"{path}: the refresh graph")
    times = {}
    for label, fn in (("graph", lambda: tr.occ_update(warmup=False)),
                      ("eager", lambda: tr._refresh(False))):
        restore(tr, start)
        sync(tr.device)
        t = time.perf_counter()
        for _ in range(REFRESH_REPS):
            fn()
        host_s = (time.perf_counter() - t) / REFRESH_REPS
        sync(tr.device)
        # the card's time: the calls queued behind a sleep twice as long
        # as the host takes to queue them, so that they run back to back
        restore(tr, start)
        sync(tr.device)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda._sleep(int((2 * host_s * REFRESH_REPS + 1e-3)
                              * CARD_CLOCK_HZ))
        ev[0].record()
        for _ in range(REFRESH_REPS):
            fn()
        ev[1].record()
        ev[1].synchronize()
        times[label] = {"host_ms": host_s * 1e3,
                        "device_ms": ev[0].elapsed_time(ev[1])
                        / REFRESH_REPS}
    restore(tr, start)
    sync(tr.device)
    log(f"  {path}: a sampled refresh, graph replay / eager: the host "
        f"queues it in {times['graph']['host_ms']:.4f} / "
        f"{times['eager']['host_ms']:.4f} ms, the card runs it in "
        f"{times['graph']['device_ms']:.4f} / "
        f"{times['eager']['device_ms']:.4f} ms (means of {REFRESH_REPS})")
    return times


REFRESH_REPS = 8


# ------------------------------------------------------------ K9 checks
ADAMW_COUNTS = 3   # counts of each K9 case, each from the last's state
# K9's cases: (label, gradient scale (1.0: the norm past grad_clip; 1e-7:
# under it), gradients as views into one flat buffer at odd offsets, a
# NaN gradient at the first count)
ADAMW_CASES = (("clip on", 1.0, False, False),
               ("clip off", 1e-7, False, False),
               ("clip on, flat-buffer views", 1.0, True, False),
               ("clip off, flat-buffer views", 1e-7, True, False),
               ("a NaN gradient", 1.0, False, True))
ADAMW_STEP_OPS = 16   # f32 operations a value of K9's update
K9_STEPS = 32   # steps of each field before `--only k9`'s checks


def adamw_opt(tr, seed, beside=True):
    """An AdamW over clones of `tr`'s parameters and moments, with (where
    `beside`) the parameters the ext path and the baselines add (theta_WF,
    plain Adam at the schedule's lr; dR and dT at EXT_LR; dR_glob at
    lr_dR_norm_glob: EXT_OPTIM) where the trainer has none, those drawn
    from `seed` with zero moments; the count the trainer's."""
    from normal_clustering_nerf_torch.training.state import AdamW
    dev = tr.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    n_img = tr.scene["poses"].shape[0]
    params = {n: p.detach().clone() for n, p in tr.params.items()}
    cfg = tr.cfg.optim
    if beside:
        extra = {"theta_WF": torch.full((), 0.2, device=dev),
                 "dR": 1e-5 * torch.randn(n_img, 3, generator=gen,
                                          device=dev),
                 "dT": 1e-5 * torch.randn(n_img, 3, generator=gen,
                                          device=dev),
                 "dR_glob": torch.zeros(3, device=dev)}
        params.update({n: t for n, t in extra.items() if n not in params})
        cfg = dataclasses.replace(cfg, **EXT_OPTIM)
    opt = AdamW(params, cfg)
    for k in ("mu", "nu"):
        for n, t in tr.opt.state[k].items():
            opt.state[k][n].copy_(t)
    opt.state["count"] = tr.opt.state["count"]
    opt.count_t.fill_(opt.state["count"])
    return opt


def adamw_grads(opt, scale, views, gen):
    """Random gradients of `opt`'s parameters: contiguous, or views into
    one flat f32 buffer, the first 1 value in and each after a gap of 1-3
    values (as `mean_over_axis` hands them over: no view 16-byte aligned
    but by chance); NaN in the gaps."""
    dev = opt.count_t.device
    grads = {n: scale * torch.randn(p.shape, generator=gen, device=dev)
             for n, p in opt.params.items()}
    if not views:
        return grads
    gaps = [1] + torch.randint(1, 4, (len(grads) - 1,), generator=gen,
                               device=dev).tolist()
    flat = torch.full((sum(g.numel() for g in grads.values()) + sum(gaps),),
                      float("nan"), device=dev)
    out, i = {}, 0
    for (n, g), gap in zip(grads.items(), gaps):
        i += gap
        out[n] = flat[i:i + g.numel()].view(g.shape)
        out[n].copy_(g)
        i += g.numel()
    return out


def bits_differ(a, b):
    """Values of a and b whose bits differ (a NaN matching a NaN)."""
    return int(((a.view(torch.int32) != b.view(torch.int32))
                & ~(a.isnan() & b.isnan())).sum())


def library_norm(gs):
    """torch's own global norm of the gradients `gs`."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(gs)))


def library_adamw(opt, gs, lr, norm=None):
    """A call of torch's own fused AdamW over `opt`'s tensors with the
    gradients `gs` (divided in place: the clip is its grad_scale), at one
    weight decay for all: not K9's rounding (it decays p (1 - lr wd) and
    divides sqrt(nu) by sqrt(bc2)). The norm `norm`, or taken in the call
    by `library_norm`."""
    hp = opt.hyper
    ps, mus, nus = (list(d.values()) for d in (
        opt.params, opt.state["mu"], opt.state["nu"]))
    steps = [torch.full((), opt.state["count"] + 1.0, device=lr.device)
             for _ in ps]
    lr_f = float(lr)

    def call():
        n = library_norm(gs) if norm is None else norm
        torch._fused_adamw_(ps, gs, mus, nus, [], steps, lr=lr_f,
                            beta1=hp.b1, beta2=hp.b2,
                            weight_decay=hp.weight_decay, eps=hp.eps,
                            amsgrad=False, maximize=False,
                            grad_scale=torch.clamp(n / hp.grad_clip,
                                                   min=1.0))
    return call


def check_adamw(paths, rec, gen):
    """K9 (`adamw_norm`, `adamw_step`) against its plain version, bit for
    bit (every parameter and moment, the norm, the count), on each bench
    field's parameters with the ext, theta_WF and dR_glob groups beside
    them (`adamw_opt`), ADAMW_COUNTS counts of each of ADAMW_CASES: the
    clip on and off, contiguous gradients and flat-buffer views, a NaN
    gradient (every output NaN, as the plain version's); the lr and the
    bias corrections views into one row, as the trainer hands them in.
    The launches on the triplane field kept in `rec` for `time_kernels`."""
    from normal_clustering_nerf_torch.ops import adamw
    chk = Check()
    for path in ("triplane", "brick", "tcnn"):
        tr = paths[path]
        for label, scale, views, nan in ADAMW_CASES:
            seed = int(torch.randint(1 << 30, (1,), generator=gen,
                                     device=tr.device))
            k_opt, p_opt = adamw_opt(tr, seed), adamw_opt(tr, seed)
            bad, norms = [], []
            for c in range(ADAMW_COUNTS):
                grads = adamw_grads(k_opt, scale, views, gen)
                if nan and c == 0:
                    g0 = next(iter(grads.values())).view(-1)
                    g0[12345 % g0.numel()] = float("nan")
                lr, bc1, bc2 = torch.tensor(
                    k_opt.schedule(k_opt.state["count"]), device=tr.device)
                got = k_opt.update(grads, lr, bc1, bc2)
                want = adamw.clipped_adamw_plain(
                    p_opt.slots(grads, lr), bc1, bc2, p_opt.count_t,
                    p_opt.hyper)
                for o in (k_opt, p_opt):
                    o.advance()
                norms.append(float(got))
                pairs = [("g_norm", got, want),
                         ("count", k_opt.count_t.float(),
                          p_opt.count_t.float())]
                for n in k_opt.params:
                    pairs += [(n, k_opt.params[n], p_opt.params[n])] + [
                        (f"{k} {n}", k_opt.state[k][n], p_opt.state[k][n])
                        for k in ("mu", "nu")]
                for name, a, b in pairs:
                    d = bits_differ(a, b)
                    if d:
                        bad.append(f"count {c}: {name} {d} of {b.numel()}")
            if nan and not (math.isnan(norms[0]) and all(
                    bool(p.isnan().all()) for p in k_opt.params.values())):
                bad.append(f"not every value NaN after a NaN gradient "
                           f"(norms {norms})")
            log(f"  K9, {path}, {label}: {len(k_opt.params)} tensors, "
                f"{sum(p.numel() for p in k_opt.params.values())} values, "
                f"norms {', '.join(f'{x:.6g}' for x in norms)}: "
                + (f"FAIL {bad[:4]}" if bad else
                   f"{ADAMW_COUNTS} counts, parameters, moments, norm and "
                   f"count bit for bit the plain version's ok"))
            if bad:
                chk.failures.append(f"K9 {path} {label}")
    chk.done("K9 against its plain version")
    # the timed calls: the triplane field's own tensors, the clip on
    tr = paths["triplane"]
    opt = adamw_opt(tr, 1)
    grads = adamw_grads(opt, 1.0, False, gen)
    lr, bc1, bc2 = torch.tensor(opt.schedule(opt.state["count"]),
                                device=tr.device)
    slots = opt.slots(grads, lr)
    plan, dev = adamw.make_plan(slots)
    g_norm = adamw.global_norm_kernel(plan, opt.count_t, dev)
    gs = list(grads.values())
    n = sum(g.numel() for g in gs)
    hp = opt.hyper
    rec["adamw_norm"] = dict(
        err=0.0, kernel=lambda: adamw.global_norm_kernel(plan, opt.count_t,
                                                         dev),
        plain=lambda: adamw.global_norm_plain(gs),
        library=lambda: library_norm(gs), bound=bound(4 * n, 2 * n))
    rec["adamw_step"] = dict(
        err=0.0, kernel=lambda: adamw.adamw_step_kernel(plan, g_norm, bc1,
                                                        bc2, hp, dev),
        plain=lambda: adamw.adamw_step_plain(slots, g_norm, bc1, bc2, hp),
        library=library_adamw(opt, gs, lr, g_norm),
        bound=bound(28 * n, ADAMW_STEP_OPS * n))


# ------------------------------------------------------------ K10 checks
LOSS_STEPS = 64   # steps of each bench field before `--only loss`'s checks
K10_LAUNCHERS = ("loss_rays", "loss_clusters", "loss_bwd")
SEM_WIDE = 6 + SEM_CLASSES   # rend's columns before the 40 logits, and them


def step_loss_args(tr):
    """The arguments of `compute_losses` in one training step after the
    bootstrap (the step is taken), copied: pred, target and the keyword
    arguments; the semantic logits kept a strided view of a wider row, as
    `split_rend` hands them over."""
    from normal_clustering_nerf_torch.training import trainer as tm
    seen, fn = [], tm.compute_losses

    def spy(pred, target, lcfg, mcfg, **kw):
        seen.append(({k: v.detach().clone() if torch.is_tensor(v) else v
                      for k, v in pred.items()},
                     {k: v.clone() for k, v in target.items()},
                     {k: v for k, v in kw.items() if k != "sched"},
                     {k: v.clone() for k, v in kw["sched"].items()}))
        return fn(pred, target, lcfg, mcfg, **kw)
    tm.compute_losses = spy
    try:
        tr.train_step_core(bootstrap=False)
    finally:
        tm.compute_losses = fn
    pred, target, kw, sched = seen[0]
    if "sem" in pred:
        C = pred["sem"].shape[1]
        wide = torch.zeros((pred["sem"].shape[0], 6 + C), device=tr.device)
        wide[:, 6:] = pred["sem"]
        pred["sem"] = wide[:, 6:]
    return pred, target, kw, sched


def max_abs(a, b):
    d = (a.double() - b.double()).abs()
    d = d[~(a.isnan() & b.isnan())]
    return float(d.max()) if d.numel() else 0.0


def k10_args_copy(a, **ptrs):
    from normal_clustering_nerf_torch.ops import loss_block as lb
    c = lb._Args.from_buffer_copy(a)
    for k, t in ptrs.items():
        setattr(c, k, t.data_ptr())
    return c


def k10_pair(plan, inp, X, needs, g_terms, g_total, gen):
    """K10's three launchers (with K7 between them) and the plain version
    (with K7 on its own normals) on the same inputs X (GRAD_INPUTS)."""
    from normal_clustering_nerf_torch.ops import kmeans as km
    from normal_clustering_nerf_torch.ops import loss_block as lb
    a, dev = lb.make_args(plan, inp, *X)
    k = dict(zip(("nm", "valid", "slots"), lb.rays_kernel(a, plan, dev)))
    p = dict(zip(("nm", "valid", "slots"), lb.rays_plain(plan, inp, *X)))
    init = inp.kmeans_init
    for r in (k, p):
        r["clus"] = None
        if plan.clustering:
            if init is None:
                init = km.draw_init(k["valid"], plan.K, gen)
            r["clus"] = km.normals_clustering(
                r["nm"], r["valid"], K=plan.K, niter=plan.niter,
                t_similar=1.0 - plan.tres, init_idx=init)
    names = ("terms", "total", "mse", "saved", "code")
    k.update(zip(names, lb.clusters_kernel(a, plan, dev, k["clus"])))
    c = p["clus"]
    p.update(zip(names, lb.clusters_plain(
        plan, inp, p["nm"], None if c is None else c.assign_new,
        None if c is None else c.centroids3, p["slots"])))
    shapes = [None if x is None else tuple(x.shape) for x in X]
    k["grads"] = lb.bwd_kernel(a, plan, dev, k["saved"], k["code"], g_terms,
                               g_total, needs, shapes)
    p["grads"] = lb.bwd_plain(plan, inp, p["saved"], p["code"], g_terms,
                              g_total, needs, *X)
    return a, k, p, init


def k10_compare(label, plan, inp, X, needs, gen, g_terms=None, quiet=False):
    """`k10_pair` held bit for bit (the plain version repeats K10's
    roundings and order of sums, and K10 has no float atomics): the
    normals, their valid flags, K7's assignment and centroids, the
    members' codes, the slots, the terms, their total, the rgb mean, the
    saved state and every gradient. Returns (failures, the run (the
    kernel's and the plain version's outputs, the inputs, each cluster's
    members), the largest |kernel - plain| by launcher)."""
    from normal_clustering_nerf_torch.ops import loss_block as lb
    g_total = torch.ones((), device=X[1].device)
    a, k, p, init = k10_pair(plan, inp, X, needs, g_terms, g_total, gen)
    bad, err = [], {n: 0.0 for n in K10_LAUNCHERS}
    d = bits_differ(k["nm"], p["nm"])
    if d or not torch.equal(k["valid"], p["valid"]):
        bad.append(f"normals: {d} values' bits differ")
    if k["clus"] is not None:
        for n in ("assign_new", "assign_orig", "centroids3"):
            a_, b_ = getattr(k["clus"], n), getattr(p["clus"], n)
            if not torch.equal(a_, b_):
                bad.append(f"K7 {n} differs")
    if not torch.equal(k["code"], p["code"]):
        bad.append("member codes differ")
    err["loss_rays"] = max(max_abs(k["nm"], p["nm"]),
                           max_abs(k["slots"], p["slots"]))
    err["loss_clusters"] = max(max_abs(k[n], p[n])
                               for n in ("terms", "total", "mse"))
    diff = {n: bits_differ(k[n], p[n])
            for n in ("slots", "terms", "total", "mse", "saved")}
    asked = [n for n, need in zip(lb.GRAD_INPUTS, needs) if need]
    for n, gk, gp in zip(lb.GRAD_INPUTS, k["grads"], p["grads"]):
        if (gk is None) != (gp is None):
            bad.append(f"d {n}: kernel {gk is None}, plain {gp is None}")
            continue
        if gk is None:
            continue
        err["loss_bwd"] = max(err["loss_bwd"], max_abs(gk, gp.float()))
        diff[f"d {n}"] = bits_differ(gk, gp.float())
    bad += [f"{n}: {c} values' bits differ" for n, c in diff.items() if c]
    code = k["code"].abs()
    members = [int((code == g).sum()) for g in (1, 2, 3)]
    if not quiet or bad:
        log(f"  K10, {label}: {plan.n_rays} rays, {plan.n_tri} triangles, "
            f"members {members}, terms "
            + ", ".join(f"{t} {float(v):.6g}"
                        for t, v in zip(plan.terms, k["terms"]))
            + f"; grads {asked}; values whose bits differ {diff}: "
            + (f"FAIL {bad}" if bad else "ok"))
    return bad, dict(a=a, k=k, p=p, plan=plan, inp=inp, X=X, needs=needs,
                     members=members), err


def k10_case(tr, base, label, lcfg=None, mcfg=None, step=3000, ext=False,
             edit=None, rows=None, n_sup=None, strategy=None, sched=None,
             sem40=False, g_terms=False, gen=None):
    """One case of `check_loss_block`: the step's arguments `base`
    (`step_loss_args`), changed as the case says, through
    `losses.block_inputs` and `k10_compare`."""
    from normal_clustering_nerf_torch import losses
    from normal_clustering_nerf_torch.datasets.sampler import (
        build_patch_tables)
    from normal_clustering_nerf_torch.ops import loss_block as lb
    pred, target, kw, _ = base
    lcfg = lcfg or tr.cfg.loss
    mcfg = mcfg or tr.model.cfg
    pred = {k: v.clone() if torch.is_tensor(v) else v
            for k, v in pred.items()}
    target = {k: v.clone() for k, v in target.items()}
    kw = dict(kw)
    if rows is not None:   # the first rows, as a batch of this size
        pred = {k: v[:rows] if torch.is_tensor(v) and v.dim() and
                v.shape[0] == base[0]["rgb"].shape[0] else v
                for k, v in pred.items()}
    n = n_sup or pred["rgb"].shape[0]
    target = {k: v[:n] for k, v in target.items()}
    if strategy is not None:
        kw["ray_sampling_strategy"] = strategy
        if "patch" in strategy:
            t = build_patch_tables(tr.sampler.H, tr.sampler.W, 8)
            kw["patch_area"] = 64
            kw["offsets_local"] = {k: getattr(t, f"{k}_local")
                                   for k in ("x1", "x2", "x3")}
    kw["random_tr_poses"] = n_sup is not None
    if sem40:
        N = pred["rgb"].shape[0]
        wide = torch.randn((N, SEM_WIDE), generator=gen, device=tr.device)
        pred["sem"] = wide[:, 6:]
        target["semantics"] = torch.randint(0, SEM_CLASSES + 1, (n,),
                                            generator=gen, device=tr.device)
        mcfg = dataclasses.replace(mcfg, n_sem_cls=SEM_CLASSES)
    if edit is not None:
        edit(pred)
    if sched is None:
        sched = losses._step_scalars(lcfg, step, tr.device)
    plan, inp, xs = losses.block_inputs(
        pred, target, lcfg, mcfg,
        ray_sampling_strategy=kw["ray_sampling_strategy"],
        random_tr_poses=kw["random_tr_poses"], patch_area=kw["patch_area"],
        offsets_local=kw["offsets_local"], kmeans_init=None, generator=None,
        sched=sched)
    X = [None if xs.get(k) is None else xs[k].detach()
         for k in lb.GRAD_INPUTS]
    needs = [x is not None for x in X]
    needs[2] = needs[2] and not lcfg.distortion_ts_bug_compat
    needs[5] = needs[6] = ext and X[5] is not None
    gt = (torch.randn(len(plan.terms), generator=gen, device=tr.device)
          if g_terms else None)
    return k10_compare(label, plan, inp, X, needs, gen, gt)


def k10_function(tr, base, lcfg, ext, gen):
    """`compute_losses` through K10's Function (as the trainer calls it)
    against `k10_pair`'s launchers on the same inputs: the terms, the
    total and every gradient bit for bit (the same kernels, no atomics),
    and with `distortion_ts_bug_compat` no gradient of the weights."""
    from normal_clustering_nerf_torch import losses
    from normal_clustering_nerf_torch.ops import kmeans as km
    from normal_clustering_nerf_torch.ops import loss_block as lb
    pred, target, kw, _ = base
    sched = losses._step_scalars(lcfg, 3000, tr.device)
    leaves = ("rgb", "opacity", "ws", "depth") + (
        ("rays_o", "rays_d") if ext else ())
    p = {k: v.clone() if torch.is_tensor(v) else v for k, v in pred.items()}
    for k in leaves:
        p[k] = p[k].detach().requires_grad_(True)
    # the logits a view of a leaf row, as split_rend hands them over
    wide = torch.zeros((p["sem"].shape[0], 6 + p["sem"].shape[1]),
                       device=tr.device)
    wide[:, 6:] = p["sem"].detach()
    wide.requires_grad_(True)
    p["sem"] = wide[:, 6:]
    init = {}
    kw = {k: kw[k] for k in ("ray_sampling_strategy", "random_tr_poses",
                             "patch_area", "offsets_local")}
    draw = km.draw_init

    def fixed(valid, K, generator):
        init.setdefault("i", draw(valid, K, gen))
        return init["i"]
    km.draw_init = fixed
    try:
        out = losses.compute_losses(p, target, lcfg, tr.model.cfg, step=3000,
                                    sched=sched, **kw)
        out["total"].backward()
        plan, inp, xs = losses.block_inputs(
            {k: v.detach() if torch.is_tensor(v) else v
             for k, v in p.items()}, target, lcfg, tr.model.cfg,
            kmeans_init=init["i"], generator=None, sched=sched, **kw)
    finally:
        km.draw_init = draw
    X = [None if xs.get(k) is None else xs[k].detach()
         for k in lb.GRAD_INPUTS]
    needs = [x is not None for x in X]
    needs[2] = not lcfg.distortion_ts_bug_compat
    needs[5] = needs[6] = ext and X[5] is not None
    _, k, _, _ = k10_pair(plan, inp, X, needs, None,
                          torch.ones((), device=tr.device), gen)
    bad = []
    got = torch.stack([out[t].detach() for t in plan.terms])
    if bits_differ(got, k["terms"]):
        bad.append("terms")
    grads = {"rgb": p["rgb"].grad, "opacity": p["opacity"].grad,
             "depth": p["depth"].grad, "sem": wide.grad[:, 6:]}
    if ext:
        grads.update(rays_o=p["rays_o"].grad, rays_d=p["rays_d"].grad)
    for n, g in zip(lb.GRAD_INPUTS, k["grads"]):
        if n in grads and (grads[n] is None or bits_differ(grads[n], g)):
            bad.append(f"d {n}")
    if lcfg.distortion_ts_bug_compat and p["ws"].grad is not None:
        bad.append("ts_bug_compat: ws got a gradient")
    if not lcfg.distortion_ts_bug_compat and p["ws"].grad is None:
        bad.append("ws got no gradient")
    return bad


def k10_bound(plan, inp, X, needs):
    """K10's launchers' bytes (each input read once, each output written
    once) and f32 operations on this run's inputs X (GRAD_INPUTS) and
    asked gradients `needs`, by launcher. loss_rays reads the supervised
    rays' rgb, target, logits and labels, every ray's opacity and dl, the
    clustering rays' o, d and depth and the triangles' indices, and
    writes the normals, the flags and the slots (~45 operations a normal,
    8 a ray, 12 + 6 C a supervised ray). loss_clusters reads the normals,
    K7's assignment and the slots and writes the codes (two sweeps, ~60
    operations a row). loss_bwd reads, for each asked gradient, what it
    is made of (d rgb: the supervised rgb and target; d opacity: the
    opacity; d dl: nothing, it is one constant; d sem: the supervised
    logits and labels; d depth, d rays_o, d rays_d: the clustering rays'
    o, d and depth, the indices, the table and the codes, and d depth the
    other rays' d), and writes each asked gradient, d sem a row for every
    ray (~10 operations a ray, 6 C a supervised one, ~90 a ray's entry of
    the table: its triangle recomputed and differentiated)."""
    N, n, T, C = plan.n_rays, plan.n_sup, plan.n_tri, plan.n_cls
    M = N - plan.unsup if plan.clustering else 0
    W = inp.table.shape[1] if plan.clustering else 0
    lab = inp.labels.element_size() if C else 0
    rgb, sem = n * 24, n * (C * 4 + lab)
    tri = M * 28 + T * 24
    rays = (rgb + sem + N * 4 + (N * 4 if X[2] is not None else 0) + tri)
    asked = [need and x is not None for need, x in zip(needs, X)]
    geo = any(asked[4:7]) and plan.clustering
    reads = (rgb * asked[0] + N * 4 * asked[1] + sem * asked[3]
             + (tri + M * W * 4 + T + (N - M) * 12 * asked[4]) * geo)
    writes = sum(b for b, a in zip((N * 12, N * 4, N * 4, N * C * 4, N * 4,
                                    N * 12, N * 12), asked) if a)
    return {
        "loss_rays": bound(rays + T * 13 + plan.blocks * 20,
                           T * 45 + N * 8 + n * (12 + 6 * C)),
        "loss_clusters": bound(T * 12 + T * 8 + T + plan.blocks * 20,
                               T * 60),
        "loss_bwd": bound(reads + writes,
                          N * 10 + n * 6 * C + M * W * 90 * geo),
    }


def check_loss_block(tr, layout, rec, gen, full=True):
    """K10 against its plain version on a training step's own arguments
    (`step_loss_args`; `k10_compare`), at full weights (step 3000); with
    `full` also at step 0 (weights 0), with rgb and opacity alone (no
    depth or rays read), past norm_can_end, with an empty cluster (the
    member discard at a tiny threshold), the snapping and the member
    discard, NaN and zero normals, patch triangles, random poses
    (triangles and patches), the ext path's ray gradients, 40 classes,
    distortion_ts_bug_compat (no dl gradient) and a cotangent of every
    term besides the total's; and `compute_losses` through the Function
    against the launchers (`k10_function`). The triplane field's base
    case is kept in `rec` for `time_kernels`."""
    from normal_clustering_nerf_torch.ops import loss_block as lb
    base = step_loss_args(tr)
    lc = tr.cfg.loss
    log(f"K10 on a training step's arguments ({layout}, step {tr.step - 1}): "
        f"{base[0]['rgb'].shape[0]} rays, terms of {lc}")
    failures, errs = [], {n: 0.0 for n in K10_LAUNCHERS}

    def run(label, **kw):
        bad, r, err = k10_case(tr, base, f"{layout}, {label}", gen=gen,
                               **kw)
        failures.extend(f"{label}: {b}" for b in bad)
        for n in errs:
            errs[n] = max(errs[n], err[n])
        return r
    r0 = run("step 3000 (full weights)")
    if full:
        rp = dataclasses.replace
        run("step 0 (weights 0)", step=0)
        run("rgb and opacity only (the bench's --min_losses)",
            lcfg=rp(lc, distortion_w=0.0, sem_w=0.0, norm_D_C_ort_dot_w=0.0,
                    norm_D_C_centr_dot_w=0.0, norm_D_C_centr_L1_w=0.0))
        run("past norm_can_end", lcfg=rp(lc, norm_can_end=2000))
        r = run("an empty cluster (member discard at 1e-7)",
                lcfg=rp(lc, discard_far_members=True, norm_can_tres=1e-7))
        cl = [float(v) for t, v in zip(r["plan"].terms, r["k"]["terms"])
              if t in lb.CLUSTER_TERMS]
        if min(r["members"]) or any(cl):
            failures.append(f"an empty cluster: members {r['members']}, "
                            f"clustering terms {cl} (expected a cluster "
                            f"empty and the terms 0)")
        # a threshold at which the centroids snap (1 - c . axis < 0.9)
        r = run("snapping and member discard",
                lcfg=rp(lc, norm_D_C_can_dot_w=2e-3, norm_D_C_can_L1_w=2e-3,
                        discard_far_members=True, norm_can_tres=0.3))
        snap = [float(v) for t, v in zip(r["plan"].terms, r["k"]["terms"])
                if t in ("norm_D_C_can_dot", "norm_D_C_can_L1")]
        if not all(snap):
            failures.append(f"snapping: terms {snap} (expected them on)")

        def nan_zero(pred):
            pred["depth"][5] = float("nan")          # triangle 1
            for r in (31, 32):                      # triangle 10: one point
                pred["rays_o"][r] = pred["rays_o"][30]
                pred["rays_d"][r] = pred["rays_d"][30]
                pred["depth"][r] = pred["depth"][30]
        run("NaN and zero normals", edit=nan_zero)
        N = base[0]["rgb"].shape[0]
        # the batch's first rays as patches of 8 x 8 (127 at the bench's
        # 8190 rays); with random poses half of them of each kind
        run("patch triangles", rows=N - N % 64,
            strategy="all_images_triang_patch")
        run("random poses", n_sup=N // 2)
        run("random poses, patch triangles", rows=N - N % 128,
            n_sup=(N - N % 128) // 2, strategy="all_images_triang_patch")
        run("ext: ray gradients", ext=True)
        run(f"{SEM_CLASSES} classes", sem40=True)
        run("distortion_ts_bug_compat (no dl gradient)",
            lcfg=rp(lc, distortion_ts_bug_compat=True))
        run("a cotangent of every term", g_terms=True)
        for ext in (False, True):
            bad = k10_function(tr, base, lc, ext, gen)
            log(f"  K10, {layout}: compute_losses through the Function"
                f"{' (ext)' if ext else ''} bit for bit the launchers': "
                + (f"FAIL {bad}" if bad else "ok"))
            failures.extend(f"Function{' ext' if ext else ''}: {b}"
                            for b in bad)
        bad = k10_function(tr, base, rp(lc, distortion_ts_bug_compat=True),
                           False, gen)
        log("  K10: compute_losses with distortion_ts_bug_compat: "
            + (f"FAIL {bad}" if bad else "no gradient of the weights ok"))
        failures.extend(f"Function ts_bug_compat: {b}" for b in bad)
        try:
            lb.make_args(r0["plan"], r0["inp"],
                         *[None if x is None else x.cpu() for x in r0["X"]])
            failures.append("K10 took a CPU tensor")
        except ValueError as e:
            log(f"  K10 on a CPU tensor: refused ok ({e})")
    if failures:
        raise RuntimeError(f"K10 against its plain version: {failures}")
    log(f"K10 against its plain version ({layout}): ok; max |kernel - "
        f"plain| by launcher {errs}")
    if rec is None:
        return
    a, k, p = r0["a"], r0["k"], r0["p"]
    plan, inp, X, needs = r0["plan"], r0["inp"], r0["X"], r0["needs"]
    bounds = k10_bound(plan, inp, X, needs)
    dev = k["nm"].device
    g_total = torch.ones((), device=dev)
    shapes = [None if x is None else tuple(x.shape) for x in X]
    ac = k10_args_copy(a, nm=k["nm"], slots=k["slots"])
    rec["loss_rays"] = dict(
        err=errs["loss_rays"], library=None, bound=bounds["loss_rays"],
        kernel=lambda: lb.rays_kernel(k10_args_copy(a), plan, dev),
        plain=lambda: lb.rays_plain(plan, inp, *X))
    rec["loss_clusters"] = dict(
        err=errs["loss_clusters"], library=None,
        bound=bounds["loss_clusters"],
        kernel=lambda: lb.clusters_kernel(ac, plan, dev, k["clus"]),
        plain=lambda: lb.clusters_plain(plan, inp, p["nm"],
                                        p["clus"].assign_new,
                                        p["clus"].centroids3, p["slots"]))
    rec["loss_bwd"] = dict(
        err=errs["loss_bwd"], library=None, bound=bounds["loss_bwd"],
        kernel=lambda: lb.bwd_kernel(k10_args_copy(a), plan, dev, k["saved"],
                                     k["code"], None, g_total, needs,
                                     shapes),
        plain=lambda: lb.bwd_plain(plan, inp, p["saved"], p["code"], None,
                                   g_total, needs, *X))



REPLACES = {
    "march_bootstrap": "normal_clustering_nerf_tpu/ops/ray_march.py:402",
    "triplane_fwd": "normal_clustering_nerf_tpu/models/triplane.py:177",
    "triplane_bwd": "normal_clustering_nerf_tpu/models/triplane.py:206",
    "composite_fwd": "normal_clustering_nerf_tpu/ops/composite.py:34",
    "composite_bwd": "normal_clustering_nerf_tpu/ops/composite.py:34",
    "distortion_fwd": "normal_clustering_nerf_tpu/ops/distortion.py:36",
    "distortion_bwd": "normal_clustering_nerf_tpu/ops/distortion.py:36",
    "march_sv_train": "normal_clustering_nerf_tpu/ops/ray_march.py:519",
    "march_sv_test_round": "normal_clustering_nerf_tpu/ops/ray_march.py:773",
    # the Pallas probe P4 (pallas16) of the brick forward's gather stage;
    # the JAX function is models/brick_hash.py:178 `_brick_encode_impl`
    "brick_fwd": "experiments/pallas_gather2.py:77",
    "brick_bwd": "normal_clustering_nerf_tpu/models/brick_hash.py:208",
    "hash_grid_fwd": "normal_clustering_nerf_tpu/models/hash_encoding.py:123",
    "hash_grid_bwd": "normal_clustering_nerf_tpu/models/hash_encoding.py:199",
    # the Pallas bit probe P2 (pallas_bit) of the bitfield march; the JAX
    # functions are ops/ray_march.py:402 `march_rays_train_dense` and :820
    # `march_rays_test_round_dense` (and the bucket round's window)
    "march_fine_train": "experiments/pallas_gather_probe.py:84",
    "march_fine_test_round": "experiments/pallas_gather_probe.py:84",
    "compact_samples": "normal_clustering_nerf_tpu/ops/ray_march.py:157",
    "composite_seg_fwd": "normal_clustering_nerf_tpu/ops/composite.py:86",
    "composite_seg_bwd": "normal_clustering_nerf_tpu/ops/composite.py:86",
    "distortion_seg_fwd": "normal_clustering_nerf_tpu/ops/distortion.py:19",
    "distortion_seg_bwd": "normal_clustering_nerf_tpu/ops/distortion.py:19",
    # the need_dx branches of the encodes' custom VJPs: H12-H14 from the
    # forward's Jacobian, contracted in the table gradient's launch (H12)
    # or in a launch of its own (H13, H14)
    "triplane_fwd_jac": "normal_clustering_nerf_tpu/models/triplane.py:230",
    "triplane_bwd_dx": "normal_clustering_nerf_tpu/models/triplane.py:230",
    "brick_fwd_jac": "normal_clustering_nerf_tpu/models/brick_hash.py:225",
    "brick_contract": "normal_clustering_nerf_tpu/models/brick_hash.py:225",
    "hash_grid_fwd_jac":
        "normal_clustering_nerf_tpu/models/hash_encoding.py:228",
    "hash_grid_contract":
        "normal_clustering_nerf_tpu/models/hash_encoding.py:228",
    # K7: normals_clustering with its spherical_kmeans (:20); K8: the
    # refresh's occupied list (sample_update_cells), its merge, mean and
    # pack (update, with ops/packbits.py:16) and its tables
    # (supervoxel_tables, with coarse_occupancy :44)
    "kmeans_cluster": "normal_clustering_nerf_tpu/ops/kmeans.py:61",
    "occ_compact": "normal_clustering_nerf_tpu/models/occupancy.py:143",
    "occ_merge_pack": "normal_clustering_nerf_tpu/models/occupancy.py:179",
    "occ_tables": "normal_clustering_nerf_tpu/models/occupancy.py:68",
    # the OR of several cards' bitfields (merge_across_chips' pmax of the
    # unpacked bits)
    "occ_union": "normal_clustering_nerf_tpu/models/occupancy.py:295",
    # K9: build_optimizer's chain (clip_by_global_norm, then adamw / adam
    # by group), applied at training/trainer.py:365
    "adamw_norm": "normal_clustering_nerf_tpu/training/state.py:43",
    "adamw_step": "normal_clustering_nerf_tpu/training/state.py:43",
    # K10: compute_losses' rgb, opacity, distortion and sem terms with the
    # depth normals (datasets/normals.py) and their gradient; the
    # clustering terms of _clustering_losses (:94)
    "loss_rays": "normal_clustering_nerf_tpu/losses.py:189",
    "loss_clusters": "normal_clustering_nerf_tpu/losses.py:94",
    "loss_bwd": "normal_clustering_nerf_tpu/losses.py:189",
}
LABEL = {"march_bootstrap": "H1", "triplane_fwd": "H2", "triplane_bwd": "H2",
         "composite_fwd": "H3", "composite_bwd": "H3",
         "distortion_fwd": "H4", "distortion_bwd": "H4",
         "march_sv_train": "K1", "march_sv_test_round": "K1",
         "brick_fwd": "H5", "brick_bwd": "H6", "hash_grid_fwd": "H7",
         "hash_grid_bwd": "H8", "march_fine_train": "H9",
         "march_fine_test_round": "H10", "compact_samples": "H11",
         "composite_seg_fwd": "H3", "composite_seg_bwd": "H3",
         "distortion_seg_fwd": "H4", "distortion_seg_bwd": "H4",
         "triplane_fwd_jac": "H12", "triplane_bwd_dx": "H12",
         "brick_fwd_jac": "H13", "brick_contract": "H13",
         "hash_grid_fwd_jac": "H14",
         "hash_grid_contract": "H14", "kmeans_cluster": "K7",
         "occ_compact": "K8", "occ_merge_pack": "K8", "occ_tables": "K8",
         "occ_union": "K8", "adamw_norm": "K9", "adamw_step": "K9",
         "loss_rays": "K10", "loss_clusters": "K10", "loss_bwd": "K10"}


def time_kernels(rec):
    """Device time of each kernel, of its plain version and of its PyTorch
    yardstick where it has one, on the inputs the checks kept."""
    for name, r in rec.items():
        r["ms"] = device_ms(r.pop("kernel"), name)
        r["plain_ms"] = device_ms(r.pop("plain"), f"{name} plain")
        lib = r.pop("library", None)
        r["library_ms"] = device_ms(lib, f"{name} library") if lib else None
        if "fill" in r:
            r["fill_ms"] = device_ms(r.pop("fill"), f"{name} fill")
        if "step_cotangent" in r:
            r["step_cotangent_ms"] = device_ms(r.pop("step_cotangent"),
                                               f"{name} step cotangent")
            log(f"  {name}: {r['ms']:.4f} ms on a random f32 cotangent, "
                f"{r['step_cotangent_ms']:.4f} ms on a training step's; "
                f"the zero fill alone {r['fill_ms']:.4f} ms, index_add_ "
                f"{r['library_ms']:.4f} ms")
        vbounds = r.pop("variant_bounds", {})
        for where, fn in r.pop("variants", {}).items():
            ms = device_ms(fn, f"{name} {where}")
            r.setdefault("variants_ms", {})[where] = ms
            vb = vbounds.get(where)
            if vb:
                r.setdefault("variants_bound_ms", {})[where] = vb[0]
            log(f"  {name} at the {where}: {ms:.4f} ms"
                + (f" (bound {vb[0]:.6f}, {vb[1]})" if vb else ""))
        for where, c in r.pop("counts", {}).items():
            log_counts(name, where, c)
        if "wide" in r:
            w = r.pop("wide")
            r["c46_shape"] = w["shape"]
            r["c46_ms"] = device_ms(w["kernel"], f"{name} C {WIDE_TIMED}")
            r["c46_plain_ms"] = device_ms(w["plain"],
                                          f"{name} C {WIDE_TIMED} plain")
            r["c46_bound_ms"] = w["bound"][0]
            log(f"  {name} at {w['shape']}: {r['c46_ms']:.4f} ms, plain "
                f"{r['c46_plain_ms']:.4f} (bound {w['bound'][0]:.6f}, "
                f"{w['bound'][1]})")
        if "k64" in r:
            k = r.pop("k64")
            r["k64_shape"] = k["shape"]
            r["k64_launches"] = k["launches"]
            r["k64_ms"] = device_ms(k["kernel"], f"{name} K 64")
            r["k64_plain_ms"] = device_ms(k["plain"], f"{name} K 64 plain")
            r["k64_bound_ms"] = k["bound"][0]
            log(f"  {name} at {k['shape']} ({k['launches']} launches on the "
                f"K64 path): {r['k64_ms']:.4f} ms, plain "
                f"{r['k64_plain_ms']:.4f} (bound {k['bound'][0]:.6f}, "
                f"{k['bound'][1]})")
        if "cascades" in r:
            c = r.pop("cascades")
            r["cascades_shape"] = c["shape"]
            r["cascades_launches"] = c["launches"]
            r["cascades_ms"] = device_ms(c["kernel"], f"{name} cascades")
            r["cascades_plain_ms"] = device_ms(c["plain"],
                                               f"{name} cascades plain")
            r["cascades_bound_ms"] = c["bound"][0]
            log(f"  {name} on the cascades path ({c['shape']}; "
                f"{c['launches']} launches): {r['cascades_ms']:.4f} ms, "
                f"plain {r['cascades_plain_ms']:.4f} (bound "
                f"{c['bound'][0]:.6f}, {c['bound'][1]}); the Uniform body "
                f"above {r['ms']:.4f} ms")
        if "at_p4_shape" in r:
            p4 = r.pop("at_p4_shape")
            r["p4_ms"] = device_ms(p4["kernel"], f"{name} P4")
            r["p4_library_ms"] = device_ms(p4["library"], f"{name} P4 library",
                                           5)
            r["p4_bound_ms"] = p4["bound"][0]
            log(f"  {name} at P4's shape, {P4_POINTS} points: {r['p4_ms']:.4f}"
                f" ms (bound {r['p4_bound_ms']:.4f}, {p4['bound'][1]}); "
                f"index_select of the 16 x {P4_POINTS} whole rows P4 gathers: "
                f"{r['p4_library_ms']:.4f} ms")
        if "at_p2_shape" in r:
            p2 = r.pop("at_p2_shape")
            r["p2_ms"] = device_ms(p2["kernel"], f"{name} P2")
            r["p2_library_ms"] = device_ms(p2["library"], f"{name} P2 library")
            r["p2_bound_ms"] = p2["bound"][0]
            log(f"  {name} full window at P2's block, {P2_RAYS} x "
                f"{P2_STEPS}: {r['p2_ms']:.4f} ms (bound "
                f"{r['p2_bound_ms']:.4f}, {p2['bound'][1]}); P2's form in "
                f"torch on precomputed cells: {r['p2_library_ms']:.4f} ms")
    for name, r in rec.items():
        if "dx_pair" in r:
            f = rec[r["dx_pair"]]
            own = r.get("variants_ms", {}).get(NO_DX, 0.0)
            r["dx_cost_ms"] = (f["ms"] - f["variants_ms"][NO_DX]
                               + r["ms"] - own)
            log(f"  {LABEL[name]}'s position gradient: {r['dx_cost_ms']:.4f} "
                f"ms = {r.pop('dx_pair')} {f['ms']:.4f} - "
                f"{f['variants_ms'][NO_DX]:.4f} without the Jacobian + "
                f"{name} {r['ms']:.4f} - {own:.4f} without the contraction")
    log("  timed from a CUDA graph: every call"
        + (f" but {', '.join(QUEUED)} (timed queued)" if QUEUED else ""))


def counted(fn):
    """Run `fn` with every launch count set to 0 just before; returns its
    result, the counts just after, and its wall time (s, synchronized)."""
    from normal_clustering_nerf_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_counts()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.counts(), time.perf_counter() - t


def train(tr, name, phases, need, exact):
    """Phase 3: a path's training steps through `Trainer.fit`, counted:
    `phases` (label, steps), timed apart. Every launcher in `need` must
    have launched, and those in `exact` exactly so many times. Returns
    (history, counts, seconds of each phase)."""
    times = []

    def run():
        hist = []
        for _, n in phases:
            t = time.perf_counter()
            hist += tr.fit(n)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return hist
    hist, counts, _ = counted(run)
    log(f"launches in {sum(n for _, n in phases)} {name} steps: {counts}")
    missing = [n for n in need if counts[n] == 0]
    if missing:
        raise RuntimeError(f"kernels never launched on the {name} path: "
                           f"{missing}")
    wrong = {k: counts[k] for k, v in exact.items() if counts[k] != v}
    if wrong:
        raise RuntimeError(f"{name} path: launch counts {wrong}, expected "
                           f"{ {k: exact[k] for k in wrong} }")
    return hist, counts, times


def check_losses(hist, marks, fall=True, untrained=()):
    """Every loss finite; the losses at the steps `marks` (label, index)
    logged; with `fall`, the mean of the last 6 steps under 0.75 of the
    first 6 (the random background makes single steps noisy), of the
    total less the components `untrained` (terms that give the parameters
    no gradient)."""
    bad = [(i, k) for i, m in enumerate(hist) for k, v in m.items()
           if k.startswith("loss_") and not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"non-finite losses: {bad[:10]}")
    for name, i in marks:
        m = hist[i]
        log(f"  {name} step: loss {m['loss_total']:.6f} psnr {m['psnr']:.3f} "
            f"rm/ray {m['rm_samples_per_ray']:.3f} "
            f"vr/ray {m['vr_samples_per_ray']:.3f} "
            f"trunc {m['trunc_ray_frac']:.4f}")
    q = 6
    head, tail = (sum(m["loss_total"] - sum(m[k] for k in untrained)
                      for m in ms) / q for ms in (hist[:q], hist[-q:]))
    if fall and not tail < 0.75 * head:
        raise RuntimeError(f"the loss did not fall: mean {head:.6f} over the "
                           f"first {q} steps, {tail:.6f} over the last {q}")
    return head, tail


def validate(tr, name, need, absent=(), rotation=True, metrics=(),
             out=None):
    """Phase 5: `Trainer.validate()` on the held-out views, counted: the
    launchers in `need` must launch and those in `absent` must not; every
    metric finite, the columns `metrics` present and, with `rotation`, the
    rotation recovered. The metrics go into `out` when given; returns the
    counts."""
    res, counts, wall = counted(tr.validate)
    out = res if out is None else out
    out.update(res)
    if [k for k in metrics if k not in out]:
        raise RuntimeError(f"{name} validate: no {metrics} in {sorted(out)}")
    log(f"launches in {name} validate: {counts}")
    for k in need:
        if not counts[k]:
            raise RuntimeError(f"{name} validate never launched {k}")
    for k in absent:
        if counts[k]:
            raise RuntimeError(f"{name} validate launched {k}")
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    if bad:
        raise RuntimeError(f"non-finite metrics: {bad}")
    rot = [f"ang/clust/{a}_abs" for a in ("yaw", "pitch", "roll")]
    if rotation and ("ang/clust/failed" in out
                     or not all(k in out for k in rot)):
        raise RuntimeError(f"rotation recovery failed: {out}")
    log(f"phase 5, {name}: validate {wall * 1e3:.1f} ms "
        f"({tr.last_render['rounds']} "
        f"rounds, {tr.last_render['total_samples']} samples): psnr "
        f"{out['psnr']:.3f}, norm_depth_ang_mean "
        f"{out['norm_depth_ang_mean']:.3f}, rot yaw/pitch/roll "
        + "/".join(f"{out.get(k, float('nan')):.3f}" for k in rot)
        + f", ssim {out['ssim']:.4f}, depth_rmse {out['depth_rmse']:.4f}, "
        f"miou {out.get('miou', float('nan')):.4f}")
    return counts


def step_times(tr, n=8):
    """Host-clock time of single bootstrap and sv steps (medians of n) and
    of one refresh of each form, each ended by a synchronize."""
    def once(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3
    boot = sorted(once(lambda: tr.train_step_core(bootstrap=True))
                  for _ in range(n))[n // 2]
    sv = sorted(once(lambda: tr.train_step_core(bootstrap=False))
                for _ in range(n))[n // 2]
    return (boot, sv, once(lambda: tr.occ_update(warmup=True)),
            once(lambda: tr.occ_update(warmup=False)))


def profile(tr, name, out_dir, step_ms, n=4):
    """Trace `n` steps of each march with torch.profiler: the device's busy
    time per step split into the port's kernels, matrix products and the
    rest, the launches per step, and the idle share against the
    unprofiled step time `step_ms[boot]`. Writes each trace's per-kernel
    table and a chrome trace, named by the path and the march (bootstrap
    steps, and steps after the bootstrap)."""
    import gzip
    import os
    import shutil
    from normal_clustering_nerf_torch.bench import split_device_time
    os.makedirs(out_dir, exist_ok=True)
    for boot in (True, False):
        tag = f"{name}_{'bootstrap' if boot else 'after'}"

        def steps():
            for _ in range(n):
                tr.train_step_core(bootstrap=boot)
        p, dev = traced(steps)
        if not dev:
            log(f"profile of {n} {tag} steps: the profiler recorded no "
                "device time; no profile")
            continue
        table = p.key_averages().table(sort_by="self_cuda_time_total",
                                       row_limit=40)
        with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
            f.write(table)
        # gzipped: ten traces of 4 steps each would pass 64 MB as JSON
        trace = os.path.join(out_dir, f"trace_{tag}.json")
        p.export_chrome_trace(trace)
        with open(trace, "rb") as f, gzip.open(trace + ".gz", "wb") as g:
            shutil.copyfileobj(f, g)
        os.remove(trace)
        split, launches = split_device_time(dev, n)
        busy = sum(split.values())
        log(f"profile of {n} {tag} steps: device busy {busy:.3f} ms/step ("
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"), {launches:.0f} device launches/step, "
            f"idle {1 - busy / step_ms[boot]:.3f} of the "
            f"{step_ms[boot]:.2f} ms step")
        for line in table.splitlines()[:24]:
            print(line)


TWO_PHASES = (("bootstrap", BOOT_STEPS), ("after the bootstrap", SV_STEPS))


def path_training(tr, name, launches, need, exact, phases=TWO_PHASES,
                  fall=True, untrained=()):
    """Phase 3 of one path: `train`, the loss checks (`untrained`: see
    `check_losses`), and its launches added to `launches`. Returns fit's
    ms/step over each phase and the steps' metrics."""
    hist, counts, secs = train(tr, name, phases, need, exact)
    marks, i = [("first", 0)], 0
    for label, n in phases[:-1]:
        i += n
        marks += [(f"last {label}", i - 1), (f"first {phases[1][0]}", i)]
    head, tail = check_losses(hist, marks + [("last", -1)], fall, untrained)
    for k, c in counts.items():
        launches[k] += c
    ms = [t * 1e3 / n for (_, n), t in zip(phases, secs)]
    log(f"  losses finite{' and falling' if fall else ''} ({head:.6f} -> "
        f"{tail:.6f}, means of 6 steps); fit "
        + ", ".join(f"{m:.2f} ms/step over the {n} {label} steps"
                    for m, (label, n) in zip(ms, phases))
        + f" ({math.ceil(sum(n for _, n in phases) / 16)} refreshes)")
    return ms, hist


def check_pose_deltas(tr, start, n_steps):
    """After `n_steps` ext steps from the parameters `start`: dR and dT
    moved, no value further than n_steps Adam updates at EXT_LR can move
    it (`adam_step_bound`), and dR_glob, which nothing reads, exactly 0."""
    from normal_clustering_nerf_torch.training.state import EXT_LR
    lim = n_steps * adam_step_bound(EXT_LR) * (1 + 1e-5)
    moved = {k: float((tr.params[k].detach() - start[k]).abs().max())
             for k in ("dR", "dT")}
    log(f"  pose deltas after {n_steps} steps: max |d dR| {moved['dR']:.3e}, "
        f"max |d dT| {moved['dT']:.3e} (bound {lim:.3e}: {n_steps} x "
        f"{adam_step_bound(EXT_LR):.3e}); dR_glob "
        f"{tr.params['dR_glob'].detach().cpu().tolist()}")
    bad = [k for k, v in moved.items() if not 0 < v <= lim]
    if bad or bool((tr.params["dR_glob"] != 0).any()):
        raise RuntimeError(f"pose deltas out of bounds: {moved}, bound "
                           f"{lim}, dR_glob {tr.params['dR_glob']}")


def check_flat_rays(tr, gen):
    """The scene-box hits (`near_intervals`) of one batch of the trainer's
    rays with a direction component set to exactly 0 in every third ray
    (and a second one in every twelfth), as a rotated pose's product can
    give: with a gradient on the rays the hits equal those without one bit
    for bit, and the rays' gradient under a random cotangent is finite
    (autodiff of 1/d gives 0 * inf = NaN there, which the global-norm clip
    would spread to every parameter)."""
    from normal_clustering_nerf_torch.models.rendering import near_intervals
    batch = tr.sampler.sample(gen)
    with torch.no_grad():
        o, d = tr._assemble_rays(batch)
    o, d = o.contiguous().clone(), d.contiguous().clone()
    n = d.shape[0]
    rows = torch.arange(0, n, 3, device=d.device)
    d[rows, rows % 3] = 0.0
    rows = torch.arange(0, n, 12, device=d.device)
    d[rows, (rows + 1) % 3] = 0.0
    ref = near_intervals(tr.cfg.model, o, d)
    ro, rd = o.requires_grad_(True), d.requires_grad_(True)
    got = near_intervals(tr.cfg.model, ro, rd)
    cot = torch.randn(got.shape, generator=gen, device=got.device)
    (got * cot).sum().backward()
    zeros = int((d.detach() == 0).sum())
    finite = all(bool(torch.isfinite(g).all()) for g in (ro.grad, rd.grad))
    same = torch.equal(got.detach(), ref)
    log(f"  box hits of {n} rays with {zeros} direction components exactly "
        f"0: values {'equal' if same else 'DIFFER'} with and without a "
        f"gradient, ray gradient {'finite' if finite else 'NOT FINITE'}")
    if not (same and finite):
        raise RuntimeError("the box hits' ray gradient is not finite on "
                           "rays with a zero direction component, or its "
                           "values moved")


def ext_path(launches):
    """The slice's path, extrinsic optimisation (EXT_OPTIM): the step
    parity with dR / dT / dR_glob for the three fields; `check_flat_rays`;
    the bench configuration with EXT_OPTIM through `Trainer.fit` for STEPS
    steps (H12 once a step: H2's forward with the Jacobian and H2's
    backward with its contraction, never H2's backward without it; K1
    SV_STEPS times), its pose deltas (`check_pose_deltas`) and `validate`;
    then EXT_LAYOUT_STEPS ext steps of the brick (H13: H5 with the
    Jacobian, and its contraction beside H6) and the tcnn field (H14: H7
    with the Jacobian, and its contraction beside H8) at the bench
    configuration. Returns the triplane trainer and fit's ms/step."""
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    for layout in ("triplane", "brick", "tcnn"):
        step_parity(layout, seed=23, ext=True)
    tr = build_trainer(ext_config(bench_config()), device="cuda")
    tr.mark_invisible_cells()
    check_flat_rays(tr, torch.Generator(device="cuda").manual_seed(29))
    log(f"phase 3, ext: {STEPS} training steps through Trainer.fit with "
        f"{EXT_OPTIM} ({tr.scene_train.n_images} images' dR and dT)")
    start = {k: p.detach().clone() for k, p in tr.params.items()}
    jac_fwd, bwd_dx = DX_LAUNCHERS["triplane"]
    ms, _ = path_training(
        tr, "ext", launches,
        PATH_KERNELS + ("triplane_fwd", jac_fwd, bwd_dx),
        {"march_sv_train": SV_STEPS, jac_fwd: STEPS, bwd_dx: STEPS,
         "triplane_bwd": 0})
    check_pose_deltas(tr, start, STEPS)
    for name, c in validate(tr, "ext", ("march_sv_test_round",
                                        "triplane_fwd",
                                        "composite_fwd")).items():
        launches[name] += c
    for layout in ("brick", "tcnn"):
        tl = build_trainer(ext_config(bench_config(hash_layout=layout)),
                           device="cuda")
        tl.mark_invisible_cells()
        # the table gradient as without ext, the forward with the
        # Jacobian, the contraction
        fwd, bwd = FIELD_KERNELS[layout]
        jac_fwd, contract = DX_LAUNCHERS[layout]
        need = (fwd, bwd, jac_fwd, contract)
        exact = {jac_fwd: EXT_LAYOUT_STEPS, contract: EXT_LAYOUT_STEPS,
                 bwd: EXT_LAYOUT_STEPS}
        log(f"phase 3, {layout} ext: {EXT_LAYOUT_STEPS} training steps")
        start = {k: p.detach().clone() for k, p in tl.params.items()}
        path_training(tl, f"{layout} ext", launches,
                      need + ("march_bootstrap",), exact,
                      phases=(("bootstrap", EXT_LAYOUT_STEPS),))
        check_pose_deltas(tl, start, EXT_LAYOUT_STEPS)
    return tr, ms


GRAPH_STEPS = 16   # a chunk of the graph phase: the steps between refreshes
# the graph phase's chunks: (path, bootstrap march or not)
GRAPH_CASES = (("triplane", True), ("triplane", False), ("bitfield", False),
               ("flat", False), ("brick", False), ("tcnn", False),
               ("preset", False), ("supervised", False), ("regnerf", False),
               ("ext", False), ("sem40", True), ("host", False),
               ("cascades", False))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def snapshot(tr):
    """Copies of what a training step reads and writes: the parameters,
    the optimizer's count and moments, the occupancy, the step and the
    generator's state."""
    def clone(d):
        return {n: t.detach().clone() for n, t in d.items()}
    return dict(params=clone(tr.params), occ=type(tr.occ)(
        *(t.clone() for t in tr.occ)), step=tr.step,
        opt={"count": tr.opt.state["count"], "mu": clone(tr.opt.state["mu"]),
             "nu": clone(tr.opt.state["nu"])},
        gen=tr.generator.get_state())


def restore(tr, snap):
    tr.load_state(snap["params"], snap["occ"], snap["opt"], snap["step"])
    tr.generator.set_state(snap["gen"])


def one_step(tr, bootstrap, graph, draws=None):
    """One step from the trainer's state: a replay of its captured graph
    (`train_chunk(1)`) or an eager step (`train_step_core`, with `draws`).
    Returns the step's sampled image and pixel indices, its metrics and
    the parameters after it, copied."""
    m = (tr.train_chunk(1, bootstrap) if graph
         else tr.train_step_core(bootstrap, draws))
    b = tr.last_batch
    out = (torch.cat([b["img_idxs"], b["pix_idxs"]]).clone(),
           {k: v.detach().clone() for k, v in m.items()},
           {k: p.detach().clone() for k, p in tr.params.items()})
    sync(tr.device)
    return out


EAGER_STEPS = 3   # eager steps from each replay's state in the graph phase


def within_spread(got, eager):
    """A replay's value against the same value from EAGER_STEPS eager
    steps from its state: the nearest must be within twice their spread
    (the largest difference between two of them) plus 2^-20 of the
    largest value. The spread is that of the fp32 atomics of H2/H6/H8
    (and the k-means' index_add_): a sum's last bits, which AdamW
    amplifies where a gradient nearly cancels, so that an entry of a
    table can take one of a few values a step. Returns (err, spread,
    ok)."""
    err = min((got - e).abs().max().item() for e in eager)
    spread = max((a - b).abs().max().item()
                 for i, a in enumerate(eager) for b in eager[i + 1:])
    tol = 2 * spread + 2.0 ** -20 * eager[0].abs().max().item()
    return err, spread, err <= tol


def check_graph_chunk(tr, path, bootstrap):
    """A chunk of GRAPH_STEPS replays of the trainer's captured graph,
    each held against EAGER_STEPS eager steps from the state and generator
    state the replay started from: the sampled indices and the rm / vr /
    trunc counts equal, the losses and the parameters after within the
    eager steps' spread (`within_spread`). Step by step, because the fp32
    atomics make whole runs part: a sum's last bit can flip a later
    rounding, after which two runs of the same chunk, eager or graph,
    follow different trajectories (parameters 1e-6 to 1e-3 apart after
    16 steps, PERF.md section 6)."""
    from normal_clustering_nerf_torch.models.rendering import (
        train_march_kind)
    kind = train_march_kind(tr.model.cfg, tr.cfg.render, tr.occ, bootstrap)
    captured = [c["kind"] for c in tr.captures]
    if tr.device.type == "cuda" and kind not in captured:
        raise RuntimeError(f"{path}: the training phase captured no {kind} "
                           f"graph (captures: {captured})")
    tag, start = f"{path}, {kind} chunk", tr.step
    states, graph, loaded = [], [], []
    for _ in range(GRAPH_STEPS):
        states.append(snapshot(tr))
        graph.append(one_step(tr, bootstrap, True))
        if tr.native_sampler is not None:   # the host batch it was fed
            loaded.append(tr.host_feed.block[0].long().reshape(-1).clone())
    end = snapshot(tr)
    if [c["kind"] for c in tr.captures] != captured:
        raise RuntimeError(f"{tag}: a capture during the replays")
    if loaded:
        check_host_batches(tag, graph, loaded)
    eager = []
    for st, g in zip(states, graph):
        runs, draws = [], None
        if loaded:   # the eager steps take the replay's host batch
            img, pix = g[0].chunk(2)
            draws = {"batch": {"img_idxs": img, "pix_idxs": pix}}
        for _ in range(EAGER_STEPS):
            restore(tr, st)
            runs.append(one_step(tr, bootstrap, False, draws))
        eager.append(runs)
    restore(tr, end)
    log(f"graph phase, {tag} from step {start}: {GRAPH_STEPS} replays, "
        f"each against {EAGER_STEPS} eager steps from its state")
    hold_steps(f"graph phase, {tag}", graph, eager, tr.sampler.batch_size)


def check_host_batches(tag, graph, loaded):
    """Host-sampler replays: each read the batch its chunk loaded into the
    device block (indices equal), and no two read the same batch."""
    chk = Check()
    got = torch.stack([g[0] for g in graph])
    chk.equal("replayed indices = the host batch loaded for the step", got,
              torch.stack(loaded))
    same = sum(bool((got[i] == got[j]).all()) for i in range(len(got))
               for j in range(i))
    log(f"  {same} of {len(got) * (len(got) - 1) // 2} pairs of replays "
        f"read the same batch {'ok' if not same else 'FAIL'}")
    if same:
        chk.failures.append("a host batch read twice")
    chk.done(tag)


def hold_steps(tag, graph, eager, n_rays, what="graph"):
    """Steps (each as `one_step` returns it) against the EAGER_STEPS eager
    steps from the state each started from (`eager`, a list a step): the
    sampled indices and the rm / vr / trunc counts equal, the losses and
    the parameters after within the eager steps' spread
    (`within_spread`). Raises on any failure."""
    chk = Check()
    chk.equal("sampled indices, every step",
              torch.stack([g[0] for g in graph]),
              torch.stack([e[0][0] for e in eager]))
    for k in ("rm_samples_per_ray", "vr_samples_per_ray", "trunc_ray_frac"):
        chk.equal(f"{k} as counts, every step",
                  torch.stack([torch.round(g[1][k] * n_rays) for g in graph]),
                  torch.stack([torch.round(e[0][1][k] * n_rays)
                               for e in eager]))
    for group, names, pick in (
            ("losses", [k for k in graph[0][1] if k.startswith("loss_")],
             lambda run, k: run[1][k]),
            ("parameters", list(graph[0][2]), lambda run, k: run[2][k])):
        worst, bad = (-1.0, 0.0, ""), []
        for k in names:
            for i, (g, runs) in enumerate(zip(graph, eager)):
                err, spread, ok = within_spread(pick(g, k),
                                                [pick(e, k) for e in runs])
                worst = max(worst, (err, spread, k))
                if not ok:
                    bad.append(f"{k} step {i}: {err:.3e} (spread "
                               f"{spread:.3e})")
        log(f"  {group}: largest {what}-eager difference {worst[0]:.3e} "
            f"({worst[2]}; eager spread there {worst[1]:.3e}), "
            + (f"{len(bad)} outside 2x the spread + 2^-20 of the largest "
               f"value FAIL: {bad[:5]}" if bad else "every one within 2x "
               "the spread + 2^-20 of the largest value of the nearest "
               "eager step ok"))
        if bad:
            chk.failures.append(f"{group} ({len(bad)})")
    chk.done(tag)


TRACED_EAGER = 4   # eager steps in graph_times' traced chunk: the profiler
                   # took ~25 s to gather a chunk of 16 eager steps


def graph_times(tr, path, bootstrap, reps=3, n=GRAPH_STEPS):
    """Graph steps against eager steps: host ms/step (median of `reps`
    chunks of `n`, each ended by a synchronize), and from one traced chunk
    of each (of TRACED_EAGER eager steps, of `n` replays) the device's
    busy ms/step split as the bench's profile splits it, its launches a
    step, the graph launches a step and the idle share against the host
    time."""
    from normal_clustering_nerf_torch.bench import split_device_time

    def eager(k=n):
        for _ in range(k):
            tr.train_step_core(bootstrap)

    def graph(k=n):
        tr.train_chunk(k, bootstrap)
    out = {"path": path, "march": "bootstrap" if bootstrap else "after"}
    if tr.native_sampler is not None:
        out["batches_per_s"] = prefetch_rate(tr.native_sampler)
        log(f"  the native prefetcher, {tr.native_sampler.batch_size} rays "
            f"a batch: {out['batches_per_s']:.1f} batches/s")
    for name, fn, k in (("eager", eager, TRACED_EAGER), ("graph", graph, n)):
        ms = []
        for _ in range(reps):
            sync(tr.device)
            t = time.perf_counter()
            fn()
            sync(tr.device)
            ms.append((time.perf_counter() - t) * 1e3 / n)
        host = sorted(ms)[reps // 2]
        r = {"host_ms": host}
        p, dev = traced(lambda: fn(k))
        if dev:
            split, launches = split_device_time(dev, k)
            busy = sum(split.values())
            r.update(busy_ms=busy, idle=1 - busy / host,
                     launches=launches, split=split,
                     graph_launches=sum(e.count for e in p.key_averages()
                                        if e.key == "cudaGraphLaunch") / k)
        out[name] = r
        log(f"  {name} steps, {path} {out['march']}: host {host:.3f} ms/step"
            + (f", device busy {r['busy_ms']:.3f} ms/step ("
               + ", ".join(f"{k} {v:.3f}" for k, v in r["split"].items())
               + f"), {r['launches']:.0f} device launches/step, "
               f"{r['graph_launches']:.2f} graph launches/step, idle "
               f"{r['idle']:.3f}" if dev else
               "; the profiler recorded no device time: not measured"))
    return out


ADAMW_TRACED = 8   # updates in each of adamw_launches' traces


def adamw_launches(tr):
    """Device launches (torch.profiler) of one optimizer update of `tr`'s
    parameters on its last step's gradients, through K9 and through its
    plain version (on clones: the trainer's state stays): a trace of
    ADAMW_TRACED updates each, taken again up to twice where it came back
    without device events, then None."""
    from normal_clustering_nerf_torch.ops import adamw
    out = []
    for plain in (False, True):
        opt = adamw_opt(tr, 0, beside=False)
        lr, bc1, bc2 = torch.tensor(opt.schedule(opt.state["count"]),
                                    device=tr.device)
        grads = dict(tr.last_grads)
        fn = ((lambda: adamw.clipped_adamw_plain(
            opt.slots(grads, lr), bc1, bc2, opt.count_t, opt.hyper))
            if plain else (lambda: opt.update(grads, lr, bc1, bc2)))
        fn()   # warm: the first K9 call may allocate its work buffer
        for _ in range(3):
            _, dev = traced(lambda: [fn() for _ in range(ADAMW_TRACED)])
            if dev:
                break
        out.append(sum(e.count for e in dev) / ADAMW_TRACED if dev
                   else None)
    return tuple(out)


def time_adamw(tr, path):
    """Device ms of the optimizer's update (clip and AdamW over every
    parameter, on the last step's gradients): K9 (`AdamW.update`, two
    launches), its plain version, and torch's own (`library_adamw`: not
    K9's rounding), against the bound of 28 bytes a value (the gradient, the moments and the parameter
    read, the moments and the parameter written); the launches of one
    update each way (`adamw_launches`). The trainer's parameters move on;
    its device count is put back."""
    from normal_clustering_nerf_torch.ops import adamw
    n = sum(p.numel() for p in tr.params.values())
    lr, bc1, bc2 = (torch.full((), v, device=tr.device)
                    for v in tr.opt.schedule(tr.opt.state["count"]))
    grads = dict(tr.last_grads)
    opt = tr.opt
    ms = device_ms(lambda: opt.update(grads, lr, bc1, bc2),
                   f"{path} AdamW update")
    plain_ms = device_ms(lambda: adamw.clipped_adamw_plain(
        opt.slots(grads, lr), bc1, bc2, opt.count_t, opt.hyper),
        f"{path} AdamW update plain")
    library_ms = device_ms(
        library_adamw(opt, [g.clone() for g in grads.values()], lr),
        f"{path} AdamW update library")
    opt.count_t.fill_(opt.state["count"])
    k9, plain = adamw_launches(tr)
    out = {"adamw_ms": ms, "adamw_plain_ms": plain_ms,
           "adamw_library_ms": library_ms,
           "adamw_bound_ms": bound(28 * n, 0)[0], "values": n,
           "tensors": len(tr.params), "launches": k9, "plain_launches": plain}
    log(f"  {path}: the optimizer's update over {n} values in "
        f"{len(tr.params)} tensors: K9 {ms:.4f} ms ({k9} launches), plain "
        f"{plain_ms:.4f} ms ({plain} launches), torch's foreach norm and "
        f"fused AdamW {library_ms:.4f} ms (not K9's rounding); bound "
        f"{out['adamw_bound_ms']:.4f}, bytes")
    return out


def graph_phase(paths):
    """Phase 7: for each of GRAPH_CASES, the graph-replayed chunk against
    eager steps (`check_graph_chunk`) and their times (`graph_times`),
    with the launches of one optimizer update through K9 and through its
    plain version (`adamw_launches`) and the graph step's launches with
    the plain version's in place of K9's; then each field's optimizer
    update (`time_adamw`)."""
    rows, launches = [], {}
    for path, bootstrap in GRAPH_CASES:
        tr = paths[path]
        if path in BASELINES:
            shift_switches(tr)
        check_graph_chunk(tr, path, bootstrap)
        row = graph_times(tr, path, bootstrap)
        key = tuple((n, tuple(p.shape)) for n, p in tr.params.items())
        if key not in launches:
            launches[key] = adamw_launches(tr)
        k9, plain = launches[key]
        row["adamw_launches"] = {"k9": k9, "plain": plain}
        g = row["graph"]
        if "launches" in g and None not in (k9, plain):
            g["launches_with_plain_update"] = g["launches"] - k9 + plain
            log(f"  graph steps, {path} {row['march']}: {g['launches']:.0f} "
                f"device launches a step, {g['launches_with_plain_update']:.0f}"
                f" with the plain update ({k9} / {plain} launches an update)")
        rows.append(row)
    for path in ("triplane", "brick", "tcnn"):
        rows.append(dict(path=path, **time_adamw(paths[path], path)))
    return rows


# ------------------------------------------------------------ preset path
# the samplers of the preset path's step parity: (name, DataConfig changes)
PRESET_SAMPLERS = (
    ("all_images_triang_patch", {}),
    ("all_images_triang_patch, random poses, keep_N_tr 6",
     dict(random_tr_poses=True, keep_N_tr=6)),
    ("same_image_triang_patch",
     dict(ray_sampling_strategy="same_image_triang_patch")),
    ("all_images, pred_norm_depth off",
     dict(ray_sampling_strategy="all_images")))
EDGE_PX = 1e-4   # a cell this close to an image edge may flip its coverage


def preset_parity_config(data):
    """`small_preset_config(**data)`; without depth normals (all_images)
    also without the clustering terms, which take them."""
    cfg = small_preset_config(**data)
    if cfg.data.ray_sampling_strategy in ("all_images", "same_image"):
        cfg = cfg.replace(
            model=dataclasses.replace(cfg.model, pred_norm_depth=False),
            loss=dataclasses.replace(cfg.loss, norm_D_C_ort_dot_w=0.0,
                                     norm_D_C_centr_dot_w=0.0,
                                     norm_D_C_centr_L1_w=0.0))
    return cfg


def build_preset_trainer():
    """The preset path's trainer: the Hypersim preset's config through
    `from_args` on a Hypersim-camera room at PRESET_WH, PRESET_TRAIN train
    and PRESET_TEST held-out views (`hypersim_split`), depth and world
    normals as labels."""
    from normal_clustering_nerf_torch.training import Trainer
    t = time.perf_counter()
    train, test = hypersim_split(PRESET_WH, PRESET_TRAIN, PRESET_TEST)
    log(f"preset path: traced {PRESET_TRAIN} + {PRESET_TEST} views at "
        f"{PRESET_WH[0]} x {PRESET_WH[1]} in "
        f"{time.perf_counter() - t:.1f} s; train rays "
        f"{train.rays.nbytes / 1e6:.0f} MB, normals "
        f"{train.labels['normals'].nbytes / 1e6:.0f} MB, depth "
        f"{train.labels['depth'].nbytes / 1e6:.0f} MB; scale "
        f"{train.scale:.4f}, shift {train.proj[2].tolist()}")
    return Trainer(preset_config(), train, test, device="cuda")


def edge_margin(cells, occ_grid, scene, near):
    """For each cell index of cascade 0, the least distance over the
    cameras, in f64, of its projection's u or v to an image edge or of its
    projected depth to 0 or `near` (the comparisons of the marking)."""
    import numpy as np
    M_ndc, M_uv, _, scale = (np.asarray(p, np.float64) for p in scene.proj)
    x = occ_grid.cell_world_pos(occ_grid.cell_coords(cells.to(
        occ_grid.device)), 0).double().cpu().numpy()             # (n, 3)
    W, H = scene.img_wh
    best = np.full(len(x), np.inf)
    for pose in np.asarray(scene.poses, np.float64):
        xc = (x - pose[:, 3]) @ pose[:, :3] * (2.0 * scale)
        clip = np.concatenate([xc, np.ones((len(x), 1))], 1) @ M_ndc.T
        uvd = (clip / clip[:, 3:]) @ M_uv.T
        d = np.stack([np.abs(uvd[:, 0]), np.abs(uvd[:, 0] - W),
                      np.abs(uvd[:, 1]), np.abs(uvd[:, 1] - H),
                      np.abs(uvd[:, 2]), np.abs(uvd[:, 2] - near)], 1)
        best = np.minimum(best, d.min(1))
    return best


def check_preset_marking(tr):
    """The projective marking (`proj`) on the card against the CPU: the
    density marks equal; the coverage fractions equal but on cells within
    EDGE_PX of an image edge in some camera (the f32 products may round
    either way there), which are counted."""
    from normal_clustering_nerf_torch.models.occupancy import OccupancyGrid
    s, near = tr.scene_train, tr.cfg.model.near_dist
    t = time.perf_counter()
    tr.mark_invisible_cells()
    sync(tr.device)
    card_s = time.perf_counter() - t
    grid = OccupancyGrid(tr.cfg.model, torch.device("cpu"))
    t = time.perf_counter()
    ref = grid.mark_invisible_cells(grid.init_state(), s.poses, s.img_wh,
                                    near, proj=s.proj)
    cpu_s = time.perf_counter() - t
    chk = Check()
    dens = tr.occ.density_grid.cpu()
    log(f"phase 2, preset: projective marking of {dens.numel()} cells in "
        f"{s.n_images} cameras, card {card_s * 1e3:.1f} ms, CPU "
        f"{cpu_s * 1e3:.1f} ms; {int((dens == -1).sum())} cells invisible")
    chk.equal("density marks, card = CPU", dens, ref.density_grid)
    diff = torch.nonzero(tr.occ.count_grid.cpu()[0]
                         != ref.count_grid[0]).flatten()
    margin = edge_margin(diff, grid, s, near)
    far = int((margin > EDGE_PX).sum())
    log(f"  count_grid: {diff.numel()} of {dens.numel()} cells differ, "
        f"every one within {EDGE_PX} px of an image edge but {far} "
        f"{'ok' if not far else 'FAIL'}")
    if far:
        chk.failures.append("count_grid away from the edges")
    chk.done("preset marking")


def preset_step_parity(seed=13):
    """Training steps of the preset at the CPU tests' size
    (`preset_parity_config`, a 64 x 48 Hypersim-camera room, 8 views) for
    each of PRESET_SAMPLERS, on the card through the kernels and on the
    CPU through the plain versions, from the same state and draws: a
    bootstrap step at step 0 and an sv step at step 3000 (the clustering
    at full weight), after a full refresh."""
    import numpy as np
    from normal_clustering_nerf_torch.models.occupancy import OccupancyState
    from normal_clustering_nerf_torch.training import Trainer
    train, _ = hypersim_split((64, 48), 8, 2)
    rng = np.random.default_rng(seed)
    chk = Check()
    for name, data in PRESET_SAMPLERS:
        cfg = preset_parity_config(data)
        cpu = Trainer(cfg, train, device="cpu")
        cpu.mark_invisible_cells()
        cpu.occ_update(warmup=True)
        card = Trainer(cfg, train, device="cuda")
        for boot, step in ((True, 0), (False, 3000)):
            cpu.step = step
            card.load_state({n: p.detach().cuda()
                             for n, p in cpu.params.items()},
                            OccupancyState(*(t.cuda() for t in cpu.occ)),
                            _to_card(cpu.opt.state), step)
            batch = cpu.sampler.draw(torch.Generator().manual_seed(
                int(rng.integers(1 << 30))))
            n_rays = cpu.sampler.n_groups * cpu.sampler.group * (
                2 if cfg.data.random_tr_poses else 1)
            draws = {"batch": batch,
                     "noise": rng.random(n_rays, dtype=np.float32)}
            if cfg.model.pred_norm_depth:
                n_norm = (n_rays // 2 if cfg.data.random_tr_poses
                          else n_rays) // 64 * 49
                draws["kmeans_init"] = rng.choice(n_norm, cfg.loss.cluster_K,
                                                  replace=False)
            ref = cpu.train_step_core(bootstrap=boot, draws=draws)
            got = {k: v.cpu() for k, v in
                   card.train_step_core(bootstrap=boot, draws=draws).items()}
            log(f"preset step parity, {name}, "
                f"{'bootstrap' if boot else 'sv'} step {step}: the card "
                f"against the CPU ({n_rays} rays, rm/ray "
                f"{float(ref['rm_samples_per_ray']):.3f})")
            for k in sorted(ref):
                if k.startswith("loss_"):
                    chk.close(k, got[k], ref[k], 1e-4)
            n = card.sampler.batch_size
            for k in ("rm_samples_per_ray", "vr_samples_per_ray",
                      "trunc_ray_frac"):
                chk.equal(k, torch.round(got[k] * n), torch.round(ref[k] * n))
            for k, g in cpu.last_grads.items():
                chk.close(f"d {k}", card.last_grads[k].cpu(), g, 1e-3)
    chk.done("preset step parity")


def check_preset_kernels(tr, rec, gen):
    """K1, H1, H3 and H5/H6 at the preset's shapes on the trained
    occupancy: K1's training launcher on a patch batch (K 32, the
    auto-full interval budget) and its test round on the held-out rays
    (`check_k1`); H1 on the same rays (exact); H3's forward and backward
    and H5's forward (bit for bit in f32 and bf16 out) and H6 on that
    batch's sv-march samples through the brick field (random
    cotangents). Their calls are timed as variants of the records in
    `rec`, each with its bound at these inputs."""
    from normal_clustering_nerf_torch.models import brick_hash as bh
    from normal_clustering_nerf_torch.models.rendering import (
        field_raws, train_intervals, train_march_args)
    from normal_clustering_nerf_torch.ops import composite as cp
    from normal_clustering_nerf_torch.ops import ray_march as rm
    batch = tr.sampler.sample(gen)
    o, d = (t.contiguous() for t in tr._assemble_rays(batch))
    N = o.shape[0]
    noise = torch.rand(N, generator=gen, device=tr.device)
    k1 = check_k1(tr, tr.occ, (o, d, None, noise), held_out_rays(tr),
                  "preset, trained occupancy", need_trunc=False, step=tr.step)
    k1["march_sv_test_round"].pop("first_round")
    m, rc = tr.cfg.model, tr.cfg.render
    kw = train_march_args(m, rc, N, "sv")
    RI = rm._sv_intervals(kw["n_intervals"], m.grid_size)
    hits = train_intervals(m, rc, o, d, tr.step)
    mr = rm.march_rays_train_dense_sv(o, d, hits, tr.occ.sv_mask,
                                      tr.occ.sv_payload, noise, **kw)
    K = mr.t.shape[1]
    xyz = (o[:, None, :] + mr.t[..., None] * d[:, None, :]).reshape(N * K, 3)
    with torch.no_grad():
        sig, raws = field_raws(tr.model, xyz, d[:, None, :].expand(
            N, K, 3).reshape(N * K, 3))
    C = raws.shape[-1]
    ca = (sig.reshape(N, K).float().contiguous(),
          raws.reshape(N, K, C).float().contiguous(), mr.dt, mr.t, mr.valid,
          rc.T_threshold)
    gs = (torch.randn(N, generator=gen, device=o.device),
          torch.randn(N, generator=gen, device=o.device),
          torch.randn((N, C), generator=gen, device=o.device),
          torch.randn((N, K), generator=gen, device=o.device))
    chk = Check()
    log(f"H3 at the preset's shape: N={N} K={K} C={C}")
    got = cp.composite_kernel(*ca)
    e_fwd = check_composite_fwd(chk, ca, got, cp.composite_plain(*ca))
    e_bwd = check_composite_bwd(chk, ca, gs)
    flops = N * K * (10 + 2 * C)
    # H1 on the same rays: the bootstrap march of the preset's first steps
    ba = (o, d, train_intervals(m, rc, o, d, 0), tr.occ.density_bitfield,
          noise)
    bkw = train_march_args(m, rc, N, "bootstrap")
    bref = rm.march_rays_train_dense_plain(*ba, **bkw)
    bgot = rm.march_rays_train_bootstrap(*ba, **bkw)
    log(f"H1 at the preset's shape: N={N} K={bref.t.shape[1]} "
        f"S={bkw['march_steps']}")
    e_h1 = max(chk.equal(f, getattr(bgot, f), getattr(bref, f))
               for f in ("t", "dt", "valid", "ray_count", "rm_samples"))
    # H5 / H6 on the sv step's samples, in the preset's compute dtype
    spec, table = tr.model.spec, tr.model.hash_table.detach()
    s = m.scale
    x = ((xyz + s) / (2.0 * s)).contiguous()
    M, out_dt = x.shape[0], tr.model.compute_dtype
    g = torch.randn((M, spec.out_dim), generator=gen, device=o.device)
    log(f"H5 / H6 at the preset's shape: M={M}")
    e_h5 = check_encode_fwd(chk, "brick", table, x, spec, "preset sv step")
    e_h6 = chk.close("H6 preset sv step", bh.encode_grad_kernel(x, g, spec),
                     bh.encode_grad_plain(x, g, spec), 1e-4)
    chk.done("H1, H3, H5 and H6 at the preset's shape")
    ops = M * spec.n_levels * ENCODE_OPS
    tag = f"preset step (N {N}, K {K}, RI {RI})"
    enc = f"preset sv step (M {M})"
    # name: (where, call, error, bound at these inputs)
    variants = {
        "march_sv_train": (tag, k1["march_sv_train"]["kernel"],
                           k1["march_sv_train"]["err"],
                           k1["march_sv_train"]["bound"]),
        "march_sv_test_round": (
            "preset first test round", k1["march_sv_test_round"]["kernel"],
            k1["march_sv_test_round"]["err"],
            k1["march_sv_test_round"]["bound"]),
        "composite_fwd": (tag, lambda: cp.composite_kernel(*ca), e_fwd,
                          bound(nbytes(*ca[:5]) + nbytes(*got), flops)),
        "composite_bwd": (tag, lambda: cp.composite_grad_kernel(*ca, *gs),
                          e_bwd, bound(nbytes(*ca[:5], *gs)
                                       + nbytes(*ca[:2]),
                                       2 * flops + N * K * C * 3)),
        "march_bootstrap": (
            f"preset bootstrap step (N {N}, K {bref.t.shape[1]})",
            lambda: rm.march_rays_train_bootstrap(*ba, **bkw), e_h1,
            bootstrap_bound(ba, bkw, bref)[0]),
        "brick_fwd": (enc, lambda: bh.encode_kernel(table, x, spec, out_dt),
                      e_h5, bound(nbytes(x) + touched_encode_bytes(
                          x, spec, "brick") + M * spec.out_dim
                          * (2 if out_dt == torch.bfloat16 else 4), ops)),
        "brick_bwd": (enc, lambda: bh.encode_grad_kernel(x, g, spec), e_h6,
                      bound(nbytes(x, g, table), ops))}
    for name, (where, fn, err, b) in variants.items():
        rec[name]["err"] = max(rec[name]["err"], err)
        rec[name].setdefault("variants", {})[where] = fn
        rec[name].setdefault("variant_bounds", {})[where] = b


def preset_path(rec, launches, gen):
    """The preset path (phases 2, 3 and 5): the Hypersim preset's config
    on the 1024 x 768 Hypersim-camera room, the projective marking against
    the CPU, the four samplers' step parity, STEPS counted steps through
    `Trainer.fit` (the brick field, K 32, the auto-full sv budget; H4 never
    launches, its weight being 0), K1 and H3 at the path's shapes, and
    `validate` on the held-out views. Returns the trainer and fit's
    ms/step."""
    tr = build_preset_trainer()
    cfg = tr.cfg
    log(f"phase 2, preset: trainer built from the Hypersim preset's argv "
        f"({sum(p.numel() for p in tr.params.values())} parameters; "
        f"{cfg.model.hash_layout} field, {cfg.data.ray_sampling_strategy}, "
        f"batch {cfg.data.batch_size}, sample_budget "
        f"{cfg.render.sample_budget} (K 32), sv_intervals "
        f"{cfg.render.sv_intervals} (auto-full), random_bg "
        f"{cfg.render.random_bg})")
    check_preset_marking(tr)
    preset_step_parity()
    log(f"phase 3, preset: {STEPS} training steps through Trainer.fit")
    ms, hist = path_training(
        tr, "preset", launches, PATH_KERNELS[:3] + ("march_sv_train",)
        + FIELD_KERNELS["brick"],
        {"march_sv_train": SV_STEPS, "distortion_fwd": 0,
         "distortion_bwd": 0, "march_fine_train": 0})
    ramp = [i for i, h in enumerate(hist) if i >= 500
            and h["loss_norm_D_C_ort_dot"] != 0.0]
    log(f"  clustering terms non-zero at {len(ramp)} of the steps "
        f"500-{len(hist) - 1} (ort_dot at the last step "
        f"{hist[-1]['loss_norm_D_C_ort_dot']:.3e}); trunc_ray_frac at the "
        f"last step {hist[-1]['trunc_ray_frac']:.4f}")
    if not ramp:
        raise RuntimeError("preset path: the clustering terms stayed 0 "
                           "after step 500")
    log("phase 4, preset: K1, H1, H3 and H5/H6 at the preset's shapes")
    check_preset_kernels(tr, rec, gen)
    for name, c in validate(tr, "preset", ("march_sv_test_round",
                                           "brick_fwd", "composite_fwd"),
                            ("march_fine_test_round",)).items():
        launches[name] += c
    return tr, ms


# ---------------------------------------------------------- baselines path
# the baselines path's configurations: (name, batch_size); regnerf's batch
# is 8190 supervised rays and as many from random poses
BASELINE_RUNS = (("supervised", 8192), ("regnerf", 16384))


def baseline_step_parity(seed=17):
    """Training steps of each of BASELINES at the CPU tests' size
    (`small_baseline_config`), on the card through the kernels and on the
    CPU through the plain versions, from the same state and draws: a
    bootstrap step at step 0 (the 'depth' annealing at n_i 0.05, the
    clustering weights 0, the Manhattan term unweighted, reg_depth off)
    and an sv step at step 3000 (every weight full, past norm_can_start
    and the annealing), after a full refresh; theta_WF after each step."""
    import numpy as np
    from normal_clustering_nerf_torch.datasets.synthetic import (
        SyntheticDataset)
    from normal_clustering_nerf_torch.models.occupancy import OccupancyState
    from normal_clustering_nerf_torch.training import Trainer
    scene = SyntheticDataset(split="train", img_wh=(24, 24),
                             n_images=6).load()
    rng = np.random.default_rng(seed)
    chk = Check()
    for name in BASELINES:
        cfg = small_baseline_config(name)
        cpu = Trainer(cfg, scene, device="cpu")
        cpu.mark_invisible_cells()
        cpu.occ_update(warmup=True)
        card = Trainer(cfg, scene, device="cuda")
        n_rays = cpu.sampler.n_groups * cpu.sampler.group * (
            2 if cfg.data.random_tr_poses else 1)
        n_tri = (n_rays // 2 if cfg.data.random_tr_poses else n_rays) // 3
        for boot, step in ((True, 0), (False, 3000)):
            cpu.step = step
            card.load_state({n: p.detach().cuda()
                             for n, p in cpu.params.items()},
                            OccupancyState(*(t.cuda() for t in cpu.occ)),
                            _to_card(cpu.opt.state), step)
            draws = {"batch": cpu.sampler.draw(torch.Generator().manual_seed(
                         int(rng.integers(1 << 30)))),
                     "noise": rng.random(n_rays, dtype=np.float32),
                     "bg": rng.random(3, dtype=np.float32),
                     "kmeans_init": rng.choice(n_tri, cfg.loss.cluster_K,
                                               replace=False)}
            ref = cpu.train_step_core(bootstrap=boot, draws=draws)
            got = {k: v.cpu() for k, v in
                   card.train_step_core(bootstrap=boot, draws=draws).items()}
            log(f"baseline step parity, {name}, "
                f"{'bootstrap' if boot else 'sv'} step {step}: the card "
                f"against the CPU ({n_rays} rays, rm/ray "
                f"{float(ref['rm_samples_per_ray']):.3f}; losses "
                + ", ".join(f"{k[5:]} {float(v):.4g}" for k, v in ref.items()
                            if k.startswith("loss_")) + ")")
            for k in sorted(ref):
                if k.startswith("loss_"):
                    chk.close(k, got[k], ref[k], 1e-4)
            n = card.sampler.batch_size
            for k in ("rm_samples_per_ray", "vr_samples_per_ray",
                      "trunc_ray_frac"):
                chk.equal(k, torch.round(got[k] * n), torch.round(ref[k] * n))
            for k, g in cpu.last_grads.items():
                chk.close(f"d {k}", card.last_grads[k].cpu(), g, 1e-3)
            if "theta_WF" in cpu.params:
                chk.close("theta_WF after the step",
                          card.params["theta_WF"].detach().cpu(),
                          cpu.params["theta_WF"].detach(), 1e-3)
    chk.done("baseline step parity")


def check_ts_distortion(tr, rec, gen):
    """H4 at the inputs `distortion_ts_bug_compat` gives it: a batch's
    sv-march samples with their distances ts (up to ~sqrt(3)) as the
    weights, forward and backward against the plain versions and bit for
    bit the serial order; timed as a variant of H4's forward."""
    from normal_clustering_nerf_torch.models.rendering import (
        train_intervals, train_march_args)
    from normal_clustering_nerf_torch.ops import distortion as ds
    from normal_clustering_nerf_torch.ops import ray_march as rm
    batch = tr.sampler.sample(gen)
    o, d = (t.contiguous() for t in tr._assemble_rays(batch))
    N = o.shape[0]
    depth = tr.scene["label_depth"][batch["img_idxs"], batch["pix_idxs"]]
    m, rc = tr.cfg.model, tr.cfg.render
    mr = rm.march_rays_train_dense_sv(
        o, d, train_intervals(m, rc, o, d, tr.step, depth_gt=depth),
        tr.occ.sv_mask, tr.occ.sv_payload,
        torch.rand(N, generator=gen, device=o.device),
        **train_march_args(m, rc, N, "sv"))
    K = mr.t.shape[1]
    da = (mr.t, mr.dt, mr.t, mr.valid)
    g = torch.randn(N, generator=gen, device=o.device)
    chk = Check()
    log(f"H4 at ts inputs (distortion_ts_bug_compat): N={N} K={K}, ts up "
        f"to {float(mr.t.max()):.4f}")
    # bit for bit the serial order, as on every input. Against the plain
    # version (torch.cumsum) the forward is held to 1e-5 of the products
    # it subtracts, 2 (A_s W_{s-1} + W_s A_{s-1}) summed over a ray's
    # samples (W, A the running sums of w and w t): with weights up to
    # sqrt(3) in place of weights summing to 1, the per-sample term
    # 2 w_s (t_s W_{s-1} - A_{s-1}) cancels products of size ~W^2 t, whose
    # f32 rounding is not 1e-5 of the largest loss
    loss = ds.distortion_kernel(*da)
    w = torch.where(mr.valid, mr.t, torch.zeros_like(mr.t))
    W, A = torch.cumsum(w, 1), torch.cumsum(w * mr.t, 1)
    cancelled = (2.0 * (A * (W - w) + W * (A - w * mr.t))).sum(1)
    e_fwd = max(chk.within("loss", loss, ds.distortion_plain(*da),
                           1e-5 * cancelled),
                chk.equal("loss = serial order", loss,
                          distortion_serial(*da)))
    d_ws = ds.distortion_grad_kernel(g, *da)
    e_bwd = max(chk.close("d_ws", d_ws, ds.distortion_grad_plain(g, *da),
                          1e-4),
                chk.equal("d_ws = serial order", d_ws,
                          distortion_serial(*da, g)))
    chk.done("H4 at ts inputs")
    r = rec["distortion_fwd"]
    r["err"] = max(r["err"], e_fwd)
    rec["distortion_bwd"]["err"] = max(rec["distortion_bwd"]["err"], e_bwd)
    where = f"ts as weights (N {N}, K {K})"
    r.setdefault("variants", {})[where] = lambda: ds.distortion_kernel(*da)
    r.setdefault("variant_bounds", {})[where] = bound(
        nbytes(*da) + 4 * N, N * K * 12)


def baselines_path(rec, launches, gen):
    """The baselines path: `baseline_step_parity`, then each of
    BASELINE_RUNS at the bench configuration (`baseline_config` on
    `bench_config`): STEPS counted steps through `Trainer.fit` with their
    loss checks (supervised: H4's backward never launches, the
    distortion fed ts being gradient-free; theta_WF finite and moved from
    0; H4 at ts inputs; `validate`, no gate. regnerf: reg_depth non-zero
    after norm_can_start). Returns {name: trainer} and {name: fit's
    ms/step}."""
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    baseline_step_parity()
    trainers, fit_ms = {}, {}
    for name, batch in BASELINE_RUNS:
        tr = build_trainer(baseline_config(name, bench_config(batch=batch)),
                           device="cuda")
        tr.mark_invisible_cells()
        lc = tr.cfg.loss
        log(f"phase 3, {name}: {STEPS} training steps through Trainer.fit "
            f"({sum(p.numel() for p in tr.params.values())} parameters, "
            f"batch {batch}, labels on the card {list(tr.labels)}; "
            f"loss {BASELINES[name]['loss']})")
        need = (("march_bootstrap", "composite_fwd", "composite_bwd",
                 "distortion_fwd", "march_sv_train")
                + FIELD_KERNELS["triplane"])
        exact = {"march_sv_train": SV_STEPS, "march_fine_train": 0}
        if lc.distortion_ts_bug_compat:
            exact["distortion_bwd"] = 0
        else:
            need += ("distortion_bwd",)
        fit_ms[name], hist = path_training(
            tr, name, launches, need, exact,
            untrained=(("loss_distortion",) if lc.distortion_ts_bug_compat
                       else ()))
        # reg_depth and the Manhattan term must have come on; the
        # snapping is logged (it is 0 while a cluster is empty, which
        # discard_far_members makes likelier)
        for k in ("loss_reg_depth", "loss_norm_WF", "loss_norm_D_C_can_dot"):
            if k not in hist[0]:
                continue
            on = [i for i, h in enumerate(hist) if h[k] != 0.0]
            log(f"  {k[5:]}: non-zero at {len(on)} of {len(hist)} steps "
                f"(first {on[0] if on else None}), last "
                f"{hist[-1][k]:.4e}")
            if not on and k != "loss_norm_D_C_can_dot":
                raise RuntimeError(f"{name} path: {k} stayed 0")
        if "theta_WF" in tr.params:
            theta = float(tr.params["theta_WF"].detach())
            log(f"  theta_WF after {STEPS} steps: {theta:.6f}")
            if not math.isfinite(theta) or theta == 0.0:
                raise RuntimeError(f"{name} path: theta_WF {theta} is not "
                                   "finite or has not moved from 0")
        if lc.distortion_ts_bug_compat:
            check_ts_distortion(tr, rec, gen)
            for k, c in validate(tr, name, ("march_sv_test_round",
                                            "triplane_fwd", "composite_fwd"),
                                 ("march_fine_test_round",),
                                 rotation=False).items():
                launches[k] += c
        trainers[name] = tr
    return trainers, fit_ms


def shift_switches(tr):
    """Move the step switches of the trainer's config into its next graph
    chunk, whose first step is returned: GRAPH_WARMUP eager steps and a
    capture (the new config makes a new step table) come first; then
    norm_can_start is 4 steps into the chunk (the clustering and snapping
    ramp over 4 steps from there; reg_depth and the Manhattan term's
    weighting from the step after it) and the interval annealing ends 8
    steps in."""
    from normal_clustering_nerf_torch.training.trainer import GRAPH_WARMUP
    start = tr.step + GRAPH_WARMUP + 1
    cfg = tr.cfg
    tr.cfg = cfg.replace(
        loss=dataclasses.replace(cfg.loss, norm_can_start=start + 4,
                                 norm_can_grow=4.0),
        render=dataclasses.replace(cfg.render, anneal_steps=start + 8))
    tr.train_chunk(GRAPH_WARMUP + 1, False)
    if tr.step != start:
        raise RuntimeError(f"shift_switches: at step {tr.step}, not {start}")
    log(f"graph phase: norm_can_start {start + 4}, anneal_steps "
        f"{start + 8}, the chunk from step {start}")


# ---------------------------------------------------------------- CLI path
# the CLI path's argv: the Hypersim preset on the synthetic room (12 train
# and 12 held-out views at 64 x 64, the CLI's synthetic branch) for one
# epoch, 1000 steps (past the bootstrap at 512), with every export and
# the checkpoint
CLI_ARGV = tuple("--dataset_name=synthetic" if a.startswith("--dataset_name=")
                 else a for a in HYPERSIM_ARGV) + ("--num_epochs=1",)
CLI_EXPORTS = ("--save_test_vis", "--save_test_preds", "--save_train_preds",
               "--save_checkpoint")
CLI_KERNELS = ("march_bootstrap", "march_sv_train", "march_sv_test_round",
               "brick_fwd", "brick_bwd", "composite_fwd", "composite_bwd")
RESUME_AT, RESUME_STEPS = 608, 32   # the resume check's checkpoint, steps


def read_png(path):
    """An 8-bit RGB PNG whose rows all use filter 0 (what
    `training/visualize.save_vis_png` writes) -> (H, W, 3) uint8, read
    with zlib; anything else raises."""
    import struct
    import zlib
    import numpy as np
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if zlib.crc32(tag + body) != struct.unpack(
                ">I", data[pos + 8 + n:pos + 12 + n])[0]:
            raise ValueError(f"{path}: bad CRC in {tag}")
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype, _, _, interlace = ihdr
    if (depth, ctype, interlace) != (8, 2, 0):
        raise ValueError(f"{path}: not 8-bit RGB without interlace")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    if raw[:, 0].any():
        raise ValueError(f"{path}: a row filter other than 0")
    return raw[:, 1:].reshape(h, w, 3)


def dir_bytes(path):
    import os
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(path) for f in fs)


def check_cli_artifacts(run, metrics):
    """(c): results.csv with metric/ and param/ columns; a pred and a gt
    PNG for each held-out view, decoding to the panels of the returned
    predictions and of the view's ground truth; the test and train
    archives with their markers and member names; the checkpoint."""
    import csv
    import os
    import tarfile
    import numpy as np
    from normal_clustering_nerf_torch.training.trainer import validation_gt
    from normal_clustering_nerf_torch.training.visualize import (
        pack_vis_panel)
    tr, d = run["trainer"], run["log_dir"]
    with open(os.path.join(d, "results.csv"), newline="") as f:
        header, row = list(csv.reader(f))
    if ("metric/psnr" not in header or not any(
            c.startswith("param/") for c in header)
            or float(row[header.index("metric/psnr")]) != metrics["psnr"]):
        raise RuntimeError(f"CLI path: results.csv header {header[:8]} ...")
    scene, ds = tr.scene_test, tr.cfg.eval.downsample_vis
    for i, img_id in enumerate(scene.img_ids):
        for tag, want in (("pred", tr._last_val_preds[i]),
                          ("gt", validation_gt(scene, i))):
            got = read_png(os.path.join(d, "results", f"{img_id}_{tag}.png"))
            want = pack_vis_panel(want, n_classes=max(scene.n_classes, 3),
                                  downsample=ds)
            if not np.array_equal(got, want):
                raise RuntimeError(f"CLI path: {img_id}_{tag}.png is not "
                                   "the panel of the run's arrays")
    names = {"sem": "semantics", "norm": "normals"}
    m = tr.cfg.model
    heads = ("rgb", "depth") + ("norm_nn",) * m.pred_norm_nn + (
        "sem",) * m.pred_sem
    for split, tag, keys, ids in (
            ("test", "pred", tr._last_val_preds[0], scene.img_ids),
            ("train", "pred", heads, tr.scene_train.img_ids),
            ("train", "gt", ("rgb",) + tuple(tr.scene_train.labels),
             tr.scene_train.img_ids)):
        path = os.path.join(d, "preds", f"{split}_{tag}.tar.gz")
        with tarfile.open(path) as tar:
            got = sorted(tar.getnames())
        want = sorted(f"{tag}.{split}.{names.get(k, k)}.scene.{i}.npy"
                      for k in keys for i in ids)
        if got != want or not os.path.isfile(os.path.join(
                d, "preds", f"{split}_{tag}.done")):
            raise RuntimeError(f"CLI path: {path} holds {got[:4]} ..., "
                               f"expected {want[:4]} ...")
    ckpt = os.path.join(d, "ckpt")
    if sorted(os.listdir(ckpt)) != ["layout_version.json", "state.pt"]:
        raise RuntimeError(f"CLI path: checkpoint {os.listdir(ckpt)}")
    log(f"  artifacts: results.csv ({len(header)} columns), "
        f"{2 * scene.n_images} PNGs equal to the run's panels, "
        f"test_pred / train_pred / train_gt archives with their members "
        f"and markers, checkpoint {dir_bytes(ckpt)} bytes")
    return dir_bytes(ckpt)


def fit_step(tr, graph):
    """One step of `fit` from the trainer's state, with the refresh due
    at it: `fit(1)` (a replay of the trainer's captured graph, or before
    the capture one of its warm-up steps) or eager (`occ_update`,
    `train_step_core`). Returns what `one_step` returns, the metrics as
    f64 0-dim tensors (fit's history holds them as f32 values)."""
    if graph:
        m = {k: torch.tensor(v, dtype=torch.float64, device=tr.device)
             for k, v in tr.fit(1)[0].items()}
    else:
        o = tr.cfg.optim
        if tr.step % o.update_interval == 0:
            tr.occ_update(warmup=tr.step < o.warmup_steps)
        m = {k: v.detach().double() for k, v in tr.train_step_core(
            tr.step < tr.cfg.render.bootstrap_steps).items()}
    b = tr.last_batch
    out = (torch.cat([b["img_idxs"], b["pix_idxs"]]).clone(), m,
           {k: p.detach().clone() for k, p in tr.params.items()})
    sync(tr.device)
    return out


def check_restored(tr, ckpt_dir):
    """Every tensor of the trainer's training state (its own, which its
    graphs hold), its step, optimizer count and generator state, equal to
    the checkpoint's, bit for bit."""
    import os
    from normal_clustering_nerf_torch.training.checkpoints import (
        trainer_state)
    ck = torch.load(os.path.join(ckpt_dir, "state.pt"), map_location="cpu",
                    weights_only=True)
    have = trainer_state(tr, dict)
    bad = [f"{g}/{n}" for g in ("params", "occ")
           for n, t in have[g].items() if not torch.equal(t.cpu(), ck[g][n])]
    bad += [f"opt/{g}/{n}" for g in ("mu", "nu")
            for n, t in have["opt"][g].items()
            if not torch.equal(t.cpu(), ck["opt"][g][n])]
    bad += [k for k, a, b in (("step", have["step"], ck["step"]),
                              ("opt/count", have["opt"]["count"],
                               ck["opt"]["count"]),
                              ("count_t", int(tr.opt.count_t), ck["opt"][
                                  "count"]),
                              ("step_t", int(tr._step_t), ck["step"]))
            if a != b]
    if not torch.equal(have["generator"], ck["generator"]):
        bad.append("generator")
    return bad


def check_resume(argv, ckpt_dir):
    """(e): a trainer at the CLI path's preset configuration fits
    RESUME_AT steps (its graphs captured), saves a checkpoint and fits
    RESUME_STEPS more (the uninterrupted run). The checkpoint is restored
    into that trainer, graphs and all, and into a fresh trainer; in each,
    the training state equals the checkpoint's bit for bit, and each of
    the RESUME_STEPS steps it then takes through `fit` is held against
    EAGER_STEPS eager steps from the state it started from (phase 7's
    rule, `hold_steps`), the first also the uninterrupted run's first
    step, which started from the same state. Step by step, because whole
    runs part (`check_graph_chunk`): some 30 steps from the checkpoint,
    two runs, eager or graph, differ in a loss's third digit. A
    restore that left a graph reading stale storages, or missed the
    generator, the moments or the occupancy, fails the first step."""
    from normal_clustering_nerf_torch.config import TrainConfig
    from normal_clustering_nerf_torch.train_nerf import build_datasets
    from normal_clustering_nerf_torch.training import Trainer
    from normal_clustering_nerf_torch.training.checkpoints import (
        restore_checkpoint, save_checkpoint)
    cfg = TrainConfig.from_args(list(argv))
    train_ds, test_ds = build_datasets(cfg)

    def build():
        return Trainer(cfg, train_ds.load(), test_ds.load(), device="cuda")
    tr = build()
    tr.mark_invisible_cells()
    tr.fit(RESUME_AT)
    captured = [c["kind"] for c in tr.captures]
    t = time.perf_counter()
    save_checkpoint(ckpt_dir, tr)
    save_s = time.perf_counter() - t
    first = fit_step(tr, True)
    ref = [first[1]["loss_total"].item()] + [
        h["loss_total"] for h in tr.fit(RESUME_STEPS - 1)]
    n_rays, restore_s = tr.sampler.batch_size, []
    for fresh, name in ((False, "the same trainer (graphs captured)"),
                        (True, "a fresh trainer")):
        if fresh:
            del tr
            tr = build()
        sync(tr.device)
        t = time.perf_counter()
        restore_checkpoint(ckpt_dir, tr)
        sync(tr.device)
        restore_s.append(time.perf_counter() - t)
        bad = check_restored(tr, ckpt_dir)
        if bad:
            raise RuntimeError(f"resume into {name}: the restored state "
                               f"differs from the checkpoint in {bad[:8]}")
        before = len(tr.captures)
        graph, eager = [], []
        for _ in range(RESUME_STEPS):
            st = snapshot(tr)
            graph.append(fit_step(tr, True))
            end = snapshot(tr)
            runs = []
            for _ in range(EAGER_STEPS):
                restore(tr, st)
                runs.append(fit_step(tr, False))
            eager.append(runs)
            restore(tr, end)
        kinds = [c["kind"] for c in tr.captures[before:]]
        if (not kinds or set(kinds) - set(captured)) if fresh else kinds:
            raise RuntimeError(f"resume into {name}: captures {kinds} after "
                               f"the restore (the run's: {captured})")
        tag = (f"resume into {name}, {RESUME_STEPS} steps from step "
               f"{RESUME_AT}")
        log(f"{tag}: restored state equal to the checkpoint's bit for bit; "
            f"each step against {EAGER_STEPS} eager steps from its state")
        hold_steps(tag, graph, eager, n_rays, what="resumed")
        log(f"  the uninterrupted run's first step against the eager steps "
            f"from the state restored into {name}")
        hold_steps(f"{tag}, the uninterrupted run's first step", [first],
                   eager[:1], n_rays, what="uninterrupted")
        part = max(abs(g[1]["loss_total"].item() - r)
                   for g, r in zip(graph, ref))
        log(f"  over the {RESUME_STEPS} steps its loss_total parts from the "
            f"uninterrupted run's by up to {part:.3e} (the fp32 atomics' "
            f"divergence; not a gate)")
    log(f"  resume ok; checkpoint save {save_s:.3f} s, restore "
        f"{restore_s[0]:.3f} s, {dir_bytes(ckpt_dir)} bytes")
    return save_s, restore_s[0]


def cli_path(launches, smi):
    """The CLI path: (a) `train_nerf.main` at CLI_ARGV with every export,
    counted; (b) the launches of H1, K1 (both launchers), H5/H6 and H3,
    and none of H4; (c) the artifacts (`check_cli_artifacts`); (d) a
    second `main` from the checkpoint with `--val_only`, its metrics
    equal to the first's within the spread of two `validate` calls on
    its trainer; (e) `check_resume`; (f) the run's wall time by part and
    the checkpoint's size, printed as a JSON line beside the card."""
    import os
    import shutil
    from pathlib import Path
    from normal_clustering_nerf_torch import train_nerf
    root = Path(__file__).resolve().parent / "build" / "cli_smoke"
    shutil.rmtree(root, ignore_errors=True)
    # the CLI logs to W&B under --no_debug where wandb imports; the smoke
    # starts no W&B service process
    os.environ["WANDB_MODE"] = "disabled"
    base = list(CLI_ARGV) + [f"--log_root_dir={root}"]
    log(f"CLI path: train_nerf.main({base + ['--exp_name=cli'] + list(CLI_EXPORTS)})")
    run = {}
    metrics, counts, wall = counted(lambda: train_nerf.main(
        base + ["--exp_name=cli"] + list(CLI_EXPORTS), run=run))
    tr = run["trainer"]
    log(f"  launches in the CLI run ({tr.step} steps, validate, "
        f"{tr.scene_train.n_images} training views rendered): {counts}")
    missing = [k for k in CLI_KERNELS if not counts[k]]
    sv = tr.step - tr.cfg.render.bootstrap_steps
    wrong = {k: (counts[k], v) for k, v in (
        ("march_bootstrap", tr.cfg.render.bootstrap_steps),
        ("march_sv_train", sv), ("distortion_fwd", 0),
        ("distortion_bwd", 0)) if counts[k] != v}
    if missing or wrong or tr.step != 1000:
        raise RuntimeError(f"CLI path: step {tr.step}, never launched "
                           f"{missing}, (count, expected) {wrong}")
    for k, c in counts.items():
        launches[k] += c
    ckpt_bytes = check_cli_artifacts(run, metrics)
    ckpt = os.path.join(run["log_dir"], "ckpt")
    run2 = {}
    metrics2 = train_nerf.main(base + ["--exp_name=cli_val",
                                       f"--ckpt_path={ckpt}", "--val_only"],
                               run=run2)
    again = run2["trainer"].validate()
    spread = max(abs(again[k] - metrics2[k]) for k in metrics2)
    diff = max(abs(metrics2[k] - metrics[k]) for k in metrics)
    log(f"  --val_only from the checkpoint: metrics differ from the run's "
        f"by {diff:.3e} at most; two validate calls by {spread:.3e}")
    if set(metrics2) != set(metrics) or diff > spread:
        raise RuntimeError(f"CLI path: --val_only metrics {metrics2} vs "
                           f"{metrics}")
    lpips_cli(base, ckpt)
    times = dict(run["times"], wall=wall, val_only_restore=run2["times"][
        "checkpoint_restore"], val_only_validate=run2["times"]["validate"])
    del run, run2, tr
    times["resume_save"], times["resume_restore"] = check_resume(
        base, root / "resume_ckpt")
    out = {"seconds": times, "checkpoint_bytes": ckpt_bytes,
           "psnr": metrics["psnr"], "val_only_max_diff": diff,
           "validate_spread": spread}
    print(f"CLI path on {smi}: " + json.dumps(out))
    shutil.rmtree(root)   # two checkpoints of ~220 MB
    return out


# ------------------------------------------------ the 40-class semantic path
SEM_STEPS = 64   # 4 chunks: 3 eager steps, a capture and replays


def relabel_semantics(scene, n_cls=SEM_CLASSES):
    """The scene with its semantics relabelled into `n_cls` classes by a
    fixed function of the pixel: 1 + (13 (class - 1) + the pixel's 8 x 8
    block) mod n_cls. semantics_WF (wall, floor, the rest) stays."""
    W, H = scene.img_wh
    pix = np.arange(W * H)
    block = (pix // W // 8) * ((W + 7) // 8) + (pix % W) // 8
    sem = scene.labels["semantics"]
    new = 1 + (13 * (sem.astype(np.int64) - 1) + block[None]) % n_cls
    return dataclasses.replace(scene, n_classes=n_cls, labels={
        **scene.labels, "semantics": new.astype(sem.dtype)})


def sem40_path(launches, smi):
    """pred_sem with SEM_CLASSES classes (C = 46 channels through H3): the
    bench configuration on the synthetic room with its semantics
    relabelled (`relabel_semantics`), SEM_STEPS steps through
    `Trainer.fit` (a CUDA graph captured and replayed; H3's forward and
    backward launched, every loss finite), then `validate` through test
    rounds at 46 channels with T_start, which must give a miou column.
    Prints the path's launches and metrics as a JSON line; returns the
    trainer and fit's ms/step."""
    from normal_clustering_nerf_torch.bench import bench_config
    from normal_clustering_nerf_torch.datasets.synthetic import (
        SyntheticDataset)
    from normal_clustering_nerf_torch.training import Trainer
    scenes = [relabel_semantics(SyntheticDataset(
        split=split, img_wh=(128, 128), n_images=n).load())
        for split, n in (("train", 48), ("test", 4))]
    tr = Trainer(bench_config(), *scenes, device="cuda")
    C = tr.model.cfg.rend_channels
    if C != WIDE_TIMED:
        raise RuntimeError(f"40-class path: {C} channels, not {WIDE_TIMED}")
    tr.mark_invisible_cells()
    log(f"phase 3, 40 classes: {SEM_STEPS} training steps through "
        f"Trainer.fit, n_sem_cls {tr.model.cfg.n_sem_cls}, C {C}")
    ms, hist = path_training(
        tr, "40 classes", launches,
        ("march_bootstrap", "composite_fwd", "composite_bwd")
        + FIELD_KERNELS["triplane"], {}, phases=(("bootstrap", SEM_STEPS),),
        fall=False)
    if tr.device.type == "cuda" and not tr.captures:
        raise RuntimeError("40-class path: no CUDA graph captured")
    out = {}
    counts = validate(tr, "40 classes", ("composite_fwd",), rotation=False,
                      metrics=("miou",), out=out)
    for k, c in counts.items():
        launches[k] += c
    print(f"40-class path on {smi}: " + json.dumps({
        "channels": C, "steps": SEM_STEPS, "fit_ms_per_step": ms[0],
        "loss_sem": [hist[0]["loss_sem"], hist[-1]["loss_sem"]],
        "validate_launches": {k: v for k, v in counts.items() if v},
        "miou": out["miou"], "psnr": out["psnr"]}))
    return tr, ms


# ------------------------------------------------------- rows of 64 samples
K64_SPR = 64     # samples a ray: a rank's rows at --num_chips 4 under the
                 # bench's budget (the global batch's, as JAX's bench.py:62)
K64_STEPS = 64   # the path's counted steps: the bootstrap march, 4 chunks


def k64_path(rec, launches, gen):
    """The bench configuration at samples_per_ray K64_SPR on one card (a
    budget of 8192 x 64, rows of 64 samples: what each rank marches at
    --num_chips 4): H3's backward on the path's own inputs (a bootstrap
    batch's march and field, `main_path_inputs`) bit for bit its serial
    order (`check_composite_bwd`), timed with its bound ("k64_*" keys of
    composite_bwd); then K64_STEPS counted steps through `Trainer.fit` (a
    CUDA graph captured and replayed), the loss falling, H3's backward
    launched once a step, each launch on rows of K64_SPR samples (the long
    kernel). Returns the trainer and fit's ms/step."""
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    from normal_clustering_nerf_torch.models.rendering import (
        train_march_args)
    from normal_clustering_nerf_torch.ops import composite as cp
    tr = build_trainer(bench_config(samples_per_ray=K64_SPR), device="cuda")
    tr.mark_invisible_cells()
    cfg = tr.cfg
    K = train_march_args(cfg.model, cfg.render, cfg.data.batch_size,
                         "bootstrap")["samples_per_ray"]
    if K != K64_SPR:
        raise RuntimeError(f"K64 path: the march's rows are {K} samples")
    inp = main_path_inputs(tr, gen)
    N, mr = inp["N"], inp["mr"]
    ca = (inp["sigmas"], inp["raws"], mr.dt, mr.t, mr.valid,
          cfg.render.T_threshold)
    C = ca[1].shape[-1]
    gs = (torch.randn(N, generator=gen, device="cuda"),
          torch.randn(N, generator=gen, device="cuda"),
          torch.randn((N, C), generator=gen, device="cuda"),
          torch.randn((N, K), generator=gen, device="cuda"))
    log(f"K64 path: H3's backward on a bootstrap batch's rows, N={N} K={K} "
        f"C={C}, {int(mr.valid.sum())} valid samples")
    chk = Check()
    err = check_composite_bwd(chk, ca, gs)
    chk.done("K64 path, H3 backward")
    rec["composite_bwd"]["err"] = max(rec["composite_bwd"]["err"], err)
    flops = N * K * (10 + 2 * C)
    rec["composite_bwd"]["k64"] = dict(
        shape=f"N {N}, K {K}, C {C}",
        kernel=(lambda: cp.composite_grad_kernel(*ca, *gs)),
        plain=(lambda: cp.composite_grad_plain(*ca, *gs)),
        bound=bound(nbytes(*ca[:5], *gs) + nbytes(ca[0], ca[1]),
                    2 * flops + N * K * C * 3))
    log(f"phase 3, K64: {K64_STEPS} training steps through Trainer.fit, "
        f"samples_per_ray {K64_SPR}")
    ms, _ = path_training(
        tr, "K64", launches,
        ("march_bootstrap", "composite_fwd", "composite_bwd")
        + FIELD_KERNELS["triplane"], {"composite_bwd": K64_STEPS},
        phases=(("bootstrap", K64_STEPS),))
    if not tr.captures:
        raise RuntimeError("K64 path: no CUDA graph captured")
    rec["composite_bwd"]["k64"]["launches"] = K64_STEPS
    return tr, ms


# ------------------------------------------------------ the cascades path
def cascade_timing(tc, gen):
    """H1, H9 and H10 at the cascades path's shapes, on its trained
    trainer: H1 on a bootstrap batch (a fresh refresh's bitfield), H9's
    fine march on that batch at the intervals after the annealing, H10's
    first window round over the held-out rays at the renderer's K. Checks
    each against its plain version (identical outputs), logs the share of
    H9's kept samples at each mip (some must lie past cascade 0), and
    returns {launcher: record} for `time_kernels`' "cascades" rows."""
    from normal_clustering_nerf_torch.models.rendering import (
        bucket_ladder, train_intervals, train_march_args)
    from normal_clustering_nerf_torch.ops import ray_march as rm
    m, rc, chk = tc.cfg.model, tc.cfg.render, Check()
    inp = main_path_inputs(tc, gen)
    a, kw = inp["march"]["args"], inp["march"]["kw"]
    N = a[0].shape[0]
    hit = a[2][:, 0] >= 0

    def march_bound(args, kw, out, t0, t2, ok, S, extra=()):
        probes = grid_probes(t0, t2, ok, kw, S)
        return bound(nbytes(*args, *out, *extra) + 4,
                     CASCADE_STEP_OPS * probes
                     + CASCADE_RAY_OPS * int(ok.sum())), probes

    def t0_of(t1, noise, kw):
        return t1 + rm.calc_dt(t1, m.exp_step_factor, kw["max_samples"],
                               m.grid_size, m.scale) * noise

    recs, err = {}, {}
    got = rm.march_rays_train_bootstrap(*a, **kw)
    ref = rm.march_rays_train_dense_plain(*a, **kw)
    err["march_bootstrap"] = max(chk.equal(f"H1 {f}", getattr(got, f),
                                           getattr(ref, f))
                                 for f in ("t", "dt", "valid", "ray_count",
                                           "rm_samples"))
    b, probes = march_bound(a, kw, (ref.t, ref.dt, ref.valid, ref.ray_count),
                            t0_of(a[2][:, 0], a[4], kw), a[2][:, 1], hit,
                            kw["march_steps"])
    log(f"cascades H1: N={N} S={kw['march_steps']} K={ref.t.shape[1]}, "
        f"{probes} steps inside the box")
    recs["march_bootstrap"] = dict(
        shape=f"N {N}, S {kw['march_steps']}, K {ref.t.shape[1]}, "
        f"{m.cascades} cascades",
        kernel=(lambda: rm.march_rays_train_bootstrap(*a, **kw)),
        plain=(lambda: rm.march_rays_train_dense_plain(*a, **kw)), bound=b)

    hits = train_intervals(m, rc, a[0], a[1], tc.step)
    fa = (a[0], a[1], hits, tc.occ.density_bitfield, a[4])
    fkw = dict(train_march_args(m, rc, N, "fine"), coarse_occ=None)
    got = rm.march_rays_train_dense(*fa, **fkw)
    ref = rm.march_rays_train_dense_plain(*fa, **fkw)
    err["march_fine_train"] = max(chk.equal(f"H9 {f}", getattr(got, f),
                                            getattr(ref, f))
                                  for f in ("t", "dt", "valid", "ray_count",
                                            "rm_samples", "trunc_rays"))
    shares = mip_shares(a[0], a[1], ref.t, ref.valid, m, m.max_samples)
    b, probes = march_bound(fa, fkw, (ref.t, ref.dt, ref.valid,
                                      ref.ray_count),
                            t0_of(hits[:, 0], a[4], fkw), hits[:, 1],
                            hits[:, 0] >= 0, fkw["march_steps"])
    log(f"cascades H9 fine on the trained occupancy: N={N} "
        f"S={fkw['march_steps']}, rm/ray {int(ref.rm_samples) / N:.2f}, "
        f"{probes} steps inside the box; kept samples by mip {shares}")
    if not sum(shares[1:]) > 0:
        raise RuntimeError(f"cascades path: no kept sample past cascade 0 "
                           f"({shares})")
    recs["march_fine_train"] = dict(
        shape=f"N {N}, S {fkw['march_steps']}, K {ref.t.shape[1]}, "
        f"{m.cascades} cascades",
        kernel=(lambda: rm.march_rays_train_dense(*fa, **fkw)),
        plain=(lambda: rm.march_rays_train_dense_plain(*fa, **fkw)), bound=b)

    ro, rd, near, far = held_out_rays(tc)
    alive = near >= 0
    Kt = next(k for b_, k in bucket_ladder(ro.shape[0],
                                           max(4, rc.test_min_k),
                                           rc.test_march_window)
              if b_ >= int(alive.sum()))
    tkw = dict(cascades=m.cascades, scale=m.scale,
               exp_step_factor=m.exp_step_factor, grid_size=m.grid_size,
               max_samples=m.max_samples, S_march=rc.test_march_window,
               n_steps=Kt)
    targs = (ro, rd, near, far, alive, tc.occ.density_bitfield)
    got = rm.march_rays_test_round_window(*targs, **tkw)
    ref = rm.march_rays_test_round_window_plain(*targs, **tkw)
    err["march_fine_test_round"] = max(
        chk.equal(f"H10 {f}", x, y)
        for f, x, y in zip(("t", "dt", "valid", "cursor"), got, ref))
    gkw = dict(tkw, max_samples=m.max_samples)
    ok = alive & (near >= 0)
    probes = grid_probes(near, torch.minimum(ref[3], far), ok, gkw,
                         rc.test_march_window)
    log(f"cascades H10 window round: N={ro.shape[0]} S_march="
        f"{rc.test_march_window} K={Kt}, {probes} steps probed")
    recs["march_fine_test_round"] = dict(
        shape=f"N {ro.shape[0]}, S_march {rc.test_march_window}, K {Kt}, "
        f"{m.cascades} cascades",
        kernel=(lambda: rm.march_rays_test_round_window(*targs, **tkw)),
        plain=(lambda: rm.march_rays_test_round_window_plain(*targs, **tkw)),
        bound=bound(nbytes(*targs, *ref), CASCADE_STEP_OPS * probes
                    + CASCADE_RAY_OPS * int(ok.sum())))
    chk.done("cascades path: H1 / H9 / H10 at its shapes")
    return recs, err, shares


def cascades_path(rec, launches, gen, smi):
    """A scene past scale 0.5: the bench configuration at CASCADES_SCALE
    (2 cascades, exp_step_factor 1/256) on the synthetic room of
    CASCADES_ROOM (48 + 4 views at 128^2), STEPS steps through
    `Trainer.fit`: H1 512 times, then the bitfield march H9 64 times (no
    sv march past one cascade: K1 never), losses finite and falling; H1,
    H9 and H10 at the path's shapes (`cascade_timing`: some kept samples
    past cascade 0); `validate` through bitfield window rounds (H10),
    psnr and norm_depth logged without a gate. Adds each launcher's
    "cascades" record to `rec`, prints a "cascades path" JSON line and
    returns the trainer and fit's ms/step."""
    from normal_clustering_nerf_torch.bench import bench_config
    from normal_clustering_nerf_torch.datasets.synthetic import (
        SyntheticDataset)
    from normal_clustering_nerf_torch.training import Trainer
    scenes = [SyntheticDataset(split=split, img_wh=(128, 128), n_images=n,
                               **CASCADES_ROOM).load()
              for split, n in (("train", 48), ("test", 4))]
    tc = Trainer(cascades_config(bench_config()), *scenes, device="cuda")
    m = tc.model.cfg
    tc.mark_invisible_cells()
    log(f"phase 3, cascades: {STEPS} training steps through Trainer.fit at "
        f"scale {m.scale}: {m.cascades} cascades, exp_step_factor "
        f"{m.exp_step_factor}, bitfield {tuple(tc.occ.density_bitfield.shape)}")
    ms, hist = path_training(
        tc, "cascades", launches,
        ("march_bootstrap", "march_fine_train", "composite_fwd",
         "composite_bwd", "distortion_fwd", "distortion_bwd")
        + FIELD_KERNELS["triplane"],
        {"march_bootstrap": BOOT_STEPS, "march_fine_train": SV_STEPS,
         "march_sv_train": 0})
    recs, err, shares = cascade_timing(tc, gen)
    out = {}
    counts = validate(tc, "cascades", ("march_fine_test_round",
                                       "triplane_fwd", "composite_fwd"),
                      ("march_sv_test_round",), rotation=False, out=out)
    for k, c in counts.items():
        launches[k] += c
    # the path's launches: fit's (checked exactly) and validate's
    path_launches = {"march_bootstrap": BOOT_STEPS,
                     "march_fine_train": SV_STEPS,
                     "march_fine_test_round": counts["march_fine_test_round"]}
    for name, r in recs.items():
        r["launches"] = path_launches[name]
        rec[name]["cascades"] = r
        rec[name]["err"] = max(rec[name]["err"], err[name])
    print(f"cascades path on {smi}: " + json.dumps({
        "scale": m.scale, "cascades": m.cascades, "steps": STEPS,
        "fit_ms_per_step": ms, "loss_total": [hist[0]["loss_total"],
                                              hist[-1]["loss_total"]],
        "kept_by_mip": shares,
        "validate_launches": {k: v for k, v in counts.items() if v},
        "psnr": out["psnr"],
        "norm_depth_ang_mean": out["norm_depth_ang_mean"]}))
    return tc, ms


def cascades_only(smi):
    """`--only cascades`: phase 2's `check_cascades` and the cascades path
    (training, `cascade_timing`, validate), then the device time of H1,
    H9 and H10 at the path's shapes beside the `Uniform` bodies' H1 and
    H9 on the bench trainer's main-path batch (fine march at its steps)."""
    from normal_clustering_nerf_torch import kernels
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    from normal_clustering_nerf_torch.models.rendering import (
        train_intervals, train_march_args)
    from normal_clustering_nerf_torch.ops import ray_march as rm
    tr = build_trainer(bench_config(), device="cuda")
    tr.mark_invisible_cells()
    gen = torch.Generator(device="cuda").manual_seed(7)
    rec = {k: {"err": e} for k, e in check_cascades(tr, gen).items()}
    launches = {k.name: 0 for k in kernels.ALL_KERNELS}
    cascades_path(rec, launches, gen, smi)
    a = main_path_inputs(tr, gen)["march"]["args"]
    N = a[0].shape[0]
    m, rc = tr.cfg.model, tr.cfg.render
    boot = train_march_args(m, rc, N, "bootstrap")
    fa = (a[0], a[1], train_intervals(m, rc, a[0], a[1], rc.anneal_steps),
          a[3], a[4])
    fine = dict(train_march_args(m, rc, N, "fine"), coarse_occ=None)
    uniform = {
        "march_bootstrap": lambda: rm.march_rays_train_bootstrap(*a, **boot),
        "march_fine_train": lambda: rm.march_rays_train_dense(*fa, **fine)}
    for name, r in rec.items():
        c = r.get("cascades")
        if c is None:
            continue
        ms = device_ms(c["kernel"], f"{name} cascades")
        log(f"  {name} on the cascades path ({c['shape']}): {ms:.4f} ms "
            f"(bound {c['bound'][0]:.6f}, {c['bound'][1]}), max error "
            f"{r['err']}")
        if name in uniform:
            log(f"  {name}, the Uniform body at the bench scale: "
                f"{device_ms(uniform[name], name):.4f} ms")


# -------------------------------------------------- the host-sampler path
def prefetch_rate(sampler, n=64):
    """Batches a second the native prefetcher delivers, over n batches
    taken back to back (its threads sample and gather them meanwhile)."""
    t = time.perf_counter()
    for _ in range(n):
        sampler.next_batch()
    return n / (time.perf_counter() - t)


def host_path(launches):
    """The triplane bench configuration with `host_sampler`: each step's
    indices come from the native prefetcher (built with g++ from the
    port's copy of raybatch.cpp) through a pinned block copied to the card
    once a chunk; STEPS steps through `Trainer.fit` (graphs captured and
    replayed; K1 SV_STEPS times), losses falling. The graph phase holds its
    replays to eager steps on the same batches. Returns the trainer and
    fit's ms/step."""
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    cfg = bench_config()
    tr = build_trainer(cfg.replace(data=dataclasses.replace(
        cfg.data, host_sampler=True)), device="cuda")
    tr.mark_invisible_cells()
    log(f"phase 3, host sampler: {STEPS} training steps through Trainer.fit,"
        f" {tr.native_sampler.batch_size} rays a batch from "
        f"{tr.cfg.data.host_sampler_threads} prefetcher threads")
    ms, _ = path_training(tr, "host sampler", launches,
                          PATH_KERNELS + FIELD_KERNELS["triplane"],
                          {"march_sv_train": SV_STEPS})
    return tr, ms


# ------------------------------------------------------------------ LPIPS
LPIPS_RTOL = 1e-4   # card against CPU: cuDNN's and the CPU's f32 sums of
                    # up to 4608 products a convolution, in other orders


def lpips_check(tr):
    """LPIPS with `random_weights`: on the card (cuDNN, TF32 off in the
    metric) against the CPU on one held-out view's render and its ground
    truth, within LPIPS_RTOL of the CPU's value; its time on the card, of
    one call (host clock, the host-to-card copies included) and of the
    network's device time (`device_ms`). Returns the times."""
    from normal_clustering_nerf_torch.metrics import lpips as lp
    scene = tr.scene_test
    W, H = scene.img_wh
    pred = np.clip(tr.render_image(scene.poses[0])["rgb"], 0, 1)
    gt = scene.rays[0, :, :3].reshape(H, W, 3)
    w = lp.random_weights(0)
    card, cpu = lp.LPIPS(w, device="cuda"), lp.LPIPS(w, device="cpu")
    a, b = card(pred, gt), cpu(pred, gt)
    err = abs(a - b)
    ok = err <= LPIPS_RTOL * abs(b) and math.isfinite(a)
    log(f"phase 5, LPIPS of held-out view 0 ({W} x {H}), random weights: "
        f"card {a:.8f}, CPU {b:.8f}, |diff| {err:.3e} (tol "
        f"{LPIPS_RTOL * abs(b):.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise RuntimeError("LPIPS: card and CPU differ")
    host = []
    for _ in range(5):
        torch.cuda.synchronize()
        t = time.perf_counter()
        card(pred, gt)
        host.append((time.perf_counter() - t) * 1e3)
    x, y = (torch.as_tensor(i, dtype=torch.float32, device=card.device)[None]
            * 2 - 1 for i in (pred, gt))
    dev_ms = device_ms(lambda: lp._lpips_pair(card.params, card.lins, x, y),
                       "LPIPS")
    out = {"image": f"{W} x {H}", "call_ms": sorted(host)[2],
           "device_ms": dev_ms, "card": a, "cpu": b}
    log(f"  LPIPS a held-out image: {out['call_ms']:.3f} ms a call (median "
        f"of 5), {dev_ms:.3f} ms on the card")
    return out


def lpips_cli(base, ckpt):
    """`--eval_lpips` through the CLI: `train_nerf.main` with --val_only
    from the CLI path's checkpoint, once with a random-weights npz in a
    temporary directory ($NCNERF_LPIPS_WEIGHTS; results.csv must hold the
    metric/lpips column) and once pointed at no file (a RuntimeWarning
    and no lpips column)."""
    import csv
    import os
    import tempfile
    import warnings
    from normal_clustering_nerf_torch import train_nerf
    from normal_clustering_nerf_torch.metrics.lpips import random_weights
    old = os.environ.get("NCNERF_LPIPS_WEIGHTS")
    try:
        with tempfile.TemporaryDirectory() as d:
            npz = os.path.join(d, "lpips_vgg.npz")
            np.savez(npz, **random_weights(0))
            for exp, weights in (("cli_lpips", npz),
                                 ("cli_no_lpips", os.path.join(d, "none"))):
                os.environ["NCNERF_LPIPS_WEIGHTS"] = weights
                run = {}
                with warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    m = train_nerf.main(base + [
                        f"--exp_name={exp}", f"--ckpt_path={ckpt}",
                        "--val_only", "--eval_lpips"], run=run)
                with open(os.path.join(run["log_dir"], "results.csv")) as f:
                    cols = next(csv.reader(f))
                warned = any("LPIPS weight" in str(c.message) for c in caught)
                has = "metric/lpips" in cols
                log(f"  --eval_lpips, weights {'given' if exp == 'cli_lpips' else 'missing'}: "
                    f"lpips {m.get('lpips')}, metric/lpips column "
                    f"{'present' if has else 'absent'}, warned {warned}")
                want = (True, False) if exp == "cli_lpips" else (False, True)
                if (has, warned) != want or ("lpips" in m) != want[0]:
                    raise RuntimeError(f"--eval_lpips ({exp}): column {has}, "
                                       f"warned {warned}")
    finally:
        if old is None:
            os.environ.pop("NCNERF_LPIPS_WEIGHTS", None)
        else:
            os.environ["NCNERF_LPIPS_WEIGHTS"] = old

# ------------------------------------------------------- distributed path
DIST_RANKS = 2        # gloo ranks sharing the one card
DIST_STEPS = 48       # their steps: refreshes (and merges) at 0, 16 and 32
NCCL_STEPS = 64       # steps of the NCCL run over every card: 4 merges
NCCL_TIMED = 64       # its timed window, and the one-card reference's
BOOT_KERNELS = ("march_bootstrap", "composite_fwd", "composite_bwd",
                "distortion_fwd", "distortion_bwd", "adamw_norm",
                "adamw_step") + FIELD_KERNELS["triplane"]


def replica_digest(tr):
    """md5 of the bytes of every parameter, moment and occupancy field."""
    import hashlib
    h = hashlib.md5()
    groups = (tr.params, tr.opt.state["mu"], tr.opt.state["nu"],
              tr.occ._asdict())
    for d in groups:
        for n in sorted(d):
            t = d[n].detach().contiguous()
            h.update(t.view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def check_replicas(tr, tag):
    """Every rank's parameters, moments and occupancy bit for bit rank
    0's (their digests gathered)."""
    from normal_clustering_nerf_torch.training.distributed import (
        gather_objects)
    digests = gather_objects(tr.axis, replica_digest(tr))
    ok = len(set(digests)) == 1
    log(f"  {tag}: the {len(digests)} replicas' parameters, moments and "
        f"occupancy {'bit-identical ok' if ok else 'DIFFER FAIL'} "
        f"({digests[0][:12]}...)")
    if not ok:
        raise RuntimeError(f"{tag}: replicas differ: {digests}")


def rank_training(tr, name, n_steps):
    """`n_steps` counted steps through `Trainer.fit` on every rank: each
    rank's counts of the bootstrap kernels > 0, K1's 0 and occ_union's one
    a refresh (each refresh's merge ORs the ranks' bitfields), the loss
    falling (the mean of the last 6 steps under the first 6's), the
    replicas identical. Returns rank 0's history and every rank's
    counts."""
    from normal_clustering_nerf_torch.training.distributed import (
        gather_objects)
    hist, counts, _ = train(tr, name, (("bootstrap", n_steps),),
                            BOOT_KERNELS, {"march_sv_train": 0,
                                           "occ_union": -(-n_steps // 16)})
    every = gather_objects(tr.axis, counts)
    missing = [(r, k) for r, c in enumerate(every) for k in BOOT_KERNELS
               if c[k] == 0]
    log(f"  {name}: launches of each rank: "
        + "; ".join(", ".join(f"{k} {c[k]}" for k in BOOT_KERNELS)
                    for c in every))
    if missing:
        raise RuntimeError(f"{name}: kernels a rank never launched: "
                           f"{missing}")
    head, tail = check_losses(hist, (("first", 0), ("last", -1)),
                              fall=False)
    if not tail < head:
        raise RuntimeError(f"{name}: the loss did not fall: {head:.6f} -> "
                           f"{tail:.6f}")
    check_replicas(tr, f"{name}, after {n_steps} steps")
    return hist, every


def averaged_update_parity(tr):
    """One step's averaged update against a one-process reference: from
    one state, every rank takes the step with its own generator (its
    half-batch, noise and k-means draws) and the all-reduce; rank 0 then,
    with no axis, takes each rank's step from the same state and
    generator state (the same draws) twice and applies AdamW to the mean
    of the two halves' gradients, in each of the four combinations. The
    averaged gradient and the parameters after are held to those
    references within twice their spread plus 2^-20 of the largest value
    (`within_spread`): the spread is that of H2's fp32 atomics, which
    make two computations of one half-batch's gradient part in their
    last bits. The trainer's state is put back."""
    from normal_clustering_nerf_torch.training.distributed import (
        gather_objects, on_rank0)
    from normal_clustering_nerf_torch.training.state import OPT_COLUMNS
    axis = tr.axis
    boot = tr.step < tr.cfg.render.bootstrap_steps
    snap = snapshot(tr)
    gens = gather_objects(axis, snap["gen"])

    def clone(d):
        return {n: t.detach().clone() for n, t in d.items()}
    tr.train_step_core(boot)
    got_grads, got_params = clone(tr.last_grads), clone(tr.params)

    def reference():
        tr.axis = None
        try:
            halves = []
            for g in gens:
                runs = []
                for _ in range(2):
                    restore(tr, snap)
                    tr.generator.set_state(g)
                    tr.train_step_core(boot)
                    runs.append(clone(tr.last_grads))
                halves.append(runs)
            refs = []
            for a in halves[0]:
                for b in halves[1]:
                    avg = {n: (a[n] + b[n]) / 2 for n in a}
                    restore(tr, snap)
                    rows = tr._table.index_select(
                        0, torch.stack([tr.opt.count_t, tr._step_t]))
                    tr.opt.update(avg, *rows[0, :OPT_COLUMNS])
                    refs.append((avg, clone(tr.params)))
        finally:
            tr.axis = axis
        chk, worst = Check(), {}
        for what, got, idx in (("gradient", got_grads, 0),
                               ("parameters after", got_params, 1)):
            bad = []
            for n in got:
                err, spread, ok = within_spread(got[n],
                                                [r[idx][n] for r in refs])
                worst[what] = max(worst.get(what, (-1.0,)), (err, spread, n))
                if not ok:
                    bad.append(f"{n}: {err:.3e} (spread {spread:.3e})")
            log(f"  averaged update, {what}: largest difference from the "
                f"one-process reference {worst[what][0]:.3e} ({worst[what][2]}"
                f"; the reference's spread there {worst[what][1]:.3e}) "
                + (f"FAIL {bad[:4]}" if bad else "within 2x the spread + "
                   "2^-20 of the largest value ok"))
            if bad:
                chk.failures.append(what)
        chk.done("distributed path, averaged update")
        return {k: v[0] for k, v in worst.items()}

    out = on_rank0(axis, reference)
    restore(tr, snap)
    return out


def gloo_rank(t0):
    """A rank of the gloo run on one card: the bench configuration at
    DIST_RANKS x 4096 rays, DIST_STEPS steps, then the averaged update's
    parity and a merge's time. Returns (on rank 0) what the phase
    reports."""
    global T0, MUTED
    T0 = t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    from normal_clustering_nerf_torch.parallel.launch import (
        initialize_multihost)
    initialize_multihost(device="cuda", backend="gloo")
    tr = build_trainer(bench_config(num_chips=DIST_RANKS), device="cuda")
    MUTED = tr.axis.rank != 0
    log(f"distributed path, gloo: {tr.axis.size} ranks on {tr.device}, "
        f"{tr.sampler.batch_size} rays a rank (eager steps)")
    tr.mark_invisible_cells()
    check_replicas(tr, "gloo, after init and marking")
    hist, every = rank_training(tr, "gloo", DIST_STEPS)
    parity = averaged_update_parity(tr)
    check_replicas(tr, "gloo, after the parity step")
    return {"losses": [hist[0]["loss_total"], hist[-1]["loss_total"]],
            "launches": every, "parity": parity, "merge_ms": merge_ms(tr)}


def merge_ms(tr, reps=5):
    """Device ms of one merge of the trainer's occupancy (the MAX of the
    grids, the ranks' bitfields gathered and ORed, the tables rebuilt):
    CUDA events on rank 0 around each, every rank's card idle before; the
    median."""
    from normal_clustering_nerf_torch.models.occupancy import OccupancyGrid
    from normal_clustering_nerf_torch.training.distributed import barrier
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        barrier(tr.axis)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        OccupancyGrid.merge_across_chips(tr.occ, tr.axis.group)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
    return sorted(ms)[reps // 2]


def allreduce_alone(tr, reps=10):
    """Device ms of the step's all-reduce alone (a buffer of the
    gradients' and the aux values' size, every rank's card idle and the
    ranks at a barrier before each; CUDA events on this rank, the
    median), and its bus rate: 2 (n - 1) / n of the bytes a card sends
    and receives in a ring, over that time."""
    from normal_clustering_nerf_torch.training.distributed import barrier
    n_values = sum(p.numel() for p in tr.params.values()) + len(
        tr._hist_keys)
    buf = torch.ones(n_values, device=tr.device)
    ms = []
    for i in range(reps + 2):
        torch.cuda.synchronize()
        barrier(tr.axis)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        torch.distributed.all_reduce(buf, group=tr.axis.group)
        b.record()
        b.synchronize()
        if i >= 2:
            ms.append(a.elapsed_time(b))
    med = sorted(ms)[reps // 2]
    k = tr.axis.size
    return {"values": n_values, "ms": med,
            "bus_gb_per_s": 2 * (k - 1) / k * 4 * n_values / med / 1e6}


def one_card_rays_per_s(warm, timed):
    """A one-card trainer at the same global batch on this rank's card:
    `warm` steps, then `timed` timed (the distributed window's phase)."""
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    tr = build_trainer(bench_config(), device="cuda")
    tr.mark_invisible_cells()
    tr.fit(warm)
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.fit(timed)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
    log(f"  one-card reference, steps {warm}-{warm + timed}: "
        f"{tr.cfg.data.batch_size * timed / dt:,.0f} rays/s "
        f"({dt * 1e3 / timed:.3f} ms/step)")
    return tr.cfg.data.batch_size * timed / dt


def nccl_rank(t0):
    """A rank of the NCCL run over every card: NCCL_STEPS counted steps
    (each march's graph captured with its all-reduce), replicas
    identical, the graph chunk against eager steps, the replicas again, a
    timed window of NCCL_TIMED steps, a traced chunk (the all-reduce's
    device time), the merge's time, and on rank 0 the one-card reference
    at the same batch and steps."""
    global T0, MUTED
    T0 = t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from normal_clustering_nerf_torch.bench import (bench_config,
                                                    build_trainer,
                                                    split_device_time)
    from normal_clustering_nerf_torch.parallel.launch import (
        initialize_multihost)
    from normal_clustering_nerf_torch.training.distributed import (
        barrier, on_rank0)
    initialize_multihost(device="cuda")
    n = torch.distributed.get_world_size()
    tr = build_trainer(bench_config(num_chips=n), device="cuda")
    MUTED = tr.axis.rank != 0
    log(f"distributed path, nccl: {n} ranks, one a card, "
        f"{tr.sampler.batch_size} rays a rank")
    tr.mark_invisible_cells()
    hist, every = rank_training(tr, f"nccl x{n}", NCCL_STEPS)
    kinds = [c["kind"] for c in tr.captures]
    log(f"  graphs captured: {kinds}")
    if tr.device.type == "cuda" and "bootstrap" not in kinds:
        raise RuntimeError(f"nccl: no bootstrap graph captured: {kinds}")
    check_graph_chunk(tr, f"nccl x{n}", True)
    check_replicas(tr, f"nccl x{n}, after the graph chunk")
    warm = tr.step

    def window():
        torch.cuda.synchronize()
        barrier(tr.axis)
        t = time.perf_counter()
        tr.fit(NCCL_TIMED)
        torch.cuda.synchronize()
        barrier(tr.axis)
        return time.perf_counter() - t
    dt = window()
    batch = tr.cfg.data.batch_size
    out = {"cards": n, "backend": tr.axis.backend,
           "rays_a_rank": tr.sampler.batch_size,
           "steps": [warm, warm + NCCL_TIMED],
           "ms_per_step": dt * 1e3 / NCCL_TIMED,
           "rays_per_s": batch * NCCL_TIMED / dt}
    p, dev = traced(lambda: tr.fit(GRAPH_STEPS))
    nccl = {e.key[:90]: {"ms_per_step": e.self_device_time_total / 1e3
                         / GRAPH_STEPS, "per_step": e.count / GRAPH_STEPS}
            for e in dev if "nccl" in e.key.lower()}
    out["nccl_kernels"] = nccl   # a chunk's: its steps' SUM, its refresh's
    sums = [v for k, v in nccl.items() if "sum" in k.lower()]   # MAX
    out["allreduce_device_ms_per_step"] = (
        sum(v["ms_per_step"] for v in sums) if dev else None)
    out["allreduce_kernels_per_step"] = (
        sum(v["per_step"] for v in sums) if dev else None)
    if dev:
        split, launches = split_device_time(dev, GRAPH_STEPS)
        out["device_busy_ms_per_step"] = sum(split.values())
        out["graph_launches_per_step"] = sum(
            e.count for e in p.key_averages()
            if e.key == "cudaGraphLaunch") / GRAPH_STEPS
    out["merge_ms"] = merge_ms(tr)
    out["allreduce_alone"] = allreduce_alone(tr)
    check_replicas(tr, f"nccl x{n}, after {tr.step} steps")
    one = on_rank0(tr.axis, one_card_rays_per_s, warm, NCCL_TIMED)
    if one:
        out["one_card_rays_per_s"] = one
        out["scaling_efficiency"] = out["rays_per_s"] / (one * n)
        out["rays_per_s_per_chip"] = out["rays_per_s"] / n
    log(f"  nccl x{n}: {out['ms_per_step']:.3f} ms/step, "
        f"{out['rays_per_s']:,.0f} rays/s, all-reduce "
        + (f"{out['allreduce_device_ms_per_step']:.4f} device ms/step "
           f"({out['allreduce_kernels_per_step']:.2f} kernels/step, "
           f"{out['graph_launches_per_step']:.2f} graph launches/step)"
           if dev else "not measured (no device events)")
        + f", merge {out['merge_ms']:.3f} ms; the all-reduce alone "
        f"{out['allreduce_alone']['ms']:.4f} ms over "
        f"{out['allreduce_alone']['values']} values "
        f"({out['allreduce_alone']['bus_gb_per_s']:.1f} GB/s bus)")
    out["launches"] = every
    return out


def distributed_path(launches, smi):
    """The distributed path (ROADMAP A10): DIST_RANKS gloo ranks on the one
    card (both on card 0), and when more than one card is visible, NCCL
    over every card, each run in processes of its own started by the
    port's launcher (`parallel.launch.spawn`). Adds rank 0's launches to
    `launches`; prints the "multi-chip" line of the NCCL run."""
    from normal_clustering_nerf_torch.parallel.launch import spawn
    res = spawn(gloo_rank, DIST_RANKS, (T0,), device="cuda",
                local_ranks=[0] * DIST_RANKS)
    log(f"distributed path, gloo: loss {res['losses'][0]:.6f} -> "
        f"{res['losses'][1]:.6f}, averaged update within "
        f"{json.dumps(res['parity'])}, merge {res['merge_ms']:.4f} ms")
    for k, c in res["launches"][0].items():
        launches[k] += c
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"distributed path, nccl: not run: {cards} card visible, NCCL "
            "over several cards needs two or more")
        return None
    out = spawn(nccl_rank, cards, (T0,), device="cuda")
    for k, c in out.pop("launches")[0].items():
        launches[k] += c
    print(f"multi-chip on {smi}: " + json.dumps(out), flush=True)
    return out



def k7k8_only(smi):
    """`--only k7k8`: the triplane bench configuration trained past the
    warm-up's end (K7 and K8's launches counted), `check_kmeans`,
    `check_occupancy` and `check_refresh_graph`, and the four launchers'
    times."""
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    tr = build_trainer(bench_config(), device="cuda")
    tr.mark_invisible_cells()
    n = 320
    hist, counts, _ = counted(lambda: tr.fit(n))
    want = {"kmeans_cluster": n, "occ_merge_pack": n // 16,
            "occ_tables": n // 16, "occ_compact": (n - 256) // 16}
    got = {k: counts[k] for k in want}
    log(f"{n} steps: K7 / K8 launches {got} (expected {want}); captures "
        f"{[(c['kind'], c['step']) for c in tr.captures]}")
    if got != want:
        raise RuntimeError(f"K7 / K8 launches {got}, expected {want}")
    check_losses(hist, [("first", 0), ("last", -1)], fall=False)
    rec, gen = {}, torch.Generator(device="cuda").manual_seed(7)
    check_kmeans(tr, rec, gen)
    check_occupancy(tr, rec, gen)
    refresh = check_refresh_graph(tr, "triplane")
    time_kernels(rec)
    print(f"sampled refresh on {smi}: " + json.dumps(refresh))
    print(json.dumps({"kernels": [
        {"name": f"{LABEL[k]} {k}", "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"], "max_abs_err": r["err"]}
        for k, r in rec.items()]}))


def k9_only(smi):
    """`--only k9`: each bench field's trainer through K9_STEPS steps of
    `Trainer.fit` (K9's two launchers counted, once a step each),
    `check_adamw`, K9's launchers' times and each field's `time_adamw`."""
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    paths = {}
    for layout in ("triplane", "brick", "tcnn"):
        tr = build_trainer(bench_config(hash_layout=layout), device="cuda")
        tr.mark_invisible_cells()
        hist, counts, _ = counted(lambda: tr.fit(K9_STEPS))
        got = {k: counts[k] for k in ("adamw_norm", "adamw_step")}
        log(f"{layout}: {K9_STEPS} steps, K9's launches {got}; captures "
            f"{[(c['kind'], c['step']) for c in tr.captures]}")
        if got != {k: K9_STEPS for k in got}:
            raise RuntimeError(f"{layout}: K9's launches {got}, expected "
                               f"{K9_STEPS} each")
        check_losses(hist, [("first", 0), ("last", -1)], fall=False)
        paths[layout] = tr
    rec, gen = {}, torch.Generator(device="cuda").manual_seed(7)
    check_adamw(paths, rec, gen)
    time_kernels(rec)
    rows = [dict(path=p, **time_adamw(t, p)) for p, t in paths.items()]
    print(f"optimizer update on {smi}: " + json.dumps(rows))
    print(json.dumps({"kernels": [
        {"name": f"{LABEL[k]} {k}", "ms": r["ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
         "library_ms": r["library_ms"], "max_abs_err": r["err"]}
        for k, r in rec.items()]}))


def loss_only(smi):
    """`--only loss`: each bench field's trainer through LOSS_STEPS steps
    of `Trainer.fit` (K10's three launchers counted, once a step each),
    `check_loss_block` (every case on the triplane field, the base case
    on the others), the triplane trainer's replayed graph steps against
    eager steps, and K10's launchers' times."""
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    rec, gen = {}, torch.Generator(device="cuda").manual_seed(7)
    launches = {}
    paths = {}
    for layout in ("triplane", "brick", "tcnn"):
        tr = build_trainer(bench_config(hash_layout=layout), device="cuda")
        tr.mark_invisible_cells()
        hist, counts, _ = counted(lambda: tr.fit(LOSS_STEPS))
        got = {k: counts[k] for k in K10_LAUNCHERS + ("kmeans_cluster",)}
        log(f"{layout}: {LOSS_STEPS} steps, K10's and K7's launches {got}; "
            f"captures {[(c['kind'], c['step']) for c in tr.captures]}")
        if got != {k: LOSS_STEPS for k in got}:
            raise RuntimeError(f"{layout}: K10's launches {got}, expected "
                               f"{LOSS_STEPS} each")
        for k in K10_LAUNCHERS:
            launches[k] = launches.get(k, 0) + counts[k]
        check_losses(hist, [("first", 0), ("last", -1)], fall=False)
        check_loss_block(tr, layout, rec if layout == "triplane" else None,
                         gen, full=layout == "triplane")
        paths[layout] = tr
    check_graph_chunk(paths["triplane"], "triplane", True)
    time_kernels(rec)
    print(json.dumps({"kernels": [
        {"name": f"{LABEL[k]} {k}", "launches": launches[k], "ms": r["ms"],
         "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
         "bound_by": r["bound"][1], "library_ms": r["library_ms"],
         "max_abs_err": r["err"]}
        for k, r in rec.items()]}))


def render_config(cfg, **kw):
    return cfg.replace(render=dataclasses.replace(cfg.render, **kw))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="directory for torch.profiler traces of 4 steps "
                         "of each march")
    ap.add_argument("--only", choices=["distributed", "cascades", "k7k8",
                                       "k9", "loss"],
                    help="build the kernels and run this phase alone")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the smoke runs on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from normal_clustering_nerf_torch import kernels
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    trainer_log = logging.getLogger("normal_clustering_nerf_torch")
    trainer_log.setLevel(logging.INFO)
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter("[smoke trainer] %(message)s"))
    trainer_log.addHandler(handler)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    t = time.perf_counter()
    logs = kernels.build_all()
    log(f"phase 1: built {sorted(logs)} in {time.perf_counter() - t:.1f} s")
    for src, text in sorted(logs.items()):
        for line in text.splitlines():
            if any(k in line for k in ("entry function", "registers",
                                       "spill")):
                log(f"  {src}: {line.strip()}")
    if args.only:
        if args.only == "distributed":
            distributed_path({k.name: 0 for k in kernels.ALL_KERNELS}, smi)
        elif args.only == "k7k8":
            k7k8_only(smi)
        elif args.only == "k9":
            k9_only(smi)
        elif args.only == "loss":
            loss_only(smi)
        else:
            cascades_only(smi)
        log(f"done in {time.time() - T0:.1f} s")
        print(smi)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return

    tr = build_trainer(bench_config(), device="cuda")
    tr.mark_invisible_cells()
    log(f"phase 2, triplane: trainer built "
        f"({sum(p.numel() for p in tr.params.values())} parameters); "
        f"kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(7)
    rec, train_in = check_kernels(tr, gen)
    test_in = held_out_rays(tr)
    # at the intervals of the steps after the near-field annealing
    occ_random = random_occupancy(tr, gen)
    step = tr.cfg.render.anneal_steps
    early = check_k1(tr, occ_random, train_in, test_in,
                     "random 20% occupancy", need_trunc=True, step=step)
    adv_err = check_k1_adversarial(tr, occ_random, gen)
    for name in ("march_sv_train", "march_sv_test_round"):
        early[name]["err"] = max(early[name]["err"], adv_err)
    early.update(check_bitfield(tr, occ_random, train_in, test_in,
                                "random 20% occupancy", need_trunc=True,
                                step=step)[0])
    err = check_scale(tr, occ_random, gen)
    for name in ("march_fine_train", "march_fine_test_round"):
        early[name]["err"] = max(early[name]["err"], err)
    log(f"phase 2, cascades: H1, H9 and H10 at scene scales "
        f"{CASCADE_SCALES}")
    for name, err in check_cascades(tr, gen).items():
        r = early if name in early else rec
        r[name]["err"] = max(r[name]["err"], err)
    step_parity()
    step_parity(cascades=True)

    log(f"phase 3, triplane: {STEPS} training steps through Trainer.fit")
    launches = {k.name: 0 for k in kernels.ALL_KERNELS}
    paths = {"triplane": tr}
    shared = PATH_KERNELS + FIELD_KERNELS["triplane"]
    fit_ms = {"triplane": path_training(
        tr, "triplane", launches, shared,
        {"march_sv_train": SV_STEPS, "march_fine_train": 0,
         **K7K8_LAUNCHES})[0]}

    log("phase 4: K7 on a step's normals, K8 on the trained grid, K10 on "
        "a step's loss arguments")
    check_kmeans(tr, rec, gen)
    check_loss_block(tr, "triplane", rec, gen)
    check_occupancy(tr, rec, gen)
    log("phase 4: K1, H9-H11, the segment launchers and H3 with T_start "
        "on the trained occupancy")
    rec.update(check_k1(tr, tr.occ, train_in, test_in, "trained occupancy",
                        need_trunc=False, step=tr.step))
    bf, flat_in, flat_round = check_bitfield(
        tr, tr.occ, train_in, test_in, "trained occupancy", need_trunc=False,
        step=tr.step)
    rec.update(bf)
    rec.update(check_segments(tr, train_in, flat_in, flat_round, gen))
    for name, r in early.items():
        rec[name]["err"] = max(rec[name]["err"], r["err"])
    log(f"phase 4, many channels: H3's launchers at C = {WIDE_C}")
    check_many_channels(rec, gen, tr.cfg.render.T_threshold)
    err, rec["composite_fwd"]["variants"] = check_t_start(
        tr, rec["march_sv_test_round"].pop("first_round"))
    rec["composite_fwd"]["err"] = max(rec["composite_fwd"]["err"], err)
    for name, c in validate(tr, "triplane", ("march_sv_test_round",
                                             "triplane_fwd", "composite_fwd"),
                            ("march_fine_test_round",)).items():
        launches[name] += c
    check_step_cotangent(tr, rec)

    # the bitfield path: the same configuration without the supervoxel-run
    # march, so that the steps after the bootstrap and the held-out rounds
    # probe the bitfield (H9, H10)
    cfg = render_config(bench_config(), march_coarse=False)
    tb = build_trainer(cfg, device="cuda")
    tb.mark_invisible_cells()
    log(f"phase 3, bitfield: {STEPS} training steps through Trainer.fit, "
        f"march_coarse False")
    fit_ms["bitfield"] = path_training(
        tb, "bitfield", launches,
        tuple(k for k in shared if k != "march_sv_train")
        + ("march_fine_train",),
        {"march_fine_train": SV_STEPS, "march_sv_train": 0})[0]
    for name, c in validate(tb, "bitfield", ("march_fine_test_round",
                                             "triplane_fwd", "composite_fwd"),
                            ("march_sv_test_round",)).items():
        launches[name] += c
    paths["bitfield"] = tb

    # the flat path: the flat march layout (no bootstrap march: H9 from
    # step 0, H11, the segment launchers) and flat test rounds
    cfg = render_config(bench_config(), march_layout="flat",
                        test_layout="flat")
    tf = build_trainer(cfg, device="cuda")
    tf.mark_invisible_cells()
    log(f"phase 3, flat: {FLAT_STEPS} training steps through Trainer.fit, "
        f"march_layout and test_layout flat")
    flat_kernels = ("march_fine_train", "compact_samples",
                    "composite_seg_fwd", "composite_seg_bwd",
                    "distortion_seg_fwd", "distortion_seg_bwd")
    fit_ms["flat"] = path_training(
        tf, "flat", launches, flat_kernels + FIELD_KERNELS["triplane"],
        {"march_fine_train": FLAT_STEPS, "march_bootstrap": 0,
         "composite_fwd": 0}, phases=(("flat", FLAT_STEPS),), fall=False)[0]
    flat_graphs = [c for c in tf.captures if c["kind"] == "flat"]
    if not flat_graphs:
        raise RuntimeError(f"flat path: the step was not captured as a CUDA "
                           f"graph (captures: {tf.captures})")
    log(f"  the flat step captured as a CUDA graph at step "
        f"{flat_graphs[0]['step']} in {flat_graphs[0]['ms']:.1f} ms, its "
        f"port launches a replay: {flat_graphs[0]['launches']}")
    for name, c in validate(tf, "flat", ("march_fine_test_round",
                                         "compact_samples",
                                         "composite_seg_fwd", "triplane_fwd"),
                            ("march_sv_test_round", "composite_fwd"),
                            rotation=False).items():
        launches[name] += c
    paths["flat"] = tf

    # the brick and the tcnn field: the same phases 2, 3 and 5 at the
    # bench configuration with that hash_layout
    for layout in ("brick", "tcnn"):
        tl = build_trainer(bench_config(hash_layout=layout), device="cuda")
        tl.mark_invisible_cells()
        log(f"phase 2, {layout}: trainer built "
            f"({sum(p.numel() for p in tl.params.values())} parameters)")
        rec.update(check_encoding(tl, gen))
        step_parity(layout)
        log(f"phase 3, {layout}: {STEPS} training steps through Trainer.fit")
        fit_ms[layout] = path_training(
            tl, layout, launches, PATH_KERNELS + FIELD_KERNELS[layout],
            {"march_sv_train": SV_STEPS})[0]
        check_step_cotangent(tl, rec)
        check_loss_block(tl, layout, None, gen, full=False)
        for name, c in validate(tl, layout, ("march_sv_test_round",
                                             FIELD_KERNELS[layout][0],
                                             "composite_fwd")).items():
            launches[name] += c
        paths[layout] = tl
    paths["ext"], fit_ms["ext"] = ext_path(launches)
    paths["sem40"], fit_ms["sem40"] = sem40_path(launches, smi)
    paths["k64"], fit_ms["k64"] = k64_path(rec, launches, gen)
    paths["host"], fit_ms["host"] = host_path(launches)
    paths["cascades"], fit_ms["cascades"] = cascades_path(rec, launches, gen,
                                                          smi)
    lpips_times = lpips_check(tr)
    paths["preset"], fit_ms["preset"] = preset_path(rec, launches, gen)
    baselines, ms = baselines_path(rec, launches, gen)
    paths.update(baselines)
    fit_ms.update(ms)
    cli_path(launches, smi)
    distributed_path(launches, smi)
    log("phase 6: K9 against its plain version on the bench fields' "
        "parameters")
    check_adamw({k: paths[k] for k in ("triplane", "brick", "tcnn")}, rec,
                gen)
    missing = [k.name for k in kernels.ALL_KERNELS if k.name not in rec]
    if missing:
        raise RuntimeError(f"kernels not checked: {missing}")
    unlaunched = [k for k, c in launches.items() if not c]
    if unlaunched:
        raise RuntimeError(f"kernels no main path launched: {unlaunched}")
    for name, t in paths.items():
        log(f"graphs captured on the {name} path: "
            + json.dumps([{k: c[k] for k in ("kind", "step", "ms")}
                          for c in t.captures]))

    refresh = {name: check_refresh_graph(paths[name], name)
               for name in ("triplane", "cascades")}
    step_ms = {}
    for name, t in paths.items():
        boot_ms, sv_ms, warm_ms, sampled_ms = step_times(t)
        step_ms[name] = {True: boot_ms, False: sv_ms}
        log(f"phase 6, {name}: one step of each march {boot_ms:.2f} / "
            f"{sv_ms:.2f} ms (medians of 8; bootstrap / after it); one "
            f"refresh {warm_ms:.2f} ms (every cell), {sampled_ms:.2f} ms "
            f"(sampled); Trainer.fit "
            + " / ".join(f"{m:.2f}" for m in fit_ms[name]) + " ms/step")
    log("  device time of each kernel, of its plain version and of its "
        "PyTorch yardstick")
    time_kernels(rec)
    if args.profile:
        for name, t in paths.items():
            profile(t, name, args.profile, step_ms[name])
    log("phase 7: graph-replayed chunks against eager steps")
    graph_rows = graph_phase(paths)
    paths["host"].native_sampler.close()

    out = []
    for k in kernels.ALL_KERNELS:
        r = rec[k.name]
        o = {"name": f"{LABEL[k.name]} {k.name}", "route": "cuda",
             "source": k.path, "replaces": REPLACES[k.name],
             "launches": launches[k.name], "max_abs_err": r["err"],
             "ms": r["ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
             "library_ms": r["library_ms"]}
        o.update({key: r[key] for key in ("variants_ms", "variants_bound_ms",
                                          "fill_ms",
                                          "step_cotangent_ms",
                                          "p4_ms", "p4_library_ms",
                                          "p4_bound_ms", "p2_ms",
                                          "p2_library_ms", "p2_bound_ms",
                                          "c46_shape", "c46_ms",
                                          "c46_plain_ms", "c46_bound_ms",
                                          "cascades_shape",
                                          "cascades_launches", "cascades_ms",
                                          "cascades_plain_ms",
                                          "cascades_bound_ms", "dx_cost_ms",
                                          "k64_shape", "k64_launches",
                                          "k64_ms", "k64_plain_ms",
                                          "k64_bound_ms")
                  if key in r})
        out.append(o)
    print("kernels: " + ", ".join(f"{o['name']} {o['ms']:.4f} ms "
                                  f"(plain {o['plain_ms']:.4f}, bound "
                                  f"{o['bound_ms']:.4f})" for o in out))
    log(f"done in {time.time() - T0:.1f} s")
    print(f"graph steps on {smi}: " + json.dumps(graph_rows))
    print(f"LPIPS on {smi}: " + json.dumps(lpips_times))
    print(f"sampled refresh on {smi}: " + json.dumps(refresh))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    T0 = time.time()
    main()
