#!/usr/bin/env python3
"""Device time of the bootstrap march (H1), the dense compositing forward
and backward (H3, at 9 channels and at 46), the distortion loss's forward
and backward (H4), the held-out render's bitfield march (H10, both modes)
and the flat layout's compaction (H11) as the main path calls them, and of
one kernel node at its least.

Run from the repository root on a machine with one NVIDIA H100:

    python3 time_calls.py              # this checkout
    python3 time_calls.py --root DIR   # the checkout at DIR

It builds the bench trainer (triplane field) of the checkout at `--root`
(`normal_clustering_nerf_torch.bench`), takes one training step (the
first refresh of the occupancy grid) and captures the arguments of the
calls that `models/rendering.py` makes: `march_rays_train_bootstrap` and
`composite_rays` in a bootstrap step (on whose arguments it also calls
`ops.composite.composite_grad_kernel`, H3's backward, with cotangents
drawn from a seed), and the first `composite_rays` of a
render of the held-out views (the first round, with T_start); and those
of `losses.distortion_loss_dense` in a bootstrap step, on which it calls
`ops.distortion.distortion_kernel` and `distortion_grad_kernel` (the
latter with a cotangent drawn from a seed); and those of
`ops.ray_march.compact_samples` in a flat-layout render of a bootstrap
step's rays (`render_train` with march_layout "flat": the fine march at
the per-ray cap into the bench's budget) and in the first round of a
flat-layout render of the held-out views (the trainer's first
`render_test` call again with test_layout "flat": the full window of
test_n_samples steps into N x that), and in that round the full window
itself (`ops.ray_march.march_rays_test_round_dense`, H10's full-window
mode). For H10's first-K mode it builds the bitfield path's configuration
as `chip_smoke.py` builds it (the bench configuration with march_coarse
False), trains BITFIELD_STEPS steps through `Trainer.fit` and captures
the first window round (`march_rays_test_round_window`) of a render of
the held-out views. The fine march's `Uniform` body
(H9 at the bench's scale) runs on the bootstrap step's rays, their
intervals after the annealing and its bitfield, at the fine march's
arguments without the coarse mask. Then, for the general step grid
(`Cascades` bodies), it builds the bench configuration at scale 1.0 (2
cascades, exp_step_factor 1/256) on the synthetic room at twice its width
(48 + 4 views at 128^2), as `chip_smoke.py`'s cascades path does, trains
CASCADE_STEPS steps through `Trainer.fit` (the bootstrap's 512 and 64 of
the fine march), and captures H1's call in a bootstrap step, H9's in a
step after it and H10's first window round of a render of the held-out
views. Then, for H3 past 16 channels, it builds the bench configuration
on the synthetic room with its semantics relabelled into 40 classes
(`chip_smoke.relabel_semantics`: C = 3 + 3 + 40 = 46, the smoke's
40-class path), trains SEM40_STEPS steps through `Trainer.fit` (which
captures its bootstrap step as a CUDA graph) and captures
`composite_rays` in the next bootstrap step, on whose arguments it also
calls H3's backward with cotangents drawn from a seed and H3's segment
forward on its rows as segments of K slots (`composite_compact_kernel`),
and in the first round of a render of the held-out views (rows of up to
64 samples, T_start); and that trainer's graph step (host ms a step of
16 replays of its captured step, ended by a synchronize, the median of 3
chunks).
It times
each captured call (a march's with the occupied cells of its bitfield),
the march on a full bitfield, and a one-element
in-place add (the least time of one kernel node under this timing, the
floor of the tiny kernels), under `torch.no_grad()`, each the mean of 20
replays of a CUDA graph of one call (`time_encodes.device_ms`). The calls
go through the wrappers' public signatures, which every checkout of the
port shares, so two checkouts compare in one call when the script runs in
each in turns.
Prints the card's name and power limit, then one JSON line.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

from chip_smoke import relabel_semantics, render_config
from time_encodes import device_ms

CASCADE_STEPS = 576   # the cascades trainer's steps before its calls
BITFIELD_STEPS = 576  # the bitfield trainer's (the smoke's bitfield path)
SEM40_STEPS = 32      # the 40-class trainer's: a graph captured


def captured(module, name, run):
    """Run `run()` with `module.<name>` spied on; return the (args, kwargs)
    of its first call."""
    fn, seen = getattr(module, name), []

    def spy(*args, **kw):
        if not seen:
            seen.append((args, kw))
        return fn(*args, **kw)
    setattr(module, name, spy)
    try:
        run()
    finally:
        setattr(module, name, fn)
    if not seen:
        raise RuntimeError(f"no call of {name}")
    return seen[0]


def bits_set(bitfield):
    """Occupied cells of a (cells / 8,) uint8 bitfield."""
    ones = torch.tensor([bin(i).count("1") for i in range(256)],
                        device=bitfield.device)
    return int(ones[bitfield.long()].sum())


def cascade_calls(bench_config):
    """{label: (args, kwargs, fn)} of H1, H9 and H10 on the trained
    cascades trainer (scale 1.0, 2 cascades, the geometric grid)."""
    from normal_clustering_nerf_torch.datasets.synthetic import (
        SyntheticDataset)
    from normal_clustering_nerf_torch.models import rendering
    from normal_clustering_nerf_torch.training import Trainer
    cfg = bench_config()
    cfg = cfg.replace(model=dataclasses.replace(cfg.model, scale=1.0))
    scenes = [SyntheticDataset(split=split, img_wh=(128, 128), n_images=n,
                               room_half=0.8, scale=1.0).load()
              for split, n in (("train", 48), ("test", 4))]
    tc = Trainer(cfg, *scenes, device="cuda")
    tc.mark_invisible_cells()
    tc.fit(CASCADE_STEPS)
    boot = captured(rendering, "march_rays_train_bootstrap",
                    lambda: tc.train_step_core(bootstrap=True))
    fine = captured(rendering, "march_rays_train_dense",
                    lambda: tc.train_step_core(bootstrap=False))
    with torch.no_grad():
        window = captured(rendering, "march_rays_test_round_window",
                          lambda: tc.render_images(tc.scene_test.poses))
    tag = f"{tc.model.cfg.cascades} cascades"
    return {f"march_bootstrap, {tag}": boot + (
                rendering.march_rays_train_bootstrap,),
            f"march_fine_train, {tag}": fine + (
                rendering.march_rays_train_dense,),
            f"march_fine_test_round, {tag}, first window round": window + (
                rendering.march_rays_test_round_window,)}


def bitfield_calls(bench_config, build_trainer):
    """{label: (args, kwargs, fn)} of H10's first window round on the
    trained bitfield path (the bench configuration without the sv
    march)."""
    from normal_clustering_nerf_torch.models import rendering
    tb = build_trainer(render_config(bench_config(), march_coarse=False),
                       device="cuda")
    tb.mark_invisible_cells()
    tb.fit(BITFIELD_STEPS)
    with torch.no_grad():
        window = captured(rendering, "march_rays_test_round_window",
                          lambda: tb.render_images(tb.scene_test.poses))
    return {"march_fine_test_round, Uniform, first window round": window + (
        rendering.march_rays_test_round_window,)}


def sem40_calls(bench_config):
    """{label: (args, kwargs, fn)} of H3's forward and backward on a
    40-class bootstrap step's own arguments (46 channels), and the
    40-class trainer's graph step in ms."""
    from normal_clustering_nerf_torch.datasets.synthetic import (
        SyntheticDataset)
    from normal_clustering_nerf_torch.models import rendering
    from normal_clustering_nerf_torch.ops import composite
    from normal_clustering_nerf_torch.training import Trainer
    scenes = [relabel_semantics(SyntheticDataset(
        split=split, img_wh=(128, 128), n_images=n).load())
        for split, n in (("train", 48), ("test", 4))]
    tr = Trainer(bench_config(), *scenes, device="cuda")
    tr.mark_invisible_cells()
    tr.fit(SEM40_STEPS)
    comp = captured(rendering, "composite_rays",
                    lambda: tr.train_step_core(bootstrap=True))
    with torch.no_grad():
        first = captured(rendering, "composite_rays",
                         lambda: tr.render_images(tr.scene_test.poses))
    ca = tuple(t.detach().contiguous() for t in comp[0][:5]) + (comp[0][5],)
    n, k, c = ca[1].shape
    # the rows as segments of k slots: ray i's slots [i k, i k + k)
    seg = (tuple(t.reshape((n * k,) + t.shape[2:]) for t in ca[:4])
           + (torch.arange(0, n * k, k, device="cuda", dtype=torch.int32),
              torch.full((n,), k, device="cuda", dtype=torch.int32),
              ca[4].reshape(n * k), ca[5]))
    cg = torch.Generator(device="cuda").manual_seed(2)
    gs = tuple(torch.randn(shape, device="cuda", generator=cg)
               for shape in ((n,), (n,), (n, c), (n, k)))
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train_chunk(16, True)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3 / 16)
    return {f"composite_fwd, C {c}": comp + (rendering.composite_rays,),
            f"composite_bwd, C {c}": (ca + gs, {},
                                      composite.composite_grad_kernel),
            f"composite_fwd, C {c}, first test round": first + (
                rendering.composite_rays,),
            f"composite_seg_fwd, C {c}, the step's rows as segments": (
                seg, {}, composite.composite_compact_kernel),
            }, sorted(ms)[1]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose package is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_calls: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.abspath(args.root))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available", flush=True)
    t0 = time.perf_counter()
    import normal_clustering_nerf_torch as package
    from normal_clustering_nerf_torch import losses
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    from normal_clustering_nerf_torch.models import rendering
    from normal_clustering_nerf_torch.ops import (composite, distortion,
                                                  ray_march)
    from normal_clustering_nerf_torch.training import trainer
    tr = build_trainer(bench_config(), device="cuda")
    tr.mark_invisible_cells()
    tr.fit(1)
    step = lambda: tr.train_step_core(bootstrap=True)   # noqa: E731
    march = captured(rendering, "march_rays_train_bootstrap", step)
    comp = captured(rendering, "composite_rays", step)
    dist = captured(losses, "distortion_loss_dense", step)
    with torch.no_grad():
        first = captured(rendering, "composite_rays",
                         lambda: tr.render_images(tr.scene_test.poses))
        views, _ = captured(trainer, "render_test",
                            lambda: tr.render_images(tr.scene_test.poses))
        flat_test = dataclasses.replace(tr.cfg.render, test_layout="flat")
        flat_round = captured(ray_march, "compact_samples",
                              lambda: rendering.render_test(
                                  *views[:4], flat_test))
        full_window = captured(ray_march, "march_rays_test_round_dense",
                               lambda: rendering.render_test(
                                   *views[:4], flat_test))
    a, kw = march
    flat = dataclasses.replace(tr.cfg.render, march_layout="flat")
    with torch.no_grad():
        compact = captured(ray_march, "compact_samples",
                           lambda: rendering.render_train(
                               tr.model, tr.occ, a[0], a[1], flat,
                               global_step=tr.step))
    full = a[:3] + (torch.full_like(a[3], 255),) + a[4:]
    calls = {
        "march_bootstrap": (a, kw, rendering.march_rays_train_bootstrap),
        "march_bootstrap, full bitfield": (
            full, kw, rendering.march_rays_train_bootstrap),
        "composite_fwd": comp + (rendering.composite_rays,),
        "composite_fwd, first test round": first + (rendering.composite_rays,),
    }
    da = tuple(t.detach().contiguous() for t in dist[0])
    g = torch.randn(da[0].shape[0], device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(0))
    cg = torch.Generator(device="cuda").manual_seed(1)
    ca = tuple(t.detach().contiguous() for t in comp[0][:5]) + (comp[0][5],)
    n, k, c = ca[1].shape
    gs = tuple(torch.randn(shape, device="cuda", generator=cg)
               for shape in ((n,), (n,), (n, c), (n, k)))
    calls["composite_bwd"] = (ca + gs, {}, composite.composite_grad_kernel)
    calls["distortion_fwd"] = (da, {}, distortion.distortion_kernel)
    calls["distortion_bwd"] = ((g,) + da, {}, distortion.distortion_grad_kernel)
    calls["compact_samples, flat training march"] = compact + (
        ray_march.compact_samples,)
    calls["compact_samples, first flat test round"] = flat_round + (
        ray_march.compact_samples,)
    calls["march_fine_test_round, full window, first flat test round"] = (
        full_window + (ray_march.march_rays_test_round_dense,))
    m, rc = tr.cfg.model, tr.cfg.render
    fine_kw = dict(rendering.train_march_args(m, rc, a[0].shape[0], "fine"),
                   coarse_occ=None)
    fine_hits = rendering.train_intervals(m, rc, a[0], a[1], rc.anneal_steps)
    calls["march_fine_train, Uniform"] = (
        (a[0], a[1], fine_hits, a[3], a[4]), fine_kw,
        rendering.march_rays_train_dense)
    calls.update(cascade_calls(bench_config))
    calls.update(bitfield_calls(bench_config, build_trainer))
    sem40, sem40_step_ms = sem40_calls(bench_config)
    calls.update(sem40)
    one = torch.zeros(1, device="cuda")
    calls["one-element add (floor)"] = ((one, 1.0), {}, torch.Tensor.add_)
    out = {"package": os.path.dirname(package.__file__)}
    for where, (ca, ckw, fn) in calls.items():
        def call(ca=ca, ckw=ckw, fn=fn):
            with torch.no_grad():
                return fn(*ca, **ckw)
        out[where] = {"shapes": [list(t.shape) for t in ca[:2]
                                 if torch.is_tensor(t)],
                      "ms": device_ms(call)}
        if where.startswith("march"):
            out[where]["bits_set"] = bits_set(ca[5] if "test_round" in where
                                              else ca[3])
    out["40-class graph step"] = {"ms": sem40_step_ms}
    out["march_kw"] = kw
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
