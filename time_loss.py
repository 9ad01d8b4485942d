#!/usr/bin/env python3
"""What the loss block costs the card, kernel by kernel, in the checkout
at --root: the terms of `compute_losses` that the bench configuration runs
and their backward.

Run from the repository root on a machine with one NVIDIA H100:

    python3 time_loss.py              # this checkout
    python3 time_loss.py --root DIR   # the checkout at DIR

It builds the bench trainer (triplane field) of that checkout
(`normal_clustering_nerf_torch.bench`), trains STEPS steps through
`Trainer.fit` (512 bootstrap steps and 64 after), and captures the
arguments of `compute_losses` in the next sv step. On copies of them,
with leaves for the rays' rgb, opacity, depth, the samples' weights (H4's
input) and the composited row the semantic logits are a view of (so that
nothing before the loss is traced):
- it traces (torch.profiler) REPS calls of `compute_losses` (the forward),
  then REPS calls of `torch.autograd.grad` of their totals (the backward;
  the forwards made before the trace): every device kernel by name, its
  launches and device ms a call, and their sums by group: K7
  (`kmeans_cluster`), H4 (`distortion_*`), K10 (`loss_*`), and the rest
  (torch's ops, the port's other glue);
- it traces REPS calls of the k-means init draw (`ops/kmeans.draw_init`,
  which the loss calls with the trainer's generator; the timed calls above
  take a drawn init) the same way;
- it traces one eager sv step (`train_step_core`): its busy ms and
  launches, split as the bench's profile splits them.
The semantic head's backward GEMMs, which the bench's `--min_losses`
probe also removes, are outside the loss's leaves and so outside these
traces. Prints the card's name and power limit, then one JSON line.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

STEPS = 576   # the smoke's main path: 512 bootstrap steps, 64 sv steps
REPS = 10     # calls a trace
LEAVES = ("rgb", "opacity", "ws", "depth")


def traced(fn, reps=REPS):
    """{kernel: [launches a call, device ms a call]} of `fn()` under
    torch.profiler (empty where the trace holds no device events)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return {e.key: [e.count / reps, e.self_device_time_total / 1e3 / reps]
            for e in p.key_averages() if e.device_type == DeviceType.CUDA}


def group(key):
    if "kmeans_cluster" in key:
        return "K7"
    if "distortion" in key:
        return "H4"
    if key.startswith("loss_") or "loss_rays" in key or "loss_bwd" in key \
            or "loss_clusters" in key:
        return "K10"
    return "rest"


def summary(kern):
    groups = {}
    for k, (n, ms) in kern.items():
        g = groups.setdefault(group(k), [0.0, 0.0])
        g[0] += n
        g[1] += ms
    return {"launches": sum(n for n, _ in kern.values()),
            "busy_ms": sum(ms for _, ms in kern.values()),
            "groups": groups,
            "kernels": sorted(([k, n, ms] for k, (n, ms) in kern.items()),
                              key=lambda r: -r[2])}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".",
                    help="checkout whose package is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_loss: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.abspath(args.root))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available", flush=True)
    t0 = time.perf_counter()
    import normal_clustering_nerf_torch as package
    from normal_clustering_nerf_torch.bench import (bench_config,
                                                    build_trainer,
                                                    split_device_time)
    from normal_clustering_nerf_torch.ops import kmeans
    from normal_clustering_nerf_torch.training import trainer as tm
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = build_trainer(bench_config(), device="cuda")
    tr.mark_invisible_cells()
    tr.fit(STEPS)
    out = {"package": os.path.dirname(package.__file__)}

    fn, seen = tm.compute_losses, []

    def spy(pred, target, lcfg, mcfg, **kw):
        seen.append(({k: v.detach().clone() if torch.is_tensor(v) else v
                      for k, v in pred.items()},
                     {k: v.clone() for k, v in target.items()},
                     dict(kw, sched={k: v.clone()
                                     for k, v in kw["sched"].items()})))
        return fn(pred, target, lcfg, mcfg, **kw)
    tm.compute_losses = spy
    try:
        tr.train_step_core(bootstrap=False)
    finally:
        tm.compute_losses = fn
    pred, target, kw = seen[0]
    kw.pop("stats", None)
    cfg = tr.cfg
    gen = torch.Generator(device="cuda").manual_seed(0)
    T = pred["depth"].shape[0] // 3
    init = kmeans.draw_init(torch.ones(T, dtype=torch.bool, device="cuda"),
                            cfg.loss.cluster_K, gen)
    kw.update(kmeans_init=init, generator=None)
    sem = pred["sem"]
    C = sem.shape[1]

    def leaves():
        p = dict(pred)
        xs = []
        for k in LEAVES:
            p[k] = pred[k].detach().clone().requires_grad_(True)
            xs.append(p[k])
        rend = torch.zeros((sem.shape[0], 6 + C), device="cuda")
        rend[:, 6:] = sem
        rend.requires_grad_(True)
        p["sem"] = rend[:, 6:]
        return p, xs + [rend]

    def forward(p):
        return fn(p, target, cfg.loss, tr.model.cfg, **kw)

    calls = [leaves() for _ in range(REPS)]
    fwd = traced(lambda: [forward(p) for p, _ in calls])
    totals = [(forward(p)["total"], xs) for p, xs in calls]
    bwd = traced(lambda: [torch.autograd.grad(t, xs, allow_unused=True)
                          for t, xs in totals])
    out["forward"] = summary(fwd)
    out["backward"] = summary(bwd)
    valid = torch.ones(T, dtype=torch.bool, device="cuda")
    out["draw_init"] = summary(traced(lambda: [
        kmeans.draw_init(valid, cfg.loss.cluster_K, gen)
        for _ in range(REPS)]))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train_step_core(bootstrap=False)
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    split, launches = split_device_time(ev, 1) if ev else ({}, 0)
    out["eager sv step"] = {"busy_ms": sum(split.values()), "split": split,
                            "launches": launches}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
