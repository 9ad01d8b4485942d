#!/usr/bin/env python3
"""What a block of the sv step costs the card, kernel by kernel, in the
checkout at --root: the loss block (`--block loss`, the default) or the
field (`--block field`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 time_loss.py                         # the loss, this checkout
    python3 time_loss.py --root DIR              # the checkout at DIR
    python3 time_loss.py --block field [--root DIR] [--layouts L1,L2]

For each bench field (`--layouts`: the triplane field for the loss, all
three for the field by default) it builds the bench trainer of that
checkout (`normal_clustering_nerf_torch.bench`) and trains STEPS steps
through `Trainer.fit` (512 bootstrap steps and 64 after).

`--block loss` captures the arguments of `compute_losses` in the next sv
step. On copies of them, with leaves for the rays' rgb, opacity, depth,
the samples' weights (H4's input) and the composited row the semantic
logits are a view of (so that nothing before the loss is traced):
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
traces.

`--block field` captures the arguments of `models/rendering.py:field_raws`
in the next sv step (an eager one): the samples' positions and view
directions, and the gradients of sigmas and raws that its backward got.
On them:
- it traces REPS calls of `field_raws` (the forward, with autograd
  recording as in a step), then REPS calls of `torch.autograd.grad` of
  their outputs into the model's parameters (the backward; the forwards
  made before the trace), grouped: K6 (`mlp_*`), the encode (H2 /
  H5-H8's launchers and the scatter), GEMMs (cuBLAS / CUTLASS) and the
  glue (casts, ReLUs, trunc_exp, the normalisation, the cats,
  trunc_sigmoid);
- it traces a chunk of GRAPH_STEPS replays of the sv step's CUDA graph
  (`train_chunk`): the card's busy ms a step, split as the bench's profile
  splits it, and its launches a step.

Prints the card's name and power limit, then one JSON line.
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

STEPS = 576        # the smoke's main path: 512 bootstrap steps, 64 sv steps
REPS = 10          # calls a trace
GRAPH_STEPS = 16   # replays in the traced graph chunk
LEAVES = ("rgb", "opacity", "ws", "depth")
ENCODE = ("triplane_", "brick_", "hash_grid_", "grad_scatter")
GEMM = ("gemm", "gemv", "nvjet", "cutlass")


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


def loss_group(key):
    if "kmeans_cluster" in key:
        return "K7"
    if "distortion" in key:
        return "H4"
    if key.startswith("loss_") or "loss_rays" in key or "loss_bwd" in key \
            or "loss_clusters" in key:
        return "K10"
    return "rest"


def field_group(key):
    if "mlp_" in key:
        return "K6"
    if any(k in key for k in ENCODE):
        return "encode"
    if any(g in key.lower() for g in GEMM):
        return "gemm"
    return "glue"


def summary(kern, group):
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


def step_split(tr, run, steps):
    """`run()` (`steps` sv steps) traced: the card's busy ms a step, split
    as the bench's profile splits it, and its launches a step."""
    from normal_clustering_nerf_torch.bench import split_device_time
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    split, launches = split_device_time(ev, steps) if ev else ({}, 0)
    return {"busy_ms": sum(split.values()), "split": split,
            "launches": launches}


def time_loss(tr):
    from normal_clustering_nerf_torch.ops import kmeans
    from normal_clustering_nerf_torch.training import trainer as tm
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
    valid = torch.ones(T, dtype=torch.bool, device="cuda")
    return {"forward": summary(fwd, loss_group),
            "backward": summary(bwd, loss_group),
            "draw_init": summary(traced(lambda: [
                kmeans.draw_init(valid, cfg.loss.cluster_K, gen)
                for _ in range(REPS)]), loss_group),
            "eager sv step": step_split(
                tr, lambda: tr.train_step_core(bootstrap=False), 1)}


def field_args(tr):
    """field_raws' positions and directions in one eager sv step (the
    step is taken), copied, with the gradients of its outputs."""
    from normal_clustering_nerf_torch.models import rendering
    seen, fn = [], rendering.field_raws

    def spy(model, xyz, dirs):
        out = fn(model, xyz, dirs)
        r = {"xyz": xyz.detach().clone(), "dirs": dirs.detach().clone()}
        for key, t in zip(("g_sig", "g_raws"), out):
            t.register_hook(lambda g, key=key, r=r: r.__setitem__(
                key, g.detach().clone()))
        seen.append(r)
        return out
    rendering.field_raws = spy
    try:
        tr.train_step_core(bootstrap=False)
    finally:
        rendering.field_raws = fn
    return seen[0]


def time_field(tr):
    from normal_clustering_nerf_torch.models.rendering import field_raws
    a = field_args(tr)
    params = [p for p in tr.model.parameters() if p.requires_grad]

    def forward():
        return field_raws(tr.model, a["xyz"], a["dirs"])
    outs = [forward() for _ in range(REPS)]
    fwd = traced(lambda: [forward() for _ in range(REPS)])
    bwd = traced(lambda: [torch.autograd.grad(o, params,
                                              (a["g_sig"], a["g_raws"]),
                                              allow_unused=True)
                          for o in outs])
    tr.train_chunk(GRAPH_STEPS, False)   # captured, warm
    return {"samples": a["xyz"].shape[0],
            "forward": summary(fwd, field_group),
            "backward": summary(bwd, field_group),
            "graph sv step": step_split(
                tr, lambda: tr.train_chunk(GRAPH_STEPS, False),
                GRAPH_STEPS)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=".",
                    help="checkout whose package is timed")
    ap.add_argument("--block", choices=("loss", "field"), default="loss")
    ap.add_argument("--layouts", default=None,
                    help="bench fields, comma-separated (default: triplane "
                         "for the loss, all three for the field)")
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
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    layouts = args.layouts or ("triplane" if args.block == "loss"
                               else "triplane,brick,tcnn")
    block = time_loss if args.block == "loss" else time_field
    out = {"package": os.path.dirname(package.__file__), "block": args.block}
    for layout in layouts.split(","):
        tr = build_trainer(bench_config(hash_layout=layout), device="cuda")
        tr.mark_invisible_cells()
        tr.fit(STEPS)
        out[layout] = block(tr)
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
