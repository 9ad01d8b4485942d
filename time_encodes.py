#!/usr/bin/env python3
"""Device time of the field's forward encode, as the training step calls it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 time_encodes.py                          # this checkout
    python3 time_encodes.py --root DIR               # the checkout at DIR
    python3 time_encodes.py --layouts triplane tcnn  # which fields
    python3 time_encodes.py --ext [--root DIR]       # the position gradient

For each field it builds the bench trainer of the checkout at `--root`
(`normal_clustering_nerf_torch.bench`), captures the positions that the
model hands its encode (`model._encode(table, x, spec, compute_dtype)`)
in a bootstrap step of the untrained field after the first refresh of
the occupancy grid (the bootstrap batch: samples spread along each ray)
and in the step after `--steps` steps (an sv step's positions), draws
the occupancy refresh's shape (every cell of the grid, at random in
[0, 1)^3), and times the encode under `torch.no_grad()` on each: the
kernel and whatever the checkout's wrapper launches with it (a cast,
say), as the main path runs them. The calls go through the model's own
entry, so the script times any checkout whose model has it, and two
checkouts compare in one call when it runs in each in turns.

With `--ext` it builds instead the bench trainer with extrinsic
optimisation (`optimize_ext`, `lr_dR_norm_glob` 1e-4: the smoke's ext
path), trains `--steps` steps, and captures in the next step the
positions, the tables and the cotangent (in the compute dtype) that the
step hands the encode and its backward. On those it times the encode's
forward (`no_grad`), its forward and table gradient (x without a
gradient) and its forward, table gradient and position gradient
(`need_dx`, x with one), each one call of the model's encode followed by
`torch.autograd.grad`, whatever kernels the checkout's encode launches
for them; `dx_cost_ms` is the last less the one before. Then the ext
trainer's graph step: host ms a step of 16 replays of its captured step,
ended by a synchronize (the median of 3 chunks).

Each time is the mean of 20 replays of a CUDA graph of one call, queued
behind a sleep kernel and read by CUDA events. Prints one JSON line per
field and, first, the card's name and power limit.
"""
import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import torch

ITERS = 20


def device_ms(fn):
    """Mean device time of one call of `fn` in ms, over ITERS replays of a
    CUDA graph of it, queued behind a sleep so that the card runs them
    back to back."""
    side = torch.cuda.Stream()   # warm-up on a side stream, as a capture
    side.wait_stream(torch.cuda.current_stream())   # with autograd wants
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(10_000_000)
    start.record()
    for _ in range(ITERS):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def captured_encode(tr, step):
    """Run `step()` and return the (table, x) of the model's first encode
    call in it."""
    model, seen = tr.model, []
    encode = model._encode

    def spy(table, x, *rest):
        if not seen:
            seen.append((table, x.detach().clone()))
        return encode(table, x, *rest)
    model._encode = spy
    try:
        step()
    finally:
        model._encode = encode
    if not seen:
        raise RuntimeError("the step made no encode call")
    return seen[0]


def time_layout(layout, steps, seed):
    import normal_clustering_nerf_torch as package
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    tr = build_trainer(bench_config(hash_layout=layout), device="cuda")
    tr.mark_invisible_cells()
    model = tr.model
    tr.fit(1)   # the first refresh of the occupancy grid, and one step
    inputs = {"bootstrap batch": captured_encode(
        tr, lambda: tr.train_step_core(bootstrap=True))}
    tr.fit(steps - 2)
    inputs["sv step"] = captured_encode(
        tr, lambda: tr.train_step_core(bootstrap=False))
    gen = torch.Generator(device="cuda").manual_seed(seed)
    table = inputs["sv step"][0]
    inputs["refresh shape"] = (table, torch.rand(
        (tr.cfg.model.grid_size ** 3, 3), generator=gen, device="cuda"))
    out = {"layout": layout, "steps": steps,
           "package": os.path.dirname(package.__file__)}
    for where, (table, x) in inputs.items():
        def call(table=table, x=x):
            with torch.no_grad():
                return model._encode(table, x, model.spec,
                                     model.compute_dtype)
        out[where] = {"M": x.shape[0], "ms": device_ms(call)}
    return out


def captured_ext(tr, step):
    """Run `step()` (an ext training step) and return the tables, the
    positions and the cotangent of the model's first encode call in it
    whose positions carry a gradient."""
    model, seen = tr.model, {}
    encode = model._encode

    def spy(table, x, *rest, **kw):
        out = encode(table, x, *rest, **kw)
        if "x" not in seen and x.requires_grad:
            seen.update(table=table, x=x.detach().clone())
            out.register_hook(
                lambda g: seen.setdefault("g", g.detach().clone()))
        return out
    model._encode = spy
    try:
        step()
    finally:
        model._encode = encode
    if "g" not in seen:
        raise RuntimeError("the step made no encode call with a position "
                           "gradient")
    return seen["table"], seen["x"], seen["g"]


def time_ext(layout, steps):
    import normal_clustering_nerf_torch as package
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    cfg = bench_config(hash_layout=layout)
    cfg = cfg.replace(optim=dataclasses.replace(
        cfg.optim, optimize_ext=True, lr_dR_norm_glob=1e-4))
    tr = build_trainer(cfg, device="cuda")
    tr.mark_invisible_cells()
    model = tr.model
    tr.fit(steps)
    table, x, g = captured_ext(tr, lambda: tr.train_step_core(
        bootstrap=False))
    tabs = (dict(table) if isinstance(table, dict) else {"table": table})
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in tabs.items()}
    tab = leaves if isinstance(table, dict) else leaves["table"]
    xg = x.clone().requires_grad_(True)
    spec, dt = model.spec, model.compute_dtype

    def fwd():
        with torch.no_grad():
            return model._encode(tab, x, spec, dt)

    def fwd_bwd():
        out = model._encode(tab, x, spec, dt)
        return torch.autograd.grad(out, list(leaves.values()), g)

    def fwd_bwd_dx():
        out = model._encode(tab, xg, spec, dt, need_dx=True)
        return torch.autograd.grad(out, list(leaves.values()) + [xg], g)
    out = {"layout": layout, "ext": True, "steps": steps, "M": x.shape[0],
           "g_dtype": str(g.dtype),
           "package": os.path.dirname(package.__file__)}
    for name, fn in (("fwd", fwd), ("fwd_bwd", fwd_bwd),
                     ("fwd_bwd_dx", fwd_bwd_dx)):
        out[f"{name}_ms"] = device_ms(fn)
    out["dx_cost_ms"] = out["fwd_bwd_dx_ms"] - out["fwd_bwd_ms"]
    ms = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train_chunk(16, False)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3 / 16)
    out["graph_step_ms"] = sorted(ms)[1]
    out["captures"] = [c["kind"] for c in tr.captures]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose package is timed")
    ap.add_argument("--layouts", nargs="+", default=["triplane", "tcnn"],
                    choices=["triplane", "brick", "tcnn"])
    ap.add_argument("--steps", type=int, default=576,
                    help="training steps before the sv step is captured")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--ext", action="store_true",
                    help="time the position gradient on the ext path's "
                         "inputs, and the ext trainer's graph step")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_encodes: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available", flush=True)
    for layout in args.layouts:
        t = time.perf_counter()
        out = (time_ext(layout, args.steps) if args.ext
               else time_layout(layout, args.steps, args.seed))
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
