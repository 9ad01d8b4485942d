#!/usr/bin/env python3
"""Device time of the field's forward encode, as the training step calls it.

Run from the repository root on a machine with one NVIDIA H100:

    python3 time_encodes.py                          # this checkout
    python3 time_encodes.py --root DIR               # the checkout at DIR
    python3 time_encodes.py --layouts triplane tcnn  # which fields

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

Each time is the mean of 20 replays of a CUDA graph of one call, queued
behind a sleep kernel and read by CUDA events. Prints one JSON line per
field and, first, the card's name and power limit.
"""
import argparse
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
    fn()
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose package is timed")
    ap.add_argument("--layouts", nargs="+", default=["triplane", "tcnn"],
                    choices=["triplane", "brick", "tcnn"])
    ap.add_argument("--steps", type=int, default=576,
                    help="training steps before the sv step is captured")
    ap.add_argument("--seed", type=int, default=7)
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
        out = time_layout(layout, args.steps, args.seed)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
