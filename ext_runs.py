#!/usr/bin/env python3
"""Repeated runs of the smoke's extrinsic-optimisation training: the
bench configuration with `optimize_ext` and `lr_dR_norm_glob` 1e-4
(`chip_smoke.EXT_OPTIM`), 576 steps from a fresh trainer each run, to
count the runs whose loss does not fall (the smoke's rule: the mean of
the last 6 steps under 0.75 of the first 6).

Run from the repository root on a machine with one NVIDIA H100:

    python3 ext_runs.py --runs 16              # this checkout, graph steps
    python3 ext_runs.py --runs 16 --root DIR   # the checkout at DIR
    python3 ext_runs.py --runs 16 --eager      # eager steps, checked

By default each run is `Trainer.fit(512)` then `fit(64)`, as the smoke
trains (CUDA-graph replays). With `--eager` every step is an eager
`train_step_core` after the refresh `fit` would make, and every gradient
is checked; at the first non-finite one the run stops, prints the
parameters whose gradient is non-finite and the batch's direction
components that are exactly 0, and takes the step again from its saved
state under autograd's anomaly mode, which names the operation whose
backward gave the NaN. The runs stop after `--stop` such runs.
Prints the card's name and power limit, a line a run, then one JSON line.
"""
import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch

EXT_OPTIM = dict(optimize_ext=True, lr_dR_norm_glob=1e-4)


def snapshot(tr):
    """What one eager step changes: parameters, moments, counters and the
    generator."""
    return dict(p={k: v.detach().clone() for k, v in tr.params.items()},
                mu={k: v.clone() for k, v in tr.opt.state["mu"].items()},
                nu={k: v.clone() for k, v in tr.opt.state["nu"].items()},
                count_t=tr.opt.count_t.clone(), step_t=tr._step_t.clone(),
                gen=tr.generator.get_state(), step=tr.step,
                count=tr.opt.state["count"])


@torch.no_grad()
def restore(tr, s):
    for k, v in tr.params.items():
        v.copy_(s["p"][k])
    for m in ("mu", "nu"):
        for k, v in tr.opt.state[m].items():
            v.copy_(s[m][k])
    tr.opt.count_t.copy_(s["count_t"])
    tr._step_t.copy_(s["step_t"])
    tr.generator.set_state(s["gen"])
    tr.step = s["step"]
    tr.opt.state["count"] = s["count"]


def diagnose(tr, s, bootstrap):
    """The batch's zero direction components, and the step taken again
    from the state `s` under anomaly mode."""
    restore(tr, s)
    gen = tr.generator.get_state()
    batch = tr.sampler.sample(tr.generator)   # the step's own first draw
    tr.generator.set_state(gen)
    with torch.no_grad():
        _, d = tr._assemble_rays(batch)
    print(f"  batch: {int((d == 0).sum())} direction components exactly 0",
          flush=True)
    restore(tr, s)
    with torch.autograd.set_detect_anomaly(True, check_nan=True):
        try:
            tr._step_body(bootstrap)
            print("  again: no anomaly", flush=True)
        except RuntimeError as e:
            print(f"  again: {e}", flush=True)


def eager_run(tr, cfg, steps):
    """Eager steps with a gradient check; the first bad step, or None."""
    for step in range(steps):
        if step % cfg.optim.update_interval == 0:
            tr.occ_update(warmup=step < cfg.optim.warmup_steps)
        s = snapshot(tr)
        boot = step < cfg.render.bootstrap_steps
        tr.train_step_core(bootstrap=boot)
        names = list(tr.last_grads)
        ok = torch.stack([torch.isfinite(tr.last_grads[k]).all()
                          for k in names]).tolist()
        bad = [k for k, o in zip(names, ok) if not o]
        if bad:
            print(f"  step {step}: non-finite gradients {bad}", flush=True)
            diagnose(tr, s, boot)
            return step
    return None


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--root", default=".",
                    help="checkout whose port is run")
    ap.add_argument("--eager", action="store_true",
                    help="eager steps, each gradient checked")
    ap.add_argument("--stop", type=int, default=2,
                    help="with --eager, stop after this many bad runs")
    args = ap.parse_args()
    sys.path.insert(0, args.root)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from normal_clustering_nerf_torch import kernels
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernels.build_all()
    cfg = bench_config()
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, **EXT_OPTIM))
    boot, after = cfg.render.bootstrap_steps, 64
    out = dict(root=args.root, eager=args.eager, runs=0, falling=0,
               bad_steps=[], tails=[])
    for r in range(args.runs):
        tr = build_trainer(cfg, device="cuda")
        tr.mark_invisible_cells()
        t = time.perf_counter()
        if args.eager:
            bad = eager_run(tr, cfg, boot + after)
            out["runs"] += 1
            print(f"run {r}: {'clean' if bad is None else f'bad at {bad}'} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)
            if bad is not None:
                out["bad_steps"].append(bad)
                if len(out["bad_steps"]) >= args.stop:
                    break
            continue
        loss = [m["loss_total"] for m in tr.fit(boot) + tr.fit(after)]
        head, tail = sum(loss[:6]) / 6, sum(loss[-6:]) / 6
        falls = tail < 0.75 * head
        out["runs"] += 1
        out["falling"] += falls
        out["tails"].append(tail)
        print(f"run {r}: loss {head:.6f} -> {tail:.6f} "
              f"{'falls' if falls else 'DOES NOT FALL'} "
              f"({time.perf_counter() - t:.1f} s)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
