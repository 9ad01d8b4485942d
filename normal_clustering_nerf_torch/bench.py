"""Training-throughput and quality benchmark of the port on the card.

    python -m normal_clustering_nerf_torch.bench [--hash_layout brick|tcnn]
        [--compute_dtype float32] [--batch N] [--samples_per_ray K]
        [--sv_intervals RI] [--min_losses] [--no_occ_update]
        [--skip-quality] [--profile DIR] [--num_chips N]

The JAX package's `bench.py` with the same flags, on CUDA devices: build
the bench configuration (`bench_config`,
`build_trainer`), mark the invisible cells, train 600 warmup steps (past
the occupancy warmup at 256 and the bootstrap march at 512), time 200
steps (`Trainer.fit`, which runs the 16 steps between two refreshes as
replays of a CUDA graph, as `bench.py:112-131 run_steps` runs them as one
dispatch), train on to step 4000, validate on the 4 held-out views (the
cold render), render them three more times (the median is the render
rate), print one JSON line with the keys of `bench.py:212-277`, and then
hold the four quality gates of `bench.py:313-338`, exiting non-zero when
one fails. With `--num_chips N` (bench.py:222-235) N ranks, one a card
(started here unless a launcher did, `parallel.launch`), split the same
global batch; the timed window gives the train rays/s of all of them, and
then rank 0 alone times a one-card run of the same global batch (JAX's
comment says the same per-chip batch, its code runs the same global
one), for `scaling_efficiency` = rays/s / (one-card rays/s x N) and
`rays_per_s_per_chip`; `validate` and the gates run on rank 0, which
alone prints. `--skip-quality` stops after the timed window; `--min_losses`
(rgb and opacity only) and `--no_occ_update` (no refresh in the timed
window) are bench.py's cost probes; `--profile DIR` traces the timed
window with torch.profiler. The JSON record, with the run's `config`
(bench.py:288-293's keys), the card's name and power limit and the time,
is appended to `bench_history_torch.jsonl` at the repository root (the
JAX bench's `bench_history.jsonl` is never written), and the throughput
is logged against the best record of the same config on a card of the
same name, with a warning past a 10% regression (bench.py:280-311); with
several cards rank 0 alone writes. On standard error it also logs the
CUDA graphs captured and each kernel's launches over the whole run, from
the first step to the last render, as a JSON object.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import logging
import os
import shutil
import subprocess
import sys
import time
from typing import Dict, Optional

import torch

from . import kernels
from .config import (
    DataConfig, LossConfig, ModelConfig, OptimConfig, ParallelConfig,
    RenderConfig, TrainConfig,
)
from .parallel.launch import (initialize_multihost, launched, require_cards,
                              spawn)
from .training.distributed import barrier, on_rank0

WARM_STEPS = 600      # past the occupancy warmup (256) and the bootstrap (512)
TIMED_STEPS = 200
TOTAL_STEPS = 4000    # the clustering ramp (500 + 2500) plus 1000 steps
BASELINE_RAYS_PER_S = 0.25e6   # the reference on an RTX 2080 Ti (BASELINE.md)
HISTORY = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "bench_history_torch.jsonl")
REGRESSION_PCT = 10.0   # the warning's threshold (bench.py:309)


def bench_config(batch: int = 8192, samples_per_ray: int = 16,
                 sv_intervals: int = 24, compute_dtype: str = "bfloat16",
                 hash_layout: str = "triplane",
                 min_losses: bool = False, num_chips: int = 1) -> TrainConfig:
    """`bench.py:44-109` at bench.py's defaults: the triplane field (or
    `hash_layout`) in bf16, 16 samples per ray with the full stratified
    tail, 24 sv intervals,
    avoid_near annealing over 600 steps, the production loss weights (rgb
    and opacity only with `min_losses`), the triangle sampler with 3-pixel
    legs, 4 epochs of 1000 steps, the rays over `num_chips` ranks. The
    march budget is the global batch times `samples_per_ray` on every
    rank, as `bench.py:62` sets it: a rank marches budget // its rays
    samples a ray, `num_chips` times `samples_per_ray` (64 at 4 cards
    and the default 16)."""
    loss = (LossConfig(opacity_w=1e-3) if min_losses else LossConfig(
        opacity_w=1e-3, distortion_w=1e-3, norm_D_C_ort_dot_w=2e-3,
        norm_D_C_centr_dot_w=2e-3, norm_D_C_centr_L1_w=2e-3,
        norm_can_tres=0.01, norm_can_start=500, norm_can_grow=2500,
        sem_w=0.04))
    return TrainConfig(
        model=ModelConfig(scale=0.5, grid_size=128, max_samples=1024,
                          pred_norm_nn=True, pred_norm_depth=True,
                          pred_sem=True, n_sem_cls=3,
                          compute_dtype=compute_dtype,
                          hash_layout=hash_layout),
        render=RenderConfig(march_block=1024,
                            sample_budget=batch * samples_per_ray,
                            sv_intervals=sv_intervals,
                            anneal_strategy="avoid_near", anneal_steps=600),
        loss=loss,
        data=DataConfig(batch_size=batch,
                        ray_sampling_strategy="all_images_triang",
                        triang_max_expand=3),
        optim=OptimConfig(num_epochs=4, steps_per_epoch=1000),
        parallel=ParallelConfig(mesh_shape=(num_chips,)))


def build_trainer(cfg: TrainConfig, device=None):
    """The bench trainer: the synthetic room, 48 training views and 4
    held-out views at 128^2 (bench.py:101-109)."""
    from .datasets.synthetic import SyntheticDataset
    from .training import Trainer
    scene_tr = SyntheticDataset(split="train", img_wh=(128, 128),
                                n_images=48).load()
    scene_te = SyntheticDataset(split="test", img_wh=(128, 128),
                                n_images=4).load()
    return Trainer(cfg, scene_tr, scene_te, device=device)


def gate_failures(out) -> list:
    """The quality gates of bench.py:313-338, unchanged."""
    fails = []
    if not out["psnr"] >= 30.0:
        fails.append(f"PSNR gate failed: {out['psnr']} < 30.0")
    if not out["trunc_ray_frac"] <= 0.01:
        fails.append(f"truncation gate failed: trunc_ray_frac "
                     f"{out['trunc_ray_frac']} > 0.01")
    if not out.get("norm_depth_ang_mean", float("inf")) <= 30.0:
        fails.append(f"normal gate failed: norm_depth_ang_mean "
                     f"{out.get('norm_depth_ang_mean')} > 30")
    for ax in ("yaw", "pitch", "roll"):
        k = f"rot_{ax}_abs"
        if k not in out:
            fails.append(f"rotation recovery missing from validate: {k}")
        elif not out[k] <= 5.0:
            fails.append(f"rotation-recovery gate failed: {k} {out[k]} > 5")
    return fails


def card_info() -> Dict[str, str]:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them (the
    power limit "not read" where nvidia-smi is not there)."""
    try:
        line = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0]
        name, limit = (x.strip() for x in line.rsplit(",", 1))
    except (OSError, subprocess.CalledProcessError, IndexError, ValueError):
        name, limit = torch.cuda.get_device_name(0), "not read"
    return {"name": name, "power_limit": limit}


def run_config(args) -> Dict:
    """The history record's `config`, bench.py:288-293's keys."""
    return {"batch": args.batch, "compute_dtype": args.compute_dtype,
            "hash_layout": args.hash_layout,
            "samples_per_ray": args.samples_per_ray,
            "sv_intervals": args.sv_intervals, "num_chips": args.num_chips}


def record_history(out: Dict, config: Dict, card: Dict[str, str], log,
                   path: str = HISTORY) -> Optional[float]:
    """Append the record `out` with its `config`, `card` and time to the
    history file at `path` (bench.py:280-311), and log its throughput
    against the best record at the same config on a card of the same
    name, warning past a REGRESSION_PCT regression. Returns the change in
    percent, None when no such record was there."""
    rec = dict(out, config=config, card=card,
               time=time.strftime("%Y-%m-%dT%H:%M:%S"))
    best = None
    try:
        with open(path) as f:
            for line in f:
                h = json.loads(line)
                if (h.get("config") == config
                        and h.get("card", {}).get("name") == card["name"]):
                    v = h.get("value", 0)
                    best = v if best is None else max(best, v)
    except FileNotFoundError:
        pass
    with open(path, "a") as f:
        f.write(json.dumps(rec) + "\n")
    if not best:
        return None
    delta = (out["value"] - best) / best * 100
    log(f"throughput vs best recorded at this config on {card['name']}: "
        f"{delta:+.1f}%")
    if delta < -REGRESSION_PCT:
        log(f"WARNING: >{REGRESSION_PCT:.0f}% throughput regression vs best "
            f"({best:,.0f})")
    return delta


def parse_args(argv=None):
    """bench.py:143-161's flags."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="directory for a torch.profiler trace of the timed "
                         "window")
    ap.add_argument("--skip-quality", action="store_true",
                    help="throughput only: no training to step 4000, no "
                         "validation, no gates")
    ap.add_argument("--compute_dtype", default="bfloat16",
                    choices=["bfloat16", "float32"])
    ap.add_argument("--hash_layout", default="triplane",
                    choices=["brick", "tcnn", "triplane"])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--samples_per_ray", type=int, default=16,
                    help="static march budget per ray of the global batch")
    ap.add_argument("--sv_intervals", type=int, default=24)
    ap.add_argument("--min_losses", action="store_true",
                    help="rgb+opacity losses only (loss-block cost probe)")
    ap.add_argument("--no_occ_update", action="store_true",
                    help="skip occupancy refreshes in the timed window "
                         "(occupancy-maintenance cost probe)")
    ap.add_argument("--num_chips", type=int, default=1,
                    help="split the batch's rays over N cards and report "
                         "the scaling efficiency")
    args = ap.parse_args(argv)
    if args.num_chips < 1:
        ap.error(f"--num_chips {args.num_chips}: one card or more")
    return args


def config_of(args, num_chips=None) -> TrainConfig:
    return bench_config(batch=args.batch,
                        samples_per_ray=args.samples_per_ray,
                        sv_intervals=args.sv_intervals,
                        compute_dtype=args.compute_dtype,
                        hash_layout=args.hash_layout,
                        min_losses=args.min_losses,
                        num_chips=num_chips or args.num_chips)


def split_device_time(events, n_steps: int):
    """torch.profiler device events (`key_averages()`, device entries) ->
    ms a step of the port's kernels (each launcher's `<name>_kernel`, the
    scatter H6 and H8 share, K8's merge and pack), of cuBLAS / CUTLASS
    products and of the rest, and the device launches a step."""
    ours = tuple(f"{k.name}_kernel" for k in kernels.ALL_KERNELS) + (
        "grad_scatter::scatter_kernel", "occ_merge_kernel",
        "occ_pack_kernel")
    gemm = ("gemm", "gemv", "nvjet", "cutlass")
    split = {"port kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for e in events:
        key = ("port kernels" if any(o in e.key for o in ours) else
               "gemm" if any(g in e.key.lower() for g in gemm) else "other")
        split[key] += e.self_device_time_total / 1e3 / n_steps
    return split, sum(e.count for e in events) / n_steps


def one_card_rays_per_s(args, log) -> float:
    """Train rays/s of a one-card trainer at the same global batch
    (bench.py:222-233): WARM_STEPS steps, then TIMED_STEPS timed."""
    tr = build_trainer(config_of(args, num_chips=1))
    tr.mark_invisible_cells()
    tr.fit(WARM_STEPS)
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.fit(TIMED_STEPS, occ_update=not args.no_occ_update)
    torch.cuda.synchronize()
    rate = tr.cfg.data.batch_size * TIMED_STEPS / (time.perf_counter() - t)
    log(f"one-card reference: {rate:,.0f} rays/s "
        f"({tr.cfg.data.batch_size / rate * 1e3:.2f} ms/step)")
    return rate


def main(argv=None):
    args = parse_args(argv)
    if args.num_chips > 1 and not launched():
        require_cards(args.num_chips)
        kernels.build_all()   # once, before the ranks load them
        return spawn(main, args.num_chips, (argv,), device="cuda")
    initialize_multihost(device="cuda")
    t_start = time.time()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config_of(args)
    tr = build_trainer(cfg)
    axis = tr.axis
    rank0 = axis is None or axis.rank == 0

    def log(msg):
        if rank0:
            print(f"[bench {time.time() - t_start:7.1f}s] {msg}",
                  file=sys.stderr, flush=True)

    def sync():   # every rank's card done
        torch.cuda.synchronize()
        if axis is not None:
            barrier(axis)

    if rank0:
        trainer_log = logging.getLogger("normal_clustering_nerf_torch")
        trainer_log.setLevel(logging.INFO)
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(logging.Formatter("[bench trainer] %(message)s"))
        trainer_log.addHandler(handler)
    flags = {k: v for k, v in vars(args).items() if k != "profile"}
    log(f"card: {torch.cuda.get_device_name(tr.device)} x {args.num_chips}; "
        f"{flags}")
    batch = cfg.data.batch_size
    tr.mark_invisible_cells()

    kernels.reset_counts()
    t = time.perf_counter()
    m = tr.fit(1)[-1]
    compile_s = time.perf_counter() - t
    log(f"first step {compile_s:.1f}s (kernel builds included)")
    m = tr.fit(WARM_STEPS - 1)[-1]
    log(f"warmup done ({WARM_STEPS} steps, psnr {m['psnr']:.2f}, rm/ray "
        f"{m['rm_samples_per_ray']:.1f}, vr/ray {m['vr_samples_per_ray']:.1f},"
        f" trunc {m['trunc_ray_frac']:.4f})")

    from torch.profiler import ProfilerActivity, profile
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if args.profile and rank0 else contextlib.nullcontext()) as prof:
        sync()
        t = time.perf_counter()
        hist = tr.fit(TIMED_STEPS, occ_update=not args.no_occ_update)
        sync()
        dt = time.perf_counter() - t
    if args.profile and rank0:
        write_profile(prof, args.profile, dt * 1e3 / TIMED_STEPS, log)
    rays_per_s = batch * TIMED_STEPS / dt
    out = {
        "metric": "train_rays_per_s",
        "value": round(rays_per_s, 1),
        "unit": "rays/s",
        "vs_baseline": round(rays_per_s / BASELINE_RAYS_PER_S, 3),
        "it_per_s": round(TIMED_STEPS / dt, 2),
        "compile_s": round(compile_s, 1),
    }
    log(f"train throughput {rays_per_s:,.0f} rays/s "
        f"({TIMED_STEPS / dt:.1f} it/s, {dt * 1e3 / TIMED_STEPS:.2f} ms/step;"
        f" rm/ray {hist[-1]['rm_samples_per_ray']:.2f})")
    if axis is not None:
        launches = kernels.counts()
        r1 = on_rank0(axis, one_card_rays_per_s, args, log)
        if rank0:
            out["num_chips"] = axis.size
            out["scaling_efficiency"] = round(rays_per_s / (r1 * axis.size),
                                              3)
            out["rays_per_s_per_chip"] = round(rays_per_s / axis.size, 1)
        for k in kernels.ALL_KERNELS:   # rank 0's one-card run is not
            k.launches = launches[k.name]   # this run's
    if args.skip_quality:
        log(f"graphs captured: {json.dumps(tr.captures)}")
        log(f"kernel launches in this run: {json.dumps(kernels.counts())}")
        if rank0:
            print(json.dumps(out), flush=True)
            record_history(out, run_config(args), card_info(), log)
        return

    log(f"training to step {TOTAL_STEPS} for the quality gates")
    m = tr.fit(TOTAL_STEPS - tr.step)[-1]
    out["train_psnr"] = round(m["psnr"], 2)
    out["trunc_ray_frac"] = round(m["trunc_ray_frac"], 4)
    log(f"train psnr at {tr.step}: {m['psnr']:.2f}")
    scene = tr.scene_test
    W, H = scene.img_wh
    t = time.perf_counter()
    val = tr.validate()
    render_cold_s = time.perf_counter() - t
    if not rank0:   # validate and the renders ran on rank 0
        for _ in range(3):
            tr.render_images(list(scene.poses))
        return
    warm_times = []
    for _ in range(3):
        t = time.perf_counter()
        tr.render_images(list(scene.poses))
        warm_times.append(time.perf_counter() - t)
    render_s = sorted(warm_times)[1]
    log(f"render cold {render_cold_s:.2f}s warm {render_s:.3f}s (3 runs: "
        f"{', '.join(f'{x:.3f}' for x in warm_times)}; "
        f"{tr.last_render['rounds']} rounds, "
        f"{tr.last_render['total_samples']} samples)")
    out["render_cold_s"] = round(render_cold_s, 1)
    out["psnr"] = round(val.get("psnr", float("nan")), 2)
    for k in ("norm_depth_ang_mean", "norm_nn_ang_mean",
              "ang/clust/yaw_abs", "ang/clust/pitch_abs",
              "ang/clust/roll_abs"):
        if k in val:
            out[k.replace("ang/clust/", "rot_")] = round(val[k], 2)
    out["render_rays_per_s"] = round(scene.n_images * W * H / render_s, 1)
    log(f"graphs captured: {json.dumps(tr.captures)}")
    log(f"kernel launches in this run: {json.dumps(kernels.counts())}")

    # the record first, so that a failed gate cannot hide the measurement
    print(json.dumps(out), flush=True)
    record_history(out, run_config(args), card_info(), log)
    fails = gate_failures(out)
    for f in fails:
        log(f)
    if fails:
        sys.exit(1)


def write_profile(prof, out_dir: str, step_ms: float, log):
    """The timed window's trace (gzipped chrome trace and the per-kernel
    table) into `out_dir`, and on the log the device's busy time a step,
    split as `split_device_time`, its launches a step, its idle share
    against the host's `step_ms`, and the largest "other" kernels."""
    from torch.autograd import DeviceType
    os.makedirs(out_dir, exist_ok=True)
    dev = [e for e in prof.key_averages()
           if e.device_type == DeviceType.CUDA]
    table = prof.key_averages().table(sort_by="self_cuda_time_total",
                                      row_limit=60)
    with open(os.path.join(out_dir, "bench_profile.txt"), "w") as f:
        f.write(table)
    trace = os.path.join(out_dir, "bench_trace.json")
    prof.export_chrome_trace(trace)
    with open(trace, "rb") as f, gzip.open(trace + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(trace)
    if not dev:
        log(f"profile written to {out_dir}: the profiler recorded no "
            "device time")
        return
    split, launches = split_device_time(dev, TIMED_STEPS)
    busy = sum(split.values())
    graphs = sum(e.count for e in prof.key_averages()
                 if e.key == "cudaGraphLaunch") / TIMED_STEPS
    log(f"profile of the {TIMED_STEPS} timed steps (written to {out_dir}): "
        f"device busy {busy:.3f} ms/step ("
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"), {launches:.0f} device launches/step, {graphs:.2f} graph "
        f"launches/step, idle {1 - busy / step_ms:.3f} of the "
        f"{step_ms:.2f} ms step")
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:25]:
        kind, _ = split_device_time([e], 1)
        if kind["other"]:
            log(f"  other: {e.self_device_time_total / 1e3 / TIMED_STEPS:.4f}"
                f" ms/step, {e.count / TIMED_STEPS:.1f}/step  {e.key[:100]}")


if __name__ == "__main__":
    main()
