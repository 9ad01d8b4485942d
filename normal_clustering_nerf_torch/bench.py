"""Training-throughput and quality benchmark of the port on one card.

    python -m normal_clustering_nerf_torch.bench [--hash_layout brick|tcnn]

The JAX package's `bench.py` run at its defaults (the triplane field
unless `--hash_layout` names the brick or the tcnn grid, as
`bench.py:148-149`), on one CUDA device:
build the bench configuration (`bench_config`, `build_trainer`), mark the
invisible cells, train 600 warmup steps (past the occupancy warmup at
256 and the bootstrap march at 512), time 200 steps, train on to step
4000, validate on the 4 held-out views (the cold render), render them
three more times (the median is the render rate), print one JSON line
with the keys of `bench.py:212-277`, and then hold the four quality gates
of `bench.py:313-338`, exiting non-zero when one fails. It writes no
history file. On standard error it also logs each kernel's launches over
the whole run, from the first step to the last render, as a JSON object.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import kernels
from .config import (
    DataConfig, LossConfig, ModelConfig, OptimConfig, RenderConfig,
    TrainConfig,
)

WARM_STEPS = 600      # past the occupancy warmup (256) and the bootstrap (512)
TIMED_STEPS = 200
TOTAL_STEPS = 4000    # the clustering ramp (500 + 2500) plus 1000 steps
BASELINE_RAYS_PER_S = 0.25e6   # the reference on an RTX 2080 Ti (BASELINE.md)


def bench_config(batch: int = 8192, samples_per_ray: int = 16,
                 sv_intervals: int = 24, compute_dtype: str = "bfloat16",
                 hash_layout: str = "triplane") -> TrainConfig:
    """`bench.py:44-109` at bench.py's defaults: the triplane field (or
    `hash_layout`) in bf16, 16 samples per ray with the full stratified
    tail, 24 sv intervals,
    avoid_near annealing over 600 steps, the production loss weights, the
    triangle sampler with 3-pixel legs, 4 epochs of 1000 steps."""
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
        loss=LossConfig(opacity_w=1e-3, distortion_w=1e-3,
                        norm_D_C_ort_dot_w=2e-3, norm_D_C_centr_dot_w=2e-3,
                        norm_D_C_centr_L1_w=2e-3, norm_can_tres=0.01,
                        norm_can_start=500, norm_can_grow=2500, sem_w=0.04),
        data=DataConfig(batch_size=batch,
                        ray_sampling_strategy="all_images_triang",
                        triang_max_expand=3),
        optim=OptimConfig(num_epochs=4, steps_per_epoch=1000))


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--hash_layout", default="triplane",
                    choices=["brick", "tcnn", "triplane"])
    args = ap.parse_args(argv)
    t_start = time.time()

    def log(msg):
        print(f"[bench {time.time() - t_start:7.1f}s] {msg}", file=sys.stderr,
              flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = bench_config(hash_layout=args.hash_layout)
    tr = build_trainer(cfg)
    log(f"card: {torch.cuda.get_device_name(tr.device)}; hash_layout "
        f"{args.hash_layout}")
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

    torch.cuda.synchronize()
    t = time.perf_counter()
    hist = tr.fit(TIMED_STEPS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t
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
    log(f"kernel launches in this run: {json.dumps(kernels.counts())}")

    # the record first, so that a failed gate cannot hide the measurement
    print(json.dumps(out), flush=True)
    fails = gate_failures(out)
    for f in fails:
        log(f)
    if fails:
        sys.exit(1)


if __name__ == "__main__":
    main()
