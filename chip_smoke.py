#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (`normal_clustering_nerf_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                  # what the acceptance run does
    python3 chip_smoke.py --profile DIR    # also trace 4 steps with torch.profiler

Phases (any failed check raises, so the script exits non-zero):
  1. build the kernels (`csrc/*.cu`, one nvcc per source, all at once);
  2. build the trainer at the bench.py configuration (synthetic room, 48
     views at 128^2, batch 8192 as 2730 triangles, triplane field in bf16,
     16 samples per ray with the full stratified tail, grid 128, the
     production losses), mark the invisible cells, and take one batch of
     the main path's inputs: rays of the scene, a refreshed occupancy
     bitfield, the march's samples and the field's outputs on them. Each
     kernel is held against its plain PyTorch version on those inputs,
     gradients included; H3 and H4 also at sigmas scaled up per ray, so
     that rays terminate early and sigma*delta reaches its clip. Then one
     training step at the CPU tests' size runs on the card and on the CPU
     from the same state and draws: every loss and gradient must agree;
  3. set every launch count to 0, train STEPS (48) bootstrap steps with
     `Trainer.fit` (an occupancy refresh every 16 steps, all 128^3 cells),
     read the counts: every kernel must have launched;
  4. check that every loss is finite and that the loss fell; report the
     first and last loss, rm/ray, vr/ray and the step time;
  5. time each kernel and its plain version on phase 2's inputs (device
     time, torch.profiler), after the step times, which tracing would slow.

Prints the kernels' JSON line, the card's name and power limit, and as its
last line {"ok": true, "device": {...}}. Exits non-zero without a result
when CUDA is not available.
"""
import argparse
import dataclasses
import json
import math
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile as torch_profile

H100_BYTES_PER_S = 3.35e12   # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12       # f32 outside the tensor cores, same sheet
STEPS = 48    # the main path's steps: 0-47, three warmup refreshes


def log(msg):
    print(f"[smoke {time.time() - T0:7.1f}s] {msg}", flush=True)


def traced(fn):
    """Run `fn` under torch.profiler; return its device events (kernels,
    fills, copies: one entry per name)."""
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    dev = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device time")
    return p, dev


def device_ms(fn, iters=20, warm=3):
    """Device time of one call of `fn` in ms: the summed durations of the
    kernels, fills and copies it launches, mean over `iters` calls. A
    wrapper's host time (argument checks, allocation, the ctypes call) is
    not counted: at these sizes it is longer than most kernels, and CUDA
    events around back-to-back calls would time the host instead."""
    for _ in range(warm):
        fn()

    def run():
        for _ in range(iters):
            fn()
    _, dev = traced(run)
    return sum(e.self_device_time_total for e in dev) / 1e3 / iters


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

    def equal(self, name, got, ref):
        bad = int((got != ref).sum())
        log(f"  {name}: {bad} of {ref.numel()} differ {'ok' if not bad else 'FAIL'}")
        if bad:
            self.failures.append(name)
        return 0.0 if not bad else float((got.float() - ref.float()).abs().max())

    def done(self, phase):
        if self.failures:
            raise RuntimeError(f"{phase}: checks failed: {self.failures}")


def bench_config():
    """bench.py:44-109 with its defaults (triplane, bf16, 16 spr, batch
    8192), for the port."""
    from normal_clustering_nerf_torch.config import (
        DataConfig, LossConfig, ModelConfig, OptimConfig, RenderConfig,
        TrainConfig)
    batch, spr = 8192, 16
    return TrainConfig(
        model=ModelConfig(scale=0.5, grid_size=128, max_samples=1024,
                          pred_norm_nn=True, pred_norm_depth=True,
                          pred_sem=True, n_sem_cls=3,
                          compute_dtype="bfloat16", hash_layout="triplane"),
        render=RenderConfig(march_block=1024, sample_budget=batch * spr,
                            sv_intervals=24, anneal_strategy="avoid_near",
                            anneal_steps=600),
        loss=LossConfig(opacity_w=1e-3, distortion_w=1e-3,
                        norm_D_C_ort_dot_w=2e-3, norm_D_C_centr_dot_w=2e-3,
                        norm_D_C_centr_L1_w=2e-3, norm_can_tres=0.01,
                        norm_can_start=500, norm_can_grow=2500, sem_w=0.04),
        data=DataConfig(batch_size=batch,
                        ray_sampling_strategy="all_images_triang",
                        triang_max_expand=3),
        optim=OptimConfig(num_epochs=4, steps_per_epoch=1000))


def small_config():
    """The bench configuration at the size of the CPU parity tests
    (tests/test_torch_common.py:slice_configs): f32 compute, plane_res 32,
    grid3d_res 16, grid 32, batch 96 at 16 samples per ray."""
    cfg = bench_config()
    batch = 96
    return cfg.replace(
        model=dataclasses.replace(cfg.model, grid_size=32, plane_res=32,
                                  grid3d_res=16, compute_dtype="float32"),
        render=dataclasses.replace(cfg.render, sample_budget=batch * 16),
        data=dataclasses.replace(cfg.data, batch_size=batch))


def step_parity(seed=11):
    """One training step at `small_config`, on the card through the kernels
    and on the CPU through the plain versions, from the same parameters,
    occupancy and draws (made with numpy from `seed`). The CPU path is the
    one the tests hold against the JAX package."""
    import numpy as np
    from normal_clustering_nerf_torch.datasets.synthetic import (
        SyntheticDataset)
    from normal_clustering_nerf_torch.models.occupancy import OccupancyState
    from normal_clustering_nerf_torch.training import Trainer

    cfg = small_config()
    scene = SyntheticDataset(split="train", img_wh=(24, 24),
                             n_images=6).load()
    cpu = Trainer(cfg, scene, device="cpu")
    cpu.mark_invisible_cells()
    cpu.occ_update(warmup=True)
    card = Trainer(cfg, scene, device="cuda")
    card.load_state({n: p.detach().cuda() for n, p in cpu.params.items()},
                    OccupancyState(*(t.cuda() for t in cpu.occ)))
    rng = np.random.default_rng(seed)
    n_tri = cfg.data.batch_size // 3
    draws = {"batch": {"img": rng.integers(0, scene.n_images, n_tri),
                       "tri": rng.integers(0, len(cpu.sampler.triang.x1),
                                           n_tri)},
             "noise": rng.random(3 * n_tri, dtype=np.float32),
             "bg": rng.random(3, dtype=np.float32),
             "kmeans_init": rng.choice(n_tri, cfg.loss.cluster_K,
                                       replace=False)}
    log(f"step parity: one step at grid {cfg.model.grid_size}, batch "
        f"{cfg.data.batch_size}, f32: the card against the CPU")
    ref = cpu.train_step_core(bootstrap=True, draws=draws)
    got = {k: v.cpu() for k, v in
           card.train_step_core(bootstrap=True, draws=draws).items()}
    chk = Check()
    # the same tolerances as tests/test_torch_slice.py: sums in another
    # order (cuBLAS, the H2 atomics) through three MLP layers
    for k in sorted(ref):
        if k.startswith("loss_"):
            chk.close(k, got[k], ref[k], 1e-4)
    for k in ("rm_samples_per_ray", "vr_samples_per_ray"):
        chk.equal(k, got[k], ref[k])
    for n, g in cpu.last_grads.items():
        chk.close(f"d {n}", card.last_grads[n].cpu(), g, 1e-3)
    chk.done("step parity")


def main_path_inputs(tr, gen):
    """One batch of the inputs the main path hands each kernel: the rays
    of a sampled batch, their march intervals, a refreshed occupancy
    bitfield (warmup form, drawn from `gen`, not stored in the trainer),
    the bootstrap march's samples and the field's outputs on them."""
    from normal_clustering_nerf_torch.datasets.ray_utils import get_rays
    from normal_clustering_nerf_torch.models.rendering import (
        bootstrap_march_args, field_raws, train_intervals)
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
        kw=bootstrap_march_args(cfg.model, cfg.render, N))
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


def check_kernels(tr, gen):
    """Phase 2: every kernel against its plain version on the main path's
    inputs. Returns {launcher name: record} with the largest error, the
    bound, and calls of the kernel and of its plain version on the same
    inputs for `time_kernels`."""
    from normal_clustering_nerf_torch import kernels
    from normal_clustering_nerf_torch.models import triplane as tp
    from normal_clustering_nerf_torch.ops import composite as cp
    from normal_clustering_nerf_torch.ops import distortion as ds
    from normal_clustering_nerf_torch.ops import ray_march as rm

    inp = main_path_inputs(tr, gen)
    chk, rec = Check(), {}
    N, K, mr = inp["N"], inp["K"], inp["mr"]
    f32 = torch.float32

    # H1: bootstrap march. Exact: same operations, same rounding.
    log(f"H1 march: N={N} S={inp['march']['kw']['march_steps']} K={K} "
        f"G={tr.cfg.model.grid_size}, occupied cells {inp['occupied']}")
    a, kw = inp["march"]["args"], inp["march"]["kw"]
    got = rm.march_rays_train_dense(*a, **kw)
    err = max(chk.equal("t", got.t, mr.t), chk.equal("dt", got.dt, mr.dt),
              chk.equal("valid", got.valid, mr.valid),
              chk.equal("ray_count", got.ray_count, mr.ray_count),
              chk.equal("rm_samples", got.rm_samples, mr.rm_samples))
    hit = int((a[2][:, 0] >= 0).sum())
    S = kw["march_steps"]
    b = nbytes(*a[:5]) + nbytes(mr.t, mr.dt, mr.valid, mr.ray_count) + 4
    # the steps this batch's rays take inside their box interval, each
    # probed once: t_k (2), three positions (6), three cells (18) = 26 f32
    # operations (the kernel's second pass is its own design choice)
    t1, t2 = a[2][:, 0], a[2][:, 1]
    lo = math.sqrt(3.0) / kw["max_samples"]
    in_box = torch.clamp(torch.ceil((t2 - (t1 + lo * a[4])) / lo), 0, S)
    probes = int(torch.where(t1 >= 0, in_box, torch.zeros_like(in_box)).sum())
    rec["march_bootstrap"] = dict(
        err=err, kernel=(lambda: rm.march_rays_train_dense(*a, **kw)),
        plain=(lambda: rm.march_rays_train_dense_plain(*a, **kw)),
        bound=bound(b, probes * 26))
    log(f"  rm/ray {float(mr.rm_samples) / N:.2f}, rays hitting the box "
        f"{hit}, steps inside it {probes}")

    # H2: triplane encode, forward in f32 and bf16, backward (f32 atomics)
    spec = tr.model.spec
    planes = tr.model.hash_table["planes"].detach()
    grid3d = tr.model.hash_table["grid3d"].detach()
    x = inp["x"]
    M = x.shape[0]
    log(f"H2 triplane: M={M}, planes {tuple(planes.shape)}, "
        f"grid3d {tuple(grid3d.shape)}")
    # 4 (8) products summed in another order: a few f32 ulps of the row
    errs = []
    for bf16 in (False, True):
        ref = tp.encode_plain(planes, grid3d, x, spec, bf16)
        errs.append(chk.close(f"encode bf16={bf16}",
                              tp.encode_kernel(planes, grid3d, x, spec, bf16),
                              ref, 2e-6))
    g = torch.randn((M, spec.out_dim), generator=gen, device=x.device)
    shapes = (planes.shape, grid3d.shape)
    gerrs = []
    for name, gg in (("f32", g), ("bf16", g.to(torch.bfloat16).to(f32))):
        ref = tp.encode_grad_plain(x, gg, spec, *shapes)
        got = tp.encode_grad_kernel(x, gg, spec, *shapes)
        # fp32 atomics in launch order vs index_add_: up to ~10^3
        # contributions per table value summed in another order
        gerrs.append(max(chk.close(f"d_planes ({name} cotangent)", got[0],
                                   ref[0], 1e-4),
                         chk.close(f"d_grid ({name} cotangent)", got[1],
                                   ref[1], 1e-4)))
    table_b = touched_table_bytes(x, spec)
    out_dim = spec.out_dim
    fwd_flops = M * (3 * (4 + spec.plane_feats * 4 * 2)
                     + (16 + spec.grid3d_feats * 8 * 2))
    bf16 = tr.model.compute_dtype == torch.bfloat16
    rec["triplane_fwd"] = dict(
        err=max(errs),
        kernel=(lambda: tp.encode_kernel(planes, grid3d, x, spec, bf16)),
        plain=(lambda: tp.encode_plain(planes, grid3d, x, spec,
                                                 bf16)),
        bound=bound(nbytes(x) + table_b + M * out_dim * 4, fwd_flops))
    rec["triplane_bwd"] = dict(
        err=max(gerrs),
        kernel=(lambda: tp.encode_grad_kernel(x, g, spec, *shapes)),
        plain=(lambda: tp.encode_grad_plain(x, g, spec, *shapes)),
        bound=bound(nbytes(x, g) + nbytes(planes, grid3d), fwd_flops))
    # the occupancy refresh's shape: every cell of the 128^3 grid
    xr = torch.rand((tr.cfg.model.grid_size ** 3, 3), generator=gen,
                    device=x.device)
    rec["triplane_fwd"]["at_refresh_shape"] = (
        xr.shape[0], lambda: tp.encode_kernel(planes, grid3d, xr, spec, bf16))

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
        # sequential running sums vs torch.cumsum, expf vs torch.exp
        errs["composite_fwd"].append(max(
            chk.close("opacity", got[0], ref[0], 1e-5),
            chk.close("depth", got[1], ref[1], 1e-5),
            chk.close("rend", got[2], ref[2], 1e-5),
            chk.close("ws", got[3], ref[3], 1e-5),
            chk.equal("vr_samples", got[4], ref[4])))
        gref = cp.composite_grad_plain(*ca, *gs)
        ggot = cp.composite_grad_kernel(*ca, *gs)
        # the sigma gradient subtracts a suffix sum from G*T*exp(-x): keep
        # the tolerance at 1e-4 of its largest value for the cancellation
        errs["composite_bwd"].append(max(
            chk.close("d_sigmas", ggot[0], gref[0], 1e-4),
            chk.close("d_raws", ggot[1], gref[1], 1e-5)))

        # H4: distortion loss on the composite's weights
        da = (ref[3].contiguous(), mr.dt, mr.t, mr.valid)
        log(f"H4 distortion, {tag} sigmas: N={N} K={K}")
        dref, dgot = ds.distortion_plain(*da), ds.distortion_kernel(*da)
        errs["distortion_fwd"].append(chk.close("loss", dgot, dref, 1e-5))
        errs["distortion_bwd"].append(chk.close(
            "d_ws", ds.distortion_grad_kernel(gl, *da),
            ds.distortion_grad_plain(gl, *da), 1e-4))
        if tag == "main":   # timed and bounded at the main path's input
            ma, mda, mgot = ca, da, got
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
    for k in kernels.ALL_KERNELS:
        if k.name not in rec:
            raise RuntimeError(f"kernel {k.name} was not checked")
    return rec


REPLACES = {
    "march_bootstrap": "normal_clustering_nerf_tpu/ops/ray_march.py:402",
    "triplane_fwd": "normal_clustering_nerf_tpu/models/triplane.py:177",
    "triplane_bwd": "normal_clustering_nerf_tpu/models/triplane.py:206",
    "composite_fwd": "normal_clustering_nerf_tpu/ops/composite.py:34",
    "composite_bwd": "normal_clustering_nerf_tpu/ops/composite.py:34",
    "distortion_fwd": "normal_clustering_nerf_tpu/ops/distortion.py:36",
    "distortion_bwd": "normal_clustering_nerf_tpu/ops/distortion.py:36",
}
LABEL = {"march_bootstrap": "H1", "triplane_fwd": "H2", "triplane_bwd": "H2",
         "composite_fwd": "H3", "composite_bwd": "H3",
         "distortion_fwd": "H4", "distortion_bwd": "H4"}


def time_kernels(rec):
    """Device time of each kernel and of its plain version, on the inputs
    `check_kernels` kept. Runs after the main path, because tracing with
    torch.profiler slows the host's launches in the rest of the process."""
    for name, r in rec.items():
        r["ms"], r["plain_ms"] = device_ms(r.pop("kernel")), device_ms(r.pop("plain"))
        if "at_refresh_shape" in r:
            M, fn = r.pop("at_refresh_shape")
            log(f"  {name} at the refresh shape, M={M}: "
                f"{device_ms(fn, 5):.4f} ms")


def train(tr, steps):
    """Phase 3: the main path, counted. Returns (history, counts, s)."""
    from normal_clustering_nerf_torch import kernels
    torch.cuda.synchronize()
    kernels.reset_counts()
    t = time.perf_counter()
    hist = tr.fit(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = kernels.counts()
    missing = [n for n, c in counts.items() if c == 0]
    log(f"launches in {steps} steps: {counts}")
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    return hist, counts, wall


def step_times(tr, n=8):
    """Host-clock time of single steps and of one warmup refresh, each
    ended by a synchronize."""
    ts = []
    for _ in range(n):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.train_step_core(bootstrap=True)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    t = time.perf_counter()
    tr.occ_update(warmup=True)
    torch.cuda.synchronize()
    return sorted(ts)[n // 2], (time.perf_counter() - t) * 1e3


def profile(tr, out_dir, step_ms, n=4):
    """Trace `n` steps with torch.profiler: the device's busy time per
    step split into the port's kernels, matrix products and the rest,
    the launches per step, and the idle share against the unprofiled
    step time `step_ms`. Writes the per-kernel table and a chrome trace."""
    import os
    from normal_clustering_nerf_torch import kernels
    os.makedirs(out_dir, exist_ok=True)

    def steps():
        for _ in range(n):
            tr.train_step_core(bootstrap=True)
    p, dev = traced(steps)
    table = p.key_averages().table(sort_by="self_cuda_time_total",
                                   row_limit=40)
    with open(os.path.join(out_dir, "profile.txt"), "w") as f:
        f.write(table)
    p.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    ours = tuple(f"{k.name}_kernel" for k in kernels.ALL_KERNELS)
    gemm = ("gemm", "gemv", "nvjet", "cutlass")   # cuBLAS / CUTLASS names
    split = {"port kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for e in dev:
        key = ("port kernels" if any(o in e.key for o in ours) else
               "gemm" if any(s in e.key.lower() for s in gemm) else "other")
        split[key] += e.self_device_time_total / 1e3 / n
    busy = sum(split.values())
    log(f"profile of {n} steps: device busy {busy:.3f} ms/step ("
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"), {sum(e.count for e in dev) / n:.0f} device launches/step, "
        f"idle {1 - busy / step_ms:.3f} of the {step_ms:.2f} ms step")
    for line in table.splitlines()[:24]:
        print(line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="directory for a torch.profiler trace of 4 steps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the smoke runs on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from normal_clustering_nerf_torch import kernels
    from normal_clustering_nerf_torch.datasets.synthetic import (
        SyntheticDataset)
    from normal_clustering_nerf_torch.training import Trainer

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
            if "registers" in line or "spill" in line:
                log(f"  {src}: {line.strip()}")

    cfg = bench_config()
    scene = SyntheticDataset(split="train", img_wh=(128, 128),
                             n_images=48).load()
    tr = Trainer(cfg, scene, device="cuda")
    tr.mark_invisible_cells()
    log(f"phase 2: trainer built ({sum(p.numel() for p in tr.params.values())}"
        f" parameters); kernels against their plain versions")
    rec = check_kernels(tr, torch.Generator(device="cuda").manual_seed(7))
    step_parity()

    log(f"phase 3: {STEPS} training steps through Trainer.fit")
    hist, counts, wall = train(tr, STEPS)

    bad = [(i, k) for i, m in enumerate(hist) for k, v in m.items()
           if k.startswith("loss_") and not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"non-finite losses: {bad[:10]}")
    first, last = hist[0], hist[-1]
    for name, m in (("first", first), ("last", last)):
        log(f"  {name} step: loss {m['loss_total']:.6f} psnr {m['psnr']:.3f} "
            f"rm/ray {m['rm_samples_per_ray']:.3f} "
            f"vr/ray {m['vr_samples_per_ray']:.3f}")
    # the random background makes single steps noisy: compare the means
    # of the first and the last 6 steps
    q = 6
    head, tail = (sum(m["loss_total"] for m in ms) / q
                  for ms in (hist[:q], hist[-q:]))
    if not tail < 0.75 * head:
        raise RuntimeError(f"the loss did not fall: mean {head:.6f} over the "
                           f"first {q} steps, {tail:.6f} over the last {q}")
    step_ms, refresh_ms = step_times(tr)
    log(f"phase 4: losses finite and falling ({head:.6f} -> {tail:.6f}, "
        f"means of {q} steps); fit {wall * 1e3 / STEPS:.2f} ms/step "
        f"over {STEPS} steps with {math.ceil(STEPS / 16)} refreshes;"
        f" one step {step_ms:.2f} ms (median of 8), one warmup refresh "
        f"{refresh_ms:.2f} ms")
    log("phase 5: device time of each kernel and of its plain version")
    time_kernels(rec)
    if args.profile:
        profile(tr, args.profile, step_ms)

    out = []
    for k in kernels.ALL_KERNELS:
        r = rec[k.name]
        out.append({
            "name": f"{LABEL[k.name]} {k.name}", "route": "cuda",
            "source": k.path, "replaces": REPLACES[k.name],
            "launches": counts[k.name], "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None})
    print("kernels: " + ", ".join(f"{o['name']} {o['ms']:.4f} ms "
                                  f"(plain {o['plain_ms']:.4f}, bound "
                                  f"{o['bound_ms']:.4f})" for o in out))
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    T0 = time.time()
    main()
