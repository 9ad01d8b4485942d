#!/usr/bin/env python3
"""On-card smoke test of the PyTorch / H100 port (`normal_clustering_nerf_torch`).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                  # what the acceptance run does
    python3 chip_smoke.py --profile DIR    # also trace 4 steps of each march

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
     those inputs, gradients included; H3 and H4 also at sigmas scaled up
     per ray, so that rays terminate early and sigma*delta reaches its
     clip. K1 (the sv march: its training launcher on the batch, its
     test-round launcher on the 65,536 rays of the 4 held-out views,
     three rounds) on a random 20% occupancy with solid blocks, where rays
     exceed the 24-interval budget. Then one bootstrap step and one sv
     step at the CPU tests' size run on the card and on the CPU from the
     same state and draws: every loss and gradient must agree;
  3. set every launch count to 0, train STEPS (576) steps with
     `Trainer.fit`: 512 bootstrap steps, then 64 sv steps; an occupancy
     refresh every 16 steps (every cell before step 256, sampled after),
     the clustering ramp from step 500. Read the counts: every training
     launcher must have launched, K1's training launcher 64 times. Every
     loss must be finite and the loss must fall;
  4. K1 against its plain versions on the trained occupancy, and H3's
     forward with T_start on the first test round's samples;
  5. validation: counts to 0, `Trainer.validate()` on the 4 held-out
     views, counts read: the test-round march, the field and the
     compositing must have launched; every metric finite and rotation
     recovery done;
  6. step times (bootstrap and sv steps), then the device time of each
     kernel and of its plain version (torch.profiler), which tracing
     would slow if it ran before.

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
BOOT_STEPS, SV_STEPS = 512, 64
STEPS = BOOT_STEPS + SV_STEPS   # the main path's steps: 0-575
K1_CHUNK = 16384   # rays per plain-version call (its (N, 24, 67) tensors)
K1_STEP_OPS = 30   # f32 operations per enumerated step of the sv march
TEST_ROUNDS = 3    # test rounds per K1 check, each from the last cursors


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


def small_config():
    """The bench configuration at the size of the CPU parity tests
    (tests/test_torch_common.py:slice_configs): f32 compute, plane_res 32,
    grid3d_res 16, grid 32, batch 96 at 16 samples per ray."""
    from normal_clustering_nerf_torch.bench import bench_config
    cfg = bench_config()
    batch = 96
    return cfg.replace(
        model=dataclasses.replace(cfg.model, grid_size=32, plane_res=32,
                                  grid3d_res=16, compute_dtype="float32"),
        render=dataclasses.replace(cfg.render, sample_budget=batch * 16),
        data=dataclasses.replace(cfg.data, batch_size=batch))


def _to_card(tree):
    if isinstance(tree, dict):
        return {k: _to_card(v) for k, v in tree.items()}
    return tree.cuda() if isinstance(tree, torch.Tensor) else tree


def step_parity(seed=11):
    """Two training steps at `small_config`, each on the card through the
    kernels and on the CPU through the plain versions, from the same
    parameters, optimizer state, occupancy and draws (made with numpy from
    `seed`): a bootstrap step, then, after a refresh that rebuilds the sv
    tables, a supervoxel-run step. The CPU path is the one the tests hold
    against the JAX package."""
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
    rng = np.random.default_rng(seed)
    n_tri = cfg.data.batch_size // 3
    chk = Check()
    for boot in (True, False):
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
        log(f"step parity, {'bootstrap' if boot else 'sv'} step at grid "
            f"{cfg.model.grid_size}, batch {cfg.data.batch_size}, f32: the "
            f"card against the CPU (rm/ray {float(ref['rm_samples_per_ray']):.3f},"
            f" trunc {float(ref['trunc_ray_frac']):.4f})")
        # the same tolerances as tests/test_torch_slice.py: sums in another
        # order (cuBLAS, the H2 atomics) through three MLP layers
        for k in sorted(ref):
            if k.startswith("loss_"):
                chk.close(k, got[k], ref[k], 1e-4)
        for k in ("rm_samples_per_ray", "vr_samples_per_ray",
                  "trunc_ray_frac"):
            chk.equal(k, got[k], ref[k])
        for n, g in cpu.last_grads.items():
            chk.close(f"d {n}", card.last_grads[n].cpu(), g, 1e-3)
        if boot:   # the refresh that builds the sv march's tables
            cpu.occ_update(warmup=True)
            if not int(cpu.occ.sv_mask.sum()):
                raise RuntimeError("step parity: the refresh left no "
                                   "occupied supervoxel")
    chk.done("step parity")


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
        kw=train_march_args(cfg.model, cfg.render, N, True))
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
    a = inp["march"]["args"]
    return rec, (a[0], a[1], a[2], a[4])


def random_occupancy(tr, gen, density=0.2):
    """An occupancy state whose cells are set at random with `density`, plus
    two solid slabs and a wall shell, so that many rays cross more occupied
    supervoxels than the interval budget holds (seeded by `gen`)."""
    from normal_clustering_nerf_torch.models.occupancy import (
        supervoxel_tables)
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
    kw = train_march_args(m, cfg.render, N, False)
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


def check_t_start(tr, first_round):
    """H3's forward with T_start against its plain version, on the samples
    of the held-out render's first round through the field, with T_start
    drawn per ray (an eighth of the rays just above T_threshold)."""
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
    err = max(chk.close("opacity", got[0], ref[0], 1e-5),
              chk.close("depth", got[1], ref[1], 1e-5),
              chk.close("rend", got[2], ref[2], 1e-5),
              chk.close("ws", got[3], ref[3], 1e-5),
              chk.equal("vr_samples", got[4], ref[4]))
    chk.done("H3 with T_start")
    return err


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
}
LABEL = {"march_bootstrap": "H1", "triplane_fwd": "H2", "triplane_bwd": "H2",
         "composite_fwd": "H3", "composite_bwd": "H3",
         "distortion_fwd": "H4", "distortion_bwd": "H4",
         "march_sv_train": "K1", "march_sv_test_round": "K1"}


def time_kernels(rec):
    """Device time of each kernel and of its plain version, on the inputs
    the checks kept. Runs after the main path, because tracing with
    torch.profiler slows the host's launches in the rest of the process."""
    for name, r in rec.items():
        r["ms"], r["plain_ms"] = device_ms(r.pop("kernel")), device_ms(r.pop("plain"))
        if "at_refresh_shape" in r:
            M, fn = r.pop("at_refresh_shape")
            log(f"  {name} at the refresh shape, M={M}: "
                f"{device_ms(fn, 5):.4f} ms")


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


def train(tr):
    """Phase 3: the main path's training steps, counted: BOOT_STEPS
    bootstrap steps, then SV_STEPS supervoxel-run steps, timed apart.
    Returns (history, counts, bootstrap s, sv s)."""
    times = []

    def run():
        hist = []
        for n in (BOOT_STEPS, SV_STEPS):
            t = time.perf_counter()
            hist += tr.fit(n)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        return hist
    hist, counts, _ = counted(run)
    log(f"launches in {STEPS} steps: {counts}")
    missing = [n for n, c in counts.items()
               if c == 0 and n != "march_sv_test_round"]
    if missing:
        raise RuntimeError(f"kernels never launched on the main path: {missing}")
    if counts["march_sv_train"] != SV_STEPS:
        raise RuntimeError(f"the sv march launched {counts['march_sv_train']}"
                           f" times in {SV_STEPS} sv steps")
    return hist, counts, times[0], times[1]


def check_losses(hist):
    bad = [(i, k) for i, m in enumerate(hist) for k, v in m.items()
           if k.startswith("loss_") and not math.isfinite(v)]
    if bad:
        raise RuntimeError(f"non-finite losses: {bad[:10]}")
    for name, i in (("first", 0), ("last bootstrap", BOOT_STEPS - 1),
                    ("first sv", BOOT_STEPS), ("last", -1)):
        m = hist[i]
        log(f"  {name} step: loss {m['loss_total']:.6f} psnr {m['psnr']:.3f} "
            f"rm/ray {m['rm_samples_per_ray']:.3f} "
            f"vr/ray {m['vr_samples_per_ray']:.3f} "
            f"trunc {m['trunc_ray_frac']:.4f}")
    # the random background makes single steps noisy: compare the means
    # of the first and the last 6 steps
    q = 6
    head, tail = (sum(m["loss_total"] for m in ms) / q
                  for ms in (hist[:q], hist[-q:]))
    if not tail < 0.75 * head:
        raise RuntimeError(f"the loss did not fall: mean {head:.6f} over the "
                           f"first {q} steps, {tail:.6f} over the last {q}")
    return head, tail


def validate(tr):
    """Phase 5: `Trainer.validate()` on the held-out views, counted."""
    out, counts, wall = counted(tr.validate)
    log(f"launches in validate: {counts}")
    for name in ("march_sv_test_round", "triplane_fwd", "composite_fwd"):
        if not counts[name]:
            raise RuntimeError(f"validate never launched {name}")
    bad = {k: v for k, v in out.items() if not math.isfinite(v)}
    if bad:
        raise RuntimeError(f"non-finite metrics: {bad}")
    rot = [f"ang/clust/{a}_abs" for a in ("yaw", "pitch", "roll")]
    if "ang/clust/failed" in out or not all(k in out for k in rot):
        raise RuntimeError(f"rotation recovery failed: {out}")
    log(f"phase 5: validate {wall * 1e3:.1f} ms ({tr.last_render['rounds']} "
        f"rounds, {tr.last_render['total_samples']} samples): psnr "
        f"{out['psnr']:.3f}, norm_depth_ang_mean "
        f"{out['norm_depth_ang_mean']:.3f}, rot yaw/pitch/roll "
        + "/".join(f"{out[k]:.3f}" for k in rot)
        + f", ssim {out['ssim']:.4f}, depth_rmse {out['depth_rmse']:.4f}, "
        f"miou {out['miou']:.4f}")
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


def profile(tr, out_dir, step_ms, n=4):
    """Trace `n` steps of each march with torch.profiler: the device's busy
    time per step split into the port's kernels, matrix products and the
    rest, the launches per step, and the idle share against the
    unprofiled step time `step_ms[boot]`. Writes each trace's per-kernel
    table and a chrome trace."""
    import os
    from normal_clustering_nerf_torch import kernels
    os.makedirs(out_dir, exist_ok=True)
    for boot in (True, False):
        tag = "bootstrap" if boot else "sv"

        def steps():
            for _ in range(n):
                tr.train_step_core(bootstrap=boot)
        p, dev = traced(steps)
        table = p.key_averages().table(sort_by="self_cuda_time_total",
                                       row_limit=40)
        with open(os.path.join(out_dir, f"profile_{tag}.txt"), "w") as f:
            f.write(table)
        p.export_chrome_trace(os.path.join(out_dir, f"trace_{tag}.json"))
        ours = tuple(f"{k.name}_kernel" for k in kernels.ALL_KERNELS)
        gemm = ("gemm", "gemv", "nvjet", "cutlass")   # cuBLAS / CUTLASS names
        split = {"port kernels": 0.0, "gemm": 0.0, "other": 0.0}
        for e in dev:
            key = ("port kernels" if any(o in e.key for o in ours) else
                   "gemm" if any(s in e.key.lower() for s in gemm) else "other")
            split[key] += e.self_device_time_total / 1e3 / n
        busy = sum(split.values())
        log(f"profile of {n} {tag} steps: device busy {busy:.3f} ms/step ("
            + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f"), {sum(e.count for e in dev) / n:.0f} device launches/step, "
            f"idle {1 - busy / step_ms[boot]:.3f} of the "
            f"{step_ms[boot]:.2f} ms step")
        for line in table.splitlines()[:24]:
            print(line)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", default="",
                    help="directory for torch.profiler traces of 4 steps "
                         "of each march")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; the smoke runs on the card",
              file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from normal_clustering_nerf_torch import kernels
    from normal_clustering_nerf_torch.bench import bench_config, build_trainer

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

    tr = build_trainer(bench_config(), device="cuda")
    tr.mark_invisible_cells()
    log(f"phase 2: trainer built ({sum(p.numel() for p in tr.params.values())}"
        f" parameters); kernels against their plain versions")
    gen = torch.Generator(device="cuda").manual_seed(7)
    rec, train_in = check_kernels(tr, gen)
    test_in = held_out_rays(tr)
    # at the intervals of the steps after the near-field annealing
    k1_random = check_k1(tr, random_occupancy(tr, gen), train_in, test_in,
                         "random 20% occupancy", need_trunc=True,
                         step=tr.cfg.render.anneal_steps)
    step_parity()

    log(f"phase 3: {STEPS} training steps through Trainer.fit")
    hist, counts, boot_s, sv_s = train(tr)
    head, tail = check_losses(hist)
    log(f"  losses finite and falling ({head:.6f} -> {tail:.6f}, means of "
        f"6 steps); fit {boot_s * 1e3 / BOOT_STEPS:.2f} ms/step over the "
        f"{BOOT_STEPS} bootstrap steps, {sv_s * 1e3 / SV_STEPS:.2f} ms/step "
        f"over the {SV_STEPS} sv steps ({math.ceil(STEPS / 16)} refreshes)")

    log("phase 4: K1 and H3 with T_start on the trained occupancy")
    rec.update(check_k1(tr, tr.occ, train_in, test_in, "trained occupancy",
                        need_trunc=False, step=tr.step))
    for name, r in k1_random.items():
        rec[name]["err"] = max(rec[name]["err"], r["err"])
    rec["composite_fwd"]["err"] = max(
        rec["composite_fwd"]["err"],
        check_t_start(tr, rec["march_sv_test_round"].pop("first_round")))
    missing = [k.name for k in kernels.ALL_KERNELS if k.name not in rec]
    if missing:
        raise RuntimeError(f"kernels not checked: {missing}")

    val_counts = validate(tr)
    boot_ms, sv_ms, warm_ms, sampled_ms = step_times(tr)
    log(f"phase 6: one bootstrap step {boot_ms:.2f} ms, one sv step "
        f"{sv_ms:.2f} ms (medians of 8); one refresh {warm_ms:.2f} ms "
        f"(every cell), {sampled_ms:.2f} ms (sampled)")
    log("  device time of each kernel and of its plain version")
    time_kernels(rec)
    if args.profile:
        profile(tr, args.profile, {True: boot_ms, False: sv_ms})

    out = []
    for k in kernels.ALL_KERNELS:
        r = rec[k.name]
        out.append({
            "name": f"{LABEL[k.name]} {k.name}", "route": "cuda",
            "source": k.path, "replaces": REPLACES[k.name],
            "launches": counts[k.name] + val_counts[k.name],
            "max_abs_err": r["err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None})
    print("kernels: " + ", ".join(f"{o['name']} {o['ms']:.4f} ms "
                                  f"(plain {o['plain_ms']:.4f}, bound "
                                  f"{o['bound_ms']:.4f})" for o in out))
    log(f"done in {time.time() - T0:.1f} s")
    print(json.dumps({"kernels": out}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    T0 = time.time()
    main()
