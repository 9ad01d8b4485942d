"""Train- and test-time rendering — port of the dense branch of the JAX
package's `models/rendering.py:render_train` and of the bucket layout of
its `render_test`.

Training: AABB intersect -> near clamp -> interval annealing -> the
bootstrap march (kernel H1) for the first `bootstrap_steps` steps, the
supervoxel-run march (kernel K1) after them -> field on the (N*K)
samples (kernel H2 + MLPs) -> compositing (kernel H3) -> random
background. The random draws (march noise, background colour) are
separable: pass them as `noise` / `bg`, or a `generator` to draw them.

Test: rounds of the sv test march (K1) over the rays still alive, each
composited (H3 with T_start) onto the ray's running result.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.composite import composite_rays
from ..ops.ray_aabb import ray_aabb_intersect
from ..ops.ray_march import (
    march_rays_test_round_sv, march_rays_train_dense,
    march_rays_train_dense_sv,
)


def anneal_hits(hits_t, global_step: int, strategy: str, anneal_steps: int):
    """Training ray-interval annealing (reference: rendering.py:168-188);
    the 'avoid_near' strategy (RegNeRF, ps = 0.5)."""
    if anneal_steps <= 0 or strategy == "none" or global_step >= anneal_steps:
        return hits_t
    if strategy != "avoid_near":
        raise NotImplementedError(
            f"anneal_strategy {strategy!r} is not ported (ROADMAP A7)")
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    # the step fraction in f32, as the JAX version computes it
    frac = float(np.float32(global_step) / np.float32(anneal_steps))
    mid = (t1 + t2) / 2.0
    n_i = min(max(frac, 0.5), 1.0)
    return torch.stack([mid + n_i * (t1 - mid), t2], dim=-1)


def split_rend(cfg, rend) -> Dict[str, torch.Tensor]:
    """rend channels -> rgb / norm_nn / sem (reference: rendering.py:214-224)."""
    out = {"rgb": rend[..., :3]}
    i = 3
    if cfg.pred_norm_nn:
        if cfg.pred_norm_nn_norm:
            raise NotImplementedError(
                "pred_norm_nn_norm is not ported (ROADMAP A7)")
        out["norm_nn"] = rend[..., i:i + 3]
        i += 3
    if cfg.pred_sem:
        out["sem"] = rend[..., i:i + cfg.n_sem_cls]
    return out


def bg_color(cfg, random_bg: bool, generator=None, device=None):
    """Per-step random training background, else white for synthetic
    scenes (exp_step_factor 0) and black otherwise (rendering.py:82-99)."""
    if random_bg:
        return torch.rand(3, generator=generator, device=device)
    v = 1.0 if cfg.exp_step_factor == 0.0 else 0.0
    return torch.full((3,), v, device=device)


def field_raws(model, xyz, dirs):
    out = model(xyz, dirs)
    raws = [out["rgbs"]]
    if model.cfg.pred_norm_nn:
        raws.append(out["norms"])
    if model.cfg.pred_sem:
        raws.append(out["sems"])
    return out["sigmas"], torch.cat(raws, dim=-1)


def near_intervals(cfg, rays_o, rays_d):
    """(N, 2) scene-box hit of each ray with the near-distance clamp
    (reference: rendering.py:28); -1 where the ray misses."""
    dev = rays_o.device
    hits_t = ray_aabb_intersect(
        rays_o, rays_d, torch.zeros(3, device=dev),
        torch.full((3,), cfg.scale, device=dev))
    t1 = hits_t[:, 0]
    t1 = torch.where((t1 >= 0) & (t1 < cfg.near_dist),
                     torch.full_like(t1, cfg.near_dist), t1)
    return torch.stack([t1, hits_t[:, 1]], dim=-1)


def train_intervals(cfg, rcfg: RenderConfig, rays_o, rays_d,
                    global_step: int = 0):
    """(N, 2) march interval of each training ray: the near-clamped box
    hit and the interval annealing."""
    hits_t = near_intervals(cfg, rays_o, rays_d)
    return anneal_hits(hits_t, global_step, rcfg.anneal_strategy,
                       rcfg.anneal_steps).contiguous()


def uses_sv(cfg, rcfg: RenderConfig) -> bool:
    """Whether the supervoxel-run march applies (rendering.py:163-165,
    621-623): one cascade, a uniform step grid, G a multiple of 8."""
    return (rcfg.march_coarse and cfg.cascades == 1
            and cfg.exp_step_factor == 0.0 and cfg.grid_size % 8 == 0)


def train_march_args(cfg, rcfg: RenderConfig, n_rays: int,
                     bootstrap: bool) -> Dict:
    """Keyword arguments of the training march for `n_rays` rays: K =
    budget // N samples with the stratified tail. The bootstrap march
    takes S_boot coarse steps of sqrt(3)/S_boot; the sv march takes
    `march_block` steps of sqrt(3)/max_samples over at most
    `sv_intervals` occupied supervoxel runs."""
    budget = rcfg.sample_budget or n_rays * 32
    K = budget // n_rays
    tail_k = K if rcfg.march_tail_k < 0 else rcfg.march_tail_k
    if bootstrap:
        S_boot = min(rcfg.bootstrap_max_samples, cfg.max_samples)
        return dict(
            cascades=cfg.cascades, scale=cfg.scale,
            exp_step_factor=cfg.exp_step_factor, grid_size=cfg.grid_size,
            max_samples=S_boot, samples_per_ray=K, march_steps=S_boot,
            tail_k=tail_k)
    return dict(scale=cfg.scale, grid_size=cfg.grid_size,
                max_samples=cfg.max_samples, samples_per_ray=K,
                march_steps=rcfg.march_block, n_intervals=rcfg.sv_intervals,
                tail_k=tail_k)


def render_train(model, occ, rays_o, rays_d, rcfg: RenderConfig, *,
                 global_step: int = 0, bootstrap: bool = False,
                 noise: Optional[torch.Tensor] = None,
                 bg: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Dict:
    """Render N rays with K = budget // N samples each; returns the same
    keys as the JAX `render_train` dense branch. `occ` is the
    `OccupancyState`: the bootstrap march reads its bitfield, the sv
    march its `sv_mask` and `sv_payload`."""
    if rcfg.march_layout != "dense":
        raise NotImplementedError("the flat march layout is ROADMAP A13")
    cfg = model.cfg
    if not (bootstrap or uses_sv(cfg, rcfg)):
        raise NotImplementedError(
            "after the bootstrap only the supervoxel-run march is ported; "
            "the bitfield march over march_block steps is ROADMAP A13")
    N = rays_o.shape[0]
    dev = rays_o.device
    hits_t = train_intervals(cfg, rcfg, rays_o, rays_d, global_step)
    if noise is None:
        noise = torch.rand(N, generator=generator, device=dev)
    noise = noise * rcfg.march_noise
    kw = train_march_args(cfg, rcfg, N, bootstrap)
    if bootstrap:
        mr = march_rays_train_dense(rays_o, rays_d, hits_t,
                                    occ.density_bitfield, noise, **kw)
    else:
        mr = march_rays_train_dense_sv(rays_o, rays_d, hits_t, occ.sv_mask,
                                       occ.sv_payload, noise, **kw)
    K = mr.t.shape[1]
    # t is a constant of the geometry (no gradient to the march)
    xyz = (rays_o[:, None, :] + mr.t[..., None] * rays_d[:, None, :])
    dirs = rays_d[:, None, :].expand(N, K, 3)
    sigmas, raws = field_raws(model, xyz.reshape(N * K, 3),
                              dirs.reshape(N * K, 3))
    comp = composite_rays(sigmas.reshape(N, K), raws.reshape(N, K, -1),
                          mr.dt, mr.t, mr.valid, rcfg.T_threshold)
    results = {
        "opacity": comp["opacity"],
        "depth": comp["depth"],
        "ws": comp["ws"],
        "deltas": mr.dt,
        "ts": mr.t,
        "ray_count": mr.ray_count,
        "sample_valid": mr.valid,
        "rm_samples": mr.rm_samples,
        "trunc_rays": mr.trunc_rays,
        "vr_samples": comp["vr_samples"].sum(),
        "rays_o": rays_o,
        "rays_d": rays_d,
    }
    results.update(split_rend(cfg, comp["rend"]))
    if bg is None:
        bg = bg_color(cfg, rcfg.random_bg, generator, dev)
    results["rgb"] = results["rgb"] + bg[None, :] * (1.0 - comp["opacity"][:, None])
    return results


# ---------------------------------------------------------------- test time
def bucket_ladder(N: int, min_samples: int):
    """Every (B, K) rung of the bucket renderer with sv rounds for N rays
    (rendering.py:441-456): B from 256 doubling while below N, then N;
    K the reference's adaptive N // B capped at 64 and floored at
    min_samples, doubled for the full-width rung."""
    ladder, b = [], 256
    while b < N:
        ladder.append(b)
        b *= 2
    ladder.append(N)
    out = []
    for B in ladder:
        K = max(min(N // B, 64), min_samples)
        out.append((B, min(2 * K, 64) if B == N else K))
    return out


def _test_round(model, occ, rcfg: RenderConfig, rays_o, rays_d, t2,
                state: Dict, K: int):
    """One round over the alive rays (rendering.py:312-381): the sv test
    march from each cursor, the field on the n_alive * K samples and the
    composite continued from each ray's opacity. Updates `state` in
    place; returns the round's valid samples (a tensor, or 0)."""
    cfg = model.cfg
    cursor, alive, opacity, depth, rend = (
        state[k] for k in ("cursor", "alive", "opacity", "depth", "rend"))
    idx = torch.nonzero(alive).reshape(-1)
    n = idx.numel()
    if n == 0:
        return 0
    ro, rd, far = rays_o[idx], rays_d[idx], t2[idx]
    t_k, dt_k, valid, new_cur = march_rays_test_round_sv(
        ro, rd, cursor[idx], far, torch.ones_like(far, dtype=torch.bool),
        occ.sv_mask, occ.sv_payload, scale=cfg.scale,
        grid_size=cfg.grid_size, max_samples=cfg.max_samples, n_steps=K,
        n_intervals=rcfg.test_sv_intervals)
    xyz = (ro[:, None, :] + t_k[..., None] * rd[:, None, :]).reshape(n * K, 3)
    dirs = rd[:, None, :].expand(n, K, 3).reshape(n * K, 3)
    sigmas, raws = field_raws(model, xyz, dirs)
    op_b = opacity[idx]
    comp = composite_rays(sigmas.reshape(n, K), raws.reshape(n, K, -1), dt_k,
                          t_k, valid, rcfg.T_threshold, T_start=1.0 - op_b)
    op_new = op_b + comp["opacity"]
    opacity[idx] = op_new
    depth[idx] = depth[idx] + comp["depth"]
    rend[idx] = rend[idx] + comp["rend"]
    cursor[idx] = new_cur
    alive[idx] = ~((1.0 - op_new) <= rcfg.T_threshold) & (new_cur < far)
    return valid.sum()


def render_test(model, occ, rays_o, rays_d, rcfg: RenderConfig) -> Dict:
    """Inference render of N rays: the bucket layout with supervoxel-run
    rounds (rendering.py:573-740). Returns opacity (N,), depth (N,), rgb
    (N, 3) [+ norm_nn, sem], total_samples (the valid samples of every
    round, an int) and rounds.

    Each dispatch takes the finest rung whose B covers the alive count
    and runs R rounds with that rung's K: one while the rung is wider
    than N/8 (or it is the first dispatch), else
    `test_rounds_per_dispatch`, never past `max_samples` samples in all.
    A round takes the rays alive at its start (`nonzero`), so B only
    sets K. The JAX version's compile-readiness choice, blind rounds and
    one-round-stale counts serve its compiled programs and are not kept.
    """
    cfg = model.cfg
    if rcfg.test_layout != "bucket":
        raise NotImplementedError("the flat test layout is ROADMAP A13")
    if not uses_sv(cfg, rcfg):
        raise NotImplementedError(
            "test rounds without the supervoxel-run march are ROADMAP K13")
    N = rays_o.shape[0]
    dev = rays_o.device
    hits_t = near_intervals(cfg, rays_o, rays_d)
    t1, t2 = hits_t[:, 0].contiguous(), hits_t[:, 1].contiguous()
    state = {"cursor": t1.clone(), "alive": t1 >= 0,
             "opacity": torch.zeros(N, device=dev),
             "depth": torch.zeros(N, device=dev),
             "rend": torch.zeros((N, cfg.rend_channels), device=dev)}
    min_samples = max(1 if cfg.exp_step_factor == 0 else 4, rcfg.test_min_k)
    rungs = bucket_ladder(N, min_samples)
    total, rounds, samples, first = 0, 0, 0, True
    n_alive = int(state["alive"].sum())
    with torch.no_grad():
        while samples < cfg.max_samples and n_alive > 0:
            B, K = next((b, k) for b, k in rungs if b >= n_alive)
            R = 1 if (first or B > N // 8) else max(
                rcfg.test_rounds_per_dispatch, 1)
            R = min(R, max((cfg.max_samples - samples) // K, 1))
            for _ in range(R):
                total += int(_test_round(model, occ, rcfg, rays_o, rays_d,
                                         t2, state, K))
                rounds += 1
            samples += K * R
            first = False
            n_alive = int(state["alive"].sum())
    opacity = state["opacity"]
    results = {"opacity": opacity, "depth": state["depth"],
               "total_samples": total, "rounds": rounds}
    results.update(split_rend(cfg, state["rend"]))
    bg = bg_color(cfg, False, device=dev)
    results["rgb"] = results["rgb"] + bg[None, :] * (1.0 - opacity[:, None])
    return results
