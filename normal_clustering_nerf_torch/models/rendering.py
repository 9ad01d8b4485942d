"""Differentiable train-time rendering of a ray batch — port of the dense
branch of the JAX package's `models/rendering.py:render_train` for the
coarse-step bootstrap march (bootstrap=True).

AABB intersect -> near clamp -> interval annealing -> bootstrap march
(kernel H1) -> field on the (N*K) samples (kernel H2 + MLPs) ->
compositing (kernel H3) -> random background.

The random draws (march noise, background colour) are separable: pass
them as `noise` / `bg`, or a `generator` to draw them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..ops.composite import composite_rays
from ..ops.ray_aabb import ray_aabb_intersect
from ..ops.ray_march import march_rays_train_dense


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


def train_intervals(cfg, rcfg: RenderConfig, rays_o, rays_d,
                    global_step: int = 0):
    """(N, 2) march interval of each training ray: the scene-box hit,
    the near-distance clamp and the interval annealing."""
    dev = rays_o.device
    hits_t = ray_aabb_intersect(
        rays_o, rays_d, torch.zeros(3, device=dev),
        torch.full((3,), cfg.scale, device=dev))
    t1 = hits_t[:, 0]
    t1 = torch.where((t1 >= 0) & (t1 < cfg.near_dist),
                     torch.full_like(t1, cfg.near_dist), t1)
    hits_t = torch.stack([t1, hits_t[:, 1]], dim=-1)
    return anneal_hits(hits_t, global_step, rcfg.anneal_strategy,
                       rcfg.anneal_steps).contiguous()


def bootstrap_march_args(cfg, rcfg: RenderConfig, n_rays: int) -> Dict:
    """Keyword arguments of the bootstrap march for `n_rays` rays: K =
    budget // N samples with the stratified tail, over S_boot coarse
    steps of sqrt(3)/S_boot."""
    budget = rcfg.sample_budget or n_rays * 32
    K = budget // n_rays
    S_boot = min(rcfg.bootstrap_max_samples, cfg.max_samples)
    return dict(
        cascades=cfg.cascades, scale=cfg.scale,
        exp_step_factor=cfg.exp_step_factor, grid_size=cfg.grid_size,
        max_samples=S_boot, samples_per_ray=K, march_steps=S_boot,
        tail_k=K if rcfg.march_tail_k < 0 else rcfg.march_tail_k)


def render_train(model, bitfield, rays_o, rays_d, rcfg: RenderConfig, *,
                 global_step: int = 0, bootstrap: bool = False,
                 noise: Optional[torch.Tensor] = None,
                 bg: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Dict:
    """Render N rays with K = budget // N samples each; returns the same
    keys as the JAX `render_train` dense branch."""
    if not bootstrap:
        raise NotImplementedError(
            "only the bootstrap march (bootstrap=True) is ported: the "
            "supervoxel-run march after bootstrap_steps is ROADMAP K1/A4")
    if rcfg.march_layout != "dense":
        raise NotImplementedError("the flat march layout is ROADMAP A13")
    cfg = model.cfg
    N = rays_o.shape[0]
    dev = rays_o.device
    hits_t = train_intervals(cfg, rcfg, rays_o, rays_d, global_step)
    if noise is None:
        noise = torch.rand(N, generator=generator, device=dev)
    noise = noise * rcfg.march_noise
    mr = march_rays_train_dense(rays_o, rays_d, hits_t, bitfield, noise,
                                **bootstrap_march_args(cfg, rcfg, N))
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
