"""Train- and test-time rendering — port of the JAX package's
`models/rendering.py:render_train` (both march layouts) and
`render_test` (the bucket and the flat test layouts).

Training, dense layout: AABB intersect -> near clamp -> interval
annealing -> the bootstrap march (kernel H1) for the first
`bootstrap_steps` steps; after them the supervoxel-run march (K1) where
it applies, else the bitfield march over `march_block` steps (H9),
two-level through the coarse mask when `march_coarse` -> field on the
(N*K) samples (kernel H2/H5/H7 + MLPs) -> compositing (H3) -> random
background. Flat layout (the training oracle): the bitfield march
compacted into the sample budget (H9, H11) from step 0 -> field on the B
slots -> compositing of the ray-major segments (H3's segment launchers).
The random draws (march noise, background colour) are separable: pass
them as `noise` / `bg`, or a `generator` to draw them.

Test, bucket layout: rounds over the rays still alive, each marching
from the ray's cursor (sv rounds, K1, or a probe window of the bitfield,
H10) and composited (H3 with T_start) onto the ray's running result.
Flat layout: rounds of the full window (H10) compacted (H11) and
composited by segments with T_start, until no ray is alive.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import numpy as np
import torch

from ..config import RenderConfig
from ..datasets.normals import normalize
from ..ops.composite import composite_rays, composite_rays_compact
from ..ops.ray_aabb import ray_aabb_intersect
from ..ops.ray_march import (
    flat_cap, march_rays_test_round, march_rays_test_round_sv,
    march_rays_test_round_window, march_rays_train,
    march_rays_train_bootstrap, march_rays_train_dense,
    march_rays_train_dense_sv,
)


# the lower clip of each strategy's n_i (rendering.py:44-55): RegNeRF's
# ps = 0.5 for "avoid_near", 0.05 for "depth"
_ANNEAL_CLIP = {"avoid_near": (0.5, 1.0), "depth": (0.05, 100.0)}


def anneal_schedule(global_step: int, anneal_steps: int, strategy: str):
    """(n_i, on) of the interval annealing `strategy` at `global_step`
    (rendering.py:36-59): n_i = clip(step / anneal_steps, 0.5, 1) for
    'avoid_near' and clip(step / anneal_steps, 0.05, 100) for 'depth',
    with the step fraction in f32, as the JAX version computes it, and
    whether the annealing applies (step < anneal_steps)."""
    if anneal_steps <= 0 or global_step >= anneal_steps or strategy == "none":
        return 1.0, False
    if strategy not in _ANNEAL_CLIP:
        raise ValueError(f"anneal_strategy {strategy!r}")
    lo, hi = _ANNEAL_CLIP[strategy]
    frac = float(np.float32(global_step) / np.float32(anneal_steps))
    return min(max(frac, lo), hi), True


def anneal_hits(hits_t, global_step: int, strategy: str, anneal_steps: int,
                sched: Optional[Mapping] = None,
                depth_gt: Optional[torch.Tensor] = None):
    """Training ray-interval annealing (reference: rendering.py:168-188):
    'avoid_near' (RegNeRF, ps = 0.5) moves each ray's near end towards the
    middle of its interval; 'depth' (ps = 0.05) shrinks the interval
    towards the ray's GT depth `depth_gt` (N,), within the interval.
    `sched` may hold the step's "anneal_n_i" and "anneal_on" as 0-dim
    tensors (a row of the trainer's step table); the intervals are then
    selected on the device: with n_i = 1 the formula is not bit for bit
    the interval, so it is not relied on."""
    if anneal_steps <= 0 or strategy == "none":
        return hits_t
    if strategy not in _ANNEAL_CLIP:
        raise ValueError(f"anneal_strategy {strategy!r}")
    if strategy == "depth" and (depth_gt is None
                                or depth_gt.shape != hits_t.shape[:1]):
        # the JAX version broadcasts depth_gt against every ray and fails
        # the same way, e.g. under random_tr_poses, whose random-pose rays
        # have no GT depth
        raise ValueError(
            "the 'depth' annealing takes one GT depth a ray: "
            f"{hits_t.shape[0]} rays, depth_gt "
            f"{None if depth_gt is None else tuple(depth_gt.shape)}")
    if sched is None:
        n_i, on = anneal_schedule(global_step, anneal_steps, strategy)
        if not on:
            return hits_t
        n_i, on = torch.full((), n_i, device=hits_t.device), None
    else:
        n_i, on = sched["anneal_n_i"], sched["anneal_on"] > 0
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    if strategy == "avoid_near":
        mid = (t1 + t2) / 2.0
        out = torch.stack([mid + n_i * (t1 - mid), t2], dim=-1)
    else:
        out = torch.stack(
            [torch.maximum(depth_gt + n_i * (t1 - depth_gt), t1),
             torch.minimum(depth_gt + n_i * (t2 - depth_gt), t2)], dim=-1)
    return out if on is None else torch.where(on, out, hits_t)


def split_rend(cfg, rend) -> Dict[str, torch.Tensor]:
    """rend channels -> rgb / norm_nn / sem (reference: rendering.py:214-224);
    with `pred_norm_nn_norm` the composited normals are made unit length
    (zero-safe, with a NaN-free gradient at zero vectors)."""
    out = {"rgb": rend[..., :3]}
    i = 3
    if cfg.pred_norm_nn:
        norm = rend[..., i:i + 3]
        out["norm_nn"] = normalize(norm) if cfg.pred_norm_nn_norm else norm
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
                    global_step: int = 0, sched: Optional[Mapping] = None,
                    depth_gt: Optional[torch.Tensor] = None):
    """(N, 2) march interval of each training ray: the near-clamped box
    hit and the interval annealing (at `global_step`, or `sched`'s; the
    'depth' strategy towards `depth_gt`)."""
    hits_t = near_intervals(cfg, rays_o, rays_d)
    return anneal_hits(hits_t, global_step, rcfg.anneal_strategy,
                       rcfg.anneal_steps, sched, depth_gt).contiguous()


def uses_sv(cfg, rcfg: RenderConfig, occ) -> bool:
    """Whether the supervoxel-run march applies (rendering.py:163-165,
    621-623): the state holds its tables, one cascade, a uniform step
    grid, G a multiple of 8."""
    return (rcfg.march_coarse and occ.sv_mask is not None
            and cfg.cascades == 1 and cfg.exp_step_factor == 0.0
            and cfg.grid_size % 8 == 0)


def train_march_kind(cfg, rcfg: RenderConfig, occ, bootstrap: bool) -> str:
    """The training march (rendering.py:163-196, 248-249): "flat" (H9 at
    the per-ray cap and H11) for the flat layout, whatever `bootstrap`
    is, as the JAX flat branch ignores it; in the dense layout
    "bootstrap" (H1), "sv" (K1) or "fine" (H9, the bitfield march)."""
    if rcfg.march_layout == "flat":
        return "flat"
    if bootstrap:
        return "bootstrap"
    return "sv" if uses_sv(cfg, rcfg, occ) else "fine"


def train_march_args(cfg, rcfg: RenderConfig, n_rays: int, kind: str) -> Dict:
    """Keyword arguments of the training march `kind` for `n_rays` rays:
    K = budget // N samples with the stratified tail. The bootstrap march
    takes S_boot coarse steps of sqrt(3)/S_boot; the sv and the fine march
    take `march_block` steps of sqrt(3)/max_samples, the sv march over at
    most `sv_intervals` occupied supervoxel runs, the fine march with
    `coarse_k_blocks` (its `coarse_occ` comes from the state)."""
    budget = rcfg.sample_budget or n_rays * 32
    K = budget // n_rays
    tail_k = K if rcfg.march_tail_k < 0 else rcfg.march_tail_k
    if kind == "bootstrap":
        S_boot = min(rcfg.bootstrap_max_samples, cfg.max_samples)
        return dict(
            cascades=cfg.cascades, scale=cfg.scale,
            exp_step_factor=cfg.exp_step_factor, grid_size=cfg.grid_size,
            max_samples=S_boot, samples_per_ray=K, march_steps=S_boot,
            tail_k=tail_k)
    if kind == "sv":
        return dict(scale=cfg.scale, grid_size=cfg.grid_size,
                    max_samples=cfg.max_samples, samples_per_ray=K,
                    march_steps=rcfg.march_block,
                    n_intervals=rcfg.sv_intervals, tail_k=tail_k)
    return dict(cascades=cfg.cascades, scale=cfg.scale,
                exp_step_factor=cfg.exp_step_factor, grid_size=cfg.grid_size,
                max_samples=cfg.max_samples, samples_per_ray=K,
                march_steps=rcfg.march_block,
                coarse_k_blocks=rcfg.coarse_k_blocks, tail_k=tail_k)


def march_t(t, valid, hits_t, ray_id=None):
    """The march's sample distances `t` ((N, K), or (B,) slots of the rays
    `ray_id`) with the gradient JAX's autodiff gives them when the rays
    carry one (extrinsic optimisation): its marches compute t_k = t1 +
    lo*noise + k*lo where valid, 0 elsewhere, in closed form, with t1 the
    near end of the annealed box interval `hits_t`, so d t_k / d t1 =
    valid. The port's marches return t without a gradient; this adds
    valid * (t1 - t1.detach()), zero in value. JAX stops the gradient of t
    only where it builds the sample positions; t reaches the compositing
    (depth) and the losses with it. The term vanishes when the camera is
    inside the box (t1 clamped to 0 or near_dist); without a gradient on
    the rays `t` is returned as it is."""
    if not hits_t.requires_grad:
        return t
    t1 = hits_t[:, 0]
    shift = t1 - t1.detach()
    shift = shift[:, None] if ray_id is None else shift[ray_id.to(torch.int64)]
    return t + torch.where(valid, shift, torch.zeros_like(shift))


def _finish(cfg, rcfg, results, comp, bg, generator, dev):
    results.update(split_rend(cfg, comp["rend"]))
    if bg is None:
        bg = bg_color(cfg, rcfg.random_bg, generator, dev)
    results["rgb"] = results["rgb"] + bg[None, :] * (1.0 - comp["opacity"][:, None])
    return results


def render_train(model, occ, rays_o, rays_d, rcfg: RenderConfig, *,
                 global_step: int = 0, bootstrap: bool = False,
                 noise: Optional[torch.Tensor] = None,
                 bg: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 sched: Optional[Mapping] = None,
                 depth_gt: Optional[torch.Tensor] = None) -> Dict:
    """Render N rays; returns the keys of the JAX `render_train`'s branch
    of `rcfg.march_layout`. `occ` is the `OccupancyState`: the bootstrap
    and the fine march read its bitfield (the two-level march also its
    `coarse_occ`), the sv march its `sv_mask` and `sv_payload` (a state
    whose `sv_mask` is None has no sv march, as a JAX call without it).
    The flat layout marches the bitfield from step 0 (no bootstrap), as
    the JAX flat branch does, into a budget of `sample_budget` slots.
    `sched` may hold the step's annealing scalars, and `depth_gt` the
    rays' GT depth, which the 'depth' annealing takes (see
    `anneal_hits`)."""
    cfg = model.cfg
    N = rays_o.shape[0]
    dev = rays_o.device
    hits_t = train_intervals(cfg, rcfg, rays_o, rays_d, global_step, sched,
                             depth_gt)
    if noise is None:
        noise = torch.rand(N, generator=generator, device=dev)
    noise = noise * rcfg.march_noise
    if rcfg.march_layout == "flat":
        return _render_train_flat(model, occ, rays_o, rays_d, rcfg, hits_t,
                                  noise, bg, generator)
    if rcfg.march_layout != "dense":
        raise ValueError(f"march_layout {rcfg.march_layout!r}")
    kind = train_march_kind(cfg, rcfg, occ, bootstrap)
    kw = train_march_args(cfg, rcfg, N, kind)
    # the march sees no gradient (its plain versions would carry one)
    geo = (rays_o.detach(), rays_d.detach(), hits_t.detach())
    if kind == "bootstrap":
        mr = march_rays_train_bootstrap(*geo, occ.density_bitfield, noise,
                                        **kw)
    elif kind == "sv":
        mr = march_rays_train_dense_sv(*geo, occ.sv_mask, occ.sv_payload,
                                       noise, **kw)
    else:
        mr = march_rays_train_dense(
            *geo, occ.density_bitfield, noise,
            coarse_occ=occ.coarse_occ if rcfg.march_coarse else None, **kw)
    K = mr.t.shape[1]
    # t is a constant of the positions (JAX's stop_gradient there); the
    # compositing and the losses take it with its gradient (`march_t`)
    xyz = (rays_o[:, None, :] + mr.t[..., None] * rays_d[:, None, :])
    t = march_t(mr.t, mr.valid, hits_t)
    dirs = rays_d[:, None, :].expand(N, K, 3)
    sigmas, raws = field_raws(model, xyz.reshape(N * K, 3),
                              dirs.reshape(N * K, 3))
    comp = composite_rays(sigmas.reshape(N, K), raws.reshape(N, K, -1),
                          mr.dt, t, mr.valid, rcfg.T_threshold)
    results = {
        "opacity": comp["opacity"],
        "depth": comp["depth"],
        "ws": comp["ws"],
        "deltas": mr.dt,
        "ts": t,
        "ray_count": mr.ray_count,
        "sample_valid": mr.valid,
        "rm_samples": mr.rm_samples,
        "trunc_rays": mr.trunc_rays,
        "vr_samples": comp["vr_samples"].sum(),
        "rays_o": rays_o,
        "rays_d": rays_d,
    }
    return _finish(cfg, rcfg, results, comp, bg, generator, dev)


def _render_train_flat(model, occ, rays_o, rays_d, rcfg, hits_t, noise, bg,
                       generator):
    """The flat branch (rendering.py:233-277): ws, deltas, ts and
    sample_valid are (B,) slots, with `ray_id`, `ray_start` and
    `ray_count` for the losses; trunc_rays 0 (the march is exact)."""
    cfg = model.cfg
    N, dev = rays_o.shape[0], rays_o.device
    budget = rcfg.sample_budget or N * 32
    kw = train_march_args(cfg, rcfg, N, "fine")
    mr = march_rays_train(
        rays_o.detach(), rays_d.detach(), hits_t.detach(),
        occ.density_bitfield, noise, cascades=cfg.cascades, scale=cfg.scale,
        exp_step_factor=cfg.exp_step_factor, grid_size=cfg.grid_size,
        max_samples=cfg.max_samples, sample_budget=budget,
        march_steps=rcfg.march_block, per_ray_cap=kw["samples_per_ray"],
        tail_k=kw["tail_k"])
    rid = mr.ray_id.to(torch.int64)
    xyz = rays_o[rid] + mr.t[:, None] * rays_d[rid]
    t = march_t(mr.t, mr.valid, hits_t, rid)
    sigmas, raws = field_raws(model, xyz, rays_d[rid])
    # no segment is longer than the march's cap: the backward's bound,
    # known on the host, so that the step reads no count from the card
    comp = composite_rays_compact(
        sigmas, raws, mr.dt, t, mr.ray_id, mr.ray_start, mr.valid, N,
        rcfg.T_threshold, ray_count=mr.ray_count,
        max_len=flat_cap(cfg.max_samples, kw["samples_per_ray"]))
    results = {
        "opacity": comp["opacity"],
        "depth": comp["depth"],
        "ws": comp["ws"],
        "deltas": mr.dt,
        "ts": t,
        "ray_id": mr.ray_id,
        "ray_start": mr.ray_start,
        "ray_count": mr.ray_count,
        "sample_valid": mr.valid,
        "rm_samples": mr.rm_samples,
        "trunc_rays": torch.zeros((), dtype=torch.int32, device=dev),
        "vr_samples": comp["vr_samples"].sum(),
        "rays_o": rays_o,
        "rays_d": rays_d,
    }
    return _finish(cfg, rcfg, results, comp, bg, generator, dev)


# ---------------------------------------------------------------- test time
def bucket_ladder(N: int, min_samples: int, S_march: Optional[int] = None):
    """Every (B, K) rung of the bucket renderer for N rays
    (rendering.py:441-456): B from 256 doubling while below N, then N; K
    the reference's adaptive N // B capped at 64 and floored at
    min_samples, doubled for the full-width rung, and clamped to the probe
    window `S_march` for rounds without the sv march (None: sv rounds)."""
    ladder, b = [], 256
    while b < N:
        ladder.append(b)
        b *= 2
    ladder.append(N)
    out = []
    for B in ladder:
        K = max(min(N // B, 64), min_samples)
        if B == N:
            K = min(2 * K, 64)
        out.append((B, K if S_march is None else min(K, S_march)))
    return out


def _test_round(model, occ, rcfg: RenderConfig, rays_o, rays_d, t2,
                state: Dict, K: int, use_sv: bool):
    """One round over the alive rays (rendering.py:312-381): the sv test
    march from each cursor, or the first K occupied steps of a
    `test_march_window`-step probe window of the bitfield, the field on
    the n_alive * K samples and the composite continued from each ray's
    opacity. Updates `state` in place; returns the round's valid samples
    (a tensor, or 0)."""
    cfg = model.cfg
    cursor, alive, opacity, depth, rend = (
        state[k] for k in ("cursor", "alive", "opacity", "depth", "rend"))
    idx = torch.nonzero(alive).reshape(-1)
    n = idx.numel()
    if n == 0:
        return 0
    ro, rd, far = rays_o[idx], rays_d[idx], t2[idx]
    sel = torch.ones_like(far, dtype=torch.bool)
    if use_sv:
        t_k, dt_k, valid, new_cur = march_rays_test_round_sv(
            ro, rd, cursor[idx], far, sel, occ.sv_mask, occ.sv_payload,
            scale=cfg.scale, grid_size=cfg.grid_size,
            max_samples=cfg.max_samples, n_steps=K,
            n_intervals=rcfg.test_sv_intervals)
    else:
        t_k, dt_k, valid, new_cur = march_rays_test_round_window(
            ro, rd, cursor[idx], far, sel, occ.density_bitfield,
            cascades=cfg.cascades, scale=cfg.scale,
            exp_step_factor=cfg.exp_step_factor, grid_size=cfg.grid_size,
            max_samples=cfg.max_samples, S_march=rcfg.test_march_window,
            n_steps=K)
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


def _flat_round(model, occ, rcfg: RenderConfig, rays_o, rays_d, t2,
                state: Dict):
    """One flat round (rendering.py:503-527): the full window of
    `test_n_samples` steps from every cursor compacted into N *
    test_n_samples slots, the field on all of them, the segments
    composited from each ray's opacity. Updates `state` in place; returns
    the round's kept samples (a tensor)."""
    cfg = model.cfg
    N = rays_o.shape[0]
    n_steps = rcfg.test_n_samples
    mres, new_cursor = march_rays_test_round(
        rays_o, rays_d, state["cursor"], t2, state["alive"],
        occ.density_bitfield, cascades=cfg.cascades, scale=cfg.scale,
        exp_step_factor=cfg.exp_step_factor, grid_size=cfg.grid_size,
        max_samples=cfg.max_samples, n_steps=n_steps,
        sample_budget=N * n_steps)
    rid = mres.ray_id.to(torch.int64)
    xyz = rays_o[rid] + mres.t[:, None] * rays_d[rid]
    sigmas, raws = field_raws(model, xyz, rays_d[rid])
    comp = composite_rays_compact(
        sigmas, raws, mres.dt, mres.t, mres.ray_id, mres.ray_start,
        mres.valid, N, rcfg.T_threshold, T_start=1.0 - state["opacity"],
        ray_count=mres.ray_count)
    state["opacity"] += comp["opacity"]
    state["depth"] += comp["depth"]
    state["rend"] += comp["rend"]
    state["cursor"] = new_cursor
    converged = (1.0 - state["opacity"]) <= rcfg.T_threshold
    state["alive"] = state["alive"] & ~converged & ~(new_cursor >= t2)
    return mres.ray_count.sum()


def render_test(model, occ, rays_o, rays_d, rcfg: RenderConfig) -> Dict:
    """Inference render of N rays (rendering.py:573-768). Returns opacity
    (N,), depth (N,), rgb (N, 3) [+ norm_nn, sem], total_samples (the
    samples of every round, an int) and rounds.

    Bucket layout: each dispatch takes the finest rung whose B covers the
    alive count and runs R rounds with that rung's K: one while the rung
    is wider than N/8 (or it is the first dispatch), else
    `test_rounds_per_dispatch`, never past `max_samples` samples in all.
    A round takes the rays alive at its start (`nonzero`), so B only
    sets K. The JAX version's compile-readiness choice, blind rounds and
    one-round-stale counts serve its compiled programs and are not kept.
    Flat layout: rounds of `test_n_samples` steps over every ray until no
    ray is alive or `max_samples` steps are marched.
    """
    cfg = model.cfg
    N = rays_o.shape[0]
    dev = rays_o.device
    hits_t = near_intervals(cfg, rays_o, rays_d)
    t1, t2 = hits_t[:, 0].contiguous(), hits_t[:, 1].contiguous()
    state = {"cursor": t1.clone(), "alive": t1 >= 0,
             "opacity": torch.zeros(N, device=dev),
             "depth": torch.zeros(N, device=dev),
             "rend": torch.zeros((N, cfg.rend_channels), device=dev)}
    total, rounds, samples = 0, 0, 0
    with torch.no_grad():
        if rcfg.test_layout == "flat":
            while samples < cfg.max_samples:
                total += int(_flat_round(model, occ, rcfg, rays_o, rays_d,
                                         t2, state))
                rounds += 1
                samples += rcfg.test_n_samples
                if not bool(state["alive"].any()):
                    break
        elif rcfg.test_layout == "bucket":
            use_sv = uses_sv(cfg, rcfg, occ)
            min_samples = max(1 if cfg.exp_step_factor == 0 else 4,
                              rcfg.test_min_k)
            rungs = bucket_ladder(
                N, min_samples, None if use_sv else rcfg.test_march_window)
            first = True
            n_alive = int(state["alive"].sum())
            while samples < cfg.max_samples and n_alive > 0:
                B, K = next((b, k) for b, k in rungs if b >= n_alive)
                R = 1 if (first or B > N // 8) else max(
                    rcfg.test_rounds_per_dispatch, 1)
                R = min(R, max((cfg.max_samples - samples) // K, 1))
                for _ in range(R):
                    total += int(_test_round(model, occ, rcfg, rays_o,
                                             rays_d, t2, state, K, use_sv))
                    rounds += 1
                samples += K * R
                first = False
                n_alive = int(state["alive"].sum())
        else:
            raise ValueError(f"test_layout {rcfg.test_layout!r}")
    opacity = state["opacity"]
    results = {"opacity": opacity, "depth": state["depth"],
               "total_samples": total, "rounds": rounds}
    results.update(split_rend(cfg, state["rend"]))
    bg = bg_color(cfg, False, device=dev)
    results["rgb"] = results["rgb"] + bg[None, :] * (1.0 - opacity[:, None])
    return results
