"""Multi-task NeRF loss with Manhattan normal-clustering self-supervision —
port of the JAX package's `losses.py`, every component: rgb, opacity,
distortion (with `distortion_ts_bug_compat`), depth L2, the GT-normal L1
and dot terms, RegNeRF's depth smoothness on the random-pose rays, the
normal-clustering terms (ort / centr_dot / centr_L1, canonical-axis
snapping, `discard_far_members`), the Manhattan-SDF wall/floor terms with
the learned angle theta_WF, and semantic CE, each behind the same finite
guard, over triangle or patch batches, with or without random-pose rays.

The clustering init draw is separable: `kmeans_init` takes the K indices.

The scalars that change with the step (each clustering term's ramp, the
clustering window, whether the step is past `norm_can_start`) come from
`loss_schedule(step)` on the host, or as 0-dim tensors in `sched`: a row
of the trainer's step table, which a CUDA graph of the step reads at
every replay.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .config import LossConfig, ModelConfig
from .datasets.normals import extract_normals_from_ray_batch, normalize
from .datasets.sampler import PATCH_STRATEGIES, TRIANG_STRATEGIES
from .ops import loss_block as k10
from .ops.distortion import distortion_loss, distortion_loss_dense


def _masked_mean(x, mask, dim=None):
    m = mask.to(x.dtype)
    if dim is None:
        return torch.sum(x * m) / torch.clamp(torch.sum(m), min=1.0)
    return (torch.sum(x * m, dim=dim)
            / torch.clamp(torch.sum(m, dim=dim), min=1.0))


def _finite_or_zero(loss):
    """NaN/Inf guard (reference: losses.py:246-262)."""
    return torch.where(torch.isfinite(loss), loss, torch.zeros_like(loss))


def w_sched(w: float, step, start: float, grow: float) -> float:
    """Ramp a loss weight from 0 to w over `grow` steps after `start`."""
    return min(max((step - start) * (w / max(grow, 1e-12)), 0.0), w)


# the clustering terms, each with its weight's field of LossConfig: the
# three of the clusters, then the two of the canonical-axis snapping
CLUSTERING_TERMS = ("norm_D_C_ort_dot", "norm_D_C_centr_dot",
                    "norm_D_C_centr_L1", "norm_D_C_can_dot",
                    "norm_D_C_can_L1")


def loss_schedule(lcfg: LossConfig, step: int) -> Dict[str, float]:
    """The loss scalars of `step`: "w_<term>", each clustering term's
    ramped weight (`w_sched`); "in_window", 1.0 while the clustering
    window is open (losses.py:314) and 0.0 after it; "after_start", 1.0
    once the step is past `norm_can_start` (the gate of `reg_depth` and
    the switch of the Manhattan term, losses.py:303, :345)."""
    out = {f"w_{t}": w_sched(getattr(lcfg, f"{t}_w"), step,
                             lcfg.norm_can_start, lcfg.norm_can_grow)
           for t in CLUSTERING_TERMS}
    out["in_window"] = float(step <= lcfg.norm_can_end
                             or lcfg.norm_can_end == -1)
    out["after_start"] = float(step > lcfg.norm_can_start)
    return out


def _step_scalars(lcfg: LossConfig, step: int, device) -> Dict:
    """`loss_schedule(step)` as 0-dim f32 tensors on `device`."""
    return {k: torch.full((), v, device=device)
            for k, v in loss_schedule(lcfg, step).items()}


def triang_idx(seq_len: int) -> Dict[str, np.ndarray]:
    """x1/x2/x3 indices of flat triangle batches (losses.py:57-61)."""
    if seq_len % 3 != 0:
        raise ValueError(f"triangle batch length {seq_len} is not a "
                         "multiple of 3")
    pix = np.arange(seq_len, dtype=np.int64).reshape(-1, 3)
    return {"x1": pix[:, 0], "x2": pix[:, 1], "x3": pix[:, 2]}


@functools.lru_cache(maxsize=8)
def triang_idx_on(seq_len: int, device: torch.device) -> Dict:
    """`triang_idx(seq_len)` as tensors on `device`, built once per batch
    size and device (a copy from the host cannot be captured in a CUDA
    graph)."""
    return {k: torch.as_tensor(v, device=device)
            for k, v in triang_idx(seq_len).items()}


def patch_triang_idx(seq_len: int, patch_area: int,
                     offsets_local) -> Dict[str, np.ndarray]:
    """x1/x2/x3 indices of patch batches (losses.py:64-71): every
    triangle inside each patch of `patch_area` rays."""
    if seq_len % patch_area != 0:
        raise ValueError(f"patch batch length {seq_len} is not a multiple "
                         f"of the patch area {patch_area}")
    pix = np.arange(seq_len, dtype=np.int64).reshape(-1, patch_area)
    return {k: pix[:, np.asarray(offsets_local[k])].reshape(-1)
            for k in ("x1", "x2", "x3")}


@functools.lru_cache(maxsize=8)
def _patch_triang_idx_on(seq_len: int, patch_area: int, local: tuple,
                         device: torch.device) -> Dict:
    offsets = dict(zip(("x1", "x2", "x3"), local))
    return {k: torch.as_tensor(v, device=device)
            for k, v in patch_triang_idx(seq_len, patch_area,
                                         offsets).items()}


def patch_triang_idx_on(seq_len: int, patch_area: int, offsets_local,
                        device: torch.device) -> Dict:
    """`patch_triang_idx` as tensors on `device`, built once per batch
    size, patch and device (as `triang_idx_on`)."""
    local = tuple(tuple(int(i) for i in offsets_local[k])
                  for k in ("x1", "x2", "x3"))
    return _patch_triang_idx_on(seq_len, patch_area, local, device)


@functools.lru_cache(maxsize=8)
def _triang_table_on(seq_len: int, device: torch.device) -> torch.Tensor:
    idx = triang_idx(seq_len)
    return torch.as_tensor(k10.incidence_table_np(
        idx["x1"], idx["x2"], idx["x3"], seq_len), device=device)


@functools.lru_cache(maxsize=8)
def _patch_table_on(seq_len: int, patch_area: int, local: tuple,
                    device: torch.device) -> torch.Tensor:
    idx = patch_triang_idx(seq_len, patch_area,
                           dict(zip(("x1", "x2", "x3"), local)))
    return torch.as_tensor(k10.incidence_table_np(
        idx["x1"], idx["x2"], idx["x3"], seq_len), device=device)


def incidence_table_on(strategy: str, seq_len: int, patch_area,
                       offsets_local, device: torch.device) -> torch.Tensor:
    """K10's ray -> (triangle, vertex) table (`ops/loss_block.py:
    incidence_table_np`) of a triangle or patch batch of `seq_len` rays,
    built once per batch shape and device, from the host's indices."""
    if strategy in TRIANG_STRATEGIES:
        return _triang_table_on(seq_len, device)
    local = tuple(tuple(int(i) for i in offsets_local[k])
                  for k in ("x1", "x2", "x3"))
    return _patch_table_on(seq_len, patch_area, local, device)


@functools.lru_cache(maxsize=8)
def _const(values: tuple, device: torch.device) -> torch.Tensor:
    """A constant f32 tensor on `device`, made once (a copy from the host
    cannot be captured in a CUDA graph). Callers must not write to it."""
    return torch.tensor(values, dtype=torch.float32, device=device)


# the Manhattan-SDF wall/floor cross-entropy's class weights and label
# smoothing (losses.py:325-328): wall, floor, the rest
_WF_WEIGHT, _WF_SMOOTHING = (1.0, 1.0, 0.3), 0.1


def _cross_entropy(logits, labels_shifted, n_cls, weight=None,
                   label_smoothing=0.0):
    """CrossEntropyLoss(ignore_index=-1[, weight, label_smoothing]) on
    shifted labels, in the JAX package's formula (losses.py:74-91): with
    a weight, the denominator is the sum of w[label] over valid rows."""
    valid = labels_shifted >= 0
    lab = torch.clamp(labels_shifted, 0, n_cls - 1)
    logp = torch.log_softmax(logits, dim=-1)
    q = torch.nn.functional.one_hot(lab, n_cls).to(logp.dtype)
    if label_smoothing:
        q = q * (1.0 - label_smoothing) + label_smoothing / n_cls
    if weight is None:
        per = -torch.sum(q * logp, dim=-1)
        denom = valid.sum().to(per.dtype)
    else:
        per = -torch.sum(q * weight[None, :] * logp, dim=-1)
        denom = torch.sum(torch.where(valid, weight[lab],
                                      torch.zeros_like(per)))
    per = torch.where(valid, per, torch.zeros_like(per))
    return torch.sum(per) / torch.clamp(denom, min=1e-12)


def _cluster_terms(lcfg: LossConfig) -> tuple:
    """The clustering terms a configuration computes: the three of the
    clusters and, with a snapping weight, the two of the snapping."""
    snap = lcfg.norm_D_C_can_dot_w > 0 or lcfg.norm_D_C_can_L1_w > 0
    return CLUSTERING_TERMS if snap else CLUSTERING_TERMS[:3]


def _plan(lcfg: LossConfig, terms: tuple, *, n_sup=0, n_rays=0, unsup=0,
          n_tri=0, n_cls=0) -> k10.Plan:
    return k10.Plan(n_sup=n_sup, n_rays=n_rays, unsup=unsup, n_tri=n_tri,
                    n_cls=n_cls, terms=terms, w_op=lcfg.opacity_w,
                    w_dist=lcfg.distortion_w, w_sem=lcfg.sem_w,
                    tres=lcfg.norm_can_tres, K=lcfg.cluster_K,
                    niter=lcfg.cluster_niter,
                    discard=lcfg.discard_far_members)


def _weights(sched: Mapping) -> tuple:
    return tuple(sched[f"w_{t}"] for t in CLUSTERING_TERMS)


def _triangles(strategy: str, n: int, patch_area, offsets_local, dev):
    """x1/x2/x3 indices of `n` rays of a triangle or patch batch, or None
    for the pixel strategies."""
    if strategy in TRIANG_STRATEGIES:
        return triang_idx_on(n, dev)
    if strategy in PATCH_STRATEGIES:
        return patch_triang_idx_on(n, patch_area, offsets_local, dev)
    return None


def _wf_losses(lcfg: LossConfig, sem_pred, sem_tgt, nD, theta, after_start):
    """The Manhattan-SDF baseline (losses.py:319-352) on the supervised
    triangles: the weighted, smoothed wall/floor cross-entropy, and the
    floor (Eq. 8) and wall (Eq. 9) terms of the depth normals `nD`,
    weighted by the predicted class (Eq. 13) once `after_start`, else
    unweighted with the walls' vertical part only."""
    if sem_pred.shape[-1] != 3:
        raise ValueError("manhattan_nerf_w needs 3 semantic channels (wall, "
                         f"floor, the rest), got {sem_pred.shape[-1]}: the "
                         "JAX loss fails there too")
    soft = torch.softmax(sem_pred, dim=-1)
    wf_ce = _cross_entropy(sem_pred, sem_tgt - 1, 3,
                           weight=_const(_WF_WEIGHT, sem_pred.device),
                           label_smoothing=_WF_SMOOTHING)
    wall, floor = sem_tgt == 1, sem_tgt == 2
    any_wall, any_floor = wall.sum() > 0, floor.sum() > 0
    floor_term = 1.0 - nD[:, 2]
    cos = nD[:, 0] * torch.cos(theta) + nD[:, 1] * torch.sin(theta)
    wall_term = torch.abs(nD[:, 2]) + torch.minimum(
        torch.abs(cos), torch.minimum(torch.abs(1 - cos),
                                      torch.abs(1 + cos)))
    joint = (_masked_mean(soft[:, 1] * floor_term, floor) * any_floor
             + _masked_mean(soft[:, 0] * wall_term, wall) * any_wall)
    geo = (_masked_mean(floor_term, floor) * any_floor
           + _masked_mean(torch.abs(nD[:, 2]), wall) * any_wall)
    wf = torch.where(after_start > 0, joint, geo)
    norm_wf = torch.where(any_floor | any_wall, lcfg.manhattan_nerf_w * wf,
                          torch.zeros_like(wf))
    return (_finite_or_zero(lcfg.sem_w * wf_ce), _finite_or_zero(norm_wf))


def block_inputs(pred: Dict, target: Dict, lcfg: LossConfig,
                 mcfg: ModelConfig, *, ray_sampling_strategy: str,
                 random_tr_poses: bool, patch_area, offsets_local,
                 kmeans_init, generator, sched: Mapping):
    """K10's plan, inputs and differentiable inputs ({name: tensor}) for
    `compute_losses`' arguments: rgb always, opacity and distortion (of
    H4's per-ray output) with their weights, the clustering terms, sem
    without the Manhattan terms."""
    n = target["rgb"].shape[0]
    unsup = n if random_tr_poses else 0
    n_unsup = pred["rgb"].shape[0] - unsup
    dev = pred["depth"].device
    clustering_on = any(getattr(lcfg, f"{t}_w") > 0 for t in CLUSTERING_TERMS)
    x123 = _triangles(ray_sampling_strategy, n_unsup, patch_area,
                      offsets_local, dev) if clustering_on else None
    wf_on = lcfg.manhattan_nerf_w > 0
    # K10's terms: rgb, opacity, distortion, the clustering terms, sem
    sem_on = lcfg.sem_w > 0 and not wf_on
    terms = (("rgb",) + (("opacity",) if lcfg.opacity_w > 0 else ())
             + (("distortion",) if lcfg.distortion_w > 0 else ())
             + (_cluster_terms(lcfg) if clustering_on else ())
             + (("sem",) if sem_on else ()))
    dl = None
    if lcfg.distortion_w > 0:
        # distortion_ts_bug_compat feeds ts as the weights (losses.py:290
        # of the reference): the term then carries no gradient
        ws = pred["ts"] if lcfg.distortion_ts_bug_compat else pred["ws"]
        if ws.ndim == 2:
            # the dense (N, K) layout
            dl = distortion_loss_dense(ws, pred["deltas"], pred["ts"],
                                       pred["sample_valid"])
        else:
            # the flat layout's ray-major segments (losses.py:266-270)
            dl = distortion_loss(ws, pred["deltas"], pred["ts"],
                                 pred["ray_id"], pred["ray_start"],
                                 pred["sample_valid"], pred["rgb"].shape[0],
                                 ray_count=pred["ray_count"])
    labels = None
    if sem_on:
        labels = target["semantics"]
        if labels.dtype not in (torch.int32, torch.int64):
            labels = labels.to(torch.int64)
    plan = _plan(lcfg, terms, n_sup=n, n_rays=pred["rgb"].shape[0],
                 unsup=unsup,
                 n_tri=len(x123["x1"]) if clustering_on else 0,
                 n_cls=mcfg.n_sem_cls if sem_on else 0)
    inp = k10.Inputs(
        target["rgb"], labels,
        tuple(x123[k] for k in ("x1", "x2", "x3")) if clustering_on else None,
        incidence_table_on(ray_sampling_strategy, n_unsup, patch_area,
                           offsets_local, dev) if clustering_on else None,
        _weights(sched), sched["in_window"], kmeans_init, generator)
    # the depth and the rays only where the clustering reads them
    rays = ({k: pred[k] for k in ("depth", "rays_o", "rays_d")}
            if clustering_on else {})
    xs = dict(rgb=pred["rgb"], opacity=pred["opacity"], dl=dl,
              sem=pred.get("sem") if sem_on else None, **rays)
    return plan, inp, xs


def compute_losses(pred: Dict, target: Dict, lcfg: LossConfig,
                   mcfg: ModelConfig, *, step: int,
                   ray_sampling_strategy: str = "all_images",
                   random_tr_poses: bool = False,
                   patch_area: Optional[int] = None,
                   offsets_local: Optional[Dict] = None,
                   kmeans_init: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   sched: Optional[Mapping] = None,
                   theta_WF: Optional[torch.Tensor] = None,
                   stats: Optional[Dict] = None
                   ) -> Dict[str, torch.Tensor]:
    """All loss components + 'total' (reference: losses.py:244-587), in
    the JAX dict's order. The step's weights, clustering window and
    `norm_can_start` switch are `sched`'s (0-dim tensors, a row of the
    trainer's step table), else `loss_schedule(step)`'s. `theta_WF` is the
    Manhattan-SDF term's learned angle (0 when None).

    `target` holds "rgb" and the labels the configured terms read:
    "depth" (depth_w), "normals" or, under `norm_GT_depth`,
    "normals_depth" (the GT-normal terms), "semantics_WF"
    (manhattan_nerf_w), "semantics" (sem_w without manhattan_nerf_w).
    With `random_tr_poses` the rays past the target's rows come from
    random poses (losses.py:209-213): the supervised terms take the first
    rows, the clustering and `reg_depth` the rest. The patch strategies
    take every triangle of each patch (`patch_area`, `offsets_local`).

    K10 (`ops/loss_block.py`) computes rgb, opacity, distortion (of H4's
    per-ray output), the clustering terms and sem, with their gradient;
    the other terms are torch ops added to its total. With `stats` (a
    dict), its "mse" becomes the rgb mean before its guard (no
    gradient)."""
    loss_d: Dict[str, torch.Tensor] = {}
    n = target["rgb"].shape[0]
    unsup = n if random_tr_poses else 0
    n_unsup = pred["rgb"].shape[0] - unsup
    dev = pred["depth"].device
    if sched is None:
        sched = _step_scalars(lcfg, step, dev)
    x123_gt = _triangles(ray_sampling_strategy, n, patch_area,
                         offsets_local, dev)
    x123 = _triangles(ray_sampling_strategy, n_unsup, patch_area,
                      offsets_local, dev)
    clustering_on = any(getattr(lcfg, f"{t}_w") > 0 for t in CLUSTERING_TERMS)
    gt_normals_on = lcfg.norm_depth_L1_w > 0 or lcfg.norm_depth_dot_w > 0
    wf_on = lcfg.manhattan_nerf_w > 0
    if mcfg.pred_norm_depth and x123 is None:
        raise ValueError("pred_norm_depth requires a *_triang or "
                         "*_triang_patch ray_sampling_strategy, got "
                         f"{ray_sampling_strategy!r}")
    if (clustering_on or gt_normals_on or wf_on) and not mcfg.pred_norm_depth:
        raise ValueError("the clustering, GT-normal and Manhattan terms take "
                         "the depth normals: set pred_norm_depth")
    if lcfg.reg_depth_w > 0 and x123 is None:
        raise ValueError("reg_depth_w requires a *_triang or *_triang_patch "
                         f"ray_sampling_strategy, got "
                         f"{ray_sampling_strategy!r}")
    # the supervised rays' depth normals (the GT-normal and Manhattan
    # terms'); the clustering's are K10's own
    norm_depth_gt = None
    if gt_normals_on or wf_on:
        norm_depth_gt = extract_normals_from_ray_batch(
            pred["rays_o"][:n], pred["rays_d"][:n], pred["depth"][:n],
            x123_gt)

    plan, inp, xs = block_inputs(
        pred, target, lcfg, mcfg, ray_sampling_strategy=ray_sampling_strategy,
        random_tr_poses=random_tr_poses, patch_area=patch_area,
        offsets_local=offsets_local, kmeans_init=kmeans_init,
        generator=generator, sched=sched)
    block, total, mse = k10.loss_block(plan, inp, **xs)
    if stats is not None:
        stats["mse"] = mse

    for k in ("rgb", "opacity", "distortion"):
        if k in block:
            loss_d[k] = block[k]
    if lcfg.depth_w > 0:
        d_t = target["depth"]
        loss_d["depth"] = _finite_or_zero(lcfg.depth_w * _masked_mean(
            (pred["depth"][:n] - d_t) ** 2, d_t > 0))
    if gt_normals_on:
        gt = target["normals_depth" if lcfg.norm_GT_depth else "normals"]
        nom_tar = gt[x123_gt["x1"]]
        m = torch.sum(torch.abs(nom_tar), dim=-1) > 0
        if lcfg.norm_depth_L1_w > 0:
            loss_d["norm_D_L1"] = _finite_or_zero(
                lcfg.norm_depth_L1_w * _masked_mean(torch.sum(
                    torch.abs(norm_depth_gt - nom_tar), dim=-1), m))
        if lcfg.norm_depth_dot_w > 0:
            dot = torch.sum(normalize(norm_depth_gt) * normalize(nom_tar),
                            dim=-1)
            loss_d["norm_D_dot"] = _finite_or_zero(
                lcfg.norm_depth_dot_w * _masked_mean(1.0 - dot, m))
    if lcfg.reg_depth_w > 0:
        # RegNeRF's depth smoothness on the unsupervised rays
        # (losses.py:299-304), from the step after norm_can_start
        d_u = pred["depth"][unsup:]
        d1 = d_u[x123["x1"]]
        reg = (d1 - d_u[x123["x2"]]) ** 2 + (d1 - d_u[x123["x3"]]) ** 2
        gated = torch.where(sched["after_start"] > 0, torch.mean(reg),
                            torch.zeros((), device=dev))
        loss_d["reg_depth"] = _finite_or_zero(lcfg.reg_depth_w * gated)
    for k in CLUSTERING_TERMS:
        if k in block:
            loss_d[k] = block[k]
    if wf_on:
        x1 = x123_gt["x1"]
        theta = (theta_WF if theta_WF is not None
                 else torch.zeros((), device=dev))
        loss_d["sem_WF"], loss_d["norm_WF"] = _wf_losses(
            lcfg, pred["sem"][:n][x1],
            target["semantics_WF"][x1].to(torch.int64), norm_depth_gt, theta,
            sched["after_start"])
    if "sem" in block:
        loss_d["sem"] = block["sem"]
    # K10's total, then the other terms in the dict's order
    for k, v in loss_d.items():
        if k not in block:
            total = total + v
    loss_d["total"] = total
    return loss_d
