"""Multi-task NeRF loss with Manhattan normal-clustering self-supervision —
port of the JAX package's `losses.py` for the components the bench
configuration switches on: rgb, opacity, distortion, the three
normal-clustering terms (ort / centr_dot / centr_L1) and semantic CE,
each behind the same finite guard. Other components raise
NotImplementedError (ROADMAP A9).

The clustering init draw is separable: `kmeans_init` takes the K indices.

The weights that change with the step (each clustering term's ramp,
the clustering window) come from `loss_schedule(step)` on the host, or as
0-dim tensors in `sched`: a row of the trainer's step table, which a
CUDA graph of the step reads at every replay.
"""
from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from .config import LossConfig, ModelConfig
from .datasets.normals import extract_normals_from_ray_batch, normalize
from .datasets.sampler import TRIANG_STRATEGIES
from .ops.distortion import distortion_loss, distortion_loss_dense
from .ops.kmeans import normals_clustering


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


# the clustering terms, each with its weight's field of LossConfig
CLUSTERING_TERMS = ("norm_D_C_ort_dot", "norm_D_C_centr_dot",
                    "norm_D_C_centr_L1")


def loss_schedule(lcfg: LossConfig, step: int) -> Dict[str, float]:
    """The loss scalars of `step`: "w_<term>", each clustering term's
    ramped weight (`w_sched`), and "in_window", 1.0 while the clustering
    window is open (losses.py:314) and 0.0 after it."""
    out = {f"w_{t}": w_sched(getattr(lcfg, f"{t}_w"), step,
                             lcfg.norm_can_start, lcfg.norm_can_grow)
           for t in CLUSTERING_TERMS}
    out["in_window"] = float(step <= lcfg.norm_can_end
                             or lcfg.norm_can_end == -1)
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


def _cross_entropy(logits, labels_shifted, n_cls):
    """CrossEntropyLoss(ignore_index=-1) on shifted labels."""
    valid = labels_shifted >= 0
    lab = torch.clamp(labels_shifted, 0, n_cls - 1)
    logp = torch.log_softmax(logits, dim=-1)
    onehot = torch.nn.functional.one_hot(lab, n_cls).to(logp.dtype)
    per = -torch.sum(onehot * logp, dim=-1)
    per = torch.where(valid, per, torch.zeros_like(per))
    return torch.sum(per) / torch.clamp(valid.sum().to(per.dtype), min=1e-12)


def clustering_losses(norm_D_C, lcfg: LossConfig, step: int, *,
                      kmeans_init: Optional[torch.Tensor] = None,
                      generator: Optional[torch.Generator] = None,
                      sched: Optional[Mapping] = None):
    """The paper's contribution (reference: losses.py:419-509): cluster
    the depth normals, then pull the three selected clusters to be
    orthogonal and tight. The weights are `sched`'s "w_<term>" (0-dim
    tensors), else `loss_schedule(step)`'s."""
    if (lcfg.norm_D_C_can_dot_w > 0 or lcfg.norm_D_C_can_L1_w > 0
            or lcfg.discard_far_members):
        raise NotImplementedError(
            "canonical-axis snapping and member discard are not ported "
            "(ROADMAP A9)")
    tres = lcfg.norm_can_tres
    finite = torch.all(torch.isfinite(norm_D_C), dim=-1)
    nonzero = torch.sum(torch.abs(norm_D_C), dim=-1) != 0.0
    valid = finite & nonzero
    normals = torch.where(valid[:, None], norm_D_C,
                          torch.zeros_like(norm_D_C))
    clus = normals_clustering(
        normals.detach(), valid, K=lcfg.cluster_K, niter=lcfg.cluster_niter,
        t_similar=1.0 - tres, init_idx=kmeans_init, generator=generator)
    assign = clus.assign_new
    normals = torch.where((assign < 0)[:, None], -normals, normals)
    assign = assign.abs()
    member = [assign == g + 1 for g in range(3)]
    counts = [m.sum() for m in member]
    cs = []
    for g in range(3):
        mean = _masked_mean(normals, member[g][:, None], dim=0)
        cs.append(normalize(mean[None, :])[0])
    c1, c2, c3 = cs
    loss_ort = (torch.abs(torch.sum(c1 * c2)) + torch.abs(torch.sum(c1 * c3))
                + torch.abs(torch.sum(c2 * c3))) / 3.0
    loss_centr_dot = sum(
        1.0 - _masked_mean(torch.sum(normals * cs[g][None, :], dim=-1),
                           member[g])
        for g in range(3)) / 3.0
    loss_centr_l1 = sum(
        _masked_mean(torch.sum(torch.abs(normals - cs[g][None, :]), dim=-1),
                     member[g])
        for g in range(3)) / 3.0
    ok = (counts[0] > 0) & (counts[1] > 0) & (counts[2] > 0)
    zero = torch.zeros((), dtype=normals.dtype, device=normals.device)
    if sched is None:
        sched = _step_scalars(lcfg, step, normals.device)
    out = {}
    for name, val in zip(CLUSTERING_TERMS,
                         (loss_ort, loss_centr_dot, loss_centr_l1)):
        out[name] = _finite_or_zero(torch.where(ok, sched[f"w_{name}"] * val,
                                                zero))
    return out


def compute_losses(pred: Dict, target: Dict, lcfg: LossConfig,
                   mcfg: ModelConfig, *, step: int,
                   ray_sampling_strategy: str = "all_images",
                   kmeans_init: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None,
                   sched: Optional[Mapping] = None
                   ) -> Dict[str, torch.Tensor]:
    """All loss components + 'total' (reference: losses.py:244-587). The
    step's weights and clustering window are `sched`'s (0-dim tensors, a
    row of the trainer's step table), else `loss_schedule(step)`'s."""
    unported = {"depth_w": lcfg.depth_w, "norm_depth_dot_w":
                lcfg.norm_depth_dot_w, "norm_depth_L1_w": lcfg.norm_depth_L1_w,
                "reg_depth_w": lcfg.reg_depth_w,
                "manhattan_nerf_w": lcfg.manhattan_nerf_w}
    on = [k for k, v in unported.items() if v > 0]
    if on or lcfg.distortion_ts_bug_compat:
        raise NotImplementedError(
            f"loss components {on or ['distortion_ts_bug_compat']} are not "
            "ported (ROADMAP A9)")
    loss_d: Dict[str, torch.Tensor] = {}
    n = target["rgb"].shape[0]
    x123 = None
    if ray_sampling_strategy in TRIANG_STRATEGIES:
        x123 = triang_idx_on(n, pred["depth"].device)
    norm_depth = None
    if mcfg.pred_norm_depth:
        if x123 is None:
            raise ValueError("pred_norm_depth requires a *_triang "
                             f"ray_sampling_strategy, got "
                             f"{ray_sampling_strategy!r}")
        # the JAX version extracts the supervised and the unsupervised
        # normals separately; without random poses both are these
        norm_depth = extract_normals_from_ray_batch(
            pred["rays_o"], pred["rays_d"], pred["depth"], x123)

    loss_d["rgb"] = _finite_or_zero(
        torch.mean((pred["rgb"][:n] - target["rgb"]) ** 2))
    if lcfg.opacity_w > 0:
        o = pred["opacity"] + 1e-10
        loss_d["opacity"] = _finite_or_zero(
            lcfg.opacity_w * torch.mean(-o * torch.log(o)))
    if lcfg.distortion_w > 0:
        if pred["ws"].ndim == 2:
            # the dense (N, K) layout
            dl = distortion_loss_dense(pred["ws"], pred["deltas"],
                                       pred["ts"], pred["sample_valid"])
        else:
            # the flat layout's ray-major segments (losses.py:266-270)
            dl = distortion_loss(pred["ws"], pred["deltas"], pred["ts"],
                                 pred["ray_id"], pred["ray_start"],
                                 pred["sample_valid"], pred["rgb"].shape[0],
                                 ray_count=pred["ray_count"])
        loss_d["distortion"] = _finite_or_zero(
            lcfg.distortion_w * torch.mean(dl))
    clustering_on = (lcfg.norm_D_C_ort_dot_w > 0
                     or lcfg.norm_D_C_centr_dot_w > 0
                     or lcfg.norm_D_C_centr_L1_w > 0
                     or lcfg.norm_D_C_can_dot_w > 0
                     or lcfg.norm_D_C_can_L1_w > 0)
    if clustering_on:
        if sched is None:
            sched = _step_scalars(lcfg, step, norm_depth.device)
        cl = clustering_losses(norm_depth, lcfg, step,
                               kmeans_init=kmeans_init, generator=generator,
                               sched=sched)
        in_window = sched["in_window"] > 0
        for k, v in cl.items():
            loss_d[k] = torch.where(in_window, v, torch.zeros_like(v))
    if lcfg.sem_w > 0:
        loss_d["sem"] = _finite_or_zero(lcfg.sem_w * _cross_entropy(
            pred["sem"][:n], target["semantics"].to(torch.int64) - 1,
            mcfg.n_sem_cls))
    loss_d["total"] = sum(loss_d.values())
    return loss_d
