"""Training loop and validation of the port — the JAX package's
`training/trainer.py` for one device, as plain eager steps.

One step: sample a triangle batch -> assemble rays -> render (the
bootstrap march before `render.bootstrap_steps`, the supervoxel-run march
after; triplane field, compositing) -> multi-task loss -> gradients ->
optax-equivalent clipped AdamW. `fit` refreshes the occupancy grid every
`update_interval` steps (every cell before `warmup_steps`). `validate`
renders the held-out views (`render_images`), computes the metric suite
and recovers the Manhattan rotation. The JAX version's lax.scan
chunking, shard_map, host sampler, render prewarming and the
visualisation / prediction exports are not ported.

Random draws come from one `torch.Generator` seeded with `cfg.seed`; each
step's draws can be handed in instead (`train_step_core(draws=...)`).
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..datasets.base import SceneData
from ..datasets.normals import extract_normals_from_depth_batch
from ..datasets.ray_utils import get_rays
from ..datasets.sampler import RaySampler
from ..device import resolve_device
from ..losses import compute_losses
from ..metrics import NeRFMTMetricsPerIm
from ..models.ngp_mt import NGPMT
from ..models.occupancy import OccupancyGrid, OccupancyState
from ..models.rendering import render_test, render_train
from ..utils.rotations import euler_angles_to_matrix
from .rotation_recovery import rotation_recovery_errors
from .state import AdamW

_LABELS = ("semantics",)


class Trainer:
    def __init__(self, cfg: TrainConfig, scene_train: SceneData,
                 scene_test: Optional[SceneData] = None, device=None):
        self.device = dev = resolve_device(device)
        if scene_train.n_classes:
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, n_sem_cls=scene_train.n_classes))
        if cfg.render.bootstrap_steps % cfg.optim.update_interval != 0:
            raise ValueError("render.bootstrap_steps must be a multiple of "
                             "optim.update_interval")
        unported = [k for k, on in (
            ("optimize_ext", cfg.optim.optimize_ext),
            ("lr_dR_norm_glob", cfg.optim.lr_dR_norm_glob > 0),
            ("random_tr_poses", cfg.data.random_tr_poses),
            ("keep_N_tr", cfg.data.keep_N_tr != -1),
            ("host_sampler", cfg.data.host_sampler)) if on]
        if unported:
            raise NotImplementedError(f"{unported} not ported (ROADMAP A10)")
        self.cfg = cfg
        self.scene_train = scene_train
        self.scene_test = scene_test
        self.generator = torch.Generator(device=dev).manual_seed(cfg.seed)
        init_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        self.model = NGPMT(cfg.model, dev, generator=init_gen)
        self.occ_grid = OccupancyGrid(cfg.model, dev)
        self.sampler = RaySampler(
            cfg.data.ray_sampling_strategy, cfg.data.batch_size,
            scene_train.img_wh, scene_train.n_images,
            max_expand=cfg.data.triang_max_expand, device=dev)
        self.scene = {
            "poses": torch.as_tensor(scene_train.poses, dtype=torch.float32,
                                     device=dev),
            "directions": torch.as_tensor(scene_train.directions,
                                          dtype=torch.float32, device=dev),
            "rays": torch.as_tensor(scene_train.rays, dtype=torch.float32,
                                    device=dev),
        }
        for k in _LABELS:
            if k in scene_train.labels:
                self.scene[f"label_{k}"] = torch.as_tensor(
                    scene_train.labels[k], device=dev)
        self.params = dict(self.model.named_parameters())
        self.opt = AdamW(self.params, cfg.optim)
        self.occ: OccupancyState = self.occ_grid.init_state()
        self.step = 0
        self.last_grads: Dict[str, torch.Tensor] = {}
        self.R_offset = self._build_R_offset()

    def _build_R_offset(self) -> np.ndarray:
        """Scene rotation offset from the ZYX euler angles of the loss
        config (reference: train_nerf.py:109-122)."""
        lc = self.cfg.loss
        ang = np.array([lc.norm_yaw_offset_ang, lc.norm_pitch_offset_ang,
                        lc.norm_roll_offset_ang]) * math.pi / 180.0
        if np.all(ang == 0):
            return np.eye(3, dtype=np.float32)
        return euler_angles_to_matrix(ang, "ZYX").astype(np.float32)

    def load_state(self, params: Dict[str, torch.Tensor],
                   occ: OccupancyState, opt_state: Optional[Dict] = None,
                   step: int = 0):
        """Take over parameters, occupancy and optimizer state (e.g. from
        `convert.convert_jax_state`)."""
        with torch.no_grad():
            for n, p in self.params.items():
                p.copy_(params[n])
        self.occ = occ
        self.opt.state = opt_state or self.opt.init_state()
        self.step = step

    # ------------------------------------------------------- occupancy ops
    def density_threshold(self) -> float:
        m = self.cfg.model
        return 0.01 * m.max_samples / math.sqrt(3.0) * m.density_tresh_decay

    def occ_update(self, warmup: bool, *, jitter=None, cell_draws=None):
        """Occupancy refresh (train_nerf.py:314-320)."""
        self.occ = self.occ_grid.update(
            self.occ, self.model.density, self.density_threshold(), warmup,
            generator=self.generator, jitter=jitter, cell_draws=cell_draws)

    def mark_invisible_cells(self):
        """One-time camera-coverage marking (train_nerf.py:306-312)."""
        s = self.scene_train
        if s.K is None:
            raise NotImplementedError(
                "projection-matrix cameras (Hypersim) are ROADMAP A15")
        self.occ = self.occ_grid.mark_invisible_cells(
            self.occ, s.poses, s.img_wh, self.cfg.model.near_dist, s.K)

    # ------------------------------------------------------------ train step
    def train_step_core(self, bootstrap: bool = True,
                        draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One optimisation step: the bootstrap march when `bootstrap`,
        else the supervoxel-run march on the occupancy tables. `draws`
        may hold this step's random draws: "batch" ({"img", "tri"}),
        "noise" (N,), "bg" (3,) and "kmeans_init" (cluster_K,). Returns
        the step's metrics as tensors (no host synchronisation)."""
        cfg, scene, g = self.cfg, self.scene, self.generator
        draws = dict(draws or {})
        for k, dt in (("noise", torch.float32), ("bg", torch.float32),
                      ("kmeans_init", torch.int64)):
            if k in draws:
                draws[k] = torch.as_tensor(np.array(draws[k]), dtype=dt,
                                           device=self.device)
        batch = self.sampler.sample(g, draws.get("batch"))
        img, pix = batch["img_idxs"], batch["pix_idxs"]
        target = {"rgb": scene["rays"][img, pix][..., :3]}
        for k in _LABELS:
            if f"label_{k}" in scene:
                target[k] = scene[f"label_{k}"][img, pix]
        rays_o, rays_d = get_rays(scene["directions"][pix], scene["poses"][img])
        results = render_train(
            self.model, self.occ, rays_o.contiguous(),
            rays_d.contiguous(), cfg.render, global_step=self.step,
            bootstrap=bootstrap, noise=draws.get("noise"), bg=draws.get("bg"),
            generator=g)
        loss_d = compute_losses(
            results, target, cfg.loss, self.model.cfg, step=self.step,
            ray_sampling_strategy=cfg.data.ray_sampling_strategy,
            kmeans_init=draws.get("kmeans_init"), generator=g)
        names = list(self.params)
        grads = torch.autograd.grad(loss_d["total"],
                                    [self.params[n] for n in names],
                                    allow_unused=True)
        self.last_grads = {n: torch.zeros_like(self.params[n]) if gr is None
                           else gr for n, gr in zip(names, grads)}
        self.opt.step(self.last_grads)
        self.step += 1
        n_rays = self.sampler.batch_size
        mse = torch.mean((results["rgb"][: target["rgb"].shape[0]].detach()
                          - target["rgb"]) ** 2)
        metrics = {
            "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "rm_samples_per_ray": results["rm_samples"].float() / n_rays,
            "vr_samples_per_ray": results["vr_samples"].float() / n_rays,
            "trunc_ray_frac": results["trunc_rays"].float() / n_rays,
        }
        metrics.update({f"loss_{k}": v.detach() for k, v in loss_d.items()})
        return metrics

    # ------------------------------------------------------------------ fit
    def fit(self, n_steps: int) -> List[Dict[str, float]]:
        """Train `n_steps` steps from the current step, refreshing the
        occupancy grid every `update_interval` steps. Call
        `mark_invisible_cells()` once before the first step, as bench.py
        does. Returns every step's metrics as floats."""
        cfg = self.cfg
        history = []
        for _ in range(n_steps):
            step = self.step
            if step % cfg.optim.update_interval == 0:
                self.occ_update(warmup=step < cfg.optim.warmup_steps)
            boot = step < cfg.render.bootstrap_steps
            history.append(self.train_step_core(bootstrap=boot))
        return [{k: float(v) for k, v in m.items()} for m in history]

    # -------------------------------------------------------------- validate
    def render_images(self, poses) -> List[Dict]:
        """Render whole images: the rays of every pose in one stream, cut
        into `render.test_chunk` rays per `render_test` call
        (trainer.py:467-535). Returns one dict of host numpy arrays per
        image (rgb (H, W, 3), depth and opacity (H, W), norm_nn, sem) with
        its share of total_samples; `self.last_render` holds the whole
        render's samples and rounds."""
        cfg, dev = self.cfg, self.device
        scene = self.scene_test or self.scene_train
        W, H = scene.img_wh
        directions = torch.as_tensor(scene.directions, dtype=torch.float32,
                                     device=dev)
        ros, rds = [], []
        for pose in poses:
            ro, rd = get_rays(directions, torch.as_tensor(
                np.asarray(pose, np.float32), device=dev))
            ros.append(ro)
            rds.append(rd)
        rays_o = torch.cat(ros).contiguous()
        rays_d = torch.cat(rds).contiguous()
        chunk = cfg.render.test_chunk
        outs = [render_test(self.model, self.occ, rays_o[i:i + chunk],
                            rays_d[i:i + chunk], cfg.render)
                for i in range(0, rays_o.shape[0], chunk)]
        total = sum(o["total_samples"] for o in outs)
        self.last_render = {"total_samples": total,
                            "rounds": sum(o["rounds"] for o in outs)}
        keys = [k for k in outs[0] if k not in ("total_samples", "rounds")]
        cat = {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in keys}
        n_px = H * W
        results = []
        for j in range(len(poses)):
            res = {"total_samples": total // len(poses)}
            for k, v in cat.items():
                sl = v[j * n_px:(j + 1) * n_px]
                res[k] = sl.reshape(H, W, -1) if sl.ndim == 2 else sl.reshape(H, W)
            results.append(res)
        return results

    def validate(self, save_vis_dir: Optional[str] = None,
                 save_preds_dir: Optional[str] = None, logger=None,
                 rotation_draws=None) -> Dict[str, float]:
        """Render the test split, compute the metric suite and recover the
        Manhattan rotation (trainer.py:537-633). `rotation_draws` may hold
        the k-means initial draws of each recovery restart; else they
        come from a generator seeded with seed ^ 0xA11."""
        if save_vis_dir or save_preds_dir or logger is not None:
            raise NotImplementedError(
                "validation images, prediction export and loggers are "
                "ROADMAP A16")
        cfg = self.cfg
        scene = self.scene_test or self.scene_train
        agg = NeRFMTMetricsPerIm(
            pred_norm_nn=cfg.model.pred_norm_nn,
            pred_norm_depth=cfg.model.pred_norm_depth,
            pred_sem=cfg.model.pred_sem,
            load_depth_gt=cfg.data.load_depth_gt or "depth" in scene.labels,
            load_norm_gt=cfg.data.load_norm_gt or "normals" in scene.labels,
            load_sem_gt="semantics" in scene.labels,
            load_sem_WF_gt="semantics_WF" in scene.labels,
            n_classes=scene.n_classes,
        )
        W, H = scene.img_wh
        preds = []
        all_res = self.render_images(list(scene.poses))
        directions = torch.as_tensor(scene.directions, dtype=torch.float32,
                                     device=self.device)
        for i in range(scene.n_images):
            res = all_res[i]
            pred = {"rgb": res["rgb"], "depth": res["depth"]}
            if "norm_nn" in res:
                pred["norm_nn"] = res["norm_nn"]
            if cfg.model.pred_norm_depth:
                nd = extract_normals_from_depth_batch(
                    torch.as_tensor(res["depth"], device=self.device)[None],
                    directions, torch.as_tensor(
                        scene.poses[i:i + 1], dtype=torch.float32,
                        device=self.device))
                pred["norm_depth"] = nd[0].cpu().numpy()
            if "sem" in res:
                pred["sem"] = res["sem"]
            gt = {"rgb": scene.rays[i, :, :3].reshape(H, W, 3)}
            for k in ("depth", "normals", "semantics", "semantics_WF"):
                if k in scene.labels:
                    v = scene.labels[k][i]
                    gt[k] = (v.reshape(H, W, -1) if v.ndim == 2
                             and v.shape[-1] == 3 else v.reshape(H, W))
            agg.update(pred, gt)
            preds.append(pred)
        out = agg.compute()
        if cfg.model.pred_norm_depth and preds:
            all_nd = np.concatenate(
                [p["norm_depth"].reshape(-1, 3) for p in preds])
            gen = None
            if rotation_draws is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    cfg.seed ^ 0xA11)
            try:
                out.update(rotation_recovery_errors(
                    all_nd, self.R_offset, init_draws=rotation_draws,
                    generator=gen, device=self.device))
            except (ValueError, np.linalg.LinAlgError) as e:
                # degenerate clustering early in training (an SVD of a
                # rank-deficient centroid triplet); anything else raises
                warnings.warn(f"rotation recovery failed: {e}",
                              RuntimeWarning)
                out["ang/clust/failed"] = 1.0
        self._last_val_preds = preds
        return out
