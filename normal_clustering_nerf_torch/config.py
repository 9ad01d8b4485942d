"""Structured configuration of the PyTorch/CUDA port.

The same dataclasses, field names and defaults as the JAX package's
`config.py`, so one configuration builds either trainer, and the same
reference-compatible CLI flags (`TrainConfig.from_args`), so a published
preset's argv (experiments/hyperparameters.py) builds the port's config.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    """NGP-MT model hyper-parameters (reference: opt.py:42-61)."""
    model_name: str = "NGPMT"
    scale: float = 0.5            # scene in [-scale, scale]^3
    grid_size: int = 128          # occupancy grid resolution G
    density_tresh_decay: float = 1.0
    max_samples: int = 1024       # per-ray sample cap
    near_dist: float = 0.01
    use_exposure: bool = False
    pred_norm_nn: bool = False
    pred_norm_nn_norm: bool = False
    pred_norm_depth: bool = False
    pred_sem: bool = False
    n_sem_cls: int = 3
    n_levels: int = 16
    n_features_per_level: int = 2
    log2_hashmap_size: int = 19
    base_resolution: int = 16
    finest_resolution: int = 2048
    # 'brick' = 4^3-vertex brick rows (models/brick_hash.py), 'tcnn' = the
    # canonical tiny-cuda-nn vertex layout (models/hash_encoding.py),
    # 'triplane' = triplane + coarse 3D grid (models/triplane.py)
    hash_layout: str = "brick"
    log2_bricks: int = 13
    plane_res: int = 512
    plane_feats: int = 8
    grid3d_res: int = 64
    grid3d_feats: int = 4
    hidden_dim: int = 64
    sigma_hidden_layers: int = 1
    rgb_hidden_layers: int = 2
    head_hidden_layers: int = 2
    geo_feat_dim: int = 16
    rgb_use_dir: bool = True
    compute_dtype: str = "float32"   # or "bfloat16"
    param_dtype: str = "float32"

    @property
    def cascades(self) -> int:
        return max(1 + int(math.ceil(math.log2(2 * self.scale))), 1)

    @property
    def per_level_scale(self) -> float:
        # b = exp(ln(finest * scale / base) / (L - 1)), as the JAX
        # package's config.py:71-77 (reference: models/ngp_mt.py:41)
        return math.exp(
            math.log(self.finest_resolution * self.scale / self.base_resolution)
            / (self.n_levels - 1)
        )

    @property
    def exp_step_factor(self) -> float:
        return 1.0 / 256.0 if self.scale > 0.5 else 0.0

    @property
    def rend_channels(self) -> int:
        c = 3
        if self.pred_norm_nn:
            c += 3
        if self.pred_sem:
            c += self.n_sem_cls
        return c


@dataclass(frozen=True)
class RenderConfig:
    """Static-shape rendering knobs (see the JAX package's config.py for
    the reasoning behind each default)."""
    T_threshold: float = 1e-4
    march_block: int = 1024
    sample_budget: int = 0             # 0 = auto (n_rays * 32)
    march_layout: str = "dense"
    march_coarse: bool = True
    coarse_k_blocks: int = 0
    sv_intervals: int = 0
    march_tail_k: int = -1             # -1 = full stratified tail
    max_march_iters: int = 4096
    march_noise: float = 1.0
    test_chunk: int = 65536
    test_n_samples: int = 64
    test_layout: str = "bucket"
    test_march_window: int = 128
    test_min_k: int = 32
    test_rounds_per_dispatch: int = 16
    test_sv_intervals: int = 24
    test_blind_rounds: int = 2
    bootstrap_steps: int = 512
    bootstrap_max_samples: int = 128
    random_bg: bool = True
    anneal_strategy: str = "none"      # 'avoid_near' | 'depth' | 'none'
    anneal_steps: int = 0


@dataclass(frozen=True)
class LossConfig:
    """Loss weights and clustering hyper-parameters (reference: opt.py:64-124)."""
    opacity_w: float = 1e-3
    distortion_w: float = 0.0
    depth_w: float = 0.0
    sem_w: float = 0.0
    norm_GT_depth: bool = False
    norm_depth_dot_w: float = 0.0
    norm_depth_L1_w: float = 0.0
    reg_depth_w: float = 0.0
    manhattan_nerf_w: float = 0.0
    norm_D_C_ort_dot_w: float = 0.0
    norm_D_C_centr_dot_w: float = 0.0
    norm_D_C_centr_L1_w: float = 0.0
    norm_D_C_can_dot_w: float = 0.0
    norm_D_C_can_L1_w: float = 0.0
    norm_can_tres: float = 0.0
    norm_can_start: int = 0
    norm_can_end: int = -1
    norm_can_grow: float = 1.0
    norm_yaw_offset_ang: float = 0.0
    norm_pitch_offset_ang: float = 0.0
    norm_roll_offset_ang: float = 0.0
    cluster_K: int = 20
    cluster_niter: int = 20
    distortion_ts_bug_compat: bool = False
    discard_far_members: bool = False


@dataclass(frozen=True)
class DataConfig:
    """Dataset / split / sampling config (reference: opt.py:14-39)."""
    root_dir: str = ""
    dataset_name: str = "synthetic"
    split: str = "train"
    split_factor: float = 0.5
    keep_N_tr: int = -1
    downsample: float = 1.0
    load_depth_gt: bool = False
    load_norm_gt: bool = False
    load_norm_depth_gt: bool = False
    load_sem_gt: bool = False
    load_sem_WF_gt: bool = False
    ray_sampling_strategy: str = "all_images"
    batch_size: int = 8192
    random_tr_poses: bool = False
    triang_max_expand: int = 0
    patch_size: int = 8
    storage_dtype: str = "float32"
    host_sampler: bool = False
    host_sampler_threads: int = 4


@dataclass(frozen=True)
class OptimConfig:
    """Optimizer / schedule (reference: train_nerf.py:237-291)."""
    lr: float = 1e-2
    num_epochs: int = 4
    steps_per_epoch: int = 1000
    grad_clip: float = 0.05
    adam_eps: float = 1e-15
    weight_decay_net: float = 1e-6
    optimize_ext: bool = False
    lr_dR_norm_glob: float = 0.0
    # parsed and never read, as in the JAX package
    dR_norm_glob_coding: str = "axis_angle"
    warmup_steps: int = 256
    update_interval: int = 16


@dataclass(frozen=True)
class EvalConfig:
    """Validation / artifact options (reference: opt.py:167-196)."""
    eval_lpips: bool = False
    val_only: bool = False
    save_test_vis: bool = False
    downsample_vis: float = 0.5
    save_test_preds: bool = False
    save_train_preds: bool = False
    downsample_pred_save: float = 0.5


@dataclass(frozen=True)
class TrainConfig:
    exp_name: str = ""
    log_root_dir: str = "./logs"
    seed: int = 1337
    no_debug: bool = False   # False: a CLI run takes the debug schedule
    ckpt_path: Optional[str] = None
    weight_path: Optional[str] = None
    save_checkpoint: bool = False
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    eval: EvalConfig = field(default_factory=EvalConfig)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def from_args(argv=None) -> "TrainConfig":
        """Parse reference-compatible CLI flags (opt.py names) into a
        TrainConfig, as the JAX package's `TrainConfig.from_args`
        (config.py:329-483) does. `--num_chips`, more than one card, which
        the port does not have, is parsed and refused above 1."""
        p = argparse.ArgumentParser()
        p.add_argument("--no_debug", action="store_true", default=False)
        p.add_argument("--log_root_dir", type=str, default="./logs")
        p.add_argument("--exp_name", type=str, default="")
        p.add_argument("--seed", type=int, default=1337)
        # dataset
        p.add_argument("--data_root_dir", type=str, default="")
        p.add_argument("--dataset_name", type=str, default="hypersim",
                       choices=["hypersim", "scannet_manhattan",
                                "replica_semnerf", "synthetic"])
        p.add_argument("--split", type=str, default="train",
                       choices=["train", "trainval", "trainvaltest"])
        p.add_argument("--split_factor", type=float, default=0.5)
        p.add_argument("--keep_N_tr", type=int, default=-1)
        p.add_argument("--downsample", type=float, default=1.0)
        for f in ["load_depth_gt", "load_norm_gt", "load_norm_depth_gt",
                  "load_sem_gt", "load_sem_WF_gt"]:
            p.add_argument(f"--{f}", action="store_true", default=False)
        # model
        p.add_argument("--model_name", type=str, default="NGPMT")
        p.add_argument("--scale", type=float, default=0.5)
        p.add_argument("--grid_size", type=int, default=128)
        p.add_argument("--density_tresh_decay", type=float, default=1.0)
        p.add_argument("--rend_max_samples", type=int, default=1024)
        p.add_argument("--rend_near_dist", type=float, default=0.01)
        for f in ["use_exposure", "pred_norm_nn", "pred_norm_nn_norm",
                  "pred_norm_depth", "pred_sem"]:
            p.add_argument(f"--{f}", action="store_true", default=False)
        p.add_argument("--compute_dtype", type=str, default="float32",
                       choices=["float32", "bfloat16"])
        # losses
        p.add_argument("--loss_opacity_w", type=float, default=1e-3)
        for f in ["distortion_w", "depth_w", "sem_w"]:
            p.add_argument(f"--loss_{f}", type=float, default=0)
        p.add_argument("--loss_norm_GT_depth", action="store_true",
                       default=False)
        for f in ["norm_depth_dot_w", "norm_depth_L1_w", "reg_depth_w",
                  "manhattan_nerf_w", "norm_D_C_ort_dot_w",
                  "norm_D_C_centr_dot_w", "norm_D_C_centr_L1_w",
                  "norm_D_C_can_dot_w", "norm_D_C_can_L1_w", "norm_can_tres",
                  "norm_can_start"]:
            p.add_argument(f"--loss_{f}", type=float, default=0)
        p.add_argument("--loss_norm_can_end", type=float, default=-1)
        p.add_argument("--loss_norm_can_grow", type=float, default=1)
        for f in ["yaw", "pitch", "roll"]:
            p.add_argument(f"--loss_norm_{f}_offset_ang", type=float,
                           default=0)
        # training
        p.add_argument("--optimize_ext", action="store_true", default=False)
        p.add_argument("--lr", type=float, default=1e-2)
        p.add_argument("--lr_dR_norm_glob", type=float, default=0)
        p.add_argument("--dR_norm_glob_coding", type=str,
                       default="axis_angle")
        p.add_argument("--num_epochs", type=int, default=4)
        p.add_argument("--batch_size", type=int, default=8192)
        p.add_argument("--ray_sampling_strategy", type=str,
                       default="all_images",
                       choices=["all_images", "same_image",
                                "same_image_triang", "all_images_triang",
                                "all_images_triang_val",
                                "same_image_triang_patch",
                                "all_images_triang_patch"])
        p.add_argument("--random_tr_poses", action="store_true",
                       default=False)
        p.add_argument("--triang_max_expand", type=int, default=0)
        p.add_argument("--anneal_strategy", type=str, default="none",
                       choices=["avoid_near", "depth", "none"])
        p.add_argument("--anneal_steps", type=int, default=0)
        p.add_argument("--num_chips", type=int, default=0,
                       help="0/1 = one card; more is ROADMAP A10")
        p.add_argument("--grad_clip", type=float, default=0.05)
        p.add_argument("--random_bg", action="store_true", default=False)
        # validation
        p.add_argument("--eval_lpips", action="store_true", default=False)
        p.add_argument("--val_only", action="store_true", default=False)
        p.add_argument("--save_test_vis", action="store_true", default=False)
        p.add_argument("--downsample_vis", type=float, default=0.5)
        p.add_argument("--save_test_preds", action="store_true",
                       default=False)
        p.add_argument("--save_train_preds", action="store_true",
                       default=False)
        p.add_argument("--downsample_pred_save", type=float, default=0.5)
        p.add_argument("--ckpt_path", type=str, default=None)
        p.add_argument("--weight_path", type=str, default=None)
        p.add_argument("--save_checkpoint", action="store_true",
                       default=False)
        a = p.parse_args(argv)
        if a.num_chips not in (0, 1):
            raise NotImplementedError(
                "flags not ported: ['--num_chips (ROADMAP A10)']")

        return TrainConfig(
            exp_name=a.exp_name, log_root_dir=a.log_root_dir, seed=a.seed,
            no_debug=a.no_debug, ckpt_path=a.ckpt_path,
            weight_path=a.weight_path, save_checkpoint=a.save_checkpoint,
            model=ModelConfig(
                model_name=a.model_name, scale=a.scale,
                grid_size=a.grid_size,
                density_tresh_decay=a.density_tresh_decay,
                max_samples=a.rend_max_samples, near_dist=a.rend_near_dist,
                use_exposure=a.use_exposure, pred_norm_nn=a.pred_norm_nn,
                pred_norm_nn_norm=a.pred_norm_nn_norm,
                pred_norm_depth=a.pred_norm_depth, pred_sem=a.pred_sem,
                compute_dtype=a.compute_dtype,
            ),
            render=RenderConfig(
                random_bg=a.random_bg, anneal_strategy=a.anneal_strategy,
                anneal_steps=a.anneal_steps, march_block=a.rend_max_samples,
            ),
            loss=LossConfig(
                opacity_w=a.loss_opacity_w, distortion_w=a.loss_distortion_w,
                depth_w=a.loss_depth_w, sem_w=a.loss_sem_w,
                norm_GT_depth=a.loss_norm_GT_depth,
                norm_depth_dot_w=a.loss_norm_depth_dot_w,
                norm_depth_L1_w=a.loss_norm_depth_L1_w,
                reg_depth_w=a.loss_reg_depth_w,
                manhattan_nerf_w=a.loss_manhattan_nerf_w,
                norm_D_C_ort_dot_w=a.loss_norm_D_C_ort_dot_w,
                norm_D_C_centr_dot_w=a.loss_norm_D_C_centr_dot_w,
                norm_D_C_centr_L1_w=a.loss_norm_D_C_centr_L1_w,
                norm_D_C_can_dot_w=a.loss_norm_D_C_can_dot_w,
                norm_D_C_can_L1_w=a.loss_norm_D_C_can_L1_w,
                norm_can_tres=a.loss_norm_can_tres,
                norm_can_start=int(a.loss_norm_can_start),
                norm_can_end=int(a.loss_norm_can_end),
                norm_can_grow=a.loss_norm_can_grow,
                norm_yaw_offset_ang=a.loss_norm_yaw_offset_ang,
                norm_pitch_offset_ang=a.loss_norm_pitch_offset_ang,
                norm_roll_offset_ang=a.loss_norm_roll_offset_ang,
            ),
            data=DataConfig(
                root_dir=a.data_root_dir, dataset_name=a.dataset_name,
                split=a.split, split_factor=a.split_factor,
                keep_N_tr=a.keep_N_tr, downsample=a.downsample,
                load_depth_gt=a.load_depth_gt, load_norm_gt=a.load_norm_gt,
                load_norm_depth_gt=a.load_norm_depth_gt,
                load_sem_gt=a.load_sem_gt, load_sem_WF_gt=a.load_sem_WF_gt,
                ray_sampling_strategy=a.ray_sampling_strategy,
                batch_size=a.batch_size, random_tr_poses=a.random_tr_poses,
                triang_max_expand=a.triang_max_expand,
            ),
            optim=OptimConfig(
                lr=a.lr, num_epochs=a.num_epochs, grad_clip=a.grad_clip,
                optimize_ext=a.optimize_ext,
                lr_dR_norm_glob=a.lr_dR_norm_glob,
                dR_norm_glob_coding=a.dR_norm_glob_coding,
            ),
            eval=EvalConfig(
                eval_lpips=a.eval_lpips, val_only=a.val_only,
                save_test_vis=a.save_test_vis, downsample_vis=a.downsample_vis,
                save_test_preds=a.save_test_preds,
                save_train_preds=a.save_train_preds,
                downsample_pred_save=a.downsample_pred_save,
            ),
        )

    def debug_overrides(self) -> "TrainConfig":
        """The CLI's shrunken smoke-test schedule without `--no_debug`
        (reference: train_nerf.py:813-866; config.py:485-497): grid 32,
        128 samples a ray, every head, batch 256 as triangles, 100 steps."""
        return dataclasses.replace(
            self,
            model=dataclasses.replace(
                self.model, grid_size=32, max_samples=128,
                pred_norm_nn=True, pred_norm_depth=True, pred_sem=True),
            data=dataclasses.replace(
                self.data, batch_size=256,
                ray_sampling_strategy="all_images_triang"),
            optim=dataclasses.replace(self.optim, num_epochs=2,
                                      steps_per_epoch=50),
            render=dataclasses.replace(self.render, march_block=128),
        )
