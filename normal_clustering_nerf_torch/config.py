"""Structured configuration of the PyTorch/CUDA port.

The same dataclasses, field names and defaults as the JAX package's
`config.py`, so one configuration builds either trainer. The CLI parser
(`TrainConfig.from_args`) is not ported yet (ROADMAP A16).
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field


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
    dR_norm_glob_coding: str = "axis_angle"
    warmup_steps: int = 256
    update_interval: int = 16


@dataclass(frozen=True)
class TrainConfig:
    exp_name: str = ""
    log_root_dir: str = "./logs"
    seed: int = 1337
    model: ModelConfig = field(default_factory=ModelConfig)
    render: RenderConfig = field(default_factory=RenderConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    data: DataConfig = field(default_factory=DataConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)
