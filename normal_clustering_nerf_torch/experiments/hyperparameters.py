"""Published sweep presets per dataset — the port's own copy of the
repository's `experiments/hyperparameters.py` (the port imports nothing
outside its package).

Flag presets mirroring the reference's experiment generators
(reference: experiments/{hypersim,scannet_man,replica_semnerf}/
hyperparameters.py): the baseline NGP configuration and the
"+normal clustering" (ours) configuration that produced the headline
numbers in BASELINE.md. Returned as argv lists for the port's CLI,
`python -m normal_clustering_nerf_torch.train_nerf`, which takes
train_nerf.py's flags.
"""
from __future__ import annotations

from typing import List


def _common(epochs: int) -> List[str]:
    return [
        "--no_debug",
        "--split=train", "--split_factor=0.5", "--keep_N_tr=-1",
        "--model_name=NGPMT", "--scale=0.5", "--grid_size=128",
        "--density_tresh_decay=1.0", "--rend_max_samples=1024",
        "--rend_near_dist=0.01",
        "--loss_opacity_w=1e-3", "--loss_distortion_w=0",
        "--lr=1e-2", f"--num_epochs={epochs}", "--batch_size=8192",
        "--triang_max_expand=0", "--anneal_strategy=none", "--anneal_steps=0",
    ]


def _clustering_flags() -> List[str]:
    # reference: experiments/hypersim/hyperparameters.py:44-54
    return [
        "--pred_norm_depth",
        "--loss_norm_D_C_ort_dot_w=2e-3",
        "--loss_norm_D_C_centr_dot_w=2e-3",
        "--loss_norm_D_C_centr_L1_w=2e-3",
        "--loss_norm_can_tres=0.01",
        "--loss_norm_can_start=500",
        "--loss_norm_can_end=-1",
        "--loss_norm_can_grow=2500",
    ]


def hypersim_flags(ours: bool = True, epochs: int = 30,
                   downsample: float = 1.0) -> List[str]:
    flags = _common(epochs) + [
        "--dataset_name=hypersim", f"--downsample={downsample}",
        "--load_depth_gt", "--load_norm_gt",
        "--ray_sampling_strategy=all_images_triang_patch",
    ]
    if ours:
        flags += _clustering_flags()
    return flags


def scannet_flags(ours: bool = True, epochs: int = 30) -> List[str]:
    flags = _common(epochs) + [
        "--dataset_name=scannet_manhattan", "--downsample=1.0",
        "--load_depth_gt",
        "--ray_sampling_strategy=all_images_triang_patch",
    ]
    if ours:
        flags += _clustering_flags()
    return flags


def replica_flags(ours: bool = True, epochs: int = 30) -> List[str]:
    flags = _common(epochs) + [
        "--dataset_name=replica_semnerf", "--downsample=1.0",
        "--load_depth_gt",
        "--ray_sampling_strategy=all_images_triang_patch",
    ]
    if ours:
        flags += _clustering_flags()
    return flags


PRESETS = {
    "hypersim": hypersim_flags,
    "scannet_manhattan": scannet_flags,
    "replica_semnerf": replica_flags,
}
