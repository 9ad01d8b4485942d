"""Scene container: host numpy arrays the trainer moves to its device once,
and random unseen poses (a copy of the JAX package's `datasets/base.py`)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class SceneData:
    """Everything the trainer needs for one split of one scene."""
    poses: np.ndarray                   # (N_img, 3, 4) c2w
    directions: np.ndarray              # (H*W, 3) camera-frame ray dirs
    rays: np.ndarray                    # (N_img, H*W, 3[+1]) rgb (+exposure)
    img_wh: Tuple[int, int]
    K: Optional[np.ndarray] = None      # (3, 3) pinhole intrinsics
    proj: Optional[tuple] = None        # Hypersim (M_ndc, M_uv, shift, scale)
    labels: Dict[str, np.ndarray] = field(default_factory=dict)
    img_ids: List[str] = field(default_factory=list)
    n_classes: int = 0
    class_metadata: Optional[dict] = None
    xyz_cam_min: Optional[np.ndarray] = None
    xyz_cam_max: Optional[np.ndarray] = None
    scale: float = 0.5

    @property
    def n_images(self) -> int:
        return self.poses.shape[0]

    def keep_first_n(self, n: int) -> "SceneData":
        """Sparse-view subsetting (reference: train_nerf.py:129-137): `n`
        images evenly spaced over the split, first and last included."""
        idx = np.linspace(0, self.n_images - 1, n).astype(np.int64)
        return SceneData(
            poses=self.poses[idx],
            directions=self.directions,
            rays=self.rays[idx],
            img_wh=self.img_wh,
            K=self.K,
            proj=self.proj,
            labels={k: v[idx] for k, v in self.labels.items()},
            img_ids=[self.img_ids[i] for i in idx] if self.img_ids else [],
            n_classes=self.n_classes,
            class_metadata=self.class_metadata,
            xyz_cam_min=self.xyz_cam_min,
            xyz_cam_max=self.xyz_cam_max,
            scale=self.scale,
        )


def _normalize(v):
    return v / np.linalg.norm(v)


def _poses_avg(poses):
    """reference: datasets/base.py:215-221."""
    position = poses[:, :3, 3].mean(0)
    z_axis = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    vec2 = _normalize(z_axis)
    vec0 = _normalize(np.cross(up, vec2))
    vec1 = _normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def _focus_pt(poses):
    """Nearest point to all focal axes (reference: base.py:224-232)."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    directions = -directions
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.inv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def generate_random_poses(poses, xyz_cam_min, xyz_cam_max, n_poses=10000,
                          seed=0, focuspt_jitter=False):
    """Random unseen poses inside the camera bounding box, looking at the
    common focus point (reference: datasets/base.py:235-263). Returns the
    (n_poses, 3, 4) f32 poses and the average pose."""
    rng = np.random.default_rng(seed)
    up = poses[:, :3, 1].mean(0)
    z_axis = _focus_pt(poses)
    out = np.empty((n_poses, 3, 4), np.float32)
    for i in range(n_poses):
        position = xyz_cam_min + (xyz_cam_max - xyz_cam_min) * (
            rng.random(3) * 0.8 + 0.1
        )
        z_i = z_axis + rng.standard_normal(3) * 0.125 if focuspt_jitter else z_axis
        vec2 = _normalize(-(z_i - position))
        vec0 = _normalize(np.cross(up, vec2))
        vec1 = _normalize(np.cross(vec2, vec0))
        out[i] = np.stack([vec0, vec1, vec2, position], axis=1)
    return out, _poses_avg(poses)
