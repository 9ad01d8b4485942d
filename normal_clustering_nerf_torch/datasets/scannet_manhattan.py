"""ScanNet (Manhattan-SDF preprocessed scenes) loader, a copy of the JAX
package's `datasets/scannet_manhattan.py`.

Equivalent of the reference loader (reference:
datasets/scannet_manhattan.py + datasets/scannet_manhattan_src/
scene.py): 640x480 images, `intrinsic.txt` pinhole K, per-frame pose
txt, COLMAP depth `.npy` with >2.0 zeroed, DeepLab semantics remapped
wall(80)->1 / floor(160)->2 / rest->3, train/test = even/odd frames,
fixed scene bounds +-1.2, poses rescaled into [-0.5, 0.5]^3 and depth
divided by the scene diameter.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from .base import SceneData

WALL_SEMANTIC_ID = 80   # scene.py:17
FLOOR_SEMANTIC_ID = 160  # scene.py:18


def _ray_dirs(W, H, K):
    """uv+0.5 pixel centers through K^-1, normalized ||d||=1
    (scene.py:64-81, depth_type='distance')."""
    X, Y = np.meshgrid(np.arange(W, dtype=np.float32),
                       np.arange(H, dtype=np.float32))
    uv1 = np.stack([X + 0.5, Y + 0.5, np.ones_like(X)], axis=-1)
    dirs = uv1 @ np.linalg.inv(K).T
    dirs = dirs.reshape(-1, 3)
    return (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(np.float32)


class ScanNetManhattanDataset:
    def __init__(self, root_dir: str, split: str = "train",
                 load_depth_gt=False, load_sem_gt=False, load_sem_WF_gt=False,
                 downsample: float = 1.0, **kwargs):
        import cv2

        if downsample != 1.0:
            raise ValueError("the reference loader has no downscaling "
                             "(scene.py:35)")
        if kwargs.get("load_norm_gt") or kwargs.get("load_norm_depth_gt"):
            raise ValueError("ScanNet has no normal GT "
                             "(scannet_manhattan.py:17-18)")
        which_labels: List[str] = []
        if load_depth_gt:
            which_labels.append("depth")
        if load_sem_gt:
            which_labels.append("semantics")
        if load_sem_WF_gt:
            which_labels.append("semantics_WF")

        image_dir = os.path.join(root_dir, "images")
        image_list = sorted(os.listdir(image_dir), key=lambda s: int(s.split(".")[0]))
        # train = even frames, test = odd (scene.py:42-48)
        image_list = image_list[::2] if split.startswith("train") else image_list[1::2]

        W, H = 640, 480
        K = np.loadtxt(os.path.join(root_dir, "intrinsic.txt"))[:3, :3].astype(np.float32)
        directions = _ray_dirs(W, H, K)

        poses, rgbs, img_ids = [], [], []
        labels = {k: [] for k in which_labels}
        for name in image_list:
            stem = name[:-4]
            img_ids.append(stem)
            poses.append(np.loadtxt(
                os.path.join(root_dir, "pose", f"{stem}.txt")).astype(np.float32))
            rgb = cv2.imread(os.path.join(image_dir, f"{stem}.png"))
            rgb = cv2.cvtColor(rgb, cv2.COLOR_BGR2RGB).astype(np.float32) / 255.0
            rgbs.append(rgb.reshape(-1, 3))
            if "depth" in labels:
                p = os.path.join(root_dir, "depth_colmap", f"{stem}.npy")
                if os.path.exists(p):
                    d = np.load(p)
                    d[d > 2.0] = 0  # scene.py:104
                    if d.shape != (H, W):
                        d = np.zeros((H, W), np.float32)
                else:
                    d = np.zeros((H, W), np.float32)
                labels["depth"].append(d.astype(np.float32).reshape(-1))
            if "semantics" in labels or "semantics_WF" in labels:
                sem = cv2.imread(
                    os.path.join(root_dir, "semantic_deeplab", f"{stem}.png"), -1)
                wall = sem == WALL_SEMANTIC_ID
                floor = sem == FLOOR_SEMANTIC_ID
                out = np.full_like(sem, 3, dtype=np.int64)
                out[wall] = 1
                out[floor] = 2
                if out.shape != (H, W):
                    out = np.zeros((H, W), np.int64)
                if "semantics" in labels:
                    labels["semantics"].append(out.reshape(-1))
                if "semantics_WF" in labels:
                    labels["semantics_WF"].append(out.copy().reshape(-1))

        poses = np.stack(poses)
        # fixed bounds +-1.2 (scene.py:158-163); rescale into [-0.5, 0.5]
        xyz_min, xyz_max = -1.2 * np.ones(3), 1.2 * np.ones(3)
        shift = (xyz_max + xyz_min) / 2
        scale = float((xyz_max - xyz_min).max()) / 2 * 1.05
        poses[:, :3, 3] = (poses[:, :3, 3] - shift) / (2 * scale)
        label_arrays = {k: np.stack(v) for k, v in labels.items()}
        if "depth" in label_arrays:
            label_arrays["depth"] /= 2 * scale

        self.scene = SceneData(
            poses=poses[:, :3, :],
            directions=directions,
            rays=np.stack(rgbs),
            img_wh=(W, H),
            K=K,
            labels=label_arrays,
            img_ids=img_ids,
            n_classes=3 if ("semantics" in label_arrays or "semantics_WF" in label_arrays) else 0,
            xyz_cam_min=((-1.2 * np.ones(3) - shift) / (2 * scale)).astype(np.float32),
            xyz_cam_max=((1.2 * np.ones(3) - shift) / (2 * scale)).astype(np.float32),
            scale=scale,
        )
        self.scene_name = os.path.basename(root_dir)

    def load(self) -> SceneData:
        return self.scene
