"""Replica (semantic-NeRF renders) loader, a copy of the JAX package's
`datasets/replica_semnerf.py`.

Equivalent of the reference loader (reference:
datasets/replica_semnerf.py + datasets/replica_semnerf_src/scene.py):
Sequence_1, 900 frames, hfov=90 pinhole, depth in mm -> m, semantics
remapped to contiguous ids (void=0 kept), semantics_WF wall(93)->1 /
floor(40)->2 / rest->3, train/test stride-12 interleave (half_step=6),
scene bounds from the full-trajectory depth pointcloud, poses rescaled
into [-0.5, 0.5]^3 and depth divided by the scene diameter.
"""
from __future__ import annotations

import glob
import json
import math
import os
from typing import List

import numpy as np

from .base import SceneData
from .normals import normals_from_depth


class ReplicaSemNerfDataset:
    def __init__(self, root_dir: str, split: str = "train",
                 load_depth_gt=False, load_norm_depth_gt=False,
                 load_sem_gt=False, load_sem_WF_gt=False,
                 downsample: float = 1.0, **kwargs):
        import cv2

        which_labels: List[str] = ["depth"]  # bounds need depth (scene.py:233)
        if load_norm_depth_gt:
            which_labels.append("normals_depth")
        if load_sem_gt:
            which_labels.append("semantics")
        if load_sem_WF_gt:
            which_labels.append("semantics_WF")

        scene_name = os.path.basename(root_dir)
        semantic_root = os.path.join(
            os.path.dirname(root_dir), "semantic_info", scene_name)
        seq_dir = os.path.join(root_dir, "Sequence_1")

        rgb_probe = sorted(glob.glob(os.path.join(seq_dir, "rgb", "rgb*.png")))
        if not rgb_probe:
            raise FileNotFoundError(f"no rgb frames under {seq_dir}")
        probe = cv2.imread(rgb_probe[0])
        # 640x480 for real Replica renders (scene.py:52); derived here so
        # synthetic fixtures can be smaller
        H0, W0 = probe.shape[:2]
        H, W = int(H0 * downsample), int(W0 * downsample)
        hfov = 90.0
        fx = W / 2.0 / math.tan(math.radians(hfov / 2.0))
        fy = fx
        cx, cy = (W - 1.0) / 2.0, (H - 1.0) / 2.0
        K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)

        # ray dirs WITHOUT the +0.5 offset (scene.py:79-93 uses pixel
        # indices against cx=(W-1)/2), depth_type='z' (unnormalized)
        X, Y = np.meshgrid(np.arange(W, dtype=np.float32),
                           np.arange(H, dtype=np.float32))
        directions = np.stack(
            [(X - cx) / fx, (Y - cy) / fy, np.ones_like(X)], axis=-1
        ).reshape(-1, 3).astype(np.float32)

        poses_all = np.loadtxt(
            os.path.join(seq_dir, "traj_w_c.txt"), delimiter=" "
        ).reshape(-1, 4, 4).astype(np.float32)
        rgb_list = sorted(glob.glob(os.path.join(seq_dir, "rgb", "rgb*.png")),
                          key=lambda f: int(f.split("_")[-1][:-4]))
        depth_list = sorted(glob.glob(os.path.join(seq_dir, "depth", "depth*.png")),
                            key=lambda f: int(f.split("_")[-1][:-4]))
        sem_list = sorted(
            glob.glob(os.path.join(seq_dir, "semantic_class", "semantic_class_*.png")),
            key=lambda f: int(f.split("_")[-1][:-4]))

        n_total = len(rgb_list)
        rgbs, depths, sems, semWFs = [], [], [], []
        for i in range(n_total):
            img = cv2.imread(rgb_list[i])[:, :, ::-1].astype(np.float32) / 255.0
            if (H, W) != (H0, W0):
                img = cv2.resize(img, (W, H), interpolation=cv2.INTER_LINEAR)
            rgbs.append(img)
            d = cv2.imread(depth_list[i], cv2.IMREAD_UNCHANGED).astype(np.float32) / 1000.0
            if (H, W) != (H0, W0):
                d = cv2.resize(d, (W, H), interpolation=cv2.INTER_LINEAR)
            depths.append(d)
            if "semantics" in which_labels or "semantics_WF" in which_labels:
                s = cv2.imread(sem_list[i], cv2.IMREAD_UNCHANGED).astype(np.int64)
                if (H, W) != (H0, W0):
                    s = cv2.resize(s.astype(np.int32), (W, H),
                                   interpolation=cv2.INTER_NEAREST).astype(np.int64)
                if "semantics" in which_labels:
                    sems.append(s)
                if "semantics_WF" in which_labels:
                    wf = np.full_like(s, 3)
                    wf[s == 93] = 1   # wall (scene.py:140-141)
                    wf[s == 40] = 2   # floor (scene.py:142-143)
                    semWFs.append(wf)

        depth_all = np.stack(depths)

        # scene bounds from full-trajectory pointcloud (scene.py:231-272)
        P_cc = directions[None] * depth_all.reshape(n_total, -1, 1)
        P_cc_h = np.concatenate([P_cc, np.ones_like(P_cc[..., :1])], -1)
        P_wc = np.einsum("nij,nkj->nki", poses_all, P_cc_h)
        P_wc = P_wc[..., :3] / P_wc[..., 3:]
        valid = depth_all.reshape(n_total, -1) != 0.0
        pts = P_wc[valid]
        xyz_min, xyz_max = pts.min(0), pts.max(0)
        trans = poses_all[:, :3, 3]
        xyz_cam_min, xyz_cam_max = trans.min(0), trans.max(0)

        # train/test stride-12 interleave (scene.py:155-169, half_step=6)
        hs = 6
        sel = slice(0, None, 2 * hs) if split.startswith("train") else slice(hs, None, 2 * hs)
        idxs = list(range(n_total))[sel]

        labels = {"depth": depth_all[idxs].reshape(len(idxs), -1)}
        n_classes = 0
        class_metadata = None
        if sems:
            sem_sel = np.stack([sems[i] for i in idxs])
            # contiguous remap over the classes present (scene.py:175-199)
            classes = np.unique(sem_sel).astype(np.int64)
            remap = np.zeros(int(classes.max()) + 1, np.int64)
            for new_id, old_id in enumerate(classes):
                remap[old_id] = new_id
            sem_sel = remap[sem_sel]
            labels["semantics"] = sem_sel.reshape(len(idxs), -1)
            n_classes = len(classes) - 1  # exclude void
            names = None
            info_path = os.path.join(semantic_root, "info_semantic.json")
            if os.path.exists(info_path):
                with open(info_path) as f:
                    ann = json.load(f)
                names = ["void"] + [x["name"] for x in ann["classes"]]
            class_metadata = {"class_ids_scene": classes.tolist(),
                              "class_names": names}
        if semWFs:
            labels["semantics_WF"] = np.stack(
                [semWFs[i] for i in idxs]).reshape(len(idxs), -1)
            n_classes = n_classes or 3

        poses = poses_all[idxs].copy()
        shift = (xyz_max + xyz_min) / 2
        scale = float((xyz_max - xyz_min).max()) / 2 * 1.05
        poses[:, :3, 3] = (poses[:, :3, 3] - shift) / (2 * scale)
        labels["depth"] = labels["depth"] / (2 * scale)

        if "normals_depth" in which_labels:
            nd = normals_from_depth(
                depth_all[idxs], directions, poses_all[idxs, :3, :])
            labels["normals_depth"] = np.asarray(nd).reshape(len(idxs), -1, 3)

        self.scene = SceneData(
            poses=poses[:, :3, :],
            directions=directions,
            rays=np.stack([rgbs[i].reshape(-1, 3) for i in idxs]),
            img_wh=(W, H),
            K=K,
            labels={} if not (load_depth_gt or load_norm_depth_gt or sems or semWFs)
            else {k: v for k, v in labels.items()
                  if k != "depth" or load_depth_gt},
            img_ids=[f"{i}" for i in idxs],
            n_classes=n_classes,
            class_metadata=class_metadata,
            xyz_cam_min=((xyz_cam_min - shift) / (2 * scale)).astype(np.float32),
            xyz_cam_max=((xyz_cam_max - shift) / (2 * scale)).astype(np.float32),
            scale=scale,
        )
        self.scene_name = scene_name

    def load(self) -> SceneData:
        return self.scene
