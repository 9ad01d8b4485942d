"""Hypersim scene loader — a copy of the JAX package's `datasets/hypersim.py`
(reference: datasets/hypersim.py, datasets/hypersim_src/{scene.py,
cam_model.py, utils.py}) in numpy, h5py and cv2:

  * HDF5 radiance images with the CCIR601 percentile tonemap
    (utils.py:682-735).
  * Labels: depth (NaN -> 0, distance convention, utils.py:240-266),
    world-space bump normals (NaN -> 0), NYU40 semantics remapped to
    contiguous scene ids, and semantics_WF merging window(9)->wall(1),
    floormat(20)->floor(2), rest->3 (utils.py:199-221).
  * The per-scene projective camera (`HypersimCamModel`): M_cam_from_uv
    ray directions on a [-1, 1]^2 uv grid with flipped v, normalised
    ||d||=1 (cam_model.py:153-201); poses from HDF5 keyframes
    (utils.py:398-430); intrinsics exposed as the projection-matrix tuple
    (M_ndc_from_cam, M_uv_from_ndc, shift, scale) that invisible-cell
    marking takes (hypersim.py:100-105, ngp_mt.py:291-321).
  * The work after the files are read (`hypersim_scene`, a function on
    arrays): depth in asset units, normals from depth, the scene bounds
    (metadata json if present, else depth-pointcloud bounds with the
    camera-expansion xyz_cam1p5 variant, scene.py:310-400), poses
    rescaled into [-0.5, 0.5]^3 with scale = (max-min)/2 * 1.05
    (hypersim.py:55-68), the optional R_offset rotation of poses and
    normal labels with the 1.6 scale fudge (hypersim.py:82-95), and depth
    clipped to the bbox via the pointcloud, then divided by the scene
    diameter (hypersim.py:115-132, utils.py:489-502).

h5py and cv2 are imported by the functions that read or resize files,
so the module imports where neither is installed; the two metadata CSVs
are read with the standard `csv` module.
"""
from __future__ import annotations

import csv
import json
import math
import os
import random
from typing import Dict, List, Optional

import numpy as np

from .base import SceneData
from .normals import normals_from_depth

H_ORIG, W_ORIG = 768, 1024


# ------------------------------------------------------------------ tonemap
def tonemap_ccir601(rgb, render_entity_id, percentile=90,
                    brightness_desired=0.8):
    """CGIntrinsics-style percentile tonemap (utils.py:682-735)."""
    gamma = 1.0 / 2.2
    valid = render_entity_id != -1
    if np.count_nonzero(valid) == 0:
        scale = 1.0
    else:
        brightness = (0.3 * rgb[:, :, 0] + 0.59 * rgb[:, :, 1]
                      + 0.11 * rgb[:, :, 2])
        cur = np.percentile(brightness[valid], percentile)
        if cur < 1e-4:
            scale = 0.0
        else:
            scale = np.power(brightness_desired, 1.0 / gamma) / cur
    out = np.power(np.maximum(scale * rgb, 0), gamma)
    return np.clip(out, 0, 1).astype(np.float32)


# ------------------------------------------------------------------ HDF5 IO
def _h5(path):
    import h5py
    if not os.path.isfile(path) or not h5py.is_hdf5(path):
        return None
    with h5py.File(path, "r") as f:
        return f["dataset"][:]


def load_image(images_dir, cam, frame, apply_tonemap=True):
    rgb = _h5(os.path.join(
        images_dir, f"scene_{cam}_final_hdf5", f"frame.{frame}.color.hdf5"))
    rgb = rgb.astype(np.float32)
    if apply_tonemap:
        reid = _h5(os.path.join(
            images_dir, f"scene_{cam}_geometry_hdf5",
            f"frame.{frame}.render_entity_id.hdf5")).astype(np.int32)
        rgb = tonemap_ccir601(rgb, reid)
    return rgb


def load_label(images_dir, cam, frame, which):
    geo = os.path.join(images_dir, f"scene_{cam}_geometry_hdf5")
    if which == "depth":
        d = _h5(os.path.join(geo, f"frame.{frame}.depth_meters.hdf5"))
        return None if d is None else d.astype(np.float32)
    if which == "normals":
        n = _h5(os.path.join(geo, f"frame.{frame}.normal_bump_world.hdf5"))
        return None if n is None else n.astype(np.float32)
    if which in ("semantics", "semantics_WF"):
        s = _h5(os.path.join(geo, f"frame.{frame}.semantic.hdf5"))
        return None if s is None else s.astype(np.int64)
    raise KeyError(which)


# ------------------------------------------------------------------ camera
def standard_cam_matrices(W, H, wfov=math.pi / 3.0, near=1.0, far=1000.0):
    """Projective matrices of Hypersim's standard (non-physical) camera:
    a 60-degree horizontal fov OpenGL camera with near=1, far=1000 asset
    units, whose metadata_camera_parameters.csv rows are exactly
      M_cam_from_uv = diag(tan(w/2), tan(w/2)*H/W, -1)
      M_proj = perspective(1/tan(w/2), 1/tan(h/2), near, far).
    The fallback where the CSV is not available."""
    tw = math.tan(wfov / 2.0)
    th = tw * H / W
    M_cam_from_uv = np.array(
        [[tw, 0, 0], [0, th, 0], [0, 0, -1.0]], np.float32)
    M_proj = np.array([
        [1.0 / tw, 0, 0, 0],
        [0, 1.0 / th, 0, 0],
        [0, 0, -(far + near) / (far - near), -2 * far * near / (far - near)],
        [0, 0, -1.0, 0],
    ], np.float32)
    return M_cam_from_uv, M_proj


def _csv_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


class HypersimCamModel:
    """Per-scene projective camera (cam_model.py:13-201), made from its
    matrices and the scene's meters per asset unit; `from_scene` reads
    them from a scene directory."""

    def __init__(self, H, W, M_cam_from_uv, M_ndc_from_cam,
                 m_per_asset_unit: float):
        self.H, self.W = H, W
        self.M_cam_from_uv = np.asarray(M_cam_from_uv, np.float32)
        self.M_ndc_from_cam = np.asarray(M_ndc_from_cam, np.float32)
        # uv<-ndc with flipped v (cam_model.py:73-78)
        self.M_uv_from_ndc = np.array([
            [0.5 * (W - 1), 0, 0, 0.5 * (W - 1)],
            [0, -0.5 * (H - 1), 0, 0.5 * (H - 1)],
            [0, 0, 0.5, 0.5],
            [0, 0, 0, 1.0],
        ], np.float32)
        self.m_per_asset_unit = float(m_per_asset_unit)
        self.metric_mode = "asset_units"
        self.ray_dirs_cc = self._ray_dirs()

    @classmethod
    def from_scene(cls, scene_root_dir, scene_name, H, W,
                   camera_params_csv: Optional[str] = None):
        """The scene's camera row of metadata_camera_parameters.csv (the
        standard camera where the CSV is absent) and meters per asset unit
        from _detail/metadata_scene.csv (utils.py:445-455)."""
        csv_path = camera_params_csv or os.path.join(
            os.path.dirname(__file__), "hypersim_src_meta",
            "metadata_camera_parameters.csv")
        if os.path.isfile(csv_path):
            row = next(r for r in _csv_rows(csv_path)
                       if r["scene_name"] == scene_name)
            M_cam_from_uv = np.array(
                [[float(row[f"M_cam_from_uv_{i}{j}"]) for j in range(3)]
                 for i in range(3)], np.float32)
            M_ndc_from_cam = np.array(
                [[float(row[f"M_proj_{i}{j}"]) for j in range(4)]
                 for i in range(4)], np.float32)
        else:
            M_cam_from_uv, M_ndc_from_cam = standard_cam_matrices(W, H)
        meta = _csv_rows(os.path.join(scene_root_dir, "_detail",
                                      "metadata_scene.csv"))
        m = next(float(r["parameter_value"]) for r in meta
                 if r["parameter_name"] == "meters_per_asset_unit")
        return cls(H, W, M_cam_from_uv, M_ndc_from_cam, m)

    def _ray_dirs(self):
        """uv grid in [-1,1]^2 (v flipped) -> M_cam_from_uv -> ||d||=1
        (cam_model.py:153-201)."""
        H, W = self.H, self.W
        du, dv = 1.0 / W, 1.0 / H
        u = np.linspace(-1 + du, 1 - du, W)
        v = np.linspace(-1 + dv, 1 - dv, H)[::-1]
        uu, vv = np.meshgrid(u, v)
        uv1 = np.stack([uu, vv, np.ones_like(uu)], -1).reshape(-1, 3)
        d = (self.M_cam_from_uv @ uv1.T).T
        d /= np.linalg.norm(d, axis=-1, keepdims=True)  # 'distance' depth
        return d.astype(np.float32)

    def load_poses(self, scene_root_dir, cam, frames: List[int]):
        """Keyframe poses reordered to the frame list (utils.py:398-430,
        cam_model.py:104-151)."""
        cam_dir = os.path.join(scene_root_dir, "_detail", cam)
        trans = _h5(os.path.join(cam_dir, "camera_keyframe_positions.hdf5"))
        rots = _h5(os.path.join(cam_dir, "camera_keyframe_orientations.hdf5"))
        fidx = _h5(os.path.join(cam_dir, "camera_keyframe_frame_indices.hdf5"))
        poses = np.concatenate(
            [rots.astype(np.float32), trans.astype(np.float32)[..., None]], -1)
        out = []
        for f in frames:
            if fidx[f] == f:
                out.append(poses[f])
            else:
                where = np.where(fidx == f)[0]
                out.append(poses[int(where[0])])
        return np.stack(out)


# --------------------------------------------------------------- processing
def process_semantics(sem_all, which, metadata=None):
    """NYU40 remap / wall-floor merge (utils.py:150-236)."""
    sem_all = sem_all.copy()
    sem_all[sem_all == -1] = 0
    if metadata is not None and "class_ids_scene" in metadata:
        class_ids = np.asarray(metadata["class_ids_scene"])
    else:
        class_ids = np.unique(sem_all)
    meta = {
        "class_ids_scene": class_ids,
        "n_classes_scene": len(class_ids),
        "n_valid_classes_scene": len(class_ids) - 1,
    }
    if which == "semantics":
        remap = np.zeros(int(class_ids.max()) + 1, sem_all.dtype)
        for new_id, old_id in enumerate(class_ids):
            remap[old_id] = new_id
        sem_all = remap[np.clip(sem_all, 0, len(remap) - 1)]
    else:  # semantics_WF (utils.py:213-221)
        sem_all[sem_all == 9] = 1    # window -> wall
        sem_all[sem_all == 20] = 2   # floormat -> floor
        wf = (sem_all == 1) | (sem_all == 2)
        sem_all[~wf] = 3
        meta["n_valid_classes_scene"] = 3
    return sem_all, meta


def generate_pointcloud(ray_dirs_cc, poses, depths):
    """Unproject distance-depths into world points (utils.py:462-486,
    depth_type='distance': dirs already unit)."""
    P_cc = ray_dirs_cc[None] * depths[..., None]
    R = poses[:, :3, :3]
    t = poses[:, :3, 3]
    return np.einsum("nij,nkj->nki", R, P_cc) + t[:, None, :]


def clip_depths_to_bbox(depths, P_wc, poses, xyz_min, xyz_max):
    """Shrink depths so points stay inside the bbox (utils.py:489-502)."""
    P_bnd = np.clip(P_wc, xyz_min[None, None], xyz_max[None, None])
    cam = poses[:, None, :3, 3]
    denom = P_wc - cam
    safe = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    S = np.where(np.abs(denom) < 1e-12, 1.0, (P_bnd - cam) / safe)
    S = np.where(depths[..., None] == 0.0, 1.0, S)
    return depths * S.min(-1)


def _downscale(arr, which, H, W):
    import cv2
    out = []
    interp = cv2.INTER_LINEAR if which == "image" else cv2.INTER_NEAREST
    for a in arr:
        r = cv2.resize(a.astype(np.float32) if a.dtype.kind != "f" else a,
                       (W, H), interpolation=interp)
        out.append(r)
    out = np.stack(out)
    if which in ("normals", "normals_depth"):
        nz = np.abs(out).sum(-1, keepdims=True) != 0
        norm = np.linalg.norm(out, axis=-1, keepdims=True)
        out = np.where(nz, out, out / np.maximum(norm, 1e-12))
    if arr.dtype.kind in "iu":
        out = out.astype(arr.dtype)
    return out


def hypersim_scene(imgs, poses, labels: Dict[str, np.ndarray],
                   cam_model: HypersimCamModel, *,
                   normals_depth: bool = False, drop_depth: bool = False,
                   scene_meta: Optional[dict] = None,
                   R_offset: Optional[np.ndarray] = None,
                   img_ids=(), n_classes: int = 0,
                   class_metadata: Optional[dict] = None) -> SceneData:
    """A Hypersim split's `SceneData` from its arrays once its files are
    read (hypersim.py:379-484).

    imgs: (n, H, W, 3) tonemapped rgb; poses: (n, 3, 4) c2w in asset
    units; labels: "depth" (n, H, W) in meters, "normals" (n, H, W, 3),
    "semantics" / "semantics_WF" (n, H, W), at the camera's resolution.
    `normals_depth` adds the normals of the depth labels, `drop_depth`
    then drops the depth labels (asked for only to derive them).
    `scene_meta` may hold the bounds ("scene_boundary"), else they come
    from the depth pointcloud. `R_offset` rotates the scene."""
    n_img = len(poses)
    labels = dict(labels)
    # metric units: depth meters -> asset units (scene.py:299-308)
    if "depth" in labels and cam_model.metric_mode == "asset_units":
        labels["depth"] = labels["depth"] / cam_model.m_per_asset_unit

    # normals from GT depth (scene.py:288-297)
    if normals_depth:
        labels["normals_depth"] = normals_from_depth(
            labels["depth"], cam_model.ray_dirs_cc, poses[:, :3, :])

    # ---------------- scene bounds (scene.py:310-400)
    bnd = {}
    if scene_meta and "scene_boundary" in scene_meta:
        bnd = {k: np.asarray(v, np.float32)
               for k, v in scene_meta["scene_boundary"].items()}
    elif "depth" in labels:
        d_flat = labels["depth"].reshape(n_img, -1)
        P_wc = generate_pointcloud(cam_model.ray_dirs_cc, poses, d_flat)
        pts = P_wc[d_flat != 0.0]
        bnd["xyz_scene_min"] = pts.min(0)
        bnd["xyz_scene_max"] = pts.max(0)
        tr = poses[:, :3, 3]
        bnd["xyz_cam_min"] = tr.min(0)
        bnd["xyz_cam_max"] = tr.max(0)
        cam_scale = bnd["xyz_cam_max"] - bnd["xyz_cam_min"]
        lo = bnd["xyz_scene_min"].copy()
        hi = bnd["xyz_scene_max"].copy()
        A = 1.5
        lo[:2] = np.maximum(lo[:2], (bnd["xyz_cam_min"] - A * cam_scale)[:2])
        hi[:2] = np.minimum(hi[:2], (bnd["xyz_cam_max"] + A * cam_scale)[:2])
        inside = np.all((pts >= lo) & (pts <= hi), axis=-1)
        if inside.any():
            bnd["xyz_cam1p5_min"] = pts[inside].min(0)
            bnd["xyz_cam1p5_max"] = pts[inside].max(0)
    else:
        raise ValueError(
            "need depth labels or scene metadata to establish bounds")

    # prefer the camera-clipped bounds (hypersim.py:57-63)
    if "xyz_cam1p5_min" in bnd:
        xyz_min, xyz_max = bnd["xyz_cam1p5_min"], bnd["xyz_cam1p5_max"]
    else:
        xyz_min, xyz_max = bnd["xyz_scene_min"], bnd["xyz_scene_max"]
    shift = ((xyz_max + xyz_min) / 2).astype(np.float32)
    scale = float((xyz_max - xyz_min).max()) / 2 * 1.05

    poses = poses.astype(np.float32)
    poses[:, :3, 3] = (poses[:, :3, 3] - shift) / (2 * scale)
    xyz_cam_min = (bnd["xyz_cam_min"] - shift) / (2 * scale)
    xyz_cam_max = (bnd["xyz_cam_max"] - shift) / (2 * scale)

    # ---------------- rotation offset (hypersim.py:82-95)
    if R_offset is not None:
        R = np.asarray(R_offset, np.float32)
        poses[:, :3, :3] = R @ poses[:, :3, :3]
        poses[:, :3, 3] = (R @ poses[:, :3, 3:4])[..., 0]
        adjust = 1.6
        poses[:, :3, 3] /= adjust
        scale = scale * adjust
        for k in ("normals", "normals_depth"):
            if k in labels:
                sh = labels[k].shape
                flat = labels[k].reshape(n_img, -1, 3)
                labels[k] = np.einsum("ij,nkj->nki", R, flat).reshape(sh)

    # ---------------- depth clip + rescale (hypersim.py:115-132)
    if "depth" in labels:
        d_flat = labels["depth"].reshape(n_img, -1)
        clipped_bounds = (
            not np.allclose(xyz_min, bnd["xyz_scene_min"])
            or not np.allclose(xyz_max, bnd["xyz_scene_max"])
        )
        if clipped_bounds:
            # pointcloud in the *original* (unshifted) frame
            raw_poses = poses.copy()
            raw_poses[:, :3, 3] = raw_poses[:, :3, 3] * (2 * scale) + shift
            P_wc = generate_pointcloud(cam_model.ray_dirs_cc, raw_poses,
                                       d_flat)
            d_flat = clip_depths_to_bbox(
                d_flat, P_wc, raw_poses,
                np.asarray(xyz_min, np.float32),
                np.asarray(xyz_max, np.float32))
        labels["depth"] = (d_flat / (2 * scale)).astype(np.float32)
    flat_labels = {}
    for k, v in labels.items():
        if drop_depth and k == "depth":
            continue
        flat_labels[k] = v.reshape(n_img, v.shape[1] * v.shape[2], -1) \
            if v.ndim == 4 else v.reshape(n_img, -1)

    return SceneData(
        poses=poses[:, :3, :],
        directions=cam_model.ray_dirs_cc,
        rays=imgs.reshape(n_img, -1, 3),
        img_wh=(cam_model.W, cam_model.H),
        K=None,
        proj=(cam_model.M_ndc_from_cam, cam_model.M_uv_from_ndc,
              shift, scale),
        labels=flat_labels,
        img_ids=list(img_ids),
        n_classes=n_classes,
        class_metadata=class_metadata,
        xyz_cam_min=xyz_cam_min.astype(np.float32),
        xyz_cam_max=xyz_cam_max.astype(np.float32),
        scale=scale,
    )


# ------------------------------------------------------------------ dataset
class HypersimDataset:
    def __init__(self, root_dir: str, split: str = "train",
                 split_factor: float = 0.5, downsample: float = 1.0,
                 load_depth_gt=False, load_norm_gt=False,
                 load_norm_depth_gt=False, load_sem_gt=False,
                 load_sem_WF_gt=False, which_cams=("cam_00",),
                 scene_metadata_path: Optional[str] = None,
                 R_offset: Optional[np.ndarray] = None,
                 seed: int = 0, **kwargs):
        import h5py

        self.scene_name = os.path.basename(root_dir)
        H = round(H_ORIG * downsample)
        W = round(W_ORIG * downsample)
        images_dir = os.path.join(root_dir, "images")

        which_labels = sorted(
            (["depth"] if load_depth_gt else [])
            + (["normals"] if load_norm_gt else [])
            + (["normals_depth"] if load_norm_depth_gt else [])
            + (["semantics"] if load_sem_gt else [])
            + (["semantics_WF"] if load_sem_WF_gt else [])
        )
        if "normals_depth" in which_labels and "depth" not in which_labels:
            which_labels = sorted(which_labels + ["depth"])
            self._drop_depth = True
        else:
            self._drop_depth = False

        # ---------------- metadata: image lists (scene.py:88-126)
        scene_meta = None
        if scene_metadata_path and os.path.isfile(scene_metadata_path):
            with open(scene_metadata_path) as f:
                scene_meta = json.load(f).get(self.scene_name)
        if scene_meta is None:
            rgb_cams = sorted(
                x.name for x in os.scandir(images_dir)
                if "final_hdf5" in x.name)
            rng = random.Random(seed)
            scene_meta = {"cams": {}}
            for rc in rgb_cams:
                names = [x.name for x in os.scandir(os.path.join(images_dir, rc))]
                rng.shuffle(names)
                cam = "_".join(rc.split("_")[1:3])
                scene_meta["cams"][cam] = {"img_names": names}
        self.scene_metadata = scene_meta

        cams = list(which_cams)
        if cams == ["cam_00"] and "cam_00" not in scene_meta["cams"]:
            cams = ["cam_01"]  # hypersim quirk (scene.py:134-139)
        cams = [c for c in scene_meta["cams"] if c in cams]

        # ---------------- split (scene.py:169-190)
        img_ids = []
        for cam in cams:
            ids = []
            for name in scene_meta["cams"][cam]["img_names"]:
                p = os.path.join(images_dir, f"scene_{cam}_final_hdf5", name)
                if os.path.isfile(p) and h5py.is_hdf5(p):
                    ids.append((cam, name.split(".")[1]))
            cut = round(split_factor * len(ids))
            if split.startswith("train"):
                ids = ids[:cut]
            elif split == "test":
                ids = ids[cut:]
            ids.sort()
            img_ids.extend(ids)
        if not img_ids:
            raise FileNotFoundError(f"no images found for {self.scene_name}")

        # ---------------- camera + poses
        cam_model = HypersimCamModel.from_scene(root_dir, self.scene_name,
                                                H, W)
        self.cam_model = cam_model
        by_cam: Dict[str, List[int]] = {}
        for cam, frame in img_ids:
            by_cam.setdefault(cam, []).append(int(frame))
        pose_map = {}
        for cam, frames in by_cam.items():
            ps = cam_model.load_poses(root_dir, cam, frames)
            for f, p in zip(frames, ps):
                pose_map[(cam, f)] = p
        poses = np.stack([pose_map[(c, int(f))] for c, f in img_ids])

        # ---------------- images
        imgs = np.stack([load_image(images_dir, c, f) for c, f in img_ids])
        if (H, W) != (H_ORIG, W_ORIG):
            imgs = _downscale(imgs, "image", H, W)

        # ---------------- labels
        labels: Dict[str, np.ndarray] = {}
        n_classes = 0
        label_meta = {}
        for which in which_labels:
            if which == "normals_depth":
                continue  # derived in hypersim_scene
            raws = []
            for c, f in img_ids:
                r = load_label(images_dir, c, f, which)
                if r is None:
                    if which == "depth":
                        r = np.zeros((H_ORIG, W_ORIG), np.float32)
                    elif which == "normals":
                        r = np.zeros((H_ORIG, W_ORIG, 3), np.float32)
                    else:
                        r = -1 * np.ones((H_ORIG, W_ORIG), np.int64)
                raws.append(r)
            arr = np.stack(raws)
            if which == "depth":
                arr = np.nan_to_num(arr, nan=0.0)
            elif which == "normals":
                arr[np.isnan(np.abs(arr).sum(-1))] = 0.0
            else:
                arr, meta = process_semantics(
                    arr, which, (scene_meta or {}).get("semantic_metadata"))
                label_meta[which] = meta
                n_classes = meta["n_valid_classes_scene"]
            if (H, W) != (H_ORIG, W_ORIG):
                arr = _downscale(arr, which, H, W)
            labels[which] = arr

        self.scene = hypersim_scene(
            imgs, poses, labels, cam_model,
            normals_depth="normals_depth" in which_labels,
            drop_depth=self._drop_depth, scene_meta=scene_meta,
            R_offset=R_offset, img_ids=[f"{c}.{f}" for c, f in img_ids],
            n_classes=n_classes, class_metadata=label_meta or None)

    def load(self) -> SceneData:
        return self.scene
