"""Prediction images and prediction archives (the port's copy of the JAX
package's `training/visualize.py`; reference: train_nerf.py:74-82
depth2img, :553-676 the panels, :736-805 the tar.gz export), in numpy and
the standard library: the card's machine has no cv2.

Task colouring: depth through the Turbo colormap over the fixed [0, 1.74]
~ sqrt(3) range, normals as (n + 1) / 2, semantics through a label
colormap. The JAX version colours and resizes with cv2; here the Turbo
table is cv2's `COLORMAP_TURBO` written out (RGB), and the resize repeats
cv2's uint8 arithmetic: INTER_LINEAR with pixel-centre mapping and 11-bit
fixed-point weights, rounded half up (at a factor of 0.5 on even sizes,
cv2's 2x2 area mean, which is the same sum), and INTER_NEAREST for the
semantic maps. cv2 vectorises the vertical pass in another fixed-point
order, so at other factors a pixel may differ from cv2's by 1. PNGs are
8-bit RGB, written with zlib (filter 0).
"""
from __future__ import annotations

import io
import os
import struct
import tarfile
import zlib
from typing import Dict, List

import numpy as np

# cv2.applyColorMap(np.arange(256, dtype=np.uint8), cv2.COLORMAP_TURBO),
# BGR -> RGB: the published Turbo colormap, 256 RGB triples
TURBO_RGB = np.array([
    48, 18, 59, 50, 21, 67, 51, 24, 74, 52, 27, 81, 53, 30, 88, 54, 33, 95, 55, 36, 102, 56, 39, 109,
    57, 42, 115, 58, 45, 121, 59, 47, 128, 60, 50, 134, 61, 53, 139, 62, 56, 145, 63, 59, 151, 63, 62, 156,
    64, 64, 162, 65, 67, 167, 65, 70, 172, 66, 73, 177, 66, 75, 181, 67, 78, 186, 68, 81, 191, 68, 84, 195,
    68, 86, 199, 69, 89, 203, 69, 92, 207, 69, 94, 211, 70, 97, 214, 70, 100, 218, 70, 102, 221, 70, 105, 224,
    70, 107, 227, 71, 110, 230, 71, 113, 233, 71, 115, 235, 71, 118, 238, 71, 120, 240, 71, 123, 242, 70, 125, 244,
    70, 128, 246, 70, 130, 248, 70, 133, 250, 70, 135, 251, 69, 138, 252, 69, 140, 253, 68, 143, 254, 67, 145, 254,
    66, 148, 255, 65, 150, 255, 64, 153, 255, 62, 155, 254, 61, 158, 254, 59, 160, 253, 58, 163, 252, 56, 165, 251,
    55, 168, 250, 53, 171, 248, 51, 173, 247, 49, 175, 245, 47, 178, 244, 46, 180, 242, 44, 183, 240, 42, 185, 238,
    40, 188, 235, 39, 190, 233, 37, 192, 231, 35, 195, 228, 34, 197, 226, 32, 199, 223, 31, 201, 221, 30, 203, 218,
    28, 205, 216, 27, 208, 213, 26, 210, 210, 26, 212, 208, 25, 213, 205, 24, 215, 202, 24, 217, 200, 24, 219, 197,
    24, 221, 194, 24, 222, 192, 24, 224, 189, 25, 226, 187, 25, 227, 185, 26, 228, 182, 28, 230, 180, 29, 231, 178,
    31, 233, 175, 32, 234, 172, 34, 235, 170, 37, 236, 167, 39, 238, 164, 42, 239, 161, 44, 240, 158, 47, 241, 155,
    50, 242, 152, 53, 243, 148, 56, 244, 145, 60, 245, 142, 63, 246, 138, 67, 247, 135, 70, 248, 132, 74, 248, 128,
    78, 249, 125, 82, 250, 122, 85, 250, 118, 89, 251, 115, 93, 252, 111, 97, 252, 108, 101, 253, 105, 105, 253, 102,
    109, 254, 98, 113, 254, 95, 117, 254, 92, 121, 254, 89, 125, 255, 86, 128, 255, 83, 132, 255, 81, 136, 255, 78,
    139, 255, 75, 143, 255, 73, 146, 255, 71, 150, 254, 68, 153, 254, 66, 156, 254, 64, 159, 253, 63, 161, 253, 61,
    164, 252, 60, 167, 252, 58, 169, 251, 57, 172, 251, 56, 175, 250, 55, 177, 249, 54, 180, 248, 54, 183, 247, 53,
    185, 246, 53, 188, 245, 52, 190, 244, 52, 193, 243, 52, 195, 241, 52, 198, 240, 52, 200, 239, 52, 203, 237, 52,
    205, 236, 52, 208, 234, 52, 210, 233, 53, 212, 231, 53, 215, 229, 53, 217, 228, 54, 219, 226, 54, 221, 224, 55,
    223, 223, 55, 225, 221, 55, 227, 219, 56, 229, 217, 56, 231, 215, 57, 233, 213, 57, 235, 211, 57, 236, 209, 58,
    238, 207, 58, 239, 205, 58, 241, 203, 58, 242, 201, 58, 244, 199, 58, 245, 197, 58, 246, 195, 58, 247, 193, 58,
    248, 190, 57, 249, 188, 57, 250, 186, 57, 251, 184, 56, 251, 182, 55, 252, 179, 54, 252, 177, 54, 253, 174, 53,
    253, 172, 52, 254, 169, 51, 254, 167, 50, 254, 164, 49, 254, 161, 48, 254, 158, 47, 254, 155, 45, 254, 153, 44,
    254, 150, 43, 254, 147, 42, 254, 144, 41, 253, 141, 39, 253, 138, 38, 252, 135, 37, 252, 132, 35, 251, 129, 34,
    251, 126, 33, 250, 123, 31, 249, 120, 30, 249, 117, 29, 248, 114, 28, 247, 111, 26, 246, 108, 25, 245, 105, 24,
    244, 102, 23, 243, 99, 21, 242, 96, 20, 241, 93, 19, 240, 91, 18, 239, 88, 17, 237, 85, 16, 236, 83, 15,
    235, 80, 14, 234, 78, 13, 232, 75, 12, 231, 73, 12, 229, 71, 11, 228, 69, 10, 226, 67, 10, 225, 65, 9,
    223, 63, 8, 221, 61, 8, 220, 59, 7, 218, 57, 7, 216, 55, 6, 214, 53, 6, 212, 51, 5, 210, 49, 5,
    208, 47, 5, 206, 45, 4, 204, 43, 4, 202, 42, 4, 200, 40, 3, 197, 38, 3, 195, 37, 3, 193, 35, 2,
    190, 33, 2, 188, 32, 2, 185, 30, 2, 183, 29, 2, 180, 27, 1, 178, 26, 1, 175, 24, 1, 172, 23, 1,
    169, 22, 1, 167, 20, 1, 164, 19, 1, 161, 18, 1, 158, 16, 1, 155, 15, 1, 152, 14, 1, 149, 13, 1,
    146, 11, 1, 142, 10, 1, 139, 9, 2, 136, 8, 2, 133, 7, 2, 129, 6, 2, 126, 5, 2, 122, 4, 3,
], np.uint8).reshape(256, 3)
_RESIZE_BITS = 11   # cv2's INTER_RESIZE_COEF_BITS


def label_colormap(n: int) -> np.ndarray:
    """Pascal-VOC-style colormap (the imgviz convention the reference
    uses, train_nerf.py:660)."""
    cmap = np.zeros((max(n, 1), 3), np.uint8)
    for i in range(max(n, 1)):
        r = g = b = 0
        c = i
        for j in range(8):
            r |= ((c >> 0) & 1) << (7 - j)
            g |= ((c >> 1) & 1) << (7 - j)
            b |= ((c >> 2) & 1) << (7 - j)
            c >>= 3
        cmap[i] = [r, g, b]
    return cmap


def depth2img(depth, vmin=0.0, vmax=1.74):
    """Turbo-colormapped depth (reference: train_nerf.py:74-82; range
    fixed to the unit-cube diagonal), RGB."""
    d = np.clip((depth - vmin) / (vmax - vmin), 0, 1)
    return TURBO_RGB[(d * 255).astype(np.uint8)]


def pred_to_vis(pred: np.ndarray, which: str, n_classes: int = 3) -> np.ndarray:
    """One prediction map -> uint8 RGB (train_nerf.py:650-670)."""
    if which == "depth":
        return depth2img(pred)
    if which in ("norm_nn", "norm_depth", "normals", "normals_depth"):
        norm = np.linalg.norm(pred, axis=-1, keepdims=True)
        unit = np.where(np.abs(pred).sum(-1, keepdims=True) == 0,
                        pred, pred / np.maximum(norm, 1e-12))
        return ((unit + 1.0) / 2.0 * 255).astype(np.uint8)
    if which in ("sem", "semantics", "sem_WF", "semantics_WF"):
        if pred.ndim == 3:
            pred = np.argmax(pred, axis=-1)
        return label_colormap(n_classes + 1)[pred.astype(np.int64)]
    if which == "rgb":
        return (np.clip(pred, 0, 1) * 255).astype(np.uint8)
    if which == "opacity":
        g = (np.clip(pred, 0, 1) * 255).astype(np.uint8)
        return np.repeat(g[..., None], 3, axis=-1)
    raise NotImplementedError(which)


def _linear_taps(n_src: int, n_dst: int):
    """cv2's INTER_LINEAR taps along one axis: the source index of each
    output pixel's first tap, its neighbour (clamped) and their 11-bit
    weights, each rounded on its own as cv2 rounds them."""
    scale = 1.0 / (n_dst / n_src)
    f = ((np.arange(n_dst) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = f - i0.astype(np.float32)
    low, high = i0 < 0, i0 >= n_src - 1
    f[low | high] = 0.0
    i0 = np.clip(i0, 0, n_src - 1)
    one = np.float32(1 << _RESIZE_BITS)
    w0 = np.rint((np.float32(1.0) - f) * one).astype(np.int64)
    w1 = np.rint(f * one).astype(np.int64)
    return i0, np.minimum(i0 + 1, n_src - 1), w0, w1


def resize_linear(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_LINEAR) of a uint8
    (H, W, C) image, in cv2's fixed point (see the module note)."""
    x0, x1, a0, a1 = _linear_taps(img.shape[1], w)
    y0, y1, b0, b1 = _linear_taps(img.shape[0], h)
    src = img.astype(np.int64)
    rows = src[:, x0] * a0[None, :, None] + src[:, x1] * a1[None, :, None]
    out = (rows[y0] * b0[:, None, None] + rows[y1] * b1[:, None, None]
           + (1 << (2 * _RESIZE_BITS - 1))) >> (2 * _RESIZE_BITS)
    return np.clip(out, 0, 255).astype(np.uint8)


def resize_nearest(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """cv2.resize(img, (w, h), interpolation=INTER_NEAREST): source pixel
    floor(dst * src / dst_size), clamped."""
    def idx(n_src, n_dst):
        scale = 1.0 / (n_dst / n_src)
        return np.minimum(np.floor(np.arange(n_dst) * scale).astype(np.int64),
                          n_src - 1)
    return img[idx(img.shape[0], h)][:, idx(img.shape[1], w)]


def pack_vis_panel(pred_dict: Dict[str, np.ndarray], n_classes: int = 3,
                   downsample: float = 1.0) -> np.ndarray:
    """Horizontal concat of all task visualizations, key-sorted
    (train_nerf.py:570-581)."""
    panels = []
    for k in sorted(pred_dict):
        if k in ("total_samples",):
            continue
        vis = pred_to_vis(pred_dict[k], k, n_classes)
        if downsample != 1.0:
            h, w = vis.shape[:2]
            resize = resize_nearest if "sem" in k else resize_linear
            vis = resize(vis, int(w * downsample), int(h * downsample))
        panels.append(vis)
    return np.concatenate(panels, axis=1)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_vis_png(path: str, panel: np.ndarray):
    """An (H, W, 3) uint8 RGB panel as an 8-bit RGB PNG (each row filter
    0, zlib-compressed)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    panel = np.ascontiguousarray(panel, np.uint8)
    h, w = panel.shape[:2]
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          panel.reshape(h, w * 3)], axis=1)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                  0, 0, 0))
                + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
                + _png_chunk(b"IEND", b""))


def save_preds_tar_gz(save_dir: str, save_dict: Dict[str, List[np.ndarray]],
                      img_ids: List[str], which_split: str, tag: str,
                      scene_name: str = "scene"):
    """`{split}_{tag}.tar.gz` of .npy predictions + `.done` marker
    (reference: train_nerf.py:781-805)."""
    os.makedirs(save_dir, exist_ok=True)
    tar_fname = f"{which_split}_{tag}"
    tar_path = os.path.join(save_dir, f"{tar_fname}.tar.gz")
    with tarfile.open(tar_path, "w:gz") as tar:
        for k, preds in save_dict.items():
            if k == "opacity":
                continue
            k_name = {"sem": "semantics", "norm": "normals"}.get(k, k)
            for pred, img_id in zip(preds, img_ids):
                b = io.BytesIO()
                np.save(b, pred)
                b.seek(0)
                info = tarfile.TarInfo(
                    name=f"{tag}.{which_split}.{k_name}.{scene_name}.{img_id}.npy")
                info.size = len(b.getvalue())
                tar.addfile(tarinfo=info, fileobj=b)
                b.close()
    with open(os.path.join(save_dir, f"{tar_fname}.done"), "w"):
        pass
    return tar_path
