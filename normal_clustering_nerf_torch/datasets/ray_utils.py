"""Camera-ray geometry: numpy at dataset set-up, torch in the train step.

Same conventions as the JAX package's `datasets/ray_utils.py`: camera
looks down +z, pixel centres at +0.5, directions not normalised.
"""
from __future__ import annotations

import numpy as np
import torch


def get_ray_directions(H, W, K, random=False, rng=None, flatten=True):
    """Pinhole per-pixel ray directions in the camera frame
    [right down front] (reference: datasets/ray_utils.py:8-42).
    Returns (H*W, 3) float32 (or (H, W, 3) when flatten=False)."""
    u, v = np.meshgrid(
        np.arange(W, dtype=np.float32),
        np.arange(H, dtype=np.float32),
        indexing="xy",
    )
    K = np.asarray(K)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    if random:
        rng = rng or np.random.default_rng(0)
        ju = rng.uniform(size=u.shape).astype(np.float32)
        jv = rng.uniform(size=v.shape).astype(np.float32)
        dirs = np.stack([(u - cx + ju) / fx, (v - cy + jv) / fy,
                         np.ones_like(u)], -1)
    else:
        dirs = np.stack([(u - cx + 0.5) / fx, (v - cy + 0.5) / fy,
                         np.ones_like(u)], -1)
    dirs = dirs.astype(np.float32)
    if flatten:
        return dirs.reshape(-1, 3)
    return dirs


def get_rays(directions: torch.Tensor, c2w: torch.Tensor):
    """Camera-frame dirs + pose(s) -> world rays
    (reference: datasets/ray_utils.py:46-71).

    directions: (N, 3); c2w: (3, 4) or (N, 3, 4).
    Returns rays_o (N, 3), rays_d (N, 3) (not normalised).
    """
    if c2w.ndim == 2:
        rays_d = directions @ c2w[:, :3].T
        rays_o = c2w[:, 3].expand_as(rays_d)
    else:
        rays_d = torch.einsum("nij,nj->ni", c2w[..., :3], directions)
        rays_o = c2w[..., 3]
    return rays_o, rays_d
