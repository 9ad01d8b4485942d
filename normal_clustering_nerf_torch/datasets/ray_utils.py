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


def axisangle_to_R(v: torch.Tensor) -> torch.Tensor:
    """Rodrigues axis-angle -> rotation matrix (JAX
    `datasets/ray_utils.py:68-90`; reference: datasets/ray_utils.py:75-101):
    R = I + sin|v|/|v| [v]x + (1 - cos|v|)/|v|^2 [v]x^2 with |v| + 1e-7 in
    place of |v|, in the same order of operations. v (3,) or (B, 3) ->
    (3, 3) or (B, 3, 3).

    At v = 0 the norm's gradient is taken as 0 (PyTorch's, and the
    reference's, convention for the norm of the zero vector). JAX's
    `jnp.linalg.norm` gives NaN there, so a JAX step from the zero
    initialisation of dR turns every parameter to NaN; the port keeps the
    reference's finite gradient, which equals JAX's wherever JAX's is
    finite."""
    single = v.ndim == 1
    if single:
        v = v[None]
    zero = torch.zeros_like(v[:, :1])
    skew = torch.stack([
        torch.cat([zero, -v[:, 2:3], v[:, 1:2]], 1),
        torch.cat([v[:, 2:3], zero, -v[:, 0:1]], 1),
        torch.cat([-v[:, 1:2], v[:, 0:1], zero], 1),
    ], dim=1)
    norm = torch.linalg.norm(v, dim=1)[:, None, None] + 1e-7
    eye = torch.eye(3, dtype=v.dtype, device=v.device)[None]
    R = (eye + (torch.sin(norm) / norm) * skew
         + ((1 - torch.cos(norm)) / norm ** 2) * (skew @ skew))
    return R[0] if single else R
