"""Surface normals from rendered depth via pixel-triangle cross products
(port of the JAX package's `datasets/normals.py`; reference:
datasets/hypersim_src/utils.py:504-611): the ray-batch form of the
training loss and the full-image form of validation."""
from __future__ import annotations

from typing import Dict

import torch


def normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Zero-safe unit normalisation with a NaN-free gradient: the
    double-where keeps sqrt(0) out of the backward of zero vectors
    (degenerate triangles are common on background rays)."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    ok = sq > eps
    safe = torch.where(ok, sq, torch.ones_like(sq))
    return torch.where(ok, v / torch.sqrt(safe), torch.zeros_like(v))


def extract_normals_from_ray_batch(rays_o, rays_d, depth,
                                   x123_idx: Dict[str, torch.Tensor]):
    """(M, 3) rays + (M,) depth -> (T, 3) unit normals, one per triangle
    (x1, x2, x3) of the batch."""
    P = rays_o + rays_d * depth[:, None]
    P1 = P[x123_idx["x1"]]
    P2 = P[x123_idx["x2"]]
    P3 = P[x123_idx["x3"]]
    n = torch.linalg.cross(P2 - P1, P3 - P1, dim=-1)
    return normalize(n)


def extract_normals_from_depth_batch(depth, ray_dirs_cc, poses):
    """Full-image normals from depth (reference: utils.py:543-611).

    depth: (B, H, W); ray_dirs_cc: (H*W, 3) camera-frame ray directions;
    poses: (B, 3, 4) (or (B, 4, 4)) camera-to-world. Returns (B, H, W, 3)
    world-frame unit normals, zero on the 1-pixel border and wherever the
    depth is 0, NaN or infinite.
    """
    B, H, W = depth.shape
    P = (ray_dirs_cc[None, :, :] * depth.reshape(B, H * W, 1)).reshape(B, H, W, 3)
    P1 = P[:, 1:-1, 1:-1]
    P2 = P[:, :-2, 1:-1]
    P3 = P[:, 1:-1, :-2]
    n = normalize(torch.linalg.cross(P2 - P1, P3 - P1, dim=-1))
    # camera -> world frame (orientation only)
    n = torch.einsum("bij,bhwj->bhwi", poses[:, :3, :3], n)
    n = torch.nn.functional.pad(n, (0, 0, 1, 1, 1, 1))
    invalid = (depth == 0.0) | torch.isnan(depth) | torch.isinf(depth)
    return torch.where(invalid[..., None], torch.zeros_like(n), n)


def normals_from_depth(depth, ray_dirs_cc, poses):
    """`extract_normals_from_depth_batch` on host numpy arrays, on the CPU
    (the loaders' labels); returns numpy."""
    return extract_normals_from_depth_batch(
        torch.as_tensor(depth), torch.as_tensor(ray_dirs_cc),
        torch.as_tensor(poses)).numpy()
