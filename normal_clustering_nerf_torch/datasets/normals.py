"""Surface normals from rendered depth via pixel-triangle cross products
(port of the JAX package's `datasets/normals.py`; reference:
datasets/hypersim_src/utils.py:504-541)."""
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
