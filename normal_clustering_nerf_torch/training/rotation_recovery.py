"""Manhattan-frame rotation recovery from clustered depth normals — port of
the JAX package's `training/rotation_recovery.py` (reference:
train_nerf.py:489-528).

All test-view depth normals are clustered (K = 30, 30 iterations, with
the port's `ops/kmeans.normals_clustering`), the three dominant
centroids form a frame, its columns and signs are matched to the applied
R_offset, and the per-axis (yaw, pitch, roll) errors are reported. The
k-means initial draws of each restart are separable: `init_draws` takes
them (a test hands in the JAX package's), else `generator` draws them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..ops.kmeans import draw_init, normals_clustering
from ..utils.rotations import matrix_to_euler_angles, project_to_SO3


def recover_rotation(normals: np.ndarray, *, K: int = 30, niter: int = 30,
                     t_similar: float = 0.99, restarts: int = 3,
                     init_draws: Optional[Sequence] = None,
                     generator: Optional[torch.Generator] = None,
                     device=None) -> np.ndarray:
    """The (3, 3) frame (columns) of the three dominant orthogonal
    clusters, SO(3)-projected, of the restart that best explains the
    data: the highest mean |n . nearest frame axis| over the valid
    normals. Raises ValueError when fewer than 3 normals are valid."""
    normals = np.asarray(normals, np.float32).reshape(-1, 3)
    norms = np.linalg.norm(normals, axis=-1)
    valid = (norms > 1e-6) & np.isfinite(norms)
    n = normals.copy()
    n[valid] /= norms[valid][:, None]
    nv = n[valid]
    if nv.shape[0] < 3:
        raise ValueError(f"rotation recovery needs >= 3 valid normals, "
                         f"got {nv.shape[0]}")
    n_t = torch.as_tensor(n, device=device)
    valid_t = torch.as_tensor(valid, device=device)
    best_R, best_score = None, -np.inf
    for r in range(restarts):
        init = (init_draws[r] if init_draws is not None
                else draw_init(valid_t, K, generator))
        res = normals_clustering(n_t, valid_t, K=K, niter=niter,
                                 t_similar=t_similar, init_idx=init)
        C = res.centroids3.cpu().numpy().astype(np.float64).T
        if np.linalg.det(C) < 0:
            # the normals fix the axes only up to sign: flip a column of a
            # left-handed triple instead of projecting it (rotation_recovery.py:54-62)
            C[:, 2] *= -1.0
        R = project_to_SO3(C)
        score = float(np.mean(np.max(np.abs(nv @ R), axis=-1)))
        if score > best_score:
            best_score, best_R = score, R
    return best_R


def rotation_recovery_errors(normals: np.ndarray, R_offset: np.ndarray, *,
                             init_draws: Optional[Sequence] = None,
                             generator: Optional[torch.Generator] = None,
                             device=None) -> Dict[str, float]:
    """Per-axis angular error (degrees) of the recovered Manhattan frame
    against the applied offset (train_nerf.py:504-528): greedy column
    matching with sign freedom, then the proper-rotation sign choice
    closest to R_offset, then the ZYX angles of the residual."""
    R_rec = recover_rotation(normals, init_draws=init_draws,
                             generator=generator, device=device)
    R_off = np.asarray(R_offset, np.float64)
    cols, used = [], set()
    for j in range(3):
        _, best = max((abs(float(R_rec[:, i] @ R_off[:, j])), i)
                      for i in range(3) if i not in used)
        used.add(best)
        sign = np.sign(float(R_rec[:, best] @ R_off[:, j])) or 1.0
        cols.append(sign * R_rec[:, best])
    M = np.stack(cols, axis=1)
    candidates = []
    for flips in ((), (0,), (1,), (2,), (0, 1), (0, 2), (1, 2), (0, 1, 2)):
        Mc = M.copy()
        for f in flips:
            Mc[:, f] *= -1.0
        if np.linalg.det(Mc) <= 0:
            continue
        Rc = project_to_SO3(Mc)
        cos = np.clip((np.trace(Rc @ R_off.T) - 1.0) / 2.0, -1.0, 1.0)
        candidates.append((float(np.arccos(cos)), Rc))
    R_matched = min(candidates, key=lambda t: t[0])[1]
    ang = matrix_to_euler_angles(R_matched @ R_off.T, "ZYX") * 180.0 / math.pi
    return {
        "ang/clust/yaw_abs": abs(float(ang[0])),
        "ang/clust/pitch_abs": abs(float(ang[1])),
        "ang/clust/roll_abs": abs(float(ang[2])),
    }
