"""Rotation conversions in numpy (the port's copy of the JAX package's
`utils/rotations.py`; reference: train_nerf.py:55-65, 512-513).
Conventions match pytorch3d: intrinsic rotations composed left to right
per convention letter, e.g. 'ZYX' -> Rz @ Ry @ Rx."""
from __future__ import annotations

import numpy as np


def _axis_rot(axis: str, angle):
    c, s = np.cos(angle), np.sin(angle)
    if axis == "X":
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])
    if axis == "Y":
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    if axis == "Z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    raise ValueError(axis)


def euler_angles_to_matrix(angles, convention: str = "ZYX"):
    """(3,) euler angles -> (3, 3) rotation (pytorch3d semantics)."""
    angles = np.asarray(angles, np.float64)
    R = np.eye(3)
    for axis, a in zip(convention, angles):
        R = R @ _axis_rot(axis, a)
    return R


def matrix_to_euler_angles(R, convention: str = "ZYX"):
    """Inverse of euler_angles_to_matrix for 'ZYX', the only convention
    the validation uses (train_nerf.py:521)."""
    R = np.asarray(R, np.float64)
    if convention != "ZYX":
        raise NotImplementedError(convention)
    # R = Rz(a) Ry(b) Rx(c)
    b = -np.arcsin(np.clip(R[2, 0], -1.0, 1.0))
    if abs(np.cos(b)) > 1e-8:
        a = np.arctan2(R[1, 0], R[0, 0])
        c = np.arctan2(R[2, 1], R[2, 2])
    else:  # gimbal lock
        a = np.arctan2(-R[0, 1], R[1, 1])
        c = 0.0
    return np.array([a, b, c])


def project_to_SO3(M):
    """Nearest rotation matrix by SVD (the reference round-trips through
    scipy's Rotation.from_matrix, train_nerf.py:512-513)."""
    U, _, Vt = np.linalg.svd(np.asarray(M, np.float64))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt
