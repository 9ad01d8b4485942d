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


def R_offset_from_angles(yaw_deg, pitch_deg, roll_deg):
    """Scene rotation offset from yaw / pitch / roll in degrees (ZYX), or
    None when all are zero (reference: train_nerf.py:109-122 builds it
    from the loss_norm_*_offset_ang flags and hands it to the dataset)."""
    ang = np.array([yaw_deg, pitch_deg, roll_deg], np.float64) * np.pi / 180.0
    if np.all(ang == 0):
        return None
    return euler_angles_to_matrix(ang, "ZYX").astype(np.float32)


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


def matrix_to_quaternion(R):
    """(3, 3) -> (w, x, y, z) unit quaternion: the trace form where the
    trace is positive, else the form of the largest diagonal entry."""
    R = np.asarray(R, np.float64)
    t = np.trace(R)
    if t > 0:
        r = np.sqrt(1 + t)
        w = 0.5 * r
        x = (R[2, 1] - R[1, 2]) / (2 * r)
        y = (R[0, 2] - R[2, 0]) / (2 * r)
        z = (R[1, 0] - R[0, 1]) / (2 * r)
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1 + R[i, i] - R[j, j] - R[k, k])
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / (2 * r)
        q[i + 1] = 0.5 * r
        q[j + 1] = (R[j, i] + R[i, j]) / (2 * r)
        q[k + 1] = (R[k, i] + R[i, k]) / (2 * r)
        w, x, y, z = q
    q = np.array([w, x, y, z])
    return q / np.linalg.norm(q)


def quaternion_to_matrix(q):
    """(w, x, y, z), normalised first -> (3, 3)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def project_to_SO3(M):
    """Nearest rotation matrix by SVD (the reference round-trips through
    scipy's Rotation.from_matrix, train_nerf.py:512-513)."""
    U, _, Vt = np.linalg.svd(np.asarray(M, np.float64))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt
