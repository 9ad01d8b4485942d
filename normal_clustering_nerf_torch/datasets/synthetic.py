"""Procedural Manhattan-room scene with exact ground truth.

The framework's in-memory test/benchmark fixture (SURVEY.md §7 build
order item 1: "synthetic in-memory scene fixture"): an axis-aligned
room interior rendered analytically, giving exact RGB, depth, surface
normals, and wall/floor semantics — so unit tests and benchmarks can
verify the full multi-task pipeline (including the Manhattan clustering
losses, whose optimum is known: the three wall-axis normals) without
any dataset download. Plays the role of the reference's hardcoded
debug scene (reference: train_nerf.py:813-866).
"""
from __future__ import annotations

import numpy as np

from .base import SceneData
from .ray_utils import get_ray_directions

# inward-facing wall planes of the room [-R, R]^3: (axis, sign)
_WALLS = [
    (0, 1.0), (0, -1.0),   # x walls
    (1, 1.0), (1, -1.0),   # y walls (y+ = floor in cam convention [right down front])
    (2, 1.0), (2, -1.0),   # z walls
]
_WALL_COLORS = np.array([
    [0.85, 0.30, 0.25],
    [0.25, 0.60, 0.85],
    [0.80, 0.75, 0.30],
    [0.35, 0.80, 0.40],
    [0.75, 0.35, 0.75],
    [0.90, 0.60, 0.25],
], np.float32)
# semantics_WF convention (reference: hypersim_src/utils.py:199-221):
# wall=1, floor=2, rest=3
_WALL_SEM = np.array([1, 1, 2, 3, 1, 1], np.int32)


def _trace_room(rays_o, rays_d, R):
    """Closed-form ray cast against the room interior walls.

    Returns rgb (N,3), depth (N,), normal (N,3) world frame, sem (N,)."""
    N = rays_o.shape[0]
    best_t = np.full(N, np.inf, np.float32)
    hit_wall = np.zeros(N, np.int32)
    for w, (axis, sign) in enumerate(_WALLS):
        denom = rays_d[:, axis]
        t = (sign * R - rays_o[:, axis]) / np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        p = rays_o + t[:, None] * rays_d
        other = [a for a in range(3) if a != axis]
        inside = (
            (t > 1e-4)
            & (np.abs(p[:, other[0]]) <= R + 1e-5)
            & (np.abs(p[:, other[1]]) <= R + 1e-5)
        )
        closer = inside & (t < best_t)
        best_t = np.where(closer, t, best_t)
        hit_wall = np.where(closer, w, hit_wall)

    p = rays_o + best_t[:, None] * rays_d
    rgb = _WALL_COLORS[hit_wall]
    # Band-limited multi-octave texture so the radiance field has
    # detail to learn AND depth is identifiable at pixel scale.
    # Deliberately NOT a hard checkerboard: step-edge textures are
    # unresolvable at grazing incidence (a pixel ray crosses several
    # tiles within one integration step dt), which capped train-view
    # PSNR at ~19 dB under the crossing camera rig — an aliasing floor
    # of the GT, not a model failure (round-3 diagnosis).
    #
    # The fine octaves are load-bearing for the Manhattan-clustering
    # benchmark (round-5 diagnosis): with only the 0.25-wavelength
    # base octave, a 0.015-unit depth error changes wall color by
    # ~0.3% — rendered depth wandered at ~3x the pixel footprint and
    # depth-triangle normals were noise (58 deg mean on a perfect
    # room), so the clustering loss had no signal to grab. Octaves at
    # 0.1/0.05 wavelength (~20/10 px per cycle at typical viewing
    # distance) pin depth at the pixel scale while staying above the
    # grazing-incidence aliasing floor.
    def _oct(freq, amp, ph):
        return amp * (
            np.sin(2 * np.pi * freq * p[:, 0] + ph)
            + np.sin(2 * np.pi * freq * p[:, 1] + ph + 0.7)
            + np.sin(2 * np.pi * freq * p[:, 2] + ph + 1.9)
        ) / 3.0
    tex = (_oct(4, 1.0, 0.0) + _oct(10, 0.55, 2.1) + _oct(20, 0.3, 4.4)) / 1.85
    rgb = rgb * (0.675 + 0.325 * tex[:, None])
    normals = np.zeros((N, 3), np.float32)
    for w, (axis, sign) in enumerate(_WALLS):
        normals[hit_wall == w, axis] = -sign  # inward
    sem = _WALL_SEM[hit_wall]
    depth = best_t.astype(np.float32)
    return rgb.astype(np.float32), depth, normals, sem


def _lookat_pose(position, target, up):
    vec2 = target - position
    vec2 = vec2 / np.linalg.norm(vec2)
    vec0 = np.cross(up, vec2)
    vec0 = vec0 / np.linalg.norm(vec0)
    vec1 = np.cross(vec2, vec0)
    return np.stack([vec0, vec1, vec2, position], axis=1).astype(np.float32)


class SyntheticDataset:
    """Reference-shaped dataset interface over the procedural room."""

    def __init__(self, split="train", img_wh=(64, 64), n_images=12,
                 room_half=0.4, scale=0.5, seed=0, R_offset=None, **kwargs):
        rng = np.random.default_rng(seed + (1 if split != "train" else 0))
        W, H = img_wh
        fx = fy = 0.8 * W
        K = np.array([[fx, 0, W / 2], [0, fy, H / 2], [0, 0, 1]], np.float32)
        directions = get_ray_directions(H, W, K)

        # Camera rig: an inward-CROSSING ring — cameras on a ring at
        # ~half the room radius, each looking across the room at the
        # opposite wall (with azimuth/elevation jitter), like a person
        # photographing a room from near its walls. This gives every
        # wall patch BOTH multi-view overlap (adjacent cameras share
        # most of the opposite wall) AND positional parallax (the
        # observing positions span a wide arc) — the two properties
        # that make geometry identifiable. Two degenerate rigs were
        # diagnosed and rejected in round 3: all-cameras-at-the-center
        # looking outward (overlap without parallax -> per-camera fog
        # billboards memorize train views via view-dependent color) and
        # scattered cameras with random directions (parallax without
        # overlap -> a sparse-view problem the reference only meets in
        # its hardest ablation).
        poses = []
        for i in range(n_images):
            phi = 2 * np.pi * i / n_images + rng.uniform(
                0, 2 * np.pi / max(n_images, 1))
            r = rng.uniform(0.45, 0.6) * room_half
            y = rng.uniform(-0.35, 0.35) * room_half
            pos = np.array([r * np.cos(phi), y, r * np.sin(phi)], np.float32)
            phi_t = phi + np.pi + rng.uniform(-0.5, 0.5)
            elev_t = rng.uniform(-0.35, 0.35)
            target = np.array([
                np.cos(phi_t) * np.cos(elev_t), np.sin(elev_t),
                np.sin(phi_t) * np.cos(elev_t),
            ], np.float32) * room_half
            poses.append(_lookat_pose(pos, target, np.array([0.0, -1.0, 0.0])))
        poses = np.stack(poses)

        rays, depths, normals, sems = [], [], [], []
        for i in range(n_images):
            rd = directions @ poses[i][:, :3].T
            ro = np.broadcast_to(poses[i][:, 3], rd.shape)
            rgb, depth, nrm, sem = _trace_room(ro, rd, room_half)
            rays.append(rgb)
            depths.append(depth)
            normals.append(nrm)
            sems.append(sem)
        depths = [np.asarray(d) for d in depths]
        normals = [np.asarray(n) for n in normals]

        # Scene rotation offset — same semantics as the Hypersim loader
        # (reference: datasets/hypersim.py:82-95): the captured images
        # stay fixed; poses and normal labels rotate, and translations
        # shrink by the reference's 1.6 fudge so the rotated room's
        # corners stay inside the [-scale, scale]^3 cube. Depth labels
        # scale with the translations.
        if R_offset is not None:
            R = np.asarray(R_offset, np.float32)
            adjust = 1.6
            poses = poses.copy()
            poses[:, :, :3] = np.einsum("ij,njk->nik", R, poses[:, :, :3])
            poses[:, :, 3] = poses[:, :, 3] @ R.T / adjust
            depths = [d / adjust for d in depths]
            normals = [n @ R.T for n in normals]

        self.scene = SceneData(
            poses=poses,
            directions=directions.astype(np.float32),
            rays=np.stack(rays),
            img_wh=img_wh,
            K=K,
            labels={
                "depth": np.stack(depths),
                "normals": np.stack(normals),
                "normals_depth": np.stack(normals),
                "semantics": np.stack(sems),
                "semantics_WF": np.stack(sems),
            },
            img_ids=[f"syn_{split}_{i:03d}" for i in range(n_images)],
            n_classes=3,
            xyz_cam_min=poses[:, :, 3].min(0).astype(np.float32),
            xyz_cam_max=poses[:, :, 3].max(0).astype(np.float32),
            scale=scale,
        )
        self.split = split

    def load(self) -> SceneData:
        return self.scene
