"""Supervoxel-run march (kernel K1's plain versions) against the JAX
package's `march_rays_train_dense_sv` and `march_rays_test_round_sv`.

Tolerance: none. t, dt, valid, ray_count, rm_samples, the truncated-ray
count and the test round's next cursor must be identical: the port
repeats the reference's arithmetic in the same order, so a sample on a
cell or supervoxel boundary lands in the same cell.
"""
import numpy as np
import pytest
import torch

from test_torch_common import J, N, T

from normal_clustering_nerf_torch.models.occupancy import supervoxel_tables
from normal_clustering_nerf_torch.ops import ray_march as tm
from normal_clustering_nerf_tpu.ops import ray_march as jm
from normal_clustering_nerf_tpu.ops.ray_aabb import (
    ray_aabb_intersect as j_aabb,
)

SCALE = 0.5


def _bitfield(rng, G, density):
    """Random cells plus, above 1% density, solid blocks and a wall shell,
    so that rays cross many occupied supervoxels. Below it, most occupied
    supervoxels hold a cell or two that a ray crossing them misses."""
    occ = rng.random((G, G, G)) < density
    if density < 0.01:
        flat = occ.transpose(2, 1, 0).reshape(-1, 8)
        return np.packbits(flat, axis=-1, bitorder="little").reshape(-1)
    b = G // 4
    occ[b:2 * b, b:2 * b, :] = True
    occ[:, 2 * b:3 * b, b:3 * b] = True
    w = max(G // 16, 1)
    occ[:w] = occ[-w:] = True
    flat = occ.transpose(2, 1, 0).reshape(-1, 8)
    return np.packbits(flat, axis=-1, bitorder="little").reshape(-1)


def _inputs(seed, n, G, density):
    rng = np.random.default_rng(seed)
    bitfield = _bitfield(rng, G, density)
    o = rng.uniform(-0.45, 0.45, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[:4] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, 1], [1, 1, 0]],
                     np.float32) / np.array([[1], [1], [1], [np.sqrt(2)]],
                                            np.float32)
    hits = np.asarray(j_aabb(J(o), J(d), J(np.zeros(3, np.float32)),
                             J(np.full(3, SCALE, np.float32))))
    t1 = np.where((hits[:, 0] >= 0) & (hits[:, 0] < 0.01), 0.01, hits[:, 0])
    hits = np.stack([t1, hits[:, 1]], -1).astype(np.float32)
    hits[4:6] = -1.0                     # rays that miss
    noise = rng.random(n).astype(np.float32)
    mask, payload = supervoxel_tables(T(bitfield), G)
    return o, d, hits, bitfield, noise, N(mask), N(payload)


# The reference runs eagerly and compiles each op once per shape, so the
# G = 32 cases share two interval budgets (4, and the auto-full 12).
@pytest.mark.parametrize("G,tail_k,n_intervals,density", [
    (32, 16, 4, 0.2),      # bench form (full tail), truncating budget
    (32, 0, 4, 0.003),     # first-K, truncating budget, sparse cells
    (32, 4, 4, 0.5),       # K1 = 12 verbatim + 4 strided, truncating
    (32, 16, 0, 0.2),      # auto-full horizon: nothing truncates
    (32, 0, 0, 0.05),      # first-K, auto-full
    (32, 4, 0, 0.5),       # 12 verbatim + 4 strided, auto-full
    (128, 16, 24, 0.02),   # the bench's grid and sv_intervals
])
def test_sv_train_march_matches_jax_exactly(G, tail_k, n_intervals,
                                            density):
    o, d, hits, _, noise, mask, payload = _inputs(G + tail_k + n_intervals,
                                                  64, G, density)
    kw = dict(scale=SCALE, grid_size=G, max_samples=1024,
              samples_per_ray=16, march_steps=1024, n_intervals=n_intervals,
              tail_k=tail_k)
    ref = jm.march_rays_train_dense_sv(J(o), J(d), J(hits), J(mask),
                                       J(payload), J(noise), **kw)
    out = tm.march_rays_train_dense_sv(T(o), T(d), T(hits), T(mask),
                                       T(payload), T(noise), **kw)
    np.testing.assert_array_equal(N(out.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(N(out.t), np.asarray(ref.t))
    np.testing.assert_array_equal(N(out.dt), np.asarray(ref.dt))
    np.testing.assert_array_equal(N(out.ray_count), np.asarray(ref.ray_count))
    assert int(out.rm_samples) == int(ref.rm_samples) > 0
    assert int(out.trunc_rays) == int(ref.trunc_rays)
    if n_intervals == 4:
        assert int(out.trunc_rays) > 0       # the budget did cut rays
    if n_intervals == 0:
        assert int(out.trunc_rays) == 0


def test_sv_march_equals_the_bitfield_march():
    """With every supervoxel run enumerated, the sv march keeps the same
    samples as the bootstrap (bitfield) march over the same S = max_samples
    steps (the JAX suite's tests/test_ray_march.py:269 on the port)."""
    G = 32
    o, d, hits, bitfield, noise, mask, payload = _inputs(3, 64, G, 0.03)
    common = dict(scale=SCALE, grid_size=G, max_samples=256,
                  samples_per_ray=16, tail_k=16)
    dense = tm.march_rays_train_dense(T(o), T(d), T(hits), T(bitfield),
                                      T(noise), cascades=1,
                                      exp_step_factor=0.0, **common)
    sv = tm.march_rays_train_dense_sv(T(o), T(d), T(hits), T(mask),
                                      T(payload), T(noise), n_intervals=0,
                                      **common)
    assert int(sv.trunc_rays) == 0
    for name in ("valid", "t", "dt", "ray_count"):
        assert torch.equal(getattr(sv, name), getattr(dense, name)), name
    assert int(sv.ray_count.sum()) > 0


@pytest.mark.parametrize("G,n_steps,n_intervals", [
    (32, 8, 4), (32, 64, 12), (128, 32, 24),
])
def test_sv_test_rounds_match_jax_exactly(G, n_steps, n_intervals):
    """Three rounds from the rays' near points; each round's samples and
    next cursor must be identical (the cursor carries the round)."""
    o, d, hits, _, _, mask, payload = _inputs(G + n_steps, 64, G, 0.2)
    t1, t2 = hits[:, 0], hits[:, 1]
    alive = t1 >= 0
    alive[7] = False                      # a finished ray keeps its cursor
    cur_j = cur_t = t1
    kw = dict(scale=SCALE, grid_size=G, max_samples=1024, n_steps=n_steps,
              n_intervals=n_intervals)
    full = 0
    for _ in range(3):
        ref = jm.march_rays_test_round_sv(J(o), J(d), J(cur_j), J(t2),
                                          J(alive), J(mask), J(payload), **kw)
        out = tm.march_rays_test_round_sv(T(o), T(d), T(cur_t), T(t2),
                                          T(alive), T(mask), T(payload), **kw)
        for a, b, name in zip(out, ref, ("t", "dt", "valid", "cursor")):
            np.testing.assert_array_equal(N(a), np.asarray(b), err_msg=name)
        full += int((N(out[2]).sum(1) == n_steps).sum())
        cur_j, cur_t = np.asarray(ref[3]), N(out[3])
    assert full > 0                       # some rounds filled all K slots
    assert cur_t[7] == t1[7]


def test_sv_march_refuses_what_the_reference_cannot_do():
    """A grid not divisible by 8 has no supervoxels; a test round has no
    auto-full interval budget (the JAX version fails on 0)."""
    o, d, hits, _, noise, mask, payload = _inputs(0, 8, 32, 0.2)
    with pytest.raises(ValueError):
        tm.march_rays_train_dense_sv(
            T(o), T(d), T(hits), T(mask), T(payload), T(noise), scale=SCALE,
            grid_size=36, max_samples=1024, samples_per_ray=16)
    with pytest.raises(ValueError):
        tm.march_rays_test_round_sv(
            T(o), T(d), T(hits[:, 0]), T(hits[:, 1]),
            torch.ones(8, dtype=torch.bool), T(mask), T(payload),
            scale=SCALE, grid_size=32, max_samples=1024, n_steps=8,
            n_intervals=0)
