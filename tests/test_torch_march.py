"""Bootstrap march (kernel H1's plain version) against the JAX package's
`march_rays_train_dense` with coarse_occ=None.

Tolerance: none. t, dt, valid, ray_count and rm_samples must be
identical — the port repeats the reference's arithmetic in the same
order, so every sample at a cell boundary selects the same cell.
"""
import numpy as np
import pytest
import torch

from test_torch_common import J, N, T, random_rays

from normal_clustering_nerf_torch.ops import ray_march as tm
from normal_clustering_nerf_torch.ops.ray_aabb import (
    ray_aabb_intersect as t_aabb,
)
from normal_clustering_nerf_tpu.ops import ray_march as jm
from normal_clustering_nerf_tpu.ops.ray_aabb import (
    ray_aabb_intersect as j_aabb,
)


def _inputs(seed, n, G, density):
    rng = np.random.default_rng(seed)
    o, d = random_rays(rng, n)
    hits = np.asarray(j_aabb(J(o), J(d), J(np.zeros(3, np.float32)),
                             J(np.full(3, 0.5, np.float32))))
    # near clamp as render_train applies it; some rays miss outright
    t1 = np.where((hits[:, 0] >= 0) & (hits[:, 0] < 0.01), 0.01, hits[:, 0])
    hits = np.stack([t1, hits[:, 1]], -1).astype(np.float32)
    hits[:3] = -1.0
    bits = (rng.random(G ** 3) < density).reshape(-1, 8)
    bitfield = np.packbits(bits, axis=-1, bitorder="little").reshape(-1)
    noise = rng.random(n).astype(np.float32)
    return o, d, hits, bitfield, noise


@pytest.mark.parametrize("G,tail_k,density", [
    (32, 16, 0.5),    # bench form: full stratified tail, K1 = 0
    (32, 0, 0.5),     # first-K cap
    (32, 4, 0.9),     # K1 = 12 verbatim + 4 strided
    (128, 16, 0.3),   # the bench's 128^3 grid
])
def test_bootstrap_march_matches_jax_exactly(G, tail_k, density):
    o, d, hits, bitfield, noise = _inputs(G + tail_k, 257, G, density)
    kw = dict(cascades=1, scale=0.5, exp_step_factor=0.0, grid_size=G,
              max_samples=128, samples_per_ray=16, march_steps=128,
              tail_k=tail_k)
    ref = jm.march_rays_train_dense(J(o), J(d), J(hits), J(bitfield),
                                    J(noise), **kw)
    out = tm.march_rays_train_dense(T(o), T(d), T(hits), T(bitfield),
                                    T(noise), **kw)
    np.testing.assert_array_equal(N(out.valid), np.asarray(ref.valid))
    np.testing.assert_array_equal(N(out.t), np.asarray(ref.t))
    np.testing.assert_array_equal(N(out.dt), np.asarray(ref.dt))
    np.testing.assert_array_equal(N(out.ray_count), np.asarray(ref.ray_count))
    assert int(out.rm_samples) == int(ref.rm_samples)
    assert int(out.trunc_rays) == 0
    assert int(out.ray_count.sum()) > 0


@pytest.mark.parametrize("tail_k", [0, 4, 16, 20])
def test_rank_targets_select_the_stratified_set(tail_k):
    """The closed form kernel H1 emits (rank_targets) keeps the same
    samples, in the same slots and with the same spans, as
    stratified_budget + select_first_k, which the plain version runs."""
    rng = np.random.default_rng(tail_k)
    K, S = 16, 128
    include = torch.as_tensor(rng.random((300, S)) < rng.random((300, 1)))
    sel, span = tm.stratified_budget(include, K, tail_k)
    idx, valid = tm.select_first_k(sel, K)
    m_tot = include.sum(-1)
    targets, tspan = tm.rank_targets(m_tot, K, tail_k)
    rank = torch.cumsum(include.long(), -1)
    for n in range(include.shape[0]):
        v = valid[n]
        steps = idx[n][v]
        assert torch.equal(rank[n][steps], targets[n][v]), n
        assert torch.equal(span[n][steps], tspan[n][v]), n
        assert int(v.sum()) == int((targets[n] <= m_tot[n]).sum()), n


def test_rank_targets_matches_jax():
    rng = np.random.default_rng(3)
    m = rng.integers(0, 200, 64).astype(np.int32)
    for tail_k in (0, 5, 16):
        t_ref, s_ref = jm.rank_targets(J(m), 16, tail_k)
        t_out, s_out = tm.rank_targets(T(m), 16, tail_k)
        np.testing.assert_array_equal(N(t_out), np.asarray(t_ref))
        np.testing.assert_array_equal(N(s_out), np.asarray(s_ref))


def test_march_through_the_aabb_port():
    """hits from the port's ray_aabb_intersect are those of JAX, so the
    march input of the render path agrees too (exact)."""
    rng = np.random.default_rng(5)
    o, d = random_rays(rng, 500)
    o[:50] *= 4.0                  # some origins outside the cube
    c, h = np.zeros(3, np.float32), np.full(3, 0.5, np.float32)
    ref = j_aabb(J(o), J(d), J(c), J(h))
    out = t_aabb(T(o), T(d), T(c), T(h))
    np.testing.assert_array_equal(N(out), np.asarray(ref))


def test_kernel_wrapper_refuses_non_uniform_steps():
    """The call once refused (the geometric step grid, exp_step_factor
    1/256) now runs: each ray's kept t grow, and dt is calc_dt(t) where
    valid (no stratified tail, so no span scales it)."""
    o, d, hits, bitfield, noise = _inputs(0, 8, 32, 0.5)
    kw = dict(cascades=1, scale=2.0, exp_step_factor=1 / 256, grid_size=32,
              max_samples=1024)
    out = tm.march_rays_train_dense(
        T(o), T(d), T(hits), T(bitfield), T(noise), **kw,
        samples_per_ray=16, march_steps=128)
    v = out.valid
    assert int(v.sum()) > 0
    t = torch.where(v, out.t, torch.full_like(out.t, float("inf")))
    assert bool((torch.diff(t, dim=1)[v[:, 1:]] > 0).all())
    dt = tm.calc_dt(out.t, kw["exp_step_factor"], kw["max_samples"], 32, 2.0)
    assert torch.equal(out.dt[v], dt[v])


def test_bootstrap_march_is_a_launcher_of_the_fine_march():
    """H1 runs H9's warp-per-ray body: its launcher sits in march_fine.cu
    beside H9's, and the thread-per-ray march.cu is gone."""
    from normal_clustering_nerf_torch import kernels
    assert kernels.MARCH.name == "march_bootstrap"
    assert kernels.MARCH.source == "march_fine.cu"
    assert kernels.MARCH.source == kernels.MARCH_FINE_TRAIN.source
    assert not (kernels.CSRC / "march.cu").exists()
    src = (kernels.CSRC / "march_fine.cu").read_text()
    assert 'extern "C" int march_bootstrap(' in src
