"""Occupancy grid of the port against the JAX package's
`models/occupancy.py`: the supervoxel tables, both refresh forms with the
JAX draws (cells, jitter) handed in, and camera-coverage marking.

Tolerance: none — every output must be identical. The density function
used here is piecewise constant with dyadic values, so the grid mean
that sets the threshold is exact in f32 in both frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, J, N, T

from normal_clustering_nerf_torch.config import ModelConfig as TM
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.models import occupancy as to
from normal_clustering_nerf_tpu.config import ModelConfig as JM
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.models import occupancy as jo

G = 32
THR = 0.01 * 1024 / np.sqrt(3.0)


def _density_j(xyz):
    q = (jnp.floor(xyz[:, 0] * 8) + 3 * jnp.floor(xyz[:, 1] * 8)
         + 5 * jnp.floor(xyz[:, 2] * 8))
    return jnp.mod(q, 9.0) / 8.0 * 12.0


def _density_t(xyz):
    q = (torch.floor(xyz[:, 0] * 8) + 3 * torch.floor(xyz[:, 1] * 8)
         + 5 * torch.floor(xyz[:, 2] * 8))
    return torch.remainder(q, 9.0) / 8.0 * 12.0


def _grids():
    return (jo.OccupancyGrid(JM(grid_size=G)),
            to.OccupancyGrid(TM(grid_size=G), CPU))


def _state_pair(seed, scale_grid):
    """A JAX state with invisible cells and earlier densities, and its
    port copy."""
    rng = np.random.default_rng(seed)
    jg, _ = _grids()
    st = jg.init_state()
    grid = (rng.integers(0, 16, (1, G ** 3)) / 8.0 * scale_grid)
    grid[:, rng.random(G ** 3) < 0.1] = -1.0
    st = st._replace(density_grid=J(grid, jnp.float32))
    return st, to.OccupancyState(*(T(getattr(st, f))
                                   for f in to.OccupancyState._fields))


def _assert_states_equal(out, ref):
    """Every field of the JAX state, in its order, the tables the refresh
    rebuilds (the dilated coarse mask coarse_occ, sv_mask, sv_payload)
    included."""
    assert to.OccupancyState._fields == jo.OccupancyState._fields
    for name in to.OccupancyState._fields:
        np.testing.assert_array_equal(N(getattr(out, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


def test_supervoxel_tables_and_coarse_mask():
    rng = np.random.default_rng(0)
    bits = (rng.random(G ** 3) < 0.02).reshape(-1, 8)
    bf = np.packbits(bits, axis=-1, bitorder="little").reshape(-1)
    m_ref, p_ref = jo.supervoxel_tables(J(bf), G)
    m, p = to.supervoxel_tables(T(bf), G)
    np.testing.assert_array_equal(N(m), np.asarray(m_ref))
    np.testing.assert_array_equal(N(p), np.asarray(p_ref))
    assert (np.asarray(p_ref) < 0).any()          # bit 31 words seen
    np.testing.assert_array_equal(N(to.coarse_occupancy(T(bf), G)),
                                  np.asarray(jo.coarse_occupancy(J(bf), G)))


def test_warmup_update_with_injected_jitter():
    jg, tg = _grids()
    st_j, st_t = _state_pair(1, 1.0)
    key = jax.random.PRNGKey(7)
    ref = jg.update(st_j, _density_j, key, THR, warmup=True)
    coords = jg.cell_coords(jnp.arange(G ** 3, dtype=jnp.int32))
    jitter = np.asarray(jax.random.uniform(jax.random.fold_in(key, 0),
                                           coords.shape))[None]
    out = tg.update(st_t, _density_t, THR, warmup=True, jitter=T(jitter))
    _assert_states_equal(out, ref)
    assert int(N(out.density_bitfield).astype(bool).sum()) > 0
    assert int(N(out.sv_mask).sum()) > 0
    assert (N(out.coarse_occ) >= N(out.sv_mask)).all()   # dilated


@pytest.mark.parametrize("scale_grid", [1.0, 0.0])
def test_sampled_update_with_injected_cells(scale_grid):
    """scale_grid 0: no cell is above the threshold, so the occupied
    draw falls back to uniform cells (occupancy.py:169-172)."""
    jg, tg = _grids()
    st_j, st_t = _state_pair(2, scale_grid)
    key = jax.random.PRNGKey(11)
    ref = jg.update(st_j, _density_j, key, THR, warmup=False)
    # the JAX draws, replayed (occupancy.py:155-172, 207-211)
    k_cells, k_jit = jax.random.split(key)
    k_u, k_o = jax.random.split(k_cells, 2)
    M = G ** 3 // 4
    n_occ = int(jnp.sum(st_j.density_grid[0] > THR))
    uni = np.asarray(jax.random.randint(k_u, (M,), 0, G ** 3))
    if n_occ > 0:
        occ = np.asarray(jax.random.randint(k_o, (M,), 0, n_occ))
    else:
        occ = np.asarray(jax.random.randint(jax.random.fold_in(k_o, 1),
                                            (M,), 0, G ** 3))
    jitter = np.asarray(jax.random.uniform(jax.random.fold_in(k_jit, 0),
                                           (2 * M, 3)))[None]
    out = tg.update(st_t, _density_t, THR, warmup=False, jitter=T(jitter),
                    cell_draws={"uniform": uni[None], "occ_rank": occ[None]})
    _assert_states_equal(out, ref)


def test_sampled_update_with_own_draws_runs():
    _, tg = _grids()
    _, st_t = _state_pair(3, 1.0)
    out = tg.update(st_t, _density_t, THR, warmup=False,
                    generator=torch.Generator().manual_seed(0))
    assert out.density_grid.shape == (1, G ** 3)
    assert bool((out.density_grid[st_t.density_grid < 0] == -1).all())


def test_mark_invisible_cells_matches_jax():
    sj = JSyn(split="train", img_wh=(24, 24), n_images=6).load()
    stt = TSyn(split="train", img_wh=(24, 24), n_images=6).load()
    np.testing.assert_array_equal(stt.poses, sj.poses)
    jg, tg = _grids()
    ref = jg.mark_invisible_cells(jg.init_state(), J(sj.poses), sj.img_wh,
                                  0.01, K=np.asarray(sj.K))
    out = tg.mark_invisible_cells(tg.init_state(), stt.poses, stt.img_wh,
                                  0.01, stt.K)
    _assert_states_equal(out, ref)
    assert (N(out.density_grid) == -1).any() and (N(out.density_grid) == 0).any()


def test_mark_invisible_cells_with_proj_matches_jax():
    """Hypersim's projection matrices (occupancy.py:240-291, the `proj`
    tuple) on the smoke's Hypersim-camera room at 64 x 48, 8 views: the
    marks and the coverage fractions equal JAX's."""
    import chip_smoke
    scene, _ = chip_smoke.hypersim_split((64, 48), 8, 2)
    jg, tg = _grids()
    proj = tuple(np.asarray(p, np.float32) if not np.isscalar(p)
                 else float(p) for p in scene.proj)
    ref = jg.mark_invisible_cells(jg.init_state(), J(scene.poses),
                                  scene.img_wh, 0.01, proj=proj)
    out = tg.mark_invisible_cells(tg.init_state(), scene.poses,
                                  scene.img_wh, 0.01, proj=scene.proj)
    _assert_states_equal(out, ref)
    d = N(out.density_grid)
    assert (d == -1).any() and (d == 0).any()
    assert 0 < N(out.count_grid).max() <= 1
