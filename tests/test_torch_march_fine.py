"""The bitfield march without supervoxel runs (kernels H9, H10, H11: their
plain versions) against the JAX package's `ops/ray_march.py`: the fine
march at S = 1024 steps, the two-level coarse march (with the truncation
counter), the dense and the windowed test rounds, `compact_samples`, and
the flat `march_rays_train` / `march_rays_test_round`.

Tolerance: none. Sample sets (t, dt, valid), counts, rm_samples,
trunc_rays and cursors must be identical: the port repeats the
reference's arithmetic in its order, and the JAX side runs eagerly (under
jit XLA contracts t0 + k*lo into an FMA, which moves boundary samples).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import J, N, T

from normal_clustering_nerf_torch.models import occupancy as to
from normal_clustering_nerf_torch.ops import ray_march as tm
from normal_clustering_nerf_tpu.models import occupancy as jo
from normal_clustering_nerf_tpu.ops import ray_march as jm
from normal_clustering_nerf_tpu.ops.ray_aabb import ray_aabb_intersect

G, MAX_S, NR = 32, 1024, 96
MK = dict(cascades=1, scale=0.5, exp_step_factor=0.0, grid_size=G,
          max_samples=MAX_S)


def _inputs(seed, density=0.3, clutter=False):
    """Rays from inside and around the box (a few miss it), a bitfield of
    random cells with a solid block, or test_truncation.py's clutter of
    thin z-planes every 8 cells, and its coarse mask (JAX's)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-0.6, 0.6, (NR, 3)).astype(np.float32)
    d = rng.standard_normal((NR, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hits = np.asarray(ray_aabb_intersect(J(o), J(d), jnp.zeros(3),
                                         jnp.full(3, 0.5)))
    if clutter:
        occ = np.zeros((G, G, G), bool)
        occ[:, :, ::8] = True
    else:
        occ = rng.random((G, G, G)) < density
        occ[10:20, 10:20, 10:20] = True
    bits = np.packbits(occ.transpose(2, 1, 0).reshape(-1), bitorder="little")
    coarse = np.asarray(jo.coarse_occupancy(J(bits), G))
    noise = rng.random(NR).astype(np.float32)
    return o, d, hits, bits, coarse, noise


def _assert_dense_equal(out, ref, trunc=True):
    for k in ("t", "dt", "valid", "ray_count"):
        np.testing.assert_array_equal(N(getattr(out, k)),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    assert int(out.rm_samples) == int(ref.rm_samples)
    if trunc:
        assert int(out.trunc_rays) == int(ref.trunc_rays)


@pytest.mark.parametrize("tail_k", [16, 0, -1])
def test_fine_march_matches_jax(tail_k):
    """The bench's march after the bootstrap without the sv march: 1024
    steps of sqrt(3)/1024, K 16, the full stratified tail or first-K."""
    o, d, hits, bits, _, noise = _inputs(tail_k + 2)
    kw = dict(MK, samples_per_ray=16, march_steps=MAX_S, tail_k=tail_k)
    ref = jm.march_rays_train_dense(J(o), J(d), J(hits), J(bits), J(noise),
                                    **kw)
    out = tm.march_rays_train_dense(T(o), T(d), T(hits), T(bits), T(noise),
                                    **kw)
    _assert_dense_equal(out, ref)
    assert int(out.trunc_rays) == 0
    assert int(N(out.ray_count).min()) == 0 < int(N(out.ray_count).max())


@pytest.mark.parametrize("clutter,kb,tail_k", [
    (True, 2, 16),     # 8 slots < K: the first two candidate blocks only
    (True, 5, 0),      # first-K: only under-filled rays are counted
    (False, 0, 16),    # default KB = max(2K/4, 8)
])
def test_two_level_march_matches_jax(clutter, kb, tail_k):
    o, d, hits, bits, coarse, noise = _inputs(7, 0.15, clutter)
    kw = dict(MK, samples_per_ray=16, march_steps=MAX_S,
              coarse_k_blocks=kb, tail_k=tail_k)
    ref = jm.march_rays_train_dense(J(o), J(d), J(hits), J(bits), J(noise),
                                    coarse_occ=J(coarse), **kw)
    out = tm.march_rays_train_dense(T(o), T(d), T(hits), T(bits), T(noise),
                                    coarse_occ=T(coarse), **kw)
    _assert_dense_equal(out, ref)
    assert out.t.shape[1] == (min(16, 4 * kb) if kb else 16)
    if clutter:
        assert int(out.trunc_rays) > 0
    # the port's refresh builds the same mask
    np.testing.assert_array_equal(N(to.coarse_occupancy(T(bits), G)), coarse)


def _cursor_rounds(fn_t, fn_j, o, d, hits, bits, rounds=3):
    """Rounds from the box's near end, each from the cursors the last
    returned; an eighth of the rays dead."""
    cur, far = hits[:, 0], hits[:, 1]
    alive = cur >= 0
    alive[::8] = False
    for _ in range(rounds):
        ref = fn_j(J(o), J(d), J(cur), J(far), J(alive), J(bits))
        out = fn_t(T(o), T(d), T(cur), T(far), T(alive), T(bits))
        for i, name in enumerate(("t", "dt", "valid", "cursor")):
            np.testing.assert_array_equal(N(out[i]), np.asarray(ref[i]),
                                          err_msg=name)
        cur = np.asarray(ref[3])
        alive = alive & (cur < far)
    return out


def test_dense_test_round_matches_jax():
    o, d, hits, bits, _, _ = _inputs(3)
    kw = dict(MK, n_steps=64)
    out = _cursor_rounds(
        lambda *a: tm.march_rays_test_round_dense(*a, **kw),
        lambda *a: jm.march_rays_test_round_dense(*a, **kw),
        o, d, hits, bits)
    assert int(out[2].sum()) > 0


def _jax_window_round(ro, rd, cur, far, sel, bitfield, *, S_march, K):
    """The JAX bucket round's non-sv march (rendering.py:332-353),
    verbatim but for the occupancy tables dict."""
    mkw = dict(exp_step_factor=0.0, max_samples=MAX_S, grid_size=G,
               scale=0.5)
    tg_ext = jm.t_step_grid(cur, S_march + 1, **mkw)
    tg = tg_ext[:, :S_march]
    dtg = jm.calc_dt(tg, 0.0, MAX_S, G, 0.5)
    xyz = ro[:, None, :] + tg[..., None] * rd[:, None, :]
    occ = jm.occupancy_lookup(xyz, dtg, bitfield, cascades=1, scale=0.5,
                              grid_size=G)
    include = (occ & sel[:, None] & (cur >= 0)[:, None]
               & (tg < far[:, None]))
    sidx, svalid = jm.select_first_k(include, K)
    t_k = jnp.where(svalid, jnp.take_along_axis(tg, sidx, axis=1), 0.0)
    dt_k = jnp.where(svalid, jnp.take_along_axis(dtg, sidx, axis=1), 0.0)
    n_found = jnp.sum(svalid, axis=-1)
    last_col = jnp.where(n_found >= K, sidx[:, K - 1] + 1, S_march)
    new_cur = jnp.take_along_axis(tg_ext, last_col[:, None], axis=1)[:, 0]
    return t_k, dt_k, svalid, new_cur


@pytest.mark.parametrize("K", [16, 64])
def test_window_round_matches_jax(K):
    """K 16 of a 64-step window (most rays find K), and K = the window."""
    o, d, hits, bits, _, _ = _inputs(4, 0.1)
    out = _cursor_rounds(
        lambda *a: tm.march_rays_test_round_window(*a, **MK, S_march=64,
                                                   n_steps=K),
        lambda *a: _jax_window_round(*a, S_march=64, K=K),
        o, d, hits, bits)
    assert int(out[2].sum()) > 0
    with pytest.raises(ValueError, match="S_march"):
        tm.march_rays_test_round_window(
            T(o), T(d), T(hits[:, 0]), T(hits[:, 1]), T(hits[:, 0] >= 0),
            T(bits), **MK, S_march=8, n_steps=16)


def _assert_compact_equal(out, ref):
    for k in ("ray_id", "t", "dt", "valid", "ray_start", "ray_count",
              "rm_samples"):
        np.testing.assert_array_equal(N(getattr(out, k)),
                                      np.asarray(getattr(ref, k)), err_msg=k)


@pytest.mark.parametrize("budget", [3000, 700])
def test_compact_samples_matches_jax(budget):
    """A budget that holds every sample and one that drops the tail."""
    rng = np.random.default_rng(5)
    inc = rng.random((NR, 64)) < rng.random((NR, 1)) * 0.4
    tg = rng.random((NR, 64)).astype(np.float32)
    dtg = rng.random((NR, 64)).astype(np.float32)
    ref = jm.compact_samples(J(inc), J(tg), J(dtg), budget)
    out = tm.compact_samples(T(inc), T(tg), T(dtg), budget)
    _assert_compact_equal(out, ref)
    assert (int(out.rm_samples) > budget) == (budget == 700)


@pytest.mark.parametrize("budget,tail_k", [(16 * NR, 16), (900, 0)])
def test_flat_march_matches_jax(budget, tail_k):
    """The flat training march: the bench's per-ray cap with the full
    tail, and a budget that drops samples (first-K)."""
    o, d, hits, bits, _, noise = _inputs(6)
    kw = dict(MK, sample_budget=budget, march_steps=MAX_S, per_ray_cap=16,
              tail_k=tail_k)
    ref = jm.march_rays_train(J(o), J(d), J(hits), J(bits), J(noise), **kw)
    out = tm.march_rays_train(T(o), T(d), T(hits), T(bits), T(noise), **kw)
    _assert_compact_equal(out, ref)
    if budget == 900:
        assert int(out.rm_samples) > 900


def test_flat_test_round_matches_jax():
    o, d, hits, bits, _, _ = _inputs(8)
    cur, far = hits[:, 0], hits[:, 1]
    alive = cur >= 0
    kw = dict(MK, n_steps=64, sample_budget=NR * 64)
    for _ in range(2):
        ref, rc = jm.march_rays_test_round(J(o), J(d), J(cur), J(far),
                                           J(alive), J(bits), **kw)
        out, oc = tm.march_rays_test_round(T(o), T(d), T(cur), T(far),
                                           T(alive), T(bits), **kw)
        _assert_compact_equal(out, ref)
        np.testing.assert_array_equal(N(oc), np.asarray(rc))
        cur = np.asarray(rc)
        alive = alive & (cur < far)


def _face_points(rng, scale, cells):
    """(n, 3) f32 positions in the box of half-size `scale`, each
    coordinate on a face of a grid of `cells` cells a side or a few ulps
    off it (the rest uniform), where x / mb and x * (1 / mb) round apart."""
    mb = np.float32(min(0.5, scale))
    faces = (mb * (2.0 * np.arange(cells + 1) / cells - 1.0)).astype(np.float32)
    near = [faces]
    for k in (1, 2, 3):
        near += [np.nextafter(faces, np.float32(np.inf)),
                 np.nextafter(faces, np.float32(-np.inf))]
        faces = near[-2]
    vals = np.concatenate(near).astype(np.float32)
    pts = rng.uniform(-mb, mb, (vals.size * 3, 3)).astype(np.float32)
    for a in range(3):
        pts[a * vals.size:(a + 1) * vals.size, a] = vals
    return pts


def _cells(x, mb, cells, reciprocal):
    q = x * (np.float32(1.0) / mb) if reciprocal else x / mb
    v = np.float32(0.5) * (q + np.float32(1.0)) * np.float32(cells)
    return np.clip(v, 0, cells - 1).astype(np.int64)


@pytest.mark.parametrize("scale", [0.3, 0.5])
def test_lookups_divide_as_jax(scale):
    """`occupancy_lookup` and `coarse_lookup` at a scale whose mip bound
    is not a power of two (0.3) and at the bench's (0.5), on positions at
    and next to the cell faces of the fine and the coarse grid, against
    the JAX functions bit for bit (the coarse mask at grid 8G, so that it
    has G cells a side too). At 0.3 the positions include some whose cell
    a product with the reciprocal would move (the card's division by a
    Python scalar): both functions divide through `_div`."""
    rng = np.random.default_rng(31)
    mb = np.float32(min(0.5, scale))
    bits = rng.integers(0, 256, G ** 3 // 8, dtype=np.uint8)
    coarse = rng.integers(0, 2, G ** 3, dtype=np.uint8)
    cells = G
    for fn in ("occupancy", "coarse"):
        xyz = _face_points(rng, scale, cells)
        moved = (_cells(xyz, mb, cells, True)
                 != _cells(xyz, mb, cells, False)).any(-1).sum()
        assert (moved > 0) == (scale == 0.3), (fn, moved)
        if fn == "occupancy":
            got = tm.occupancy_lookup(T(xyz), T(bits), cascades=1,
                                      scale=scale, grid_size=G)
            ref = jm.occupancy_lookup(J(xyz), jnp.zeros(xyz.shape[0]),
                                      J(bits), cascades=1, scale=scale,
                                      grid_size=G)
        else:
            got = tm.coarse_lookup(T(xyz), T(coarse), scale=scale,
                                   grid_size=8 * G)
            ref = jm.coarse_lookup(J(xyz), J(coarse), scale=scale,
                                   grid_size=8 * G)
        np.testing.assert_array_equal(N(got), np.asarray(ref), err_msg=fn)
