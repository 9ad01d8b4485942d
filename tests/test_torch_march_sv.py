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


LO = np.float32(np.sqrt(3.0) / 1024)    # the lattice step at max_samples 1024


def _adversarial(seed, n, G, density):
    """`_inputs`' random rays with rays 0-39 replaced by the cases a sorted
    merge of plane crossings must get right (kernel K1's phase A):
      0-7    axis-parallel, and components of magnitude < 1e-9 (the
             crossing divides by 1e-9 while the position moves by d);
      8-15   diagonals with equal components from equal coordinates: the
             planes of two or three axes are crossed at the same t, at
             supervoxel edges and corners;
      16-23  hit rays whose noise puts t0 at or past t_end (t2 = t0, t2
             between t1 and t0, t2 = t1, t2 just below t1);
      24-31  rays along z at x = y = -c*1e-9: the x and y planes through 0
             are "crossed" at t = c by the 1e-9 denominator, together, so
             the piece there is invalid (b1 = b0) and the next one is the
             same supervoxel again, which the reference counts anew;
      32-39  the same with d_y > 0 (only the x crossing is spurious: two
             adjacent valid pieces of one supervoxel, the second dropped).
    The rest cross many occupied supervoxels, so a small interval budget
    truncates them."""
    o, d, hits, bitfield, noise, mask, payload = _inputs(seed, n, G, density)
    rng = np.random.default_rng(seed + 1)
    f32 = np.float32
    o[:40] = rng.uniform(-0.4, 0.4, (40, 3))
    d[:6] = np.eye(3)[[0, 1, 2, 0, 1, 2]] * np.array([1, 1, 1, -1, -1, -1])[:, None]
    d[6] = [4e-10, -7e-10, 1.0]
    d[7] = [1.0, 0.0, -3e-10]
    o[8:16] = rng.choice([-0.25, 0.0, 0.25], 8)[:, None]
    o[12:16, 2] = rng.uniform(-0.4, 0.4, 4)
    d[8:12] = np.array([1, -1, 1, -1])[:, None] * f32(1.0 / np.sqrt(3.0))
    d[12:16] = [[0.6, 0.6, 0.53], [-0.6, -0.6, 0.53], [0.6, 0.6, -0.1],
                [-0.6, -0.6, -0.1]]
    d[12:16] /= np.linalg.norm(d[12:16], axis=1, keepdims=True)
    o[24:40, :2] = (-rng.uniform(0.1, 0.8, 16) * 1e-9)[:, None]
    o[24:40, 2] = -0.45
    o[32:40, 1] = -0.3
    d[24:32] = [0.0, 0.0, 1.0]
    d[32:40] = [0.0, 0.6, 0.8]
    hits[:40] = [0.01, 0.9]
    noise[16:24] = rng.uniform(0.25, 1.0, 8)
    t1 = hits[16:24, 0]
    t0 = t1 + LO * noise[16:24]             # the march's t0, in f32
    hits[16:24, 1] = [t0[0], t0[1], 0.5 * (t1[2] + t0[2]), t1[3],
                      t1[4] - f32(1e-6), t0[5], 0.5 * (t1[6] + t0[6]), t1[7]]
    return o, d, hits, bitfield, noise, mask, payload


def _classes(o, d, hits, noise, mask, G, n_intervals, train):
    """How many rays of each `_adversarial` kind the march meets
    (`sv_ray_kinds`, the count the card's check uses too)."""
    o, d, hits = T(o), T(d), T(hits)
    t1, t2 = hits[:, 0], hits[:, 1]
    hit = t1 >= 0
    lo = float(np.sqrt(3.0) / 1024)
    ninf = torch.full_like(t2, -float("inf"))
    if train:
        t0 = t1 + lo * T(noise)
        t_end = torch.where(hit, torch.minimum(t2, t0 + 1024 * lo), ninf)
    else:
        t0, t_end = t1, torch.where(hit, t2, ninf)
    return tm.sv_ray_kinds(o, d, t0, t_end, hit, T(mask), scale=SCALE,
                           grid_size=G, RI=tm._sv_intervals(n_intervals, G))


def _check_classes(case, truncating, **kw):
    c = _classes(*case, **kw)
    assert all(n > 0 for k, n in c.items() if k != "over"), c
    assert (c["over"] > 0) == truncating, c


# The reference runs eagerly and compiles each op once per shape, so the
# G = 32 cases share two interval budgets (4, and the auto-full 12).
def _train_case(G, tail_k, n_intervals, density, rays="random"):
    ident = "-".join(map(str, (G, tail_k, n_intervals, density)))
    return pytest.param(G, tail_k, n_intervals, density, rays,
                        id=ident if rays == "random" else f"{rays}-{ident}")


@pytest.mark.parametrize("G,tail_k,n_intervals,density,rays", [
    _train_case(32, 16, 4, 0.2),      # bench form (full tail), truncating
    _train_case(32, 0, 4, 0.003),     # first-K, truncating, sparse cells
    _train_case(32, 4, 4, 0.5),       # 12 verbatim + 4 strided, truncating
    _train_case(32, 16, 0, 0.2),      # auto-full horizon: nothing truncates
    _train_case(32, 0, 0, 0.05),      # first-K, auto-full
    _train_case(32, 4, 0, 0.5),       # 12 verbatim + 4 strided, auto-full
    _train_case(128, 16, 24, 0.02),   # the bench's grid and sv_intervals
    # every `_adversarial` kind, with and without the stratified tail
    _train_case(32, 16, 4, 0.2, "adversarial"),
    _train_case(32, 0, 4, 0.003, "adversarial"),
    _train_case(32, 16, 0, 0.2, "adversarial"),
])
def test_sv_train_march_matches_jax_exactly(G, tail_k, n_intervals,
                                            density, rays):
    build = _adversarial if rays == "adversarial" else _inputs
    o, d, hits, _, noise, mask, payload = build(G + tail_k + n_intervals,
                                                64, G, density)
    if rays == "adversarial":
        _check_classes((o, d, hits, noise, mask, G, n_intervals),
                       n_intervals > 0, train=True)
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


@pytest.mark.parametrize("G", [32, 128])
def test_crossing_ranks_give_the_sorted_pieces(G):
    """Kernel K1 does not sort the plane crossings: it puts an in-range
    crossing at its index within its axis plus the count of the other
    axes' in-range crossings below it, ties going to the axis first in an
    arbitrary order. On every `_adversarial` kind, in either tie order,
    that gives the bounds of `sv_intervals_plain`'s torch.sort, and so its
    pieces: b0, b1, validity and the supervoxel of each valid piece."""
    o, d, hits, _, noise, mask, _ = _adversarial(G, 64, G, 0.2)
    f32 = np.float32
    lo = float(np.sqrt(3.0) / 1024)
    t1, t2 = hits[:, 0], hits[:, 1]
    hit = t1 >= 0
    t0 = N(T(t1) + lo * T(noise))
    t_end = np.where(hit, np.minimum(t2, N(T(t0) + 1024 * lo)), -np.inf)
    A = {k: N(v) for k, v in tm.sv_intervals_plain(
        T(o), T(d), T(t0), T(t_end), T(hit), T(mask), scale=SCALE,
        grid_size=G, RI=4).items()}
    Gc, mb, sv, _ = tm._sv_geometry(SCALE, G, lo)
    jj = np.arange(Gc + 1, dtype=f32)
    den = np.where(np.abs(d) < f32(1e-9), f32(1e-9), d)
    for order in ((0, 1, 2), (2, 1, 0)):
        for n in np.nonzero(hit)[0]:
            if t0[n] < t_end[n]:
                # each axis's crossings in ascending t: plane index up for
                # d > 0, down for d < 0 (monotone: one rounded division)
                ax = [((jj * f32(sv) - f32(mb)) - o[n, a]) / den[n, a]
                      for a in range(3)]
                ax = [v if den[n, a] > 0 else v[::-1]
                      for a, v in enumerate(ax)]
                assert all(np.all(np.diff(v) >= 0) for v in ax)
                first = [np.searchsorted(v, t0[n], "right") for v in ax]
                last = [np.searchsorted(v, t_end[n], "left") for v in ax]
                bounds = np.full(sum(last) - sum(first) + 2, np.nan, f32)
                bounds[0], bounds[-1] = t0[n], t_end[n]
                for a in range(3):
                    for i in range(first[a], last[a]):
                        v, place = ax[a][i], 1 + i - first[a]
                        for b in range(3):
                            if b != a:
                                side = ("right" if order.index(b) < order.index(a)
                                        else "left")
                                place += (np.searchsorted(ax[b], v, side)
                                          - first[b])
                        assert np.isnan(bounds[place])
                        bounds[place] = v
            else:
                bounds = np.array([t_end[n], t0[n]], f32)
            k = bounds.size - 1
            b0, b1 = bounds[:-1], bounds[1:]
            np.testing.assert_array_equal(A["b0"][n, :k], b0)
            np.testing.assert_array_equal(A["b1"][n, :k], b1)
            valid = np.isfinite(b1) & (b1 > b0 + f32(1e-9))
            np.testing.assert_array_equal(A["iv_valid"][n, :k], valid)
            assert not A["iv_valid"][n, k:].any()
            tmid = f32(0.5) * (b0 + b1)
            c = [np.clip(np.floor((o[n, a] + tmid * d[n, a] + f32(mb))
                                  / f32(sv)), 0, Gc - 1).astype(np.int64)
                 for a in range(3)]
            sv_id = (c[2] * Gc + c[1]) * Gc + c[0]
            np.testing.assert_array_equal(A["sv_id"][n, :k][valid],
                                          sv_id[valid])


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


@pytest.mark.parametrize("G,n_steps,n_intervals,rays", [
    pytest.param(32, 8, 4, "random", id="32-8-4"),
    pytest.param(32, 64, 12, "random", id="32-64-12"),
    pytest.param(128, 32, 24, "random", id="128-32-24"),
    pytest.param(32, 8, 4, "adversarial", id="adversarial-32-8-4"),
])
def test_sv_test_rounds_match_jax_exactly(G, n_steps, n_intervals, rays):
    """Three rounds from the rays' near points; each round's samples and
    next cursor must be identical (the cursor carries the round)."""
    build = _adversarial if rays == "adversarial" else _inputs
    o, d, hits, _, noise, mask, payload = build(G + n_steps, 64, G, 0.2)
    if rays == "adversarial":
        _check_classes((o, d, hits, noise, mask, G, n_intervals), True,
                       train=False)
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
