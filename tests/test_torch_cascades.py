"""Scenes past scale 0.5 in the port against the JAX package: several
cascades and the geometric step grid (exp_step_factor 1/256), from the
step arithmetic through the marches of kernels H1, H9 and H10 (their plain
versions), the occupancy refresh, training steps and `render_test`, to the
CLI at --scale 1.0.

Tolerances:
  * `calc_dt` and `occupancy_lookup` (`cell_index`): exact, given the same
    positions and step sizes;
  * `t_step_grid`: within 2 ulp of JAX's, with at most 2% of the steps
    apart. XLA's CPU `log` and `pow` are not PyTorch's (ROADMAP C,
    "Reference behaviours"), so the geometric phase can round apart;
    the phase counts kA and jB are exact, the divisions rounding once as
    JAX's;
  * the marches (MARCH_RULE): on the rows whose t grid is JAX's the
    samples are identical. A row whose grid differs (by at most 2 ulp)
    keeps JAX's selection (valid, counts) with t and dt within 2 ulp,
    unless a differing t lies on the other side of a cell face, a cascade
    face or t2 than JAX's (`_crossing`), and at most 2% of the rays may
    take that way;
  * the occupancy refresh, `cell_world_pos` and the marking: exact (the
    density function of tests/test_torch_occupancy.py);
  * a bootstrap step and a step after it: tests/test_torch_baselines.py's
    tolerances (loss components rtol 1e-4, atol 1e-7; the counters
    exact; gradients rtol 1e-3 with atol 1e-4 of the largest; parameters
    atol 1e-3 lr a step): the eager JAX step's marches keep the port's
    selection on these rays;
  * `render_test`: tests/test_torch_render.py's rtol 2e-4, atol 2e-5 and
    total_samples equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, J, N, T, slice_configs
from test_torch_occupancy import THR, _density_j, _density_t
from test_torch_preset import _jax_config

from normal_clustering_nerf_torch.config import ModelConfig as TMC
from normal_clustering_nerf_torch.config import RenderConfig as TRC
from normal_clustering_nerf_torch.convert import convert_jax_state
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.models import occupancy as to
from normal_clustering_nerf_torch.models import rendering as tr
from normal_clustering_nerf_torch.ops import ray_march as tm
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_tpu.config import ModelConfig as JMC
from normal_clustering_nerf_tpu.config import RenderConfig as JRC
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.models import occupancy as jo
from normal_clustering_nerf_tpu.models import rendering as jr
from normal_clustering_nerf_tpu.ops import ray_march as jm
from normal_clustering_nerf_tpu.ops.ray_aabb import ray_aabb_intersect
from normal_clustering_nerf_tpu.training import Trainer as JTrainer

F = 1.0 / 256.0
G = 32
NR = 128
ULP = 2            # t_step_grid: largest distance from JAX's, in ulp
STEP_SHARE = 0.02  # t_step_grid: largest share of steps apart from JAX's
RAY_SHARE = 0.02   # marches: largest share of rays whose selection moved
ROOM = dict(room_half=0.8, scale=1.0)   # the smoke's cascades scene


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ia = a.view(np.int32).astype(np.int64)
    ib = b.view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def _mk(scale, max_samples=1024, grid_size=G):
    cascades = TMC(scale=scale).cascades
    return dict(cascades=cascades, scale=scale, exp_step_factor=F,
                grid_size=grid_size, max_samples=max_samples)


def _grid_kw(kw):
    return {k: kw[k] for k in ("exp_step_factor", "max_samples",
                               "grid_size", "scale")}


def _grids(t0, S, kw):
    """The port's and JAX's (eager) t_step_grid from t0 (numpy)."""
    g = _grid_kw(kw)
    with jax.disable_jit():
        ref = np.asarray(jm.t_step_grid(J(t0), S, **g))
    return N(tm.t_step_grid(T(t0), S, **g)), ref


# ------------------------------------------------------ step arithmetic
def test_calc_dt_matches_jax():
    rng = np.random.default_rng(0)
    for scale, ms in ((1.0, 1024), (2.0, 128), (16.0, 1024)):
        lo, hi = np.sqrt(3) / ms, np.sqrt(3) * 2 * scale / G
        t = np.concatenate([rng.uniform(-1, 4 * hi / F, 4000),
                            [lo / F, hi / F, 0.0, -1.0]]).astype(np.float32)
        t = np.concatenate([t, np.nextafter(t, np.float32(np.inf)),
                            np.nextafter(t, np.float32(-np.inf))])
        ref = jm.calc_dt(J(t), F, ms, G, scale)
        np.testing.assert_array_equal(N(tm.calc_dt(T(t), F, ms, G, scale)),
                                      np.asarray(ref))


@pytest.mark.parametrize("scale,max_samples", [(1.0, 1024), (2.0, 1024),
                                               (16.0, 1024), (1.0, 128)])
def test_t_step_grid_within_two_ulp_of_jax(scale, max_samples):
    """t0 in phase A (t <= lo/f), in phase B (geometric), past B = hi/f
    and at 0; 1024 steps from each."""
    kw = _mk(scale, max_samples)
    lo, hi = np.sqrt(3) / max_samples, np.sqrt(3) * 2 * scale / G
    A, B = lo / F, hi / F
    rng = np.random.default_rng(1)
    t0 = np.concatenate([rng.uniform(0, A, 40), rng.uniform(A, B, 40),
                         rng.uniform(B, 2 * B, 40), [0.0, A, B]]
                        ).astype(np.float32)
    out, ref = _grids(t0, 1024, kw)
    apart = out != ref
    assert _ulps(out, ref).max() <= ULP
    assert apart.mean() <= STEP_SHARE, apart.mean()
    # phase A is JAX's exactly: t0 + k * lo in both
    np.testing.assert_array_equal(out[:40, :8], ref[:40, :8])
    assert (np.diff(out, axis=1) > 0).all()


def test_t_step_grid_uniform_when_lo_reaches_hi():
    """lo >= hi (G > 2 scale max_samples): steps of lo, exactly JAX's."""
    kw = dict(exp_step_factor=F, max_samples=16, grid_size=64, scale=1.0)
    t0 = np.random.default_rng(2).uniform(0, 2, 50).astype(np.float32)
    g = {k: kw[k] for k in kw}
    with jax.disable_jit():
        ref = np.asarray(jm.t_step_grid(J(t0), 64, **g))
    np.testing.assert_array_equal(N(tm.t_step_grid(T(t0), 64, **g)), ref)


def _jax_phases(t0, max_samples, scale):
    """kA, tA, jB of JAX's t_step_grid (ray_march.py:122-137), eager."""
    lo, hi = np.sqrt(3) / max_samples, np.sqrt(3) * 2 * scale / G
    A, B = lo / F, hi / F
    with jax.disable_jit():
        t0s = jnp.maximum(J(t0), 0.0)
        kA = jnp.where(t0s <= A, jnp.floor((A - t0s) / lo) + 1.0, 0.0)
        tA = t0s + kA * lo
        jB = jnp.where(tA <= B, jnp.floor(
            jnp.log(B / jnp.maximum(tA, 1e-30)) / np.log(1.0 + F)) + 1.0, 0.0)
    return np.asarray(kA), np.asarray(tA), np.asarray(jB)


def test_t_step_grid_divides_once():
    """The repair of `t_step_grid`: B / tA is one correctly rounded
    division (PyTorch's Python scalar over a tensor is the tensor's
    reciprocal times the scalar, two roundings), and (A - t0s) / lo and
    the log's quotient go through `_div`. On t0 where the two-rounding
    B / tA is off JAX's, the phase counts kA and jB and tA are JAX's."""
    ms, scale = 1024, 2.0
    hi = np.sqrt(3) * 2 * scale / G
    B = np.float32(hi / F)
    rng = np.random.default_rng(3)
    t0 = np.concatenate([rng.uniform(0, hi / F, 20000),
                         rng.uniform(0, 0.1, 2000)]).astype(np.float32)
    kA, tA, jB = _jax_phases(t0, ms, scale)
    once = B / tA
    # PyTorch's float / tensor: the old form, off JAX's quotient here
    rdiv = N(float(B) / T(tA))
    assert (rdiv == B * (np.float32(1.0) / tA)).all()
    off = rdiv != once
    assert off.sum() > 1000
    _, kA_t, tA_t, jB_t, _ = tm.step_phases(
        T(t0), exp_step_factor=F, max_samples=ms, grid_size=G, scale=scale)
    for name, a, b in (("kA", kA_t, kA), ("tA", tA_t, tA), ("jB", jB_t, jB)):
        np.testing.assert_array_equal(N(a)[off], b[off], err_msg=name)
        np.testing.assert_array_equal(N(a), b, err_msg=name)


# ---------------------------------------------------------------- lookup
def _face_values(scale, cascades):
    """Coordinates on the cell faces of every cascade and on the cascade
    faces (|x| = 2^(m-1)), and 1-3 ulp either side."""
    vals = []
    for mip in range(cascades):
        b = np.float32(min(2.0 ** (mip - 1), scale))
        vals.append((b * (2.0 * np.arange(G + 1) / G - 1.0)).astype(
            np.float32))
        vals.append(np.float32([2.0 ** (mip - 1), -2.0 ** (mip - 1)]))
    v = np.concatenate(vals)
    out = [v]
    for _ in range(3):
        out += [np.nextafter(out[-2 if len(out) > 1 else 0],
                             np.float32(np.inf)),
                np.nextafter(out[-1 if len(out) > 1 else 0],
                             np.float32(-np.inf))]
    return np.concatenate(out).astype(np.float32)


def _dt_values(cascades):
    """Step sizes whose dt * G is on and next to 2^e: the mip from dt."""
    e = np.arange(-6, cascades + 1)
    dt = (2.0 ** e / G).astype(np.float32)
    return np.concatenate([dt, np.nextafter(dt, np.float32(np.inf)),
                           np.nextafter(dt, np.float32(-np.inf))])


@pytest.mark.parametrize("scale", [0.75, 1.0, 2.0, 16.0])
def test_lookup_matches_jax(scale):
    """`occupancy_lookup` at 2, 2, 3 and 6 cascades on positions on cell
    and cascade faces and step sizes on mip thresholds, against JAX's bit
    for bit (and `cell_index` against JAX's index formula). At 0.75 the
    top cascade's bound is not a power of two: the product with the
    rounded reciprocal moves some positions off the quotient's cell."""
    C = TMC(scale=scale).cascades
    assert C == {0.75: 2, 1.0: 2, 2.0: 3, 16.0: 6}[scale]
    rng = np.random.default_rng(int(scale * 4))
    faces = _face_values(scale, C)
    n = faces.size * 3
    xyz = rng.uniform(-scale, scale, (n, 3)).astype(np.float32)
    for a in range(3):
        xyz[a * faces.size:(a + 1) * faces.size, a] = faces
    dts = _dt_values(C)
    dt = np.where(rng.random(n) < 0.5, rng.choice(dts, n),
                  rng.uniform(1e-3, 0.1, n)).astype(np.float32)
    bits = rng.integers(0, 256, C * G ** 3 // 8, dtype=np.uint8)
    ref = jm.occupancy_lookup(J(xyz), J(dt), J(bits), cascades=C,
                              scale=scale, grid_size=G)
    got = tm.occupancy_lookup(T(xyz), T(bits), cascades=C, scale=scale,
                              grid_size=G, dt=T(dt))
    np.testing.assert_array_equal(N(got), np.asarray(ref))
    idx = N(tm.cell_index(T(xyz), cascades=C, scale=scale, grid_size=G,
                          dt=T(dt)))
    mip = idx // G ** 3
    assert set(np.unique(mip)) == set(range(C))
    # JAX's index formula (ray_march.py:88-95), in numpy
    mx = np.abs(xyz).max(-1)
    m_pos = np.clip(np.frexp(mx)[1] + 1, 0, C - 1)
    m_dt = np.clip(np.frexp(dt * np.float32(G))[1], 0, C - 1)
    m = np.maximum(m_pos, m_dt)
    np.testing.assert_array_equal(mip, m)
    b = np.minimum(2.0 ** (m - 1.0), scale).astype(np.float32)
    inv = (np.float32(1.0) / b)[:, None]
    q_mul, q_div = xyz * inv, xyz / b[:, None]
    moved = (_cell(q_mul) != _cell(q_div)).any(-1).sum()
    assert (moved > 0) == (scale == 0.75), moved
    cell = _cell(q_mul)
    np.testing.assert_array_equal(
        idx, ((m * G + cell[:, 2]) * G + cell[:, 1]) * G + cell[:, 0])
    with pytest.raises(ValueError, match="dt"):
        tm.occupancy_lookup(T(xyz), T(bits), cascades=C, scale=scale,
                            grid_size=G)


def _cell(q):
    v = np.float32(0.5) * (q + np.float32(1.0)) * np.float32(G)
    return np.clip(v, 0, G - 1).astype(np.int64)


# --------------------------------------------------------------- marches
def _march_inputs(seed, scale, density=0.3):
    """Rays from inside and around the box of half-size `scale` (some miss
    it), their box intervals, march noise and a random bitfield over every
    cascade."""
    C = TMC(scale=scale).cascades
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1.2 * scale, 1.2 * scale, (NR, 3)).astype(np.float32)
    d = rng.standard_normal((NR, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    hits = np.asarray(ray_aabb_intersect(J(o), J(d), jnp.zeros(3),
                                         jnp.full(3, scale)))
    occ = rng.random(C * G ** 3) < density
    bits = np.packbits(occ, bitorder="little")
    noise = rng.random(NR).astype(np.float32)
    return o, d, hits, bits, noise


def _crossing(o, d, t2, ok, tg_t, tg_j, kw):
    """(N,) rays where some step's t differs between the port's grid
    `tg_t` and JAX's `tg_j` and the two lie in different cells (of any
    cascade) or on different sides of t2 (in-range for a ray that
    marches, `ok`): the steps a 2-ulp difference can really move."""
    cells = []
    for tg in (tg_t, tg_j):
        tg = torch.as_tensor(np.array(tg))
        dt = tm.calc_dt(tg, kw["exp_step_factor"], kw["max_samples"],
                        kw["grid_size"], kw["scale"])
        xyz = T(o)[:, None, :] + tg[..., None] * T(d)[:, None, :]
        cells.append(N(tm.cell_index(xyz, cascades=kw["cascades"],
                                     scale=kw["scale"],
                                     grid_size=kw["grid_size"], dt=dt)))
    diff = tg_t != tg_j
    moved = (cells[0] != cells[1]) | ((tg_t < t2[:, None])
                                      != (tg_j < t2[:, None]))
    return (diff & moved & ok[:, None]).any(1)


def _hold_rows(same_grid, cross, fields):
    """MARCH_RULE on per-ray (N, ...) outputs: rows of `same_grid` exact;
    other rows without a crossing: the boolean and integer fields exact,
    the float fields within ULP; returns the rows that differ anywhere."""
    differ = np.zeros(same_grid.shape, bool)
    for name, a, b in fields:
        a, b = N(a), np.asarray(b)
        rows = (a != b).reshape(a.shape[0], -1).any(1)
        differ |= rows
        np.testing.assert_array_equal(a[same_grid], b[same_grid],
                                      err_msg=name)
        free = ~same_grid & ~cross
        if a.dtype.kind == "f":
            assert _ulps(a[free], b[free]).max(initial=0) <= ULP, name
        else:
            np.testing.assert_array_equal(a[free], b[free], err_msg=name)
    return differ


def _check_crossings(differ, same_grid, cross):
    """Every row that differs from JAX's on a differing grid without a
    crossing differs by the 2-ulp values only (`_hold_rows`); the rows
    with a crossing are at most RAY_SHARE of the rays."""
    assert not (differ & same_grid).any()
    assert cross.sum() <= RAY_SHARE * cross.size, cross.sum()
    return int(cross.sum())


@pytest.mark.parametrize("scale", [1.0, 2.0])
@pytest.mark.parametrize("kind,tail_k", [("bootstrap", 16), ("bootstrap", 0),
                                         ("fine", 16), ("fine", 0)])
def test_dense_march_matches_jax(scale, kind, tail_k):
    """H1's bootstrap march (128 steps of sqrt(3)/128) and H9's fine
    march (1024 steps of sqrt(3)/1024), K 16, the full stratified tail
    and first-K, at 2 and 3 cascades, under MARCH_RULE."""
    o, d, hits, bits, noise = _march_inputs(int(scale) + tail_k, scale)
    ms = 128 if kind == "bootstrap" else 1024
    kw = _mk(scale, ms)
    mkw = dict(kw, samples_per_ray=16, march_steps=ms, tail_k=tail_k)
    with jax.disable_jit():
        ref = jm.march_rays_train_dense(J(o), J(d), J(hits), J(bits),
                                        J(noise), **mkw)
    fn = (tm.march_rays_train_bootstrap if kind == "bootstrap"
          else tm.march_rays_train_dense)
    out = fn(T(o), T(d), T(hits), T(bits), T(noise), **mkw)
    t1 = hits[:, 0]
    t0 = N(T(t1) + tm.calc_dt(T(t1), F, ms, G, scale) * T(noise))
    with jax.disable_jit():
        t0_j = np.asarray(J(t1) + jm.calc_dt(J(t1), F, ms, G, scale)
                          * J(noise))
    np.testing.assert_array_equal(t0, t0_j)
    tg_t, tg_j = _grids(t0, ms, kw)
    same = (tg_t == tg_j).all(1)
    cross = _crossing(o, d, hits[:, 1], t1 >= 0, tg_t, tg_j, kw)
    differ = _hold_rows(same, cross,
                        [(f, getattr(out, f), getattr(ref, f))
                         for f in ("t", "dt", "valid", "ray_count")])
    n = _check_crossings(differ, same, cross)
    print(f"{kind} scale {scale} tail {tail_k}: grids apart on "
          f"{int((~same).sum())} rays, crossings {n}, rows differing "
          f"{int(differ.sum())}")
    if n == 0:
        assert int(out.rm_samples) == int(ref.rm_samples)
    assert int(out.trunc_rays) == 0 == int(ref.trunc_rays)
    assert int(N(out.ray_count).sum()) > 0
    # the fine grid reaches its geometric phase (t > 256 lo = 0.43), where
    # the two pow functions part; the bootstrap grid mostly stays before it
    assert kind == "bootstrap" or not same.all()
    # samples past cascade 0 are selected
    v = N(out.valid)
    xyz = o[:, None, :] + N(out.t)[..., None] * d[:, None, :]
    assert (np.abs(xyz[v]).max(-1) > 0.5).any()


def _per_ray(res, n_rays, width):
    """The flat slots of `res` (a MarchResult) as (N, width) rows."""
    rs, rc = N(res.ray_start), N(res.ray_count)
    t = np.zeros((n_rays, width), np.float32)
    dt = np.zeros_like(t)
    for r in range(n_rays):
        t[r, :rc[r]] = N(res.t)[rs[r]:rs[r] + rc[r]]
        dt[r, :rc[r]] = N(res.dt)[rs[r]:rs[r] + rc[r]]
    return t, dt, rc


@pytest.mark.parametrize("scale,tail_k", [(1.0, 16), (2.0, 0)])
def test_flat_march_matches_jax(scale, tail_k):
    """H9 at the per-ray cap compacted by H11 (the flat training march)
    against JAX's `march_rays_train`, per ray under MARCH_RULE."""
    o, d, hits, bits, noise = _march_inputs(5 + tail_k, scale)
    kw = _mk(scale)
    mkw = dict(kw, sample_budget=16 * NR, march_steps=1024, per_ray_cap=16,
               tail_k=tail_k)
    with jax.disable_jit():
        ref = jm.march_rays_train(J(o), J(d), J(hits), J(bits), J(noise),
                                  **mkw)
    out = tm.march_rays_train(T(o), T(d), T(hits), T(bits), T(noise), **mkw)
    t1 = hits[:, 0]
    t0 = N(T(t1) + tm.calc_dt(T(t1), F, 1024, G, scale) * T(noise))
    tg_t, tg_j = _grids(t0, 1024, kw)
    same = (tg_t == tg_j).all(1)
    cross = _crossing(o, d, hits[:, 1], t1 >= 0, tg_t, tg_j, kw)
    got, want = _per_ray(out, NR, 16), _per_ray(ref, NR, 16)
    differ = _hold_rows(same, cross,
                        list(zip(("t", "dt", "ray_count"), got, want)))
    n = _check_crossings(differ, same, cross)
    if n == 0:
        for k in ("ray_id", "t", "dt", "valid", "ray_start", "ray_count",
                  "rm_samples"):
            if k in ("t", "dt"):
                assert _ulps(N(getattr(out, k)),
                             np.asarray(getattr(ref, k))).max() <= ULP
            else:
                np.testing.assert_array_equal(N(getattr(out, k)),
                                              np.asarray(getattr(ref, k)),
                                              err_msg=k)
    assert int(N(out.valid).sum()) > 0


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_test_rounds_match_jax(scale):
    """H10's full window (JAX's `march_rays_test_round_dense`, 512 steps)
    and its first-K window (the bucket round's non-sv march,
    rendering.py:332-353: K 16 of a 512-step window), three rounds each,
    every round from JAX's cursors, under MARCH_RULE (the cursor within
    2 ulp on the rows without a crossing). Then the flat round (H10 +
    H11) on the first round's cursors. The rounds start at t 0.2 or the
    near end, past A = lo/f (0.108 at max_samples 4096): in the geometric
    phase; a round restarts the grid from its cursor, and pow(1 + f, j)
    parts from JAX's only at larger j, hence the long windows."""
    o, d, hits, bits, _ = _march_inputs(9, scale, 0.1)
    kw = _mk(scale, 4096)
    near, far = hits[:, 0], hits[:, 1]
    near = np.where(near >= 0, np.maximum(near, np.float32(0.2)), near)
    apart = False
    for mode, S in (("full", 512), ("window", 512)):
        cur, alive = near.copy(), near >= 0
        alive[::8] = False
        for r in range(3):
            if mode == "full":
                with jax.disable_jit():
                    ref = jm.march_rays_test_round_dense(
                        J(o), J(d), J(cur), J(far), J(alive), J(bits), **kw,
                        n_steps=S)
                out = tm.march_rays_test_round_dense(
                    T(o), T(d), T(cur), T(far), T(alive), T(bits), **kw,
                    n_steps=S)
            else:
                with jax.disable_jit():
                    ref = _window_round_j(J(o), J(d), J(cur), J(far),
                                          J(alive), J(bits), kw, S, 16)
                out = tm.march_rays_test_round_window(
                    T(o), T(d), T(cur), T(far), T(alive), T(bits), **kw,
                    S_march=S, n_steps=16)
            tg_t, tg_j = _grids(cur, S + 1, kw)
            same = (tg_t == tg_j).all(1)
            ok = alive & (cur >= 0)
            cross = _crossing(o, d, far, ok, tg_t[:, :S], tg_j[:, :S], kw)
            differ = _hold_rows(same, cross, [
                (name, N(a).reshape(NR, -1), np.asarray(b).reshape(NR, -1))
                for name, a, b in zip(("t", "dt", "valid", "cursor"), out,
                                      ref)])
            _check_crossings(differ, same, cross)
            assert r > 0 or int(N(out[2]).sum()) > 0
            apart |= ~same.all()
            cur = np.asarray(ref[3])
            alive = alive & (cur < far)
    assert apart
    # the flat round from the near ends
    cur, alive = near.copy(), near >= 0
    fkw = dict(kw, n_steps=64, sample_budget=NR * 64)
    with jax.disable_jit():
        ref, rc = jm.march_rays_test_round(J(o), J(d), J(cur), J(far),
                                           J(alive), J(bits), **fkw)
    out, oc = tm.march_rays_test_round(T(o), T(d), T(cur), T(far), T(alive),
                                       T(bits), **fkw)
    tg_t, tg_j = _grids(cur, 65, kw)
    same = (tg_t == tg_j).all(1)
    cross = _crossing(o, d, far, alive, tg_t[:, :64], tg_j[:, :64], kw)
    differ = _hold_rows(same, cross, list(zip(
        ("t", "dt", "ray_count"), _per_ray(out, NR, 64),
        _per_ray(ref, NR, 64))) + [("cursor", N(oc)[:, None],
                                    np.asarray(rc)[:, None])])
    _check_crossings(differ, same, cross)


def _window_round_j(ro, rd, cur, far, sel, bitfield, kw, S_march, K):
    """The JAX bucket round's non-sv march (rendering.py:332-353) at the
    multi-cascade keywords `kw` (tests/test_torch_march_fine.py has it at
    one cascade)."""
    g = _grid_kw(kw)
    tg_ext = jm.t_step_grid(cur, S_march + 1, **g)
    tg = tg_ext[:, :S_march]
    dtg = jm.calc_dt(tg, F, kw["max_samples"], kw["grid_size"], kw["scale"])
    xyz = ro[:, None, :] + tg[..., None] * rd[:, None, :]
    occ = jm.occupancy_lookup(xyz, dtg, bitfield, cascades=kw["cascades"],
                              scale=kw["scale"], grid_size=kw["grid_size"])
    include = (occ & sel[:, None] & (cur >= 0)[:, None]
               & (tg < far[:, None]))
    sidx, svalid = jm.select_first_k(include, K)
    t_k = jnp.where(svalid, jnp.take_along_axis(tg, sidx, axis=1), 0.0)
    dt_k = jnp.where(svalid, jnp.take_along_axis(dtg, sidx, axis=1), 0.0)
    last_col = jnp.where(jnp.sum(svalid, -1) >= K, sidx[:, K - 1] + 1,
                         S_march)
    new_cur = jnp.take_along_axis(tg_ext, last_col[:, None], axis=1)[:, 0]
    return t_k, dt_k, svalid, new_cur


# ------------------------------------------------------------- occupancy
def _occ_grids(scale):
    return (jo.OccupancyGrid(JMC(grid_size=G, scale=scale)),
            to.OccupancyGrid(TMC(grid_size=G, scale=scale), CPU))


def _occ_states(seed, scale):
    """A JAX state at `scale`'s cascades with invisible cells and earlier
    densities, and its port copy: cells above THR in every cascade but
    the last, where the occupied draw falls back to uniform cells."""
    jg, _ = _occ_grids(scale)
    C = jg.cascades
    rng = np.random.default_rng(seed)
    grid = rng.integers(0, 16, (C, G ** 3)) / 2.0
    grid[-1] /= 4.0
    grid[:, rng.random(G ** 3) < 0.1] = -1.0
    st = jg.init_state()._replace(density_grid=J(grid, jnp.float32))
    return st, to.OccupancyState(*(T(getattr(st, f))
                                   for f in to.OccupancyState._fields))


def _assert_states_equal(out, ref):
    for name in to.OccupancyState._fields:
        np.testing.assert_array_equal(N(getattr(out, name)),
                                      np.asarray(getattr(ref, name)),
                                      err_msg=name)


@pytest.mark.parametrize("scale", [1.0, 2.0])
def test_occupancy_refresh_matches_jax(scale):
    """The warmup and the sampled refresh at 2 and 3 cascades with JAX's
    draws handed in (per cascade: jitter from fold_in(key, c), the cell
    draws from split(k_cells, 2C)), and `cell_world_pos` of each cascade,
    exact."""
    jg, tg = _occ_grids(scale)
    C = jg.cascades
    assert C == {1.0: 2, 2.0: 3}[scale] == tg.cascades
    st_j, st_t = _occ_states(int(scale), scale)
    coords = jg.cell_coords(jnp.arange(G ** 3, dtype=jnp.int32))
    jit = np.random.default_rng(4).random((G ** 3, 3)).astype(np.float32)
    for c in range(C):
        np.testing.assert_array_equal(
            N(tg.cell_world_pos(T(coords), c, T(jit))),
            np.asarray(jg.cell_world_pos(coords, c, J(jit))))
    key = jax.random.PRNGKey(7)
    ref = jg.update(st_j, _density_j, key, THR, warmup=True)
    jitter = np.stack([np.asarray(jax.random.uniform(
        jax.random.fold_in(key, c), coords.shape)) for c in range(C)])
    out = tg.update(st_t, _density_t, THR, warmup=True, jitter=T(jitter))
    _assert_states_equal(out, ref)
    bits = N(out.density_bitfield)
    assert bits.shape == (C * G ** 3 // 8,)
    assert all(bits[c * G ** 3 // 8:(c + 1) * G ** 3 // 8].any()
               for c in range(C))

    key = jax.random.PRNGKey(11)
    ref = jg.update(st_j, _density_j, key, THR, warmup=False)
    k_cells, k_jit = jax.random.split(key)
    keys = jax.random.split(k_cells, 2 * C)
    M = G ** 3 // 4
    uni, occ, jit = [], [], []
    for c in range(C):
        n_occ = int(jnp.sum(st_j.density_grid[c] > THR))
        uni.append(np.asarray(jax.random.randint(keys[2 * c], (M,), 0,
                                                 G ** 3)))
        k_o = keys[2 * c + 1]
        occ.append(np.asarray(
            jax.random.randint(k_o, (M,), 0, n_occ) if n_occ else
            jax.random.randint(jax.random.fold_in(k_o, 1), (M,), 0, G ** 3)))
        assert (n_occ > 0) == (c < C - 1)
        jit.append(np.asarray(jax.random.uniform(
            jax.random.fold_in(k_jit, c), (2 * M, 3))))
    out = tg.update(st_t, _density_t, THR, warmup=False,
                    jitter=T(np.stack(jit)),
                    cell_draws={"uniform": np.stack(uni),
                                "occ_rank": np.stack(occ)})
    _assert_states_equal(out, ref)


def test_mark_invisible_cells_at_two_cascades():
    """Camera-coverage marking of every cascade on the cascades scene
    (the room at twice its width, scale 1.0), exact."""
    sj = JSyn(split="train", img_wh=(24, 24), n_images=6, **ROOM).load()
    st = TSyn(split="train", img_wh=(24, 24), n_images=6, **ROOM).load()
    jg, tg = _occ_grids(1.0)
    ref = jg.mark_invisible_cells(jg.init_state(), J(sj.poses), sj.img_wh,
                                  0.01, K=np.asarray(sj.K))
    out = tg.mark_invisible_cells(tg.init_state(), st.poses, st.img_wh,
                                  0.01, st.K)
    _assert_states_equal(out, ref)
    d = N(out.density_grid)
    assert d.shape == (2, G ** 3)
    assert all((d[c] == -1).any() and (d[c] == 0).any() for c in range(2))


# ----------------------------------------------------- steps, render, CLI
def test_steps_match_jax():
    """A bootstrap step and a step after it (the bitfield march over 1024
    steps: no sv march past one cascade) of the slice configuration at
    scale 1.0 on the cascades scene, from the JAX state after a full
    refresh, against JAX's eager step (tests/test_torch_baselines.py's
    `_jax_step`, its draws handed in): every loss component, the
    counters, every gradient, and every parameter after the two steps."""
    from test_torch_baselines import _flat, _jax_step
    _, tcfg = slice_configs(scale=1.0)
    tcfg = tcfg.replace(render=dataclasses.replace(tcfg.render,
                                                   bootstrap_steps=16))
    assert tcfg.model.cascades == 2 and tcfg.model.exp_step_factor == F
    jt = JTrainer(_jax_config(tcfg), JSyn(split="train", img_wh=(24, 24),
                                          n_images=6, **ROOM).load())
    jt.mark_invisible_cells()
    state = jt.state._replace(occ=jt._occ_update[True](
        jt.state.occ, jt.state.params, jax.random.PRNGKey(7)))
    tt = TTrainer(tcfg, TSyn(split="train", img_wh=(24, 24), n_images=6,
                             **ROOM).load(), device="cpu")
    tt.load_state(*convert_jax_state(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.occ), tt.opt, CPU))
    assert tt.occ.density_bitfield.shape == (2 * 32 ** 3 // 8,)
    n_rays = tt.sampler.batch_size
    for step, boot in enumerate((True, False)):
        with jax.disable_jit():
            draws, grads, loss_ref, rm, vr, state = _jax_step(jt, state,
                                                               boot)
        m = tt.train_step_core(bootstrap=boot, draws=draws)
        for k, v in loss_ref.items():
            np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {step} loss {k}")
        assert round(float(m["rm_samples_per_ray"]) * n_rays) == rm > 0
        assert round(float(m["vr_samples_per_ray"]) * n_rays) == vr
        g_ref = _flat(grads["model"])
        assert set(g_ref) == set(tt.last_grads)
        for n, g in tt.last_grads.items():
            np.testing.assert_allclose(N(g), g_ref[n], rtol=1e-3,
                                       atol=1e-4 * np.abs(g_ref[n]).max(),
                                       err_msg=f"step {step} grad {n}")
    p_ref = _flat(state.params["model"])
    for n, p in tt.params.items():
        np.testing.assert_allclose(N(p), p_ref[n], rtol=0,
                                   atol=2e-3 * tcfg.optim.lr,
                                   err_msg=f"param {n} after 2 steps")


def _render_pair(scale, seed, **rkw):
    """JAX's and the port's render_test on a triplane field with moved
    tables at `scale` (G 16, 128 samples), a random bitfield over every
    cascade, rays from 1.2x the box."""
    from test_torch_render import _models
    G_ = 16
    jmod, params, tmod = _models(8.0, grid_size=G_, max_samples=128,
                                 scale=scale)
    C = tmod.cfg.cascades
    rng = np.random.default_rng(seed)
    occ = rng.random(C * G_ ** 3) > 0.6
    bits = np.packbits(occ, bitorder="little")
    state = to.OccupancyGrid(TMC(grid_size=G_, scale=scale),
                             CPU).init_state()._replace(
        density_bitfield=T(bits))
    o = rng.uniform(-1.2 * scale, 1.2 * scale, (37, 3)).astype(np.float32)
    d = rng.standard_normal((37, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    rc = dict(test_march_window=32, test_n_samples=16)
    rc.update(rkw)
    # the flat rounds eagerly (test_torch_render.py says why); the bucket
    # renderer compiles its rounds ahead of time
    with jax.disable_jit(rc.get("test_layout") == "flat"):
        ref = jr.render_test(jmod, params, J(bits), J(o), J(d), JRC(**rc))
    with torch.no_grad():
        out = tr.render_test(tmod, state, T(o), T(d), TRC(**rc))
    return out, ref


@pytest.mark.parametrize("layout", ["bucket", "flat"])
def test_render_test_matches_jax(layout):
    """`render_test` at scale 1.0 (2 cascades, black background, the
    bucket ladder's min_samples 4): bucket rounds through the bitfield
    window (no sv march past one cascade) and flat rounds, against JAX's
    eager render, tests/test_torch_render.py's tolerance."""
    out, ref = _render_pair(1.0, 3, test_layout=layout)
    for k in ("rgb", "opacity", "depth", "norm_nn", "sem"):
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    assert out["total_samples"] == int(ref["total_samples"]) > 0
    assert out["rounds"] >= 2
    op = N(out["opacity"])
    assert ((op > 1 - 2e-4) & (op < 1)).any()   # rays ended early


def test_cli_trains_past_scale_half(tmp_path, monkeypatch):
    """`main` with --scale 1.0 on the synthetic room builds a trainer at 2
    cascades and the geometric grid and trains: the CLI's debug run cut to
    two bootstrap steps and one step of the bitfield march, every loss
    finite; validation stubbed (`test_render_test_matches_jax` holds the
    rounds, tests/test_torch_cli.py runs the CLI whole)."""
    from normal_clustering_nerf_torch import train_nerf
    hist = []

    def fit(trainer, cfg, logger):
        hist.extend(trainer.fit(2))
        hist.append({k: float(v) for k, v in
                     trainer.train_step_core(bootstrap=False).items()})
        return hist
    monkeypatch.setattr(train_nerf, "_fit", fit)
    monkeypatch.setattr(TTrainer, "validate",
                        lambda self, **kw: {"psnr": 0.0})
    run = {}
    train_nerf.main(["--dataset_name=synthetic", "--scale=1.0",
                     f"--log_root_dir={tmp_path}", "--exp_name=cascades"],
                    device="cpu", run=run)
    tt = run["trainer"]
    assert tt.step == 3 and len(hist) == 3
    assert tt.model.cfg.cascades == 2 and tt.model.cfg.exp_step_factor == F
    assert tt.occ.density_bitfield.shape == (2 * 32 ** 3 // 8,)
    assert all(np.isfinite(v) for m in hist for k, v in m.items()
               if k.startswith("loss_"))
    assert hist[-1]["rm_samples_per_ray"] > 0
    assert os.path.exists(os.path.join(str(tmp_path), "cascades",
                                       "results.csv"))


def test_state_crosses_from_jax_and_through_a_checkpoint(tmp_path):
    """A 2-cascade occupancy state (density grid (2, G^3), bitfield
    (2 G^3 / 8,)) after JAX's full refresh crosses into the port by
    `convert.py` exactly, and a checkpoint of the port's trainer restores
    it bit for bit into a fresh one, which then steps as the first."""
    from test_torch_checkpoints import _assert_same_state
    from normal_clustering_nerf_torch.training.checkpoints import (
        restore_checkpoint, save_checkpoint,
    )
    _, tcfg = slice_configs(scale=1.0)
    scene = dict(split="train", img_wh=(24, 24), n_images=6, **ROOM)
    jt = JTrainer(_jax_config(tcfg), JSyn(**scene).load())
    jt.mark_invisible_cells()
    occ = jt._occ_update[True](jt.state.occ, jt.state.params,
                               jax.random.PRNGKey(5))
    tt = TTrainer(tcfg, TSyn(**scene).load(), device="cpu")
    tt.load_state(*convert_jax_state(
        jax.tree_util.tree_map(np.asarray, jt.state.params),
        jax.tree_util.tree_map(np.asarray, occ), tt.opt, CPU))
    assert tt.occ.density_grid.shape == (2, G ** 3)
    assert tt.occ.density_bitfield.shape == (2 * G ** 3 // 8,)
    for name in to.OccupancyState._fields:
        np.testing.assert_array_equal(N(getattr(tt.occ, name)),
                                      np.asarray(getattr(occ, name)),
                                      err_msg=name)
    assert (N(tt.occ.density_grid)[1] == -1).any()
    tt.fit(2)
    ck = str(tmp_path / "ckpt")
    save_checkpoint(ck, tt)
    fresh = TTrainer(tcfg, TSyn(**scene).load(), device="cpu")
    restore_checkpoint(ck, fresh)
    _assert_same_state(tt, fresh)
    assert fresh.fit(1) == tt.fit(1)
    _assert_same_state(tt, fresh)
