"""The arithmetic of the general step grid's kernel bodies (`Cascades` in
`normal_clustering_nerf_torch/csrc/march_fine.cu`: H1, H9 and H10 past
scale 0.5) against the plain versions and the JAX package, on the CPU.
The kernels do not run here; these cases hold the values they read in
place of the reference's per-probe libm calls:

  (a) the table of powers (`ray_march.pow_table`, the one the wrappers
      pass), gathered at j = k - kA and multiplied by tA, gives
      `t_step_grid`'s steps bit for bit, on rays with t0 <= 0, tA > B
      (jB = 0), jB past the window, kA past the window, and the last
      entry j = S (H10's cursor); and is within test_torch_cascades'
      2-ulp rule of JAX's grid (XLA's CPU pow is not PyTorch's);
  (b) the cell's reciprocal 2^(1-mip) where 2^(mip-1) <= scale, else
      1/scale, equals the port's `_over(1.0, mip_bound)` and JAX's
      `1 / mip_bound` bit for bit at every mip of the scale;
  (c) the table is kept per (device, f): one buffer for equal requests, a
      longer one replacing it when asked, the old one kept;
  (d) the mip from the floats' exponent bits (`frexp_exponent`) equals
      the port's and JAX's frexp rule on cell and cascade faces, 0, -0
      and subnormal coordinates;
  (e) `step_args` passes the table and its length only where the grid
      is geometric.

All comparisons are exact. ATen's CPU pow runs vectorised over whole
vectors and scalar over a tail, so a power could differ by an ulp with
its place in the tensor; on these shapes the table and the grid agree
everywhere, which (a) asserts. On the card the powers are one elementwise
kernel and `chip_smoke.check_cascades` holds the kernels' outputs to the
plain versions bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_cascades import STEP_SHARE, ULP, _ulps
from test_torch_common import CPU, J, N, T

from normal_clustering_nerf_torch.config import ModelConfig as TMC
from normal_clustering_nerf_torch.ops import ray_march as tm
from normal_clustering_nerf_tpu.ops import ray_march as jm

SCALES = [0.75, 1.0, 2.0, 16.0]
F = 1.0 / 256.0
G = 128            # the bench's grid
MAX_SAMPLES = 1024  # the fine march's lo = sqrt(3) / 1024
S = 128            # a window of 128 steps: jB > S on rays that start at A


def _grid(scale):
    lo = np.sqrt(3) / MAX_SAMPLES
    hi = np.sqrt(3) * 2 * scale / G
    return lo, hi, lo / F, hi / F


def _start_points(scale):
    """t0 of the cases: at or below 0, deep in phase A (kA past the
    window), just below and at A, just past A (kA = 0, jB > S: the last
    step reads j = S), inside the geometric phase, a few steps before B
    (the walk crosses into steps of hi), at and past B (tA > B: jB = 0),
    and random ones over [-0.1, 2B]."""
    lo, hi, A, B = _grid(scale)
    f32 = np.float32
    above_a = np.nextafter(f32(A), f32(np.inf))
    pts = [-1.0, -lo / 2, 0.0, A / 4, A - 3 * lo, A - lo / 3, A, above_a,
           A * (1 + 2 * F), A * 3, B / (1 + F) ** 5, B / (1 + F), B,
           np.nextafter(f32(B), f32(np.inf)), B * 1.5, 4 * B]
    rng = np.random.default_rng(int(scale * 100))
    return np.concatenate([np.float32(pts),
                           rng.uniform(-0.1, 2 * B, 200)]).astype(np.float32)


def _table_steps(t0, n, scale):
    """t_k (k < n) as the `Cascades` body computes it from `pow_table`:
    t0s + k lo to kA, tA * table[k - kA] to jB, tB + (j - jB) hi after;
    with kA, jB and tA of each ray."""
    lo, hi, _, _ = _grid(scale)
    t0s, kA, tA, jB, tB = (x[:, None] for x in tm.step_phases(
        T(t0), exp_step_factor=F, max_samples=MAX_SAMPLES, grid_size=G,
        scale=scale))
    k = torch.arange(n, dtype=torch.float32)[None, :]
    j = k - kA
    tab = tm.pow_table(F, tm.pow_table_len(n - 1), CPU)
    geo = tA * tab[torch.clamp(j, 0, tab.numel() - 1).long()]
    t = torch.where(k <= kA, t0s + k * lo,
                    torch.where(j <= jB, geo, tB + (j - jB) * hi))
    return N(t), N(kA[:, 0]), N(jB[:, 0]), N(tA[:, 0])


@pytest.mark.parametrize("scale", SCALES)
def test_table_steps_are_t_step_grid(scale):
    t0 = _start_points(scale)
    n = S + 1
    got, kA, jB, tA = _table_steps(t0, n, scale)
    _, _, _, B = _grid(scale)
    # every kind of ray is present
    assert (t0 <= 0).any()
    assert ((tA > np.float32(B)) & (jB == 0)).any()
    assert (jB > S).any()
    assert (kA > S).any()
    last = (kA == 0) & (jB >= S)      # step S reads table[S]
    assert last.any()
    g = dict(exp_step_factor=F, max_samples=MAX_SAMPLES, grid_size=G,
             scale=scale)
    ref = N(tm.t_step_grid(T(t0), n, **g))
    np.testing.assert_array_equal(got.view(np.int32), ref.view(np.int32))
    with jax.disable_jit():
        jref = np.asarray(jm.t_step_grid(J(t0), n, **g))
    assert _ulps(got, jref).max() <= ULP
    assert (got != jref).mean() <= STEP_SHARE


def _kernel_inverse(mip, scale):
    """The `Cascades` body's reciprocal of min(2^(mip-1), scale)."""
    p = np.ldexp(np.float32(1.0), mip - 1)
    if p <= np.float32(scale):
        return np.ldexp(np.float32(1.0), 1 - mip)
    return np.float32(1.0) / np.float32(scale)


@pytest.mark.parametrize("scale", SCALES)
def test_cascade_reciprocal_is_exact(scale):
    C = TMC(scale=scale).cascades
    assert C >= 2
    mip = np.arange(C, dtype=np.int32)
    got = np.float32([_kernel_inverse(int(m), scale) for m in mip])
    tmip = torch.from_numpy(mip).long()
    bound = torch.clamp((torch.ones_like(tmip) << tmip).float() * 0.5,
                        max=scale)
    port = N(tm._over(1.0, bound))
    with jax.disable_jit():
        jb = jnp.minimum(jnp.exp2(J(mip).astype(jnp.float32) - 1.0), scale)
        jref = np.asarray(1.0 / jb)
    np.testing.assert_array_equal(got.view(np.int32), port.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), jref.view(np.int32))
    # the top cascade at 0.75 is bounded by the scale, not a power of two
    if scale == 0.75:
        assert got[-1] == np.float32(1.0) / np.float32(0.75)


def test_pow_table_kept_per_device_and_factor():
    f = F * 3.0          # a factor no other test asks for
    a = tm.pow_table(f, 129, CPU)
    b = tm.pow_table(f, 129, CPU)
    assert a is b and a.numel() >= 129
    assert tm.pow_table(f, a.numel(), CPU) is a
    n = a.numel() + 500
    c = tm.pow_table(f, n, CPU)
    assert c is not a and c.numel() >= n
    assert any(r is a for r in tm._pow_retired)
    assert tm.pow_table(f, 129, CPU) is c
    np.testing.assert_array_equal(N(c[:a.numel()]), N(a))
    other = tm.pow_table(F * 5.0, 129, CPU)
    assert other is not c
    assert N(other)[1] == np.float32(1.0 + F * 5.0)
    assert tm.pow_table_len(1024) == 1025 and tm.pow_table_len(13) == 33


def _exponent(v):
    """`frexp_exponent` of march_fine.cu on float32 v >= 0."""
    b = (v.view(np.uint32) >> 23).astype(np.int64)
    return np.where(v == 0, 0, b - 126)


def _positions(scale, C):
    """Coordinates on every cascade's cell faces and cascade faces, 1 ulp
    either side, 0, -0 and subnormals."""
    vals = [np.float32([0.0, -0.0, 1e-45, -1e-45, 1e-40, 1.1754942e-38,
                        1.1754944e-38])]
    for mip in range(C):
        b = np.float32(min(2.0 ** (mip - 1), scale))
        vals.append((b * (2.0 * np.arange(G + 1) / G - 1.0)).astype(
            np.float32))
    v = np.concatenate(vals)
    v = np.concatenate([v, np.nextafter(v, np.float32(np.inf)),
                        np.nextafter(v, np.float32(-np.inf))])
    return v.astype(np.float32)


@pytest.mark.parametrize("scale", SCALES)
def test_mip_from_exponent_bits(scale):
    C = TMC(scale=scale).cascades
    v = _positions(scale, C)
    rng = np.random.default_rng(5)
    xyz = np.stack([v, rng.permutation(v), rng.permutation(v) * 0.5], -1)
    mx = np.max(np.abs(xyz), axis=-1)
    got_pos = np.clip(_exponent(mx) + 1, 0, C - 1)
    e = np.arange(-8, C + 2)
    dt = np.concatenate([(2.0 ** e / G), np.sqrt(3) / np.float32([128, 1024]),
                         [np.sqrt(3) * 2 * scale / G]]).astype(np.float32)
    dt = np.concatenate([dt, np.nextafter(dt, np.float32(np.inf)),
                         np.nextafter(dt, np.float32(-np.inf))])
    got_dt = np.clip(_exponent(dt * np.float32(G)), 0, C - 1)
    np.testing.assert_array_equal(got_pos, N(tm._mip_from_pos(T(xyz), C)))
    np.testing.assert_array_equal(got_dt, N(tm._mip_from_dt(T(dt), G, C)))
    with jax.disable_jit():
        np.testing.assert_array_equal(
            got_pos, np.asarray(jm._mip_from_pos(J(xyz), C)))
        np.testing.assert_array_equal(
            got_dt, np.asarray(jm._mip_from_dt(J(dt), G, C)))


@pytest.mark.parametrize("scale", SCALES)
def test_step_args_pass_the_table_on_the_geometric_grid(scale):
    geo = tm.step_args(TMC(scale=scale).cascades, F, MAX_SAMPLES, G, scale,
                       1024, CPU)
    tab = tm.pow_table(F, 1025, CPU)
    assert geo[-2].value == tab.data_ptr() and geo[-1] == tab.numel() >= 1025
    assert geo[3] == F and geo[7] == 1.0 + F
    # one cascade, f = 0: the uniform grid reads no table
    flat = tm.step_args(1, 0.0, MAX_SAMPLES, G, 0.5, 1024, CPU)
    assert flat[-2:] == [None, 0] and flat[3] == 0.0
    # lo >= hi: calc_dt is lo, the grid uniform
    wide = tm.step_args(TMC(scale=scale).cascades, F, 16, 4096, scale, 64,
                        CPU)
    assert wide[-2:] == [None, 0] and wide[3] == 0.0
