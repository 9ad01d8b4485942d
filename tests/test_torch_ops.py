"""Small ops of the port against the JAX package: step grids, bit
packing, Morton codes, the ray-sphere intersection, the clamped
activations, rays, normals from depth, and the triangle sampler.

Tolerances: exact for integer and selection outputs and for ops that
repeat the JAX arithmetic op for op; float32 rtol 1e-6 where a library
routine (exp, sigmoid, pow, log) may differ by an ulp.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_common import J, N, T, random_rays

from normal_clustering_nerf_torch.datasets import normals as tn
from normal_clustering_nerf_torch.datasets import ray_utils as tr
from normal_clustering_nerf_torch.datasets.sampler import RaySampler as TS
from normal_clustering_nerf_torch.losses import triang_idx as t_triang_idx
from normal_clustering_nerf_torch.ops import morton as tmo
from normal_clustering_nerf_torch.ops import packbits as tp
from normal_clustering_nerf_torch.ops import ray_aabb as tra
from normal_clustering_nerf_torch.ops import ray_march as tm
from normal_clustering_nerf_torch.ops import trunc_exp as tt
from normal_clustering_nerf_tpu.datasets import normals as jn
from normal_clustering_nerf_tpu.datasets import ray_utils as jr
from normal_clustering_nerf_tpu.datasets.sampler import RaySampler as JS
from normal_clustering_nerf_tpu.losses import triang_idx as j_triang_idx
from normal_clustering_nerf_tpu.ops.packbits import packbits as j_packbits
from normal_clustering_nerf_tpu.ops.packbits import unpack_bit as j_unpack_bit
from normal_clustering_nerf_tpu.ops import morton as jmo
from normal_clustering_nerf_tpu.ops import ray_aabb as jra
from normal_clustering_nerf_tpu.ops import ray_march as jm
from normal_clustering_nerf_tpu.ops.trunc_exp import trunc_exp as j_trunc_exp
from normal_clustering_nerf_tpu.ops.trunc_exp import trunc_sigmoid as j_trunc_sigmoid


@pytest.mark.parametrize("f,max_samples,G,scale", [
    (0.0, 128, 128, 0.5),        # bootstrap grid
    (1 / 256, 1024, 128, 2.0),   # geometric phase of large scenes
])
def test_step_grid_and_calc_dt(f, max_samples, G, scale):
    rng = np.random.default_rng(0)
    t0 = rng.uniform(0.0, 2.0, 64).astype(np.float32)
    kw = dict(exp_step_factor=f, max_samples=max_samples, grid_size=G,
              scale=scale)
    ref = jm.t_step_grid(J(t0), 300, **kw)
    out = tm.t_step_grid(T(t0), 300, **kw)
    np.testing.assert_allclose(N(out), np.asarray(ref), rtol=1e-6)
    dref = jm.calc_dt(ref, f, max_samples, G, scale)
    dout = tm.calc_dt(out, f, max_samples, G, scale)
    np.testing.assert_allclose(N(dout), np.asarray(dref), rtol=1e-6)


def test_packbits_roundtrip_and_parity():
    rng = np.random.default_rng(1)
    grid = rng.random(16 ** 3).astype(np.float32)
    ref = np.asarray(j_packbits(J(grid), 0.4))
    out = tp.packbits(T(grid), 0.4)
    np.testing.assert_array_equal(N(out), ref)
    np.testing.assert_array_equal(N(tp.unpack_bits(out)), grid > 0.4)
    idx = rng.integers(0, 16 ** 3, 500)
    np.testing.assert_array_equal(
        N(tp.unpack_bit(out, T(idx))),
        np.asarray(j_unpack_bit(J(ref), J(idx, np.int32))))


def test_morton_codes_match_jax():
    """Every cell of a 1024^3 grid's corners and random cells; the codes
    reach bit 29, and decode back."""
    rng = np.random.default_rng(2)
    coords = rng.integers(0, 1024, (4096, 3)).astype(np.int32)
    coords[:8] = [[x, y, z] for x in (0, 1023) for y in (0, 1023)
                  for z in (0, 1023)]
    ref = np.asarray(jmo.morton3d(J(coords)))
    out = tmo.morton3d(T(coords))
    np.testing.assert_array_equal(N(out), ref)
    assert out.dtype == torch.int32 and int(out.max()) == 2 ** 30 - 1
    np.testing.assert_array_equal(N(tmo.morton3d_invert(out)),
                                  np.asarray(jmo.morton3d_invert(J(ref))))
    np.testing.assert_array_equal(N(tmo.morton3d_invert(out)), coords)


def test_ray_sphere_intersect_matches_jax():
    """Origins inside, outside and behind the sphere (misses give -1)."""
    rng = np.random.default_rng(3)
    o, d = random_rays(rng, 500)
    o = o * 4.0
    c = np.array([0.1, -0.2, 0.05], np.float32)
    ref = np.asarray(jra.ray_sphere_intersect(J(o), J(d), J(c), 0.7))
    out = N(tra.ray_sphere_intersect(T(o), T(d), T(c), 0.7))
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)
    assert (ref[:, 0] == -1).any() and (ref[:, 0] > 0).any() \
        and ((ref[:, 0] == 0) & (ref[:, 1] > 0)).any()


@pytest.mark.parametrize("fn", ["exp", "sigmoid"])
def test_clamped_activations(fn):
    x = np.linspace(-40, 40, 401).astype(np.float32)
    g = np.random.default_rng(2).standard_normal(401).astype(np.float32)
    jf = j_trunc_exp if fn == "exp" else j_trunc_sigmoid
    tf = tt.trunc_exp if fn == "exp" else tt.trunc_sigmoid
    y_ref, vjp = jax.vjp(jf, J(x))
    xt = T(x).requires_grad_(True)
    y = tf(xt)
    y.backward(T(g))
    np.testing.assert_allclose(N(y), np.asarray(y_ref), rtol=1e-6)
    np.testing.assert_allclose(N(xt.grad), np.asarray(vjp(J(g))[0]),
                               rtol=1e-6, atol=1e-30)


def test_get_rays_batched_and_single():
    rng = np.random.default_rng(3)
    K = np.array([[20, 0, 12], [0, 20, 12], [0, 0, 1]], np.float32)
    dirs = jr.get_ray_directions(24, 24, K)
    np.testing.assert_array_equal(tr.get_ray_directions(24, 24, K), dirs)
    poses = rng.standard_normal((40, 3, 4)).astype(np.float32)
    sel = dirs[:40]
    o_ref, d_ref = jr.get_rays(J(sel), J(poses))
    o, d = tr.get_rays(T(sel), T(poses))
    np.testing.assert_array_equal(N(o), np.asarray(o_ref))
    # XLA evaluates the 3-term dot as an FMA chain, torch rounds each
    # product: 1-ulp differences of O(1) terms, so an absolute 1e-6
    np.testing.assert_allclose(N(d), np.asarray(d_ref), rtol=1e-6,
                               atol=1e-6)
    o_ref, d_ref = jr.get_rays(J(sel), J(poses[0]))
    o, d = tr.get_rays(T(sel), T(poses[0]))
    np.testing.assert_array_equal(N(o), np.asarray(o_ref))
    np.testing.assert_allclose(N(d), np.asarray(d_ref), rtol=1e-6,
                               atol=1e-6)


def test_normals_from_ray_batch_and_grad():
    """Including degenerate (zero-area) triangles, whose normal and
    gradient must be 0, not NaN."""
    rng = np.random.default_rng(4)
    o, d = random_rays(rng, 96)
    depth = rng.uniform(0.1, 1.0, 96).astype(np.float32)
    depth[:3] = 0.0
    o[:3] = 0.0                              # triangle 0 collapses
    idx = t_triang_idx(96)
    for k, v in j_triang_idx(96).items():
        np.testing.assert_array_equal(idx[k], v)
    g = rng.standard_normal((32, 3)).astype(np.float32)
    ref, vjp = jax.vjp(
        lambda dep: jn.extract_normals_from_ray_batch(J(o), J(d), dep, idx),
        J(depth))
    dt = T(depth).requires_grad_(True)
    out = tn.extract_normals_from_ray_batch(
        T(o), T(d), dt, {k: torch.as_tensor(v) for k, v in idx.items()})
    out.backward(T(g))
    np.testing.assert_allclose(N(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(N(dt.grad), np.asarray(vjp(J(g))[0]),
                               rtol=1e-4, atol=1e-5)
    assert np.all(N(out)[0] == 0.0) and np.isfinite(N(dt.grad)).all()


@pytest.mark.parametrize("expand", [0, 3])
def test_triangle_sampler_with_injected_draws(expand):
    js = JS("all_images_triang", 96, (24, 20), 6, max_expand=expand)
    ts = TS("all_images_triang", 96, (24, 20), 6, max_expand=expand,
            device="cpu")
    key = jax.random.PRNGKey(expand)
    ref = js.sample(key)
    k_img, k_pix, _ = jax.random.split(key, 3)
    draws = {"img": np.asarray(jax.random.randint(k_img, (32,), 0, 6)),
             "tri": np.asarray(jax.random.randint(
                 k_pix, (32,), 0, js.triang.x1.shape[0]))}
    out = ts.sample(draws=draws)
    for k in ("img_idxs", "pix_idxs"):
        np.testing.assert_array_equal(N(out[k]), np.asarray(ref[k]))
    drawn = ts.sample(torch.Generator().manual_seed(0))
    assert drawn["pix_idxs"].shape == (96,)
    assert int(drawn["pix_idxs"].max()) < 24 * 20
