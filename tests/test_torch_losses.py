"""Losses of the port against the JAX package's `losses.py`: spherical
k-means and the Manhattan cluster selection, the clustering losses, and
`compute_losses` with the bench.py loss configuration, values and
gradients, with the k-means init drawn by JAX and handed in.

Tolerances: cluster assignments exact (well-separated clusters, so no
assignment sits on an argmax tie); centroids rtol 1e-5, atol 1e-6;
loss values rtol 1e-5, atol 1e-7; gradients rtol 1e-4, atol 1e-6 (f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import J, N, T, slice_configs

from normal_clustering_nerf_torch import losses as tl
from normal_clustering_nerf_torch.ops import kmeans as tk
from normal_clustering_nerf_tpu import losses as jl
from normal_clustering_nerf_tpu.ops import kmeans as jk


def _manhattan_normals(seed, M=900):
    """Noisy normals of a rotated box room, with flipped, zero and NaN
    rows."""
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    axes = np.concatenate([q, -q]).astype(np.float32)
    n = axes[rng.integers(0, 6, M)] + 0.05 * rng.standard_normal((M, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:10] = 0.0
    n[10:12] = np.nan
    return n.astype(np.float32)


def _init_idx(key, normals, K):
    finite = np.all(np.isfinite(normals), -1)
    valid = finite & (np.abs(np.nan_to_num(normals)).sum(-1) != 0)
    p = valid / max(valid.sum(), 1)
    return np.asarray(jax.random.choice(key, normals.shape[0], (K,),
                                        replace=False, p=J(p)))


def test_normals_clustering_matches_jax():
    normals = np.nan_to_num(_manhattan_normals(0))
    valid = np.abs(normals).sum(-1) != 0
    key = jax.random.PRNGKey(3)
    ref = jk.normals_clustering(J(normals), J(valid), key, K=20, niter=20,
                                t_similar=0.99)
    out = tk.normals_clustering(T(normals), T(valid), K=20, niter=20,
                                t_similar=0.99,
                                init_idx=T(_init_idx(key, normals, 20)))
    np.testing.assert_array_equal(N(out.assign_orig),
                                  np.asarray(ref.assign_orig))
    np.testing.assert_array_equal(N(out.assign_new),
                                  np.asarray(ref.assign_new))
    np.testing.assert_allclose(N(out.centroids3), np.asarray(ref.centroids3),
                               rtol=1e-5, atol=1e-6)
    assert set(np.unique(N(out.assign_new))) >= {1, 2, 3}


def test_card_cluster_sums_match_jax():
    """K7's fixed-order cluster sums (`kmeans.cluster_sums`: a warp's
    lanes, then an xor butterfly; the card's order and, since K7, the
    CPU's too) against JAX's segment sum, and the clustering with them
    against JAX, at the tolerances above."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((1000, 3)).astype(np.float32)
    assign = rng.integers(0, 20, 1000)
    ok = rng.random(1000) < 0.8
    ref = jax.ops.segment_sum(J(x * ok[:, None]), J(assign),
                              num_segments=20)
    got = tk.cluster_sums(T(x), T(assign).long(), 20, T(ok))
    np.testing.assert_allclose(N(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)
    normals = np.nan_to_num(_manhattan_normals(1))
    valid = np.abs(normals).sum(-1) != 0
    key = jax.random.PRNGKey(4)
    ref = jk.normals_clustering(J(normals), J(valid), key, K=20, niter=20,
                                t_similar=0.99)
    out = tk.normals_clustering(T(normals), T(valid), K=20, niter=20,
                                t_similar=0.99,
                                init_idx=T(_init_idx(key, normals, 20)))
    np.testing.assert_array_equal(N(out.assign_new),
                                  np.asarray(ref.assign_new))
    np.testing.assert_allclose(N(out.centroids3), np.asarray(ref.centroids3),
                               rtol=1e-5, atol=1e-6)


def test_kmeans_draws_its_own_init():
    normals = torch.nn.functional.normalize(torch.randn(200, 3), dim=-1)
    valid = torch.ones(200, dtype=torch.bool)
    valid[:195] = False                     # fewer valid rows than K
    c, a = tk.spherical_kmeans(normals, valid, 20, 5,
                               generator=torch.Generator().manual_seed(0))
    assert c.shape == (20, 3) and a.shape == (200,)
    assert torch.isfinite(c).all()


def _pred_target(seed, n=96, K=16):
    rng = np.random.default_rng(seed)
    pred = {
        "rgb": rng.random((n, 3)), "opacity": rng.uniform(0.01, 1.0, n),
        "ws": rng.random((n, K)) / K, "deltas": rng.uniform(0.01, 0.05, (n, K)),
        "ts": np.cumsum(rng.uniform(0.01, 0.05, (n, K)), 1),
        "depth": rng.uniform(0.2, 1.0, n), "sem": rng.standard_normal((n, 3)),
        "rays_o": np.zeros((n, 3)), "rays_d": None,
    }
    # rays of a camera looking at a wall, in triangle triples
    d = rng.standard_normal((n, 3)) * 0.05 + [0.0, 0.0, 1.0]
    pred["rays_d"] = d / np.linalg.norm(d, axis=1, keepdims=True)
    pred = {k: v.astype(np.float32) for k, v in pred.items()}
    pred["sample_valid"] = np.arange(K)[None] < rng.integers(0, K + 1, n)[:, None]
    target = {"rgb": rng.random((n, 3)).astype(np.float32),
              "semantics": rng.integers(0, 4, n).astype(np.int32)}
    return pred, target


DIFF = ("rgb", "opacity", "ws", "depth", "sem")


@pytest.mark.parametrize("step", [0, 3000])
def test_compute_losses_values_and_gradients(step):
    """step 0: clustering weights are still 0 (the k-means runs anyway);
    step 3000: full clustering weights."""
    jcfg, tcfg = slice_configs()
    pred, target = _pred_target(step)
    key = jax.random.PRNGKey(5)

    def loss_j(diff):
        p = {k: J(v) for k, v in pred.items()}
        p.update(diff)
        return jl.compute_losses(
            p, {k: J(v) for k, v in target.items()}, jcfg.loss, jcfg.model,
            step=step, key=key, ray_sampling_strategy="all_images_triang")

    (ref, vjp_fn) = jax.vjp(loss_j, {k: J(pred[k]) for k in DIFF})
    g_ref = vjp_fn({k: jnp.ones_like(v) if k == "total" else jnp.zeros_like(v)
                    for k, v in ref.items()})[0]

    # the clustering input is normals of the triangles, as JAX extracts
    nd = np.asarray(jl.extract_normals_from_ray_batch(
        J(pred["rays_o"]), J(pred["rays_d"]), J(pred["depth"]),
        jl.triang_idx(96)))
    init = _init_idx(key, nd, jcfg.loss.cluster_K)
    tp = {k: T(v) for k, v in pred.items()}
    for k in DIFF:
        tp[k].requires_grad_(True)
    out = tl.compute_losses(tp, {k: T(v) for k, v in target.items()},
                            tcfg.loss, tcfg.model, step=step,
                            ray_sampling_strategy="all_images_triang",
                            kmeans_init=T(init))
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    out["total"].backward()
    for k in DIFF:
        np.testing.assert_allclose(N(tp[k].grad), np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    if step:
        assert float(out["norm_D_C_ort_dot"].detach()) != 0.0


PATCH = dict(patch_area=64, offsets_local={
    k: np.asarray(v) for k, v in zip(
        ("x1", "x2", "x3"),
        (np.arange(64).reshape(8, 8)[1:, 1:].reshape(-1),
         np.arange(64).reshape(8, 8)[:-1, 1:].reshape(-1),
         np.arange(64).reshape(8, 8)[1:, :-1].reshape(-1)))})


def test_patch_triang_idx_matches_jax():
    for n in (64, 256):
        ref = jl.patch_triang_idx(n, **PATCH)
        out = tl.patch_triang_idx(n, **PATCH)
        on = tl.patch_triang_idx_on(n, device=torch.device("cpu"), **PATCH)
        for k in ("x1", "x2", "x3"):
            np.testing.assert_array_equal(out[k], np.asarray(ref[k]))
            np.testing.assert_array_equal(N(on[k]), np.asarray(ref[k]))
    with pytest.raises(ValueError, match="patch area"):
        tl.patch_triang_idx(100, **PATCH)


@pytest.mark.parametrize("random_tr_poses", [False, True])
def test_compute_losses_patch_batches(random_tr_poses):
    """The patch branch (losses.py:215-246) at full clustering weights, on
    8 patches of 8 x 8; with `random_tr_poses` the last 4 patches are the
    random-pose rays: rgb on the first 256 rays, the clustering on the
    normals of the others. Values and gradients at the tolerances above."""
    jcfg, tcfg = slice_configs()
    step, n = 3000, 512
    pred, target = _pred_target(7, n=n)
    # each patch looks at one wall of a box (axis patch % 3): its points
    # lie on that plane, so the clustering finds three orthogonal groups
    rng = np.random.default_rng(8)
    uv = (np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1)
          .reshape(64, 2) - 3.5) * 0.03
    d = np.zeros((n // 64, 64, 3))
    for i in range(n // 64):
        a = i % 3
        d[i, :, a] = 1.0
        d[i, :, [(a + 1) % 3, (a + 2) % 3]] = (uv + rng.normal(
            0, 0.05, 2)).T
    d = d.reshape(n, 3)
    pred["rays_d"] = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)
    axis = np.repeat(np.arange(n // 64) % 3, 64)
    pred["depth"] = (1.0 / np.abs(pred["rays_d"][np.arange(n), axis])
                     * rng.uniform(0.999, 1.001, n)).astype(np.float32)
    gt = n // 2 if random_tr_poses else n
    target = {k: v[:gt] for k, v in target.items()}
    key = jax.random.PRNGKey(9)
    kw = dict(ray_sampling_strategy="all_images_triang_patch",
              random_tr_poses=random_tr_poses, **PATCH)

    def loss_j(diff):
        p = {k: J(v) for k, v in pred.items()}
        p.update(diff)
        return jl.compute_losses(
            p, {k: J(v) for k, v in target.items()}, jcfg.loss, jcfg.model,
            step=step, key=key, **kw)

    (ref, vjp_fn) = jax.vjp(loss_j, {k: J(pred[k]) for k in DIFF})
    g_ref = vjp_fn({k: jnp.ones_like(v) if k == "total" else jnp.zeros_like(v)
                    for k, v in ref.items()})[0]
    u = n - gt
    nd = np.asarray(jl.extract_normals_from_ray_batch(
        J(pred["rays_o"][gt % n:]), J(pred["rays_d"][gt % n:]),
        J(pred["depth"][gt % n:]), jl.patch_triang_idx(u or n, **PATCH)))
    init = _init_idx(key, nd, jcfg.loss.cluster_K)
    tp = {k: T(v) for k, v in pred.items()}
    for k in DIFF:
        tp[k].requires_grad_(True)
    out = tl.compute_losses(tp, {k: T(v) for k, v in target.items()},
                            tcfg.loss, tcfg.model, step=step,
                            kmeans_init=T(init), **kw)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    out["total"].backward()
    for k in DIFF:
        np.testing.assert_allclose(N(tp[k].grad), np.asarray(g_ref[k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    assert float(out["norm_D_C_ort_dot"].detach()) != 0.0
    if random_tr_poses:
        # the random-pose rays get no rgb gradient, the others no gradient
        # through the clustering's depth
        assert not N(tp["rgb"].grad)[gt:].any()
        assert not N(tp["depth"].grad)[:gt].any()
