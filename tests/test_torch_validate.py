"""Validation of the port against the JAX package: full-image normals from
depth, the metric suite, Manhattan rotation recovery (the JAX k-means
draws handed in), and `Trainer.validate` end to end from a converted
JAX state.

Tolerances:
  * normals from depth: rtol 1e-5, atol 1e-6 (a cross product and a
    normalisation in another order);
  * metrics on the same images: rtol 1e-6 (numpy in both; the port's
    PSNR sums in f32 with numpy instead of XLA);
  * rotation recovery on the same normals with the same k-means draws:
    atol 1e-3 deg (20 k-means iterations of f32 dot products summed in
    another order);
  * validate end to end: the renders agree to rtol 2e-4 / atol 2e-5
    (tests/test_torch_render.py), and the metrics follow: PSNR and SSIM
    rtol 1e-4, depth errors rtol 1e-3, normal angles and rotation errors
    atol 1e-3 deg (a normal from depth differences of neighbouring pixels
    amplifies the render's rounding; 2e-5 deg seen), semantic scores
    exact (argmax of the same logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, J, N, T, slice_configs

from normal_clustering_nerf_torch import metrics as tmet
from normal_clustering_nerf_torch.convert import convert_jax_state
from normal_clustering_nerf_torch.datasets import normals as tn
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_torch.training import rotation_recovery as trr
from normal_clustering_nerf_torch.utils import rotations as trot
from normal_clustering_nerf_tpu import metrics as jmet
from normal_clustering_nerf_tpu.datasets import normals as jn
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.metrics import rgb as jrgb
from normal_clustering_nerf_tpu.training import Trainer as JTrainer
from normal_clustering_nerf_tpu.training import rotation_recovery as jrr
from normal_clustering_nerf_tpu.utils import rotations as jrot


def test_normals_from_depth_batch_match_jax():
    rng = np.random.default_rng(0)
    B, H, W = 2, 9, 11
    depth = rng.uniform(0.2, 2.0, (B, H, W)).astype(np.float32)
    depth[0, 3, 4] = 0.0
    depth[1, 5, 6] = np.nan
    depth[1, 2, 2] = np.inf
    dirs = rng.standard_normal((H * W, 3)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (B, 3))
    poses = np.stack([np.concatenate(
        [jrot.euler_angles_to_matrix(a, "ZYX"), rng.standard_normal((3, 1))],
        axis=1) for a in ang]).astype(np.float32)
    ref = np.asarray(jn.extract_normals_from_depth_batch(J(depth), J(dirs),
                                                         J(poses)))
    out = N(tn.extract_normals_from_depth_batch(T(depth), T(dirs), T(poses)))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    assert (out[1, 5, 6] == 0).all() and (out[:, 0] == 0).all()
    assert np.isfinite(out).all()


def _images(rng, H=20, W=24):
    gt = rng.uniform(0, 1, (H, W, 3)).astype(np.float32)
    pred = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1).astype(
        np.float32)
    return pred, gt


def test_rgb_metrics_match_jax():
    pred, gt = _images(np.random.default_rng(1))
    np.testing.assert_allclose(tmet.psnr(pred, gt),
                               float(jrgb.psnr(J(pred), J(gt))), rtol=1e-6)
    for name in ("ssim", "ssim_gaussian", "ssim_norm", "ssim_norm_scikit"):
        np.testing.assert_allclose(getattr(tmet.rgb, name)(pred, gt),
                                   getattr(jrgb, name)(pred, gt), rtol=1e-6,
                                   err_msg=name)


def test_metric_aggregator_matches_jax(tmp_path, monkeypatch):
    """Two images with every head and label, through update and compute:
    PSNR, the SSIMs, depth errors, both normal heads' angles (their
    flip-minimum forms too) and the confusion-matrix scores; with
    eval_lpips and no weight file, both warn and give the same columns
    (tests/test_torch_lpips.py holds the column with a file)."""
    rng = np.random.default_rng(2)
    kw = dict(pred_norm_nn=True, pred_norm_depth=True, pred_sem=True,
              load_depth_gt=True, load_norm_gt=True, load_sem_gt=True,
              n_classes=3)
    agg_t, agg_j = tmet.NeRFMTMetricsPerIm(**kw), jmet.NeRFMTMetricsPerIm(**kw)
    for _ in range(2):
        rgb, rgb_gt = _images(rng)
        H, W = rgb.shape[:2]
        depth_gt = rng.uniform(0.5, 2.0, (H, W)).astype(np.float32)
        depth_gt[:2] = 0.0                              # invalid pixels
        n_gt = rng.standard_normal((H, W, 3)).astype(np.float32)
        n_gt[:, :1] = 0.0
        pred = {"rgb": rgb, "depth": depth_gt + rng.normal(0, 0.1, (H, W)),
                "norm_nn": rng.standard_normal((H, W, 3)),
                "norm_depth": n_gt + rng.normal(0, 0.3, (H, W, 3)),
                "sem": rng.standard_normal((H, W, 3))}
        gt = {"rgb": rgb_gt, "depth": depth_gt, "normals": n_gt,
              "semantics": rng.integers(0, 4, (H, W))}
        agg_t.update(pred, gt)
        agg_j.update(pred, gt)
    out, ref = agg_t.compute(), agg_j.compute()
    assert set(out) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(out[k], v, rtol=1e-6, err_msg=k)
    monkeypatch.setenv("NCNERF_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    with pytest.warns(RuntimeWarning, match="no LPIPS weight file"):
        agg_t = tmet.NeRFMTMetricsPerIm(eval_lpips=True, device="cpu", **kw)
        agg_j = jmet.NeRFMTMetricsPerIm(eval_lpips=True, **kw)
    agg_t.update(pred, gt)
    agg_j.update(pred, gt)
    assert set(agg_t.compute()) == set(agg_j.compute())
    assert "lpips" not in agg_t.compute()


def _manhattan_normals(rng, R, n=3000, noise=0.08):
    axes = np.concatenate([np.eye(3), -np.eye(3)])
    pick = rng.choice(6, n, p=[0.3, 0.15, 0.2, 0.15, 0.1, 0.1])
    v = axes[pick] + rng.normal(0, noise, (n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v = v @ R.T
    v[rng.random(n) < 0.1] = 0.0                     # invalid pixels
    return v.astype(np.float32)


def _jax_init_draws(normals, key, K=30, restarts=3):
    """The k-means initial indices of each restart of the JAX
    recover_rotation (rotation_recovery.py: fold_in(key, r), then
    kmeans.py: choice over the valid normals)."""
    nrm = np.linalg.norm(normals, axis=-1)
    valid = (nrm > 1e-6) & np.isfinite(nrm)
    p = valid.astype(np.float32)
    p = J(p / max(p.sum(), 1.0))
    return [np.array(jax.random.choice(jax.random.fold_in(key, r),
                                       normals.shape[0], (K,),
                                       replace=False, p=p))
            for r in range(restarts)]


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (20.0, -10.0, 35.0)])
def test_rotation_recovery_matches_jax(angles):
    rng = np.random.default_rng(3)
    R_off = trot.euler_angles_to_matrix(np.radians(angles), "ZYX")
    np.testing.assert_allclose(
        R_off, jrot.euler_angles_to_matrix(np.radians(angles), "ZYX"))
    normals = _manhattan_normals(rng, R_off)
    key = jax.random.PRNGKey(5)
    ref = jrr.rotation_recovery_errors(normals, R_off, key)
    out = trr.rotation_recovery_errors(
        normals, R_off, init_draws=_jax_init_draws(normals, key), device=CPU)
    assert set(out) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(out[k], v, atol=1e-3, err_msg=k)
        assert out[k] < 5.0                          # the frame was found


def test_rotation_recovery_refuses_zero_normals():
    with pytest.raises(ValueError):
        trr.rotation_recovery_errors(np.zeros((100, 3), np.float32),
                                     np.eye(3), generator=torch.Generator(),
                                     device=CPU)


@pytest.fixture(scope="module")
def validated():
    """validate() of a JAX trainer and of the port's trainer holding the
    same state: the slice configuration, 6 training and 2 held-out views
    at 24^2, triplane tables scaled up so that rays end on surfaces, the
    invisible cells marked and one full refresh."""
    jcfg, tcfg = slice_configs()
    size = dict(img_wh=(24, 24))
    jt = JTrainer(jcfg, JSyn(split="train", n_images=6, **size).load(),
                  JSyn(split="test", n_images=2, **size).load())
    params = dict(jt.state.params)
    params["model"] = dict(params["model"])
    params["model"]["hash_table"] = jax.tree_util.tree_map(
        lambda p: 8.0 * jax.random.normal(jax.random.PRNGKey(1), p.shape),
        params["model"]["hash_table"])
    jt.state = jt.state._replace(params=params)
    jt.mark_invisible_cells()
    occ = jt._occ_update[True](jt.state.occ, jt.state.params,
                               jax.random.PRNGKey(7))
    jt.state = jt.state._replace(occ=occ)
    tt = TTrainer(tcfg, TSyn(split="train", n_images=6, **size).load(),
                  TSyn(split="test", n_images=2, **size).load(), device="cpu")
    p, o, s = convert_jax_state(
        jax.tree_util.tree_map(np.asarray, jt.state.params),
        jax.tree_util.tree_map(np.asarray, jt.state.occ), tt.opt, CPU)
    tt.load_state(p, o, s)
    ref = jt.validate()
    nd = np.concatenate([p["norm_depth"].reshape(-1, 3)
                         for p in jt._last_val_preds])
    out = tt.validate(rotation_draws=_jax_init_draws(
        nd, jax.random.PRNGKey(jcfg.seed ^ 0xA11)))
    return out, ref, tt, jt


def test_validate_end_to_end_matches_jax(validated):
    out, ref, tt, jt = validated
    assert set(out) == set(ref)
    assert "ang/clust/yaw_abs" in out and "ang/clust/failed" not in out
    tol = {"psnr": dict(rtol=1e-4), "ssim": dict(rtol=1e-4),
           "ssim_norm": dict(rtol=1e-4), "ssim_norm_scikit": dict(rtol=1e-4),
           "depth_rmse": dict(rtol=1e-3), "depth_abs": dict(rtol=1e-3),
           "miou": dict(rtol=0), "accuracy": dict(rtol=0)}
    for k, v in ref.items():
        assert np.isfinite(out[k]), k
        np.testing.assert_allclose(out[k], v, err_msg=k,
                                   **tol.get(k, dict(atol=1e-3)))
    for p_t, p_j in zip(tt._last_val_preds, jt._last_val_preds):
        for k in ("rgb", "depth", "norm_nn", "sem"):
            np.testing.assert_allclose(p_t[k], p_j[k], rtol=2e-4, atol=2e-5,
                                       err_msg=k)
    op = np.concatenate([np.asarray(jnp.ravel(p["depth"]))
                         for p in jt._last_val_preds])
    assert (op > 0).mean() > 0.5                     # rays found surfaces
