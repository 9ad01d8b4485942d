"""The port's LPIPS (`metrics/lpips.py`) against the JAX package's
`metrics/lpips.py`, with shared `random_weights` (no pretrained file is in
the repository: weights/README.md): the VGG-16 tap features, the pair
value and the metric on images; the npz round trip through
$NCNERF_LPIPS_WEIGHTS; the aggregator's `lpips` column, present with a
weight file and left out with a warning without one; `--eval_lpips`
through the CLI's flags and `Trainer.validate`.

Tolerances: features within 1e-5 of their largest value, LPIPS values
rtol 1e-5 (f32 convolutions summed in another order by XLA and by
PyTorch's CPU kernels, through 13 layers).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import N, slice_configs

import normal_clustering_nerf_torch.config as tcfg
import normal_clustering_nerf_tpu.config as jcfg
from normal_clustering_nerf_torch.convert import lpips_params
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.metrics import lpips as tl
from normal_clustering_nerf_torch.metrics import metrics as tmet
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_tpu.metrics import lpips as jl
from normal_clustering_nerf_tpu.metrics import metrics as jmet


def _images(seed, shape=(32, 48, 3)):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, shape).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def test_random_weights_and_constants_equal_jax():
    w_t, w_j = tl.random_weights(3), jl.random_weights(3)
    assert set(w_t) == set(w_j)
    for k in w_j:
        np.testing.assert_array_equal(w_t[k], w_j[k], err_msg=k)
    assert tl._VGG_PLAN == jl._VGG_PLAN and tl._TAPS == jl._TAPS
    assert tl._LIN_CHANNELS == jl._LIN_CHANNELS
    np.testing.assert_array_equal(tl._SHIFT, jl._SHIFT)
    np.testing.assert_array_equal(tl._SCALE, jl._SCALE)


def test_vgg16_features_match_jax():
    w = tl.random_weights(0)
    conv = {k: v for k, v in w.items() if not k.startswith("lin")}
    a, b = _images(1)
    x = np.stack([a, b]) * 2.0 - 1.0
    ref = jl.vgg16_features({k: jnp.asarray(v) for k, v in conv.items()},
                            jnp.asarray(x))
    got = tl.vgg16_features(lpips_params(conv), torch.as_tensor(x))
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(N(g), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max(),
                                   err_msg=f"tap {i}")
    u = tl._unit_normalize(got[0])
    np.testing.assert_allclose(N(u), np.asarray(jl._unit_normalize(ref[0])),
                               rtol=1e-5, atol=1e-6)


def test_lpips_pair_and_metric_match_jax():
    w = tl.random_weights(0)
    a, b = _images(2, (48, 64, 3))
    x, y = (np.asarray(i)[None] * 2.0 - 1.0 for i in (a, b))
    m = tl.LPIPS(w, device="cpu")
    got = tl._lpips_pair(m.params, m.lins, torch.as_tensor(x),
                         torch.as_tensor(y))
    jm = jl.LPIPS(w)
    ref = jl._lpips_pair(jm.params, jm.lins, jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(N(got), np.asarray(ref), rtol=1e-5)
    np.testing.assert_allclose(m(a, b), jm(a, b), rtol=1e-5)
    assert m(a, a) == 0.0 and m(a, b) > 0


def test_load_lpips_resolves_as_jax(tmp_path, monkeypatch):
    """The argument, then $NCNERF_LPIPS_WEIGHTS, then weights/ of the
    repository; a missing file gives None."""
    w = tl.random_weights(1)
    path = tmp_path / "lpips_vgg.npz"
    np.savez(path, **w)
    monkeypatch.setenv("NCNERF_LPIPS_WEIGHTS", str(path))
    assert tl.default_weights_path() == jl.default_weights_path() == str(path)
    a, b = _images(3)
    m = tl.load_lpips(device="cpu")
    np.testing.assert_allclose(m(a, b), jl.load_lpips()(a, b), rtol=1e-5)
    assert tl.load_lpips(str(tmp_path / "none.npz"), device="cpu") is None
    monkeypatch.delenv("NCNERF_LPIPS_WEIGHTS")
    assert (tl.default_weights_path().replace("\\", "/")
            .endswith("/weights/lpips_vgg.npz"))
    bad = dict(w, lin0=w["lin0"][:10])
    with pytest.raises(ValueError, match="lin0"):
        tl.LPIPS(bad, device="cpu")


def _aggregators(**kw):
    return (tmet.NeRFMTMetricsPerIm(eval_lpips=True, device="cpu", **kw),
            jmet.NeRFMTMetricsPerIm(eval_lpips=True, **kw))


def test_lpips_column_with_and_without_weights(tmp_path, monkeypatch):
    """With a weight file both aggregators add the mean LPIPS of their
    images; without one both warn and leave the column out."""
    np.savez(tmp_path / "w.npz", **tl.random_weights(0))
    monkeypatch.setenv("NCNERF_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    agg_t, agg_j = _aggregators()
    for seed in (4, 5):
        a, b = _images(seed)
        agg_t.update({"rgb": a}, {"rgb": b})
        agg_j.update({"rgb": a}, {"rgb": b})
    out, ref = agg_t.compute(), agg_j.compute()
    assert set(out) == set(ref) and "lpips" in out
    np.testing.assert_allclose(out["lpips"], ref["lpips"], rtol=1e-5)
    monkeypatch.setenv("NCNERF_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    with pytest.warns(RuntimeWarning, match="no LPIPS weight file"):
        agg_t, _ = _aggregators()
    a, b = _images(6)
    agg_t.update({"rgb": a}, {"rgb": b})
    assert "lpips" not in agg_t.compute() and "psnr" in agg_t.compute()


def test_eval_lpips_flag_passes_through():
    argv = ["--dataset_name=synthetic", "--eval_lpips"]
    t, j = tcfg.TrainConfig.from_args(argv), jcfg.TrainConfig.from_args(argv)
    assert t.eval.eval_lpips is j.eval.eval_lpips is True


def test_validate_with_eval_lpips(tmp_path, monkeypatch):
    """`Trainer.validate` with eval_lpips: the lpips column with a weight
    file (the mean over the held-out views of LPIPS on the clipped render
    and the ground truth), none and a warning without one."""
    np.savez(tmp_path / "w.npz", **tl.random_weights(0))
    monkeypatch.setenv("NCNERF_LPIPS_WEIGHTS", str(tmp_path / "w.npz"))
    _, cfg = slice_configs()
    cfg = cfg.replace(eval=dataclasses.replace(cfg.eval, eval_lpips=True))
    scene = TSyn(split="train", img_wh=(24, 24), n_images=3).load()
    tr = TTrainer(cfg, scene, device="cpu")
    tr.occ_update(warmup=True)
    out = tr.validate()
    m = tl.load_lpips(device="cpu")
    want = np.mean([m(np.clip(p["rgb"], 0, 1), scene.rays[i, :, :3]
                      .reshape(24, 24, 3))
                    for i, p in enumerate(tr._last_val_preds)])
    np.testing.assert_allclose(out["lpips"], want, rtol=1e-6)
    monkeypatch.setenv("NCNERF_LPIPS_WEIGHTS", str(tmp_path / "none.npz"))
    with pytest.warns(RuntimeWarning, match="no LPIPS weight file"):
        out = tr.validate()
    assert "lpips" not in out and "psnr" in out
