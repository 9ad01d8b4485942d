"""The port's image, archive, results.csv and logger writers
(`normal_clustering_nerf_torch/training/visualize.py`, `results.py`,
`loggers.py`) against the JAX package's, which draw with cv2: the Turbo
table is cv2's, every task colouring equals JAX's, the panels equal
JAX's exactly at the default factor 0.5 on even sizes and within 1 at
other factors (cv2's vectorised vertical pass rounds in another order;
its nearest-neighbour semantic panels stay exact), the PNG decodes
through cv2 to the panel, the archives hold JAX's members and arrays,
and results.csv has JAX's columns and values for the same argv,
`param/parallel.*` (the cards of the run) included."""
import csv
import io
import os
import sys
import tarfile
import warnings

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

import normal_clustering_nerf_torch.config as tcfg  # noqa: E402
import normal_clustering_nerf_tpu.config as jcfg  # noqa: E402
from normal_clustering_nerf_torch.training import loggers as tlog  # noqa: E402
from normal_clustering_nerf_torch.training import results as tres  # noqa: E402
from normal_clustering_nerf_torch.training import visualize as tvis  # noqa: E402
from normal_clustering_nerf_torch.utils import rotations as trot  # noqa: E402
from normal_clustering_nerf_tpu.training import results as jres  # noqa: E402
from normal_clustering_nerf_tpu.training import visualize as jvis  # noqa: E402
from normal_clustering_nerf_tpu.utils import rotations as jrot  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "experiments"))
from hyperparameters import hypersim_flags  # noqa: E402

import chip_smoke  # noqa: E402

PARALLEL_COLUMNS = {"param/parallel.multihost",
                    "param/parallel.coordinator_address",
                    "param/parallel.num_processes",
                    "param/parallel.process_id"}


def _preds(rng, H, W, n_cls=3):
    """A validation pred dict and a gt dict as `Trainer.validate` builds
    them, depth and normals partly out of range and zero."""
    nrm = rng.standard_normal((H, W, 3)).astype(np.float32)
    nrm[0] = 0.0
    pred = {"rgb": rng.uniform(-0.1, 1.1, (H, W, 3)).astype(np.float32),
            "depth": rng.uniform(-0.2, 2.0, (H, W)).astype(np.float32),
            "norm_nn": nrm, "norm_depth": nrm[::-1].copy(),
            "sem": rng.standard_normal((H, W, n_cls)).astype(np.float32)}
    gt = {"rgb": pred["rgb"][::-1].copy(), "depth": pred["depth"].T.copy()
          if H == W else pred["depth"], "normals": nrm,
          "semantics": rng.integers(0, n_cls + 1, (H, W)),
          "semantics_WF": rng.integers(0, 3, (H, W)).astype(np.int32)}
    return pred, gt


def test_turbo_table_is_cv2s():
    ref = cv2.applyColorMap(np.arange(256, dtype=np.uint8)[:, None],
                            cv2.COLORMAP_TURBO)[:, 0, ::-1]
    np.testing.assert_array_equal(tvis.TURBO_RGB, ref)


@pytest.mark.parametrize("which", ["depth", "norm_nn", "norm_depth",
                                   "normals", "normals_depth", "sem",
                                   "semantics", "sem_WF", "semantics_WF",
                                   "rgb", "opacity"])
def test_pred_to_vis_matches_jax(which):
    rng = np.random.default_rng(0)
    pred, gt = _preds(rng, 12, 16, n_cls=4)
    v = {"depth": pred["depth"], "norm_nn": pred["norm_nn"],
         "norm_depth": pred["norm_depth"], "normals": gt["normals"],
         "normals_depth": pred["norm_nn"], "sem": pred["sem"],
         "semantics": gt["semantics"], "sem_WF": pred["sem"],
         "semantics_WF": gt["semantics_WF"], "rgb": pred["rgb"],
         "opacity": pred["depth"]}[which]
    got = tvis.pred_to_vis(v, which, n_classes=4)
    assert got.dtype == np.uint8 and got.shape == v.shape[:2] + (3,)
    np.testing.assert_array_equal(got, jvis.pred_to_vis(v, which, 4))


def test_unknown_task_is_refused():
    with pytest.raises(NotImplementedError):
        tvis.pred_to_vis(np.zeros((2, 2)), "bogus")


@pytest.mark.parametrize("hw", [(24, 32), (64, 64)])
def test_panels_match_jax_at_one_half(hw):
    rng = np.random.default_rng(1)
    for d in _preds(rng, *hw):
        got = tvis.pack_vis_panel(d, n_classes=3, downsample=0.5)
        np.testing.assert_array_equal(got, jvis.pack_vis_panel(
            d, n_classes=3, downsample=0.5))
        assert got.shape == (hw[0] // 2, len(d) * (hw[1] // 2), 3)


@pytest.mark.parametrize("hw,factor", [((24, 32), 1.0), ((25, 33), 0.5),
                                       ((40, 60), 0.3), ((30, 20), 0.75),
                                       ((17, 13), 1.5)])
def test_panels_within_one_of_jax_at_other_sizes(hw, factor):
    """At other factors (or odd sizes at 0.5) cv2 takes its generic
    linear path, whose vectorised rounding may put a pixel 1 off; the
    semantic (nearest-neighbour) panels and factor 1.0 stay exact."""
    rng = np.random.default_rng(2)
    pred, gt = _preds(rng, *hw)
    for d in (pred, gt):
        got = tvis.pack_vis_panel(d, downsample=factor)
        ref = jvis.pack_vis_panel(d, downsample=factor)
        assert got.shape == ref.shape
        assert np.abs(got.astype(int) - ref).max() <= (0 if factor == 1.0
                                                       else 1)
        w = ref.shape[1] // len(d)
        for i, k in enumerate(sorted(d)):
            if "sem" in k:
                np.testing.assert_array_equal(got[:, i * w:(i + 1) * w],
                                              ref[:, i * w:(i + 1) * w])


def test_resize_matches_cv2():
    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        tvis.resize_linear(img, 32, 24),
        cv2.resize(img, (32, 24), interpolation=cv2.INTER_LINEAR))
    for w, h in ((32, 24), (19, 7), (100, 90)):
        np.testing.assert_array_equal(
            tvis.resize_nearest(img, w, h),
            cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST))
        diff = tvis.resize_linear(img, w, h).astype(int) - cv2.resize(
            img, (w, h), interpolation=cv2.INTER_LINEAR)
        assert np.abs(diff).max() <= 1


def test_png_decodes_to_the_panel(tmp_path):
    rng = np.random.default_rng(4)
    pred, _ = _preds(rng, 24, 32)
    panel = tvis.pack_vis_panel(pred, downsample=0.5)
    path = str(tmp_path / "sub" / "x_pred.png")
    tvis.save_vis_png(path, panel)
    back = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1], panel)
    # the smoke's own reader, which checks the card's PNGs
    np.testing.assert_array_equal(chip_smoke.read_png(path), panel)
    jpath = str(tmp_path / "x_jax.png")
    jvis.save_vis_png(jpath, panel)
    np.testing.assert_array_equal(cv2.imread(jpath), back)


def _members(path):
    with tarfile.open(path, "r:gz") as tar:
        return {m.name: np.load(io.BytesIO(tar.extractfile(m).read()))
                for m in tar.getmembers()}


@pytest.mark.parametrize("split,tag", [("test", "pred"), ("train", "gt")])
def test_archives_match_jax(tmp_path, split, tag):
    rng = np.random.default_rng(5)
    rows = [_preds(rng, 8, 10)[0 if tag == "pred" else 1] for _ in range(3)]
    rows[0]["opacity"] = rows[1]["opacity"] = rows[2]["opacity"] = \
        np.ones((8, 10), np.float32)
    stack = {k: [r[k] for r in rows] for k in rows[0]}
    ids = ["cam_00.0001", "cam_00.0003", "cam_00.0005"]
    got = tvis.save_preds_tar_gz(str(tmp_path / "t"), stack, ids, split, tag)
    ref = jvis.save_preds_tar_gz(str(tmp_path / "j"), stack, ids, split, tag)
    assert os.path.basename(got) == os.path.basename(ref) == \
        f"{split}_{tag}.tar.gz"
    assert os.path.isfile(str(tmp_path / "t" / f"{split}_{tag}.done"))
    a, b = _members(got), _members(ref)
    assert list(a) == list(b) and not any(".opacity." in n for n in a)
    assert f"{tag}.{split}.rgb.scene.cam_00.0003.npy" in a
    for n, v in b.items():
        assert a[n].dtype == v.dtype
        np.testing.assert_array_equal(a[n], v, err_msg=n)


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    assert len(rows) == 2
    return rows[0], dict(zip(*rows))


@pytest.mark.parametrize("argv", [
    [], hypersim_flags(), hypersim_flags() + [
        "--exp_name=x", "--save_test_vis", "--ckpt_path=a/ckpt",
        "--weight_path=w.npz", "--save_checkpoint", "--val_only",
        "--downsample_vis=0.25"]])
def test_results_csv_matches_jax(tmp_path, argv):
    t, j = tcfg.TrainConfig.from_args(argv), jcfg.TrainConfig.from_args(argv)
    if not t.no_debug:
        t, j = t.debug_overrides(), j.debug_overrides()
    metrics = {"psnr": 21.5, "ssim": 0.25, "ang/clust/yaw_abs": 1.0 / 3}
    info = {"step": 100, "scene": "ai_042_042"}
    got, ref = str(tmp_path / "t.csv"), str(tmp_path / "j.csv")
    tres.save_results_csv(got, metrics, t, info=info)
    jres.save_results_csv(ref, metrics, j, info=info)
    (th, tv), (jh, jv) = _read_csv(got), _read_csv(ref)
    assert PARALLEL_COLUMNS <= set(th)
    assert th == jh
    assert tv == jv
    assert tv["metric/psnr"] == "21.5" and "param/eval.val_only" in tv
    assert tres._flatten_cfg(t) == jres._flatten_cfg(j)


def test_done_marker_and_summary_match_jax(tmp_path):
    for mod, d in ((tres, tmp_path / "t"), (jres, tmp_path / "j")):
        d.mkdir()
        mod.write_done_marker(str(d), "run")
        mod.save_run_summary(str(d / "summary.json"), {"psnr": 1.5})
    for name in ("run.done", "summary.json"):
        assert (tmp_path / "t" / name).read_bytes() == \
            (tmp_path / "j" / name).read_bytes()


@pytest.mark.parametrize("angles", [(0.0, 0.0, 0.0), (30.0, 0.0, 0.0),
                                    (10.0, -20.0, 5.0), (0.0, 0.0, 90.0)])
def test_R_offset_from_angles_matches_jax(angles):
    got, ref = trot.R_offset_from_angles(*angles), \
        jrot.R_offset_from_angles(*angles)
    if ref is None:
        assert got is None
        return
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)


def test_logger_writes_tensorboard_events(tmp_path):
    logger = tlog.MetricLogger(str(tmp_path))
    assert logger.tb is not None and logger.wandb is None
    logger.log_scalars({"loss": 0.5, "psnr": 20.0}, 10, prefix="train/")
    logger.log_image("val/x", np.zeros((4, 6, 3), np.uint8), 10)
    logger.close()
    events = [f for f in os.listdir(tmp_path) if "tfevents" in f]
    assert events and os.path.getsize(tmp_path / events[0]) > 0


def test_logger_warns_once_for_a_missing_backend(tmp_path, monkeypatch):
    """wandb absent (as on the card's machine): one warning, no W&B
    logs; the logger's calls still work."""
    monkeypatch.setitem(sys.modules, "wandb", None)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        logger = tlog.MetricLogger(str(tmp_path), use_wandb=True)
        logger.log_scalars({"loss": 1.0}, 1)
        logger.close()
    msgs = [str(w.message) for w in seen if "wandb" in str(w.message)]
    assert len(msgs) == 1 and logger.wandb is None
