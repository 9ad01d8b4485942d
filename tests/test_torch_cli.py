"""The port's training CLI (`python -m normal_clustering_nerf_torch.train_nerf`,
`main(argv, device="cpu")`) end to end on Hypersim-format files: the argv
of the JAX CLI's test (tests/test_hypersim_e2e.py:112-121, the debug
schedule: 100 steps, batch 256, grid 32) on the room of
`test_torch_common.write_hypersim_scene`, held to that test's assertions,
with the prediction archives and a checkpoint; a `--ckpt_path ...
--val_only` rerun gives the same metrics; `fit` logs at the steps the
JAX trainer's rule gives (trainer.py:445-459), checked against the JAX
`Trainer.fit` loop itself with its steps stubbed out."""
import contextlib
import io
import os
import re
import tarfile
import types

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
pytest.importorskip("h5py")

from test_torch_common import slice_configs, write_hypersim_scene  # noqa: E402

from normal_clustering_nerf_torch import train_nerf  # noqa: E402
from normal_clustering_nerf_torch.datasets.synthetic import (  # noqa: E402
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.training import Trainer as TTrainer  # noqa: E402
from normal_clustering_nerf_tpu.training import Trainer as JTrainer  # noqa: E402
from normal_clustering_nerf_tpu.training.state import TrainState  # noqa: E402

THREADS = 4   # the brick field's plain encode over the 16.8 M-value table


def _argv(scene_dir, log_root, exp_name, *extra):
    return ["--dataset_name", "hypersim", "--data_root_dir", scene_dir,
            "--downsample", "0.125",
            "--load_depth_gt", "--load_norm_gt", "--load_sem_WF_gt",
            "--exp_name", exp_name, "--log_root_dir", log_root,
            "--save_test_vis", *extra]


def _main(argv):
    """`main` with its stdout captured: (metrics, run dict, stdout)."""
    run, out = {}, io.StringIO()
    with contextlib.redirect_stdout(out):
        metrics = train_nerf.main(argv, device="cpu", run=run)
    return metrics, run, out.getvalue()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The training run (with the test predictions' archive and a
    checkpoint), then a `--val_only` run restored from its checkpoint
    that also exports the training views' archives (`--keep_N_tr=1`
    keeps one)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    try:
        root = tmp_path_factory.mktemp("cli")
        scene_dir = write_hypersim_scene(root / "ai_042_042")
        log_root = str(root / "logs")
        first = _main(_argv(scene_dir, log_root, "hypersim_e2e",
                            "--save_test_preds", "--save_checkpoint"))
        ckpt = os.path.join(log_root, "hypersim_e2e", "ckpt")
        second = _main(_argv(scene_dir, log_root, "val", "--ckpt_path",
                             ckpt, "--val_only", "--save_train_preds",
                             "--keep_N_tr=1"))
    finally:
        torch.set_num_threads(threads)
    return log_root, first, second


def test_cli_on_hypersim_format(runs):
    """tests/test_hypersim_e2e.py's assertions, on the port's CLI."""
    log_root, (metrics, run, out), _ = runs
    assert metrics["psnr"] > 8.0, metrics
    assert "norm_depth_ang_mean" in metrics
    assert "miou" in metrics
    csv_path = os.path.join(log_root, "hypersim_e2e", "results.csv")
    assert os.path.isfile(csv_path)
    with open(csv_path) as f:
        header = f.readline()
    assert "metric/psnr" in header and "param/" in header
    assert "info/step" in header and "info/scene" in header
    vis = os.listdir(os.path.join(log_root, "hypersim_e2e", "results"))
    assert any(x.endswith("_pred.png") for x in vis)
    assert any(x.endswith("_gt.png") for x in vis)
    assert run["trainer"].step == 100
    assert "validation: {" in out


def test_cli_writes_every_view_and_archive(runs):
    """A pred and a gt panel per held-out view, each the panel of the
    returned predictions; the test predictions' archive; the
    checkpoint; TensorBoard events."""
    log_root, (metrics, run, _), _ = runs
    tr, d = run["trainer"], os.path.join(log_root, "hypersim_e2e")
    scene = tr.scene_test
    from normal_clustering_nerf_torch.training.visualize import (
        pack_vis_panel)
    for i, img_id in enumerate(scene.img_ids):
        for tag in ("pred", "gt"):
            png = cv2.imread(os.path.join(d, "results", f"{img_id}_{tag}.png"))
            assert png is not None, (img_id, tag)
        panel = pack_vis_panel(tr._last_val_preds[i], n_classes=3,
                               downsample=tr.cfg.eval.downsample_vis)
        pred_png = cv2.imread(os.path.join(d, "results", f"{img_id}_pred.png"))
        np.testing.assert_array_equal(pred_png[..., ::-1], panel)
    with tarfile.open(os.path.join(d, "preds", "test_pred.tar.gz")) as tar:
        names = tar.getnames()
    assert len(names) == len(scene.img_ids) * len(tr._last_val_preds[0])
    assert os.path.isfile(os.path.join(d, "preds", "test_pred.done"))
    assert sorted(os.listdir(os.path.join(d, "ckpt"))) == [
        "layout_version.json", "state.pt"]
    assert any("tfevents" in f for f in os.listdir(d))


def test_val_only_rerun_gives_the_same_metrics(runs):
    log_root, (metrics, run, _), (metrics2, run2, out2) = runs
    assert metrics2 == metrics
    assert run2["trainer"].step == 100 and "fit" not in run2["times"]
    assert "step " not in out2
    d = os.path.join(log_root, "val", "preds")
    for tag in ("pred", "gt"):
        with tarfile.open(os.path.join(d, f"train_{tag}.tar.gz")) as tar:
            names = tar.getnames()
        assert os.path.isfile(os.path.join(d, f"train_{tag}.done"))
        img_id = run2["trainer"].scene_train.img_ids[0]
        assert f"{tag}.train.rgb.scene.{img_id}.npy" in names
        assert all(f".{img_id}.npy" in n for n in names)


def test_cli_log_lines_follow_the_jax_rule(runs):
    """The debug schedule's 100 steps in chunks of 16, logging every 10:
    a line after each chunk, none after the last 4 single steps."""
    _, (_, _, out), _ = runs
    steps = [int(s) for s in re.findall(r"^step (\d+)/100 loss=", out, re.M)]
    assert steps == _jax_log_steps(100, 0, 10)


def _jax_log_steps(total, start, log_every, interval=16):
    """The steps at which the JAX `Trainer.fit` logs, from its own loop:
    its steps, refreshes and marking replaced by counters."""
    jt = object.__new__(JTrainer)
    jcfg, _ = slice_configs()
    jt.cfg = jcfg.replace(optim=jcfg.optim.__class__(
        num_epochs=1, steps_per_epoch=total, update_interval=interval))
    jt.native_sampler, jt._prewarmed, jt.scene_dev = None, True, None
    jt.state = TrainState(None, None, None, np.int32(start), None)
    jt.mark_invisible_cells = lambda: None
    jt._occ_update = {w: (lambda occ, params, key: occ) for w in (0, 1)}
    metrics = {"loss_total": 0.5, "psnr": 20.0}

    def advance(n):
        return lambda st, scene: (st._replace(step=st.step + n), metrics)
    jt.step_fns = lambda step: (advance(1), advance(interval))
    lines = []
    jt.fit(log_every=log_every, log_fn=lines.append)
    return [int(re.match(r"step (\d+)/", s).group(1)) for s in lines]


@pytest.mark.parametrize("total,start,log_every", [
    (100, 0, 10), (100, 0, 100), (1000, 0, 100), (60, 20, 10), (50, 3, 7),
    (40, 0, 0), (30, 29, 1)])
def test_fit_logs_at_the_jax_steps(total, start, log_every):
    """The port's `fit` loop (chunks and single steps, refreshes at the
    interval, the log rule) with its chunks stubbed, against the JAX
    `fit` loop: the same log steps; a log reads one step's metrics."""
    _, cfg = slice_configs()
    tr = TTrainer(cfg, TSyn(split="train", img_wh=(8, 8),
                            n_images=2).load(), device="cpu")
    tr.step = start
    chunks, reads, lines = [], [], []

    def chunk(n, bootstrap=None):
        chunks.append(n)
        tr.step = tr.step + n

    def history(a, b):
        reads.append(b - a)
        return [{"loss_total": 0.5, "psnr": 20.0}] * (b - a)
    tr.train_chunk, tr._history = chunk, history
    tr.occ_update = types.MethodType(lambda self, warmup: None, tr)
    tr.fit(total - start, log_every=log_every, log_fn=lines.append)
    steps = [int(re.match(r"step (\d+)/", s).group(1)) for s in lines]
    assert steps == _jax_log_steps(total, start, log_every)
    assert reads == [1] * len(steps) + [total - start]
    assert all(s.startswith(f"step {n}/{total} loss=0.5000 psnr=20.00 ")
               for s, n in zip(lines, steps))
    # whole chunks wherever one fits before the end: a log splits none
    want, step = [], start
    while step < total:
        want.append(16 if step % 16 == 0 and step + 16 <= total else 1)
        step += want[-1]
    assert chunks == want
