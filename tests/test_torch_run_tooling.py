"""The port's run tooling around its entry points, on the CPU: the bench's
history file (`bench.record_history`: the port's own file, the best at the
same config on a card of the same name, the >10% regression warning),
the published presets (`normal_clustering_nerf_torch.experiments.
hyperparameters`, the port's copy) against the repository's
`experiments/hyperparameters.py`, the scene sweep (`experiments.
run_sweep`: its commands, host striding and failure accounting with the
runs stubbed), and the numpy pose utilities against the JAX package's.

Tolerances: the presets, the commands and the history are exact; the pose
utilities are the same numpy operations in the same order, so exact too.
"""
import ast
import json
import os
from pathlib import Path

import numpy as np
import pytest

from experiments import hyperparameters as jhp
from normal_clustering_nerf_torch import bench
from normal_clustering_nerf_torch.datasets import ray_utils as tru
from normal_clustering_nerf_torch.experiments import hyperparameters as thp
from normal_clustering_nerf_torch.experiments import run_sweep
from normal_clustering_nerf_torch.utils import rotations as trot
from normal_clustering_nerf_tpu.datasets import ray_utils as jru
from normal_clustering_nerf_tpu.utils import rotations as jrot

ROOT = Path(__file__).resolve().parent.parent
CONFIG = {"batch": 8192, "compute_dtype": "bfloat16",
          "hash_layout": "triplane", "samples_per_ray": 16,
          "sv_intervals": 24, "num_chips": 1}
H100 = {"name": "NVIDIA H100 80GB HBM3", "power_limit": "700.00 W"}


# ----------------------------------------------------------- bench history
def test_history_is_the_ports_own_ignored_file():
    assert Path(bench.HISTORY) == ROOT / "bench_history_torch.jsonl"
    ignored = (ROOT / ".gitignore").read_text().splitlines()
    assert "bench_history_torch.jsonl" in ignored
    assert "bench_history.jsonl" not in ignored
    assert bench.run_config(bench.parse_args([])) == CONFIG


@pytest.mark.parametrize("value, warns", [(89_900.0, True),
                                          (90_100.0, False)])
def test_history_appends_and_warns_past_ten_percent(tmp_path, value, warns):
    """The best at the same config on a card of the same name is 100,000
    rays/s (a faster record at another config, and one on another card,
    do not count): 89,900 is -10.1% and warns, 90,100 is -9.9% and does
    not. Every call appends its record with config, card and time."""
    path = str(tmp_path / "history.jsonl")
    logs = []
    other = dict(CONFIG, batch=4096)
    a100 = {"name": "NVIDIA A100-SXM4-80GB", "power_limit": "400.00 W"}
    assert bench.record_history({"value": 100_000.0}, CONFIG, H100,
                                logs.append, path) is None
    assert logs == []
    bench.record_history({"value": 95_000.0}, CONFIG, H100, logs.append,
                         path)
    bench.record_history({"value": 150_000.0}, other, H100, logs.append,
                         path)
    bench.record_history({"value": 200_000.0}, CONFIG, a100, logs.append,
                         path)
    logs.clear()
    delta = bench.record_history({"value": value, "psnr": 39.1}, CONFIG,
                                 H100, logs.append, path)
    assert delta == pytest.approx((value - 1e5) / 1e3)
    assert logs[0].startswith("throughput vs best recorded at this config "
                              f"on {H100['name']}: {delta:+.1f}%")
    assert any("WARNING" in m for m in logs) == warns
    recs = [json.loads(x) for x in Path(path).read_text().splitlines()]
    assert len(recs) == 5
    assert recs[-1]["value"] == value and recs[-1]["psnr"] == 39.1
    assert recs[-1]["config"] == CONFIG and recs[-1]["card"] == H100
    assert recs[-1]["time"][:2] == "20"


# ------------------------------------------------------------------ presets
@pytest.mark.parametrize("dataset", sorted(jhp.PRESETS))
def test_presets_are_the_repositorys(dataset):
    assert sorted(thp.PRESETS) == sorted(jhp.PRESETS)
    for ours in (True, False):
        for epochs in (1, 7, 30):
            assert thp.PRESETS[dataset](ours=ours, epochs=epochs) == (
                jhp.PRESETS[dataset](ours=ours, epochs=epochs))
    assert thp.hypersim_flags(downsample=0.5) == jhp.hypersim_flags(
        downsample=0.5)


def test_the_package_imports_no_top_level_experiments():
    """The port keeps its own copy: none of its modules imports the
    repository's `experiments` package."""
    for p in (ROOT / "normal_clustering_nerf_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(p.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            assert not any(n.split(".")[0] == "experiments" for n in names), p


# -------------------------------------------------------------------- sweep
def _scenes(tmp_path, names=("a", "b", "c", "d", "e")):
    root = tmp_path / "data"
    for n in names:
        (root / n).mkdir(parents=True)
    (root / "not_a_scene.txt").write_text("")
    return root


def test_sweep_dry_run_prints_the_port_cli_per_scene(tmp_path, capsys):
    """`--dry_run` prints one command a scene of this host's share (every
    2nd scene from the 2nd: b, d) and runs none; the command is the
    port's CLI with the scene's paths, the preset and the extra flags."""
    root, logs = _scenes(tmp_path), tmp_path / "logs"
    rc = run_sweep.main(["--dataset", "scannet_manhattan", "--data_root",
                         str(root), "--log_root", str(logs), "--epochs", "2",
                         "--num_hosts", "2", "--host_id", "1", "--dry_run",
                         "--extra=--seed=3"])
    lines = capsys.readouterr().out.splitlines()
    cmds = [x.split()[1:] for x in lines if x.startswith("[sweep] ") and
            " -m " in x]
    preset = thp.PRESETS["scannet_manhattan"](ours=True, epochs=2)
    assert [c[3] for c in cmds] == ["--data_root_dir=" + str(root / "b"),
                                    "--data_root_dir=" + str(root / "d")]
    for cmd, scene in zip(cmds, ("b", "d")):
        assert cmd[1:3] == ["-m", "normal_clustering_nerf_torch.train_nerf"]
        assert cmd[4:6] == [f"--log_root_dir={logs}", f"--exp_name={scene}"]
        assert cmd[6:] == preset + ["--seed=3"]
    assert rc == 0 and not logs.exists()
    rc = run_sweep.main(["--dataset", "hypersim", "--data_root", str(root),
                         "--log_root", str(logs), "--scenes", "x", "y", "z",
                         "--num_hosts", "2", "--dry_run", "--method",
                         "baseline"])
    out = capsys.readouterr().out
    assert "--exp_name=x" in out and "--exp_name=z" in out
    assert "--exp_name=y" not in out and "--pred_norm_depth" not in out


def test_sweep_reruns_only_the_failed_and_counts_failures(tmp_path, capsys,
                                                          monkeypatch):
    """With `--rerun_failed` a scene with results.csv is skipped; a run
    that writes no results.csv, and one that exits non-zero, fail; the
    sweep exits 1."""
    root, logs = _scenes(tmp_path, ("a", "b", "c", "d")), tmp_path / "logs"
    (logs / "a").mkdir(parents=True)
    (logs / "a" / "results.csv").write_text("metric/psnr\n30\n")
    ran = []

    def call(cmd):
        scene = next(x for x in cmd if x.startswith("--exp_name="))[11:]
        ran.append(scene)
        if scene in ("b", "d"):   # d writes its results but exits 1
            os.makedirs(logs / scene, exist_ok=True)
            (logs / scene / "results.csv").write_text("metric/psnr\n31\n")
        return 1 if scene == "d" else 0
    monkeypatch.setattr(run_sweep.subprocess, "call", call)
    rc = run_sweep.main(["--dataset", "replica_semnerf", "--data_root",
                         str(root), "--log_root", str(logs),
                         "--rerun_failed"])
    out = capsys.readouterr().out
    assert ran == ["b", "c", "d"]
    assert "[sweep] FAILED: c (rc=0)" in out
    assert "[sweep] FAILED: d (rc=1)" in out
    assert out.splitlines()[-1] == ("[sweep] done: 2 ok, 2 failed: "
                                    "['c', 'd']")
    assert rc == 1
    ran.clear()
    assert run_sweep.main(["--dataset", "replica_semnerf", "--data_root",
                           str(root), "--log_root", str(logs), "--scenes",
                           "a", "b"]) == 0
    assert ran == ["a", "b"]


# ----------------------------------------------------------- pose utilities
def _rotation(axis, angle):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


@pytest.mark.parametrize("case", ["trace > 0", "x", "y", "z"])
def test_quaternions_match_jax(case):
    """Each branch of `matrix_to_quaternion`: trace > 0 (a small
    rotation), else the largest diagonal entry's (a rotation near pi about
    a direction near that axis), and `quaternion_to_matrix` back."""
    rng = np.random.default_rng(5)
    for _ in range(4):
        if case == "trace > 0":
            R = _rotation(rng.standard_normal(3), rng.uniform(0.1, 1.5))
        else:
            i = "xyz".index(case)
            axis = 0.2 * rng.standard_normal(3)
            axis[i] = 1.0
            R = _rotation(axis, rng.uniform(2.9, 3.1))
            assert np.trace(R) <= 0 and np.argmax(np.diag(R)) == i
        q = trot.matrix_to_quaternion(R)
        np.testing.assert_array_equal(q, jrot.matrix_to_quaternion(R))
        q4 = rng.standard_normal(4)
        np.testing.assert_array_equal(trot.quaternion_to_matrix(q4),
                                      jrot.quaternion_to_matrix(q4))
        np.testing.assert_allclose(trot.quaternion_to_matrix(q), R,
                                   atol=1e-12)


def test_pose_helpers_match_jax():
    rng = np.random.default_rng(11)
    poses = np.concatenate([
        np.stack([_rotation(rng.standard_normal(3), rng.uniform(0, 3))
                  for _ in range(9)]),
        rng.standard_normal((9, 3, 1))], -1)
    pts = rng.standard_normal((50, 3))
    v = rng.standard_normal(3)
    np.testing.assert_array_equal(tru.normalize_np(v), jru.normalize_np(v))
    for p3 in (None, pts):
        np.testing.assert_array_equal(tru.average_poses(poses, p3),
                                      jru.average_poses(poses, p3))
    np.testing.assert_array_equal(tru.center_poses(poses),
                                  jru.center_poses(poses))
    for got, ref in zip(tru.center_poses(poses, pts),
                        jru.center_poses(poses, pts)):
        np.testing.assert_array_equal(got, ref)
    for n in (1, 7, 120):
        got = tru.create_spheric_poses(1.3, 0.2, n)
        assert got.shape == (n, 3, 4)
        np.testing.assert_array_equal(got, jru.create_spheric_poses(1.3, 0.2,
                                                                    n))
