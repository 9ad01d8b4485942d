"""The port's bench entry point (`normal_clustering_nerf_torch/bench.py`)
against the JAX package's `bench.py`: the same configuration, field by
field, and the same four quality gates; and no run without a card.
"""
import dataclasses

import pytest
import torch

import bench as jax_bench
import normal_clustering_nerf_tpu.datasets.synthetic as j_synthetic
import normal_clustering_nerf_tpu.training as j_training
from normal_clustering_nerf_torch import bench


class _Scene:
    def __init__(self, **kw):
        self.kw = kw

    def load(self):
        return self.kw


def test_bench_config_matches_bench_py(monkeypatch):
    """bench.py:44-109 at bench.py's defaults (triplane, bf16, 16 samples
    per ray, 24 sv intervals): every field the port's config has takes
    the JAX value, and the scenes are the same."""
    monkeypatch.setattr(j_synthetic, "SyntheticDataset", _Scene)
    monkeypatch.setattr(j_training, "Trainer", lambda *a: a)
    (_, scene_tr, scene_te), jcfg = jax_bench.build_trainer(
        8192, compute_dtype="bfloat16", hash_layout="triplane",
        samples_per_ray=16, sv_intervals=24)
    assert scene_tr == dict(split="train", img_wh=(128, 128), n_images=48)
    assert scene_te == dict(split="test", img_wh=(128, 128), n_images=4)
    cfg = bench.bench_config()
    for part in ("model", "render", "loss", "data", "optim"):
        ours, ref = getattr(cfg, part), getattr(jcfg, part)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(ref, f.name), \
                f"{part}.{f.name}"
    assert cfg.seed == jcfg.seed


PASS = {"psnr": 34.0, "trunc_ray_frac": 0.0, "norm_depth_ang_mean": 18.0,
        "rot_yaw_abs": 0.3, "rot_pitch_abs": 3.5, "rot_roll_abs": 3.2}


@pytest.mark.parametrize("key,value", [
    (None, None), ("psnr", 29.99), ("trunc_ray_frac", 0.011),
    ("norm_depth_ang_mean", 30.01), ("rot_pitch_abs", 5.01),
    ("rot_roll_abs", "missing"), ("psnr", float("nan"))])
def test_gates_are_bench_py_gates(key, value):
    out = dict(PASS)
    if value == "missing":
        del out[key]
    elif key is not None:
        out[key] = value
    fails = bench.gate_failures(out)
    assert len(fails) == (0 if key is None else 1), fails


def test_bench_needs_the_card():
    """No fallback: without a card the bench raises before it trains."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run for minutes")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main([])
