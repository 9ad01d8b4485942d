"""The port's `TrainConfig.from_args` against the JAX package's, field by
field, on the argv of each published preset (experiments/
hyperparameters.py) and on a few flags off their defaults; and the
smoke's Hypersim argv literal against `hypersim_flags()`. Exact: the
configs are plain values."""
import dataclasses
import os
import sys

import pytest

import normal_clustering_nerf_torch.config as tcfg
import normal_clustering_nerf_tpu.config as jcfg

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                "experiments"))
from hyperparameters import PRESETS, hypersim_flags  # noqa: E402

import chip_smoke  # noqa: E402

SUBCONFIGS = ("model", "render", "loss", "data", "optim")
OFF_DEFAULTS = ["--seed=3", "--exp_name=x", "--random_tr_poses",
                "--keep_N_tr=5", "--random_bg", "--compute_dtype=bfloat16",
                "--anneal_strategy=avoid_near", "--anneal_steps=600",
                "--loss_sem_w=0.04", "--pred_sem", "--pred_norm_nn",
                "--triang_max_expand=3", "--grad_clip=0.1", "--num_chips=1",
                "--data_root_dir=/data/scene"]


def _assert_same(argv):
    t, j = tcfg.TrainConfig.from_args(argv), jcfg.TrainConfig.from_args(argv)
    for f in ("exp_name", "log_root_dir", "seed", "no_debug"):
        assert getattr(t, f) == getattr(j, f), f
    for sub in SUBCONFIGS:
        ts, js = dataclasses.asdict(getattr(t, sub)), \
            dataclasses.asdict(getattr(j, sub))
        assert ts == js, (sub, {k: (v, js.get(k)) for k, v in ts.items()
                                if js.get(k) != v})
    return t


@pytest.mark.parametrize("preset", sorted(PRESETS))
@pytest.mark.parametrize("ours", [True, False])
def test_preset_argv_builds_the_jax_config(preset, ours):
    t = _assert_same(PRESETS[preset](ours=ours))
    assert t.data.ray_sampling_strategy == "all_images_triang_patch"
    assert t.model.hash_layout == "brick" and t.render.sample_budget == 0


def test_flags_off_their_defaults():
    t = _assert_same(hypersim_flags() + OFF_DEFAULTS)
    assert t.data.random_tr_poses and t.data.keep_N_tr == 5
    _assert_same([])


def test_smoke_argv_is_the_hypersim_preset():
    assert list(chip_smoke.HYPERSIM_ARGV) == hypersim_flags()


@pytest.mark.parametrize("flag", ["--eval_lpips", "--val_only",
                                  "--save_checkpoint", "--num_chips=4",
                                  "--ckpt_path=x.npz"])
def test_unported_flags_are_refused(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tcfg.TrainConfig.from_args([flag])
