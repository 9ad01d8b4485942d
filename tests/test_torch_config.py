"""The port's `TrainConfig.from_args` against the JAX package's, field by
field, on the argv of each published preset (experiments/
hyperparameters.py), on a few flags off their defaults and on each flag
of the checkpoints and exports; `debug_overrides` against JAX's; the
flags the port refuses, each naming its ROADMAP item; and the smoke's
Hypersim argv literal against `hypersim_flags()`. Exact: the configs
are plain values."""
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

SUBCONFIGS = ("model", "render", "loss", "data", "optim", "eval")
TOP_LEVEL = ("exp_name", "log_root_dir", "seed", "no_debug", "ckpt_path",
             "weight_path", "save_checkpoint")
OFF_DEFAULTS = ["--seed=3", "--exp_name=x", "--random_tr_poses",
                "--keep_N_tr=5", "--random_bg", "--compute_dtype=bfloat16",
                "--anneal_strategy=avoid_near", "--anneal_steps=600",
                "--loss_sem_w=0.04", "--pred_sem", "--pred_norm_nn",
                "--triang_max_expand=3", "--grad_clip=0.1", "--num_chips=1",
                "--data_root_dir=/data/scene"]


def _assert_same(argv, debug=False):
    t, j = tcfg.TrainConfig.from_args(argv), jcfg.TrainConfig.from_args(argv)
    if debug:
        t, j = t.debug_overrides(), j.debug_overrides()
    for f in TOP_LEVEL:
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


# the flags of the checkpoints and exports (ROADMAP A6): (flag, the
# config field it sets, its value)
A6_FLAGS = (("--val_only", "eval.val_only", True),
            ("--save_test_vis", "eval.save_test_vis", True),
            ("--downsample_vis=0.25", "eval.downsample_vis", 0.25),
            ("--save_test_preds", "eval.save_test_preds", True),
            ("--save_train_preds", "eval.save_train_preds", True),
            ("--downsample_pred_save=0.25", "eval.downsample_pred_save", 0.25),
            ("--ckpt_path=logs/run/ckpt", "ckpt_path", "logs/run/ckpt"),
            ("--weight_path=w.npz", "weight_path", "w.npz"),
            ("--save_checkpoint", "save_checkpoint", True))


@pytest.mark.parametrize("flag,field,value", A6_FLAGS)
def test_checkpoint_and_export_flags_build_the_jax_config(flag, field,
                                                          value):
    t = _assert_same(hypersim_flags() + [flag])
    for name in field.split("."):
        t = getattr(t, name)
    assert t == value


@pytest.mark.parametrize("argv", [[], ["--dataset_name=synthetic",
                                       "--random_bg"], hypersim_flags()])
def test_debug_overrides_match_jax(argv):
    t = _assert_same(argv, debug=True)
    assert (t.model.grid_size, t.data.batch_size, t.render.march_block,
            t.optim.num_epochs * t.optim.steps_per_epoch) == (32, 256, 128,
                                                            100)


@pytest.mark.parametrize("flag,item", [("--num_chips=4", "A10")])
def test_unported_flags_are_refused(flag, item):
    """The CLI refuses them naming their ROADMAP item: more than one card
    when it parses the flags (extrinsic optimisation trains:
    tests/test_torch_extrinsics.py; --eval_lpips passes through:
    tests/test_torch_lpips.py)."""
    from normal_clustering_nerf_torch.train_nerf import main
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        main([flag, "--dataset_name=synthetic"], device="cpu")
