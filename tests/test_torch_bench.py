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


@pytest.mark.parametrize("layout", ["triplane", "brick", "tcnn"])
def test_bench_config_matches_bench_py(monkeypatch, layout):
    """bench.py:44-109 at bench.py's defaults (bf16, 16 samples per ray,
    24 sv intervals) with each `--hash_layout` (triplane by default):
    every field the port's config has takes the JAX value, and the scenes
    are the same."""
    monkeypatch.setattr(j_synthetic, "SyntheticDataset", _Scene)
    monkeypatch.setattr(j_training, "Trainer", lambda *a: a)
    (_, scene_tr, scene_te), jcfg = jax_bench.build_trainer(
        8192, compute_dtype="bfloat16", hash_layout=layout,
        samples_per_ray=16, sv_intervals=24)
    assert scene_tr == dict(split="train", img_wh=(128, 128), n_images=48)
    assert scene_te == dict(split="test", img_wh=(128, 128), n_images=4)
    cfg = (bench.bench_config() if layout == "triplane"
           else bench.bench_config(hash_layout=layout))
    assert cfg.model.per_level_scale == jcfg.model.per_level_scale
    for part in ("model", "render", "loss", "data", "optim"):
        ours, ref = getattr(cfg, part), getattr(jcfg, part)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(ref, f.name), \
                f"{part}.{f.name}"
    assert cfg.seed == jcfg.seed


# (port argv, jax_bench.build_trainer keywords): each flag of
# bench.py:143-161 that changes the configuration, alone and together
FLAG_CASES = [
    ([], {}),
    (["--samples_per_ray", "32"], dict(samples_per_ray=32)),
    (["--samples_per_ray", "64"], dict(samples_per_ray=64)),
    (["--min_losses"], dict(min_losses=True)),
    (["--batch", "4096"], dict(batch=4096)),
    (["--compute_dtype", "float32"], dict(compute_dtype="float32")),
    (["--sv_intervals", "8"], dict(sv_intervals=8)),
    (["--hash_layout", "brick", "--min_losses", "--samples_per_ray", "24",
      "--batch", "4096"],
     dict(hash_layout="brick", min_losses=True, samples_per_ray=24,
          batch=4096)),
]


@pytest.mark.parametrize("argv,jax_kw", FLAG_CASES,
                         ids=[" ".join(a) or "defaults" for a, _ in FLAG_CASES])
def test_bench_flags_match_bench_py(monkeypatch, argv, jax_kw):
    """The configuration the port's flags build equals bench.py's
    `build_trainer` at the same flags, field by field (bench.py's
    defaults for the rest: batch 8192, bf16, triplane, 16 samples a ray,
    24 sv intervals, the production losses)."""
    monkeypatch.setattr(j_synthetic, "SyntheticDataset", _Scene)
    monkeypatch.setattr(j_training, "Trainer", lambda *a: a)
    kw = dict(batch=8192, compute_dtype="bfloat16", hash_layout="triplane",
              samples_per_ray=16, sv_intervals=24, min_losses=False)
    kw.update(jax_kw)
    _, jcfg = jax_bench.build_trainer(kw.pop("batch"), **kw)
    cfg = bench.config_of(bench.parse_args(argv))
    for part in ("model", "render", "loss", "data", "optim"):
        ours, ref = getattr(cfg, part), getattr(jcfg, part)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(ref, f.name), \
                f"{part}.{f.name}"
    assert cfg.seed == jcfg.seed


def test_bench_run_flags():
    """The flags that shape the run and not the configuration: the cost
    probes, the trace and the throughput-only run; `--num_chips 2` parses
    (ROADMAP A10); any number of samples a ray parses, 33 and 64
    included (past one lane group of H3's backward); fewer than one card
    is refused."""
    args = bench.parse_args(["--no_occ_update", "--skip-quality",
                             "--profile", "trace_dir"])
    assert args.no_occ_update and args.skip_quality
    assert args.profile == "trace_dir"
    defaults = bench.parse_args([])
    assert not (defaults.no_occ_update or defaults.skip_quality
                or defaults.min_losses or defaults.profile)
    assert defaults.num_chips == 1
    assert bench.parse_args(["--num_chips", "2"]).num_chips == 2
    for k in (33, 64):
        assert bench.parse_args(["--samples_per_ray", str(k)]
                                ).samples_per_ray == k
    with pytest.raises(SystemExit):
        bench.parse_args(["--num_chips", "0"])


@pytest.mark.parametrize("num_chips", [2, 4])
def test_num_chips_splits_the_batch_as_bench_py(monkeypatch, num_chips):
    """`--num_chips N` builds bench.py's configuration at num_chips N
    (ParallelConfig mesh (N,), the same global batch), field by field
    with no exception: the march budget is the global batch's on every
    rank (bench.py:62), so a rank of 8192 / N rays marches 16 N samples a
    ray."""
    monkeypatch.setattr(j_synthetic, "SyntheticDataset", _Scene)
    monkeypatch.setattr(j_training, "Trainer", lambda *a: a)
    _, jcfg = jax_bench.build_trainer(
        8192, num_chips=num_chips, compute_dtype="bfloat16",
        hash_layout="triplane", samples_per_ray=16, sv_intervals=24)
    cfg = bench.config_of(bench.parse_args(["--num_chips", str(num_chips)]))
    assert dataclasses.asdict(cfg.parallel) == \
        dataclasses.asdict(jcfg.parallel)
    assert cfg.data.batch_size == jcfg.data.batch_size == 8192
    assert cfg.render.sample_budget == jcfg.render.sample_budget == 8192 * 16
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--hash_layout", "brick"])
    with pytest.raises(SystemExit):   # bench.py's three choices only
        bench.main(["--hash_layout", "grid"])
    with pytest.raises(RuntimeError, match="2 cards; 0 are visible"):
        bench.main(["--num_chips", "2"])
