"""The port's own trainer, without JAX: a few bootstrap steps on the CPU
at the slice configuration (tests/test_torch_common.py:slice_configs),
steps of the marches after the bootstrap, and the refusal to run
anywhere but on the card unless asked.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from test_torch_common import replace_model, slice_configs

from normal_clustering_nerf_torch.datasets.synthetic import SyntheticDataset
from normal_clustering_nerf_torch.device import resolve_device
from normal_clustering_nerf_torch.training import Trainer


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataset(split="train", img_wh=(24, 24), n_images=6).load()


def test_a_few_steps_give_a_finite_falling_loss(scene):
    _, cfg = slice_configs()
    tr = Trainer(cfg, scene, device="cpu")
    tr.mark_invisible_cells()
    hist = tr.fit(20)
    assert tr.step == 20
    for m in hist:
        assert all(math.isfinite(v) for k, v in m.items()
                   if k.startswith("loss_")), m
        assert 0 < m["rm_samples_per_ray"] <= 16
    loss = np.array([m["loss_total"] for m in hist])
    # the random background makes single steps noisy: compare quarters
    assert loss[-5:].mean() < 0.75 * loss[:5].mean(), loss


@pytest.mark.parametrize("render", [dict(march_coarse=False),
                                    dict(march_layout="flat")])
def test_steps_after_the_bootstrap_are_refused(scene, render):
    """Steps after the bootstrap without the supervoxel-run march (the
    bitfield march over march_block steps) and in the flat layout train
    (tests/test_torch_slice.py holds them against JAX); a scene past scale
    0.5 (several cascades and the geometric step grid), once refused,
    trains too: its steps after the bootstrap have finite losses
    (tests/test_torch_cascades.py holds them against JAX)."""
    _, cfg = slice_configs()
    cfg = cfg.replace(render=dataclasses.replace(cfg.render, **render))
    tr = Trainer(cfg, scene, device="cpu")
    tr.occ_update(warmup=True)
    for _ in range(2):
        m = tr.train_step_core(bootstrap=False)
        assert math.isfinite(float(m["loss_total"]))
        assert 0 < float(m["rm_samples_per_ray"]) <= 16
        assert float(m["trunc_ray_frac"]) == 0.0
    big = Trainer(replace_model(cfg, scale=1.0), scene, device="cpu")
    assert big.model.cfg.cascades == 2
    big.occ_update(warmup=True)
    for _ in range(2):
        m = big.train_step_core(bootstrap=False)
        assert math.isfinite(float(m["loss_total"]))
        assert 0 < float(m["rm_samples_per_ray"]) <= 16


def test_the_card_is_the_default_device(scene):
    _, cfg = slice_configs()
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, scene)
    assert resolve_device("cpu").type == "cpu"
