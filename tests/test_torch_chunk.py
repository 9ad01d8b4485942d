"""The port's chunked training (`Trainer.fit` / `Trainer.train_chunk`, the
JAX trainer's `_make_chunk_fn`) and what its CUDA graphs rely on, on the
CPU: the step table against the host functions it is built from (bit
for bit) and against the JAX schedule (within f32 rounding), the
occupancy refresh in place, `fit` through chunks against the per-step
loop (bit for bit), and the launch counts of graph replays (a stub graph:
no graph runs on the CPU).

JAX schedule tolerance: rtol 2^-21 and atol 2^-22 (a few f32 ulps at 1):
the JAX side raises f32 to an int32 power and divides an int32 step, the
host functions work in numpy f32 and Python doubles.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import slice_configs

from normal_clustering_nerf_torch import kernels
from normal_clustering_nerf_torch.datasets.synthetic import SyntheticDataset
from normal_clustering_nerf_torch.losses import loss_schedule
from normal_clustering_nerf_torch.models.rendering import anneal_schedule
from normal_clustering_nerf_torch.training import Trainer
from normal_clustering_nerf_torch.training.state import (
    SCHEDULE_COLUMNS, AdamW, schedule_table,
)
from normal_clustering_nerf_tpu import losses as jl
from normal_clustering_nerf_tpu.training.state import cosine_epoch_schedule

STEPS = 4001   # steps 0..4000: the bench run and its last count


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataset(split="train", img_wh=(24, 24), n_images=6).load()


def test_step_table_is_the_host_functions_and_the_jax_schedule():
    """Every column at every step 0..4000, for the bench configuration
    with a clustering window that closes at step 3000."""
    _, cfg = slice_configs()
    cfg = cfg.replace(loss=dataclasses.replace(cfg.loss, norm_can_end=3000))
    opt = AdamW({"w": torch.zeros(1)}, cfg.optim)
    table = schedule_table(opt, cfg, STEPS, "cpu")
    assert table.dtype == torch.float32
    assert table.shape == (STEPS, len(SCHEDULE_COLUMNS))
    col = {c: table[:, j].numpy() for j, c in enumerate(SCHEDULE_COLUMNS)}
    f32 = np.float32
    for i in range(STEPS):
        # the optimizer's formulas as its step computed them on the host
        want = {"lr": opt.lr(i),
                "bc1": float(f32(1.0) - f32(0.9) ** f32(i + 1)),
                "bc2": float(f32(1.0) - f32(0.999) ** f32(i + 1))}
        want.update(loss_schedule(cfg.loss, i))
        n_i, on = anneal_schedule(i, cfg.render.anneal_steps,
                                  cfg.render.anneal_strategy)
        want.update(anneal_n_i=n_i, anneal_on=float(on))
        for c in SCHEDULE_COLUMNS:
            assert col[c][i] == f32(want[c]), (c, i)
    for c in ("anneal_on", "in_window", "after_start"):
        assert set(np.unique(col[c])) == {0.0, 1.0}, c

    steps = jnp.arange(STEPS)
    o, lc = cfg.optim, cfg.loss
    ref = {"lr": cosine_epoch_schedule(o.lr, o.num_epochs,
                                       o.steps_per_epoch)(steps),
           "bc1": 1.0 - jnp.float32(0.9) ** (steps + 1),
           "bc2": 1.0 - jnp.float32(0.999) ** (steps + 1),
           "anneal_n_i": jnp.where(steps < cfg.render.anneal_steps,
                                   jnp.clip(steps / cfg.render.anneal_steps,
                                            0.5, 1.0), 1.0),
           "anneal_on": steps < cfg.render.anneal_steps,
           "in_window": (steps <= lc.norm_can_end) | (lc.norm_can_end == -1),
           "after_start": steps > lc.norm_can_start}
    for t in ("norm_D_C_ort_dot", "norm_D_C_centr_dot", "norm_D_C_centr_L1",
              "norm_D_C_can_dot", "norm_D_C_can_L1"):
        ref[f"w_{t}"] = jl.w_sched(getattr(lc, f"{t}_w"), steps,
                                   lc.norm_can_start, lc.norm_can_grow)
    assert set(ref) == set(SCHEDULE_COLUMNS)
    for c, r in ref.items():
        np.testing.assert_allclose(col[c], np.asarray(r, np.float32),
                                   rtol=2 ** -21, atol=2 ** -22, err_msg=c)


@pytest.mark.parametrize("warmup", [True, False])
def test_refresh_keeps_the_state_storages(scene, warmup):
    """A refresh writes into the trainer's own tensors (their data_ptr
    unchanged) the values a fresh `OccupancyGrid.update` returns from the
    same state and draws."""
    _, cfg = slice_configs()
    tr = Trainer(cfg, scene, device="cpu")
    tr.mark_invisible_cells()
    tr.occ_update(warmup=True)
    ptrs = [t.data_ptr() for t in tr.occ]
    rng = np.random.default_rng(3)
    G3 = cfg.model.grid_size ** 3
    n = G3 if warmup else G3 // 2
    jitter = torch.as_tensor(rng.random((1, n, 3), dtype=np.float32))
    draws = None if warmup else {
        "uniform": torch.as_tensor(rng.integers(0, G3, (1, G3 // 4))),
        "occ_u": torch.as_tensor(rng.random((1, G3 // 4), dtype=np.float32))}
    before = type(tr.occ)(*(t.clone() for t in tr.occ))
    ref = tr.occ_grid.update(before, tr.model.density,
                             tr.density_threshold(), warmup, jitter=jitter,
                             cell_draws=draws)
    tr.occ_update(warmup, jitter=jitter, cell_draws=draws)
    assert [t.data_ptr() for t in tr.occ] == ptrs
    for name, got, want in zip(tr.occ._fields, tr.occ, ref):
        assert torch.equal(got, want), name
    assert int(tr.occ.density_bitfield.ne(0).sum()) > 0
    # an assigned state is copied in as well
    tr.occ = before
    assert [t.data_ptr() for t in tr.occ] == ptrs
    assert all(torch.equal(a, b) for a, b in zip(tr.occ, before))


def _chunk_config():
    """The slice configuration with a refresh every 4 steps, the bootstrap
    march for 8, the annealing over 6, the clustering ramp over steps 3-9
    and its window closing after step 11, 2 epochs of 5 steps."""
    _, cfg = slice_configs()
    return cfg.replace(
        render=dataclasses.replace(cfg.render, bootstrap_steps=8,
                                   anneal_steps=6),
        optim=dataclasses.replace(cfg.optim, update_interval=4,
                                  warmup_steps=6, num_epochs=2,
                                  steps_per_epoch=5),
        loss=dataclasses.replace(cfg.loss, norm_can_start=3, norm_can_grow=6,
                                 norm_can_end=11))


def test_fit_through_chunks_is_the_step_loop(scene, monkeypatch):
    """`fit(1)` then `fit(13)` (refreshes at steps 0, 4, 8 and 12, whole
    chunks at 4-7 and 8-11, single steps elsewhere; the bootstrap switch
    at 8) against the per-step loop with the same refreshes: every step's
    metrics, the parameters, the moments and the occupancy bit for bit.
    The step table grows past its 10 rows on the way."""
    cfg = _chunk_config()
    chunked, looped = (Trainer(cfg, scene, device="cpu") for _ in range(2))
    calls = []
    real = Trainer.train_chunk

    def spy(self, n, bootstrap=None):
        calls.append(n)
        return real(self, n, bootstrap)
    monkeypatch.setattr(Trainer, "train_chunk", spy)
    chunked.mark_invisible_cells()
    hist = chunked.fit(1) + chunked.fit(13)
    assert calls == [1, 1, 1, 1, 4, 4, 1, 1]
    assert chunked.step == 14 and chunked.opt.state["count"] == 14

    looped.mark_invisible_cells()
    ref = []
    for step in range(14):
        if step % 4 == 0:
            looped.occ_update(warmup=step < 6)
        m = looped.train_step_core(bootstrap=step < 8)
        ref.append({k: float(v) for k, v in m.items()})
    assert hist == ref
    for n, p in chunked.params.items():
        assert torch.equal(p, looped.params[n]), n
        for k in ("mu", "nu"):
            assert torch.equal(chunked.opt.state[k][n],
                               looped.opt.state[k][n]), (k, n)
    assert all(torch.equal(a, b) for a, b in zip(chunked.occ, looped.occ))
    losses = np.array([m["loss_total"] for m in hist])
    assert np.isfinite(losses).all()


def test_replays_add_the_captured_launch_counts():
    """`capture_counts` takes a capture's launch calls off the counts and
    keeps them; each `CountedGraph.replay` replays the graph and adds
    them back."""
    class StubGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    saved = kernels.counts()
    try:
        kernels.reset_counts()
        kernels.MARCH.launches = 5
        with kernels.capture_counts() as rec:
            # what Kernel.launch does for each call inside a capture
            kernels.MARCH.launches += 1
            kernels.COMPOSITE_FWD.launches += 2
        assert rec == {kernels.MARCH: 1, kernels.COMPOSITE_FWD: 2}
        assert kernels.MARCH.launches == 5
        assert kernels.COMPOSITE_FWD.launches == 0
        graph = StubGraph()
        counted = kernels.CountedGraph(graph, rec)
        for _ in range(3):
            counted.replay()
        assert graph.replays == 3
        c = kernels.counts()
        assert c["march_bootstrap"] == 8 and c["composite_fwd"] == 6
        assert sum(c.values()) == 14
    finally:
        for k in kernels.ALL_KERNELS:
            k.launches = saved[k.name]
