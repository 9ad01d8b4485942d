"""The flat march layout's training step as the port's CUDA-graph chunk
runs it, on the CPU: the step kind ("flat" whatever the bootstrap switch
says, as the JAX flat branch ignores it), `train_chunk` against the
per-step loop (bit for bit), the segment bound the step passes to the
compositing (the march's cap, known on the host, so that the backward on
the card reads no count), the compositing with that bound against JAX,
and the constant that sizes H11's look-back buffer against the kernel's.

Tolerances: against JAX those of `test_torch_flat.py` (rtol 2e-5, atol
2e-6 for values; rtol 1e-4, atol 1e-5 of the largest entry for
gradients: the JAX flat path's global cumsum); the port with and without
the bound: exact (the plain versions do not read it).
"""
import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import J, N, T, slice_configs
from test_torch_flat import C, NR, THR, _cotangents, _dense, _flat

from normal_clustering_nerf_torch import kernels
from normal_clustering_nerf_torch.datasets.synthetic import SyntheticDataset
from normal_clustering_nerf_torch.models import rendering
from normal_clustering_nerf_torch.models.occupancy import OccupancyGrid
from normal_clustering_nerf_torch.ops import composite as tc
from normal_clustering_nerf_torch.ops.ray_march import flat_cap
from normal_clustering_nerf_torch.training import Trainer
from normal_clustering_nerf_tpu.ops import composite as jc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene():
    return SyntheticDataset(split="train", img_wh=(24, 24), n_images=6).load()


def _flat_config():
    """The slice configuration in the flat layout: 16 samples a ray at
    most (budget 96 x 16), so the march's cap is 16."""
    _, cfg = slice_configs()
    return cfg.replace(render=dataclasses.replace(
        cfg.render, march_layout="flat", test_layout="flat"))


@pytest.mark.parametrize("bootstrap", [False, True])
def test_the_flat_layout_is_its_own_step_kind(bootstrap):
    cfg = _flat_config()
    occ = OccupancyGrid(cfg.model, torch.device("cpu")).init_state()
    assert rendering.train_march_kind(cfg.model, cfg.render, occ,
                                      bootstrap) == "flat"
    dense = dataclasses.replace(cfg.render, march_layout="dense")
    assert rendering.train_march_kind(cfg.model, dense, occ, bootstrap) == (
        "bootstrap" if bootstrap else "sv")


def test_a_flat_chunk_is_the_step_loop(scene):
    """`train_chunk(3)` (bootstrap by the step, which the flat layout
    ignores) against three `train_step_core(bootstrap=False)` steps from
    the same state: the last metrics, parameters, moments and occupancy
    bit for bit."""
    cfg = _flat_config()
    chunked, looped = (Trainer(cfg, scene, device="cpu") for _ in range(2))
    for tr in (chunked, looped):
        tr.mark_invisible_cells()
        tr.occ_update(warmup=True)
    assert chunked.step < cfg.render.bootstrap_steps
    m = chunked.train_chunk(3)
    for _ in range(3):
        ref = looped.train_step_core(bootstrap=False)
    assert chunked.step == looped.step == 3
    assert {k: float(v) for k, v in m.items()} == {
        k: float(v) for k, v in ref.items()}
    assert float(m["rm_samples_per_ray"]) > 0
    for n, p in chunked.params.items():
        assert torch.equal(p, looped.params[n]), n
        for k in ("mu", "nu"):
            assert torch.equal(chunked.opt.state[k][n],
                               looped.opt.state[k][n]), (k, n)
    assert all(torch.equal(a, b) for a, b in zip(chunked.occ, looped.occ))


def test_the_flat_step_bounds_the_segments_by_the_cap(scene, monkeypatch):
    """The training step's composite gets max_len = the march's cap
    (min(max_samples, budget // N)), and no segment is longer."""
    cfg = _flat_config()
    tr = Trainer(cfg, scene, device="cpu")
    tr.mark_invisible_cells()
    tr.occ_update(warmup=True)
    seen = []
    real = rendering.composite_rays_compact

    def spy(*args, **kw):
        seen.append((kw["max_len"], kw["ray_count"].clone()))
        return real(*args, **kw)
    monkeypatch.setattr(rendering, "composite_rays_compact", spy)
    tr.train_step_core()
    n_rays = cfg.data.batch_size
    cap = min(cfg.model.max_samples, cfg.render.sample_budget // n_rays)
    assert cap == 16 == flat_cap(cfg.model.max_samples, cap)
    (max_len, count), = seen
    assert max_len == cap
    assert 0 < int(count.max()) <= cap


def test_composite_with_the_cap_matches_jax():
    """The flat composite with max_len at the cap (K 16): the forward and
    the gradients of sigmas and raws equal the call without it and match
    the JAX `composite_rays_compact` (test_torch_flat.py's tolerances)."""
    s = _dense(2)
    mr, sig, raws = _flat(s)
    cot = _cotangents(s["rng"], sig.shape[0])
    outs = []
    for max_len in (None, 16):
        ts_, st = T(sig).requires_grad_(), T(raws).requires_grad_()
        out = tc.composite_rays_compact(ts_, st, mr.dt, mr.t, mr.ray_id,
                                        mr.ray_start, mr.valid, NR, THR,
                                        ray_count=mr.ray_count,
                                        max_len=max_len)
        sum((out[k] * T(c)).sum() for k, c in
            zip(("opacity", "depth", "rend", "ws"), cot)).backward()
        outs.append((out, ts_.grad, st.grad))
    (out0, gs0, gr0), (out, g_sig, g_raws) = outs
    for k in out:
        assert torch.equal(out[k], out0[k]), k
    assert torch.equal(g_sig, gs0) and torch.equal(g_raws, gr0)

    args_j = (J(N(mr.dt)), J(N(mr.t)), J(N(mr.ray_id)), J(N(mr.ray_start)),
              J(N(mr.valid)), NR, THR)
    ref = jc.composite_rays_compact(J(sig), J(raws), *args_j)
    for k in ("opacity", "depth", "rend", "ws"):
        np.testing.assert_allclose(N(out[k].detach()), np.asarray(ref[k]),
                                   rtol=2e-5, atol=2e-6, err_msg=k)

    def f(sg, rw):
        o = jc.composite_rays_compact(sg, rw, *args_j)
        return sum(jnp.sum(o[k] * J(c)) for k, c in
                   zip(("opacity", "depth", "rend", "ws"), cot))
    refs = jax.grad(f, argnums=(0, 1))(J(sig), J(raws))
    for got, r in zip((g_sig, g_raws), refs):
        r = np.asarray(r)
        np.testing.assert_allclose(N(got), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
    assert raws.shape[-1] == C


def test_the_compact_buffer_matches_the_kernel():
    """`kernels.compact_words` sizes H11's look-back buffer with the
    kernel's rays a block (COMPACT_THREADS in csrc/march_fine.cu): the
    epoch and ticket, and a status word a block."""
    src = (Path(kernels.CSRC) / "march_fine.cu").read_text()
    threads = int(re.search(r"constexpr int COMPACT_THREADS = (\d+);",
                            src).group(1))
    assert kernels.COMPACT_RAYS == threads
    for n, words in ((1, 2), (threads, 2), (threads + 1, 3),
                     (8190, 1 + -(-8190 // threads))):
        assert kernels.compact_words(n) == words
