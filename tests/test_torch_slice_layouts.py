"""One bootstrap training step of the port with the brick and the tcnn
hash grids against the JAX package, at the size of test_torch_slice.py
(all heads, 16 samples per ray with the full stratified tail, the
production loss weights, grid 32, 6 views at 24^2, batch 96), with the
tables cut to 2^8 bricks / 2^12 rows a level and the finest resolution
to 64 vertices a level (finest_resolution 128; 16 levels), near the
triplane's 32. The rays of the two packages differ by an ulp (an FMA
chain in XLA); at 1024 vertices a level that moves some sample across a
stride-3 brick face, whose vertices the brick layout stores twice: a
real jump of its features, which the gradients of that sample then
carry (the tcnn grid is continuous there).

The JAX state after one full refresh is carried across by `convert.py`;
the step's random draws are replayed from the JAX key splits and handed
in (`test_torch_slice._jax_draws`, which also gives the JAX loss and its
gradients, computed without jit). Tolerances are those of the triplane
steps in test_torch_slice.py: loss components rtol 1e-4, atol 1e-7;
the march and compositing counters exact; gradients rtol 1e-3 with atol
1e-4 of the parameter's largest gradient.
"""
import dataclasses

import jax
import numpy as np
import pytest

from test_torch_common import CPU, N, slice_configs
from test_torch_slice import _flat, _jax_draws

from normal_clustering_nerf_torch.convert import convert_jax_state
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.training import Trainer as JTrainer


@pytest.mark.parametrize("layout,kw", [("brick", dict(log2_bricks=8)),
                                       ("tcnn", dict(log2_hashmap_size=12))])
def test_bootstrap_step_matches_jax(layout, kw):
    jcfg, tcfg = (c.replace(render=dataclasses.replace(c.render,
                                                       sv_intervals=24))
                  for c in slice_configs(hash_layout=layout,
                                         finest_resolution=128, **kw))
    jt = JTrainer(jcfg, JSyn(split="train", img_wh=(24, 24),
                             n_images=6).load())
    jt.mark_invisible_cells()
    occ = jt._occ_update[True](jt.state.occ, jt.state.params,
                               jax.random.PRNGKey(7))
    jt.state = jt.state._replace(occ=occ)
    tt = TTrainer(tcfg, TSyn(split="train", img_wh=(24, 24),
                             n_images=6).load(), device="cpu")
    params, occ_t, opt_state = convert_jax_state(
        jax.tree_util.tree_map(np.asarray, jt.state.params),
        jax.tree_util.tree_map(np.asarray, jt.state.occ), tt.opt, CPU)
    assert params["hash_table"].shape == tt.params["hash_table"].shape
    tt.load_state(params, occ_t, opt_state, step=int(jt.state.step))

    draws, grads, loss_ref, rm, vr = _jax_draws(jt, jt.state)
    m = tt.train_step_core(bootstrap=True, draws=draws)
    for k, v in loss_ref.items():
        np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                   rtol=1e-4, atol=1e-7, err_msg=f"loss {k}")
    assert round(float(m["rm_samples_per_ray"]) * 96) == rm > 0
    assert round(float(m["vr_samples_per_ray"]) * 96) == vr > 0
    g_ref = _flat(grads["model"])
    assert set(g_ref) == set(tt.last_grads)
    assert np.count_nonzero(g_ref["hash_table"]) > 0
    for n, g in tt.last_grads.items():
        r = g_ref[n]
        np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"grad {n}")
