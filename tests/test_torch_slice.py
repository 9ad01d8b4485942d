"""The port's training steps against the JAX package's
`Trainer.train_step_core`, at a small size that keeps the bench.py
structure: all heads on, the triplane field, 16 samples per ray with the
full stratified tail, the bootstrap march and after it the supervoxel-run
march (or the bitfield march, or the flat layout), avoid_near annealing
and the production loss weights (plane_res 32, grid3d_res 16, grid 32, 6
views at 24^2, batch 96).

The JAX parameters and occupancy state are carried across by
`convert.py`; every random draw of a step (batch, march noise,
background, k-means init) is made by JAX from the same key splits
(trainer.py:313, rendering.py:139, kmeans.py:36) and handed in.

Tolerances (f32 compute):
  * loss components: rtol 1e-4, atol 1e-7; march/compositing counters
    exact. Rays enter through a 3-term product that XLA evaluates as an
    FMA chain and torch does not (1 ulp), then run through the field,
    compositing and the losses;
  * gradients: rtol 1e-3 with atol 1e-4 of the parameter's largest
    gradient (the same 1-ulp ray differences, amplified through three
    MLP layers, the scatter and the clustering normals);
  * parameters after 3 steps: atol 3e-3 * lr. An AdamW step moves each
    weight by lr * mu_hat / (sqrt(nu_hat) + eps), whatever the gradient's
    size, so a gradient that agrees to rtol 1e-3 gives a step that agrees
    to about 1e-3 * lr, and three steps add up. Table values whose
    gradients are tiny move by a full lr all the same, which is why the
    bound is in units of lr and not of the parameter's scale.
"""
import dataclasses

import jax
import numpy as np
import pytest

from test_torch_common import CPU, J, N, slice_configs

from normal_clustering_nerf_torch.convert import (
    convert_jax_state, convert_occupancy,
)
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_tpu.datasets.normals import (
    extract_normals_from_ray_batch,
)
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.losses import compute_losses, triang_idx
from normal_clustering_nerf_tpu.models.rendering import render_train
from normal_clustering_nerf_tpu.training import Trainer as JTrainer


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_draws(jt, state, bootstrap=True, render=None):
    """Replay the key splits of train_step_core for one step, and the
    JAX loss function (eagerly, at the trainer's render config or
    `render`) to get its gradients and the clustering-valid mask the
    k-means init is drawn over."""
    cfg = jt.cfg if render is None else jt.cfg.replace(render=render)
    _, k_batch, k_render, k_loss = jax.random.split(state.key, 4)
    k_img, k_pix, _ = jax.random.split(k_batch, 3)
    n_tri = cfg.data.batch_size // 3
    draws = {"batch": {
        "img": np.asarray(jax.random.randint(k_img, (n_tri,), 0,
                                             jt.scene_train.n_images)),
        "tri": np.asarray(jax.random.randint(
            k_pix, (n_tri,), 0, jt.sampler.triang.x1.shape[0]))}}
    k_noise, k_bg = jax.random.split(k_render)
    draws["noise"] = np.asarray(jax.random.uniform(k_noise, (3 * n_tri,)))
    draws["bg"] = np.asarray(jax.random.uniform(k_bg, (3,)))

    batch = jt.sampler.sample(k_batch)
    scene = jt.scene_dev
    target = {"rgb": scene["rays"][batch["img_idxs"], batch["pix_idxs"]][..., :3]}
    for name in ("depth", "normals", "normals_depth", "semantics",
                 "semantics_WF"):
        target[name] = scene[f"label_{name}"][batch["img_idxs"],
                                              batch["pix_idxs"]]

    def loss_fn(params):
        rays_o, rays_d = jt._assemble_rays(params, batch, scene)
        res = render_train(jt.model, params["model"],
                           state.occ.density_bitfield, rays_o, rays_d,
                           k_render, cfg.render, global_step=state.step,
                           coarse_occ=state.occ.coarse_occ,
                           sv_mask=state.occ.sv_mask,
                           sv_payload=state.occ.sv_payload,
                           bootstrap=bootstrap)
        loss_d = compute_losses(
            res, target, cfg.loss, jt.model.cfg, step=state.step, key=k_loss,
            ray_sampling_strategy=cfg.data.ray_sampling_strategy)
        nd = extract_normals_from_ray_batch(
            res["rays_o"], res["rays_d"], res["depth"],
            triang_idx(res["depth"].shape[0]))
        return loss_d["total"], (loss_d, nd, res["rm_samples"],
                                 res["vr_samples"])

    grads, (loss_d, nd, rm, vr) = jax.grad(loss_fn, has_aux=True)(state.params)
    nd = np.asarray(nd)
    valid = np.all(np.isfinite(nd), -1) & (np.abs(nd).sum(-1) != 0)
    p = valid / max(valid.sum(), 1)
    draws["kmeans_init"] = np.asarray(jax.random.choice(
        k_loss, nd.shape[0], (cfg.loss.cluster_K,), replace=False, p=J(p)))
    return draws, grads, loss_d, int(rm), int(vr)


def _render(cfg, **kw):
    return cfg.replace(render=dataclasses.replace(cfg.render, **kw))


@pytest.fixture(scope="module")
def trainers():
    """A JAX trainer after one full refresh, the port's trainer holding
    its state, and that JAX state, at bootstrap_steps 16 and the bench's
    24 sv intervals: the steps 0-2 are bootstrap steps, and the steps
    15-17 cross the switch."""
    jcfg, tcfg = (_render(c, bootstrap_steps=16, sv_intervals=24)
                  for c in slice_configs())
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
    tt.load_state(params, occ_t, opt_state, step=int(jt.state.step))
    # every field of the state crosses, the coarse mask included
    for name in occ_t._fields:
        np.testing.assert_array_equal(N(getattr(occ_t, name)),
                                      np.asarray(getattr(jt.state.occ, name)),
                                      err_msg=name)
    assert int(N(occ_t.coarse_occ).sum()) > 0
    # a copy: the JAX step donates the state it is given
    return jt, tt, jax.tree_util.tree_map(lambda a: a.copy(), jt.state)


def test_three_bootstrap_steps_match_jax(trainers):
    jt, tt, _ = trainers
    assert int(N(tt.occ.density_bitfield).astype(bool).sum()) > 0
    for step in range(3):
        draws, grads, loss_ref, rm, vr = _jax_draws(jt, jt.state)
        jt.state, m_ref = jt._train_step_boot(jt.state, jt.scene_dev)
        m = tt.train_step_core(bootstrap=True, draws=draws)
        for k, v in loss_ref.items():
            np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {step} loss {k}")
            np.testing.assert_allclose(float(m[f"loss_{k}"]),
                                       float(m_ref[f"loss_{k}"]),
                                       rtol=1e-4, atol=1e-7)
        assert round(float(m["rm_samples_per_ray"]) * 96) == rm
        assert round(float(m["vr_samples_per_ray"]) * 96) == vr
        g_ref = _flat(grads["model"])
        assert set(g_ref) == set(tt.last_grads)
        for n, g in tt.last_grads.items():
            r = g_ref[n]          # norm_net has no loss: all zero
            np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                       atol=1e-4 * np.abs(r).max(),
                                       err_msg=f"step {step} grad {n}")
    assert tt.step == int(jt.state.step) == 3
    p_ref = _flat(jt.state.params["model"])
    atol = 3 * 1e-3 * jt.cfg.optim.lr
    for n, p in tt.params.items():
        np.testing.assert_allclose(N(p), p_ref[n], rtol=0, atol=atol,
                                   err_msg=f"param {n} after 3 steps")


def _compare_step(tt, m, m_ref, loss_ref, grads, rm, vr, step):
    for k, v in loss_ref.items():
        np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                   rtol=1e-4, atol=1e-7,
                                   err_msg=f"step {step} loss {k}")
        np.testing.assert_allclose(float(m[f"loss_{k}"]),
                                   float(m_ref[f"loss_{k}"]),
                                   rtol=1e-4, atol=1e-7)
    # per-ray counters, compared as counts of the 96 rays
    for k, ref in (("rm_samples_per_ray", rm), ("vr_samples_per_ray", vr),
                   ("trunc_ray_frac", round(float(m_ref["trunc_ray_frac"])
                                            * 96))):
        assert round(float(m[k]) * 96) == ref, k
    g_ref = _flat(grads["model"])
    for n, g in tt.last_grads.items():
        r = g_ref[n]
        np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"step {step} grad {n}")


def test_steps_across_the_bootstrap_switch_match_jax(trainers):
    """Step 15 is the last bootstrap step; at step 16 the refresh rebuilds
    the sv tables (the JAX state's, carried across) and steps 16 and 17
    take the supervoxel-run march. Both trainers pick the march from their
    step counter, as their `fit` does. Both restart from the fixture's
    JAX state, moved to step 15."""
    jt, tt, state0 = trainers
    jcfg, tcfg = jt.cfg, tt.cfg
    jt.state = state0._replace(step=state0.step + 15)
    params, occ_t, opt_state = convert_jax_state(
        jax.tree_util.tree_map(np.asarray, jt.state.params),
        jax.tree_util.tree_map(np.asarray, jt.state.occ), tt.opt, CPU)
    tt.load_state(params, occ_t, opt_state, step=15)
    for step in (15, 16, 17):
        if step % jcfg.optim.update_interval == 0:
            occ = jt._occ_update[True](jt.state.occ, jt.state.params,
                                       jax.random.PRNGKey(step))
            jt.state = jt.state._replace(occ=occ)
            tt.occ = convert_occupancy(
                jax.tree_util.tree_map(np.asarray, occ), CPU)
            assert int(N(tt.occ.sv_mask).sum()) > 0
        boot = tt.step < tcfg.render.bootstrap_steps
        assert boot == (step < 16)
        step_fn, _ = jt.step_fns(int(jt.state.step))
        draws, grads, loss_ref, rm, vr = _jax_draws(jt, jt.state, boot)
        jt.state, m_ref = step_fn(jt.state, jt.scene_dev)
        m = tt.train_step_core(bootstrap=boot, draws=draws)
        _compare_step(tt, m, m_ref, loss_ref, grads, rm, vr, step)
    assert tt.step == int(jt.state.step) == 18
    p_ref = _flat(jt.state.params["model"])
    atol = 3 * 1e-3 * jt.cfg.optim.lr
    for n, p in tt.params.items():
        np.testing.assert_allclose(N(p), p_ref[n], rtol=0, atol=atol,
                                   err_msg=f"param {n} after 3 steps")


@pytest.mark.parametrize("render", [dict(march_coarse=False),
                                    dict(march_layout="flat")])
def test_fine_and_flat_steps_match_jax(trainers, render):
    """One step after the bootstrap without the sv march (the bitfield
    march over march_block = 1024 steps, kernel H9) and one flat-layout
    step (H9 + H11, the segment launchers of H3/H4; the flat layout
    marches the bitfield from step 0), each from the JAX trainer's
    current state (a copy: the other tests' steps donate the states they
    are given) and draws, against the eager JAX loss and gradients."""
    jt = trainers[0]
    state0 = jax.tree_util.tree_map(lambda a: a.copy(), jt.state)
    rcfg = dataclasses.replace(jt.cfg.render, **render)
    draws, grads, loss_ref, rm, vr = _jax_draws(jt, state0, False, rcfg)
    _, tcfg = slice_configs()
    tt = TTrainer(_render(tcfg, bootstrap_steps=16, sv_intervals=24,
                          **render),
                  TSyn(split="train", img_wh=(24, 24), n_images=6).load(),
                  device="cpu")
    tt.load_state(*convert_jax_state(
        jax.tree_util.tree_map(np.asarray, state0.params),
        jax.tree_util.tree_map(np.asarray, state0.occ), tt.opt, CPU),
        step=int(state0.step))
    m = tt.train_step_core(bootstrap=False, draws=draws)
    for k, v in loss_ref.items():
        np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                   rtol=1e-4, atol=1e-7, err_msg=f"loss {k}")
    assert round(float(m["rm_samples_per_ray"]) * 96) == rm > 0
    assert round(float(m["vr_samples_per_ray"]) * 96) == vr
    assert float(m["trunc_ray_frac"]) == 0.0
    g_ref = _flat(grads["model"])
    for n, g in tt.last_grads.items():
        r = g_ref[n]
        np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"grad {n}")
