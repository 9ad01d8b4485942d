"""The port's bootstrap training step against the JAX package's
`Trainer.train_step_core`, at a small size that keeps the bench.py
structure: all heads on, the triplane field, 16 samples per ray with the
full stratified tail, the bootstrap march, avoid_near annealing and the
production loss weights (plane_res 32, grid3d_res 16, grid 32, 6 views
at 24^2, batch 96).

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
import jax
import numpy as np
import pytest

from test_torch_common import CPU, J, N, slice_configs

from normal_clustering_nerf_torch.convert import convert_jax_state
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


def _jax_draws(jt, state):
    """Replay the key splits of train_step_core for one step, and the
    JAX loss function to get its gradients and the clustering-valid mask
    the k-means init is drawn over."""
    cfg = jt.cfg
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
                           bootstrap=True)
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


@pytest.fixture(scope="module")
def trainers():
    jcfg, tcfg = slice_configs()
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
    return jt, tt


def test_three_bootstrap_steps_match_jax(trainers):
    jt, tt = trainers
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
