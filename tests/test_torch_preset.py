"""Training steps of the Hypersim preset (experiments/hyperparameters.py:
hypersim_flags, through `TrainConfig.from_args`) on a Hypersim-format
fixture read by both packages' loaders, port against eager JAX: the
patch sampler (all_images_triang_patch), the projective camera's
invisible-cell marking, the brick field, the clustering losses at full
weight; then the same with random unseen poses and keep_N_tr.

Size: the preset cut as `chip_smoke.small_preset_config` (grid 32, the
brick field of test_torch_slice_layouts.py, batch 256 = 4 patches, 16
samples per ray, a 16-step bootstrap), frames read at 128 x 96. The JAX
state after a full refresh is carried across by `convert.py`; each
step's draws (patch corners, images, random poses, march noise, k-means
init) come from JAX's key splits, and its loss and gradients from the
JAX loss run without jit (`test_torch_slice._jax_draws` explains why).
Tolerances are test_torch_slice.py's: loss components rtol 1e-4, atol
1e-7; counters exact; gradients rtol 1e-3 with atol 1e-4 of the
parameter's largest gradient.
"""
import dataclasses

import jax
import numpy as np
import pytest

pytest.importorskip("cv2")
pytest.importorskip("h5py")

import chip_smoke  # noqa: E402
from test_torch_common import CPU, J, N, write_hypersim_scene  # noqa: E402
from test_torch_sampler import _jax_draws as sampler_draws  # noqa: E402
from test_torch_slice import _flat  # noqa: E402

import normal_clustering_nerf_tpu.config as jc  # noqa: E402
from normal_clustering_nerf_torch.convert import convert_jax_state  # noqa: E402
from normal_clustering_nerf_torch.datasets import get_dataset  # noqa: E402
from normal_clustering_nerf_torch.training import Trainer as TTrainer  # noqa: E402
from normal_clustering_nerf_tpu.datasets import (  # noqa: E402
    get_dataset as j_get_dataset,
)
from normal_clustering_nerf_tpu.datasets.normals import (  # noqa: E402
    extract_normals_from_ray_batch,
)
from normal_clustering_nerf_tpu.losses import (  # noqa: E402
    compute_losses, patch_triang_idx,
)
from normal_clustering_nerf_tpu.models.rendering import render_train  # noqa: E402
from normal_clustering_nerf_tpu.training import Trainer as JTrainer  # noqa: E402

LOAD = dict(downsample=0.125, load_depth_gt=True, load_norm_gt=True)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    root = write_hypersim_scene(tmp_path_factory.mktemp("ai_002_002"))
    return (get_dataset("hypersim")(root, **LOAD).load(),
            j_get_dataset("hypersim")(root, **LOAD).load())


def _jax_config(tcfg):
    """The JAX TrainConfig with the port config's fields."""
    return jc.TrainConfig(
        seed=tcfg.seed, no_debug=tcfg.no_debug,
        model=jc.ModelConfig(**dataclasses.asdict(tcfg.model)),
        render=jc.RenderConfig(**dataclasses.asdict(tcfg.render)),
        loss=jc.LossConfig(**dataclasses.asdict(tcfg.loss)),
        data=jc.DataConfig(**dataclasses.asdict(tcfg.data)),
        optim=jc.OptimConfig(**dataclasses.asdict(tcfg.optim)))


def _step_draws(jt, state, bootstrap):
    """The draws of JAX's train_step_core (trainer.py:313) for one step,
    and the eager JAX loss and gradients on them."""
    cfg = jt.cfg
    _, k_batch, k_render, k_loss = jax.random.split(state.key, 4)
    draws = {"batch": sampler_draws(jt.sampler, k_batch)}
    batch = jt.sampler.sample(k_batch)
    n_rays = batch["pix_idxs"].shape[0] * (2 if jt.random_poses is not None
                                           else 1)
    draws["noise"] = np.asarray(jax.random.uniform(
        jax.random.split(k_render)[0], (n_rays,)))
    scene = jt.scene_dev
    target = {"rgb": scene["rays"][batch["img_idxs"],
                                   batch["pix_idxs"]][..., :3]}
    gt = target["rgb"].shape[0]
    unsup = gt if cfg.data.random_tr_poses else 0

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
            ray_sampling_strategy=cfg.data.ray_sampling_strategy,
            random_tr_poses=cfg.data.random_tr_poses,
            patch_area=jt.sampler.patch_area,
            offsets_local=jt.sampler.offsets_local)
        nd = extract_normals_from_ray_batch(
            res["rays_o"][unsup:], res["rays_d"][unsup:],
            res["depth"][unsup:],
            patch_triang_idx(n_rays - unsup, jt.sampler.patch_area,
                             jt.sampler.offsets_local))
        return loss_d["total"], (loss_d, nd, res["rm_samples"],
                                 res["vr_samples"])

    grads, (loss_d, nd, rm, vr) = jax.grad(loss_fn, has_aux=True)(state.params)
    nd = np.asarray(nd)
    valid = np.all(np.isfinite(nd), -1) & (np.abs(nd).sum(-1) != 0)
    draws["kmeans_init"] = np.asarray(jax.random.choice(
        k_loss, nd.shape[0], (cfg.loss.cluster_K,), replace=False,
        p=J(valid / max(valid.sum(), 1))))
    return draws, grads, loss_d, int(rm), int(vr)


@pytest.mark.parametrize("data", [
    {}, dict(random_tr_poses=True, keep_N_tr=3)],
    ids=["patches", "random-poses-keep3"])
def test_preset_steps_match_jax(scenes, data):
    """After the marking (equal) and a full refresh (the port's, handed to
    JAX), three steps from the same parameters, each with its own key:
    bootstrap steps at steps 0 and 1 and an sv step at step 3000 (the
    clustering at full weight)."""
    t_scene, j_scene = scenes
    tcfg = chip_smoke.small_preset_config(**data)
    jt = JTrainer(_jax_config(tcfg), j_scene)
    jt.mark_invisible_cells()
    tt = TTrainer(tcfg, t_scene, device="cpu")
    tt.mark_invisible_cells()
    for f in ("density_grid", "count_grid"):
        np.testing.assert_array_equal(N(getattr(tt.occ, f)),
                                      np.asarray(getattr(jt.state.occ, f)))
    if data:
        assert tt.scene_train.n_images == jt.scene_train.n_images == 3
        np.testing.assert_array_equal(N(tt.random_poses), jt.random_poses)
    tt.load_state(*convert_jax_state(
        jax.tree_util.tree_map(np.asarray, jt.state.params),
        jax.tree_util.tree_map(np.asarray, jt.state.occ), tt.opt, CPU))
    tt.occ_update(warmup=True)
    assert int(N(tt.occ.sv_mask).sum()) > 0
    state0 = jt.state._replace(occ=type(jt.state.occ)(
        *(J(N(t)) for t in tt.occ)))
    n_rays = tcfg.data.batch_size
    for i, (boot, step) in enumerate(((True, 0), (True, 1), (False, 3000))):
        state = state0._replace(step=state0.step * 0 + step,
                                key=jax.random.PRNGKey(100 + i))
        tt.load_state(*convert_jax_state(
            jax.tree_util.tree_map(np.asarray, state.params),
            jax.tree_util.tree_map(np.asarray, state.occ), tt.opt, CPU),
            step=step)
        draws, grads, loss_ref, rm, vr = _step_draws(jt, state, boot)
        m = tt.train_step_core(bootstrap=boot, draws=draws)
        for k, v in loss_ref.items():
            np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {step} loss {k}")
        assert round(float(m["rm_samples_per_ray"]) * n_rays) == rm > 0
        assert round(float(m["vr_samples_per_ray"]) * n_rays) == vr > 0
        g_ref = _flat(grads["model"])
        assert set(g_ref) == set(tt.last_grads)
        for n, g in tt.last_grads.items():
            r = g_ref[n]
            np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                       atol=1e-4 * np.abs(r).max(),
                                       err_msg=f"step {step} grad {n}")
