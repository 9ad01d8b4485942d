"""The paper's baselines in the port against the JAX package: the field
with the exposure tonemapper, the SH direction encoding, the baselines'
argv through both packages' `from_args`, and three training steps of each
baseline configuration of `chip_smoke.BASELINES`:

  * "supervised": depth_w, the GT-normal L1 and dot terms, the
    Manhattan-SDF terms with theta_WF, the canonical-axis snapping with
    `discard_far_members`, `distortion_ts_bug_compat`, the 'depth'
    interval annealing, `pred_norm_nn_norm` and `use_exposure`;
  * "regnerf": random-pose rays with RegNeRF's depth smoothness and the
    clustering terms, the 'avoid_near' annealing.

The steps run at test_torch_slice.py's size (`chip_smoke.
small_baseline_config`; 6 views at 24^2, batch 96, a 16-step bootstrap),
from the JAX state after a full refresh, carried across by `convert.py`,
with `norm_can_start` 0, `norm_can_grow` 1 and `anneal_steps` 2, so that
the switches flip within the three steps: `reg_depth` and the Manhattan
term's weighting from step 1, the clustering and snapping weights from 0
to full at step 1, the annealing off at step 2. Each step's draws come
from JAX's key splits (trainer.py:313); the JAX step runs without jit
(test_torch_slice.py says why) and its optimizer update is JAX's own
`tx.update`. Tolerances are test_torch_slice.py's: loss components rtol
1e-4, atol 1e-7; counters exact; gradients rtol 1e-3 with atol 1e-4 of the
parameter's largest gradient; parameters atol 1e-3 * lr a step taken.

The field's tolerances are test_torch_model.py's (f32 and bf16); the SH
encoding rtol 1e-6, atol 1e-7 (the same f32 products).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_common import CPU, J, N, T, random_rays, slice_configs
from test_torch_config import _assert_same
from test_torch_model import TOL
from test_torch_preset import _jax_config
from test_torch_sampler import _jax_draws as sampler_draws
from test_torch_slice import _flat

from normal_clustering_nerf_torch.convert import (
    convert_jax_state, convert_params,
)
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.models.ngp_mt import NGPMT as TModel
from normal_clustering_nerf_torch.models.sh_encoding import (
    sh_encode_deg4 as t_sh,
)
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_tpu.datasets.normals import (
    extract_normals_from_ray_batch,
)
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.losses import compute_losses, triang_idx
from normal_clustering_nerf_tpu.models.ngp_mt import NGPMT as JModel
from normal_clustering_nerf_tpu.models.rendering import render_train
from normal_clustering_nerf_tpu.models.sh_encoding import (
    sh_encode_deg4 as j_sh,
)
from normal_clustering_nerf_tpu.training import Trainer as JTrainer


# ------------------------------------------------------------------ field
@pytest.mark.parametrize("mode", ["tonemapped", "exposure", "radiance"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_exposure_field_matches_jax(dtype, mode):
    """NGPMT with `use_exposure` (the triplane field at the CPU size),
    weights carried by convert.py: rgb tonemapped from log-radiance
    without and with a per-sample exposure, and the radiance itself
    (`output_radiance`), with every parameter's gradient."""
    jc, tc = slice_configs(compute_dtype=dtype, use_exposure=True)
    jm = JModel(jc.model)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tc.model, CPU)
    tm.load_state_dict(convert_params(
        jax.tree_util.tree_map(np.asarray, params), CPU))
    rng = np.random.default_rng(40)
    x, d = random_rays(rng, 400)
    exposure = rng.uniform(0.5, 2.0, (400, 1)).astype(np.float32)
    kw = {"exposure": dict(exposure=exposure),
          "radiance": dict(output_radiance=True)}.get(mode, {})
    cot = {"sigmas": rng.standard_normal(400), "rgbs":
           rng.standard_normal((400, 3)), "sems": rng.standard_normal(
               (400, 3)), "norms": rng.standard_normal((400, 3))}
    cot = {k: v.astype(np.float32) for k, v in cot.items()}

    def loss_j(p):
        out = jm(p, J(x), J(d), **{k: J(v) if k == "exposure" else v
                                   for k, v in kw.items()})
        return sum(jnp.sum(out[k] * J(c)) for k, c in cot.items()), out

    with jax.disable_jit():
        (_, ref), grads = jax.value_and_grad(loss_j, has_aux=True)(params)
    out = tm(T(x), T(d), **{k: T(v) if k == "exposure" else v
                            for k, v in kw.items()})
    sum((out[k] * T(c)).sum() for k, c in cot.items()).backward()
    for k in cot:
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), err_msg=k,
                                   **TOL[dtype]["out"])
    if mode != "radiance":
        assert (N(out["rgbs"]) >= 0).all() and (N(out["rgbs"]) <= 1).all()
    rtol, atol = TOL[dtype]["grad"]
    flat = _flat(grads)
    assert set(flat) == {n for n, _ in tm.named_parameters()}
    for n, p in tm.named_parameters():
        r = flat[n]
        if mode == "radiance" and n.startswith("tonemapper"):
            assert p.grad is None and not r.any(), n
            continue
        np.testing.assert_allclose(N(p.grad), r, rtol=rtol,
                                   atol=atol * np.abs(r).max(), err_msg=n)


def test_sh_encoding_matches_jax():
    rng = np.random.default_rng(41)
    _, d = random_rays(rng, 500)
    d[:3] = np.eye(3, dtype=np.float32)
    np.testing.assert_allclose(N(t_sh(T(d))), np.asarray(j_sh(J(d))),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ config
BASE_ARGV = ["--dataset_name=synthetic", "--ray_sampling_strategy="
             "all_images_triang", "--pred_norm_depth", "--pred_sem",
             "--load_sem_WF_gt"]


@pytest.mark.parametrize("flags", [
    ["--load_depth_gt", "--loss_depth_w=0.05", "--anneal_strategy=depth",
     "--anneal_steps=600"],
    ["--load_norm_gt", "--loss_norm_depth_L1_w=2e-3",
     "--loss_norm_depth_dot_w=2e-3"],
    ["--load_norm_depth_gt", "--loss_norm_GT_depth",
     "--loss_norm_depth_dot_w=2e-3"],
    ["--random_tr_poses", "--loss_reg_depth_w=1e-2",
     "--anneal_strategy=avoid_near", "--anneal_steps=600"],
    ["--loss_manhattan_nerf_w=2e-3", "--loss_sem_w=0.04",
     "--loss_norm_can_start=500"],
    ["--loss_norm_D_C_can_dot_w=2e-3", "--loss_norm_D_C_can_L1_w=2e-3",
     "--loss_norm_can_tres=0.01", "--pred_norm_nn", "--pred_norm_nn_norm",
     "--use_exposure"],
], ids=["depth", "normals", "depth-normals", "regnerf", "manhattan",
        "snapping-exposure"])
def test_baseline_argv_builds_the_jax_config(flags):
    """Each baseline's flags through both packages' `from_args`: the same
    config, and the port refuses none of them."""
    _assert_same(BASE_ARGV + flags)


def test_the_trainer_gathers_only_the_labels_the_terms_read():
    """Each baseline moves to the device only the labels its terms and
    the 'depth' annealing read (the bench configuration: the semantics
    alone), and a scene without one of them is refused."""
    from normal_clustering_nerf_torch.training.trainer import loss_labels
    want = {"supervised": ("depth", "normals", "semantics_WF"),
            "regnerf": ("semantics",)}
    for name, labels in want.items():
        assert loss_labels(chip_smoke.small_baseline_config(name)) == labels
    assert loss_labels(chip_smoke.small_config()) == ("semantics",)
    scene = TSyn(split="train", img_wh=(24, 24), n_images=6).load()
    scene = dataclasses.replace(scene, labels={
        k: v for k, v in scene.labels.items() if k != "semantics_WF"})
    with pytest.raises(ValueError, match="semantics_WF"):
        TTrainer(chip_smoke.small_baseline_config("supervised"), scene,
                 device="cpu")


# ------------------------------------------------------------------ steps
SWITCHES = dict(norm_can_start=0, norm_can_grow=1.0)


def _step_config(name):
    """`small_baseline_config(name)` with the switches inside the three
    steps (see the module note)."""
    cfg = chip_smoke.small_baseline_config(name)
    return cfg.replace(
        render=dataclasses.replace(cfg.render, bootstrap_steps=16,
                                   anneal_steps=2),
        loss=dataclasses.replace(cfg.loss, **SWITCHES))


def _jax_step(jt, state, bootstrap=True):
    """One step of JAX's `train_step_core` (trainer.py:313-385), the
    bootstrap march's by default, without jit: its draws in the port's
    form, its loss components, gradients and counters, and the state after
    its optimizer update."""
    cfg = jt.cfg
    key, k_batch, k_render, k_loss = jax.random.split(state.key, 4)
    draws = {"batch": sampler_draws(jt.sampler, k_batch)}
    batch = jt.sampler.sample(k_batch)
    n_gt = batch["pix_idxs"].shape[0]
    unsup = n_gt if cfg.data.random_tr_poses else 0
    n_rays = n_gt + unsup
    k_noise, k_bg = jax.random.split(k_render)
    draws["noise"] = np.asarray(jax.random.uniform(k_noise, (n_rays,)))
    draws["bg"] = np.asarray(jax.random.uniform(k_bg, (3,)))
    scene = jt.scene_dev
    img, pix = batch["img_idxs"], batch["pix_idxs"]
    target = {"rgb": scene["rays"][img, pix][..., :3]}
    for name in ("depth", "normals", "normals_depth", "semantics",
                 "semantics_WF"):
        target[name] = scene[f"label_{name}"][img, pix]

    def loss_fn(params):
        rays_o, rays_d = jt._assemble_rays(params, batch, scene)
        res = render_train(jt.model, params["model"],
                           state.occ.density_bitfield, rays_o, rays_d,
                           k_render, cfg.render, global_step=state.step,
                           depth_gt=target.get("depth"),
                           coarse_occ=state.occ.coarse_occ,
                           sv_mask=state.occ.sv_mask,
                           sv_payload=state.occ.sv_payload,
                           bootstrap=bootstrap)
        loss_d = compute_losses(
            res, target, cfg.loss, jt.model.cfg, step=state.step, key=k_loss,
            ray_sampling_strategy=cfg.data.ray_sampling_strategy,
            random_tr_poses=cfg.data.random_tr_poses,
            patch_area=jt.sampler.patch_area,
            offsets_local=jt.sampler.offsets_local,
            theta_WF=params.get("theta_WF"))
        nd = extract_normals_from_ray_batch(
            res["rays_o"][unsup:], res["rays_d"][unsup:],
            res["depth"][unsup:], triang_idx(n_rays - unsup))
        return loss_d["total"], (loss_d, nd, res["rm_samples"],
                                 res["vr_samples"])

    grads, (loss_d, nd, rm, vr) = jax.grad(loss_fn, has_aux=True)(state.params)
    nd = np.asarray(nd)
    valid = np.all(np.isfinite(nd), -1) & (np.abs(nd).sum(-1) != 0)
    draws["kmeans_init"] = np.asarray(jax.random.choice(
        k_loss, nd.shape[0], (cfg.loss.cluster_K,), replace=False,
        p=J(valid / max(valid.sum(), 1))))
    updates, opt_state = jt.tx.update(grads, state.opt_state, state.params)
    params = jax.tree_util.tree_map(lambda p, u: p + u, state.params, updates)
    new = state._replace(params=params, opt_state=opt_state,
                         step=state.step + 1, key=key)
    return draws, grads, loss_d, int(rm), int(vr), new


@pytest.mark.parametrize("name", ["supervised", "regnerf"])
def test_baseline_steps_match_jax(name):
    """Three bootstrap steps of the baseline from the JAX state after a
    full refresh: every loss component, the counters and every gradient
    (theta_WF's included) at each step, theta_WF after each step, every
    parameter after the three."""
    tcfg = _step_config(name)
    jt = JTrainer(_jax_config(tcfg), JSyn(split="train", img_wh=(24, 24),
                                          n_images=6).load())
    jt.mark_invisible_cells()
    state = jt.state._replace(occ=jt._occ_update[True](
        jt.state.occ, jt.state.params, jax.random.PRNGKey(7)))
    tt = TTrainer(tcfg, TSyn(split="train", img_wh=(24, 24),
                             n_images=6).load(), device="cpu")
    tt.load_state(*convert_jax_state(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.occ), tt.opt, CPU))
    supervised = name == "supervised"
    assert ("theta_WF" in tt.params) == supervised
    lr = tcfg.optim.lr
    seen = set()
    for step in range(3):
        draws, grads, loss_ref, rm, vr, state = _jax_step(jt, state)
        m = tt.train_step_core(bootstrap=True, draws=draws)
        assert set(m) >= {f"loss_{k}" for k in loss_ref}
        for k, v in loss_ref.items():
            np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {step} loss {k}")
            if float(v) != 0.0:
                seen.add((k, step))
        n_rays = tt.sampler.batch_size
        assert round(float(m["rm_samples_per_ray"]) * n_rays) == rm > 0
        assert round(float(m["vr_samples_per_ray"]) * n_rays) == vr
        g_ref = _flat(grads["model"])
        if supervised:
            g_ref["theta_WF"] = np.asarray(grads["theta_WF"])
        assert set(g_ref) == set(tt.last_grads)
        for n, g in tt.last_grads.items():
            r = g_ref[n]
            np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                       atol=1e-4 * np.abs(r).max(),
                                       err_msg=f"step {step} grad {n}")
        if supervised:
            np.testing.assert_allclose(
                N(tt.params["theta_WF"]), np.asarray(state.params["theta_WF"]),
                rtol=0, atol=(step + 1) * 1e-3 * lr,
                err_msg=f"theta_WF after step {step}")
    assert tt.step == int(state.step) == 3
    p_ref = _flat(state.params["model"])
    for n, p in tt.params.items():
        if n != "theta_WF":
            np.testing.assert_allclose(N(p), p_ref[n], rtol=0,
                                       atol=3e-3 * lr,
                                       err_msg=f"param {n} after 3 steps")
    # the gated terms flipped within the three steps
    if supervised:
        assert ("norm_D_C_can_dot", 0) not in seen
        assert {("norm_D_C_can_dot", 1), ("norm_WF", 0), ("depth", 0),
                ("norm_D_dot", 0), ("sem_WF", 0)} <= seen
        assert float(tt.params["theta_WF"].detach()) != 0.0
    else:
        assert ("reg_depth", 0) not in seen and ("reg_depth", 1) in seen
