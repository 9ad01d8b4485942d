"""Extrinsic optimisation in the port (`optimize_ext`, `lr_dR_norm_glob`)
against the JAX package: `axisangle_to_R`, the rays of `_assemble_rays`
with pose deltas and random poses, the optimizer's parameter groups
against optax, the march-t term with cameras outside the scene box, a
bootstrap and an sv training step, the weights and checkpoint files that
carry dR, dT and dR_glob, and the CLI's two flags.

A JAX quirk the port does not copy: `jnp.linalg.norm`'s gradient at the
zero vector is NaN, and dR starts at zero, so a JAX step from the initial
state turns every parameter to NaN (through the global-norm clip). The
port takes the norm's gradient there as 0, the reference's (PyTorch's)
convention; `test_zero_pose_delta_gradient` shows both. The step tests
start from a state whose dR and dT are small and non-zero, where the two
agree.

Tolerances (f32):
  * axisangle_to_R and its gradient: rtol 1e-6, atol 1e-7 (the same
    operations in the same order);
  * rays: rtol 1e-6, atol 1e-6 (a 3x3 product and the pose's einsum in
    another summation order);
  * the optimizer: rtol 1e-6, atol 2e-6 of the parameter's lr: an Adam
    update is about lr in size, and the two compute it to a few f32 ulps
    (the pose deltas are held at ~1e-5, where their ulp is far below
    their 1e-6 updates);
  * render_train's ray gradients: rtol 1e-4, atol 1e-5 of the largest
    (test_torch_render.py's gradient tolerance: the field's sums in
    another order, through the encode's position gradient);
  * training steps: test_torch_slice.py's (loss components rtol 1e-4, atol
    1e-7; gradients rtol 1e-3, atol 1e-4 of the largest; parameters atol
    1e-3 of a step's lr: AdamW moves every value by about lr a step), and
    2 lr where the gradient is within its tolerance of 0: a first Adam
    step is g / (|g| + 1e-15), whose sign such a gradient does not fix.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_baselines import _jax_step
from test_torch_common import CPU, J, N, T, slice_configs
from test_torch_sampler import _jax_draws as sampler_draws
from test_torch_slice import _flat

from normal_clustering_nerf_torch import train_nerf
from normal_clustering_nerf_torch.config import ModelConfig as TMC
from normal_clustering_nerf_torch.config import RenderConfig as TRC
from normal_clustering_nerf_torch.convert import (
    convert_jax_state, convert_params,
)
from normal_clustering_nerf_torch.datasets.ray_utils import (
    axisangle_to_R as t_axisangle,
)
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.models import rendering as tr
from normal_clustering_nerf_torch.models.ngp_mt import NGPMT as TModel
from normal_clustering_nerf_torch.ops.distortion import (
    distortion_loss_dense as t_distortion,
)
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_torch.training.checkpoints import (
    load_weights, restore_checkpoint, save_checkpoint, save_weights,
)
from normal_clustering_nerf_torch.training.state import EXT_LR, AdamW
from normal_clustering_nerf_tpu.config import ModelConfig as JMC
from normal_clustering_nerf_tpu.config import RenderConfig as JRC
from normal_clustering_nerf_tpu.datasets.ray_utils import (
    axisangle_to_R as j_axisangle,
)
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.models import rendering as jr
from normal_clustering_nerf_tpu.models.ngp_mt import NGPMT as JModel
from normal_clustering_nerf_tpu.models.occupancy import (
    coarse_occupancy, supervoxel_tables,
)
from normal_clustering_nerf_tpu.ops.distortion import (
    distortion_loss_dense as j_distortion,
)
from normal_clustering_nerf_tpu.ops.packbits import packbits
from normal_clustering_nerf_tpu.training import Trainer as JTrainer
from normal_clustering_nerf_tpu.training import checkpoints as jck
from normal_clustering_nerf_tpu.training.state import build_optimizer

SCENE = dict(split="train", img_wh=(24, 24), n_images=6)
EXT = dict(optimize_ext=True, lr_dR_norm_glob=1e-4)


def _ext(cfg, **optim):
    return cfg.replace(optim=dataclasses.replace(cfg.optim,
                                                 **dict(EXT, **optim)))


# ------------------------------------------------------------ rotations
@pytest.mark.parametrize("shape", [(3,), (7, 3)])
def test_axisangle_to_R_matches_jax(shape):
    """Values and the gradient of a weighted sum, on (3,) and (B, 3)
    axis-angles of norm up to ~1 (and a row of zeros in the batch, whose
    value is the identity)."""
    rng = np.random.default_rng(len(shape))
    v = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    w = rng.standard_normal(shape[:-1] + (3, 3)).astype(np.float32)
    ref = np.asarray(j_axisangle(J(v)))
    vt = T(v).requires_grad_(True)
    out = t_axisangle(vt)
    np.testing.assert_allclose(N(out), ref, rtol=1e-6, atol=1e-7)
    (out * T(w)).sum().backward()
    g = jax.grad(lambda x: jnp.sum(j_axisangle(x) * J(w)))(J(v))
    np.testing.assert_allclose(N(vt.grad), np.asarray(g), rtol=1e-6,
                               atol=1e-7)
    if len(shape) == 2:
        z = t_axisangle(torch.zeros((2, 3)))
        np.testing.assert_array_equal(N(z), np.broadcast_to(np.eye(3),
                                                            (2, 3, 3)))


def test_zero_pose_delta_gradient():
    """At v = 0 (dR's initial value) JAX's gradient is NaN (the norm of the
    zero vector); the port's is the limit of JAX's as v -> 0: d R / d v_i
    is the skew matrix of the unit vector e_i (sin|v|/|v| -> 1)."""
    w = np.random.default_rng(2).standard_normal((3, 3)).astype(np.float32)
    g_jax = jax.grad(lambda x: jnp.sum(j_axisangle(x) * J(w)))(
        jnp.zeros(3))
    assert np.isnan(np.asarray(g_jax)).all()
    vt = torch.zeros(3, requires_grad=True)
    (t_axisangle(vt) * T(w)).sum().backward()
    skew = [np.array([[0, 0, 0], [0, 0, -1], [0, 1, 0]]),
            np.array([[0, 0, 1], [0, 0, 0], [-1, 0, 0]]),
            np.array([[0, -1, 0], [1, 0, 0], [0, 0, 0]])]
    want = np.array([(w * k).sum() for k in skew], np.float32)
    np.testing.assert_allclose(N(vt.grad), want, rtol=1e-6, atol=1e-6)
    # and JAX's own gradient just off zero tends to it
    g_near = jax.grad(lambda x: jnp.sum(j_axisangle(x) * J(w)))(
        jnp.full(3, 1e-4))
    np.testing.assert_allclose(np.asarray(g_near), want, rtol=0, atol=1e-3)


def test_axis_parallel_rays_give_a_finite_box_gradient():
    """A ray direction with a component exactly 0 (a rotated pose's
    product can cancel to it) gives that slab ts of +-inf, never the near
    or far end. JAX's autodiff of the slab test turns its gradient into
    0 * inf = NaN, which the global-norm clip spreads to every parameter;
    the port's hits are JAX's bit for bit, and its gradient is JAX's where
    JAX's is finite and 0 where JAX's is NaN (the limit: a tiny component
    keeps that slab unselected). Cameras inside the box (t1 clamped, the
    extrinsic path's case) and outside it; one and two zero components."""
    from normal_clustering_nerf_torch.ops.ray_aabb import ray_aabb_intersect
    rng = np.random.default_rng(31)
    n = 96
    o = rng.uniform(-0.4, 0.4, (n, 3)).astype(np.float32)
    o[n // 2:] = rng.uniform(-1.2, 1.2, (n - n // 2, 3))
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    for i in range(0, n, 3):
        d[i, i % 3] = 0.0
        if i % 4 == 0:
            d[i, (i + 1) % 3] = 0.0
    d[n // 2 + 1, 1] = -0.0
    cot = rng.standard_normal((n, 2)).astype(np.float32)
    half = np.full(3, 0.5, np.float32)

    def loss_j(ro, rd):
        hits = jr.ray_aabb_intersect(ro, rd, jnp.zeros(3), J(half))
        return jnp.sum(hits * J(cot)), hits

    (_, ref), (g_o, g_d) = jax.value_and_grad(
        loss_j, argnums=(0, 1), has_aux=True)(J(o), J(d))
    ro, rd = T(o).requires_grad_(True), T(d).requires_grad_(True)
    hits = ray_aabb_intersect(ro, rd, torch.zeros(3), T(half))
    (hits * T(cot)).sum().backward()
    np.testing.assert_array_equal(N(hits), np.asarray(ref))
    np.testing.assert_array_equal(
        N(ray_aabb_intersect(T(o), T(d), torch.zeros(3), T(half))),
        np.asarray(ref))
    hit = np.asarray(ref)[:, 1] > 0
    assert hit[: n // 2].all() and 0 < hit[n // 2:].sum() < n - n // 2
    for got, r in ((ro.grad, g_o), (rd.grad, g_d)):
        got, r = N(got), np.asarray(r)
        nan = np.isnan(r)
        assert nan.any() and np.isfinite(got).all()
        assert (got[nan] == 0).all()
        np.testing.assert_allclose(got[~nan], r[~nan], rtol=1e-6, atol=0)


# ------------------------------------------------------------ optimizer
@pytest.mark.parametrize("clip", [True, False])
def test_optimizer_groups_match_optax(clip):
    """Three updates from the same gradients over a hash table, a network
    weight, theta_WF, dR, dT and dR_glob, against JAX's `build_optimizer`
    chain: dR and dT by adam(1e-6), dR_glob by adam(lr_dR_norm_glob),
    neither decayed (weight_decay_net 0.1 here, so that a decay would
    show), every gradient under the one global-norm clip (with `clip` the
    norm exceeds grad_clip)."""
    jcfg, tcfg = (_ext(c, weight_decay_net=0.1) for c in slice_configs())
    rng = np.random.default_rng(40 + clip)
    shapes = {"hash_table.planes": (4, 8), "sigma_net.w0": (8, 4),
              "theta_WF": (), "dR": (6, 3), "dT": (6, 3), "dR_glob": (3,)}
    # the pose deltas at 1e-5, where an f32 ulp (~1e-12) is far below
    # their 1e-6 updates
    p_np = {n: ((1e-5 if n.startswith("d") else 1e-2)
                * rng.standard_normal(s)).astype(np.float32)
            for n, s in shapes.items()}

    def jtree(d):
        tree = {"model": {"hash_table": {"planes": J(d["hash_table.planes"])},
                          "sigma_net": {"w0": J(d["sigma_net.w0"])}}}
        tree.update({k: J(d[k]) for k in ("theta_WF", "dR", "dT",
                                           "dR_glob")})
        return tree
    jparams = jtree(p_np)
    tx = build_optimizer(jcfg, jparams)
    jstate = tx.init(jparams)
    tparams = {n: T(a) for n, a in p_np.items()}
    opt = AdamW(tparams, tcfg.optim)
    scale = 1.0 if clip else 1e-4
    for count in range(3):
        g_np = {n: (scale * rng.standard_normal(s)).astype(np.float32)
                for n, s in shapes.items()}
        updates, jstate = tx.update(jtree(g_np), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        lr, bc1, bc2 = (torch.tensor(v, dtype=torch.float32)
                        for v in opt.schedule(count))
        g_norm = opt.update({n: T(a) for n, a in g_np.items()}, lr, bc1, bc2)
        opt.advance()
        assert (float(g_norm) > tcfg.optim.grad_clip) == clip
        want = _flat(jparams)
        want = {n.replace("model.", ""): v for n, v in want.items()}
        for n, p in tparams.items():
            lr_n = {"dR": EXT_LR, "dT": EXT_LR,
                    "dR_glob": tcfg.optim.lr_dR_norm_glob}.get(n,
                                                             tcfg.optim.lr)
            np.testing.assert_allclose(N(p), want[n], rtol=1e-6,
                                       atol=2e-6 * lr_n,
                                       err_msg=f"{n} after update {count}")
    # dR and dT moved by about 1e-6 an update, whatever the gradient's size
    moved = np.abs(N(tparams["dR"]) - p_np["dR"])
    assert moved.max() < 3 * 3.2 * EXT_LR and moved.min() > 0


# ------------------------------------------------------------ rays
def test_assemble_rays_matches_jax():
    """The batch's rays with non-zero dR and dT (each image's pose rotated
    and translated), and the random-pose rays appended after them, not
    adjusted."""
    jcfg, tcfg = (_ext(c) for c in slice_configs())
    jcfg, tcfg = (c.replace(data=dataclasses.replace(
        c.data, random_tr_poses=True)) for c in (jcfg, tcfg))
    jt = JTrainer(jcfg, JSyn(**SCENE).load())
    tt = TTrainer(tcfg, TSyn(**SCENE).load(), device="cpu")
    rng = np.random.default_rng(5)
    params = dict(jt.state.params)
    for k in ("dR", "dT"):
        params[k] = J(0.05 * rng.standard_normal((6, 3)).astype(np.float32))
    tt.load_params(convert_params(
        jax.tree_util.tree_map(np.asarray, params), CPU))
    key = jax.random.PRNGKey(9)
    batch = jt.sampler.sample(key)
    tb = tt.sampler.sample(None, sampler_draws(jt.sampler, key))
    for k in ("img_idxs", "pix_idxs", "rnd_img_idxs"):
        np.testing.assert_array_equal(N(tb[k]), np.asarray(batch[k]))
    ro, rd = jt._assemble_rays(params, batch, jt.scene_dev)
    to, td = tt._assemble_rays(tb)
    n = batch["img_idxs"].shape[0]
    assert to.shape == (2 * n, 3)
    for got, ref in ((to, ro), (td, rd)):
        np.testing.assert_allclose(N(got), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    # the deltas moved the batch's rays and left the random-pose rays
    ro0, rd0 = jt._assemble_rays(jt.state.params, batch, jt.scene_dev)
    assert np.abs(np.asarray(ro0)[:n] - N(to)[:n]).min() > 0
    np.testing.assert_array_equal(np.asarray(ro0)[n:], N(to)[n:])


# ------------------------------------------------------------ march t
def _outside_case(seed, kind):
    """A need_pos_grad field at the render tests' size, a random occupancy
    with its sv tables, and rays from outside the scene box (origins at
    distance 0.9-1.3 from its centre, aimed at points inside it): the near
    end t1 of each ray's interval is its box entry, which moves with the
    ray."""
    G, n = 32, 120
    kw = dict(scale=0.5, pred_norm_nn=True, pred_sem=True, n_sem_cls=3,
              hash_layout="triplane", plane_res=32, grid3d_res=16,
              grid_size=G, max_samples=1024)
    jm = JModel(JMC(**kw), need_pos_grad=True)
    params = jm.init(jax.random.PRNGKey(0))
    params["hash_table"] = jax.tree_util.tree_map(
        lambda p: 0.5 * jax.random.normal(jax.random.PRNGKey(1), p.shape),
        params["hash_table"])
    tm = TModel(TMC(**kw), CPU, need_pos_grad=True)
    tm.load_state_dict(convert_params(
        jax.tree_util.tree_map(np.asarray, params), CPU))
    rng = np.random.default_rng(seed)
    occ = rng.random((G, G, G)) > 0.7
    bitfield = packbits(jnp.asarray(occ.transpose(2, 1, 0).reshape(-1)
                                    .astype(np.float32)), 0.5)
    mask, payload = supervoxel_tables(bitfield, G)
    from normal_clustering_nerf_torch.models.occupancy import OccupancyGrid
    state = OccupancyGrid(TMC(grid_size=G), CPU).init_state()._replace(
        density_bitfield=T(bitfield), sv_mask=T(mask), sv_payload=T(payload),
        coarse_occ=T(coarse_occupancy(bitfield, G)))
    u = rng.standard_normal((n, 3))
    o = (u / np.linalg.norm(u, axis=1, keepdims=True)
         * rng.uniform(0.9, 1.3, (n, 1))).astype(np.float32)
    d = rng.uniform(-0.3, 0.3, (n, 3)) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rkw = dict(march_block=1024, sample_budget=16 * n,
               anneal_strategy="avoid_near", anneal_steps=600)
    if kind == "flat":
        rkw["march_layout"] = "flat"
    return jm, params, tm, state, (bitfield, mask, payload), o, d, rkw


@pytest.mark.parametrize("kind,global_step", [("bootstrap", 300),
                                              ("sv", 700), ("flat", 700)])
def test_march_t_gradient_outside_the_box_matches_jax(kind, global_step):
    """The rays' gradient through render_train (rgb, depth, opacity, ws,
    and the distortion loss of ws, deltas and ts) with cameras outside the
    box: JAX's autodiff carries the gradient of the near end t1 into every
    valid t (t_k = t1 + lo*noise + k*lo), and through it into depth and
    the losses; the port adds it (`models/rendering.py:march_t`). At step
    300 the 'avoid_near' annealing also moves t1 with the far end. Without
    the term the port's gradient would part from JAX's."""
    jm, params, tm, state, (bitfield, mask, payload), o, d, rkw = (
        _outside_case(21, kind))
    n = o.shape[0]
    key = jax.random.PRNGKey(3)
    k_noise, k_bg = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    bg = np.asarray(jax.random.uniform(k_bg, (3,)))
    flat = kind == "flat"
    rng = np.random.default_rng(22)
    cot = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("rgb", (n, 3)), ("depth", (n,)), ("opacity", (n,)),
        ("ws", (16 * n,) if flat else (n, 16)))}
    boot = kind == "bootstrap"

    def loss_j(ro, rd):
        res = jr.render_train(jm, params, bitfield, ro, rd, key, JRC(**rkw),
                              global_step=global_step,
                              coarse_occ=coarse_occupancy(bitfield, 32),
                              sv_mask=mask, sv_payload=payload,
                              bootstrap=boot)
        loss = sum(jnp.sum(res[k] * J(c)) for k, c in cot.items())
        if not flat:
            loss = loss + jnp.sum(j_distortion(res["ws"], res["deltas"],
                                               res["ts"],
                                               res["sample_valid"]))
        return loss, res

    with jax.disable_jit(flat):
        (_, ref), (g_o, g_d) = jax.value_and_grad(
            loss_j, argnums=(0, 1), has_aux=True)(J(o), J(d))

    def port(term=True):
        ro, rd = T(o).requires_grad_(True), T(d).requires_grad_(True)
        march_t = tr.march_t
        if not term:
            tr.march_t = lambda t, *a, **k: t
        try:
            out = tr.render_train(tm, state, ro, rd, TRC(**rkw),
                                  global_step=global_step, bootstrap=boot,
                                  noise=T(noise), bg=T(bg))
        finally:
            tr.march_t = march_t
        loss = sum((out[k] * T(c)).sum() for k, c in cot.items())
        if not flat:
            loss = loss + t_distortion(out["ws"], out["deltas"], out["ts"],
                                       out["sample_valid"]).sum()
        loss.backward()
        return out, ro.grad, rd.grad

    out, go, gd = port()
    assert int(out["rm_samples"]) > 2 * n
    np.testing.assert_array_equal(N(out["ts"]), np.asarray(ref["ts"]))
    hits = jr.ray_aabb_intersect(J(o), J(d), jnp.zeros(3), jnp.full(3, 0.5))
    assert float(jnp.min(hits[:, 0])) > 0.1   # outside: t1 > 0 on a hit
    for got, r in ((go, g_o), (gd, g_d)):
        r = np.asarray(r)
        np.testing.assert_allclose(N(got), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
    # the t term carries a real share of the gradient
    _, go0, _ = port(term=False)
    r = np.asarray(g_o)
    assert np.abs(N(go0) - r).max() > 1e-2 * np.abs(r).max()


# ------------------------------------------------------------ steps
def _grads(tree):
    """{port parameter name: numpy} of a JAX params-shaped tree."""
    out = {k.replace("model.", "", 1): v for k, v in _flat(tree).items()}
    return out


@pytest.fixture(scope="module")
def ext_pair():
    """A JAX trainer with optimize_ext and lr_dR_norm_glob after one full
    refresh (bootstrap_steps 16, the bench's 24 sv intervals), its state
    with small non-zero dR (|v| ~ 0.02 rad) and dT (~0.01), and the port's
    trainer at the same configuration."""
    jcfg, tcfg = (_ext(c).replace(render=dataclasses.replace(
        c.render, bootstrap_steps=16, sv_intervals=24))
        for c in slice_configs())
    jt = JTrainer(jcfg, JSyn(**SCENE).load())
    jt.mark_invisible_cells()
    rng = np.random.default_rng(17)
    params = dict(jt.state.params)
    params["dR"] = J((0.01 * rng.standard_normal((6, 3))).astype(np.float32))
    params["dT"] = J((0.01 * rng.standard_normal((6, 3))).astype(np.float32))
    occ = jt._occ_update[True](jt.state.occ, params, jax.random.PRNGKey(7))
    state = jt.state._replace(params=params, occ=occ)
    tt = TTrainer(tcfg, TSyn(**SCENE).load(), device="cpu")
    assert {"dR", "dT", "dR_glob"} <= set(tt.params)
    assert tt.model.need_pos_grad
    return jt, tt, state


def _load(tt, state):
    tt.load_state(*convert_jax_state(
        jax.tree_util.tree_map(np.asarray, state.params),
        jax.tree_util.tree_map(np.asarray, state.occ), tt.opt, CPU),
        step=int(state.step))


def _compare_step(tt, m, loss_ref, grads, rm, vr, new):
    for k, v in loss_ref.items():
        np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                   rtol=1e-4, atol=1e-7, err_msg=f"loss {k}")
    n_rays = tt.sampler.batch_size
    assert round(float(m["rm_samples_per_ray"]) * n_rays) == rm > 0
    assert round(float(m["vr_samples_per_ray"]) * n_rays) == vr
    g_ref = _grads(grads)
    assert set(g_ref) == set(tt.last_grads)
    for n, g in tt.last_grads.items():
        r = g_ref[n]
        np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"grad {n}")
    assert np.abs(g_ref["dR"]).max() > 0 and np.abs(g_ref["dT"]).max() > 0
    assert not g_ref["dR_glob"].any() and not N(tt.last_grads["dR_glob"]).any()
    p_ref = _grads(new.params)
    lr = tt.cfg.optim.lr
    for n, p in tt.params.items():
        step_lr = EXT_LR if n in ("dR", "dT") else lr
        # a first Adam step is g / (|g| + 1e-15): where g is within the
        # gradient's tolerance of 0, its sign (a step of +-lr) is not held
        r = g_ref[n]
        tiny = np.abs(r) <= 1e-4 * np.abs(r).max()
        atol = np.where(tiny, 2 * step_lr, 1e-3 * step_lr)
        assert (np.abs(N(p) - p_ref[n]) <= atol).all(), (
            f"param {n} after the step: "
            f"{np.abs(N(p) - p_ref[n]).max()}")
    assert not N(tt.params["dR_glob"]).any()


def test_bootstrap_step_with_extrinsics_matches_jax(ext_pair):
    """A bootstrap step (H1's march) with optimize_ext and lr_dR_norm_glob:
    every loss, gradient (dR's, dT's and dR_glob's, which is 0) and
    parameter after the step against the eager JAX step and its optax
    update."""
    jt, tt, state = ext_pair
    _load(tt, state)
    draws, grads, loss_ref, rm, vr, new = _jax_step(jt, state, True)
    m = tt.train_step_core(bootstrap=True, draws=draws)
    _compare_step(tt, m, loss_ref, grads, rm, vr, new)


def test_sv_step_with_extrinsics_matches_jax(ext_pair):
    """An sv step (K1's march) at step 16, after the refresh that builds
    the sv tables, with optimize_ext and lr_dR_norm_glob."""
    jt, tt, state = ext_pair
    # a copy: the refresh donates the occupancy it is given
    occ = jax.tree_util.tree_map(lambda a: a.copy(), state.occ)
    state = state._replace(step=state.step + 16, occ=jt._occ_update[True](
        occ, state.params, jax.random.PRNGKey(16)))
    _load(tt, state)
    assert int(N(tt.occ.sv_mask).sum()) > 0
    draws, grads, loss_ref, rm, vr, new = _jax_step(jt, state, False)
    m = tt.train_step_core(bootstrap=False, draws=draws)
    _compare_step(tt, m, loss_ref, grads, rm, vr, new)


def test_step_from_zero_pose_deltas(ext_pair):
    """From the initial dR = 0: JAX's dR gradient is NaN (and its step
    would turn every parameter to NaN through the clip); the port's step
    is finite, its model and dT gradients JAX's, its dR gradient finite
    and non-zero, and every value of dR moved by at most one lr."""
    jt, tt, state = ext_pair
    params = dict(state.params)
    params["dR"] = jnp.zeros_like(params["dR"])
    state = state._replace(params=params)
    _load(tt, state)
    draws, grads, loss_ref, _, _, new = _jax_step(jt, state, True)
    assert np.isnan(np.asarray(grads["dR"])).any()
    assert np.isnan(np.asarray(new.params["model"]["sigma_net"]["w0"])).all()
    m = tt.train_step_core(bootstrap=True, draws=draws)
    for k, v in loss_ref.items():
        np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                   rtol=1e-4, atol=1e-7, err_msg=f"loss {k}")
    g_ref = _grads(grads)
    for n, g in tt.last_grads.items():
        assert np.isfinite(N(g)).all(), n
        if n != "dR":
            np.testing.assert_allclose(N(g), g_ref[n], rtol=1e-3,
                                       atol=1e-4 * np.abs(g_ref[n]).max(),
                                       err_msg=f"grad {n}")
    assert np.abs(N(tt.last_grads["dR"])).max() > 0
    assert 0 < np.abs(N(tt.params["dR"])).max() <= EXT_LR * (1 + 1e-6)


# ------------------------------------------------------------ files
def _ext_trainer(layout="triplane"):
    _, tcfg = slice_configs()
    tt = TTrainer(_ext(tcfg), TSyn(**SCENE).load(), device="cpu")
    rng = np.random.default_rng(31)
    with torch.no_grad():
        for k in ("dR", "dT"):
            tt.params[k].copy_(T(rng.standard_normal((6, 3))
                                 .astype(np.float32)))
    return tt


def test_weights_file_carries_pose_deltas(tmp_path):
    """`save_weights` writes dR, dT and dR_glob under JAX's keys (the JAX
    `save_weights` writes every leaf of params); the JAX `load_weights`
    reads them into its tree, and the port's `load_weights` reads a JAX
    file's back (`--weight_path`)."""
    tt = _ext_trainer()
    path = str(tmp_path / "w.npz")
    save_weights(path, tt.params)
    data = np.load(path)
    assert {"dR", "dT", "dR_glob"} <= set(data.files)
    tmpl = {k: jnp.zeros(tuple(tt.params[k].shape))
            for k in ("dR", "dT", "dR_glob")}
    got = jck.load_weights(path, tmpl)
    for k in tmpl:
        np.testing.assert_array_equal(np.asarray(got[k]), N(tt.params[k]))
    # a JAX file back into a fresh port trainer
    src = {k: (np.asarray(got[k]) + 1.0).astype(np.float32) for k in tmpl}
    jpath = str(tmp_path / "j.npz")
    jck.save_weights(jpath, {k: J(v) for k, v in src.items()})
    fresh = _ext_trainer()
    loaded = load_weights(jpath, fresh.params)
    for k in tmpl:
        np.testing.assert_array_equal(N(loaded[k]), src[k])


def test_checkpoint_carries_pose_deltas(tmp_path):
    """A full checkpoint of an ext trainer after two steps holds dR, dT and
    dR_glob with their moments; restored into a fresh trainer, every one
    equal bit for bit."""
    tt = _ext_trainer()
    tt.mark_invisible_cells()
    tt.fit(2)
    path = str(tmp_path / "ckpt")
    save_checkpoint(path, tt)
    fresh = _ext_trainer()
    with torch.no_grad():
        for k in ("dR", "dT"):
            fresh.params[k].zero_()
    restore_checkpoint(path, fresh)
    for k in ("dR", "dT", "dR_glob"):
        np.testing.assert_array_equal(N(fresh.params[k]), N(tt.params[k]))
        for m in ("mu", "nu"):
            np.testing.assert_array_equal(N(fresh.opt.state[m][k]),
                                          N(tt.opt.state[m][k]))
    assert np.abs(N(tt.opt.state["mu"]["dR"])).max() > 0
    assert fresh.step == tt.step == 2


# ------------------------------------------------------------ CLI
@pytest.mark.parametrize("flags", [("--optimize_ext",),
                                   ("--lr_dR_norm_glob=0.1",),
                                   ("--optimize_ext", "--lr_dR_norm_glob=0.1")])
def test_cli_trains_with_extrinsic_flags(flags, tmp_path, monkeypatch):
    """`main` with the flags builds a trainer holding dR / dT (with
    --optimize_ext, (n_images, 3) each) and dR_glob (with
    --lr_dR_norm_glob, (3,), which stays 0), and takes steps: the CLI's
    debug run cut to 3 steps, validation stubbed (tests/test_torch_cli.py
    runs it whole)."""
    monkeypatch.setattr(train_nerf, "_fit",
                        lambda trainer, cfg, logger: trainer.fit(3))
    monkeypatch.setattr(TTrainer, "validate",
                        lambda self, **kw: {"psnr": 0.0})
    run = {}
    train_nerf.main([*flags, "--dataset_name=synthetic",
                     f"--log_root_dir={tmp_path}", "--exp_name=ext"],
                    device="cpu", run=run)
    tt = run["trainer"]
    assert tt.step == 3
    ext = "--optimize_ext" in flags
    glob = any(f.startswith("--lr_dR_norm_glob") for f in flags)
    assert tt.model.need_pos_grad
    assert ("dR" in tt.params) == ("dT" in tt.params) == ext
    assert ("dR_glob" in tt.params) == glob
    if ext:
        n = tt.scene_train.n_images
        assert tt.params["dR"].shape == tt.params["dT"].shape == (n, 3)
        assert 0 < float(tt.params["dT"].detach().abs().max()) <= (
            3 * 7.3 * EXT_LR)
    if glob:
        assert not N(tt.params["dR_glob"]).any()
    assert os.path.exists(os.path.join(str(tmp_path), "ext", "results.csv"))
