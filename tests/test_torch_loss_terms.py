"""The loss terms, render options and optimizer group of the paper's
baselines, port against the JAX package: `compute_losses` with the depth
L2 and the GT-normal L1 / dot terms (depth-supervised and
normal-supervised NGP), `reg_depth` on random-pose rays (RegNeRF), the
Manhattan-SDF wall/floor terms with theta_WF, the canonical-axis snapping
with `discard_far_members`, and `distortion_ts_bug_compat` in the dense
and the flat layout; the 'depth' interval annealing and
`pred_norm_nn_norm`; and one AdamW step with theta_WF against JAX's
`build_optimizer` chain.

Inputs are made with numpy from a seed; the k-means init is drawn by JAX
and handed in (test_torch_losses.py). Tolerances: loss values rtol 1e-5,
atol 1e-7; gradients rtol 1e-4, atol 1e-6 (f32 sums in another order),
those of test_torch_losses.py; the flat layout's distortion against JAX
rtol 2e-5, atol 2e-6 (JAX's global f32 cumsum, test_torch_flat.py); the
annealed intervals exact; the optimizer step rtol 1e-6, atol 1e-9 (optax's
arithmetic in its order, f32 rounding of the global norm's sum).
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import J, N, T, slice_configs
from test_torch_flat import _dense, _flat
from test_torch_losses import DIFF, _init_idx, _pred_target

from normal_clustering_nerf_torch import losses as tl
from normal_clustering_nerf_torch.models import rendering as tr
from normal_clustering_nerf_torch.ops import kmeans as tk
from normal_clustering_nerf_torch.training.state import AdamW
from normal_clustering_nerf_tpu import losses as jl
from normal_clustering_nerf_tpu.models import rendering as jr
from normal_clustering_nerf_tpu.training.state import build_optimizer

VAL = dict(rtol=1e-5, atol=1e-7)
GRAD = dict(rtol=1e-4, atol=1e-6)
NO_CLUSTERING = dict(norm_D_C_ort_dot_w=0.0, norm_D_C_centr_dot_w=0.0,
                     norm_D_C_centr_L1_w=0.0)


def _configs(**loss):
    jcfg, tcfg = slice_configs()
    return tuple(c.replace(loss=dataclasses.replace(c.loss, **loss))
                 for c in (jcfg, tcfg))


def _labels(seed, n, walls_floors=True):
    """GT labels of `n` rays: depth with zeros (invalid), unit normals and
    depth normals with zero rows, wall/floor semantics (0 void, 1 wall, 2
    floor, 3 the rest; without walls and floors only 0 and 3)."""
    rng = np.random.default_rng(seed)
    depth = rng.uniform(0.2, 1.0, n).astype(np.float32)
    depth[rng.random(n) < 0.2] = 0.0
    out = {"depth": depth}
    for k in ("normals", "normals_depth"):
        v = rng.standard_normal((n, 3)).astype(np.float32)
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        v[rng.random(n) < 0.2] = 0.0
        out[k] = v
    sem = rng.integers(0, 4, n) if walls_floors else rng.choice([0, 3], n)
    out["semantics_WF"] = sem.astype(np.int32)
    return out


def _compare(jcfg, tcfg, pred, target, step, *, diff=DIFF, theta=None,
             clustering=False, val=VAL,
             ray_sampling_strategy="all_images_triang", **kw):
    """compute_losses of both packages on the same inputs: every value,
    and the gradient of 'total' with respect to `diff` (and theta_WF).
    Returns the port's values and gradients."""
    key = jax.random.PRNGKey(5)
    jkw = dict(ray_sampling_strategy=ray_sampling_strategy, **kw)
    jd = {k: J(pred[k]) for k in diff}
    if theta is not None:
        jd["theta_WF"] = J(np.float32(theta))

    def loss_j(d):
        p = {k: J(v) for k, v in pred.items()}
        p.update({k: v for k, v in d.items() if k != "theta_WF"})
        return jl.compute_losses(
            p, {k: J(v) for k, v in target.items()}, jcfg.loss, jcfg.model,
            step=step, key=key, theta_WF=d.get("theta_WF"), **jkw)

    ref, vjp_fn = jax.vjp(loss_j, jd)
    g_ref = vjp_fn({k: jnp.ones_like(v) if k == "total" else jnp.zeros_like(v)
                    for k, v in ref.items()})[0]
    init = None
    if clustering:
        n, n_all = target["rgb"].shape[0], pred["rgb"].shape[0]
        u = n if kw.get("random_tr_poses") else 0
        nd = np.asarray(jl.extract_normals_from_ray_batch(
            J(pred["rays_o"][u:]), J(pred["rays_d"][u:]),
            J(pred["depth"][u:]), jl.triang_idx(n_all - u)))
        init = T(_init_idx(key, nd, jcfg.loss.cluster_K))
    tp = {k: T(v) for k, v in pred.items()}
    for k in diff:
        tp[k].requires_grad_(True)
    th = None
    if theta is not None:
        th = torch.tensor(np.float32(theta), requires_grad=True)
    out = tl.compute_losses(tp, {k: T(v) for k, v in target.items()},
                            tcfg.loss, tcfg.model, step=step,
                            kmeans_init=init, theta_WF=th, **jkw)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), err_msg=k,
                                   **val)
    out["total"].backward()
    # an input the loss does not read has no gradient: zeros, as JAX's
    grads = {k: torch.zeros_like(tp[k]) if tp[k].grad is None
             else tp[k].grad for k in diff}
    if th is not None:
        grads["theta_WF"] = th.grad
    for k, g in grads.items():
        np.testing.assert_allclose(N(g), np.asarray(g_ref[k]), err_msg=k,
                                   **GRAD)
        assert np.isfinite(N(g)).all(), k
    return out, grads


@pytest.mark.parametrize("gt_depth_normals", [False, True])
def test_depth_and_gt_normal_terms_match_jax(gt_depth_normals):
    """depth_w on the rays with GT depth > 0, and the GT-normal L1 and dot
    terms against `normals` or, under norm_GT_depth, `normals_depth`, at
    the first pixel of each triangle; rows of zero GT normals (and GT
    depth 0) are left out of the means."""
    jcfg, tcfg = _configs(depth_w=0.1, norm_depth_L1_w=0.05,
                          norm_depth_dot_w=0.05,
                          norm_GT_depth=gt_depth_normals, **NO_CLUSTERING)
    pred, target = _pred_target(20)
    target.update(_labels(21, 96))
    out, grads = _compare(jcfg, tcfg, pred, target, 3000)
    for k in ("depth", "norm_D_L1", "norm_D_dot"):
        assert float(out[k].detach()) != 0.0, k
    assert N(grads["depth"]).any()


@pytest.mark.parametrize("step", [400, 3000])
def test_reg_depth_on_random_pose_rays_matches_jax(step):
    """RegNeRF's depth smoothness on the random-pose rays (the last 48 of
    96; rgb on the first 48), zero up to norm_can_start (500) and on after
    it, beside the clustering terms on the same rays (12 clusters: the 48
    rays make 16 triangles, and the k-means draws its init without
    replacement)."""
    jcfg, tcfg = _configs(reg_depth_w=0.1, cluster_K=12)
    pred, target = _pred_target(22)
    target = {k: v[:48] for k, v in target.items()}
    out, grads = _compare(jcfg, tcfg, pred, target, step, clustering=True,
                          random_tr_poses=True)
    on = float(out["reg_depth"].detach()) != 0.0
    assert on == (step > 500)
    assert not N(grads["rgb"])[48:].any()


@pytest.mark.parametrize("walls_floors", [True, False])
@pytest.mark.parametrize("step", [400, 3000])
def test_manhattan_terms_match_jax(step, walls_floors):
    """The Manhattan-SDF block: the wall/floor cross-entropy (class
    weights 1, 1, 0.3, label smoothing 0.1) in place of the semantic CE,
    and the wall/floor normal term, unweighted before norm_can_start and
    weighted by the predicted classes after it, with its gradient with
    respect to theta_WF (0 before the start, where theta is not read);
    without walls and floors the normal term is 0."""
    jcfg, tcfg = _configs(manhattan_nerf_w=0.05, **NO_CLUSTERING)
    pred, target = _pred_target(23)
    target.update(_labels(24, 96, walls_floors))
    out, grads = _compare(jcfg, tcfg, pred, target, step, theta=0.3)
    assert "sem" not in out and float(out["sem_WF"].detach()) != 0.0
    wf = float(out["norm_WF"].detach())
    assert (wf != 0.0) == walls_floors
    assert (float(grads["theta_WF"]) != 0.0) == (walls_floors and step > 500)


def _room_normals(seed, M=900, noise=0.08):
    """Noisy normals of a box room whose axes lie 0.04 rad from the
    canonical ones (so that the centroids snap), with flipped, zero and
    NaN rows."""
    rng = np.random.default_rng(seed)
    c, s = np.cos(0.04), np.sin(0.04)
    q = np.asarray([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
    axes = np.concatenate([q, -q])
    n = axes[rng.integers(0, 6, M)] + noise * rng.standard_normal((M, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:10] = 0.0
    n[10:12] = np.nan
    return n.astype(np.float32)


def _room_batch(seed, M=900):
    """A triangle batch of 3 M rays whose depth normals are the box room's
    (`_room_normals`, to ~1e-5): triangle i's corners P1, P1 + 0.05 u and
    P1 + 0.05 v with u x v its normal, seen from origins spread by 0.05 at
    depths in [0.5, 1.5]; the zero and NaN rows become triangles of no
    area (zero normals: a NaN depth would give JAX's chain a NaN
    gradient). `_pred_target`'s other outputs and targets."""
    n = _room_normals(seed, M).astype(np.float64)
    n = np.where(np.isfinite(n), n, 0.0)
    rng = np.random.default_rng(seed + 50)
    pred, target = _pred_target(seed, n=3 * M)
    # an axis each normal is far from: u = n x axis (unit), v = n x u
    u = np.cross(n, np.eye(3)[np.argmin(np.abs(n), -1)])
    u /= np.maximum(np.linalg.norm(u, axis=1, keepdims=True), 1e-30)
    v = np.cross(n, u)
    P1 = rng.uniform(-1.0, 1.0, (M, 3)) + [0.0, 0.0, 3.0]
    P = np.stack([P1, P1 + 0.05 * u, P1 + 0.05 * v], 1).reshape(-1, 3)
    o = 0.05 * rng.standard_normal((3 * M, 3))
    depth = rng.uniform(0.5, 1.5, 3 * M)
    pred["rays_o"] = o.astype(np.float32)
    pred["rays_d"] = ((P - o) / depth[:, None]).astype(np.float32)
    pred["depth"] = depth.astype(np.float32)
    return pred, target


def test_snapping_and_member_discard_match_jax():
    """The clustering terms with the canonical-axis snapping and
    `discard_far_members` on the depth normals of a box room's triangles
    (`_room_batch`), through compute_losses: values and gradients; the
    snapping is on (can_dot != 0) and the discard takes members out of a
    cluster."""
    lc = dict(norm_D_C_can_dot_w=2e-3, norm_D_C_can_L1_w=2e-3,
              norm_can_tres=0.02)
    pred, target = _room_batch(2)
    nd = np.asarray(jl.extract_normals_from_ray_batch(
        J(pred["rays_o"]), J(pred["rays_d"]), J(pred["depth"]),
        jl.triang_idx(pred["depth"].shape[0])))
    # the init `_compare` draws
    init = _init_idx(jax.random.PRNGKey(5), nd, 20)
    counts = {}
    for discard in (False, True):
        jcfg, tcfg = _configs(discard_far_members=discard, **lc)
        out, grads = _compare(jcfg, tcfg, pred, target, 3000,
                              clustering=True)
        assert float(out["norm_D_C_can_dot"].detach()) != 0.0
        assert N(grads["depth"]).any()
        # the members of each cluster, as the loss selects them
        ok = np.abs(nd).sum(-1) != 0
        clus = tk.normals_clustering(T(nd), T(ok), K=20, niter=20,
                                     t_similar=0.98, init_idx=T(init))
        a = N(clus.assign_new)
        flipped = np.where((a < 0)[:, None], -nd, nd)
        near = (1.0 - flipped @ N(clus.centroids3).T) <= 0.02
        counts[discard] = [int(((np.abs(a) == g + 1)
                                & (near[:, g] | (not discard))).sum())
                           for g in range(3)]
    assert counts[True] != counts[False] and min(counts[True]) > 0


def test_clustering_terms_at_cluster_K_40_match_jax():
    """The clustering terms with cluster_K 40 (past one warp of clusters;
    the port refused it once, the JAX package takes any K) on the box
    room's triangles of the snapping test, through compute_losses: values
    and gradients."""
    pred, target = _room_batch(2)
    jcfg, tcfg = _configs(cluster_K=40)
    out, grads = _compare(jcfg, tcfg, pred, target, 3000, clustering=True)
    assert float(out["norm_D_C_ort_dot"].detach()) != 0.0
    assert N(grads["depth"]).any()


def _flat_pred(seed):
    """A flat-layout batch: the samples of test_torch_flat's rows
    compacted ray-major (the segments' ray_id, ray_start and ray_count,
    which JAX's version does not read), random weights, and the per-ray
    outputs."""
    s = _dense(seed)
    mr, _, _ = _flat(s)
    pred, target = _pred_target(seed, n=s["valid"].shape[0])
    rng = np.random.default_rng(seed)
    pred.update(ws=rng.random(mr.t.shape[0]).astype(np.float32) / 16,
                ts=N(mr.t), deltas=N(mr.dt), sample_valid=N(mr.valid),
                ray_id=N(mr.ray_id), ray_start=N(mr.ray_start),
                ray_count=N(mr.ray_count))
    return pred, target


@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_distortion_ts_bug_compat_matches_jax(layout):
    """`distortion_ts_bug_compat` feeds ts as the weights in both
    layouts: the value is JAX's, and the distortion term gives the
    weights no gradient (the term's only other inputs are constants of
    the march). The flat batch (64 rays) is not made of triangles: the
    pixel sampler, without depth normals."""
    jcfg, tcfg = _configs(distortion_ts_bug_compat=True, **NO_CLUSTERING)
    if layout == "dense":
        pred, target = _pred_target(25)
        out, grads = _compare(jcfg, tcfg, pred, target, 3000)
    else:
        jcfg, tcfg = (c.replace(model=dataclasses.replace(
            c.model, pred_norm_depth=False)) for c in (jcfg, tcfg))
        pred, target = _flat_pred(25)
        out, grads = _compare(jcfg, tcfg, pred, target, 3000,
                              val=dict(rtol=2e-5, atol=2e-6),
                              ray_sampling_strategy="all_images")
    assert float(out["distortion"].detach()) != 0.0
    assert not N(grads["ws"]).any()


# ------------------------------------------------------------ render options
def test_depth_annealing_matches_jax():
    """The 'depth' strategy at steps 0, 150 (mid) and 300 (off) of
    anneal_steps 300, rays with GT depth 0 included: the port's intervals
    equal JAX's, by the host path and by a step-table row alike; more
    rays than GT depths are refused, where JAX fails to broadcast."""
    rng = np.random.default_rng(30)
    n = 96
    t1 = rng.uniform(0.0, 0.5, n).astype(np.float32)
    hits = np.stack([t1, t1 + rng.uniform(0.2, 1.2, n).astype(np.float32)],
                    -1)
    depth = rng.uniform(0.0, 1.5, n).astype(np.float32)
    depth[:10] = 0.0
    for step in (0, 150, 300):
        ref = jr._anneal_hits(J(hits), jnp.int32(step), "depth", 300,
                              J(depth))
        host = tr.anneal_hits(T(hits), step, "depth", 300, depth_gt=T(depth))
        n_i, on = tr.anneal_schedule(step, 300, "depth")
        sched = {"anneal_n_i": torch.tensor(n_i, dtype=torch.float32),
                 "anneal_on": torch.tensor(float(on))}
        row = tr.anneal_hits(T(hits), step, "depth", 300, sched=sched,
                             depth_gt=T(depth))
        np.testing.assert_array_equal(N(host), np.asarray(ref))
        np.testing.assert_array_equal(N(row), np.asarray(ref))
        assert on == (step < 300)
        assert (N(host) != hits).any() == on
    with pytest.raises(ValueError, match="one GT depth a ray"):
        tr.anneal_hits(T(np.concatenate([hits, hits])), 0, "depth", 300,
                       depth_gt=T(depth))


def test_pred_norm_nn_norm_matches_jax():
    """`split_rend` with pred_norm_nn_norm: the composited normals made
    unit length, zero vectors kept at zero, values and gradients equal to
    JAX's and finite."""
    jcfg, tcfg = slice_configs(pred_norm_nn_norm=True)
    rng = np.random.default_rng(31)
    rend = rng.standard_normal((64, tcfg.model.rend_channels)).astype(
        np.float32)
    rend[:5, 3:6] = 0.0
    g = rng.standard_normal((64, 3)).astype(np.float32)
    model = SimpleNamespace(cfg=jcfg.model)
    ref, vjp_fn = jax.vjp(lambda r: jr._split_rend(model, r)["norm_nn"],
                          J(rend))
    g_ref = vjp_fn(J(g))[0]
    x = T(rend).requires_grad_(True)
    out = tr.split_rend(tcfg.model, x)
    np.testing.assert_allclose(N(out["norm_nn"]), np.asarray(ref), **VAL)
    assert not N(out["norm_nn"])[:5].any()
    np.testing.assert_allclose(np.linalg.norm(N(out["norm_nn"])[5:], axis=1),
                               1.0, rtol=1e-6)
    (out["norm_nn"] * T(g)).sum().backward()
    np.testing.assert_allclose(N(x.grad), np.asarray(g_ref), **GRAD)
    assert np.isfinite(N(x.grad)).all()


# -------------------------------------------------------------- optimizer
@pytest.mark.parametrize("clip", [True, False])
def test_adamw_with_theta_matches_the_jax_chain(clip):
    """Two AdamW steps over a hash table, a network weight and theta_WF
    from the same gradients, against JAX's `build_optimizer` chain
    (clip_by_global_norm, adamw masked off the hash table, adam for
    theta_WF): theta_WF takes no weight decay (weight_decay_net 0.1 here,
    so that a decayed theta would show), its gradient is clipped with the
    others, and its moments are the optimizer's. With `clip` the global
    norm exceeds grad_clip."""
    jcfg, tcfg = slice_configs()
    jcfg, tcfg = (c.replace(optim=dataclasses.replace(
        c.optim, weight_decay_net=0.1)) for c in (jcfg, tcfg))
    rng = np.random.default_rng(32 + clip)
    p_np = {"hash_table": {"planes": rng.standard_normal((4, 8))},
            "sigma_net": {"w0": rng.standard_normal((8, 4))}}
    p_np = jax.tree_util.tree_map(lambda a: a.astype(np.float32), p_np)
    jparams = {"model": jax.tree_util.tree_map(J, p_np),
               "theta_WF": jnp.float32(0.2)}
    tx = build_optimizer(jcfg, jparams)
    jstate = tx.init(jparams)
    tparams = {"hash_table.planes": T(p_np["hash_table"]["planes"]),
               "sigma_net.w0": T(p_np["sigma_net"]["w0"]),
               "theta_WF": torch.tensor(0.2)}
    opt = AdamW(tparams, tcfg.optim)
    scale = 1.0 if clip else 1e-4
    for count in range(2):
        g_np = {"hash_table": {"planes": rng.standard_normal((4, 8))},
                "sigma_net": {"w0": rng.standard_normal((8, 4))}}
        g_np = jax.tree_util.tree_map(
            lambda a: (a * scale).astype(np.float32), g_np)
        g_theta = np.float32(0.5 * scale)
        jg = {"model": jax.tree_util.tree_map(J, g_np),
              "theta_WF": J(g_theta)}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        lr, bc1, bc2 = (torch.tensor(v, dtype=torch.float32)
                        for v in opt.schedule(count))
        g_norm = opt.update({"hash_table.planes":
                             T(g_np["hash_table"]["planes"]),
                             "sigma_net.w0": T(g_np["sigma_net"]["w0"]),
                             "theta_WF": T(g_theta)}, lr, bc1, bc2)
        opt.advance()
        assert (float(g_norm) > tcfg.optim.grad_clip) == clip
        want = {"hash_table.planes": jparams["model"]["hash_table"]["planes"],
                "sigma_net.w0": jparams["model"]["sigma_net"]["w0"],
                "theta_WF": jparams["theta_WF"]}
        for n, w in want.items():
            np.testing.assert_allclose(N(tparams[n]), np.asarray(w),
                                       rtol=1e-6, atol=1e-9, err_msg=n)
    # theta_WF's moments are the optimizer's own
    assert float(opt.state["mu"]["theta_WF"]) != 0.0
