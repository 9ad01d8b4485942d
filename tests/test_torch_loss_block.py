"""K10's plain version (`ops/loss_block.py`): the loss block's terms and
their hand-derived gradient, against the JAX package's `compute_losses`
(`jax.vjp`) where the existing loss tests do not reach, and K10's own
pieces against numpy.

K10 (`csrc/loss_block.cu`) runs only on the card; `chip_smoke.py`'s
`check_loss_block` holds it there to this plain version (the normals bit
for bit). Here, at the existing loss tests' shapes (96 rays,
`slice_configs()`; patches of 8 x 8 at 512 rays) and tolerances (values
rtol 1e-5, atol 1e-7; gradients rtol 1e-4, atol 1e-6):
  * the gradient of the rays' origins and directions (the ext path's),
    over triangles and over patch triangles with random poses;
  * a batch whose member discard empties the clusters: every clustering
    term and its gradient exactly 0;
  * a non-finite clustering term: 0, and no gradient from it;
  * a cotangent of every term besides the total's, on the rays and on
    the triangles of given normals with the snapping on; 40 classes; the
    rgb mean the trainer's psnr reads;
  * the ray -> (triangle, vertex) table against `patch_triang_idx` in
    numpy, the block trees against a numpy emulation of K10's threads,
    the ctypes arguments against the kernel's struct, and K10's launchers
    on CPU tensors.
"""
import ctypes
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import J, N, T, slice_configs
from test_torch_losses import PATCH, _init_idx, _pred_target

from normal_clustering_nerf_torch import losses as tl
from normal_clustering_nerf_torch.ops import kmeans as tk
from normal_clustering_nerf_torch.ops import loss_block as lb
from normal_clustering_nerf_tpu import losses as jl

VAL = dict(rtol=1e-5, atol=1e-7)
GRAD = dict(rtol=1e-4, atol=1e-6)
DIFF = ("rgb", "opacity", "ws", "depth", "sem")
RAYS = DIFF + ("rays_o", "rays_d")
CLUSTER = ("norm_D_C_ort_dot", "norm_D_C_centr_dot", "norm_D_C_centr_L1")
CU = open(lb.__file__.replace("ops/loss_block.py",
                              "csrc/loss_block.cu")).read()


def _configs(**loss):
    return tuple(c.replace(loss=dataclasses.replace(c.loss, **loss))
                 for c in slice_configs())


def _triangle_pred(seed, n=96):
    """`_pred_target`'s camera looking at a wall, from origins spread by
    0.05 (so that their gradient is not one sum)."""
    pred, target = _pred_target(seed, n)
    rng = np.random.default_rng(seed + 100)
    pred["rays_o"] = (0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    return pred, target


def _patch_pred(seed, n=512):
    """Patches of 8 x 8 rays, each looking at one wall of a box (axis patch
    % 3), from origins spread by 0.01: test_torch_losses.py's patch
    batch."""
    pred, target = _pred_target(seed, n=n)
    rng = np.random.default_rng(seed + 1)
    uv = (np.stack(np.meshgrid(np.arange(8), np.arange(8)), -1)
          .reshape(64, 2) - 3.5) * 0.03
    d = np.zeros((n // 64, 64, 3))
    for i in range(n // 64):
        a = i % 3
        d[i, :, a] = 1.0
        d[i, :, [(a + 1) % 3, (a + 2) % 3]] = (uv + rng.normal(
            0, 0.05, 2)).T
    d = d.reshape(n, 3)
    pred["rays_d"] = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(
        np.float32)
    axis = np.repeat(np.arange(n // 64) % 3, 64)
    pred["depth"] = (1.0 / np.abs(pred["rays_d"][np.arange(n), axis])
                     * rng.uniform(0.999, 1.001, n)).astype(np.float32)
    pred["rays_o"] = (0.01 * rng.standard_normal((n, 3))).astype(np.float32)
    return pred, target


def _vjp(jcfg, tcfg, pred, target, step, *, diff=DIFF, cot=None, sched=None,
         ray_sampling_strategy="all_images_triang", **kw):
    """compute_losses of both packages on the same inputs (the k-means
    init from JAX's draw): (the port's values, its gradients of the
    cotangent `cot` ({term: value}; the total's 1 when None), JAX's
    values, JAX's gradients)."""
    key = jax.random.PRNGKey(5)
    kw = dict(ray_sampling_strategy=ray_sampling_strategy, **kw)

    def loss_j(d):
        p = {k: J(v) for k, v in pred.items()}
        p.update(d)
        return jl.compute_losses(
            p, {k: J(v) for k, v in target.items()}, jcfg.loss, jcfg.model,
            step=step, key=key, **kw)

    ref, vjp_fn = jax.vjp(loss_j, {k: J(pred[k]) for k in diff})
    cot = cot or {"total": 1.0}
    g_ref = vjp_fn({k: jnp.full_like(v, cot.get(k, 0.0))
                    for k, v in ref.items()})[0]
    n, n_all = target["rgb"].shape[0], pred["rgb"].shape[0]
    u = n if kw.get("random_tr_poses") else 0
    idx = (jl.triang_idx(n_all - u) if "patch" not in ray_sampling_strategy
           else jl.patch_triang_idx(n_all - u, kw["patch_area"],
                                    kw["offsets_local"]))
    nd = np.asarray(jl.extract_normals_from_ray_batch(
        J(pred["rays_o"][u:]), J(pred["rays_d"][u:]), J(pred["depth"][u:]),
        idx))
    init = T(_init_idx(key, nd, jcfg.loss.cluster_K))
    tp = {k: T(v) for k, v in pred.items()}
    for k in diff:
        tp[k].requires_grad_(True)
    out = tl.compute_losses(tp, {k: T(v) for k, v in target.items()},
                            tcfg.loss, tcfg.model, step=step,
                            kmeans_init=init, sched=sched, **kw)
    total = sum(out[k] * c for k, c in cot.items())
    total.backward()
    grads = {k: torch.zeros_like(tp[k]) if tp[k].grad is None
             else tp[k].grad for k in diff}
    return out, grads, ref, g_ref


def _held(out, grads, ref, g_ref):
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), err_msg=k,
                                   **VAL)
    for k, g in grads.items():
        np.testing.assert_allclose(N(g), np.asarray(g_ref[k]), err_msg=k,
                                   **GRAD)
        assert np.isfinite(N(g)).all(), k


@pytest.mark.parametrize("case", ["triangles", "patches, random poses"])
def test_ray_gradients_match_jax(case):
    """The gradient of the rays' origins and directions (the ext path's
    pose gradient) through the hand-derived backward of the clustering
    terms: P = o + d depth, the cross product, the normalisation."""
    jcfg, tcfg = slice_configs()
    if case == "triangles":
        pred, target = _triangle_pred(12)
        kw = {}
    else:
        pred, target = _patch_pred(13)
        target = {k: v[:256] for k, v in target.items()}
        kw = dict(ray_sampling_strategy="all_images_triang_patch",
                  random_tr_poses=True, **PATCH)
    out, grads, ref, g_ref = _vjp(jcfg, tcfg, pred, target, 3000, diff=RAYS,
                                  **kw)
    _held(out, grads, ref, g_ref)
    assert float(out["norm_D_C_ort_dot"].detach()) != 0.0
    for k in ("rays_o", "rays_d", "depth"):
        assert N(grads[k]).any(), k
    if kw:   # the supervised rays give the clustering no gradient
        for k in ("rays_o", "rays_d", "depth"):
            assert not N(grads[k])[:256].any(), k


def test_an_empty_cluster_zeroes_the_clustering_terms():
    """The member discard at a threshold no member meets empties the
    clusters (`ok` false): every clustering term and its gradient exactly
    0, as JAX's, the other terms JAX's."""
    jcfg, tcfg = _configs(discard_far_members=True, norm_can_tres=1e-7)
    pred, target = _triangle_pred(14)
    out, grads, ref, g_ref = _vjp(jcfg, tcfg, pred, target, 3000, diff=RAYS)
    _held(out, grads, ref, g_ref)
    for k in CLUSTER:
        assert float(out[k].detach()) == 0.0, k
    # only the clustering terms read the depth and the rays
    for k in ("depth", "rays_o", "rays_d"):
        assert not N(grads[k]).any(), k


def test_a_non_finite_clustering_term_gives_no_gradient():
    """A clustering term whose weighted value is not finite (here an inf
    weight) is 0 and adds no gradient: every value and gradient is the one
    with that weight 0, bit for bit (the JAX chain's gradient through its
    guard is NaN there: 0 * inf)."""
    _, tcfg = slice_configs()
    pred, target = _triangle_pred(15)
    cpu = torch.device("cpu")
    init = None
    res = []
    for w in (float("inf"), 0.0):
        sched = tl._step_scalars(tcfg.loss, 3000, cpu)
        sched["w_norm_D_C_ort_dot"] = torch.tensor(w)
        tp = {k: T(v) for k, v in pred.items()}
        for k in RAYS:
            tp[k].requires_grad_(True)
        if init is None:
            init = torch.arange(tcfg.loss.cluster_K)
        out = tl.compute_losses(tp, {k: T(v) for k, v in target.items()},
                                tcfg.loss, tcfg.model, step=3000,
                                kmeans_init=init, sched=sched,
                                ray_sampling_strategy="all_images_triang")
        out["total"].backward()
        res.append((out, {k: tp[k].grad for k in RAYS}))
    (o_inf, g_inf), (o_0, g_0) = res
    assert float(o_inf["norm_D_C_ort_dot"].detach()) == 0.0
    for k in o_0:
        assert torch.equal(o_inf[k].detach(), o_0[k].detach()), k
    for k in RAYS:
        assert torch.equal(g_inf[k], g_0[k]), k
    assert float(o_0["norm_D_C_centr_dot"].detach()) != 0.0


def test_a_cotangent_of_every_term_matches_jax():
    """A cotangent on each of K10's terms besides the total's (the
    Function's terms output), values and gradients against jax.vjp."""
    jcfg, tcfg = slice_configs()
    pred, target = _triangle_pred(16)
    rng = np.random.default_rng(16)
    names = ("rgb", "opacity", "distortion") + CLUSTER + ("sem",)
    cot = {k: float(v) for k, v in zip(names, rng.uniform(0.5, 2.0, 7))}
    cot["total"] = 0.75
    _held(*_vjp(jcfg, tcfg, pred, target, 3000, diff=RAYS, cot=cot))


def _member_ties(pred, target, tcfg, init):
    """Members (the plain version's, on `init`) with a component of their
    flipped normal equal to their centroid's in f32: there |x|'s
    derivative is 0 in both packages, but JAX's centroid, summed in
    another order, may lie an ulp off and give it a sign."""
    plan, inp, xs = tl.block_inputs(
        {k: T(v) for k, v in pred.items()},
        {k: T(v) for k, v in target.items()}, tcfg.loss, tcfg.model,
        ray_sampling_strategy="all_images_triang", random_tr_poses=False,
        patch_area=None, offsets_local=None, kmeans_init=init,
        generator=None,
        sched=tl._step_scalars(tcfg.loss, 3000, torch.device("cpu")))
    nm, valid, slots = lb.rays_plain(plan, inp, *map(xs.get, lb.GRAD_INPUTS))
    clus = tk.normals_clustering(nm, valid, K=plan.K, niter=plan.niter,
                                 t_similar=1.0 - plan.tres, init_idx=init)
    *_, saved, code = lb.clusters_plain(plan, inp, nm, clus.assign_new,
                                        clus.centroids3, slots)
    c = saved[lb.S_C:lb.S_C + 9].view(3, 3)
    g = code.abs().to(torch.int64)
    nf = torch.where((code < 0)[:, None], -nm, nm)
    tie = (nf == c[(g - 1).clamp(min=0)]).any(-1) & (g > 0)
    return int(tie.sum())


def test_given_normals_with_a_cotangent_of_every_term_match_jax():
    """The snapping on and a cotangent of each clustering term, on the
    triangles of a box room whose normals are given (`_room_batch`, the
    snapping test's room): values and the gradients of the rays, their
    origins and directions against jax.vjp. The room holds no member
    whose normal ties its centroid in a component (`_member_ties`; the
    rooms' near-axis components are a few thousand ulps wide, and seed
    4's room has one)."""
    from test_torch_loss_terms import _room_batch
    jcfg, tcfg = _configs(norm_D_C_can_dot_w=2e-3, norm_D_C_can_L1_w=2e-3,
                          norm_can_tres=0.02)
    pred, target = _room_batch(2)
    names = CLUSTER + ("norm_D_C_can_dot", "norm_D_C_can_L1")
    cot = dict(zip(names, (0.5, 1.5, 2.0, 0.25, 3.0)))
    out, grads, ref, g_ref = _vjp(jcfg, tcfg, pred, target, 3000, diff=RAYS,
                                  cot=cot)
    nd = np.asarray(jl.extract_normals_from_ray_batch(
        J(pred["rays_o"]), J(pred["rays_d"]), J(pred["depth"]),
        jl.triang_idx(pred["depth"].shape[0])))
    init = T(_init_idx(jax.random.PRNGKey(5), nd, 20))   # `_vjp`'s draw
    assert _member_ties(pred, target, tcfg, init) == 0
    _held(out, grads, ref, g_ref)
    assert float(out["norm_D_C_can_dot"].detach()) != 0.0
    for k in ("rays_o", "rays_d", "depth"):
        assert N(grads[k]).any(), k
    # only the clustering terms have a cotangent
    for k in ("rgb", "opacity", "ws", "sem"):
        assert not N(grads[k]).any(), k


def test_forty_classes_match_jax():
    """The cross-entropy at 40 classes (the 40-class path's), labels 0
    (none) to 40, values and gradients."""
    jcfg, tcfg = slice_configs(n_sem_cls=40)
    pred, target = _triangle_pred(17)
    rng = np.random.default_rng(17)
    pred["sem"] = rng.standard_normal((96, 40)).astype(np.float32)
    target["semantics"] = rng.integers(0, 41, 96).astype(np.int32)
    out, grads, ref, g_ref = _vjp(jcfg, tcfg, pred, target, 3000)
    _held(out, grads, ref, g_ref)
    assert N(grads["sem"]).any() and float(out["sem"].detach()) > 0.0


def test_the_rgb_mean_is_the_psnr_s_before_its_guard():
    """compute_losses' `stats["mse"]` (the trainer's psnr reads it): the
    rgb mean, also where it is not finite and the rgb term is 0."""
    _, tcfg = slice_configs()
    pred, target = _triangle_pred(18)
    for bad in (False, True):
        p = {k: T(v) for k, v in pred.items()}
        if bad:
            p["rgb"][3, 1] = float("nan")
        stats = {}
        out = tl.compute_losses(p, {k: T(v) for k, v in target.items()},
                                tcfg.loss, tcfg.model, step=3000,
                                ray_sampling_strategy="all_images_triang",
                                kmeans_init=torch.arange(20), stats=stats)
        want = np.mean((pred["rgb"].astype(np.float64) - target["rgb"]) ** 2)
        if bad:
            assert np.isnan(float(stats["mse"]))
            assert float(out["rgb"]) == 0.0
        else:
            np.testing.assert_allclose(float(stats["mse"]), want, rtol=1e-6)
            assert float(out["rgb"]) == float(stats["mse"])
        assert not stats["mse"].requires_grad


@pytest.mark.parametrize("n", [64, 256, 512])
def test_incidence_table_matches_patch_triang_idx(n):
    """Each ray's row of the table: its (triangle t, vertex k) of
    `patch_triang_idx` as 3 t + k in increasing order, -1 after; as wide as
    the most a ray has (3 for 8 x 8 patches); the triangle batches' one
    entry a ray."""
    idx = jl.patch_triang_idx(n, **PATCH)
    want = [[] for _ in range(n)]
    for k, name in enumerate(("x1", "x2", "x3")):
        for t, r in enumerate(np.asarray(idx[name])):
            want[r].append(3 * t + k)
    W = max(len(w) for w in want)
    want = np.array([sorted(w) + [-1] * (W - len(w)) for w in want])
    got = N(tl.incidence_table_on("all_images_triang_patch", n,
                                  PATCH["patch_area"], PATCH["offsets_local"],
                                  torch.device("cpu")))
    assert W == 3 and got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    tri = N(tl.incidence_table_on("all_images_triang", 3 * (n // 3), None,
                                  None, torch.device("cpu")))
    np.testing.assert_array_equal(tri, np.arange(3 * (n // 3))[:, None])


def _emulated_block(vals, threads):
    """numpy, thread by thread: K10's block_sums of one value a thread
    (vals (threads,) f32): each warp's lanes by shuffles xor 16..1, lane
    0's sum a warp, then warp 0's lanes over the warp sums by shuffles
    xor warps/2..1."""
    f = np.float32
    warps = threads // 32
    lanes = vals.reshape(warps, 32).astype(f)
    for o in (16, 8, 4, 2, 1):
        lanes = np.stack([[f(w[l] + w[l ^ o]) for l in range(32)]
                          for w in lanes])
    w = np.concatenate([lanes[:, 0], np.zeros(32 - warps, f)])
    o = warps // 2
    while o:
        w = np.array([f(w[l] + w[l ^ o]) for l in range(32)], f)
        o //= 2
    return w[0]


@pytest.mark.parametrize("threads,rows", [(256, 256), (1024, 1024),
                                          (1024, 2730)])
def test_block_trees_match_an_emulation_of_the_threads(threads, rows):
    """`tree_sum` / `strided_sum` bit for bit a numpy emulation of K10's
    threads (thread t adds rows t, t + threads, ... from +0.0, then the
    block's tree), on values of mixed magnitudes where order shows."""
    rng = np.random.default_rng(threads + rows)
    x = (rng.standard_normal((rows, 2))
         * 10.0 ** rng.integers(-6, 6, (rows, 2))).astype(np.float32)
    got = N(lb.strided_sum(T(x), threads))
    for c in range(2):
        acc = np.zeros(threads, np.float32)
        for r in range(0, rows, threads):
            part = np.zeros(threads, np.float32)
            part[:min(threads, rows - r)] = x[r:r + threads, c]
            acc = (acc + part).astype(np.float32)
        want = _emulated_block(acc, threads)
        assert got[c].tobytes() == np.float32(want).tobytes(), c
    # a block of loss_rays: one value a thread
    v = x[:threads, 0] if rows >= threads else None
    if v is not None:
        assert (N(lb.tree_sum(T(v)[None]))[0].tobytes()
                == np.float32(_emulated_block(v, threads)).tobytes())


def test_args_and_saved_layout_match_the_kernel():
    """The ctypes Args against csrc/loss_block.cu's struct (its fields in
    order, their types and its size), and the SAVED offsets and the terms'
    order against the kernel's enums."""
    assert f"sizeof(Args) == {ctypes.sizeof(lb._Args)}" in CU
    body = re.search(r"struct Args \{(.*?)\n\};", CU, re.S).group(1)
    names = []
    for line in body.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        decl = re.sub(r"^(const )?(long |signed )?\w+\s*\*?\s*", "", line)
        names += [re.sub(r"\[.*\]", "", d).strip(" *")
                  for d in decl.split(",")]
    assert names == [f[0] for f in lb._Args._fields_]
    for name, value in (("S_F", lb.S_F), ("S_DEN", lb.S_DEN),
                        ("S_K", lb.S_K), ("S_C", lb.S_C), ("S_S", lb.S_S),
                        ("S_R", lb.S_R), ("S_SG", lb.S_SG),
                        ("S_SD", lb.S_SD), ("S_COND", lb.S_COND),
                        ("S_NCOND", lb.S_NCOND), ("SAVED", lb.SAVED)):
        assert re.search(rf"\b{name} = {value}\b", CU), name
    assert "enum { RGB, OPAC, DIST, ORT, CDOT, CL1, CANDOT, CANL1, SEM };" \
        in CU and lb.TERMS[lb.SEM] == "sem"
    assert f"RAY_THREADS = {lb.RAY_THREADS};" in CU
    assert f"CL_THREADS = {lb.CL_THREADS};" in CU


def test_launchers_refuse_cpu_tensors():
    """K10's arguments are checked before any launch: CPU tensors raise
    (the wrapper takes the plain version for them itself)."""
    _, tcfg = slice_configs()
    pred, target = _triangle_pred(19)
    p = {k: T(v) for k, v in pred.items()}
    t = {k: T(v) for k, v in target.items()}
    sched = tl._step_scalars(tcfg.loss, 3000, torch.device("cpu"))
    plan, inp, xs = tl.block_inputs(
        p, t, tcfg.loss, tcfg.model,
        ray_sampling_strategy="all_images_triang", random_tr_poses=False,
        patch_area=None, offsets_local=None, kmeans_init=None,
        generator=None, sched=sched)
    with pytest.raises(ValueError, match="CUDA"):
        lb.make_args(plan, inp, **xs)
