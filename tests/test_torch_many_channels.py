"""Compositing at more channels than one tile of H3 (ROADMAP C1): the
plain versions of H3's four launchers at C = 46 (3 rgb + 3 normals + 40
semantic classes, NYU40's count) against the JAX package's
`composite_rays` and `composite_rays_compact`, the wrappers taking any
channel count, and one training step with 40 semantic classes against
the eager JAX step.

Tolerances, as in tests/test_torch_composite.py and
tests/test_torch_flat.py: forward values rtol 1e-5, atol 1e-6 (prefix
sums in another order; the flat layout rtol 2e-5, atol 2e-6 for JAX's
global cumsum); gradients rtol 1e-4, atol 1e-5 of the largest entry
(the closed form against autodiff); the training step as
tests/test_torch_slice.py holds it (losses rtol 1e-4, atol 1e-7;
counters exact; gradients rtol 1e-3, atol 1e-4 of the largest).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_common import CPU, J, N, T, slice_configs
from test_torch_slice import _flat as _flat_tree
from test_torch_slice import _jax_draws

from normal_clustering_nerf_torch.convert import convert_jax_state
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.ops import composite as tc
from normal_clustering_nerf_torch.ops.ray_march import compact_samples
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.ops import composite as jc
from normal_clustering_nerf_tpu.training import Trainer as JTrainer

C, THR, N_CLS = 46, 1e-4, 40


def _case(seed, n=300, K=16):
    """As tests/test_torch_composite.py draws its rays, at C channels."""
    rng = np.random.default_rng(seed)
    sig = np.exp(rng.normal(1.0, 2.0, (n, K))).astype(np.float32)
    sig[: n // 4] *= 200.0                 # opaque rays terminate early
    raws = rng.standard_normal((n, K, C)).astype(np.float32)
    dt = rng.uniform(0.005, 0.05, (n, K)).astype(np.float32)
    ts = np.cumsum(dt, axis=1).astype(np.float32)
    count = rng.integers(0, K + 1, n)
    valid = np.arange(K)[None, :] < count[:, None]
    cot = [rng.standard_normal(s).astype(np.float32)
           for s in ((n,), (n,), (n, C), (n, K))]
    return sig, raws, dt, ts, valid, cot


@pytest.mark.parametrize("K,with_t_start", [(16, False), (64, True)])
def test_forward_at_46_channels_matches_jax(K, with_t_start):
    """K 16 (the bench's rows) and K 64 with T_start (a test round's: H3
    takes such rows in chunks and the 48 sums in passes)."""
    sig, raws, dt, ts, valid, _ = _case(K, K=K)
    t_start = None
    if with_t_start:
        t_start = np.random.default_rng(1).uniform(0, 1, sig.shape[0])
        t_start = t_start.astype(np.float32)
    ref = jc.composite_rays(J(sig), J(raws), J(dt), J(ts), J(valid), THR,
                            T_start=None if t_start is None else J(t_start))
    out = tc.composite_rays(T(sig), T(raws), T(dt), T(ts), T(valid), THR,
                            T_start=None if t_start is None else T(t_start))
    for k in ("opacity", "depth", "rend", "ws"):
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(N(out["vr_samples"]),
                                  np.asarray(ref["vr_samples"]))
    assert N(out["rend"]).shape[-1] == C
    assert (N(out["vr_samples"]) < valid.sum(1)).any()   # early stops seen


def test_backward_at_46_channels_matches_jax_vjp():
    sig, raws, dt, ts, valid, cot = _case(2)

    def f(s, r):
        o = jc.composite_rays(s, r, J(dt), J(ts), J(valid), THR)
        return o["opacity"], o["depth"], o["rend"], o["ws"]
    _, vjp = jax.vjp(f, J(sig), J(raws))
    d_sig_ref, d_raw_ref = vjp(tuple(J(c) for c in cot))
    st, rt = T(sig).requires_grad_(True), T(raws).requires_grad_(True)
    out = tc.composite_rays(st, rt, T(dt), T(ts), T(valid), THR)
    sum((out[k] * T(c)).sum() for k, c in
        zip(("opacity", "depth", "rend", "ws"), cot)).backward()
    for ref, got, name in ((d_sig_ref, st.grad, "d_sigmas"),
                           (d_raw_ref, rt.grad, "d_raws")):
        r = np.asarray(ref)
        np.testing.assert_allclose(N(got), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def test_compact_at_46_channels_matches_jax():
    """The flat layout (H3's segment launchers' plain versions): forward
    and gradients against `composite_rays_compact` on the samples of
    dense rows compacted ray-major, with padding slots. Sigmas and steps
    as tests/test_torch_flat.py draws them (the batch's sigma * delta
    sums to ~60, where JAX's global cumsum stays inside the tolerance)."""
    _, raws, _, _, valid, cot = _case(3, n=64)
    rng = np.random.default_rng(5)
    sig = (30.0 * rng.random(valid.shape) ** 2).astype(np.float32)
    dt = rng.uniform(0.002, 0.02, valid.shape).astype(np.float32)
    ts = (0.05 + np.cumsum(dt, 1)).astype(np.float32)
    mr = compact_samples(T(valid), T(ts), T(dt), int(valid.sum()) + 40)
    rid, v = N(mr.ray_id), N(mr.valid)
    pos = np.clip(np.arange(rid.shape[0]) - N(mr.ray_start)[rid], 0, 15)
    fsig = np.where(v, sig[rid, pos], 0).astype(np.float32)
    fraws = np.where(v[:, None], raws[rid, pos], 0).astype(np.float32)
    g_ws = np.random.default_rng(4).standard_normal(v.shape[0])
    g_ws = g_ws.astype(np.float32)
    cots = cot[:3] + [g_ws]
    st, rt = T(fsig).requires_grad_(True), T(fraws).requires_grad_(True)
    out = tc.composite_rays_compact(st, rt, mr.dt, mr.t, mr.ray_id,
                                    mr.ray_start, mr.valid, 64, THR,
                                    ray_count=mr.ray_count)

    def f(s, r):
        return jc.composite_rays_compact(
            s, r, J(N(mr.dt)), J(N(mr.t)), J(rid), J(N(mr.ray_start)),
            J(v), 64, THR)
    ref = f(J(fsig), J(fraws))
    for k in ("opacity", "depth", "rend", "ws"):
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=2e-5,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_array_equal(N(out["vr_samples"]),
                                  np.asarray(ref["vr_samples"]))
    keys = ("opacity", "depth", "rend", "ws")
    sum((out[k] * T(c)).sum() for k, c in zip(keys, cots)).backward()
    g_sig, g_raws = jax.grad(
        lambda s, r: sum(jnp.sum(f(s, r)[k] * J(c))
                         for k, c in zip(keys, cots)),
        argnums=(0, 1))(J(fsig), J(fraws))
    for got, r in ((st.grad, np.asarray(g_sig)), (rt.grad, np.asarray(g_raws))):
        np.testing.assert_allclose(N(got), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())


@pytest.mark.parametrize("channels", [17, 46, 99])
def test_kernel_wrappers_take_any_channel_count(channels):
    """The wrappers check shapes, types and the device, and no longer the
    channel count: a CPU tensor stops them at the device check."""
    rng = np.random.default_rng(channels)
    n, K = 8, 16
    rows = (T(rng.random((n, K), np.float32)),
            T(rng.random((n, K, channels), np.float32)),
            T(rng.random((n, K), np.float32)),
            T(rng.random((n, K), np.float32)), T(np.ones((n, K), bool)))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tc._check_inputs(*rows)
    flat = (rows[0].reshape(-1), rows[1].reshape(-1, channels),
            rows[2].reshape(-1), rows[3].reshape(-1))
    seg = (T(np.arange(0, n * K, K, dtype=np.int32)),
           T(np.full(n, K, np.int32)))
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        tc._check_compact(*flat, *seg, rows[4].reshape(-1))


def relabel(scene, n_cls=N_CLS):
    """The scene's semantics relabelled into n_cls classes by a fixed
    function of the pixel (chip_smoke.relabel_semantics)."""
    W, H = scene.img_wh
    pix = np.arange(W * H)
    block = (pix // W // 8) * ((W + 7) // 8) + (pix % W) // 8
    sem = scene.labels["semantics"]
    new = 1 + (13 * (sem.astype(np.int64) - 1) + block[None]) % n_cls
    return dataclasses.replace(scene, n_classes=n_cls, labels={
        **scene.labels, "semantics": new.astype(sem.dtype)})


def test_a_40_class_step_matches_jax():
    """One bootstrap step of the slice configuration with 40 semantic
    classes (C 46 through the compositing) against the JAX step: its
    losses (the 40-way cross-entropy among them), counters and
    gradients, each draw handed in from JAX's key splits."""
    jcfg, tcfg = (c.replace(render=dataclasses.replace(c.render,
                                                       bootstrap_steps=16))
                  for c in slice_configs())
    jt = JTrainer(jcfg, relabel(JSyn(split="train", img_wh=(24, 24),
                                     n_images=6).load()))
    jt.mark_invisible_cells()
    occ = jt._occ_update[True](jt.state.occ, jt.state.params,
                               jax.random.PRNGKey(7))
    jt.state = jt.state._replace(occ=occ)
    tt = TTrainer(tcfg, relabel(TSyn(split="train", img_wh=(24, 24),
                                     n_images=6).load()), device="cpu")
    assert tt.model.cfg.n_sem_cls == jt.model.cfg.n_sem_cls == N_CLS
    assert tt.model.cfg.rend_channels == C
    params, occ_t, opt_state = convert_jax_state(
        jax.tree_util.tree_map(np.asarray, jt.state.params),
        jax.tree_util.tree_map(np.asarray, jt.state.occ), tt.opt, CPU)
    tt.load_state(params, occ_t, opt_state, step=int(jt.state.step))
    draws, grads, loss_ref, rm, vr = _jax_draws(jt, jt.state)
    m = tt.train_step_core(bootstrap=True, draws=draws)
    assert float(loss_ref["sem"]) > 0
    for k, v in loss_ref.items():
        np.testing.assert_allclose(float(m[f"loss_{k}"]), float(v),
                                   rtol=1e-4, atol=1e-7, err_msg=f"loss {k}")
    assert round(float(m["rm_samples_per_ray"]) * 96) == rm
    assert round(float(m["vr_samples_per_ray"]) * 96) == vr
    g_ref = _flat_tree(grads["model"])
    for n, g in tt.last_grads.items():
        r = g_ref[n]
        np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"grad {n}")
