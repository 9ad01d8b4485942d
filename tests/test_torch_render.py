"""Rendering of the port against the JAX package's `models/rendering.py`:
the branches of `render_train` (values and gradients, the march noise and
background handed in): the supervoxel-run ("sv") march, the bitfield
march over march_block steps with and without the two-level coarse mask,
and the flat layout; and `render_test`: bucket rounds with the sv march
or the bitfield window, and the flat layout. All on a triplane field
whose JAX parameters are carried across by `convert.py`.

Tolerances:
  * render_train: the march's outputs (ts, deltas, sample_valid,
    ray_count, rm_samples, trunc_rays) and vr_samples exact; the
    composited outputs rtol 1e-5, atol 1e-6 (the field's tolerance,
    tests/test_torch_model.py); gradients rtol 1e-4 with atol 1e-5 of
    the parameter's largest gradient (the field's sums in another order,
    then compositing's closed-form backward, tests/test_torch_composite.py);
  * the flat branch: the composited outputs rtol 2e-5, atol 2e-6, the
    tolerance of JAX's own flat-vs-dense test
    (tests/test_render_parity.py:55-58): JAX's flat prefix sums are one
    global cumsum minus each segment's base, the port's are per segment;
  * render_test: rtol 2e-4, atol 2e-5 and total_samples equal: the
    tolerance the JAX suite holds between two schedules of the same
    render (tests/test_render_test_bucket.py:58-67). Each round continues
    the composite from the transmittance so far, so the prefix sums of a
    ray are cut at other places than in one pass.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, J, N, T

from normal_clustering_nerf_torch.config import ModelConfig as TMC
from normal_clustering_nerf_torch.config import RenderConfig as TRC
from normal_clustering_nerf_torch.convert import convert_params
from normal_clustering_nerf_torch.models import rendering as tr
from normal_clustering_nerf_torch.models.ngp_mt import NGPMT as TModel
from normal_clustering_nerf_torch.models.occupancy import OccupancyGrid
from normal_clustering_nerf_tpu.config import ModelConfig as JMC
from normal_clustering_nerf_tpu.config import RenderConfig as JRC
from normal_clustering_nerf_tpu.models import rendering as jr
from normal_clustering_nerf_tpu.models.ngp_mt import NGPMT as JModel
from normal_clustering_nerf_tpu.models.occupancy import (
    coarse_occupancy, supervoxel_tables,
)
from normal_clustering_nerf_tpu.ops.packbits import packbits


def _models(table_scale, **model_kw):
    """The JAX field and its port copy. table_scale > 0 moves the tables
    away from their tiny init so that rays end early; 0 keeps the init
    (a nearly transparent field: every ray runs to its far end)."""
    kw = dict(scale=0.5, pred_norm_nn=True, pred_sem=True, n_sem_cls=3,
              hash_layout="triplane", plane_res=32, grid3d_res=16)
    kw.update(model_kw)
    jm = JModel(JMC(**kw))
    params = jm.init(jax.random.PRNGKey(0))
    if table_scale:
        params["hash_table"] = jax.tree_util.tree_map(
            lambda p: table_scale * jax.random.normal(jax.random.PRNGKey(1),
                                                      p.shape),
            params["hash_table"])
    tm = TModel(TMC(**kw), CPU)
    tm.load_state_dict(convert_params(
        jax.tree_util.tree_map(np.asarray, params), CPU))
    return jm, params, tm


def _occupancy(rng, G, p_empty):
    """Random cells with a solid block (the JAX suite's setup,
    tests/test_render_test_bucket.py:33-36): the bitfield, its sv tables,
    and the port's state holding them."""
    occ = rng.random((G, G, G)) > p_empty
    occ[G // 3:2 * G // 3, G // 3:2 * G // 3, G // 3:2 * G // 3] = True
    flat = occ.transpose(2, 1, 0).reshape(-1)
    bitfield = packbits(jnp.asarray(flat.astype(np.float32)), 0.5)
    mask, payload = supervoxel_tables(bitfield, G)
    state = OccupancyGrid(TMC(grid_size=G), CPU).init_state()._replace(
        density_bitfield=T(bitfield), sv_mask=T(mask), sv_payload=T(payload),
        coarse_occ=T(coarse_occupancy(bitfield, G)))
    return bitfield, mask, payload, state


def _rays(rng, n, lo=-1.2, hi=1.2):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _train_case(seed, global_step, rkw, *, use_sv=True, coarse=False):
    """The bench's budget (16 samples, full stratified tail) at G 32 and
    1024 steps: the JAX and the port's render_train on the same rays,
    noise, background and cotangents. use_sv=False drops the sv tables (a
    JAX call without them, a port state whose sv_mask is None); coarse
    hands the JAX call the coarse mask, as the trainer does."""
    G, n = 32, 120
    jm, params, tm = _models(0.5, grid_size=G, max_samples=1024)
    rng = np.random.default_rng(seed)
    bitfield, mask, payload, state = _occupancy(rng, G, 0.7)
    if not use_sv:
        mask = payload = None
        state = state._replace(sv_mask=None, sv_payload=None)
    o, d = _rays(rng, n, -0.45, 0.45)
    rkw = dict(dict(march_block=1024, sample_budget=16 * n,
                    anneal_strategy="avoid_near", anneal_steps=600), **rkw)
    key = jax.random.PRNGKey(3)
    k_noise, k_bg = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    bg = np.asarray(jax.random.uniform(k_bg, (3,)))
    flat = rkw.get("march_layout") == "flat"
    cot = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("rgb", (n, 3)), ("depth", (n,)), ("opacity", (n,)),
        ("norm_nn", (n, 3)), ("sem", (n, 3)),
        ("ws", (16 * n,) if flat else (n, 16)))}

    def loss_j(p):
        res = jr.render_train(jm, p, bitfield, J(o), J(d), key,
                              JRC(**rkw), global_step=global_step,
                              coarse_occ=(coarse_occupancy(bitfield, G)
                                          if coarse else None),
                              sv_mask=mask, sv_payload=payload,
                              bootstrap=False)
        return sum(jnp.sum(res[k] * J(c)) for k, c in cot.items()), res

    # eagerly: under jit XLA contracts the march's t0 + k*lo into an FMA,
    # which moves boundary samples by an ulp (JAX against itself)
    (_, ref), grads = jax.value_and_grad(loss_j, has_aux=True)(params)
    out = tr.render_train(tm, state, T(o), T(d), TRC(**rkw),
                          global_step=global_step, bootstrap=False,
                          noise=T(noise), bg=T(bg))
    sum((out[k] * T(c)).sum() for k, c in cot.items()).backward()
    exact = ["ts", "deltas", "sample_valid", "ray_count", "rm_samples",
             "trunc_rays", "vr_samples"]
    if flat:
        exact += ["ray_id", "ray_start"]
    for k in exact:
        np.testing.assert_array_equal(N(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    rtol, atol = (2e-5, 2e-6) if flat else (1e-5, 1e-6)
    for k in cot:
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
    assert int(out["rm_samples"]) > 4 * n
    g_ref = _flat(grads)
    for name, p in tm.named_parameters():
        r = g_ref[name]
        np.testing.assert_allclose(N(p.grad), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)
    return out


@pytest.mark.parametrize("sv_intervals,global_step", [(24, 700), (3, 300)])
def test_render_train_sv_branch_matches_jax(sv_intervals, global_step):
    """The sv march; 3 intervals truncate rays and step 300 anneals the
    near end."""
    out = _train_case(sv_intervals, global_step,
                      dict(sv_intervals=sv_intervals))
    if sv_intervals == 3:
        assert int(out["trunc_rays"]) > 0


@pytest.mark.parametrize("rkw,use_sv,coarse", [
    (dict(march_coarse=False), True, False),
    # the two-level march: coarse mask, no sv tables; 5 candidate blocks
    # of 4 steps truncate rays
    (dict(coarse_k_blocks=5), False, True),
])
def test_render_train_fine_branch_matches_jax(rkw, use_sv, coarse):
    """The bitfield march over march_block steps (rendering.py:186-196)."""
    out = _train_case(24, 700, rkw, use_sv=use_sv, coarse=coarse)
    assert (int(out["trunc_rays"]) > 0) == coarse


def test_render_train_flat_branch_matches_jax():
    """The flat layout (rendering.py:233-277): the march compacted into
    16 * n slots from step 0, segments composited."""
    out = _train_case(5, 700, dict(march_layout="flat"))
    assert out["ws"].shape == (16 * 120,) and int(out["trunc_rays"]) == 0


def _render_both(n_rays, table_scale, seed=0, disable_jit=False, **rkw):
    G = 16
    jm, params, tm = _models(table_scale, grid_size=G, max_samples=128)
    rng = np.random.default_rng(seed)
    bitfield, mask, payload, state = _occupancy(rng, G, 0.6)
    o, d = _rays(rng, n_rays)
    rc = dict(test_layout="bucket", test_march_window=32, test_n_samples=16)
    rc.update(rkw)
    with jax.disable_jit(disable_jit):
        ref = jr.render_test(jm, params, bitfield, J(o), J(d), JRC(**rc),
                             sv_mask=mask, sv_payload=payload)
    with torch.no_grad():
        out = tr.render_test(tm, state, T(o), T(d), TRC(**rc))
    return out, ref


def _assert_render_close(out, ref):
    for k in ("rgb", "opacity", "depth", "norm_nn", "sem"):
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    assert out["total_samples"] == int(ref["total_samples"]) > 0


@pytest.mark.parametrize("n_rays,table_scale", [(37, 8.0), (37, 0.0),
                                                (600, 0.0)])
def test_render_test_matches_jax(n_rays, table_scale):
    """37 rays: one bucket rung, so both renderers run the same rounds
    (K = 64 each) and rays end early in the field with moved tables.
    600 rays: the rungs 256, 512 and 600; the port picks its rung from the
    fresh alive count and the JAX version from stale ones, so the two
    schedules differ, and on the nearly transparent field every ray runs
    to its far end in both (the samples are the same set)."""
    out, ref = _render_both(n_rays, table_scale)
    _assert_render_close(out, ref)
    op = N(out["opacity"])
    if table_scale:
        assert ((op > 1 - 2e-4) & (op < 1)).any()   # rays ended early
    if n_rays > 256:
        assert out["rounds"] >= 2


@pytest.mark.parametrize("table_scale", [8.0, 0.0])
def test_render_test_bucket_window_matches_jax(table_scale):
    """Bucket rounds without the sv march (rendering.py:331-353): K
    clamped to the 32-step window, the cursor just past the K-th
    occupied step."""
    out, ref = _render_both(37, table_scale, march_coarse=False)
    _assert_render_close(out, ref)
    assert out["rounds"] >= 2


@pytest.mark.parametrize("table_scale", [8.0, 0.0])
def test_render_test_flat_matches_jax(table_scale):
    """Flat rounds (rendering.py:742-768) of 16 steps, the JAX rounds
    run eagerly (its round function is jitted, where XLA contracts the
    step grid into FMAs)."""
    out, ref = _render_both(37, table_scale, disable_jit=True,
                            test_layout="flat")
    _assert_render_close(out, ref)
    assert out["rounds"] >= 2


def test_render_test_refuses_unported_layouts():
    """A scene past scale 0.5 (2 cascades, the geometric step grid), once
    refused, renders through the bitfield rounds of both layouts: finite
    outputs, samples taken, rays ended (tests/test_torch_cascades.py holds
    both against JAX)."""
    _, _, tm = _models(8.0, grid_size=16, max_samples=128, scale=1.0)
    assert tm.cfg.cascades == 2
    rng = np.random.default_rng(1)
    bits = np.packbits(rng.random(2 * 16 ** 3) > 0.6, bitorder="little")
    state = OccupancyGrid(TMC(grid_size=16, scale=1.0), CPU).init_state()
    state = state._replace(density_bitfield=T(bits))
    o, d = _rays(rng, 8)
    for rc in (TRC(test_layout="flat"), TRC(march_coarse=False)):
        with torch.no_grad():
            out = tr.render_test(tm, state, T(o), T(d), rc)
        for k in ("rgb", "opacity", "depth"):
            assert np.isfinite(N(out[k])).all(), k
        assert out["total_samples"] > 0 and out["rounds"] > 0


def test_bucket_ladder_matches_jax():
    for N_, min_k in ((37, 32), (600, 32), (65536, 32), (5000, 1)):
        assert tr.bucket_ladder(N_, min_k) == \
            jr._bucket_ladder_BK(N_, min_k, 128, True)
        for S_march in (16, 128):
            assert tr.bucket_ladder(N_, min_k, S_march) == \
                jr._bucket_ladder_BK(N_, min_k, S_march, False)
