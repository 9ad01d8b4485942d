"""Rendering of the port against the JAX package's `models/rendering.py`:
the supervoxel-run ("sv") branch of `render_train` (values and gradients,
the march noise and background handed in) and the bucket test renderer
`render_test` with sv rounds, both on a triplane field whose JAX
parameters are carried across by `convert.py`.

Tolerances:
  * render_train: the march's outputs (ts, deltas, sample_valid,
    ray_count, rm_samples, trunc_rays) and vr_samples exact; the
    composited outputs rtol 1e-5, atol 1e-6 (the field's tolerance,
    tests/test_torch_model.py); gradients rtol 1e-4 with atol 1e-5 of
    the parameter's largest gradient (the field's sums in another order,
    then compositing's closed-form backward, tests/test_torch_composite.py);
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
from normal_clustering_nerf_tpu.models.occupancy import supervoxel_tables
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
        density_bitfield=T(bitfield), sv_mask=T(mask), sv_payload=T(payload))
    return bitfield, mask, payload, state


def _rays(rng, n, lo=-1.2, hi=1.2):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("sv_intervals,global_step", [(24, 700), (3, 300)])
def test_render_train_sv_branch_matches_jax(sv_intervals, global_step):
    """The bench's budget (16 samples, full stratified tail) over the sv
    march; 3 intervals truncate rays and step 300 anneals the near end."""
    G, n = 32, 120
    jm, params, tm = _models(0.5, grid_size=G, max_samples=1024)
    rng = np.random.default_rng(sv_intervals)
    bitfield, mask, payload, state = _occupancy(rng, G, 0.7)
    o, d = _rays(rng, n, -0.45, 0.45)
    rkw = dict(march_block=1024, sample_budget=16 * n,
               sv_intervals=sv_intervals, anneal_strategy="avoid_near",
               anneal_steps=600)
    key = jax.random.PRNGKey(3)
    k_noise, k_bg = jax.random.split(key)
    noise = np.asarray(jax.random.uniform(k_noise, (n,)))
    bg = np.asarray(jax.random.uniform(k_bg, (3,)))
    cot = {k: rng.standard_normal(s).astype(np.float32) for k, s in (
        ("rgb", (n, 3)), ("depth", (n,)), ("opacity", (n,)),
        ("norm_nn", (n, 3)), ("sem", (n, 3)), ("ws", (n, 16)))}

    def loss_j(p):
        res = jr.render_train(jm, p, bitfield, J(o), J(d), key,
                              JRC(**rkw), global_step=global_step,
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

    for k in ("ts", "deltas", "sample_valid", "ray_count", "rm_samples",
              "trunc_rays", "vr_samples"):
        np.testing.assert_array_equal(N(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in cot:
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if sv_intervals == 3:
        assert int(out["trunc_rays"]) > 0
    assert int(out["rm_samples"]) > 4 * n
    g_ref = _flat(grads)
    for name, p in tm.named_parameters():
        r = g_ref[name]
        np.testing.assert_allclose(N(p.grad), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max(), err_msg=name)


def _render_both(n_rays, table_scale, seed=0, **rkw):
    G = 16
    jm, params, tm = _models(table_scale, grid_size=G, max_samples=128)
    rng = np.random.default_rng(seed)
    bitfield, mask, payload, state = _occupancy(rng, G, 0.6)
    o, d = _rays(rng, n_rays)
    rc = dict(test_layout="bucket", test_march_window=32, test_n_samples=16)
    rc.update(rkw)
    ref = jr.render_test(jm, params, bitfield, J(o), J(d), JRC(**rc),
                         sv_mask=mask, sv_payload=payload)
    with torch.no_grad():
        out = tr.render_test(tm, state, T(o), T(d), TRC(**rc))
    return out, ref


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
    for k in ("rgb", "opacity", "depth", "norm_nn", "sem"):
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)
    assert out["total_samples"] == int(ref["total_samples"]) > 0
    op = N(out["opacity"])
    if table_scale:
        assert ((op > 1 - 2e-4) & (op < 1)).any()   # rays ended early
    if n_rays > 256:
        assert out["rounds"] >= 2


def test_render_test_refuses_unported_layouts():
    """The flat layout (A13) and rounds without the sv march (K13)."""
    _, _, tm = _models(0.0, grid_size=16, max_samples=128)
    rng = np.random.default_rng(1)
    *_, state = _occupancy(rng, 16, 0.6)
    o, d = _rays(rng, 8)
    for rc in (TRC(test_layout="flat"), TRC(march_coarse=False)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tr.render_test(tm, state, T(o), T(d), rc)


def test_bucket_ladder_matches_jax():
    for N_, min_k in ((37, 32), (600, 32), (65536, 32), (5000, 1)):
        assert tr.bucket_ladder(N_, min_k) == \
            jr._bucket_ladder_BK(N_, min_k, 128, True)
