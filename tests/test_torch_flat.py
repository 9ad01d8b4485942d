"""The flat ray-major layout's compositing and distortion loss (the plain
versions of H3's and H4's segment launchers) and `segment_cumsum`,
against the JAX package's `composite_rays_compact`, `distortion_loss`,
`segment_cumsum` and the reference-formula gradient oracles, and against
the port's own dense layout on the same samples.

Tolerances:
  * against JAX: rtol 2e-5, atol 2e-6 (values) and rtol 1e-4 with atol
    1e-5 of the largest entry (gradients). The JAX flat path takes each
    ray's prefix sums as one global f32 cumsum over the whole budget minus
    the sum before the ray's segment; the port sums each segment on its
    own, as the dense layout does, so the two differ by the global sum's
    rounding (JAX's own flat-vs-dense test holds rtol 2e-5,
    tests/test_render_parity.py:55-58);
  * the port's flat layout against its dense layout on the same samples:
    exact, values and gradients;
  * gradients against `composite_reference_grads` /
    `distortion_reference_grad`: rtol 1e-4, atol 1e-5 of the largest
    entry (closed form against the written-out backward).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import J, N, T

from normal_clustering_nerf_torch.ops import composite as tc
from normal_clustering_nerf_torch.ops import distortion as td
from normal_clustering_nerf_torch.ops import segops as ts
from normal_clustering_nerf_torch.ops.ray_march import compact_samples
from normal_clustering_nerf_tpu.ops import composite as jc
from normal_clustering_nerf_tpu.ops import distortion as jd
from normal_clustering_nerf_tpu.ops import segops as js

NR, K, C, THR = 64, 16, 9, 1e-4


def _dense(seed, sig_scale=30.0):
    """(N, K) samples as the dense march leaves them: a valid prefix of
    each row (ray 0 full, ray 1 empty), t ascending, zeros past the
    prefix. sig_scale sets how many rays end early: at 30 the batch's
    sigma * delta sums to ~60, which keeps the JAX global cumsum's
    rounding inside the stated tolerance; at 300 most rays end early."""
    rng = np.random.default_rng(seed)
    count = rng.integers(0, K + 1, NR)
    count[0], count[1] = K, 0
    valid = np.arange(K)[None, :] < count[:, None]
    dt = rng.uniform(0.002, 0.02, (NR, K)).astype(np.float32)
    t = (0.05 + np.cumsum(dt, 1)).astype(np.float32)
    sig = (sig_scale * rng.random((NR, K)) ** 2).astype(np.float32)
    raws = rng.standard_normal((NR, K, C)).astype(np.float32)
    z = ~valid
    t[z], dt[z] = 0.0, 0.0
    return dict(sig=sig, raws=raws, dt=dt, t=t, valid=valid, rng=rng)


def _flat(s):
    """The same samples compacted ray-major into a budget with padding."""
    mr = compact_samples(T(s["valid"]), T(s["t"]), T(s["dt"]),
                         int(s["valid"].sum()) + 40)
    pos = N(ts.segment_slots(mr.ray_id, mr.ray_start))
    rid, v = N(mr.ray_id), N(mr.valid)
    src = lambda a: np.where(v.reshape((-1,) + (1,) * (a.ndim - 2)),
                             a[rid, np.clip(pos, 0, K - 1)], 0)
    return mr, src(s["sig"]), src(s["raws"])


def test_segment_cumsum_matches_jax():
    s = _dense(0)
    mr, _, raws = _flat(s)
    x = raws[:, 0] * N(mr.valid)
    ref = js.segment_cumsum(J(x), J(N(mr.ray_id)), J(N(mr.ray_start)))
    out = ts.segment_cumsum(T(x), mr.ray_id, mr.ray_start)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(N(o), np.asarray(r), rtol=2e-5, atol=2e-6)
    # per segment: each equals the dense row's own cumsum
    dense = torch.cumsum(T(s["raws"][..., 0] * s["valid"]), 1)
    v = mr.valid
    pos = ts.segment_slots(mr.ray_id, mr.ray_start)
    np.testing.assert_array_equal(
        N(out[0][v]), N(dense[mr.ray_id[v].long(), pos[v]]))


@pytest.mark.parametrize("with_t_start", [False, True])
def test_composite_compact_matches_jax(with_t_start):
    s = _dense(1)
    mr, sig, raws = _flat(s)
    t_start = (s["rng"].random(NR).astype(np.float32) if with_t_start
               else None)
    if with_t_start:
        t_start[::5] = THR * 1.5   # rays that enter just above the threshold
    args_j = (J(sig), J(raws), J(N(mr.dt)), J(N(mr.t)), J(N(mr.ray_id)),
              J(N(mr.ray_start)), J(N(mr.valid)), NR, THR)
    ref = jc.composite_rays_compact(
        *args_j, T_start=None if t_start is None else J(t_start))
    out = tc.composite_rays_compact(
        T(sig), T(raws), mr.dt, mr.t, mr.ray_id, mr.ray_start, mr.valid, NR,
        THR, T_start=None if t_start is None else T(t_start),
        ray_count=mr.ray_count)
    for k in ("opacity", "depth", "rend", "ws"):
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=2e-5,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_array_equal(N(out["vr_samples"]),
                                  np.asarray(ref["vr_samples"]))
    assert (N(out["opacity"]) > 0).any()
    if with_t_start:   # rays entering near T_threshold end early
        assert (N(out["vr_samples"]) < N(mr.ray_count)).any()


def _cotangents(rng, B):
    return (rng.standard_normal(NR).astype(np.float32),
            rng.standard_normal(NR).astype(np.float32),
            rng.standard_normal((NR, C)).astype(np.float32),
            rng.standard_normal(B).astype(np.float32))


def test_composite_compact_grads_match_jax_and_the_oracle():
    s = _dense(2)
    mr, sig, raws = _flat(s)
    cot = _cotangents(s["rng"], sig.shape[0])
    ts_, st = T(sig).requires_grad_(), T(raws).requires_grad_()
    out = tc.composite_rays_compact(ts_, st, mr.dt, mr.t, mr.ray_id,
                                    mr.ray_start, mr.valid, NR, THR,
                                    ray_count=mr.ray_count)
    sum((out[k] * T(c)).sum() for k, c in
        zip(("opacity", "depth", "rend", "ws"), cot)).backward()

    def f(sg, rw):
        o = jc.composite_rays_compact(
            sg, rw, J(N(mr.dt)), J(N(mr.t)), J(N(mr.ray_id)),
            J(N(mr.ray_start)), J(N(mr.valid)), NR, THR)
        return sum(jnp.sum(o[k] * J(c)) for k, c in
                   zip(("opacity", "depth", "rend", "ws"), cot))
    g_sig, g_raws = jax.grad(f, argnums=(0, 1))(J(sig), J(raws))
    for got, ref in ((ts_.grad, g_sig), (st.grad, g_raws)):
        r = np.asarray(ref)
        np.testing.assert_allclose(N(got), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
    # the oracle: the reference's backward formula on the dense layout,
    # its cotangent of ws laid out densely
    g_ws_dense = np.zeros((NR, K), np.float32)
    v, rid = N(mr.valid), N(mr.ray_id)
    pos = N(ts.segment_slots(mr.ray_id, mr.ray_start))
    g_ws_dense[rid[v], pos[v]] = cot[3][v]
    o_sig, o_raws = jc.composite_reference_grads(
        J(s["sig"]), J(s["raws"]), J(s["dt"]), J(s["t"]), J(s["valid"]),
        THR, J(cot[0]), J(cot[1]), J(cot[2]), J(g_ws_dense))
    o_sig, o_raws = np.asarray(o_sig), np.asarray(o_raws)
    np.testing.assert_allclose(N(ts_.grad)[v], o_sig[rid[v], pos[v]],
                               rtol=1e-4, atol=1e-5 * np.abs(o_sig).max())
    np.testing.assert_allclose(N(st.grad)[v], o_raws[rid[v], pos[v]],
                               rtol=1e-4, atol=1e-5 * np.abs(o_raws).max())
    assert not N(ts_.grad)[~v].any() and not N(st.grad)[~v].any()


def test_distortion_compact_matches_jax_and_the_oracle():
    s = _dense(3)
    mr, _, _ = _flat(s)
    rng = s["rng"]
    # weights as compositing leaves them: each ray's sum at most 1
    ws = (rng.random(mr.t.shape[0]) * N(mr.valid) / K).astype(np.float32)
    g = rng.standard_normal(NR).astype(np.float32)
    wt = T(ws).requires_grad_()
    out = td.distortion_loss(wt, mr.dt, mr.t, mr.ray_id, mr.ray_start,
                             mr.valid, NR, ray_count=mr.ray_count)
    (out * T(g)).sum().backward()
    args_j = (J(N(mr.dt)), J(N(mr.t)), J(N(mr.ray_id)), J(N(mr.ray_start)),
              J(N(mr.valid)), NR)
    ref = jd.distortion_loss(J(ws), *args_j)
    np.testing.assert_allclose(N(out), np.asarray(ref), rtol=2e-5, atol=2e-6)
    g_ref = np.asarray(jax.grad(lambda w: jnp.sum(
        jd.distortion_loss(w, *args_j) * J(g)))(J(ws)))
    g_orc = np.asarray(jd.distortion_reference_grad(
        J(g), J(ws), J(N(mr.dt)), J(N(mr.t)), J(N(mr.ray_id)),
        J(N(mr.ray_start)), J(N(mr.valid)), NR))
    for r in (g_ref, g_orc):
        np.testing.assert_allclose(N(wt.grad), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
    assert (N(out) > 0).any()


@pytest.mark.parametrize("sig_scale", [300.0, 30000.0])
def test_flat_equals_dense_on_the_same_samples(sig_scale):
    """Composite (forward, with and without T_start, and backward) and
    distortion (forward and backward) of the flat layout give the dense
    layout's bits on the same samples; 3000 clips sigma * delta at 80."""
    s = _dense(4, sig_scale)
    mr, sig, raws = _flat(s)
    v, rid = mr.valid, mr.ray_id.long()
    pos = ts.segment_slots(mr.ray_id, mr.ray_start)
    cot = _cotangents(s["rng"], sig.shape[0])
    g_ws_dense = torch.zeros((NR, K))
    g_ws_dense[rid[v], pos[v]] = T(cot[3])[v]

    def run(flat, t_start=None):
        sg = T(sig if flat else s["sig"]).requires_grad_(t_start is None)
        rw = T(raws if flat else s["raws"]).requires_grad_(t_start is None)
        if flat:
            o = tc.composite_rays_compact(
                sg, rw, mr.dt, mr.t, mr.ray_id, mr.ray_start, mr.valid, NR,
                THR, T_start=t_start, ray_count=mr.ray_count)
            dl = td.distortion_loss(o["ws"], mr.dt, mr.t, mr.ray_id,
                                    mr.ray_start, mr.valid, NR,
                                    ray_count=mr.ray_count)
            g_ws = T(cot[3])
        else:
            o = tc.composite_rays(sg, rw, T(s["dt"]), T(s["t"]),
                                  T(s["valid"]), THR, T_start=t_start)
            dl = td.distortion_loss_dense(o["ws"], T(s["dt"]), T(s["t"]),
                                          T(s["valid"]))
            g_ws = g_ws_dense
        if t_start is not None:
            return o, None, None
        (sum((o[k] * T(c)).sum() for k, c in
             zip(("opacity", "depth", "rend"), cot[:3]))
         + (o["ws"] * g_ws).sum() + dl.sum()).backward()
        return dict(o, dl=dl), sg.grad, rw.grad

    (fo, fg_s, fg_r), (do, dg_s, dg_r) = run(True), run(False)
    for k in ("opacity", "depth", "rend", "vr_samples", "dl"):
        np.testing.assert_array_equal(N(fo[k]), N(do[k]), err_msg=k)
    np.testing.assert_array_equal(N(fo["ws"])[N(v)],
                                  N(do["ws"])[N(rid[v]), N(pos[v])])
    np.testing.assert_array_equal(N(fg_s)[N(v)], N(dg_s)[N(rid[v]), N(pos[v])])
    np.testing.assert_array_equal(N(fg_r)[N(v)], N(dg_r)[N(rid[v]), N(pos[v])])
    t_start = T(s["rng"].random(NR).astype(np.float32))
    (fo, _, _), (do, _, _) = run(True, t_start), run(False, t_start)
    for k in ("opacity", "depth", "rend", "vr_samples"):
        np.testing.assert_array_equal(N(fo[k]), N(do[k]), err_msg=k)
    assert (N(fo["vr_samples"]) < N(mr.ray_count)).any()
    if sig_scale > 1000:
        assert (s["sig"] * s["dt"] * s["valid"] >= 80).any()
