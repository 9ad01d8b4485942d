"""Compositing (kernel H3's plain versions) against the JAX package's
`composite_rays`: forward outputs, and the hand-written backward against
`jax.vjp` of the JAX forward and against `composite_reference_grads`,
under random cotangents on all four differentiable outputs (opacity,
depth, rend AND ws, which feeds the distortion loss).

Tolerances: vr_samples exact; f32 outputs rtol 1e-5, atol 1e-6 (prefix
sums accumulated in another order); gradients rtol 1e-4, atol 1e-5
(the closed form multiplies the same terms in another order than
autodiff, over K = 16 suffix sums); the flat layout's forward against
`composite_rays_compact` rtol 2e-5, atol 2e-6 (JAX's global cumsum,
as in tests/test_torch_flat.py).
"""
import jax
import numpy as np
import pytest

import chip_smoke
from test_torch_common import J, N, T

from normal_clustering_nerf_torch.ops import composite as tc
from normal_clustering_nerf_tpu.ops import composite as jc

THR = 1e-4


def _case(seed, n=300, K=16, C=9):
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


def _jax_outputs(sig, raws, dt, ts, valid):
    out = jc.composite_rays(sig, raws, J(dt), J(ts), J(valid), THR)
    return out["opacity"], out["depth"], out["rend"], out["ws"]


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_jax(seed):
    sig, raws, dt, ts, valid, _ = _case(seed)
    ref = jc.composite_rays(J(sig), J(raws), J(dt), J(ts), J(valid), THR)
    out = tc.composite_rays(T(sig), T(raws), T(dt), T(ts), T(valid), THR)
    for k in ("opacity", "depth", "rend", "ws"):
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(N(out["vr_samples"]),
                                  np.asarray(ref["vr_samples"]))
    assert (N(out["vr_samples"]) < valid.sum(1)).any()   # early stops seen
    assert (valid & (sig * dt >= tc.SIGDT_MAX)).any()    # clipped samples


@pytest.mark.parametrize("K", [1, 16, 32, 33, 64, 100])
@pytest.mark.parametrize("seed", [2, 3])
def test_backward_matches_jax_vjp_and_reference_grads(seed, K):
    """At K = 1, 16 and 32, the row lengths for which H3's backward takes
    a ray on a group of 1, 16 and 32 lanes; at K = 33, 64 and 100, rows
    its long kernel takes on a warp in chunks of 32 (two chunks, the
    second of one sample; two; four, the last of 4): 64 is a rank's row
    at four cards under the bench's global budget."""
    sig, raws, dt, ts, valid, cot = _case(seed, K=K)
    assert (valid & (sig * dt >= tc.SIGDT_MAX)).any()    # clip mask used
    _, vjp = jax.vjp(lambda s, r: _jax_outputs(s, r, dt, ts, valid),
                     J(sig), J(raws))
    d_sig_ref, d_raw_ref = vjp(tuple(J(c) for c in cot))
    d_sig_cuda, d_raw_cuda = jc.composite_reference_grads(
        J(sig), J(raws), J(dt), J(ts), J(valid), THR, *(J(c) for c in cot))

    st, rt = T(sig).requires_grad_(True), T(raws).requires_grad_(True)
    out = tc.composite_rays(st, rt, T(dt), T(ts), T(valid), THR)
    loss = sum((out[k] * T(c)).sum()
               for k, c in zip(("opacity", "depth", "rend", "ws"), cot))
    loss.backward()
    for ref, got, name in ((d_sig_ref, st.grad, "d_sigmas vjp"),
                           (d_raw_ref, rt.grad, "d_raws vjp"),
                           (d_sig_cuda, st.grad, "d_sigmas reference"),
                           (d_raw_cuda, rt.grad, "d_raws reference")):
        np.testing.assert_allclose(N(got), np.asarray(ref), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("K", [16, 64, 100])
def test_serial_backward_reference_matches_jax_vjp(K):
    """`chip_smoke.composite_grad_serial`, the order of f32 operations that
    H3's backward keeps at every row length (the lane groups' and the long
    kernel's chunks; the card holds d_sigmas to it bit for bit), against
    `jax.vjp` of the JAX forward, within the tolerance of the backward's
    plain version above."""
    sig, raws, dt, ts, valid, cot = _case(9 + K, K=K)
    _, vjp = jax.vjp(lambda s: _jax_outputs(s, J(raws), dt, ts, valid),
                     J(sig))
    ref = np.asarray(vjp(tuple(J(c) for c in cot))[0])
    got = chip_smoke.composite_grad_serial(
        T(sig), T(raws), T(dt), T(ts), T(valid), THR, *(T(c) for c in cot))
    np.testing.assert_allclose(N(got), ref, rtol=1e-4, atol=1e-5)
    assert (N(got) != 0).any()


@pytest.mark.parametrize("C", [9, 46, 99])
@pytest.mark.parametrize("K", [16, 32])
def test_plain_backward_holds_each_ray_to_the_serial_order(K, C):
    """The backward's plain version against `chip_smoke.composite_grad_serial`
    ray by ray, d_sigmas within 1e-4 of each ray's largest |value| (what
    `chip_smoke.py` holds H3's backward to on a single ray): the sum over
    the samples after s is the next sample's inclusive suffix, as H3 takes
    it. The inclusive suffix less the sample's own term cancels where that
    term dominates (an opaque ray's last included sample) and missed this
    on ~0.5% of the rays."""
    sig, raws, dt, ts, valid, cot = _case(40 + K + C, n=2000, K=K, C=C)
    args = (T(sig), T(raws), T(dt), T(ts), T(valid), THR) + tuple(
        T(c) for c in cot)
    got = tc.composite_grad_plain(*args)[0]
    ref = chip_smoke.composite_grad_serial(*args)
    err = (got - ref).abs().amax(1)
    assert (ref != 0).any()
    assert (err <= 1e-4 * ref.abs().amax(1)).all()


def test_d_raws_is_g_rend_times_forward_ws_bit_for_bit():
    """d_raws = g_rend_c * w_s with w_s the forward's own ws, bit for bit:
    the property `chip_smoke.py` holds H3's backward to against H3's
    forward on the card."""
    sig, raws, dt, ts, valid, cot = _case(7)
    args = (T(sig), T(raws), T(dt), T(ts), T(valid), THR)
    ws = tc.composite_plain(*args)[3]
    _, d_raws = tc.composite_grad_plain(*args, *(T(c) for c in cot))
    assert (N(ws) > 0).any()
    np.testing.assert_array_equal(
        N(d_raws), N(T(cot[2])[:, None, :] * ws[:, :, None]))


def test_ws_cotangent_alone_reaches_sigmas():
    """Dropping the ws gradient would pass every forward test and break
    the distortion loss's training signal."""
    sig, raws, dt, ts, valid, cot = _case(4)
    st = T(sig).requires_grad_(True)
    out = tc.composite_rays(st, T(raws), T(dt), T(ts), T(valid), THR)
    (out["ws"] * T(cot[3])).sum().backward()
    _, vjp = jax.vjp(lambda s: jc.composite_rays(
        s, J(raws), J(dt), J(ts), J(valid), THR)["ws"], J(sig))
    ref = np.asarray(vjp(J(cot[3]))[0])
    assert np.abs(ref).max() > 0
    np.testing.assert_allclose(N(st.grad), ref, rtol=1e-4, atol=1e-5)


# The K are the edges of H3 forward's lanes at C = 9 (a group of 1 lane,
# and groups of 16 taking a row in one chunk, two, two and a sample, and
# four); at C 17, 46 and 99 (past 16 sums) the wide kernel's groups of
# 8-32 lanes owning 2-4 sums a lane in one walk of the row.
T_START_CASES = (
    [pytest.param(k, 9, id=str(k)) for k in (1, 16, 32, 33, 64)]
    + [pytest.param(k, c, id=f"C{c}-K{k}")
       for c in (17, 46, 99) for k in (1, 16, 33, 64)])


@pytest.mark.parametrize("K,C", T_START_CASES)
def test_forward_with_T_start_matches_jax(K, C):
    """Inference rounds continue each ray from its transmittance so far
    (composite.py:60-61), at the test renderer's K up to 64; T_start near
    the threshold makes rays stop on their first sample, and rows made to
    stop on a chunk's edge (`chip_smoke.stop_at_chunk_edges`) stop there.
    The plain version and `chip_smoke.composite_serial`, the serial order
    H3's forward is held to bit for bit on the card, against JAX."""
    sig, raws, dt, ts, valid, _ = _case(6 + K + C - 9, K=K, C=C)
    stops = chip_smoke.stop_at_chunk_edges(sig, valid, K)
    rng = np.random.default_rng(K)
    T_start = rng.uniform(0.0, 1.0, sig.shape[0]).astype(np.float32)
    T_start[:20] = rng.uniform(THR, 3 * THR, 20)
    ref = jc.composite_rays(J(sig), J(raws), J(dt), J(ts), J(valid), THR,
                            T_start=J(T_start))
    out = tc.composite_rays(T(sig), T(raws), T(dt), T(ts), T(valid), THR,
                            T_start=T(T_start))
    ser = dict(zip(("opacity", "depth", "rend", "ws", "vr_samples"),
                   chip_smoke.composite_serial(T(sig), T(raws), T(dt), T(ts),
                                               T(valid), THR, T(T_start))))
    for got in (out, ser):
        for k in ("opacity", "depth", "rend", "ws"):
            np.testing.assert_allclose(N(got[k]), np.asarray(ref[k]),
                                       rtol=1e-5, atol=1e-6, err_msg=k)
        np.testing.assert_array_equal(N(got["vr_samples"]),
                                      np.asarray(ref["vr_samples"]))
    vr = N(out["vr_samples"])
    assert all(vr[n] <= e for n, e in stops.items())
    assert (vr[list(stops)] == list(stops.values())).any()
    assert (N(out["opacity"]) <= T_start + 1e-5).all()   # f32 sums of 64 terms
    with pytest.raises(NotImplementedError):
        tc.composite_rays(T(sig).requires_grad_(True), T(raws), T(dt),
                          T(ts), T(valid), THR, T_start=T(T_start))


@pytest.mark.parametrize("with_t_start", [False, True])
def test_segment_forward_on_every_length_matches_jax(with_t_start):
    """The flat layout's forward (the plain version of H3's segment
    launcher) on segments of every length 0..64, in shuffled order: the
    lengths a flat test round gives it (test_n_samples = 64), which the
    launcher takes on a warp in chunks of 32. Against
    `composite_rays_compact`, eager (`jax.disable_jit()`), within the
    tolerance of tests/test_torch_flat.py: the batch's sigma*delta sums
    to ~60, where JAX's global cumsum minus the segment base stays inside
    it. A tenth of the segments' slots are invalid, 7 padding slots
    follow the last segment."""
    count, start, ray_id, valid, dt, ts, sig, raws, rng = _segments(11, 64)
    n = count.shape[0]
    t_start = None
    if with_t_start:
        t_start = rng.random(n).astype(np.float32)
        t_start[::5] = THR * 1.5   # rays that enter just above the threshold
    with jax.disable_jit():
        ref = jc.composite_rays_compact(
            J(sig), J(raws), J(dt), J(ts), J(ray_id), J(start), J(valid), n,
            THR, T_start=None if t_start is None else J(t_start))
    out = tc.composite_rays_compact(
        T(sig), T(raws), T(dt), T(ts), T(ray_id), T(start), T(valid), n, THR,
        T_start=None if t_start is None else T(t_start), ray_count=T(count))
    for k in ("opacity", "depth", "rend", "ws"):
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]), rtol=2e-5,
                                   atol=2e-6, err_msg=k)
    np.testing.assert_array_equal(N(out["vr_samples"]),
                                  np.asarray(ref["vr_samples"]))
    n_valid = np.bincount(ray_id[valid], minlength=n)
    assert (N(out["vr_samples"]) > 32).any()   # two chunks' worth kept
    if with_t_start:   # rays entering near T_threshold end early
        assert (N(out["vr_samples"]) < n_valid).any()


def _segments(seed, longest):
    """Flat composite inputs on segments of every length 0..longest in
    shuffled order, a tenth of the slots invalid, 7 padding slots after
    the last segment: (count, start, ray_id, valid, dt, ts, sig, raws)."""
    rng = np.random.default_rng(seed)
    count = rng.permutation(longest + 1).astype(np.int32)
    n, used_slots = count.shape[0], int(count.sum())
    start = (np.cumsum(count) - count).astype(np.int32)
    B = used_slots + 7
    ray_id = np.full(B, n - 1, np.int32)
    ray_id[:used_slots] = np.repeat(np.arange(n), count)
    valid = (np.arange(B) < used_slots) & (rng.random(B) >= 0.1)
    dt = rng.uniform(0.002, 0.02, B).astype(np.float32)
    ts = np.cumsum(dt).astype(np.float32)
    sig = (8.0 * rng.random(B) ** 2).astype(np.float32)
    raws = rng.standard_normal((B, 9)).astype(np.float32)
    return count, start, ray_id, valid, dt, ts, sig, raws, rng


def test_segment_backward_on_every_length_matches_jax():
    """The flat layout's backward (the plain version of H3's segment
    launcher, which past 32 samples takes a segment on a warp in chunks)
    on segments of every length 0..64 against `jax.grad` of
    `composite_rays_compact`, eager, under random cotangents on opacity,
    depth, rend and ws: within the tolerance of tests/test_torch_flat.py
    (rtol 1e-4, atol 1e-5 of the largest entry: JAX's global cumsum and
    autodiff against the written-out backward); zero outside every
    valid slot."""
    count, start, ray_id, valid, dt, ts, sig, raws, rng = _segments(12, 64)
    n, B = count.shape[0], sig.shape[0]
    cot = (rng.standard_normal(n).astype(np.float32),
           rng.standard_normal(n).astype(np.float32),
           rng.standard_normal((n, 9)).astype(np.float32),
           rng.standard_normal(B).astype(np.float32))
    st, rt = T(sig).requires_grad_(True), T(raws).requires_grad_(True)
    out = tc.composite_rays_compact(st, rt, T(dt), T(ts), T(ray_id),
                                    T(start), T(valid), n, THR,
                                    ray_count=T(count), max_len=64)
    sum((out[k] * T(c)).sum() for k, c in
        zip(("opacity", "depth", "rend", "ws"), cot)).backward()

    def f(sg, rw):
        o = jc.composite_rays_compact(sg, rw, J(dt), J(ts), J(ray_id),
                                      J(start), J(valid), n, THR)
        return sum(jax.numpy.sum(o[k] * J(c)) for k, c in
                   zip(("opacity", "depth", "rend", "ws"), cot))
    with jax.disable_jit():
        g_sig, g_raws = jax.grad(f, argnums=(0, 1))(J(sig), J(raws))
    for got, ref in ((st.grad, g_sig), (rt.grad, g_raws)):
        r = np.asarray(ref)
        np.testing.assert_allclose(N(got), r, rtol=1e-4,
                                   atol=1e-5 * np.abs(r).max())
    assert not N(st.grad)[~valid].any() and not N(rt.grad)[~valid].any()
    n_valid = np.bincount(ray_id[valid], minlength=n)
    assert (n_valid > 32).any()   # segments of two chunks
