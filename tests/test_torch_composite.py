"""Compositing (kernel H3's plain versions) against the JAX package's
`composite_rays`: forward outputs, and the hand-written backward against
`jax.vjp` of the JAX forward and against `composite_reference_grads`,
under random cotangents on all four differentiable outputs (opacity,
depth, rend AND ws, which feeds the distortion loss).

Tolerances: vr_samples exact; f32 outputs rtol 1e-5, atol 1e-6 (prefix
sums accumulated in another order); gradients rtol 1e-4, atol 1e-5
(the closed form multiplies the same terms in another order than
autodiff, over K = 16 suffix sums).
"""
import jax
import numpy as np
import pytest

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


@pytest.mark.parametrize("seed", [2, 3])
def test_backward_matches_jax_vjp_and_reference_grads(seed):
    sig, raws, dt, ts, valid, cot = _case(seed)
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


@pytest.mark.parametrize("K", [16, 64])
def test_forward_with_T_start_matches_jax(K):
    """Inference rounds continue each ray from its transmittance so far
    (composite.py:60-61), at the test renderer's K up to 64; T_start near
    the threshold makes rays stop on their first sample."""
    sig, raws, dt, ts, valid, _ = _case(6 + K, K=K)
    rng = np.random.default_rng(K)
    T_start = rng.uniform(0.0, 1.0, sig.shape[0]).astype(np.float32)
    T_start[:20] = rng.uniform(THR, 3 * THR, 20)
    ref = jc.composite_rays(J(sig), J(raws), J(dt), J(ts), J(valid), THR,
                            T_start=J(T_start))
    out = tc.composite_rays(T(sig), T(raws), T(dt), T(ts), T(valid), THR,
                            T_start=T(T_start))
    for k in ("opacity", "depth", "rend", "ws"):
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_array_equal(N(out["vr_samples"]),
                                  np.asarray(ref["vr_samples"]))
    assert (N(out["opacity"]) <= T_start + 1e-5).all()   # f32 sums of 64 terms
    with pytest.raises(NotImplementedError):
        tc.composite_rays(T(sig).requires_grad_(True), T(raws), T(dt),
                          T(ts), T(valid), THR, T_start=T(T_start))


def test_kernel_wrapper_refuses_wide_rows():
    sig, raws, dt, ts, valid, _ = _case(5, n=4, K=40)
    with pytest.raises(ValueError):
        tc._check_inputs(T(sig), T(raws), T(dt), T(ts), T(valid))
