"""Distortion loss (kernel H4's plain versions) against the JAX package's
`distortion_loss_dense`: forward, and the closed-form backward against
`jax.vjp` of the JAX forward.

Tolerances: forward rtol 1e-5, atol 1e-7 (prefix sums in another
order); gradient rtol 1e-4, atol 1e-6 (closed form vs autodiff: the same
terms, grouped differently).
"""
import jax
import numpy as np
import pytest

from test_torch_common import J, N, T

from normal_clustering_nerf_torch.ops import distortion as td
from normal_clustering_nerf_tpu.ops import distortion as jd


def _case(seed, n=400, K=16):
    rng = np.random.default_rng(seed)
    ws = rng.dirichlet(np.ones(K), n).astype(np.float32) * rng.random((n, 1))
    dt = rng.uniform(0.005, 0.05, (n, K)).astype(np.float32)
    ts = np.cumsum(dt, axis=1).astype(np.float32) + rng.random((n, 1))
    ts = ts.astype(np.float32)
    count = rng.integers(0, K + 1, n)
    valid = np.arange(K)[None, :] < count[:, None]
    g = rng.standard_normal(n).astype(np.float32)
    return ws.astype(np.float32), dt, ts, valid, g


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_and_gradient_match_jax(seed):
    ws, dt, ts, valid, g = _case(seed)
    ref, vjp = jax.vjp(lambda w: jd.distortion_loss_dense(
        w, J(dt), J(ts), J(valid)), J(ws))
    wt = T(ws).requires_grad_(True)
    out = td.distortion_loss_dense(wt, T(dt), T(ts), T(valid))
    np.testing.assert_allclose(N(out), np.asarray(ref), rtol=1e-5, atol=1e-7)
    out.backward(T(g))
    np.testing.assert_allclose(N(wt.grad), np.asarray(vjp(J(g))[0]),
                               rtol=1e-4, atol=1e-6)
    assert np.all(N(wt.grad)[~valid] == 0.0)
