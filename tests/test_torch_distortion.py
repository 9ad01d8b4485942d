"""Distortion loss (kernel H4's plain versions) against the JAX package's
`distortion_loss_dense`: forward, and the closed-form backward against
`jax.vjp` of the JAX forward.

Tolerances: forward rtol 1e-5, atol 1e-7 (prefix sums in another
order); gradient rtol 1e-4, atol 1e-6 (closed form vs autodiff: the same
terms, grouped differently). The same hold `chip_smoke.distortion_serial`
(the serial loop that H4 is held to bit for bit on the card) to JAX and
to the plain versions; the segment plain versions equal the dense ones.
"""
import functools

import jax
import numpy as np
import pytest

import chip_smoke
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


# K: groups of 1, 16 and 32 lanes in H4's dense launcher (one chunk; two
# chunks of 32, the second of one sample or of 32); N: rows, one, none
KS, NS = (1, 16, 32, 33, 64), (0, 1, 400)


@functools.lru_cache(maxsize=None)
def _jax_case(K):
    """The (400, K) case of seed K with JAX's loss and gradient on it: one
    JAX shape per K (the rows are independent, so a case of n rows takes
    the first n)."""
    ws, dt, ts, valid, g = _case(100 + K, K=K)
    ref, vjp = jax.vjp(lambda w: jd.distortion_loss_dense(
        w, J(dt), J(ts), J(valid)), J(ws))
    return (ws, dt, ts, valid, g), np.asarray(ref), np.asarray(vjp(J(g))[0])


def _rows(K, n):
    (ws, dt, ts, valid, g), ref, grad = _jax_case(K)
    return ([T(x[:n]) for x in (ws, dt, ts, valid)], T(g[:n]), ref[:n],
            grad[:n], valid[:n])


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("K", KS)
def test_plain_matches_jax(K, n):
    a, g, ref, grad, valid = _rows(K, n)
    np.testing.assert_allclose(N(td.distortion_plain(*a)), ref, rtol=1e-5,
                               atol=1e-7)
    d = N(td.distortion_grad_plain(g, *a))
    np.testing.assert_allclose(d, grad, rtol=1e-4, atol=1e-6)
    assert np.all(d[~valid] == 0.0)


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("K", KS)
def test_serial_reference_matches_jax_and_plain(K, n):
    """`chip_smoke.distortion_serial`, the card's bit-for-bit reference of
    H4 (the first design's serial loop), within the same tolerances of
    JAX and of the plain versions."""
    a, g, ref, grad, valid = _rows(K, n)
    loss, d = N(chip_smoke.distortion_serial(*a)), N(
        chip_smoke.distortion_serial(*a, g))
    for want, dwant in ((ref, grad), (N(td.distortion_plain(*a)),
                                      N(td.distortion_grad_plain(g, *a)))):
        np.testing.assert_allclose(loss, want, rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(d, dwant, rtol=1e-4, atol=1e-6)
    assert np.all(d[~valid] == 0.0)


def test_segment_plain_equals_dense_plain():
    """The segment plain versions on segments of every length 0..64 (a
    tenth of the slots invalid, unused slots after the last segment) give
    the dense plain versions' bits on the same samples laid out as rows of
    64."""
    L, rng = 64, np.random.default_rng(5)
    count = rng.permutation(np.repeat(np.arange(L + 1), 3))
    n = count.shape[0]
    start = np.cumsum(count) - count
    B = int(count.sum()) + 37
    ray_id = np.repeat(np.arange(n), count)
    ray_id = np.concatenate([ray_id, np.full(B - ray_id.shape[0], n - 1)])
    pos = np.arange(B) - start[ray_id]
    used = np.arange(B) < count.sum()
    valid = used & (rng.random(B) >= 0.1)
    valid[start[count == L][0] + L - 1] = True   # rows of 64: W = 64
    ws = (rng.random(B) / np.maximum(count, 1)[ray_id]).astype(np.float32)
    dt = rng.uniform(0.005, 0.05, B).astype(np.float32)
    ts = (np.arange(B) * 0.01 + 0.5).astype(np.float32)
    g = rng.standard_normal(n).astype(np.float32)
    rows = np.zeros((n, L), np.int64)
    inside = np.arange(L)[None] < count[:, None]
    rows[inside] = np.arange(B)[used]
    dense = [T(x[rows]) for x in (ws, dt, ts)] + [T(valid[rows] & inside)]
    seg = [T(x) for x in (ws, dt, ts)]
    rid, st = T(ray_id.astype(np.int32)), T(start.astype(np.int32))
    np.testing.assert_array_equal(
        N(td.distortion_compact_plain(*seg, rid, st, T(valid), n)),
        N(td.distortion_plain(*dense)))
    d = N(td.distortion_compact_grad_plain(T(g), *seg, rid, st, T(valid), n))
    np.testing.assert_array_equal(
        d[used], N(td.distortion_grad_plain(T(g), *dense))[inside])
    assert np.all(d[~used] == 0.0) and pos[used].max() == L - 1
