"""K7's plain version (`ops/kmeans.py:normals_clustering_plain`, the
arithmetic order of `csrc/kmeans.cu`: elementwise dot products, the
cluster sums by block ranges, lanes, a butterfly and the blocks in order,
the written-out norm) against the JAX package's `normals_clustering`, on
inputs made by numpy from a seed, with the K initial rows drawn by JAX
and handed in, through the public wrapper `normals_clustering` (on a CPU
tensor the plain version).

Cases: the bench's shape (M 2730, K 20, 20 rounds), duplicated normals
(exact and one-ulp near-ties between rows and between centroids), an
invalid share, every row past the first K invalid, every row invalid,
M off multiples of 32 and 1024, K 12, 33, 40 and 64 (past one warp of
clusters: the JAX package takes any K), rotation recovery's shape (M
65,536, K 30, 30 rounds), merge_clusters and find_opposite on and off.

Tolerances: assign_new exact; centroids3 within 1e-6 (JAX's matmul and
segment sum add in other orders); assign_orig exact, but for rows whose
two clusters' dot products with JAX's final centroids lie within 4 ulps
of each other (near-tie cases only): JAX's CPU dot product is the FMA
chain fma(a2, b2, fma(a1, b1, a0 b0)), and its segment sum adds in row
order, where K7 rounds every product and sums by lanes, so a row tied
between two near-duplicate centroids can take either. Those clusters
merge into one group, so the labels (assign_new) still agree.
"""
import jax
import numpy as np
import pytest
import torch

from test_torch_common import J, N, T

from normal_clustering_nerf_torch.ops import kmeans as tk
from normal_clustering_nerf_tpu.ops import kmeans as jk


def _room_normals(rng, M, noise=0.05):
    """Noisy normals of a rotated box room, both orientations."""
    q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    axes = np.concatenate([q, -q]).astype(np.float32)
    n = axes[rng.integers(0, 6, M)] + noise * rng.standard_normal((M, 3))
    return (n / np.linalg.norm(n, axis=1, keepdims=True)).astype(np.float32)


def _near_ties(rng, M):
    """A few directions repeated exactly and moved by one ulp, so that
    rows tie exactly or nearly with each other and with the centroids
    drawn from them."""
    base = _room_normals(rng, 8, noise=0.2)
    n = base[rng.integers(0, 8, M)]
    step = rng.integers(-1, 2, (M, 3)).astype(np.int32)
    return (n.view(np.int32) + step * (rng.random((M, 3)) < 0.3)).view(
        np.float32)


def _case(kind, M, seed):
    rng = np.random.default_rng(seed)
    n = _near_ties(rng, M) if kind == "ties" else _room_normals(rng, M)
    valid = np.ones(M, bool)
    if kind == "invalid":
        valid = rng.random(M) < 0.7
    elif kind == "past_k":
        valid[20:] = False
    elif kind == "none":
        valid[:] = False
    n[~valid] = 0.0   # as clustering_losses hands them in
    return n, valid


CASES = [   # (kind, M, K, niter, merge_clusters, find_opposite)
    ("room", 2730, 20, 20, True, True),
    ("ties", 2730, 20, 20, True, True),
    ("invalid", 2730, 20, 20, True, True),
    ("past_k", 300, 20, 20, True, True),
    ("none", 300, 20, 20, True, True),
    ("room", 4097, 20, 20, True, True),
    ("ties", 1031, 12, 20, True, True),
    ("room", 2730, 12, 5, False, True),
    ("invalid", 1031, 20, 20, True, False),
    ("room", 1031, 20, 20, False, False),
    ("room", 2730, 33, 20, True, True),
    ("invalid", 2730, 40, 20, True, True),
    ("room", 4097, 64, 20, True, True),
]


@pytest.mark.parametrize("kind,M,K,niter,merge,opposite", CASES)
def test_kernel_order_matches_jax(kind, M, K, niter, merge, opposite):
    normals, valid = _case(kind, M, seed=M + K + niter)
    key = jax.random.PRNGKey(M * 7 + K)
    ref = jk.normals_clustering(J(normals), J(valid), key, K=K, niter=niter,
                                t_similar=0.99, merge_clusters=merge,
                                find_opposite=opposite)
    # JAX's own draw (kmeans.py:36-38), handed to the port
    p = valid.astype(np.float32) / max(valid.sum(), 1.0)
    init = np.asarray(jax.random.choice(key, M, shape=(K,), replace=False,
                                        p=J(p)))
    out = tk.normals_clustering(
        T(normals), T(valid), K=K, niter=niter, t_similar=0.99,
        merge_clusters=merge, find_opposite=opposite, init_idx=T(init))
    got, want = N(out.assign_orig), np.asarray(ref.assign_orig)
    moved = np.flatnonzero(got != want)
    if kind != "ties":
        assert moved.size == 0
    elif moved.size:
        cent, _ = jk.spherical_kmeans(J(normals), J(valid), key, K=K,
                                      niter=niter)
        dots = normals[moved].astype(np.float64) @ np.asarray(
            cent, np.float64).T
        a, b = (dots[np.arange(moved.size), x[moved]] for x in (got, want))
        assert (np.abs(a - b) <= 4 * np.spacing(np.float32(np.abs(b)))).all()
    np.testing.assert_array_equal(N(out.assign_new),
                                  np.asarray(ref.assign_new))
    np.testing.assert_allclose(N(out.centroids3), np.asarray(ref.centroids3),
                               rtol=0, atol=1e-6)
    if kind == "none":
        assert not N(out.assign_new).any()
    elif kind == "room" and merge and opposite:
        assert set(np.unique(N(out.assign_new))) >= {1, 2, 3}


@pytest.mark.parametrize("M,K,niter,merge,opposite", [
    (1031, 40, 20, False, False),
    (65536, 30, 30, True, True),   # rotation recovery's shape
])
def test_drift_of_many_rows_or_clusters_stays_at_near_ties(M, K, niter,
                                                           merge, opposite):
    """Room normals at ~26 rows a cluster (K 40) and at rotation
    recovery's shape, against JAX. Here the two orders of the cluster
    sums part the centroids by more than a few ulps: a row tied within a
    few ulps between two near-duplicate centroids takes the other one in
    an early round (at K 40 one centroid then moves by 1.4e-3, measured),
    and the sums over ~2,000 rows a cluster differ in their last bits
    (at M 65,536 the centroids part by up to 2.8e-5 after 30 rounds, 3
    rows move, centroids3 1.1e-5 apart); K7's former order (a cluster's
    rows on one warp) parts from JAX the same way at that shape (3 rows
    moved, centroids3 1.1e-5 apart). So a
    row's cluster may differ only where that drift explains it: its two
    clusters' dot products with JAX's final centroids lie within the two
    centroids' drift (their distance between the port and JAX) plus 4
    ulps; at most one row in 1,000 moves; a label (assign_new) differs
    only on a moved row; centroids3 within 1e-4 of JAX's."""
    normals, valid = _case("room", M, seed=M + K + niter)
    key = jax.random.PRNGKey(M * 7 + K)
    ref = jk.normals_clustering(J(normals), J(valid), key, K=K, niter=niter,
                                t_similar=0.99, merge_clusters=merge,
                                find_opposite=opposite)
    cent, _ = jk.spherical_kmeans(J(normals), J(valid), key, K=K,
                                  niter=niter)
    cent = np.asarray(cent, np.float64)
    p = valid.astype(np.float32) / max(valid.sum(), 1.0)
    init = np.asarray(jax.random.choice(key, M, shape=(K,), replace=False,
                                        p=J(p)))
    out, tc = tk.normals_clustering_plain(
        T(normals), T(valid), K=K, niter=niter, t_similar=0.99,
        merge_clusters=merge, find_opposite=opposite, init_idx=T(init))
    drift = np.linalg.norm(N(tc).astype(np.float64) - cent, axis=1)
    got, want = N(out.assign_orig), np.asarray(ref.assign_orig)
    moved = np.flatnonzero(got != want)
    assert moved.size <= M // 1000
    dots = normals[moved].astype(np.float64) @ cent.T
    a, b = (dots[np.arange(moved.size), x[moved]] for x in (got, want))
    gap = drift[got[moved]] + drift[want[moved]] + 4 * np.spacing(
        np.float32(np.abs(b)))
    assert (np.abs(a - b) <= gap).all()
    relabeled = np.flatnonzero(N(out.assign_new) != np.asarray(ref.assign_new))
    assert np.isin(relabeled, moved).all()
    np.testing.assert_allclose(N(out.centroids3), np.asarray(ref.centroids3),
                               rtol=0, atol=1e-4)


def test_near_ties_reach_the_assignment():
    """The near-tie case is one: rows whose two best dot products with
    the final centroids are within an ulp, or equal."""
    normals, valid = _case("ties", 2730, seed=2730 + 20 + 20)
    rng = np.random.default_rng(0)
    init = rng.choice(2730, 20, replace=False)
    cent, _ = tk.spherical_kmeans(T(normals), T(valid), 20, 20,
                                  init_idx=T(init))
    sim = N(tk.similarity(T(normals), cent))
    top = np.sort(sim, axis=1)[:, -2:]
    gap = top[:, 1] - top[:, 0]
    assert (gap <= np.spacing(np.abs(top[:, 1]))).sum() > 100


@pytest.mark.parametrize("M", [1000, 20, 4097])
def test_cluster_sums_order(M):
    """`cluster_sums` takes K7's order: the rows in BLOCKS (16) ranges of
    ceil(M / BLOCKS) (at M 20 the last six ranges are empty), in each
    range lane l adds its rows l, l + 32, ..., then the xor butterfly,
    then the ranges' partials in order; a serial f32 reference of that
    order agrees bit for bit."""
    rng = np.random.default_rng(3)
    K = 5
    x = rng.standard_normal((M, 3)).astype(np.float32)
    a = rng.integers(0, K, M)
    ok = rng.random(M) < 0.9
    got = N(tk.cluster_sums(T(x), T(a).long(), K, T(ok)))
    P = -(-M // tk.BLOCKS)
    want = np.zeros((K, 3), np.float32)
    for k in range(K):
        for b in range(tk.BLOCKS):
            lanes = np.zeros((32, 3), np.float32)
            for r in range(b * P, min((b + 1) * P, M)):
                if a[r] == k and ok[r]:
                    j = (r - b * P) % 32
                    lanes[j] = (lanes[j] + x[r]).astype(np.float32)
            for o in (16, 8, 4, 2, 1):
                lanes = (lanes + lanes[np.arange(32) ^ o]).astype(np.float32)
            want[k] = (want[k] + lanes[0]).astype(np.float32)
    np.testing.assert_array_equal(got, want)


def test_wrapper_takes_plain_on_cpu_past_32():
    """The wrapper on CPU tensors is the plain version, bit for bit, at K
    20 and past one warp of clusters (K 33: the port refused it once)."""
    normals, valid = _case("room", 500, seed=1)
    for K in (20, 33):
        init = np.random.default_rng(2).choice(500, K, replace=False)
        got = tk.normals_clustering(T(normals), T(valid), K=K, niter=20,
                                    init_idx=T(init))
        want, _ = tk.normals_clustering_plain(T(normals), T(valid), K=K,
                                              niter=20, init_idx=T(init))
        for g, w in zip(got, want):
            assert torch.equal(g, w)
