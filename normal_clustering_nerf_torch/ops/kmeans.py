"""Spherical k-means and Manhattan cluster selection — port of the JAX
package's `ops/kmeans.py` (reference: losses.py:47-166, where FAISS ran
on the CPU): kernel K7 (`csrc/kmeans.cu`, `normals_clustering` on a CUDA
tensor: the whole loop and the selection in one launch) and its plain
version (`normals_clustering_plain`), which takes K7's arithmetic order
with torch elementwise ops, so that the two agree bit for bit on the
card: the dot products as (n0 c0 + n1 c1) + n2 c2 (`similarity`, not a
matmul, whose FMA and split order would flip near-ties between the many
near-duplicate centroids), the cluster sums in K7's lane-then-butterfly
order (`cluster_sums`), the norm written out.

The centroid-init draw is separable: `init_idx` takes the K indices a
test hands in from the JAX package's draw.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import kernels

LANES = 32    # K7 sums a cluster on one warp
MAX_K = 32    # K7: a warp a cluster


def draw_init(valid: torch.Tensor, K: int,
              generator: torch.Generator) -> torch.Tensor:
    """K distinct indices drawn uniformly from the valid rows (from any
    rows once the valid ones run out), as Gumbel top-k."""
    u = torch.rand(valid.shape, generator=generator, device=valid.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    score = torch.where(valid, gumbel, gumbel - 1e9)
    return torch.topk(score, K).indices


def similarity(a, b):
    """(A, B) dot products of the rows of a (A, 3) and b (B, 3) in K7's
    order: (a0 b0 + a1 b1) + a2 b2, each product and sum rounded alone."""
    a, b = a[:, None, :], b[None, :, :]
    return ((a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1])
            + a[..., 2] * b[..., 2])


def cluster_sums(x, assign, K: int, valid=None):
    """(K, D) sums of the rows of x (M, D) by cluster (the valid rows
    only, where `valid` is given), in K7's order: lane l of cluster k's
    warp adds the rows l, l + 32, ... of cluster k in that order, from
    +0.0, then the lanes' sums meet in an xor butterfly over offsets 16,
    8, 4, 2, 1 (each lane adds the other's sum to its own), and lane 0's
    is the sum. A row of another cluster adds +0.0, which changes no sum
    (one that starts at +0.0 is never -0.0)."""
    M, D = x.shape
    rounds = -(-M // LANES)
    member = assign[None, :] == torch.arange(K, device=x.device)[:, None]
    if valid is not None:
        member = member & valid[None, :]
    rows = torch.zeros((K, rounds * LANES, D), dtype=x.dtype, device=x.device)
    rows[:, :M] = torch.where(member[..., None], x[None], 0.0)
    rows = rows.reshape(K, rounds, LANES, D)
    acc = torch.zeros((K, LANES, D), dtype=x.dtype, device=x.device)
    for j in range(rounds):
        acc = acc + rows[:, j]
    lane = torch.arange(LANES, device=x.device)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, lane ^ o]
    return acc[:, 0]


def spherical_kmeans(normals, valid, K: int = 20, niter: int = 20, *,
                     init_idx: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """(M, 3) unit vectors -> centroids (K, 3), assign (M,) by max dot
    product (the first cluster on a tie); a centroid becomes its valid
    members' sum over the sum's norm where that norm exceeds 1e-12, else
    stays. K7's order throughout."""
    if init_idx is None:
        init_idx = draw_init(valid, K, generator)
    centroids = normals[torch.as_tensor(init_idx, device=normals.device)]
    for _ in range(niter):
        assign = torch.argmax(similarity(normals, centroids), dim=-1)
        s = cluster_sums(normals, assign, K, valid)
        norm = torch.sqrt((s[:, 0] * s[:, 0] + s[:, 1] * s[:, 1])
                          + s[:, 2] * s[:, 2])[:, None]
        centroids = torch.where(norm > 1e-12,
                                s / torch.clamp(norm, min=1e-12), centroids)
    assign = torch.argmax(similarity(normals, centroids), dim=-1)
    return centroids, assign


def _row(m, i):
    """m[i] for a 0-dim index tensor `i` on m's device, without reading
    `i` on the host (a CUDA graph cannot capture that read)."""
    return m.index_select(0, i.view(1))[0]


class ClusteringResult(NamedTuple):
    assign_new: torch.Tensor   # (M,) int in {-3..3}; 0 = discarded
    assign_orig: torch.Tensor  # (M,) raw k-means ids
    centroids3: torch.Tensor   # (3, 3) centroids of C1, C2, C3


def normals_clustering(normals, valid, *, K: int = 20, niter: int = 20,
                       t_similar: float = 0.99, merge_clusters: bool = True,
                       find_opposite: bool = True,
                       init_idx: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> ClusteringResult:
    """Cluster depth normals and pick the three most mutually orthogonal
    clusters: C1 the biggest, (C2, C3) minimising the pairwise |cos|
    criteria; similar clusters merge into a group and opposite clusters
    get the negated label (kmeans.py:61-120). K7 on a CUDA tensor (it
    reads nothing on the host), the plain version on a CPU one. K is at
    most 32 (K7's warp a cluster)."""
    if K > MAX_K:
        raise ValueError(f"cluster_K {K}: K7 (csrc/kmeans.cu) takes at "
                         f"most {MAX_K} clusters, a warp each; ROADMAP B14 "
                         f"would lift the limit")
    if init_idx is None:
        init_idx = draw_init(valid, K, generator)
    init_idx = torch.as_tensor(init_idx, device=normals.device)
    if normals.is_cuda:
        return normals_clustering_kernel(normals, valid, init_idx, niter,
                                         t_similar, merge_clusters,
                                         find_opposite)[0]
    return normals_clustering_plain(normals, valid, K=K, niter=niter,
                                    t_similar=t_similar,
                                    merge_clusters=merge_clusters,
                                    find_opposite=find_opposite,
                                    init_idx=init_idx)[0]


def normals_clustering_kernel(normals, valid, init_idx, niter: int,
                              t_similar: float, merge_clusters: bool,
                              find_opposite: bool):
    """K7 on the card: (ClusteringResult, centroids (K, 3))."""
    dev = normals.device
    M, K = normals.shape[0], init_idx.shape[0]
    if not 1 <= K <= MAX_K:
        raise ValueError(f"K7 takes 1 to {MAX_K} clusters, got {K}")
    if niter < 0 or M < 1:
        raise ValueError(f"K7: niter {niter}, {M} rows")
    normals = normals.detach().contiguous()
    n = kernels.check(normals, "normals", torch.float32, (M, 3), dev)
    v = kernels.check(valid, "valid", torch.bool, (M,), dev)
    i = kernels.check(init_idx, "init_idx", torch.int64, (K,), dev)
    # K7's masks (32 words a group of 32 rows) and a byte a row, which it
    # keeps here when the rows do not fit in shared memory
    scratch = torch.empty(128 * -(-M // 32) + M, dtype=torch.uint8,
                          device=dev)
    new = torch.empty(M, dtype=torch.int64, device=dev)
    orig = torch.empty(M, dtype=torch.int64, device=dev)
    cent = torch.empty((K, 3), dtype=torch.float32, device=dev)
    cent3 = torch.empty((3, 3), dtype=torch.float32, device=dev)
    kernels.KMEANS_CLUSTER.launch(
        n, v, i, M, K, niter, float(t_similar), int(merge_clusters),
        int(find_opposite), kernels.ptr(scratch), kernels.ptr(new),
        kernels.ptr(orig), kernels.ptr(cent), kernels.ptr(cent3), device=dev)
    return ClusteringResult(new, orig, cent3), cent


def normals_clustering_plain(normals, valid, *, K: int = 20, niter: int = 20,
                             t_similar: float = 0.99,
                             merge_clusters: bool = True,
                             find_opposite: bool = True,
                             init_idx: Optional[torch.Tensor] = None,
                             generator: Optional[torch.Generator] = None):
    """K7's plain version: (ClusteringResult, centroids (K, 3))."""
    centroids, assign = spherical_kmeans(normals, valid, K, niter,
                                         init_idx=init_idx,
                                         generator=generator)
    sim = similarity(centroids, centroids)
    sim_abs = sim.abs()
    sizes = (assign[None, :] == torch.arange(K, device=normals.device)[:, None]
             ) & valid[None, :]
    c1 = torch.argmax(sizes.sum(dim=1))
    criteria = (_row(sim_abs.T, c1)[:, None] + _row(sim_abs, c1)[None, :]
                + sim_abs)
    mins, min_idx = torch.min(criteria, dim=0)
    c2 = torch.argmin(mins)
    c3 = _row(min_idx, c2)

    def member_mask(ci):
        sel = (_row(sim, ci) > t_similar if merge_clusters
               else torch.arange(K, device=normals.device) == ci)
        return sel[assign]

    new = torch.zeros_like(assign)
    for g, ci in enumerate((c1, c2, c3)):
        new = torch.where(member_mask(ci) & valid, g + 1, new)
    if find_opposite:
        for g, ci in enumerate((c1, c2, c3)):
            cand = _row(sim, ci)
            o = torch.argmin(cand)
            is_opp = (-_row(cand, o)) > t_similar
            new = torch.where(is_opp & member_mask(o) & valid, -(g + 1), new)
    centroids3 = centroids[torch.stack([c1, c2, c3])]
    return ClusteringResult(new, assign, centroids3), centroids
