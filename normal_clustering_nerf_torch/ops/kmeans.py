"""Spherical k-means and Manhattan cluster selection in plain PyTorch —
port of the JAX package's `ops/kmeans.py` (reference: losses.py:47-166,
where FAISS ran on the CPU). Kernel K7 is still to write
(ROADMAP).

The centroid-init draw is separable: `init_idx` takes the K indices a
test hands in from the JAX package's draw.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


def draw_init(valid: torch.Tensor, K: int,
              generator: torch.Generator) -> torch.Tensor:
    """K distinct indices drawn uniformly from the valid rows (from any
    rows once the valid ones run out), as Gumbel top-k."""
    u = torch.rand(valid.shape, generator=generator, device=valid.device)
    gumbel = -torch.log(-torch.log(u.clamp(1e-20, 1.0 - 1e-7)))
    score = torch.where(valid, gumbel, gumbel - 1e9)
    return torch.topk(score, K).indices


def spherical_kmeans(normals, valid, K: int = 20, niter: int = 20, *,
                     init_idx: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
    """(M, 3) unit vectors -> centroids (K, 3), assign (M,) by max dot
    product; centroids are renormalised member sums."""
    if init_idx is None:
        init_idx = draw_init(valid, K, generator)
    centroids = normals[torch.as_tensor(init_idx, device=normals.device)]
    w = valid.to(normals.dtype)[:, None]
    for _ in range(niter):
        assign = torch.argmax(normals @ centroids.T, dim=-1)
        sums = torch.zeros((K, 3), dtype=normals.dtype, device=normals.device)
        sums.index_add_(0, assign, normals * w)
        norm = torch.linalg.norm(sums, dim=-1, keepdim=True)
        centroids = torch.where(norm > 1e-12,
                                sums / torch.clamp(norm, min=1e-12),
                                centroids)
    assign = torch.argmax(normals @ centroids.T, dim=-1)
    return centroids, assign


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
    get the negated label (kmeans.py:61-120)."""
    centroids, assign = spherical_kmeans(normals, valid, K, niter,
                                         init_idx=init_idx,
                                         generator=generator)
    sim = centroids @ centroids.T
    sim_abs = sim.abs()
    sizes = torch.zeros(K, dtype=torch.int64, device=normals.device)
    sizes.index_add_(0, assign, valid.to(torch.int64))
    c1 = torch.argmax(sizes)
    criteria = sim_abs[:, c1][:, None] + sim_abs[c1, :][None, :] + sim_abs
    mins, min_idx = torch.min(criteria, dim=0)
    c2 = torch.argmin(mins)
    c3 = min_idx[c2]

    def member_mask(ci):
        sel = (sim[ci] > t_similar if merge_clusters
               else torch.arange(K, device=normals.device) == ci)
        return sel[assign]

    new = torch.zeros_like(assign)
    for g, ci in enumerate((c1, c2, c3)):
        new = torch.where(member_mask(ci) & valid, g + 1, new)
    if find_opposite:
        for g, ci in enumerate((c1, c2, c3)):
            cand = sim[ci]
            o = torch.argmin(cand)
            is_opp = (-cand[o]) > t_similar
            new = torch.where(is_opp & member_mask(o) & valid, -(g + 1), new)
    centroids3 = centroids[torch.stack([c1, c2, c3])]
    return ClusteringResult(new, assign, centroids3)
