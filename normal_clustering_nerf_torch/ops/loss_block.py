"""The loss block — the terms of the JAX package's `compute_losses`
(normal_clustering_nerf_tpu/losses.py:189-364) that the bench
configuration runs, with their gradient: rgb, opacity, distortion (H4's
per-ray output in, its cotangent out), the normal-clustering terms (ort,
centr_dot, centr_L1 and the canonical-axis snapping, with
`discard_far_members`; `_clustering_losses`, :94-186) on the depth
normals of the triangles (`extract_normals_from_ray_batch`,
datasets/normals.py) and the semantic cross-entropy. Kernel K10
(`csrc/loss_block.cu`) on CUDA tensors, its plain version on CPU ones, as
one `torch.autograd.Function` (`loss_block`) whose backward is derived
by hand (not autograd of the chain):

  loss_rays     the triangles' depth normals (and the zeroed rows and the
                `valid` flags K7 reads), and a block's sums of the rays'
                squared rgb error, opacity entropy, distortion, cross-
                entropy and its valid count, each at its block's slot;
  K7            the k-means and the cluster selection (`ops/kmeans.py`);
  loss_clusters one block: the slots added, the flip and the membership,
                the member sums, the centroids, the terms, their finite
                guards, the schedule's weights and window (read on the
                device), the terms' vector, their total and what the
                backward reads (`SAVED`);
  loss_bwd      the gradient of every input, a thread a ray: the ray
                terms', and the clustering terms' through the centroids,
                the members (the flip undone), the normalisation, the
                cross product and the points, a ray's triangles added in
                the order of its row of the ray -> (triangle, vertex)
                table (`incidence_table`), with no float atomics.

The plain version repeats K10's arithmetic and its order of sums (one
rounding an operation; block sums as K10's trees, `tree_sum`), so that
the normals, K7's input and the terms agree with the kernel bit for bit
on the card.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from .kmeans import normals_clustering

RAY_THREADS = 256     # loss_rays' and loss_bwd's threads a block, an item each
CL_THREADS = 1024     # loss_clusters' one block
# K10's terms, in the JAX dict's order; a configuration computes a subset
TERMS = ("rgb", "opacity", "distortion", "norm_D_C_ort_dot",
         "norm_D_C_centr_dot", "norm_D_C_centr_L1", "norm_D_C_can_dot",
         "norm_D_C_can_L1", "sem")
CLUSTER_TERMS = TERMS[3:8]
RGB, OPAC, DIST, ORT, CDOT, CL1, CANDOT, CANL1, SEM = range(len(TERMS))
# a block's ray sums: squared rgb error, opacity entropy, distortion,
# cross-entropy, its valid rows
Q_RGB, Q_ENT, Q_DL, Q_CE, Q_CNT = range(5)
NQ = 5
# what loss_clusters saves for the backward (f32): each term's factor (its
# weight where it is on, finite and in the window, else 0), the
# denominators of the ray terms, and of each cluster its member count
# (at least 1), centroid, member sum, the norm of its mean (0 where it
# normalises to 0) and sum of the signs of (member - centroid); the signs
# of the centroids' dot products (1-2, 1-3, 2-3), the snapping's 18
# conditions and their count (at least 1)
S_F, S_DEN, S_K, S_C, S_S, S_R, S_SG, S_SD, S_COND, S_NCOND = (
    0, 9, 12, 15, 24, 33, 36, 45, 48, 66)
SAVED = 67
CANONICAL = ((1., 0., 0.), (-1., 0., 0.), (0., 1., 0.), (0., -1., 0.),
             (0., 0., 1.), (0., 0., -1.))
MAX_INDEX = 1 << 30   # K10 indexes with 32-bit ints (ROADMAP B6c)


class Plan(NamedTuple):
    """The static part of a call: sizes, which terms, the constant
    weights (as f32 in K10; the schedule's come as 0-dim tensors)."""
    n_sup: int          # supervised rows (rgb, sem)
    n_rays: int         # rays (opacity, distortion)
    unsup: int          # the first clustering ray
    n_tri: int          # triangles (the clustering's rows)
    n_cls: int          # semantic classes (0: no sem term)
    terms: Tuple[str, ...]   # the computed subset of TERMS, in order
    w_op: float
    w_dist: float
    w_sem: float
    tres: float         # norm_can_tres
    K: int              # cluster_K
    niter: int          # cluster_niter
    discard: bool       # discard_far_members

    @property
    def clustering(self) -> bool:
        return "norm_D_C_ort_dot" in self.terms

    @property
    def snap(self) -> bool:
        return "norm_D_C_can_dot" in self.terms

    @property
    def items(self) -> int:
        """loss_rays' and loss_bwd's items: a ray and a triangle each."""
        return max(self.n_rays, self.n_tri)

    @property
    def blocks(self) -> int:
        return max(1, -(-self.items // RAY_THREADS))


class Inputs(NamedTuple):
    """What the block reads besides its differentiable inputs."""
    trgb: Optional[torch.Tensor]      # (n_sup, 3) targets
    labels: Optional[torch.Tensor]    # (n_sup,) semantic labels (1..C; 0 none)
    x123: Optional[Tuple[torch.Tensor, ...]]   # (T,) x1, x2, x3 (int64)
    table: Optional[torch.Tensor]     # (M, W) int32 ray -> 3 t + vertex
    weights: Tuple[torch.Tensor, ...]  # 0-dim f32 w_<term> of CLUSTER_TERMS
    in_window: Optional[torch.Tensor]  # 0-dim f32, > 0 inside
    kmeans_init: Optional[torch.Tensor]
    generator: Optional[torch.Generator]


# ------------------------------------------------------------ tables
def incidence_table_np(x1, x2, x3, n_rays: int) -> np.ndarray:
    """(n_rays, W) int32: ray r's (triangle t, vertex k) incidences as 3 t
    + k in increasing order, -1 past its last; W the most any ray has
    (at least 1)."""
    code = np.concatenate([3 * np.arange(len(x1)) + k
                           for k in range(3)]).astype(np.int64)
    ray = np.concatenate([np.asarray(x1), np.asarray(x2),
                          np.asarray(x3)]).astype(np.int64)
    order = np.lexsort((code, ray))
    ray, code = ray[order], code[order]
    count = np.bincount(ray, minlength=n_rays)
    W = max(1, int(count.max()) if count.size else 1)
    first = np.concatenate([[0], np.cumsum(count)[:-1]]).astype(np.int64)
    slot = np.arange(len(ray)) - first[ray]
    out = np.full((n_rays, W), -1, np.int32)
    out[ray, slot] = code
    return out


# ------------------------------------------------------------ K10's order
def tree_sum(s: torch.Tensor) -> torch.Tensor:
    """(..., threads) -> (...): K10's block tree: xor halvings 16..1 over
    a warp's lanes (each lane adds the other lane's sum to its own), then
    over the warp sums (threads // 32 of them)."""
    threads = s.shape[-1]
    warps = threads // 32
    lane = torch.arange(32, device=s.device)
    s = s.reshape(*s.shape[:-1], warps, 32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ o]
    w = s[..., 0]
    wi = torch.arange(warps, device=s.device)
    o = warps // 2
    while o:
        w = w + w[..., wi ^ o]
        o //= 2
    return w[..., 0]


def strided_sum(x: torch.Tensor, threads: int) -> torch.Tensor:
    """(R, k) -> (k,): thread t adds rows t, t + threads, ... in order from
    +0.0, then `tree_sum` over the threads."""
    R, k = x.shape
    rounds = max(1, -(-R // threads))
    pad = x.new_zeros((rounds * threads - R, k))
    rows = torch.cat([x, pad]).view(rounds, threads, k)
    acc = x.new_zeros((threads, k))
    for r in rows:
        acc = acc + r
    return tree_sum(acc.T.contiguous())


def _t(v: float, ref: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 constant on ref's device: a divisor divided by as such
    (PyTorch's CUDA kernel multiplies by a Python scalar's reciprocal)."""
    return torch.full((), v, dtype=torch.float32, device=ref.device)


@functools.lru_cache(maxsize=8)
def _canonical(device: torch.device) -> torch.Tensor:
    """(6, 3) signed axes on `device`, made once (a copy from the host
    cannot be captured in a CUDA graph). Callers must not write to it."""
    return torch.tensor(CANONICAL, device=device)


def _sgn(x):
    return (x > 0).to(x.dtype) - (x < 0).to(x.dtype)


def dot3(a, b):
    """(a0 b0 + a1 b1) + a2 b2 over the last axis, each op rounded."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def cross3(a, b):
    """a x b as torch.linalg.cross and jnp.cross write it, each product
    and difference rounded alone."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


# ------------------------------------------------------------ stage 1
class Tri(NamedTuple):
    a: torch.Tensor      # P2 - P1 (T, 3)
    b: torch.Tensor      # P3 - P1
    r: torch.Tensor      # sqrt of |a x b|^2 where it exceeds 1e-12, else 1
    n: torch.Tensor      # the unit normal (0 where |a x b|^2 <= 1e-12)


def triangles_plain(rays_o, rays_d, depth, x123) -> Tri:
    """`extract_normals_from_ray_batch` in K10's order: P = o + d depth,
    the cross product, the double-where normalisation
    (datasets/normals.py:12-31)."""
    P = rays_o + rays_d * depth[:, None]
    P1, P2, P3 = (P[x] for x in x123)
    a, b = P2 - P1, P3 - P1
    v = cross3(a, b)
    sq = dot3(v, v)
    ok = sq > 1e-12
    r = torch.sqrt(torch.where(ok, sq, torch.ones_like(sq)))
    n = torch.where(ok[:, None], v / r[:, None], torch.zeros_like(v))
    return Tri(a, b, r, n)


def masked(n):
    """(rows zeroed where not finite or all zero, the valid flags)."""
    finite = torch.isfinite(n).all(dim=-1)
    valid = finite & (n.abs().sum(dim=-1) != 0.0)
    return torch.where(valid[:, None], n, torch.zeros_like(n)), valid


def _softmax_parts(x):
    """(x - max, log of the sum of exp(x - max)), the classes summed in
    order."""
    z = x - x.max(dim=-1, keepdim=True).values
    s = torch.zeros_like(z[:, 0])
    for c in range(z.shape[1]):
        s = s + torch.exp(z[:, c])
    return z, torch.log(s)


def _sem_rows(sem, labels, n_cls):
    """(the cross-entropy of each row (0 where its label is none), the
    valid flags, the one-hot rows, log-softmax), as the JAX package's
    `_cross_entropy` (losses.py:74-91) with no weight or smoothing."""
    lab = labels.to(torch.int64) - 1
    valid = lab >= 0
    q = torch.nn.functional.one_hot(lab.clamp(0, n_cls - 1),
                                    n_cls).to(sem.dtype)
    z, lse = _softmax_parts(sem.float())
    logp = z - lse[:, None]
    acc = torch.zeros_like(lse)
    for c in range(n_cls):
        acc = acc + q[:, c] * logp[:, c]
    per = torch.where(valid, -acc, torch.zeros_like(acc))
    return per, valid, q, logp


def rays_plain(plan: Plan, inp: Inputs, rgb=None, opacity=None, dl=None,
               sem=None, depth=None, rays_o=None, rays_d=None):
    """loss_rays: (normals zeroed where invalid (T, 3), valid (T,), the
    blocks' ray sums (blocks, NQ))."""
    dev = opacity.device
    if plan.clustering:
        u = plan.unsup
        tri = triangles_plain(rays_o[u:], rays_d[u:], depth[u:], inp.x123)
        nm, valid = masked(tri.n)
    else:
        nm = torch.zeros((0, 3), device=dev)
        valid = torch.zeros(0, dtype=torch.bool, device=dev)
    items = plan.blocks * RAY_THREADS
    vals = torch.zeros((items, NQ), device=dev)
    n, N = plan.n_sup, plan.n_rays
    e = rgb[:n] - inp.trgb
    vals[:n, Q_RGB] = dot3(e, e)
    o = opacity + 1e-10
    vals[:N, Q_ENT] = -o * torch.log(o)
    if dl is not None:
        vals[:N, Q_DL] = dl
    if plan.n_cls:
        per, ok, _, _ = _sem_rows(sem[:n], inp.labels, plan.n_cls)
        vals[:n, Q_CE] = per
        vals[:n, Q_CNT] = ok.float()
    slots = tree_sum(vals.view(plan.blocks, RAY_THREADS, NQ)
                     .permute(0, 2, 1).contiguous())
    return nm, valid, slots


# ------------------------------------------------------------ stage 2
def _normalize3(m):
    """(the unit vector (0 where |m|^2 <= 1e-12), its norm (0 there))."""
    sq = dot3(m, m)
    ok = sq > 1e-12
    r = torch.sqrt(torch.where(ok, sq, torch.ones_like(sq)))
    c = torch.where(ok[..., None], m / r[..., None], torch.zeros_like(m))
    return c, torch.where(ok, r, torch.zeros_like(r))


def membership(plan: Plan, nm, assign, cent3):
    """(the flipped normals, each row's code: +-(g + 1) for a member of
    cluster g (negative where flipped), 0 for none)."""
    flip = assign < 0
    nf = torch.where(flip[:, None], -nm, nm)
    g = assign.abs()
    keep = (g >= 1) & (g <= 3)
    if plan.discard:
        c = cent3[(g - 1).clamp(0, 2)]
        near = (1.0 - dot3(nf, c)) <= plan.tres
        keep = keep & near
    code = torch.where(keep, torch.where(flip, -g, g), torch.zeros_like(g))
    return nf, code.to(torch.int8)


def clusters_plain(plan: Plan, inp: Inputs, nm, assign, cent3, slots):
    """loss_clusters: (terms (len(plan.terms),), their total, the rgb
    mean before its guard, the SAVED state, the members' codes (T,))."""
    dev = slots.device
    f = torch.float32
    one = _t(1.0, slots)
    three = _t(3.0, slots)
    sums = strided_sum(slots, CL_THREADS)
    saved = torch.zeros(SAVED, device=dev)
    val = {}
    fac = {}
    win = None
    code = torch.zeros(plan.n_tri, dtype=torch.int8, device=dev)
    n, N = plan.n_sup, plan.n_rays
    den_rgb, den_n = _t(3.0 * n, slots), _t(float(N), slots)
    mse = sums[Q_RGB] / den_rgb
    val["rgb"], fac["rgb"] = mse, one
    ent = sums[Q_ENT] / den_n
    val["opacity"] = plan.w_op * ent
    fac["opacity"] = _t(plan.w_op, slots)
    val["distortion"] = plan.w_dist * (sums[Q_DL] / den_n)
    fac["distortion"] = _t(plan.w_dist, slots)
    den_sem = torch.clamp(sums[Q_CNT], min=1e-12)
    val["sem"] = plan.w_sem * (sums[Q_CE] / den_sem)
    fac["sem"] = _t(plan.w_sem, slots)
    saved[S_DEN:S_DEN + 3] = torch.stack([den_rgb, den_n, den_sem])
    if plan.clustering:
        nf, code = membership(plan, nm, assign, cent3)
        g = code.abs().to(torch.int64)
        mem = torch.stack([(g == j + 1) for j in range(3)], -1)   # (T, 3)
        zero = torch.zeros_like(nf)
        cols = []
        for j in range(3):
            cols += [mem[:, j].to(f)] + [torch.where(mem[:, j:j + 1], nf,
                                                     zero)[:, c]
                                         for c in range(3)]
        s1 = strided_sum(torch.stack(cols, -1), CL_THREADS).view(3, 4)
        cnt, S = s1[:, 0], s1[:, 1:]
        k = torch.clamp(cnt, min=1.0)
        mean = S / k[:, None]
        c, r = _normalize3(mean)
        cols = []
        for j in range(3):
            m = mem[:, j]
            d = nf - c[j]
            cols += [torch.where(m, dot3(nf, c[j]), zero[:, 0]),
                     torch.where(m, (d[:, 0].abs() + d[:, 1].abs())
                                 + d[:, 2].abs(), zero[:, 0])]
            cols += [torch.where(m, _sgn(d[:, i]), zero[:, 0])
                     for i in range(3)]
        s2 = strided_sum(torch.stack(cols, -1), CL_THREADS).view(3, 5)
        D, L, SG = s2[:, 0], s2[:, 1], s2[:, 2:]
        d12, d13, d23 = dot3(c[0], c[1]), dot3(c[0], c[2]), dot3(c[1], c[2])
        ort = ((d12.abs() + d13.abs()) + d23.abs()) / three
        cd = (((one - D[0] / k[0]) + (one - D[1] / k[1]))
              + (one - D[2] / k[2])) / three
        cl1 = ((L[0] / k[0] + L[1] / k[1]) + L[2] / k[2]) / three
        ok = (cnt > 0).all()
        on = {"norm_D_C_ort_dot": ok, "norm_D_C_centr_dot": ok,
              "norm_D_C_centr_L1": ok}
        raw = {"norm_D_C_ort_dot": ort, "norm_D_C_centr_dot": cd,
               "norm_D_C_centr_L1": cl1}
        if plan.snap:
            can = _canonical(dev)
            dots = torch.stack([torch.stack([c[j][i // 2] if i % 2 == 0
                                             else -c[j][i // 2]
                                             for i in range(6)])
                                for j in range(3)])           # (3, 6)
            cond = (one - dots) < plan.tres * 3.0
            condf = cond.to(f).reshape(-1)
            l1 = ((c[:, None, 0] - can[None, :, 0]).abs()
                  + (c[:, None, 1] - can[None, :, 1]).abs()) \
                + (c[:, None, 2] - can[None, :, 2]).abs()
            acc_d = torch.zeros((), device=dev)
            acc_l = torch.zeros((), device=dev)
            acc_n = torch.zeros((), device=dev)
            for i in range(18):
                acc_d = acc_d + dots.reshape(-1)[i] * condf[i]
                acc_l = acc_l + l1.reshape(-1)[i] * condf[i]
                acc_n = acc_n + condf[i]
            nc = torch.clamp(acc_n, min=1.0)
            snap = ok & (acc_n > 0)
            on["norm_D_C_can_dot"] = on["norm_D_C_can_L1"] = snap
            raw["norm_D_C_can_dot"] = one - acc_d / nc
            raw["norm_D_C_can_L1"] = acc_l / nc
            saved[S_COND:S_COND + 18] = condf
            saved[S_NCOND] = nc
        win = inp.in_window > 0
        for name, w in zip(CLUSTER_TERMS, inp.weights):
            if name not in raw:
                continue
            v = torch.where(on[name], w * raw[name], torch.zeros_like(w))
            val[name] = torch.where(win, v, torch.zeros_like(v))
            fac[name] = torch.where(on[name] & win, w, torch.zeros_like(w))
        saved[S_K:S_K + 3] = k
        saved[S_C:S_C + 9] = c.reshape(-1)
        saved[S_S:S_S + 9] = S.reshape(-1)
        saved[S_R:S_R + 3] = r
        saved[S_SG:S_SG + 9] = SG.reshape(-1)
        saved[S_SD:S_SD + 3] = torch.stack([_sgn(d12), _sgn(d13), _sgn(d23)])
    terms = []
    total = None
    for name in plan.terms:
        v = val[name]
        fin = torch.isfinite(v)
        t = torch.where(fin, v, torch.zeros_like(v))
        saved[S_F + TERMS.index(name)] = torch.where(
            fin, fac[name], torch.zeros_like(fac[name]))
        terms.append(t)
        total = t if total is None else total + t
    return torch.stack(terms), total, mse, saved, code


# ------------------------------------------------------------ backward
class Coef(NamedTuple):
    rgb: torch.Tensor     # d rgb = rgb * (2 e)
    op: torch.Tensor      # d opacity = -(op * (log o + 1))
    dl: torch.Tensor      # d dl
    sem: torch.Tensor     # d logits = sem * (softmax - onehot)
    A: torch.Tensor       # (3, 3) a member's d nf: A_g + B_g sgn(nf - c_g)
    B: torch.Tensor       # (3,)


def coefficients(plan: Plan, saved, g_terms, g_total) -> Coef:
    """The scalars of loss_bwd, as each of its blocks computes them: each
    term's cotangent (its own and the total's) times its factor, then the
    ray terms' and the clusters' coefficients."""
    dev = saved.device
    G = torch.zeros(len(TERMS), device=dev)
    for i, name in enumerate(plan.terms):
        j = TERMS.index(name)
        gs = torch.zeros((), device=dev)
        if g_terms is not None:
            gs = gs + g_terms[i]
        if g_total is not None:
            gs = gs + g_total
        G[j] = gs * saved[S_F + j]
    den = saved[S_DEN:S_DEN + 3]
    rgb, op = G[RGB] / den[0], G[OPAC] / den[1]
    dl, sem = G[DIST] / den[1], G[SEM] / den[2]
    A = torch.zeros((3, 3), device=dev)
    B = torch.zeros(3, device=dev)
    if plan.clustering:
        three = _t(3.0, saved)
        k = saved[S_K:S_K + 3]
        c = saved[S_C:S_C + 9].view(3, 3)
        S = saved[S_S:S_S + 9].view(3, 3)
        r = saved[S_R:S_R + 3]
        SG = saved[S_SG:S_SG + 9].view(3, 3)
        sd = saved[S_SD:S_SD + 3]
        a_ort = G[ORT] / three
        a_cd = (G[CDOT] / three) / k
        a_cl = (G[CL1] / three) / k
        others = ((1, 0, 2, 1), (0, 0, 2, 2), (0, 1, 1, 2))
        Gc = []
        for j in range(3):
            b1, s1, b2, s2 = others[j]
            gc = a_ort * (sd[s1] * c[b1] + sd[s2] * c[b2])
            gc = gc - a_cd[j] * S[j]
            gc = gc - a_cl[j] * SG[j]
            if plan.snap:
                nc = saved[S_NCOND]
                a_cand, a_canl = G[CANDOT] / nc, G[CANL1] / nc
                can = _canonical(dev)
                for i in range(6):
                    cnd = saved[S_COND + 6 * j + i]
                    gc = gc + cnd * (a_canl * _sgn(c[j] - can[i])
                                     - a_cand * can[i])
            Gc.append(gc)
        Gc = torch.stack(Gc)
        ok = r > 0
        safe = torch.where(ok, r, torch.ones_like(r))
        dm = (Gc - c * dot3(c, Gc)[:, None]) / safe[:, None]
        dm = torch.where(ok[:, None], dm, torch.zeros_like(dm))
        A = dm / k[:, None] - a_cd[:, None] * c
        B = a_cl
    return Coef(rgb, op, dl, sem, A, B)


def member_grad(coef: Coef, saved, nm, code):
    """(T, 3): d of the loss by each (unflipped, masked) normal."""
    g = code.abs().to(torch.int64)
    gi = (g - 1).clamp(0, 2)
    flip = (code < 0)[:, None]
    nf = torch.where(flip, -nm, nm)
    c = saved[S_C:S_C + 9].view(3, 3)[gi]
    d = coef.A[gi] + coef.B[gi][:, None] * _sgn(nf - c)
    d = torch.where(flip, -d, d)
    return torch.where((g > 0)[:, None], d, torch.zeros_like(d))


def bwd_plain(plan: Plan, inp: Inputs, saved, code, g_terms, g_total,
              needs, rgb=None, opacity=None, dl=None, sem=None, depth=None,
              rays_o=None, rays_d=None):
    """loss_bwd: the gradient of each of GRAD_INPUTS that `needs` asks
    for, else None."""
    coef = coefficients(plan, saved, g_terms, g_total)
    out = [None] * len(GRAD_INPUTS)
    n, N = plan.n_sup, plan.n_rays
    if needs[0]:
        d = torch.zeros_like(rgb)
        e = rgb[:n] - inp.trgb
        d[:n] = coef.rgb * (e + e)
        out[0] = d
    if needs[1]:
        o = opacity + 1e-10
        out[1] = -(coef.op * (torch.log(o) + 1.0))
    if needs[2] and dl is not None:
        out[2] = coef.dl.expand(N).clone()
    if needs[3] and plan.n_cls:
        d = torch.zeros(sem.shape, device=sem.device)
        _, ok, q, logp = _sem_rows(sem[:n], inp.labels, plan.n_cls)
        ds = coef.sem * (torch.exp(logp) - q)
        d[:n] = torch.where(ok[:, None], ds, torch.zeros_like(ds))
        out[3] = d.to(sem.dtype)
    if any(needs[4:7]):
        dP = torch.zeros((N, 3), device=depth.device)
        if plan.clustering:
            u = plan.unsup
            tri = triangles_plain(rays_o[u:], rays_d[u:], depth[u:],
                                  inp.x123)
            nm, _ = masked(tri.n)
            dn = member_grad(coef, saved, nm, code)
            nd = dot3(tri.n, dn)
            dv = (dn - tri.n * nd[:, None]) / tri.r[:, None]
            da, db = cross3(tri.b, dv), cross3(dv, tri.a)
            per = torch.stack([-da - db, da, db], 1)
            # a triangle of no cluster adds nothing (K10 skips it)
            per = torch.where((code != 0)[:, None, None], per,
                              torch.zeros_like(per)).reshape(-1, 3)
            acc = torch.zeros((N - u, 3), device=depth.device)
            for w in range(inp.table.shape[1]):
                idx = inp.table[:, w].to(torch.int64)
                got = per[idx.clamp(min=0)]
                acc = acc + torch.where((idx >= 0)[:, None], got,
                                        torch.zeros_like(got))
            dP[u:] = acc
        if needs[4]:
            out[4] = dot3(dP, rays_d)
        if needs[5]:
            out[5] = dP
        if needs[6]:
            out[6] = dP * depth[:, None]
    return out


# ------------------------------------------------------------ the card
class _Args(ctypes.Structure):
    """csrc/loss_block.cu's Args, passed by value to each launcher."""
    _fields_ = [(k, ctypes.c_void_p) for k in (
        "rgb", "trgb", "op", "dl", "sem", "labels", "depth", "rays_o",
        "rays_d", "x1", "x2", "x3", "table", "assign", "cent3",
        "w_ort", "w_cdot", "w_cl1", "w_candot", "w_canl1", "in_window",
        "nm", "valid", "slots", "terms", "total", "mse", "saved", "member",
        "g_terms", "g_total", "d_rgb", "d_op", "d_dl", "d_sem", "d_depth",
        "d_o", "d_d")] + [
        (k, ctypes.c_int) for k in (
            "rgb_stride", "trgb_stride", "sem_stride", "labels64",
            "n_sup", "n_rays", "unsup", "n_tri", "n_cls", "table_w",
            "blocks", "discard", "snap", "clustering")] + [
        ("pos", ctypes.c_int * len(TERMS))] + [
        (k, ctypes.c_float) for k in ("w_op", "w_dist", "w_sem", "tres",
                                      "tres3")]



def _ptr(t, name, dtype, shape, dev) -> int:
    return kernels.check(t, name, dtype, shape, dev).value


def _rows(t, name, width, rows, dev):
    """A (rows, width) f32 view with unit column stride: its pointer and
    row stride."""
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"K10 {name}: {t.dtype} on {t.device}, expected "
                         f"f32 on {dev}")
    if t.dim() != 2 or t.shape[0] != rows or t.shape[1] != width \
            or (t.shape[0] > 1 and width and t.stride(1) != 1):
        raise ValueError(f"K10 {name}: shape {tuple(t.shape)} strides "
                         f"{t.stride()}, expected ({rows}, {width}) rows")
    return t.data_ptr(), t.stride(0)


def make_args(plan: Plan, inp: Inputs, rgb=None, opacity=None, dl=None,
              sem=None, depth=None, rays_o=None,
              rays_d=None) -> Tuple[_Args, torch.device]:
    """K10's arguments, every tensor checked (on one card, f32, the
    shapes of `plan`)."""
    if plan.items >= MAX_INDEX or plan.n_tri * 3 >= MAX_INDEX:
        raise ValueError(f"K10 indexes with 32-bit ints: {plan.items} rays, "
                         f"{plan.n_tri} triangles (ROADMAP B6c)")
    a = _Args()
    dev = opacity.device
    if dev.type != "cuda":
        raise ValueError(f"K10: expected CUDA tensors, got {dev}")
    f32 = torch.float32
    N, n = plan.n_rays, plan.n_sup
    a.rgb, a.rgb_stride = _rows(rgb, "rgb", 3, N, dev)
    a.trgb, a.trgb_stride = _rows(inp.trgb, "target rgb", 3, n, dev)
    a.op = _ptr(opacity, "opacity", f32, (N,), dev)
    if dl is not None:
        a.dl = _ptr(dl, "dl", f32, (N,), dev)
    if plan.n_cls:
        a.sem, a.sem_stride = _rows(sem, "sem", plan.n_cls, N, dev)
        if inp.labels.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"K10 labels: {inp.labels.dtype}, expected "
                             "int32 or int64")
        a.labels = _ptr(inp.labels, "labels", inp.labels.dtype, (n,), dev)
        a.labels64 = int(inp.labels.dtype == torch.int64)
    if plan.clustering:
        a.depth = _ptr(depth, "depth", f32, (N,), dev)
        a.rays_o = _ptr(rays_o, "rays_o", f32, (N, 3), dev)
        a.rays_d = _ptr(rays_d, "rays_d", f32, (N, 3), dev)
        for k, x in zip(("x1", "x2", "x3"), inp.x123):
            setattr(a, k, _ptr(x, k, torch.int64, (plan.n_tri,), dev))
        a.table = _ptr(inp.table, "table", torch.int32,
                       (N - plan.unsup, inp.table.shape[1]), dev)
        a.table_w = inp.table.shape[1]
        for k, w in zip(("w_ort", "w_cdot", "w_cl1", "w_candot", "w_canl1"),
                        inp.weights):
            setattr(a, k, _ptr(w, k, f32, (), dev))
        a.in_window = _ptr(inp.in_window, "in_window", f32, (), dev)
    for k in ("n_sup", "n_rays", "unsup", "n_tri", "n_cls", "discard",
              "snap", "clustering"):
        setattr(a, k, int(getattr(plan, k)))
    a.blocks = plan.blocks
    for j, name in enumerate(TERMS):
        a.pos[j] = plan.terms.index(name) if name in plan.terms else -1
    a.w_op, a.w_dist, a.w_sem = plan.w_op, plan.w_dist, plan.w_sem
    a.tres, a.tres3 = plan.tres, plan.tres * 3.0
    return a, dev


def _p(a):
    return ctypes.c_void_p(ctypes.addressof(a))


def rays_kernel(a: _Args, plan: Plan, dev):
    """loss_rays on the card: (normals (T, 3), valid (T,), slots)."""
    nm = torch.empty((plan.n_tri, 3), dtype=torch.float32, device=dev)
    valid = torch.empty(plan.n_tri, dtype=torch.bool, device=dev)
    slots = torch.empty((plan.blocks, NQ), dtype=torch.float32, device=dev)
    a.nm, a.valid, a.slots = (t.data_ptr() for t in (nm, valid, slots))
    kernels.LOSS_RAYS.launch(_p(a), device=dev)
    return nm, valid, slots


def clusters_kernel(a: _Args, plan: Plan, dev, clus):
    """loss_clusters on the card: (terms, total, mse, saved, codes)."""
    f32 = torch.float32
    terms = torch.empty(len(plan.terms), dtype=f32, device=dev)
    total, mse = (torch.empty((), dtype=f32, device=dev) for _ in range(2))
    saved = torch.empty(SAVED, dtype=f32, device=dev)
    code = torch.empty(plan.n_tri, dtype=torch.int8, device=dev)
    if clus is not None:
        a.assign = _ptr(clus.assign_new, "assign", torch.int64,
                        (plan.n_tri,), dev)
        a.cent3 = _ptr(clus.centroids3, "centroids3", f32, (3, 3), dev)
    a.terms, a.total, a.mse, a.saved, a.member = (
        t.data_ptr() for t in (terms, total, mse, saved, code))
    kernels.LOSS_CLUSTERS.launch(_p(a), device=dev)
    return terms, total, mse, saved, code


def bwd_kernel(a: _Args, plan: Plan, dev, saved, code, g_terms, g_total,
               needs, shapes):
    """loss_bwd on the card: the gradients `needs` asks for."""
    f32 = torch.float32
    a.saved = _ptr(saved, "saved", f32, (SAVED,), dev)
    a.member = _ptr(code, "member", torch.int8, (plan.n_tri,), dev)
    # kept until the launch: a temporary's memory could be handed out again
    g_terms = None if g_terms is None else g_terms.contiguous()
    g_total = None if g_total is None else g_total.contiguous()
    a.g_terms = (None if g_terms is None else
                 _ptr(g_terms, "g_terms", f32, (len(plan.terms),), dev))
    a.g_total = (None if g_total is None else
                 _ptr(g_total, "g_total", f32, (), dev))
    names = ("d_rgb", "d_op", "d_dl", "d_sem", "d_depth", "d_o", "d_d")
    out = [None] * len(names)
    for i, (name, shape) in enumerate(zip(names, shapes)):
        setattr(a, name, None)
        if needs[i] and shape is not None:
            out[i] = torch.empty(shape, dtype=f32, device=dev)
            setattr(a, name, out[i].data_ptr())
    kernels.LOSS_BWD.launch(_p(a), device=dev)
    return out


GRAD_INPUTS = ("rgb", "opacity", "dl", "sem", "depth", "rays_o", "rays_d")


# ------------------------------------------------------------ the Function
class LossBlock(torch.autograd.Function):
    """(terms, total, mse) of the block; its backward is loss_bwd."""

    @staticmethod
    def forward(ctx, plan: Plan, inp: Inputs, rgb, opacity, dl, sem, depth,
                rays_o, rays_d):
        ctx.set_materialize_grads(False)
        xs = (rgb, opacity, dl, sem, depth, rays_o, rays_d)
        xs = tuple(None if x is None else x.detach() for x in xs)
        on_card = opacity.is_cuda
        if on_card:
            a, dev = make_args(plan, inp, *xs)
            nm, valid, slots = rays_kernel(a, plan, dev)
        else:
            nm, valid, slots = rays_plain(plan, inp, *xs)
        clus = None
        if plan.clustering:
            clus = normals_clustering(
                nm, valid, K=plan.K, niter=plan.niter,
                t_similar=1.0 - plan.tres, init_idx=inp.kmeans_init,
                generator=inp.generator)
        if on_card:
            terms, total, mse, saved, code = clusters_kernel(a, plan, dev,
                                                             clus)
            ctx.args = a
        else:
            terms, total, mse, saved, code = clusters_plain(
                plan, inp, nm, None if clus is None else clus.assign_new,
                None if clus is None else clus.centroids3, slots)
        ctx.plan, ctx.inp, ctx.on_card = plan, inp, on_card
        ctx.save_for_backward(saved, code, *xs)
        ctx.mark_non_differentiable(mse)
        return terms, total, mse

    @staticmethod
    def backward(ctx, g_terms, g_total, _g_mse):
        saved, code, *xs = ctx.saved_tensors
        needs = ctx.needs_input_grad[2:]
        none = [None] * len(GRAD_INPUTS)
        if (g_terms is None and g_total is None) or not any(needs):
            return (None, None, *none)
        plan = ctx.plan
        if ctx.on_card:
            shapes = [None if x is None else tuple(x.shape) for x in xs]
            out = bwd_kernel(ctx.args, plan, saved.device, saved, code,
                             g_terms, g_total, needs, shapes)
        else:
            out = bwd_plain(plan, ctx.inp, saved, code, g_terms, g_total,
                            needs, *xs)
        return (None, None, *out)


def loss_block(plan: Plan, inp: Inputs, rgb=None, opacity=None, dl=None,
               sem=None, depth=None, rays_o=None, rays_d=None):
    """K10 on CUDA tensors (three launches and K7: it reads nothing on the
    host; a failed check or launch raises), its plain version on CPU
    ones. Returns ({term: 0-dim tensor} in TERMS' order, their total, the
    rgb mean before its guard (no gradient))."""
    terms, total, mse = LossBlock.apply(plan, inp, rgb, opacity, dl, sem,
                                        depth, rays_o, rays_d)
    return dict(zip(plan.terms, terms.unbind(0))), total, mse
