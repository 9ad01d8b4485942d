"""Occupancy-bitfield ray marching on the dense (N, K) training layout.

Port of the JAX package's `ops/ray_march.py` for the bootstrap march of
the first `bootstrap_steps` training steps: a uniform step grid
(exp_step_factor 0), one cascade, every step probed. The supervoxel-run
march that takes over afterwards is ROADMAP K1.

`march_rays_train_dense` launches kernel H1 (`csrc/march.cu`) for CUDA
tensors and runs `march_rays_train_dense_plain`, the same function in
plain PyTorch, for CPU tensors.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels
from .packbits import unpack_bit

SQRT3 = math.sqrt(3.0)


def calc_dt(t, exp_step_factor, max_samples, grid_size, scale):
    """reference: models/csrc/raymarching.cu:11-13 (CUDA clamp: lo wins
    when lo > hi)."""
    lo = SQRT3 / max_samples
    hi = SQRT3 * 2.0 * scale / grid_size
    return torch.clamp(torch.clamp(t * exp_step_factor, max=hi), min=lo)


def t_step_grid(t0, n_steps, *, exp_step_factor, max_samples, grid_size,
                scale):
    """Closed-form t_k of the stepping recurrence t_{k+1} = t_k +
    calc_dt(t_k), k in [0, n_steps): (N,) -> (N, n_steps)."""
    lo = SQRT3 / max_samples
    hi = SQRT3 * 2.0 * scale / grid_size
    f = exp_step_factor
    k = torch.arange(n_steps, dtype=torch.float32, device=t0.device)[None, :]
    t0 = t0[:, None]
    if f == 0.0 or lo >= hi:
        return t0 + k * lo
    A, B = lo / f, hi / f
    t0s = torch.clamp(t0, min=0.0)
    kA = torch.where(t0s <= A, torch.floor((A - t0s) / lo) + 1.0,
                     torch.zeros_like(t0s))
    tA = t0s + kA * lo
    ratio = 1.0 + f
    jB = torch.where(
        tA <= B,
        torch.floor(torch.log(B / torch.clamp(tA, min=1e-30))
                    / math.log(ratio)) + 1.0,
        torch.zeros_like(tA))
    tB = tA * torch.pow(ratio, jB)
    j = k - kA
    t_geo = tA * torch.pow(ratio, torch.clamp(j, min=0.0))
    t_lin_hi = tB + (j - jB) * hi
    return torch.where(k <= kA, t0s + k * lo,
                       torch.where(j <= jB, t_geo, t_lin_hi))


def occupancy_lookup(xyz, bitfield, *, cascades, scale, grid_size):
    """Occupancy bit at (..., 3) positions, single-cascade form
    (linear x-fastest cell index, ray_march.py:80-87)."""
    if cascades != 1:
        raise NotImplementedError(
            "multi-cascade occupancy lookup is not ported (ROADMAP A13)")
    G = grid_size
    mip_bound = min(0.5, scale)
    cell = torch.clamp(0.5 * (xyz / mip_bound + 1.0) * G, 0.0,
                       G - 1.0).to(torch.int64)
    idx = (cell[..., 2] * G + cell[..., 1]) * G + cell[..., 0]
    return unpack_bit(bitfield, idx)


def select_first_k(include, k: int):
    """Per-row indices of the first `k` True entries of (N, S) `include`:
    returns (idx (N, k) ascending, valid (N, k))."""
    S = include.shape[-1]
    col = torch.arange(S, device=include.device).expand_as(include)
    score = torch.where(include, S - col, torch.zeros_like(col))
    v, idx = torch.topk(score, k, dim=-1, sorted=True)
    return idx, v > 0


def stratified_budget(include, K: int, tail_k: int):
    """First K - tail_k occupied steps verbatim plus tail_k evenly
    strided by occupied rank over the rest (ray_march.py:295-338).
    Returns (sel (N, S) bool, span (N, S) int64 >= 1)."""
    cnt = torch.cumsum(include.to(torch.int64), dim=-1)
    ones = torch.ones_like(cnt)
    if tail_k <= 0:
        return include & (cnt <= K), ones
    K1 = max(K - tail_k, 0)
    K2 = tail_k
    M = cnt[:, -1:]
    E = torch.clamp(M - K1, min=0)
    x = cnt - K1
    Es = torch.clamp(E, min=1)
    jstar = -torch.div(-x * K2, Es, rounding_mode="floor")
    sel_even = torch.div(jstar * Es, K2, rounding_mode="floor") == x
    span_even = x - torch.div((jstar - 1) * Es, K2, rounding_mode="floor")
    exact = E <= K2
    in_tail = include & (x >= 1)
    sel = (include & (cnt <= K1)) | (in_tail & (exact | sel_even))
    span = torch.where(in_tail & ~exact & sel_even, span_even, ones)
    return sel, span


def rank_targets(m_tot, K: int, tail_k: int):
    """Closed-form 1-based occupied rank held by each of the K slots and
    its represented span (ray_march.py:341-373): (N,) -> (N, K) x2."""
    N = m_tot.shape[0]
    i = torch.arange(K, dtype=torch.int64, device=m_tot.device)[None, :]
    ones = torch.ones((N, K), dtype=torch.int64, device=m_tot.device)
    if tail_k <= 0:
        return (i + 1).expand(N, K), ones
    K1, K2 = max(K - tail_k, 0), tail_k
    E = torch.clamp(m_tot.to(torch.int64) - K1, min=0)[:, None]
    j = i - K1 + 1
    exact = E <= K2
    tgt_even = torch.div(j * E, K2, rounding_mode="floor")
    tgt_prev = torch.div((j - 1) * E, K2, rounding_mode="floor")
    tail_tgt = K1 + torch.where(exact, j, tgt_even)
    tail_span = torch.where(exact, torch.ones_like(tgt_even),
                            tgt_even - tgt_prev)
    targets = torch.where(i < K1, i + 1, tail_tgt)
    span = torch.clamp(torch.where(i < K1, ones, tail_span), min=1)
    return targets, span


class DenseMarchResult(NamedTuple):
    """Per-ray dense (N, K) sample buffers."""
    t: torch.Tensor          # (N, K) sample distances
    dt: torch.Tensor         # (N, K) integration steps (x span)
    valid: torch.Tensor      # (N, K) bool
    ray_count: torch.Tensor  # (N,) int32 samples per ray
    rm_samples: torch.Tensor  # () int32 selected samples of the batch
    trunc_rays: torch.Tensor  # () int32, 0: this march enumerates all


def _uniform_step(exp_step_factor, max_samples, grid_size, scale) -> float:
    lo = SQRT3 / max_samples
    hi = SQRT3 * 2.0 * scale / grid_size
    if not (exp_step_factor == 0.0 or lo >= hi):
        raise NotImplementedError(
            "the port's march takes a uniform step grid only "
            "(exp_step_factor 0); the geometric grid is ROADMAP A13")
    return lo


def march_rays_train_dense_plain(rays_o, rays_d, hits_t, bitfield, noise, *,
                                 cascades, scale, exp_step_factor, grid_size,
                                 max_samples, samples_per_ray, march_steps=0,
                                 tail_k=0) -> DenseMarchResult:
    """Plain PyTorch version of H1: the JAX algorithm as written
    (ray_march.py:446-516): the (N, S) step grid, one probe per step,
    stratified_budget and select_first_k."""
    S = march_steps or max_samples
    K = min(samples_per_ray, S)
    _uniform_step(exp_step_factor, max_samples, grid_size, scale)
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    dt0 = calc_dt(t1, exp_step_factor, max_samples, grid_size, scale)
    t0 = t1 + dt0 * noise
    tg = t_step_grid(t0, S, exp_step_factor=exp_step_factor,
                     max_samples=max_samples, grid_size=grid_size,
                     scale=scale)
    dtg = calc_dt(tg, exp_step_factor, max_samples, grid_size, scale)
    xyz = rays_o[:, None, :] + tg[..., None] * rays_d[:, None, :]
    occ = occupancy_lookup(xyz, bitfield, cascades=cascades, scale=scale,
                           grid_size=grid_size)
    include = occ & (t1 >= 0)[:, None] & (tg < t2[:, None])
    sel, span = stratified_budget(include, K, tail_k)
    rm_samples = sel.sum().to(torch.int32)
    idx, valid = select_first_k(sel, K)
    zero = torch.zeros((), dtype=tg.dtype, device=tg.device)
    t_k = torch.where(valid, torch.gather(tg, 1, idx), zero)
    dt_k = torch.where(valid, torch.gather(dtg, 1, idx), zero)
    if tail_k > 0:
        dt_k = dt_k * torch.gather(span, 1, idx).to(dt_k.dtype)
    ray_count = valid.sum(dim=-1).to(torch.int32)
    return DenseMarchResult(t_k, dt_k, valid, ray_count, rm_samples,
                            torch.zeros((), dtype=torch.int32,
                                        device=tg.device))


def _march_kernel(rays_o, rays_d, hits_t, bitfield, noise, *, cascades,
                  scale, exp_step_factor, grid_size, max_samples,
                  samples_per_ray, march_steps, tail_k) -> DenseMarchResult:
    if cascades != 1:
        raise NotImplementedError(
            "the march kernel takes one cascade (ROADMAP A13)")
    lo = _uniform_step(exp_step_factor, max_samples, grid_size, scale)
    N = rays_o.shape[0]
    S = march_steps or max_samples
    K = min(samples_per_ray, S)
    dev = rays_o.device
    f32 = torch.float32
    args = [
        kernels.check(rays_o, "rays_o", f32, (N, 3), dev),
        kernels.check(rays_d, "rays_d", f32, (N, 3), dev),
        kernels.check(hits_t, "hits_t", f32, (N, 2), dev),
        kernels.check(bitfield, "bitfield", torch.uint8,
                      (grid_size ** 3 // 8,), dev),
        kernels.check(noise, "noise", f32, (N,), dev),
    ]
    t = torch.empty((N, K), dtype=f32, device=dev)
    dt = torch.empty((N, K), dtype=f32, device=dev)
    valid = torch.empty((N, K), dtype=torch.bool, device=dev)
    count = torch.empty((N,), dtype=torch.int32, device=dev)
    rm = torch.zeros((1,), dtype=torch.int32, device=dev)
    if N > 0:
        kernels.MARCH.launch(
            *args, N, S, K, tail_k, grid_size, lo, min(0.5, scale),
            kernels.ptr(t), kernels.ptr(dt), kernels.ptr(valid),
            kernels.ptr(count), kernels.ptr(rm), device=dev)
    return DenseMarchResult(t, dt, valid, count, rm[0],
                            torch.zeros((), dtype=torch.int32, device=dev))


def march_rays_train_dense(rays_o, rays_d, hits_t, bitfield, noise, *,
                           cascades, scale, exp_step_factor, grid_size,
                           max_samples, samples_per_ray, march_steps=0,
                           tail_k=0) -> DenseMarchResult:
    """March N rays into K dense samples each (the bootstrap form of the
    JAX `march_rays_train_dense` with coarse_occ=None).

    rays_o, rays_d: (N, 3) f32; hits_t: (N, 2) box interval (-1 on miss);
    bitfield: (G^3/8,) uint8; noise: (N,) first-step jitter in [0, 1).
    """
    fn = _march_kernel if rays_o.is_cuda else march_rays_train_dense_plain
    return fn(rays_o, rays_d, hits_t, bitfield, noise, cascades=cascades,
              scale=scale, exp_step_factor=exp_step_factor,
              grid_size=grid_size, max_samples=max_samples,
              samples_per_ray=samples_per_ray, march_steps=march_steps,
              tail_k=tail_k)
