"""Occupancy ray marching — port of the JAX package's `ops/ray_march.py`:

  * `march_rays_train_bootstrap`: the bootstrap march of the first
    `bootstrap_steps` training steps, every step probed in the bitfield;
    kernel H1 (`csrc/march_fine.cu`, a launcher of H9's body);
  * `march_rays_train_dense`: the bitfield march over `march_block` steps,
    optionally two-level through the coarse mask; kernel H9
    (`csrc/march_fine.cu`, a warp per ray, the port of the Pallas bit
    probe P2);
  * `march_rays_test_round_dense` and `march_rays_test_round_window`:
    bitfield test rounds, the full window or its first K occupied steps;
    kernel H10 (same file);
  * `compact_samples`, `march_rays_train` and `march_rays_test_round`:
    the flat ray-major layout; kernel H11 (same file);
  * `march_rays_train_dense_sv`: the supervoxel-run ("sv") march of the
    later training steps, and `march_rays_test_round_sv`, one round of
    the held-out renderer; kernel K1 (`csrc/march_sv.cu`), both on
    `sv_scan_plain`'s algorithm.

Each launches its kernel for CUDA tensors and runs its `*_plain` version,
the same function in plain PyTorch, for CPU tensors. The bitfield marches
(H1, H9, H10) take any scene scale: past 0.5 several cascades
(`cell_index`) and the geometric step grid (`t_step_grid`); the sv march
(K1) takes one cascade and a uniform grid, as JAX's (`rendering.uses_sv`).
"""
from __future__ import annotations

import math
from typing import Dict, List, NamedTuple, Tuple

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


def step_phases(t0, *, exp_step_factor, max_samples, grid_size, scale):
    """The phase bounds of the geometric grid from each t0 (JAX's
    ray_march.py:122-137 operation for operation): t0s = max(t0, 0), kA
    steps of lo to tA (while t <= A = lo/f), then jB geometric steps of
    ratio 1 + f to tB (while t <= B = hi/f). Every division rounds once,
    as JAX's: by a Python scalar through `_div`, and B / tA as a tensor
    division (`_over`). Returns (t0s, kA, tA, jB, tB), each t0's shape."""
    lo = SQRT3 / max_samples
    hi = SQRT3 * 2.0 * scale / grid_size
    f = exp_step_factor
    A, B = lo / f, hi / f
    t0s = torch.clamp(t0, min=0.0)
    zero = torch.zeros_like(t0s)
    kA = torch.where(t0s <= A, torch.floor(_div(A - t0s, lo)) + 1.0, zero)
    tA = t0s + kA * lo
    ratio = 1.0 + f
    jB = torch.where(
        tA <= B,
        torch.floor(_div(torch.log(_over(B, torch.clamp(tA, min=1e-30))),
                         math.log(ratio))) + 1.0,
        zero)
    return t0s, kA, tA, jB, tA * torch.pow(ratio, jB)


def t_step_grid(t0, n_steps, *, exp_step_factor, max_samples, grid_size,
                scale):
    """Closed-form t_k of the stepping recurrence t_{k+1} = t_k +
    calc_dt(t_k), k in [0, n_steps): (N,) -> (N, n_steps). JAX's
    ray_march.py:99-143: steps of lo while t <= A, geometric while t <= B,
    then steps of hi (`step_phases`); f == 0 or lo >= hi: steps of lo."""
    lo = SQRT3 / max_samples
    hi = SQRT3 * 2.0 * scale / grid_size
    f = exp_step_factor
    k = torch.arange(n_steps, dtype=torch.float32, device=t0.device)[None, :]
    if f == 0.0 or lo >= hi:
        return t0[:, None] + k * lo
    t0s, kA, tA, jB, tB = (x[:, None] for x in step_phases(
        t0, exp_step_factor=f, max_samples=max_samples, grid_size=grid_size,
        scale=scale))
    j = k - kA
    t_geo = tA * torch.pow(1.0 + f, torch.clamp(j, min=0.0))
    t_lin_hi = tB + (j - jB) * hi
    return torch.where(k <= kA, t0s + k * lo,
                       torch.where(j <= jB, t_geo, t_lin_hi))


def _div(x, s: float):
    """x / s with one rounding on any device. PyTorch's CUDA kernel
    divides by a Python scalar as a product with its reciprocal, a
    rounding more, which can move the ceil of a quotient by a step, or a
    position across a cell face, off the kernels' `__fdiv_rn` (K1, H9,
    H10) and the CPU's and JAX's division; a 0-dim tensor on x's device
    is divided by as such."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _over(s: float, x):
    """s / x with one rounding: PyTorch evaluates a Python scalar over a
    tensor as x's reciprocal times s."""
    return torch.full((), s, dtype=x.dtype, device=x.device) / x


def _mip_from_pos(xyz, cascades):
    """reference: models/csrc/raymarching.cu:19-23 (the frexp exponent of
    the largest |coordinate|, plus 1), as ray_march.py:54-58."""
    mx = torch.amax(torch.abs(xyz), dim=-1)
    return torch.clamp(torch.frexp(mx).exponent + 1, 0, cascades - 1)


def _mip_from_dt(dt, grid_size, cascades):
    """reference: models/csrc/raymarching.cu:29-32, as ray_march.py:61-64."""
    return torch.clamp(torch.frexp(dt * grid_size).exponent, 0, cascades - 1)


def cell_index(xyz, *, cascades, scale, grid_size, dt=None):
    """The bitfield index of the cell holding each (..., 3) position
    (ray_march.py:67-96): linear x-fastest within a cascade, cascade `mip`
    from bit mip * G^3. One cascade: mip 0 and x / min(0.5, scale).
    Several: the step sizes `dt` (...) must be given; mip is the larger of
    the position's and the step's, and the cell is x times the rounded
    reciprocal of min(2^(mip-1), scale), as JAX computes it (at scale 0.75
    that product is not the quotient)."""
    G = grid_size
    if cascades == 1:
        mip_bound = min(0.5, scale)
        cell = torch.clamp(0.5 * (_div(xyz, mip_bound) + 1.0) * G, 0.0,
                           G - 1.0).to(torch.int64)
        return (cell[..., 2] * G + cell[..., 1]) * G + cell[..., 0]
    if dt is None:
        raise ValueError(f"the cell lookup at {cascades} cascades needs the "
                         "step sizes dt (the mip depends on them)")
    mip = torch.maximum(_mip_from_pos(xyz, cascades),
                        _mip_from_dt(dt, G, cascades)).to(torch.int64)
    # 2^(mip-1) exactly, with nothing read from the host
    mip_bound = torch.clamp((torch.ones_like(mip) << mip).to(xyz.dtype) * 0.5,
                            max=scale)
    inv_b = _over(1.0, mip_bound)[..., None]
    cell = torch.clamp(0.5 * (xyz * inv_b + 1.0) * G, 0.0,
                       G - 1.0).to(torch.int64)
    return ((mip * G + cell[..., 2]) * G + cell[..., 1]) * G + cell[..., 0]


def occupancy_lookup(xyz, bitfield, *, cascades, scale, grid_size, dt=None):
    """Occupancy bit at (..., 3) positions: the bit of `cell_index` in the
    (cascades * G^3 / 8,) bitfield."""
    return unpack_bit(bitfield, cell_index(
        xyz, cascades=cascades, scale=scale, grid_size=grid_size, dt=dt))


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


# The geometric grid's powers (1 + f)^j, one table a (device, f), with at
# least the entries of the fine march's 1024 steps (`pow_table_len`).
POW_TABLE_MIN = 1025
_pow_tables: Dict[Tuple[torch.device, float], torch.Tensor] = {}
_pow_retired: List[torch.Tensor] = []


def pow_table_len(n_steps: int) -> int:
    """Entries of (1 + f)^j that H1, H9 and H10 read over `n_steps` steps:
    j up to the last lane of the last chunk of 32 steps, and one more (H10's
    cursor reads step n_steps)."""
    return 32 * -(-n_steps // 32) + 1


def pow_table(exp_step_factor: float, n: int, device) -> torch.Tensor:
    """(1 + f)^j for j = 0..n-1 at least, f32 on `device`: torch.pow of
    the Python scalar 1 + f over an arange, the expression `t_step_grid`
    evaluates over j, so that on the card each entry is the plain
    version's power of the same j. One table a (device, f), built at its
    first use and kept; a longer request replaces it for later calls and
    the old one is kept, since a captured CUDA graph reads the table its
    capture saw. It is built outside a capture (the trainer's eager steps
    come first); a first use inside one raises."""
    device = torch.device(device)
    key = (device, float(exp_step_factor))
    tab = _pow_tables.get(key)
    if tab is None or tab.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "the step grid's table of powers is built on its first use, "
                "which must come before a CUDA graph capture")
        if tab is not None:
            _pow_retired.append(tab)
        k = torch.arange(max(n, POW_TABLE_MIN), dtype=torch.float32,
                         device=device)
        tab = torch.pow(1.0 + exp_step_factor, k)
        _pow_tables[key] = tab
    return tab


def step_args(cascades, exp_step_factor, max_samples, grid_size, scale,
              n_steps, device) -> list:
    """The step grid's arguments of H1, H9 and H10 (`csrc/march_fine.cu`)
    over `n_steps` steps: lo, min(0.5, scale), cascades, then
    t_step_grid's constants as Python doubles, which ctypes rounds to f32
    as JAX rounds its weak scalars: f (0 where the grid is uniform: f 0 or
    lo >= hi, where calc_dt is lo either way), hi, A = lo/f, B = hi/f,
    1 + f, log(1 + f) and scale; last the pointer to `pow_table` on
    `device` and its length (None and 0 where f is 0)."""
    lo = SQRT3 / max_samples
    hi = SQRT3 * 2.0 * scale / grid_size
    f = exp_step_factor if exp_step_factor != 0.0 and lo < hi else 0.0
    A, B = (lo / f, hi / f) if f else (0.0, 0.0)
    tab = pow_table(f, pow_table_len(n_steps), device) if f else None
    return [lo, min(0.5, scale), cascades, f, hi, A, B, 1.0 + f,
            math.log(1.0 + f), scale,
            kernels.ptr(tab) if f else None, tab.numel() if f else 0]


def coarse_lookup(xyz, coarse_occ, *, scale, grid_size):
    """Dilated supervoxel occupancy probe of cascade 0
    (ray_march.py:376-391): the cell formula of `occupancy_lookup` at
    resolution G/8 (not the fine cell >> 3: the two differ at cell
    boundaries)."""
    Gc = grid_size // 8
    mip_bound = min(0.5, scale)
    cell = torch.clamp(0.5 * (_div(xyz, mip_bound) + 1.0) * Gc, 0.0,
                       Gc - 1.0).to(torch.int64)
    idx = (cell[..., 2] * Gc + cell[..., 1]) * Gc + cell[..., 0]
    return coarse_occ[idx] > 0


# Steps per coarse block (ray_march.py:394-399): the probe at a block's
# first step covers its 4 steps through the mask's one-supervoxel dilation.
COARSE_BLOCK = 4
# H9 keeps a warp's candidate-block bits in shared memory: 32 words, so
# the two-level march takes S <= 4 * 32 * 32 steps.
COARSE_MAX_STEPS = 4096


def _coarse_blocks(coarse_occ, cascades, S, K, coarse_k_blocks):
    """KB, the candidate blocks the two-level march probes finely
    (ray_march.py:461-463), or 0 when it does not apply."""
    if coarse_occ is None or cascades != 1 or S % COARSE_BLOCK:
        return 0
    return min(coarse_k_blocks or max(2 * K // COARSE_BLOCK, 8),
               S // COARSE_BLOCK)


def march_rays_train_dense_plain(rays_o, rays_d, hits_t, bitfield, noise, *,
                                 cascades, scale, exp_step_factor, grid_size,
                                 max_samples, samples_per_ray, march_steps=0,
                                 coarse_occ=None, coarse_k_blocks=0,
                                 tail_k=0) -> DenseMarchResult:
    """Plain PyTorch version of H1 and H9: the JAX algorithm as written
    (ray_march.py:446-516): the (N, S) step grid, with `coarse_occ` the
    coarse probe of each block's first step and the first KB candidate
    blocks kept, one fine probe per kept step, stratified_budget and
    select_first_k."""
    N = rays_o.shape[0]
    S = march_steps or max_samples
    K = min(samples_per_ray, S)
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    dt0 = calc_dt(t1, exp_step_factor, max_samples, grid_size, scale)
    t0 = t1 + dt0 * noise
    tg = t_step_grid(t0, S, exp_step_factor=exp_step_factor,
                     max_samples=max_samples, grid_size=grid_size,
                     scale=scale)

    def in_range(t):
        return (t1 >= 0)[:, None] & (t < t2[:, None])

    KB = _coarse_blocks(coarse_occ, cascades, S, K, coarse_k_blocks)
    gate = True
    if KB:
        BS = COARSE_BLOCK
        tgc = tg[:, ::BS]
        xyz_c = rays_o[:, None, :] + tgc[..., None] * rays_d[:, None, :]
        cand = coarse_lookup(xyz_c, coarse_occ, scale=scale,
                             grid_size=grid_size) & in_range(tgc)
        bidx, bval = select_first_k(cand, KB)
        n_cand_extra = cand.sum(-1) - bval.sum(-1)
        cols = (bidx[:, :, None] * BS
                + torch.arange(BS, device=tg.device)[None, None, :]
                ).reshape(N, KB * BS)
        gate = bval.repeat_interleave(BS, dim=1)
        tg = torch.gather(tg, 1, cols)
    dtg = calc_dt(tg, exp_step_factor, max_samples, grid_size, scale)
    xyz = rays_o[:, None, :] + tg[..., None] * rays_d[:, None, :]
    occ = occupancy_lookup(xyz, bitfield, cascades=cascades, scale=scale,
                           grid_size=grid_size, dt=dtg)
    include = occ & gate & in_range(tg)
    sel, span = stratified_budget(include, K, tail_k)
    rm_samples = sel.sum().to(torch.int32)
    idx, valid = select_first_k(sel, min(K, include.shape[1]))
    zero = torch.zeros((), dtype=tg.dtype, device=tg.device)
    t_k = torch.where(valid, torch.gather(tg, 1, idx), zero)
    dt_k = torch.where(valid, torch.gather(dtg, 1, idx), zero)
    if tail_k > 0:
        dt_k = dt_k * torch.gather(span, 1, idx).to(dt_k.dtype)
    ray_count = valid.sum(dim=-1).to(torch.int32)
    if not KB:
        trunc = torch.zeros((), dtype=torch.int32, device=tg.device)
    elif tail_k > 0:
        # any skipped candidate block biases the stratified tail
        trunc = (n_cand_extra > 0).sum().to(torch.int32)
    else:
        # first-K: only under-filled rays lost samples
        trunc = ((ray_count < K) & (n_cand_extra > 0)).sum().to(torch.int32)
    return DenseMarchResult(t_k, dt_k, valid, ray_count, rm_samples, trunc)


def _march_inputs(rays_o, rays_d, hits_t, bitfield, noise, cascades,
                  grid_size):
    N, dev, f32 = rays_o.shape[0], rays_o.device, torch.float32
    return N, [
        kernels.check(rays_o, "rays_o", f32, (N, 3), dev),
        kernels.check(rays_d, "rays_d", f32, (N, 3), dev),
        kernels.check(hits_t, "hits_t", f32, (N, 2), dev),
        _bitfield_arg(bitfield, cascades, grid_size, dev),
        kernels.check(noise, "noise", f32, (N,), dev),
    ]


def _bitfield_arg(bitfield, cascades, grid_size, dev):
    """The (cascades * G^3 / 8,) bitfield; H1, H9 and H10 read it as 32-bit
    words."""
    p = kernels.check(bitfield, "bitfield", torch.uint8,
                      (cascades * grid_size ** 3 // 8,), dev)
    if bitfield.data_ptr() % 4:
        raise ValueError("bitfield: the march kernels read 32-bit words; "
                         "its storage must be 4-byte aligned")
    return p


def _march_bootstrap_kernel(rays_o, rays_d, hits_t, bitfield, noise, *,
                            cascades, scale, exp_step_factor, grid_size,
                            max_samples, samples_per_ray, march_steps,
                            tail_k) -> DenseMarchResult:
    S = march_steps or max_samples
    K = min(samples_per_ray, S)
    N, args = _march_inputs(rays_o, rays_d, hits_t, bitfield, noise,
                            cascades, grid_size)
    dev, f32 = rays_o.device, torch.float32
    t = torch.empty((N, K), dtype=f32, device=dev)
    dt = torch.empty((N, K), dtype=f32, device=dev)
    valid = torch.empty((N, K), dtype=torch.bool, device=dev)
    count = torch.empty((N,), dtype=torch.int32, device=dev)
    rm = torch.zeros((1,), dtype=torch.int32, device=dev)
    if N > 0:
        kernels.MARCH.launch(
            *args, N, S, K, tail_k, grid_size,
            *step_args(cascades, exp_step_factor, max_samples, grid_size,
                       scale, S, dev),
            kernels.ptr(t), kernels.ptr(dt), kernels.ptr(valid),
            kernels.ptr(count), kernels.ptr(rm), device=dev)
    return DenseMarchResult(t, dt, valid, count, rm[0],
                            torch.zeros((), dtype=torch.int32, device=dev))


def march_rays_train_bootstrap(rays_o, rays_d, hits_t, bitfield, noise, *,
                               cascades, scale, exp_step_factor, grid_size,
                               max_samples, samples_per_ray, march_steps=0,
                               tail_k=0) -> DenseMarchResult:
    """The bootstrap march of the first `bootstrap_steps` training steps
    (rendering.py:166-176): `march_rays_train_dense` without the coarse
    mask, at S_boot coarse steps; kernel H1 (H9's body, a warp per ray).

    rays_o, rays_d: (N, 3) f32; hits_t: (N, 2) box interval (-1 on miss);
    bitfield: (G^3/8,) uint8; noise: (N,) first-step jitter in [0, 1).
    """
    fn = (_march_bootstrap_kernel if rays_o.is_cuda
          else march_rays_train_dense_plain)
    return fn(rays_o, rays_d, hits_t, bitfield, noise, cascades=cascades,
              scale=scale, exp_step_factor=exp_step_factor,
              grid_size=grid_size, max_samples=max_samples,
              samples_per_ray=samples_per_ray, march_steps=march_steps,
              tail_k=tail_k)


def _march_fine_kernel(rays_o, rays_d, hits_t, bitfield, noise, *, cascades,
                       scale, exp_step_factor, grid_size, max_samples,
                       samples_per_ray, march_steps, coarse_occ,
                       coarse_k_blocks, tail_k) -> DenseMarchResult:
    S = march_steps or max_samples
    K = min(samples_per_ray, S)
    KB = _coarse_blocks(coarse_occ, cascades, S, K, coarse_k_blocks)
    N, args = _march_inputs(rays_o, rays_d, hits_t, bitfield, noise,
                            cascades, grid_size)
    dev, f32 = rays_o.device, torch.float32
    if KB:
        if grid_size % 8 or S > COARSE_MAX_STEPS:
            raise ValueError(f"the two-level march kernel takes G % 8 == 0 "
                             f"and S <= {COARSE_MAX_STEPS}; got G "
                             f"{grid_size}, S {S}")
        args.append(kernels.check(coarse_occ, "coarse_occ", torch.uint8,
                                  ((grid_size // 8) ** 3,), dev))
    else:
        args.append(None)
    Kout = min(K, KB * COARSE_BLOCK) if KB else K
    t = torch.empty((N, Kout), dtype=f32, device=dev)
    dt = torch.empty((N, Kout), dtype=f32, device=dev)
    valid = torch.empty((N, Kout), dtype=torch.bool, device=dev)
    count = torch.empty((N,), dtype=torch.int32, device=dev)
    sums = torch.zeros((2,), dtype=torch.int32, device=dev)  # rm, trunc
    if N > 0:
        kernels.MARCH_FINE_TRAIN.launch(
            *args, N, S, K, Kout, tail_k, grid_size, KB,
            *step_args(cascades, exp_step_factor, max_samples, grid_size,
                       scale, S, dev),
            kernels.ptr(t), kernels.ptr(dt), kernels.ptr(valid),
            kernels.ptr(count), kernels.ptr(sums), device=dev)
    return DenseMarchResult(t, dt, valid, count, sums[0], sums[1])


def march_rays_train_dense(rays_o, rays_d, hits_t, bitfield, noise, *,
                           cascades, scale, exp_step_factor, grid_size,
                           max_samples, samples_per_ray, march_steps=0,
                           coarse_occ=None, coarse_k_blocks=0,
                           tail_k=0) -> DenseMarchResult:
    """March N rays into K dense samples each: every one of the S =
    march_steps steps of sqrt(3)/max_samples probed in the bitfield (the
    JAX `march_rays_train_dense`); kernel H9 (one warp per ray).

    With `coarse_occ` ((G/8)^3 uint8, the dilated mask of
    `models/occupancy.py:coarse_occupancy`) the two-level march: one
    coarse probe per 4-step block, fine probes only in the first KB
    candidate blocks (`coarse_k_blocks`, or max(2K/4, 8)), and the rays
    whose samples that budget cut counted in `trunc_rays`. The output
    then has min(K, 4 KB) slots.
    """
    fn = _march_fine_kernel if rays_o.is_cuda else march_rays_train_dense_plain
    return fn(rays_o, rays_d, hits_t, bitfield, noise, cascades=cascades,
              scale=scale, exp_step_factor=exp_step_factor,
              grid_size=grid_size, max_samples=max_samples,
              samples_per_ray=samples_per_ray, march_steps=march_steps,
              coarse_occ=coarse_occ, coarse_k_blocks=coarse_k_blocks,
              tail_k=tail_k)


# ------------------------------------------- bitfield test rounds (H10)
def march_rays_test_round_dense_plain(rays_o, rays_d, cursor, t_far, alive,
                                      bitfield, *, cascades, scale,
                                      exp_step_factor, grid_size,
                                      max_samples, n_steps):
    """Plain PyTorch version of H10's full-window mode: the JAX
    `march_rays_test_round_dense` (ray_march.py:820-856)."""
    tg_ext = t_step_grid(cursor, n_steps + 1, exp_step_factor=exp_step_factor,
                         max_samples=max_samples, grid_size=grid_size,
                         scale=scale)
    tg = tg_ext[:, :n_steps].contiguous()
    dtg = calc_dt(tg, exp_step_factor, max_samples, grid_size, scale)
    xyz = rays_o[:, None, :] + tg[..., None] * rays_d[:, None, :]
    occ = occupancy_lookup(xyz, bitfield, cascades=cascades, scale=scale,
                           grid_size=grid_size, dt=dtg)
    valid = (occ & alive[:, None] & (cursor >= 0)[:, None]
             & (tg < t_far[:, None]))
    return tg, dtg, valid, torch.where(alive, tg_ext[:, -1], cursor)


def march_rays_test_round_window_plain(rays_o, rays_d, cursor, t_far, alive,
                                       bitfield, *, cascades, scale,
                                       exp_step_factor, grid_size,
                                       max_samples, S_march, n_steps):
    """Plain PyTorch version of H10's first-K mode: the bucket round's
    non-sv march (rendering.py:332-353), written out."""
    _check_window(n_steps, S_march)
    K = n_steps
    tg_ext = t_step_grid(cursor, S_march + 1, exp_step_factor=exp_step_factor,
                         max_samples=max_samples, grid_size=grid_size,
                         scale=scale)
    tg = tg_ext[:, :S_march]
    dtg = calc_dt(tg, exp_step_factor, max_samples, grid_size, scale)
    xyz = rays_o[:, None, :] + tg[..., None] * rays_d[:, None, :]
    occ = occupancy_lookup(xyz, bitfield, cascades=cascades, scale=scale,
                           grid_size=grid_size, dt=dtg)
    include = (occ & alive[:, None] & (cursor >= 0)[:, None]
               & (tg < t_far[:, None]))
    sidx, valid = select_first_k(include, K)
    zero = torch.zeros((), dtype=tg.dtype, device=tg.device)
    t_k = torch.where(valid, torch.gather(tg, 1, sidx), zero)
    dt_k = torch.where(valid, torch.gather(dtg, 1, sidx), zero)
    last_col = torch.where(valid.sum(-1) >= K, sidx[:, K - 1] + 1,
                           torch.full_like(sidx[:, 0], S_march))
    return t_k, dt_k, valid, torch.gather(tg_ext, 1, last_col[:, None])[:, 0]


def _check_window(K: int, S_march: int):
    # rendering.py:302-306: the selection is a row top_k over the window
    if K > S_march:
        raise ValueError(f"bucket round K={K} exceeds probe window "
                         f"S_march={S_march}: the first K occupied steps "
                         "are taken from the window, so K <= S_march")


def _march_test_kernel(rays_o, rays_d, cursor, t_far, alive, bitfield, *,
                       cascades, scale, exp_step_factor, grid_size,
                       max_samples, S, K):
    """H10: K == 0 is the full-window mode ((N, S) outputs), else the
    first K occupied steps of the window."""
    N, dev, f32 = rays_o.shape[0], rays_o.device, torch.float32
    args = [kernels.check(rays_o, "rays_o", f32, (N, 3), dev),
            kernels.check(rays_d, "rays_d", f32, (N, 3), dev),
            kernels.check(cursor, "cursor", f32, (N,), dev),
            kernels.check(t_far, "t_far", f32, (N,), dev),
            kernels.check(alive, "alive", torch.bool, (N,), dev),
            _bitfield_arg(bitfield, cascades, grid_size, dev)]
    W = K or S
    t = torch.empty((N, W), dtype=f32, device=dev)
    dt = torch.empty((N, W), dtype=f32, device=dev)
    valid = torch.empty((N, W), dtype=torch.bool, device=dev)
    new_cursor = torch.empty((N,), dtype=f32, device=dev)
    if N > 0:
        kernels.MARCH_FINE_TEST.launch(
            *args, N, S, K, grid_size,
            *step_args(cascades, exp_step_factor, max_samples, grid_size,
                       scale, S, dev),
            kernels.ptr(t), kernels.ptr(dt), kernels.ptr(valid),
            kernels.ptr(new_cursor), device=dev)
    return t, dt, valid, new_cursor


def march_rays_test_round_dense(rays_o, rays_d, cursor, t_far, alive,
                                bitfield, *, cascades, scale,
                                exp_step_factor, grid_size, max_samples,
                                n_steps):
    """One inference round in the dense (N, n_steps) layout (the JAX
    `march_rays_test_round_dense`): the whole window of n_steps steps from
    each cursor, unmasked t and dt, `valid` the occupied in-range steps of
    alive rays, and the cursor n_steps steps on for alive rays. Kernel
    H10, full-window mode."""
    if not rays_o.is_cuda:
        return march_rays_test_round_dense_plain(
            rays_o, rays_d, cursor, t_far, alive, bitfield,
            cascades=cascades, scale=scale, exp_step_factor=exp_step_factor,
            grid_size=grid_size, max_samples=max_samples, n_steps=n_steps)
    return _march_test_kernel(
        rays_o, rays_d, cursor, t_far, alive, bitfield, cascades=cascades,
        scale=scale, exp_step_factor=exp_step_factor, grid_size=grid_size,
        max_samples=max_samples, S=n_steps, K=0)


def march_rays_test_round_window(rays_o, rays_d, cursor, t_far, alive,
                                 bitfield, *, cascades, scale,
                                 exp_step_factor, grid_size, max_samples,
                                 S_march, n_steps):
    """One round of the bucket renderer without the sv march
    (rendering.py:332-353): probe an `S_march`-step window from each
    cursor, keep the first K = n_steps occupied in-range steps of alive
    rays, and move the cursor just past the K-th (tg_ext[sidx[K-1] + 1])
    when K were found, else past the window (tg_ext[S_march]); the
    cursor moves for every row, as the JAX round computes it. Kernel
    H10, first-K mode. Returns (t (N, K), dt, valid, new_cursor (N,))."""
    if not rays_o.is_cuda:
        return march_rays_test_round_window_plain(
            rays_o, rays_d, cursor, t_far, alive, bitfield,
            cascades=cascades, scale=scale, exp_step_factor=exp_step_factor,
            grid_size=grid_size, max_samples=max_samples, S_march=S_march,
            n_steps=n_steps)
    _check_window(n_steps, S_march)
    if n_steps < 1:
        raise ValueError(f"a window round takes n_steps >= 1, got {n_steps}")
    return _march_test_kernel(
        rays_o, rays_d, cursor, t_far, alive, bitfield, cascades=cascades,
        scale=scale, exp_step_factor=exp_step_factor, grid_size=grid_size,
        max_samples=max_samples, S=S_march, K=n_steps)


# ------------------------------------------------ flat layout (H11)
class MarchResult(NamedTuple):
    """Compact (budget-sized) sample buffers, ray-major ordered."""
    ray_id: torch.Tensor     # (B,) int32 owning ray of each slot
    t: torch.Tensor          # (B,) sample distance
    dt: torch.Tensor         # (B,) integration step
    valid: torch.Tensor      # (B,) bool
    ray_start: torch.Tensor  # (N,) int32 first slot of each ray's segment
    ray_count: torch.Tensor  # (N,) int32 samples of each ray in budget
    rm_samples: torch.Tensor  # () int32 samples before the budget


def compact_samples_plain(include, tg, dtg, budget: int) -> MarchResult:
    """Plain PyTorch version of H11: the JAX `compact_samples`
    (ray_march.py:157-192) as written, a scatter of the included steps'
    flat indices into the budget."""
    N, S = include.shape
    B = budget
    dev = include.device
    flat_inc = include.reshape(-1)
    rm_samples = flat_inc.sum().to(torch.int32)
    pos = torch.cumsum(flat_inc.to(torch.int64), 0) - 1
    within = flat_inc & (pos < B)
    src = torch.full((B + 1,), N * S, dtype=torch.int64, device=dev)
    src[torch.where(within, pos, torch.full_like(pos, B))] = torch.arange(
        N * S, device=dev)
    src = src[:B]
    valid = torch.arange(B, device=dev) < torch.clamp(rm_samples, max=B)
    src_safe = torch.clamp(src, max=N * S - 1)
    zero = torch.zeros((), dtype=tg.dtype, device=dev)
    t_c = torch.where(valid, tg.reshape(-1)[src_safe], zero)
    dt_c = torch.where(valid, dtg.reshape(-1)[src_safe], zero)
    ray_id = torch.where(valid, src_safe // S, torch.full_like(src, N - 1))
    ray_count = (include & within.reshape(N, S)).sum(-1).to(torch.int32)
    ray_start = (torch.cumsum(ray_count, 0) - ray_count).to(torch.int32)
    return MarchResult(ray_id.to(torch.int32), t_c, dt_c, valid, ray_start,
                       ray_count, rm_samples)


def _compact_kernel(include, tg, dtg, budget: int) -> MarchResult:
    N, S = include.shape
    B, dev, f32, i32 = budget, include.device, torch.float32, torch.int32
    args = [kernels.check(tg, "tg", f32, (N, S), dev),
            kernels.check(dtg, "dtg", f32, (N, S), dev),
            kernels.check(include, "include", torch.bool, (N, S), dev)]
    out = MarchResult(torch.empty(B, dtype=i32, device=dev),
                      torch.empty(B, dtype=f32, device=dev),
                      torch.empty(B, dtype=f32, device=dev),
                      torch.empty(B, dtype=torch.bool, device=dev),
                      torch.empty(N, dtype=i32, device=dev),
                      torch.empty(N, dtype=i32, device=dev),
                      torch.empty((), dtype=i32, device=dev))
    if N == 0:
        return out._replace(rm_samples=torch.zeros((), dtype=i32,
                                                   device=dev))
    kernels.COMPACT.launch(*args, N, S, B,
                           kernels.ptr(kernels.compact_workspace(N, dev)),
                           *map(kernels.ptr, out), device=dev)
    return out


def compact_samples(include, tg, dtg, budget: int) -> MarchResult:
    """Compact the included (ray, step) samples of (N, S) grids into a
    flat ray-major budget of B slots (the JAX `compact_samples`): samples
    past B are dropped (`rm_samples` counts them all, `ray_count` only
    those kept), `ray_start` is the exclusive scan of `ray_count`, and
    padding slots take ray N-1, t = dt = 0, invalid. Kernel H11: one
    launch, the counts' scan included."""
    fn = _compact_kernel if include.is_cuda else compact_samples_plain
    return fn(include, tg, dtg, budget)


def flat_cap(max_samples: int, per_ray_cap: int = 0) -> int:
    """The flat march's samples a ray at most: the dense march's K,
    min(max_samples, per_ray_cap), or max_samples when no cap is set."""
    return min(max_samples, per_ray_cap) if per_ray_cap else max_samples


def march_rays_train(rays_o, rays_d, hits_t, bitfield, noise, *, cascades,
                     scale, exp_step_factor, grid_size, max_samples,
                     sample_budget, march_steps=0, per_ray_cap=0,
                     tail_k=0) -> MarchResult:
    """March all rays and compact their samples into a flat budget (the
    JAX `march_rays_train`, the flat training oracle): the dense march
    (H9) at K = min(max_samples, per_ray_cap), whose sample set is the
    flat march's (ray_march.py:421-423), then `compact_samples` (H11)."""
    cap = flat_cap(max_samples, per_ray_cap)
    mr = march_rays_train_dense(
        rays_o, rays_d, hits_t, bitfield, noise, cascades=cascades,
        scale=scale, exp_step_factor=exp_step_factor, grid_size=grid_size,
        max_samples=max_samples, samples_per_ray=cap,
        march_steps=march_steps, tail_k=tail_k)
    return compact_samples(mr.valid, mr.t, mr.dt, sample_budget)


def march_rays_test_round(rays_o, rays_d, cursor, t_far, alive, bitfield, *,
                          cascades, scale, exp_step_factor, grid_size,
                          max_samples, n_steps, sample_budget):
    """One flat inference round (the JAX `march_rays_test_round`): the
    full-window round (H10) compacted into the budget (H11). Returns
    (MarchResult, new_cursor (N,))."""
    tg, dtg, valid, new_cursor = march_rays_test_round_dense(
        rays_o, rays_d, cursor, t_far, alive, bitfield, cascades=cascades,
        scale=scale, exp_step_factor=exp_step_factor, grid_size=grid_size,
        max_samples=max_samples, n_steps=n_steps)
    return compact_samples(valid, tg, dtg, sample_budget), new_cursor


# ------------------------------------------------ supervoxel-run march (K1)
# The kernel keeps each ray's selected intervals in local arrays of this
# size; the bench's 24 intervals and the auto-full 3 * G/8 = 48 of the
# 128^3 grid fit.
SV_MAX_INTERVALS = 64


def _sv_geometry(scale, grid_size, lo):
    """(Gc, mip bound, supervoxel edge, lattice steps per interval SI)."""
    if grid_size % 8:
        raise ValueError(f"the sv march needs grid_size % 8 == 0, got "
                         f"{grid_size}")
    Gc = grid_size // 8
    mb = min(0.5, scale)
    sv = 2.0 * mb / Gc
    return Gc, mb, sv, int(sv * SQRT3 / lo) + 3


def sv_intervals_plain(rays_o, rays_d, t0, t_end, hit, sv_mask, *, scale,
                       grid_size, RI):
    """Phase A of `_sv_scan` (ray_march.py:614-669): the ray's box interval
    cut at every supervoxel boundary plane, each piece's supervoxel from
    its midpoint, the occupied pieces de-duplicated, and the first RI of
    them selected. Returns a dict of the intermediates phases B and C
    (and the bound of kernel K1) read."""
    N = rays_o.shape[0]
    Gc, mb, sv, _ = _sv_geometry(scale, grid_size, 1.0)
    dev = rays_o.device
    inf = float("inf")
    jj = torch.arange(Gc + 1, dtype=torch.float32, device=dev)
    denom = torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9),
                        rays_d)
    tb = ((jj[None, None, :] * sv - mb) - rays_o[:, :, None]) / denom[:, :, None]
    tb = tb.reshape(N, 3 * (Gc + 1))
    tb = torch.where((tb > t0[:, None]) & (tb < t_end[:, None]), tb,
                     torch.full_like(tb, inf))
    t0b = torch.where(hit, t0, torch.full_like(t0, inf))[:, None]
    teb = torch.where(hit, t_end, torch.full_like(t_end, inf))[:, None]
    bounds = torch.sort(torch.cat([t0b, tb, teb], dim=1), dim=1).values
    b0, b1 = bounds[:, :-1], bounds[:, 1:]                  # (N, NB)
    tm = 0.5 * (b0 + b1)
    iv_valid = torch.isfinite(b1) & (b1 > b0 + 1e-9)
    tmz = torch.where(iv_valid, tm, torch.zeros_like(tm))
    svc = [torch.clamp(torch.floor(_div(rays_o[:, a:a + 1]
                                        + tmz * rays_d[:, a:a + 1] + mb, sv)),
                       0, Gc - 1).to(torch.int64)
           for a in range(3)]
    sv_id = (svc[2] * Gc + svc[1]) * Gc + svc[0]
    occ_iv = (sv_mask[sv_id] > 0) & iv_valid
    # an interval repeating its IMMEDIATE predecessor's supervoxel is
    # dropped; an invalid predecessor counts as id -1 (ray_march.py:662-664)
    cmp = torch.where(iv_valid, sv_id, torch.full_like(sv_id, -1))
    first = torch.arange(cmp.shape[1], device=dev) == 0
    occ_iv = occ_iv & ((cmp != torch.roll(cmp, 1, dims=1)) | first[None, :])
    iidx, ivalid = select_first_k(occ_iv, min(RI, occ_iv.shape[1]))
    return dict(b0=b0, b1=b1, iv_valid=iv_valid, sv_id=sv_id, iidx=iidx,
                ivalid=ivalid, iv_extra=occ_iv.sum(-1) - ivalid.sum(-1))


SV_RAY_KINDS = ("axis", "tie", "late", "over", "reenter")


def sv_ray_kinds(rays_o, rays_d, t0, t_end, hit, sv_mask, *, scale,
                 grid_size, RI):
    """How many rays of each kind in SV_RAY_KINDS a batch holds, from the
    plain phase A: "axis", a hit ray with a component below 1e-9 (its
    crossings divide by 1e-9); "tie", in-range crossings of two axes at
    one t; "late", a hit ray with t0 >= t_end; "over", more occupied
    pieces than RI; "reenter", an occupied piece whose predecessor is
    invalid and whose last valid predecessor has its supervoxel. The
    cases kernel K1's phase A must get right, counted so that a test set
    can show it holds each."""
    A = sv_intervals_plain(rays_o, rays_d, t0, t_end, hit, sv_mask,
                           scale=scale, grid_size=grid_size, RI=RI)
    Gc, mb, sv, _ = _sv_geometry(scale, grid_size, 1.0)
    dev, nan = rays_o.device, float("nan")
    jj = torch.arange(Gc + 1, dtype=torch.float32, device=dev)
    den = torch.where(rays_d.abs() < 1e-9, torch.full_like(rays_d, 1e-9),
                      rays_d)
    tb = ((jj * sv - mb)[None, None, :] - rays_o[:, :, None]) / den[:, :, None]
    tb = torch.where((tb > t0[:, None, None]) & (tb < t_end[:, None, None]),
                     tb, torch.full_like(tb, nan))
    tie = torch.zeros_like(hit)
    for a, b in ((0, 1), (0, 2), (1, 2)):
        tie |= (tb[:, a, :, None] == tb[:, b, None, :]).flatten(1).any(1)
    valid, sv_id = A["iv_valid"], A["sv_id"]
    idx = torch.arange(valid.shape[1], device=dev).expand_as(sv_id)
    last = torch.cummax(torch.where(valid, idx, -1), 1).values
    prev = torch.cat([torch.full_like(last[:, :1], -1), last[:, :-1]], 1)
    same = torch.gather(sv_id, 1, prev.clamp(min=0)) == sv_id
    gap = torch.cat([torch.zeros_like(valid[:, :1]), ~valid[:, :-1]], 1)
    occ = valid & (sv_mask[sv_id] > 0)
    return dict(axis=int((hit & (rays_d.abs() < 1e-9).any(1)).sum()),
                tie=int(tie.sum()), late=int((hit & (t0 >= t_end)).sum()),
                over=int((A["iv_extra"] > 0).sum()),
                reenter=int((occ & gap & (prev >= 0) & same).any(1).sum()))


def sv_scan_plain(rays_o, rays_d, t0, t_end, hit, sv_mask, sv_payload, *,
                  scale, grid_size, K, S, lo, RI, tail_k=0):
    """Plain PyTorch version of kernel K1: the JAX `_sv_scan`
    (ray_march.py:595-770) step for step, with its one-hot selects
    written as gathers (the same values).

    Returns (t_k (N, K), dt_k, valid, ray_count, rm_samples, scan_end,
    iv_extra)."""
    N = rays_o.shape[0]
    G = grid_size
    Gc, mb, sv, SI = _sv_geometry(scale, grid_size, lo)
    dev = rays_o.device
    A = sv_intervals_plain(rays_o, rays_d, t0, t_end, hit, sv_mask,
                           scale=scale, grid_size=grid_size, RI=RI)
    iidx, ivalid = A["iidx"], A["ivalid"]
    RI = iidx.shape[1]
    ts_r = torch.gather(A["b0"], 1, iidx)
    svid_r = torch.gather(A["sv_id"], 1, iidx)
    payload = sv_payload[svid_r].to(torch.int64)            # (N, RI, 16)
    te_last = torch.gather(A["b1"], 1, iidx[:, -1:])[:, 0]
    scan_end = torch.where(ivalid[:, -1], te_last, t_end)

    # ---- phase B: SI lattice steps from each interval's start
    k0 = torch.ceil(_div(ts_r - t0[:, None], lo))
    k0 = torch.where(ivalid, k0, torch.zeros_like(k0)).to(torch.int64) - 1
    kk = k0[:, :, None] + torch.arange(SI, device=dev)[None, None, :]
    tt = t0[:, None, None] + kk.to(torch.float32) * lo
    own = ((kk >= 0) & (kk < S) & (tt < t_end[:, None, None])
           & ivalid[:, :, None])
    svcs = (svid_r % Gc, (svid_r // Gc) % Gc, svid_r // (Gc * Gc))
    loc = []
    for a in range(3):
        pos = rays_o[:, a, None, None] + tt * rays_d[:, a, None, None]
        cell = torch.clamp(0.5 * (_div(pos, mb) + 1.0) * G, 0.0,
                           G - 1.0).to(torch.int64)
        own = own & ((cell >> 3) == svcs[a][:, :, None])
        loc.append(cell - 8 * svcs[a][:, :, None])
    L = (loc[2] * 8 + loc[1]) * 8 + loc[0]
    L = torch.where(own, L, torch.zeros_like(L))            # [0, 512)
    word = torch.gather(payload, 2, L >> 5)
    include = own & (((word >> (L & 31)) & 1) > 0)

    # ---- phase C: the slot of each target occupied rank
    cnt = torch.cumsum(include.to(torch.int64), dim=2)      # (N, RI, SI)
    tot = cnt[:, :, -1]
    cum = torch.cumsum(tot, dim=1)
    m_tot = cum[:, -1]
    targets, span_k = rank_targets(m_tot, K, tail_k)
    valid = targets <= m_tot[:, None]
    r = (cum[:, None, :] < targets[:, :, None]).sum(-1).clamp(max=RI - 1)
    local = targets - torch.gather(cum - tot, 1, r)
    cnt_r = torch.gather(cnt, 1, r[:, :, None].expand(N, K, SI))
    jsel = torch.argmax((cnt_r >= local[:, :, None]).to(torch.int32), dim=2)
    kk_sel = torch.gather(k0, 1, r) + jsel
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    t_k = torch.where(valid, t0[:, None] + kk_sel.to(torch.float32) * lo, zero)
    dt_k = torch.where(valid, torch.full_like(t_k, lo), zero)
    if tail_k > 0:
        dt_k = dt_k * span_k.to(torch.float32)
    ray_count = valid.sum(-1).to(torch.int32)
    return (t_k, dt_k, valid, ray_count, ray_count.sum(), scan_end,
            A["iv_extra"])


def _sv_intervals(n_intervals: int, grid_size: int) -> int:
    # auto-full horizon (ray_march.py:561-571): no ray visits more than
    # 3 * (G/8) supervoxels, so nothing truncates
    return n_intervals if n_intervals > 0 else 3 * (grid_size // 8)


def _test_intervals(n_intervals: int) -> int:
    # a test round has no auto-full horizon: the JAX version takes
    # n_intervals as given and fails on 0
    if n_intervals <= 0:
        raise ValueError(f"a test round needs n_intervals >= 1, got "
                         f"{n_intervals}")
    return n_intervals


def march_rays_train_dense_sv_plain(rays_o, rays_d, hits_t, sv_mask,
                                    sv_payload, noise, *, scale, grid_size,
                                    max_samples, samples_per_ray,
                                    march_steps=0, n_intervals=8,
                                    tail_k=0) -> DenseMarchResult:
    """Plain PyTorch version of K1's training launcher
    (ray_march.py:519-592)."""
    lo = SQRT3 / max_samples
    S = march_steps or max_samples
    K = min(samples_per_ray, S)
    t1, t2 = hits_t[:, 0], hits_t[:, 1]
    hit = t1 >= 0
    t0 = t1 + lo * noise
    t_end = torch.where(hit, torch.minimum(t2, t0 + S * lo),
                        torch.full_like(t2, -float("inf")))
    t_k, dt_k, valid, ray_count, rm, _, iv_extra = sv_scan_plain(
        rays_o, rays_d, t0, t_end, hit, sv_mask, sv_payload, scale=scale,
        grid_size=grid_size, K=K, S=S, lo=lo,
        RI=_sv_intervals(n_intervals, grid_size), tail_k=tail_k)
    cut = hit & (iv_extra > 0)
    if tail_k <= 0:
        # first-K: only under-filled rays lost samples
        cut = cut & (ray_count < K)
    return DenseMarchResult(t_k, dt_k, valid, ray_count, rm.to(torch.int32),
                            cut.sum().to(torch.int32))


def march_rays_test_round_sv_plain(rays_o, rays_d, cursor, t_far, alive,
                                   sv_mask, sv_payload, *, scale, grid_size,
                                   max_samples, n_steps, n_intervals=8):
    """Plain PyTorch version of K1's test-round launcher
    (ray_march.py:773-817). Returns (t, dt, valid, new_cursor)."""
    lo = SQRT3 / max_samples
    K = n_steps
    hit = alive & (cursor >= 0)
    t0 = cursor
    t_end = torch.where(hit, t_far, torch.full_like(t_far, -float("inf")))
    t_k, dt_k, valid, ray_count, _, scan_end, _ = sv_scan_plain(
        rays_o, rays_d, t0, t_end, hit, sv_mask, sv_payload, scale=scale,
        grid_size=grid_size, K=K, S=max_samples, lo=lo,
        RI=_test_intervals(n_intervals))
    # lattice-aligned cursor: one step past the last sample when K were
    # found, else the first lattice point at or after the scan horizon;
    # torch.round rounds half to even, as jnp.round does
    t_last = torch.where(valid, t_k, torch.full_like(t_k, -float("inf")))
    t_last = t_last.max(dim=1).values
    k_last = torch.round(_div(t_last - t0, lo))
    cur_full = t0 + (k_last + 1.0) * lo
    cur_part = t0 + torch.ceil(_div(torch.clamp(scan_end - t0, min=0.0),
                                    lo)) * lo
    new_cursor = torch.where(ray_count >= K, cur_full, cur_part)
    return t_k, dt_k, valid, torch.where(hit, new_cursor, cursor)


def _sv_tables(sv_mask, sv_payload, grid_size, dev):
    Gc3 = (grid_size // 8) ** 3
    return [kernels.check(sv_mask, "sv_mask", torch.uint8, (Gc3,), dev),
            kernels.check(sv_payload, "sv_payload", torch.int32, (Gc3, 16),
                          dev)]


def _sv_check_intervals(RI: int):
    if RI > SV_MAX_INTERVALS:
        raise ValueError(f"the sv march kernel takes at most "
                         f"{SV_MAX_INTERVALS} intervals, got {RI}")


def _march_sv_train_kernel(rays_o, rays_d, hits_t, sv_mask, sv_payload,
                           noise, *, scale, grid_size, max_samples,
                           samples_per_ray, march_steps, n_intervals,
                           tail_k) -> DenseMarchResult:
    lo = SQRT3 / max_samples
    S = march_steps or max_samples
    K = min(samples_per_ray, S)
    _, mb, sv, SI = _sv_geometry(scale, grid_size, lo)
    RI = min(_sv_intervals(n_intervals, grid_size),
             3 * (grid_size // 8 + 1) + 1)
    _sv_check_intervals(RI)
    N = rays_o.shape[0]
    dev, f32 = rays_o.device, torch.float32
    args = [kernels.check(rays_o, "rays_o", f32, (N, 3), dev),
            kernels.check(rays_d, "rays_d", f32, (N, 3), dev),
            kernels.check(hits_t, "hits_t", f32, (N, 2), dev),
            *_sv_tables(sv_mask, sv_payload, grid_size, dev),
            kernels.check(noise, "noise", f32, (N,), dev)]
    t = torch.empty((N, K), dtype=f32, device=dev)
    dt = torch.empty((N, K), dtype=f32, device=dev)
    valid = torch.empty((N, K), dtype=torch.bool, device=dev)
    count = torch.empty((N,), dtype=torch.int32, device=dev)
    sums = torch.zeros((2,), dtype=torch.int32, device=dev)  # rm, trunc
    if N > 0:
        # S * lo in double, then f32: the constant the JAX t_end adds
        kernels.MARCH_SV_TRAIN.launch(
            *args, N, S, K, tail_k, RI, SI, grid_size, lo, S * lo, mb, sv,
            kernels.ptr(t), kernels.ptr(dt), kernels.ptr(valid),
            kernels.ptr(count), kernels.ptr(sums), device=dev)
    return DenseMarchResult(t, dt, valid, count, sums[0], sums[1])


def _march_sv_test_round_kernel(rays_o, rays_d, cursor, t_far, alive,
                                sv_mask, sv_payload, *, scale, grid_size,
                                max_samples, n_steps, n_intervals):
    lo = SQRT3 / max_samples
    K = n_steps
    _, mb, sv, SI = _sv_geometry(scale, grid_size, lo)
    RI = min(_test_intervals(n_intervals), 3 * (grid_size // 8 + 1) + 1)
    _sv_check_intervals(RI)
    N = rays_o.shape[0]
    dev, f32 = rays_o.device, torch.float32
    args = [kernels.check(rays_o, "rays_o", f32, (N, 3), dev),
            kernels.check(rays_d, "rays_d", f32, (N, 3), dev),
            kernels.check(cursor, "cursor", f32, (N,), dev),
            kernels.check(t_far, "t_far", f32, (N,), dev),
            kernels.check(alive, "alive", torch.bool, (N,), dev),
            *_sv_tables(sv_mask, sv_payload, grid_size, dev)]
    t = torch.empty((N, K), dtype=f32, device=dev)
    dt = torch.empty((N, K), dtype=f32, device=dev)
    valid = torch.empty((N, K), dtype=torch.bool, device=dev)
    new_cursor = torch.empty((N,), dtype=f32, device=dev)
    if N > 0:
        kernels.MARCH_SV_TEST.launch(
            *args, N, max_samples, K, RI, SI, grid_size, lo, mb, sv,
            kernels.ptr(t), kernels.ptr(dt), kernels.ptr(valid),
            kernels.ptr(new_cursor), device=dev)
    return t, dt, valid, new_cursor


def march_rays_train_dense_sv(rays_o, rays_d, hits_t, sv_mask, sv_payload,
                              noise, *, scale, grid_size, max_samples,
                              samples_per_ray, march_steps=0, n_intervals=8,
                              tail_k=0) -> DenseMarchResult:
    """Supervoxel-run training march (the JAX
    `march_rays_train_dense_sv`): the same sample set as the bitfield
    march over S = march_steps steps of sqrt(3)/max_samples, unless a ray
    holds more than `n_intervals` occupied supervoxel runs (counted in
    `trunc_rays`). n_intervals <= 0: every run (3 * G/8).

    rays_o, rays_d: (N, 3) f32; hits_t: (N, 2) box interval (-1 on miss);
    sv_mask: ((G/8)^3,) uint8; sv_payload: ((G/8)^3, 16) int32 (see
    `models/occupancy.py:supervoxel_tables`); noise: (N,) in [0, 1).
    """
    fn = (_march_sv_train_kernel if rays_o.is_cuda
          else march_rays_train_dense_sv_plain)
    return fn(rays_o, rays_d, hits_t, sv_mask, sv_payload, noise,
              scale=scale, grid_size=grid_size, max_samples=max_samples,
              samples_per_ray=samples_per_ray, march_steps=march_steps,
              n_intervals=n_intervals, tail_k=tail_k)


def march_rays_test_round_sv(rays_o, rays_d, cursor, t_far, alive, sv_mask,
                             sv_payload, *, scale, grid_size, max_samples,
                             n_steps, n_intervals=8):
    """One inference marching round (the JAX `march_rays_test_round_sv`):
    the next `n_steps` occupied lattice samples of each alive ray from its
    cursor, and the cursor of the next round, on the ray's step lattice.

    cursor, t_far: (N,) f32; alive: (N,) bool. Returns (t (N, K), dt,
    valid, new_cursor (N,)).
    """
    fn = (_march_sv_test_round_kernel if rays_o.is_cuda
          else march_rays_test_round_sv_plain)
    return fn(rays_o, rays_d, cursor, t_far, alive, sv_mask, sv_payload,
              scale=scale, grid_size=grid_size, max_samples=max_samples,
              n_steps=n_steps, n_intervals=n_intervals)
