"""Multiresolution hash-grid encoding (Instant-NGP, the tcnn layout) —
port of the JAX package's `models/hash_encoding.py`.

tcnn's Grid algorithm: per level, resolution ceil(N_min * b^l - 1) + 1,
corners floor(x*scale + 0.5), each clipped to [0, res-1] per axis,
trilinear weights from the unclipped fraction; dense indexing
(ix*res + iy)*res + iz when the level's res^3 vertices fit in the table,
else the {1, 2654435761, 805459861} XOR-multiply hash with uint32
wraparound, & (T-1). All levels share one (total_rows, F) table, level l
at row `level_offsets[l]` (level sizes aligned to 8), so it converts 1:1
from JAX.

`hash_encode` launches kernels H7 (forward), H8 (table gradient) and
H14 (position gradient, for extrinsic optimisation) of
`csrc/hash_grid.cu` for CUDA tensors, and runs `encode_plain` /
`encode_grad_plain` / `encode_dx_plain` for CPU tensors. The cotangent arrives in the
compute dtype, f32 or bf16: H8 reads it as it is, the plain version casts
it to f32 first. The JAX package's optional run-dedupe scatter
(`_run_dedupe_scatter`, behind an environment toggle, off by default)
computes the same sum as the direct scatter and is not ported.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import torch

from .. import kernels
from ..ops.chain import chain_sum

_HASH_PRIMES = (1, 2654435761, 805459861)


class HashGridSpec(NamedTuple):
    """Static per-level geometry of the hash grid."""
    n_levels: int
    n_features: int
    table_size: int              # per-level hash table capacity (2^log2_T)
    base_res: int
    per_level_scale: float
    scales: Sequence[float]      # tcnn 'scale' per level
    resolutions: Sequence[int]   # cells per axis per level
    level_offsets: Sequence[int]  # row offset of each level in the table
    total_rows: int
    dense: Sequence[bool]        # dense indexing (no hashing) per level

    @staticmethod
    def create(
        n_levels: int = 16,
        n_features: int = 2,
        log2_table_size: int = 19,
        base_res: int = 16,
        per_level_scale: float = 1.3819,
    ) -> "HashGridSpec":
        # in Python doubles, as hash_encoding.py:47-76
        T = 1 << log2_table_size
        scales, resolutions, offsets, dense = [], [], [], []
        off = 0
        for l in range(n_levels):
            # tcnn grid.h: scale = exp2(l*log2(b))*N_min - 1; res = ceil(scale)+1
            s = math.exp2(l * math.log2(per_level_scale)) * base_res - 1.0
            res = int(math.ceil(s)) + 1
            n_cells = res ** 3
            use_dense = n_cells <= T
            rows = n_cells if use_dense else T
            # tcnn aligns level sizes to multiples of 8
            rows = (rows + 7) // 8 * 8
            scales.append(s)
            resolutions.append(res)
            offsets.append(off)
            dense.append(use_dense)
            off += rows
        return HashGridSpec(
            n_levels=n_levels, n_features=n_features, table_size=T,
            base_res=base_res, per_level_scale=per_level_scale,
            scales=tuple(scales), resolutions=tuple(resolutions),
            level_offsets=tuple(offsets), total_rows=off, dense=tuple(dense),
        )

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def table_shape(self):
        return (self.total_rows, self.n_features)


def init_hash_table(spec: HashGridSpec, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """tcnn's init: uniform in [-1e-4, 1e-4) (hash_encoding.py:79-84)."""
    u = torch.rand(spec.table_shape(), generator=generator, device=device)
    return u * 2e-4 - 1e-4


def level_fraction(x, spec: HashGridSpec, l: int):
    """Level l's base vertex floor(x*scale + 0.5) (M, 3) int64 and the
    unclipped fraction (M, 3), with the level's scale as an f32."""
    scale = torch.tensor(spec.scales[l], dtype=torch.float32)
    pos = x * scale + 0.5
    p0f = torch.floor(pos)
    return p0f.to(torch.int64), pos - p0f


def level_corners(x, spec: HashGridSpec, l: int):
    """Table rows (M, 8) and trilinear weights (M, 8) of level l
    (hash_encoding.py:99-120): pos = x*scale + 0.5 with the level's scale
    as an f32, corner c = floor(pos) + (cx, cy, cz) clipped per axis,
    weight (wx * wy) * wz from the unclipped fraction."""
    res = spec.resolutions[l]
    p0, w = level_fraction(x, spec, l)
    rows, wts = [], []
    for c in range(8):
        cx, cy, cz = (c >> 2) & 1, (c >> 1) & 1, c & 1
        ix, iy, iz = (torch.clamp(p0[:, a] + cc, 0, res - 1)
                      for a, cc in enumerate((cx, cy, cz)))
        if spec.dense[l]:
            idx = (ix * res + iy) * res + iz
        else:   # the low bits of the int64 products are the uint32 ones
            idx = (ix * _HASH_PRIMES[0] ^ iy * _HASH_PRIMES[1]
                   ^ iz * _HASH_PRIMES[2]) & (spec.table_size - 1)
        rows.append(spec.level_offsets[l] + idx)
        wx = w[:, 0] if cx else 1.0 - w[:, 0]
        wy = w[:, 1] if cy else 1.0 - w[:, 1]
        wz = w[:, 2] if cz else 1.0 - w[:, 2]
        wts.append(wx * wy * wz)
    return torch.stack(rows, 1), torch.stack(wts, 1)


def encode_plain(table, x, spec: HashGridSpec):
    """Plain PyTorch version of the H7 forward: (M, 3) in [0, 1]^3 ->
    (M, L*F) f32, level-major, the 8 corner terms summed in corner
    order."""
    feats = []
    for l in range(spec.n_levels):
        rows, w = level_corners(x, spec, l)
        vals = table[rows]                                  # (M, 8, F)
        acc = torch.zeros((x.shape[0], spec.n_features), dtype=torch.float32,
                          device=x.device)
        for c in range(8):
            acc = acc + w[:, c, None] * vals[:, c]
        feats.append(acc)
    return torch.cat(feats, dim=1)


def encode_grad_plain(x, g, spec: HashGridSpec):
    """Plain PyTorch version of the H8 backward: scatter-add g (x) w of
    the 8 corners into a zeroed (total_rows, F) f32 table gradient
    (hash_encoding.py:199-245, direct scatter; g cast to f32 first)."""
    g = g.to(torch.float32)
    F = spec.n_features
    d_table = torch.zeros(spec.table_shape(), dtype=torch.float32,
                          device=x.device)
    f = torch.arange(F, device=x.device)
    for l in range(spec.n_levels):
        rows, w = level_corners(x, spec, l)
        upd = w[:, :, None] * g[:, None, l * F:(l + 1) * F]
        d_table.view(-1).index_add_(0, (rows[:, :, None] * F + f).reshape(-1),
                                    upd.reshape(-1))
    return d_table


def encode_dx_plain(table, x, g, spec: HashGridSpec):
    """Plain PyTorch version of H14: the position gradient (M, 3) f32 of
    the encode under the f32 cotangent g (M, L*F), the need_dx branch of
    `_hash_vjp_bwd` (hash_encoding.py:227-243): per level and axis a, the
    sum in corner order of ((+-1 * w_o1) * w_o2) * scale, the derivative
    of the corner's weight along a (o1, o2 the other axes, the weights
    from the unclipped fraction), times the corner's row dotted with the
    level's cotangent (feature order); the levels added in order."""
    F = spec.n_features
    dx = [[], [], []]
    for l in range(spec.n_levels):
        rows, _ = level_corners(x, spec, l)
        _, w = level_fraction(x, spec, l)
        vals = table[rows]                                  # (M, 8, F)
        g_l = g[:, l * F:(l + 1) * F]
        scale = torch.tensor(spec.scales[l], dtype=torch.float32)
        acc = [[], [], []]
        for c in range(8):
            cs = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            gd = chain_sum([vals[:, c, f] * g_l[:, f] for f in range(F)])
            for a in range(3):
                o1, o2 = [b for b in range(3) if b != a]
                w1 = w[:, o1] if cs[o1] else 1.0 - w[:, o1]
                w2 = w[:, o2] if cs[o2] else 1.0 - w[:, o2]
                acc[a].append(((w1 if cs[a] else -w1) * w2) * scale * gd)
        for a in range(3):
            dx[a].append(chain_sum(acc[a]))
    return torch.stack([chain_sum(t) for t in dx], 1)


# ------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=16)
def level_table(spec: HashGridSpec, device) -> torch.Tensor:
    """(L, 4) int32 per-level constants of the kernels: the f32 scale's
    bits, res, dense, row offset (kept per spec and device)."""
    scale_bits = torch.tensor(spec.scales, dtype=torch.float32).view(
        torch.int32)
    return torch.stack([scale_bits,
                        torch.tensor(spec.resolutions, dtype=torch.int32),
                        torch.tensor(spec.dense, dtype=torch.int32),
                        torch.tensor(spec.level_offsets, dtype=torch.int32)],
                       1).contiguous().to(device)


def _kernel_args(x, spec: HashGridSpec):
    if spec.n_features != 2:
        raise NotImplementedError("the hash-grid kernels take n_features 2")
    M, dev = x.shape[0], x.device
    return M, dev, [kernels.check(x, "x", torch.float32, (M, 3), dev),
                    kernels.check(level_table(spec, dev), "levels",
                                  torch.int32, (spec.n_levels, 4), dev)]


def encode_kernel(table, x, spec: HashGridSpec, out_dtype=torch.float32):
    """H7: (M, L*F) features in `out_dtype` (f32 or bf16, rounded once
    from the f32 sum)."""
    M, dev, args = _kernel_args(x, spec)
    tab = kernels.check(table, "table", torch.float32, spec.table_shape(), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: H7 reads aligned row pairs as 16-byte "
                         "words; the table must start 16-byte aligned")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype}: f32 or bf16")
    out = torch.empty((M, spec.out_dim), dtype=out_dtype, device=dev)
    if M > 0:
        kernels.HASH_FWD.launch(tab, *args, kernels.ptr(out), M,
                                spec.n_levels, spec.table_size,
                                int(out_dtype == torch.bfloat16), device=dev)
    return out


def encode_grad_kernel(x, g, spec: HashGridSpec):
    """H8: the table gradient of g ((M, L*F) in f32 or bf16, read in its
    own dtype), a zeroed (total_rows, F) f32 table with the corner terms
    added by float2 reductions (`csrc/grad_scatter.cuh`)."""
    M, dev, args = _kernel_args(x, spec)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g: dtype {g.dtype}, expected float32 or bfloat16")
    gp = kernels.check(g, "g", g.dtype, (M, spec.out_dim), dev)
    if math.prod(spec.table_shape()) >= 2 ** 31:
        raise ValueError("H8 addresses the table with 32-bit offsets: "
                         f"{spec.table_shape()} is too large")
    d_table = torch.zeros(spec.table_shape(), dtype=torch.float32, device=dev)
    if M > 0:
        kernels.HASH_BWD.launch(gp, *args, kernels.ptr(d_table), M,
                                spec.n_levels, spec.table_size,
                                int(g.dtype == torch.bfloat16), device=dev)
    return d_table


def encode_dx_kernel(table, x, g, spec: HashGridSpec):
    """H14: the position gradient (M, 3) f32 of g ((M, L*F) in f32 or
    bf16, read in its own dtype)."""
    M, dev, args = _kernel_args(x, spec)
    tab = kernels.check(table, "table", torch.float32, spec.table_shape(), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: H14 reads aligned row pairs as 16-byte "
                         "words; the table must start 16-byte aligned")
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g: dtype {g.dtype}, expected float32 or bfloat16")
    gp = kernels.check(g, "g", g.dtype, (M, spec.out_dim), dev)
    dx = torch.empty((M, 3), dtype=torch.float32, device=dev)
    if M > 0:
        kernels.HASH_DX.launch(tab, *args, gp, kernels.ptr(dx), M,
                               spec.n_levels, spec.table_size,
                               int(g.dtype == torch.bfloat16), device=dev)
    return dx


class HashEncode(torch.autograd.Function):
    """The table gradient, and the position gradient (H14) when x needs
    one (extrinsic optimisation: JAX's need_dx)."""

    @staticmethod
    def forward(ctx, table, x, spec, out_dtype):
        ctx.save_for_backward(x, table)
        ctx.spec = spec
        if x.is_cuda:
            return encode_kernel(table, x, spec, out_dtype)
        return encode_plain(table, x, spec).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        if x.is_cuda:   # the kernels read g in the compute dtype
            g = g.contiguous()
            grad, dx_fn = encode_grad_kernel, encode_dx_kernel
        else:
            g = g.to(torch.float32)
            grad, dx_fn = encode_grad_plain, encode_dx_plain
        dx = (dx_fn(table, x, g, ctx.spec) if ctx.needs_input_grad[1]
              else None)
        return grad(x, g, ctx.spec), dx, None, None


def hash_encode(table: torch.Tensor, x: torch.Tensor, spec: HashGridSpec,
                compute_dtype=torch.float32, need_dx: bool = False):
    """Encode (M, 3) positions in [0,1]^3 -> (M, L*F) features, level-major:
    the f32 blend cast to `compute_dtype` (hash_encoding.py:251-265). With
    `need_dx`, a gradient of x (H14) is computed when x requires one;
    without it x gets none."""
    if not need_dx:
        x = x.detach()
    return HashEncode.apply(table, x.to(torch.float32).contiguous(), spec,
                            compute_dtype)
