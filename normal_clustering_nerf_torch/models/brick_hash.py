"""Brick-hash multiresolution encoding — port of the JAX package's
`models/brick_hash.py`.

The same trilinear multiresolution grid as tiny-cuda-nn's, with the
vertices of each level grouped into 4x4x4-vertex bricks on a stride-3
grid: brick b covers vertex coordinates [3b, 3b+3], so all 8 corners of
the cell with base p0 lie in brick p0 // 3. A level's table has
n_bricks rows of 64 slots x F features (lane s*F + f, slot s = lx*16 +
ly*4 + lz); coarse levels index their bricks densely, fine levels hash
the brick coordinate with the tcnn XOR-prime hash. Vertices on a
stride-3 face are stored once per adjacent brick (brick_hash.py:30-38).
The table is (L, n_bricks, 64*F) and converts 1:1 from JAX.

`brick_encode` launches kernels H5 (forward), H6 (table gradient) and
H13 (position gradient, for extrinsic optimisation) of
`csrc/brick_hash.cu` for CUDA tensors, and runs `encode_plain` /
`encode_grad_plain` for CPU tensors. H13 is H5 writing the encode's
Jacobian when x needs a gradient (`encode_jac_kernel`, plain
`encode_jacobian_plain`) and a launch of the contraction H14 runs too
(`contract_kernel`, plain `contract_plain`). The cotangent arrives in
the compute dtype, f32 or bf16: H6 and the contraction read it as it
is, the plain versions cast it to f32 first.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple, Sequence

import torch

from .. import kernels
from ..ops.chain import chain_sum
from .hash_encoding import contract_launch, contract_plain

_HASH_PRIMES = (1, 2654435761, 805459861)


class BrickGridSpec(NamedTuple):
    """Static geometry of the brick-hash grid (uniform per-level shape)."""
    n_levels: int
    n_features: int
    n_bricks: int                # rows per level (2^log2_bricks)
    base_res: int
    per_level_scale: float
    scales: Sequence[float]      # tcnn 'scale' per level
    resolutions: Sequence[int]   # vertex count per axis per level
    nb_axis: Sequence[int]       # brick-grid extent per axis per level
    dense: Sequence[bool]        # dense brick indexing (no hashing)

    @staticmethod
    def create(
        n_levels: int = 16,
        n_features: int = 2,
        log2_bricks: int = 13,
        base_res: int = 16,
        per_level_scale: float = 1.3819,
    ) -> "BrickGridSpec":
        # in Python doubles, as brick_hash.py:65-88: at some levels s lands
        # on an integer, where a float32 recomputation can flip the ceil
        NB = 1 << log2_bricks
        scales, resolutions, nbs, dense = [], [], [], []
        for l in range(n_levels):
            s = math.exp2(l * math.log2(per_level_scale)) * base_res - 1.0
            res = int(math.ceil(s)) + 1
            nb = (res - 1) // 3 + 1
            scales.append(s)
            resolutions.append(res)
            nbs.append(nb)
            dense.append(nb ** 3 <= NB)
        return BrickGridSpec(
            n_levels=n_levels, n_features=n_features, n_bricks=NB,
            base_res=base_res, per_level_scale=per_level_scale,
            scales=tuple(scales), resolutions=tuple(resolutions),
            nb_axis=tuple(nbs), dense=tuple(dense),
        )

    @property
    def row_width(self) -> int:
        return 64 * self.n_features

    @property
    def out_dim(self) -> int:
        return self.n_levels * self.n_features

    def table_shape(self):
        return (self.n_levels, self.n_bricks, self.row_width)


def init_brick_table(spec: BrickGridSpec, generator: torch.Generator,
                     device: torch.device) -> torch.Tensor:
    """tcnn's init: uniform in [-1e-4, 1e-4) (brick_hash.py:98-102)."""
    u = torch.rand(spec.table_shape(), generator=generator, device=device)
    return u * 2e-4 - 1e-4


# ------------------------------------------------------------ geometry
def level_axes(x, spec: BrickGridSpec, l: int):
    """Brick row (M,) of level l and, per axis (M, 3) each: the lower and
    upper local slots, whether they coincide (the top face), and the
    lower and upper weights (see `level_geometry`)."""
    scale = torch.tensor(spec.scales[l], dtype=torch.float32)
    res, nb = spec.resolutions[l], spec.nb_axis[l]
    pos = x * scale + 0.5
    p0f = torch.floor(pos)
    f = pos - p0f
    p0 = torch.clamp(p0f.to(torch.int64), 0, res - 1)
    b = torch.div(p0, 3, rounding_mode="floor")
    l0 = p0 - 3 * b
    l1 = torch.clamp(p0 + 1, max=res - 1) - 3 * b
    top = l1 == l0
    w0 = torch.where(top, (1.0 - f) + f, 1.0 - f)
    w1 = torch.where(top, torch.zeros_like(f), f)
    if spec.dense[l]:
        row = (b[:, 0] * nb + b[:, 1]) * nb + b[:, 2]
    else:
        h = (b[:, 0] * _HASH_PRIMES[0] ^ b[:, 1] * _HASH_PRIMES[1]
             ^ b[:, 2] * _HASH_PRIMES[2])
        row = h & (spec.n_bricks - 1)
    return row, l0, l1, top, w0, w1


def level_geometry(x, spec: BrickGridSpec, l: int):
    """Brick row (M,), the 8 corner slots (M, 8) and their trilinear
    weights (M, 8) of level l (brick_hash.py:115-147).

    pos = x*scale + 0.5 with scale the f32 the JAX level constants hold;
    p0 = clip(floor(pos), 0, res-1) and the fraction f from the unclipped
    position. Along an axis the lower corner is slot l0 = p0 - 3b, the
    upper l1 = min(p0+1, res-1) - 3b; where l1 == l0 (the top face) both
    weights fall on one slot as (1-f) + f, as the one-hot sum gives, and
    the upper corner's weight is 0. A corner's weight is wx * (wy * wz),
    the order of `_w64`."""
    row, l0, l1, _, w0, w1 = level_axes(x, spec, l)
    slots, ws = [], []
    for c in range(8):
        cx, cy, cz = (c >> 2) & 1, (c >> 1) & 1, c & 1
        sl = [(l1 if cc else l0)[:, a] for a, cc in enumerate((cx, cy, cz))]
        wa = [(w1 if cc else w0)[:, a] for a, cc in enumerate((cx, cy, cz))]
        slots.append(sl[0] * 16 + sl[1] * 4 + sl[2])
        ws.append(wa[0] * (wa[1] * wa[2]))
    return row, torch.stack(slots, 1), torch.stack(ws, 1)


def _lanes(row, slots, F: int):
    """Flat index into one level's (n_bricks * 64 * F) table of
    (sample, corner, feature): (M, 8, F)."""
    f = torch.arange(F, device=row.device)
    return (row[:, None, None] * 64 + slots[:, :, None]) * F + f


def encode_plain(table, x, spec: BrickGridSpec):
    """Plain PyTorch version of the H5 forward: (M, 3) in [0, 1]^3 ->
    (M, L*F) f32, level-major, each level's 8 corner terms summed in
    corner order."""
    F = spec.n_features
    feats = []
    for l in range(spec.n_levels):
        row, slots, w = level_geometry(x, spec, l)
        vals = table[l].reshape(-1)[_lanes(row, slots, F)]      # (M, 8, F)
        acc = torch.zeros((x.shape[0], F), dtype=torch.float32,
                          device=x.device)
        for c in range(8):
            acc = acc + w[:, c, None] * vals[:, c]
        feats.append(acc)
    return torch.cat(feats, dim=1)


def encode_grad_plain(x, g, spec: BrickGridSpec):
    """Plain PyTorch version of the H6 backward: scatter-add g (x) w of the
    8 corners into a zeroed (L, n_bricks, 64*F) f32 table gradient (g cast
    to f32 first)."""
    g = g.to(torch.float32)
    F = spec.n_features
    d_table = torch.zeros(spec.table_shape(), dtype=torch.float32,
                          device=x.device)
    for l in range(spec.n_levels):
        row, slots, w = level_geometry(x, spec, l)
        upd = w[:, :, None] * g[:, None, l * F:(l + 1) * F]
        d_table[l].view(-1).index_add_(0, _lanes(row, slots, F).reshape(-1),
                                       upd.reshape(-1))
    return d_table


def encode_jacobian_plain(table, x, spec: BrickGridSpec):
    """Plain PyTorch version of H5's Jacobian: d(out)/dx (M, L*F*3) f32,
    entry (l*F + f)*3 + a the sum in corner order of the corner's slot
    value f times d_a * (w_o1 * w_o2), the derivative of its weight
    wx * (wy * wz) along a (o1 < o2 the other axes; d_a = +1 for the
    upper slot, -1 for the lower, 0 on the top face, where JAX's dw4 =
    oh1 - oh0 vanishes), times the level's scale."""
    F = spec.n_features
    cols = []
    for l in range(spec.n_levels):
        row, slots, _ = level_geometry(x, spec, l)
        _, _, _, top, w0, w1 = level_axes(x, spec, l)
        d = torch.where(top, 0.0, 1.0)
        vals = table[l].reshape(-1)[_lanes(row, slots, F)]      # (M, 8, F)
        dw = [[], [], []]
        for c in range(8):
            cs = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
            wa = [(w1 if cc else w0)[:, a] for a, cc in enumerate(cs)]
            for a in range(3):
                o1, o2 = [b for b in range(3) if b != a]
                da = d[:, a] if cs[a] else -d[:, a]
                dw[a].append(da * (wa[o1] * wa[o2]))
        scale = torch.tensor(spec.scales[l], dtype=torch.float32)
        for f in range(F):
            for a in range(3):
                cols.append(chain_sum([vals[:, c, f] * dw[a][c]
                                       for c in range(8)]) * scale)
    return torch.stack(cols, 1)


def encode_dx_plain(table, x, g, spec: BrickGridSpec):
    """The position gradient (M, 3) f32 of the encode under the f32
    cotangent g (M, L*F), as the kernels compute it: the Jacobian
    contracted with g. JAX's need_dx branch of `_brick_vjp_bwd`
    (brick_hash.py:225-239) dots each slot with g first and sums the
    corners after; the two orders agree within 1e-5 of the largest
    |dx|."""
    return contract_plain(encode_jacobian_plain(table, x, spec), g)


# ------------------------------------------------------------ kernels
@functools.lru_cache(maxsize=16)
def level_table(spec: BrickGridSpec, device) -> torch.Tensor:
    """(L, 4) int32 per-level constants of the kernels: the f32 scale's
    bits, res, nb, dense (kept per spec and device)."""
    scale_bits = torch.tensor(spec.scales, dtype=torch.float32).view(
        torch.int32)
    return torch.stack([scale_bits,
                        torch.tensor(spec.resolutions, dtype=torch.int32),
                        torch.tensor(spec.nb_axis, dtype=torch.int32),
                        torch.tensor(spec.dense, dtype=torch.int32)],
                       1).contiguous().to(device)


def _kernel_args(x, spec: BrickGridSpec):
    if spec.n_features != 2:
        raise NotImplementedError("the brick kernels take n_features 2")
    M, dev = x.shape[0], x.device
    return M, dev, [kernels.check(x, "x", torch.float32, (M, 3), dev),
                    kernels.check(level_table(spec, dev), "levels",
                                  torch.int32, (spec.n_levels, 4), dev)]


def encode_kernel(table, x, spec: BrickGridSpec, out_dtype=torch.float32):
    """H5: (M, L*F) features in `out_dtype` (f32 or bf16, rounded once
    from the f32 sum)."""
    M, dev, args = _kernel_args(x, spec)
    tab = kernels.check(table, "table", torch.float32, spec.table_shape(), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: H5 reads aligned slot pairs as 16-byte "
                         "words; the table must start 16-byte aligned")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype}: f32 or bf16")
    out = torch.empty((M, spec.out_dim), dtype=out_dtype, device=dev)
    if M > 0:
        kernels.BRICK_FWD.launch(tab, *args, kernels.ptr(out), M,
                                 spec.n_levels, spec.n_bricks,
                                 int(out_dtype == torch.bfloat16), device=dev)
    return out


def encode_grad_kernel(x, g, spec: BrickGridSpec):
    """H6: the table gradient of g ((M, L*F) in f32 or bf16, read in its
    own dtype), a zeroed (L, n_bricks, 64*F) f32 table with the corner terms
    added by float2 reductions (`csrc/grad_scatter.cuh`)."""
    M, dev, args = _kernel_args(x, spec)
    if g.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"g: dtype {g.dtype}, expected float32 or bfloat16")
    gp = kernels.check(g, "g", g.dtype, (M, spec.out_dim), dev)
    if math.prod(spec.table_shape()) >= 2 ** 31:
        raise ValueError("H6 addresses the table with 32-bit offsets: "
                         f"{spec.table_shape()} is too large")
    d_table = torch.zeros(spec.table_shape(), dtype=torch.float32, device=dev)
    if M > 0:
        kernels.BRICK_BWD.launch(gp, *args, kernels.ptr(d_table), M,
                                 spec.n_levels, spec.n_bricks,
                                 int(g.dtype == torch.bfloat16), device=dev)
    return d_table


def encode_jac_kernel(table, x, spec: BrickGridSpec,
                      out_dtype=torch.float32):
    """H5 with the Jacobian (`brick_fwd_jac`): the (M, L*F) features in
    `out_dtype`, as `encode_kernel` writes them, and d(out)/dx (M,
    L*F*3) f32 (`encode_jacobian_plain`'s layout)."""
    M, dev, args = _kernel_args(x, spec)
    tab = kernels.check(table, "table", torch.float32, spec.table_shape(), dev)
    if table.data_ptr() % 16:
        raise ValueError("table: H5 reads aligned slot pairs as 16-byte "
                         "words; the table must start 16-byte aligned")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype}: f32 or bf16")
    out = torch.empty((M, spec.out_dim), dtype=out_dtype, device=dev)
    jac = torch.empty((M, 3 * spec.out_dim), dtype=torch.float32, device=dev)
    if M > 0:
        kernels.BRICK_FWD_JAC.launch(tab, *args, kernels.ptr(out),
                                     kernels.ptr(jac), M, spec.n_levels,
                                     spec.n_bricks,
                                     int(out_dtype == torch.bfloat16),
                                     device=dev)
    return out, jac


def contract_kernel(jac, g, spec: BrickGridSpec):
    """H13's contraction (`brick_contract`) of H5's Jacobian, H14's body:
    the position gradient (M, 3) f32 from `jac` (M, L*F*3) and g ((M,
    L*F) in f32 or bf16, read in its own dtype), in `contract_plain`'s
    order."""
    return contract_launch(kernels.BRICK_CONTRACT, jac, g, spec)


class BrickEncode(torch.autograd.Function):
    """The table gradient, and with `jac` (x needs a gradient: JAX's
    need_dx, extrinsic optimisation) the position gradient H13 from the
    Jacobian the forward saves in place of the table."""

    @staticmethod
    def forward(ctx, table, x, spec, out_dtype, jac=False):
        ctx.spec = spec
        if not jac:
            ctx.save_for_backward(x)
            if x.is_cuda:
                return encode_kernel(table, x, spec, out_dtype)
            return encode_plain(table, x, spec).to(out_dtype)
        if x.is_cuda:
            out, J = encode_jac_kernel(table, x, spec, out_dtype)
        else:
            out = encode_plain(table, x, spec).to(out_dtype)
            J = encode_jacobian_plain(table, x, spec)
        ctx.save_for_backward(x, J)
        return out

    @staticmethod
    def backward(ctx, g):
        x, *J = ctx.saved_tensors
        card = x.is_cuda   # the kernels read g in the compute dtype
        g = g.contiguous() if card else g.to(torch.float32)
        grad = encode_grad_kernel if card else encode_grad_plain
        dx = None
        if J:
            dx = (contract_kernel(J[0], g, ctx.spec) if card
                  else contract_plain(J[0], g))
        return grad(x, g, ctx.spec), dx, None, None, None


def brick_encode(table: torch.Tensor, x: torch.Tensor, spec: BrickGridSpec,
                 compute_dtype=torch.float32, need_dx: bool = False):
    """Encode (M, 3) positions in [0,1]^3 -> (M, L*F) features, level-major:
    the f32 fold cast to `compute_dtype` (brick_hash.py:246-257). With
    `need_dx`, a gradient of x (H13) is computed when x requires one;
    without it x gets none."""
    if not need_dx:
        x = x.detach()
    jac = torch.is_grad_enabled() and x.requires_grad
    return BrickEncode.apply(table, x.to(torch.float32).contiguous(), spec,
                             compute_dtype, jac)
