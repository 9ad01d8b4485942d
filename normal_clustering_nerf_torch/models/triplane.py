"""Triplane + coarse-grid factorised field — port of the JAX package's
`models/triplane.py`.

Three axis-aligned feature planes (xy, xz, yz; plane_res^2 vertices x 8
features, bilinear) and one coarse 3D grid (grid3d_res^3 x 4 features,
trilinear), stored as brick rows in the feature-major v2 layout
(triplane.py:41-46): a plane row is a 4x4-vertex brick of 128 values,
lane f*16 + s; a grid row a 4x4x4 brick of 256 values, lane f*64 + s.
The tables convert 1:1 from JAX parameters.

`triplane_encode` launches kernel H2 (`csrc/triplane.cu`) for CUDA
tensors, forward and backward, and H12 for the position gradient
(extrinsic optimisation), and runs `encode_plain` / `encode_grad_plain`
/ `encode_dx_plain` for CPU tensors. The cotangent arrives in the compute
dtype, f32 or bf16: H2 reads it as it is, the plain version casts it to
f32 first.
"""
from __future__ import annotations

from typing import Dict, NamedTuple

import numpy as np
import torch

from .. import kernels
from ..ops.chain import chain_sum

PLANES = ((0, 1), (0, 2), (1, 2))
# the row-lane layout version a weights file or checkpoint records
# (triplane.py:41-46): v1 slot-major lanes (s*F + f), v2 feature-major
# (f*S + s). The shapes are the same in both.
TRIPLANE_LAYOUT_VERSION = 2


def convert_rows_slot_to_feature_major(rows, n_slots: int) -> np.ndarray:
    """(rows, F*S) slot-major (lane s*F + f) -> feature-major (lane
    f*S + s) (triplane.py:47-55)."""
    R, FS = rows.shape
    F = FS // n_slots
    return (np.asarray(rows).reshape(R, n_slots, F)
            .transpose(0, 2, 1).reshape(R, FS))


def convert_triplane_params_v1_to_v2(tp_params: Dict) -> Dict:
    """A v1 {"planes", "grid3d"} dict of numpy arrays in the v2 layout
    (triplane.py:58-66)."""
    out = dict(tp_params)
    out["planes"] = np.stack([
        convert_rows_slot_to_feature_major(p, 16)
        for p in np.asarray(tp_params["planes"])])
    out["grid3d"] = convert_rows_slot_to_feature_major(
        tp_params["grid3d"], 64)
    return out


class TriplaneSpec(NamedTuple):
    plane_res: int
    plane_feats: int
    grid3d_res: int
    grid3d_feats: int

    @staticmethod
    def create(plane_res=512, plane_feats=8, grid3d_res=64, grid3d_feats=4):
        if 16 * plane_feats != 128:
            raise ValueError("plane row must be 128 values (plane_feats 8)")
        return TriplaneSpec(plane_res, plane_feats, grid3d_res, grid3d_feats)

    @property
    def nb2(self) -> int:
        return (self.plane_res - 2) // 3 + 1   # 2D bricks per axis

    @property
    def nb3(self) -> int:
        return (self.grid3d_res - 1) // 3 + 1  # 3D bricks per axis

    @property
    def out_dim(self) -> int:
        return 3 * self.plane_feats + self.grid3d_feats

    def param_shapes(self):
        return {
            "planes": (3, self.nb2 ** 2, 128),
            "grid3d": (self.nb3 ** 3, 64 * self.grid3d_feats),
        }

    def clip_hi(self, res: int) -> float:
        # the JAX clip bound R - 2 + 1e-6, as the f32 it rounds to
        return float(torch.tensor(res - 2 + 1e-6, dtype=torch.float32))


def init_triplane(spec: TriplaneSpec, generator: torch.Generator,
                  device: torch.device) -> Dict[str, torch.Tensor]:
    """Tables uniform in [-1e-4, 1e-4) (triplane.py:99-107)."""
    out = {}
    for name, shape in spec.param_shapes().items():
        u = torch.rand(shape, generator=generator, device=device)
        out[name] = u * 2e-4 - 1e-4
    return out


# ------------------------------------------------------------ geometry
def _axis(pos):
    p0f = torch.floor(pos)
    f = pos - p0f
    p0 = p0f.to(torch.int64)
    b = torch.div(p0, 3, rounding_mode="floor")
    return b, p0 - 3 * b, 1.0 - f, f


def _axes(x, res: int, spec: TriplaneSpec):
    """Each column's (brick, slot, lower weight, upper weight)."""
    pos = torch.clamp(x * (res - 1), 0.0, spec.clip_hi(res))
    return [_axis(pos[:, a]) for a in range(x.shape[1])]


def plane_corners(x2, spec: TriplaneSpec):
    """(M, 2) in [0,1]^2 -> brick row (M,), 4 corner slots (M, 4) and
    their bilinear weights (M, 4) (triplane.py:129-139)."""
    (bu, lu, u0, u1), (bv, lv, v0, v1) = _axes(x2, spec.plane_res, spec)
    row = bu * spec.nb2 + bv
    s00 = lu * 4 + lv
    slots = torch.stack([s00, s00 + 1, s00 + 4, s00 + 5], dim=1)
    w = torch.stack([u0 * v0, u0 * v1, u1 * v0, u1 * v1], dim=1)
    return row, slots, w


def grid_corners(x, spec: TriplaneSpec):
    """(M, 3) in [0,1]^3 -> brick row (M,), 8 corner slots (M, 8) and
    their trilinear weights (M, 8) (triplane.py:142-154)."""
    ((bx, lx, x0, x1), (by, ly, y0, y1),
     (bz, lz, z0, z1)) = _axes(x, spec.grid3d_res, spec)
    row = (bx * spec.nb3 + by) * spec.nb3 + bz
    s000 = lx * 16 + ly * 4 + lz
    slots, ws = [], []
    for c in range(8):
        cx, cy, cz = (c >> 2) & 1, (c >> 1) & 1, c & 1
        slots.append(s000 + cx * 16 + cy * 4 + cz)
        ws.append(((x1 if cx else x0) * (y1 if cy else y0))
                  * (z1 if cz else z0))
    return row, torch.stack(slots, dim=1), torch.stack(ws, dim=1)


def _lanes(row, slots, n_feats: int, row_width: int, n_slots: int):
    """Flat table index of (sample, feature, corner): (M, F, C)."""
    f = torch.arange(n_feats, device=row.device)[None, :, None]
    return (row[:, None, None] * row_width + f * n_slots + slots[:, None, :])


def _fold(table_flat, lanes, w, bf16: bool):
    vals = table_flat[lanes]                       # (M, F, C)
    if bf16:
        prod = (vals.to(torch.bfloat16)
                * w.to(torch.bfloat16)[:, None, :]).to(torch.float32)
    else:
        prod = vals * w[:, None, :]
    return prod.sum(dim=-1)


def encode_plain(planes, grid3d, x, spec: TriplaneSpec, bf16: bool):
    """Plain PyTorch version of the H2 forward: (M, 3) -> (M, 3Fp+Fg) f32."""
    Fp, Fg = spec.plane_feats, spec.grid3d_feats
    feats = []
    for pi, (a, b) in enumerate(PLANES):
        row, slots, w = plane_corners(torch.stack((x[:, a], x[:, b]), 1),
                                       spec)
        feats.append(_fold(planes[pi].reshape(-1),
                           _lanes(row, slots, Fp, 128, 16), w, bf16))
    row, slots, w = grid_corners(x, spec)
    feats.append(_fold(grid3d.reshape(-1),
                       _lanes(row, slots, Fg, 64 * Fg, 64), w, bf16))
    return torch.cat(feats, dim=1)


def encode_grad_plain(x, g, spec: TriplaneSpec, plane_shape, grid_shape):
    """Plain PyTorch version of the H2 backward: scatter-add g (x) w into
    zeroed f32 tables."""
    Fp, Fg = spec.plane_feats, spec.grid3d_feats
    d_planes = torch.zeros(plane_shape, dtype=torch.float32, device=x.device)
    for pi, (a, b) in enumerate(PLANES):
        row, slots, w = plane_corners(torch.stack((x[:, a], x[:, b]), 1),
                                       spec)
        upd = g[:, pi * Fp:(pi + 1) * Fp, None] * w[:, None, :]
        d_planes[pi].view(-1).index_add_(
            0, _lanes(row, slots, Fp, 128, 16).reshape(-1), upd.reshape(-1))
    row, slots, w = grid_corners(x, spec)
    upd = g[:, 3 * Fp:, None] * w[:, None, :]
    d_grid = torch.zeros(grid_shape, dtype=torch.float32, device=x.device)
    d_grid.view(-1).index_add_(
        0, _lanes(row, slots, Fg, 64 * Fg, 64).reshape(-1), upd.reshape(-1))
    return d_planes, d_grid


def _dx_terms(table_flat, lanes, g, dws, scale: float):
    """One table's position terms: each corner's dot of its F values with
    g (M, F), feature by feature, times each axis' weight derivatives
    (dws: per axis, (M, C)), summed corner by corner, times `scale`."""
    vals = table_flat[lanes]                         # (M, F, C)
    gd = chain_sum([vals[:, f] * g[:, f, None] for f in range(g.shape[1])])
    return [chain_sum([gd[:, c] * dw[:, c] for c in range(dw.shape[1])])
            * scale for dw in dws]


def encode_dx_plain(planes, grid3d, x, g, spec: TriplaneSpec):
    """Plain PyTorch version of H12: the position gradient (M, 3) f32 of
    the encode under the f32 cotangent g (M, 3Fp+Fg), the need_dx branch
    of `_tp_bwd` (triplane.py:229-250). Per plane, each corner's f32 row
    values dotted with g (feature order), times the derivative of its
    bilinear weight along u (+-v's weight) and along v (+-u's), summed in
    corner order, times R_p - 1; the grid's the same over 8 corners and
    three axes, times R_g - 1. dx[a] adds the planes' terms (xy, xz, yz)
    then the grid's, as the JAX version does; the clip of the position
    gets no derivative there either."""
    Fp, Fg = spec.plane_feats, spec.grid3d_feats
    terms = [[], [], []]
    for pi, (a, b) in enumerate(PLANES):
        x2 = torch.stack((x[:, a], x[:, b]), 1)
        row, slots, _ = plane_corners(x2, spec)
        (_, _, u0, u1), (_, _, v0, v1) = _axes(x2, spec.plane_res, spec)
        # corners (u, v) = (0, 0), (0, 1), (1, 0), (1, 1)
        dwu = torch.stack([-v0, -v1, v0, v1], 1)
        dwv = torch.stack([-u0, u0, -u1, u1], 1)
        du, dv = _dx_terms(planes[pi].reshape(-1),
                           _lanes(row, slots, Fp, 128, 16),
                           g[:, pi * Fp:(pi + 1) * Fp], (dwu, dwv),
                           float(spec.plane_res - 1))
        terms[a].append(du)
        terms[b].append(dv)
    row, slots, _ = grid_corners(x, spec)
    w = [(w0, w1) for _, _, w0, w1 in _axes(x, spec.grid3d_res, spec)]
    dws = [[], [], []]
    for c in range(8):
        cs = ((c >> 2) & 1, (c >> 1) & 1, c & 1)
        pick = [w[a][cs[a]] for a in range(3)]
        for a in range(3):
            o1, o2 = [o for o in range(3) if o != a]
            prod = pick[o1] * pick[o2]
            dws[a].append(prod if cs[a] else -prod)
    gd = _dx_terms(grid3d.reshape(-1), _lanes(row, slots, Fg, 64 * Fg, 64),
                   g[:, 3 * Fp:], [torch.stack(d, 1) for d in dws],
                   float(spec.grid3d_res - 1))
    for a in range(3):
        terms[a].append(gd[a])
    return torch.stack([(t[0] + t[1]) + t[2] for t in terms], 1)


# ------------------------------------------------------------ kernels
def _kernel_geometry(spec: TriplaneSpec):
    if spec.grid3d_feats != 4:
        raise NotImplementedError("the triplane kernel takes grid3d_feats 4")
    return (spec.plane_res, spec.nb2, spec.grid3d_res, spec.nb3,
            spec.nb2 ** 2, spec.clip_hi(spec.plane_res),
            spec.clip_hi(spec.grid3d_res))


def encode_kernel(planes, grid3d, x, spec: TriplaneSpec, bf16: bool,
                  out_dtype=torch.float32):
    """H2's forward: (M, 3Fp+Fg) features in `out_dtype` (f32, or rounded
    once from the f32 sum to bf16), folding bf16-rounded rows when
    `bf16`."""
    geo = _kernel_geometry(spec)
    M, dev, f32 = x.shape[0], x.device, torch.float32
    args = [kernels.check(x, "x", f32, (M, 3), dev),
            kernels.check(planes, "planes", f32,
                          spec.param_shapes()["planes"], dev),
            kernels.check(grid3d, "grid3d", f32,
                          spec.param_shapes()["grid3d"], dev)]
    if out_dtype not in (f32, torch.bfloat16):
        raise ValueError(f"out_dtype {out_dtype}: f32 or bf16")
    out = torch.empty((M, spec.out_dim), dtype=out_dtype, device=dev)
    if M > 0:
        kernels.TRIPLANE_FWD.launch(*args, kernels.ptr(out), M, *geo,
                                    int(bf16),
                                    int(out_dtype == torch.bfloat16),
                                    device=dev)
    return out


def encode_grad_kernel(x, g, spec: TriplaneSpec, plane_shape, grid_shape):
    """H2's backward: the table gradients of g ((M, 3Fp+Fg) in f32 or bf16,
    read in its own dtype), zeroed f32 tables with the corner terms added
    a cell a warp instruction."""
    geo = _kernel_geometry(spec)
    M, dev, f32 = x.shape[0], x.device, torch.float32
    if g.dtype not in (f32, torch.bfloat16):
        raise ValueError(f"g: dtype {g.dtype}, expected float32 or bfloat16")
    args = [kernels.check(x, "x", f32, (M, 3), dev),
            kernels.check(g, "g", g.dtype, (M, spec.out_dim), dev)]
    d_planes = torch.zeros(plane_shape, dtype=f32, device=dev)
    d_grid = torch.zeros(grid_shape, dtype=f32, device=dev)
    if M > 0:
        kernels.TRIPLANE_BWD.launch(*args, kernels.ptr(d_planes),
                                    kernels.ptr(d_grid), M, *geo,
                                    int(g.dtype == torch.bfloat16),
                                    device=dev)
    return d_planes, d_grid


def encode_dx_kernel(planes, grid3d, x, g, spec: TriplaneSpec):
    """H12: the position gradient (M, 3) f32 of g ((M, 3Fp+Fg) in f32 or
    bf16, read in its own dtype), from the f32 tables."""
    geo = _kernel_geometry(spec)
    M, dev, f32 = x.shape[0], x.device, torch.float32
    if g.dtype not in (f32, torch.bfloat16):
        raise ValueError(f"g: dtype {g.dtype}, expected float32 or bfloat16")
    shapes = spec.param_shapes()
    args = [kernels.check(x, "x", f32, (M, 3), dev),
            kernels.check(planes, "planes", f32, shapes["planes"], dev),
            kernels.check(grid3d, "grid3d", f32, shapes["grid3d"], dev),
            kernels.check(g, "g", g.dtype, (M, spec.out_dim), dev)]
    dx = torch.empty((M, 3), dtype=f32, device=dev)
    if M > 0:
        kernels.TRIPLANE_DX.launch(*args, kernels.ptr(dx), M, *geo,
                                   int(g.dtype == torch.bfloat16), device=dev)
    return dx


class TriplaneEncode(torch.autograd.Function):
    """Table gradients, and the position gradient when x needs one
    (extrinsic optimisation: JAX's need_dx). The encode folds bf16 rows
    when `out_dtype` (the compute dtype) is bf16, and returns its output
    in `out_dtype` (H2 writes it so; the plain version's f32 sum is cast),
    so that the cotangent comes back in it: H2's backward and H12 read a
    bf16 cotangent as it is, the plain versions cast it to f32 (exact)."""

    @staticmethod
    def forward(ctx, planes, grid3d, x, spec, out_dtype):
        if ctx.needs_input_grad[2]:
            ctx.save_for_backward(x, planes, grid3d)
        else:
            ctx.save_for_backward(x)
        ctx.spec = spec
        ctx.shapes = (planes.shape, grid3d.shape)
        bf16 = out_dtype == torch.bfloat16
        if x.is_cuda:
            return encode_kernel(planes, grid3d, x, spec, bf16, out_dtype)
        return encode_plain(planes, grid3d, x, spec, bf16).to(out_dtype)

    @staticmethod
    def backward(ctx, g):
        x = ctx.saved_tensors[0]
        if x.is_cuda:
            g = g.contiguous()
            grad, dx_fn = encode_grad_kernel, encode_dx_kernel
        else:
            g = g.to(torch.float32)
            grad, dx_fn = encode_grad_plain, encode_dx_plain
        d_planes, d_grid = grad(x, g, ctx.spec, *ctx.shapes)
        dx = None
        if ctx.needs_input_grad[2]:
            dx = dx_fn(*ctx.saved_tensors[1:], x, g, ctx.spec)
        return d_planes, d_grid, dx, None, None


def triplane_encode(params: Dict[str, torch.Tensor], x: torch.Tensor,
                    spec: TriplaneSpec, compute_dtype=torch.float32,
                    need_dx: bool = False):
    """Encode (M, 3) positions in [0,1]^3 -> (M, 3Fp+Fg) features in
    `compute_dtype`. Under bf16 the folds use bf16 table values; the
    output is accumulated in f32 and gradients are f32. With `need_dx`,
    a gradient of x (H12) is computed when x requires one; without it
    (JAX's need_dx False) x gets none."""
    if not need_dx:
        x = x.detach()
    return TriplaneEncode.apply(params["planes"], params["grid3d"],
                                x.contiguous(), spec, compute_dtype)
