"""Occupancy-grid maintenance over explicit state — port of the JAX
package's `models/occupancy.py` (reference: models/ngp_mt.py:231-368).

The density grid, bitfield and coverage counts live in an
`OccupancyState`; every update returns a new state, which the trainer
copies into its own (`OccupancyState.copy_`). Cells are indexed
linearly, x fastest, within each cascade, which is the layout the march
probes. Random draws (sampled cells, their jitter) are separable: each
function that draws takes them as optional arguments.

The refresh after the sigma eval is kernel K8 (`csrc/occupancy.cu`):
`occ_compact` (each cascade's occupied list and count), `occ_merge_pack`
(the EMA max-merge, the mean density in a fixed order, the threshold and
the bitfield) and `occ_tables` (the march's supervoxel tables and coarse
mask), each with its plain version (`*_plain`) for a CPU tensor; on
several cards `occ_union` ORs the ranks' gathered bitfields. Nothing in
`OccupancyGrid.update` reads the card on the host, so the trainer replays
the sampled refresh as a CUDA graph.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..config import ModelConfig
from ..device import as_index
from ..ops.packbits import packbits, unpack_bits
from ..ops.ray_march import _div

# K8's order of the mean density (`occ_merge_pack`): tiles of MERGE_TILE
# cells, thread t of MERGE_THREADS adding its cells of quads t + k
# MERGE_THREADS (k < MERGE_QUADS) in order, then pairwise halvings over the
# 32 lanes of a warp and over the warps; the tile sums the same way
# (thread t adding tiles t, t + MERGE_THREADS, ... in order)
MERGE_THREADS = 512
MERGE_QUADS = 4
MERGE_TILE = 4 * MERGE_QUADS * MERGE_THREADS
COMPACT_TILE = 16384   # occ_compact's cells a block
# cameras per chunk of mark_invisible_cells: at G = 128 one camera's
# projected cells are 3 x 128^3 floats (25 MB); 8 cameras keep the
# intermediate at ~200 MB instead of the 1.2 GB of all 48 at once
_MARK_CHUNK = 8


class OccupancyState(NamedTuple):
    """The JAX `OccupancyState`'s fields, in its order. Every refresh
    rebuilds the tables of cascade 0 from the bitfield: the two-level
    march's dilated supervoxel mask `coarse_occ` (`coarse_occupancy`) and
    the supervoxel-run march's undilated mask and 16-word payload
    (`supervoxel_tables`)."""
    density_grid: torch.Tensor      # (C, G^3) f32; -1 marks invisible cells
    density_bitfield: torch.Tensor  # (C*G^3/8,) uint8
    count_grid: torch.Tensor        # (C, G^3) f32 camera-coverage fraction
    coarse_occ: torch.Tensor        # ((G/8)^3,) uint8, dilated
    sv_mask: torch.Tensor           # ((G/8)^3,) uint8
    sv_payload: torch.Tensor        # ((G/8)^3, 16) int32

    def copy_(self, src: "OccupancyState") -> "OccupancyState":
        """Copy every field of `src` into this state's own tensors, whose
        shapes are fixed by the grid (a CUDA graph of a training step
        holds their storages); returns self."""
        for name, dst, s in zip(self._fields, self, src):
            if dst.shape != s.shape or dst.dtype != s.dtype:
                raise ValueError(f"{name}: {tuple(s.shape)} {s.dtype}, "
                                 f"expected {tuple(dst.shape)} {dst.dtype}")
            dst.copy_(s)
        return self


def _occ_cube(bitfield: torch.Tensor, G: int) -> torch.Tensor:
    return unpack_bits(bitfield[: G ** 3 // 8]).reshape(G, G, G)  # [z, y, x]


def coarse_occupancy(bitfield: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Max-pool the cascade-0 bits into (G/8)^3 supervoxels and dilate by
    one supervoxel per axis (occupancy.py:44-65)."""
    G, Gc = grid_size, grid_size // 8
    occ = _occ_cube(bitfield, G).to(torch.uint8)
    coarse = occ.reshape(Gc, 8, Gc, 8, Gc, 8).amax(dim=(1, 3, 5))
    for axis in range(3):
        lo = torch.roll(coarse, 1, dims=axis)
        lo.select(axis, 0).zero_()
        hi = torch.roll(coarse, -1, dims=axis)
        hi.select(axis, Gc - 1).zero_()
        coarse = torch.maximum(coarse, torch.maximum(lo, hi))
    return coarse.reshape(-1)


def supervoxel_tables(bitfield: torch.Tensor, grid_size: int):
    """(sv_mask, sv_payload) of the supervoxel-run march
    (occupancy.py:68-98): supervoxel (zc, yc, xc) packs its 8^3 fine bits
    into 16 int32 words, local cell (lx, ly, lz) at bit
    L = (lz*8 + ly)*8 + lx, word L >> 5, bit L & 31."""
    G, Gc = grid_size, grid_size // 8
    occ = _occ_cube(bitfield, G).to(torch.int64)
    blk = occ.reshape(Gc, 8, Gc, 8, Gc, 8).permute(0, 2, 4, 1, 3, 5)
    flat = blk.reshape(Gc ** 3, 512)
    w = torch.bitwise_left_shift(
        torch.ones(32, dtype=torch.int64, device=flat.device),
        torch.arange(32, dtype=torch.int64, device=flat.device))
    words = (flat.reshape(Gc ** 3, 16, 32) * w).sum(dim=-1)
    # two's-complement view of the 32-bit word (bit 31 = sign)
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    mask = (flat.amax(dim=-1) > 0).to(torch.uint8)
    return mask, words.to(torch.int32)


def occ_compact(grid: torch.Tensor, density_threshold: float):
    """Each cascade's cells whose density exceeds the threshold, in
    ascending order, and their count: (list (C, G^3) int32, of which row
    c's first count[c] entries are the cells, count (C,) int32). K8's
    `occ_compact` on a CUDA tensor (past the count the list holds
    whatever was there), `occ_compact_plain` on a CPU one."""
    if not grid.is_cuda:
        return occ_compact_plain(grid, density_threshold)
    dev = grid.device
    C, G3 = grid.shape
    g = kernels.check(grid, "density_grid", torch.float32, (C, G3), dev)
    work = kernels.scan_workspace("occ", 1 + C * -(-G3 // COMPACT_TILE),
                                  dev)
    lst = torch.empty((C, G3), dtype=torch.int32, device=dev)
    count = torch.empty(C, dtype=torch.int32, device=dev)
    kernels.OCC_COMPACT.launch(g, float(density_threshold), C, G3,
                               kernels.ptr(work), kernels.ptr(lst),
                               kernels.ptr(count), device=dev)
    return lst, count


def occ_compact_plain(grid: torch.Tensor, density_threshold: float):
    """`occ_compact` as JAX builds the list (occupancy.py:164-168): each
    occupied cell's rank by a cumsum, the cells scattered to their ranks
    (the rest of the list is 0)."""
    C, G3 = grid.shape
    occ = grid > density_threshold
    rank = torch.cumsum(occ.to(torch.int64), dim=1) - 1
    dest = torch.where(occ, rank, G3)
    cells = torch.arange(G3, dtype=torch.int32, device=grid.device)
    lst = torch.zeros((C, G3 + 1), dtype=torch.int32, device=grid.device)
    lst.scatter_(1, dest, cells.expand(C, G3))
    return lst[:, :G3], occ.sum(dim=1).to(torch.int32)


def occ_merge_pack(grid: torch.Tensor, tmp: torch.Tensor, decay: float,
                   density_threshold: float):
    """The refresh's merge and pack (occupancy.py:217-230): grid' =
    where(grid < 0, grid, max(grid * decay, tmp)), thr = min(the mean of
    grid''s positive cells, density_threshold), and the bitfield of
    grid' > thr. Returns (grid', bitfield (C G^3 / 8,) uint8, the mean as
    a 0-dim tensor). K8's `occ_merge_pack` (one launch) on a CUDA tensor,
    `occ_merge_pack_plain` (the same order of the mean's sum) on a CPU
    one."""
    if not grid.is_cuda:
        return occ_merge_pack_plain(grid, tmp, decay, density_threshold)
    dev = grid.device
    n = grid.numel()
    g = kernels.check(grid, "density_grid", torch.float32, device=dev)
    t = kernels.check(tmp, "tmp", torch.float32, grid.shape, dev)
    out = torch.empty_like(grid)
    bits = torch.empty(n // 8, dtype=torch.uint8, device=dev)
    partials = torch.empty(2 * -(-n // MERGE_TILE), dtype=torch.float32,
                           device=dev)
    mean = torch.empty((), dtype=torch.float32, device=dev)
    kernels.OCC_MERGE_PACK.launch(
        g, t, float(decay), float(density_threshold), n,
        kernels.ptr(kernels.scan_workspace("merge", 1, dev)),
        kernels.ptr(partials), kernels.ptr(out), kernels.ptr(bits),
        kernels.ptr(mean), device=dev)
    return out, bits, mean


def _halvings(part: torch.Tensor) -> torch.Tensor:
    """(..., 2^k) -> (...): pairwise halvings over the last axis, element
    i + h added to element i (h = 2^(k-1), ..., 1), as xor shuffles add."""
    while part.shape[-1] > 1:
        h = part.shape[-1] // 2
        part = part[..., :h] + part[..., h:]
    return part[..., 0]


def _block_sum(v: torch.Tensor) -> torch.Tensor:
    """(..., MERGE_THREADS) thread values -> (...): the halvings over the
    lanes of each warp, then over the warps."""
    return _halvings(_halvings(v.reshape(*v.shape[:-1], -1, 32)))


def fixed_order_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of x's values in K8's order (x padded with +0.0 to whole
    tiles, which changes no sum of non-negative values): each thread adds
    its 16 cells in order, the tile's threads by `_block_sum`, then the
    tile sums by the same two steps."""
    flat = x.reshape(-1)
    tiles = -(-flat.numel() // MERGE_TILE)
    pad = torch.zeros(tiles * MERGE_TILE, dtype=x.dtype, device=x.device)
    pad[:flat.numel()] = flat
    # [tile, k, thread, cell of the quad] -> [tile, thread, (k, cell)]
    cells = pad.view(tiles, MERGE_QUADS, MERGE_THREADS, 4).transpose(1, 2)
    cells = cells.reshape(tiles, MERGE_THREADS, 4 * MERGE_QUADS)
    acc = cells[..., 0]
    for i in range(1, 4 * MERGE_QUADS):
        acc = acc + cells[..., i]
    part = _block_sum(acc)
    rows = -(-tiles // MERGE_THREADS)
    sums = torch.zeros(rows * MERGE_THREADS, dtype=x.dtype, device=x.device)
    sums[:tiles] = part
    sums = sums.view(rows, MERGE_THREADS)
    acc = sums[0]
    for i in range(1, rows):
        acc = acc + sums[i]
    return _block_sum(acc)


def occ_merge_pack_plain(grid, tmp, decay: float, density_threshold: float):
    """`occ_merge_pack`'s plain version."""
    new = torch.where(grid < 0, grid, torch.maximum(grid * decay, tmp))
    pos = new > 0
    total = fixed_order_sum(torch.where(pos, new, 0.0))
    mean = total / torch.clamp(pos.sum(), min=1).to(torch.float32)
    thr = torch.clamp(mean, max=density_threshold)
    return new, packbits(new, thr), mean


def occ_union(rows: torch.Tensor) -> torch.Tensor:
    """The OR of the (world, N) uint8 rows (several cards' bitfields):
    K8's `occ_union` on a CUDA tensor, `occ_union_plain` on a CPU one."""
    if not rows.is_cuda:
        return occ_union_plain(rows)
    dev = rows.device
    world, nbytes = rows.shape
    r = kernels.check(rows, "rows", torch.uint8, device=dev)
    out = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    kernels.OCC_UNION.launch(r, world, nbytes, kernels.ptr(out), device=dev)
    return out


def occ_union_plain(rows: torch.Tensor) -> torch.Tensor:
    """`occ_union`'s plain version: a bitwise_or over the rows."""
    out = rows[0].clone()
    for row in rows[1:]:
        out.bitwise_or_(row)
    return out


def occ_tables(bitfield: torch.Tensor, grid_size: int):
    """(coarse_occ, sv_mask, sv_payload) of cascade 0's bits: K8's
    `occ_tables` on a CUDA tensor, `coarse_occupancy` and
    `supervoxel_tables` on a CPU one."""
    if not bitfield.is_cuda:
        return (coarse_occupancy(bitfield, grid_size),
                *supervoxel_tables(bitfield, grid_size))
    dev = bitfield.device
    G, Gc3 = grid_size, (grid_size // 8) ** 3
    if G % 8 or bitfield.dim() != 1 or bitfield.numel() < G ** 3 // 8:
        raise ValueError(f"occ_tables: a bitfield of {bitfield.numel()} "
                         f"bytes at G {G}")
    b = kernels.check(bitfield, "bitfield", torch.uint8, device=dev)
    coarse = torch.empty(Gc3, dtype=torch.uint8, device=dev)
    mask = torch.empty(Gc3, dtype=torch.uint8, device=dev)
    payload = torch.empty((Gc3, 16), dtype=torch.int32, device=dev)
    kernels.OCC_TABLES.launch(b, G, kernels.ptr(coarse), kernels.ptr(mask),
                              kernels.ptr(payload), device=dev)
    return coarse, mask, payload


class OccupancyGrid:
    """Static geometry + pure update functions (state passed explicitly)."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        self.cfg = cfg
        self.G = cfg.grid_size
        self.cascades = cfg.cascades
        self.scale = cfg.scale
        self.device = device

    def init_state(self) -> OccupancyState:
        G3 = self.G ** 3
        Gc3 = (self.G // 8) ** 3
        z = dict(device=self.device)
        u8 = dict(dtype=torch.uint8, **z)
        return OccupancyState(
            density_grid=torch.zeros((self.cascades, G3), **z),
            density_bitfield=torch.zeros((self.cascades * G3 // 8,), **u8),
            count_grid=torch.zeros((self.cascades, G3), **z),
            coarse_occ=torch.zeros((Gc3,), **u8),
            sv_mask=torch.zeros((Gc3,), **u8),
            sv_payload=torch.zeros((Gc3, 16), dtype=torch.int32, **z),
        )

    # ------------------------------------------------------------ geometry
    def cell_coords(self, indices: torch.Tensor) -> torch.Tensor:
        """Flat linear cell index -> (x, y, z) integer coords."""
        G = self.G
        return torch.stack([indices % G, (indices // G) % G,
                            indices // (G * G)], dim=-1)

    def cell_world_pos(self, coords, cascade: int, jitter=None):
        """Cell coords -> world position, optionally jittered inside the
        cell (reference: models/ngp_mt.py:350-354)."""
        G = self.G
        s = min(2.0 ** (cascade - 1), self.scale)
        half = s / G
        xyz = (coords.to(torch.float32) / (G - 1) * 2.0 - 1.0) * (s - half)
        if jitter is not None:
            xyz = xyz + (jitter * 2.0 - 1.0) * half
        return xyz

    # ------------------------------------------------------- cell sampling
    def draw_update_cells(self, state: OccupancyState,
                          generator: torch.Generator) -> Dict:
        """The sampled refresh's cell draws, per cascade: M = G^3/4
        uniform cells, and M ranks into the list of cells above the
        threshold (a cell index itself when no cell is above it)."""
        G3 = self.G ** 3
        M = G3 // 4
        kw = dict(generator=generator, device=self.device)
        uni = torch.randint(0, G3, (self.cascades, M), **kw)
        occ = torch.rand((self.cascades, M), **kw)
        return {"uniform": uni, "occ_u": occ}

    def sample_update_cells(self, state: OccupancyState, density_threshold,
                            draws: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """M uniform + M occupied cells per cascade (occupancy.py:143-176):
        uniform over the cells whose density exceeds the threshold, or
        uniform over all cells when none does. The occupied list and its
        count stay on the device (`occ_compact`).

        `draws` holds "uniform" (C, M) cell indices and either "occ_rank"
        (C, M) ranks into the occupied list (cell indices when it is
        empty), as a test passes the JAX package's draws, or "occ_u"
        (C, M) uniforms in [0, 1) scaled to that range: with n occupied
        cells, list[min(floor(u n), n - 1)], else min(floor(u G^3),
        G^3 - 1).
        Returns (indices (C, 2M), coords (C, 2M, 3)).
        """
        G3 = self.G ** 3
        occ_list, n = occ_compact(state.density_grid, density_threshold)
        n = n.to(torch.int64)[:, None]
        if "occ_rank" in draws:
            r = as_index(draws["occ_rank"], self.device)
            listed = occ_list.gather(1, r)
        else:
            u = draws["occ_u"]
            r = torch.minimum((u * n.to(u.dtype)).long(), n - 1).clamp_(min=0)
            listed = occ_list.gather(1, r)
            r = (u * G3).long().clamp_(max=G3 - 1)
        occ_idx = torch.where(n > 0, listed.to(torch.int64), r)
        idx = torch.cat([as_index(draws["uniform"], self.device), occ_idx],
                        dim=1)
        return idx, self.cell_coords(idx)

    # ------------------------------------------------------------- updates
    def update(self, state: OccupancyState,
               density_fn: Callable[[torch.Tensor], torch.Tensor],
               density_threshold: float, warmup: bool, *,
               generator: Optional[torch.Generator] = None,
               jitter: Optional[torch.Tensor] = None,
               cell_draws: Optional[Dict] = None,
               decay: float = 0.95) -> OccupancyState:
        """EMA-merge fresh sigma samples into the grid, repack the bits and
        rebuild the coarse mask and the sv march's tables
        (occupancy.py:179-237; erode=False as the trainer calls it).

        density_fn: (M, 3) world positions -> (M,) sigma.
        warmup: evaluate every cell (steps < warmup_steps).
        jitter: (C, n_cells, 3) in-cell jitter in [0, 1); cell_draws: see
          `sample_update_cells`. Both are drawn from `generator` when None.
        """
        G3 = self.G ** 3
        tmp = torch.zeros_like(state.density_grid)
        if warmup:
            idx = torch.arange(G3, device=self.device).expand(self.cascades, G3)
        else:
            if cell_draws is None:
                cell_draws = self.draw_update_cells(state, generator)
            idx, _ = self.sample_update_cells(state, density_threshold,
                                              cell_draws)
        coords = self.cell_coords(idx)
        if jitter is None:
            jitter = torch.rand(coords.shape, generator=generator,
                                device=self.device)
        for c in range(self.cascades):
            xyz = self.cell_world_pos(coords[c], c, jitter[c])
            with torch.no_grad():
                sig = density_fn(xyz).to(torch.float32)
            if warmup:
                tmp[c] = sig
            else:
                # duplicate indices keep the max (occupancy.py:213-215)
                tmp[c].scatter_reduce_(0, idx[c], sig, reduce="amax")
        grid, bitfield, _ = occ_merge_pack(state.density_grid, tmp, decay,
                                           density_threshold)
        return OccupancyState(grid, bitfield, state.count_grid,
                              *occ_tables(bitfield, self.G))

    # ------------------------------------------------------ several cards
    @staticmethod
    def merge_across_chips(state: OccupancyState, group) -> OccupancyState:
        """Merge the ranks' refreshed grids (occupancy.py:294-315): each
        rank sampled its own cells, and the union of their evidence is the
        MAX of the density grids and the OR of the bitfields (JAX takes the
        MAX of the unpacked bits: NCCL has no bitwise reduction, and a MAX
        of packed bytes is no OR), here the ranks' bitfields all-gathered
        and ORed (`occ_union`). The coarse mask and the sv tables are
        rebuilt from the merged bitfield (dilation and any-reduction
        commute with the union); the coverage counts are kept. Every rank
        returns the same state."""
        grid = state.density_grid.clone()
        dist.all_reduce(grid, op=dist.ReduceOp.MAX, group=group)
        bits = state.density_bitfield
        rows = bits.new_empty((dist.get_world_size(group), bits.numel()))
        dist.all_gather(list(rows.unbind(0)), bits, group=group)
        bitfield = occ_union(rows)
        G = round(state.density_grid.shape[1] ** (1.0 / 3.0))
        return OccupancyState(grid, bitfield, state.count_grid,
                              *occ_tables(bitfield, G))

    # ---------------------------------------------------- visibility marks
    def mark_invisible_cells(self, state: OccupancyState, poses, img_wh,
                             near_distance: float, K=None,
                             proj: Optional[Tuple] = None) -> OccupancyState:
        """Mark cells no camera sees with density -1 and store each
        cell's camera-coverage fraction (occupancy.py:240-291): through
        the pinhole `K`, or through Hypersim's projection matrices `proj`
        = (M_ndc_from_cam, M_uv_from_ndc, shift, scale) (reference:
        ngp_mt.py:291-321).

        Unlike the JAX version, which projects every cell into every
        camera at once (a (N_cams, 3, G^3) intermediate, 1.2 GB at 48
        cameras and G = 128), this loops over chunks of `_MARK_CHUNK`
        cameras and accumulates the per-cell counts.
        """
        def mat(m):
            return torch.as_tensor(np.asarray(m, np.float32),
                                   device=self.device)
        if proj is not None:
            M_ndc, M_uv, scale = mat(proj[0]), mat(proj[1]), float(proj[3])
        elif not isinstance(K, torch.Tensor):
            K = mat(K)
        poses = torch.as_tensor(poses, dtype=torch.float32, device=self.device)
        n_cams = poses.shape[0]
        G3 = self.G ** 3
        w2c_R = poses[:, :3, :3].transpose(1, 2)
        w2c_T = -w2c_R @ poses[:, :3, 3:]
        coords = self.cell_coords(torch.arange(G3, device=self.device))
        density = state.density_grid.clone()
        counts = state.count_grid.clone()
        for c in range(self.cascades):
            xyzs_w = self.cell_world_pos(coords, c).T           # (3, G3)
            n_cov = torch.zeros(G3, dtype=torch.int64, device=self.device)
            too_near = torch.zeros(G3, dtype=torch.bool, device=self.device)
            for s in range(0, n_cams, _MARK_CHUNK):
                sl = slice(s, s + _MARK_CHUNK)
                xyzs_c = w2c_R[sl] @ xyzs_w + w2c_T[sl]          # (n, 3, G3)
                if proj is not None:
                    xc = xyzs_c * (2.0 * scale)                  # metric
                    xc_h = torch.cat([xc, torch.ones_like(xc[:, :1])], 1)
                    clip = M_ndc @ xc_h
                    uvd = M_uv @ (clip / clip[:, 3:])
                    uv = uvd[:, :2]
                else:
                    uvd = K @ xyzs_c
                    uv = uvd[:, :2] / uvd[:, 2:]
                in_image = ((uvd[:, 2] >= 0)
                            & (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
                            & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1]))
                n_cov += ((uvd[:, 2] >= near_distance) & in_image).sum(0)
                too_near |= ((uvd[:, 2] < near_distance) & in_image).any(0)
            # a 0-dim divisor: CUDA divides by a Python scalar through its
            # reciprocal, which can round a fraction one ulp off the CPU's
            count = _div(n_cov.to(torch.float32), n_cams)
            valid = (count > 0) & ~too_near
            counts[c] = count
            density[c] = torch.where(valid, torch.zeros_like(count),
                                     torch.full_like(count, -1.0))
        return state._replace(density_grid=density, count_grid=counts)
