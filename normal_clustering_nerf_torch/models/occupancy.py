"""Occupancy-grid maintenance over explicit state — port of the JAX
package's `models/occupancy.py` (reference: models/ngp_mt.py:231-368).

The density grid, bitfield and coverage counts live in an
`OccupancyState`; every update returns a new state, which the trainer
copies into its own (`OccupancyState.copy_`). Cells are indexed
linearly, x fastest, within each cascade, which is the layout the march
probes. Random draws (sampled cells, their jitter) are separable: each
function that draws takes them as optional arguments.
"""
from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import ModelConfig
from ..device import as_index
from ..ops.packbits import packbits, unpack_bits

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
        uniform over all cells when none does.

        `draws` holds "uniform" (C, M) cell indices and either "occ_rank"
        (C, M) ranks into the occupied list (cell indices when it is
        empty), as a test passes the JAX package's draws, or "occ_u"
        (C, M) uniforms in [0, 1) scaled to that range.
        Returns (indices (C, 2M), coords (C, 2M, 3)).
        """
        G3 = self.G ** 3
        all_idx = []
        for c in range(self.cascades):
            occ = state.density_grid[c] > density_threshold
            occ_list = torch.nonzero(occ).reshape(-1)
            n_occ = occ_list.numel()
            if "occ_rank" in draws:
                r = as_index(draws["occ_rank"][c], self.device)
            else:
                r = (draws["occ_u"][c] * (n_occ if n_occ else G3)).long()
                r = r.clamp(max=(n_occ if n_occ else G3) - 1)
            occ_idx = occ_list[r] if n_occ > 0 else r
            all_idx.append(torch.cat([as_index(draws["uniform"][c],
                                               self.device),
                                      occ_idx]))
        idx = torch.stack(all_idx)
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
        grid = torch.where(state.density_grid < 0, state.density_grid,
                           torch.maximum(state.density_grid * decay, tmp))
        pos = grid > 0
        mean_density = (torch.where(pos, grid, torch.zeros_like(grid)).sum()
                        / torch.clamp(pos.sum(), min=1))
        thr = torch.clamp(mean_density, max=density_threshold)
        bitfield = packbits(grid, thr)
        return OccupancyState(grid, bitfield, state.count_grid,
                              coarse_occupancy(bitfield, self.G),
                              *supervoxel_tables(bitfield, self.G))

    # ---------------------------------------------------- visibility marks
    def mark_invisible_cells(self, state: OccupancyState, poses, img_wh,
                             near_distance: float, K) -> OccupancyState:
        """Mark cells no camera sees with density -1 and store each
        cell's camera-coverage fraction (occupancy.py:240-291, pinhole K).

        Unlike the JAX version, which projects every cell into every
        camera at once (a (N_cams, 3, G^3) intermediate, 1.2 GB at 48
        cameras and G = 128), this loops over chunks of `_MARK_CHUNK`
        cameras and accumulates the per-cell counts.
        """
        if not isinstance(K, torch.Tensor):
            K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
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
                uvd = K @ xyzs_c
                uv = uvd[:, :2] / uvd[:, 2:]
                in_image = ((uvd[:, 2] >= 0)
                            & (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
                            & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1]))
                n_cov += ((uvd[:, 2] >= near_distance) & in_image).sum(0)
                too_near |= ((uvd[:, 2] < near_distance) & in_image).any(0)
            count = n_cov.to(torch.float32) / n_cams
            valid = (count > 0) & ~too_near
            counts[c] = count
            density[c] = torch.where(valid, torch.zeros_like(count),
                                     torch.full_like(count, -1.0))
        return state._replace(density_grid=density, count_grid=counts)
