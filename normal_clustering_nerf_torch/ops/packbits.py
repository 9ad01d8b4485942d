"""Occupancy-grid bit packing — port of the JAX package's
`ops/packbits.py` (reference: models/csrc/raymarching.cu:122-161).

One bit per cell, 8 cells per byte, little-endian within a byte (bit i
of byte n = cell 8n+i); cells in linear x-fastest order within a
cascade, the layout `ops/ray_march.py` probes.
"""
import torch

_WEIGHTS = (1, 2, 4, 8, 16, 32, 64, 128)


def packbits(density_grid: torch.Tensor, density_threshold) -> torch.Tensor:
    """(..., 8*N) float densities -> (N_total,) uint8 bitfield."""
    occ = (density_grid.reshape(-1) > density_threshold).reshape(-1, 8)
    w = torch.tensor(_WEIGHTS, dtype=torch.int32, device=occ.device)
    return (occ.to(torch.int32) * w).sum(dim=-1).to(torch.uint8)


def unpack_bits(bitfield: torch.Tensor) -> torch.Tensor:
    """(N,) uint8 -> (8N,) bool, inverse of `packbits`."""
    w = torch.tensor(_WEIGHTS, dtype=torch.uint8, device=bitfield.device)
    return ((bitfield[:, None] & w) > 0).reshape(-1)


def unpack_bit(bitfield: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Occupancy bits of flat cell indices `idx` (int64)."""
    byte = bitfield[idx >> 3].to(torch.int64)
    return ((byte >> (idx & 7)) & 1).to(torch.bool)
