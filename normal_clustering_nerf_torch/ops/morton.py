"""3D Morton (Z-order) encode/decode — port of the JAX package's
`ops/morton.py` (reference: models/csrc/raymarching.cu:35-119).

torch has no uint32, so the bit-twiddling runs on int64: every product
stays below 2^50 and each mask keeps the low 32 bits, which is what the
uint32 arithmetic of the JAX version keeps.
"""
import torch


def _to_int32(v: torch.Tensor) -> torch.Tensor:
    # the uint32 value's two's-complement int32 view
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _expand_bits(v: torch.Tensor) -> torch.Tensor:
    # reference: models/csrc/raymarching.cu:35-42 (__expand_bits)
    v = v.to(torch.int64) & 0xFFFFFFFF
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton3d(coords: torch.Tensor) -> torch.Tensor:
    """(N, 3) int cell coords -> (N,) int32 Morton codes
    (raymarching.cu:44-50)."""
    xx = _expand_bits(coords[..., 0])
    yy = _expand_bits(coords[..., 1])
    zz = _expand_bits(coords[..., 2])
    return _to_int32((xx | (yy << 1) | (zz << 2)) & 0xFFFFFFFF)


def _compact_bits(x: torch.Tensor) -> torch.Tensor:
    # reference: models/csrc/raymarching.cu:52-60 (__morton3D_invert)
    x = x & 0x49249249
    x = (x | (x >> 2)) & 0xC30C30C3
    x = (x | (x >> 4)) & 0x0F00F00F
    x = (x | (x >> 8)) & 0xFF0000FF
    x = (x | (x >> 16)) & 0x0000FFFF
    return x


def morton3d_invert(indices: torch.Tensor) -> torch.Tensor:
    """(N,) Morton codes -> (N, 3) int32 cell coords."""
    idx = indices.to(torch.int64) & 0xFFFFFFFF
    return torch.stack([_compact_bits(idx >> 0), _compact_bits(idx >> 1),
                        _compact_bits(idx >> 2)], dim=-1).to(torch.int32)
