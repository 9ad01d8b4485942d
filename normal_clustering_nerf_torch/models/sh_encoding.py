"""Degree-4 real spherical-harmonics direction encoding — port of the
JAX package's `models/sh_encoding.py`.

The reference instantiates a SphericalHarmonics direction encoder but
bypasses it in its forward, concatenating the raw normalised direction
(reference: models/ngp_mt.py:94-101, 207-209); the JAX forward and the
port's `NGPMT.forward` bypass it likewise. The coefficients are the
standard hard-coded real-SH basis (tcnn's sh.h, Instant-NGP); the inputs
are unit directions.
"""
import torch


def sh_encode_deg4(d: torch.Tensor) -> torch.Tensor:
    """(N, 3) unit directions -> (N, 16) SH basis values (degrees 0..3)."""
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    xx, yy, zz = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814),            # l0
        -0.48860251190291987 * y,                          # l1
        0.48860251190291987 * z,
        -0.48860251190291987 * x,
        1.0925484305920792 * xy,                           # l2
        -1.0925484305920792 * yz,
        0.94617469575755997 * zz - 0.31539156525251999,
        -1.0925484305920792 * xz,
        0.54627421529603959 * (xx - yy),
        0.59004358992664352 * y * (-3.0 * xx + yy),        # l3
        2.8906114426405538 * xy * z,
        0.45704579946446572 * y * (1.0 - 5.0 * zz),
        0.3731763325901154 * z * (5.0 * zz - 3.0),
        0.45704579946446572 * x * (1.0 - 5.0 * zz),
        1.4453057213202769 * z * (xx - yy),
        0.59004358992664352 * x * (-xx + 3.0 * yy),
    ], dim=-1)
