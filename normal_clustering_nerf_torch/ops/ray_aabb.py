"""Ray / axis-aligned-box intersection (slab test) — port of the JAX
package's `ops/ray_aabb.py` (reference: models/csrc/intersection.cu:5-100,
one-box fast path)."""
import torch


def ray_aabb_intersect(rays_o, rays_d, center, half_size):
    """Slab test of N rays against one AABB.

    Returns hits_t (N, 2) [t_near, t_far], near clamped to 0, and
    (-1, -1) where the ray misses (t1 > t2 or t2 <= 0).
    """
    inv_d = 1.0 / rays_d
    t_lo = (center - half_size - rays_o) * inv_d
    t_hi = (center + half_size - rays_o) * inv_d
    t1 = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    t2 = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    hit = (t1 <= t2) & (t2 > 0)
    near = torch.clamp(t1, min=0.0)
    out = torch.stack([near, t2], dim=-1)
    return torch.where(hit[:, None], out, torch.full_like(out, -1.0))
