"""Ray / axis-aligned-box intersection (slab test) — port of the JAX
package's `ops/ray_aabb.py` (reference: models/csrc/intersection.cu:5-100,
one-box fast path)."""
import torch


def ray_aabb_intersect(rays_o, rays_d, center, half_size):
    """Slab test of N rays against one AABB.

    Returns hits_t (N, 2) [t_near, t_far], near clamped to 0, and
    (-1, -1) where the ray misses (t1 > t2 or t2 <= 0).

    When the rays carry a gradient (extrinsic optimisation), a direction
    component that is exactly 0 gives its slab ts of +-inf, which the min /
    max never select; their gradient is 0 there. Autodiff of the plain
    form gives 0 * inf = NaN for it (through 1/d and through the products
    with 1/d), which the optimizer's global-norm clip spreads to every
    parameter; JAX's autodiff does the same. So the ts of such a component
    are taken detached and its gradient path is fed a finite stand-in; the
    values are those of the plain form, bit for bit.
    """
    lo, hi = center - half_size - rays_o, center + half_size - rays_o
    if not (rays_o.requires_grad or rays_d.requires_grad):
        inv_d = 1.0 / rays_d
        t_lo, t_hi = lo * inv_d, hi * inv_d
    else:
        flat = rays_d == 0
        inv_d = 1.0 / torch.where(flat, torch.ones_like(rays_d), rays_d)
        inv_0 = (1.0 / rays_d).detach()
        live = torch.where(flat, torch.zeros_like(inv_d), inv_d)
        t_lo, t_hi = (torch.where(flat, (b * inv_0).detach(), b * live)
                      for b in (lo, hi))
    t1 = torch.amax(torch.minimum(t_lo, t_hi), dim=-1)
    t2 = torch.amin(torch.maximum(t_lo, t_hi), dim=-1)
    hit = (t1 <= t2) & (t2 > 0)
    near = torch.clamp(t1, min=0.0)
    out = torch.stack([near, t2], dim=-1)
    return torch.where(hit[:, None], out, torch.full_like(out, -1.0))


def ray_sphere_intersect(rays_o, rays_d, center, radius):
    """Ray / sphere intersection by the quadratic solve (reference:
    models/csrc/intersection.cu:103-197; not on the main path). The same
    conventions as `ray_aabb_intersect`: (N, 2) [t_near, t_far], near
    clamped to 0, (-1, -1) on a miss."""
    oc = rays_o - center
    a = torch.sum(rays_d * rays_d, dim=-1)
    b = 2.0 * torch.sum(oc * rays_d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - 4.0 * a * c
    ok = disc >= 0
    sq = torch.sqrt(torch.where(ok, disc, torch.zeros_like(disc)))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    hit = ok & (t2 > 0)
    out = torch.stack([torch.clamp(t1, min=0.0), t2], dim=-1)
    return torch.where(hit[:, None], out, torch.full_like(out, -1.0))
