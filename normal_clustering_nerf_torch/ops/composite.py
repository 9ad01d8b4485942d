"""N-channel front-to-back alpha compositing — port of the JAX package's
`ops/composite.py`: `composite_rays` over dense (N, K) samples and
`composite_rays_compact` over the flat layout's ray-major segments
(reference: models/csrc/volumerendering.cu:98-176 forward, :298-418
backward).

Transmittance is exp(-exclusive cumsum of sigma*delta); early ray
termination is the inclusion mask T_excl > T_threshold, so the sample
that crosses the threshold is composited but not counted. The backward
is written out (JAX takes it by autodiff) and takes upstream gradients
on opacity, depth, rend and ws.

`composite_rays` launches kernel H3 (`csrc/composite.cu`) for CUDA
tensors and runs `composite_plain` / `composite_grad_plain` for CPU
tensors; `composite_rays_compact` launches H3's segment launchers, whose
loops are the dense ones, and its plain versions lay the segments out as
dense rows for the dense plain versions (`ops/segops.py`). Neither copies
the JAX flat path's global cumsum minus segment base. Inference rounds
continue a ray's transmittance with `T_start` (forward only: nothing
differentiates an inference round).
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import kernels
from .segops import dense_rows

SIGDT_MAX = 80.0  # exp(-80) ~ 1.8e-35: far below any T_threshold


def _scan(sigmas, deltas, valid, T_threshold, T_start=None):
    raw_x = sigmas * deltas
    x = torch.clamp(torch.where(valid, raw_x, torch.zeros_like(raw_x)),
                    0.0, SIGDT_MAX)
    T = torch.exp(-(torch.cumsum(x, dim=-1) - x))
    if T_start is not None:
        T = T * T_start[:, None]
    alpha = -torch.expm1(-x)
    include = valid & (T > T_threshold)
    w = torch.where(include, alpha * T, torch.zeros_like(T))
    return raw_x, x, T, alpha, include, w


def composite_plain(sigmas, raws, deltas, ts, valid, T_threshold,
                    T_start=None):
    """Plain PyTorch version of the H3 forward."""
    _, _, T, alpha, include, w = _scan(sigmas, deltas, valid, T_threshold,
                                       T_start)
    early = torch.any(include & (T * (1.0 - alpha) <= T_threshold), dim=-1)
    vr = include.sum(dim=-1) - early.to(torch.int64)
    return (w.sum(dim=-1), (w * ts).sum(dim=-1),
            torch.einsum("nk,nkc->nc", w, raws), w, vr.to(torch.int32))


def composite_grad_plain(sigmas, raws, deltas, ts, valid, T_threshold,
                         g_op, g_depth, g_rend, g_ws):
    """Plain PyTorch version of the H3 backward: (d_sigmas, d_raws). G_s
    and the sum of G w over the samples after s are taken in H3's order:
    G's channel terms one after another, the sum back to front from the
    last sample. d_sigma is a difference of the two terms, which can
    cancel to a few 1e-5 of them: summed in another order (an einsum; the
    inclusive suffix less the sample's own term, which cancels where that
    term dominates it), it parted from H3 by more than 1e-4 of a ray's
    largest value on ~0.5% of rays."""
    raw_x, x, T, _, include, w = _scan(sigmas, deltas, valid, T_threshold)
    zero = torch.zeros_like(w)
    G = (g_op[:, None] + g_depth[:, None] * ts) + g_ws
    for c in range(raws.shape[-1]):
        G = G + g_rend[:, c, None] * raws[:, :, c]
    G = torch.where(include, G, zero)
    gw = G * w
    after, suffix = torch.empty_like(gw), gw.new_zeros(gw.shape[0])
    for s in reversed(range(gw.shape[1])):
        after[:, s] = suffix
        suffix = suffix + gw[:, s]
    dx = torch.where(include, G * T * torch.exp(-x), zero) - after
    inside = valid & (raw_x > 0) & (raw_x < SIGDT_MAX)
    d_sigmas = torch.where(inside, dx * deltas, zero)
    d_raws = g_rend[:, None, :] * w[:, :, None]
    return d_sigmas, d_raws


# H3's backward takes rows of up to LANE_ROWS samples on lane groups, a
# lane a sample; longer rows on a warp in chunks of 32 samples, with a
# scratch value a sample (`_long_scratch`)
LANE_ROWS = 32


def _long_scratch(n, max_len, device):
    """The scratch of H3's long-row backward (a float a sample: its G*w,
    read back on the walk from the last chunk), or None for rows the lane
    groups take."""
    if max_len <= LANE_ROWS:
        return None
    return torch.empty(n, dtype=torch.float32, device=device)


def _ptr_or_null(t):
    return None if t is None else kernels.ptr(t)


def _check_inputs(sigmas, raws, deltas, ts, valid):
    """Both launchers take any row length K and any channel count."""
    N, K = sigmas.shape
    C = raws.shape[-1]
    dev, f32 = sigmas.device, torch.float32
    return N, K, C, [
        kernels.check(sigmas, "sigmas", f32, (N, K), dev),
        kernels.check(raws, "raws", f32, (N, K, C), dev),
        kernels.check(deltas, "deltas", f32, (N, K), dev),
        kernels.check(ts, "ts", f32, (N, K), dev),
        kernels.check(valid, "valid", torch.bool, (N, K), dev),
    ]


def composite_kernel(sigmas, raws, deltas, ts, valid, T_threshold,
                     T_start=None):
    N, K, C, args = _check_inputs(sigmas, raws, deltas, ts, valid)
    args.append(None if T_start is None else kernels.check(
        T_start, "T_start", torch.float32, (N,), sigmas.device))
    e = dict(dtype=torch.float32, device=sigmas.device)
    opacity, depth = torch.empty(N, **e), torch.empty(N, **e)
    rend, ws = torch.empty((N, C), **e), torch.empty((N, K), **e)
    vr = torch.empty(N, dtype=torch.int32, device=sigmas.device)
    if N > 0:
        kernels.COMPOSITE_FWD.launch(
            *args, N, K, C, T_threshold, *map(kernels.ptr,
                                              (opacity, depth, rend, ws, vr)),
            device=sigmas.device)
    return opacity, depth, rend, ws, vr


def composite_grad_kernel(sigmas, raws, deltas, ts, valid, T_threshold,
                          g_op, g_depth, g_rend, g_ws):
    N, K, C, args = _check_inputs(sigmas, raws, deltas, ts, valid)
    dev, f32 = sigmas.device, torch.float32
    gargs = [kernels.check(g_op, "g_opacity", f32, (N,), dev),
             kernels.check(g_depth, "g_depth", f32, (N,), dev),
             kernels.check(g_rend, "g_rend", f32, (N, C), dev),
             kernels.check(g_ws, "g_ws", f32, (N, K), dev)]
    d_sigmas = torch.empty((N, K), dtype=f32, device=dev)
    d_raws = torch.empty((N, K, C), dtype=f32, device=dev)
    if N > 0:
        scratch = _long_scratch(N * K, K, dev)
        kernels.COMPOSITE_BWD.launch(
            *args, *gargs, N, K, C, T_threshold, kernels.ptr(d_sigmas),
            kernels.ptr(d_raws), _ptr_or_null(scratch), device=dev)
    return d_sigmas, d_raws


def _d_ts(ctx, g_depth, ws, ray_id=None):
    """The gradient of ts when they carry one (extrinsic optimisation: the
    march's start moves with the pose, models/rendering.py:march_t):
    depth = sum ws * ts gives g_depth * ws (the segment's g_depth in the
    flat layout); None otherwise, and when depth has no cotangent."""
    if not ctx.needs_input_grad[3] or g_depth is None:
        return None
    g = g_depth.to(torch.float32)
    if ray_id is None:
        return g[:, None] * ws
    rid = ray_id.to(torch.int64).clamp(0, g.shape[0] - 1)
    return g[rid] * ws


class CompositeRays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, raws, deltas, ts, valid, T_threshold):
        fn = composite_kernel if sigmas.is_cuda else composite_plain
        opacity, depth, rend, ws, vr = fn(sigmas, raws, deltas, ts, valid,
                                          T_threshold)
        ctx.save_for_backward(sigmas, raws, deltas, ts, valid, ws)
        ctx.T_threshold = T_threshold
        ctx.mark_non_differentiable(vr)
        return opacity, depth, rend, ws, vr

    @staticmethod
    def backward(ctx, g_op, g_depth, g_rend, g_ws, _g_vr):
        sigmas, raws, deltas, ts, valid, ws = ctx.saved_tensors
        N, K = sigmas.shape

        def grad(g, shape):
            if g is None:
                return torch.zeros(shape, dtype=torch.float32,
                                   device=sigmas.device)
            return g.to(torch.float32).contiguous()

        gs = (grad(g_op, (N,)), grad(g_depth, (N,)),
              grad(g_rend, (N, raws.shape[-1])), grad(g_ws, (N, K)))
        fn = composite_grad_kernel if sigmas.is_cuda else composite_grad_plain
        d_sigmas, d_raws = fn(sigmas, raws, deltas, ts, valid,
                              ctx.T_threshold, *gs)
        return d_sigmas, d_raws, None, _d_ts(ctx, g_depth, ws), None, None


def composite_rays(sigmas, raws, deltas, ts, valid, T_threshold=1e-4,
                   T_start=None) -> Dict[str, torch.Tensor]:
    """Composite dense per-ray samples front to back.

    sigmas, deltas, ts: (N, K) f32; raws: (N, K, C) f32; valid: (N, K) bool;
    T_start: optional (N,) transmittance each ray enters with (inference
    rounds continue a ray's composite; no gradient then).
    Returns opacity (N,), depth (N,), rend (N, C), ws (N, K) and
    vr_samples (N,) int32. Gradients flow to sigmas and raws, and to ts
    when they carry one (depth = sum ws * ts).
    """
    args = (sigmas.contiguous(), raws.contiguous(), deltas.contiguous(),
            ts.contiguous(), valid.contiguous(), float(T_threshold))
    if T_start is None:
        opacity, depth, rend, ws, vr = CompositeRays.apply(*args)
    else:
        if torch.is_grad_enabled() and (sigmas.requires_grad
                                        or raws.requires_grad):
            raise NotImplementedError(
                "composite_rays with T_start is forward-only (inference)")
        fn = composite_kernel if sigmas.is_cuda else composite_plain
        opacity, depth, rend, ws, vr = fn(*args, T_start.contiguous())
    return {"opacity": opacity, "depth": depth, "rend": rend, "ws": ws,
            "vr_samples": vr}


# ------------------------------------------------------------ flat layout
def composite_compact_plain(sigmas, raws, deltas, ts, ray_id, ray_start,
                            valid, n_rays, T_threshold, T_start=None):
    """Plain PyTorch version of H3's segment forward: each ray's segment
    as a dense row through `composite_plain`; ws back in the slots."""
    to_rows, from_rows = dense_rows(ray_id, ray_start, valid, n_rays)
    opacity, depth, rend, ws, vr = composite_plain(
        *map(to_rows, (sigmas, raws, deltas, ts, valid)), T_threshold,
        T_start)
    return opacity, depth, rend, from_rows(ws), vr


def composite_compact_grad_plain(sigmas, raws, deltas, ts, ray_id,
                                 ray_start, valid, n_rays, T_threshold,
                                 g_op, g_depth, g_rend, g_ws):
    """Plain PyTorch version of H3's segment backward: (d_sigmas (B,),
    d_raws (B, C)), zero outside the valid slots."""
    to_rows, from_rows = dense_rows(ray_id, ray_start, valid, n_rays)
    d_sigmas, d_raws = composite_grad_plain(
        *map(to_rows, (sigmas, raws, deltas, ts, valid)), T_threshold,
        g_op, g_depth, g_rend, to_rows(g_ws))
    return from_rows(d_sigmas), from_rows(d_raws)


def _check_compact(sigmas, raws, deltas, ts, ray_start, ray_count, valid):
    B, C = raws.shape
    N = ray_start.shape[0]
    dev, f32, i32 = sigmas.device, torch.float32, torch.int32
    return B, N, C, [
        kernels.check(sigmas, "sigmas", f32, (B,), dev),
        kernels.check(raws, "raws", f32, (B, C), dev),
        kernels.check(deltas, "deltas", f32, (B,), dev),
        kernels.check(ts, "ts", f32, (B,), dev),
        kernels.check(valid, "valid", torch.bool, (B,), dev),
    ], [kernels.check(ray_start, "ray_start", i32, (N,), dev),
        kernels.check(ray_count, "ray_count", i32, (N,), dev)]


def composite_compact_kernel(sigmas, raws, deltas, ts, ray_start, ray_count,
                             valid, T_threshold, T_start=None):
    B, N, C, args, seg = _check_compact(sigmas, raws, deltas, ts, ray_start,
                                        ray_count, valid)
    args.append(None if T_start is None else kernels.check(
        T_start, "T_start", torch.float32, (N,), sigmas.device))
    e = dict(dtype=torch.float32, device=sigmas.device)
    opacity, depth = torch.empty(N, **e), torch.empty(N, **e)
    rend, ws = torch.empty((N, C), **e), torch.zeros(B, **e)
    vr = torch.empty(N, dtype=torch.int32, device=sigmas.device)
    if N > 0:
        kernels.COMPOSITE_SEG_FWD.launch(
            *args, *seg, N, C, T_threshold,
            *map(kernels.ptr, (opacity, depth, rend, ws, vr)),
            device=sigmas.device)
    return opacity, depth, rend, ws, vr


def composite_compact_grad_kernel(sigmas, raws, deltas, ts, ray_start,
                                  ray_count, valid, T_threshold, g_op,
                                  g_depth, g_rend, g_ws, max_len=None):
    """`max_len` bounds the segments (the backward sizes its lane groups
    by it, and past LANE_ROWS takes a ray a warp in chunks); None reads it
    from `ray_count` (a host sync, which a CUDA graph's capture
    refuses)."""
    B, N, C, args, seg = _check_compact(sigmas, raws, deltas, ts, ray_start,
                                        ray_count, valid)
    if max_len is None:
        max_len = int(ray_count.max()) if N else 0
    dev, f32 = sigmas.device, torch.float32
    gargs = [kernels.check(g_op, "g_opacity", f32, (N,), dev),
             kernels.check(g_depth, "g_depth", f32, (N,), dev),
             kernels.check(g_rend, "g_rend", f32, (N, C), dev),
             kernels.check(g_ws, "g_ws", f32, (B,), dev)]
    d_sigmas = torch.zeros(B, dtype=f32, device=dev)
    d_raws = torch.zeros((B, C), dtype=f32, device=dev)
    if N > 0:
        scratch = _long_scratch(B, max_len, dev)
        kernels.COMPOSITE_SEG_BWD.launch(
            *args, *gargs, *seg, N, max_len, C, T_threshold,
            kernels.ptr(d_sigmas), kernels.ptr(d_raws), _ptr_or_null(scratch),
            device=dev)
    return d_sigmas, d_raws


class CompositeRaysCompact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, raws, deltas, ts, ray_id, ray_start, ray_count,
                valid, T_threshold, max_len):
        N = ray_start.shape[0]
        if sigmas.is_cuda:
            out = composite_compact_kernel(sigmas, raws, deltas, ts,
                                           ray_start, ray_count, valid,
                                           T_threshold)
        else:
            out = composite_compact_plain(sigmas, raws, deltas, ts, ray_id,
                                          ray_start, valid, N, T_threshold)
        ctx.save_for_backward(sigmas, raws, deltas, ts, ray_id, ray_start,
                              ray_count, valid, out[3])
        ctx.T_threshold, ctx.max_len = T_threshold, max_len
        ctx.mark_non_differentiable(out[4])
        return out

    @staticmethod
    def backward(ctx, g_op, g_depth, g_rend, g_ws, _g_vr):
        (sigmas, raws, deltas, ts, ray_id, ray_start, ray_count,
         valid, ws) = ctx.saved_tensors
        N, B = ray_start.shape[0], sigmas.shape[0]

        def grad(g, shape):
            if g is None:
                return torch.zeros(shape, dtype=torch.float32,
                                   device=sigmas.device)
            return g.to(torch.float32).contiguous()

        gs = (grad(g_op, (N,)), grad(g_depth, (N,)),
              grad(g_rend, (N, raws.shape[-1])), grad(g_ws, (B,)))
        if sigmas.is_cuda:
            d_sigmas, d_raws = composite_compact_grad_kernel(
                sigmas, raws, deltas, ts, ray_start, ray_count, valid,
                ctx.T_threshold, *gs, max_len=ctx.max_len)
        else:
            d_sigmas, d_raws = composite_compact_grad_plain(
                sigmas, raws, deltas, ts, ray_id, ray_start, valid, N,
                ctx.T_threshold, *gs)
        return (d_sigmas, d_raws, None, _d_ts(ctx, g_depth, ws, ray_id),
                None, None, None, None, None, None)


def composite_rays_compact(sigmas, raws, deltas, ts, ray_id, ray_start,
                           valid, n_rays, T_threshold=1e-4, T_start=None, *,
                           ray_count, max_len=None
                           ) -> Dict[str, torch.Tensor]:
    """Composite flat ray-major sample segments (the JAX
    `composite_rays_compact`): ray n's samples are the budget slots
    [ray_start[n], ray_start[n] + ray_count[n]), in order (`ray_count`,
    which the kernel reads, is the march's; the plain version finds the
    segments from `ray_id`). `max_len`, a bound on the segments that the
    caller knows (the march's cap), spares the backward on the card its
    read of the longest one (`composite_compact_grad_kernel`).

    sigmas, deltas, ts: (B,) f32; raws: (B, C) f32; ray_id: (B,) int32;
    ray_start, ray_count: (N,) int32; valid: (B,) bool; T_start: optional
    (N,) entering transmittance (forward only). Returns opacity (N,),
    depth (N,), rend (N, C), ws (B,) and vr_samples (N,) int32; gradients
    flow to sigmas and raws, and to ts when they carry one.
    """
    if ray_start.shape[0] != n_rays:
        raise ValueError(f"ray_start holds {ray_start.shape[0]} rays, "
                         f"n_rays is {n_rays}")
    args = (sigmas.contiguous(), raws.contiguous(), deltas.contiguous(),
            ts.contiguous(), ray_id.contiguous(), ray_start.contiguous(),
            ray_count.contiguous(), valid.contiguous(), float(T_threshold))
    if T_start is None:
        opacity, depth, rend, ws, vr = CompositeRaysCompact.apply(*args,
                                                                  max_len)
    else:
        if torch.is_grad_enabled() and (sigmas.requires_grad
                                        or raws.requires_grad):
            raise NotImplementedError(
                "composite_rays_compact with T_start is forward-only "
                "(inference)")
        s, r, d, t, rid, rs, rc, v, thr = args
        if s.is_cuda:
            opacity, depth, rend, ws, vr = composite_compact_kernel(
                s, r, d, t, rs, rc, v, thr, T_start.contiguous())
        else:
            opacity, depth, rend, ws, vr = composite_compact_plain(
                s, r, d, t, rid, rs, v, n_rays, thr, T_start)
    return {"opacity": opacity, "depth": depth, "rend": rend, "ws": ws,
            "vr_samples": vr}
