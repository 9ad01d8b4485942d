"""N-channel front-to-back alpha compositing over dense (N, K) samples —
port of the JAX package's `ops/composite.py:composite_rays` (reference:
models/csrc/volumerendering.cu:98-176 forward, :298-418 backward).

Transmittance is exp(-exclusive cumsum of sigma*delta); early ray
termination is the inclusion mask T_excl > T_threshold, so the sample
that crosses the threshold is composited but not counted. The backward
is written out (JAX takes it by autodiff) and takes upstream gradients
on opacity, depth, rend and ws.

`composite_rays` launches kernel H3 (`csrc/composite.cu`) for CUDA
tensors and runs `composite_plain` / `composite_grad_plain` for CPU
tensors. T_start continuation (inference rounds) is not ported.
"""
from __future__ import annotations

from typing import Dict

import torch

from .. import kernels

SIGDT_MAX = 80.0  # exp(-80) ~ 1.8e-35: far below any T_threshold


def _scan(sigmas, deltas, valid, T_threshold):
    raw_x = sigmas * deltas
    x = torch.clamp(torch.where(valid, raw_x, torch.zeros_like(raw_x)),
                    0.0, SIGDT_MAX)
    T = torch.exp(-(torch.cumsum(x, dim=-1) - x))
    alpha = -torch.expm1(-x)
    include = valid & (T > T_threshold)
    w = torch.where(include, alpha * T, torch.zeros_like(T))
    return raw_x, x, T, alpha, include, w


def composite_plain(sigmas, raws, deltas, ts, valid, T_threshold):
    """Plain PyTorch version of the H3 forward."""
    _, _, T, alpha, include, w = _scan(sigmas, deltas, valid, T_threshold)
    early = torch.any(include & (T * (1.0 - alpha) <= T_threshold), dim=-1)
    vr = include.sum(dim=-1) - early.to(torch.int64)
    return (w.sum(dim=-1), (w * ts).sum(dim=-1),
            torch.einsum("nk,nkc->nc", w, raws), w, vr.to(torch.int32))


def composite_grad_plain(sigmas, raws, deltas, ts, valid, T_threshold,
                         g_op, g_depth, g_rend, g_ws):
    """Plain PyTorch version of the H3 backward: (d_sigmas, d_raws)."""
    raw_x, x, T, _, include, w = _scan(sigmas, deltas, valid, T_threshold)
    zero = torch.zeros_like(w)
    G = (g_op[:, None] + g_depth[:, None] * ts + g_ws
         + torch.einsum("nc,nkc->nk", g_rend, raws))
    G = torch.where(include, G, zero)
    gw = G * w
    suffix = torch.flip(torch.cumsum(torch.flip(gw, [1]), dim=1), [1]) - gw
    dx = torch.where(include, G * T * torch.exp(-x), zero) - suffix
    inside = valid & (raw_x > 0) & (raw_x < SIGDT_MAX)
    d_sigmas = torch.where(inside, dx * deltas, zero)
    d_raws = g_rend[:, None, :] * w[:, :, None]
    return d_sigmas, d_raws


def _check_inputs(sigmas, raws, deltas, ts, valid):
    N, K = sigmas.shape
    C = raws.shape[-1]
    if K > 32 or C > 16:
        raise ValueError(f"composite kernel takes K <= 32, C <= 16; "
                         f"got K={K}, C={C}")
    dev, f32 = sigmas.device, torch.float32
    return N, K, C, [
        kernels.check(sigmas, "sigmas", f32, (N, K), dev),
        kernels.check(raws, "raws", f32, (N, K, C), dev),
        kernels.check(deltas, "deltas", f32, (N, K), dev),
        kernels.check(ts, "ts", f32, (N, K), dev),
        kernels.check(valid, "valid", torch.bool, (N, K), dev),
    ]


def composite_kernel(sigmas, raws, deltas, ts, valid, T_threshold):
    N, K, C, args = _check_inputs(sigmas, raws, deltas, ts, valid)
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
        kernels.COMPOSITE_BWD.launch(
            *args, *gargs, N, K, C, T_threshold, kernels.ptr(d_sigmas),
            kernels.ptr(d_raws), device=dev)
    return d_sigmas, d_raws


class CompositeRays(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sigmas, raws, deltas, ts, valid, T_threshold):
        fn = composite_kernel if sigmas.is_cuda else composite_plain
        opacity, depth, rend, ws, vr = fn(sigmas, raws, deltas, ts, valid,
                                          T_threshold)
        ctx.save_for_backward(sigmas, raws, deltas, ts, valid)
        ctx.T_threshold = T_threshold
        ctx.mark_non_differentiable(vr)
        return opacity, depth, rend, ws, vr

    @staticmethod
    def backward(ctx, g_op, g_depth, g_rend, g_ws, _g_vr):
        sigmas, raws, deltas, ts, valid = ctx.saved_tensors
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
        return d_sigmas, d_raws, None, None, None, None


def composite_rays(sigmas, raws, deltas, ts, valid,
                   T_threshold=1e-4) -> Dict[str, torch.Tensor]:
    """Composite dense per-ray samples front to back.

    sigmas, deltas, ts: (N, K) f32; raws: (N, K, C) f32; valid: (N, K) bool.
    Returns opacity (N,), depth (N,), rend (N, C), ws (N, K) and
    vr_samples (N,) int32. Gradients flow to sigmas and raws.
    """
    opacity, depth, rend, ws, vr = CompositeRays.apply(
        sigmas.contiguous(), raws.contiguous(), deltas.contiguous(),
        ts.contiguous(), valid.contiguous(), float(T_threshold))
    return {"opacity": opacity, "depth": depth, "rend": rend, "ws": ws,
            "vr_samples": vr}
