"""Mip-NeRF-360 distortion loss — port of the JAX package's
`ops/distortion.py`: `distortion_loss_dense` on the dense (N, K) layout
and `distortion_loss` on the flat layout's ray-major segments (reference:
models/csrc/losses.cu:62-140).

Per ray: sum_s 2*(wts_incl_s*ws_excl_s - ws_incl_s*wts_excl_s)
+ w_s^2*delta_s/3 over valid samples. The backward is the closed form of
`distortion_reference_grad`; gradients flow to `ws` only (t and delta
are constants of the march).

`distortion_loss_dense` launches kernel H4 (`csrc/distortion.cu`) for
CUDA tensors and runs the plain versions for CPU tensors;
`distortion_loss` launches H4's segment launchers (the same loops), and
its plain versions scan each segment on its own (`ops/segops.py`), not
with the JAX flat path's global cumsum.
"""
from __future__ import annotations

import torch

from .. import kernels
from .segops import dense_rows, segment_cumsum


def distortion_plain(ws, deltas, ts, valid):
    """Plain PyTorch version of the H4 forward: (N,) per-ray loss."""
    w = torch.where(valid, ws, torch.zeros_like(ws))
    wts = w * ts
    ws_in = torch.cumsum(w, dim=-1)
    wts_in = torch.cumsum(wts, dim=-1)
    ws_ex = ws_in - w
    wts_ex = wts_in - wts
    per = (2.0 * (wts_in * ws_ex - ws_in * wts_ex)
           + (1.0 / 3.0) * w * w * deltas)
    return torch.where(valid, per, torch.zeros_like(per)).sum(dim=-1)


def distortion_grad_plain(g_loss, ws, deltas, ts, valid):
    """Plain PyTorch version of the H4 backward: dL/dws (N, K)."""
    w = torch.where(valid, ws, torch.zeros_like(ws))
    wts = w * ts
    ws_in = torch.cumsum(w, dim=-1)
    wts_in = torch.cumsum(wts, dim=-1)
    ws_sum = ws_in[:, -1:]
    wts_sum = wts_in[:, -1:]
    head = ts * (ws_in - w) - (wts_in - wts)
    tail = wts_sum - wts_in - ts * (ws_sum - ws_in)
    g = g_loss[:, None]
    d = g * 2.0 * (head + tail) + g * (2.0 / 3.0) * w * deltas
    return torch.where(valid, d, torch.zeros_like(d))


def _args(ws, deltas, ts, valid):
    N, K = ws.shape
    dev, f32 = ws.device, torch.float32
    return N, K, [kernels.check(ws, "ws", f32, (N, K), dev),
                  kernels.check(deltas, "deltas", f32, (N, K), dev),
                  kernels.check(ts, "ts", f32, (N, K), dev),
                  kernels.check(valid, "valid", torch.bool, (N, K), dev)]


def distortion_kernel(ws, deltas, ts, valid):
    N, K, args = _args(ws, deltas, ts, valid)
    loss = torch.empty(N, dtype=torch.float32, device=ws.device)
    if N > 0:
        kernels.DISTORTION_FWD.launch(*args, N, K, kernels.ptr(loss),
                                      device=ws.device)
    return loss


def distortion_grad_kernel(g_loss, ws, deltas, ts, valid):
    N, K, args = _args(ws, deltas, ts, valid)
    gp = kernels.check(g_loss, "g_loss", torch.float32, (N,), ws.device)
    d_ws = torch.empty((N, K), dtype=torch.float32, device=ws.device)
    if N > 0:
        kernels.DISTORTION_BWD.launch(gp, *args, N, K, kernels.ptr(d_ws),
                                      device=ws.device)
    return d_ws


class DistortionLoss(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ws, deltas, ts, valid):
        ctx.save_for_backward(ws, deltas, ts, valid)
        fn = distortion_kernel if ws.is_cuda else distortion_plain
        return fn(ws, deltas, ts, valid)

    @staticmethod
    def backward(ctx, g):
        ws, deltas, ts, valid = ctx.saved_tensors
        fn = distortion_grad_kernel if ws.is_cuda else distortion_grad_plain
        return fn(g.to(torch.float32).contiguous(), ws, deltas, ts,
                  valid), None, None, None


def distortion_loss_dense(ws, deltas, ts, valid) -> torch.Tensor:
    """(N, K) weights, steps, distances and validity -> (N,) loss."""
    return DistortionLoss.apply(ws.contiguous(), deltas.contiguous(),
                                ts.contiguous(), valid.contiguous())


# ------------------------------------------------------------ flat layout
def distortion_compact_plain(ws, deltas, ts, ray_id, ray_start, valid,
                             n_rays):
    """Plain PyTorch version of H4's segment forward: the JAX
    `distortion_loss` (distortion.py:19-33) with per-segment scans."""
    w = torch.where(valid, ws, torch.zeros_like(ws))
    wts = w * ts
    ws_in, ws_ex = segment_cumsum(w, ray_id, ray_start)
    wts_in, wts_ex = segment_cumsum(wts, ray_id, ray_start)
    per = (2.0 * (wts_in * ws_ex - ws_in * wts_ex)
           + (1.0 / 3.0) * w * w * deltas)
    to_rows, _ = dense_rows(ray_id, ray_start, valid, n_rays)
    return to_rows(per).sum(dim=-1)


def distortion_compact_grad_plain(g_loss, ws, deltas, ts, ray_id, ray_start,
                                  valid, n_rays):
    """Plain PyTorch version of H4's segment backward: each segment as a
    dense row through `distortion_grad_plain` (the closed form of
    `distortion_reference_grad`, distortion.py:55-74); dL/dws (B,)."""
    to_rows, from_rows = dense_rows(ray_id, ray_start, valid, n_rays)
    return from_rows(distortion_grad_plain(
        g_loss, *map(to_rows, (ws, deltas, ts, valid))))


def _seg_args(ws, deltas, ts, valid, ray_start, ray_count):
    B, N = ws.shape[0], ray_start.shape[0]
    dev, f32, i32 = ws.device, torch.float32, torch.int32
    return N, [kernels.check(ws, "ws", f32, (B,), dev),
               kernels.check(deltas, "deltas", f32, (B,), dev),
               kernels.check(ts, "ts", f32, (B,), dev),
               kernels.check(valid, "valid", torch.bool, (B,), dev),
               kernels.check(ray_start, "ray_start", i32, (N,), dev),
               kernels.check(ray_count, "ray_count", i32, (N,), dev)]


def distortion_compact_kernel(ws, deltas, ts, valid, ray_start, ray_count):
    N, args = _seg_args(ws, deltas, ts, valid, ray_start, ray_count)
    loss = torch.empty(N, dtype=torch.float32, device=ws.device)
    if N > 0:
        kernels.DISTORTION_SEG_FWD.launch(*args, N, kernels.ptr(loss),
                                          device=ws.device)
    return loss


def distortion_compact_grad_kernel(g_loss, ws, deltas, ts, valid, ray_start,
                                   ray_count):
    N, args = _seg_args(ws, deltas, ts, valid, ray_start, ray_count)
    gp = kernels.check(g_loss, "g_loss", torch.float32, (N,), ws.device)
    d_ws = torch.zeros_like(ws)
    if N > 0:
        kernels.DISTORTION_SEG_BWD.launch(gp, *args, N, kernels.ptr(d_ws),
                                          device=ws.device)
    return d_ws


class DistortionLossCompact(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ws, deltas, ts, ray_id, ray_start, ray_count, valid):
        ctx.save_for_backward(ws, deltas, ts, ray_id, ray_start, ray_count,
                              valid)
        if ws.is_cuda:
            return distortion_compact_kernel(ws, deltas, ts, valid,
                                             ray_start, ray_count)
        return distortion_compact_plain(ws, deltas, ts, ray_id, ray_start,
                                        valid, ray_start.shape[0])

    @staticmethod
    def backward(ctx, g):
        ws, deltas, ts, ray_id, ray_start, ray_count, valid = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        if ws.is_cuda:
            d = distortion_compact_grad_kernel(g, ws, deltas, ts, valid,
                                               ray_start, ray_count)
        else:
            d = distortion_compact_grad_plain(g, ws, deltas, ts, ray_id,
                                              ray_start, valid,
                                              ray_start.shape[0])
        return d, None, None, None, None, None, None


def distortion_loss(ws, deltas, ts, ray_id, ray_start, valid, n_rays, *,
                    ray_count) -> torch.Tensor:
    """Per-ray loss over flat ray-major samples (the JAX
    `distortion_loss`): (B,) weights, steps, distances and validity, the
    segments of `compact_samples` ((N,) int32 ray_start and ray_count;
    (B,) int32 ray_id) -> (N,) loss. Gradients flow to `ws`."""
    if ray_start.shape[0] != n_rays:
        raise ValueError(f"ray_start holds {ray_start.shape[0]} rays, "
                         f"n_rays is {n_rays}")
    return DistortionLossCompact.apply(
        ws.contiguous(), deltas.contiguous(), ts.contiguous(),
        ray_id.contiguous(), ray_start.contiguous(), ray_count.contiguous(),
        valid.contiguous())
