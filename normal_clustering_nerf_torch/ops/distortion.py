"""Mip-NeRF-360 distortion loss on the dense (N, K) layout — port of the
JAX package's `ops/distortion.py:distortion_loss_dense` (reference:
models/csrc/losses.cu:62-140).

Per ray: sum_s 2*(wts_incl_s*ws_excl_s - ws_incl_s*wts_excl_s)
+ w_s^2*delta_s/3 over valid samples. The backward is the closed form of
`distortion_reference_grad`; gradients flow to `ws` only (t and delta
are constants of the march).

`distortion_loss_dense` launches kernel H4 (`csrc/distortion.cu`) for
CUDA tensors and runs the plain versions for CPU tensors.
"""
from __future__ import annotations

import torch

from .. import kernels


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
