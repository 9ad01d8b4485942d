"""Gradient-clamped activations — port of the JAX package's
`ops/trunc_exp.py`.

trunc_exp: forward exp(x); backward g * exp(clamp(x, -15, 15))
(reference: models/custom_functions.py:162-173).
trunc_sigmoid: forward sigmoid(x); backward sigmoid' evaluated at
clamp(x, -10, 10), so a saturated colour head can recover.
"""
import torch


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -15.0, 15.0))


class _TruncSigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.sigmoid(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        s = torch.sigmoid(torch.clamp(x, -10.0, 10.0))
        return g * s * (1.0 - s)


def trunc_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncExp.apply(x)


def trunc_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return _TruncSigmoid.apply(x)
