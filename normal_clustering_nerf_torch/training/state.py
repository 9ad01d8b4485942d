"""Optimizer of the port: optax's AdamW chain, written out in PyTorch.

The JAX package optimises with
`optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, eps=1e-15,
weight_decay=1e-6, mask=not hash_table))` (training/state.py:43-79).
This class repeats optax's arithmetic in the same order, so a step from
the same gradients gives the same parameters to f32 rounding:

  * clipping: g <- g / ||g|| * max_norm only when ||g|| >= max_norm, with
    no epsilon (torch.nn.utils.clip_grad_norm_ scales by
    max_norm / (norm + 1e-6) and always, which is another update);
  * Adam moments mu = 0.1 g + 0.9 mu, nu = 0.001 g^2 + 0.999 nu, bias
    corrected by 1 - b^count, update mu_hat / (sqrt(nu_hat) + eps);
  * decoupled weight decay added to the update (not to the hash table),
    then the update scaled by -lr(count);
  * lr(count): cosine annealing stepped per epoch,
    lr * 0.5 * (1 + cos(pi * epoch / num_epochs)).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..config import OptimConfig


def cosine_epoch_lr(base_lr: float, num_epochs: int, steps_per_epoch: int,
                    count: int) -> float:
    """CosineAnnealingLR(T_max=num_epochs) stepped per epoch, in f32 as
    the JAX schedule evaluates it."""
    f32 = np.float32
    epoch = f32(min(count // steps_per_epoch, num_epochs))
    c = np.cos(f32(math.pi) * epoch / f32(num_epochs))
    return float(f32(base_lr * 0.5) * (f32(1.0) + c))


def decays(name: str) -> bool:
    """Weight decay on the networks, none on the hash table."""
    return not name.split(".")[0] == "hash_table"


class AdamW:
    """Clip-by-global-norm + AdamW over named parameters (see module doc)."""

    def __init__(self, params: Dict[str, torch.nn.Parameter],
                 cfg: OptimConfig, b1: float = 0.9, b2: float = 0.999):
        self.params = params
        self.cfg = cfg
        self.b1, self.b2 = b1, b2
        self.state = self.init_state()

    def init_state(self) -> Dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in self.params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in self.params.items()}}

    def lr(self, count: int) -> float:
        o = self.cfg
        return cosine_epoch_lr(o.lr, o.num_epochs, o.steps_per_epoch, count)

    @staticmethod
    def clip(grads: Dict[str, torch.Tensor], max_norm: float):
        """optax.clip_by_global_norm."""
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = g_norm < max_norm
        return {n: torch.where(keep, g, (g / g_norm) * max_norm)
                for n, g in grads.items()}, g_norm

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Update the parameters in place; returns the pre-clip norm."""
        grads, g_norm = self.clip(grads, self.cfg.grad_clip)
        st = self.state
        count = st["count"] + 1
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        neg_lr = -self.lr(st["count"])
        wd = self.cfg.weight_decay_net
        for n, p in self.params.items():
            g = grads[n]
            mu = (1 - self.b1) * g + self.b1 * st["mu"][n]
            nu = (1 - self.b2) * (g * g) + self.b2 * st["nu"][n]
            st["mu"][n], st["nu"][n] = mu, nu
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.cfg.adam_eps)
            if decays(n):
                u = u + wd * p
            p.add_(u * neg_lr)
        st["count"] = count
        return g_norm
