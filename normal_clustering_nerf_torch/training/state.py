"""Optimizer of the port: optax's AdamW chain, written out in PyTorch.

The JAX package optimises with
`optax.chain(clip_by_global_norm(grad_clip), adamw(schedule, eps=1e-15,
weight_decay=1e-6, mask=not hash_table))` (training/state.py:43-79), and
the parameters beside the model's each with its own Adam, no weight
decay, their gradients clipped with the others: the Manhattan-SDF angle
`theta_WF` with `adam(schedule)`, the per-image extrinsic deltas `dR` and
`dT` (`optimize_ext`) with `adam(1e-6)`, the global normal-frame rotation
`dR_glob` (`lr_dR_norm_glob > 0`) with `adam(lr_dR_norm_glob)`; a
constant lr is a 0-dim tensor on the device, which the update scales by
its negation as optax's `scale(-lr)` does. The update is one call of
`ops/adamw.py:clipped_adamw` over every parameter (kernel K9 on the card,
two launches), which repeats optax's arithmetic in the same order, so a
step from the same gradients gives the same parameters to f32 rounding:

  * clipping: g <- g / ||g|| * max_norm only when ||g|| >= max_norm, with
    no epsilon, ||g|| summed in K9's fixed order
    (torch.nn.utils.clip_grad_norm_ scales by
    max_norm / (norm + 1e-6) and always, which is another update);
  * Adam moments mu = 0.1 g + 0.9 mu, nu = 0.001 g^2 + 0.999 nu, bias
    corrected by 1 - b^count, update mu_hat / (sqrt(nu_hat) + eps);
  * decoupled weight decay added to the update (not to the hash table
    or theta_WF), then the update scaled by -lr(count);
  * lr(count): cosine annealing stepped per epoch,
    lr * 0.5 * (1 + cos(pi * epoch / num_epochs)).

The scalars that change with the step (the lr, the bias corrections, the
clustering loss weights, the interval annealing's fraction and whether
it applies, the clustering window, whether the step is past
`norm_can_start`) are a table on the device,
`schedule_table`, one row per step, computed once with the host
functions below; a step indexes it with its device counters, so that a
CUDA graph of the step reads the right row at every replay. The
moments, like the parameters, are updated in their own storages.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..config import OptimConfig, TrainConfig
from ..losses import CLUSTERING_TERMS, loss_schedule
from ..models.rendering import anneal_schedule
from ..ops import adamw

# the columns of `schedule_table`: row i holds the optimizer's scalars at
# its count i (lr(i), the bias corrections 1 - b^(i+1)) and the trainer's
# at its step i (each clustering term's weight, the configured annealing
# strategy's fraction n_i and whether it applies, whether the clustering
# window is open, whether the step is past norm_can_start)
SCHEDULE_COLUMNS = ("lr", "bc1", "bc2") + tuple(
    f"w_{t}" for t in CLUSTERING_TERMS) + ("anneal_n_i", "anneal_on",
                                          "in_window", "after_start")
OPT_COLUMNS = 3   # the optimizer's, indexed by its count


def cosine_epoch_lr(base_lr: float, num_epochs: int, steps_per_epoch: int,
                    count: int) -> float:
    """CosineAnnealingLR(T_max=num_epochs) stepped per epoch, in f32 as
    the JAX schedule evaluates it."""
    f32 = np.float32
    epoch = f32(min(count // steps_per_epoch, num_epochs))
    c = np.cos(f32(math.pi) * epoch / f32(num_epochs))
    return float(f32(base_lr * 0.5) * (f32(1.0) + c))


# the lr of the extrinsic deltas dR / dT (state.py:69-71; reference:
# train_nerf.py:267-270)
EXT_LR = 1e-6


def decays(name: str) -> bool:
    """Weight decay on the networks; none on the hash table
    (train_nerf.py:284-285) or on the parameters beside the model's
    (theta_WF, dR, dT, dR_glob), which JAX's `build_optimizer` gives plain
    Adam."""
    return name.split(".")[0] not in ("hash_table", "theta_WF", "dR", "dT",
                                      "dR_glob")


def constant_lr(name: str, cfg: OptimConfig):
    """The constant lr of a parameter outside the cosine schedule: EXT_LR
    for dR and dT, lr_dR_norm_glob for dR_glob; None for the others."""
    return {"dR": EXT_LR, "dT": EXT_LR,
            "dR_glob": cfg.lr_dR_norm_glob}.get(name)


class AdamW:
    """Clip-by-global-norm + AdamW over named parameters (see module doc)."""

    def __init__(self, params: Dict[str, torch.nn.Parameter],
                 cfg: OptimConfig, b1: float = 0.9, b2: float = 0.999):
        self.params = params
        self.cfg = cfg
        self.b1, self.b2 = b1, b2
        self.hyper = adamw.Hyper(b1, b2, cfg.adam_eps, cfg.weight_decay_net,
                                 cfg.grad_clip)
        self.state = self.init_state()
        dev = next(iter(params.values())).device
        # the count on the device, which `update` advances (a captured
        # step included); state["count"] is its host copy (`advance`)
        self.count_t = torch.zeros((), dtype=torch.int64, device=dev)
        # -lr of the parameters at a constant lr, as the f32 optax scales by
        self.neg_const_lr = {
            n: torch.tensor(-constant_lr(n, cfg), dtype=torch.float32,
                            device=dev)
            for n in params if constant_lr(n, cfg) is not None}

    def init_state(self) -> Dict:
        return {"count": 0,
                "mu": {n: torch.zeros_like(p) for n, p in self.params.items()},
                "nu": {n: torch.zeros_like(p) for n, p in self.params.items()}}

    @torch.no_grad()
    def load_state(self, state: Dict):
        """Take over `state` (count and moments) into this optimizer's own
        storages, which a captured step reads and writes."""
        for k in ("mu", "nu"):
            for n, t in self.state[k].items():
                t.copy_(state[k][n])
        self.state["count"] = int(state["count"])
        self.count_t.fill_(self.state["count"])

    def lr(self, count: int) -> float:
        o = self.cfg
        return cosine_epoch_lr(o.lr, o.num_epochs, o.steps_per_epoch, count)

    def schedule(self, count: int) -> Tuple[float, float, float]:
        """(lr, bc1, bc2) of the step taken at `count`: the lr at `count`
        and the bias corrections 1 - b^(count + 1), in f32."""
        f32, c = np.float32, np.float32(count + 1)
        return (self.lr(count), float(f32(1.0) - f32(self.b1) ** c),
                float(f32(1.0) - f32(self.b2) ** c))

    def slots(self, grads: Dict[str, torch.Tensor],
              lr: torch.Tensor) -> List[adamw.Slot]:
        """K9's tensors of a step, in the parameters' order: each
        parameter with its gradient, its moments, its lr (the step table's
        `lr`, or its constant one's negation) and its weight decay."""
        st = self.state
        return [adamw.Slot(p, grads[n], st["mu"][n], st["nu"][n],
                           self.neg_const_lr.get(n, lr),
                           n not in self.neg_const_lr, decays(n))
                for n, p in self.params.items()]

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor], lr: torch.Tensor,
               bc1: torch.Tensor, bc2: torch.Tensor) -> torch.Tensor:
        """Update the parameters and the moments in place, on the device
        only, through `ops.adamw.clipped_adamw` (K9 on the card, two
        launches): `lr`, `bc1` and `bc2` are 0-dim f32 tensors (the row of
        `schedule_table` at `count_t`), divided by as tensors (one
        rounding on the card too, where a Python divisor becomes a product
        with its reciprocal). Advances `count_t` (on the card, in K9's
        first launch); the caller advances the host count (`advance`).
        Returns the pre-clip norm."""
        return adamw.clipped_adamw(self.slots(grads, lr), bc1, bc2,
                                   self.count_t, self.hyper)

    def advance(self):
        self.state["count"] += 1


def schedule_row(opt: AdamW, cfg: TrainConfig, i: int) -> Tuple[float, ...]:
    """Row i of `schedule_table`, from the host functions: the optimizer's
    `schedule(i)`, `losses.loss_schedule` and
    `models.rendering.anneal_schedule` at step i."""
    loss = loss_schedule(cfg.loss, i)
    n_i, on = anneal_schedule(i, cfg.render.anneal_steps,
                              cfg.render.anneal_strategy)
    return (*opt.schedule(i), *(loss[f"w_{t}"] for t in CLUSTERING_TERMS),
            n_i, float(on), loss["in_window"], loss["after_start"])


def schedule_table(opt: AdamW, cfg: TrainConfig, n_rows: int,
                   device) -> torch.Tensor:
    """(n_rows, len(SCHEDULE_COLUMNS)) f32 on `device`: the step scalars of
    steps 0..n_rows-1 (see SCHEDULE_COLUMNS)."""
    rows = np.array([schedule_row(opt, cfg, i) for i in range(n_rows)],
                    np.float32).reshape(n_rows, len(SCHEDULE_COLUMNS))
    return torch.as_tensor(rows, device=device)
