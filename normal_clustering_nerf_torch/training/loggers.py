"""Metric logging: TensorBoard, and Weights & Biases on request (the
port's copy of the JAX package's `training/loggers.py`; reference:
train_nerf.py:901-943).

TensorBoard through tensorboardX, or `torch.utils.tensorboard` where that
imports; W&B in offline mode (the reference also runs wandb offline and
syncs afterwards). A backend whose package does not import logs nothing,
as in the JAX version; each such backend is named once in a warning.
"""
from __future__ import annotations

import os
import warnings
from typing import Dict, Optional


def _summary_writer(log_dir: str):
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            warnings.warn("neither tensorboardX nor torch.utils.tensorboard "
                          "imports: no TensorBoard logs", RuntimeWarning)
            return None
    return SummaryWriter(log_dir)


class MetricLogger:
    def __init__(self, log_dir: str, use_wandb: bool = False,
                 wandb_project: str = "ncnerf_tpu", run_name: str = "",
                 config: Optional[dict] = None):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self.tb = _summary_writer(log_dir)
        self.wandb = None
        if use_wandb:
            try:
                import wandb
            except ImportError:
                warnings.warn("wandb does not import: no W&B logs",
                              RuntimeWarning)
            else:
                os.environ.setdefault("WANDB_MODE", "offline")
                self.wandb = wandb.init(
                    project=wandb_project, name=run_name or None,
                    dir=log_dir, config=config or {})

    def log_scalars(self, metrics: Dict[str, float], step: int,
                    prefix: str = ""):
        for k, v in metrics.items():
            if self.tb is not None:
                self.tb.add_scalar(f"{prefix}{k}", float(v), step)
        if self.wandb is not None:
            self.wandb.log(
                {f"{prefix}{k}": float(v) for k, v in metrics.items()},
                step=step)

    def log_image(self, name: str, img, step: int):
        if self.tb is not None:
            self.tb.add_image(name, img, step, dataformats="HWC")
        if self.wandb is not None:
            import wandb
            self.wandb.log({name: wandb.Image(img)}, step=step)

    def close(self):
        if self.tb is not None:
            self.tb.close()
        if self.wandb is not None:
            self.wandb.finish()
