"""Training CLI of the port, the JAX package's `train_nerf.py` on the card:

    python -m normal_clustering_nerf_torch.train_nerf <flags of train_nerf.py>
    NCNERF_PLATFORM=cpu python -m normal_clustering_nerf_torch.train_nerf ...

The same flags (`TrainConfig.from_args`) and the same order of work
(train_nerf.py:15-116): the debug schedule unless `--no_debug`; the
dataset (the synthetic room, or a loader reading `--data_root_dir`);
`--weight_path` (an npz of either package), then `--ckpt_path` (a full
checkpoint of the port: parameters, optimizer, occupancy, step and
generator); the `MetricLogger` (W&B too under `--no_debug`); unless
`--val_only`, the invisible-cell marking and `fit` up to `num_epochs *
steps_per_epoch`, logging every 100 steps (10 in the debug schedule);
`validate`, writing `results/` (`--save_test_vis`) and `preds/`
(`--save_test_preds`); `save_train_preds` (`--save_train_preds`);
`results.csv`; the checkpoint `<log_dir>/ckpt` (`--save_checkpoint`).
After a full checkpoint the marking is skipped: the restored occupancy
holds it, and marking again would zero the trained densities (the JAX
CLI marks again, so its resumed run does not continue as the
uninterrupted one).

`--num_chips N` trains on N cards of this host (train_nerf.py:33-34 joins
the hosts first): without a process group in the environment, `main`
starts N processes itself (`parallel.launch.spawn`), each of which runs
`main` as one rank (under a launcher each process is one already:
`parallel.launch.initialize_multihost`). Rank 0 alone writes the
logger's files, the exports, results.csv and the checkpoint, and its
validation metrics are what `main` returns.

It runs on the card. `NCNERF_PLATFORM` (the JAX CLI's variable) unset,
"cuda" or "gpu" means the card, "cpu" the plain PyTorch versions on the
CPU; anything else raises. `NCNERF_PROFILE_DIR=<dir>` traces `fit` with
torch.profiler into a TensorBoard trace there.
"""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, Optional

import torch

from .config import TrainConfig


def platform_device(device=None) -> str:
    """The device a run uses: `device` if given, else NCNERF_PLATFORM's."""
    if device is not None:
        return device
    platform = os.environ.get("NCNERF_PLATFORM", "").lower()
    if platform in ("", "cuda", "gpu"):
        return "cuda"
    if platform == "cpu":
        return "cpu"
    raise ValueError(f"NCNERF_PLATFORM={platform!r}: expected cuda, gpu or "
                     "cpu")


def build_datasets(cfg: TrainConfig):
    """The train and test datasets of `cfg` (train_nerf.py:36-60), with
    the rotation offset of the loss_norm_*_offset_ang flags."""
    from .datasets import get_dataset
    from .utils.rotations import R_offset_from_angles
    R_offset = R_offset_from_angles(
        cfg.loss.norm_yaw_offset_ang, cfg.loss.norm_pitch_offset_ang,
        cfg.loss.norm_roll_offset_ang)
    ds_cls = get_dataset(cfg.data.dataset_name)
    if cfg.data.dataset_name == "synthetic":
        return (ds_cls(split=cfg.data.split, R_offset=R_offset),
                ds_cls(split="test", R_offset=R_offset))
    kw = dict(root_dir=cfg.data.root_dir, split_factor=cfg.data.split_factor,
              downsample=cfg.data.downsample,
              load_depth_gt=cfg.data.load_depth_gt,
              load_norm_gt=cfg.data.load_norm_gt,
              load_norm_depth_gt=cfg.data.load_norm_depth_gt,
              load_sem_gt=cfg.data.load_sem_gt,
              load_sem_WF_gt=cfg.data.load_sem_WF_gt, R_offset=R_offset)
    return ds_cls(split=cfg.data.split, **kw), ds_cls(split="test", **kw)


class _Timer:
    """Wall seconds of each part of a run, each ended by a synchronize."""

    def __init__(self, device: torch.device):
        self.device, self.times = device, {}

    def __call__(self, name: str, fn):
        t = time.perf_counter()
        out = fn()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.times[name] = self.times.get(name, 0.0) + time.perf_counter() - t
        return out


def _fit(trainer, cfg: TrainConfig, logger):
    n = cfg.optim.num_epochs * cfg.optim.steps_per_epoch - trainer.step
    log_every = 100 if cfg.no_debug else 10
    profile_dir = os.environ.get("NCNERF_PROFILE_DIR")
    if not profile_dir:
        return trainer.fit(n, log_every=log_every, logger=logger)
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(profile_dir)):
        hist = trainer.fit(n, log_every=log_every, logger=logger)
    print(f"profiler trace written to {profile_dir}")
    return hist


def main(argv=None, device=None, run: Optional[Dict] = None
         ) -> Dict[str, float]:
    """Train and validate as the flags in `argv` say; returns the
    validation metrics (rank 0's; None on the other ranks). `device`
    overrides NCNERF_PLATFORM. A dict `run` receives the trainer, the log
    directory and the wall seconds of each part of the run ("times")."""
    from .parallel.launch import (initialize_multihost, launched,
                                  require_cards, spawn)
    from .training import Trainer
    from .training.checkpoints import (load_weights, restore_checkpoint,
                                       save_checkpoint)
    from .training.loggers import MetricLogger
    from .training.results import save_results_csv

    cfg = TrainConfig.from_args(argv)
    platform = platform_device(device)
    n_ranks = cfg.parallel.mesh_shape[0]
    if n_ranks != 1 and not launched():
        if n_ranks == -1:
            if platform != "cuda":
                raise ValueError("--num_chips -1 (every card) runs on the "
                                 "card; give the number of ranks")
            n_ranks = torch.cuda.device_count()
        if platform == "cuda":   # once, before the ranks load them
            from . import kernels
            require_cards(n_ranks)
            kernels.build_all()
        return spawn(main, n_ranks, (argv, device), device=platform)
    initialize_multihost(device=platform)
    if not cfg.no_debug:
        cfg = cfg.debug_overrides()
    dev = torch.device(platform)
    timer = _Timer(dev)
    train_ds, test_ds = timer("dataset", lambda: build_datasets(cfg))
    trainer = timer("dataset", lambda: Trainer(
        cfg, train_ds.load(), test_ds.load(), device=dev))

    if cfg.weight_path:
        timer("checkpoint_restore", lambda: trainer.load_params(
            load_weights(cfg.weight_path, trainer.params)))
    if cfg.ckpt_path:
        timer("checkpoint_restore",
              lambda: restore_checkpoint(cfg.ckpt_path, trainer))

    log_dir = os.path.join(cfg.log_root_dir, cfg.exp_name or "run")
    rank0 = trainer.axis is None or trainer.axis.rank == 0
    logger = None
    if rank0:
        os.makedirs(log_dir, exist_ok=True)
        logger = MetricLogger(log_dir, use_wandb=cfg.no_debug,
                              run_name=cfg.exp_name)
    if run is not None:
        run.update(trainer=trainer, log_dir=log_dir, times=timer.times)

    if not cfg.eval.val_only:
        if not cfg.ckpt_path:
            timer("marking", trainer.mark_invisible_cells)
        timer("fit", lambda: _fit(trainer, cfg, logger))

    metrics = timer("validate", lambda: trainer.validate(
        save_vis_dir=os.path.join(log_dir, "results")
        if cfg.eval.save_test_vis else None,
        save_preds_dir=os.path.join(log_dir, "preds")
        if cfg.eval.save_test_preds else None,
        logger=logger))
    if rank0:
        print("validation:", {k: round(v, 4) for k, v in metrics.items()})

    if cfg.eval.save_train_preds:
        timer("exports", lambda: trainer.save_train_preds(
            os.path.join(log_dir, "preds")))
    if rank0:
        timer("exports", lambda: save_results_csv(
            os.path.join(log_dir, "results.csv"), metrics, cfg,
            info={"step": trainer.step,
                  "scene": getattr(train_ds, "scene_name",
                                   cfg.data.dataset_name)}))
        logger.close()

    if cfg.save_checkpoint:
        timer("checkpoint_save", lambda: save_checkpoint(
            os.path.join(log_dir, "ckpt"), trainer))
    if rank0:
        print("wall seconds:",
              {k: round(v, 3) for k, v in timer.times.items()})
    return metrics


if __name__ == "__main__":
    main(sys.argv[1:])
