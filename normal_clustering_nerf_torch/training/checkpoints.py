"""Checkpoints and weights files of the port (the JAX package's
`training/checkpoints.py`; reference: train_nerf.py:889-899, utils.py:4-39).

A full checkpoint is a directory, as the JAX one is (`<log_dir>/ckpt`): a
`torch.save` file of everything a training step reads or writes (the
parameters, theta_WF included; AdamW's count and moments; every field of
the occupancy state; the step; the trainer's generator state) and the
JAX version's `layout_version.json` tag. A restore writes into the
trainer's own tensors (`Trainer.load_state`) and generator, which its
CUDA graphs hold, and refuses a file whose tensors' names, shapes or
dtypes, or whose model configuration, differ from the trainer's. The
port writes only the current triplane layout, and refuses a full
checkpoint tagged with another (the JAX restore converts a v1
checkpoint's parameters but not its moments, `checkpoints.py:83`).

On several ranks every rank calls `save_checkpoint`: the file also holds
every rank's generator state, gathered to rank 0, and the world size;
rank 0 writes it and the others wait at a barrier. A restore sets each
rank's own generator, so that a resumed run on N cards continues as the
uninterrupted one, and refuses a file of another world size.

A weights file keeps the JAX format, so each package reads the other's:
an npz of the parameters under their "/"-joined JAX paths
(`convert.jax_path`) with `__triplane_layout__`; a v1 file's triplane
tables are converted on load.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict

import numpy as np
import torch

from ..convert import jax_path
from ..models.occupancy import OccupancyState
from ..models.triplane import (
    TRIPLANE_LAYOUT_VERSION, convert_triplane_params_v1_to_v2)
from .distributed import barrier, gather_objects

_LAYOUT_FILE = "layout_version.json"
_STATE_FILE = "state.pt"


def _write_layout_tag(path: str):
    with open(os.path.join(path, _LAYOUT_FILE), "w") as f:
        json.dump({"triplane_layout": TRIPLANE_LAYOUT_VERSION}, f)


def _read_layout_tag(path: str) -> int:
    """Layout version recorded in a checkpoint dir; an absent tag is v1
    (checkpoints from before the tag were all slot-major)."""
    p = os.path.join(path, _LAYOUT_FILE)
    if not os.path.exists(p):
        return 1
    with open(p) as f:
        return int(json.load(f).get("triplane_layout", 1))


def _cpu(d: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {n: t.detach().cpu().clone() for n, t in d.items()}


def trainer_state(trainer, tensors=_cpu) -> Dict:
    """What a training step of `trainer` reads or writes, and its model
    configuration: each group of tensors through `tensors` (host copies;
    `dict` for the trainer's own tensors)."""
    opt = trainer.opt.state
    return {"params": tensors(trainer.params),
            "opt": {"count": int(opt["count"]), "mu": tensors(opt["mu"]),
                    "nu": tensors(opt["nu"])},
            "occ": tensors(trainer.occ._asdict()),
            "step": int(trainer.step),
            "generator": trainer.generator.get_state(),
            "model": dataclasses.asdict(trainer.cfg.model)}


def _layout(state: Dict) -> Dict[str, tuple]:
    """{group/name: (shape, dtype)} of every tensor in `state`."""
    groups = {"params": state["params"], "mu": state["opt"]["mu"],
              "nu": state["opt"]["nu"], "occ": state["occ"],
              "generator": {"state": state["generator"]}}
    return {f"{g}/{n}": (tuple(t.shape), t.dtype)
            for g, d in groups.items() for n, t in d.items()}


def _world_size(trainer) -> int:
    return 1 if trainer.axis is None else trainer.axis.size


def save_checkpoint(path: str, trainer):
    """Write `trainer`'s full training state to the directory `path` (on
    several ranks: every rank calls it, rank 0 writes)."""
    path = os.path.abspath(path)
    state = trainer_state(trainer)
    axis = trainer.axis
    if axis is not None:
        state["rank_generators"] = gather_objects(axis, state["generator"])
        state["world_size"] = axis.size
    if axis is None or axis.rank == 0:
        os.makedirs(path, exist_ok=True)
        torch.save(state, os.path.join(path, _STATE_FILE))
        _write_layout_tag(path)
    if axis is not None:
        barrier(axis)


def restore_checkpoint(path: str, trainer):
    """Restore a `save_checkpoint` directory into `trainer`, in place."""
    path = os.path.abspath(path)
    version = _read_layout_tag(path)
    if version != TRIPLANE_LAYOUT_VERSION:
        raise ValueError(
            f"{path}: checkpoint triplane layout v{version}, this build "
            f"reads v{TRIPLANE_LAYOUT_VERSION} only; restore its weights "
            f"(an npz of save_weights, which converts v1) instead")
    ck = torch.load(os.path.join(path, _STATE_FILE), map_location="cpu",
                    weights_only=True)
    world = _world_size(trainer)
    if ck.get("world_size", 1) != world:
        raise ValueError(f"{path}: a checkpoint of {ck.get('world_size', 1)} "
                         f"rank(s), this run has {world}")
    have, want = _layout(ck), _layout(trainer_state(trainer, dict))
    diff = sorted(k for k in have.keys() | want.keys()
                  if have.get(k) != want.get(k))
    if diff:
        raise ValueError(
            f"{path}: the checkpoint does not fit this trainer: "
            + "; ".join(f"{k} {have.get(k)} (trainer: {want.get(k)})"
                        for k in diff[:8]))
    model = dataclasses.asdict(trainer.cfg.model)
    diff = sorted(k for k in model if ck["model"].get(k) != model[k])
    if diff:
        raise ValueError(
            f"{path}: the checkpoint's model configuration differs: "
            + "; ".join(f"{k} {ck['model'].get(k)!r} (trainer: "
                        f"{model[k]!r})" for k in diff))
    trainer.load_state(ck["params"], OccupancyState(**ck["occ"]),
                       ck["opt"], ck["step"])
    trainer.generator.set_state(
        ck["generator"] if world == 1
        else ck["rank_generators"][trainer.axis.rank])
    return trainer


def save_weights(path: str, params: Dict[str, torch.Tensor]):
    """Weights-only file: an npz of the parameters under their JAX paths
    with the layout tag (JAX `save_weights`)."""
    flat = {"__triplane_layout__": np.int32(TRIPLANE_LAYOUT_VERSION)}
    for n, p in params.items():
        flat[jax_path(n)] = p.detach().cpu().numpy()
    np.savez(path, **flat)


def load_weights(path: str, params: Dict[str, torch.Tensor]
                 ) -> Dict[str, torch.Tensor]:
    """The parameters of a `save_weights` file of either package, for the
    names in `params`: those the file holds from the file (a v1 file's
    triplane tables converted), the others as they are in `params`
    (JAX `load_weights`). A shape that differs raises."""
    data = np.load(path)
    version = (int(data["__triplane_layout__"])
               if "__triplane_layout__" in data.files else 1)
    if version > TRIPLANE_LAYOUT_VERSION:
        raise ValueError(
            f"weights triplane layout v{version} is newer than this "
            f"build's v{TRIPLANE_LAYOUT_VERSION}: refusing to guess")
    found = {n: data[jax_path(n)] for n in params
             if jax_path(n) in data.files}
    tp = ("hash_table.planes", "hash_table.grid3d")
    if version != TRIPLANE_LAYOUT_VERSION and all(n in found for n in tp):
        conv = convert_triplane_params_v1_to_v2(
            {n.split(".")[1]: found[n] for n in tp})
        found.update({n: conv[n.split(".")[1]] for n in tp})
    out = {}
    for n, p in params.items():
        if n not in found:
            out[n] = p.detach().clone()
            continue
        if tuple(found[n].shape) != tuple(p.shape):
            raise ValueError(f"{path}: {jax_path(n)} has shape "
                             f"{tuple(found[n].shape)}, the parameter "
                             f"{tuple(p.shape)}")
        out[n] = torch.as_tensor(found[n], dtype=p.dtype, device=p.device)
    return out


def slim_state(trainer) -> Dict:
    """Parameters and step only (reference: utils.py:29-39)."""
    return {"params": _cpu(trainer.params), "step": int(trainer.step)}
