"""The "rays" axis of a run on several cards (the JAX package's
`parallel/mesh.py`).

The parallelism is the JAX package's (replacing the reference's Lightning
DDP, train_nerf.py:950-952), with `shard_batch_spec` / `replicated_spec`
read as a rule: each rank draws its own rays (a batch of
`batch_size / n` with its own generator), and the parameters, the
optimizer state and the occupancy grid are replicated, bit-identical on
every rank. A step's gradients and metrics are averaged over the axis
(`training.distributed`) before the replicated update; a refresh's grids
are merged by a MAX (`OccupancyGrid.merge_across_chips`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .launch import local_rank


@dataclasses.dataclass(frozen=True)
class RaysAxis:
    """A rank's place on the axis: its rank, the axis's size, the process
    group of its collectives, its backend and the device it runs on."""
    rank: int
    size: int
    group: object
    backend: str
    device: torch.device


def axis_size(mesh_shape: Tuple[int, ...]) -> int:
    """The ranks `mesh_shape` asks for (-1: every rank of the process
    group, 1 without one)."""
    n = mesh_shape[0]
    if n != -1:
        return n
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(mesh_shape: Tuple[int, ...] = (-1,),
              axis_names: Tuple[str, ...] = ("rays",),
              device="cuda") -> Optional[RaysAxis]:
    """The axis over the ranks of the process group, or None for one
    rank. `mesh_shape[0]` is the number of ranks, -1 every rank; more
    than one needs an initialised process group of exactly that size
    (`launch.initialize_multihost`), else it raises. A rank on the card
    runs on card `launch.local_rank()`; with `device` "cpu" on the CPU."""
    if len(mesh_shape) != 1 or len(axis_names) != 1:
        raise ValueError(f"a 1-D mesh: shape {mesh_shape}, names "
                         f"{axis_names}")
    n = axis_size(mesh_shape)
    if n == 1:
        return None
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh_shape {mesh_shape} asks for {n} ranks and this process "
            "is in no process group: start the run with --num_chips "
            f"{n} (which starts the ranks), or under a launcher "
            "(parallel.launch.initialize_multihost)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"mesh_shape {mesh_shape} asks for {n} ranks, the "
                           f"process group has {dist.get_world_size()}")
    device = torch.device(device)
    if device.type == "cuda":
        device = torch.device("cuda", local_rank())
    # the axis spans every rank: the default group, with the backend the
    # launcher chose (`init_device_mesh` would put a gloo run whose ranks
    # share a card on a new NCCL group, which refuses a shared card)
    group = dist.group.WORLD
    return RaysAxis(rank=dist.get_rank(group), size=n, group=group,
                    backend=str(dist.get_backend(group)), device=device)
