"""The pieces of a training step on several cards (the JAX package's
`training/distributed.py`: `make_sharded_train_step`,
`make_sharded_train_chunk`, `make_sharded_occ_update`), which
`Trainer` wires in when `cfg.parallel.mesh_shape` asks for more than one
rank (`parallel.mesh.make_mesh`).

  * each rank samples `batch_size / n` rays (`local_batch`) with its own
    generator (`shard_seed`), which draws its batch, the march noise and
    background, the k-means init and its refresh's cells and jitter, as
    JAX folds the shard index into each key; the model's init generator
    is the same on every rank, and rank 0's parameters are broadcast
    (`broadcast_`);
  * the gradients and the step's aux values (the loss terms, rm / vr /
    trunc counts, mse) are averaged over the axis before the clip and
    AdamW (`mean_over_axis`: one all-reduce SUM of a flat buffer, then a
    division by n, JAX's `pmean`, trainer.py:362-364), so that the
    replicated update is the same on every rank;
  * after each rank's refresh the grids are merged
    (`OccupancyGrid.merge_across_chips`).

An NCCL all-reduce is recorded into the step's CUDA graph like any other
launch (the eager warm-up steps have run it on the capturing stream
first); a gloo one runs on the host and cannot be captured.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.distributed as dist


def local_batch(batch_size: int, n: int) -> int:
    """Each rank's rays (distributed.py:32-35): a batch that does not
    divide over the ranks is refused."""
    if batch_size % n:
        raise ValueError(f"batch_size {batch_size} must divide over {n} "
                         "ranks")
    return batch_size // n


def shard_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s generator: `seed` on rank 0, the others
    apart by a large odd stride."""
    return (seed + rank * 0x9E3779B97F4A7C15) % (1 << 63)


def mean_over_axis(axis, grads: Dict[str, torch.Tensor],
                   aux: Dict[str, torch.Tensor]
                   ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """The mean over the ranks of every gradient and aux value: one
    all-reduce SUM of the values laid end to end in an f32 buffer (new
    storage: an unused parameter's shared zero gradient is not written),
    divided by n. The SUM's order is the collective's, the same on every
    rank, so the results are the same on every rank."""
    items = list(grads.items()) + list(aux.items())
    flat = torch.cat([t.detach().reshape(-1).to(torch.float32)
                      for _, t in items])
    dist.all_reduce(flat, group=axis.group)
    # a tensor divisor: one rounding, as on the CPU (the card's division
    # by a Python scalar is a product with its reciprocal)
    flat = flat / torch.full((), float(axis.size), device=flat.device)
    out, i = [], 0
    for _, t in items:
        out.append(flat[i:i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    n = len(grads)
    return (dict(zip(grads, out[:n])), dict(zip(aux, out[n:])))


@torch.no_grad()
def broadcast_(axis, tensors: List[torch.Tensor]):
    """Rank 0's values into every rank's tensors, in place."""
    for t in tensors:
        dist.broadcast(t.detach(), src=dist.get_global_rank(axis.group, 0),
                       group=axis.group)


def gather_objects(axis, obj) -> list:
    """Every rank's `obj`, in rank order, on every rank."""
    out = [None] * axis.size
    dist.all_gather_object(out, obj, group=axis.group)
    return out


def barrier(axis):
    if axis.backend == "nccl":
        dist.barrier(group=axis.group, device_ids=[axis.device.index])
    else:
        dist.barrier(group=axis.group)


def on_rank0(axis, fn, *args, **kw):
    """`fn(*args, **kw)` on rank 0, the other ranks waiting at a barrier;
    rank 0's result (None on the others)."""
    out = fn(*args, **kw) if axis.rank == 0 else None
    barrier(axis)
    return out
