"""Carry a JAX-package training state across to the port.

The JAX `TrainState` keeps parameters as a nested pytree
({"model": {"hash_table": {"planes", "grid3d"}, "sigma_net": {"w0", ...},
...}}) and occupancy as an `OccupancyState` of arrays. The port names its
parameters by the same path ("hash_table.planes", "sigma_net.w0", ...)
and keeps the triplane rows in the same feature-major v2 layout, so every
array converts 1:1. The brick and tcnn layouts keep the table as one
leaf, `hash_table` ((L, n_bricks, 128) or (total_rows, F), the JAX
layouts), which `_flatten` maps to the port's single `hash_table`
parameter (tests/test_torch_slice_layouts.py carries such a state across).
The Manhattan-SDF angle `theta_WF`, a top-level leaf beside "model",
becomes the port's 0-dim parameter `theta_WF`.
Inputs are numpy arrays (e.g. `np.asarray` of each leaf), so nothing of
JAX is imported here.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch

from .models.occupancy import OccupancyState


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, name))
        else:
            out[name] = np.array(v)
    return out


# the JAX params tree's leaves beside "model" that the port has
TOP_LEVEL = ("theta_WF",)


def jax_path(name: str) -> str:
    """The port's parameter name -> the "/"-joined path of its JAX leaf
    in the TrainState params (the key of a JAX `save_weights` file):
    "hash_table.planes" -> "model/hash_table/planes", "theta_WF" ->
    "theta_WF". The reverse of `_flatten` under `convert_params`."""
    return name if name in TOP_LEVEL else "model/" + name.replace(".", "/")


def convert_params(params_np: Mapping, device) -> Dict[str, torch.Tensor]:
    """JAX params pytree (numpy leaves, with or without the top-level
    "model" key) -> {port parameter name: f32 tensor}. Beside "model", the
    top-level leaves (`theta_WF`) keep their names."""
    if "model" in params_np:
        flat = _flatten(params_np["model"])
        flat.update(_flatten({k: v for k, v in params_np.items()
                              if k != "model"}))
    else:
        flat = _flatten(params_np)
    return {n: torch.as_tensor(a, dtype=torch.float32, device=device)
            for n, a in flat.items()}


def convert_occupancy(occ_np, device) -> OccupancyState:
    """JAX OccupancyState (NamedTuple or mapping of numpy arrays) -> the
    port's OccupancyState: every field, with the same dtypes (the coarse
    mask and the sv march's tables included)."""
    get = (occ_np.get if isinstance(occ_np, Mapping)
           else lambda k: getattr(occ_np, k))
    return OccupancyState(*(torch.as_tensor(np.array(get(f)), device=device)
                            for f in OccupancyState._fields))


def convert_jax_state(params_np: Mapping, occ_np, optimizer,
                      device) -> Tuple[Dict[str, torch.Tensor],
                                       OccupancyState, Dict]:
    """(parameters, occupancy buffers, freshly built optimizer state) of
    the port from a JAX state. `optimizer` is the port's AdamW over the
    target parameters (the model's and, with manhattan_nerf_w, theta_WF);
    the names of the JAX state's leaves, top-level ones included, must be
    exactly those. Its state is rebuilt from zero moments (count 0), as
    the JAX optimizer state is at step 0."""
    params = convert_params(params_np, device)
    missing = set(optimizer.params) ^ set(params)
    if missing:
        raise ValueError(f"parameter names differ: {sorted(missing)}")
    for n, p in optimizer.params.items():
        if tuple(p.shape) != tuple(params[n].shape):
            raise ValueError(f"{n}: shape {tuple(params[n].shape)}, "
                             f"expected {tuple(p.shape)}")
    return params, convert_occupancy(occ_np, device), optimizer.init_state()
