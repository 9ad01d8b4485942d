"""Device selection: the port runs on the GPU unless told otherwise."""
from __future__ import annotations

import numpy as np
import torch


def as_index(a, device: torch.device) -> torch.Tensor:
    """Indices handed in as a tensor, a numpy or JAX array or a sequence
    (a test passes the JAX package's draws) -> int64 tensor on `device`."""
    if not isinstance(a, torch.Tensor):
        a = torch.as_tensor(np.array(a))
    return a.to(device=device, dtype=torch.int64)


def resolve_device(device=None) -> torch.device:
    """`None` means "cuda". A CUDA device without a visible card raises:
    the plain PyTorch versions run only when the caller asks for the CPU
    (`device="cpu"`)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the port's "
            "plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
