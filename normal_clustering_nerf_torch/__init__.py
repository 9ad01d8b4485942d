"""PyTorch / CUDA (H100) port of the NGP-MT normal-clustering NeRF.

A second package beside the JAX reference `normal_clustering_nerf_tpu`:
it imports `torch`, never `jax`, and nothing of the JAX package. Its hot
ops are hand-written CUDA kernels (`csrc/`, built by `kernels.py`), each
with a plain PyTorch version in the same module that runs for CPU
tensors. Entry points default to `device="cuda"`.
"""
from .config import (  # noqa: F401
    DataConfig, LossConfig, ModelConfig, OptimConfig, RenderConfig,
    TrainConfig,
)
from .device import resolve_device  # noqa: F401
