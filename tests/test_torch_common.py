"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Each parity test builds its inputs with numpy from a seed, runs the JAX
package's function and the port's plain PyTorch version on them (on the
CPU), and compares with a stated tolerance. Random draws are made with
JAX and handed to the port, since threefry and Philox never agree.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

import normal_clustering_nerf_torch.config as tcfg
import normal_clustering_nerf_tpu.config as jcfg

# tier-1 runs six xdist workers on this machine's cores
torch.set_num_threads(1)

CPU = torch.device("cpu")


def T(a, dtype=None) -> torch.Tensor:
    """numpy / JAX array -> CPU tensor (a copy)."""
    t = torch.as_tensor(np.array(a))
    return t if dtype is None else t.to(dtype)


def N(x) -> np.ndarray:
    """tensor / JAX array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32 if x.is_floating_point()
                             else x.dtype).cpu().numpy()
    return np.asarray(x)


def J(a, dtype=None):
    return jnp.asarray(np.asarray(a), dtype=dtype)


def slice_configs(**model_kw):
    """The bench.py training configuration at CPU-test size, for both
    packages: all heads on, triplane field, 16 samples per ray with the
    full stratified tail, avoid_near annealing and the production loss
    weights (bench.py:44-109); plane_res 32, grid3d_res 16, grid 32,
    batch 96."""
    model = dict(scale=0.5, grid_size=32, max_samples=1024,
                 pred_norm_nn=True, pred_norm_depth=True, pred_sem=True,
                 n_sem_cls=3, hash_layout="triplane", plane_res=32,
                 grid3d_res=16)
    model.update(model_kw)
    batch, spr = 96, 16
    render = dict(march_block=1024, sample_budget=batch * spr,
                  anneal_strategy="avoid_near", anneal_steps=600)
    loss = dict(opacity_w=1e-3, distortion_w=1e-3, norm_D_C_ort_dot_w=2e-3,
                norm_D_C_centr_dot_w=2e-3, norm_D_C_centr_L1_w=2e-3,
                norm_can_tres=0.01, norm_can_start=500, norm_can_grow=2500,
                sem_w=0.04)
    data = dict(batch_size=batch, ray_sampling_strategy="all_images_triang",
                triang_max_expand=3)
    optim = dict(num_epochs=4, steps_per_epoch=1000)

    def build(m):
        return m.TrainConfig(
            model=m.ModelConfig(**model), render=m.RenderConfig(**render),
            loss=m.LossConfig(**loss), data=m.DataConfig(**data),
            optim=m.OptimConfig(**optim))
    return build(jcfg), build(tcfg)


def replace_model(cfg, **kw):
    return cfg.replace(model=dataclasses.replace(cfg.model, **kw))


def random_rays(rng, n, scale=0.5):
    """Origins inside the scene cube, unit directions."""
    o = rng.uniform(-0.9 * scale, 0.9 * scale, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d.astype(np.float32)


def key_uniform(key, shape):
    return np.asarray(jax.random.uniform(key, shape))
