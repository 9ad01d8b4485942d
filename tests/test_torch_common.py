"""Shared helpers of the PyTorch-port parity tests (tests/test_torch_*.py).

Each parity test builds its inputs with numpy from a seed, runs the JAX
package's function and the port's plain PyTorch version on them (on the
CPU), and compares with a stated tolerance. Random draws are made with
JAX and handed to the port, since threefry and Philox never agree.
"""
import dataclasses
import math

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


def write_hypersim_scene(root, gen_hw=(192, 256)):
    """Write a traced room into `root` in Hypersim's layout: HDF5 radiance and geometry
    frames, keyframe tables (frame indices out of order), meters per
    asset unit 0.5, cameras close together so that the camera-expanded
    bounds clip the room (the depth-clip path), NaN depth and normal
    pixels, and NYU40 ids 9 / 20 for the wall-floor merge; frames of
    `gen_hw` (H, W). Returns the directory as a string."""
    import h5py
    from normal_clustering_nerf_torch.datasets.synthetic import (
        _lookat_pose, _trace_room)

    def _h5(path, arr):
        with h5py.File(path, "w") as f:
            f.create_dataset("dataset", data=arr)
    GEN_H, GEN_W = gen_hw
    images, detail, cam = root / "images", root / "_detail", "cam_00"
    fin = images / f"scene_{cam}_final_hdf5"
    geo = images / f"scene_{cam}_geometry_hdf5"
    for d in (fin, geo, detail / cam):
        d.mkdir(parents=True)
    with open(detail / "metadata_scene.csv", "w") as f:
        f.write("parameter_name,parameter_value\n"
                "meters_per_asset_unit,0.5\n")
    tw = math.tan(math.pi / 6.0)
    th = tw * GEN_H / GEN_W
    u = np.linspace(-1 + 1 / GEN_W, 1 - 1 / GEN_W, GEN_W)
    v = np.linspace(-1 + 1 / GEN_H, 1 - 1 / GEN_H, GEN_H)[::-1]
    uu, vv = np.meshgrid(u, v)
    dirs = np.stack([tw * uu, th * vv, -np.ones_like(uu)], -1).reshape(-1, 3)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    rng = np.random.default_rng(5)
    n, R_room = 8, 2.0
    trans, rots = [], []
    for i in range(n):
        pos = rng.uniform(-0.2, 0.2, 3)
        ang = 2 * np.pi * i / n
        target = np.array([np.cos(ang), 0.3, np.sin(ang)]) * R_room
        p = _lookat_pose(pos, target, np.array([0.0, -1.0, 0.0]))
        trans.append(pos)
        rots.append(np.stack([p[:, 0], -p[:, 1], -p[:, 2]], axis=1))
    trans = np.stack(trans).astype(np.float32)
    rots = np.stack(rots).astype(np.float32)
    order = np.array([3, 0, 1, 2, 4, 5, 6, 7])   # keyframes out of order
    _h5(detail / cam / "camera_keyframe_positions.hdf5", trans[order])
    _h5(detail / cam / "camera_keyframe_orientations.hdf5", rots[order])
    _h5(detail / cam / "camera_keyframe_frame_indices.hdf5", order)
    for i in range(n):
        rd = (dirs @ rots[i].T).astype(np.float32)
        rgb, depth, nrm, sem = _trace_room(np.broadcast_to(trans[i], rd.shape),
                                           rd, R_room)
        hdr = np.power(np.clip(rgb, 1e-4, 1.0), 2.2).reshape(GEN_H, GEN_W, 3)
        depth = (depth * 0.5).reshape(GEN_H, GEN_W)      # meters
        depth[0, :5] = np.nan
        nrm = nrm.reshape(GEN_H, GEN_W, 3)
        nrm[1, :3] = np.nan
        sem = sem.reshape(GEN_H, GEN_W).astype(np.int16)
        sem[:4, :20] = 9
        sem[-4:, :20] = 20
        sem[10:12] = -1
        frame = f"{i:04d}"
        _h5(fin / f"frame.{frame}.color.hdf5", hdr.astype(np.float32))
        _h5(geo / f"frame.{frame}.render_entity_id.hdf5",
            np.ones((GEN_H, GEN_W), np.int32))
        _h5(geo / f"frame.{frame}.depth_meters.hdf5", depth)
        _h5(geo / f"frame.{frame}.normal_bump_world.hdf5", nrm)
        _h5(geo / f"frame.{frame}.semantic.hdf5", sem)
    return str(root)
