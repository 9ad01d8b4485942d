"""Training loop and validation of the port — the JAX package's
`training/trainer.py` for one device, as plain eager steps.

One step: sample a batch (pixels, triangles or patches, half of them
from random unseen poses under `random_tr_poses`) -> assemble rays ->
render (the bootstrap march before `render.bootstrap_steps`, after it
the supervoxel-run march or the bitfield march, or the flat layout's
march from step 0, as `render.march_layout` and `render.march_coarse`
choose; the field, compositing) -> multi-task loss (the Manhattan-SDF
term with its learned angle `theta_WF`, a parameter beside the model's)
-> gradients -> optax-equivalent clipped AdamW (with `optimize_ext` the
per-image pose deltas dR / dT at their own lr, the positions' gradient
reaching them through the encode's H12-H14). `fit` refreshes the
occupancy grid every `update_interval` steps (every cell before
`warmup_steps`) and runs the
steps between two refreshes as one chunk (`train_chunk`, the JAX
trainer's `_make_chunk_fn`). `validate` renders the held-out views
(`render_images`), computes the metric suite and recovers the Manhattan
rotation, and writes the prediction panels, the prediction archives and
the logger's images and scalars on request; `save_train_preds` renders
the training views into archives. With `host_sampler` the batches' indices
come from the native prefetcher on the host (`HostFeed`) in place of the
device sampler. The JAX version's render prewarming is not ported.

On several cards (`cfg.parallel.mesh_shape` above 1, trainer.py:120-175
of the JAX package; one process a card, `parallel.launch`) each rank
draws `batch_size / n` rays with its own generator, the gradients and
the step's metrics are averaged over the ranks between the backward and
AdamW, each refresh's grids are merged, and rank 0's parameters,
moments and occupancy are broadcast after init and after every load
(`training.distributed`): the replicas stay bit-identical. `validate`,
`render_images` and `save_train_preds` run on rank 0 (the others return
None at a barrier). With NCCL the all-reduce is inside the step's CUDA
graph; gloo runs eager steps.

On the card a chunk is a CUDA graph of one step, replayed once a step.
Everything a step reads or writes stays in fixed storages: parameters,
moments, occupancy (a refresh copies into it), the step counters on the
device and the step table they index (`state.schedule_table`: the lr,
the bias corrections, the loss weights, the annealing), and the rows
that collect each step's metrics, which `fit` copies to the host once.

Random draws come from one `torch.Generator` seeded with `cfg.seed`
(registered with each graph, so that a replay draws what an eager step
draws); each step's draws can be handed in instead
(`train_step_core(draws=...)`).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import math
import os
import time
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import kernels
from ..config import TrainConfig
from ..datasets.base import SceneData, generate_random_poses
from ..datasets.normals import extract_normals_from_depth_batch
from ..datasets.ray_utils import axisangle_to_R, get_rays
from ..datasets.sampler import RaySampler
from ..device import as_index, resolve_device
from ..losses import compute_losses
from ..metrics import NeRFMTMetricsPerIm
from ..models.ngp_mt import NGPMT
from ..models.occupancy import OccupancyGrid, OccupancyState
from ..models.rendering import render_test, render_train, train_march_kind
from ..parallel.mesh import axis_size, make_mesh
from ..utils.rotations import R_offset_from_angles
from .distributed import (broadcast_, local_batch, mean_over_axis, on_rank0,
                          shard_seed)
from .rotation_recovery import rotation_recovery_errors
from .state import OPT_COLUMNS, SCHEDULE_COLUMNS, AdamW, schedule_table
from .visualize import pack_vis_panel, save_preds_tar_gz, save_vis_png

_log = logging.getLogger(__name__)
# eager steps of a step kind, on a side stream, before its CUDA graph is
# captured (as PyTorch's whole-network capture warms up: lazy
# initialisation, the kernels' libraries, cuBLAS's handles)
GRAPH_WARMUP = 3
RANDOM_POSES = 10000   # random unseen poses of random_tr_poses (trainer.py:82)
REFRESH = "refresh"    # the kind of the sampled refresh's CUDA graph


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        return _row_sums(g, idx, ctx.n_rows), None


def _row_sums(g, idx, n_rows: int):
    """(n_rows, D) sums of the rows of g (M, D) by their index in idx: on
    the CPU added in row order (index_add_, as JAX's segment sum does); on
    the card each row's masked (D, M) products reduced along M, whose
    order is fixed, where index_add_'s float atomics add in an order that
    changes from run to run."""
    if not g.is_cuda:
        return torch.zeros((n_rows, g.shape[1]), dtype=g.dtype,
                           device=g.device).index_add_(0, idx, g)
    member = torch.arange(n_rows, device=g.device)[:, None] == idx[None, :]
    return (member[:, None, :] * g.T[None, :, :]).sum(-1)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (2-D) whose gradient sums each row's entries in a fixed
    order (`_row_sums`): index_add_'s atomics on the card would part graph
    replays from eager steps, which AdamW amplifies."""
    return _GatherRows.apply(table, idx)


def loss_labels(cfg: TrainConfig) -> tuple:
    """The scene labels the configured loss terms and the 'depth'
    annealing read (trainer.py:322-326 gathers every label the scene
    has; only these are moved to the card and gathered a step)."""
    lc, rc = cfg.loss, cfg.render
    gt_normals = lc.norm_depth_L1_w > 0 or lc.norm_depth_dot_w > 0
    on = {"depth": lc.depth_w > 0 or (rc.anneal_strategy == "depth"
                                      and rc.anneal_steps > 0),
          "normals": gt_normals and not lc.norm_GT_depth,
          "normals_depth": gt_normals and lc.norm_GT_depth,
          "semantics": lc.sem_w > 0 and lc.manhattan_nerf_w == 0,
          "semantics_WF": lc.manhattan_nerf_w > 0}
    return tuple(k for k, v in on.items() if v)


class HostFeed:
    """The native host sampler's batches into a step, on the card also
    into a captured one (trainer.py:269-285 of the JAX package hands a
    chunk's `(n_steps, B)` index block to one `lax.scan`). `load(n)` takes
    the next n batches from the prefetcher, writes their indices into a
    pinned host block (two of them in turn: a block is rewritten only
    after its last copy has finished) and copies them to a fixed device
    block with one non-blocking copy, and sets the device row counter to
    0; a step's `read()` takes the block's row at the counter and
    advances it, so a replayed step reads each step's batch with nothing
    on the host between replays. `prefetch(n)` pops batches ahead into a
    host queue while the card runs a chunk."""

    def __init__(self, sampler, n_rows: int, device: torch.device):
        self.sampler = sampler
        shape = (n_rows, 2, sampler.batch_size)
        self.block = torch.zeros(shape, dtype=torch.int32, device=device)
        self.row = torch.zeros((), dtype=torch.int64, device=device)
        self.queue = collections.deque()
        on_card = device.type == "cuda"
        self.pinned = ([torch.empty(shape, dtype=torch.int32,
                                    pin_memory=True) for _ in range(2)]
                       if on_card else [self.block])
        self.copied = [torch.cuda.Event() if on_card else None
                       for _ in self.pinned]
        self.turn = 0

    def prefetch(self, n: int):
        while len(self.queue) < n:
            b = self.sampler.next_batch()
            self.queue.append((b["img_idxs"], b["pix_idxs"]))

    def load(self, n: int):
        if n > self.block.shape[0]:
            raise ValueError(f"{n} host batches, the block holds "
                             f"{self.block.shape[0]}")
        self.prefetch(n)
        i, self.turn = self.turn, (self.turn + 1) % len(self.pinned)
        host, ev = self.pinned[i], self.copied[i]
        if ev is not None:
            ev.synchronize()
        rows = host.numpy()
        for k in range(n):
            rows[k, 0], rows[k, 1] = self.queue.popleft()
        if ev is not None:
            self.block[:n].copy_(host[:n], non_blocking=True)
            ev.record()
        self.row.zero_()

    def read(self) -> Dict[str, torch.Tensor]:
        row = self.block.index_select(0, self.row.view(1))[0].long()
        self.row.add_(1)
        return {"img_idxs": row[0], "pix_idxs": row[1]}


def validation_gt(scene: SceneData, i: int) -> Dict[str, np.ndarray]:
    """View i's ground truth as `validate` scores and draws it: rgb and
    the labels depth, normals, semantics and semantics_WF, as images
    (trainer.py:573-580; other labels, normals_depth among them, are
    left out)."""
    W, H = scene.img_wh
    gt = {"rgb": scene.rays[i, :, :3].reshape(H, W, 3)}
    for k in ("depth", "normals", "semantics", "semantics_WF"):
        if k in scene.labels:
            v = scene.labels[k][i]
            gt[k] = (v.reshape(H, W, -1) if v.ndim == 2
                     and v.shape[-1] == 3 else v.reshape(H, W))
    return gt


def rank0_only(fn):
    """A method that runs on rank 0 alone: the other ranks wait for it at
    a barrier and return None (its calls inside it do not wait again)."""
    @functools.wraps(fn)
    def wrapped(self, *args, **kw):
        if self.axis is None or self._in_rank0:
            return fn(self, *args, **kw)

        def run():
            self._in_rank0 = True
            try:
                return fn(self, *args, **kw)
            finally:
                self._in_rank0 = False
        return on_rank0(self.axis, run)
    return wrapped


class Trainer:
    def __init__(self, cfg: TrainConfig, scene_train: SceneData,
                 scene_test: Optional[SceneData] = None, device=None):
        dev = resolve_device(device)
        n_ranks = axis_size(cfg.parallel.mesh_shape)
        if n_ranks > 1:
            if cfg.data.host_sampler:
                raise ValueError("host_sampler is single-device only")
            local_batch(cfg.data.batch_size, n_ranks)
        self.axis = make_mesh(cfg.parallel.mesh_shape,
                              cfg.parallel.mesh_axis_names, dev)
        self._in_rank0 = False
        self.device = dev = dev if self.axis is None else self.axis.device
        if scene_train.n_classes:
            cfg = cfg.replace(model=dataclasses.replace(
                cfg.model, n_sem_cls=scene_train.n_classes))
        if cfg.render.bootstrap_steps % cfg.optim.update_interval != 0:
            raise ValueError("render.bootstrap_steps must be a multiple of "
                             "optim.update_interval")
        if cfg.data.host_sampler and cfg.data.random_tr_poses:
            raise ValueError("host_sampler does not support random_tr_poses")
        if cfg.data.keep_N_tr != -1:
            scene_train = scene_train.keep_first_n(cfg.data.keep_N_tr)
        self.cfg = cfg
        self.scene_train = scene_train
        self.scene_test = scene_test
        rank = 0 if self.axis is None else self.axis.rank
        self.generator = torch.Generator(device=dev).manual_seed(
            shard_seed(cfg.seed, rank))
        init_gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
        o = cfg.optim
        # position gradients through the encode (H12-H14) when the
        # extrinsics are optimised or dR_glob is (trainer.py:71-72)
        self.model = NGPMT(cfg.model, dev, generator=init_gen,
                           need_pos_grad=o.optimize_ext
                           or o.lr_dR_norm_glob > 0)
        self.occ_grid = OccupancyGrid(cfg.model, dev)
        # random unseen poses (trainer.py:79-90), held once on the device:
        # a step takes its rows by a device index
        self.random_poses = None
        if cfg.data.random_tr_poses:
            rnd, _ = generate_random_poses(
                scene_train.poses, scene_train.xyz_cam_min,
                scene_train.xyz_cam_max, RANDOM_POSES, seed=cfg.seed)
            self.random_poses = torch.as_tensor(rnd, device=dev)
        self.sampler = RaySampler(
            cfg.data.ray_sampling_strategy,
            local_batch(cfg.data.batch_size, n_ranks),
            scene_train.img_wh, scene_train.n_images,
            max_expand=cfg.data.triang_max_expand,
            patch_size=cfg.data.patch_size,
            n_random_poses=RANDOM_POSES if cfg.data.random_tr_poses else 0,
            device=dev)
        # the native host sampler (trainer.py:98-114): the step takes its
        # indices from it in place of the device sampler's draws
        self.native_sampler = self.host_feed = None
        if cfg.data.host_sampler:
            from ..datasets.native_sampler import NativeRaySampler
            labels = scene_train.labels
            self.native_sampler = NativeRaySampler(
                cfg.data.ray_sampling_strategy, cfg.data.batch_size,
                scene_train.img_wh, np.asarray(scene_train.rays)[..., :3],
                depth=labels.get("depth"), normals=labels.get("normals"),
                semantics=labels.get("semantics"),
                max_expand=cfg.data.triang_max_expand,
                patch_size=cfg.data.patch_size,
                n_threads=cfg.data.host_sampler_threads, seed=cfg.seed)
            self.host_feed = HostFeed(self.native_sampler,
                                      cfg.optim.update_interval, dev)
        self.scene = {
            "poses": torch.as_tensor(scene_train.poses, dtype=torch.float32,
                                     device=dev),
            "directions": torch.as_tensor(scene_train.directions,
                                          dtype=torch.float32, device=dev),
            "rays": torch.as_tensor(scene_train.rays, dtype=torch.float32,
                                    device=dev),
        }
        self.labels = loss_labels(cfg)
        missing = [k for k in self.labels if k not in scene_train.labels]
        if missing:
            raise ValueError(f"the configured loss terms read the labels "
                             f"{missing}, which the scene lacks")
        for k in self.labels:
            self.scene[f"label_{k}"] = torch.as_tensor(
                scene_train.labels[k], device=dev)
        self.params = dict(self.model.named_parameters())
        # the JAX state's leaves beside the model (state.py:89-95): the
        # per-image extrinsic deltas (axis-angle dR, translation dT); the
        # global normal-frame rotation dR_glob, which the JAX step creates
        # and optimises but never reads (its gradient is 0, and it stays
        # 0); the Manhattan-SDF wall angle
        n_img = scene_train.n_images
        if o.optimize_ext:
            for k in ("dR", "dT"):
                self.params[k] = torch.nn.Parameter(
                    torch.zeros((n_img, 3), device=dev))
        if o.lr_dR_norm_glob > 0:
            self.params["dR_glob"] = torch.nn.Parameter(
                torch.zeros(3, device=dev))
        if cfg.loss.manhattan_nerf_w > 0:
            # the Manhattan-SDF wall angle (state.py:94-95 of the JAX
            # package), optimised with the model by plain Adam
            self.params["theta_WF"] = torch.nn.Parameter(
                torch.zeros((), device=dev))
        self.opt = AdamW(self.params, cfg.optim)
        self._occ: OccupancyState = self.occ_grid.init_state()
        self._step = 0
        self._step_t = torch.zeros((), dtype=torch.int64, device=dev)
        self._table = self._table_cfg = None   # see _ensure_rows
        self._hist = self._hist_keys = None    # each step's metrics
        self._graphs: Dict[str, kernels.CountedGraph] = {}
        # a graph's own outputs: metrics, last_batch, last_grads
        self._graph_out: Dict[str, tuple] = {}
        self._warm: Dict[str, int] = {}
        self._zero_grads: Dict[str, torch.Tensor] = {}
        self._pool = self._side = None
        self._eager_logged = False
        self.captures: List[Dict] = []   # kind, step, ms of each capture
        self.last_grads: Dict[str, torch.Tensor] = {}
        self.last_batch: Optional[Dict[str, torch.Tensor]] = None
        self.R_offset = self._build_R_offset()
        self._sync_replicas()

    @property
    def step(self) -> int:
        return self._step

    @step.setter
    def step(self, value: int):
        self._step = int(value)
        self._step_t.fill_(self._step)

    @property
    def occ(self) -> OccupancyState:
        return self._occ

    @occ.setter
    def occ(self, value: OccupancyState):
        """Assigning a state copies it into the trainer's own tensors."""
        self._occ.copy_(value)

    def _build_R_offset(self) -> np.ndarray:
        """Scene rotation offset from the ZYX euler angles of the loss
        config (reference: train_nerf.py:109-122)."""
        lc = self.cfg.loss
        R = R_offset_from_angles(lc.norm_yaw_offset_ang,
                                 lc.norm_pitch_offset_ang,
                                 lc.norm_roll_offset_ang)
        return np.eye(3, dtype=np.float32) if R is None else R

    def load_state(self, params: Dict[str, torch.Tensor],
                   occ: OccupancyState, opt_state: Optional[Dict] = None,
                   step: int = 0):
        """Take over parameters, occupancy and optimizer state (e.g. from
        `convert.convert_jax_state` or a checkpoint), into the trainer's
        own tensors."""
        self.load_params(params)
        self.occ = occ
        self.opt.load_state(opt_state or self.opt.init_state())
        self.step = step
        self._sync_replicas(params=False)

    @torch.no_grad()
    def load_params(self, params: Dict[str, torch.Tensor]):
        """Copy `params` (every parameter's name) into the parameters."""
        for n, p in self.params.items():
            p.copy_(params[n])
        self._sync_replicas(moments=False, occ=False)

    def _sync_replicas(self, params=True, moments=True, occ=True):
        """On several ranks, rank 0's parameters, moments and occupancy
        into every rank's (the step and the count are host state that
        every rank shares)."""
        if self.axis is None:
            return
        ts = list(self.params.values()) if params else []
        if moments:
            ts += [t for k in ("mu", "nu")
                   for t in self.opt.state[k].values()]
        if occ:
            ts += list(self._occ)
        broadcast_(self.axis, ts)

    # ------------------------------------------------------- occupancy ops
    def density_threshold(self) -> float:
        m = self.cfg.model
        return 0.01 * m.max_samples / math.sqrt(3.0) * m.density_tresh_decay

    def occ_update(self, warmup: bool, *, jitter=None, cell_draws=None):
        """Occupancy refresh (train_nerf.py:314-320; the JAX trainer's
        `_occ_update` is a jit of its own); the new state is copied into
        the trainer's tensors. On one card the sampled form with its own
        draws runs eagerly once, is then captured as a CUDA graph of its
        own (kind REFRESH, in the steps' pool, the generator registered)
        and replayed at every later boundary; the warm-up form (every
        cell) and given draws run eagerly. On several ranks each refreshes
        eagerly with its own draws and the grids are merged
        (`make_sharded_occ_update`)."""
        if (not warmup and jitter is None and cell_draws is None
                and self.device.type == "cuda" and self.axis is None):
            graph = self._graphs.get(REFRESH)
            if graph is None and self._warm.get(REFRESH, 0) >= 1:
                graph = self._capture(REFRESH, lambda: self._refresh(False))
            if graph is not None:
                graph.replay()
                return
            self._warm[REFRESH] = self._warm.get(REFRESH, 0) + 1
        self._refresh(warmup, jitter, cell_draws)

    def _refresh(self, warmup: bool, jitter=None, cell_draws=None):
        """One refresh on the device, into the trainer's occupancy tensors:
        what the refresh's CUDA graph holds."""
        new = self.occ_grid.update(
            self.occ, self.model.density, self.density_threshold(), warmup,
            generator=self.generator, jitter=jitter, cell_draws=cell_draws)
        if self.axis is not None:
            new = OccupancyGrid.merge_across_chips(new, self.axis.group)
        self.occ = new

    def mark_invisible_cells(self):
        """One-time camera-coverage marking (train_nerf.py:306-312), through
        the scene's projection matrices where it has them (Hypersim), else
        its pinhole K (trainer.py:220-240)."""
        s = self.scene_train
        self.occ = self.occ_grid.mark_invisible_cells(
            self.occ, s.poses, s.img_wh, self.cfg.model.near_dist,
            K=s.K if s.proj is None else None, proj=s.proj)
        self._sync_replicas(params=False, moments=False)

    # ------------------------------------------------------------ train step
    def _ensure_rows(self, end: int):
        """Make the step table and the metric rows cover the steps and
        optimizer counts of this config up to `end - step` steps from now.
        A new table drops the captured graphs, which read the old one and
        this config's host-side branches."""
        need = max(end, self.opt.state["count"] + end - self.step)
        same = self._table_cfg is self.cfg
        have = 0 if self._table is None else self._table.shape[0]
        if same and need <= have:
            return
        o = self.cfg.optim
        rows = max(need, o.num_epochs * o.steps_per_epoch,
                   2 * have if same else 0)
        self._drop_graphs()
        self._table = schedule_table(self.opt, self.cfg, rows, self.device)
        self._table_cfg = self.cfg
        if self._hist is not None:
            old, self._hist = self._hist, torch.zeros(
                (rows, self._hist.shape[1]), device=self.device)
            self._hist[:min(have, rows)] = old[:rows]

    def _drop_graphs(self):
        if self._graphs:
            torch.cuda.synchronize(self.device)
            _log.info(f"dropping the CUDA graphs of {sorted(self._graphs)} "
                      f"at step {self.step}")
        self._graphs.clear()
        self._graph_out.clear()
        self._warm.clear()

    def _record(self, metrics: Dict[str, torch.Tensor]):
        """Write the step's metrics into its row (on the device)."""
        keys = tuple(metrics)
        if self._hist is None or keys != self._hist_keys:
            self._hist = torch.zeros((self._table.shape[0], len(keys)),
                                     device=self.device)
            self._hist_keys = keys
        row = torch.stack([v.float() for v in metrics.values()])
        self._hist.index_copy_(0, self._step_t.view(1), row[None])

    def _step_body(self, bootstrap: bool,
                   draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One optimisation step on the device, host state untouched but
        for `last_grads` / `last_batch`: what a CUDA graph of a step
        holds. The step's scalars are the rows of the step table at the
        optimizer's and the trainer's device counters, which it
        advances."""
        cfg, scene, g = self.cfg, self.scene, self.generator
        draws = dict(draws or {})
        for k, dt in (("noise", torch.float32), ("bg", torch.float32),
                      ("kmeans_init", torch.int64)):
            if k in draws:
                draws[k] = torch.as_tensor(np.array(draws[k]), dtype=dt,
                                           device=self.device)
        rows = self._table.index_select(
            0, torch.stack([self.opt.count_t, self._step_t]))
        sched = dict(zip(SCHEDULE_COLUMNS, rows[1]))
        given = draws.get("batch")
        if given is not None and "img_idxs" in given:   # a host batch
            batch = {k: as_index(given[k], self.device)
                     for k in ("img_idxs", "pix_idxs")}
        elif given is None and self.host_feed is not None:
            batch = self.host_feed.read()
        else:
            batch = self.sampler.sample(g, given)
        self.last_batch = batch
        img, pix = batch["img_idxs"], batch["pix_idxs"]
        target = {"rgb": scene["rays"][img, pix][..., :3]}
        for k in self.labels:
            target[k] = scene[f"label_{k}"][img, pix]
        rays_o, rays_d = self._assemble_rays(batch)
        stats: Dict[str, torch.Tensor] = {}
        results = render_train(
            self.model, self.occ, rays_o.contiguous(),
            rays_d.contiguous(), cfg.render, global_step=self.step,
            bootstrap=bootstrap, noise=draws.get("noise"), bg=draws.get("bg"),
            generator=g, sched=sched, depth_gt=target.get("depth"))
        loss_d = compute_losses(
            results, target, cfg.loss, self.model.cfg, step=self.step,
            ray_sampling_strategy=cfg.data.ray_sampling_strategy,
            random_tr_poses=cfg.data.random_tr_poses,
            patch_area=self.sampler.patch_area,
            offsets_local=self.sampler.offsets_local,
            kmeans_init=draws.get("kmeans_init"), generator=g, sched=sched,
            theta_WF=self.params.get("theta_WF"), stats=stats)
        names = list(self.params)
        grads = torch.autograd.grad(loss_d["total"],
                                    [self.params[n] for n in names],
                                    allow_unused=True)
        grads = {n: self._zeros(n) if gr is None else gr
                 for n, gr in zip(names, grads)}
        aux = {f"loss_{k}": v.detach() for k, v in loss_d.items()}
        aux.update(
            rm=results["rm_samples"].float(),
            vr=results["vr_samples"].float(),
            trunc=results["trunc_rays"].float(),
            mse=stats["mse"])   # K10's rgb mean before its guard
        if self.axis is not None:   # pmean (trainer.py:362-364)
            grads, aux = mean_over_axis(self.axis, grads, aux)
        self.last_grads = grads
        self.opt.update(grads, *rows[0, :OPT_COLUMNS])
        n_rays = self.sampler.batch_size   # this rank's (trainer.py:375)
        metrics = {
            "psnr": -10.0 * torch.log10(torch.clamp(aux.pop("mse"),
                                                    min=1e-12)),
            "rm_samples_per_ray": aux.pop("rm") / n_rays,
            "vr_samples_per_ray": aux.pop("vr") / n_rays,
            "trunc_ray_frac": aux.pop("trunc") / n_rays,
        }
        metrics.update(aux)
        self._record(metrics)
        self._step_t.add_(1)
        return metrics

    def _assemble_rays(self, batch: Dict[str, torch.Tensor]):
        """The batch's world rays (trainer.py:242-256): with
        `optimize_ext`, each image's pose rotated by axisangle_to_R(dR)
        and translated by dT; with random poses the same pixels again from
        the batch's random poses after them (not adjusted)."""
        img = batch["img_idxs"]
        poses = self.scene["poses"][img]
        dirs = self.scene["directions"][batch["pix_idxs"]]
        if "dR" in self.params:
            rot = axisangle_to_R(gather_rows(self.params["dR"], img))
            t = poses[..., 3] + gather_rows(self.params["dT"], img)
            poses = torch.cat([rot @ poses[..., :3], t[..., None]], dim=-1)
        if self.random_poses is not None:
            poses = torch.cat([poses,
                               self.random_poses[batch["rnd_img_idxs"]]])
            dirs = torch.cat([dirs, dirs])
        return get_rays(dirs, poses)

    def _zeros(self, name: str) -> torch.Tensor:
        """An unused parameter's gradient: zeros made at its first step."""
        if name not in self._zero_grads:
            self._zero_grads[name] = torch.zeros_like(self.params[name])
        return self._zero_grads[name]

    def _advance(self):
        self._step += 1
        self.opt.advance()

    def train_step_core(self, bootstrap: bool = True,
                        draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One eager optimisation step: the bootstrap march when
        `bootstrap`, else the march `render_train` picks from the occupancy
        state (the flat layout ignores `bootstrap`, as the JAX one does).
        `draws` may hold this step's random draws: "batch" (the sampler's
        `draw()`: {"img", "tri" / "corner" / "pix"[, "rnd"]}, or a host
        batch {"img_idxs", "pix_idxs"}), "noise" (N,), "bg" (3,) and
        "kmeans_init" (cluster_K,). With the host sampler and no batch
        given, the step takes the prefetcher's next batch.
        Returns the step's metrics as tensors (no host synchronisation)."""
        self._ensure_rows(self.step + 1)
        if self.host_feed is not None and "batch" not in (draws or {}):
            self.host_feed.load(1)
        return self._one_step(bootstrap, draws)

    def _one_step(self, bootstrap: bool, draws: Optional[Dict] = None):
        metrics = self._step_body(bootstrap, draws)
        self._advance()
        return metrics

    def train_chunk(self, n: int, bootstrap: Optional[bool] = None
                    ) -> Dict[str, torch.Tensor]:
        """`n` steps of one march with no refresh: the JAX trainer's
        `_make_chunk_fn` (one `lax.scan` dispatch). `bootstrap` defaults
        to whether this step is before `render.bootstrap_steps`. On the
        card, each march's first GRAPH_WARMUP steps run eagerly on a side
        stream; its next step is captured as a CUDA graph and every step
        after is a replay of it, with nothing on the host between replays
        (the flat layout's step too, as the kind "flat"). A gloo axis,
        whose all-reduce runs on the host, runs eager steps. On the CPU
        the same body runs eagerly. Returns the
        last step's metrics (tensors; on the card a graph's own, which its
        next replay overwrites)."""
        if bootstrap is None:
            bootstrap = self.step < self.cfg.render.bootstrap_steps
        self._ensure_rows(self.step + n)
        m = None
        on_card = self.device.type == "cuda"
        if self.host_feed is not None:
            self.host_feed.load(n)
        why = (f"{self.axis.backend} axis: eager steps, not a CUDA graph "
               "(its all-reduce runs on the host)"
               if self.axis is not None and self.axis.backend != "nccl"
               else None)
        if not on_card or why:
            if on_card and not self._eager_logged:
                _log.info(why)
                self._eager_logged = True
            for _ in range(n):
                m = self._one_step(bootstrap)
            return m
        kind = train_march_kind(self.model.cfg, self.cfg.render, self.occ,
                                bootstrap)
        for _ in range(n):
            graph = self._graphs.get(kind)
            if graph is None and self._warm.get(kind, 0) >= GRAPH_WARMUP:
                graph = self._capture(
                    kind, lambda: self._step_body(bootstrap))
            if graph is None:
                m = self._warm_step(kind, bootstrap)
            else:
                graph.replay()
                self._advance()
                m, self.last_batch, self.last_grads = self._graph_out[kind]
        if self.host_feed is not None:   # the next chunk's, while this one runs
            self.host_feed.prefetch(self.cfg.optim.update_interval)
        return m

    def _warm_step(self, kind: str, bootstrap: bool):
        """One eager step of `kind` before its capture, on a side stream."""
        main = torch.cuda.current_stream(self.device)
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            m = self._one_step(bootstrap)
        main.wait_stream(self._side)
        self._warm[kind] = self._warm.get(kind, 0) + 1
        return m

    def _capture(self, kind: str, body) -> kernels.CountedGraph:
        """Capture `body()` (one step of the march `kind`, or the refresh)
        as a CUDA graph (the capture runs nothing: the caller replays it
        for this step), in the trainer's one graph memory pool, with the
        generator registered; a step's outputs are kept in `_graph_out`.
        The kernels' launches it records are counted at each replay. On
        several cards the capture runs on the side stream of the eager
        warm-up steps, which have run its NCCL all-reduce there. A failed
        capture raises."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        t = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        stream = None if self.axis is None else self._side
        # a process group's watchdog thread queries its events while this
        # thread captures: only this thread's calls are checked
        mode = ("thread_local" if torch.distributed.is_initialized()
                else "global")
        with kernels.capture_counts() as counts:
            with torch.cuda.graph(graph, pool=self._pool, stream=stream,
                                  capture_error_mode=mode):
                out = body()
        self._graphs[kind] = kernels.CountedGraph(graph, counts)
        if kind != REFRESH:
            self._graph_out[kind] = (out, self.last_batch, self.last_grads)
        rec = {"kind": kind, "step": self.step,
               "ms": (time.perf_counter() - t) * 1e3,
               "launches": {k.name: c for k, c in counts.items()}}
        self.captures.append(rec)
        what = "refresh" if kind == REFRESH else f"{kind} step"
        _log.info(f"captured the {what} as a CUDA graph at step "
                  f"{self.step} in {rec['ms']:.1f} ms "
                  f"({sum(counts.values())} kernel launches of the port)")
        return self._graphs[kind]

    # ------------------------------------------------------------------ fit
    def fit(self, n_steps: int, occ_update: bool = True, log_every: int = 0,
            log_fn=print, logger=None) -> List[Dict[str, float]]:
        """Train `n_steps` steps from the current step as the JAX bench's
        `run_steps` does: an occupancy refresh at every `update_interval`
        boundary (unless not `occ_update`, its cost probe), a whole chunk
        (`train_chunk`) where one fits before the end, single steps
        otherwise. Call `mark_invisible_cells()` once before the first
        step, as bench.py does. With `log_every`, after the chunk or step
        that brings the step `log_every` or more past the last log, the
        JAX trainer's line (trainer.py:445-459; it/s is the absolute step
        over the time since `fit` began, as there) goes to `log_fn` and
        the step's metrics under "train/" to `logger`: one read of the
        device a log, between chunks. Returns every step's metrics as
        floats, copied from the device once."""
        cfg = self.cfg
        interval = cfg.optim.update_interval
        start, end = self.step, self.step + n_steps
        self._ensure_rows(end)
        t0, last_log = time.time(), start
        while self.step < end:
            step = self.step
            if step % interval == 0 and occ_update:
                self.occ_update(warmup=step < cfg.optim.warmup_steps)
            whole = step % interval == 0 and step + interval <= end
            self.train_chunk(interval if whole else 1)
            if (log_every and self.step - last_log >= log_every
                    and (self.axis is None or self.axis.rank == 0)):
                last_log = step = self.step
                m = self._history(step - 1, step)[0]
                rate = step / max(time.time() - t0, 1e-9)
                log_fn(f"step {step}/{end} "
                       f"loss={m.get('loss_total', float('nan')):.4f} "
                       f"psnr={m.get('psnr', float('nan')):.2f} "
                       f"rm/ray={m.get('rm_samples_per_ray', 0):.1f} "
                       f"vr/ray={m.get('vr_samples_per_ray', 0):.1f} "
                       f"trunc={m.get('trunc_ray_frac', 0):.4f} "
                       f"({rate:.1f} it/s)")
                if logger is not None:
                    logger.log_scalars(m, step, prefix="train/")
        return self._history(start, end)

    def _history(self, start: int, end: int) -> List[Dict[str, float]]:
        """The metrics of steps start..end-1 as floats (one copy)."""
        if end <= start:
            return []
        rows = self._hist[start:end].cpu().tolist()
        return [dict(zip(self._hist_keys, r)) for r in rows]

    # -------------------------------------------------------------- validate
    @rank0_only
    def render_image(self, pose, scene: Optional[SceneData] = None) -> Dict:
        """Full-image render of one pose (train_nerf.py:381-401)."""
        return self.render_images([pose], scene)[0]

    @rank0_only
    def render_images(self, poses, scene: Optional[SceneData] = None
                      ) -> List[Dict]:
        """Render whole images through the camera (directions, size) of
        `scene`, by default the held-out scene or else the training one:
        the rays of every pose in one stream, cut into `render.test_chunk`
        rays per `render_test` call (trainer.py:467-535). Returns one dict
        of host numpy arrays per image (rgb (H, W, 3), depth and opacity
        (H, W), norm_nn, sem) with its share of total_samples;
        `self.last_render` holds the whole render's samples and rounds."""
        cfg, dev = self.cfg, self.device
        scene = scene or self.scene_test or self.scene_train
        W, H = scene.img_wh
        directions = torch.as_tensor(scene.directions, dtype=torch.float32,
                                     device=dev)
        ros, rds = [], []
        for pose in poses:
            ro, rd = get_rays(directions, torch.as_tensor(
                np.asarray(pose, np.float32), device=dev))
            ros.append(ro)
            rds.append(rd)
        rays_o = torch.cat(ros).contiguous()
        rays_d = torch.cat(rds).contiguous()
        chunk = cfg.render.test_chunk
        outs = [render_test(self.model, self.occ, rays_o[i:i + chunk],
                            rays_d[i:i + chunk], cfg.render)
                for i in range(0, rays_o.shape[0], chunk)]
        total = sum(o["total_samples"] for o in outs)
        self.last_render = {"total_samples": total,
                            "rounds": sum(o["rounds"] for o in outs)}
        keys = [k for k in outs[0] if k not in ("total_samples", "rounds")]
        cat = {k: torch.cat([o[k] for o in outs]).cpu().numpy() for k in keys}
        n_px = H * W
        results = []
        for j in range(len(poses)):
            res = {"total_samples": total // len(poses)}
            for k, v in cat.items():
                sl = v[j * n_px:(j + 1) * n_px]
                res[k] = sl.reshape(H, W, -1) if sl.ndim == 2 else sl.reshape(H, W)
            results.append(res)
        return results

    @rank0_only
    def validate(self, save_vis_dir: Optional[str] = None,
                 save_preds_dir: Optional[str] = None, logger=None,
                 rotation_draws=None) -> Dict[str, float]:
        """Render the test split, compute the metric suite and recover the
        Manhattan rotation (trainer.py:537-633); write each view's
        prediction and ground-truth panels as `<img_id>_pred.png` /
        `_gt.png` into `save_vis_dir`, the predictions' archive
        `test_pred.tar.gz` into `save_preds_dir`, and the prediction panels
        and "test/" scalars to `logger`. `rotation_draws` may hold the
        k-means initial draws of each recovery restart; else they come
        from a generator seeded with seed ^ 0xA11."""
        cfg = self.cfg
        scene = self.scene_test or self.scene_train
        agg = NeRFMTMetricsPerIm(
            pred_norm_nn=cfg.model.pred_norm_nn,
            pred_norm_depth=cfg.model.pred_norm_depth,
            pred_sem=cfg.model.pred_sem,
            load_depth_gt=cfg.data.load_depth_gt or "depth" in scene.labels,
            load_norm_gt=cfg.data.load_norm_gt or "normals" in scene.labels,
            load_sem_gt="semantics" in scene.labels,
            load_sem_WF_gt="semantics_WF" in scene.labels,
            n_classes=scene.n_classes, eval_lpips=cfg.eval.eval_lpips,
            device=self.device,
        )
        preds = []
        all_res = self.render_images(list(scene.poses))
        directions = torch.as_tensor(scene.directions, dtype=torch.float32,
                                     device=self.device)
        for i in range(scene.n_images):
            res = all_res[i]
            pred = {"rgb": res["rgb"], "depth": res["depth"]}
            if "norm_nn" in res:
                pred["norm_nn"] = res["norm_nn"]
            if cfg.model.pred_norm_depth:
                nd = extract_normals_from_depth_batch(
                    torch.as_tensor(res["depth"], device=self.device)[None],
                    directions, torch.as_tensor(
                        scene.poses[i:i + 1], dtype=torch.float32,
                        device=self.device))
                pred["norm_depth"] = nd[0].cpu().numpy()
            if "sem" in res:
                pred["sem"] = res["sem"]
            gt = validation_gt(scene, i)
            agg.update(pred, gt)
            preds.append(pred)
            name = scene.img_ids[i] or i
            n_cls = max(scene.n_classes, 3)
            panel = (pack_vis_panel(pred, n_classes=n_cls,
                                    downsample=cfg.eval.downsample_vis)
                     if save_vis_dir or logger is not None else None)
            if save_vis_dir:
                save_vis_png(os.path.join(save_vis_dir, f"{name}_pred.png"),
                             panel)
                save_vis_png(os.path.join(save_vis_dir, f"{name}_gt.png"),
                             pack_vis_panel(gt, n_classes=n_cls,
                                            downsample=cfg.eval.downsample_vis))
            if logger is not None:
                logger.log_image(f"val/{name}", panel, self.step)
        out = agg.compute()
        if cfg.model.pred_norm_depth and preds:
            all_nd = np.concatenate(
                [p["norm_depth"].reshape(-1, 3) for p in preds])
            gen = None
            if rotation_draws is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    cfg.seed ^ 0xA11)
            try:
                out.update(rotation_recovery_errors(
                    all_nd, self.R_offset, init_draws=rotation_draws,
                    generator=gen, device=self.device))
            except (ValueError, np.linalg.LinAlgError) as e:
                # degenerate clustering early in training (an SVD of a
                # rank-deficient centroid triplet); anything else raises
                warnings.warn(f"rotation recovery failed: {e}",
                              RuntimeWarning)
                out["ang/clust/failed"] = 1.0
        if save_preds_dir:
            save_preds_tar_gz(save_preds_dir,
                              {k: [p[k] for p in preds] for k in preds[0]},
                              scene.img_ids, "test", "pred")
        if logger is not None:
            logger.log_scalars(out, self.step, prefix="test/")
        self._last_val_preds = preds
        return out

    @rank0_only
    def save_train_preds(self, save_dir: str):
        """Render the training views one at a time and write the
        predictions' and the labels' archives, `train_pred.tar.gz` and
        `train_gt.tar.gz` (trainer.py:635-658; reference:
        train_nerf.py:747-779)."""
        scene = self.scene_train
        W, H = scene.img_wh
        preds, gts = [], []
        for i in range(scene.n_images):
            res = self.render_image(scene.poses[i], scene)
            preds.append({k: res[k] for k in ("rgb", "depth", "norm_nn",
                                              "sem") if k in res})
            gt = {"rgb": scene.rays[i, :, :3].reshape(H, W, 3)}
            for k, v in scene.labels.items():
                gt[k] = (v[i].reshape(H, W, -1) if v[i].ndim == 2
                         else v[i].reshape(H, W))
            gts.append(gt)
        for tag, rows in (("pred", preds), ("gt", gts)):
            save_preds_tar_gz(save_dir, {k: [r[k] for r in rows]
                                         for k in rows[0]},
                              scene.img_ids, "train", tag)
