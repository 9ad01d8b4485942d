"""Training on several cards (`parallel/`, `training/distributed.py`),
on the CPU: 2 ranks as real gloo processes, their rendezvous a `file://`
store in tmp_path (`parallel.launch.spawn`, or the launcher's environment
variables), against the JAX package's sharded functions on a 2-device
mesh of conftest's CPU devices.

  * one sharded step from a converted JAX state against
    `make_sharded_train_step` (bootstrap march), each rank handed its
    shard's draws (tests/test_torch_slice.py's `_jax_draws` with the
    shard folded into k_batch / k_render / k_loss and the local sampler):
    losses, gradients (the mean of the two shards') and parameters at
    test_torch_slice.py's tolerances; the two ranks' parameters and
    moments bit for bit;
  * the sharded refresh against `make_sharded_occ_update` (each shard's
    cells and jitter handed in, the density a dyadic function of the
    position as in tests/test_torch_occupancy.py): every field exact; two
    ranks' packed bytes 0b01 / 0b10 merge to 0b11;
  * `Trainer` with `ParallelConfig(mesh_shape=(2,))`: `fit` across two
    refreshes, `validate` on rank 0, a resume through a checkpoint equal
    to the uninterrupted run on both ranks; the refusals;
  * a 2-step chunk of ranks started from the environment equal to the
    spawned ranks' (`tests/test_multihost_launch.py`);
  * the CLI with `--num_chips=2`.

The slice configuration at a global batch of 192 (96 rays a rank, the
slice tests' shapes; the march budget 1536 a rank, as in JAX, where each
shard marches its rays with the configured budget)."""
import csv
import dataclasses
import os
import pickle
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, J, N, slice_configs
import torch_parallel_workers as workers

from normal_clustering_nerf_torch.config import ParallelConfig as TPar
from normal_clustering_nerf_torch.convert import convert_jax_state
from normal_clustering_nerf_torch.parallel import launch
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_torch.training.checkpoints import (
    restore_checkpoint, save_checkpoint,
)
from normal_clustering_nerf_tpu.datasets.normals import (
    extract_normals_from_ray_batch,
)
from normal_clustering_nerf_tpu.datasets.sampler import RaySampler
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.losses import compute_losses, triang_idx
from normal_clustering_nerf_tpu.models import occupancy as jo
from normal_clustering_nerf_tpu.models.rendering import render_train
from normal_clustering_nerf_tpu.parallel.mesh import make_mesh
from normal_clustering_nerf_tpu.training import Trainer as JTrainer
from normal_clustering_nerf_tpu.training.distributed import (
    make_sharded_occ_update, make_sharded_train_step,
)

RANKS, BATCH = 2, 192
THR = 0.01 * 1024 / np.sqrt(3.0)   # the slice config's density threshold


def configs(**optim):
    jcfg, tcfg = slice_configs()
    out = []
    for c in (jcfg, tcfg):
        c = c.replace(
            data=dataclasses.replace(c.data, batch_size=BATCH),
            render=dataclasses.replace(c.render, bootstrap_steps=16,
                                       sv_intervals=24),
            optim=dataclasses.replace(c.optim, **optim))
        out.append(c)
    jcfg, tcfg = out
    return jcfg, tcfg.replace(parallel=TPar(mesh_shape=(RANKS,)))


def _flat(tree):
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _density_j(xyz):
    q = (jnp.floor(xyz[:, 0] * 8) + 3 * jnp.floor(xyz[:, 1] * 8)
         + 5 * jnp.floor(xyz[:, 2] * 8))
    return jnp.mod(q, 9.0) / 8.0 * 12.0


def _shard_draws(jt, state, shard, sampler):
    """`_jax_draws` of tests/test_torch_slice.py for shard `shard`: the
    key splits of train_step_core with the shard folded in
    (trainer.py:313-320), the local sampler's draws, the eager JAX loss's
    gradients and the k-means init over its clustering-valid mask."""
    cfg = jt.cfg
    _, k_batch, k_render, k_loss = jax.random.split(state.key, 4)
    k_batch, k_render, k_loss = (jax.random.fold_in(k, shard)
                                 for k in (k_batch, k_render, k_loss))
    k_img, k_pix, _ = jax.random.split(k_batch, 3)
    n_tri = sampler.batch_size // 3
    draws = {"batch": {
        "img": np.asarray(jax.random.randint(k_img, (n_tri,), 0,
                                             jt.scene_train.n_images)),
        "tri": np.asarray(jax.random.randint(
            k_pix, (n_tri,), 0, sampler.triang.x1.shape[0]))}}
    k_noise, k_bg = jax.random.split(k_render)
    draws["noise"] = np.asarray(jax.random.uniform(k_noise, (3 * n_tri,)))
    draws["bg"] = np.asarray(jax.random.uniform(k_bg, (3,)))
    batch = sampler.sample(k_batch)
    scene = jt.scene_dev
    target = {"rgb": scene["rays"][batch["img_idxs"],
                                   batch["pix_idxs"]][..., :3]}
    for name in ("depth", "normals", "normals_depth", "semantics",
                 "semantics_WF"):
        target[name] = scene[f"label_{name}"][batch["img_idxs"],
                                              batch["pix_idxs"]]

    def loss_fn(params):
        rays_o, rays_d = jt._assemble_rays(params, batch, scene)
        res = render_train(jt.model, params["model"],
                           state.occ.density_bitfield, rays_o, rays_d,
                           k_render, cfg.render, global_step=state.step,
                           coarse_occ=state.occ.coarse_occ,
                           sv_mask=state.occ.sv_mask,
                           sv_payload=state.occ.sv_payload, bootstrap=True)
        loss_d = compute_losses(
            res, target, cfg.loss, jt.model.cfg, step=state.step, key=k_loss,
            ray_sampling_strategy=cfg.data.ray_sampling_strategy)
        nd = extract_normals_from_ray_batch(
            res["rays_o"], res["rays_d"], res["depth"],
            triang_idx(res["depth"].shape[0]))
        return loss_d["total"], (loss_d, nd, res["rm_samples"],
                                 res["vr_samples"])

    grads, (loss_d, nd, rm, vr) = jax.grad(loss_fn, has_aux=True)(
        state.params)
    nd = np.asarray(nd)
    valid = np.all(np.isfinite(nd), -1) & (np.abs(nd).sum(-1) != 0)
    p = valid / max(valid.sum(), 1)
    draws["kmeans_init"] = np.asarray(jax.random.choice(
        k_loss, nd.shape[0], (cfg.loss.cluster_K,), replace=False, p=J(p)))
    return draws, _flat(grads["model"]), loss_d, int(rm), int(vr)


def _refresh_reference(mesh):
    """A grid with invisible cells and earlier densities, the JAX sharded
    refresh of it (`make_sharded_occ_update` around the grid's own update
    with the dyadic density), and each shard's draws replayed
    (occupancy.py:155-172, 207-211 from the key folded by the shard)."""
    G = 32
    jg = jo.OccupancyGrid(jcfg_model(G))
    rng = np.random.default_rng(5)
    grid = rng.integers(0, 16, (1, G ** 3)).astype(np.float64)   # > THR too
    grid[:, rng.random(G ** 3) < 0.1] = -1.0
    st = jg.init_state()._replace(density_grid=J(grid, jnp.float32))
    occ_in = {n: torch.as_tensor(np.array(getattr(st, n)))
              for n in st._fields}
    stub = types.SimpleNamespace(
        _occ_update_impl=lambda occ, params, key, warmup: jg.update(
            occ, _density_j, key, THR, warmup=warmup, erode=False))
    key = jax.random.PRNGKey(11)
    ref = make_sharded_occ_update(stub, mesh, warmup=False)(
        jax.tree_util.tree_map(jnp.copy, st), jnp.zeros(()), key)
    M = G ** 3 // 4
    n_occ = int(jnp.sum(st.density_grid[0] > THR))
    assert n_occ > 0
    draws = {"jitter": [], "uniform": [], "occ_rank": []}
    for shard in range(RANKS):
        k_cells, k_jit = jax.random.split(jax.random.fold_in(key, shard))
        k_u, k_o = jax.random.split(k_cells, 2)
        draws["uniform"].append(np.asarray(
            jax.random.randint(k_u, (M,), 0, G ** 3)))
        draws["occ_rank"].append(np.asarray(
            jax.random.randint(k_o, (M,), 0, n_occ)))
        draws["jitter"].append(torch.as_tensor(np.array(jax.random.uniform(
            jax.random.fold_in(k_jit, 0), (2 * M, 3)))[None]))
    return dict(occ=occ_in, **draws), ref


def jcfg_model(G):
    from normal_clustering_nerf_tpu.config import ModelConfig
    return ModelConfig(grid_size=G)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The JAX side (a state after a full refresh, its sharded bootstrap
    step, each shard's draws and gradients, the sharded refresh) and the
    two spawned ranks' results of `workers.step_worker`."""
    tmp = tmp_path_factory.mktemp("sharded")
    jcfg, tcfg = configs()
    jt = JTrainer(jcfg, JSyn(split="train", img_wh=(24, 24),
                             n_images=6).load())
    jt.mark_invisible_cells()
    occ = jt._occ_update[True](jt.state.occ, jt.state.params,
                               jax.random.PRNGKey(7))
    state0 = jt.state._replace(occ=occ)
    mesh = make_mesh((RANKS,), ("rays",))
    sampler = RaySampler(jcfg.data.ray_sampling_strategy, BATCH // RANKS,
                         jt.scene_train.img_wh, jt.scene_train.n_images,
                         max_expand=jcfg.data.triang_max_expand)
    shards = [_shard_draws(jt, state0, s, sampler) for s in range(RANKS)]
    step = make_sharded_train_step(jt, mesh, bootstrap=True)
    state1, m_ref = step(jax.tree_util.tree_map(jnp.copy, state0),
                         jt.scene_dev)
    one = TTrainer(tcfg.replace(parallel=TPar()), workers.scenes()[0],
                   device=CPU)
    params, occ_t, opt_state = convert_jax_state(
        jax.tree_util.tree_map(np.asarray, state0.params),
        jax.tree_util.tree_map(np.asarray, state0.occ), one.opt, CPU)
    refresh, refresh_ref = _refresh_reference(mesh)
    data = {"params": params, "occ": occ_t._asdict(), "opt": opt_state,
            "step": int(state0.step), "draws": [s[0] for s in shards],
            "refresh": refresh}
    torch.save(data, tmp / "data.pt")
    out = str(tmp / "step")
    launch.spawn(workers.step_worker, RANKS,
                 (tcfg, str(tmp / "data.pt"), out), device="cpu")
    ranks = [torch.load(f"{out}.{r}", weights_only=False)
             for r in range(RANKS)]
    return dict(jt=jt, state1=state1, m_ref=m_ref, shards=shards,
                refresh_ref=refresh_ref, ranks=ranks, tcfg=tcfg, tmp=tmp)


def _same(a, b, what):
    """Two ranks' dicts of tensors, bit for bit."""
    assert a.keys() == b.keys(), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what} {k}"


def test_sharded_step_matches_jax(sharded):
    r0, r1 = sharded["ranks"]
    assert (r0["rank"], r1["rank"], r0["world"]) == (0, 1, RANKS)
    assert r0["backend"] == "gloo" and r0["batch"] == BATCH // RANKS
    m_ref = sharded["m_ref"]
    shards = sharded["shards"]
    for k in shards[0][2]:
        mean = np.mean([float(s[2][k]) for s in shards])
        for got in (r0["metrics"][f"loss_{k}"], float(m_ref[f"loss_{k}"])):
            np.testing.assert_allclose(got, mean, rtol=1e-4, atol=1e-7,
                                       err_msg=f"loss {k}")
        np.testing.assert_allclose(r0["metrics"][f"loss_{k}"],
                                   float(m_ref[f"loss_{k}"]), rtol=1e-4,
                                   atol=1e-7, err_msg=f"loss {k} vs JAX")
    # per-ray counters: the mean of the shards' counts over the local batch
    local = BATCH // RANKS
    for k, i in (("rm_samples_per_ray", 3), ("vr_samples_per_ray", 4)):
        assert round(r0["metrics"][k] * local * RANKS) == sum(
            s[i] for s in shards), k
        np.testing.assert_allclose(r0["metrics"][k], float(m_ref[k]),
                                   rtol=1e-6)
    g_ref = {n: np.mean([s[1][n] for s in shards], axis=0)
             for n in shards[0][1]}
    assert set(g_ref) == set(r0["grads"])
    for n, g in r0["grads"].items():
        r = g_ref[n]
        np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"grad {n}")
    p_ref = _flat(sharded["state1"].params["model"])
    atol = 1e-3 * sharded["jt"].cfg.optim.lr
    for n, p in r0["step"]["params"].items():
        np.testing.assert_allclose(N(p), p_ref[n], rtol=0, atol=atol,
                                   err_msg=f"param {n} after the step")
    assert r0["step"]["step"] == int(sharded["state1"].step) == 1
    for part in ("params", "mu", "nu", "occ"):
        _same(r0["step"][part], r1["step"][part], f"step {part}")
    _same(r0["grads"], r1["grads"], "grads")
    assert r0["metrics"] == r1["metrics"]


def test_sharded_refresh_matches_jax(sharded):
    ref = sharded["refresh_ref"]
    for res in sharded["ranks"]:
        for name in ref._fields:
            np.testing.assert_array_equal(N(res["refresh"][name]),
                                          np.asarray(getattr(ref, name)),
                                          err_msg=name)
    assert int(np.asarray(ref.density_bitfield).astype(bool).sum()) > 0


def test_packed_bytes_merge_as_an_or(sharded):
    """Rank 0 holds 0b01 in byte 0, rank 1 0b10: the merge is 0b11 (a MAX
    of the packed bytes would give 0b10)."""
    for res in sharded["ranks"]:
        assert res["bytes_merged"].tolist() == [0b11, 0]


def _chunk_results(out):
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(RANKS)]


def test_launcher_from_the_environment(sharded, monkeypatch):
    """2 processes joined by COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID (a file store), a 2-step chunk from the converted JAX
    state: equal to the spawned ranks' chunk, and on both ranks; alone,
    `initialize_multihost()` is a no-op returning False."""
    tmp = sharded["tmp"]
    with open(tmp / "args.pkl", "wb") as f:
        pickle.dump((sharded["tcfg"], str(tmp / "data.pt")), f)
    env = dict(os.environ, COORDINATOR_ADDRESS=f"file://{tmp}/env_store",
               NUM_PROCESSES=str(RANKS))
    out = str(tmp / "env_chunk")
    procs = [subprocess.Popen(
        [sys.executable, workers.__file__, "chunk", str(tmp / "args.pkl"),
         out], env=dict(env, PROCESS_ID=str(r)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT) for r in range(RANKS)]
    logs = [p.communicate(timeout=300)[0].decode()[-2000:] for p in procs]
    assert [p.returncode for p in procs] == [0] * RANKS, logs
    got = _chunk_results(out)
    spawned = [r["chunk"] for r in sharded["ranks"]]
    for g, s in zip(got, spawned):
        assert g["step"] == s["step"] == 2
        assert g["loss_total"] == s["loss_total"]
        assert np.isfinite(g["loss_total"])
        for part in ("params", "mu", "nu", "occ"):
            _same(g[part], s[part], f"env chunk {part}")
    for part in ("params", "mu", "nu", "occ"):
        _same(got[0][part], got[1][part], f"env ranks {part}")
    for k in ("COORDINATOR_ADDRESS", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    assert launch.initialize_multihost(device="cpu") is False
    assert not torch.distributed.is_initialized()


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fit")
    _, tcfg = configs(update_interval=2)
    out, ckpt = str(tmp / "fit"), str(tmp / "ckpt")
    launch.spawn(workers.fit_worker, RANKS, (tcfg, ckpt, out), device="cpu")
    return [torch.load(f"{out}.{r}", weights_only=False)
            for r in range(RANKS)], ckpt


def test_trainer_wires_the_axis_from_config(fitted):
    """`fit` for 3 steps across the refreshes at steps 0 and 2 (each rank
    its own cells and jitter, merged): finite losses, step 3, replicas
    identical; `validate` on rank 0, None on rank 1."""
    (r0, r1), _ = fitted
    assert len(r0["hist"]) == 3 and r0["three"]["step"] == 3
    assert all(np.isfinite(h["loss_total"]) for h in r0["hist"])
    assert r0["hist"] == r1["hist"]
    for part in ("params", "mu", "nu", "occ"):
        _same(r0["three"][part], r1["three"][part], part)
    assert np.isfinite(r0["val"]["psnr"]) and r1["val"] is None


def test_resume_on_two_ranks_equals_the_whole_run(fitted):
    """2 steps, a checkpoint (every rank's generator in it), a fresh
    trainer restored from it, 2 more steps (the refresh at step 2
    included): bit for bit the 4-step run, on both ranks."""
    ranks, ckpt = fitted
    for res in ranks:
        assert res["restored_step"] == 2 and res["resumed"]["step"] == 4
        for part in ("params", "mu", "nu", "occ"):
            _same(res["resumed"][part], res["four"][part], part)
    ck = torch.load(os.path.join(ckpt, "state.pt"), weights_only=True)
    assert ck["world_size"] == RANKS and len(ck["rank_generators"]) == RANKS
    assert not torch.equal(*ck["rank_generators"])
    assert torch.equal(ck["generator"], ck["rank_generators"][0])


def test_restore_onto_another_world_size_is_refused(tmp_path):
    _, tcfg = configs()
    tr = TTrainer(tcfg.replace(parallel=TPar()), workers.scenes()[0],
                  device=CPU)
    save_checkpoint(str(tmp_path), tr)
    path = tmp_path / "state.pt"
    ck = torch.load(path, weights_only=True)
    ck["world_size"] = 2
    torch.save(ck, path)
    with pytest.raises(ValueError, match="checkpoint of 2 rank"):
        restore_checkpoint(str(tmp_path), tr)


@pytest.mark.parametrize("change,error,match", [
    (dict(host_sampler=True), ValueError, "single-device only"),
    (dict(batch_size=191), ValueError, "must divide over 2 ranks"),
    ({}, RuntimeError, "no process group"),
])
def test_refusals(change, error, match):
    """The host sampler with two ranks, a batch that does not divide, and
    two ranks without a process group raise; nothing falls back to one
    rank."""
    _, tcfg = configs()
    tcfg = tcfg.replace(data=dataclasses.replace(tcfg.data, **change))
    with pytest.raises(error, match=match):
        TTrainer(tcfg, workers.scenes()[0], device=CPU)


@pytest.mark.parametrize("env,want", [
    (dict(COORDINATOR_ADDRESS="10.0.0.1:1234", NUM_PROCESSES="4",
          PROCESS_ID="3"), ("10.0.0.1:1234", 4, 3)),
    (dict(MASTER_ADDR="10.0.0.2", MASTER_PORT="29500", WORLD_SIZE="8",
          RANK="5"), ("10.0.0.2:29500", 8, 5)),
    ({}, (None, 1, 0)),
])
def test_launcher_environment_names(monkeypatch, env, want):
    """The JAX package's variables, else torchrun's; a group of one
    process (or none described) is no group: `initialize_multihost`
    returns False."""
    for k in ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID",
              "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert launch._from_env() == want
    assert launch.launched() == (want[1] > 1)
    if want[0]:
        monkeypatch.setenv("NUM_PROCESSES" if "PROCESS_ID" in env
                           else "WORLD_SIZE", "1")
    assert launch.initialize_multihost(device="cpu") is False


def test_one_rank_has_no_axis():
    _, tcfg = configs()
    tr = TTrainer(tcfg.replace(parallel=TPar(mesh_shape=(1,))),
                  workers.scenes()[0], device=CPU)
    assert tr.axis is None and not torch.distributed.is_initialized()
    assert tr.sampler.batch_size == BATCH


def test_cli_on_two_ranks(tmp_path, monkeypatch):
    """`main(["--num_chips=2", ...], device="cpu")` starts 2 ranks itself
    (`launch.spawn`, here with each rank's fit cut to 3 steps and its
    validation stubbed), and rank 0 alone writes results.csv and the
    checkpoint; `main` returns rank 0's metrics."""
    spawned = []
    real = launch.spawn

    def spawn(fn, n, args=(), device="cuda"):
        spawned.append((fn.__name__, n, device))
        return real(workers.cli_rank, n, args, device=device)

    monkeypatch.setattr(launch, "spawn", spawn)
    from normal_clustering_nerf_torch import train_nerf
    metrics = train_nerf.main(
        ["--num_chips=2", "--dataset_name=synthetic", "--save_checkpoint",
         f"--log_root_dir={tmp_path}", "--exp_name=two"], device="cpu")
    assert spawned == [("main", 2, "cpu")]
    assert metrics == {"psnr": 0.0}
    run = tmp_path / "two"
    with open(run / "results.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["info/step"] == "3"
    ck = torch.load(run / "ckpt" / "state.pt", weights_only=True)
    assert ck["step"] == 3 and ck["world_size"] == 2
