"""Rank bodies of tests/test_torch_parallel.py: each runs in one process of
a 2-rank gloo group on the CPU (started by `parallel.launch.spawn`, or by
the test with the launcher's environment variables), imports no JAX, and
writes what the test compares with `torch.save` to `<out>.<rank>`.

    python tests/torch_parallel_workers.py chunk ARGS OUT   # under the env
"""
import os
import pickle
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from normal_clustering_nerf_torch.datasets.synthetic import (  # noqa: E402
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.models.occupancy import (  # noqa: E402
    OccupancyGrid, OccupancyState,
)
from normal_clustering_nerf_torch.parallel.launch import (  # noqa: E402
    initialize_multihost,
)
from normal_clustering_nerf_torch.training import Trainer  # noqa: E402
from normal_clustering_nerf_torch.training.checkpoints import (  # noqa: E402
    restore_checkpoint, save_checkpoint,
)
from normal_clustering_nerf_torch.training.distributed import (  # noqa: E402
    shard_seed,
)


def density(xyz):
    """tests/test_torch_occupancy.py's `_density_t`: piecewise constant,
    dyadic values, so that both frameworks' grid means are exact."""
    q = (torch.floor(xyz[:, 0] * 8) + 3 * torch.floor(xyz[:, 1] * 8)
         + 5 * torch.floor(xyz[:, 2] * 8))
    return torch.remainder(q, 9.0) / 8.0 * 12.0


def scenes(test_views=0):
    tr = TSyn(split="train", img_wh=(24, 24), n_images=6).load()
    te = (TSyn(split="test", img_wh=(24, 24), n_images=test_views).load()
          if test_views else None)
    return tr, te


def state_of(tr):
    """Parameters, moments, occupancy and step, copied."""
    return {"params": {n: p.detach().clone() for n, p in tr.params.items()},
            "mu": {n: t.clone() for n, t in tr.opt.state["mu"].items()},
            "nu": {n: t.clone() for n, t in tr.opt.state["nu"].items()},
            "occ": {n: t.clone() for n, t in tr.occ._asdict().items()},
            "step": tr.step}


def _load(tr, data):
    tr.load_state(data["params"], OccupancyState(**data["occ"]),
                  data["opt"], data["step"])


def chunk_of(tr, data, cfg):
    """A 2-step chunk from the converted JAX state, each rank drawing
    with its own generator from its seed."""
    _load(tr, data)
    tr.generator.manual_seed(shard_seed(cfg.seed, tr.axis.rank))
    m = tr.train_chunk(2)
    return {"loss_total": float(m["loss_total"]), **state_of(tr)}


def step_worker(cfg, data_path, out):
    """The sharded refresh from a given grid with each rank's JAX draws
    (the density `density`), two ranks' packed bytes 0b01 / 0b10 merged,
    one step from the converted JAX state with each rank's JAX draws, and
    `chunk_of`."""
    assert initialize_multihost(device="cpu")
    data = torch.load(data_path, weights_only=False)
    tr = Trainer(cfg, scenes()[0], device="cpu")
    r = tr.axis.rank
    res = {"rank": r, "world": dist.get_world_size(),
           "backend": tr.axis.backend, "batch": tr.sampler.batch_size}

    ref = data["refresh"]
    tr.occ = OccupancyState(**ref["occ"])
    tr.model.density = density
    tr.occ_update(False, jitter=ref["jitter"][r],
                  cell_draws={"uniform": ref["uniform"][r][None],
                              "occ_rank": ref["occ_rank"][r][None]})
    del tr.model.density
    res["refresh"] = {n: t.clone() for n, t in tr.occ._asdict().items()}
    one = tr.occ._replace(density_bitfield=torch.zeros_like(
        tr.occ.density_bitfield))
    one.density_bitfield[0] = 1 << r
    res["bytes_merged"] = OccupancyGrid.merge_across_chips(
        one, tr.axis.group).density_bitfield[:2].clone()

    _load(tr, data)
    m = tr.train_step_core(bootstrap=True, draws=data["draws"][r])
    res["metrics"] = {k: float(v) for k, v in m.items()}
    res["grads"] = {n: g.clone() for n, g in tr.last_grads.items()}
    res["step"] = state_of(tr)
    res["chunk"] = chunk_of(tr, data, cfg)
    torch.save(res, f"{out}.{r}")


def chunk_worker(cfg, data_path, out):
    """`chunk_of` in a process group joined from the environment."""
    assert initialize_multihost(device="cpu")
    tr = Trainer(cfg, scenes()[0], device="cpu")
    data = torch.load(data_path, weights_only=False)
    torch.save(chunk_of(tr, data, cfg), f"{out}.{tr.axis.rank}")


def fit_worker(cfg, ckpt, out):
    """`fit` for 3 steps (refreshes at 0 and 2 at update_interval 2),
    `validate` on 2 held-out views, a 4th step; then 2 steps, a
    checkpoint, a fresh trainer restored from it and 2 more steps."""
    assert initialize_multihost(device="cpu")
    tr_scene, te_scene = scenes(test_views=2)
    a = Trainer(cfg, tr_scene, te_scene, device="cpu")
    a.mark_invisible_cells()
    res = {"hist": a.fit(3), "three": state_of(a)}
    res["val"] = a.validate()
    a.fit(1)
    res["four"] = state_of(a)
    b = Trainer(cfg, tr_scene, te_scene, device="cpu")
    b.mark_invisible_cells()
    b.fit(2)
    save_checkpoint(ckpt, b)
    c = Trainer(cfg, tr_scene, te_scene, device="cpu")
    restore_checkpoint(ckpt, c)
    res["restored_step"] = c.step
    c.fit(2)
    res["resumed"] = state_of(c)
    torch.save(res, f"{out}.{a.axis.rank}")


def cli_rank(argv, device):
    """One rank of the CLI, its fit cut to 3 steps and its validation
    stubbed (tests/test_torch_extrinsics.py's cut)."""
    from normal_clustering_nerf_torch import train_nerf
    train_nerf._fit = lambda trainer, cfg, logger: trainer.fit(3)
    Trainer.validate = lambda self, **kw: {"psnr": 0.0}
    return train_nerf.main(argv, device)


if __name__ == "__main__":
    torch.set_num_threads(1)   # the spawned ranks' count: the same sums
    _, what, args_path, out_path = sys.argv
    with open(args_path, "rb") as f:
        args = pickle.load(f)
    {"chunk": chunk_worker}[what](*args, out_path)
