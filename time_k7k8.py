#!/usr/bin/env python3
"""Device time of the clustering loss's k-means and cluster selection
(K7) and of the sampled occupancy refresh (K8) as the main path calls
them, and what a graph step and a refresh window cost the card, in the
checkout at --root.

Run from the repository root on a machine with one NVIDIA H100:

    python3 time_k7k8.py              # this checkout
    python3 time_k7k8.py --root DIR   # the checkout at DIR

It builds the bench trainer (triplane field) of that checkout
(`normal_clustering_nerf_torch.bench`) and trains STEPS steps through
`Trainer.fit` (512 bootstrap steps and 64 after; the refreshes from step
256 are sampled, and a checkout that replays the refresh as a CUDA graph
has captured it). Then:
- it captures the arguments of `normals_clustering` in the next sv step
  (`ops.loss_block.normals_clustering`, or `losses.normals_clustering`
  in a checkout without K10) and times `ops.kmeans.normals_clustering`
  on them: the mean of 20 replays of a CUDA graph of one call
  (`time_encodes.device_ms`);
- it times `normals_clustering` at rotation recovery's shape (M 65,536
  room normals made from a seed, K 30, 30 rounds:
  `training/rotation_recovery.py`), and the floor of K7's rounds: one
  call on 8 rows at K 1 with 20 rounds less one with none, over 20;
- it times a sampled refresh, `Trainer.occ_update(warmup=False)`: the
  host's time to queue one (the median of REPS), and the card's (REPS
  refreshes queued behind a sleep, by CUDA events);
- it times K8's three launchers on that refresh's inputs at the trained
  grid (`models/occupancy.py`): `occ_compact` on the density grid,
  `occ_merge_pack` on the grid and a sampled refresh's sigma grid
  (`chip_smoke.refresh_tmp`), `occ_tables` on the bitfield that pack
  writes, each with `device_ms`; the first two at 2 cascades, the
  trained grid and its sigma grid twice; and `occ_union` on 2 and 4
  ranks' bitfields where the checkout has it (`k8_times`);
- it traces (torch.profiler) a chunk of 16 graph steps
  (`train_chunk(16)`): the card's busy ms a step, split as the bench's
  profile splits it, and its launches a step; and a window of a refresh
  and its chunk (`fit(16)` from a boundary): host ms a step (the median
  of 3 windows, each ended by a synchronize), busy ms a step from a traced
  window, and the idle share 1 - busy / host.
Each part starts from the state the one before left. Prints the card's
name and power limit, then one JSON line.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from chip_smoke import refresh_tmp
from time_encodes import device_ms

STEPS = 576    # the smoke's main path: 512 bootstrap steps, 64 sv steps
REPS = 8       # refreshes a timing
CHUNK = 16     # the steps between two refreshes


def room_normals(M, gen):
    """Unit normals of a rotated box room with noise, a fifth invalid (zero
    rows, as the loss hands them in), and the valid mask."""
    q, _ = torch.linalg.qr(torch.randn(3, 3, generator=gen, device="cuda"))
    axes = torch.cat([q, -q])
    pick = torch.randint(0, 6, (M,), generator=gen, device="cuda")
    n = axes[pick] + 0.05 * torch.randn(M, 3, generator=gen, device="cuda")
    n = torch.nn.functional.normalize(n, dim=-1)
    valid = torch.rand(M, generator=gen, device="cuda") < 0.8
    return torch.where(valid[:, None], n, 0.0).contiguous(), valid


def traced(fn):
    """The card's events of `fn()` under torch.profiler (possibly none)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as p:
        fn()
        torch.cuda.synchronize()
    return [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]


def refresh_ms(tr):
    """(host ms to queue a sampled refresh, the median of REPS; the card's
    ms a refresh, REPS queued behind a sleep)."""
    host = []
    for _ in range(REPS):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.occ_update(warmup=False)
        host.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(int((2 * max(host) * REPS + 1e-3) * 2.0e9))
    start.record()
    for _ in range(REPS):
        tr.occ_update(warmup=False)
    end.record()
    torch.cuda.synchronize()
    return sorted(host)[REPS // 2] * 1e3, start.elapsed_time(end) / REPS


def k8_times(occupancy, grid, tmp, thr, G):
    """Device ms of K8's launchers on (1, G^3) inputs: occ_compact,
    occ_merge_pack and occ_tables (on the bitfield the pack writes) at one
    cascade, occ_compact and occ_merge_pack at two (the inputs twice), and
    where the checkout has it occ_union on 2 and 4 ranks' bitfields (that
    bitfield and the ones packed from the grid and sigma grids shifted by
    a cell)."""
    bits = occupancy.occ_merge_pack(grid, tmp, 0.95, thr)[1]
    grid2, tmp2 = torch.cat([grid, grid]), torch.cat([tmp, tmp])
    out = {
        "G": G, "occupied": int((grid > thr).sum()),
        "occ_compact_ms": device_ms(lambda: occupancy.occ_compact(grid, thr)),
        "occ_merge_pack_ms": device_ms(
            lambda: occupancy.occ_merge_pack(grid, tmp, 0.95, thr)),
        "occ_tables_ms": device_ms(lambda: occupancy.occ_tables(bits, G)),
        "occ_compact_ms_2_cascades": device_ms(
            lambda: occupancy.occ_compact(grid2, thr)),
        "occ_merge_pack_ms_2_cascades": device_ms(
            lambda: occupancy.occ_merge_pack(grid2, tmp2, 0.95, thr))}
    if hasattr(occupancy, "occ_union"):
        ranks = torch.stack([bits] + [occupancy.occ_merge_pack(
            grid.roll(r, 1), tmp.roll(r, 1), 0.95, thr)[1] for r in (1, 2, 3)])
        for world in (2, 4):
            rows = ranks[:world].contiguous()
            out[f"occ_union_ms_{world}_ranks"] = device_ms(
                lambda rows=rows: occupancy.occ_union(rows))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose package is timed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_k7k8: CUDA is not available", file=sys.stderr)
        sys.exit(1)
    sys.path.insert(0, os.path.abspath(args.root))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available", flush=True)
    t0 = time.perf_counter()
    import normal_clustering_nerf_torch as package
    from normal_clustering_nerf_torch import losses
    from normal_clustering_nerf_torch.bench import (bench_config,
                                                    build_trainer,
                                                    split_device_time)
    from normal_clustering_nerf_torch.models import occupancy
    from normal_clustering_nerf_torch.ops import kmeans
    torch.backends.cuda.matmul.allow_tf32 = False
    tr = build_trainer(bench_config(), device="cuda")
    tr.mark_invisible_cells()
    tr.fit(STEPS)
    out = {"package": os.path.dirname(package.__file__)}

    try:   # K10's forward calls the clustering
        from normal_clustering_nerf_torch.ops import loss_block as owner
    except ImportError:   # a checkout before K10: the loss calls it
        owner = losses
    fn, seen = owner.normals_clustering, []

    def spy(*a, **kw):
        seen.append((a, kw))
        return fn(*a, **kw)
    owner.normals_clustering = spy
    try:
        tr.train_step_core(bootstrap=False)
    finally:
        owner.normals_clustering = fn
    a, kw = seen[0]
    # the initial rows drawn once: a graph of the call would not hold the
    # trainer's generator
    kw = dict(kw, init_idx=kmeans.draw_init(a[1], kw["K"], kw["generator"]),
              generator=None)
    out["normals_clustering"] = {
        "M": a[0].shape[0], "K": kw["K"], "niter": kw["niter"],
        "ms": device_ms(lambda: kmeans.normals_clustering(*a, **kw))}
    gen = torch.Generator(device="cuda").manual_seed(0)
    n, v = room_normals(65536, gen)
    rot = dict(K=30, niter=30, init_idx=kmeans.draw_init(v, 30, gen))
    out["rotation recovery"] = {
        "M": 65536, "K": 30, "niter": 30,
        "ms": device_ms(lambda: kmeans.normals_clustering(n, v, **rot))}
    n8, v8 = room_normals(8, gen)
    v8[:] = True
    one = dict(K=1, init_idx=kmeans.draw_init(v8, 1, gen))
    t0, t20 = (device_ms(lambda: kmeans.normals_clustering(
        n8, v8, niter=r, **one)) for r in (0, 20))
    out["round floor"] = {"M": 8, "K": 1, "ms_0_rounds": t0,
                          "ms_20_rounds": t20, "ms_a_round": (t20 - t0) / 20}

    # the next boundary, then the refresh's times
    tr.fit(-tr.step % CHUNK)
    host, dev = refresh_ms(tr)
    out["sampled refresh"] = {"host_ms": host, "device_ms": dev}
    out["K8 launchers"] = k8_times(occupancy, tr.occ.density_grid,
                                   refresh_tmp(tr, gen),
                                   tr.density_threshold(), tr.occ_grid.G)

    ev = traced(lambda: tr.train_chunk(CHUNK, False))
    split, launches = split_device_time(ev, CHUNK) if ev else ({}, 0)
    out["graph step"] = {"busy_ms": sum(split.values()), "split": split,
                         "launches": launches}

    tr.fit(-tr.step % CHUNK)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        tr.fit(CHUNK)
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t) * 1e3 / CHUNK)
    ev = traced(lambda: tr.fit(CHUNK))
    split, launches = split_device_time(ev, CHUNK) if ev else ({}, 0)
    busy = sum(split.values())
    host_ms = sorted(host)[1]
    out["refresh window"] = {"host_ms": host_ms, "busy_ms": busy,
                             "idle": 1 - busy / host_ms if ev else None,
                             "launches": launches, "split": split}
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
