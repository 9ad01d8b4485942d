"""Multi-scene sweep of the port: the repository's
`experiments/run_sweep.py` on the port's CLI.

    python -m normal_clustering_nerf_torch.experiments.run_sweep \
        --dataset hypersim --data_root DATA --log_root LOGS \
        [--method ours|baseline] [--epochs 30] [--scenes S ...] \
        [--num_hosts H --host_id I] [--rerun_failed] [--dry_run] \
        [--extra FLAG ...]

Runs `python -m normal_clustering_nerf_torch.train_nerf` once a scene
(every directory under `--data_root`, or `--scenes`), one after another,
with the dataset's published preset (`hyperparameters.PRESETS`) and the
`--extra` flags; with `--num_hosts H --host_id I` this host takes every
H-th scene from the I-th. A scene without `<log_root>/<scene>/results.csv`
after its run counts as failed; `--rerun_failed` runs only the scenes
without one. `--dry_run` prints each command and runs none. Run it from
the repository root, where the CLI's package is importable. Exits 1 if
any scene failed.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

from .hyperparameters import PRESETS

CLI = "normal_clustering_nerf_torch.train_nerf"


def list_scenes(data_root: str):
    return sorted(
        d for d in os.listdir(data_root)
        if os.path.isdir(os.path.join(data_root, d))
    )


def scene_done(log_root: str, scene: str) -> bool:
    return os.path.isfile(os.path.join(log_root, scene, "results.csv"))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", required=True, choices=list(PRESETS))
    p.add_argument("--data_root", required=True)
    p.add_argument("--log_root", required=True)
    p.add_argument("--method", default="ours", choices=["ours", "baseline"])
    p.add_argument("--epochs", type=int, default=30)
    p.add_argument("--scenes", nargs="*", default=None,
                   help="subset of scene dirs (default: all)")
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--host_id", type=int, default=0)
    p.add_argument("--rerun_failed", action="store_true")
    p.add_argument("--dry_run", action="store_true")
    p.add_argument("--extra", nargs="*", default=[],
                   help="extra flags forwarded to the CLI")
    args = p.parse_args(argv)

    scenes = args.scenes or list_scenes(args.data_root)
    scenes = scenes[args.host_id::args.num_hosts]
    preset = PRESETS[args.dataset](ours=args.method == "ours",
                                   epochs=args.epochs)

    failed = []
    for scene in scenes:
        if args.rerun_failed and scene_done(args.log_root, scene):
            continue
        cmd = [
            sys.executable, "-m", CLI,
            f"--data_root_dir={os.path.join(args.data_root, scene)}",
            f"--log_root_dir={args.log_root}",
            f"--exp_name={scene}",
        ] + preset + list(args.extra)
        print("[sweep]", " ".join(cmd), flush=True)
        if args.dry_run:
            continue
        rc = subprocess.call(cmd)
        if rc != 0 or not scene_done(args.log_root, scene):
            failed.append(scene)
            print(f"[sweep] FAILED: {scene} (rc={rc})", flush=True)

    print(f"[sweep] done: {len(scenes) - len(failed)} ok, "
          f"{len(failed)} failed: {failed}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
