"""results.csv and run bookkeeping (the port's copy of the JAX package's
`training/results.py`).

The reference's single-row results file with metric/, info/ and param/
namespaced columns (reference: train_nerf.py:678-704), read by the
experiments layer (experiments/extract_results.py), and the `.done`
marker of batch failure accounting (train_nerf.py:803-805).
"""
from __future__ import annotations

import csv
import dataclasses
import json
import os
from typing import Dict


def _flatten_cfg(cfg, prefix="param/") -> Dict[str, object]:
    out = {}
    for f in dataclasses.fields(cfg):
        v = getattr(cfg, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_flatten_cfg(v, prefix=f"{prefix}{f.name}."))
        elif isinstance(v, (int, float, str, bool)) or v is None:
            out[f"{prefix}{f.name}"] = v
    return out


def save_results_csv(path: str, metrics: Dict[str, float], cfg,
                     info: Dict[str, object] | None = None):
    row = {f"metric/{k}": v for k, v in metrics.items()}
    row.update({f"info/{k}": v for k, v in (info or {}).items()})
    row.update(_flatten_cfg(cfg))
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row.keys()))
        w.writeheader()
        w.writerow(row)
    return path


def write_done_marker(dir_path: str, name: str = "run"):
    """`.done` marker after artifact writes (train_nerf.py:803-805)."""
    p = os.path.join(dir_path, f"{name}.done")
    with open(p, "w") as f:
        f.write("done\n")
    return p


def save_run_summary(path: str, metrics: Dict[str, float]):
    with open(path, "w") as f:
        json.dump(metrics, f, indent=2)
