"""Per-image metric aggregator (reference: metrics/metrics.py:14-120):
accumulates the metrics of each test image and reduces them to the
metric keys of the results (train_nerf.py:685-704). LPIPS is optional and
gated on its weight file, as in the JAX package: without one it warns
and leaves the column out."""
from __future__ import annotations

import warnings
from collections import defaultdict
from typing import Dict

import numpy as np

from .depth import depth_abs_err, depth_rmse
from .normals import normal_angular_error
from .rgb import psnr, ssim_gaussian, ssim_norm, ssim_norm_scikit
from .semantic import confusion_matrix, miou_from_confusion


class NeRFMTMetricsPerIm:
    def __init__(self, *, pred_norm_nn=False, pred_norm_depth=False,
                 pred_sem=False, load_depth_gt=False, load_norm_gt=False,
                 load_sem_gt=False, load_sem_WF_gt=False,
                 eval_lpips=False, n_classes=0, device=None):
        """`device`: where LPIPS runs (None: the card)."""
        self.pred_norm_nn = pred_norm_nn
        self.pred_norm_depth = pred_norm_depth
        self.pred_sem = pred_sem
        self.load_depth_gt = load_depth_gt
        self.load_norm_gt = load_norm_gt
        self.load_sem_gt = load_sem_gt or load_sem_WF_gt
        self.n_classes = n_classes
        self.eval_lpips = eval_lpips
        self._lpips = self._try_lpips(device) if eval_lpips else None
        self.reset()

    @staticmethod
    def _try_lpips(device):
        """VGG-LPIPS (metrics/lpips.py) from the weight file, or None with
        a warning (metrics.py:40-55 of the JAX package)."""
        from .lpips import default_weights_path, load_lpips
        m = load_lpips(device=device)
        if m is None:
            warnings.warn(
                "eval_lpips=True but no LPIPS weight file was found at "
                f"{default_weights_path()}; the 'lpips' column will be "
                "missing from results. The npz is a download "
                "(weights/README.md).", RuntimeWarning, stacklevel=3)
        return m

    def reset(self):
        self.vals = defaultdict(list)
        self.cm = (
            np.zeros((self.n_classes, self.n_classes), np.int64)
            if self.pred_sem and self.load_sem_gt else None
        )

    def update(self, pred: Dict, gt: Dict):
        """Accumulate one test image; values are (H, W, C) / (H, W) numpy."""
        self.vals["psnr"].append(psnr(pred["rgb"], gt["rgb"]))
        self.vals["ssim"].append(ssim_gaussian(pred["rgb"], gt["rgb"]))
        self.vals["ssim_norm"].append(ssim_norm(pred["rgb"], gt["rgb"]))
        self.vals["ssim_norm_scikit"].append(
            ssim_norm_scikit(pred["rgb"], gt["rgb"]))
        if self._lpips is not None:
            self.vals["lpips"].append(self._lpips(
                np.clip(np.asarray(pred["rgb"], np.float32), 0, 1),
                np.clip(np.asarray(gt["rgb"], np.float32), 0, 1)))

        if self.load_depth_gt and "depth" in gt and "depth" in pred:
            self.vals["depth_rmse"].append(depth_rmse(pred["depth"], gt["depth"]))
            self.vals["depth_abs"].append(depth_abs_err(pred["depth"], gt["depth"]))

        if self.load_norm_gt and "normals" in gt:
            for key in ("norm_nn", "norm_depth"):
                if key in pred:
                    e = normal_angular_error(pred[key], gt["normals"])
                    em = normal_angular_error(pred[key], gt["normals"],
                                              flip_min=True)
                    self.vals[f"{key}_ang_mean"].append(e["mean_deg"])
                    self.vals[f"{key}_ang_median"].append(e["median_deg"])
                    self.vals[f"{key}_ang_mean_min"].append(em["mean_deg"])
                    self.vals[f"{key}_ang_median_min"].append(em["median_deg"])

        if self.cm is not None and "sem" in pred:
            sem_key = "semantics" if "semantics" in gt else "semantics_WF"
            pred_cls = np.asarray(pred["sem"]).argmax(-1) + 1
            self.cm += confusion_matrix(pred_cls, gt[sem_key], self.n_classes)

    def compute(self) -> Dict[str, float]:
        out = {}
        for k, v in self.vals.items():
            arr = np.asarray(v, np.float64)
            out[k] = float(np.nanmean(arr)) if arr.size else float("nan")
        if self.cm is not None:
            out.update(miou_from_confusion(self.cm))
        return out
