"""Depth metrics on valid (gt > 0) pixels
(reference: metrics/depth_metrics.py:6-65)."""
import numpy as np


def _valid(pred, gt):
    pred = np.asarray(pred).reshape(-1)
    gt = np.asarray(gt).reshape(-1)
    m = gt > 0
    return pred[m], gt[m]


def depth_rmse(pred, gt):
    p, g = _valid(pred, gt)
    if p.size == 0:
        return float("nan")
    return float(np.sqrt(np.mean((p - g) ** 2)))


def depth_abs_err(pred, gt):
    p, g = _valid(pred, gt)
    if p.size == 0:
        return float("nan")
    return float(np.mean(np.abs(p - g)))
