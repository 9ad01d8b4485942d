"""Normal angular-error metrics in degrees: mean and median, and their
sign-flip-minimum variants, over valid pixels
(reference: metrics/normals_metrics.py:7-75)."""
import numpy as np


def normal_angular_error(pred, gt, flip_min=False):
    """Angular error between normal maps pred, gt (..., 3); pixels with
    |gt| == 0 are invalid. flip_min: per-pixel minimum over the sign of
    pred (the reference's *_min variants). Returns mean_deg, median_deg."""
    pred = np.asarray(pred, np.float64).reshape(-1, 3)
    gt = np.asarray(gt, np.float64).reshape(-1, 3)
    valid = np.abs(gt).sum(-1) > 0
    pred, gt = pred[valid], gt[valid]
    if pred.size == 0:
        return {"mean_deg": float("nan"), "median_deg": float("nan")}
    pn = pred / np.maximum(np.linalg.norm(pred, axis=-1, keepdims=True), 1e-12)
    gn = gt / np.maximum(np.linalg.norm(gt, axis=-1, keepdims=True), 1e-12)
    cos = np.clip((pn * gn).sum(-1), -1.0, 1.0)
    ang = np.degrees(np.arccos(cos))
    if flip_min:
        ang = np.minimum(ang, 180.0 - ang)
    return {"mean_deg": float(ang.mean()), "median_deg": float(np.median(ang))}
