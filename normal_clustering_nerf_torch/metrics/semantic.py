"""Semantic segmentation metrics via a confusion matrix
(reference: metrics/semantic_metrics.py:6-66). Labels use the dataset
convention: void = 0 is ignored, classes are 1..n_cls."""
import numpy as np


def confusion_matrix(pred_cls, gt_cls, n_cls):
    """pred_cls: predicted class ids in 1..n_cls (e.g. argmax + 1);
    gt_cls: ground truth with void = 0."""
    pred = np.asarray(pred_cls).reshape(-1)
    gt = np.asarray(gt_cls).reshape(-1)
    m = gt > 0
    pred, gt = pred[m] - 1, gt[m] - 1
    cm = np.zeros((n_cls, n_cls), np.int64)
    np.add.at(cm, (gt, pred), 1)
    return cm


def miou_from_confusion(cm):
    inter = np.diag(cm).astype(np.float64)
    union = cm.sum(0) + cm.sum(1) - np.diag(cm)
    present = cm.sum(1) > 0
    iou = np.where(union > 0, inter / np.maximum(union, 1), np.nan)
    miou = float(np.nanmean(np.where(present, iou, np.nan)))
    acc = float(inter.sum() / max(cm.sum(), 1))
    return {"miou": miou, "accuracy": acc}
