"""RGB metrics: PSNR and the reference's three SSIM variants
(reference: metrics/rgb_metrics.py:13-162, which wraps torchmetrics and
scikit-image; the formulas are written out here):

  * ssim_gaussian    — gaussian window, data_range 1 (SSIMPerImg);
  * ssim_norm        — gaussian window, per-image data_range
                       gt.max() - gt.min() (SSIMPerImgNorm);
  * ssim_norm_scikit — scikit's uniform 7x7 window, per-image range
                       (SSIMPerImgNormSckit).
"""
from __future__ import annotations

import numpy as np
from scipy.ndimage import uniform_filter


def psnr(pred, gt, data_range=1.0):
    """Peak signal-to-noise ratio in f32 (train_nerf.py:162)."""
    d = np.asarray(pred, np.float32) - np.asarray(gt, np.float32)
    mse = np.mean(d * d, dtype=np.float32)
    return float(np.float32(10.0) * np.log10(
        np.float32(data_range ** 2) / np.maximum(mse, np.float32(1e-12))))


def _gaussian_kernel1d(size=11, sigma=1.5):
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2.0
    k = np.exp(-(x ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


def _gaussian_filter2d(img, size=11, sigma=1.5):
    """Separable 'valid' gaussian filter of an (H, W) image."""
    k = _gaussian_kernel1d(size, sigma)
    out = np.apply_along_axis(
        lambda r: np.convolve(r, k, mode="valid"), 1, img)
    return np.apply_along_axis(
        lambda c: np.convolve(c, k, mode="valid"), 0, out)


def ssim_gaussian(pred, gt, data_range=1.0, size=11, sigma=1.5,
                  K1=0.01, K2=0.03):
    """SSIM with a gaussian window and population covariance (the
    torchmetrics StructuralSimilarityIndexMeasure formulation).
    pred, gt: (H, W, C) or (H, W)."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        f = lambda z: _gaussian_filter2d(z, size, sigma)  # noqa: E731
        ux, uy = f(x), f(y)
        vx = f(x * x) - ux * ux
        vy = f(y * y) - uy * uy
        vxy = f(x * y) - ux * uy
        S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
            (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))
        vals.append(S.mean())
    return float(np.mean(vals))


def ssim_norm(pred, gt):
    """Gaussian-window SSIM with data_range = gt.max() - gt.min()."""
    gt_a = np.asarray(gt, np.float64)
    rng = float(gt_a.max() - gt_a.min())
    return ssim_gaussian(pred, gt, data_range=max(rng, 1e-12))


def ssim_norm_scikit(pred, gt):
    """Uniform-window SSIM with data_range = gt.max() - gt.min()."""
    gt_a = np.asarray(gt, np.float64)
    rng = float(gt_a.max() - gt_a.min())
    return ssim(pred, gt, data_range=max(rng, 1e-12))


def ssim(pred, gt, data_range=1.0, win_size=7, K1=0.01, K2=0.03):
    """Structural similarity with scikit-image's uniform window and sample
    covariance (gaussian_weights=False). pred, gt: (H, W, C) in
    [0, data_range]."""
    pred = np.asarray(pred, np.float64)
    gt = np.asarray(gt, np.float64)
    if pred.ndim == 2:
        pred, gt = pred[..., None], gt[..., None]
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)
    vals = []
    for c in range(pred.shape[-1]):
        x, y = pred[..., c], gt[..., c]
        ux = uniform_filter(x, win_size)
        uy = uniform_filter(y, win_size)
        uxx = uniform_filter(x * x, win_size)
        uyy = uniform_filter(y * y, win_size)
        uxy = uniform_filter(x * y, win_size)
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)
        A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
        B1, B2 = ux ** 2 + uy ** 2 + C1, vx + vy + C2
        S = (A1 * A2) / (B1 * B2)
        pad = (win_size - 1) // 2
        vals.append(S[pad:-pad, pad:-pad].mean())
    return float(np.mean(vals))
