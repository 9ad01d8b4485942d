"""LPIPS (VGG-16 variant) of the port — the JAX package's
`metrics/lpips.py` (reference: metrics/rgb_metrics.py:124-162, which
computes it through torchmetrics). The computation follows the official
`lpips` package (richzhang/PerceptualSimilarity, v0.1 'vgg' net):

  1. scale inputs from [0, 1] to [-1, 1];
  2. per-channel affine normalisation (x - shift) / scale with the
     package's constants;
  3. VGG-16 feature maps after relu1_2, relu2_2, relu3_3, relu4_3,
     relu5_3 (2x2 max pooling between blocks);
  4. unit-normalise each feature map over channels;
  5. squared difference, 1x1 non-negative linear head per layer, spatial
     mean, sum over layers.

The public functions keep the JAX layout (images and feature maps NHWC);
the convolutions run as `F.conv2d` on NCHW with OIHW weights
(`convert.lpips_params` converts the npz's HWIO arrays), in full f32
also on the card: cuDNN's TF32 is turned off around them.

Weights: the npz of the JAX package (no pretrained file is in the
repository: weights/README.md). Weight file resolution order:
  1. explicit `weights` argument,
  2. $NCNERF_LPIPS_WEIGHTS,
  3. <repo>/weights/lpips_vgg.npz.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..convert import lpips_params

# lpips package scaling layer constants (lpips/lpips.py ScalingLayer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# VGG-16 conv plan: (name, out_channels); 'M' = 2x2/2 maxpool.
# Taps (the lpips feature layers) come after the relu of the marked convs.
_VGG_PLAN = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
]
_TAPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")
_LIN_CHANNELS = (64, 128, 256, 512, 512)


def vgg16_features(params: Dict[str, torch.Tensor], x: torch.Tensor
                   ) -> List[torch.Tensor]:
    """Feature maps at the five LPIPS tap points.

    params: {'<conv>_w': (out, in, 3, 3), '<conv>_b': (out,)}
    (`convert.lpips_params`); x: (N, H, W, 3) in [-1, 1] after the lpips
    input scaling. Returns five (N, h, w, c) tensors."""
    dev = x.device
    shift, scale = (torch.as_tensor(a, device=dev) for a in (_SHIFT, _SCALE))
    h = ((x - shift) / scale).permute(0, 3, 1, 2)
    feats = []
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for item in _VGG_PLAN:
            if item == "M":
                h = F.max_pool2d(h, 2, 2)
                continue
            name, _ = item
            h = F.relu(F.conv2d(h, params[f"{name}_w"], params[f"{name}_b"],
                                padding=1))
            if name in _TAPS:
                feats.append(h.permute(0, 2, 3, 1))
    return feats


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    return f / torch.sqrt(torch.sum(f * f, dim=-1, keepdim=True) + eps)


def _lpips_pair(params, lins, a: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """LPIPS of image batches a, b ((N, H, W, 3) in [-1, 1]): (N,)."""
    fa = vgg16_features(params, a)
    fb = vgg16_features(params, b)
    total = 0.0
    for i, (x, y) in enumerate(zip(fa, fb)):
        d = (_unit_normalize(x) - _unit_normalize(y)) ** 2
        # 1x1 non-negative linear head == channel-weighted sum
        total = total + torch.mean(torch.sum(d * lins[i], dim=-1),
                                   dim=(1, 2))
    return total


class LPIPS:
    """Callable LPIPS metric on `device` (None: the card, as the port's
    entry points). Images are (H, W, 3) float in [0, 1]."""

    def __init__(self, params: Dict[str, np.ndarray],
                 lins: Optional[list] = None, device=None):
        from ..device import resolve_device
        self.device = resolve_device(device)
        if lins is not None:
            params = {**params, **{f"lin{i}": l for i, l in enumerate(lins)}}
        p = lpips_params(params, self.device)
        self.params = {k: v for k, v in p.items() if not k.startswith("lin")}
        self.lins = [p[f"lin{i}"] for i in range(5)]
        for i, l in enumerate(self.lins):
            if l.shape[0] != _LIN_CHANNELS[i]:
                raise ValueError(
                    f"lin{i} has {l.shape[0]} channels, expected "
                    f"{_LIN_CHANNELS[i]}")

    @torch.no_grad()
    def __call__(self, img0, img1) -> float:
        def batch(img):
            t = torch.as_tensor(np.asarray(img, np.float32),
                                device=self.device)
            return t[None] * 2.0 - 1.0
        return float(_lpips_pair(self.params, self.lins, batch(img0),
                                 batch(img1))[0])


def default_weights_path() -> str:
    env = os.environ.get("NCNERF_LPIPS_WEIGHTS")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, "weights", "lpips_vgg.npz")


def load_lpips(weights: Optional[str] = None, device=None) -> Optional[LPIPS]:
    """LPIPS instance from an npz weight file, or None if unavailable."""
    path = weights or default_weights_path()
    if not os.path.exists(path):
        return None
    data = np.load(path)
    params = {k: data[k] for k in data.files if not k.startswith("lin")}
    lins = [data[f"lin{i}"] for i in range(5)]
    return LPIPS(params, lins, device)


def random_weights(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random VGG+lin weights in the npz's layout (for graph parity tests
    only): the JAX package's draws, array for array."""
    rng = np.random.default_rng(seed)
    params: Dict[str, np.ndarray] = {}
    cin = 3
    for item in _VGG_PLAN:
        if item == "M":
            continue
        name, cout = item
        params[f"{name}_w"] = rng.standard_normal(
            (3, 3, cin, cout)).astype(np.float32) * (1.0 / np.sqrt(9 * cin))
        params[f"{name}_b"] = rng.standard_normal(cout).astype(np.float32) * 0.1
        cin = cout
    for i, c in enumerate(_LIN_CHANNELS):
        params[f"lin{i}"] = rng.uniform(0, 1, c).astype(np.float32)
    return params
