"""Ray-batch sampling on the training device.

Port of the JAX package's `datasets/sampler.py` for the triangle
strategies (reference: datasets/base.py:15-33,102-140): a batch is
batch//3 right-angle pixel triangles (x1 corner, x2 above, x3 left),
optionally dilated by `max_expand` pixels. The patch strategies and
random unseen poses are not ported yet (ROADMAP A8).

The random draws (image and triangle indices) are separable: `sample`
takes them as `draws`, so a test can hand in the JAX package's draws.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import as_index, resolve_device

TRIANG_STRATEGIES = ("all_images_triang", "same_image_triang",
                     "all_images_triang_val")


class TriangTables(NamedTuple):
    x1: np.ndarray
    x2: np.ndarray
    x3: np.ndarray


def build_triang_tables(h: int, w: int) -> TriangTables:
    """Valid triangle-corner index maps (reference: base.py:15-33)."""
    img = np.arange(h * w, dtype=np.int32).reshape(h, w)
    return TriangTables(
        x1=np.ascontiguousarray(img[1:-1, 1:-1].reshape(-1)),
        x2=np.ascontiguousarray(img[:-2, 1:-1].reshape(-1)),
        x3=np.ascontiguousarray(img[1:-1, :-2].reshape(-1)),
    )


class RaySampler:
    """Triangle-batch sampler; tables live on `device` (None: the card;
    the CPU only when asked for, as `device.resolve_device` rules)."""

    def __init__(self, strategy: str, batch_size: int, img_wh,
                 n_images: int, *, max_expand: int = 0,
                 device=None):
        if strategy not in TRIANG_STRATEGIES:
            raise NotImplementedError(
                f"ray_sampling_strategy {strategy!r} is not ported yet "
                f"(ROADMAP A8); the port samples {TRIANG_STRATEGIES}")
        self.strategy = strategy
        self.batch_size = batch_size
        self.W, self.H = img_wh
        self.N = self.W * self.H
        self.n_images = n_images
        self.max_expand = max_expand
        self.device = device = resolve_device(device)
        t = build_triang_tables(self.H, self.W)
        self.triang = TriangTables(*(torch.as_tensor(a, dtype=torch.int64,
                                                     device=device)
                                     for a in t))
        self.n_triang = batch_size // 3

    def draw(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The batch's random draws: image index and triangle index of
        each triangle (one image for all under `same_image_*`)."""
        n = self.n_triang
        n_img = 1 if self.strategy.startswith("same") else n
        kw = dict(generator=generator, device=self.device)
        return {
            "img": torch.randint(0, self.n_images, (n_img,), **kw),
            "tri": torch.randint(0, self.triang.x1.shape[0], (n,), **kw),
        }

    def sample(self, generator: Optional[torch.Generator] = None,
               draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One batch of {img_idxs, pix_idxs}, triangles interleaved
        (x1, x2, x3 of triangle 0, then of triangle 1, ...)."""
        d = draws if draws is not None else self.draw(generator)
        n = self.n_triang
        img, tri = as_index(d["img"], self.device), as_index(d["tri"],
                                                             self.device)
        img = img.expand(n) if img.numel() == 1 else img
        x1 = self.triang.x1[tri]
        x2 = self.triang.x2[tri]
        x3 = self.triang.x3[tri]
        if self.max_expand > 0:
            # dilate the unit triangle (reference: base.py:128-138)
            e, W = self.max_expand, self.W
            x1n = x1 + e * W
            x1 = torch.where(x1n < self.N, x1n, x1)
            x2n = x2 - e * W
            x2 = torch.where(x2n >= 0, x2n, x2)
            x3n = x3 - e
            x3 = torch.where(torch.div(x3n, W, rounding_mode="floor")
                             == torch.div(x3, W, rounding_mode="floor"),
                             x3n, x3)
        return {
            "img_idxs": img.repeat_interleave(3),
            "pix_idxs": torch.stack([x1, x2, x3], dim=1).reshape(-1),
        }
