"""Ray-batch sampling on the training device.

Port of the JAX package's `datasets/sampler.py` (reference:
datasets/base.py:15-182), every strategy:
  all_images / same_image    independent random pixels;
  *_triang                   batch//3 right-angle pixel triangles (x1
                             corner, x2 above, x3 left), optionally
                             dilated by `max_expand` pixels;
  *_triang_patch             batch//p^2 p x p patches; the loss takes
                             all (p-1)^2 triangles inside each patch
                             (`patch_area`, `offsets_local`).
With `n_random_poses` the triangle and patch strategies sample half the
groups, and draw a random unseen pose for each group of the other half
("rnd_img_idxs"; the trainer renders those rays from the random poses).

The random draws are separable: `draw` returns every index the batch
needs and `sample` takes them as `draws`, so a test can hand in the JAX
package's draws (`jax.random.split(key, 3)`: images, pixels / triangles /
corners, random poses).
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from ..device import as_index, resolve_device

TRIANG_STRATEGIES = ("all_images_triang", "same_image_triang",
                     "all_images_triang_val")
PATCH_STRATEGIES = ("all_images_triang_patch", "same_image_triang_patch")
PIXEL_STRATEGIES = ("all_images", "same_image")


class TriangTables(NamedTuple):
    x1: np.ndarray
    x2: np.ndarray
    x3: np.ndarray


class PatchTables(NamedTuple):
    corners: np.ndarray           # valid upper-left pixel indices
    offsets: np.ndarray           # (p^2,) flat offsets inside a patch
    x1_local: np.ndarray          # ((p-1)^2,) local triangle corners
    x2_local: np.ndarray
    x3_local: np.ndarray


def build_triang_tables(h: int, w: int) -> TriangTables:
    """Valid triangle-corner index maps (reference: base.py:15-33)."""
    img = np.arange(h * w, dtype=np.int32).reshape(h, w)
    return TriangTables(
        x1=np.ascontiguousarray(img[1:-1, 1:-1].reshape(-1)),
        x2=np.ascontiguousarray(img[:-2, 1:-1].reshape(-1)),
        x3=np.ascontiguousarray(img[1:-1, :-2].reshape(-1)),
    )


def build_patch_tables(h: int, w: int, patch_size: int = 8) -> PatchTables:
    """Patch corner/offset tables (reference: base.py:35-66)."""
    img = np.arange(h * w, dtype=np.int32).reshape(h, w)
    p = patch_size
    local = np.arange(p * p, dtype=np.int32).reshape(p, p)
    return PatchTables(
        corners=np.ascontiguousarray(img[: h - p + 1, : w - p + 1].reshape(-1)),
        offsets=np.ascontiguousarray(img[:p, :p].reshape(-1)),
        x1_local=np.ascontiguousarray(local[1:, 1:].reshape(-1)),
        x2_local=np.ascontiguousarray(local[:-1, 1:].reshape(-1)),
        x3_local=np.ascontiguousarray(local[1:, :-1].reshape(-1)),
    )


class RaySampler:
    """Strategy-dispatching batch sampler; its tables live on `device`
    (None: the card; the CPU only when asked for, as
    `device.resolve_device` rules)."""

    def __init__(self, strategy: str, batch_size: int, img_wh,
                 n_images: int, *, max_expand: int = 0, patch_size: int = 8,
                 n_random_poses: int = 0, device=None):
        if strategy not in TRIANG_STRATEGIES + PATCH_STRATEGIES \
                + PIXEL_STRATEGIES:
            raise NotImplementedError(strategy)
        if n_random_poses and strategy in PIXEL_STRATEGIES:
            # the JAX sampler draws no random poses for these, and its
            # trainer then fails on the missing rnd_img_idxs
            raise ValueError(f"random poses need a triangle or patch "
                             f"strategy, got {strategy!r}")
        self.strategy = strategy
        self.same = strategy.startswith("same")
        self.batch_size = batch_size
        self.W, self.H = img_wh
        self.N = self.W * self.H
        self.n_images = n_images
        self.max_expand = max_expand
        self.patch_size = patch_size
        self.n_random_poses = n_random_poses
        self.device = device = resolve_device(device)

        def on_dev(tables):
            return type(tables)(*(torch.as_tensor(a, dtype=torch.int64,
                                                  device=device)
                                  for a in tables))
        self.triang = self.patch = self._offsets_local = None
        if strategy in TRIANG_STRATEGIES:
            self.triang = on_dev(build_triang_tables(self.H, self.W))
            self.group, n_groups = 3, batch_size // 3
        elif strategy in PATCH_STRATEGIES:
            tables = build_patch_tables(self.H, self.W, patch_size)
            self.patch = on_dev(tables)
            # kept on the host: the loss reads them in a captured step
            self._offsets_local = {k: getattr(tables, f"{k}_local")
                                   for k in ("x1", "x2", "x3")}
            self.group = patch_size ** 2
            n_groups = batch_size // self.group
        else:
            self.group, n_groups = 1, batch_size
        if n_random_poses > 0:
            n_groups //= 2
        self.n_groups = n_groups

    def draw(self, generator: torch.Generator) -> Dict[str, torch.Tensor]:
        """The batch's random draws: "img", the image of each group (one
        image for all under `same_image*`); "pix", "tri" or "corner", the
        pixel, triangle or patch corner of each group; with random poses,
        "rnd", the random pose of each group of the other half (one for
        all under `same_image*`)."""
        n, n_one = self.n_groups, 1 if self.same else self.n_groups
        kw = dict(generator=generator, device=self.device)
        out = {"img": torch.randint(0, self.n_images, (n_one,), **kw)}
        if self.triang is not None:
            out["tri"] = torch.randint(0, self.triang.x1.shape[0], (n,), **kw)
        elif self.patch is not None:
            out["corner"] = torch.randint(0, self.patch.corners.shape[0],
                                          (n,), **kw)
        else:
            out["pix"] = torch.randint(0, self.N, (n,), **kw)
        if self.n_random_poses > 0:
            out["rnd"] = torch.randint(0, self.n_random_poses, (n_one,),
                                       **kw)
        return out

    def _per_ray(self, idx: torch.Tensor) -> torch.Tensor:
        """A draw of each group (or one for all) -> one index a ray."""
        n, g = self.n_groups, self.group
        idx = idx.expand(n) if idx.numel() == 1 else idx
        return idx[:, None].expand(n, g).reshape(-1)

    def sample(self, generator: Optional[torch.Generator] = None,
               draws: Optional[Dict] = None) -> Dict[str, torch.Tensor]:
        """One batch of {img_idxs, pix_idxs[, rnd_img_idxs]}, a group's
        rays together (x1, x2, x3 of triangle 0, then of triangle 1, ...;
        a patch's pixels row by row)."""
        d = draws if draws is not None else self.draw(generator)
        d = {k: as_index(v, self.device) for k, v in d.items()}
        out = {"img_idxs": self._per_ray(d["img"])}
        if self.triang is not None:
            out["pix_idxs"] = self._triangles(d["tri"])
        elif self.patch is not None:
            corners = self.patch.corners[d["corner"]]
            out["pix_idxs"] = (corners[:, None]
                               + self.patch.offsets[None, :]).reshape(-1)
        else:
            out["pix_idxs"] = d["pix"]
        if self.n_random_poses > 0:
            out["rnd_img_idxs"] = self._per_ray(d["rnd"])
        return out

    def _triangles(self, tri: torch.Tensor) -> torch.Tensor:
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
        return torch.stack([x1, x2, x3], dim=1).reshape(-1)

    # static triangle-extraction metadata consumed by the loss
    @property
    def patch_area(self) -> Optional[int]:
        return self.patch_size ** 2 if self.patch is not None else None

    @property
    def offsets_local(self) -> Optional[Dict[str, np.ndarray]]:
        return self._offsets_local
