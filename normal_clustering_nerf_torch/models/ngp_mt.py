"""NGP-MT field with multi-task heads — port of the JAX package's
`models/ngp_mt.py`.

  * encoding, by `hash_layout` (ngp_mt.py:78-102): `triplane`, the
    triplane + coarse grid (models/triplane.py, kernel H2); `brick`, the
    brick-hash grid (models/brick_hash.py, kernels H5/H6); any other
    value, the tcnn hash grid (models/hash_encoding.py, kernels H7/H8)
  * sigma_net: enc -> 64 -> 16, ReLU, sigma = trunc_exp(h[:, 0])
  * rgb_net: [d, h] (3+16) -> 64 -> 64 -> 3, trunc_sigmoid; with
    `use_exposure` (HDR, ngp_mt.py:131-133) no output activation: the
    three outputs are log-radiance, which the tonemapper_net_{0,1,2}
    (1 -> 64 -> 1, trunc_sigmoid, one a channel) map to rgb, or which
    `output_radiance` returns as radiance (trunc_exp)
  * sem_net / norm_net: 16 -> 64 -> 64 -> n_cls / 3
The view direction enters rgb_net raw, as in the JAX forward (which
bypasses its SH encoder, `models/sh_encoding.py`). All MLPs are
bias-free (tcnn FullyFusedMLP style) and run as `torch.matmul` in the
compute dtype: plain products, as the JAX package leaves them to XLA
(ROADMAP K6 fuses them once a profile asks for it).

Parameter names follow the JAX pytree: `hash_table.planes` and
`hash_table.grid3d` (triplane) or one `hash_table` (brick, tcnn),
`sigma_net.w0`, ..., `tonemapper_net_0.w0`, so parameters convert 1:1.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
from torch import nn

from ..config import ModelConfig
from ..ops.trunc_exp import trunc_exp, trunc_sigmoid
from .brick_hash import BrickGridSpec, brick_encode, init_brick_table
from .hash_encoding import HashGridSpec, hash_encode, init_hash_table
from .triplane import TriplaneSpec, init_triplane, triplane_encode


def _init_mlp(dims: List[int], generator, device) -> nn.ParameterDict:
    """Bias-free Xavier-uniform weights, (fan_in, fan_out) each."""
    ws = {}
    for i, (fan_in, fan_out) in enumerate(zip(dims[:-1], dims[1:])):
        bound = math.sqrt(6.0 / (fan_in + fan_out))
        u = torch.rand((fan_in, fan_out), generator=generator, device=device)
        ws[f"w{i}"] = nn.Parameter(u * (2 * bound) - bound)
    return nn.ParameterDict(ws)


def apply_mlp(params: nn.ParameterDict, x, out_act=None,
              compute_dtype=torch.float32):
    h = x.to(compute_dtype)
    n = len(params)
    for i in range(n):
        h = torch.matmul(h, params[f"w{i}"].to(compute_dtype))
        if i < n - 1:
            h = torch.relu(h)
    if out_act == "sigmoid":
        h = trunc_sigmoid(h)
    return h


class NGPMT(nn.Module):
    def __init__(self, cfg: ModelConfig, device: torch.device,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        self.scale = cfg.scale
        grid = dict(n_levels=cfg.n_levels,
                    n_features=cfg.n_features_per_level,
                    base_res=cfg.base_resolution,
                    per_level_scale=cfg.per_level_scale)
        if cfg.hash_layout == "brick":
            self.spec = BrickGridSpec.create(log2_bricks=cfg.log2_bricks,
                                             **grid)
            init, self._encode = init_brick_table, brick_encode
        elif cfg.hash_layout == "triplane":
            self.spec = TriplaneSpec.create(
                plane_res=cfg.plane_res, plane_feats=cfg.plane_feats,
                grid3d_res=cfg.grid3d_res, grid3d_feats=cfg.grid3d_feats)
            init, self._encode = init_triplane, triplane_encode
        else:
            self.spec = HashGridSpec.create(
                log2_table_size=cfg.log2_hashmap_size, **grid)
            init, self._encode = init_hash_table, hash_encode
        self.compute_dtype = (torch.bfloat16 if cfg.compute_dtype == "bfloat16"
                              else torch.float32)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        W, geo = cfg.hidden_dim, cfg.geo_feat_dim
        table = init(self.spec, generator, device)
        self.hash_table = (
            nn.ParameterDict({k: nn.Parameter(v) for k, v in table.items()})
            if isinstance(table, dict) else nn.Parameter(table))
        self.sigma_net = _init_mlp(
            [self.spec.out_dim] + [W] * cfg.sigma_hidden_layers + [geo],
            generator, device)
        self.rgb_net = _init_mlp(
            [3 + geo] + [W] * cfg.rgb_hidden_layers + [3], generator, device)
        if cfg.pred_sem:
            self.sem_net = _init_mlp(
                [geo] + [W] * cfg.head_hidden_layers + [cfg.n_sem_cls],
                generator, device)
        if cfg.pred_norm_nn:
            self.norm_net = _init_mlp(
                [geo] + [W] * cfg.head_hidden_layers + [3], generator, device)
        if cfg.use_exposure:
            for i in range(3):
                setattr(self, f"tonemapper_net_{i}",
                        _init_mlp([1, W, 1], generator, device))

    def density(self, x, return_feat: bool = False):
        """sigma at world positions x in [-scale, scale]^3."""
        xn = (x + self.scale) / (2.0 * self.scale)
        table = (dict(self.hash_table)
                 if isinstance(self.hash_table, nn.ParameterDict)
                 else self.hash_table)
        enc = self._encode(table, xn, self.spec, self.compute_dtype)
        h = apply_mlp(self.sigma_net, enc, compute_dtype=self.compute_dtype)
        sigmas = trunc_exp(h[:, 0].to(torch.float32))
        if return_feat:
            return sigmas, h
        return sigmas

    def log_radiance_to_rgb(self, log_radiances, exposure=None):
        """HDR-NeRF tonemapping (ngp_mt.py:156-169): each channel's
        log-radiance, plus log(exposure) when given, through its own
        tonemapper MLP in the compute dtype."""
        log_exposure = torch.log(exposure) if exposure is not None else 0.0
        return torch.cat([
            apply_mlp(getattr(self, f"tonemapper_net_{i}"),
                      log_radiances[:, i:i + 1] + log_exposure,
                      out_act="sigmoid", compute_dtype=self.compute_dtype)
            for i in range(3)], dim=1)

    def forward(self, x, d, exposure=None,
                output_radiance: bool = False) -> Dict[str, torch.Tensor]:
        """Full field: (M, 3) positions and view directions -> sigmas (M,),
        rgbs (M, 3) [+ sems, norms], all f32. With `use_exposure`, rgbs
        is the tonemapped log-radiance (at `exposure`, (M, 1), when given),
        or with `output_radiance` the radiance itself."""
        sigmas, h = self.density(x, return_feat=True)
        d = d / torch.linalg.norm(d, dim=1, keepdim=True)
        if not self.cfg.rgb_use_dir:
            d = d * 0.0
        rgb_in = torch.cat([d.to(h.dtype), h], dim=1)
        hdr = self.cfg.use_exposure
        rgbs = apply_mlp(self.rgb_net, rgb_in,
                         out_act=None if hdr else "sigmoid",
                         compute_dtype=self.compute_dtype)
        if hdr and output_radiance:
            rgbs = trunc_exp(rgbs.to(torch.float32))
        elif hdr:
            rgbs = self.log_radiance_to_rgb(rgbs, exposure)
        out = {"sigmas": sigmas, "rgbs": rgbs.to(torch.float32)}
        if self.cfg.pred_sem:
            out["sems"] = apply_mlp(self.sem_net, h,
                                    compute_dtype=self.compute_dtype
                                    ).to(torch.float32)
        if self.cfg.pred_norm_nn:
            out["norms"] = apply_mlp(self.norm_net, h,
                                     compute_dtype=self.compute_dtype
                                     ).to(torch.float32)
        return out
