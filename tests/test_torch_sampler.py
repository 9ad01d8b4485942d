"""The port's ray sampler (datasets/sampler.py) against the JAX package's
`RaySampler`, every strategy, with and without random poses.

The JAX sampler splits its key in three (images, pixels / triangles /
patch corners, random poses); the test makes the same draws from those
keys and hands them to the port, whose indices must then equal JAX's
exactly (integer indices: no tolerance).
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from test_torch_common import N

from normal_clustering_nerf_torch.datasets.sampler import (
    RaySampler as TS, build_patch_tables as t_patch,
)
from normal_clustering_nerf_tpu.datasets.sampler import (
    RaySampler as JS, build_patch_tables as j_patch,
)

WH, N_IMG, N_RND, BATCH = (24, 20), 6, 7, 384
STRATEGIES = ("all_images", "same_image", "all_images_triang",
              "same_image_triang", "all_images_triang_val",
              "all_images_triang_patch", "same_image_triang_patch")
# random poses come with the triangle and patch strategies only
CASES = [(s, r) for s, r in itertools.product(STRATEGIES, (0, N_RND))
         if not (r and s in ("all_images", "same_image"))]


@pytest.mark.parametrize("hw,p", [((20, 24), 8), ((192, 256), 8),
                                  ((9, 9), 4)])
def test_patch_tables_equal_jax(hw, p):
    for a, b in zip(t_patch(*hw, p), j_patch(*hw, p)):
        np.testing.assert_array_equal(a, np.asarray(b))


def _jax_draws(js, key):
    """The draws JAX's `sample(key)` makes, in the port's form."""
    k_img, k_pix, k_rnd = jax.random.split(key, 3)
    same = js.strategy.startswith("same")
    if js.triang is not None:
        group, n_tab, name = 3, js.triang.x1.shape[0], "tri"
    elif js.patch is not None:
        group, n_tab, name = js.patch_size ** 2, js.patch.corners.shape[0], \
            "corner"
    else:
        group, n_tab, name = 1, js.N, "pix"
    n = js.batch_size // group
    if js.n_random_poses > 0:
        n //= 2
    shape = () if same else (n,)
    out = {"img": jax.random.randint(k_img, shape, 0, js.n_images),
           name: jax.random.randint(k_pix, (js.batch_size if group == 1
                                            else n,), 0, n_tab)}
    if js.n_random_poses > 0:
        out["rnd"] = jax.random.randint(k_rnd, shape, 0, js.n_random_poses)
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("strategy,n_rnd", CASES)
def test_indices_from_jax_draws_equal_jax(strategy, n_rnd):
    kw = dict(max_expand=2 if "triang" in strategy else 0,
              n_random_poses=n_rnd)
    js = JS(strategy, BATCH, WH, N_IMG, **kw)
    ts = TS(strategy, BATCH, WH, N_IMG, device="cpu", **kw)
    for seed in (0, 1):
        key = jax.random.PRNGKey(seed)
        ref = js.sample(key)
        out = ts.sample(draws=_jax_draws(js, key))
        assert set(out) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(N(out[k]), np.asarray(ref[k]),
                                          err_msg=k)
    assert ts.patch_area == js.patch_area
    if js.offsets_local is None:
        assert ts.offsets_local is None
    else:
        for k, v in js.offsets_local.items():
            np.testing.assert_array_equal(ts.offsets_local[k], v)


@pytest.mark.parametrize("strategy,n_rnd", CASES)
def test_own_draws_in_range(strategy, n_rnd):
    ts = TS(strategy, BATCH, WH, N_IMG, n_random_poses=n_rnd, device="cpu")
    out = ts.sample(torch.Generator().manual_seed(3))
    n = BATCH // 2 if n_rnd else BATCH
    n -= n % ts.group
    assert out["img_idxs"].shape == out["pix_idxs"].shape == (n,)
    assert 0 <= int(out["pix_idxs"].min()) <= int(out["pix_idxs"].max()) \
        < WH[0] * WH[1]
    assert int(out["img_idxs"].max()) < N_IMG
    if strategy.startswith("same"):
        assert len(set(N(out["img_idxs"]).tolist())) == 1
    if n_rnd:
        assert out["rnd_img_idxs"].shape == (n,)
        assert int(out["rnd_img_idxs"].max()) < n_rnd


def test_random_poses_need_groups():
    with pytest.raises(ValueError, match="random poses"):
        TS("all_images", BATCH, WH, N_IMG, n_random_poses=N_RND,
           device="cpu")
