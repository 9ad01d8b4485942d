"""The port's native host sampler (`datasets/native_sampler.py`, its own
copy of raybatch.cpp built with g++ into build/native/) against the JAX
package's `NativeRaySampler`, the invariants of tests/test_native_sampler.py,
and the trainer's host-batch path: its batches feeding the steps in order
(`HostFeed`), and one host-batch step against the JAX trainer's
`_train_step_hostb`.

The JAX sampler loads native/libraybatch.so and runs make there when the
library is missing; these tests point it at a library built from the JAX
package's own source (native/raybatch.cpp, with native/Makefile's flags)
in a temporary directory, so that nothing is written into native/.

Batches compare array for array: each batch comes from a stream seeded by
the seed and its sequence number, so with one prefetch thread both
samplers give the same sequence. The step is held at the tolerances of
tests/test_torch_slice.py (losses rtol 1e-4, atol 1e-7; counters exact;
gradients rtol 1e-3, atol 1e-4 of the largest).
"""
import dataclasses
import subprocess
from pathlib import Path

import jax
import numpy as np
import pytest

from test_torch_common import CPU, J, N, slice_configs
from test_torch_slice import _flat as _flat_tree
from test_torch_slice import _jax_draws

import normal_clustering_nerf_tpu.datasets.native_sampler as jns
from normal_clustering_nerf_torch.convert import convert_jax_state
from normal_clustering_nerf_torch.datasets import native_sampler as tns
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.training import Trainer as JTrainer

REPO = Path(__file__).resolve().parents[1]
STRATEGIES = ("all_images", "same_image", "all_images_triang",
              "same_image_triang", "all_images_triang_patch",
              "same_image_triang_patch")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX sampler module, its library built in a temporary directory
    from native/raybatch.cpp with native/Makefile's flags."""
    d = tmp_path_factory.mktemp("jax_native")
    subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-fPIC",
                    "-Wall", "-pthread", "-shared", "-o",
                    str(d / "libraybatch.so"),
                    str(REPO / "native" / "raybatch.cpp")], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jns, "_NATIVE_DIR", str(d))
        yield jns


@pytest.fixture(scope="module")
def scene_arrays():
    """tests/test_native_sampler.py's scene, with normals."""
    rng = np.random.default_rng(0)
    n_img, H, W = 4, 24, 32
    rgb = rng.random((n_img, H * W, 3)).astype(np.float32)
    depth = rng.random((n_img, H * W)).astype(np.float32)
    normals = rng.standard_normal((n_img, H * W, 3)).astype(np.float32)
    sem = rng.integers(0, 4, (n_img, H * W)).astype(np.int32)
    return (W, H), rgb, depth, normals, sem


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_batches_equal_jax(jax_native, scene_arrays, strategy):
    """Three batches of each strategy, with every label, triangles dilated
    by 2 pixels, and a batch size of no whole group (200 -> 198 rays as
    triangles, 192 as 8 x 8 patches)."""
    img_wh, rgb, depth, normals, sem = scene_arrays
    kw = dict(depth=depth, normals=normals, semantics=sem, max_expand=2,
              n_threads=1, seed=11)
    a = tns.NativeRaySampler(strategy, 200, img_wh, rgb, **kw)
    b = jax_native.NativeRaySampler(strategy, 200, img_wh, rgb, **kw)
    try:
        assert a.batch_size == b.batch_size
        for _ in range(3):
            x, y = a.next_batch(), b.next_batch()
            assert set(x) == set(y)
            for k in y:
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
    finally:
        a.close()
        b.close()


def test_library_is_built_under_build(scene_arrays):
    """The port builds its own copy, into build/native/, never native/."""
    path = tns.build()
    assert path.exists() and (REPO / "build" / "native") in path.parents
    assert tns.SOURCE.parent == REPO / "normal_clustering_nerf_torch" / "native"


def test_uniform_strategy_gathers_correctly(scene_arrays):
    img_wh, rgb, depth, normals, sem = scene_arrays
    s = tns.NativeRaySampler("all_images", 256, img_wh, rgb, depth=depth,
                             normals=normals, semantics=sem, seed=7)
    b = s.next_batch()
    s.close()
    W, H = img_wh
    assert b["img_idxs"].shape == (256,)
    assert (b["img_idxs"] >= 0).all() and (b["img_idxs"] < rgb.shape[0]).all()
    assert (b["pix_idxs"] >= 0).all() and (b["pix_idxs"] < W * H).all()
    at = (b["img_idxs"], b["pix_idxs"])
    for k, src in (("rgb", rgb), ("depth", depth), ("normals", normals),
                   ("semantics", sem)):
        np.testing.assert_array_equal(b[k], src[at], err_msg=k)


def test_triang_strategy_structure(scene_arrays):
    img_wh, rgb, _, _, _ = scene_arrays
    W, H = img_wh
    s = tns.NativeRaySampler("all_images_triang", 192, img_wh, rgb, seed=3)
    b = s.next_batch()
    s.close()
    pix = b["pix_idxs"].reshape(-1, 3)
    img = b["img_idxs"].reshape(-1, 3)
    assert (img == img[:, :1]).all()
    x1, x2, x3 = pix[:, 0], pix[:, 1], pix[:, 2]
    np.testing.assert_array_equal(x2, x1 - W)
    np.testing.assert_array_equal(x3, x1 - 1)
    assert (x1 // W >= 1).all() and (x1 // W <= H - 2).all()
    assert (x1 % W >= 1).all() and (x1 % W <= W - 2).all()


def test_patch_strategy_structure(scene_arrays):
    img_wh, rgb, _, _, _ = scene_arrays
    W, H = img_wh
    p = 8
    s = tns.NativeRaySampler("same_image_triang_patch", 2 * p * p, img_wh,
                             rgb, patch_size=p, seed=5)
    b = s.next_batch()
    s.close()
    assert (b["img_idxs"] == b["img_idxs"][0]).all()
    for row in b["pix_idxs"].reshape(-1, p * p):
        corner = row[0]
        expect = (corner + (np.arange(p * p) // p) * W
                  + (np.arange(p * p) % p))
        np.testing.assert_array_equal(row, expect)
        assert corner % W + p <= W and corner // W + p <= H


def test_deterministic_given_seed(scene_arrays):
    img_wh, rgb, _, _, _ = scene_arrays
    batches = []
    for _ in range(2):
        s = tns.NativeRaySampler("all_images", 128, img_wh, rgb, seed=42,
                                 n_threads=1)
        batches.append(s.next_batch())
        s.close()
    for k in ("img_idxs", "pix_idxs"):
        np.testing.assert_array_equal(batches[0][k], batches[1][k])


def test_prefetch_throughput_and_close(scene_arrays):
    img_wh, rgb, depth, _, _ = scene_arrays
    s = tns.NativeRaySampler("all_images_triang", 768, img_wh, rgb,
                             depth=depth, n_threads=4, seed=1)
    for _ in range(50):
        assert s.next_batch()["rgb"].shape == (768, 3)
    s.close()
    with pytest.raises(RuntimeError, match="closed"):
        s.next_batch()


def _host_cfgs(threads=1):
    jcfg, tcfg = (c.replace(
        render=dataclasses.replace(c.render, bootstrap_steps=16),
        data=dataclasses.replace(c.data, host_sampler=True,
                                 host_sampler_threads=threads))
        for c in slice_configs())
    return jcfg, tcfg


def _scene(mod):
    return mod(split="train", img_wh=(24, 24), n_images=6).load()


def test_host_sampler_refuses_random_poses():
    _, tcfg = _host_cfgs()
    cfg = tcfg.replace(data=dataclasses.replace(tcfg.data,
                                                random_tr_poses=True))
    with pytest.raises(ValueError, match="random_tr_poses"):
        TTrainer(cfg, _scene(TSyn), device="cpu")


def test_host_batches_feed_the_steps_in_order():
    """A chunk's steps take the prefetcher's batches in order through the
    device block, and an eager step the next one: the batches of an
    independent sampler at the same seed, one prefetch thread."""
    _, tcfg = _host_cfgs()
    scene = _scene(TSyn)
    tt = TTrainer(tcfg, scene, device="cpu")
    ref = tns.NativeRaySampler(
        "all_images_triang", 96, scene.img_wh, scene.rays[..., :3],
        max_expand=3, n_threads=1, seed=tcfg.seed)
    want = [ref.next_batch() for _ in range(4)]
    ref.close()
    tt.occ_update(warmup=True)
    tt.train_chunk(3, bootstrap=True)
    for i in range(3):
        np.testing.assert_array_equal(N(tt.host_feed.block[i, 0]),
                                      want[i]["img_idxs"])
        np.testing.assert_array_equal(N(tt.host_feed.block[i, 1]),
                                      want[i]["pix_idxs"])
    np.testing.assert_array_equal(N(tt.last_batch["pix_idxs"]),
                                  want[2]["pix_idxs"])
    tt.train_step_core(bootstrap=True)
    np.testing.assert_array_equal(N(tt.last_batch["pix_idxs"]),
                                  want[3]["pix_idxs"])
    assert tt.step == 4
    tt.native_sampler.close()


def test_a_host_batch_step_matches_jax(jax_native):
    """One bootstrap step on a host batch: the port's step (the batch
    handed in as `draws["batch"]`) against the JAX trainer's
    `_train_step_hostb` on the same batch and its eager loss and
    gradients (`_jax_draws` with the JAX sampler's draw replaced by the
    host batch)."""
    jcfg, tcfg = _host_cfgs()
    jt = JTrainer(jcfg, _scene(JSyn))
    assert jt.native_sampler is not None
    jt.mark_invisible_cells()
    occ = jt._occ_update[True](jt.state.occ, jt.state.params,
                               jax.random.PRNGKey(7))
    jt.state = jt.state._replace(occ=occ)
    tt = TTrainer(tcfg, _scene(TSyn), device="cpu")
    params, occ_t, opt_state = convert_jax_state(
        jax.tree_util.tree_map(np.asarray, jt.state.params),
        jax.tree_util.tree_map(np.asarray, jt.state.occ), tt.opt, CPU)
    tt.load_state(params, occ_t, opt_state, step=int(jt.state.step))
    b = tt.native_sampler.next_batch()
    hb = {k: J(b[k]) for k in ("img_idxs", "pix_idxs")}
    jt.sampler.sample = lambda key: hb
    draws, grads, loss_ref, rm, vr = _jax_draws(jt, jt.state)
    draws["batch"] = {k: b[k] for k in ("img_idxs", "pix_idxs")}
    state = jax.tree_util.tree_map(lambda a: a.copy(), jt.state)
    _, m_ref = jt._train_step_hostb[True](state, jt.scene_dev, hb)
    m = tt.train_step_core(bootstrap=True, draws=draws)
    np.testing.assert_array_equal(N(tt.last_batch["pix_idxs"]),
                                  b["pix_idxs"])
    for k, v in loss_ref.items():
        for ref in (float(v), float(m_ref[f"loss_{k}"])):
            np.testing.assert_allclose(float(m[f"loss_{k}"]), ref,
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"loss {k}")
    assert round(float(m["rm_samples_per_ray"]) * 96) == rm
    assert round(float(m["vr_samples_per_ray"]) * 96) == vr
    g_ref = _flat_tree(grads["model"])
    for n, g in tt.last_grads.items():
        r = g_ref[n]
        np.testing.assert_allclose(N(g), r, rtol=1e-3,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg=f"grad {n}")
    jt.native_sampler.close()
    tt.native_sampler.close()
