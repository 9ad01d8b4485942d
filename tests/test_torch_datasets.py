"""The port's scene loaders (`datasets.get_dataset`: Hypersim, ScanNet-
Manhattan, Replica-SemNeRF) against the JAX package's on the same
fixture directories, written here in each dataset's on-disk format.

Every field of the `SceneData` is compared: the arrays, the Hypersim
`proj` tuple, the bounds, `scale`, the labels and the class metadata.
Tolerance: exact (both loaders run the same numpy and cv2 code), but for
the normals derived from depth (`normals_depth`), which JAX computes
with jnp and the port with torch: atol 1e-6 (f32 cross products and a
square root in another library).

The fixtures are small (Hypersim frames at 256 x 192, read at 1/8 and
1/4 of Hypersim's 1024 x 768; Replica at 64 x 48), but ScanNet's at 640 x
480: that loader fixes the resolution, and depth or semantics of another
size become zeros, so a smaller fixture would test only that fallback.
"""
import json

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
h5py = pytest.importorskip("h5py")

from test_torch_common import write_hypersim_scene  # noqa: E402

from normal_clustering_nerf_torch.datasets import get_dataset  # noqa: E402
from normal_clustering_nerf_torch.datasets.hypersim import (  # noqa: E402
    HypersimCamModel,
)
from normal_clustering_nerf_tpu.datasets import (  # noqa: E402
    get_dataset as j_get_dataset,
)
from normal_clustering_nerf_tpu.datasets.hypersim import (  # noqa: E402
    HypersimCamModel as JCamModel,
)


@pytest.fixture(scope="module")
def hypersim_dir(tmp_path_factory):
    return write_hypersim_scene(tmp_path_factory.mktemp("ai_001_001"))


@pytest.fixture(scope="module")
def scannet_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("scannet_scene")
    H, W = 480, 640
    for d in ("images", "pose", "depth_colmap", "semantic_deeplab"):
        (root / d).mkdir()
    K = np.array([[577.0, 0, 320.0], [0, 577.0, 240.0], [0, 0, 1]])
    np.savetxt(root / "intrinsic.txt",
               np.vstack([np.hstack([K, np.zeros((3, 1))]), [0, 0, 0, 1]]))
    rng = np.random.default_rng(0)
    for i in range(4):
        cv2.imwrite(str(root / "images" / f"{i}.png"),
                    rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        pose = np.eye(4)
        pose[:3, 3] = rng.uniform(-0.5, 0.5, 3)
        np.savetxt(root / "pose" / f"{i}.txt", pose)
        if i != 2:   # frame 2 has no depth: zeros
            np.save(root / "depth_colmap" / f"{i}.npy",
                    rng.uniform(0, 3.0, (H, W)).astype(np.float32))
        sem = np.full((H, W), 7, np.uint8)
        sem[:100] = 80
        sem[200:300] = 160
        cv2.imwrite(str(root / "semantic_deeplab" / f"{i}.png"), sem)
    return str(root)


@pytest.fixture(scope="module")
def replica_dir(tmp_path_factory):
    base = tmp_path_factory.mktemp("replica")
    seq = base / "room_x" / "Sequence_1"
    for d in ("rgb", "depth", "semantic_class"):
        (seq / d).mkdir(parents=True)
    info = base / "semantic_info" / "room_x"
    info.mkdir(parents=True)
    with open(info / "info_semantic.json", "w") as f:
        json.dump({"classes": [{"name": f"c{i}"} for i in range(1, 100)]}, f)
    n, H, W = 24, 48, 64
    rng = np.random.default_rng(1)
    poses = np.tile(np.eye(4)[None], (n, 1, 1))
    poses[:, :3, 3] = rng.uniform(-1, 1, (n, 3))
    np.savetxt(seq / "traj_w_c.txt", poses.reshape(n, 16), delimiter=" ")
    for i in range(n):
        cv2.imwrite(str(seq / "rgb" / f"rgb_{i}.png"),
                    rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        cv2.imwrite(str(seq / "depth" / f"depth_{i}.png"),
                    rng.integers(500, 4000, (H, W)).astype(np.uint16))
        sem = np.full((H, W), 5, np.uint16)
        sem[:10] = 93
        sem[20:30] = 40
        sem[40:, :8] = 17
        cv2.imwrite(str(seq / "semantic_class" / f"semantic_class_{i}.png"),
                    sem)
    return str(base / "room_x")


def _assert_value_equal(a, b, path, atol=0.0):
    if isinstance(b, dict):
        assert isinstance(a, dict) and set(a) == set(b), path
        for k in b:
            _assert_value_equal(a[k], b[k], f"{path}.{k}",
                                1e-6 if k == "normals_depth" else atol)
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_value_equal(x, y, f"{path}[{i}]", atol)
    elif isinstance(b, np.ndarray) or hasattr(b, "__array__"):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (path, a.shape, b.shape)
        if atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=path)
        else:
            assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, (path, a, b)


def _assert_scenes_equal(t, j):
    for f in ("poses", "directions", "rays", "img_wh", "K", "proj", "labels",
              "img_ids", "n_classes", "class_metadata", "xyz_cam_min",
              "xyz_cam_max", "scale"):
        _assert_value_equal(getattr(t, f), getattr(j, f), f)


def _load_both(name, root, **kw):
    return (get_dataset(name)(root, **kw).load(),
            j_get_dataset(name)(root, **kw).load())


R_OFFSET = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                    np.float32) @ np.array(
    [[1.0, 0.0, 0.0], [0.0, 0.8, -0.6], [0.0, 0.6, 0.8]], np.float32)


@pytest.mark.parametrize("kw", [
    dict(downsample=0.125, load_depth_gt=True, load_norm_gt=True,
         load_sem_WF_gt=True),
    dict(downsample=0.25, split="test", load_norm_depth_gt=True,
         load_sem_gt=True, R_offset=R_OFFSET),
    dict(downsample=0.125, load_depth_gt=True, load_norm_depth_gt=True,
         load_norm_gt=True, R_offset=R_OFFSET, split_factor=0.75),
], ids=["resize-wf", "rotated-test", "rotated-normals"])
def test_hypersim_loader_matches_jax(hypersim_dir, kw):
    t, j = _load_both("hypersim", hypersim_dir, **kw)
    _assert_scenes_equal(t, j)
    assert t.proj is not None and t.K is None
    assert np.abs(t.poses[:, :, 3]).max() <= 0.5


def test_hypersim_loader_with_scene_metadata(hypersim_dir, tmp_path):
    """Bounds and image lists from a metadata json (scene.py:88-126)."""
    name = hypersim_dir.rstrip("/").split("/")[-1]
    meta = {name: {
        "cams": {"cam_00": {"img_names": [
            f"frame.{i:04d}.color.hdf5" for i in (5, 1, 7, 0, 3, 2)]}},
        "scene_boundary": {"xyz_scene_min": [-2.0, -2.0, -2.0],
                           "xyz_scene_max": [2.0, 2.0, 2.0],
                           "xyz_cam_min": [-0.2, -0.2, -0.2],
                           "xyz_cam_max": [0.2, 0.2, 0.2]}}}
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(meta))
    t, j = _load_both("hypersim", hypersim_dir, downsample=0.125,
                      load_depth_gt=True, scene_metadata_path=str(path))
    _assert_scenes_equal(t, j)
    assert t.n_images == 3


def test_hypersim_camera_from_its_csv(hypersim_dir, tmp_path):
    """A scene's row of metadata_camera_parameters.csv, read with `csv`
    (the port) and pandas (JAX); the standard camera without it."""
    name = hypersim_dir.rstrip("/").split("/")[-1]
    rng = np.random.default_rng(3)
    cols = [f"M_cam_from_uv_{i}{k}" for i in range(3) for k in range(3)] \
        + [f"M_proj_{i}{k}" for i in range(4) for k in range(4)]
    rows = {s: rng.standard_normal(len(cols)) for s in ("ai_0", name, "ai_9")}
    path = tmp_path / "metadata_camera_parameters.csv"
    with open(path, "w") as f:
        f.write(",".join(["scene_name"] + cols) + "\n")
        for s, vals in rows.items():
            f.write(",".join([s] + [repr(float(x)) for x in vals]) + "\n")
    for csv_path in (str(path), str(tmp_path / "absent.csv")):
        t = HypersimCamModel.from_scene(hypersim_dir, name, 96, 128,
                                        camera_params_csv=csv_path)
        j = JCamModel(hypersim_dir, name, 96, 128,
                      camera_params_csv=csv_path)
        for f in ("M_cam_from_uv", "M_ndc_from_cam", "M_uv_from_ndc",
                  "ray_dirs_cc", "m_per_asset_unit", "H", "W"):
            _assert_value_equal(getattr(t, f), getattr(j, f), f)
    assert t.m_per_asset_unit == 0.5


@pytest.mark.parametrize("split", ["train", "test"])
def test_scannet_loader_matches_jax(scannet_dir, split):
    t, j = _load_both("scannet_manhattan", scannet_dir, split=split,
                      load_depth_gt=True, load_sem_gt=True,
                      load_sem_WF_gt=True)
    _assert_scenes_equal(t, j)
    assert t.n_images == 2
    with pytest.raises(ValueError, match="normal GT"):
        get_dataset("scannet_manhattan")(scannet_dir, load_norm_gt=True)


@pytest.mark.parametrize("kw", [
    dict(load_depth_gt=True, load_sem_gt=True, load_sem_WF_gt=True),
    dict(split="test", downsample=0.5, load_norm_depth_gt=True,
         load_sem_gt=True),
    dict(),
], ids=["labels", "test-resized-normals", "no-labels"])
def test_replica_loader_matches_jax(replica_dir, kw):
    t, j = _load_both("replica_semnerf", replica_dir, **kw)
    _assert_scenes_equal(t, j)


def test_get_dataset_names():
    for name in ("hypersim", "scannet_manhattan", "replica_semnerf",
                 "synthetic"):
        assert get_dataset(name).__name__ == j_get_dataset(name).__name__
    with pytest.raises(KeyError):
        get_dataset("llff")
