"""The port's weights files and full checkpoints
(`normal_clustering_nerf_torch/training/checkpoints.py`) against the JAX
package's (`training/checkpoints.py`): weights travel both ways exactly
(npz keyed by the JAX tree paths), a v1 triplane file converts as JAX
converts it, and a full checkpoint round-trips every tensor bit for bit
and resumes training exactly on the CPU (as tests/test_train_e2e.py:98-130
holds the JAX one); a checkpoint that does not fit the trainer, or whose
layout tag is not the current one, is refused."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from test_torch_common import CPU, slice_configs

from normal_clustering_nerf_torch.convert import convert_params, jax_path
from normal_clustering_nerf_torch.datasets.synthetic import (
    SyntheticDataset as TSyn,
)
from normal_clustering_nerf_torch.training import Trainer as TTrainer
from normal_clustering_nerf_torch.training.checkpoints import (
    load_weights, restore_checkpoint, save_checkpoint, save_weights,
    slim_state, trainer_state,
)
from normal_clustering_nerf_tpu.datasets.synthetic import (
    SyntheticDataset as JSyn,
)
from normal_clustering_nerf_tpu.training import Trainer as JTrainer
from normal_clustering_nerf_tpu.training import checkpoints as jck

LAYOUTS = {"triplane": {}, "brick": dict(log2_bricks=8,
                                         finest_resolution=128)}
SCENE = dict(split="train", img_wh=(24, 24), n_images=6)


def _configs(layout):
    """slice_configs with the Manhattan-SDF term on, so that the params
    hold the top-level leaf theta_WF beside "model"."""
    return tuple(c.replace(loss=dataclasses.replace(c.loss,
                                                    manhattan_nerf_w=2e-3))
                 for c in slice_configs(hash_layout=layout,
                                        **LAYOUTS[layout]))


@pytest.fixture(scope="module", params=sorted(LAYOUTS))
def pair(request):
    jcfg, tcfg = _configs(request.param)
    jt = JTrainer(jcfg, JSyn(**SCENE).load())
    tt = TTrainer(tcfg, TSyn(**SCENE).load(), device="cpu")
    return request.param, jt, tt


def _jax_leaves(params):
    """{"/"-joined path: numpy leaf} of a JAX params tree."""
    return {"/".join(str(getattr(k, "key", k)) for k in kp): np.asarray(v)
            for kp, v in jax.tree_util.tree_leaves_with_path(params)}


def test_port_reads_jax_weights(pair, tmp_path):
    layout, jt, tt = pair
    path = str(tmp_path / "jax.npz")
    jck.save_weights(path, jt.state.params)
    got = load_weights(path, tt.params)
    want = convert_params(jax.tree_util.tree_map(np.asarray,
                                                 jt.state.params), CPU)
    assert set(got) == set(want) == set(tt.params)
    assert "theta_WF" in got
    for n, w in want.items():
        assert torch.equal(got[n], w), n
        assert not torch.equal(tt.params[n], w) or n == "theta_WF", n
    tt.load_params(got)
    for n, p in tt.params.items():
        assert torch.equal(p.detach(), want[n]), n


def test_jax_reads_port_weights(pair, tmp_path):
    layout, jt, tt = pair
    path = str(tmp_path / "port.npz")
    with torch.no_grad():
        tt.params["theta_WF"].fill_(0.25)
    save_weights(path, tt.params)
    restored = _jax_leaves(jck.load_weights(path, jt.state.params))
    assert set(restored) == {jax_path(n) for n in tt.params}
    for n, p in tt.params.items():
        np.testing.assert_array_equal(restored[jax_path(n)],
                                      p.detach().numpy(), err_msg=n)


def test_load_weights_fills_only_the_names_it_finds(pair, tmp_path):
    """As JAX's: a file without a leaf leaves that parameter as it is."""
    layout, jt, tt = pair
    leaves = _jax_leaves(jt.state.params)
    part = {k: v for k, v in leaves.items() if "sigma_net" in k}
    path = str(tmp_path / "part.npz")
    np.savez(path, __triplane_layout__=np.int32(2), **part)
    got = load_weights(path, tt.params)
    ref = _jax_leaves(jck.load_weights(path, jt.state.params))
    for n, p in tt.params.items():
        if jax_path(n) in part:
            np.testing.assert_array_equal(got[n].numpy(), ref[jax_path(n)])
        else:
            assert torch.equal(got[n], p.detach()), n


@pytest.mark.parametrize("tag", ["v1", "untagged"])
def test_v1_weights_convert_as_jax(pair, tmp_path, tag):
    """A file tagged v1 (or without a tag) holds slot-major triplane rows:
    both packages load it into the same feature-major tables."""
    layout, jt, tt = pair
    leaves = _jax_leaves(jt.state.params)
    if tag == "v1":
        leaves["__triplane_layout__"] = np.int32(1)
    path = str(tmp_path / "v1.npz")
    np.savez(path, **leaves)
    ref = _jax_leaves(jck.load_weights(path, jt.state.params))
    got = load_weights(path, tt.params)
    for n in tt.params:
        np.testing.assert_array_equal(got[n].numpy(), ref[jax_path(n)],
                                      err_msg=n)
    moved = not np.array_equal(ref["model/hash_table/planes"],
                               leaves["model/hash_table/planes"]) \
        if layout == "triplane" else None
    assert moved in (True, None)


def test_weights_of_another_shape_are_refused(pair, tmp_path):
    layout, jt, tt = pair
    path = str(tmp_path / "bad.npz")
    np.savez(path, **{"model/sigma_net/w0": np.zeros((3, 3), np.float32)})
    with pytest.raises(ValueError, match="shape"):
        load_weights(path, tt.params)


def _trained(cfg, steps):
    tr = TTrainer(cfg, TSyn(**SCENE).load(), device="cpu")
    tr.mark_invisible_cells()
    tr.fit(steps)
    return tr


def _assert_same_state(a, b):
    sa, sb = trainer_state(a), trainer_state(b)
    assert sa["step"] == sb["step"] and sa["model"] == sb["model"]
    assert sa["opt"]["count"] == sb["opt"]["count"]
    assert torch.equal(sa["generator"], sb["generator"])
    for group in ("params", "occ"):
        for n, t in sa[group].items():
            assert torch.equal(t, sb[group][n]), (group, n)
    for group in ("mu", "nu"):
        for n, t in sa["opt"][group].items():
            assert torch.equal(t, sb["opt"][group][n]), (group, n)


def test_checkpoint_resumes_bit_for_bit(tmp_path):
    """20 steps (a refresh at 0 and 16), a checkpoint, then 16 steps (one
    more refresh, whose draws come from the restored generator): a fresh
    trainer restored from the checkpoint and the first trainer restored
    into after it moved on both repeat those 16 steps exactly."""
    _, cfg = _configs("triplane")
    tr = _trained(cfg, 20)
    ck = str(tmp_path / "ckpt")
    save_checkpoint(ck, tr)
    assert sorted(os.listdir(ck)) == ["layout_version.json", "state.pt"]
    fresh = TTrainer(cfg, TSyn(**SCENE).load(), device="cpu")
    restore_checkpoint(ck, fresh)
    _assert_same_state(tr, fresh)
    assert fresh.step == 20 and fresh.opt.state["count"] == 20
    assert int(fresh.opt.count_t) == 20 and int(fresh._step_t) == 20
    ref = tr.fit(16)
    for other in (fresh, restore_checkpoint(ck, tr)):
        assert other.fit(16) == ref
    _assert_same_state(fresh, tr)
    slim = slim_state(tr)
    assert slim["step"] == 36 and set(slim["params"]) == set(tr.params)


@pytest.mark.parametrize("case", ["grid", "layout", "near_dist",
                                  "theta_WF", "tag", "untagged"])
def test_checkpoint_that_does_not_fit_is_refused(tmp_path, case):
    """Another grid (the occupancy's shapes), field (the parameters'
    names), model option of the same shapes, or parameter set, or a
    layout tag that is not the current one: refused, nothing loaded."""
    _, cfg = _configs("triplane")
    tr = TTrainer(cfg, TSyn(**SCENE).load(), device="cpu")
    ck = str(tmp_path / "ckpt")
    save_checkpoint(ck, tr)
    model = {"grid": dict(grid_size=16),
             "layout": dict(hash_layout="brick", **LAYOUTS["brick"]),
             "near_dist": dict(near_dist=0.02)}.get(case, {})
    other = cfg.replace(model=dataclasses.replace(cfg.model, **model))
    if case == "theta_WF":
        other = other.replace(loss=dataclasses.replace(other.loss,
                                                       manhattan_nerf_w=0))
    if case == "tag":
        with open(os.path.join(ck, "layout_version.json"), "w") as f:
            json.dump({"triplane_layout": 1}, f)
    if case == "untagged":
        os.remove(os.path.join(ck, "layout_version.json"))
    target = TTrainer(other, TSyn(**SCENE).load(), device="cpu")
    before = trainer_state(target)
    match = "layout v1" if case in ("tag", "untagged") else "checkpoint"
    with pytest.raises(ValueError, match=match):
        restore_checkpoint(ck, target)
    after = trainer_state(target)
    for n, t in before["params"].items():
        assert torch.equal(t, after["params"][n]), n
