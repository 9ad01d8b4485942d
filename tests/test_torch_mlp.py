"""The field's four MLPs (kernel K6's plain version, `ops/mlp.py`) against
the JAX package: the port's NGPMT and the JAX NGPMT on the same bf16
encoding (each model's encode replaced by that encoding, so that only the
nets, trunc_exp, the direction's normalisation, the cat, trunc_sigmoid,
the heads and the tonemapper are compared), the weights carried across by
`convert.py`: sigmas and every head's output, and the gradients of every
weight, of the encoding and of the directions. Also the plain backward
against autograd of the parent's torch chain, the wrapper on CPU tensors,
the refusals K6's wrapper makes before any launch, the layout of K6's
arguments, and the rule `chip_smoke.py` holds K6 to on the card.

Tolerances, bf16 compute (as tests/test_torch_model.py): each product is
rounded to bf16 (8-bit mantissa) and XLA and torch may round a hidden
unit differently, so outputs agree to atol 3e-2 and gradients to atol
5e-2 of the largest gradient. The plain backward against autograd of the
parent chain: bit for bit (the same products, rounded at the same
points, h's gradient added in autograd's order), but the directions'
gradient, which the plain version writes out as (g - dn (g . dn)) / |d|:
within 2^-20 of its largest value (f32 rounding).
"""
import contextlib
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_common import CPU, J, N, T, random_rays, slice_configs

import normal_clustering_nerf_tpu.models.ngp_mt as jngp
from normal_clustering_nerf_torch.convert import convert_params
from normal_clustering_nerf_torch.models.ngp_mt import NGPMT as TModel
from normal_clustering_nerf_torch.models.ngp_mt import apply_mlp
from normal_clustering_nerf_torch.ops import mlp
from normal_clustering_nerf_torch.ops.trunc_exp import trunc_exp

BF = torch.bfloat16
M = 300
TOL_OUT, TOL_GRAD = 3e-2, 5e-2
DIN = {"triplane": 28, "brick": 32, "tcnn": 32}
LAYOUTS = {"triplane": {}, "brick": dict(log2_bricks=8),
           "tcnn": dict(log2_hashmap_size=12)}


@contextlib.contextmanager
def given_encoding():
    """The JAX NGPMT's encode returns params["hash_table"] (an encoding
    array put there) in the compute dtype."""
    names = ("brick_encode", "triplane_encode", "hash_encode")
    saved = {n: getattr(jngp, n) for n in names}
    for n in names:
        setattr(jngp, n, lambda table, xn, spec, dtype, need_dx=False:
                table.astype(dtype))
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(jngp, n, f)


def _models(layout="triplane", **model_kw):
    jc, tc = slice_configs(compute_dtype="bfloat16", hash_layout=layout,
                           **LAYOUTS[layout], **model_kw)
    jm = jngp.NGPMT(jc.model)
    params = jm.init(jax.random.PRNGKey(0))
    tm = TModel(tc.model, CPU)
    nets = {k: v for k, v in params.items() if k != "hash_table"}
    missing, _ = tm.load_state_dict(convert_params(
        jax.tree_util.tree_map(np.asarray, nets), CPU), strict=False)
    assert all(k.startswith("hash_table") for k in missing)
    return jm, nets, tm


CASES = [("triplane", dict(n_sem_cls=3)),
         ("brick", dict(n_sem_cls=40)),
         ("tcnn", dict(n_sem_cls=3, rgb_use_dir=False)),
         ("triplane", dict(n_sem_cls=40, pred_norm_nn=False)),
         ("tcnn", dict(pred_sem=False))]


@pytest.mark.parametrize("layout,kw", CASES,
                         ids=[f"{l}-{'-'.join(f'{k}={v}' for k, v in kw.items())}"
                              for l, kw in CASES])
def test_field_mlp_matches_jax(layout, kw):
    """The port's field on a given encoding (K6's plain version through
    FieldMLP) against the JAX NGPMT.__call__ on it: sigmas, rgbs, norms,
    sems, and the gradients of every weight, the encoding and the
    directions (the ext path's), at each field's input width, with
    rgb_use_dir on and off, 3 and 40 classes, without the normal or the
    semantic head."""
    jm, nets, tm = _models(layout, **kw)
    rng = np.random.default_rng(3)
    x, d = random_rays(rng, M)
    d = d * rng.uniform(0.5, 2.0, (M, 1)).astype(np.float32)   # not unit
    enc = rng.standard_normal((M, DIN[layout])).astype(np.float32)
    keys = ["sigmas", "rgbs"] + (["norms"] if tm.cfg.pred_norm_nn else []) \
        + (["sems"] if tm.cfg.pred_sem else [])
    cot = {k: rng.standard_normal((M,) if k == "sigmas" else (
        M, tm.cfg.n_sem_cls if k == "sems" else 3)).astype(np.float32)
        for k in keys}

    def loss_j(p, table, dj):
        out = jm(dict(p, hash_table=table), J(x), dj)
        return sum(jnp.sum(out[k] * J(c)) for k, c in cot.items()), out

    with given_encoding(), jax.disable_jit():
        (_, ref), grads = jax.value_and_grad(loss_j, (0, 1, 2), has_aux=True)(
            nets, J(enc, jnp.bfloat16), J(d))
    et = T(enc).to(BF).requires_grad_(True)
    dt = T(d).requires_grad_(True)
    tm.encode = lambda xx: et
    out = tm(T(x), dt)
    assert set(out) == set(keys)
    sum((out[k] * T(c)).sum() for k, c in cot.items()).backward()
    for k in keys:
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k], np.float32),
                                   rtol=0, atol=TOL_OUT, err_msg=k)
    gp, ge, gd = grads
    flat = {".".join(str(getattr(q, "key", q)) for q in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]}
    named = dict(tm.named_parameters())
    assert set(flat) == {n for n in named if not n.startswith("hash_table")}
    for n, r in flat.items():
        np.testing.assert_allclose(N(named[n].grad), r, rtol=0,
                                   atol=TOL_GRAD * np.abs(r).max(), err_msg=n)
    for got, r, name in ((et.grad, ge, "encoding"), (dt.grad, gd, "dirs")):
        r = np.asarray(r, np.float32)
        np.testing.assert_allclose(N(got), r, rtol=0,
                                   atol=TOL_GRAD * np.abs(r).max(),
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["tonemapped", "radiance"])
def test_exposure_rgb_matches_jax(mode):
    """use_exposure: K6's rgb without trunc_sigmoid (the log-radiance),
    then the torch tonemapper or trunc_exp, against JAX, with the
    gradients of the rgb net, the tonemappers and the encoding."""
    jm, nets, tm = _models("triplane", use_exposure=True)
    rng = np.random.default_rng(4)
    x, d = random_rays(rng, M)
    enc = rng.standard_normal((M, 28)).astype(np.float32)
    kw = {"output_radiance": True} if mode == "radiance" else {}
    cot = rng.standard_normal((M, 3)).astype(np.float32)

    def loss_j(p, table):
        out = jm(dict(p, hash_table=table), J(x), J(d), **kw)
        return jnp.sum(out["rgbs"] * J(cot)), out["rgbs"]

    with given_encoding(), jax.disable_jit():
        (_, ref), (gp, ge) = jax.value_and_grad(loss_j, (0, 1),
                                                has_aux=True)(
            nets, J(enc, jnp.bfloat16))
    et = T(enc).to(BF).requires_grad_(True)
    tm.encode = lambda xx: et
    out = tm(T(x), T(d), **kw)
    (out["rgbs"] * T(cot)).sum().backward()
    np.testing.assert_allclose(N(out["rgbs"]), np.asarray(ref, np.float32),
                               rtol=0, atol=TOL_OUT)
    named = dict(tm.named_parameters())
    flat = {".".join(str(getattr(q, "key", q)) for q in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(gp)[0]}
    for n in ("rgb_net.w0", "rgb_net.w2", "sigma_net.w1",
              "tonemapper_net_1.w0"):
        r = flat[n]
        if mode == "radiance" and n.startswith("tonemapper"):
            assert named[n].grad is None and not r.any()
            continue
        np.testing.assert_allclose(N(named[n].grad), r, rtol=0,
                                   atol=TOL_GRAD * np.abs(r).max(), err_msg=n)
    r = np.asarray(ge, np.float32)
    np.testing.assert_allclose(N(et.grad), r, rtol=0,
                               atol=TOL_GRAD * np.abs(r).max())


@pytest.mark.parametrize("layout", ["triplane", "tcnn"])
def test_density_mode_matches_jax(layout):
    """NGPMT.density of a bf16 model (K6's density mode; its plain version
    here) against the JAX NGPMT.density on the same encoding."""
    jm, nets, tm = _models(layout)
    rng = np.random.default_rng(5)
    x = rng.uniform(-0.5, 0.5, (M, 3)).astype(np.float32)
    enc = rng.standard_normal((M, DIN[layout])).astype(np.float32)
    with given_encoding(), jax.disable_jit():
        ref = jm.density(dict(nets, hash_table=J(enc, jnp.bfloat16)), J(x))
    tm.encode = lambda xx: T(enc).to(BF)
    with torch.no_grad():
        out = tm.density(T(x))
    assert out.dtype == torch.float32 and out.shape == (M,)
    np.testing.assert_allclose(N(out), np.asarray(ref), rtol=0,
                               atol=TOL_OUT * np.abs(np.asarray(ref)).max())


def _parent_chain(plan, enc, d, ws):
    """The parent's torch chain (models/ngp_mt.py's apply_mlp, trunc_exp,
    the cat, trunc_sigmoid and the casts; the kernel's norm formula)."""
    def sub(w):
        return {f"w{i}": v for i, v in enumerate(w)}
    h = apply_mlp(sub(ws[:2]), enc, compute_dtype=BF)
    sig = trunc_exp(h[:, 0].to(torch.float32))
    dn, _ = mlp.unit_dirs(d)
    if not plan.use_dir:
        dn = dn * 0.0
    rgb = apply_mlp(sub(ws[2:5]), torch.cat([dn.to(BF), h], 1),
                    out_act=None if plan.exposure else "sigmoid",
                    compute_dtype=BF)
    raws, i = [rgb.float()], 5
    if plan.norm:
        raws.append(apply_mlp(sub(ws[i:i + 3]), h, compute_dtype=BF).float())
        i += 3
    if plan.n_cls:
        raws.append(apply_mlp(sub(ws[i:i + 3]), h, compute_dtype=BF).float())
    return sig, torch.cat(raws, 1)


PLANS = [mlp.Plan(28, 3, True, True, False), mlp.Plan(32, 0, True, True, False),
         mlp.Plan(28, 40, False, False, False), mlp.Plan(28, 0, False, True, True),
         mlp.Plan(32, 40, True, True, False)]


def _inputs(plan, seed):
    g = torch.Generator().manual_seed(seed)
    ws = [(torch.randn(s, generator=g) * 0.3).requires_grad_(True)
          for s in mlp.weight_shapes(plan)]
    enc = torch.randn((M, plan.din), generator=g).to(BF).requires_grad_(True)
    d = torch.randn((M, 3), generator=g).requires_grad_(True)
    gs = torch.randn(M, generator=g)
    gr = torch.randn((M, plan.channels), generator=g)
    return enc, d, ws, gs, gr


@pytest.mark.parametrize("plan", PLANS, ids=[str(i) for i in range(len(PLANS))])
def test_plain_backward_is_autograd_of_the_parent_chain(plan):
    """field_mlp_plain is the parent's forward bit for bit, and
    field_mlp_bwd_plain its autograd backward bit for bit (the weights'
    and the encoding's gradients), the directions' within f32 rounding."""
    enc, d, ws, gs, gr = _inputs(plan, 1)
    sig, raws = _parent_chain(plan, enc, d, ws)
    grads = torch.autograd.grad((sig * gs).sum() + (raws * gr).sum(),
                                [enc, d] + ws)
    with torch.no_grad():
        s2, r2 = mlp.field_mlp_plain(plan, enc, d, ws)
        de, dd, gw = mlp.field_mlp_bwd_plain(plan, enc, d, ws, gs, gr, True)
    assert torch.equal(s2, sig) and torch.equal(r2, raws)
    assert de.dtype == BF and torch.equal(de, grads[0])
    for a, b in zip(gw, grads[2:]):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    top = grads[1].abs().max().item()
    assert (dd - grads[1]).abs().max().item() <= 2.0 ** -20 * max(top, 1.0)


def test_wrapper_takes_plain_on_cpu():
    """field_mlp on CPU tensors is the plain version, forward and backward,
    bit for bit; the directions get a gradient only when they need one."""
    plan = PLANS[0]
    enc, d, ws, gs, gr = _inputs(plan, 2)
    sig, raws = mlp.field_mlp(plan, enc, d, ws)
    got = torch.autograd.grad((sig * gs).sum() + (raws * gr).sum(),
                              [enc, d] + ws)
    with torch.no_grad():
        s2, r2 = mlp.field_mlp_plain(plan, enc, d, ws)
        de, dd, gw = mlp.field_mlp_bwd_plain(plan, enc, d, ws, gs, gr, True)
    assert torch.equal(sig, s2) and torch.equal(raws, r2)
    assert torch.equal(got[0], de) and torch.equal(got[1], dd)
    for a, b in zip(got[2:], gw):
        assert torch.equal(a, b)
    d0 = d.detach()
    sig, raws = mlp.field_mlp(plan, enc, d0, ws)
    (raws.sum() + sig.sum()).backward()
    assert d0.grad is None and enc.grad is not None
    dens = mlp.field_density(enc, ws[:2])
    assert torch.equal(dens, s2)


def test_checks_refuse_before_launch():
    """K6's wrapper refuses (ValueError, before any launch) what the kernel
    does not take: an encoding wider than 32 or of odd width, more than 42
    classes with or without the normal head, other widths or layer counts,
    f32 or CPU tensors; a bf16 model of other widths or layer counts is
    refused when built."""
    plan = PLANS[0]
    enc, d, ws, gs, gr = _inputs(plan, 3)
    ws = [w.detach() for w in ws]
    enc = enc.detach()
    for bad, wsb in ((plan._replace(din=34), ws), (plan._replace(din=27), ws),
                     (plan._replace(n_cls=43), ws), (plan, ws[:-1]),
                     (plan, [ws[0][:, :32]] + ws[1:]),
                     (plan, [w.double() for w in ws])):
        with pytest.raises(ValueError):
            mlp.check_plan(bad, wsb)
    for n_cls in (43, 45):   # a raws row within 48 channels, as full_ok
        with pytest.raises(ValueError, match="B10d"):
            mlp.check_plan(plan._replace(n_cls=n_cls, norm=False), ws)
    with pytest.raises(ValueError, match="CUDA"):
        mlp.fwd_kernel(plan, enc, d.detach(), ws)
    with pytest.raises(ValueError, match="B10b"):
        mlp.make_args(plan, enc.float(), d.detach(), ws, False)
    _, tc = slice_configs(compute_dtype="bfloat16")
    for kw in (dict(hidden_dim=32), dict(geo_feat_dim=8),
               dict(rgb_hidden_layers=3), dict(head_hidden_layers=1)):
        with pytest.raises(ValueError, match="B10"):
            TModel(tc.model.__class__(**{**tc.model.__dict__, **kw}), CPU)


def test_convert_carries_the_nets_across():
    """convert.py carries the JAX parameters into a bf16 port model with
    K6 unchanged: every name and shape, and `mlp_weights` in K6's order
    (sigma, rgb, norm, sem) are the JAX nets' leaves."""
    jc, tc = slice_configs(compute_dtype="bfloat16")
    jm = jngp.NGPMT(jc.model)
    params = jax.tree_util.tree_map(np.asarray,
                                    jm.init(jax.random.PRNGKey(0)))
    tm = TModel(tc.model, CPU)
    tm.load_state_dict(convert_params(params, CPU))   # strict
    want = [params[n][f"w{i}"] for n in ("sigma_net", "rgb_net", "norm_net",
                                         "sem_net")
            for i in range(len(params[n]))]
    got = tm.mlp_weights()
    assert len(got) == len(want) == tm.mlp_plan().n_weights
    for g, w in zip(got, want):
        assert np.array_equal(N(g), w)
    mlp.check_plan(tm.mlp_plan(), got)


@pytest.mark.parametrize("plan", PLANS[:3], ids=["0", "1", "2"])
def test_kernel_arguments_layout(plan):
    """K6's argument struct is csrc/mlp.cu's (its static_asserts), and its
    matrices cover every weight gradient once: rgb w0's direction rows
    first, then its h rows, each gradient at its offset in NETS' order."""
    assert ctypes.sizeof(mlp._Mat) == 24
    assert ctypes.sizeof(mlp._Args) == 12 * 24 + 10 * 8 + 10 * 4
    ws = [torch.zeros(s) for s in mlp.weight_shapes(plan)]
    mats, nw = mlp.matrices(plan, ws)
    assert nw == sum(w.numel() for w in ws)
    covered = np.zeros(nw, int)
    for m in mats:
        if m is not None:
            _, row, fi, fo, off = m
            covered[off:off + fi * fo] += 1
    assert (covered == 1).all()
    assert mats[mlp.RH][4] == mats[mlp.RD][4] + 3 * mlp.WIDTH
    assert mats[mlp.RH][1] == 3 and mats[mlp.RD][2] == 3
    present = [m is not None for m in mats]
    assert present[mlp.N0] == plan.norm and present[mlp.E0] == bool(plan.n_cls)
    dens, nd = mlp.matrices(plan, ws, density=True)
    assert nd == ws[0].numel() + ws[1].numel()
    assert sum(m is not None for m in dens) == 2


def test_dw_reduce_plain_adds_in_block_order():
    """mlp_dw_reduce's plain version: the partial rows added in order from
    +0.0 in f32, then rounded once to bf16."""
    g = torch.Generator().manual_seed(6)
    part = torch.randn((132, 50), generator=g) * torch.logspace(
        -3, 3, 132)[:, None]
    want = torch.zeros(50)
    for row in part:
        want = want + row
    got = mlp.dw_reduce_plain(part)
    assert torch.equal(got, want.to(BF).float())
    split = mlp.split_grads(PLANS[0], torch.arange(
        sum(a * b for a, b in mlp.weight_shapes(PLANS[0])),
        dtype=torch.float32))
    assert [tuple(s.shape) for s in split] == mlp.weight_shapes(PLANS[0])
    assert split[1][0, 0] == PLANS[0].din * mlp.WIDTH


def test_k6_rule_sees_a_tile_dropped_or_added_twice():
    """chip_smoke.k6_rule on a weight gradient's sum over 131,040 rows
    (~1024 tiles of 128; X >= 0 as after a ReLU, dY of mean 1, so that a
    tile is ~0.1 % of every sum; the columns two decades apart, as a
    weight gradient's): the sum of the tiles' partials in
    another f32 order, rounded once to bf16, passes against the plain
    product; with one tile left out or added twice it fails on the count
    of values that differ alone, within the largest and the mean
    difference's limits."""
    g = torch.Generator().manual_seed(7)
    rows, tile = 131040, 128
    x = torch.randn((rows, 64), generator=g).abs().to(BF).float()
    dy = ((torch.randn((rows, 64), generator=g) + 1.0)
          * torch.logspace(-2, 0, 64)).to(BF).float()   # columns' scales
    ref = x.t().mm(dy).to(BF).float()
    pad = -rows % tile
    xt = torch.cat([x, x.new_zeros((pad, 64))]).view(-1, tile, 64)
    dyt = torch.cat([dy, dy.new_zeros((pad, 64))]).view(-1, tile, 64)
    part = torch.bmm(xt.transpose(1, 2), dyt)
    s = torch.zeros(64, 64)
    for p in part.flip(0):
        s = s + p
    ok, differ, *_ = chip_smoke.k6_rule(s.to(BF).float(), ref)
    assert ok and differ <= chip_smoke.K6_DIFFER * ref.numel()
    for sign in (-1.0, 1.0):
        ok, differ, most, err, tol, mean, mtol = chip_smoke.k6_rule(
            (s + sign * part[500]).to(BF).float(), ref)
        assert not ok and err <= tol and mean <= mtol
        assert differ > 4 * most
