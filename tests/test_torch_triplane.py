"""Triplane encode (kernel H2's plain versions, and H12's: the Jacobian
H2's forward writes and its contraction in H2's backward) against the JAX
package's `triplane_encode_vjp` (forward `_encode_impl`, backward
`_tp_bwd`, with need_dx its position gradient) and its numpy oracle
`triplane_encode_reference_np`.

Tolerances:
  * f32 forward and table gradients: rtol 1e-5, atol 1e-6 — the same
    products, summed in another order (4/8 corner terms here, 16/64
    slots with zeros in JAX);
  * bf16 forward: the same bf16-rounded products, so the same bound;
  * bf16 table gradients: JAX scatter-adds in bf16 (one bf16 rounding per
    add, ~2^-8 relative each) while the port accumulates in f32, so the
    two differ by bf16 accumulation error: atol 2e-2 of the largest
    gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_common import J, N, T

from normal_clustering_nerf_torch.models import triplane as tt
from normal_clustering_nerf_tpu.models import triplane as jt


def _case(seed, res=(32, 16), M=600):
    spec_j = jt.TriplaneSpec.create(plane_res=res[0], grid3d_res=res[1])
    spec_t = tt.TriplaneSpec.create(plane_res=res[0], grid3d_res=res[1])
    rng = np.random.default_rng(seed)
    shapes = spec_t.param_shapes()
    params = {k: rng.standard_normal(v).astype(np.float32)
              for k, v in shapes.items()}
    x = rng.random((M, 3)).astype(np.float32)
    x[:6] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1], [0.5, 0.5, 0.5],
             [1 / 3, 2 / 3, 1]]                 # box faces and corners
    g = rng.standard_normal((M, spec_t.out_dim)).astype(np.float32)
    return spec_j, spec_t, params, x, g


def _tparams(params):
    return {k: T(v).requires_grad_(True) for k, v in params.items()}


@pytest.mark.parametrize("res", [(32, 16), (65, 17)])
def test_forward_matches_jax_and_numpy_oracle(res):
    spec_j, spec_t, params, x, _ = _case(0, res)
    ref = np.asarray(jt.triplane_encode_vjp(
        {k: J(v) for k, v in params.items()}, J(x), spec_j))
    oracle = jt.triplane_encode_reference_np(params, x, spec_j)
    out = N(tt.triplane_encode(_tparams(params), T(x), spec_t))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, oracle, rtol=1e-5, atol=1e-6)


def test_forward_bf16_rows_match_jax():
    spec_j, spec_t, params, x, _ = _case(1)
    ref = np.asarray(jt.triplane_encode_vjp(
        {k: J(v) for k, v in params.items()}, J(x), spec_j, False,
        jnp.bfloat16))
    out = tt.encode_plain(T(params["planes"]), T(params["grid3d"]), T(x),
                          spec_t, bf16=True)
    np.testing.assert_allclose(N(out), ref, rtol=1e-5, atol=1e-6)
    # and the compute-dtype output is that, rounded to bf16
    enc = tt.triplane_encode(_tparams(params), T(x), spec_t, torch.bfloat16)
    assert enc.dtype == torch.bfloat16
    np.testing.assert_array_equal(N(enc), N(out.to(torch.bfloat16)))


@pytest.mark.parametrize("bf16", [False, True])
def test_table_gradients_match_jax_vjp(bf16):
    spec_j, spec_t, params, x, g = _case(2)
    table = jnp.bfloat16 if bf16 else jnp.float32
    _, vjp = jax.vjp(lambda p: jt.triplane_encode_vjp(p, J(x), spec_j,
                                                      False, table),
                     {k: J(v) for k, v in params.items()})
    ref = vjp(J(g))[0]
    tp = _tparams(params)
    out = tt.TriplaneEncode.apply(tp["planes"], tp["grid3d"], T(x), spec_t,
                                  torch.bfloat16 if bf16 else torch.float32)
    out.backward(T(g).to(out.dtype))
    for k in ("planes", "grid3d"):
        r = np.asarray(ref[k], np.float32)
        if bf16:
            np.testing.assert_allclose(N(tp[k].grad), r,
                                       atol=2e-2 * np.abs(r).max(), err_msg=k)
        else:
            np.testing.assert_allclose(N(tp[k].grad), r, rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def _face_points(rng, spec, x):
    """x with one coordinate of 64 rows each on a plane cell face
    (x*(R_p-1) an integer up to f32 rounding), a stride-3 plane brick
    face, a grid3d cell face and a stride-3 grid3d brick face; the first
    6 rows (the box's faces and corners, x = 1.0 where the clip holds)
    kept."""
    i = 6
    for res in (spec.plane_res, spec.grid3d_res):
        for n in (rng.integers(0, res, 64), 3 * rng.integers(0, res // 3, 64)):
            x[i:i + 64, rng.integers(0, 3)] = (n / (res - 1)).astype(
                np.float32)
            i += 64
    return x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_position_gradients_match_jax(dtype):
    """The position gradient (H12's plain version, through
    `triplane_encode(need_dx=True)`) against `jax.vjp` of the JAX
    `triplane_encode(need_dx=True)` in the same compute dtype, the
    cotangent in it (bf16: read as bf16, widened exactly), on random
    points, cell and brick faces and the box's faces (x = 1.0, where the
    clip gets no derivative). Tolerance: 1e-5 of the largest |dx|: the
    same products, JAX summing 16 / 64 slots (zeros included) by einsum
    in another order."""
    spec_j, spec_t, params, x, g = _case(3)
    x = _face_points(np.random.default_rng(13), spec_t, x)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(lambda xx: jt.triplane_encode(
        {k: J(v) for k, v in params.items()}, xx, spec_j, jdt,
        need_dx=True), J(x))
    ref = np.asarray(vjp(J(g, jdt))[0])
    xt = T(x).requires_grad_(True)
    out = tt.triplane_encode(_tparams(params), xt, spec_t, dtype,
                             need_dx=True)
    out.backward(T(g).to(dtype))
    np.testing.assert_allclose(N(xt.grad), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert np.abs(ref).min() < np.abs(ref).max()
    # the plain version itself, on the cotangent the autograd passed
    gf = T(g).to(dtype).to(torch.float32)
    np.testing.assert_array_equal(
        N(tt.encode_dx_plain(T(params["planes"]), T(params["grid3d"]),
                             T(x), gf, spec_t)), N(xt.grad))


def test_bf16_output_matches_jax_triplane_encode():
    """The compute-dtype output under bf16 (what H2 writes, and what the
    plain version's f32 sum rounds to) against the JAX encode with
    compute_dtype bf16, eager: within one bf16 ulp."""
    spec_j, spec_t, params, x, _ = _case(4)
    with jax.disable_jit():
        ref = jt.triplane_encode({k: J(v) for k, v in params.items()}, J(x),
                                 spec_j, compute_dtype=jnp.bfloat16)
    assert ref.dtype == jnp.bfloat16
    out = tt.triplane_encode(_tparams(params), T(x), spec_t, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    # adjacent bf16 values of one sign have adjacent bit patterns (-0 as +0)
    bits = [torch.where(t == 0, 0, t.view(torch.int16).to(torch.int32))
            for t in (out, T(np.asarray(ref, np.float32), torch.bfloat16))]
    assert int((bits[0] - bits[1]).abs().max()) <= 1


def jacobian_columns(jac, spec):
    """The plain Jacobian (M, 60) as (M, out_dim, 3): output feature j's
    derivatives along x, y, z (0 along the axis a plane does not span)."""
    Fp, Fg = spec.plane_feats, spec.grid3d_feats
    full = np.zeros((jac.shape[0], spec.out_dim, 3), np.float32)
    for p, axes in enumerate(tt.PLANES):
        for f in range(Fp):
            for k, a in enumerate(axes):
                full[:, p * Fp + f, a] = jac[:, p * 2 * Fp + 2 * f + k]
    for f in range(Fg):
        full[:, 3 * Fp + f] = jac[:, 6 * Fp + 3 * f:6 * Fp + 3 * f + 3]
    return full


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jacobian_columns_are_jax_vjps_of_one_hot_cotangents(dtype):
    """The plain Jacobian (what H2's forward writes when x needs a
    gradient): its column j, d out_j / dx (M, 3), against `jax.vjp` of
    the JAX `triplane_encode(need_dx=True)` in the compute dtype under the
    one-hot cotangent e_j (1 on feature j of every sample, exact in bf16),
    on random points, cell and brick faces and the box's faces.
    Tolerance: 1e-5 of the column's largest |dx| (the same products; JAX
    dots each corner's values with the cotangent first and sums 16 / 64
    slots by einsum)."""
    spec_j, spec_t, params, x, _ = _case(6)
    x = _face_points(np.random.default_rng(17), spec_t, x)
    M, D = x.shape[0], spec_t.out_dim
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    _, vjp = jax.vjp(lambda xx: jt.triplane_encode(
        {k: J(v) for k, v in params.items()}, xx, spec_j, jdt,
        need_dx=True), J(x))
    ref = np.asarray(jax.vmap(lambda e: vjp(
        jnp.broadcast_to(e, (M, D)))[0])(jnp.eye(D, dtype=jdt)))
    jac = tt.encode_jacobian_plain(T(params["planes"]), T(params["grid3d"]),
                                   T(x), spec_t)
    assert jac.shape == (M, tt.jac_width(spec_t))
    full = jacobian_columns(N(jac), spec_t)
    assert np.abs(ref).max() > 0
    for j in range(D):
        np.testing.assert_allclose(full[:, j], ref[j], rtol=0,
                                   atol=1e-5 * np.abs(ref[j]).max(),
                                   err_msg=f"column {j}")
    # the autograd path saves this Jacobian and contracts it
    xt = T(x).requires_grad_(True)
    tt.triplane_encode(_tparams(params), xt, spec_t, dtype,
                       need_dx=True).backward(torch.ones((M, D), dtype=dtype))
    np.testing.assert_array_equal(N(xt.grad), N(tt.contract_plain(
        jac, torch.ones((M, D)), spec_t)))


def test_kernel_wrappers_refuse_cpu_tensors():
    _, spec_t, params, x, g = _case(5, M=8)
    planes, grid3d = T(params["planes"]), T(params["grid3d"])
    jac = torch.zeros((x.shape[0], tt.jac_width(spec_t)))
    for out_dtype in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA"):
            tt.encode_kernel(planes, grid3d, T(x), spec_t, True, out_dtype)
        with pytest.raises(ValueError, match="CUDA"):
            tt.encode_jac_kernel(planes, grid3d, T(x), spec_t, True,
                                 out_dtype)
    with pytest.raises(ValueError, match="CUDA"):
        tt.encode_grad_kernel(T(x), T(g), spec_t, planes.shape, grid3d.shape)
    with pytest.raises(ValueError, match="CUDA"):
        tt.encode_grad_dx_kernel(T(x), T(g), jac, spec_t, planes.shape,
                                 grid3d.shape)


def test_warp_load_counter_on_hand_built_warps():
    # H2's lanes of 33 samples (a ragged last warp), 4 tables x 32 terms
    lanes = (torch.arange(4)[:, None] * 4096
             + torch.arange(32)[None, :]).expand(33, 4, 32)
    # a warp a (sample, table): 32 consecutive floats, 1 line, 4 sectors
    a, m = chip_smoke.triplane_warp_loads(lanes, "tile")
    assert a.shape == (33 * 4, 32) and bool(m.all())
    assert chip_smoke.distinct_per_instruction(a, m) == (33 * 4, 33 * 16)
    # a thread a sample: 2 warps x 128 loads, every lane on one value
    a, m = chip_smoke.triplane_warp_loads(lanes, "thread")
    assert int(m.any(1).sum()) == 2 * 128
    assert chip_smoke.distinct_per_instruction(a, m) == (256, 256)
    # and 32 samples in 32 rows: every thread-mapped load touches 32 lines
    rows = (torch.arange(32)[:, None, None] * 512 + lanes[:32])
    a, m = chip_smoke.triplane_warp_loads(rows, "thread")
    assert chip_smoke.distinct_per_instruction(a, m) == (128 * 32,
                                                         128 * 32)
