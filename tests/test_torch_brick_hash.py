"""Brick-hash encode (kernels H5/H6's and H13's plain versions: H13 is
H5's Jacobian and its contraction) against
the JAX package's `brick_encode_vjp` (forward `_brick_encode_impl`,
backward `_brick_vjp_bwd`, with need_dx its position gradient) and its
numpy oracle `brick_encode_reference_np`.

The JAX reference runs eagerly (`jax.disable_jit()`): its forward and
backward are `lax.scan`s, whose compiled body XLA evaluates x*scale + 0.5
as an FMA; at a stride-3 brick face a one-ulp move of floor(pos) picks
another brick's copy of the face vertex, a real jump in value (the eager
JAX, the numpy oracle and the port all round the product first).

Inputs: 16 levels at the bench's per-level scale with 2^8 bricks a level
(level 0 dense, 1-15 hashed), random points plus points on the cell faces
of every level, on stride-3 brick faces, and at 0 and 1.

Tolerances (f32): forward rtol 1e-5, atol 1e-6 (the same products, the
8 corner terms summed in another order: JAX folds 128 lanes, zeros
included, with a matmul); table gradients atol 1e-5 of the largest entry
(up to a few hundred terms per entry, scattered in another order).

Also H5's load geometry (hypothesis: a corner's z pair lies in one
32-byte sector, one aligned float4 exactly when lz0 is even) and the
smoke's model of H5's warp loads (`chip_smoke.hash_grid_warp_loads` on
`brick_slots`, counted per instruction and per warp) on hand-built warps.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke
from test_torch_common import J, N, T

from normal_clustering_nerf_torch.models import brick_hash as tb
from normal_clustering_nerf_tpu.models import brick_hash as jb

BENCH_B = math.exp(math.log(2048 * 0.5 / 16) / 15)   # bench per_level_scale


def face_points(rng, spec, M):
    """M points in [0, 1]^3: random, then one coordinate of 8 points per
    level on that level's cell faces (pos = x*scale + 0.5 an integer up
    to f32 rounding), 8 per level on stride-3 brick faces, and the
    corners of the box."""
    x = rng.random((M, 3)).astype(np.float32)
    i = 0
    for l in range(spec.n_levels):
        s, res = np.float32(spec.scales[l]), spec.resolutions[l]
        for n in (rng.integers(1, res, 8), 3 * rng.integers(1, res // 3, 8)):
            x[i:i + 8, rng.integers(0, 3)] = np.clip(
                ((n - 0.5) / s).astype(np.float32), 0.0, 1.0)
            i += 8
    x[i:i + 4] = [[0, 0, 0], [1, 1, 1], [0, 1, 0.5], [1, 0, 1]]
    assert i + 4 <= M
    return x


def _case(seed, M=520):
    kw = dict(n_levels=16, log2_bricks=8, per_level_scale=BENCH_B)
    spec_j, spec_t = jb.BrickGridSpec.create(**kw), tb.BrickGridSpec.create(**kw)
    rng = np.random.default_rng(seed)
    table = rng.standard_normal(spec_t.table_shape()).astype(np.float32)
    x = face_points(rng, spec_t, M)
    g = rng.standard_normal((M, spec_t.out_dim)).astype(np.float32)
    return spec_j, spec_t, table, x, g


@pytest.mark.parametrize("log2_bricks,b", [(13, BENCH_B), (8, BENCH_B),
                                           (8, 2.0)])
def test_spec_matches_jax(log2_bricks, b):
    """Level constants bit for bit: at the bench scale s lands on 63.0,
    255.0 and 1023.0 at levels 5, 10 and 15, where a float32 recomputation
    could flip ceil(s) and change res, nb and dense."""
    kw = dict(n_levels=16, log2_bricks=log2_bricks, per_level_scale=b)
    sj, st = jb.BrickGridSpec.create(**kw), tb.BrickGridSpec.create(**kw)
    assert tuple(st) == tuple(sj)
    assert st.table_shape() == sj.table_shape()
    if (log2_bricks, b) == (13, BENCH_B):
        assert st.dense == (True,) * 5 + (False,) * 11
        assert st.resolutions[0] == 16 and st.resolutions[-1] == 1024


def test_forward_matches_jax_and_numpy_oracle():
    spec_j, spec_t, table, x, _ = _case(0)
    assert any(spec_t.dense) and not all(spec_t.dense)
    with jax.disable_jit():
        ref = np.asarray(jb.brick_encode_vjp(J(table), J(x), spec_j))
    oracle = jb.brick_encode_reference_np(table, x, spec_j)
    out = N(tb.brick_encode(T(table), T(x), spec_t))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, oracle, rtol=1e-5, atol=1e-6)


def test_compute_dtype_rounds_the_f32_fold():
    spec_j, spec_t, table, x, _ = _case(1)
    with jax.disable_jit():
        ref = np.asarray(jb.brick_encode(J(table), J(x), spec_j,
                                         jnp.bfloat16), np.float32)
    out = tb.brick_encode(T(table), T(x), spec_t, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    f32 = tb.encode_plain(T(table), T(x), spec_t)
    np.testing.assert_array_equal(N(out), N(f32.to(torch.bfloat16)))
    # f32 values that agree to f32 rounding may round to neighbouring
    # bf16 values: one bf16 ulp, 2^-7 relative
    np.testing.assert_allclose(N(out), ref, rtol=2 ** -7, atol=1e-6)


def test_table_gradient_matches_jax_vjp():
    spec_j, spec_t, table, x, g = _case(2)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda t: jb.brick_encode_vjp(t, J(x), spec_j),
                         J(table))
        ref = np.asarray(vjp(J(g))[0])
    tab = T(table).requires_grad_(True)
    tb.brick_encode(tab, T(x), spec_t).backward(T(g))
    np.testing.assert_allclose(N(tab.grad), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert np.count_nonzero(ref) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_position_gradients_match_jax(dtype):
    """The position gradient (H13's plain version, through
    `brick_encode(need_dx=True)`) against `jax.vjp` of the eager JAX
    `brick_encode(need_dx=True)` in the same compute dtype, the cotangent in
    it, on `face_points` (cell faces, stride-3 brick faces, x = 0 and 1,
    where the corners clamp). Tolerance: 1e-5 of the largest |dx|: the
    same products, JAX folding the 64 slots (zeros included) by einsum, the levels in another order."""
    spec_j, spec_t, table, x, g = _case(4)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda xx: jb.brick_encode(J(table), xx, spec_j, jdt,
                                                need_dx=True), J(x))
        ref = np.asarray(vjp(J(g, jdt))[0])
    xt = T(x).requires_grad_(True)
    tb.brick_encode(T(table), xt, spec_t, dtype, need_dx=True).backward(
        T(g).to(dtype))
    np.testing.assert_allclose(N(xt.grad), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    gf = T(g).to(dtype).to(torch.float32)
    np.testing.assert_array_equal(
        N(tb.encode_dx_plain(T(table), T(x), gf, spec_t)), N(xt.grad))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_jacobian_columns_are_jax_vjps_of_one_hot_cotangents(dtype):
    """The plain Jacobian (what H5 writes when x needs a gradient): its
    column j, d out_j / dx (M, 3), against `jax.vjp` of the eager JAX
    `brick_encode(need_dx=True)` in the compute dtype under the one-hot
    cotangent e_j (1 on feature j of every sample, exact in bf16), on
    `face_points` (cell faces, stride-3 brick faces, x = 0 and 1).
    Tolerance: 1e-5 of the column's largest |dx| (the same products; JAX
    dots each slot with the cotangent first and folds the 64 slots, zeros
    included, by einsum)."""
    spec_j, spec_t, table, x, _ = _case(6, M=260)
    M, D = x.shape[0], spec_t.out_dim
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda xx: jb.brick_encode(J(table), xx, spec_j, jdt,
                                                need_dx=True), J(x))
        ref = np.stack([np.asarray(vjp(jnp.broadcast_to(e, (M, D)))[0])
                        for e in jnp.eye(D, dtype=jdt)])
    jac = N(tb.encode_jacobian_plain(T(table), T(x), spec_t)).reshape(M, D, 3)
    assert np.abs(ref).max() > 0
    for j in range(D):
        np.testing.assert_allclose(jac[:, j], ref[j], rtol=0,
                                   atol=1e-5 * np.abs(ref[j]).max(),
                                   err_msg=f"column {j}")
    # the autograd path saves this Jacobian and contracts it
    xt = T(x).requires_grad_(True)
    tb.brick_encode(T(table), xt, spec_t, dtype, need_dx=True).backward(
        torch.ones((M, D), dtype=dtype))
    np.testing.assert_array_equal(N(xt.grad), N(tb.contract_plain(
        T(jac.reshape(M, -1)), torch.ones((M, D)))))


def test_kernel_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers take CUDA tensors only, and
    `brick_encode` picks them by the tensor's device."""
    _, spec_t, table, x, g = _case(3)
    jac = torch.zeros((x.shape[0], 3 * spec_t.out_dim))
    with pytest.raises(ValueError, match="CUDA"):
        tb.encode_kernel(T(table), T(x), spec_t)
    with pytest.raises(ValueError, match="CUDA"):
        tb.encode_grad_kernel(T(x), T(g), spec_t)
    with pytest.raises(ValueError, match="CUDA"):
        tb.encode_jac_kernel(T(table), T(x), spec_t)
    with pytest.raises(ValueError, match="CUDA"):
        tb.contract_kernel(jac, T(g), spec_t)


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16))
def test_z_pairs_lie_in_one_sector(seed):
    """H5 reads each (x, y) corner's z pair (corners 2k, 2k + 1) from one
    32-byte sector of its 512-byte row: slot = lx*16 + ly*4 + lz, so
    (lx*16 + ly*4)*8 bytes is a multiple of 32. The pair is one aligned
    float4 (both slots in slot pair a >> 1) exactly when lz0 is even or
    the corner sits on the top face (one slot); when lz0 = 1 the second
    slot is the next float4's, still in the same sector."""
    spec = tb.BrickGridSpec.create(n_levels=16, log2_bricks=13,
                                   per_level_scale=BENCH_B)
    x = T(face_points(np.random.default_rng(seed), spec, 300))
    for l in range(spec.n_levels):
        _, slots, _ = tb.level_geometry(x, spec, l)
        for k in range(4):
            a, b = slots[:, 2 * k], slots[:, 2 * k + 1]
            assert torch.equal(a // 4, b // 4)           # one sector
            lz0, top = a % 4, b == a
            assert bool(((lz0 <= 2) & (top | (b == a + 1))).all())
            assert torch.equal(a // 2 == b // 2, (lz0 % 2 == 0) | top)


def test_brick_warp_load_model_on_hand_built_warps():
    L = 1
    # 33 samples (a ragged tile: the second tile has one live lane), all
    # in one cell whose z pairs straddle a float4 (lz0 = 1): slots 1, 2 of
    # each (x, y) corner, in sectors 0, 1, 4, 5 and lines 0, 1 of row 0
    cell = torch.tensor([1, 2, 5, 6, 17, 18, 21, 22])
    slots = cell.expand(33, L, 8)
    a, m = chip_smoke.hash_grid_warp_loads(slots, (True,) * L, "tile")
    assert a.shape == (2 * 8, 32)    # 2 tiles x (4 float4 + 4 float2)
    assert int(m.any(1).sum()) == 16   # every float2 live
    assert int(m[8:].sum()) == 8       # the second tile: one lane
    assert chip_smoke.distinct_per_instruction(a, m) == (16, 16)
    # each warp: 2 lines and 4 sectors across its 8 loads
    assert chip_smoke.distinct_per_warp(a, m) == (4, 8)
    a, m = chip_smoke.hash_grid_warp_loads(slots, (True,) * L, "thread")
    assert int(m.any(1).sum()) == 16   # 2 warps (32 + 1 threads) x 8
    assert chip_smoke.distinct_per_instruction(a, m) == (16, 16)
    assert chip_smoke.distinct_per_warp(a, m) == (4, 8)
    # lz0 even (0) and the top face (lz0 = lz1 = 2): no float2 is live
    for cell in ([0, 1, 4, 5, 16, 17, 20, 21], [2, 2, 6, 6, 18, 18, 22, 22]):
        a, m = chip_smoke.hash_grid_warp_loads(
            torch.tensor(cell).expand(32, L, 8), (True,) * L, "tile")
        assert int(m.any(1).sum()) == 4
        assert chip_smoke.distinct_per_instruction(a, m) == (4, 4)
        assert chip_smoke.distinct_per_warp(a, m) == (2, 4)
    # 32 samples in 32 rows 4 KB apart, lz0 = 1: the thread mapping's
    # warp is 2 samples x 16 levels; each tile load touches 32 sectors,
    # the tile's warp 4 sectors a sample, as the thread's
    rows = (torch.arange(32) * 512)[:, None, None]
    slots = (rows + torch.tensor([1, 2, 5, 6, 17, 18, 21, 22])).expand(
        32, L, 8)
    a, m = chip_smoke.hash_grid_warp_loads(slots, (True,) * L, "tile")
    assert chip_smoke.distinct_per_instruction(a, m) == (8 * 32, 8 * 32)
    assert chip_smoke.distinct_per_warp(a, m) == (2 * 32, 4 * 32)
    a, m = chip_smoke.hash_grid_warp_loads(slots, (True,) * L, "thread")
    assert chip_smoke.distinct_per_instruction(a, m) == (8 * 32, 8 * 32)
    assert chip_smoke.distinct_per_warp(a, m) == (2 * 32, 4 * 32)
    # a masked lane touches nothing
    part = m.clone()
    part[:, 1:] = False
    assert chip_smoke.distinct_per_warp(a, part) == (2, 4)
    # the counts of a real encode: per warp never above per instruction
    spec = tb.BrickGridSpec.create(n_levels=4, log2_bricks=8,
                                   per_level_scale=BENCH_B)
    x = T(face_points(np.random.default_rng(5), spec, 100))
    counts = chip_smoke.warp_load_counts("brick", x, spec)
    assert counts["M"] == 100
    for mapping in ("thread", "tile"):
        i, ln, sec, wln, wsec = counts[mapping]
        assert wln <= ln and wsec <= sec and 0 < wsec <= 4 * 4 * 100
