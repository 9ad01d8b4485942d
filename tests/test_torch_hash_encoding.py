"""tcnn hash-grid encode (kernels H7/H8's and H14's plain versions)
against the JAX package's `hash_encode_vjp` (forward
`_hash_encode_fwd_impl`, backward `_hash_vjp_bwd`, direct scatter, with
need_dx its position gradient) and its numpy oracle
`hash_encode_reference_np`.

The JAX reference runs eagerly (`jax.disable_jit()`), so that
x*scale + 0.5 is rounded after the product, as the port and the oracle
do (XLA may fuse it into an FMA when it compiles).

Inputs: 16 levels at the bench's per-level scale with a 2^12-row table
per level (level 0 dense, 1-15 hashed), random points plus points on the
cell faces of every level and at 0 and 1.

Tolerances (f32): forward rtol 1e-5, atol 1e-6 (the same products, the
8 corner terms summed in another order); table gradients atol 1e-5 of
the largest entry (sums scattered in another order).

Also: the row pairs of `level_corners` that H7 loads as one float4, and
the smoke's model of the lines and sectors each warp load of H7 touches
(`chip_smoke.hash_grid_warp_loads`), on hand-built warps.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import chip_smoke

from test_torch_brick_hash import BENCH_B, face_points
from test_torch_common import J, N, T

from normal_clustering_nerf_torch.models import hash_encoding as th
from normal_clustering_nerf_tpu.models import hash_encoding as jh


def _case(seed, M=520):
    kw = dict(n_levels=16, log2_table_size=12, per_level_scale=BENCH_B)
    spec_j, spec_t = jh.HashGridSpec.create(**kw), th.HashGridSpec.create(**kw)
    rng = np.random.default_rng(seed)
    table = rng.standard_normal(spec_t.table_shape()).astype(np.float32)
    x = face_points(rng, spec_t, M)
    g = rng.standard_normal((M, spec_t.out_dim)).astype(np.float32)
    return spec_j, spec_t, table, x, g


@pytest.mark.parametrize("log2_T,b", [(19, BENCH_B), (12, BENCH_B),
                                      (12, 1.3819)])
def test_spec_matches_jax(log2_T, b):
    kw = dict(n_levels=16, log2_table_size=log2_T, per_level_scale=b)
    sj, st = jh.HashGridSpec.create(**kw), th.HashGridSpec.create(**kw)
    assert tuple(st) == tuple(sj)
    assert st.table_shape() == (sj.total_rows, sj.n_features)
    if (log2_T, b) == (19, BENCH_B):
        assert st.dense == (True,) * 6 + (False,) * 10
        assert st.total_rows == 5_710_032


def test_forward_matches_jax_and_numpy_oracle():
    spec_j, spec_t, table, x, _ = _case(0)
    assert any(spec_t.dense) and not all(spec_t.dense)
    with jax.disable_jit():
        ref = np.asarray(jh.hash_encode_vjp(J(table), J(x), spec_j))
    oracle = jh.hash_encode_reference_np(table, x, spec_j)
    out = N(th.hash_encode(T(table), T(x), spec_t))
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out, oracle, rtol=1e-5, atol=1e-6)


def test_compute_dtype_rounds_the_f32_blend():
    spec_j, spec_t, table, x, _ = _case(1)
    with jax.disable_jit():
        ref = np.asarray(jh.hash_encode(J(table), J(x), spec_j,
                                        jnp.bfloat16), np.float32)
    out = th.hash_encode(T(table), T(x), spec_t, torch.bfloat16)
    assert out.dtype == torch.bfloat16
    f32 = th.encode_plain(T(table), T(x), spec_t)
    np.testing.assert_array_equal(N(out), N(f32.to(torch.bfloat16)))
    # one bf16 ulp (2^-7 relative), as in test_torch_brick_hash.py
    np.testing.assert_allclose(N(out), ref, rtol=2 ** -7, atol=1e-6)


def test_table_gradient_matches_jax_vjp():
    spec_j, spec_t, table, x, g = _case(2)
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda t: jh.hash_encode_vjp(t, J(x), spec_j),
                         J(table))
        ref = np.asarray(vjp(J(g))[0])
    tab = T(table).requires_grad_(True)
    th.hash_encode(tab, T(x), spec_t).backward(T(g))
    np.testing.assert_allclose(N(tab.grad), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    assert np.count_nonzero(ref) > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_position_gradients_match_jax(dtype):
    """The position gradient (H14's plain version, through
    `hash_encode(need_dx=True)`) against `jax.vjp` of the eager JAX
    `hash_encode(need_dx=True)` in the same compute dtype, the cotangent in
    it, on `face_points` (cell faces, stride-3 brick faces, x = 0 and 1,
    where the corners clamp). Tolerance: 1e-5 of the largest |dx|: the
    same products, JAX summing by einsum, the levels in another order."""
    spec_j, spec_t, table, x, g = _case(4)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda xx: jh.hash_encode(J(table), xx, spec_j, jdt,
                                                need_dx=True), J(x))
        ref = np.asarray(vjp(J(g, jdt))[0])
    xt = T(x).requires_grad_(True)
    th.hash_encode(T(table), xt, spec_t, dtype, need_dx=True).backward(
        T(g).to(dtype))
    np.testing.assert_allclose(N(xt.grad), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    gf = T(g).to(dtype).to(torch.float32)
    np.testing.assert_array_equal(
        N(th.encode_dx_plain(T(table), T(x), gf, spec_t)), N(xt.grad))


def test_kernel_wrappers_refuse_cpu_tensors():
    _, spec_t, table, x, g = _case(3)
    with pytest.raises(ValueError, match="CUDA"):
        th.encode_kernel(T(table), T(x), spec_t)
    with pytest.raises(ValueError, match="CUDA"):
        th.encode_grad_kernel(T(x), T(g), spec_t)
    with pytest.raises(ValueError, match="CUDA"):
        th.encode_dx_kernel(T(table), T(x), T(g), spec_t)


@settings(max_examples=25, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16))
def test_level_corners_pair_rows_as_h7_loads_them(seed):
    """H7 loads a corner pair as one float4 when both rows lie in one
    aligned row pair: at a hashed level the x neighbours from an even ix
    are rows h and h ^ 1 (x's prime is 1); at a dense level the z
    neighbours are rows r and r + 1, or r twice where iz + 1 is clipped.
    Both need level offsets that are multiples of 8 (of 2 at least)."""
    spec = th.HashGridSpec.create(n_levels=16, log2_table_size=19,
                                  per_level_scale=BENCH_B)
    assert all(o % 8 == 0 for o in spec.level_offsets)
    x = T(face_points(np.random.default_rng(seed), spec, 300))
    for l in range(spec.n_levels):
        rows, _ = th.level_corners(x, spec, l)
        res = spec.resolutions[l]
        p0 = torch.floor(x * torch.tensor(spec.scales[l], dtype=torch.float32)
                         + 0.5).to(torch.int64)
        lo, hi = (torch.clamp(p0 + d, 0, res - 1) for d in (0, 1))
        if spec.dense[l]:
            z_clipped = hi[:, 2] == lo[:, 2]
            for c in (0, 2, 4, 6):
                want = torch.where(z_clipped, rows[:, c], rows[:, c] + 1)
                assert torch.equal(rows[:, c + 1], want)
        else:
            even = (lo[:, 0] % 2 == 0) & (hi[:, 0] == lo[:, 0] + 1)
            assert even.any()
            for c in range(4):
                assert torch.equal(rows[even, c + 4], rows[even, c] ^ 1)


def test_warp_load_counter_on_hand_built_warps():
    # one float2 row in every lane: 1 line, 1 sector an instruction
    one = torch.full((3, 32), 8 * 1001, dtype=torch.int64)
    act = torch.ones((3, 32), dtype=torch.bool)
    assert chip_smoke.distinct_per_instruction(one, act) == (3, 3)
    # 32 rows in 32 lines; 32 consecutive float2 rows: 2 lines, 8 sectors
    far = torch.arange(32, dtype=torch.int64)[None] * 4096
    near = torch.arange(32, dtype=torch.int64)[None] * 8
    assert chip_smoke.distinct_per_instruction(far, act[:1]) == (32, 32)
    assert chip_smoke.distinct_per_instruction(near, act[:1]) == (2, 8)
    # masked lanes touch nothing
    part = act[:1].clone()
    part[0, 1:] = False
    assert chip_smoke.distinct_per_instruction(far, part) == (1, 1)
    # a ragged tile: 33 samples of one dense level, all in one cell whose
    # z pairs are aligned (rows 8c, 8c + 1), so no float2 load is live
    rows = (8 * torch.arange(4).repeat_interleave(2)
            + torch.arange(8) % 2).expand(33, 1, 8)
    a, m = chip_smoke.hash_grid_warp_loads(rows, (True,), "tile")
    assert a.shape == (2 * 8, 32)   # 2 tiles x (4 float4 + 4 float2)
    assert int(m.any(1).sum()) == 8
    assert chip_smoke.distinct_per_instruction(a, m) == (8, 8)
    a, m = chip_smoke.hash_grid_warp_loads(rows, (True,), "thread")
    assert int(m.any(1).sum()) == 16   # 2 warps (32 + 1 threads) x 8
    assert chip_smoke.distinct_per_instruction(a, m) == (16, 16)
    # a hashed level pairs the x neighbours (corners c, c + 4): rows 2k
    # and 2k + 1 share a float4, rows 2k + 1 and 2k + 2 do not
    rows = torch.tensor([0, 2, 4, 6, 1, 3, 5, 7]).expand(32, 1, 8)
    a, m = chip_smoke.hash_grid_warp_loads(rows, (False,), "tile")
    assert int(m.any(1).sum()) == 4
    rows = torch.tensor([1, 3, 5, 7, 2, 4, 6, 8]).expand(32, 1, 8)
    a, m = chip_smoke.hash_grid_warp_loads(rows, (False,), "tile")
    assert int(m.any(1).sum()) == 8
