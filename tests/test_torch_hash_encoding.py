"""tcnn hash-grid encode (kernels H7/H8's plain versions) against the JAX
package's `hash_encode_vjp` (forward `_hash_encode_fwd_impl`, backward
`_hash_vjp_bwd`, direct scatter) and its numpy oracle
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
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_kernel_wrappers_refuse_cpu_tensors():
    _, spec_t, table, x, g = _case(3)
    with pytest.raises(ValueError, match="CUDA"):
        th.encode_kernel(T(table), T(x), spec_t)
    with pytest.raises(ValueError, match="CUDA"):
        th.encode_grad_kernel(T(x), T(g), spec_t)
    with pytest.raises(NotImplementedError):
        th.hash_encode(T(table), T(x), spec_t, need_dx=True)
