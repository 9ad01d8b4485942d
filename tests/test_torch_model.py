"""NGP-MT field of the port (MLPs, and the triplane (kernel H2), brick
(H5/H6) or tcnn (H7/H8) encoding) against the JAX package's NGPMT, with
the JAX parameters carried across by `convert.py`: density, the full
multi-head call, and every parameter's gradient. The brick and tcnn
tables are cut to 2^8 bricks / 2^12 rows a level (16 levels at the bench
scale). The JAX reference runs eagerly (`jax.disable_jit()`), so that the
brick encode's `lax.scan` rounds x*scale + 0.5 as the port does (see
test_torch_brick_hash.py).

Tolerances:
  * f32: outputs rtol 1e-5, atol 1e-6; gradients rtol 1e-4 with atol
    1e-6 of the largest gradient (sums in another order through three
    MLP layers and the table scatter);
  * bf16 compute: each layer's output is rounded to bf16 (8-bit
    mantissa) and XLA and torch may round a hidden unit differently, so
    outputs agree to atol 3e-2 and gradients to atol 5e-2 of the
    largest gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, J, N, T, random_rays, slice_configs

from normal_clustering_nerf_torch.convert import convert_params
from normal_clustering_nerf_torch.models.ngp_mt import NGPMT as TModel
from normal_clustering_nerf_tpu.models.ngp_mt import NGPMT as JModel


LAYOUTS = {"triplane": {}, "brick": dict(log2_bricks=8),
           "tcnn": dict(log2_hashmap_size=12)}


def _models(dtype, layout="triplane"):
    jc, tc = slice_configs(compute_dtype=dtype, hash_layout=layout,
                           **LAYOUTS[layout])
    jm = JModel(jc.model)
    params = jm.init(jax.random.PRNGKey(0))
    # tables well away from their tiny init, so the field is not flat
    params["hash_table"] = jax.tree_util.tree_map(
        lambda p: 0.5 * jax.random.normal(jax.random.PRNGKey(1), p.shape),
        params["hash_table"])
    tm = TModel(tc.model, CPU)
    tm.load_state_dict(convert_params(
        jax.tree_util.tree_map(np.asarray, params), CPU))
    return jm, params, tm


TOL = {"float32": dict(out=dict(rtol=1e-5, atol=1e-6), grad=(1e-4, 1e-6)),
       "bfloat16": dict(out=dict(rtol=0, atol=3e-2), grad=(0, 5e-2))}


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_outputs_and_gradients_match_jax(dtype, layout):
    jm, params, tm = _models(dtype, layout)
    rng = np.random.default_rng(0)
    x, d = random_rays(rng, 400)
    cot = {"sigmas": rng.standard_normal(400), "rgbs":
           rng.standard_normal((400, 3)), "sems": rng.standard_normal(
               (400, 3)), "norms": rng.standard_normal((400, 3))}
    cot = {k: v.astype(np.float32) for k, v in cot.items()}

    def loss_j(p):
        out = jm(p, J(x), J(d))
        return sum(jnp.sum(out[k] * J(c)) for k, c in cot.items()), out

    with jax.disable_jit():
        (_, ref), grads = jax.value_and_grad(loss_j, has_aux=True)(params)
    out = tm(T(x), T(d))
    sum((out[k] * T(c)).sum() for k, c in cot.items()).backward()
    for k in cot:
        assert out[k].dtype == torch.float32
        np.testing.assert_allclose(N(out[k]), np.asarray(ref[k]),
                                   err_msg=k, **TOL[dtype]["out"])
    rtol, atol = TOL[dtype]["grad"]
    flat = {".".join(str(getattr(p, "key", p)) for p in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
    assert set(flat) == {n for n, _ in tm.named_parameters()}
    for n, p in tm.named_parameters():
        r = flat[n]
        np.testing.assert_allclose(N(p.grad), r, rtol=rtol,
                                   atol=atol * np.abs(r).max(), err_msg=n)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_density_matches_jax(layout):
    jm, params, tm = _models("float32", layout)
    x = np.random.default_rng(1).uniform(-0.5, 0.5, (500, 3)).astype(
        np.float32)
    with jax.disable_jit():
        ref = jm.density(params, J(x))
    with torch.no_grad():
        out = tm.density(T(x))
    np.testing.assert_allclose(N(out), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_exposure_tonemapper_raises():
    """The exposure tonemapper is ported and no longer raises (the test
    keeps the name of its refusal): `use_exposure` builds the three
    tonemapper_net_{i} MLPs under the JAX tree's names and shapes, so
    that `convert.py` carries them across (tests/test_torch_baselines.py
    holds the field's outputs to JAX)."""
    jc, tc = slice_configs(use_exposure=True)
    tm = TModel(tc.model, CPU)
    ref = jax.eval_shape(JModel(jc.model).init, jax.random.PRNGKey(0))
    flat = {".".join(str(getattr(p, "key", p)) for p in path): v.shape
            for path, v in jax.tree_util.tree_flatten_with_path(ref)[0]}
    assert {n: tuple(p.shape) for n, p in tm.named_parameters()} == flat
    assert {f"tonemapper_net_{i}.w{j}" for i in range(3)
            for j in range(2)} <= set(flat)


def test_layouts_size_the_encoding_as_jax():
    """brick / tcnn: enc_dim L*F and one `hash_table` parameter of the JAX
    leaf's shape; any value but brick and triplane is the tcnn grid, as
    the JAX `else` branch."""
    for layout, kw in (("brick", LAYOUTS["brick"]), ("tcnn", LAYOUTS["tcnn"]),
                       ("hash", LAYOUTS["tcnn"])):
        jc, tc = slice_configs(hash_layout=layout, **kw)
        jm, tm = JModel(jc.model), TModel(tc.model, CPU)
        assert tm.spec.out_dim == jm.enc_dim == 32
        assert tuple(tm.hash_table.shape) == tuple(
            jax.eval_shape(jm.init, jax.random.PRNGKey(0))["hash_table"].shape)
        assert type(tm.spec).__name__ == type(jm.grid_spec).__name__
