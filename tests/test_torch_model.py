"""NGP-MT field of the port (triplane layout, kernel H2 + MLPs) against
the JAX package's NGPMT, with the JAX parameters carried across by
`convert.py`: density, the full multi-head call, and every parameter's
gradient.

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


def _models(dtype):
    jc, tc = slice_configs(compute_dtype=dtype)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_field_outputs_and_gradients_match_jax(dtype):
    jm, params, tm = _models(dtype)
    rng = np.random.default_rng(0)
    x, d = random_rays(rng, 400)
    cot = {"sigmas": rng.standard_normal(400), "rgbs":
           rng.standard_normal((400, 3)), "sems": rng.standard_normal(
               (400, 3)), "norms": rng.standard_normal((400, 3))}
    cot = {k: v.astype(np.float32) for k, v in cot.items()}

    def loss_j(p):
        out = jm(p, J(x), J(d))
        return sum(jnp.sum(out[k] * J(c)) for k, c in cot.items()), out

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


def test_density_matches_jax():
    jm, params, tm = _models("float32")
    x = np.random.default_rng(1).uniform(-0.5, 0.5, (500, 3)).astype(
        np.float32)
    ref = jm.density(params, J(x))
    with torch.no_grad():
        out = tm.density(T(x))
    np.testing.assert_allclose(N(out), np.asarray(ref), rtol=1e-5, atol=1e-6)


def test_unported_layouts_raise():
    _, tc = slice_configs(hash_layout="brick")
    with pytest.raises(NotImplementedError):
        TModel(tc.model, CPU)
