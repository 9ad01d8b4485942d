"""The table gradients of the three fields (H6 `brick_bwd`, H8
`hash_grid_bwd`, H2 `triplane_bwd`) and the kernels' C interface.

The kernels run only on the card; what they rely on is checked here on
the plain versions `encode_grad_plain`, which the card checks hold them
against. A "level" is a hash level (its 2 features) or, for the
triplane, one of its four tables (a plane's 8 features, grid3d's 4):
  - a (sample, level) pair whose cotangent slice is zero adds nothing,
    bit for bit: the kernels skip such pairs and any term equal to +-0;
  - no entry of the table gradient is -0.0 (the table starts at +0.0 and
    only adds, so a +-0 term never changes an entry), over seeds and
    cotangent signs, with -0.0 cotangents and exactly cancelling terms;
  - a bf16 cotangent, which the kernels read in bf16, gives the JAX
    package's gradient of the bf16 encode (the JAX side runs eagerly, as
    in test_torch_brick_hash.py; atol 1e-5 of the largest entry; the
    triplane's 2e-2, as test_torch_triplane.py states: JAX scatter-adds
    its gradient in bf16, the port in f32).
The last test reads every `extern "C"` launcher in `csrc/*.cu` and holds
each `Kernel`'s ctypes argtypes against it: a pointer passed as a C int
would be cut to 32 bits without any error.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import test_torch_brick_hash as tbh
import test_torch_hash_encoding as the
import test_torch_triplane as ttp
from test_torch_common import J, N, T

from normal_clustering_nerf_torch import kernels
from normal_clustering_nerf_torch.models import brick_hash as tb
from normal_clustering_nerf_torch.models import hash_encoding as th
from normal_clustering_nerf_torch.models import triplane as tt
from normal_clustering_nerf_tpu.models import brick_hash as jb
from normal_clustering_nerf_tpu.models import hash_encoding as jh
from normal_clustering_nerf_tpu.models import triplane as jt

LAYOUTS = {"brick": (tbh._case, tb, jb.brick_encode),
           "tcnn": (the._case, th, jh.hash_encode),
           "triplane": (ttp._case, tt, jt.triplane_encode)}


def level_part(layout, spec, d_table, l):
    """Level l's entries of a table gradient."""
    if layout == "brick":
        return d_table[l]
    lo = spec.level_offsets[l]
    hi = (spec.level_offsets[l + 1] if l + 1 < spec.n_levels
          else spec.total_rows)
    return d_table[lo:hi]


def level_columns(layout, spec):
    """The cotangent columns of each level (the triplane: its three planes'
    features, then grid3d's)."""
    if layout == "triplane":
        Fp = spec.plane_feats
        return [slice(i * Fp, (i + 1) * Fp) for i in range(3)] + [
            slice(3 * Fp, spec.out_dim)]
    F = spec.n_features
    return [slice(l * F, (l + 1) * F) for l in range(spec.n_levels)]


def grad_levels(layout, spec, x, g):
    """The plain table gradient of g, one numpy array a level."""
    if layout == "triplane":
        shapes = spec.param_shapes()
        d_planes, d_grid = tt.encode_grad_plain(
            T(x), T(g), spec, shapes["planes"], shapes["grid3d"])
        return [N(p) for p in d_planes] + [N(d_grid)]
    d = LAYOUTS[layout][1].encode_grad_plain(T(x), T(g), spec)
    return [N(level_part(layout, spec, d, l)) for l in range(spec.n_levels)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_zero_cotangent_pairs_add_nothing(layout, seed):
    """Zeroing the cotangent of a random subset of (sample, level) pairs,
    whole samples among them, gives at every level the plain gradient of
    the remaining samples alone, bit for bit: the kernels' skip of zero
    pairs is exact."""
    case = LAYOUTS[layout][0]
    _, spec, _, x, g = case(10 + seed)
    rng = np.random.default_rng(seed)
    cols = level_columns(layout, spec)
    M, L = x.shape[0], len(cols)
    zero = rng.random((M, L)) < 0.3
    zero[rng.random(M) < 0.2] = True
    gz = g.copy()
    for l, c in enumerate(cols):
        gz[zero[:, l], c] = 0.0
    got = grad_levels(layout, spec, x, gz)
    for l in range(L):
        keep = ~zero[:, l]
        ref = grad_levels(layout, spec, x[keep], g[keep])
        np.testing.assert_array_equal(got[l], ref[l])
    assert zero.any() and not zero.all()


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@settings(max_examples=12, deadline=None, database=None)
@given(seed=st.integers(0, 2 ** 16),
       sign=st.sampled_from(["positive", "negative", "mixed"]))
def test_table_gradient_has_no_negative_zero(layout, seed, sign):
    _, spec, _, x, g = LAYOUTS[layout][0](seed % 4)
    rng = np.random.default_rng(seed)
    M = x.shape[0]
    g = np.abs(g)
    if sign == "negative":
        g = -g
    elif sign == "mixed":
        g = g * rng.choice([-1.0, 1.0], g.shape).astype(np.float32)
    g[rng.random(g.shape) < 0.2] = -0.0
    # the second half repeats the first half's points with the negated
    # cotangent: an entry that one such pair alone touches sums to 0
    half = M // 2
    x[half:2 * half], g[half:2 * half] = x[:half], -g[:half]
    d = np.concatenate([p.reshape(-1)
                        for p in grad_levels(layout, spec, x, g)])
    assert not np.any(np.signbit(d) & (d == 0))
    assert np.count_nonzero(d == 0) > 0


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_bf16_cotangent_matches_jax(layout):
    """The encode in bf16, differentiated with a bf16 cotangent: the
    backward hands the table gradient the cotangent in bf16 (the kernels
    read it so; the plain version casts it to f32), as JAX's transpose of
    the cast does."""
    case, mod, jax_encode = LAYOUTS[layout]
    spec_j, spec, table, x, g = case(4)
    gb = T(g).to(torch.bfloat16)
    if layout == "triplane":
        table = {k: J(v) for k, v in table.items()}
        tab = {k: T(v).requires_grad_(True) for k, v in table.items()}
        encode, atol = tt.triplane_encode, 2e-2
    else:
        table, tab = J(table), T(table).requires_grad_(True)
        encode = tb.brick_encode if layout == "brick" else th.hash_encode
        atol = 1e-5
    with jax.disable_jit():
        _, vjp = jax.vjp(lambda t: jax_encode(t, J(x), spec_j, jnp.bfloat16),
                         table)
        ref = vjp(jnp.asarray(N(gb.float()), jnp.bfloat16))[0]
    encode(tab, T(x), spec, torch.bfloat16).backward(gb)
    if layout == "triplane":
        got = [N(tab["planes"].grad), N(tab["grid3d"].grad)]
        ref = [np.asarray(ref["planes"], np.float32),
               np.asarray(ref["grid3d"], np.float32)]
    else:
        got, ref = [N(tab.grad)], [np.asarray(ref)]
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a, r, rtol=0, atol=atol * np.abs(r).max())
    if layout == "triplane":
        shapes = spec.param_shapes()
        plain = mod.encode_grad_plain(T(x), gb.float(), spec,
                                      shapes["planes"], shapes["grid3d"])
    else:
        plain = [mod.encode_grad_plain(T(x), gb.float(), spec)]
    for a, p in zip(got, plain):
        np.testing.assert_array_equal(a, N(p))


def launchers():
    """{name: [C parameter declarations]} of every `extern "C" int`
    launcher in csrc/*.cu."""
    found = {}
    for src in sorted(kernels.CSRC.glob("*.cu")):
        text = re.sub(r"//[^\n]*", "", src.read_text())
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            found[name] = [p.strip() for p in params.split(",")]
    return found


def c_type(decl):
    """The ctypes class a C parameter declaration must be passed as."""
    if "*" in decl or decl.startswith("cudaStream_t"):
        return kernels.P
    kind = decl.split()[0]
    return {"int": kernels.I, "float": kernels.F}[kind]


@pytest.mark.parametrize("kernel", kernels.ALL_KERNELS,
                         ids=lambda k: k.name)
def test_argtypes_match_the_launcher(kernel):
    decls = launchers()[kernel.name]
    src = kernels.CSRC / kernel.source
    assert f'extern "C" int {kernel.name}(' in src.read_text()
    assert decls[-1].startswith("cudaStream_t")
    assert [c_type(d) for d in decls] == kernel.argtypes
