"""The optimizer's update, K9's plain version (`ops/adamw.py`), against
the JAX package's `build_optimizer` chain and against K9's order.

K9 (`csrc/adamw.cu`) runs only on the card; `chip_smoke.py`'s
`check_adamw` holds it there to the plain version bit for bit. Here:
  * the plain norm, summed in K9's tiles, against `optax.global_norm` and
    a float64 numpy norm (rtol 1e-6: one f32 sum in another order), and
    bit for bit against a numpy emulation of K9's threads written from
    the kernel's index arithmetic;
  * `AdamW.update` over narrow versions of the triplane field's 13
    parameters with theta_WF, dR, dT and dR_glob against optax for three
    counts, the clip on and off (test_torch_extrinsics.py's tolerances:
    rtol 1e-6, atol 2e-6 of the parameter's lr);
  * gradients as views into one flat buffer at odd offsets (as
    `mean_over_axis` hands them over) equal bit for bit to contiguous ones;
  * the host tile plan, the ctypes plan against the kernel's struct, and
    the wrapper on CPU tensors.
"""
import ctypes
import dataclasses
import re

import jax
import numpy as np
import optax
import pytest
import torch

from test_torch_common import J, N, T, slice_configs

from normal_clustering_nerf_torch import kernels
from normal_clustering_nerf_torch.ops import adamw
from normal_clustering_nerf_torch.training.state import EXT_LR, AdamW
from normal_clustering_nerf_tpu.training.state import build_optimizer

# narrow versions of the triplane field's parameters (the bench's names;
# hash_table.planes crosses a tile edge) and the parameters beside them
SHAPES = {"hash_table.grid3d": (27, 16), "hash_table.planes": (3, 37, 40),
          "sigma_net.w0": (28, 8), "sigma_net.w1": (8, 16),
          "rgb_net.w0": (19, 8), "rgb_net.w1": (8, 8), "rgb_net.w2": (8, 3),
          "sem_net.w0": (16, 8), "sem_net.w1": (8, 8), "sem_net.w2": (8, 3),
          "norm_net.w0": (16, 8), "norm_net.w1": (8, 8),
          "norm_net.w2": (8, 3), "theta_WF": (), "dR": (6, 3), "dT": (6, 3),
          "dR_glob": (3,)}
BESIDE = ("theta_WF", "dR", "dT", "dR_glob")


def _configs():
    def ext(c):
        return c.replace(optim=dataclasses.replace(
            c.optim, optimize_ext=True, lr_dR_norm_glob=1e-4,
            weight_decay_net=0.1))
    return tuple(ext(c) for c in slice_configs())


def _jtree(d):
    """{dotted name: array} -> the JAX state's params tree."""
    tree = {"model": {}}
    for name, a in d.items():
        if name in BESIDE:
            tree[name] = J(a)
        else:
            mod, leaf = name.split(".")
            tree["model"].setdefault(mod, {})[leaf] = J(a)
    return tree


def _jflat(tree):
    out = {k: np.asarray(v) for k, v in tree.items() if k != "model"}
    for mod, leaves in tree["model"].items():
        out.update({f"{mod}.{k}": np.asarray(v) for k, v in leaves.items()})
    return out


def _params(rng):
    # the pose deltas at 1e-5, where an f32 ulp (~1e-12) is far below
    # their 1e-6 updates
    return {n: ((1e-5 if n.startswith("d") else 1e-2)
                * rng.standard_normal(s)).astype(np.float32)
            for n, s in SHAPES.items()}


# ------------------------------------------------------------- the norm
NORM_SIZES = [(1,), (4095,), (4096,), (4097,), (3, 4099), (), (7, 3),
              (1_100_003,)]


def test_plain_norm_against_optax_and_float64():
    """Tensors of odd sizes on both sides of tile edges, and one of 269
    tiles (past THREADS tiles: two rows of the tile sums' walk)."""
    rng = np.random.default_rng(3)
    gs = [rng.standard_normal(s).astype(np.float32) for s in NORM_SIZES]
    got = float(adamw.global_norm_plain([T(g) for g in gs]))
    want64 = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in gs))
    want_jax = float(optax.global_norm([J(g) for g in gs]))
    np.testing.assert_allclose(got, want64, rtol=1e-6)
    np.testing.assert_allclose(got, want_jax, rtol=1e-6)


def _emulated_norm(gs):
    """K9's norm as its threads compute it, in float32 numpy from the
    kernel's index arithmetic: tile p of a tensor, thread t, quad k, value
    j is the tensor's value (p TILE) + 4 (k THREADS + t) + j."""
    f32 = np.float32
    lane, warp = np.arange(32), np.arange(adamw.WARPS)

    def tree(s):   # (rows, THREADS) -> (rows,): halvings, lanes then warps
        s = s.reshape(len(s), adamw.WARPS, 32)
        for o in (16, 8, 4, 2, 1):
            s = (s + s[..., lane ^ o]).astype(f32)
        w = s[..., 0]
        o = adamw.WARPS // 2
        while o:
            w = (w + w[..., warp ^ o]).astype(f32)
            o //= 2
        return w[..., 0]

    sums = []
    for g in gs:
        x = g.reshape(-1)
        tiles = -(-x.size // adamw.TILE)
        p = np.arange(tiles)[:, None]
        t = np.arange(adamw.THREADS)[None, :]
        acc = np.zeros((tiles, adamw.THREADS), f32)
        for k in range(adamw.QUADS):
            for j in range(4):
                idx = p * adamw.TILE + 4 * (k * adamw.THREADS + t) + j
                v = np.where(idx < x.size, x[np.minimum(idx, x.size - 1)],
                             f32(0))
                acc = (acc + (v * v).astype(f32)).astype(f32)
        sums.append(tree(acc))
    sums = np.concatenate(sums)
    acc = np.zeros(adamw.THREADS, f32)
    for i in range(0, len(sums), adamw.THREADS):
        row = np.zeros(adamw.THREADS, f32)
        chunk = sums[i:i + adamw.THREADS]
        row[:len(chunk)] = chunk
        acc = (acc + row).astype(f32)
    return np.sqrt(tree(acc[None])[0], dtype=f32)


def test_plain_norm_is_the_kernels_order():
    """The plain version's column adds and halvings are K9's threads'
    order, bit for bit (and not torch.sum's, which differs here)."""
    rng = np.random.default_rng(4)
    gs = [(rng.standard_normal(s) * rng.uniform(0.1, 10)).astype(np.float32)
          for s in NORM_SIZES]
    got = N(adamw.global_norm_plain([T(g) for g in gs]))
    assert got.tobytes() == _emulated_norm(gs).tobytes()


def test_plain_norm_of_a_nan_gradient_is_nan():
    g = np.ones(5000, np.float32)
    g[4321] = np.nan
    assert np.isnan(float(adamw.global_norm_plain([T(g), T(np.ones(3))])))


# ------------------------------------------------------- against optax
@pytest.mark.parametrize("clip", [True, False])
def test_update_matches_build_optimizer(clip):
    """Three updates of the triplane field's narrow parameters, theta_WF
    (adam at the schedule), dR and dT (adam(1e-6)) and dR_glob
    (adam(lr_dR_norm_glob)), every gradient under the one global-norm
    clip, against JAX's `build_optimizer` (weight_decay_net 0.1, so that a
    decay where there should be none would show). With `clip` the norm
    exceeds grad_clip."""
    jcfg, tcfg = _configs()
    rng = np.random.default_rng(50 + clip)
    p_np = _params(rng)
    jparams = _jtree(p_np)
    tx = build_optimizer(jcfg, jparams)
    jstate = tx.init(jparams)
    tparams = {n: T(a) for n, a in p_np.items()}
    opt = AdamW(tparams, tcfg.optim)
    scale = 1.0 if clip else 1e-5
    for count in range(3):
        g_np = {n: (scale * rng.standard_normal(s)).astype(np.float32)
                for n, s in SHAPES.items()}
        updates, jstate = tx.update(_jtree(g_np), jstate, jparams)
        jparams = jax.tree_util.tree_map(lambda p, u: p + u, jparams,
                                         updates)
        lr, bc1, bc2 = (torch.tensor(v, dtype=torch.float32)
                        for v in opt.schedule(count))
        g_norm = opt.update({n: T(a) for n, a in g_np.items()}, lr, bc1, bc2)
        opt.advance()
        assert (float(g_norm) > tcfg.optim.grad_clip) == clip
        assert int(opt.count_t) == count + 1
        want = _jflat(jparams)
        for n, p in tparams.items():
            lr_n = {"dR": EXT_LR, "dT": EXT_LR,
                    "dR_glob": tcfg.optim.lr_dR_norm_glob}.get(n,
                                                             tcfg.optim.lr)
            np.testing.assert_allclose(N(p), want[n], rtol=1e-6,
                                       atol=2e-6 * lr_n,
                                       err_msg=f"{n} after update {count}")


def _state(rng):
    tparams = {n: T(a) for n, a in _params(rng).items()}
    opt = AdamW(tparams, _configs()[1].optim)
    return tparams, opt


@pytest.mark.parametrize("clip", [True, False])
def test_flat_buffer_views_equal_contiguous_gradients(clip):
    """The same three updates given each gradient as a view into one flat
    f32 buffer at an odd offset (1, then gaps of 1-3 values: no view
    16-byte aligned but by chance), as `mean_over_axis` hands them over,
    bit for bit the updates from contiguous gradients, and the shared
    zeros of an unused parameter's gradient left as they were."""
    rng = np.random.default_rng(60 + clip)
    seed = int(rng.integers(1 << 30))
    runs = []
    for views in (False, True):
        tparams, opt = _state(np.random.default_rng(seed))
        grng = np.random.default_rng(seed + 1)
        gap_rng = np.random.default_rng(seed + 2)
        zeros = torch.zeros(SHAPES["sem_net.w2"])
        norms = []
        for count in range(3):
            g_np = {n: ((1.0 if clip else 1e-5)
                        * grng.standard_normal(s)).astype(np.float32)
                    for n, s in SHAPES.items()}
            grads = {n: T(a) for n, a in g_np.items()}
            grads["sem_net.w2"] = zeros
            if views:
                sizes = [g.numel() for g in grads.values()]
                gaps = [1] + list(gap_rng.integers(1, 4, len(sizes) - 1))
                flat = torch.full((sum(sizes) + sum(gaps),), float("nan"))
                i, out = 0, {}
                for (n, g), gap in zip(grads.items(), gaps):
                    i += int(gap)
                    flat[i:i + g.numel()] = g.reshape(-1)
                    out[n] = flat[i:i + g.numel()].view(g.shape)
                    i += g.numel()
                grads = out
            lr, bc1, bc2 = (torch.tensor(v, dtype=torch.float32)
                            for v in opt.schedule(count))
            norms.append(opt.update(grads, lr, bc1, bc2))
            opt.advance()
        assert torch.equal(zeros, torch.zeros_like(zeros))
        runs.append((tparams, opt.state, torch.stack(norms)))
    (p0, s0, n0), (p1, s1, n1) = runs
    assert n0.numpy().tobytes() == n1.numpy().tobytes()
    for n in SHAPES:
        for a, b in ((p0[n], p1[n]), (s0["mu"][n], s1["mu"][n]),
                     (s0["nu"][n], s1["nu"][n])):
            assert a.numpy().tobytes() == b.numpy().tobytes(), n


# ---------------------------------------------------------- the tile plan
@pytest.mark.parametrize("numels", [[1], [4096], [4097, 0, 3, 8192],
                                    [13, 4095, 4096, 4097, 1],
                                    [5000] * adamw.MAX_TENSORS])
def test_tile_plan_covers_every_value_once(numels):
    """Every value of every tensor in exactly one tile, a tensor's tiles
    contiguous from its first value and the tensors' tiles in their
    order; the plan depends on the sizes alone."""
    first, tiles = adamw.tile_plan(numels)
    owner = np.full(tiles, -1)
    for i, (n, f) in enumerate(zip(numels, first)):
        k = -(-n // adamw.TILE)
        assert (owner[f:f + k] == -1).all()
        owner[f:f + k] = i
        covered = np.zeros(n, int)
        for p in range(f, f + k):
            lo = (p - f) * adamw.TILE
            covered[lo:min(lo + adamw.TILE, n)] += 1
        assert (covered == 1).all()
    assert (owner >= 0).all() and (np.diff(owner) >= 0).all()
    assert first == sorted(first)
    assert adamw.tile_plan(numels) == (first, tiles)


def test_tile_plan_refuses_past_the_cap():
    with pytest.raises(ValueError, match="ROADMAP B5c"):
        adamw.tile_plan([1] * (adamw.MAX_TENSORS + 1))


def test_plan_struct_matches_the_kernel():
    """ops/adamw.py's ctypes plan and constants against csrc/adamw.cu's
    struct sizes, cap, tile geometry and flags."""
    src = (kernels.CSRC / "adamw.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("THREADS") == adamw.THREADS
    assert const("QUADS") == adamw.QUADS
    assert const("MAX_TENSORS") == adamw.MAX_TENSORS
    assert (const("DECAY"), const("NEGATE_LR")) == (adamw.DECAY,
                                                    adamw.NEGATE_LR)
    sizes = dict(re.findall(r"static_assert\(sizeof\((\w+)\) == (\d+)", src))
    assert int(sizes["Entry"]) == ctypes.sizeof(adamw._Entry)
    assert int(sizes["Plan"]) == ctypes.sizeof(adamw._Plan)


def test_kernel_wrapper_refuses_cpu_tensors():
    """K9's wrapper checks every tensor before it builds or launches:
    a CPU tensor raises."""
    tparams, opt = _state(np.random.default_rng(7))
    slots = opt.slots({n: torch.zeros_like(p) for n, p in tparams.items()},
                      torch.tensor(1e-2))
    with pytest.raises(ValueError, match="CUDA"):
        adamw.make_plan(slots)


# ------------------------------------------------------------ the wrapper
def test_wrapper_takes_plain_on_cpu():
    """`clipped_adamw` on CPU tensors is the plain version, bit for bit,
    the count advanced once a call."""
    outs = []
    for fn in (adamw.clipped_adamw, adamw.clipped_adamw_plain):
        tparams, opt = _state(np.random.default_rng(8))
        grng = np.random.default_rng(9)
        norms = []
        for count in range(3):
            grads = {n: T(grng.standard_normal(s).astype(np.float32))
                     for n, s in SHAPES.items()}
            lr, bc1, bc2 = (torch.tensor(v, dtype=torch.float32)
                            for v in opt.schedule(count))
            norms.append(fn(opt.slots(grads, lr), bc1, bc2, opt.count_t,
                            opt.hyper))
        assert int(opt.count_t) == 3
        outs.append((torch.stack(norms), tparams, opt.state))
    (n0, p0, s0), (n1, p1, s1) = outs
    assert torch.equal(n0, n1)
    for n in SHAPES:
        assert torch.equal(p0[n], p1[n])
        assert torch.equal(s0["mu"][n], s1["mu"][n])
        assert torch.equal(s0["nu"][n], s1["nu"][n])
