"""K8's plain versions (`models/occupancy.py`: `occ_compact_plain`,
`occ_merge_pack_plain` with `fixed_order_sum`, the tables) against the
JAX package's refresh, on inputs made by numpy from a seed, and the
refresh with no host read.

- `occ_compact`: the occupied list and its count against JAX's cumsum
  list (occupancy.py:164-168, run with jnp as written there): empty, full,
  one cell, a 20% share, G 32 and 64, C 1 and 2. Exact.
- The occupied draws: ranks to cells with JAX's draws (`sample_update_cells`
  against JAX's, cascades 1 and 2), and the uniforms' mapping. Exact.
- The merge, the fixed-order mean and the pack against JAX's expressions
  and `packbits`, with the dyadic densities of `test_torch_occupancy.py`
  (every sum exact in f32, so any order gives JAX's bits), and the order
  itself against a numpy emulation on random values. Exact.
- The tables against `supervoxel_tables` / `coarse_occupancy` of JAX:
  random bits with bit-31 words, all zero, all one. Exact.
- `update` with every host read patched to raise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_common import CPU, J, N, T

from normal_clustering_nerf_torch.config import ModelConfig as TM
from normal_clustering_nerf_torch.models import occupancy as to
from normal_clustering_nerf_tpu.config import ModelConfig as JM
from normal_clustering_nerf_tpu.models import occupancy as jo
from normal_clustering_nerf_tpu.ops.packbits import packbits as j_packbits

THR = 0.01 * 1024 / np.sqrt(3.0)


def _grid(kind, C, G, seed):
    """(C, G^3) densities: dyadic values (THR is ~5.91), a tenth of the
    cells invisible (-1) in "p20"; `kind` sets the share above THR."""
    rng = np.random.default_rng(seed)
    G3 = G ** 3
    g = rng.integers(0, 16, (C, G3)) / 8.0
    share = {"empty": 0.0, "full": 1.0, "one": 0.0, "p20": 0.2}[kind]
    above = rng.random((C, G3)) < share
    g = np.where(above, 8.0 + g, np.minimum(g, 4.0))
    if kind == "one":
        g[:, rng.integers(0, G3)] = 7.5
    if kind == "p20":
        g[rng.random((C, G3)) < 0.1] = -1.0
    return g.astype(np.float32)


def _jax_list(grid_c, thr):
    """occupancy.py:164-168, as written there."""
    G3 = grid_c.shape[0]
    occ = grid_c > thr
    n_occ = jnp.sum(occ.astype(jnp.int32))
    pos = jnp.cumsum(occ.astype(jnp.int32)) - 1
    occ_list = jnp.zeros((G3 + 1,), jnp.int32).at[
        jnp.where(occ, pos, G3)].set(
            jnp.arange(G3, dtype=jnp.int32), mode="drop")[:G3]
    return np.asarray(occ_list), int(n_occ)


@pytest.mark.parametrize("kind", ["empty", "full", "one", "p20"])
@pytest.mark.parametrize("C,G", [(1, 32), (2, 64)])
def test_occ_compact_matches_jax_list(kind, C, G):
    grid = _grid(kind, C, G, seed=G + C)
    lst, count = to.occ_compact(T(grid), THR)
    assert lst.shape == (C, G ** 3) and lst.dtype == torch.int32
    for c in range(C):
        want, n = _jax_list(J(grid[c]), THR)
        assert int(count[c]) == n
        np.testing.assert_array_equal(N(lst[c])[:n], want[:n])
        np.testing.assert_array_equal(N(lst[c])[:n],
                                      np.flatnonzero(grid[c] > THR))
    expect = {"empty": 0, "one": 1}.get(kind)
    if expect is not None:
        assert (N(count) == expect).all()
    if kind == "full":
        assert (N(count) == G ** 3).all()


@pytest.mark.parametrize("scale,fill", [(0.5, 1.0), (0.5, 0.0), (1.0, 1.0)])
def test_sampled_cells_match_jax(scale, fill):
    """`sample_update_cells` with JAX's draws (occupancy.py:155-172)
    against JAX's cells; fill 0: no occupied cell, so the occupied draw
    takes uniform cells."""
    G = 32
    jg = jo.OccupancyGrid(JM(grid_size=G, scale=scale))
    tg = to.OccupancyGrid(TM(grid_size=G, scale=scale), CPU)
    C, G3, M = jg.cascades, G ** 3, G ** 3 // 4
    grid = _grid("p20", C, G, seed=5) * fill
    st = jg.init_state()._replace(density_grid=J(grid))
    key = jax.random.PRNGKey(3)
    ref, _ = jg.sample_update_cells(st, key, THR)
    keys = jax.random.split(key, 2 * C)
    uni, rank = [], []
    for c in range(C):
        n = int(jnp.sum(st.density_grid[c] > THR))
        uni.append(np.asarray(jax.random.randint(keys[2 * c], (M,), 0, G3)))
        k_o = keys[2 * c + 1]
        rank.append(np.asarray(
            jax.random.randint(k_o, (M,), 0, max(n, 1)) if n else
            jax.random.randint(jax.random.fold_in(k_o, 1), (M,), 0, G3)))
    state = to.OccupancyState(*(T(getattr(st, f))
                                for f in to.OccupancyState._fields))
    idx, coords = tg.sample_update_cells(
        state, THR, {"uniform": np.stack(uni), "occ_rank": np.stack(rank)})
    np.testing.assert_array_equal(N(idx), np.asarray(ref))
    assert coords.shape == (C, 2 * M, 3)


@pytest.mark.parametrize("fill", [1.0, 0.0])
def test_uniform_draws_map_to_cells(fill):
    """"occ_u" draws: with n occupied cells, list[min(floor(u n), n - 1)]
    (u n one f32 product), else min(floor(u G^3), G^3 - 1)."""
    G, C = 32, 2
    G3 = G ** 3
    tg = to.OccupancyGrid(TM(grid_size=G, scale=1.0), CPU)
    grid = _grid("p20", C, G, seed=9) * fill
    state = tg.init_state()._replace(density_grid=T(grid))
    rng = np.random.default_rng(4)
    u = rng.random((C, 64)).astype(np.float32)
    u[:, 0] = np.float32(1.0) - np.float32(2 ** -24)   # the top of [0, 1)
    uni = rng.integers(0, G3, (C, 64))
    idx, _ = tg.sample_update_cells(state, THR,
                                    {"uniform": uni, "occ_u": T(u)})
    for c in range(C):
        cells = np.flatnonzero(grid[c] > THR)
        n = cells.size
        if n:
            r = np.minimum((u[c] * np.float32(n)).astype(np.int64), n - 1)
            want = cells[r]
        else:
            want = np.minimum((u[c] * np.float32(G3)).astype(np.int64),
                              G3 - 1)
        np.testing.assert_array_equal(N(idx[c, 64:]), want)
        np.testing.assert_array_equal(N(idx[c, :64]), uni[c])


@pytest.mark.parametrize("C,G", [(1, 32), (2, 32), (1, 64)])
@pytest.mark.parametrize("decay", [0.5, 0.95])
def test_merge_mean_and_pack_match_jax(C, G, decay):
    """The merge, the mean of the positive cells and the pack
    (occupancy.py:217-230, jnp as written there; `packbits` of the JAX
    package). At decay 0.5 every merged density is dyadic and every sum
    exact, so the mean and the bits are JAX's; at the trainer's 0.95 the
    merged grid is exact and the mean, whose sum JAX adds in another
    order, within 2 ulp."""
    rng = np.random.default_rng(G * C)
    grid = _grid("p20", C, G, seed=G * C + 1)
    tmp = (rng.integers(0, 24, grid.shape) / 8.0).astype(np.float32)
    g = J(grid)
    new_j = jnp.where(g < 0, g, jnp.maximum(g * decay, J(tmp)))
    pos = new_j > 0
    mean_j = np.asarray(jnp.sum(jnp.where(pos, new_j, 0.0))
                        / jnp.maximum(jnp.sum(pos), 1))
    bits_j = j_packbits(new_j, jnp.minimum(mean_j, THR))
    new, bits, mean = to.occ_merge_pack(T(grid), T(tmp), decay, THR)
    np.testing.assert_array_equal(N(new), np.asarray(new_j))
    if decay == 0.5:
        assert N(mean) == mean_j
        np.testing.assert_array_equal(N(bits), np.asarray(bits_j))
    else:
        assert abs(N(mean) - mean_j) <= 2 * np.spacing(mean_j)
    assert 0 < np.unpackbits(N(bits)).mean() < 1


def test_fixed_order_sum_is_k8s_order():
    """`fixed_order_sum` against a numpy emulation of K8's order on random
    non-negative values (column sums down 65,536 lanes, then halvings in
    blocks of 256, then across the 256 blocks), bit for bit."""
    rng = np.random.default_rng(8)
    x = rng.random(2 * 32 ** 3 * 3 + 512).astype(np.float32)
    cols = np.zeros(-(-x.size // to.COLUMNS) * to.COLUMNS, np.float32)
    cols[:x.size] = x
    acc = np.zeros(to.COLUMNS, np.float32)
    for row in cols.reshape(-1, to.COLUMNS):
        acc = (acc + row).astype(np.float32)
    part = acc.reshape(to.MERGE_BLOCKS, to.MERGE_THREADS)
    while part.shape[1] > 1:
        h = part.shape[1] // 2
        part = (part[:, :h] + part[:, h:]).astype(np.float32)
    part = part[:, 0]
    while part.size > 1:
        h = part.size // 2
        part = (part[:h] + part[h:]).astype(np.float32)
    assert N(to.fixed_order_sum(T(x))) == part[0]


@pytest.mark.parametrize("kind", ["random", "zero", "one"])
@pytest.mark.parametrize("G", [32, 64])
def test_tables_match_jax(kind, G):
    rng = np.random.default_rng(G)
    n = G ** 3 // 8
    Gc = G // 8
    # half the supervoxels empty, a twentieth of the others' cells set
    sv = rng.random((Gc, 1, Gc, 1, Gc, 1)) < 0.5
    cells = (rng.random((Gc, 8, Gc, 8, Gc, 8)) < 0.05) & sv   # z, y, x
    bf = {"random": np.packbits(cells.reshape(-1), bitorder="little"),
          "zero": np.zeros(n, np.uint8),
          "one": np.full(n, 255, np.uint8)}[kind]
    coarse, mask, payload = to.occ_tables(T(bf), G)
    m_ref, p_ref = jo.supervoxel_tables(J(bf), G)
    np.testing.assert_array_equal(N(mask), np.asarray(m_ref))
    np.testing.assert_array_equal(N(payload), np.asarray(p_ref))
    np.testing.assert_array_equal(N(coarse),
                                  np.asarray(jo.coarse_occupancy(J(bf), G)))
    if kind == "random":
        assert (np.asarray(p_ref) < 0).any() and not np.asarray(m_ref).all()
    if kind == "one":
        assert (N(payload) == -1).all() and N(coarse).all()


def _density(xyz):
    q = (torch.floor(xyz[:, 0] * 8) + 3 * torch.floor(xyz[:, 1] * 8)
         + 5 * torch.floor(xyz[:, 2] * 8))
    return torch.remainder(q, 9.0) / 8.0 * 12.0


def test_update_reads_nothing_on_the_host(monkeypatch):
    """Both refresh forms with torch.nonzero, Tensor.item, Tensor.tolist,
    Tensor.__bool__ and Tensor.__int__ patched to raise: no host read
    (what a CUDA graph of the refresh needs), at 2 cascades."""
    tg = to.OccupancyGrid(TM(grid_size=32, scale=1.0), CPU)
    state = tg.init_state()._replace(
        density_grid=T(_grid("p20", tg.cascades, 32, seed=1)))
    gen = torch.Generator().manual_seed(0)
    want = [tg.update(state, _density, THR, warmup=w,
                      generator=gen.manual_seed(0)) for w in (False, True)]

    def host_read(*args, **kwargs):
        raise AssertionError("a host read in the refresh")
    monkeypatch.setattr(torch, "nonzero", host_read)
    for name in ("item", "tolist", "__bool__", "__int__"):
        monkeypatch.setattr(torch.Tensor, name, host_read)
    for w, ref in zip((False, True), want):
        out = tg.update(state, _density, THR, warmup=w,
                        generator=gen.manual_seed(0))
        monkeypatch.undo()
        for a, b in zip(out, ref):
            assert torch.equal(a, b)
        monkeypatch.setattr(torch, "nonzero", host_read)
        for name in ("item", "tolist", "__bool__", "__int__"):
            monkeypatch.setattr(torch.Tensor, name, host_read)
