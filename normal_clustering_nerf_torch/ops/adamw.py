"""The optimizer's update — optax's `clip_by_global_norm` and AdamW (or
plain Adam) over named parameters, the JAX package's `build_optimizer`
chain (training/state.py:43-79): kernel K9 (`csrc/adamw.cu`: the global
norm in one launch, the clip, moments and step in a second) on CUDA
tensors, and its plain version on CPU ones.

The plain version takes K9's arithmetic order with torch elementwise ops,
so that the two agree bit for bit on the card: the norm's squares summed
in K9's tiles (`tile_sums`: TILE values a tile, a thread's QUADS quads in
order, then xor halvings over the lanes and over the warps) and the tile
sums the same way (`global_norm_plain`), with no epsilon; the clip as a
division by the norm, then a product with grad_clip; every product, sum,
division and square root rounded alone.

A tensor is one `Slot`: the parameter, its gradient, its two moments
(updated in place, in their own storages, which a captured step reads),
its lr as a 0-dim f32 tensor (+lr to be negated, or -lr already) and
whether it takes weight decay. K9 takes up to MAX_TENSORS tensors a call.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence, Tuple

import torch

from .. import kernels

THREADS = 256                     # K9's threads a block, a tile a block
WARPS = THREADS // 32
QUADS = 4                         # a thread's quads of a tile
TILE = THREADS * QUADS * 4        # values a tile
MAX_TENSORS = 32                  # csrc/adamw.cu's Plan holds this many
DECAY, NEGATE_LR = 1, 2           # csrc/adamw.cu's Entry flags


class Slot(NamedTuple):
    p: torch.Tensor          # the parameter, updated in place
    g: torch.Tensor          # its gradient (any contiguous f32 view)
    mu: torch.Tensor         # the first moment, updated in place
    nu: torch.Tensor         # the second moment, updated in place
    lr: torch.Tensor         # 0-dim f32: +lr when `negate`, else -lr
    negate: bool
    decay: bool              # decoupled weight decay on this tensor


class Hyper(NamedTuple):
    b1: float
    b2: float
    eps: float
    weight_decay: float
    grad_clip: float


class _Entry(ctypes.Structure):
    _fields_ = [("g", ctypes.c_void_p), ("p", ctypes.c_void_p),
                ("mu", ctypes.c_void_p), ("nu", ctypes.c_void_p),
                ("lr", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("first_tile", ctypes.c_int), ("flags", ctypes.c_int)]


class _Plan(ctypes.Structure):
    _fields_ = [("e", _Entry * MAX_TENSORS), ("tensors", ctypes.c_int),
                ("tiles", ctypes.c_int)]


def tile_plan(numels: Sequence[int]) -> Tuple[List[int], int]:
    """Each tensor's first tile and the tiles of all: tensor i takes
    ceil(numels[i] / TILE) tiles after tensor i - 1's, its first tile from
    its first value. Refuses more than MAX_TENSORS tensors."""
    if len(numels) > MAX_TENSORS:
        raise ValueError(
            f"K9 takes at most {MAX_TENSORS} tensors a call, got "
            f"{len(numels)} (ROADMAP B5c: the tile plan in device memory "
            f"would lift the cap)")
    first, tiles = [], 0
    for n in numels:
        first.append(tiles)
        tiles += -(-int(n) // TILE)
    return first, tiles


def block_sum(s: torch.Tensor) -> torch.Tensor:
    """(..., THREADS) -> (...): K9's block tree, xor halvings 16..1 over a
    warp's lanes (each lane adds the other lane's sum to its own), then
    over the WARPS warp sums."""
    lane = torch.arange(32, device=s.device)
    s = s.reshape(*s.shape[:-1], WARPS, 32)
    for o in (16, 8, 4, 2, 1):
        s = s + s[..., lane ^ o]
    w = s[..., 0]
    warp = torch.arange(WARPS, device=s.device)
    o = WARPS // 2
    while o:
        w = w + w[..., warp ^ o]
        o //= 2
    return w[..., 0]


def tile_sums(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """(tiles,) sums of the gradients' squares, tile by tile in K9's
    order (every tensor's tiles in turn, its first tile from its first
    value): thread t of a tile adds, from +0.0, its quads k THREADS + t
    (k = 0..QUADS-1, each quad's 4 values in order; +0.0 past the
    tensor's end), then `block_sum`. All tiles at once: one add a (quad,
    value), so the launches do not grow with the tensors."""
    zeros = grads[0].new_zeros(TILE)
    pieces = []
    for g in grads:
        sq = g.reshape(-1) * g.reshape(-1)
        pieces += [sq, zeros[:-sq.numel() % TILE]]
    # (QUADS * 4, tiles, THREADS): value j of quad k of every thread at
    # row 4 k + j, so that each add of the thread's order reads one row
    cols = torch.cat(pieces).view(-1, QUADS, THREADS, 4).permute(
        1, 3, 0, 2).reshape(QUADS * 4, -1, THREADS)
    s = torch.zeros_like(cols[0])
    for c in cols:
        s = s + c
    return block_sum(s)


def global_norm_plain(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """K9's norm (0-dim f32): the `tile_sums`, thread t adding the tiles
    t, t + THREADS, ... in order, then `block_sum`, then the square
    root."""
    sums = tile_sums(grads)
    rows = -(-sums.numel() // THREADS)
    sums = torch.cat([sums, sums.new_zeros(rows * THREADS - sums.numel())])
    acc = sums.new_zeros(THREADS)
    for r in sums.view(rows, THREADS):
        acc = acc + r
    return torch.sqrt(block_sum(acc))


@torch.no_grad()
def adamw_step_plain(slots: Sequence[Slot], g_norm: torch.Tensor,
                     bc1: torch.Tensor, bc2: torch.Tensor, hp: Hyper):
    """K9's second launch in torch: each gradient clipped (where g_norm
    is not under grad_clip, (g / g_norm) * grad_clip), the moments, the
    bias-corrected update with its weight decay, and the step, in
    place."""
    keep = g_norm < hp.grad_clip
    for s in slots:
        g = torch.where(keep, s.g, (s.g / g_norm) * hp.grad_clip)
        torch.add((1 - hp.b1) * g, hp.b1 * s.mu, out=s.mu)
        torch.add((1 - hp.b2) * (g * g), hp.b2 * s.nu, out=s.nu)
        u = (s.mu / bc1) / (torch.sqrt(s.nu / bc2) + hp.eps)
        if s.decay:
            u = u + hp.weight_decay * s.p
        s.p.add_(u * (-s.lr if s.negate else s.lr))


@torch.no_grad()
def clipped_adamw_plain(slots: Sequence[Slot], bc1: torch.Tensor,
                        bc2: torch.Tensor, count: torch.Tensor,
                        hp: Hyper) -> torch.Tensor:
    """K9's plain version: returns the pre-clip norm, advances `count`."""
    g_norm = global_norm_plain([s.g for s in slots])
    count.add_(1)
    adamw_step_plain(slots, g_norm, bc1, bc2, hp)
    return g_norm


def clipped_adamw(slots: Sequence[Slot], bc1: torch.Tensor,
                  bc2: torch.Tensor, count: torch.Tensor,
                  hp: Hyper) -> torch.Tensor:
    """Clip by the global norm, then AdamW, over every slot in place;
    advances `count` (0-dim int64) and returns the pre-clip norm (0-dim
    f32). K9 on CUDA tensors (it reads nothing on the host; a failed
    check or launch raises), the plain version on CPU ones."""
    if slots[0].p.is_cuda:
        return clipped_adamw_kernel(slots, bc1, bc2, count, hp)
    return clipped_adamw_plain(slots, bc1, bc2, count, hp)


def make_plan(slots: Sequence[Slot]) -> Tuple[_Plan, torch.device]:
    """K9's tile plan of `slots` (a host struct, built every call: an
    eager step's gradients are new storage each time), every tensor
    checked: f32, contiguous, on the first parameter's card, the moments
    and the gradient of the parameter's shape, lr 0-dim."""
    if not slots:
        raise ValueError("K9: no tensors")
    dev = slots[0].p.device
    first, tiles = tile_plan([s.p.numel() for s in slots])
    if tiles == 0:
        raise ValueError("K9: the tensors hold no values")
    plan = _Plan()
    plan.tensors, plan.tiles = len(slots), tiles
    for i, s in enumerate(slots):
        shape = tuple(s.p.shape)
        e = plan.e[i]
        e.p = kernels.check(s.p, f"param {i}", torch.float32, None, dev).value
        e.g = kernels.check(s.g, f"grad {i}", torch.float32, shape,
                            dev).value
        e.mu = kernels.check(s.mu, f"mu {i}", torch.float32, shape,
                             dev).value
        e.nu = kernels.check(s.nu, f"nu {i}", torch.float32, shape,
                             dev).value
        e.lr = kernels.check(s.lr, f"lr {i}", torch.float32, (), dev).value
        e.n, e.first_tile = s.p.numel(), first[i]
        e.flags = (DECAY if s.decay else 0) | (NEGATE_LR if s.negate else 0)
    return plan, dev


def global_norm_kernel(plan: _Plan, count: torch.Tensor,
                       dev: torch.device) -> torch.Tensor:
    """K9's first launch (`adamw_norm`): the norm (0-dim f32), `count`
    advanced."""
    c = kernels.check(count, "count", torch.int64, (), dev)
    slots = torch.empty(plan.tiles, dtype=torch.float32, device=dev)
    g_norm = torch.empty((), dtype=torch.float32, device=dev)
    kernels.ADAMW_NORM.launch(
        ctypes.c_void_p(ctypes.addressof(plan)),
        kernels.ptr(kernels.scan_workspace("adamw", 1, dev)),
        kernels.ptr(slots), kernels.ptr(g_norm), c, device=dev)
    return g_norm


def adamw_step_kernel(plan: _Plan, g_norm: torch.Tensor, bc1: torch.Tensor,
                      bc2: torch.Tensor, hp: Hyper, dev: torch.device):
    """K9's second launch (`adamw_step`): the clip, the moments and the
    step of every value, in place."""
    gn = kernels.check(g_norm, "g_norm", torch.float32, (), dev)
    b1 = kernels.check(bc1, "bc1", torch.float32, (), dev)
    b2 = kernels.check(bc2, "bc2", torch.float32, (), dev)
    # each factor as the f32 value of the host's double (ctypes' float),
    # as torch's ops take a Python scalar
    kernels.ADAMW_STEP.launch(
        ctypes.c_void_p(ctypes.addressof(plan)), gn, b1, b2, hp.b1,
        1 - hp.b1, hp.b2, 1 - hp.b2, hp.eps, hp.weight_decay, hp.grad_clip,
        device=dev)


def clipped_adamw_kernel(slots: Sequence[Slot], bc1: torch.Tensor,
                         bc2: torch.Tensor, count: torch.Tensor,
                         hp: Hyper) -> torch.Tensor:
    """K9 on the card: two launches, the norm, then the update."""
    plan, dev = make_plan(slots)
    g_norm = global_norm_kernel(plan, count, dev)
    adamw_step_kernel(plan, g_norm, bc1, bc2, hp, dev)
    return g_norm
