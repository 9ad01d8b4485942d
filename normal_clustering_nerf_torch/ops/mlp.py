"""The field's four MLPs — the sigma net on the encoding, the rgb net on
[the unit view direction, h], the normal and the semantic heads on h,
bias-free and in bf16 (the JAX package's `models/ngp_mt.py:51`
`_apply_mlp` and `NGPMT.__call__` / `density`, which XLA fused): kernel
K6 (`csrc/mlp.cu`) on CUDA tensors, its plain version on CPU ones, as
one `torch.autograd.Function` (`FieldMLP`) whose backward is written
out (not autograd of the chain):

  mlp_fwd        sigmas (M,) f32 and the raws (M, C) f32 in
                 `field_raws`' channel order (rgb, norm, sem), or sigmas
                 alone (the density mode); it saves nothing, so one
                 launcher serves training and the test rounds;
  mlp_bwd        each tile's activations recomputed from the encoding
                 and the directions, the gradients of sigmas and raws
                 back through the heads, the rgb and the sigma nets: the
                 encoding's gradient (bf16), the directions' (when asked)
                 and each block's partial weight gradients (f32);
  mlp_dw_reduce  the partials added in block order, each weight gradient
                 rounded once to bf16 and stored as f32.

The plain version (`field_mlp_plain`, `field_mlp_bwd_plain`) is the
parent's chain of `apply_mlp`, `trunc_exp`, the direction's
normalisation, the cat, `trunc_sigmoid` and the casts, rounded where
bf16 autograd rounds it: after every product (an f32 sum rounded once),
in trunc_sigmoid's forward and in each of its backward's three
elementwise ops, in the direction's cast, in each add of h's gradient
over its consumers (norm + sem, + rgb, + the sigma slice: the order of
autograd's ready queue, latest consumer first) and in each weight
gradient's sum over the rows. The direction's norm is written out as
K6 takes it, sqrt((d0 d0 + d1 d1) + d2 d2), each operation rounded
alone. K6 rounds at the same points; only the f32 summation order inside
a product differs, so the two agree up to bf16 flips where two f32 sums
round apart (`chip_smoke.py:k6_compare` states the tolerances).

Weights are the model's f32 parameters, (fan_in, fan_out) each, in
NETS' order: sigma (w0, w1), rgb (w0, w1, w2), then norm (w0, w1, w2)
with the normal head and sem (w0, w1, w2) with the semantic one. An f32
model does not come here (`models/ngp_mt.py` keeps `torch.matmul` for
it, ROADMAP B10b).
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import kernels
from .trunc_exp import trunc_exp, trunc_sigmoid

WIDTH = 64        # K6's hidden width
GEO = 16          # h's width (geo_feat_dim)
MAX_IN = 32       # the widest encoding K6 takes
MAX_CLASSES = 42   # the widest semantic head K6 takes (a raws row <= 48)
ROWS = 128        # a tile: 8 warps of 16 rows
NMAT = 12         # csrc/mlp.cu's matrices (rgb's w0 as its d and h rows)
BF16 = torch.bfloat16


class Plan(NamedTuple):
    """The static part of a call."""
    din: int            # the encoding's width
    n_cls: int          # semantic classes (0: no semantic head)
    norm: bool          # the normal head
    use_dir: bool       # the view direction enters rgb (else zeros)
    exposure: bool      # rgb without its output activation (log-radiance)

    @property
    def channels(self) -> int:
        return 3 + 3 * self.norm + self.n_cls

    @property
    def n_weights(self) -> int:
        return 2 + 3 + 3 * self.norm + 3 * bool(self.n_cls)


def weight_shapes(plan: Plan, density: bool = False) -> List[Tuple[int, int]]:
    """(fan_in, fan_out) of each weight in NETS' order (the sigma net's
    alone in the density mode)."""
    W, G = WIDTH, GEO
    if density:
        return [(plan.din, W), (W, G)]
    shapes = [(plan.din, W), (W, G), (3 + G, W), (W, W), (W, 3)]
    if plan.norm:
        shapes += [(G, W), (W, W), (W, 3)]
    if plan.n_cls:
        shapes += [(G, W), (W, W), (W, plan.n_cls)]
    return shapes


def check_plan(plan: Plan, ws: Sequence[torch.Tensor], density=False):
    """K6's refusals, before any launch (ValueError, naming the ROADMAP
    item that would lift it): the widths and layer counts it is written
    for, an encoding of at most MAX_IN values, at most MAX_CLASSES
    semantic classes (with or without the normal head), f32 weights of the
    shapes `weight_shapes` gives."""
    shapes = weight_shapes(plan, density)
    if plan.din > MAX_IN or plan.din < 2 or plan.din % 2:
        raise ValueError(f"K6 takes an encoding of an even number of values "
                         f"up to {MAX_IN}, got {plan.din} (ROADMAP B10d: "
                         f"other first layers)")
    if plan.n_cls > MAX_CLASSES:
        raise ValueError(f"K6 takes at most {MAX_CLASSES} semantic classes, "
                         f"got {plan.n_cls} (ROADMAP B10d: a wider semantic "
                         f"head)")
    if len(ws) != len(shapes):
        raise ValueError(f"K6 takes {len(shapes)} weights (sigma 2, rgb "
                         f"3, norm 3, sem 3 layers), got {len(ws)} (ROADMAP "
                         f"B10d: other layer counts)")
    for i, (w, shape) in enumerate(zip(ws, shapes)):
        if tuple(w.shape) != shape:
            raise ValueError(f"K6 weight {i}: shape {tuple(w.shape)}, "
                             f"expected {shape} (hidden width {WIDTH}, "
                             f"geo_feat_dim {GEO}; ROADMAP B10d: other "
                             f"widths)")
        if w.dtype != torch.float32:
            raise ValueError(f"K6 weight {i}: {w.dtype}, expected f32 "
                             f"parameters")


def check_model(cfg) -> None:
    """A bf16 model's refusals (`check_plan`'s, read from its
    ModelConfig): other widths and layer counts, which neither K6 nor its
    plain version takes."""
    if (cfg.hidden_dim, cfg.geo_feat_dim) != (WIDTH, GEO):
        raise ValueError(f"K6 takes hidden width {WIDTH} and geo_feat_dim "
                         f"{GEO}, got {cfg.hidden_dim} and "
                         f"{cfg.geo_feat_dim} (ROADMAP B10d)")
    if (cfg.sigma_hidden_layers, cfg.rgb_hidden_layers,
            cfg.head_hidden_layers) != (1, 2, 2):
        raise ValueError(
            "K6 takes 1 sigma, 2 rgb and 2 head hidden layers, got "
            f"{cfg.sigma_hidden_layers}, {cfg.rgb_hidden_layers} and "
            f"{cfg.head_hidden_layers} (ROADMAP B10d)")


# ------------------------------------------------------------ the plain version
def unit_dirs(d: torch.Tensor):
    """(d / |d|, |d|) with |d| = sqrt((d0 d0 + d1 d1) + d2 d2), each
    operation rounded alone, as K6 computes it."""
    n = torch.sqrt(d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2])
    return d / n[:, None], n


def _mm(x, w):
    return x.mm(w.to(BF16))


def _mlp(x, ws):
    for i, w in enumerate(ws):
        x = _mm(x, w)
        if i < len(ws) - 1:
            x = torch.relu(x)
    return x


def _rgb_in(plan: Plan, d, h):
    dn, n = unit_dirs(d)
    if not plan.use_dir:
        dn = dn * 0.0
    return torch.cat([dn.to(BF16), h], dim=1), dn, n


def density_plain(enc, ws):
    """sigma = trunc_exp(h[:, 0]) of the sigma net, (M,) f32, and h."""
    h = _mlp(enc.to(BF16), ws[:2])
    return trunc_exp(h[:, 0].to(torch.float32)), h


def field_mlp_plain(plan: Plan, enc, d, ws, density: bool = False):
    """K6's forward in torch: (sigmas (M,) f32, raws (M, C) f32 in the
    order rgb, norm, sem), raws None in the density mode."""
    sig, h = density_plain(enc, ws)
    if density:
        return sig, None
    x, _, _ = _rgb_in(plan, d, h)
    rgb = _mlp(x, ws[2:5])
    raws = [(rgb if plan.exposure else trunc_sigmoid(rgb)).to(torch.float32)]
    i = 5
    if plan.norm:
        raws.append(_mlp(h, ws[i:i + 3]).to(torch.float32))
        i += 3
    if plan.n_cls:
        raws.append(_mlp(h, ws[i:i + 3]).to(torch.float32))
    return sig, torch.cat(raws, dim=1)


def _dx(g, w):
    """The product's input gradient, as autograd's mm backward."""
    return g.mm(w.to(BF16).t())


def _dw(x, g):
    """The product's weight gradient over the rows, rounded once to bf16
    (an f32 sum), as f32 (the weight cast's backward)."""
    return x.t().mm(g).to(torch.float32)


def _relu_bwd(g, out):
    return torch.ops.aten.threshold_backward(g, out, 0)


def _head_bwd(x, ws, g, grads, first):
    """A head's three products and ReLUs (x -> 64 -> 64 -> out) taken
    back from its output's bf16 gradient g: the weights' gradients into
    grads[first:first + 3], x's gradient returned."""
    a1 = torch.relu(_mm(x, ws[0]))
    a2 = torch.relu(_mm(a1, ws[1]))
    grads[first + 2] = _dw(a2, g)
    dz = _relu_bwd(_dx(g, ws[2]), a2)
    grads[first + 1] = _dw(a1, dz)
    dz = _relu_bwd(_dx(dz, ws[1]), a1)
    grads[first] = _dw(x, dz)
    return _dx(dz, ws[0])


def trunc_sigmoid_bwd(g, z):
    """trunc_sigmoid's backward on bf16 tensors (ops/trunc_exp.py): three
    elementwise ops, each rounded to bf16."""
    s = torch.sigmoid(torch.clamp(z, -10.0, 10.0))
    return g * s * (1.0 - s)


def field_mlp_bwd_plain(plan: Plan, enc, d, ws, g_sig, g_raws,
                        need_dd: bool):
    """K6's backward in torch: (the encoding's gradient (M, din) bf16,
    the directions' (M, 3) f32 or None, the weights' gradients (f32, in
    NETS' order)). g_sig (M,) and g_raws (M, C) are f32."""
    f32 = torch.float32
    grads: List[Optional[torch.Tensor]] = [None] * plan.n_weights
    e = enc.to(BF16)
    a1 = torch.relu(_mm(e, ws[0]))
    h = _mm(a1, ws[1])
    dh = torch.zeros_like(h)
    i, c = 5, 3
    heads = []
    if plan.norm:
        heads.append((i, c, 3))
        i, c = i + 3, c + 3
    if plan.n_cls:
        heads.append((i, c, plan.n_cls))
    # norm, then sem, then rgb, then the sigma slice: the latest consumer
    # of h first
    for first, col, width in heads:
        dh = dh + _head_bwd(h, ws[first:first + 3],
                            g_raws[:, col:col + width].to(BF16), grads,
                            first)
    x, dn, n = _rgb_in(plan, d, h)
    r1 = torch.relu(_mm(x, ws[2]))
    r2 = torch.relu(_mm(r1, ws[3]))
    g = g_raws[:, :3].to(BF16)
    dz = g if plan.exposure else trunc_sigmoid_bwd(g, _mm(r2, ws[4]))
    grads[4] = _dw(r2, dz)
    dz = _relu_bwd(_dx(dz, ws[4]), r2)
    grads[3] = _dw(r1, dz)
    dz = _relu_bwd(_dx(dz, ws[3]), r1)
    grads[2] = _dw(x, dz)
    dx = _dx(dz, ws[2])
    dh = dh + dx[:, 3:]
    gs = g_sig * torch.exp(torch.clamp(h[:, 0].to(f32), -15.0, 15.0))
    sel = torch.zeros_like(h)
    sel[:, 0] = gs.to(BF16)
    dh = dh + sel
    grads[1] = _dw(a1, dh)
    dz = _relu_bwd(_dx(dh, ws[1]), a1)
    grads[0] = _dw(e, dz)
    d_enc = _dx(dz, ws[0])
    d_d = None
    if need_dd:
        gd = dx[:, :3].to(f32)
        if not plan.use_dir:
            gd = gd * 0.0
        dot = gd[:, 0] * dn[:, 0] + gd[:, 1] * dn[:, 1] + gd[:, 2] * dn[:, 2]
        d_d = (gd - dn * dot[:, None]) / n[:, None]
    return d_enc, d_d, grads


# ------------------------------------------------------------ the card
class _Mat(ctypes.Structure):
    _fields_ = [("w", ctypes.c_void_p), ("fan_in", ctypes.c_int),
                ("fan_out", ctypes.c_int), ("dw", ctypes.c_int)]


class _Args(ctypes.Structure):
    """csrc/mlp.cu's Args, passed by value to each launcher."""
    _fields_ = [("m", _Mat * NMAT)] + [
        (k, ctypes.c_void_p) for k in (
            "enc", "dirs", "sigma", "raws", "g_sigma", "g_raws", "d_enc",
            "d_dirs", "partial", "dw")] + [
        (k, ctypes.c_int) for k in (
            "M", "din", "C", "n_cls", "has_norm", "use_dir", "exposure",
            "density", "blocks", "nw")]


# csrc/mlp.cu's matrices: sigma w0, w1; rgb w0's direction rows and its h
# rows; rgb w1, w2; norm w0-w2; sem w0-w2
S0, S1, RD, RH, R1, R2, N0, N1, N2, E0, E1, E2 = range(NMAT)


def matrices(plan: Plan, ws: Sequence[torch.Tensor], density=False):
    """[(weight, row offset, fan_in, fan_out, dw offset)] of csrc/mlp.cu's
    NMAT matrices (None for an absent head's, and past the sigma net's in
    the density mode), and the values of all weight gradients: each
    weight's gradient at its offset, in NETS' order, (fan_in, fan_out)
    row-major."""
    shapes = weight_shapes(plan, density)
    offs, n = [], 0
    for fi, fo in shapes:
        offs.append(n)
        n += fi * fo
    out: List = [None] * NMAT
    out[S0] = (ws[0], 0, plan.din, WIDTH, offs[0])
    out[S1] = (ws[1], 0, WIDTH, GEO, offs[1])
    if density:
        return out, n
    out[RD] = (ws[2], 0, 3, WIDTH, offs[2])
    out[RH] = (ws[2], 3, GEO, WIDTH, offs[2] + 3 * WIDTH)
    out[R1] = (ws[3], 0, WIDTH, WIDTH, offs[3])
    out[R2] = (ws[4], 0, WIDTH, 3, offs[4])
    i = 5
    if plan.norm:
        for k, m in enumerate((N0, N1, N2)):
            fi, fo = shapes[i + k]
            out[m] = (ws[i + k], 0, fi, fo, offs[i + k])
        i += 3
    if plan.n_cls:
        for k, m in enumerate((E0, E1, E2)):
            fi, fo = shapes[i + k]
            out[m] = (ws[i + k], 0, fi, fo, offs[i + k])
    return out, n


def grid(M: int, dev: torch.device, per_sm: int) -> int:
    """Persistent blocks: at most per_sm a multiprocessor, at most one a
    tile."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return max(1, min(-(-M // ROWS), per_sm * sms))


def make_args(plan: Plan, enc, d, ws, density: bool) -> Tuple[_Args,
                                                              torch.device]:
    """K6's arguments, every tensor checked: the encoding (M, din) bf16
    and the directions (M, 3) f32 contiguous on one card, the weights as
    `check_plan` takes them."""
    check_plan(plan, ws, density)
    if enc.dtype != BF16:
        raise ValueError(f"K6 computes in bf16, got a {enc.dtype} encoding "
                         f"(ROADMAP B10b: K6 for f32 models)")
    dev = enc.device
    M = enc.shape[0]
    a = _Args()
    a.enc = kernels.check(enc, "encoding", BF16, (M, plan.din), dev).value
    if not density:
        a.dirs = kernels.check(d, "directions", torch.float32, (M, 3),
                               dev).value
    mats, nw = matrices(plan, ws, density)
    for k, m in enumerate(mats):
        if m is None:
            continue
        w, row, fi, fo, off = m
        kernels.check(w, f"weight of matrix {k}", torch.float32, None, dev)
        a.m[k].w = w.data_ptr() + row * fo * 4
        a.m[k].fan_in, a.m[k].fan_out, a.m[k].dw = fi, fo, off
    a.M, a.din, a.C, a.n_cls = M, plan.din, plan.channels, plan.n_cls
    a.has_norm, a.use_dir = int(plan.norm), int(plan.use_dir)
    a.exposure, a.density, a.nw = int(plan.exposure), int(density), nw
    return a, dev


def _p(a):
    return ctypes.c_void_p(ctypes.addressof(a))


def fwd_kernel(plan: Plan, enc, d, ws, density: bool = False):
    """mlp_fwd on the card: (sigmas (M,), raws (M, C) or None)."""
    a, dev = make_args(plan, enc, d, ws, density)
    M = a.M
    sig = torch.empty(M, dtype=torch.float32, device=dev)
    raws = None if density else torch.empty((M, plan.channels),
                                            dtype=torch.float32, device=dev)
    a.sigma = sig.data_ptr()
    a.raws = None if raws is None else raws.data_ptr()
    a.blocks = grid(M, dev, 2)
    if M:
        kernels.MLP_FWD.launch(_p(a), device=dev)
    return sig, raws


def bwd_partials(plan: Plan, enc, d, ws, g_sig, g_raws, need_dd: bool):
    """mlp_bwd on the card: (its arguments, the encoding's gradient (M,
    din) bf16, the directions' (M, 3) f32 or None, the blocks' partial
    weight gradients (blocks, nw) f32). The partials are written whole by
    every launch, so nothing zeroes them, and come from the caching
    allocator: under a CUDA graph's capture from the graph's pool."""
    a, dev = make_args(plan, enc, d, ws, False)
    M = a.M
    f32 = torch.float32
    a.g_sigma = kernels.check(g_sig, "sigmas' gradient", f32, (M,),
                              dev).value
    a.g_raws = kernels.check(g_raws, "raws' gradient", f32,
                             (M, plan.channels), dev).value
    d_enc = torch.empty((M, plan.din), dtype=BF16, device=dev)
    d_d = torch.empty((M, 3), dtype=f32, device=dev) if need_dd else None
    a.blocks = grid(M, dev, 1)
    partial = torch.empty((a.blocks, a.nw), dtype=f32, device=dev)
    a.d_enc = d_enc.data_ptr()
    a.d_dirs = None if d_d is None else d_d.data_ptr()
    a.partial = partial.data_ptr()
    if M:
        kernels.MLP_BWD.launch(_p(a), device=dev)
    else:
        partial.zero_()
    return a, d_enc, d_d, partial


def dw_reduce_kernel(a: _Args, partial: torch.Tensor) -> torch.Tensor:
    """mlp_dw_reduce on the card: the (nw,) weight gradients of `partial`
    (`a`'s blocks by nw), each the blocks' sum in block order rounded
    once to bf16."""
    dev = partial.device
    kernels.check(partial, "partials", torch.float32, (a.blocks, a.nw), dev)
    dw = torch.empty(a.nw, dtype=torch.float32, device=dev)
    a.partial, a.dw = partial.data_ptr(), dw.data_ptr()
    kernels.MLP_DW_REDUCE.launch(_p(a), device=dev)
    return dw


def dw_reduce_plain(partial: torch.Tensor) -> torch.Tensor:
    """mlp_dw_reduce in torch: the rows added in order from +0.0, rounded
    to bf16, as f32."""
    s = torch.zeros_like(partial[0])
    for row in partial:
        s = s + row
    return s.to(BF16).to(torch.float32)


def split_grads(plan: Plan, dw: torch.Tensor) -> List[torch.Tensor]:
    """The flat weight gradients as (fan_in, fan_out) views, NETS' order."""
    grads, off = [], 0
    for fi, fo in weight_shapes(plan):
        grads.append(dw[off:off + fi * fo].view(fi, fo))
        off += fi * fo
    return grads


def bwd_kernel(plan: Plan, enc, d, ws, g_sig, g_raws, need_dd: bool):
    """mlp_bwd and mlp_dw_reduce on the card: as `field_mlp_bwd_plain`."""
    a, d_enc, d_d, partial = bwd_partials(plan, enc, d, ws, g_sig, g_raws,
                                          need_dd)
    return d_enc, d_d, split_grads(plan, dw_reduce_kernel(a, partial))


# ------------------------------------------------------------ the Function
class FieldMLP(torch.autograd.Function):
    """(sigmas, raws) of the four nets; the backward is mlp_bwd and
    mlp_dw_reduce (field_mlp_bwd_plain on the CPU)."""

    @staticmethod
    def forward(ctx, plan: Plan, enc, d, *ws):
        with torch.no_grad():
            if enc.is_cuda:
                sig, raws = fwd_kernel(plan, enc, d, ws)
            else:
                sig, raws = field_mlp_plain(plan, enc, d, ws)
        ctx.plan = plan
        ctx.save_for_backward(enc, d, *ws)
        return sig, raws

    @staticmethod
    def backward(ctx, g_sig, g_raws):
        enc, d, *ws = ctx.saved_tensors
        plan = ctx.plan
        need_dd = ctx.needs_input_grad[2]
        g_sig, g_raws = g_sig.contiguous(), g_raws.contiguous()
        with torch.no_grad():
            if enc.is_cuda:
                d_enc, d_d, grads = bwd_kernel(plan, enc, d, ws, g_sig,
                                               g_raws, need_dd)
            else:
                d_enc, d_d, grads = field_mlp_bwd_plain(plan, enc, d, ws,
                                                        g_sig, g_raws,
                                                        need_dd)
        if not ctx.needs_input_grad[1]:
            d_enc = None
        return (None, d_enc, d_d, *grads)


def field_mlp(plan: Plan, enc, d, ws):
    """The four nets on the encoding (M, din) bf16 and the view
    directions (M, 3) f32: (sigmas (M,) f32, raws (M, C) f32). K6 on CUDA
    tensors (three launches a step: it reads nothing on the host; a
    failed check or launch raises), the plain version on CPU ones."""
    return FieldMLP.apply(plan, enc, d.contiguous(), *ws)


def field_density(enc, ws):
    """The sigma net alone: sigmas (M,) f32. K6's density mode (mlp_fwd)
    on CUDA tensors, which computes no gradient (a call that would need
    one raises); the plain version on CPU ones."""
    if not enc.is_cuda:
        return density_plain(enc, ws)[0]
    if torch.is_grad_enabled() and (enc.requires_grad
                                    or any(w.requires_grad for w in ws)):
        raise ValueError("K6's density mode computes no gradient; take "
                         "field_mlp for a differentiable field")
    plan = Plan(enc.shape[1], 0, False, True, False)
    return fwd_kernel(plan, enc, None, ws, density=True)[0]
