"""Segments of flat ray-major sample buffers — port of the JAX package's
`ops/segops.py` (reference: models/csrc/losses.cu:8-41,
volumerendering.cu:211-215), plain PyTorch only.

Segment n is the run of slots whose `seg_id` is n, starting at
`seg_start[n]` (ray-major order, as `compact_samples` writes them). The
JAX version scans with one global cumsum and subtracts each segment's
base, whose rounding grows with the whole batch's sum; here each segment
is laid out as a row of a dense (N, W) buffer and scanned on its own, as
the dense (N, K) layout is, so a flat buffer gives the bits of the dense
layout on the same samples (W = K) and the kernels' per-ray loops.
"""
import torch


def segment_slots(seg_id, seg_start):
    """Position of each slot inside its segment: (B,) int64."""
    idx = torch.arange(seg_id.shape[0], device=seg_id.device)
    return idx - seg_start.to(torch.int64)[seg_id.to(torch.int64)]


def to_segments(x, seg_id, pos, valid, n_seg: int, width: int):
    """Scatter the valid slots of flat `x` (B, ...) into a zeroed
    (n_seg, width, ...) buffer at (seg_id, pos)."""
    out = x.new_zeros((n_seg, width) + tuple(x.shape[1:]))
    out[seg_id[valid].to(torch.int64), pos[valid]] = x[valid]
    return out


def segment_width(pos, valid) -> int:
    """The longest segment of valid slots (at least 1)."""
    return int(pos[valid].max()) + 1 if bool(valid.any()) else 1


def dense_rows(seg_id, seg_start, valid, n_seg: int):
    """The valid slots' segments as dense rows: returns (to_rows, from_rows),
    which lay a flat (B, ...) tensor out as (n_seg, W, ...) rows (W the
    longest segment, zeros past each) and read such rows back into the
    slots (zeros outside the valid slots)."""
    pos = segment_slots(seg_id, seg_start)
    W = segment_width(pos, valid)
    rid, p = seg_id.to(torch.int64), torch.clamp(pos, 0, W - 1)

    def to_rows(x):
        return to_segments(x, seg_id, pos, valid, n_seg, W)

    def from_rows(y):
        out = y[rid, p]
        keep = valid.reshape((-1,) + (1,) * (out.dim() - 1))
        return torch.where(keep, out, out.new_zeros(()))
    return to_rows, from_rows


def segment_cumsum(x, seg_id, seg_start):
    """Inclusive and exclusive cumulative sums within segments.

    x: (B,) values (invalid slots must be 0); seg_id: (B,) owning segment,
    sorted ascending; seg_start: (N,) first slot of each segment.
    Returns (inclusive (B,), exclusive (B,)).
    """
    pos = segment_slots(seg_id, seg_start)
    inside = pos >= 0
    dense = to_segments(x, seg_id, pos, inside, seg_start.shape[0],
                        segment_width(pos, inside))
    incl = torch.cumsum(dense, dim=1)[seg_id.to(torch.int64),
                                      torch.clamp(pos, min=0)]
    return incl, incl - x
