"""Build, load and launch the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for `sm_90a` into its own
shared library with a plain C interface and loaded with `ctypes` (no
PyTorch headers, so a build takes seconds). Libraries are built at first
use into `build/kernels/` at the repository root (listed in
`.gitignore`), keyed by a hash of the sources and flags, so a fresh
checkout builds them itself. `build_all()` starts one `nvcc` per source,
all at once.

Every launch goes through `Kernel.launch`, which checks the
`cudaGetLastError()` code the C function returns, raises if it is not 0,
and counts the launch in `Kernel.launches`. A launch recorded into a CUDA
graph runs at each replay, with no Python call: `capture_counts` takes
the capture's calls off the counts, and `CountedGraph.replay` adds them
back at every replay. Nothing here falls back to another implementation:
a missing `nvcc`, a failed build or a failed launch raises.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "build" / "kernels"
# --fmad=false: the march must reproduce the reference's t/xyz/cell
# arithmetic bit for bit (no multiply-add contraction); the other
# kernels are memory- or latency-bound, so contraction buys nothing.
NVCC_FLAGS = [
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
]

# argument types of the exported launchers
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the port's kernels")
    return path


def _lib_path(source: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = Path(source).stem
    return BUILD_ROOT / f"{stem}-{h.hexdigest()[:16]}" / f"lib{stem}.so"


def _start_build(source: str):
    out = _lib_path(source)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.NamedTemporaryFile(dir=out.parent, suffix=".so",
                                      delete=False).name
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
           str(CSRC / source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(proc, tmp: str, out: Path, source: str) -> str:
    log, _ = proc.communicate()
    (out.parent / "nvcc.log").write_text(log)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source} "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(sources: Sequence[str] = ()) -> Dict[str, str]:
    """Build every kernel source not built yet, one `nvcc` per source,
    all started together. Returns {source: nvcc log} of what it built."""
    sources = list(sources) or sorted(p.name for p in CSRC.glob("*.cu"))
    with _lock:
        todo = [s for s in sources if not _lib_path(s).exists()]
        started = [(s, *_start_build(s)) for s in todo]
        logs, errors = {}, []
        for s, proc, tmp, out in started:
            try:
                logs[s] = _finish_build(proc, tmp, out, s)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return logs


def _load(source: str) -> ctypes.CDLL:
    lib = _libs.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build_all([source])
        lib = ctypes.CDLL(str(path))
        lib.ncn_error_string.argtypes = [I]
        lib.ncn_error_string.restype = ctypes.c_char_p
        _libs[source] = lib
    return lib


def library(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built if it is not yet."""
    return _load(source)


class Kernel:
    """One exported C launcher: `int fn(args..., cudaStream_t)` that
    returns `cudaGetLastError()` after its launch."""

    def __init__(self, name: str, source: str, argtypes: List):
        self.name = name
        self.source = source
        self.argtypes = list(argtypes) + [P]   # trailing stream
        self.launches = 0
        self._fn = None

    @property
    def path(self) -> str:
        """Source path relative to the repository root."""
        return f"normal_clustering_nerf_torch/csrc/{self.source}"

    def launch(self, *args, device: torch.device):
        if self._fn is None:
            lib = _load(self.source)
            fn = getattr(lib, self.name)
            fn.argtypes = self.argtypes
            fn.restype = I
            self._fn, self._lib = fn, lib
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._fn(*args, stream)
        if err != 0:
            msg = self._lib.ncn_error_string(err).decode()
            raise RuntimeError(f"kernel {self.name} failed to launch: "
                               f"CUDA error {err} ({msg})")
        self.launches += 1


def ptr(t: torch.Tensor):
    return ctypes.c_void_p(t.data_ptr())


def check(t: torch.Tensor, name: str, dtype, shape=None, device=None):
    """Validate a kernel argument: CUDA, dtype, contiguity and shape."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    return ptr(t)


# H1, the bootstrap march: a launcher of H9's body
# the step grid's arguments of H1, H9 and H10 (`ops/ray_march.step_args`):
# lo, mip_bound, cascades, seven constants, the powers' table, its length
STEP_GRID = [F, F, I] + [F] * 7 + [P, I]
MARCH = Kernel("march_bootstrap", "march_fine.cu",
               [P] * 5 + [I] * 5 + STEP_GRID + [P] * 5)
TRIPLANE_FWD = Kernel("triplane_fwd", "triplane.cu",
                      [P, P, P, P, I, I, I, I, I, I, F, F, I, I])
TRIPLANE_BWD = Kernel("triplane_bwd", "triplane.cu",
                      [P, P, P, P, I, I, I, I, I, I, F, F, I])
# H12, the triplane encode's position gradient (extrinsic optimisation):
# H2's forward with its Jacobian and H2's backward with its contraction
TRIPLANE_FWD_JAC = Kernel("triplane_fwd_jac", "triplane.cu",
                          [P, P, P, P, P, I, I, I, I, I, I, F, F, I, I])
TRIPLANE_BWD_DX = Kernel("triplane_bwd_dx", "triplane.cu",
                         [P, P, P, P, P, P, I, I, I, I, I, I, F, F, I])
COMPOSITE_FWD = Kernel("composite_fwd", "composite.cu",
                       [P, P, P, P, P, P, I, I, I, F, P, P, P, P, P])
COMPOSITE_BWD = Kernel("composite_bwd", "composite.cu",
                       [P, P, P, P, P, P, P, P, P, I, I, I, F, P, P, P])
DISTORTION_FWD = Kernel("distortion_fwd", "distortion.cu",
                        [P, P, P, P, I, I, P])
DISTORTION_BWD = Kernel("distortion_bwd", "distortion.cu",
                        [P, P, P, P, P, I, I, P])
MARCH_SV_TRAIN = Kernel("march_sv_train", "march_sv.cu",
                        [P] * 6 + [I] * 7 + [F] * 4 + [P] * 5)
MARCH_SV_TEST = Kernel("march_sv_test_round", "march_sv.cu",
                       [P] * 7 + [I] * 6 + [F] * 3 + [P] * 4)

MARCH_FINE_TRAIN = Kernel("march_fine_train", "march_fine.cu",
                          [P] * 6 + [I] * 7 + STEP_GRID + [P] * 5)
MARCH_FINE_TEST = Kernel("march_fine_test_round", "march_fine.cu",
                         [P] * 6 + [I] * 4 + STEP_GRID + [P] * 4)
COMPACT = Kernel("compact_samples", "march_fine.cu",
                 [P] * 3 + [I] * 3 + [P] * 8)
COMPACT_RAYS = 64   # H11's rays a block: COMPACT_THREADS of march_fine.cu
COMPACT_MIN_WORDS = 4096   # H11's first buffer: up to 262,080 rays
_scan_work: Dict[tuple, torch.Tensor] = {}
_scan_retired: List[torch.Tensor] = []


def compact_words(n_rays: int) -> int:
    """64-bit words H11 uses for `n_rays` rays: the epoch and ticket, and
    the look-back status word of each block of COMPACT_RAYS rays."""
    return 1 + -(-n_rays // COMPACT_RAYS)


def scan_workspace(user: str, words: int, device: torch.device,
                   min_words: int = 0) -> torch.Tensor:
    """The work buffer of a single-pass scan (`csrc/look_back.cuh`) of
    `user` ("compact": H11; "occ": K8's occupied list; "merge": the grid
    barrier of K8's merge and pack; "adamw": K9's tickets) on `device`: one
    buffer a (user, device), allocated zeroed at its first use and kept
    for the process (each call is an epoch of it, so no call zeroes it
    again; a CUDA graph's replays use the buffer its capture saw, and a
    larger one replaces it for later calls, the old one kept). A user's
    calls on one device must follow each other on the stream."""
    key = (user, device)
    buf = _scan_work.get(key)
    if buf is None or buf.numel() < words:
        if buf is not None:
            _scan_retired.append(buf)
        buf = torch.zeros(max(words, min_words), dtype=torch.int64,
                          device=device)
        _scan_work[key] = buf
    return buf


def compact_workspace(n_rays: int, device: torch.device) -> torch.Tensor:
    """H11's work buffer on `device` (`scan_workspace`)."""
    return scan_workspace("compact", compact_words(n_rays), device,
                          COMPACT_MIN_WORDS)


COMPOSITE_SEG_FWD = Kernel("composite_seg_fwd", "composite.cu",
                           [P] * 8 + [I] * 2 + [F] + [P] * 5)
COMPOSITE_SEG_BWD = Kernel("composite_seg_bwd", "composite.cu",
                           [P] * 11 + [I] * 3 + [F] + [P] * 3)
DISTORTION_SEG_FWD = Kernel("distortion_seg_fwd", "distortion.cu",
                            [P] * 6 + [I] + [P])
DISTORTION_SEG_BWD = Kernel("distortion_seg_bwd", "distortion.cu",
                            [P] * 7 + [I] + [P])

BRICK_FWD = Kernel("brick_fwd", "brick_hash.cu", [P, P, P, P, I, I, I, I])
BRICK_BWD = Kernel("brick_bwd", "brick_hash.cu", [P, P, P, P, I, I, I, I])
HASH_FWD = Kernel("hash_grid_fwd", "hash_grid.cu", [P, P, P, P, I, I, I, I])
HASH_BWD = Kernel("hash_grid_bwd", "hash_grid.cu", [P, P, P, P, I, I, I, I])
# H13, the brick encode's position gradient: H5 with its Jacobian, and the
# Jacobian's contraction with the cotangent (H14's body)
BRICK_FWD_JAC = Kernel("brick_fwd_jac", "brick_hash.cu",
                       [P, P, P, P, P, I, I, I, I])
BRICK_CONTRACT = Kernel("brick_contract", "brick_hash.cu", [P, P, P, I, I, I])
# H14, the tcnn encode's position gradient: H7 with its Jacobian, and the
# Jacobian's contraction with the cotangent
HASH_FWD_JAC = Kernel("hash_grid_fwd_jac", "hash_grid.cu",
                      [P, P, P, P, P, I, I, I, I])
HASH_CONTRACT = Kernel("hash_grid_contract", "hash_grid.cu",
                       [P, P, P, I, I, I])

# K7, spherical k-means and the Manhattan cluster selection (ops/kmeans.py)
KMEANS_CLUSTER = Kernel("kmeans_cluster", "kmeans.cu",
                        [P] * 3 + [I] * 3 + [F] + [I] * 2 + [P] * 5)
# K8, the occupancy refresh (models/occupancy.py): the occupied list, the
# merge with the threshold and the pack, the march's tables; the union of
# several cards' bitfields
OCC_COMPACT = Kernel("occ_compact", "occupancy.cu", [P, F, I, I, P, P, P])
OCC_MERGE_PACK = Kernel("occ_merge_pack", "occupancy.cu",
                        [P, P, F, F, I, P, P, P, P, P])
OCC_TABLES = Kernel("occ_tables", "occupancy.cu", [P, I, P, P, P])
OCC_UNION = Kernel("occ_union", "occupancy.cu", [P, I, I, P])
# K9, the optimizer's update (ops/adamw.py): the global norm, then the
# clip, the moments and the step of every parameter
ADAMW_NORM = Kernel("adamw_norm", "adamw.cu", [P] * 5)
ADAMW_STEP = Kernel("adamw_step", "adamw.cu", [P] * 4 + [F] * 7)
# K10, the loss block (ops/loss_block.py): the normals and the rays' sums,
# the clusters' terms after K7, the gradient; each takes the Args struct
LOSS_RAYS = Kernel("loss_rays", "loss_block.cu", [P])
LOSS_CLUSTERS = Kernel("loss_clusters", "loss_block.cu", [P])
LOSS_BWD = Kernel("loss_bwd", "loss_block.cu", [P])
# K6, the field's four MLPs (ops/mlp.py): the forward (or the density
# mode), the backward with each block's partial weight gradients, and
# their reduction; each takes the Args struct
MLP_FWD = Kernel("mlp_fwd", "mlp.cu", [P])
MLP_BWD = Kernel("mlp_bwd", "mlp.cu", [P])
MLP_DW_REDUCE = Kernel("mlp_dw_reduce", "mlp.cu", [P])

ALL_KERNELS = (MARCH, TRIPLANE_FWD, TRIPLANE_BWD, COMPOSITE_FWD,
               COMPOSITE_BWD, DISTORTION_FWD, DISTORTION_BWD, MARCH_SV_TRAIN,
               MARCH_SV_TEST, BRICK_FWD, BRICK_BWD, HASH_FWD, HASH_BWD,
               MARCH_FINE_TRAIN, MARCH_FINE_TEST, COMPACT, COMPOSITE_SEG_FWD,
               COMPOSITE_SEG_BWD, DISTORTION_SEG_FWD, DISTORTION_SEG_BWD,
               TRIPLANE_FWD_JAC, TRIPLANE_BWD_DX, BRICK_FWD_JAC,
               BRICK_CONTRACT, HASH_FWD_JAC, HASH_CONTRACT, KMEANS_CLUSTER,
               OCC_COMPACT, OCC_MERGE_PACK, OCC_TABLES, OCC_UNION, ADAMW_NORM,
               ADAMW_STEP, LOSS_RAYS, LOSS_CLUSTERS, LOSS_BWD, MLP_FWD,
               MLP_BWD, MLP_DW_REDUCE)


def reset_counts():
    for k in ALL_KERNELS:
        k.launches = 0


def counts() -> Dict[str, int]:
    return {k.name: k.launches for k in ALL_KERNELS}


@contextlib.contextmanager
def capture_counts():
    """Around a CUDA graph capture: yields a dict that, after the block,
    holds {Kernel: launches} of the calls made in it, which are taken off
    the counts again (a capture records the launches; it runs none)."""
    before = {k: k.launches for k in ALL_KERNELS}
    rec: Dict[Kernel, int] = {}
    try:
        yield rec
    finally:
        for k in ALL_KERNELS:
            if k.launches != before[k]:
                rec[k] = k.launches - before[k]
                k.launches = before[k]


class CountedGraph:
    """A captured CUDA graph and the launches its capture recorded
    (`capture_counts`): each `replay` runs the graph and adds them to the
    counts."""

    def __init__(self, graph, counts: Dict[Kernel, int]):
        self.graph = graph
        self.counts = dict(counts)

    def replay(self):
        self.graph.replay()
        for k, n in self.counts.items():
            k.launches += n
