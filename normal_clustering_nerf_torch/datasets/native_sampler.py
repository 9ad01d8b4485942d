"""ctypes bindings of the native (C++) host-side batch prefetcher — the
JAX package's `datasets/native_sampler.py` for the port.

Streams gather-ready ray batches assembled by the port's own copy of
`raybatch.cpp` (`normal_clustering_nerf_torch/native/`): the reference's
16 DataLoader worker processes (reference: train_nerf.py:293-298) when
the trainer takes its batches from the host (`DataConfig.host_sampler`).
The library is built with g++ at first use into `build/native/` at the
repository root (listed in `.gitignore`), keyed by a hash of the source
and the flags; a failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_STRATEGIES = {
    "all_images": 0,
    "same_image": 1,
    "all_images_triang": 2,
    "same_image_triang": 3,
    "all_images_triang_patch": 4,
    "same_image_triang_patch": 5,
}

SOURCE = Path(__file__).resolve().parent.parent / "native" / "raybatch.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
# native/Makefile's flags, less -march=native (the library is built on the
# machine that runs it, but nothing here needs the host's vector units)
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_ROOT / f"raybatch-{h.hexdigest()[:16]}" / "libraybatch.so"


def build() -> Path:
    """Build the library unless it is built: g++ into a temporary file
    beside the target, renamed into place (so that processes building it
    at once never load half a file). Raises if g++ is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("g++ not found: the host sampler's library "
                           "(native/raybatch.cpp) is built with it")
    out.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=out.parent, suffix=".so")
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        Path(tmp).unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE} (exit "
                           f"{proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def _load_lib() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.rb_create.restype = ctypes.c_void_p
            lib.rb_create.argtypes = [
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
                ctypes.c_int32, ctypes.c_uint64,
            ]
            lib.rb_next.restype = ctypes.c_int32
            lib.rb_next.argtypes = [ctypes.c_void_p] + [ctypes.c_void_p] * 6
            lib.rb_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        return _lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None


class NativeRaySampler:
    """Threaded prefetching batch source over host-resident scene arrays.
    Each batch comes from its own stream, seeded with seed + its sequence
    number (raybatch.cpp:227-228), so with one thread the batches are a
    function of the seed; with several they arrive in the order the
    threads finish them."""

    def __init__(self, strategy: str, batch_size: int, img_wh, rgb: np.ndarray,
                 depth: Optional[np.ndarray] = None,
                 normals: Optional[np.ndarray] = None,
                 semantics: Optional[np.ndarray] = None,
                 max_expand: int = 0, patch_size: int = 8,
                 n_threads: int = 4, queue_depth: int = 8, seed: int = 0):
        if strategy not in _STRATEGIES:
            raise NotImplementedError(f"the host sampler has no strategy "
                                      f"{strategy!r}")
        self._lib = _load_lib()
        W, H = img_wh
        # the device sampler's effective batch: triangle strategies emit
        # whole (x1, x2, x3) triples, patch strategies whole patches
        if "triang_patch" in strategy:
            pa = patch_size ** 2
            batch_size = max(batch_size // pa, 1) * pa
        elif "triang" in strategy:
            batch_size = max(batch_size // 3, 1) * 3
        self.batch_size = batch_size
        # kept: the native prefetcher reads these buffers while it runs
        self._rgb = np.ascontiguousarray(rgb, np.float32)
        self._depth = (np.ascontiguousarray(depth, np.float32)
                       if depth is not None else None)
        self._normals = (np.ascontiguousarray(normals, np.float32)
                         if normals is not None else None)
        self._semantics = (np.ascontiguousarray(semantics, np.int32)
                           if semantics is not None else None)
        self._handle = self._lib.rb_create(
            _STRATEGIES[strategy], batch_size, self._rgb.shape[0], W, H,
            max_expand, patch_size, _ptr(self._rgb), _ptr(self._depth),
            _ptr(self._normals), _ptr(self._semantics), n_threads,
            queue_depth, seed)
        if not self._handle:
            raise RuntimeError("native prefetcher creation failed")

    def next_batch(self) -> Dict[str, np.ndarray]:
        """The next prefetched batch: img_idxs, pix_idxs (B,) int32, rgb
        (B, 3) and the labels the sampler was given."""
        if not self._handle:
            raise RuntimeError("the native prefetcher is closed")
        B = self.batch_size
        out = {"img_idxs": np.empty(B, np.int32),
               "pix_idxs": np.empty(B, np.int32),
               "rgb": np.empty((B, 3), np.float32)}
        if self._depth is not None:
            out["depth"] = np.empty(B, np.float32)
        if self._normals is not None:
            out["normals"] = np.empty((B, 3), np.float32)
        if self._semantics is not None:
            out["semantics"] = np.empty(B, np.int32)
        rc = self._lib.rb_next(
            self._handle, *(_ptr(out.get(k)) for k in (
                "img_idxs", "pix_idxs", "rgb", "depth", "normals",
                "semantics")))
        if rc != 0:
            raise RuntimeError("native prefetcher stopped")
        return out

    def close(self):
        """Stop the prefetcher's threads and free its queue."""
        if getattr(self, "_handle", None):
            self._lib.rb_destroy(self._handle)
            self._handle = None

    def __del__(self):
        self.close()
