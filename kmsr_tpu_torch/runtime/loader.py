"""ctypes binding + build for the native threaded patch loader.

The port's own copy of `kmsr_tpu.runtime.loader` over its own copy of
`csrc/patch_loader.cpp`. It builds with g++ at first use into `_build/`
beside this file (listed in .gitignore; the library's name carries a hash
of the source), so it never shares a library with the JAX package's
`~/.cache/kmsr_tpu`. Without a toolchain the caller falls back to numpy.

Two kinds of gather: the plain one (`gather`, `prefetch` / `wait`) returns
a natural [B, *shape] batch, for `data.sampler.StreamingPatchPool`; the
dual split gather writes into caller-owned buffers: the factory passes
numpy views of pinned host tensors, so the gathered batch goes to the card
with a non-blocking copy and no staging copy.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

_SRC = Path(__file__).parent / "csrc" / "patch_loader.cpp"
_BUILD_DIR = Path(__file__).parent / "_build"
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_THREADS = 8  # reader threads per loader


class NativeLoaderUnavailable(RuntimeError):
    pass


def _build_library() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so_path = _BUILD_DIR / f"patch_loader_{tag}.so"
    if so_path.exists():
        return so_path
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [
        "g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
        str(_SRC), "-o", str(tmp),
    ]
    try:
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, OSError) as e:
        detail = getattr(e, "stderr", None) or str(e)
        raise NativeLoaderUnavailable(f"g++ build failed: {detail}") from e
    os.replace(tmp, so_path)  # atomic: concurrent builders never see a partial .so
    return so_path


def _get_lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(_build_library()))
            lib.kmsr_loader_create.restype = ctypes.c_void_p
            lib.kmsr_loader_create.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
                ctypes.c_int64, ctypes.c_int,
            ]
            idx_args = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                        ctypes.c_int, ctypes.POINTER(ctypes.c_float)]
            for fn in (lib.kmsr_loader_gather, lib.kmsr_loader_prefetch):
                fn.restype = ctypes.c_int
                fn.argtypes = idx_args
            dual_args = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_float),
            ]
            lib.kmsr_loader_prefetch_split_dual.restype = ctypes.c_int
            lib.kmsr_loader_prefetch_split_dual.argtypes = dual_args
            lib.kmsr_loader_wait.restype = ctypes.c_int
            lib.kmsr_loader_wait.argtypes = [ctypes.c_void_p]
            lib.kmsr_loader_last_error.restype = ctypes.c_char_p
            lib.kmsr_loader_last_error.argtypes = [ctypes.c_void_p]
            lib.kmsr_loader_destroy.restype = None
            lib.kmsr_loader_destroy.argtypes = [ctypes.c_void_p]
            _LIB = lib
    return _LIB


def _f32_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64_ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _check_buffer(buf: np.ndarray, shape: tuple, what: str) -> None:
    if (buf.shape != shape or buf.dtype != np.float32
            or not buf.flags.c_contiguous or not buf.flags.writeable):
        raise ValueError(
            f"{what} buffer must be a writeable C-contiguous float32 array "
            f"of shape {shape}; got {buf.dtype} {buf.shape}")


class NativePatchLoader:
    """Threaded native gather of float32 .npy patches with async prefetch.

    Usage (double buffering):
        loader = NativePatchLoader(paths, shape=(5, 256, 256))
        loader.prefetch(idx0)
        batch = loader.wait()                       # [B, 5, 256, 256]
    or, for the factory's presplit route:
        loader.prefetch_split_dual(idx0, 8, out0, nat0)
        split, natural = loader.wait()              # the idx0 batch
        loader.prefetch_split_dual(idx1, 8, out1, nat1)  # overlaps the step
        ...device step on `split`...
    """

    def __init__(self, paths: Sequence[str], shape: tuple[int, ...]):
        self.paths = [str(p) for p in paths]
        self.shape = tuple(shape)
        self._floats = int(np.prod(shape))
        lib = _get_lib()
        arr = (ctypes.c_char_p * len(self.paths))(
            *[p.encode() for p in self.paths]
        )
        self._handle = lib.kmsr_loader_create(
            arr, len(self.paths), self._floats, _THREADS
        )
        if not self._handle:
            raise NativeLoaderUnavailable("loader create failed (bad npy files?)")
        self._lib = lib
        self._pending = None

    def _err(self) -> str:
        return self._lib.kmsr_loader_last_error(self._handle).decode()

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Read patches `indices` into a new [B, *shape] float32 array."""
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(indices), *self.shape), np.float32)
        rc = self._lib.kmsr_loader_gather(
            self._handle, _i64_ptr(indices), len(indices), _f32_ptr(out))
        if rc != 0:
            raise IOError(f"native gather failed: {self._err()}")
        return out

    def prefetch(self, indices: np.ndarray) -> None:
        """Start `gather(indices)` on the loader's threads; `wait()`
        returns the batch."""
        if self._pending is not None:
            raise RuntimeError("a prefetch is already in flight")
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(indices), *self.shape), np.float32)
        rc = self._lib.kmsr_loader_prefetch(
            self._handle, _i64_ptr(indices), len(indices), _f32_ptr(out))
        if rc != 0:
            raise IOError(f"native prefetch failed (rc={rc}): {self._err()}")
        self._pending = (indices, out)

    def prefetch_split_dual(
        self, indices: np.ndarray, factor: int, out: np.ndarray,
        nat: np.ndarray,
    ) -> None:
        """Async dual gather: ONE file read per patch fills both `out`, the
        halo-free pre-split layout [C, f, H/f, W, B] that
        `ops.degrade_fused.degrade_fused_presplit` takes, and `nat`, the
        natural [B, C, H, W] batch. `wait()` returns (out, nat); the
        buffers must stay untouched until then (this object keeps
        references to them)."""
        if self._pending is not None:
            raise RuntimeError("a prefetch is already in flight")
        if len(self.shape) != 3:
            raise ValueError(
                f"split gather needs [C, H, W] patches, loader shape is {self.shape}"
            )
        c, h, w = self.shape
        if h % factor or w % factor:
            raise ValueError(f"H, W must be multiples of factor: {(h, w, factor)}")
        indices = np.ascontiguousarray(indices, dtype=np.int64)
        n = len(indices)
        _check_buffer(out, (c, factor, h // factor, w, n), "split")
        _check_buffer(nat, (n, c, h, w), "natural")
        rc = self._lib.kmsr_loader_prefetch_split_dual(
            self._handle,
            indices.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n, c, h, w, factor, 0,  # halo=0: no baked replicate rows
            _f32_ptr(out), _f32_ptr(nat),
        )
        if rc != 0:
            raise IOError(
                f"native dual split prefetch failed (rc={rc}): {self._err()}"
            )
        self._pending = (indices, (out, nat))

    def wait(self):
        """The batch of the prefetch in flight: an array after `prefetch`,
        (out, nat) after `prefetch_split_dual`."""
        if self._pending is None:
            raise RuntimeError("no prefetch in flight")
        rc = self._lib.kmsr_loader_wait(self._handle)
        _, out = self._pending
        self._pending = None
        if rc != 0:
            raise IOError(f"native prefetch failed: {self._err()}")
        return out

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._lib.kmsr_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass
