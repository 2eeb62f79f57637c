"""Build and bind the port's hand-written CUDA kernels.

`degrade_stencil.cu` is compiled with nvcc for sm_90a into a shared
library with a plain C interface, at first use, into `_build/` beside this
file (listed in .gitignore). The library's name carries a hash of the
source and the flags, so an edited source rebuilds and a stale build is
never loaded. The library is called through ctypes with `data_ptr()`s and
PyTorch's current CUDA stream; each launch's `cudaGetLastError()` comes
back as the return code, and a nonzero code raises. Nothing here falls
back to a plain version: a build or launch failure is an error.

`LAUNCHES` counts the launches of each kernel, by the name of the TPU
kernel it replaces, so a run can show which kernels its path went through
(`reset_launches()` sets every count to 0).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_SRC = Path(__file__).with_name("degrade_stencil.cu")
_BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None

#: launches per kernel, keyed by the TPU kernel each replaces:
#: degrade_v3 <- degrade_pallas.py:_degrade_kernel_v3 (+ noise variant),
#: degrade_v3psn <- degrade_pallas.py:_degrade_kernel_v3psn (+ noise)
LAUNCHES = {"degrade_v3": 0, "degrade_v3psn": 0}

LAYOUTS = {"nchw": 0, "chwb": 1, "presplit": 2}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile degrade_stencil.cu (if not already built) and return the
    shared library's path. The compiler's output, including ptxas's
    register and shared-memory report, is kept beside it as `<name>.log`.
    """
    tag = hashlib.sha256(
        _SRC.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so_path = _BUILD_DIR / f"libdegrade_stencil_{tag}.so"
    if so_path.exists():
        return so_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so_path.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {_SRC.name}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so_path)  # atomic: a concurrent builder sees all or none
    return so_path


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.kmsr_degrade_stencil.restype = ci
            lib.kmsr_degrade_stencil.argtypes = [
                vp, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp,
            ]
            lib.kmsr_cuda_error_string.restype = ctypes.c_char_p
            lib.kmsr_cuda_error_string.argtypes = [ci]
            _LIB = lib
    return _LIB


def _check(t: torch.Tensor, what: str, device: torch.device,
           dtypes=(torch.float32,)) -> None:
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}, expected one of {dtypes}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def degrade_stencil(
    x: torch.Tensor,
    comp: torch.Tensor,
    noise: torch.Tensor | None,
    out: torch.Tensor,
    *,
    layout: str,
    dims: tuple[int, int, int, int],
    factor: int,
) -> torch.Tensor:
    """Launch the fused degrade stencil: out = stencil(x, comp) (+ noise).

    x: float32 or bfloat16 in `layout` ("nchw", "chwb" or "presplit");
    dims: the image dims (C, H, W, B); comp: [C, K, K] float32 composed
    kernels; noise: None or float32 shaped like `out`; out: float32
    [B, C, H/f, W/f] (nchw) or [C, H/f, W/f, B]. All on one CUDA device
    and contiguous. Launches on the current stream, does not synchronize.
    """
    c, h, w, b = dims
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"degrade_stencil needs CUDA tensors, got {dev}")
    _check(x, "x", dev, tuple(_DTYPES))
    _check(comp, "comp", dev)
    _check(out, "out", dev)
    oh, ow = h // factor, w // factor
    want_out = (b, c, oh, ow) if layout == "nchw" else (c, oh, ow, b)
    if tuple(out.shape) != want_out:
        raise ValueError(f"out shape {tuple(out.shape)} != {want_out}")
    if x.numel() != c * h * w * b:
        raise ValueError(f"x has {x.numel()} elements, dims {dims} need "
                         f"{c * h * w * b}")
    k = comp.shape[-1]
    if tuple(comp.shape) != (c, k, k):
        raise ValueError(f"comp shape {tuple(comp.shape)} != {(c, k, k)}")
    if noise is not None:
        _check(noise, "noise", dev)
        if noise.shape != out.shape:
            raise ValueError(
                f"noise shape {tuple(noise.shape)} != {tuple(out.shape)}")
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.kmsr_degrade_stencil(
            x.data_ptr(), _DTYPES[x.dtype], LAYOUTS[layout], comp.data_ptr(),
            None if noise is None else noise.data_ptr(), out.data_ptr(),
            c, h, w, b, factor, k, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        reason = ("arguments refused" if rc < 0
                  else lib.kmsr_cuda_error_string(rc).decode())
        raise RuntimeError(
            f"degrade_stencil launch failed ({rc}: {reason}) for layout="
            f"{layout}, dims={dims}, factor={factor}, K={k}, "
            f"dtype={x.dtype}")
    LAUNCHES["degrade_v3psn" if layout == "presplit" else "degrade_v3"] += 1
    return out
