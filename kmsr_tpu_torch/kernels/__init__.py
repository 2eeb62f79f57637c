"""Build and bind the port's hand-written CUDA kernels.

Each source here is compiled with nvcc for sm_90a into a shared library
with a plain C interface, at first use, into `_build/` beside this file
(listed in .gitignore):

* `degrade_stencil.cu` — the factory's fused degrade stencil
  (`degrade_stencil`);
* `scene_stencil.cu` — the whole-scene slab stencil (`scene_stencil_raw`,
  `scene_stencil_ext`).

A library's name carries a hash of its source and the flags, so an edited
source rebuilds and a stale build is never loaded; each source builds in
its own nvcc process, so callers may build them in parallel. The libraries are called through ctypes with
`data_ptr()`s and PyTorch's current CUDA stream; each launch's
`cudaGetLastError()` comes back as the return code, and a nonzero code
raises. Nothing here falls back to a plain version: a build or launch
failure is an error.

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

_DIR = Path(__file__).parent
_BUILD_DIR = _DIR / "_build"
SOURCES = ("degrade_stencil", "scene_stencil")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

#: launches per kernel, keyed by the TPU kernel each replaces:
#: degrade_v3 <- degrade_pallas.py:_degrade_kernel_v3 (+ noise variant),
#: degrade_v3psn <- degrade_pallas.py:_degrade_kernel_v3psn (+ noise),
#: colsplit_raw <- degrade_scene_fast.py:_colsplit_raw_kernel,
#: colsplit <- degrade_scene_fast.py:_colsplit_kernel
LAUNCHES = {"degrade_v3": 0, "degrade_v3psn": 0, "colsplit_raw": 0,
            "colsplit": 0}

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


def build(name: str = "degrade_stencil") -> Path:
    """Compile `<name>.cu` (if not already built) and return the shared
    library's path. The compiler's output, including ptxas's register and
    shared-memory report, is kept beside it as `<library>.log`.
    """
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}; one of {SOURCES}")
    src = _DIR / f"{name}.cu"
    tag = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    so_path = _BUILD_DIR / f"lib{name}_{tag}.so"
    if so_path.exists():
        return so_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so_path.with_suffix(".log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr
    )
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src.name}:\n"
            f"{proc.stderr[-4000:]}"
        )
    os.replace(tmp, so_path)  # atomic: a concurrent builder sees all or none
    return so_path


def _bind(name: str, lib: ctypes.CDLL) -> None:
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if name == "degrade_stencil":
        lib.kmsr_degrade_stencil.restype = ci
        lib.kmsr_degrade_stencil.argtypes = [
            vp, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp,
        ]
        lib.kmsr_cuda_error_string.restype = ctypes.c_char_p
        lib.kmsr_cuda_error_string.argtypes = [ci]
    else:
        lib.kmsr_scene_stencil.restype = ci
        lib.kmsr_scene_stencil.argtypes = [
            ci, vp, cl, cl, ci, vp, cl, cl, ci, vp, cl, cl, ci,
            vp, vp, ci, ci, ci, ci, ci, ci, vp,
        ]
        lib.kmsr_scene_cuda_error_string.restype = ctypes.c_char_p
        lib.kmsr_scene_cuda_error_string.argtypes = [ci]


def _lib(name: str = "degrade_stencil") -> ctypes.CDLL:
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build(name)))
            _bind(name, lib)
            _LIBS[name] = lib
    return _LIBS[name]


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


def _row_view(t: torch.Tensor, what: str, device: torch.device,
              c: int, w: int) -> tuple[int, int]:
    """(channel stride, row stride) of a [c, rows, w] float32 view with
    unit column stride, the layout the scene stencil reads in place."""
    if t.device != device:
        raise ValueError(f"{what} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{what} has dtype {t.dtype}, expected torch.float32")
    if t.ndim != 3 or t.shape[0] != c or t.shape[2] != w:
        raise ValueError(f"{what} shape {tuple(t.shape)} is not [{c}, rows, {w}]")
    if t.stride(2) != 1 and w > 1:
        raise ValueError(f"{what} must have unit column stride, got {t.stride()}")
    return t.stride(0), t.stride(1)


def _scene_launch(raw: bool, x, top, bot, comp, out, factor, row0, hs):
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"scene_stencil needs CUDA tensors, got {dev}")
    c, x_rows, w = x.shape
    x_cs, x_rs = _row_view(x, "x", dev, c, w)
    top_cs, top_rs = _row_view(top, "top_rows", dev, c, w)
    bot_cs, bot_rs = _row_view(bot, "bot_rows", dev, c, w)
    _check(comp, "comp", dev)
    _check(out, "out", dev)
    k = comp.shape[-1]
    if tuple(comp.shape) != (c, k, k):
        raise ValueError(f"comp shape {tuple(comp.shape)} != {(c, k, k)}")
    want_out = (c, hs // factor, w // factor)
    if tuple(out.shape) != want_out:
        raise ValueError(f"out shape {tuple(out.shape)} != {want_out}")
    lib = _lib("scene_stencil")
    with torch.cuda.device(dev):
        rc = lib.kmsr_scene_stencil(
            int(raw), x.data_ptr(), x_cs, x_rs, x_rows,
            top.data_ptr(), top_cs, top_rs, top.shape[1],
            bot.data_ptr(), bot_cs, bot_rs, bot.shape[1],
            comp.data_ptr(), out.data_ptr(), c, hs, w, row0, factor, k,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        reason = ("arguments refused" if rc < 0
                  else lib.kmsr_scene_cuda_error_string(rc).decode())
        raise RuntimeError(
            f"scene_stencil launch failed ({rc}: {reason}) for "
            f"{'raw' if raw else 'ext'} rows, x {tuple(x.shape)}, halos "
            f"({top.shape[1]}, {bot.shape[1]}), row0={row0}, factor={factor}, "
            f"K={k}")
    LAUNCHES["colsplit_raw" if raw else "colsplit"] += 1
    return out


def scene_stencil_raw(
    x: torch.Tensor,
    top_rows: torch.Tensor,
    bot_rows: torch.Tensor,
    comp: torch.Tensor,
    out: torch.Tensor,
    *,
    factor: int,
) -> torch.Tensor:
    """Launch the scene stencil on a raw slab: out = stencil(x, comp) with
    slab row y < 0 read from top_rows[th + y] and y >= Hs from
    bot_rows[y - Hs] (the counterpart of `_colsplit_raw_kernel`).

    x [C, Hs, W], top_rows [C, th, W], bot_rows [C, bh, W]: float32 views
    with unit column stride (read in place, never concatenated), th and bh
    at least `halo_rows(factor, K)`; comp [C, K, K] and out [C, Hs/f, W/f]
    float32 contiguous; all on one CUDA device. Launches on the current
    stream, does not synchronize.
    """
    return _scene_launch(True, x, top_rows, bot_rows, comp, out, factor, 0,
                         x.shape[1])


def scene_stencil_ext(
    x_ext: torch.Tensor,
    comp: torch.Tensor,
    out: torch.Tensor,
    *,
    factor: int,
    top: int,
) -> torch.Tensor:
    """Launch the scene stencil on a halo-extended slab: slab row y is
    x_ext[top + y] (the counterpart of `_colsplit_kernel`); out has
    Hs = out.shape[1] * factor slab rows. x_ext [C, top + Hs + bot, W] is a
    float32 view with unit column stride; comp, out as for
    `scene_stencil_raw`."""
    return _scene_launch(False, x_ext, x_ext, x_ext, comp, out, factor, top,
                         out.shape[1] * factor)
