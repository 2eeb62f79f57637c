"""Build and bind the port's hand-written CUDA kernels.

Each source here is compiled with nvcc for sm_90a into a shared library
with a plain C interface, at first use, into `_build/` beside this file
(listed in .gitignore):

* `degrade_stencil.cu` — the factory's fused degrade stencil
  (`degrade_stencil`, versions 3: the v3, v3psn and v3ps instantiations),
  its input rows streamed through a shared-memory ring, each thread
  keeping the outputs still open in its column, at most ceil(K/f)
  (`stencil_tiles` is its plan);
* `degrade_wide.cu` — the wide-span stencil tiled through shared memory
  (`degrade_stencil`, versions 2 and 1; `wide_tiles` is its plan);
* `degrade_dense.cu` — the banded stencil-matrix degrade on the tensor
  cores, A generated per tile on chip (`degrade_dense`, the v4
  counterpart; `dense_tiles` is its tile and band table);
* `scene_stencil.cu` — the whole-scene slab stencil (`scene_stencil_raw`,
  `scene_stencil_ext`), the same row ring on a [C, rows, W] plane
  (`scene_tiles` is its plan);
* `swin_norm.cu` — SwinIR's LayerNorm over the stream's rows (their first
  C channels; the zero pad past them written 0) with the window
  attention's token gather and residual add folded in
  (`swin_norm_rows`, `swin_add_norm_rows`; `norm_plan` is its plan). It
  replaces no TPU kernel: the JAX package's SwinIR has none.

The ring and wide sources also hold a global-read instantiation, planned
(`RING_DIRECT`, `WIDE_DIRECT`) only where no tile fits a block's shared
memory, i.e. at spans far wider than the shipped 13x13 blur's: a thread
sums one output from global memory through the read-only cache, in its
version's tap order, so every span JAX's guards accept is taken.

A library's name carries a hash of its source, the `*.cuh` headers beside
it (`stencil_ring.cuh`, the ring walk the v3 and scene kernels share) and
the flags, so an edited source or header rebuilds and a stale build is
never loaded; each source builds in
its own nvcc process, so callers may build them in parallel. The libraries are called through ctypes with
`data_ptr()`s and PyTorch's current CUDA stream; each launch's
`cudaGetLastError()` comes back as the return code, and a nonzero code
raises. Nothing here falls back to a plain version: a build or launch
failure is an error.

`LAUNCHES` counts the launches of each kernel, by the name of the TPU
kernel it replaces (the SwinIR norm's by its own entry points), so a run
can show which kernels its path went through (`reset_launches()` sets every
count to 0).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_DIR = Path(__file__).parent
_BUILD_DIR = _DIR / "_build"
SOURCES = ("degrade_stencil", "degrade_wide", "degrade_dense", "scene_stencil", "swin_norm")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}

#: launches per kernel, keyed by the TPU kernel each replaces (each with
#: its noise variant):
#: degrade_v3 <- degrade_pallas.py:_degrade_kernel_v3,
#: degrade_v3psn <- degrade_pallas.py:_degrade_kernel_v3psn,
#: degrade_v3ps <- degrade_pallas.py:_degrade_kernel_v3ps,
#: degrade_v2 <- degrade_pallas.py:_degrade_kernel_v2,
#: degrade_v1 <- degrade_pallas.py:_degrade_kernel,
#: degrade_v4 <- degrade_pallas.py:_degrade_kernel_v4,
#: colsplit_raw <- degrade_scene_fast.py:_colsplit_raw_kernel,
#: colsplit <- degrade_scene_fast.py:_colsplit_kernel;
#: swin_norm_rows, swin_add_norm_rows <- none (SwinIR's XLA LayerNorms)
LAUNCHES = {"degrade_v3": 0, "degrade_v3psn": 0, "degrade_v3ps": 0,
            "degrade_v2": 0, "degrade_v1": 0, "degrade_v4": 0,
            "colsplit_raw": 0, "colsplit": 0,
            "swin_norm_rows": 0, "swin_add_norm_rows": 0}

LAYOUTS = {"nchw": 0, "chwb": 1, "presplit": 2, "presplit_halo": 3}
#: the wide-span kernel's tap order, by the JAX version it follows
WIDE_MODES = {2: 1, 1: 2}
#: output columns per dense-kernel tile: the widest of these dividing w/f
DENSE_TILE_N = (24, 16, 8)
#: outputs a wide-span thread sums down one column (degrade_wide.cu's R)
WIDE_R = 8
#: a block's shared-memory limit on sm_90, bytes
SMEM_MAX = 232448
#: row buffers of the v3 and scene kernels' ring, and the accumulators a
#: thread keeps at run-time shapes (stencil_ring.cuh's kRing and kSlots)
RING = 4
RING_SLOTS = 8
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _call(dev: torch.device, fn, *args) -> int:
    """fn(*args, stream) with `dev` current and PyTorch's current stream on
    it (the kernels launch there). The stream is read as its raw handle, not
    built into a `torch.cuda.Stream`, and the device switch is skipped when
    `dev` is current already: a few microseconds of host time a launch each."""
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    if dev.index == torch.cuda.current_device():
        return fn(*args, stream)
    with torch.cuda.device(dev):
        return fn(*args, stream)


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


def _source_tag(name: str, flags: tuple[str, ...] = NVCC_FLAGS) -> str:
    """Hash of `<name>.cu`, every `*.cuh` header beside it (a source
    includes them by name) and the flags."""
    h = hashlib.sha256((_DIR / f"{name}.cu").read_bytes())
    for header in sorted(_DIR.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build(name: str = "degrade_stencil", defines: tuple[str, ...] = ()) -> Path:
    """Compile `<name>.cu` (if not already built) and return the shared
    library's path. `defines` ("NAME=VALUE") go to nvcc as -D flags and
    into the library's tag, for building a variant beside the default. The
    compiler's output, including ptxas's register and shared-memory
    report, is kept beside it as `<library>.log`.
    """
    if name not in SOURCES:
        raise ValueError(f"unknown kernel source {name!r}; one of {SOURCES}")
    src = _DIR / f"{name}.cu"
    flags = NVCC_FLAGS + tuple(f"-D{d}" for d in defines)
    so_path = _BUILD_DIR / f"lib{name}_{_source_tag(name, flags)}.so"
    if so_path.exists():
        return so_path
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so_path.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_nvcc(), *flags, "-o", str(tmp), str(src)]
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
            vp, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
            ci, ci, ci, ci, vp,
        ]
        lib.kmsr_cuda_error_string.restype = ctypes.c_char_p
        lib.kmsr_cuda_error_string.argtypes = [ci]
    elif name == "degrade_wide":
        lib.kmsr_degrade_wide.restype = ci
        lib.kmsr_degrade_wide.argtypes = [
            vp, ci, ci, ci, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci,
            ci, ci, ci, ci, ci, vp,
        ]
        lib.kmsr_wide_cuda_error_string.restype = ctypes.c_char_p
        lib.kmsr_wide_cuda_error_string.argtypes = [ci]
    elif name == "degrade_dense":
        lib.kmsr_degrade_dense.restype = ci
        lib.kmsr_degrade_dense.argtypes = [
            vp, ci, vp, vp, ci, ci, ci, vp, vp, ci, ci, ci, ci, ci, ci,
            cl, cl, cl, cl, cl, cl, vp,
        ]
        lib.kmsr_dense_cuda_error_string.restype = ctypes.c_char_p
        lib.kmsr_dense_cuda_error_string.argtypes = [ci]
    elif name == "swin_norm":
        lib.kmsr_swin_norm.restype = ci
        lib.kmsr_swin_norm.argtypes = [
            ci, ci, vp, vp, vp, vp, vp, vp, vp, cl, cl, ci, ci, ci, ci,
            ctypes.c_double, vp,
        ]
        lib.kmsr_swin_norm_error_string.restype = ctypes.c_char_p
        lib.kmsr_swin_norm_error_string.argtypes = [ci]
    else:
        lib.kmsr_scene_stencil.restype = ci
        lib.kmsr_scene_stencil.argtypes = [
            ci, vp, cl, cl, ci, vp, cl, cl, ci, vp, cl, cl, ci,
            vp, vp, ci, ci, ci, ci, ci, ci, ci, ci, ci, ci, vp,
        ]
        lib.kmsr_scene_cuda_error_string.restype = ctypes.c_char_p
        lib.kmsr_scene_cuda_error_string.argtypes = [ci]


def _lib(name: str = "degrade_stencil") -> ctypes.CDLL:
    lib = _LIBS.get(name)  # built and bound: no lock
    if lib is not None:
        return lib
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


def _stencil_launch_name(layout: str, version: int) -> str:
    if version != 3:
        return f"degrade_v{version}"
    return {"presplit": "degrade_v3psn",
            "presplit_halo": "degrade_v3ps"}.get(layout, "degrade_v3")


def degrade_stencil(
    x: torch.Tensor,
    comp: torch.Tensor,
    noise: torch.Tensor | None,
    out: torch.Tensor,
    *,
    layout: str,
    dims: tuple[int, int, int, int],
    factor: int,
    version: int = 3,
    half: int | None = None,
    halo: int = 0,
) -> torch.Tensor:
    """Launch the fused degrade stencil: out = stencil(x, comp) (+ noise).

    x: float32 or bfloat16 in `layout` ("nchw", "chwb", "presplit" or
    "presplit_halo", the last with `halo` replicate rows baked at each end
    of every phase); dims: the image dims (C, H, W, B); comp: [C, K, K]
    float32 composed kernels; version: the JAX kernel whose tap order to
    follow (3: v3/v3psn/v3ps, `degrade_stencil.cu`; 2 on "nchw"/"chwb" and
    1 on "chwb" only, the layouts that reach them, `degrade_wide.cu`;
    others are refused); half: the tap offset (default (K - f) // 2, the
    v3 family's; v1/v2 take the blur kernel's kh // 2); noise: None or
    float32 shaped like `out`; out: float32 [B, C, H/f, W/f] (nchw) or
    [C, H/f, W/f, B]. All on one CUDA device and contiguous. Launches on
    the current stream, does not synchronize.
    """
    c, h, w, b = dims
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"degrade_stencil needs CUDA tensors, got {dev}")
    if layout not in LAYOUTS or version not in (3, *WIDE_MODES):
        raise ValueError(f"unknown layout {layout!r} or version {version!r}")
    _check(x, "x", dev, tuple(_DTYPES))
    _check(comp, "comp", dev)
    _check(out, "out", dev)
    oh, ow = h // factor, w // factor
    want_out = (b, c, oh, ow) if layout == "nchw" else (c, oh, ow, b)
    if tuple(out.shape) != want_out:
        raise ValueError(f"out shape {tuple(out.shape)} != {want_out}")
    halo = halo if layout == "presplit_halo" else 0
    n_x = c * (h + 2 * halo * factor) * w * b
    if x.numel() != n_x:
        raise ValueError(f"x has {x.numel()} elements, dims {dims} with "
                         f"halo {halo} need {n_x}")
    k = comp.shape[-1]
    if tuple(comp.shape) != (c, k, k):
        raise ValueError(f"comp shape {tuple(comp.shape)} != {(c, k, k)}")
    if noise is not None:
        _check(noise, "noise", dev)
        if noise.shape != out.shape:
            raise ValueError(
                f"noise shape {tuple(noise.shape)} != {tuple(out.shape)}")
    half = (k - factor) // 2 if half is None else half
    wide = version in WIDE_MODES
    lib = _lib("degrade_wide" if wide else "degrade_stencil")
    n_ptr = None if noise is None else noise.data_ptr()
    if wide:
        # the kernel refuses the presplit layouts (and an empty plan)
        plan = (wide_tiles(layout, k, factor, h)
                if layout in ("nchw", "chwb") else (0,) * 5)
        rc = _call(dev, lib.kmsr_degrade_wide, x.data_ptr(), _DTYPES[x.dtype],
                   LAYOUTS[layout], WIDE_MODES[version], comp.data_ptr(),
                   n_ptr, out.data_ptr(), c, h, w, b, factor, k, half, *plan)
    else:
        rc = _call(dev, lib.kmsr_degrade_stencil, x.data_ptr(),
                   _DTYPES[x.dtype], LAYOUTS[layout], comp.data_ptr(), n_ptr,
                   out.data_ptr(), c, h, w, b, factor, k, half, halo,
                   *stencil_tiles(layout, k, factor, h, w, b))
    if rc != 0:
        errstr = (lib.kmsr_wide_cuda_error_string if wide
                  else lib.kmsr_cuda_error_string)
        reason = "arguments refused" if rc < 0 else errstr(rc).decode()
        raise RuntimeError(
            f"degrade_stencil launch failed ({rc}: {reason}) for layout="
            f"{layout}, version={version}, dims={dims}, factor={factor}, "
            f"K={k}, half={half}, halo={halo}, dtype={x.dtype}")
    LAUNCHES[_stencil_launch_name(layout, version)] += 1
    return out


def wide_tiles(layout: str, ksize: int, factor: int,
               h: int) -> tuple[int, int, int, int, int]:
    """The wide-span (v1/v2) kernel's tile plan: (ti, tj, rows, cols, noc).

    A block sums ti x tj outputs (NCHW: tj = 32 output columns, a warp;
    CHWB: tj columns of a 32-wide batch slice), WIDE_R down each thread's
    column, and stages its input window one row phase dyi at a time:
    `rows` window rows f*q + dyi and `cols` window columns (NCHW: per
    column phase x % f), two phases in shared memory beside comp in
    lattice order. noc row taps share one register window: 7 for the x2
    lattice (f = 2, ceil(K/f) = 7), which has a compile-time instantiation,
    else 4, in chunks. The largest tile that fits is taken: NCHW 8, 4, 2
    or 1 row groups of WIDE_R (no more than the image's h/f output rows
    need), CHWB 2 x 8, 1 x 8, 1 x 4, 1 x 2 or 1 x 1 (row groups x columns).
    Where none fits (the window grows as K^2/f: CHWB K > 32 at f = 2), the
    plan is `WIDE_DIRECT`: the kernel's global-read instantiation, a
    thread an output with no shared memory.
    """
    n_o = -(-ksize // factor)
    noc = 7 if (factor, n_o) == (2, 7) else 4
    n_chunk = -(-n_o // noc) * noc
    oh = h // factor
    if layout == "nchw":
        tries = [(g, 32) for g in (8, 4, 2, 1) if g == 1 or g // 2 * WIDE_R < oh]
    elif layout == "chwb":
        tries = [(2, 8), (1, 8), (1, 4), (1, 2), (1, 1)]
    else:
        raise ValueError(f"the wide-span kernel takes nchw or chwb, got {layout!r}")
    table = -(-factor * ksize * (-(-n_chunk // 4) * 4) // 4) * 4  # floats
    for groups, tj in tries:
        ti = groups * WIDE_R
        rows = ti - 1 + n_chunk
        if layout == "nchw":
            cols = tj - 1 + n_o
            phase = rows * factor * cols
        else:
            cols = factor * (tj - 1 + n_o)
            phase = rows * cols * 32
        if 4 * (table + 2 * phase) <= SMEM_MAX:
            return ti, tj, rows, cols, noc
    return WIDE_DIRECT


#: the plans of the kernels' global-read instantiations, taken where no
#: tile fits shared memory: a thread sums one output straight from global
#: memory (comp and pixels through the read-only cache), same tap order
RING_DIRECT = (0, 0, 0, 0)
WIDE_DIRECT = (0, 0, 0, 0, 4)
#: output rows a v3 block walks down each column (`stencil_tiles`)
STENCIL_TI = 8
#: output rows a scene block walks down each column (`scene_tiles`)
SCENE_TI = 16


def _phase_cols(n: int, factor: int) -> int:
    """Staged columns per column phase of a phase-split window row: at
    least n, and, where f divides 32, congruent to 32/f mod 32, so the 32
    consecutive columns a warp stores land in 32 distinct banks."""
    if 32 % factor == 0:
        n += (32 // factor - n) % 32
    return n


def ring_smem(ksize: int, row: int, span: int, tables: int) -> int:
    """Shared-memory bytes of a ring kernel's block: comp[c] (K rows of K
    floats, each padded to a multiple of 4), RING row buffers of `row`
    floats and `tables` int column tables of `span` entries."""
    return 4 * (ksize * (-(-ksize // 4) * 4) + RING * row + tables * span)


def _ring_plan(what: str, phase_split: bool, ksize: int, factor: int,
               oh: int, ow: int, ti: int,
               tj: int | None) -> tuple[int, int, int, int]:
    """(ti, tj, cols, row) of a ring kernel's block: ti output rows (no
    more than oh, nor than RING_SLOTS where ceil(K/f) is larger) x tj
    output columns. phase_split: a lane a column, tj = 128, 64 or 32 (no
    more than ow needs), `cols` window columns per column phase
    (`_phase_cols`); else a warp a column of a 32-wide batch slice, tj =
    4, 2 or 1, `cols` = f*(tj-1) + K window columns of 32 entries. The
    first tj whose block fits shared memory is taken, or `tj` if given.
    Where none fits (comp's K x K copy and the ring rows: batch-minor
    K > 184, phase-split K > 236 at f <= 4), `RING_DIRECT`, the global-read
    instantiation."""
    if oh < 1 or ow < 1:
        raise ValueError(f"empty {what} output: {oh} x {ow}")
    n_o = -(-ksize // factor)
    ti = min(ti, oh) if n_o <= RING_SLOTS else min(ti, oh, RING_SLOTS)
    unit = 32 if phase_split else 1
    tries = [tj] if tj else [unit * n for n in (4, 2, 1)
                             if n == 1 or unit * (n // 2) < ow]
    for tj in tries:
        span = factor * (tj - 1) + ksize
        if phase_split:
            cols = _phase_cols(tj - 1 + n_o, factor)
            row, tables = -(-factor * cols // 4) * 4, 2
        else:
            cols, row, tables = span, span * 32, 1
        if ring_smem(ksize, row, span, tables) <= SMEM_MAX:
            return ti, tj, cols, row
    return RING_DIRECT


def stencil_tiles(layout: str, ksize: int, factor: int, h: int, w: int,
                  b: int, ti: int = STENCIL_TI,
                  tj: int | None = None) -> tuple[int, int, int, int]:
    """The v3-family kernel's tile plan: (ti, tj, cols, row).

    A block owns ti output rows x tj output columns of one channel and
    streams the f*(ti-1) + K input rows they read, f*(tj-1) + K columns
    wide, through a ring of RING row buffers of `row` floats; each thread
    keeps the outputs still open in its column. Batch-minor maps ("chwb",
    "presplit", "presplit_halo"): tj columns of a 32-wide batch slice, one
    warp a column (4, the fastest of 2, 4 and 8 at the factory's shape by
    `scripts/torch_stencil_sweep.py`), `cols` window columns of 32 batch
    entries. "nchw": tj = 32, 64 or 128 columns of one image, a lane a
    column, `cols` window columns per column phase. ti is STENCIL_TI,
    fewer where h/f is smaller or ceil(K/f) exceeds RING_SLOTS; the last
    row and column tiles and the last batch slice are masked, so any h, w
    (multiples of f) and any batch b >= 1 is covered. ti and tj may be
    given (the sweep's other plans).
    """
    if layout not in LAYOUTS:
        raise ValueError(f"unknown layout {layout!r}")
    if b < 1:
        raise ValueError(f"empty batch: b={b}")
    return _ring_plan("v3", layout == "nchw", ksize, factor, h // factor,
                      w // factor, ti, tj)


def scene_tiles(ksize: int, factor: int, hs: int, w: int, ti: int = SCENE_TI,
                tj: int | None = None) -> tuple[int, int, int, int]:
    """The scene kernel's tile plan: (ti, tj, cols, row), the NCHW walk of
    `stencil_tiles` on one [C, rows, W] plane with ti = SCENE_TI output
    rows (or fewer, as there) a block. Partial tiles are masked."""
    return _ring_plan("scene", True, ksize, factor, hs // factor, w // factor,
                      ti, tj)


@functools.lru_cache(maxsize=32)
def _dense_plan(ksize: int, factor: int, h: int, w: int,
                device: torch.device) -> tuple[int, torch.Tensor, int]:
    tn, tiles = dense_tiles(ksize, factor, h, w)
    max_band = int((tiles[:, 3] * tiles[:, 5]).max())
    return tn, tiles.to(device), max_band


def dense_tiles(ksize: int, factor: int, h: int,
                w: int) -> tuple[int, torch.Tensor]:
    """The dense (v4) kernel's output tiles and the band each one reads.

    One tile per output row i and run of tn output columns from j0 (tn: the
    widest of `DENSE_TILE_N` that divides w // factor). Its band is the
    input rows y0 .. y0+nr-1 and columns x0 .. x0+nc-1 that the tile's taps
    clamp(f*i + dy - half), clamp(f*j + dx - half) reach, half = (K-f)//2,
    x0 and nc widened to multiples of 8 (whole 16-byte runs of an image
    row). The kernel generates the stencil matrix's entries over that band
    only and contracts over it. Returns (tn, int32 [n_tiles, 6] of
    (i, j0, y0, nr, x0, nc)) on the CPU.
    """
    half = (ksize - factor) // 2
    oh, ow = h // factor, w // factor
    if w % 8 or ow % 8 or h % factor or oh < 1:
        raise ValueError(f"the dense kernel needs w and w // factor multiples "
                         f"of 8 and h a multiple of factor; got h={h}, w={w}, "
                         f"factor={factor}")
    tn = next(t for t in DENSE_TILE_N if ow % t == 0)

    def reach(first: int, last: int, size: int) -> tuple[int, int]:
        lo = min(max(factor * first - half, 0), size - 1)
        hi = min(max(factor * last - half + ksize - 1, 0), size - 1)
        return lo, hi

    rows = []
    for i in range(oh):
        y0, y1 = reach(i, i, h)
        for j0 in range(0, ow, tn):
            xlo, xhi = reach(j0, j0 + tn - 1, w)
            x0, x1 = xlo // 8 * 8, min(-(-(xhi + 1) // 8) * 8, w)
            rows.append((i, j0, y0, y1 - y0 + 1, x0, x1 - x0))
    return tn, torch.tensor(rows, dtype=torch.int32)


def degrade_dense(
    x: torch.Tensor,
    comp: torch.Tensor,
    noise: torch.Tensor | None,
    out: torch.Tensor,
    *,
    layout: str,
    factor: int,
) -> torch.Tensor:
    """Launch the banded degrade (the v4 counterpart) on the tensor cores:
    out[c] = sum_{i+j<=2} A_i[c] . x_j[c] (+ noise), with the stencil
    matrix's three bf16 terms A_i generated per output tile in shared
    memory from `comp`, over the tile's band only (`dense_tiles`), and x
    split into its bf16 terms in the kernel.

    x: float32 or bfloat16, [B, C, h, w] ("nchw") or [C, h, w, B]
    ("chwb"), w and w // factor multiples of 8; comp: [C, K, K] float32
    composed kernels; noise: None or float32 shaped like `out`; out:
    float32 [B, C, h/f, w/f] (nchw) or [C, h/f, w/f, B]. All on one CUDA
    device and contiguous. Launches on the current stream, does not
    synchronize.
    """
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"degrade_dense needs CUDA tensors, got {dev}")
    if layout not in ("nchw", "chwb"):
        raise ValueError(f"degrade_dense takes nchw or chwb, got {layout!r}")
    _check(x, "x", dev, tuple(_DTYPES))
    _check(comp, "comp", dev)
    _check(out, "out", dev)
    if x.ndim != 4 or out.ndim != 4 or comp.ndim != 3:
        raise ValueError("x and out must be 4-D and comp [C, K, K]")
    if layout == "nchw":
        b, c, h, w = x.shape
        want_out = (b, c, h // factor, w // factor)
    else:
        c, h, w, b = x.shape
        want_out = (c, h // factor, w // factor, b)
    if tuple(out.shape) != want_out:
        raise ValueError(f"out shape {tuple(out.shape)} != {want_out}")
    k = comp.shape[-1]
    if tuple(comp.shape) != (c, k, k):
        raise ValueError(f"comp shape {tuple(comp.shape)} != {(c, k, k)}")
    if noise is not None:
        _check(noise, "noise", dev)
        if noise.shape != out.shape:
            raise ValueError(
                f"noise shape {tuple(noise.shape)} != {tuple(out.shape)}")
    tn, tiles, max_band = _dense_plan(k, factor, h, w, dev)
    kd, m = h * w, (h // factor) * (w // factor)
    if layout == "nchw":
        x_strides, o_strides = (kd, 1, c * kd), (m, 1, c * m)
    else:
        x_strides, o_strides = (kd * b, b, 1), (m * b, b, 1)
    lib = _lib("degrade_dense")
    rc = _call(dev, lib.kmsr_degrade_dense, x.data_ptr(), _DTYPES[x.dtype],
               comp.data_ptr(), tiles.data_ptr(), tiles.shape[0], max_band, tn,
               None if noise is None else noise.data_ptr(), out.data_ptr(),
               c, h, w, b, factor, k, *x_strides, *o_strides)
    if rc != 0:
        reason = ("arguments refused" if rc < 0
                  else lib.kmsr_dense_cuda_error_string(rc).decode())
        raise RuntimeError(
            f"degrade_dense launch failed ({rc}: {reason}) for layout="
            f"{layout}, x {tuple(x.shape)}, comp {tuple(comp.shape)}, "
            f"factor={factor}, dtype={x.dtype}")
    LAUNCHES["degrade_v4"] += 1
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
    rc = _call(dev, lib.kmsr_scene_stencil, int(raw), x.data_ptr(), x_cs,
               x_rs, x_rows, top.data_ptr(), top_cs, top_rs, top.shape[1],
               bot.data_ptr(), bot_cs, bot_rs, bot.shape[1], comp.data_ptr(),
               out.data_ptr(), c, hs, w, row0, factor, k,
               *scene_tiles(k, factor, hs, w))
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


#: the SwinIR norm's element types (swin_norm.cu's dtype codes)
_NORM_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
#: vectors a lane of the SwinIR norm keeps in registers (swin_norm.cu's kChunks)
NORM_CHUNKS = 8


def norm_plan(cw: int, esize: int, ptrs: tuple[int, ...],
              c: int | None = None) -> tuple[int, int]:
    """The SwinIR norm's plan for rows of `cw` elements of `esize` bytes
    normed over their first `c` (None: all cw): (vec_bytes, lpr). A lane
    loads vectors of the widest of 16, 8, 4 or 2 bytes, no fewer than one
    element, that divides the norm's bytes, the row's and the address of
    every tensor `ptrs` holds (one element always does), so a vector is all
    norm or all pad; a row takes the fewest lanes, a power of 2 up to a
    warp, that hold the norm's vectors in NORM_CHUNKS each."""
    low = 0
    for p in ptrs:  # a power of 2 divides every address iff it divides their OR
        low |= p
    return _norm_plan(cw if c is None else c, cw, esize, low & 15)


@functools.lru_cache(maxsize=None)
def _norm_plan(c: int, cw: int, esize: int, low: int) -> tuple[int, int]:
    vb = next(v for v in (16, 8, 4, 2)
              if v >= esize and c * esize % v == 0 and cw * esize % v == 0 and low % v == 0)
    nvec = c * esize // vb
    lpr = 1
    while lpr < 32 and lpr * NORM_CHUNKS < nvec:
        lpr *= 2
    return vb, lpr


def _swin_norm(f, a, idx, w, b, eps: float):
    """Check the inputs, allocate the outputs and launch: (f_new or None, y)."""
    dev = f.device
    if dev.type != "cuda":
        raise ValueError(f"the SwinIR norm needs CUDA tensors, got {dev}")
    if f.dtype not in _NORM_DTYPES:
        raise TypeError(f"the SwinIR norm takes {tuple(_NORM_DTYPES)}, got {f.dtype}")
    if f.ndim != 3:
        raise ValueError(f"the stream must be [B, P, C], got {tuple(f.shape)}")
    if not f.is_contiguous():
        raise ValueError("f must be contiguous")
    bsz, p, cw = f.shape
    dt = f.dtype
    if a is not None:
        _check(a, "a", dev, (dt,))
        if a.shape != f.shape:
            raise ValueError(f"a shape {tuple(a.shape)} != {tuple(f.shape)}")
    c = w.shape[0] if w.ndim == 1 else -1
    if not 0 < c <= cw:
        raise ValueError(f"w shape {tuple(w.shape)}: not [C] with C at most the row's {cw}")
    for t, what in ((w, "w"), (b, "b")):
        _check(t, what, dev, (dt,))
        if t.shape != (c,):
            raise ValueError(f"{what} shape {tuple(t.shape)} != {(c,)}")
    if idx is not None:
        _check(idx, "idx", dev, (torch.int64,))
        if idx.shape != (p,):
            raise ValueError(f"idx shape {tuple(idx.shape)} != {(p,)}")
    add = a is not None
    y = torch.empty_like(f)  # contiguous, as f is
    f_new = torch.empty_like(f) if add else None
    if f.numel() == 0:
        return f_new, y
    fp, wp, bp, yp = f.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr()
    ap, fnp = (a.data_ptr(), f_new.data_ptr()) if add else (0, 0)
    vec_bytes, lpr = norm_plan(cw, f.element_size(), (fp, wp, bp, yp, ap, fnp), c)
    rc = _call(dev, _lib("swin_norm").kmsr_swin_norm, int(add), _NORM_DTYPES[dt], fp,
               ap or None, None if idx is None else idx.data_ptr(), wp, bp, fnp or None, yp,
               bsz * p, p, c, cw, vec_bytes, lpr, eps)
    if rc != 0:
        reason = ("arguments refused" if rc < 0
                  else _lib("swin_norm").kmsr_swin_norm_error_string(rc).decode())
        raise RuntimeError(
            f"SwinIR norm launch failed ({rc}: {reason}) for f {tuple(f.shape)} "
            f"{f.dtype}, add={add}, vec_bytes={vec_bytes}, lpr={lpr}")
    LAUNCHES["swin_add_norm_rows" if add else "swin_norm_rows"] += 1
    return f_new, y


def swin_norm_rows(f: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   idx: torch.Tensor | None, eps: float) -> torch.Tensor:
    """Launch the SwinIR norm: y[:, p] = LN(f[:, idx[p]]) (idx None: f[:, p]),
    LN over the first C channels of the last axis with weight w and bias b
    (C = len(w)), in float32 statistics (float64 for float64 rows); y's
    channels past C are 0.

    f: [B, P, Cp] float32, bfloat16 or float64, Cp >= C (the stream's pad
    channels past C are not read into the norm); w, b: [C] in f's dtype;
    idx: None or int64 [P], a permutation of the P tokens (not checked: an
    index out of range reads out of bounds). All on one CUDA device and
    contiguous. Returns y (new, f's shape and dtype); launches on the
    current stream, does not synchronize."""
    return _swin_norm(f, None, idx, w, b, eps)[1]


def swin_add_norm_rows(f: torch.Tensor, a: torch.Tensor, idx: torch.Tensor,
                       w: torch.Tensor, b: torch.Tensor,
                       eps: float) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the SwinIR norm after the residual add: f_new[:, q] = f[:, q] +
    a[:, idx[q]] rounded to f's dtype in the first C channels and 0 past
    them, y = LN(f_new) as in `swin_norm_rows`. a: f's shape and dtype; the
    rest as there. Returns (f_new, y), both new: f is never written."""
    return _swin_norm(f, a, idx, w, b, eps)
