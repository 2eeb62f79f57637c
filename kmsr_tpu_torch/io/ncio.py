"""NetCDF4-compatible grouped-file IO built directly on HDF5.

The port's own copy of `kmsr_tpu.io.ncio` (same on-disk contract, so a
file written by either package reads in the other). It runs on this
package's own HDF5 codec, `io.hdf5` (numpy and zlib), not on h5py, so
`.nc` files are read and written wherever the port runs. The codec's
h5py-like surface is used here (`File`, `Group.keys/items/__contains__/
__getitem__/attrs/create_group/create_dataset/visititems`, `Dataset.
shape/dtype/size/attrs/__getitem__/__array__`, `attrs.get/items/
__setitem__`) and by the port's call sites outside this module:
`pipeline.check_shapes` (`NCFile.group`, `grp[band]`),
`pipeline.inspect_nc` (`File`, `items`, `attrs`, `visititems`),
`pipeline.make_train_data` and `data.patches` (`NCFile` "w",
`write_bands`, `create_variable`, `set_attrs`), the append-a-group stages
`pipeline.denoise_cli`, `sr_infer`, `apply_kernel`, `degrade_scene` and
`sr_scene` (`copied` + `write_bands`; apply_kernel's in-place mode
`NCFile` "a"), `pipeline.denoise_cli` and
`scripts/torch_quality_report.py` (`get_attrs`), `pipeline.sr_infer`
(`has_group`), `io.landsat` (`NCFile` "w") and
`scripts/torch_native_lr_eval.py` (`grp[band][:]`).

NetCDF-4 files *are* HDF5 files following a small set of conventions
(dimension scales + naming attributes).  This module writes files that the
standard `netCDF4` library can open, and reads files produced by it, without
depending on the netCDF4 package (not present in this environment).

It replaces the ~6 duplicated NetCDF readers in the reference
(`utils.py:8-15`, `E_make_train_data.py:32-46`, `D_build_noise_pool.py:26-38`,
`single_kernel/train.py:39-88`, `C_30apply_kernel_to_landsat.py:36-65`,
`A_00_patch_cutter_universal.py:42-86`) with one reader/writer pair.

Conventions implemented for netCDF4 compatibility:
  * Dimensions are HDF5 datasets flagged as dimension scales with the
    canonical "This is a netCDF dimension but not a netCDF variable" NAME.
  * Variables attach their dimensions via HDF5 dimension scales.
  * `_FillValue` attributes mark invalid data (default -9999.0), converted
    to/from NaN by the band-stack helpers, matching the masked-array
    `.filled(np.nan)` semantics used throughout the reference.
"""
from __future__ import annotations

import contextlib
import os
from typing import Dict, Iterable, Iterator, Mapping, Optional, Sequence

import numpy as np

from . import hdf5
from .schema import BAND_NAMES, INVALID_VALUE

_NC_DIM_NAME = (
    "This is a netCDF dimension but not a netCDF variable. "
)


def _ensure_dim(grp: hdf5.Group, name: str, size: int) -> hdf5.Dataset:
    """Create (or fetch) a netCDF-style dimension scale in `grp`."""
    if name in grp:
        dim = grp[name]
        if dim.shape != (size,):
            raise ValueError(
                f"dimension {name!r} exists with size {dim.shape[0]}, wanted {size}"
            )
        return dim
    dim = grp.create_dataset(name, shape=(size,), dtype="f4")
    dim.make_scale(name)
    # netCDF marks pure dimensions (no coordinate variable) with this NAME.
    dim.attrs["NAME"] = np.bytes_(f"{_NC_DIM_NAME}{size:10d}")
    return dim


class NCFile:
    """Minimal grouped NetCDF4-style file handle.

    Usage:
        with NCFile(path, "w") as f:
            g = f.create_group("geophysical_data")
            f.create_variable(g, "L_TOA_443", data, dims=("y", "x"))
    """

    def __init__(self, path: str | os.PathLike, mode: str = "r"):
        self.path = str(path)
        self._h5 = hdf5.File(self.path, mode)
        if mode == "w":
            # Stamp so netCDF4 recognizes the file as netCDF-4.
            self._h5.attrs["_NCProperties"] = np.bytes_(
                "version=2,netcdf=kmsr_tpu-0.1,hdf5=1.10"
            )

    # -- context manager -------------------------------------------------
    def __enter__(self) -> "NCFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._h5:
            self._h5.close()

    # -- structure --------------------------------------------------------
    @property
    def h5(self) -> hdf5.File:
        return self._h5

    @property
    def groups(self) -> Dict[str, hdf5.Group]:
        return {
            k: v for k, v in self._h5.items() if isinstance(v, hdf5.Group)
        }

    def has_group(self, name: str) -> bool:
        return name in self._h5 and isinstance(self._h5[name], hdf5.Group)

    def create_group(self, name: str) -> hdf5.Group:
        if name in self._h5:
            return self._h5[name]
        return self._h5.create_group(name)

    def group(self, name: str) -> hdf5.Group:
        if not self.has_group(name):
            raise KeyError(f"group {name!r} not in {self.path}")
        return self._h5[name]

    # -- attributes ---------------------------------------------------------
    def set_attrs(self, attrs: Mapping[str, object], group: Optional[str] = None):
        tgt = self._h5 if group is None else self.create_group(group)
        for k, v in attrs.items():
            if isinstance(v, str):
                v = np.bytes_(v)
            tgt.attrs[k] = v

    def get_attrs(self, group: Optional[str] = None) -> Dict[str, object]:
        tgt = self._h5 if group is None else self.group(group)
        out = {}
        for k, v in tgt.attrs.items():
            if isinstance(v, bytes):
                v = v.decode("utf-8", "replace")
            elif isinstance(v, np.bytes_):
                v = bytes(v).decode("utf-8", "replace")
            out[k] = v
        return out

    # -- variables ----------------------------------------------------------
    def create_variable(
        self,
        group: hdf5.Group | str,
        name: str,
        data: np.ndarray,
        dims: Sequence[str] = ("y", "x"),
        attrs: Optional[Mapping[str, object]] = None,
        fill_value: Optional[float] = INVALID_VALUE,
        compress: bool = True,
    ) -> hdf5.Dataset:
        """Create a variable with netCDF dimension scales attached."""
        grp = self.create_group(group) if isinstance(group, str) else group
        data = np.asarray(data)
        if data.ndim != len(dims):
            raise ValueError(f"{name}: data rank {data.ndim} != dims {dims}")
        kwargs = {}
        if compress and data.size > 64:
            kwargs.update(compression="gzip", compression_opts=4, shuffle=True)
        var = grp.create_dataset(name, data=data.astype(np.float32), **kwargs)
        for axis, (dname, dsize) in enumerate(zip(dims, data.shape)):
            dim = _ensure_dim(grp, dname, dsize)
            var.attach_scale(axis, dim)
        if fill_value is not None:
            var.attrs["_FillValue"] = np.float32(fill_value)
        if attrs:
            for k, v in attrs.items():
                var.attrs[k] = np.bytes_(v) if isinstance(v, str) else v
        return var

    def variable(self, group: str, name: str) -> np.ndarray:
        grp = self.group(group)
        if name not in grp:
            raise KeyError(f"variable {name!r} not in group {group!r}")
        return np.asarray(grp[name])

    def variable_names(self, group: str) -> list[str]:
        grp = self.group(group)
        names = []
        for k, v in grp.items():
            if not isinstance(v, hdf5.Dataset):
                continue
            if v.attrs.get("CLASS") == b"DIMENSION_SCALE":
                continue
            names.append(k)
        return names


# ---------------------------------------------------------------------------
# Band-stack helpers (the framework-wide [5, H, W] contract)
# ---------------------------------------------------------------------------

def band_shape(path: str | os.PathLike, group: str,
               band: str = BAND_NAMES[0]) -> tuple[int, ...]:
    """The [H, W] shape of one band of `group`, without reading it."""
    with NCFile(path, "r") as f:
        return tuple(f.group(group)[band].shape)


def read_band_stack(
    path: str | os.PathLike,
    group: str,
    band_names: Iterable[str] = BAND_NAMES,
    fill_to_nan: bool = True,
    rows: slice | None = None,
) -> np.ndarray:
    """Read the 5 spectral bands of `group` as a `[C, H, W]` float32 stack
    (only the rows `rows` of each band when given: a rank's slab).

    `_FillValue` pixels (and exact INVALID_VALUE matches) become NaN when
    `fill_to_nan`, mirroring the masked-array `.filled(np.nan)` reads in the
    reference (`D_build_noise_pool.py:33-37`).
    """
    with NCFile(path, "r") as f:
        grp = f.group(group)
        bands = []
        for b in band_names:
            if b not in grp:
                raise KeyError(f"band {b!r} not in group {group!r} of {path}")
            arr = np.asarray(grp[b] if rows is None else grp[b][rows], dtype=np.float32)
            if fill_to_nan:
                fv = grp[b].attrs.get("_FillValue", INVALID_VALUE)
                arr = np.where(arr == np.float32(fv), np.nan, arr)
            bands.append(arr)
    return np.stack(bands, axis=0)


def write_band_stack(
    path: str | os.PathLike,
    group: str,
    stack: np.ndarray,
    band_names: Sequence[str] = BAND_NAMES,
    dims: tuple[str, str] = ("y", "x"),
    mode: str = "a",
    var_attrs: Optional[Mapping[str, object]] = None,
    group_attrs: Optional[Mapping[str, object]] = None,
    nan_to_fill: bool = False,
) -> None:
    """Write a `[C, H, W]` stack into `group`, one variable per band."""
    if mode == "a" and not os.path.exists(path):
        mode = "w"
    with NCFile(path, mode) as f:
        write_bands(f, group, stack, band_names, dims, var_attrs, group_attrs, nan_to_fill)


def write_bands(
    f: NCFile,
    group: str,
    stack: np.ndarray,
    band_names: Sequence[str] = BAND_NAMES,
    dims: tuple[str, str] = ("y", "x"),
    var_attrs: Optional[Mapping[str, object]] = None,
    group_attrs: Optional[Mapping[str, object]] = None,
    nan_to_fill: bool = False,
) -> None:
    """`write_band_stack` into an open file (several groups, one write)."""
    stack = np.asarray(stack, dtype=np.float32)
    if stack.ndim != 3 or stack.shape[0] != len(band_names):
        raise ValueError(f"expected [{len(band_names)},H,W] stack, got {stack.shape}")
    for i, b in enumerate(band_names):
        data = stack[i]
        if nan_to_fill:
            data = np.where(np.isnan(data), np.float32(INVALID_VALUE), data)
        f.create_variable(group, b, data, dims=dims, attrs=var_attrs)
    if group_attrs:
        f.set_attrs(group_attrs, group=group)


def read_nav(path: str | os.PathLike) -> Dict[str, np.ndarray]:
    """Read latitude/longitude (and any other nav rasters) if present."""
    out: Dict[str, np.ndarray] = {}
    with NCFile(path, "r") as f:
        if not f.has_group("navigation_data"):
            return out
        for name in f.variable_names("navigation_data"):
            out[name] = np.asarray(f.group("navigation_data")[name], np.float32)
    return out


def copy_file_with_groups(src: str, dst: str) -> None:
    """Copy a grouped file (used by append-a-group pipeline stages)."""
    with hdf5.File(src, "r") as s, hdf5.File(dst, "w") as d:
        hdf5.copy_tree(s, d)


@contextlib.contextmanager
def copied(src: str, dst: str) -> Iterator[NCFile]:
    """`dst` as `copy_file_with_groups(src, dst)` makes it, open to add
    groups to; written once, on exit. An append-a-group stage's
    `copy_file_with_groups` + `write_band_stack(mode="a")` in one write:
    the codec's "a" mode rewrites the whole file, where h5py appends."""
    with hdf5.File(src, "r") as s, NCFile(dst, "w") as d:
        del d.h5.attrs["_NCProperties"]  # the root's attributes are src's
        hdf5.copy_tree(s, d.h5)
        yield d
