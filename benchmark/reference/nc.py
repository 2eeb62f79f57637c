"""The netCDF-4 layer of the benchmark's frozen codec: the grouped band files
of the pipeline, written and read without the program.

`write_patch` lays a file out as the program's denoise stage writes one
(`kmsr_tpu_torch.pipeline.denoise_cli._write_denoised`): the cut patch's
root attributes and its `geophysical_data` and `navigation_data` groups,
plus the `denoised` group with its sigma attributes; every band a float32
variable, gzip 4 + shuffle, `_FillValue` -9999, its two dimensions attached
as netCDF dimension scales. `read_bands` reads the five bands of a group
back as a [5, H, W] float32 stack.
"""
from __future__ import annotations

import numpy as np

from . import hdf5

BANDS = ("L_TOA_443", "L_TOA_490", "L_TOA_555", "L_TOA_660", "L_TOA_865")
FILL = -9999.0
_DIM_NAME = "This is a netCDF dimension but not a netCDF variable. "


def _dim(grp, name: str, size: int):
    if name in grp:
        return grp[name]
    dim = grp.create_dataset(name, shape=(size,), dtype="f4")
    dim.make_scale(name)
    dim.attrs["NAME"] = np.bytes_(f"{_DIM_NAME}{size:10d}")
    return dim


def _variable(grp, name: str, data: np.ndarray, dims: tuple) -> None:
    var = grp.create_dataset(name, data=np.asarray(data, np.float32),
                             compression="gzip", compression_opts=4, shuffle=True)
    for axis, (dname, size) in enumerate(zip(dims, data.shape)):
        var.attach_scale(axis, _dim(grp, dname, size))
    var.attrs["_FillValue"] = np.float32(FILL)


def _attrs(node, attrs: dict) -> None:
    for k, v in attrs.items():
        node.attrs[k] = np.bytes_(v) if isinstance(v, str) else v


def write_patch(path: str, groups: dict, nav: dict, root_attrs: dict,
                group_attrs: dict) -> None:
    """One grouped file: groups {name: [5, H, W] stack}, nav {name: [H, W]},
    attributes of the root and of each group by name."""
    with hdf5.File(path, "w") as f:
        f.attrs["_NCProperties"] = np.bytes_("version=2,netcdf=kmsr_tpu-0.1,hdf5=1.10")
        _attrs(f, root_attrs)
        for gname, stack in groups.items():
            grp = f.create_group(gname)
            for band, data in zip(BANDS, stack):
                _variable(grp, band, data, ("y", "x"))
            _attrs(grp, group_attrs.get(gname, {}))
        if nav:
            grp = f.create_group("navigation_data")
            for name, arr in nav.items():
                _variable(grp, name, arr, tuple(f"{name}_dim_{j}" for j in range(arr.ndim)))


def read_bands(path: str, group: str) -> np.ndarray:
    """The five bands of `group` as [5, H, W] float32, fill values as NaN."""
    with hdf5.File(path, "r") as f:
        out = []
        for band in BANDS:
            ds = f[group][band]
            arr = np.asarray(ds[()], np.float32)
            fill = np.float32(ds.attrs.get("_FillValue", FILL))
            out.append(np.where(arr == fill, np.nan, arr))
    return np.stack(out)


def patch_attrs(i: int, size: int) -> dict:
    """Root attributes of cut patch i (the cutter's provenance)."""
    return {"source_file": f"scene_{i // 64:03d}.nc", "grid_i": (i % 64) // 8,
            "grid_j": i % 8, "h_offset": size // 2 * ((i % 64) // 8),
            "w_offset": size // 2 * (i % 8), "patch_size": size,
            "invalid_value": FILL,
            "description": "Patch extracted from Landsat/GOCI-2 L1B data"}


def denoise_attrs(sigmas) -> dict:
    """The `denoised` group's attributes for per-band noise sigmas."""
    attrs = {"h_factor": 1.0, "denoising_method": "Non-Local Means (NLM)",
             "patch_size": 7, "patch_distance": 11}
    for band, s in zip(BANDS, sigmas):
        attrs[f"{band}_sigma"] = float(s)
        attrs[f"{band}_h"] = float(s)
    attrs["average_sigma"] = float(np.mean(sigmas))
    attrs["average_h"] = float(np.mean(sigmas))
    return attrs


def write_denoised_patch(args: tuple) -> None:
    """(path, geophysical [5, H, W], denoised [5, H, W], latitude,
    longitude, patch index, sigmas [5]) -> one patch file as the denoise
    stage leaves it; a worker process's task (this module imports no torch)."""
    path, geo, den, lat, lon, i, sigmas = args
    write_patch(path, {"geophysical_data": geo, "denoised": den},
                {"latitude": lat, "longitude": lon}, patch_attrs(i, den.shape[-1]),
                {"denoised": denoise_attrs(sigmas)})
