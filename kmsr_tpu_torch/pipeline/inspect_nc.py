"""Stage: NetCDF/HDF5 structure inspector (CLI).

Counterpart of `kmsr_tpu.pipeline.inspect_nc` (host-only; it reads through
the port's HDF5 codec, `io.hdf5`, where JAX's reads through h5py, and the
text it prints is the same, character for character). Capability parity
with `00_check_nc.py:6-222` (groups, dims, variables, attributes; --full,
--by-group, --list-only modes) and the 4-line `test.py` scratch inspector
(print one group's variables).

Usage:
    python -m kmsr_tpu_torch.pipeline.inspect_nc FILE [--full] [--by-group]
    python -m kmsr_tpu_torch.pipeline.inspect_nc FILE --list-only
    python -m kmsr_tpu_torch.pipeline.inspect_nc FILE --group geophysical_data
"""
from __future__ import annotations

import argparse

import numpy as np

from ..io import hdf5


def _fmt_attrs(attrs, indent: str) -> list[str]:
    lines = []
    for k, v in attrs.items():
        if isinstance(v, (bytes, np.bytes_)):
            v = bytes(v).decode("utf-8", "replace")
        lines.append(f"{indent}@{k} = {v}")
    return lines


def _is_dim_scale(ds) -> bool:
    return isinstance(ds, hdf5.Dataset) and ds.attrs.get("CLASS") == b"DIMENSION_SCALE"


def describe_variable(name: str, ds, full: bool) -> list[str]:
    lines = [f"    {name}: {ds.dtype} {ds.shape}"]
    if full:
        lines += _fmt_attrs(ds.attrs, "      ")
        if ds.size and np.issubdtype(ds.dtype, np.floating):
            arr = np.asarray(ds)
            finite = arr[np.isfinite(arr)]
            if finite.size:
                lines.append(
                    f"      range=[{finite.min():.4g}, {finite.max():.4g}] "
                    f"mean={finite.mean():.4g}"
                )
    return lines


def analyze_file(path: str, full: bool = False, group: str | None = None) -> str:
    lines = [f"=== {path} ==="]
    with hdf5.File(path, "r") as f:
        root_attrs = _fmt_attrs(f.attrs, "  ")
        if root_attrs:
            lines.append("root attributes:")
            lines += root_attrs

        def walk(grp, gname: str):
            if group and gname and gname != group:
                return
            dims = [k for k, v in grp.items() if _is_dim_scale(v)]
            variables = [
                k
                for k, v in grp.items()
                if isinstance(v, hdf5.Dataset) and not _is_dim_scale(v)
            ]
            lines.append(f"group: {gname or '/'}")
            if dims:
                lines.append(
                    "  dimensions: "
                    + ", ".join(f"{d}={grp[d].shape[0]}" for d in dims)
                )
            gattrs = _fmt_attrs(grp.attrs, "  ")
            if gattrs and gname:
                lines.extend(gattrs)
            for v in variables:
                lines.extend(describe_variable(v, grp[v], full))

        walk(f, "")
        for name, item in f.items():
            if isinstance(item, hdf5.Group):
                walk(item, name)
    return "\n".join(lines)


def list_variables(path: str, by_group: bool = False) -> str:
    lines = []
    with hdf5.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, hdf5.Dataset) and not _is_dim_scale(obj):
                lines.append(name if by_group else name.split("/")[-1])

        f.visititems(visit)
    return "\n".join(sorted(set(lines)) if not by_group else sorted(lines))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Inspect NetCDF/HDF5 structure")
    p.add_argument("file")
    p.add_argument("--full", action="store_true", help="attrs + value ranges")
    p.add_argument("--list-only", action="store_true", help="variable names only")
    p.add_argument("--by-group", action="store_true", help="group/variable paths")
    p.add_argument("--group", default=None, help="restrict to one group")
    a = p.parse_args(argv)
    if a.list_only or a.by_group:
        print(list_variables(a.file, by_group=a.by_group))
    else:
        print(analyze_file(a.file, full=a.full, group=a.group))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
