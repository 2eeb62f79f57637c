"""Write the foreign HDF5 fixtures of `tests/data/hdf5_foreign/` with h5py.

Each file holds one structure that h5py reads and that the port's codec
(`kmsr_tpu_torch.io.hdf5`) reads too: the five layout-v4 chunk indexes
(`libver="latest"`), the filters h5py decodes without plugins, soft and
external links, committed datatypes, a dense attribute over 64 KiB, and a
whole scene in `degrade_scene`'s input layout (group `geophysical_data`,
5 bands of 256x256 float32 with NaN holes, gzip 4 + shuffle, chunks of
8x4 so each band's fixed array index is paged). `manifest.json` records
each file's sha256 and the sha256 of every decoded array and attribute
(`digest_file`), with the h5py and HDF5 versions that wrote them.

    python scripts/torch_make_hdf5_fixtures.py [OUTDIR]

Needs h5py (the build host); reading the manifest back (`digest_file`,
`check_dir`) does not, so `chip_smoke.py` checks the fixtures on a machine
without it. Every array is made from seeds, so a run with the same h5py and
HDF5 versions rewrites the same bytes.
"""
from __future__ import annotations

import hashlib
import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DEFAULT_DIR = os.path.join(os.path.dirname(HERE), "tests", "data", "hdf5_foreign")
BANDS = ("L_TOA_443", "L_TOA_490", "L_TOA_555", "L_TOA_660", "L_TOA_865")
SCENE = "scene_v4.nc"
SCENE_SHAPE = (256, 256)
SCENE_CHUNKS = (8, 4)     # 2048 chunks a band: a paged fixed array (> 2^10)


def smooth(rng, shape, scale=1.0, step=1 / 64):
    """A smooth seeded field (bilinear over a coarse random grid),
    quantized to `step` so that shuffle + deflate pack it tightly."""
    coarse = rng.normal(0.0, scale, (9, 9))
    ys = np.linspace(0, 8, shape[0])
    xs = np.linspace(0, 8, shape[1])
    y0 = np.minimum(ys.astype(int), 7)
    x0 = np.minimum(xs.astype(int), 7)
    fy, fx = (ys - y0)[:, None], (xs - x0)[None, :]
    c = coarse
    v = ((1 - fy) * (1 - fx) * c[y0][:, x0] + (1 - fy) * fx * c[y0][:, x0 + 1]
         + fy * (1 - fx) * c[y0 + 1][:, x0] + fy * fx * c[y0 + 1][:, x0 + 1])
    return (np.round(v / step) * step).astype(np.float32)


# ---------------------------------------------------------------------------
# the structures (each writer takes a path and a seeded generator)
# ---------------------------------------------------------------------------

def _file(path, latest=True):
    """A new file whose objects store no times (so a rerun writes the same
    bytes): `libver="latest"`, or h5py's default format."""
    import h5py
    from h5py import h5f, h5p

    fcpl = h5p.create(h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)
    fapl = h5p.create(h5p.FILE_ACCESS)
    if latest:
        fapl.set_libver_bounds(h5f.LIBVER_LATEST, h5f.LIBVER_LATEST)
    return h5py.File(h5f.create(path.encode(), h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl))


def _group(parent, name):
    """A group that stores no times."""
    import h5py
    from h5py import h5g, h5p

    gcpl = h5p.create(h5p.GROUP_CREATE)
    gcpl.set_obj_track_times(False)
    h5g.create(parent.id, name.encode(), gcpl=gcpl)
    return parent[name]


def _dataset(parent, name, **kw):
    return parent.create_dataset(name, track_times=False, **kw)


def write_fixed_array(path, rng):
    """Fixed-shape chunked datasets: a fixed array index, paged past 1024
    chunks, with and without gzip; one written only in part (pages never
    written read as the fill value)."""
    with _file(path) as f:
        a = smooth(rng, (48, 40), 10)
        _dataset(f, "gzip", data=a, chunks=(8, 8), compression="gzip")
        _dataset(f, "plain", data=a, chunks=(8, 8))
        big = smooth(rng, (66, 66), 10)
        _dataset(f, "paged_gzip", data=big, chunks=(2, 2), compression="gzip",
                         shuffle=True)
        _dataset(f, "paged_plain", data=big, chunks=(2, 2))
        d = _dataset(f, "paged_sparse", shape=(66, 66), dtype="f4", chunks=(2, 2),
                             fillvalue=-1.5)
        d[0:4, :] = big[0:4]
        d[50:52, 30:32] = 7.0
        f["gzip"].attrs["units"] = "W m-2"


def write_single_chunk(path, rng):
    with _file(path) as f:
        a = smooth(rng, (16, 24), 4)
        _dataset(f, "gzip", data=a, chunks=(16, 24), compression="gzip")
        _dataset(f, "plain", data=a, chunks=(16, 24))


def write_extensible_array(path, rng):
    """One unlimited dimension (netCDF's unlimited `time`): an extensible
    array whose chunks reach past its index block into super blocks, the
    unlimited axis first and last (the index swizzles it to the slowest)."""
    with _file(path) as f:
        rows = smooth(rng, (300, 8), 5)
        _dataset(f, "rows_gzip", data=rows, chunks=(1, 8), maxshape=(None, 8),
                         compression="gzip")
        _dataset(f, "rows_plain", data=rows, chunks=(1, 8), maxshape=(None, 8))
        cols = smooth(rng, (8, 260), 5)
        _dataset(f, "cols_gzip", data=cols, chunks=(4, 1), maxshape=(8, None),
                         compression="gzip")
        _dataset(f, "cols_plain", data=cols, chunks=(4, 1), maxshape=(8, None))
        d = _dataset(f, "grown", shape=(0, 6), dtype="i4", chunks=(2, 6),
                             maxshape=(None, 6), fillvalue=-7)
        d.resize((90, 6))
        d[10:20] = np.arange(60, dtype="i4").reshape(10, 6)
        d[80:84] = 5


def write_btree_v2(path, rng):
    """Two unlimited dimensions: a version-2 B-tree index of depth 1."""
    with _file(path) as f:
        a = smooth(rng, (40, 40), 5)
        _dataset(f, "gzip", data=a, chunks=(2, 2), maxshape=(None, None),
                         compression="gzip")
        _dataset(f, "plain", data=a, chunks=(2, 2), maxshape=(None, None))


def write_implicit(path, rng):
    """Early allocation and no filter: the implicit index (chunk i of the
    grid at address + i * chunk bytes)."""
    from h5py import h5d, h5p, h5s, h5t
    with _file(path) as f:
        a = smooth(rng, (30, 20), 5)
        dcpl = h5p.create(h5p.DATASET_CREATE)
        dcpl.set_chunk((8, 8))
        dcpl.set_alloc_time(h5d.ALLOC_TIME_EARLY)
        dcpl.set_obj_track_times(False)
        d = h5d.create(f.id, b"early", h5t.IEEE_F32LE, h5s.create_simple(a.shape), dcpl=dcpl)
        d.write(h5s.ALL, h5s.ALL, a)


def write_filters(path, rng):
    """lzf, scaleoffset (integer and float D-scale), szip (float, integer,
    a scanline that is not whole blocks) and nbit (a 12-bit field at bit
    offset 2 of an int16); lzf over noise leaves chunks unfiltered (mask)."""
    from h5py import h5d, h5p, h5s, h5t, h5z
    with _file(path, latest=False) as f:
        a = smooth(rng, (64, 48), 50)
        _dataset(f, "lzf", data=a, chunks=(16, 16), compression="lzf")
        _dataset(f, "lzf_noise", data=rng.normal(size=(32, 32)).astype("f4"),
                         chunks=(16, 16), compression="lzf")
        _dataset(f, "scaleoffset_int", data=(a * 64).astype("i4"), chunks=(16, 16),
                         scaleoffset=0)
        _dataset(f, "scaleoffset_float", data=a, chunks=(16, 16), scaleoffset=3)
        _dataset(f, "szip_float", data=a, chunks=(16, 16), compression="szip")
        _dataset(f, "szip_int", data=(a * 64).astype("i2"), chunks=(16, 20),
                         compression="szip", compression_opts=("ec", 8))
        t = h5t.STD_I16LE.copy()
        t.set_precision(12)
        t.set_offset(2)
        dcpl = h5p.create(h5p.DATASET_CREATE)
        dcpl.set_chunk((16, 16))
        dcpl.set_filter(h5z.FILTER_NBIT)
        dcpl.set_obj_track_times(False)
        v = rng.integers(-2000, 2000, (40, 40)).astype("i2")
        h5d.create(f.id, b"nbit_int", t, h5s.create_simple(v.shape), dcpl=dcpl).write(
            h5s.ALL, h5s.ALL, v)


def write_soft_links(path, rng):
    """Soft links in a default (superblock v0, symbol-table) file:
    absolute, relative to their group, to a group, and dangling."""
    import h5py
    with _file(path, latest=False) as f:
        _dataset(_group(f, "data"), "v", data=smooth(rng, (10, 12), 3))
        f["abs"] = h5py.SoftLink("/data/v")
        f["data/rel"] = h5py.SoftLink("v")
        f["group_alias"] = h5py.SoftLink("/data")
        f["dangling"] = h5py.SoftLink("/nowhere")
        f["data/v"].attrs["note"] = np.int32(3)


def write_soft_links_latest(path, rng):
    """The same links as link messages (libver latest)."""
    import h5py
    with _file(path) as f:
        _dataset(_group(f, "data"), "v", data=smooth(rng, (10, 12), 3))
        f["abs"] = h5py.SoftLink("/data/v")
        f["data/rel"] = h5py.SoftLink("v")
        f["dangling"] = h5py.SoftLink("/nowhere")


def write_external_links(path, rng):
    """External links to objects of `external_target.h5` (a path relative
    to this file's directory), and one to a file that does not exist."""
    import h5py
    target = os.path.join(os.path.dirname(path), "external_target.h5")
    with _file(target, latest=False) as t:
        _dataset(_group(t, "data"), "v", data=smooth(rng, (6, 7), 2))
        t["data/v"].attrs["where"] = np.bytes_(b"target")
    with _file(path, latest=False) as f:
        _dataset(f, "local", data=np.arange(5, dtype="i8"))
        f["ext"] = h5py.ExternalLink("external_target.h5", "/data/v")
        f["ext_group"] = h5py.ExternalLink("external_target.h5", "/data")
        f["missing"] = h5py.ExternalLink("nowhere.h5", "/x")


def write_committed_types(path, rng):
    """Committed datatypes: one used by a dataset, one by an attribute,
    one by nothing."""
    with _file(path, latest=False) as f:
        f["t_float"] = np.dtype("<f4")
        f["t_int"] = np.dtype("<i2")
        f["t_unused"] = np.dtype("<u8")
        d = _dataset(f, "v", data=smooth(rng, (12, 9), 3), dtype=f["t_float"])
        d.attrs.create("code", np.arange(4, dtype="i2"), dtype=f["t_int"])
        f["t_float"].attrs["about"] = np.bytes_(b"committed")


def write_huge_attribute(path, rng):
    """A 66 KiB attribute (a huge fractal-heap object of dense storage)
    beside small ones."""
    with _file(path) as f:
        d = _dataset(f, "v", data=np.arange(6, dtype="f8"))
        d.attrs["big"] = smooth(rng, (130, 130), 1)   # 67,600 bytes
        d.attrs["small"] = np.int64(7)
        f.attrs["title"] = "huge attribute"


def write_scene(path, rng):
    """A scene in degrade_scene's input layout, written by h5py with the
    latest format: `geophysical_data` with 5 float32 bands, netCDF
    dimension scales y and x, NaN holes, gzip 4 + shuffle, 8x4 chunks."""
    import h5py
    h, w = SCENE_SHAPE
    with _file(path) as f:
        f.attrs["_NCProperties"] = np.bytes_("version=2,netcdf=4.9.2,hdf5=1.14.6")
        g = _group(f, "geophysical_data")
        dims = []
        for name, n in (("y", h), ("x", w)):
            d = _dataset(g, name, shape=(n,), dtype="f4")
            d.make_scale(name)
            dims.append(d)
        holes = np.zeros(SCENE_SHAPE, bool)
        for _ in range(6):
            y, x = rng.integers(0, h - 24), rng.integers(0, w - 24)
            holes[y:y + rng.integers(4, 24), x:x + rng.integers(4, 24)] = True
        for b, band in enumerate(BANDS):
            a = smooth(rng, SCENE_SHAPE, 8, step=1 / 4) + np.float32(40 + 10 * b)
            a[holes] = np.nan
            v = _dataset(g, band, data=a, chunks=SCENE_CHUNKS, compression="gzip",
                                 compression_opts=4, shuffle=True)
            v.dims[0].attach_scale(dims[0])
            v.dims[1].attach_scale(dims[1])
            v.attrs["units"] = np.bytes_("W m-2 sr-1 um-1")


FIXTURES = {
    "fixed_array.h5": write_fixed_array,
    "single_chunk.h5": write_single_chunk,
    "extensible_array.h5": write_extensible_array,
    "btree_v2.h5": write_btree_v2,
    "implicit.h5": write_implicit,
    "filters.h5": write_filters,
    "soft_links.h5": write_soft_links,
    "soft_links_latest.h5": write_soft_links_latest,
    "external_links.h5": write_external_links,
    "committed_types.h5": write_committed_types,
    "huge_attribute.h5": write_huge_attribute,
    SCENE: write_scene,
}


# ---------------------------------------------------------------------------
# digests: one walk for h5py and for the port's codec
# ---------------------------------------------------------------------------

def _sha(b: bytes) -> str:
    return hashlib.sha256(b).hexdigest()


def _canon(v, deref) -> bytes:
    """Bytes that stand for an attribute value read by either reader:
    numbers as their little-endian bytes, strings as UTF-8, references as
    their target's name."""
    if type(v).__name__ == "Reference":
        return b"ref:" + (deref(v) or "").encode()
    if isinstance(v, str):
        return b"str:" + v.encode("utf-8")
    if isinstance(v, bytes):
        return b"bytes:" + v
    a = np.asarray(v)
    if a.dtype.names:
        return b"|".join(_canon(a[n][i], deref) for i in np.ndindex(a.shape)
                         for n in a.dtype.names)
    if a.dtype == object:
        return b"[" + b",".join(_canon(x, deref) for x in a.ravel()) + b"]"
    return str(a.dtype.newbyteorder("<")).encode() + str(a.shape).encode() + \
        a.astype(a.dtype.newbyteorder("<")).tobytes()


def _content(obj) -> str:
    if hasattr(obj, "shape"):
        return "dataset " + _sha(np.asarray(obj[()]).tobytes())
    if hasattr(obj, "keys"):
        return "group " + ",".join(sorted(obj.keys()))
    return f"datatype {obj.dtype}"


def digest_file(f, deref) -> dict:
    """{path: what is there} of an open file (h5py.File or the port's
    hdf5.File): each link (soft / external with its target, or dangling),
    each dataset's shape, dtype and data sha256, each committed type's
    dtype, every attribute's sha256; hard links walked, others not."""
    out = {}

    def attrs(obj):
        return {k: _sha(_canon(obj.attrs[k], deref)) for k in sorted(obj.attrs.keys())}

    def walk(g, prefix):
        for name in sorted(g.keys()):
            path = prefix + name
            link = g.get(name, getlink=True)
            kind = type(link).__name__
            if kind in ("SoftLink", "ExternalLink"):
                obj = g.get(name)
                # what the link resolves to, by content (h5py names an object
                # by the path it was opened through; the codec by its first)
                out[path] = {"link": kind, "path": link.path,
                             **({"file": link.filename} if kind == "ExternalLink" else {}),
                             "target": None if obj is None else _content(obj)}
                continue
            obj = g[name]
            if hasattr(obj, "shape"):
                data = np.asarray(obj[()])
                out[path] = {"shape": list(obj.shape), "dtype": str(obj.dtype),
                             "sha256": _sha(data.astype(data.dtype.newbyteorder("<")).tobytes()),
                             "attrs": attrs(obj)}
            elif hasattr(obj, "keys"):
                out[path] = {"group": True, "attrs": attrs(obj)}
                walk(obj, path + "/")
            else:
                out[path] = {"dtype": str(obj.dtype), "attrs": attrs(obj)}

    out["/"] = {"group": True, "attrs": attrs(f)}
    walk(f, "/")
    return out


def port_digest(path: str) -> dict:
    """`digest_file` through the port's codec (no h5py needed)."""
    from kmsr_tpu_torch.io import hdf5

    with hdf5.File(path, "r") as f:
        def deref(r):
            try:
                return f._deref(r).name
            except KeyError:
                return None
        return digest_file(f, deref)


def h5py_digest(path: str) -> dict:
    import h5py

    with h5py.File(path, "r") as f:
        def deref(r):
            try:
                return f[r].name
            except (KeyError, ValueError):
                return None
        return digest_file(f, deref)


def check_dir(directory: str = DEFAULT_DIR) -> dict:
    """Each fixture of `directory` against its manifest, through the port's
    codec: {file: [mismatches]} (all empty when every sha256 matches)."""
    with open(os.path.join(directory, "manifest.json")) as fh:
        manifest = json.load(fh)
    bad = {}
    for name, want in manifest["files"].items():
        p = os.path.join(directory, name)
        got = []
        with open(p, "rb") as fh:
            if _sha(fh.read()) != want["sha256"]:
                got.append("file sha256")
        if "objects" in want:
            have = port_digest(p)
            got += [k for k in sorted(set(want["objects"]) | set(have))
                    if want["objects"].get(k) != have.get(k)]
        bad[name] = got
    return bad


def write_all(directory: str = DEFAULT_DIR) -> dict:
    import h5py

    os.makedirs(directory, exist_ok=True)
    files = {}
    for i, (name, writer) in enumerate(FIXTURES.items()):
        p = os.path.join(directory, name)
        writer(p, np.random.default_rng(100 + i))
    for name in sorted(os.listdir(directory)):
        if not name.endswith((".h5", ".nc")):
            continue
        p = os.path.join(directory, name)
        with open(p, "rb") as fh:
            files[name] = {"sha256": _sha(fh.read())}
        files[name]["objects"] = h5py_digest(p)
    manifest = {"h5py": h5py.version.version, "hdf5": h5py.version.hdf5_version,
                "files": files}
    with open(os.path.join(directory, "manifest.json"), "w") as fh:
        json.dump(manifest, fh, indent=1, sort_keys=True)
        fh.write("\n")
    return manifest


if __name__ == "__main__":
    out = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR
    m = write_all(out)
    total = sum(os.path.getsize(os.path.join(out, n)) for n in m["files"])
    print(f"{len(m['files'])} files, {total} bytes, in {out}")
