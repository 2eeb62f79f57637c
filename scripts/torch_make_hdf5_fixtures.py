"""Write the foreign HDF5 fixtures of `tests/data/hdf5_foreign/` with h5py,
and with the C calls of the libhdf5 that h5py bundles where h5py has none.

Each file holds one structure that h5py reads and that the port's codec
(`kmsr_tpu_torch.io.hdf5`) reads too: the five layout-v4 chunk indexes
(`libver="latest"`), the filters h5py decodes without plugins, soft and
external links, committed datatypes, a dense attribute over 64 KiB, and a
whole scene in `degrade_scene`'s input layout (group `geophysical_data`,
5 bands of 256x256 float32 with NaN holes, gzip 4 + shuffle, chunks of
8x4 so each band's fixed array index is paged). Through libhdf5 itself
(`ctypes` on h5py's bundled shared library, `_libhdf5`): the shared object
header message table in list and B-tree form, a group whose links live in
a deflated fractal heap, edge chunks stored unfiltered
(`H5Pset_chunk_opts`) beside an implicit index never allocated, and the
inputs of `chip_smoke.py` phase 18: 4 denoised patches of 5x256x256 (the
factory's `.nc` route at x8) and a 5x256x256 scene, each with every
message shared through the table, the patches' root links in a deflated
heap. `manifest.json` records each file's sha256 and the sha256 of every
decoded array and attribute (`digest_file`), with the h5py and HDF5
versions that wrote them.

    python scripts/torch_make_hdf5_fixtures.py [OUTDIR]

Needs h5py (the build host); reading the manifest back (`digest_file`,
`check_dir`) does not, so `chip_smoke.py` checks the fixtures on a machine
without it. Every array is made from seeds and no object stores a time, so
a run with the same h5py and HDF5 versions rewrites the same bytes.
"""
from __future__ import annotations

import contextlib
import functools
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
SHARED_SCENE = "scene_sohm.nc"
PATCHES = tuple(f"patch_sohm_{i}.nc" for i in range(4))
PATCH_SHAPE = (256, 256)  # configs/quality_x8.json's patch, x8 -> 32x32

# libhdf5's constants (H5Opublic.h): every message type the shared object
# header message table can hold (dataspace, datatype, fill value, filter
# pipeline, attribute)
SHMESG_ALL = 0x182A


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


@functools.lru_cache(maxsize=None)
def _libhdf5():
    """The libhdf5 that h5py links (its bundled shared library, beside the
    package), for the calls h5py does not wrap: they act on h5py's own
    objects and property lists by their identifiers."""
    import ctypes
    import glob

    import h5py

    site = os.path.dirname(os.path.dirname(os.path.abspath(h5py.__file__)))
    found = sorted(glob.glob(os.path.join(site, "h5py.libs", "libhdf5-*.so*")))
    if not found:
        raise RuntimeError(f"no libhdf5 shared library beside h5py in {site}")
    return ctypes.CDLL(found[0])


def _h5(name, *args):
    """libhdf5's `name` on h5py objects (by identifier), identifiers, bytes
    and unsigned ints; raises where it returns a negative status."""
    import ctypes

    conv = [ctypes.c_int64(a.id) if hasattr(a, "id") else a if isinstance(a, bytes)
            else a if isinstance(a, ctypes.c_int64) else ctypes.c_uint(a) for a in args]
    fn = getattr(_libhdf5(), name)
    fn.restype = ctypes.c_int64 if name == "H5Pcreate" else ctypes.c_int   # hid_t, herr_t
    r = fn(*conv)
    if r < 0:
        raise RuntimeError(f"{name}{args} failed")
    return r


@contextlib.contextmanager
def _table_file(path, phase=(50, 40), filtered_root=False):
    """A new `libver="latest"` file that shares every dataspace, datatype,
    fill value, pipeline and attribute message through the shared object
    header message table: one index, no size minimum, a list up to
    phase[0] messages and a v2 B-tree from there on (back to a list below
    phase[1]; libhdf5's default 50 / 40). With filtered_root, the root
    group's links live in a deflated fractal heap."""
    import h5py
    from h5py import h5f, h5p

    fcpl = h5p.create(h5p.FILE_CREATE)
    fcpl.set_obj_track_times(False)
    _h5("H5Pset_shared_mesg_nindexes", fcpl, 1)
    _h5("H5Pset_shared_mesg_index", fcpl, 0, SHMESG_ALL, 0)
    _h5("H5Pset_shared_mesg_phase_change", fcpl, *phase)
    if filtered_root:   # the file creation list is the root group's
        _h5("H5Pset_deflate", fcpl, 6)
        _h5("H5Pset_link_phase_change", fcpl, 0, 0)
    fapl = h5p.create(h5p.FILE_ACCESS)
    fapl.set_libver_bounds(h5f.LIBVER_LATEST, h5f.LIBVER_LATEST)
    with h5py.File(h5f.create(path.encode(), h5f.ACC_TRUNC, fcpl=fcpl, fapl=fapl)) as f:
        yield f
    _untimed_extension(path)


def _untimed_extension(path):
    """Zero the times libhdf5 writes into the superblock extension's object
    header whatever the creation lists say (it is made with the default
    group creation list), and its checksum after them, so that a rerun
    writes the same bytes."""
    from kmsr_tpu_torch.io.hdf5_filters import lookup3

    with open(path, "r+b") as fh:
        raw = bytearray(fh.read())
        ext = int.from_bytes(raw[20:28], "little")   # superblock v2 / v3
        flags = raw[ext + 5]
        if raw[ext:ext + 4] != b"OHDR" or not flags & 0x20:
            return
        raw[ext + 6:ext + 22] = bytes(16)           # access, modification, change, birth
        start = ext + 22 + (4 if flags & 0x10 else 0)
        size_len = 1 << (flags & 3)
        end = start + size_len + int.from_bytes(raw[start:start + size_len], "little")
        raw[end:end + 4] = lookup3(bytes(raw[ext:end])).to_bytes(4, "little")
        fh.seek(0)
        fh.write(raw)


def _commit(group, name, dtype):
    """A committed datatype that stores no times (h5py's commit takes no
    creation list)."""
    import ctypes

    from h5py import h5p, h5t

    lib = _libhdf5()
    tcpl = ctypes.c_int64(_h5("H5Pcreate", ctypes.c_int64.in_dll(
        lib, "H5P_CLS_DATATYPE_CREATE_ID_g")))
    try:
        _h5("H5Pset_obj_track_times", tcpl, 0)
        _h5("H5Tcommit2", group.id, name.encode(), h5t.py_create(dtype).copy(),
            h5p.create(h5p.LINK_CREATE), tcpl, ctypes.c_int64(0))   # H5P_DEFAULT
    finally:
        _h5("H5Pclose", tcpl)


def _filtered_group(parent, name):
    """A group whose links live in a deflated fractal heap from its
    first link (dense storage, no compact phase)."""
    from h5py import h5g, h5p

    gcpl = h5p.create(h5p.GROUP_CREATE)
    gcpl.set_obj_track_times(False)
    _h5("H5Pset_deflate", gcpl, 6)
    _h5("H5Pset_link_phase_change", gcpl, 0, 0)
    h5g.create(parent.id, name.encode(), gcpl=gcpl)
    return parent[name]


def _bands(f, group, stack, dims=("y", "x"), **kw):
    """netCDF-4 variables of `group` (created if missing): one per band of
    the [C, H, W] `stack`, with dimension scales `dims` attached."""
    g = f[group] if group in f else _group(f, group)
    scales = []
    for name, n in zip(dims, stack.shape[1:]):
        d = _dataset(g, name, data=np.arange(n, dtype="f4"))
        d.make_scale(name)
        scales.append(d)
    for band, a in zip(BANDS, stack):
        v = _dataset(g, band, data=a, compression="gzip", compression_opts=4,
                     shuffle=True, **kw)
        for axis, d in enumerate(scales):
            v.dims[axis].attach_scale(d)
        v.attrs["units"] = np.bytes_("W m-2 sr-1 um-1")
        v.attrs["_FillValue"] = np.float32(-9999.0)
    return g


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


def write_shared_list(path, rng, phase=(100, 80)):
    """Every message shared through the table: datasets whose dataspace,
    datatype, fill value and pipeline are shared (several datasets share
    each body), compact shared attributes, an object with 12 shared
    attributes in dense storage, netCDF dimension scales (their
    `DIMENSION_LIST` / `REFERENCE_LIST` shared), a committed datatype
    beside them. The index stays a list (its 52 messages under the
    cut-off of 100)."""
    with _table_file(path, phase) as f:
        f.attrs["title"] = np.bytes_(b"shared messages")
        f.attrs["version"] = np.int32(4)
        for i in range(3):
            d = _dataset(f, f"gzip_{i}", data=smooth(rng, (20, 16), 4), chunks=(5, 8),
                         compression="gzip", shuffle=True, fillvalue=-1.5)
            d.attrs["units"] = np.bytes_(b"W m-2")
            d.attrs["scale"] = np.float32(0.5)
        _dataset(f, "plain", data=np.arange(24, dtype="i2").reshape(4, 6))
        _dataset(f, "grown", data=smooth(rng, (6, 5), 2), chunks=(2, 5), maxshape=(None, 5))
        many = _dataset(f, "many_attrs", data=np.arange(5, dtype="f8"))
        for i in range(12):   # past the compact maximum (8): dense storage
            many.attrs[f"a{i:02d}"] = np.float64(i) / 4
        _commit(f, "t_float", np.dtype("<f4"))
        _dataset(f, "typed", data=smooth(rng, (4, 4), 1), dtype=f["t_float"])
        _bands(f, "geophysical_data", np.stack([smooth(rng, (12, 10), 3) for _ in BANDS]))


def write_shared_btree(path, rng):
    """The same objects, the table's index a v2 B-tree from its first
    message (record type 8)."""
    write_shared_list(path, rng, phase=(0, 0))


def write_filtered_links(path, rng):
    """A group whose link heap is deflated: 60 links (a root indirect
    block holding three filtered direct blocks), soft links, one to a path
    of 5,000 bytes (its link message is over the heap's 4 KiB managed
    maximum: a filtered huge object of the heap's B-tree, record type 2),
    and a filtered group inside it."""
    import h5py
    with _file(path) as f:
        g = _filtered_group(f, "g")
        for i in range(60):
            _dataset(g, f"variable_{i:03d}", data=np.full(3, i, "i2"))
        g["soft"] = h5py.SoftLink("/g/variable_003")
        g["soft_long"] = h5py.SoftLink("/g/" + "x" * 5_000)
        inner = _filtered_group(g, "inner")
        _dataset(inner, "v", data=smooth(rng, (8, 8), 2))
        inner.attrs["note"] = np.bytes_(b"inside a filtered group")


def write_edge_chunks(path, rng):
    """Edge chunks left unfiltered (`H5Pset_chunk_opts(...,
    H5D_CHUNK_DONT_FILTER_PARTIAL_CHUNKS)`: layout v4's flag 0x2) in a
    10x10 gzip dataset of 4x4 chunks, and implicit indexes that were never
    allocated (early allocation of an empty extent)."""
    from h5py import h5d, h5p, h5s, h5t

    with _file(path) as f:
        a = smooth(rng, (10, 10), 5)
        dcpl = h5p.create(h5p.DATASET_CREATE)
        dcpl.set_chunk((4, 4))
        dcpl.set_deflate(6)
        dcpl.set_obj_track_times(False)
        _h5("H5Pset_chunk_opts", dcpl, 0x2)
        h5d.create(f.id, b"partial_unfiltered", h5t.IEEE_F32LE, h5s.create_simple(a.shape),
                   dcpl=dcpl).write(h5s.ALL, h5s.ALL, a)
        for name, shape in ((b"implicit_empty", (0, 4)), (b"implicit_void", (0, 0))):
            dcpl = h5p.create(h5p.DATASET_CREATE)
            dcpl.set_chunk((2, 2))
            dcpl.set_alloc_time(h5d.ALLOC_TIME_EARLY)
            dcpl.set_obj_track_times(False)
            h5d.create(f.id, name, h5t.IEEE_F32LE, h5s.create_simple(shape, shape), dcpl=dcpl)


def _radiance(rng, shape, b):
    """A smooth seeded TOA-radiance-like band (quantized to 1/4)."""
    return smooth(rng, shape, 8, step=1 / 4) + np.float32(40 + 10 * b)


def write_patch(path, rng):
    """A denoised patch as the factory's `.nc` route reads it (group
    `denoised`, 5 bands of 256x256 float32, and `navigation_data`), every
    message shared through the table, the root's links in a deflated
    heap."""
    with _table_file(path, filtered_root=True) as f:
        f.attrs["_NCProperties"] = np.bytes_("version=2,netcdf=4.9.2,hdf5=1.14.6")
        _bands(f, "denoised", np.stack([_radiance(rng, PATCH_SHAPE, b)
                                        for b in range(len(BANDS))]))
        nav = _group(f, "navigation_data")
        lat = np.linspace(30, 31, PATCH_SHAPE[0], dtype="f4")[:, None]
        lon = np.linspace(125, 126, PATCH_SHAPE[1], dtype="f4")[None, :]
        _dataset(nav, "latitude", data=np.broadcast_to(lat, PATCH_SHAPE),
                 compression="gzip", shuffle=True)
        _dataset(nav, "longitude", data=np.broadcast_to(lon, PATCH_SHAPE),
                 compression="gzip", shuffle=True)


def write_shared_scene(path, rng):
    """A scene in degrade_scene's input layout (`geophysical_data`, 5
    bands of 256x256 float32 with NaN holes), every message shared through
    the table."""
    h, w = SCENE_SHAPE
    holes = np.zeros(SCENE_SHAPE, bool)
    for _ in range(6):
        y, x = rng.integers(0, h - 24), rng.integers(0, w - 24)
        holes[y:y + rng.integers(4, 24), x:x + rng.integers(4, 24)] = True
    bands = np.stack([_radiance(rng, SCENE_SHAPE, b) for b in range(len(BANDS))])
    bands[:, holes] = np.nan
    with _table_file(path) as f:
        f.attrs["_NCProperties"] = np.bytes_("version=2,netcdf=4.9.2,hdf5=1.14.6")
        _bands(f, "geophysical_data", bands)


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
    "shared_list.h5": write_shared_list,
    "shared_btree.h5": write_shared_btree,
    "filtered_links.h5": write_filtered_links,
    "edge_chunks.h5": write_edge_chunks,
    SHARED_SCENE: write_shared_scene,
    **{name: write_patch for name in PATCHES},
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
    sys.path.insert(0, os.path.dirname(HERE))   # the port's codec, for digests
    out = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_DIR
    m = write_all(out)
    total = sum(os.path.getsize(os.path.join(out, n)) for n in m["files"])
    print(f"{len(m['files'])} files, {total} bytes, in {out}")
