"""The port's HDF5 codec on files from outside the DAG: every structure
that h5py (the JAX package's `ncio`) reads and neither package writes.

Each file is written here by h5py and read through `kmsr_tpu_torch.io.
hdf5` bit for bit, data and attributes: the five layout-v4 chunk indexes
(`libver="latest"`: single chunk, implicit, fixed array paged and not,
extensible array into its super blocks and paged, version-2 B-tree of
depth 1, each with and without gzip), the filters h5py decodes without
plugins (lzf, scaleoffset, szip, nbit), soft and external links,
committed datatypes and a 100 KiB dense attribute. After "a" mode and
`ncio.copy_file_with_groups` (which rewrite layout v4 as v3 through a v1
B-tree), h5py and the JAX package read the rewritten file equal to the
original, with maxshape, links and committed types kept. The committed
fixtures of `tests/data/hdf5_foreign/` match their manifest and the
generator (`scripts/torch_make_hdf5_fixtures.py`) rewrites them.
"""
from __future__ import annotations

import importlib.util
import json
import os
import shutil
import struct

import h5py
import numpy as np
import pytest

from kmsr_tpu.io import ncio as jnc
from kmsr_tpu_torch.io import hdf5
from kmsr_tpu_torch.io import hdf5_filters
from kmsr_tpu_torch.io import ncio as tnc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(REPO, "tests", "data", "hdf5_foreign")
_spec = importlib.util.spec_from_file_location(
    "torch_make_hdf5_fixtures", os.path.join(REPO, "scripts", "torch_make_hdf5_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _diff(want: dict, got: dict) -> list:
    return [k for k in sorted(set(want) | set(got)) if want.get(k) != got.get(k)]


def _assert_reads_as_h5py(path):
    assert not _diff(fx.h5py_digest(path), fx.port_digest(path)), path


# ---------------------------------------------------------------------------
# layout v4: the five chunk indexes
# ---------------------------------------------------------------------------

def _index_kind(path, name):
    with hdf5.File(path) as f:
        ds = f[name]
        ds._load()
        return ds._v4[0], ds._v4[3]


_INDEXES = {  # name: (index type, shape, h5py keywords)
    "single chunk": (1, (16, 24), dict(chunks=(16, 24))),
    "fixed array": (3, (48, 40), dict(chunks=(8, 8))),
    "paged fixed array": (3, (66, 66), dict(chunks=(2, 2))),
    "extensible array": (4, (300, 8), dict(chunks=(1, 8), maxshape=(None, 8))),
    "extensible array, unlimited last": (4, (8, 260), dict(chunks=(4, 1), maxshape=(8, None))),
    "version 2 B-tree": (5, (40, 40), dict(chunks=(2, 2), maxshape=(None, None))),
}


@pytest.mark.parametrize("gzip", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("index", sorted(_INDEXES))
def test_chunk_index_reads_bit_equal(tmp_path, index, gzip):
    kind, shape, kw = _INDEXES[index]
    rng = np.random.default_rng(1)
    data = fx.smooth(rng, shape, 5)
    p = str(tmp_path / "v4.h5")
    with h5py.File(p, "w", libver="latest") as f:
        d = f.create_dataset("v", data=data, compression="gzip" if gzip else None, **kw)
        d.attrs["units"] = "W m-2"
        d.attrs["scale"] = np.float32(0.5)
    assert _index_kind(p, "v")[0] == kind
    _assert_reads_as_h5py(p)
    with hdf5.File(p) as f:
        v = f["v"]
        assert v.maxshape == kw.get("maxshape", shape) and v.chunks == kw["chunks"]
        assert _same(v[()], data)
        assert _same(v[3:7, 1:5], data[3:7, 1:5])
    with open(p, "rb") as fh:
        raw = fh.read()
    if index == "paged fixed array":   # more than 2^10 entries: paged
        addr = _index_kind(p, "v")[1]
        assert raw[addr:addr + 4] == b"FAHD" and struct.unpack_from("<Q", raw, addr + 8)[0] > 1024
    if kind == 5:                      # a root of depth >= 1
        addr = _index_kind(p, "v")[1]
        assert raw[addr:addr + 4] == b"BTHD" and struct.unpack_from("<H", raw, addr + 12)[0] >= 1
    if kind == 4:                      # chunks past the index block's own data blocks
        addr = _index_kind(p, "v")[1]
        assert raw[addr:addr + 4] == b"EAHD" and struct.unpack_from("<Q", raw, addr + 12)[0] >= 1


def test_implicit_index_reads_bit_equal(tmp_path):
    p = str(tmp_path / "implicit.h5")
    fx.write_implicit(p, np.random.default_rng(2))
    assert _index_kind(p, "early")[0] == 2
    _assert_reads_as_h5py(p)


def test_paged_extensible_array_and_unwritten_pages(tmp_path):
    """131,200 one-byte chunks: super block 13 onwards holds data blocks
    of 2048 elements, paged by 1024, whose page bitmaps live in the super
    block; a second dataset writes one page of such a block only."""
    n = 131_200
    want = (np.arange(n) % 251).astype("u1")
    p = str(tmp_path / "ea.h5")
    with h5py.File(p, "w", libver="latest") as f:
        f.create_dataset("v", data=want, chunks=(1,), maxshape=(None,))
        d = f.create_dataset("sparse", shape=(n,), dtype="u1", chunks=(1,), maxshape=(None,),
                             fillvalue=9)
        d[131_100:131_110] = 3
        d[:4] = 1
        sparse = d[()]
    with hdf5.File(p) as f:
        assert _same(f["v"][()], want)
        assert _same(f["v"][131_000:131_100], want[131_000:131_100])
        assert _same(f["sparse"][()], sparse)


def test_row_slice_of_a_v4_dataset_inflates_only_its_chunks(tmp_path, monkeypatch):
    rng = np.random.default_rng(3)
    data = fx.smooth(rng, (96, 64), 5)
    p = str(tmp_path / "s.h5")
    with h5py.File(p, "w", libver="latest") as f:
        f.create_dataset("fa", data=data, chunks=(8, 16), compression="gzip")
        f.create_dataset("ea", data=data, chunks=(8, 16), compression="gzip",
                         maxshape=(None, 64))
        f.create_dataset("bt", data=data, chunks=(8, 16), compression="gzip",
                         maxshape=(None, None))
    calls = []
    real = hdf5._Pipeline.decode_chunk
    monkeypatch.setattr(hdf5._Pipeline, "decode_chunk",
                        lambda self, *a: calls.append(1) or real(self, *a))
    with hdf5.File(p) as f:
        for name in ("fa", "ea", "bt"):
            calls.clear()
            assert _same(f[name][20:35], data[20:35])
            assert len(calls) == (34 // 8 - 20 // 8 + 1) * 4, name


# ---------------------------------------------------------------------------
# filters
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def filters_file(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("filters") / "filters.h5")
    fx.write_filters(p, np.random.default_rng(4))
    return p


@pytest.mark.parametrize("name", ["lzf", "lzf_noise", "scaleoffset_int", "scaleoffset_float",
                                  "szip_float", "szip_int", "nbit_int"])
def test_filter_decodes_bit_equal(filters_file, name):
    with h5py.File(filters_file) as fh, hdf5.File(filters_file) as fp:
        want, got = fh[name][()], fp[name][()]
        assert got.dtype == want.dtype and _same(got, want)
        if name == "lzf_noise":   # noise does not shrink: chunks stored unfiltered
            masks = [fh[name].id.read_direct_chunk(fh[name].id.get_chunk_info(i).chunk_offset)[0]
                     for i in range(fh[name].id.get_num_chunks())]
            assert any(masks)


@pytest.mark.parametrize("opts,dtype,chunks", [
    (("nn", 8), "f8", (16, 16)), (("nn", 32), "f4", (16, 20)), (("ec", 16), "i4", (16, 20)),
    (("nn", 4), "u1", (8, 12)), (("nn", 8), "i2", (5, 7))])
def test_szip_variants_decode_bit_equal(tmp_path, opts, dtype, chunks):
    """libaec's paths: 64-bit samples as byte planes, 32 pixels a block, a
    scanline that is not whole blocks (padded), 8- and 16-bit samples."""
    rng = np.random.default_rng(5)
    data = (fx.smooth(rng, (40, 44), 30) * (8 if dtype[0] in "iu" else 1)).astype(dtype)
    p = str(tmp_path / "sz.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("v", data=data, chunks=chunks, compression="szip",
                         compression_opts=opts)
    with hdf5.File(p) as f:
        assert _same(f["v"][()], data)


def test_unknown_filter_in_a_chunk_raises_naming_it(tmp_path):
    """A chunk that needs a filter neither reader has (32015, zstd) raises
    H5FormatError naming the filter; h5py fails on it too. (h5py cannot
    apply the filter, so it stores the chunk unfiltered with the filter's
    mask bit set; clearing that bit in the B-tree key makes the chunk
    claim the filter.)"""
    from h5py import h5p, h5s, h5t, h5z, h5d
    p = str(tmp_path / "zstd.h5")
    data = np.arange(64, dtype="f4").reshape(8, 8)
    with h5py.File(p, "w") as f:
        dcpl = h5p.create(h5p.DATASET_CREATE)
        dcpl.set_chunk((8, 8))
        dcpl.set_filter(32015, h5z.FLAG_OPTIONAL)
        h5d.create(f.id, b"v", h5t.IEEE_F32LE, h5s.create_simple((8, 8)), dcpl=dcpl).write(
            h5s.ALL, h5s.ALL, data)
    with hdf5.File(p) as f:
        assert _same(f["v"][()], data)   # masked: read as h5py reads it
    raw = bytearray(open(p, "rb").read())
    key = struct.pack("<II3Q", 256, 1, 0, 0, 0)
    assert raw.count(key) == 1
    i = raw.index(key)
    raw[i + 4] = 0
    open(p, "wb").write(bytes(raw))
    with hdf5.File(p) as f:
        with pytest.raises(hdf5.H5FormatError, match="filter 32015"):
            f["v"][()]
    with h5py.File(p) as f:
        with pytest.raises(OSError):
            f["v"][()]


def test_lookup3_is_hdf5s_metadata_checksum(tmp_path):
    """The checksum the codec writes into OHDR / FRHP / BTHD / BTLF equals
    the one HDF5 stored in an object header it wrote."""
    p = str(tmp_path / "c.h5")
    with h5py.File(p, "w", libver="latest") as f:
        f.create_dataset("v", data=np.arange(10))
        addr = h5py.h5o.get_info(f["v"].id).addr
    raw = open(p, "rb").read()
    assert raw[addr:addr + 4] == b"OHDR"
    size_len = 1 << (raw[addr + 5] & 3)
    start = addr + 6 + (16 if raw[addr + 5] & 0x20 else 0) + (4 if raw[addr + 5] & 0x10 else 0)
    end = start + size_len + int.from_bytes(raw[start:start + size_len], "little")
    assert hdf5_filters.lookup3(raw[addr:end]) == struct.unpack_from("<I", raw, end)[0]


# ---------------------------------------------------------------------------
# links, committed datatypes, huge attributes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["write_soft_links", "write_soft_links_latest"])
def test_soft_links_list_and_resolve(tmp_path, writer):
    """A soft link (symbol-table cache type 2, or a link message of type 1)
    lists, resolves absolute or relative to its group, and a dangling one
    lists and raises KeyError naming it (the codec once took cache type 2
    for a hard link to UNDEF, and the file could not even be listed)."""
    p = str(tmp_path / "soft.h5")
    getattr(fx, writer)(p, np.random.default_rng(6))
    _assert_reads_as_h5py(p)
    with h5py.File(p) as fh, hdf5.File(p) as fp:
        assert fp.keys() == list(fh.keys())
        assert fp["data"].keys() == list(fh["data"].keys())
        assert _same(fp["abs"][()], fh["data/v"][()])
        assert fp["data/rel"] is fp["data/v"] is fp["abs"]
        assert isinstance(fp.get("dangling", getlink=True), hdf5.SoftLink)
        assert fp.get("dangling") is None and "dangling" not in fp
        assert dict(fp.items())["dangling"] is None
        with pytest.raises(KeyError, match="dangling"):
            fp["dangling"]
        assert [k for k, _ in fp.items()] == list(fh.keys())
        seen = []
        fp.visititems(lambda n, o: seen.append(n))
        assert seen == ["data", "data/v"]


def test_external_links_relative_and_absolute(tmp_path):
    p = str(tmp_path / "ext.h5")
    fx.write_external_links(p, np.random.default_rng(7))
    _assert_reads_as_h5py(p)
    target = str(tmp_path / "external_target.h5")
    with h5py.File(p, "a") as f:
        f["abs"] = h5py.ExternalLink(target, "/data/v")
    sub = tmp_path / "elsewhere"
    sub.mkdir()
    cwd = os.getcwd()
    try:   # the relative name is found beside the linking file, not in the cwd
        os.chdir(sub)
        with h5py.File(p) as fh, hdf5.File(p) as fp:
            want = fh["ext"][()]
            assert _same(fp["ext"][()], want) and _same(fp["abs"][()], want)
            assert fp["ext"].attrs["where"] == b"target"
            assert fp["ext_group"].keys() == ["v"]
            link = fp.get("ext", getlink=True)
            assert (link.filename, link.path) == ("external_target.h5", "/data/v")
            with pytest.raises(KeyError, match="nowhere.h5") as e:
                fp["missing"]
            assert "ext.h5" in str(e.value)
    finally:
        os.chdir(cwd)


def test_committed_datatypes(tmp_path):
    p = str(tmp_path / "ct.nc")
    fx.write_committed_types(p, np.random.default_rng(8))
    with h5py.File(p, "a") as f:   # a netCDF-style group beside them
        f.create_group("g").create_dataset("L_TOA_443", data=np.ones((2, 2), "f4"))
    _assert_reads_as_h5py(p)
    with h5py.File(p) as fh, hdf5.File(p) as fp:
        assert fp.keys() == list(fh.keys())
        t = fp["t_float"]
        assert isinstance(t, hdf5.Datatype) and t.dtype == np.dtype("f4")
        assert t.name == "/t_float" and t.attrs["about"] == b"committed"
        v = fp["v"]
        v._load()
        assert v._type is t._load_type()
        assert _same(fp["v"].attrs["code"], fh["v"].attrs["code"])
    with tnc.NCFile(p) as f, jnc.NCFile(p) as j:
        assert list(f.groups) == list(j.groups) == ["g"]


def test_dense_attribute_over_64_kib(tmp_path):
    p = str(tmp_path / "big.h5")
    big = np.random.default_rng(9).normal(size=12_800)   # 100 KiB of float64
    with h5py.File(p, "w", libver="latest") as f:
        d = f.create_dataset("v", data=np.arange(3))
        d.attrs["big"] = big
        d.attrs["units"] = "m"
    _assert_reads_as_h5py(p)
    with hdf5.File(p) as f:
        assert _same(f["v"].attrs["big"], big) and f["v"].attrs["units"] == "m"


# ---------------------------------------------------------------------------
# "a" mode and copies
# ---------------------------------------------------------------------------

def _kinds(path):
    """What a rewrite must keep beyond the digest: maxshape and chunks of
    each dataset, and which types are committed."""
    out = {}
    with h5py.File(path) as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = (obj.maxshape, obj.chunks, obj.compression,
                             obj.id.get_type().committed())
        f.visititems(visit)
    return out


@pytest.mark.parametrize("name", sorted(fx.FIXTURES))
def test_append_and_copy_keep_foreign_structures(tmp_path, name):
    src = tmp_path / "src"
    shutil.copytree(FIXTURE_DIR, src)
    p = str(src / name)
    want, kinds = fx.h5py_digest(p), _kinds(p)
    a, c = str(src / f"a_{name}"), str(src / f"c_{name}")
    shutil.copy(p, a)
    with hdf5.File(a, "a") as f:
        f.attrs["stage"] = "appended"
    tnc.copy_file_with_groups(p, c)
    for out in (a, c):
        got = fx.h5py_digest(out)
        got["/"]["attrs"].pop("stage", None)
        assert not _diff(want, got), (out, _diff(want, got))
        assert _kinds(out) == kinds
        with hdf5.File(out) as f:
            assert f._src.superblock_version == 0   # the codec's own layout
    if name == fx.SCENE:
        for out in (a, c):
            assert _same(jnc.read_band_stack(out, "geophysical_data"),
                         jnc.read_band_stack(p, "geophysical_data"))


# ---------------------------------------------------------------------------
# the committed fixtures
# ---------------------------------------------------------------------------

def test_fixtures_match_their_manifest():
    assert fx.check_dir(FIXTURE_DIR) == {n: [] for n in
                                         json.load(open(os.path.join(FIXTURE_DIR, "manifest.json")))["files"]}
    total = sum(os.path.getsize(os.path.join(FIXTURE_DIR, n)) for n in os.listdir(FIXTURE_DIR))
    # ~0.93 MB of h5py-written fixtures, ~0.88 MB written through libhdf5
    # (4 patches and a scene of 5x256x256 among them)
    assert total < 2_000_000


def test_generator_rewrites_the_fixtures(tmp_path):
    """Byte for byte with the h5py and HDF5 versions that wrote them (the
    manifest says which); with others, every decoded array and attribute."""
    manifest = json.load(open(os.path.join(FIXTURE_DIR, "manifest.json")))
    again = fx.write_all(str(tmp_path))
    same_versions = (manifest["h5py"], manifest["hdf5"]) == (h5py.version.version,
                                                             h5py.version.hdf5_version)
    assert sorted(again["files"]) == sorted(manifest["files"])
    for name, entry in manifest["files"].items():
        assert again["files"][name]["objects"] == entry["objects"], name
        if same_versions:
            assert again["files"][name]["sha256"] == entry["sha256"], name


def test_inspect_nc_lists_the_v4_scene(capsys):
    from kmsr_tpu_torch.pipeline import inspect_nc
    assert inspect_nc.main([os.path.join(FIXTURE_DIR, fx.SCENE), "--by-group"]) == 0
    out = capsys.readouterr().out
    assert all(f"geophysical_data/{b}" in out for b in fx.BANDS)
