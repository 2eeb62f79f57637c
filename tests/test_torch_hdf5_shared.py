"""The port's HDF5 codec on the last structures h5py reads that it refused:
messages shared through the shared object header message table, and
groups whose links live in a filtered fractal heap.

The files are the committed fixtures of `tests/data/hdf5_foreign/` that
`scripts/torch_make_hdf5_fixtures.py` writes through libhdf5's own C calls
(h5py wraps none of them): the table in list and in B-tree form (shared
dataspaces, datatypes, fill values, pipelines and attributes, compact and
dense, netCDF dimension scales, a committed type), a deflated link heap
(a root indirect block, a filtered huge object), edge chunks left
unfiltered and implicit indexes never allocated, 4 denoised patches and a
scene of 5x256x256. Each reads equal to h5py's read (the JAX package's
`ncio`), arrays, attributes and dimension lists; "a" mode and copies write
the shared messages back inline and the filtered group in the codec's own
layout; the port's factory over the patches (its plain versions on the
CPU) equals the JAX package's at rtol 1e-4 / atol 1e-5, and the port's
scene CLI gives the same bits on the shared scene as on its rewrite.
"""
from __future__ import annotations

import collections
import glob
import importlib.util
import os
import shutil
import struct

import h5py
import numpy as np
import pytest

from kmsr_tpu.io import ncio as jnc
from kmsr_tpu.pipeline.factory import run_factory as j_run_factory
from kmsr_tpu_torch.io import hdf5
from kmsr_tpu_torch.io import ncio as tnc
from kmsr_tpu_torch.pipeline import degrade_scene
from kmsr_tpu_torch.pipeline import factory as tfactory

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_DIR = os.path.join(REPO, "tests", "data", "hdf5_foreign")
_spec = importlib.util.spec_from_file_location(
    "torch_make_hdf5_fixtures", os.path.join(REPO, "scripts", "torch_make_hdf5_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

TOL = dict(rtol=1e-4, atol=1e-5)
SHARED = ("shared_list.h5", "shared_btree.h5", fx.SHARED_SCENE) + fx.PATCHES
NEW = SHARED + ("filtered_links.h5", "edge_chunks.h5")
_DS, _DT, _FILL, _PIPE, _ATTR = 0x1, 0x3, 0x5, 0xB, 0xC


def _path(name):
    return os.path.join(FIXTURE_DIR, name)


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


@pytest.fixture
def table_reads(monkeypatch):
    """Counts of the messages read through the shared message table, by
    message type."""
    seen = collections.Counter()
    real = hdf5._Source.table_message

    def counted(self, mtype, heap_id, where):
        seen[mtype] += 1
        return real(self, mtype, heap_id, where)
    monkeypatch.setattr(hdf5._Source, "table_message", counted)
    return seen


def _dim_names(f, deref):
    """{variable path: names of the scales its dimensions attach}."""
    out = {}

    def visit(name, obj):
        if hasattr(obj, "shape") and "DIMENSION_LIST" in obj.attrs:
            out[name] = [[deref(f, r) for r in refs] for refs in obj.attrs["DIMENSION_LIST"]]
    f.visititems(visit)
    return out


@pytest.mark.parametrize("name", NEW)
def test_reads_as_h5py(name):
    """Every array and attribute (the manifest's digests, written by h5py
    on this file) and every dimension list as h5py resolves it."""
    p = _path(name)
    assert fx.port_digest(p) == fx.h5py_digest(p)
    with h5py.File(p) as fh, hdf5.File(p) as fp:
        assert _dim_names(fp, lambda f, r: f._deref(r).name) == \
            _dim_names(fh, lambda f, r: f[r].name)


@pytest.mark.parametrize("name", ["shared_list.h5", "shared_btree.h5"])
def test_dataset_messages_from_the_table(name, table_reads):
    """Dataspaces, datatypes, fill values and pipelines of datasets come
    from the table (the codec refused each: "shared message of type ..."),
    in list and in B-tree form; a committed type beside them still
    resolves to its object header."""
    p = _path(name)
    index_type = 1 if "btree" in name else 0
    raw = open(p, "rb").read()
    assert raw[raw.index(b"SMTB") + 5] == index_type
    with h5py.File(p) as fh, hdf5.File(p) as fp:
        for key in ("gzip_0", "gzip_1", "gzip_2", "plain", "grown", "typed"):
            assert _same(fp[key][()], fh[key][()]), key
            assert fp[key].maxshape == fh[key].maxshape and fp[key].chunks == fh[key].chunks
        assert {_DS, _DT, _FILL, _PIPE} <= set(table_reads)
        fp["gzip_0"]._load()
        assert fp["gzip_0"]._fill == np.float32(-1.5).tobytes()
        assert fp["typed"]._load() is None and fp["typed"]._type is fp["t_float"]._load_type()


def test_shared_attributes_compact_and_dense(table_reads):
    """Attribute messages from the table, their own datatypes and
    dataspaces from it too (the codec refused a shared attribute
    dataspace), and 12 attributes in dense storage whose name-index
    records point into the table's heap."""
    p = _path("shared_list.h5")
    with h5py.File(p) as fh, hdf5.File(p) as fp:
        for key in ("/", "gzip_1", "many_attrs", "geophysical_data/L_TOA_443"):
            want, got = dict(fh[key].attrs), dict(fp[key].attrs)
            assert list(got) == list(want), key
            for k in want:
                if not k.endswith("_LIST"):
                    assert _same(got[k], want[k]), (key, k)
        assert len(fp["many_attrs"].attrs.keys()) == 12
        assert any(m.type == hdf5._ATTRINFO for m in fp["many_attrs"]._messages())
    assert table_reads[_ATTR] >= 12 and table_reads[_DS] and table_reads[_DT]


def test_filtered_link_heap(monkeypatch):
    """A group whose links live in a deflated fractal heap (the codec
    refused it: "filtered heap blocks"): a root indirect block of three
    direct blocks, each inflated once, a 5,000-byte soft link (a filtered
    huge object) and a filtered group inside."""
    p = _path("filtered_links.h5")
    inflated = []
    real = hdf5._Pipeline.decode_chunk
    monkeypatch.setattr(hdf5._Pipeline, "decode_chunk",
                        lambda self, buf, *a: inflated.append(len(buf)) or real(self, buf, *a))
    with h5py.File(p) as fh, hdf5.File(p) as fp:
        g = fp["g"]
        assert g.keys() == list(fh["g"].keys())
        heap = next(fp._src.fheap(hdf5._u(m.data, 2 + (8 if m.data[1] & 1 else 0), 8))
                    for m in g._messages() if m.type == hdf5._LINKINFO)
        assert heap.pipeline is not None and heap.root_rows > 0
        assert sum(1 for b in heap._walk() if b[3] is not None) == 3
        assert len(g.get("soft_long", getlink=True).path) == 5_003
        assert g.get("soft_long", getlink=True).path == fh["g"].get("soft_long", getlink=True).path
        assert _same(fp["g/soft"][()], fh["g/variable_003"][()])
        assert _same(fp["g/inner/v"][()], fh["g/inner/v"][()])
        assert fp["g/inner"].attrs["note"] == b"inside a filtered group"
        n = len(inflated)
        for k in fp["g"].keys()[:20]:
            fp["g"].get(k, getlink=True)
        assert len(inflated) == n   # each block once
    assert 3 < n < 10


def test_edge_chunks_and_unallocated_implicit_index():
    """`H5Pset_chunk_opts` leaves the edge chunks of a 10x10 gzip dataset
    in 4x4 chunks unfiltered (layout v4 flag 0x1, read as stored), and an
    implicit index of an empty extent is never allocated."""
    p = _path("edge_chunks.h5")
    with h5py.File(p) as fh, hdf5.File(p) as fp:
        d = fp["partial_unfiltered"]
        d._load()
        kind, flags, _, _ = d._v4
        assert flags & 0x1 and _same(d[()], fh["partial_unfiltered"][()])
        stored = {pos: n for pos, (_, n, _) in d._index().items()}
        assert stored[(2, 2)] == 4 * 4 * 4 and stored[(0, 0)] < 4 * 4 * 4   # edge: as stored
        for name in ("implicit_empty", "implicit_void"):
            e = fp[name]
            e._load()
            assert e._v4[0] == 2 and e._v4[3] == hdf5.UNDEF
            assert _same(e[()], fh[name][()])


@pytest.mark.parametrize("name", ["shared_list.h5", "filtered_links.h5", fx.PATCHES[0]])
def test_append_and_copy_write_shared_messages_inline(tmp_path, name):
    """"a" mode and `copy_file_with_groups` write the table's messages
    back as unshared messages of the codec's v1 headers and the filtered
    group in its own layout, every link kept: h5py reads the rewrites
    equal to the original."""
    src = tmp_path / name
    shutil.copy(_path(name), src)
    want = fx.h5py_digest(str(src))
    a, c = str(tmp_path / f"a_{name}"), str(tmp_path / f"c_{name}")
    shutil.copy(src, a)
    with hdf5.File(a, "a") as f:
        f.attrs["stage"] = "appended"
    tnc.copy_file_with_groups(str(src), c)
    for out in (a, c):
        got = fx.h5py_digest(out)
        got["/"]["attrs"].pop("stage", None)
        assert got == want, out
        raw = open(out, "rb").read()
        assert b"SMTB" not in raw and b"FRHP" not in raw
        with hdf5.File(out) as f:
            assert f._src.superblock_version == 0 and f._src.ext_addr == hdf5.UNDEF
            # only datatype messages naming a committed type stay shared
            assert not [m for node in [f] + [f[k] for k in _paths(f)]
                        for m in node._messages()
                        if m.flags & hdf5._MSG_SHARED and m.type != _DT]


def _paths(f):
    out = []
    f.visititems(lambda n, o: out.append(n))
    return out


def test_a_type_without_an_index_raises_naming_it(tmp_path):
    """A message shared through the table whose type no index holds (the
    dataspace bit cleared from the index's type flags) raises
    H5FormatError naming the shared message and its type."""
    raw = bytearray(open(_path("shared_list.h5"), "rb").read())
    e = raw.index(b"SMTB") + 4
    flags = struct.unpack_from("<H", raw, e + 2)[0]
    assert flags == fx.SHMESG_ALL
    struct.pack_into("<H", raw, e + 2, flags & ~(1 << _DS))
    p = tmp_path / "no_space_index.h5"
    p.write_bytes(bytes(raw))   # the table's checksum is not verified
    with hdf5.File(str(p)) as f:
        with pytest.raises(hdf5.H5FormatError, match="shared message.*type 0x1"):
            f["plain"][()]


@pytest.fixture(scope="module")
def patch_inputs(tmp_path_factory):
    """The 4 patches, a seeded 13x13 kernel and a seeded pool of 32x32."""
    d = tmp_path_factory.mktemp("patches")
    src = d / "in"
    src.mkdir()
    for name in fx.PATCHES:
        shutil.copy(_path(name), src / name)
    rng = np.random.default_rng(17)
    k = rng.uniform(0.1, 1, (5, 13, 13)).astype(np.float32)
    np.save(d / "k.npy", k)
    np.save(d / "pool.npy", rng.normal(0, 0.1, (6, 5, 32, 32)).astype(np.float32))
    return d, str(src), str(d / "k.npy"), str(d / "pool.npy")


def test_factory_over_shared_patches_matches_jax(patch_inputs):
    """x8 over the 4 patches (denoised 5x256x256, their messages in the
    table, their root links in a deflated heap): the same files, hr equal
    to h5py's read of `denoised`, lr within rtol 1e-4 / atol 1e-5 of the
    JAX factory's, navigation copied."""
    d, src, k, pool = patch_inputs
    jr = j_run_factory(src, k, pool, str(d / "jax"), seed=11, progress=False)
    tr = tfactory.run_factory(src, k, pool, str(d / "port"), seed=11, batch_size=3,
                              progress=False, device="cpu")
    assert jr.n_fail == tr.n_fail == 0 and len(tr.succeeded) == 4
    for name in fx.PATCHES:
        out = name[:-3] + "_train.nc"
        got, want = str(d / "port" / out), str(d / "jax" / out)
        hr = jnc.read_band_stack(got, "hr")
        np.testing.assert_array_equal(hr, jnc.read_band_stack(_path(name), "denoised"))
        np.testing.assert_array_equal(hr, jnc.read_band_stack(want, "hr"))
        lr = jnc.read_band_stack(got, "lr")
        assert lr.shape == (5, 32, 32) and np.isfinite(lr).all()
        np.testing.assert_allclose(lr, jnc.read_band_stack(want, "lr"), **TOL)
        assert tnc.read_nav(got).keys() == {"latitude", "longitude"}
        for key, v in tnc.read_nav(got).items():
            np.testing.assert_array_equal(v, jnc.read_nav(want)[key])


def test_scene_cli_on_the_shared_scene_and_its_rewrite(tmp_path):
    """The port's scene CLI (its plain path on the CPU) on the scene whose
    messages are all in the table and on its layout-v3 rewrite: the same
    `_blurred` bits, NaN cells where whole cells are holes."""
    v3 = tmp_path / "v3" / fx.SHARED_SCENE
    v3.parent.mkdir()
    tnc.copy_file_with_groups(_path(fx.SHARED_SCENE), str(v3))
    np.save(tmp_path / "k.npy", np.random.default_rng(18).uniform(0, 1, (13, 13))
            .astype(np.float32))
    out = {}
    for label, p in (("table", _path(fx.SHARED_SCENE)), ("v3", str(v3))):
        assert degrade_scene.main(["--input", p, "--kernel", str(tmp_path / "k.npy"),
                                   "--output-dir", str(tmp_path / label),
                                   "--device", "cpu"]) == 0
        [blurred] = glob.glob(str(tmp_path / label / "*_blurred.nc"))
        out[label] = tnc.read_band_stack(blurred, "blurred")
    assert out["table"].shape == (5, 32, 32)
    assert out["table"].tobytes() == out["v3"].tobytes()
    assert 0 < np.isnan(out["table"]).sum() < out["table"].size
