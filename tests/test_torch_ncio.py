"""The port's HDF5 codec (`kmsr_tpu_torch.io.hdf5`) against h5py.

Files cross between the packages both ways: what the JAX package writes
through h5py reads bit for bit in the port, and what the port writes reads
in the JAX package's `ncio` and in h5py, whose dimension-scale API finds
every scale on the right axis (also after "a" mode and a copy). h5py is
the oracle here; the port itself never imports it.
"""
from __future__ import annotations

import os
import struct

import h5py
import numpy as np
import pytest

from kmsr_tpu.io import ncio as jnc
from kmsr_tpu.pipeline import make_train_data as jmake
from kmsr_tpu_torch.io import hdf5
from kmsr_tpu_torch.io import ncio as tnc
from kmsr_tpu_torch.pipeline import make_train_data as tmake

BANDS = ("L_TOA_443", "L_TOA_490", "L_TOA_555", "L_TOA_660", "L_TOA_865")


def _stack(rng, c, h, w, nan_frac=0.0):
    a = rng.normal(5.0, 1.0, (c, h, w)).astype(np.float32)
    if nan_frac:
        a[rng.random(a.shape) < nan_frac] = np.nan
    return a


def _same(a, b) -> bool:
    """Bit-equal values (NaN payloads included) or equal objects."""
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype.kind in "fiuS" and b.dtype.kind in "fiuS":
        return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()
    return a.shape == b.shape and all(_same(x, y) for x, y in zip(a.ravel(), b.ravel()))


def _ref_name_h5(f, ref):
    """The target's name, None where the reference points at no object
    (as in every copy the JAX package makes: h5py's `copy` leaves the
    dimension scales' references dangling)."""
    try:
        return f[ref].name
    except (KeyError, ValueError):
        return None


def _ref_name_port(f, ref):
    try:
        return f._deref(ref).name
    except KeyError:
        return None


def _attr_equal(f_h5, v_h5, f_port, v_port) -> bool:
    """An attribute read by h5py and by the codec: the same values, with
    references compared by the name of their target."""
    if isinstance(v_h5, h5py.Reference):
        return _ref_name_h5(f_h5, v_h5) == _ref_name_port(f_port, v_port)
    if isinstance(v_h5, np.ndarray) and v_h5.dtype.names:
        return v_h5.dtype.names == v_port.dtype.names and all(
            _attr_equal(f_h5, x[n], f_port, y[n])
            for x, y in zip(v_h5, v_port) for n in v_h5.dtype.names)
    if isinstance(v_h5, np.ndarray) and v_h5.dtype == object:
        return v_h5.shape == v_port.shape and all(
            _attr_equal(f_h5, x, f_port, y) for x, y in zip(v_h5.ravel(), v_port.ravel()))
    if isinstance(v_h5, str):
        return v_h5 == v_port
    return type(v_h5) is type(v_port) and _same(v_h5, v_port)


def _assert_tree_equal(path):
    """Every group, dataset (data bit for bit, shape, dtype, layout) and
    attribute of `path` the same through the codec as through h5py, in the
    same order, with every dimension scale's name per axis."""
    with h5py.File(path, "r") as fh, hdf5.File(path, "r") as fp:
        def walk(gh, gp):
            assert list(gh.keys()) == gp.keys(), gh.name
            assert list(gh.attrs.keys()) == gp.attrs.keys(), gh.name
            for k in gh.attrs:
                assert _attr_equal(fh, gh.attrs[k], fp, gp.attrs[k]), (gh.name, k)
            for name, oh in gh.items():
                op = gp[name]
                assert op.name == oh.name
                if isinstance(oh, h5py.Group):
                    assert isinstance(op, hdf5.Group)
                    walk(oh, op)
                    continue
                assert isinstance(op, hdf5.Dataset)
                assert op.shape == oh.shape and op.dtype == oh.dtype, oh.name
                op._load()
                assert op._chunks == oh.chunks
                assert (op._pipeline is not None) == (oh.compression is not None)
                assert _same(op[()], oh[()]), oh.name
                assert list(oh.attrs.keys()) == op.attrs.keys(), oh.name
                for k in oh.attrs:
                    assert _attr_equal(fh, oh.attrs[k], fp, op.attrs[k]), (oh.name, k)
                if "DIMENSION_LIST" in oh.attrs:
                    names = [_ref_name_h5(fh, r[0]) for r in oh.attrs["DIMENSION_LIST"]]
                    got = [_ref_name_port(fp, r[0]) for r in op.attrs["DIMENSION_LIST"]]
                    assert got == names, oh.name
                    if None not in names:
                        assert names == [oh.dims[i][0].name for i in range(oh.ndim)]
        walk(fh, fp)


# ---------------------------------------------------------------------------
# JAX-written (h5py) -> port-read
# ---------------------------------------------------------------------------

def _jax_factory(tmp, rng):
    p = str(tmp / "s_000_000_train.nc")
    nav = {"latitude": rng.normal(size=(256, 256)).astype(np.float32),
           "longitude": rng.normal(size=(256, 256)).astype(np.float32)}
    jmake.save_training_sample(p, _stack(rng, 5, 256, 256), _stack(rng, 5, 32, 32), nav,
                               lr_attrs={"moe_expert": 3})
    return p


def _jax_cut(tmp, rng):
    from kmsr_tpu.data.patches import CutConfig, cut_to_files
    scene = _stack(rng, 5, 300, 280)
    scene[4] = np.abs(scene[4]) * 0.5 + 0.1   # NIR inside the water window
    nav = {"latitude": rng.normal(size=(300, 280)).astype(np.float32),
           "longitude": rng.normal(size=(300, 280)).astype(np.float32)}
    res = cut_to_files(scene, str(tmp / "cut"), "scene", CutConfig(apply_mask=False),
                       nav=nav, source_file="scene.nc")
    return res.files[0]


def _jax_denoised(tmp, rng):
    from kmsr_tpu.pipeline.denoise_cli import _write_denoised
    src = str(tmp / "p_000_000.nc")
    jnc.write_band_stack(src, "geophysical_data", _stack(rng, 5, 64, 64, 0.02), mode="w")
    return _write_denoised(src, str(tmp / "den"), None, _stack(rng, 5, 64, 64),
                           [0.1, 0.2, 0.3, 0.4, 0.5], 0.8, verbose=False)


def _jax_sr(tmp, rng):
    src = _jax_factory(tmp, rng)
    out = str(tmp / "pair_sr.nc")
    jnc.copy_file_with_groups(src, out)
    jnc.write_band_stack(out, "sr", _stack(rng, 5, 256, 256), dims=("y_sr", "x_sr"),
                         mode="a", group_attrs={"model_file": "sr_model.npz", "factor": 8})
    return out


def _jax_landsat(tmp, rng):
    from kmsr_tpu.io import landsat as jland
    from tests.helpers.landsat_fixtures import make_landsat_scene
    scene = tmp / "LC08_L1TP_syn"
    make_landsat_scene(scene, rng, shape=(24, 32))
    return jland.calc_landsat_toa(str(scene), [1, 2, 3, 4, 5], mode="rad",
                                  out_dir=str(tmp / "ls"))


def _jax_wide_group(tmp, rng):
    """A group spanning several SNODs (more than 8 entries) and a variable
    of 128 chunks (a two-level chunk B-tree)."""
    p = str(tmp / "wide.nc")
    with jnc.NCFile(p, "w") as f:
        f.create_variable("big", "v", rng.normal(size=(1024, 1024)).astype(np.float32))
        for i in range(20):
            f.create_variable("many", f"v{i:02d}", rng.normal(size=(16, 16)), dims=("a", "b"))
        f.set_attrs({f"a{i}": i for i in range(12)}, group="many")
    return p


JAX_FILES = {"factory": _jax_factory, "cut": _jax_cut, "denoised": _jax_denoised,
             "sr_infer": _jax_sr, "landsat": _jax_landsat, "wide": _jax_wide_group}


@pytest.mark.parametrize("kind", sorted(JAX_FILES))
def test_jax_written_file_reads_bit_equal(tmp_path, kind):
    path = JAX_FILES[kind](tmp_path, np.random.default_rng(1))
    _assert_tree_equal(path)
    with jnc.NCFile(path) as jf, tnc.NCFile(path) as tf:
        assert sorted(jf.groups) == sorted(tf.groups)
        assert jf.get_attrs() == tf.get_attrs()
        for g in jf.groups:
            assert jf.get_attrs(g) == tf.get_attrs(g)
            assert jf.variable_names(g) == tf.variable_names(g)
            for v in jf.variable_names(g):
                assert _same(jf.variable(g, v), tf.variable(g, v))


def test_wide_file_structures(tmp_path):
    """The fixture really has the structures named: several SNODs in one
    group and a chunk B-tree of two levels."""
    path = _jax_wide_group(tmp_path, np.random.default_rng(2))
    with hdf5.File(path) as f:
        src = f._src
        many = f["many"]
        stab = [m for m in many._messages() if m.type == 0x11][0]
        btree = int.from_bytes(stab.data[:8], "little")
        snods = []
        src.btree_v1(btree, 0, 8, lambda lk, child, rk: snods.append(child))
        assert len(snods) > 1 and len(many.keys()) == 22
        v = f["big/v"]
        v._load()
        assert src.read(v._btree, 8)[5] == 1  # root node one level up
        assert len(v._index()) == 128


# ---------------------------------------------------------------------------
# port-written -> JAX's ncio and h5py
# ---------------------------------------------------------------------------

def test_port_written_sample_reads_in_jax_and_h5py(tmp_path):
    rng = np.random.default_rng(3)
    hr, lr = _stack(rng, 5, 256, 256), _stack(rng, 5, 32, 32)
    nav = {"latitude": rng.normal(size=(256, 256)).astype(np.float32)}
    tp, jp = str(tmp_path / "t_train.nc"), str(tmp_path / "j_train.nc")
    tmake.save_training_sample(tp, hr, lr, nav, lr_attrs={"moe_expert": 2, "note": "x"})
    jmake.save_training_sample(jp, hr, lr, nav, lr_attrs={"moe_expert": 2, "note": "x"})
    for g, want in (("hr", hr), ("lr", lr)):
        assert _same(jnc.read_band_stack(tp, g), want)
    assert _same(jnc.read_nav(tp)["latitude"], nav["latitude"])
    with jnc.NCFile(tp) as t, jnc.NCFile(jp) as j:
        assert t.get_attrs() == j.get_attrs() and t.get_attrs("lr") == j.get_attrs("lr")
        for g in ("hr", "lr", "navigation_data"):
            assert t.variable_names(g) == j.variable_names(g)
    with h5py.File(tp) as t, h5py.File(jp) as j:
        def layout(f):
            out = {}
            f.visititems(lambda n, o: out.__setitem__(n, (
                o.shape, o.dtype, o.chunks, o.compression, o.shuffle,
                sorted(o.attrs)) if isinstance(o, h5py.Dataset) else None))
            return out
        assert layout(t) == layout(j)
        for g, dims in (("hr", ("y_hr", "x_hr")), ("lr", ("y_lr", "x_lr"))):
            for b in BANDS:
                v = t[f"{g}/{b}"]
                assert [v.dims[i][0].name for i in range(2)] == [f"/{g}/{d}" for d in dims]
                assert v.attrs["_FillValue"] == np.float32(-9999.0)
            for d in dims:
                scale = t[f"{g}/{d}"]
                assert scale.is_scale
                assert scale.attrs["NAME"] == j[f"{g}/{d}"].attrs["NAME"]
                assert sorted(t[r].name for r, _ in scale.attrs["REFERENCE_LIST"]) == \
                    sorted(f"/{g}/{b}" for b in BANDS)
    _assert_tree_equal(tp)


def _h5_dims_ok(path, group, var, dims):
    with h5py.File(path) as f:
        v = f[f"{group}/{var}"]
        return [v.dims[i][0].name for i in range(v.ndim)] == [f"/{group}/{d}" for d in dims]


def test_append_and_copy_keep_scales_attached(tmp_path):
    rng = np.random.default_rng(4)
    p = str(tmp_path / "a.nc")
    a, b = _stack(rng, 5, 96, 80), _stack(rng, 5, 96, 80)
    tnc.write_band_stack(p, "geophysical_data", a, mode="w")
    # "a": a group with new dims, and a variable on the group's existing dims
    tnc.write_band_stack(p, "denoised", b, mode="a", group_attrs={"h": 0.5})
    with tnc.NCFile(p, "a") as f:
        f.create_variable("geophysical_data", "extra", b[0], dims=("y", "x"))
    for g, var in (("geophysical_data", "L_TOA_443"), ("geophysical_data", "extra"),
                   ("denoised", "L_TOA_865")):
        assert _h5_dims_ok(p, g, var, ("y", "x"))
    with h5py.File(p) as f:
        refs = f["geophysical_data/y"].attrs["REFERENCE_LIST"]
        assert sorted(f[r].name for r, _ in refs) == sorted(
            [f"/geophysical_data/{x}" for x in BANDS] + ["/geophysical_data/extra"])
    assert _same(jnc.read_band_stack(p, "geophysical_data"), a)
    assert _same(jnc.read_band_stack(p, "denoised"), b)
    # the copy: references point into the copy, chunks copied still compressed
    q = str(tmp_path / "copy.nc")
    tnc.copy_file_with_groups(p, q)
    tnc.write_band_stack(q, "sr", a, dims=("y_sr", "x_sr"), mode="a")
    for g, var, dims in (("denoised", "L_TOA_555", ("y", "x")), ("sr", "L_TOA_443",
                                                                 ("y_sr", "x_sr"))):
        assert _h5_dims_ok(q, g, var, dims)
    with h5py.File(q) as f, h5py.File(p) as src:
        assert f["denoised/L_TOA_555"].id.get_storage_size() == \
            src["denoised/L_TOA_555"].id.get_storage_size()
        assert dict(f["denoised"].attrs) == {"h": 0.5}
    _assert_tree_equal(q)
    # the JAX package appends to the port's file through h5py
    jnc.write_band_stack(q, "blurred", a[:, :12, :10], dims=("y_lr", "x_lr"), mode="a")
    _assert_tree_equal(q)
    # a JAX copy holds references to no object: the port copies it, writing
    # them as null references, and keeps the data
    jq, tq = str(tmp_path / "jcopy.nc"), str(tmp_path / "tcopy.nc")
    jnc.copy_file_with_groups(p, jq)
    tnc.copy_file_with_groups(jq, tq)
    tnc.write_band_stack(tq, "sr", b, dims=("y_sr", "x_sr"), mode="a")
    _assert_tree_equal(tq)
    assert _same(jnc.read_band_stack(tq, "denoised"), b)
    assert _h5_dims_ok(tq, "sr", "L_TOA_865", ("y_sr", "x_sr"))


def _h5_tree(path) -> dict:
    """{path: (attrs, data bytes or None)} of every object, through h5py,
    with references as their targets' names."""
    out = {}
    with h5py.File(path) as f:
        def attrs(o):
            return {k: (sorted(_ref_name_h5(f, r) for r, _ in v) if k == "REFERENCE_LIST"
                        else [_ref_name_h5(f, r[0]) for r in v] if k == "DIMENSION_LIST"
                        else np.asarray(v).tobytes()) for k, v in o.attrs.items()}
        out["/"] = (attrs(f), None)
        f.visititems(lambda n, o: out.__setitem__(n, (attrs(o), o[()].tobytes() if isinstance(
            o, h5py.Dataset) else None)))
    return out


def test_copied_equals_copy_then_append(tmp_path):
    """`ncio.copied` (one write) makes the file that copy_file_with_groups
    followed by write_band_stack(mode="a") makes (two writes)."""
    rng = np.random.default_rng(10)
    src = str(tmp_path / "src.nc")
    tnc.write_band_stack(src, "geophysical_data", _stack(rng, 5, 64, 48), mode="w")
    lr = _stack(rng, 5, 8, 6)
    one, two = str(tmp_path / "one.nc"), str(tmp_path / "two.nc")
    with tnc.copied(src, one) as f:
        tnc.write_bands(f, "blurred", lr, dims=("y_b", "x_b"), group_attrs={"k": "v"})
    tnc.copy_file_with_groups(src, two)
    tnc.write_band_stack(two, "blurred", lr, dims=("y_b", "x_b"), mode="a",
                         group_attrs={"k": "v"})
    assert _h5_tree(one) == _h5_tree(two)
    assert _h5_dims_ok(one, "blurred", "L_TOA_555", ("y_b", "x_b"))


def test_row_slice_decompresses_only_its_chunks(tmp_path, monkeypatch):
    rng = np.random.default_rng(5)
    scene = _stack(rng, 5, 1024, 768)
    p = str(tmp_path / "scene.nc")
    jnc.write_band_stack(p, "geophysical_data", scene, mode="w")
    calls = []
    real = hdf5._Pipeline.decode_chunk
    monkeypatch.setattr(hdf5._Pipeline, "decode_chunk",
                        lambda self, *a: calls.append(1) or real(self, *a))
    with h5py.File(p) as f:
        cr, cc = f["geophysical_data/L_TOA_443"].chunks
    got = tnc.read_band_stack(p, "geophysical_data", rows=slice(100, 260))
    assert _same(got, scene[:, 100:260])
    rows_touched = (259 // cr) - (100 // cr) + 1
    assert len(calls) == 5 * rows_touched * (-(-768 // cc))
    with hdf5.File(p) as f:
        v = f["geophysical_data/L_TOA_660"]
        for key in (np.s_[5], np.s_[-3:], np.s_[::7, 3], np.s_[..., 100:101], np.s_[10:4]):
            assert _same(v[key], scene[3][key])


@pytest.mark.parametrize("shape", [(8, 8), (5, 13), (3, 4)])
def test_small_variables_are_contiguous_like_jax(tmp_path, shape):
    rng = np.random.default_rng(6)
    data = rng.normal(size=shape).astype(np.float32)
    out = {}
    for name, mod in (("t", tnc), ("j", jnc)):
        p = str(tmp_path / f"{name}.nc")
        with mod.NCFile(p, "w") as f:
            f.create_variable("g", "v", data, dims=("a", "b"))
        with h5py.File(p) as f:
            v = f["g/v"]
            out[name] = (v.chunks, v.compression, v[()].tobytes())
    assert out["t"] == out["j"]
    assert (out["t"][0] is None) == (data.size <= 64)


def test_nan_and_fill_value(tmp_path):
    rng = np.random.default_rng(7)
    a = _stack(rng, 5, 40, 40, nan_frac=0.1)
    p = str(tmp_path / "n.nc")
    tnc.write_band_stack(p, "g", a, mode="w", nan_to_fill=True)
    with h5py.File(p) as f:
        raw = f["g/L_TOA_490"][()]
        assert f["g/L_TOA_490"].attrs["_FillValue"] == np.float32(-9999.0)
    assert not np.isnan(raw).any() and (raw == -9999.0).sum() == np.isnan(a[1]).sum()
    for mod in (tnc, jnc):
        got = mod.read_band_stack(p, "g")
        assert np.array_equal(np.isnan(got), np.isnan(a))
        assert np.array_equal(got[~np.isnan(got)], a[~np.isnan(a)])
    assert _same(tnc.read_band_stack(p, "g", fill_to_nan=False),
                 jnc.read_band_stack(p, "g", fill_to_nan=False))


# ---------------------------------------------------------------------------
# the netCDF-C layout: superblock v2, v2 object headers, dense storage
# ---------------------------------------------------------------------------

def _dense_fixture(path, rng):
    """h5py at libver v108 with creation order tracked, as netCDF-C 4.x
    writes: more than 8 links in a group and 8 attributes on an object go
    to fractal heaps indexed by v2 B-trees."""
    with h5py.File(path, "w", libver=("v108", "v108"), track_order=True) as f:
        f.attrs["_NCProperties"] = np.bytes_("version=2,netcdf=4.9.2,hdf5=1.14.6")
        g = f.create_group("geophysical_data", track_order=True)
        y = g.create_dataset("y", shape=(40,), dtype="f4")
        x = g.create_dataset("x", shape=(48,), dtype="f4")
        for d in (y, x):
            d.make_scale(d.name.split("/")[-1])
        for i in range(12):
            v = g.create_dataset(f"band_{i:02d}", data=rng.normal(size=(40, 48)).astype("f4"),
                                 compression="gzip", shuffle=True, chunks=(16, 16),
                                 track_order=True)
            v.dims[0].attach_scale(y)
            v.dims[1].attach_scale(x)
            v.attrs["_FillValue"] = np.float32(-32767)
            for k in range(10):
                v.attrs[f"attr_{k}"] = np.float64(k * 0.5) if k % 2 else np.int32(k)
            v.attrs["long_name"] = np.bytes_(f"band {i}")
            v.attrs["units"] = "W m-2"          # variable-length UTF-8 string
            v.attrs["valid_range"] = np.array([0, 100], np.int16)
        g.attrs.update({f"g{k}": np.int64(k) for k in range(9)})
        f.create_dataset("plain", data=np.arange(30, dtype=np.uint8).reshape(5, 6))


def test_netcdf_c_layout_dense_fixture(tmp_path):
    p = str(tmp_path / "dense.nc")
    _dense_fixture(p, np.random.default_rng(8))
    with hdf5.File(p) as f:
        assert f._src.superblock_version == 2
        kinds = {m.type for m in f["geophysical_data"]._messages()}
        assert 0x2 in kinds and 0x6 not in kinds          # link info, no compact links
        vk = {m.type for m in f["geophysical_data/band_03"]._messages()}
        assert 0x15 in vk and 0xC not in vk               # attribute info only
        assert f["geophysical_data/band_03"].attrs["units"] == "W m-2"
    _assert_tree_equal(p)
    # the port's copy rewrites it in its own layout (superblock v0, v1
    # headers, symbol tables), still read equal by h5py
    q = str(tmp_path / "dense_copy.nc")
    tnc.copy_file_with_groups(p, q)
    with hdf5.File(q) as f:
        assert f._src.superblock_version == 0
    _assert_tree_equal(q)
    with h5py.File(p) as a, h5py.File(q) as b:
        assert b["geophysical_data/band_07"].dims[1][0].name == "/geophysical_data/x"
        assert _same(a["geophysical_data/band_07"][()], b["geophysical_data/band_07"][()])


@pytest.mark.parametrize("index,kwargs", [
    ("fixed array", dict(chunks=(8, 8))),
    ("extensible array", dict(chunks=(8, 8), maxshape=(None, 24))),
    ("version 2 B-tree", dict(chunks=(8, 8), maxshape=(None, None))),
    ("single chunk", dict(chunks=(16, 24))),
])
def test_layout_v4_chunk_indexes_raise(tmp_path, index, kwargs):
    """Once refused, each layout-v4 chunk index now reads as h5py reads it
    (the name is kept; `tests/test_torch_hdf5_foreign.py` covers each
    index further)."""
    data = np.random.default_rng(10).normal(size=(16, 24)).astype("f4")
    p = str(tmp_path / "v4.h5")
    with h5py.File(p, "w", libver="latest") as f:
        f.create_dataset("v", data=data, compression="gzip", **kwargs)
    with hdf5.File(p) as f:
        v = f["v"]
        v._load()
        assert hdf5._INDEX_NAMES[v._v4[0]] == index
        assert _same(v[()], data) and v.maxshape == kwargs.get("maxshape", data.shape)


def test_fletcher32_is_verified_and_unknown_filters_raise(tmp_path):
    rng = np.random.default_rng(9)
    data = rng.normal(size=(64, 64)).astype(np.float32)
    p = str(tmp_path / "f32.h5")
    with h5py.File(p, "w") as f:
        f.create_dataset("v", data=data, chunks=(32, 32), fletcher32=True, shuffle=True)
        f.create_dataset("s", data=data, chunks=(32, 32), scaleoffset=3)
        addr = f["v"].id.get_chunk_info(0).byte_offset
    with hdf5.File(p) as f, h5py.File(p) as fh:
        assert _same(f["v"][()], data)
        assert _same(f["s"][()], fh["s"][()])   # scaleoffset is decoded now
    with open(p, "r+b") as fh:
        fh.seek(addr + 100)
        byte = fh.read(1)
        fh.seek(addr + 100)
        fh.write(bytes([byte[0] ^ 0xFF]))
    with hdf5.File(p) as f:
        with pytest.raises(hdf5.H5FormatError, match="fletcher32"):
            f["v"][()]
    # an unknown filter (32015, zstd: h5py here has no plugin for it either)
    # raises where a chunk needs it; h5py stores the chunk unfiltered with
    # the filter's mask bit set, which is cleared here in the B-tree key
    from h5py import h5d, h5p, h5s, h5t, h5z
    q = str(tmp_path / "zstd.h5")
    with h5py.File(q, "w") as f:
        dcpl = h5p.create(h5p.DATASET_CREATE)
        dcpl.set_chunk((8, 8))
        dcpl.set_filter(32015, h5z.FLAG_OPTIONAL)
        h5d.create(f.id, b"z", h5t.IEEE_F32LE, h5s.create_simple((8, 8)), dcpl=dcpl).write(
            h5s.ALL, h5s.ALL, data[:8, :8].copy())
    raw = bytearray(open(q, "rb").read())
    i = raw.index(struct.pack("<II3Q", 256, 1, 0, 0, 0))
    raw[i + 4] = 0
    open(q, "wb").write(bytes(raw))
    with hdf5.File(q) as f:
        with pytest.raises(hdf5.H5FormatError, match="filter 32015"):
            f["z"][()]


def test_not_hdf5_raises_naming_the_structure(tmp_path):
    p = tmp_path / "x.nc"
    p.write_bytes(b"CDF\x01" + bytes(200))
    with pytest.raises(hdf5.H5FormatError, match="superblock at offset 0x0"):
        hdf5.File(str(p))


def test_guess_chunk_matches_h5py():
    from h5py._hl.filters import guess_chunk
    for shape in [(256, 256), (32, 32), (1024, 1024), (8003, 7999), (13,), (5, 7, 9)]:
        assert hdf5.guess_chunk(shape, 4) == guess_chunk(shape, None, 4)


def test_write_is_atomic(tmp_path, monkeypatch):
    """A write that fails leaves the old file in place and no temporary."""
    p = str(tmp_path / "keep.nc")
    tnc.write_band_stack(p, "g", np.ones((5, 8, 8), np.float32), mode="w")
    before = open(p, "rb").read()

    def boom(*a):
        raise OSError("disk full")

    monkeypatch.setattr(hdf5, "_encode_gheap", boom)
    with pytest.raises(OSError, match="disk full"):
        tnc.write_band_stack(p, "h", np.zeros((5, 8, 8), np.float32), mode="a")
    assert open(p, "rb").read() == before
    assert os.listdir(tmp_path) == ["keep.nc"]
    # a file the codec writes gets the mode open() gives a new file
    monkeypatch.undo()
    q = str(tmp_path / "mode.nc")
    umask = os.umask(0o022)
    try:
        tnc.write_band_stack(q, "g", np.ones((5, 8, 8), np.float32), mode="w")
    finally:
        os.umask(umask)
    assert os.stat(q).st_mode & 0o777 == 0o644
