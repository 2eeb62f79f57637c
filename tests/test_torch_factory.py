"""Port parity: kmsr_tpu_torch.pipeline.factory vs kmsr_tpu.pipeline.factory.

Both factories run on one synthetic directory (JAX with backend="pallas",
i.e. the Pallas kernels in interpret mode on this CPU host; the port with
device="cpu", i.e. its kernels' plain versions): the same files come out,
hr bit-identical, lr within rtol 1e-4 / atol 1e-5.
"""
import glob
import os

import numpy as np
import pytest
import torch

from kmsr_tpu.io import read_band_stack as j_read
from kmsr_tpu.pipeline.apply_kernel import load_kernel as j_load_kernel
from kmsr_tpu.pipeline.factory import run_factory as j_run_factory
from kmsr_tpu_torch import convert
from kmsr_tpu_torch.io import GROUP_DENOISED, GROUP_HR, GROUP_LR, read_band_stack, write_band_stack
from kmsr_tpu_torch.ops.degrade import degrade
from kmsr_tpu_torch.ops.degrade_fused import phase_split_chwb
from kmsr_tpu_torch.pipeline import factory as tfactory
from kmsr_tpu_torch.pipeline.common import DeviceSyncGuard

TOL = dict(rtol=1e-4, atol=1e-5)


def _make_dir(tmp_path, rng, fmt, n=4, c=5, h=16, factor=8, ksize=13, n_pool=7):
    patches = tmp_path / f"in_{fmt}"
    patches.mkdir()
    arrays = {}
    for i in range(n):
        a = rng.normal(5, 2, (c, h, h)).astype(np.float32)
        if fmt == "npy":
            np.save(patches / f"p{i}.npy", a)
        else:
            write_band_stack(patches / f"p{i}.nc", GROUP_DENOISED, a, mode="w")
        arrays[f"p{i}_train.nc"] = a
    np.save(tmp_path / "k.npy", rng.uniform(0.1, 1, (c, ksize, ksize)).astype(np.float32))
    np.save(tmp_path / "pool.npy",
            rng.normal(0, 0.1, (n_pool, c, h // factor, h // factor)).astype(np.float32))
    return str(patches), str(tmp_path / "k.npy"), str(tmp_path / "pool.npy"), arrays


def _outputs(d):
    return {os.path.basename(p): p for p in glob.glob(os.path.join(d, "*_train.nc"))}


@pytest.mark.parametrize("fmt,factor,h", [
    ("nc", 8, 16), ("npy", 4, 16),
    ("nc", 2, 16),   # span 14 > 5*2 at out_w 8: auto-selects v4
    ("npy", 2, 24),  # out_w 12: v2; the .npy route goes natural here
])
def test_factory_matches_jax(tmp_path, rng, fmt, factor, h):
    """.nc route (v3) at f=8 (span 20), .npy presplit route (v3psn) at
    f=4 (span 16, two-deep tap reach), and both routes at f=2, where the
    composed span exceeds 5*factor and JAX picks v4 or v2 by shape; the
    port runs 2 batches, JAX one."""
    src, k, pool, arrays = _make_dir(tmp_path, rng, fmt, h=h, factor=factor)
    jr = j_run_factory(src, k, pool, str(tmp_path / "jax"), factor=factor,
                       seed=5, backend="pallas", progress=False)
    tr = tfactory.run_factory(src, k, pool, str(tmp_path / "port"), factor=factor,
                              seed=5, batch_size=3, progress=False, device="cpu")
    assert jr.n_fail == tr.n_fail == 0
    jo, to = _outputs(tmp_path / "jax"), _outputs(tmp_path / "port")
    assert sorted(jo) == sorted(to) == sorted(arrays)
    for name in jo:
        hr = read_band_stack(to[name], GROUP_HR)
        np.testing.assert_array_equal(hr, j_read(jo[name], GROUP_HR))
        np.testing.assert_array_equal(hr, arrays[name])
        lr = read_band_stack(to[name], GROUP_LR)
        assert lr.shape == (5, h // factor, h // factor)
        np.testing.assert_allclose(lr, j_read(jo[name], GROUP_LR), **TOL)


def test_factory_matches_two_stage_route(tmp_path, rng):
    """factory == apply_kernel + make_train_data (the port's own routes):
    hr identical; each lr = the two-stage blurred + some pool entry."""
    from kmsr_tpu_torch.pipeline.apply_kernel import main as apply_main
    from kmsr_tpu_torch.pipeline.make_train_data import main as mtd_main

    src, k, pool_path, arrays = _make_dir(tmp_path, rng, "nc", n=3, h=32)
    pool = np.load(pool_path)
    assert tfactory.main([
        "--input-dir", src, "--kernel", k, "--noise-pool", pool_path,
        "--output-dir", str(tmp_path / "fused"), "--seed", "7", "--device", "cpu",
    ]) == 0
    assert apply_main(["--input-dir", src, "--kernel", k, "--output-dir",
                       str(tmp_path / "blurred"), "--device", "cpu"]) == 0
    assert mtd_main(["--input-dir", str(tmp_path / "blurred"), "--noise-pool",
                     pool_path, "--output-dir", str(tmp_path / "two"),
                     "--seed", "7", "--hr-size", "32", "--lr-size", "4"]) == 0
    kernel = torch.from_numpy(np.load(k))
    for name, a in arrays.items():
        fused = tmp_path / "fused" / name
        two = tmp_path / "two" / name.replace("_train", "_blurred_train")
        np.testing.assert_array_equal(read_band_stack(fused, GROUP_HR), a)
        np.testing.assert_array_equal(read_band_stack(two, GROUP_HR), a)
        blurred = degrade(torch.from_numpy(a), kernel).numpy()
        for path in (fused, two):
            residual = read_band_stack(path, GROUP_LR) - blurred
            dists = np.abs(pool - residual[None]).reshape(len(pool), -1).max(axis=1)
            assert dists.min() < 1e-4


@pytest.mark.parametrize("fmt", ["nc", "npy"])
def test_conv_backend_matches_fused(tmp_path, rng, fmt):
    src, k, pool, _ = _make_dir(tmp_path, rng, fmt, n=3)
    for backend in ("fused", "conv"):
        rep = tfactory.run_factory(src, k, pool, str(tmp_path / backend),
                                   backend=backend, batch_size=2,
                                   progress=False, device="cpu")
        assert rep.n_ok == 3 and rep.n_fail == 0
    fo, co = _outputs(tmp_path / "fused"), _outputs(tmp_path / "conv")
    assert sorted(fo) == sorted(co)
    for name in fo:
        np.testing.assert_allclose(read_band_stack(fo[name], GROUP_LR),
                                   read_band_stack(co[name], GROUP_LR), **TOL)


def test_npy_route_failure_isolation(tmp_path, rng):
    """An empty dir fails loudly up front; an explicitly empty file list
    gives an empty report; a corrupt FIRST file (the route's shape probe)
    fails alone while the rest of the run proceeds."""
    c, h, f = 5, 16, 4
    np.save(tmp_path / "k.npy", rng.uniform(0.1, 1, (c, 5, 5)).astype(np.float32))
    np.save(tmp_path / "pool.npy",
            rng.normal(0, 0.1, (4, c, h // f, h // f)).astype(np.float32))
    k, pool = str(tmp_path / "k.npy"), str(tmp_path / "pool.npy")
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(FileNotFoundError):
        tfactory.run_factory(str(empty), k, pool, str(tmp_path / "o0"), factor=f,
                             progress=False, input_format="npy", device="cpu")
    rep = tfactory.run_factory(str(empty), k, pool, str(tmp_path / "o0"), factor=f,
                               progress=False, input_format="npy", files=[],
                               device="cpu")
    assert rep.n_ok == 0 and rep.n_fail == 0

    d = tmp_path / "patches"
    d.mkdir()
    (d / "a_corrupt.npy").write_bytes(b"not an npy file")
    for i in range(2):
        np.save(d / f"b_good{i}.npy", rng.normal(5, 2, (c, h, h)).astype(np.float32))
    rep = tfactory.run_factory(str(d), k, pool, str(tmp_path / "o1"), factor=f,
                               progress=False, device="cpu")
    assert rep.n_ok == 2 and rep.n_fail == 1
    assert "a_corrupt" in rep.failed[0][0]


def test_nc_route_failure_isolation(tmp_path, rng):
    src, k, pool, _ = _make_dir(tmp_path, rng, "nc", n=3)
    with open(os.path.join(src, "p1.nc"), "wb") as fh:
        fh.write(b"not an hdf5 file")
    rep = tfactory.run_factory(src, k, pool, str(tmp_path / "out"), batch_size=2,
                               progress=False, device="cpu")
    assert rep.n_ok == 2 and rep.n_fail == 1
    assert rep.failed[0][0].endswith("p1.nc")


def test_npy_split_numpy_fallback_matches_native_loader(tmp_path, rng, monkeypatch):
    """The host-loader fallback writes the same presplit and natural
    batches as the native dual split gather (and both match
    phase_split_chwb of the natural batch)."""
    src, *_ = _make_dir(tmp_path, rng, "npy", n=3, h=16)
    files = sorted(glob.glob(os.path.join(src, "*.npy")))
    import kmsr_tpu_torch.runtime as runtime

    try:
        runtime.NativePatchLoader(files, shape=(5, 16, 16)).close()
    except runtime.NativeLoaderUnavailable as e:
        pytest.skip(f"no native toolchain: {e}")
    cpu = torch.device("cpu")
    native = list(tfactory._npy_split_batches(files, 2, (5, 16, 16), 4, cpu))

    def unavailable(*a, **kw):
        raise runtime.NativeLoaderUnavailable("no toolchain")

    monkeypatch.setattr(runtime, "NativePatchLoader", unavailable)
    fallback = list(tfactory._npy_split_batches(files, 2, (5, 16, 16), 4, cpu))
    assert len(native) == len(fallback) == 2
    for (pa, xa, na, fa), (pb, xb, nb, fb) in zip(native, fallback):
        assert pa == pb and fa == fb == []
        assert torch.equal(xa, xb) and torch.equal(na, nb)
        want = phase_split_chwb(na.permute(1, 2, 3, 0), 4)
        assert torch.equal(xa, want)


class _FailingSync:
    """A device batch whose synchronization fails (a device-side fault)."""

    def cpu(self):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")


def test_sync_failures_isolated_then_abort(tmp_path, rng, monkeypatch):
    """A batch whose device sync fails fails its files and the run goes
    on; three such batches in a row abort it (DeviceSyncGuard)."""
    src, k, pool, _ = _make_dir(tmp_path, rng, "nc", n=4)
    real = tfactory.factory_batches

    def one_bad(*a, **kw):
        for i, (paths, hr, lr, fails) in enumerate(real(*a, **kw)):
            yield paths, hr, (_FailingSync() if i == 0 else lr), fails

    monkeypatch.setattr(tfactory, "factory_batches", one_bad)
    rep = tfactory.run_factory(src, k, pool, str(tmp_path / "o1"), batch_size=2,
                               progress=False, device="cpu")
    assert rep.n_ok == 2 and rep.n_fail == 2
    assert "illegal memory access" in rep.failed[0][1]

    def all_bad(*a, **kw):
        for paths, hr, _, fails in real(*a, **kw):
            yield paths, hr, _FailingSync(), fails

    monkeypatch.setattr(tfactory, "factory_batches", all_bad)
    with pytest.raises(RuntimeError, match="3 consecutive"):
        tfactory.run_factory(src, k, pool, str(tmp_path / "o2"), batch_size=1,
                             progress=False, device="cpu")


def test_device_sync_guard_resets_on_success():
    g = DeviceSyncGuard()
    for _ in range(5):
        g.failed(ValueError("x"))
        g.failed(ValueError("x"))
        g.succeeded()
    g.failed(ValueError("x"))
    g.failed(ValueError("x"))
    with pytest.raises(RuntimeError, match="consecutive"):
        g.failed(ValueError("x"))


@pytest.mark.parametrize("shape", [(13, 13), (5, 13, 13), (3, 5, 13, 13)])
def test_kernel_from_jax_rank_rules(tmp_path, rng, shape):
    k = rng.uniform(0.1, 1, shape).astype(np.float32)
    np.save(tmp_path / "k.npy", k)
    want = j_load_kernel(str(tmp_path / "k.npy"))
    for src in (k, str(tmp_path / "k.npy")):
        got = convert.kernel_from_jax(src, device="cpu")
        assert got.dtype == torch.float32 and got.shape == (5, 13, 13)
        np.testing.assert_array_equal(got.numpy(), want)


def test_kernel_from_jax_rejects_degenerate_bands(tmp_path, rng):
    k = rng.uniform(0.1, 1, (5, 13, 13)).astype(np.float32)
    k[2] = 0.0
    np.save(tmp_path / "k.npy", k)
    with pytest.raises(ValueError, match="degenerate"):
        j_load_kernel(str(tmp_path / "k.npy"))
    with pytest.raises(ValueError, match="degenerate"):
        convert.kernel_from_jax(str(tmp_path / "k.npy"), device="cpu")
    k[2] = np.nan
    with pytest.raises(ValueError, match="degenerate"):
        convert.kernel_from_jax(k, device="cpu")
    with pytest.raises(ValueError, match="incompatible"):
        convert.kernel_from_jax(k[:4], device="cpu")


def test_noise_pool_from_jax(tmp_path, rng):
    pool = rng.normal(0, 0.1, (6, 5, 4, 4))
    np.save(tmp_path / "pool.npy", pool)
    got = convert.noise_pool_from_jax(str(tmp_path / "pool.npy"), device="cpu")
    assert got.dtype == torch.float32 and got.shape == (6, 5, 4, 4)
    np.testing.assert_array_equal(got.numpy(), pool.astype(np.float32))
    with pytest.raises(ValueError, match=r"\[N,C,h,w\]"):
        convert.noise_pool_from_jax(pool[0], device="cpu")


def test_list_patch_files_shards_by_rank(tmp_path, monkeypatch):
    """Under an initialized torch.distributed group each rank takes its
    strided shard of the sorted list (the JAX package's host_shard rule);
    a single process gets the whole list."""
    import torch.distributed as dist

    from kmsr_tpu_torch.data.sampler import list_patch_files

    for i in range(5):
        (tmp_path / f"p{i}.npy").write_bytes(b"")
    everything = list_patch_files(str(tmp_path), "*.npy")
    assert [os.path.basename(p) for p in everything] == [f"p{i}.npy" for i in range(5)]
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda: 2)
    monkeypatch.setattr(dist, "get_rank", lambda: 1)
    assert list_patch_files(str(tmp_path), "*.npy") == everything[1::2]
    assert list_patch_files(str(tmp_path), "*.npy", host_shard=False) == everything
