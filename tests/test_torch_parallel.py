"""Port parity: kmsr_tpu_torch.parallel's multi-host helpers and per-host
batch data parallelism.

- `host_shard`, `host_batch_size` and `pad_put` against JAX's functions,
  with explicit process index and count: equal lists, equal padded
  batches (the port's blocks concatenated), equal error messages.
- Local DP over the device list [cpu, cpu] (`local_batch_dp(devices=)`):
  the factory's `.npy` presplit route, the NLM chunk, `sr_infer`'s device
  loop and `apply_kernel`, each bit-equal to the one-device run of the
  port, which the existing tests hold to JAX. The CPU's plain paths stand
  in for the kernels here; on the card each block runs on its own card.
- The mesh helpers without a process group (a one-rank mesh): the rows
  of a batch, JAX's divisibility error, the refusals.
"""
import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from kmsr_tpu.parallel import local_dp as jlocal
from kmsr_tpu.parallel import multihost as jmulti
from kmsr_tpu_torch.io.ncio import read_band_stack, write_band_stack
from kmsr_tpu_torch.models.sr import SRConfig, init_sr
from kmsr_tpu_torch.ops import nlm as tnlm
from kmsr_tpu_torch.parallel import local_dp, mesh as tmesh, multihost
from kmsr_tpu_torch.pipeline import apply_kernel as tapply
from kmsr_tpu_torch.pipeline import factory as tfactory
from kmsr_tpu_torch.pipeline import sr_infer as tinfer

CPU2 = ["cpu", "cpu"]


def _raises_same(f_jax, f_port):
    msgs = []
    for f in (f_jax, f_port):
        with pytest.raises(ValueError) as e:
            f()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ------------------------------------------------------------- multihost
@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_host_shard_matches_jax(count):
    items = [f"f{i:02d}.nc" for i in range(10)]
    for index in range(count):
        got = multihost.host_shard(items, process_index=index, process_count=count)
        assert got == jmulti.host_shard(items, process_index=index, process_count=count)
    assert sorted(sum((multihost.host_shard(items, i, count) for i in range(count)), [])) == items
    _raises_same(lambda: jmulti.host_shard(items, count, count),
                 lambda: multihost.host_shard(items, count, count))


@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_host_batch_size_matches_jax(count):
    for b in (12, 24):
        assert multihost.host_batch_size(b, count) == jmulti.host_batch_size(b, count)
    if count > 1:
        _raises_same(lambda: jmulti.host_batch_size(13, count),
                     lambda: multihost.host_batch_size(13, count))


def test_single_process_defaults():
    """No group and no launcher: rank 0 of 1, the identity shard, and no
    process group started."""
    assert multihost.rank() == 0 and multihost.world_size() == 1
    assert multihost.host_shard(list("abc")) == list("abc")
    assert multihost.host_batch_size(7) == 7
    assert not multihost.initialize_if_needed("cpu")
    mesh = tmesh.make_mesh(device="cpu")
    t = torch.arange(6.0).reshape(3, 2)
    assert torch.equal(multihost.global_batch(mesh, t), t)


@pytest.mark.parametrize("n_dev", [1, 2, 3])
@pytest.mark.parametrize("b", [4, 5, 7])
def test_pad_put_matches_jax(n_dev, b):
    host = np.random.default_rng(b).normal(size=(b, 3, 4)).astype(np.float32)
    mesh = Mesh(np.array(jax.devices()[:n_dev]), ("data",))
    j_batch, j_b = jlocal.pad_put(host, NamedSharding(mesh, P("data")), n_dev)
    blocks, t_b = local_dp.pad_put(host, [torch.device("cpu")] * n_dev, n_dev)
    assert t_b == j_b == b and len(blocks) == n_dev
    assert len({blk.shape for blk in blocks}) == 1
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), np.asarray(j_batch))
    # no sharding: the batch as it is
    j_plain, _ = jlocal.pad_put(host, None, 1)
    (plain,), _ = local_dp.pad_put(host, None, 1)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(j_plain))


def test_pad_put_on_the_last_axis_and_gather():
    host = torch.arange(2 * 3 * 5, dtype=torch.float32).reshape(2, 3, 5)
    blocks, b = local_dp.pad_put(host, [torch.device("cpu")] * 2, 2, axis=-1)
    assert b == 5 and [tuple(x.shape) for x in blocks] == [(2, 3, 3)] * 2
    assert torch.equal(local_dp.gather(blocks, b, axis=-1), host)
    assert torch.equal(local_dp.gather(local_dp.local_map(lambda x: x * 2, blocks), b,
                                       axis=-1), host * 2)


def test_local_batch_dp_devices():
    assert local_dp.local_batch_dp("cpu") == ([torch.device("cpu")], 1)
    devs, n = local_dp.local_batch_dp("cpu", devices=CPU2)
    assert n == 2 and devs == [torch.device("cpu")] * 2
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        local_dp.local_batch_dp()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        local_dp.local_batch_dp(devices=["cuda:0", "cuda:1"])


# ------------------------------------------------------------------ mesh
def test_one_rank_mesh_and_its_refusals():
    mesh = tmesh.make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.group, mesh.axis_names) == (1, 0, None, ("data",))
    assert mesh.shape == {"data": 1} and mesh.is_main
    batch = np.arange(12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_array_equal(tmesh.shard_batch(mesh, batch).numpy(), batch)
    two = tmesh.Mesh("data", 2, 1, torch.device("cpu"))
    np.testing.assert_array_equal(tmesh.shard_batch(two, batch).numpy(), batch[3:])
    with pytest.raises(ValueError, match=r"divisible by 2 .* equal to 3 \(full shape: \(3, 2\)\)"):
        tmesh.shard_batch(two, batch[:3])
    two_d = tmesh.make_mesh(axis_sizes=(1, 1), axis_names=("data", "model"), device="cpu")
    assert two_d.axis_names == ("data", "model") and two_d.shape == {"data": 1, "model": 1}
    assert (two_d.group, two_d.model_group, two_d.model_rank) == (None, None, 0) and two_d.is_main
    with pytest.raises(ValueError, match="mesh needs 4 devices, have 1"):
        tmesh.make_mesh((2, 2), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="only 1-D and 2-D meshes"):
        tmesh.make_mesh((1, 1, 1), ("data", "model", "x"), device="cpu")
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        tmesh.make_mesh(axis_sizes=(2,), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_mesh()
    assert tmesh.mesh_device("cpu", mesh) == torch.device("cpu")
    # no group: every collective of a step is the identity
    with tmesh.data_parallel(mesh):
        assert tmesh.active_mesh() is None and tmesh.global_rows(3) == 3
        x = torch.ones(3, requires_grad=True)
        assert tmesh.batch_mean(x) is x
    g = [torch.ones(2)]
    assert tmesh.all_reduce_grads(mesh, g)[0] is g[0]


# ------------------------------------------------------- local DP, [cpu, cpu]
def test_factory_npy_route_over_two_devices_is_bit_equal(tmp_path, monkeypatch):
    """130 `.npy` patches in chunks of 128: the first chunk split over two
    devices (>= LANE * 2 / 2 patches, one `degrade_v3psn` call a device),
    the 2-patch tail on the first alone; lr bit-equal to the one-device
    route, chunk by chunk."""
    rng = np.random.default_rng(0)
    files = []
    for i in range(130):
        files.append(str(tmp_path / f"p{i:03d}.npy"))
        np.save(files[-1], rng.normal(5, 1, (5, 32, 32)).astype(np.float32))
    np.save(tmp_path / "pool.npy", rng.normal(0, 0.1, (9, 5, 4, 4)).astype(np.float32))
    kernel = torch.from_numpy(rng.uniform(0, 1, (5, 13, 13)).astype(np.float32))
    pool, noise_of = tfactory.noise_inputs(files, str(tmp_path / "pool.npy"), seed=7)
    kw = dict(shape=(5, 32, 32), factor=8, batch_size=128, device="cpu")
    widths = []
    real = tfactory.degrade_fused_presplit
    monkeypatch.setattr(tfactory, "degrade_fused_presplit",
                        lambda x, *a, **k: widths.append(x.shape[-1]) or real(x, *a, **k))
    one = list(tfactory.presplit_batches(files, kernel, pool, noise_of, **kw))
    two = list(tfactory.presplit_batches(files, kernel, pool, noise_of, devices=CPU2, **kw))
    assert [len(b[0]) for b in two] == [128, 2]
    assert widths == [128, 2, 64, 64, 2]
    for (p1, h1, l1, f1), (p2, h2, l2, f2) in zip(one, two, strict=True):
        assert p1 == p2 and f1 == f2 == []
        np.testing.assert_array_equal(h1, h2)
        assert l2.shape == (len(p2), 5, 4, 4)
        np.testing.assert_array_equal(l1.numpy(), l2.numpy())


def test_nlm_chunk_over_two_devices_is_bit_equal():
    """15 (file, band) images (odd: one zero pad image) with NaN holes and a
    dead band: denoised images and sigmas bit-equal to one device."""
    rng = np.random.default_rng(1)
    stacks = rng.normal(5, 1, (3, 5, 24, 24)).astype(np.float32)
    stacks[0, :, :4, :5] = np.nan
    stacks[2, 1] = np.nan
    one = tnlm.denoise_batch_finalize(tnlm.denoise_batch_dispatch(stacks, 1.5, "cpu"))
    two = tnlm.denoise_batch_finalize(
        tnlm.denoise_batch_dispatch(stacks, 1.5, "cpu", devices=CPU2))
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)
    assert np.isnan(two[0][0, :, :4, :5]).all() and two[1][2, 1] == 0.0


def test_sr_infer_over_two_devices_is_bit_equal():
    """run_batches over [cpu, cpu]: groups of 3 and 2 (one padded block)
    and a group with no hr: predictions and PSNR/SSIM bit-equal, exactly
    b rows handed over (the padding cut off), and no two groups' views
    sharing memory (each group lands in a buffer of its own)."""
    cfg = SRConfig(width=8, n_blocks=1, factor=4)
    params = init_sr(cfg, seed=1, device="cpu")
    rng = np.random.default_rng(6)

    def pair(with_hr=True):
        return (rng.normal(3, 1, (5, 8, 8)).astype(np.float32),
                rng.normal(3, 1, (5, 32, 32)).astype(np.float32) if with_hr else None)

    chunks = [(["a", "b", "c"], [pair(), pair(), pair()], []),
              (["d", "e", "f"], [pair(), pair(), pair(False)], [])]
    seen = {}
    for key, devices in (("one", None), ("two", CPU2)):
        out = seen[key] = []
        assert tinfer.run_batches(chunks, params, cfg,
                                  lambda p, preds, m, out=out: out.append((p, preds, m)),
                                  device="cpu", devices=devices) == []
    assert [p for p, _, _ in seen["two"]] == [["a", "b", "c"], ["d", "e"], ["f"]]
    for (p1, x1, m1), (p2, x2, m2) in zip(seen["one"], seen["two"], strict=True):
        assert p1 == p2
        np.testing.assert_array_equal(x1, x2)
        assert (m1 is None) == (m2 is None)
        if m1 is not None:
            np.testing.assert_array_equal(m1, m2)
    for paths, preds, mets in seen["two"]:
        assert preds.shape == (len(paths), 5, 32, 32)
        assert mets is None or mets.shape == (len(paths), 2)
    views = [v for _, preds, mets in seen["two"] for v in (preds, mets) if v is not None]
    assert not any(np.shares_memory(a, b) for i, a in enumerate(views) for b in views[i + 1:])


def test_apply_kernel_over_two_devices_is_bit_equal(tmp_path):
    """Seven .nc patches in batches of 4 (the last padded) over [cpu, cpu]:
    every blurred group bit-equal to the one-device run."""
    rng = np.random.default_rng(2)
    (tmp_path / "in").mkdir()
    for i in range(7):
        write_band_stack(str(tmp_path / "in" / f"p{i}.nc"), "denoised",
                         rng.normal(5, 1, (5, 32, 32)).astype(np.float32), mode="w")
    np.save(tmp_path / "k.npy", rng.uniform(0, 1, (5, 13, 13)).astype(np.float32))
    for out, devices in (("one", None), ("two", CPU2)):
        rep = tapply.apply_kernel_to_folder(
            str(tmp_path / "in"), str(tmp_path / "k.npy"), str(tmp_path / out),
            batch_size=4, progress=False, device="cpu", devices=devices)
        assert rep.n_ok == 7 and rep.n_fail == 0
    for name in sorted(os.listdir(tmp_path / "one")):
        np.testing.assert_array_equal(
            read_band_stack(str(tmp_path / "two" / name), "blurred"),
            read_band_stack(str(tmp_path / "one" / name), "blurred"))
