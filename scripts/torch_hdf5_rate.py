"""Read and write rates of the port's HDF5 codec against h5py, on this CPU.

The same float32 payload (5 datasets of 1024x1024, smooth seeded fields
with noise, chunks of 64x128: h5py's guess) is written by h5py in layout v3 (a v1
B-tree, h5py's default format) and in each layout-v4 chunk index
(`libver="latest"`: fixed array, single chunk, extensible array, v2
B-tree, all gzip 4 + shuffle; implicit, which takes no filter). Each file
is then read whole through `kmsr_tpu_torch.io.hdf5` and through h5py, the
two alternating in every round, and written:

  * layout v3: a new file with gzip 4 + shuffle through the codec's
    `create_dataset` and through h5py's (the only layout the codec writes);
  * every file: rewritten as a whole, chunks still compressed, through the
    codec's `ncio.copy_file_with_groups` and through h5py's `copy` into a
    new file of the same format.

Then the filters the codec decodes in pure Python or numpy (lzf, szip,
scaleoffset, nbit) on one 1024x1024 dataset each, read through both.
Every rate is MB/s of float32 payload (uncompressed bytes), the median of
`--rounds` rounds with min and max. Prints a table and, last, one JSON line.

    python scripts/torch_hdf5_rate.py [--rounds 5] [--dir DIR]

Needs h5py (the build host).
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import shutil
import tempfile
import time

import numpy as np

N_DS, SIDE, CHUNK = 5, 1024, (64, 128)   # CHUNK: h5py's (and the codec's) guess


def cpu_name() -> str:
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or "unknown CPU"


def payload(rng) -> list:
    yy, xx = np.mgrid[0:SIDE, 0:SIDE].astype(np.float32) / SIDE
    return [(40 + 10 * np.sin(6 * yy + b) * np.cos(5 * xx - b)
             + rng.normal(0, 0.2, (SIDE, SIDE))).astype(np.float32) for b in range(N_DS)]


LAYOUTS = {  # name: (libver, h5py keywords); gzip 4 + shuffle unless noted
    "v3 (v1 B-tree)": (None, dict(chunks=CHUNK)),
    "v4 fixed array": ("latest", dict(chunks=CHUNK)),
    "v4 single chunk": ("latest", dict(chunks=(SIDE, SIDE))),
    "v4 extensible array": ("latest", dict(chunks=CHUNK, maxshape=(None, SIDE))),
    "v4 v2 B-tree": ("latest", dict(chunks=CHUNK, maxshape=(None, None))),
    "v4 implicit (no filter)": ("latest", None),
}
FILTERS = {
    "lzf": dict(compression="lzf"),
    "szip": dict(compression="szip"),
    "scaleoffset": dict(scaleoffset=2),
    "nbit": None,
}


def write_h5py(path, data, libver, kw) -> None:
    import h5py
    from h5py import h5d, h5p, h5s, h5t

    with h5py.File(path, "w", **({"libver": libver} if libver else {})) as f:
        for i, a in enumerate(data):
            if kw is None:   # early allocation, no filter: the implicit index
                dcpl = h5p.create(h5p.DATASET_CREATE)
                dcpl.set_chunk(CHUNK)
                dcpl.set_alloc_time(h5d.ALLOC_TIME_EARLY)
                h5d.create(f.id, f"b{i}".encode(), h5t.IEEE_F32LE,
                           h5s.create_simple(a.shape), dcpl=dcpl).write(h5s.ALL, h5s.ALL, a)
            else:
                f.create_dataset(f"b{i}", data=a, compression="gzip", compression_opts=4,
                                 shuffle=True, **kw)


def write_filter(path, a, kw) -> None:
    import h5py
    from h5py import h5d, h5p, h5s, h5t, h5z

    with h5py.File(path, "w") as f:
        if kw is None:   # nbit over a float32 (full precision: stored as it is)
            dcpl = h5p.create(h5p.DATASET_CREATE)
            dcpl.set_chunk(CHUNK)
            dcpl.set_filter(h5z.FILTER_NBIT)
            t = h5t.STD_I32LE.copy()
            t.set_precision(20)
            h5d.create(f.id, b"b0", t, h5s.create_simple(a.shape), dcpl=dcpl).write(
                h5s.ALL, h5s.ALL, (a * 1000).astype("i4"))
        else:
            f.create_dataset("b0", data=a, chunks=CHUNK, **kw)


def read_port(path) -> int:
    from kmsr_tpu_torch.io import hdf5
    with hdf5.File(path) as f:
        return sum(f[k][()].nbytes for k in f.keys())


def read_h5py(path) -> int:
    import h5py
    with h5py.File(path) as f:
        return sum(f[k][()].nbytes for k in f.keys())


def create_port(path, data) -> int:
    from kmsr_tpu_torch.io import hdf5
    with hdf5.File(path, "w") as f:
        for i, a in enumerate(data):
            f.create_dataset(f"b{i}", data=a, compression="gzip", compression_opts=4,
                             shuffle=True)
    return sum(a.nbytes for a in data)


def create_h5py(path, data) -> int:
    write_h5py(path, data, None, dict(chunks=CHUNK))
    return sum(a.nbytes for a in data)


def copy_port(src, dst) -> int:
    from kmsr_tpu_torch.io.ncio import copy_file_with_groups
    copy_file_with_groups(src, dst)
    return N_DS * SIDE * SIDE * 4


def copy_h5py(src, dst, libver) -> int:
    import h5py
    with h5py.File(src) as s, h5py.File(dst, "w", **({"libver": libver} if libver else {})) as d:
        for k in s.keys():
            s.copy(s[k], d, k)
    return N_DS * SIDE * SIDE * 4


def timed(fn) -> float:
    t0 = time.perf_counter()
    n = fn()
    return n / 1e6 / (time.perf_counter() - t0)


def stats(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)), "max": float(max(xs))}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--dir", default=None, help="scratch directory (default: a temp dir)")
    a = p.parse_args(argv)
    work = a.dir or tempfile.mkdtemp(prefix="kmsr_hdf5_rate_")
    os.makedirs(work, exist_ok=True)
    rng = np.random.default_rng(0)
    data = payload(rng)
    rates: dict = {}
    try:
        files = {}
        for name, (libver, kw) in LAYOUTS.items():
            files[name] = os.path.join(work, name.split()[0] + "_" + name.split()[1] + ".h5")
            write_h5py(files[name], data, libver, kw)
        ffiles = {}
        for name, kw in FILTERS.items():
            ffiles[name] = os.path.join(work, f"filter_{name}.h5")
            write_filter(ffiles[name], data[0], kw)
        runs: dict = {}

        def add(key, value):
            runs.setdefault(key, []).append(value)

        for r in range(a.rounds):
            order = ("port", "h5py") if r % 2 == 0 else ("h5py", "port")
            for name, path in files.items():
                libver = LAYOUTS[name][0]
                for who in order:
                    add((name, "read", who), timed(lambda: (read_port if who == "port"
                                                            else read_h5py)(path)))
                    out = os.path.join(work, f"copy_{who}.h5")
                    add((name, "copy", who), timed(
                        lambda: copy_port(path, out) if who == "port"
                        else copy_h5py(path, out, libver)))
            for who in order:
                out = os.path.join(work, f"create_{who}.h5")
                add(("v3 (v1 B-tree)", "write", who), timed(
                    lambda: (create_port if who == "port" else create_h5py)(out, data)))
            for name, path in ffiles.items():
                for who in order:
                    add((f"filter {name}", "read", who),
                        timed(lambda: (read_port if who == "port" else read_h5py)(path)))
        for (name, op, who), xs in runs.items():
            rates.setdefault(name, {}).setdefault(op, {})[who] = stats(xs)
    finally:
        if a.dir is None:
            shutil.rmtree(work, ignore_errors=True)
    cpu = cpu_name()
    print(f"HDF5 codec vs h5py on this CPU ({cpu}, {os.cpu_count()} logical cores), "
          f"{a.rounds} rounds, MB/s of float32 payload (median [min, max]):")
    for name, ops in rates.items():
        for op, by in ops.items():
            port, h5 = by["port"], by["h5py"]
            print(f"  {name:26s} {op:5s} port {port['median']:9.1f} [{port['min']:.1f}, "
                  f"{port['max']:.1f}]  h5py {h5['median']:9.1f} [{h5['min']:.1f}, "
                  f"{h5['max']:.1f}]  port/h5py {port['median'] / h5['median']:.3f}")
    print(json.dumps({"hdf5_rate": {"cpu": cpu, "rounds": a.rounds,
                                    "payload_mb": N_DS * SIDE * SIDE * 4 / 1e6,
                                    "chunks": list(CHUNK), "rates": rates}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
