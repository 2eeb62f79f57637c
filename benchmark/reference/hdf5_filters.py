# Frozen copy of kmsr_tpu_torch/io/hdf5_filters.py as of commit 84a67c1,
# imported by the frozen codec beside it. Keep it as it is.
"""Decoders for the HDF5 filters that h5py reads without plugins, and
HDF5's Jenkins lookup3 checksum. numpy and the standard library only;
`io.hdf5` calls these on one chunk's bytes at a time.

  * lzf (32000): h5py's LZF filter (liblzf's format);
  * scaleoffset (6): `H5Zscaleoffset.c`'s integer minimum-bits form and
    its float D-scale form (the E-scale form HDF5 itself never decodes);
  * szip (4): the CCSDS 121.0 adaptive Rice stream as libaec decodes it
    behind HDF5's szip filter (reference samples, zero blocks, the second
    extension, split samples, uncompressed blocks, the NN preprocessor,
    libaec's byte interleaving of 32- and 64-bit samples);
  * nbit (5): `H5Znbit.c` for atomic types (each element's precision bits,
    MSB first, back at their bit offset).

The decoders are pure Python where the format is sequential (lzf, szip),
so they are far slower than zlib; `scripts/torch_hdf5_rate.py` measures them.
"""
from __future__ import annotations

import bisect
import struct

import numpy as np

__all__ = ["lzf_decode", "scaleoffset_decode", "szip_decode", "nbit_decode", "lookup3"]


# ---------------------------------------------------------------------------
# LZF
# ---------------------------------------------------------------------------

def lzf_decode(buf: bytes, out_size: int) -> bytes:
    """liblzf's `lzf_decompress`: literal runs (ctrl < 32: ctrl + 1 bytes)
    and back references (length ctrl >> 5, 7 extends by the next byte;
    distance ((ctrl & 31) << 8) + next byte + 1), copied byte by byte."""
    out = bytearray()
    ip, n = 0, len(buf)
    while ip < n:
        ctrl = buf[ip]
        ip += 1
        if ctrl < 32:
            out += buf[ip:ip + ctrl + 1]
            ip += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            length += buf[ip]
            ip += 1
        ref = len(out) - ((ctrl & 0x1F) << 8) - 1 - buf[ip]
        ip += 1
        length += 2
        if ref < 0:
            raise ValueError("lzf back reference before the start of the chunk")
        dist = len(out) - ref
        if dist >= length:
            out += out[ref:ref + length]
        else:  # overlapping: the last `dist` bytes repeat
            pat = bytes(out[ref:])
            out += (pat * (length // dist + 1))[:length]
    if len(out) > out_size:
        raise ValueError(f"lzf chunk decodes to {len(out)} bytes, more than {out_size}")
    return bytes(out)


# ---------------------------------------------------------------------------
# bit streams (scaleoffset, nbit): each value's bits MSB first, packed
# ---------------------------------------------------------------------------

def _unpack_fields(buf: bytes, n: int, bits: int) -> np.ndarray:
    """n unsigned `bits`-wide values read MSB first from a packed stream."""
    if bits == 0:
        return np.zeros(n, np.uint64)
    need = n * bits
    stream = np.unpackbits(np.frombuffer(buf, np.uint8, -(-need // 8)))[:need]
    fields = stream.reshape(n, bits)
    width = -(-bits // 8) * 8
    padded = np.zeros((n, width), np.uint8)
    padded[:, width - bits:] = fields
    be = np.packbits(padded, axis=1)  # each value big-endian in width/8 bytes
    out = np.zeros(n, np.uint64)
    for k in range(width // 8):
        out = (out << np.uint64(8)) | be[:, k].astype(np.uint64)
    return out


def _uint(size: int) -> np.dtype:
    return np.dtype(f"<u{size}")


# ---------------------------------------------------------------------------
# scaleoffset
# ---------------------------------------------------------------------------

_SO_HEADER = 21   # minbits (4), minval's size (1), minval, padding


def scaleoffset_decode(buf: bytes, cd) -> bytes:
    """Undo `H5Z_FILTER_SCALEOFFSET` (cd values as HDF5 stores them:
    scale type, scale factor, elements, class, size, sign, order, fill
    defined, fill value words)."""
    scale_type, factor, nelmts, cls, size, sign, order, filavail = cd[:8]
    if cls not in (0, 1) or size not in (1, 2, 4, 8) or (cls == 1 and size not in (4, 8)):
        raise ValueError(f"scaleoffset class {cls} size {size}")
    if cls == 1 and scale_type != 0:
        raise ValueError("scaleoffset float E-scale (HDF5 does not decode it either)")
    if factor >= 1 << 31:
        factor -= 1 << 32   # a signed int in the parameters
    minbits = int.from_bytes(buf[0:4], "little")
    msize = min(8, buf[4])
    minval = int.from_bytes(buf[5:5 + msize], "little")
    nbytes = nelmts * size
    if minbits == size * 8:   # stored as they are
        out = np.frombuffer(buf, np.uint8, nbytes, _SO_HEADER).copy()
        return _to_order(out, size, order)
    bits = _unpack_fields(buf[_SO_HEADER:], nelmts, minbits)
    fill = b"".join(struct.pack("<I", w & 0xFFFFFFFF) for w in cd[8:8 + -(-size // 4)])[:size]
    all_ones = np.uint64((1 << minbits) - 1)
    ut = _uint(size)
    if cls == 0:
        vals = (bits + np.uint64(minval)).astype(ut)   # wraps as the C sum does
        if filavail == 1:
            vals = np.where(bits == all_ones, np.frombuffer(fill, ut)[0], vals).astype(ut)
        out = vals.view(np.uint8)
    else:
        ft, st = (np.float32, np.int32) if size == 4 else (np.float64, np.int64)
        vmin = np.frombuffer(minval.to_bytes(8, "little")[:size], ft)[0]
        # (type)sbuf / (type)pow(10, D) + min, in the element's precision
        vals = bits.astype(st).astype(ft) / ft(np.power(10.0, factor)) + vmin
        if filavail == 1:
            vals = np.where(bits.astype(st) == st(all_ones.astype(st)),
                            np.frombuffer(fill, ft)[0], vals).astype(ft)
        out = vals.view(np.uint8)
    return _to_order(out, size, order)


def _to_order(le_bytes: np.ndarray, size: int, order: int) -> bytes:
    if order == 1 and size > 1:   # big-endian dataset type
        return le_bytes.reshape(-1, size)[:, ::-1].tobytes()
    return le_bytes.tobytes()


# ---------------------------------------------------------------------------
# nbit
# ---------------------------------------------------------------------------

def nbit_decode(buf: bytes, cd, chunk_bytes: int) -> bytes:
    """Undo `H5Z_FILTER_NBIT` for an atomic type: cd = (count, no-compress
    flag, elements, class, size, order, precision, offset)."""
    if cd[1]:
        return buf
    if cd[3] != 1:
        raise ValueError(f"nbit class {cd[3]} (only atomic types are decoded)")
    nelmts, size, order, prec, off = cd[2], cd[4], cd[5], cd[6], cd[7]
    if off + prec > 8 * size:
        raise ValueError(f"nbit precision {prec} at offset {off} in {size} bytes")
    vals = _unpack_fields(buf, nelmts, prec) << np.uint64(off)
    le = vals.astype(_uint(size)).view(np.uint8)
    out = _to_order(le, size, order)
    if len(out) != chunk_bytes:
        raise ValueError(f"nbit chunk of {len(out)} bytes, expected {chunk_bytes}")
    return out


# ---------------------------------------------------------------------------
# szip (CCSDS 121.0 adaptive entropy coding, as libaec decodes it)
# ---------------------------------------------------------------------------

_SZ_MSB, _SZ_NN = 16, 32
_ROS = 5


def _se_table():
    table = []
    for i in range(13):
        ms = len(table)
        table += [(i, ms)] * (i + 1)
    return table


_SE = _se_table()


class _Bits:
    """An MSB-first bit reader over bytes, with unary (fundamental
    sequence) reads through the positions of the 1 bits."""

    def __init__(self, data: bytes):
        self.data = data + b"\0" * 9
        self.ones = np.flatnonzero(np.unpackbits(np.frombuffer(data, np.uint8))).tolist()
        self.pos = 0

    def get(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        byte = p >> 3
        nb = ((p & 7) + n + 7) >> 3
        word = int.from_bytes(self.data[byte:byte + nb], "big")
        self.pos = p + n
        return (word >> (nb * 8 - (p & 7) - n)) & ((1 << n) - 1)

    def fs(self) -> int:
        i = bisect.bisect_left(self.ones, self.pos)
        if i == len(self.ones):
            raise ValueError("szip stream ends inside a fundamental sequence")
        one = self.ones[i]
        count = one - self.pos
        self.pos = one + 1
        return count


def _aec_decode(data: bytes, nsamples: int, bps: int, block: int, rsi: int,
                preprocess: bool) -> list:
    """Unsigned samples of a CCSDS 121.0 stream (libaec's decoder, no
    padding between reference sample intervals)."""
    id_len = 5 if bps > 16 else 4 if bps > 8 else 3
    uncomp = (1 << id_len) - 1
    xmax = (1 << bps) - 1
    bits = _Bits(data)
    out: list = []
    rsi_samples = rsi * block
    while len(out) < nsamples:
        start = len(out)   # one RSI of residuals (its first the reference)
        rsi_out: list = []
        while len(rsi_out) < rsi_samples and start + len(rsi_out) < nsamples:
            ref = 1 if preprocess and not rsi_out else 0
            ident = bits.get(id_len)
            if ident == 0:
                se = bits.get(1)
                if ref:
                    rsi_out.append(bits.get(bps))
                if se:
                    i = ref
                    while i < block:
                        m = bits.fs()
                        if m >= len(_SE):
                            raise ValueError("szip second-extension code out of range")
                        beta, ms = _SE[m]
                        d1 = m - ms
                        if (i & 1) == 0:
                            rsi_out.append(beta - d1)
                            i += 1
                        rsi_out.append(d1)
                        i += 1
                else:
                    zero_blocks = bits.fs() + 1
                    if zero_blocks == _ROS:
                        b = len(rsi_out) // block
                        zero_blocks = min(rsi - b, 64 - (b % 64))
                    elif zero_blocks > _ROS:
                        zero_blocks -= 1
                    rsi_out += [0] * (zero_blocks * block - ref)
            elif ident == uncomp:
                rsi_out += [bits.get(bps) for _ in range(block)]
            else:
                k = ident - 1
                if ref:
                    rsi_out.append(bits.get(bps))
                n = block - ref
                fs = [bits.fs() for _ in range(n)]
                if k:
                    rsi_out += [(f << k) | bits.get(k) for f in fs]
                else:
                    rsi_out += fs
        if preprocess and rsi_out:
            last = rsi_out[0]
            res = [last]
            med = xmax // 2 + 1
            for d in rsi_out[1:]:
                half = (d >> 1) + (d & 1)
                mask = xmax if last & med else 0
                if half <= (mask ^ last):
                    last = (last + (-((d + 1) >> 1) if d & 1 else d >> 1)) & 0xFFFFFFFFFFFFFFFF
                else:
                    last = mask ^ d
                res.append(last)
            rsi_out = res
        out += rsi_out
    return out[:nsamples]


def szip_decode(buf: bytes, cd) -> bytes:
    """Undo HDF5's szip filter: a little-endian uint32 of the decoded size,
    then libaec's stream (cd = options mask, pixels per block, bits per
    pixel, pixels per scanline)."""
    mask, ppb, bpp, pps = cd[:4]
    size = int.from_bytes(buf[:4], "little")
    interleave = bpp in (32, 64)
    bps = 8 if interleave else bpp
    nbytes = 1 if bps <= 8 else 2 if bps <= 16 else 4
    nsamples = size // nbytes
    rsi = -(-pps // ppb)
    if pps % ppb:   # each scanline was padded to whole blocks
        lines = -(-nsamples // pps)
        samples = _aec_decode(bytes(buf[4:]), lines * rsi * ppb, bps, ppb, rsi,
                              bool(mask & _SZ_NN))
        arr = np.array(samples, np.uint64).reshape(lines, rsi * ppb)[:, :pps].ravel()
        arr = arr[:nsamples].astype(_uint(nbytes))
    else:
        samples = _aec_decode(bytes(buf[4:]), nsamples, bps, ppb, rsi, bool(mask & _SZ_NN))
        arr = np.array(samples, np.uint64).astype(_uint(nbytes))
    out = arr.astype(arr.dtype.newbyteorder(">")) if mask & _SZ_MSB and nbytes > 1 else arr
    raw = out.tobytes()
    if interleave:   # libaec codes 32/64-bit samples as byte planes
        w = bpp // 8
        n = len(raw) // w
        raw = np.frombuffer(raw, np.uint8, n * w).reshape(w, n).T.tobytes()
    return raw[:size]


# ---------------------------------------------------------------------------
# Jenkins lookup3 (H5_checksum_lookup3), for the metadata this package writes
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _rot(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & _M32


def lookup3(data: bytes, initval: int = 0) -> int:
    """HDF5's metadata checksum (Bob Jenkins' hashlittle)."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    p = 0
    while n - p > 12:
        x, y, z = struct.unpack_from("<3I", data, p)
        a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 4); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 6); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 8); b = (b + a) & _M32
        a = (a - c) & _M32; a ^= _rot(c, 16); c = (c + b) & _M32
        b = (b - a) & _M32; b ^= _rot(a, 19); a = (a + c) & _M32
        c = (c - b) & _M32; c ^= _rot(b, 4); b = (b + a) & _M32
        p += 12
    if n - p == 0:
        return c
    x, y, z = struct.unpack("<3I", bytes(data[p:]) + b"\0" * (12 - (n - p)))
    a, b, c = (a + x) & _M32, (b + y) & _M32, (c + z) & _M32
    c ^= b; c = (c - _rot(b, 14)) & _M32
    a ^= c; a = (a - _rot(c, 11)) & _M32
    b ^= a; b = (b - _rot(a, 25)) & _M32
    c ^= b; c = (c - _rot(b, 16)) & _M32
    a ^= c; a = (a - _rot(c, 4)) & _M32
    b ^= a; b = (b - _rot(a, 14)) & _M32
    c ^= b; c = (c - _rot(b, 24)) & _M32
    return c
