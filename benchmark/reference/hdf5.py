# Frozen copy of kmsr_tpu_torch/io/hdf5.py as of commit 84a67c1: the
# benchmark's own reader and writer of .nc files (benchmark/reference/nc.py
# is its netCDF layer). It writes the inputs of the file cells and reads
# their outputs back for the check, so a later change to the program's codec
# is judged against this one. Keep it as it is.
"""A reader and writer for HDF5 files: what h5py reads, and the subset of
it that netCDF-4 files use for writing.

numpy and `zlib` only (plus `io.hdf5_filters`). `io.ncio` keeps its
grouped-file contract on this module, so the port reads and writes `.nc`
files where h5py is not installed, and the files stay readable by h5py,
netCDF-C and the JAX package's `ncio` (which reads and writes through h5py).

Reads:
  * superblock v0 (what h5py writes by default) and v2/v3 (netCDF-C 4.x,
    h5py with `libver >= "v108"`); 8-byte offsets and lengths;
  * object headers v1 (continuations, NIL gaps) and v2 (`OHDR` / `OCHK`);
  * groups as symbol tables (v1 B-tree type 0, `SNOD` nodes, local heap),
    as compact link messages, and as dense links in a fractal heap indexed
    by a v2 B-tree of any depth, the heap filtered or not (each direct
    block decoded whole through the heap's pipeline); hard links, soft
    links (a symbol-table entry of cache type 2, or a link message of type
    1; absolute or relative to their group) and external links (type 64:
    the file is opened read-only, found by its own absolute name, then
    beside the linking file, then in the working directory), followed as
    HDF5 follows them (16 in a row at most); a dangling link is listed and
    raises KeyError naming it;
  * committed datatypes (`Datatype`: `dtype`, `attrs`, `name`), and shared
    datatype messages in datasets and attributes that point at them;
  * the shared object header message table (superblock extension message
    0x0F -> `SMTB`, its indexes a list or a v2 B-tree): a message shared
    through it (dataspace, datatype, fill value, pipeline, attribute, and
    an attribute's own datatype and dataspace) is read from its index's
    fractal heap by the heap ID the object header holds;
  * attributes compact (messages v1-v3) or dense, huge fractal-heap
    objects (over the heap's managed size, e.g. a >64 KiB attribute)
    included, both the directly and the B-tree-indexed kind, filtered or
    not;
  * datasets contiguous (storage never allocated reads as the fill
    value), compact, or chunked: layout v3 through a v1 B-tree of any
    depth, and layout v4 through each of its five chunk indexes (single
    chunk, implicit, fixed array, paged or not, extensible array with its
    super blocks and paged data blocks, the unlimited axis unswizzled,
    and version-2 B-tree records of type 10 and 11), edge chunks left
    unfiltered where the layout's flag says so;
  * filters: deflate, shuffle, fletcher32 (a checksum is verified, never
    ignored), and, decoded in `io.hdf5_filters`, lzf, scaleoffset (integer
    and float D-scale), szip and nbit; a chunk whose filter mask skipped a
    filter is read as stored;
  * datatypes: integers of 1-8 bytes (an nbit field of fewer bits read as
    HDF5 converts it), IEEE float16/32/64, fixed-length strings, enums
    (read as their base integer), arrays, compounds, object references,
    and variable-length sequences and strings (global heap).

Not verified: the Jenkins checksums of v2 object headers, fractal heaps,
v2 B-trees and the chunk indexes' blocks (fletcher32 on data is).

Still refused, each with `H5FormatError` naming the structure and its
file offset: a non-datatype message shared in another object header
(libhdf5 1.8+ shares them only through the table), a message of a type
the table has no index for; a filter this module has no decoder for,
where a chunk needs it; virtual datasets; datatypes of class time,
bitfield or opaque; non-IEEE floats.

A basic slice (`ds[lo:hi]`) decompresses only the chunks it touches.

Writes superblock v0, v1 object headers sized to their messages, symbol-
table groups with their entries sorted by name (soft links as entries of
cache type 2; a group holding an external link as link messages),
chunked datasets with h5py's guessed chunk shape through a v1 B-tree of
as many levels as the chunk grid needs (so a port-written file
decompresses the same chunks for a row slice as a JAX-written one),
dimension scales as HDF5's H5DS API lays them out (`CLASS`, `NAME`,
`REFERENCE_LIST`, `DIMENSION_LIST`), and attribute types as h5py maps them
(`str` and `bytes` -> fixed-length bytes, `int` -> int64, `float` ->
float64; numpy scalars and arrays keep their dtype). A file opened with
"w" or "a" is written once, on `close`, to a temporary file in the same
directory and moved into place with `os.replace`; "a" loads the existing
tree with its chunks still compressed, and every object reference is
rewritten to its target's new address (as is every reference in a file
copied by `copy_tree`). A loaded layout-v4 dataset is written as layout v3
with each chunk's bytes, size and filter mask as read (an unfiltered edge
chunk gets the mask of every filter), its dataspace message raw (so
`maxshape` survives) and its filters as they were; a message read from
the shared message table is written inline, unshared, and a group whose
links lived in a (filtered) heap in the codec's own layout; a committed
datatype is written as one and shared messages point at its new address;
an object
with an attribute too large for a message (over 64 KiB) keeps its
attributes in dense storage (a v2 object header, one fractal-heap block,
a one-leaf name index). New data is written with gzip 4 + shuffle or no
filter only.

The surface is the small part of h5py's that the port uses (`io.ncio`
lists the call sites): `File(path, mode)` with mode "r", "w" or "a";
`Group`: `keys`, `items`, `get`, `__iter__`, `__contains__`,
`__getitem__`, `attrs`, `create_group`, `create_dataset`, `visititems`;
`Dataset`: `shape`, `maxshape`, `chunks`, `dtype`, `size`, `attrs`,
`__getitem__`, `__array__`; `Datatype`: `dtype`, `attrs`; `attrs` with
`get`, `items`, `keys`, `__getitem__`, `__contains__`, `__setitem__` and
`__delitem__`; `SoftLink` / `ExternalLink` (h5py's `get(name,
getlink=True)`); plus `Dataset.make_scale` / `Dataset.attach_scale` for
netCDF dimensions (H5DS's calls) and `copy_tree` for copies. An object
reached through a soft link keeps the name of its hard link (h5py names it
by the path it was opened through).
"""
from __future__ import annotations

import os
import struct
import uuid
import zlib
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from . import hdf5_filters as _filters

__all__ = [
    "File", "Group", "Dataset", "Datatype", "AttributeManager", "Reference",
    "SoftLink", "ExternalLink", "H5FormatError", "copy_tree", "guess_chunk",
]

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF

# object header message types
_NIL, _DATASPACE, _LINKINFO, _DATATYPE, _FILL_OLD, _FILL = 0x0, 0x1, 0x2, 0x3, 0x4, 0x5
_LINK, _LAYOUT, _GROUPINFO, _PIPELINE, _ATTRIBUTE = 0x6, 0x8, 0xA, 0xB, 0xC
_SHARED_TABLE, _CONT, _STAB, _ATTRINFO = 0x0F, 0x10, 0x11, 0x15
_MSG_SHARED = 0x2       # message flag: the body lives elsewhere
# messages that carry nothing a reader of this subset needs
_IGNORED = {
    0x7,   # external data files (refused below if a layout needs them)
    0xD,   # comment
    0xE,   # modification time (old)
    0x12,  # modification time
    0x13,  # B-tree 'K' values
    0x16,  # object reference count
    0x17,  # file space info
}

# filters
_DEFLATE, _SHUFFLE, _FLETCHER32, _SZIP, _NBIT, _SCALEOFFSET, _LZF = 1, 2, 3, 4, 5, 6, 32000
_FILTER_NAMES = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip",
                 5: "nbit", 6: "scaleoffset", 32000: "lzf"}
_MAX_LINK_DEPTH = 16    # HDF5's limit on soft / external links followed in one lookup

_CHUNK_K = 32           # v1 B-tree K of chunk indexes (superblock v0 default)
_GROUP_NODE_K = 16      # v1 B-tree K of group indexes
_GROUP_LEAF_K = 4       # symbol table node K
_GHEAP_MIN = 4096       # smallest global heap collection HDF5 reads

_CHUNK_BASE, _CHUNK_MIN, _CHUNK_MAX = 16 * 1024, 8 * 1024, 1024 * 1024


class H5FormatError(ValueError):
    """A structure outside the supported subset, or a damaged file."""

    def __init__(self, structure: str, offset: int, detail: str):
        super().__init__(f"HDF5 {structure} at offset {offset:#x}: {detail}")
        self.structure, self.offset = structure, offset


def _align8(n: int) -> int:
    return (n + 7) & ~7


def _u(b, off: int, n: int) -> int:
    return int.from_bytes(b[off:off + n], "little")


def _le(v: int, n: int) -> bytes:
    return int(v).to_bytes(n, "little")


def guess_chunk(shape, typesize: int) -> tuple:
    """h5py's chunk shape for a dataset of `shape` (h5py._hl.filters)."""
    chunks = np.array([x if x != 0 else 1024 for x in shape], dtype="=f8")
    dset_size = float(np.prod(chunks)) * typesize
    target = _CHUNK_BASE * (2 ** np.log10(dset_size / (1024.0 * 1024)))
    target = min(max(target, _CHUNK_MIN), _CHUNK_MAX)
    idx = 0
    while True:
        chunk_bytes = float(np.prod(chunks)) * typesize
        if ((chunk_bytes < target or abs(chunk_bytes - target) / target < 0.5)
                and chunk_bytes < _CHUNK_MAX):
            break
        if np.prod(chunks) == 1:
            break
        chunks[idx % len(shape)] = np.ceil(chunks[idx % len(shape)] / 2.0)
        idx += 1
    return tuple(int(x) for x in chunks)


# ---------------------------------------------------------------------------
# Datatypes
# ---------------------------------------------------------------------------

class Reference:
    """An object reference: the target's object header address as read,
    or the target object itself once resolved (for rewriting)."""

    __slots__ = ("addr", "target")

    def __init__(self, addr: int = UNDEF, target=None):
        self.addr, self.target = addr, target

    def __bool__(self) -> bool:
        return self.target is not None or self.addr not in (0, UNDEF)

    def __repr__(self) -> str:
        return "<HDF5 object reference%s>" % ("" if self else " (null)")


class _Type:
    """A decoded HDF5 datatype.

    cls: 0 integer, 1 float, 3 string, 6 compound, 7 reference, 8 enum,
    9 variable length, 10 array. `raw` is the numpy dtype of one element's
    bytes on disk (references as uint64, variable-length slots as V16);
    `encoded` is the datatype message as read, re-emitted unchanged when a
    loaded attribute is written back.
    """

    def __init__(self, cls: int, size: int, raw: np.dtype, *, members=None,
                 base=None, is_str=False, dims=None,
                 encoded: bytes = b"", field=None):
        self.cls, self.size, self.raw = cls, size, np.dtype(raw)
        self.members = members or []   # compound: [(name, offset, _Type)]
        self.base = base               # vlen / array / enum base type
        self.is_str, self.dims = is_str, dims
        self.encoded = encoded
        # an integer narrower than its bytes: (bit offset, precision)
        self.field = field
        # the Datatype object this type was committed as, if any
        self.committed: Optional["Datatype"] = None

    def from_field(self, arr: np.ndarray) -> np.ndarray:
        """Raw integers -> their values, as HDF5 converts an integer of
        `precision` bits at `offset` to its full-width type."""
        if self.field is None:
            return arr
        off, prec = self.field
        u = arr.view(arr.dtype.str.replace("i", "u")).astype(np.uint64)
        v = (u >> np.uint64(off)) & np.uint64((1 << prec) - 1)
        if self.raw.kind == "i":
            sign = np.uint64(1 << (prec - 1))
            v = (v ^ sign) - sign   # wraps: sign extension in uint64
        return (v.view(np.int64) if self.raw.kind == "i" else v).astype(arr.dtype)

    @property
    def has_refs(self) -> bool:
        if self.cls in (7, 9):
            return True
        if self.cls == 6:
            return any(t.has_refs for _, _, t in self.members)
        return self.cls == 10 and self.base.has_refs

    def numpy_dtype(self) -> np.dtype:
        """The dtype h5py reports (references and vlen as objects)."""
        if self.cls in (7, 9):
            return np.dtype("O")
        if self.cls == 6:
            return np.dtype({
                "names": [m[0] for m in self.members],
                "formats": [m[2].numpy_dtype() for m in self.members],
                "offsets": [m[1] for m in self.members],
                "itemsize": self.size,
            })
        if self.cls == 10:
            return np.dtype((self.base.numpy_dtype(), self.dims))
        return self.raw


def _decode_type(b, off: int) -> Tuple[_Type, int]:
    """Decode the datatype message at `b[off:]`; returns (type, length)."""
    start = off
    cv = b[off]
    cls, ver = cv & 0x0F, cv >> 4
    bits = b[off + 1] | (b[off + 2] << 8) | (b[off + 3] << 16)
    size = _u(b, off + 4, 4)
    p = off + 8
    if cls == 0:  # fixed point
        order = ">" if bits & 1 else "<"
        boff, prec = struct.unpack_from("<HH", b, p)
        p += 4
        if size not in (1, 2, 4, 8) or prec == 0 or boff + prec > 8 * size:
            raise H5FormatError("integer datatype", start,
                                f"size {size} offset {boff} precision {prec}")
        t = _Type(0, size, np.dtype(f"{order}{'i' if bits & 8 else 'u'}{size}"),
                  field=None if (boff, prec) == (0, 8 * size) else (boff, prec))
    elif cls == 1:  # floating point
        if bits & 0x40:
            raise H5FormatError("float datatype", start, "VAX byte order")
        order = ">" if bits & 1 else "<"
        boff, prec = struct.unpack_from("<HH", b, p)
        eloc, esize, mloc, msize = b[p + 4], b[p + 5], b[p + 6], b[p + 7]
        ieee = {2: (16, 10, 5, 0, 10), 4: (32, 23, 8, 0, 23), 8: (64, 52, 11, 0, 52)}
        if size not in ieee or boff != 0 or (prec, eloc, esize, mloc, msize) != ieee[size]:
            raise H5FormatError("float datatype", start, f"non-IEEE layout, size {size}")
        p += 12
        t = _Type(1, size, np.dtype(f"{order}f{size}"))
    elif cls == 3:  # fixed-length string
        t = _Type(3, size, np.dtype(f"S{size}"))
    elif cls == 6:  # compound
        members = []
        for _ in range(bits & 0xFFFF):
            end = bytes(b[p:p + 65536]).index(b"\0", 0)
            name = bytes(b[p:p + end]).decode("utf-8")
            if ver >= 3:
                p += end + 1
                nb = 1 if size < 256 else 2 if size < 65536 else 3 if size < 1 << 24 else 4
                moff = _u(b, p, nb)
                p += nb
            else:
                p += _align8(end + 1)
                moff = _u(b, p, 4)
                p += 4
                if ver == 1:
                    ndims = b[p]
                    p += 28
                    if ndims:
                        raise H5FormatError("compound datatype", start,
                                            f"member {name!r} with array dimensions")
            mt, n = _decode_type(b, p)
            p += n
            members.append((name, moff, mt))
        raw = np.dtype({"names": [m[0] for m in members],
                        "formats": [m[2].raw for m in members],
                        "offsets": [m[1] for m in members], "itemsize": size})
        t = _Type(6, size, raw, members=members)
    elif cls == 7:  # reference
        if ver >= 4 or (bits & 0xF) != 0 or size != 8:
            raise H5FormatError("reference datatype", start,
                                f"type {bits & 0xF} version {ver}: only object references")
        t = _Type(7, 8, np.dtype("<u8"))
    elif cls == 8:  # enumeration: read as the base integer
        base, n = _decode_type(b, p)
        p += n
        nmemb = bits & 0xFFFF
        for _ in range(nmemb):
            end = bytes(b[p:p + 65536]).index(b"\0")
            p += end + 1 if ver >= 3 else _align8(end + 1)
        p += nmemb * base.size
        t = _Type(8, size, base.raw, base=base)
    elif cls == 9:  # variable length
        base, n = _decode_type(b, p)
        p += n
        if size != 16:
            raise H5FormatError("vlen datatype", start, f"size {size}")
        t = _Type(9, 16, np.dtype("V16"), base=base, is_str=(bits & 0xF) == 1)
    elif cls == 10:  # array
        ndims = b[p]
        p += 1 if ver >= 3 else 4
        dims = tuple(_u(b, p + 4 * i, 4) for i in range(ndims))
        p += 4 * ndims
        if ver < 3:
            p += 4 * ndims  # permutation
        base, n = _decode_type(b, p)
        p += n
        t = _Type(10, size, np.dtype((base.raw, dims)), base=base, dims=dims)
    else:
        names = {2: "time", 4: "bitfield", 5: "opaque"}
        raise H5FormatError("datatype", start,
                            f"class {cls} ({names.get(cls, 'unknown')}) not supported")
    t.encoded = bytes(b[start:p])
    return t, p - start


def _float_props(size: int) -> bytes:
    prec, eloc, esize, mloc, msize, bias = {
        2: (16, 10, 5, 0, 10, 15), 4: (32, 23, 8, 0, 23, 127),
        8: (64, 52, 11, 0, 52, 1023)}[size]
    return struct.pack("<HHBBBBI", 0, prec, eloc, esize, mloc, msize, bias)


def _type_for_dtype(dt: np.dtype) -> _Type:
    """The datatype h5py writes for a numpy dtype (little-endian only)."""
    dt = np.dtype(dt)
    if dt.byteorder == ">":
        raise TypeError(f"big-endian dtype {dt} is not written")
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0
        enc = struct.pack("<B3BI", 0x10, bits, 0, 0, dt.itemsize) + struct.pack(
            "<HH", 0, 8 * dt.itemsize)
        return _Type(0, dt.itemsize, dt.newbyteorder("<"), encoded=enc)
    if dt.kind == "f" and dt.itemsize in (2, 4, 8):
        sign = 8 * dt.itemsize - 1
        enc = struct.pack("<B3BI", 0x11, 0x20, sign, 0, dt.itemsize) + _float_props(dt.itemsize)
        return _Type(1, dt.itemsize, dt.newbyteorder("<"), encoded=enc)
    if dt.kind == "S":
        size = max(dt.itemsize, 1)
        enc = struct.pack("<B3BI", 0x13, 0x01, 0, 0, size)  # null-padded ASCII
        return _Type(3, size, np.dtype(f"S{size}"), encoded=enc)
    raise TypeError(f"dtype {dt} is not written by this codec")


def _string_type(size: int, nullterm: bool) -> _Type:
    enc = struct.pack("<B3BI", 0x13, 0 if nullterm else 1, 0, 0, size)
    return _Type(3, size, np.dtype(f"S{size}"), encoded=enc)


_REF_TYPE = _Type(7, 8, np.dtype("<u8"), encoded=struct.pack("<B3BI", 0x17, 0, 0, 0, 8))
# H5DS's REFERENCE_LIST element: {hobj_ref_t dataset; unsigned dimension}
_U32_TYPE = _type_for_dtype(np.dtype("<u4"))
_REFLIST_TYPE = _Type(
    6, 16, np.dtype({"names": ["dataset", "dimension"], "formats": ["<u8", "<u4"],
                     "offsets": [0, 8], "itemsize": 16}),
    members=[("dataset", 0, _REF_TYPE), ("dimension", 8, _U32_TYPE)],
    encoded=(struct.pack("<B3BI", 0x16, 2, 0, 0, 16)
             + b"dataset\0" + struct.pack("<IB3xI4x16x", 0, 0, 0) + _REF_TYPE.encoded
             + b"dimension\0\0\0\0\0\0\0" + struct.pack("<IB3xI4x16x", 8, 0, 0)
             + _U32_TYPE.encoded))
# DIMENSION_LIST: a variable-length sequence of object references
_DIMLIST_TYPE = _Type(9, 16, np.dtype("V16"), base=_REF_TYPE,
                      encoded=struct.pack("<B3BI", 0x19, 0, 0, 0, 16) + _REF_TYPE.encoded)


# ---------------------------------------------------------------------------
# Dataspaces
# ---------------------------------------------------------------------------

def _decode_space(b, off: int) -> Optional[tuple]:
    """Shape of the dataspace message at `b[off:]`; None for a null space."""
    ver, rank, flags = b[off], b[off + 1], b[off + 2]
    if ver == 1:
        p = off + 8
    elif ver == 2:
        if b[off + 3] == 2:
            return None
        p = off + 4
    else:
        raise H5FormatError("dataspace", off, f"version {ver}")
    return tuple(_u(b, p + 8 * i, 8) for i in range(rank))


def _decode_maxshape(b, off: int) -> Optional[tuple]:
    """Max dimensions of a dataspace message (None where there are none
    stored, i.e. equal to the shape); an unlimited dimension is None."""
    ver, rank, flags = b[off], b[off + 1], b[off + 2]
    if not flags & 1 or (ver == 2 and b[off + 3] == 2):
        return None
    p = (off + 8 if ver == 1 else off + 4) + 8 * rank
    return tuple(None if _u(b, p + 8 * i, 8) == UNDEF else _u(b, p + 8 * i, 8)
                 for i in range(rank))


def _in_table(b) -> bool:
    """Whether a shared message's encoding names a message of the shared
    object header message table (version 3, type 1: its heap ID)."""
    return b[0] == 3 and b[1] == 1


def _shared_address(b, where: int, what: str) -> int:
    """The object header address a shared message names (a committed
    datatype)."""
    ver = b[0]
    if ver == 1:
        return _u(b, 8, 8)
    if ver in (2, 3) and (ver == 2 or b[1] == 2):
        return _u(b, 2, 8)
    raise H5FormatError(f"shared {what} message", where, f"version {ver} type {b[1]}")


def _encode_space(shape: tuple) -> bytes:
    """A version-1 dataspace (scalar when `shape` is ())."""
    rank = len(shape)
    if rank == 0:
        return struct.pack("<BBBB4x", 1, 0, 0, 0)
    return (struct.pack("<BBBB4x", 1, rank, 1, 0)
            + b"".join(_le(d, 8) for d in shape) * 2)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

class _Msg:
    __slots__ = ("type", "flags", "data", "corder", "addr")

    def __init__(self, mtype, flags, data, corder, addr):
        self.type, self.flags, self.data, self.corder, self.addr = (
            mtype, flags, data, corder, addr)


class _Source:
    """Random access to an open HDF5 file."""

    def __init__(self, path: str):
        self.path = path
        self.fh = open(path, "rb")
        self.fd = self.fh.fileno()
        self.size = os.fstat(self.fd).st_size
        self._gheaps: Dict[int, Dict[int, bytes]] = {}
        self._fheaps: Dict[int, "_FractalHeap"] = {}
        self._table: Optional[Dict[int, int]] = None
        self.ext_addr = UNDEF
        self._parse_superblock()

    def close(self) -> None:
        self.fh.close()

    def read(self, addr: int, n: int, what: str = "data") -> bytes:
        if addr == UNDEF or addr + n > self.size:
            raise H5FormatError(what, addr, f"{n} bytes past the end of the file "
                                f"({self.size} bytes)")
        return os.pread(self.fd, n, addr)

    # -- superblock ---------------------------------------------------------
    def _parse_superblock(self) -> None:
        b = self.read(0, 96, "superblock")
        if b[:8] != SIGNATURE:
            raise H5FormatError("superblock", 0, "not an HDF5 file (no signature at 0)")
        ver = b[8]
        if ver in (0, 1):
            if b[13] != 8 or b[14] != 8:
                raise H5FormatError("superblock", 0, f"offset/length sizes {b[13]}/{b[14]}")
            p = 24 if ver == 0 else 28
            base = _u(b, p, 8)
            # root group symbol table entry: name offset, header address
            self.root_addr = _u(b, p + 32 + 8, 8)
        elif ver in (2, 3):
            if b[9] != 8 or b[10] != 8:
                raise H5FormatError("superblock", 0, f"offset/length sizes {b[9]}/{b[10]}")
            base = _u(b, 12, 8)
            self.ext_addr = _u(b, 20, 8)
            self.root_addr = _u(b, 36, 8)
        else:
            raise H5FormatError("superblock", 0, f"version {ver}")
        if base != 0:
            raise H5FormatError("superblock", 0, f"base address {base}")
        self.superblock_version = ver

    # -- object headers -------------------------------------------------------
    def messages(self, addr: int) -> List[_Msg]:
        """Every message of the object header at `addr`, in file order."""
        head = self.read(addr, 16, "object header")
        out: List[_Msg] = []
        if head[:4] == b"OHDR":
            if head[4] != 2:
                raise H5FormatError("object header", addr, f"OHDR version {head[4]}")
            flags = head[5]
            p = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            nsz = 1 << (flags & 3)
            pre = self.read(addr, p + nsz, "object header")
            size0 = _u(pre, p, nsz)
            start = addr + p + nsz
            queue = [(start, self.read(start, size0, "object header"))]
            corder = bool(flags & 0x04)
            while queue:
                base, buf = queue.pop(0)
                self._v2_messages(base, buf, corder, out, queue)
        elif head[0] == 1:
            nmsgs, _, size0 = struct.unpack_from("<HII", head, 2)
            queue = [(addr + 16, self.read(addr + 16, size0, "object header"))]
            while queue:
                base, buf = queue.pop(0)
                p = 0
                while p + 8 <= len(buf):
                    mtype, msize, mflags = struct.unpack_from("<HHB", buf, p)
                    data = buf[p + 8:p + 8 + msize]
                    if mtype == _CONT:
                                        caddr, clen = struct.unpack_from("<QQ", data)
                                        queue.append((caddr, self.read(caddr, clen, "object header continuation")))
                    elif mtype != _NIL:
                        out.append(_Msg(mtype, mflags, data, None, base + p))
                    p += 8 + msize
        else:
            raise H5FormatError("object header", addr, f"unknown version byte {head[0]}")
        for m in out:
            if m.flags & _MSG_SHARED and _in_table(m.data):
                m.data = self.table_message(m.type, m.data[2:10], m.addr)
                m.flags &= ~_MSG_SHARED
        return out

    # -- the shared object header message table -----------------------------
    def table_message(self, mtype: int, heap_id: bytes, where: int) -> bytes:
        """The body of a message of type `mtype` that the shared object
        header message table holds, by its heap ID: each of the table's
        indexes (superblock extension message 0x0F -> `SMTB`) keeps the
        messages of its types in a fractal heap of its own."""
        if self._table is None:
            self._table = {}
            for m in self.messages(self.ext_addr) if self.ext_addr != UNDEF else []:
                if m.type != _SHARED_TABLE:
                    continue
                addr, n = _u(m.data, 1, 8), m.data[9]
                b = self.read(addr, 4 + 30 * n, "shared message table")
                if b[:4] != b"SMTB":
                    raise H5FormatError("shared message table", addr, "no SMTB signature")
                for i in range(n):
                    # version, index type, message type flags, minimum size,
                    # list and B-tree cut-offs, count, index address, heap
                    e = 4 + 30 * i
                    flags, heap = _u(b, e + 2, 2), _u(b, e + 22, 8)
                    self._table.update({t: heap for t in range(16) if flags >> t & 1})
        if mtype not in self._table:
            raise H5FormatError("shared message", where, f"type {mtype:#x} in the shared "
                                "message table, which has no index of that type")
        return self.fheap(self._table[mtype]).get(bytes(heap_id))

    def _v2_messages(self, base, buf, corder, out, queue) -> None:
        hdr = 6 if corder else 4
        p = 0
        end = len(buf)
        while p + hdr <= end:
            mtype, msize, mflags = buf[p], _u(buf, p + 1, 2), buf[p + 3]
            co = _u(buf, p + 4, 2) if corder else None
            data = buf[p + hdr:p + hdr + msize]
            if mtype == _CONT:
                caddr, clen = struct.unpack_from("<QQ", data)
                chunk = self.read(caddr, clen, "object header continuation")
                if chunk[:4] != b"OCHK":
                    raise H5FormatError("object header continuation", caddr, "no OCHK signature")
                queue.append((caddr + 4, chunk[4:-4]))
            elif mtype != _NIL:
                out.append(_Msg(mtype, mflags, data, co, base + p))
            p += hdr + msize

    # -- global heap ----------------------------------------------------------
    def gheap_object(self, addr: int, index: int) -> bytes:
        objs = self._gheaps.get(addr)
        if objs is None:
            head = self.read(addr, 16, "global heap")
            if head[:4] != b"GCOL":
                raise H5FormatError("global heap", addr, "no GCOL signature")
            size = _u(head, 8, 8)
            buf = self.read(addr, size, "global heap")
            objs = {}
            p = 16
            while p + 16 <= size:
                idx, _, osize = struct.unpack_from("<HH4xQ", buf, p)
                if idx == 0:
                    break
                objs[idx] = buf[p + 16:p + 16 + osize]
                p += 16 + _align8(osize)
            self._gheaps[addr] = objs
        if index not in objs:
            raise H5FormatError("global heap", addr, f"no object {index}")
        return objs[index]

    def fheap(self, addr: int) -> "_FractalHeap":
        h = self._fheaps.get(addr)
        if h is None:
            h = self._fheaps[addr] = _FractalHeap(self, addr)
        return h

    # -- v1 B-trees -------------------------------------------------------------
    def btree_v1(self, addr: int, ntype: int, key_size: int,
                 leaf: Callable[[bytes, int, bytes], None]) -> None:
        """Visit every level-0 child of the v1 B-tree at `addr`, in key
        order: leaf(left key bytes, child address, right key bytes)."""
        stack = [addr]
        while stack:
            a = stack.pop()
            head = self.read(a, 24, "v1 B-tree node")
            if head[:4] != b"TREE" or head[4] != ntype:
                raise H5FormatError("v1 B-tree node", a,
                                    f"signature {head[:4]!r} type {head[4]}")
            level, n = head[5], _u(head, 6, 2)
            body = self.read(a + 24, n * (8 + key_size) + key_size, "v1 B-tree node")
            children = []
            for i in range(n):
                k0 = i * (key_size + 8)
                child = _u(body, k0 + key_size, 8)
                if level == 0:
                    leaf(body[k0:k0 + key_size], child,
                         body[k0 + key_size + 8:k0 + 2 * key_size + 8])
                else:
                    children.append(child)
            stack.extend(reversed(children))


class _FractalHeap:
    """Managed objects of a fractal heap (dense links and attributes, the
    shared message table's messages). A filtered heap's direct blocks are
    decoded whole through its pipeline, then addressed as stored ones."""

    def __init__(self, src: _Source, addr: int):
        self.src, self.addr = src, addr
        h = src.read(addr, 146, "fractal heap")
        if h[:4] != b"FRHP" or h[4] != 0:
            raise H5FormatError("fractal heap", addr, f"signature {h[:4]!r} version {h[4]}")
        self.id_len, self.filter_len = _u(h, 5, 2), _u(h, 7, 2)
        # filtered: the root direct block's stored size and filter mask,
        # then the pipeline message
        self.pipeline: Optional[_Pipeline] = None
        self.root_filtered: Tuple[Optional[int], int] = (None, 0)
        if self.filter_len:
            f = src.read(addr + 142, 12 + self.filter_len, "fractal heap")
            self.root_filtered = (_u(f, 0, 8), _u(f, 8, 4))
            self.pipeline = _Pipeline.decode(f[12:], addr + 154)
        self._decoded: Dict[int, bytes] = {}
        self.flags = h[9]
        max_man = _u(h, 10, 4)
        self.huge_btree = _u(h, 22, 8)
        self._huge: Optional[Dict[int, Tuple[int, int]]] = None
        p = 14 + 8 + 8 + 8 + 8 + 8 + 8 + 8 + 8 + 8 + 8 + 8 + 8
        self.width = _u(h, p, 2)
        self.start_block, self.max_direct = _u(h, p + 2, 8), _u(h, p + 10, 8)
        self.max_heap_bits = _u(h, p + 18, 2)
        self.root = _u(h, p + 22, 8)
        self.root_rows = _u(h, p + 30, 2)
        self.off_size = (self.max_heap_bits + 7) // 8
        dir_off = (self.max_direct.bit_length() - 1 + 7) // 8
        self.len_size = min(dir_off, (max_man.bit_length() - 1) // 8 + 1)
        self.max_direct_rows = (self.max_direct.bit_length() - self.start_block.bit_length()) + 2
        self._blocks: Optional[List[tuple]] = None

    def _row_size(self, row: int) -> int:
        return self.start_block if row == 0 else self.start_block << (row - 1)

    def _walk(self) -> List[tuple]:
        """(heap offset, size, address, stored size or None, filter mask)
        of every allocated direct block."""
        blocks: List[tuple] = []
        if self.root == UNDEF:
            return blocks
        if self.root_rows == 0:
            blocks.append((0, self.start_block, self.root) + self.root_filtered)
            return blocks
        first_bits = (self.start_block.bit_length() - 1) + (self.width.bit_length() - 1)
        # a filtered heap's direct-block entry adds its stored size and mask
        dentry = 20 if self.pipeline else 8

        def indirect(addr: int, nrows: int, heap_off: int) -> None:
            ndirect = min(nrows, self.max_direct_rows)
            hdr = 5 + 8 + self.off_size
            nbytes = hdr + self.width * (dentry * ndirect + 8 * (nrows - ndirect))
            buf = self.src.read(addr, nbytes, "fractal heap indirect block")
            if buf[:4] != b"FHIB":
                raise H5FormatError("fractal heap indirect block", addr, "no FHIB signature")
            p, off = hdr, heap_off
            for row in range(nrows):
                size = self._row_size(row)
                for _ in range(self.width):
                    child = _u(buf, p, 8)
                    if row < ndirect and self.pipeline:
                        stored = (_u(buf, p + 8, 8), _u(buf, p + 16, 4))
                    else:
                        stored = (None, 0)
                    p += dentry if row < ndirect else 8
                    if child != UNDEF:
                        if row < ndirect:
                            blocks.append((off, size, child) + stored)
                        else:
                            indirect(child, (size.bit_length() - 1) - first_bits + 1, off)
                    off += size

        indirect(self.root, self.root_rows, 0)
        return blocks

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind == 2:  # tiny: stored in the ID itself
            if self.id_len <= 18:
                n = (heap_id[0] & 0x0F) + 1
                return bytes(heap_id[1:1 + n])
            n = (((heap_id[0] & 0x0F) << 8) | heap_id[1]) + 1
            return bytes(heap_id[2:2 + n])
        if kind == 1:
            return self._huge_object(heap_id)
        if kind != 0:
            raise H5FormatError("fractal heap", self.addr, f"heap ID of type {kind}")
        off = _u(heap_id, 1, self.off_size)
        length = _u(heap_id, 1 + self.off_size, self.len_size)
        if self._blocks is None:
            self._blocks = self._walk()
        for boff, bsize, baddr, stored, mask in self._blocks:
            if boff <= off < boff + bsize:
                if stored is None:
                    return self.src.read(baddr + off - boff, length, "fractal heap object")
                if baddr not in self._decoded:
                    self._decoded[baddr] = bytes(self.pipeline.decode_chunk(
                        self.src.read(baddr, stored, "fractal heap direct block"), mask, 1,
                        baddr, bsize))
                return self._decoded[baddr][off - boff:off - boff + length]
        raise H5FormatError("fractal heap", self.addr, f"no block holds offset {off}")

    def _huge_object(self, heap_id: bytes) -> bytes:
        """A huge object: stored on its own, its address and length (in a
        filtered heap also its filter mask and decoded size) in the heap ID
        itself where the ID is long enough (H5HFhuge.c), else in the heap's
        huge-object v2 B-tree under the ID's number (record type 1, or 2
        when filtered)."""
        filtered = self.pipeline is not None
        fields = 4 if filtered else 2    # address, length[, mask, size]
        if self.id_len - 1 >= 8 * fields - 4 * filtered:   # directly accessed
            rec = heap_id[1:]
        else:
            if self._huge is None:
                key_at = 28 if filtered else 16
                self._huge = {_u(r, key_at, 8): r
                              for r in _btree_v2_records(self.src, self.huge_btree)}
            key = _u(heap_id, 1, min(self.id_len - 1, 8))
            if key not in self._huge:
                raise H5FormatError("fractal heap", self.addr, f"no huge object {key}")
            rec = self._huge[key]
        data = self.src.read(_u(rec, 0, 8), _u(rec, 8, 8), "huge fractal heap object")
        if filtered:
            data = bytes(self.pipeline.decode_chunk(data, _u(rec, 16, 4), 1, self.addr,
                                                    _u(rec, 20, 8)))
        return data


def _btree_v2_records(src: _Source, addr: int) -> List[bytes]:
    """Every record of the v2 B-tree at `addr` (in tree order)."""
    h = src.read(addr, 38, "v2 B-tree header")
    if h[:4] != b"BTHD":
        raise H5FormatError("v2 B-tree header", addr, "no BTHD signature")
    node_size, rec_size, depth = _u(h, 6, 4), _u(h, 10, 2), _u(h, 12, 2)
    root, root_n = _u(h, 16, 8), _u(h, 24, 2)
    # per-level record counts and the byte widths of the child pointers'
    # counts, as H5B2__hdr_init computes them
    max_nrec = [(node_size - 10) // rec_size]
    cum = [max_nrec[0]]
    cum_size = [0]
    nrec_size = (max_nrec[0].bit_length() - 1) // 8 + 1
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        m = (node_size - (10 + ptr)) // (rec_size + ptr)
        max_nrec.append(m)
        cum.append((m + 1) * cum[d - 1] + m)
        cum_size.append((cum[d].bit_length() - 1) // 8 + 1)
    out: List[bytes] = []

    def node(a: int, nrec: int, d: int) -> None:
        if a == UNDEF or nrec == 0:
            return
        sig = b"BTIN" if d else b"BTLF"
        ptr = (8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)) if d else 0
        buf = src.read(a, 6 + nrec * rec_size + (nrec + 1) * ptr, "v2 B-tree node")
        if buf[:4] != sig:
            raise H5FormatError("v2 B-tree node", a, f"expected {sig!r}, got {buf[:4]!r}")
        recs = [buf[6 + i * rec_size:6 + (i + 1) * rec_size] for i in range(nrec)]
        if d == 0:
            out.extend(recs)
            return
        p = 6 + nrec * rec_size
        for i in range(nrec + 1):
            child, cn = _u(buf, p, 8), _u(buf, p + 8, nrec_size)
            node(child, cn, d - 1)
            if i < nrec:
                out.append(recs[i])
            p += ptr

    node(root, root_n, depth)
    return out


class SoftLink:
    """A soft link: a path, absolute or relative to the group holding it."""

    __slots__ = ("path",)

    def __init__(self, path: str):
        self.path = path

    def __repr__(self) -> str:
        return f"<SoftLink to {self.path!r}>"


class ExternalLink:
    """An external link: an object path inside another HDF5 file."""

    __slots__ = ("filename", "path")

    def __init__(self, filename: str, path: str):
        self.filename, self.path = filename, path

    def __repr__(self) -> str:
        return f"<ExternalLink to {self.path!r} in {self.filename!r}>"


def _parse_link(b, off: int = 0):
    """(name, target, creation order) of a link message; the target is an
    object header address, a SoftLink or an ExternalLink."""
    if b[off] != 1:
        raise H5FormatError("link message", off, f"version {b[off]}")
    flags = b[off + 1]
    p = off + 2
    ltype = 0
    if flags & 0x08:
        ltype = b[p]
        p += 1
    corder = None
    if flags & 0x04:
        corder = _u(b, p, 8)
        p += 8
    if flags & 0x10:
        p += 1
    nsz = 1 << (flags & 3)
    nlen = _u(b, p, nsz)
    p += nsz
    name = bytes(b[p:p + nlen]).decode("utf-8")
    p += nlen
    if ltype == 0:
        return name, _u(b, p, 8), corder
    vlen = _u(b, p, 2)
    value = bytes(b[p + 2:p + 2 + vlen])
    if ltype == 1:
        return name, SoftLink(value.decode("utf-8")), corder
    if ltype == 64:
        fname, path = value[1:].split(b"\0")[:2]
        return name, ExternalLink(fname.decode("utf-8"), path.decode("utf-8")), corder
    raise H5FormatError("link message", off, f"link {name!r} of user-defined type {ltype}")


def _parse_attribute(b, where: int, file: "File"):
    """(name, type, shape, raw data bytes) of an attribute; a shared
    (committed) datatype is read from its object header in `file`."""
    ver = b[0]
    if ver == 1:
        nsz, tsz, ssz = struct.unpack_from("<HHH", b, 2)
        p = 8
        name = bytes(b[p:p + nsz]).split(b"\0", 1)[0].decode("utf-8")
        p += _align8(nsz)
        t, _ = _decode_type(b, p)
        p += _align8(tsz)
        shape = _decode_space(b, p)
        p += _align8(ssz)
    elif ver in (2, 3):
        nsz, tsz, ssz = struct.unpack_from("<HHH", b, 2)
        p = 8 if ver == 2 else 9
        name = bytes(b[p:p + nsz]).split(b"\0", 1)[0].decode("utf-8")
        p += nsz
        tb = b[p:p + tsz]
        if b[1] & 0x1 and _in_table(tb):
            t, _ = _decode_type(file._src.table_message(_DATATYPE, tb[2:10], where), 0)
        elif b[1] & 0x1:
            t = file._committed_type(_shared_address(tb, where, "datatype"))
        else:
            t, _ = _decode_type(b, p)
        p += tsz
        sb = b[p:p + ssz]
        if not b[1] & 0x2:
            shape = _decode_space(b, p)
        elif _in_table(sb):
            shape = _decode_space(file._src.table_message(_DATASPACE, sb[2:10], where), 0)
        else:
            raise H5FormatError("attribute message", where,
                                f"dataspace shared outside the shared message table "
                                f"(version {sb[0]} type {sb[1]})")
        p += ssz
    else:
        raise H5FormatError("attribute message", where, f"version {ver}")
    n = 0 if shape is None else int(np.prod(shape, dtype=np.int64))
    return name, t, shape, bytes(b[p:p + n * t.size])


def _unshuffle(buf: bytes, size: int) -> bytes:
    """Undo HDF5's shuffle: byte k of every element is stored in plane k."""
    n = len(buf) // size
    if size <= 1 or n <= 1:
        return buf
    planes = np.frombuffer(buf, np.uint8, n * size).reshape(size, n)
    out = np.empty((n, size), np.uint8)
    for k in range(size):  # a column at a time: far faster than planes.T
        out[:, k] = planes[k]
    if len(buf) > n * size:
        return out.tobytes() + buf[n * size:]
    return out.reshape(-1)  # uint8 array: np.frombuffer takes it as it is


def _shuffle(buf: bytes, size: int) -> bytes:
    n = len(buf) // size
    if size <= 1 or n <= 1:
        return buf
    elems = np.frombuffer(buf, np.uint8, n * size).reshape(n, size)
    out = np.empty((size, n), np.uint8)
    for k in range(size):
        out[k] = elems[:, k]
    return out.tobytes() + buf[n * size:]


def _fletcher32(data: bytes) -> int:
    """HDF5's H5_checksum_fletcher32 (16-bit big-endian words, 360 a block)."""
    n = len(data) // 2
    words = np.frombuffer(data, ">u2", n).astype(np.int64)
    s1 = s2 = 0
    for i in range(0, n, 360):
        w = words[i:i + 360]
        cs = np.cumsum(w)
        s2 += len(w) * s1 + int(cs.sum())
        s1 += int(cs[-1])
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


class _Pipeline:
    """A filter pipeline: [(id, flags, client values)] plus the message."""

    def __init__(self, filters, encoded: bytes):
        self.filters, self.encoded = filters, encoded

    @classmethod
    def decode(cls, b, where: int) -> "_Pipeline":
        ver, n = b[0], b[1]
        p = 8 if ver == 1 else 2
        filters = []
        for _ in range(n):
            fid = _u(b, p, 2)
            p += 2
            nlen = 0
            if ver == 1 or fid >= 256:
                nlen = _u(b, p, 2)
                p += 2
            flags, ncd = struct.unpack_from("<HH", b, p)
            p += 4
            p += nlen
            cd = struct.unpack_from(f"<{ncd}I", b, p)
            p += 4 * ncd
            if ver == 1 and ncd % 2:
                p += 4
            # an unknown filter is refused only where a chunk needs it: h5py
            # stores a chunk an optional filter could not shrink unfiltered
            filters.append((fid, flags, cd))
        return cls(filters, bytes(b))

    def decode_chunk(self, buf: bytes, mask: int, itemsize: int, where: int,
                     nbytes: Optional[int] = None) -> bytes:
        """Undo the filters not masked out, last first; `nbytes` is the
        chunk's decoded size."""
        for i in range(len(self.filters) - 1, -1, -1):
            if mask & (1 << i):
                continue
            fid, _, cd = self.filters[i]
            if fid not in _FILTER_NAMES:
                raise H5FormatError("chunk", where, f"filter {fid} (unknown; h5py without "
                                    "its plugin cannot decode it either)")
            try:
                if fid == _DEFLATE:
                    buf = zlib.decompress(buf)
                elif fid == _SHUFFLE:
                    buf = _unshuffle(buf, cd[0] if cd else itemsize)
                elif fid == _FLETCHER32:
                    stored = _u(buf, len(buf) - 4, 4)
                    buf = buf[:-4]
                    f = _fletcher32(buf)
                    swapped = int.from_bytes(f.to_bytes(4, "little"), "big")
                    if stored not in (f, swapped):
                        raise H5FormatError("chunk", where, "fletcher32 checksum mismatch")
                elif fid == _LZF:
                    buf = _filters.lzf_decode(bytes(buf), cd[2] if len(cd) > 2 and cd[2]
                                              else nbytes or 1 << 62)
                elif fid == _SCALEOFFSET:
                    buf = _filters.scaleoffset_decode(bytes(buf), cd)
                elif fid == _SZIP:
                    buf = _filters.szip_decode(bytes(buf), cd)
                else:
                    buf = _filters.nbit_decode(bytes(buf), cd, nbytes)
            except H5FormatError:
                raise
            except (ValueError, zlib.error) as e:
                raise H5FormatError("chunk", where, f"{_FILTER_NAMES[fid]} filter: {e}") from e
        return buf

    @staticmethod
    def gzip_shuffle(level: int, itemsize: int) -> "_Pipeline":
        """Shuffle then deflate, encoded as HDF5 writes it (version 1)."""
        def entry(fid, name, cd):
            nm = name + b"\0" * (8 - len(name) % 8 if len(name) % 8 else 8)
            body = struct.pack("<HHHH", fid, len(nm), 1, len(cd)) + nm + struct.pack(
                f"<{len(cd)}I", *cd)
            return body + (b"\0" * 4 if len(cd) % 2 else b"")
        enc = (struct.pack("<BB6x", 1, 2) + entry(_SHUFFLE, b"shuffle", (itemsize,))
               + entry(_DEFLATE, b"deflate", (level,)))
        return _Pipeline([(_SHUFFLE, 1, (itemsize,)), (_DEFLATE, 1, (level,))], enc)

    def encode_chunk(self, buf: bytes, itemsize: int) -> bytes:
        for fid, _, cd in self.filters:
            if fid == _SHUFFLE:
                buf = _shuffle(buf, cd[0] if cd else itemsize)
            elif fid == _DEFLATE:
                buf = zlib.compress(buf, cd[0] if cd else 6)
            else:
                buf = buf + _le(_fletcher32(buf), 4)
        return buf


# ---------------------------------------------------------------------------
# The object tree
# ---------------------------------------------------------------------------

class _Attr:
    """One attribute: its type, shape and raw bytes, or a value to write."""

    __slots__ = ("type", "shape", "raw", "_value", "file")

    def __init__(self, t: _Type, shape, raw: Optional[bytes], value=None, file=None):
        # `file`: the File whose global heap and addresses `raw` refers to
        self.type, self.shape, self.raw, self._value, self.file = t, shape, raw, value, file

    def array(self) -> Optional[np.ndarray]:
        """Every element, as h5py returns them (objects for refs / vlen)."""
        if self._value is None and self.shape is not None:
            n = int(np.prod(self.shape, dtype=np.int64))
            arr = np.frombuffer(self.raw, self.type.raw, n).reshape(self.shape)
            self._value = _to_user(arr, self.type, self.file._src)
        return self._value

    def value(self):
        """The attribute as h5py returns it (numpy scalar for a scalar
        dataspace, ndarray otherwise, str for variable-length strings)."""
        v = self.array()
        if isinstance(v, np.ndarray) and v.shape == ():
            return v[()]
        return v


def _to_user(arr: np.ndarray, t: _Type, src: Optional[_Source]):
    """Raw on-disk values -> what h5py returns (objects for refs/vlen)."""
    if not t.has_refs:
        arr = t.from_field(arr)
        return arr.astype(t.raw.newbyteorder("="), copy=True) if t.raw.byteorder == ">" else arr.copy()
    if t.cls == 7:
        out = np.empty(arr.shape, object)
        for i, a in np.ndenumerate(arr):
            out[i] = Reference(int(a))
        return out
    if t.cls == 9:
        out = np.empty(arr.shape, object)
        for i, slot in np.ndenumerate(arr):
            sb = bytes(slot)
            n, gaddr, gidx = struct.unpack("<IQI", sb)
            data = src.gheap_object(gaddr, gidx) if n else b""
            if t.is_str:
                out[i] = data[:n].split(b"\0", 1)[0].decode("utf-8", "replace")
            else:
                base = np.frombuffer(data, t.base.raw, n)
                out[i] = _to_user(base, t.base, src)
        return out
    if t.cls == 6:
        out = np.empty(arr.shape, t.numpy_dtype())
        for name, _, mt in t.members:
            out[name] = _to_user(np.ascontiguousarray(arr[name]), mt, src)
        return out
    raise H5FormatError("datatype", 0, f"class {t.cls} with references inside")


def _to_raw(value, t: _Type, refaddr: Callable[[Reference], int],
            gheap: Callable[[bytes], Tuple[int, int]]) -> np.ndarray:
    """User values (with References) -> raw on-disk array of `t.raw`."""
    value = np.asarray(value, dtype=object if t.cls in (7, 9) else None)
    if t.cls == 7:
        return np.vectorize(lambda r: refaddr(r), otypes=[np.uint64])(value).astype("<u8") \
            if value.size else np.zeros(value.shape, "<u8")
    if t.cls == 9:
        out = np.zeros(value.shape, "V16")
        for i, item in np.ndenumerate(value):
            if t.is_str:
                data = item.encode("utf-8") if isinstance(item, str) else bytes(item)
                n = len(data)
            else:
                base = _to_raw(np.asarray(item, dtype=object if t.base.cls in (7, 9) else None),
                               t.base, refaddr, gheap)
                data, n = base.tobytes(), base.size
            gaddr, gidx = gheap(data) if n else (0, 0)
            out[i] = np.frombuffer(struct.pack("<IQI", n, gaddr, gidx), "V16")[0]
        return out
    if t.cls == 6:
        out = np.zeros(value.shape, t.raw)
        for name, _, mt in t.members:
            out[name] = _to_raw(value[name], mt, refaddr, gheap)
        return out
    return value.astype(t.raw)


class AttributeManager:
    """The attributes of one object, in the order h5py iterates them."""

    def __init__(self, node: "_Node"):
        self._node = node

    @property
    def _d(self) -> Dict[str, _Attr]:
        return self._node._attrs()

    def __contains__(self, name: str) -> bool:
        return name in self._d

    def __getitem__(self, name: str):
        if name not in self._d:
            raise KeyError(f"attribute {name!r} not found")
        return self._d[name].value()

    def get(self, name: str, default=None):
        return self[name] if name in self._d else default

    def keys(self):
        return list(self._d)

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._d))

    def items(self):
        return [(k, self[k]) for k in list(self._d)]

    def __setitem__(self, name: str, value) -> None:
        self._node.file._check_writable()
        self._d[name] = _new_attr(value, self._node.file)

    def __delitem__(self, name: str) -> None:
        self._node.file._check_writable()
        del self._d[name]


def _new_attr(value, file: "File") -> _Attr:
    """An attribute from a value, typed as h5py types it."""
    if isinstance(value, bool) or isinstance(value, np.bool_):
        raise TypeError("boolean attributes are not written by this codec")
    if isinstance(value, str):
        value = np.bytes_(value.encode("utf-8"))
    elif isinstance(value, bytes):
        value = np.bytes_(value)
    elif isinstance(value, int):
        value = np.int64(value)
    elif isinstance(value, float):
        value = np.float64(value)
    arr = np.asarray(value)
    if arr.dtype.kind == "U":
        raise TypeError("unicode array attributes are not written by this codec")
    t = _type_for_dtype(arr.dtype)
    if arr.dtype.kind == "S":
        arr = arr.astype(t.raw)
    raw = np.ascontiguousarray(arr, dtype=t.raw)
    return _Attr(t, tuple(arr.shape), raw.tobytes(), raw.copy(), file)


class _Node:
    """An object of the file: its header address (when read) and attrs."""

    def __init__(self, file: "File", name: str, addr: Optional[int]):
        self.file, self.name, self._addr = file, name, addr
        self._attr_dict: Optional[Dict[str, _Attr]] = None
        self._msgs: Optional[List[_Msg]] = None

    def _messages(self) -> List[_Msg]:
        if self._msgs is None:
            self._msgs = [] if self._addr is None else self.file._src.messages(self._addr)
        return self._msgs

    @property
    def attrs(self) -> AttributeManager:
        return AttributeManager(self)

    def _attrs(self) -> Dict[str, _Attr]:
        if self._attr_dict is None:
            self._attr_dict = self._read_attrs()
        return self._attr_dict

    def _read_attrs(self) -> Dict[str, _Attr]:
        src = self.file._src
        found = []  # (creation order or None, position, name, _Attr)
        for i, m in enumerate(self._messages()):
            if m.type == _ATTRIBUTE:
                name, t, shape, raw = _parse_attribute(m.data, m.addr, self.file)
                found.append((m.corder, i, name, _Attr(t, shape, raw, file=self.file)))
            elif m.type == _ATTRINFO:
                b = m.data
                flags = b[1]
                p = 2 + (2 if flags & 1 else 0)
                heap_addr, name_bt = _u(b, p, 8), _u(b, p + 8, 8)
                if heap_addr == UNDEF:
                    continue
                heap = src.fheap(heap_addr)
                for j, rec in enumerate(_btree_v2_records(src, name_bt)):
                    # record: heap ID, message flags, creation order, hash
                    data = (src.table_message(_ATTRIBUTE, rec[:8], heap_addr)
                            if rec[8] & _MSG_SHARED else heap.get(rec[:8]))
                    name, t, shape, raw = _parse_attribute(data, heap_addr, self.file)
                    corder = _u(rec, 9, 4) if flags & 1 else None
                    found.append((corder, len(self._messages()) + j, name,
                                  _Attr(t, shape, raw, file=self.file)))
        # h5py's order: creation order where it is tracked, else by name
        if found and all(f[0] is not None for f in found):
            found.sort(key=lambda f: f[0])
        else:
            found.sort(key=lambda f: f[2].encode("utf-8"))
        return {name: a for _, _, name, a in found}

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


class Group(_Node):
    """A group: its links in h5py's iteration order. A link is to an
    object of this file, or a SoftLink or ExternalLink followed on lookup."""

    def __init__(self, file: "File", name: str, addr: Optional[int]):
        super().__init__(file, name, addr)
        self._link_dict: Optional[Dict[str, object]] = None if addr is not None else {}

    def _links(self) -> Dict[str, object]:
        """name -> object, SoftLink or ExternalLink (links not followed)."""
        if self._link_dict is None:
            self._link_dict = {}
            for lname, target in self._read_links():
                if isinstance(target, int):
                    target = self.file._node_at(target, self._child_path(lname))
                self._link_dict[lname] = target
        return self._link_dict

    def _child_path(self, name: str) -> str:
        return f"/{name}" if self.name == "/" else f"{self.name}/{name}"

    def _read_links(self) -> List[Tuple[str, object]]:
        src = self.file._src
        found = []  # (creation order, name, target)
        for m in self._messages():
            if m.type == _STAB:
                btree, heap = struct.unpack_from("<QQ", m.data)
                found += [(None, n, a) for n, a in _symbol_table(src, btree, heap)]
            elif m.type == _LINK:
                name, target, corder = _parse_link(m.data)
                found.append((corder, name, target))
            elif m.type == _LINKINFO:
                b = m.data
                flags = b[1]
                p = 2 + (8 if flags & 1 else 0)
                heap_addr, name_bt = _u(b, p, 8), _u(b, p + 8, 8)
                if heap_addr == UNDEF:
                    continue
                heap = src.fheap(heap_addr)
                for rec in _btree_v2_records(src, name_bt):
                    name, target, corder = _parse_link(heap.get(rec[4:4 + heap.id_len]))
                    found.append((corder, name, target))
        if found and all(f[0] is not None for f in found):
            found.sort(key=lambda f: f[0])
        else:
            found.sort(key=lambda f: f[1].encode("utf-8"))
        return [(n, a) for _, n, a in found]

    def _follow(self, name: str, depth: int = 0):
        """The object `name` links to, soft and external links followed
        as HDF5 follows them; KeyError for a missing or dangling link."""
        target = self._links()[name]
        if isinstance(target, _Node):
            return target
        if depth >= _MAX_LINK_DEPTH:
            raise KeyError(f"link {self._child_path(name)!r}: more than "
                           f"{_MAX_LINK_DEPTH} soft or external links in a row")
        try:
            if isinstance(target, SoftLink):
                base = self.file if target.path.startswith("/") else self
                return base._walk(target.path, depth + 1)
            return self.file._external(target)._walk(target.path, depth + 1)
        except KeyError as e:
            raise KeyError(f"link {self._child_path(name)!r} in {self.file.path} "
                           f"({target!r}) does not resolve: {e.args[0] if e.args else e}") from None

    def _walk(self, path: str, depth: int = 0):
        node: _Node = self.file if path.startswith("/") else self
        for part in [p for p in path.split("/") if p and p != "."]:
            if not isinstance(node, Group) or part not in node._links():
                raise KeyError(f"{path!r} not found in {self.file.path}:{self.name}")
            node = node._follow(part, depth)
        return node

    # -- h5py surface ---------------------------------------------------------
    def keys(self):
        return list(self._links())

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._links()))

    def get(self, name: str, default=None, getlink: bool = False):
        """h5py's `get`: the object (default where the name or its link's
        target is missing), or with getlink=True the link itself (a
        SoftLink, an ExternalLink, or the object of a hard link)."""
        if getlink:
            return self._links().get(name, default)
        try:
            return self[name]
        except KeyError:
            return default

    def items(self):
        """(name, object) in link order; None for a dangling link, as h5py."""
        return [(k, self.get(k)) for k in list(self._links())]

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __getitem__(self, path: str):
        return self._walk(path)

    def create_group(self, name: str) -> "Group":
        self.file._check_writable()
        parent, leaf = self._parent_for(name)
        if leaf in parent._links():
            raise ValueError(f"{name!r} already exists in {self.name!r}")
        g = Group(self.file, parent._child_path(leaf), None)
        g._attr_dict = {}
        parent._links()[leaf] = g
        return g

    def create_dataset(self, name: str, shape=None, dtype=None, data=None,
                       compression=None, compression_opts=None,
                       shuffle: bool = False) -> "Dataset":
        """A new dataset, as h5py lays it out: contiguous, or with gzip and
        shuffle chunked in h5py's guessed chunk shape; storage never
        written (no data) is left unallocated."""
        self.file._check_writable()
        parent, leaf = self._parent_for(name)
        if leaf in parent._links():
            raise ValueError(f"{name!r} already exists in {self.name!r}")
        if data is not None:
            data = np.asarray(data, dtype=dtype)
            shape, dt = data.shape, data.dtype
        elif shape is None:
            raise TypeError("create_dataset needs data or shape")
        else:
            shape = (shape,) if isinstance(shape, int) else tuple(shape)
            dt = np.dtype(dtype if dtype is not None else "f4")
        t = _type_for_dtype(dt)
        pipeline = chunks = None
        if compression is not None or shuffle:
            if compression != "gzip" or not shuffle:
                raise ValueError("the codec writes gzip with shuffle, or no filter")
            pipeline = _Pipeline.gzip_shuffle(
                4 if compression_opts is None else int(compression_opts), t.size)
            chunks = guess_chunk(shape, t.size)
        ds = Dataset(self.file, parent._child_path(leaf), None)
        ds._attr_dict = {}
        ds._init_new(tuple(shape), t, chunks, pipeline,
                     None if data is None else np.ascontiguousarray(data, dtype=t.raw))
        parent._links()[leaf] = ds
        return ds

    def _parent_for(self, name: str) -> Tuple["Group", str]:
        parts = [p for p in name.split("/") if p]
        if not parts:
            raise ValueError("empty name")
        node: Group = self.file if name.startswith("/") else self
        for part in parts[:-1]:
            node = node[part] if part in node else node.create_group(part)
        return node, parts[-1]

    def visititems(self, func):
        """Call func(path relative to this group, object) on every object
        below it, as h5py (H5Ovisit) does: through hard links only, each
        object once; stop when func returns non-None."""
        seen = {id(self)}

        def walk(grp: Group, prefix: str):
            for k, v in grp._links().items():
                if not isinstance(v, _Node) or id(v) in seen:
                    continue
                seen.add(id(v))
                path = f"{prefix}{k}"
                r = func(path, v)
                if r is not None:
                    return r
                if isinstance(v, Group):
                    r = walk(v, path + "/")
                    if r is not None:
                        return r
            return None
        return walk(self, "")


def _symbol_table(src: _Source, btree: int, heap: int) -> List[Tuple[str, object]]:
    """(name, object header address or SoftLink) of every entry of a
    symbol table (an entry of cache type 2 is a soft link, its value in
    the local heap at the offset its scratch pad holds)."""
    h = src.read(heap, 32, "local heap")
    if h[:4] != b"HEAP":
        raise H5FormatError("local heap", heap, "no HEAP signature")
    dsize, daddr = _u(h, 8, 8), _u(h, 24, 8)
    names = src.read(daddr, dsize, "local heap data")
    out = []

    def leaf(_lk, snod, _rk):
        b = src.read(snod, 8, "symbol table node")
        if b[:4] != b"SNOD":
            raise H5FormatError("symbol table node", snod, "no SNOD signature")
        n = _u(b, 6, 2)
        ents = src.read(snod + 8, 40 * n, "symbol table node")
        for i in range(n):
            noff, oaddr, cache = struct.unpack_from("<QQI", ents, 40 * i)
            name = names[noff:names.index(b"\0", noff)].decode("utf-8")
            if cache == 2:
                voff = _u(ents, 40 * i + 24, 4)
                out.append((name, SoftLink(names[voff:names.index(b"\0", voff)].decode("utf-8"))))
            else:
                out.append((name, oaddr))

    src.btree_v1(btree, 0, 8, leaf)
    return out


class Dataset(_Node):
    """A dataset; reading slices decompresses only the chunks touched."""

    def __init__(self, file: "File", name: str, addr: Optional[int]):
        super().__init__(file, name, addr)
        self._loaded = False
        self._data: Optional[np.ndarray] = None   # new data, to be written
        self._chunk_index: Optional[Dict[tuple, Tuple[int, int, int]]] = None
        self._raw_msgs: List[Tuple[int, bytes]] = []  # fill value as read
        self._space_raw: Optional[bytes] = None
        self._maxshape: Optional[tuple] = None
        self._v4: Optional[tuple] = None       # layout v4: (index, flags, params, address)
        self._rsrc: Optional[_Source] = None   # where the stored data lives

    # -- metadata --------------------------------------------------------------
    def _init_new(self, shape, t, chunks, pipeline, data) -> None:
        self._loaded = True
        self._shape, self._type, self._chunks, self._pipeline = shape, t, chunks, pipeline
        self._layout = "chunked" if chunks else "contiguous"
        self._contig = (UNDEF, 0)
        self._fill = None
        self._data = data

    def _load(self) -> None:
        if self._loaded:
            return
        self._loaded = True
        self._rsrc = self.file._src
        self._shape = self._type = self._chunks = self._pipeline = None
        self._fill = None
        self._layout = None
        for m in self._messages():
            b = m.data
            if m.flags & _MSG_SHARED and m.type != _DATATYPE:
                raise H5FormatError("object header message", m.addr,
                                    f"message of type {m.type:#x} in {self.name!r} shared "
                                    f"in another object header (version {b[0]} type {b[1]})")
            if m.type == _DATASPACE:
                self._shape = _decode_space(b, 0) or ()
                self._maxshape = _decode_maxshape(b, 0)
                self._space_raw = bytes(b)
            elif m.type == _DATATYPE:
                if m.flags & _MSG_SHARED:
                    self._type = self.file._committed_type(
                        _shared_address(b, m.addr, "datatype"))
                else:
                    self._type, _ = _decode_type(b, 0)
            elif m.type == _PIPELINE:
                self._pipeline = _Pipeline.decode(b, m.addr)
            elif m.type in (_FILL, _FILL_OLD):
                self._fill = self._parse_fill(m)
                self._raw_msgs.append((m.type, bytes(b)))
            elif m.type == _LAYOUT:
                self._parse_layout(b, m.addr)
            elif m.type in (_ATTRIBUTE, _ATTRINFO) or m.type in _IGNORED:
                continue
            else:
                raise H5FormatError("object header message", m.addr,
                                    f"type {m.type:#x} in dataset {self.name!r}")
        if self._shape is None or self._type is None or self._layout is None:
            raise H5FormatError("dataset", self._addr or 0,
                                f"{self.name!r} lacks a dataspace, datatype or layout")

    @staticmethod
    def _parse_fill(m: _Msg) -> Optional[bytes]:
        b = m.data
        if m.type == _FILL_OLD:
            n = _u(b, 0, 4)
            return bytes(b[4:4 + n]) if n else None
        ver = b[0]
        if ver in (1, 2):
            if ver == 2 and not b[3]:
                return None
            n = _u(b, 4, 4)
            return bytes(b[8:8 + n]) if n else None
        if ver == 3:
            if not b[1] & 0x20:
                return None
            n = _u(b, 2, 4)
            return bytes(b[6:6 + n]) if n else None
        raise H5FormatError("fill value message", m.addr, f"version {ver}")

    def _parse_layout(self, b, where: int) -> None:
        ver = b[0]
        if ver not in (3, 4):
            raise H5FormatError("data layout message", where, f"version {ver}")
        cls = b[1]
        if cls == 0:
            n = _u(b, 2, 2)
            self._layout, self._compact = "compact", bytes(b[4:4 + n])
        elif cls == 1:
            self._layout, self._contig = "contiguous", struct.unpack_from("<QQ", b, 2)
        elif cls == 2 and ver == 3:
            nd = b[2]
            self._layout = "chunked"
            self._btree = _u(b, 3, 8)
            dims = struct.unpack_from(f"<{nd}I", b, 11)
            self._chunks = tuple(dims[:-1])
        elif cls == 2:
            # version 4: flags, rank + 1 dimensions of `enc` bytes (the last
            # the element size), the index type, its parameters, its address
            flags, nd, enc = b[2], b[3], b[4]
            dims = [_u(b, 5 + i * enc, enc) for i in range(nd)]
            p = 5 + nd * enc
            kind = b[p]
            p += 1
            params: tuple = ()
            if kind == 1 and flags & 0x2:     # single chunk, filtered
                params = (_u(b, p, 8), _u(b, p + 8, 4))
                p += 12
            elif kind == 3:                   # fixed array: page bits
                p += 1
            elif kind == 4:                   # extensible array: 5 parameters
                p += 5
            elif kind == 5:                   # v2 B-tree: node size, split, merge
                p += 6
            elif kind not in (1, 2):
                raise H5FormatError("data layout message", where, f"chunk index type {kind}")
            self._layout = "chunked"
            self._chunks = tuple(dims[:-1])
            self._v4 = (kind, flags, params, _u(b, p, 8))
        else:
            raise H5FormatError("data layout message", where,
                                f"class {cls} (virtual datasets are not supported)")

    @property
    def shape(self) -> tuple:
        self._load()
        return self._shape

    @property
    def dtype(self) -> np.dtype:
        self._load()
        return self._type.numpy_dtype().newbyteorder("=") if self._type.cls in (0, 1) \
            else self._type.numpy_dtype()

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    @property
    def maxshape(self) -> tuple:
        """h5py's maxshape: None for an unlimited dimension."""
        self._load()
        return self._shape if self._maxshape is None else self._maxshape

    @property
    def chunks(self) -> Optional[tuple]:
        self._load()
        return self._chunks

    # -- reading --------------------------------------------------------------
    def __array__(self, dtype=None, copy=None):
        arr = self._read_box(tuple(slice(0, n) for n in self.shape))
        return arr if dtype is None else arr.astype(dtype)

    def __getitem__(self, key):
        shape = self.shape
        if not isinstance(key, tuple):
            key = (key,)
        if any(k is Ellipsis for k in key):
            i = next(j for j, k in enumerate(key) if k is Ellipsis)
            key = key[:i] + (slice(None),) * (len(shape) - len(key) + 1) + key[i + 1:]
        key = key + (slice(None),) * (len(shape) - len(key))
        if len(key) != len(shape) or not all(isinstance(k, (slice, int, np.integer)) for k in key):
            return np.asarray(self)[key if len(key) else ()]
        box, sub = [], []
        for k, n in zip(key, shape):
            if isinstance(k, slice):
                lo, hi, step = k.indices(n)
                if step > 0 and hi > lo:
                    box.append(slice(lo, hi))
                    sub.append(slice(0, hi - lo, step))
                else:  # empty or reversed: read the axis, let numpy index
                    box.append(slice(0, n))
                    sub.append(k)
            else:
                i = int(k) + (n if k < 0 else 0)
                if not 0 <= i < n:
                    raise IndexError(f"index {k} out of range for axis of size {n}")
                box.append(slice(i, i + 1))
                sub.append(0)
        arr = self._read_box(tuple(box))
        out = arr[tuple(sub)]
        return out.copy() if isinstance(out, np.ndarray) else out

    def _fill_array(self, shape) -> np.ndarray:
        dt = self._type.raw
        if self._fill is not None and len(self._fill) == dt.itemsize:
            return np.full(shape, np.frombuffer(self._fill, dt)[0], dt)
        return np.zeros(shape, dt)

    def _read_box(self, box: Tuple[slice, ...]) -> np.ndarray:
        """The array of `self[box]` (each a slice with step 1)."""
        self._load()
        t = self._type
        if self._data is not None:
            return np.array(self._data[box], dtype=self.dtype)
        if t.has_refs:
            raise H5FormatError("dataset", self._addr or 0,
                                f"{self.name!r}: datasets of references or vlen are not read")
        out_shape = tuple(s.stop - s.start for s in box)
        n = int(np.prod(self._shape, dtype=np.int64))
        src = self._rsrc
        fresh = True   # an array of its own (a view of a buffer is copied)
        if self._layout == "compact":
            arr, fresh = np.frombuffer(self._compact, t.raw, n).reshape(self._shape)[box], False
        elif self._layout == "contiguous":
            addr, size = self._contig
            if addr == UNDEF:
                arr = self._fill_array(out_shape)
            else:
                arr, fresh = self._read_contiguous(src, addr, box), False
        else:
            arr = self._read_chunked(src, box, out_shape)
        arr = t.from_field(arr)
        return np.asarray(arr, dtype=self.dtype) if fresh else np.array(arr, dtype=self.dtype)

    def _read_contiguous(self, src: _Source, addr: int, box) -> np.ndarray:
        t, shape = self._type, self._shape
        if not shape:
            return np.frombuffer(src.read(addr, t.size), t.raw, 1).reshape(())
        row = int(np.prod(shape[1:], dtype=np.int64)) * t.size
        lo, hi = box[0].start, box[0].stop
        buf = src.read(addr + lo * row, (hi - lo) * row, "contiguous data")
        arr = np.frombuffer(buf, t.raw).reshape((hi - lo,) + shape[1:])
        return arr[(slice(None),) + box[1:]]

    def _index(self) -> Dict[tuple, Tuple[int, int, int]]:
        """{chunk position: (address, stored bytes, filter mask)} of every
        allocated chunk."""
        if self._chunk_index is None and self._v4 is not None:
            self._chunk_index = _v4_index(self)
        if self._chunk_index is None:
            rank = len(self._shape)
            key_size = 8 + 8 * (rank + 1)
            idx = {}
            chunks = self._chunks

            def leaf(k, addr, _rk):
                nbytes, mask = struct.unpack_from("<II", k)
                offs = struct.unpack_from(f"<{rank}Q", k, 8)
                idx[tuple(o // c for o, c in zip(offs, chunks))] = (addr, nbytes, mask)

            if self._btree != UNDEF:
                self._rsrc.btree_v1(self._btree, 1, key_size, leaf)
            self._chunk_index = idx
        return self._chunk_index

    def _read_chunked(self, src: _Source, box, out_shape) -> np.ndarray:
        t, chunks = self._type, self._chunks
        out = self._fill_array(out_shape)
        index = self._index()
        ranges = [range(s.start // c, (s.stop - 1) // c + 1) if s.stop > s.start else range(0)
                  for s, c in zip(box, chunks)]
        csize = int(np.prod(chunks, dtype=np.int64)) * t.size
        wanted = [pos for pos in (tuple(r[i] for r, i in zip(ranges, cidx))
                                  for cidx in np.ndindex(*[len(r) for r in ranges]))
                  if pos in index]

        def decode(pos):
            addr, nbytes, mask = index[pos]
            buf = src.read(addr, nbytes, "chunk")
            if self._pipeline is not None:
                buf = self._pipeline.decode_chunk(buf, mask, t.size, addr, csize)
            if len(buf) != csize:
                raise H5FormatError("chunk", addr, f"{len(buf)} bytes, expected {csize}")
            return buf

        for pos, buf in zip(wanted, map(decode, wanted)):
            chunk = np.frombuffer(buf, t.raw).reshape(chunks)
            src_sl, dst_sl = [], []
            for p, c, s in zip(pos, chunks, box):
                lo, hi = max(p * c, s.start), min((p + 1) * c, s.stop)
                src_sl.append(slice(lo - p * c, hi - p * c))
                dst_sl.append(slice(lo - s.start, hi - s.start))
            out[tuple(dst_sl)] = chunk[tuple(src_sl)]
        return out

    # -- dimension scales (netCDF dimensions) ---------------------------------
    def make_scale(self, name: str = "") -> None:
        """Flag this dataset as a dimension scale, as H5DSset_scale does."""
        self.file._check_writable()
        d = self._attrs()
        d["CLASS"] = _Attr(_string_type(16, True), (), b"DIMENSION_SCALE\0", file=self.file)
        if name:
            d["NAME"] = _Attr(_string_type(len(name) + 1, True), (), name.encode() + b"\0",
                              file=self.file)

    def attach_scale(self, axis: int, scale: "Dataset") -> None:
        """Attach `scale` to `axis`, as H5DSattach_scale does: the axis's
        entry of DIMENSION_LIST names the scale and the scale's
        REFERENCE_LIST names this dataset and axis."""
        self.file._check_writable()
        rank = len(self.shape)
        d = self._attrs()
        dl = d.get("DIMENSION_LIST")
        lists = [[] for _ in range(rank)]
        if dl is not None:
            for i, refs in enumerate(dl.array()):
                lists[i] = [_resolve(r, dl.file) for r in refs]
        if not any(r.target is scale for r in lists[axis]):
            lists[axis].append(Reference(target=scale))
        val = np.empty(rank, object)
        for i, refs in enumerate(lists):
            val[i] = np.array(refs, dtype=object)
        d["DIMENSION_LIST"] = _Attr(_DIMLIST_TYPE, (rank,), None, val, self.file)
        sd = scale._attrs()
        rows = []
        rl = sd.get("REFERENCE_LIST")
        if rl is not None:
            rows = [(_resolve(r["dataset"], rl.file), int(r["dimension"]))
                    for r in np.atleast_1d(rl.array())]
        rows.append((Reference(target=self), axis))
        val = np.empty(len(rows), _REFLIST_TYPE.numpy_dtype())
        for i, row in enumerate(rows):
            val[i] = row
        sd["REFERENCE_LIST"] = _Attr(_REFLIST_TYPE, (len(rows),), None, val, self.file)


class Datatype(_Node):
    """A committed (named) datatype: an object header holding a datatype
    message and no dataspace or layout."""

    def __init__(self, file: "File", name: Optional[str], addr: Optional[int]):
        super().__init__(file, name, addr)
        self._type: Optional[_Type] = None

    def _load_type(self) -> _Type:
        if self._type is None:
            m = next((m for m in self._messages() if m.type == _DATATYPE), None)
            if m is None:
                raise H5FormatError("object header", self._addr or 0,
                                    f"{self.name!r} holds no datatype message")
            self._type, _ = _decode_type(m.data, 0)
            self._type.committed = self
        return self._type

    @property
    def dtype(self) -> np.dtype:
        t = self._load_type()
        return t.numpy_dtype().newbyteorder("=") if t.cls in (0, 1) else t.numpy_dtype()


def _resolve(ref: Reference, file: "File") -> Reference:
    """`ref` with its target object looked up in `file` (a null reference
    where there is no object at its address)."""
    if ref.target is not None:
        return ref
    try:
        return Reference(target=file._deref(ref))
    except KeyError:
        return Reference()


# ---------------------------------------------------------------------------
# Layout v4 chunk indexes (HDF5 1.10+: H5Dsingle, H5Dnone, H5Dfarray,
# H5Dearray, H5Dbt2). Each gives {chunk position: (address, stored bytes,
# filter mask)}, as the v1 B-tree of layout v3 does.
# ---------------------------------------------------------------------------

_INDEX_NAMES = {1: "single chunk", 2: "implicit", 3: "fixed array",
                4: "extensible array", 5: "version 2 B-tree"}


def _chunk_size_len(chunk_bytes: int) -> int:
    """Bytes of a filtered chunk's size in an index entry (H5D_*_idx)."""
    return min(8, 1 + ((chunk_bytes.bit_length() - 1) + 8) // 8)


def _grid(shape, chunks) -> tuple:
    return tuple(-(-n // c) for n, c in zip(shape, chunks))


def _v4_index(ds: "Dataset") -> Dict[tuple, Tuple[int, int, int]]:
    kind, flags, params, addr = ds._v4
    src, chunks, shape = ds._rsrc, ds._chunks, ds._shape
    csize = int(np.prod(chunks, dtype=np.int64)) * ds._type.size
    maxshape = ds._maxshape or shape
    grid = _grid(shape, chunks)
    # the index's linear order runs over the grid of the maximum dimensions
    max_grid = [None if m is None else -(-m // c) for m, c in zip(maxshape, chunks)]
    filtered = ds._pipeline is not None
    where = f"{_INDEX_NAMES[kind]} chunk index of {ds.name!r}"
    entries: Dict[tuple, Tuple[int, int, int]] = {}
    if addr == UNDEF:
        return entries
    if kind == 1:
        nbytes, mask = params if params else (csize, 0)
        entries[(0,) * len(shape)] = (addr, nbytes, mask)
    elif kind == 2:
        for pos in np.ndindex(*grid):
            entries[pos] = (addr + _linear(pos, max_grid) * csize, csize, 0)
    elif kind in (3, 4):
        slen = _chunk_size_len(csize)
        if kind == 3:
            raw = _fixed_array(src, addr, where)
            order = list(range(len(shape)))
        else:
            raw = _extensible_array(src, addr, where)
            unlim = next((d for d, m in enumerate(max_grid) if m is None), 0)
            order = [unlim] + [d for d in range(len(shape)) if d != unlim]
        sizes = [max_grid[d] for d in order]
        for i, elem in enumerate(raw):
            if elem is None or _u(elem, 0, 8) == UNDEF:
                continue
            spos = _unlinear(i, sizes)
            pos = [0] * len(shape)
            for d, v in zip(order, spos):
                pos[d] = v
            e = (_u(elem, 0, 8), _u(elem, 8, slen), _u(elem, 8 + slen, 4)) if filtered \
                else (_u(elem, 0, 8), csize, 0)
            entries[tuple(pos)] = e
    else:
        slen = _chunk_size_len(csize)
        rank = len(shape)
        for rec in _btree_v2_records(src, addr):
            caddr = _u(rec, 0, 8)
            if filtered:   # type 11: address, size, mask, scaled offsets
                nbytes, mask, p = _u(rec, 8, slen), _u(rec, 8 + slen, 4), 12 + slen
            else:          # type 10: address, scaled offsets
                nbytes, mask, p = csize, 0, 8
            entries[tuple(_u(rec, p + 8 * d, 8) for d in range(rank))] = (caddr, nbytes, mask)
    inside = {pos: e for pos, e in entries.items() if all(p < g for p, g in zip(pos, grid))}
    if flags & 0x1 and filtered:
        # DONT_FILTER_PARTIAL_BOUND_CHUNKS: edge chunks are stored unfiltered;
        # a mask of every filter says so to the reader (and to layout v3)
        every = (1 << len(ds._pipeline.filters)) - 1
        for pos, (a, n, m) in inside.items():
            if any((p + 1) * c > d for p, c, d in zip(pos, chunks, shape)):
                inside[pos] = (a, n, every)
    return inside


def _linear(pos, sizes) -> int:
    i = 0
    for p, n in zip(pos, sizes):
        i = i * (n or 1) + p
    return i


def _unlinear(i: int, sizes) -> tuple:
    """Row-major position of linear index i (the first size may be None:
    the unlimited, slowest dimension)."""
    out = []
    for n in reversed(sizes[1:]):
        i, r = divmod(i, n)
        out.append(r)
    out.append(i)
    return tuple(reversed(out))


def _bit_set(bitmap: bytes, i: int) -> bool:
    return bool(bitmap[i // 8] & (0x80 >> (i % 8)))


def _fixed_array(src: "_Source", addr: int, where: str) -> list:
    """Every element's bytes of a fixed array (None where a page was
    never written)."""
    h = src.read(addr, 28, "fixed array header")
    if h[:4] != b"FAHD":
        raise H5FormatError("fixed array header", addr, f"no FAHD signature ({where})")
    esize, page_bits, n, dblk = h[6], h[7], _u(h, 8, 8), _u(h, 16, 8)
    if dblk == UNDEF:
        return []
    head = src.read(dblk, 14, "fixed array data block")
    if head[:4] != b"FADB":
        raise H5FormatError("fixed array data block", dblk, f"no FADB signature ({where})")
    page = 1 << page_bits
    if n <= page:
        buf = src.read(dblk + 14, n * esize, "fixed array data block")
        return [buf[i * esize:(i + 1) * esize] for i in range(n)]
    npages = -(-n // page)
    bitmap = src.read(dblk + 14, (npages + 7) // 8, "fixed array page bitmap")
    base = dblk + 14 + len(bitmap) + 4
    out: list = []
    for pg in range(npages):
        cnt = min(page, n - pg * page)
        if not _bit_set(bitmap, pg):
            out += [None] * cnt
            continue
        buf = src.read(base + pg * (page * esize + 4), cnt * esize, "fixed array page")
        out += [buf[i * esize:(i + 1) * esize] for i in range(cnt)]
    return out


def _extensible_array(src: "_Source", addr: int, where: str) -> list:
    """Every element's bytes of an extensible array up to its highest
    index set: the index block's own elements, then the data blocks of
    its super blocks (the first ones' addresses in the index block, the
    rest through super blocks), paged past 2^page_bits elements
    (H5EA__hdr_init's geometry)."""
    h = src.read(addr, 72, "extensible array header")
    if h[:4] != b"EAHD":
        raise H5FormatError("extensible array header", addr, f"no EAHD signature ({where})")
    esize, max_bits, ib_elmts, min_elmts, min_ptrs, page_bits = h[6:12]
    remaining, iblock = _u(h, 44, 8), _u(h, 60, 8)
    if iblock == UNDEF:
        return []
    nsblks = 1 + max_bits - (min_elmts.bit_length() - 1)
    ib_nsblks = 2 * (min_ptrs.bit_length() - 1)
    ndblk_addrs, nsblk_addrs = 2 * (min_ptrs - 1), nsblks - ib_nsblks
    arr_off = (max_bits + 7) // 8
    page = 1 << page_bits
    ib = src.read(iblock, 14 + ib_elmts * esize + 8 * (ndblk_addrs + nsblk_addrs),
                  "extensible array index block")
    if ib[:4] != b"EAIB":
        raise H5FormatError("extensible array index block", iblock, f"no EAIB signature ({where})")

    def split(buf, n):
        return [buf[i * esize:(i + 1) * esize] for i in range(n)]

    out = split(ib[14:], min(ib_elmts, remaining))
    remaining -= len(out)
    p = 14 + ib_elmts * esize
    dblk_addrs = [_u(ib, p + 8 * i, 8) for i in range(ndblk_addrs)]
    sblk_addrs = [_u(ib, p + 8 * (ndblk_addrs + i), 8) for i in range(nsblk_addrs)]

    def data_block(a: int, n: int, bitmap: Optional[bytes]) -> list:
        if a == UNDEF:
            return [None] * n
        if n <= page:
            return split(src.read(a + 14 + arr_off, n * esize, "extensible array data block"), n)
        res: list = []
        for pg in range(n // page):   # pages after the block's prefix and checksum
            if bitmap is not None and not _bit_set(bitmap, pg):
                res += [None] * page
            else:
                res += split(src.read(a + 14 + arr_off + 4 + pg * (page * esize + 4),
                                      page * esize, "extensible array data block page"), page)
        return res

    used = 0
    for u in range(nsblks):
        if remaining <= 0:
            break
        ndblks, dn = 1 << (u // 2), (1 << ((u + 1) // 2)) * min_elmts
        bitmaps: List[Optional[bytes]] = [None] * ndblks
        if u < ib_nsblks:
            addrs = dblk_addrs[used:used + ndblks]
            used += ndblks
        else:
            sa = sblk_addrs[u - ib_nsblks]
            addrs = [UNDEF] * ndblks
            if sa != UNDEF:
                bm = ((dn // page) + 7) // 8 if dn > page else 0
                sb = src.read(sa, 14 + arr_off + ndblks * (bm + 8), "extensible array super block")
                if sb[:4] != b"EASB":
                    raise H5FormatError("extensible array super block", sa,
                                        f"no EASB signature ({where})")
                q = 14 + arr_off
                if bm:
                    bitmaps = [sb[q + i * bm:q + (i + 1) * bm] for i in range(ndblks)]
                q += ndblks * bm
                addrs = [_u(sb, q + 8 * i, 8) for i in range(ndblks)]
        for a, bm_bytes in zip(addrs, bitmaps):
            if remaining <= 0:
                break
            els = data_block(a, dn, bm_bytes)[:remaining]
            out += els
            remaining -= len(els)
    return out


# ---------------------------------------------------------------------------
# The file
# ---------------------------------------------------------------------------

class File(Group):
    """An HDF5 file. Modes: "r" (read), "w" (create or truncate), "a"
    (read, then rewrite on close; "w" where there is no file). Writes
    happen once, on close, through a temporary file."""

    def __init__(self, path, mode: str = "r"):
        path = os.fspath(path)
        if mode not in ("r", "w", "a"):
            raise ValueError(f"mode {mode!r}: the codec opens r, w or a")
        if mode == "a" and not os.path.exists(path):
            mode = "w"
        self.path, self.mode = path, mode
        self._writable = mode != "r"
        self._src: Optional[_Source] = None
        self._by_addr: Dict[int, _Node] = {}
        self._copies: Dict[int, _Node] = {}   # id(copied object) -> its copy here
        self._externals: Dict[str, "File"] = {}   # files reached by external links
        self._closed = False
        if mode in ("r", "a"):
            self._src = _Source(path)
            super().__init__(self, "/", self._src.root_addr)
            self._by_addr[self._src.root_addr] = self
            if mode == "a":
                _load_all(self)
        else:
            super().__init__(self, "/", None)
            self._attr_dict = {}

    def _check_writable(self) -> None:
        if not self._writable or self._closed:
            raise ValueError(f"{self.path} is not open for writing")

    def _node_at(self, addr: int, path: Optional[str]) -> _Node:
        node = self._by_addr.get(addr)
        if node is None:
            msgs = self._src.messages(addr)
            kinds = {m.type for m in msgs}
            if kinds & {_STAB, _LINK, _LINKINFO, _GROUPINFO}:
                node = Group(self, path, addr)
            elif _LAYOUT in kinds:
                node = Dataset(self, path, addr)
            elif _DATATYPE in kinds and not kinds & {_DATASPACE, _LAYOUT}:
                node = Datatype(self, path, addr)
            else:
                raise H5FormatError("object header", addr,
                                    f"{path!r} is neither a group, a dataset nor a "
                                    "committed datatype")
            node._msgs = msgs
            self._by_addr[addr] = node
        elif node.name is None and path is not None:
            node.name = path   # reached first through a shared message
        return node

    def _committed_type(self, addr: int) -> _Type:
        """The type of the committed datatype at `addr` (a shared datatype
        message's target)."""
        node = self._node_at(addr, None)
        if not isinstance(node, Datatype):
            raise H5FormatError("shared datatype message", addr,
                                "its target is not a committed datatype")
        return node._load_type()

    def _external(self, link: "ExternalLink") -> "File":
        """The file an external link names, opened read-only as HDF5 finds
        it: the name itself if absolute, then in the directory of this
        file, then in the working directory."""
        name = link.filename
        here = os.path.dirname(os.path.abspath(self.path))
        tries = ([name] if os.path.isabs(name) else []) + [
            os.path.join(here, os.path.basename(name) if os.path.isabs(name) else name)]
        if not os.path.isabs(name):
            tries.append(os.path.abspath(name))
        for cand in tries:
            if os.path.isfile(cand):
                key = os.path.realpath(cand)
                if key == os.path.realpath(self.path):
                    return self
                if key not in self._externals:
                    self._externals[key] = File(cand, "r")
                return self._externals[key]
        raise KeyError(f"external file {name!r} linked from {self.path} not found "
                       f"(looked for {', '.join(tries)})")

    def _deref(self, ref: Reference) -> _Node:
        if ref.target is not None:
            return ref.target
        if not ref or self._src is None:
            raise KeyError("null reference")
        if ref.addr in self._by_addr:
            return self._by_addr[ref.addr]
        _load_all(self)  # reaches every linked object, registering them
        if ref.addr not in self._by_addr:
            raise KeyError(f"reference to {ref.addr:#x}: no object there")
        return self._by_addr[ref.addr]

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._closed:
            return
        try:
            if self._writable:
                _write_file(self)
        finally:
            self._closed = True
            if self._src is not None:
                self._src.close()
            for ext in self._externals.values():
                ext.close()

    def __bool__(self) -> bool:  # h5py's: an open file is true
        return not self._closed


def _load_all(grp: Group, seen: Optional[set] = None) -> None:
    """Read every object below `grp` into memory (datasets keep their raw,
    still compressed chunks on disk until written). Soft and external
    links are kept as links, not followed."""
    seen = set() if seen is None else seen
    seen.add(id(grp))
    for node in grp._links().values():
        if not isinstance(node, _Node) or id(node) in seen:
            continue
        seen.add(id(node))
        node._attrs()
        if isinstance(node, Group):
            _load_all(node, seen)
        elif isinstance(node, Dataset):
            node._load()
        else:
            node._load_type()
    grp._attrs()




def copy_tree(src: File, dst: File) -> None:
    """Copy every attribute and object of `src` into the empty `dst`. The
    chunks are copied still compressed; object references are rewritten to
    the copies when `dst` is written (h5py's `expand_refs=True`)."""
    dst._check_writable()
    _load_all(src)

    def clone(node, path: str):
        if not isinstance(node, _Node):
            return node   # a soft or external link, copied as the link
        if id(node) in dst._copies:
            return dst._copies[id(node)]   # a second hard link to one object
        if isinstance(node, Group):
            c = Group(dst, path, None)
            dst._copies[id(node)] = c
            for name, child in node._links().items():
                c._links()[name] = clone(child, c._child_path(name))
        else:
            c = (Dataset if isinstance(node, Dataset) else Datatype)(dst, path, None)
            c.__dict__.update({k: v for k, v in node.__dict__.items()
                               if k not in ("file", "name", "_addr", "_msgs", "_attr_dict")})
            dst._copies[id(node)] = c
        c._attr_dict = dict(node._attrs())
        return c

    for name, child in src._links().items():
        dst._links()[name] = clone(child, dst._child_path(name))
    dst._attrs().update(src._attrs())
    dst._copies[id(src)] = dst


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

class _Out:
    """The new file: space is handed out in address order and written with
    pwrite, so chunks go to disk as they are compressed."""

    def __init__(self, fd: int):
        self.fd, self.size = fd, 0

    def alloc(self, n: int) -> int:
        addr = self.size
        self.size += n
        return addr

    def put(self, addr: int, data: bytes) -> None:
        view = memoryview(data)
        while len(view):
            n = os.pwrite(self.fd, view, addr)
            view, addr = view[n:], addr + n

    def append(self, data: bytes) -> int:
        addr = self.alloc(len(data))
        self.put(addr, data)
        return addr


def _pad8(b: bytes) -> bytes:
    return b + b"\0" * (_align8(len(b)) - len(b))


def _msg_v1(mtype: int, data: bytes, flags: int = 0) -> bytes:
    data = _pad8(data)
    return struct.pack("<HHB3x", mtype, len(data), flags) + data


_MAX_MSG = 0xFFFF - 8   # an object header message's size field is 16 bits


def _shared_msg(addr: int) -> bytes:
    """A shared message naming a committed datatype (version 2, as HDF5
    encodes one)."""
    return struct.pack("<BBQ", 2, 2, addr)


def _attr_msg(name: str, a: _Attr, raw: bytes, shared: Optional[int] = None) -> bytes:
    """An attribute message: version 1 (name, type and space padded to 8),
    or version 2 with a shared datatype where the type is committed at the
    object header `shared` (version 1 has no flags to say so)."""
    nm = name.encode("utf-8") + b"\0"
    sb = _encode_space(a.shape)
    if shared is None:
        tb = a.type.encoded
        return (struct.pack("<BBHHH", 1, 0, len(nm), len(tb), len(sb))
                + _pad8(nm) + _pad8(tb) + _pad8(sb) + raw)
    tb = _shared_msg(shared)
    return struct.pack("<BBHHH", 2, 1, len(nm), len(tb), len(sb)) + nm + tb + sb + raw


def _header(msgs: List[Tuple[int, int, bytes]]) -> bytes:
    """A version-1 object header holding (type, flags, data) messages in
    one chunk."""
    body = b"".join(_msg_v1(t, d, fl) for t, fl, d in msgs)
    return struct.pack("<BBHII4x", 1, 0, len(msgs), 1, len(body)) + body


def _header_v2(msgs: List[Tuple[int, int, bytes]]) -> bytes:
    """A version-2 object header (`OHDR`, 4-byte chunk size, lookup3
    checksum): what an object with dense attribute storage needs, since
    HDF5 reads no attribute info message from a version-1 header."""
    body = b"".join(struct.pack("<BHB", t, len(d), fl) + d for t, fl, d in msgs)
    raw = b"OHDR" + bytes([2, 0x02]) + struct.pack("<I", len(body)) + body
    return raw + _le(_filters.lookup3(raw), 4)


def _link_msg(name: str, target, addr: int) -> bytes:
    """A link message (version 1): hard (to `addr`), soft or external."""
    nb = name.encode("utf-8")
    nsz = 0 if len(nb) < 1 << 8 else 1 if len(nb) < 1 << 16 else 2
    if isinstance(target, SoftLink):
        v = target.path.encode("utf-8")
        ltype, info = 1, struct.pack("<H", len(v)) + v
    elif isinstance(target, ExternalLink):
        v = b"\0" + target.filename.encode("utf-8") + b"\0" + target.path.encode("utf-8") + b"\0"
        ltype, info = 64, struct.pack("<H", len(v)) + v
    else:
        ltype, info = 0, _le(addr, 8)
    return (bytes([1, nsz | (0x08 if ltype else 0)]) + (bytes([ltype]) if ltype else b"")
            + _le(len(nb), 1 << nsz) + nb + info)


def _link_messages(g: Group) -> bool:
    """Whether `g` is written with link messages (an external link has no
    symbol-table form) instead of a symbol table."""
    return any(isinstance(v, ExternalLink) for v in g._links().values())


def _write_file(f: File) -> None:
    """Write the whole tree to a temporary file, then os.replace it."""
    objects: List[_Node] = []
    seen: set = set()

    def collect(node: _Node) -> None:
        objects.append(node)
        seen.add(id(node))
        if isinstance(node, Group):
            links = node._links()
            for name in sorted(links, key=lambda n: n.encode("utf-8")):
                child = links[name]
                if isinstance(child, _Node) and id(child) not in seen:
                    collect(child)

    collect(f)
    addr_of: Dict[int, int] = {}

    def committed_at(t: _Type) -> Optional[int]:
        """The new address of the committed datatype `t` came from, None
        where it is not written (the type then goes inline)."""
        c = t.committed
        if c is None:
            return None
        c = f._copies.get(id(c), c)
        return addr_of.get(id(c), 0) if id(c) in seen else None

    def refaddr(a: _Attr) -> Callable[[Reference], int]:
        def get(r: Reference) -> int:
            # a reference to no object (h5py's copies of dimension scales
            # hold such) is written as a null reference
            r = _resolve(r, a.file)
            if not r:
                return 0
            return addr_of[id(f._copies.get(id(r.target), r.target))]
        return get

    heap_objs: List[bytes] = []   # global heap objects, in encoding order
    heap_slots: List[Tuple[int, int]] = []

    def heap_dry(data: bytes) -> Tuple[int, int]:
        heap_objs.append(data)
        return (0, 0)

    def attr_bodies(node: _Node, real: bool) -> List[Tuple[str, bytes]]:
        out = []
        slots = iter(heap_slots) if real else None

        def heap_real(data: bytes) -> Tuple[int, int]:
            k, slot = next(slots)
            heap_objs[k] = data   # same length as in the dry run
            return slot

        for name, a in node._attrs().items():
            raw = a.raw
            if a.type.has_refs:
                if real:
                    raw = _to_raw(a.array(), a.type, refaddr(a), heap_real).tobytes()
                else:
                    raw = _to_raw(a.array(), a.type, lambda _r: 0, heap_dry).tobytes()
            out.append((name, _attr_msg(name, a, raw, committed_at(a.type))))
        return out

    def object_msgs(node: _Node, meta: dict) -> List[Tuple[int, int, bytes]]:
        if isinstance(node, Datatype):
            return [(_DATATYPE, 1, node._load_type().encoded)]
        if isinstance(node, Group):
            if not _link_messages(node):
                return [(_STAB, 0, struct.pack("<QQ", meta.get("btree", 0), meta.get("heap", 0)))]
            links = node._links()
            return [(_LINKINFO, 0, struct.pack("<BBQQ", 0, 0, UNDEF, UNDEF)),
                    (_GROUPINFO, 0, b"\0\0")] + [
                (_LINK, 0, _link_msg(n, links[n], addr_of.get(id(links[n]), 0)))
                for n in sorted(links, key=lambda n: n.encode("utf-8"))]
        ds: Dataset = node
        ds._load()
        t = ds._type
        at = committed_at(t)
        msgs = [(_DATASPACE, 0, ds._space_raw or _encode_space(ds._shape)),
                (_DATATYPE, 1, t.encoded) if at is None else (_DATATYPE, 3, _shared_msg(at))]
        if ds._raw_msgs:
            msgs += [(mt, 1, b) for mt, b in ds._raw_msgs]
        else:
            # h5py's default fill value message: version 2, allocation
            # incremental (chunked) or late, written if set, library default
            msgs.append((_FILL, 1, struct.pack(
                "<BBBBI", 2, 3 if ds._layout == "chunked" else 2, 2, 1, 0)))
        data = meta.get("data", UNDEF)
        if ds._layout == "chunked":
            dims = ds._chunks + (t.size,)
            msgs.append((_LAYOUT, 0, struct.pack("<BBBQ", 3, 2, len(dims), data)
                         + struct.pack(f"<{len(dims)}I", *dims)))
        elif ds._layout == "compact":
            msgs.append((_LAYOUT, 0, struct.pack("<BBH", 3, 0, len(ds._compact)) + ds._compact))
        else:
            msgs.append((_LAYOUT, 0, struct.pack("<BBQQ", 3, 1, data, ds.size * t.size)))
        if ds._pipeline is not None:
            msgs.append((_PIPELINE, 1, ds._pipeline.encoded))
        return msgs

    def header(node: _Node, meta: dict, bodies, dense: Optional[dict]) -> bytes:
        msgs = object_msgs(node, meta)
        if dense is None:
            return _header(msgs + [(_ATTRIBUTE, 0, b) for _, b in bodies])
        return _header_v2(msgs + [(_ATTRINFO, 0, struct.pack(
            "<BBQQ", 0, 0, dense.get("heap", 0), dense.get("btree", 0)))])

    # 1. header sizes (the addresses inside do not change them); objects
    # with an attribute too large for a message keep them in dense storage
    sizes, heap_counts, dense_of = {}, {}, {}
    for node in objects:
        before = len(heap_objs)
        bodies = attr_bodies(node, False)
        if any(len(b) > _MAX_MSG for _, b in bodies):
            dense_of[id(node)] = [(n, len(b)) for n, b in bodies]
        sizes[id(node)] = len(header(node, {}, bodies, {} if id(node) in dense_of else None))
        heap_counts[id(node)] = (before, len(heap_objs))

    # beside the target (os.replace stays on one file system), created as
    # open() creates files, so the umask sets its mode
    tmp = f"{f.path}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
    fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_EXCL, 0o666)
    try:
        out = _Out(fd)
        out.alloc(96)  # superblock
        # 2. addresses of headers, group structures, heaps, dense storage
        for node in objects:
            addr_of[id(node)] = out.alloc(sizes[id(node)])
        groups = {id(n): _plan_group(n, out) for n in objects
                  if isinstance(n, Group) and not _link_messages(n)}
        heaps = _plan_gheap(heap_objs, out)
        dense = {k: _plan_dense(v, out) for k, v in dense_of.items()}
        # 3. raw data, written as it is produced
        datas = {id(n): _write_data(n, out) for n in objects if isinstance(n, Dataset)}
        # 4. headers, groups, heaps, superblock
        for node in objects:
            lo, hi = heap_counts[id(node)]
            heap_slots[:] = [(k, heaps["slots"][k]) for k in range(lo, hi)]
            meta = groups.get(id(node)) or datas.get(id(node)) or {}
            bodies = attr_bodies(node, True)
            hb = header(node, meta, bodies, dense.get(id(node)))
            if len(hb) != sizes[id(node)]:
                raise RuntimeError(f"object header of {node.name!r} changed size")
            out.put(addr_of[id(node)], hb)
            if id(node) in dense:
                _encode_dense(bodies, dense[id(node)], out)
        for node in objects:
            if id(node) in groups:
                _encode_group(node, groups, addr_of, out)
        _encode_gheap(heap_objs, heaps, out)
        root = groups.get(id(f))
        entry = (struct.pack("<QQII", 0, addr_of[id(f)], 1, 0)
                 + struct.pack("<QQ", root["btree"], root["heap"]) if root
                 else struct.pack("<QQII16x", 0, addr_of[id(f)], 0, 0))
        out.put(0, SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                + struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0)
                + struct.pack("<QQQQ", 0, UNDEF, out.size, UNDEF) + entry)
        os.ftruncate(fd, out.size)
        os.close(fd)
        fd = -1
        os.replace(tmp, f.path)
    except BaseException:
        if fd >= 0:
            os.close(fd)
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


_DENSE_BLOCK_HDR = 17   # FHDB, version, heap header address, 4-byte block offset


def _plan_dense(attrs: List[Tuple[str, int]], out: _Out) -> dict:
    """Addresses of an object's dense attribute storage: a fractal heap
    whose root is one direct block holding every attribute message, and
    a one-leaf v2 B-tree indexing them by name."""
    offsets, pos = [], _DENSE_BLOCK_HDR
    for _, n in attrs:
        offsets.append(pos)
        pos += n
    block = max(512, 1 << (pos - 1).bit_length())
    if block > 1 << 24:
        raise ValueError("attributes of one object over 16 MiB are not written by this codec")
    node_size = max(512, 10 + 17 * len(attrs))
    return {"heap": out.alloc(146), "block": out.alloc(block), "bsize": block,
            "offsets": offsets, "btree": out.alloc(38), "leaf": out.alloc(node_size),
            "node_size": node_size}


def _encode_dense(bodies: List[Tuple[str, bytes]], meta: dict, out: _Out) -> None:
    size, n = meta["bsize"], len(bodies)
    blk = bytearray(size)
    blk[:_DENSE_BLOCK_HDR] = b"FHDB\0" + _le(meta["heap"], 8) + _le(0, 4)
    for (_, body), off in zip(bodies, meta["offsets"]):
        blk[off:off + len(body)] = body
    out.put(meta["block"], bytes(blk))
    h = (b"FRHP\0" + struct.pack("<HHBI", 8, 0, 0, size)   # ID length, no filter, flags, max object
         + struct.pack("<QQQQ", 0, UNDEF, 0, UNDEF)        # huge objects; free space
         + struct.pack("<QQQQ", size, size, size, n)        # managed space, objects
         + struct.pack("<QQQQ", 0, 0, 0, 0)                 # huge and tiny objects
         + struct.pack("<HQQHHQH", 4, size, size, 32, 1, meta["block"], 0))
    out.put(meta["heap"], h + _le(_filters.lookup3(h), 4))
    len_size = min((size.bit_length() - 1 + 7) // 8, (size.bit_length() - 1) // 8 + 1)
    recs = sorted((_filters.lookup3(name.encode("utf-8")), name.encode("utf-8"), i,
                   (b"\0" + _le(off, 4) + _le(len(body), len_size)).ljust(8, b"\0"))
                  for i, ((name, body), off) in enumerate(zip(bodies, meta["offsets"])))
    leaf = b"BTLF\0\x08" + b"".join(hid + b"\0" + _le(i, 4) + _le(hsh, 4)
                                    for hsh, _, i, hid in recs)
    leaf += _le(_filters.lookup3(leaf), 4)
    out.put(meta["leaf"], leaf + b"\0" * (meta["node_size"] - len(leaf)))
    bt = b"BTHD\0\x08" + struct.pack("<IHHBBQHQ", meta["node_size"], 17, 0, 100, 40,
                                     meta["leaf"], n, n)
    out.put(meta["btree"], bt + _le(_filters.lookup3(bt), 4))


def _plan_btree(out: _Out, leaves, right_key, fanout: int) -> Tuple[int, list]:
    """A v1 B-tree over `leaves` [(left key, child address)] in as many
    levels as nodes of `fanout` children need. Returns the root's address
    and the nodes [(address, level, [(key, child)], right key)]."""
    nodes = []
    level, entries = 0, leaves
    while True:
        parts = [entries[i:i + fanout] for i in range(0, len(entries), fanout)] or [[]]
        built = []
        for i, part in enumerate(parts):
            rk = parts[i + 1][0][0] if i + 1 < len(parts) else right_key
            nodes.append([None, level, part, rk])  # allocated by _encode_btree
            built.append((part[0][0] if part else right_key, len(nodes) - 1))
        if len(built) == 1:
            return built[0][1], nodes
        level, entries = level + 1, built


def _encode_btree(out: _Out, nodes, ntype: int, fanout: int, key_size: int,
                  encode_key: Callable[[object], bytes]) -> int:
    """Allocate and write the planned nodes (each at its full size: HDF5
    reads 2K entries); children that are node indices become addresses."""
    node_size = 24 + fanout * 8 + (fanout + 1) * key_size
    for n in nodes:
        n[0] = out.alloc(node_size)
    by_level: Dict[int, List[int]] = {}
    for i, n in enumerate(nodes):
        by_level.setdefault(n[1], []).append(i)
    for i, (addr, level, entries, rk) in enumerate(nodes):
        sib = by_level[level]
        k = sib.index(i)
        left = nodes[sib[k - 1]][0] if k > 0 else UNDEF
        right = nodes[sib[k + 1]][0] if k + 1 < len(sib) else UNDEF
        body = [struct.pack("<4sBBHQQ", b"TREE", ntype, level, len(entries), left, right)]
        for key, child in entries:
            body.append(encode_key(key))
            body.append(_le(child if level == 0 else nodes[child][0], 8))
        body.append(encode_key(rk))
        raw = b"".join(body)
        out.put(addr, raw + b"\0" * (node_size - len(raw)))
    return nodes[-1][0]


def _plan_group(g: Group, out: _Out) -> dict:
    """Addresses of a symbol-table group's local heap and SNODs, its
    entries sorted by name (HDF5 looks names up by bisection)."""
    links = g._links()
    names = sorted(links, key=lambda n: n.encode("utf-8"))
    offsets, pos = [], 8   # offset 0 holds the empty name
    for n in names:
        offsets.append(pos)
        pos += _align8(len(n.encode("utf-8")) + 1)
    values = {}            # soft links' paths follow the names
    for n in names:
        if isinstance(links[n], SoftLink):
            values[n] = pos
            pos += _align8(len(links[n].path.encode("utf-8")) + 1)
    heap, heap_data = out.alloc(32), out.alloc(pos)
    per = 2 * _GROUP_LEAF_K
    snods = [(names[i:i + per], out.alloc(8 + per * 40)) for i in range(0, len(names), per)]
    name_off = dict(zip(names, offsets))
    # child i covers names in (key i, key i+1]: key 0 is "", key i+1 the
    # last name of SNOD i
    leaves = [(0 if i == 0 else name_off[snods[i - 1][0][-1]], a)
              for i, (_, a) in enumerate(snods)]
    right = name_off[names[-1]] if names else 0
    root, nodes = _plan_btree(out, leaves, right, 2 * _GROUP_NODE_K)
    meta = {"names": names, "offsets": offsets, "heap": heap, "heap_data": heap_data,
            "heap_size": pos, "snods": snods, "nodes": nodes, "values": values}
    meta["btree"] = _encode_btree(out, nodes, 0, 2 * _GROUP_NODE_K, 8, lambda k: _le(k, 8))
    return meta


def _encode_group(g: Group, groups: Dict[int, dict], addr_of, out: _Out) -> None:
    meta = groups[id(g)]
    data = bytearray(meta["heap_size"])
    links = g._links()
    for n, o in list(zip(meta["names"], meta["offsets"])) + [
            (links[n].path, o) for n, o in meta["values"].items()]:
        nb = n.encode("utf-8")
        data[o:o + len(nb)] = nb
    # free list head 1: no free block
    out.put(meta["heap"], struct.pack("<4sB3xQQQ", b"HEAP", 0, meta["heap_size"], 1,
                                      meta["heap_data"]))
    out.put(meta["heap_data"], bytes(data))
    off = dict(zip(meta["names"], meta["offsets"]))
    per = 2 * _GROUP_LEAF_K
    for entries, addr in meta["snods"]:
        body = [struct.pack("<4sBxH", b"SNOD", 1, len(entries))]
        for n in entries:
            child = links[n]
            if isinstance(child, SoftLink):  # cache type 2: the path's heap offset
                body.append(struct.pack("<QQIII12x", off[n], UNDEF, 2, 0, meta["values"][n]))
            elif isinstance(child, Group) and id(child) in groups:  # cached B-tree and heap
                cm = groups[id(child)]
                body.append(struct.pack("<QQIIQQ", off[n], addr_of[id(child)], 1, 0,
                                        cm["btree"], cm["heap"]))
            else:
                body.append(struct.pack("<QQII16x", off[n], addr_of[id(child)], 0, 0))
        raw = b"".join(body)
        out.put(addr, raw + b"\0" * (8 + per * 40 - len(raw)))


def _plan_gheap(objs: List[bytes], out: _Out) -> dict:
    """Global heap collections (at least 4096 bytes) for `objs`."""
    slots, sizes, used, index = [], [], 16, 0
    for data in objs:
        need = 16 + _align8(len(data))
        if index and used + need > _GHEAP_MIN:
            sizes.append(used)
            used, index = 16, 0
        index += 1
        slots.append((len(sizes), index))
        used += need
    if objs:
        sizes.append(used)
    sizes = [max(_GHEAP_MIN, s) for s in sizes]
    addrs = [out.alloc(s) for s in sizes]
    return {"slots": [(addrs[c], i) for c, i in slots], "sizes": sizes, "addrs": addrs,
            "collection": [c for c, _ in slots]}


def _encode_gheap(objs: List[bytes], plan: dict, out: _Out) -> None:
    bufs = [[struct.pack("<4sB3xQ", b"GCOL", 1, s)] for s in plan["sizes"]]
    used = [16] * len(bufs)
    for data, c, (_, index) in zip(objs, plan["collection"], plan["slots"]):
        bufs[c].append(struct.pack("<HH4xQ", index, 1, len(data)) + _pad8(data))
        used[c] += 16 + _align8(len(data))
    for c, parts in enumerate(bufs):
        free = plan["sizes"][c] - used[c]
        if free >= 16:  # object 0: the free space
            parts.append(struct.pack("<HH4xQ", 0, 0, free))
        raw = b"".join(parts)
        out.put(plan["addrs"][c], raw + b"\0" * (plan["sizes"][c] - len(raw)))


def _write_data(ds: Dataset, out: _Out) -> dict:
    """Write a dataset's raw data; returns its layout's address."""
    ds._load()
    t = ds._type
    if ds._layout == "compact":
        return {}
    if ds._layout == "contiguous":
        if ds._data is not None:
            return {"data": out.append(np.ascontiguousarray(ds._data, dtype=t.raw).tobytes())}
        if ds._contig[0] == UNDEF:
            return {"data": UNDEF}
        return {"data": out.append(ds._rsrc.read(ds._contig[0], ds._contig[1], "contiguous data"))}
    rank, chunks = len(ds._shape), ds._chunks
    leaves = []
    last = None
    if ds._data is not None:
        grid = [-(-n // c) for n, c in zip(ds._shape, chunks)]
        positions = list(np.ndindex(*grid))

        def encode(pos) -> bytes:
            sl = tuple(slice(p * c, min((p + 1) * c, n)) for p, c, n in zip(pos, chunks, ds._shape))
            block = ds._data[sl]
            if block.shape != chunks:   # edge chunks are stored whole
                full = np.zeros(chunks, t.raw)
                full[tuple(slice(0, s) for s in block.shape)] = block
                block = full
            raw = np.ascontiguousarray(block, dtype=t.raw).tobytes()
            return raw if ds._pipeline is None else ds._pipeline.encode_chunk(raw, t.size)

        for pos, raw in zip(positions, map(encode, positions)):
            leaves.append(((len(raw), 0, pos), out.append(raw)))
            last = pos
    else:
        for pos, (caddr, nbytes, mask) in sorted(ds._index().items()):
            leaves.append(((nbytes, mask, pos), out.append(ds._rsrc.read(caddr, nbytes, "chunk"))))
            last = pos
    if not leaves:
        return {"data": UNDEF}
    right = (0, 0, tuple(p + 1 for p in last))
    key_size = 8 + 8 * (rank + 1)

    def key(k) -> bytes:
        nbytes, mask, pos = k
        return struct.pack(f"<II{rank + 1}Q", nbytes, mask,
                           *(p * c for p, c in zip(pos, chunks)), 0)

    _, nodes = _plan_btree(out, leaves, right, 2 * _CHUNK_K)
    return {"data": _encode_btree(out, nodes, 1, 2 * _CHUNK_K, key_size, key)}
