"""A small HDF5 reader and writer on numpy alone (no libhdf5, no h5py).

The machine that runs the port on the card has no HDF5 library, so the
port reads and writes its files through this module. It offers the slice of
h5py's interface the package uses: ``File(path, mode)``, groups addressed by
``"a/b"`` paths, datasets read with numpy indexing, and ``attrs``.

Reading covers what the HDF5 library writes by default (and h5py with it):
superblock versions 0-3, object headers v1 and v2, old-style (symbol table)
and compact new-style groups, contiguous, compact and chunked datasets (v1
B-tree chunk index, deflate and shuffle filters), and numeric, fixed- or
variable-length string attributes. Anything else — dense link or attribute
storage, the version-4 chunk indexes (chunked datasets in files written
with the library's newest format), compound or enum types — raises
:class:`H5FormatError` naming it.

A read touches only what it selects: a row range of a chunked dataset
(``dset[r0:r1]``, ``dset[i]``) decodes only the chunks that meet those
rows, each once (``DECODE_STATS`` counts them), and
:meth:`Dataset.read_direct` fills a caller's buffer — possibly a column
window of a wider one — with a row range: from a contiguous dataset, or an
unfiltered chunk as wide as the rows, straight from the file (``preadv``,
one iovec a row: one copy out of the page cache).

Writing produces the library's default (earliest) format: a version-0
superblock, version-1 object headers, symbol-table groups and
variable-length strings in one global heap. A dataset is contiguous, or
chunked where ``create_dataset`` is given ``chunks``, as the library writes
an extendible dataset: a version-1 dataspace with its maximum dimensions
(``None`` is unlimited), a version-3 layout message of class 2 whose chunk
dimensions end with the element size, a version-1 B-tree of type 1 as the
chunk index (nodes of 2K = 64 entries, allocated whole, so the library can
insert into them in place), every chunk stored whole and unfiltered, and the
fill value in both fill-value messages. The HDF5 library can therefore
``resize`` such a dataset and append to the file. A file created ``"w"`` is
held in memory and written out whole on ``close()``, through a temporary
file renamed over the target, so a reader never sees a torn file.

A file opened ``"r+"`` is changed in place (:class:`_Edit`), never
rewritten: chunked datasets resize within their ``maxshape`` and take
writes, new chunks at the end of the file entered in the chunk B-tree
(which splits its nodes and grows levels as the library's does); existing
numeric attributes are overwritten; new groups and datasets are written at
the end and linked into a symbol-table group. ``File.flush`` commits in
crash order and ``fsync``s. Such files stay ones the HDF5 library reads and
extends. Any other in-place change raises :class:`H5FormatError`.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
_LEAF_K, _NODE_K = 4, 16  # symbol-table node and group B-tree widths
_CHUNK_K = 32  # chunk B-tree width: the library's default for a version-0 superblock


class H5FormatError(OSError):
    """The file is not HDF5, or uses a feature this module does not read."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# chunks decoded by the process (a row-range read decodes each chunk it
# meets once; the tests count them)
DECODE_STATS = {"chunks": 0}

# iovecs one preadv takes
_IOV_MAX = os.sysconf("SC_IOV_MAX") if hasattr(os, "sysconf") else 1024


def _pread_rows(fd: int, offset: int, dest: np.ndarray, path: str) -> None:
    """Fill ``dest`` (2-D, each row contiguous) from the file's contiguous
    bytes at ``offset``: the whole array in one read where it is
    contiguous, else one iovec per row, ``_IOV_MAX`` rows a ``preadv``."""
    if dest.flags.c_contiguous:
        views = [memoryview(dest.reshape(-1)).cast("B")]
    else:
        views = [memoryview(row).cast("B") for row in dest]
    for i in range(0, len(views), max(1, _IOV_MAX)):
        batch = views[i:i + max(1, _IOV_MAX)]
        want = sum(v.nbytes for v in batch)
        got = os.preadv(fd, batch, offset)
        pos = 0
        for v in batch:  # after a short read, the rest one view at a time
            start = min(max(got - pos, 0), v.nbytes)
            while start < v.nbytes:
                n = os.preadv(fd, [v[start:]], offset + pos + start)
                if n <= 0:
                    raise H5FormatError(f"{path}: truncated at byte {offset + pos + start}")
                start += n
            pos += v.nbytes
        offset += want


# ---------------------------------------------------------------------------
# reading

class _Reader:
    """Parses one open file; addresses are relative to the superblock."""

    def __init__(self, path: str, writable: bool = False):
        self.path = path
        # unbuffered: reads go through pread, so a write through the same
        # descriptor is never hidden behind a stale buffer
        self.fh = open(path, "r+b" if writable else "rb", buffering=0)
        try:
            self._superblock()
        except BaseException:
            self.fh.close()
            raise

    def close(self) -> None:
        self.fh.close()

    def read(self, addr: int, n: int) -> bytes:
        data = os.pread(self.fh.fileno(), n, self.base + addr)
        while len(data) < n:
            more = os.pread(self.fh.fileno(), n - len(data), self.base + addr + len(data))
            if not more:
                raise H5FormatError(f"{self.path}: truncated at address {addr}")
            data += more
        return data

    def _superblock(self) -> None:
        size = os.fstat(self.fh.fileno()).st_size
        at = 0
        while at + 8 <= size:
            self.fh.seek(at)
            if self.fh.read(8) == SIGNATURE:
                break
            at = 512 if at == 0 else at * 2
        else:
            raise H5FormatError(f"{self.path} is not an HDF5 file")
        self.base = at
        head = self.read(8, 16)
        version = self.sb_version = head[0]
        # the B-tree widths (K) of symbol-table nodes and chunk indexes:
        # version 1 stores the chunk index's, version 0 has the default
        self.leaf_k, self.chunk_k = _LEAF_K, _CHUNK_K
        if version in (0, 1):
            self.so, self.sl = head[5], head[6]
            self.leaf_k = struct.unpack_from("<H", head, 8)[0]
            if version == 1:
                self.chunk_k = struct.unpack_from("<H", self.read(24, 2), 0)[0]
            pos = 8 + 16 + (4 if version == 1 else 0)
            self.eof_at = pos + 2 * self.so  # after base and free-space addresses
            self.stored_eof = self._addr(self.read(self.eof_at, 8), 0)
            pos += 4 * self.so  # base, free-space, end-of-file, driver
            entry = self.read(pos, 2 * self.so + 24)
            self.root = self._addr(entry, self.so)
        elif version in (2, 3):
            self.so, self.sl = head[1], head[2]
            pos = 8 + 4 + 3 * self.so  # base, extension, end-of-file
            self.root = self._addr(self.read(pos, self.so), 0)
        else:
            raise H5FormatError(f"{self.path}: superblock version {version}")
        if self.so != 8 or self.sl != 8:
            raise H5FormatError(f"{self.path}: offsets of {self.so} bytes")

    @staticmethod
    def _addr(buf: bytes, pos: int) -> int:
        return struct.unpack_from("<Q", buf, pos)[0]

    # -- object headers ----------------------------------------------------
    def messages(self, addr: int) -> List[Tuple[int, bytes]]:
        return [(mtype, data) for mtype, data, _ in self.messages_at(addr)]

    def messages_at(self, addr: int) -> List[Tuple[int, bytes, Optional[int]]]:
        """``(type, data, address of the data)`` of each message; the
        address is None in a version-2 header (its chunks carry a checksum,
        so a message there cannot be edited in place here)."""
        if self.read(addr, 4) == b"OHDR":
            return [(mtype, data, None) for mtype, data in self._messages_v2(addr)]
        head = self.read(addr, 16)
        if head[0] != 1:
            raise H5FormatError(f"{self.path}: object header version {head[0]}")
        count, size = struct.unpack_from("<H", head, 2)[0], struct.unpack_from("<I", head, 8)[0]
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < count:
            start, length = blocks.pop(0)
            buf, pos = self.read(start, length), 0
            while pos + 8 <= length and len(out) < count:
                mtype, msize, mflags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                at = start + pos + 8
                pos += 8 + msize
                found: List[Tuple[int, bytes]] = []
                self._collect(mtype, mflags, data, found, blocks)
                out.extend((t, d, at) for t, d in found)
        return out

    def _messages_v2(self, addr: int) -> List[Tuple[int, bytes]]:
        flags = self.read(addr, 6)[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = int.from_bytes(self.read(addr + pos, width), "little")
        hdr = 4 + (2 if flags & 0x04 else 0)  # type, size, flags[, order]
        blocks, out = [(addr + pos + width, size)], []
        while blocks:
            start, length = blocks.pop(0)
            buf, p = self.read(start, length), 0
            if buf[:4] == b"OCHK":  # continuation chunk: signature ... checksum
                buf, p = buf[:-4], 4
            while p + hdr <= len(buf):
                mtype, msize, mflags = buf[p], struct.unpack_from("<H", buf, p + 1)[0], buf[p + 3]
                data = buf[p + hdr:p + hdr + msize]
                p += hdr + msize
                self._collect(mtype, mflags, data, out, blocks)
        return out

    def _collect(self, mtype, mflags, data, out, blocks) -> None:
        if mtype == 0x10:  # continuation
            blocks.append((self._addr(data, 0), self._addr(data, 8)))
        elif mtype:
            if mflags & 0x02:
                raise H5FormatError(f"{self.path}: shared (committed) messages")
            out.append((mtype, data))

    # -- groups ------------------------------------------------------------
    def links(self, msgs) -> Dict[str, int]:
        links: Dict[str, int] = {}
        for mtype, data in msgs:
            if mtype == 0x11:  # symbol table: v1 B-tree + local heap
                heap = self._local_heap(self._addr(data, 8))
                self._walk_group_btree(self._addr(data, 0), heap, links)
            elif mtype == 0x06:
                name, target = self._link(data)
                if target is not None:
                    links[name] = target
            elif mtype == 0x02 and self._addr(data, 2 + (8 if data[1] & 1 else 0)) != UNDEF:
                raise H5FormatError(f"{self.path}: dense link storage")
        return links

    def _local_heap(self, addr: int) -> bytes:
        head = self.read(addr, 32)
        if head[:4] != b"HEAP":
            raise H5FormatError(f"{self.path}: bad local heap at {addr}")
        size = self._addr(head, 8)
        return self.read(self._addr(head, 24), size)

    @staticmethod
    def _cstr(heap: bytes, off: int) -> str:
        return heap[off:heap.index(b"\0", off)].decode()

    def _walk_group_btree(self, addr: int, heap: bytes, links: Dict[str, int]) -> None:
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 0:
            raise H5FormatError(f"{self.path}: bad group B-tree at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        body = self.read(addr + 24, used * 16 + 8)
        for i in range(used):
            child = self._addr(body, 8 + 16 * i)
            if level:
                self._walk_group_btree(child, heap, links)
                continue
            snod = self.read(child, 8)
            if snod[:4] != b"SNOD":
                raise H5FormatError(f"{self.path}: bad symbol node at {child}")
            n = struct.unpack_from("<H", snod, 6)[0]
            ents = self.read(child + 8, 40 * n)
            for e in range(n):
                links[self._cstr(heap, self._addr(ents, 40 * e))] = self._addr(ents, 40 * e + 8)

    def _link(self, data: bytes):
        flags, pos = data[1], 2
        ltype = 0
        if flags & 0x08:
            ltype, pos = data[pos], pos + 1
        if flags & 0x04:
            pos += 8
        if flags & 0x10:
            pos += 1
        width = 1 << (flags & 3)
        n = int.from_bytes(data[pos:pos + width], "little")
        pos += width
        name = data[pos:pos + n].decode()
        return name, (self._addr(data, pos + n) if ltype == 0 else None)

    # -- datatypes, dataspaces, attributes ---------------------------------
    def dtype(self, data: bytes):
        """numpy dtype, or the string "vlen-str"."""
        cls, bits = data[0] & 0x0F, data[1] | (data[2] << 8)
        size = struct.unpack_from("<I", data, 4)[0]
        order = ">" if bits & 1 else "<"
        if cls == 0:
            return np.dtype(f"{order}{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:
            return np.dtype(f"{order}f{size}")
        if cls == 3:
            return np.dtype(f"S{size}")
        if cls == 9 and (bits & 0x0F) == 1:
            return "vlen-str"
        raise H5FormatError(f"{self.path}: datatype class {cls}")

    @staticmethod
    def dtype_size(data: bytes) -> int:
        return struct.unpack_from("<I", data, 4)[0]

    @staticmethod
    def shape(data: bytes) -> Optional[Tuple[int, ...]]:
        version, rank, flags = data[0], data[1], data[2]
        if version == 1:
            pos = 8
        else:
            if data[3] == 2:
                return None  # null dataspace
            pos = 4
        return tuple(struct.unpack_from(f"<{rank}Q", data, pos)) if rank else ()

    @staticmethod
    def maxshape(data: bytes) -> Optional[Tuple[Optional[int], ...]]:
        """The maximum dimensions (None for unlimited), or None where the
        dataspace message has none."""
        version, rank, flags = data[0], data[1], data[2]
        if not flags & 1:
            return None
        pos = (8 if version == 1 else 4) + 8 * rank
        dims = struct.unpack_from(f"<{rank}Q", data, pos)
        return tuple(None if d == UNDEF else d for d in dims)

    @staticmethod
    def fill_value(data: bytes, dt: np.dtype):
        """The defined fill value of a fill-value message (versions 1-3),
        else None."""
        version = data[0]
        if version in (1, 2):
            defined, pos = data[3], 4
        elif version == 3:
            defined, pos = data[1] & 0x20, 2
        else:
            return None
        if not defined or len(data) < pos + 4:
            return None
        size = struct.unpack_from("<I", data, pos)[0]
        if size != dt.itemsize:
            return None
        return np.frombuffer(data, dt, count=1, offset=pos + 4)[0]

    def attributes(self, msgs) -> Dict[str, object]:
        return {name: value for name, (value, _slot) in self.attribute_slots(msgs).items()}

    def attribute_slots(self, msgs) -> Dict[str, Tuple[object, Optional[Tuple]]]:
        """name -> ``(value, slot)``; ``slot`` is ``(address of the raw
        value, dtype, shape)`` where ``msgs`` carry the messages' addresses
        (:meth:`messages_at`) and the value is numeric, else None."""
        out: Dict[str, Tuple[object, Optional[Tuple]]] = {}
        for msg in msgs:
            mtype, data, at = msg if len(msg) == 3 else (*msg, None)
            if mtype == 0x15 and self._addr(data, 4 if data[1] & 1 else 2) != UNDEF:
                raise H5FormatError(f"{self.path}: dense attribute storage")
            if mtype != 0x0C:
                continue
            version = data[0]
            nsize, tsize, ssize = struct.unpack_from("<HHH", data, 2)
            pos = 8 + (1 if version == 3 else 0)
            pad = _pad8 if version == 1 else (lambda n: n)
            name = data[pos:pos + nsize].split(b"\0")[0].decode()
            pos += pad(nsize)
            tdata = data[pos:pos + tsize]
            pos += pad(tsize)
            shape = self.shape(data[pos:pos + ssize])
            pos += pad(ssize)
            dt = self.dtype(tdata)
            value = self._value(dt, self.dtype_size(tdata), shape, data[pos:])
            slot = ((at + pos, dt, shape) if at is not None and isinstance(dt, np.dtype)
                    and shape is not None else None)
            out[name] = (value, slot)
        return out

    def _value(self, dt, itemsize, shape, raw):
        n = int(np.prod(shape)) if shape else 1
        if dt == "vlen-str":
            vals = []
            for i in range(n):
                length, coll, index = struct.unpack_from("<IQI", raw, 16 * i)
                vals.append(self._global(coll, index)[:length].decode())
            return vals[0] if shape == () else np.array(vals, dtype=object).reshape(shape)
        arr = np.frombuffer(raw, dtype=dt, count=n)
        arr = arr.astype(arr.dtype.newbyteorder("=")) if arr.dtype.byteorder == ">" else arr
        return arr[0] if shape == () else arr.reshape(shape).copy()

    def _global(self, coll: int, index: int) -> bytes:
        head = self.read(coll, 16)
        if head[:4] != b"GCOL":
            raise H5FormatError(f"{self.path}: bad global heap at {coll}")
        size, pos = self._addr(head, 8), 16
        buf = self.read(coll, size)
        while pos + 16 <= size:
            idx = struct.unpack_from("<H", buf, pos)[0]
            osize = self._addr(buf, pos + 8)
            if idx == index:
                return buf[pos + 16:pos + 16 + osize]
            if idx == 0:
                break
            pos += 16 + _pad8(osize)
        raise H5FormatError(f"{self.path}: global heap object {index} missing")

    # -- dataset storage ---------------------------------------------------
    def layout(self, data: bytes, rank: int):
        version, cls = data[0], data[1]
        if version in (3, 4) and cls in (0, 1) or version == 3:
            if cls == 0:
                n = struct.unpack_from("<H", data, 2)[0]
                return ("compact", data[4:4 + n])
            if cls == 1:
                return ("contiguous", self._addr(data, 2))
            if cls == 2:
                dims = data[2]
                chunk = struct.unpack_from(f"<{dims}I", data, 11)
                return ("chunked", self._addr(data, 3), tuple(chunk[:rank]))
        raise H5FormatError(f"{self.path}: data layout version {version} class {cls}"
                            + (" (a version-4 chunk index)" if cls == 2 else ""))

    @staticmethod
    def filters(data: bytes) -> List[Tuple[int, Tuple[int, ...]]]:
        version, count = data[0], data[1]
        pos, out = (8 if version == 1 else 2), []
        for _ in range(count):
            fid = struct.unpack_from("<H", data, pos)[0]
            pos += 2
            nlen = 0
            if version == 1 or fid >= 256:
                nlen = struct.unpack_from("<H", data, pos)[0]
                pos += 2
            _flags, nval = struct.unpack_from("<HH", data, pos)
            pos += 4 + (_pad8(nlen) if version == 1 else nlen)
            vals = struct.unpack_from(f"<{nval}I", data, pos)
            pos += 4 * nval + (4 if version == 1 and nval % 2 else 0)
            out.append((fid, vals))
        return out

    def chunks(self, addr: int, rank: int):
        """``(offset, size, filter_mask, address)`` of every stored chunk."""
        head = self.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise H5FormatError(f"{self.path}: bad chunk B-tree at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        ksize = 8 + 8 * (rank + 1)
        body = self.read(addr + 24, used * (ksize + 8) + ksize)
        out = []
        for i in range(used):
            k = i * (ksize + 8)
            size, mask = struct.unpack_from("<II", body, k)
            offset = struct.unpack_from(f"<{rank}Q", body, k + 8)
            child = self._addr(body, k + ksize)
            if level:
                out.extend(self.chunks(child, rank))
            else:
                out.append((offset, size, mask, child))
        return out


# ---------------------------------------------------------------------------
# the h5py-like objects

class AttributeManager:
    """``slots`` (files opened ``"r+"``): name -> where an existing numeric
    attribute's value lies, for an overwrite in place; ``edit`` the file's
    in-place writer. Without ``edit`` the attributes live in memory (a new
    object's, written when the file is)."""

    def __init__(self, values: Dict[str, object], writable: bool,
                 slots: Optional[Dict[str, Tuple]] = None, edit=None):
        self._values = values
        self._writable = writable
        self._slots = slots or {}
        self._edit = edit

    def __getitem__(self, name: str):
        return self._values[name]

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def get(self, name: str, default=None):
        return self._values.get(name, default)

    def keys(self):
        return sorted(self._values)

    def items(self):
        return [(k, self._values[k]) for k in self.keys()]

    def __setitem__(self, name: str, value) -> None:
        self.create(name, value)

    def create(self, name: str, value, dtype=None) -> None:
        if not self._writable:
            raise OSError("the file is open read-only")
        if self._edit is not None:
            self._values[name] = self._edit.overwrite_attribute(
                name, self._slots.get(name), value)
            return
        if isinstance(value, str):
            self._values[name] = value
        else:
            self._values[name] = np.asarray(value, dtype=dtype)


class Dataset:
    """``maxshape``, ``chunks`` and ``fillvalue`` as in h5py: the maximum
    shape (None where the dataset is not extendible), the chunk shape (None
    for a contiguous or compact dataset) and the defined fill value (None
    where there is none)."""

    def __init__(self, name: str, *, data: Optional[np.ndarray] = None, reader=None,
                 msgs=None, writable: bool = False, maxshape=None, chunks=None,
                 fillvalue=None, edit=None):
        self.name = name
        self._writable = writable
        self._edit = edit
        self._tree = None  # the chunk index, loaded by a first in-place write
        self.maxshape, self.chunks, self.fillvalue = maxshape, chunks, fillvalue
        if data is not None:
            self._data = np.ascontiguousarray(data)
            self.attrs = AttributeManager({}, writable)
            return
        self._data = None
        self._reader = reader
        msgs = [m if len(m) == 3 else (*m, None) for m in msgs]
        self._msg_at = {t: at for t, _, at in msgs}
        info = {t: d for t, d, _ in msgs}
        shape = reader.shape(info[0x01])
        if shape is None or 0x03 not in info or 0x08 not in info:
            raise H5FormatError(f"{reader.path}: {name} is not a plain dataset")
        dt = reader.dtype(info[0x03])
        if not isinstance(dt, np.dtype):
            raise H5FormatError(f"{reader.path}: {name} has a variable-length type")
        self._shape, self._dtype = shape, dt
        self._layout = reader.layout(info[0x08], len(shape))
        self._filters = reader.filters(info[0x0B]) if 0x0B in info else []
        self._space_version = info[0x01][0]
        slots = reader.attribute_slots(msgs)
        self.attrs = AttributeManager({k: v for k, (v, _) in slots.items()}, writable,
                                      {k: sl for k, (_, sl) in slots.items()}, edit)
        if self._layout[0] == "chunked":
            self.chunks = self._layout[2]
            self.maxshape = reader.maxshape(info[0x01]) or shape
        if 0x05 in info:
            self.fillvalue = reader.fill_value(info[0x05], dt)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._data.shape if self._data is not None else self._shape

    @property
    def dtype(self) -> np.dtype:
        if self._data is not None:
            return self._data.dtype
        return self._dtype.newbyteorder("=")

    def _read_all(self) -> np.ndarray:
        r, lay = self._reader, self._layout
        n = int(np.prod(self._shape))
        if lay[0] == "compact":
            arr = np.frombuffer(lay[1], self._dtype, count=n)
        elif lay[0] == "contiguous":
            if lay[1] == UNDEF:
                return np.zeros(self._shape, self.dtype)
            arr = np.frombuffer(r.read(lay[1], n * self._dtype.itemsize), self._dtype)
        else:
            return self._read_chunked()
        return arr.reshape(self._shape).astype(self.dtype)

    def _read_chunked(self) -> np.ndarray:
        """Chunks never written read as the fill value."""
        out = np.empty(self._shape, self.dtype)
        self._chunked_rows(0, self._shape[0] if self._shape else 0, out)
        return out

    def _decode(self, raw: bytes, mask: int) -> np.ndarray:
        """One stored chunk through its filters (deflate, shuffle), as a
        block of the chunk shape."""
        r, chunk = self._reader, self._layout[2]
        for i, (fid, _vals) in reversed(list(enumerate(self._filters))):
            if mask & (1 << i):
                continue
            if fid == 1:
                raw = zlib.decompress(raw)
            elif fid == 2:
                item = self._dtype.itemsize
                raw = np.frombuffer(raw, np.uint8).reshape(item, -1).T.tobytes()
            else:
                raise H5FormatError(f"{r.path}: filter {fid} of {self.name}")
        DECODE_STATS["chunks"] += 1
        return np.frombuffer(raw, self._dtype, count=int(np.prod(chunk))).reshape(chunk)

    def _stored_chunks(self):
        """``(offset, size, filter_mask, address)`` of every stored chunk:
        from the in-memory index once an in-place write loaded it (whose
        pending chunks are then written: a read sees its file's writes)."""
        if self._tree is not None:
            self._tree.write_data()
            return [(off, size, mask, addr)
                    for off, (size, mask, addr) in self._tree.index.items()]
        addr = self._layout[1]
        return [] if addr == UNDEF else self._reader.chunks(addr, len(self._layout[2]))

    def _chunked_rows(self, r0: int, r1: int, out: np.ndarray) -> None:
        """Rows ``[r0, r1)`` of a chunked dataset into ``out`` (their shape):
        only the chunks that intersect the rows are read and decoded, each
        once; rows of chunks never written hold the fill value."""
        r, (_, addr, chunk) = self._reader, self._layout
        fill = 0 if self.fillvalue is None else self.fillvalue
        if r1 <= r0:
            return
        stored = [c for c in self._stored_chunks()
                  if c[0][0] < r1 and c[0][0] + chunk[0] > r0]
        # the chunk grid cells the rows meet: fewer stored means some never
        # were written, and their rows hold the fill value
        cells = (r1 - 1) // chunk[0] - r0 // chunk[0] + 1
        for s, c in zip(self._shape[1:], chunk[1:]):
            cells *= -(-s // c)
        if len(stored) < cells:
            out[...] = fill
        # an unfiltered chunk as wide as the rows goes from the file into
        # out's rows in one copy, as a contiguous dataset does
        whole_rows = (tuple(chunk[1:]) == tuple(self._shape[1:]) and out.ndim == 2
                      and out.dtype == self._dtype and out.strides[1] == out.itemsize)
        row_bytes = self._dtype.itemsize * int(np.prod(chunk[1:]))
        for offset, size, mask, caddr in stored:
            lo, hi = max(offset[0], r0), min(offset[0] + chunk[0], r1)
            unfiltered = all(mask & (1 << i) for i in range(len(self._filters)))
            if whole_rows and unfiltered:
                _pread_rows(r.fh.fileno(), r.base + caddr + (lo - offset[0]) * row_bytes,
                            out[lo - r0:hi - r0], r.path)
                DECODE_STATS["chunks"] += 1
                continue
            block = self._decode(r.read(caddr, size), mask)
            dst = (slice(lo - r0, hi - r0),) + tuple(
                slice(o, min(o + c, s))
                for o, c, s in zip(offset[1:], chunk[1:], self._shape[1:]))
            src = (slice(lo - offset[0], hi - offset[0]),) + tuple(
                slice(0, d.stop - d.start) for d in dst[1:])
            out[dst] = block[src]

    def _row_range(self, key):
        """``(r0, r1, rest)`` where ``key`` selects a row range with unit step
        (an int keeps the row axis and drops it through ``rest``), else
        None."""
        if not self._shape:
            return None
        first, rest = (key[0], key[1:]) if isinstance(key, tuple) else (key, ())
        n = self._shape[0]
        if isinstance(first, (int, np.integer)):
            i = int(first) + (n if first < 0 else 0)
            if not 0 <= i < n:
                raise IndexError(f"index {first} is out of bounds for axis 0 with size {n}")
            return i, i + 1, (0,) + tuple(rest)
        if isinstance(first, slice):
            r0, r1, step = first.indices(n)
            if step == 1:
                return r0, max(r0, r1), (slice(None),) + tuple(rest)
        return None

    def read_direct(self, dest: np.ndarray, rows: Tuple[int, int]) -> None:
        """Rows ``[rows[0], rows[1])`` into ``dest``, an array of their shape
        — possibly a view of columns of a wider buffer, its rows each
        contiguous. A contiguous dataset is read from the file straight into
        ``dest`` (one ``preadv`` a batch of rows: one copy, from the page
        cache); a chunked one decodes only the chunks the rows meet, each
        once."""
        r0, r1 = int(rows[0]), int(rows[1])
        if not (0 <= r0 <= r1 <= (self.shape[0] if self.shape else 0)):
            raise IndexError(f"{self.name}: rows [{r0}, {r1}) outside {self.shape}")
        if tuple(dest.shape) != (r1 - r0,) + tuple(self.shape[1:]):
            raise ValueError(f"{self.name}: destination {dest.shape} for rows "
                             f"[{r0}, {r1}) of {self.shape}")
        if self._data is not None:
            dest[...] = self._data[r0:r1]
            return
        lay = self._layout
        if lay[0] == "chunked":
            self._chunked_rows(r0, r1, dest)
        elif lay[0] == "contiguous" and lay[1] != UNDEF and self._shape:
            row_bytes = self._dtype.itemsize * int(np.prod(self._shape[1:]))
            at = self._reader.base + lay[1] + r0 * row_bytes
            direct = (dest.dtype == self._dtype and dest.ndim == 2
                      and dest.strides[1] == dest.itemsize)
            target = dest if direct else np.empty(dest.shape, self._dtype)
            _pread_rows(self._reader.fh.fileno(), at, target, self._reader.path)
            if not direct:
                dest[...] = target
        else:
            dest[...] = self._read_all()[r0:r1]

    def __getitem__(self, key) -> np.ndarray:
        if self._data is not None:
            return np.array(self._data[key])
        lay = self._layout
        if lay[0] == "contiguous" and lay[1] != UNDEF and self._shape:
            view = np.memmap(self._reader.path, dtype=self._dtype, mode="r",
                             offset=self._reader.base + lay[1], shape=self._shape)
            try:
                return np.array(view[key], dtype=self.dtype)
            finally:
                del view
        rows = self._row_range(key) if lay[0] == "chunked" else None
        if rows is not None:
            r0, r1, rest = rows
            out = np.empty((r1 - r0,) + tuple(self._shape[1:]), self.dtype)
            self._chunked_rows(r0, r1, out)
            return np.array(out[rest])
        return np.array(self._read_all()[key])

    def __array__(self, dtype=None, copy=None):
        arr = self._data if self._data is not None else self._read_all()
        return np.asarray(arr, dtype=dtype)

    def _require_writable(self) -> None:
        if not self._writable:
            raise OSError("the file is open read-only")

    def __setitem__(self, key, value) -> None:
        self._require_writable()
        if self._data is not None:
            self._data[key] = value
            return
        self._edit.write_dataset(self, self._box(key), value)

    def _box(self, key) -> Tuple[Tuple[int, int], ...]:
        """The ``[lo, hi)`` bounds per axis that ``key`` selects: ints and
        slices of unit step (an in-place write takes no other selection)."""
        key = key if isinstance(key, tuple) else (key,)
        key = key + (slice(None),) * (len(self._shape) - len(key))
        box = []
        for k, n in zip(key, self._shape):
            if isinstance(k, (int, np.integer)):
                i = int(k) + (n if k < 0 else 0)
                if not 0 <= i < n:
                    raise IndexError(f"{self.name}: index {k} out of bounds for {n}")
                box.append((i, i + 1))
            elif isinstance(k, slice) and k.indices(n)[2] == 1:
                lo, hi, _ = k.indices(n)
                box.append((lo, max(lo, hi)))
            else:
                raise H5FormatError(f"{self.name}: in-place write of selection {key!r}")
        return tuple(box)

    def resize(self, shape) -> None:
        """New rows hold the fill value (0 where none is defined). A chunked
        dataset grows only within its ``maxshape``. In a file opened
        ``"r+"`` the new extent reaches the file with the next
        :meth:`File.flush` (its dataspace is rewritten in place)."""
        self._require_writable()
        shape = tuple(int(s) for s in shape)
        if self.maxshape is not None and (len(shape) != len(self.maxshape) or any(
                m is not None and n > m for n, m in zip(shape, self.maxshape))):
            raise ValueError(f"{self.name}: shape {shape} exceeds maxshape {self.maxshape}")
        if self._data is None:
            self._edit.resize_dataset(self, shape)
            return
        fill = 0 if self.fillvalue is None else self.fillvalue
        new = np.full(shape, fill, self._data.dtype)
        common = tuple(slice(0, min(a, b)) for a, b in zip(shape, self._data.shape))
        new[common] = self._data[common]
        self._data = new


class Group:
    def __init__(self, name: str, *, reader=None, addr: Optional[int] = None,
                 writable: bool = False, edit=None):
        self.name = name
        self._writable = writable
        self._edit = edit if reader is not None else None
        self._addr = addr
        self._children: Dict[str, object] = {}
        if reader is None:
            self.attrs = AttributeManager({}, writable)
            return
        msgs = reader.messages_at(addr)
        slots = reader.attribute_slots(msgs)
        self.attrs = AttributeManager({k: v for k, (v, _) in slots.items()}, writable,
                                      {k: sl for k, (_, sl) in slots.items()}, self._edit)
        for child, caddr in reader.links([(t, d) for t, d, _ in msgs]).items():
            self._children[child] = (reader, caddr)  # opened on first use

    def _child(self, name: str):
        obj = self._children[name]
        if isinstance(obj, tuple):
            reader, addr = obj
            msgs = reader.messages_at(addr)
            path = f"{self.name.rstrip('/')}/{name}"
            if all(t != 0x08 for t, _, _ in msgs):  # no data layout: a group
                obj = Group(path, reader=reader, addr=addr, writable=self._writable,
                            edit=self._edit)
            else:
                obj = Dataset(path, reader=reader, msgs=msgs, writable=self._writable,
                              edit=self._edit)
            self._children[name] = obj
        return obj

    def __getitem__(self, path: str):
        obj = self
        for part in [p for p in path.split("/") if p]:
            if not isinstance(obj, Group) or part not in obj._children:
                raise KeyError(f"Unable to open object (object '{part}' doesn't exist)")
            obj = obj._child(part)
        return obj

    def __contains__(self, path: str) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def __iter__(self) -> Iterator[str]:
        return iter(sorted(self._children))

    def __len__(self) -> int:
        return len(self._children)

    def _parent_for_new(self, path: str):
        parts = [p for p in path.split("/") if p]
        if not self._writable:
            raise OSError("the file is open read-only")
        parent = self
        for part in parts[:-1]:  # intermediate groups are created, as in h5py
            parent = (parent._child(part) if part in parent._children
                      else parent.create_group(part))
        if parts[-1] in parent._children:
            raise ValueError(f"Unable to create {path!r} (name already exists)")
        return parent, parts[-1]

    def create_group(self, path: str) -> "Group":
        parent, name = self._parent_for_new(path)
        grp = Group(f"{parent.name.rstrip('/')}/{name}", writable=True)
        parent._children[name] = grp
        parent._new_child(name, grp)
        return grp

    def _new_child(self, name: str, obj) -> None:
        """In a file opened ``"r+"``, a new member of a group stored in the
        file is written at its end and linked in when the file is flushed;
        the members of a new group go with it."""
        if self._edit is not None:
            self._edit.new.append((self, name, obj))

    def create_dataset(self, path: str, shape=None, dtype=None, data=None, *,
                       maxshape=None, chunks=None, fillvalue=None) -> Dataset:
        """As h5py's, with the layout given explicitly: ``chunks`` (a shape)
        makes the dataset chunked, ``maxshape`` (None for an unlimited
        dimension) needs ``chunks``."""
        parent, name = self._parent_for_new(path)
        if data is None:
            fill = 0 if fillvalue is None else fillvalue
            data = np.full(shape, fill, dtype=dtype or np.float32)
        arr = np.asarray(data, dtype=dtype)
        if shape is not None and tuple(arr.shape) != tuple(shape):
            arr = arr.reshape(shape)
        if maxshape is not None and chunks is None:
            raise ValueError(f"{path}: maxshape needs explicit chunks here")
        if chunks is not None:
            chunks = tuple(int(c) for c in chunks)
            maxshape = tuple(arr.shape) if maxshape is None else tuple(
                None if m is None else int(m) for m in maxshape)
            if (len(chunks) != arr.ndim or len(maxshape) != arr.ndim
                    or any(c < 1 for c in chunks)
                    or any(m is not None and n > m for n, m in zip(arr.shape, maxshape))):
                raise ValueError(f"{path}: chunks {chunks} or maxshape {maxshape} do not "
                                 f"fit shape {arr.shape}")
        if fillvalue is not None:
            fillvalue = np.asarray(fillvalue, arr.dtype)[()]
        dset = Dataset(f"{parent.name.rstrip('/')}/{name}", data=arr, writable=True,
                       maxshape=maxshape, chunks=chunks, fillvalue=fillvalue)
        parent._children[name] = dset
        parent._new_child(name, dset)
        return dset


class File(Group):
    """``mode``: "r" (read, lazily), "w" (create or truncate: the file is
    built in memory and written whole on ``close()``) or "r+" (read and
    write an existing file in place, :class:`_Edit`)."""

    def __init__(self, path, mode: str = "r"):
        self.filename = os.fspath(path)
        self.mode = mode
        self._reader = None
        if mode not in ("r", "w", "r+"):
            raise ValueError(f"mode {mode!r}")
        if mode == "w":
            super().__init__("/", writable=True)
            return
        reader = self._reader = _Reader(self.filename, writable=mode == "r+")
        try:
            edit = _Edit(reader) if mode == "r+" else None
            super().__init__("/", reader=reader, addr=reader.root, writable=mode == "r+",
                             edit=edit)
        except BaseException:
            reader.close()
            raise

    def flush(self) -> None:
        """``"r+"``: write what is pending — new objects and their links,
        the chunk indexes, the end-of-file address, then the dataspaces —
        and ``fsync`` the file. A no-op in the other modes."""
        if self._edit is not None:
            self._edit.flush()

    def close(self) -> None:
        if self._reader is not None:
            try:
                if self._edit is not None:
                    self._edit.flush()
            finally:
                self._edit = None
                self._reader.close()
                self._reader = None
        elif self._writable:
            _write_file(self.filename, self)
            self._writable = False

    def __enter__(self) -> "File":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None:
            # leave the file as its last flush left it: "w" writes nothing,
            # "r+" writes no pending metadata (chunks already written lie
            # past the dataspaces or the end of the file)
            self._writable = False
            self._edit = None
        self.close()


# ---------------------------------------------------------------------------
# writing

def _dtype_message(dt) -> bytes:
    if dt == "vlen-str":  # variable-length UTF-8 string of 1-byte characters
        base = bytes([0x10, 0, 0, 0]) + struct.pack("<IHH", 1, 0, 8)
        return bytes([0x19, 0x01, 0x01, 0]) + struct.pack("<I", 16) + base
    dt = np.dtype(dt)
    size = dt.itemsize
    if dt.kind in "iu":
        bits = 0x08 if dt.kind == "i" else 0
        return bytes([0x10, bits, 0, 0]) + struct.pack("<IHH", size, 0, 8 * size)
    if dt.kind == "f":
        exp, man, bias = {2: (5, 10, 15), 4: (8, 23, 127), 8: (11, 52, 1023)}[size]
        return (bytes([0x11, 0x20, 8 * size - 1, 0]) + struct.pack("<I", size)
                + struct.pack("<HHBBBBI", 0, 8 * size, man, exp, 0, man, bias))
    if dt.kind == "S":
        return bytes([0x13, 0, 0, 0]) + struct.pack("<I", size)
    raise TypeError(f"cannot store dtype {dt} in HDF5 here")


def _space_message(shape, maxshape=None) -> bytes:
    """Version 1; ``maxshape`` (None entries unlimited) adds the maximum
    dimensions."""
    out = bytes([1, len(shape), 0 if maxshape is None else 1, 0, 0, 0, 0, 0])
    out += struct.pack(f"<{len(shape)}Q", *shape)
    if maxshape is not None:
        out += struct.pack(f"<{len(shape)}Q", *(UNDEF if m is None else m for m in maxshape))
    return out


def _message(mtype: int, data: bytes) -> bytes:
    data = data + b"\0" * (_pad8(len(data)) - len(data))
    return struct.pack("<HHB3x", mtype, len(data), 0) + data


class _Writer:
    def __init__(self, out, strings: Dict[str, Tuple[int, int]]):
        self.out = out
        self.strings = strings

    def alloc(self, data) -> int:
        """Write ``data`` (bytes, or a C-contiguous array, without a copy)
        at the next 8-byte boundary; returns its address."""
        pos = self.out.tell()
        if pos % 8:
            self.out.write(b"\0" * (8 - pos % 8))
            pos = self.out.tell()
        self.out.write(memoryview(data).cast("B") if isinstance(data, np.ndarray) else data)
        return pos

    def header(self, messages: List[bytes]) -> int:
        body = b"".join(messages)
        return self.alloc(struct.pack("<BBHII4x", 1, 0, len(messages), 1, len(body)) + body)

    def attribute_messages(self, attrs: AttributeManager) -> List[bytes]:
        out = []
        for name in attrs.keys():
            value = attrs[name]
            if isinstance(value, str):
                coll, index = self.strings[value]
                dt, shape = _dtype_message("vlen-str"), ()
                raw = struct.pack("<IQI", len(value.encode()), coll, index)
            else:
                dt, shape = _dtype_message(value.dtype), value.shape
                raw = np.ascontiguousarray(value, value.dtype.newbyteorder("<")).tobytes()
            space = _space_message(shape)
            bname = name.encode() + b"\0"
            head = struct.pack("<BxHHH", 1, len(bname), len(dt), len(space))
            body = b"".join(x + b"\0" * (_pad8(len(x)) - len(x)) for x in (bname, dt, space))
            out.append(_message(0x0C, head + body + raw))
        return out

    def dataset(self, dset: Dataset) -> int:
        arr = np.ascontiguousarray(dset._data, dset._data.dtype.newbyteorder("<"))
        if dset.chunks is not None:
            return self.chunked(dset, arr)
        addr = self.alloc(arr.reshape(-1)) if arr.size else UNDEF
        layout = struct.pack("<BBQQ", 3, 1, addr, arr.nbytes)
        fill = bytes([2, 2, 2, 0])
        return self.header([_message(0x01, _space_message(arr.shape)),
                            _message(0x03, _dtype_message(arr.dtype)),
                            _message(0x05, fill), _message(0x08, layout)]
                           + self.attribute_messages(dset.attrs))

    def chunked(self, dset: Dataset, arr: np.ndarray) -> int:
        """A chunked dataset as the library writes an extendible one: every
        chunk that meets the shape stored whole (the part past the shape
        holds the fill value), indexed by a version-1 B-tree of type 1."""
        chunks, item = dset.chunks, arr.dtype.itemsize
        fill = np.zeros((), arr.dtype) if dset.fillvalue is None else np.asarray(
            dset.fillvalue, arr.dtype)
        entries = []  # (element offsets, chunk address), in offset order
        grid = [range(0, n, c) for n, c in zip(arr.shape, chunks)]
        for offset in (np.stack(np.meshgrid(*grid, indexing="ij"), -1).reshape(-1, arr.ndim)
                       if arr.size else ()):
            offset = tuple(int(o) for o in offset)
            block = np.full(chunks, fill, arr.dtype)
            src = tuple(slice(o, min(o + c, n)) for o, c, n in zip(offset, chunks, arr.shape))
            block[tuple(slice(0, s.stop - s.start) for s in src)] = arr[src]
            entries.append((offset, self.alloc(block.reshape(-1))))
        nbytes = int(np.prod(chunks)) * item
        btree = self.chunk_btree(entries, chunks, item, nbytes) if entries else UNDEF
        layout = struct.pack("<BBBQ", 3, 2, arr.ndim + 1, btree)
        layout += struct.pack(f"<{arr.ndim + 1}I", *chunks, item)
        value = fill.tobytes()
        fill_new = bytes([2, 3, 2, 1]) + struct.pack("<I", item) + value  # incremental, if set
        fill_old = struct.pack("<I", item) + value
        return self.header([_message(0x01, _space_message(arr.shape, dset.maxshape)),
                            _message(0x03, _dtype_message(arr.dtype)),
                            _message(0x05, fill_new), _message(0x04, fill_old),
                            _message(0x08, layout)]
                           + self.attribute_messages(dset.attrs))

    def chunk_btree(self, entries, chunks, item: int, nbytes: int) -> int:
        """The chunk index over ``entries`` ((element offsets, address) in
        offset order); returns its root's address. A key is (bytes of the
        chunk, filter mask 0, its element offsets, 0). A node's last key is
        the next node's first, and the last node's the offsets one chunk past
        its last child's in every dimension, as the library writes it."""
        per = 2 * _CHUNK_K
        rank = len(chunks)

        def key(size, offset):
            return struct.pack(f"<II{rank + 1}Q", size, 0, *offset, 0)

        last = entries[-1][0]
        end = key(0, tuple(o + c for o, c in zip(last, chunks)))[:-8] + struct.pack("<Q", item)
        node_bytes = 24 + per * 8 + (per + 1) * len(end)
        level = 0
        # (first key, address) of each node of the level below; leaves first
        nodes = [(key(nbytes, offset), addr) for offset, addr in entries]
        while True:
            parents = []
            for start in range(0, len(nodes), per):
                group = nodes[start:start + per]
                right = nodes[start + per][0] if start + per < len(nodes) else end
                body = b"".join(k + struct.pack("<Q", a) for k, a in group) + right
                raw = (b"TREE" + struct.pack("<BBHQQ", 1, level, len(group), UNDEF, UNDEF)
                       + body)
                parents.append((group[0][0], self.alloc(raw + bytes(node_bytes - len(raw)))))
            if len(parents) == 1:
                return parents[0][1]
            nodes, level = parents, level + 1

    def group(self, grp: Group) -> Tuple[int, int, int]:
        names = sorted(grp._children, key=lambda n: n.encode())
        addrs = []
        for name in names:
            child = grp._children[name]
            addrs.append(self.group(child)[0] if isinstance(child, Group)
                         else self.dataset(child))
        heap, offsets = bytearray(8), []  # offset 0: the empty name
        for name in names:
            offsets.append(len(heap))
            raw = name.encode() + b"\0"
            heap += raw + b"\0" * (_pad8(len(raw)) - len(raw))
        # free-list offset 1 is the library's "no free block"
        heap_addr = self.alloc(b"HEAP" + bytes(4)
                               + struct.pack("<QQQ", len(heap), 1, 0))
        data_addr = self.alloc(bytes(heap))
        self.out.seek(heap_addr + 24)
        self.out.write(struct.pack("<Q", data_addr))
        self.out.seek(0, os.SEEK_END)
        per = 2 * _LEAF_K
        if len(names) > per * 2 * _NODE_K:
            raise ValueError(f"group {grp.name} has more than {per * 2 * _NODE_K} members")
        snods, keys = [], [0]
        for start in range(0, len(names), per):
            ents = b"".join(struct.pack("<QQII16x", offsets[i], addrs[i], 0, 0)
                            for i in range(start, min(start + per, len(names))))
            count = min(per, len(names) - start)
            ents += b"\0" * (40 * per - len(ents))
            snods.append(self.alloc(b"SNOD" + struct.pack("<BBH", 1, 0, count) + ents))
            keys.append(offsets[start + count - 1])
        body = struct.pack("<Q", keys[0]) + b"".join(
            struct.pack("<QQ", child, key) for child, key in zip(snods, keys[1:]))
        body += b"\0" * ((2 * _NODE_K) * 16 + 8 - len(body))
        btree = self.alloc(b"TREE" + struct.pack("<BBHQQ", 0, 0, len(snods), UNDEF, UNDEF) + body)
        addr = self.header([_message(0x11, struct.pack("<QQ", btree, heap_addr))]
                           + self.attribute_messages(grp.attrs))
        return addr, btree, heap_addr


def _strings(grp: Group, found: List[str]) -> List[str]:
    for _name, value in grp.attrs.items():
        if isinstance(value, str) and value not in found:
            found.append(value)
    for child in grp._children.values():
        if isinstance(child, Group):
            _strings(child, found)
        else:
            for _name, value in child.attrs.items():
                if isinstance(value, str) and value not in found:
                    found.append(value)
    return found


def _global_heap(out, strings: List[str]) -> Dict[str, Tuple[int, int]]:
    """A global heap collection holding ``strings`` (the variable-length
    string attributes' values), written at ``out``'s position; returns each
    string's ``(collection address, index)``."""
    if not strings:
        return {}
    objs = b""
    for i, s in enumerate(strings, start=1):
        raw = s.encode()
        objs += struct.pack("<HH4xQ", i, 0, len(raw)) + raw
        objs += b"\0" * (_pad8(len(raw)) - len(raw))
    size = max(4096, _pad8(16 + len(objs) + 16))
    free = struct.pack("<HH4xQ", 0, 0, size - 16 - len(objs))
    coll = b"GCOL" + bytes([1, 0, 0, 0]) + struct.pack("<Q", size) + objs + free
    coll += b"\0" * (size - len(coll))
    caddr = _Writer(out, {}).alloc(coll)
    return {s: (caddr, i) for i, s in enumerate(strings, start=1)}


def _write_file(path: str, root: Group) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as out:
            out.write(bytes(96))  # superblock, written last
            table = _global_heap(out, _strings(root, []))
            root_addr, btree, heap = _Writer(out, table).group(root)
            eof = out.seek(0, os.SEEK_END)
            out.seek(0)
            out.write(SIGNATURE + bytes([0, 0, 0, 0, 0, 8, 8, 0])
                      + struct.pack("<HHI", _LEAF_K, _NODE_K, 0)
                      + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
                      + struct.pack("<QQII", 0, root_addr, 1, 0)
                      + struct.pack("<QQ", btree, heap))
            out.flush()
            os.fsync(out.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# ---------------------------------------------------------------------------
# writing in place ("r+")

class _Edit:
    """The in-place writer of a file opened ``"r+"``: what the solution
    writers need, done as the HDF5 library does it, and nothing else.

    - a chunked dataset is resized within its maximum shape; its dataspace
      message is rewritten in place (same rank, same size) at the next
      :meth:`flush`. Shrinking writes the fill value over the stored chunks'
      part past the new extent, so rows that come back read as the fill;
    - a write fills the chunks it meets: a stored, unfiltered chunk in place
      (its size does not change), a new chunk at the end of the file,
      entered in the chunk B-tree (:class:`_ChunkTree`);
    - an existing numeric attribute of the same type and shape is
      overwritten in place;
    - a new group or dataset is written whole at the end of the file and
      linked into a stored symbol-table group that has a free entry in its
      symbol-table node (the local heap's data segment, grown by the name,
      moves to the end of the file);
    - the superblock's end-of-file address follows the allocations.

    Anything else raises :class:`H5FormatError` naming the operation: the
    file is never rewritten whole. :meth:`flush` writes the pending
    metadata in crash order — new objects and their links, the chunk
    indexes, the end-of-file address, then the dataspaces — and ``fsync``s:
    a file killed before it holds its previous extents, with the new
    chunks unreferenced past them.
    """

    def __init__(self, reader: _Reader):
        r = self.r = reader
        if r.base != 0:
            raise H5FormatError(f"{r.path}: in-place update of a file with a user block")
        if r.sb_version not in (0, 1):
            raise H5FormatError(f"{r.path}: in-place update under a version-"
                                f"{r.sb_version} superblock (it holds a checksum)")
        self.fd = r.fh.fileno()
        # allocate past everything the file holds: a torn earlier write may
        # have left bytes past its recorded end
        self.eof = _pad8(max(r.stored_eof, os.fstat(self.fd).st_size))
        self.eof_dirty = False
        self.resized: Dict[int, Dataset] = {}
        self.trees: Dict[int, "_ChunkTree"] = {}
        self.new: List[Tuple[Group, str, object]] = []

    def alloc(self, n: int) -> int:
        addr = self.eof
        self.eof = _pad8(addr + n)
        self.eof_dirty = True
        return addr

    def write(self, addr: int, data) -> None:
        view = memoryview(data).cast("B")
        while len(view):
            n = os.pwrite(self.fd, view, addr)
            view, addr = view[n:], addr + n

    # -- datasets ----------------------------------------------------------
    def _chunked(self, dset: Dataset, what: str):
        if dset._layout[0] != "chunked":
            raise H5FormatError(f"{self.r.path}: in-place {what} of {dset._layout[0]} "
                                f"dataset {dset.name}")
        if dset._msg_at.get(0x01) is None or dset._msg_at.get(0x08) is None:
            raise H5FormatError(f"{self.r.path}: in-place {what} of {dset.name} "
                                "(a version-2 object header)")
        if dset._tree is None:
            dset._tree = _ChunkTree(self, dset)
            self.trees[id(dset)] = dset._tree
        return dset._tree

    def resize_dataset(self, dset: Dataset, shape: Tuple[int, ...]) -> None:
        tree = self._chunked(dset, "resize")
        old = dset._shape
        if len(shape) != len(old):
            raise H5FormatError(f"{self.r.path}: resize of {dset.name} to rank {len(shape)}")
        if any(n < o for n, o in zip(shape, old)):
            # stored chunks keep their place; their part past the new
            # extent takes the fill value, as the library's pruning leaves it
            chunk = dset._layout[2]
            for off in list(tree.index):
                box = [(o, min(o + c, n)) for o, c, n in zip(off, chunk, old)]
                if any(lo >= hi for lo, hi in box):
                    continue
                if all(hi <= n for (_, hi), n in zip(box, shape)):
                    continue
                block = tree.read_block(off)
                keep = tuple(slice(0, max(0, min(c, n - o)))
                             for o, c, n in zip(off, chunk, shape))
                fresh = np.full(chunk, tree.fill, block.dtype)
                fresh[keep] = block[keep]
                tree.write_block(off, fresh)
        dset._shape = tuple(shape)
        self.resized[id(dset)] = dset

    def write_dataset(self, dset: Dataset, box, value) -> None:
        tree = self._chunked(dset, "write")
        chunk = dset._layout[2]
        want = tuple(hi - lo for lo, hi in box)
        value = np.broadcast_to(np.asarray(value, dset._dtype), want)
        if not all(hi > lo for lo, hi in box):
            return
        grid = [range((lo // c) * c, hi, c) for (lo, hi), c in zip(box, chunk)]
        for off in (tuple(int(o) for o in cell)
                    for cell in np.stack(np.meshgrid(*grid, indexing="ij"), -1)
                    .reshape(-1, len(chunk))):
            dst = tuple(slice(max(lo, o) - o, min(hi, o + c) - o)
                        for (lo, hi), o, c in zip(box, off, chunk))
            src = tuple(slice(max(lo, o) - lo, min(hi, o + c) - lo)
                        for (lo, hi), o, c in zip(box, off, chunk))
            whole = all(d.start == 0 and d.stop == c for d, c in zip(dst, chunk))
            if off in tree.index and not whole:
                block = tree.read_block(off)
            else:
                block = np.full(chunk, tree.fill, dset._dtype)
            block[dst] = value[src]
            tree.write_block(off, block)

    # -- attributes --------------------------------------------------------
    def overwrite_attribute(self, name: str, slot, value):
        if slot is None or isinstance(value, str):
            raise H5FormatError(f"{self.r.path}: in-place write of attribute {name!r} "
                                "(only an existing numeric attribute is overwritten)")
        addr, dt, shape = slot
        arr = np.asarray(value)
        cast = arr.astype(dt)
        if (arr.shape != tuple(shape) or arr.dtype.kind != dt.kind
                or not np.array_equal(cast, arr)):
            raise H5FormatError(f"{self.r.path}: in-place write of attribute {name!r} "
                                f"as {arr.dtype}{arr.shape} over {dt}{tuple(shape)}")
        self.write(addr, np.ascontiguousarray(cast).tobytes())
        out = cast.astype(dt.newbyteorder("="))
        return out[()] if out.shape == () else out

    # -- new objects -------------------------------------------------------
    def _write_new(self) -> List[Tuple[int, bytes]]:
        """Write the new objects at the end of the file, and each link's
        grown heap segment; returns the writes that then link them in."""
        pending, self.new = self.new, []
        links: List[Tuple[int, bytes]] = []
        for parent, name, obj in pending:
            if parent._addr is None:
                continue  # a member of a new group: written with it
            with open(self.r.path, "r+b") as out:
                out.seek(self.eof)
                w = _Writer(out, {})
                w.strings = _global_heap(out, _strings(obj, []) if isinstance(obj, Group)
                                         else [v for _, v in obj.attrs.items()
                                               if isinstance(v, str)])
                addr = w.group(obj)[0] if isinstance(obj, Group) else w.dataset(obj)
                out.flush()
                self.eof = _pad8(out.tell())
            self.eof_dirty = True
            links += self._link(parent._addr, name, addr)
            # the new object is now stored: it reopens as the file's own
            parent._children[name] = (self.r, addr)
        return links

    def _link(self, group_addr: int, name: str, target: int) -> List[Tuple[int, bytes]]:
        """Enter ``name -> target`` into the symbol-table group at
        ``group_addr``: the name is appended to the local heap, whose data
        segment is written anew at the end of the file now; returned are
        the writes that commit the link — the heap's header, the entry
        inserted in name order into the symbol-table node that holds its
        range, and that node's key where the name is its largest."""
        r, path = self.r, self.r.path
        stab = [d for t, d in r.messages(group_addr) if t == 0x11]
        if not stab:
            raise H5FormatError(f"{path}: linking {name!r} into a group without a "
                                "symbol table (link messages)")
        btree, heap = r._addr(stab[0], 0), r._addr(stab[0], 8)
        head = r.read(heap, 32)
        size, daddr = r._addr(head, 8), r._addr(head, 24)
        data = r.read(daddr, size)
        raw = name.encode() + b"\0"
        raw += b"\0" * (_pad8(len(raw)) - len(raw))
        name_off = size
        data += raw
        bt = r.read(btree, 24)
        if bt[:4] != b"TREE" or bt[4] != 0:
            raise H5FormatError(f"{path}: bad group B-tree at {btree}")
        used = struct.unpack_from("<H", bt, 6)[0]
        if bt[5] != 0 or used == 0:
            raise H5FormatError(f"{path}: linking {name!r} into a group B-tree of "
                                f"{bt[5] + 1} level(s) and {used} node(s)")
        body = r.read(btree + 24, 16 * used + 8)
        keys = [r._addr(body, 16 * i) for i in range(used + 1)]
        key_name = [_Reader._cstr(data, k).encode() for k in keys]
        bname = name.encode()
        i = next((j for j in range(used) if bname <= key_name[j + 1]), used - 1)
        snod = r._addr(body, 8 + 16 * i)
        head = r.read(snod, 8)
        if head[:4] != b"SNOD":
            raise H5FormatError(f"{path}: bad symbol node at {snod}")
        count = struct.unpack_from("<H", head, 6)[0]
        if count >= 2 * r.leaf_k:
            raise H5FormatError(f"{path}: linking {name!r}: the group's symbol-table "
                                "node is full")
        ents = [r.read(snod + 8 + 40 * e, 40) for e in range(count)]
        names = [_Reader._cstr(data, r._addr(e, 0)).encode() for e in ents]
        if bname in names:
            raise ValueError(f"Unable to create {name!r} (name already exists)")
        pos = sum(n < bname for n in names)
        ents.insert(pos, struct.pack("<QQII16x", name_off, target, 0, 0))
        new_daddr = self.alloc(len(data))
        self.write(new_daddr, data)
        out = [(heap + 8, struct.pack("<Q", len(data))),
               (heap + 24, struct.pack("<Q", new_daddr)),
               (snod + 6, struct.pack("<H", count + 1)),
               (snod + 8, b"".join(ents))]
        if bname > key_name[i + 1]:
            out.append((btree + 24 + 16 * (i + 1), struct.pack("<Q", name_off)))
        return out

    # -- the commit --------------------------------------------------------
    def flush(self) -> None:
        """Commit in crash order: the new data (written already) and
        objects, then the end-of-file address that covers them, ``fsync``;
        then what references them — links, chunk-index nodes — and the
        dataspaces last, ``fsync``."""
        links = self._write_new()
        for tree in self.trees.values():
            tree.write_data()
        if self.eof_dirty:
            if os.fstat(self.fd).st_size < self.eof:
                os.ftruncate(self.fd, self.eof)  # the library reads past no end
            self.write(self.r.eof_at, struct.pack("<Q", self.eof))
            self.eof_dirty = False
            os.fsync(self.fd)
        for addr, data in links:
            self.write(addr, data)
        for tree in self.trees.values():
            tree.flush()
        for dset in self.resized.values():
            at = dset._msg_at[0x01] + (8 if dset._space_version == 1 else 4)
            self.write(at, struct.pack(f"<{len(dset._shape)}Q", *dset._shape))
        self.resized.clear()
        os.fsync(self.fd)


class _ChunkTree:
    """The version-1 B-tree chunk index of one dataset, loaded whole on its
    first in-place write, changed in memory and written back by
    :meth:`flush` (nodes keep their addresses; they are allocated whole, 2K
    entries). An insertion that fills a node splits it as the library does —
    the right-most node keeps 90% of its entries, the left-most 10%, any
    other half — and a root that splits keeps its address: its entries move
    to a new node and it becomes the parent of the two, a level up."""

    def __init__(self, edit: _Edit, dset: Dataset):
        self.edit, self.dset = edit, dset
        r = edit.r
        self.chunk = dset._layout[2]
        self.rank = len(self.chunk)
        self.item = dset._dtype.itemsize
        self.nbytes = int(np.prod(self.chunk)) * self.item
        self.two_k = 2 * r.chunk_k
        self.ksize = 8 + 8 * (self.rank + 1)
        self.node_bytes = 24 + 8 * self.two_k + self.ksize * (self.two_k + 1)
        self.unfiltered = not dset._filters
        fill = 0 if dset.fillvalue is None else dset.fillvalue
        self.fill = np.asarray(fill, dset._dtype)
        self.root = dset._layout[1]
        self.root_dirty = False
        self.nodes: Dict[int, list] = {}  # addr -> [level, keys, children, left, right]
        self.dirty: set = set()
        self.index: Dict[Tuple[int, ...], list] = {}  # chunk offsets -> [size, mask, addr]
        self.pending: Dict[Tuple[int, ...], np.ndarray] = {}  # chunks to write
        if self.root != UNDEF:
            self._load(self.root)

    def _load(self, addr: int) -> None:
        r = self.edit.r
        head = r.read(addr, 24)
        if head[:4] != b"TREE" or head[4] != 1:
            raise H5FormatError(f"{r.path}: bad chunk B-tree at {addr}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        left, right = struct.unpack_from("<QQ", head, 8)
        body = r.read(addr + 24, used * (self.ksize + 8) + self.ksize)
        keys, children = [], []
        for i in range(used + 1):
            k = i * (self.ksize + 8)
            keys.append(struct.unpack_from(f"<II{self.rank + 1}Q", body, k))
            if i < used:
                children.append(r._addr(body, k + self.ksize))
        self.nodes[addr] = [level, keys, children, left, right]
        for key, child in zip(keys, children):
            if level:
                self._load(child)
            else:
                self.index[tuple(key[2:2 + self.rank])] = [key[0], key[1], child]

    # -- chunk data --------------------------------------------------------
    def read_block(self, off) -> np.ndarray:
        if off in self.pending:
            return self.pending[off].copy()
        size, mask, addr = self.index[off]
        if not self._raw(mask) or size != self.nbytes:
            raise H5FormatError(f"{self.edit.r.path}: in-place write into a filtered "
                                f"chunk of {self.dset.name}")
        return np.frombuffer(self.edit.r.read(addr, size), self.dset._dtype).reshape(
            self.chunk).copy()

    def _raw(self, mask: int) -> bool:
        return self.unfiltered or all(mask & (1 << i) for i in range(len(self.dset._filters)))

    def write_block(self, off, block: np.ndarray) -> None:
        """A whole chunk: in place where it is stored, else at the end of
        the file and entered in the index. The bytes wait in memory for
        :meth:`write_data` (the commit's first step): a write block that
        fails before the commit leaves the file as it was."""
        data = np.ascontiguousarray(block, self.dset._dtype)
        if off in self.index:
            size, mask, addr = self.index[off]
            if not self._raw(mask) or size != self.nbytes:
                raise H5FormatError(f"{self.edit.r.path}: in-place write into a "
                                    f"filtered chunk of {self.dset.name}")
        else:
            if self.dset._filters:
                raise H5FormatError(f"{self.edit.r.path}: in-place write of a new chunk "
                                    f"of filtered dataset {self.dset.name}")
            addr = self.edit.alloc(self.nbytes)
            self.index[off] = [self.nbytes, 0, addr]
            self._insert((self.nbytes, 0) + tuple(off) + (0,), addr)
        self.pending[off] = data

    def write_data(self) -> None:
        """The pending chunks' bytes, in address order."""
        for off in sorted(self.pending, key=lambda o: self.index[o][2]):
            self.edit.write(self.index[off][2], self.pending[off])
        self.pending.clear()

    # -- the B-tree --------------------------------------------------------
    def _off(self, key) -> Tuple[int, ...]:
        return tuple(key[2:2 + self.rank])

    def _end(self, key) -> tuple:
        """The right key one chunk past ``key``, as the library writes a
        node's last key."""
        return (0, 0) + tuple(o + c for o, c in zip(self._off(key), self.chunk)) + (self.item,)

    def _new_node(self, level, keys, children, left=UNDEF, right=UNDEF) -> int:
        addr = self.edit.alloc(self.node_bytes)
        self.nodes[addr] = [level, keys, children, left, right]
        self.dirty.add(addr)
        return addr

    def _insert(self, key, child: int) -> None:
        if self.root == UNDEF:
            self.root = self._new_node(0, [key, self._end(key)], [child])
            self.root_dirty = True
            return
        split = self._insert_at(self.root, key, child)
        if split is None:
            return
        # the root split: its entries move to a new node, and the root (at
        # its address) becomes their parent, one level up
        level, keys, children, left, right = self.nodes[self.root]
        moved = self._new_node(level, keys, children, UNDEF, split[1])
        self.nodes[split[1]][3] = moved
        self.dirty.add(split[1])
        new_keys = [keys[0], split[0], self.nodes[split[1]][1][-1]]
        self.nodes[self.root] = [level + 1, new_keys, [moved, split[1]], UNDEF, UNDEF]
        self.dirty.add(self.root)

    def _insert_at(self, addr: int, key, child: int):
        """Insert into the subtree at ``addr``; returns ``(separator key,
        new node)`` where the node split, else None."""
        node = self.nodes[addr]
        level, keys, children = node[0], node[1], node[2]
        off = self._off(key)
        lefts = [self._off(k) for k in keys[:len(children)]]
        if level == 0:
            pos = sum(o < off for o in lefts)
            keys.insert(pos, key)
            children.insert(pos, child)
            if pos == len(children) - 1 and not off < self._off(keys[-1]):
                keys[-1] = self._end(key)
        else:
            i = max(0, sum(o <= off for o in lefts) - 1)
            split = self._insert_at(children[i], key, child)
            keys[i] = self.nodes[children[i]][1][0]
            if split is not None:
                keys.insert(i + 1, split[0])
                children.insert(i + 1, split[1])
            keys[-1] = self.nodes[children[-1]][1][-1]
        self.dirty.add(addr)
        if len(children) <= self.two_k:
            return None
        ratio = 0.9 if node[4] == UNDEF else 0.1 if node[3] == UNDEF else 0.5
        nleft = min(len(children) - 1, max(1, int(self.two_k * ratio)))
        new = self._new_node(level, keys[nleft:], children[nleft:], addr, node[4])
        if node[4] != UNDEF:
            self.nodes[node[4]][3] = new
            self.dirty.add(node[4])
        node[1], node[2], node[4] = keys[:nleft + 1], children[:nleft], new
        return keys[nleft], new

    def _pack(self, node) -> bytes:
        level, keys, children, left, right = node
        fmt = f"<II{self.rank + 1}Q"
        body = b"".join(struct.pack(fmt, *k) + struct.pack("<Q", c)
                        for k, c in zip(keys, children)) + struct.pack(fmt, *keys[-1])
        raw = b"TREE" + struct.pack("<BBHQQ", 1, level, len(children), left, right) + body
        return raw + bytes(self.node_bytes - len(raw))

    def flush(self) -> None:
        for addr in sorted(self.dirty):
            self.edit.write(addr, self._pack(self.nodes[addr]))
        self.dirty.clear()
        if self.root_dirty:
            # the layout message's chunk-index address (version 3, class 2)
            self.edit.write(self.dset._msg_at[0x08] + 3, struct.pack("<Q", self.root))
            self.root_dirty = False
