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
``resize`` such a dataset and append to the file. A file opened for writing
is held in memory and written out whole on ``close()``, through a temporary
file renamed over the target, so a reader never sees a torn file. Datasets
may be resized in memory, chunked ones up to their ``maxshape``; a file
opened ``"r+"`` keeps each dataset's layout, maximum shape and fill value.
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


# ---------------------------------------------------------------------------
# reading

class _Reader:
    """Parses one open file; addresses are relative to the superblock."""

    def __init__(self, path: str):
        self.path = path
        self.fh = open(path, "rb")
        try:
            self._superblock()
        except BaseException:
            self.fh.close()
            raise

    def close(self) -> None:
        self.fh.close()

    def read(self, addr: int, n: int) -> bytes:
        self.fh.seek(self.base + addr)
        data = self.fh.read(n)
        if len(data) != n:
            raise H5FormatError(f"{self.path}: truncated at address {addr}")
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
        version = head[0]
        if version in (0, 1):
            self.so, self.sl = head[5], head[6]
            pos = 8 + 16 + (4 if version == 1 else 0)
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
        if self.read(addr, 4) == b"OHDR":
            return self._messages_v2(addr)
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
                pos += 8 + msize
                self._collect(mtype, mflags, data, out, blocks)
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
        out: Dict[str, object] = {}
        for mtype, data in msgs:
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
            out[name] = self._value(self.dtype(tdata), self.dtype_size(tdata), shape, data[pos:])
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
    def __init__(self, values: Dict[str, object], writable: bool):
        self._values = values
        self._writable = writable

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
                 fillvalue=None):
        self.name = name
        self._writable = writable
        self.maxshape, self.chunks, self.fillvalue = maxshape, chunks, fillvalue
        if data is not None:
            self._data = np.ascontiguousarray(data)
            self.attrs = AttributeManager({}, writable)
            return
        self._data = None
        self._reader = reader
        info = dict(msgs)
        shape = reader.shape(info[0x01])
        if shape is None or 0x03 not in info or 0x08 not in info:
            raise H5FormatError(f"{reader.path}: {name} is not a plain dataset")
        dt = reader.dtype(info[0x03])
        if not isinstance(dt, np.dtype):
            raise H5FormatError(f"{reader.path}: {name} has a variable-length type")
        self._shape, self._dtype = shape, dt
        self._layout = reader.layout(info[0x08], len(shape))
        self._filters = reader.filters(info[0x0B]) if 0x0B in info else []
        self.attrs = AttributeManager(reader.attributes(msgs), writable)
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
        r, (_, addr, chunk) = self._reader, self._layout
        out = np.full(self._shape, 0 if self.fillvalue is None else self.fillvalue, self.dtype)
        if addr == UNDEF:
            return out
        for offset, size, mask, caddr in r.chunks(addr, len(chunk)):
            raw = r.read(caddr, size)
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
            block = np.frombuffer(raw, self._dtype, count=int(np.prod(chunk))).reshape(chunk)
            dst = tuple(slice(o, min(o + c, s)) for o, c, s in zip(offset, chunk, self._shape))
            src = tuple(slice(0, d.stop - d.start) for d in dst)
            out[dst] = block[src]
        return out

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
        return np.array(self._read_all()[key])

    def __array__(self, dtype=None, copy=None):
        arr = self._data if self._data is not None else self._read_all()
        return np.asarray(arr, dtype=dtype)

    def _require_writable(self) -> None:
        if not self._writable:
            raise OSError("the file is open read-only")

    def __setitem__(self, key, value) -> None:
        self._require_writable()
        self._data[key] = value

    def resize(self, shape) -> None:
        """New rows hold the fill value (0 where none is defined). A chunked
        dataset grows only within its ``maxshape``."""
        self._require_writable()
        shape = tuple(int(s) for s in shape)
        if self.maxshape is not None and (len(shape) != len(self.maxshape) or any(
                m is not None and n > m for n, m in zip(shape, self.maxshape))):
            raise ValueError(f"{self.name}: shape {shape} exceeds maxshape {self.maxshape}")
        fill = 0 if self.fillvalue is None else self.fillvalue
        new = np.full(shape, fill, self._data.dtype)
        common = tuple(slice(0, min(a, b)) for a, b in zip(shape, self._data.shape))
        new[common] = self._data[common]
        self._data = new


class Group:
    def __init__(self, name: str, *, reader=None, addr: Optional[int] = None,
                 writable: bool = False):
        self.name = name
        self._writable = writable
        self._children: Dict[str, object] = {}
        if reader is None:
            self.attrs = AttributeManager({}, writable)
            return
        msgs = reader.messages(addr)
        self.attrs = AttributeManager(reader.attributes(msgs), writable)
        for child, caddr in reader.links(msgs).items():
            self._children[child] = (reader, caddr)  # opened on first use

    def _child(self, name: str):
        obj = self._children[name]
        if isinstance(obj, tuple):
            reader, addr = obj
            msgs = reader.messages(addr)
            path = f"{self.name.rstrip('/')}/{name}"
            if all(t != 0x08 for t, _ in msgs):  # no data layout: a group
                obj = Group(path, reader=reader, addr=addr, writable=self._writable)
            else:
                obj = Dataset(path, reader=reader, msgs=msgs, writable=self._writable)
                if self._writable:  # files opened for writing live in memory
                    obj = _in_memory(obj)
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
        return grp

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
        return dset


def _in_memory(dset: Dataset) -> Dataset:
    out = Dataset(dset.name, data=np.asarray(dset), writable=True, maxshape=dset.maxshape,
                  chunks=dset.chunks, fillvalue=dset.fillvalue)
    out.attrs = AttributeManager(dict(dset.attrs._values), True)
    return out


class File(Group):
    """``mode``: "r" (read, lazily), "w" (create or truncate) or "r+" (read
    and write an existing file)."""

    def __init__(self, path, mode: str = "r"):
        self.filename = os.fspath(path)
        self.mode = mode
        self._reader = None
        if mode not in ("r", "w", "r+"):
            raise ValueError(f"mode {mode!r}")
        writable = mode != "r"
        if mode == "w":
            super().__init__("/", writable=True)
            return
        reader = self._reader = _Reader(self.filename)
        try:
            super().__init__("/", reader=reader, addr=reader.root, writable=writable)
            if writable:  # a file opened for writing lives in memory
                self._load_all(self)
        except BaseException:
            reader.close()
            raise
        if writable:
            reader.close()
            self._reader = None

    def _load_all(self, group: Group) -> None:
        for name in list(group._children):
            obj = group._child(name)
            if isinstance(obj, Group):
                self._load_all(obj)

    def close(self) -> None:
        if self._reader is not None:
            self._reader.close()
            self._reader = None
        elif self._writable:
            _write_file(self.filename, self)
            self._writable = False

    def __enter__(self) -> "File":
        return self

    def __exit__(self, exc_type, *exc) -> None:
        if exc_type is not None and self._reader is None:
            self._writable = False  # leave the previous file untouched
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


def _write_file(path: str, root: Group) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as out:
            out.write(bytes(96))  # superblock, written last
            strings = _strings(root, [])
            table: Dict[str, Tuple[int, int]] = {}
            if strings:
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
                table = {s: (caddr, i) for i, s in enumerate(strings, start=1)}
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
