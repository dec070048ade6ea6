"""The dataset files (``train.parquet``, ``test.parquet``,
``item_brand.parquet``) without pandas or pyarrow.

The card's machine has neither, so the port reads and writes its parquet
files itself, with numpy and the standard library:

* ``read_columns(path)`` reads what pandas/pyarrow and ``write_columns``
  write for these files: flat columns of INT32 or INT64 (required or
  optional), data pages V1 and V2, SNAPPY or UNCOMPRESSED, PLAIN values or
  a PLAIN dictionary page with RLE_DICTIONARY / PLAIN_DICTIONARY data
  pages (and the PLAIN pages pyarrow falls back to when the dictionary
  outgrows its page limit), RLE definition levels, any number of row
  groups.  Anything else raises ``ValueError`` naming what it met (a codec,
  an encoding, a type, a nested schema, a null value); it never guesses.
* ``write_columns(path, columns)`` writes required INT32 / INT64 columns
  as PLAIN, UNCOMPRESSED pages in one row group; pandas reads the file
  back as the same frame.

SNAPPY pages, definition levels and dictionary indices are decoded by
``data/parquet_native.cpp``, built with g++ at first use
(``data/native_ext.py::build_library``); when it cannot be built or
loaded, reading such a page raises ``RuntimeError`` (PLAIN, UNCOMPRESSED
pages of required columns, what ``write_columns`` writes, need no
library).
The file layout follows the Apache Parquet format specification
(``parquet.thrift``: FileMetaData, PageHeader, ColumnMetaData), encoded
with Thrift's compact protocol.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"PAR1"

# parquet.thrift enums
_TYPES = {1: "INT32", 2: "INT64"}
_TYPE_NAMES = {0: "BOOLEAN", 1: "INT32", 2: "INT64", 3: "INT96", 4: "FLOAT",
               5: "DOUBLE", 6: "BYTE_ARRAY", 7: "FIXED_LEN_BYTE_ARRAY"}
_DTYPES = {"INT32": np.dtype("<i4"), "INT64": np.dtype("<i8")}
_CODECS = {0: "UNCOMPRESSED", 1: "SNAPPY", 2: "GZIP", 3: "LZO", 4: "BROTLI",
           5: "LZ4", 6: "ZSTD", 7: "LZ4_RAW"}
_ENCODINGS = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
              5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
              7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
_PLAIN, _PLAIN_DICTIONARY, _RLE, _RLE_DICTIONARY = 0, 2, 3, 8
_DATA_PAGE, _DICTIONARY_PAGE, _DATA_PAGE_V2 = 0, 2, 3
_REQUIRED, _OPTIONAL = 0, 1
# converted types that leave an INT32 / INT64 column a signed integer
_SIGNED_CONVERTED = {"INT32": (None, 17), "INT64": (None, 18)}  # INT_32, INT_64

# the writer's page size: values per data page
WRITE_PAGE_VALUES = 1 << 20


# ---------------------------------------------------------------------------
# Thrift compact protocol
# ---------------------------------------------------------------------------

_CT_STOP, _CT_TRUE, _CT_FALSE, _CT_BYTE, _CT_I16, _CT_I32, _CT_I64 = 0, 1, 2, 3, 4, 5, 6
_CT_DOUBLE, _CT_BINARY, _CT_LIST, _CT_SET, _CT_MAP, _CT_STRUCT = 7, 8, 9, 10, 11, 12


def _varint(buf, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        if pos >= len(buf):
            raise ValueError("parquet: truncated varint")
        b = buf[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7
        if shift > 63:
            raise ValueError("parquet: malformed varint")


def _zigzag(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _read_value(buf, pos: int, ctype: int):
    if ctype == _CT_TRUE:
        return True, pos
    if ctype == _CT_FALSE:
        return False, pos
    if ctype == _CT_BYTE:
        if pos >= len(buf):
            raise ValueError("parquet: truncated thrift byte")
        return struct.unpack_from("<b", buf, pos)[0], pos + 1
    if ctype in (_CT_I16, _CT_I32, _CT_I64):
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if ctype == _CT_DOUBLE:
        if pos + 8 > len(buf):
            raise ValueError("parquet: truncated thrift double")
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if ctype == _CT_BINARY:
        n, pos = _varint(buf, pos)
        if pos + n > len(buf):
            raise ValueError("parquet: truncated thrift binary")
        return bytes(buf[pos:pos + n]), pos + n
    if ctype in (_CT_LIST, _CT_SET):
        if pos >= len(buf):
            raise ValueError("parquet: truncated thrift list")
        head = buf[pos]
        pos += 1
        size, etype = head >> 4, head & 0x0F
        if size == 15:
            size, pos = _varint(buf, pos)
        out = []
        for _ in range(size):
            if etype in (_CT_TRUE, _CT_FALSE):  # a bool element is one byte
                out.append(buf[pos] == _CT_TRUE)
                pos += 1
            else:
                v, pos = _read_value(buf, pos, etype)
                out.append(v)
        return out, pos
    if ctype == _CT_MAP:
        size, pos = _varint(buf, pos)
        out = {}
        if size:
            kv = buf[pos]
            pos += 1
            for _ in range(size):
                k, pos = _read_value(buf, pos, kv >> 4)
                v, pos = _read_value(buf, pos, kv & 0x0F)
                out[k] = v
        return out, pos
    if ctype == _CT_STRUCT:
        return _read_struct(buf, pos)
    raise ValueError(f"parquet: unknown thrift compact type {ctype}")


def _read_struct(buf, pos: int) -> Tuple[Dict[int, object], int]:
    """A thrift struct as {field id: value}; nested structs likewise."""
    out: Dict[int, object] = {}
    last = 0
    while True:
        if pos >= len(buf):
            raise ValueError("parquet: truncated thrift struct")
        head = buf[pos]
        pos += 1
        ctype = head & 0x0F
        if ctype == _CT_STOP:
            return out, pos
        delta = head >> 4
        if delta:
            fid = last + delta
        else:
            v, pos = _varint(buf, pos)
            fid = _zigzag(v)
        out[fid], pos = _read_value(buf, pos, ctype)
        last = fid


class _Writer:
    """Thrift compact encoding of the few structs ``write_columns`` needs."""

    def __init__(self):
        self.out = bytearray()
        self._last: List[int] = [0]

    def _uvarint(self, v: int) -> None:
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def _int(self, v: int) -> None:
        self._uvarint((v << 1) ^ (v >> 63))

    def _field(self, fid: int, ctype: int) -> None:
        delta = fid - self._last[-1]
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ctype)
        else:
            self.out.append(ctype)
            self._int(fid)
        self._last[-1] = fid

    def i32(self, fid: int, v: int) -> None:
        self._field(fid, _CT_I32)
        self._int(int(v))

    def i64(self, fid: int, v: int) -> None:
        self._field(fid, _CT_I64)
        self._int(int(v))

    def binary(self, fid: int, v: bytes) -> None:
        self._field(fid, _CT_BINARY)
        self._uvarint(len(v))
        self.out += v

    def begin_struct(self, fid: Optional[int] = None) -> None:
        """A struct field (``fid``) or a list element (``fid`` None)."""
        if fid is not None:
            self._field(fid, _CT_STRUCT)
        self._last.append(0)

    def end_struct(self) -> None:
        self.out.append(_CT_STOP)
        self._last.pop()

    def begin_list(self, fid: int, etype: int, size: int) -> None:
        self._field(fid, _CT_LIST)
        if size < 15:
            self.out.append((size << 4) | etype)
        else:
            self.out.append(0xF0 | etype)
            self._uvarint(size)

    def list_binary(self, v: bytes) -> None:
        self._uvarint(len(v))
        self.out += v

    def list_i32(self, v: int) -> None:
        self._int(int(v))


# ---------------------------------------------------------------------------
# SNAPPY and the RLE / bit-packed hybrid (C++)
# ---------------------------------------------------------------------------

NATIVE_SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "parquet_native.cpp")
_SNAPPY_ERRORS = {-1: "truncated stream", -2: "copy offset out of range",
                  -3: "more output than declared", -4: "less output than declared",
                  -5: "malformed length preamble"}
_native = None
_native_lock = threading.Lock()


def _native_lib() -> ctypes.CDLL:
    """The decoders' library, built on first use.  Raises ``RuntimeError``
    when it cannot be built or loaded: there is no Python decoder."""
    global _native
    if _native is None:
        from gcn_recommendation_tpu_torch.data import native_ext

        with _native_lock:
            if _native is None:
                try:
                    lib = ctypes.CDLL(native_ext.build_library(source=NATIVE_SOURCE))
                except (OSError, RuntimeError) as e:
                    raise RuntimeError(f"parquet: the native decoder did not build: {e}") from e
                u8p, i64 = ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64
                lib.pq_snappy_length.argtypes = [u8p, i64]
                lib.pq_snappy_length.restype = i64
                lib.pq_snappy_decompress.argtypes = [u8p, i64, u8p, i64]
                lib.pq_snappy_decompress.restype = i64
                lib.pq_decode_hybrid.argtypes = [
                    u8p, i64, ctypes.c_int, i64, ctypes.POINTER(ctypes.c_uint32)]
                lib.pq_decode_hybrid.restype = i64
                _native = lib
    return _native


def snappy_decompress(data) -> bytes:
    """One SNAPPY block (a whole page body) decompressed."""
    lib = _native_lib()
    src = np.frombuffer(data, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    sp = src.ctypes.data_as(u8p)
    n = lib.pq_snappy_length(sp, len(src))
    if n < 0:
        raise ValueError(f"parquet: bad SNAPPY page: {_SNAPPY_ERRORS.get(n, n)}")
    dst = np.empty(n, dtype=np.uint8)
    got = lib.pq_snappy_decompress(sp, len(src), dst.ctypes.data_as(u8p), n)
    if got < 0:
        raise ValueError(f"parquet: bad SNAPPY page: {_SNAPPY_ERRORS.get(got, got)}")
    return dst.tobytes()


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _decode_hybrid(buf, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE / bit-packed hybrid encoding in
    ``buf[pos:end]``, as uint32 (``data/parquet_native.cpp``)."""
    lib = _native_lib()
    src = np.frombuffer(buf, dtype=np.uint8, count=max(0, end - pos), offset=pos)
    out = np.empty(count, dtype=np.uint32)
    got = lib.pq_decode_hybrid(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(src),
                               int(bit_width), count,
                               out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    if got < 0:
        raise ValueError("parquet: bad RLE/bit-packed run: "
                         + ("bit width out of range" if got == -6 else "truncated"))
    return out


class _Column:
    def __init__(self, name: str, ptype: str, optional: bool):
        self.name, self.ptype, self.optional = name, ptype, optional
        self.dtype = _DTYPES[ptype]


def _schema(meta) -> List[_Column]:
    elems = meta.get(2) or []
    if not elems:
        raise ValueError("parquet: empty schema")
    root, leaves = elems[0], elems[1:]
    if root.get(5, 0) != len(leaves):
        raise ValueError("parquet: nested schema (only flat columns are read)")
    cols = []
    for e in leaves:
        name = e.get(4, b"").decode()
        if e.get(5):
            raise ValueError(f"parquet: column {name!r} is nested")
        ptype = e.get(1)
        if ptype not in _TYPES:
            raise ValueError(f"parquet: column {name!r} has type "
                             f"{_TYPE_NAMES.get(ptype, ptype)} (only INT32 and INT64 are read)")
        ptype = _TYPES[ptype]
        conv = e.get(6)
        logical = e.get(10)
        if conv not in _SIGNED_CONVERTED[ptype] or (
            logical is not None and not (
                10 in logical and logical[10].get(2) is True
                and logical[10].get(1) == (32 if ptype == "INT32" else 64))):
            raise ValueError(f"parquet: column {name!r} ({ptype}) has converted type {conv} / "
                             f"logical type {logical} (only plain signed integers are read)")
        rep = e.get(3, _REQUIRED)
        if rep not in (_REQUIRED, _OPTIONAL):
            raise ValueError(f"parquet: column {name!r} is repeated")
        cols.append(_Column(name, ptype, rep == _OPTIONAL))
    return cols


def _page_body(data: bytes, codec: int, uncompressed: int) -> bytes:
    if codec == 0:
        body = data
    elif codec == 1:
        body = snappy_decompress(data)
    else:
        raise ValueError(f"parquet: codec {_CODECS.get(codec, codec)} "
                         "(only SNAPPY and UNCOMPRESSED are read)")
    if len(body) != uncompressed:
        raise ValueError(f"parquet: page is {len(body)} bytes, header says {uncompressed}")
    return body


def _check_no_nulls(levels: np.ndarray, col: _Column) -> None:
    if len(levels) and levels.min() == 0:
        raise ValueError(f"parquet: column {col.name!r} holds a null value")


def _decode_values(body, pos: int, encoding: int, n: int, col: _Column,
                   dictionary: Optional[np.ndarray]) -> np.ndarray:
    if encoding == _PLAIN:
        if pos + n * col.dtype.itemsize > len(body):
            raise ValueError(f"parquet: column {col.name!r}: PLAIN page too short")
        return np.frombuffer(body, dtype=col.dtype, count=n, offset=pos)
    if encoding in (_RLE_DICTIONARY, _PLAIN_DICTIONARY):
        if dictionary is None:
            raise ValueError(f"parquet: column {col.name!r}: dictionary page missing")
        if n == 0:
            return dictionary[:0]
        if pos >= len(body):
            raise ValueError(f"parquet: column {col.name!r}: dictionary indices missing")
        idx = _decode_hybrid(body, pos + 1, len(body), body[pos], n)
        if len(idx) and int(idx.max()) >= len(dictionary):
            raise ValueError(f"parquet: column {col.name!r}: dictionary index out of range")
        return dictionary[idx]
    raise ValueError(f"parquet: column {col.name!r}: encoding "
                     f"{_ENCODINGS.get(encoding, encoding)} (only PLAIN and "
                     "RLE_DICTIONARY / PLAIN_DICTIONARY are read)")


def _read_chunk(buf: memoryview, chunk, col: _Column) -> np.ndarray:
    meta = chunk.get(3)
    if meta is None or chunk.get(1):
        raise ValueError(f"parquet: column {col.name!r}: chunk metadata missing or in another file")
    codec = meta.get(4, 0)
    total = meta.get(5, 0)
    start = meta.get(11) or meta.get(9)
    end = start + meta.get(7, 0)
    if end > len(buf):
        raise ValueError(f"parquet: column {col.name!r}: chunk runs past the file's end")
    dictionary = None
    parts = []
    seen = 0
    pos = start
    while seen < total:
        if pos >= end:
            raise ValueError(f"parquet: column {col.name!r}: {seen} of {total} values found")
        head, pos = _read_struct(buf, pos)
        ptype, usize, csize = head.get(1), head.get(2, 0), head.get(3, 0)
        if pos + csize > end:
            raise ValueError(f"parquet: column {col.name!r}: page runs past its chunk")
        raw = buf[pos:pos + csize]
        pos += csize
        if ptype == _DICTIONARY_PAGE:
            dh = head.get(7, {})
            if dh.get(2, _PLAIN) not in (_PLAIN, _PLAIN_DICTIONARY):
                raise ValueError(f"parquet: column {col.name!r}: dictionary page encoding "
                                 f"{_ENCODINGS.get(dh.get(2), dh.get(2))}")
            body = _page_body(raw, codec, usize)
            n = dh.get(1, 0)
            if n * col.dtype.itemsize > len(body):
                raise ValueError(f"parquet: column {col.name!r}: dictionary page too short")
            dictionary = np.frombuffer(body, dtype=col.dtype, count=n)
        elif ptype == _DATA_PAGE:
            dh = head.get(5, {})
            n, enc = dh.get(1, 0), dh.get(2, _PLAIN)
            body = _page_body(raw, codec, usize)
            vpos = 0
            if col.optional:
                if dh.get(3, _RLE) != _RLE:
                    raise ValueError(f"parquet: column {col.name!r}: definition levels "
                                     f"encoded {_ENCODINGS.get(dh.get(3), dh.get(3))}")
                if len(body) < 4:
                    raise ValueError(f"parquet: column {col.name!r}: definition levels missing")
                nlev = struct.unpack_from("<i", body, 0)[0]
                _check_no_nulls(_decode_hybrid(body, 4, 4 + nlev, 1, n), col)
                vpos = 4 + nlev
            parts.append(_decode_values(body, vpos, enc, n, col, dictionary))
            seen += n
        elif ptype == _DATA_PAGE_V2:
            dh = head.get(8, {})
            n, nulls, enc = dh.get(1, 0), dh.get(2, 0), dh.get(4, _PLAIN)
            dlen, rlen = dh.get(5, 0), dh.get(6, 0)
            if nulls:
                raise ValueError(f"parquet: column {col.name!r} holds a null value")
            if rlen:
                raise ValueError(f"parquet: column {col.name!r} has repetition levels")
            if col.optional and dlen:
                _check_no_nulls(_decode_hybrid(raw, 0, dlen, 1, n), col)
            values = raw[dlen:]
            if dh.get(7, True):
                body = _page_body(values, codec, usize - dlen - rlen)
            else:
                body = bytes(values)
            parts.append(_decode_values(body, 0, enc, n, col, dictionary))
            seen += n
        else:
            raise ValueError(f"parquet: column {col.name!r}: page type {ptype}")
    if seen != total:
        raise ValueError(f"parquet: column {col.name!r}: pages hold {seen} values, chunk says {total}")
    return np.concatenate(parts) if parts else np.empty(0, col.dtype)


def read_columns(path: str) -> Dict[str, np.ndarray]:
    """Every column of a parquet file, by name, as native-endian numpy
    arrays (int32 for INT32, int64 for INT64).  Raises ``ValueError`` on
    anything this reader does not support."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != MAGIC or data[-4:] != MAGIC:
        raise ValueError(f"parquet: {path} is not a parquet file")
    flen = struct.unpack_from("<I", data, len(data) - 8)[0]
    if flen + 12 > len(data):
        raise ValueError(f"parquet: {path}: footer length {flen} out of range")
    buf = memoryview(data)
    meta, _ = _read_struct(buf, len(data) - 8 - flen)
    cols = _schema(meta)
    groups = meta.get(4) or []
    out = {}
    for j, col in enumerate(cols):
        parts = []
        for g in groups:
            chunks = g.get(1) or []
            if len(chunks) != len(cols):
                raise ValueError(f"parquet: {path}: a row group has {len(chunks)} "
                                 f"columns, the schema {len(cols)}")
            part = _read_chunk(buf, chunks[j], col)
            if len(part) != g.get(3, 0):
                raise ValueError(f"parquet: column {col.name!r}: {len(part)} values in "
                                 f"a row group of {g.get(3, 0)} rows")
            parts.append(part)
        arr = np.concatenate(parts) if parts else np.empty(0, col.dtype)
        out[col.name] = arr.astype(col.dtype.newbyteorder("="), copy=False)
    n_rows = meta.get(3, 0)
    for name, arr in out.items():
        if len(arr) != n_rows:
            raise ValueError(f"parquet: column {name!r} has {len(arr)} values, the file {n_rows} rows")
    return out


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def write_columns(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write equal-length 1-D int32 / int64 arrays as a parquet file
    (required columns, PLAIN, UNCOMPRESSED, one row group, pages of at
    most ``WRITE_PAGE_VALUES`` values).  Written to a temporary name and
    moved into place."""
    arrays = {}
    for name, a in columns.items():
        a = np.asarray(a)
        if a.ndim != 1 or a.dtype not in (np.int32, np.int64):
            raise ValueError(f"parquet: column {name!r} must be 1-D int32 or int64, "
                             f"got {a.dtype} {a.shape}")
        arrays[name] = np.ascontiguousarray(a, dtype=a.dtype.newbyteorder("<"))
    lengths = {len(a) for a in arrays.values()}
    if len(lengths) > 1:
        raise ValueError(f"parquet: columns have different lengths {sorted(lengths)}")
    n_rows = lengths.pop() if lengths else 0

    body = bytearray(MAGIC)
    chunks = []  # (name, ptype, offset, size)
    for name, a in arrays.items():
        ptype = 1 if a.dtype == np.int32 else 2
        offset = len(body)
        for lo in range(0, n_rows, WRITE_PAGE_VALUES) if n_rows else [0]:
            page = a[lo:lo + WRITE_PAGE_VALUES].tobytes()
            h = _Writer()
            h.begin_struct()
            h.i32(1, _DATA_PAGE)
            h.i32(2, len(page))
            h.i32(3, len(page))
            h.begin_struct(5)
            h.i32(1, len(page) // a.dtype.itemsize)
            h.i32(2, _PLAIN)
            h.i32(3, _RLE)
            h.i32(4, _RLE)
            h.end_struct()
            h.end_struct()
            body += h.out
            body += page
        chunks.append((name, ptype, offset, len(body) - offset))

    m = _Writer()
    m.begin_struct()
    m.i32(1, 1)  # version
    m.begin_list(2, _CT_STRUCT, len(arrays) + 1)
    m.begin_struct()
    m.binary(4, b"schema")
    m.i32(5, len(arrays))
    m.end_struct()
    for name, ptype, _, _ in chunks:
        m.begin_struct()
        m.i32(1, ptype)
        m.i32(3, _REQUIRED)
        m.binary(4, name.encode())
        m.end_struct()
    m.i64(3, n_rows)
    m.begin_list(4, _CT_STRUCT, 1)
    m.begin_struct()
    m.begin_list(1, _CT_STRUCT, len(chunks))
    for name, ptype, offset, size in chunks:
        m.begin_struct()
        m.i64(2, offset)  # file_offset
        m.begin_struct(3)
        m.i32(1, ptype)
        m.begin_list(2, _CT_I32, 2)
        m.list_i32(_PLAIN)
        m.list_i32(_RLE)
        m.begin_list(3, _CT_BINARY, 1)
        m.list_binary(name.encode())
        m.i32(4, 0)  # UNCOMPRESSED
        m.i64(5, n_rows)
        m.i64(6, size)
        m.i64(7, size)
        m.i64(9, offset)
        m.end_struct()
        m.end_struct()
    m.i64(2, sum(c[3] for c in chunks))
    m.i64(3, n_rows)
    m.end_struct()
    m.binary(6, b"gcn_recommendation_tpu_torch parquet writer")
    m.end_struct()

    body += m.out
    body += struct.pack("<I", len(m.out))
    body += MAGIC
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        f.write(body)
    os.replace(tmp, path)
