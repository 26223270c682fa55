"""OCDBT, the key-value store under orbax checkpoints (tensorstore's
"Optionally-Cooperative Distributed B+Tree"), read and written without
tensorstore.

A database is a directory. Its `manifest.ocdbt` holds the config and the
version list; each version names the root of a B+tree whose nodes and
values live in data files (`d/<name>`, or another database's, such as
`ocdbt.process_0/d/<name>`: a data file id is a base path and a relative
path under the manifest's directory). Values up to the config's
`max_inline_value_bytes` may sit in their leaf instead.

Every manifest and node file starts with a big-endian magic, its own length
(u64 LE), a format version and a compression varint (0 none, 1 zstd), and
ends with a CRC-32C (LE) of all bytes before it; the body between is one zstd
frame when compressed. All integers in a body are LEB128 varints unless said
otherwise, and lists are stored column by column. Keys in a node are
prefix-compressed against the previous key and are relative to the node's
prefix: an interior entry's child has the prefix parent_prefix +
key[:subtree_common_prefix_length].

The codecs (zstd, CRC-32C) are knnsvc_torch/csrc/orbax_io.cc, built with the
host compiler at first use and bound here with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import struct
import time
import uuid as uuid_mod
from typing import Callable

import numpy as np

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
# orbax's settings (what save_train_state's databases hold)
MAX_INLINE_VALUE_BYTES = 1024
MAX_DECODED_NODE_BYTES = 100_000_000
VERSION_TREE_ARITY_LOG2 = 4
_ERR = 512

_lib = None


def orbax_io() -> ctypes.CDLL:
    """The loaded codec library, built on first use."""
    global _lib
    if _lib is None:
        from knnsvc_torch.ops.build import build_host_library

        lib = ctypes.CDLL(str(build_host_library("orbax_io")))
        vp, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.knnsvc_zstd_decode.restype = ctypes.c_int
        lib.knnsvc_zstd_decode.argtypes = [vp, i64, vp, i64, ctypes.c_char_p, i64]
        lib.knnsvc_zstd_decode_alloc.restype = ctypes.c_int
        lib.knnsvc_zstd_decode_alloc.argtypes = [vp, i64, i64, ctypes.POINTER(vp),
                                                 ctypes.POINTER(i64), ctypes.c_char_p, i64]
        lib.knnsvc_orbax_free.restype = None
        lib.knnsvc_orbax_free.argtypes = [vp]
        lib.knnsvc_zstd_raw_size.restype = i64
        lib.knnsvc_zstd_raw_size.argtypes = [i64]
        lib.knnsvc_zstd_write_raw.restype = i64
        lib.knnsvc_zstd_write_raw.argtypes = [vp, i64, vp, i64]
        lib.knnsvc_crc32c.restype = ctypes.c_uint32
        lib.knnsvc_crc32c.argtypes = [vp, i64]
        _lib = lib
    return _lib


def _addr(buf) -> tuple[object, int, object]:
    """(pointer argument, length, object to keep alive) of bytes or an array."""
    if isinstance(buf, bytes):
        return buf, len(buf), buf
    a = np.ascontiguousarray(buf).view(np.uint8).reshape(-1)
    return a.ctypes.data, a.size, a


def crc32c(buf) -> int:
    ptr, n, _keep = _addr(buf)
    return int(orbax_io().knnsvc_crc32c(ptr, n))


def zstd_decode_into(src, out: np.ndarray) -> None:
    """Decode the zstd frames of `src` into the C-contiguous array `out`,
    which they must fill exactly; ValueError on anything else."""
    if not out.flags.c_contiguous:
        raise ValueError("zstd_decode_into needs a C-contiguous output array")
    ptr, n, _keep = _addr(src)
    err = ctypes.create_string_buffer(_ERR)
    if orbax_io().knnsvc_zstd_decode(ptr, n, out.ctypes.data, out.nbytes, err, _ERR):
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")


def zstd_decode(src, limit: int) -> bytes:
    """Decode the zstd frames of `src` (of unknown decoded size, at most
    `limit` bytes)."""
    ptr, n, _keep = _addr(src)
    lib = orbax_io()
    out, out_len = ctypes.c_void_p(), ctypes.c_int64()
    err = ctypes.create_string_buffer(_ERR)
    if lib.knnsvc_zstd_decode_alloc(ptr, n, limit, ctypes.byref(out), ctypes.byref(out_len),
                                    err, _ERR):
        raise ValueError(f"zstd: {err.value.decode(errors='replace')}")
    try:
        return ctypes.string_at(out, out_len.value) if out_len.value else b""
    finally:
        lib.knnsvc_orbax_free(out)


def zstd_frame(data) -> np.ndarray:
    """One zstd frame of raw blocks holding `data` (bytes or an array), as a
    uint8 array."""
    ptr, n, _keep = _addr(data)
    lib = orbax_io()
    out = np.empty(lib.knnsvc_zstd_raw_size(n), np.uint8)
    if lib.knnsvc_zstd_write_raw(ptr, n, out.ctypes.data, out.size) != out.size:
        raise RuntimeError("zstd frame writer: size mismatch")
    return out


# ------------------------------------------------------------------ encoding


class _Reader:
    def __init__(self, data: bytes, what: str):
        self.b, self.i, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.i + n > len(self.b):
            raise ValueError(f"OCDBT {self.what}: truncated")

    def varint(self) -> int:
        r = shift = 0
        while True:
            self._need(1)
            c = self.b[self.i]
            self.i += 1
            r |= (c & 0x7F) << shift
            shift += 7
            if c < 0x80:
                return r
            if shift > 63:
                raise ValueError(f"OCDBT {self.what}: varint too long")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def raw(self, n: int) -> bytes:
        self._need(n)
        r = self.b[self.i:self.i + n]
        self.i += n
        return r

    def u8(self) -> int:
        return self.raw(1)[0]

    def end(self) -> None:
        if self.i != len(self.b):
            raise ValueError(f"OCDBT {self.what}: {len(self.b) - self.i} bytes after the end")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        c = v & 0x7F
        v >>= 7
        if v:
            out.append(c | 0x80)
        else:
            out.append(c)
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _common_prefix(a: bytes, b: bytes) -> int:
    n = min(len(a), len(b))
    i = 0
    while i < n and a[i] == b[i]:
        i += 1
    return i


def _read_prefixed(r: _Reader, n: int, extra_columns: int = 0
                   ) -> tuple[list[bytes], list[list[int]]]:
    """n prefix-compressed keys: prefix lengths (of keys 1..n-1), suffix
    lengths, `extra_columns` more varint columns, then the suffix bytes."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    extra = [r.varints(n) for _ in range(extra_columns)]
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        if p > len(prev):
            raise ValueError(f"OCDBT {r.what}: key prefix longer than the previous key")
        prev = prev[:p] + r.raw(s)
        keys.append(prev)
    return keys, extra


def _write_prefixed(keys: list[bytes]) -> bytes:
    """A leaf's keys, as _read_prefixed reads them."""
    prefix = [_common_prefix(keys[i - 1], keys[i]) for i in range(1, len(keys))]
    return b"".join([_varints(prefix), _varints(len(k) - p for k, p in zip(keys, [0] + prefix))]
                    + [k[p:] for k, p in zip(keys, [0] + prefix)])


@dataclasses.dataclass(frozen=True)
class DataFile:
    base_path: str
    relative_path: str

    def path(self, root: str) -> str:
        rel = self.base_path + self.relative_path
        parts = rel.split("/")
        if rel.startswith("/") or ".." in parts or "" in parts[:-1] or not parts[-1]:
            raise ValueError(f"OCDBT: data file path {rel!r} leaves the database")
        return os.path.join(root, *parts)


def _read_file_table(r: _Reader) -> list[DataFile]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    base = r.varints(n)
    files, prev = [], b""
    for p, s, b in zip(prefix, suffix, base):
        if p > len(prev):
            raise ValueError(f"OCDBT {r.what}: path prefix longer than the previous path")
        prev = prev[:p] + r.raw(s)
        if b > len(prev):
            raise ValueError(f"OCDBT {r.what}: base path longer than the path")
        files.append(DataFile(prev[:b].decode(), prev[b:].decode()))
    return files


def _write_file_table(files: list[DataFile]) -> bytes:
    paths = [(f.base_path + f.relative_path).encode() for f in files]
    prefix = [_common_prefix(paths[i - 1], paths[i]) for i in range(1, len(paths))]
    return b"".join([_varint(len(files)), _varints(prefix),
                     _varints(len(p) - q for p, q in zip(paths, [0] + prefix)),
                     _varints(len(f.base_path.encode()) for f in files)]
                    + [p[q:] for p, q in zip(paths, [0] + prefix)])


def _unwrap(data: bytes, magic: int, what: str) -> bytes:
    """Check a manifest or node file's magic, length and CRC-32C -> its
    decoded body."""
    if len(data) < 4 + 8 + 2 + 4:
        raise ValueError(f"OCDBT {what}: {len(data)} bytes is too short")
    if struct.unpack(">I", data[:4])[0] != magic:
        raise ValueError(f"OCDBT {what}: bad magic {data[:4].hex()}")
    if struct.unpack("<Q", data[4:12])[0] != len(data):
        raise ValueError(f"OCDBT {what}: length field {struct.unpack('<Q', data[4:12])[0]} "
                         f"!= {len(data)} bytes")
    if crc32c(data[:-4]) != struct.unpack("<I", data[-4:])[0]:
        raise ValueError(f"OCDBT {what}: CRC-32C mismatch")
    r = _Reader(data[:-4], what)
    r.i = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise NotImplementedError(f"OCDBT {what}: format version {version}")
    body = data[r.i:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd_decode(body, MAX_DECODED_NODE_BYTES * 4)
    raise NotImplementedError(f"OCDBT {what}: compression format {compression}")


def _wrap(body: bytes, magic: int) -> bytes:
    """Header, the body as one raw-block zstd frame, CRC-32C."""
    payload = _varint(0) + _varint(1) + zstd_frame(body).tobytes()
    head = struct.pack(">I", magic) + struct.pack("<Q", 4 + 8 + len(payload) + 4)
    data = head + payload
    return data + struct.pack("<I", crc32c(data))


# ------------------------------------------------------------------ reading


@dataclasses.dataclass(frozen=True)
class ValueRef:
    """An indirect value: `length` bytes at `offset` of a data file."""
    file: DataFile
    offset: int
    length: int


@dataclasses.dataclass
class Manifest:
    """The newest version of a database."""
    root: ValueRef | None     # None: the empty tree
    root_height: int
    num_keys: int


def read_manifest(root: str) -> Manifest:
    """The newest version of the database at `root`."""
    path = os.path.join(root, "manifest.ocdbt")
    with open(path, "rb") as f:
        data = f.read()
    r = _Reader(_unwrap(data, MANIFEST_MAGIC, path), path)
    r.raw(16)                      # uuid
    kind = r.varint()
    if kind != 0:
        raise NotImplementedError(f"OCDBT {path}: numbered manifests (kind {kind})")
    r.varint()                     # max inline value bytes
    r.varint()                     # max decoded node bytes
    r.u8()                         # version tree arity, log2
    method = r.varint()
    if method == 1:
        r.raw(4)                   # zstd level, int32 LE
    elif method != 0:
        raise NotImplementedError(f"OCDBT {path}: compression method {method}")
    files = _read_file_table(r)
    n = r.varint()
    gen, height, fid, off, length, keys, _tree_bytes, _value_bytes = (r.varints(n)
                                                                       for _ in range(8))
    r.raw(8 * n)                   # commit times, u64 LE
    n_nodes = r.varint()           # older versions, in version tree nodes: not read
    for _ in range(5):
        r.varints(n_nodes)
    r.raw(8 * n_nodes)
    r.raw(n_nodes)
    r.end()
    if n == 0:
        raise ValueError(f"OCDBT {path}: no version")
    k = max(range(n), key=lambda i: gen[i])
    ref = None
    if length[k]:
        if fid[k] >= len(files):
            raise ValueError(f"OCDBT {path}: data file id {fid[k]} out of range")
        ref = ValueRef(files[fid[k]], off[k], length[k])
    return Manifest(ref, height[k], keys[k])


def _read_ref(root: str, ref: ValueRef) -> bytes:
    with open(ref.file.path(root), "rb") as f:
        f.seek(ref.offset)
        data = f.read(ref.length)
    if len(data) != ref.length:
        raise ValueError(f"OCDBT: {ref.file.path(root)} ends before byte "
                         f"{ref.offset + ref.length}")
    return data


def _walk(root: str, ref: ValueRef, height: int, prefix: bytes,
          out: dict[bytes, bytes | ValueRef]) -> None:
    what = f"node {ref.file.relative_path}@{ref.offset}"
    r = _Reader(_unwrap(_read_ref(root, ref), NODE_MAGIC, what), what)
    h = r.u8()
    if h != height:
        raise ValueError(f"OCDBT {what}: height {h}, its parent says {height}")
    files = _read_file_table(r)
    n = r.varint()
    if h > 0:
        keys, (common,) = _read_prefixed(r, n, 1)
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        r.varints(3 * n)           # statistics: keys, tree bytes, indirect value bytes
        r.end()
        for i in range(n):
            if fid[i] >= len(files) or common[i] > len(keys[i]):
                raise ValueError(f"OCDBT {what}: bad child reference")
            _walk(root, ValueRef(files[fid[i]], off[i], length[i]), h - 1,
                  prefix + keys[i][:common[i]], out)
        return
    keys, _ = _read_prefixed(r, n)
    length = r.varints(n)
    kind = r.varints(n)
    if any(k not in (0, 1) for k in kind):
        raise ValueError(f"OCDBT {what}: unknown value kind")
    indirect = [i for i in range(n) if kind[i] == 1]
    fid, off = r.varints(len(indirect)), r.varints(len(indirect))
    refs = {}
    for j, i in enumerate(indirect):
        if fid[j] >= len(files):
            raise ValueError(f"OCDBT {what}: data file id {fid[j]} out of range")
        refs[i] = ValueRef(files[fid[j]], off[j], length[i])
    for i in range(n):
        out[prefix + keys[i]] = refs[i] if kind[i] == 1 else r.raw(length[i])
    r.end()


class Database:
    """A read-only view of the newest version of the database at `root`:
    `keys()`, `read(key)`, and `ref(key)` for the indirect values."""

    def __init__(self, root: str):
        self.root = str(root)
        self.manifest = read_manifest(self.root)
        self._entries: dict[bytes, bytes | ValueRef] = {}
        if self.manifest.root is not None:
            _walk(self.root, self.manifest.root, self.manifest.root_height, b"", self._entries)
        if len(self._entries) != self.manifest.num_keys:
            raise ValueError(f"OCDBT {self.root}: {len(self._entries)} keys, the manifest "
                             f"says {self.manifest.num_keys}")

    def keys(self) -> list[bytes]:
        return sorted(self._entries)

    def __contains__(self, key: bytes) -> bool:
        return key in self._entries

    def ref(self, key: bytes) -> ValueRef | None:
        """Where an indirect value lies; None for an inline one."""
        entry = self._entries[key]
        return None if isinstance(entry, bytes) else entry

    def read(self, key: bytes) -> bytes:
        entry = self._entries[key]
        return entry if isinstance(entry, bytes) else _read_ref(self.root, entry)


# ------------------------------------------------------------------ writing


def _leaf_body(keys: list[bytes], values: list[bytes | ValueRef],
               files: list[DataFile]) -> bytes:
    fid = {f: i for i, f in enumerate(files)}
    refs = [v for v in values if isinstance(v, ValueRef)]
    return b"".join([
        bytes([0]), _write_file_table(files), _varint(len(keys)), _write_prefixed(keys),
        _varints(v.length if isinstance(v, ValueRef) else len(v) for v in values),
        _varints(1 if isinstance(v, ValueRef) else 0 for v in values),
        _varints(fid[v.file] for v in refs), _varints(v.offset for v in refs),
        b"".join(v for v in values if isinstance(v, bytes))])


def write_database(root: str,
                   items: dict[bytes, bytes | np.ndarray | Callable[[], np.ndarray]]) -> None:
    """Write a new database at `root` (a directory that holds none) with one
    version holding `items`; a callable value is called when it is written,
    so one value at a time is held in memory. Values longer than
    MAX_INLINE_VALUE_BYTES go, in key order, into one data file; the B+tree
    is one leaf node, in another (a checkpoint's keys and inline values take
    a few MB, far under MAX_DECODED_NODE_BYTES). The config is orbax's."""
    os.makedirs(os.path.join(root, "d"), exist_ok=True)
    if os.path.exists(os.path.join(root, "manifest.ocdbt")):
        raise FileExistsError(f"OCDBT: {root} already holds a database")
    keys = sorted(items)
    value_file = DataFile("", f"d/{uuid_mod.uuid4().hex}")
    node_file = DataFile("", f"d/{uuid_mod.uuid4().hex}")
    values: list[bytes | ValueRef] = []
    value_bytes = 0
    with open(value_file.path(root), "wb") as f:
        for k in keys:
            v = items[k]
            if callable(v):
                v = v()
            n = len(v) if isinstance(v, bytes) else np.asarray(v).nbytes
            if n <= MAX_INLINE_VALUE_BYTES:
                values.append(v if isinstance(v, bytes) else np.asarray(v).tobytes())
            else:
                values.append(ValueRef(value_file, f.tell(), n))
                f.write(v if isinstance(v, bytes) else memoryview(np.ascontiguousarray(v)))
                value_bytes += n

    leaf = b""
    if keys:
        body = _leaf_body(keys, values, [value_file] if value_bytes else [])
        if len(body) > MAX_DECODED_NODE_BYTES:
            raise ValueError(f"OCDBT: a leaf of {len(body)} bytes passes the node limit "
                             f"{MAX_DECODED_NODE_BYTES}")
        leaf = _wrap(body, NODE_MAGIC)
        with open(node_file.path(root), "wb") as f:
            f.write(leaf)
    body = b"".join([
        uuid_mod.uuid4().bytes, _varint(0), _varint(MAX_INLINE_VALUE_BYTES),
        _varint(MAX_DECODED_NODE_BYTES), bytes([VERSION_TREE_ARITY_LOG2]), _varint(1),
        struct.pack("<i", 0), _write_file_table([node_file] if leaf else []), _varint(1),
        _varints([1, 0, 0, 0, len(leaf), len(keys), len(leaf), value_bytes]),
        struct.pack("<Q", time.time_ns()), _varint(0)])
    tmp = os.path.join(root, f"manifest.ocdbt.tmp{os.getpid()}")
    with open(tmp, "wb") as f:
        f.write(_wrap(body, MANIFEST_MAGIC))
    os.replace(tmp, os.path.join(root, "manifest.ocdbt"))
