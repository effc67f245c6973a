"""Checkpoints in the JAX package's file format, read and written without
`msgpack` or flax.

Layout of a file:
  * the 8-byte magic `IDTPU1\\0\\0`;
  * an 8-byte little-endian length, then that many bytes of JSON meta
    (`{"architecture", "epoch", "trees"}`);
  * a msgpack blob of nested maps whose leaves are flax-encoded ndarrays.

Flax encodes an ndarray as msgpack ext type 1 whose payload is itself a
msgpack array `[shape, dtype name, raw C-order bytes]`.  The codec below
covers the subset flax emits for parameter and trainer-state trees: maps,
arrays, str, bin, ints, floats, nil, bool and ext type 1, with float32,
int32, int64 (a trainer's step), uint8 and float16 arrays.  Anything else
raises.

Under a process group only rank 0 writes; the trainers gather sharded
state on every rank before they call the writers, and the writers run no
collective, so a write on rank 0's thread never waits for another rank.
"""

from __future__ import annotations

import json
import os
import struct
import threading
from typing import Any

import numpy as np

from . import is_main_process

MAGIC = b"IDTPU1\x00\x00"

_EXT_NDARRAY = 1
_DTYPES = {"float32": np.float32, "int32": np.int32, "int64": np.int64, "uint8": np.uint8,
           "float16": np.float16}


# ----------------------------------------------------------------- encode


def _pack_int(n: int, out: bytearray) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -32 <= n < 0:
        out.append(n & 0xFF)
    elif 0 <= n < 1 << 8:
        out += b"\xcc" + struct.pack(">B", n)
    elif 0 <= n < 1 << 16:
        out += b"\xcd" + struct.pack(">H", n)
    elif 0 <= n < 1 << 32:
        out += b"\xce" + struct.pack(">I", n)
    elif 0 <= n < 1 << 64:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -(1 << 7) <= n < 0:
        out += b"\xd0" + struct.pack(">b", n)
    elif -(1 << 15) <= n < 0:
        out += b"\xd1" + struct.pack(">h", n)
    elif -(1 << 31) <= n < 0:
        out += b"\xd2" + struct.pack(">i", n)
    elif -(1 << 63) <= n < 0:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: bytes, out: bytearray) -> None:
    """Header of a str/bin/array/map of length n: fix form when allowed,
    else the 8/16/32-bit length forms in `codes` (8-bit may be absent)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
        return
    forms = [(1 << 8, ">B"), (1 << 16, ">H"), (1 << 32, ">I")]
    if len(codes) == 2:  # no 8-bit form (arrays and maps)
        forms = forms[1:]
    for code, (limit, fmt) in zip(codes, forms):
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 31, b"\xd9\xda\xdb", out)
        out += data
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(len(obj), None, 0, b"\xc4\xc5\xc6", out)
        out += obj
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 15, b"\xdc\xdd", out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 15, b"\xde\xdf", out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        name = obj.dtype.name
        if name not in _DTYPES:
            raise TypeError(f"unsupported array dtype {name!r}; expected one of {sorted(_DTYPES)}")
        payload = packb([list(obj.shape), name, np.ascontiguousarray(obj).tobytes()])
        _pack_len(len(payload), None, 0, b"\xc7\xc8\xc9", out)
        out.append(_EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"cannot msgpack-encode {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode `obj` (nested dicts/lists of scalars, str, bytes, ndarrays)."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ----------------------------------------------------------------- decode


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        chunk = self.data[self.pos:self.pos + n]
        self.pos += n
        return chunk

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_FIXED = {
    0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
    0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
    0xCA: ">f", 0xCB: ">d",
}
_LEN8_16_32 = {0: ">B", 1: ">H", 2: ">I"}


def _ext(code: int, data: bytes):
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, name, raw = unpackb(data)
    if isinstance(name, bytes):
        name = name.decode()
    if name not in _DTYPES:
        raise ValueError(f"unsupported array dtype {name!r}; expected one of {sorted(_DTYPES)}")
    return np.frombuffer(raw, dtype=_DTYPES[name]).reshape(shape).copy()


def _unpack(r: _Reader):
    b = r.unpack(">B")
    if b < 0x80:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _unpack_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return bytes(r.take(b & 0x1F)).decode("utf-8")
    if b == 0xC0:
        return None
    if b == 0xC2:
        return False
    if b == 0xC3:
        return True
    if b in _FIXED:
        return r.unpack(_FIXED[b])
    if 0xC4 <= b <= 0xC6:  # bin 8/16/32
        return bytes(r.take(r.unpack(_LEN8_16_32[b - 0xC4])))
    if 0xD9 <= b <= 0xDB:  # str 8/16/32
        return bytes(r.take(r.unpack(_LEN8_16_32[b - 0xD9]))).decode("utf-8")
    if b in (0xDC, 0xDD):  # array 16/32
        return [_unpack(r) for _ in range(r.unpack(">H" if b == 0xDC else ">I"))]
    if b in (0xDE, 0xDF):  # map 16/32
        return _unpack_map(r, r.unpack(">H" if b == 0xDE else ">I"))
    if 0xC7 <= b <= 0xC9:  # ext 8/16/32
        n = r.unpack(_LEN8_16_32[b - 0xC7])
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(n)))
    if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
        code = r.unpack(">b")
        return _ext(code, bytes(r.take(1 << (b - 0xD4))))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes):
    """Decode one msgpack object (the subset `packb` and flax emit)."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} trailing bytes after msgpack object")
    return obj


# ------------------------------------------------------------------- files


def save_checkpoint(path: str, architecture: dict | None = None, epoch: int | None = None,
                    **trees) -> None:
    """Save named trees of numpy arrays plus metadata, atomically (on rank
    0 alone under a process group)."""
    if not is_main_process():
        return
    payload = {name: tree for name, tree in trees.items() if tree is not None}
    meta = json.dumps({"architecture": architecture, "epoch": epoch, "trees": sorted(payload)})
    blob = packb(payload)
    folder = os.path.dirname(path)
    if folder:
        os.makedirs(folder, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(MAGIC)
        f.write(len(meta).to_bytes(8, "little"))
        f.write(meta.encode())
        f.write(blob)
    os.replace(tmp, path)


class AsyncSaver:
    """Checkpoint writes off the caller's thread: the caller hands over
    trees already copied to the host, serialization and file IO run on a
    background thread, and at most one write is in flight (a new save, or
    `wait`, joins the previous one first).  Off rank 0 of a process
    group it writes nothing."""

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, path: str, architecture: dict | None = None, epoch: int | None = None,
             **trees) -> None:
        self.wait()
        if not is_main_process():
            return

        def work():
            try:
                save_checkpoint(path, architecture, epoch, **trees)
            except BaseException as e:  # re-raised by wait() on the caller's thread
                self._error = e

        self._thread = threading.Thread(target=work, daemon=False)
        self._thread.start()

    def wait(self) -> None:
        """Join the write in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """-> (trees, meta) where meta = {'architecture', 'epoch', 'trees'}."""
    with open(path, "rb") as f:
        if f.read(8) != MAGIC:
            raise ValueError(f"{path} is not an image-diffusion-tpu checkpoint")
        meta_len = int.from_bytes(f.read(8), "little")
        meta = json.loads(f.read(meta_len).decode())
        trees = unpackb(f.read())
    return trees, meta
