"""Fold checkpoints in flax's msgpack layout (port of
`iggcn_tpu/train/checkpoint.py`), with a codec of the port's own.

A checkpoint `gcn_state_dict_{result_file_name}_fold_{k}.msgpack` holds
`{"params": ..., "batch_stats": ...}` in the flax tree of the model
(`tools/convert.py:to_flax_variables`). The bytes are what
`flax.serialization.to_bytes` writes for the same tree, so either package
reads the other's files; the port imports neither flax nor msgpack. The
layout (flax 0.12's `_msgpack_ext_pack` / `_ndarray_to_bytes`):

  * a msgpack map of str keys, nested maps for subtrees, strings packed
    as str (`use_bin_type`), Python ints and floats as msgpack ints and
    float64;
  * an ndarray leaf is ext type 1 whose payload is the msgpack array
    `(shape, dtype name, C-order bytes)`; a NumPy scalar is ext type 3
    with the same payload of its 0-d array.

Arrays over flax's `MAX_CHUNK_SIZE` (1 GiB), which flax would split into
chunks, are refused in both directions: no model of this repository has
one.
"""
from __future__ import annotations

import os
import struct
from typing import Any, Dict

import numpy as np

MAX_CHUNK_SIZE = 2 ** 30
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3


def _header(out: bytearray, n: int, fix: int | None, fix_max: int,
            codes: tuple) -> None:
    """A length header: the fix form below `fix_max`, else the 8/16/32-bit
    form (`codes` the three type bytes, None for a width without one)."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (2 ** 8, 2 ** 16, 2 ** 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, limit in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                                 (0xCE, ">I", 2 ** 32),
                                 (0xCF, ">Q", 2 ** 64)):
            if v < limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for code, fmt, limit in ((0xD0, ">b", 2 ** 7), (0xD1, ">h", 2 ** 15),
                                 (0xD2, ">i", 2 ** 31),
                                 (0xD3, ">q", 2 ** 63)):
            if v >= -limit:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _header(out, len(data), None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _ndarray_payload(arr: np.ndarray) -> bytes:
    if arr.dtype.hasobject or arr.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be stored")
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(
            f"array of {arr.nbytes} bytes exceeds flax's MAX_CHUNK_SIZE "
            f"({MAX_CHUNK_SIZE}); flax would split it into chunks, which "
            "this codec does not write")
    out = bytearray()
    _pack(out, [list(arr.shape), arr.dtype.name, arr.tobytes("C")])
    return bytes(out)


def _pack(out: bytearray, obj: Any) -> None:
    t = type(obj)
    if obj is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if obj else 0xC2)
    elif t is int:
        _pack_int(out, obj)
    elif t is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif t is str:
        data = obj.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif t is bytes:
        _header(out, len(obj), None, 0, (0xC4, 0xC5, 0xC6))
        out += obj
    elif t is list:
        _header(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(out, v)
    elif t is dict:
        _header(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(out, k)
            _pack(out, v)
    elif isinstance(obj, np.ndarray):
        _pack_ext(out, EXT_NDARRAY, _ndarray_payload(obj))
    elif isinstance(obj, np.generic):
        _pack_ext(out, EXT_NPSCALAR, _ndarray_payload(np.asarray(obj)))
    else:
        raise TypeError(f"cannot store a {t.__name__} in a checkpoint")


def to_bytes(tree: Dict[str, Any]) -> bytes:
    """The msgpack bytes of a tree of dicts (str keys) with ndarray, NumPy
    scalar and Python scalar leaves, keys in the dicts' order, as
    `flax.serialization.to_bytes` writes them."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


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

    def obj(self, raw: bool = False) -> Any:
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        widths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in widths:
            return bytes(self.take(self.unpack(widths[b])))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H",
                   0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h",
                   0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            return self.ext(self.unpack(ext[b]))
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return self.str(self.unpack(strs[b]), raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"unknown msgpack type byte 0x{b:02x}")

    def str(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        if "__msgpack_chunked_array__" in out:
            raise ValueError("this checkpoint holds an array that flax split "
                             f"into chunks (over {MAX_CHUNK_SIZE} bytes); "
                             "the port does not read chunked arrays")
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = bytes(self.take(n))
        if code == EXT_COMPLEX:
            real, imag = _Reader(data).obj()
            return complex(real, imag)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unknown msgpack ext type {code}")
        shape, name, buf = _Reader(data).obj(raw=True)
        arr = np.frombuffer(buf, dtype=np.dtype(name.decode())).reshape(
            shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]


def from_bytes(data: bytes) -> Any:
    """The tree `to_bytes` (or flax's `to_bytes`) wrote: dicts with str
    keys, ndarray leaves, NumPy scalars for ext type 3."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} trailing bytes "
                         "after the msgpack object")
    return tree


def _sorted_tree(tree: Any) -> Any:
    """Keys sorted at every level, as `jax.device_get` hands the JAX
    package's `save_checkpoint` its trees."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def save_checkpoint(path: str, params: Dict[str, Any],
                    batch_stats: Dict[str, Any]) -> None:
    """Write `{"params": ..., "batch_stats": ...}` (flax trees of host
    arrays) to `path`: the bytes the JAX package's `save_checkpoint` writes
    for the same trees."""
    data = to_bytes({"params": _sorted_tree(params),
                     "batch_stats": _sorted_tree(batch_stats)})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(data)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """`{"params": ..., "batch_stats": ...}` from a checkpoint written by
    either package; load it into a model with
    `tools/convert.py:load_flax_variables`."""
    with open(path, "rb") as fh:
        payload = from_bytes(fh.read())
    if not isinstance(payload, dict) or "params" not in payload:
        raise ValueError(f"{path} is not a fold checkpoint (no 'params' "
                         "entry at its top level)")
    payload.setdefault("batch_stats", {})
    return payload
