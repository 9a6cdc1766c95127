"""flax's checkpoint format (``flax.serialization.to_bytes``) in plain
Python: the JAX package's ``params.msgpack`` and ``<path>.opt`` files.

The format is msgpack (nil, bool, the int and float families, str, bin,
array, map) of a state dict: nested maps with string keys. An array leaf
is an ext record of code 1 whose payload is itself a msgpack array
``[shape, dtype name, C-order bytes]``; a numpy scalar is code 3 with the
same payload. An array above ``MAX_CHUNK_SIZE`` bytes is written as a map
``{"__msgpack_chunked_array__": true, "shape": {"0": d0, ...}, "chunks":
{"0": flat chunk, ...}}``, which ``loads`` joins back into one array.

``loads(bytes)`` returns the tree (dicts; arrays as numpy, bfloat16 arrays
as torch tensors since numpy has no such type); ``dumps(tree)`` is its
inverse and writes the bytes ``to_bytes`` writes for the same state dict.
Neither flax nor msgpack is needed.
"""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are chunked
MAX_CHUNK_SIZE = 2 ** 30
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"

# first bytes of a flax file: a msgpack map of one or more entries
_MAP_HEADS = frozenset(range(0x81, 0x90)) | {0xDE, 0xDF}


def is_flax_msgpack(head: bytes) -> bool:
    """Whether a file starting with ``head`` is a flax checkpoint (a
    msgpack map) rather than a torch file (a zip archive, or a pickle,
    which starts 0x80 followed by its protocol)."""
    return len(head) > 0 and head[0] in _MAP_HEADS


# -- decoding ---------------------------------------------------------------

def _array_from_payload(payload: bytes):
    (shape, dtype, buf), end = _unpack(memoryview(payload), 0)
    if end != len(payload):
        raise ValueError("trailing bytes in an ndarray record")
    shape = tuple(int(s) for s in shape)
    if dtype == "bfloat16":
        return torch.frombuffer(bytearray(buf), dtype=torch.bfloat16
                                ).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).copy()


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _array_from_payload(payload)
    if code == _EXT_NPSCALAR:
        return _array_from_payload(payload)[()]
    raise ValueError(f"unsupported msgpack ext code {code} (flax writes "
                     f"{_EXT_NDARRAY} for arrays, {_EXT_NPSCALAR} for numpy "
                     "scalars)")


_FIXED = {  # head byte → (struct format, size)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


def _length(buf, pos: int, size: int) -> Tuple[int, int]:
    return struct.unpack_from(_LEN[size], buf, pos)[0], pos + size


def _unpack(buf, pos: int) -> Tuple[Any, int]:
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _list(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        n = b & 0x1F
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in _FIXED:
        fmt, size = _FIXED[b]
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
        n, pos = _length(buf, pos, 1 << (b - 0xC4))
        return bytes(buf[pos:pos + n]), pos + n
    if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
        n, pos = _length(buf, pos, 1 << (b - 0xD9))
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if b in (0xDC, 0xDD):  # array 16/32
        n, pos = _length(buf, pos, 2 << (b - 0xDC))
        return _list(buf, pos, n)
    if b in (0xDE, 0xDF):  # map 16/32
        n, pos = _length(buf, pos, 2 << (b - 0xDE))
        return _map(buf, pos, n)
    if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
        n = 1 << (b - 0xD4)
    elif b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
        n, pos = _length(buf, pos, 1 << (b - 0xC7))
    else:
        raise ValueError(f"invalid msgpack byte 0x{b:02x} at {pos - 1}")
    code = struct.unpack_from(">b", buf, pos)[0]
    pos += 1
    return _ext(code, bytes(buf[pos:pos + n])), pos + n


def _list(buf, pos: int, n: int):
    out = []
    for _ in range(n):
        v, pos = _unpack(buf, pos)
        out.append(v)
    return out, pos


def _map(buf, pos: int, n: int):
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos)
        v, pos = _unpack(buf, pos)
        out[k] = v
    return out, pos


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(x):
    # as flax's _unchunk_array_leaves_in_place: through maps only
    if isinstance(x, dict):
        if _CHUNKED in x:
            return _unchunk(x)
        return {k: _unchunk_tree(v) for k, v in x.items()}
    return x


def loads(data: bytes) -> Any:
    """flax ``to_bytes`` output → the state-dict tree."""
    buf = memoryview(data)
    tree, end = _unpack(buf, 0)
    if end != len(buf):
        raise ValueError(f"trailing bytes after the msgpack object "
                         f"({len(buf) - end})")
    return _unchunk_tree(tree)


def load(path: str) -> Any:
    with open(path, "rb") as f:
        return loads(f.read())


# -- encoding ---------------------------------------------------------------

def _pack_len(out: bytearray, n: int, small: Tuple[int, int], heads) -> None:
    """Header of a str/bin/array/map of ``n``: the fix form below
    ``small[1]`` (base ``small[0]``), else the 8/16/32-bit length forms
    (``heads`` maps their byte size to the head byte)."""
    if small is not None and n < small[1]:
        out.append(small[0] | n)
        return
    for size, fmt in ((1, ">B"), (2, ">H"), (4, ">I")):
        if size in heads and n < 1 << (8 * size):
            out.append(heads[size])
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack object too large ({n})")


def _pack_int(out: bytearray, x: int) -> None:
    # msgpack-python's choice: positive values unsigned, negative signed,
    # each in its smallest form
    if 0 <= x < 0x80 or -32 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
    elif x >= 0:
        for head, fmt, lim in ((0xCC, ">B", 8), (0xCD, ">H", 16),
                               (0xCE, ">I", 32), (0xCF, ">Q", 64)):
            if x < 1 << lim:
                out.append(head)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(x)
    else:
        for head, fmt, lim in ((0xD0, ">b", 7), (0xD1, ">h", 15),
                               (0xD2, ">i", 31), (0xD3, ">q", 63)):
            if x >= -(1 << lim):
                out.append(head)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(x)


def _array_payload(x) -> bytes:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            return _packb([list(x.shape), "bfloat16",
                           x.view(torch.int16).numpy().tobytes()])
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serialisable")
    return _packb([list(x.shape), x.dtype.name, x.tobytes("C")])


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fix = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fix:
        out.append(fix[n])
    else:
        _pack_len(out, n, None, {1: 0xC7, 2: 0xC8, 4: 0xC9})
    out += struct.pack(">b", code)
    out += payload


def _chunked(x, max_chunk: int):
    """flax's ``_chunk``: an oversized array as a map of flat chunks."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) \
        else x.dtype.itemsize
    step = max(1, int(max_chunk / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + step]
                       for j, i in enumerate(range(0, n, step))}}


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return x.size * x.dtype.itemsize


def _pack(out: bytearray, x, max_chunk) -> None:
    """``max_chunk``: chunk arrays above it (None inside records and lists,
    which flax does not chunk)."""
    # exact types, as flax's strict_types packer: a numpy float64 (a float
    # subclass) is a numpy scalar record, not a msgpack float
    if x is None:
        out.append(0xC0)
    elif type(x) is bool:
        out.append(0xC3 if x else 0xC2)
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _pack_len(out, len(b), (0xA0, 32), {1: 0xD9, 2: 0xDA, 4: 0xDB})
        out += b
    elif type(x) is bytes:
        _pack_len(out, len(x), None, {1: 0xC4, 2: 0xC5, 4: 0xC6})
        out += x
    elif isinstance(x, dict):
        _pack_len(out, len(x), (0x80, 16), {2: 0xDE, 4: 0xDF})
        for k, v in x.items():
            _pack(out, k, None)
            _pack(out, v, max_chunk)
    elif isinstance(x, (list, tuple)):
        _pack_len(out, len(x), (0x90, 16), {2: 0xDC, 4: 0xDD})
        for v in x:
            _pack(out, v, None)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if max_chunk is not None and _nbytes(x) > max_chunk:
            _pack(out, _chunked(x, max_chunk), None)
        else:
            _pack_ext(out, _EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(x)))
    else:
        raise TypeError(f"cannot serialise {type(x).__name__}")


def _packb(x) -> bytes:
    out = bytearray()
    _pack(out, x, None)
    return bytes(out)


def dumps(tree: Any, max_chunk_size: int = MAX_CHUNK_SIZE) -> bytes:
    """The state-dict ``tree`` (dicts with string keys; numpy or torch
    arrays, numpy scalars and Python values at the leaves) → the bytes
    flax's ``to_bytes`` writes for it, arrays above ``max_chunk_size``
    bytes chunked as flax chunks them."""
    out = bytearray()
    _pack(out, tree, max_chunk_size)
    return bytes(out)


def dump(path: str, tree: Any) -> None:
    with open(path, "wb") as f:
        f.write(dumps(tree))
