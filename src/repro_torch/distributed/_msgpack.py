"""The subset of MessagePack that checkpoints use, packed as
``msgpack.packb(obj, use_bin_type=True)`` packs it and read back as
``msgpack.unpackb(data, raw=False)`` reads it.

Types: nil, bool, int (-2**63 .. 2**64 - 1), float (float64), str, bytes
(bin 8/16/32), list/tuple (array) and dict (map). Every container and
every str or bytes is at most 2**32 - 1 entries or bytes long,
MessagePack's own limit.
"""
from __future__ import annotations

import struct


def packb(obj) -> bytes:
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


def _head(out, n, small, small_max, codes):
    """A length header: ``small | n`` below ``small_max`` (when there is
    a fix form), else the first of ``codes`` (8, 16, 32-bit) that holds
    n."""
    if small is not None and n < small_max:
        out.append(small | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} exceeds MessagePack's 2**32 - 1")


def _pack(obj, out):
    if obj is None:
        out.append(0xC0)
    elif obj is True:
        out.append(0xC3)
    elif obj is False:
        out.append(0xC2)
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _head(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _head(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(obj, (list, tuple)):
        _head(out, len(obj), 0x90, 16, (None, 0xDC, 0xDD))
        for x in obj:
            _pack(x, out)
    elif isinstance(obj, dict):
        _head(out, len(obj), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj).__name__}")


def _pack_int(n, out):
    if 0 <= n < 0x80 or -32 <= n < 0:
        out += struct.pack(">b" if n < 0 else ">B", n)
    elif n >= 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF),
                               (0xCF, ">Q", 0xFFFFFFFFFFFFFFFF)):
            if n <= top:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"{n} does not fit in 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                               (0xD2, ">i", -0x80000000),
                               (0xD3, ">q", -0x8000000000000000)):
            if n >= low:
                out.append(code)
                out += struct.pack(fmt, n)
                return
        raise OverflowError(f"{n} does not fit in 64 bits")


# code -> (struct format, size) of the fixed-width scalars
_SCALARS = {0xCB: (">d", 8),
            0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4),
            0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
            0xD2: (">i", 4), 0xD3: (">q", 8)}
# code -> (kind, size of the length field)
_SIZED = {0xD9: ("str", 1), 0xDA: ("str", 2), 0xDB: ("str", 4),
          0xC4: ("bin", 1), 0xC5: ("bin", 2), 0xC6: ("bin", 4),
          0xDC: ("array", 2), 0xDD: ("array", 4),
          0xDE: ("map", 2), 0xDF: ("map", 4)}
_LEN_FMT = {1: ">B", 2: ">H", 4: ">I"}


def unpackb(data) -> object:
    view = memoryview(data)
    obj, pos = _unpack(view, 0)
    if pos != len(view):
        raise ValueError(f"{len(view) - pos} bytes after the object")
    return obj


def _unpack(view, pos):
    code = view[pos]
    pos += 1
    if code <= 0x7F:
        return code, pos
    if code >= 0xE0:
        return code - 0x100, pos
    if 0x80 <= code <= 0x8F:
        return _container("map", code & 0x0F, view, pos)
    if 0x90 <= code <= 0x9F:
        return _container("array", code & 0x0F, view, pos)
    if 0xA0 <= code <= 0xBF:
        n = code & 0x1F
        return str(view[pos:pos + n], "utf-8"), pos + n
    if code == 0xC0:
        return None, pos
    if code in (0xC2, 0xC3):
        return code == 0xC3, pos
    if code in _SCALARS:
        fmt, size = _SCALARS[code]
        return struct.unpack_from(fmt, view, pos)[0], pos + size
    if code in _SIZED:
        kind, size = _SIZED[code]
        n = struct.unpack_from(_LEN_FMT[size], view, pos)[0]
        pos += size
        if kind == "str":
            return str(view[pos:pos + n], "utf-8"), pos + n
        if kind == "bin":
            return bytes(view[pos:pos + n]), pos + n
        return _container(kind, n, view, pos)
    raise ValueError(f"MessagePack type 0x{code:02x} is not supported")


def _container(kind, n, view, pos):
    if kind == "array":
        items = []
        for _ in range(n):
            x, pos = _unpack(view, pos)
            items.append(x)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(view, pos)
        v, pos = _unpack(view, pos)
        out[k] = v
    return out, pos
