"""A small MessagePack codec for checkpoint manifests.

The JAX package's checkpoint manifest is ``manifest.msgpack``, written with
the ``msgpack`` package (``use_bin_type=True``) and read with ``raw=False``.
The port reads and writes the same files without that package, through
this codec for the subset a manifest uses: nil, bool, float64, ints up to
64 bits either sign, str, bin, and arrays and maps of up to 2**32 - 1
entries.  ``packb`` picks the smallest encoding for each value, as the
``msgpack`` package does, so both write the same bytes for the same
value; ``unpackb`` also reads float32, and gives arrays as lists.
"""

from __future__ import annotations

import struct


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: a fix code while ``n <= fix_max``, else the first
    of ``codes`` ((code, struct format, max)) that holds ``n``."""
    if n <= fix_max:
        out.append(fix | n)
        return
    for code, fmt, most in codes:
        if n <= most:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} past 2**32 - 1")


_STR = ((0xD9, ">B", 0xFF), (0xDA, ">H", 0xFFFF), (0xDB, ">I", 0xFFFFFFFF))
_BIN = ((0xC4, ">B", 0xFF), (0xC5, ">H", 0xFFFF), (0xC6, ">I", 0xFFFFFFFF))
_ARR = ((0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))
_MAP = ((0xDE, ">H", 0xFFFF), (0xDF, ">I", 0xFFFFFFFF))


def _int(out: bytearray, x: int) -> None:
    if 0 <= x < 0x80 or -32 <= x < 0:
        out += struct.pack(">b" if x < 0 else ">B", x)
    elif x >= 0:
        for code, fmt, most in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                (0xCE, ">I", 0xFFFFFFFF),
                                (0xCF, ">Q", 2 ** 64 - 1)):
            if x <= most:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} past 64 bits")
    else:
        for code, fmt, least in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                                 (0xD2, ">i", -2 ** 31),
                                 (0xD3, ">q", -2 ** 63)):
            if x >= least:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"int {x} past 64 bits")


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True or x is False:
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _head(out, len(b), 0xA0, 31, _STR)
        out += b
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        _head(out, len(b), 0, -1, _BIN)
        out += b
    elif isinstance(x, (list, tuple)):
        _head(out, len(x), 0x90, 15, _ARR)
        for v in x:
            _pack(out, v)
    elif isinstance(x, dict):
        _head(out, len(x), 0x80, 15, _MAP)
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot msgpack {type(x).__name__}")


def packb(obj) -> bytes:
    """``obj`` as MessagePack bytes (``msgpack.packb(obj,
    use_bin_type=True)`` for the supported types)."""
    out = bytearray()
    _pack(out, obj)
    return bytes(out)


# code -> (struct format, kind) of the fixed-width headers
_FIXED = {
    0xCC: (">B", "int"), 0xCD: (">H", "int"), 0xCE: (">I", "int"),
    0xCF: (">Q", "int"), 0xD0: (">b", "int"), 0xD1: (">h", "int"),
    0xD2: (">i", "int"), 0xD3: (">q", "int"),
    0xCA: (">f", "float"), 0xCB: (">d", "float"),
    0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
    0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
    0xDC: (">H", "array"), 0xDD: (">I", "array"),
    0xDE: (">H", "map"), 0xDF: (">I", "map"),
}


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.at = 0

    def take(self, n: int) -> memoryview:
        if self.at + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def value(self):
        code = self.take(1)[0]
        if code <= 0x7F:
            return code
        if code >= 0xE0:
            return code - 0x100
        if 0x80 <= code <= 0x8F:
            return self.items("map", code & 0x0F)
        if 0x90 <= code <= 0x9F:
            return self.items("array", code & 0x0F)
        if 0xA0 <= code <= 0xBF:
            return str(self.take(code & 0x1F), "utf-8")
        if code == 0xC0:
            return None
        if code in (0xC2, 0xC3):
            return code == 0xC3
        if code not in _FIXED:
            raise ValueError(f"msgpack code 0x{code:02x} is not supported")
        fmt, kind = _FIXED[code]
        (n,) = struct.unpack(fmt, self.take(struct.calcsize(fmt)))
        if kind in ("int", "float"):
            return n
        if kind == "str":
            return str(self.take(n), "utf-8")
        if kind == "bin":
            return bytes(self.take(n))
        return self.items(kind, n)

    def items(self, kind: str, n: int):
        if kind == "array":
            return [self.value() for _ in range(n)]
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out


def unpackb(data: bytes):
    """The value packed in ``data`` (``msgpack.unpackb(data, raw=False)``
    for the supported types); trailing bytes raise."""
    r = _Reader(data)
    out = r.value()
    if r.at != len(r.data):
        raise ValueError(f"{len(r.data) - r.at} bytes after the msgpack "
                         "value")
    return out
