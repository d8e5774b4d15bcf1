"""Minimal CBOR (RFC 8949) decoder (the port's copy of
tfhe_tpu/utils/cbor.py) — enough to read the wire format of
utils/serialization.py and tfhe-rs test vectors (maps, arrays, uints,
negints, bignums, byte and text strings, floats).  No external dependency.
"""

from __future__ import annotations

import struct


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def byte(self) -> int:
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def read(self, n: int) -> bytes:
        out = self.buf[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated CBOR")
        self.pos += n
        return out


_BREAK = object()


def _read_uint(r: _Reader, info: int) -> int:
    if info < 24:
        return info
    if info == 24:
        return r.byte()
    if info == 25:
        return struct.unpack(">H", r.read(2))[0]
    if info == 26:
        return struct.unpack(">I", r.read(4))[0]
    if info == 27:
        return struct.unpack(">Q", r.read(8))[0]
    raise ValueError(f"bad additional info {info}")


def _decode(r: _Reader):
    ib = r.byte()
    major, info = ib >> 5, ib & 0x1F
    if major == 0:
        return _read_uint(r, info)
    if major == 1:
        return -1 - _read_uint(r, info)
    if major == 2:  # byte string
        if info == 31:
            chunks = []
            while True:
                c = _decode(r)
                if c is _BREAK:
                    break
                chunks.append(c)
            return b"".join(chunks)
        return r.read(_read_uint(r, info))
    if major == 3:  # text
        if info == 31:
            chunks = []
            while True:
                c = _decode(r)
                if c is _BREAK:
                    break
                chunks.append(c)
            return "".join(chunks)
        return r.read(_read_uint(r, info)).decode("utf-8")
    if major == 4:  # array
        if info == 31:
            out = []
            while True:
                v = _decode(r)
                if v is _BREAK:
                    break
                out.append(v)
            return out
        n = _read_uint(r, info)
        return [_decode(r) for _ in range(n)]
    if major == 5:  # map
        if info == 31:
            out = {}
            while True:
                k = _decode(r)
                if k is _BREAK:
                    break
                out[k] = _decode(r)
            return out
        n = _read_uint(r, info)
        return {_decode(r): _decode(r) for _ in range(n)}
    if major == 6:  # tag
        tag = _read_uint(r, info)
        v = _decode(r)
        if tag == 2:   # RFC 8949 positive bignum
            return int.from_bytes(v, "big")
        if tag == 3:   # negative bignum
            return -1 - int.from_bytes(v, "big")
        return v
    # major == 7: simple / float / break
    if info == 20:
        return False
    if info == 21:
        return True
    if info == 22:
        return None
    if info == 23:
        return None  # undefined
    if info == 25:
        return struct.unpack(">e", r.read(2))[0]
    if info == 26:
        return struct.unpack(">f", r.read(4))[0]
    if info == 27:
        return struct.unpack(">d", r.read(8))[0]
    if info == 31:
        return _BREAK
    if info < 24 or info == 24:
        return _read_uint(r, info)  # simple value
    raise ValueError(f"unsupported CBOR item {major}/{info}")


def loads(buf: bytes):
    return _decode(_Reader(buf))


def load(path):
    with open(path, "rb") as f:
        return loads(f.read())
