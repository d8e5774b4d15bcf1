"""GMP-backed bigint multiply for the Kronecker polynomial products.

Port of tfhe_tpu/zk/gmp_bigint.py (a host bigint choice, not a device).

CPython multiplies huge ints with Karatsuba; GMP (runtime library is
commonly present even without headers) uses Toom/FFT — 10-30x faster at the
~1 MB operand sizes of the pke_v2 prover's Kronecker substitution.  We bind
libgmp directly with ctypes (mpz import/export + mul); if the library is
missing the callers fall back to plain `a * b`.
"""

from __future__ import annotations

import ctypes
import ctypes.util

_lib = None


class _MpzT(ctypes.Structure):
    _fields_ = [("_mp_alloc", ctypes.c_int),
                ("_mp_size", ctypes.c_int),
                ("_mp_d", ctypes.c_void_p)]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    for name in ("libgmp.so.10", "libgmp.so", ctypes.util.find_library("gmp")):
        if not name:
            continue
        try:
            lib = ctypes.CDLL(name)
        except OSError:
            continue
        lib.__gmpz_init.argtypes = [ctypes.POINTER(_MpzT)]
        lib.__gmpz_clear.argtypes = [ctypes.POINTER(_MpzT)]
        lib.__gmpz_import.argtypes = [
            ctypes.POINTER(_MpzT), ctypes.c_size_t, ctypes.c_int,
            ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t, ctypes.c_void_p]
        lib.__gmpz_export.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_int,
            ctypes.c_size_t, ctypes.c_int, ctypes.c_size_t,
            ctypes.POINTER(_MpzT)]
        lib.__gmpz_export.restype = ctypes.c_void_p
        lib.__gmpz_mul.argtypes = [ctypes.POINTER(_MpzT)] * 3
        _lib = lib
        return lib
    _lib = False
    return False


def available() -> bool:
    return bool(_load())


def mul_bytes(a: bytes, b: bytes, out_len: int) -> bytes:
    """(a * b) as little-endian bytes of length out_len (a, b little-endian
    non-negative).  Requires available()."""
    lib = _load()
    x, y, z = _MpzT(), _MpzT(), _MpzT()
    lib.__gmpz_init(x)
    lib.__gmpz_init(y)
    lib.__gmpz_init(z)
    try:
        lib.__gmpz_import(x, len(a), -1, 1, 0, 0, a)
        lib.__gmpz_import(y, len(b), -1, 1, 0, 0, b)
        lib.__gmpz_mul(z, x, y)
        buf = ctypes.create_string_buffer(out_len + 8)
        count = ctypes.c_size_t(0)
        lib.__gmpz_export(buf, ctypes.byref(count), -1, 1, 0, 0, z)
        n = min(count.value, out_len)
        return buf.raw[:n] + b"\x00" * (out_len - n)
    finally:
        lib.__gmpz_clear(x)
        lib.__gmpz_clear(y)
        lib.__gmpz_clear(z)
