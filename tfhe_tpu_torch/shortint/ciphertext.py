"""shortint ciphertext with degree / noise-level metadata (port of
tfhe_tpu/shortint/ciphertext.py; round outputs stay on the torch device).

Mirrors shortint/ciphertext/standard.rs:20-29: the Degree (max reachable
plaintext value) and NoiseLevel (multiple of nominal fresh noise) ride along
with every ciphertext and drive the smart-op bootstrap decisions.  Metadata
lives host-side (plain ints) — device code never branches on it.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..ops.torus import to_u64

NOMINAL_NOISE = 1

_M64 = 1 << 64


class DeviceLweBatch:
    """One PBS round's output batch, resident on device ((B, n+1) int64
    torus words, ops/torus.py).

    The host copy is downloaded lazily and cached — a chain of PBS rounds
    that only feeds the next round never crosses the host link (the
    reference's analog is device-resident RadixCiphertext::Cuda,
    high_level_api/integers/unsigned/inner.rs:22-60)."""

    __slots__ = ("arr", "_np")

    # host materialisations: batches downloaded (each once, then cached), in
    # the style of the kernel wrappers' launch counts
    downloads = 0

    def __init__(self, arr):
        self.arr = arr
        self._np = None

    def to_np(self) -> np.ndarray:
        if self._np is None:
            self._np = to_u64(self.arr)
            DeviceLweBatch.downloads += 1
        return self._np


class LazyLweData:
    """Lazy linear form over device-resident LWE rows:
    value = sum_j coeff_j * parent_j[row_j] + const   (wrapping mod 2^64).

    The shortint linear ops (unchecked_add/sub/scalar_mul) hit the operator
    overloads below and stay symbolic; apply_lookup_table_batch compiles the
    forms of a whole round into ONE device gather+combine, so inter-round
    linear algebra never leaves the device.  Any other consumer (decrypt,
    serialization, non-batched ops) materializes transparently via
    __array__ with the parent download cached."""

    __slots__ = ("terms", "const", "width")
    __array_priority__ = 1000

    def __init__(self, terms, const, width: int):
        self.terms = tuple(terms)   # ((coeff, DeviceLweBatch, row), ...)
        self.const = const          # np (width,) u64 or None
        self.width = width

    # -- materialization ----------------------------------------------
    @property
    def shape(self):
        return (self.width,)

    def __array__(self, dtype=None, copy=None):
        out = (np.zeros(self.width, np.uint64) if self.const is None
               else np.array(self.const, dtype=np.uint64))
        with np.errstate(over="ignore"):
            for c, h, r in self.terms:
                out += np.uint64(c % _M64) * h.to_np()[r]
        return out if dtype is None else out.astype(dtype)

    def __getitem__(self, idx):
        return np.asarray(self)[idx]

    def __len__(self):
        return self.width

    # -- lazy linear algebra -------------------------------------------
    @staticmethod
    def _cadd(a, b):
        if a is None:
            return None if b is None else np.array(b, dtype=np.uint64)
        if b is None:
            return np.array(a, dtype=np.uint64)
        with np.errstate(over="ignore"):
            return (np.asarray(a, dtype=np.uint64)
                    + np.asarray(b, dtype=np.uint64))

    def _as_lazy(self, other):
        if isinstance(other, LazyLweData):
            return other
        if isinstance(other, np.ndarray) and other.shape == (self.width,):
            return LazyLweData((), other, self.width)
        return None

    def __add__(self, other):
        o = self._as_lazy(other)
        if o is None:
            return np.asarray(self) + other
        if len(self.terms) + len(o.terms) > 16:   # safety valve
            return np.asarray(self) + np.asarray(o)
        return LazyLweData(self.terms + o.terms,
                           self._cadd(self.const, o.const), self.width)

    __radd__ = __add__

    def __mul__(self, scalar):
        if not isinstance(scalar, (int, np.integer)):
            return np.asarray(self) * scalar
        s = int(scalar) % _M64
        const = None
        if self.const is not None:
            with np.errstate(over="ignore"):
                const = self.const * np.uint64(s)
        return LazyLweData(tuple((c * s % _M64, h, r) for c, h, r in self.terms),
                           const, self.width)

    __rmul__ = __mul__

    def __neg__(self):
        return self * (_M64 - 1)

    def __sub__(self, other):
        o = self._as_lazy(other)
        if o is None:
            return np.asarray(self) - other
        return self + (-o)

    def __rsub__(self, other):
        o = self._as_lazy(other)
        if o is None:
            return other - np.asarray(self)
        return o + (-self)


@dataclass
class Ciphertext:
    data: np.ndarray  # (n+1,) uint64 — LWE under the big key (KS->PBS order)
    degree: int
    noise_level: int
    message_modulus: int
    carry_modulus: int

    @property
    def lwe_dimension(self) -> int:
        return self.data.shape[-1] - 1

    def with_data(self, data, degree=None, noise_level=None) -> "Ciphertext":
        return Ciphertext(
            data=data,
            degree=self.degree if degree is None else degree,
            noise_level=self.noise_level if noise_level is None else noise_level,
            message_modulus=self.message_modulus,
            carry_modulus=self.carry_modulus,
        )

    def copy(self) -> "Ciphertext":
        # a LazyLweData is never changed in place (its ops build new forms),
        # so a copy shares it and stays on the device
        data = self.data if isinstance(self.data, LazyLweData) else np.array(self.data)
        return replace(self, data=data)
