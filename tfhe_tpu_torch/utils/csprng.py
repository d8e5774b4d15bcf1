"""AES-128-CTR CSPRNG with tree forking, bit-compatible with tfhe-csprng.

Reference behavior (studied, not copied):
  - tfhe-csprng/src/generators/aes_ctr/generic.rs: byte at flat position ``pos``
    of the keystream is ``AES_ECB(key, LE128(pos // 16 + offset))[pos % 16]``.
  - Key bytes: the u128 seed in little-endian byte order
    (generic.rs:94 ``u128::from_le``, soft/block_cipher.rs:15 ``to_ne_bytes``).
  - Fork (states.rs:156 ``check_fork``): child ``i`` of ``fork(n, nbytes)`` owns
    the window ``[pos + i*nbytes, pos + (i+1)*nbytes)``; the parent advances to
    ``pos + n*nbytes``.  Parallel and sequential generation therefore consume
    identical streams.

The sampling layer mirrors tfhe/src/core_crypto/commons/math/random/:
  - uniform u64/u32: from_le_bytes (uniform.rs:17-23)
  - uniform binary: one byte per bit, ``byte & 1`` (uniform_binary.rs:16)
  - Gaussian pair: Box-Muller with rejection (gaussian.rs:40-69); a single
    torus sample draws a pair and keeps the first element (gaussian.rs:151).
  - TUniform: ceil((b+2)/8) bytes, randomized rounding (t_uniform.rs:84-112)

The keystream comes from the AES-NI CTR core in csrc/aes_ctr.cpp, built with
g++ at first use (utils/build.py), or from the `cryptography` package where
that imports; with neither, sampling raises.  Host-side (client/keygen)
code: numpy only.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

# bytes of keystream one AES block gives (tfhe-csprng's BYTES_PER_AES_CALL)
BYTES_PER_AES_CALL = 16

# tfhe/src/core_crypto/commons/generators/encryption/mod.rs:23
PER_SAMPLE_TARGET_FAILURE_PROBABILITY_LOG2 = -128.0


class _Backend:
    """The AES-CTR keystream source, chosen once at first use."""

    lib = None        # ctypes library of csrc/aes_ctr.cpp, or None
    cipher = None     # cryptography's Cipher/algorithms/modes, or None
    ready = False


def _native_lib():
    import ctypes

    from .build import CSRC, build_shared_libraries

    (so,) = build_shared_libraries([(
        "tfhe_torch_aes", [CSRC / "aes_ctr.cpp"],
        ["g++", "-O3", "-maes", "-msse4.1", "-shared", "-fPIC"])])
    lib = ctypes.CDLL(str(so))
    lib.tfhe_aes_ctr_blocks.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint64,
        ctypes.c_void_p,
    ]
    lib.tfhe_aes_ctr_blocks.restype = None
    return lib


def _backend() -> _Backend:
    if not _Backend.ready:
        errors = []
        try:
            _Backend.lib = _native_lib()
        except (OSError, RuntimeError) as e:   # no g++ / no AES-NI
            errors.append(f"native AES: {e}")
            try:
                from cryptography.hazmat.primitives.ciphers import (
                    Cipher, algorithms, modes)
                _Backend.cipher = (Cipher, algorithms, modes)
            except ImportError as e2:
                errors.append(f"cryptography: {e2}")
                raise RuntimeError("no AES-CTR backend for the CSPRNG: "
                                   + "; ".join(errors)) from e2
        _Backend.ready = True
    return _Backend


def _aes_ecb(key_bytes: bytes, blocks: np.ndarray) -> np.ndarray:
    """Encrypt an array of 16-byte blocks (shape (n, 16) uint8) with AES-128-ECB."""
    cipher, algorithms, modes = _backend().cipher
    enc = cipher(algorithms.AES(key_bytes), modes.ECB()).encryptor()
    out = enc.update(blocks.tobytes()) + enc.finalize()
    return np.frombuffer(out, dtype=np.uint8).reshape(-1, 16)


def _aes_ctr_blocks(key_bytes: bytes, start_ctr: int, count: int) -> np.ndarray:
    """Keystream blocks for counters start_ctr..start_ctr+count-1 (LE128)."""
    lib = _backend().lib
    if lib is not None:
        out = np.empty(count * 16, dtype=np.uint8)
        lib.tfhe_aes_ctr_blocks(
            key_bytes,
            start_ctr & 0xFFFFFFFFFFFFFFFF,
            (start_ctr >> 64) & 0xFFFFFFFFFFFFFFFF,
            count,
            out.ctypes.data,
        )
        return out.reshape(count, 16)
    return _aes_ecb(key_bytes, _counter_blocks(start_ctr, count))


def _counter_blocks(start_ctr: int, count: int) -> np.ndarray:
    """LE128 counter blocks for counters start_ctr .. start_ctr+count-1 (mod 2^128)."""
    ctrs = (start_ctr + np.arange(count, dtype=object)) % (1 << 128)
    buf = np.empty((count, 16), dtype=np.uint8)
    # little-endian: byte j = (ctr >> (8*j)) & 0xff
    lo = np.array([int(c) & 0xFFFFFFFFFFFFFFFF for c in ctrs], dtype=np.uint64)
    hi = np.array([(int(c) >> 64) & 0xFFFFFFFFFFFFFFFF for c in ctrs], dtype=np.uint64)
    buf[:, :8] = lo[:, None].view(np.uint8).reshape(count, 8)
    buf[:, 8:] = hi[:, None].view(np.uint8).reshape(count, 8)
    return buf


class ByteStream:
    """A window [pos, end) into the AES-CTR keystream of (key, offset).

    Matches tfhe-csprng AesCtrGenerator semantics at byte granularity.
    Positions are flat byte indices: aes_index * 16 + byte_index.
    """

    __slots__ = ("key_bytes", "offset", "pos", "end", "_cache_start", "_cache")

    def __init__(self, seed: int | bytes, offset: int = 0, pos: int = 0, end: int | None = None):
        if isinstance(seed, bytes):
            self.key_bytes = seed
        else:
            # Seed(u128) -> little-endian key bytes (tfhe-csprng generic.rs:94)
            self.key_bytes = int(seed).to_bytes(16, "little")
        self.offset = offset
        self.pos = pos
        # 2^132 = full table (aes_index in [0, 2^128), 16 bytes each)
        self.end = (1 << 132) if end is None else end
        self._cache_start = 0
        self._cache = b""

    # -- raw bytes ---------------------------------------------------------

    def take(self, n: int) -> np.ndarray:
        """Return the next n bytes as uint8 array and advance."""
        if self.pos + n > self.end:
            raise RuntimeError("ByteStream exhausted (fork window overrun)")
        out = self._bytes_at(self.pos, n)
        self.pos += n
        return out

    def _bytes_at(self, pos: int, n: int) -> np.ndarray:
        if n == 0:
            return np.empty(0, dtype=np.uint8)
        first_block = pos // 16
        last_block = (pos + n - 1) // 16
        nblocks = last_block - first_block + 1
        blocks = _aes_ctr_blocks(self.key_bytes,
                                 (first_block + self.offset) % (1 << 128), nblocks)
        flat = blocks.reshape(-1)
        off = pos - first_block * 16
        return flat[off : off + n].copy()

    def skip(self, n: int) -> None:
        self.pos += n

    def remaining(self) -> int:
        return self.end - self.pos

    # -- forking -----------------------------------------------------------

    def fork(self, n_children: int, bytes_per_child: int) -> list["ByteStream"]:
        """Split into n children of fixed windows; parent advances past them."""
        total = n_children * bytes_per_child
        if self.pos + total > self.end:
            raise RuntimeError("Fork too large for remaining stream window")
        children = [
            ByteStream(
                self.key_bytes,
                self.offset,
                self.pos + i * bytes_per_child,
                self.pos + (i + 1) * bytes_per_child,
            )
            for i in range(n_children)
        ]
        self.pos += total
        return children

    # -- typed sampling (tfhe/core_crypto/commons/math/random) -------------

    def uniform_u64(self, count: int) -> np.ndarray:
        raw = self.take(count * 8)
        return raw.view("<u8").copy()

    def uniform_u32(self, count: int) -> np.ndarray:
        raw = self.take(count * 4)
        return raw.view("<u4").copy()

    def uniform_scalar(self, count: int, bits: int = 64) -> np.ndarray:
        """``count`` uniform words of the bits-wide torus as uint64 (a u32
        draw takes 4 bytes a word)."""
        if bits == 64:
            return self.uniform_u64(count)
        if bits == 32:
            return self.uniform_u32(count).astype(np.uint64)
        raise ValueError(bits)

    def uniform_u128(self) -> int:
        raw = self.take(16)
        return int.from_bytes(raw.tobytes(), "little")

    def binary(self, count: int) -> np.ndarray:
        """One byte per output element, value = byte & 1 (uniform_binary.rs:16)."""
        raw = self.take(count)
        return (raw & 1).astype(np.uint64)

    def gaussian_torus(self, count: int, std: float, mean: float,
                       bits: int = 64) -> np.ndarray:
        """`count` single Gaussian samples of the bits-wide torus as uint64
        (each draws a Box-Muller pair, keeps the first: gaussian.rs:151-163).

        Sample k consumes exactly the k-th *successful* 16-byte chunk of the
        stream; failed chunks in between are consumed and discarded (each
        attempt reads 8+8 bytes; success iff 0 < u^2+v^2 < 1)."""
        if count == 0:
            return np.empty(0, dtype=np.uint64)
        results = np.empty(count, dtype=np.float64)
        found = 0
        while found < count:
            todo = count - found
            # over-draw: expected success rate pi/4
            n_try = min(max(16, int(todo / 0.75) + 8), self.remaining() // 16)
            if n_try <= 0:
                raise RuntimeError("ByteStream exhausted during gaussian sampling")
            raw = self.take(n_try * 16)
            pairs = raw.view("<i8").reshape(n_try, 2)
            u = pairs[:, 0].astype(np.float64) * 2.0 ** (-63)
            v = pairs[:, 1].astype(np.float64) * 2.0 ** (-63)
            s = u * u + v * v
            idx = np.nonzero((s > 0.0) & (s < 1.0))[0]
            if len(idx) >= todo:
                # rewind the bytes after the todo-th success
                self.pos -= (n_try - 1 - int(idx[todo - 1])) * 16
                idx = idx[:todo]
            if len(idx):
                cst = std * np.sqrt(-2.0 * np.log(s[idx]) / s[idx])
                results[found:found + len(idx)] = u[idx] * cst + mean
                found += len(idx)
        return _from_torus(results, bits)

    def tuniform(self, count: int, bound_log2: int, bits: int = 64) -> np.ndarray:
        """TUniform(bound_log2) torus samples (t_uniform.rs:84-112), masked to
        the bits-wide torus."""
        required_bits = bound_log2 + 2
        required_bytes = (required_bits + 7) // 8
        raw = self.take(count * required_bytes).reshape(count, required_bytes)
        buf = np.zeros((count, 8), dtype=np.uint8)
        buf[:, :required_bytes] = raw
        vals = buf.view("<u8").reshape(count)
        mask = np.uint64((1 << required_bits) - 1)
        cand = vals & mask
        bit = cand & np.uint64(1)
        cand = cand >> np.uint64(1)
        cand = cand + bit
        cand = cand - np.uint64(1 << bound_log2)  # wrapping in uint64
        return cand & np.uint64(0xFFFFFFFF) if bits == 32 else cand


def _from_torus(x: np.ndarray, bits: int = 64) -> np.ndarray:
    """FromTorus: frac(x) scaled to the bits-wide torus, rounded
    (torus/mod.rs:72-78), as uint64.

    Rust casts f64 -> iN with saturating semantics; only the exact boundary
    value 2^(bits-1) can occur (fract == 0.5), so saturate it explicitly."""
    f = np.round((x - np.round(x)) * 2.0 ** bits)
    hi = 2.0 ** (bits - 1)
    signed = np.where(f >= hi, 0.0, f).astype(np.int64)
    signed = np.where(f >= hi, np.int64((1 << (bits - 1)) - 1), signed)
    out = signed.astype(np.uint64)
    return out & np.uint64(0xFFFFFFFF) if bits == 32 else out


# -- distributions ---------------------------------------------------------


@dataclass(frozen=True)
class Gaussian:
    """Gaussian noise of standard deviation ``std`` (a torus fraction, as
    tfhe_tpu's boolean TFHE_LIB set passes it)."""

    std: float
    mean: float = 0.0

    def sample_bytes(self) -> int:
        # 16 bytes per attempt; budget = attempts needed for 2^-128 failure
        attempts = math.ceil(PER_SAMPLE_TARGET_FAILURE_PROBABILITY_LOG2
                             / math.log2(1.0 - math.pi / 4.0))
        return 16 * attempts

    def sample(self, stream: ByteStream, count: int, bits: int = 64) -> np.ndarray:
        return stream.gaussian_torus(count, self.std, self.mean, bits)

    def variance(self, bits: int) -> float:
        """The variance on the 2^bits integer scale."""
        return (self.std * (2.0 ** bits)) ** 2


@dataclass(frozen=True)
class TUniform:
    bound_log2: int

    def sample_bytes(self) -> int:
        return (self.bound_log2 + 2 + 7) // 8

    def sample(self, stream: ByteStream, count: int, bits: int = 64) -> np.ndarray:
        return stream.tuniform(count, self.bound_log2, bits)

    def variance(self, bits: int) -> float:
        """The variance of the law on [-2^b, 2^b] with half weight at the
        ends: (2^(2b+1) + 1) / 6, whatever the torus width."""
        return (2.0 ** (2 * self.bound_log2 + 1) + 1.0) / 6.0


# -- generators mirroring tfhe's generator types ---------------------------


class SecretRandomGenerator:
    def __init__(self, seed: int):
        self.stream = ByteStream(seed)

    def binary_key(self, count: int) -> np.ndarray:
        return self.stream.binary(count)


class DeterministicSeeder:
    """commons/generators/seeder.rs:36 — seeds drawn as u128 LE from own stream."""

    def __init__(self, seed: int):
        self.stream = ByteStream(seed)

    def seed(self) -> int:
        return self.stream.uniform_u128()


class EncryptionRandomGenerator:
    """Mask generator (public, seeded) + noise generator (seeded from a Seeder).

    commons/generators/encryption/mod.rs:91-99.
    """

    def __init__(self, seed: int, seeder: DeterministicSeeder):
        self.mask = ByteStream(seed)
        self.noise = ByteStream(seeder.seed())

    @classmethod
    def _from_streams(cls, mask: ByteStream, noise: ByteStream) -> "EncryptionRandomGenerator":
        obj = cls.__new__(cls)
        obj.mask = mask
        obj.noise = noise
        return obj

    def fork(self, n_children: int, mask_elements: int, noise_elements: int,
             noise_distribution, bits: int = 64) -> list["EncryptionRandomGenerator"]:
        """Fork both sub-streams; byte budgets follow the reference fork configs
        (mask: bits / 8 bytes per element of the bits-wide torus, 4 for the
        KS32 key's u32, 8 for u64, 16 for the u128 noise-squashing key; noise: distribution-dependent
        per-sample budget)."""
        mask_bytes = mask_elements * (bits // 8)
        noise_bytes = noise_elements * noise_distribution.sample_bytes()
        mask_children = self.mask.fork(n_children, mask_bytes)
        noise_children = self.noise.fork(n_children, noise_bytes)
        return [
            EncryptionRandomGenerator._from_streams(m, n)
            for m, n in zip(mask_children, noise_children)
        ]
