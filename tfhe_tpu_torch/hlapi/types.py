"""FheUint / FheInt / FheBool with operator overloads.

Port of tfhe_tpu/hlapi/types.py.

Analog of high_level_api/integers/ (unsigned/ops.rs:72 operator impls with
per-op dispatch to the thread-global server key).  Widths are blocks of
log2(message_modulus) bits (32 blocks of 2 bits for FheUint64 at 2_2).
"""

from __future__ import annotations

from ..integer.ciphertext import BooleanBlock, RadixCiphertext, SignedRadixCiphertext
from .global_state import internal_server_key


class FheBool:
    def __init__(self, inner: BooleanBlock):
        self.inner = inner

    @classmethod
    def encrypt(cls, value: bool, client_key) -> "FheBool":
        return cls(client_key.integer_key.encrypt_bool(bool(value)))

    def decrypt(self, client_key) -> bool:
        return client_key.integer_key.decrypt_bool(self.inner)

    def __and__(self, other: "FheBool") -> "FheBool":
        sk = internal_server_key().integer_key
        out = sk.key.bitand(self.inner.block, other.inner.block)
        return FheBool(BooleanBlock(out))

    def __or__(self, other: "FheBool") -> "FheBool":
        sk = internal_server_key().integer_key
        out = sk.key.bitor(self.inner.block, other.inner.block)
        return FheBool(BooleanBlock(out))

    def __xor__(self, other: "FheBool") -> "FheBool":
        sk = internal_server_key().integer_key
        out = sk.key.bitxor(self.inner.block, other.inner.block)
        return FheBool(BooleanBlock(out))

    def __invert__(self) -> "FheBool":
        sk = internal_server_key().integer_key
        return FheBool(sk.boolean_not(self.inner))

    def if_then_else(self, a: "FheUintBase", b: "FheUintBase"):
        sk = internal_server_key().integer_key
        out = sk.if_then_else_parallelized(self.inner, a.inner, b.inner)
        return type(a)(out)

    select = if_then_else


class FheUintBase:
    NUM_BITS: int = 0

    def __init__(self, inner: RadixCiphertext):
        self.inner = inner

    # -- encryption --------------------------------------------------------

    @classmethod
    def num_blocks(cls, params) -> int:
        bits_per_block = (params.message_modulus - 1).bit_length()
        return cls.NUM_BITS // bits_per_block

    @classmethod
    def encrypt(cls, value: int, client_key) -> "FheUintBase":
        ik = client_key.integer_key
        n = cls.num_blocks(ik.params)
        return cls(ik.encrypt_radix(value, n))

    @classmethod
    def encrypt_trivial(cls, value: int) -> "FheUintBase":
        sk = internal_server_key().integer_key
        n = cls.num_blocks(sk.params)
        return cls(sk.create_trivial_radix(value, n))

    @classmethod
    def generate_oblivious_pseudo_random(cls, seed: int,
                                         random_bits_count: int | None = None):
        """Server-side uniform pseudorandom value from a public seed
        (high_level_api/integers/oprf.rs): full width, or bounded to
        [0, 2^random_bits_count)."""
        from ..integer.oprf import OprfServerKey

        sk = internal_server_key().integer_key
        n = cls.num_blocks(sk.params)
        ok = OprfServerKey.from_compute_key(sk)
        if random_bits_count is None:
            return cls(ok.generate_oblivious_pseudo_random_unsigned_integer(
                seed, n, sk))
        return cls(ok.generate_oblivious_pseudo_random_unsigned_integer_bounded(
            seed, random_bits_count, n, sk))

    @classmethod
    def generate_oblivious_pseudo_random_bounded(cls, seed: int,
                                                 random_bits_count: int):
        return cls.generate_oblivious_pseudo_random(seed, random_bits_count)

    def decrypt(self, client_key) -> int:
        return client_key.integer_key.decrypt_radix(self.inner)

    # -- arithmetic --------------------------------------------------------

    def _sk(self):
        return internal_server_key().integer_key

    def _coerce(self, other):
        if isinstance(other, FheUintBase):
            return other.inner, False
        return int(other), True

    def __add__(self, other):
        sk = self._sk()
        o, scalar = self._coerce(other)
        out = sk.scalar_add_parallelized(self.inner, o) if scalar \
            else sk.add_parallelized(self.inner, o)
        return type(self)(out)

    __radd__ = __add__

    def __sub__(self, other):
        sk = self._sk()
        o, scalar = self._coerce(other)
        out = sk.scalar_sub_parallelized(self.inner, o) if scalar \
            else sk.sub_parallelized(self.inner, o)
        return type(self)(out)

    def __mul__(self, other):
        sk = self._sk()
        o, scalar = self._coerce(other)
        out = sk.scalar_mul_parallelized(self.inner, o) if scalar \
            else sk.mul_parallelized(self.inner, o)
        return type(self)(out)

    __rmul__ = __mul__

    def __neg__(self):
        return type(self)(self._sk().neg_parallelized(self.inner))

    def __and__(self, other):
        sk = self._sk()
        o, scalar = self._coerce(other)
        out = sk.scalar_bitand_parallelized(self.inner, o) if scalar \
            else sk.bitand_parallelized(self.inner, o)
        return type(self)(out)

    __rand__ = __and__

    def __or__(self, other):
        sk = self._sk()
        o, scalar = self._coerce(other)
        out = sk.scalar_bitor_parallelized(self.inner, o) if scalar \
            else sk.bitor_parallelized(self.inner, o)
        return type(self)(out)

    __ror__ = __or__

    def __xor__(self, other):
        sk = self._sk()
        o, scalar = self._coerce(other)
        out = sk.scalar_bitxor_parallelized(self.inner, o) if scalar \
            else sk.bitxor_parallelized(self.inner, o)
        return type(self)(out)

    __rxor__ = __xor__

    def __invert__(self):
        return type(self)(self._sk().bitnot(self.inner))

    def __floordiv__(self, other):
        sk = self._sk()
        o, scalar = self._coerce(other)
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
            if isinstance(self.inner, SignedRadixCiphertext):
                o = SignedRadixCiphertext(o.blocks)
        return type(self)(sk.div_parallelized(self.inner, o))

    __truediv__ = __floordiv__

    def __mod__(self, other):
        sk = self._sk()
        o, scalar = self._coerce(other)
        if scalar:
            o = sk.create_trivial_radix(o, self.inner.num_blocks)
            if isinstance(self.inner, SignedRadixCiphertext):
                o = SignedRadixCiphertext(o.blocks)
        return type(self)(sk.rem_parallelized(self.inner, o))

    def div_rem(self, other):
        sk = self._sk()
        q, r = sk.div_rem_parallelized(self.inner, other.inner)
        return type(self)(q), type(self)(r)

    def __lshift__(self, amount):
        sk = self._sk()
        if isinstance(amount, FheUintBase):
            return type(self)(sk.left_shift_parallelized(self.inner, amount.inner))
        return type(self)(sk.scalar_left_shift_parallelized(self.inner, int(amount)))

    def __rshift__(self, amount):
        sk = self._sk()
        if isinstance(amount, FheUintBase):
            return type(self)(sk.right_shift_parallelized(self.inner, amount.inner))
        return type(self)(sk.scalar_right_shift_parallelized(self.inner, int(amount)))

    def rotate_left(self, amount):
        sk = self._sk()
        if isinstance(amount, FheUintBase):
            return type(self)(sk.rotate_left_parallelized(self.inner, amount.inner))
        return type(self)(sk.scalar_rotate_left_parallelized(self.inner, int(amount)))

    def rotate_right(self, amount):
        sk = self._sk()
        if isinstance(amount, FheUintBase):
            return type(self)(sk.rotate_right_parallelized(self.inner, amount.inner))
        return type(self)(sk.scalar_rotate_right_parallelized(self.inner, int(amount)))

    def count_ones(self):
        return type(self)(self._sk().count_ones_parallelized(self.inner))

    def count_zeros(self):
        return type(self)(self._sk().count_zeros_parallelized(self.inner))

    def leading_zeros(self):
        return type(self)(self._sk().leading_zeros_parallelized(self.inner))

    def trailing_zeros(self):
        return type(self)(self._sk().trailing_zeros_parallelized(self.inner))

    def ilog2(self):
        return type(self)(self._sk().ilog2_parallelized(self.inner))

    def is_even(self) -> "FheBool":
        return FheBool(self._sk().is_even_parallelized(self.inner))

    def is_odd(self) -> "FheBool":
        return FheBool(self._sk().is_odd_parallelized(self.inner))

    def overflowing_add(self, other):
        sk = self._sk()
        if isinstance(self.inner, SignedRadixCiphertext):
            out, ovf = sk.signed_overflowing_add_parallelized(self.inner, other.inner)
        else:
            out, ovf = sk.overflowing_add_parallelized(self.inner, other.inner)
        return type(self)(out), FheBool(ovf)

    def squash_noise(self):
        """Re-encrypt on the u128 torus (high_level_api squashed-noise types);
        decrypt with ClientKey.decrypt_squashed.  One batched KS -> PBS128
        over the blocks (K1, then K5 on the card)."""
        hsk = internal_server_key()
        if getattr(hsk, "noise_squashing_key", None) is None:
            raise ValueError("noise squashing not enabled in Config")
        return hsk.noise_squashing_key.squash_radix_ciphertext_noise(
            hsk.integer_key, self.inner)

    def overflowing_sub(self, other):
        sk = self._sk()
        if isinstance(self.inner, SignedRadixCiphertext):
            out, ovf = sk.signed_overflowing_sub_parallelized(self.inner, other.inner)
        else:
            out, ovf = sk.overflowing_sub_parallelized(self.inner, other.inner)
        return type(self)(out), FheBool(ovf)

    # -- comparisons -------------------------------------------------------

    def _cmp(self, other, enc_name, scalar_name) -> FheBool:
        sk = self._sk()
        o, scalar = self._coerce(other)
        if scalar:
            return FheBool(getattr(sk, scalar_name)(self.inner, o))
        return FheBool(getattr(sk, enc_name)(self.inner, o))

    def eq(self, other) -> FheBool:
        return self._cmp(other, "eq_parallelized", "scalar_eq_parallelized")

    def ne(self, other) -> FheBool:
        return self._cmp(other, "ne_parallelized", "scalar_ne_parallelized")

    def lt(self, other) -> FheBool:
        return self._cmp(other, "lt_parallelized", "scalar_lt_parallelized")

    def le(self, other) -> FheBool:
        return self._cmp(other, "le_parallelized", "scalar_le_parallelized")

    def gt(self, other) -> FheBool:
        return self._cmp(other, "gt_parallelized", "scalar_gt_parallelized")

    def ge(self, other) -> FheBool:
        return self._cmp(other, "ge_parallelized", "scalar_ge_parallelized")

    # Python comparison operators as sugar over the named methods (the Rust
    # reference can only offer .gt()/.lt()-style methods since its operators
    # must return bool; Python's can return FheBool).  __eq__/__ne__ also
    # return encrypted FheBool — an identity-based `a == 99` silently
    # yielding a plaintext False is a far worse footgun than ciphertexts
    # being unhashable (numpy arrays made the same trade).
    __hash__ = None

    def __eq__(self, other):
        try:
            return self.eq(other)
        except (TypeError, AttributeError):
            return NotImplemented

    def __ne__(self, other):
        try:
            return self.ne(other)
        except (TypeError, AttributeError):
            return NotImplemented

    def __lt__(self, other) -> FheBool:
        return self.lt(other)

    def __le__(self, other) -> FheBool:
        return self.le(other)

    def __gt__(self, other) -> FheBool:
        return self.gt(other)

    def __ge__(self, other) -> FheBool:
        return self.ge(other)

    def min(self, other):
        return type(self)(self._sk().min_parallelized(self.inner, other.inner))

    def max(self, other):
        return type(self)(self._sk().max_parallelized(self.inner, other.inner))


class FheIntBase(FheUintBase):
    """Two's-complement signed integers (high_level_api/integers/signed/).

    The inner ciphertext is a SignedRadixCiphertext, so comparisons, right
    shifts, and division dispatch to the signed circuits in the integer layer.
    """

    @classmethod
    def encrypt(cls, value: int, client_key) -> "FheIntBase":
        ik = client_key.integer_key
        n = cls.num_blocks(ik.params)
        return cls(ik.encrypt_signed_radix(value, n))

    @classmethod
    def encrypt_trivial(cls, value: int) -> "FheIntBase":
        sk = internal_server_key().integer_key
        n = cls.num_blocks(sk.params)
        return cls(SignedRadixCiphertext(sk.create_trivial_radix(value, n).blocks))

    def decrypt(self, client_key) -> int:
        return client_key.integer_key.decrypt_signed_radix(self.inner)

    def abs(self) -> "FheIntBase":
        return type(self)(self._sk().abs_parallelized(self.inner))


# -- concrete widths (generated) -------------------------------------------
# The full reference width set (high_level_api/mod.rs pub use list): 2..16
# even, 24..256 step 8, then 512/1024/2048 — signed and unsigned, 82 types.
FHE_WIDTHS = (list(range(2, 17, 2)) + list(range(24, 257, 8))
              + [512, 1024, 2048])

ALL_UINT_TYPES: list = []
ALL_INT_TYPES: list = []
for _bits in FHE_WIDTHS:
    _u = type(f"FheUint{_bits}", (FheUintBase,), {"NUM_BITS": _bits})
    _i = type(f"FheInt{_bits}", (FheIntBase,), {"NUM_BITS": _bits})
    globals()[_u.__name__] = _u
    globals()[_i.__name__] = _i
    ALL_UINT_TYPES.append(_u)
    ALL_INT_TYPES.append(_i)
del _bits, _u, _i


def bitonic_shuffle(values: list, key_bits: int = 40, seed: int = 0):
    """Uniformly shuffle a list of Fhe integers with OPRF-random sort keys
    through the bitonic network (high_level_api/integers/shuffle.rs:24).
    key_bits trades key-collision probability (non-uniformity) against
    per-comparison cost."""
    from ..integer.oprf import OprfServerKey

    if not values:
        return []
    sk = internal_server_key().integer_key
    ok = OprfServerKey.from_compute_key(sk)
    inner = sk.bitonic_shuffle(ok, [v.inner for v in values], key_bits, seed)
    return [type(values[0])(ct) for ct in inner]


def match_value(a, matches: list):
    """(result, matched) for a plaintext (input -> output) mapping applied
    to an encrypted value (integer MatchValues, vector_find.rs:24)."""
    sk = internal_server_key().integer_key
    result, matched = sk.match_value_parallelized(a.inner, matches)
    return type(a)(result), FheBool(matched)


def match_value_or(a, matches: list, default: int):
    sk = internal_server_key().integer_key
    return type(a)(sk.match_value_or_parallelized(a.inner, matches, default))
