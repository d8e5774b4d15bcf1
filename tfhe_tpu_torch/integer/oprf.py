"""Integer-level OPRF (integer/oprf.rs): radix pseudorandom generation
(port of tfhe_tpu/integer/oprf.py, the same words from the same seeds).

Each radix block receives up to log2(message_modulus) random bits from the
shortint OPRF (one batched PBS across all blocks); bounded and custom-range
variants follow integer/oprf.rs:629-688 (multiply by the bound, shift right
by the input-bit count).
"""

from __future__ import annotations

from ..shortint.oprf import OprfPrivateKey as ShortintOprfPrivateKey
from ..shortint.oprf import OprfServerKey as ShortintOprfServerKey
from .ciphertext import RadixCiphertext, SignedRadixCiphertext


class OprfPrivateKey:
    """integer::OprfPrivateKey — dedicated key at the compute parameters."""

    def __init__(self, client_key, seed: int | None = None):
        ck = client_key.key if hasattr(client_key, "key") else client_key
        self.key = ShortintOprfPrivateKey(ck, seed)


class OprfServerKey:
    """integer::OprfServerKey — dedicated OPRF bootstrapping key."""

    def __init__(self, key: ShortintOprfServerKey):
        self.key = key

    @classmethod
    def new(cls, oprf_pk: OprfPrivateKey, target_ck, seed: int | None = None,
            device="cuda"):
        ck = target_ck.key if hasattr(target_ck, "key") else target_ck
        return cls(ShortintOprfServerKey.new(oprf_pk.key, ck, seed, device=device))

    @classmethod
    def from_compute_key(cls, target_sks):
        sk = target_sks.key if hasattr(target_sks, "key") else target_sks
        return cls(ShortintOprfServerKey.from_compute_key(sk))

    # -- generation (integer/oprf.rs:138-375) ---------------------------

    def _msg_bits(self, target_sks) -> int:
        return (target_sks.msg - 1).bit_length()

    def generate_oblivious_pseudo_random_unsigned_integer(
            self, seed: int, num_blocks: int, target_sks) -> RadixCiphertext:
        """Uniform in [0, 2^(num_blocks * msg_bits))."""
        mb = self._msg_bits(target_sks)
        blocks = self.key.generate_bits_blocks(seed, [mb] * num_blocks)
        return RadixCiphertext(blocks)

    def generate_oblivious_pseudo_random_unsigned_integer_bounded(
            self, seed: int, random_bits_count: int, num_blocks: int,
            target_sks) -> RadixCiphertext:
        """Uniform in [0, 2^random_bits_count); high blocks trivially 0."""
        mb = self._msg_bits(target_sks)
        assert random_bits_count <= num_blocks * mb
        full, rem = divmod(random_bits_count, mb)
        bits = [mb] * full + ([rem] if rem else [])
        blocks = self.key.generate_bits_blocks(seed, bits) if bits else []
        blocks += [target_sks.key.create_trivial(0)
                   for _ in range(num_blocks - len(blocks))]
        return RadixCiphertext(blocks)

    def generate_oblivious_pseudo_random_signed_integer(
            self, seed: int, num_blocks: int, target_sks) -> SignedRadixCiphertext:
        mb = self._msg_bits(target_sks)
        blocks = self.key.generate_bits_blocks(seed, [mb] * num_blocks)
        return SignedRadixCiphertext(blocks)

    def generate_oblivious_pseudo_random_signed_integer_bounded(
            self, seed: int, random_bits_count: int, num_blocks: int,
            target_sks) -> SignedRadixCiphertext:
        u = self.generate_oblivious_pseudo_random_unsigned_integer_bounded(
            seed, random_bits_count, num_blocks, target_sks)
        return SignedRadixCiphertext(u.blocks)

    def generate_oblivious_pseudo_random_unsigned_custom_range(
            self, seed: int, num_input_random_bits: int,
            excluded_upper_bound: int, num_blocks_output: int,
            target_sks) -> RadixCiphertext:
        """Almost-uniform in [0, excluded_upper_bound): X * bound >> k
        (integer/oprf.rs:629-688)."""
        assert excluded_upper_bound > 0
        mb = self._msg_bits(target_sks)
        assert excluded_upper_bound & (excluded_upper_bound - 1), \
            "power-of-two bound: use the cheaper bounded variant"
        ceil_log2 = excluded_upper_bound.bit_length()
        assert ceil_log2 <= num_blocks_output * mb
        post_mul_bits = num_input_random_bits + ceil_log2
        num_blocks = -(-post_mul_bits // mb)
        x = self.generate_oblivious_pseudo_random_unsigned_integer_bounded(
            seed, num_input_random_bits, num_blocks, target_sks)
        mul = target_sks.scalar_mul_parallelized(x, excluded_upper_bound)
        res = target_sks.scalar_right_shift_parallelized(
            mul, num_input_random_bits)
        blocks = res.blocks[:num_blocks_output]
        blocks += [target_sks.key.create_trivial(0)
                   for _ in range(num_blocks_output - len(blocks))]
        return RadixCiphertext(blocks)
