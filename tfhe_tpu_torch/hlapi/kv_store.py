"""KVStore: encrypted-key lookup/update over a clear-keyed map
(high_level_api/kv_store.rs:67, integer kv_store primitives).

Port of tfhe_tpu/hlapi/kv_store.py.

get(enc_key):   sum_k [enc_key == k] * value_k — ONE coalesced eq + ONE
                coalesced masked-select round spanning every entry
                (integer/scheduler.py); zero if absent
update(enc_key, new_value): value_k' = select([enc_key == k], new_value,
                value_k) for every entry.
map_values(f):  apply a clear function to every stored value.
"""

from __future__ import annotations

from ..integer.ciphertext import RadixCiphertext
from ..integer.server_key import ServerKey


class KVStore:
    def __init__(self, server_key: ServerKey, num_blocks: int):
        self.sk = server_key
        self.num_blocks = num_blocks
        self._entries: dict[int, RadixCiphertext] = {}

    def insert_clear_key(self, key: int, value: RadixCiphertext) -> None:
        self._entries[int(key)] = value

    def __len__(self) -> int:
        return len(self._entries)

    def _hits(self, enc_key: RadixCiphertext, keys: list) -> list:
        """[enc_key == k] for every stored key, all rounds coalesced."""
        from ..integer import scheduler as sched

        sk = self.sk
        kn = enc_key.num_blocks
        pairs = [(enc_key, sk.create_trivial_radix(int(k), kn)) for k in keys]
        return sched.eq_many_parallelized(sk, pairs)

    def get(self, enc_key: RadixCiphertext) -> RadixCiphertext:
        """Encrypted lookup; encrypts 0 when the key is absent.  One
        coalesced eq round-set + one coalesced masked-select round over ALL
        entries (integer/scheduler.py), then a carry-save sum."""
        from ..integer import scheduler as sched

        sk = self.sk
        if not self._entries:
            return sk.create_trivial_radix(0, self.num_blocks)
        keys = list(self._entries)
        hits = self._hits(enc_key, keys)
        zero = sk.create_trivial_radix(0, self.num_blocks)
        masked = sched.if_then_else_many_parallelized(
            sk, [(h, self._entries[k], zero) for h, k in zip(hits, keys)])
        if len(masked) == 1:
            return masked[0]
        return sk.sum_ciphertexts(masked, self.num_blocks)

    def update(self, enc_key: RadixCiphertext, new_value: RadixCiphertext) -> None:
        from ..integer import scheduler as sched

        sk = self.sk
        if not self._entries:
            return
        keys = list(self._entries)
        hits = self._hits(enc_key, keys)
        outs = sched.if_then_else_many_parallelized(
            sk, [(h, new_value, self._entries[k])
                 for h, k in zip(hits, keys)])
        for k, o in zip(keys, outs):
            self._entries[k] = o

    def map_values(self, f) -> None:
        """Apply an encrypted-domain function v -> f(v) to every value."""
        for k, v in list(self._entries.items()):
            self._entries[k] = f(v)

    def decrypt_all(self, client_key) -> dict:
        return {k: client_key.decrypt_radix(v) for k, v in self._entries.items()}

    # -- reference-parity surface (kv_store.rs:242-826) -----------------

    def contains_clear_key(self, key: int) -> bool:
        return int(key) in self._entries

    def get_with_clear_key(self, key: int):
        return self._entries.get(int(key))

    def remove_with_clear_key(self, key: int):
        return self._entries.pop(int(key), None)

    def is_empty(self) -> bool:
        return not self._entries

    def get_with_flag(self, enc_key: RadixCiphertext):
        """(value, found): like get(), plus an encrypted found flag
        (kv_store.rs:371 get -> (T, FheBool))."""
        from ..integer import scheduler as sched
        from ..integer.ciphertext import BooleanBlock

        sk = self.sk
        if not self._entries:
            return (sk.create_trivial_radix(0, self.num_blocks),
                    BooleanBlock(sk.key.create_trivial(0)))
        keys = list(self._entries)
        hits = self._hits(enc_key, keys)
        zero = sk.create_trivial_radix(0, self.num_blocks)
        masked = sched.if_then_else_many_parallelized(
            sk, [(h, self._entries[k], zero) for h, k in zip(hits, keys)])
        value = masked[0] if len(masked) == 1 else \
            sk.sum_ciphertexts(masked, self.num_blocks)
        ind = sk.boolean_dot_prod_parallelized(hits, [1] * len(hits), 1)
        return value, sk.scalar_ne_parallelized(ind, 0)

    def contains_key(self, enc_key: RadixCiphertext):
        """Encrypted membership test for an encrypted key."""
        _, found = self.get_with_flag(enc_key)
        return found

    def contains_value(self, enc_value: RadixCiphertext):
        """Any stored value equal to enc_value (kv_store.rs:485)."""
        from ..integer import scheduler as sched
        from ..integer.ciphertext import BooleanBlock

        sk = self.sk
        if not self._entries:
            return BooleanBlock(sk.key.create_trivial(0))
        eqs = sched.eq_many_parallelized(
            sk, [(enc_value, v) for v in self._entries.values()])
        ind = sk.boolean_dot_prod_parallelized(eqs, [1] * len(eqs), 1)
        return sk.scalar_ne_parallelized(ind, 0)

    def compress(self, comp_key) -> "CompressedKVStore":
        """Pack every value's blocks into one GLWE compression list
        (kv_store.rs:720; comp_key: shortint CompressionKey)."""
        layout, blocks = [], []
        for k, v in self._entries.items():
            layout.append((k, len(v.blocks)))
            blocks.extend(v.blocks)
        return CompressedKVStore(comp_key.compress(blocks), layout,
                                 self.num_blocks)


class CompressedKVStore:
    """GLWE-packed KVStore storage (kv_store.rs:769)."""

    def __init__(self, packed, layout, num_blocks):
        self.packed = packed
        self.layout = layout
        self.num_blocks = num_blocks

    def decompress(self, comp_key, server_key: ServerKey) -> KVStore:
        blocks = comp_key.decompress(self.packed)
        store = KVStore(server_key, self.num_blocks)
        off = 0
        for k, nb in self.layout:
            store._entries[k] = RadixCiphertext(blocks[off:off + nb])
            off += nb
        return store
