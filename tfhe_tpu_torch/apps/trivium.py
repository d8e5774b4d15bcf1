"""Trivium / Kreyvium stream ciphers over clear bools and FheBool
(apps/trivium/src/{trivium,kreyvium}; transciphering support).

The state update needs 3 AND gates per step; over encrypted bools every
step's ANDs run as ONE packed gate call, and XORs are evaluated as gates
too (boolean layer).  `TriviumStream.next_bits(n)` drives n keystream bits.

Transciphering: a server holding `FheBool`-encrypted key/IV runs the same
generator homomorphically and XORs the keystream with a symmetric-ciphertext
stream to obtain FHE ciphertexts (transciphering/mod.rs:94 StreamCiphertext).

Port of tfhe_tpu/apps/trivium.py: the same gate calls in the same order
over the port's boolean ServerKey (boolean/server_key.py), so every bit is
tfhe_tpu's words; each gate call is one K1 launch and one K2 exact rotation
on the card.  A full warm-up is 4 x 288 steps of 10 gate calls.
"""

from __future__ import annotations


class _Backend:
    """Gate backend abstraction: clear bools or tfhe boolean server key."""

    def __init__(self, server_key=None):
        self.sk = server_key

    def and_(self, a, b):
        return (a and b) if self.sk is None else self.sk.and_(a, b)

    def xor(self, a, b):
        return (a != b) if self.sk is None else self.sk.xor_(a, b)

    def xor3(self, a, b, c):
        return self.xor(self.xor(a, b), c)

    def ands_packed(self, pairs):
        if self.sk is None:
            return [a and b for a, b in pairs]
        kinds = ["and"] * len(pairs)
        return self.sk.gates_packed(kinds, [p[0] for p in pairs], [p[1] for p in pairs])

    def const(self, v: bool):
        if self.sk is None:
            return v
        from ..boolean.client_key import Ciphertext

        return Ciphertext.new_trivial(v)


class TriviumStream:
    """80-bit key / 80-bit IV Trivium (de Canniere-Preneel)."""

    def __init__(self, key_bits, iv_bits, server_key=None):
        be = _Backend(server_key)
        self.be = be
        assert len(key_bits) == 80 and len(iv_bits) == 80
        f = be.const(False)
        t = be.const(True)
        # registers: s1[0..92], s2[0..83], s3[0..110]
        self.s1 = list(key_bits) + [f] * 13
        self.s2 = list(iv_bits) + [f] * 4
        self.s3 = [f] * 108 + [t, t, t]
        for _ in range(4 * 288):
            self._step(warmup=True)

    def _step(self, warmup: bool = False):
        be = self.be
        s1, s2, s3 = self.s1, self.s2, self.s3
        t1 = be.xor(s1[65], s1[92])
        t2 = be.xor(s2[68], s2[83])
        t3 = be.xor(s3[65], s3[110])
        z = None if warmup else be.xor3(t1, t2, t3)
        a1, a2, a3 = be.ands_packed([
            (s1[90], s1[91]), (s2[81], s2[82]), (s3[108], s3[109])
        ])
        n1 = be.xor(be.xor(t3, a3), s1[68])
        n2 = be.xor(be.xor(t1, a1), s2[77])
        n3 = be.xor(be.xor(t2, a2), s3[86])
        self.s1 = [n1] + s1[:-1]
        self.s2 = [n2] + s2[:-1]
        self.s3 = [n3] + s3[:-1]
        return z

    def next_bit(self):
        return self._step()

    def next_bits(self, n: int):
        return [self._step() for _ in range(n)]


class KreyviumStream:
    """128-bit key/IV Kreyvium (Trivium variant with key/IV feedback)."""

    def __init__(self, key_bits, iv_bits, server_key=None):
        be = _Backend(server_key)
        self.be = be
        assert len(key_bits) == 128 and len(iv_bits) == 128
        f = be.const(False)
        t = be.const(True)
        self.s1 = list(key_bits[:93])
        self.s2 = list(iv_bits[:84])
        self.s3 = [t] * 108 + [f, f, f]
        # K* and IV* shift registers (reversed order feed)
        self.kstar = list(key_bits)[::-1]
        self.ivstar = list(iv_bits)[::-1]
        for _ in range(4 * 288):
            self._step(warmup=True)

    def _step(self, warmup: bool = False):
        be = self.be
        s1, s2, s3 = self.s1, self.s2, self.s3
        t1 = be.xor(s1[65], s1[92])
        t2 = be.xor(s2[68], s2[83])
        t3 = be.xor(be.xor(s3[65], s3[107]), self.kstar[0])
        z = None if warmup else be.xor3(t1, t2, t3)
        a1, a2, a3 = be.ands_packed([
            (s1[90], s1[91]), (s2[81], s2[82]), (s3[105], s3[106])
        ])
        n1 = be.xor(be.xor(t3, a3), s1[68])
        n2 = be.xor(be.xor(t1, a1), s2[77])
        n3 = be.xor(be.xor(be.xor(t2, a2), s3[86]), self.ivstar[0])
        self.s1 = [n1] + s1[:-1]
        self.s2 = [n2] + s2[:-1]
        self.s3 = [n3] + s3[:-1]
        self.kstar = self.kstar[1:] + [self.kstar[0]]
        self.ivstar = self.ivstar[1:] + [self.ivstar[0]]
        return z

    def next_bit(self):
        return self._step()

    def next_bits(self, n: int):
        return [self._step() for _ in range(n)]


def transcipher_decrypt(stream: TriviumStream, cipher_bits, server_key):
    """XOR a clear symmetric ciphertext with the homomorphic keystream,
    yielding FHE ciphertexts of the plaintext (transciphering core)."""
    out = []
    for cb in cipher_bits:
        ks = stream.next_bit()
        out.append(server_key.not_(ks) if cb else ks)
    return out
