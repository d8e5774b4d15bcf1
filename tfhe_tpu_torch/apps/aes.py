"""AES-128 and AES-256 transciphering: homomorphic AES-CTR keystream
evaluation (port of tfhe_tpu/apps/aes.py).

Analog of tfhe/src/transciphering/ciphers/aes/ -- but where the reference
evaluates the S-box as a hand-wired Boyar-Peralta boolean circuit over bit
ciphertexts, tfhe_tpu, and so the port, evaluates it through WoPBS vertical
packing (an 8-bit-input LUT via circuit bootstrap + CMux tree): the S-box
table is derived from first principles (x^254 in GF(2^8)/0x11B + the affine
map), and every per-byte LUT evaluation batches through the server key's
device pipeline: one batched PBS round (K1, K2) extracts every bit of every
byte, one circuit bootstrap (K1, K2, then K1 at the PFPKS shape) follows,
and the low-bit rotations of every byte's LUTs run in one launch of K2's
CMux chain (an 8-bit table needs no CMux tree at N = 512).

The cleartext AES is checked against the port's native AES-NI core
(csrc/aes_ctr.cpp, the CSPRNG's).
"""

from __future__ import annotations

from ..integer.ciphertext import RadixCiphertext
from ..shortint.wopbs import ggsw_sets

# ---------------------------------------------------------------------------
# Cleartext AES-128 (first-principles; checked against the AES-NI native core)
# ---------------------------------------------------------------------------


def _gf_mul(a: int, b: int) -> int:
    r = 0
    for _ in range(8):
        if b & 1:
            r ^= a
        hi = a & 0x80
        a = (a << 1) & 0xFF
        if hi:
            a ^= 0x1B
        b >>= 1
    return r


def _gf_inv(a: int) -> int:
    return 0 if a == 0 else pow_gf(a, 254)


def pow_gf(a: int, e: int) -> int:
    r = 1
    while e:
        if e & 1:
            r = _gf_mul(r, a)
        a = _gf_mul(a, a)
        e >>= 1
    return r


def _affine(x: int) -> int:
    out = 0
    for i in range(8):
        bit = ((x >> i) ^ (x >> ((i + 4) % 8)) ^ (x >> ((i + 5) % 8))
               ^ (x >> ((i + 6) % 8)) ^ (x >> ((i + 7) % 8)) ^ (0x63 >> i)) & 1
        out |= bit << i
    return out


SBOX = [_affine(_gf_inv(x)) for x in range(256)]
RCON = [0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36]


def key_expansion(key: bytes) -> list:
    """11 round keys of 16 bytes each (FIPS-197, AES-128)."""
    w = [list(key[4 * i : 4 * i + 4]) for i in range(4)]
    for i in range(4, 44):
        t = list(w[i - 1])
        if i % 4 == 0:
            t = t[1:] + t[:1]
            t = [SBOX[b] for b in t]
            t[0] ^= RCON[i // 4 - 1]
        w.append([a ^ b for a, b in zip(w[i - 4], t)])
    return [bytes(sum(w[4 * r : 4 * r + 4], [])) for r in range(11)]


def key_expansion_256(key: bytes) -> list:
    """15 round keys of 16 bytes each (FIPS-197, AES-256: Nk=8, Nr=14)."""
    w = [list(key[4 * i : 4 * i + 4]) for i in range(8)]
    for i in range(8, 60):
        t = list(w[i - 1])
        if i % 8 == 0:
            t = t[1:] + t[:1]
            t = [SBOX[b] for b in t]
            t[0] ^= RCON[i // 8 - 1]
        elif i % 8 == 4:
            t = [SBOX[b] for b in t]
        w.append([a ^ b for a, b in zip(w[i - 8], t)])
    return [bytes(sum(w[4 * r : 4 * r + 4], [])) for r in range(15)]


def _shift_rows_idx() -> list:
    """Output byte i (column-major state) comes from input index map[i]."""
    return [(i + 4 * (i % 4)) % 16 for i in range(16)]


def _mix_single_column(col: list) -> list:
    a = col
    return [
        _gf_mul(a[0], 2) ^ _gf_mul(a[1], 3) ^ a[2] ^ a[3],
        a[0] ^ _gf_mul(a[1], 2) ^ _gf_mul(a[2], 3) ^ a[3],
        a[0] ^ a[1] ^ _gf_mul(a[2], 2) ^ _gf_mul(a[3], 3),
        _gf_mul(a[0], 3) ^ a[1] ^ a[2] ^ _gf_mul(a[3], 2),
    ]


def _aes_encrypt_block(rks: list, block: bytes) -> bytes:
    nr = len(rks) - 1
    s = [b ^ k for b, k in zip(block, rks[0])]
    sr = _shift_rows_idx()
    for rnd in range(1, nr):
        s = [SBOX[b] for b in s]
        s = [s[sr[i]] for i in range(16)]
        cols = [s[4 * c : 4 * c + 4] for c in range(4)]
        s = sum((_mix_single_column(c) for c in cols), [])
        s = [b ^ k for b, k in zip(s, rks[rnd])]
    s = [SBOX[b] for b in s]
    s = [s[sr[i]] for i in range(16)]
    s = [b ^ k for b, k in zip(s, rks[nr])]
    return bytes(s)


def aes128_encrypt_block(key: bytes, block: bytes) -> bytes:
    return _aes_encrypt_block(key_expansion(key), block)


def aes256_encrypt_block(key: bytes, block: bytes) -> bytes:
    return _aes_encrypt_block(key_expansion_256(key), block)


# ---------------------------------------------------------------------------
# Homomorphic AES-128 over radix bytes (WoPBS S-box)
# ---------------------------------------------------------------------------


class FheAes128:
    """Server-side AES on an encrypted key: the client uploads Enc(key); the
    server derives Enc(round keys) and evaluates Enc(AES_k(counter)) for
    public counters — the keystream for CTR transciphering."""

    NR = 10  # rounds

    def __init__(self, server_key, wopbs_key, enc_key_bytes: list):
        """enc_key_bytes: 16 encrypted bytes (RadixCiphertexts)."""
        self.sk = server_key
        self.wk = wopbs_key
        self.round_keys = self._key_expansion_fhe(enc_key_bytes)

    # -- byte-level homomorphic helpers ---------------------------------

    def _bytes_ggsws(self, byte_cts: list) -> list:
        """Bit-decompose + circuit-bootstrap MANY bytes at once: one batched
        PBS round extracts every bit of every byte, one batched CBS follows
        (the batch-first shape of the reference's per-gate circuit)."""
        p = self.sk.params
        mb = (p.message_modulus - 1).bit_length()
        blocks, luts = [], []
        for byte_ct in byte_cts:
            nb = byte_ct.num_blocks
            for blk_i in range(nb - 1, -1, -1):  # MSB first
                for j in range(mb - 1, -1, -1):
                    blocks.append(byte_ct.blocks[blk_i])
                    luts.append(self.sk._lut(f"bit_{j}",
                                             lambda x, j=j: (x >> j) & 1))
        bits = self.sk.key.apply_lookup_table_batch(blocks, luts)
        ggsws = self.wk.circuit_bootstrap_bits(bits)
        per_byte = 8
        return [ggsws[i * per_byte : (i + 1) * per_byte]
                for i in range(len(byte_cts))]

    def _bytes_lut_from_ggsws(self, ggsws_list: list, table: list) -> list:
        p = self.sk.params
        mb = (p.message_modulus - 1).bit_length()
        nb = 8 // mb
        # one vertical packing a byte and output block, all in one call: one
        # CMux-chain launch for every low bit of every packing, on the
        # bytes' GGSW sets as the circuit bootstrap left them
        sets = ggsw_sets([g for ggsws in ggsws_list for g in ggsws]).view(
            (len(ggsws_list), len(ggsws_list[0])) + tuple(ggsws_list[0][0].shape))
        tables = [[(table[x] >> (mb * blk_i)) & (p.message_modulus - 1) for x in range(256)]
                  for blk_i in range(nb)]
        raw = self.wk._vertical_packing_many(
            sets, [i for i in range(len(ggsws_list)) for _ in range(nb)],
            [tables[blk_i] for _ in ggsws_list for blk_i in range(nb)], p.delta)
        # refresh: vertical-packing outputs carry CMux-chain noise (~2^55 at
        # test params) that the *4 bivariate XOR packing would amplify past
        # the decode threshold; one batched univariate PBS restores nominal
        # noise for all blocks at once
        msg = p.message_modulus
        refreshed = self.sk.key.apply_lookup_table_batch(
            raw, self.sk._lut("msg_extract", lambda x: x % msg))
        return [RadixCiphertext(refreshed[i * nb : (i + 1) * nb])
                for i in range(len(ggsws_list))]

    def _apply_byte_lut(self, byte_ct: RadixCiphertext, table: list) -> RadixCiphertext:
        ggsws = self._bytes_ggsws([byte_ct])
        return self._bytes_lut_from_ggsws(ggsws, table)[0]

    def _sbox(self, byte_ct: RadixCiphertext) -> RadixCiphertext:
        return self._apply_byte_lut(byte_ct, SBOX)

    def _sbox_bytes(self, byte_cts: list) -> list:
        ggsws = self._bytes_ggsws(byte_cts)
        return self._bytes_lut_from_ggsws(ggsws, SBOX)

    def _xtimes_tables(self):
        return ([_gf_mul(x, 2) for x in range(256)],
                [_gf_mul(x, 3) for x in range(256)])

    def _xor(self, a: RadixCiphertext, b: RadixCiphertext) -> RadixCiphertext:
        return self.sk.bitxor_parallelized(a, b)

    def _xor_scalar(self, a: RadixCiphertext, s: int) -> RadixCiphertext:
        return self.sk.scalar_bitxor_parallelized(a, s)

    # -- key schedule -----------------------------------------------------

    def _key_expansion_fhe(self, key_bytes: list) -> list:
        assert len(key_bytes) == 16, "AES-128 takes 16 encrypted key bytes"
        w = [key_bytes[4 * i : 4 * i + 4] for i in range(4)]
        for i in range(4, 44):
            t = list(w[i - 1])
            if i % 4 == 0:
                t = t[1:] + t[:1]
                t = [self._sbox(b) for b in t]
                t[0] = self._xor_scalar(t[0], RCON[i // 4 - 1])
            w.append([self._xor(a, b) for a, b in zip(w[i - 4], t)])
        return [sum(w[4 * r : 4 * r + 4], []) for r in range(11)]

    # -- block encryption --------------------------------------------------

    def encrypt_block(self, block_bytes: list, rounds: int | None = None) -> list:
        """block_bytes: 16 PUBLIC bytes (e.g. a CTR counter block); output:
        16 encrypted bytes of AES_k(block)."""
        nr = self.NR if rounds is None else rounds
        sk = self.sk
        mul2_t, mul3_t = self._xtimes_tables()
        nbl = self.round_keys[0][0].num_blocks
        s = [self._xor_scalar(self.round_keys[0][i], block_bytes[i])
             for i in range(16)]
        sr = _shift_rows_idx()
        for rnd in range(1, rounds + 1 if rounds is not None else nr + 1):
            s = self._sbox_bytes(s)
            s = [s[sr[i]] for i in range(16)]
            if rnd < self.NR:
                # one batched CBS for the whole state, three LUTs per byte
                ggsws16 = self._bytes_ggsws(s)
                mul2_all = self._bytes_lut_from_ggsws(ggsws16, mul2_t)
                mul3_all = self._bytes_lut_from_ggsws(ggsws16, mul3_t)
                out = []
                for c in range(4):
                    a = s[4 * c : 4 * c + 4]
                    a2 = mul2_all[4 * c : 4 * c + 4]
                    a3 = mul3_all[4 * c : 4 * c + 4]
                    out += [
                        self._xor(self._xor(a2[0], a3[1]), self._xor(a[2], a[3])),
                        self._xor(self._xor(a[0], a2[1]), self._xor(a3[2], a[3])),
                        self._xor(self._xor(a[0], a[1]), self._xor(a2[2], a3[3])),
                        self._xor(self._xor(a3[0], a[1]), self._xor(a[2], a2[3])),
                    ]
                s = out
            if rnd <= self.NR:
                s = [self._xor(s[i], self.round_keys[rnd][i]) for i in range(16)]
        return s

    def keystream_block(self, nonce_counter: bytes) -> list:
        return self.encrypt_block(list(nonce_counter))

    def transcipher_block(self, aes_ciphertext_block: bytes,
                          nonce_counter: bytes) -> list:
        """CTR transcipher: Enc(plain) = Enc(keystream) XOR public bytes."""
        ks = self.keystream_block(nonce_counter)
        return [self._xor_scalar(k, b) for k, b in
                zip(ks, aes_ciphertext_block)]


class FheAes256(FheAes128):
    """AES-256 variant (Nk=8, Nr=14): same WoPBS S-box machinery, the
    256-bit FIPS-197 key schedule (extra S-box word at i%8==4), 14 rounds.
    Analog of the reference's aes256 radix op family."""

    NR = 14

    def _key_expansion_fhe(self, key_bytes: list) -> list:
        assert len(key_bytes) == 32, "AES-256 takes 32 encrypted key bytes"
        w = [key_bytes[4 * i : 4 * i + 4] for i in range(8)]
        for i in range(8, 60):
            t = list(w[i - 1])
            if i % 8 == 0:
                t = t[1:] + t[:1]
                t = self._sbox_bytes(t)
                t[0] = self._xor_scalar(t[0], RCON[i // 8 - 1])
            elif i % 8 == 4:
                t = self._sbox_bytes(t)
            w.append([self._xor(a, b) for a, b in zip(w[i - 8], t)])
        return [sum(w[4 * r : 4 * r + 4], []) for r in range(15)]
