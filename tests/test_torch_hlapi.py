"""The port's high-level API against tfhe_tpu's on the CPU, word for word
(tolerance 0; all arithmetic is integer): the same key sets from the same
master seed (XofKeySet: seeded server key, squashing key), the same
operator calls on both, and every output block must hold the same u64
words, degree and noise level and decrypt to the clear model.  Also the
keys of generate_keys, the public key, the entry points' default device
and the compact public key of a key set.

The keys are the TEST set's.  The operators are dispatch to the integer
layer (held block for block at the TEST set in test_torch_integer.py), so
they run on a key set at the TEST set cut to n = 2, N = 64 (the same
message and carry moduli, decomposition and noise), where a round costs a
few milliseconds on both packages."""

import dataclasses

import numpy as np
import pytest
import torch

import tfhe_tpu as ref_t
import tfhe_tpu_torch as t
from tfhe_tpu import shortint as ref_shortint
from tfhe_tpu.hlapi import compact_list as ref_cl
from tfhe_tpu.hlapi import kv_store as ref_kv
from tfhe_tpu.integer import noise_squashing as ref_ins
from tfhe_tpu.shortint import noise_squashing as ref_ns
from tfhe_tpu.shortint import params as ref_sp
from tfhe_tpu_torch import hlapi, shortint
from tfhe_tpu_torch.hlapi import compact_list as cl
from tfhe_tpu_torch.hlapi import kv_store
from tfhe_tpu_torch.ops import torus
from tfhe_tpu_torch.shortint import noise_squashing as ns
from tfhe_tpu_torch.shortint import params as sp_mod

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

MASTER = 0x4A1C0DE
SEED = 0x4A1


def _config(mod, shortint_mod, ns_mod, squash: bool = True, cut: bool = False):
    params = shortint_mod.TEST_PARAM_MESSAGE_2_CARRY_2
    if cut:
        params = dataclasses.replace(params, lwe_dimension=2, polynomial_size=64)
    b = mod.ConfigBuilder().use_custom_parameters(params)
    if squash:
        b = b.enable_noise_squashing(ns_mod.TEST_NOISE_SQUASHING_PARAM)
    return b.build()


def _blocks(x) -> list:
    x = getattr(x, "inner", x)
    if hasattr(x, "blocks"):
        return x.blocks
    return [x.block] if hasattr(x, "block") else [x]


def same(r, p) -> None:
    """tfhe_tpu's and the port's outputs hold the same blocks: type, u64
    words, degrees and noise levels (lo and hi words for squashed ones)."""
    if isinstance(r, (list, tuple)):
        assert len(r) == len(p)
        for x, y in zip(r, p):
            same(x, y)
        return
    assert type(r).__name__ == type(p).__name__
    br, bp = _blocks(r), _blocks(p)
    assert len(br) == len(bp)
    if hasattr(br[0], "lo"):
        for half in ("lo", "hi"):
            got = np.stack([torus.to_u64(getattr(b, half)) for b in bp])
            assert (got == np.stack([np.asarray(getattr(b, half)) for b in br])).all()
    else:
        got = np.stack([np.asarray(b.data) for b in bp])
        assert got.dtype == np.uint64
        assert (got == np.stack([np.asarray(b.data) for b in br])).all()
        assert [b.noise_level for b in bp] == [b.noise_level for b in br]
    assert [b.degree for b in bp] == [b.degree for b in br]


class KeySets:
    def __init__(self, r, p):
        self.r, self.p = r, p

    def run(self, fn):
        """fn(api, client_key) under tfhe_tpu's hlapi and server key, then
        under the port's; the outputs checked block for block."""
        with ref_t.with_server_key_as_context(self.r.server_key):
            r = fn(ref_t, self.r.client_key)
        with t.with_server_key_as_context(self.p.server_key):
            p = fn(t, self.p.client_key)
        same(r, p)
        return r, p

    def dec(self, r, p):
        """Both decryptions, which must agree."""
        got, want = p.decrypt(self.p.client_key), r.decrypt(self.r.client_key)
        assert got == want
        return got


def _key_sets(cut: bool) -> KeySets:
    r = ref_t.CompressedXofKeySet(_config(ref_t, ref_shortint, ref_ns, cut=cut),
                                  MASTER).expand()
    p = t.CompressedXofKeySet(_config(t, shortint, ns, cut=cut), MASTER).expand(device="cpu")
    return KeySets(r, p)


@pytest.fixture(scope="module")
def keys():
    return _key_sets(cut=False)


@pytest.fixture(scope="module")
def op_keys():
    return _key_sets(cut=True)


def test_xof_key_sets_match(keys):
    """Client keys, the decompressed server key and the squashing key from
    one master seed are tfhe_tpu's, word for word, on the asked device."""
    rk, pk = keys.r.client_key.integer_key.key, keys.p.client_key.integer_key.key
    assert (pk.lwe_secret_key.data == np.asarray(rk.lwe_secret_key.data)).all()
    assert (pk.glwe_secret_key.data == np.asarray(rk.glwe_secret_key.data)).all()
    rsk, psk = keys.r.server_key.integer_key.key, keys.p.server_key.integer_key.key
    assert psk.device.type == "cpu" and keys.p.server_key.device.type == "cpu"
    assert (torus.to_u64(psk.ksk) == np.asarray(rsk.ksk)).all()
    assert (psk._bsk_coeff.data == np.asarray(rsk._bsk_coeff.data)).all()
    assert psk._bsk_floored == rsk._bsk_floored == 0
    assert np.array_equal(keys.p.server_key.noise_squashing_key.key.bsk128_ntt.numpy().view(
        np.uint32), np.asarray(keys.r.server_key.noise_squashing_key.key.bsk128_mont))


def test_xof_expansion_is_deterministic():
    cfg = _config(t, shortint, ns, squash=False)
    a, b = (t.CompressedXofKeySet(cfg, MASTER + 1).expand(device="cpu") for _ in range(2))
    ka, kb = a.server_key.integer_key.key, b.server_key.integer_key.key
    assert torch.equal(ka.ksk, kb.ksk) and (ka._bsk_coeff.data == kb._bsk_coeff.data).all()
    assert a.server_key.noise_squashing_key is None
    ct = t.FheUint8.encrypt(77, a.client_key)
    assert ct.decrypt(b.client_key) == 77


def test_generate_keys_match():
    """generate_keys from one seed: tfhe_tpu's client key and, through the
    seed's XORs, its squashing private key and squashing key; the server key
    on the asked device."""
    rck = ref_t.ClientKey(_config(ref_t, ref_shortint, ref_ns), seed=SEED)
    pck, psk = t.generate_keys(_config(t, shortint, ns), seed=SEED, device="cpu")
    assert pck.seed == rck.seed == SEED
    assert (pck.integer_key.key.glwe_secret_key.data
            == np.asarray(rck.integer_key.key.glwe_secret_key.data)).all()
    assert np.array_equal(pck.noise_squashing_private_key.key._key_bits,
                          np.asarray(rck.noise_squashing_private_key.key._key_bits))
    rnsk = ref_ins.NoiseSquashingKey(rck.integer_key, rck.noise_squashing_private_key,
                                     rck.seed ^ 0x5C0A6)
    assert np.array_equal(psk.noise_squashing_key.key.bsk128_ntt.numpy().view(np.uint32),
                          np.asarray(rnsk.key.bsk128_mont))
    assert psk.device.type == "cpu"


A, B = 201, 183          # every block pair carries on add and borrows on sub

U8_OPS = {
    "add": (lambda a, b, c: a + b, (A + B) % 256),
    "sub": (lambda a, b, c: a - b, (A - B) % 256),
    "mul": (lambda a, b, c: a * b, (A * B) % 256),
    "bitand": (lambda a, b, c: a & b, A & B),
    "bitor": (lambda a, b, c: a | b, A | B),
    "bitxor": (lambda a, b, c: a ^ b, A ^ B),
    "lt": (lambda a, b, c: a < b, A < B),
    "eq": (lambda a, b, c: a == b, False),
    "ge_scalar": (lambda a, b, c: a >= 200, A >= 200),
    "shl": (lambda a, b, c: a << 3, (A << 3) % 256),
    "shr": (lambda a, b, c: a >> 2, A >> 2),
    "scalar_add": (lambda a, b, c: a + 77, (A + 77) % 256),
    "select": (lambda a, b, c: c.if_then_else(a, b), A),
}


@pytest.mark.parametrize("name", list(U8_OPS))
def test_fheuint8_operator_matches(op_keys, name):
    fn, want = U8_OPS[name]

    def run(api, ck):
        a, b = api.FheUint8.encrypt(A, ck), api.FheUint8.encrypt(B, ck)
        return fn(a, b, api.FheBool.encrypt(True, ck))

    r, p = op_keys.run(run)
    assert op_keys.dec(r, p) == want


def test_overflowing_add_matches(op_keys):
    r, p = op_keys.run(lambda api, ck: api.FheUint8.encrypt(A, ck).overflowing_add(
        api.FheUint8.encrypt(B, ck)))
    assert op_keys.dec(r[0], p[0]) == (A + B) % 256
    assert op_keys.dec(r[1], p[1]) is True


@pytest.mark.parametrize("name,fn,want", [
    ("add", lambda a, b: a + b, (51_234 + 40_000) % 65_536),
    ("gt", lambda a, b: a > b, True)])
def test_fheuint16_operator_matches(op_keys, name, fn, want):
    r, p = op_keys.run(lambda api, ck: fn(api.FheUint16.encrypt(51_234, ck),
                                          api.FheUint16.encrypt(40_000, ck)))
    assert op_keys.dec(r, p) == want


@pytest.mark.parametrize("name,fn,want", [
    ("add", lambda a, b: a + b, -100 + 37),
    ("lt", lambda a, b: a < b, True),
    ("neg", lambda a, b: -a, 100)])
def test_fheint8_operator_matches(op_keys, name, fn, want):
    r, p = op_keys.run(lambda api, ck: fn(api.FheInt8.encrypt(-100, ck),
                                          api.FheInt8.encrypt(37, ck)))
    assert op_keys.dec(r, p) == want


def test_fhebool_operators_match(op_keys):
    def run(api, ck):
        x, y = api.FheBool.encrypt(True, ck), api.FheBool.encrypt(False, ck)
        return [x & y, x | y, x ^ y, ~x]

    r, p = op_keys.run(run)
    assert [op_keys.dec(a, b) for a, b in zip(r, p)] == [False, True, True, False]


def test_tag_matches():
    for mod in (ref_t, t):
        tag = mod.Tag.from_u64(42)
        assert tag.as_u64() == 42 and tag == mod.Tag(tag.data)
        assert mod.Tag(b"x") != mod.Tag(b"y") and not mod.Tag()
    assert t.Tag.from_u64(2**40 + 3).data == ref_t.Tag.from_u64(2**40 + 3).data


def test_array_matches(op_keys):
    """Elementwise add through the scheduler (one call for all elements),
    the carry-save sum, indexing."""
    vals_a, vals_b = [[1], [250]], [[10], [40]]

    def run(api, ck):
        a = api.FheUintArray.encrypt(vals_a, api.FheUint8, ck)
        b = api.FheUintArray.encrypt(vals_b, api.FheUint8, ck)
        s = a + b
        return [s.elems, a.sum(), a[1, 0]]

    r, p = op_keys.run(run)
    got = [c.decrypt(op_keys.p.client_key) for c in [t.FheUint8(e) for e in p[0]] + p[1:]]
    assert got == [11, (250 + 40) % 256, 251, 250]


def test_kv_store_matches(op_keys):
    """get of a present and an absent encrypted key, update, map_values:
    every stored value's blocks."""
    table = {3: 12, 7: 5}

    def run(api, ck):
        mod = ref_kv if api is ref_t else kv_store
        ik = ck.integer_key
        sk = api.hlapi.global_state.internal_server_key().integer_key
        store = mod.KVStore(sk, 2)
        for k, v in table.items():
            store.insert_clear_key(k, ik.encrypt_radix(v, 2))
        hit = store.get(ik.encrypt_radix(7, 2))
        miss = store.get(ik.encrypt_radix(5, 2))
        store.update(ik.encrypt_radix(3, 2), ik.encrypt_radix(9, 2))
        store.map_values(lambda v: sk.scalar_add_parallelized(v, 1))
        return [hit, miss] + [store.get_with_clear_key(k) for k in table]

    r, p = op_keys.run(run)
    ik = op_keys.p.client_key.integer_key
    assert [ik.decrypt_radix(c) for c in p] == [5, 0, 10, 6]


def test_match_value_matches(op_keys):
    def run(api, ck):
        a = api.FheUint8.encrypt(4, ck)
        res, hit = api.match_value(a, [(4, 200), (9, 7)])
        return [res, hit, api.match_value_or(a, [(5, 1)], 123)]

    r, p = op_keys.run(run)
    assert [op_keys.dec(x, y) for x, y in zip(r, p)] == [200, True, 123]


def test_squash_noise_matches(op_keys):
    """A FheUint8 sum squashed onto the u128 torus (K5's function), lo and
    hi words and degrees, decrypted with decrypt_squashed."""
    r, p = op_keys.run(lambda api, ck: (api.FheUint8.encrypt(A, ck)
                                        + api.FheUint8.encrypt(B, ck)).squash_noise())
    assert (op_keys.p.client_key.decrypt_squashed(p)
            == op_keys.r.client_key.decrypt_squashed(r) == (A + B) % 256)


def test_public_key():
    """n bits + 128 encryptions of zero by default (tfhe_tpu's count), the
    same words as tfhe_tpu's from the same client key, and encrypt_block
    decrypts (its subset is drawn from ``secrets``)."""
    cfg_r, cfg_p = (_config(m, s, n, squash=False) for m, s, n in
                    ((ref_t, ref_shortint, ref_ns), (t, shortint, ns)))
    rck, pck = ref_t.ClientKey(cfg_r, seed=SEED + 1), t.ClientKey(cfg_p, seed=SEED + 1)
    rpk, ppk = ref_t.PublicKey(rck, zero_count=64), t.PublicKey(pck, zero_count=64)
    assert (ppk._zeros == np.asarray(rpk._zeros)).all()
    full = t.PublicKey(pck)
    p = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
    assert full.zero_count == p.glwe_dimension * p.polynomial_size * 64 + 128
    assert full._zeros.shape == (full.zero_count, p.glwe_dimension * p.polynomial_size + 1)
    for m in (0, 3):
        assert pck.integer_key.key.decrypt(full.encrypt_block(m)) == m


def test_full_width_surface():
    """All 82 widths at the package root, as tfhe_tpu exports them."""
    assert len(t.FHE_WIDTHS) == 41 and t.FHE_WIDTHS == ref_t.FHE_WIDTHS
    for w in t.FHE_WIDTHS:
        assert getattr(t, f"FheUint{w}").NUM_BITS == getattr(t, f"FheInt{w}").NUM_BITS == w
    assert sorted(hlapi.__all__) == sorted(ref_t.hlapi.__all__)


def test_compact_public_key_is_refused():
    """What stays refused of the compact public key at the hlapi surface, in
    both packages: expanding a list encrypted under a dedicated PKE set
    without its casting key (RequiresCasting)."""
    for mod, sp, kw in ((ref_cl, ref_sp, {}), (cl, sp_mod, {"device": "cpu"})):
        pke = sp.CompactPublicKeyEncryptionParameters(
            encryption_lwe_dimension=64, encryption_noise=sp.TUniform(3), message_modulus=4,
            carry_modulus=4)
        cpk = mod.CompactPublicKey(mod.CompactPrivateKey(pke, 3), 4)
        with pytest.raises(ValueError, match="RequiresCasting"):
            cpk.encrypt_list([1]).expand(**kw)


def test_compact_public_key_from_key_set_matches():
    """enable_compact_public_key sets the flag, and the key set's expansion
    derives tfhe_tpu's compact public key from the master seed (the cut
    TEST set)."""
    ref_cfg = _config(ref_t, ref_shortint, ref_ns, squash=False, cut=True)
    cfg = t.ConfigBuilder().use_custom_parameters(
        _config(t, shortint, ns, squash=False, cut=True).shortint_params)
    cfg = cfg.enable_compact_public_key().build()
    assert cfg.enable_compact_public_key
    ref_cfg.enable_compact_public_key = True
    want = ref_t.CompressedXofKeySet(ref_cfg, MASTER).expand().compact_public_key
    got = t.CompressedXofKeySet(cfg, MASTER).expand(device="cpu").compact_public_key
    assert (got.a == want.a).all() and (got.b == want.b).all()
    assert got.params == cfg.shortint_params and not got._requires_casting


@pytest.fixture
def no_gpu(monkeypatch):
    """Pretend the host has no CUDA device, whatever it has."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_default_to_cuda(no_gpu):
    """generate_keys, ServerKey, CompressedServerKey.decompress and the key
    set's expansion run on the card unless asked for the CPU, and raise
    without one."""
    cfg = _config(t, shortint, ns, squash=False)
    ck = t.ClientKey(cfg, seed=5)
    for call in (lambda: t.generate_keys(cfg, seed=5), lambda: t.ServerKey(ck),
                 lambda: t.CompressedServerKey(ck, seed=6).decompress(),
                 lambda: t.CompressedXofKeySet(cfg, 7).expand()):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
