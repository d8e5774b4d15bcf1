"""core/experimental.py and the GLWE keyswitch of the port against tfhe_tpu
on the CPU, word for word (tolerance 0: all of it is exact integer
arithmetic): partial and shared keys, the GLWE keyswitch key and
ops/server.py glwe_keyswitch (the key of tests/test_core_pbs.py:79: N =
256, k_in = 2, base 2^8, l = 4), the shrinking keyswitch (K1's plain
version), the pseudo-GGSW and the fast keyswitch (K7's plain version, both
signs also held against the schoolbook oracle ops/polymul_ref.py), partial
extraction and the extended PBS at E = 1 and 4 (K8's plain version, at E = 1
also against the port's classic rotation), at the toy set
(TEST_VECTOR_TOY_PARAMS: n = 10, N = 256, noiseless).  Keys come from
module-scoped fixtures built once in each package from the same seeds;
tfhe_tpu's results are computed once each."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu.core import encrypt as ref_enc
from tfhe_tpu.core import experimental as ref_exp
from tfhe_tpu.core import keygen as ref_kg
from tfhe_tpu.core.entities import LweCiphertext as RefLweCt
from tfhe_tpu.core.params import TEST_VECTOR_TOY_PARAMS as REF_TOY
from tfhe_tpu.core.params import DecompParams as RefDecomp
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.utils import csprng as ref_rng
from tfhe_tpu_torch.core import experimental as exp
from tfhe_tpu_torch.core import keygen as kg
from tfhe_tpu_torch.core.entities import LweBootstrapKey
from tfhe_tpu_torch.core.params import TEST_VECTOR_TOY_PARAMS as TOY
from tfhe_tpu_torch.core.params import DecompParams
from tfhe_tpu_torch.ops import kernels, ntt, polymul_ref, server, torus
from tfhe_tpu_torch.utils import csprng

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0xE4BE12
MSG_BITS = 4
DELTA = 1 << (64 - MSG_BITS - 1)
N = TOY.polynomial_size
NOISE = csprng.Gaussian(0.0)                  # TOY's noise, noiseless
# tfhe_tpu's fast keyswitch and extended PBS compiled whole (eager dispatch
# compiles each of their operations on its own, some 15 s a shape)
REF_FAST_KS = jax.jit(ref_exp.glwe_fast_keyswitch, static_argnums=(2, 3, 4))
REF_EXT_PBS = jax.jit(ref_exp.extended_pbs_batch, static_argnums=(3, 4, 5, 6))


def _t(a) -> torch.Tensor:
    return torus.from_u64(np.asarray(a, dtype=np.uint64), "cpu")


def _np(t) -> np.ndarray:
    return torus.to_u64(t)


def _gens(pkg, seed: int = SEED):
    """(secret, encryption) generators of tfhe_tpu's csprng (pkg=ref_rng) or
    the port's, from the same seeds: the same streams."""
    return (pkg.SecretRandomGenerator(seed),
            pkg.EncryptionRandomGenerator(seed, pkg.DeterministicSeeder(seed ^ 0x55)))


def _decode(plain: int) -> int:
    return ref_enc.decode(int(plain) % (1 << 64), MSG_BITS)


def _decrypt_glwe(sk_data, glwe) -> np.ndarray:
    """body - sum_i mask_i (*) s_i of one (k+1, N) GLWE, on the host."""
    plan = ntt.make_plan(glwe.shape[-1])
    acc = glwe[-1].copy()
    with np.errstate(over="ignore"):
        for i in range(sk_data.shape[0]):
            acc = acc - ntt.negacyclic_polymul_u64(glwe[i], sk_data[i].astype(np.uint64), plan)
    return acc


# ---------------------------------------------------------------------------
# Keys
# ---------------------------------------------------------------------------


def test_partial_and_shared_keys():
    ref_sec, _ = _gens(ref_rng)
    sec, _ = _gens(csprng)
    ref_sk = ref_exp.generate_partial_binary_glwe_secret_key(2, N, 100, ref_sec)
    sk = exp.generate_partial_binary_glwe_secret_key(2, N, 100, sec)
    assert (sk.data == ref_sk.data).all() and (sk.data.reshape(-1)[100:] == 0).all()
    ref_large = ref_kg.generate_binary_lwe_secret_key(64, ref_sec)
    large = kg.generate_binary_lwe_secret_key(64, sec)
    assert (exp.generate_fully_shared_binary_lwe_secret_key(large, 24).data
            == ref_exp.generate_fully_shared_binary_lwe_secret_key(ref_large, 24).data).all()
    ref_glwe = ref_kg.generate_binary_glwe_secret_key(2, 128, ref_sec)
    glwe = kg.generate_binary_glwe_secret_key(2, 128, sec)
    shared = exp.generate_shared_glwe_secret_key_from_glwe_secret_key(glwe, 1, 128)
    assert (shared.data == ref_exp.generate_shared_glwe_secret_key_from_glwe_secret_key(
        ref_glwe, 1, 128).data).all()


@pytest.fixture(scope="module")
def gksk():
    """The GLWE keyswitch key of tests/test_core_pbs.py:79 in both packages
    (N = 256, k_in = 2 -> k_out = 1, base 2^8, l = 4, TUniform(3)), a GLWE
    under the input key and tfhe_tpu's keyswitch of it."""
    out = {}
    for tag, pkg, keygen in (("ref", ref_rng, ref_kg), ("port", csprng, kg)):
        sec = pkg.SecretRandomGenerator(5)
        sk_in = keygen.generate_binary_glwe_secret_key(2, N, sec)
        sk_out = keygen.generate_binary_glwe_secret_key(1, N, sec)
        gen = pkg.EncryptionRandomGenerator(6, pkg.DeterministicSeeder(7))
        decomp = (RefDecomp if tag == "ref" else DecompParams)(8, 4)
        args = (sk_in, sk_out, decomp, pkg.TUniform(3), gen)
        key = keygen.generate_glwe_keyswitch_key(*args, **({} if tag == "ref" else
                                                          {"device": "cpu"}))
        out[tag] = (sk_in, sk_out, key, gen)
    sk_in, _, (ref_key, plan), gen = out["ref"]
    msg = np.arange(N, dtype=np.uint64) % 16
    with np.errstate(over="ignore"):
        ct = ref_enc.encrypt_glwe_assign(sk_in, msg * np.uint64(1 << 59), ref_rng.TUniform(3),
                                         gen).data
    want = np.asarray(ref_srv.glwe_keyswitch(jnp.asarray(ct)[None], jnp.asarray(ref_key), plan,
                                             8, 4))[0]
    return out, ct, msg, want


def test_glwe_keyswitch_key_words(gksk):
    """generate_glwe_keyswitch_key: tfhe_tpu's Montgomery NTT words from the
    same seeds, and from_raw_keys carries tfhe_tpu's key across."""
    out, _, _, _ = gksk
    ref_key, plan = out["ref"][2]
    key = out["port"][2]
    assert key.data.shape == (2, 4, 2, 4, N) and key.data.dtype == torch.int32
    assert (key.data.numpy().view(np.uint32) == np.asarray(ref_key)).all()
    assert key.dp.plan.primes == plan.primes
    raw = kg.NttKey.from_raw_keys(np.asarray(ref_key), device="cpu")
    assert torch.equal(raw.data, key.data) and raw.dp.plan.primes == plan.primes


def test_glwe_keyswitch_words(gksk):
    """ops/server.py glwe_keyswitch (K7's plain version on the CPU) gives
    tfhe_tpu's words, and the output decrypts under the output key."""
    out, ct, msg, want = gksk
    key = out["port"][2]
    got = _np(server.glwe_keyswitch(_t(ct)[None], key.data, key.dp, 8, 4))[0]
    assert (got == want).all()
    dec = _decrypt_glwe(out["port"][1].data, got)
    with np.errstate(over="ignore"):
        assert (((dec + np.uint64(1 << 58)) >> np.uint64(59)) % np.uint64(16) == msg).all()


@pytest.mark.parametrize("add_sum", [False, True])
def test_k7_plain_matches_schoolbook(add_sum):
    """K7's plain version, both signs, against the exact schoolbook product
    (ops/polymul_ref.py) on random words: (0, body) - sum or sum + (0,
    body), sum = sum_{i,lev} decomp_lev(mask_i) * key[i][lev] mod (X^N + 1,
    2^64) (|sum| < P/2 here, where the CRT result is the exact one)."""
    rng = np.random.default_rng(7 + add_sum)
    n_poly, k_in, kout1, base_log, levels = 64, 2, 2, 8, 4
    glwe = rng.integers(0, 1 << 64, (2, k_in + 1, n_poly), dtype=np.uint64)
    key_words = rng.integers(0, 1 << 64, (k_in, levels, kout1, n_poly), dtype=np.uint64)
    key = kg.words_to_ntt_key(key_words, device="cpu")
    got = _np(kernels.glwe_keyswitch(_t(glwe), key.data, key.dp, base_log, levels, add_sum))
    digits = _np(server.signed_decompose(_t(glwe[:, :-1]), base_log, levels)).view(np.int64)
    for b in range(glwe.shape[0]):
        for cc in range(kout1):
            total = np.zeros(n_poly, dtype=np.uint64)
            with np.errstate(over="ignore"):
                for i in range(k_in):
                    for lev in range(levels):
                        total += polymul_ref.negacyclic_polymul_signed_exact(
                            digits[lev, b, i], key_words[i, lev, cc])
                want = total if add_sum else np.uint64(0) - total
                if cc == kout1 - 1:
                    want = want + glwe[b, -1]
            assert (got[b, cc] == want).all()


# ---------------------------------------------------------------------------
# Shrinking keyswitch, pseudo-GGSW and fast keyswitch, partial extraction
# ---------------------------------------------------------------------------


def test_shrinking_keyswitch():
    """A 40-coefficient key shrunk to its 16-coefficient prefix: the key's
    words, from_raw_keys, and the keyswitch of five messages (K1's plain
    version on the tail) against tfhe_tpu, each decrypted."""
    ref_sec, ref_gen = _gens(ref_rng)
    sec, gen = _gens(csprng)
    ref_large = ref_kg.generate_binary_lwe_secret_key(40, ref_sec)
    large = kg.generate_binary_lwe_secret_key(40, sec)
    ref_sksk = ref_exp.generate_lwe_shrinking_keyswitch_key(ref_large, 16, RefDecomp(37, 1),
                                                            REF_TOY.lwe.noise, ref_gen)
    sksk = exp.generate_lwe_shrinking_keyswitch_key(large, 16, DecompParams(37, 1), NOISE, gen,
                                                    device="cpu")
    assert (sksk.ksk.data == ref_sksk.ksk.data).all()
    assert (sksk.input_lwe_dimension, sksk.output_lwe_dimension) == (40, 16)
    raw = exp.LweShrinkingKeyswitchKey.from_raw_keys(ref_sksk.ksk.data, DecompParams(37, 1), 16,
                                                     device="cpu")
    msgs = [0, 3, 7, 12, 15]
    cts = np.stack([ref_enc.encrypt_lwe(ref_large, ref_enc.encode(m, MSG_BITS), REF_TOY.lwe.noise,
                                        ref_gen).data for m in msgs])
    want = np.asarray(ref_exp.shrinking_keyswitch(jnp.asarray(cts), ref_sksk))
    for key in (sksk, raw):
        got = _np(exp.shrinking_keyswitch(_t(cts), key))
        assert (got == want).all()
    small = exp.generate_fully_shared_binary_lwe_secret_key(large, 16)
    assert [_decode(ref_enc.decrypt_lwe(small, RefLweCt(w))) for w in want] == msgs


@pytest.mark.parametrize("k_in,decomp", [(1, (24, 1)), (2, (8, 4))])
def test_pseudo_ggsw_and_fast_keyswitch(k_in, decomp):
    """The pseudo-GGSW's words and NTT form (from_raw_keys of tfhe_tpu's),
    and the fast keyswitch of a GLWE of 256 messages (K7's plain version,
    the sum added) against tfhe_tpu, decrypted under the output key."""
    ref_sec, ref_gen = _gens(ref_rng, SEED + k_in)
    sec, gen = _gens(csprng, SEED + k_in)
    ref_in = ref_kg.generate_binary_glwe_secret_key(k_in, N, ref_sec)
    ref_out = ref_kg.generate_binary_glwe_secret_key(1, N, ref_sec)
    sk_in = kg.generate_binary_glwe_secret_key(k_in, N, sec)
    sk_out = kg.generate_binary_glwe_secret_key(1, N, sec)
    ref_pg = ref_exp.encrypt_pseudo_ggsw(ref_out, ref_in, RefDecomp(*decomp), REF_TOY.glwe.noise,
                                         ref_gen)
    pg = exp.encrypt_pseudo_ggsw(sk_out, sk_in, DecompParams(*decomp), NOISE, gen, device="cpu")
    assert pg.data.shape == (k_in, decomp[1], 2, N) and (pg.data == ref_pg.data).all()
    ref_mont, plan = ref_exp.pseudo_ggsw_to_ntt(ref_pg)
    key = exp.pseudo_ggsw_to_ntt(exp.PseudoGgswCiphertext.from_raw_keys(
        ref_pg.data, DecompParams(*decomp)), device="cpu")
    assert (key.data.numpy().view(np.uint32) == ref_mont).all()
    assert (pg.input_glwe_dimension, pg.output_glwe_dimension, pg.polynomial_size) == (
        k_in, 1, N)
    msgs = np.arange(N) % 16
    with np.errstate(over="ignore"):
        ct = ref_enc.encrypt_glwe_assign(ref_in, msgs.astype(np.uint64) << np.uint64(59),
                                         REF_TOY.glwe.noise, ref_gen).data
    want = np.asarray(REF_FAST_KS(jnp.asarray(ct)[None], jnp.asarray(ref_mont), plan,
                                  *decomp))[0]
    got = _np(exp.glwe_fast_keyswitch(_t(ct)[None], key.data, key.dp, *decomp))[0]
    assert (got == want).all()
    assert [_decode(v) for v in _decrypt_glwe(sk_out.data, got)] == list(msgs)


def test_partial_extract_and_convert():
    """Partial extraction at phi = 300 of a k = 2 GLWE under a partial key
    and the embedding back into a constant GLWE: tfhe_tpu's words."""
    ref_sec, ref_gen = _gens(ref_rng)
    ref_sk = ref_exp.generate_partial_binary_glwe_secret_key(2, N, 300, ref_sec)
    msgs = np.arange(N) % 16
    with np.errstate(over="ignore"):
        ct = ref_enc.encrypt_glwe_assign(ref_sk, msgs.astype(np.uint64) << np.uint64(59),
                                         REF_TOY.glwe.noise, ref_gen).data
    rng = np.random.default_rng(3)
    batch = np.stack([ct, rng.integers(0, 1 << 64, ct.shape, dtype=np.uint64)])
    for nth in (0, 5):
        want = np.asarray(ref_exp.partial_extract_lwe_sample(jnp.asarray(batch), nth, 300))
        got = _np(exp.partial_extract_lwe_sample(_t(batch), nth, 300))
        assert (got == want).all()
    lwe = _np(exp.partial_extract_lwe_sample(_t(batch[:1]), 0, 300))
    want_glwe = np.asarray(ref_exp.partial_convert_lwe_to_constant_glwe(jnp.asarray(lwe), 2, N))
    got_glwe = _np(exp.partial_convert_lwe_to_constant_glwe(_t(lwe), 2, N))
    assert (got_glwe == want_glwe).all()
    assert _decode(_decrypt_glwe(ref_sk.data, got_glwe[0])[0]) == msgs[0]


# ---------------------------------------------------------------------------
# Extended PBS
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pbs_keys():
    """TOY's keys in both packages (the port's BSK words are tfhe_tpu's)
    and the NTT key, with the LWEs of six messages under the small key."""
    ref_sec, ref_gen = _gens(ref_rng)
    glwe_sk = ref_kg.generate_binary_glwe_secret_key(1, N, ref_sec)
    small_sk = ref_kg.generate_binary_lwe_secret_key(TOY.lwe_dimension, ref_sec)
    bsk = ref_kg.generate_lwe_bootstrap_key(small_sk, glwe_sk, REF_TOY.pbs_decomp,
                                            REF_TOY.glwe.noise,
                                            ref_gen)
    ref_mont, plan = ref_kg.bootstrap_key_to_ntt(bsk)
    mont, port_plan = kg.bootstrap_key_to_ntt(LweBootstrapKey(bsk.data, DecompParams(24, 1)))
    assert (mont == ref_mont).all()
    msgs = [0, 1, 5, 8, 11, 15]
    cts = np.stack([ref_enc.encrypt_lwe(small_sk, ref_enc.encode(m, MSG_BITS), REF_TOY.lwe.noise,
                                        ref_gen).data for m in msgs])
    return (glwe_sk.as_lwe_secret_key(), jnp.asarray(ref_mont), plan,
            torch.from_numpy(mont.view(np.int32)), ntt.device_plan(port_plan, "cpu"), msgs, cts)


@pytest.mark.parametrize("ext_factor", [1, 4])
def test_extended_pbs(pbs_keys, ext_factor):
    """extended_pbs_batch at E = 1 and 4 with f(x) = (x^2 + 3) % 16 on the
    extended LUT of size N E: tfhe_tpu's words, decrypted under the
    flattened GLWE key."""
    large_sk, ref_key, plan, key, dp, msgs, cts = pbs_keys
    f = lambda x: (x * x + 3) % 16  # noqa: E731
    lut = ref_srv.generate_lut(N * ext_factor, 2, 16, DELTA, f)
    lut_b = np.broadcast_to(lut[None], (len(msgs),) + lut.shape)
    want = np.asarray(REF_EXT_PBS(jnp.asarray(cts), jnp.asarray(lut_b), ref_key, plan, 24, 1,
                                  ext_factor))
    got = _np(exp.extended_pbs_batch(_t(cts), _t(lut_b), key, dp, 24, 1, ext_factor))
    assert got.shape == (len(msgs), N + 1) and (got == want).all()
    assert [_decode(ref_enc.decrypt_lwe(large_sk, RefLweCt(w))) for w in got] == [
        f(m) for m in msgs]


def test_k8_plain_e1_is_the_classic_rotation(pbs_keys):
    """At E = 1 K8's plain version is the exact classic rotation: the port's
    blind_rotate's words on the same switched inputs and LUT."""
    _, _, _, key, dp, msgs, cts = pbs_keys
    rng = np.random.default_rng(11)
    lut = _t(rng.integers(0, 1 << 64, (len(msgs), 2, N), dtype=np.uint64))
    msed = server.modulus_switch(_t(cts), (2 * N).bit_length() - 1)
    want = server.blind_rotate(msed[:, :-1], msed[:, -1], lut, key, dp, 24, 1)
    acc = exp.split_extended_lut(server.monomial_div(lut, msed[:, -1, None, None]), 1)
    got = kernels.blind_rotate_extended(msed[:, :-1], acc, key, dp, 24, 1)
    assert got.shape == (len(msgs), 1, 2, N) and torch.equal(got[:, 0], want)


@pytest.mark.parametrize("shape,route", [
    ((2, 2048, 1, 23), "lazy"),       # every 2_2 set
    ((2, 2048, 1, 30), "lazy"),
    ((2, 2048, 2, 15), "generic"),    # l = 2
    ((2, 2048, 1, 31), "generic"),    # a digit past the high word
    ((2, 512, 1, 23), "generic"),     # the TEST sets' N
    ((5, 512, 1, 23), "generic"),     # 1_1's k+1
    ((2, 1024, 3, 7), "generic"),     # TFHE_LIB
])
def test_k8_route(shape, route):
    """K8's pure-Python shape predicate (the lazy kernel exactly at
    K8_LAZY_SHAPE, which the C entry point mirrors; the generic kernel at
    the other shapes it takes)."""
    assert kernels.extended_route(*shape) == route
    k1, n_poly, levels, base_log = shape
    s = kernels.K8_LAZY_SHAPE
    assert (route == "lazy") == (k1 == s["k1"] and n_poly == s["n_poly"]
                                 and levels == s["levels"] and base_log <= s["max_base_log"])


@pytest.mark.parametrize("shape", [(6, 512, 1, 23), (5, 2048, 1, 23), (2, 2048, 8, 8)])
def test_k8_route_refuses_what_no_kernel_takes(shape):
    """Above the generic kernel's k+1 <= 5, its block's shared memory, or
    base_log l < 64: a ValueError naming both kernels' limits."""
    with pytest.raises(ValueError, match="its lazy kernel takes k\\+1 = 2, N = 2048, l = 1"):
        kernels.extended_route(*shape)


# cudaOccupancyMaxActiveClusters of K8's lazy kernel on an NVIDIA H100 80GB
# HBM3, by (log E, SB): 132 clusters of one block, 66 of 2, 30 of 4, 15 of 8
# (tools/rotation_probe.py)
_H100_K8_CLUSTERS = {(0, 1): 132, (1, 1): 66, (1, 2): 132, (2, 1): 30, (2, 2): 66,
                     (3, 1): 15, (3, 2): 30}


@pytest.mark.parametrize("e,batch,sb", [
    (1, 64, 1), (2, 64, 1), (4, 64, 2), (8, 64, 1),   # the probe's fastest at B = 64
    (4, 4, 1), (8, 4, 1),                             # one wave either way: one slot
    (4, 512, 2), (8, 512, 2),
])
def test_k8_slots_by_waves(monkeypatch, e, batch, sb):
    """extended_slots takes the fewest waves of clusters, a two-slot wave
    weighted by K8_TWO_SLOT_WAVE_COST, one slot a block on a tie."""
    monkeypatch.setattr(kernels, "_K8_CLUSTERS", dict(_H100_K8_CLUSTERS))
    assert kernels.extended_slots(e, batch) == sb


def test_split_extended_lut():
    rng = np.random.default_rng(2)
    lut = rng.integers(0, 1 << 64, (3, 2, 4 * 16), dtype=np.uint64)
    want = np.asarray(ref_exp.split_extended_lut(jnp.asarray(lut), 4))
    assert (_np(exp.split_extended_lut(_t(lut), 4).contiguous()) == want).all()
