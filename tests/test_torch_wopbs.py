"""WoPBS of the port against tfhe_tpu on the CPU, word for word (tolerance 0;
all arithmetic is integer): the PFPKS key from the same seed (keygen at the
TEST set cut to N = 64, so tfhe_tpu's row-by-row keygen stays short) and
from_raw_keys of tfhe_tpu's 4-prime NTT-domain key; at the TEST set, on
one key's words in both packages, the PFPKS rows (K1's plain version at the
PFPKS shape), extract_bits, the circuit-bootstrapped GGSWs, vertical
packing (K2's CMux and step entries' plain versions) with and without the
CMux tree, and apply_wopbs with the identity and a non-monotone LUT.
tfhe_tpu's _pfpks and _cmux run compiled by jax.jit (the same functions;
eager dispatch compiles each of their operations on its own, about 30 s
more)."""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu.ops import server as ref_srv
from tfhe_tpu.shortint import wopbs as ref_wopbs
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops import kernels, ntt, server, torus
from tfhe_tpu_torch.shortint import wopbs

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0x30B
P = shortint.TEST_PARAM_MESSAGE_2_CARRY_2
REF_P = ref.TEST_PARAM_MESSAGE_2_CARRY_2


def _u(t) -> np.ndarray:
    return torus.to_u64(t) if isinstance(t, torch.Tensor) else np.asarray(t)


def _ref_rows(wk: wopbs.WopbsKey) -> list:
    """The port key's rows in tfhe_tpu's layout: k+1 arrays (n+1, l, k+1,
    4, N) uint32, 4-prime Montgomery NTT domain."""
    words = torus.to_u64(wk.pfpksk).copy()
    with np.errstate(over="ignore"):
        words[-1] = np.uint64(0) - words[-1]
    k1, n_poly = wk.k + 1, wk.n_poly
    rows = words.reshape(words.shape[:2] + (k1, k1, n_poly))
    plan = ntt.make_plan(n_poly, 4)
    with np.errstate(over="ignore"):
        return [ntt.to_mont_all(ntt.forward_all(rows[:, :, r], plan), plan).astype(np.uint32)
                for r in range(k1)]


@pytest.fixture(scope="module")
def cut_keys():
    cut = dataclasses.replace(P, polynomial_size=64)
    ref_cut = dataclasses.replace(REF_P, polynomial_size=64)
    ref_ck = ref.ClientKey(ref_cut, seed=SEED)
    ref_wk = ref_wopbs.WopbsKey(ref_ck, None, ref_wopbs.TEST_WOPBS_PARAM, seed=SEED + 2)
    ck = shortint.ClientKey(cut, seed=SEED)
    sk = shortint.ServerKey(ck, seed=SEED + 1, device="cpu")
    wk = wopbs.WopbsKey(ck, sk, wopbs.TEST_WOPBS_PARAM, seed=SEED + 2)
    return ref_wk, sk, wk


@pytest.fixture(scope="module")
def keys():
    """The TEST set: the port's keys and tfhe_tpu's on the same words, with
    tfhe_tpu's _pfpks and _cmux compiled."""
    ck = shortint.ClientKey(P, seed=SEED)
    sk = shortint.ServerKey(ck, seed=SEED + 1, device="cpu")
    wk = wopbs.WopbsKey(ck, sk, wopbs.TEST_WOPBS_PARAM, seed=SEED + 2)
    ref_ck = ref.ClientKey(REF_P, seed=SEED)
    ref_sk = ref.ServerKey(ref_ck, seed=SEED + 1)
    ref_wk = ref_wopbs.WopbsKey.__new__(ref_wopbs.WopbsKey)
    ref_wk.params = ref_wopbs.TEST_WOPBS_PARAM
    ref_wk.shortint_params = REF_P
    ref_wk.server_key = ref_sk
    ref_wk.k, ref_wk.n_poly = P.glwe_dimension, P.polynomial_size
    ref_wk.plan = ref_ntt.make_plan(P.polynomial_size, 4)
    ref_wk.pfpksk = [jnp.asarray(r) for r in _ref_rows(wk)]

    def pfpks(keys_, lwe, r):
        obj = copy.copy(ref_wk)
        obj.pfpksk = list(keys_)
        return ref_wopbs.WopbsKey._pfpks(obj, lwe, r)

    compiled_pfpks = jax.jit(pfpks, static_argnums=2)
    ref_wk._pfpks = lambda lwe, r: compiled_pfpks(tuple(ref_wk.pfpksk), lwe, r)
    ref_wk._cmux = jax.jit(functools.partial(ref_wopbs.WopbsKey._cmux, ref_wk))
    return ck, sk, wk, ref_ck, ref_wk


def test_pfpks_key_equals_tfhe_tpu(cut_keys):
    ref_wk, _, wk = cut_keys
    for got, want in zip(_ref_rows(wk), ref_wk.pfpksk):
        np.testing.assert_array_equal(got, np.asarray(want))
    assert wk.pfpksk.shape == (65, 2, 4 * 64)


def test_from_raw_keys_equals_the_port_keygen(cut_keys):
    ref_wk, sk, wk = cut_keys
    raw = wopbs.WopbsKey.from_raw_keys(sk, [np.asarray(k) for k in ref_wk.pfpksk])
    assert torch.equal(raw.pfpksk, wk.pfpksk)


def test_pfpks_rows_match(keys):
    ck, _, wk, ref_ck, ref_wk = keys
    lwe = np.asarray(ref_ck.encrypt_without_padding_value(11).data)
    for r in range(wk.k + 1):
        np.testing.assert_array_equal(_u(wk._pfpks(lwe, r)), np.asarray(ref_wk._pfpks(lwe, r)))


@pytest.fixture(scope="module")
def bits(keys):
    ck, _, wk, ref_ck, ref_wk = keys
    ct = ref_ck.encrypt_without_padding_value(0b1011)
    port_ct = shortint.Ciphertext(np.asarray(ct.data).copy(), ct.degree, ct.noise_level, 4, 4)
    return ref_wk.extract_bits(ct, 4), wk.extract_bits(port_ct, 4)


def test_extract_bits_match(keys, bits):
    ck = keys[0]
    ref_bits, port_bits = bits
    for a, b in zip(ref_bits, port_bits):
        np.testing.assert_array_equal(np.asarray(b.data), np.asarray(a.data))
    assert [ck.decrypt_raw(b) & 1 for b in port_bits] == [1, 0, 1, 1]


@pytest.fixture(scope="module")
def ggsws(keys, bits):
    _, _, wk, _, ref_wk = keys
    ref_bits, port_bits = bits
    return ([ref_wk.circuit_bootstrap_bit(b) for b in ref_bits],
            wk.circuit_bootstrap_bits(port_bits))


def test_circuit_bootstrap_ggsws_match(keys, bits, ggsws):
    ref_g, port_g = ggsws
    assert port_g[0].shape == (4, 2, 2, 4, 512) and port_g[0].dtype == torch.int32
    for a, b in zip(ref_g, port_g):
        np.testing.assert_array_equal(b.numpy().view(np.uint32), np.asarray(a))
    assert torch.equal(keys[2].circuit_bootstrap_bit(bits[1][2]), port_g[2])


def test_vertical_packing_matches(keys, ggsws):
    ck, _, wk, _, ref_wk = keys
    ref_g, port_g = ggsws
    f = lambda x: (x * x + 3) % 16  # noqa: E731
    vals = [f(x) for x in range(16)]
    want = ref_wk.vertical_packing(ref_g, vals, REF_P.delta)
    got = wk.vertical_packing(port_g, vals, P.delta)
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    assert (got.degree, got.noise_level) == (want.degree, want.noise_level)
    assert ck.decrypt_raw(got) == f(0b1011)


@pytest.mark.parametrize("lut,value", [("identity", 5), ("nonmonotone", 12)])
def test_apply_wopbs_matches(keys, lut, value):
    ck, _, wk, ref_ck, ref_wk = keys
    f = (lambda x: x) if lut == "identity" else (lambda x: (x * x + 3) % 16)
    ct = ref_ck.encrypt_without_padding_value(value)
    port_ct = shortint.Ciphertext(np.asarray(ct.data).copy(), ct.degree, ct.noise_level, 4, 4)
    want = ref_wk.apply_wopbs(ct, f, 4)
    got = wk.apply_wopbs(port_ct, f, 4)
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    assert ck.decrypt_raw(got) == f(value)


def test_large_lut_tree_matches(keys):
    """kappa = 10 > log2 N = 9: one level of the CMux tree (K2's CMux entry),
    then nine low-bit rotations (K2's step entry)."""
    ck, _, wk, ref_ck, ref_wk = keys
    f = lambda x: (x ^ (x >> 3)) % 16  # noqa: E731
    v = 0b1100101011
    ref_cts = [ref_ck.encrypt_without_padding_value((v >> j) & 1) for j in range(9, -1, -1)]
    cts = [shortint.Ciphertext(np.asarray(c.data).copy(), c.degree, c.noise_level, 4, 4)
           for c in ref_cts]
    vals = [f(x) for x in range(1 << 10)]
    want = ref_wk.vertical_packing([ref_wk.circuit_bootstrap_bit(c) for c in ref_cts], vals,
                                   REF_P.delta)
    cmux_calls = []
    real = kernels.cmux

    def counting(*args):
        cmux_calls.append(args[0].shape[0])
        return real(*args)

    kernels.cmux = counting
    try:
        got = wk.vertical_packing(wk.circuit_bootstrap_bits(cts), vals, P.delta)
    finally:
        kernels.cmux = real
    assert cmux_calls == [1]
    np.testing.assert_array_equal(np.asarray(got.data), np.asarray(want.data))
    assert ck.decrypt_raw(got) == f(v)


def test_ggsw_sets_view_the_circuit_bootstrap_tensor(ggsws):
    """circuit_bootstrap_bits returns views of one tensor, one after
    another: ggsw_sets stacks them again without a copy (the same storage),
    and a list out of order is stacked as a copy."""
    port_g = ggsws[1]
    sets = wopbs.ggsw_sets(port_g)
    assert sets.shape == (4, 4, 2, 2, 4, 512) and sets.is_contiguous()
    assert sets.data_ptr() == port_g[0].data_ptr()
    assert all(torch.equal(sets[i], g) for i, g in enumerate(port_g))
    swapped = wopbs.ggsw_sets(port_g[::-1])
    assert swapped.data_ptr() != port_g[0].data_ptr()
    assert torch.equal(swapped, sets.flip(0))


def test_cmux_chain_plain_matches_tfhe_tpu_cmux(keys, ggsws):
    """K2's CMux chain's plain version on 3 packings over 2 GGSW sets (the
    circuit-bootstrapped GGSWs of bits 0-1 and 2-3, key_index 1, 0, 1),
    two steps each at random rotations, equals a loop of tfhe_tpu's _cmux(
    ggsw, acc, X^a acc) on the same GGSWs, word for word."""
    _, sk, wk, _, ref_wk = keys
    ref_g, port_g = ggsws
    rng = np.random.default_rng(SEED + 7)
    acc = rng.integers(0, 1 << 64, (3, 2, 512), dtype=np.uint64)
    a = rng.integers(0, 1024, (3, 2))
    index = [1, 0, 1]
    sets = wopbs.ggsw_sets(port_g).view(2, 2, 4, 2, 2, 4, 512)
    got = kernels.cmux_chain(torus.from_u64(acc, "cpu"), torch.from_numpy(a), sets,
                             torch.tensor(index), sk.dp, 6, 4)
    for b, g in enumerate(index):
        want = jnp.asarray(acc[b:b + 1])
        for i in range(2):
            rotated = ref_srv.monomial_mul(want, jnp.full((1, 1, 1), int(a[b, i]), jnp.uint64))
            want = ref_wk._cmux(ref_g[2 * g + i], want, rotated)
        np.testing.assert_array_equal(_u(got[b:b + 1]), np.asarray(want))


def test_vertical_packing_many_equals_a_loop(keys, ggsws):
    """_vertical_packing_many on 3 packings over 2 GGSW sets (the four bits
    and their reverse), each with its own table, equals a loop of
    vertical_packing, word for word, degree and noise; each decrypts to its
    table's entry at its bits."""
    ck, _, wk, _, _ = keys
    port_g = ggsws[1]
    sets = torch.stack([wopbs.ggsw_sets(port_g), wopbs.ggsw_sets(port_g[::-1])])
    tables = [[(x * x + 3) % 16 for x in range(16)], [x ^ 5 for x in range(16)],
              [(7 * x) % 16 for x in range(16)]]
    set_of = [0, 1, 0]
    got = wk._vertical_packing_many(sets, set_of, tables, P.delta)
    for out, g, table in zip(got, set_of, tables):
        want = wk.vertical_packing(port_g if g == 0 else port_g[::-1], table, P.delta)
        np.testing.assert_array_equal(np.asarray(out.data), np.asarray(want.data))
        assert (out.degree, out.noise_level) == (want.degree, want.noise_level)
        assert ck.decrypt_raw(out) == table[0b1011 if g == 0 else 0b1101]


@pytest.mark.parametrize("shape, route", [
    ((2, 512, 4, 6), "chain"),      # the TEST sets' GGSWs
    ((2, 512, 1, 23), "chain"),
    ((5, 512, 4, 6), "step"),       # k+1 = 5 (1_1's width)
    ((5, 512, 1, 23), "step"),      # 1_1's rotation: the small-N kernel, but no chain
    ((2, 1024, 3, 7), "step"),      # N = 1024
    ((2, 256, 4, 6), "step"),       # the toy vectors' N
    ((2, 512, 5, 6), "step"),       # l > 4
    ((2, 512, 2, 31), "step"),      # base_log > 30
], ids=lambda v: "-".join(map(str, v)) if isinstance(v, tuple) else v)
def test_low_bits_route(shape, route):
    """Vertical packing's low bits run the CMux chain only at the shapes its
    kernel takes (kernels.chain_shape); every other shape keeps K2's step
    entry, one launch a bit, which the chain's kernel would refuse."""
    assert wopbs.low_bits_route(*shape) == route


def test_vertical_packing_step_route_equals_the_chain(keys, ggsws, monkeypatch):
    """At a shape the chain's kernel refuses (low_bits_route "step"),
    _vertical_packing_many runs the low bits through kernels.cmux_step, one
    call a bit and a GGSW set and no cmux_chain call, and gives the chain
    route's words on 3 packings over 2 GGSW sets."""
    ck, _, wk, _, _ = keys
    port_g = ggsws[1]
    sets = torch.stack([wopbs.ggsw_sets(port_g), wopbs.ggsw_sets(port_g[::-1])])
    tables = [[(x * x + 3) % 16 for x in range(16)], [x ^ 5 for x in range(16)],
              [(7 * x) % 16 for x in range(16)]]
    set_of = [0, 1, 0]
    calls = {"cmux_step": 0, "cmux_chain": 0}

    def counted(name):
        original = getattr(kernels, name)

        def call(*args, **kwargs):
            calls[name] += 1
            return original(*args, **kwargs)
        return call

    for name in calls:
        monkeypatch.setattr(kernels, name, counted(name))
    chain = wk._vertical_packing_many(sets, set_of, tables, P.delta)
    assert calls == {"cmux_step": 0, "cmux_chain": 1}
    monkeypatch.setattr(wopbs, "low_bits_route", lambda *shape: "step")
    step = wk._vertical_packing_many(sets, set_of, tables, P.delta)
    assert calls == {"cmux_step": 2 * 4, "cmux_chain": 1}
    for a, b in zip(step, chain):
        np.testing.assert_array_equal(np.asarray(a.data), np.asarray(b.data))
        assert (a.degree, a.noise_level) == (b.degree, b.noise_level)
    assert [ck.decrypt_raw(c) for c in step] == [tables[0][0b1011], tables[1][0b1101],
                                                 tables[2][0b1011]]


def test_cmux_plain_is_ct0_plus_the_external_product(keys):
    _, sk, _, _, _ = keys
    rng = np.random.default_rng(SEED)
    ct0, ct1 = (torus.from_u64(rng.integers(0, 1 << 64, (3, 2, 512), dtype=np.uint64), "cpu")
                for _ in range(2))
    ggsw = torch.from_numpy(rng.integers(0, 1 << 29, (4, 2, 2, 4, 512)).astype(np.int32))
    want = ct0 + server.external_product(ct1 - ct0, ggsw, sk.dp, 6, 4)
    assert torch.equal(kernels.cmux(ct0, ct1, ggsw, sk.dp, 6, 4), want)
