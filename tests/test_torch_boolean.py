"""The boolean gate API of the port against tfhe_tpu on the CPU, word for
word (tolerance 0): the parameter sets, key bytes from the same seeds,
every gate's truth table in packed calls, mux (whose OR gathers the AND
gates' device-resident outputs), not_, and the trivial short-circuits."""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from tfhe_tpu import boolean as ref
from tfhe_tpu_torch import boolean
from tfhe_tpu_torch.ops import torus
from tfhe_tpu_torch.shortint.ciphertext import DeviceLweBatch, LazyLweData

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

GATES = {
    "and": lambda x, y: x and y,
    "or": lambda x, y: x or y,
    "xor": lambda x, y: x != y,
    "nand": lambda x, y: not (x and y),
    "nor": lambda x, y: not (x or y),
    "xnor": lambda x, y: x == y,
}


@pytest.fixture(scope="module")
def keys():
    rck, rsk = ref.gen_keys(ref.TEST_PARAMETERS, seed=0xB001)
    pck, psk = boolean.gen_keys(boolean.TEST_PARAMETERS, seed=0xB001, device="cpu")
    return rck, rsk, pck, psk


def _words(cts) -> np.ndarray:
    return np.stack([np.asarray(c.data) for c in cts])


@pytest.mark.parametrize("name", ["DEFAULT_PARAMETERS", "TFHE_LIB_PARAMETERS",
                                  "PARAMETERS_ERROR_PROB_2_POW_MINUS_165",
                                  "TEST_PARAMETERS"])
def test_parameter_sets_match(name):
    r, p = getattr(ref.params, name), getattr(boolean.params, name)
    assert dataclasses.asdict(p).keys() == dataclasses.asdict(r).keys()
    for field in dataclasses.fields(p):
        a, b = getattr(p, field.name), getattr(r, field.name)
        assert (dataclasses.asdict(a) == dataclasses.asdict(b)
                if dataclasses.is_dataclass(a) else a == b), field.name
    assert p.core.pbs_decomp.base_log == r.core.pbs_decomp.base_log
    assert p.big_lwe_dimension == r.big_lwe_dimension


def test_keys_are_byte_identical(keys):
    rck, rsk, pck, psk = keys
    assert (pck.lwe_secret_key.data == rck.lwe_secret_key.data).all()
    assert (pck.glwe_secret_key.data == rck.glwe_secret_key.data).all()
    assert (torus.to_u64(psk.ksk) == np.asarray(rsk.ksk)).all()
    assert (psk.bsk_ntt.numpy().view(np.uint32) == np.asarray(rsk.bsk_mont)).all()
    assert psk.dp.num_primes == len(rsk.plan.primes) == 4


def test_encryptions_match(keys):
    rck, _, pck, _ = keys
    for v in (True, False):
        r, p = rck.encrypt(v), pck.encrypt(v)
        assert (p.data == r.data).all()
        assert pck.decrypt(p) is v


def test_truth_tables_packed_match(keys):
    """All six gates x four input pairs in one packed call (24 gates, padded
    to 32), then the same gates on those outputs in a second call."""
    rck, rsk, pck, psk = keys
    combos = list(itertools.product([False, True], repeat=2))
    kinds, want = [], []
    r_l, r_r, p_l, p_r = [], [], [], []
    for name, f in GATES.items():
        for a, b in combos:
            kinds.append(name)
            want.append(f(a, b))
            r_l.append(rck.encrypt(a))
            p_l.append(pck.encrypt(a))
            r_r.append(rck.encrypt(b))
            p_r.append(pck.encrypt(b))
    r_out = rsk.gates_packed(kinds, r_l, r_r)
    p_out = psk.gates_packed(kinds, p_l, p_r)
    assert all(isinstance(c.data, LazyLweData) for c in p_out)
    assert (_words(p_out) == _words(r_out)).all()
    assert [pck.decrypt(c) for c in p_out] == want
    # second layer on the device-resident outputs
    r2 = rsk.gates_packed(kinds, r_out, r_l)
    p2 = psk.gates_packed(kinds, p_out, p_l)
    assert (_words(p2) == _words(r2)).all()
    assert [pck.decrypt(c) for c in p2] == [GATES[k](w, a) for k, w, (a, _)
                                            in zip(kinds, want, combos * 6)]
    assert psk.pbs_count >= 48


@pytest.mark.parametrize("c,a,b", list(itertools.product([False, True], repeat=3)))
def test_mux_matches(keys, c, a, b):
    rck, rsk, pck, psk = keys
    r_in = [rck.encrypt(v) for v in (c, a, b)]
    p_in = [pck.encrypt(v) for v in (c, a, b)]
    before = DeviceLweBatch.downloads
    p = psk.mux(*p_in)
    assert DeviceLweBatch.downloads == before      # the OR gathered on the device
    r = rsk.mux(*r_in)
    assert (np.asarray(p.data) == np.asarray(r.data)).all()
    assert pck.decrypt(p) == (a if c else b)


def test_not_and_trivial_short_circuits(keys):
    rck, rsk, pck, psk = keys
    r, p = rck.encrypt(True), pck.encrypt(True)
    assert (psk.not_(p).data == rsk.not_(r).data).all()
    assert pck.decrypt(psk.not_(p)) is False
    # not_ of a gate's device-resident output stays lazy
    g = psk.and_(p, p)
    assert isinstance(psk.not_(g).data, LazyLweData)
    assert (np.asarray(psk.not_(g).data) == np.asarray(rsk.not_(rsk.and_(r, r)).data)).all()
    t, f = boolean.Ciphertext.new_trivial(True), boolean.Ciphertext.new_trivial(False)
    count = psk.pbs_count
    assert pck.decrypt(psk.and_(t, f)) is False and pck.decrypt(psk.xor_(t, f)) is True
    assert pck.decrypt(psk.not_(t)) is False
    assert psk.mux(t, p, f) is p and psk.mux(f, p, f) is f
    assert psk.pbs_count == count          # no PBS for trivial operands
    # one trivial operand: a real gate on its constant encoding, as tfhe_tpu
    mixed_p, mixed_r = psk.and_(p, t), rsk.and_(r, ref.Ciphertext.new_trivial(True))
    assert (np.asarray(mixed_p.data) == np.asarray(mixed_r.data)).all()
    assert pck.decrypt(mixed_p) is True


def test_server_key_default_device_raises(keys, monkeypatch):
    _, _, pck, _ = keys
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        boolean.ServerKey(pck, seed=1)
    with pytest.raises(RuntimeError, match="cuda"):
        boolean.gen_keys(boolean.TEST_PARAMETERS, seed=1)
