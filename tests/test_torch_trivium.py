"""The port's Trivium and Kreyvium (apps/trivium.py) against tfhe_tpu's on
the CPU: the clear keystreams, and encrypted keystream steps and
transciphering over the boolean gate API at TEST_PARAMETERS, word for word
(tolerance 0).  An encrypted warm-up is 1,152 steps of 10-12 gate calls, so
the encrypted streams start from a clear stream's post-warm-up state,
encrypted by tfhe_tpu and handed to the port (set through __new__)."""

import random

import numpy as np
import pytest
import torch

from tfhe_tpu import boolean as ref_boolean
from tfhe_tpu.apps import trivium as ref_trivium
from tfhe_tpu_torch import apps, boolean
from tfhe_tpu_torch.apps import trivium

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

SEED = 0x7819
STREAMS = {"trivium": ("TriviumStream", 80), "kreyvium": ("KreyviumStream", 128)}


def key_iv(bits: int, seed: int) -> tuple:
    rng = random.Random(seed)
    return ([bool(rng.getrandbits(1)) for _ in range(bits)],
            [bool(rng.getrandbits(1)) for _ in range(bits)])


@pytest.fixture(scope="module")
def keys():
    rck, rsk = ref_boolean.gen_keys(ref_boolean.TEST_PARAMETERS, seed=SEED)
    psk = boolean.ServerKey(boolean.ClientKey(boolean.TEST_PARAMETERS, seed=SEED),
                            seed=SEED, device="cpu")
    return rck, rsk, psk


@pytest.fixture(scope="module")
def clear_streams():
    """Each stream warmed up in the clear in both packages."""
    out = {}
    for name, (cls, bits) in STREAMS.items():
        k, iv = key_iv(bits, SEED + bits)
        out[name] = (getattr(ref_trivium, cls)(k, iv), getattr(trivium, cls)(k, iv))
    return out


def test_apps_exports_trivium():
    assert apps.trivium is trivium


@pytest.mark.parametrize("name", list(STREAMS))
def test_clear_keystream(clear_streams, name):
    """The warmed-up registers and 64 keystream bits are tfhe_tpu's."""
    ref_s, s = clear_streams[name]
    regs = ("s1", "s2", "s3") + (("kstar", "ivstar") if name == "kreyvium" else ())
    assert all(getattr(ref_s, r) == getattr(s, r) for r in regs)
    assert s.next_bits(64) == ref_s.next_bits(64)
    assert all(getattr(ref_s, r) == getattr(s, r) for r in regs)


def encrypted_from(mod, cls_name: str, clear, server_key, enc):
    """A stream of module ``mod`` over server_key holding clear's registers,
    each bit through enc."""
    cls = getattr(mod, cls_name)
    stream = cls.__new__(cls)
    stream.be = mod._Backend(server_key)
    for reg in ("s1", "s2", "s3", "kstar", "ivstar"):
        if hasattr(clear, reg):
            setattr(stream, reg, [enc(b) for b in getattr(clear, reg)])
    return stream


@pytest.mark.parametrize("name", list(STREAMS))
def test_encrypted_steps_and_transcipher(keys, clear_streams, name):
    """One encrypted keystream step and one transciphered bit (two steps in
    all, 24-28 gate calls) from the same encrypted state: tfhe_tpu's words,
    and the clear stream's bits."""
    rck, rsk, psk = keys
    cls_name = STREAMS[name][0]
    ref_s, _ = clear_streams[name]
    ref_e = encrypted_from(ref_trivium, cls_name, ref_s, rsk, rck.encrypt)
    # the same ciphertexts handed to the port, register by register
    port_e = encrypted_from(trivium, cls_name, ref_e, psk,
                            lambda c: boolean.Ciphertext(np.asarray(c.data).copy()))
    want_clear = [ref_s.next_bit(), ref_s.next_bit()]
    ref_out = ref_e.next_bits(1) + ref_trivium.transcipher_decrypt(ref_e, [True], rsk)
    out = port_e.next_bits(1) + trivium.transcipher_decrypt(port_e, [True], psk)
    assert (np.stack([np.asarray(c.data) for c in out])
            == np.stack([np.asarray(c.data) for c in ref_out])).all()
    assert [rck.decrypt(c) for c in out] == [want_clear[0], not want_clear[1]]
    for reg in ("s1", "s2", "s3"):
        assert (np.stack([np.asarray(c.data) for c in getattr(port_e, reg)[:3]])
                == np.stack([np.asarray(c.data) for c in getattr(ref_e, reg)[:3]])).all()
