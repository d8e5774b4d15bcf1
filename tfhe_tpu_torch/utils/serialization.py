"""Versioned safe serialization: the wire format shared with tfhe_tpu (port
of tfhe_tpu/utils/serialization.py).

Design goals mirroring tfhe-versionable + tfhe-safe-serialize:
  - every payload carries a format magic, a type name, and a type VERSION;
    loading runs an explicit upgrade chain when the stored version is older
    (Versionize/Upgrade semantics, utils/tfhe-versionable/README.md);
  - safe_deserialize enforces a byte-size limit before parsing and a
    conformance predicate after (ParameterSetConformant,
    utils/tfhe-safe-serialize/src/lib.rs:1-15);
  - wire format is CBOR (RFC 8949) so payloads are readable by any CBOR
    library, like the reference's test vectors.

Arrays are encoded as {__nd__: {dtype, shape, data(bytes, little-endian)}}.
``MAGIC``, ``FORMAT_VERSION``, the type names, their versions and their
payload keys are tfhe_tpu's, so either package reads the other's payloads
and the port's bytes equal tfhe_tpu's for the same object.  The port holds
torus words as int64, often on a device (a round's outputs, squashed
ciphertexts): a payload holds them as numpy uint64, and serializing a
device-resident ciphertext downloads it (counted in
shortint/ciphertext.py DeviceLweBatch.downloads).  Deserialized
ciphertexts are host arrays (numpy, or CPU tensors for the squashed
words), as a client holds them; the server's next round uploads them.
"""

from __future__ import annotations

import struct
from typing import Callable

import numpy as np

MAGIC = "tfhe_tpu"
FORMAT_VERSION = 1

# type registry: name -> (current_version, to_dict, from_dict, upgrades)
_REGISTRY: dict = {}


def register_type(name: str, version: int, to_dict: Callable, from_dict: Callable):
    _REGISTRY.setdefault(name, {"version": version, "to": to_dict,
                                "from": from_dict, "upgrades": {}})


def register_upgrade(name: str, from_version: int, fn: Callable):
    """fn(old_payload_dict) -> new_payload_dict for from_version+1."""
    _REGISTRY[name]["upgrades"][from_version] = fn


# ---------------------------------------------------------------------------
# CBOR encoder (decoder lives in cbor.py)
# ---------------------------------------------------------------------------


def _enc_uint(major: int, n: int, out: bytearray):
    mj = major << 5
    if n < 24:
        out.append(mj | n)
    elif n < 256:
        out += bytes([mj | 24, n])
    elif n < 65536:
        out += bytes([mj | 25]) + struct.pack(">H", n)
    elif n < 2 ** 32:
        out += bytes([mj | 26]) + struct.pack(">I", n)
    else:
        out += bytes([mj | 27]) + struct.pack(">Q", n)


def _encode(obj, out: bytearray):
    if obj is None:
        out.append(0xF6)
    elif obj is True:
        out.append(0xF5)
    elif obj is False:
        out.append(0xF4)
    elif isinstance(obj, (int, np.integer)):
        obj = int(obj)
        n = obj if obj >= 0 else -1 - obj
        if n < (1 << 64):
            _enc_uint(0 if obj >= 0 else 1, n, out)
        else:  # RFC 8949 bignum: tag 2 (positive) / 3 (negative) + bytes
            _enc_uint(6, 2 if obj >= 0 else 3, out)
            b = n.to_bytes((n.bit_length() + 7) // 8, "big")
            _enc_uint(2, len(b), out)
            out += b
    elif isinstance(obj, float):
        out.append(0xFB)
        out += struct.pack(">d", obj)
    elif isinstance(obj, bytes):
        _enc_uint(2, len(obj), out)
        out += obj
    elif isinstance(obj, str):
        b = obj.encode("utf-8")
        _enc_uint(3, len(b), out)
        out += b
    elif isinstance(obj, (list, tuple)):
        _enc_uint(4, len(obj), out)
        for v in obj:
            _encode(v, out)
    elif isinstance(obj, dict):
        _enc_uint(5, len(obj), out)
        for k, v in obj.items():
            _encode(k, out)
            _encode(v, out)
    elif isinstance(obj, np.ndarray):
        arr = np.ascontiguousarray(obj)
        _encode({"__nd__": {"dtype": arr.dtype.str, "shape": list(arr.shape),
                            "data": arr.astype(arr.dtype.newbyteorder("<")).tobytes()}}, out)
    else:
        raise TypeError(f"cannot serialize {type(obj)}")


def cbor_dumps(obj) -> bytes:
    out = bytearray()
    _encode(obj, out)
    return bytes(out)


def _revive(obj):
    """Recursively convert {__nd__: ...} nodes back to ndarrays."""
    if isinstance(obj, dict):
        if "__nd__" in obj and len(obj) == 1:
            nd = obj["__nd__"]
            dt = np.dtype(nd["dtype"])
            arr = np.frombuffer(nd["data"], dtype=dt.newbyteorder("<")).astype(dt)
            return arr.reshape(nd["shape"])
        return {k: _revive(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_revive(v) for v in obj]
    return obj


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------


def serialize(obj) -> bytes:
    name = type(obj).__name__
    if name not in _REGISTRY:
        raise TypeError(f"type {name} is not registered for serialization")
    ent = _REGISTRY[name]
    return cbor_dumps({
        "magic": MAGIC,
        "format": FORMAT_VERSION,
        "type": name,
        "version": ent["version"],
        "payload": ent["to"](obj),
    })


def deserialize(data: bytes):
    from . import cbor

    doc = _revive(cbor.loads(data))
    if not isinstance(doc, dict) or doc.get("magic") != MAGIC:
        raise ValueError("not a tfhe_tpu payload")
    name = doc["type"]
    if name not in _REGISTRY:
        raise ValueError(f"unknown serialized type {name!r}")
    ent = _REGISTRY[name]
    payload, version = doc["payload"], doc["version"]
    while version < ent["version"]:
        if version not in ent["upgrades"]:
            raise ValueError(f"no upgrade path for {name} v{version}")
        payload = ent["upgrades"][version](payload)
        version += 1
    if version != ent["version"]:
        raise ValueError(f"{name}: stored v{version} newer than supported v{ent['version']}")
    return ent["from"](payload)


def safe_serialize(obj, size_limit: int = 1 << 30) -> bytes:
    data = serialize(obj)
    if len(data) > size_limit:
        raise ValueError(f"serialized size {len(data)} exceeds limit {size_limit}")
    return data


def safe_deserialize(data: bytes, size_limit: int = 1 << 30, conformance=None):
    if len(data) > size_limit:
        raise ValueError(f"payload size {len(data)} exceeds limit {size_limit}")
    obj = deserialize(data)
    if conformance is not None and not conformance(obj):
        raise ValueError("deserialized object failed conformance check")
    return obj


# ---------------------------------------------------------------------------
# Registrations for the user-facing types
# ---------------------------------------------------------------------------


def _u64(words) -> np.ndarray:
    """Torus words as a host uint64 array: numpy arrays and LazyLweData (a
    download) as they are, int64 tensors (on any device) reinterpreted."""
    if hasattr(words, "detach"):
        from ..ops.torus import to_u64

        return to_u64(words)
    return np.asarray(words, dtype=np.uint64)


def _seeded_bits(p) -> None:
    if p["bits"] != 64:
        raise ValueError(f"seeded {p['bits']}-bit keys are not ported (64-bit torus only)")


def _register_all():
    from ..integer.ciphertext import (BooleanBlock, CompressedModulusSwitchedRadixCiphertext,
                                      RadixCiphertext, SignedRadixCiphertext)
    from ..integer.crt import CrtCiphertext
    from ..shortint.ciphertext import Ciphertext as ShortintCt

    register_type(
        "Ciphertext", 0,
        lambda c: {"data": _u64(c.data), "degree": c.degree,
                   "noise_level": c.noise_level, "message_modulus": c.message_modulus,
                   "carry_modulus": c.carry_modulus},
        lambda p: ShortintCt(p["data"], p["degree"], p["noise_level"],
                             p["message_modulus"], p["carry_modulus"]),
    )
    register_type(
        "RadixCiphertext", 0,
        lambda c: {"blocks": [_REGISTRY["Ciphertext"]["to"](b) for b in c.blocks]},
        lambda p: RadixCiphertext([_REGISTRY["Ciphertext"]["from"](b) for b in p["blocks"]]),
    )
    register_type(
        "BooleanBlock", 0,
        lambda c: {"block": _REGISTRY["Ciphertext"]["to"](c.block)},
        lambda p: BooleanBlock(_REGISTRY["Ciphertext"]["from"](p["block"])),
    )
    register_type(
        "SignedRadixCiphertext", 0,
        lambda c: {"blocks": [_REGISTRY["Ciphertext"]["to"](b) for b in c.blocks]},
        lambda p: SignedRadixCiphertext(
            [_REGISTRY["Ciphertext"]["from"](b) for b in p["blocks"]]),
    )
    register_type(
        "CrtCiphertext", 0,
        lambda c: {"blocks": [_REGISTRY["Ciphertext"]["to"](b) for b in c.blocks],
                   "moduli": list(c.moduli)},
        lambda p: CrtCiphertext(
            [_REGISTRY["Ciphertext"]["from"](b) for b in p["blocks"]],
            list(p["moduli"])),
    )

    from ..ops.torus import from_u64
    from ..shortint.noise_squashing import SquashedNoiseCiphertext

    register_type(
        "SquashedNoiseCiphertext", 0,
        lambda c: {"lo": _u64(c.lo), "hi": _u64(c.hi),
                   "degree": c.degree, "message_modulus": c.message_modulus,
                   "carry_modulus": c.carry_modulus},
        lambda p: SquashedNoiseCiphertext(
            from_u64(p["lo"], "cpu"), from_u64(p["hi"], "cpu"), p["degree"],
            p["message_modulus"], p["carry_modulus"]),
    )

    from ..core.params import DecompParams
    from ..core.seeded import (SeededLweBootstrapKey, SeededLweCiphertextList,
                               SeededLweKeyswitchKey)

    # the seeded types carry tfhe_tpu's "bits" (64: the port's torus); a
    # seeded BSK's mask floor is not in the payload, as in tfhe_tpu, so a
    # floored key reads back unfloored (masks regenerated whole)
    def _ct_list_from(p):
        _seeded_bits(p)
        return SeededLweCiphertextList(p["seed"], p["bodies"], p["lwe_dimension"])

    def _ksk_from(p):
        _seeded_bits(p)
        return SeededLweKeyswitchKey(p["seed"], p["bodies"], p["input_dimension"],
                                     p["output_dimension"],
                                     DecompParams(p["base_log"], p["level"]))

    def _bsk_from(p):
        _seeded_bits(p)
        return SeededLweBootstrapKey(p["seed"], p["bodies"], p["glwe_dimension"],
                                     p["polynomial_size"],
                                     DecompParams(p["base_log"], p["level"]))

    register_type(
        "SeededLweCiphertextList", 0,
        lambda c: {"seed": c.seed, "bodies": _u64(c.bodies),
                   "lwe_dimension": c.lwe_dimension, "bits": 64},
        _ct_list_from,
    )
    register_type(
        "SeededLweKeyswitchKey", 0,
        lambda c: {"seed": c.seed, "bodies": _u64(c.bodies),
                   "input_dimension": c.input_dimension,
                   "output_dimension": c.output_dimension,
                   "base_log": c.decomp.base_log, "level": c.decomp.level_count,
                   "bits": 64},
        _ksk_from,
    )
    register_type(
        "SeededLweBootstrapKey", 0,
        lambda c: {"seed": c.seed, "bodies": _u64(c.bodies),
                   "glwe_dimension": c.glwe_dimension,
                   "polynomial_size": c.polynomial_size,
                   "base_log": c.decomp.base_log, "level": c.decomp.level_count,
                   "bits": 64},
        _bsk_from,
    )

    from ..shortint.server_key import CompressedModulusSwitchedCiphertext

    register_type(
        "CompressedModulusSwitchedCiphertext", 0,
        lambda c: {"packed": np.asarray(c.packed), "count": c.count,
                   "log_modulus": c.log_modulus, "degree": c.degree,
                   "message_modulus": c.message_modulus,
                   "carry_modulus": c.carry_modulus},
        lambda p: CompressedModulusSwitchedCiphertext(
            np.asarray(p["packed"], dtype=np.uint8), p["count"],
            p["log_modulus"], p["degree"], p["message_modulus"],
            p["carry_modulus"]),
    )

    _MSC = "CompressedModulusSwitchedCiphertext"
    register_type(
        "CompressedModulusSwitchedRadixCiphertext", 0,
        lambda c: {"blocks": [_REGISTRY[_MSC]["to"](b) for b in c.blocks],
                   "signed": c.signed},
        lambda p: CompressedModulusSwitchedRadixCiphertext(
            [_REGISTRY[_MSC]["from"](b) for b in p["blocks"]], p["signed"]),
    )

    # Curve points are 446-bit bigints: encode as fixed-width byte strings
    # (112 bytes G1 affine, 224 bytes G2 affine; all-zeros = infinity/absent).
    from ..zk.pke import Proof, _g1_bytes, _g1_from_bytes, _g2_bytes, _g2_from_bytes

    _V1_G1 = ("c_y", "pi", "c_h", "pi_kzg")
    _V1_G2 = ("c_hat", "c_hat_t")

    def _zk_to_dict(g1_fields, g2_fields):
        def conv(c):
            out = {f: _g1_bytes(getattr(c, f)) for f in g1_fields}
            out.update({f: _g2_bytes(getattr(c, f)) for f in g2_fields})
            return out
        return conv

    register_type(
        "Proof", 0,  # zk.pke.Proof (pke v1)
        _zk_to_dict(_V1_G1, _V1_G2),
        lambda p: Proof(_g2_from_bytes(p["c_hat"]), _g1_from_bytes(p["c_y"]),
                        _g1_from_bytes(p["pi"]), _g2_from_bytes(p["c_hat_t"]),
                        _g1_from_bytes(p["c_h"]), _g1_from_bytes(p["pi_kzg"])),
    )

    from ..zk.pke_v2 import ProofV2

    _V2_G1 = ("c_e", "c_r_tilde", "c_R", "c_y", "c_h1", "c_h2", "pi",
              "pi_kzg")
    _V2_G2 = ("c_hat_e", "c_hat_bin", "c_hat_t", "c_hat_h3", "c_hat_w")

    def _v2_from_dict(p):
        kw = {f: _g1_from_bytes(p[f]) for f in _V2_G1}
        kw.update({f: _g2_from_bytes(p[f]) for f in _V2_G2})
        return ProofV2(**kw)

    register_type("ProofV2", 0, _zk_to_dict(_V2_G1, _V2_G2), _v2_from_dict)

    # the type received from untrusted clients; the nested proof rides its
    # own envelope so it keeps its own version/upgrade chain
    def _proven_from_dict(p):
        from ..hlapi.proven_compact_list import ProvenCompactCiphertextList

        c1 = np.asarray(p["c1"], dtype=np.uint64)
        c2 = np.asarray(p["c2"], dtype=np.uint64)
        if c1.ndim != 1 or c2.ndim != 1:
            raise ValueError("malformed proven list arrays")
        return ProvenCompactCiphertextList(
            c1, c2, deserialize(p["proof"]),
            int(p["message_modulus"]), int(p["carry_modulus"]))

    register_type(
        "ProvenCompactCiphertextList", 0,
        lambda c: {"c1": np.asarray(c.c1, dtype=np.uint64),
                   "c2": np.asarray(c.c2, dtype=np.uint64),
                   "proof": serialize(c.proof),
                   "message_modulus": c.message_modulus,
                   "carry_modulus": c.carry_modulus},
        _proven_from_dict,
    )


_register_all()
