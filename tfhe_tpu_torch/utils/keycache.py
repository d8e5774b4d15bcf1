"""On-disk key cache, so that tests and runs do not pay keygen again (port
of tfhe_tpu/utils/keycache.py; analog of tfhe/src/keycache/mod.rs).

Keys per parameter set and seed are generated once and kept as npz files
of their standard-domain words, tagged as tfhe_tpu tags them
(keycache.py:19-28).  Loading rebuilds every kernel layout from those
words (the NTT-domain keys, the rounded key of v7/v9 mode, K1's byte
layout) on the requested device, where a ServerKey uploads them once.  The
port keeps its own directory, ``.keys_torch/`` at the checkout's root
(TFHE_TPU_TORCH_KEY_CACHE overrides it): tfhe_tpu's loader reads and
deletes files it does not know in its ``.keys/``.  A stale or corrupt file
is deleted and the key generated again.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np

CACHE_DIR = Path(os.environ.get("TFHE_TPU_TORCH_KEY_CACHE",
                                Path(__file__).resolve().parents[2] / ".keys_torch"))
# bumped when what a file holds changes: older files are then regenerated
FORMAT = 1


def _params_tag(params, seed) -> str:
    """tfhe_tpu's tag (keycache.py:19-28): the set, the seed, and the
    flooring rb of the v7 / v9 families, whose stored BSK is floored."""
    from ..ops.bsk_prep import mb_round_bits
    from ..shortint.server_key import ROUND_BITS, _v7_family, _v9_family

    raw = repr(params) + f"/seed={seed}/v3"
    if _v7_family(params):
        raw += f"/mfrb={ROUND_BITS}"
    if _v9_family(params):
        raw += f"/mbv2rb={mb_round_bits(params)}"
    return hashlib.sha256(raw.encode()).hexdigest()[:16]


def _tag(*parts) -> str:
    return hashlib.sha256("".join(parts).encode()).hexdigest()[:16]


def _load(path: Path, build):
    """build(data) from the file's arrays, or None where there is no file or
    it is stale or corrupt (then it is deleted)."""
    if not path.exists():
        return None
    try:
        with np.load(path) as data:
            if int(data["format"]) != FORMAT:
                raise ValueError("stale key cache file")
            return build(data)
    except Exception:
        path.unlink(missing_ok=True)
        return None


def _save(path: Path, **arrays) -> None:
    """Write atomically (a process that reads the file meanwhile sees the
    old one or none)."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.npz")
    np.savez(tmp, format=FORMAT, **arrays)
    os.replace(tmp, path)


def get_shortint_keys(params, seed: int = 0x7FEE, device="cuda"):
    """(ClientKey, ServerKey) for the parameter set, the server key's words
    cached on disk."""
    from ..ops import torus
    from ..shortint.client_key import ClientKey
    from ..shortint.server_key import ServerKey

    path = CACHE_DIR / f"shortint_{_params_tag(params, seed)}.npz"
    ck = ClientKey(params, seed)  # secret keygen is cheap and seed-deterministic

    def build(data):
        sk = ServerKey.from_raw_keys(params, data["ksk"], data["bsk"],
                                     int(data["bsk_floored"]), device)
        if "drift_zeros" in data:
            sk.drift_zeros = torus.from_u64(data["drift_zeros"], sk.device)
        return sk

    sk = _load(path, build)
    if sk is None:
        sk = ServerKey(ck, seed, device=device)
        extra = ({} if sk.drift_zeros is None
                 else {"drift_zeros": torus.to_u64(sk.drift_zeros)})
        _save(path, ksk=torus.to_u64(sk.ksk),
              bsk=np.asarray(getattr(sk._bsk_coeff, "data", sk._bsk_coeff)),
              bsk_floored=sk._bsk_floored, **extra)
    return ck, sk


def get_squashing_keys(params, sq_params, seed: int = 0x7FEE, device="cuda"):
    """(ck, sk, priv, nsk), the squashing BSK128's standard-domain words
    cached on disk (the 918-GGSW u128 keygen is minutes of host draws)."""
    from ..shortint.noise_squashing import NoiseSquashingKey, NoiseSquashingPrivateKey

    ck, sk = get_shortint_keys(params, seed, device)
    path = CACHE_DIR / f"squash_{_tag(repr(params), repr(sq_params), f'/s{seed}/v1')}.npz"
    priv = NoiseSquashingPrivateKey(sq_params, seed=seed ^ 0x5E1)
    nsk = _load(path, lambda d: NoiseSquashingKey.from_standard_keys(
        d["bsk_lo"], d["bsk_hi"], sq_params, device))
    if nsk is None:
        dp = NoiseSquashingKey.device_plan(sq_params, sk.device)
        lo, hi = NoiseSquashingKey.generate_standard_key(ck, priv, seed ^ 0x5E2, dp)
        _save(path, bsk_lo=lo, bsk_hi=hi)
        nsk = NoiseSquashingKey.from_standard_keys(lo, hi, sq_params, device)
    return ck, sk, priv, nsk


def get_squash_compression_keys(sq_params, comp_params, priv, seed: int = 0x7FEE,
                                device="cuda"):
    """(cpriv, ckey) for squashed-noise compression, the packing key's
    standard-domain words cached on disk."""
    from ..shortint.noise_squashing import (NoiseSquashingCompressionKey,
                                            NoiseSquashingCompressionPrivateKey)

    path = CACHE_DIR / f"squashcomp_{_tag(repr(sq_params), repr(comp_params), f'/s{seed}/v1')}.npz"
    cpriv = NoiseSquashingCompressionPrivateKey(comp_params, seed=seed ^ 0x5E3)
    ckey = _load(path, lambda d: NoiseSquashingCompressionKey.from_standard_keys(
        d["pksk_lo"], d["pksk_hi"], comp_params, device))
    if ckey is None:
        ckey = NoiseSquashingCompressionKey(priv, cpriv, seed=seed ^ 0x5E4, device=device)
        lo, hi = ckey.standard_key()
        _save(path, pksk_lo=lo, pksk_hi=hi)
    return cpriv, ckey
