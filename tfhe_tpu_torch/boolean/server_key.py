"""Boolean server key: gates as linear combinations + one batched sign PBS
(port of tfhe_tpu/boolean/server_key.py).

Gate formulas (boolean/engine/mod.rs:558-593 AND et al.):
  AND:  a + b - q/8     OR:  a + b + q/8    XOR: 2(a+b) + q/4
  NAND/NOR/XNOR: negated linear forms; NOT: -a (no PBS);
  MUX(c,a,b) = OR(AND(c,a), AND(not c, b)) — 3 gates, first two batched.

Each gate ends with a sign-extracting PBS (constant q/8 accumulator — the
negacyclic rotation itself produces the +-q/8 output) through one batched
KS -> PBS call (ops/server.py ks_pbs_batch in exact mode on the four-prime
key, as tfhe_tpu runs it: K1, then K2's exact rotation on the card).
`*_packed` variants run many independent gates in a single device call.

The keys are tfhe_tpu's bytes from the same seeds and are uploaded once:
the KSK (with K1's byte layout of it on the card, ``ks_key``) and the exact
four-prime NTT key.  A gate batch is uploaded once; a gate's output stays on
the device (a shortint LazyLweData), so a gate that feeds the next (mux's
OR) is gathered there.
"""

from __future__ import annotations

import secrets

import numpy as np

from ..core import keygen as kg
from ..ops import kernels, ntt, torus
from ..ops import server as srv
from ..shortint.ciphertext import DeviceLweBatch, LazyLweData
from ..shortint.server_key import ServerKey as ShortintServerKey
from ..shortint.server_key import pad_pow2, upload_batch
from ..utils.csprng import DeterministicSeeder, EncryptionRandomGenerator
from ..utils.device import resolve_device
from .client_key import Ciphertext, ClientKey

Q8 = np.uint64(1 << 61)
Q4 = np.uint64(1 << 62)


class ServerKey:
    def __init__(self, client_key: ClientKey, seed: int | None = None, device="cuda"):
        device = resolve_device(device)
        p = client_key.params
        self.params = p
        self.device = device
        if seed is None:
            seed = secrets.randbits(128)
        gen = EncryptionRandomGenerator(seed ^ 0xA4093822299F31D0,
                                        DeterministicSeeder(seed ^ 0x082EFA98EC4E6C89))
        core = p.core
        ksk = kg.generate_lwe_keyswitch_key(
            client_key.big_lwe_secret_key, client_key.lwe_secret_key,
            core.ks_decomp, p.lwe_noise, gen,
        )
        bsk = kg.generate_lwe_bootstrap_key(
            client_key.lwe_secret_key, client_key.glwe_secret_key,
            core.pbs_decomp, p.glwe_noise, gen, device,
        )
        self.plan = ntt.make_plan(p.polynomial_size)
        self.dp = ntt.device_plan(self.plan, str(device))
        self.ksk = torus.from_u64(ksk.data, device)
        self.ks_key = kernels.keyswitch_key(self.ksk, p.ks_base_log, p.ks_level)
        self.bsk_ntt = ntt.key_ntt(bsk.data, self.dp)
        # constant sign accumulator: all coefficients q/8, zero mask
        acc = np.zeros((p.glwe_dimension + 1, p.polynomial_size), dtype=np.uint64)
        acc[-1, :] = Q8
        self._sign_lut = torus.from_u64(acc, device)
        self.pbs_count = 0

    # -- internals ---------------------------------------------------------

    def _gate_batch(self, lin_fns: list) -> list:
        """Evaluate a list of prepared linear forms through one KS -> PBS
        call: one upload (device rows gathered there), the batch padded to a
        power of two with copies of the first form (each row is rotated on
        its own, so padding never changes a real row's words)."""
        p = self.params
        b = len(lin_fns)
        n_pad = pad_pow2(b)
        batch = upload_batch(lin_fns + [lin_fns[0]] * (n_pad - b), self.device)
        lut_b = self._sign_lut.expand((n_pad,) + tuple(self._sign_lut.shape))
        out = srv.ks_pbs_batch(
            batch, lut_b, self.ks_key, self.bsk_ntt, self.dp,
            p.ks_base_log, p.ks_level, p.pbs_base_log, p.pbs_level, trunc_acc=False)
        self.pbs_count += b
        handle = DeviceLweBatch(out)
        w = int(out.shape[-1])
        return [Ciphertext(LazyLweData(((1, handle, i),), None, w)) for i in range(b)]

    def _materialize(self, ct: Ciphertext):
        """Trivial -> plaintext constant vector (mask 0, body +-q/8)."""
        if ct.trivial is None:
            return ct.data
        data = np.zeros(self.params.big_lwe_dimension + 1, dtype=np.uint64)
        with np.errstate(over="ignore"):
            data[-1] = Q8 if ct.trivial else np.uint64(0) - Q8
        return data

    # -- gates -------------------------------------------------------------

    def not_(self, a: Ciphertext) -> Ciphertext:
        if a.trivial is not None:
            return Ciphertext.new_trivial(not a.trivial)
        if isinstance(a.data, LazyLweData):
            return Ciphertext(-a.data)
        return Ciphertext(np.zeros_like(np.asarray(a.data)) - np.asarray(a.data))

    # data + offset on the body word; a device-resident form stays lazy
    _add_body = staticmethod(ShortintServerKey._add_to_body)

    def _binary_lin(self, kind: str, a, b):
        # wrapping mod 2^64 is the torus semantics; numpy's scalar-overflow
        # warnings on the negated constants are silenced deliberately
        with np.errstate(over="ignore"):
            neg = np.uint64(0) - np.uint64(1)  # -1 (wrapping)
            if kind == "and":
                return self._add_body(a + b, np.uint64(0) - Q8)
            if kind == "or":
                return self._add_body(a + b, Q8)
            if kind == "xor":
                return self._add_body((a + b) * np.uint64(2), Q4)
            if kind == "nand":
                return self._add_body((a + b) * neg, Q8)
            if kind == "nor":
                return self._add_body((a + b) * neg, np.uint64(0) - Q8)
            if kind == "xnor":
                return self._add_body((a + b) * (neg - np.uint64(1)),
                                      np.uint64(0) - Q4)
        raise ValueError(kind)

    _TRIVIAL = {
        "and": lambda x, y: x and y,
        "or": lambda x, y: x or y,
        "xor": lambda x, y: x != y,
        "nand": lambda x, y: not (x and y),
        "nor": lambda x, y: not (x or y),
        "xnor": lambda x, y: x == y,
    }

    def gates_packed(self, kinds: list, lhs: list, rhs: list) -> list:
        """Many independent binary gates in one batched KS -> PBS call."""
        outs: list = [None] * len(kinds)
        lin, idx = [], []
        for i, (k, a, b) in enumerate(zip(kinds, lhs, rhs)):
            if a.trivial is not None and b.trivial is not None:
                outs[i] = Ciphertext.new_trivial(self._TRIVIAL[k](a.trivial, b.trivial))
            else:
                lin.append(self._binary_lin(k, self._materialize(a), self._materialize(b)))
                idx.append(i)
        if lin:
            res = self._gate_batch(lin)
            for i, r in zip(idx, res):
                outs[i] = r
        return outs

    def _gate(self, kind: str, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        return self.gates_packed([kind], [a], [b])[0]

    def and_(self, a, b):
        return self._gate("and", a, b)

    def or_(self, a, b):
        return self._gate("or", a, b)

    def xor_(self, a, b):
        return self._gate("xor", a, b)

    def nand(self, a, b):
        return self._gate("nand", a, b)

    def nor(self, a, b):
        return self._gate("nor", a, b)

    def xnor(self, a, b):
        return self._gate("xnor", a, b)

    def mux(self, c: Ciphertext, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        if c.trivial is not None:
            return a if c.trivial else b
        t1, t2 = self.gates_packed(["and", "and"], [c, self.not_(c)], [a, b])
        return self.or_(t1, t2)
