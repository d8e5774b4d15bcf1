"""Encrypted arrays (high_level_api/array/): n-dimensional containers of
FheUint elements with elementwise ops.

Port of tfhe_tpu/hlapi/array.py.

Elementwise add/sub/mul and the bitwise ops coalesce EVERY internal PBS
round across all array elements through the round scheduler
(integer/scheduler.py)."""

from __future__ import annotations

import math

from .global_state import internal_server_key


class FheUintArray:
    def __init__(self, elems: list, shape: tuple, element_type):
        assert len(elems) == math.prod(shape)
        self.elems = elems          # flat list[RadixCiphertext]
        self.shape = tuple(shape)
        self.element_type = element_type

    @classmethod
    def encrypt(cls, values, element_type, client_key) -> "FheUintArray":
        import numpy as np

        arr = np.asarray(values, dtype=object)
        ik = client_key.integer_key
        n = element_type.num_blocks(ik.params)
        elems = [ik.encrypt_radix(int(v), n) for v in arr.reshape(-1)]
        return cls(elems, arr.shape, element_type)

    def decrypt(self, client_key):
        import numpy as np

        ik = client_key.integer_key
        flat = [ik.decrypt_radix(e) for e in self.elems]
        return np.asarray(flat, dtype=object).reshape(self.shape)

    _MANY = {"add_parallelized": "add_many_parallelized",
             "sub_parallelized": "sub_many_parallelized",
             "mul_parallelized": "mul_many_parallelized",
             "bitand_parallelized": "bitand_many_parallelized",
             "bitor_parallelized": "bitor_many_parallelized",
             "bitxor_parallelized": "bitxor_many_parallelized"}

    def _zip_op(self, other: "FheUintArray", opname: str) -> "FheUintArray":
        assert self.shape == other.shape, (self.shape, other.shape)
        sk = internal_server_key().integer_key
        many = self._MANY.get(opname)
        if many is not None:
            from ..integer import scheduler as sched

            outs = getattr(sched, many)(sk, list(zip(self.elems, other.elems)))
            return FheUintArray(outs, self.shape, self.element_type)
        op = getattr(sk, opname)
        return FheUintArray([op(a, b) for a, b in zip(self.elems, other.elems)],
                            self.shape, self.element_type)

    def __add__(self, other):
        return self._zip_op(other, "add_parallelized")

    def __sub__(self, other):
        return self._zip_op(other, "sub_parallelized")

    def __mul__(self, other):
        return self._zip_op(other, "mul_parallelized")

    def __and__(self, other):
        return self._zip_op(other, "bitand_parallelized")

    def __or__(self, other):
        return self._zip_op(other, "bitor_parallelized")

    def __xor__(self, other):
        return self._zip_op(other, "bitxor_parallelized")

    def sum(self):
        """Tree sum of all elements (one carry-save circuit)."""
        sk = internal_server_key().integer_key
        out = sk.sum_ciphertexts([e for e in self.elems])
        return self.element_type(out)

    def __getitem__(self, idx):
        import numpy as np

        flat_idx = np.ravel_multi_index(idx if isinstance(idx, tuple) else (idx,),
                                        self.shape)
        return self.element_type(self.elems[int(flat_idx)])

    def reshape(self, *shape) -> "FheUintArray":
        assert math.prod(shape) == len(self.elems)
        return FheUintArray(self.elems, shape, self.element_type)
