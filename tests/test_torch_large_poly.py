"""V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128 (N = 8192, l = 2) on
the CPU: the port's ServerKey against tfhe_tpu's, word for word (tolerance
0), with n cut to 4 so that the rotation's plain version stays short; and
the choice of K2's exact kernels by shape: the cluster kernel at N = 8192,
and no 4-prime NTT plan in either package above it (why 4_4, N = 65536, is
out of both)."""

import dataclasses

import numpy as np
import pytest
import torch

from tfhe_tpu import shortint as ref
from tfhe_tpu.ops import ntt as ref_ntt
from tfhe_tpu_torch import shortint
from tfhe_tpu_torch.ops import kernels, ntt

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

CUT_N = 4


def _words(cts) -> np.ndarray:
    return np.stack([np.asarray(c.data) for c in cts])


@pytest.fixture(scope="module")
def keys_3_3():
    """(reference client, server; port client, server) from the same seeds
    at 3_3 with n cut to CUT_N."""
    rp = dataclasses.replace(ref.params.V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128,
                             lwe_dimension=CUT_N)
    pp = dataclasses.replace(shortint.V1_4_PARAM_MESSAGE_3_CARRY_3_KS_PBS_TUNIFORM_2M128,
                             lwe_dimension=CUT_N)
    rck = ref.ClientKey(rp, seed=81)
    pck = shortint.ClientKey(pp, seed=81)
    return rck, ref.ServerKey(rck, seed=82), pck, shortint.ServerKey(pck, seed=82, device="cpu")


def test_3_3_lut_batch_matches_tfhe_tpu(keys_3_3):
    """B = 2 through apply_lookup_table_batch at N = 8192, l = 2 (the exact
    rotation: 3_3 is outside the v7 family), the same words and degrees;
    the outputs decrypt to f at message and carry 8 x 8."""
    rck, rsk, pck, psk = keys_3_3
    assert not psk.trunc_acc and psk.bsk_ntt.shape == (CUT_N, 2, 2, 2, 4, 8192)
    vals = [5, 62]
    rc = [rck.encrypt(v) for v in vals]
    pc = [pck.encrypt(v) for v in vals]
    assert (_words(rc) == _words(pc)).all()
    f = lambda x: (7 * x + 3) % 64       # noqa: E731
    ro = rsk.apply_lookup_table_batch(rc, rsk.generate_lookup_table(f))
    po = psk.apply_lookup_table_batch(pc, psk.generate_lookup_table(f))
    assert (_words(ro) == _words(po)).all()
    assert [c.degree for c in po] == [c.degree for c in ro] == [63, 63]
    assert [pck.decrypt_raw(c) for c in po] == [f(v) for v in vals]


@pytest.mark.parametrize("shape,route", [
    ((2, 8192, 2, 15, False), "cluster"),   # 3_3
    ((2, 8192, 1, 23, False), "cluster"),
    ((2, 2048, 1, 23, True), "lazy"),       # 2_2
    ((2, 2048, 1, 23, False), "generic"),
    ((5, 512, 1, 23, False), "cluster"),    # 1_1: the small-N kernel
    ((2, 4096, 1, 22, False), "generic"),
    ((2, 1024, 3, 7, False), "generic"),    # TFHE_LIB
])
def test_exact_rotation_route(shape, route):
    """The wrapper's choice of K2's exact kernel: the cluster kernel
    exactly where the generic kernel's block does not fit shared memory
    and the cluster kernel takes the shape, and at N = 512 where its
    small-N kernel takes it (1_1)."""
    k1, n_poly, levels, base_log, lazy = shape
    assert kernels.exact_rotation_route(k1, n_poly, levels, base_log, lazy) == route
    fits = kernels.exact_smem_bytes(k1, n_poly, levels) <= kernels.SMEM_LIMIT
    small = kernels.small_shape(k1, n_poly, levels, base_log)
    assert (route == "cluster") == (not lazy and (not fits or small))


@pytest.mark.parametrize("shape", [(2, 4096, 3, 10), (3, 8192, 1, 15), (2, 8192, 2, 31), (2, 8192, 3, 10)])
def test_exact_rotation_refuses_what_no_kernel_takes(shape):
    """Shapes above a block's shared memory that the cluster kernel does
    not take raise a ValueError (none is a set of shortint/params.py)."""
    with pytest.raises(ValueError, match="cluster kernel takes"):
        kernels.exact_rotation_route(*shape, False)


def test_3_3_smem_split_over_a_cluster():
    """At 3_3 one block would need 671,744 B; a cluster's block needs
    167,936 B (a quarter of the accumulator and one prime's residues)."""
    assert kernels.exact_smem_bytes(2, 8192, 2) == 671_744
    assert kernels.exact_smem_bytes(2, 8192, 2, cluster=True) == 167_936


@pytest.mark.parametrize("n_poly,levels", [(16384, 2), (65536, 3)])
def test_no_plan_above_8192_in_either_package(n_poly, levels):
    """Above N = 8192 neither package builds a 4-prime NTT plan (the
    primes' 2-adic orders are 14, 15, 18 and 14), so neither makes a 4_4
    server key; the wrapper refuses the shape with that reason."""
    with pytest.raises(AssertionError) as port_err:
        ntt.make_plan(n_poly, 4)
    with pytest.raises(AssertionError) as ref_err:
        ref_ntt.make_plan(n_poly, 4)
    assert str(port_err.value) == str(ref_err.value) == (
        f"prime 1073692673 does not support size {n_poly}")
    orders = [((p - 1) & -(p - 1)).bit_length() - 1 for p in ntt.PRIMES[:4]]
    assert orders == [14, 15, 18, 14]
    with pytest.raises(ValueError, match="no 4-prime NTT plan exists above N = 8192"):
        kernels.exact_rotation_route(2, n_poly, levels, 11, False)
