"""ops/torus.py: u64 torus words held in torch.int64 behave as numpy uint64
(wrapping add/sub/mul/neg, logical shift, unsigned compare, bit-exact
views in both directions)."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from tfhe_tpu_torch.ops import torus

torch.set_num_threads(1)  # the suite runs in parallel processes: one thread each

U64 = st.integers(min_value=0, max_value=(1 << 64) - 1)
WORDS = st.lists(U64, min_size=1, max_size=16)
FAST = settings(max_examples=60, deadline=None)

EDGES = [0, 1, (1 << 63) - 1, 1 << 63, (1 << 63) + 1, (1 << 64) - 1,
         0xFFFFFFFF, 1 << 32, 0x8000000080000000]


def _t(words):
    return torus.from_u64(np.array(words, dtype=np.uint64), "cpu")


@FAST
@given(WORDS)
def test_views_round_trip(words):
    a = np.array(words, dtype=np.uint64)
    t = torus.from_u64(a, "cpu")
    assert t.dtype == torch.int64
    assert (torus.to_u64(t) == a).all()
    assert (t.numpy() == a.view(np.int64)).all()


@FAST
@given(WORDS, WORDS)
def test_wrapping_add_sub_mul(xs, ys):
    n = min(len(xs), len(ys))
    a = np.array(xs[:n], dtype=np.uint64)
    b = np.array(ys[:n], dtype=np.uint64)
    ta, tb = _t(a), _t(b)
    with np.errstate(over="ignore"):
        assert (torus.to_u64(ta + tb) == a + b).all()
        assert (torus.to_u64(ta - tb) == a - b).all()
        assert (torus.to_u64(ta * tb) == a * b).all()
        assert (torus.to_u64(-ta) == np.uint64(0) - a).all()


@pytest.mark.parametrize("shift", [0, 1, 7, 31, 32, 52, 63])
@FAST
@given(words=WORDS)
def test_logical_shift_right(shift, words):
    a = np.array(words, dtype=np.uint64)
    assert (torus.to_u64(torus.shr(_t(a), shift)) == a >> np.uint64(shift)).all()


@FAST
@given(WORDS, WORDS)
def test_unsigned_compare(xs, ys):
    n = min(len(xs), len(ys))
    a = np.array(xs[:n], dtype=np.uint64)
    b = np.array(ys[:n], dtype=np.uint64)
    assert (torus.ult(_t(a), _t(b)).numpy() == (a < b)).all()
    assert (torus.uge(_t(a), _t(b)).numpy() == (a >= b)).all()


@pytest.mark.parametrize("scalar", EDGES)
def test_unsigned_compare_with_int(scalar):
    a = np.array(EDGES, dtype=np.uint64)
    assert (torus.ult(_t(a), scalar).numpy() == (a < np.uint64(scalar))).all()


@pytest.mark.parametrize("value", EDGES)
def test_s64_keeps_the_bits(value):
    s = torus.s64(value)
    assert -(1 << 63) <= s < (1 << 63)
    assert np.array([s], dtype=np.int64).view(np.uint64)[0] == value
