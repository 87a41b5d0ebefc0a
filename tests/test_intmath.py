"""Exactness proof-by-test for the int32 limb arithmetic.

Ground truth is numpy int64 (same semantics as the reference's Rust i64 path:
wide MAC, arithmetic shift, truncating i32 cast).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from flo_tpu.ops.intmath import div2_trunc, dot_f32, predict_shift


def _ground_truth(c, s, shift):
    acc = (c.astype(np.int64) * s.astype(np.int64)).sum(axis=-1)
    return ((acc >> shift) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shift", [0, 1, 7, 14, 15])
def test_predict_shift_random(seed, shift):
    rng = np.random.default_rng(seed)
    n = 4096
    # Samples up to 2^17 (mid channel), coeffs up to 2^20 (typical LD output).
    c = rng.integers(-(2**20), 2**20, size=(n, 12)).astype(np.int32)
    s = rng.integers(-(2**17), 2**17, size=(n, 12)).astype(np.int32)
    got = np.asarray(predict_shift(jnp.asarray(c), jnp.asarray(s), shift))
    want = _ground_truth(c, s, np.int64(shift))
    np.testing.assert_array_equal(got, want)


def test_predict_shift_extreme_domain():
    # Documented exactness domain: |s| < 2^25, |c| < 2^31.
    rng = np.random.default_rng(3)
    n = 2048
    c = rng.integers(-(2**31), 2**31, size=(n, 12)).astype(np.int64).astype(np.int32)
    s = rng.integers(-(2**25), 2**25, size=(n, 12)).astype(np.int32)
    for shift in (0, 15):
        got = np.asarray(predict_shift(jnp.asarray(c), jnp.asarray(s), shift))
        want = _ground_truth(c, s, np.int64(shift))
        np.testing.assert_array_equal(got, want)


def test_predict_shift_per_lane_shift():
    rng = np.random.default_rng(4)
    n = 1000
    c = rng.integers(-(2**18), 2**18, size=(n, 12)).astype(np.int32)
    s = rng.integers(-(2**17), 2**17, size=(n, 12)).astype(np.int32)
    shifts = rng.integers(0, 16, size=n).astype(np.int32)
    got = np.asarray(predict_shift(jnp.asarray(c), jnp.asarray(s), jnp.asarray(shifts)))
    want = np.array(
        [_ground_truth(c[i : i + 1], s[i : i + 1], np.int64(shifts[i]))[0] for i in range(n)]
    )
    np.testing.assert_array_equal(got, want)


def test_div2_trunc():
    x = np.array([5, -5, 4, -4, 0, 1, -1, 2**30, -(2**30)], dtype=np.int32)
    got = np.asarray(div2_trunc(jnp.asarray(x)))
    want = np.array([2, -2, 2, -2, 0, 0, 0, 2**29, -(2**29)], dtype=np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("S", [1, 4096, 44100, 96000])
def test_dot_f32_extreme_domain(S):
    """Full-scale mid/side samples (|x| = 2^17) over frames up to 96 kHz: the
    int32 partial sums never wrap, so the result is the int64 sum to within
    the few float32 roundings of its assembly."""
    rng = np.random.default_rng(S)
    a = rng.choice([-(2**17), 2**17 - 1, 2**17], size=(3, S)).astype(np.int32)
    b = np.stack([a[0], -a[1], rng.integers(-(2**17), 2**17 + 1, S)]).astype(np.int32)
    prod = a.astype(np.int64) * b.astype(np.int64)
    got = np.asarray(dot_f32(jnp.asarray(a), jnp.asarray(b))).astype(np.float64)
    err = np.abs(got - prod.sum(axis=-1))
    assert (err <= 2.0**-21 * np.abs(prod).sum(axis=-1)).all(), err


def test_dot_f32_exact_below_2_24():
    """Sums that fit a float32 mantissa come out exact."""
    rng = np.random.default_rng(7)
    a = rng.integers(-40, 40, size=(16, 5000)).astype(np.int32)
    b = rng.integers(-40, 40, size=(16, 5000)).astype(np.int32)
    want = (a.astype(np.int64) * b).sum(axis=-1)
    assert np.abs(want).max() < 2**24
    np.testing.assert_array_equal(np.asarray(dot_f32(jnp.asarray(a), jnp.asarray(b))), want)


def test_dot_f32_rows_do_not_depend_on_batch():
    """A row's result is the same whether it is reduced alone, in a slice,
    or in the whole batch."""
    rng = np.random.default_rng(8)
    a = rng.integers(-(2**16), 2**16, size=(12, 9000)).astype(np.int32)
    whole = np.asarray(dot_f32(jnp.asarray(a), jnp.asarray(a)))
    for lo, hi in ((0, 1), (3, 6), (4, 12)):
        part = np.asarray(dot_f32(jnp.asarray(a[lo:hi]), jnp.asarray(a[lo:hi])))
        np.testing.assert_array_equal(part, whole[lo:hi])
