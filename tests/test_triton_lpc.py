"""The Triton reconstruction kernel must be bit-identical to the lax.scan
formulation and to the numpy oracle. Runs in interpret mode on the CPU; the
compiled kernel is checked on the GPU by tests/test_chip.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flo_tpu.corpus import mixed_lanes
from flo_tpu.ops import lpc
from flo_tpu.ops.triton_lpc import (
    BLOCK_LANES,
    T_CHUNK,
    WARMUP,
    padded_shape,
    reconstruct_triton,
)


def _check(args):
    dev = [jnp.asarray(a) for a in args]
    got = np.asarray(reconstruct_triton(*dev, interpret=True))
    np.testing.assert_array_equal(got, np.asarray(lpc.reconstruct(*dev)))
    np.testing.assert_array_equal(got, lpc.reconstruct_host(*args))


def test_mixed_orders_and_warmup():
    """Orders 0-12, fixed and LPC, through the 12-step warm-up prologue."""
    _check(mixed_lanes(0, 52, WARMUP + 2 * T_CHUNK + 5))


@pytest.mark.parametrize(
    "S", [3, WARMUP, WARMUP + 1, WARMUP + T_CHUNK, WARMUP + 2 * T_CHUNK + 1]
)
def test_time_chunk_boundaries(S):
    """The carry hands off exactly across the prologue and chunk edges,
    and padded steps past S are trimmed."""
    _check(mixed_lanes(3, 8, S))


@pytest.mark.parametrize("L", [1, BLOCK_LANES + 5, 2 * BLOCK_LANES + 6])
def test_lane_padding(L):
    """Lane counts that are not a multiple of the block pad with inert lanes."""
    assert padded_shape(L, 40)[0] % BLOCK_LANES == 0
    _check(mixed_lanes(5, L, 40))


def test_int32_wrap():
    """Accumulations past the int32 range wrap like the reference's
    release-mode arithmetic."""
    L, S = 8, 60
    residuals = np.full((L, S), (1 << 31) - 5, np.int64).astype(np.int32)
    residuals[::2] = np.int32(-(1 << 31) + 7)
    coeffs = np.zeros((L, lpc.MAX_ORDER), np.int32)
    coeffs[:, :2] = [[2, -1]]
    coeffs[4:, :12] = (1 << 31) - 1  # extreme taps with the largest shift
    shifts = np.where(np.arange(L) >= 4, 15, 0).astype(np.int32)
    orders = np.where(np.arange(L) >= 4, 12, 2).astype(np.int32)
    is_fixed = np.arange(L) < 4
    _check((residuals, coeffs, shifts, orders, is_fixed))


def test_padded_shape():
    assert padded_shape(960, 44100) == (960, WARMUP + -(-(44100 - WARMUP) // T_CHUNK) * T_CHUNK)
    assert padded_shape(1, 1) == (BLOCK_LANES, WARMUP)


def test_choice_by_platform():
    """The GPU takes the kernel and the CPU the scan: a CPU program holds
    no kernel, while a CUDA lowering of the same call does."""
    args = [jnp.asarray(a) for a in mixed_lanes(1, 4, 20)]
    traced = jax.jit(lpc.reconstruct_best).trace(*args)
    assert "triton" not in traced.lower(lowering_platforms=("cpu",)).as_text()
    assert "triton" in traced.lower(lowering_platforms=("cuda",)).as_text()
