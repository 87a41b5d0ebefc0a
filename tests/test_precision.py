"""Float32 products on the lossy path carry HIGHEST precision (a GPU would
otherwise run them in TF32), and the device numerics agree with their
float64 references within stated tolerances."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from flo_tpu.lossy import encoder as loe
from flo_tpu.ops import mdct, psycho


def _blocks(seed, C=2, T=6):
    rng = np.random.default_rng(seed)
    t = np.arange(T * 2048) / 44100.0
    x = 0.5 * np.sin(2 * np.pi * 997 * t) + 0.05 * rng.standard_normal(t.size)
    return np.stack([x.reshape(T, 2048)] * C).astype(np.float32)


def _dot_precisions(text):
    return re.findall(r"stablehlo\.dot_general.*", text)


def test_smr_product_carries_highest_precision():
    coeffs = jnp.zeros((2, 3, 1024), jnp.float32)
    text = psycho.smr.lower(coeffs, 44100, 2048).as_text()
    dots = _dot_precisions(text)
    assert dots and all("HIGHEST" in d for d in dots), dots


def test_lossy_encode_program_has_no_default_precision_product():
    text = loe._encode_blocks.lower(jnp.asarray(_blocks(0)), 44100, -30.0).as_text()
    assert all("HIGHEST" in d for d in _dot_precisions(text))


@pytest.mark.parametrize("seed", [0, 1])
def test_smr_matches_float64(seed):
    coeffs = np.asarray(mdct.forward(jnp.asarray(_blocks(seed)), 2048, "vorbis"))
    got = np.asarray(psycho.smr(jnp.asarray(coeffs), 44100, 2048))
    want = psycho.smr_host(coeffs, 44100, 2048)
    np.testing.assert_allclose(got, want, rtol=0, atol=psycho.SMR_TOL_DB)


def test_mdct_matches_float64_oracle():
    x = _blocks(2, C=1, T=3)[0]
    got = np.asarray(mdct.forward(jnp.asarray(x), 2048, "vorbis"))
    want = mdct.mdct_oracle(x, 2048, "vorbis")
    assert np.abs(got - want).max() <= mdct.ORACLE_RTOL * np.abs(want).max()
