"""Psychoacoustic model: Bark bands, ATH, spreading, temporal masking.

Behavioral mirror of libflo/src/lossy/psychoacoustic.rs, vectorized:
per-bin constants (ATH, Bark band map) and the 25x25 spreading matrix are
precomputed once per (sample_rate, fft_size); masking thresholds for a whole
[.., T, n2] block batch are computed with one one-hot matmul per reduction and
a `lax.scan` over the hop axis for the temporal-masking carry
(psychoacoustic.rs:195-202 — note the reference's quirk of decaying the
previous *dB threshold* by 0.7 as if it were energy; replicated as-is for
parity).
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

NUM_BARK_BANDS = 25

BARK_BAND_EDGES = np.array(
    [
        0.0, 100.0, 200.0, 300.0, 400.0, 510.0, 630.0, 770.0, 920.0, 1080.0,
        1270.0, 1480.0, 1720.0, 2000.0, 2320.0, 2700.0, 3150.0, 3700.0, 4400.0,
        5300.0, 6400.0, 7700.0, 9500.0, 12000.0, 15500.0, 20500.0,
    ],
    dtype=np.float32,
)

MASKING_OFFSET_DB = -6.0
TEMPORAL_DECAY = 0.7
HEADROOM_DB = 10.0

#: Agreement of :func:`smr` (float32) with :func:`smr_host` (float64), in dB.
#: float32 band sums of at most 1024 terms carry a relative error below
#: 1024 * 2^-24 = 6e-5, i.e. 2.6e-4 dB; TF32 rounds each term to 2^-11 =
#: 4.9e-4, i.e. up to 2.1e-3 dB, and fails it.
SMR_TOL_DB = 5e-4


def ath_db(freq: np.ndarray) -> np.ndarray:
    """Terhardt ATH in dB, clamped [-10, 96] (psychoacoustic.rs:90-104).

    Frequencies outside [20, 20000] Hz return 96 dB.
    """
    freq = np.asarray(freq, dtype=np.float32)
    f = freq / np.float32(1000.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        term1 = 3.64 * np.power(f, -0.8, dtype=np.float32)
    term2 = 6.5 * np.exp(-0.6 * (f - 3.3) ** 2, dtype=np.float32)
    term3 = 0.001 * f**4
    val = np.clip(term1 - term2 + term3, -10.0, 96.0)
    out_of_range = (freq < 20.0) | (freq > 20000.0)
    return np.where(out_of_range, np.float32(96.0), val).astype(np.float32)


def freq_to_bark_band(freq: np.ndarray) -> np.ndarray:
    """Bark band index per frequency (psychoacoustic.rs:114-121): first band
    whose upper edge exceeds the frequency, else the last band."""
    freq = np.asarray(freq, dtype=np.float32)
    idx = np.searchsorted(BARK_BAND_EDGES[1:], freq, side="right")
    return np.minimum(idx, NUM_BARK_BANDS - 1).astype(np.int32)


def freq_to_bark(freq: np.ndarray) -> np.ndarray:
    """Traunmueller bark value, clamped [0, 24] (psychoacoustic.rs:107-111)."""
    freq = np.asarray(freq, dtype=np.float32)
    return np.clip((26.81 * freq) / (1960.0 + freq) - 0.53, 0.0, 24.0).astype(np.float32)


def spreading_matrix_db() -> np.ndarray:
    """[masker j, target i] spreading attenuation in dB.

    Reproduces the reference's dB->linear->clamp->dB round trip
    (psychoacoustic.rs:125-147, 151-174): upper slope -25 dB/Bark; the lower
    slope's positive dB clamps to 0 dB (full masking downward — a reference
    quirk kept for parity).
    """
    j = np.arange(NUM_BARK_BANDS, dtype=np.float32)[:, None]
    i = np.arange(NUM_BARK_BANDS, dtype=np.float32)[None, :]
    delta = i - j
    spread_db = np.where(delta >= 0, -25.0 * delta, -10.0 * delta).astype(np.float32)
    linear = np.minimum(np.power(np.float32(10.0), spread_db / 10.0), 1.0).astype(np.float32)
    with np.errstate(divide="ignore"):
        return (10.0 * np.log10(linear)).astype(np.float32)


@lru_cache(maxsize=None)
def model_tables(sample_rate: int, fft_size: int):
    """Per-bin constants for a model instance (psychoacoustic.rs:36-76).

    Returns (ath [n2], band [n2] int32, band_onehot [n2, 25] f32,
    inv_count [25] f32, spread_db [25, 25] f32) as host numpy arrays
    (jit-safe: lifted as compile-time constants at use sites).
    """
    n2 = fft_size // 2
    freq = (np.arange(n2, dtype=np.float32) + 0.5) * (sample_rate / np.float32(fft_size))
    ath = ath_db(freq)
    band = freq_to_bark_band(freq)
    onehot = np.zeros((n2, NUM_BARK_BANDS), dtype=np.float32)
    onehot[np.arange(n2), band] = 1.0
    count = onehot.sum(axis=0)
    inv_count = np.where(count > 0, 1.0 / np.maximum(count, 1.0), 0.0).astype(np.float32)
    return ath, band, onehot, inv_count, spreading_matrix_db()


@partial(jax.jit, static_argnames=("sample_rate", "fft_size"))
def smr(coeffs, sample_rate: int, fft_size: int):
    """Signal-to-mask ratio for batched MDCT blocks.

    coeffs: [..., T, n2] — T is the sequential hop axis (temporal masking
    carries across it, initial state 0 as in psychoacoustic.rs:73).
    Returns SMR [..., T, n2] (psychoacoustic.rs:218-235).
    """
    ath, band, onehot, inv_count, spread = model_tables(sample_rate, fft_size)

    energy = coeffs * coeffs
    # HIGHEST: a GPU would otherwise run this float32 product in TF32 (about
    # three decimal digits), which moves the SMR gating decisions
    # (tools/determinism_probe.py plants TF32 here as a control).
    band_energy = jnp.matmul(
        energy, onehot, precision=jax.lax.Precision.HIGHEST
    )  # [..., T, 25]
    band_mean = band_energy * inv_count
    band_db = jnp.where(
        (inv_count > 0) & (band_energy > 1e-10),
        10.0 * jnp.log10(jnp.maximum(band_mean, 1e-30)),
        -100.0,
    )

    # Simultaneous masking: max over maskers j of band_db[j] + spread[j, i].
    masking = jnp.max(band_db[..., :, None] + spread, axis=-2) + MASKING_OFFSET_DB

    # Temporal masking scan over the hop axis (stateful in the reference).
    def step(prev, cur):
        thr = jnp.maximum(cur, prev * TEMPORAL_DECAY)
        return thr, thr

    m = jnp.moveaxis(masking, -2, 0)  # [T, ..., 25]
    init = jnp.zeros_like(m[0])
    _, thr = jax.lax.scan(step, init, m)
    spread_thr = jnp.moveaxis(thr, 0, -2)  # [..., T, 25]

    per_bin_thr = jnp.maximum(spread_thr[..., band], ath) - HEADROOM_DB

    mag = jnp.abs(coeffs)
    signal_db = jnp.where(
        mag > 1e-10, 20.0 * jnp.log10(jnp.maximum(mag, 1e-30)), -100.0
    )
    return signal_db - per_bin_thr


def smr_host(coeffs, sample_rate: int, fft_size: int) -> np.ndarray:
    """float64 numpy form of :func:`smr`: the reference against which the
    device's float32 result is held (same tables, same order of steps)."""
    ath, band, onehot, inv_count, spread = model_tables(sample_rate, fft_size)
    c = np.asarray(coeffs, np.float64)
    band_energy = (c * c) @ onehot.astype(np.float64)
    inv_count = inv_count.astype(np.float64)
    with np.errstate(divide="ignore"):
        band_db = np.where(
            (inv_count > 0) & (band_energy > 1e-10),
            10.0 * np.log10(np.maximum(band_energy * inv_count, 1e-30)),
            -100.0,
        )
        masking = np.max(band_db[..., :, None] + spread, axis=-2) + MASKING_OFFSET_DB
    thr = np.empty_like(masking)
    prev = np.zeros_like(masking[..., 0, :])
    for t in range(masking.shape[-2]):
        prev = np.maximum(masking[..., t, :], prev * TEMPORAL_DECAY)
        thr[..., t, :] = prev
    per_bin_thr = np.maximum(thr[..., band], ath) - HEADROOM_DB
    mag = np.abs(c)
    signal_db = np.where(mag > 1e-10, 20.0 * np.log10(np.maximum(mag, 1e-30)), -100.0)
    return signal_db - per_bin_thr
