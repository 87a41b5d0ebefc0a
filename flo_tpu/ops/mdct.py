"""Batched MDCT/IMDCT.

Same transform math as the reference (libflo/src/lossy/mdct.rs:166-291):
window -> fold N samples into N/4 complex points -> N/4 FFT -> twiddle,
with twiddle factors e^{i*(pi/n2)*(k+1/8)} and IMDCT output scaled by 2/n2 and
windowed. The reference processes one block per call with per-channel overlap
state; here every (lane, block) is one row of a [B, N] tensor, the FFT is
`jnp.fft.fft` over the whole batch, and overlap-add happens as one shifted add
over the block axis (no sequential state).

Windows: Sine, Vorbis, KBD(alpha=4) per mdct.rs:99-161.
"""

from __future__ import annotations

from functools import lru_cache, partial

import jax
import jax.numpy as jnp
import numpy as np

LONG_N = 2048
SHORT_N = 256

#: Largest error of :func:`forward` against :func:`mdct_oracle`, relative to
#: the largest coefficient: float32 FFT error grows as log2(N) * eps * |x|,
#: about 1e-6 at N = 2048, so this leaves a wide margin.
ORACLE_RTOL = 1e-5


def sine_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float32)
    return np.sin(np.pi * (i + 0.5) / n).astype(np.float32)


def vorbis_window(n: int) -> np.ndarray:
    i = np.arange(n, dtype=np.float32)
    x = np.sin(np.pi * (i + 0.5) / n)
    return np.sin(np.pi / 2.0 * x * x).astype(np.float32)


def kbd_window(n: int, alpha: float = 4.0) -> np.ndarray:
    half = n // 2
    i = np.arange(half + 1, dtype=np.float64)
    arg = np.pi * alpha * np.sqrt(np.maximum(0.0, 1.0 - (2.0 * i / half - 1.0) ** 2))
    kaiser = np.i0(arg)
    cumsum = np.cumsum(kaiser)
    w = np.zeros(n, dtype=np.float32)
    w[:half] = np.sqrt(cumsum[:half] / cumsum[half]).astype(np.float32)
    w[n - half :] = w[:half][::-1]
    return w


_WINDOWS = {"sine": sine_window, "vorbis": vorbis_window, "kbd": kbd_window}


@lru_cache(maxsize=None)
def _tables(n: int, window: str):
    """Window + twiddle constants as host numpy (jit-safe: lifted as
    compile-time constants at use sites)."""
    n2, n4 = n // 2, n // 4
    k = np.arange(n4, dtype=np.float32)
    ang = np.float32(np.pi) / np.float32(n2) * (k + np.float32(0.125))
    tw = np.cos(ang).astype(np.float32) + 1j * np.sin(ang).astype(np.float32)
    win = _WINDOWS[window](n)
    return win, tw.astype(np.complex64)


@partial(jax.jit, static_argnames=("n", "window"))
def forward(samples, n: int = LONG_N, window: str = "vorbis"):
    """Forward MDCT: [..., n] windowed samples -> [..., n/2] coefficients.

    Vectorized restatement of the FFmpeg-style fold in mdct.rs:166-226.
    """
    win, tw = _tables(n, window)
    n2, n4, n8 = n // 2, n // 4, n // 8
    n3 = 3 * n4
    x = samples * win

    rev = lambda t: t[..., ::-1]
    # First butterfly (z[0:n8]):
    #   re = -x[2i+3n/4] - x[3n/4-1-2i], im = -x[n/4+2i] + x[n/4-1-2i]
    re_a = -x[..., n3::2] - rev(x[..., n2 + 1 : n3 : 2])
    im_a = -x[..., n4:n2:2] + rev(x[..., 1:n4:2])
    # Second butterfly (z[n8:n4]):
    #   re = x[2i] - x[n/2-1-2i], im = -x[n/2+2i] - x[n-1-2i]
    re_b = x[..., 0:n4:2] - rev(x[..., n4 + 1 : n2 : 2])
    im_b = -x[..., n2:n3:2] - rev(x[..., n3 + 1 :: 2])

    re = jnp.concatenate([re_a, re_b], axis=-1)
    im = jnp.concatenate([im_a, im_b], axis=-1)
    wr, wi = jnp.real(tw), jnp.imag(tw)
    z = (-re * wr - im * wi) + 1j * (re * wi - im * wr)

    zf = jnp.fft.fft(z.astype(jnp.complex64), axis=-1)
    zr, zi = jnp.real(zf), jnp.imag(zf)

    r = -(zr * wr + zi * wi)
    s = -zr * wi + zi * wr
    out = jnp.stack([r, s[..., ::-1]], axis=-1)
    return out.reshape(*out.shape[:-2], n2)


@partial(jax.jit, static_argnames=("n", "window"))
def inverse(spec, n: int = LONG_N, window: str = "vorbis"):
    """Inverse MDCT: [..., n/2] coefficients -> [..., n] windowed+scaled
    samples ready for 50%-overlap-add (mdct.rs:231-291, Symphonia algorithm).
    """
    win, tw = _tables(n, window)
    n2, n4, n8 = n // 2, n // 4, n // 8

    even = spec[..., 0::2]
    odd = -spec[..., n2 - 1 :: -2][..., :n4]
    wr, wi = jnp.real(tw), jnp.imag(tw)
    z = (odd * wi - even * wr) + 1j * (odd * wr + even * wi)

    zf = jnp.fft.fft(z.astype(jnp.complex64), axis=-1)
    zr, zi = jnp.real(zf), jnp.imag(zf)

    vr = wr * zr + wi * zi
    vi = wi * zr - wr * zi

    vr1, vr2 = vr[..., :n8], vr[..., n8:]
    vi1, vi2 = vi[..., :n8], vi[..., n8:]

    def interleave(a, b):
        o = jnp.stack([a, b], axis=-1)
        return o.reshape(*o.shape[:-2], n4)

    rev = lambda t: t[..., ::-1]
    q1 = interleave(-vr2, -rev(vi1))
    q2 = interleave(vi1, rev(vr2))
    q3 = interleave(vi2, rev(vr1))
    q4 = interleave(vr1, rev(vi2))
    out = jnp.concatenate([q1, q2, q3, q4], axis=-1)
    scale = jnp.float32(2.0 / n2)
    return out * (scale * win)


@jax.jit
def overlap_add(blocks):
    """Stateless 50% overlap-add over the block axis.

    blocks: [..., T, n] IMDCT outputs (already windowed+scaled).
    Returns [..., T, n/2] stream segments: segment t = blocks[t, :n/2] +
    blocks[t-1, n/2:], with zeros before block 0 — exactly the stateful
    per-block overlap buffer of mdct.rs:437-468 unrolled over the batch.
    """
    n = blocks.shape[-1]
    n2 = n // 2
    first = blocks[..., :n2]
    second = blocks[..., n2:]
    prev = jnp.concatenate(
        [jnp.zeros_like(second[..., :1, :]), second[..., :-1, :]], axis=-2
    )
    return first + prev


def mdct_oracle(samples: np.ndarray, n: int, window: str = "vorbis") -> np.ndarray:
    """O(N^2) direct MDCT for testing:
    X[k] = sum_n x[n] w[n] cos(pi/n2 (n + 0.5 + n2/... ) ...) per mdct.rs:
    X[k] = sum x[n]*w[n]*cos(pi/N*(n+0.5+N/2)*(k+0.5)), N = n/... (2N=n).
    """
    win = _WINDOWS[window](n).astype(np.float64)
    n2 = n // 2
    x = samples.astype(np.float64) * win
    nn = np.arange(n)[:, None]
    kk = np.arange(n2)[None, :]
    basis = np.cos(np.pi / n2 * (nn + 0.5 + n2 / 2.0) * (kk + 0.5))
    return (x[..., None, :] @ basis).squeeze(-2) if samples.ndim > 1 else x @ basis
