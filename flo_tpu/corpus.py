"""The committed conformance corpus and seeded program material built from it.

``tests/vectors/examples/`` holds the reference encoder's Examples corpus
(tests/vectors/README.md). The smoke check and the benchmark build their
bulk workloads from it, so a checkout of the repository is all they need.
``FLO_TPU_EXAMPLES_DIR`` points elsewhere. :func:`mixed_lanes` makes seeded
inputs for the reconstruction kernels.
"""

from __future__ import annotations

import os
import pathlib

import numpy as np

_REPO = pathlib.Path(__file__).resolve().parent.parent


def examples_dir() -> pathlib.Path:
    env = os.environ.get("FLO_TPU_EXAMPLES_DIR")
    return pathlib.Path(env) if env else _REPO / "tests" / "vectors" / "examples"


def lossless_files() -> list[pathlib.Path]:
    """Every lossless corpus file (11 in the reference corpus)."""
    from .container import reader

    return [
        p for p in sorted(examples_dir().glob("*.flo"))
        if not reader.read(p.read_bytes()).header.is_lossy
    ]


def _sources(rate: int) -> list[np.ndarray]:
    """Decoded lossless corpus content at ``rate`` as [n, 2] float32 (mono
    files are widened to stereo with a 7 ms delay on the right channel)."""
    from .container import reader
    from .lossless import decoder

    out = []
    for p in lossless_files():
        flo = reader.read(p.read_bytes())
        h = flo.header
        if h.sample_rate != rate or h.channels not in (1, 2):
            continue
        x = decoder.decode_file_host(flo).reshape(-1, h.channels)
        if h.channels == 1:
            d = rate * 7 // 1000
            x = np.stack([x[:, 0], np.concatenate([np.zeros(d, x.dtype), x[:-d, 0]])], 1)
        if len(x) >= rate // 4 and np.abs(x).max() > 0:
            out.append(x.astype(np.float32))
    return out


def mixed_lanes(seed: int, L: int, S: int):
    """Seeded reconstruction inputs of every kind the decoder meets, for
    checking an implementation against ``ops.lpc.reconstruct_host``: lane
    l % 4 is LPC of order 1 + (l // 4) % 12 at shift (l // 4) % 16, a fixed
    predictor of order (l // 4) % 5, raw, or order-12 LPC at shift 15 with
    full-range taps; every fifth step is a spike that wraps int32 sums."""
    from .ops.lpc import _FIXED_COEFFS, MAX_ORDER

    rng = np.random.default_rng(seed)
    residuals = rng.integers(-3000, 3000, (L, S)).astype(np.int32)
    step = max(S // 5, 1)
    residuals[:, ::step] = rng.integers(-(1 << 20), 1 << 20, residuals[:, ::step].shape)
    coeffs = np.zeros((L, MAX_ORDER), np.int32)
    shifts = np.zeros(L, np.int32)
    orders = np.zeros(L, np.int32)
    is_fixed = np.zeros(L, bool)
    lane = np.arange(L)
    kind, k = lane % 4, lane // 4
    taps = rng.integers(-(1 << 15), 1 << 15, (L, MAX_ORDER)).astype(np.int32)
    lpc_lane, fixed_lane, full_lane = kind == 0, kind == 1, kind == 3
    orders[lpc_lane] = 1 + k[lpc_lane] % MAX_ORDER
    shifts[lpc_lane] = k[lpc_lane] % 16
    orders[fixed_lane] = k[fixed_lane] % 5
    coeffs[fixed_lane] = _FIXED_COEFFS[orders[fixed_lane]]
    is_fixed[fixed_lane] = True
    orders[full_lane], shifts[full_lane] = MAX_ORDER, 15
    live = (lpc_lane | full_lane)[:, None] & (np.arange(MAX_ORDER) < orders[:, None])
    coeffs = np.where(live, taps, coeffs)
    return residuals, coeffs, shifts, orders, is_fixed


def material(n_files: int, seconds: int, seed: int, rate: int = 44100) -> list[np.ndarray]:
    """``n_files`` interleaved stereo clips of ``seconds`` each, cut from the
    corpus: segments of 0.25-3 s from random sources at random offsets and
    gains, chosen by ``seed``. Samples lie on the i16 grid, so lossless
    round trips are exact."""
    rng = np.random.default_rng(seed)
    sources = _sources(rate)
    clips = []
    n = seconds * rate
    for _ in range(n_files):
        out = np.empty((n, 2), np.float32)
        pos = 0
        while pos < n:
            src = sources[rng.integers(len(sources))]
            seg = min(int(rng.uniform(0.25, 3.0) * rate), len(src), n - pos)
            start = int(rng.integers(0, len(src) - seg + 1))
            out[pos : pos + seg] = src[start : start + seg] * rng.uniform(0.3, 1.0)
            pos += seg
        clips.append((np.round(np.clip(out, -1, 1) * 32767) / 32767).reshape(-1))
    return [c.astype(np.float32) for c in clips]
