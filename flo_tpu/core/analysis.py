"""Audio analysis: waveform peaks/RMS, spectral fingerprint, similarity.

Behavioral mirror of libflo/src/core/analysis.rs, vectorized with numpy
(windowed reductions via ``reduceat``; the 256-pt probe FFTs via np.fft).
EBU R128 loudness lives in ebu_r128.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import blake3, msgpack
from .metadata import WaveformData


@dataclass
class SpectralFingerprint:
    """Compact audio fingerprint (analysis.rs:10-26)."""

    hash: bytes = b"\x00" * 32
    duration_ms: int = 0
    sample_rate: int = 0
    channels: int = 0
    frequency_peaks: bytes = b"\x00" * 8
    energy_profile: bytes = b"\x00" * 16
    avg_loudness: int = 0

    def to_bytes(self) -> bytes:
        """Wire form stored in metadata `spectrum_fingerprint`:
        rmp_serde::to_vec_named of the struct (lib.rs:255-258) — a msgpack
        named map with fixed-size u8 arrays as int lists."""
        return msgpack.packb(
            {
                "hash": list(self.hash),
                "duration_ms": int(self.duration_ms),
                "sample_rate": int(self.sample_rate),
                "channels": int(self.channels),
                "frequency_peaks": list(self.frequency_peaks),
                "energy_profile": list(self.energy_profile),
                "avg_loudness": int(self.avg_loudness),
            }
        )

    @classmethod
    def from_bytes(cls, data: bytes) -> "SpectralFingerprint":
        d = msgpack.unpackb(data)
        return cls(
            hash=bytes(d.get("hash", b"\x00" * 32)),
            duration_ms=int(d.get("duration_ms", 0)),
            sample_rate=int(d.get("sample_rate", 0)),
            channels=int(d.get("channels", 0)),
            frequency_peaks=bytes(d.get("frequency_peaks", b"\x00" * 8)),
            energy_profile=bytes(d.get("energy_profile", b"\x00" * 16)),
            avg_loudness=int(d.get("avg_loudness", 0)),
        )


def _window_bounds(n_frames: int, samples_per_peak: float):
    idx = np.arange(int(np.ceil(n_frames / samples_per_peak)) + 1, dtype=np.float64)
    b = (idx * samples_per_peak).astype(np.int64)
    return b


def _extract_waveform(samples, channels, sample_rate, peaks_per_second, rms: bool):
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    if samples.size == 0:
        return WaveformData(peaks_per_second=peaks_per_second, peaks=[], channels=channels)
    C = int(channels)
    spp = sample_rate / float(peaks_per_second)
    total = int(np.ceil(samples.size / (spp * C)))

    n_frames = samples.size // C
    frames = samples[: n_frames * C].reshape(n_frames, C)
    tail = samples.size - n_frames * C

    # Window boundaries in frame units (analysis.rs:58-66: f64 truncation).
    starts = (np.arange(total, dtype=np.float64) * spp).astype(np.int64)
    ends = ((np.arange(total, dtype=np.float64) + 1.0) * spp).astype(np.int64)
    starts = np.minimum(starts, n_frames + (1 if tail else 0))
    keep = starts * C < samples.size
    starts, ends = starts[keep], np.minimum(ends[keep], n_frames)

    if C == 1:
        x = np.abs(frames[:, 0]) if not rms else frames[:, 0].astype(np.float64) ** 2
    elif C == 2:
        if rms:
            x = frames.astype(np.float64) ** 2
        else:
            x = np.abs(frames)
    else:
        mono = frames.mean(axis=1)
        x = mono.astype(np.float64) ** 2 if rms else np.abs(mono)

    peaks = np.zeros(len(starts), dtype=np.float64)
    valid = starts < ends
    red_starts = np.where(valid, starts, 0)
    if valid.any() and n_frames > 0:
        if C == 2:
            if rms:
                cs = np.vstack([np.zeros((1, 2)), np.cumsum(x, axis=0)])
                lens = np.maximum(ends - starts, 1)
                sums = cs[ends] - cs[starts]
                lr = np.sqrt(sums / lens[:, None])
                peaks = np.where(valid, (lr[:, 0] + lr[:, 1]) / 2.0, 0.0)
            else:
                lmax = np.maximum.reduceat(x[:, 0], red_starts)
                rmax = np.maximum.reduceat(x[:, 1], red_starts)
                # reduceat returns per-start segment reductions to next start.
                peaks = np.where(valid, (lmax + rmax) / 2.0, 0.0)
        else:
            if rms:
                cs = np.concatenate([[0.0], np.cumsum(x)])
                lens = np.maximum(ends - starts, 1)
                peaks = np.where(valid, np.sqrt((cs[ends] - cs[starts]) / lens), 0.0)
            else:
                peaks = np.where(valid, np.maximum.reduceat(x, red_starts), 0.0)
    peaks = peaks.astype(np.float32)

    m = peaks.max(initial=0.0)
    if m > 0:
        peaks = peaks / m
    return WaveformData(
        peaks_per_second=int(peaks_per_second),
        peaks=[float(p) for p in peaks],
        channels=C,
    )


def extract_waveform_peaks(samples, channels, sample_rate, peaks_per_second=50):
    """Windowed max-abs peaks, stereo averaged, normalized (analysis.rs:38-115)."""
    return _extract_waveform(samples, channels, sample_rate, peaks_per_second, rms=False)


def extract_waveform_rms(samples, channels, sample_rate, peaks_per_second=50):
    """Windowed RMS variant (analysis.rs:121-210)."""
    return _extract_waveform(samples, channels, sample_rate, peaks_per_second, rms=True)


def extract_spectral_fingerprint(
    samples, channels, sample_rate, fft_size=None, hop_size=None
) -> SpectralFingerprint:
    """BLAKE3 content hash + 3-probe 256-pt FFT spectral profile
    (analysis.rs:223-357)."""
    samples = np.asarray(samples, dtype=np.float32).reshape(-1)
    C = int(channels)
    if samples.size == 0:
        return SpectralFingerprint(sample_rate=sample_rate, channels=C)

    n = samples.size // C
    duration_ms = max(1, int(n / sample_rate * 1000.0))

    # Header (channels u8, rate u32le, count u32le) + raw little-endian f32
    # PCM, assembled in ONE buffer (a bytes-concat of the ~MB PCM payload
    # costs two extra copies per file on this 1-core host).
    hasher_input = np.empty(9 + 4 * samples.size, dtype=np.uint8)
    hasher_input[0] = C & 0xFF
    hasher_input[1:5].view("<u4")[0] = int(sample_rate)
    hasher_input[5:9].view("<u4")[0] = samples.size & 0xFFFFFFFF
    hasher_input[9:].view("<f4")[:] = samples
    from .. import native

    h = native.blake3_digest(hasher_input)  # C++ tree hash (27x the numpy path)
    if h is None:
        h = blake3.digest(hasher_input.tobytes())

    FFT = 256
    probes = [n // 4, n // 2, n * 3 // 4]
    bands = np.zeros(16, dtype=np.float32)
    peak_bands = np.zeros(8, dtype=np.uint8)
    frames = samples[: n * C].reshape(n, C)
    for p in probes:
        if p + FFT >= n:
            continue
        mono = frames[p : p + FFT].mean(axis=1, dtype=np.float32)
        spec = np.fft.fft(mono.astype(np.float64))
        mag2 = (spec.real**2 + spec.imag**2).astype(np.float32)
        for band in range(16):
            s, e = band * FFT // 32, min((band + 1) * FFT // 32, FFT // 2)
            bands[band] += np.sqrt(mag2[s:e].sum())
        for band in range(8):
            s, e = band * FFT // 16, min((band + 1) * FFT // 16, FFT // 2)
            peak_bin = s + int(np.argmax(mag2[s:e]))
            peak_bands[band] = max(peak_bands[band], int(peak_bin / FFT * 255.0))

    max_e = bands.max(initial=0.0)
    energy = (
        (bands / max_e * 255.0).astype(np.uint8) if max_e > 0 else np.zeros(16, np.uint8)
    )

    ss = native.sumsq_f32(samples)
    if ss is None:  # portable fallback (no toolchain)
        ss = float(np.sum(samples.astype(np.float64) ** 2))
    ms = ss / samples.size
    avg_loudness = int(np.clip(-20.0 * np.log10(ms + 1e-10), -60.0, 0.0) + 60.0)

    return SpectralFingerprint(
        hash=h,
        duration_ms=duration_ms,
        sample_rate=int(sample_rate),
        channels=C,
        frequency_peaks=peak_bands.tobytes(),
        energy_profile=energy.tobytes(),
        avg_loudness=avg_loudness,
    )


def extract_dominant_frequencies(fp: SpectralFingerprint, num_frequencies: int):
    """Map peak bands back to Hz (analysis.rs:367-385)."""
    k = min(num_frequencies, 8)
    peaks = list(fp.frequency_peaks)
    return [[peaks[i] / 255.0 * (fp.sample_rate / 2.0) for i in range(k)]]


def spectral_similarity(a: SpectralFingerprint, b: SpectralFingerprint) -> float:
    """Weighted 0.5/0.3/0.2 similarity (analysis.rs:395-437)."""
    if bytes(a.hash) == bytes(b.hash):
        return 1.0
    if a.sample_rate != b.sample_rate or a.channels != b.channels:
        return 0.0
    ea, eb = np.frombuffer(bytes(a.energy_profile), np.uint8).astype(np.float32), (
        np.frombuffer(bytes(b.energy_profile), np.uint8).astype(np.float32)
    )
    pa, pb = np.frombuffer(bytes(a.frequency_peaks), np.uint8).astype(np.float32), (
        np.frombuffer(bytes(b.frequency_peaks), np.uint8).astype(np.float32)
    )
    e_sim = float(np.mean(1.0 - np.abs(ea - eb) / 255.0))
    p_sim = float(np.mean(1.0 - np.abs(pa - pb) / 255.0))
    l_sim = 1.0 - abs(a.avg_loudness - b.avg_loudness) / 255.0
    return e_sim * 0.5 + p_sim * 0.3 + l_sim * 0.2
