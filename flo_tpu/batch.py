"""Top-level bulk (multi-file) API — the corpus-throughput surface.

Each call runs one device program for the whole batch (see
lossless/encoder.encode_many, lossy/encoder.encode_many, and the two
decode_many implementations), which is how thousands of files per chip are
meant to be processed (SURVEY.md §0 north star).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from .container import reader
from .core.constants import FrameType
from .futures import BulkFuture
from .lossless import decoder as _lossless_decoder
from .lossless import encoder as _lossless_encoder
from .lossy import decoder as _lossy_decoder
from .lossy import encoder as _lossy_encoder
from .lossy.presets import QUALITY_U8_TO_F32


def _analyzed_metas_async(samples_list, sample_rate, channels, metadata_list, analyze):
    """Reference facade behavior: every encoded file gets analysis metadata
    (waveform/fingerprint/loudness/length_ms) embedded, lib.rs:219-283.

    Returns a zero-arg callable producing the metadata list. With
    analyze=True the pass runs on a worker thread so it overlaps the encode
    pipeline's wire waits: the analysis path touches ONLY numpy + the ctypes
    kernels (both release the GIL) and never jax, so it never shares the
    device with the pipelines, which stay single-threaded (futures.py)."""
    if not analyze:
        return lambda: metadata_list
    import threading

    from .core.analysis_batch import analyze_many

    box: list = []

    def run():
        # Capture failures: the collect-side get() re-raises them, so an
        # analysis error surfaces with its real traceback instead of the
        # worker dying silently and get() hitting an empty box.
        try:
            box.append(
                (True, analyze_many(samples_list, sample_rate, channels, metadata_list))
            )
        except BaseException as e:  # noqa: BLE001 — re-raised at get()
            box.append((False, e))

    t = threading.Thread(target=run, daemon=True)
    t.start()

    def get():
        t.join()
        ok, val = box[0]
        if not ok:
            raise val
        return val

    return get


def encode_many_async(
    samples_list: Sequence[np.ndarray],
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata_list: Optional[Sequence[bytes]] = None,
    analyze: bool = True,
) -> BulkFuture:
    """Lossless bulk encode, dispatched immediately (futures.BulkFuture).

    The device candidate search is dispatched FIRST; the host analysis pass
    (waveform/fingerprint/loudness, lib.rs:219-283) then runs while the
    device computes, and the metadata lands in the container writer at
    collect time — analysis costs ~no wall time when the device pass is
    longer."""
    from .container import writer

    level = min(int(compression_level), 9)
    fut = _lossless_encoder.encode_many_to_frames_async(
        samples_list, sample_rate, channels, level, "device"
    )
    get_metas = _analyzed_metas_async(
        samples_list, sample_rate, channels, metadata_list, analyze
    )

    def fin(frames_per_file):
        metas = get_metas() or [b""] * len(samples_list)
        return [
            writer.write(
                int(sample_rate), int(channels), int(bit_depth), level, frames, meta
            )
            for frames, meta in zip(frames_per_file, metas)
        ]

    return fut.then(fin)


def encode_many(
    samples_list: Sequence[np.ndarray],
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata_list: Optional[Sequence[bytes]] = None,
    analyze: bool = True,
) -> List[bytes]:
    """Lossless bulk encode with auto-embedded analysis (lib.rs:219-283;
    analyze=False skips it). Uses on-device coefficient analysis (bit-exact
    round-trips; pass analysis="exact" via lossless.encoder.encode_many for
    output byte-identical to the per-file `encode`)."""
    return encode_many_async(
        samples_list, sample_rate, channels, bit_depth, compression_level,
        metadata_list, analyze,
    ).result()


def encode_lossy_many_async(
    samples_list: Sequence[np.ndarray],
    sample_rate: int,
    channels: int,
    quality: int = 2,
    metadata_list: Optional[Sequence[bytes]] = None,
    transport_dtype=np.float32,
    analyze: bool = True,
) -> BulkFuture:
    """Lossy bulk encode, dispatched immediately; quality is the u8 preset.

    Device MDCT work is dispatched before the host analysis pass runs (see
    encode_many_async); metadata lands in the writer at collect time."""
    from .container import writer

    q = QUALITY_U8_TO_F32[min(int(quality), 4)]
    fut = _lossy_encoder.encode_many_to_frames_async(
        samples_list, sample_rate, channels, q, transport_dtype
    )
    get_metas = _analyzed_metas_async(
        samples_list, sample_rate, channels, metadata_list, analyze
    )
    q_u8 = min(int(quality), 4)

    def fin(frames_per_file):
        metas = get_metas() or [b""] * len(samples_list)
        return [
            writer.write(
                int(sample_rate), int(channels), 16, 5, frames, meta,
                lossy=True, lossy_quality=q_u8,
            )
            for frames, meta in zip(frames_per_file, metas)
        ]

    return fut.then(fin)


def encode_lossy_many(
    samples_list: Sequence[np.ndarray],
    sample_rate: int,
    channels: int,
    quality: int = 2,
    metadata_list: Optional[Sequence[bytes]] = None,
    transport_dtype=np.float32,
    analyze: bool = True,
) -> List[bytes]:
    """Lossy bulk encode with auto-embedded analysis; quality u8 0-4."""
    return encode_lossy_many_async(
        samples_list, sample_rate, channels, quality, metadata_list,
        transport_dtype, analyze,
    ).result()


def decode_many_async(datas: Sequence[bytes]) -> BulkFuture:
    """Bulk auto-detecting decode: groups files into lossless/lossy batches
    (each group = one dispatched device pass); result() returns outputs in
    input order."""
    flos = [reader.read(d) for d in datas]
    is_lossy = [
        any(f.frame_type == int(FrameType.TRANSFORM) for f in flo.frames) for flo in flos
    ]
    outs: List[np.ndarray] = [np.zeros(0, np.float32)] * len(flos)
    ll = [i for i, v in enumerate(is_lossy) if not v]
    lo = [i for i, v in enumerate(is_lossy) if v]
    pending = []  # (indices, future)
    if ll:
        pending.append((ll, _lossless_decoder.decode_many_async([flos[i] for i in ll])))
    if lo:
        # Lossy bulk needs homogeneous rate/channels; sub-group accordingly.
        groups: dict = {}
        for i in lo:
            key = (flos[i].header.sample_rate, flos[i].header.channels)
            groups.setdefault(key, []).append(i)
        for idxs in groups.values():
            pending.append(
                (idxs, _lossy_decoder.decode_many_async([flos[i] for i in idxs]))
            )

    def fin() -> List[np.ndarray]:
        for idxs, fut in pending:
            for i, out in zip(idxs, fut.result()):
                outs[i] = out
        return outs

    return BulkFuture(fin)


def decode_many(datas: Sequence[bytes]) -> List[np.ndarray]:
    """Blocking form of decode_many_async."""
    return decode_many_async(datas).result()
