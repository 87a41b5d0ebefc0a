"""Native (C++) host finalizers with lazy g++ build and ctypes binding.

The device owns the array math; the container's serial bit/byte-level work
is the host hot path, implemented in C++ with OpenMP over independent streams:

- rice.cpp     — Rice bitstream pack/unpack (rice.rs equivalent)
- sparse.cpp   — lossy sparse RLE coefficient coder (encoder.rs:284-329)
- encode.cpp   — lossless best-of-N candidate search (encoder.rs:173-217 +
                 lpc.rs), the per-frame path for streaming encode
- analysis.cpp — BLAKE3 (parallel tree), K-weighting biquads, true-peak FIR
                 (analysis.rs / ebu_r128.rs hot loops, for bulk auto-embed)

Libraries are built from these sources at first use into ``_build/``, under
a name keyed by a hash of the source, the compiler flags and the host CPU's
model and feature flags, so a library built for another CPU is never loaded.
Falls back to the vectorized numpy implementations when no toolchain is
available, so importing never requires g++.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import platform
import subprocess
import threading

import numpy as np

_DIR = pathlib.Path(__file__).resolve().parent
_BUILD_DIR = _DIR / "_build"
_lock = threading.Lock()
_libs: dict = {}

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i16p = ctypes.POINTER(ctypes.c_int16)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_f64p = ctypes.POINTER(ctypes.c_double)
_f32p = ctypes.POINTER(ctypes.c_float)

_SIGNATURES = {
    "rice": {
        "rice_sizes": [_i32p, ctypes.c_int64, ctypes.c_int64, _i64p, _i32p, _i64p],
        "rice_encode_batch": [
            _i32p, ctypes.c_int64, ctypes.c_int64, _i64p, _i32p, _i64p, _u8p
        ],
        "rice_decode_batch": [
            _u8p, _i64p, _i64p, _i32p, _i64p, ctypes.c_int64, ctypes.c_int64, _i32p
        ],
        "lpc_reconstruct_batch": [
            _i32p, ctypes.c_int64, ctypes.c_int64, _i32p, _i32p, _i32p, _u8p, _i64p
        ],
    },
    "blockpack": {
        "blockpack_analyze": [
            _i32p, ctypes.c_int64, ctypes.c_int64, _i64p, ctypes.c_int64,
            _u8p, _u8p, _i64p,
        ],
        "blockpack_pack": [
            _i32p, ctypes.c_int64, ctypes.c_int64, _i64p, ctypes.c_int64,
            _u8p, _u8p, _i64p, _u8p,
        ],
        "blockpack_unpack": [
            _u8p, _i64p, _u8p, _u8p, ctypes.c_int64, ctypes.c_int64, _i64p,
            ctypes.c_int64, _i32p,
        ],
        "blockpack_unpack_f32": [
            _u8p, _i64p, _u8p, _u8p, ctypes.c_int64, ctypes.c_int64, _i64p,
            _i64p, ctypes.c_int64, ctypes.c_float, _f32p,
        ],
        "midside_interleave_f32": [
            _i32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _u8p,
            _i64p, ctypes.c_float, _f32p,
        ],
        "encode_marshal_f32": [
            _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, ctypes.c_float, _u8p, _i64p,
            _i32p,
        ],
        "lossy_marshal_f32": [
            _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int64, ctypes.c_float, _i32p,
        ],
    },
    "sparse": {
        "sparse_sizes": [_i16p, ctypes.c_int64, ctypes.c_int64, _i64p],
        "sparse_encode": [_i16p, ctypes.c_int64, ctypes.c_int64, _i64p, _u8p],
        "sparse_decode": [
            _u8p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _i16p
        ],
        "sparse_entry_counts": [
            _u8p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _i64p
        ],
        "sparse_decode_entries": [
            _u8p, _i64p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64, _i32p
        ],
        "sparse_sizes_csr": [
            _i32p, _i64p, _i32p, ctypes.c_int64, ctypes.c_int64, _i64p
        ],
        "sparse_encode_csr": [
            _i32p, _i64p, _i32p, ctypes.c_int64, ctypes.c_int64, _i64p, _u8p
        ],
    },
    "encode": {
        "lossless_search_batch": [
            _i32p, ctypes.c_int64, ctypes.c_int64, _i64p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _i32p, _i32p, _i32p, _i32p, _i32p, _i64p, _i32p,
        ],
    },
    "ingest": {
        # AAC/M4A ingest shim over the system libavformat/libavcodec
        # (ingest.cpp) — handle-based API, see flo_tpu/aac.py.
        "flo_ingest_decode": [_u8p, ctypes.c_int64],
        "flo_ingest_encode_aac": [
            _f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
        ],
        "flo_ingest_error": [ctypes.c_void_p],
        "flo_ingest_rate": [ctypes.c_void_p],
        "flo_ingest_channels": [ctypes.c_void_p],
        "flo_ingest_nsamples": [ctypes.c_void_p],
        "flo_ingest_samples": [ctypes.c_void_p, _f32p],
        "flo_ingest_ntags": [ctypes.c_void_p],
        "flo_ingest_tag_key": [ctypes.c_void_p, ctypes.c_int],
        "flo_ingest_tag_val": [ctypes.c_void_p, ctypes.c_int],
        "flo_ingest_cover_size": [ctypes.c_void_p],
        "flo_ingest_cover_mime": [ctypes.c_void_p],
        "flo_ingest_cover": [ctypes.c_void_p, _u8p],
        "flo_ingest_bytes_size": [ctypes.c_void_p],
        "flo_ingest_bytes": [ctypes.c_void_p, _u8p],
        "flo_ingest_free": [ctypes.c_void_p],
    },
    "analysis": {
        "blake3_digest": [_u8p, ctypes.c_int64, _u8p],
        "kweight_cascade": [_f64p, ctypes.c_int64, ctypes.c_int64, _f64p],
        "fir_absmax": [
            _f64p, ctypes.c_int64, ctypes.c_int64, _f64p, ctypes.c_int64,
            ctypes.c_int64, _f64p,
        ],
        "loudness_pass": [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f64p, _f64p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _f64p, _f64p,
        ],
        "sumsq_f32": [_f32p, ctypes.c_int64],
    },
}

#: fn -> ctypes restype for non-void natives (ctypes defaults to c_int).
_RESTYPES = {
    "sumsq_f32": ctypes.c_double,
    "flo_ingest_decode": ctypes.c_void_p,
    "flo_ingest_encode_aac": ctypes.c_void_p,
    "flo_ingest_error": ctypes.c_char_p,
    "flo_ingest_nsamples": ctypes.c_int64,
    "flo_ingest_tag_key": ctypes.c_char_p,
    "flo_ingest_tag_val": ctypes.c_char_p,
    "flo_ingest_cover_size": ctypes.c_int64,
    "flo_ingest_cover_mime": ctypes.c_char_p,
    "flo_ingest_bytes_size": ctypes.c_int64,
}

#: module -> extra g++ flags (system libraries the shim links against).
_LINK_FLAGS = {
    "ingest": ["-lavformat", "-lavcodec", "-lavutil"],
}


#: Compiler invocations, best first, as (flags before the source, libraries
#: after it); each gets its own cache key.
_COMPILERS = (
    (("g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"), ()),
    (("g++", "-O3", "-shared", "-fPIC"), ()),
    (("cc", "-O2", "-shared", "-fPIC", "-x", "c++"), ("-lstdc++",)),
)


def _host_id() -> str:
    """The host CPU's model and feature flags: what -march=native compiles for."""
    try:
        with open("/proc/cpuinfo") as f:
            lines = f.read().split("\n\n", 1)[0].splitlines()
        keep = [ln for ln in lines if ln.split(":")[0].strip() in
                ("vendor_id", "cpu family", "model", "model name", "flags", "Features")]
        return "\n".join(keep)
    except OSError:
        return f"{platform.machine()} {platform.processor()}"


def _so_path(src: pathlib.Path, cmd: tuple, link: tuple) -> pathlib.Path:
    key = hashlib.sha256()
    for part in (src.read_bytes(), repr((cmd, link)).encode(), _host_id().encode()):
        key.update(part)
        key.update(b"\0")
    return _BUILD_DIR / f"_lib{src.stem}-{key.hexdigest()[:16]}.so"


def _build(src: pathlib.Path, cmd: tuple, link: tuple, out: pathlib.Path) -> bool:
    """Compile into a private temporary name, then rename: concurrent
    processes never load a half-written library."""
    _BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        res = subprocess.run(
            [*cmd, str(src), "-o", str(tmp), *link], capture_output=True, timeout=120
        )
        if res.returncode != 0 or not tmp.exists():
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        tmp.unlink(missing_ok=True)


def _library_path(name: str) -> pathlib.Path | None:
    """Path of a library built from the committed source for this host,
    building it on first use; None when no compiler succeeds."""
    src = _DIR / f"{name}.cpp"
    for cmd, libs in _COMPILERS:
        link = (*libs, *_LINK_FLAGS.get(name, ()))
        so = _so_path(src, cmd, link)
        if so.exists() or _build(src, cmd, link, so):
            return so
    return None


def _load(name: str):
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        try:
            so = _library_path(name)
            if so is not None:
                lib = ctypes.CDLL(str(so))
                for fn, argtypes in _SIGNATURES[name].items():
                    getattr(lib, fn).argtypes = argtypes
                    if fn in _RESTYPES:
                        getattr(lib, fn).restype = _RESTYPES[fn]
        except OSError:
            lib = None
        _libs[name] = lib
        return lib


def available() -> bool:
    return _load("rice") is not None


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


# ---------------- Rice ----------------


def rice_encode_batch(rows: np.ndarray, ks: np.ndarray, lengths: np.ndarray):
    """C++ batch Rice pack; returns list of per-stream bytes or None."""
    lib = _load("rice")
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    n, stride = rows.shape
    ks = np.ascontiguousarray(ks, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    sizes = np.empty(n, dtype=np.int64)
    lib.rice_sizes(
        _ptr(rows, ctypes.c_int32), n, stride,
        _ptr(lengths, ctypes.c_int64), _ptr(ks, ctypes.c_int32),
        _ptr(sizes, ctypes.c_int64),
    )
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    total = int(offsets[-1] + sizes[-1]) if n else 0
    out = np.zeros(total, dtype=np.uint8)
    if total:
        lib.rice_encode_batch(
            _ptr(rows, ctypes.c_int32), n, stride,
            _ptr(lengths, ctypes.c_int64), _ptr(ks, ctypes.c_int32),
            _ptr(offsets, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
        )
    buf = out.tobytes()
    return [buf[int(offsets[i]) : int(offsets[i] + sizes[i])] for i in range(n)]


def rice_encode_into(rows, ks, lengths, byte_offsets, out: np.ndarray) -> bool:
    """C++ batch Rice pack at caller-chosen byte offsets into ``out``
    (upload transport path). Returns False if the native lib is missing."""
    lib = _load("rice")
    if lib is None:
        return False
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    n, stride = rows.shape
    if n == 0:
        return True
    ks = np.ascontiguousarray(ks, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    byte_offsets = np.ascontiguousarray(byte_offsets, dtype=np.int64)
    lib.rice_encode_batch(
        _ptr(rows, ctypes.c_int32), n, stride,
        _ptr(lengths, ctypes.c_int64), _ptr(ks, ctypes.c_int32),
        _ptr(byte_offsets, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
    )
    return True


def lpc_reconstruct_into(rows: np.ndarray, coeffs, shifts, orders, is_fixed,
                         lengths) -> bool:
    """C++ in-place LPC/fixed reconstruction over [L, S] int32 residual rows
    (decoder.rs:92-273 semantics — i64 MAC >> shift, int32 wrap, fixed-lane
    warm-up ramp). The host half of the streaming/seeking single-frame decode
    path, where a per-frame device round trip would be pure latency.
    Returns False if the native lib is missing (callers fall back to the
    jitted scan)."""
    lib = _load("rice")
    if lib is None or not hasattr(lib, "lpc_reconstruct_batch"):
        return False
    assert rows.dtype == np.int32 and rows.flags.c_contiguous
    n, stride = rows.shape
    if n == 0:
        return True
    coeffs = np.ascontiguousarray(coeffs, dtype=np.int32)
    assert coeffs.shape == (n, 12)  # ops/lpc.MAX_ORDER, hardcoded in the C++
    shifts = np.ascontiguousarray(shifts, dtype=np.int32)
    orders = np.ascontiguousarray(orders, dtype=np.int32)
    fx = np.ascontiguousarray(np.asarray(is_fixed), dtype=np.uint8)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    lib.lpc_reconstruct_batch(
        _ptr(rows, ctypes.c_int32), n, stride,
        _ptr(coeffs, ctypes.c_int32), _ptr(shifts, ctypes.c_int32),
        _ptr(orders, ctypes.c_int32), _ptr(fx, ctypes.c_uint8),
        _ptr(lengths, ctypes.c_int64),
    )
    return True


def rice_decode_batch(blobs, ks, lengths, out_width: int):
    """C++ batch Rice unpack into [n, out_width] int32, or None."""
    n = len(blobs)
    blob_lens = np.array([len(b) for b in blobs], dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(blob_lens[:-1], out=offsets[1:])
    cat = np.frombuffer(b"".join(blobs), dtype=np.uint8) if n else np.zeros(0, np.uint8)
    return rice_decode_concat(cat, offsets, blob_lens, ks, lengths, out_width)


def rice_decode_concat(cat, offsets, blob_lens, ks, lengths, out_width: int):
    """rice_decode_batch over an already-concatenated byte buffer (skips the
    per-blob split/join — the decode hot paths hold (buffer, offsets))."""
    lib = _load("rice")
    if lib is None:
        return None
    n = len(offsets)
    cat = np.ascontiguousarray(cat, dtype=np.uint8)
    if cat.size == 0:
        cat = np.zeros(1, dtype=np.uint8)  # valid pointer for empty input
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    blob_lens = np.ascontiguousarray(blob_lens, dtype=np.int64)
    ks = np.ascontiguousarray(ks, dtype=np.int32)
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    out = np.zeros((n, out_width), dtype=np.int32)
    if n:
        lib.rice_decode_batch(
            _ptr(cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            _ptr(blob_lens, ctypes.c_int64), _ptr(ks, ctypes.c_int32),
            _ptr(lengths, ctypes.c_int64), n, out_width,
            _ptr(out, ctypes.c_int32),
        )
    return out


# ---------------- Blockpack wire transport ----------------


def blockpack_analyze(rows: np.ndarray, nvalid: np.ndarray, nblk: int):
    """C++ mode/width/size analysis; (modes, widths, lane_bytes) or None."""
    lib = _load("blockpack")
    if lib is None:
        return None
    L, stride = rows.shape
    modes = np.zeros(L, np.uint8)
    widths = np.zeros((L, nblk), np.uint8)
    lane_bytes = np.zeros(L, np.int64)
    if L:
        lib.blockpack_analyze(
            _ptr(rows, ctypes.c_int32), L, stride, _ptr(nvalid, ctypes.c_int64),
            nblk, _ptr(modes, ctypes.c_uint8), _ptr(widths, ctypes.c_uint8),
            _ptr(lane_bytes, ctypes.c_int64),
        )
    return modes, widths, lane_bytes


def blockpack_pack(rows, nvalid, nblk, modes, widths, lane_off, out) -> bool:
    """C++ pack into ``out`` at lane_off; False if the lib is missing."""
    lib = _load("blockpack")
    if lib is None:
        return False
    L, stride = rows.shape
    if L:
        lib.blockpack_pack(
            _ptr(rows, ctypes.c_int32), L, stride, _ptr(nvalid, ctypes.c_int64),
            nblk, _ptr(modes, ctypes.c_uint8), _ptr(widths, ctypes.c_uint8),
            _ptr(lane_off, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
        )
    return True


def blockpack_unpack(buf, lane_off, modes, widths, nvalid, S: int):
    """C++ unpack -> [L, S] int32 rows, or None."""
    lib = _load("blockpack")
    if lib is None:
        return None
    L, nblk = widths.shape
    out = np.zeros((L, S), np.int32)
    if L:
        lib.blockpack_unpack(
            _ptr(buf, ctypes.c_uint8), _ptr(lane_off, ctypes.c_int64),
            _ptr(modes, ctypes.c_uint8), _ptr(widths, ctypes.c_uint8),
            L, nblk, _ptr(nvalid, ctypes.c_int64), S,
            _ptr(out, ctypes.c_int32),
        )
    return out


def blockpack_unpack_f32(
    buf, lane_off, modes, widths, nvalid, out_base, out_step: int,
    scale: float, out: np.ndarray,
) -> bool:
    """Fused decode finalizer for the BIT-PLANE stream (the pack_host /
    pack_rows_stage* wire format): parse + i32->f32 + strided interleave in
    one pass — lane l's sample j at ``out[out_base[l] + j*out_step]``,
    scaled by ``scale``; ``out_base < 0`` skips the lane. Returns False
    when the native lib is unavailable (caller takes the numpy path)."""
    lib = _load("blockpack")
    if lib is None or not hasattr(lib, "blockpack_unpack_f32"):
        return False
    L, nblk = widths.shape
    assert out.dtype == np.float32 and out.flags.c_contiguous
    if L:
        lib.blockpack_unpack_f32(
            _ptr(buf, ctypes.c_uint8), _ptr(lane_off, ctypes.c_int64),
            _ptr(modes, ctypes.c_uint8), _ptr(widths, ctypes.c_uint8),
            L, nblk, _ptr(nvalid, ctypes.c_int64),
            _ptr(out_base, ctypes.c_int64), out_step,
            ctypes.c_float(scale), _ptr(out, ctypes.c_float),
        )
    return True


def midside_interleave_f32(rows, mid_side, frame_lengths, channels: int,
                           scale: float):
    """Single-file decode finalizer: mid/side undo + interleave + i32->f32
    in one C++ pass over reconstructed rows [F*C, S]. Returns the flat f32
    array, or None when the native lib is unavailable."""
    lib = _load("blockpack")
    if lib is None or not hasattr(lib, "midside_interleave_f32"):
        return None
    rows = np.ascontiguousarray(rows, np.int32)
    FC, S = rows.shape
    F = FC // max(channels, 1)
    mid_side = np.ascontiguousarray(mid_side, np.uint8)
    frame_lengths = np.ascontiguousarray(frame_lengths, np.int64)
    out = np.empty(int(frame_lengths.sum()) * channels, np.float32)
    if F:
        lib.midside_interleave_f32(
            _ptr(rows, ctypes.c_int32), F, channels, S,
            _ptr(mid_side, ctypes.c_uint8),
            _ptr(frame_lengths, ctypes.c_int64),
            ctypes.c_float(scale), _ptr(out, ctypes.c_float),
        )
    return out


def lossy_marshal_f32(flat, n: int, C: int, hop: int, scale: float,
                      rows: np.ndarray) -> bool:
    """One file's interleaved f32 -> pre-rolled i32 channel rows
    ([C, stride], pre-zeroed) in one pass: sample j of channel c at
    rows[c, hop+j] = clamp(rint(x*scale)). Returns False when the native
    lib is unavailable."""
    lib = _load("blockpack")
    if lib is None or not hasattr(lib, "lossy_marshal_f32"):
        return False
    assert flat.dtype == np.float32 and flat.flags.c_contiguous
    assert rows.dtype == np.int32 and rows.flags.c_contiguous
    if n:
        lib.lossy_marshal_f32(
            _ptr(flat, ctypes.c_float), n, C, hop, rows.shape[1],
            ctypes.c_float(scale), _ptr(rows, ctypes.c_int32),
        )
    return True


def encode_marshal_f32(flat, total: int, C: int, spf: int, thresh: float,
                       scale: float, lanes: np.ndarray, row0: int):
    """Bulk-encode marshal: interleaved f32 [total, C] -> compacted
    lane-major i32 frames written at ``lanes[row0:]`` in one pass, silence
    detection included. Returns (n_active, silent[F] bool,
    active_idx[n_active]) or None when the native lib is unavailable."""
    lib = _load("blockpack")
    if lib is None or not hasattr(lib, "encode_marshal_f32"):
        return None
    lib.encode_marshal_f32.restype = ctypes.c_int64
    F = -(-total // spf) if total else 0
    assert flat.dtype == np.float32 and flat.flags.c_contiguous
    assert lanes.dtype == np.int32 and lanes.flags.c_contiguous
    silent = np.zeros(F, np.uint8)
    active_idx = np.zeros(F, np.int64)
    n_active = 0
    if F:
        n_active = lib.encode_marshal_f32(
            _ptr(flat, ctypes.c_float), total, C, spf, F,
            ctypes.c_float(thresh), ctypes.c_float(scale),
            _ptr(silent, ctypes.c_uint8), _ptr(active_idx, ctypes.c_int64),
            _ptr(lanes[row0:], ctypes.c_int32),
        )
    return int(n_active), silent.astype(bool), active_idx[:n_active]


# ---------------- Sparse RLE ----------------


def sparse_encode_batch(rows: np.ndarray):
    """C++ sparse RLE over [n, width] i16 rows -> list of bytes, or None."""
    lib = _load("sparse")
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int16)
    n, width = rows.shape
    sizes = np.empty(n, dtype=np.int64)
    lib.sparse_sizes(_ptr(rows, ctypes.c_int16), n, width, _ptr(sizes, ctypes.c_int64))
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    total = int(offsets[-1] + sizes[-1]) if n else 0
    out = np.zeros(max(total, 1), dtype=np.uint8)
    if n:
        lib.sparse_encode(
            _ptr(rows, ctypes.c_int16), n, width,
            _ptr(offsets, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
        )
    buf = out.tobytes()
    return [buf[int(offsets[i]) : int(offsets[i] + sizes[i])] for i in range(n)]


def sparse_encode_entries_csr(entries: np.ndarray, row_nnz: np.ndarray,
                              width: int):
    """C++ sparse RLE straight from sorted (col<<16|val) entries.

    entries: [total] i32, row-major (row r owns the slice starting at
    cumsum(row_nnz)[r-1], cols strictly ascending within a row — the device
    compaction's output order, ops/compact.py); row_nnz: [n] int. Emits
    byte-identical streams to sparse_encode_batch on the equivalent dense
    rows without ever materializing them. Returns list[bytes] or None.
    """
    lib = _load("sparse")
    if lib is None:
        return None
    entries = np.ascontiguousarray(entries, dtype=np.int32)
    row_nnz = np.ascontiguousarray(row_nnz, dtype=np.int32)
    n = len(row_nnz)
    row_off = np.zeros(n, dtype=np.int64)
    np.cumsum(row_nnz[:-1], dtype=np.int64, out=row_off[1:])
    if entries.size == 0:
        entries = np.zeros(1, dtype=np.int32)  # valid base pointer
    sizes = np.empty(n, dtype=np.int64)
    lib.sparse_sizes_csr(
        _ptr(entries, ctypes.c_int32), _ptr(row_off, ctypes.c_int64),
        _ptr(row_nnz, ctypes.c_int32), n, width, _ptr(sizes, ctypes.c_int64),
    )
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(sizes[:-1], out=offsets[1:])
    total = int(offsets[-1] + sizes[-1]) if n else 0
    out = np.zeros(max(total, 1), dtype=np.uint8)
    if n:
        lib.sparse_encode_csr(
            _ptr(entries, ctypes.c_int32), _ptr(row_off, ctypes.c_int64),
            _ptr(row_nnz, ctypes.c_int32), n, width,
            _ptr(offsets, ctypes.c_int64), _ptr(out, ctypes.c_uint8),
        )
    buf = out.tobytes()
    return [buf[int(offsets[i]) : int(offsets[i] + sizes[i])] for i in range(n)]


def sparse_decode_batch(blobs, width: int):
    """C++ sparse RLE decode -> [n, width] i16, or None."""
    lib = _load("sparse")
    if lib is None:
        return None
    n = len(blobs)
    lens = np.array([len(b) for b in blobs], dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    cat = np.frombuffer(b"".join(blobs), dtype=np.uint8) if n else np.zeros(0, np.uint8)
    cat = np.ascontiguousarray(cat)
    if cat.size == 0:
        cat = np.zeros(1, dtype=np.uint8)
    out = np.zeros((n, width), dtype=np.int16)
    if n:
        lib.sparse_decode(
            _ptr(cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            _ptr(lens, ctypes.c_int64), n, width, _ptr(out, ctypes.c_int16),
        )
    return out


# ---------------- Analysis ----------------


def blake3_digest(data) -> bytes | None:
    """C++ parallel BLAKE3 (32-byte digest), or None without a toolchain."""
    lib = _load("analysis")
    if lib is None:
        return None
    if isinstance(data, np.ndarray):
        buf = np.ascontiguousarray(data).reshape(-1).view(np.uint8)
    else:
        buf = np.frombuffer(data, dtype=np.uint8)  # zero-copy on bytes
    if buf.size == 0:
        buf = np.zeros(1, dtype=np.uint8)
        n = 0
    else:
        n = buf.size
    out = np.zeros(32, dtype=np.uint8)
    lib.blake3_digest(_ptr(buf, ctypes.c_uint8), n, _ptr(out, ctypes.c_uint8))
    return out.tobytes()


def kweight_cascade(x: np.ndarray, coefs: np.ndarray):
    """In-place K-weighting over [lanes, n] f64 rows, or None."""
    lib = _load("analysis")
    if lib is None:
        return None
    assert x.dtype == np.float64 and x.flags.c_contiguous
    coefs = np.ascontiguousarray(coefs, dtype=np.float64)
    lanes, n = x.shape
    lib.kweight_cascade(
        _ptr(x, ctypes.c_double), lanes, n, _ptr(coefs, ctypes.c_double)
    )
    return x


def fir_absmax(x: np.ndarray, h: np.ndarray, center: int):
    """Per-lane max|conv(x, h)| over [lanes, n] f64 rows, or None."""
    lib = _load("analysis")
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float64)
    h = np.ascontiguousarray(h, dtype=np.float64)
    lanes, n = x.shape
    out = np.zeros(lanes, dtype=np.float64)
    lib.fir_absmax(
        _ptr(x, ctypes.c_double), lanes, n, _ptr(h, ctypes.c_double),
        len(h), center, _ptr(out, ctypes.c_double),
    )
    return out


def loudness_pass(interleaved: np.ndarray, channels: int, cf: np.ndarray,
                  h: np.ndarray, center: int, hop: int):
    """Fused EBU R128 prep: (seg_energy_sums, true_peak, sample_peak) or None.

    interleaved: f32 [n*C]; returns (seg f64 [n//hop + 1] summed over
    channels — element [n//hop] is the partial tail — tp_linear,
    sample_peak_linear).
    """
    lib = _load("analysis")
    if lib is None:
        return None
    x = np.ascontiguousarray(interleaved, dtype=np.float32)
    C = max(int(channels), 1)
    n = x.size // C
    nseg = n // hop if hop > 0 else 0
    seg = np.zeros(nseg + 1, dtype=np.float64)
    peaks = np.zeros(2, dtype=np.float64)
    cf = np.ascontiguousarray(cf, dtype=np.float64)
    h = np.ascontiguousarray(h, dtype=np.float64)
    lib.loudness_pass(
        _ptr(x, ctypes.c_float), n, C, _ptr(cf, ctypes.c_double),
        _ptr(h, ctypes.c_double), len(h), center, hop,
        _ptr(seg, ctypes.c_double), _ptr(peaks, ctypes.c_double),
    )
    return seg, float(peaks[0]), float(peaks[1])


def sumsq_f32(x: np.ndarray):
    """f64-accumulated sum of squares of an f32 array, or None."""
    lib = _load("analysis")
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32).reshape(-1)
    if x.size == 0:
        return 0.0
    return float(lib.sumsq_f32(_ptr(x, ctypes.c_float), x.size))


def sparse_decode_entries(blobs, width: int):
    """C++ sparse RLE -> row-major (col<<16 | i16 value) int32 entries.

    Returns (entries int32 [total_nnz], stream_nnz int64 [n]) or None.
    Zero VALUES inside nonzero runs are dropped, matching dense+np.nonzero.
    """
    lib = _load("sparse")
    if lib is None or not hasattr(lib, "sparse_entry_counts"):
        return None
    n = len(blobs)
    lens = np.array([len(b) for b in blobs], dtype=np.int64)
    offsets = np.zeros(n, dtype=np.int64)
    np.cumsum(lens[:-1], out=offsets[1:])
    cat = np.frombuffer(b"".join(blobs), dtype=np.uint8) if n else np.zeros(0, np.uint8)
    cat = np.ascontiguousarray(cat)
    if cat.size == 0:
        cat = np.zeros(1, dtype=np.uint8)
    counts = np.zeros(n, dtype=np.int64)
    if n:
        lib.sparse_entry_counts(
            _ptr(cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            _ptr(lens, ctypes.c_int64), n, width, _ptr(counts, ctypes.c_int64),
        )
    entry_off = np.zeros(n, dtype=np.int64)
    np.cumsum(counts[:-1], out=entry_off[1:])
    total = int(entry_off[-1] + counts[-1]) if n else 0
    entries = np.zeros(max(total, 1), dtype=np.int32)
    if n:
        lib.sparse_decode_entries(
            _ptr(cat, ctypes.c_uint8), _ptr(offsets, ctypes.c_int64),
            _ptr(lens, ctypes.c_int64), _ptr(entry_off, ctypes.c_int64),
            n, width, _ptr(entries, ctypes.c_int32),
        )
    return entries[:total], counts


def lossless_search_batch(lanes: np.ndarray, nvalid: np.ndarray,
                          max_order: int, use_lpc: bool,
                          prune_lpc: int = 0):
    """C++ per-lane best-of-N candidate search (encoder.rs:173-217 + lpc.rs).

    lanes: [L, S] int32 (mid/side domain); nvalid: [L] int64. Returns
    (sel_kind [L] 0=raw/1=fixed/2=lpc, sel_order, k, coeffs [L,12], shift,
    size_bytes [L] i64, residuals [L, S] i32) or None without a toolchain.

    prune_lpc=0 evaluates the full LPC order set (byte parity with the
    reference search); K>0 evaluates only the K best PREDICTED orders from
    the Levinson prediction error (see encode.cpp) — the streaming
    encoder's latency knob, never used where byte parity is asserted.
    """
    lib = _load("encode")
    if lib is None:
        return None
    lanes = np.ascontiguousarray(lanes, dtype=np.int32)
    L, S = lanes.shape
    nvalid = np.ascontiguousarray(nvalid, dtype=np.int64)
    sel_kind = np.zeros(L, np.int32)
    sel_order = np.zeros(L, np.int32)
    k = np.zeros(L, np.int32)
    coeffs = np.zeros((L, 12), np.int32)
    shift = np.zeros(L, np.int32)
    size = np.zeros(L, np.int64)
    residuals = np.zeros((L, S), np.int32)
    if L:
        lib.lossless_search_batch(
            _ptr(lanes, ctypes.c_int32), L, S, _ptr(nvalid, ctypes.c_int64),
            int(max_order), int(bool(use_lpc)), int(prune_lpc),
            _ptr(sel_kind, ctypes.c_int32), _ptr(sel_order, ctypes.c_int32),
            _ptr(k, ctypes.c_int32), _ptr(coeffs, ctypes.c_int32),
            _ptr(shift, ctypes.c_int32), _ptr(size, ctypes.c_int64),
            _ptr(residuals, ctypes.c_int32),
        )
    return sel_kind, sel_order, k, coeffs, shift, size, residuals
