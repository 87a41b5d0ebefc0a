"""Lossless decoder: C++ Rice parse -> block-packed wire -> batched device scan.

Pipeline (mirrors the behavior of lossless/decoder.rs:21-273, redesigned
batch-first):

1. Classify every (frame, channel) into a *lane* with uniform parameters
   (residual row, 12 coefficient taps, shift, warm-up order, fixed flag) so a
   single universal program handles LPC/fixed/raw/silence.
2. The container's Rice streams are parsed on the host by the C++ batch
   decoder (native/rice.cpp) — exact under ANY quotient or truncation, the
   reference's zero-fill semantics, so no escape paths exist anywhere.
3. Residual lanes cross the wire block-packed (ops/blockpack — compressed
   size, scan-free device unpack); one reconstruction over [lanes, samples]
   (ops/lpc.reconstruct_best: the Triton kernel on the GPU) reconstructs
   everything at once; mid/side undo and the block-packed PCM DOWNLOAD
   transport are fused into the same jit.
4. Host C++ unpacks the download, trims per-frame tails, and interleaves.
   (An earlier iteration decoded the container's Rice blobs ON device via a
   leading-ones scan; measured on real hardware the 44100-step scan plus the
   per-lane big-quotient escapes cost far more than the C++ parse — one
   transient per frame is enough to overflow any fixed device window, since
   rice.rs:29-69 legally emits 271-bit codes.)
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..container import reader
from ..core import rice_host
from ..futures import BulkFuture, start_host_copy
from ..ops import blockpack
from ..core.constants import (
    FIXED_PREDICTOR_MARKER,
    FrameType,
    ResidualEncoding,
)
from ..core.types import FloFile
from ..ops import lpc
from ..ops.intmath import div2_trunc


def _marshal_lanes(flo: FloFile):
    """Build per-lane arrays from a parsed file.

    Returns (residual_rows [L,S], coeffs [L,12], shifts [L], orders [L],
    is_fixed [L], mid_side [F] bool, S, frame_lengths [F]).
    Lane order is frame-major, channel-minor.
    """
    channels = flo.header.channels
    frames = [f for f in flo.frames if not FrameType.from_byte(f.frame_type).is_transform]
    F = len(frames)
    if F == 0:
        return None
    S = max(f.frame_samples for f in frames)
    L = F * channels

    rows = np.zeros((L, S), dtype=np.int32)
    coeffs = np.zeros((L, lpc.MAX_ORDER), dtype=np.int32)
    shifts = np.zeros(L, dtype=np.int32)
    orders = np.zeros(L, dtype=np.int32)
    is_fixed = np.zeros(L, dtype=bool)
    mid_side = np.zeros(F, dtype=bool)
    frame_lengths = np.zeros(F, dtype=np.int64)

    # Defer rice decodes so they run as one vectorized batch.
    rice_jobs = []  # (lane, blob, k, n)

    for fi, frame in enumerate(frames):
        n = frame.frame_samples
        frame_lengths[fi] = n
        mid_side[fi] = channels == 2 and bool(frame.flags & 0x01)
        for ci in range(channels):
            lane = fi * channels + ci
            ch = frame.channels[ci] if ci < len(frame.channels) else None
            if ch is None:
                continue
            has_coeffs = len(ch.predictor_coeffs) > 0
            has_residuals = len(ch.residuals) > 0
            # Classification order mirrors decoder.rs:92-148.
            if not has_coeffs and has_residuals and ch.shift_bits >= FIXED_PREDICTOR_MARKER:
                order = ch.shift_bits - FIXED_PREDICTOR_MARKER
                rice_jobs.append((lane, ch.residuals, ch.rice_parameter, n))
                if order <= 4:
                    is_fixed[lane] = True
                    orders[lane] = order
                    coeffs[lane, :] = lpc._FIXED_COEFFS[order]
                # order > 4: unknown fixed order -> samples = residuals verbatim
                # (decoder.rs:261-264): zero coeffs, order 0 already set.
            elif has_coeffs:
                order = len(ch.predictor_coeffs)
                rice_jobs.append((lane, ch.residuals, ch.rice_parameter, n))
                coeffs[lane, :order] = np.asarray(ch.predictor_coeffs, dtype=np.int64).astype(
                    np.int32
                )
                shifts[lane] = min(int(ch.shift_bits), 15)
                orders[lane] = order
            elif has_residuals:
                # Raw i16 PCM (decoder.rs:132-144); whole i16 pairs only.
                raw = np.frombuffer(
                    ch.residuals[: (len(ch.residuals) // 2) * 2], dtype="<i2"
                ).astype(np.int32)
                m = min(len(raw), n)
                rows[lane, :m] = raw[:m]
            # else: silence -> zeros already.

    if rice_jobs:
        job_lanes = np.array([j[0] for j in rice_jobs])
        job_ks = np.array([j[2] for j in rice_jobs], dtype=np.int32)
        job_ns = np.array([j[3] for j in rice_jobs], dtype=np.int64)
        decoded = rice_host.decode_batch(
            [j[1] for j in rice_jobs], job_ks, job_ns, S
        )
        rows[job_lanes] = decoded

    return rows, coeffs, shifts, orders, is_fixed, mid_side, S, frame_lengths


@partial(jax.jit, static_argnames=("channels",))
def _device_decode(rows, coeffs, shifts, orders, is_fixed, mid_side, channels: int):
    """Reconstruct + mid/side undo + f32 conversion, fully on device.

    rows: [F*C, S] -> returns [F, S, C] float32 (interleave-ready).
    """
    samples = lpc.reconstruct(rows, coeffs, shifts, orders, is_fixed)
    S = samples.shape[1]
    fcs = samples.reshape(-1, channels, S)
    if channels == 2:
        m, s = fcs[:, 0], fcs[:, 1]
        left = div2_trunc(m + s)
        right = div2_trunc(m - s)
        ms = mid_side[:, None]
        fcs = jnp.stack(
            [jnp.where(ms, left, m), jnp.where(ms, right, s)], axis=1
        )
    f32 = fcs.astype(jnp.float32) * jnp.float32(1.0 / 32767.0)
    return jnp.transpose(f32, (0, 2, 1))


def _bucket_bytes(n: int, floor: int = 1 << 20) -> int:
    """Upload-buffer bucket: {1, 1.5} x 2^k growth bounds both the zero
    padding (<= 33%) and the number of distinct compiled shapes."""
    from ..buckets import grow_bucket

    return grow_bucket(n, floor)


def decode_file(flo: FloFile) -> np.ndarray:
    """Decode a parsed lossless file to interleaved float32 samples."""
    return decode_many([flo])[0]


def decode(data: bytes) -> np.ndarray:
    """Decode flo bytes to interleaved float32 samples (lossless path)."""
    return decode_file(reader.read(data))


@partial(jax.jit, static_argnames=("channels", "S", "up_kmax", "mesh"))
def _decode_lanes_bp(buf, up_modes, up_widths, up_off, coeffs, shifts,
                     orders, is_fixed, mid_side, lane_nvalid,
                     channels: int, S: int, up_kmax: int = 4, mesh=None):
    """Block-packed decode step: residual lanes in AND reconstructed PCM
    out through the bit-plane blockpack transport (compressed-size payloads,
    no per-code indexed ops in either direction — one 8-word-row scatter
    per upload plane unit, one row gather per download unit). The download
    pack runs fused at the PCM worst-case bucket (pack_rows_fused), so no
    size download sits on the device stream between phases. The only
    sequential device work left is the reconstruction recurrence itself."""
    rows = blockpack.unpack_rows(
        buf, up_modes, up_widths, up_off, lane_nvalid, S, kmax=up_kmax
    )
    samples = lpc.reconstruct_best(rows, coeffs, shifts, orders, is_fixed, mesh=mesh)
    fcs = samples.reshape(-1, channels, S)
    if channels == 2:
        m, s = fcs[:, 0], fcs[:, 1]
        left = div2_trunc(m + s)
        right = div2_trunc(m - s)
        ms = mid_side[:, None]
        fcs = jnp.stack([jnp.where(ms, left, m), jnp.where(ms, right, s)], axis=1)
    lanes = fcs.reshape(-1, S)
    return blockpack.pack_rows_fused(lanes, lane_nvalid)


def decode_many_async(flos: list[FloFile], mesh=None) -> BulkFuture:
    """Bulk decode: every file's lanes in one reconstruction scan per channel
    count. The container's Rice streams are parsed by the C++ host decoder
    (exact under ANY quotient or truncation — the reference's zero-fill
    semantics, rice.rs:128-131 — so no per-lane escape paths exist); both
    wire directions then carry block-packed compressed-size payloads
    (ops/blockpack). All device work is dispatched before this returns.

    mesh: optional `jax.sharding.Mesh` (or ambient `parallel.use_mesh`) —
    chunks pad their frame axis to a mesh multiple and run the same jitted
    program GSPMD-sharded over the 'batch' axis; outputs are identical."""
    from ..core.convert import i32_to_f32_np
    from ..parallel import pipeline as _pp

    mesh = _pp.active_mesh(mesh)

    marshaled = [(_marshal_lanes(f), f.header.channels) for f in flos]
    outs: list[np.ndarray] = [np.zeros(0, dtype=np.float32)] * len(flos)
    by_channels: dict[int, list] = {}
    for i, (m, c) in enumerate(marshaled):
        if m is not None:
            by_channels.setdefault(c, []).append((i, m))

    collectors = []
    for channels, group in by_channels.items():
        S_max = max(m[6] for _, m in group)
        L_tot = sum(m[0].shape[0] for _, m in group)
        rows = np.zeros((L_tot, S_max), dtype=np.int32)
        coeffs = np.zeros((L_tot, lpc.MAX_ORDER), np.int32)
        shifts = np.zeros(L_tot, np.int32)
        orders = np.zeros(L_tot, np.int32)
        is_fixed = np.zeros(L_tot, bool)
        mid_side_all = []
        off = 0
        for _, m in group:
            r = m[0]
            rows[off : off + r.shape[0], : r.shape[1]] = r
            coeffs[off : off + r.shape[0]] = m[1]
            shifts[off : off + r.shape[0]] = m[2]
            orders[off : off + r.shape[0]] = m[3]
            is_fixed[off : off + r.shape[0]] = m[4]
            mid_side_all.append(m[5])
            off += r.shape[0]
        mid_side = np.concatenate(mid_side_all)
        frame_lengths_all = np.concatenate([m[7] for _, m in group]).astype(np.int32)
        lane_nvalid = np.repeat(frame_lengths_all, channels)

        # Double-buffer over two frame sub-batches: chunk B's host pack +
        # upload overlap chunk A's device compute + download.
        F_tot = L_tot // channels
        f_half = F_tot // 2 if F_tot >= 4 else F_tot
        # Keep each chunk under the device packer's int32 bit-index bound
        # (blockpack.MAX_PACK_SAMPLES; the download transport packs
        # channels * S_max padded samples per frame).
        spad_f = channels * blockpack.nblocks(S_max) * blockpack.BLK
        f_half = max(1, min(f_half, blockpack.MAX_PACK_SAMPLES // max(spad_f, 1)))

        def dispatch(flo_f, fhi_f):
            lo, hi = flo_f * channels, fhi_f * channels
            buf, up_modes, up_widths, up_off = blockpack.pack_host(
                rows[lo:hi], lane_nvalid[lo:hi].astype(np.int64)
            )
            payload_end = len(buf) - blockpack.PAD_BYTES
            nb = _bucket_bytes(len(buf))
            if nb != len(buf):
                buf = np.concatenate([buf, np.zeros(nb - len(buf), np.uint8)])
            # Mesh padding: inert zero lanes (nvalid=0) at the frame tail.
            # Their upload offsets sit at the payload end with zero widths
            # (their window slices read pad bytes; every plane is masked).
            pad_f = _pp.pad_batch(fhi_f - flo_f, mesh) - (fhi_f - flo_f)
            pad_l = pad_f * channels
            padf = lambda a, p: np.pad(a, [(0, p)] + [(0, 0)] * (a.ndim - 1))
            pb = lambda x: _pp.put_batch(x, mesh)
            handle = _decode_lanes_bp(
                _pp.put_replicated(buf, mesh),
                pb(padf(up_modes.astype(np.int32), pad_l)),
                pb(padf(up_widths, pad_l)),
                pb(np.concatenate([
                    up_off.astype(np.int32),
                    np.full(pad_l, payload_end, np.int32),
                ])),
                pb(padf(coeffs[lo:hi], pad_l)), pb(padf(shifts[lo:hi], pad_l)),
                pb(padf(orders[lo:hi], pad_l)), pb(padf(is_fixed[lo:hi], pad_l)),
                pb(padf(mid_side[flo_f:fhi_f], pad_f)),
                pb(padf(lane_nvalid[lo:hi], pad_l)), channels, S_max,
                # Static cumsum depth for the residual unpack: the host
                # packer just chose the modes, so the highest order is
                # known here (residual content rarely exceeds 2; each
                # skipped order saves one [L, S] cumsum pass in the decode
                # step).
                up_kmax=int(up_modes.max()) if len(up_modes) else 0,
                mesh=mesh,
            )
            # Small outputs (modes/widths/bytes) start their host copy now
            # (ready when compute ends). The payload prefix fetch ALSO
            # starts now, speculatively sized from the previous same-shaped
            # chunk (cold: ~0.75x the residual upload — delta-packed PCM is
            # usually smaller than the Rice-domain residuals), so the
            # download streams while the host collects OTHER pipelines
            # instead of waiting for this collect's turn (tools/
            # pass_timeline.py: fetches used to start 2.4-2.6 s late).
            start_host_copy(handle[2], handle[3], handle[4])
            from ..ops import blockspread

            spec = blockspread.fetch_words_spec_start(
                handle[1],
                ("ll_dec", channels, S_max, fhi_f - flo_f),
                int(payload_end * 0.75),
            )
            return handle, spec, lo, hi

        handles = []
        for flo_f in range(0, F_tot, f_half):
            fhi_f = min(flo_f + f_half, F_tot)
            handles.append(dispatch(flo_f, fhi_f))

        # Per-lane interleaved output bases: the group's files concatenate
        # into one flat f32 buffer (per-file results are zero-copy views);
        # frame f's samples interleave over channels at frame_base[f].
        flens64 = frame_lengths_all.astype(np.int64)
        frame_base = np.zeros(F_tot, np.int64)
        np.cumsum(flens64[:-1] * channels, out=frame_base[1:])
        lane_base = (
            frame_base[:, None] + np.arange(channels, dtype=np.int64)[None, :]
        ).reshape(-1)
        group_nsamp = int(flens64.sum() * channels)

        # NB: group-level names the deferred closure touches are bound via
        # default args — the loop rebinds them for the next channel group
        # before collect() runs.
        def collect(handles=handles, group=group, channels=channels,
                    lane_nvalid=lane_nvalid, S_max=S_max,
                    lane_base=lane_base, group_nsamp=group_nsamp):
            # Phase 1: start every chunk's payload download (async) so later
            # chunks' bytes stream while earlier chunks host-unpack.
            from ..ops import blockspread

            started = []
            for (stage, words_d, modes_d, widths_d, bytes_d, _off_d), spec, lo, hi in handles:
                # Offsets recomputed host-side (lane payloads are 32-byte
                # multiples and tile the stream; padded mesh lanes are a
                # zero-byte tail, dropped by the [:hi-lo] slices below).
                dn_bytes = np.asarray(bytes_d).astype(np.int64)
                boff = np.concatenate([[0], np.cumsum(dn_bytes)])
                total_bytes = int(boff[-1])
                if total_bytes > words_d.size * 4:
                    # Corrupt-stream route: reconstruction garbage widened a
                    # block past PCM_WORST_BITS — redispatch at the exact
                    # entropy-sized bucket (the speculative prefix is a
                    # slice of the OLD words buffer; drop it).
                    words_d = blockpack.pack_rows_stage2(
                        NW=blockspread.bucket_words(total_bytes // 4), **stage
                    )
                    spec = None
                h = blockspread.fetch_words_spec_resolve(spec, words_d, total_bytes)
                started.append(
                    (h, total_bytes, boff[:-1], modes_d, widths_d, lo, hi)
                )
            # Every lane writes its f32 samples straight into the group
            # buffer (fused C++ parse+scale+interleave); lane regions tile
            # the buffer exactly, so np.empty is safe.
            group_out = np.empty(group_nsamp, np.float32)
            for h, total, dn_off, modes_d, widths_d, lo, hi in started:
                packed = blockspread.fetch_words_spec_collect(h)
                blockpack.unpack_f32_into(
                    packed, np.asarray(modes_d)[: hi - lo],
                    np.asarray(widths_d)[: hi - lo],
                    dn_off[: hi - lo],
                    lane_nvalid[lo:hi], S_max,
                    lane_base[lo:hi], channels,
                    1.0 / 32767.0, group_out,
                )
            pos = 0
            for i, m in group:
                n = int(m[7].sum()) * channels
                outs[i] = group_out[pos : pos + n]
                pos += n

        collectors.append(collect)

    def fin():
        for collect in collectors:
            collect()
        return outs

    return BulkFuture(fin)


def decode_many(flos: list[FloFile], mesh=None) -> list[np.ndarray]:
    """Blocking form of decode_many_async."""
    return decode_many_async(flos, mesh=mesh).result()


def _undo_midside_host(fcs: np.ndarray, mid_side: np.ndarray, channels: int) -> np.ndarray:
    """Mid/side -> L/R on [F, C, S] int32 frames (decoder.rs:75-89; Rust's
    truncating `/ 2`)."""
    if channels != 2:
        return fcs
    m, s = fcs[:, 0].astype(np.int64), fcs[:, 1].astype(np.int64)

    def trunc_div2(t):
        return t // 2 + ((t < 0) & (t % 2 != 0))

    left = np.where(mid_side[:, None], trunc_div2(m + s), m)
    right = np.where(mid_side[:, None], trunc_div2(m - s), s)
    return np.stack([left.astype(np.int32), right.astype(np.int32)], axis=1)


def decode_file_i32(flo: FloFile) -> np.ndarray:
    """Integer-domain decode: [total_samples, channels] int32 (pre mid/side
    conversion applied, i.e. true L/R). Used by bit-exactness tests."""
    channels = flo.header.channels
    marshaled = _marshal_lanes(flo)
    if marshaled is None:
        return np.zeros((0, channels), dtype=np.int32)
    rows, coeffs, shifts, orders, is_fixed, mid_side, S, frame_lengths = marshaled
    samples = np.asarray(lpc.reconstruct(rows, coeffs, shifts, orders, is_fixed))
    fcs = _undo_midside_host(samples.reshape(-1, channels, S), mid_side, channels)
    parts = [fcs[i, :, : frame_lengths[i]].T for i in range(fcs.shape[0])]
    return np.concatenate(parts, axis=0)


def decode_file_host(flo: FloFile) -> np.ndarray:
    """Single-file decode with NO device round trip -> interleaved f32.

    The bulk pipelines amortize device dispatch and transfer over thousands
    of lanes; a per-frame streaming next_frame() or a seek's decode_frame_at
    cannot, so those paths run entirely on the host: C++ batch Rice unpack
    plus C++ LPC reconstruction (native/rice.cpp lpc_reconstruct_batch, the
    native analog of decoder.rs:92-273's serial loops). Falls back to the
    jitted device path when the native toolchain is unavailable.
    """
    from .. import native
    from ..core.convert import i32_to_f32_np

    channels = flo.header.channels
    marshaled = _marshal_lanes(flo)
    if marshaled is None:
        return np.zeros(0, dtype=np.float32)
    rows, coeffs, shifts, orders, is_fixed, mid_side, S, frame_lengths = marshaled
    if not native.lpc_reconstruct_into(
        rows, coeffs, shifts, orders, is_fixed, np.repeat(frame_lengths, channels)
    ):
        return decode_file(flo)
    out = native.midside_interleave_f32(
        rows, mid_side, frame_lengths.astype(np.int64), channels, 1.0 / 32767.0
    )
    if out is not None:
        return out
    fcs = _undo_midside_host(rows.reshape(-1, channels, S), mid_side, channels)
    parts = [fcs[i, :, : frame_lengths[i]].T for i in range(fcs.shape[0])]
    ints = np.concatenate(parts, axis=0)
    return i32_to_f32_np(ints).reshape(-1)
