"""Lossless encoder: batched best-of-N predictor search, device-first.

Behavioral model: libflo/src/lossless/encoder.rs:32-302. Redesigned for batches:
instead of the reference's per-channel serial loop that tries ~14 candidate
encodings one at a time, every (frame, channel) lane evaluates *all*
candidates in ONE jitted program (ops/select.py):

1. Host marshals interleaved f32 into [lanes, S] int32 (silence detection,
   f32->i32, deinterleave, exact mid/side decision, encoder.rs:66-170).
2. Host computes exact integer autocorrelation (f64 einsum — products
   <= 2^34 and sums <= 2^52 are exactly representable, so this equals
   autocorr_int lpc.rs:213-221 bit-for-bit) and the float64 Levinson
   recursion for every LPC order in one vectorized sweep (ops/lpc.py).
3. Device: exact residuals, exact Rice parameter, exact encoded sizes,
   argmin selection (reference evaluation order raw -> fixed 0..4 ->
   LPC 5..max with strict-< tie-break, encoder.rs:173-217; instability
   rejection max|r| > 1e6, encoder.rs:269-271), winner residual streams,
   and the Rice/raw WIRE BYTES themselves (ops/blockspread.py) — only
   entropy-coded payloads cross the device->host wire.
4. Host: slice per-lane payloads + container writer.

Deliberate deviation from the reference (bug, not behavior): encoder.rs:104-119
types a frame Raw when every channel's best *order* is 0 — which includes
fixed-predictor-0 winners whose payload is Rice bytes, and Raw serialization
(writer.rs:266-268) then drops the Rice framing so the decoder misreads the
stream as i16 PCM (visibly corrupt in the reference's own
Examples/white_noise.flo). We type a frame Raw only when every channel chose
the raw-PCM strategy; fixed-0 winners keep the ALPC layout, which the
reference decoder handles correctly (decoder.rs:92-148).
"""

from __future__ import annotations

from typing import List, Optional

import jax.numpy as jnp
import numpy as np

from ..container import writer
from ..futures import BulkFuture
from ..core.constants import (
    FIXED_PREDICTOR_MARKER,
    FRAME_FLAG_MID_SIDE,
    FrameType,
    I16_MAX_F32,
    LPC_ORDER_BY_LEVEL,
    MIN_LEVEL_FOR_LPC,
    ResidualEncoding,
    SILENCE_THRESHOLD,
)
from ..core.convert import f32_to_i32_np
from ..core.types import ChannelData, Frame
from ..ops import lpc, ricepack
from ..ops.select import encode_select_packed, encode_select_pcm16


def _candidate_plan(compression_level: int):
    """Candidate list in the reference's evaluation order (encoder.rs:183-214).

    Returns (kinds, orders, max_order): kind 'raw' | 'fixed' | 'lpc'.
    """
    max_order = LPC_ORDER_BY_LEVEL[min(compression_level, 9)]
    kinds = ["raw"]
    orders = [0]
    for o in range(0, min(4, max_order) + 1):
        kinds.append("fixed")
        orders.append(o)
    if compression_level >= MIN_LEVEL_FOR_LPC and max_order > 4:
        for o in range(5, max_order + 1):
            kinds.append("lpc")
            orders.append(o)
    return kinds, orders, max_order


def _autocorr_int_exact(lanes: np.ndarray, nvalid: np.ndarray, max_order: int) -> np.ndarray:
    """Exact integer autocorrelation lags 0..max_order (lpc.rs:213-221).

    f64 (exact for the codec's sample domain: products <= 2^34, sums <= 2^52,
    so ANY summation order gives the identical result); batched BLAS matmul
    per lag for multithreaded reductions. Zero padding beyond nvalid
    contributes nothing.
    """
    S = lanes.shape[1]
    mask = np.arange(S)[None, :] < nvalid[:, None]
    x = np.where(mask, lanes, 0).astype(np.float64)  # one f64 copy
    cols = [np.matmul(x[:, None, :], x[:, :, None])[:, 0, 0]]
    for lag in range(1, max_order + 1):
        cols.append(
            np.matmul(x[:, None, lag:], x[:, : S - lag, None])[:, 0, 0]
        )
    return np.stack(cols, axis=1)


def encode_many_to_frames_async(
    samples_list,
    sample_rate: int,
    channels: int,
    compression_level: int = 5,
    analysis: str = "exact",
    compat: str = "fixed",
    mesh=None,
) -> BulkFuture:
    """Encode MANY files (same rate/channels) in one batched pass.

    All files' (frame, channel) lanes are concatenated into chunked device
    candidate-search calls — the bulk throughput path (batch parallelism is
    the workload's parallelism story, SURVEY.md §2.9). All device work is
    DISPATCHED before this returns; the BulkFuture's result() blocks on the
    downloads and yields one frame list per input file.

    mesh: optional `jax.sharding.Mesh` (or ambient `parallel.use_mesh`) —
    each chunk's frame axis is padded to a mesh multiple and the SAME jitted
    search runs GSPMD-sharded over the 'batch' axis; output bytes are
    identical to the unsharded path (parallel/pipeline.py).
    """
    C = int(channels)
    spf = int(sample_rate)
    if spf >= (1 << 18):
        raise ValueError("sample_rate too large for exact device aggregation")

    kinds, cand_orders, max_order = _candidate_plan(compression_level)
    NC = len(kinds)

    from .. import native

    # Worst-case lane allocation: every frame active. The fused C++ marshal
    # (native.encode_marshal_f32) writes each file's non-silent frames
    # compactly at a running row offset — interleaved f32 -> lane-major i32
    # + silence detection in ONE host pass (replacing astype+pad, the |x|
    # silence pass, f32->i32's temporaries, np.stack, and the lane moveaxis:
    # ~6 passes over the full PCM on this single-core host).
    metas = []  # (flat, is_int, total, num_frames)
    F_sum = 0
    for samples in samples_list:
        arr = np.asarray(samples)
        # Integer input is taken as the i32 sample domain directly (no f32
        # detour — the asymmetric 1/32767 scale makes i32->f32->i32 lossy
        # for 1536 values, see core/convert.py), enabling exact ingest of
        # integer PCM and byte-exact conformance re-encodes.
        is_int = np.issubdtype(arr.dtype, np.integer)
        flat = arr.reshape(-1)
        total = len(flat) // C
        num_frames = -(-total // spf) if total else 0
        metas.append((flat, is_int, total, num_frames))
        F_sum += num_frames

    lanes_batch = np.empty((F_sum * C, spf), np.int32)
    row = 0
    all_frames: List[List[Frame]] = []
    active_nvalid = []
    active_slots = []  # (file_idx, frame_idx)
    for fidx, (flat, is_int, total, num_frames) in enumerate(metas):
        if num_frames == 0:
            all_frames.append([])
            continue
        frame_samples = np.full(num_frames, spf, dtype=np.int64)
        frame_samples[-1] = total - (num_frames - 1) * spf
        res = None
        if not is_int:
            flat32 = np.ascontiguousarray(flat[: total * C], np.float32)
            res = native.encode_marshal_f32(
                flat32, total, C, spf, SILENCE_THRESHOLD,
                float(I16_MAX_F32), lanes_batch, row,
            )
        if res is not None:
            n_act, silent, active_idx = res
        else:
            # numpy fallback; also the integer-domain ingest path (silence
            # there is exact zeroness, not the f32 threshold).
            if is_int:
                padded = np.zeros(num_frames * spf * C, dtype=np.int32)
                padded[: total * C] = flat[: total * C]
                fsc = padded.reshape(num_frames, spf, C)
                silent = (fsc == 0).all(axis=(1, 2))
            else:
                padded = np.zeros(num_frames * spf * C, dtype=np.float32)
                padded[: total * C] = flat[: total * C].astype(np.float32)
                f32 = padded.reshape(num_frames, spf, C)
                silent = (np.abs(f32) < SILENCE_THRESHOLD).all(axis=(1, 2))
                fsc = f32_to_i32_np(f32)
            active_idx = np.flatnonzero(~silent)
            n_act = len(active_idx)
            if n_act:
                lanes_batch[row : row + n_act * C] = np.ascontiguousarray(
                    np.moveaxis(fsc[active_idx], 2, 1)
                ).reshape(-1, spf)
        frames: List[Frame] = [None] * num_frames  # type: ignore[list-item]
        for fi in np.flatnonzero(silent):
            frames[fi] = Frame(
                frame_type=int(FrameType.SILENCE),
                frame_samples=int(frame_samples[fi]),
                channels=[ChannelData.silence() for _ in range(C)],
            )
        all_frames.append(frames)
        for fi in active_idx:
            active_nvalid.append(frame_samples[fi])
            active_slots.append((fidx, int(fi)))
        row += n_act * C
    if not active_slots:
        return BulkFuture(lambda: all_frames)

    lanes_batch = lanes_batch[:row]  # [F'*C, S] lane-major, frame-compacted
    nvalid_f = np.asarray(active_nvalid, dtype=np.int64)

    from ..parallel import pipeline as _pp

    states = _dispatch_active_frames(
        lanes_batch, nvalid_f, C, kinds, cand_orders, analysis,
        mesh=_pp.active_mesh(mesh),
    )

    def fin() -> List[List[Frame]]:
        # Phase 1: async-start every chunk's payload download so later
        # chunks' bytes stream while earlier chunks assemble frames.
        for st in states:
            _start_chunk_fetch(st)
        frames_out: List[Frame] = []
        for st in states:
            frames_out.extend(
                _collect_chunk(st, C, kinds, cand_orders, max_order, compat)
            )
        for (fidx, fi), frame in zip(active_slots, frames_out):
            all_frames[fidx][fi] = frame
        return all_frames

    return BulkFuture(fin)


def encode_many_to_frames(
    samples_list,
    sample_rate: int,
    channels: int,
    compression_level: int = 5,
    analysis: str = "exact",
    compat: str = "fixed",
) -> List[List[Frame]]:
    """Blocking form of encode_many_to_frames_async."""
    return encode_many_to_frames_async(
        samples_list, sample_rate, channels, compression_level, analysis, compat
    ).result()


#: Number of sub-batches a bulk encode is split into. With >1, chunk B's
#: uploads/compute overlap chunk A's download + host assembly (jax dispatch
#: is async; only the collect blocks). Not yet re-measured on the GPU.
PIPELINE_CHUNKS = 2


def _dispatch_active_frames(
    lanes, frame_samples, C, kinds, cand_orders, analysis: str = "exact", mesh=None
):
    """Dispatch a batch of non-silent frames (lane-major [F'*C, S], frame
    f's channel c at row f*C+c) as PIPELINE_CHUNKS sub-batches; returns the
    per-chunk states for _collect_chunk.

    analysis: "exact" (host i64-equivalent autocorrelation + f64 Levinson —
    reference-parity coefficient generation) or "device" (everything on
    device in f32 — zero host analysis; round-trips stay bit-exact, ratios
    may drift marginally).
    """
    Fa = lanes.shape[0] // C
    G = PIPELINE_CHUNKS if Fa >= 2 * PIPELINE_CHUNKS else 1
    # Keep every chunk under the device packer's int32 bit-index bound
    # (shape buckets can pad a chunk's lane axis up to 1.5x, so budget for it).
    from ..parallel import pipeline as _pp

    pad_factor = 3 if _pp.shape_buckets_on() else 2
    G = max(G, -(-(lanes.shape[0] * lanes.shape[1] * pad_factor // 2)
                 // ricepack.MAX_BATCH_SAMPLES))
    chunk = -(-Fa // G)
    states = []
    for g in range(G):
        lo, hi = g * chunk, min((g + 1) * chunk, Fa)
        if lo >= hi:
            continue
        states.append(
            _dispatch_chunk(
                lanes[lo * C : hi * C], frame_samples[lo:hi], C, kinds,
                cand_orders, analysis, mesh=mesh,
            )
        )
    return states


def _pad_frames(arr, pad_f, axis=0):
    """Zero-pad `pad_f` extra entries along `axis` (inert mesh-padding rows)."""
    if pad_f == 0:
        return arr
    widths = [(0, 0)] * arr.ndim
    widths[axis] = (0, pad_f)
    return np.pad(arr, widths)


def _dispatch_chunk(lanes_in, frame_samples, C, kinds, cand_orders,
                    analysis="exact", mesh=None):
    """Host marshal + async device dispatch for one sub-batch.

    lanes_in: lane-major [F'*C, S] int32 samples — frame f's channel c at
    row f*C+c (the fused marshal emits this layout directly; both branches
    below consume it without a transpose copy).
    Under a mesh, the frame axis is padded to a mesh multiple (padding frames
    are nvalid=0 -> zero-byte raw winners at the lane tail) and every batch
    array is uploaded with the 'batch' sharding; small inputs replicate."""
    from ..parallel import pipeline as _pp

    NC = len(kinds)
    spf = lanes_in.shape[1]
    n_frames = lanes_in.shape[0] // C
    max_order = max(
        (o for kd, o in zip(kinds, cand_orders) if kd == "lpc"), default=0
    )
    pad_f = _pp.pad_batch(n_frames, mesh) - n_frames
    pb = lambda x: _pp.put_batch(x, mesh)
    pr = lambda x: _pp.put_replicated(x, mesh)

    if analysis == "device":
        # Block-packed PCM upload (ops/blockpack): the input crosses the wire
        # at compressed size; the device unpacks scan-free + runs the whole
        # analysis + search (encode_select_packed).
        from ..ops import blockpack
        from .decoder import _bucket_bytes

        lanes_pcm = lanes_in  # already lane-major, no transpose copy
        nv_lane = np.repeat(frame_samples, C).astype(np.int64)
        buf, modes_up, widths_up, lane_off_up = blockpack.pack_host(lanes_pcm, nv_lane)
        payload_end = len(buf) - blockpack.PAD_BYTES  # 4-aligned
        nb = _bucket_bytes(len(buf))
        if nb != len(buf):
            buf = np.concatenate([buf, np.zeros(nb - len(buf), np.uint8)])
        # Mesh-padding lanes sit at the payload end with zero widths (their
        # window slices read pad bytes; every plane is masked by w=0).
        off_pad = np.full(pad_f * C, payload_end, np.int32)
        device_out = encode_select_packed(
            pr(buf),
            pb(_pad_frames(modes_up.astype(np.int32), pad_f * C)),
            pb(_pad_frames(widths_up, pad_f * C)),
            pb(np.concatenate([lane_off_up.astype(np.int32), off_pad])),
            pb(_pad_frames(frame_samples.astype(np.int32), pad_f)),
            tuple(kinds), tuple(cand_orders), C, spf,
        )
        # Start host copies for the small outputs (everything but the packed
        # payload buffer [3] and the residual rows [7]). The payload prefix
        # fetch ALSO starts now, speculatively sized from the previous
        # same-shaped chunk (cold: ~1.3x the packed-PCM upload — Rice
        # residual payloads run a bit larger than delta-packed PCM), so the
        # container bytes stream down while the host is busy elsewhere.
        from ..futures import start_host_copy
        from ..ops import blockspread

        start_host_copy(*(device_out[i] for i in (0, 1, 2, 4, 5, 6, 8, 9, 10)))
        spec = blockspread.fetch_words_spec_start(
            device_out[3],
            ("ll_enc", C, spf, n_frames),
            int(payload_end * 1.3),
        )
        return {
            "device_out": device_out[:10],
            "spec": spec,
            "mid_side_dev": device_out[10],
            "nvalid": np.repeat(frame_samples, C).astype(np.int32),
            "frame_samples": frame_samples,
            "mid_side": None,
            "Fa": n_frames,
            "L": n_frames * C,
        }
    ch = lanes_in.reshape(n_frames, C, spf)  # view — already lane-major
    Fa = n_frames
    nvalid_f = frame_samples

    mid_side = np.zeros(Fa, dtype=bool)
    if C == 2:
        # einsum with dtype=f64 is exact here (squares <= 2^34, sums <= 2^52,
        # encoder.rs:131-153) without materializing f64 copies.
        l, r = ch[:, 0], ch[:, 1]
        var_l = np.einsum("fs,fs->f", l, l, dtype=np.float64)
        var_r = np.einsum("fs,fs->f", r, r, dtype=np.float64)
        side = l - r  # int32-exact
        var_side = np.einsum("fs,fs->f", side, side, dtype=np.float64)
        mid_side = var_side < np.floor_divide(var_l + var_r, 2)
        mid = l + r
        ch = np.where(mid_side[:, None, None], np.stack([mid, side], axis=1), ch)

    lanes = ch.reshape(Fa * C, spf)
    nvalid = np.repeat(nvalid_f, C).astype(np.int32)
    L = lanes.shape[0]

    # Per-lane candidate parameter tables.
    coeffs_all = np.zeros((L, NC, lpc.MAX_ORDER), dtype=np.int32)
    shifts_all = np.zeros((L, NC), dtype=np.int32)
    orders_all = np.zeros((L, NC), dtype=np.int32)
    fixed_all = np.zeros((L, NC), dtype=bool)
    cand_ok = np.ones((L, NC), dtype=bool)

    if any(kd == "lpc" for kd in kinds):
        ac = _autocorr_int_exact(lanes, nvalid, max_order)
        lpc_c, lpc_s, lpc_valid = lpc.levinson_durbin_all_orders(ac, max_order)
    for ci, (kd, o) in enumerate(zip(kinds, cand_orders)):
        if kd == "fixed":
            coeffs_all[:, ci, :] = lpc._FIXED_COEFFS[o]
            orders_all[:, ci] = o
            fixed_all[:, ci] = True
        elif kd == "lpc":
            coeffs_all[:, ci] = lpc_c[:, o - 1]
            shifts_all[:, ci] = lpc_s[:, o - 1]
            orders_all[:, ci] = o
            cand_ok[:, ci] = lpc_valid[:, o - 1] & (nvalid > o)

    is_lpc = tuple(kd == "lpc" for kd in kinds)
    # i16 upload + entropy-packed download (see ops/select.py); pcm is
    # i16-representable by construction (f32_to_i32 clamps to [-32768, 32767]).
    pcm16 = lanes_in.reshape(Fa, C, spf).astype(np.int16)
    device_out = encode_select_pcm16(
        pb(_pad_frames(pcm16, pad_f)),
        pb(_pad_frames(mid_side, pad_f)),
        pb(_pad_frames(nvalid_f.astype(np.int32), pad_f)),
        pb(_pad_frames(coeffs_all, pad_f * C)),
        pb(_pad_frames(shifts_all, pad_f * C)),
        pb(_pad_frames(orders_all, pad_f * C)),
        pb(_pad_frames(fixed_all, pad_f * C)),
        pb(_pad_frames(cand_ok, pad_f * C)),
        is_lpc,
    )
    from ..futures import start_host_copy
    from ..ops import blockspread

    start_host_copy(*(device_out[i] for i in (0, 1, 2, 4, 5, 6, 8, 9)))
    spec = blockspread.fetch_words_spec_start(
        device_out[3],
        ("ll_enc16", C, spf, Fa),
        int(pcm16.nbytes * 0.55),
    )
    return {
        "device_out": device_out,
        "spec": spec,
        "mid_side_dev": None,
        "nvalid": nvalid,
        "frame_samples": frame_samples,
        "mid_side": mid_side,
        "Fa": Fa,
        "L": L,
    }


def _start_chunk_fetch(st) -> None:
    """Collect phase 1: download the tiny lane sizes (prefetched at dispatch
    — the pack itself already ran fused in the dispatch program at the
    worst-case bucket, so nothing waits on these sizes but the payload
    fetch length) and async-start the payload prefix download. Idempotent."""
    from ..ops import blockspread

    if "prefetch" in st:
        return
    (_, _, _, words, lane_bytes_d, lane_off_d, *_rest) = st["device_out"]
    lane_bytes = np.asarray(lane_bytes_d).astype(np.int64)
    lane_off = np.asarray(lane_off_d).astype(np.int64)
    # Word-aligned payload span (the last lane's region rounds up to words).
    total = int(lane_off[-1] + ((lane_bytes[-1] + 3) // 4) * 4) if st["L"] else 0
    h = blockspread.fetch_words_spec_resolve(st.get("spec"), words, total)
    st["prefetch"] = (h, total, lane_bytes, lane_off)


def _collect_chunk(st, C, kinds, cand_orders, max_order, compat: str = "fixed"):
    """Block on one sub-batch's results; slice the device-packed wire
    payloads and assemble its frames (host entropy coding only for the rare
    `bad` lanes — >32-bit codes past the tail-patch capacity).

    compat="reference-bugs" reproduces the reference encoder BYTE-FOR-BYTE,
    including its Raw-frame defect (encoder.rs:104-119 + writer.rs:266-268):
    a frame whose channels all won with ORDER 0 — raw-PCM *or* fixed-0, whose
    payload is Rice bytes — is typed Raw and serialized without the ALPC
    framing, so fixed-0 payloads decode as garbage i16 PCM (the corruption
    visible in Examples/white_noise.flo). The default "fixed" types Raw only
    when every channel actually chose the raw-PCM strategy."""
    (
        sel_d, k_d, size_d, _words, lane_bytes_d, lane_off_d, bad_d,
        res_dev, winc_d, wins_d,
    ) = st["device_out"]
    frame_samples = st["frame_samples"]
    Fa, L = st["Fa"], st["L"]

    from ..ops import blockspread

    sel = np.asarray(sel_d)
    ks = np.asarray(k_d)
    _start_chunk_fetch(st)
    prefix_h, total, lane_bytes, lane_off = st["prefetch"]
    # The packer's byte counts are computed independently of selection's exact
    # sizes; equality is a cheap end-to-end check of the device bit packing.
    if not np.array_equal(lane_bytes, np.asarray(size_d).astype(np.int64)):
        raise AssertionError("device Rice packing size mismatch")
    pb = blockspread.fetch_words_spec_collect(prefix_h)

    # Exact host re-pack of flagged lanes (q+1+k > 32 somewhere; possible
    # only on pathological spikes — the estimator keeps quotients small).
    # Safety of substituting whole lanes: the device may have scattered a
    # long code's PARTIAL tail into the packed buffer, but (a) repack
    # replaces the lane's entire blob (rice_host.encode from the residual
    # row — `repack.get(lane) or pb[...]` below never mixes the two), and
    # (b) blockspread's bad-flagging is a RANGE mark over every lane whose
    # words intersect a polluted region (ops/blockspread.py lane_cov_bad),
    # so a tail crossing a lane boundary flags the neighbor for re-pack too.
    repack: dict[int, bytes] = {}
    bad_rows = np.flatnonzero(np.asarray(bad_d))
    if len(bad_rows):
        from ..core import rice_host
        from ..ops.select import gather_rows
        import jax.numpy as _jnp

        pad = 1 << max(len(bad_rows) - 1, 0).bit_length()
        idx_p = np.zeros(pad, np.int32)
        idx_p[: len(bad_rows)] = bad_rows
        rows = np.asarray(gather_rows(res_dev, _jnp.asarray(idx_p)))[: len(bad_rows)]
        nv = st["nvalid"]
        for lane, row in zip(bad_rows.tolist(), rows):
            repack[lane] = rice_host.encode(row[: nv[lane]], int(ks[lane]))
            assert len(repack[lane]) == lane_bytes[lane]

    win_coeffs = np.asarray(winc_d)
    win_shifts = np.asarray(wins_d)
    mid_side = (
        st["mid_side"] if st["mid_side"] is not None else np.asarray(st["mid_side_dev"])
    )

    bug_compat = compat == "reference-bugs"
    frames_out: List[Frame] = []
    for idx in range(Fa):
        n = int(frame_samples[idx])
        chans = []
        all_raw = True
        if bug_compat:
            # encoder.rs best_order==0 for raw AND fixed-0 winners.
            all_order0 = all(
                kinds[int(sel[idx * C + c])] == "raw"
                or (kinds[int(sel[idx * C + c])] == "fixed"
                    and cand_orders[int(sel[idx * C + c])] == 0)
                for c in range(C)
            )
            if all_order0:
                for c in range(C):
                    lane = idx * C + c
                    blob = repack.get(lane) or pb[
                        lane_off[lane] : lane_off[lane] + lane_bytes[lane]
                    ]
                    # writer.rs:266-268: Raw channels emit the payload bytes
                    # verbatim — fixed-0 winners lose their Rice framing.
                    chans.append(ChannelData.raw(blob))
                frames_out.append(
                    Frame(
                        frame_type=int(FrameType.RAW),
                        frame_samples=n,
                        flags=FRAME_FLAG_MID_SIDE if mid_side[idx] else 0,
                        channels=chans,
                    )
                )
                continue
        for c in range(C):
            lane = idx * C + c
            ci = int(sel[lane])
            kd = kinds[ci]
            blob = repack.get(lane) or pb[lane_off[lane] : lane_off[lane] + lane_bytes[lane]]
            if kd == "raw":
                # Raw winners' packed payload IS the verbatim LE16 samples
                # (i16 wrap matches Rust `as i16`; see ops/ricepack.py).
                chans.append(ChannelData.raw(blob))
            else:
                all_raw = False
                k = int(ks[lane])
                if kd == "fixed":
                    chans.append(
                        ChannelData(
                            predictor_coeffs=[],
                            shift_bits=FIXED_PREDICTOR_MARKER + cand_orders[ci],
                            residual_encoding=ResidualEncoding.RICE,
                            rice_parameter=k,
                            residuals=blob,
                        )
                    )
                else:
                    order = cand_orders[ci]
                    chans.append(
                        ChannelData(
                            predictor_coeffs=[int(v) for v in win_coeffs[lane][:order]],
                            shift_bits=int(win_shifts[lane]),
                            residual_encoding=ResidualEncoding.RICE,
                            rice_parameter=k,
                            residuals=blob,
                        )
                    )
        ftype = FrameType.RAW if all_raw else FrameType.from_order(max_order)
        frames_out.append(
            Frame(
                frame_type=int(ftype),
                frame_samples=n,
                flags=FRAME_FLAG_MID_SIDE if mid_side[idx] else 0,
                channels=chans,
            )
        )
    return frames_out


def encode_to_frames(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    compression_level: int = 5,
    compat: str = "fixed",
) -> List[Frame]:
    """Encode interleaved f32 samples into a list of container frames.

    Single-file encodes (the CLI's hot path) run on the HOST via the C++
    candidate search when f32 input and default compat allow — a lone file
    cannot amortize device round trips, and the host path also skips the
    JAX backend handshake entirely. compat="reference-bugs" (byte-exact
    reference conformance) and integer-domain ingest keep the exact
    device/bulk path."""
    arr = np.asarray(samples)
    if compat == "fixed" and not np.issubdtype(arr.dtype, np.integer):
        frames = _encode_frames_host_file(
            arr, sample_rate, channels, compression_level
        )
        if frames is not None:
            return frames
    return encode_many_to_frames(
        [samples], sample_rate, channels, compression_level, "exact", compat
    )[0]


def _encode_frames_host_file(
    samples: np.ndarray, sample_rate: int, channels: int, compression_level: int
) -> Optional[List[Frame]]:
    """Whole-file host encode: one encode_frame_host call per 1 s frame.
    Returns None when the native toolchain is unavailable."""
    arr = np.asarray(samples, dtype=np.float32).reshape(-1)
    C = int(channels)
    spf = int(sample_rate)
    total = len(arr) // C
    frames: List[Frame] = []
    for start in range(0, total, spf):
        chunk = arr[start * C : min(start + spf, total) * C]
        f = encode_frame_host(chunk, sample_rate, C, compression_level)
        if f is None:
            return None
        frames.append(f)
    return frames


def encode_frame_host(
    samples: np.ndarray, sample_rate: int, channels: int,
    compression_level: int = 5, prune_lpc: int = 0,
):
    """Encode ONE frame's interleaved f32 samples entirely on the host:
    C++ candidate search (native/encode.cpp) + C++ Rice pack. The per-frame
    path for streaming encode, where a device round trip per 1 s frame is
    pure latency (same rationale as decoder.decode_file_host). Returns a
    Frame, or None when the native toolchain is unavailable (callers fall
    back to the device path).

    Same candidate plan and selection semantics as the device search
    (encoder.rs:66-217); coefficients may differ at the f64-ulp level from
    the numpy Levinson (identical recursion, different libm rounding on some
    hosts) — round-trips are bit-exact either way, since coefficients are
    stored in the stream.
    """
    from .. import native
    from ..core import rice_host

    arr = np.asarray(samples, dtype=np.float32).reshape(-1)
    C = int(channels)
    n = len(arr) // C
    if n == 0:
        return None
    if (np.abs(arr[: n * C]) < SILENCE_THRESHOLD).all():
        return Frame(
            frame_type=int(FrameType.SILENCE),
            frame_samples=n,
            channels=[ChannelData.silence() for _ in range(C)],
        )
    ints = f32_to_i32_np(arr[: n * C]).reshape(n, C)
    ch = np.ascontiguousarray(ints.T)  # [C, n]

    mid_side = False
    if C == 2:
        l, r = ch[0], ch[1]
        var_l = np.einsum("s,s->", l, l, dtype=np.float64)
        var_r = np.einsum("s,s->", r, r, dtype=np.float64)
        side = l - r
        var_side = np.einsum("s,s->", side, side, dtype=np.float64)
        mid_side = bool(var_side < np.floor_divide(var_l + var_r, 2))
        if mid_side:
            ch = np.stack([l + r, side])

    kinds, cand_orders, max_order = _candidate_plan(compression_level)
    use_lpc = any(kd == "lpc" for kd in kinds)
    out = native.lossless_search_batch(
        ch, np.full(C, n, np.int64), max_order, use_lpc, prune_lpc
    )
    if out is None:
        return None
    sel_kind, sel_order, ks, coeffs, shifts, sizes, residuals = out

    rice_lanes = np.flatnonzero(sel_kind != 0)
    blobs = {}
    if len(rice_lanes):
        packed = rice_host.encode_batch(
            residuals[rice_lanes], ks[rice_lanes],
            np.full(len(rice_lanes), n, np.int64),
        )
        blobs = dict(zip(rice_lanes.tolist(), packed))

    chans = []
    all_raw = True
    for c in range(C):
        kd = int(sel_kind[c])
        if kd == 0:
            chans.append(
                ChannelData.raw(residuals[c, :n].astype("<i2").tobytes())
            )
        else:
            all_raw = False
            if kd == 1:
                chans.append(
                    ChannelData(
                        predictor_coeffs=[],
                        shift_bits=FIXED_PREDICTOR_MARKER + int(sel_order[c]),
                        residual_encoding=ResidualEncoding.RICE,
                        rice_parameter=int(ks[c]),
                        residuals=blobs[c],
                    )
                )
            else:
                order = int(sel_order[c])
                chans.append(
                    ChannelData(
                        predictor_coeffs=[int(v) for v in coeffs[c, :order]],
                        shift_bits=int(shifts[c]),
                        residual_encoding=ResidualEncoding.RICE,
                        rice_parameter=int(ks[c]),
                        residuals=blobs[c],
                    )
                )
    ftype = FrameType.RAW if all_raw else FrameType.from_order(max_order)
    return Frame(
        frame_type=int(ftype),
        frame_samples=n,
        flags=FRAME_FLAG_MID_SIDE if mid_side else 0,
        channels=chans,
    )


def encode_many_async(
    samples_list,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata_list=None,
    analysis: str = "device",
    mesh=None,
) -> BulkFuture:
    """Bulk encode, dispatched immediately; result() yields the file bytes.

    The bulk default analysis="device" runs the mid/side decision +
    autocorrelation + Levinson on device (f32): zero host analysis work.
    Round-trips stay bit-exact either way (coefficients travel in the
    stream); corpus re-encode sizes drift <= 1 byte vs analysis="exact"
    (the reference-parity host i64/f64 path, still the single-file
    encode() default and available here as an option).

    mesh: optional device mesh for GSPMD batch sharding (or ambient
    `parallel.use_mesh`); see encode_many_to_frames_async.
    """
    level = min(int(compression_level), 9)
    fut = encode_many_to_frames_async(
        samples_list, sample_rate, channels, level, analysis, mesh=mesh
    )
    n = len(samples_list)
    metas = metadata_list or [b""] * n
    return fut.then(
        lambda frames_per_file: [
            writer.write(
                int(sample_rate), int(channels), int(bit_depth), level, frames, meta
            )
            for frames, meta in zip(frames_per_file, metas)
        ]
    )


def encode_many(
    samples_list,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata_list=None,
    analysis: str = "device",
    mesh=None,
) -> List[bytes]:
    """Bulk encode: many files, one device pass (blocking form; see
    encode_many_async for the analysis="device" bulk default)."""
    return encode_many_async(
        samples_list, sample_rate, channels, bit_depth, compression_level,
        metadata_list, analysis, mesh=mesh,
    ).result()


def encode(
    samples: np.ndarray,
    sample_rate: int,
    channels: int,
    bit_depth: int = 16,
    compression_level: int = 5,
    metadata: bytes = b"",
    compat: str = "fixed",
) -> bytes:
    """Encode interleaved f32 samples to flo bytes (encoder.rs:32-45).

    compat="reference-bugs" reproduces the reference encoder's output
    byte-for-byte, including its Raw-frame serialization defect — see
    _collect_chunk. Use only for conformance testing against
    reference-produced files."""
    level = min(int(compression_level), 9)
    frames = encode_to_frames(samples, sample_rate, channels, level, compat)
    return writer.write(
        int(sample_rate), int(channels), int(bit_depth), level, frames, metadata
    )
