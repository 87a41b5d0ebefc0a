"""Fixed-width bit-plane block-packed integer wire transport (upload).

The ONE transport format for every bulk host->device tensor (PCM uploads,
residual uploads). Design rationale (fewer bytes across the host link and
no per-index device scatter/gather; not yet re-measured on the GPU):

* Rice coding on the wire needs either a sequential device scan to decode
  (hundreds of ms per chunk) or heavy host numpy (seconds), and real content
  defeats per-lane escape hatches — one transient per 1 s frame is enough to
  push a Rice quotient past any fixed device window (rice.rs caps unary runs
  at 255, so 271-bit codes are format-legal).
* Fixed-width blocks have NO escape cases (w <= 32 covers any int32) and
  cost ~10-15% more bytes than Rice.
* BIT-PLANE layout inside each block makes the device unpack pure
  arithmetic: one contiguous-slice gather per block (the only indexed op —
  ~4k of them per MB, not one per code) followed by a fused plane
  accumulation. Round 2 unpacked sequential-bit blocks with per-WORD delta
  scatters + a flat cumsum; at ~10 ns/index those scatters alone cost
  ~196 ms per bulk chunk (tools/decode_decompose.py) — the entire gap
  between the Pallas reconstruction (~7 ms) and the 1000x target.

Format (shared with the C++ half, see native/blockpack.cpp): per lane a
transform mode (0 = values, k in 1..4 = k-th difference, int32 wrap — the
codec's fixed-predictor family; on the corpus's tonal content orders 3/4
cut the PCM wire from ~7.0 to ~4.6 bits/sample while noise still picks 0),
zigzag, then blocks of BLK=256 codes at a per-block width w in [0, 32].
Block payload = w bit-planes; plane p (0..w-1) is 8 little-endian u32
words, and bit i of plane word q holds bit p of zigzag code 32q+i. A block
is exactly 32*w bytes (identical to sequential packing, so the width
analysis is unchanged). Per-lane modes, per-block widths (u8), and lane
byte offsets travel as separate tiny arrays.

Silence/constant lanes pack to w=0 blocks: zero payload bytes.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

BLK = 256

#: Padding bytes after the packed payload so the device's per-block
#: 256-word window slices never read out of bounds (32 planes x 8 words).
PAD_BYTES = 1024

#: Bulk chunks are bounded so absolute BIT positions fit int32 on the
#: DOWNLOAD side (ops/blockspread packs <= WORST_BITS_PER_SAMPLE bits per
#: padded sample); kept here because callers size their chunks once for
#: both wire directions. (The upload unpack itself indexes words, not bits.)
MAX_PACK_SAMPLES = (1 << 31) // 32 - 2 * BLK


def nblocks(S: int) -> int:
    return -(-S // BLK)


# ---------------------------------------------------------------------------
# Host half (C++ single-pass with a vectorized numpy fallback).
# ---------------------------------------------------------------------------


def _np_zigzag(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.int32, copy=False)
    return ((v << 1) ^ (v >> 31)).view(np.uint32)


def _np_widths(z: np.ndarray, nblk: int) -> np.ndarray:
    """Per-block bit widths of zigzag codes z [L, nblk*BLK] -> [L, nblk]."""
    m = z.reshape(z.shape[0], nblk, BLK).max(axis=2)
    # bit_length via float exponent would be inexact near 2^24; use a table
    # walk: width = position of highest set bit + 1.
    w = np.zeros(m.shape, np.uint8)
    cur = m.copy()
    for shift in (16, 8, 4, 2, 1):
        big = cur >= (np.uint32(1) << shift)
        w[big] += shift
        cur = np.where(big, cur >> shift, cur)
    w[m > 0] += 1
    return w


def _np_transform(rows, nvalid, nblk):
    """Shared fallback prep: masked values + the 1st..4th differences
    (int32 wrap), padded to whole blocks. Each difference is taken over the
    UNMASKED previous order (nvalid is a prefix count, so every valid
    position's chain only touches valid positions — matching the C++
    streaming state). Returns ([v, d1, d2, d3, d4], valid), each
    [L, nblk*BLK] with invalid positions zeroed."""
    L, S = rows.shape
    valid = np.arange(S)[None, :] < nvalid[:, None]
    v = np.where(valid, rows, 0).astype(np.int32)
    pad = nblk * BLK - S
    if pad:
        v = np.pad(v, ((0, 0), (0, pad)))
        valid = np.pad(valid, ((0, 0), (0, pad)))
    cands = [v]
    for _ in range(4):
        d = cands[-1].copy()
        d[:, 1:] -= cands[-1][:, :-1]
        cands.append(d)
    return [np.where(valid, d, 0) for d in cands], valid


def analyze_host(rows: np.ndarray, nvalid: np.ndarray):
    """Pick per-lane mode + per-block widths + lane byte sizes.

    rows: [L, S] int32 (values past nvalid are ignored); nvalid: [L].
    Returns (modes u8 [L], widths u8 [L, NB], lane_bytes i64 [L]).
    """
    from .. import native

    rows = np.ascontiguousarray(rows, dtype=np.int32)
    L, S = rows.shape
    nblk = nblocks(S)
    nvalid = np.ascontiguousarray(nvalid, dtype=np.int64)
    out = native.blockpack_analyze(rows, nvalid, nblk)
    if out is not None:
        return out
    # numpy fallback
    ds, _valid = _np_transform(rows, nvalid, nblk)
    cands = [_np_widths(_np_zigzag(x), nblk) for x in ds]
    sizes = np.stack([32 * c.astype(np.int64).sum(axis=1) for c in cands])
    modes = sizes.argmin(axis=0).astype(np.uint8)
    widths = np.choose(modes[:, None], cands)
    return modes, widths, sizes[modes, np.arange(L)]


def pack_host(rows: np.ndarray, nvalid: np.ndarray):
    """Analyze + pack on the host (upload direction).

    Returns (buf u8 [total+PAD_BYTES], modes u8 [L], widths u8 [L, NB],
    lane_off i64 [L]).
    """
    from .. import native

    rows = np.ascontiguousarray(rows, dtype=np.int32)
    L, S = rows.shape
    nblk = nblocks(S)
    nvalid = np.ascontiguousarray(nvalid, dtype=np.int64)
    modes, widths, lane_bytes = analyze_host(rows, nvalid)
    lane_off = np.zeros(L, np.int64)
    np.cumsum(lane_bytes[:-1], out=lane_off[1:])
    total = int(lane_off[-1] + lane_bytes[-1]) if L else 0
    buf = np.zeros(total + PAD_BYTES, np.uint8)
    if not native.blockpack_pack(rows, nvalid, nblk, modes, widths, lane_off, buf):
        _np_pack_into(rows, nvalid, modes, widths, lane_off, buf)
    return buf, modes, widths, lane_off


def _plane_units(widths: np.ndarray, lane_off: np.ndarray):
    """Flat (block, plane) coordinates of every 8-word plane unit in the
    payload, in stream order. widths [L, NB] -> (blk_of_unit, p_of_unit).

    Derives positions purely from the widths cumsum, which is only valid
    for CONTIGUOUS lane payloads — asserted here so the numpy paths (the
    declared test oracles) can never silently mis-read a gapped/realigned
    buffer that the offset-honoring C++ path would handle correctly."""
    per_lane = widths.astype(np.int64).sum(axis=1) * 32
    want_off = np.zeros(widths.shape[0], np.int64)
    np.cumsum(per_lane[:-1], out=want_off[1:])
    if not np.array_equal(np.asarray(lane_off, np.int64), want_off):
        raise ValueError(
            "numpy blockpack path requires contiguous lane payloads "
            "(lane_off must equal the running sum of lane sizes)"
        )
    w = widths.astype(np.int64).reshape(-1)
    blk = np.repeat(np.arange(w.size, dtype=np.int64), w)
    unit0 = np.concatenate([[0], np.cumsum(w)[:-1]])
    p = np.arange(int(w.sum()), dtype=np.int64) - unit0[blk]
    return blk, p


def _np_pack_into(rows, nvalid, modes, widths, lane_off, buf):
    """Vectorized numpy bit-plane packer (fallback; also the pack oracle in
    tests). Lane payloads are contiguous (lane_off is the running sum), so
    the payload is the stream of live plane units in block order."""
    L, S = rows.shape
    nblk = widths.shape[1]
    ds, _valid = _np_transform(rows, nvalid, nblk)
    modes = np.asarray(modes)
    t = np.choose(modes[:, None], ds)
    z = _np_zigzag(t).reshape(L * nblk, 8, 32)  # [block, group, i]
    blk, p = _plane_units(widths, lane_off)
    if blk.size == 0:
        return
    # Plane unit (blk, p): word g = sum_i ((z[blk, g, i] >> p) & 1) << i.
    zb = z[blk]  # [NU, 8, 32]
    bits = (zb >> p[:, None, None].astype(np.uint32)) & np.uint32(1)
    units = (bits << np.arange(32, dtype=np.uint32)[None, None, :]).sum(
        axis=2, dtype=np.uint32
    )  # [NU, 8]
    payload = units.astype("<u4").tobytes()
    buf[: len(payload)] = np.frombuffer(payload, np.uint8)


def unpack_host(buf, modes, widths, lane_off, nvalid, S: int) -> np.ndarray:
    """Host inverse of pack_host -> [L, S] int32 (zeros past nvalid).
    C++ fast path; vectorized numpy fallback (also the test oracle)."""
    from .. import native

    L, nblk = widths.shape
    nvalid = np.ascontiguousarray(nvalid, dtype=np.int64)
    out = native.blockpack_unpack(
        np.ascontiguousarray(buf, np.uint8),
        np.ascontiguousarray(lane_off, np.int64),
        np.ascontiguousarray(modes, np.uint8),
        np.ascontiguousarray(widths, np.uint8),
        nvalid, S,
    )
    if out is not None:
        return out
    buf = np.ascontiguousarray(buf, np.uint8)
    blk, p = _plane_units(widths, lane_off)
    NBT = L * nblk
    win = np.zeros((NBT, 32, 8), np.uint32)
    if blk.size:
        units = (
            buf[: blk.size * 32]
            .view("<u4")
            .reshape(-1, 8)
            .astype(np.uint32)
        )
        win[blk, p] = units
    # z[b, 32q+i] = sum_p ((win[b, p, q] >> i) & 1) << p
    z = np.zeros((NBT, 8, 32), np.uint32)
    i = np.arange(32, dtype=np.uint32)[None, None, :]
    for pp in range(32):
        z |= (((win[:, pp, :, None] >> i) & np.uint32(1)) << np.uint32(pp))
    z = z.reshape(L, nblk * BLK)[:, :S]
    v = ((z >> 1) ^ (-(z & 1)).astype(np.uint32)).view(np.int32)
    sums = [v]
    for _ in range(4):
        sums.append(np.cumsum(sums[-1], axis=1, dtype=np.int32))
    modes = np.asarray(modes)
    out = np.choose(modes[:, None], sums)
    return np.where(np.arange(S)[None, :] < nvalid[:, None], out, 0)


# ---------------------------------------------------------------------------
# Device half (traced jnp — call inside jit).
# ---------------------------------------------------------------------------


def _exclusive_cumsum(x, axis):
    c = jnp.cumsum(x, axis=axis)
    return c - x


def _bit_transpose32(R):
    """Vectorized 32x32 bit-matrix transpose over the LAST axis (= 32 rows
    of u32): bit p of row i lands at row 31-p, bit 31-i (same orientation
    as native/blockpack.cpp transpose32). 5 masked-swap steps, pure
    elementwise + reshapes — no large intermediates, unlike a 4-D
    bit-reduction, whose [*, 32, 8, 32] operand costs ~2.7 GB of device
    memory per bulk chunk and stalls the overlapped pipelines."""
    m = jnp.uint32(0x0000FFFF)
    j = 16
    shape = R.shape
    while j:
        Rr = R.reshape(shape[:-1] + (32 // (2 * j), 2, j))
        a = Rr[..., 0, :]
        b = Rr[..., 1, :]
        t = (a ^ (b >> j)) & m
        R = jnp.stack([a ^ t, b ^ (t << j)], axis=-2).reshape(shape)
        j >>= 1
        if j:
            m = m ^ (m << jnp.uint32(j))
    return R


def _codes_to_planes(z):
    """[N, 8, 32] zigzag codes (group g, code i) -> plane words [N, 32, 8]
    (plane p, group g): pw[n, p, g] bit i == bit p of z[n, g, 32g+i]."""
    T = _bit_transpose32(jnp.flip(z, axis=-1))
    return jnp.swapaxes(jnp.flip(T, axis=-1), -1, -2)


def _planes_to_codes(pw):
    """Inverse of _codes_to_planes: [N, 32, 8] plane words -> [N, 8, 32]
    codes. Plane rows past a block's width must be zero (they are, both in
    the wire format and in the scatter-built window)."""
    R = jnp.flip(jnp.swapaxes(pw, -1, -2), axis=-1)
    return jnp.flip(_bit_transpose32(R), axis=-1)


def pack_rows_stage1(rows, nvalid):
    """Device pack, phase 1 (download direction): [L, S] int32 -> bit-plane
    blocks in the same wire format pack_host emits, so the host inverse is
    the SAME C++ parser both directions use (native blockpack_unpack*).

    Returns (stage dict for :func:`pack_rows_stage2`, modes i32 [L],
    widths u8 [L, NB], lane_bytes i32 [L], lane_off i32 [L]).

    Everything here is elementwise/reduction arithmetic: widths via block
    max + clz, planes via a fused 32-step shift/mask reduction (plane p of
    a width-w block is all zeros for p >= w, which stage 2 exploits).
    Replaces the blockspread fixed-width spread for PCM downloads: its
    stage-2 word-domain gather took one index per OUTPUT WORD; the
    bit-plane stage 2 gathers 8-word units instead (payload/32 indices).
    """
    L, S = rows.shape
    NB = nblocks(S)
    Spad = NB * BLK
    j = jnp.arange(Spad, dtype=jnp.int32)
    valid = j[None, :] < nvalid.astype(jnp.int32)[:, None]
    vpad = rows if Spad == S else jnp.pad(rows, ((0, 0), (0, Spad - S)))
    v = jnp.where(valid, vpad, 0).astype(jnp.int32)
    # 1st..4th differences over the unmasked previous order (prefix-valid
    # lanes make the chains match the C++ streaming state), masked after.
    diffs = [v]
    for _ in range(4):
        d = diffs[-1]
        diffs.append(d - jnp.pad(d, ((0, 0), (1, 0)))[:, :Spad])
    diffs = [jnp.where(valid, d, 0) for d in diffs]

    def zig(x):
        return ((x << 1) ^ (x >> 31)).astype(jnp.uint32)

    def wblk(z):
        m = z.reshape(L, NB, BLK).max(axis=2)
        return jnp.where(
            m == 0, 0, 32 - jax.lax.clz(jax.lax.bitcast_convert_type(m, jnp.int32))
        )

    zs = [zig(d) for d in diffs]
    ws = [wblk(z) for z in zs]
    sizes = jnp.stack([w.sum(axis=1) for w in ws])  # [5, L]
    modes = jnp.argmin(sizes, axis=0).astype(jnp.int32)  # first-min tiebreak
    # Elementwise where-chain select (no [5, L, Spad] stack in HBM).
    w = ws[0]
    z = zs[0]
    for k in range(1, 5):
        mk = (modes == k)[:, None]
        w = jnp.where(mk, ws[k], w)
        z = jnp.where(mk, zs[k], z)

    # Plane production = the vectorized 32x32 bit transpose (the same
    # algorithm the C++ half uses). Two rejected alternates, measured: an
    # unrolled 32-step reduce loop never finishes the remote compile, and
    # a single 4-D masked reduction materializes a [NBT, 32, 8, 32]
    # operand (~2.7 GB/chunk) that collapses the overlapped headline pass.
    pw = _codes_to_planes(z.reshape(L * NB, 8, 32))  # [NBT, 32, 8]

    lane_bytes = 32 * w.sum(axis=1)
    lane_off = _exclusive_cumsum(lane_bytes, 0)
    stage = {"pw": pw, "widths_i32": w, "lane_off_i32": lane_off}
    return stage, modes, w.astype(jnp.uint8), lane_bytes, lane_off


#: Worst-case bit width per code for the PCM download direction: decoded
#: PCM is i16 by format, and the widest candidate the analyzer may PICK is
#: the 4th difference, |d4| <= 2^4 * 32768 = 2^19 -> zigzag < 2^20, 20 bits.
#: A corrupt stream can exceed this (reconstruction garbage) — callers fall
#: back to the entropy-bucketed two-phase path when the payload overflows.
PCM_WORST_BITS = 20


def pack_worst_words_pcm(L: int, S: int) -> int:
    """Static u32 word bound for pack_rows of an [L, S] i16-PCM batch."""
    return max(L * nblocks(S) * PCM_WORST_BITS * 8, 8)


def pack_rows_fused(rows, nvalid):
    """Single-phase device pack (download direction): stage 1 + the unit
    compaction at the static PCM worst-case bucket, in one program — no
    inter-stage size download on the device stream (see
    ops/blockspread.pack_worst_words).

    Returns (stage, words, modes, widths u8, lane_bytes i32, lane_off i32);
    `words` covers the payload whenever every block's width fits
    PCM_WORST_BITS (always, for spec-valid i16 PCM). Callers check
    ``total <= words.size * 4`` and redispatch :func:`pack_rows_stage2` at
    an entropy-sized bucket from `stage` otherwise (corrupt-stream route).
    """
    L, S = rows.shape
    stage, modes, widths, lane_bytes, lane_off = pack_rows_stage1(rows, nvalid)
    words = pack_rows_stage2(NW=pack_worst_words_pcm(L, S), **stage)
    return stage, words, modes, widths, lane_bytes, lane_off


@partial(jax.jit, static_argnames=("NW",))
def pack_rows_stage2(pw, widths_i32, lane_off_i32, NW: int):
    """Device pack, phase 2: compact the live plane units into the
    contiguous payload at a bucketed size (static NW u32 words, multiple
    of 8). Callers download the (tiny) lane sizes after stage 1 and pick
    NW from the actual payload instead of the worst case.

    The only indexed op is one destination-side row gather: payload unit u
    arithmetically knows its (block, plane) via two per-block delta
    scatters + unit-domain cumsums (blocks tile the payload; zero-width
    blocks telescope). Units past the payload read plane rows >= the
    block's width, which are identically zero. The downloaded u32 buffer's
    little-endian host layout IS the byte stream (no byteswap pass).
    """
    NBT = pw.shape[0]
    NUo = NW // 8
    unit0 = (lane_off_i32 >> 5)[:, None] + _exclusive_cumsum(widths_i32, 1)
    u0f = unit0.reshape(-1)
    pos = jnp.minimum(u0f, NUo)
    bid = jnp.arange(NBT, dtype=jnp.int32)
    dB = bid - jnp.concatenate([jnp.zeros(1, jnp.int32), bid[:-1]])
    dU = u0f - jnp.concatenate([jnp.zeros(1, jnp.int32), u0f[:-1]])
    seedB = jnp.zeros((NUo,), jnp.int32).at[pos].add(
        dB, mode="drop", indices_are_sorted=True
    )
    seedU = jnp.zeros((NUo,), jnp.int32).at[pos].add(
        dU, mode="drop", indices_are_sorted=True
    )
    blk_of_unit = jnp.cumsum(seedB)
    p_of_unit = jnp.arange(NUo, dtype=jnp.int32) - jnp.cumsum(seedU)
    src = blk_of_unit * 32 + jnp.clip(p_of_unit, 0, 31)
    units = jnp.take(
        pw.reshape(NBT * 32, 8), jnp.clip(src, 0, NBT * 32 - 1), axis=0
    )
    return units.reshape(NW)


def unpack_f32_into(
    buf, modes, widths, lane_off, nvalid, S: int,
    out_base, out_step: int, scale: float, out: np.ndarray,
) -> None:
    """Fused decode finalizer for the bit-plane download: parse the plane
    stream and write f32 interleaved samples in ONE host pass — lane l's
    sample j lands at ``out[out_base[l] + j*out_step]`` scaled by
    ``scale``; ``out_base < 0`` skips the lane without parsing (pre-roll
    frames, mesh padding). C++ fast path; numpy fallback via unpack_host.
    """
    from .. import native

    modes = np.ascontiguousarray(modes, np.uint8)
    widths = np.ascontiguousarray(widths, np.uint8)
    lane_off = np.ascontiguousarray(lane_off, np.int64)
    nvalid = np.ascontiguousarray(nvalid, np.int64)
    out_base = np.ascontiguousarray(out_base, np.int64)
    if isinstance(buf, np.ndarray):
        buf = np.ascontiguousarray(buf.view(np.uint8))
    else:
        buf = np.frombuffer(buf, np.uint8)
    if native.blockpack_unpack_f32(
        buf, lane_off, modes, widths, nvalid,
        out_base, int(out_step), float(scale), out,
    ):
        return
    rows = unpack_host(buf, modes, widths, lane_off, nvalid, S)
    step = int(out_step)
    for l in range(rows.shape[0]):
        b = int(out_base[l])
        if b < 0:
            continue
        n = int(nvalid[l])
        out[b : b + n * step : step] = (
            rows[l, :n].astype(np.float32) * np.float32(scale)
        )


def unpack_rows(buf, modes, widths, lane_off, nvalid, S: int, kmax: int = 4):
    """Device inverse of pack_host -> [L, S] int32 (zeros past nvalid).

    buf: [B] u8 (>= total + PAD_BYTES, B a multiple of 32); widths: [L, NB]
    u8 (NB covers S); modes: [L]; lane_off: [L] byte offsets; nvalid: [L].

    kmax (STATIC): highest difference order present in `modes`. The host
    packer knows it at dispatch (``int(modes.max())``), and each difference
    order costs one [L, S] cumsum pass here — residual uploads rarely pick
    order > 2 (every lane picked 2 on corpus content).
    Bounded compile variants: kmax in 0..4.

    NO indexed scatter anywhere — the whole unpack is one aligned bit
    transpose plus two block-row gathers:

    1. View the payload as ALIGNED TILES of 32 consecutive 8-word plane
       units and inverse-bit-transpose every tile in place (pure vector
       arithmetic over the payload — compressed size, not window size):
       ``Ttile[t, g, i]`` bit r == bit i of unit ``32t+r``'s word g.
    2. A block whose first unit sits at ``u0 = 32*t0 + s`` owns plane p's
       bits at tile-transposed bit position ``s+p`` — i.e. its codes are
       ``(Ttile[t0] >> s) | (Ttile[t0+1] << (32-s))`` masked to its width
       (bits >= w belong to later blocks; bits < s were earlier blocks').
       Two row gathers (1 KB rows, one index per BLOCK — payload/1024
       bytes of indices) replace the previous per-unit row SCATTER into a
       padded [NBT, 32, 8] window, which at ~88 ns/scatter-index cost
       ~81 ms per 29 MB bulk chunk — 87% of the whole unpack
       (tools/decode_decompose.py DCE breakdown, r3). PAD_BYTES = 1024 is
       exactly one tile, so ``t0+1`` is always in bounds for live blocks;
       for dead/tail blocks the width mask zeroes whatever was read.

    (Alternatives measured on this chip and rejected: per-unit row scatter
    into the padded window, 81 ms/chunk as above; per-word delta scatter +
    flat cumsum ~196 ms; a vmap(dynamic_slice) per-block window gather,
    which XLA unrolls into a >100 MB binary with 0.1-2.4 s dispatch; and
    4-D bit reductions, whose giant operands stall the overlapped bulk
    pass — tools/gather_microbench.py / decode_decompose.py.)
    """
    L, NB = widths.shape
    NBT = L * NB
    Sp = NB * BLK
    NT = buf.shape[0] // 1024  # aligned 32-unit tiles (PAD_BYTES = 1 tile)
    W32 = jax.lax.bitcast_convert_type(
        buf[: NT * 1024].reshape(NT, 32, 8, 4), jnp.uint32
    )  # [tile, unit-in-tile, group word, LE bytes]
    # Same planes->codes orientation as the window path: bit r of
    # Ttile[t, g, i] == bit i of payload unit (32t+r)'s word g.
    Ttile = _planes_to_codes(W32)  # [NT, 8, 32]

    w = widths.astype(jnp.int32)
    # First plane unit of each block: lane byte offset / 32 + widths cumsum.
    unit0 = (lane_off.astype(jnp.int32) >> 5)[:, None] + _exclusive_cumsum(w, 1)
    u0f = unit0.reshape(-1)
    t0 = jnp.clip(u0f >> 5, 0, NT - 1)
    s = (u0f & 31).astype(jnp.uint32)[:, None, None]
    T0 = jnp.take(Ttile, t0, axis=0)  # [NBT, 8, 32]
    T1 = jnp.take(Ttile, jnp.minimum(t0 + 1, NT - 1), axis=0)
    hi = jnp.where(
        s > 0, T1 << ((jnp.uint32(32) - s) & jnp.uint32(31)), jnp.uint32(0)
    )
    wf = w.reshape(-1)
    mask = jnp.where(
        wf >= 32,
        jnp.uint32(0xFFFFFFFF),
        (jnp.uint32(1) << jnp.minimum(wf, 31).astype(jnp.uint32)) - 1,
    )[:, None, None]
    z = (((T0 >> s) | hi) & mask).reshape(L, Sp)[:, :S]

    v = ((z >> 1) ^ (-(z & 1).astype(jnp.int32)).astype(jnp.uint32)).astype(jnp.int32)
    out = v
    acc = v
    for k in range(1, kmax + 1):
        acc = jnp.cumsum(acc, axis=1, dtype=jnp.int32)
        out = jnp.where((modes == k)[:, None], acc, out)
    valid = jnp.arange(S, dtype=jnp.int32)[None, :] < nvalid.astype(jnp.int32)[:, None]
    return jnp.where(valid, out, 0)
