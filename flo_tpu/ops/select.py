"""Fused lossless candidate search: one jitted program from lanes to winners.

Computes, for every (lane, candidate): exact int32-limb residuals, selection
aggregates, the exact Rice parameter (rice.rs:29-69 in pure int32), the
encoded byte size at that k, then argmin selection in the reference's
evaluation order (strict-<, encoder.rs:173-217) and the winning lane's
residual stream — all inside a single XLA program, so it shards over a batch
mesh with no host round-trips.

Exactness notes (also see lossless/encoder.py):
* Valid candidates have |r| < 2^22 (fixed: <= 16*65535 in the mid/side
  domain; accepted LPC: <= 1e6), so the clamped split-limb sums and the
  two-step integer mean are exact for every candidate that can win.
* Bit length is computed with 24 integer comparisons — no float logs.
* Unreachable pathology: a candidate whose every residual is i32::MIN would
  be rejected here (max_abs < 0) where the reference would keep it with
  k=15; real Levinson output cannot produce it.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import lpc
from .intmath import dot_f32, predict_shift, predict_shift_taps

_SUM_SPLIT = 11  # Σ|r| limb split; exact for S < 2^(31-11) samples per frame
_ABS_CLAMP = 1 << 22  # above any valid candidate's |r|


def residuals_one(lanes, nvalid, coeffs, shifts, orders, is_fixed):
    """Masked residuals [L, S] for one candidate per lane.

    Main region uses the stored coefficients; the <=12-sample warm-up prefix
    is fixed up separately: LPC emits samples verbatim (lpc.rs:283-285), fixed
    predictors ramp through orders 0..min(i,4) (lpc.rs:301-359).
    """
    L, S = lanes.shape
    pred = predict_shift_taps(lanes, coeffs, shifts[:, None])
    r = lanes - pred

    P = min(lpc.MAX_ORDER, S)
    prefix = lanes[:, :P]
    lag_pref = jnp.stack(
        [jnp.pad(prefix, ((0, 0), (j + 1, 0)))[:, :P] for j in range(lpc.MAX_ORDER)],
        axis=-1,
    )  # [L, P, 12]
    fixed_table = jnp.asarray(lpc._FIXED_COEFFS)
    i_idx = jnp.arange(P, dtype=jnp.int32)
    ramp_rows = fixed_table[jnp.minimum(i_idx, 4)]  # [P, 12]
    pred_ramp = predict_shift(ramp_rows[None, :, :], lag_pref, jnp.int32(0))
    in_warmup = i_idx[None, :] < orders[:, None]
    r_pref = jnp.where(
        in_warmup,
        jnp.where(is_fixed[:, None], prefix - pred_ramp, prefix),
        r[:, :P],
    )
    r = jnp.concatenate([r_pref, r[:, P:]], axis=1)
    valid = jnp.arange(S, dtype=jnp.int32)[None, :] < nvalid[:, None]
    return jnp.where(valid, r, 0)


def _bit_length(x):
    """Exact integer bit length for x in [0, 2^24) (int32)."""
    x = x.astype(jnp.int32)
    bits = jnp.zeros_like(x)
    for k in range(24):
        bits = bits + (x >= (1 << k)).astype(jnp.int32)
    return bits


def rice_k_exact(max_abs, sum_hi, sum_lo, nvalid):
    """rice.rs:29-69 in int32: k = clamp(max(min_k, mean_k), 0, 15)."""
    n = jnp.maximum(nvalid, 1)
    max_u2 = 2 * jnp.clip(max_abs, 0, _ABS_CLAMP)
    min_k = jnp.where(max_u2 > 255, jnp.maximum(_bit_length(max_u2) - 8, 0), 0)

    # Exact mean of the split-limb sum: total = hi*2^s + lo.
    q1 = sum_hi // n
    r1 = sum_hi - q1 * n
    mean = q1 * (1 << _SUM_SPLIT) + ((r1 * (1 << _SUM_SPLIT) + sum_lo) // n)
    mean_k = _bit_length(mean)

    k = jnp.clip(jnp.maximum(min_k, mean_k), 0, 15)
    return jnp.where(max_abs == 0, 0, k)


def _zigzag_u32(r):
    z = (r << 1) ^ (r >> 31)
    return jax.lax.bitcast_convert_type(z, jnp.uint32)


def residuals_approx(lanes_f, nvalid, coeffs, shifts, orders, is_fixed):
    """f32 approximation of :func:`residuals_one`, for selection stats only.

    pred = floor(Σ c_j x_{i-j-1} / 2^shift) in f32: products reach ~2^32, so
    the accumulated absolute error is ≲ 3000 pre-shift → r is off by at most
    ±1, and only on large-amplitude content where k is large and an
    off-by-one never moves a code across a Rice bucket that matters. The
    winner's residuals, k and size are re-derived exactly after selection
    (see encode_select_step), so only the *choice* between near-tied
    candidates can drift — the same marginal drift this device path already
    documents for its f32 Levinson analysis. ~6x fewer vector ops per
    candidate than the exact int32-limb path.
    """
    L, S = lanes_f.shape
    acc = jnp.zeros_like(lanes_f)
    for t in range(lpc.MAX_ORDER):
        xlag = jnp.pad(lanes_f, ((0, 0), (t + 1, 0)))[:, :S]
        acc = acc + coeffs[:, t : t + 1].astype(jnp.float32) * xlag
    pred = jnp.floor(acc * jnp.exp2(-shifts[:, None].astype(jnp.float32)))
    r = lanes_f - pred

    # Warm-up prefix (<= 12 samples): LPC emits samples verbatim, fixed
    # predictors ramp through orders 0..min(i,4). Products here are small
    # (|coeff| <= 4), so the f32 ramp is exact.
    P = min(lpc.MAX_ORDER, S)
    prefix = lanes_f[:, :P]
    fixed_table = jnp.asarray(lpc._FIXED_COEFFS, dtype=jnp.float32)
    i_idx = jnp.arange(P, dtype=jnp.int32)
    ramp_rows = fixed_table[jnp.minimum(i_idx, 4)]  # [P, 12]
    pred_ramp = jnp.zeros_like(prefix)
    for t in range(lpc.MAX_ORDER):
        xlag = jnp.pad(prefix, ((0, 0), (t + 1, 0)))[:, :P]
        pred_ramp = pred_ramp + ramp_rows[None, :, t] * xlag
    in_warmup = i_idx[None, :] < orders[:, None]
    r_pref = jnp.where(
        in_warmup,
        jnp.where(is_fixed[:, None], prefix - pred_ramp, prefix),
        r[:, :P],
    )
    r = jnp.concatenate([r_pref, r[:, P:]], axis=1)
    valid = jnp.arange(S, dtype=jnp.int32)[None, :] < nvalid[:, None]
    return jnp.where(valid, r, 0.0)


def candidate_size_approx(r_f, nvalid):
    """(max_abs, k, size_bytes) from f32 residuals (selection stats only).

    The residuals are whole numbers; clamped, they convert to int32 exactly
    and every sum below is an integer sum, which no reduction order changes.
    """
    a = jnp.minimum(jnp.abs(r_f), jnp.float32(_ABS_CLAMP)).astype(jnp.int32)
    max_abs = jnp.max(a, axis=1)
    sum_hi = jnp.sum(a >> _SUM_SPLIT, axis=1, dtype=jnp.int32)
    sum_lo = jnp.sum(a & ((1 << _SUM_SPLIT) - 1), axis=1, dtype=jnp.int32)
    k = rice_k_exact(max_abs, sum_hi, sum_lo, nvalid)

    # |zigzag| = 2|r| - (r < 0).
    u = 2 * a - (r_f < 0).astype(jnp.int32)
    q = jnp.minimum(
        jax.lax.shift_right_logical(jnp.maximum(u, 0), k[:, None]), 255
    )
    qsum = jnp.sum(q, axis=1, dtype=jnp.int32)
    bits = qsum + nvalid * (1 + k)
    return max_abs, k, (bits + 7) >> 3


def candidate_size(r, nvalid):
    """(max_abs, k, size_bytes) for one candidate's masked residuals [L, S].

    max_abs wraps at i32::MIN exactly like Rust release `.abs()`; k is the
    exact Rice estimate; size is the exact encoded byte count at k.
    """
    a_wrap = jnp.abs(r)
    max_abs = jnp.max(a_wrap, axis=1)
    a = jnp.minimum(a_wrap, _ABS_CLAMP)
    a = jnp.where(a < 0, _ABS_CLAMP, a)
    sum_hi = jnp.sum(a >> _SUM_SPLIT, axis=1, dtype=jnp.int32)
    sum_lo = jnp.sum(a & ((1 << _SUM_SPLIT) - 1), axis=1, dtype=jnp.int32)
    k = rice_k_exact(max_abs, sum_hi, sum_lo, nvalid)

    u = _zigzag_u32(r)
    q = jnp.minimum(u >> k[:, None].astype(jnp.uint32), jnp.uint32(255)).astype(jnp.int32)
    qsum = jnp.sum(q, axis=1, dtype=jnp.int32)
    bits = qsum + nvalid * (1 + k)
    return max_abs, k, (bits + 7) >> 3


@partial(jax.jit, static_argnames=("is_lpc",))
def encode_select_step(
    lanes, nvalid, coeffs_all, shifts_all, orders_all, fixed_all, cand_ok, is_lpc: tuple
):
    """Full candidate search on device.

    Args: lanes [L, S] i32; nvalid [L]; candidate tables [L, NC, ...];
    cand_ok [L, NC] host-known validity (Levinson success, n > order);
    is_lpc: static per-candidate flags; candidate 0 MUST be the raw-PCM
    baseline (its size is 2*nvalid; other table rows for it are ignored).

    Returns (sel [L], k [L], size_bytes [L], residuals [L, S] for the
    winner — raw winners' rows are their verbatim samples, since candidate 0
    has zero coefficients/order).

    The candidate axis runs as a `lax.scan` (identical per-candidate body),
    keeping the compiled graph one-candidate-sized — the Python-unrolled
    version took minutes to compile.
    """
    NC = coeffs_all.shape[1]
    L = lanes.shape[0]
    lpc_mask = jnp.asarray(np.array(is_lpc, dtype=bool))

    xs = (
        jnp.moveaxis(coeffs_all, 1, 0),  # [NC, L, 12]
        jnp.moveaxis(shifts_all, 1, 0),
        jnp.moveaxis(orders_all, 1, 0),
        jnp.moveaxis(fixed_all, 1, 0),
        jnp.moveaxis(cand_ok, 1, 0),
        lpc_mask,
        jnp.arange(NC, dtype=jnp.int32),
    )

    lanes_f = lanes.astype(jnp.float32)

    def body(carry, x):
        best_size, best_ci = carry
        c, sh, od, fx, ok, islpc, ci = x
        r = residuals_approx(lanes_f, nvalid, c, sh, od, fx)
        max_abs, k, size = candidate_size_approx(r, nvalid)
        stable = max_abs <= 1_000_000  # encoder.rs:269-271 (f32 can't wrap)
        ok = ok & jnp.where(islpc, stable, True) & (ci > 0)
        better = ok & (size < best_size)
        return (
            jnp.where(better, size, best_size),
            jnp.where(better, ci, best_ci),
        ), None

    init = (2 * nvalid, jnp.zeros((L,), jnp.int32))
    (_, best_ci), _ = jax.lax.scan(body, init, xs)

    # The winner's residuals, Rice k and byte size are re-derived with the
    # exact int32-limb path: the scan's f32 stats steer only the CHOICE
    # between candidates, never the emitted bytes (lossless/encoder.py's
    # packer-size assertion depends on these being exact). A winner whose
    # EXACT size is not strictly below the raw baseline is demoted to raw
    # (the reference's strict-< keeps raw on ties) — this both removes the
    # one way f32 drift could worsen a lane beyond raw and restores the
    # hard <=16-bits/sample bound that sizes the fused pack's static word
    # bucket (pack_worst_words).
    take = lambda t: jnp.take_along_axis(t, best_ci[:, None], axis=1)[:, 0]
    win_c = jnp.take_along_axis(coeffs_all, best_ci[:, None, None], axis=1)[:, 0]
    win_shift = take(shifts_all)
    residuals = residuals_one(
        lanes, nvalid, win_c, win_shift, take(orders_all), take(fixed_all)
    )
    _, k_w, size_w = candidate_size(residuals, nvalid)
    demote = (best_ci != 0) & (size_w >= 2 * nvalid)
    best_ci = jnp.where(demote, 0, best_ci)
    win_c = jnp.where(demote[:, None], 0, win_c)
    win_shift = jnp.where(demote, 0, win_shift)
    valid = jnp.arange(lanes.shape[1], dtype=jnp.int32)[None, :] < nvalid[:, None]
    residuals = jnp.where(demote[:, None], jnp.where(valid, lanes, 0), residuals)
    is_raw_win = best_ci == 0
    best_k = jnp.where(is_raw_win, 0, k_w)
    best_size = jnp.where(is_raw_win, 2 * nvalid, size_w)
    return best_ci, best_k, best_size, residuals, win_c, win_shift


def _lanes_from_pcm16(pcm16, mid_side):
    """[F, C, S] i16 PCM + per-frame mid/side flags -> [F*C, S] i32 lanes
    (exact int32 math on device)."""
    F, C, S = pcm16.shape
    p = pcm16.astype(jnp.int32)
    if C == 2:
        mid = p[:, 0] + p[:, 1]
        side = p[:, 0] - p[:, 1]
        p = jnp.where(mid_side[:, None, None], jnp.stack([mid, side], axis=1), p)
    return p.reshape(F * C, S)


def _transport_outputs(sel, k, size, residuals, win_c, win_shift, nvalid):
    """Pack every winner's wire payload ON DEVICE (ops/blockspread.py): Rice
    streams for selected candidates, verbatim LE16 for raw winners. The host
    downloads only the packed bytes + tiny per-lane tables — entropy-coded
    size instead of full i16 residual tensors (the round-1 wire bottleneck).

    SINGLE-phase: the whole pack (stage 1 spread+merge AND the stage 2 word
    assembly at the static 16-bit/sample worst-case bucket) runs inside the
    dispatch program. The earlier two-phase split (download exact sizes,
    dispatch stage 2 at an entropy-sized bucket) was built for the v2
    packer, whose per-word assembly made worst-case sizing costly; the v3
    assembly costs little bucket slack, while the inter-stage size download
    puts a device->host read on the device stream. The caller still
    downloads the lane sizes — but only to size the payload fetch, off the
    device stream.

    The device-resident residual tensor rides along for the host's exact
    re-pack of `bad` lanes (patch-capacity overflow, blockspread.PATCH_CAP).
    """
    from .blockspread import pack_stage1, pack_stage2, pack_worst_words

    L, S = residuals.shape
    stage, lane_bytes, lane_off, bad = pack_stage1(residuals, k, nvalid, sel == 0)
    words = pack_stage2(NW=pack_worst_words(L, S), **stage)
    return sel, k, size, words, lane_bytes, lane_off, bad, residuals, win_c, win_shift


@partial(jax.jit, static_argnames=("is_lpc",))
def encode_select_pcm16(
    pcm16, mid_side, nvalid_f, coeffs_all, shifts_all, orders_all, fixed_all,
    cand_ok, is_lpc: tuple
):
    """Transport-optimized candidate search.

    Takes i16 PCM [F, C, S] + per-frame mid/side flags (halving the upload vs
    i32 mid/side lanes) and returns the winners' wire payloads as one packed
    byte buffer (see _transport_outputs) plus per-lane selection tables.
    """
    C = pcm16.shape[1]
    lanes = _lanes_from_pcm16(pcm16, mid_side)
    nvalid = jnp.repeat(nvalid_f.astype(jnp.int32), C)
    out = encode_select_step(
        lanes, nvalid, coeffs_all, shifts_all, orders_all, fixed_all, cand_ok, is_lpc
    )
    return _transport_outputs(*out, nvalid)


@partial(jax.jit, static_argnames=("kinds", "cand_orders"))
def encode_select_device(pcm16, nvalid_f, kinds: tuple, cand_orders: tuple):
    """Fully-on-device candidate search: the mid/side decision,
    autocorrelation, and Levinson-Durbin all run on device (f32), so the
    host does ZERO analysis work.

    The f32 math may propose slightly different coefficients (and flip
    borderline mid/side decisions) vs the exact host path
    (lossless/encoder.py) — round-trips stay bit-exact because both the
    coefficients and the mid/side flag are stored in the stream; only
    compression ratio can drift marginally. kinds/cand_orders: the static
    candidate plan (lossless/encoder._candidate_plan), candidate 0 = raw.

    Returns the usual transport outputs plus the mid/side flags [F].
    """
    F, C, S = pcm16.shape
    return _select_device_core(
        pcm16.astype(jnp.int32), nvalid_f, kinds, cand_orders
    )


@partial(jax.jit, static_argnames=("kinds", "cand_orders", "C", "S"))
def encode_select_packed(buf, modes, widths, lane_off, nvalid_f,
                         kinds: tuple, cand_orders: tuple, C: int, S: int):
    """encode_select_device fed by a block-packed PCM UPLOAD: the host ships
    ops/blockpack.pack_host's buffer (compressed size) instead of an i16
    tensor, and the device recovers the [F, C, S] PCM lanes scan-free
    (ops/blockpack.unpack_rows) before running the same candidate search.
    """
    from .blockpack import unpack_rows

    F = nvalid_f.shape[0]
    nv_lane = jnp.repeat(nvalid_f.astype(jnp.int32), C)
    pcm = unpack_rows(buf, modes, widths, lane_off, nv_lane, S)
    return _select_device_core(pcm.reshape(F, C, S), nvalid_f, kinds, cand_orders)


def _select_device_core(p, nvalid_f, kinds: tuple, cand_orders: tuple):
    """Shared body: [F, C, S] int32 PCM -> transport outputs + mid/side."""
    F, C, S = p.shape
    if C == 2:
        # Exact integer sums (intmath.dot_f32): the decision, like the
        # coefficients below, must not depend on the batch or shard shape.
        l, r = p[:, 0], p[:, 1]
        var_l = dot_f32(l, l)
        var_r = dot_f32(r, r)
        var_side = dot_f32(l - r, l - r)
        mid_side = var_side < (var_l + var_r) * 0.5
        mid = p[:, 0] + p[:, 1]
        sid = p[:, 0] - p[:, 1]
        p = jnp.where(mid_side[:, None, None], jnp.stack([mid, sid], axis=1), p)
    else:
        mid_side = jnp.zeros((F,), bool)
    lanes = p.reshape(F * C, S)
    nvalid = jnp.repeat(nvalid_f.astype(jnp.int32), C)
    L = lanes.shape[0]
    NC = len(kinds)

    max_order = max(
        (o for kd, o in zip(kinds, cand_orders) if kd == "lpc"), default=0
    )
    coeffs_all = jnp.zeros((L, NC, lpc.MAX_ORDER), jnp.int32)
    shifts_all = jnp.zeros((L, NC), jnp.int32)
    orders_all = jnp.zeros((L, NC), jnp.int32)
    fixed_all = jnp.zeros((L, NC), bool)
    cand_ok = jnp.ones((L, NC), bool)

    if max_order > 0:
        ac = lpc.autocorrelation_device(lanes, nvalid, max_order)
        lc, ls, lv = lpc.levinson_device(ac, max_order)
    for ci, (kd, o) in enumerate(zip(kinds, cand_orders)):
        if kd == "fixed":
            coeffs_all = coeffs_all.at[:, ci, :].set(jnp.asarray(lpc._FIXED_COEFFS[o]))
            orders_all = orders_all.at[:, ci].set(o)
            fixed_all = fixed_all.at[:, ci].set(True)
        elif kd == "lpc":
            coeffs_all = coeffs_all.at[:, ci].set(lc[:, o - 1])
            shifts_all = shifts_all.at[:, ci].set(ls[:, o - 1])
            orders_all = orders_all.at[:, ci].set(o)
            cand_ok = cand_ok.at[:, ci].set(lv[:, o - 1] & (nvalid > o))

    is_lpc = tuple(kd == "lpc" for kd in kinds)
    out = encode_select_step(
        lanes, nvalid, coeffs_all, shifts_all, orders_all, fixed_all, cand_ok, is_lpc
    )
    return _transport_outputs(*out, nvalid) + (mid_side,)


@partial(jax.jit, static_argnames=())
def gather_rows(arr, idx):
    """Tiny follow-up fetch of specific rows (misfit lanes)."""
    return jnp.take(arr, idx, axis=0)
