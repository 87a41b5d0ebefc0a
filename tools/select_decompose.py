#!/usr/bin/env python
"""Decompose encode_select_device's device time into its stages.

Times, on device-resident input at the bench's device_kernels geometry
([120, 2, 44100] i16 -> L=240 lanes):

  full        encode_select_device (analysis + scan + winner + pack)
  analysis    mid/side + autocorrelation + Levinson only
  scan        encode_select_step's candidate scan only (tables precomputed)
  winner      one residuals_one pass (the winner rematerialization)
  onecand     residuals_one + candidate_size for a single candidate
  pack1       blockspread.pack_stage1 (candidate-independent spread)
  pack2       blockspread.pack_stage2 at the entropy-sized bucket

Prints one line per stage: name, hot ms/call, implied audio-sec/sec.
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

F, C, S = 120, 2, 44100
RATE = 44100


def main():
    import jax
    import jax.numpy as jnp

    from flo_tpu import compile_cache

    compile_cache.configure()

    from flo_tpu.ops import lpc
    from flo_tpu.ops.select import (
        encode_select_device,
        encode_select_step,
        residuals_one,
        candidate_size,
    )
    from flo_tpu.ops import blockspread

    dev = jax.devices()[0]
    print("device:", dev, flush=True)
    audio_sec = F * S / RATE  # 120 audio-seconds

    rng = np.random.default_rng(0)
    # Corpus-like content: tones + mild noise, 16-bit range.
    t = np.arange(F * S) / RATE
    sig = 20000 * np.sin(2 * np.pi * 261.6 * t) + 6000 * np.sin(2 * np.pi * 329.6 * t)
    sig += 300 * rng.standard_normal(sig.shape)
    pcm = np.stack(
        [sig.astype(np.int16), np.roll(sig, 7).astype(np.int16)], axis=1
    ).reshape(F, S, C).transpose(0, 2, 1)
    pcm = np.ascontiguousarray(pcm)

    pcm_dev = jax.device_put(pcm, dev)
    nv_dev = jax.device_put(np.full(F, S, np.int32), dev)

    kinds = ("raw", "fixed", "fixed", "fixed", "fixed", "fixed",
             "lpc", "lpc", "lpc", "lpc")
    orders = (0, 0, 1, 2, 3, 4, 5, 6, 7, 8)

    def timeit(name, fn, reps=20):
        t0 = time.time()
        jax.block_until_ready(fn())
        print(f"{name:10s} compile+run {time.time()-t0:7.1f} s", flush=True)
        # Enqueue reps back-to-back and wait for all of them.
        outs = []
        t0 = time.time()
        for _ in range(reps):
            outs.append(fn())
        jax.block_until_ready(outs)
        dt = (time.time() - t0) / reps
        print(
            f"{name:10s} hot {dt*1e3:8.1f} ms   -> {audio_sec/dt:8.0f} au-s/s",
            flush=True,
        )
        return dt

    # --- full
    timeit("full", lambda: encode_select_device(pcm_dev, nv_dev, kinds, orders))

    # --- analysis only (mid/side + autocorr + levinson)
    import functools

    @functools.partial(jax.jit, static_argnames=("max_order",))
    def analysis_only(p, nvalid_f, max_order: int):
        Fl, Cl, Sl = p.shape
        p = p.astype(jnp.int32)
        l = p[:, 0].astype(jnp.float32)
        r = p[:, 1].astype(jnp.float32)
        var_l = jnp.sum(l * l, axis=1)
        var_r = jnp.sum(r * r, axis=1)
        side = l - r
        var_side = jnp.sum(side * side, axis=1)
        mid_side = var_side < (var_l + var_r) * 0.5
        mid = p[:, 0] + p[:, 1]
        sid = p[:, 0] - p[:, 1]
        p = jnp.where(mid_side[:, None, None], jnp.stack([mid, sid], axis=1), p)
        lanes = p.reshape(Fl * Cl, Sl)
        nvalid = jnp.repeat(nvalid_f.astype(jnp.int32), Cl)
        ac = lpc.autocorrelation_device(lanes, nvalid, max_order)
        lc, ls, lv = lpc.levinson_device(ac, max_order)
        return lanes, nvalid, lc, ls, lv, mid_side

    timeit("analysis", lambda: analysis_only(pcm_dev, nv_dev, 8))

    # Materialize tables for the scan-only timing.
    lanes_h, nvalid_h, lc_h, ls_h, lv_h, _ = jax.tree_util.tree_map(
        np.asarray, analysis_only(pcm_dev, nv_dev, 8)
    )
    L = lanes_h.shape[0]
    NC = len(kinds)
    coeffs_all = np.zeros((L, NC, lpc.MAX_ORDER), np.int32)
    shifts_all = np.zeros((L, NC), np.int32)
    orders_all = np.zeros((L, NC), np.int32)
    fixed_all = np.zeros((L, NC), bool)
    cand_ok = np.ones((L, NC), bool)
    for ci, (kd, o) in enumerate(zip(kinds, orders)):
        if kd == "fixed":
            coeffs_all[:, ci, :] = lpc._FIXED_COEFFS[o]
            orders_all[:, ci] = o
            fixed_all[:, ci] = True
        elif kd == "lpc":
            coeffs_all[:, ci] = lc_h[:, o - 1]
            shifts_all[:, ci] = ls_h[:, o - 1]
            orders_all[:, ci] = o
            cand_ok[:, ci] = lv_h[:, o - 1] & (nvalid_h > o)
    is_lpc = tuple(kd == "lpc" for kd in kinds)

    d = lambda x: jax.device_put(x, dev)
    lanes_d, nvalid_d = d(lanes_h), d(nvalid_h)
    ca_d, sa_d, oa_d, fa_d, ok_d = (
        d(coeffs_all), d(shifts_all), d(orders_all), d(fixed_all), d(cand_ok))

    timeit(
        "scan",
        lambda: encode_select_step(
            lanes_d, nvalid_d, ca_d, sa_d, oa_d, fa_d, ok_d, is_lpc
        ),
    )

    # --- single winner-rematerialization / one-candidate pass
    c1 = d(coeffs_all[:, 7])  # lpc order 6
    s1 = d(shifts_all[:, 7])
    o1 = d(orders_all[:, 7])
    f1 = d(fixed_all[:, 7])

    @jax.jit
    def onecand(lanes, nvalid, c, sh, od, fx):
        r = residuals_one(lanes, nvalid, c, sh, od, fx)
        return candidate_size(r, nvalid)

    @jax.jit
    def winner(lanes, nvalid, c, sh, od, fx):
        return residuals_one(lanes, nvalid, c, sh, od, fx)

    timeit("winner", lambda: winner(lanes_d, nvalid_d, c1, s1, o1, f1))
    timeit("onecand", lambda: onecand(lanes_d, nvalid_d, c1, s1, o1, f1))

    # --- pack only (two-phase blockspread, same split the production
    # encoder dispatches: stage1 in the select jit, stage2 at the bucket
    # sized from the downloaded lane sizes)
    res_h = np.asarray(winner(lanes_d, nvalid_d, c1, s1, o1, f1))
    k_h = np.asarray(onecand(lanes_d, nvalid_d, c1, s1, o1, f1)[1])
    res_d, k_d = d(res_h), d(k_h)
    raw_d = d(np.zeros(L, bool))
    stage1_j = jax.jit(
        lambda r, k, nv, raw: blockspread.pack_stage1(r, k, nv, raw)
    )
    timeit("pack1", lambda: stage1_j(res_d, k_d, nvalid_d, raw_d))
    stage, lane_bytes, lane_off, bad = stage1_j(res_d, k_d, nvalid_d, raw_d)
    total = int(np.asarray(lane_off)[-1] + np.asarray(lane_bytes)[-1])
    NW = blockspread.bucket_words(max(total // 4, 1))
    print(f"payload={total/1e6:.1f} MB NW={NW}", flush=True)
    timeit("pack2", lambda: blockspread.pack_stage2(NW=NW, **stage))


if __name__ == "__main__":
    main()
