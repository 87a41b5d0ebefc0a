#!/usr/bin/env python
"""Decompose the device decode step (`lossless/decoder._decode_lanes_bp`)
into its stages and time each device-resident on the accelerator.

Stages (all jitted separately, same geometry as bench.py's device_decode):
  unpack      blockpack.unpack_rows (upload-transport inverse)
  recon       lpc.reconstruct_best (Triton kernel / scan recurrence)
  midside     the mid/side undo + reshape
  dn1         blockpack.pack_rows_stage1 (bit-plane download, phase 1)
  dn2         blockpack.pack_rows_stage2 at the entropy bucket (phase 2)
  full        the production _decode_lanes_bp + stage2 (two-phase pipelined)

Run:  python tools/decode_decompose.py [n_files [seconds]]
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))


def _setup_cache():
    from flo_tpu import compile_cache

    compile_cache.configure()


def _time(fn, reps=20):
    """Throughput timing: enqueue `reps` dispatches back-to-back and wait
    for all of them."""
    import jax

    jax.block_until_ready(fn())  # compile
    outs = []
    t0 = time.time()
    for _ in range(reps):
        outs.append(fn())
    jax.block_until_ready(outs)
    return (time.time() - t0) / reps


def main():
    _setup_cache()
    import jax
    import jax.numpy as jnp

    from flo_tpu.lossless.decoder import _decode_lanes_bp
    from flo_tpu.ops import blockpack, blockspread, lpc

    n_files = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    seconds = int(sys.argv[2]) if len(sys.argv) > 2 else 30
    RATE, CH = 44100, 2
    rng = np.random.default_rng(7)

    t = np.arange(RATE * seconds, dtype=np.float64)
    base = sum(np.sin(2 * np.pi * f * t / RATE) for f in (262.0, 330.0, 392.0))
    audio_sec = n_files * seconds

    pcm = np.stack(
        [
            np.round(
                (0.25 * base + 0.003 * rng.standard_normal(t.size)) * 32767
            ).astype(np.int16)
            for _ in range(n_files * CH)
        ]
    ).astype(np.int32)
    pcm_f = pcm.reshape(-1, RATE)  # 1 s lanes
    L, S = pcm_f.shape

    res_rows = np.clip(np.diff(pcm_f, axis=1, prepend=0), -30000, 30000).astype(
        np.int32
    )
    nv = np.full(L, S, np.int64)
    buf, modes, widths, off = blockpack.pack_host(res_rows, nv)
    print(f"L={L} S={S} payload={buf.nbytes/1e6:.1f} MB", flush=True)

    d_buf = jax.device_put(buf)
    d_modes = jax.device_put(modes.astype(np.int32))
    d_widths = jax.device_put(widths)
    d_off = jax.device_put(off.astype(np.int32))
    d_nv = jax.device_put(nv.astype(np.int32))
    d_coeffs = jax.device_put(
        np.tile(np.array([[2, -1] + [0] * 10], np.int32), (L, 1))
    )
    d_shifts = jax.device_put(np.zeros(L, np.int32))
    d_orders = jax.device_put(np.full(L, 2, np.int32))
    d_fixed = jax.device_put(np.ones(L, bool))
    d_ms = jax.device_put(np.zeros(L // CH, bool))
    d_rows = jax.device_put(res_rows)
    d_pcm = jax.device_put(pcm_f)

    unpack_j = jax.jit(
        lambda: blockpack.unpack_rows(d_buf, d_modes, d_widths, d_off, d_nv, S)
    )
    recon_j = jax.jit(lambda: lpc.reconstruct_best(d_rows, d_coeffs, d_shifts, d_orders, d_fixed))

    def midside(samples):
        fcs = samples.reshape(-1, CH, S)
        m, s = fcs[:, 0], fcs[:, 1]
        from flo_tpu.ops.intmath import div2_trunc

        left = div2_trunc(m + s)
        right = div2_trunc(m - s)
        msk = d_ms[:, None]
        fcs = jnp.stack(
            [jnp.where(msk, left, m), jnp.where(msk, right, s)], axis=1
        )
        return fcs.reshape(-1, S)

    midside_j = jax.jit(lambda: midside(d_pcm))
    dn1_j = jax.jit(lambda: blockpack.pack_rows_stage1(d_pcm, d_nv))

    st, smodes, sw, slb, slo = dn1_j()
    total = int(np.asarray(slo)[-1] + np.asarray(slb)[-1])
    NW = blockspread.bucket_words(max(total // 4, 1))
    print(f"download payload={total/1e6:.1f} MB NW={NW}", flush=True)
    dn2_j = lambda: blockpack.pack_rows_stage2(NW=NW, **st)

    for name, fn in (
        ("unpack", unpack_j),
        ("recon", recon_j),
        ("midside", midside_j),
        ("dn1", dn1_j),
        ("dn2", dn2_j),
    ):
        dt = _time(fn)
        print(
            f"{name:8s} {dt*1e3:8.2f} ms  {audio_sec/dt:8.1f}x realtime",
            flush=True,
        )

    def full():
        return _decode_lanes_bp(
            d_buf, d_modes, d_widths, d_off, d_coeffs, d_shifts, d_orders,
            d_fixed, d_ms, d_nv, CH, S,
        )

    # single-phase (pack fused at the PCM worst-case bucket), same as bench
    _force(full()[1])
    reps = 6
    t0 = time.time()
    outs = [full() for _ in range(reps)]
    _force(outs[-1][1])
    dt = (time.time() - t0) / reps
    print(f"{'full':8s} {dt*1e3:8.2f} ms  {audio_sec/dt:8.1f}x realtime", flush=True)


if __name__ == "__main__":
    main()
