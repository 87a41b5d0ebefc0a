#!/usr/bin/env python
"""Decompose pack_stage1's device time via dead-code-elimination variants.

Requesting only a subset of stage-1 outputs lets XLA DCE the rest:
  sizes_only   clen/pattern + cumsums + lane sizes    (no spread, no merge)
  rows_only    + dense block spread                   (_DEBUG_STAGE_EXTRAS)
  sup_only     + hierarchical barrel merge            (no patch compaction)
  full         everything (incl. patch compaction + bad-lane marking)

Timing: enqueue reps back-to-back and wait for all of them.
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

L, S = 240, 44100


def main():
    import jax

    from flo_tpu import compile_cache

    compile_cache.configure()
    from flo_tpu.ops import blockspread as bs

    bs._DEBUG_STAGE_EXTRAS = True

    dev = jax.devices()[0]
    print("device:", dev, flush=True)

    rng = np.random.default_rng(0)
    residuals = rng.integers(-300, 300, (L, S)).astype(np.int32)
    residuals[:, ::5000] = 1 << 18  # some long codes
    k = np.full(L, 4, np.int32)
    nvalid = np.full(L, S, np.int32)
    is_raw = np.zeros(L, bool)
    d = lambda x: jax.device_put(x, dev)
    r_d, k_d, nv_d, raw_d = d(residuals), d(k), d(nvalid), d(is_raw)

    def timeit(name, fn, reps=10):
        t0 = time.time()
        jax.block_until_ready(fn())
        print(f"{name:12s} compile+run {time.time()-t0:7.1f} s", flush=True)
        outs = []
        t0 = time.time()
        for _ in range(reps):
            outs.append(fn())
        jax.block_until_ready(outs)
        print(f"{name:12s} hot {(time.time()-t0)/reps*1e3:8.1f} ms", flush=True)

    @jax.jit
    def sizes_only(r, kk, nv, raw):
        _, lane_bytes, lane_off, _ = bs.pack_stage1(r, kk, nv, raw)
        return lane_bytes, lane_off

    @jax.jit
    def rows_only(r, kk, nv, raw):
        stage, lane_bytes, _, _ = bs.pack_stage1(r, kk, nv, raw)
        return stage["rows"], stage["adv"], lane_bytes

    @jax.jit
    def sup_only(r, kk, nv, raw):
        stage, lane_bytes, _, _ = bs.pack_stage1(r, kk, nv, raw)
        return stage["sup"], stage["S0x"], lane_bytes

    @jax.jit
    def full(r, kk, nv, raw):
        return bs.pack_stage1(r, kk, nv, raw)

    timeit("sizes_only", lambda: sizes_only(r_d, k_d, nv_d, raw_d))
    timeit("rows_only", lambda: rows_only(r_d, k_d, nv_d, raw_d))
    timeit("sup_only", lambda: sup_only(r_d, k_d, nv_d, raw_d))
    timeit("full", lambda: full(r_d, k_d, nv_d, raw_d))


if __name__ == "__main__":
    main()
