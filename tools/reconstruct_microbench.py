#!/usr/bin/env python
"""Kernel-only microbench for the LPC reconstruction (ops/lpc.reconstruct_best).

[240, 44100], [480, 44100] and [960, 44100] int32 lanes (960 lanes = 8
minutes of 44.1 kHz stereo audio; a bulk decode of it dispatches two
sub-batches of 480), device-resident input and output, steady state, for
each lanes-per-program setting of the Triton kernel (BLOCK_LANES). Every
setting is checked bit-exact against the first. This is the KERNEL-ONLY
figure — no wire unpack/pack around it; the `device_reconstruct` bench
config (bench.py) wraps the same kernel with device-resident I/O.

Run on the GPU host:  python tools/reconstruct_microbench.py [--block-lanes 32,64,128]
"""

import argparse
import json
import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

S = 44100


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--block-lanes", default="32")
    ap.add_argument("--lanes", default="240,480,960")
    args = ap.parse_args(argv)

    import jax

    from flo_tpu import compile_cache, corpus

    compile_cache.configure()
    dev = jax.devices()[0]
    print("device:", dev, flush=True)

    from flo_tpu.ops import lpc, triton_lpc

    lanes = [int(x) for x in args.lanes.split(",")]
    host = corpus.mixed_lanes(1, max(lanes), S)
    full = [jax.device_put(a, dev) for a in host]
    first = {}
    for bl in (int(x) for x in args.block_lanes.split(",")):
        triton_lpc.BLOCK_LANES = bl
        jax.clear_caches()  # the kernel reads BLOCK_LANES when it is traced
        recon = jax.jit(lpc.reconstruct_best)
        for L in lanes:
            d = [a[:L] for a in full]
            t0 = time.perf_counter()
            out = np.asarray(recon(*d))
            compile_s = time.perf_counter() - t0
            exact = bool(np.array_equal(out, first.setdefault(L, out)))
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(recon(*d))
                times.append(time.perf_counter() - t0)
            print(json.dumps({
                "block_lanes": bl, "lanes": L, "steps": S,
                "median_ms": float(np.median(times)) * 1e3,
                "min_ms": min(times) * 1e3, "first_call_s": compile_s,
                "equal_to_first_setting": exact,
            }), flush=True)


if __name__ == "__main__":
    main()
