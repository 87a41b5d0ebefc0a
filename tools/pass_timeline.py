#!/usr/bin/env python
"""Wall-clock timeline of one headline bench pass.

Records (t0, t1, MB, tag) around every wire funnel call — uploads via
parallel.pipeline.put_batch/put_replicated, payload downloads via
ricepack.fetch_prefix_start/finish — plus the top-level dispatch/collect
boundaries of the four pipelines, then prints a sorted event log. The gaps
between wire events are host compute or device waits; this is the tool that
says WHICH.

Run on the GPU host with a warm compile cache (after bench.py).
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

EVENTS = []
T0 = [0.0]


def ev(tag, t0, t1, mb=0.0):
    EVENTS.append((t0 - T0[0], t1 - T0[0], mb, tag))


def install():
    from flo_tpu.ops import ricepack
    from flo_tpu.parallel import pipeline as pp

    orig_pb, orig_pr = pp.put_batch, pp.put_replicated
    orig_fs = ricepack.fetch_prefix_start
    orig_ff = ricepack.fetch_prefix_finish

    def put_batch(x, mesh):
        t0 = time.time()
        out = orig_pb(x, mesh)
        ev("up.batch", t0, time.time(), np.asarray(x).nbytes / 1e6)
        return out

    def put_replicated(x, mesh):
        t0 = time.time()
        out = orig_pr(x, mesh)
        ev("up.repl", t0, time.time(), np.asarray(x).nbytes / 1e6)
        return out

    def fetch_prefix_start(arr, nelems):
        t0 = time.time()
        out = orig_fs(arr, nelems)
        ev("down.start", t0, time.time(), nelems * arr.dtype.itemsize / 1e6)
        return out

    def fetch_prefix_finish(h, nelems):
        t0 = time.time()
        out = orig_ff(h, nelems)
        ev("down.finish(block)", t0, time.time(), nelems / 1e6)
        return out

    pp.put_batch = put_batch
    pp.put_replicated = put_replicated
    ricepack.fetch_prefix_start = fetch_prefix_start
    ricepack.fetch_prefix_finish = fetch_prefix_finish


def main():
    import jax

    from flo_tpu import compile_cache

    compile_cache.configure()

    from bench import RATE, CHANNELS, SEED
    from flo_tpu import corpus
    from flo_tpu.container import reader as _reader
    from flo_tpu.lossless import decoder as lld, encoder as lle
    from flo_tpu.lossy import decoder as lod, encoder as loe
    from flo_tpu.lossy.presets import QUALITY_U8_TO_F32

    print("device:", jax.devices()[0], flush=True)
    clips = corpus.material(8, 60, SEED)
    q = QUALITY_U8_TO_F32[1]

    def pass_once():
        h_ll = lle.encode_many_async(clips, RATE, CHANNELS, 16, 5)
        ev("disp.enc_ll", t0p, time.time())
        t1 = time.time()
        h_lo = loe.encode_many_async(clips, RATE, CHANNELS, q, transport_dtype="packed")
        ev("disp.enc_lo", t1, time.time())
        t1 = time.time()
        d_ll = h_ll.result()
        ev("coll.enc_ll", t1, time.time())
        t1 = time.time()
        h_lld = lld.decode_many_async([_reader.read(d) for d in d_ll])
        ev("disp.dec_ll", t1, time.time())
        t1 = time.time()
        d_lo = h_lo.result()
        ev("coll.enc_lo", t1, time.time())
        t1 = time.time()
        h_lod = lod.decode_many_async([_reader.read(d) for d in d_lo])
        ev("disp.dec_lo", t1, time.time())
        t1 = time.time()
        out_ll = h_lld.result()
        ev("coll.dec_ll", t1, time.time())
        t1 = time.time()
        out_lo = h_lod.result()
        ev("coll.dec_lo", t1, time.time())
        return d_ll, out_ll, d_lo, out_lo

    # warmup (compile)
    t0p = time.time()
    pass_once()
    EVENTS.clear()

    T0[0] = t0p = time.time()
    install()
    pass_once()
    total = time.time() - t0p

    print(f"pass: {total:.2f}s")
    up = down = 0.0
    for t0, t1, mb, tag in sorted(EVENTS):
        bar = " " * int(t0 * 6) + "#" * max(1, int((t1 - t0) * 6))
        print(f"{t0:7.2f} {t1:7.2f} {t1-t0:6.2f}s {mb:7.1f}MB  {tag:20s} {bar[:110]}")
        if tag.startswith("up"):
            up += mb
        elif tag.startswith("down.start"):
            down += mb
    print(f"up {up:.1f} MB, down {down:.1f} MB")


if __name__ == "__main__":
    main()
