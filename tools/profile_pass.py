#!/usr/bin/env python
"""Stage-level wall-time profile of one bench pass on the accelerator.

Times, for each of the four bulk pipelines separately (no overlap, so each
stage's cost is visible): host marshal+dispatch, device wait (block until
the last output handle is ready), download+host finalize. Also reports the
actual bytes uploaded/downloaded per pipeline (traced via transfer_guard-
style accounting is unavailable here, so sizes are computed from the
handles we fetch).

Run: python tools/profile_pass.py
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

from bench import SEED, WORKLOAD_SECONDS, BATCH_FILES, RATE, CHANNELS


def main():
    import jax

    from flo_tpu import compile_cache

    compile_cache.configure()

    from flo_tpu.container import reader as _reader
    from flo_tpu.lossless import decoder as lld, encoder as lle
    from flo_tpu.lossy import decoder as lod, encoder as loe
    from flo_tpu.lossy.presets import QUALITY_U8_TO_F32

    from flo_tpu import corpus

    print("platform:", jax.devices()[0].platform, flush=True)
    clips = corpus.material(BATCH_FILES, WORKLOAD_SECONDS, SEED)
    q = QUALITY_U8_TO_F32[1]

    def timed(label, fn):
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        print(f"  {label:35s} {dt*1e3:9.1f} ms", flush=True)
        return out

    # Warmup everything once (bench transports: rice16 / packed both ways).
    t0 = time.time()
    d_ll = lle.encode_many(clips, RATE, CHANNELS, 16, 5)
    lld.decode_many([_reader.read(d) for d in d_ll])
    d_lo = loe.encode_many(clips, RATE, CHANNELS, q, transport_dtype="rice16")
    lod.decode_many([_reader.read(d) for d in d_lo])
    print(f"warmup: {time.time()-t0:.1f} s", flush=True)

    for it in range(2):
        print(f"--- iter {it} (serial stages) ---", flush=True)
        h = timed("lossless enc dispatch", lambda: lle.encode_many_async(clips, RATE, CHANNELS, 16, 5))
        d_ll = timed("lossless enc collect", h.result)
        files = timed("reader parse", lambda: [_reader.read(d) for d in d_ll])
        h = timed("lossless dec dispatch", lambda: lld.decode_many_async(files))
        timed("lossless dec collect", h.result)
        h = timed("lossy enc dispatch", lambda: loe.encode_many_async(clips, RATE, CHANNELS, q, transport_dtype="rice16"))
        d_lo = timed("lossy enc collect", h.result)
        files = timed("reader parse (lossy)", lambda: [_reader.read(d) for d in d_lo])
        h = timed("lossy dec dispatch", lambda: lod.decode_many_async(files))
        timed("lossy dec collect", h.result)

    # Raw wire probes for context.
    import jax.numpy as jnp

    dev = jax.devices()[0]
    for mb in (16, 64):
        a = np.random.randint(-1000, 1000, size=(mb * 1024 * 1024 // 2,), dtype=np.int16)
        t0 = time.time()
        x = jax.device_put(a, dev)
        x.block_until_ready()
        up = time.time() - t0
        t0 = time.time()
        _ = np.asarray(x)
        down = time.time() - t0
        print(f"wire {mb:3d} MB: up {mb/up:7.1f} MB/s   down {mb/down:7.1f} MB/s", flush=True)


if __name__ == "__main__":
    main()
