#!/usr/bin/env python
"""Primitive-cost microbench for the device Rice packer redesign.

pack_lanes([240, 44100]) measured 425 ms — this decomposes the cost into its
primitive candidates so the redesign targets the real constraint:

  scatter169   scatter-add 10.6M sorted indices into the 169M bit domain
  scatter16    same values into a 16M merged (code+word) domain
  cumsum169    cumsum over the 169M i32 bit domain
  cumsum16     cumsum over 16M i32
  cumsum2d     within-row cumsum [240, 705600] (per-lane bit domain)
  elemwise169  one fused elementwise pass over 169M (the bit extraction)
  fold         the 8->1 bit fold ([165k, 1024] -> bytes)
  cumsum_code  cumsum over the 10.6M code domain
  gatherE      5.3M minor-axis take_along_axis from [240, 44100]
"""

import pathlib
import sys
import time

import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

L, S = 240, 44100
NCODES = L * S
NW = L * (S * 16 // 32 + 1)
NW = -(-NW // 32) * 32
NB = NW * 32


def main():
    import jax
    import jax.numpy as jnp

    from flo_tpu import compile_cache

    compile_cache.configure()
    dev = jax.devices()[0]
    print(f"device: {dev}  NCODES={NCODES}  NW={NW}  NB={NB}", flush=True)

    rng = np.random.default_rng(0)
    # Sorted non-decreasing starts spanning the bit domain (realistic: ~7
    # bits/code mean -> occupies ~half the worst-case domain).
    clen = rng.integers(1, 14, NCODES).astype(np.int32)
    starts = (np.cumsum(clen) - clen).astype(np.int32)
    vals = rng.integers(-(2**31), 2**31 - 1, NCODES, dtype=np.int64).astype(np.int32)

    d_starts = jax.device_put(starts, dev)
    d_vals = jax.device_put(vals, dev)

    def timeit(name, fn, reps=5):
        t0 = time.time()
        jax.block_until_ready(fn())
        print(f"{name:12s} compile+run {time.time()-t0:7.1f} s", flush=True)
        t0 = time.time()
        for _ in range(reps):
            jax.block_until_ready(fn())
        dt = (time.time() - t0) / reps
        print(f"{name:12s} hot {dt*1e3:8.1f} ms", flush=True)
        return dt

    @jax.jit
    def scatter169(idx, v):
        return jnp.zeros((NB,), jnp.int32).at[idx].add(
            v, mode="drop", indices_are_sorted=True
        )

    @jax.jit
    def scatter16(idx, v):
        return jnp.zeros((NCODES + NW,), jnp.int32).at[idx >> 5].add(
            v, mode="drop", indices_are_sorted=True
        )

    big = jax.device_put(
        rng.integers(-100, 100, NB, dtype=np.int16).astype(np.int32), dev
    )
    med = jax.device_put(
        rng.integers(-100, 100, NCODES + NW, dtype=np.int16).astype(np.int32), dev
    )
    lanes2d = jax.device_put(
        rng.integers(-100, 100, (L, S * 16), dtype=np.int16).astype(np.int32), dev
    )

    timeit("scatter169", lambda: scatter169(d_starts, d_vals))
    timeit("scatter16", lambda: scatter16(d_starts, d_vals))
    timeit("cumsum169", lambda: jax.jit(jnp.cumsum)(big))
    timeit("cumsum16", lambda: jax.jit(jnp.cumsum)(med))
    timeit(
        "cumsum2d",
        lambda: jax.jit(lambda x: jnp.cumsum(x, axis=1))(lanes2d),
    )

    @jax.jit
    def elemwise(st):
        off = jnp.arange(NB, dtype=jnp.int32) - st
        u = jax.lax.bitcast_convert_type(st, jnp.uint32)
        bit = jnp.where(
            (off >= 0) & (off < 32),
            (u >> jnp.clip(31 - off, 0, 31).astype(jnp.uint32)) & jnp.uint32(1),
            jnp.uint32(0),
        )
        return bit.astype(jnp.int32)

    timeit("elemwise169", lambda: elemwise(big))

    @jax.jit
    def fold(bits):
        b2 = bits.reshape(NB // 1024, 1024)
        byte = jnp.zeros((NB // 1024, 128), jnp.int32)
        for j in range(8):
            byte = byte + (b2[:, j::8] << (7 - j))
        return byte.reshape(-1)

    timeit("fold", lambda: fold(big & 1))

    timeit("cumsum_code", lambda: jax.jit(jnp.cumsum)(d_vals))

    qidx = jax.device_put(
        np.sort(rng.integers(0, S, (L, S // 2), dtype=np.int32), axis=1), dev
    )
    rows = jax.device_put(
        rng.integers(-30000, 30000, (L, S), dtype=np.int32), dev
    )

    @jax.jit
    def gatherE(r, q):
        return jnp.take_along_axis(r, q, axis=1)

    timeit("gatherE", lambda: gatherE(rows, qidx))


if __name__ == "__main__":
    main()
