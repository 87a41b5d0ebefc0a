#!/usr/bin/env python
"""Microbench the indexed-op primitives that could rebuild blockpack's
device unpack (the 195 ms stage in the decode step):

  A. slice-gather: vmap(dynamic_slice) — one 256-word contiguous slice per
     block (83k indices, 1 KB each -> [NBT, 256] words).
  B. unit-scatter: scatter 8-word plane units into padded rows
     ([PW/8] indices of 32 B each).
  C. word-delta-scatter + cumsum (the current unpack_rows expansion).
  D. flat per-code gather (the retired round-2 design, for scale).
  E. plane-sum: the fused 32-plane bit accumulation on a resident window
     (no indexed ops — the arithmetic half of the bit-plane design).

Run: python tools/gather_microbench.py [L [S]]
"""

import pathlib
import sys
import time

import numpy as np


def _setup_cache():
    from flo_tpu import compile_cache

    compile_cache.configure()


def _time(fn, reps=20):
    import jax

    jax.block_until_ready(fn())
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

    L = int(sys.argv[1]) if len(sys.argv) > 1 else 480
    S = int(sys.argv[2]) if len(sys.argv) > 2 else 44100
    BLK = 256
    NB = -(-S // BLK)
    NBT = L * NB
    rng = np.random.default_rng(0)

    # Synthetic geometry: widths ~ audio d2 (mostly 9-13 bits).
    w = np.clip(rng.normal(11, 2, NBT), 4, 32).astype(np.int32)
    blk_words = 8 * w
    off = np.zeros(NBT, np.int64)
    np.cumsum(blk_words[:-1], out=off[1:])
    PW = int(off[-1] + blk_words[-1])
    print(f"L={L} S={S} NBT={NBT} payload={PW*4/1e6:.1f} MB", flush=True)

    W = jax.device_put(rng.integers(0, 2**32, PW + 256, np.uint64).astype(np.uint32))
    offs = jax.device_put(off.astype(np.int32))
    w_d = jax.device_put(w)

    WMAX = 16
    WINDOW = 8 * WMAX

    # A: slice-gather (production window: 8*wmax words per block)
    def slice_gather():
        return jax.vmap(lambda o: jax.lax.dynamic_slice(W, (o,), (WINDOW,)))(offs)

    # B: unit-scatter (8-word units into [NBT*32, 8])
    NU = PW // 8
    u_dst = np.zeros(NU, np.int64)
    unit0 = off // 8
    for b in range(NBT):  # host precompute; not part of the timed region
        t0_, n = unit0[b], blk_words[b] // 8
        u_dst[t0_ : t0_ + n] = b * 32 + np.arange(n)
    u_dst_d = jax.device_put(u_dst.astype(np.int32))
    Wu = jax.device_put(
        np.asarray(rng.integers(0, 2**32, (NU, 8), np.uint64), np.uint32)
    )

    def unit_scatter():
        return (
            jnp.zeros((NBT * 32, 8), jnp.uint32)
            .at[u_dst_d]
            .set(Wu, mode="drop", indices_are_sorted=True, unique_indices=True)
        )

    # C: per-word delta scatter + cumsum (current expansion, word->code)
    Sp = NB * BLK
    first_code = np.minimum(
        np.repeat(np.arange(NBT, dtype=np.int64) * BLK, 1), L * Sp - 1
    )
    # word -> first code map (approximate geometry: ceil(32t/w) per block)
    pos_w = np.zeros(PW, np.int64)
    for b in range(NBT):
        t = np.arange(blk_words[b])
        fc = (32 * t + w[b] - 1) // w[b]
        pos_w[off[b] : off[b] + blk_words[b]] = b * BLK + np.minimum(fc, BLK - 1)
    pos_w_d = jax.device_put(pos_w.astype(np.int32))
    Wp = jax.device_put(
        np.asarray(rng.integers(-(2**31), 2**31, PW, np.int64), np.int32)
    )

    def word_delta_scatter():
        delta = Wp - jnp.concatenate([jnp.zeros(1, jnp.int32), Wp[:-1]])
        seed = jnp.zeros((L * Sp,), jnp.int32).at[pos_w_d].add(
            delta, mode="drop", indices_are_sorted=True
        )
        return jnp.cumsum(seed)

    # D: flat per-code gather
    code_word = np.zeros(L * Sp, np.int64)
    for b in range(NBT):
        j = np.arange(BLK)
        code_word[b * BLK : (b + 1) * BLK] = off[b] + (j * w[b]) // 32
    code_word_d = jax.device_put(code_word.astype(np.int32))

    def flat_gather():
        return W[code_word_d]

    # E: plane-sum arithmetic on a resident [NBT, WMAX, 8] window (the
    # exact accumulation unpack_rows runs after its window gather)
    win = jax.device_put(
        np.asarray(rng.integers(0, 2**32, (NBT, WMAX, 8), np.uint64), np.uint32)
    )

    def plane_sum():
        i = jnp.arange(32, dtype=jnp.uint32)[None, None, :]
        acc = jnp.zeros((NBT, 8, 32), jnp.uint32)
        for p in range(WMAX):
            bits = (win[:, p, :, None] >> i) & jnp.uint32(1)
            acc = acc + jnp.where(
                (p < w_d)[:, None, None], bits << jnp.uint32(p), jnp.uint32(0)
            )
        return acc

    # F: destination-side row gather (plane-unit compaction inverse:
    # NU indices pulling 8-word rows — the bit-plane download placement)
    rowsrc = jax.device_put(
        np.asarray(rng.integers(0, 2**32, (NBT * 32, 8), np.uint64), np.uint32)
    )
    ridx = jax.device_put(
        rng.integers(0, NBT * 32, NU, np.int64).astype(np.int32)
    )

    def row_gather():
        return jnp.take(rowsrc, ridx, axis=0)

    # A (vmap dynamic_slice window) is excluded: it compiles to a >100 MB
    # fully-unrolled binary with unstable 0.1-2.4 s execution (measured via
    # tools/decode_decompose.py) — XLA has no good lowering for many-index
    # large-slice gathers on this target. C (per-word delta scatter) and D
    # (flat per-code gather) are the retired round-2/round-3 baselines.
    todo = [
        ("B unit-scatter", jax.jit(unit_scatter)),
        ("E plane-sum", jax.jit(plane_sum)),
        ("F row-gather", jax.jit(row_gather)),
    ]
    if "--all" in sys.argv:
        todo += [
            ("A slice-gather", jax.jit(slice_gather)),
            ("C word-delta-scatter", jax.jit(word_delta_scatter)),
            ("D flat-code-gather", jax.jit(flat_gather)),
        ]
    for name, fn in todo:
        try:
            dt = _time(fn)
            print(f"{name:22s} {dt*1e3:9.2f} ms", flush=True)
        except Exception as e:  # noqa: BLE001
            print(f"{name:22s} FAILED: {type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
