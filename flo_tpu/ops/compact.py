"""Sparse coefficient transport: ship (column, value) pairs, not dense rows.

Quantized MDCT coefficients are mostly zeros (that is the whole point of the
psychoacoustic gate — lossy ratios are 2-30x), yet round 1 moved them as
dense [rows, 1024] i16 tensors in BOTH directions. These helpers compact the
nonzeros on device (encode: download 4 bytes per nonzero) and expand
host-built pairs back to dense on device (decode: upload 4 bytes per
nonzero), cutting the lossy wire traffic by roughly the compression ratio.

Entry format: int32 ``(col << 16) | (value & 0xFFFF)`` — col < 32768 keeps
the sign bit clear, values are i16. Entries are emitted row-major (ascending
column within each row) so hosts split rows with one cumsum of row_nnz.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np


@jax.jit
def compact_nonzeros(q):
    """q [R, W] i16/i32 -> (entries i32 [R*W] prefix-packed, row_nnz [R]).

    entries[:row_nnz.sum()] holds the nonzeros in row-major order; the tail
    is zero. Download only the prefix (fetch_prefix).

    Reference implementation (one per-element scatter); production uses the
    two-phase
    compact_blocks/assemble_entries pair below. Kept as the test oracle and
    for small one-shot calls."""
    R, W = q.shape
    flat = q.reshape(-1).astype(jnp.int32)
    nz = flat != 0
    rank = jnp.cumsum(nz.astype(jnp.int32)) - 1
    dest = jnp.where(nz, rank, R * W)  # zeros -> dropped
    col = jnp.arange(R * W, dtype=jnp.int32) % W
    entry = (col << 16) | (flat & 0xFFFF)
    entries = jnp.zeros((R * W,), jnp.int32).at[dest].set(
        entry, mode="drop", unique_indices=True
    )
    row_nnz = jnp.sum(nz.reshape(R, W), axis=1, dtype=jnp.int32)
    return entries, row_nnz


#: Elements per compaction block (dense in-block rank spread).
BLKE = 32


def compact_blocks(q):
    """Stage 1 of the two-phase compaction (call inside jit): q [R, W] ->
    (comp [NBLK, BLKE] block-local prefix-packed entries, blk_nnz [NBLK],
    row_nnz [R]). No per-element indexed ops: within-block ranks come from a
    log-depth cumsum and the compaction itself is a dense compare-select
    reduce (same design as ops/blockspread — per-element scatters cost
    ~10 ns/element on this chip)."""
    R, W = q.shape
    N = R * W
    NBLK = -(-N // BLKE)
    pad = NBLK * BLKE - N
    flat = q.reshape(-1).astype(jnp.int32)
    col = jnp.arange(N, dtype=jnp.int32) % W
    entry = jnp.where(flat != 0, (col << 16) | (flat & 0xFFFF), 0)
    if pad:
        entry = jnp.pad(entry, (0, pad))
    nz = (entry != 0).reshape(NBLK, BLKE)
    # NOTE: a zero value never produces an entry, so entry != 0 == flat != 0.
    eb = entry.reshape(NBLK, BLKE)
    nzi = nz.astype(jnp.int32)
    rank = nzi
    sh = 1
    while sh < BLKE:
        rank = rank + jnp.pad(rank, ((0, 0), (sh, 0)))[:, :BLKE]
        sh <<= 1
    rank = rank - nzi  # exclusive within-block rank
    j = jnp.arange(BLKE, dtype=jnp.int32)
    comp = jnp.sum(
        jnp.where((rank[:, :, None] == j[None, None, :]) & nz[:, :, None],
                  eb[:, :, None], 0),
        axis=1,
    )
    blk_nnz = jnp.sum(nzi, axis=1)
    row_nnz = jnp.sum((flat != 0).reshape(R, W), axis=1, dtype=jnp.int32)
    return comp, blk_nnz, row_nnz


@partial(jax.jit, static_argnames=("NE",))
def assemble_entries(comp, blk_nnz, NE: int):
    """Stage 2: merge block-local prefixes into one [NE] global prefix.

    NE is the entropy-sized bucket the caller picks after downloading the
    tiny row_nnz table (sum = true entry count). Per-block delta scatters +
    entry-domain cumsums + one flat gather — all O(NE + NBLK)."""
    NBLK = comp.shape[0]
    boff = jnp.cumsum(blk_nnz) - blk_nnz
    pos = jnp.minimum(boff, NE)
    bidx = jnp.arange(NBLK, dtype=jnp.int32)
    db = bidx - jnp.concatenate([jnp.zeros(1, jnp.int32), bidx[:-1]])
    dw = boff - jnp.concatenate([jnp.zeros(1, jnp.int32), boff[:-1]])
    seedB = jnp.zeros((NE,), jnp.int32).at[pos].add(
        db, mode="drop", indices_are_sorted=True
    )
    seedW = jnp.zeros((NE,), jnp.int32).at[pos].add(
        dw, mode="drop", indices_are_sorted=True
    )
    B1 = jnp.cumsum(seedB)
    W0e = jnp.cumsum(seedW)
    i = jnp.arange(NE, dtype=jnp.int32)
    j = i - W0e
    flat = jnp.clip(B1 * BLKE + jnp.clip(j, 0, BLKE - 1), 0, NBLK * BLKE - 1)
    return jnp.where((j >= 0) & (j < BLKE), comp.reshape(-1)[flat], 0)


def split_entries(entries: np.ndarray):
    """Host-side: int32 entries -> (cols int32, vals int16)."""
    cols = (entries >> 16).astype(np.int32)
    vals = (entries & 0xFFFF).astype(np.uint16).view(np.int16)
    return cols, vals


def make_entries(cols: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Host-side inverse of split_entries."""
    return (cols.astype(np.int32) << 16) | (
        vals.astype(np.int16).view(np.uint16).astype(np.int32)
    )


@partial(jax.jit, static_argnames=("R", "W"))
def expand_nonzeros(entries, row_nnz, total, R: int, W: int):
    """Rebuild dense [R, W] i32 rows from padded row-major entries.

    entries: [N_pad] i32 (tail past ``total`` ignored); row_nnz: [R] i32;
    total: scalar i32 (= row_nnz.sum(), passed so shapes stay static).
    """
    N = entries.shape[0]
    # Row id per entry: +1 markers at each row's first entry index, cumsum.
    # Rows with zero entries stack their markers on the same index (add).
    row_start = jnp.cumsum(row_nnz) - row_nnz
    marks = jnp.zeros((N,), jnp.int32).at[row_start].add(1, mode="drop")
    row_id = jnp.cumsum(marks) - 1
    col = entries >> 16
    val = (entries << 16) >> 16  # sign-extended low 16 bits
    flat_idx = row_id * W + col
    valid = jnp.arange(N, dtype=jnp.int32) < total
    flat_idx = jnp.where(valid, flat_idx, R * W)
    dense = jnp.zeros((R * W,), jnp.int32).at[flat_idx].set(
        val, mode="drop", unique_indices=True
    )
    return dense.reshape(R, W)


#: Download-slice bucket (elements) — see ricepack.PREFIX_BUCKET.
PREFIX_BUCKET = 2 << 20


def bucket_entries(n: int, floor: int = 1 << 16) -> int:
    """{1, 1.5} x 2^k growth bucket for the assemble_entries size."""
    from ..buckets import grow_bucket

    return grow_bucket(n, floor)


@partial(jax.jit, static_argnames=("n",))
def _take_prefix(arr, n: int):
    return jax.lax.dynamic_slice_in_dim(arr, 0, n)


def fetch_prefix(arr, n: int) -> np.ndarray:
    """Download the first n elements of a device 1-D buffer (bucketed)."""
    if n <= 0:
        return np.zeros(0, arr.dtype)
    cap = arr.shape[0]
    m = min(-(-n // PREFIX_BUCKET) * PREFIX_BUCKET, cap)
    return np.asarray(_take_prefix(arr, m))[:n]


def pad_entries(entries: np.ndarray, bucket: int = 1 << 20) -> np.ndarray:
    """Pad to a bucket multiple so the expand program rarely recompiles."""
    n = len(entries)
    cap = -(-max(n, 1) // bucket) * bucket
    out = np.zeros(cap, np.int32)
    out[:n] = entries
    return out
