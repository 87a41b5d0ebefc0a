"""Device Rice bitstream packing v3: block-dense spread, hierarchical
barrel-shift merge, wide-tile gather assembly. No per-element indexed ops
touch the payload anywhere.

Replaces ops/ricepack.pack_lanes as the production encoder transport. The
design history (per-index costs below are from the accelerator this was
first built for, and have not been re-measured on the GPU):

- Round-2 v1 spread per-code deltas over a 169M-element BIT domain. Every
  per-code indexed op cost ~7 ns/index there -> ~425 ms/batch.
- v2 (round 3) spread codes densely within 32-code blocks (no indexing),
  then expanded blocks to the word domain with per-WORD bookkeeping: two
  [NW] delta-scatter+cumsums (~7 ms) plus one flat per-word gather
  (~28-30 ms at the bench geometry). Gather/scatter cost is per-ELEMENT
  (~3-7 ns) below 32-word granularity — the per-word expand was the
  binding cost of the whole encode pass.
- v3 (this file) exploits the measured gather cliff: 8/16-word row gathers
  still pay ~2.5 ns/element, but >=32-word rows run at memory speed
  (17 MB moved: x8 10.7 ms, x16 8.6 ms, x32 1.2 ms, x128 0.28 ms). So:

  1. Elementwise per code (unchanged from v2): bit length ``clen`` and the
     32-bit MSB-aligned pattern (unary ones, terminator, remainder — or
     the raw LE16 pattern).
  2. DENSE within-block spread (unchanged): each 32-code block's bits land
     in a 34-word row starting at its absolute word W0; row word j is a
     broadcast compare-select-sum over the block's codes. No indexing.
  3. Hierarchical MERGE: 7 rounds of pairwise barrel-shift OR fuse block
     rows into 128-block SUPERROWS [NSB, 4224], each dense at word 0
     (measured 15.2 ms at the bench geometry — pure vector selects).
     Straddle words need no special fold: adjacent segments' bits are
     disjoint in the shared word, so OR merges them.
  4. Wide-tile assembly: the output is cut into 128-word TILES. Each tile
     is covered by the superblock owning its first word plus at most
     RCAND-1 superblocks starting inside it (every fully-valid superblock
     advances >=128 words, so coverage is <=2 there). Per candidate: one
     or two ALIGNED 128-word unit gathers from the superrows (memory
     speed) + a 7-step barrel shift + a validity mask. All bookkeeping
     (tile -> owning superblock) runs on the NSB~2.6k and NT=NW/128
     domains — thousands of indices, not millions.
  5. Codes that cannot live in a 34-word row — >32-bit Rice codes
     (format-legal up to 271 bits, reference rice.rs caps quotients at
     255) and codes displaced past word 32 by one — are excluded from the
     spread and written whole by a compacted patch pass (<= PATCH_CAP
     codes). Lanes whose geometry breaks the fast path's static bounds
     (patch overflow, >32-word block advances, >RCAND-1 superblock starts
     in one tile) are flagged ``bad`` and re-packed exactly on the host,
     as before.

Output contract (same as v2): for every non-flagged lane, the byte stream
``words.view(u8)[off[l]:off[l]+n[l]]`` is byte-for-byte identical to
``rice_host.encode(residuals[l, :n[l]], k[l])``; raw lanes carry verbatim
LE16 codes. Lane offsets are word-aligned. The MSB-first word->byte swap
happens ON DEVICE at the end of pack_stage2 (4 vector shift/ors) so the
downloaded u32 buffer's little-endian host layout IS the byte stream —
fetch_words_finish is a zero-copy view.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

#: Codes per spread block. 32 codes * <=32 bits + straddle -> 34-word rows.
BLKC = 32
ROWW = 34

#: Blocks per superblock (merge fan-in) and output tile width in words.
GBLK = 128
TILE = 128

#: Superrow padded width: content <= GBLK*32+1 = 4097 words; the owner
#: window reads up to content_start + TILE - 1 -> 4096 + 127 < 4224.
SUPW = 4224
_SUP_UNITS = SUPW // TILE  # 33

#: Static superblock candidates per output tile: the owner of the tile's
#: first word + up to RCAND-1 superblocks starting inside the tile. A
#: fully-valid superblock advances >=GBLK words >= TILE, so coverage is
#: <=2 there; short/ragged lanes can exceed RCAND and fall back to exact
#: host re-packing via the ``bad`` flags.
RCAND = 4

#: Static cap on patched codes (>32-bit or overflow-wi) per pack call.
PATCH_CAP = 16384

#: Static cap on BLOCKS containing patched codes (first compaction level).
PATCH_BLOCKS = 4096

#: Max words a patched code can span: ceil((255+1+15)/32) + straddle.
PATCH_WORDS = 10

#: Worst-case packed bits per sample (raw baseline bound) — sizes the
#: fallback single-program path and the stage-2 bucket ceiling.
WORST_BITS_PER_SAMPLE = 16

#: Hard cap so every bit index fits int32 (with word-align slack).
MAX_BATCH_SAMPLES = (1 << 30) // WORST_BITS_PER_SAMPLE - 1


def _zigzag_u32(r):
    z = (r << 1) ^ (r >> 31)
    return jax.lax.bitcast_convert_type(z, jnp.uint32)


def _exclusive_block_cumsum(x):
    """[N, BLKC] -> exclusive within-row cumsum via log2(BLKC) shifted adds."""
    c = x
    sh = 1
    while sh < BLKC:
        c = c + jnp.pad(c, ((0, 0), (sh, 0)))[:, :BLKC]
        sh <<= 1
    return c - x


def pack_stage1(residuals, k, nvalid, is_raw):
    """Candidate-independent packing analysis + block spread (call in jit).

    Args: residuals [L, S] int32 (Rice lanes: residuals; raw lanes: verbatim
    samples), k [L] int32, nvalid [L] int32, is_raw [L] bool.

    Returns a dict of device arrays for :func:`pack_stage2` plus
    (lane_bytes [L] i32, lane_off [L] i32 word-aligned, bad [L] bool).
    """
    L, S = residuals.shape
    kcol = k[:, None]
    ku = kcol.astype(jnp.uint32)

    u_rice = _zigzag_u32(residuals)
    q = jnp.minimum(u_rice >> ku, jnp.uint32(255)).astype(jnp.int32)
    u_raw = jax.lax.bitcast_convert_type(residuals & 0xFFFF, jnp.uint32)

    valid = jnp.arange(S, dtype=jnp.int32)[None, :] < nvalid[:, None]
    clen = jnp.where(is_raw[:, None], 16, q + 1 + kcol)
    clen = jnp.where(valid, clen, 0)

    # MSB-aligned 32-bit pattern (spread codes have q <= 31, so the
    # remainder always fits; patched codes never read their pattern).
    q32 = jnp.minimum(q, 31).astype(jnp.uint32)
    ones = jnp.where(q >= 32, jnp.uint32(0xFFFFFFFF), ~(jnp.uint32(0xFFFFFFFF) >> q32))
    rem = jnp.where(ku > 0, u_rice << (jnp.uint32(32) - ku), jnp.uint32(0))
    pat_rice = ones | jnp.where(q < 31, rem >> jnp.minimum(q32 + 1, 31), jnp.uint32(0))
    pat_raw = ((u_raw & jnp.uint32(0x00FF)) << 24) | ((u_raw & jnp.uint32(0xFF00)) << 8)
    pattern = jnp.where(is_raw[:, None], pat_raw, pat_rice)
    pattern = jnp.where(valid, pattern, jnp.uint32(0))

    return _spread_codes(clen, pattern, q, u_rice)


def _spread_codes(clen, pattern, q, u_rice):
    """Shared stage-1 core: variable-length codes [L, S] (bit length `clen`,
    first-32-bits MSB-aligned `pattern`, Rice (q, u) for >32-bit patch
    tails) -> merged superrows + tile-assembly bookkeeping + patch list +
    lane sizes."""
    L, S = clen.shape
    NBL = -(-S // BLKC)  # blocks per lane
    Sp = NBL * BLKC

    # Two-level bit-offset cumsum: block sums, then in-block log shifts.
    pad = Sp - S
    clen_p = jnp.pad(clen, ((0, 0), (0, pad))) if pad else clen
    cb = clen_p.reshape(L, NBL, BLKC)
    blk_bits = jnp.sum(cb, axis=2)  # [L, NBL]
    blk_off = jnp.cumsum(blk_bits, axis=1) - blk_bits
    within = (
        blk_off[:, :, None] + _exclusive_block_cumsum(cb.reshape(-1, BLKC)).reshape(L, NBL, BLKC)
    ).reshape(L, Sp)

    lane_bits = blk_off[:, -1] + blk_bits[:, -1]
    lane_bytes = (lane_bits + 7) >> 3
    lane_words = (lane_bits + 31) >> 5
    lane_woff = jnp.cumsum(lane_words) - lane_words
    lane_off = lane_woff * 4
    total_words = lane_woff[-1] + lane_words[-1] if L else jnp.int32(0)

    # Absolute bit start per code; block word starts.
    abs_start = (lane_woff[:, None] << 5) + within  # [L, Sp]
    W0 = ((lane_woff << 5)[:, None] + blk_off) >> 5  # [L, NBL]
    W0_flat = W0.reshape(-1)
    NBLK = L * NBL

    # Per-code spread inputs.
    wi = (abs_start >> 5) - jnp.repeat(W0, BLKC, axis=1)
    bo = (abs_start & 31).astype(jnp.uint32)
    live = (clen_p > 0) & (clen_p <= 32) & (wi <= 32)
    is_patch = (clen_p > 0) & ~live
    pat_live = jnp.where(live, jnp.pad(pattern, ((0, 0), (0, pad))) if pad else pattern, jnp.uint32(0))
    a = pat_live >> bo
    b = jnp.where(bo > 0, pat_live << (jnp.uint32(32) - bo), jnp.uint32(0))

    # Dense within-block spread -> rows [NBLK, ROWW].
    wib = wi.reshape(NBLK, BLKC)
    ab = a.reshape(NBLK, BLKC)
    bb = b.reshape(NBLK, BLKC)
    j = jnp.arange(ROWW, dtype=jnp.int32)
    rows = jnp.sum(
        jnp.where(wib[:, :, None] == j[None, None, :], ab[:, :, None], jnp.uint32(0))
        + jnp.where(wib[:, :, None] == (j - 1)[None, None, :], bb[:, :, None], jnp.uint32(0)),
        axis=1,
    )  # [NBLK, ROWW] u32

    # Word advance per block (includes lane-end word-align padding; the
    # straddle word at local index adv_b overlaps the next block's word 0
    # and is merged by OR below — bits are disjoint).
    adv = jnp.concatenate([W0_flat[1:], total_words[None]]) - W0_flat

    # --- Hierarchical merge: block rows -> GBLK-block superrows. Each
    # round pairs rows and ORs the right row barrel-shifted by the left
    # row's accumulated advance. log2(GBLK) rounds of pure vector selects
    # (measured 15.2 ms at the bench geometry vs ~37 ms for the v2
    # per-word seeds+cumsum+gather expansion this replaces).
    NBLKP = -(-NBLK // GBLK) * GBLK
    padb = NBLKP - NBLK
    adv_p = jnp.pad(adv, (0, padb)) if padb else adv
    m_rows = jnp.pad(rows, ((0, padb), (0, 0))) if padb else rows
    m_adv = adv_p
    W0p = (
        jnp.concatenate([W0_flat, jnp.full((padb,), 1, jnp.int32) * total_words])
        if padb
        else W0_flat
    )
    # Pair slicing via reshape (contiguous column slices): 1-D stride-2
    # slicing lowers to a relayout on this chip — a scalar replica of this
    # loop on [N_k] arrays alone measured 17.5 ms; reshape-based 4.5 ms.
    W = ROWW
    rnd = 1
    while W < SUPW:
        W_out = min(2 * W, SUPW)
        r2 = m_rows.reshape(-1, 2 * W)
        left = r2[:, :W]
        right = r2[:, W:]
        a2 = m_adv.reshape(-1, 2)
        s = a2[:, 0]
        x = jnp.pad(right, ((0, 0), (0, W_out - W)))
        for bit in range(rnd + 5):
            sv = 1 << bit
            x = jnp.where(((s & sv) != 0)[:, None], jnp.pad(x, ((0, 0), (sv, 0)))[:, :W_out], x)
        m_rows = jnp.pad(left, ((0, 0), (0, W_out - W))) | x
        m_adv = a2[:, 0] + a2[:, 1]
        W = W_out
        rnd += 1
    sup = m_rows  # [NSB, SUPW] u32, dense at word 0
    advs = m_adv  # [NSB] content words (straddle excluded)
    NSB = NBLKP // GBLK
    S0 = W0p[::GBLK]  # [NSB] absolute word start

    # Placement-overflow flag: a block's LIVE bits always sit in [0, ROWW)
    # of its row, so if every block in a superblock advances <= 32 words,
    # every merge round's placement fits with slack (adv_left + ce_right
    # <= 32*2^rnd + 2 <= 34*2^rnd = W_out, barrel budget 2^(rnd+5)-1 >=
    # 2^(rnd+4) = max adv_left). A block advancing >32 words is possible
    # only via patch-displaced gaps (>=2 long codes in one 32-code block
    # — a k-estimation catastrophe, never isolated spikes); those
    # superblocks may lose/garble bits WITHIN their own span (assembly
    # reads are masked to [0, adv]) and their lanes are flagged for exact
    # host re-packing. advs > SUPW-TILE additionally would let an owner
    # window (start <= advs) read past the superrow into the next row's
    # unit 0 unmasked.
    sb_over = jnp.any(adv_p.reshape(NSB, GBLK) > BLKC, axis=1) | (advs > SUPW - TILE)

    # --- Tile-assembly bookkeeping (NSB domain, ~thousands of elements).
    sidx = jnp.arange(NSB, dtype=jnp.int32)
    nonempty = advs > 0
    # Next nonempty superblock strictly after s, shifted so that
    # nxtx[pos + 1] walks the chain from pos (pos = -1 starts at the
    # first nonempty superblock overall).
    nn = jax.lax.cummin(jnp.where(nonempty, sidx, NSB), reverse=True)
    nxtx = jnp.concatenate([nn, jnp.full((2,), NSB, jnp.int32)])
    # Owner deltas: owner[u] = last nonempty s with S0_s < 128*u, via a
    # delta scatter at tile (S0>>7)+1 and a cumsum in stage 2.
    pni = jax.lax.cummax(jnp.where(nonempty, sidx, -1))
    prev = jnp.concatenate([jnp.full((1,), -1, jnp.int32), pni[:-1]])
    own_ds = jnp.where(nonempty, sidx - prev, 0)
    own_t = jnp.where(nonempty, (S0 >> 7) + 1, jnp.int32(1 << 30))
    S0x = jnp.concatenate([S0, jnp.full((1,), 1 << 29, jnp.int32)])
    advx = jnp.concatenate([advs, jnp.full((1,), -1, jnp.int32)])

    # --- Fast-path violations -> per-lane bad flags (host re-pack).
    # (a) Merge placement overflow (sb_over, computed above).
    # (b) More than RCAND-1 nonempty superblocks starting in one tile:
    #     the candidate loop can't cover the tile. Detect via the
    #     (RCAND-1)-th previous nonempty superblock sharing the tile.
    rk = jnp.cumsum(nonempty.astype(jnp.int32)) - 1
    posn = (
        jnp.full((NSB,), NSB, jnp.int32)
        .at[jnp.where(nonempty, rk, NSB)]
        .set(sidx, mode="drop")
    )
    t_s = S0 >> 7
    prevK = posn[jnp.clip(rk - (RCAND - 1), 0, NSB - 1)]
    crowded = nonempty & (rk >= RCAND - 1) & (jnp.take(t_s, prevK) == t_s)

    # Mark every lane whose words intersect a polluted region. Lane of a
    # word via binary search over the (sorted) lane word offsets; range
    # marking via +-1 scatters and a cumsum over the tiny [L] domain.
    def lane_of(w):
        return jnp.clip(
            jnp.searchsorted(lane_woff, w, side="right").astype(jnp.int32) - 1,
            0,
            L - 1,
        )

    markers = jnp.zeros((L + 1,), jnp.int32)
    crow_i = crowded.astype(jnp.int32)
    markers = markers.at[lane_of(t_s * TILE)].add(crow_i, mode="drop")
    markers = markers.at[lane_of(t_s * TILE + (TILE - 1)) + 1].add(-crow_i, mode="drop")
    over_i = (sb_over & nonempty).astype(jnp.int32)
    markers = markers.at[lane_of(S0)].add(over_i, mode="drop")
    markers = markers.at[lane_of(S0 + advs) + 1].add(-over_i, mode="drop")
    lane_cov_bad = (jnp.cumsum(markers)[:L] > 0) & (lane_words > 0)

    # --- Compacted patch list (>32-bit codes and overflow-wi codes).
    # Patches are rare, so compact in two levels with cumsum-rank + tiny
    # scatters — a flat jnp.nonzero over L*Sp codes lowers to a full
    # device sort (~100 ms at this geometry; tools/stage1_decompose.py).
    qp = jnp.pad(q, ((0, 0), (0, pad))) if pad else q
    up = jnp.pad(u_rice, ((0, 0), (0, pad))) if pad else u_rice
    patch_b = is_patch.reshape(NBLK, BLKC)
    blk_has = jnp.any(patch_b, axis=1)
    n_pblk = jnp.sum(blk_has, dtype=jnp.int32)
    n_patch = jnp.sum(patch_b, dtype=jnp.int32)

    def _compact(args):
        # The block-rank scatter (NBLK indices) + PATCH_CAP compaction is
        # ~5-7 ms at the bench geometry; lax.cond skips it entirely on the
        # (common) patch-free batch.
        blk_has, patch_b, s_b, clen_b, q_b, u_b = args
        brank = jnp.cumsum(blk_has.astype(jnp.int32)) - 1
        bdest = jnp.where(blk_has, brank, PATCH_BLOCKS)
        bidx_sel = (
            jnp.full((PATCH_BLOCKS,), NBLK, jnp.int32)
            .at[bdest]
            .set(jnp.arange(NBLK, dtype=jnp.int32), mode="drop",
                 indices_are_sorted=True)
        )
        grab = jnp.minimum(bidx_sel, NBLK - 1)
        g_flag = patch_b[grab] & (bidx_sel < NBLK)[:, None]
        gf = g_flag.reshape(-1)
        crank = jnp.cumsum(gf.astype(jnp.int32)) - 1
        cdest = jnp.where(gf, crank, PATCH_CAP)
        put = lambda src: (
            jnp.zeros((PATCH_CAP,), src.dtype)
            .at[cdest]
            .set(src[grab].reshape(-1), mode="drop", indices_are_sorted=True)
        )
        return put(s_b), put(clen_b), put(q_b), put(u_b)

    def _nopatch(args):
        return (
            jnp.zeros((PATCH_CAP,), jnp.int32),
            jnp.zeros((PATCH_CAP,), jnp.int32),
            jnp.zeros((PATCH_CAP,), jnp.int32),
            jnp.zeros((PATCH_CAP,), jnp.uint32),
        )

    p_s, p_clen, p_q, p_u = jax.lax.cond(
        n_patch > 0,
        _compact,
        _nopatch,
        (
            blk_has,
            patch_b,
            abs_start.reshape(NBLK, BLKC),
            clen_p.reshape(NBLK, BLKC),
            qp.reshape(NBLK, BLKC),
            up.reshape(NBLK, BLKC),
        ),
    )
    live_c = jnp.arange(PATCH_CAP, dtype=jnp.int32) < jnp.minimum(n_patch, PATCH_CAP)

    bad = (
        jnp.any(is_patch.reshape(L, Sp), axis=1)
        & ((n_patch > PATCH_CAP) | (n_pblk > PATCH_BLOCKS))
    ) | lane_cov_bad

    stage = {
        "sup": sup,
        "S0x": S0x,
        "advx": advx,
        "nxtx": nxtx,
        "own_t": own_t,
        "own_ds": own_ds,
        "p_s": p_s,
        "p_clen": p_clen,
        "p_q": p_q,
        "p_u": p_u,
        "p_live": live_c,
    }
    if _DEBUG_STAGE_EXTRAS:
        stage = dict(stage, rows=rows, adv=adv)
    return stage, lane_bytes.astype(jnp.int32), lane_off.astype(jnp.int32), bad


#: Trace-time flag for profiling tools (tools/stage1_decompose.py): adds
#: the pre-merge block rows to the stage dict so DCE variants can time the
#: spread separately from the merge. Never set in production.
_DEBUG_STAGE_EXTRAS = False


@partial(jax.jit, static_argnames=("NW",))
def pack_stage2(sup, S0x, advx, nxtx, own_t, own_ds,
                p_s, p_clen, p_q, p_u, p_live, NW: int,
                rows=None, adv=None):
    """Assemble the word stream at a bucketed size (static NW words,
    multiple of TILE).

    Returns words u32 [NW] already byte-swapped to host little-endian
    layout: ``np.asarray(words).view(np.uint8)`` IS the MSB-first byte
    stream (fetch_words_finish is a zero-copy view).
    """
    assert NW % TILE == 0
    NSB = sup.shape[0]
    NT = NW // TILE
    sup6 = sup.reshape(NSB * _SUP_UNITS, TILE)

    # Owner superblock per tile: cumsum of the stage-1 delta scatter.
    seed = (
        jnp.zeros((NT + 1,), jnp.int32)
        .at[jnp.clip(own_t, 0, NT)]
        .add(own_ds, mode="drop", indices_are_sorted=True)
    )
    owner = jnp.cumsum(seed)[:NT] - 1  # [-1 .. NSB-1]

    u0 = jnp.arange(NT, dtype=jnp.int32) * TILE
    jj = jnp.arange(TILE, dtype=jnp.int32)
    acc = jnp.zeros((NT, TILE), jnp.uint32)
    pos = owner  # candidate walker; -1 = "before the first superblock"
    for r in range(RCAND):
        s_cur = jnp.where(pos < 0, NSB, pos)  # NSB = sentinel row
        S0r = jnp.take(S0x, s_cur)
        advr = jnp.take(advx, s_cur)
        o = u0 - S0r  # window start within the superrow
        if r == 0:
            # Owner window: o in [1, adv] <= 4096 -> two aligned units.
            qo = jnp.clip(o, 0, SUPW - 1) >> 7
            base = jnp.clip(s_cur, 0, NSB - 1) * _SUP_UNITS + qo
            hi = NSB * _SUP_UNITS - 1
            U0 = jnp.take(sup6, jnp.clip(base, 0, hi), axis=0)
            U1 = jnp.take(sup6, jnp.clip(base + 1, 0, hi), axis=0)
            x = jnp.concatenate([U0, U1], axis=1)  # [NT, 2*TILE]
            sh = jnp.clip(o, 0, SUPW - 1) & (TILE - 1)
            for bit in range(7):
                sv = 1 << bit
                x = jnp.where(
                    ((sh & sv) != 0)[:, None],
                    jnp.pad(x, ((0, 0), (0, sv)))[:, sv:],
                    x,
                )
            win = x[:, :TILE]
        else:
            # In-tile starters: o in (-TILE, 0] -> unit 0, shifted right.
            base = jnp.clip(s_cur, 0, NSB - 1) * _SUP_UNITS
            x = jnp.take(sup6, base, axis=0)
            p = jnp.clip(-o, 0, TILE - 1)
            for bit in range(7):
                sv = 1 << bit
                x = jnp.where(
                    ((p & sv) != 0)[:, None],
                    jnp.pad(x, ((0, 0), (sv, 0)))[:, :TILE],
                    x,
                )
            win = x
        srcw = o[:, None] + jj[None, :]
        m = (srcw >= 0) & (srcw <= advr[:, None])
        acc = acc | jnp.where(m, win, jnp.uint32(0))
        if r + 1 < RCAND:
            pos = jnp.take(nxtx, pos + 1)

    words = acc.reshape(NW)

    # Patch pass: write each flagged code's full bit pattern additively
    # (its words are untouched by the spread, neighbours' bits disjoint).
    first_word = p_s >> 5

    def code_word(t):
        """32-bit word t of the code's span, MSB-first (vector [PATCH_CAP])."""
        base = (first_word + t) << 5  # absolute bit of word bit 0
        acc = jnp.zeros_like(p_s)
        for s2 in range(32):
            o = base + s2 - p_s
            in_code = (o >= 0) & (o < p_clen)
            is_one = o < p_q
            rem_sh = jnp.clip(p_clen - 1 - o, 0, 31).astype(jnp.uint32)
            rem_bit = ((p_u >> rem_sh) & 1).astype(jnp.int32)
            bit = jnp.where(is_one, 1, jnp.where(o == p_q, 0, rem_bit))
            acc = acc + jnp.where(in_code, bit << (31 - s2), 0)
        return acc

    # All PATCH_WORDS contributions in ONE scatter-add: ten sequential
    # .at[].add passes on the [NW] words array each risk a full aliasing
    # copy of the payload between scatters.
    contribs = jnp.stack([code_word(t) for t in range(PATCH_WORDS)])
    tgts = jnp.where(
        p_live[None, :] & (contribs != 0),
        first_word[None, :] + jnp.arange(PATCH_WORDS, dtype=p_s.dtype)[:, None],
        NW,
    )
    words = jax.lax.bitcast_convert_type(
        jax.lax.bitcast_convert_type(words, jnp.int32)
        .at[tgts.reshape(-1)]
        .add(contribs.reshape(-1), mode="drop"),
        jnp.uint32,
    )
    # Byte-swap on device: the stream is MSB-first within each u32, so
    # emitting the swapped word makes the host's little-endian u32 buffer
    # equal the byte stream — the download needs no host-side byteswap copy.
    return (
        (words >> 24)
        | ((words >> 8) & jnp.uint32(0x0000FF00))
        | ((words << 8) & jnp.uint32(0x00FF0000))
        | (words << 24)
    )


def pack_worst_words(L: int, S: int) -> int:
    """Static word-count bound for a [L, S] batch, for fusing pack_stage2
    into the dispatch program (no mid-pass size download): every winner's
    payload is <= the raw baseline (16 bits/sample — ops/select demotes
    winners whose exact size is not strictly below raw), and lane payloads
    word-align independently. Rounded up to a TILE multiple.

    Sizing stage 2 at this bound costs a little slack per word (v3
    assembly), while downloading the exact sizes between stages puts a
    device->host read on the device stream every pass. Worst case won where
    this was measured; it is still to be re-measured on the GPU.
    """
    n = L * ((16 * S + 31) >> 5)
    return -(-max(n, 1) // TILE) * TILE


def bucket_words(n: int, floor: int = 1 << 16) -> int:
    """{1, 1.5} x 2^k growth bucket for the stage-2 word count."""
    from ..buckets import grow_bucket

    return grow_bucket(n, floor)


def fetch_words_start(words_dev, total_bytes: int):
    """Dispatch + async-start the packed payload download (u32 words)."""
    from .ricepack import fetch_prefix_start

    if total_bytes <= 0:
        return None
    return fetch_prefix_start(words_dev, -(-total_bytes // 4))


def fetch_words_finish(h, total_bytes: int) -> np.ndarray:
    """Finish the download; returns the MSB-first byte stream as a
    zero-copy ``np.uint8`` view of the downloaded words (pack_stage2
    byte-swapped on device)."""
    from .ricepack import fetch_prefix_finish

    if h is None:
        return np.zeros(0, np.uint8)
    w = fetch_prefix_finish(h, -(-total_bytes // 4))
    return np.ascontiguousarray(w).view(np.uint8)[:total_bytes]


#: Last ACTUAL payload byte size per (caller, geometry) key. Dispatch-time
#: speculative prefetches size themselves from the previous identically-
#: shaped chunk — bulk content is steady, so after the first chunk the
#: speculative slice covers the payload and the download streams while the
#: host is busy collecting OTHER pipelines (tools/pass_timeline.py measured
#: decode payload fetches starting 2.4-2.6 s after their dispatch because
#: the fetch waited for collect()'s turn on the single host thread).
#: Invariant: values are SIZE HINTS only — a stale/garbage value costs an
#: extra tail fetch or wasted wire but never changes results
#: (tests/test_spec_prefetch.py). Bounded by _SPEC_CAP; reset between
#: tests via reset_spec_cache().
_SPEC_BYTES: dict = {}
_SPEC_CAP = 1024


def reset_spec_cache() -> None:
    """Clear the speculative-sizing cache (test isolation hook)."""
    _SPEC_BYTES.clear()

#: Master switch for dispatch-time speculative payload prefetch (all four
#: bulk pipelines consult it). Runtime-mutable for A/B measurement.
SPEC_PREFETCH = True


def fetch_words_spec_start(words_dev, key, cold_estimate: int):
    """Speculative payload prefetch AT DISPATCH TIME, before the actual
    payload size is host-readable. Sized from the previous chunk with the
    same `key` (falling back to `cold_estimate` bytes), bucketed by
    :data:`ricepack.PREFIX_BUCKET` and clamped to the buffer. Resolve with
    :func:`fetch_words_spec_finish` — overshoot wastes at most the estimate
    error + one bucket of wire; undershoot costs one extra tail fetch at
    collect (what every fetch cost before speculation existed)."""
    from .ricepack import fetch_prefix_start

    if not SPEC_PREFETCH:
        return None
    want = int(_SPEC_BYTES.get(key, cold_estimate))
    nw = -(-want // 4)
    h = fetch_prefix_start(words_dev, nw) if nw > 0 else None
    covered = int(h.shape[0]) * 4 if h is not None else 0
    return (h, covered, key)


def fetch_words_spec_resolve(spec, words_dev, total_bytes: int):
    """Phase 1 (non-blocking): resolve a dispatch-time speculative prefetch
    against the ACTUAL payload size — on a partial hit async-start the
    missing tail, on a cold miss async-start a plain prefix fetch. Records
    the actual size under the spec's key for the next same-shaped chunk.
    Block on the result with :func:`fetch_words_spec_collect`."""
    from .ricepack import fetch_range_start

    h, covered, key = spec if spec is not None else (None, 0, None)
    if key is not None:
        if len(_SPEC_BYTES) >= _SPEC_CAP and key not in _SPEC_BYTES:
            _SPEC_BYTES.clear()  # geometry keys are few; full reset is fine
        _SPEC_BYTES[key] = total_bytes
    if total_bytes <= 0 or h is None:
        return (fetch_words_start(words_dev, total_bytes), None, 0, total_bytes)
    if total_bytes <= covered:
        return (None, (h, None), covered, total_bytes)
    lo_w = covered // 4
    tail_nw = -(-total_bytes // 4) - lo_w
    hr = fetch_range_start(words_dev, lo_w, tail_nw)
    return (None, (h, hr), covered, total_bytes)


def fetch_words_spec_collect(token) -> np.ndarray:
    """Phase 2 (blocking): finish the downloads a spec resolve started and
    return the payload byte stream."""
    from .ricepack import fetch_range_finish

    plain_h, spec_pair, covered, total_bytes = token
    if spec_pair is None:
        return fetch_words_finish(plain_h, total_bytes)
    h, hr = spec_pair
    head = np.ascontiguousarray(np.asarray(h)).view(np.uint8)
    if hr is None:
        return head[:total_bytes]
    tail_nw = -(-total_bytes // 4) - covered // 4
    tail = np.ascontiguousarray(fetch_range_finish(hr, tail_nw)).view(np.uint8)
    out = np.empty(total_bytes, np.uint8)
    out[:covered] = head
    out[covered:] = tail[: total_bytes - covered]
    return out


def pack_lanes_words(residuals, k, nvalid, is_raw, NW: int):
    """Single-call convenience (stage1 + stage2 at a caller-chosen NW);
    the production pipelines split the stages to size NW from the downloaded
    lane sizes. Call inside jit or rely on pack_stage2's jit."""
    stage, lane_bytes, lane_off, bad = pack_stage1(residuals, k, nvalid, is_raw)
    words = pack_stage2(NW=NW, **stage)
    return words, lane_bytes, lane_off, bad
