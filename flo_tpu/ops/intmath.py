"""Exact wide-integer helpers in int32 only.

The reference codec does its LPC math with i64 multiply-accumulate followed by
an arithmetic right shift (lpc.rs:288-294, lossless/decoder.rs:169-179). JAX
runs with 32-bit integers unless x64 mode is on, so these helpers compute the
identical result using 15-bit limb decomposition in int32:

    c = c1*2^15 + c0,  s = s1*2^15 + s0   (c0, s0 in [0, 2^15))

    sum_j c_j*s_j = L3*2^45 + L2*2^30 + L1*2^15 + L0

with every limb and limb-sum provably inside int32 for the codec's domain
(|sample| < 2^25, |coeff| < 2^31, order <= 12 — real audio uses |sample| <=
2^17). The final ``(value >> shift) mod 2^32`` is assembled from the limbs
with uint32 wrapping arithmetic, matching Rust's ``(prediction >> shift) as
i32`` bit-for-bit, including the wrap-around cases.
"""

from __future__ import annotations

import jax.numpy as jnp

# Plain int (not jnp.int32): a module-level jnp constant would initialize a
# JAX backend at import time.
_MASK15 = 0x7FFF


def limb_dot(c, s):
    """Exact Σ c*s over the last axis, returned as canonical limbs.

    c, s: int32 arrays broadcastable to a common shape [..., T].
    Returns (L3, L2, L1, L0) int32 limbs with L0, L1, L2 in [0, 2^15) and
    value = L3*2^45 + L2*2^30 + L1*2^15 + L0.
    """
    c = c.astype(jnp.int32)
    s = s.astype(jnp.int32)
    c1, c0 = c >> 15, c & _MASK15
    s1, s0 = s >> 15, s & _MASK15

    A = c1 * s1  # contributes at 2^30
    P1 = c1 * s0  # at 2^15
    P2 = c0 * s1  # at 2^15
    P0 = c0 * s0  # at 2^0, non-negative

    def hi_lo_sum(x):
        return jnp.sum(x >> 15, axis=-1), jnp.sum(x & _MASK15, axis=-1)

    SAhi, SAlo = hi_lo_sum(A)
    SP1hi, SP1lo = hi_lo_sum(P1)
    SP2hi, SP2lo = hi_lo_sum(P2)
    SP0hi, SP0lo = hi_lo_sum(P0)

    L3 = SAhi
    L2 = SAlo + SP1hi + SP2hi
    L1 = SP1lo + SP2lo + SP0hi
    L0 = SP0lo

    # Canonicalize: propagate carries so L0, L1, L2 land in [0, 2^15).
    L1 = L1 + (L0 >> 15)
    L0 = L0 & _MASK15
    L2 = L2 + (L1 >> 15)
    L1 = L1 & _MASK15
    L3 = L3 + (L2 >> 15)
    L2 = L2 & _MASK15
    return L3, L2, L1, L0


def limb_shift_right_i32(L3, L2, L1, L0, shift):
    """(value >> shift) truncated to int32 (mod 2^32), for shift in [0, 15].

    Matches Rust's i64 arithmetic shift followed by an ``as i32`` cast.
    """
    shift = jnp.asarray(shift, jnp.uint32)
    lower = (L1 << 15) | L0  # in [0, 2^30), exact in int32
    t_lower = (lower.astype(jnp.uint32)) >> shift
    t_L2 = L2.astype(jnp.uint32) << (jnp.uint32(30) - shift)
    amt3 = jnp.uint32(45) - shift
    t_L3 = jnp.where(
        amt3 < 32,
        L3.astype(jnp.uint32) << jnp.minimum(amt3, jnp.uint32(31)),
        jnp.uint32(0),
    )
    return (t_L3 + t_L2 + t_lower).astype(jnp.int32)


def predict_shift(c, s, shift):
    """Exact ``(Σ_j c[...,j]*s[...,j]) >> shift`` as wrapping int32.

    The workhorse of both the residual computation (encoder) and the
    reconstruction recurrence (decoder).
    """
    L3, L2, L1, L0 = limb_dot(c, s)
    return limb_shift_right_i32(L3, L2, L1, L0, shift)


def predict_shift_taps(samples, coeffs, shifts):
    """Exact ``pred[..., i] = (Σ_j coeffs[..., j] * samples[..., i-1-j]) >> shift``
    with zero-padded lags, without materializing a [..., S, T] lag tensor.

    Tap-unrolled limb accumulation: identical arithmetic to
    ``predict_shift(coeffs, lagged, shift)`` (the encoder's batched causal
    prediction, lpc.rs:288-294) but each tap is a shifted view of ``samples``,
    so peak memory stays at a few [..., S] int32 buffers.

    samples: [..., S] int32; coeffs: [..., T] int32; shifts: [...] int or
    broadcastable. Returns [..., S] int32 (wrapping, bit-exact vs i64>>shift).
    """
    s = samples.astype(jnp.int32)
    S = s.shape[-1]
    T = coeffs.shape[-1]
    s1, s0 = s >> 15, s & _MASK15

    def lag(x, j):
        pad = [(0, 0)] * (x.ndim - 1) + [(j + 1, 0)]
        return jnp.pad(x, pad)[..., :S]

    zero = jnp.zeros_like(s)
    SAhi = SAlo = SP1hi = SP1lo = SP2hi = SP2lo = SP0hi = SP0lo = zero
    for j in range(T):
        c = coeffs[..., j : j + 1].astype(jnp.int32)
        c1, c0 = c >> 15, c & _MASK15
        l1, l0 = lag(s1, j), lag(s0, j)
        A = c1 * l1
        P1 = c1 * l0
        P2 = c0 * l1
        P0 = c0 * l0
        SAhi += A >> 15
        SAlo += A & _MASK15
        SP1hi += P1 >> 15
        SP1lo += P1 & _MASK15
        SP2hi += P2 >> 15
        SP2lo += P2 & _MASK15
        SP0hi += P0 >> 15
        SP0lo += P0 & _MASK15

    L3 = SAhi
    L2 = SAlo + SP1hi + SP2hi
    L1 = SP1lo + SP2lo + SP0hi
    L0 = SP0lo
    L1 = L1 + (L0 >> 15)
    L0 = L0 & _MASK15
    L2 = L2 + (L1 >> 15)
    L1 = L1 & _MASK15
    L3 = L3 + (L2 >> 15)
    L2 = L2 & _MASK15
    return limb_shift_right_i32(L3, L2, L1, L0, shifts)


#: Terms per int32 partial sum in :func:`dot_f32`: 9-bit limb products stay
#: within 2^17, so a chunk's sum stays within 2^29.
_DOT_CHUNK = 4096


def _balanced(x, bits: int):
    """(hi, lo) with x = hi * 2^bits + lo and lo in [-2^(bits-1), 2^(bits-1))."""
    half = 1 << (bits - 1)
    lo = ((x + half) & ((1 << bits) - 1)) - half
    return (x - lo) >> bits, lo


def dot_f32(a, b):
    """``Σ a*b`` over the last axis as float32, for int32 ``|a|, |b| <= 2^17``
    and at most 2^21 terms.

    The products and their sums are exact in int32 limbs; only the last five
    additions round, in a fixed order, so the result depends on the values
    alone. A float32 ``jnp.sum`` does not: its rounding follows the reduction
    order XLA picks for the array's shape, which on a GPU differs between a
    batch and each of its shards. The limbs are balanced (signed low digits),
    so they carry no bias that the last additions would have to cancel.
    """
    a = a.astype(jnp.int32)
    b = b.astype(jnp.int32)
    S = a.shape[-1]
    n = -(-S // _DOT_CHUNK)
    pad = [(0, 0)] * (a.ndim - 1) + [(0, n * _DOT_CHUNK - S)]
    shape = a.shape[:-1] + (n, _DOT_CHUNK)
    a1, a0 = _balanced(jnp.pad(a, pad).reshape(shape), 9)
    b1, b0 = _balanced(jnp.pad(b, pad).reshape(shape), 9)
    out = None
    # a*b = a1*b1*2^18 + (a1*b0 + a0*b1)*2^9 + a0*b0, each term within 2^17.
    for term, scale in ((a0 * b0, 0), (a1 * b0 + a0 * b1, 9), (a1 * b1, 18)):
        hi, lo = _balanced(jnp.sum(term, axis=-1), 15)  # per chunk, within 2^29
        hi = jnp.sum(hi, axis=-1).astype(jnp.float32)  # within 2^24: exact
        lo = jnp.sum(lo, axis=-1).astype(jnp.float32)
        # Scaling by a power of two is exact, so a fused multiply-add
        # rounds these the same as a multiply and an add.
        val = lo * 2.0**scale + hi * 2.0 ** (scale + 15)
        out = val if out is None else out + val
    return out


def div2_trunc(x):
    """Truncating division by 2 (Rust i32 `/ 2`), vs. Python's floor."""
    x = x.astype(jnp.int32)
    return jnp.where(x >= 0, x >> 1, -((-x) >> 1))
