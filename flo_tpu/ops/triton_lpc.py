"""GPU kernel for the batched integer LPC reconstruction (Pallas, Triton route).

The decoder's only sequential operation:

    s[i] = r[i] + ((sum_j c_eff[j] * s[i-1-j]) >> shift)      (int32 wrap)

with the warm-up rule of lossless/decoder.rs:92-273 (while i < order, fixed
lanes use the ramped fixed predictor FIXED[min(i, 4)] and LPC lanes use zero
coefficients) and the exact i64-equivalent 15-bit-limb arithmetic of
ops/intmath.py.

Under XLA the recurrence is a 44,100-step while loop that launches kernels
on every step. Here one program owns a block of BLOCK_LANES lanes and runs
the whole time loop itself:

* residuals and output are time-major ``[S, L]``, so one time step of a lane
  block is one coalesced load and one coalesced store;
* the 12-sample carry is 12 register vectors of ``[BLOCK_LANES]`` int32, and
  the coefficient limbs are split once, outside the loop;
* the warm-up (``i < order <= 12``) is a 12-step prologue loop, so the main
  loop carries no per-step choice of coefficients;
* the main loop loads T_CHUNK residual rows before it starts the chunk's
  recurrence, so the loads stay off the carried dependency chain.

Lane blocks are independent, so programs may run in any order.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .lpc import _FIXED_COEFFS, MAX_ORDER

#: Lanes per program: one warp, one lane per thread. 960 lanes (the bulk
#: geometry) then run as 30 programs. 64 and 128 are bit-exact too, and on an
#: H100 (700 W) at [960, 44100] all three ran in 10.0-10.1 ms: each program
#: walks every step, so time follows the steps, not the lanes.
BLOCK_LANES = 32
#: Time steps whose residuals are loaded ahead of their recurrence. On an
#: H100 at [960, 44100], 1/2/4/8 steps ran in 21.3/14.7/10.1/9.9 ms and
#: compiled in 1.0/1.2/2.6/12.1 s (16 with an unrolled warm-up: 240 s).
T_CHUNK = 4
#: Warm-up steps run before the main loop: every order is at most MAX_ORDER.
WARMUP = MAX_ORDER

_MASK15 = 0x7FFF


def _predict(c_limbs, carry, shifts):
    """Exact ``(sum_j c[j] * carry[j]) >> shifts`` as wrapping int32.

    c_limbs: MAX_ORDER pairs ``(c >> 15, c & 0x7FFF)``, each entry an int32
    vector or a Python int; carry: MAX_ORDER int32 vectors; shifts: uint32
    vector in [0, 15]. Same limb sums and carries as intmath.limb_dot.
    """
    zero = jnp.zeros_like(carry[0])
    sa_hi = sa_lo = sp1_hi = sp1_lo = sp2_hi = sp2_lo = sp0_hi = sp0_lo = zero
    for (c1, c0), s in zip(c_limbs, carry):
        s1, s0 = s >> 15, s & _MASK15
        a = c1 * s1
        p1 = c1 * s0
        p2 = c0 * s1
        p0 = c0 * s0
        sa_hi += a >> 15
        sa_lo += a & _MASK15
        sp1_hi += p1 >> 15
        sp1_lo += p1 & _MASK15
        sp2_hi += p2 >> 15
        sp2_lo += p2 & _MASK15
        sp0_hi += p0 >> 15
        sp0_lo += p0 & _MASK15
    l3 = sa_hi
    l2 = sa_lo + sp1_hi + sp2_hi
    l1 = sp1_lo + sp2_lo + sp0_hi
    l0 = sp0_lo
    l1 = l1 + (l0 >> 15)
    l0 = l0 & _MASK15
    l2 = l2 + (l1 >> 15)
    l1 = l1 & _MASK15
    l3 = l3 + (l2 >> 15)
    l2 = l2 & _MASK15
    # (value >> shift) mod 2^32. A shift by 32 or more is undefined in LLVM,
    # so the L3 term is masked where 45 - shift reaches 32.
    lower = ((l1 << 15) | l0).astype(jnp.uint32)
    t_lower = lower >> shifts
    t_l2 = l2.astype(jnp.uint32) << (jnp.uint32(30) - shifts)
    amt3 = jnp.uint32(45) - shifts
    t_l3 = jnp.where(
        amt3 < 32,
        l3.astype(jnp.uint32) << jnp.minimum(amt3, jnp.uint32(31)),
        jnp.uint32(0),
    )
    return (t_l3 + t_l2 + t_lower).astype(jnp.int32)


def _ramp(i, j: int):
    """FIXED[min(i, 4)][j] for a traced step index ``i`` (a scalar)."""
    m = jnp.minimum(i, 4)
    out = jnp.int32(0)
    for order in range(1, 5):
        out = jnp.where(m == order, int(_FIXED_COEFFS[order, j]), out)
    return out


def _kernel(res_ref, coeffs_ref, shifts_ref, orders_ref, fixed_ref, out_ref,
            *, n_chunks: int):
    """One program: BLOCK_LANES (BL) lanes over the whole time axis.

    res_ref/out_ref: [WARMUP + n_chunks * T_CHUNK, BL] int32, time-major;
    coeffs_ref: [MAX_ORDER, BL] int32; shifts/orders/fixed_ref: [BL] int32.
    """
    coeffs = [coeffs_ref[j] for j in range(MAX_ORDER)]
    shifts = shifts_ref[...].astype(jnp.uint32)
    orders = orders_ref[...]
    fixed = fixed_ref[...] != 0
    zero = jnp.zeros_like(orders)

    # Warm-up: step i < order uses the ramp row FIXED[min(i, 4)] on fixed
    # lanes and zero coefficients on LPC lanes.
    def warm_step(i, carry):
        use_ramp = i < orders
        c_eff = [
            jnp.where(use_ramp, jnp.where(fixed, _ramp(i, j), 0), coeffs[j])
            for j in range(MAX_ORDER)
        ]
        c_limbs = [(c >> 15, c & _MASK15) for c in c_eff]
        s = _predict(c_limbs, carry, shifts) + res_ref[i]
        out_ref[i] = s
        return (s,) + carry[:-1]

    carry = jax.lax.fori_loop(0, WARMUP, warm_step, (zero,) * MAX_ORDER)

    c_limbs = [(c >> 15, c & _MASK15) for c in coeffs]

    def chunk(k, carry):
        base = WARMUP + k * T_CHUNK
        rs = [res_ref[base + t] for t in range(T_CHUNK)]
        for t in range(T_CHUNK):
            s = _predict(c_limbs, carry, shifts) + rs[t]  # wrapping int32 add
            out_ref[base + t] = s
            carry = (s,) + carry[:-1]
        return carry

    jax.lax.fori_loop(0, n_chunks, chunk, carry)


def padded_shape(L: int, S: int) -> tuple[int, int]:
    """(lanes, steps) the kernel runs after padding: lanes to a multiple of
    BLOCK_LANES, steps to WARMUP plus a multiple of T_CHUNK."""
    lanes = pl.cdiv(max(L, 1), BLOCK_LANES) * BLOCK_LANES
    steps = WARMUP + pl.cdiv(max(S - WARMUP, 0), T_CHUNK) * T_CHUNK
    return lanes, steps


@partial(jax.jit, static_argnames=("interpret",))
def reconstruct_triton(residuals, coeffs, shifts, orders, is_fixed,
                       interpret: bool = False):
    """Same contract as ops/lpc.reconstruct, as one Triton kernel.

    residuals [L, S] int32, coeffs [L, 12] int32, shifts/orders [L] int32,
    is_fixed [L] bool -> [L, S] int32. Padding lanes and steps hold zeros,
    which reconstruct to zeros, and are trimmed on return.
    """
    L, S = residuals.shape
    Lp, Sp = padded_shape(L, S)
    n_chunks = (Sp - WARMUP) // T_CHUNK

    def lanes(x):
        return jnp.pad(x.astype(jnp.int32), (0, Lp - L))

    res = jnp.pad(residuals, ((0, Lp - L), (0, Sp - S))).T  # [Sp, Lp]
    cfs = jnp.pad(coeffs, ((0, Lp - L), (0, 0))).T  # [MAX_ORDER, Lp]
    lane_spec = pl.BlockSpec((BLOCK_LANES,), lambda i: (i,))
    time_spec = pl.BlockSpec((Sp, BLOCK_LANES), lambda i: (0, i))
    out = pl.pallas_call(
        partial(_kernel, n_chunks=n_chunks),
        grid=(Lp // BLOCK_LANES,),
        in_specs=[
            time_spec,
            pl.BlockSpec((MAX_ORDER, BLOCK_LANES), lambda i: (0, i)),
            lane_spec,
            lane_spec,
            lane_spec,
        ],
        out_specs=time_spec,
        out_shape=jax.ShapeDtypeStruct((Sp, Lp), jnp.int32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=BLOCK_LANES // 32),
        interpret=interpret,
        name="lpc_reconstruct",
    )(res, cfs, lanes(shifts), lanes(orders), lanes(is_fixed))
    return out.T[:L, :S]
