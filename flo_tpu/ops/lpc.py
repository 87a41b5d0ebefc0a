"""LPC kernels: batched reconstruction scan and residual computation.

Batch-first design: the unit of work is a batch of *lanes* (one lane = one
frame-channel). Throughput comes from lane parallelism — the reconstruction
recurrence is sequential in time but fully vectorized across lanes, while the
encoder's residual computation has no sequential dependence at all and runs as
a batched 12-tap integer convolution.

One universal kernel covers every lossless frame type
(lossless/decoder.rs:92-273):

* LPC order 1-12: stored coefficients, i64-exact MAC + >> shift
  (via 15-bit limb math, see ops/intmath.py), warm-up = residuals verbatim.
* Fixed predictors 0-4: binomial coefficients with shift 0; their documented
  ramp-up (order o uses predictor order min(i, o) for the first samples,
  decoder.rs:187-273) is reproduced by swapping in a global per-step ramp
  coefficient row while i < order.
* Raw/silence: zero coefficients -> identity on residuals.

All adds wrap in int32 exactly like the reference's release-mode arithmetic.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .intmath import dot_f32, predict_shift

MAX_ORDER = 12

#: Binomial difference-filter coefficients for fixed predictors 0..4
#: (lpc.rs:301-359), padded to MAX_ORDER taps.
_FIXED_COEFFS = np.zeros((5, MAX_ORDER), dtype=np.int32)
_FIXED_COEFFS[1, :1] = [1]
_FIXED_COEFFS[2, :2] = [2, -1]
_FIXED_COEFFS[3, :3] = [3, -3, 1]
_FIXED_COEFFS[4, :4] = [4, -6, 4, -1]


@partial(jax.jit, static_argnames=("unroll",))
def reconstruct(residuals, coeffs, shifts, orders, is_fixed, unroll: int = 8):
    """Reconstruct samples from residuals for a batch of lanes.

    Args:
      residuals: [L, S] int32 (zero-padded beyond each lane's true length).
      coeffs:    [L, MAX_ORDER] int32, zero-padded; coeffs[:, j] multiplies
                 sample i-1-j.
      shifts:    [L] int32 in [0, 15].
      orders:    [L] int32 — warm-up length (LPC order / fixed order).
      is_fixed:  [L] bool — lane uses a fixed predictor (ramp-up startup).

    Returns: [L, S] int32 reconstructed samples.
    """
    L, S = residuals.shape
    fixed_table = jnp.asarray(_FIXED_COEFFS)

    def step(carry, xs):
        r_i, i = xs
        ramp_row = fixed_table[jnp.minimum(i, 4)]
        use_ramp = i < orders
        c_eff = jnp.where(
            use_ramp[:, None],
            jnp.where(is_fixed[:, None], ramp_row[None, :], jnp.int32(0)),
            coeffs,
        )
        pred = predict_shift(c_eff, carry, shifts)
        s = pred + r_i  # wrapping int32 add
        new_carry = jnp.concatenate([s[:, None], carry[:, :-1]], axis=1)
        return new_carry, s

    carry0 = jnp.zeros((L, MAX_ORDER), dtype=jnp.int32)
    xs = (residuals.T, jnp.arange(S, dtype=jnp.int32))
    _, out = jax.lax.scan(step, carry0, xs, unroll=unroll)
    return out.T


def reconstruct_best(residuals, coeffs, shifts, orders, is_fixed, mesh=None):
    """Reconstruction on whatever platform the enclosing jit is lowered for:
    the Triton kernel (ops/triton_lpc.py) on CUDA, the scan elsewhere.

    ``mesh``: the 1-D 'batch' mesh the lane axis is sharded over, if any.
    Lanes are independent, so each device reconstructs its own shard (the
    kernel is opaque to XLA's partitioner, which would otherwise gather
    every lane onto every device).
    """
    from .triton_lpc import reconstruct_triton

    def run(*args):
        return jax.lax.platform_dependent(
            *args, cuda=reconstruct_triton, default=reconstruct
        )

    args = (residuals, coeffs, shifts, orders, is_fixed)
    if mesh is None:
        return run(*args)
    from jax.sharding import PartitionSpec as P

    return jax.shard_map(
        run, mesh=mesh, in_specs=P("batch"), out_specs=P("batch"), check_vma=False
    )(*args)


def reconstruct_host(residuals, coeffs, shifts, orders, is_fixed) -> np.ndarray:
    """Exact numpy mirror of :func:`reconstruct` (i64 MAC + arithmetic shift,
    int32 wrap — the reference's release-mode semantics, decoder.rs:92-273).

    Test oracle and the pure-Python fallback behind the C++ reconstruction
    (native.lpc_reconstruct_into) when no toolchain is available.
    Vectorized across lanes; sequential over samples.
    """
    residuals = np.asarray(residuals, np.int32)
    L, S = residuals.shape
    coeffs64 = np.asarray(coeffs, np.int64)
    shifts64 = np.asarray(shifts, np.int64)
    orders = np.asarray(orders)
    is_fixed = np.asarray(is_fixed, bool)
    carry = np.zeros((L, MAX_ORDER), np.int64)
    out = np.empty((L, S), np.int32)
    fixed64 = _FIXED_COEFFS.astype(np.int64)
    for i in range(S):
        use_ramp = i < orders
        c_eff = np.where(
            use_ramp[:, None],
            np.where(is_fixed[:, None], fixed64[min(i, 4)][None, :], 0),
            coeffs64,
        )
        pred = np.einsum("lj,lj->l", c_eff, carry) >> shifts64
        s = pred + residuals[:, i]
        s32 = ((s + (1 << 31)) & 0xFFFFFFFF).astype(np.int64) - (1 << 31)
        out[:, i] = s32.astype(np.int32)
        carry[:, 1:] = carry[:, :-1]
        carry[:, 0] = s32
    return out


def autocorrelation_device(lanes, nvalid, max_order: int):
    """On-device autocorrelation lags 0..max_order, as float32.

    Each lag is summed exactly in int32 limbs (intmath.dot_f32, domain
    |s| <= 2^17) and rounded once to float32, so a lane's result does not
    depend on the batch or shard it is computed in, and the proposed
    coefficients, hence the stream's bytes, do not either. Round-trip
    exactness never depends on them: coefficients are stored in the stream.
    lanes [L, S] i32, nvalid [L] -> [L, max_order+1] f32.
    """
    L, S = lanes.shape
    mask = jnp.arange(S, dtype=jnp.int32)[None, :] < nvalid[:, None]
    x = jnp.where(mask, lanes, 0)
    cols = [
        dot_f32(x, jnp.pad(x, ((0, 0), (lag, 0)))[:, :S])
        for lag in range(max_order + 1)
    ]
    return jnp.stack(cols, axis=1)


def levinson_device(ac, max_order: int):
    """On-device Levinson-Durbin for every order 1..max_order, vectorized
    across lanes (f32 analog of :func:`levinson_durbin_all_orders`; same
    instability rejection and fixed-point quantization rules,
    lpc.rs:225-276).

    ac: [L, max_order+1] f32. Returns (coeffs_fp [L, max_order, MAX_ORDER]
    i32, shifts [L, max_order] i32, valid [L, max_order] bool).
    """
    L = ac.shape[0]
    j_idx = jnp.arange(MAX_ORDER, dtype=jnp.int32)

    def step(carry, i):
        coeffs, error, alive = carry
        # lam = ac[i+1] - sum_{j<i} coeffs[j] * ac[i-j]
        gather = jnp.take_along_axis(
            ac, jnp.clip(i - j_idx, 0, ac.shape[1] - 1)[None, :].repeat(L, 0), axis=1
        )
        # Subtracted term by term in a fixed order, not by a reduction whose
        # order the compiler picks per shape.
        terms = jnp.where(j_idx[None, :] < i, coeffs * gather, 0.0)
        lam = ac[:, i + 1]
        for j in range(MAX_ORDER):
            lam = lam - terms[:, j]
        dead = jnp.abs(error) < 1e-10
        alive = alive & ~dead
        gamma = jnp.where(alive, lam / jnp.where(error == 0, 1.0, error), 0.0)
        alive = alive & (jnp.abs(gamma) < 1.0)

        # new[j] = coeffs[j] - gamma*coeffs[i-1-j] for j<i; new[i] = gamma
        rev = jnp.take_along_axis(
            coeffs, jnp.clip(i - 1 - j_idx, 0, MAX_ORDER - 1)[None, :].repeat(L, 0), axis=1
        )
        new = jnp.where(
            j_idx[None, :] < i,
            coeffs - gamma[:, None] * rev,
            jnp.where(j_idx[None, :] == i, gamma[:, None], coeffs),
        )
        coeffs = jnp.where(alive[:, None], new, coeffs)
        error = error * (1.0 - gamma * gamma)

        # Quantize the order-(i+1) snapshot.
        in_order = j_idx[None, :] <= i
        c_now = jnp.where(in_order, coeffs, 0.0)
        max_c = jnp.max(jnp.abs(c_now), axis=1)
        ok = alive & (max_c > 0) & jnp.isfinite(max_c)
        shift = jnp.floor(jnp.log2((1 << 30) / jnp.where(ok, max_c, 1.0)))
        shift = jnp.clip(shift, 0, 15).astype(jnp.int32)
        scaled = c_now * jnp.exp2(shift.astype(jnp.float32))[:, None]
        q = jnp.sign(scaled) * jnp.floor(jnp.abs(scaled) + 0.5)
        q = jnp.clip(q, -(2.0**31), 2.0**31 - 1).astype(jnp.int32)
        q = jnp.where(ok[:, None], q, 0)
        return (coeffs, error, alive), (q, shift, ok)

    init = (jnp.zeros((L, MAX_ORDER), jnp.float32), ac[:, 0], ac[:, 0] != 0.0)
    _, (qs, shifts, valid) = jax.lax.scan(
        step, init, jnp.arange(max_order, dtype=jnp.int32)
    )
    return (
        jnp.moveaxis(qs, 0, 1),      # [L, max_order, MAX_ORDER]
        jnp.moveaxis(shifts, 0, 1),  # [L, max_order]
        jnp.moveaxis(valid, 0, 1),   # [L, max_order]
    )


def levinson_durbin_all_orders(autocorr: np.ndarray, max_order: int):
    """Vectorized (host, float64) Levinson-Durbin producing coefficients for
    *every* order 1..max_order in one recursion.

    Mirrors the numerical behavior of levinson_durbin_int (lpc.rs:225-276):
    float64 recursion on autocorrelation, instability rejection when
    |gamma| >= 1 or the error vanishes, then fixed-point quantization with
    shift = min(floor(log2(2^30 / max|c|)), 15).

    Args:
      autocorr: [L, max_order+1] float64.
      max_order: highest order to produce.

    Returns:
      coeffs_fp: [L, max_order, MAX_ORDER] int32 quantized coefficients where
                 coeffs_fp[:, o-1] is the order-o predictor (zero-padded).
      shifts:    [L, max_order] uint8.
      valid:     [L, max_order] bool — False where the recursion bailed
                 (matching the reference returning None).
    """
    ac = np.asarray(autocorr, dtype=np.float64)
    L = ac.shape[0]
    coeffs = np.zeros((L, max_order), dtype=np.float64)
    out_c = np.zeros((L, max_order, MAX_ORDER), dtype=np.int32)
    out_shift = np.zeros((L, max_order), dtype=np.uint8)
    valid = np.zeros((L, max_order), dtype=bool)

    error = ac[:, 0].copy()
    alive = ac[:, 0] != 0.0

    for i in range(max_order):
        lam = ac[:, i + 1].copy()
        for j in range(i):
            lam -= coeffs[:, j] * ac[:, i - j]
        dead = np.abs(error) < 1e-10
        alive = alive & ~dead
        with np.errstate(divide="ignore", invalid="ignore"):
            gamma = np.where(alive, lam / np.where(error == 0, 1.0, error), 0.0)
        alive = alive & (np.abs(gamma) < 1.0)

        new = coeffs.copy()
        new[:, i] = gamma
        for j in range(i):
            new[:, j] = coeffs[:, j] - gamma * coeffs[:, i - 1 - j]
        coeffs = np.where(alive[:, None], new, coeffs)
        error = error * (1.0 - gamma * gamma)

        order = i + 1
        c_now = coeffs[:, :order]
        max_c = np.abs(c_now).max(axis=1)
        ok = alive & (max_c > 0) & np.isfinite(max_c)
        with np.errstate(divide="ignore", invalid="ignore"):
            shift = np.floor(np.log2((1 << 30) / np.where(ok, max_c, 1.0)))
        # Rust: `... as u8` saturates (negative -> 0, huge -> 255), then min(15).
        shift_u8 = np.clip(shift, 0, 15).astype(np.uint8)
        scale = np.ldexp(1.0, shift_u8.astype(np.int64))
        # Rust f64::round = half away from zero; `as i32` saturates.
        scaled = c_now * scale[:, None]
        q = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5)
        q = np.clip(q, -(2**31), 2**31 - 1)
        out_c[:, i, :order] = np.where(ok[:, None], q, 0).astype(np.int64).astype(np.int32)
        out_shift[:, i] = np.where(ok, shift_u8, 0)
        valid[:, i] = ok

    return out_c, out_shift, valid
