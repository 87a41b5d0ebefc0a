#!/usr/bin/env python
"""What the GPU's float32 arithmetic does to the codec's output.

    python tools/determinism_probe.py [--files 8] [--seconds 60] [--parts shapes,lossy,control]

Each part prints one JSON line:

  shapes   lossless analysis="device" on one device: every lane's
           autocorrelation computed in the whole batch and in quarters of it
           (the shard a 4-device mesh gives each device), once with the exact
           integer sums the encoder uses (ops/intmath.dot_f32) and once with
           a plain float32 jnp.sum; the Levinson coefficients from each; and
           the bulk bytes of a quarter of the files encoded alone against the
           same files in the whole batch.
  lossy    the lossy encoder's quantization of the same input on the default
           device and on the CPU. Each difference by kind: a band's scale
           factor code (its truncation boundary), the SMR gate, a rounding by
           one step, or larger; how far each sat from its boundary on each
           backend; which backend a float64 host quantization (mdct_oracle,
           psycho.smr_host) agrees with; and how many output samples each
           kind moves by more than 2 i16 steps.
  control  the lossy bulk encode against the same call on the CPU, held to
           chip_smoke.py's limits, with the psychoacoustic band product at
           HIGHEST precision (as shipped) and at DEFAULT (TF32 on a GPU): a
           planted fault the limits must catch.

Without a GPU every comparison is CPU against CPU; use small sizes there.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

RATE = 44100
CHANNELS = 2
#: Coefficients below this share of their block's largest carry float32
#: FFT noise of 1 % or more of their value.
NOISE_FLOOR = 1e-4


def _ulps(a, b):
    """Distance in float32 units in the last place, elementwise."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(1 << 31) - ia, ia)  # order negative floats too
    ib = np.where(ib < 0, -(1 << 31) - ib, ib)
    return np.abs(ia - ib)


def part_shapes(clips) -> dict:
    import jax
    import jax.numpy as jnp

    from flo_tpu.lossless import encoder as lle
    from flo_tpu.ops import lpc

    # Lanes as the device analysis sees mid/side frames: 1 s of mid, then side.
    frames = np.concatenate([
        np.round(c.reshape(-1, CHANNELS) * 32767).astype(np.int32)[: len(c) // 2 // RATE * RATE]
        .reshape(-1, RATE, CHANNELS) for c in clips
    ])
    left, right = frames[..., 0], frames[..., 1]
    lanes = np.stack([left + right, left - right], 1).reshape(-1, RATE)
    L = len(lanes)
    q = max(L // 4, 1)
    nv = np.full(L, RATE, np.int32)

    def float32_sum(x, nvalid, max_order):
        xf = jnp.where(jnp.arange(x.shape[1])[None] < nvalid[:, None], x, 0).astype(jnp.float32)
        S = xf.shape[1]
        return jnp.stack([jnp.sum(xf[:, k:] * xf[:, : S - k], axis=1)
                          for k in range(max_order + 1)], 1)

    out = {"lanes": L, "quarter": q}
    levinson = jax.jit(lpc.levinson_device, static_argnums=1)
    for name, fn in (("float32_sum", float32_sum), ("exact", lpc.autocorrelation_device)):
        f = jax.jit(fn, static_argnums=2)
        whole = np.asarray(f(jnp.asarray(lanes), jnp.asarray(nv), 12))
        parts = np.concatenate([np.asarray(f(jnp.asarray(lanes[i:i + q]), jnp.asarray(nv[i:i + q]), 12))
                                for i in range(0, L, q)])
        u = _ulps(whole, parts)
        # Levinson of each lane in the batch and in its quarter.
        lw = [np.asarray(a) for a in levinson(jnp.asarray(whole), 12)]
        chunks = [levinson(jnp.asarray(parts[i:i + q]), 12) for i in range(0, L, q)]
        lp = [np.concatenate([np.asarray(c[k]) for c in chunks]) for k in range(3)]
        differ = np.zeros(L, bool)
        for a, b in zip(lw, lp):
            differ |= np.any((a != b).reshape(L, -1), axis=1)
        coeff_lanes = int(differ.sum())
        out[name] = {
            "lanes_with_a_differing_sum": int(np.sum(u.max(1) > 0)),
            "differing_sums": int(np.sum(u > 0)),
            "max_ulps": int(u.max()),
            "lanes_with_differing_coefficients": coeff_lanes,
        }
    n = max(len(clips) // 4, 1)
    whole = lle.encode_many(clips, RATE, CHANNELS, 16, 5)
    alone = lle.encode_many(clips[:n], RATE, CHANNELS, 16, 5)
    out["bulk_bytes_equal_alone_vs_batch"] = f"{sum(a == b for a, b in zip(alone, whole))}/{n}"
    return out


def _internals(padded, sample_rate: int, thr):
    """The lossy encoder's quantization with its intermediates:
    (coeffs, smr, sf, q) for padded [C, (T+1)*HOP] rows."""
    import jax
    import jax.numpy as jnp

    from flo_tpu.lossy import encoder as loe
    from flo_tpu.ops import mdct, psycho

    _, band, onehot, _, _ = psycho.model_tables(sample_rate, loe.BLOCK)
    C, n = padded.shape
    segs = padded.reshape(C, n // loe.HOP, loe.HOP)
    blocks = jnp.concatenate([segs[:, :-1], segs[:, 1:]], axis=-1)
    coeffs = mdct.forward(blocks, loe.BLOCK, loe.WINDOW)
    q, sf = loe._quantize_coeffs(coeffs, band, onehot, sample_rate, thr)
    return coeffs, psycho.smr(coeffs, sample_rate, loe.BLOCK), sf, q


def _host_quantize(blocks64, sample_rate: int, thr):
    """float64 form of the encoder's quantization for one row's blocks:
    (kept [T, n2], q [T, n2], scale factor [T, 25], smr [T, n2])."""
    from flo_tpu.lossy import encoder as loe
    from flo_tpu.ops import mdct, psycho

    _, band, onehot, _, _ = psycho.model_tables(sample_rate, loe.BLOCK)
    c = mdct.mdct_oracle(blocks64, loe.BLOCK, loe.WINDOW)
    smr = psycho.smr_host(c, sample_rate, loe.BLOCK)
    band_max = np.stack([np.abs(c)[:, band == b].max(axis=1, initial=0.0)
                         for b in range(onehot.shape[1])], axis=1)
    sf = np.where(band_max > 1e-10, 30000.0 / np.maximum(band_max, 1e-30), 1.0)
    scaled = c * sf[:, band]
    q = np.clip(np.sign(scaled) * np.floor(np.abs(scaled) + 0.5), -32768, 32767)
    return smr > thr, q, sf, smr


def _agrees(host, dev, cpu) -> dict:
    """How often a float64 host value equals each backend's."""
    return {"device": int(np.sum(host == dev)),
            "cpu": int(np.sum((host != dev) & (host == cpu))),
            "neither": int(np.sum((host != dev) & (host != cpu)))}


def _sf_code_x(sf):
    """The scale factor's wire code before truncation (encoder.encode_sf_u16)."""
    return np.log2(np.maximum(np.asarray(sf, np.float64), 1e-37)) * 256.0 + 32768.0


def part_lossy(clips, quality: float) -> dict:
    """Every difference between the default device's and the CPU's lossy
    quantization of the same input, by kind, and the output samples each
    kind moves by more than 2 i16 steps (decoding one backend's choices with
    the other's, one kind at a time). Distances and float64 agreement are
    given for differences above the float32 noise floor; those below it are
    only counted."""
    import jax

    from flo_tpu.lossy import decoder as lod
    from flo_tpu.lossy import encoder as loe
    from flo_tpu.ops import psycho

    thr = np.float32(loe.smr_threshold(quality))
    padded = np.concatenate([loe._file_padded(c, CHANNELS)[0] for c in clips])  # [R, W]
    run = jax.jit(_internals, static_argnames=("sample_rate",))
    c_d, smr_d, sf_d, q_d = (np.asarray(a) for a in run(padded, RATE, thr))
    with jax.default_device(jax.devices("cpu")[0]):
        c_c, smr_c, sf_c, q_c = (np.asarray(a) for a in run(padded, RATE, thr))
    _, band, _, _, _ = psycho.model_tables(RATE, loe.BLOCK)

    # A float32 FFT is exact to about 1e-6 of a block's largest coefficient,
    # so near-silent coefficients and bands differ between backends by noise.
    floor = np.abs(c_c) < NOISE_FLOOR * np.abs(c_c).max(axis=-1, keepdims=True)
    band_floor = np.stack([floor[..., band == b].all(axis=-1)
                           for b in range(sf_c.shape[-1])], axis=-1)
    code_d, code_c = loe.encode_sf_u16(sf_d), loe.encode_sf_u16(sf_c)
    code_flip_all = code_d != code_c  # [R, T, 25]
    keep_d, keep_c = smr_d > thr, smr_c > thr
    gate_flip_all = keep_d != keep_c  # [R, T, n2]
    dq = np.abs(q_d.astype(np.int32) - q_c.astype(np.int32))
    code_flip = code_flip_all & ~band_floor
    gate_flip = gate_flip_all & ~floor
    by_one = (dq == 1) & ~gate_flip_all & ~floor
    other = (dq > 1) & ~gate_flip_all & ~floor

    # Decode with one kind of difference switched at a time: the CPU's
    # choices, then the device's scale-factor codes, then its gate
    # decisions, then its rounding (= the device's own result).
    q_gate = np.where(gate_flip_all, q_d, q_c)

    def decode(q, code):
        sf = lod.decode_sf_u16(code)[:, :, None]  # [R, T, 1, 25]
        return np.asarray(lod._decode_blocks(q[:, :, None], sf, RATE, loe.BLOCK))

    steps = [decode(q_c, code_c), decode(q_c, code_d), decode(q_gate, code_d),
             decode(q_d, code_d)]
    moved = {}
    for name, (a, b) in (("total", (steps[0], steps[3])), ("sf_code", (steps[0], steps[1])),
                         ("gate", (steps[1], steps[2])), ("rounding", (steps[2], steps[3]))):
        d = np.abs(a - b) * 32767
        moved[name] = {"samples_over_2_steps": int(np.sum(d > 2)), "max_steps": float(d.max())}

    # float64 host quantization of every row with a difference.
    rows = np.flatnonzero(code_flip.any((1, 2)) | (gate_flip | by_one).any((1, 2)))
    host = {"code": [], "gate": [], "by_one": []}
    gate_dist, code_dist, half_dist = [], [], []
    for r in rows:
        segs = padded[r].astype(np.float64).reshape(-1, loe.HOP)
        keep64, q64, sf64, smr64 = _host_quantize(
            np.concatenate([segs[:-1], segs[1:]], axis=-1), RATE, float(thr))
        cf, gf, bo = code_flip[r], gate_flip[r], by_one[r]
        code64 = loe.encode_sf_u16(sf64)
        host["code"].append((code64[cf], code_d[r][cf], code_c[r][cf]))
        host["gate"].append((keep64[gf], keep_d[r][gf], keep_c[r][gf]))
        host["by_one"].append((q64[bo], q_d[r][bo], q_c[r][bo]))
        gate_dist.append(np.abs(np.stack([smr_d[r][gf], smr_c[r][gf], smr64[gf]]) - thr))
        x = np.stack([_sf_code_x(sf_d[r][cf]), _sf_code_x(sf_c[r][cf]), _sf_code_x(sf64[cf])])
        code_dist.append(np.abs(x - np.round(x)))
        sfb = np.stack([sf_d[r][:, band][bo], sf_c[r][:, band][bo]])
        scaled = np.abs(np.stack([c_d[r][bo], c_c[r][bo]]).astype(np.float64) * sfb)
        half_dist.append(np.abs(scaled % 1.0 - 0.5))

    def cat(parts, k):
        return np.concatenate([p[k] for p in parts]) if parts else np.zeros(0)

    def spread(parts):
        """[median, 99th percentile, max] for each backend's distances."""
        a = np.concatenate(parts, axis=1) if parts else np.zeros((3, 0))
        if not a.shape[1]:
            return None
        return [[float(np.quantile(v, f)) for f in (0.5, 0.99, 1.0)] for v in a]

    return {
        "quality": quality,
        "coefficients": int(q_d.size),
        "bands": int(code_d.size),
        "noise_floor_flips": {"sf_code": int((code_flip_all & band_floor).sum()),
                              "gate": int((gate_flip_all & floor).sum()),
                              "q": int(((dq > 0) & ~gate_flip_all & floor).sum())},
        "sf_code_flips": int(code_flip.sum()),
        "sf_code_distance_from_boundary": spread(code_dist),
        "sf_code_float64_agrees_with": _agrees(*(cat(host["code"], k) for k in range(3))),
        "gate_flips": int(gate_flip.sum()),
        "gate_smr_minus_gate_db_abs": spread(gate_dist),
        "gate_float64_agrees_with": _agrees(*(cat(host["gate"], k) for k in range(3))),
        "rounding_flips_by_one": int(by_one.sum()),
        "rounding_distance_from_half": spread(half_dist),
        "rounding_float64_agrees_with": _agrees(*(cat(host["by_one"], k) for k in range(3))),
        "other_q_flips": int(other.sum()),
        "output_moved": moved,
    }


def part_control(clips) -> dict:
    import jax
    import jax.numpy as jnp

    import chip_smoke as cs
    from flo_tpu.container import reader
    from flo_tpu.lossy import decoder as lod
    from flo_tpu.lossy import encoder as loe
    from flo_tpu.lossy.presets import QUALITY_U8_TO_F32
    from flo_tpu.ops import psycho

    presets = (("medium", 1), ("transparent", 4))
    cpu = jax.devices("cpu")[0]
    refs = {}
    with jax.default_device(cpu):
        for name, preset in presets:
            d = loe.encode_many(clips, RATE, CHANNELS, QUALITY_U8_TO_F32[preset])
            refs[name] = (d, lod.decode_many([reader.read(x) for x in d]))
    class DefaultPrecision:
        """jax.numpy whose matmul drops the precision it is given."""

        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def matmul(a, b, precision=None):
            return jnp.matmul(a, b)

    out = {}
    try:
        for label, np_module in (("HIGHEST", jnp), ("DEFAULT", DefaultPrecision())):
            psycho.jnp = np_module  # read when smr is traced
            jax.clear_caches()
            text = psycho.smr.lower(jnp.zeros((1, 2, 1024)), RATE, 2048).as_text()
            assert ("HIGHEST" in text) == (label == "HIGHEST"), "the plant did not take"
            for name, preset in presets:
                datas = loe.encode_many(clips, RATE, CHANNELS, QUALITY_U8_TO_F32[preset])
                outs = lod.decode_many([reader.read(x) for x in datas])
                m = cs.lossy_agreement(clips, datas, outs, *refs[name])
                try:
                    cs.check_lossy_agreement(name, m, "CPU")
                    m["verdict"] = "within limits"
                except cs.PhaseError as e:
                    m["verdict"] = f"fails: {e}"
                out[f"{label}/{name}"] = m
    finally:
        psycho.jnp = jnp
        jax.clear_caches()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--files", type=int, default=8)
    ap.add_argument("--seconds", type=int, default=60)
    ap.add_argument("--parts", default="shapes,lossy,control")
    args = ap.parse_args(argv)

    from flo_tpu import compile_cache, corpus, device_info

    compile_cache.configure()
    import jax

    d = jax.devices()[0]
    print(json.dumps({"device": d.device_kind, "platform": d.platform,
                      "card": device_info.card() if d.platform == "gpu" else None}), flush=True)
    parts = args.parts.split(",")
    if "shapes" in parts:
        t0 = time.perf_counter()
        r = part_shapes(corpus.material(args.files, args.seconds, 0))
        print(json.dumps({"part": "shapes", "s": time.perf_counter() - t0, **r}), flush=True)
    lossy_clips = corpus.material(args.files, args.seconds, 1)
    if "lossy" in parts:
        from flo_tpu.lossy.presets import QUALITY_U8_TO_F32

        for quality in (QUALITY_U8_TO_F32[1], QUALITY_U8_TO_F32[4]):
            t0 = time.perf_counter()
            r = part_lossy(lossy_clips, quality)
            print(json.dumps({"part": "lossy", "s": time.perf_counter() - t0, **r}), flush=True)
    if "control" in parts:
        t0 = time.perf_counter()
        r = part_control(lossy_clips)
        print(json.dumps({"part": "control", "s": time.perf_counter() - t0, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
