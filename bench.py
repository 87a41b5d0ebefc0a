#!/usr/bin/env python
"""Throughput benchmark: audio-seconds encoded+decoded per second on one GPU.

Runs the full public-API pipelines (lossless encode/decode at level 5, lossy
medium encode/decode) on program material cut from the committed reference
corpus (flo_tpu/corpus.py) and prints one JSON line, then a short summary:

    {"metric": ..., "value": N, "unit": ..., "device": {...}, ...}

value = total audio-seconds processed (each encode and each decode of W
seconds counts W) divided by wall time. Every record names the device (JAX
platform, device kind and count) and the card's power limit; without a GPU
the benchmark stops instead of timing the CPU. Also verifies the bit-exact
lossless round trip on the corpus and includes the rate in the JSON.
"""

from __future__ import annotations

import json
import time

import numpy as np

WORKLOAD_SECONDS = 60
BATCH_FILES = 8
RATE = 44100
CHANNELS = 2
ITERS = 4  # headline = best of 4 laps (all laps recorded)
SEED = 0
BREADTH_SECONDS = 15  # per-config breadth passes
BREADTH_FILES = 8     # smaller batch keeps total bench wall time sane


def make_audio(seconds: int, rate: int, seed: int = 42) -> np.ndarray:
    """Noise-laden synthetic stereo signal (tones + noise + envelope).

    Deliberately near-incompressible (~11.5 bits/sample) — kept as the
    stress config; the headline uses real corpus content."""
    rng = np.random.default_rng(seed)
    t = np.arange(seconds * rate, dtype=np.float64) / rate
    l = (
        0.4 * np.sin(2 * np.pi * 220 * t)
        + 0.2 * np.sin(2 * np.pi * 331 * t)
        + 0.1 * np.sin(2 * np.pi * 553 * t)
        + 0.03 * rng.standard_normal(t.size)
    ) * (0.6 + 0.4 * np.sin(2 * np.pi * 0.25 * t))
    r = (
        0.4 * np.sin(2 * np.pi * 277 * t)
        + 0.2 * np.sin(2 * np.pi * 415 * t)
        + 0.03 * rng.standard_normal(t.size)
    ) * (0.6 + 0.4 * np.cos(2 * np.pi * 0.21 * t))
    out = np.empty(2 * t.size, dtype=np.float32)
    out[0::2] = np.clip(l, -1, 1)
    out[1::2] = np.clip(r, -1, 1)
    return out


def corpus_bit_exact() -> tuple[int, int]:
    """Round-trip every lossless corpus file bit-exactly (i32 domain)."""
    import flo_tpu
    from flo_tpu import corpus
    from flo_tpu.container import reader as _reader
    from flo_tpu.core.convert import f32_to_i32_np
    from flo_tpu.lossless import decoder as lldec

    total = ok = 0
    for p in corpus.lossless_files():
        flo = _reader.read(p.read_bytes())
        ref_i32 = lldec.decode_file_i32(flo)
        if ref_i32.size == 0:
            continue
        total += 1
        f32 = lldec.decode_file(flo)
        enc = flo_tpu.encode(
            f32, flo.header.sample_rate, flo.header.channels, analyze=False
        )
        got = lldec.decode_file_i32(_reader.read(enc))
        # Contract: our decode->encode->decode reproduces the decoded signal's
        # i32 samples exactly (f32->i32 of the decoded f32).
        want = f32_to_i32_np(f32).reshape(-1, flo.header.channels)
        if got.shape == want.shape and np.array_equal(got, want):
            ok += 1
    return ok, total


def corpus_content(name: str, n_files: int, seconds: int):
    """Tile one corpus file to the bench geometry at ITS native rate and
    channel count (sweep_20_20k is 44.1 kHz mono, hires_96khz 96 kHz mono).
    Returns (clips, rate, channels)."""
    from flo_tpu import corpus
    from flo_tpu.container import reader as _reader
    from flo_tpu.lossless import decoder as lld

    raw = (corpus.examples_dir() / f"{name}.flo").read_bytes()
    hdr = _reader.read(raw).header
    base = lld.decode(raw)
    rate, ch = hdr.sample_rate, hdr.channels
    need = seconds * rate * ch
    reps = -(-need // len(base))
    tiled = np.tile(base, reps)[:need]
    out = []
    for i in range(n_files):
        out.append(np.roll(tiled, i * ch * rate))  # de-correlate the batch
    return out, rate, ch


def main() -> None:
    from flo_tpu import compile_cache, corpus, device_info

    compile_cache.configure()
    import jax

    devices = device_info.require_gpu()
    device = {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
        "card": device_info.card(),
    }

    t_setup = time.time()
    from flo_tpu.container import reader as _reader
    from flo_tpu.lossless import decoder as lld
    from flo_tpu.lossless import encoder as lle
    from flo_tpu.lossy import decoder as lod
    from flo_tpu.lossy import encoder as loe
    from flo_tpu.lossy.presets import QUALITY_U8_TO_F32

    clips = corpus.material(BATCH_FILES, WORKLOAD_SECONDS, SEED)
    q_med = QUALITY_U8_TO_F32[1]

    def pass_once(material):
        # Cross-pipeline overlap (futures): both encodes dispatch before
        # either collects, and each decode dispatches as soon as its encode's
        # bytes exist. Every transport is entropy-coded: block-packed uploads
        # and downloads, sparse lossy coefficients.
        h_ll = lle.encode_many_async(material, RATE, CHANNELS, 16, 5)
        h_lo = loe.encode_many_async(
            material, RATE, CHANNELS, q_med, transport_dtype="packed"
        )
        d_ll = h_ll.result()
        h_lld = lld.decode_many_async([_reader.read(d) for d in d_ll])
        d_lo = h_lo.result()
        h_lod = lod.decode_many_async([_reader.read(d) for d in d_lo])
        return d_ll, h_lld.result(), d_lo, h_lod.result()

    # Warmup: compile all jit programs for these shapes.
    data_ll, out_ll, data_lo, out_lo = pass_once(clips)
    err = float(np.abs(out_ll[0] - clips[0]).max())
    assert err <= 1 / 32768 + 1e-6, f"lossless round-trip broken: {err}"
    setup_s = time.time() - t_setup

    laps = []
    for _ in range(ITERS):
        t0 = time.time()
        pass_once(clips)
        laps.append(time.time() - t0)
    # Headline policy (label travels in the JSON as headline_policy): best
    # of ITERS passes, with the median alongside (value_median) and every
    # lap in pass_seconds, so any other statistic can be recomputed.
    wall = min(laps)
    wall_median = float(np.median(laps))

    # 2 encodes + 2 decodes of every clip per pass.
    audio_seconds = BATCH_FILES * WORKLOAD_SECONDS * 4
    value = audio_seconds / wall
    data_ll, data_lo = data_ll[0], data_lo[0]
    audio = clips[0]

    # ---- Breadth configs (BASELINE.md: all presets, levels, synthetic
    # stress, streaming). Shorter clips (same file count) keep total bench
    # wall time sane; value = audio-seconds encoded+decoded per second.
    bclips = corpus.material(BREADTH_FILES, BREADTH_SECONDS, SEED + 1)
    cfg_audio = BREADTH_FILES * BREADTH_SECONDS * 2  # one encode + one decode
    configs: dict = {}

    def run_cfg(name, enc, dec, material, audio_sec=None, extra=None):
        dec(enc(material))  # warmup: compile any config-specific programs
        dt = float("inf")
        for _ in range(2):  # best of 2
            t0 = time.time()
            datas = enc(material)
            outs = dec(datas)
            dt = min(dt, time.time() - t0)
        ratio = len(material[0]) * 2 / len(datas[0])
        configs[name] = {
            "value": round((audio_sec if audio_sec else cfg_audio) / dt, 1),
            "ratio": round(ratio, 2),
        }
        if extra:
            configs[name].update(extra)
        return datas, outs

    l5_datas = None
    for level in (0, 5, 9):
        datas, _outs = run_cfg(
            f"lossless_l{level}",
            lambda m, lv=level: lle.encode_many(m, RATE, CHANNELS, 16, lv),
            lambda ds: lld.decode_many([_reader.read(d) for d in ds]),
            bclips,
        )
        if level == 5:
            l5_datas = datas
    for preset in range(5):
        q = QUALITY_U8_TO_F32[preset]
        run_cfg(
            f"lossy_q{preset}",
            lambda m, qq=q: loe.encode_many(
                m, RATE, CHANNELS, qq, transport_dtype="packed"
            ),
            lambda ds: lod.decode_many([_reader.read(d) for d in ds]),
            bclips,
        )
    # Near-incompressible stress content (the old synthetic headline).
    noise = [make_audio(BREADTH_SECONDS, RATE, seed=42 + i) for i in range(BREADTH_FILES)]
    run_cfg(
        "synthetic_noise_l5",
        lambda m: lle.encode_many(m, RATE, CHANNELS, 16, 5),
        lambda ds: lld.decode_many([_reader.read(d) for d in ds]),
        noise,
    )
    # Facade path with auto-embedded analysis metadata (lib.rs:219-283).
    from flo_tpu import batch as _batch

    run_cfg(
        "lossless_with_analysis",
        lambda m: _batch.encode_many(m, RATE, CHANNELS, analyze=True),
        lambda ds: lld.decode_many([_reader.read(d) for d in ds]),
        bclips,
    )

    # ---- BASELINE.json configs[3]: "Lossy transparent + bitrate-targeted
    # encode of sweep_20_20k and hires_96khz" — each corpus file tiled at its
    # NATIVE rate/channels (sweep: 44.1 kHz mono; hires: 96 kHz mono).
    from flo_tpu.lossy.presets import QualityPreset

    q_transparent = QUALITY_U8_TO_F32[4]
    for cname in ("sweep_20_20k", "hires_96khz"):
        cclips, crate, cch = corpus_content(cname, BREADTH_FILES, BREADTH_SECONDS)
        csec = BREADTH_FILES * (len(cclips[0]) / (crate * cch)) * 2
        q_br = QUALITY_U8_TO_F32[
            int(QualityPreset.from_bitrate(128, crate, cch))
        ]
        run_cfg(
            f"lossy_transparent_{cname}",
            lambda m, r=crate, c=cch: loe.encode_many(
                m, r, c, q_transparent, transport_dtype="packed"
            ),
            lambda ds: lod.decode_many([_reader.read(d) for d in ds]),
            cclips,
            audio_sec=csec,
            extra={"rate": crate, "channels": cch},
        )
        run_cfg(
            f"lossy_bitrate128_{cname}",
            lambda m, r=crate, c=cch, q=q_br: loe.encode_many(
                m, r, c, q, transport_dtype="packed"
            ),
            lambda ds: lod.decode_many([_reader.read(d) for d in ds]),
            cclips,
            audio_sec=csec,
            extra={
                "rate": crate,
                "channels": cch,
                "note": "encode_with_bitrate facade: 128 kbps -> preset "
                        "via QualityPreset.from_bitrate (lib.rs:180-206)",
            },
        )

    # ---- The same bulk pipelines under an explicit jax.sharding.Mesh over
    # every available device, with outputs asserted byte-identical to the
    # unsharded lossless_l5 config above.
    from flo_tpu import parallel as _par

    mesh = _par.device_mesh()
    with _par.use_mesh(mesh):
        mdatas = lle.encode_many(bclips, RATE, CHANNELS, 16, 5)  # warmup+equality
        mouts = lld.decode_many([_reader.read(d) for d in mdatas])
    mesh_equal = l5_datas is not None and all(
        a == b for a, b in zip(mdatas, l5_datas)
    ) and all(np.array_equal(a, b) for a, b in zip(mouts, lld.decode_many(
        [_reader.read(d) for d in l5_datas])))
    dt = float("inf")
    for _ in range(2):
        t0 = time.time()
        with _par.use_mesh(mesh):
            ds = lle.encode_many(bclips, RATE, CHANNELS, 16, 5)
            lld.decode_many([_reader.read(d) for d in ds])
        dt = min(dt, time.time() - t0)
    configs["mesh_lossless_l5"] = {
        "value": round(cfg_audio / dt, 1),
        "mesh_devices": mesh.size,
        "equal_to_unsharded": bool(mesh_equal),
        "note": "production bulk encode+decode under an explicit device "
                "Mesh; bytes asserted == unsharded",
    }
    assert mesh_equal, "mesh path output != unsharded output"

    # Compute-only realtime factor: the full lossless candidate search +
    # device entropy pack on device-resident input, no host transfer.
    import jax.numpy as jnp
    from flo_tpu.ops.select import encode_select_device

    kinds = ("raw", "fixed", "fixed", "fixed", "fixed", "fixed",
             "lpc", "lpc", "lpc", "lpc")
    orders = (0, 0, 1, 2, 3, 4, 5, 6, 7, 8)
    pcm = np.stack(
        [np.round(c.reshape(-1, 2).T * 32767).astype(np.int16)[:, : RATE * BREADTH_SECONDS]
         for c in bclips]
    ).reshape(BREADTH_FILES, 2, -1)
    # frames of 1s: [F, C, S]
    pcm_f = np.ascontiguousarray(
        pcm.reshape(BREADTH_FILES, 2, BREADTH_SECONDS, RATE).transpose(0, 2, 1, 3)
    ).reshape(-1, 2, RATE)
    pcm_dev = jax.device_put(pcm_f)
    nv_dev = jax.device_put(np.full(pcm_f.shape[0], RATE, np.int32))

    def _time_device(fn, reps=3):
        jax.block_until_ready(fn())
        t0 = time.time()
        for _ in range(reps):
            jax.block_until_ready(fn())
        return (time.time() - t0) / reps

    from flo_tpu.futures import start_host_copy as _shc

    def dk_dispatch():
        out = encode_select_device(pcm_dev, nv_dev, kinds, orders)
        _shc(out[4], out[5])  # size arrays (payload-fetch length at collect)
        return out

    # Single-phase since the worst-case-bucket fuse (ops/select
    # _transport_outputs): the whole search + pack is ONE dispatch, so
    # steady-state throughput = enqueue reps back-to-back, wait for the last.
    out = dk_dispatch()
    lane_bytes = np.asarray(out[4]).astype(np.int64)
    lane_off = np.asarray(out[5]).astype(np.int64)
    jax.block_until_ready(out)  # compile on first call; measure below
    t0 = time.time()
    jax.block_until_ready(dk_dispatch())
    lat = time.time() - t0
    dk_total = int(lane_off[-1] + ((lane_bytes[-1] + 3) // 4) * 4)
    reps = 6
    t0 = time.time()
    outs = [dk_dispatch() for _ in range(reps)]
    jax.block_until_ready(outs)
    dt = (time.time() - t0) / reps
    configs["device_kernels"] = {
        "value": round(BREADTH_FILES * BREADTH_SECONDS / dt, 1),
        "latency_ms": round(lat * 1e3, 1),
        "payload_mb": round(dk_total / 1e6, 1),
        "note": "lossless candidate search + device Rice pack, fused "
                "single-phase at the worst-case word bucket, device-resident "
                "I/O, steady state; latency_ms = one call",
    }

    # The LPC reconstruction alone (ops/lpc.reconstruct_best).
    from flo_tpu.ops import lpc as _lpc

    res_dev = jax.device_put(
        np.clip(np.diff(pcm_f[:, 0], prepend=0), -30000, 30000)
        .astype(np.int32)
        .reshape(-1, RATE)
    )
    coeffs_d = jax.device_put(
        np.tile(np.array([[2, -1] + [0] * 10], np.int32), (pcm_f.shape[0], 1))
    )
    z_d = jax.device_put(np.zeros(pcm_f.shape[0], np.int32))
    two_d = jax.device_put(np.full(pcm_f.shape[0], 2, np.int32))
    fx_d = jax.device_put(np.ones(pcm_f.shape[0], bool))
    recon = jax.jit(_lpc.reconstruct_best)
    dt = _time_device(lambda: recon(res_dev, coeffs_d, z_d, two_d, fx_d))
    configs["device_reconstruct"] = {
        "value": round(BREADTH_FILES * BREADTH_SECONDS / dt, 1),
        "note": "LPC reconstruction, device-resident I/O",
    }

    # Full decode step: block-packed residual unpack + LPC reconstruction
    # + mid/side + bit-plane PCM pack (the production _decode_lanes_bp
    # program), single-phase like the encoder (pack fused at the PCM
    # worst-case bucket).
    from flo_tpu.lossless.decoder import _decode_lanes_bp
    from flo_tpu.ops import blockpack as _bp

    F2 = pcm_f.shape[0]
    res_rows = np.asarray(
        np.clip(np.diff(pcm_f.reshape(-1, RATE), axis=1, prepend=0), -30000, 30000),
        np.int32,
    )
    L2 = res_rows.shape[0]
    nv_l = np.full(L2, RATE, np.int64)
    upb, upm, upw, upo = _bp.pack_host(res_rows, nv_l)
    dd_args = (
        jax.device_put(upb), jax.device_put(upm.astype(np.int32)),
        jax.device_put(upw), jax.device_put(upo.astype(np.int32)),
        jax.device_put(np.tile(np.array([[2, -1] + [0] * 10], np.int32), (L2, 1))),
        jax.device_put(np.zeros(L2, np.int32)),
        jax.device_put(np.full(L2, 2, np.int32)),
        jax.device_put(np.ones(L2, bool)),
        jax.device_put(np.zeros(F2, bool)),
        jax.device_put(nv_l.astype(np.int32)),
    )

    dd_kmax = int(upm.max()) if len(upm) else 0  # same static arg production passes

    def dd_dispatch():
        out = _decode_lanes_bp(*dd_args, 2, RATE, up_kmax=dd_kmax)
        _shc(out[4])
        return out

    jax.block_until_ready(dd_dispatch())
    t0 = time.time()
    jax.block_until_ready(dd_dispatch())
    lat = time.time() - t0
    t0 = time.time()
    outs = [dd_dispatch() for _ in range(6)]
    jax.block_until_ready(outs)
    dt = (time.time() - t0) / 6
    configs["device_decode"] = {
        "value": round(BREADTH_FILES * BREADTH_SECONDS / dt, 1),
        "latency_ms": round(lat * 1e3, 1),
        "up_kmax": dd_kmax,
        "note": "full decode step (blockpack unpack + LPC reconstruct + "
                "bit-plane PCM pack), fused single-phase at the PCM "
                "worst-case bucket, device-resident I/O, steady state; "
                "up_kmax = static unpack cumsum depth from the host pack",
    }

    # Lossy encode compute: the full MDCT -> psychoacoustics -> quantize ->
    # sparse-compact program on device-resident input (same jit the bulk
    # path runs).
    from flo_tpu.lossy.encoder import _encode_padded_compact, _file_padded, HOP
    from flo_tpu.lossy.encoder import smr_threshold as _thr

    from flo_tpu.ops import compact as _compact

    pf = [_file_padded(c, CHANNELS) for c in bclips]
    t_max_b = max(nh for _, nh in pf)
    stackb = np.zeros((BREADTH_FILES * CHANNELS, (t_max_b + 1) * HOP), np.float32)
    for i, (padded, nh) in enumerate(pf):
        stackb[i * CHANNELS : (i + 1) * CHANNELS, : padded.shape[1]] = padded
    stackb_dev = jax.device_put(stackb)
    thrq = np.float32(_thr(q_med))

    def dm_dispatch():
        out = _encode_padded_compact(stackb_dev, RATE, thrq)
        _shc(out[2])
        return out

    # Speculative-hit steady state (the production collect dispatches each
    # chunk's assembly at the previous chunk's bucket before any size read;
    # on steady content the bucket always fits, so no read sits on the
    # device stream).
    warm = dm_dispatch()
    dm_total = int(np.asarray(warm[2]).sum())
    dm_ne = _compact.bucket_entries(dm_total)

    def dm_pass():
        out = dm_dispatch()
        return _compact.assemble_entries(out[0], out[1], NE=dm_ne)

    jax.block_until_ready(dm_pass())
    t0 = time.time()
    jax.block_until_ready(dm_pass())
    lat = time.time() - t0
    t0 = time.time()
    outs = [dm_pass() for _ in range(6)]
    jax.block_until_ready(outs)
    dt = (time.time() - t0) / 6
    configs["device_mdct"] = {
        "value": round(BREADTH_FILES * BREADTH_SECONDS / dt, 1),
        "latency_ms": round(lat * 1e3, 1),
        "note": "lossy MDCT+psy+quantize+compact, speculative-bucket "
                "steady state (the production collect's hit path), "
                "device-resident I/O",
    }

    # Streaming encode (host C++ candidate search, frame-at-a-time —
    # native/encode.cpp).
    from flo_tpu.streaming import StreamingDecoder, StreamingEncoder

    def stream_encode_all():
        se = StreamingEncoder(RATE, CHANNELS)
        step = RATE // 4 * CHANNELS
        for i in range(0, len(audio), step):
            se.push_samples(audio[i : i + step])
            while se.next_frame() is not None:
                pass
        return se.flush()

    stream_encode_all()  # warmup (native build, caches)
    t0 = time.time()
    stream_encode_all()
    configs["streaming_encode"] = {
        "value": round(WORKLOAD_SECONDS / (time.time() - t0), 1),
        # Levinson-predicted LPC prune (StreamingEncoder.lpc_prune_topk=2,
        # native/encode.cpp prune_topk), byte-identical to the full search
        # (tools/stream_enc_ab.py).
        "note": "lpc_prune_topk=2",
    }

    # Streaming decode (host state machine, frame-at-a-time).

    def stream_all():
        sd = StreamingDecoder()
        sd.feed(data_ll)
        ns = 0
        while True:
            fr = sd.next_frame()
            if fr is None:
                break
            ns += len(fr) // CHANNELS
        return ns

    stream_all()  # warmup (per-frame kernels)
    t0 = time.time()
    ns = stream_all()
    configs["streaming_decode"] = {"value": round((ns / RATE) / (time.time() - t0), 1)}

    ok, total = corpus_bit_exact()
    bit_exact = (ok / total) if total else None

    result = {
        "metric": "audio-seconds encoded+decoded/sec (lossless+lossy)",
        "value": round(value, 2),
        "unit": "audio-sec/sec",
        "headline_policy": f"best of {ITERS} passes (median alongside)",
        "value_median": round(audio_seconds / wall_median, 2),
        "device": device,
        "workload": (
            f"{BATCH_FILES}x{WORKLOAD_SECONDS}s 44.1kHz stereo x{ITERS} iters, "
            f"bulk lossless+lossy encode+decode, corpus material seed {SEED}"
        ),
        "lossless_ratio": round(len(audio) * 2 / len(data_ll), 2),
        "lossy_ratio": round(len(audio) * 2 / len(data_lo), 2),
        "corpus_bit_exact": f"{ok}/{total}" if total else "n/a",
        "corpus_bit_exact_rate": bit_exact,
        "setup_seconds": round(setup_s, 1),
        "pass_seconds": [round(x, 1) for x in laps],
        "configs": configs,
        "note": (
            "headline = corpus material (flo_tpu/corpus.py); "
            "synthetic_noise_l5 = near-incompressible stress config. "
            "device_kernels shows the compute-only realtime factor."
        ),
    }
    print(json.dumps(result))
    # Compact summary last: a reader that keeps only the tail of stdout
    # still gets everything the record must preserve from this short line.
    print(json.dumps({
        "summary": True,
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "value_median": result["value_median"],
        "headline_policy": result["headline_policy"],
        "device": result["device"],
        "pass_seconds": result["pass_seconds"],
        "corpus_bit_exact": result["corpus_bit_exact"],
    }))


if __name__ == "__main__":
    main()
