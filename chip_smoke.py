#!/usr/bin/env python
"""Smoke check of flo_tpu on one GPU, through the entry points a user calls.

    python chip_smoke.py           # every phase on one card
    python chip_smoke.py --four    # sharded bulk pipelines on four cards

Phases, each printing one line:

  device      the first JAX device is a GPU; the card's name and power limit
  kernel      the LPC reconstruction compiled at [960, 44100], bit-exact
              against the numpy oracle (Triton kernel and lax.scan), timed;
              MDCT and SMR against their float64 forms
  lossless    bulk encode + decode of 8 x 60 s 44.1 kHz stereo at level 5,
              bit-exact; 2 files encode to the same bytes alone as in the
              batch; analysis="exact" bytes equal the per-file host encode; GPU decode equals the host decode; 11/11 corpus files
              survive decode -> encode -> decode
  lossy       bulk encode + decode (medium, transparent) against the same
              calls on the CPU; the reference lossy corpus against the CPU
  entry       `flo` encode/decode/validate in-process, and the HTTP service
              answering encode/decode requests

With --four, only the mesh phase runs: lossless and lossy bulk pipelines over
a 4-device 'batch' mesh against the same pipelines on one device (lossless
bytes equal, lossy within the limits below).

Exits non-zero, and prints no result, if there is no GPU or any phase fails.
The last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import tempfile
import threading
import time
import traceback
import urllib.request

import numpy as np

RATE = 44100
CHANNELS = 2
FILES = 8
SECONDS = 60
SEED = 0
#: Lanes of the bench headline (8 files x 60 s x 2 channels) and a quarter.
RECON_LANES = (FILES * SECONDS * CHANNELS, FILES * SECONDS * CHANNELS // 4)
#: Lossy bulk encode vs the same call on the CPU. The backends' float32
#: FFTs and sums differ by ulps, so a coefficient at a boundary (the SMR
#: gate, a rounding, its band's scale-factor code) can go one way on one
#: backend and the other way on the other (tools/determinism_probe.py counts
#: them); one such flip can move a 2048-sample block by tens of i16 steps.
#: Held: sizes within 1 %, at most 0.1 % of samples more than 2 i16 steps
#: apart (a TF32 band product breaks this), and each file's SNR within 0.1 dB.
LOSSY_SIZE_RTOL = 0.01
LOSSY_SAMPLE_TOL = 2.0 / 32767.0
LOSSY_FLIP_FRACTION = 1e-3
LOSSY_SNR_TOL_DB = 0.1
#: Decoding one file on two backends: within one i16 step (docs/determinism.md).
DECODE_TOL = 1.0 / 32767.0 + 1e-7
#: Least SNR of the decode against the source, by quality.
LOSSY_MIN_SNR_DB = {"medium": 10.0, "transparent": 25.0}


class PhaseError(AssertionError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def _timed(fn, reps: int) -> list[float]:
    import jax

    jax.block_until_ready(fn())
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        out.append(time.perf_counter() - t0)
    return out


def phase_kernel(lanes=RECON_LANES, S=RATE) -> str:
    import jax

    from flo_tpu import corpus
    from flo_tpu.ops import lpc, mdct, psycho
    from flo_tpu.ops.triton_lpc import reconstruct_triton

    host = corpus.mixed_lanes(SEED, lanes[0], S)
    dev = [jax.device_put(a) for a in host]
    want = lpc.reconstruct_host(*host)
    compiled = jax.jit(reconstruct_triton).lower(*dev).compile()
    print(f"  kernel memory_analysis: {compiled.memory_analysis()}", flush=True)
    check(np.array_equal(np.asarray(compiled(*dev)), want), "Triton kernel != reconstruct_host")
    scan = jax.jit(lpc.reconstruct)
    check(np.array_equal(np.asarray(scan(*dev)), want), "lax.scan != reconstruct_host")
    best = jax.jit(lpc.reconstruct_best)
    check(np.array_equal(np.asarray(best(*dev)), want), "reconstruct_best != reconstruct_host")

    times = {}
    for L in lanes:
        d = [a[:L] for a in dev]
        times[f"kernel_ms[{L},{S}]"] = float(np.median(_timed(lambda d=d: best(*d), 5))) * 1e3
        times[f"scan_ms[{L},{S}]"] = float(np.median(_timed(lambda d=d: scan(*d), 3))) * 1e3

    # MDCT at n = 2048 against the float64 oracle, and SMR against its
    # float64 form on the same coefficients.
    rng = np.random.default_rng(SEED)
    t = np.arange(64 * 2048) / RATE
    x = (0.5 * np.sin(2 * np.pi * 997 * t) + 0.05 * rng.standard_normal(t.size))
    blocks = np.stack([x.reshape(64, 2048)] * CHANNELS).astype(np.float32)
    coeffs = np.asarray(mdct.forward(jax.device_put(blocks), 2048, "vorbis"))
    want_c = mdct.mdct_oracle(blocks, 2048, "vorbis")
    mdct_err = float(np.abs(coeffs - want_c).max() / np.abs(want_c).max())
    check(mdct_err <= mdct.ORACLE_RTOL, f"MDCT relative error {mdct_err:.3g}")
    smr = np.asarray(psycho.smr(jax.device_put(coeffs), RATE, 2048))
    smr_err = float(np.abs(smr - psycho.smr_host(coeffs, RATE, 2048)).max())
    check(smr_err <= psycho.SMR_TOL_DB, f"SMR error {smr_err:.3g} dB")
    times = {k: round(v, 3) for k, v in times.items()}
    return f"bit-exact at [{lanes[0]}, {S}]; {json.dumps(times)}; " \
           f"mdct rel err {mdct_err:.3g}; smr err {smr_err:.3g} dB"


def _q(x):
    from flo_tpu.core.convert import f32_to_i32_np, i32_to_f32_np

    return i32_to_f32_np(f32_to_i32_np(x))


def phase_lossless(files=FILES, seconds=SECONDS) -> str:
    import jax

    import flo_tpu
    from flo_tpu import corpus
    from flo_tpu.container import reader
    from flo_tpu.core.convert import f32_to_i32_np, i32_to_f32_np
    from flo_tpu.lossless import decoder as lld
    from flo_tpu.lossless import encoder as lle

    cpu = jax.devices("cpu")[0]
    clips = corpus.material(files, seconds, SEED)
    t0 = time.perf_counter()
    datas = lle.encode_many(clips, RATE, CHANNELS, 16, 5)
    flos = [reader.read(d) for d in datas]
    outs = lld.decode_many(flos)
    first = time.perf_counter() - t0
    for i, (o, c) in enumerate(zip(outs, clips)):
        check(np.array_equal(o, _q(c)), f"bulk round trip not bit-exact (file {i})")
    t0 = time.perf_counter()
    lld.decode_many(flos)
    warm_decode = time.perf_counter() - t0

    # A file's bytes do not depend on the batch it is encoded in; the shard
    # a 4-card mesh gives each card is such a smaller batch.
    part = lle.encode_many(clips[:2], RATE, CHANNELS, 16, 5)
    check(part == datas[:2], "bulk bytes of 2 files alone != the same files in the batch")

    exact = lle.encode_many(clips, RATE, CHANNELS, 16, 5, analysis="exact")
    for i, (d, c) in enumerate(zip(exact, clips)):
        check(d == lle.encode(c, RATE, CHANNELS, 16, 5),
              f'analysis="exact" bytes != per-file host encode (file {i})')

    with jax.default_device(cpu):
        for i, (flo, o) in enumerate(zip(flos, outs)):
            ints = lld.decode_file_i32(flo).reshape(-1)
            check(np.array_equal(i32_to_f32_np(ints), o), f"GPU decode != host decode (file {i})")

    # Every lossless corpus file through one bulk decode (one compile per
    # channel count), against the host decode, then decode -> encode -> decode.
    paths = corpus.lossless_files()
    flos = [reader.read(p.read_bytes()) for p in paths]
    got = lld.decode_many(flos)
    with jax.default_device(cpu):
        ref = [i32_to_f32_np(lld.decode_file_i32(f)).reshape(-1) for f in flos]
    again = lld.decode_many([
        reader.read(flo_tpu.encode(g, f.header.sample_rate, f.header.channels, analyze=False))
        for g, f in zip(got, flos)
    ])
    files_ok = [
        p.name for p, g, r, a in zip(paths, got, ref, again)
        if np.array_equal(g, r) and np.array_equal(f32_to_i32_np(a), f32_to_i32_np(g))
    ]
    check(len(files_ok) == len(paths),
          f"corpus {len(files_ok)}/{len(paths)}: {sorted({p.name for p in paths} - set(files_ok))}")
    return (f"{files}x{seconds}s bit-exact; bytes independent of batch; "
            f"exact==host bytes; GPU==host decode; "
            f"corpus {len(files_ok)}/{len(paths)}; first pass {first:.3f} s, "
            f"warm decode_many {warm_decode:.3f} s")


def _snr_db(ref, out) -> float:
    m = min(len(ref), len(out))
    noise = np.sum((ref[:m].astype(np.float64) - out[:m]) ** 2)
    return float(10 * np.log10(np.sum(ref[:m].astype(np.float64) ** 2) / max(noise, 1e-30)))


def lossy_agreement(clips, datas, outs, ref_datas, ref_outs) -> dict:
    """How far a lossy bulk encode is from the same call made elsewhere:
    the largest relative size difference, the largest sample difference in
    i16 steps, the share of samples more than 2 steps apart, the least SNR
    against the source and the largest SNR gap between the two."""
    snr = [_snr_db(c, o) for c, o in zip(clips, outs)]
    return {
        "size_err": max(abs(len(a) - len(b)) / len(b) for a, b in zip(datas, ref_datas)),
        "max_steps": max(float(np.abs(a - b).max()) for a, b in zip(outs, ref_outs)) * 32767,
        "flip_frac": sum(int(np.sum(np.abs(a - b) > LOSSY_SAMPLE_TOL))
                         for a, b in zip(outs, ref_outs)) / sum(len(a) for a in outs),
        "min_snr": min(snr),
        "snr_gap": max(abs(a - _snr_db(c, r)) for a, c, r in zip(snr, clips, ref_outs)),
    }


def check_lossy_agreement(name, m: dict, ref) -> str:
    """Hold :func:`lossy_agreement`'s numbers to the limits above."""
    check(m["size_err"] <= LOSSY_SIZE_RTOL,
          f"{name}: sizes differ from {ref} by {m['size_err']:.3%}")
    check(m["flip_frac"] <= LOSSY_FLIP_FRACTION,
          f"{name}: {m['flip_frac']:.3%} of samples differ from {ref} by more than 2 steps")
    check(m["snr_gap"] <= LOSSY_SNR_TOL_DB,
          f"{name}: SNR differs from {ref} by {m['snr_gap']:.3f} dB")
    return (f"size {m['size_err']:.3%}, encode max {m['max_steps']:.2f} steps on "
            f"{m['flip_frac']:.4%} of samples, snr {m['min_snr']:.1f} dB "
            f"(gap {m['snr_gap']:.4f} dB)")


def phase_lossy(files=FILES, seconds=SECONDS) -> str:
    import jax

    from flo_tpu import corpus
    from flo_tpu.container import reader
    from flo_tpu.lossy import decoder as lod
    from flo_tpu.lossy import encoder as loe
    from flo_tpu.lossy.presets import QUALITY_U8_TO_F32

    cpu = jax.devices("cpu")[0]
    clips = corpus.material(files, seconds, SEED + 1)
    notes = []
    for name, preset in (("medium", 1), ("transparent", 4)):
        q = QUALITY_U8_TO_F32[preset]
        datas = loe.encode_many(clips, RATE, CHANNELS, q)
        flos = [reader.read(d) for d in datas]
        outs = lod.decode_many(flos)
        with jax.default_device(cpu):
            ref_datas = loe.encode_many(clips, RATE, CHANNELS, q)
            ref_outs = lod.decode_many([reader.read(d) for d in ref_datas])
            cpu_outs = lod.decode_many(flos)  # the GPU's bytes, decoded on the CPU
        dec_diff = max(float(np.abs(a - b).max()) for a, b in zip(outs, cpu_outs))
        check(dec_diff <= DECODE_TOL,
              f"{name}: decoding the same bytes differs from CPU by {dec_diff * 32767:.2f} steps")
        agree = check_lossy_agreement(
            name, lossy_agreement(clips, datas, outs, ref_datas, ref_outs), "CPU")
        snr = min(_snr_db(c, o) for c, o in zip(clips, outs))
        check(snr >= LOSSY_MIN_SNR_DB[name], f"{name}: SNR {snr:.1f} dB")
        notes.append(f"{name}: same-bytes decode {dec_diff * 32767:.2f} steps, {agree}")

    n = 0
    for p in sorted(corpus.examples_dir().glob("*.flo")):
        flo = reader.read(p.read_bytes())
        if not flo.header.is_lossy:
            continue
        got = lod.decode_many([flo])[0]
        with jax.default_device(cpu):
            ref = lod.decode_many([flo])[0]
        check(got.shape == ref.shape and float(np.abs(got - ref).max()) <= DECODE_TOL,
              f"reference lossy file {p.name}: GPU != CPU")
        n += 1
    check(n > 0, "no lossy corpus files")
    return "; ".join(notes) + f"; lossy corpus {n}/{n} within one step"


def phase_entry() -> str:
    import pathlib

    from flo_tpu import audio_io, cli, corpus, service
    from flo_tpu.container import reader

    clip = corpus.material(1, 5, SEED + 2)[0]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        (tmp / "in.wav").write_bytes(audio_io.write_wav_to_bytes(clip, RATE, CHANNELS))
        for argv in (["encode", str(tmp / "in.wav"), str(tmp / "a.flo")],
                     ["encode", "--lossy", "--quality", "high",
                      str(tmp / "in.wav"), str(tmp / "b.flo")],
                     ["decode", str(tmp / "a.flo"), str(tmp / "a.wav")],
                     ["decode", str(tmp / "b.flo"), str(tmp / "b.wav")],
                     ["validate", str(tmp / "a.flo")]):
            with contextlib.redirect_stdout(io.StringIO()):
                rc = cli.main(argv)
            check(rc == 0, f"flo {argv[0]} failed")
        samples, _, _ = audio_io.read_audio_from_bytes((tmp / "a.wav").read_bytes())[:3]
        check(np.allclose(np.asarray(samples).reshape(-1), _q(clip), atol=1 / 32768 + 1e-6),
              "CLI lossless round trip")

    srv = service.make_server("127.0.0.1", 0)
    srv.verbose = False
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        base = f"http://127.0.0.1:{srv.server_address[1]}"

        def post(path, body):
            req = urllib.request.Request(base + path, data=body, method="POST")
            with urllib.request.urlopen(req, timeout=300) as r:
                return r.read()

        for _ in range(3):
            flo = post(f"/v1/encode?sample_rate={RATE}&channels={CHANNELS}",
                       clip.astype("<f4").tobytes())
            check(reader.read(flo).header.sample_rate == RATE, "service encode")
            pcm = np.frombuffer(post("/v1/decode", flo), "<f4")
            check(np.array_equal(pcm, _q(clip)), "service lossless round trip")
        lossy = post(f"/v1/encode_lossy?sample_rate={RATE}&channels={CHANNELS}&quality=3",
                     clip.astype("<f4").tobytes())
        pcm = np.frombuffer(post("/v1/decode", lossy), "<f4")
        check(_snr_db(clip, pcm) > 10, "service lossy round trip")
    finally:
        srv.shutdown()
        srv.server_close()
        thread.join(timeout=30)
    return "cli encode/decode/validate ok; service answered 8 requests"


def phase_four(files=FILES, seconds=SECONDS) -> str:
    """Sharded bulk pipelines over four cards against one card."""
    import jax

    from flo_tpu import corpus, parallel
    from flo_tpu.container import reader
    from flo_tpu.lossless import decoder as lld
    from flo_tpu.lossless import encoder as lle
    from flo_tpu.lossy import decoder as lod
    from flo_tpu.lossy import encoder as loe
    from flo_tpu.parallel import pipeline as pp

    check(len(jax.devices()) >= 4, f"--four needs 4 devices, JAX sees {len(jax.devices())}")
    mesh = parallel.device_mesh(n=4)
    seen = set()
    put_batch = pp.put_batch

    def recording_put_batch(x, m):
        arr = put_batch(x, m)
        if m is not None:
            seen.add(len(arr.sharding.device_set))
        return arr

    pp.put_batch = recording_put_batch
    try:
        clips = corpus.material(files, seconds, SEED)
        # The bulk default (analysis="device") and the host analysis
        # ("exact") must each give the same bytes on the mesh as on one card.
        four = {}
        for analysis in ("device", "exact"):
            one = lle.encode_many(clips, RATE, CHANNELS, 16, 5, analysis=analysis)
            four[analysis] = lle.encode_many(clips, RATE, CHANNELS, 16, 5,
                                             analysis=analysis, mesh=mesh)
            same = sum(a == b for a, b in zip(one, four[analysis]))
            check(same == len(clips), f'lossless bytes (analysis="{analysis}"): 4-card mesh '
                                      f"== one card on {same}/{len(clips)} files")
        flos = [reader.read(d) for d in four["device"] + four["exact"]]
        dec_one = lld.decode_many(flos)
        dec_four = lld.decode_many(flos, mesh=mesh)
        check(all(np.array_equal(a, b) for a, b in zip(dec_one, dec_four)),
              "lossless decode: 4-card mesh != one card")
        check(all(np.array_equal(a, _q(c)) for a, c in zip(dec_four, clips + clips)),
              "lossless round trip on the mesh")
        q = 0.55
        lone = loe.encode_many(clips, RATE, CHANNELS, q)
        lfour = loe.encode_many(clips, RATE, CHANNELS, q, mesh=mesh)
        lflos = [reader.read(d) for d in lfour]
        out_one = lod.decode_many([reader.read(d) for d in lone])
        out_four = lod.decode_many(lflos, mesh=mesh)
        same_bytes = lod.decode_many(lflos)
        dec_diff = max(float(np.abs(a - b).max()) for a, b in zip(out_four, same_bytes))
        check(dec_diff <= DECODE_TOL,
              f"lossy decode of the same bytes: 4-card mesh differs by {dec_diff * 32767:.2f} steps")
        enc_diff = lossy_agreement(clips, lfour, out_four, lone, out_one)["max_steps"]
        check(enc_diff <= DECODE_TOL * 32767,
              f"lossy encode: 4-card mesh differs from one card by {enc_diff:.2f} steps")
    finally:
        pp.put_batch = put_batch
    check(seen == {4}, f"mesh uploads landed on {sorted(seen)} devices, not 4")
    return (f'lossless byte-exact (analysis "device" and "exact"), decode bit-exact; '
            f"lossy same-bytes decode within {dec_diff * 32767:.2f} steps, "
            f"encode within {enc_diff:.2f} steps; "
            f"uploads on 4 devices")


def run_phase(name: str, fn) -> bool:
    t0 = time.perf_counter()
    try:
        note = fn()
    except Exception:  # noqa: BLE001 — report every phase, then fail the run
        print(f"[{name}] FAILED after {time.perf_counter() - t0:.1f} s", flush=True)
        traceback.print_exc()
        return False
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s: {note}", flush=True)
    return True


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the 4-card sharded pipelines against one card")
    args = parser.parse_args(argv)

    from flo_tpu import compile_cache, device_info

    compile_cache.configure()
    try:
        devices = device_info.require_gpu()
    except RuntimeError as e:
        print(f"[device] FAILED: {e}", flush=True)
        return 1
    dev = devices[0]
    print(f"[device] ok: {dev.device_kind} x{len(devices)}", flush=True)
    print(device_info.card(), flush=True)

    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [("kernel", phase_kernel), ("lossless", phase_lossless),
                  ("lossy", phase_lossy), ("entry", phase_entry)]
    ok = all([run_phase(name, fn) for name, fn in phases])
    if not ok:
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
