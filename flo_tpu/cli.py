"""`flo` command-line interface.

Mirrors reflo/src/main.rs: encode | decode | info | metadata | analysis |
validate with matching flags and output shape. Invoke as
``python -m flo_tpu <command> ...``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import os
import sys

import numpy as np

#: CLI quality names -> f32 (main.rs:236-249 — note this differs from the
#: QualityPreset table; kept for parity).
CLI_QUALITY = {
    "low": 0.2,
    "medium": 0.4,
    "med": 0.4,
    "high": 0.6,
    "veryhigh": 0.8,
    "vh": 0.8,
    "transparent": 1.0,
    "trans": 1.0,
}

QUALITY_NAMES = ["Low", "Medium", "High", "VeryHigh", "Transparent"]


def _fmt_time_ms(ms: int) -> str:
    secs, ms_rem = divmod(int(ms), 1000)
    mins, secs = divmod(secs, 60)
    return f"{mins:02d}:{secs:02d}.{ms_rem:03d}"


def cmd_encode(args) -> int:
    from . import reflo
    from .core.metadata import FloMetadata

    print(f"Reading {args.input}...")
    audio_bytes = pathlib.Path(args.input).read_bytes()
    try:
        rate, channels, duration = reflo.get_audio_info(audio_bytes)
    except Exception as e:
        print(f"Failed to read audio file: {e}", file=sys.stderr)
        return 1
    print(f"  Sample rate: {rate} Hz")
    print(f"  Channels: {channels}")
    print(f"  Duration: {duration:.2f}s")

    if args.lossy or args.transform or args.bitrate is not None:
        if args.bitrate is not None:
            print(f"Encoding to flo™ (lossy, ~{args.bitrate} kbps)...")
            options = reflo.EncodeOptions.lossy_bitrate(args.bitrate)
        else:
            q = CLI_QUALITY.get(args.quality.lower())
            if q is None:
                print(
                    f"Invalid quality level: {args.quality}. "
                    "Use: low, medium, high, veryhigh, transparent",
                    file=sys.stderr,
                )
                return 1
            print(f"Encoding to flo™ (lossy, {args.quality} quality)...")
            options = reflo.EncodeOptions.lossy_quality(q)
    else:
        print("Encoding to flo™ (lossless)...")
        options = reflo.EncodeOptions.lossless()
    options = options.with_level(args.level)

    if args.title or args.artist or args.album:
        meta = FloMetadata(title=args.title, artist=args.artist, album=args.album)
        options = options.with_metadata(meta)

    flo_data = reflo.encode_from_audio(audio_bytes, options)
    pathlib.Path(args.output).write_bytes(flo_data)

    original_size = int(rate * channels * duration * 4.0)
    ratio = original_size / len(flo_data) if flo_data else 0.0
    print("Done!")
    print(f"  Output: {args.output}")
    print(f"  Size: {len(flo_data)} bytes ({ratio:.1f}x compression)")
    return 0


def cmd_decode(args) -> int:
    from . import reflo

    print(f"Reading {args.input}...")
    flo_data = pathlib.Path(args.input).read_bytes()
    info = reflo.get_flo_info(flo_data)
    print(f"  Sample rate: {info.sample_rate} Hz")
    print(f"  Channels: {info.channels}")
    print(f"  Duration: {info.duration_secs:.2f}s")
    print("Decoding...")
    wav = reflo.decode_to_wav(flo_data)
    print("Writing WAV...")
    pathlib.Path(args.output).write_bytes(wav)
    print("Done!")
    print(f"  Output: {args.output}")
    return 0


def cmd_info(args) -> int:
    from . import reflo

    flo_data = pathlib.Path(args.input).read_bytes()
    i = reflo.get_flo_info(flo_data)
    print("flo™ Audio File")
    print("───────────────────────────────")
    print(f"  Version:     {i.version}")
    print(f"  Sample rate: {i.sample_rate} Hz")
    print(f"  Channels:    {i.channels}")
    print(f"  Bit depth:   {i.bit_depth}")
    print(f"  Duration:    {i.duration_secs:.2f}s")
    print(f"  Total sample-frames: {i.total_samples}")
    print(f"  File size:   {i.file_size} bytes")
    print(f"  Compression: {i.compression_ratio:.1f}x")
    print(f"  CRC valid:   {'yes' if i.crc_valid else 'no'}")
    if i.is_lossy:
        name = (
            QUALITY_NAMES[i.lossy_quality]
            if i.lossy_quality < len(QUALITY_NAMES)
            else "Unknown"
        )
        print(f"  Encoding:    Lossy ({name})")
    else:
        print("  Encoding:    Lossless")

    if args.metadata:
        print()
        print("Metadata")
        print("───────────────────────────────")
        meta = reflo.get_metadata(flo_data)
        if meta is None:
            print("  (no metadata)")
        else:
            for label, v in [
                ("Title:      ", meta.title),
                ("Artist:     ", meta.artist),
                ("Album:      ", meta.album),
                ("Year:       ", meta.year),
                ("Genre:      ", meta.genre),
                ("BPM:        ", meta.bpm),
                ("Key:        ", meta.key),
            ]:
                if v is not None:
                    print(f"  {label} {v}")
            if meta.pictures:
                print(f"  Pictures:     {len(meta.pictures)} attached")
            if meta.synced_lyrics:
                print("  Synced lyrics: yes")
            if meta.section_markers:
                print(f"  Sections:     {len(meta.section_markers)} markers")
            if meta.waveform_data is not None:
                print("  Waveform:     pre-computed")
    return 0


def _jsonable(obj):
    if isinstance(obj, (bytes, bytearray)):
        return list(obj)
    if isinstance(obj, dict):
        return {k: _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    return obj


def cmd_metadata(args) -> int:
    from . import reflo

    flo_data = pathlib.Path(args.input).read_bytes()
    meta = reflo.get_metadata(flo_data)
    if meta is None:
        print("null" if args.json else "No metadata present")
        return 0
    if args.json:
        print(json.dumps(_jsonable(meta.to_obj()), indent=2))
        return 0

    print("flo™ Metadata")
    print("═══════════════════════════════════════")
    simple = [
        ("Title:          ", meta.title),
        ("Subtitle:       ", meta.subtitle),
        ("Album:          ", meta.album),
        ("ISRC:           ", meta.isrc),
        ("Artist:         ", meta.artist),
        ("Album Artist:   ", meta.album_artist),
        ("Composer:       ", meta.composer),
        ("Conductor:      ", meta.conductor),
        ("Lyricist:       ", meta.lyricist),
        ("Remixer:        ", meta.remixer),
        ("Genre:          ", meta.genre),
        ("Mood:           ", meta.mood),
        ("Year:           ", meta.year),
        ("BPM:            ", meta.bpm),
        ("Key:            ", meta.key),
        ("Language:       ", meta.language),
    ]
    for label, v in simple:
        if v is not None:
            print(f"{label} {v}")
    if meta.track_number is not None:
        tr = f"{meta.track_number}/{meta.track_total}" if meta.track_total else meta.track_number
        print(f"Track:           {tr}")
    if meta.integrated_loudness_lufs is not None or meta.true_peak_dbtp is not None:
        print()
        print("Loudness")
        print("───────────────────────────────────────")
        if meta.integrated_loudness_lufs is not None:
            print(f"Integrated:      {meta.integrated_loudness_lufs:.1f} LUFS")
        if meta.loudness_range_lu is not None:
            print(f"Range:           {meta.loudness_range_lu:.1f} LU")
        if meta.true_peak_dbtp is not None:
            print(f"True Peak:       {meta.true_peak_dbtp:.1f} dBTP")
    if meta.pictures:
        print()
        print(f"Pictures ({len(meta.pictures)}):")
        for i, pic in enumerate(meta.pictures):
            print(
                f"  [{i + 1}] {pic.picture_type.value} - {pic.mime_type} "
                f"({len(pic.data)} bytes)"
            )
    if meta.section_markers:
        print()
        print(f"Sections ({len(meta.section_markers)}):")
        for sec in meta.section_markers:
            label = sec.label or ""
            print(f"  {_fmt_time_ms(sec.timestamp_ms)} {sec.section_type.value} {label}")
    if meta.waveform_data is not None:
        wd = meta.waveform_data
        print()
        print("Waveform Data:")
        print(f"  Peaks/sec:     {wd.peaks_per_second}")
        print(f"  Total peaks:   {len(wd.peaks)}")
        print(f"  Channels:      {wd.channels}")
    if meta.flo_encoder_version or meta.source_format:
        print()
        print("flo™ Info")
        print("───────────────────────────────────────")
        if meta.flo_encoder_version:
            print(f"Encoder:         {meta.flo_encoder_version}")
        if meta.source_format:
            print(f"Source:          {meta.source_format}")
    return 0


def cmd_analysis(args) -> int:
    from . import reflo
    from .core import analysis, ebu_r128

    flo_data = pathlib.Path(args.input).read_bytes()
    info = reflo.get_flo_info(flo_data)
    samples, rate, channels = reflo.decode_to_samples(flo_data)
    loudness = ebu_r128.compute_ebu_r128_loudness(samples, info.channels, info.sample_rate)

    waveform = None
    if args.waveform:
        wf = analysis.extract_waveform_peaks(samples, info.channels, info.sample_rate, 60)
        stats = None
        if wf.peaks:
            stats = {
                "min": float(min(wf.peaks)),
                "max": float(max(wf.peaks)),
                "average": float(sum(wf.peaks) / len(wf.peaks)),
            }
        waveform = {
            "peaks_per_second": wf.peaks_per_second,
            "total_peaks": len(wf.peaks),
            "channels": wf.channels,
            "peak_statistics": stats,
        }

    spectral = None
    if args.spectrum:
        fp = analysis.extract_spectral_fingerprint(samples, info.channels, info.sample_rate)
        spectral = {
            "duration_ms": fp.duration_ms,
            "sample_rate": fp.sample_rate,
            "channels": fp.channels,
            "peak_frequency_bands": list(fp.frequency_peaks),
            "energy_profile": list(fp.energy_profile),
            "average_loudness": fp.avg_loudness,
            "spectral_hash_hex": bytes(fp.hash[:8]).hex(),
        }

    if args.json:
        print(
            json.dumps(
                {
                    "file_info": {
                        "sample_rate": info.sample_rate,
                        "channels": info.channels,
                        "bit_depth": info.bit_depth,
                        "duration_secs": info.duration_secs,
                        "total_samples": info.total_samples,
                    },
                    "loudness": {
                        "integrated_lufs": loudness.integrated_lufs,
                        "loudness_range_lu": loudness.loudness_range_lu,
                        "true_peak_dbtp": loudness.true_peak_dbtp,
                        "sample_peak_dbfs": loudness.sample_peak_dbfs,
                    },
                    "waveform": waveform,
                    "spectral": spectral,
                },
                indent=2,
            )
        )
        return 0

    print(f"Analyzing {args.input}...")
    print()
    print("File Information")
    print("────────────────")
    print(f"  Sample rate: {info.sample_rate} Hz")
    print(f"  Channels:    {info.channels}")
    print(f"  Bit depth:   {info.bit_depth} bits")
    print(f"  Duration:    {info.duration_secs:.2f}s")
    print(f"  Total samples: {info.total_samples}")
    print()
    print("Loudness Metrics (EBU R128)")
    print("────────────────────────────")
    print(f"  Integrated loudness: {loudness.integrated_lufs:.2f} LUFS")
    print(f"  Loudness range:      {loudness.loudness_range_lu:.2f} LU")
    print(f"  True peak:           {loudness.true_peak_dbtp:.2f} dBTP")
    print(f"  Sample peak:         {loudness.sample_peak_dbfs:.2f} dBFS")
    print()
    if waveform:
        print("Waveform Analysis")
        print("─────────────────")
        print(f"  Peaks per second:    {waveform['peaks_per_second']}")
        print(f"  Total peaks:         {waveform['total_peaks']}")
        print(f"  Channels:            {waveform['channels']}")
        if waveform["peak_statistics"]:
            st = waveform["peak_statistics"]
            print("  Peak statistics:")
            print(f"    Min:               {st['min']:.6f}")
            print(f"    Max:               {st['max']:.6f}")
            print(f"    Average:           {st['average']:.6f}")
        print()
    if spectral:
        print("Spectral Analysis")
        print("─────────────────")
        print(f"  Duration:            {spectral['duration_ms']} ms")
        print(f"  Sample rate:         {spectral['sample_rate']} Hz")
        print(f"  Channels:            {spectral['channels']}")
        print(f"  Peak frequency bands: {spectral['peak_frequency_bands']}")
        print(f"  Energy profile (16 bands): {spectral['energy_profile']}")
        print(f"  Average loudness:    {spectral['average_loudness']}")
        print(f"  Spectral hash (first 8 bytes):   {spectral['spectral_hash_hex']}")
        print()
    return 0


def cmd_validate(args) -> int:
    from . import reflo

    flo_data = pathlib.Path(args.input).read_bytes()
    try:
        valid = reflo.validate_flo(flo_data)
    except Exception:
        valid = False
    if valid:
        print(f"✓ {args.input} is a valid flo™ file")
        return 0
    print(f"✗ {args.input} is not a valid flo™ file", file=sys.stderr)
    return 1


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="flo", description="flo™ audio format converter")
    sub = p.add_subparsers(dest="command", required=True)

    e = sub.add_parser("encode", help="Encode audio file to flo™ format")
    e.add_argument("input")
    e.add_argument("output")
    e.add_argument("-l", "--level", type=int, default=5, help="Compression level (0-9)")
    e.add_argument("--lossy", action="store_true", help="Enable lossy compression mode")
    e.add_argument("--transform", action="store_true", help="Use transform-based lossy")
    e.add_argument("--quality", default="high",
                   help="Lossy quality (low, medium, high, veryhigh, transparent)")
    e.add_argument("--bitrate", type=int, default=None, help="Target bitrate in kbps")
    e.add_argument("--title", default=None)
    e.add_argument("--artist", default=None)
    e.add_argument("--album", default=None)
    e.set_defaults(fn=cmd_encode)

    d = sub.add_parser("decode", help="Decode flo™ file to WAV")
    d.add_argument("input")
    d.add_argument("output")
    d.set_defaults(fn=cmd_decode)

    i = sub.add_parser("info", help="Show information about a flo™ file")
    i.add_argument("input")
    i.add_argument("-m", "--metadata", action="store_true", help="Show metadata details")
    i.set_defaults(fn=cmd_info)

    m = sub.add_parser("metadata", help="Display metadata from a flo™ file")
    m.add_argument("input")
    m.add_argument("--json", action="store_true", help="Output as JSON")
    m.set_defaults(fn=cmd_metadata)

    a = sub.add_parser("analysis", help="Analyze audio content")
    a.add_argument("input")
    a.add_argument("-w", "--waveform", action="store_true", help="Show waveform peaks")
    a.add_argument("-s", "--spectrum", action="store_true", help="Show spectral fingerprint")
    a.add_argument("--json", action="store_true", help="Output as JSON")
    a.set_defaults(fn=cmd_analysis)

    v = sub.add_parser("validate", help="Validate a flo™ file")
    v.add_argument("input")
    v.set_defaults(fn=cmd_validate)

    s = sub.add_parser(
        "serve",
        help="Run the HTTP codec service (the WASM/JS API's serving analog)",
    )
    s.add_argument(
        "--host",
        default="127.0.0.1",
        help="bind address (default loopback; the service is "
        "unauthenticated — pass 0.0.0.0 only behind a reverse proxy)",
    )
    s.add_argument("--port", type=int, default=8080)
    s.set_defaults(fn=cmd_serve)
    return p


def cmd_serve(args) -> int:
    from .service import serve

    serve(args.host, args.port)
    return 0


def main(argv=None) -> int:
    from . import compile_cache

    args = build_parser().parse_args(argv)
    compile_cache.configure()
    try:
        return args.fn(args)
    except FileNotFoundError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    except BrokenPipeError:
        # `flo info file | head` closes our stdout mid-print; exit quietly
        # like any well-behaved unix filter (os.devnull swap stops the
        # interpreter-shutdown flush from raising a second time).
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
