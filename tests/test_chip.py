"""Tests that need a GPU: the compiled Triton kernel at full width, the bulk
decoder on the corpus, and host frame bytes against device frame bytes.

Run on a GPU with ``JAX_PLATFORMS=cuda,cpu python -m pytest -m chip -p no:xdist
tests/``; elsewhere the ``gpu`` fixture skips them.
"""

import jax
import numpy as np
import pytest

import flo_tpu
from flo_tpu import corpus
from flo_tpu.container import reader
from flo_tpu.core.convert import f32_to_i32_np, i32_to_f32_np
from flo_tpu.lossless import decoder as lld
from flo_tpu.lossless import encoder as lle
from flo_tpu.ops import lpc
from flo_tpu.ops.triton_lpc import reconstruct_triton

pytestmark = pytest.mark.chip


def test_kernel_matches_oracle_at_full_width(gpu):
    host = corpus.mixed_lanes(0, 960, 44100)
    dev = [jax.device_put(a, gpu) for a in host]
    got = np.asarray(reconstruct_triton(*dev))
    np.testing.assert_array_equal(got, lpc.reconstruct_host(*host))
    np.testing.assert_array_equal(got, np.asarray(lpc.reconstruct(*dev)))


def test_corpus_roundtrip_through_bulk_decoder(gpu):
    flos = [reader.read(p.read_bytes()) for p in corpus.lossless_files()]
    assert len(flos) == 11
    got = lld.decode_many(flos)
    with jax.default_device(jax.devices("cpu")[0]):
        want = [i32_to_f32_np(lld.decode_file_i32(f)).reshape(-1) for f in flos]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    again = lld.decode_many([
        reader.read(flo_tpu.encode(g, f.header.sample_rate, f.header.channels, analyze=False))
        for g, f in zip(got, flos)
    ])
    for a, g in zip(again, got):
        np.testing.assert_array_equal(f32_to_i32_np(a), f32_to_i32_np(g))


def test_host_frame_bytes_equal_device_frame_bytes(gpu):
    clips = corpus.material(3, 4, seed=3)
    bulk = lle.encode_many(clips, 44100, 2, 16, 5, analysis="exact")
    for blob, clip in zip(bulk, clips):
        assert blob == lle.encode(clip, 44100, 2, 16, 5)
