"""The in-repo MessagePack codec against the `msgpack` package as an oracle,
fixed byte vectors, and `import flo_tpu` with no `msgpack` installed."""

import math
import subprocess
import sys

import numpy as np
import pytest

from flo_tpu.core import msgpack as mp
from flo_tpu.core.metadata import FloMetadata, PictureType

oracle = pytest.importorskip("msgpack")

_INT_EDGES = [
    0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63),
]


def _oracle_pack(obj):
    return oracle.packb(obj, use_bin_type=True, use_single_float=True)


def _random_obj(rng, depth=0):
    kind = rng.integers(0, 9 if depth < 3 else 6)
    if kind == 0:
        return [None, True, False][rng.integers(3)]
    if kind == 1:
        return _INT_EDGES[rng.integers(len(_INT_EDGES))]
    if kind == 2:
        return float(rng.standard_normal() * 10.0 ** rng.integers(-40, 40))
    if kind == 3:
        n = int(rng.choice([0, 5, 31, 32, 255, 256, 70000]))
        return "".join(chr(c) for c in rng.integers(32, 0x3000, n))
    if kind == 4:
        return bytes(rng.integers(0, 256, int(rng.choice([0, 3, 255, 256, 65536]))).astype(np.uint8))
    if kind == 5:
        return int(rng.integers(-(2**62), 2**62))
    n = int(rng.choice([0, 1, 15, 16, 40]))
    if kind == 6:
        return [_random_obj(rng, depth + 1) for _ in range(n)]
    if kind == 7:
        return tuple(_random_obj(rng, depth + 1) for _ in range(n))
    return {f"k{i}": _random_obj(rng, depth + 1) for i in range(n)}


@pytest.mark.parametrize("seed", range(4))
def test_pack_matches_oracle(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        obj = _random_obj(rng)
        want = _oracle_pack(obj)
        assert mp.packb(obj) == want
        got = mp.unpackb(want)
        assert got == oracle.unpackb(want, raw=False, strict_map_key=False)


@pytest.mark.parametrize("x", _INT_EDGES)
def test_int_forms_match_oracle(x):
    assert mp.packb(x) == _oracle_pack(x)
    assert mp.unpackb(mp.packb(x)) == x


@pytest.mark.parametrize(
    "obj,wire",
    [
        (None, b"\xc0"),
        (True, b"\xc3"),
        (-1, b"\xff"),
        (200, b"\xcc\xc8"),
        (-200, b"\xd1\xff\x38"),
        (1.5, b"\xca\x3f\xc0\x00\x00"),
        ("a" * 32, b"\xd9\x20" + b"a" * 32),
        (b"\x01\x02", b"\xc4\x02\x01\x02"),
        ({"t": [1, 2]}, b"\x81\xa1t\x92\x01\x02"),
    ],
)
def test_fixed_vectors(obj, wire):
    assert mp.packb(obj) == wire
    assert mp.unpackb(wire) == (list(obj) if isinstance(obj, tuple) else obj)


def test_unpack_reads_forms_it_never_writes():
    """float64, map keys that are not strings, and extension types."""
    blob = oracle.packb(
        {1: 2.5, "e": oracle.ExtType(5, b"xyz")}, use_bin_type=True
    )
    got = mp.unpackb(blob)
    assert got[1] == 2.5 and got["e"] == mp.ExtType(5, b"xyz")


@pytest.mark.parametrize("blob", [b"", b"\x92\x01", b"\xc1", b"\x01\x02", b"\xda\x00\x05ab"])
def test_malformed_input_raises_value_error(blob):
    with pytest.raises(ValueError):
        mp.unpackb(blob)


def test_nan_and_overflow_floats_match_oracle():
    for x in (math.inf, -math.inf, 1e300, 3.4e38):
        assert mp.packb(x) == _oracle_pack(x)
    assert math.isnan(mp.unpackb(mp.packb(math.nan)))


def test_metadata_bytes_match_oracle():
    m = FloMetadata.with_basic("Title", "Artist", "Album")
    m.bpm = 120
    m.add_picture("image/png", PictureType.COVER_FRONT, b"\x89PNG" * 100)
    obj = m.to_obj()
    assert m.to_msgpack() == _oracle_pack(obj)
    assert FloMetadata.from_msgpack(_oracle_pack(obj)).to_obj() == obj


def test_import_without_msgpack_package(tmp_path):
    """`import flo_tpu` and a metadata round trip need no msgpack package."""
    code = (
        "import sys; sys.modules['msgpack'] = None\n"
        "import flo_tpu\n"
        "from flo_tpu.core.metadata import FloMetadata\n"
        "m = FloMetadata.with_basic('t', 'a')\n"
        "assert FloMetadata.from_msgpack(m.to_msgpack()).title == 't'\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
        cwd=tmp_path, env={**__import__("os").environ, "JAX_PLATFORMS": "cpu",
                           "PYTHONPATH": str(__import__("pathlib").Path(__file__).parents[1])},
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
