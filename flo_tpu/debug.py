"""Debug / integrity mode (SURVEY.md §5.2 aux subsystem).

The reference's only runtime integrity machinery is the CRC32 validate path
plus clippy at build time; this build adds an opt-in debug mode
that turns on JAX's numerical checks and makes every decode verify the DATA
CRC before touching frames.
"""

from __future__ import annotations

import contextlib

_DEBUG = False


def debug_enabled() -> bool:
    return _DEBUG


def enable_debug_mode(enable: bool = True) -> None:
    """Turn on jax NaN/Inf checks + CRC-verified decodes."""
    global _DEBUG
    import jax

    _DEBUG = bool(enable)
    jax.config.update("jax_debug_nans", _DEBUG)
    jax.config.update("jax_debug_infs", _DEBUG)


@contextlib.contextmanager
def debug_mode():
    """Context manager form of :func:`enable_debug_mode`."""
    prev = _DEBUG
    enable_debug_mode(True)
    try:
        yield
    finally:
        enable_debug_mode(prev)


def check_crc(data: bytes) -> None:
    """Raise if the DATA CRC does not match (used by decode in debug mode)."""
    from . import lib

    if not lib.validate(data):
        raise ValueError("CRC32 mismatch: corrupted flo data")
