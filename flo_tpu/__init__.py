"""flo_tpu — a batch reimplementation of the flo dual-mode audio codec in JAX.

Batch-first architecture: the unit of work is a batch of frames shaped
[lanes, samples]; all codec math runs as jitted XLA/Pallas programs over the
batch, while variable-length bitstream assembly runs in a vectorized host
finalizer. The public API mirrors libflo/src/lib.rs.
"""

from .core.constants import VERSION_STRING as __format_version__
from .lib import (
    AudioInfo,
    add_analysis_data_if_missing,
    create_metadata,
    decode,
    encode,
    encode_lossy,
    encode_transform,
    encode_with_bitrate,
    format_time,
    format_time_ms,
    get_metadata,
    get_metadata_bytes,
    has_metadata,
    info,
    strip_metadata,
    update_metadata,
    update_metadata_bytes,
    validate,
    version,
)
from .seeking import SeekResult, decode_frame_at, get_toc, seek_to_time

__version__ = "0.1.0"

__all__ = [
    "AudioInfo",
    "SeekResult",
    "add_analysis_data_if_missing",
    "create_metadata",
    "decode",
    "decode_frame_at",
    "encode",
    "encode_lossy",
    "encode_transform",
    "encode_with_bitrate",
    "format_time",
    "format_time_ms",
    "get_metadata",
    "get_metadata_bytes",
    "get_toc",
    "has_metadata",
    "info",
    "seek_to_time",
    "strip_metadata",
    "update_metadata",
    "update_metadata_bytes",
    "validate",
    "version",
]
