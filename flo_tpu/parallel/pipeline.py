"""Mesh sharding helpers + sharded codec steps.

The fused candidate-search program lives in ops/select.py; this module adds
the `jax.sharding` plumbing for scaling it over a device mesh: a 1-D 'batch'
axis over codec lanes (data parallelism — the only parallelism dimension the
workload warrants, SURVEY.md §2.9). Each lane is independent, so XLA
partitions every step with zero collectives; host gather of the
variable-length packed streams is the only cross-device synchronization.

PRODUCTION bulk pipelines (lossless/lossy encode_many + decode_many) take an
optional mesh, either as an explicit ``mesh=`` argument or ambiently via
:func:`use_mesh`::

    with flo_tpu.parallel.use_mesh(pipeline.device_mesh()):
        datas = lossless.encoder.encode_many(clips, 44100, 2)

Their chunk dispatchers then pad each chunk's frame axis to a mesh multiple
and device_put every batch-major array with a 'batch' NamedSharding (small
side inputs are replicated), so the SAME jitted programs run GSPMD-partitioned
over all chips. Per-lane work partitions with zero collectives; only the
entropy-packed wire buffers' global offset scans cross shard boundaries.
Outputs are byte-identical to the unsharded path (tests/test_parallel.py;
exercised end to end by __graft_entry__.dryrun_multichip and by
``python chip_smoke.py --four`` on four GPUs).
"""

from __future__ import annotations

import os
from contextlib import contextmanager
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.select import encode_select_step  # re-exported sharded step

__all__ = [
    "active_mesh",
    "batch_sharding",
    "bucket_count",
    "decode_step",
    "device_mesh",
    "encode_select_step",
    "pad_batch",
    "put_batch",
    "put_replicated",
    "shape_buckets_on",
    "shard_batch",
    "use_mesh",
    "use_shape_buckets",
]

#: Ambient mesh stack for the bulk pipelines (see use_mesh).
_MESH_STACK: list[Mesh] = []


@contextmanager
def use_mesh(mesh: Mesh):
    """Route every bulk pipeline dispatched inside the block over `mesh`."""
    _MESH_STACK.append(mesh)
    try:
        yield mesh
    finally:
        _MESH_STACK.pop()


def active_mesh(mesh: Mesh | None = None) -> Mesh | None:
    """Resolve the effective mesh: explicit argument, else ambient, else None."""
    if mesh is not None:
        return mesh
    return _MESH_STACK[-1] if _MESH_STACK else None


def mesh_size(mesh: Mesh | None) -> int:
    return 1 if mesh is None else int(np.prod(list(mesh.shape.values())))


#: Shape-bucket mode stack (see use_shape_buckets). Opt-in because the
#: padding costs up to +33% device compute on a one-shot batch; it pays for
#: itself whenever batch geometry varies call-to-call (serving), since every
#: new shape compiles its programs anew.
_SHAPE_BUCKETS: list[bool] = [os.environ.get("FLO_SHAPE_BUCKETS", "0") not in ("", "0")]


@contextmanager
def use_shape_buckets(enabled: bool = True):
    """Pad bulk-pipeline batch axes (lanes; the lossy hop axis) to
    {1, 1.5}x2^k buckets inside the block, so arbitrary batch geometries hit
    a logarithmic set of compiled programs instead of one per exact shape.
    Padding rows are the same inert nvalid=0 / all-zero lanes the mesh
    padding already uses, so outputs are unchanged (tests/test_bulk.py)."""
    _SHAPE_BUCKETS.append(bool(enabled))
    try:
        yield
    finally:
        _SHAPE_BUCKETS.pop()


def shape_buckets_on() -> bool:
    return _SHAPE_BUCKETS[-1]


def bucket_count(n: int, floor: int = 4) -> int:
    """{1, 1.5} x 2^k growth bucket (4, 6, 8, 12, 16, 24, 32, ...)."""
    from ..buckets import grow_bucket

    return grow_bucket(n, floor)


def pad_batch(n: int, mesh: Mesh | None) -> int:
    """Round a batch count up to a mesh multiple (padding lanes are inert:
    nvalid=0 rows select raw with zero payload bytes everywhere). Under
    :func:`use_shape_buckets`, round up to a shape bucket first."""
    d = mesh_size(mesh)
    if _SHAPE_BUCKETS[-1] and n > 0:
        n = bucket_count(n)
    return -(-n // d) * d


# NOTE on lossy equality: the f32 FFT stages are nondeterministic at the ulp
# level on this backend (run-to-run AND batch-size dependent — SIMD paths
# vary with buffer alignment), so sharded == unsharded holds BYTE-exactly for
# the integer lossless pipelines and within one i16 quantization step for the
# lossy ones (tests/test_parallel.py asserts accordingly).


def put_batch(x, mesh: Mesh | None):
    """Upload with axis-0 'batch' sharding under a mesh, else plain asarray."""
    if mesh is None:
        return jnp.asarray(x)
    return jax.device_put(np.asarray(x), batch_sharding(mesh, np.ndim(x)))


def put_replicated(x, mesh: Mesh | None):
    """Upload fully replicated under a mesh (small side inputs — a jit cannot
    mix mesh-committed and single-device-committed arguments)."""
    if mesh is None:
        return jnp.asarray(x)
    return jax.device_put(np.asarray(x), NamedSharding(mesh, P()))


def device_mesh(devices=None, n: int | None = None) -> Mesh:
    """1-D 'batch' mesh over the given (or all) devices."""
    if devices is None:
        devices = jax.devices()
    if n is not None:
        devices = devices[:n]
    return Mesh(np.array(devices), ("batch",))


def batch_sharding(mesh: Mesh, ndim: int) -> NamedSharding:
    """Shard axis 0 (lanes) across the mesh, replicate the rest."""
    return NamedSharding(mesh, P("batch", *([None] * (ndim - 1))))


def shard_batch(mesh: Mesh, *arrays):
    """device_put each array with its batch-axis sharding."""
    return tuple(jax.device_put(a, batch_sharding(mesh, np.ndim(a))) for a in arrays)


@partial(jax.jit, static_argnames=("channels",))
def decode_step(rows, coeffs, shifts, orders, is_fixed, mid_side, channels: int):
    """Sharded decode step: reconstruction + mid/side + f32 (one program)."""
    from ..lossless.decoder import _device_decode

    return _device_decode(rows, coeffs, shifts, orders, is_fixed, mid_side, channels)
