"""Multi-host ingest: host-local ``.iq`` reads feeding a globally sharded
array.

The reference is strictly single-host over USB (SURVEY.md section 5.8).
The scale-out story for multi-GB capture sets across hosts:

* each process reads only the dwell files covering its own time shards
  (``host_local_time_range``) — no cross-host filesystem traffic;
* :func:`make_global_capture` assembles the per-process arrays into one
  globally sharded ``jax.Array`` over the (time, chan) mesh via
  ``jax.make_array_from_single_device_arrays`` — the standard
  device-buffers-to-global-view construction, which works identically for
  one process holding all devices (tested here) and many processes holding
  disjoint device subsets (``jax.distributed.initialize`` at startup);
* the :class:`~sdr_channelizer_tpu.parallel.pipeline.ShardedPipeline` then
  consumes the global array; its collectives (FIR halos, latch chaining,
  noise-floor median) ride ICI/DCN as laid out by the mesh.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import numpy as np
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from sdr_channelizer_tpu.parallel.mesh import TIME_AXIS


def time_shard_bounds(n_samples: int, n_time: int) -> List[Tuple[int, int]]:
    """[start, end) sample range of each time shard (equal blocks)."""
    if n_samples % n_time:
        raise ValueError(f"{n_samples} samples not divisible by {n_time} shards")
    block = n_samples // n_time
    return [(i * block, (i + 1) * block) for i in range(n_time)]


def host_local_time_range(
    mesh: jax.sharding.Mesh, n_samples: int
) -> Tuple[int, int]:
    """The [start, end) sample range this process's devices own.

    With a single process this is the whole capture; under
    ``jax.distributed`` each process gets the union of its addressable time
    shards (contiguous for the standard device order).
    """
    n_time = mesh.shape[TIME_AXIS]
    bounds = time_shard_bounds(n_samples, n_time)
    addressable = {d.id for d in jax.local_devices()}
    mine = [
        bounds[i]
        for i in range(n_time)
        if any(d.id in addressable for d in np.asarray(mesh.devices)[i].ravel())
    ]
    if not mine:
        raise ValueError("this process owns no time shards of the mesh")
    return mine[0][0], mine[-1][1]


def make_global_capture(
    mesh: jax.sharding.Mesh,
    local_samples: np.ndarray,
    n_samples: int,
    local_start: int,
) -> jax.Array:
    """Build the globally (time-)sharded capture array from this process's
    local span ``[local_start, local_start + len(local_samples))``."""
    sharding = NamedSharding(mesh, P(TIME_AXIS))
    n_time = mesh.shape[TIME_AXIS]
    bounds = time_shard_bounds(n_samples, n_time)
    buffers = []
    devs = np.asarray(mesh.devices)
    local_ids = {d.id for d in jax.local_devices()}
    for i, (s, e) in enumerate(bounds):
        row = devs[i].ravel()
        for dev in row:
            if dev.id not in local_ids:
                continue
            if s < local_start or e > local_start + len(local_samples):
                raise ValueError(
                    f"shard [{s},{e}) outside this host's span "
                    f"[{local_start},{local_start + len(local_samples)})"
                )
            block = local_samples[s - local_start : e - local_start]
            buffers.append(jax.device_put(block, dev))
    return jax.make_array_from_single_device_arrays(
        (n_samples,), sharding, buffers
    )


def ingest_capture_set(
    mesh: jax.sharding.Mesh, segment, n_samples: int
) -> jax.Array:
    """Read this host's span of a :class:`~sdr_channelizer_tpu.dsp.streaming.
    Segment` and build the global array (single-segment convenience)."""
    from sdr_channelizer_tpu.io import iqpacket

    lo, hi = host_local_time_range(mesh, n_samples)
    parts = []
    pos = 0
    for path, hdr in zip(segment.paths, segment.headers):
        n = hdr.num_samples
        s, e = pos, pos + n
        if e > lo and s < hi:
            _, samples = iqpacket.read_iq(path)
            iq = iqpacket.to_complex(np.asarray(samples), hdr.bit_width)
            parts.append(iq[max(lo - s, 0) : min(hi, e) - s])
        pos += n
        if pos >= hi:
            break
    local = np.concatenate(parts) if parts else np.zeros(0, np.complex64)
    return make_global_capture(mesh, local, n_samples, lo)
