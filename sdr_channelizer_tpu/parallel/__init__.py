"""Distribution layer: 2-D (time-blocks x channels) device mesh, overlap-save
halo exchange, cross-shard PDW latch chaining and merge.

The reference is single-process / single-device over USB (SURVEY.md
section 5.7-5.8); this package is the multi-device scale-out design it never
had: the sample axis is sharded into time blocks (the sequence-parallel
analog), the channel axis is sharded for PDW extraction (the tensor-parallel
analog — each mesh column keeps its band slice), FIR filter history rides
NVLink (NCCL) via
``ppermute`` halos, and pulses straddling block edges are stitched exactly by
composing the detector's latch transfer functions across shards.
"""

from sdr_channelizer_tpu.parallel.mesh import make_mesh, TIME_AXIS, CHAN_AXIS  # noqa: F401
from sdr_channelizer_tpu.parallel.pipeline import (  # noqa: F401
    ShardedPipeline,
    sharded_channelize,
)
