"""Compute ops: prototype filter design, exact median reductions, device
payload dequantization, and the per-backend method choice."""

from sdr_channelizer_tpu.ops.filters import (  # noqa: F401
    design_prototype_filter,
    polyphase_decompose,
    kaiser_beta,
)
from sdr_channelizer_tpu.ops.medians import masked_median, median  # noqa: F401
