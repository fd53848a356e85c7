"""Device-side dequantization of the raw recorder payload.

The recorders write interleaved integer I/Q pairs (``io.iqpacket``).  The
pipelines take those bytes to the device untouched, one pair per element:
an (N, 2) int16 payload viewed as int32, or an (N, 2) int8 payload viewed
as int16 (``packed_view``).  Sign extension by shifts and the
``2^-(bit_width-1)`` Q-format scale then run on the device.  Both factors
are exact in f32, so the result equals ``io.iqpacket.to_complex`` on the
host bit for bit (``create_pdws.m:30-33``).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def packed_view(samples: np.ndarray) -> np.ndarray:
    """(N, 2) int16 or int8 payload -> (N,) int32 or int16 packed view
    (no copy for a contiguous payload)."""
    samples = np.ascontiguousarray(samples)
    if samples.dtype == np.int16:
        return samples.view(np.int32).ravel()
    if samples.dtype == np.int8:
        return samples.view(np.int16).ravel()
    raise ValueError(f"packed payloads are int16 or int8, not {samples.dtype}")


def unpack_planes(xq: jax.Array, bit_width: int) -> Tuple[jax.Array, jax.Array]:
    """Packed payload -> dequantized float32 (I, Q) planes.

    ``xq``: int32 (int16 pairs: low half I, high half Q on a little-endian
    host) or int16 (int8 pairs: low byte I, high byte Q).
    """
    scale = jnp.float32(2.0 ** -(bit_width - 1))
    if xq.dtype == jnp.int32:
        xr = (xq << 16) >> 16
        xi = xq >> 16
    elif xq.dtype == jnp.int16:
        x32 = xq.astype(jnp.int32)
        xr = (x32 << 24) >> 24
        xi = x32 >> 8
    else:
        raise ValueError(f"packed payloads are int32 or int16, not {xq.dtype}")
    return xr.astype(jnp.float32) * scale, xi.astype(jnp.float32) * scale


def unpack_complex(xq: jax.Array, bit_width: int) -> jax.Array:
    """Packed payload -> dequantized complex64 capture."""
    xr, xi = unpack_planes(xq, bit_width)
    return jax.lax.complex(xr, xi)


def planes_complex(xr: jax.Array, xi: jax.Array, bit_width: int = 0) -> jax.Array:
    """Integer (``bit_width`` > 0) or float (``bit_width`` = 0) I/Q planes ->
    complex64 capture."""
    xr = xr.astype(jnp.float32)
    xi = xi.astype(jnp.float32)
    if bit_width:
        scale = jnp.float32(2.0 ** -(bit_width - 1))
        xr, xi = xr * scale, xi * scale
    return jax.lax.complex(xr, xi)
