"""Median reductions — the reference leans on medians everywhere
(noise floor ``create_pdws.m:44``, pulse magnitude ``:70``, phase difference
``:86``, PRI ``predict_event.m:135``).  MATLAB ``median`` semantics: middle
element for odd length, mean of the two middle elements for even length.

Two exact implementations: :func:`median` (whole-capture noise floors)
takes the backend's choice from ``ops.backend.noise_floor_median`` when
``method`` is None; :func:`masked_median` (per-pulse windows) sorts unless
told otherwise:

* **sort** — ``jnp.sort``-based;
* **select** — sort-free radix selection: map f32 to order-preserving u32
  keys, then walk the 32 bits MSB-first, counting survivors below each
  pivot (32 data passes, or 32/bits with ``bits`` > 1; pure elementwise +
  reductions).  It is also the streamed noise floor's algorithm
  (``dsp.streaming``).

Both pick exactly the same order statistics, so results are bit-identical
whichever runs (SURVEY.md section 7's "document the median choice" note:
the choice is *exact* on both).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sdr_channelizer_tpu.ops import backend

def _sortable_u32(x: jax.Array) -> jax.Array:
    """IEEE-754 f32 -> u32 keys with the same total order (NaNs sort high)."""
    u = jax.lax.bitcast_convert_type(x.astype(jnp.float32), jnp.uint32)
    neg = (u >> 31) == 1
    return jnp.where(neg, ~u, u | jnp.uint32(0x80000000))


def _u32_to_f32(u: jax.Array) -> jax.Array:
    neg = (u >> 31) == 0  # originally negative -> sign bit now clear
    raw = jnp.where(neg, ~u, u & jnp.uint32(0x7FFFFFFF))
    return jax.lax.bitcast_convert_type(raw, jnp.float32)


def _kth_smallest_key(keys: jax.Array, mask: jax.Array, k: jax.Array,
                      axis: int) -> jax.Array:
    """k-th smallest (0-based) masked key along ``axis`` via radix descent.

    ``k`` has the shape of ``keys`` with ``axis`` removed.  Undefined when a
    slice has fewer than k+1 masked elements (callers guard with the count).
    """
    prefix = jnp.zeros_like(k, dtype=jnp.uint32)
    kk = k.astype(jnp.int32)
    for b in range(31, -1, -1):
        bit = np.uint32(1 << b)
        above = np.uint32((0xFFFFFFFF << (b + 1)) & 0xFFFFFFFF) if b < 31 else np.uint32(0)
        live = mask & ((keys & above) == jnp.expand_dims(prefix & above, axis))
        zero_here = (keys & bit) == 0
        cnt0 = jnp.sum(live & zero_here, axis=axis).astype(jnp.int32)
        take1 = kk >= cnt0
        kk = jnp.where(take1, kk - cnt0, kk)
        prefix = jnp.where(take1, prefix | bit, prefix)
    return prefix


def _kth_smallest_key_multibit(keys: jax.Array, mask: jax.Array, k: jax.Array,
                               axis: int, bits: int) -> jax.Array:
    """Value-space radix descent, ``bits`` per level: ``32/bits`` counting
    passes over the data instead of 32.

    Each level evaluates ``count(mask & keys <= cut_j)`` at the
    ``2^bits - 1`` candidate cut points below the current prefix (absolute
    range compares — no live-prefix mask needed, unlike the 1-bit form) and
    picks the smallest bucket whose count reaches ``k+1``.  Identical order
    statistics to :func:`_kth_smallest_key`; the win is HBM passes — the
    noise-floor median over a (T, M) block is bandwidth-bound, and 8 passes
    (bits=4) beat 32 by ~the pass ratio when XLA fuses the per-level cut
    compares into one read.
    """
    assert 32 % bits == 0, bits
    prefix = jnp.zeros_like(k, dtype=jnp.uint32)
    kk = k.astype(jnp.int32)
    j = jnp.asarray(np.arange(1, 1 << bits, dtype=np.uint32))  # (2^bits - 1,)
    for level in range(32 // bits):
        shift = 32 - bits * (level + 1)
        cuts = (jnp.expand_dims(prefix, -1) | (j << shift)) - jnp.uint32(1)
        cuts_b = jnp.expand_dims(cuts, axis)  # broadcast over the data axis
        below = mask[..., None] & (keys[..., None] <= cuts_b)
        cnt = jnp.sum(below, axis=axis).astype(jnp.int32)  # (..., 2^bits-1)
        nib = jnp.sum(cnt <= jnp.expand_dims(kk, -1), axis=-1).astype(jnp.uint32)
        prefix = prefix | (nib << shift)
    return prefix


def _masked_median_select(x: jax.Array, mask: jax.Array, axis: int,
                          bits: int = 1) -> jax.Array:
    keys = _sortable_u32(x)
    n = jnp.sum(mask, axis=axis).astype(jnp.int32)
    k_lo = jnp.maximum((n - 1) // 2, 0)
    k_hi = jnp.maximum(n // 2, 0)
    if bits > 1:
        pref = _kth_smallest_key_multibit(keys, mask, k_lo, axis, bits)
    else:
        pref = _kth_smallest_key(keys, mask, k_lo, axis)
    lo = _u32_to_f32(pref)
    # The k_hi-th order statistic (n even) without a second 32-pass
    # descent: it is `lo` again when duplicates of lo cover rank k_hi,
    # else the smallest masked value strictly above it — one counting
    # pass + one masked min.
    pref_e = jnp.expand_dims(pref, axis)
    cnt_le = jnp.sum(mask & (keys <= pref_e), axis=axis).astype(jnp.int32)
    nxt = jnp.min(jnp.where(mask & (keys > pref_e), x, jnp.inf), axis=axis)
    hi = jnp.where(cnt_le > k_hi, lo, nxt)
    med = 0.5 * (lo + hi)
    return jnp.where(n > 0, med, jnp.nan)


def _masked_median_sort(x: jax.Array, mask: jax.Array, axis: int) -> jax.Array:
    x = jnp.where(mask, x, jnp.inf)
    x = jnp.sort(x, axis=axis)
    n = jnp.sum(mask, axis=axis, keepdims=True)
    lo_idx = jnp.maximum((n - 1) // 2, 0)
    hi_idx = jnp.maximum(n // 2, 0)
    lo = jnp.take_along_axis(x, lo_idx, axis=axis)
    hi = jnp.take_along_axis(x, hi_idx, axis=axis)
    med = 0.5 * (lo + hi)
    med = jnp.where(jnp.squeeze(n, axis) > 0, jnp.squeeze(med, axis), jnp.nan)
    return med


def masked_median(
    x: jax.Array, mask: jax.Array, axis: int = -1,
    method: Optional[str] = None, bits: int = 1
) -> jax.Array:
    """Median of ``x`` where ``mask`` is True along ``axis``.

    Exact MATLAB semantics (mean of the two middle order statistics for
    even counts); NaN where the mask is empty.  ``method``: "sort" (also
    for None) or "select".  ``bits``: radix bits per
    counting pass on the select path (1 = classic 32-pass descent; 4 =
    8 passes — same exact result, fewer HBM reads; used by the noise
    floor over large blocks).
    """
    axis = axis % x.ndim
    mask = jnp.broadcast_to(mask, x.shape)
    if method == "select":
        return _masked_median_select(x, mask, axis, bits=bits)
    return _masked_median_sort(x, mask, axis)


def median(x: jax.Array, axis: Optional[int] = None,
           method: Optional[str] = None, bits: int = 1) -> jax.Array:
    """Exact median along ``axis`` (None = over all elements).
    ``method=None`` takes ``ops.backend.noise_floor_median`` (method and
    bits)."""
    if method is None:
        method, bits = backend.noise_floor_median()
    if method == "sort":
        return jnp.median(x, axis=axis)
    if axis is None:
        x = jnp.ravel(x)
        axis = 0
    return _masked_median_select(
        x, jnp.ones(x.shape, bool), axis % x.ndim, bits=bits
    )
