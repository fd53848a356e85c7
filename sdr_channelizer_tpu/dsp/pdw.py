"""Pulse-descriptor-word (PDW) extraction — vectorized.

Reproduces the semantics of the reference's sequential edge-detector loops
(wideband ``matlab/create_pdws.m:51-105``, channelized
``create_pdws_channelized.m:79-136``, event-mode ``predict_event.m:70-123``,
C++ twin ``usrp_predict_event.cpp:300-343``) without the sequential loop:

* the pulse-active hysteresis latch (set when ``mag >= lead``, reset when
  ``mag <= trail``, hold otherwise, trailing checked only while active) is
  computed with a **parallel associative scan** over 2-bit boolean transfer
  functions — the latch update is function composition over {set, reset,
  hold, toggle}, which is associative;
* per-pulse statistics (median magnitude, median wrapped phase difference,
  saturation) are computed over fixed-width windows gathered at each pulse's
  leading edge, masked to the true pulse extent — static shapes, vmapped
  over pulses and channels.

Numerical parity notes (deliberate reference quirks, kept):

* TOA uses the MATLAB 1-based sample index: ``toa_time = (i0+1)/fs + t0``
  where ``i0`` is the 0-based leading-edge index (``create_pdws.m:67``);
* the trailing-edge sample (below threshold) IS included in the median
  magnitude / phase-difference windows (``median(mag(toa:jj))``);
* pulse width is ``(jj - toa)/fs`` — trailing minus leading index
  (``create_pdws.m:79``);
* phase differences in degrees, wrapped once into [-180, 180] with strict
  inequalities (``create_pdws.m:84-85``: exactly +/-180 is NOT wrapped);
* saturation (|I| or |Q| >= 0.9999) is only checked strictly inside the
  pulse — not at the leading- or trailing-edge samples
  (``create_pdws.m:100-102`` runs in the not-a-trailing-edge branch and the
  leading-edge iteration resets the flag);
* frequency: ``f = fc + fs * medPhaseDiff / 360`` (``create_pdws.m:91``,
  algebraically identical to ``fc + fs/(360/med)``);
* a pulse still active at the end of the capture is not emitted.

The jitted core returns integer indices + float32 metrics; absolute times
and absolute frequencies are finalized on the host in float64 (epoch seconds
do not fit float32).  Fixed bugs NOT replicated: the reference channelized
extractor's linear-indexing bug ``phase(toa:jj)`` that always reads bin 1
(``create_pdws_channelized.m:114``) — we index the actual bin.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.ops import medians
from sdr_channelizer_tpu.ops.medians import masked_median

@jax.tree_util.register_dataclass
@dataclasses.dataclass
class PdwBatch:
    """Fixed-capacity batch of PDWs from one (block, channel).

    Arrays have leading dimension ``max_pulses`` (plus any vmapped batch
    dims).  Only the first ``count`` entries (``valid`` mask) are real.
    """

    toa_idx: jax.Array  # i32, 0-based leading-edge sample index
    te_idx: jax.Array  # i32, 0-based trailing-edge sample index
    pw_sec: jax.Array  # f32, (te - toa)/fs
    mag: jax.Array  # f32, median |iq| over the pulse
    snr_db: jax.Array  # f32, 10*log10(mag/noise_floor)
    freq_offset_hz: jax.Array  # f32, fs*medPhaseDiff/360 (add fc on host)
    saturated: jax.Array  # bool
    valid: jax.Array  # bool
    count: jax.Array  # i32 scalar, number of valid PDWs


def compose_transfer(f1, f2):
    """Compose boolean-latch transfer functions: apply ``f1`` then ``f2``.

    A transfer function is the pair ``(f(0), f(1))``; composition is
    ``(f2(a1), f2(b1))`` and is associative — the algebraic core of both the
    in-block parallel scan and the cross-shard latch chaining
    (``parallel/pipeline.py``).
    """
    a1, b1 = f1
    a2, b2 = f2
    return (jnp.where(a1, b2, a2), jnp.where(b1, b2, a2))


def hysteresis_fns(ge_lead: jax.Array, le_trail: jax.Array, axis: int = -1):
    """Prefix transfer functions ``(a, b)`` of the pulse-active latch.

    Element transfer functions over the boolean latch state (f(0), f(1)):
    ``(ge_lead, ~le_trail)`` — set/(reset)/hold/toggle.  The associative scan
    yields at each position the composition of all transfer functions up to
    and including it: ``a`` is the latch state had it started inactive, ``b``
    had it started active.  Seeding with an arbitrary entry state is
    ``jnp.where(entry, b, a)`` — this is what makes the latch exactly
    shardable across time blocks.
    """
    return jax.lax.associative_scan(
        compose_transfer, (ge_lead, jnp.logical_not(le_trail)), axis=axis
    )


def hysteresis_scan(ge_lead: jax.Array, le_trail: jax.Array, axis: int = -1) -> jax.Array:
    """Pulse-active state after each sample (latch starts inactive, matching
    the reference's ``pulseActive = false`` initialization,
    ``create_pdws.m:51``)."""
    a, _ = hysteresis_fns(ge_lead, le_trail, axis=axis)
    return a  # f_prefix(0)


def _edge_indices(edge: jax.Array, max_pulses: int) -> jax.Array:
    """Indices of True entries, padded with len(edge) (an out-of-range
    sentinel) to ``max_pulses``.

    The r-th edge is the first position whose inclusive edge count reaches
    r: a binary search of the ranks 1..max_pulses in the edge cumsum.
    Ranks past the count come back as len(edge).
    """
    csum = jnp.cumsum(edge.astype(jnp.int32))
    ranks = jnp.arange(1, max_pulses + 1, dtype=jnp.int32)
    return jnp.searchsorted(csum, ranks, side="left").astype(jnp.int32)


@functools.partial(
    jax.jit, static_argnames=("snr_threshold_db", "trailing_threshold_db",
                              "saturation_level", "max_pulses", "max_pulse_samples",
                              "median_method")
)
def extract_pdws_core(
    mag: jax.Array,
    phase_deg: jax.Array,
    sat_sample: jax.Array,
    noise_floor: jax.Array,
    *,
    snr_threshold_db: float,
    trailing_threshold_db: Optional[float],
    saturation_level: float,  # unused here (sat_sample precomputed); kept for cfg symmetry
    max_pulses: int,
    max_pulse_samples: int,
    median_method: Optional[str] = None,
) -> PdwBatch:
    """Extract PDWs from one channel's magnitude/phase streams.

    mag, phase_deg, sat_sample: (T,).  noise_floor: scalar.
    ``median_method`` is the per-pulse medians' method
    (``ops.medians.masked_median``: None sorts).
    """
    del saturation_level
    t_len = mag.shape[-1]
    w = max_pulse_samples

    lead_thresh = noise_floor * 10.0 ** (snr_threshold_db / 10.0)
    if trailing_threshold_db is None:
        trail_thresh = lead_thresh
    else:
        trail_thresh = noise_floor * 10.0 ** (trailing_threshold_db / 10.0)

    with jax.named_scope("latch"):
        ge_lead = mag >= lead_thresh
        le_trail = mag <= trail_thresh
        state = hysteresis_scan(ge_lead, le_trail)
        prev = jnp.concatenate([jnp.zeros((1,), bool), state[:-1]])
        lead_edge = state & ~prev
        trail_edge = ~state & prev

    # The latch state at sample jj already reflects sample jj's thresholds,
    # so a trailing edge at sample jj (mag[jj] <= trail while previously
    # active) shows as state[jj] = 0 with state[jj-1] = 1 — trail_edge[jj]
    # is True exactly at the reference's `jj`.
    with jax.named_scope("edge_search"):
        toa_idx = _edge_indices(lead_edge, max_pulses)
        te_idx = _edge_indices(trail_edge, max_pulses)
    # Clamp to capacity: a capture with more pulses than slots silently drops
    # the overflow, and ``count`` must agree with the number of valid slots
    # (consumers sum counts across blocks/channels).
    count = jnp.minimum(jnp.sum(trail_edge), max_pulses).astype(jnp.int32)
    valid = jnp.arange(max_pulses) < count
    return _emit_batch(
        mag, phase_deg, sat_sample, noise_floor, toa_idx, te_idx, valid, count, w,
        median_method,
    )


def _emit_batch(mag, phase_deg, sat_sample, noise_floor, toa_idx, te_idx, valid,
                count, w, median_method=None):
    """Per-pulse statistics + batch assembly shared by the single-device and
    block-sharded extractors.  ``w = max_pulse_samples``."""
    with jax.named_scope("pulse_stats"):
        t_len = mag.shape[-1]

        # Pad streams so fixed windows can be gathered at any edge index.
        mag_p = jnp.concatenate([mag, jnp.full((w,), jnp.inf, mag.dtype)])
        dph = phase_deg[1:] - phase_deg[:-1]
        dph = jnp.where(dph < -180.0, dph + 360.0, dph)
        dph = jnp.where(dph > 180.0, dph - 360.0, dph)
        dph_p = jnp.concatenate([dph, jnp.zeros((w + 1,), dph.dtype)])
        sat_p = jnp.concatenate([sat_sample, jnp.zeros((w,), bool)])

        pos = jnp.arange(w)

        def per_pulse(i0, i1):
            plen = jnp.minimum(i1 - i0 + 1, w)  # samples toa..jj inclusive
            magwin = jax.lax.dynamic_slice_in_dim(mag_p, i0, w)
            m_mask = pos < plen
            med_mag = masked_median(magwin, m_mask, method=median_method)
            # diff(phase(toa:jj)) = dph[toa .. jj-1], plen-1 entries
            dwin = jax.lax.dynamic_slice_in_dim(dph_p, i0, w)
            d_mask = pos < (plen - 1)
            med_dph = masked_median(dwin, d_mask, method=median_method)
            # saturation strictly inside the pulse: samples toa+1 .. jj-1
            swin = jax.lax.dynamic_slice_in_dim(sat_p, i0, w)
            s_mask = (pos >= 1) & (pos < (plen - 1))
            sat = jnp.any(swin & s_mask)
            return med_mag, med_dph, sat

        i0c = jnp.clip(toa_idx, 0, t_len)
        i1c = jnp.clip(te_idx, 0, t_len)
        med_mag, med_dph, sat = jax.vmap(per_pulse)(i0c, i1c)

        snr = 10.0 * jnp.log10(med_mag / noise_floor)
        zero = jnp.zeros((), jnp.float32)
        return PdwBatch(
            toa_idx=jnp.where(valid, toa_idx, -1),
            te_idx=jnp.where(valid, te_idx, -1),
            pw_sec=jnp.where(valid, (te_idx - toa_idx).astype(jnp.float32), zero),
            mag=jnp.where(valid, med_mag.astype(jnp.float32), zero),
            snr_db=jnp.where(valid, snr.astype(jnp.float32), zero),
            freq_offset_hz=jnp.where(valid, med_dph.astype(jnp.float32) / 360.0, zero),
            saturated=jnp.where(valid, sat, False),
            valid=valid,
            count=count,
        )


@functools.partial(
    jax.jit,
    static_argnames=("own_len", "snr_threshold_db", "trailing_threshold_db",
                     "max_pulses", "max_pulse_samples"),
)
def extract_pdws_block_core(
    mag: jax.Array,
    phase_deg: jax.Array,
    sat_sample: jax.Array,
    noise_floor: jax.Array,
    entry_active: jax.Array,
    *,
    own_len: int,
    snr_threshold_db: float,
    trailing_threshold_db: Optional[float],
    max_pulses: int,
    max_pulse_samples: int,
) -> PdwBatch:
    """PDW extraction for one time block of a sharded capture.

    ``mag/phase_deg/sat_sample`` cover ``own_len`` owned samples plus a right
    halo (the following shard's head, or +inf magnitude past capture end).
    ``entry_active`` is the latch state entering the block (chained from the
    previous shard via :func:`block_transfer` composition).  The block emits
    exactly the pulses whose **leading edge** lies in its owned region; the
    trailing edge and pulse statistics may extend into the halo.  With a halo
    at least one sample longer than the longest pulse, concatenating all
    blocks' PDWs (offset by the block start) reproduces the single-device
    extractor bit-for-bit — including the reference rule that a pulse still
    active at capture end is never emitted (the +inf pad keeps the latch set
    so the final pulse stays unmatched).
    """
    w = max_pulse_samples
    lead_thresh = noise_floor * 10.0 ** (snr_threshold_db / 10.0)
    if trailing_threshold_db is None:
        trail_thresh = lead_thresh
    else:
        trail_thresh = noise_floor * 10.0 ** (trailing_threshold_db / 10.0)

    ge_lead = mag >= lead_thresh
    le_trail = mag <= trail_thresh
    a, b = hysteresis_fns(ge_lead, le_trail)
    state = jnp.where(entry_active, b, a)
    prev = jnp.concatenate([entry_active[None], state[:-1]])
    lead_edge = state & ~prev
    trail_edge = ~state & prev

    t_total = mag.shape[-1]
    pos_all = jnp.arange(t_total)
    owned_lead = lead_edge & (pos_all < own_len)
    toa_idx = _edge_indices(owned_lead, max_pulses)
    # Latch events strictly alternate; when the block enters active, the
    # first event is the previous shard's trailing edge — skip it.
    trail_all = _edge_indices(trail_edge, max_pulses + 1)
    skip = entry_active.astype(jnp.int32)
    te_idx = trail_all[jnp.arange(max_pulses) + skip]

    n_own = jnp.sum(owned_lead).astype(jnp.int32)
    sentinel = jnp.int32(t_total)
    matched = (jnp.arange(max_pulses) < n_own) & (te_idx < sentinel)
    count = jnp.sum(matched).astype(jnp.int32)
    return _emit_batch(
        mag, phase_deg, sat_sample, noise_floor, toa_idx, te_idx, matched, count, w
    )


def block_transfer(
    mag: jax.Array,
    noise_floor: jax.Array,
    snr_threshold_db: float,
    trailing_threshold_db: Optional[float],
):
    """Whole-block latch transfer function ``(f(0), f(1))`` over ``mag``.

    Composing these across shards (exclusive prefix with
    :func:`compose_transfer`, identity ``(False, True)``) yields each block's
    ``entry_active`` — the cross-shard chaining used by
    ``parallel/pipeline.py``.
    """
    lead_thresh = noise_floor * 10.0 ** (snr_threshold_db / 10.0)
    if trailing_threshold_db is None:
        trail_thresh = lead_thresh
    else:
        trail_thresh = noise_floor * 10.0 ** (trailing_threshold_db / 10.0)
    a, b = hysteresis_fns(mag >= lead_thresh, mag <= trail_thresh)
    return a[..., -1], b[..., -1]


def _prep_streams(iq: jax.Array, saturation_level: float):
    mag = jnp.abs(iq)
    phase_deg = jnp.rad2deg(jnp.angle(iq))
    sat = (jnp.abs(iq.real) >= saturation_level) | (jnp.abs(iq.imag) >= saturation_level)
    return mag, phase_deg, sat


def _prep_streams_planes(yr: jax.Array, yi: jax.Array, saturation_level: float):
    """Detection streams from real/imag float planes (see
    ``dsp.channelizer.channelize_planes``)."""
    mag = jnp.sqrt(yr * yr + yi * yi)
    phase_deg = jnp.rad2deg(jnp.arctan2(yi, yr))
    sat = (jnp.abs(yr) >= saturation_level) | (jnp.abs(yi) >= saturation_level)
    return mag, phase_deg, sat


def _extract_wideband_from_streams(
    mag: jax.Array,
    phase_deg: jax.Array,
    sat: jax.Array,
    cfg: PdwConfig,
    noise_floor: jax.Array,
) -> PdwBatch:
    """Wideband extraction from precomputed (T,) detection streams — shared
    by the complex and the planes entry points."""
    return extract_pdws_core(
        mag,
        phase_deg,
        sat,
        noise_floor,
        snr_threshold_db=cfg.snr_threshold_db,
        trailing_threshold_db=cfg.trailing_threshold_db,
        saturation_level=cfg.saturation_level,
        max_pulses=cfg.max_pulses,
        max_pulse_samples=cfg.max_pulse_samples,
    )


def extract_pdws_planes(
    yr: jax.Array,
    yi: jax.Array,
    cfg: PdwConfig,
    noise_floor: Optional[jax.Array] = None,
) -> PdwBatch:
    """Wideband extraction from float planes (complex-free graph) — the
    same extraction as :func:`extract_pdws`."""
    mag, phase_deg, sat = _prep_streams_planes(yr, yi, cfg.saturation_level)
    if noise_floor is None:
        noise_floor = medians.median(mag)
    return _extract_wideband_from_streams(mag, phase_deg, sat, cfg, noise_floor)


def extract_pdws_channelized_streams(
    mag: jax.Array,
    phase_deg: jax.Array,
    sat: jax.Array,
    cfg: PdwConfig,
    noise_floor: Optional[jax.Array] = None,
    median_method: Optional[str] = None,
) -> PdwBatch:
    """Per-channel extraction from precomputed (T, M) detection streams:
    the latch, edge search and per-pulse statistics of
    :func:`extract_pdws_core`, vmapped over channels.  ``median_method``
    pins every median's method (None: the noise floor takes the backend's,
    the per-pulse medians sort)."""
    if noise_floor is None:
        noise_floor = medians.median(mag, axis=0, method=median_method)
    core = functools.partial(
        extract_pdws_core,
        snr_threshold_db=cfg.snr_threshold_db,
        trailing_threshold_db=cfg.trailing_threshold_db,
        saturation_level=cfg.saturation_level,
        max_pulses=cfg.max_pulses,
        max_pulse_samples=cfg.max_pulse_samples,
        median_method=median_method,
    )
    return jax.vmap(core, in_axes=(1, 1, 1, 0))(mag, phase_deg, sat, noise_floor)


@functools.partial(
    jax.jit,
    static_argnames=("snr_threshold_db", "max_pulses", "block"),
)
def _extract_event_core(
    mag: jax.Array,
    sat: jax.Array,
    noise_floor: jax.Array,
    *,
    snr_threshold_db: float,
    max_pulses: int,
    block: int = 512,
) -> PdwBatch:
    """Real-time event-mode wideband extraction — the C++ tracker's exact
    per-pulse statistics (``usrp_predict_event.cpp:300-343``), vectorized:

    * the hysteresis-free latch (lead and trail share one threshold,
      ``:290-291, :306, :317``) is **memoryless**: ``state[t] = mag[t] >
      thresh`` — no scan.  (The sequential reference differs only on
      samples exactly equal to the threshold, where its ``>=`` lead /
      ``<=`` trail checks toggle; a float32 measure-zero case.)
    * pulse amplitude is the **mean** magnitude over ``[toa, te)``
      (``amp += mag(jj); amp /= (jj - toa)``, ``:312, :325-330`` — the
      trailing-edge sample is excluded), NOT the offline median — so there
      is no per-pulse window bound at all: means come from two-level
      prefix sums (per-``block`` partial sums + one tiny cross-block
      cumsum), exact for any pulse length.
    * saturation is any flagged sample strictly inside the pulse
      (``:336-340``); no frequency is emitted (the C++ loop measures none).

    Dense compare/reduce + one contiguous block gather per (rank,
    quantity), no scatters.  f32 accumulation
    (the reference accumulates ``amp`` in double; the difference is below
    0.001 dB at dwell scales).  Returns sample-unit ``pw_sec`` and zero
    ``freq_offset_hz`` like the other cores; :func:`finalize_pdws` scales.
    """
    t_len = mag.shape[-1]
    pad = (-t_len) % block
    thresh = noise_floor * 10.0 ** (snr_threshold_db / 10.0)
    state = mag > thresh
    prev = jnp.concatenate([jnp.zeros((1,), bool), state[:-1]])
    lead = (state & ~prev).astype(jnp.float32)
    trail = (~state & prev).astype(jnp.float32)
    magp = jnp.pad(mag, (0, pad))
    satp = jnp.pad(sat, (0, pad)).astype(jnp.float32)
    lead = jnp.pad(lead, (0, pad))
    trail = jnp.pad(trail, (0, pad))
    # A pulse open at capture end is never emitted (no trailing edge fires;
    # the pad is all-below-threshold but `prev` ends at t_len-1, so a pad
    # trail edge would land at index >= t_len and is masked by `closed`).

    n_b = (t_len + pad) // block
    lead_b = lead.reshape(n_b, block)
    trail_b = trail.reshape(n_b, block)
    mag_b = magp.reshape(n_b, block)
    sat_b = satp.reshape(n_b, block)

    def rank_positions(bits_b):
        """Index of the r-th set bit (r = 1..max_pulses), ``t_len`` when
        absent — two-level: block-end cumsum compare + one partial block."""
        bcum = jnp.cumsum(jnp.sum(bits_b, axis=1))  # (n_b,) inclusive
        ranks = jnp.arange(1, max_pulses + 1, dtype=jnp.float32)
        full = jnp.sum(bcum[None, :] < ranks[:, None], axis=1).astype(jnp.int32)
        idx = jnp.minimum(full, n_b - 1)
        part = jax.vmap(
            lambda i: jax.lax.dynamic_index_in_dim(bits_b, i, 0, False)
        )(idx)  # (R, block)
        base = jnp.where(idx > 0, bcum[jnp.maximum(idx - 1, 0)], 0.0)
        lc = jnp.cumsum(part, axis=1)
        within = jnp.sum(lc < (ranks - base)[:, None], axis=1).astype(jnp.int32)
        return jnp.minimum(idx * block + within, t_len)

    toa_idx = rank_positions(lead_b)
    te_idx = rank_positions(trail_b)
    closed = (toa_idx < t_len) & (te_idx < t_len)
    count = jnp.minimum(jnp.sum(trail), max_pulses).astype(jnp.int32)
    valid = (jnp.arange(max_pulses) < count) & closed

    def prefix_at(vals_b, bsum_ex, p):
        """sum(vals[0:p]) via the block partials + one gathered block."""
        blk = jnp.minimum(p // block, n_b - 1)
        row = jax.lax.dynamic_index_in_dim(vals_b, blk, 0, False)
        within = (p - blk * block).astype(jnp.float32)
        pos = jax.lax.iota(jnp.float32, block)
        return bsum_ex[blk] + jnp.sum(jnp.where(pos < within, row, 0.0))

    def prefix_fn(vals_b):
        bsums = jnp.sum(vals_b, axis=1)
        bsum_ex = jnp.concatenate(
            [jnp.zeros((1,), jnp.float32), jnp.cumsum(bsums)[:-1]])
        return jax.vmap(functools.partial(prefix_at, vals_b, bsum_ex))

    safe_toa = jnp.minimum(toa_idx, t_len - 1)
    safe_te = jnp.minimum(te_idx, t_len - 1)
    s_mag = prefix_fn(mag_b)
    amp = (s_mag(safe_te) - s_mag(safe_toa)) / jnp.maximum(
        (safe_te - safe_toa).astype(jnp.float32), 1.0)
    s_sat = prefix_fn(sat_b)
    # Interior samples toa+1 .. te-1 (both edge samples excluded, :336-340).
    sat_cnt = s_sat(safe_te) - s_sat(jnp.minimum(safe_toa + 1, t_len - 1))
    snr = 10.0 * jnp.log10(amp / noise_floor)

    zero = jnp.zeros((), jnp.float32)
    return PdwBatch(
        toa_idx=jnp.where(valid, toa_idx, -1),
        te_idx=jnp.where(valid, te_idx, -1),
        pw_sec=jnp.where(valid, (te_idx - toa_idx).astype(jnp.float32), zero),
        mag=jnp.where(valid, amp, zero),
        snr_db=jnp.where(valid, snr, zero),
        freq_offset_hz=jnp.zeros((max_pulses,), jnp.float32),
        saturated=jnp.where(valid, sat_cnt > 0.5, False),
        valid=valid,
        count=count,
    )


def extract_pdws_event(
    iq: jax.Array,
    cfg: PdwConfig,
    noise_floor: Optional[jax.Array] = None,
) -> PdwBatch:
    """Wideband event-mode extraction from a complex capture: mean noise
    floor (``usrp_predict_event.cpp:288-289``) + :func:`_extract_event_core`
    mean-amplitude statistics.  The real-time tracker's extraction path."""
    mag = jnp.abs(iq)
    sat = ((jnp.abs(iq.real) >= cfg.saturation_level)
           | (jnp.abs(iq.imag) >= cfg.saturation_level))
    if noise_floor is None:
        noise_floor = jnp.mean(mag)
    return _extract_event_core(
        mag, sat, noise_floor,
        snr_threshold_db=cfg.snr_threshold_db, max_pulses=cfg.max_pulses,
    )


def extract_pdws_event_planes(
    yr: jax.Array,
    yi: jax.Array,
    cfg: PdwConfig,
    noise_floor: Optional[jax.Array] = None,
) -> PdwBatch:
    """Complex-free twin of :func:`extract_pdws_event` (float planes in)."""
    mag = jnp.sqrt(yr * yr + yi * yi)
    sat = ((jnp.abs(yr) >= cfg.saturation_level)
           | (jnp.abs(yi) >= cfg.saturation_level))
    if noise_floor is None:
        noise_floor = jnp.mean(mag)
    return _extract_event_core(
        mag, sat, noise_floor,
        snr_threshold_db=cfg.snr_threshold_db, max_pulses=cfg.max_pulses,
    )


def extract_pdws_channelized_planes(
    yr: jax.Array,
    yi: jax.Array,
    cfg: PdwConfig,
    noise_floor: Optional[jax.Array] = None,
) -> PdwBatch:
    """Per-channel extraction from (T, M) float planes (complex-free)."""
    mag, phase_deg, sat = _prep_streams_planes(yr, yi, cfg.saturation_level)
    return extract_pdws_channelized_streams(mag, phase_deg, sat, cfg, noise_floor)


def extract_pdws(
    iq: jax.Array,
    cfg: PdwConfig,
    noise_floor: Optional[jax.Array] = None,
) -> PdwBatch:
    """Wideband PDW extraction from a 1-D complex capture.

    ``pw_sec`` / ``freq_offset_hz`` in the returned batch are in units of
    samples and cycles-per-sample respectively; :func:`finalize_pdws` scales
    them by the true ``fs`` on the host (keeps the jitted core
    rate-agnostic).
    """
    mag, phase_deg, sat = _prep_streams(iq, cfg.saturation_level)
    if noise_floor is None:
        noise_floor = medians.median(mag)
    return _extract_wideband_from_streams(mag, phase_deg, sat, cfg, noise_floor)


def extract_pdws_channelized(
    chan_iq: jax.Array,
    cfg: PdwConfig,
    noise_floor: Optional[jax.Array] = None,
) -> PdwBatch:
    """Per-channel PDW extraction from a channelized (T, M) matrix.

    Noise floor is per channel (median over time, matching
    ``create_pdws_channelized.m:73``); detection runs independently per
    channel (vmapped).  Returned batch arrays have shape (M, max_pulses).
    """
    mag, phase_deg, sat = _prep_streams(chan_iq, cfg.saturation_level)
    return extract_pdws_channelized_streams(mag, phase_deg, sat, cfg, noise_floor)


def finalize_pdws(
    batch: PdwBatch,
    fs: float,
    fc: float = 0.0,
    sample_start_time: float = 0.0,
    bin_offsets_hz: Optional[np.ndarray] = None,
) -> dict:
    """Convert a (possibly channelized) PdwBatch to host float64 PDW arrays.

    Applies the MATLAB formulas exactly, in float64:
    ``toa = (i0+1)/fs + sampleStartTime`` (1-based index parity,
    ``create_pdws.m:67``), ``pw = (jj-toa)/fs``, ``freq = fc [+ bin] +
    fs*medPhaseDiff/360``.  For channelized batches pass
    ``bin_offsets_hz = center_frequencies(M, fs_original)`` and the
    decimated ``fs``; each channel's PDWs get its bin offset
    (``create_pdws_channelized.m:80,122``).

    Returns a dict of 1-D numpy arrays sorted by TOA:
    ``toa, freq, pw, mag, snr, sat, channel``.
    """
    toa_idx = np.asarray(batch.toa_idx, np.int64)
    te_idx = np.asarray(batch.te_idx, np.int64)
    valid = np.asarray(batch.valid, bool)
    mag = np.asarray(batch.mag, np.float64)
    snr = np.asarray(batch.snr_db, np.float64)
    foff = np.asarray(batch.freq_offset_hz, np.float64)
    sat = np.asarray(batch.saturated, bool)

    if toa_idx.ndim == 1:
        channel = np.zeros_like(toa_idx)
        bin_off = np.zeros(1)
    else:
        m = toa_idx.shape[0]
        channel = np.broadcast_to(np.arange(m)[:, None], toa_idx.shape)
        bin_off = np.zeros(m) if bin_offsets_hz is None else np.asarray(bin_offsets_hz, np.float64)

    sel = valid.ravel()
    ch = channel.ravel()[sel]
    i0 = toa_idx.ravel()[sel]
    i1 = te_idx.ravel()[sel]
    toa = (i0 + 1) / fs + sample_start_time
    pw = (i1 - i0) / fs
    freq = fc + bin_off[ch] + foff.ravel()[sel] * fs

    order = np.argsort(toa, kind="stable")
    return {
        "toa": toa[order],
        "freq": freq[order],
        "pw": pw[order],
        "mag": mag.ravel()[sel][order],
        "snr": snr.ravel()[sel][order],
        "sat": sat.ravel()[sel][order],
        "channel": ch[order],
    }
