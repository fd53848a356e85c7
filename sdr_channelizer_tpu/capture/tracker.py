"""Closed-loop real-time event tracker — the JAX rebuild of the
reference's ``cpp/usrp_predict_event.cpp`` (its only native DSP, stale and
excluded from the reference build — SURVEY.md #9).

Per dwell (``usrp_predict_event.cpp:208-389``):

* saturation check on the raw samples -> gain down 1 dB (``:210-218``);
* noise floor = **mean** magnitude (not the offline median), 20 dB
  threshold (``:288-291``) — PDW extraction runs on-device through
  :func:`dsp.pdw.extract_pdws_event`, which reproduces the C++ loop's
  per-pulse statistics exactly: **mean** amplitude over the pulse
  (``:312, :325-330``), not the offline median — so extraction has no
  per-pulse window bound and needs no selection kernels (prefix sums);
* more than ``min_pulses_for_fit`` pulses -> quadratic least-squares fit of
  SNR vs TOA; the event is the parabola peak (``:28-52, :348-352``) — the
  fit runs ON DEVICE (``dsp.events.quadratic_peak_time_masked``) so the
  per-dwell packed fetch is the tracker's only host sync;
* more than ``min_events_for_pri`` events -> next event = last event +
  median of event diffs (``:354-373``);
* feedback: the next dwell is scheduled at ``next_event - dwell/2``
  (``:229-241``) so the beam peak lands mid-dwell.

The reference never writes these dwells out (the write is commented out,
``:382-385``); :class:`EventTracker` optionally does, one v3 ``.iq`` file
per dwell.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from sdr_channelizer_tpu.config import EventConfig, PdwConfig
from sdr_channelizer_tpu.dsp import events as eventsmod
from sdr_channelizer_tpu.dsp import pdw as pdwmod
from sdr_channelizer_tpu.utils.metrics import Counters
from sdr_channelizer_tpu.capture.hardware import DwellError


@dataclasses.dataclass
class DwellReport:
    """What one tracker step observed and decided."""

    start_time: float
    num_pulses: int
    saturated: bool
    gain_db: float
    event_time: Optional[float]
    next_event_time: Optional[float]


@dataclasses.dataclass
class EventTracker:
    """Drives a receiver, extracts PDWs on-device, fits events, schedules."""

    radio: object  # Receiver protocol: receive(n, start_time) + gain_db
    dwell_sec: float
    pdw_cfg: PdwConfig = dataclasses.field(default_factory=PdwConfig.event)
    event_cfg: EventConfig = dataclasses.field(default_factory=EventConfig)
    saturation_level: float = 0.9999  # usrp_predict_event.cpp:336
    events: List[float] = dataclasses.field(default_factory=list)
    next_event_time: Optional[float] = None
    # Observability (SURVEY.md section 5.5): dwell/pulse/saturation counters
    # replacing the reference's stdout prints (usrp_predict_event.cpp:311).
    counters: Counters = dataclasses.field(default_factory=Counters)

    def __post_init__(self):
        cfg = self.pdw_cfg
        fs = float(self.radio.sample_rate_sps)

        def _pack(batch, sat, event_rel):
            """One f32 array carrying everything the host loop needs —
            ONE device->host fetch per dwell (each fetch waits for the
            device and pays a transfer).
            Row 0 head: [count, saturated, event_time_rel]; rows 1-2:
            per-pulse TOA indices and SNRs (for reporting/offline use —
            the quadratic fit itself already ran on device)."""
            head = jnp.stack([
                batch.count.astype(jnp.float32),
                sat.astype(jnp.float32),
                event_rel.astype(jnp.float32),
            ])
            head = jnp.pad(head, (0, cfg.max_pulses - head.shape[0]))
            return jnp.stack([
                head,
                jnp.where(batch.valid, batch.toa_idx.astype(jnp.float32),
                          -1.0),
                batch.snr_db,
            ])

        def _extract_streams(mag, sat_mask):
            """Mean noise floor (:288-289) + the mean-amplitude event-mode
            extractor (the C++ tracker's exact per-pulse statistics,
            :300-343 — no per-pulse window bound) +
            the quadratic SNR-vs-TOA fit folded on device
            (:28-52, :348-352) so the packed fetch is the only sync."""
            noise_floor = jnp.mean(mag)
            batch = pdwmod._extract_event_core(
                mag, sat_mask, noise_floor,
                snr_threshold_db=cfg.snr_threshold_db,
                max_pulses=cfg.max_pulses,
            )
            toa_rel = (batch.toa_idx.astype(jnp.float32) + 1.0) / fs
            event_rel = eventsmod.quadratic_peak_time_masked(
                toa_rel, batch.snr_db, batch.valid)
            # Whole-dwell saturation trips the gain feedback; the C++ flag
            # is set on in-pulse samples only (:336-340), but a saturated
            # sample is >= 0.9999 full scale and therefore inside a pulse
            # region for any plausible threshold — same decisions.
            return _pack(batch, jnp.any(sat_mask), event_rel)

        @jax.jit
        def _extract(x):
            mag = jnp.abs(x)
            sat_mask = ((jnp.abs(x.real) >= self.saturation_level)
                        | (jnp.abs(x.imag) >= self.saturation_level))
            return _extract_streams(mag, sat_mask)

        @jax.jit
        def _extract_planes(xr, xi):
            # Device-resident (I, Q) planes (DeviceDwellEmitter).
            mag = jnp.sqrt(xr * xr + xi * xi)
            sat_mask = ((jnp.abs(xr) >= self.saturation_level)
                        | (jnp.abs(xi) >= self.saturation_level))
            return _extract_streams(mag, sat_mask)

        self._extract = _extract
        self._extract_planes = _extract_planes

    def step(self) -> DwellReport:
        fs = self.radio.sample_rate_sps
        dwell_n = int(round(self.dwell_sec * fs))
        start = None
        if self.next_event_time is not None:
            start = self.next_event_time - self.dwell_sec / 2  # :229-241
        try:
            iq, t0 = self.radio.receive(dwell_n, start_time=start)
        except DwellError as e:
            # The reference loop logs the error code, counts overruns, and
            # keeps looping — only whole dwells are processed
            # (usrp_predict_event.cpp / usrp_record_iq_12bit.cpp:201-227,
            # drop-don't-corrupt).  Skip this dwell, keep the schedule.
            self.counters.add("dwells")
            self.counters.add(f"dwell_errors_{e.code}")
            return DwellReport(
                start_time=start if start is not None else float("nan"),
                num_pulses=0, saturated=False,
                gain_db=float(self.radio.gain_db),
                event_time=None, next_event_time=self.next_event_time,
            )

        if isinstance(iq, tuple):
            # Device-resident planes (DeviceDwellEmitter): no host copy at
            # all — the packed fetch below is the dwell's only transfer.
            packed = self._extract_planes(*iq)
        else:
            packed = self._extract(jnp.asarray(iq))
        packed = np.asarray(packed)  # the dwell's single host sync
        n_pulses = int(packed[0, 0])
        sat = bool(packed[0, 1] > 0.5)
        self.counters.add("dwells")
        self.counters.add("samples_ingested", dwell_n)
        if sat:
            self.radio.gain_db -= 1.0  # :210-218
            self.counters.add("saturation_events")
            self.counters.add("gain_decrements_db")

        self.counters.add("pulses_emitted", n_pulses)
        event_t = None
        t_peak = float(packed[0, 2])  # fitted on device
        if n_pulses > self.event_cfg.min_pulses_for_fit:  # :348
            if np.isfinite(t_peak):
                event_t = t0 + t_peak
                self.events.append(event_t)
                self.counters.add("events_fitted")

        if len(self.events) > self.event_cfg.min_events_for_pri:  # :354
            diffs = np.diff(np.asarray(self.events))
            self.next_event_time = float(self.events[-1] + np.median(diffs))

        return DwellReport(
            start_time=t0,
            num_pulses=n_pulses,
            saturated=sat,
            gain_db=float(self.radio.gain_db),
            event_time=event_t,
            next_event_time=self.next_event_time,
        )

    def run(self, num_dwells: int) -> List[DwellReport]:
        return [self.step() for _ in range(num_dwells)]
