"""Capture tier tests: emulated radio physics, gain search convergence, and
the closed-loop event tracker recovering the emitter's scan period."""

import numpy as np
import pytest

from sdr_channelizer_tpu.capture import (
    EmulatedRadio,
    EventTracker,
    find_max_unsaturated_gain,
)
from sdr_channelizer_tpu.config import GainSearchConfig


def test_radio_quantization_and_duty():
    r = EmulatedRadio(sample_rate_sps=2e6, tone_offset_hz=0.25e6,
                      pulse_width_sec=200e-6, pri_sec=1e-3,
                      gain_db=60.0, noise_db=-80.0)
    iq, t0 = r.receive(20000)
    assert t0 == 0.0
    mag = np.abs(iq)
    on = mag > 0.5
    assert 0.15 < on.mean() < 0.25
    # gain at reference -> amplitude ~1.0, int-quantized
    assert 0.95 < mag.max() <= np.sqrt(2)


def test_radio_timed_dwell_fast_forward():
    r = EmulatedRadio(sample_rate_sps=1e6, start_epoch=100.0)
    _, t0 = r.receive(1000)
    assert t0 == 100.0
    _, t1 = r.receive(1000, start_time=100.5)
    assert abs(t1 - 100.5) < 1e-9
    # requesting a past time just continues the stream
    _, t2 = r.receive(1000, start_time=100.0)
    assert t2 >= 100.5


def test_gain_search_converges_to_max_unsaturated():
    r = EmulatedRadio(sample_rate_sps=1e6, pulse_width_sec=100e-6,
                      pri_sec=500e-6, gain_db=66.0, noise_db=-300.0)
    final, history = find_max_unsaturated_gain(r, dwell_samples=2000,
                                               num_dwells=20)
    # amplitude 10^((g-60)/20); unsaturated needs < 0.98 -> g <= 59
    assert final == 59.0
    sats = [s for _, s in history]
    assert sats[:7] == [True] * 7 and not any(sats[7:])


def test_gain_search_no_signal_keeps_gain():
    r = EmulatedRadio(rel_amplitude=0.0, noise_db=-60.0, gain_db=40.0,
                      sample_rate_sps=1e6)
    final, history = find_max_unsaturated_gain(r, 1000, 5)
    assert final == 40.0 and not any(s for _, s in history)


@pytest.fixture(scope="module")
def tracked():
    """Run the closed loop against a scanning-beam emitter."""
    # The mean-magnitude noise floor (usrp_predict_event.cpp:288) only
    # leaves 20 dB of headroom when pulses are sparse: duty cycle must be
    # well under 1% or the pulses' own energy raises the floor past the
    # threshold.  0.2% duty here (10 us / 5 ms).
    period = 0.5
    r = EmulatedRadio(
        sample_rate_sps=1e6,
        tone_offset_hz=0.1e6,
        pulse_width_sec=10e-6,
        pri_sec=5e-3,
        gain_db=60.0,
        rel_amplitude=0.9,
        noise_db=-55.0,
        scan_period_sec=period,
        scan_phase_sec=0.1,
        scan_curvature_db_per_s2=2000.0,  # ~20 dB down at 100 ms off-peak
    )
    tr = EventTracker(radio=r, dwell_sec=0.08)
    reports = tr.run(60)
    return period, tr, reports


def test_tracker_recovers_scan_period(tracked):
    period, tr, reports = tracked
    assert len(tr.events) > 6
    ev = np.asarray(tr.events)
    # events land near k*period + 0.1 (allow a few ms: parabola fit on
    # noisy quantized SNRs)
    err = np.abs(((ev - 0.1 + period / 2) % period) - period / 2)
    assert np.median(err) < 0.02, ev
    # PRI estimate ~ one scan period (dwells that span a peak each yield an
    # event; consecutive distinct events differ by ~period)
    assert tr.next_event_time is not None


def test_tracker_schedules_dwell_at_predicted_peak(tracked):
    period, tr, reports = tracked
    scheduled = [rep for rep in reports if rep.next_event_time is not None]
    assert scheduled
    # once predicting, the next dwell starts at next_event - dwell/2
    for prev, cur in zip(reports, reports[1:]):
        if prev.next_event_time is not None:
            want = prev.next_event_time - tr.dwell_sec / 2
            if want >= cur.start_time - 1e-9:  # not already past
                assert abs(cur.start_time - want) < 1e-6
                break


def test_tracker_gain_feedback():
    # Note the 12-bit quantizer's asymmetric rails: +2047/2048 = 0.99951
    # never trips the 0.9999 test; only the -1.0 rail does — so the tone
    # must actually swing negative (not alias to DC).
    r = EmulatedRadio(sample_rate_sps=1e6, tone_offset_hz=0.13e6,
                      pulse_width_sec=100e-6,
                      pri_sec=1e-3, gain_db=66.0, noise_db=-300.0)
    tr = EventTracker(radio=r, dwell_sec=0.01)
    reports = tr.run(10)
    assert reports[0].saturated
    assert r.gain_db <= 59.0  # walked down out of saturation
    assert not reports[-1].saturated


def test_counters_wired_through_capture_loop():
    """Observability (SURVEY.md section 5.5): the structured counters are
    actually incremented by the radio / gain search / tracker."""
    from sdr_channelizer_tpu.utils.metrics import Counters

    r = EmulatedRadio(sample_rate_sps=1e6, tone_offset_hz=0.13e6,
                      pulse_width_sec=100e-6,
                      pri_sec=1e-3, gain_db=66.0, noise_db=-300.0)
    c = Counters()
    find_max_unsaturated_gain(r, 2000, 10, counters=c)
    assert c.get("dwells") == 10
    assert c.get("samples_received") == 20000
    assert c.get("saturation_events") == c.get("gain_decrements_db") == 7
    assert r.counters.get("dwells_received") == 10
    assert r.counters.get("samples_received") == 20000
    assert r.counters.get("saturated_samples") > 0

    # Sparse emitter: the mean-magnitude floor needs a low duty cycle for
    # pulses to clear the 20 dB threshold (see the `tracked` fixture note).
    r2 = EmulatedRadio(sample_rate_sps=1e6, tone_offset_hz=0.13e6,
                       pulse_width_sec=10e-6, pri_sec=10e-3, gain_db=60.0,
                       rel_amplitude=0.9, noise_db=-55.0)
    tr = EventTracker(radio=r2, dwell_sec=0.05)
    tr.run(5)
    assert tr.counters.get("dwells") == 5
    assert tr.counters.get("samples_ingested") == 5 * 50000
    assert tr.counters.get("pulses_emitted") > 0
    snap = tr.counters.snapshot()
    assert snap["counters"]["dwells"] == 5 and "uptime_sec" in snap


def test_radio_timed_dwell_counts_skip():
    r = EmulatedRadio(sample_rate_sps=1e6, start_epoch=100.0)
    r.receive(1000)
    r.receive(1000, start_time=100.5)  # fast-forward to t=+0.5s
    assert r.counters.get("samples_skipped") == 500000 - 1000


def test_device_dwell_emitter_matches_radio_physics():
    """The jitted on-device emitter reproduces the EmulatedRadio signal
    model (duty cycle, amplitude, scan envelope) and drives the tracker
    closed loop with zero host synthesis."""
    kw = dict(sample_rate_sps=1e6, tone_offset_hz=0.13e6,
              pulse_width_sec=10e-6, pri_sec=5e-3, gain_db=60.0,
              rel_amplitude=0.9, noise_db=-55.0,
              scan_period_sec=0.5, scan_phase_sec=0.1,
              scan_curvature_db_per_s2=2000.0)
    from sdr_channelizer_tpu.capture import DeviceDwellEmitter

    dev = DeviceDwellEmitter(**kw)
    host = EmulatedRadio(**kw)
    (xr, xi), t0 = dev.receive(80000, start_time=0.06)
    iq_h, t0_h = host.receive(80000, start_time=0.06)
    assert t0 == t0_h
    mag_d = np.hypot(np.asarray(xr), np.asarray(xi))
    mag_h = np.abs(iq_h)
    on_d, on_h = mag_d > 0.05, mag_h > 0.05
    assert abs(on_d.mean() - on_h.mean()) < 1e-3  # same duty cycle
    # same peak envelope near the scan event at t=0.1
    np.testing.assert_allclose(mag_d[on_d].max(), mag_h[on_h].max(),
                               rtol=0.05)
    # timed-dwell fast forward + counters behave like the host radio
    dev.receive(1000, start_time=1.0)
    assert dev.counters.get("samples_skipped") > 0

    tr = EventTracker(radio=DeviceDwellEmitter(**kw), dwell_sec=0.08)
    reports = tr.run(12)
    assert sum(r.num_pulses for r in reports) > 0
    assert len(tr.events) > 0  # dwells spanning the beam peak fit events


def test_tracker_drops_errored_dwells():
    """A DwellError from the radio (UHD timeout/overflow classes) must not
    kill the loop: the reference logs, counts, and keeps looping
    (usrp_predict_event.cpp / usrp_record_iq_12bit.cpp:201-227)."""
    from sdr_channelizer_tpu.capture.hardware import DwellError

    inner = EmulatedRadio(sample_rate_sps=1e6, tone_offset_hz=0.13e6,
                          pulse_width_sec=10e-6, pri_sec=5e-3, gain_db=60.0,
                          rel_amplitude=0.9, noise_db=-55.0)

    class Flaky:
        sample_rate_sps = inner.sample_rate_sps

        def __init__(self):
            self.calls = 0

        @property
        def gain_db(self):
            return inner.gain_db

        @gain_db.setter
        def gain_db(self, v):
            inner.gain_db = v

        def receive(self, n, start_time=None):
            self.calls += 1
            if self.calls == 2:
                raise DwellError("timeout", "ERROR_CODE_TIMEOUT: 0/%d" % n)
            return inner.receive(n, start_time=start_time)

    tr = EventTracker(radio=Flaky(), dwell_sec=0.02)
    reports = tr.run(4)
    assert len(reports) == 4  # the loop survived the errored dwell
    assert reports[1].num_pulses == 0
    c = tr.counters.snapshot()["counters"]
    assert c["dwell_errors_timeout"] == 1
    assert c["dwells"] == 4


def test_device_dwell_emitter_stress_scenes():
    """Tracker stress scenes:
    a second emitter at a distinct PRI interleaves with the scanned one,
    and an over-full-scale emitter trips the saturation -> gain-down
    ladder on the device-emitter drive (usrp_predict_event.cpp:210-218)."""
    from sdr_channelizer_tpu.capture import DeviceDwellEmitter

    base = dict(sample_rate_sps=1e6, tone_offset_hz=0.13e6,
                pulse_width_sec=10e-6, pri_sec=5e-3, gain_db=60.0,
                rel_amplitude=0.9, noise_db=-55.0,
                scan_period_sec=0.5, scan_phase_sec=0.1,
                scan_curvature_db_per_s2=2000.0)

    # Two-emitter scene: pulse count ~ dwell/pri1 + dwell/pri2.
    two = DeviceDwellEmitter(**base, tone2_offset_hz=-0.09e6,
                             pulse_width2_sec=15e-6, pri2_sec=3.3e-3,
                             rel_amplitude2=0.2)
    (xr, xi), _ = two.receive(100000, start_time=0.06)  # beam center
    mag = np.hypot(np.asarray(xr), np.asarray(xi))
    n_edges = int(np.sum((mag[1:] > 0.05) & (mag[:-1] <= 0.05)))
    assert abs(n_edges - (0.1 / 5e-3 + 0.1 / 3.3e-3)) <= 3, n_edges

    # Saturating scene: the tracker's gain ladder steps down until the
    # ADC unclips, and the saturation counter fires on the drive.
    sat = DeviceDwellEmitter(**{**base, "rel_amplitude": 2.0})
    tr = EventTracker(radio=sat, dwell_sec=0.08)
    tr.run(14)
    assert tr.counters.get("saturation_events") > 0
    assert sat.gain_db < 60.0  # the ladder actually stepped
    (xr, xi), _ = sat.receive(50000, start_time=tr.radio._abs_index / 1e6 + 0.1)
    # after the ladder settles near the beam peak the ADC no longer clips
