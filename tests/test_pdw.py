"""PDW extractor tests.

Oracle: a direct NumPy port of the reference's sequential edge-detector
loop (``create_pdws.m:51-105``), including its quirks (1-based TOA, the
trailing-edge sample included in medians, strict wrap inequalities,
saturation only strictly inside the pulse).  The vectorized extractor
must match it pulse-for-pulse.
"""

import numpy as np
import pytest

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.dsp import channelizer as chlib
from sdr_channelizer_tpu.dsp import pdw as pdwlib
from sdr_channelizer_tpu.signal import synth
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec


def matlab_pdw_oracle(iq, fs, fc, sample_start_time, lead_db, trail_db=None,
                      noise_floor=None, sat_level=0.9999):
    """Line-for-line port of the create_pdws.m loop semantics."""
    mag = np.abs(iq)
    phase = np.rad2deg(np.angle(iq))
    floor = np.median(mag) if noise_floor is None else noise_floor
    lead = floor * 10 ** (lead_db / 10)
    trail = lead if trail_db is None else floor * 10 ** (trail_db / 10)
    out = {k: [] for k in ("toa", "freq", "pw", "mag", "snr", "sat")}
    active = False
    saturated = False
    toa = 0
    for jj in range(len(iq)):
        if not active:
            if mag[jj] >= lead:
                active = True
                toa = jj
                saturated = False
        else:
            if mag[jj] <= trail:
                active = False
                out["toa"].append((toa + 1) / fs + sample_start_time)
                m = np.median(mag[toa : jj + 1])
                out["mag"].append(m)
                out["snr"].append(10 * np.log10(m / floor))
                out["pw"].append((jj - toa) / fs)
                d = np.diff(phase[toa : jj + 1])
                d = np.where(d < -180, d + 360, d)
                d = np.where(d > 180, d - 360, d)
                out["freq"].append(fc + fs * np.median(d) / 360 if len(d) else fc)
                out["sat"].append(saturated)
            else:
                if abs(iq[jj].real) >= sat_level or abs(iq[jj].imag) >= sat_level:
                    saturated = True
    return {k: np.asarray(v) for k, v in out.items()}


def _extract(iq, fs, fc=0.0, t0=0.0, cfg=None):
    cfg = cfg or PdwConfig.wideband(max_pulses=64, max_pulse_samples=2048)
    batch = pdwlib.extract_pdws(np.asarray(iq, np.complex64), cfg)
    return pdwlib.finalize_pdws(batch, fs=fs, fc=fc, sample_start_time=t0)


def _mk_noisy_train(seed=7, fs=1e6, f=120e3, pw=40e-6, pri=200e-6, dur=5e-3,
                    amp=1.0, noise=0.01):
    spec = PulseTrainSpec(
        sample_rate_sps=fs, duration_sec=dur, frequency_hz=f,
        pulse_width_sec=pw, pri_sec=pri, start_index=123,
        amplitude=amp, noise_std=noise,
    )
    return synth.pulse_train(spec, seed=seed), spec


class TestAgainstOracle:
    @pytest.mark.parametrize("trail_db", [3.0, None])
    def test_matches_matlab_loop(self, trail_db):
        iq, spec = _mk_noisy_train()
        fs, fc, t0 = 1e6, 5e6, 1700000000.0
        want = matlab_pdw_oracle(np.asarray(iq, np.complex128), fs, fc, t0,
                                 lead_db=18.0, trail_db=trail_db)
        cfg = PdwConfig(snr_threshold_db=18.0, trailing_threshold_db=trail_db,
                        max_pulses=64, max_pulse_samples=2048)
        batch = pdwlib.extract_pdws(np.asarray(iq, np.complex64), cfg)
        got = pdwlib.finalize_pdws(batch, fs=fs, fc=fc, sample_start_time=t0)

        assert len(got["toa"]) == len(want["toa"]) > 5
        np.testing.assert_allclose(got["toa"], want["toa"], rtol=0, atol=1e-9)
        np.testing.assert_allclose(got["pw"], want["pw"], atol=1e-12)
        np.testing.assert_allclose(got["mag"], want["mag"], rtol=1e-4)
        np.testing.assert_allclose(got["snr"], want["snr"], rtol=1e-3)
        np.testing.assert_allclose(got["freq"], want["freq"], rtol=1e-6)
        np.testing.assert_array_equal(got["sat"], want["sat"])

    def test_saturated_pulses_flagged(self):
        iq, spec = _mk_noisy_train(amp=1.0, noise=0.005)
        # amplitude 1.0 tones hit |I| ~ 1 at phase 0 -> saturated
        got = _extract(iq, 1e6)
        want = matlab_pdw_oracle(np.asarray(iq, np.complex128), 1e6, 0, 0, 18.0, 3.0)
        np.testing.assert_array_equal(got["sat"], want["sat"])
        assert got["sat"].any()

    def test_random_specs_match(self):
        for seed in range(4):
            spec = synth.random_pulse_train_spec(seed, sample_rate_sps=2e6,
                                                 duration_sec=20e-3)
            iq = synth.pulse_train(
                spec.__class__(**{**spec.__dict__, "amplitude": 0.7,
                                  "noise_std": 0.02}), seed=seed)
            want = matlab_pdw_oracle(np.asarray(iq, np.complex128),
                                     2e6, 0, 0, 18.0, 3.0)
            cfg = PdwConfig.wideband(max_pulses=256, max_pulse_samples=4096)
            got = pdwlib.finalize_pdws(
                pdwlib.extract_pdws(np.asarray(iq, np.complex64), cfg),
                fs=2e6)
            assert len(got["toa"]) == len(want["toa"])
            if len(want["toa"]):
                np.testing.assert_allclose(got["toa"], want["toa"], atol=1e-9)
                np.testing.assert_allclose(got["pw"], want["pw"], atol=1e-12)


class TestGroundTruth:
    def test_recovers_pw_pri_freq(self):
        fs, f, pw, pri = 1e6, 200e3, 50e-6, 250e-6
        iq, spec = _mk_noisy_train(fs=fs, f=f, pw=pw, pri=pri, noise=0.003,
                                   amp=0.8)
        got = _extract(iq, fs, fc=1e9)
        n_expected = len(synth.pulse_starts(spec))
        assert len(got["toa"]) == n_expected
        # PW within a couple samples
        np.testing.assert_allclose(got["pw"], pw, atol=3 / fs)
        # PRI from TOA diffs
        pris = np.diff(got["toa"])
        np.testing.assert_allclose(pris, pri, atol=3 / fs)
        # frequency from median phase diff
        np.testing.assert_allclose(got["freq"], 1e9 + f, rtol=0, atol=500.0)

    def test_open_pulse_at_end_not_emitted(self):
        mag = np.zeros(1000)
        mag[900:] = 1.0  # pulse never ends
        iq = mag.astype(np.complex64)
        got = _extract(iq + 0.001, 1e6,
                       cfg=PdwConfig.wideband(max_pulses=16,
                                              max_pulse_samples=256))
        assert len(got["toa"]) == 0

    def test_hysteresis_prevents_retrigger(self):
        # A mid-pulse dip that stays above the 3 dB trailing threshold but
        # below the 18 dB leading threshold must NOT split the pulse with
        # hysteresis; without hysteresis (trail = lead) it must split.
        floor = 0.01
        sig = floor * np.ones(4000)
        sig[1000:1200] = 1.0
        sig[1200:1300] = 0.05  # ~14 dB above floor: below lead, above trail
        sig[1300:1500] = 1.0
        iq = sig.astype(np.complex64)
        cfg_h = PdwConfig(snr_threshold_db=18.0, trailing_threshold_db=3.0,
                          max_pulses=16, max_pulse_samples=1024)
        cfg_n = PdwConfig(snr_threshold_db=18.0, trailing_threshold_db=None,
                          max_pulses=16, max_pulse_samples=1024)
        got_h = pdwlib.finalize_pdws(pdwlib.extract_pdws(iq, cfg_h), fs=1e6)
        got_n = pdwlib.finalize_pdws(pdwlib.extract_pdws(iq, cfg_n), fs=1e6)
        assert len(got_h["toa"]) == 1  # merged: ends only back at the floor
        np.testing.assert_allclose(got_h["pw"], (1500 - 1000) / 1e6)
        assert len(got_n["toa"]) == 2  # split at the dip

    def test_max_pulses_cap(self):
        # more pulses than max_pulses: emit the first max_pulses, don't crash
        fs = 1e6
        iq, spec = _mk_noisy_train(fs=fs, pw=20e-6, pri=100e-6, dur=10e-3)
        cfg = PdwConfig.wideband(max_pulses=8, max_pulse_samples=256)
        got = pdwlib.finalize_pdws(pdwlib.extract_pdws(
            np.asarray(iq, np.complex64), cfg), fs=fs)
        assert len(got["toa"]) == 8


class TestChannelized:
    def test_channelized_extraction_end_to_end(self):
        # generate -> channelize -> per-channel PDWs; recover the truth in
        # the right bin (create_pdws_channelized.m pipeline, minus its bugs)
        fs = 8e6
        m = 8
        f = 3e6 + 30e3
        spec = PulseTrainSpec(
            sample_rate_sps=fs, duration_sec=20e-3, frequency_hz=f,
            pulse_width_sec=100e-6, pri_sec=1000e-6, start_index=4000,
            amplitude=0.9, noise_std=0.001,
        )
        iq = synth.pulse_train(spec, seed=3)
        ch = chlib.Channelizer.create(m)
        y = ch(np.asarray(iq, np.complex64))
        cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=512)
        batch = pdwlib.extract_pdws_channelized(y, cfg)
        fs_dec = ch.decimated_rate(fs)
        got = pdwlib.finalize_pdws(
            batch, fs=fs_dec, fc=0.0, sample_start_time=0.0,
            bin_offsets_hz=ch.center_frequencies(fs),
        )
        n_expected = len(synth.pulse_starts(spec))
        cf = ch.center_frequencies(fs)
        k = int(np.argmin(np.abs(cf - f)))
        in_bin = got["channel"] == k
        assert in_bin.sum() == n_expected
        # PW is broadened by the prototype filter's rise/fall (up to
        # ~taps_per_band decimated samples at the 15 dB threshold)
        np.testing.assert_allclose(got["pw"][in_bin], 100e-6,
                                   atol=ch.taps_per_band / fs_dec)
        np.testing.assert_allclose(got["freq"][in_bin], f, atol=2e3)
        pris = np.diff(got["toa"][in_bin])
        np.testing.assert_allclose(pris, 1000e-6, atol=3 / fs_dec)


def test_hysteresis_scan_basic():
    ge = np.array([0, 1, 0, 0, 0, 1, 0, 0], bool)
    le = np.array([1, 0, 0, 1, 1, 0, 0, 1], bool)
    s = np.asarray(pdwlib.hysteresis_scan(ge, le))
    np.testing.assert_array_equal(s, [0, 1, 1, 0, 0, 1, 1, 0])


def test_hysteresis_scan_matches_sequential_random():
    rng = np.random.default_rng(1)
    for _ in range(5):
        mag = rng.random(997)
        lead, trail = 0.8, 0.3
        ge, le = mag >= lead, mag <= trail
        s = np.asarray(pdwlib.hysteresis_scan(ge, le))
        ref, active = [], False
        for j in range(len(mag)):
            if not active:
                if ge[j]:
                    active = True
            else:
                if le[j]:
                    active = False
            ref.append(active)
        np.testing.assert_array_equal(s, np.asarray(ref))


def test_count_clamped_to_capacity():
    """count never exceeds max_pulses (consumers sum counts across
    blocks/channels), with either median method."""
    import jax.numpy as jnp

    fs = 1e6
    iq, spec = _mk_noisy_train(fs=fs, pw=20e-6, pri=100e-6, dur=10e-3)
    cfg = PdwConfig.wideband(max_pulses=8, max_pulse_samples=256)
    for method in ("sort", "select"):
        iq_j = jnp.asarray(iq, jnp.complex64)
        mag, ph, sat = pdwlib._prep_streams(iq_j, cfg.saturation_level)
        batch = pdwlib.extract_pdws_core(
            mag, ph, sat, jnp.median(mag),
            snr_threshold_db=cfg.snr_threshold_db,
            trailing_threshold_db=cfg.trailing_threshold_db,
            saturation_level=cfg.saturation_level,
            max_pulses=cfg.max_pulses,
            max_pulse_samples=cfg.max_pulse_samples,
            median_method=method)
        assert int(np.asarray(batch.count)) == 8
        assert int(np.sum(np.asarray(batch.valid))) == 8
