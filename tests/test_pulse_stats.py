"""Per-pulse statistics (``dsp.pdw._emit_batch``: gathered windows +
masked medians) against a numpy per-pulse loop over the reference's
definitions (``create_pdws.m:70-102``): median magnitude over ``toa..te``
inclusive, median once-wrapped phase difference over ``toa..te-1``,
saturation strictly inside the pulse; windows clamp at
``max_pulse_samples``."""

import jax.numpy as jnp
import numpy as np
import pytest

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.dsp import pdw as pdwmod


def _numpy_stats(mag, ph, sat, toa, te, w):
    dph = np.diff(ph)
    dph = np.where(dph < -180.0, dph + 360.0, dph)
    dph = np.where(dph > 180.0, dph - 360.0, dph).astype(np.float32)
    out = []
    for i0, i1 in zip(toa, te):
        plen = min(i1 - i0 + 1, w)
        med_mag = np.median(mag[i0:i0 + plen])
        d = dph[i0:i0 + plen - 1]
        med_dph = np.median(d) if len(d) else np.nan
        s = bool(np.any(sat[i0 + 1:i0 + plen - 1]))
        out.append((med_mag, med_dph, s))
    return out


def _case(seed, t_len=4096, n_pulses=40, w=256):
    rng = np.random.default_rng(seed)
    mag = np.abs(rng.standard_normal(t_len)).astype(np.float32)
    ph = rng.uniform(-180.0, 180.0, t_len).astype(np.float32)
    sat = rng.random(t_len) < 0.05
    starts = np.sort(rng.choice(t_len - 2 * w, n_pulses, replace=False))
    lens = rng.integers(0, w + 40, n_pulses)  # some past the window
    lens[:4] = [0, 1, 2, 3]                   # 1- to 4-sample pulses
    return mag, ph, sat, starts.astype(np.int32), (starts + lens).astype(np.int32)


def _emit(mag, ph, sat, toa, te, w, method):
    n = len(toa)
    valid = jnp.ones(n, bool)
    return pdwmod._emit_batch(
        jnp.asarray(mag), jnp.asarray(ph), jnp.asarray(sat), jnp.float32(0.5),
        jnp.asarray(toa), jnp.asarray(te), valid, jnp.int32(n), w, method)


@pytest.mark.parametrize("method", ["sort", "select"])
@pytest.mark.parametrize("seed", [0, 1])
def test_emit_batch_matches_numpy_loop(seed, method):
    w = 256
    mag, ph, sat, toa, te = _case(seed, w=w)
    b = _emit(mag, ph, sat, toa, te, w, method)
    want = _numpy_stats(mag, ph, sat, toa, te, w)
    np.testing.assert_array_equal(np.asarray(b.mag), [s[0] for s in want])
    np.testing.assert_array_equal(
        np.asarray(b.freq_offset_hz),
        np.float32([s[1] for s in want]) / np.float32(360.0))
    np.testing.assert_array_equal(np.asarray(b.saturated), [s[2] for s in want])
    np.testing.assert_array_equal(np.asarray(b.pw_sec), (te - toa).astype(np.float32))
    np.testing.assert_allclose(np.asarray(b.snr_db),
                               10 * np.log10(np.float32([s[0] for s in want]) / 0.5),
                               rtol=1e-6)


def test_tiny_pulses_closed_form():
    """1- and 2-sample pulses: the median magnitude is the sample (or the
    mean of the two), the phase difference is the single diff (or NaN),
    and nothing is strictly inside."""
    mag = np.float32([1.0, 3.0, 7.0, 2.0, 5.0, 9.0])
    ph = np.float32([0.0, 10.0, -170.0, 170.0, 0.0, 0.0])
    sat = np.ones(6, bool)
    b = _emit(mag, ph, sat, np.int32([0, 2]), np.int32([0, 3]), 8, "sort")
    np.testing.assert_array_equal(np.asarray(b.mag), [1.0, 4.5])
    f = np.asarray(b.freq_offset_hz) * 360.0
    assert np.isnan(f[0])
    np.testing.assert_allclose(f[1], -20.0, rtol=1e-6)  # 340 wraps to -20
    np.testing.assert_array_equal(np.asarray(b.saturated), [False, False])


def test_long_pulse_window_clamps():
    """A pulse longer than ``max_pulse_samples`` takes its statistics over
    the first ``max_pulse_samples`` samples; its width stays exact."""
    w = 16
    mag = np.arange(64, dtype=np.float32)
    ph = np.zeros(64, np.float32)
    sat = np.zeros(64, bool)
    sat[30] = True  # past the window: not seen
    b = _emit(mag, ph, sat, np.int32([4]), np.int32([40]), w, "select")
    np.testing.assert_array_equal(np.asarray(b.mag), [np.median(mag[4:20])])
    np.testing.assert_array_equal(np.asarray(b.saturated), [False])
    np.testing.assert_array_equal(np.asarray(b.pw_sec), [36.0])


def test_short_capture_extracts():
    """Captures shorter than the statistics window still extract (the
    streams pad past the capture end)."""
    t = np.arange(100)
    iq = (0.001 * np.exp(1j * 0.3 * t)).astype(np.complex64)
    iq[20:40] *= 1000.0
    cfg = PdwConfig.wideband(max_pulses=4, max_pulse_samples=256)
    b = pdwmod.extract_pdws(jnp.asarray(iq), cfg)
    assert int(np.asarray(b.count)) == 1
    assert int(np.asarray(b.toa_idx)[0]) == 20
    assert int(np.asarray(b.te_idx)[0]) == 40
