"""Channelizer correctness tests.

The oracle is a brute-force NumPy implementation of the defining equation
(downconvert -> lowpass -> decimate, frame convention):

    y_k[n] = (h * (x . e^{-j2pi k t/M}))[nM + M - 1]

which is independent of the polyphase/DFT factorization under test.
Behavioral contracts from the reference: output (N/M, M), fftshift centering,
decimated rate fs/M, truncation to a multiple of M
(``create_pdws_channelized.m:52-62``).
"""

import numpy as np
import pytest

from sdr_channelizer_tpu.dsp import channelizer as chlib
from sdr_channelizer_tpu.ops import filters
from sdr_channelizer_tpu.signal import synth
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec


def brute_force_channelize(x, m, h):
    """O(N*L*M) direct evaluation of the defining equation (no fftshift)."""
    t_frames = len(x) // m
    x = x[: t_frames * m]
    n_idx = np.arange(len(x))
    out = np.zeros((t_frames, m), dtype=np.complex128)
    for k in range(m):
        d = x * np.exp(-2j * np.pi * k * n_idx / m)
        v = np.convolve(d, h)  # full; v[t] = sum_m h[m] d[t-m]
        out[:, k] = v[np.arange(t_frames) * m + m - 1]
    return out


@pytest.mark.parametrize("m,p", [(8, 12), (5, 4), (16, 12), (7, 3)])
def test_matches_brute_force(m, p):
    rng = np.random.default_rng(42)
    n = m * 50
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    ch = chlib.Channelizer.create(m, taps_per_band=p)
    h = np.zeros(m * p)
    # reconstruct prototype from the stored reversed polyphase matrix
    h = ch.taps_rev[:, ::-1].reshape(-1).astype(np.float64)
    got = np.asarray(ch(x, shift=False))
    want = brute_force_channelize(np.asarray(x, np.complex128), m, h)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_fftshift_and_shape():
    m = 8
    ch = chlib.Channelizer.create(m)
    x = np.ones(m * 40, dtype=np.complex64)
    y = np.asarray(ch(x, shift=True))
    y_ns = np.asarray(ch(x, shift=False))
    assert y.shape == (40, m)
    np.testing.assert_allclose(y, np.fft.fftshift(y_ns, axes=-1), rtol=1e-6)


def test_truncates_to_multiple_of_m():
    m = 8
    ch = chlib.Channelizer.create(m)
    x = np.ones(m * 10 + 3, dtype=np.complex64)
    assert np.asarray(ch(x)).shape == (10, m)


def test_tone_lands_in_correct_channel():
    m = 16
    fs = 16e6
    ch = chlib.Channelizer.create(m)
    cf = ch.center_frequencies(fs)
    for k_off in [-7, -3, 0, 2, 5]:
        f = k_off * fs / m
        t = np.arange(m * 200) / fs
        x = np.exp(2j * np.pi * f * t).astype(np.complex64)
        y = np.asarray(ch(x, shift=True))
        steady = np.abs(y[ch.taps_per_band + 2 :])
        ch_idx = int(np.argmax(steady.mean(axis=0)))
        assert cf[ch_idx] == pytest.approx(f), f"tone {f} landed in {cf[ch_idx]}"
        # unit amplitude at channel center, ~unit DC gain prototype
        assert steady[:, ch_idx].mean() == pytest.approx(1.0, abs=0.02)


def test_adjacent_channel_rejection():
    m = 16
    fs = 16e6
    ch = chlib.Channelizer.create(m, taps_per_band=12, stopband_atten_db=80.0)
    cf = ch.center_frequencies(fs)
    k = 5  # tone at channel center
    f = cf[k]
    t = np.arange(m * 500) / fs
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    y = np.asarray(ch(x, shift=True))
    steady = np.abs(y[ch.taps_per_band + 2 :])
    sig = steady[:, k].mean()
    others = np.delete(steady, k, axis=1).max()
    # 80 dB design stopband; require >= 60 dB in float32
    assert 20 * np.log10(sig / others) > 60.0


def test_offset_tone_phase_slope():
    # Tone at channel center + df: decimated phase advances 2*pi*df/fs_dec.
    m = 8
    fs = 8e6
    df = 37e3
    ch = chlib.Channelizer.create(m)
    cf = ch.center_frequencies(fs)
    k = 6
    f = cf[k] + df
    t = np.arange(m * 400) / fs
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    y = np.asarray(ch(x, shift=True))
    fs_dec = ch.decimated_rate(fs)
    seg = y[ch.taps_per_band + 2 :, k]
    dphi = np.angle(seg[1:] * np.conj(seg[:-1]))
    est_df = np.median(dphi) * fs_dec / (2 * np.pi)
    assert est_df == pytest.approx(df, rel=1e-3)


def test_streaming_blocks_match_single_shot():
    m = 8
    ch = chlib.Channelizer.create(m)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(m * 64) + 1j * rng.standard_normal(m * 64)).astype(
        np.complex64
    )
    full = np.asarray(ch(x))
    state = ch.init_state()
    blocks = []
    for i in range(4):
        blk, state = ch.stream_block(x[i * m * 16 : (i + 1) * m * 16], state)
        blocks.append(np.asarray(blk))
    streamed = np.concatenate(blocks, axis=0)
    np.testing.assert_allclose(streamed, full, atol=1e-6)


def test_pulse_train_energy_in_right_bin():
    # End-to-end-ish: channelize a pulsed tone, energy should pulse in the
    # channel containing the tone (the create_pdws_channelized use case).
    fs = 8e6
    m = 8
    spec = PulseTrainSpec(
        sample_rate_sps=fs,
        duration_sec=2e-3,
        frequency_hz=3e6 + 40e3,
        pulse_width_sec=100e-6,
        pri_sec=400e-6,
        start_index=500,
    )
    x = synth.pulse_train(spec)
    ch = chlib.Channelizer.create(m)
    y = np.abs(np.asarray(ch(x, shift=True)))
    cf = ch.center_frequencies(fs)
    k = int(np.argmin(np.abs(cf - spec.frequency_hz)))
    # on/off contrast in the right channel
    col = y[:, k]
    assert col.max() > 0.8
    frac_on = (col > 0.5).mean()
    expected_duty = spec.pulse_width_sec / spec.pri_sec
    assert frac_on == pytest.approx(expected_duty, rel=0.3)


def test_prototype_filter_properties():
    h = filters.design_prototype_filter(16, 12, 80.0)
    assert len(h) == 192
    assert np.sum(h) == pytest.approx(1.0)
    # symmetric (linear phase)
    np.testing.assert_allclose(h, h[::-1], atol=1e-15)
    # stopband: response at >= 2x channel spacing down by >= 75 dB
    w = np.fft.rfftfreq(8192 * 4)
    H = np.abs(np.fft.rfft(h, 8192 * 4))
    stop = H[w >= 1.0 / 16]
    assert 20 * np.log10(stop.max() / H[0]) < -70.0


def test_fine_grained_560_bands():
    """The reference's fine-grained config: 0.1 MHz bins -> 560 bands at
    56 Msps (generate_channelized_training_iq.m:95-96)."""
    from sdr_channelizer_tpu.config import bands_for_bin_width

    m = bands_for_bin_width(56e6, 1e5)
    assert m == 560
    chan = chlib.Channelizer.create(m)
    assert chan.taps_rev.shape == (12, 560)
    # a tone at a bin center lands in exactly that bin
    n_frames = 64
    t = np.arange(m * n_frames)
    f0 = 37 * 1e5  # bin +37 (0.1 MHz bins)
    x = np.exp(2j * np.pi * f0 / 56e6 * t).astype(np.complex64)
    import jax.numpy as jnp
    y = np.asarray(chlib.channelize(jnp.asarray(x), chan))
    steady = np.abs(y[20:])
    assert steady.mean(axis=0).argmax() == m // 2 + 37


@pytest.mark.parametrize("method", ["fft", "dft"])
@pytest.mark.parametrize("m,n_frames", [(8, 256), (64, 300)])
def test_extraction_methods_match_brute_force(m, n_frames, method):
    """Both channel extractions ``ops.backend`` can pick (FFT, and the
    DFT matmul at HIGHEST precision) against the defining equation, with
    the fftshift centering, at production band counts."""
    rng = np.random.default_rng(m)
    n = m * n_frames
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)
    ch = chlib.Channelizer.create(m)
    h = ch.taps_rev[:, ::-1].reshape(-1).astype(np.float64)
    got = np.asarray(ch(x, shift=True, method=method))
    want = np.fft.fftshift(
        brute_force_channelize(np.asarray(x, np.complex128), m, h), axes=-1)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_dft_unshifted_matches_brute_force():
    m, n_frames = 8, 128
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(m * n_frames)
         + 1j * rng.standard_normal(m * n_frames)).astype(np.complex64)
    ch = chlib.Channelizer.create(m)
    h = ch.taps_rev[:, ::-1].reshape(-1).astype(np.float64)
    got = np.asarray(ch(x, shift=False, method="dft"))
    want = brute_force_channelize(np.asarray(x, np.complex128), m, h)
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_dft_path_matches_fft_path():
    """The DFT-matmul extraction equals the FFT extraction to f32
    rounding (the parity contract a TF32 matmul would break)."""
    import jax.numpy as jnp

    m, n_frames = 16, 512
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(m * n_frames)
         + 1j * rng.standard_normal(m * n_frames)).astype(np.complex64)
    ch = chlib.Channelizer.create(m)
    a = np.asarray(chlib.channelize(jnp.asarray(x), ch, method="fft"))
    b = np.asarray(chlib.channelize(jnp.asarray(x), ch, method="dft"))
    np.testing.assert_allclose(b, a, rtol=0, atol=2e-5 * np.max(np.abs(a)))


def test_every_dft_matmul_asks_for_highest_precision():
    """A default-precision f32 matmul may run in TF32 on a GPU; each DFT
    matmul of the channelizer, its planes twin and the spectrogram pins
    ``precision=HIGHEST`` in the traced program."""
    import jax
    import jax.numpy as jnp

    from sdr_channelizer_tpu.dsp import spectrogram

    m = 8
    ch = chlib.Channelizer.create(m)
    x = jnp.zeros(m * 32, jnp.complex64)
    xr = jnp.zeros(m * 32, jnp.float32)
    progs = [
        jax.make_jaxpr(lambda v: chlib.channelize(v, ch, method="dft"))(x),
        jax.make_jaxpr(lambda a, b: chlib.channelize_planes(a, b, ch))(xr, xr),
        jax.make_jaxpr(lambda a, b: spectrogram._windowed_dft_power_planes(
            a.reshape(-1, 16), b.reshape(-1, 16), 16,
            np.ones(16, np.float32)))(xr, xr),
    ]
    for prog in progs:
        text = str(prog)
        n_dots = text.count("dot_general")
        assert n_dots > 0
        assert text.count("Precision.HIGHEST") >= n_dots, text


@pytest.mark.parametrize("seed,t_len,m", [(0, 256, 8), (1, 768, 128),
                                          (2, 769, 60)])
def test_detection_streams_match_numpy(seed, t_len, m):
    """Magnitude, degrees phase, saturation flags and the once-wrapped
    phase difference (``create_pdws.m:84-85``) of the (T, M) streams the
    extractor consumes, against numpy."""
    import jax.numpy as jnp

    from sdr_channelizer_tpu.dsp import pdw as pdwmod

    rng = np.random.default_rng(seed)
    y = (rng.standard_normal((t_len, m))
         + 1j * rng.standard_normal((t_len, m))).astype(np.complex64)
    y[::7, 0] = 1.0 + 0.5j  # saturating samples
    mag, ph, sat = (np.asarray(v) for v in pdwmod._prep_streams(
        jnp.asarray(y), 0.9999))
    np.testing.assert_allclose(mag, np.abs(y), rtol=2e-7)
    np.testing.assert_allclose(ph, np.degrees(np.angle(y)), rtol=0,
                               atol=4e-5)
    np.testing.assert_array_equal(
        sat, (np.abs(y.real) >= 0.9999) | (np.abs(y.imag) >= 0.9999))
    dph = np.diff(ph.astype(np.float64), axis=0)
    dph = np.where(dph < -180, dph + 360, dph)
    dph = np.where(dph > 180, dph - 360, dph)
    assert np.all(np.abs(dph) <= 180)


def test_channelized_pipeline_recovers_ground_truth():
    """The full channelize -> noise floor -> PDW graph (payload ingest)
    recovers a pulse train's TOAs, widths and frequency."""
    from sdr_channelizer_tpu.config import PdwConfig
    from sdr_channelizer_tpu.io import iqpacket
    from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline

    m, fs = 8, 8e6
    spec = PulseTrainSpec(sample_rate_sps=fs, duration_sec=4e-3,
                          frequency_hz=2.0e6, pulse_width_sec=100e-6,
                          pri_sec=500e-6, start_index=1234, noise_std=3e-3)
    iq = synth.pulse_train(spec, seed=7).astype(np.complex64)
    n = len(iq) // m * m
    samples = iqpacket.from_complex(iq[:n], 12)
    pipe = ChannelizerPipeline.create(
        m, pdw_cfg=PdwConfig.channelized(max_pulses=32, max_pulse_samples=256))
    p = pipe.extract_fused(samples, bit_width=12, fs=fs, fc=1e9)
    sel = (p["snr"] > 25) & (np.abs(p["freq"] - 1e9 - 2.0e6) < fs / m / 2)
    starts = synth.pulse_starts(spec)
    starts = starts[starts + int(100e-6 * fs) < n]
    assert sel.sum() == len(starts)
    # within the prototype filter's group delay (M * taps / 2 samples)
    np.testing.assert_allclose(p["toa"][sel], (starts + 1) / fs,
                               atol=m * 12 / 2 / fs)
    # each edge spreads over the prototype's length (M * taps samples)
    np.testing.assert_allclose(p["pw"][sel], 100e-6, atol=m * 12 / fs)
