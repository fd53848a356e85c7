"""Spectrogram tests (hamming(768), zero overlap, centered power —
``spectrogram_my_iq.m:114`` semantics)."""

import numpy as np
import pytest

from sdr_channelizer_tpu.config import SpectrogramConfig
from sdr_channelizer_tpu.dsp import spectrogram as sg


def test_hamming_matches_matlab_definition():
    w = sg.hamming(8, dtype=np.float64)
    n = np.arange(8)
    want = 0.54 - 0.46 * np.cos(2 * np.pi * n / 7)
    np.testing.assert_allclose(w, want, rtol=1e-12)
    assert w[0] == pytest.approx(0.08)
    np.testing.assert_allclose(w, w[::-1])  # symmetric, not periodic


def test_tone_bin_and_power():
    fs = 768e3
    cfg = SpectrogramConfig()
    L = cfg.window_length
    k = 100  # tone exactly on bin k
    f = k * fs / L
    t = np.arange(L * 10) / fs
    x = np.exp(2j * np.pi * f * t).astype(np.complex64)
    p = np.asarray(sg.stft_power(x, cfg=cfg))
    assert p.shape == (10, L)
    _, faxis = sg.axes_for(10, fs, 0.0, cfg)
    peak_bin = int(np.argmax(p.mean(axis=0)))
    assert faxis[peak_bin] == pytest.approx(f)
    # coherent gain: |sum(w)|^2
    w = sg.hamming(L, np.float64)
    assert p[:, peak_bin].mean() == pytest.approx(np.sum(w) ** 2, rel=1e-3)


def test_freq_axis_includes_fc():
    _, f = sg.axes_for(1, 56e6, 2.4e9)
    assert f.min() == pytest.approx(2.4e9 - 28e6)
    assert f[len(f) // 2] == pytest.approx(2.4e9)


def test_save_png(tmp_path):
    fs = 768e3
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(768 * 5) + 1j * rng.standard_normal(768 * 5)).astype(
        np.complex64
    )
    p = np.asarray(sg.stft_power(x))
    out = tmp_path / "spec.png"
    sg.save_png(out, p, fs=fs, fc=1e9, title="test")
    data = out.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert len(data) > 1000


def test_stft_dft_matches_fft():
    """The complex-free DFT branch equals the FFT oracle."""
    import numpy as np
    import jax.numpy as jnp
    from sdr_channelizer_tpu.config import SpectrogramConfig
    from sdr_channelizer_tpu.dsp.spectrogram import stft_power

    rng = np.random.default_rng(0)
    iq = (rng.standard_normal(4096) + 1j * rng.standard_normal(4096)
          ).astype(np.complex64)
    cfg = SpectrogramConfig(window_length=256)
    a = np.asarray(stft_power(jnp.asarray(iq), cfg=cfg, method="fft"))
    b = np.asarray(stft_power(jnp.asarray(iq), cfg=cfg, method="dft"))
    np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-4)


def test_stft_power_packed_matches_float_path():
    """Packed int16/int8 ingest (device-side dequant) equals stft_power over
    the host-dequantized capture (spectrogram_my_iq.m:92-98 normalization)."""
    import jax.numpy as jnp

    from sdr_channelizer_tpu.io import iqpacket

    rng = np.random.default_rng(3)
    n = 1024 * 4
    iq = (0.4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    cfg = SpectrogramConfig(window_length=256)
    for bit_width, view in ((12, np.int32), (8, np.int16)):
        samples = iqpacket.from_complex(iq, bit_width)
        packed = np.ascontiguousarray(samples).view(view).ravel()
        got = np.asarray(sg.stft_power_packed(
            jnp.asarray(packed), bit_width, cfg=cfg))
        deq = iqpacket.to_complex(samples, bit_width)
        want = np.asarray(sg.stft_power(jnp.asarray(deq), cfg=cfg,
                                        method="dft"))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
