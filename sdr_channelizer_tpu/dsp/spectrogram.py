"""Spectrogram / STFT rendering (``matlab/spectrogram_my_iq.m:114-129``).

Reference configuration: ``stft(iq, fs, 'Window', hamming(768),
'OverlapLength', 0)`` — symmetric Hamming window, zero overlap, squared
magnitude power, frequency axis centered on the tuned frequency
(``y = (f + fc) MHz``), one PNG per capture.

Zero overlap means the STFT is a plain reshape -> window -> DFT: an FFT,
or a windowed matmul with the window folded into the DFT matrix
(``method``).  :func:`stft_power_packed` takes the
raw recorder payload (packed int16/int8 I/Q pairs) so the dequantization
happens on device, not on the host — the same packed ingest contract as
the PDW pipeline (``models/pipeline.py:extract_fused``).
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sdr_channelizer_tpu.config import SpectrogramConfig
from sdr_channelizer_tpu.ops.ingest import unpack_planes


def hamming(length: int, dtype=np.float32) -> np.ndarray:
    """Symmetric Hamming window, MATLAB ``hamming(L)`` semantics."""
    n = np.arange(length, dtype=np.float64)
    w = 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (length - 1))
    return w.astype(dtype)


def stft_power(
    iq: jax.Array,
    window: Optional[jax.Array] = None,
    cfg: SpectrogramConfig = SpectrogramConfig(),
    method: str = "fft",
) -> jax.Array:
    """Squared-magnitude STFT with zero overlap.

    Returns ``(num_frames, window_length)`` float32 power, frequency axis in
    FFT-shifted (ascending, DC-centered) order to match the reference's
    'centered' display.  ``method`` follows
    :func:`dsp.channelizer.extract_channels`; ``"dft"`` computes the DFT as
    a windowed matmul (window folded into the DFT matrix).
    """
    w = jnp.asarray(hamming(cfg.window_length) if window is None else window)
    length = w.shape[0]
    frames = iq.shape[-1] // length
    x = iq[..., : frames * length].reshape(*iq.shape[:-1], frames, length)
    if method == "dft":
        return _windowed_dft_power_planes(
            jnp.real(x).astype(jnp.float32), jnp.imag(x).astype(jnp.float32),
            length, np.asarray(w))
    spec = jnp.fft.fftshift(jnp.fft.fft(x * w, axis=-1), axes=-1)
    return jnp.square(jnp.abs(spec)).astype(jnp.float32)


def _windowed_dft_power_planes(
    xr: jax.Array, xi: jax.Array, length: int, window: np.ndarray
) -> jax.Array:
    """(frames, L) planes -> squared-magnitude DFT power, window folded into
    the DFT matrix (four real matmuls at ``precision=HIGHEST``)."""
    from sdr_channelizer_tpu.dsp.channelizer import dft_matrix

    wm = np.asarray(dft_matrix(length, shifted=True)) * window[:, None]
    wr = jnp.asarray(np.real(wm).astype(np.float32))
    wi = jnp.asarray(np.imag(wm).astype(np.float32))
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    sr = mm(xr, wr) - mm(xi, wi)
    si = mm(xr, wi) + mm(xi, wr)
    return (sr * sr + si * si).astype(jnp.float32)


def stft_power_packed(
    xq: jax.Array,
    bit_width: int,
    window: Optional[jax.Array] = None,
    cfg: SpectrogramConfig = SpectrogramConfig(),
) -> jax.Array:
    """Packed-ingest spectrogram: raw recorder payload in, power mesh out.

    ``xq`` packs one interleaved (I, Q) pair per element — int32 for int16
    payloads (``samples.view(np.int32)``), int16 for int8 payloads — the
    same device ingest as ``extract_fused``; sign extension and the
    ``2^-(bit_width-1)`` Q-format dequant run on device (no host float
    conversion).  Same values as :func:`stft_power` over the dequantized
    capture (``spectrogram_my_iq.m:92-98,114`` ingest + STFT semantics).
    """
    w = np.asarray(hamming(cfg.window_length) if window is None else window)
    length = w.shape[0]
    frames = xq.shape[-1] // length
    x = xq[..., : frames * length].reshape(*xq.shape[:-1], frames, length)
    xr, xi = unpack_planes(x, bit_width)
    return _windowed_dft_power_planes(xr, xi, length, w)


def axes_for(
    num_frames: int, fs: float, fc: float, cfg: SpectrogramConfig = SpectrogramConfig()
) -> Tuple[np.ndarray, np.ndarray]:
    """(time_sec, freq_hz) axes; freq absolute (f + fc) ascending, as in
    ``spectrogram_my_iq.m:118-123``."""
    t = np.arange(num_frames) * cfg.window_length / fs
    f = np.fft.fftshift(np.fft.fftfreq(cfg.window_length)) * fs + fc
    return t, f


def save_png(
    path,
    power: np.ndarray,
    fs: float,
    fc: float = 0.0,
    cfg: SpectrogramConfig = SpectrogramConfig(),
    db_floor: float = -120.0,
    title: Optional[str] = None,
) -> None:
    """Render the power mesh to a PNG (parity with the reference's per-file
    PNG export, ``spectrogram_my_iq.m:129``)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    power = np.asarray(power)
    t, f = axes_for(power.shape[0], fs, fc, cfg)
    db = 10.0 * np.log10(np.maximum(power, 10.0 ** (db_floor / 10.0)))
    fig, ax = plt.subplots(figsize=(10, 6), dpi=100)
    im = ax.pcolormesh(
        f * 1e-6, t * 1e3, db, shading="nearest", cmap="viridis", rasterized=True
    )
    ax.set_xlabel("Frequency (MHz)")
    ax.set_ylabel("Time (ms)")
    if title:
        ax.set_title(title)
    fig.colorbar(im, ax=ax, label="Power (dB)")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
