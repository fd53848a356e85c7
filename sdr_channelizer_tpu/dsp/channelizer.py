"""Polyphase analysis channelizer — the framework's kernel layer (L4).

Re-implements the behavior of MATLAB ``dsp.Channelizer(M)`` as used by the
reference (``matlab/create_pdws_channelized.m:29-62``,
``matlab/channelizer_example.m:29-60``):

* input truncated to a multiple of M (``create_pdws_channelized.m:52-54``),
* output shape ``(N/M, M)`` — channel ``k`` is the band centered at
  ``k * fs / M`` (wrapped), downconverted to baseband and decimated to
  ``fs / M`` (``create_pdws_channelized.m:62``),
* ``fftshift`` along the channel axis centers DC
  (``create_pdws_channelized.m:60``) so columns align with the ascending
  :func:`center_frequencies`,
* zero initial filter state (MATLAB System-object semantics): the first
  ``P-1`` output rows carry the startup transient.

Derivation (frame convention — output row ``n`` consumes input frame ``n``
fully): channel ``k`` is defined by downconvert -> lowpass -> decimate,

    y_k[n] = v_k[nM + M - 1],   v_k = h * (x . e^{-j 2 pi k t / M})

Substituting ``m = pM + rho`` for the tap index and
``rho' = M - 1 - rho`` gives

    y[n, k] = sum_rho' e^{-j 2 pi k rho' / M} u[n, rho']
    u[n, rho'] = sum_p  Hr[p, rho'] F[n - p, rho']

with frames ``F[n, rho'] = x[nM + rho']`` and the frame-aligned polyphase
taps ``Hr[p, rho'] = h[pM + (M-1-rho')]``.  The channel extraction is a
plain forward DFT over branches: ``jnp.fft`` or, equivalently, one
``(T, M) @ (M, M)`` matmul with the shift folded into the matrix columns
(:func:`dft_matrix`).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sdr_channelizer_tpu.config import ChannelizerConfig
from sdr_channelizer_tpu.ops import filters


def center_frequencies(num_bands: int, sample_rate_sps: float) -> np.ndarray:
    """Ascending channel center frequencies, aligned with fftshifted output.

    Equivalent to MATLAB ``centerFrequencies(dsp.Channelizer(M), fs)`` as the
    reference consumes it: after ``fftshift(out, 2)`` column ``i`` is the
    band centered at ``center_frequencies(M, fs)[i]`` relative to the tuned
    center frequency (``create_pdws_channelized.m:60,80``).
    """
    return np.fft.fftshift(np.fft.fftfreq(num_bands)) * sample_rate_sps


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class ChannelizerState:
    """Carried streaming state: the last P frames of input (zeros at start)."""

    frames: jax.Array  # (P, M) complex64


@dataclasses.dataclass(frozen=True)
class Channelizer:
    """Configured polyphase channelizer.

    ``taps_rev`` is the frame-aligned polyphase matrix ``Hr`` (P, M) float32.
    """

    num_bands: int
    taps_per_band: int
    taps_rev: np.ndarray

    @classmethod
    def create(
        cls,
        num_bands: int,
        taps_per_band: int = 12,
        stopband_atten_db: float = 80.0,
        prototype: Optional[np.ndarray] = None,
    ) -> "Channelizer":
        if prototype is None:
            prototype = filters.design_prototype_filter(
                num_bands, taps_per_band, stopband_atten_db
            )
        hr = filters.reversed_polyphase(np.asarray(prototype, np.float64), num_bands)
        return cls(
            num_bands=num_bands,
            taps_per_band=hr.shape[0],
            taps_rev=hr.astype(np.float32),
        )

    @classmethod
    def from_config(cls, cfg: ChannelizerConfig) -> "Channelizer":
        return cls.create(cfg.num_bands, cfg.taps_per_band, cfg.stopband_atten_db)

    def init_state(self) -> ChannelizerState:
        p, m = self.taps_rev.shape
        return ChannelizerState(frames=jnp.zeros((p, m), jnp.complex64))

    def center_frequencies(self, sample_rate_sps: float) -> np.ndarray:
        return center_frequencies(self.num_bands, sample_rate_sps)

    def decimated_rate(self, sample_rate_sps: float) -> float:
        return sample_rate_sps / self.num_bands

    def __call__(self, x: jax.Array, shift: bool = True, method: str = "fft") -> jax.Array:
        return channelize(x, self, shift=shift, method=method)

    def stream_block(
        self,
        x_block: jax.Array,
        state: ChannelizerState,
        shift: bool = True,
        method: str = "fft",
    ) -> Tuple[jax.Array, ChannelizerState]:
        """Channelize one block carrying filter history across calls.

        Splitting a capture into blocks and folding with ``stream_block``
        produces bit-identical output to one :func:`channelize` call — the
        overlap-save contract the sharded path relies on.
        """
        return _channelize_block(
            x_block, state, jnp.asarray(self.taps_rev), self.num_bands, shift,
            method,
        )


def dft_extract(u: jax.Array, num_bands: int, shift: bool = True) -> jax.Array:
    """Channel extraction as a matmul: ``u @ W`` over the branch axis,
    equal to ``fftshift(fft(u))`` (``shift``) up to f32 rounding."""
    w = jnp.asarray(dft_matrix(num_bands, shifted=shift))
    return jnp.matmul(u, w, precision=jax.lax.Precision.HIGHEST)


def fft_extract(u: jax.Array, shift: bool = True) -> jax.Array:
    """Channel extraction by FFT over the branch axis."""
    y = jnp.fft.fft(u, axis=-1)
    return jnp.fft.fftshift(y, axes=-1) if shift else y


def extract_channels(u: jax.Array, num_bands: int, shift: bool = True,
                     method: str = "fft") -> jax.Array:
    """Branch outputs ``u`` (..., T, M) -> channels.

    ``method``: ``"fft"`` — ``jnp.fft.fft`` + ``fftshift``; the bit-parity
    oracle, and the faster of the two on the CPU and on the H100 (see
    ``ops.backend``).  ``"dft"`` — DFT-as-matmul with the shift folded into
    the matrix columns, at ``precision=HIGHEST`` (a default-precision f32
    matmul may run in TF32 on a GPU).
    """
    if method == "dft":
        return dft_extract(u, num_bands, shift)
    return fft_extract(u, shift)


def channelize(
    x: jax.Array, chan: Channelizer, shift: bool = True, method: str = "fft"
) -> jax.Array:
    """Channelize a 1-D complex capture. Returns ``(N // M, M)`` complex64."""
    m = chan.num_bands
    n_frames = x.shape[-1] // m
    x = x[..., : n_frames * m]
    frames = x.reshape(*x.shape[:-1], n_frames, m)
    hist = jnp.zeros((*x.shape[:-1], chan.taps_per_band, m), frames.dtype)
    u = _fir_branches(frames, hist, jnp.asarray(chan.taps_rev))
    return extract_channels(u, m, shift, method)


@functools.partial(jax.jit, static_argnames=("num_bands", "shift", "method"))
def _channelize_block(x_block, state, taps_rev, num_bands, shift, method="fft"):
    m = num_bands
    n_frames = x_block.shape[-1] // m
    frames = x_block[: n_frames * m].reshape(n_frames, m)
    u = _fir_branches(frames, state.frames, taps_rev)
    y = extract_channels(u, m, shift, method)
    p = taps_rev.shape[0]
    all_frames = jnp.concatenate([state.frames, frames], axis=0)
    new_state = ChannelizerState(frames=all_frames[-p:])
    return y, new_state


def _fir_branches(frames: jax.Array, history: jax.Array, taps_rev: jax.Array) -> jax.Array:
    """Polyphase branch FIR over frames (with P-frame history prefix).

    frames: (..., T, M); history: (..., P, M) — the P frames preceding
    ``frames`` (only the last P-1 are used; keeping P makes state handling
    uniform).  Returns the branch outputs ``u`` of shape (..., T, M); the
    channel outputs are the forward DFT of ``u`` along the last axis.
    """
    p, m = taps_rev.shape
    del m
    t = frames.shape[-2]
    if jnp.issubdtype(frames.dtype, jnp.inexact):
        ctype = frames.dtype  # complex stays complex; float planes stay float
    else:
        ctype = jnp.complex64
    if p > 1:
        padded = jnp.concatenate([history[..., -(p - 1) :, :], frames], axis=-2)
    else:
        padded = frames
    taps = taps_rev.astype(jnp.float32)
    # u[n, rho] = sum_p Hr[p, rho] * padded[n + (P-1) - p, rho]
    u = jnp.zeros(frames.shape, ctype)
    for pp in range(p):
        u = u + taps[pp] * jax.lax.dynamic_slice_in_dim(padded, p - 1 - pp, t, axis=-2)
    return u


def _fir_dft(frames: jax.Array, history: jax.Array, taps_rev: jax.Array) -> jax.Array:
    """Branch FIR + FFT channel extraction.  Returns (..., T, M) complex."""
    return jnp.fft.fft(_fir_branches(frames, history, taps_rev), axis=-1)


def channelize_planes(
    xr: jax.Array,
    xi: jax.Array,
    chan: Channelizer,
    shift: bool = True,
) -> Tuple[jax.Array, jax.Array]:
    """Channelize with no complex dtype anywhere in the graph.

    Runs the branch FIR on the real/imag float32 planes separately and the
    DFT as four real matmuls (``precision=HIGHEST``):

        yr = ur @ Wr - ui @ Wi,   yi = ur @ Wi + ui @ Wr

    Numerically identical to ``channelize(..., method="dft")`` (same op
    order per element).  Inputs ``xr, xi``: 1-D float32 sample planes;
    returns ``(yr, yi)`` of shape ``(N // M, M)``.
    """
    m = chan.num_bands
    n_frames = xr.shape[-1] // m
    fr = xr[..., : n_frames * m].reshape(n_frames, m).astype(jnp.float32)
    fi = xi[..., : n_frames * m].reshape(n_frames, m).astype(jnp.float32)
    hist = jnp.zeros((chan.taps_per_band, m), jnp.float32)
    taps = jnp.asarray(chan.taps_rev)
    ur = _fir_branches(fr, hist, taps)
    ui = _fir_branches(fi, hist, taps)
    w = dft_matrix(m, shifted=shift)
    wr = jnp.asarray(np.real(w).astype(np.float32))
    wi = jnp.asarray(np.imag(w).astype(np.float32))
    mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
    yr = mm(ur, wr) - mm(ui, wi)
    yi = mm(ur, wi) + mm(ui, wr)
    return yr, yi


def dft_matrix(num_bands: int, shifted: bool = True, dtype=np.complex64) -> np.ndarray:
    """Forward DFT matrix ``W[rho, k] = exp(-2j pi rho k / M)``.

    With ``shifted=True`` the columns are reordered so ``u @ W`` equals
    ``fftshift(fft(u), axes=-1)`` — channel ``i`` is the band at
    :func:`center_frequencies` ``[i]``.
    """
    m = int(num_bands)
    rho = np.arange(m)[:, None]
    k = np.arange(m)[None, :]
    w = np.exp(-2j * np.pi * rho * k / m)
    if shifted:
        w = w[:, np.fft.fftshift(np.arange(m))]
    return w.astype(dtype)
