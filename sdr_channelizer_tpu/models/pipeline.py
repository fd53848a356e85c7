"""Flagship end-to-end pipelines (single-device; see ``parallel`` for the
sharded variants).

``ChannelizerPipeline`` compiles the reference's offline analysis chain
(``matlab/convert_my_iq_to_mat.m`` -> ``create_pdws_channelized.m``) into one
XLA program: dequantized capture in, channelized spectra + noise floors +
pulse descriptor words out.  ``WidebandPdwPipeline`` is the un-channelized
detector (``create_pdws.m``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.dsp import pdw as pdwmod
from sdr_channelizer_tpu.ops import ingest, medians
from sdr_channelizer_tpu.dsp.channelizer import Channelizer, channelize
from sdr_channelizer_tpu.dsp.pdw import PdwBatch


@dataclasses.dataclass
class ChannelizerPipeline:
    """Channelize -> per-band median noise floor -> PDW extraction.

    One jittable step; reuse the instance so the compiled program is cached
    per input length.
    """

    channelizer: Channelizer
    pdw_cfg: PdwConfig

    @classmethod
    def create(
        cls,
        num_bands: int,
        pdw_cfg: Optional[PdwConfig] = None,
        **chan_kwargs,
    ) -> "ChannelizerPipeline":
        return cls(
            channelizer=Channelizer.create(num_bands, **chan_kwargs),
            pdw_cfg=pdw_cfg or PdwConfig.channelized(),
        )

    def forward(self, x: jax.Array) -> Tuple[jax.Array, jax.Array, PdwBatch]:
        """The pure forward step (jit-compatible): capture -> (chan_iq,
        noise_floor, PdwBatch)."""
        y = channelize(x, self.channelizer)
        nf = medians.median(jnp.abs(y), axis=0)
        batch = pdwmod.extract_pdws_channelized(y, self.pdw_cfg, noise_floor=nf)
        return y, nf, batch

    def forward_reference(self, x: jax.Array) -> Tuple[jax.Array, PdwBatch]:
        """The plain reference of every device route: the graph of
        :meth:`forward` with its one platform-dependent choice pinned —
        FFT channel extraction and sort medians whatever the backend.
        Capture -> (noise_floor, PdwBatch)."""
        nf, _, batch = self._forward_streams(x, nf_method="sort")
        return nf, batch

    def forward_planes(
        self, xr: jax.Array, xi: jax.Array
    ) -> Tuple[jax.Array, jax.Array, jax.Array, PdwBatch]:
        """Complex-free forward step: float32 sample planes in, channelized
        planes + noise floor + PDWs out.  Same numbers as :meth:`forward`
        with the DFT extraction."""
        from sdr_channelizer_tpu.dsp.channelizer import channelize_planes

        yr, yi = channelize_planes(xr, xi, self.channelizer)
        mag, ph, sat = pdwmod._prep_streams_planes(
            yr, yi, self.pdw_cfg.saturation_level
        )
        nf = medians.median(mag, axis=0)
        batch = pdwmod.extract_pdws_channelized_streams(
            mag, ph, sat, self.pdw_cfg, noise_floor=nf
        )
        return yr, yi, nf, batch

    def _forward_streams(
        self, x: jax.Array, nf_method: Optional[str] = None
    ) -> Tuple[jax.Array, jax.Array, PdwBatch]:
        """Dequantized complex capture -> (noise_floor, mag, PdwBatch): the
        graph of :meth:`forward`, returning the (T, M) magnitude stream in
        place of the complex spectrum.  ``nf_method`` pins the noise
        floor's median method (None: ``ops.backend``)."""
        with jax.named_scope("channelize"):
            y = channelize(x, self.channelizer, method="fft")
        with jax.named_scope("streams"):
            mag, ph, sat = pdwmod._prep_streams(y, self.pdw_cfg.saturation_level)
        with jax.named_scope("noise_floor"):
            nf = medians.median(mag, axis=0, method=nf_method)
        batch = pdwmod.extract_pdws_channelized_streams(
            mag, ph, sat, self.pdw_cfg, noise_floor=nf)
        return nf, mag, batch

    def forward_fused(
        self, xr: jax.Array, xi: jax.Array, bit_width: int = 0
    ) -> Tuple[jax.Array, jax.Array, PdwBatch]:
        """I/Q sample planes -> (noise_floor, mag, PdwBatch).  ``xr``/``xi``
        are raw integer planes (dequantized on the device by
        ``2^-(bit_width-1)``) or, with ``bit_width=0``, float planes."""
        with jax.named_scope("ingest"):
            x = ingest.planes_complex(xr, xi, bit_width)
        return self._forward_streams(x)

    def forward_packed(
        self, xq: jax.Array, bit_width: int
    ) -> Tuple[jax.Array, jax.Array, PdwBatch]:
        """Like :meth:`forward_fused` but on the raw recorder payload:
        ``xq`` is the (N, 2) int16 I/Q buffer viewed as one int32 plane (or
        an int8 buffer viewed as int16) — on-disk bytes straight to the
        device, unpacked and dequantized there (``ops.ingest``)."""
        with jax.named_scope("ingest"):
            x = ingest.unpack_complex(xq, bit_width)
        return self._forward_streams(x)

    def __post_init__(self):
        self._jit_forward = jax.jit(self.forward)
        self._jit_forward_planes = jax.jit(self.forward_planes)
        self._jit_forward_fused = jax.jit(
            self.forward_fused, static_argnames=("bit_width",)
        )
        self._jit_forward_packed = jax.jit(
            self.forward_packed, static_argnames=("bit_width",)
        )

    def step(self, x: jax.Array) -> Tuple[jax.Array, jax.Array, PdwBatch]:
        return self._jit_forward(x)

    def step_planes(self, xr, xi):
        return self._jit_forward_planes(xr, xi)

    def step_fused(self, xr, xi, bit_width: int = 0):
        return self._jit_forward_fused(xr, xi, bit_width=bit_width)

    def step_packed(self, xq, bit_width: int):
        return self._jit_forward_packed(xq, bit_width=bit_width)

    def _finalize(self, batch: PdwBatch, fs: float, fc: float,
                  sample_start_time: float) -> dict:
        return pdwmod.finalize_pdws(
            batch,
            fs=fs / self.channelizer.num_bands,
            fc=fc,
            sample_start_time=sample_start_time,
            bin_offsets_hz=self.channelizer.center_frequencies(fs),
        )

    def extract_fused(
        self,
        samples: np.ndarray,
        bit_width: int,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        """Raw (N, 2) payload -> host PDW dict.

        int16 payloads go as the packed int32 plane and int8 payloads as
        the packed int16 plane (zero-copy views of the on-disk bytes);
        float payloads go as planes."""
        samples = np.ascontiguousarray(samples)
        if samples.dtype in (np.int16, np.int8):
            _, _, batch = self.step_packed(ingest.packed_view(samples),
                                           bit_width=bit_width)
        else:
            xr = np.ascontiguousarray(samples[:, 0])
            xi = np.ascontiguousarray(samples[:, 1])
            _, _, batch = self.step_fused(xr, xi, bit_width=bit_width)
        return self._finalize(batch, fs, fc, sample_start_time)

    def extract_planes(
        self,
        iq: np.ndarray,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        """Host complex capture -> host PDW dict via the complex-free graph
        (planes split on the host)."""
        xr = np.ascontiguousarray(np.real(iq), np.float32)
        xi = np.ascontiguousarray(np.imag(iq), np.float32)
        _, _, _, batch = self.step_planes(xr, xi)
        return self._finalize(batch, fs, fc, sample_start_time)

    def extract(
        self,
        x: jax.Array,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        """Capture -> host PDW dict (absolute TOAs in epoch seconds, absolute
        frequencies with per-bin offsets)."""
        _, _, batch = self.step(x)
        return self._finalize(batch, fs, fc, sample_start_time)


@dataclasses.dataclass
class WidebandPdwPipeline:
    """Full-rate PDW extraction, no channelizer (``create_pdws.m``): noise
    floor = median magnitude of the whole capture, 18 dB leading / 3 dB
    trailing hysteresis by default."""

    pdw_cfg: PdwConfig = dataclasses.field(default_factory=PdwConfig.wideband)

    def __post_init__(self):
        self._jit_forward = jax.jit(self.forward)

    def forward(self, x: jax.Array) -> Tuple[jax.Array, PdwBatch]:
        mag = jnp.abs(x)
        nf = medians.median(mag)
        batch = pdwmod.extract_pdws(x, self.pdw_cfg, noise_floor=nf)
        return nf, batch

    def step(self, x: jax.Array) -> Tuple[jax.Array, PdwBatch]:
        return self._jit_forward(x)

    def extract(
        self,
        x: jax.Array,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        _, batch = self.step(x)
        return pdwmod.finalize_pdws(
            batch, fs=fs, fc=fc, sample_start_time=sample_start_time
        )
