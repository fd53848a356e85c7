"""Typed configuration for the whole framework.

The reference scatters its operating constants through the code (SNR
thresholds of 18/15/20 dB, 1 MHz / 0.1 MHz bin widths, 0.9999 / 0.98
saturation levels, 7-positional-arg capture CLI — see
reference ``matlab/create_pdws.m:45-47``, ``matlab/create_pdws_channelized.m:31,74``,
``matlab/predict_event.m:65``, ``cpp/usrp_predict_event.cpp:290``,
``cpp/blade_record_iq_12bit.cpp:33-48``).  Here every knob lives in one
dataclass tree with the reference's names and defaults preserved.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ChannelizerConfig:
    """Polyphase analysis filterbank configuration.

    Matches the semantics of MATLAB ``dsp.Channelizer(num_bands)`` as used by
    the reference (``matlab/create_pdws_channelized.m:31-33``,
    ``matlab/channelizer_example.m:29-31``): ``num_bands`` channels of width
    ``fs / num_bands``, a lowpass prototype with ``taps_per_band`` taps per
    polyphase branch and ``stopband_atten_db`` stopband attenuation
    (dsp.Channelizer defaults: 12 taps/band, 80 dB), outputs decimated to
    ``fs / num_bands`` and centered with ``fftshift`` along the channel axis.
    """

    num_bands: int
    taps_per_band: int = 12
    stopband_atten_db: float = 80.0

    @property
    def num_taps(self) -> int:
        return self.num_bands * self.taps_per_band


def bands_for_bin_width(sample_rate_sps: float, bin_width_hz: float = 1e6) -> int:
    """Number of channelizer bands for a target bin width.

    The reference uses ``M = fs*1e-6`` (1 MHz bins,
    ``create_pdws_channelized.m:31``) and ``round(fs/binWidth)`` for 0.1 MHz
    bins (``generate_channelized_training_iq.m:95-96``).
    """
    return int(round(sample_rate_sps / bin_width_hz))


@dataclasses.dataclass(frozen=True)
class PdwConfig:
    """Pulse-descriptor-word extraction configuration.

    Reference semantics (``matlab/create_pdws.m:41-105``):

    * noise floor = median magnitude ("resistant statistic")
    * leading edge:  mag >= floor * 10^(snr_threshold_db/10)
    * trailing edge: mag <= floor * 10^(trailing_threshold_db/10);
      ``trailing_threshold_db=None`` means no hysteresis (trailing threshold
      equals the leading threshold) as in the channelized extractor
      (``create_pdws_channelized.m:88-94``) and event mode
      (``predict_event.m:76-82``).
    * saturation flag: any |I| or |Q| >= saturation_level strictly inside
      the pulse (``create_pdws.m:100-102``)

    Default thresholds: 18 dB + 3 dB hysteresis (wideband), 15 dB
    (channelized), 20 dB (event mode) — see the named constructors.

    ``max_pulses`` / ``max_pulse_samples`` are static-shape bounds: the
    extractor emits at most ``max_pulses`` PDWs per (block, channel) and
    measures median statistics over at most ``max_pulse_samples`` samples of
    each pulse.  The reference loops have no such bound; pick bounds that
    exceed the physics (PW <= 1000 us at 56 Msps = 56000 samples wideband;
    56 samples per channel at 1 MHz bins).
    """

    snr_threshold_db: float = 18.0
    trailing_threshold_db: Optional[float] = 3.0
    saturation_level: float = 0.9999
    max_pulses: int = 512
    max_pulse_samples: int = 4096

    @classmethod
    def wideband(cls, **kw) -> "PdwConfig":
        """18 dB leading / 3 dB trailing (``create_pdws.m:45-47``)."""
        return cls(snr_threshold_db=18.0, trailing_threshold_db=3.0, **kw)

    @classmethod
    def channelized(cls, **kw) -> "PdwConfig":
        """15 dB, no hysteresis (``create_pdws_channelized.m:74``)."""
        return cls(snr_threshold_db=15.0, trailing_threshold_db=None, **kw)

    @classmethod
    def event(cls, **kw) -> "PdwConfig":
        """20 dB, no hysteresis (``predict_event.m:65-66``,
        ``usrp_predict_event.cpp:290``)."""
        return cls(snr_threshold_db=20.0, trailing_threshold_db=None, **kw)


@dataclasses.dataclass(frozen=True)
class EventConfig:
    """Event prediction configuration (``matlab/predict_event.m``).

    * quadratic fit of PDW SNR vs TOA; event time = parabola peak
      (``predict_event.m:125-130``; ``usrp_predict_event.cpp:28-52``)
    * next event = last event + median(diff(events)); bootstrap period used
      before >=2 events exist (``predict_event.m:134-138``)
    * a capture participates only if max |iq| > amplitude_gate
      (``predict_event.m:53``)
    * the real-time tracker requires min_pulses_for_fit pulses
      (``usrp_predict_event.cpp:348``) and min_events_for_pri events
      (``usrp_predict_event.cpp:354``)
    """

    amplitude_gate: float = 0.9
    bootstrap_period_sec: float = 4.61962892466417  # predict_event.m:137
    min_pulses_for_fit: int = 10  # usrp_predict_event.cpp:348
    min_events_for_pri: int = 5  # usrp_predict_event.cpp:354


@dataclasses.dataclass(frozen=True)
class CaptureConfig:
    """The reference recorders' 7-positional-argument CLI contract
    (``blade_record_iq_12bit.cpp:31-48``, ``usrp_record_iq_12bit.cpp:24-30``).
    """

    frequency_mhz: float
    bandwidth_mhz: float
    sample_rate_msps: float
    rx_gain_db: float
    dwell_sec: float
    duration_sec: float
    filter_delay_samples: int = 0
    bit_width: int = 12

    @property
    def sample_rate_sps(self) -> float:
        return self.sample_rate_msps * 1e6

    @property
    def dwell_samples(self) -> int:
        return int(round(self.dwell_sec * self.sample_rate_sps))


@dataclasses.dataclass(frozen=True)
class GainSearchConfig:
    """Max-unsaturated-gain search (``blade_find_max_unsaturated_gain.cpp``):
    receive a dwell, scan for any sample >= saturation_fraction * full scale,
    decrement gain by gain_step_db and repeat until duration elapses
    (``:227-274``)."""

    saturation_fraction: float = 0.98
    gain_step_db: float = 1.0


@dataclasses.dataclass(frozen=True)
class SpectrogramConfig:
    """STFT configuration matching ``spectrogram_my_iq.m:114``:
    hamming(768) symmetric window, zero overlap, squared-magnitude power,
    frequency axis centered on fc."""

    window_length: int = 768
    overlap: int = 0


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """2-D (time-blocks x channels) mesh layout for long captures.

    The reference is single-process/single-device (SURVEY.md section 5.7-5.8);
    this is the multi-device scale-out design: the sample axis is sharded into
    time blocks with overlap-save FIR halos exchanged between neighbors, the
    channel axis is sharded for PDW extraction, and boundary-straddling
    pulses are deduplicated by emitting each pulse from the shard that owns
    its leading edge (each shard reads ``pdw_halo_samples`` frames past its
    right boundary).
    """

    time_axis: str = "time"
    channel_axis: str = "chan"
    # Right-halo length (decimated frames) for cross-boundary pulse capture;
    # must be >= PdwConfig.max_pulse_samples for exact boundary stitching.
    pdw_halo_frames: int = 4096


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Top-level config for the channelize -> PDW -> predict pipeline."""

    channelizer: ChannelizerConfig
    pdw: PdwConfig = dataclasses.field(default_factory=PdwConfig.channelized)
    events: EventConfig = dataclasses.field(default_factory=EventConfig)
    sharding: ShardingConfig = dataclasses.field(default_factory=ShardingConfig)
