"""sdr_channelizer_tpu — a wideband channelizer + pulse-detection framework.

A from-scratch JAX/XLA rebuild of the capabilities of the
``cwozny/sdr_channelizer`` reference (C++ bladeRF/USRP capture utilities +
MATLAB analysis chain):

* versioned ``IqPacket`` binary I/Q ingest (int8 / int12 / int16) — ``io``
* synthetic pulse / LFM / Barker-13 signal generators — ``signal``
* M-branch polyphase FIR filterbank + FFT (or DFT-matmul) channel
  extraction — ``ops``, ``dsp.channelizer``
* per-channel envelope detection and PDW (pulse-descriptor-word)
  extraction, vectorized with an associative-scan hysteresis latch —
  ``dsp.pdw``
* spectrogram/STFT rendering — ``dsp.spectrogram``
* quadratic-fit event prediction + closed-loop dwell scheduling —
  ``dsp.events``, ``capture.tracker``
* multi-device sharding over a 2-D (time × channel) mesh with overlap-save
  halo exchange and cross-block PDW merge — ``parallel``
* capture emulator + auto-gain search with the reference CLI contract —
  ``capture``, ``native/``

See SURVEY.md at the repo root for the structural analysis of the reference
this framework re-implements.
"""

__version__ = "0.1.0"

from sdr_channelizer_tpu import config as config  # noqa: F401
