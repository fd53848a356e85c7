"""Capture tier: emulated radio front-end, auto-gain search, closed-loop
event tracker, and wrappers for the native recorder binaries.

The reference's capture tier is hardware-bound C++ (bladeRF/UHD recorders,
gain search, the real-time ``usrp_predict_event`` tracker — SURVEY.md
section 2 #3-#10).  Here the same control loops run against an emulated
receiver (host-side NumPy, or the native ``sdr_record_emulator`` binary for
file-producing captures), with the DSP on the accelerator; the real-hardware backends
(``capture.hardware``: :class:`UhdRadio`, :class:`BladeRadio`) implement
the same :class:`~sdr_channelizer_tpu.capture.hardware.Receiver` protocol
behind import-guarded vendor drivers.
"""

from sdr_channelizer_tpu.capture.emulator import (  # noqa: F401
    DeviceDwellEmitter,
    EmulatedRadio,
    NativeEmulator,
)
from sdr_channelizer_tpu.capture.gain_search import find_max_unsaturated_gain  # noqa: F401
from sdr_channelizer_tpu.capture.hardware import (  # noqa: F401
    BladeRadio,
    Receiver,
    UhdRadio,
    provision_bladerf,
)
from sdr_channelizer_tpu.capture.tracker import EventTracker  # noqa: F401
