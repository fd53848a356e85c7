"""DSP layer: channelizer, PDW extraction, event prediction, spectrogram,
and the streaming/blocking layer."""

from sdr_channelizer_tpu.dsp.channelizer import (  # noqa: F401
    Channelizer,
    channelize,
    center_frequencies,
    dft_matrix,
)
from sdr_channelizer_tpu.dsp.pdw import (  # noqa: F401
    PdwBatch,
    extract_pdws,
    extract_pdws_channelized,
    finalize_pdws,
)
from sdr_channelizer_tpu.dsp.events import (  # noqa: F401
    EventPredictor,
    next_event_time,
    quadratic_peak_time,
)
from sdr_channelizer_tpu.dsp.spectrogram import stft_power, hamming  # noqa: F401
from sdr_channelizer_tpu.dsp.streaming import (  # noqa: F401
    CaptureSet,
    Segment,
    StreamingExtractor,
)
