"""Device-side payload dequantization (``ops.ingest``) and the pipeline
entry points that take the raw recorder payload."""

import jax.numpy as jnp
import numpy as np
import pytest

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline
from sdr_channelizer_tpu.ops import ingest
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train

M = 8
FS = 8e6
CFG = PdwConfig.channelized(max_pulses=64, max_pulse_samples=128)


def _payload(bit_width: int, n_frames: int = 512) -> np.ndarray:
    n = n_frames * M
    spec = PulseTrainSpec(sample_rate_sps=FS, duration_sec=n / FS,
                          frequency_hz=1.02e6, pulse_width_sec=40e-6,
                          pri_sec=110e-6, start_index=37)
    rng = np.random.default_rng(bit_width)
    iq = pulse_train(spec) + 1e-3 * (rng.standard_normal(n)
                                     + 1j * rng.standard_normal(n))
    return np.ascontiguousarray(
        iqpacket.from_complex(iq.astype(np.complex64), bit_width)[:n])


@pytest.mark.parametrize("bit_width", [12, 16, 8])
def test_unpack_matches_host_dequant(bit_width):
    """Shift sign extension + Q-format scale on the device equal the host
    ``to_complex`` bit for bit, over the full integer range."""
    dt = np.int8 if bit_width <= 8 else np.int16
    info = np.iinfo(dt)
    rng = np.random.default_rng(bit_width)
    samples = rng.integers(info.min, info.max + 1, (4096, 2)).astype(dt)
    samples[:4] = [[info.min, info.max], [info.max, info.min], [0, -1],
                   [-1, 0]]
    xq = jnp.asarray(ingest.packed_view(samples))
    got = np.asarray(ingest.unpack_complex(xq, bit_width))
    np.testing.assert_array_equal(got, iqpacket.to_complex(samples, bit_width))
    xr, xi = (np.asarray(v) for v in ingest.unpack_planes(xq, bit_width))
    np.testing.assert_array_equal(xr + 1j * xi, got)


def _assert_batches_equal(a, b):
    for name in ("toa_idx", "te_idx", "pw_sec", "mag", "snr_db",
                 "freq_offset_hz", "saturated", "valid", "count"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name)),
                                      np.asarray(getattr(b, name)),
                                      err_msg=name)


@pytest.mark.parametrize("bit_width", [12, 8])
def test_forward_packed_matches_complex_forward(bit_width):
    """The payload entry point is the complex forward graph behind a
    device dequant: equal noise floor, magnitude stream and PDWs."""
    samples = _payload(bit_width)
    pipe = ChannelizerPipeline.create(M, pdw_cfg=CFG)
    nf, mag, batch = pipe.step_packed(
        jnp.asarray(ingest.packed_view(samples)), bit_width=bit_width)
    x = jnp.asarray(iqpacket.to_complex(samples, bit_width))
    nf_c, mag_c, batch_c = pipe._jit_forward_fused(
        jnp.real(x), jnp.imag(x), bit_width=0)
    np.testing.assert_array_equal(np.asarray(nf), np.asarray(nf_c))
    np.testing.assert_array_equal(np.asarray(mag), np.asarray(mag_c))
    _assert_batches_equal(batch, batch_c)
    assert int(np.sum(np.asarray(batch.count))) > 10


@pytest.mark.parametrize("bit_width", [12, 8])
def test_forward_fused_int_planes_match_packed(bit_width):
    """Integer I/Q planes with ``bit_width`` and the packed payload are
    the same capture: identical PDWs through ``extract_fused``."""
    samples = _payload(bit_width)
    pipe = ChannelizerPipeline.create(M, pdw_cfg=CFG)
    got = pipe.extract_fused(samples.astype(np.float32), bit_width=bit_width,
                             fs=FS, fc=1e9)
    ref = pipe.extract_fused(samples, bit_width=bit_width, fs=FS, fc=1e9)
    assert len(ref["toa"]) > 10
    for key in ref:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)


def test_packed_view_rejects_non_integer_payload():
    with pytest.raises(ValueError, match="int16 or int8"):
        ingest.packed_view(np.zeros((8, 2), np.float32))


def test_unpack_rejects_unpacked_dtype():
    with pytest.raises(ValueError, match="int32 or int16"):
        ingest.unpack_planes(jnp.zeros(8, jnp.float32), 12)
