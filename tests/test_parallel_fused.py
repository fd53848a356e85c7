"""Sharded payload-ingest pipeline parity (virtual CPU mesh).

``ShardedPipeline.extract_fused`` / ``step_packed`` dequantize the raw
recorder payload on the devices and run the sharded channelize -> noise
floor -> PDW step (overlap-save FIR history over ``ppermute``) — the
multi-device composition of the single-device headline path
(``bench.py``).  These tests pin bit-identity against the single-device
pipeline, including pulses straddling shard boundaries and a pulse open at
capture end.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.dsp import pdw as pdwmod
from sdr_channelizer_tpu.dsp.channelizer import Channelizer
from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline
from sdr_channelizer_tpu.parallel import make_mesh
from sdr_channelizer_tpu.parallel.pipeline import (
    ShardedPipeline,
    merge_block_batches,
)
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train

M = 8
FS = 8e6
CFG = PdwConfig.channelized(max_pulses=64, max_pulse_samples=128)


def _capture(bit_width=12, n_frames=1024, seed=3) -> np.ndarray:
    """Quantized (N, 2) multi-emitter capture with pulses that straddle the
    4-way and 8-way shard boundaries of ``n_frames``."""
    n = n_frames * M
    dur = n / FS
    specs = [
        PulseTrainSpec(sample_rate_sps=FS, duration_sec=dur, frequency_hz=1.02e6,
                       pulse_width_sec=40e-6, pri_sec=110e-6, start_index=37),
        PulseTrainSpec(sample_rate_sps=FS, duration_sec=dur, frequency_hz=-2.97e6,
                       pulse_width_sec=80e-6, pri_sec=270e-6, start_index=803),
    ]
    rng = np.random.default_rng(seed)
    iq = sum(pulse_train(s) for s in specs)
    iq = iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return np.ascontiguousarray(iqpacket.from_complex(iq.astype(np.complex64),
                                                      bit_width)[:n])


def _sorted_pdws(d):
    order = np.lexsort((d["channel"], d["toa"]))
    return {k: np.asarray(v)[order] for k, v in d.items()}


def _assert_pdws_equal(got, ref, fs_dec=FS / M):
    got, ref = _sorted_pdws(got), _sorted_pdws(ref)
    assert len(got["toa"]) == len(ref["toa"]) > 10
    for key in ("toa", "pw", "mag", "sat", "channel"):
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
    # XLA's vectorized atan2 may round a phase sample differently by one
    # f32 ulp in two programs.  A phase difference then moves by two ulps
    # of 180 degrees, and its wrap by 360 degrees rounds once more: four
    # ulps of 180 degrees, in Hz at the decimated rate, bound freq.  log10
    # compile variance: a couple f32 ulps on snr.
    freq_atol = 4 * float(np.spacing(np.float32(180.0))) / 360.0 * fs_dec
    np.testing.assert_allclose(got["freq"], ref["freq"], rtol=0,
                               atol=freq_atol)
    np.testing.assert_allclose(got["snr"], ref["snr"], rtol=1e-9, atol=1e-5)


@pytest.mark.parametrize("n_time", [4, 8])
def test_sharded_fused_matches_single_device(n_time):
    """Sharded packed ingest == single-device packed ingest."""
    samples = _capture(12)
    chan = Channelizer.create(M)
    mesh = make_mesh(n_time=n_time, n_chan=1)
    pipe = ShardedPipeline(mesh, chan, CFG)
    got = pipe.extract_fused(samples, bit_width=12, fs=FS, fc=1e9,
                             sample_start_time=2.0)
    ref = ChannelizerPipeline(channelizer=chan, pdw_cfg=CFG).extract_fused(
        samples, bit_width=12, fs=FS, fc=1e9, sample_start_time=2.0)
    _assert_pdws_equal(got, ref)


def test_sharded_fused_int8_packed():
    """8-bit recordings go through the packed int16 lane sharded too."""
    samples = _capture(8)
    assert samples.dtype == np.int8
    chan = Channelizer.create(M)
    mesh = make_mesh(n_time=4, n_chan=1)
    pipe = ShardedPipeline(mesh, chan, CFG)
    got = pipe.extract_fused(samples, bit_width=8, fs=FS, fc=0.0)
    ref = ChannelizerPipeline(channelizer=chan, pdw_cfg=CFG).extract_fused(
        samples, bit_width=8, fs=FS, fc=0.0)
    _assert_pdws_equal(got, ref)


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4), (1, 8)])
def test_sharded_fused_chan_split(mesh_shape):
    """The pipeline over a full (time x chan) mesh — each mesh column keeps
    its band slice of the channelizer output (SURVEY section 5.8's 2-D
    mesh) — equals the single-device pipeline bit-for-bit."""
    n_time, n_chan = mesh_shape
    samples = _capture(12)
    chan = Channelizer.create(M)
    mesh = make_mesh(n_time=n_time, n_chan=n_chan)
    pipe = ShardedPipeline(mesh, chan, CFG)
    got = pipe.extract_fused(samples, bit_width=12, fs=FS, fc=1e9,
                             sample_start_time=2.0)
    ref = ChannelizerPipeline(channelizer=chan, pdw_cfg=CFG).extract_fused(
        samples, bit_width=12, fs=FS, fc=1e9, sample_start_time=2.0)
    _assert_pdws_equal(got, ref)


def test_sharded_fused_rejects_indivisible_bands():
    mesh = make_mesh(n_time=2, n_chan=3)
    pipe = ShardedPipeline(mesh, Channelizer.create(M), CFG)
    with pytest.raises(ValueError, match="divisible"):
        pipe.step_packed(jnp.zeros(4096, jnp.int32), bit_width=12)


def _open_end_capture(m: int, n_frames: int = 1024) -> np.ndarray:
    """Two-emitter (N, 2) int16 capture whose last 60 samples re-open a
    strong pulse at capture end (which must NOT be emitted)."""
    n = n_frames * m
    fs = m * 1e6
    dur = n / fs
    specs = [
        PulseTrainSpec(sample_rate_sps=fs, duration_sec=dur,
                       frequency_hz=1.02e6, pulse_width_sec=40e-6,
                       pri_sec=110e-6, start_index=37),
        PulseTrainSpec(sample_rate_sps=fs, duration_sec=dur,
                       frequency_hz=-2.97e6, pulse_width_sec=80e-6,
                       pri_sec=270e-6, start_index=803),
    ]
    rng = np.random.default_rng(3)
    iq = sum(pulse_train(s) for s in specs)
    iq = (iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    iq[-60:] = iq[37:37 + 60]
    return np.ascontiguousarray(iqpacket.from_complex(iq, 12)[:n])


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_sharded_packed_open_pulse_matches_single_device(mesh_shape):
    """Packed step over the mesh: equal noise floor and equal PDWs, a pulse
    open at capture end dropped on both sides."""
    n_time, n_chan = mesh_shape
    m = 16
    samples = _open_end_capture(m)
    fs = m * 1e6
    chan = Channelizer.create(m)
    cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=128)
    pipe = ShardedPipeline(make_mesh(n_time=n_time, n_chan=n_chan), chan, cfg)
    xq = samples.view(np.int32).ravel()
    nf, batch = pipe.step_packed(jnp.asarray(xq), bit_width=12)
    single = ChannelizerPipeline(channelizer=chan, pdw_cfg=cfg)
    nf_ref, _, batch_ref = single.step_packed(jnp.asarray(xq), bit_width=12)
    np.testing.assert_array_equal(np.asarray(nf), np.asarray(nf_ref))
    t_loc = samples.shape[0] // (n_time * m)
    got = pdwmod.finalize_pdws(
        merge_block_batches(batch, t_loc), fs=fs / m, fc=1e9,
        sample_start_time=2.0, bin_offsets_hz=chan.center_frequencies(fs))
    ref = pdwmod.finalize_pdws(
        batch_ref, fs=fs / m, fc=1e9, sample_start_time=2.0,
        bin_offsets_hz=chan.center_frequencies(fs))
    _assert_pdws_equal(got, ref)


def test_sharded_float_planes_match_single_device():
    """Float-plane ingest (``step_fused``) through the sharded step equals
    the single-device ``forward_fused``."""
    samples = _capture(12)
    chan = Channelizer.create(M)
    mesh = make_mesh(n_time=4, n_chan=1)
    pipe = ShardedPipeline(mesh, chan, CFG)
    xr = np.ascontiguousarray(samples[:, 0], np.float32) / 2048.0
    xi = np.ascontiguousarray(samples[:, 1], np.float32) / 2048.0
    nf, batch = pipe.step_fused(jnp.asarray(xr), jnp.asarray(xi), bit_width=0)
    single = ChannelizerPipeline(channelizer=chan, pdw_cfg=CFG)
    nf_ref, _, batch_ref = single.step_fused(
        jnp.asarray(xr), jnp.asarray(xi), bit_width=0)
    np.testing.assert_array_equal(np.asarray(nf), np.asarray(nf_ref))
    t_loc = samples.shape[0] // (4 * M)
    got = pdwmod.finalize_pdws(
        merge_block_batches(batch, t_loc), fs=FS / M, fc=1e9,
        sample_start_time=2.0, bin_offsets_hz=chan.center_frequencies(FS))
    ref = pdwmod.finalize_pdws(
        batch_ref, fs=FS / M, fc=1e9, sample_start_time=2.0,
        bin_offsets_hz=chan.center_frequencies(FS))
    _assert_pdws_equal(got, ref)


@pytest.mark.parametrize("mesh_shape", [(4, 1), (2, 2)])
def test_sharded_int_planes_match_packed(mesh_shape):
    """Integer planes with ``bit_width`` dequantize on the devices to the
    same capture as the packed payload: identical sharded PDWs."""
    n_time, n_chan = mesh_shape
    samples = _capture(12)
    chan = Channelizer.create(M)
    pipe = ShardedPipeline(make_mesh(n_time=n_time, n_chan=n_chan), chan, CFG)
    got = pipe.extract_fused(samples.astype(np.float32), bit_width=12, fs=FS,
                             fc=1e9, sample_start_time=2.0)
    ref = pipe.extract_fused(samples, bit_width=12, fs=FS, fc=1e9,
                             sample_start_time=2.0)
    for key in got:
        np.testing.assert_array_equal(got[key], ref[key], err_msg=key)
