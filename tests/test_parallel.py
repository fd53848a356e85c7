"""Sharded-pipeline parity tests: the distributed (time x chan) path must
reproduce the single-device path exactly (bit-for-bit with one mesh column,
within DFT-vs-FFT rounding otherwise) — including pulses straddling time
shard boundaries and pulses still active at capture end.

Runs on the 8-virtual-CPU-device mesh set up by conftest.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.dsp.channelizer import Channelizer, channelize
from sdr_channelizer_tpu.dsp.pdw import extract_pdws_channelized
from sdr_channelizer_tpu.parallel import make_mesh
from sdr_channelizer_tpu.parallel.pipeline import (
    ShardedPipeline,
    merge_block_batches,
    sharded_channelize,
)
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train


M = 8
FS = 8e6  # 8 channels of 1 MHz


def _capture(n_frames: int, seed: int = 0) -> np.ndarray:
    """Multi-emitter capture: three pulse trains in different bands with PRIs
    chosen so pulses straddle shard boundaries, plus low noise."""
    n = n_frames * M
    dur = n / FS
    specs = [
        PulseTrainSpec(sample_rate_sps=FS, duration_sec=dur, frequency_hz=1.02e6,
                       pulse_width_sec=120e-6, pri_sec=410e-6, start_index=37),
        PulseTrainSpec(sample_rate_sps=FS, duration_sec=dur, frequency_hz=-2.97e6,
                       pulse_width_sec=260e-6, pri_sec=990e-6, start_index=1803),
        PulseTrainSpec(sample_rate_sps=FS, duration_sec=dur, frequency_hz=0.04e6,
                       pulse_width_sec=60e-6, pri_sec=505e-6, start_index=901),
    ]
    rng = np.random.default_rng(seed)
    iq = sum(pulse_train(s) for s in specs)
    iq = iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
    return iq.astype(np.complex64)


def _valid_pdws(batch, chan_idx):
    """Sorted (toa, te, pw, mag, snr, foff, sat) tuples for one channel."""
    v = np.asarray(batch.valid[chan_idx])
    cols = [np.asarray(f[chan_idx])[v] for f in (
        batch.toa_idx, batch.te_idx, batch.pw_sec, batch.mag,
        batch.snr_db, batch.freq_offset_hz, batch.saturated)]
    order = np.argsort(cols[0], kind="stable")
    return [c[order] for c in cols]


@pytest.fixture(scope="module")
def capture():
    return _capture(n_frames=4096)


@pytest.fixture(scope="module")
def reference(capture):
    y = channelize(jnp.asarray(capture), Channelizer.create(M))
    cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=512)
    batch = extract_pdws_channelized(y, cfg)
    return y, batch


def test_sharded_channelize_exact(capture, reference):
    y_ref, _ = reference
    mesh = make_mesh(n_time=8, n_chan=1)
    y = sharded_channelize(jnp.asarray(capture), Channelizer.create(M), mesh)
    np.testing.assert_array_equal(np.asarray(y), np.asarray(y_ref))


def test_sharded_channelize_chan_split(capture, reference):
    y_ref, _ = reference
    mesh = make_mesh(n_time=4, n_chan=2)
    y = sharded_channelize(jnp.asarray(capture), Channelizer.create(M), mesh)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y_ref), atol=2e-5)


@pytest.mark.parametrize("n_time,n_chan", [(8, 1), (4, 2), (2, 4)])
def test_sharded_pipeline_matches_single_device(capture, reference, n_time, n_chan):
    _, batch_ref = reference
    cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=512)
    mesh = make_mesh(n_time=n_time, n_chan=n_chan)
    pipe = ShardedPipeline(mesh, Channelizer.create(M), cfg)
    _, _, batch = pipe.step(jnp.asarray(capture))
    merged = merge_block_batches(batch, block_len_frames=4096 // n_time)

    assert int(np.sum(np.asarray(batch.count))) == int(
        np.sum(np.asarray(batch_ref.count))
    )
    for ch in range(M):
        ref = _valid_pdws(batch_ref, ch)
        got = _valid_pdws(merged, ch)
        np.testing.assert_array_equal(got[0], ref[0])  # toa indices
        np.testing.assert_array_equal(got[1], ref[1])  # te indices
        np.testing.assert_array_equal(got[6], ref[6])  # saturation
        if n_chan == 1:
            for k in (2, 3, 4, 5):  # bit-exact float metrics (FFT path)
                np.testing.assert_array_equal(got[k], ref[k])
        else:
            for k in (2, 3, 4, 5):
                np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, atol=1e-5)


def test_boundary_straddling_pulse_owned_once(reference):
    """A pulse crossing every shard boundary is emitted exactly once, by the
    shard owning its leading edge."""
    # One long pulse spanning frames [500, 1600) — crosses the 1024-frame
    # boundary of an 8-way split of 2048 frames (block = 256 frames).
    n_frames = 2048
    n = n_frames * M
    iq = np.full(n, 0.001 + 0j, np.complex64)
    t = np.arange(n)
    tone = np.exp(2j * np.pi * 1.1e6 / FS * t).astype(np.complex64)
    iq[500 * M:1600 * M] = tone[500 * M:1600 * M]
    cfg = PdwConfig.channelized(max_pulses=16, max_pulse_samples=2048)
    chan = Channelizer.create(M)
    batch_ref = extract_pdws_channelized(channelize(jnp.asarray(iq), chan), cfg)

    mesh = make_mesh(n_time=8, n_chan=1)
    pipe = ShardedPipeline(mesh, chan, cfg)
    # max_pulse_samples (2048) deliberately exceeds the 256-frame blocks:
    # the halo caps (with a warning) and the stitching contract still holds
    # for the pulses this capture actually produces.
    with pytest.warns(UserWarning, match="halo"):
        _, _, batch = pipe.step(jnp.asarray(iq))
    merged = merge_block_batches(batch, block_len_frames=n_frames // 8)
    assert int(np.sum(np.asarray(batch.count))) == int(np.sum(np.asarray(batch_ref.count)))
    for ch in range(M):
        ref = _valid_pdws(batch_ref, ch)
        got = _valid_pdws(merged, ch)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g, r)


def test_pulse_active_at_end_not_emitted():
    """Reference rule: a pulse that never sees its trailing edge is dropped —
    also under sharding (the +inf halo pad)."""
    n_frames = 1024
    n = n_frames * M
    iq = np.full(n, 0.001 + 0j, np.complex64)
    t = np.arange(n)
    tone = np.exp(2j * np.pi * 1.0e6 / FS * t).astype(np.complex64)
    iq[900 * M:] = tone[900 * M:]  # runs to capture end
    cfg = PdwConfig.channelized(max_pulses=8, max_pulse_samples=256)
    chan = Channelizer.create(M)
    batch_ref = extract_pdws_channelized(channelize(jnp.asarray(iq), chan), cfg)
    mesh = make_mesh(n_time=8, n_chan=1)
    pipe = ShardedPipeline(mesh, chan, cfg)
    with pytest.warns(UserWarning, match="halo"):
        _, _, batch = pipe.step(jnp.asarray(iq))
    assert int(np.sum(np.asarray(batch.count))) == int(np.sum(np.asarray(batch_ref.count)))


def test_strict_halo_mode_refuses():
    """halo_mode='strict' turns the halo cap into an error (never a silent
    boundary-pulse drop); a fitting halo still runs."""
    n_frames = 1024
    iq = _capture(n_frames)
    cfg = PdwConfig.channelized(max_pulses=8, max_pulse_samples=2048)
    chan = Channelizer.create(M)
    mesh = make_mesh(n_time=8, n_chan=1)
    pipe = ShardedPipeline(mesh, chan, cfg, halo_mode="strict")
    with pytest.raises(ValueError, match="halo"):
        pipe.step(jnp.asarray(iq))
    ok = ShardedPipeline(mesh, chan, cfg, halo_frames=128,
                         halo_mode="strict")
    _, _, batch = ok.step(jnp.asarray(iq))
    assert int(np.sum(np.asarray(batch.count))) >= 0


def test_extract_end_to_end(capture):
    """Host-facing extract(): absolute times/frequencies, sorted by TOA."""
    cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=512)
    mesh = make_mesh(n_time=4, n_chan=2)
    pipe = ShardedPipeline(mesh, Channelizer.create(M), cfg)
    pdws = pipe.extract(jnp.asarray(capture), fs=FS, fc=1e9, sample_start_time=100.0)
    assert len(pdws["toa"]) > 0
    assert np.all(np.diff(pdws["toa"]) >= 0)
    assert np.all(pdws["toa"] > 100.0)
    # The 1.02 MHz emitter lands in the 1 MHz band with ~20 kHz offset.
    band1 = pdws["freq"][(pdws["freq"] > 1e9 + 0.9e6) & (pdws["freq"] < 1e9 + 1.1e6)]
    assert len(band1) > 0


def test_sharded_wideband_matches_single_device():
    """Time-sharded full-rate extraction (create_pdws.m under sharding)."""
    from sdr_channelizer_tpu.dsp.pdw import extract_pdws
    from sdr_channelizer_tpu.parallel.pipeline import sharded_extract_pdws

    n = 8 * 4096
    rng = np.random.default_rng(11)
    t = np.arange(n)
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    tone = np.exp(2j * np.pi * 0.113 * t).astype(np.complex64)
    for s in range(500, n - 700, 3000):  # pulses straddle 4096-sample shards
        iq[s:s + 700] = tone[s:s + 700]
    cfg = PdwConfig.wideband(max_pulses=32, max_pulse_samples=1024)
    batch_ref = extract_pdws(jnp.asarray(iq), cfg)

    mesh = make_mesh(n_time=8, n_chan=1)
    batch, block_len = sharded_extract_pdws(jnp.asarray(iq), cfg, mesh)
    from sdr_channelizer_tpu.parallel.pipeline import merge_block_batches
    merged = merge_block_batches(batch, block_len)
    assert int(np.asarray(batch.count).sum()) == int(np.asarray(batch_ref.count))
    ref_cols = _valid_pdws_1d(batch_ref)
    got_cols = _valid_pdws(merged, 0)
    for r, g in zip(ref_cols, got_cols):
        np.testing.assert_array_equal(g, r)


def _valid_pdws_1d(batch):
    v = np.asarray(batch.valid)
    cols = [np.asarray(f)[v] for f in (
        batch.toa_idx, batch.te_idx, batch.pw_sec, batch.mag,
        batch.snr_db, batch.freq_offset_hz, batch.saturated)]
    order = np.argsort(cols[0], kind="stable")
    return [c[order] for c in cols]


@pytest.mark.parametrize("n_time,n_chan", [(8, 1), (4, 2)])
def test_sharded_planes_matches_single_device(capture, n_time, n_chan):
    """The complex-free planes sharded graph matches the single-device
    planes pipeline exactly."""
    from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline

    cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=512)
    chan = Channelizer.create(M)
    mesh = make_mesh(n_time=n_time, n_chan=n_chan)
    pipe = ShardedPipeline(mesh, chan, cfg)
    got = pipe.extract_planes(capture, fs=FS, fc=1e9, sample_start_time=2.0)
    ref = ChannelizerPipeline(channelizer=chan, pdw_cfg=cfg).extract_planes(
        capture, fs=FS, fc=1e9, sample_start_time=2.0)
    assert len(got["toa"]) == len(ref["toa"]) > 20
    for key in ("toa", "pw", "mag", "sat", "channel"):
        np.testing.assert_array_equal(got[key], ref[key])
    # /360 and log10 may compile as multiply-by-reciprocal in one program
    # and true divide in the other -> 1 f32 ULP on freq/snr.
    for key in ("freq", "snr"):
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-9, atol=1e-6)


def test_sharded_planes_channelizer_matches_complex(capture):
    """Planes sharded channelization == complex sharded channelization
    (same DFT matmul, split into four real products)."""
    mesh = make_mesh(n_time=4, n_chan=2)
    chan = Channelizer.create(M)
    cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=512)
    pipe = ShardedPipeline(mesh, chan, cfg)
    xr = np.ascontiguousarray(np.real(capture), np.float32)
    xi = np.ascontiguousarray(np.imag(capture), np.float32)
    yr, yi, nf, _ = pipe.step_planes(jnp.asarray(xr), jnp.asarray(xi))
    y = np.asarray(channelize(jnp.asarray(capture), chan, method="dft"))
    np.testing.assert_allclose(np.asarray(yr), np.real(y), atol=2e-5)
    np.testing.assert_allclose(np.asarray(yi), np.imag(y), atol=2e-5)
