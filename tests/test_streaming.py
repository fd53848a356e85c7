"""Streaming layer tests: blockwise channelize->PDW must equal the
single-shot pipeline bit-for-bit, and CaptureSet must group dwell files into
contiguous segments by their absolute start times."""

import os
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.dsp.channelizer import Channelizer, channelize
from sdr_channelizer_tpu.dsp.pdw import extract_pdws_channelized, finalize_pdws
from sdr_channelizer_tpu.dsp.streaming import CaptureSet, StreamingExtractor
from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_train

M = 8
FS = 8e6


def _capture(n_frames=8192, seed=3):
    n = n_frames * M
    dur = n / FS
    specs = [
        PulseTrainSpec(sample_rate_sps=FS, duration_sec=dur, frequency_hz=1.02e6,
                       pulse_width_sec=120e-6, pri_sec=410e-6, start_index=37),
        PulseTrainSpec(sample_rate_sps=FS, duration_sec=dur, frequency_hz=-2.97e6,
                       pulse_width_sec=900e-6, pri_sec=2100e-6, start_index=5000),
    ]
    rng = np.random.default_rng(seed)
    iq = sum(pulse_train(s) for s in specs)
    return (iq + 1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            ).astype(np.complex64)


@pytest.fixture(scope="module")
def capture():
    return _capture()


@pytest.fixture(scope="module")
def reference_pdws(capture):
    chan = Channelizer.create(M)
    cfg = PdwConfig.channelized(max_pulses=128, max_pulse_samples=1024)
    y = channelize(jnp.asarray(capture), chan)
    batch = extract_pdws_channelized(y, cfg)
    return finalize_pdws(
        batch, fs=FS / M, fc=5e8, sample_start_time=50.0,
        bin_offsets_hz=chan.center_frequencies(FS),
    )


@pytest.mark.parametrize("block_samples", [8192 * 8 // 4, 10000])
def test_streaming_matches_single_shot(capture, reference_pdws, block_samples):
    """Odd block sizes (not multiples of M) exercise the frame-carry path."""
    chan = Channelizer.create(M)
    cfg = PdwConfig.channelized(max_pulses=128, max_pulse_samples=1024)
    ext = StreamingExtractor(chan, cfg, block_frames=2048)

    def blocks():
        for k in range(0, len(capture), block_samples):
            yield capture[k : k + block_samples]

    got = ext.extract(blocks, fs=FS, fc=5e8, sample_start_time=50.0)
    ref = reference_pdws
    assert len(got["toa"]) == len(ref["toa"])
    for key in ("toa", "freq", "pw", "mag", "snr", "sat", "channel"):
        np.testing.assert_array_equal(got[key], ref[key])


def test_capture_set_segments(tmp_path):
    """Contiguous dwells merge into one segment; filter-delay gaps split."""
    if shutil.which("g++") is None:
        pytest.skip("no native toolchain")
    from conftest import build_native

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    build_native()
    exe = os.path.join(repo, "native", "build", "sdr_record_emulator")

    cont = tmp_path / "contig"
    gapped = tmp_path / "gapped"
    cont.mkdir(), gapped.mkdir()
    base = [exe, "1000", "56", "2", "30", "0.004", "0.012"]
    subprocess.run(base[:7] + ["0", "--out-dir", str(cont),
                               "--start-epoch", "1723800000.0"],
                   check=True, capture_output=True)
    subprocess.run(base[:7] + ["500", "--out-dir", str(gapped),
                               "--start-epoch", "1723900000.0"],
                   check=True, capture_output=True)

    cs = CaptureSet.from_dir(str(cont))
    assert len(cs.segments) == 1 and len(cs.segments[0].paths) == 3

    cs2 = CaptureSet.from_dir(str(gapped))
    assert len(cs2.segments) == 3  # 500-sample gap per dwell

    # Segment sample iterator re-chunks across file boundaries.
    seg = cs.segments[0]
    blocks = list(seg.iter_samples(5000))
    assert sum(b.size for b in blocks) == seg.num_samples
    assert all(b.size == 5000 for b in blocks[:-1])


def test_streaming_first_block_mode(capture):
    """Single-pass approximate mode runs and finds the strong pulses."""
    chan = Channelizer.create(M)
    cfg = PdwConfig.channelized(max_pulses=128, max_pulse_samples=1024)
    ext = StreamingExtractor(chan, cfg, block_frames=4096)

    def blocks():
        half = len(capture) // 2
        yield capture[:half]
        yield capture[half:]

    got = ext.extract(blocks, fs=FS, noise_floor="first_block")
    assert len(got["toa"]) > 10


def test_extract_segment_checkpoint_resume(tmp_path, capture, reference_pdws):
    """Segment extraction with checkpoints: interrupted run resumes at the
    first unprocessed block and the merged result is bit-identical to the
    single-shot pipeline."""
    from sdr_channelizer_tpu.io import iqpacket

    # write the capture as 3 contiguous dwell files
    n = len(capture)
    chunk = n // 3
    for k in range(3):
        part = capture[k * chunk:(k + 1) * chunk] if k < 2 else capture[2 * chunk:]
        hdr = iqpacket.IqHeader(
            frequency_hz=5e8, bandwidth_hz=FS, sample_rate_sps=FS, rx_gain_db=0,
            num_samples=len(part), bit_width=16,
            sample_start_time=50.0 + k * chunk / FS,
        )
        iqpacket.write_iq(tmp_path / f"d{k}.iq", hdr, iqpacket.from_complex(part, 16))
    # re-read: quantization means ground truth = requantized capture
    cs = CaptureSet.from_dir(str(tmp_path))
    assert len(cs.segments) == 1
    seg = cs.segments[0]
    requant = seg.read_samples(0, seg.num_samples)

    chan = Channelizer.create(M)
    cfg = PdwConfig.channelized(max_pulses=128, max_pulse_samples=1024)
    y_ref = channelize(jnp.asarray(requant), chan)
    ref = finalize_pdws(
        extract_pdws_channelized(y_ref, cfg), fs=FS / M, fc=5e8,
        sample_start_time=50.0, bin_offsets_hz=chan.center_frequencies(FS),
    )

    ext = StreamingExtractor(chan, cfg, block_frames=1500)
    ck = tmp_path / "ck"

    # "interrupted" first run: process then delete the tail checkpoints
    full = ext.extract_segment(seg, fc=5e8, checkpoint_dir=str(ck))
    blocks = sorted(ck.glob("block_*.npz"))
    assert len(blocks) >= 3
    for b in blocks[len(blocks) // 2:]:
        b.unlink()

    resumed = ext.extract_segment(seg, fc=5e8, checkpoint_dir=str(ck))
    for key in ref:
        np.testing.assert_array_equal(resumed[key], full[key])
        np.testing.assert_array_equal(resumed[key], ref[key])


def test_read_samples_random_access(tmp_path):
    from sdr_channelizer_tpu.io import iqpacket

    iq = (np.arange(3000) + 1j * np.arange(3000)).astype(np.complex64) / 4096
    for k in range(3):
        part = iq[k * 1000:(k + 1) * 1000]
        hdr = iqpacket.IqHeader(
            frequency_hz=0, bandwidth_hz=1e6, sample_rate_sps=1e6, rx_gain_db=0,
            num_samples=1000, bit_width=16, sample_start_time=k * 1e-3,
        )
        iqpacket.write_iq(tmp_path / f"f{k}.iq", hdr, iqpacket.from_complex(part, 16))
    seg = CaptureSet.from_dir(str(tmp_path)).segments[0]
    whole = seg.read_samples(0, 3000)
    np.testing.assert_array_equal(seg.read_samples(900, 250), whole[900:1150])
    np.testing.assert_array_equal(seg.read_samples(2990, 100), whole[2990:])
    assert seg.read_samples(5000, 10).size == 0


def test_wideband_segment_extraction(tmp_path):
    """channelizer=None: full-rate create_pdws.m semantics over dwell files,
    equal to the in-memory wideband pipeline."""
    from sdr_channelizer_tpu.io import iqpacket
    from sdr_channelizer_tpu.models import WidebandPdwPipeline

    # Sparse pulses: the wideband median floor needs a low duty cycle.
    rng = np.random.default_rng(9)
    n = 4096 * M
    t = np.arange(n)
    spec_iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
               ).astype(np.complex64)
    tone = np.exp(2j * np.pi * 0.113 * t).astype(np.complex64)
    for s0 in range(400, n - 900, 2500):
        spec_iq[s0:s0 + 800] = tone[s0:s0 + 800]
    chunk = n // 2
    for k in range(2):
        part = spec_iq[k * chunk:(k + 1) * chunk]
        hdr = iqpacket.IqHeader(
            frequency_hz=0, bandwidth_hz=FS, sample_rate_sps=FS, rx_gain_db=0,
            num_samples=len(part), bit_width=16,
            sample_start_time=7.0 + k * chunk / FS,
        )
        iqpacket.write_iq(tmp_path / f"w{k}.iq", hdr, iqpacket.from_complex(part, 16))
    seg = CaptureSet.from_dir(str(tmp_path)).segments[0]
    requant = seg.read_samples(0, seg.num_samples)

    cfg = PdwConfig.wideband(max_pulses=256, max_pulse_samples=4096)
    ref = WidebandPdwPipeline(pdw_cfg=cfg).extract(
        jnp.asarray(requant), fs=FS, sample_start_time=7.0)

    ext = StreamingExtractor(None, cfg, block_frames=9000)
    got = ext.extract_segment(seg)
    assert len(got["toa"]) == len(ref["toa"]) > 10
    for key in ("toa", "freq", "pw", "mag", "snr", "sat"):
        np.testing.assert_array_equal(got[key], ref[key])


def test_wideband_extract_iterator_mode(capture):
    """extract() with channelizer=None (ADVICE r1: used to crash on
    self.channelizer.num_bands): wideband iterator-based extraction equals
    the in-memory wideband pipeline bit-for-bit."""
    from sdr_channelizer_tpu.models import WidebandPdwPipeline

    rng = np.random.default_rng(13)
    n = 4096 * M
    t = np.arange(n)
    iq = (1e-3 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    tone = np.exp(2j * np.pi * 0.171 * t).astype(np.complex64)
    for s0 in range(300, n - 900, 2100):
        iq[s0:s0 + 650] = tone[s0:s0 + 650]

    cfg = PdwConfig.wideband(max_pulses=256, max_pulse_samples=4096)
    ref = WidebandPdwPipeline(pdw_cfg=cfg).extract(
        jnp.asarray(iq), fs=FS, fc=1e9, sample_start_time=3.0)

    ext = StreamingExtractor(None, cfg, block_frames=7168)

    def blocks():
        for k in range(0, n, 7168):
            yield iq[k:k + 7168]

    got = ext.extract(blocks, fs=FS, fc=1e9, sample_start_time=3.0)
    assert len(got["toa"]) == len(ref["toa"]) > 10
    for key in ("toa", "freq", "pw", "mag", "snr", "sat"):
        np.testing.assert_array_equal(got[key], ref[key])


def test_measure_noise_floor_exact(capture):
    """The two-counting-pass streamed median (O(block) memory) equals
    np.median over the materialized whole-capture magnitudes — the
    create_pdws_channelized.m:73 exactness contract — for both even and odd
    sample counts (mean-of-two-middles vs middle order statistic)."""
    chan = Channelizer.create(M)
    cfg = PdwConfig.channelized(max_pulses=32, max_pulse_samples=256)

    for n_frames in (4096, 4095):  # even and odd per-channel counts
        iq = capture[: n_frames * M]

        def blocks(iq=iq):
            for k in range(0, len(iq), 10001):
                yield iq[k:k + 10001]

        ext = StreamingExtractor(chan, cfg, block_frames=1024)
        got = ext.measure_noise_floor(blocks)
        full = np.abs(np.asarray(channelize(jnp.asarray(iq), chan)))
        np.testing.assert_array_equal(got, np.median(full, axis=0).astype(np.float32))

    with pytest.raises(ValueError, match="empty sample stream"):
        StreamingExtractor(chan, cfg).measure_noise_floor(lambda: iter(()))


def test_short_block_warnings():
    """Blocks shorter than the detection halo warn instead of silently
    breaking the bit-exact stitching contract (ADVICE r1)."""
    chan = Channelizer.create(M)
    cfg = PdwConfig.channelized(max_pulses=32, max_pulse_samples=1024)
    with pytest.warns(UserWarning, match="shorter than the detection halo"):
        StreamingExtractor(chan, cfg, block_frames=512)


def test_streaming_counters(capture):
    chan = Channelizer.create(M)
    cfg = PdwConfig.channelized(max_pulses=128, max_pulse_samples=1024)
    ext = StreamingExtractor(chan, cfg, block_frames=2048)

    def blocks():
        for k in range(0, len(capture), 10000):
            yield capture[k:k + 10000]

    got = ext.extract(blocks, fs=FS, noise_floor="first_block")
    c = ext.counters
    assert c.get("samples_ingested") == len(capture) // M * M
    assert c.get("blocks_processed") == -(-len(capture) // 10000)
    assert c.get("pulses_emitted") == len(got["toa"]) > 0


def test_extract_segment_matches_packed_single_shot(tmp_path):
    """A two-file 12-bit segment streamed block by block equals the
    single-shot packed-payload extraction (``extract_fused``) of the same
    bytes pulse-for-pulse, and checkpoint/resume is bit-identical."""
    from sdr_channelizer_tpu.io import iqpacket
    from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline

    capture = _capture(n_frames=1536, seed=5)
    n = len(capture)
    chunk = n // 2
    raw = []
    for k in range(2):
        part = capture[k * chunk:(k + 1) * chunk]
        hdr = iqpacket.IqHeader(
            frequency_hz=5e8, bandwidth_hz=FS, sample_rate_sps=FS,
            rx_gain_db=0, num_samples=len(part), bit_width=12,
            sample_start_time=50.0 + k * chunk / FS,
        )
        raw.append(iqpacket.from_complex(part, 12))
        iqpacket.write_iq(tmp_path / f"d{k}.iq", hdr, raw[-1])
    seg = CaptureSet.from_dir(str(tmp_path)).segments[0]
    raw = np.concatenate(raw)

    chan = Channelizer.create(M)
    cfg = PdwConfig.channelized(max_pulses=64, max_pulse_samples=256)
    pipe = ChannelizerPipeline.create(M, pdw_cfg=cfg)
    ref = pipe.extract_fused(raw, bit_width=12, fs=FS, fc=5e8,
                             sample_start_time=50.0)

    ext = StreamingExtractor(chan, cfg, block_frames=512, halo_frames=256)
    ck = tmp_path / "ck"
    got = ext.extract_segment(seg, fc=5e8, checkpoint_dir=str(ck))
    assert len(got["toa"]) == len(ref["toa"]) > 10
    for key in ("toa", "pw", "mag", "sat", "channel"):
        np.testing.assert_array_equal(got[key], ref[key])
    for key in ("freq", "snr"):  # few f32 ulps: per-shape compile variance
        np.testing.assert_allclose(got[key], ref[key], rtol=1e-6, atol=1e-5)

    # interrupted resume: drop the tail checkpoint, rerun, bit-identical
    blocks = sorted(ck.glob("block_*.npz"))
    assert len(blocks) == 3
    blocks[-1].unlink()
    resumed = ext.extract_segment(seg, fc=5e8, checkpoint_dir=str(ck))
    for key in got:
        np.testing.assert_array_equal(resumed[key], got[key])


def test_capture_set_contiguous_at_utc_epoch(tmp_path):
    """Absolute UTC epoch start times (~1.7e9 s): one f64 ulp is ~13
    samples at 56 Msps, so the contiguity check must tolerate timestamp
    representation error or it splits genuinely contiguous dwells."""
    from sdr_channelizer_tpu.io import iqpacket

    fs = 56e6
    chunk = 1000000
    for k in range(3):
        hdr = iqpacket.IqHeader(
            frequency_hz=0, bandwidth_hz=fs, sample_rate_sps=fs,
            rx_gain_db=0, num_samples=chunk, bit_width=12,
            sample_start_time=1723800000.0 + k * chunk / fs,
        )
        iqpacket.write_iq(tmp_path / f"d{k}.iq", hdr,
                          np.zeros((chunk, 2), np.int16))
    cs = CaptureSet.from_dir(str(tmp_path))
    assert len(cs.segments) == 1
    # a genuine multi-sample gap still splits
    hdr = iqpacket.IqHeader(
        frequency_hz=0, bandwidth_hz=fs, sample_rate_sps=fs,
        rx_gain_db=0, num_samples=chunk, bit_width=12,
        sample_start_time=1723800000.0 + (3 * chunk + 500) / fs,
    )
    iqpacket.write_iq(tmp_path / "d3.iq", hdr,
                      np.zeros((chunk, 2), np.int16))
    assert len(CaptureSet.from_dir(str(tmp_path)).segments) == 2
