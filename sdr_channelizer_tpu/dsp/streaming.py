"""Streaming/blocking layer: run the channelize -> PDW chain over captures
too large for one device buffer, and over multi-file capture sets.

The reference's unit of storage is one ``.iq`` file per dwell with an
absolute ``sampleStartTime`` (``Helper.cpp:22``,
``usrp_record_iq_12bit.cpp:196``), and its channelizer demo walks a capture
in windows (``channelizer_example.m:33-50``).  This module formalizes both:

* :class:`CaptureSet` — an ordered set of ``.iq`` files grouped into
  *contiguous segments* (files whose start time continues the previous
  file's samples within half a sample period).  Timed dwells with gaps form
  separate segments, exactly like the reference treating files
  independently while TOAs stay absolute.

* :class:`StreamingExtractor` — overlap-save block processing within a
  segment: the channelizer carries its P-frame FIR history
  (``Channelizer.stream_block``) and the PDW detector carries its latch
  state across blocks via transfer-function composition
  (``dsp.pdw.block_transfer``), with a one-block lookahead providing the
  right halo so pulses straddling block boundaries are emitted exactly once
  with exact statistics.  Block outputs concatenate bit-for-bit to the
  single-shot result — same contract as the sharded path
  (``parallel/pipeline.py``), sequential instead of SPMD.

Noise floors: the reference uses the median over the *whole* capture
(``create_pdws_channelized.m:73``), which no single streaming pass can
produce.  ``noise_floor="two_pass"`` (default) measures exact floors with
two streamed counting passes (O(block) memory, see
:meth:`StreamingExtractor.measure_noise_floor`), then detects — preserving
exact parity; ``"first_block"`` estimates from the first block only
(single pass, approximate); or pass precomputed per-channel floors.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator, List, Optional, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.dsp import pdw as pdwmod
from sdr_channelizer_tpu.ops import medians
from sdr_channelizer_tpu.dsp.channelizer import Channelizer
from sdr_channelizer_tpu.io import iqpacket
from sdr_channelizer_tpu.utils.metrics import Counters


def _sortable_u32_np(x: np.ndarray) -> np.ndarray:
    """Order-preserving f32 -> u32 keys (numpy twin of
    ``ops.medians._sortable_u32``; same total order, NaNs sort high)."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    neg = (u >> np.uint32(31)) == 1
    return np.where(neg, ~u, u | np.uint32(0x80000000))


def _u32_to_f32_np(u: np.ndarray) -> np.ndarray:
    u = np.atleast_1d(np.ascontiguousarray(u, np.uint32))
    neg = (u >> np.uint32(31)) == 0
    raw = np.where(neg, ~u, u & np.uint32(0x7FFFFFFF))
    return raw.view(np.float32)


@dataclasses.dataclass
class Segment:
    """A maximal run of time-contiguous dwell files."""

    paths: List[str]
    headers: List[iqpacket.IqHeader]

    @property
    def start_time(self) -> float:
        return self.headers[0].sample_start_time

    @property
    def num_samples(self) -> int:
        return sum(h.num_samples for h in self.headers)

    def iter_samples(self, block_samples: int) -> Iterator[np.ndarray]:
        """Yield normalized complex64 blocks of exactly ``block_samples``
        (last block may be short)."""
        carry = np.zeros(0, np.complex64)
        for path, hdr in zip(self.paths, self.headers):
            _, samples = iqpacket.read_iq(path)
            iq = iqpacket.to_complex(np.asarray(samples), hdr.bit_width)
            buf = np.concatenate([carry, iq]) if carry.size else iq
            n_full = buf.size // block_samples
            for k in range(n_full):
                yield buf[k * block_samples : (k + 1) * block_samples]
            carry = buf[n_full * block_samples :]
        if carry.size:
            yield carry

    def read_samples(self, start: int, count: int) -> np.ndarray:
        """Random-access read of ``count`` normalized samples from segment
        offset ``start`` (clipped at the segment end; memory-mapped, so only
        the requested span touches disk)."""
        out = []
        pos = 0
        remaining = count
        for path, hdr in zip(self.paths, self.headers):
            n = hdr.num_samples
            if remaining <= 0:
                break
            if pos + n > start:
                lo = max(start - pos, 0)
                hi = min(n, lo + remaining)
                _, samples = iqpacket.read_iq(path)  # mmap-backed
                out.append(
                    iqpacket.to_complex(np.asarray(samples[lo:hi]), hdr.bit_width)
                )
                remaining -= hi - lo
            pos += n
        if not out:
            return np.zeros(0, np.complex64)
        return out[0] if len(out) == 1 else np.concatenate(out)

@dataclasses.dataclass
class CaptureSet:
    """Ordered ``.iq`` files split into contiguous segments."""

    segments: List[Segment]

    @classmethod
    def from_paths(
        cls, paths: Sequence[str], tol_samples: float = 0.5
    ) -> "CaptureSet":
        entries = []
        for p in paths:
            hdr, _ = iqpacket.read_iq(p)
            entries.append((hdr.sample_start_time, str(p), hdr))
        entries.sort(key=lambda e: e[0])
        segs: List[Segment] = []
        for t0, path, hdr in entries:
            if segs:
                prev = segs[-1].headers[-1]
                expected_end = prev.sample_start_time + prev.num_samples / prev.sample_rate_sps
                gap = abs(t0 - expected_end) * hdr.sample_rate_sps
                same_rate = hdr.sample_rate_sps == prev.sample_rate_sps
                # At absolute UTC epochs (~1.7e9 s) one float64 ulp is
                # ~2.4e-7 s — 13 samples at 56 Msps — so a sub-sample
                # tolerance would split genuinely contiguous dwells on
                # representation error alone.  Guard by a few ulps of the
                # timestamps themselves.
                ulp_guard = 4.0 * np.spacing(max(abs(t0), abs(expected_end),
                                                 1.0))
                tol = max(tol_samples, ulp_guard * hdr.sample_rate_sps)
                if same_rate and gap <= tol:
                    segs[-1].paths.append(path)
                    segs[-1].headers.append(hdr)
                    continue
            segs.append(Segment(paths=[path], headers=[hdr]))
        return cls(segments=segs)

    @classmethod
    def from_dir(cls, directory: str, pattern: str = "*.iq") -> "CaptureSet":
        import glob
        import os

        return cls.from_paths(sorted(glob.glob(os.path.join(directory, pattern))))


@dataclasses.dataclass
class StreamingExtractor:
    """Blockwise channelize -> PDW over one contiguous sample stream.

    With ``channelizer=None`` the extractor runs **wideband** (full-rate,
    ``create_pdws.m`` semantics): the stream is treated as one channel, no
    decimation, scalar whole-capture median noise floor.
    """

    channelizer: Optional[Channelizer]
    pdw_cfg: PdwConfig
    block_frames: int = 65536
    halo_frames: Optional[int] = None  # default: pdw_cfg.max_pulse_samples
    # Observability (SURVEY.md section 5.5): samples/blocks/pulses counters.
    counters: Counters = dataclasses.field(default_factory=Counters)

    def __post_init__(self):
        self._halo = self.halo_frames or self.pdw_cfg.max_pulse_samples
        if self.block_frames < self._halo:
            # The one-block lookahead is the halo; shorter blocks would
            # silently truncate it below the longest pulse and break the
            # bit-exact stitching contract for boundary-straddling pulses.
            import warnings

            warnings.warn(
                f"block_frames={self.block_frames} is shorter than the "
                f"detection halo ({self._halo} frames): pulses straddling "
                f"block boundaries may be dropped; increase block_frames or "
                f"reduce max_pulse_samples/halo_frames",
                stacklevel=2,
            )
        cfg = self.pdw_cfg

        @functools.partial(jax.jit, static_argnames=("own_len",))
        def _detect_block(mag_e, ph_e, sat_e, nf, entry, *, own_len):
            core = functools.partial(
                pdwmod.extract_pdws_block_core,
                own_len=own_len,
                snr_threshold_db=cfg.snr_threshold_db,
                trailing_threshold_db=cfg.trailing_threshold_db,
                max_pulses=cfg.max_pulses,
                max_pulse_samples=cfg.max_pulse_samples,
            )
            batch = jax.vmap(core, in_axes=(1, 1, 1, 0, 0))(
                mag_e, ph_e, sat_e, nf, entry
            )
            a, b = pdwmod.block_transfer(
                mag_e[:own_len].T, nf[:, None],
                cfg.snr_threshold_db, cfg.trailing_threshold_db,
            )
            return batch, a, b

        self._detect_block = _detect_block

    def _channelized_blocks(self, sample_blocks: Iterator[np.ndarray]):
        """Channelize a sample-block stream; yields (T_i, M) complex arrays
        whose concatenation equals the single-shot channelizer output.
        Wideband mode (no channelizer): identity, one column per stream."""
        if self.channelizer is None:
            for block in sample_blocks:
                if block.size:
                    yield jnp.asarray(block)[:, None]
            return
        m = self.channelizer.num_bands
        state = self.channelizer.init_state()
        carry = np.zeros(0, np.complex64)
        for block in sample_blocks:
            buf = np.concatenate([carry, block]) if carry.size else block
            n_frames = buf.size // m
            carry = buf[n_frames * m :]
            if n_frames == 0:
                continue
            y, state = self.channelizer.stream_block(
                jnp.asarray(buf[: n_frames * m]), state
            )
            yield y

    def _noise_floor_from_mag_blocks(self, make_mag_blocks) -> np.ndarray:
        """Exact per-channel median from an iterator factory of host (T, M)
        float32 magnitude blocks — the two counting passes of
        :meth:`measure_noise_floor`."""
        bins = 1 << 16
        hist_hi = None
        n_total = 0
        for mag in make_mag_blocks():
            keys = _sortable_u32_np(mag)  # (T, M)
            m = keys.shape[1]
            if hist_hi is None:
                hist_hi = np.zeros((m, bins), np.int64)
            flat = (keys >> np.uint32(16)).astype(np.int64) + np.arange(m) * bins
            hist_hi += np.bincount(flat.ravel(), minlength=m * bins).reshape(m, bins)
            n_total += keys.shape[0]
        if not n_total:
            raise ValueError("empty sample stream: no samples to measure")
        m = hist_hi.shape[0]

        ks = (max((n_total - 1) // 2, 0), n_total // 2)
        cum = np.cumsum(hist_hi, axis=1)
        need = {}
        locs = np.empty((m, 2), np.int64)
        below = np.empty((m, 2), np.int64)
        for c in range(m):
            for j, k in enumerate(ks):
                b = int(np.searchsorted(cum[c], k + 1, side="left"))
                locs[c, j] = b
                below[c, j] = int(cum[c, b - 1]) if b else 0
                need.setdefault((c, b), len(need))

        hist_lo = np.zeros((len(need), bins), np.int64)
        for mag in make_mag_blocks():
            keys = _sortable_u32_np(mag)
            for (c, b), row in need.items():
                col = keys[:, c]
                sel = col[(col >> np.uint32(16)) == b]
                if sel.size:
                    hist_lo[row] += np.bincount(
                        (sel & np.uint32(0xFFFF)).astype(np.int64),
                        minlength=bins)

        vals = np.empty((m, 2), np.float32)
        for c in range(m):
            for j in range(2):
                b = locs[c, j]
                cl = np.cumsum(hist_lo[need[(c, b)]])
                r = ks[j] - below[c, j]
                low = int(np.searchsorted(cl, r + 1, side="left"))
                vals[c, j] = _u32_to_f32_np(np.uint32((b << 16) | low))[0]
        return np.float32(0.5) * (vals[:, 0] + vals[:, 1])

    def measure_noise_floor(self, make_sample_blocks) -> np.ndarray:
        """Exact per-channel median magnitude over the whole stream in
        O(block) memory (pass 1 of the exact two-pass mode).

        The median is not streaming-composable and materializing every
        block's magnitudes would defeat the purpose of streaming captures
        too large for memory; instead the selection runs as **two counting
        passes over the order-preserving u32 key space** — the streamed
        form of ``ops.medians``' radix selection.  Pass A histograms the
        top 16 key bits per channel, locating the 64Ki-key bucket holding
        each middle order statistic; pass B histograms the low 16 bits
        within those buckets only.  Identical order statistics and
        mean-of-two-middles as ``medians.median`` / ``np.median``
        (``create_pdws_channelized.m:73`` exactness contract).

        ``make_sample_blocks``: zero-arg callable returning a fresh
        sample-block iterator (consumed twice).
        """
        def mag_blocks():
            for y in self._channelized_blocks(make_sample_blocks()):
                yield np.asarray(jnp.abs(y))  # |y| on device, f32 fetch

        return self._noise_floor_from_mag_blocks(mag_blocks)

    def extract(
        self,
        make_sample_blocks,  # () -> Iterator[np.ndarray]; callable so the
        # two-pass mode can re-read the source
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
        noise_floor: Union[str, np.ndarray] = "two_pass",
    ) -> dict:
        """Run the stream; returns the host PDW dict (absolute TOAs/freqs)."""
        m = 1 if self.channelizer is None else self.channelizer.num_bands
        cfg = self.pdw_cfg
        halo = self._halo

        if isinstance(noise_floor, str) and noise_floor == "two_pass":
            nf = jnp.asarray(self.measure_noise_floor(make_sample_blocks))
        elif isinstance(noise_floor, str) and noise_floor == "first_block":
            nf = None  # set from the first block below
        else:
            nf = jnp.asarray(noise_floor)

        entry = jnp.zeros((m,), bool)
        results = []
        offsets = []
        offset = 0

        pending = None  # previous block's (mag, ph, sat) awaiting its halo

        def flush(prev, halo_streams, own_len, entry):
            mag_e = jnp.concatenate([prev[0], halo_streams[0]], axis=0)
            ph_e = jnp.concatenate([prev[1], halo_streams[1]], axis=0)
            sat_e = jnp.concatenate([prev[2], halo_streams[2]], axis=0)
            return self._detect_block(
                mag_e, ph_e, sat_e, nf, entry, own_len=own_len
            )

        short_halo = False  # last flush's halo was truncated by a short block
        for y in self._channelized_blocks(make_sample_blocks()):
            self.counters.add("samples_ingested", y.shape[0] * m)
            self.counters.add("blocks_processed")
            mag, ph, sat = pdwmod._prep_streams(y, cfg.saturation_level)
            if nf is None:
                nf = medians.median(mag, axis=0)
            if pending is not None:
                if short_halo:
                    # The previous flush saw a halo shorter than the longest
                    # pulse AND the short block was not the final one — a
                    # pulse straddling the whole short block may be dropped.
                    import warnings

                    warnings.warn(
                        f"a sample block shorter than the detection halo "
                        f"({halo} frames) arrived mid-stream: pulses "
                        f"straddling it may be dropped; use blocks of at "
                        f"least halo length", stacklevel=2,
                    )
                h = min(halo, mag.shape[0])
                short_halo = h < halo
                batch, a, b = flush(
                    pending, (mag[:h], ph[:h], sat[:h]), pending[0].shape[0], entry
                )
                entry = jnp.where(entry, b, a)
                results.append(jax.tree.map(np.asarray, batch))
                offsets.append(offset)
                offset += int(pending[0].shape[0])
            pending = (mag, ph, sat)

        if pending is not None:
            # Final block: +inf halo = "capture ends here" (open pulses die).
            t_end = pending[0].shape[0]
            inf = jnp.full((1, m), jnp.inf, pending[0].dtype)
            batch, _, _ = flush(
                pending,
                (inf, jnp.zeros((1, m), pending[1].dtype), jnp.zeros((1, m), bool)),
                t_end,
                entry,
            )
            results.append(jax.tree.map(np.asarray, batch))
            offsets.append(offset)

        return self._finalize(results, offsets, fs, fc, sample_start_time)

    def extract_segment(
        self,
        segment: Segment,
        fc: float = 0.0,
        noise_floor: Union[str, np.ndarray] = "two_pass",
        checkpoint_dir: Optional[str] = None,
    ) -> dict:
        """Block-random-access extraction over a :class:`Segment`, with
        optional checkpoint/resume.

        Each ``block_frames``-frame block is processed independently: its
        FIR history is re-read from the raw samples (frames ``[F-(P-1),
        F)``), its right halo is channelized alongside it, and its latch
        entry state is the composition of all previous blocks' stored
        transfer functions — so a killed job resumes at the first
        unprocessed block with zero recomputation and bit-identical output
        (the framework analog of the reference's one-file-per-dwell
        resumability, SURVEY.md section 5.4).  Checkpoints are one ``.npz``
        per block keyed by block index plus a ``noise_floor.npz``.
        """
        import os

        fs = segment.headers[0].sample_rate_sps
        t0 = segment.start_time
        wideband = self.channelizer is None
        m = 1 if wideband else self.channelizer.num_bands
        p = 1 if wideband else self.channelizer.taps_per_band
        cfg = self.pdw_cfg
        halo = self._halo
        block = self.block_frames
        n_frames = segment.num_samples // m
        n_blocks = max((n_frames + block - 1) // block, 1)

        ck = checkpoint_dir
        if ck:
            os.makedirs(ck, exist_ok=True)

        def _ck_path(k):
            return os.path.join(ck, f"block_{k:06d}.npz") if ck else None

        # Noise floor (checkpointed once).
        if isinstance(noise_floor, str) and noise_floor == "two_pass":
            nf_path = os.path.join(ck, "noise_floor.npz") if ck else None
            if nf_path and os.path.exists(nf_path):
                nf = jnp.asarray(np.load(nf_path)["nf"])
            else:
                nf = jnp.asarray(
                    self.measure_noise_floor(
                        lambda: segment.iter_samples(block * m)
                    )
                )
                if nf_path:
                    np.savez(nf_path, nf=np.asarray(nf))
        else:
            nf = jnp.asarray(noise_floor)

        field_names = ("toa_idx", "te_idx", "pw_sec", "mag", "snr_db",
                       "freq_offset_hz", "saturated", "valid", "count")
        results, offsets = [], []
        entry = jnp.zeros((m,), bool)
        for k in range(n_blocks):
            f0 = k * block
            t_k = min(block, n_frames - f0)
            path = _ck_path(k)
            self.counters.add("blocks_processed")
            self.counters.add("samples_ingested", t_k * m)
            if path and os.path.exists(path):
                z = np.load(path)
                batch = pdwmod.PdwBatch(**{n: z[n] for n in field_names})
                a_blk, b_blk = jnp.asarray(z["a"]), jnp.asarray(z["b"])
                self.counters.add("blocks_resumed_from_checkpoint")
            else:
                h_k = min(halo, n_frames - f0 - t_k)
                hist_frames = min(p - 1, f0)
                raw = segment.read_samples(
                    (f0 - hist_frames) * m, (hist_frames + t_k + h_k) * m
                ).reshape(-1, m)
                if wideband:
                    y = jnp.asarray(raw)
                else:
                    hist = jnp.zeros((p, m), jnp.complex64)
                    if hist_frames:
                        hist = hist.at[p - hist_frames:].set(raw[:hist_frames])
                    from sdr_channelizer_tpu.dsp.channelizer import (
                        _fir_branches, extract_channels,
                    )
                    u = _fir_branches(jnp.asarray(raw[hist_frames:]), hist,
                                      jnp.asarray(self.channelizer.taps_rev))
                    y = extract_channels(u, m)
                mag, ph, sat = pdwmod._prep_streams(y, cfg.saturation_level)
                if h_k < 1:  # capture ends at this block: +inf pad
                    mag = jnp.concatenate([mag, jnp.full((1, m), jnp.inf, mag.dtype)])
                    ph = jnp.concatenate([ph, jnp.zeros((1, m), ph.dtype)])
                    sat = jnp.concatenate([sat, jnp.zeros((1, m), bool)])
                batch, a_blk, b_blk = self._detect_block(
                    mag, ph, sat, nf, entry, own_len=t_k
                )
                batch = jax.tree.map(np.asarray, batch)
                if path:
                    np.savez(
                        path, a=np.asarray(a_blk), b=np.asarray(b_blk),
                        **{n: getattr(batch, n) for n in field_names},
                    )
            entry = jnp.where(entry, jnp.asarray(b_blk), jnp.asarray(a_blk))
            results.append(batch)
            offsets.append(f0)
        return self._finalize(results, offsets, fs, fc, t0)

    def _finalize(self, results, offsets, fs, fc, sample_start_time) -> dict:
        wideband = self.channelizer is None
        m = 1 if wideband else self.channelizer.num_bands
        fields = {}
        for name in ("toa_idx", "te_idx", "pw_sec", "mag", "snr_db",
                     "freq_offset_hz", "saturated", "valid", "count"):
            parts = []
            for batch, off in zip(results, offsets):
                v = getattr(batch, name)
                if name in ("toa_idx", "te_idx"):
                    v = np.where(batch.valid, v.astype(np.int64) + off, -1)
                parts.append(v)
            if name == "count":
                fields[name] = np.sum(parts, axis=0)
            else:
                fields[name] = np.concatenate(parts, axis=1)  # (M, total)
        merged = pdwmod.PdwBatch(**fields)
        self.counters.add("pulses_emitted", int(np.sum(fields["valid"])))
        return pdwmod.finalize_pdws(
            merged,
            fs=fs / m,
            fc=fc,
            sample_start_time=sample_start_time,
            bin_offsets_hz=(None if wideband
                            else self.channelizer.center_frequencies(fs)),
        )
