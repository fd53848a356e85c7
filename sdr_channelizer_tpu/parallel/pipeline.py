"""Sharded channelize -> PDW pipeline over a (time x chan) mesh.

The reference processes captures single-device (MATLAB loops,
``create_pdws_channelized.m:79-136``); this module is the multi-device
scale-out path.  Design:

* **Time sharding (sequence-parallel analog).**  The sample axis splits into
  contiguous blocks, one per mesh row.  The polyphase FIR needs the previous
  ``P-1`` frames of history (prototype length ``M*P`` taps,
  ``create_pdws_channelized.m:31-33``) — each shard ``ppermute``s its tail
  frames to its right neighbor (overlap-save; on GPUs XLA hands the
  ``ppermute`` to NCCL over NVLink), so block outputs
  concatenate to exactly the unsharded channelizer output (zero initial
  state, matching MATLAB System-object semantics).

* **Channel sharding (tensor-parallel analog).**  Each mesh column owns a
  slice of the bands and all downstream PDW work for them.  Every column
  transforms all branches and keeps its slice, so the output is
  bit-identical to the single-device path.

* **Exact PDW stitching.**  The detector's pulse-active hysteresis latch is
  a composition of per-sample boolean transfer functions
  (``dsp/pdw.py:hysteresis_fns``).  Each shard computes its block's total
  transfer function, an ``all_gather`` + exclusive prefix composition yields
  every block's entry state, and each shard re-evaluates its local scan
  seeded with that state.  A pulse is emitted by the shard owning its
  leading edge; its trailing edge and statistics may extend into a right
  halo (the next shard's head samples, fetched with ``ppermute``).  The last
  shard's halo is +inf magnitude so a pulse still active at capture end is
  never emitted — the reference rule.  Result: sharded PDWs == unsharded
  PDWs, bit-for-bit, as long as the halo exceeds the longest pulse.

* **Noise floor.**  The reference uses the median magnitude over the whole
  capture per bin (``create_pdws_channelized.m:73``) — a global reduction;
  it is computed between the two shard_map stages with a plain
  ``jnp.median`` over the sharded array and XLA inserts the collectives.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.dsp import channelizer as chmod
from sdr_channelizer_tpu.dsp import pdw as pdwmod
from sdr_channelizer_tpu.ops import ingest, medians
from sdr_channelizer_tpu.dsp.pdw import PdwBatch
from sdr_channelizer_tpu.parallel.mesh import CHAN_AXIS, TIME_AXIS


def _cap_halo(halo: int, t_loc: int, strict: bool = False) -> int:
    """Cap the stitching halo at the shard block length, loudly.

    The bit-exact stitching contract requires the halo to exceed the
    longest pulse; when shard blocks are shorter than that, boundary-
    straddling pulses may be dropped relative to the single-device
    extractor — warn (or, with ``strict``, refuse) instead of silently
    shrinking.
    """
    if halo > t_loc:
        msg = (
            f"requested PDW stitching halo ({halo} frames) exceeds the "
            f"per-shard block length ({t_loc} frames)"
        )
        fix = (
            "use fewer/longer time shards, a smaller max_pulse_samples, "
            "or an explicit halo_frames"
        )
        if strict:
            raise ValueError(
                f"{msg}; pulses longer than the block could be dropped at "
                f"shard boundaries (halo_mode='strict') — {fix}"
            )
        import warnings

        warnings.warn(
            f"{msg}; capping to {t_loc}. Pulses longer than the block may "
            f"be dropped at shard boundaries — {fix}", stacklevel=3,
        )
        return t_loc
    return halo


def _fwd_perm(n: int):
    """ppermute pairs sending each shard's data to its right neighbor."""
    return [(j, j + 1) for j in range(n - 1)]


def _bwd_perm(n: int):
    """ppermute pairs sending each shard's data to its left neighbor."""
    return [(j + 1, j) for j in range(n - 1)]


def _build_channelize_local(chan, n_time: int, n_chan: int, t_loc: int):
    taps_np = chan.taps_rev  # (P, M) float32
    m = chan.num_bands
    if m % n_chan:
        raise ValueError(f"num_bands {m} not divisible by chan mesh axis {n_chan}")
    m_loc = m // n_chan

    def local(x_loc: jax.Array) -> jax.Array:
        frames = x_loc.reshape(t_loc, m)
        taps = jnp.asarray(taps_np)
        p = taps.shape[0]
        if p > 1:
            tail = frames[-(p - 1):]
            hist = jax.lax.ppermute(tail, TIME_AXIS, _fwd_perm(n_time))
            hist = jnp.concatenate([jnp.zeros((1, m), frames.dtype), hist])
        else:
            hist = jnp.zeros((1, m), frames.dtype)
        u = chmod._fir_branches(frames, hist, taps)
        # Every mesh column transforms all branches and keeps its band
        # slice: the same FFT as the single-device path, bit for bit.
        y = chmod.fft_extract(u)
        if n_chan == 1:
            return y
        c_i = jax.lax.axis_index(CHAN_AXIS)
        return jax.lax.dynamic_slice_in_dim(y, c_i * m_loc, m_loc, axis=1)

    return local


def _build_channelize_local_planes(chan, n_time: int, n_chan: int, t_loc: int):
    """Complex-free twin of :func:`_build_channelize_local`: float32
    real/imag planes in, the DFT as four real matmuls with column slices of
    ``Wr``/``Wi`` per mesh column — same numbers as
    ``dsp.channelizer.channelize_planes``."""
    taps_np = chan.taps_rev  # (P, M) float32
    m = chan.num_bands
    if m % n_chan:
        raise ValueError(f"num_bands {m} not divisible by chan mesh axis {n_chan}")
    m_loc = m // n_chan
    w = chmod.dft_matrix(m, shifted=True)
    wr_np = np.ascontiguousarray(np.real(w), np.float32)
    wi_np = np.ascontiguousarray(np.imag(w), np.float32)

    def local(xr_loc: jax.Array, xi_loc: jax.Array):
        taps = jnp.asarray(taps_np)
        p = taps.shape[0]

        def branches(plane):
            frames = plane.reshape(t_loc, m).astype(jnp.float32)
            if p > 1:
                tail = frames[-(p - 1):]
                hist = jax.lax.ppermute(tail, TIME_AXIS, _fwd_perm(n_time))
                hist = jnp.concatenate([jnp.zeros((1, m), frames.dtype), hist])
            else:
                hist = jnp.zeros((1, m), frames.dtype)
            return chmod._fir_branches(frames, hist, taps)

        ur, ui = branches(xr_loc), branches(xi_loc)
        c_i = jax.lax.axis_index(CHAN_AXIS)
        wr = jax.lax.dynamic_slice_in_dim(jnp.asarray(wr_np), c_i * m_loc, m_loc, axis=1)
        wi = jax.lax.dynamic_slice_in_dim(jnp.asarray(wi_np), c_i * m_loc, m_loc, axis=1)
        mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)
        yr = mm(ur, wr) - mm(ui, wi)
        yi = mm(ur, wi) + mm(ui, wr)
        return yr, yi

    return local


def _build_pdw_local(cfg: PdwConfig, n_time: int, t_loc: int, halo: int,
                     m_loc: int, planes: bool = False):
    core = functools.partial(
        pdwmod.extract_pdws_block_core,
        own_len=t_loc,
        snr_threshold_db=cfg.snr_threshold_db,
        trailing_threshold_db=cfg.trailing_threshold_db,
        max_pulses=cfg.max_pulses,
        max_pulse_samples=cfg.max_pulse_samples,
    )

    def local_streams(mag, ph, sat, nf_loc: jax.Array) -> PdwBatch:
        t_i = jax.lax.axis_index(TIME_AXIS)

        # Right halo: the next shard's first `halo` frames.  The last shard
        # (nothing to receive -> ppermute zeros) gets +inf magnitude so the
        # latch can never see a trailing edge past capture end.
        hm = jax.lax.ppermute(mag[:halo], TIME_AXIS, _bwd_perm(n_time))
        hp = jax.lax.ppermute(ph[:halo], TIME_AXIS, _bwd_perm(n_time))
        hs = jax.lax.ppermute(sat[:halo], TIME_AXIS, _bwd_perm(n_time))
        hm = jnp.where(t_i == n_time - 1, jnp.inf, hm)
        mag_e = jnp.concatenate([mag, hm], axis=0)
        ph_e = jnp.concatenate([ph, hp], axis=0)
        sat_e = jnp.concatenate([sat, hs], axis=0)

        # Cross-shard latch chaining: block transfer fns -> all_gather ->
        # exclusive prefix composition -> this block's entry state.
        a_blk, b_blk = pdwmod.block_transfer(
            mag.T, nf_loc[:, None],
            cfg.snr_threshold_db, cfg.trailing_threshold_db,
        )  # each (m_loc,)
        ag_a = jax.lax.all_gather(a_blk, TIME_AXIS)  # (n_time, m_loc)
        ag_b = jax.lax.all_gather(b_blk, TIME_AXIS)
        pa, _ = jax.lax.associative_scan(
            pdwmod.compose_transfer, (ag_a, ag_b), axis=0
        )
        prev = jnp.take(pa, jnp.maximum(t_i - 1, 0), axis=0)
        entry = jnp.where(t_i == 0, jnp.zeros((m_loc,), bool), prev)

        batch = jax.vmap(core, in_axes=(1, 1, 1, 0, 0))(
            mag_e, ph_e, sat_e, nf_loc, entry
        )
        # Leading (1, ...) axis so out_specs can stack blocks along time.
        return jax.tree.map(lambda v: v[None], batch)

    if planes:
        def local(yr_loc: jax.Array, yi_loc: jax.Array, nf_loc: jax.Array) -> PdwBatch:
            mag, ph, sat = pdwmod._prep_streams_planes(
                yr_loc, yi_loc, cfg.saturation_level
            )
            return local_streams(mag, ph, sat, nf_loc)
    else:
        def local(y_loc: jax.Array, nf_loc: jax.Array) -> PdwBatch:
            mag, ph, sat = pdwmod._prep_streams(y_loc, cfg.saturation_level)
            return local_streams(mag, ph, sat, nf_loc)

    return local


@dataclasses.dataclass
class ShardedPipeline:
    """Jitted channelize -> noise-floor -> PDW step over a (time, chan) mesh.

    ``halo_frames`` (decimated frames read past each block's right edge)
    must exceed the longest pulse for exact boundary stitching; defaults to
    ``pdw_cfg.max_pulse_samples`` and is capped at the block length
    (``halo_mode="warn"``) or refused when it does not fit
    (``halo_mode="strict"`` — guarantees the bit-exact stitching contract
    or an error, never a silent drop).
    """

    mesh: jax.sharding.Mesh
    channelizer: "chmod.Channelizer"
    pdw_cfg: PdwConfig
    halo_frames: Optional[int] = None
    halo_mode: str = "warn"

    @property
    def _strict_halo(self) -> bool:
        if self.halo_mode not in ("warn", "strict"):
            raise ValueError(f"unknown halo_mode {self.halo_mode!r}")
        return self.halo_mode == "strict"

    def __post_init__(self):
        self._cache = {}

    @property
    def n_time(self) -> int:
        return self.mesh.shape[TIME_AXIS]

    @property
    def n_chan(self) -> int:
        return self.mesh.shape[CHAN_AXIS]

    def _build(self, n_samples: int, to_complex=None):
        """Jitted sharded step over an ``n_samples`` capture.  With
        ``to_complex`` (a map from the step's inputs to the complex capture,
        e.g. the packed-payload dequant of ``ops.ingest``) the step takes
        those inputs and returns (noise_floor, batch); without it, it takes
        the complex capture and returns (chan_iq, noise_floor, batch)."""
        n_time, n_chan = self.n_time, self.n_chan
        m = self.channelizer.num_bands
        if m % n_chan:
            raise ValueError(
                f"num_bands {m} not divisible by chan mesh axis {n_chan}")
        if n_samples % (n_time * m):
            raise ValueError(
                f"capture length {n_samples} must divide into "
                f"{n_time} time shards of whole {m}-sample frames"
            )
        t_loc = n_samples // (n_time * m)
        halo = _cap_halo(self.halo_frames or self.pdw_cfg.max_pulse_samples,
                         t_loc, self._strict_halo)
        m_loc = m // n_chan

        chan_local = _build_channelize_local(self.channelizer, n_time, n_chan, t_loc)
        pdw_local = _build_pdw_local(self.pdw_cfg, n_time, t_loc, halo, m_loc)
        batch_specs = PdwBatch(
            **{f.name: P(TIME_AXIS, CHAN_AXIS) for f in dataclasses.fields(PdwBatch)}
        )

        def forward(x) -> Tuple[jax.Array, jax.Array, PdwBatch]:
            y = jax.shard_map(
                chan_local, mesh=self.mesh,
                in_specs=P(TIME_AXIS), out_specs=P(TIME_AXIS, CHAN_AXIS),
                check_vma=False,
            )(x)
            nf = medians.median(jnp.abs(y), axis=0)  # global per-band median
            batch = jax.shard_map(
                pdw_local, mesh=self.mesh,
                in_specs=(P(TIME_AXIS, CHAN_AXIS), P(CHAN_AXIS)),
                out_specs=batch_specs,
                check_vma=False,
            )(y, nf)
            return y, nf, batch

        if to_complex is None:
            return jax.jit(forward), t_loc

        @jax.jit
        def step(*inputs) -> Tuple[jax.Array, PdwBatch]:
            _, nf, batch = forward(to_complex(*inputs))
            return nf, batch

        return step, t_loc

    def _build_planes(self, n_samples: int):
        """Complex-free twin of :meth:`_build`: (xr, xi) planes in,
        (yr, yi, nf, batch) out (the multi-device form of
        ``models.pipeline.ChannelizerPipeline.forward_planes``)."""
        n_time, n_chan = self.n_time, self.n_chan
        m = self.channelizer.num_bands
        if n_samples % (n_time * m):
            raise ValueError(
                f"capture length {n_samples} must divide into "
                f"{n_time} time shards of whole {m}-sample frames"
            )
        t_loc = n_samples // (n_time * m)
        halo = _cap_halo(self.halo_frames or self.pdw_cfg.max_pulse_samples,
                         t_loc, self._strict_halo)
        m_loc = m // n_chan

        chan_local = _build_channelize_local_planes(
            self.channelizer, n_time, n_chan, t_loc
        )
        pdw_local = _build_pdw_local(
            self.pdw_cfg, n_time, t_loc, halo, m_loc, planes=True
        )
        batch_specs = PdwBatch(
            **{f.name: P(TIME_AXIS, CHAN_AXIS) for f in dataclasses.fields(PdwBatch)}
        )

        @jax.jit
        def step(xr, xi):
            yr, yi = jax.shard_map(
                chan_local, mesh=self.mesh,
                in_specs=(P(TIME_AXIS), P(TIME_AXIS)),
                out_specs=(P(TIME_AXIS, CHAN_AXIS), P(TIME_AXIS, CHAN_AXIS)),
                check_vma=False,
            )(xr, xi)
            nf = medians.median(jnp.sqrt(yr * yr + yi * yi), axis=0)
            batch = jax.shard_map(
                pdw_local, mesh=self.mesh,
                in_specs=(P(TIME_AXIS, CHAN_AXIS), P(TIME_AXIS, CHAN_AXIS),
                          P(CHAN_AXIS)),
                out_specs=batch_specs,
                check_vma=False,
            )(yr, yi, nf)
            return yr, yi, nf, batch

        return step, t_loc

    def _cached(self, key, n_samples: int, to_complex=None):
        if key not in self._cache:
            self._cache[key] = self._build(n_samples, to_complex)
        return self._cache[key]

    def step_fused(self, xr: jax.Array, xi: jax.Array, bit_width: int = 0):
        """Run the sharded pipeline on integer (``bit_width`` > 0) or float
        I/Q sample planes.  Returns (noise_floor, batch)."""
        n = int(np.shape(xr)[-1])
        fn, _ = self._cached(
            ("planes", n, bit_width), n,
            functools.partial(ingest.planes_complex, bit_width=bit_width))
        return fn(xr, xi)

    def step_packed(self, xq: jax.Array, bit_width: int = 12):
        """Run the sharded pipeline on the packed recorder payload
        (``samples.view(int32)`` of an (N, 2) int16 buffer, or
        ``view(int16)`` of int8), dequantized on the devices.  Returns
        (noise_floor, batch)."""
        n = int(np.shape(xq)[-1])
        fn, _ = self._cached(
            ("packed", n, bit_width), n,
            functools.partial(ingest.unpack_complex, bit_width=bit_width))
        return fn(xq)

    def extract_fused(
        self,
        samples: np.ndarray,
        bit_width: int,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        """Raw (N, 2) payload -> host PDW dict through the sharded graph
        (the multi-device twin of
        ``models.ChannelizerPipeline.extract_fused``)."""
        samples = np.ascontiguousarray(samples)
        if samples.dtype in (np.int16, np.int8):
            _, batch = self.step_packed(ingest.packed_view(samples),
                                        bit_width=bit_width)
        else:
            xr = np.ascontiguousarray(samples[:, 0], np.float32)
            xi = np.ascontiguousarray(samples[:, 1], np.float32)
            _, batch = self.step_fused(xr, xi, bit_width=bit_width)
        t_loc = int(np.shape(samples)[0]) // (self.n_time * self.channelizer.num_bands)
        return self._finalize_merged(batch, t_loc, fs, fc, sample_start_time)

    def _finalize_merged(self, batch: PdwBatch, block_len_frames: int,
                         fs: float, fc: float, sample_start_time: float) -> dict:
        """Merge a block-stacked batch and finalize to the host PDW dict
        (decimated rate, absolute times/frequencies)."""
        merged = merge_block_batches(batch, block_len_frames)
        m = self.channelizer.num_bands
        return pdwmod.finalize_pdws(
            merged,
            fs=fs / m,
            fc=fc,
            sample_start_time=sample_start_time,
            bin_offsets_hz=self.channelizer.center_frequencies(fs),
        )

    def step(self, x: jax.Array):
        """Run the sharded pipeline.  Returns (chan_iq, noise_floor, batch)
        with ``batch`` arrays stacked ``(n_time, M, max_pulses)``."""
        n = int(np.shape(x)[-1])
        fn, _ = self._cached(n, n)
        return fn(x)

    def step_planes(self, xr: jax.Array, xi: jax.Array):
        """Run the complex-free sharded pipeline on float32 sample planes.
        Returns (yr, yi, noise_floor, batch)."""
        n = int(np.shape(xr)[-1])
        key = ("planes", n)
        if key not in self._cache:
            self._cache[key] = self._build_planes(n)
        fn, _ = self._cache[key]
        return fn(xr, xi)

    def extract_planes(
        self,
        iq: np.ndarray,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        """Host complex capture -> host PDW dict through the complex-free
        sharded graph (planes split on the host)."""
        xr = np.ascontiguousarray(np.real(iq), np.float32)
        xi = np.ascontiguousarray(np.imag(iq), np.float32)
        n = int(np.shape(xr)[-1])
        key = ("planes", n)
        if key not in self._cache:
            self._cache[key] = self._build_planes(n)
        fn, t_loc = self._cache[key]
        _, _, _, batch = fn(xr, xi)
        return self._finalize_merged(batch, t_loc, fs, fc, sample_start_time)

    def extract(
        self,
        x: jax.Array,
        fs: float,
        fc: float = 0.0,
        sample_start_time: float = 0.0,
    ) -> dict:
        """Full capture -> host PDW dict (decimated-rate TOAs/PWs, absolute
        frequencies), matching ``create_pdws_channelized.m`` semantics."""
        n = int(np.shape(x)[-1])
        fn, t_loc = self._cached(n, n)
        _, _, batch = fn(x)
        return self._finalize_merged(batch, t_loc, fs, fc, sample_start_time)


def merge_block_batches(batch: PdwBatch, block_len_frames: int) -> PdwBatch:
    """Merge a block-stacked ``(n_time, M, max_pulses)`` batch into a
    per-channel ``(M, n_time*max_pulses)`` batch with capture-global sample
    indices (host-side numpy)."""
    f = lambda v: np.asarray(v)
    toa, te, valid = f(batch.toa_idx), f(batch.te_idx), f(batch.valid)
    nt = toa.shape[0]
    off = (np.arange(nt, dtype=np.int64) * block_len_frames)[:, None, None]
    tr = lambda v: np.moveaxis(v, 0, 1).reshape(v.shape[1], -1)
    return PdwBatch(
        toa_idx=tr(np.where(valid, toa + off, -1)),
        te_idx=tr(np.where(valid, te + off, -1)),
        pw_sec=tr(f(batch.pw_sec)),
        mag=tr(f(batch.mag)),
        snr_db=tr(f(batch.snr_db)),
        freq_offset_hz=tr(f(batch.freq_offset_hz)),
        saturated=tr(f(batch.saturated)),
        valid=tr(valid),
        count=f(batch.count).sum(axis=0),
    )


def sharded_extract_pdws(
    x: jax.Array,
    cfg: PdwConfig,
    mesh: jax.sharding.Mesh,
    halo_samples: Optional[int] = None,
    strict_halo: bool = False,
) -> Tuple[PdwBatch, int]:
    """Time-sharded **wideband** PDW extraction (``create_pdws.m`` under
    sharding): full-rate stream split across the time axis, scalar global
    median noise floor, latch chained across shards, halo-stitched pulses.

    Returns ``(batch, block_len)`` with batch arrays ``(n_time, 1,
    max_pulses)``; merge with :func:`merge_block_batches` and finalize with
    ``finalize_pdws``.  Requires a chan axis of size 1.
    """
    n_time = mesh.shape[TIME_AXIS]
    if mesh.shape[CHAN_AXIS] != 1:
        raise ValueError("wideband sharded extraction uses a (n_time, 1) mesh")
    n = int(np.shape(x)[-1])
    if n % n_time:
        raise ValueError(f"{n} samples not divisible by {n_time} time shards")
    t_loc = n // n_time
    halo = _cap_halo(halo_samples or cfg.max_pulse_samples, t_loc, strict_halo)
    pdw_local = _build_pdw_local(cfg, n_time, t_loc, halo, m_loc=1)
    batch_specs = PdwBatch(
        **{f.name: P(TIME_AXIS, CHAN_AXIS) for f in dataclasses.fields(PdwBatch)}
    )

    @jax.jit
    def step(xv):
        nf = medians.median(jnp.abs(xv))[None]  # scalar -> (1,) channel vector
        batch = jax.shard_map(
            pdw_local, mesh=mesh,
            in_specs=(P(TIME_AXIS, None), P(None)),
            out_specs=batch_specs,
            check_vma=False,
        )(xv[:, None], nf)
        return batch

    return step(x), t_loc


def sharded_channelize(
    x: jax.Array,
    chan: "chmod.Channelizer",
    mesh: jax.sharding.Mesh,
) -> jax.Array:
    """Standalone time/channel-sharded channelizer (exact overlap-save).

    Output equals ``dsp.channelizer.channelize(x, chan)`` bit for bit.
    """
    n_time = mesh.shape[TIME_AXIS]
    n_chan = mesh.shape[CHAN_AXIS]
    m = chan.num_bands
    n = int(np.shape(x)[-1])
    n_frames = n // m
    if n_frames % n_time:
        raise ValueError(f"{n_frames} frames not divisible by {n_time} time shards")
    x = x[..., : n_frames * m]
    t_loc = n_frames // n_time
    local = _build_channelize_local(chan, n_time, n_chan, t_loc)
    fn = jax.jit(
        jax.shard_map(
            local, mesh=mesh,
            in_specs=P(TIME_AXIS), out_specs=P(TIME_AXIS, CHAN_AXIS),
            check_vma=False,
        )
    )
    return fn(x)
