#!/usr/bin/env python
"""On-card smoke check: the channelize -> PDW main path on one GPU.

    python chip_smoke.py          # one card: phases 1-4, then the result line
    python chip_smoke.py --four   # four cards: the sharded phase only

Every phase runs in this one process (a second JAX process could not get
the card's memory) and raises on the first failed check, so the script
exits non-zero unless all of them pass.  With no GPU it exits non-zero and
prints no result.

Phases (one card):

1. card — ``nvidia-smi`` name and power limit, JAX version and devices;
2. CLI — ``generate`` a 0.3 s 56 Msps ground-truth capture and run
   ``pdw --channelized --bands 56`` on it in-process; count, TOA, PW, PRI
   and frequency against the spec;
3. headline — the dense and sparse bench scenes (M=64, 262,144 frames =
   16.78 M samples, packed int16) through ``extract_fused`` on the card,
   each compared with the plain reference (``forward_reference``: FFT +
   sort medians) run on the CPU; compile time, a warm step, memory;
4. reach — M=560 (0.1 MHz bins), an int8 payload at M=56, ``pdw --stream``
   over a two-file capture longer than one block against the single-shot
   result, and three ``track`` dwells against the emulator.

``--four``: ``ShardedPipeline.extract`` and ``extract_fused`` on 4x1 and
2x2 (time x chan) meshes at bench size, each compared with the one-card
result.

The last line of standard output is the JSON result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

import numpy as np

# Tolerances of a card result against the CPU reference (cuFFT and the
# CPU's FFT round differently, by ~1e-7 of a frame's energy):
# * mag: a median of channel magnitudes, each off by ~1e-7 relative for a
#   bin-centred tone over the noise -> rtol 1e-5;
# * snr: 10*log10(mag/nf) moves by 4.34 dB per unit relative error of
#   either -> atol 1e-4 dB;
# * freq: a median phase difference off by ~1e-3 degrees for noise-level
#   bins -> atol 1e-5 of the decimated rate (10 Hz at 1 MHz bins).
MAG_RTOL = 1e-5
SNR_ATOL_DB = 1e-4
FREQ_ATOL_FRAC = 1e-5
# Dense scenes put 1-2 sample transients on the threshold by construction;
# such a pulse may flip between two correct FFTs.
DENSE_MAX_DIFF_FRAC = 1e-3
EDGE_THRESH_RTOL = 1e-5
# Divides every capture length; 1 on the card.  A rehearsal on the CPU
# calls the phase functions with a larger value.
SCALE = 1


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    log(f"== {name}")
    yield
    log(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)")


def run_cli(argv) -> str:
    """``cli.main.main(argv)`` in this process; returns its stdout."""
    from sdr_channelizer_tpu.cli.main import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(list(argv))
    check(rc == 0, f"cli {argv[0]} returned {rc}")
    return buf.getvalue()


def compare_pdws(got: dict, ref: dict, fs_dec: float, max_pulses: int):
    """Match card PDWs to reference PDWs by (channel, toa, pw).  Returns
    (differing keys, matched index pairs); channels at slot capacity are
    compared up to the earlier of their two last TOAs (a flipped pulse
    shifts which pulse falls off the end)."""
    def index(p):
        return {(int(c), int(round(t * fs_dec)), int(round(w * fs_dec))): i
                for i, (c, t, w) in enumerate(zip(p["channel"], p["toa"],
                                                  p["pw"]))}

    gi, ri = index(got), index(ref)
    cut = {}
    for c in set(int(c) for c in np.concatenate([got["channel"], ref["channel"]])):
        ng = int(np.sum(got["channel"] == c))
        nr = int(np.sum(ref["channel"] == c))
        if max(ng, nr) >= max_pulses:
            last_g = max(k[1] for k in gi if k[0] == c)
            last_r = max(k[1] for k in ri if k[0] == c)
            cut[c] = min(last_g, last_r)
    keep = lambda k: k[0] not in cut or k[1] <= cut[k[0]]
    diff = {k for k in set(gi) ^ set(ri) if keep(k)}
    matched = [(gi[k], ri[k]) for k in set(gi) & set(ri)]
    return diff, matched


def stat_diffs(got, ref, matched, fs_dec):
    g = np.asarray([i for i, _ in matched], int)
    r = np.asarray([j for _, j in matched], int)
    if not len(g):
        return 0.0, 0.0, 0.0
    mag = np.max(np.abs(got["mag"][g] - ref["mag"][r])
                 / np.maximum(np.abs(ref["mag"][r]), 1e-30))
    snr = np.max(np.abs(got["snr"][g] - ref["snr"][r]))
    freq = np.max(np.abs(got["freq"][g] - ref["freq"][r])) / fs_dec
    sat = bool(np.all(got["sat"][g] == ref["sat"][r]))
    check(sat, "saturation flags differ on matched pulses")
    return float(mag), float(snr), float(freq)


def reference_on_cpu(pipe, payload, bit_width):
    """(nf, batch, mag) of the plain reference on the CPU device."""
    import jax
    import jax.numpy as jnp

    from sdr_channelizer_tpu.dsp.channelizer import channelize
    from sdr_channelizer_tpu.io import iqpacket

    cpu = jax.devices("cpu")[0]
    x = jax.device_put(iqpacket.to_complex(payload, bit_width), cpu)
    nf, batch = jax.jit(pipe.forward_reference)(x)
    mag = jax.jit(lambda v: jnp.abs(channelize(v, pipe.channelizer,
                                               method="fft")))(x)
    return np.asarray(nf), batch, np.asarray(mag)


def finalize(pipe, batch, fs):
    from sdr_channelizer_tpu.dsp.pdw import finalize_pdws

    m = pipe.channelizer.num_bands
    return finalize_pdws(batch, fs=fs / m,
                         bin_offsets_hz=pipe.channelizer.center_frequencies(fs))


def check_against_reference(name, pipe, got, payload, bit_width, fs,
                            exact: bool):
    """Card PDWs vs the CPU reference.  ``exact``: equal pulse sets;
    otherwise under ``DENSE_MAX_DIFF_FRAC`` differing pulses, each with a
    sample within ``EDGE_THRESH_RTOL`` of the threshold."""
    cfg = pipe.pdw_cfg
    m = pipe.channelizer.num_bands
    fs_dec = fs / m
    nf, batch, mag = reference_on_cpu(pipe, payload, bit_width)
    ref = finalize(pipe, batch, fs)
    diff, matched = compare_pdws(got, ref, fs_dec, cfg.max_pulses)
    n = max(len(ref["toa"]), 1)
    d_mag, d_snr, d_freq = stat_diffs(got, ref, matched, fs_dec)
    log(f"{name}: card {len(got['toa'])} pulses, reference {len(ref['toa'])}, "
        f"differing {len(diff)} ({len(diff) / n:.2e}); matched max |dmag|/mag "
        f"{d_mag:.2e}, |dsnr| {d_snr:.2e} dB, |dfreq| {d_freq:.2e} x fs_dec")
    if exact:
        check(len(got["toa"]) == len(ref["toa"]) and not diff,
              f"{name}: pulse sets differ: {sorted(diff)[:10]}")
        check(d_mag <= MAG_RTOL, f"{name}: mag off by {d_mag:.2e}")
        check(d_snr <= SNR_ATOL_DB, f"{name}: snr off by {d_snr:.2e} dB")
        check(d_freq <= FREQ_ATOL_FRAC, f"{name}: freq off by {d_freq:.2e}")
        return
    check(len(diff) <= DENSE_MAX_DIFF_FRAC * n,
          f"{name}: {len(diff)} differing pulses of {n}")
    thr = nf * 10.0 ** (cfg.snr_threshold_db / 10.0)
    for c, t0, w in diff:
        lo, hi = max(t0 - 1, 0), min(t0 + w + 2, mag.shape[0])
        near = np.abs(mag[lo:hi, c] - thr[c]) <= EDGE_THRESH_RTOL * thr[c]
        check(bool(np.any(near)),
              f"{name}: differing pulse (channel {c}, toa {t0}, pw {w}) has "
              f"no sample within {EDGE_THRESH_RTOL} of the threshold")


def phase_card():
    import jax

    from sdr_channelizer_tpu.utils.device import card_name_and_power

    log(card_name_and_power())
    devs = jax.devices()
    log(f"jax {jax.__version__}; {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")


def phase_cli(tmp: str):
    from sdr_channelizer_tpu.dsp.channelizer import center_frequencies
    from sdr_channelizer_tpu.io import iqpacket
    from sdr_channelizer_tpu.signal.synth import PulseTrainSpec, pulse_starts

    fs, f0, m = 56e6, 7.3e6, 56
    dur = 0.3 / SCALE
    out = run_cli(["generate", "--out-dir", tmp, "--fs-msps", "56",
                   "--duration-sec", str(dur), "--freq-mhz", "7.3",
                   "--pw-us", "100", "--pri-us", "500", "--noise-std", "3e-3"])
    path = out.strip().splitlines()[-1]
    hdr, _ = iqpacket.read_iq(path)
    spec = PulseTrainSpec(sample_rate_sps=fs, duration_sec=dur,
                          frequency_hz=f0, pulse_width_sec=100e-6,
                          pri_sec=500e-6, noise_std=3e-3)
    check(hdr.num_samples == spec.num_samples, "capture length")
    pdw_npz = os.path.join(tmp, "pdw.npz")
    run_cli(["pdw", path, "--channelized", "--bands", str(m),
             "--max-pulses", "1024", "--out", pdw_npz])
    p = dict(np.load(pdw_npz))
    c0 = int(np.argmin(np.abs(center_frequencies(m, fs) - f0)))
    sel = (p["channel"] == c0) & (p["snr"] > 25)
    # group delay of the 12-tap/band prototype: M * 12 / 2 samples
    delay = m * 12 / 2 / fs
    starts = pulse_starts(spec)
    closed = starts + spec.pw_samples + 4 * m * 12 < spec.num_samples
    truth = (starts[closed] + 1) / fs
    toa = p["toa"][sel] - hdr.sample_start_time
    log(f"cli: {sel.sum()} pulses in channel {c0} vs {len(truth)} true")
    check(len(toa) == len(truth), "cli: pulse count")
    check(np.all(np.abs(toa - truth) <= delay), "cli: TOA")
    check(np.all(np.abs(p["pw"][sel] - 100e-6) <= m * 12 / fs), "cli: PW")
    check(np.all(np.abs(np.diff(toa) - 500e-6) <= 2 * m / fs), "cli: PRI")
    check(np.all(np.abs(p["freq"][sel] - f0) <= 0.01 * fs / m), "cli: freq")
    log(f"cli: TOA offset {np.median(toa - truth) * 1e6:.2f} us, PW "
        f"{np.median(p['pw'][sel]) * 1e6:.2f} us, PRI "
        f"{np.median(np.diff(toa)) * 1e6:.2f} us, freq "
        f"{np.median(p['freq'][sel]) / 1e6:.4f} MHz")


def phase_headline():
    import jax

    import bench
    from sdr_channelizer_tpu.config import PdwConfig
    from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline
    from sdr_channelizer_tpu.ops import ingest

    m, frames = 64, 262144 // SCALE
    n, fs = m * frames, m * 1e6
    pipe = ChannelizerPipeline.create(
        m, pdw_cfg=PdwConfig.channelized(max_pulses=512, max_pulse_samples=1024))
    dev = jax.devices()[0]
    step = jax.jit(pipe.forward_packed, static_argnames=("bit_width",))
    compiled = None
    for name, sparse in (("sparse", True), ("dense", False)):
        payload = bench.quantize(bench.make_capture(n, m, sparse=sparse))
        xq = jax.device_put(ingest.packed_view(payload), dev)
        if compiled is None:
            t0 = time.perf_counter()
            compiled = step.lower(xq, bit_width=12).compile()
            log(f"headline: compile {time.perf_counter() - t0:.1f} s; "
                f"{compiled.memory_analysis()}")
        jax.block_until_ready(compiled(xq))
        t0 = time.perf_counter()
        nf, _, batch = jax.block_until_ready(compiled(xq))
        dt = time.perf_counter() - t0
        log(f"headline {name}: warm step {dt * 1e3:.2f} ms "
            f"({n / dt / 1e6:.0f} Msamples/s); peak_bytes_in_use "
            f"{(dev.memory_stats() or {}).get('peak_bytes_in_use')}")
        got = finalize(pipe, batch, fs)
        check(np.all(np.isfinite(np.asarray(nf))), "non-finite noise floor")
        check_against_reference(f"headline {name}", pipe, got, payload, 12,
                                fs, exact=sparse)


def _tone_capture(n, fs, trains, amp, noise, seed=0):
    rng = np.random.default_rng(seed)
    t = np.arange(n)
    iq = (noise * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
          ).astype(np.complex64)
    for k, (f0, pw, pri) in enumerate(trains):
        tone = (amp * np.exp(2j * np.pi * f0 / fs * t)).astype(np.complex64)
        pw_n, pri_n = int(pw * fs), int(pri * fs)
        for s in range(137 + k * 1000, n - pw_n, pri_n):
            iq[s:s + pw_n] = tone[s:s + pw_n]
    return iq


def phase_reach(tmp: str):
    import jax

    from sdr_channelizer_tpu.config import PdwConfig
    from sdr_channelizer_tpu.io import iqpacket
    from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline

    fs = 56e6
    trains = [(1.0e6, 100e-6, 1e-3), (-8.0e6, 50e-6, 0.7e-3)]

    # M=560: 0.1 MHz bins at 56 Msps, bin-centred tones.
    m, n = 560, 560 * (10000 // SCALE)
    pipe = ChannelizerPipeline.create(
        m, pdw_cfg=PdwConfig.channelized(max_pulses=256, max_pulse_samples=256))
    payload = iqpacket.from_complex(_tone_capture(n, fs, trains, 0.02, 0.001), 12)
    got = pipe.extract_fused(payload, bit_width=12, fs=fs)
    check_against_reference("reach M=560", pipe, got, payload, 12, fs,
                            exact=False)

    # int8 payload (SC8_Q7) at M=56.
    m, n = 56, 56 * (100000 // SCALE)
    pipe = ChannelizerPipeline.create(
        m, pdw_cfg=PdwConfig.channelized(max_pulses=256, max_pulse_samples=256))
    payload = iqpacket.from_complex(_tone_capture(n, fs, trains, 0.3, 0.02), 8)
    check(payload.dtype == np.int8, "int8 payload")
    got = pipe.extract_fused(payload, bit_width=8, fs=fs)
    check_against_reference("reach int8 M=56", pipe, got, payload, 8, fs,
                            exact=False)

    # pdw --stream over two contiguous files (2 blocks of 65,536 frames).
    n_file = 56 * (50000 // SCALE)
    cap = _tone_capture(2 * n_file, fs, trains, 0.02, 0.001, seed=1)
    payload = iqpacket.from_complex(cap, 12)
    files = []
    for k in range(2):
        hdr = iqpacket.IqHeader(
            frequency_hz=0.0, bandwidth_hz=fs, sample_rate_sps=fs,
            rx_gain_db=0, num_samples=n_file, bit_width=12,
            sample_start_time=100.0 + k * n_file / fs)
        files.append(os.path.join(tmp, f"stream{k}.iq"))
        iqpacket.write_iq(files[-1], hdr, payload[k * n_file:(k + 1) * n_file])
    out = os.path.join(tmp, "stream.npz")
    run_cli(["pdw", "--stream", "--channelized", "--bands", "56",
             "--block-frames", str(65536 // SCALE), "--max-pulse-samples",
             "1024", *files, "--out", out])
    got = dict(np.load(out))
    pipe = ChannelizerPipeline.create(
        56, pdw_cfg=PdwConfig.channelized(max_pulses=512, max_pulse_samples=1024))
    ref = pipe.extract_fused(payload, bit_width=12, fs=fs,
                             sample_start_time=100.0)
    log(f"reach stream: {len(got['toa'])} pulses streamed, "
        f"{len(ref['toa'])} single-shot")
    check(len(got["toa"]) == len(ref["toa"]) > 0, "stream: pulse count")
    for key in ("toa", "pw", "mag", "sat", "channel"):
        check(np.array_equal(got[key], ref[key]), f"stream: {key} differs")
    check(np.allclose(got["freq"], ref["freq"], rtol=0,
                      atol=FREQ_ATOL_FRAC * fs / 56), "stream: freq")
    check(np.allclose(got["snr"], ref["snr"], rtol=0, atol=SNR_ATOL_DB),
          "stream: snr")

    # Three 80 ms dwells of the closed-loop event tracker (0.2 % duty: the
    # tracker's mean noise floor self-jams above ~0.5 %).
    dwell = 0.08 / SCALE
    lines = run_cli(["track", "1000", "56", "56", "40", str(dwell),
                     str(3 * dwell),
                     "--pw-us", "10", "--pri-us", "5000"]).splitlines()
    dwells = [ln for ln in lines if "pulses=" in ln]
    for ln in dwells:
        log(f"reach track: {ln}")
    check(len(dwells) == 3, "track: dwell count")
    check(all(int(ln.split("pulses=")[1].split()[0]) > 0 for ln in dwells),
          "track: a dwell without pulses")


def phase_four():
    import jax

    import bench
    from sdr_channelizer_tpu.config import PdwConfig
    from sdr_channelizer_tpu.io import iqpacket
    from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline
    from sdr_channelizer_tpu.parallel import make_mesh
    from sdr_channelizer_tpu.parallel.pipeline import ShardedPipeline

    devs = jax.devices()
    check(len(devs) >= 4, f"--four needs 4 devices, found {len(devs)}")
    m, frames = 64, 262144 // SCALE
    n, fs = m * frames, m * 1e6
    # Sharded PDWs equal one card's while no (shard, channel) fills its
    # slots: each shard has max_pulses of its own.  The dense scene has
    # ~1.2k pulses per channel, so the slots exceed that here.
    cfg = PdwConfig.channelized(max_pulses=2048, max_pulse_samples=1024)
    single = ChannelizerPipeline.create(m, pdw_cfg=cfg)
    for name, sparse in (("sparse", True), ("dense", False)):
        payload = bench.quantize(bench.make_capture(n, m, sparse=sparse))
        x = iqpacket.to_complex(payload, 12)
        refs = {"extract": single.extract(x, fs=fs),
                "extract_fused": single.extract_fused(payload, bit_width=12,
                                                      fs=fs)}
        for shape in ((4, 1), (2, 2)):
            mesh = make_mesh(n_time=shape[0], n_chan=shape[1],
                             devices=devs[:4])
            sp = ShardedPipeline(mesh, single.channelizer, cfg)
            for entry in ("extract", "extract_fused"):
                t0 = time.perf_counter()
                got = (sp.extract(x, fs=fs) if entry == "extract" else
                       sp.extract_fused(payload, bit_width=12, fs=fs))
                dt = time.perf_counter() - t0
                ref = refs[entry]
                same = {k: bool(np.array_equal(got[k], ref[k]))
                        for k in ("toa", "pw", "mag", "sat", "channel")}
                d_freq = d_snr = float("nan")
                if len(got["toa"]) == len(ref["toa"]):
                    d_freq = float(np.max(np.abs(got["freq"] - ref["freq"])))
                    d_snr = float(np.max(np.abs(got["snr"] - ref["snr"])))
                log(f"four {name} {shape} {entry}: {len(got['toa'])} vs "
                    f"{len(ref['toa'])} pulses, exact {same}, max |dfreq| "
                    f"{d_freq:.3g} Hz, |dsnr| {d_snr:.3g} dB "
                    f"(first call incl. compile {dt:.1f} s)")
                check(all(same.values()),
                      f"four {name} {shape} {entry}: fields differ {same}")
                check(d_freq <= FREQ_ATOL_FRAC * fs / m
                      and d_snr <= SNR_ATOL_DB,
                      f"four {name} {shape} {entry}: freq/snr")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()

    import jax

    from sdr_channelizer_tpu.utils.compile_cache import enable_compile_cache
    from sdr_channelizer_tpu.utils.device import device_summary

    enable_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's default backend is "
              f"{devs[0].platform!r})", file=sys.stderr)
        return 2

    with phase("card"):
        phase_card()
    if args.four:
        with phase("four"):
            phase_four()
    else:
        with tempfile.TemporaryDirectory() as tmp:
            with phase("cli"):
                phase_cli(tmp)
            with phase("headline"):
                phase_headline()
            with phase("reach"):
                phase_reach(tmp)
    print(json.dumps({"ok": True, "device": device_summary()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
