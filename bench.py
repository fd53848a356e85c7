#!/usr/bin/env python
"""Headline benchmark: end-to-end channelize -> PDW throughput on one GPU.

Measures complex Msamples/s through the flagship pipeline (64-band polyphase
channelizer + per-band noise floor + PDW extraction — the compiled
``create_pdws_channelized.m`` chain) on the raw recorder payload (packed
int16 I/Q, dequantized on the device), at TWO operating points:

* **dense**: tones mid-transition-band at full scale — every channel's
  512-pulse slot capacity nearly saturates with 1-2 sample edge transients
  (the worst case for the per-pulse statistics);
* **sparse**: the reference's actual fixture regime
  (generate_training_iq.m:16-22 — a few hundred real pulses, two active
  channels) — bin-centered tones 24 dB over the noise floor.

The reference's implied operating point is keeping up with a 56 Msps radio
(BASELINE.md); ``vs_baseline`` is the multiple of that floor the DENSE
point sustains.

Timing: the step is compiled once (reported as set-up), warmed up, then
run ``--reps`` times, each rep timed on the host clock around a call that
ends in ``block_until_ready``; the median and quartiles are reported.

Options: ``--trace DIR`` writes a ``jax.profiler`` trace of a few steps of
each scene and prints the device time per layer (the ``jax.named_scope``
names of ``models/pipeline.py`` and ``dsp/pdw.py``); ``--routes`` times
the alternatives behind the route (FFT vs DFT matmul, sort vs
radix-select medians for the noise floor and the per-pulse windows)
layer by layer and end to end.

Needs a GPU: with no GPU it exits non-zero.  Prints exactly one JSON line
to stdout; diagnostics go to stderr.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

import numpy as np

LAYERS = ("ingest", "channelize", "streams", "noise_floor", "latch",
          "edge_search", "pulse_stats")


def _log(msg: str) -> None:
    print(f"bench: {msg}", file=sys.stderr, flush=True)


def make_capture(n: int, bands: int, sparse: bool = False) -> np.ndarray:
    """The dense or sparse bench scene: complex64, 1 MHz bins at
    ``fs = bands * 1 MHz``."""
    rng = np.random.default_rng(0)
    fs = bands * 1e6
    t = np.arange(n)
    iq = (0.001 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(
        np.complex64
    )
    if sparse:
        # Bin-centered tones 24 dB over the per-channel noise floor: the
        # detector recovers exactly the real pulses (~680 over 262 ms, two
        # active channels, no edge transients).
        amp, trains = 0.02, [(1.0e6, 100e-6, 1e-3), (-8.0e6, 50e-6, 0.7e-3)]
    else:
        # Full-scale tones mid-transition-band: every channel catches
        # broadband edge clicks and threshold-hovering leakage — ~32k
        # 1-2 sample pulses/step, the dense worst case.
        amp, trains = 1.0, [(1.3e6, 100e-6, 1e-3), (-7.6e6, 50e-6, 0.7e-3)]
    for k, (f0, pw, pri) in enumerate(trains):
        tone = (amp * np.exp(2j * np.pi * f0 / fs * t)).astype(np.complex64)
        pw_n, pri_n = int(pw * fs), int(pri * fs)
        for s in range(137 + k * 1000, n - pw_n, pri_n):
            iq[s : s + pw_n] = tone[s : s + pw_n]
    return iq


def quantize(cap: np.ndarray) -> np.ndarray:
    """complex64 [-1,1) -> interleaved Q11 int16 pairs (the recorder payload)."""
    return np.clip(np.round(np.stack([cap.real, cap.imag], -1) * 2048),
                   -2048, 2047).astype(np.int16)


def time_step(fn, args, reps: int, warmup: int = 2):
    """Per-rep seconds of ``fn(*args)`` to ``block_until_ready``, after
    ``warmup`` untimed calls."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return np.asarray(times)


def _quartiles(times: np.ndarray) -> dict:
    q1, q2, q3 = np.percentile(times, [25, 50, 75])
    return {"median_ms": q2 * 1e3, "q1_ms": q1 * 1e3, "q3_ms": q3 * 1e3,
            "reps": int(len(times))}


def _norm(name: str) -> str:
    return re.sub(r"[.\-]", "_", name)


def scope_map(hlo_text: str) -> dict:
    """HLO instruction name (normalized) -> its ``op_name`` metadata, which
    carries the ``jax.named_scope`` path."""
    out = {}
    for m in re.finditer(r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name="([^"]*)"',
                         hlo_text, re.M):
        out[_norm(m.group(1))] = m.group(2)
    return out


def layer_times(trace_dir: str, scopes: dict) -> dict:
    """Device microseconds per layer (named scope) and in total from the
    newest ``.xplane.pb`` under ``trace_dir``: each device event's duration
    is charged to the first layer name in its op's scope path (``scopes``,
    from :func:`scope_map`), else to "other"."""
    import jax

    paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                             recursive=True), key=os.path.getmtime)
    data = jax.profiler.ProfileData.from_file(paths[-1])
    per_layer: dict = {}
    per_op: dict = {}
    busy = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = list(plane.lines)
        # "XLA Ops" holds one event per executed HLO op; the per-stream
        # lines hold the same work as kernels — count one of them.
        ops = [ln for ln in lines if ln.name == "XLA Ops"] or [
            ln for ln in lines if ln.name.startswith("Stream")]
        for line in ops:
            for ev in line.events:
                path = scopes.get(_norm(ev.name), "") + "/"
                layer = next((ly for ly in LAYERS if f"/{ly}/" in path),
                             "other")
                dur = ev.duration_ns / 1e3
                per_layer[layer] = per_layer.get(layer, 0.0) + dur
                key = f"{ev.name} [{layer}]"
                per_op[key] = per_op.get(key, 0.0) + dur
                busy.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    busy.sort()
    union, end = 0.0, None
    span0 = busy[0][0] if busy else 0
    for a, b in busy:
        if end is None or a > end:
            union += b - a
            end = b
        elif b > end:
            union += b - end
            end = b
    span = (end - span0) if busy else 0
    top = sorted(per_op.items(), key=lambda kv: -kv[1])[:25]
    return {"per_layer_us": per_layer, "busy_us": union / 1e3,
            "span_us": span / 1e3, "top_ops_us": top}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--bands", type=int, default=64)
    ap.add_argument("--frames", type=int, default=262144,
                    help="channelizer frames per step (samples = frames*bands)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="write a profiler trace of each scene under DIR and "
                         "print device time per layer")
    ap.add_argument("--routes", action="store_true",
                    help="time both methods of each backend choice")
    args = ap.parse_args()
    if args.trace:
        # Kernels replayed from CUDA graphs show in the trace as one
        # command buffer; without them each kernel carries its op and scope.
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_gpu_enable_command_buffer=")

    import jax

    from sdr_channelizer_tpu.config import PdwConfig
    from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline
    from sdr_channelizer_tpu.ops import ingest
    from sdr_channelizer_tpu.utils.compile_cache import enable_compile_cache
    from sdr_channelizer_tpu.utils.device import (
        card_name_and_power,
        device_summary,
        require_gpu,
    )

    enable_compile_cache()
    dev = require_gpu()
    card = card_name_and_power()
    _log(f"card = {card}; device = {device_summary()}")

    n = args.bands * args.frames
    pipe = ChannelizerPipeline.create(
        args.bands,
        pdw_cfg=PdwConfig.channelized(max_pulses=512, max_pulse_samples=1024),
    )
    scenes = {}
    for name, sparse in (("dense", False), ("sparse", True)):
        payload = quantize(make_capture(n, args.bands, sparse=sparse))
        scenes[name] = jax.device_put(ingest.packed_view(payload), dev)

    step = jax.jit(pipe.forward_packed, static_argnames=("bit_width",))
    t0 = time.perf_counter()
    compiled = step.lower(scenes["dense"], bit_width=12).compile()
    compile_s = time.perf_counter() - t0
    _log(f"compile {compile_s:.1f} s; memory {compiled.memory_analysis()}")

    def run(q):
        return compiled(q)

    results = {}
    for name, q in scenes.items():
        times = time_step(run, (q,), args.reps)
        nf, mag, batch = run(q)
        results[name] = dict(_quartiles(times),
                             pulses=int(np.sum(np.asarray(batch.count))))
        _log(f"{name}: {results[name]}")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")

    if args.trace:
        scopes = scope_map(compiled.as_text())
        for name, q in scenes.items():
            d = os.path.join(args.trace, name)
            with jax.profiler.trace(d):
                for _ in range(3):
                    jax.block_until_ready(run(q))
            lt = layer_times(d, scopes)
            _log(f"trace {name}: busy {lt['busy_us']:.0f} us of "
                 f"{lt['span_us']:.0f} us span (3 steps)")
            for layer, us in sorted(lt["per_layer_us"].items(),
                                    key=lambda kv: -kv[1]):
                _log(f"  {layer:<12s} {us / 3:10.1f} us/step")
            for op, us in lt["top_ops_us"]:
                _log(f"  op {op[:90]:<90s} {us / 3:10.1f} us/step")

    if args.routes:
        measure_routes(pipe, scenes, args.reps, dev)

    dense_ms = results["dense"]["median_ms"]
    print(json.dumps({
        "metric": "channelize_pdw_throughput",
        "value": n / (dense_ms * 1e-3) / 1e6,
        "unit": "Msamples/s/card",
        "vs_baseline": n / (dense_ms * 1e-3) / 1e6 / 56.0,
        "dense": results["dense"],
        "sparse": results["sparse"],
        "sparse_msps": n / (results["sparse"]["median_ms"] * 1e-3) / 1e6,
        "samples_per_step": n,
        "compile_s": compile_s,
        "peak_bytes_in_use": peak,
        "ingest": "packed_int16",
        "card": card,
        "device": device_summary(),
    }))


def measure_routes(pipe, scenes, reps: int, dev) -> None:
    """The route's alternatives on this device: the channel extraction
    alone at M = 56, 64, 560 over ~16.8 M samples, the noise-floor median,
    and the full step per combination of methods."""
    import jax
    import jax.numpy as jnp

    from sdr_channelizer_tpu.dsp.channelizer import Channelizer, channelize
    from sdr_channelizer_tpu.ops import ingest, medians

    n_target = 1 << 24
    for m in (56, 64, 560):
        chan = Channelizer.create(m)
        n = n_target // m * m
        rng = np.random.default_rng(m)
        x = jax.device_put((rng.standard_normal(n) + 1j * rng.standard_normal(n)
                            ).astype(np.complex64) * 0.01, dev)
        for method in ("fft", "dft"):
            fn = jax.jit(lambda v, c=chan, mt=method: jnp.abs(
                channelize(v, c, method=mt)))
            t = time_step(fn, (x,), reps)
            _log(f"route channelize M={m} {method}: {_quartiles(t)}")

    from sdr_channelizer_tpu.dsp import pdw as pdwmod

    q = scenes["dense"]
    mag = jax.jit(lambda v: pipe.step_packed(v, 12)[1])(q)
    for method, bits in (("sort", 1), ("select", 1), ("select", 4)):
        fn = jax.jit(lambda v, mt=method, b=bits: medians.median(
            v, axis=0, method=mt, bits=b))
        t = time_step(fn, (mag,), reps)
        _log(f"route noise_floor {method} bits={bits}: {_quartiles(t)}")

    def step_with(v, dft, nf_method, nf_bits, stats_method):
        """The headline step with each method given."""
        y = channelize(ingest.unpack_complex(v, 12), pipe.channelizer,
                       method=dft)
        mag, ph, sat = pdwmod._prep_streams(y, pipe.pdw_cfg.saturation_level)
        nf = medians.median(mag, axis=0, method=nf_method, bits=nf_bits)
        return nf, pdwmod.extract_pdws_channelized_streams(
            mag, ph, sat, pipe.pdw_cfg, noise_floor=nf,
            median_method=stats_method)

    for combo in (("fft", "sort", 1, "sort"), ("fft", "select", 1, "sort"),
                  ("fft", "select", 4, "sort"), ("fft", "select", 4, "select"),
                  ("dft", "select", 4, "sort")):
        fn = jax.jit(lambda v, c=combo: step_with(v, *c))
        for name, qq in scenes.items():
            t = time_step(fn, (qq,), reps)
            _log(f"route step {name} channelize={combo[0]} noise_floor="
                 f"{combo[1]}/bits={combo[2]} pulse_stats={combo[3]}: "
                 f"{_quartiles(t)}")


if __name__ == "__main__":
    main()
