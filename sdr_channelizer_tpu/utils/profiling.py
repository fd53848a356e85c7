"""Per-stage timing and JAX profiler integration.

The reference's only tracing is timestamped progress prints
(``create_pdws.m:35,49``; per-dwell ``"Received N"`` prints,
``blade_record_iq_12bit.cpp:311``).  Here: a :class:`StageTimer` that times
named stages (ingest / channelize / detect / merge) with device
synchronization, and :func:`trace` wrapping ``jax.profiler`` for on-device
traces.

JAX dispatch is asynchronous: a stage's time is only its device time once
the stage waits for its outputs (``jax.block_until_ready``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class StageTimer:
    """Accumulates wall-clock per named stage across repeated passes."""

    totals: Dict[str, float] = dataclasses.field(default_factory=dict)
    counts: Dict[str, int] = dataclasses.field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        """Time a stage; pass the stage's output pytree as ``sync`` (or
        append it to the yielded list) so the stage waits for it."""
        t0 = time.perf_counter()
        box: List = []
        try:
            yield box
        finally:
            target = box[0] if box else sync
            if target is not None:
                import jax

                jax.block_until_ready(target)
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items(), key=lambda kv: -kv[1]):
            n = self.counts[name]
            lines.append(f"{name:<16s} {tot:8.3f} s  ({n} calls, {tot/n*1e3:8.2f} ms/call)")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """``jax.profiler.trace`` wrapper; no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import jax

    with jax.profiler.trace(log_dir):
        yield
