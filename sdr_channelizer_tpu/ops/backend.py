"""The one place where a computation's method may depend on the backend.

Every backend runs the same graph: complex channelizer output, plain
``jnp``/``lax`` left to XLA, channels extracted by FFT (on the H100 at
400 W cuFFT took 0.84 ms against the HIGHEST-precision DFT matmul's
0.95 ms at M=64, and 1.05 against 2.57 ms at M=560, ~16.8 M samples —
``PERF.md``).  One choice inside that graph has exact alternatives whose
speed depends on the device: the median over a capture's whole time axis
(the noise floor) — ``"sort"`` (XLA's sort) or ``"select"`` (the radix
selection of ``ops.medians``, with its bits per counting pass).  Both
pick the same order statistics.  The per-pulse window medians sort on
every platform (on the H100 sorting the 1024-sample windows beat the
select by 0.6–0.7 ms per bench step).

The table below holds the choice per platform; a platform missing from it
takes the CPU's method.  An entry differs from the CPU's only where a
measurement on that device showed a gain.

The platform is the process's default backend.  Code that must not depend
on it — a CPU reference run inside a GPU process, for instance — passes
``method=`` explicitly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax

# (method, bits).  Radix select on the GPU: XLA's GPU sort took 66.6 ms
# for the M=64 bench noise floor (H100, 700 W), the select 1.17 ms with
# 1 bit per pass and 1.06 ms with 4; the headline step fell from 71.7 to
# 6.1 ms (PERF.md).
_NOISE_FLOOR_MEDIAN = {"cpu": ("sort", 1), "gpu": ("select", 4)}


def platform() -> str:
    """The default backend's platform name (``"cpu"``, ``"gpu"``, ...)."""
    return jax.default_backend()


def noise_floor_median(platform_name: Optional[str] = None) -> Tuple[str, int]:
    """``(method, bits)`` of a whole-capture median on ``platform_name``
    (default: the default backend)."""
    p = platform_name or platform()
    return _NOISE_FLOOR_MEDIAN.get(p, _NOISE_FLOOR_MEDIAN["cpu"])
