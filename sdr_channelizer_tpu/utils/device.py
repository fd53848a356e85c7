"""The accelerator a measurement ran on, named the way every number in the
repo is labelled: the card's name and power limit from ``nvidia-smi`` and
the device as JAX reports it."""

from __future__ import annotations

import subprocess


def card_name_and_power() -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    (one line per card), or why it could not be read."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"
    return res.stdout.strip()


def require_gpu():
    """The first JAX device, which must be a GPU: a measurement that finds
    no GPU fails instead of falling back to the CPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default backend is {devices[0].platform!r}")
    return devices[0]


def device_summary() -> dict:
    """``{"platform", "kind", "count"}`` of JAX's default devices."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
