"""Test configuration.

Tests run on the CPU with 8 virtual devices, so the multi-device sharding
paths (mesh, halo exchange, PDW merge) are exercised without a GPU.  The
platform is forced with ``jax.config.update`` (backends have not
initialized yet when conftest runs); XLA_FLAGS is read lazily at backend
init, so the virtual device count can be set via the environment.  The
checks that need the card run in ``chip_smoke.py`` on the GPU.
"""

import fcntl
import os
import subprocess

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
# The CLI turns on the persistent compilation cache; tests compile afresh.
jax.config.update("jax_enable_compilation_cache", False)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NATIVE_DIR = os.path.join(_REPO, "native")


def build_native():
    """Build the native tier exactly once across concurrent test workers.

    ``make -C native`` is not safe to run from several pytest-xdist workers
    at once (two make processes compiling the same object race), so the
    call is serialized through an exclusive file lock.
    """
    lock_path = os.path.join(_NATIVE_DIR, ".build.lock")
    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        subprocess.run(["make", "-C", _NATIVE_DIR], check=True,
                       capture_output=True)
