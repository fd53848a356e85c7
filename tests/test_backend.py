"""The per-backend method choice (``ops.backend``), the pinned reference
route, and the compile-cache location."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdr_channelizer_tpu.config import PdwConfig
from sdr_channelizer_tpu.models.pipeline import ChannelizerPipeline
from sdr_channelizer_tpu.ops import backend
from sdr_channelizer_tpu.utils import compile_cache


@pytest.mark.parametrize("platform", ["cpu", "gpu", "some_new_backend"])
def test_choices_are_exact_methods(platform):
    method, bits = backend.noise_floor_median(platform)
    assert method in ("sort", "select") and 32 % bits == 0
    if platform not in backend._NOISE_FLOOR_MEDIAN:
        assert (method, bits) == backend.noise_floor_median("cpu")
    assert backend.noise_floor_median("gpu") == ("select", 4)


def test_reference_route_ignores_backend_choice(monkeypatch):
    """``forward_reference`` pins sort medians: flipping the backend table
    changes the device route's method but not the reference."""
    m, n = 8, 8 * 512
    rng = np.random.default_rng(0)
    x = (0.01 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
         ).astype(np.complex64)
    x[1000:1400] = 0.8
    cfg = PdwConfig.channelized(max_pulses=16, max_pulse_samples=64)
    nf_a, b_a = ChannelizerPipeline.create(m, pdw_cfg=cfg).forward_reference(
        jnp.asarray(x))
    monkeypatch.setitem(backend._NOISE_FLOOR_MEDIAN, "cpu", ("select", 4))
    assert backend.noise_floor_median() == ("select", 4)
    pipe = ChannelizerPipeline.create(m, pdw_cfg=cfg)
    nf_b, b_b = pipe.forward_reference(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(nf_a), np.asarray(nf_b))
    np.testing.assert_array_equal(np.asarray(b_a.mag), np.asarray(b_b.mag))
    # the device route follows the table; select picks the same order
    # statistics as sort
    _, nf_dev, b_dev = pipe.forward(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(b_dev.count),
                                  np.asarray(b_a.count))
    np.testing.assert_array_equal(np.asarray(nf_dev), np.asarray(nf_a))


def test_compile_cache_honours_environment(monkeypatch):
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    assert compile_cache.enable_compile_cache() == "/somewhere/else"
    assert calls == []


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update", lambda *a: calls.append(a))
    path = compile_cache.enable_compile_cache()
    assert path.endswith(".jax_cache")
    assert calls == [("jax_compilation_cache_dir", path)]
