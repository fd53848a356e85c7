"""Radix-selection median must match the sort path bit-for-bit — it picks
the same order statistics without a sort."""

import jax.numpy as jnp
import numpy as np
import pytest

from sdr_channelizer_tpu.ops.medians import masked_median, median


@pytest.mark.parametrize("n", [1, 2, 5, 8, 100, 1001])
def test_median_select_matches_sort(n):
    rng = np.random.default_rng(n)
    x = jnp.asarray(rng.standard_normal((7, n)).astype(np.float32) * 100)
    a = np.asarray(median(x, axis=1, method="sort"))
    b = np.asarray(median(x, axis=1, method="select"))
    np.testing.assert_array_equal(a, b)


def test_median_negative_and_special_values():
    x = jnp.asarray(np.array(
        [[-5.0, -1.0, 0.0, 2.5, 1e30],
         [-np.inf, -2.0, 3.0, np.inf, 7.0],
         [0.0, -0.0, 0.0, -0.0, 1.0]], np.float32))
    a = np.asarray(median(x, axis=1, method="sort"))
    b = np.asarray(median(x, axis=1, method="select"))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", range(4))
def test_masked_median_matches(seed):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((5, 64)).astype(np.float32))
    mask = jnp.asarray(rng.random((5, 64)) < 0.6)
    a = np.asarray(masked_median(x, mask, axis=1, method="sort"))
    b = np.asarray(masked_median(x, mask, axis=1, method="select"))
    np.testing.assert_array_equal(a, b)


def test_masked_median_empty_mask_is_nan():
    x = jnp.ones((2, 4), jnp.float32)
    mask = jnp.asarray([[True, True, False, False], [False] * 4])
    out = np.asarray(masked_median(x, mask, axis=1, method="select"))
    assert out[0] == 1.0 and np.isnan(out[1])


def test_median_flat():
    rng = np.random.default_rng(9)
    x = jnp.asarray(rng.standard_normal(1000).astype(np.float32))
    a = np.asarray(median(x, method="sort"))
    b = np.asarray(median(x, method="select"))
    np.testing.assert_array_equal(a, b)


def test_multibit_select_matches_sort_and_1bit():
    """bits=2/4/8 value-space descent picks identical order statistics."""
    from sdr_channelizer_tpu.ops import medians
    rng = np.random.default_rng(7)
    for shape, axis in (((1000,), 0), ((257, 6), 0), ((6, 257), 1)):
        x = rng.standard_normal(shape).astype(np.float32)
        x.ravel()[:: 7] *= -1.0  # negatives exercise the key mapping
        x.ravel()[3] = 0.0
        mask = rng.random(shape) > 0.2
        want = medians.masked_median(jnp.asarray(x), jnp.asarray(mask),
                                     axis=axis, method="sort")
        for bits in (1, 2, 4, 8):
            got = medians.masked_median(jnp.asarray(x), jnp.asarray(mask),
                                        axis=axis, method="select", bits=bits)
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_multibit_median_unmasked():
    from sdr_channelizer_tpu.ops import medians
    rng = np.random.default_rng(8)
    x = np.abs(rng.standard_normal((500, 4))).astype(np.float32)
    want = np.median(x, axis=0)
    got = medians.median(jnp.asarray(x), axis=0, method="select", bits=4)
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-7)


@pytest.mark.parametrize("method", ["sort", "select"])
@pytest.mark.parametrize("r,t_len,t_pad", [
    (16, 5000, 5120),   # pad columns masked
    (8, 4095, 4096),    # odd count (middle order statistic)
    (8, 4096, 4096),    # even count (mean of two middles)
    (8, 300, 300),      # short rows
])
def test_noise_floor_median_matches_numpy(r, t_len, t_pad, method):
    """Per-channel noise floor (``create_pdws_channelized.m:73``): both
    methods against ``np.median``, with pad columns masked out."""
    rng = np.random.default_rng(r + t_len)
    mag = np.abs(rng.standard_normal((r, t_pad))).astype(np.float32)
    mag[:, t_len:] = 0.0
    want = np.median(mag[:, :t_len], axis=1).astype(np.float32)
    mask = jnp.arange(t_pad)[None, :] < t_len
    got = np.asarray(masked_median(jnp.asarray(mag), mask, axis=1,
                                   method=method))
    np.testing.assert_array_equal(got, want)
    got_t = np.asarray(median(jnp.asarray(mag[:, :t_len].T), axis=0,
                              method=method))
    np.testing.assert_array_equal(got_t, want)
