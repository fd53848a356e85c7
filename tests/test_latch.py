"""Hysteresis latch (``lax.associative_scan``) and edge search (cumsum +
``searchsorted``) against a sequential numpy latch — the reference's own
loop (``create_pdws.m:51-105``): set when ``mag >= lead``, reset when
``mag <= trail`` while active, hold otherwise."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sdr_channelizer_tpu.dsp import pdw as pdwmod


def _sequential_latch(mag, lead, trail):
    """Per-channel (toa, te) edge lists of the reference loop; a pulse still
    open at the end has a toa and no te."""
    t_len, m = mag.shape
    toas, tes = [], []
    for c in range(m):
        active, toa, te = False, [], []
        for j in range(t_len):
            if not active:
                if mag[j, c] >= lead[c]:
                    active = True
                    toa.append(j)
            elif mag[j, c] <= trail[c]:
                active = False
                te.append(j)
        toas.append(toa)
        tes.append(te)
    return toas, tes


def _streams(seed, t_len, m, open_at_end=False):
    rng = np.random.default_rng(seed)
    mag = (np.abs(rng.standard_normal((t_len, m))) * 0.01).astype(np.float32)
    for c in range(m):
        for s in range(5 + c, t_len - 30, 97 + 13 * c):
            mag[s:s + 7 + c % 5, c] = 1.0
    # threshold-hovering samples so the latch also holds and toggles
    mag[rng.random((t_len, m)) < 0.02] = 0.05
    if open_at_end:
        mag[-3:, 0] = 1.0
    nf = np.median(mag, axis=0).astype(np.float32)
    return mag, nf * 10.0, nf * 3.0


def _edges(mag, lead, trail, max_pulses):
    ge = jnp.asarray(mag) >= jnp.asarray(lead)[None, :]
    le = jnp.asarray(mag) <= jnp.asarray(trail)[None, :]
    state = pdwmod.hysteresis_scan(ge, le, axis=0)
    prev = jnp.concatenate([jnp.zeros_like(state[:1]), state[:-1]])
    find = jax.vmap(functools.partial(pdwmod._edge_indices,
                                      max_pulses=max_pulses), in_axes=1)
    return np.asarray(find(state & ~prev)), np.asarray(find(~state & prev))


@pytest.mark.parametrize("seed,t_len,m", [(0, 4096, 8), (1, 5000, 8),
                                          (2, 2048, 16), (3, 2048, 96)])
def test_latch_edges_match_sequential(seed, t_len, m):
    mag, lead, trail = _streams(seed, t_len, m)
    want_toa, want_te = _sequential_latch(mag, lead, trail)
    cap = max(len(t) for t in want_toa) + 3
    toa, te = _edges(mag, lead, trail, cap)
    for c in range(m):
        n_l, n_t = len(want_toa[c]), len(want_te[c])
        np.testing.assert_array_equal(toa[c, :n_l], want_toa[c])
        np.testing.assert_array_equal(te[c, :n_t], want_te[c])
        assert np.all(toa[c, n_l:] == t_len) and np.all(te[c, n_t:] == t_len)


@pytest.mark.parametrize("m,t_len", [(8, 1024), (64, 2048), (3, 512),
                                     (100, 512)])
def test_block_chaining_matches_whole_capture(m, t_len):
    """Two time blocks, the latch carried across by transfer-function
    composition (``block_transfer``) and a right halo, emit exactly the
    whole capture's pulses; a pulse open at capture end is never emitted."""
    mag, lead, trail = _streams(5, t_len, m, open_at_end=True)
    want_toa, want_te = _sequential_latch(mag, lead, trail)
    nf = jnp.asarray(lead / 10.0)
    cfg = dict(snr_threshold_db=10.0, trailing_threshold_db=10 * np.log10(3.0),
               max_pulses=64, max_pulse_samples=32)
    half, halo = t_len // 2, 32
    ph = jnp.zeros((t_len + 1, m), jnp.float32)
    sat = jnp.zeros((t_len + 1, m), bool)
    mag_e = jnp.concatenate([jnp.asarray(mag), jnp.full((1, m), jnp.inf)])

    def block(lo, hi, own, entry):
        core = functools.partial(pdwmod.extract_pdws_block_core,
                                 own_len=own, **cfg)
        return jax.vmap(core, in_axes=(1, 1, 1, 0, 0))(
            mag_e[lo:hi], ph[lo:hi], sat[lo:hi], nf, entry)

    b0 = block(0, half + halo, half, jnp.zeros((m,), bool))
    a, b = pdwmod.block_transfer(jnp.asarray(mag[:half]).T, nf[:, None],
                                 cfg["snr_threshold_db"],
                                 cfg["trailing_threshold_db"])
    b1 = block(half, t_len + 1, t_len - half, a)
    for c in range(m):
        got_toa = np.concatenate([
            np.asarray(b0.toa_idx[c])[np.asarray(b0.valid[c])],
            np.asarray(b1.toa_idx[c])[np.asarray(b1.valid[c])] + half])
        got_te = np.concatenate([
            np.asarray(b0.te_idx[c])[np.asarray(b0.valid[c])],
            np.asarray(b1.te_idx[c])[np.asarray(b1.valid[c])] + half])
        n = len(want_te[c])  # closed pulses only
        np.testing.assert_array_equal(got_toa, want_toa[c][:n])
        np.testing.assert_array_equal(got_te, want_te[c])


def test_latch_starts_inactive():
    """Samples between the thresholds hold the latch in its state — which
    starts inactive (``pulseActive = false``, ``create_pdws.m:51``)."""
    mag = jnp.asarray([0.5, 0.5, 2.0, 0.5, 0.1, 0.5], jnp.float32)
    state = np.asarray(pdwmod.hysteresis_scan(mag >= 1.0, mag <= 0.2))
    np.testing.assert_array_equal(state, [0, 0, 1, 1, 0, 0])


@pytest.mark.parametrize("seed,m,t_len,r", [(0, 4, 4096, 64),
                                            (1, 8, 2048, 128),
                                            (2, 3, 8192, 32)])
def test_edge_indices_match_nonzero(seed, m, t_len, r):
    """The r-th edge by binary search of the edge cumsum == the r-th
    nonzero, ``t_len`` past the count; densities above and below the
    rank range per channel."""
    rng = np.random.default_rng(seed)
    dens = np.linspace(0.001, 0.1, m)
    edges = rng.random((t_len, m)) < dens[None, :]
    got = np.asarray(jax.vmap(functools.partial(
        pdwmod._edge_indices, max_pulses=r), in_axes=1)(jnp.asarray(edges)))
    for c in range(m):
        nz = np.nonzero(edges[:, c])[0][:r]
        want = np.full(r, t_len)
        want[:len(nz)] = nz
        np.testing.assert_array_equal(got[c], want)


@pytest.mark.parametrize("seed,t_len,p", [(0, 4096, 500), (1, 1024, 257)])
def test_edge_indices_capacity(seed, t_len, p):
    """More edges than slots keep the first ``p``; fewer pad with t_len."""
    rng = np.random.default_rng(seed)
    for dens in (0.5, 0.05):
        edges = rng.random(t_len) < dens
        got = np.asarray(pdwmod._edge_indices(jnp.asarray(edges), p))
        nz = np.nonzero(edges)[0][:p]
        assert got.shape == (p,)
        np.testing.assert_array_equal(got[:len(nz)], nz)
        assert np.all(got[len(nz):] == t_len)


def test_edge_indices_corner_cases():
    t_len = 300
    none = np.asarray(pdwmod._edge_indices(jnp.zeros(t_len, bool), 4))
    np.testing.assert_array_equal(none, [t_len] * 4)
    ends = np.zeros(t_len, bool)
    ends[[0, t_len - 1]] = True
    got = np.asarray(pdwmod._edge_indices(jnp.asarray(ends), 4))
    np.testing.assert_array_equal(got, [0, t_len - 1, t_len, t_len])
