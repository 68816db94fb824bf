"""The masked trimmed mean kernel's sorting network, pinned on the CPU.

``csrc/robust.cu`` sorts each column of up to 64 rows in registers with
Batcher's odd-even merge network, generated at compile time from a loop nest
that ``kernels/robust.sorting_network`` repeats in Python.  No card is
needed to check that loop nest:

* the 0-1 principle: a comparator network sorts every input iff it sorts
  every 0-1 input, so it is checked exhaustively up to 16 inputs and on
  random vectors at 32 and 64;
* its size, (t² − t + 4)·2^(t−2) − 1 for 2^t inputs (5, 19, 63, 191, 543),
  which ``chip_smoke.py`` counts in the kernel's bound;
* a torch emulation of the kernel (dead rows and padding positions as +inf,
  the network, then the band summed in sorted order) against the
  reference's Pallas kernel in interpret mode, its ``masked_trimmed_mean_ref``
  and the port's plain sort-then-trim, atol 1e-5 as in
  ``tests/test_kernels.py``: dead rows holding NaN and 1e30, ties, ±0, the
  degenerate cohort and the empty mask.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import robust as trobust


def _apply(pairs, v: np.ndarray) -> np.ndarray:
    """The network on the columns of ``v`` (each row one input vector)."""
    v = v.copy()
    for lo, hi in pairs:
        a, b = v[:, lo].copy(), v[:, hi]
        v[:, lo] = np.minimum(a, b)
        v[:, hi] = np.maximum(a, b)
    return v


@pytest.mark.parametrize("t", [1, 2, 3, 4, 5, 6])
def test_network_size_matches_batcher(t):
    pairs = trobust.sorting_network(2 ** t)
    assert len(pairs) == ((t * t - t + 4) << t) // 4 - 1
    assert all(0 <= lo < hi < 2 ** t for lo, hi in pairs)


def test_network_sizes_are_the_bound_counts():
    assert [len(trobust.sorting_network(2 ** t)) for t in range(2, 7)] == [5, 19, 63, 191, 543]


@pytest.mark.parametrize("np_", [2, 4, 8, 16])
def test_network_sorts_every_01_input(np_):
    bits = np.array(list(itertools.product((0, 1), repeat=np_)), np.int8)
    out = _apply(trobust.sorting_network(np_), bits)
    assert (np.diff(out, axis=1) >= 0).all()
    np.testing.assert_array_equal(out.sum(1), bits.sum(1))


@pytest.mark.parametrize("np_", [32, 64])
def test_network_sorts_random_inputs(np_):
    rng = np.random.default_rng(np_)
    pairs = trobust.sorting_network(np_)
    bits = (rng.uniform(size=(20_000, np_)) < rng.uniform(size=(20_000, 1))).astype(np.int8)
    out = _apply(pairs, bits)
    assert (np.diff(out, axis=1) >= 0).all()
    floats = rng.normal(size=(2_000, np_)).astype(np.float32)
    floats[:, ::5] = floats[:, 1::5]  # ties
    np.testing.assert_array_equal(_apply(pairs, floats), np.sort(floats, axis=1))


def _network_trimmed_mean(arena: np.ndarray, mask: np.ndarray, trim_k: int) -> np.ndarray:
    """What ``network_kernel`` computes, in torch: each column in NP = N
    rounded up to a power of two (at least 4) positions, dead rows and the
    padding as +inf by a select, Batcher's network by min/max, then the band
    ``[trim_k, n_valid - trim_k)`` summed in sorted order, or the live rows
    ``[0, n_live)`` for a degenerate cohort."""
    n, p = arena.shape
    np_ = max(4, 1 << (n - 1).bit_length())
    m = torch.from_numpy(mask)
    live = m > 0
    v = torch.full((np_, p), torch.inf)
    v[:n] = torch.where(live[:, None], torch.from_numpy(arena), torch.inf)
    for lo, hi in trobust.sorting_network(np_):
        a, b = v[lo].clone(), v[hi].clone()
        v[lo], v[hi] = torch.minimum(a, b), torch.maximum(a, b)
    m_sum = m.sum()
    n_valid = int(m_sum)
    count = n_valid - 2 * trim_k
    lo, hi = (trim_k, n_valid - trim_k) if count > 0 else (0, int(live.sum()))
    total = torch.zeros(p)
    for i in range(lo, hi):
        total = total + v[i]
    if count > 0:
        return (total / count).numpy()
    if n_valid > 0:
        return (total / torch.clamp(m_sum, min=1.0)).numpy()
    return torch.zeros(p).numpy()


def _rows(n: int, p: int, seed: int, dead: bool) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(n, p)) * 3).astype(np.float32)
    if n >= 4:
        rows[n // 2] = rows[0]  # a duplicated row
        rows[n // 2 + 1] = -rows[1]  # a negated row
    rows[:, : p // 8] = 0.5  # all-equal columns
    rows[::2, p // 8] = 0.0
    rows[1::2, p // 8] = -0.0  # a ±0 column
    mask = np.ones((n,), np.float32)
    if dead:
        mask[2::3] = 0.0
        rows[2::3] = np.nan
        rows[5::6] = 1e30
    return rows, mask


def _check(rows: np.ndarray, mask: np.ndarray, trim_k: int) -> None:
    got = _network_trimmed_mean(rows, mask, trim_k)
    assert np.isfinite(got).all()
    w = np.ones(mask.shape, np.float32)
    pallas = jops.masked_trimmed_mean(jnp.asarray(rows), jnp.asarray(w), jnp.asarray(mask),
                                      trim_k=trim_k)
    ref = jref.masked_trimmed_mean_ref(jnp.asarray(rows), jnp.asarray(mask), trim_k)
    plain = trobust.masked_trimmed_mean_torch(torch.from_numpy(rows), torch.from_numpy(mask),
                                              trim_k)
    for want in (np.asarray(pallas), np.asarray(ref), plain.numpy()):
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("dead", [False, True])
@pytest.mark.parametrize("n,trim_k", [(2, 0), (3, 1), (4, 1), (5, 2), (8, 3), (16, 7),
                                      (17, 4), (31, 15), (32, 8), (33, 1), (64, 16)])
def test_network_emulation_matches_reference(n, trim_k, dead):
    rows, mask = _rows(n, 384, seed=n * 10 + trim_k, dead=dead)
    _check(rows, mask, trim_k)


def test_network_emulation_degenerate_cohort_and_empty_mask():
    rows, _ = _rows(8, 384, seed=1, dead=False)
    two = np.zeros((8,), np.float32)
    two[[0, 5]] = 1.0  # n_valid 2 <= 2·trim_k: the untrimmed mean of rows 0 and 5
    rows[[1, 2, 3, 4, 6, 7]] = np.nan
    _check(rows, two, 2)
    np.testing.assert_allclose(_network_trimmed_mean(rows, two, 2), (rows[0] + rows[5]) / 2,
                               atol=1e-6)
    assert (_network_trimmed_mean(rows, np.zeros((8,), np.float32), 2) == 0).all()


def test_network_emulation_scale_fate_outliers():
    """Byzantine `scale` uploads: extremes 1e6 times the band, summed around,
    never subtracted, so the band keeps its bits."""
    rows, mask = _rows(32, 384, seed=3, dead=False)
    rows[[4, 9, 20]] *= 1e6
    rows[[11, 27]] *= -1e6
    _check(rows, mask, 8)
