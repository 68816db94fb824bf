"""The FedAvg kernel's launch plan and bulk-copy windows, on the host.

``csrc/fedavg.cu`` copies each live row's part of a column tile into a ring
slot in shared memory with ``cp.async.bulk``, which needs 16-byte-aligned
source, destination and size.  ``kernels/fedavg.tile_window`` is the window
arithmetic the kernel follows (the aligned window over the tile, clipped to
the view's extent, with the clipped edges loaded by plain loads), and
``launch_plan`` sizes the grid and the shared memory.  These tests hold both
to what the kernel relies on: every column of every row is covered exactly
once by a window's payload or an edge load; every bulk source, destination
and size is a multiple of 16 bytes; no window leaves the view's bytes; a
slot holds its window; the shared memory fits a block (232,448 bytes) and
``BLOCKS_PER_SM`` blocks fit the SM.  The kernel itself runs only on the card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro_torch.kernels import fedavg as tfed

P_MAIN = 10_174_464  # housing-mlp-10m row, padded to the arena's 1024 alignment
P_STACK = 10_174_081  # the stack leg's unpadded rows
BASE = 0x7F3A_0000_0000  # a 256-byte-aligned device address, as the allocator gives
H100_SMS = 132


TILE = tfed.TILE_BYTES


def _all_windows(base, esize, stride, n, p):
    cols = TILE // esize
    tiles = -(-p // cols)
    rows = np.arange(n, dtype=np.int64)[:, None]
    c0 = np.arange(tiles, dtype=np.int64)[None, :] * cols
    c1 = np.minimum(c0 + cols, p)
    return tfed.tile_window(base, esize, stride, n, p, rows, c0, c1)


def _check_windows(win, base, esize, stride, n, p):
    lo, hi = base, base + ((n - 1) * stride + p) * esize
    a, b = win.a, win.b
    # The bulk copy: 16-byte aligned source, size and destination in its slot.
    assert np.all(win.src % 16 == 0) and np.all(win.nbytes % 16 == 0)
    assert np.all(win.dst % 16 == 0) and np.all(win.nbytes >= 0)
    # Inside the view's bytes, and inside a slot of TILE_BYTES + 128.
    live = win.nbytes > 0
    assert np.all(win.src[live] >= lo) and np.all((win.src + win.nbytes)[live] <= hi)
    assert np.all(win.dst + win.nbytes <= TILE + 128)
    assert np.all((0 <= win.delta) & (win.delta < 128))
    # Unclipped, source and destination are 128-byte aligned.
    assert np.all((win.src % 128 == 0) | (win.src == ((lo + 15) & ~15)))
    assert np.all((win.dst == 0) | (win.src == ((lo + 15) & ~15)))
    # The slot's origin is the same global address for the copy and the columns.
    assert np.all(win.src - win.dst == a - win.delta)
    # Head, the window's payload and tail partition [a, b), element-aligned.
    bulk_lo = np.clip(win.src, a, b)
    bulk_hi = np.clip(win.src + win.nbytes, a, b)
    head = win.head_end - a
    tail = b - win.tail_start
    assert np.all(head >= 0) and np.all(tail >= 0)
    assert np.all(head + (bulk_hi - bulk_lo) + tail == b - a)
    assert np.all(win.head_end <= bulk_lo) and np.all(bulk_hi <= win.tail_start)
    assert np.all(head < 16) and np.all(tail < 16)
    assert np.all(head % esize == 0) and np.all(tail % esize == 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [P_STACK, P_MAIN])
def test_windows_at_the_main_shapes(p, dtype):
    esize = torch.empty((), dtype=dtype).element_size()
    plan = tfed.launch_plan(torch.empty((32, p), dtype=dtype, device="meta"),
                            sm_count=H100_SMS)
    assert plan.n_tiles == -(-p * esize // TILE)
    win = _all_windows(BASE, esize, p, 32, p)
    _check_windows(win, BASE, esize, p, 32, p)
    if p == P_MAIN:  # rows a multiple of 16 bytes: every window aligned, none clipped
        assert np.all(win.delta == 0) and np.all(win.nbytes == win.b - win.a)
    elif esize == 4:  # 10,174,081 ≡ 1 (mod 4): row r sits 4·(r mod 4) bytes off 16
        assert np.all(win.delta % 16 == (4 * (np.arange(32) % 4))[:, None])
        assert int(win.nbytes.sum()) <= 32 * p * 4 + 32 * win.nbytes.shape[1] * 128


def _emulate(buf, base, esize, stride, n, p):
    """The kernel's data path on the host: each (row, tile) fills a ring slot
    from its bulk window and its edge loads, and the tile's columns are read
    back at the row's byte offset; returns the rows as bytes."""
    cols = TILE // esize
    out = np.zeros((n, p * esize), np.uint8)
    for r in range(n):
        for c0 in range(0, p, cols):
            c1 = min(c0 + cols, p)
            w = tfed.tile_window(base, esize, stride, n, p, r, c0, c1)
            slot = np.full(TILE + 128, 0xAB, np.uint8)  # stale bytes
            if w.nbytes:
                assert base <= w.src and w.src + w.nbytes <= base + buf.size
                slot[w.dst: w.dst + w.nbytes] = buf[w.src - base: w.src - base + w.nbytes]
            for x in [*range(w.a, w.head_end, esize), *range(w.tail_start, w.b, esize)]:
                assert base <= x and x + esize <= base + buf.size
                slot[w.delta + x - w.a: w.delta + x - w.a + esize] = buf[x - base: x - base + esize]
            out[r, c0 * esize: c1 * esize] = slot[w.delta: w.delta + (c1 - c0) * esize]
    return out


@settings(max_examples=60, deadline=None)
@given(esize=st.sampled_from([2, 4]), n=st.integers(1, 4), narrow=st.integers(0, 40),
       wide=st.integers(0, 40_000), use_wide=st.sampled_from([False, True]),
       pad=st.integers(0, 9), offset=st.integers(0, 9), seed=st.integers(0, 2**31 - 1))
def test_windows_cover_every_column_once(esize, n, narrow, wide, use_wide, pad, offset, seed):
    """Random strides, storage offsets and widths, from under one 16-byte
    window (P < 4 included) to several tiles a row: the emulated data path
    returns every row exactly, reading only the view."""
    p = wide if use_wide else narrow
    stride = p + pad
    base = BASE + offset * esize  # a view like arena[:, offset:]
    extent = ((n - 1) * stride + p) * esize
    buf = np.random.default_rng(seed).integers(0, 256, size=extent, dtype=np.uint8)
    want = np.stack([buf[r * stride * esize: (r * stride + p) * esize] for r in range(n)])
    np.testing.assert_array_equal(_emulate(buf, base, esize, stride, n, p), want)
    if p:
        _check_windows(_all_windows(base, esize, stride, n, p), base, esize, stride, n, p)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [3, 50_001, P_STACK, P_MAIN])
@pytest.mark.parametrize("n", [1, 32, 1100, 2048, 2049, 5000, 100_000])
def test_launch_plan_fits_shared_memory(n, p, dtype):
    rows = torch.empty((n, p), dtype=dtype, device="meta")
    plan = tfed.launch_plan(rows, sm_count=H100_SMS)
    assert plan.staged == (n <= tfed.STAGE_CAP)
    assert plan.smem_bytes == tfed.smem_bytes(n, plan.staged)
    assert plan.smem_bytes <= 232_448
    assert tfed.BLOCKS_PER_SM * (plan.smem_bytes + tfed.SMEM_RESERVED) <= tfed.SMEM_SM
    assert plan.n_tiles == -(-p // (tfed.TILE_BYTES // rows.element_size()))
    assert 1 <= plan.grid <= min(plan.n_tiles, H100_SMS * tfed.BLOCKS_PER_SM)


def test_launch_plan_at_the_main_shape():
    rows = torch.empty((32, P_MAIN), device="meta")
    plan = tfed.launch_plan(rows, sm_count=H100_SMS)
    assert plan.staged and plan.smem_bytes == 99_528
    assert plan.n_tiles == P_MAIN * 4 // tfed.TILE_BYTES
    # The fewest blocks that take as many rounds as BLOCKS_PER_SM on every SM
    # would: every block walks `rounds` tiles or one fewer, so the last round
    # is nearly full.
    rounds = -(-plan.n_tiles // (H100_SMS * tfed.BLOCKS_PER_SM))
    assert plan.grid <= H100_SMS * tfed.BLOCKS_PER_SM
    assert -(-plan.n_tiles // plan.grid) == rounds < -(-plan.n_tiles // (plan.grid - 1))
    # The largest staged block (STAGE_CAP rows) still fits BLOCKS_PER_SM to an SM.
    big = tfed.smem_bytes(tfed.STAGE_CAP, True)
    assert tfed.BLOCKS_PER_SM * (big + tfed.SMEM_RESERVED) <= tfed.SMEM_SM


def test_empty_width_plans_no_tiles():
    plan = tfed.launch_plan(torch.empty((4, 0), device="meta"), sm_count=H100_SMS)
    assert plan.n_tiles == 0 and plan.grid == 0
