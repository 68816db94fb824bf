"""The FedAvg kernel's launch plan and bulk-copy windows, on the host.

``csrc/fedavg.cu`` copies each live row's part of a column tile into a ring
slot in shared memory with ``cp.async.bulk``, which needs 16-byte-aligned
source, destination and size; for int8 rows (the fused dequant-into-aggregate)
it copies the tile's scales into a scale slot the same way.  ``kernels/fedavg.tile_window`` is the window
arithmetic the kernel follows (the aligned window over the tile, clipped to
the view's extent, with the clipped edges loaded by plain loads), and
``launch_plan`` sizes the grid and the shared memory.  These tests hold both
to what the kernel relies on: every column of every row is covered exactly
once by a window's payload or an edge load; every bulk source, destination
and size is a multiple of 16 bytes; no window leaves the view's bytes; a
slot holds its window; the shared memory fits a block (232,448 bytes) and
``BLOCKS_PER_SM`` blocks fit the SM.  For int8 rows the same holds of the
values and of the scale groups each tile's columns touch, and the emulated
data path dequantizes every value with the scale the kernel's consumer
indexes.  The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
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


def _all_windows(base, esize, stride, n, p, tile=TILE):
    cols = tile // esize
    tiles = -(-p // cols)
    rows = np.arange(n, dtype=np.int64)[:, None]
    c0 = np.arange(tiles, dtype=np.int64)[None, :] * cols
    c1 = np.minimum(c0 + cols, p)
    return tfed.tile_window(base, esize, stride, n, p, rows, c0, c1)


def _check_windows(win, base, esize, stride, n, p, slot=TILE + 128):
    lo, hi = base, base + ((n - 1) * stride + p) * esize
    a, b = win.a, win.b
    # The bulk copy: 16-byte aligned source, size and destination in its slot.
    assert np.all(win.src % 16 == 0) and np.all(win.nbytes % 16 == 0)
    assert np.all(win.dst % 16 == 0) and np.all(win.nbytes >= 0)
    # Inside the view's bytes, and inside a slot (TILE_BYTES + 128 by default).
    live = win.nbytes > 0
    assert np.all(win.src[live] >= lo) and np.all((win.src + win.nbytes)[live] <= hi)
    assert np.all(win.dst + win.nbytes <= slot)
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


# ---------------------------------------------------------------------------
# int8 rows and their scales (the fused dequant-into-aggregate)
# ---------------------------------------------------------------------------

TILE_Q8 = tfed.TILE_BYTES_Q8


def _q8_windows(qbase, qstride, sbase, sstride, n, p, group):
    """Every (row, tile) window of the values and of the tile's scale groups
    ``[c0 // group, ceil(c1 / group))``, as the kernel's producer takes them."""
    rows = np.arange(n, dtype=np.int64)[:, None]
    c0 = np.arange(-(-p // TILE_Q8), dtype=np.int64)[None, :] * TILE_Q8
    c1 = np.minimum(c0 + TILE_Q8, p)
    vals = tfed.tile_window(qbase, 1, qstride, n, p, rows, c0, c1)
    scales = tfed.tile_window(sbase, 4, sstride, n, p // group, rows, c0 // group,
                              -(-c1 // group))
    return vals, scales


@pytest.mark.parametrize("n,p,group,qoff,soff,qpad,spad", [
    (32, P_MAIN, 256, 0, 0, 0, 0),      # the main shape: aligned, group divides the tile
    (32, P_MAIN, 512, 0, 0, 0, 0),
    (5, 40_960, 256, 3, 1, 5, 3),       # unaligned values and scales
    (3, 48_000, 24, 7, 2, 1, 1),        # a group that does not divide the tile
    (4, 8_200, 8, 1, 0, 0, 0),          # P % 16 == 8
])
def test_q8_windows_are_aligned_and_inside_the_views(n, p, group, qoff, soff, qpad, spad):
    qstride, sstride = p + qoff + qpad, p // group + soff + spad
    qbase, sbase = BASE + qoff, BASE + 2**34 + 4 * soff
    vals, scales = _q8_windows(qbase, qstride, sbase, sstride, n, p, group)
    _check_windows(vals, qbase, 1, qstride, n, p, slot=TILE_Q8 + 128)
    _check_windows(scales, sbase, 4, sstride, n, p // group,
                   slot=tfed.scale_slot_bytes(group))
    if (qoff, qpad, soff, spad) == (0, 0, 0, 0) and TILE_Q8 % group == 0:
        # Aligned rows, whole groups a tile: the bulk copies read exactly the
        # bytes the bound counts, L·P + 4·L·P/group for L live rows.
        assert int(vals.nbytes.sum()) == n * p
        assert int(scales.nbytes.sum()) == 4 * n * (p // group)


def _emulate_q8(qbuf, qbase, qstride, sbuf, sbase, sstride, n, p, group, live):
    """The kernel's int8 data path on the host: each live (row, tile) fills a
    value slot and a scale slot from their bulk windows and edge loads, and
    each column is dequantized with the scale at the offset the consumer
    computes, ``(c0 % group + j) // group``; returns the (N, P) f32 rows (0
    for a dead row, never read)."""
    out = np.zeros((n, p), np.float32)
    for r in np.flatnonzero(live):
        for c0 in range(0, p, TILE_Q8):
            c1 = min(c0 + TILE_Q8, p)
            g0, g1 = c0 // group, -(-c1 // group)
            slots = []
            for buf, base, esize, stride, cols, a0, a1, size in (
                    (qbuf, qbase, 1, qstride, p, c0, c1, TILE_Q8 + 128),
                    (sbuf, sbase, 4, sstride, p // group, g0, g1, tfed.scale_slot_bytes(group))):
                w = tfed.tile_window(base, esize, stride, n, cols, r, a0, a1)
                slot = np.full(size, 0xAB, np.uint8)
                if w.nbytes:
                    assert base <= w.src and w.src + w.nbytes <= base + buf.size
                    slot[w.dst: w.dst + w.nbytes] = buf[w.src - base: w.src - base + w.nbytes]
                for x in [*range(w.a, w.head_end, esize), *range(w.tail_start, w.b, esize)]:
                    assert base <= x and x + esize <= base + buf.size
                    slot[w.delta + x - w.a: w.delta + x - w.a + esize] = buf[x - base: x - base + esize]
                slots.append((slot, w.delta))
            (vslot, vd), (sslot, sd) = slots
            j = np.arange(c1 - c0)
            q = vslot[vd: vd + c1 - c0].view(np.int8).astype(np.float32)
            s = sslot[sd: sd + 4 * (g1 - g0)].view(np.float32)
            out[r, c0:c1] = q * s[(c0 % group + j) // group]
    return out


@settings(max_examples=40, deadline=None)
@given(n=st.integers(1, 4), groups=st.integers(1, 90), group=st.sampled_from([8, 16, 24, 256, 512]),
       qpad=st.integers(0, 17), qoff=st.integers(0, 17), spad=st.integers(0, 5),
       soff=st.integers(0, 5), live_bits=st.integers(0, 15), seed=st.integers(0, 2**31 - 1))
def test_q8_windows_cover_every_value_and_scale_once(n, groups, group, qpad, qoff, spad, soff,
                                                    live_bits, seed):
    """Random widths (whole groups, from one group to several tiles), strides
    and storage offsets of both views: the emulated data path dequantizes
    every live row exactly as ``dequant_rows`` does, reading only the views."""
    from repro_torch.kernels.fused_agg import dequant_rows

    p = groups * group
    qstride, sstride, ng = p + qpad, groups + spad, groups
    rng = np.random.default_rng(seed)
    qext, sext = (n - 1) * qstride + p, (n - 1) * sstride + ng
    qbuf = rng.integers(0, 256, size=qext, dtype=np.uint8)
    sbuf = rng.uniform(0.01, 5, size=sext).astype(np.float32).view(np.uint8)
    live = np.array([(live_bits >> i) & 1 for i in range(n)], bool)
    got = _emulate_q8(qbuf, BASE + qoff, qstride, sbuf, BASE + 2**34 + 4 * soff, sstride,
                      n, p, group, live)
    q = torch.from_numpy(np.stack([qbuf[r * qstride: r * qstride + p] for r in range(n)]).view(np.int8))
    s = torch.from_numpy(np.stack([sbuf.view(np.float32)[r * sstride: r * sstride + ng]
                                   for r in range(n)]))
    want = dequant_rows(q, s, group).numpy()
    np.testing.assert_array_equal(got[live].view(np.int32), want[live].view(np.int32))
    vals, scales = _q8_windows(BASE + qoff, qstride, BASE + 2**34 + 4 * soff, sstride, n, p, group)
    _check_windows(vals, BASE + qoff, 1, qstride, n, p, slot=TILE_Q8 + 128)
    _check_windows(scales, BASE + 2**34 + 4 * soff, 4, sstride, n, ng,
                   slot=tfed.scale_slot_bytes(group))


@pytest.mark.parametrize("group", [8, 24, 256, 512])
@pytest.mark.parametrize("p_groups", [1, 77, 40_000])
@pytest.mark.parametrize("n", [1, 32, 2048, 2049, 100_000])
def test_q8_launch_plan_fits_shared_memory(n, p_groups, group):
    rows = torch.empty((n, p_groups * group), dtype=torch.int8, device="meta")
    plan = tfed.launch_plan(rows, sm_count=H100_SMS, group=group)
    assert plan.staged == (n <= tfed.STAGE_CAP)
    assert plan.smem_bytes == tfed.smem_bytes(n, plan.staged, group)
    assert plan.smem_bytes <= 232_448
    assert tfed.BLOCKS_PER_SM * (plan.smem_bytes + tfed.SMEM_RESERVED) <= tfed.SMEM_SM
    assert plan.n_tiles == -(-p_groups * group // TILE_Q8)
    assert 1 <= plan.grid <= min(plan.n_tiles, H100_SMS * tfed.BLOCKS_PER_SM)
    # The scale slot holds the groups one tile touches, 128 bytes early.
    assert tfed.scale_slot_bytes(group) % 128 == 0
    assert tfed.scale_slot_bytes(group) >= 128 + 4 * (-(-TILE_Q8 // group) + 1)


def test_q8_launch_plan_at_the_main_shape():
    rows = torch.empty((32, P_MAIN), dtype=torch.int8, device="meta")
    plan = tfed.launch_plan(rows, sm_count=H100_SMS, group=256)
    assert plan.staged and plan.n_tiles == P_MAIN // TILE_Q8 == 621  # whole tiles
    assert plan.smem_bytes == tfed.smem_bytes(32, True, 256) == 51_928
    rounds = -(-plan.n_tiles // (H100_SMS * tfed.BLOCKS_PER_SM))
    assert plan.grid <= H100_SMS * tfed.BLOCKS_PER_SM
    assert -(-plan.n_tiles // plan.grid) == rounds < -(-plan.n_tiles // (plan.grid - 1))
    with pytest.raises(ValueError, match="scale group"):
        tfed.launch_plan(rows, sm_count=H100_SMS)
    with pytest.raises(ValueError, match="scale group"):
        tfed.launch_plan(torch.empty((32, P_MAIN), device="meta"), sm_count=H100_SMS, group=256)
