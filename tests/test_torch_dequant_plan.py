"""The int8 dequantize kernel's persistent grid and index walk, on the host.

``csrc/quantize.cu``'s ``dequantize_kernel`` runs on the grid that
``kernels/quantize.dequant_plan`` sizes from the card's SM count.  Each warp
takes the chunks of 2,048 values (512 four-value quads) at its own index and
every grid stride after it; the warp next in line takes the quads past the
last whole chunk.  A quad's group is ``quad // (group / 4)``, which the
kernel computes without a 64-bit divide: the chunk's first group and its
offset in it are carried from chunk to chunk, and the group within the chunk
is a multiply-high and a shift by the invariant divisor's magic number.
These tests replay that arithmetic (``_magic`` and ``_walk`` are the C
entry's and the kernel's, line for line) and hold it to what the output
relies on: every quad written exactly once with the scale of its own group,
every group read, at the shapes the main path gives the kernel and at the
edges (odd group counts of group 8, groups 24 and 4096, one grid stride and
that stride +- 16 values), with the H100's 132 SMs.  The grid keeps every
warp's number of chunks within one of the others' and fits the C entry's
``int`` and its cap, and the plan's shape is the one the kernel is built
with.  The kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import pathlib
import re

import numpy as np
import pytest

from repro_torch.kernels import quantize as tquant

H100_SMS = 132
P_MAIN = 10_174_464  # housing-mlp-10m's arena row
P_SERVE = 3_879_927_808  # gemma3-4b's pushed row, padded to the int8 wire's tile
QUADS = tquant.DQ_CHUNK // 4  # a chunk's quads (the kernel's kDqChunkQuads)
GRID_CAP = (1 << 30) // (tquant.DQ_WARPS * QUADS)  # repro_dequantize's refusal
STRIDE = tquant.dequant_plan(P_MAIN, H100_SMS) * tquant.DQ_WARPS * tquant.DQ_CHUNK


def _magic(g4: int) -> tuple[int, int]:
    """``repro_dequantize``'s (magic, shift): x // g4 == umulhi(x, magic) >> shift."""
    log2 = 0
    while (1 << log2) < g4:
        log2 += 1
    return ((1 << (31 + log2)) + g4 - 1) // g4, log2 - 1


def _div(x, magic: int, shift: int):
    return ((np.asarray(x, dtype=np.uint64) * np.uint64(magic)) >> np.uint64(32 + shift))


def _walk(n: int, group: int, grid: int):
    """Each warp's chunk indices and the (g0, r0) the kernel carries into
    each: ``(chunks, g0, r0)`` arrays over every (warp, round) that runs, and
    the tail warp's index."""
    g4 = group // 4
    magic, shift = _magic(g4)
    n_chunks = n // 4 // QUADS
    warps = grid * tquant.DQ_WARPS
    warp = np.arange(warps, dtype=np.int64)
    first, step = warp * QUADS, warps * QUADS
    assert first.max() < 2 ** 31 and step < 2 ** 31  # the magic's range
    g0 = _div(first, magic, shift).astype(np.int64)
    r0 = first - g0 * g4
    step_g = int(_div(step, magic, shift))
    step_r = step - step_g * g4
    out_c, out_g, out_r = [], [], []
    c = warp.copy()
    while True:
        live = c < n_chunks
        if not live.any():
            break
        out_c.append(c[live])
        out_g.append(g0[live])
        out_r.append(r0[live])
        g0 = g0 + step_g
        r0 = r0 + step_r
        wrap = r0 >= g4
        r0 = np.where(wrap, r0 - g4, r0)
        g0 = np.where(wrap, g0 + 1, g0)
        c = c + warps
    cat = (lambda xs: np.concatenate(xs)) if out_c else (lambda xs: np.zeros(0, np.int64))
    return cat(out_c), cat(out_g), cat(out_r), n_chunks % warps


_EDGES = [(8, 8), (24, 8), (8 * 4_097, 8), (8 * 1_700_001, 8), (24, 24), (24 * 560_001, 24),
          (4096, 4096), (4096 * 3_301, 4096), (P_MAIN, 256), (P_MAIN, 512), (STRIDE, 256),
          (STRIDE - 16, 8), (STRIDE + 16, 8), (2048, 256), (2048 + 8, 8)]


@pytest.mark.parametrize("n,group", _EDGES)
def test_every_quad_once_with_its_own_group(n, group):
    grid = tquant.dequant_plan(n, H100_SMS)
    g4 = group // 4
    magic, shift = _magic(g4)
    chunks, g0, r0, tail_warp = _walk(n, group, grid)
    assert tail_warp < grid * tquant.DQ_WARPS  # the warp next in line exists
    # Each chunk's 16 stores of 32 lanes: quad q0 + 32 j + lane, group g0 + gl.
    off = np.arange(QUADS, dtype=np.int64)
    quads = (chunks[:, None] * QUADS + off[None, :]).reshape(-1)
    local = (r0[:, None] + off[None, :])
    assert local.max(initial=0) < 2 ** 31
    groups = (g0[:, None] + _div(local, magic, shift).astype(np.int64)).reshape(-1)
    # The tail: quads past the last whole chunk, group by a plain division.
    tail = np.arange(n // 4 // QUADS * QUADS, n // 4, dtype=np.int64)
    quads = np.concatenate([quads, tail])
    groups = np.concatenate([groups, tail // g4])
    written = np.bincount(quads, minlength=n // 4)
    assert written.shape[0] == n // 4 and np.all(written == 1)
    assert np.array_equal(groups, quads // g4)
    assert np.array_equal(np.unique(groups), np.arange(n // group))


@pytest.mark.parametrize("n,group", [(P_SERVE, 256), (2 ** 31 + 2 ** 20 + 256, 256),
                                     (24 * 10 ** 8, 24), (2 ** 33 + 4096, 4096)])
def test_carried_group_of_every_chunk_past_2_31(n, group):
    """Rows past 2^31 values: the group and offset carried into each of the
    chunks are the first quad's ``divmod`` (64-bit quads, 32-bit offsets)."""
    chunks, g0, r0, _ = _walk(n, group, tquant.dequant_plan(n, H100_SMS))
    assert np.array_equal(np.sort(chunks), np.arange(n // tquant.DQ_CHUNK))
    q0 = chunks * QUADS
    assert np.array_equal(g0, q0 // (group // 4)) and np.array_equal(r0, q0 % (group // 4))
    assert r0.max() + QUADS < 2 ** 31


@pytest.mark.parametrize("n", [0, 8, 2048, 2056, STRIDE, P_MAIN, 73_937_920, 1_228_025_856,
                               2 ** 31 + 2 ** 20 + 256, P_SERVE, 16 * 10 ** 9])
def test_grid_balances_the_rounds_and_fits_the_entry(n):
    grid = tquant.dequant_plan(n, H100_SMS)
    assert 1 <= grid <= min(GRID_CAP, H100_SMS * tquant.DQ_BLOCKS_PER_SM, 2 ** 31 - 1)
    chunks = n // tquant.DQ_CHUNK
    warps = grid * tquant.DQ_WARPS
    per_warp = [len(range(w, chunks, warps)) for w in range(min(warps, 8))]
    rounds = -(-chunks // (H100_SMS * tquant.DQ_BLOCKS_PER_SM * tquant.DQ_WARPS))
    assert max(per_warp) == rounds  # no more rounds than the full card would take
    assert chunks == 0 or chunks > (rounds - 1) * warps  # and every round has work


def test_plan_shape_is_the_kernels():
    """``DQ_WARPS``, ``DQ_CHUNK`` and ``DQ_BLOCKS_PER_SM`` are the warps a
    block, the values a warp's chunk holds and the launch bound's blocks an
    SM of the ``dequantize_kernel`` that ``csrc/quantize.cu`` builds."""
    src = (pathlib.Path(tquant.__file__).parent / "csrc" / "quantize.cu").read_text()
    const: dict[str, int] = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src, re.M):
        const[name] = eval(expr.replace("/", "//"), {}, dict(const))  # noqa: S307
    assert tquant.DQ_WARPS == const["kDqWarps"] == const["kThreads"] // 32
    assert tquant.DQ_CHUNK == 4 * const["kDqChunkQuads"]
    assert tquant.DQ_BLOCKS_PER_SM == const["kDqBlocksPerSm"]
    assert "__launch_bounds__(kThreads, kDqBlocksPerSm)\ndequantize_kernel(" in src


def test_one_round_at_the_10m_row():
    """The int8-wire leg's row: 4,968 chunks, one a warp, so one grid stride
    covers the row exactly."""
    assert P_MAIN // tquant.DQ_CHUNK == 4_968
    assert STRIDE == P_MAIN


@pytest.mark.parametrize("groups", [range(8, 1025, 8), range(1032, 4097, 8),
                                    [2 ** 20, 3 * 2 ** 19, 2 ** 28 + 8, 2 ** 31 - 8]])
def test_division_by_the_magic_number_is_exact(groups):
    """Every offset a chunk's stores reach (below group / 4 + 512) and the
    largest first quad and stride the grid cap allows, for every group."""
    for group in groups:
        g4 = group // 4
        magic, shift = _magic(g4)
        assert magic < 2 ** 32 and shift >= 0
        x = np.concatenate([np.arange(min(g4 + QUADS, 1 << 16), dtype=np.int64),
                            np.arange(g4 + QUADS - 64, g4 + QUADS, dtype=np.int64),
                            np.array([2 ** 30, 2 ** 30 - 1, 2 ** 31 - 1], dtype=np.int64)])
        assert np.array_equal(_div(x, magic, shift).astype(np.int64), x // g4), group
