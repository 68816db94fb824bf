"""The port on the card: the hand-written kernels and sync rounds through them.

Needs a CUDA card; every test skips without one (decided inside the
``cuda_device`` fixture, never at import).  This file imports neither JAX nor
the reference, so it runs where only the port is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Kernel bars: atol = rtol = 1e-5 for f32 rows, 3e-2 for bf16 rows, against
the plain torch version on the same card and the f64 host oracle (FedAvg
also at the main path's full widths, where every block walks several tiles
and the arena passes 2^31 bytes, at N = 1,100 and 2,500, on an unaligned
view, at P of 1, 3 and 5, with one live row among NaN ones, zero weights and
the empty mask, two launches bit-identical, one device kernel per wrapper
call); quantize
and dequantize bit-identical to their plain versions (``ops.quantize`` on
unpadded rows with ragged tails, one launch that writes the wire's layout);
the fused dequant-into-aggregate at atol = rtol = 2e-5; the masked trimmed
mean at atol = rtol = 1e-5 in f32 and bf16 alike (both versions widen bf16
to f32 exactly and sum the band in sorted order, up to the torch
reduction's grouping), on both sides of each of the sorting network's
template sizes and of the switch to the rank-select past 64 rows, and at
full width; each of quantize and the trimmed mean one device kernel a call.
The robust rules' sorts (both medians, both trimmed means' plain versions)
equal the host's bit for bit with a negative and a positive NaN in live rows.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import housing_mlp
from repro_torch.core import Driver, FederationEnv, TerminationCriteria
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import fedavg as tfed
from repro_torch.kernels import fused_agg as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref as tref
from repro_torch.kernels import robust as trobust
from repro_torch.launch import train
from repro_torch.models import mlp

pytestmark = pytest.mark.cuda

_TOL = {torch.float32: 1e-5, torch.bfloat16: 3e-2}
P_MAIN = 10_174_464  # housing-mlp-10m's arena row
P_STACK = 10_174_081  # the stack leg's unpadded rows, not 16-byte aligned


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no host mode")
    return torch.device("cuda")


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [1024, 50_001])
@pytest.mark.parametrize("n", [1, 7, 64])
def test_kernel_matches_plain(cuda_device, n, p, dtype):
    rng = np.random.default_rng(n + p)
    rows = (rng.normal(size=(n, p)) * 3).astype(np.float32)
    w = (rng.uniform(size=(n,)) + 0.05).astype(np.float32)
    mask = np.ones((n,), np.float32)
    mask[1::3] = 0.0
    trows = torch.from_numpy(rows).to(cuda_device, dtype)
    tw, tm = torch.from_numpy(w).to(cuda_device), torch.from_numpy(mask).to(cuda_device)
    before = (tfed.masked_fedavg_cuda.launches, tfed.fedavg_cuda.launches)
    got_u = tops.fedavg(trows, tw)
    trows[tm == 0] = float("nan")
    got_m = tops.masked_fedavg(trows, tw, tm)
    assert (tfed.masked_fedavg_cuda.launches, tfed.fedavg_cuda.launches) == (
        before[0] + 1, before[1] + 1)
    _close(got_m.cpu(), tfed.masked_fedavg_torch(trows, tw, tm).cpu(), _TOL[dtype])
    _close(got_u.cpu(), tref.fedavg_f64(torch.from_numpy(rows).to(dtype), w), _TOL[dtype])


def _fedavg_edge_inputs(case, dtype, dev):
    """Rows, weights and mask for one of the cases the redesigned kernel opens:
    N past the old 1,024 staging limit (1,100) and past the kernel's 2,048
    staging cap (2,500); a view whose ``data_ptr`` and rows are not 16-byte
    aligned; widths under one 16-byte window; one live row among NaN ones; zero
    weights; the empty mask."""
    shapes = {"n1100": (1100, 777), "n2500": (2500, 333), "unaligned_view": (32, 5001),
              "p1": (7, 1), "p3": (7, 3), "p5": (7, 5), "one_live": (32, 4099),
              "zero_weights": (7, 5003), "empty_mask": (7, 5003)}
    n, p = shapes[case]
    rng = np.random.default_rng(sorted(shapes).index(case))
    rows = torch.from_numpy((rng.normal(size=(n, p)) * 3).astype(np.float32)).to(dev, dtype)
    w = torch.from_numpy((rng.uniform(size=(n,)) + 0.05).astype(np.float32)).to(dev)
    m = torch.ones((n,), device=dev)
    m[1::3] = 0.0
    if case == "unaligned_view":
        rows = rows[:, 1:]
        assert rows.data_ptr() % 16 and (rows.stride(0) * rows.element_size()) % 16
    elif case == "one_live":
        m = torch.zeros((n,), device=dev)
        m[13] = 1.0
    elif case == "zero_weights":
        w = torch.zeros((n,), device=dev)
    elif case == "empty_mask":
        m = torch.zeros((n,), device=dev)
    rows[m == 0] = float("nan")
    return rows, w, m


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["n1100", "n2500", "unaligned_view", "p1", "p3", "p5",
                                  "one_live", "zero_weights", "empty_mask"])
def test_fedavg_kernel_edge_cases(cuda_device, case, dtype):
    rows, w, m = _fedavg_edge_inputs(case, dtype, cuda_device)
    tol = _TOL[dtype]
    got = tops.masked_fedavg(rows, w, m)
    again = tops.masked_fedavg(rows, w, m)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))  # no atomics
    want = tfed.masked_fedavg_torch(rows, w, m)
    assert torch.isfinite(got).all()
    _close(got.cpu(), want.cpu(), tol)
    if case == "empty_mask":
        assert torch.count_nonzero(got) == 0
    if case == "zero_weights":  # uniform over the valid rows
        _close(got.cpu(), rows.float()[m > 0].mean(0).cpu(), tol)
    clean = torch.nan_to_num(rows, nan=0.5)
    got_u = tops.fedavg(clean, w)
    again_u = tops.fedavg(clean, w)
    assert torch.equal(got_u.view(torch.int32), again_u.view(torch.int32))
    _close(got_u.cpu(), tfed.fedavg_torch(clean, w).cpu(), tol)




@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("p", [P_STACK, P_MAIN])
@pytest.mark.parametrize("n", [1, 7, 32, 64])
def test_fedavg_kernel_at_full_width(cuda_device, n, p, dtype):
    """The shapes ``chip_smoke.py`` checks at full width: every block walks
    several tiles round the ring, and at N = 64 the f32 arena passes 2^31
    bytes, so row offsets need 64-bit arithmetic."""
    gen = torch.Generator(device=cuda_device).manual_seed(n * 7 + p % 97)
    rows = (torch.randn((n, p), generator=gen, device=cuda_device) * 3).to(dtype)
    w = torch.rand((n,), generator=gen, device=cuda_device) + 0.05
    plan = tfed.launch_plan(rows)
    assert plan.n_tiles > plan.grid  # at least two tiles for some block
    got_u = tops.fedavg(rows, w)
    _close(got_u.cpu(), tfed.fedavg_torch(rows, w).cpu(), _TOL[dtype])
    m = torch.ones((n,), device=cuda_device)
    m[1::3] = 0.0
    rows[m == 0] = float("nan")
    got = tops.masked_fedavg(rows, w, m)
    again = tops.masked_fedavg(rows, w, m)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    _close(got.cpu(), tfed.masked_fedavg_torch(rows, w, m).cpu(), _TOL[dtype])


def test_fedavg_wrappers_launch_one_device_kernel(cuda_device):
    """Each wrapper call is one device kernel, the normalization inside it."""
    from torch.profiler import ProfilerActivity, profile

    rows = torch.randn((32, 70_001), device=cuda_device)
    w = torch.rand((32,), device=cuda_device) + 0.05
    m = torch.ones((32,), device=cuda_device)
    for call in (lambda: tfed.masked_fedavg_cuda(rows, w, m), lambda: tfed.fedavg_cuda(rows, w)):
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert len(names) == 5 and all("fedavg_kernel" in k for k in names), names


def test_sync_rounds_launch_the_kernel(cuda_device):
    rounds = 2
    _, learners = train.build_housing_learners("100k", 3, 0, device=cuda_device)
    init = mlp.init_params(torch.Generator().manual_seed(0), housing_mlp.reduced(), cuda_device)
    driver = Driver(FederationEnv(protocol="sync", local_steps=2, batch_size=16,
                                  termination=TerminationCriteria(max_rounds=rounds),
                                  device=cuda_device))
    driver.initialize(init, learners)
    before = tfed.masked_fedavg_cuda.launches
    history = driver.run()
    assert tfed.masked_fedavg_cuda.launches - before == rounds
    assert driver.controller.arena.buffer.device.type == "cuda"
    assert all(np.isfinite(h.metrics["eval_loss"]) for h in history)


def _special(size, group, seed):
    """Normal data plus groups of NaN, ±inf, zeros and subnormals."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=size) * 5).astype(np.float32)
    x[:group] = 0.0
    x[group: 2 * group] = (rng.normal(size=group) * 1e-39).astype(np.float32)
    x[2 * group + 3] = np.nan
    x[3 * group + 5] = np.inf
    x[4 * group + 7] = -np.inf
    x[5 * group: 6 * group] = (rng.normal(size=group) * 1e-37).astype(np.float32)
    return x


@pytest.mark.parametrize("group", [256, 512])
@pytest.mark.parametrize("size", [16_384, 100_000, 100_225, 100_001, 100_007, P_STACK])
def test_quantize_kernels_match_plain(cuda_device, size, group):
    """``ops.quantize`` reads the unpadded row (a last group of 129 at
    100,225, tails at 1 and 7 mod 8) and writes the wire's layout in one
    launch, bit-identical to padding then quantizing."""
    x = torch.from_numpy(_special(size, group, seed=size)).to(cuda_device)
    before = (tquant.quantize_cuda.launches, tquant.dequantize_cuda.launches)
    q, s = tops.quantize(x, group=group)
    assert tquant.quantize_cuda.launches == before[0] + 1
    assert s.data_ptr() == q.data_ptr() + q.shape[0]  # one buffer, the wire's layout
    padded = torch.nn.functional.pad(x, (0, q.shape[0] - size))
    pq, ps = tquant.quantize_torch(padded, group)
    assert torch.equal(q, pq)
    assert torch.equal(s.view(torch.int32), ps.view(torch.int32))
    back = tops.dequantize(q, s, size, group=group)
    want = tquant.dequantize_torch(q, s, group)[:size]
    assert torch.equal(back.view(torch.int32), want.view(torch.int32))
    assert (tquant.quantize_cuda.launches, tquant.dequantize_cuda.launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("n,p,group", [(7, 4096, 256), (33, 2304, 256), (4, 4096, 512)])
def test_fused_q8_kernel_matches_plain(cuda_device, n, p, group):
    rng = np.random.default_rng(n + p)
    q = torch.from_numpy(rng.integers(-127, 128, size=(n, p), dtype=np.int8)).to(cuda_device)
    s = torch.from_numpy(rng.uniform(0.01, 5, size=(n, p // group)).astype(np.float32))
    s = s.to(cuda_device)
    w = torch.from_numpy(rng.uniform(1, 50, size=n).astype(np.float32)).to(cuda_device)
    m = torch.ones((n,), device=cuda_device)
    m[1::3] = 0.0
    s[m == 0] = float("nan")  # a dead row's garbage must not leak
    before = tfused.masked_fedavg_q8_cuda.launches
    got = tops.masked_fedavg_q8(q, s, w, m, group=group)
    assert tfused.masked_fedavg_q8_cuda.launches == before + 1
    assert torch.isfinite(got).all()
    want = tfused.masked_fedavg_q8_torch(q, s, w, m, group)
    _close(got.cpu(), want.cpu(), 2e-5)
    empty = tops.masked_fedavg_q8(q, s, w, torch.zeros_like(m), group=group)
    assert torch.count_nonzero(empty) == 0


def test_int8_arena_rounds_launch_the_fused_kernel(cuda_device):
    rounds, n_learners = 2, 3
    _, learners = train.build_housing_learners("100k", n_learners, 0, device=cuda_device)
    init = mlp.init_params(torch.Generator().manual_seed(0), housing_mlp.reduced(), cuda_device)
    driver = Driver(FederationEnv(protocol="sync", local_steps=2, batch_size=16,
                                  upload_codec="int8", arena_dtype="int8",
                                  termination=TerminationCriteria(max_rounds=rounds),
                                  device=cuda_device))
    driver.initialize(init, learners)
    before = (tfused.masked_fedavg_q8_cuda.launches, tquant.quantize_cuda.launches)
    history = driver.run()
    assert tfused.masked_fedavg_q8_cuda.launches - before[0] == rounds
    assert tquant.quantize_cuda.launches - before[1] == rounds * n_learners
    arena = driver.controller.arena
    assert arena.buffer.device.type == "cuda" and arena.buffer.dtype == torch.int8
    assert driver.controller.telemetry.value("engine.uploads.quantized_direct") == (
        rounds * n_learners)
    assert all(np.isfinite(h.metrics["eval_loss"]) for h in history)


def _trimmed_inputs(n, p, seed, device, dead=True):
    """Normal rows (a third of them dead, holding NaN and 1e30), duplicated
    and negated rows, a block of all-equal columns and a ±0 column: the
    kernel's ties and garbage.  Made on the card, so full width is quick."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = torch.randn((n, p), generator=gen, device=device) * 3
    if n >= 4:
        rows[n // 2] = rows[0]
        rows[n // 2 + 1] = -rows[1]
    rows[:, : p // 8] = 0.5
    rows[::2, p // 8] = 0.0
    rows[1::2, p // 8] = -0.0
    mask = torch.ones((n,), device=device)
    if dead:
        mask[2::3] = 0.0
        rows[2::3] = float("nan")
        rows[5::6] = 1e30
    return rows, mask


# N on both sides of each of the network's template sizes (4, 8, 16, 32, 64)
# and of the switch to the rank-select past 64, with trim_k at 0 or 1,
# middling and 2·trim_k = N − 1; then full width at N = 32 and 64, where
# the row offsets pass 2^31 bytes.
_TRIMMED_CASES = [
    (n, trim_k, p)
    for p in (1024, 5000)
    for n, trim_k in ((3, 0), (3, 1), (8, 3), (33, 8), (64, 31), (2001, 1000), (2, 0), (4, 1),
                      (5, 2), (16, 7), (17, 8), (31, 15), (32, 1), (63, 31), (65, 32), (65, 1))
] + [(32, 8, P_MAIN), (64, 16, P_MAIN), (64, 1, P_MAIN)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,trim_k,p", _TRIMMED_CASES)
def test_trimmed_mean_kernel_matches_plain(cuda_device, n, trim_k, p, dtype):
    for dead in (False, True):
        rows, tm = _trimmed_inputs(n, p, seed=n + p + trim_k, device=cuda_device, dead=dead)
        trows = rows.to(dtype)
        before = trobust.masked_trimmed_mean_cuda.launches
        got = tops.masked_trimmed_mean(trows, torch.ones_like(tm), tm, trim_k=trim_k)
        torch.cuda.synchronize()
        assert trobust.masked_trimmed_mean_cuda.launches == before + 1
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        want = trobust.masked_trimmed_mean_torch(trows, tm, trim_k)
        _close(got.cpu(), want.cpu(), 1e-5)
        if p < P_MAIN:  # the host f64 sort of a full-width arena takes too long
            oracle = tref.masked_trimmed_mean_f64(trows.float().cpu(), tm.cpu(), trim_k)
            _close(got.cpu(), oracle, 1e-5)
        del rows, trows


def test_trimmed_mean_kernel_edges(cuda_device):
    trows, _ = _trimmed_inputs(8, 3000, seed=1, device=cuda_device)
    none = tops.masked_trimmed_mean(trows, torch.ones(8), torch.zeros(8, device=cuda_device), 2)
    assert torch.count_nonzero(none) == 0
    two = torch.zeros(8, device=cuda_device)
    two[[0, 4]] = 1.0  # degenerate cohort: the untrimmed mean of rows 0 and 4
    got = tops.masked_trimmed_mean(trows, torch.ones(8), two, trim_k=2)
    _close(got.cpu(), ((trows[0] + trows[4]) / 2.0).cpu(), 1e-5)
    with pytest.raises(ValueError, match="trim_k=4 invalid for N=8"):
        trobust.masked_trimmed_mean_cuda(trows, torch.ones(8, device=cuda_device), 4)
    padded = torch.zeros((8, 4096), device=cuda_device)
    padded[:, :3000] = trows  # the arena's padded width, read in place
    got = tops.masked_trimmed_mean(padded[:, :3000], torch.ones(8),
                                   torch.ones(8, device=cuda_device), trim_k=1)
    want = trobust.masked_trimmed_mean_torch(trows, torch.ones(8, device=cuda_device), 1)
    _close(got.cpu(), want.cpu(), 1e-5)


@pytest.mark.parametrize("n,trim_k", [(8, 1), (8, 3), (5, 2), (33, 8), (64, 31)])
def test_trimmed_mean_kernel_nan_in_live_rows(cuda_device, n, trim_k):
    """A NaN in a live row (x86's negative NaN too) and +inf meeting -inf:
    the kernel agrees with the sort, which puts NaN of either sign last, on
    the band and on the degenerate fallback alike.  It is held against the
    plain version on the host: ``torch.sort`` on the card puts a negative NaN
    first."""
    rows, _ = _trimmed_inputs(n, 3000, seed=n + trim_k, device=cuda_device, dead=False)
    rows[2::3] = float("nan")
    rows[4::5] = -float("nan")
    rows[1, :500] = float("inf")
    rows[3, 300:900] = -float("inf")
    for mask in (torch.ones(n, device=cuda_device),
                 (torch.arange(n, device=cuda_device) % 4 != 3).float()):
        got = trobust.masked_trimmed_mean_cuda(rows, mask, trim_k).cpu()
        want = trobust.masked_trimmed_mean_torch(rows.cpu(), mask.cpu(), trim_k)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        both = ~torch.isnan(want)
        _close(got[both], want[both], 1e-5)


def test_quantize_and_trimmed_mean_launch_one_device_kernel(cuda_device):
    """``ops.quantize`` on the unpadded row and the trimmed mean are each one
    device kernel a call (no pad, no copy, no torch op).  The profiler must
    have recorded them, so the test cannot pass on an empty trace.  It has
    been seen to miss a record now and then, and a whole window once, never
    to add one; so a window is traced up to three times, and one missed
    record of ten is accepted."""
    from torch.profiler import ProfilerActivity, profile

    x = torch.randn((P_STACK,), device=cuda_device)
    rows = torch.randn((32, 70_001), device=cuda_device)
    m = torch.ones((32,), device=cuda_device)
    for call, kernel in ((lambda: tops.quantize(x), "quantize_kernel"),
                         (lambda: trobust.masked_trimmed_mean_cuda(rows, m, 8), "network_kernel")):
        call()
        torch.cuda.synchronize()
        for _ in range(3):  # a window that missed a record is traced again
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    call()
                torch.cuda.synchronize()
            names = [e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA]
            if len(names) >= 10:
                break
        assert 9 <= len(names) <= 10 and all(kernel in k for k in names), names


def test_trimmed_mean_rounds_launch_the_kernel(cuda_device):
    rounds = 2
    _, learners = train.build_housing_learners("100k", 5, 0, device=cuda_device)
    init = mlp.init_params(torch.Generator().manual_seed(0), housing_mlp.reduced(), cuda_device)
    driver = Driver(FederationEnv(protocol="sync", local_steps=2, batch_size=16,
                                  aggregation_rule="trimmed_mean", trim_k=2,
                                  termination=TerminationCriteria(max_rounds=rounds),
                                  device=cuda_device))
    driver.initialize(init, learners)
    before = (trobust.masked_trimmed_mean_cuda.launches, tfed.masked_fedavg_cuda.launches)
    history = driver.run()
    assert trobust.masked_trimmed_mean_cuda.launches - before[0] == rounds
    assert tfed.masked_fedavg_cuda.launches == before[1]
    assert all(np.isfinite(h.metrics["eval_loss"]) for h in history)


_NEG_NAN = float(np.array([0xFFC00000], np.uint32).view(np.float32)[0])  # sign bit set


def _nan_rows(n, p, seed):
    """Integer-valued rows (every sum exact in any order) with a negative and a
    positive NaN in live rows, and NaN in the dead row 0."""
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.integers(-50, 50, size=(n, p)).astype(np.float32))
    rows[2, ::3] = _NEG_NAN
    rows[5, 1::4] = float("nan")
    rows[7, ::7] = _NEG_NAN
    rows[0] = _NEG_NAN
    mask = torch.ones(n)
    mask[0] = 0.0
    return rows, mask


_ROBUST_SORTS = {
    # n = 9 rows, row 0 dead: 8 live, so trim_k 2 leaves a band of 4 and
    # every mean divides by a power of two (the card multiplies by 1/count)
    "masked_coordinate_median": lambda r, m: tagg.masked_coordinate_median(r, m, m),
    "masked_trimmed_mean_torch": lambda r, m: trobust.masked_trimmed_mean_torch(r, m, 2),
    "trimmed_mean": lambda r, m: tagg.trimmed_mean(r[1:], 2),
    "coordinate_median": lambda r, m: tagg.coordinate_median(r[1:]),
}


@pytest.mark.parametrize("name", sorted(_ROBUST_SORTS))
def test_robust_sorts_put_every_nan_last_on_the_card(cuda_device, name):
    """``torch.sort`` on the card puts a negative NaN first; each robust sort
    makes NaN positive first, so the card's result equals the host's bit for
    bit.  NaN results are compared as NaN: the card's arithmetic returns its
    own NaN payload."""
    rows, mask = _nan_rows(9, 4099, seed=3)
    fn = _ROBUST_SORTS[name]
    want = fn(rows, mask)
    got = fn(rows.to(cuda_device), mask.to(cuda_device)).cpu()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32))
