"""The port on the card: the hand-written kernels and sync rounds through them.

Needs a CUDA card; every test skips without one (decided inside the
``cuda_device`` fixture, never at import).  This file imports neither JAX nor
the reference, so it runs where only the port is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Kernel bars: atol = rtol = 1e-5 for f32 rows, 3e-2 for bf16 rows, against
the plain torch version on the same card and the f64 host oracle; quantize
and dequantize bit-identical to their plain versions; the fused
dequant-into-aggregate at atol = rtol = 2e-5; the masked trimmed mean at
atol = rtol = 1e-5 in f32 and bf16 alike (both versions widen bf16 to f32
exactly; they differ only in the order they sum the band).
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import housing_mlp
from repro_torch.core import Driver, FederationEnv, TerminationCriteria
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
@pytest.mark.parametrize("size", [16_384, 100_000])
def test_quantize_kernels_match_plain(cuda_device, size, group):
    x = torch.from_numpy(_special(size, group, seed=size)).to(cuda_device)
    before = (tquant.quantize_cuda.launches, tquant.dequantize_cuda.launches)
    q, s = tops.quantize(x, group=group)
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


def _trimmed_inputs(n, p, seed, dead=True):
    """Normal rows (a third of them dead, holding NaN and 1e30), duplicated
    rows and a block of all-equal columns: the kernel's ties and garbage."""
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(n, p)) * 3).astype(np.float32)
    if n >= 4:
        rows[n // 2] = rows[0]
        rows[n // 2 + 1] = -rows[1]
    rows[:, : p // 8] = 0.5
    mask = np.ones((n,), np.float32)
    if dead:
        mask[2::3] = 0.0
        rows[2::3] = np.nan
        rows[5::6] = 1e30
    return rows, mask


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,trim_k", [(3, 0), (3, 1), (8, 3), (33, 8), (64, 31), (2001, 1000)])
@pytest.mark.parametrize("p", [1024, 5000])
def test_trimmed_mean_kernel_matches_plain(cuda_device, n, trim_k, p, dtype):
    for dead in (False, True):
        rows, mask = _trimmed_inputs(n, p, seed=n + p + trim_k, dead=dead)
        trows = torch.from_numpy(rows).to(cuda_device, dtype)
        tm = torch.from_numpy(mask).to(cuda_device)
        before = trobust.masked_trimmed_mean_cuda.launches
        got = tops.masked_trimmed_mean(trows, torch.ones_like(tm), tm, trim_k=trim_k)
        torch.cuda.synchronize()
        assert trobust.masked_trimmed_mean_cuda.launches == before + 1
        assert got.dtype == torch.float32 and torch.isfinite(got).all()
        want = trobust.masked_trimmed_mean_torch(trows, tm, trim_k)
        _close(got.cpu(), want.cpu(), 1e-5)
        oracle = tref.masked_trimmed_mean_f64(trows.float().cpu(), mask, trim_k)
        _close(got.cpu(), oracle, 1e-5)


def test_trimmed_mean_kernel_edges(cuda_device):
    rows, mask = _trimmed_inputs(8, 3000, seed=1)
    trows = torch.from_numpy(rows).to(cuda_device)
    none = tops.masked_trimmed_mean(trows, torch.ones(8), torch.zeros(8, device=cuda_device), 2)
    assert torch.count_nonzero(none) == 0
    two = torch.zeros(8, device=cuda_device)
    two[[0, 4]] = 1.0  # degenerate cohort: the untrimmed mean of rows 0 and 4
    got = tops.masked_trimmed_mean(trows, torch.ones(8), two, trim_k=2)
    _close(got.cpu(), (rows[0] + rows[4]) / 2.0, 1e-5)
    with pytest.raises(ValueError, match="trim_k=4 invalid for N=8"):
        trobust.masked_trimmed_mean_cuda(trows, torch.ones(8, device=cuda_device), 4)
    padded = torch.zeros((8, 4096), device=cuda_device)
    padded[:, :3000] = trows  # the arena's padded width, read in place
    got = tops.masked_trimmed_mean(padded[:, :3000], torch.ones(8),
                                   torch.ones(8, device=cuda_device), trim_k=1)
    want = trobust.masked_trimmed_mean_torch(trows, torch.ones(8, device=cuda_device), 1)
    _close(got.cpu(), want.cpu(), 1e-5)


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
