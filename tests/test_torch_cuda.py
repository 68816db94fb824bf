"""The port on the card: the hand-written kernel and one sync round.

Needs a CUDA card; every test skips without one (decided inside the
``cuda_device`` fixture, never at import).  This file imports neither JAX nor
the reference, so it runs where only the port is installed:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

Kernel bars: atol = rtol = 1e-5 for f32 rows, 3e-2 for bf16 rows, against
the plain torch version on the same card and the f64 host oracle.
"""

import numpy as np
import pytest
import torch

from repro_torch.configs import housing_mlp
from repro_torch.core import Driver, FederationEnv, TerminationCriteria
from repro_torch.kernels import fedavg as tfed
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
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
