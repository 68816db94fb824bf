"""The port's masked/unmasked FedAvg against the reference's kernels.

On the CPU the port's ``kernels/ops`` runs the plain torch version; it is
held against the reference's Pallas kernels (``repro.kernels.ops``, interpret
mode on the CPU, as ``tests/test_kernels.py`` runs them), the reference's
jnp oracles and the port's f64 oracle, on the same numpy inputs.  Bars are
those of ``tests/test_kernels.py``: atol = rtol = 1e-5 for f32 rows and 3e-2
for bf16 rows (bf16 inputs rounded identically in both frameworks).  The
hand-written kernel itself runs only on the card
(``tests/test_torch_cuda.py``, ``cuda`` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import aggregation as tagg
from repro_torch.kernels import fedavg as tfed
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

_DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _inputs(n, p, seed):
    rng = np.random.default_rng(seed)
    rows = (rng.normal(size=(n, p)) * 3).astype(np.float32)
    w = (rng.uniform(size=(n,)) + 0.05).astype(np.float32)
    mask = np.ones((n,), np.float32)
    mask[1::3] = 0.0  # every third row dead (none when n == 1)
    return rows, w, mask


def _both(rows, dtype):
    jd, td, _ = _DTYPES[dtype]
    return jnp.asarray(rows).astype(jd), torch.from_numpy(rows).to(td)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("p", [1024, 16384, 50_001])
@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_fedavg_matches_reference(n, p, dtype):
    tol = _DTYPES[dtype][2]
    rows, w, _ = _inputs(n, p, seed=n * p)
    jrows, trows = _both(rows, dtype)
    got = tops.fedavg(trows, torch.from_numpy(w)).numpy()
    _close(got, jops.fedavg(jrows, jnp.asarray(w)), tol)
    _close(got, jref.fedavg_ref(jrows, jnp.asarray(w)), tol)
    _close(got, tref.fedavg_f64(trows, w), tol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("p", [1024, 16384, 50_001])
@pytest.mark.parametrize("n", [1, 2, 7, 64])
def test_masked_fedavg_matches_reference_with_nan_dead_rows(n, p, dtype):
    tol = _DTYPES[dtype][2]
    rows, w, mask = _inputs(n, p, seed=n * p + 1)
    rows[mask == 0] = np.nan  # a dead row's garbage must not leak
    jrows, trows = _both(rows, dtype)
    got = tops.masked_fedavg(trows, torch.from_numpy(w), torch.from_numpy(mask)).numpy()
    assert np.isfinite(got).all()
    jm = jnp.asarray(mask)
    _close(got, jops.masked_fedavg(jrows, jnp.asarray(w), jm), tol)
    _close(got, jref.masked_fedavg_ref(jrows, jnp.asarray(w), jm), tol)
    _close(got, tref.masked_fedavg_f64(trows, w, mask), tol)


def test_zero_weights_fall_back_to_uniform():
    rows, _, mask = _inputs(7, 2048, seed=3)
    zero = np.zeros((7,), np.float32)
    trows = torch.from_numpy(rows)
    # Unmasked: the controller's aggregation.fedavg (not fedavg_pallas's
    # unguarded w / sum(w), which divides by zero) — uniform over every row.
    got = tops.fedavg(trows, torch.from_numpy(zero)).numpy()
    _close(got, jagg.fedavg(jnp.asarray(rows), jnp.asarray(zero)), 1e-5)
    _close(got, rows.mean(axis=0), 1e-5)
    # Masked: uniform over the valid rows.
    got = tops.masked_fedavg(trows, torch.from_numpy(zero), torch.from_numpy(mask)).numpy()
    _close(got, jops.masked_fedavg(jnp.asarray(rows), jnp.asarray(zero), jnp.asarray(mask)),
           1e-5)
    _close(got, rows[mask > 0].mean(axis=0), 1e-5)


def test_empty_mask_gives_zeros():
    rows, w, _ = _inputs(5, 1024, seed=4)
    empty = np.zeros((5,), np.float32)
    got = tops.masked_fedavg(torch.from_numpy(rows), torch.from_numpy(w),
                             torch.from_numpy(empty)).numpy()
    assert not got.any()
    want = jops.masked_fedavg(jnp.asarray(rows), jnp.asarray(w), jnp.asarray(empty))
    assert not np.asarray(want).any()


def test_aggregation_rules_match_reference():
    """The controller-facing rules of core/aggregation.py, incl. staleness."""
    rows, w, mask = _inputs(7, 4096, seed=5)
    rows[mask == 0] = np.nan
    versions = np.array([0, 1, 2, 3, 0, 5, 2], np.float32)  # row 5 is ahead: clamps to 0
    t = {k: torch.from_numpy(v) for k, v in
         dict(rows=rows, w=w, mask=mask, versions=versions).items()}
    j = {k: jnp.asarray(v) for k, v in
         dict(rows=rows, w=w, mask=mask, versions=versions).items()}
    got = tagg.masked_staleness_average(t["rows"], t["w"], t["versions"], 3.0, t["mask"], 0.5)
    want = jagg.masked_staleness_average(j["rows"], j["w"], j["versions"], jnp.float32(3.0),
                                         j["mask"], 0.5)
    _close(got.numpy(), want, 1e-5)
    stal = np.maximum(3.0 - versions, 0.0)
    np.testing.assert_allclose(tagg.staleness_weights(t["w"], torch.from_numpy(stal)).numpy(),
                               np.asarray(jagg.staleness_weights(j["w"], jnp.asarray(stal))),
                               rtol=1e-6)
    got = tagg.masked_weighted_average(t["rows"], t["w"], t["mask"]).numpy()
    _close(got, jagg.masked_weighted_average(j["rows"], j["w"], j["mask"]), 1e-5)
    _close(got, tref.masked_fedavg_f64(rows, w, mask), 1e-5)
    clean = np.nan_to_num(rows)
    got = tagg.weighted_average(torch.from_numpy(clean), t["w"]).numpy()
    _close(got, jagg.weighted_average(jnp.asarray(clean), j["w"]), 1e-5)
    _close(got, tref.fedavg_f64(clean, w), 1e-5)


def test_ops_refuse_other_devices():
    meta = torch.empty((3, 1024), device="meta")
    w = torch.ones((3,), device="meta")
    with pytest.raises(ValueError, match="no kernel route"):
        tops.fedavg(meta, w)
    with pytest.raises(ValueError, match="no kernel route"):
        tops.masked_fedavg(meta, w, w)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The kernel wrappers never take a host tensor (no silent fallback)."""
    rows = torch.zeros((2, 1024))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfed.masked_fedavg_cuda(rows, torch.ones(2), torch.ones(2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tfed.fedavg_cuda(rows, torch.ones(2))
