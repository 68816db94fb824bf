"""The robust rules in both packages: the trimmed-mean kernel's plain version,
the four aggregation rules, the controller's rule setup and federations.

The same numpy inputs go through the reference and the port on the CPU.  The
reference's Pallas kernel runs in interpret mode, as its own tests run it
(``repro.kernels.ops.INTERPRET`` is set on the CPU); the port's
``ops.masked_trimmed_mean`` takes its plain sort-then-trim on a host tensor.

Bars: the kernel-level comparisons use the reference's atol 1e-5
(``tests/test_kernels.py``); the aggregation rules atol = rtol = 1e-6 in f32
(the two sorts agree, the sums round alike) and one bf16 step (2^-8 relative)
in bf16; the conformance grid the reference's own tolerances
(``tests/test_conformance.py``: rtol 1e-5 / atol 1e-6 raw, 0.02 int8); the
housing federations rtol 1e-4 / atol 1e-5, as ``tests/test_torch_slice.py``
explains.  Errors and byte counts agree exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import housing_mlp
from repro.core import Driver as JDriver
from repro.core import FederationEnv as JEnv
from repro.core import TerminationCriteria as JTerm
from repro.core import aggregation as jagg
from repro.core import packing as jpack
from repro.core.controller import Controller as JController
from repro.core.learner import Learner as JLearner
from repro.core.scheduler import SyncProtocol as JSync
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import train as jtrain
from repro.models import mlp as jmlp
from repro.optim import sgd as jsgd
from repro_torch import optim as topt
from repro_torch.core import Driver as TDriver
from repro_torch.core import FederationEnv as TEnv
from repro_torch.core import TerminationCriteria as TTerm
from repro_torch.core import aggregation as tagg
from repro_torch.core import packing as tpack
from repro_torch.core.controller import Controller as TController
from repro_torch.core.learner import Learner as TLearner
from repro_torch.core.scheduler import SyncProtocol as TSync
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import robust as trobust
from repro_torch.launch import train as ttrain


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel (interpret) and oracles
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,trim_k", [(3, 1), (8, 1), (8, 3), (16, 4)])
@pytest.mark.parametrize("p", [1024, 5000])
def test_trimmed_mean_sweep_matches_pallas(n, trim_k, p):
    rng = np.random.default_rng(n * p + trim_k)
    arena = (rng.normal(size=(n, p)) * 3).astype(np.float32)
    mask = (rng.uniform(size=(n,)) > 0.3).astype(np.float32)
    w = np.ones((n,), np.float32)
    got = tops.masked_trimmed_mean(_t(arena), _t(w), _t(mask), trim_k=trim_k)
    assert got.dtype == torch.float32 and got.shape == (p,)
    pallas = jops.masked_trimmed_mean(jnp.asarray(arena), jnp.asarray(w),
                                      jnp.asarray(mask), trim_k=trim_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
    want = jref.masked_trimmed_mean_ref(jnp.asarray(arena), jnp.asarray(mask), trim_k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), tref.masked_trimmed_mean_f64(arena, mask, trim_k),
                               atol=1e-5)


def test_dead_row_garbage_never_leaks():
    arena = np.ones((6, 2048), np.float32)
    arena[2] = np.nan
    arena[4] = 1e30
    mask = np.array([1, 1, 0, 1, 0, 1], np.float32)
    got = tops.masked_trimmed_mean(_t(arena), torch.ones(6), _t(mask), trim_k=1)
    np.testing.assert_allclose(got.numpy(), np.ones(2048), atol=1e-6)
    pallas = jops.masked_trimmed_mean(jnp.asarray(arena), jnp.ones((6,)),
                                      jnp.asarray(mask), trim_k=1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(pallas))


def test_degenerate_cohort_falls_back_to_the_masked_mean():
    rng = np.random.default_rng(5)
    arena = rng.normal(size=(8, 1024)).astype(np.float32)
    mask = np.zeros((8,), np.float32)
    mask[[0, 5]] = 1.0
    got = tops.masked_trimmed_mean(_t(arena), torch.ones(8), _t(mask), trim_k=2)
    np.testing.assert_allclose(got.numpy(), (arena[0] + arena[5]) / 2.0, atol=1e-5)
    pallas = jops.masked_trimmed_mean(jnp.asarray(arena), jnp.ones((8,)),
                                      jnp.asarray(mask), trim_k=2)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
    empty = tops.masked_trimmed_mean(_t(arena), torch.ones(8), torch.zeros(8), trim_k=2)
    assert torch.count_nonzero(empty) == 0


def test_ties_duplicated_rows_and_equal_columns():
    """Clipped or sign-flipped rows and all-equal columns tie: the band must
    still be the sort's, whichever tied row it admits."""
    rng = np.random.default_rng(11)
    base = (rng.normal(size=(4, 3000)) * 2).astype(np.float32)
    arena = np.concatenate([base, base, -base[:2]], axis=0)  # (10, P), duplicates
    arena[:, :500] = 0.25  # all-equal columns
    mask = np.ones((10,), np.float32)
    mask[7] = 0.0
    for trim_k in (1, 2, 4):
        got = tops.masked_trimmed_mean(_t(arena), torch.ones(10), _t(mask), trim_k=trim_k)
        pallas = jops.masked_trimmed_mean(jnp.asarray(arena), jnp.ones((10,)),
                                          jnp.asarray(mask), trim_k=trim_k)
        np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)
        np.testing.assert_allclose(
            got.numpy(), tref.masked_trimmed_mean_f64(arena, mask, trim_k), atol=1e-5)
        np.testing.assert_array_equal(got.numpy()[:500], np.full(500, 0.25, np.float32))


@pytest.mark.parametrize("trim_k", [-1, 2, 3])
def test_trim_k_out_of_range_raises_like_reference(trim_k):
    arena = np.ones((4, 1024), np.float32)
    with pytest.raises(ValueError) as jerr:
        jops.masked_trimmed_mean(jnp.asarray(arena), jnp.ones((4,)), jnp.ones((4,)),
                                 trim_k=trim_k, block_p=1024)
    with pytest.raises(ValueError) as terr:
        tops.masked_trimmed_mean(_t(arena), torch.ones(4), torch.ones(4), trim_k=trim_k)
    assert str(terr.value) == str(jerr.value)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        trobust.masked_trimmed_mean_cuda(_t(arena), torch.ones(4), 1)


def test_host_path_never_counts_a_launch():
    before = trobust.masked_trimmed_mean_cuda.launches
    arena = torch.randn(5, 300)
    tops.masked_trimmed_mean(arena, torch.ones(5), torch.ones(5), trim_k=1)
    tagg.masked_trimmed_mean(arena, torch.ones(5), torch.ones(5), 2)
    assert trobust.masked_trimmed_mean_cuda.launches == before


# ---------------------------------------------------------------------------
# the four aggregation rules
# ---------------------------------------------------------------------------

_RULES = {
    "coordinate_median": lambda mod, x, w, m: mod.coordinate_median(x),
    "trimmed_mean": lambda mod, x, w, m: mod.trimmed_mean(x, 2),
    "masked_coordinate_median": lambda mod, x, w, m: mod.masked_coordinate_median(x, w, m),
    "masked_trimmed_mean": lambda mod, x, w, m: mod.masked_trimmed_mean(x, w, m, 2),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rule", sorted(_RULES))
def test_aggregation_rules_match_reference(rule, dtype):
    rng = np.random.default_rng(7)
    for n in (6, 7):  # even and odd cohorts: the median's midpoint and middle
        rows = (rng.normal(size=(n, 2500)) * 3).astype(np.float32)
        w = rng.uniform(1, 50, size=(n,)).astype(np.float32)
        mask = np.ones((n,), np.float32)
        mask[1] = 0.0
        rows[1] = np.nan  # a dead row's garbage (the unmasked rules see all rows)
        if not rule.startswith("masked"):
            rows[1] = rows[0] * 50.0
        jx = jnp.asarray(rows).astype(dtype)
        tx = _t(rows).to(getattr(torch, dtype))
        want = _RULES[rule](jagg, jx, jnp.asarray(w), jnp.asarray(mask))
        got = _RULES[rule](tagg, tx, _t(w), _t(mask))
        assert str(got.dtype).removeprefix("torch.") == str(want.dtype) == dtype
        tol = 1e-6 if dtype == "float32" else 2.0 ** -8
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


def test_median_matches_reference_semantics():
    """``jnp.median``'s: the two middle values averaged, NaN columns NaN, an
    integer stack's result f32; no valid row gives 0."""
    x = np.array([[1.0, 5.0, np.nan], [4.0, 2.0, 1.0], [2.0, 2.0, 3.0], [9.0, 0.0, 2.0]],
                 np.float32)
    got = tagg.coordinate_median(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jagg.coordinate_median(jnp.asarray(x))))
    np.testing.assert_array_equal(got[:2], [3.0, 2.0])
    assert np.isnan(got[2])
    ints = np.arange(12, dtype=np.int32).reshape(4, 3)
    got_i = tagg.coordinate_median(_t(ints))
    assert got_i.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(jagg.coordinate_median(ints)))
    none = tagg.masked_coordinate_median(_t(x), torch.ones(4), torch.zeros(4))
    assert torch.count_nonzero(none) == 0
    with pytest.raises(ValueError, match="too large"):
        tagg.trimmed_mean(_t(x), 2)
    with pytest.raises(ValueError, match="too large"):
        tagg.masked_trimmed_mean(_t(x), torch.ones(4), torch.ones(4), 2)


# ---------------------------------------------------------------------------
# the reference's conformance grid, run in both packages
# ---------------------------------------------------------------------------

_N, _ROUNDS, _TRIM_K = 4, 2, 1
_INIT = {"w": np.zeros((4, 1), np.float32)}


def _data(i):
    rng = np.random.default_rng(i)
    x = rng.normal(size=(64, 4)).astype(np.float32)
    return rng, x, x @ np.ones((4, 1), np.float32)


def _jlearner(i):
    rng, x, y = _data(i)

    def loss_fn(p, b):
        return jnp.mean((b[0] @ p["w"] - b[1]) ** 2)

    def data_fn(bs):
        j = rng.integers(0, 64, size=bs)
        return x[j], y[j]

    return JLearner(f"l{i}", loss_fn, lambda p, b: {"eval_loss": loss_fn(p, b)},
                    data_fn, lambda: (x, y), jsgd(0.05), 64)


def _tlearner(i):
    rng, x, y = _data(i)
    tx, ty = _t(x), _t(y)

    def loss_fn(p, b):
        return torch.mean((b[0] @ p["w"] - b[1]) ** 2)

    def data_fn(bs):
        j = torch.from_numpy(rng.integers(0, 64, size=bs))
        return tx[j], ty[j]

    return TLearner(f"l{i}", loss_fn, lambda p, b: {"eval_loss": loss_fn(p, b)},
                    data_fn, lambda: (tx, ty), topt.sgd(0.05), 64, device="cpu")


def _replay(rule):
    """The reference's f64 order-statistics replay: np.median / sort-then-trim
    over the replayed uploads, then the fedavg server step (a plain swap)."""
    learners = [_jlearner(i) for i in range(_N)]
    proto = JSync(local_steps=2, batch_size=16)
    params = {"w": jnp.asarray(_INIT["w"])}
    for r in range(_ROUNDS):
        task = proto.make_task(r, {})
        stack = np.stack([np.asarray(jpack.pack_numeric(l.fit(params, task).params),
                                     np.float64) for l in learners])
        if rule == "median":
            new = np.median(stack, axis=0)
        else:
            new = np.sort(stack, axis=0)[_TRIM_K: _N - _TRIM_K].mean(axis=0)
        params = {"w": jnp.asarray(new.astype(np.float32).reshape(4, 1))}
    return np.asarray(params["w"])


def _conformance_run(ctrl_cls, make_learner, init, **kw):
    ctrl = ctrl_cls(aggregation_rule=kw.pop("rule"), trim_k=_TRIM_K, **kw)
    ctrl.set_initial_model(init)
    for i in range(_N):
        ctrl.register_learner(make_learner(i))
    ctrl.engine.run(rounds=_ROUNDS)
    tel = ctrl.telemetry
    out = (np.asarray(ctrl.global_params["w"]),
           {k: tel.value(k) for k in ("engine.uploads.rejected.nonfinite",
                                      "engine.uploads.clipped", "channel.upload_messages",
                                      "channel.upload_bytes")})
    ctrl.shutdown()
    return out


@pytest.mark.parametrize("codec", ["raw", "int8"])
@pytest.mark.parametrize("store_mode", ["arena", "stack"])
@pytest.mark.parametrize("rule", ["median", "trimmed_mean"])
def test_robust_rules_conformance_both_packages(rule, store_mode, codec):
    common = dict(rule=rule, store_mode=store_mode, upload_codec=codec)
    jgot, jstats = _conformance_run(
        JController, _jlearner, _INIT, protocol=JSync(local_steps=2, batch_size=16), **common)
    tgot, tstats = _conformance_run(
        TController, _tlearner, tpack.tree_from_numpy(_INIT, "cpu"),
        protocol=TSync(local_steps=2, batch_size=16), device="cpu", **common)
    ref = _replay(rule)
    rtol, atol = (1e-5, 1e-6) if codec == "raw" else (0.02, 0.02)
    np.testing.assert_allclose(tgot, ref, rtol=rtol, atol=atol)
    np.testing.assert_allclose(tgot, jgot, rtol=rtol, atol=atol)
    assert tstats == jstats
    assert tstats["engine.uploads.rejected.nonfinite"] == tstats["engine.uploads.clipped"] == 0
    assert tstats["channel.upload_messages"] == _N * _ROUNDS


# ---------------------------------------------------------------------------
# the controller and the Driver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rule", ["median", "trimmed_mean"])
def test_driver_carries_trim_k_and_matches_reference(rule):
    seed, rounds, n = 0, 2, 6
    jinit = jmlp.init_params(jax.random.key(seed), housing_mlp.reduced())
    tinit = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jinit), "cpu")
    _, jlearners = jtrain.build_housing_learners("100k", n, seed)
    _, tlearners = ttrain.build_housing_learners("100k", n, seed, device="cpu")
    kw = dict(protocol="sync", local_steps=2, batch_size=32, learning_rate=0.01,
              aggregation_rule=rule, trim_k=2)
    jd = JDriver(JEnv(termination=JTerm(max_rounds=rounds), **kw))
    td = TDriver(TEnv(termination=TTerm(max_rounds=rounds), device="cpu", **kw))
    assert td.controller.trim_k == jd.controller.trim_k == 2
    assert td.controller.aggregation_rule == rule
    jd.initialize(jinit, jlearners)
    td.initialize(tinit, tlearners)
    assert len(td.run()) == len(jd.run()) == rounds
    np.testing.assert_allclose(np.asarray(td.controller.global_buffer),
                               np.asarray(jd.controller.global_buffer), rtol=1e-4, atol=1e-5)


def test_trim_k_changes_the_result():
    """trim_k=2 and trim_k=1 give different models: the knob is not dropped."""
    outs = []
    for trim_k in (1, 2):
        _, learners = ttrain.build_housing_learners("100k", 6, 0, device="cpu")
        init = tpack.tree_from_numpy(jax.tree_util.tree_map(
            np.asarray, jmlp.init_params(jax.random.key(0), housing_mlp.reduced())), "cpu")
        td = TDriver(TEnv(protocol="sync", local_steps=2, batch_size=32, device="cpu",
                          aggregation_rule="trimmed_mean", trim_k=trim_k,
                          termination=TTerm(max_rounds=1)))
        td.initialize(init, learners)
        td.run()
        outs.append(np.asarray(td.controller.global_buffer))
    assert not np.array_equal(outs[0], outs[1])


_REFUSALS = {
    "int8_arena": dict(arena_dtype="int8", aggregation_rule="trimmed_mean"),
    "custom_fn": dict(aggregation_rule="median", aggregate_fn=lambda s, w: s[0]),
    "custom_masked_fn": dict(aggregation_rule="trimmed_mean",
                             masked_aggregate_fn=lambda a, w, m: a[0]),
    "unknown_rule": dict(aggregation_rule="krum"),
    "trim_k_zero": dict(aggregation_rule="trimmed_mean", trim_k=0),
}


@pytest.mark.parametrize("case", sorted(_REFUSALS))
def test_controller_refusals_match_reference(case):
    with pytest.raises(ValueError) as jerr:
        JController(**_REFUSALS[case])
    with pytest.raises(ValueError) as terr:
        TController(device="cpu", **_REFUSALS[case])
    assert str(terr.value) == str(jerr.value)


def test_trim_k_against_arena_capacity_refused_like_reference():
    init = {"w": np.zeros((8,), np.float32)}
    jc = JController(aggregation_rule="trimmed_mean", trim_k=4, arena_n_max=8)
    tc = TController(aggregation_rule="trimmed_mean", trim_k=4, arena_n_max=8, device="cpu")
    with pytest.raises(ValueError) as jerr:
        jc.set_initial_model({"w": jnp.asarray(init["w"])})
    with pytest.raises(ValueError) as terr:
        tc.set_initial_model(tpack.tree_from_numpy(init, "cpu"))
    assert str(terr.value) == str(jerr.value)
    assert "every cohort would fall back" in str(terr.value)
    ok = TController(aggregation_rule="trimmed_mean", trim_k=3, arena_n_max=8, device="cpu")
    ok.set_initial_model(tpack.tree_from_numpy(init, "cpu"))
    assert ok.arena.n_max == 8
    for c in (jc, tc, ok):
        c.shutdown()


@pytest.mark.parametrize("name", ["masked_coordinate_median", "masked_trimmed_mean_torch",
                                  "trimmed_mean", "coordinate_median"])
def test_positive_nan_leaves_nan_free_results_unchanged(name, monkeypatch):
    """Making NaN positive before each robust sort changes nothing, bit for
    bit, on NaN-free rows (±0, ±inf and subnormals among them)."""
    rng = np.random.default_rng(11)
    rows = torch.from_numpy((rng.normal(size=(9, 2051)) * 3).astype(np.float32))
    rows[1, :40] = -0.0
    rows[2, 40:80] = float("inf")
    rows[3, 80:120] = -float("inf")
    rows[4, 120:160] = 1e-42
    mask = torch.ones(9)
    mask[[0, 6]] = 0.0
    calls = {
        "masked_coordinate_median": lambda: tagg.masked_coordinate_median(rows, mask, mask),
        "masked_trimmed_mean_torch": lambda: trobust.masked_trimmed_mean_torch(rows, mask, 2),
        "trimmed_mean": lambda: tagg.trimmed_mean(rows, 3),
        "coordinate_median": lambda: tagg.coordinate_median(rows),
    }
    assert torch.equal(trobust.positive_nan(rows).view(torch.int32), rows.view(torch.int32))
    got = calls[name]()
    monkeypatch.setattr(tagg, "positive_nan", lambda x: x)
    monkeypatch.setattr(trobust, "positive_nan", lambda x: x)
    want = calls[name]()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
