"""Fault injection in both packages: decisions, corrupted bytes, federations.

Every ``FaultInjector`` decision is a numpy generator keyed by
``(seed, crc32(key))``, so the port's decisions must equal the reference's
for the same spec and ids, and the corrupted upload bytes must be identical.
A byzantine federation (the reduced housing MLP, 16 learners, 3 sync rounds,
fault seed 7: learners 006, 007, 008, 010, 012 and 014 byzantine under
``scale`` and ``sign_flip``) runs in both packages from one carried-across
init under each robust rule.  ``max_dispatch_workers=1`` fixes the arrival
order, which feeds the admission screen's EWMA, so the clipped, rejected and
quarantine counters must agree exactly; the global buffer within
rtol 1e-4 / atol 1e-5 (the two frameworks' CPU BLAS kernels sum in different
orders, ``tests/test_torch_slice.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import housing_mlp
from repro.core import faults as jfaults
from repro.core.controller import Controller as JController
from repro.core.metrics import Telemetry as JTelemetry
from repro.core.scheduler import SyncProtocol as JSync
from repro.launch import train as jtrain
from repro.models import mlp as jmlp
from repro.optim import sgd as jsgd
from repro_torch import optim as topt
from repro_torch.core import faults as tfaults
from repro_torch.core import packing as tpack
from repro_torch.core.controller import Controller as TController
from repro_torch.core.metrics import Telemetry
from repro_torch.core.scheduler import SyncProtocol as TSync
from repro_torch.launch import train as ttrain

_SPECS = {
    "everything": dict(seed=3, dropout_rate=0.2, rejoin_rate=0.5, upload_loss_rate=0.1,
                       upload_dup_rate=0.15, straggler_rate=0.3, straggler_tail=1.2,
                       bandwidth_min_gbps=0.1, bandwidth_max_gbps=20.0, min_active=5,
                       adversarial_fraction=0.25,
                       adversarial_fates=("nan", "scale", "sign_flip", "garbage")),
    "byzantine": dict(seed=7, adversarial_fraction=0.15,
                      adversarial_fates=("scale", "sign_flip")),
    "one_fate": dict(seed=123456789, adversarial_fraction=0.5, adversarial_fates=("nan",),
                     straggler_rate=1.0),
}
_IDS = [f"learner_{i:03d}" for i in range(200)]


def _decisions(mod, spec):
    inj = mod.FaultInjector(mod.FaultSpec(**spec))
    out = {
        "straggler": [inj.is_straggler(lid) for lid in _IDS],
        "bandwidth": [inj.bandwidth_cap(lid) for lid in _IDS],
        "adversary": [inj.is_adversarial(lid) for lid in _IDS],
    }
    for r in range(4):
        out[f"step_time_{r}"] = [inj.step_time(lid, r) for lid in _IDS]
        out[f"fate_{r}"] = [inj.upload_fate(lid, r) for lid in _IDS]
        out[f"advfate_{r}"] = [inj.adversarial_fate(lid, r) for lid in _IDS]
    active = list(_IDS[:60])
    for r in range(6):
        leave, rejoin = inj.churn(r, active)
        out[f"churn_{r}"] = (leave, rejoin)
        active = [lid for lid in active if lid not in leave] + rejoin
    return out


@pytest.mark.parametrize("name", sorted(_SPECS))
def test_injector_decisions_equal_reference(name):
    want = _decisions(jfaults, _SPECS[name])
    got = _decisions(tfaults, _SPECS[name])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert any(want["adversary"])


def test_straggler_counter_counts_like_reference():
    counts = []
    for mod, telemetry in ((jfaults, JTelemetry()), (tfaults, Telemetry())):
        inj = mod.FaultInjector(mod.FaultSpec(seed=5, straggler_rate=0.4), telemetry=telemetry)
        for lid in _IDS[:50]:
            inj.step_time(lid, 0)
        counts.append(telemetry.value("engine.faults.stragglers"))
    assert counts[0] == counts[1] > 0


_BAD_SPECS = [
    dict(dropout_rate=1.5), dict(upload_loss_rate=0.6, upload_dup_rate=0.6),
    dict(straggler_tail=0.0), dict(bandwidth_min_gbps=1.0),
    dict(bandwidth_min_gbps=5.0, bandwidth_max_gbps=1.0), dict(min_active=0),
    dict(adversarial_fraction=0.1, adversarial_fates=()),
    dict(adversarial_fraction=0.1, adversarial_fates=("flip",)),
    dict(adversarial_scale=0.0),
]


@pytest.mark.parametrize("i", range(len(_BAD_SPECS)))
def test_spec_validation_matches_reference(i):
    with pytest.raises(ValueError) as jerr:
        jfaults.FaultSpec(**_BAD_SPECS[i])
    with pytest.raises(ValueError) as terr:
        tfaults.FaultSpec(**_BAD_SPECS[i])
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("fate", tfaults.ADVERSARIAL_FATES)
def test_corrupt_is_byte_identical(fate):
    assert tfaults.ADVERSARIAL_FATES == jfaults.ADVERSARIAL_FATES
    spec = dict(seed=9, adversarial_fraction=1.0, adversarial_scale=37.5)
    row = (np.random.default_rng(4).normal(size=3072) * 2).astype(np.float32)
    want = jfaults.FaultInjector(jfaults.FaultSpec(**spec)).corrupt(
        jnp.asarray(row), fate, "learner_004", 2)
    buf = torch.from_numpy(row.copy())
    got = tfaults.FaultInjector(tfaults.FaultSpec(**spec)).corrupt(buf, fate, "learner_004", 2)
    assert got.dtype == torch.float32 and got.device == buf.device
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  np.asarray(want, np.float32).view(np.uint32))
    np.testing.assert_array_equal(buf.numpy(), row)  # the learner's buffer is untouched


def test_faulty_channel_stamps_and_counts_like_reference():
    spec = dict(seed=7, adversarial_fraction=0.15, adversarial_fates=("scale", "sign_flip"))
    jch = jfaults.FaultyChannel(jfaults.FaultInjector(jfaults.FaultSpec(**spec)))
    tch = tfaults.FaultyChannel(tfaults.FaultInjector(tfaults.FaultSpec(**spec)), device="cpu")
    row = np.linspace(-1, 1, 1024, dtype=np.float32)
    for r in range(3):
        for lid in _IDS[:32]:
            md = {"learner_id": lid, "round_id": r}
            je = jch.upload(jnp.asarray(row), metadata=md)
            te = tch.upload(torch.from_numpy(row), metadata=md)
            assert te.metadata == je.metadata
            np.testing.assert_array_equal(np.asarray(te.payload), np.asarray(je.payload))
    for fate in tfaults.ADVERSARIAL_FATES:
        name = f"engine.faults.adversarial.{fate}"
        assert tch.telemetry.value(name) == jch.telemetry.value(name), name
    assert tch.telemetry.value("engine.faults.adversarial.scale") > 0
    assert tch.telemetry.value("engine.faults.adversarial.sign_flip") > 0


# ---------------------------------------------------------------------------
# byzantine federations in both packages
# ---------------------------------------------------------------------------

_FED_SPEC = dict(seed=7, adversarial_fraction=0.15, adversarial_fates=("scale", "sign_flip"))
_COUNTERS = ("engine.faults.adversarial.scale", "engine.faults.adversarial.sign_flip",
             "engine.faults.adversarial.nan", "engine.faults.adversarial.garbage",
             "engine.uploads.clipped", "engine.uploads.rejected.nonfinite",
             "engine.quarantine.entered", "engine.quarantine.active",
             "channel.upload_messages", "channel.upload_bytes")


def _byzantine_run(side, rule, n=16, rounds=3, trim_k=6, spec=_FED_SPEC):
    jinit = jmlp.init_params(jax.random.key(0), housing_mlp.reduced())
    if side == "reference":
        _, learners = jtrain.build_housing_learners("100k", n, 0, optimizer=jsgd(0.01))
        ctrl = JController(
            protocol=JSync(2, 32, 0.01),
            channel=jfaults.FaultyChannel(jfaults.FaultInjector(jfaults.FaultSpec(**spec))),
            aggregation_rule=rule, trim_k=trim_k, arena_n_max=n, max_dispatch_workers=1)
        init = jinit
    else:
        _, learners = ttrain.build_housing_learners("100k", n, 0, optimizer=topt.sgd(0.01),
                                                    device="cpu")
        ctrl = TController(
            protocol=TSync(2, 32, 0.01),
            channel=tfaults.FaultyChannel(
                tfaults.FaultInjector(tfaults.FaultSpec(**spec)), device="cpu"),
            aggregation_rule=rule, trim_k=trim_k, arena_n_max=n, max_dispatch_workers=1,
            device="cpu")
        init = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jinit), "cpu")
    ctrl.set_initial_model(init)
    for learner in learners:
        ctrl.register_learner(learner)
    buffers = []
    for _ in range(rounds):
        ctrl.engine.run(rounds=1)
        buffers.append(np.asarray(ctrl.global_buffer))
    counters = {k: ctrl.telemetry.value(k) for k in _COUNTERS}
    ctrl.shutdown()
    return buffers, counters


@pytest.mark.parametrize("rule", ["median", "trimmed_mean"])
def test_byzantine_federation_matches_reference(rule):
    jbufs, jcount = _byzantine_run("reference", rule)
    tbufs, tcount = _byzantine_run("port", rule)
    for r, (got, want) in enumerate(zip(tbufs, jbufs)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"round {r}")
        assert np.isfinite(got).all()
    assert tcount == jcount
    assert tcount["engine.faults.adversarial.scale"] > 0
    assert tcount["engine.faults.adversarial.sign_flip"] > 0
    assert 0 < tcount["engine.uploads.clipped"] <= tcount["engine.faults.adversarial.scale"]


def test_every_adversarial_fate_in_a_federation_matches_reference():
    """NaN uploads are rejected and garbage is ingested, alike in both."""
    spec = dict(seed=0, adversarial_fraction=0.4, adversarial_fates=tfaults.ADVERSARIAL_FATES)
    kw = dict(rule="trimmed_mean", n=8, rounds=2, trim_k=3, spec=spec)
    jbufs, jcount = _byzantine_run("reference", **kw)
    tbufs, tcount = _byzantine_run("port", **kw)
    for r, (got, want) in enumerate(zip(tbufs, jbufs)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"round {r}")
    assert tcount == jcount
    assert tcount["engine.uploads.rejected.nonfinite"] == tcount["engine.faults.adversarial.nan"]
    assert all(tcount[f"engine.faults.adversarial.{f}"] > 0 for f in tfaults.ADVERSARIAL_FATES)


def _fate_controller(side, fate):
    rate = {"upload_loss_rate": 1.0} if fate == "lost" else {"upload_dup_rate": 1.0}
    init = jmlp.init_params(jax.random.key(0), housing_mlp.reduced())
    if side == "reference":
        _, learners = jtrain.build_housing_learners("100k", 2, 0)
        ctrl = JController(protocol=JSync(1, 8, 0.01), max_dispatch_workers=1,
                           channel=jfaults.FaultyChannel(
                               jfaults.FaultInjector(jfaults.FaultSpec(seed=1, **rate))))
    else:
        _, learners = ttrain.build_housing_learners("100k", 2, 0, device="cpu")
        ctrl = TController(protocol=TSync(1, 8, 0.01), max_dispatch_workers=1, device="cpu",
                           channel=tfaults.FaultyChannel(
                               tfaults.FaultInjector(tfaults.FaultSpec(seed=1, **rate)),
                               device="cpu"))
        init = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, init), "cpu")
    ctrl.set_initial_model(init)
    for learner in learners:
        ctrl.register_learner(learner)
    return ctrl


@pytest.mark.parametrize("fate", ["lost", "dup"])
def test_transport_fault_fate_is_refused_not_ingested(fate):
    """The engine enacts the fates as the reference does: a lost upload is
    never ingested (a cohort that loses every upload fails the round), a
    duplicated one is ingested again into its own row and counted once
    toward the quorum."""
    out = {}
    for side in ("reference", "port"):
        ctrl = _fate_controller(side, fate)
        if fate == "lost":
            with pytest.raises(RuntimeError, match="dropped out"):
                ctrl.engine.run(rounds=1)
        else:
            (t,) = ctrl.engine.run(rounds=1)
            assert np.isfinite(t.metrics["eval_loss"])
        fired = [e.n_arrived for e in ctrl.engine.event_log if type(e).__name__ == "AggregateFired"]
        out[side] = (ctrl.arena.total_writes, fired, np.asarray(ctrl.global_buffer),
                     {k: ctrl.telemetry.value(k) for k in (
                         "engine.faults.uploads_lost", "engine.faults.uploads_duplicated",
                         "engine.faults.uploads_late", "channel.upload_messages")})
        ctrl.shutdown()
    (tw, tfired, tbuf, tcount), (jw, jfired, jbuf, jcount) = out["port"], out["reference"]
    assert (tw, tfired, tcount) == (jw, jfired, jcount)
    np.testing.assert_allclose(tbuf, jbuf, rtol=1e-4, atol=1e-5)
    if fate == "lost":
        assert tw == 0 and tfired == [] and tcount["engine.faults.uploads_lost"] == 2
    else:
        assert tw == 4 and tfired == [2] and tcount["engine.faults.uploads_duplicated"] == 2
