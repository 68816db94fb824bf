"""The five protocols beside sync, in both packages, and the engine's unit tests.

Federations: each policy of reference ``tests/test_conformance.py`` beside
sync (semi-sync, async, FedBuff, deadline cohorts, reputation) runs in both
packages from one init (the reduced housing MLP initialized by the reference
and carried across with ``packing.tree_from_numpy``) with learners from both
packages' ``build_housing_learners`` on the same seed, over
{arena, stack} × {raw, int8}, plus the int8 arena for the two continuous
policies.  One dispatch worker fixes the arrival order, and every learner
reports a fixed seconds per step (``SPS * (i + 1)``), so semi-sync sizing
and deadline prediction see the same profiles in both packages; the deadline
and reputation cases also run on a ``FaultyChannel`` (fault seed 7: a ``dup``
in round 0, a ``lost`` upload in rounds 0 and 1).  The global buffer must
agree after every update within rtol 1e-4 / atol 1e-5 (the two frameworks'
CPU BLAS kernels sum in different orders, ``tests/test_torch_slice.py``),
or on int8 legs the int8 bar of ``tests/test_torch_int8.py``; the dispatched
tasks, the aggregates' cohorts, the journal's staleness and the wire, store
and engine counters must be equal exactly.

Unit tests: the reference's engine tests that need no checkpoint and no
secure path (``tests/test_engine.py``) and the profile properties of
``tests/test_policy_props.py``, each run against both packages as the cases
of one parametrised test.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from hypothesis_compat import given, settings, st
from repro.configs import housing_mlp
from repro.launch import train as jtrain
from repro.models import mlp as jmlp
from repro.optim import sgd as jsgd
from repro_torch import optim as topt
from repro_torch.core import packing as tpack
from repro_torch.launch import train as ttrain
from test_torch_int8 import assert_within_q8_bar

SPS = 1e-3  # learner i reports SPS * (i + 1) seconds per step
FAULTS = dict(seed=7, upload_loss_rate=0.1, upload_dup_rate=0.1)
COUNTERS = (
    "channel.bytes_moved", "channel.messages", "channel.upload_bytes",
    "channel.upload_messages", "controller.dispatch_serializations",
    "controller.model_version", "engine.round_id", "engine.uploads.orphaned",
    "engine.uploads.quantized_direct", "controller.aggregations.fused_q8",
    "engine.faults.uploads_lost", "engine.faults.uploads_duplicated",
    "engine.faults.uploads_late", "engine.faults.deadline_fires",
    "store.arena.total_writes", "store.arena.bytes_ingested",
    "store.model.total_inserts", "store.model.bytes_ingested",
)

_CASES = {
    # hyper-period 5.5 ms against ~1 ms of modeled wire: 4, 2 and 1 steps
    # from round 1 on
    "semi_sync": dict(
        proto=lambda m: m.SemiSyncProtocol(hyperperiod_s=0.0055, batch_size=32,
                                           learning_rate=0.01, default_steps=2),
        n=3, rounds=2, updates=0,
    ),
    "async": dict(
        proto=lambda m: m.AsyncProtocol(local_steps=2, batch_size=32, learning_rate=0.01),
        n=3, rounds=0, updates=4,
    ),
    "buffered_async": dict(
        proto=lambda m: m.BufferedAsyncProtocol(buffer_k=3, local_steps=2, batch_size=32,
                                                learning_rate=0.01),
        n=4, rounds=0, updates=2,
    ),
    # predicted 3, 5, 7, ... ms against a 6 ms deadline: from round 1 on
    # only learners 0 and 1 and the unprofiled (lost) learner 4 are dispatched
    "deadline": dict(
        proto=lambda m: m.DeadlineCohortProtocol(deadline_s=0.006, local_steps=2,
                                                 batch_size=32, learning_rate=0.01,
                                                 enforce_wall_clock=False),
        n=6, rounds=2, updates=0, faults=True,
    ),
    # the top 5 of 6: learner 4 loses its round-0 upload, drops to the
    # bottom of the ranking and sits out rounds 1 and 2
    "reputation": dict(
        proto=lambda m: m.ReputationProtocol(fraction=0.75, local_steps=2, batch_size=32,
                                             learning_rate=0.01),
        n=6, rounds=3, updates=0, faults=True,
    ),
}


def _fixed_step_time(learner, sps):
    """Make the learner report ``sps`` seconds per step, whatever it took."""
    fit = learner.fit

    def fixed(params, task):
        update = fit(params, task)
        update.seconds_per_step = sps
        return update

    learner.fit = fixed
    return learner


def _federation(side, case, store_mode, codec, arena_dtype="f32"):
    m = J if side == "reference" else T
    dev = {} if side == "reference" else {"device": "cpu"}
    n = case["n"]
    init = jmlp.init_params(jax.random.key(0), housing_mlp.reduced())
    if side == "reference":
        _, learners = jtrain.build_housing_learners("100k", n, 0, optimizer=jsgd(0.01))
    else:
        _, learners = ttrain.build_housing_learners("100k", n, 0, optimizer=topt.sgd(0.01),
                                                    device="cpu")
        init = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, init), "cpu")
    channel = None
    if case.get("faults"):
        channel = m.FaultyChannel(m.FaultInjector(m.FaultSpec(**FAULTS)), **dev)
    ctrl = m.Controller(protocol=case["proto"](m), channel=channel, store_mode=store_mode,
                        upload_codec=codec, arena_dtype=arena_dtype, arena_n_max=n,
                        max_dispatch_workers=1, **dev)
    ctrl.set_initial_model(init)
    for i, learner in enumerate(learners):
        ctrl.register_learner(_fixed_step_time(learner, SPS * (i + 1)))
    commits = []
    commit = ctrl._commit

    def recording(new_buffer):
        commit(new_buffer)
        commits.append(np.array(ctrl.global_buffer))

    ctrl._commit = recording
    if case["updates"]:
        ctrl.engine.run(total_updates=case["updates"])
    else:
        for _ in range(case["rounds"]):
            ctrl.engine.run(rounds=1)
    log = list(ctrl.engine.event_log)
    events = {
        "dispatched": [(e.round_id, e.learner_id, e.task.local_steps) for e in log
                       if isinstance(e, m.Dispatched)],
        "fired": [(e.round_id, e.n_arrived, e.members) for e in log
                  if isinstance(e, m.AggregateFired)],
        "staleness": [r.get("staleness") for r in ctrl.journal.records()
                      if r.get("kind") == "upload"],
    }
    counters = {k: ctrl.telemetry.value(k) for k in COUNTERS}
    ctrl.shutdown()
    return commits, events, counters


def _hold(case, store_mode, codec, arena_dtype="f32"):
    jcommits, jevents, jcount = _federation("reference", case, store_mode, codec, arena_dtype)
    tcommits, tevents, tcount = _federation("port", case, store_mode, codec, arena_dtype)
    assert tevents == jevents
    assert tcount == jcount
    assert len(tcommits) == len(jcommits) >= max(case["rounds"], case["updates"])
    for u, (got, want) in enumerate(zip(tcommits, jcommits)):
        if codec == "int8":
            assert_within_q8_bar(got, want, what=f"update {u}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"update {u}")
        assert np.isfinite(got).all()
    return tevents, tcount


@pytest.mark.parametrize("codec", ["raw", "int8"])
@pytest.mark.parametrize("store_mode", ["arena", "stack"])
@pytest.mark.parametrize("proto", list(_CASES))
def test_protocol_matches_reference(proto, store_mode, codec):
    case = _CASES[proto]
    events, counters = _hold(case, store_mode, codec)
    steps = {s for _, _, s in events["dispatched"]}
    if proto == "semi_sync":
        assert steps == {2, 4, 1}  # default steps, then sized from the profiles
    if proto in ("async", "buffered_async"):
        assert max(events["staleness"]) > 0
    if proto == "buffered_async":
        assert all(len(members) == 3 for _, _, members in events["fired"])
    if proto == "deadline":
        late_rounds = {lid for r, lid, _ in events["dispatched"] if r == 1}
        assert late_rounds == {"learner_000", "learner_001", "learner_004"}
    if proto == "reputation":
        later = {lid for r, lid, _ in events["dispatched"] if r > 0}
        assert "learner_004" not in later and len(later) == 5
    if case.get("faults"):
        assert counters["engine.faults.uploads_lost"] > 0
        assert counters["engine.faults.uploads_duplicated"] > 0


@pytest.mark.parametrize("proto", ["async", "buffered_async"])
def test_continuous_protocol_on_int8_arena_matches_reference(proto):
    _, counters = _hold(_CASES[proto], "arena", "int8", arena_dtype="int8")
    assert counters["controller.aggregations.fused_q8"] == counters["controller.model_version"]
    assert counters["engine.uploads.quantized_direct"] == counters["channel.upload_messages"]


# ---------------------------------------------------------------------------
# the reference's engine unit tests, against both packages
# ---------------------------------------------------------------------------


def _toy_learner(side, i):
    """The reference tests' linear-regression learner, in either package."""
    rng = np.random.default_rng(i)
    X = rng.normal(size=(64, 4)).astype(np.float32)
    y = X @ np.ones((4, 1), np.float32)
    if side == "reference":
        def loss_fn(p, b):
            return jnp.mean((b[0] @ p["w"] - b[1]) ** 2)

        def data_fn(bs):
            j = rng.integers(0, 64, size=bs)
            return X[j], y[j]

        return J.Learner(f"l{i}", loss_fn, lambda p, b: {"eval_loss": loss_fn(p, b)},
                         data_fn, lambda: (X, y), jsgd(0.05), 64)
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)

    def tloss(p, b):
        return torch.mean((b[0] @ p["w"] - b[1]) ** 2)

    def tdata(bs):
        j = torch.from_numpy(rng.integers(0, 64, size=bs))
        return tX[j], ty[j]

    return T.Learner(f"l{i}", tloss, lambda p, b: {"eval_loss": tloss(p, b)},
                     tdata, lambda: (tX, ty), topt.sgd(0.05), 64, device="cpu")


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """One package's surface, so each unit test runs against both."""
    side = request.param
    if side == "reference":
        m, dev, arr = J, {}, jnp.asarray
    else:
        m, dev, arr = T, {"device": "cpu"}, torch.as_tensor
    ns = types.SimpleNamespace(**{k: getattr(m, k) for k in m.__all__ if hasattr(m, k)})
    ns.side = side
    ns.Controller = functools.partial(m.Controller, **dev)
    ns.Channel = functools.partial(m.Channel, **dev)
    ns.FaultyChannel = functools.partial(m.FaultyChannel, **dev)
    ns.learner = functools.partial(_toy_learner, side)
    ns.zeros = lambda shape: arr(np.zeros(shape, np.float32))
    ns.full = lambda n, v: arr(np.full((n,), v, np.float32))
    return ns


def _w(ctrl):
    return np.asarray(ctrl.global_params["w"])


def test_engine_run_argument_contract(pkg):
    ctrl = pkg.Controller(protocol=pkg.SyncProtocol())
    ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
    with pytest.raises(TypeError):
        ctrl.engine.run()  # round-based needs rounds=
    with pytest.raises(TypeError):
        ctrl.engine.run(total_updates=3)  # sync is not continuous
    ctrl.shutdown()
    actrl = pkg.Controller(protocol=pkg.AsyncProtocol())
    actrl.set_initial_model({"w": pkg.zeros((4, 1))})
    with pytest.raises(TypeError):
        actrl.engine.run(rounds=2)  # continuous needs total_updates=
    assert actrl.engine.run(total_updates=0) == []
    actrl.shutdown()


@pytest.mark.parametrize("name", ["SyncProtocol", "SemiSyncProtocol", "AsyncProtocol",
                                  "BufferedAsyncProtocol", "DeadlineCohortProtocol",
                                  "ReputationProtocol"])
def test_prox_mu_reaches_train_task(pkg, name):
    proto = getattr(pkg, name)(prox_mu=0.25)
    assert proto.size_task(0, {}).prox_mu == 0.25
    assert proto.make_task(0, {}).prox_mu == 0.25  # the legacy alias


@pytest.mark.parametrize("name", ["sync", "semi_sync", "async", "buffered_async",
                                  "deadline", "reputation"])
def test_prox_mu_plumbed_through_federation_env(pkg, name):
    env = pkg.FederationEnv(protocol=name, prox_mu=0.125)
    assert env.make_protocol().size_task(0, {}).prox_mu == 0.125
    assert pkg.FederationEnv(protocol=name).make_protocol().size_task(0, {}).prox_mu == 0.0


def test_prox_mu_federation_runs_and_stays_finite(pkg):
    ctrl = pkg.Controller(protocol=pkg.SyncProtocol(local_steps=2, batch_size=16, prox_mu=0.1))
    ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
    for i in range(2):
        ctrl.register_learner(pkg.learner(i))
    ctrl.engine.run(rounds=2)
    ctrl.shutdown()
    assert np.isfinite(_w(ctrl)).all()
    tasks = [e.task for e in ctrl.engine.event_log if isinstance(e, pkg.Dispatched)]
    assert tasks and all(t.prox_mu == 0.1 for t in tasks)


def test_semi_sync_wire_aware_subtracts_wire_time(pkg):
    proto = pkg.SemiSyncProtocol(hyperperiod_s=1.0, default_steps=2)
    prof = {"seconds_per_step": 0.01}
    assert proto.size_task(0, prof, wire_s=0.0).local_steps == 100
    assert proto.size_task(0, prof, wire_s=0.5).local_steps == 50
    naive = pkg.SemiSyncProtocol(hyperperiod_s=1.0, wire_aware=False)
    assert naive.size_task(0, prof, wire_s=0.5).local_steps == 100
    assert proto.size_task(0, prof, wire_s=2.0).local_steps == 1
    assert proto.size_task(0, {}, wire_s=0.5).local_steps == 2


def test_semi_sync_budget_covers_train_plus_wire(pkg):
    rng = np.random.default_rng(1)
    proto = pkg.SemiSyncProtocol(hyperperiod_s=1.0)
    for _ in range(200):
        sps = float(rng.uniform(1e-4, 0.2))
        wire = float(rng.uniform(0.0, 0.9))
        steps = proto.size_task(0, {"seconds_per_step": sps}, wire_s=wire).local_steps
        if proto.hyperperiod_s - wire >= sps:
            assert steps * sps + wire <= proto.hyperperiod_s + 1e-9


def test_controller_wire_time_estimate_matches_channel_model(pkg):
    ch = pkg.Channel(bandwidth_gbps=0.1, latency_ms=1.0)
    ctrl = pkg.Controller(protocol=pkg.SemiSyncProtocol(hyperperiod_s=0.05, batch_size=8),
                          channel=ch)
    ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
    ctrl.register_learner(pkg.learner(0))
    down = ctrl.manifest.total_bytes
    up = 4 * ctrl.arena.padded_params
    assert ctrl.wire_time_s("l0") == pytest.approx(ch.round_trip_s(down, up))
    assert ctrl.wire_time_s("l0") == pytest.approx(2 * 1e-3 + (down + up) * 8 / 0.1e9)
    ctrl.engine.run(rounds=1)
    ctrl.shutdown()
    assert ctrl._learner_profiles["l0"]["upload_bytes"] == up
    assert ctrl.wire_time_s("l0") == pytest.approx(ch.round_trip_s(down, up))


def test_wire_aware_sizing_shapes_real_rounds(pkg):
    def run(wire_aware):
        ctrl = pkg.Controller(
            protocol=pkg.SemiSyncProtocol(hyperperiod_s=0.1, batch_size=8, default_steps=1,
                                          wire_aware=wire_aware),
            channel=pkg.Channel(bandwidth_gbps=0.0005, latency_ms=5.0),
        )
        ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
        ctrl.register_learner(_fixed_step_time(pkg.learner(0), 1e-3))
        ctrl.engine.run(rounds=3)
        steps = [e.task.local_steps for e in ctrl.engine.event_log
                 if isinstance(e, pkg.Dispatched)]
        wire = ctrl.wire_time_s("l0")
        ctrl.shutdown()
        return steps, wire

    aware_steps, wire = run(True)
    naive_steps, _ = run(False)
    assert wire > 0.05
    assert aware_steps[0] == naive_steps[0] == 1
    assert naive_steps[-1] == 100
    assert aware_steps[-1] == int((0.1 - wire) / 1e-3)
    assert aware_steps[-1] * 1e-3 + wire <= 0.1
    assert naive_steps[-1] * 1e-3 + wire > 0.1


def test_custom_policy_weighting_hook_is_consulted(pkg):
    """A round-based policy declaring "staleness" gets the community
    aggregate (every valid stored model), not the cohort-masked FedAvg."""

    class StaleSync(pkg.SyncProtocol):
        def weighting(self):
            return "staleness"

    def run(proto):
        ctrl = pkg.Controller(protocol=proto)
        ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
        for i in range(2):
            ctrl.register_learner(pkg.learner(i))
        ctrl.arena.write("ghost", pkg.full(ctrl.arena.padded_params, 123.0),
                         weight=1e9, version=0.0)
        ctrl.engine.run(rounds=1)
        ctrl.shutdown()
        return _w(ctrl)

    np.testing.assert_allclose(run(StaleSync(local_steps=1, batch_size=8)), 123.0, rtol=1e-3)
    assert np.abs(run(pkg.SyncProtocol(local_steps=1, batch_size=8))).max() < 10


class _Dropping:
    """Wraps a learner so that fit() deregisters it mid-round (orphan path)."""

    def __init__(self, inner, controller):
        self._inner, self._ctrl = inner, controller
        self.learner_id, self.num_examples = inner.learner_id, inner.num_examples

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def fit(self, params, task):
        update = self._inner.fit(params, task)
        self._ctrl.deregister_learner(self.learner_id)
        return update


@pytest.mark.parametrize("store_mode", ["arena", "stack"])
def test_mid_round_dropout_upload_is_orphaned_not_fatal(pkg, store_mode):
    ctrl = pkg.Controller(protocol=pkg.SyncProtocol(local_steps=2, batch_size=16),
                          store_mode=store_mode, max_dispatch_workers=1)
    ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
    ctrl.register_learner(pkg.learner(0))
    ctrl.register_learner(_Dropping(pkg.learner(1), ctrl))
    ctrl.register_learner(pkg.learner(2))
    assert len(ctrl.engine.run(rounds=1)) == 1
    assert ctrl.telemetry.value("engine.uploads.orphaned") == 1
    assert ctrl.telemetry.value("engine.faults.dropouts") == 1
    assert "l1" not in ctrl._learners
    assert np.isfinite(_w(ctrl)).all()
    assert len(ctrl.engine.run(rounds=1)) == 1  # the survivors keep federating
    ctrl.shutdown()


def test_every_learner_dropping_mid_round_raises(pkg):
    ctrl = pkg.Controller(protocol=pkg.SyncProtocol(local_steps=2, batch_size=16),
                          max_dispatch_workers=1)
    ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
    ctrl.register_learner(_Dropping(pkg.learner(0), ctrl))
    with pytest.raises(RuntimeError, match="dropped out"):
        ctrl.engine.run(rounds=1)
    ctrl.shutdown()


class _ScriptedInjector:
    """Scripted upload fates keyed by ``(learner_id, round_id)`` or ``learner_id``."""

    def __init__(self, fates):
        self.fates = dict(fates)

    def upload_fate(self, lid, rid):
        return self.fates.get((lid, int(rid))) or self.fates.get(lid, "ok")


def _faulty_controller(pkg, protocol, fates):
    ctrl = pkg.Controller(protocol=protocol, channel=pkg.FaultyChannel(_ScriptedInjector(fates)),
                          max_dispatch_workers=1)
    ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
    for i in range(2):
        ctrl.register_learner(pkg.learner(i))
    return ctrl


def test_dup_completing_quorum_is_not_counted_late(pkg):
    ctrl = _faulty_controller(pkg, pkg.SyncProtocol(local_steps=1, batch_size=16), {"l1": "dup"})
    assert len(ctrl.engine.run(rounds=2)) == 2
    assert ctrl.telemetry.value("engine.faults.uploads_duplicated") == 2
    assert ctrl.telemetry.value("engine.faults.uploads_late") == 0
    assert ctrl.engine._late_carry == []
    ctrl.shutdown()


def test_dup_completing_buffer_leaves_no_phantom_member(pkg):
    ctrl = _faulty_controller(
        pkg, pkg.BufferedAsyncProtocol(buffer_k=2, local_steps=1, batch_size=16), {"l1": "dup"})
    ctrl.engine.run(total_updates=2)
    assert ctrl.engine._buffer == []
    fired = [e for e in ctrl.engine.event_log if isinstance(e, pkg.AggregateFired)]
    assert len(fired) == 2 and all(e.members == ("l0", "l1") for e in fired)
    assert ctrl.telemetry.value("engine.faults.uploads_duplicated") == 2
    ctrl.shutdown()


def test_lost_upload_retries_a_continuous_leg(pkg):
    """Without a checkpoint drain a lost continuous upload is re-dispatched
    at once: the learner stays in the rotation."""
    ctrl = _faulty_controller(
        pkg, pkg.BufferedAsyncProtocol(buffer_k=1, local_steps=1, batch_size=16),
        {("l1", 0): "lost"})
    ctrl.engine.run(total_updates=3)
    assert ctrl.telemetry.value("engine.faults.uploads_lost") == 1
    legs = [e for e in ctrl.engine.event_log
            if isinstance(e, pkg.Dispatched) and e.learner_id == "l1"]
    assert len(legs) >= 2 and ctrl.engine._retry_pending == []
    ctrl.shutdown()


def test_rejoin_preserves_profile_and_decays_reputation(pkg):
    ctrl = pkg.Controller(protocol=pkg.SyncProtocol(local_steps=2, batch_size=16))
    ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
    for i in range(2):
        ctrl.register_learner(pkg.learner(i))
    ctrl.engine.run(rounds=1)
    prof = ctrl._learner_profiles["l0"]
    rep_before, obs_before = prof.reputation(), prof.observations
    assert rep_before > 0
    ctrl.deregister_learner("l0")
    ctrl.engine.run(rounds=2)  # two rounds absent
    ctrl.register_learner(pkg.learner(0))
    assert ctrl._learner_profiles["l0"] is prof
    assert prof.observations == obs_before
    assert prof.reputation() == pytest.approx(rep_before * 0.9**2)
    assert ctrl.telemetry.value("engine.faults.rejoins") == 1
    ctrl.engine.run(rounds=1)
    ctrl.shutdown()


@pytest.mark.parametrize("timer", ["fires", "cancelled"])
def test_deadline_timer_partial_round_and_late_carry(pkg, timer):
    """A wall-clock deadline aggregates what arrived and the straggler's
    upload is counted late and carried to the next round's reduce; a round
    that completes first cancels its timer."""
    import threading

    gate = threading.Event()

    class _Slow:
        def __init__(self, inner):
            self._inner = inner
            self.learner_id, self.num_examples = inner.learner_id, inner.num_examples

        def __getattr__(self, name):
            return getattr(self._inner, name)

        def fit(self, params, task):
            if task.round_id == 0:
                gate.wait(timeout=30)
            return self._inner.fit(params, task)

    deadline = 2.0 if timer == "fires" else 30.0
    ctrl = pkg.Controller(protocol=pkg.DeadlineCohortProtocol(
        deadline_s=deadline, local_steps=1, batch_size=16), max_dispatch_workers=2)
    ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
    ctrl.register_learner(pkg.learner(0))
    ctrl.register_learner(_Slow(pkg.learner(1)))
    release = threading.Timer(3.0 if timer == "fires" else 0.0, gate.set)
    release.start()
    ctrl.engine.run(rounds=1)
    late_carry = list(ctrl.engine._late_carry)
    ctrl.engine.run(rounds=1)
    fired = [e for e in ctrl.engine.event_log if isinstance(e, pkg.AggregateFired)]
    late = ctrl.telemetry.value("engine.faults.uploads_late")
    if timer == "fires":
        assert ctrl.telemetry.value("engine.faults.deadline_fires") == 1
        assert [e.n_arrived for e in fired] == [1, 2] and late == 1
        assert late_carry == ["l1"]
        assert any(isinstance(e, pkg.DeadlineExpired) for e in ctrl.engine.event_log)
    else:
        assert ctrl.telemetry.value("engine.faults.deadline_fires") == 0
        assert [e.n_arrived for e in fired] == [2, 2] and late == 0 and late_carry == []
    assert ctrl.engine._late_carry == []  # consumed by round 1's reduce
    assert np.isfinite(_w(ctrl)).all()
    ctrl.shutdown()


# ---------------------------------------------------------------------------
# reputation / EWMA profile properties (tests/test_policy_props.py)
# ---------------------------------------------------------------------------

_PROFILES = pytest.mark.parametrize("profile", [J.LearnerProfile, T.LearnerProfile],
                                    ids=["reference", "port"])


@_PROFILES
@settings(max_examples=50, deadline=None)
@given(decay=st.floats(min_value=0.0, max_value=0.99),
       scores=st.lists(st.floats(min_value=0.0, max_value=1.0), min_size=1, max_size=20))
def test_reputation_stays_inside_observed_range(profile, decay, scores):
    prof = profile(decay=decay)
    for s in scores:
        est = prof.observe_contribution(s)
        assert min(scores) - 1e-9 <= est <= max(scores) + 1e-9
    assert prof.rep_observations == len(scores)


@_PROFILES
@settings(max_examples=50, deadline=None)
@given(decay=st.floats(min_value=0.0, max_value=0.99),
       start=st.floats(min_value=0.0, max_value=1.0),
       target=st.floats(min_value=0.0, max_value=1.0),
       n=st.integers(min_value=1, max_value=30))
def test_repeated_observation_converges_monotonically(profile, decay, start, target, n):
    prof = profile(decay=decay)
    prof.observe_contribution(start)
    gap = abs(prof.reputation() - target)
    for _ in range(n):
        prof.observe_contribution(target)
        new_gap = abs(prof.reputation() - target)
        assert new_gap <= gap + 1e-9
        gap = new_gap
    assert gap <= abs(start - target) * decay**n + 1e-6


@_PROFILES
@settings(max_examples=50, deadline=None)
@given(scores=st.lists(st.floats(min_value=0.0, max_value=1.0), min_size=1, max_size=20))
def test_decay_zero_is_legacy_last_sample(profile, scores):
    prof = profile(decay=0.0)
    for s in scores:
        prof.observe_contribution(s)
        assert prof.reputation() == pytest.approx(s)


@_PROFILES
@settings(max_examples=50, deadline=None)
@given(n=st.integers(min_value=1, max_value=10), decay=st.floats(min_value=0.0, max_value=0.99))
def test_zero_observations_never_produce_nan(profile, n, decay):
    prof = profile(decay=decay)
    for _ in range(n):
        prof.observe_step_time(0.0)
        prof.observe_contribution(0.0)
    assert np.isfinite(prof.reputation()) and prof.reputation() == 0.0
    assert np.isfinite(float(prof["seconds_per_step"]))


@_PROFILES
@settings(max_examples=50, deadline=None)
@given(rep=st.floats(min_value=0.0, max_value=1.0),
       absent=st.integers(min_value=0, max_value=20),
       rate=st.floats(min_value=0.1, max_value=0.99))
def test_decay_reputation_algebra(profile, rep, absent, rate):
    prof = profile(decay=0.5)
    prof.observe_contribution(rep)
    out = prof.decay_reputation(absent, rate=rate)
    assert out == pytest.approx(rep * rate**absent) and np.isfinite(out)
    assert prof.decay_reputation(0, rate=rate) == pytest.approx(out)


@_PROFILES
def test_decay_reputation_on_unobserved_profile_is_default(profile):
    prof = profile(decay=0.5)
    assert prof.decay_reputation(5) == 1.0
    assert prof.reputation() == 1.0 and prof.rep_observations == 0


@_PROFILES
@settings(max_examples=30, deadline=None)
@given(a=st.floats(min_value=0.0, max_value=1.0), b=st.floats(min_value=0.0, max_value=1.0),
       decay=st.floats(min_value=0.0, max_value=0.99))
def test_first_observation_seeds_the_estimate(profile, a, b, decay):
    prof = profile(decay=decay)
    assert prof.observe_contribution(a) == pytest.approx(a)
    assert prof.observe_contribution(b) == pytest.approx(decay * a + (1.0 - decay) * b)
