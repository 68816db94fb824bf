"""Checkpoint and resume, in both packages: kill-and-resume bit-identity.

The reference's ``tests/test_checkpoint_resume.py`` (its two top-k tests
among them), its engine test of a learner lost
during the pre-checkpoint drain (``tests/test_engine.py``) and its
checkpoint-file tests (``tests/test_infra.py``), each run as the cases of one
parametrised test against the reference and against the port
(``device="cpu"``).  A federation killed at a checkpointed boundary and
resumed on a fresh controller, with fresh learners, must end with a global
model bit-identical to the uninterrupted run, within each package, across
the protocol × store grid, the robust rules, admission and quarantine,
FedBuff mid-buffer, the int8 arena, secure sync and the top-k uplink (the
learners' error-feedback residuals and the sparse arena's indices ride the
checkpoint).  The harness supplies
the reference's determinism conditions: constant batches, a fixed
``seconds_per_step``, async at one learner, FedBuff at one dispatch worker.

Across the packages, one federation checkpointed in both must write the
same ``.npz`` keys and the same meta counters, with global models within
rtol 1e-4 / atol 1e-5 (the two frameworks' CPU kernels sum in different
orders, ``tests/test_torch_slice.py``).
"""

import functools
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.checkpoint import checkpoint as jckpt
from repro.core import transport as jtransport
from repro.optim import sgd as jsgd
from repro_torch import optim as topt
from repro_torch.checkpoint import checkpoint as tckpt
from repro_torch.core import transport as ttransport
from test_torch_protocols import _ScriptedInjector, _toy_learner


@pytest.fixture(params=["reference", "port"])
def pkg(request):
    """One package's surface (controller, learners, checkpoint files)."""
    side = request.param
    m = J if side == "reference" else T
    dev = {} if side == "reference" else {"device": "cpu"}
    ns = types.SimpleNamespace(**{k: getattr(m, k) for k in m.__all__ if hasattr(m, k)})
    ns.side = side
    ns.Controller = functools.partial(m.Controller, **dev)
    ns.FaultyChannel = functools.partial(m.FaultyChannel, **dev)
    ns.ckpt = jckpt if side == "reference" else tckpt
    ns.restore_checkpoint = (jckpt.restore_checkpoint if side == "reference"
                             else functools.partial(tckpt.restore_checkpoint, device="cpu"))
    ns.zeros = (lambda s: jnp.zeros(s, jnp.float32)) if side == "reference" else (
        lambda s: torch.zeros(s, dtype=torch.float32))
    ns.as_array = jnp.asarray if side == "reference" else torch.as_tensor
    ns.TopkUploadCodec = (jtransport if side == "reference" else ttransport).TopkUploadCodec
    return ns


def _fixed_learner(side, i):
    """The reference harness's learner: a constant batch, a fixed step time."""
    rng = np.random.default_rng(i)
    X = rng.normal(size=(16, 4)).astype(np.float32)
    y = X @ np.ones((4, 1), np.float32)
    if side == "reference":
        def loss_fn(p, b):
            return jnp.mean((b[0] @ p["w"] - b[1]) ** 2)

        base, data, opt, dev = J.Learner, (X, y), jsgd(0.05), {}
    else:
        def loss_fn(p, b):
            return torch.mean((b[0] @ p["w"] - b[1]) ** 2)

        base, opt, dev = T.Learner, topt.sgd(0.05), {"device": "cpu"}
        data = (torch.from_numpy(X), torch.from_numpy(y))

    class _Fixed(base):
        def fit(self, params, task):
            update = super().fit(params, task)
            update.seconds_per_step = 1e-3
            return update

    return _Fixed(f"l{i}", loss_fn, lambda p, b: {"eval_loss": loss_fn(p, b)},
                  lambda bs: data, lambda: data, opt, 16, **dev)


def _protocol(m, name):
    if name == "sync":
        return m.SyncProtocol(local_steps=2, batch_size=8)
    if name == "semi_sync":
        return m.SemiSyncProtocol(hyperperiod_s=0.05, batch_size=8, default_steps=2)
    if name == "buffered_async":
        return m.BufferedAsyncProtocol(buffer_k=2, local_steps=2, batch_size=8)
    if name == "deadline":
        # no wall-clock timer: predicted cohorts only, the same in both runs
        return m.DeadlineCohortProtocol(deadline_s=1e6, local_steps=2, batch_size=8,
                                        enforce_wall_clock=False)
    if name == "reputation":
        return m.ReputationProtocol(fraction=1.0, local_steps=2, batch_size=8)
    return m.AsyncProtocol(local_steps=2, batch_size=8)


_CONTINUOUS = ("async", "buffered_async")


def _extra(proto_name):
    # FedBuff membership depends on arrival order: one dispatch worker.
    return {"max_dispatch_workers": 1} if proto_name == "buffered_async" else {}


def _build(pkg, proto_name, store_mode, n, secure=False, **kwargs):
    ctrl = pkg.Controller(protocol=_protocol(pkg, proto_name), store_mode=store_mode,
                          secure=secure, **kwargs)
    ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
    for i in range(n):
        ctrl.register_learner(_fixed_learner(pkg.side, i))
    return ctrl


def _run(ctrl, proto_name, k):
    if proto_name in _CONTINUOUS:
        return ctrl.engine.run(total_updates=k)
    return ctrl.engine.run(rounds=k)


def _buf(ctrl):
    return np.array(ctrl.global_buffer)


GRID = [
    ("sync", "arena", 3),
    ("sync", "stack", 3),
    ("semi_sync", "arena", 2),
    ("semi_sync", "stack", 2),
    ("async", "arena", 1),
    ("async", "stack", 1),
    ("buffered_async", "arena", 3),
    ("buffered_async", "stack", 3),
    ("deadline", "arena", 3),
    ("deadline", "stack", 3),
    ("reputation", "arena", 3),
]


@pytest.mark.parametrize("proto,store_mode,n", GRID, ids=[f"{p}-{s}" for p, s, _ in GRID])
def test_kill_and_resume_bit_identical(pkg, proto, store_mode, n, tmp_path):
    golden = _build(pkg, proto, store_mode, n, **_extra(proto))
    _run(golden, proto, 4)
    want, want_version = _buf(golden), golden._model_version
    golden.shutdown()

    ckpt = str(tmp_path / "ckpt")
    first = _build(pkg, proto, store_mode, n, checkpoint_dir=ckpt, checkpoint_every=2,
                   **_extra(proto))
    _run(first, proto, 2)
    first.shutdown()

    resumed = _build(pkg, proto, store_mode, n, **_extra(proto))
    meta = resumed.restore(ckpt)
    assert meta["round_id"] == 2 and resumed.round_id == 2
    _run(resumed, proto, 2)
    got = _buf(resumed)
    resumed.shutdown()
    np.testing.assert_array_equal(got, want)  # bit-identical, not allclose
    assert resumed._model_version == want_version


@pytest.mark.parametrize("rule", ["median", "trimmed_mean"])
@pytest.mark.parametrize("store_mode", ["arena", "stack"])
def test_robust_rule_kill_and_resume_bit_identical(pkg, rule, store_mode, tmp_path):
    kw = dict(aggregation_rule=rule, trim_k=1)
    golden = _build(pkg, "sync", store_mode, 4, **kw)
    _run(golden, "sync", 4)
    want = _buf(golden)
    golden.shutdown()

    ckpt = str(tmp_path / "ckpt")
    first = _build(pkg, "sync", store_mode, 4, checkpoint_dir=ckpt, checkpoint_every=2, **kw)
    _run(first, "sync", 2)
    first.shutdown()

    wrong_rule = _build(pkg, "sync", store_mode, 4)  # a fedavg controller
    with pytest.raises(ValueError, match="aggregation_rule"):
        wrong_rule.restore(ckpt)
    wrong_rule.shutdown()

    resumed = _build(pkg, "sync", store_mode, 4, **kw)
    assert resumed.restore(ckpt)["aggregation_rule"] == rule
    _run(resumed, "sync", 2)
    got = _buf(resumed)
    resumed.shutdown()
    np.testing.assert_array_equal(got, want)


def test_resume_restores_admission_and_quarantine_state(pkg, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _build(pkg, "sync", "arena", 3, aggregation_rule="trimmed_mean")
    _run(first, "sync", 2)
    # warm the admission EWMA past warm-up, as arriving uploads would
    for i in range(10):
        row = pkg.as_array(np.full((4,), 1.0 + 0.1 * i, np.float32))
        if pkg.side == "reference":
            first._screen_upload("l0", row)
        else:
            first._screen_upload("l0", row, torch.linalg.vector_norm(row))
    assert first.note_offense("l0") is False
    assert first.note_offense("l0") is True
    first.note_offense("l1")
    assert first.is_quarantined("l0") and not first.is_quarantined("l1")
    want = (first._adm_ewma, first._adm_accepted, dict(first._offenses),
            set(first._quarantined))
    first.save_checkpoint(ckpt)
    first.shutdown()

    resumed = _build(pkg, "sync", "arena", 3, aggregation_rule="trimmed_mean")
    meta = resumed.restore(ckpt)
    assert resumed._adm_ewma == want[0]  # floats round-trip exactly
    assert resumed._adm_accepted == want[1]
    assert resumed._offenses == want[2]
    assert resumed._quarantined == want[3]
    assert resumed.is_quarantined("l0") and not resumed.is_quarantined("l1")
    assert meta["admission"]["accepted"] == want[1]
    assert resumed.telemetry.value("engine.quarantine.active") == 1
    resumed.shutdown()


def test_secure_sync_resume_bit_identical(pkg, tmp_path):
    golden = _build(pkg, "sync", "arena", 2, secure=True)
    _run(golden, "sync", 4)
    want = _buf(golden)
    golden.shutdown()

    ckpt = str(tmp_path / "ckpt")
    first = _build(pkg, "sync", "arena", 2, secure=True, checkpoint_dir=ckpt,
                   checkpoint_every=2)
    _run(first, "sync", 2)
    first.shutdown()

    resumed = _build(pkg, "sync", "arena", 2, secure=True)
    resumed.restore(ckpt)
    _run(resumed, "sync", 2)
    got = _buf(resumed)
    resumed.shutdown()
    np.testing.assert_array_equal(got, want)


def test_adaptive_server_state_resumes_bit_identical(pkg, tmp_path):
    """FedAdam's step and moments ride the checkpoint as ``server_state_{i}``
    in the reference's leaf order (step, m, v); the step comes back as the
    type it was saved from."""
    from repro.core.server_opt import make_server_optimizer as jmake
    from repro_torch.core.server_opt import make_server_optimizer as tmake

    make = jmake if pkg.side == "reference" else tmake

    def build(**kw):
        return _build(pkg, "sync", "arena", 2,
                      server_optimizer=make("fedadam", lr=0.1), **kw)

    golden = build()
    _run(golden, "sync", 4)
    want = _buf(golden)
    golden.shutdown()
    ckpt = str(tmp_path / "ckpt")
    first = build(checkpoint_dir=ckpt, checkpoint_every=2)
    _run(first, "sync", 2)
    saved_state = first._server_state
    first.shutdown()
    resumed = build()
    resumed.restore(ckpt)
    assert type(resumed._server_state.step) is type(saved_state.step)
    assert int(resumed._server_state.step) == 2
    np.testing.assert_array_equal(np.array(resumed._server_state.v), np.array(saved_state.v))
    _run(resumed, "sync", 2)
    got = _buf(resumed)
    resumed.shutdown()
    np.testing.assert_array_equal(got, want)
    with np.load(os.path.join(ckpt, "ckpt_00000002.npz")) as z:
        assert {k for k in z.files if k.startswith("extra__server_state_")} == {
            f"extra__server_state_{i}" for i in range(3)}


def test_fedbuff_mid_buffer_kill_and_resume(pkg, tmp_path):
    """n=3, K=2, one dispatch worker: update 1 folds the first two arrivals
    while the third is in flight; the checkpoint carries the drained arrival
    in ``pending_buffer`` and the re-dispatched pair in ``pending_dispatch``."""
    proto, store_mode, n = "buffered_async", "arena", 3
    golden = _build(pkg, proto, store_mode, n, max_dispatch_workers=1)
    _run(golden, proto, 4)
    want = _buf(golden)
    golden.shutdown()

    ckpt = str(tmp_path / "ckpt")
    first = _build(pkg, proto, store_mode, n, checkpoint_dir=ckpt, checkpoint_every=1,
                   max_dispatch_workers=1)
    _run(first, proto, 1)
    first.shutdown()

    resumed = _build(pkg, proto, store_mode, n, max_dispatch_workers=1)
    meta = resumed.restore(ckpt)
    assert meta["pending_buffer"] == ["l2"]
    assert meta["pending_dispatch"] == ["l0", "l1"]
    _run(resumed, proto, 3)
    got = _buf(resumed)
    resumed.shutdown()
    np.testing.assert_array_equal(got, want)


def test_checkpoint_cadence_writes_round_boundary_files(pkg, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    ctrl = _build(pkg, "sync", "arena", 2)
    ctrl.engine.run(rounds=4, checkpoint_every=2, checkpoint_dir=ckpt)
    ctrl.shutdown()
    assert sorted(os.listdir(ckpt)) == ["ckpt_00000002.npz", "ckpt_00000004.npz"]


def test_restore_state_carries_counters_profiles_and_journal(pkg, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _build(pkg, "sync", "arena", 2, checkpoint_dir=ckpt, checkpoint_every=2)
    first.engine.run(rounds=2)
    saved_cursor = first.journal.cursor
    saved_profile = dict(first._learner_profiles["l0"])
    first.shutdown()

    resumed = _build(pkg, "sync", "arena", 2)
    meta = resumed.restore(ckpt)
    assert meta["journal_cursor"] <= saved_cursor  # flushed before EngineStopped
    assert resumed.journal.cursor == meta["journal_cursor"]
    assert resumed._model_version == 2
    assert resumed.engine.aggregates_fired == 2
    assert resumed._learner_versions == {"l0": 1, "l1": 1}
    prof = resumed._learner_profiles["l0"]
    assert dict(prof) == saved_profile
    assert prof.observations == 2 and prof.decay == first.profile_decay
    resumed.engine.run(rounds=1)
    assert resumed.journal.records()[0]["seq"] == meta["journal_cursor"]
    assert meta["telemetry"]["channel.upload_messages"] == 4
    resumed.shutdown()


def test_restore_validates_configuration(pkg, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    ctrl = _build(pkg, "sync", "arena", 2)
    ctrl.engine.run(rounds=2)
    ctrl.save_checkpoint(ckpt)
    ctrl.shutdown()
    for wrong, what in ((_build(pkg, "async", "arena", 1), "protocol"),
                        (_build(pkg, "sync", "stack", 2), "store_mode"),
                        (_build(pkg, "sync", "arena", 2, secure=True), "secure")):
        with pytest.raises(ValueError, match=what):
            wrong.restore(ckpt)
        wrong.shutdown()


def test_checkpoint_requires_directory_and_model(pkg):
    ctrl = pkg.Controller(protocol=pkg.SyncProtocol())
    with pytest.raises(ValueError, match="directory"):
        ctrl.save_checkpoint()
    with pytest.raises(ValueError, match="directory"):
        ctrl.restore()
    ctrl.shutdown()
    bare = pkg.Controller(protocol=pkg.SyncProtocol())
    with pytest.raises(RuntimeError, match="set_initial_model"):
        bare.save_checkpoint("never-written")
    bare.shutdown()


def test_save_restore_roundtrip_preserves_arena_bitwise(pkg, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    ctrl = _build(pkg, "sync", "arena", 3)
    ctrl.engine.run(rounds=1)
    buf = np.array(ctrl.arena.export_state()["buffer"])
    rows = dict(ctrl.arena._rows)
    ctrl.save_checkpoint(ckpt)
    ctrl.shutdown()

    resumed = _build(pkg, "sync", "arena", 3)
    resumed.restore(ckpt)
    st = resumed.arena.export_state()
    np.testing.assert_array_equal(np.asarray(st["buffer"]), buf)
    assert st["rows"] == rows
    np.testing.assert_array_equal(_buf(resumed), _buf(ctrl))
    for key in ("weights", "versions", "valid"):
        np.testing.assert_array_equal(st[key], ctrl.arena.export_state()[key])
    resumed.shutdown()


def test_stack_restore_preserves_records_without_counter_bumps(pkg, tmp_path):
    ckpt = str(tmp_path / "ckpt")
    ctrl = _build(pkg, "sync", "stack", 2)
    ctrl.engine.run(rounds=1)
    inserts = ctrl.store.total_inserts
    ctrl.save_checkpoint(ckpt)
    ctrl.shutdown()
    assert inserts == 2

    resumed = _build(pkg, "sync", "stack", 2)
    resumed.restore(ckpt)
    recs = resumed.store.export_records()
    assert [r.learner_id for r in recs] == [r.learner_id for r in ctrl.store.export_records()]
    assert resumed.store.num_records() == 2
    assert resumed.store.total_inserts == 0  # a restore is not new wire traffic
    assert recs[0].metadata["model_version"] == 0
    for a, b in zip(recs, ctrl.store.export_records()):
        np.testing.assert_array_equal(np.asarray(a.buffer), np.asarray(b.buffer))
    resumed.shutdown()


@pytest.mark.parametrize("codec", ["raw", "int8"])
def test_int8_arena_kill_and_resume_bit_identical(pkg, codec, tmp_path):
    kw = dict(arena_dtype="int8", upload_codec=codec)
    golden = _build(pkg, "sync", "arena", 3, **kw)
    _run(golden, "sync", 4)
    want = _buf(golden)
    golden.shutdown()

    ckpt = str(tmp_path / "ckpt")
    first = _build(pkg, "sync", "arena", 3, checkpoint_dir=ckpt, checkpoint_every=2, **kw)
    _run(first, "sync", 2)
    saved_q, saved_s = np.array(first.arena.buffer), np.array(first.arena.scales)
    first.shutdown()

    wrong_dtype = _build(pkg, "sync", "arena", 3, upload_codec=codec)
    with pytest.raises(ValueError, match="arena_dtype"):
        wrong_dtype.restore(ckpt)
    wrong_dtype.shutdown()

    resumed = _build(pkg, "sync", "arena", 3, **kw)
    assert resumed.restore(ckpt)["arena_dtype"] == "int8"
    np.testing.assert_array_equal(np.array(resumed.arena.buffer), saved_q)
    np.testing.assert_array_equal(np.array(resumed.arena.scales), saved_s)
    assert np.array(resumed.arena.buffer).dtype == np.int8
    _run(resumed, "sync", 2)
    got = _buf(resumed)
    resumed.shutdown()
    np.testing.assert_array_equal(got, want)


_TOPK_GRID = [
    ("sync", "direct", 3),
    ("sync", "densify", 3),
    ("async", "direct", 1),
    ("buffered_async", "direct", 3),
]


@pytest.mark.parametrize("proto,sparse_mode,n", _TOPK_GRID,
                         ids=[f"{p}-{m}" for p, m, _ in _TOPK_GRID])
def test_topk_kill_and_resume_bit_identical(pkg, proto, sparse_mode, n, tmp_path):
    """The learners' error-feedback residuals ride the checkpoint bit for
    bit, the sparse arena checkpoints its indices beside its values, and the
    resumed run is bit-identical to the uninterrupted one."""
    kw = dict(upload_codec=pkg.TopkUploadCodec(k=2), sparse_mode=sparse_mode, **_extra(proto))
    golden = _build(pkg, proto, "arena", n, **kw)
    _run(golden, proto, 4)
    want = _buf(golden)
    golden.shutdown()

    ckpt = str(tmp_path / "ckpt")
    first = _build(pkg, proto, "arena", n, checkpoint_dir=ckpt, checkpoint_every=2, **kw)
    _run(first, proto, 2)
    res_saved = {lid: l.export_residual() for lid, l in first._learners.items()}
    assert any(r is not None for r in res_saved.values())
    if sparse_mode == "direct":
        saved_idx, saved_val = np.array(first.arena.indices), np.array(first.arena.buffer)
    first.shutdown()

    resumed = _build(pkg, proto, "arena", n, **kw)
    meta = resumed.restore(ckpt)
    assert meta["sparse_mode"] == sparse_mode
    for lid, learner in resumed._learners.items():
        saved, got = res_saved[lid], learner.export_residual()
        assert (saved is None) == (got is None)
        if saved is not None:
            np.testing.assert_array_equal(got, saved)
    if sparse_mode == "direct":
        np.testing.assert_array_equal(np.array(resumed.arena.indices), saved_idx)
        np.testing.assert_array_equal(np.array(resumed.arena.buffer), saved_val)
        assert str(resumed.arena.indices.dtype).endswith("int32")
    _run(resumed, proto, 2)
    got = _buf(resumed)
    resumed.shutdown()
    np.testing.assert_array_equal(got, want)  # bit-identical, not allclose


def test_topk_restore_refuses_sparse_mode_mismatch(pkg, tmp_path):
    """A direct-mode checkpoint resumed on a densify controller is a different
    resident layout: refused, not coerced."""
    ckpt = str(tmp_path / "ckpt")
    first = _build(pkg, "sync", "arena", 3, checkpoint_dir=ckpt, checkpoint_every=2,
                   upload_codec=pkg.TopkUploadCodec(k=2), sparse_mode="direct")
    _run(first, "sync", 2)
    first.shutdown()

    wrong = _build(pkg, "sync", "arena", 3, upload_codec=pkg.TopkUploadCodec(k=2),
                   sparse_mode="densify")
    with pytest.raises(ValueError, match="sparse_mode"):
        wrong.restore(ckpt)
    wrong.shutdown()


def test_lost_during_checkpoint_drain_rejoins_rotation(pkg, tmp_path):
    """An upload lost while the pre-checkpoint drain absorbs arrivals is
    re-dispatched after the checkpoint, and the checkpoint owes it."""

    def controller(fates):
        ctrl = pkg.Controller(
            protocol=pkg.BufferedAsyncProtocol(buffer_k=1, local_steps=1, batch_size=16),
            channel=pkg.FaultyChannel(_ScriptedInjector(fates)), max_dispatch_workers=1)
        ctrl.set_initial_model({"w": pkg.zeros((4, 1))})
        for i in range(2):
            ctrl.register_learner(_toy_learner(pkg.side, i))
        return ctrl

    ctrl = controller({("l1", 0): "lost"})
    ctrl.engine.run(total_updates=3, checkpoint_every=1, checkpoint_dir=str(tmp_path))
    assert ctrl.telemetry.value("engine.faults.uploads_lost") == 1
    dispatched_l1 = [e for e in ctrl.engine.event_log
                     if isinstance(e, pkg.Dispatched) and e.learner_id == "l1"]
    assert len(dispatched_l1) >= 2  # the owed retry leg left
    _, _, meta = pkg.restore_checkpoint(str(tmp_path), step=1)
    assert meta["pending_dispatch"] == ["l0", "l1"]
    ctrl.shutdown()

    ctrl2 = controller({})
    ctrl2.restore(str(tmp_path), step=1)
    assert ctrl2.engine._resume_dispatch == ["l0", "l1"]
    ctrl2.shutdown()


# -- checkpoint files (reference tests/test_infra.py) --------------------------


def test_checkpoint_file_roundtrip(pkg, tmp_path):
    d = str(tmp_path)
    rng = np.random.default_rng(0)
    w = rng.normal(size=(8, 4)).astype(np.float32)
    emb = rng.normal(size=(10, 4)).astype(np.float32)
    if pkg.side == "reference":
        params = {"w": jnp.asarray(w), "emb": jnp.asarray(emb).astype(jnp.bfloat16)}
    else:
        params = {"w": torch.from_numpy(w), "emb": torch.from_numpy(emb).to(torch.bfloat16)}
    pkg.ckpt.save_checkpoint(d, 3, params, extra_arrays={"rounds": np.asarray([1, 2, 3])},
                             metadata={"arch": "test"})
    pkg.ckpt.save_checkpoint(d, 7, params)
    assert pkg.ckpt.latest_step(d) == 7
    back, extras, meta = pkg.restore_checkpoint(d, 3)
    assert meta["step"] == 3 and meta["arch"] == "test"
    np.testing.assert_array_equal(extras["rounds"], [1, 2, 3])
    for k in ("w", "emb"):
        assert back[k].dtype == params[k].dtype
        a = np.asarray(params[k].astype(jnp.float32)) if pkg.side == "reference" else (
            params[k].float().numpy())
        b = np.asarray(back[k].astype(jnp.float32)) if pkg.side == "reference" else (
            back[k].float().numpy())
        np.testing.assert_array_equal(a, b)


def test_checkpoint_restore_latest(pkg, tmp_path):
    d = str(tmp_path)
    pkg.ckpt.save_checkpoint(d, 1, {"w": pkg.as_array(np.ones((2,), np.float32))})
    _, _, meta = pkg.restore_checkpoint(d)
    assert meta["step"] == 1


def test_checkpoint_missing_raises(pkg, tmp_path):
    with pytest.raises(FileNotFoundError):
        pkg.restore_checkpoint(str(tmp_path))


def test_restore_checkpoint_defaults_to_the_card(tmp_path):
    tckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.ones((2,))})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tckpt.restore_checkpoint(str(tmp_path))


# -- the two packages write the same checkpoint --------------------------------


@pytest.mark.parametrize("proto,store_mode,kw", [
    ("sync", "arena", {}),
    ("sync", "stack", {"max_dispatch_workers": 1}),  # records in arrival order
    ("buffered_async", "arena", {"max_dispatch_workers": 1}),
    ("sync", "arena", {"arena_dtype": "int8", "upload_codec": "int8"}),
    ("sync", "arena", {"secure": True}),
    ("sync", "arena", {"upload_codec": "topk", "sparse_mode": "direct"}),
], ids=["sync-arena", "sync-stack", "fedbuff-arena", "int8-arena", "secure-arena",
        "topk-direct"])
def test_checkpoint_holds_the_reference_keys_and_counters(proto, store_mode, kw, tmp_path):
    """The same federation, checkpointed at round 2 in both packages: the
    same ``.npz`` keys, the same meta keys and counters (every telemetry
    counter but the wall-clock ones), models within rtol 1e-4 / atol 1e-5."""
    files = {}
    for side in ("reference", "port"):
        ns = types.SimpleNamespace(
            side=side, Controller=functools.partial(
                (J if side == "reference" else T).Controller,
                **({} if side == "reference" else {"device": "cpu"})),
            **{k: getattr(J if side == "reference" else T, k)
               for k in ("SyncProtocol", "SemiSyncProtocol", "BufferedAsyncProtocol",
                         "DeadlineCohortProtocol", "ReputationProtocol", "AsyncProtocol")},
            zeros=(lambda s: jnp.zeros(s, jnp.float32)) if side == "reference" else (
                lambda s: torch.zeros(s, dtype=torch.float32)))
        ckpt = str(tmp_path / side)
        ctrl = _build(ns, proto, store_mode, 3, checkpoint_dir=ckpt, checkpoint_every=2, **kw)
        _run(ctrl, proto, 2)
        ctrl.shutdown()
        with np.load(os.path.join(ckpt, "ckpt_00000002.npz")) as z:
            files[side] = ({k: z[k] for k in z.files if k not in ("manifest", "meta")},
                           json.loads(z["meta"].tobytes().decode()))
    (j_arrays, j_meta), (t_arrays, t_meta) = files["reference"], files["port"]
    assert sorted(t_arrays) == sorted(j_arrays)
    assert sorted(t_meta) == sorted(j_meta)
    for key in ("step", "round_id", "model_version", "learner_versions", "aggregates_fired",
                "deregistered_at", "late_carry", "journal_cursor", "protocol", "store_mode",
                "secure", "aggregation_rule", "offenses", "quarantined", "arena_rows",
                "arena_dtype", "pending_buffer", "pending_dispatch", "sparse_mode",
                "residual_learners"):
        assert t_meta.get(key) == j_meta.get(key), key
    assert t_meta["admission"]["accepted"] == j_meta["admission"]["accepted"]
    assert {k: p["observations"] for k, p in t_meta["profiles"].items()} == {
        k: p["observations"] for k, p in j_meta["profiles"].items()}
    timers = ("_s", "seconds")
    j_tel = {k: v for k, v in j_meta["telemetry"].items()
             if isinstance(v, (int, float)) and not k.endswith(timers)}
    t_tel = {k: v for k, v in t_meta["telemetry"].items()
             if isinstance(v, (int, float)) and not k.endswith(timers)}
    assert t_tel == j_tel
    for key, want in j_arrays.items():
        got = t_arrays[key]
        assert got.shape == want.shape, key
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=key)
        elif key == "arena_buffer":  # int8 codes may flip by one where sums differ
            assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        else:
            np.testing.assert_array_equal(got, want, err_msg=key)


# -- the port's entry points ---------------------------------------------------


def test_driver_passes_the_checkpoint_config_through(tmp_path):
    from repro_torch.core import Driver, FederationConfig, FederationEnv, TerminationCriteria

    ckpt = str(tmp_path / "ckpt")
    driver = Driver(FederationEnv(local_steps=1, batch_size=8, device="cpu",
                                  config=FederationConfig(checkpoint_every=1,
                                                          checkpoint_dir=ckpt),
                                  termination=TerminationCriteria(max_rounds=2)))
    assert (driver.controller.checkpoint_every, driver.controller.checkpoint_dir) == (1, ckpt)
    driver.initialize({"w": torch.zeros((4, 1))}, [_fixed_learner("port", i) for i in range(2)])
    driver.run()  # one engine loop a round: one file a round
    assert sorted(os.listdir(ckpt)) == ["ckpt_00000001.npz", "ckpt_00000002.npz"]


def test_launcher_saves_the_final_model_under_secure(tmp_path, capsys):
    from repro_torch.launch import train

    ckpt = str(tmp_path / "ckpt")
    driver, history = train.main(["--size", "100k", "--learners", "2", "--rounds", "2",
                                  "--local-steps", "1", "--secure", "--checkpoint-dir", ckpt,
                                  "--device", "cpu"])
    assert driver.controller.secure and len(history) == 2
    path = os.path.join(ckpt, "ckpt_00000002.npz")
    assert f"checkpoint: {path}" in capsys.readouterr().out
    params, extras, meta = tckpt.restore_checkpoint(ckpt, device="cpu")
    assert meta["rounds"] == 2 and meta["arch"] == "housing-mlp" and extras == {}
    np.testing.assert_array_equal(tckpt.packing.pack_numeric(params).numpy(),
                                  driver.controller.global_buffer.numpy())
