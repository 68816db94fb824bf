"""The top-k uplink as a whole: the port's twin of the reference's conformance grid.

The reference's top-k conformance tests (``tests/test_conformance.py``,
"sparse (top-k) uplink with error feedback") run here in both packages, on
the reference tests' linear-regression learners (``_toy_learner``: same
seeds, same batches) and a zero-initialized ``(4, 1)`` model, one dispatch
worker so arrival order is fixed: sync, semi-sync (one round: later rounds
size tasks from measured step times), async (one learner) and FedBuff
(K = n, one update) × {direct, densify} on the arena; densify on the stack
store; int8-grouped values; the int8 arena under densify; the same
envelopes landed direct and densified; the compression ratios at k = P/64;
every construction refusal, with the reference's exception type and
message; and the ``Driver``/``FederationEnv`` surface with a
``TopkUploadCodec`` object.

Each port run is held against the reference's own controller run at the
tolerance the reference's conformance test holds it to against its f64
replay, rtol 1e-5 / atol 1e-6 (on the int8 arena: within one quantization
step of each group plus 1e-5, ``tests/test_torch_int8.py``'s bar), with the
upload bytes, their header bytes and the sparse counters equal exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from repro.core import transport as jtransport
from repro_torch.core import transport as ttransport
from test_torch_int8 import assert_within_q8_bar
from test_torch_protocols import _toy_learner

_CASES = {
    "sync": dict(proto=lambda m: m.SyncProtocol(local_steps=2, batch_size=16),
                 n=3, rounds=2, updates=0),
    "semi_sync": dict(proto=lambda m: m.SemiSyncProtocol(hyperperiod_s=0.05, batch_size=16,
                                                         default_steps=2),
                      n=3, rounds=1, updates=0),
    "async": dict(proto=lambda m: m.AsyncProtocol(local_steps=2, batch_size=16),
                  n=1, rounds=0, updates=3),
    "buffered_async": dict(proto=lambda m: m.BufferedAsyncProtocol(buffer_k=3, local_steps=2,
                                                                   batch_size=16),
                           n=3, rounds=0, updates=1),
}
COUNTERS = ("channel.upload_messages", "channel.upload_bytes", "channel.upload_meta_bytes",
            "engine.uploads.sparse_direct", "controller.aggregations.sparse_scatter",
            "engine.uploads.quantized_direct", "controller.aggregations.fused_q8",
            "controller.model_version", "store.arena.total_writes",
            "store.arena.bytes_ingested", "store.arena.bytes_resident")


def _pkg(side):
    m = J if side == "reference" else T
    tr = jtransport if side == "reference" else ttransport
    dev = {} if side == "reference" else {"device": "cpu"}
    zeros = (jnp.zeros((4, 1), jnp.float32) if side == "reference"
             else torch.zeros((4, 1), dtype=torch.float32))
    return m, tr, dev, zeros


def _federation(side, case, sparse_mode, store_mode="arena", k=2, value_dtype="f32", **kw):
    m, tr, dev, zeros = _pkg(side)
    ctrl = m.Controller(protocol=case["proto"](m), store_mode=store_mode,
                        upload_codec=tr.TopkUploadCodec(k=k, value_dtype=value_dtype),
                        sparse_mode=sparse_mode, max_dispatch_workers=1, **kw, **dev)
    ctrl.set_initial_model({"w": zeros})
    for i in range(case["n"]):
        ctrl.register_learner(_toy_learner(side, i))
    if case["updates"]:
        ctrl.engine.run(total_updates=case["updates"])
    else:
        ctrl.engine.run(rounds=case["rounds"])
    ctrl.shutdown()
    counters = {c: ctrl.telemetry.value(c, 0) for c in COUNTERS}
    return np.asarray(ctrl.global_params["w"]).reshape(-1), counters, ctrl


def _both(case, sparse_mode, **kw):
    got, tc, tctrl = _federation("port", case, sparse_mode, **kw)
    want, jc, _ = _federation("reference", case, sparse_mode, **kw)
    assert tc == jc
    return got, want, tc, tctrl


@pytest.mark.parametrize("sparse_mode", ["direct", "densify"])
@pytest.mark.parametrize("proto", list(_CASES))
def test_topk_arena_conformance(proto, sparse_mode):
    case = _CASES[proto]
    got, want, counters, ctrl = _both(case, sparse_mode)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    expected = case["n"] * (case["rounds"] + case["updates"])
    assert counters["channel.upload_messages"] == expected
    assert counters["channel.upload_bytes"] > 0 and counters["channel.upload_meta_bytes"] > 0
    if sparse_mode == "direct":
        assert counters["engine.uploads.sparse_direct"] == expected
        assert counters["controller.aggregations.sparse_scatter"] > 0
        assert ctrl.arena.arena_dtype == "topk" and tuple(ctrl.arena.buffer.shape)[1] == 2
    else:
        assert counters["engine.uploads.sparse_direct"] == 0
    assert any(l._residual is not None for l in ctrl._learners.values())


@pytest.mark.parametrize("proto", ["sync", "async"])
def test_topk_stack_conformance(proto):
    got, want, counters, ctrl = _both(_CASES[proto], "densify", store_mode="stack")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ctrl.arena is None
    case = _CASES[proto]
    assert counters["channel.upload_messages"] == case["n"] * (case["rounds"] + case["updates"])


@pytest.mark.parametrize("sparse_mode", ["direct", "densify"])
def test_topk_int8_values_conformance(sparse_mode):
    got, want, counters, _ = _both(_CASES["sync"], sparse_mode, value_dtype="int8")
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert counters["channel.upload_bytes"] == 6 * (5 * 2 + 4)  # 6 uploads, k = 2, one scale


@pytest.mark.parametrize("proto", ["sync", "buffered_async"])
def test_topk_densify_on_the_int8_arena(proto):
    got, want, counters, ctrl = _both(_CASES[proto], "densify", arena_dtype="int8",
                                      value_dtype="int8", k=4)
    assert_within_q8_bar(got, want, what="topk densify int8 arena")
    assert ctrl.arena.buffer.dtype == torch.int8
    assert counters["controller.aggregations.fused_q8"] > 0
    assert counters["engine.uploads.quantized_direct"] == 0


def _ingest_envelopes(side, mode, rows, k=16):
    m, tr, dev, zeros = _pkg(side)
    ctrl = m.Controller(protocol=m.SyncProtocol(local_steps=2, batch_size=16), store_mode="arena",
                        upload_codec=tr.TopkUploadCodec(k=k), sparse_mode=mode, **dev)
    ctrl.set_initial_model({"w": zeros})
    for i in range(len(rows)):
        ctrl.register_learner(_toy_learner(side, i))
    wires = []
    for i, row in enumerate(rows):
        buf = jnp.asarray(row) if side == "reference" else torch.from_numpy(row)
        env = ctrl.channel.upload(buf, metadata={"learner_id": f"l{i}", "round_id": 0})
        wires.append(env.payload.tobytes())
        ctrl.ingest(m.LocalUpdate(learner_id=f"l{i}", round_id=0, params=None, buffer=None,
                                  num_examples=10 * (i + 1), metrics={},
                                  seconds_per_step=0.01, upload=env))
    ctrl.aggregate_round([f"l{i}" for i in range(len(rows))])
    ctrl.shutdown()
    return np.asarray(ctrl.global_buffer), wires, ctrl


def test_topk_direct_vs_densify_landing_parity():
    rng = np.random.default_rng(0)
    rows = [rng.normal(size=1024).astype(np.float32) for _ in range(3)]
    out = {(side, mode): _ingest_envelopes(side, mode, rows)
           for side in ("port", "reference") for mode in ("direct", "densify")}
    direct, densify = out["port", "direct"], out["port", "densify"]
    np.testing.assert_allclose(direct[0], densify[0], rtol=1e-6, atol=1e-7)
    for mode in ("direct", "densify"):
        assert out["port", mode][1] == out["reference", mode][1]  # the same wire bytes
        np.testing.assert_allclose(out["port", mode][0], out["reference", mode][0],
                                   rtol=1e-6, atol=1e-7)
    ctrl = direct[2]
    assert ctrl.telemetry.value("engine.uploads.sparse_direct") == 3
    assert ctrl.telemetry.value("controller.aggregations.sparse_scatter") == 1
    assert tuple(ctrl.arena.buffer.shape) == tuple(ctrl.arena.indices.shape) == (
        ctrl.arena.n_max, 16)


def test_topk_uplink_actually_compresses():
    """At k = P/64 the sparse wire carries >= 8x fewer bytes than raw and >= 2x
    fewer than int8 (P = 1024, the padded arena row), in both packages."""
    case = _CASES["sync"]
    bytes_ = {}
    for side in ("port", "reference"):
        m, tr, dev, zeros = _pkg(side)
        for codec in ("raw", "int8"):
            ctrl = m.Controller(protocol=case["proto"](m), upload_codec=codec,
                                max_dispatch_workers=1, **dev)
            ctrl.set_initial_model({"w": zeros})
            for i in range(case["n"]):
                ctrl.register_learner(_toy_learner(side, i))
            ctrl.engine.run(rounds=case["rounds"])
            ctrl.shutdown()
            bytes_[side, codec] = ctrl.channel.stats.upload_bytes
        got, counters, _ = _federation(side, case, "direct", k=1024 // 64)
        bytes_[side, "topk"] = counters["channel.upload_bytes"]
        assert np.isfinite(got).all()
    for key in ("raw", "int8", "topk"):
        assert bytes_["port", key] == bytes_["reference", key]
    n = case["n"] * case["rounds"]
    assert bytes_["port", "topk"] == n * 8 * 16
    assert bytes_["port", "raw"] / bytes_["port", "topk"] >= 8.0
    assert bytes_["port", "int8"] / bytes_["port", "topk"] >= 2.0


def _custom_fn(stack, w):
    return stack[0]


REFUSALS = {
    "secure": dict(upload_codec="topk", secure=True),
    "flat_uploads": dict(upload_codec="topk", flat_uploads=False),
    "aggregate_fn": dict(upload_codec="topk", aggregate_fn=_custom_fn),
    "masked_aggregate_fn": dict(upload_codec="topk", masked_aggregate_fn=_custom_fn),
    "direct_without_topk": dict(upload_codec="raw", sparse_mode="direct"),
    "direct_int8_codec": dict(upload_codec="int8", sparse_mode="direct"),
    "direct_stack": dict(upload_codec="topk", sparse_mode="direct", store_mode="stack"),
    "direct_median": dict(upload_codec="topk", sparse_mode="direct", aggregation_rule="median"),
    "direct_trimmed_mean": dict(upload_codec="topk", sparse_mode="direct",
                                aggregation_rule="trimmed_mean"),
    "direct_int8_arena": dict(upload_codec="topk", sparse_mode="direct", arena_dtype="int8"),
    "bad_sparse_mode": dict(upload_codec="topk", sparse_mode="lazy"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_topk_construction_refusals_match_reference(case):
    kw = REFUSALS[case]
    with pytest.raises(Exception) as jerr:
        J.Controller(**kw)
    with pytest.raises(Exception) as terr:
        T.Controller(device="cpu", **kw)
    assert type(terr.value) is type(jerr.value) is ValueError
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("case", ["flat_uploads", "direct_raw", "direct_stack", "direct_median",
                                  "direct_int8", "bad_mode"])
def test_topk_config_refusals_match_reference(case):
    kw = {"flat_uploads": dict(upload_codec="topk", flat_uploads=False),
          "direct_raw": dict(sparse_mode="direct"),
          "direct_stack": dict(upload_codec="topk", sparse_mode="direct", store_mode="stack"),
          "direct_median": dict(upload_codec="topk", sparse_mode="direct",
                                aggregation_rule="median"),
          "direct_int8": dict(upload_codec="topk", sparse_mode="direct", arena_dtype="int8"),
          "bad_mode": dict(sparse_mode="eager")}[case]
    with pytest.raises(ValueError) as jerr:
        J.FederationConfig(**kw)
    with pytest.raises(ValueError) as terr:
        T.FederationConfig(**kw)
    assert str(terr.value) == str(jerr.value)


def test_direct_arena_refuses_a_dense_envelope():
    msgs = []
    for side in ("reference", "port"):
        m, tr, dev, zeros = _pkg(side)
        ctrl = m.Controller(upload_codec=tr.TopkUploadCodec(k=4), sparse_mode="direct", **dev)
        ctrl.set_initial_model({"w": zeros})
        ctrl.register_learner(_toy_learner(side, 0))
        row = np.ones(1024, np.float32)
        env = ctrl.channel.upload(jnp.asarray(row) if side == "reference" else
                                  torch.from_numpy(row), codec="raw")
        with pytest.raises(ValueError) as err:
            ctrl.ingest(m.LocalUpdate(learner_id="l0", round_id=0, params=None,
                                      num_examples=1, metrics={}, seconds_per_step=0.01,
                                      upload=env))
        msgs.append(str(err.value))
        assert ctrl.arena.num_valid() == 0
        ctrl.shutdown()
    assert msgs[0] == msgs[1] and "sparse_mode='direct'" in msgs[1]


def test_sparse_admission_clips_by_rescaling_values():
    """Past the screen's warm-up an outlier's values are rescaled to the
    clip limit, in both packages, and the clipped row lands alike."""
    rng = np.random.default_rng(5)
    rows = [rng.normal(size=1024).astype(np.float32) for _ in range(4)]
    rows[3] *= 100.0
    landed = {}
    for side in ("reference", "port"):
        m, tr, dev, zeros = _pkg(side)
        ctrl = m.Controller(upload_codec=tr.TopkUploadCodec(k=32), sparse_mode="direct",
                            admission_warmup=2, **dev)
        ctrl.set_initial_model({"w": zeros})
        for i in range(4):
            ctrl.register_learner(_toy_learner(side, i))
        clips = []
        for i, row in enumerate(rows):
            env = ctrl.channel.upload(jnp.asarray(row) if side == "reference" else
                                      torch.from_numpy(row))
            clips.append(ctrl.ingest(m.LocalUpdate(
                learner_id=f"l{i}", round_id=0, params=None, num_examples=5, metrics={},
                seconds_per_step=0.01, upload=env)))
        assert clips[:3] == [None] * 3 and clips[3] is not None
        assert ctrl.telemetry.value("engine.uploads.clipped") == 1
        landed[side] = (np.asarray(ctrl.arena.buffer), np.asarray(ctrl.arena.indices), clips[3])
        ctrl.shutdown()
    np.testing.assert_array_equal(landed["port"][1], landed["reference"][1])
    np.testing.assert_allclose(landed["port"][0], landed["reference"][0], rtol=1e-5, atol=1e-7)
    for key in ("norm", "limit"):
        assert landed["port"][2][key] == pytest.approx(landed["reference"][2][key], rel=1e-5)


@pytest.mark.parametrize("sparse_mode", ["direct", "densify"])
def test_driver_reaches_topk_with_a_codec_object(sparse_mode):
    """``FederationEnv(upload_codec=TopkUploadCodec(...), sparse_mode=...)``
    through ``Driver``, as users reach the sparse uplink."""
    out = {}
    for side in ("reference", "port"):
        m, tr, dev, zeros = _pkg(side)
        env = m.FederationEnv(local_steps=2, batch_size=16, learning_rate=0.05,
                              upload_codec=tr.TopkUploadCodec(k=2), sparse_mode=sparse_mode,
                              termination=m.TerminationCriteria(max_rounds=2), **dev)
        assert env.config.sparse_mode == sparse_mode
        driver = m.Driver(env)
        driver.initialize({"w": zeros}, [_toy_learner(side, i) for i in range(3)])
        history = driver.run()
        assert len(history) == 2
        tel = driver.controller.telemetry
        out[side] = (np.asarray(driver.controller.global_buffer),
                     tel.value("channel.upload_bytes"),
                     tel.value("engine.uploads.sparse_direct", 0))
    assert out["port"][1:] == out["reference"][1:]
    assert out["port"][2] == (6 if sparse_mode == "direct" else 0)
    np.testing.assert_allclose(out["port"][0], out["reference"][0], rtol=1e-5, atol=1e-6)
