"""Secure aggregation, in both packages and held against each other.

The port's ``core/secure.py`` draws its pairwise pads from ``torch.Generator``
where the reference uses threefry, so a single masked upload differs between
the packages; the pads cancel exactly in wrapping int32, so
``encode_fixed``, the unmasked fixed-point sum and the aggregate must equal
the reference's bit for bit on the same inputs (NaN, ±inf, out-of-range
values and sums that wrap past ±2^31 included).

Also here: the reference's ``tests/test_secure.py`` and its secure
controller test (``tests/test_controller.py``), each run against both
packages as the cases of one parametrised test; the ``secure`` and
``secure_async`` cases of ``tests/test_conformance.py`` against a
learner-side replay in the port (bit-identical on the raw codec) and against
the reference's federation (rtol 1e-4 / atol 1e-5: the two frameworks' CPU
kernels sum the local steps in different orders); and the controller's
refusals.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as T
from hypothesis_compat import given, settings, st
from repro.core import secure as jsec
from repro_torch.core import secure as tsec
from test_torch_protocols import _toy_learner

SIDES = ["reference", "port"]


def _mod(side):
    return jsec if side == "reference" else tsec


def _arr(side, x):
    return jnp.asarray(x) if side == "reference" else torch.from_numpy(np.array(x))


def _net_mask(side, masker, idx, size):
    return masker.net_mask(idx, size, **({} if side == "reference" else {"device": "cpu"}))


def _np(x):
    return np.asarray(x) if not isinstance(x, torch.Tensor) else x.numpy()


def _special(n: int, seed: int) -> np.ndarray:
    """Normal values, then NaN of both signs, ±inf, values at and past the
    int32 limits once scaled, and exact halves of the fixed-point step."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=n) * 100).astype(np.float32)
    x[:16] = [np.nan, -np.nan, np.inf, -np.inf, 32768.0, -32768.0, 32767.999, -32768.001,
              1e30, -1e30, 0.5 / 65536, 1.5 / 65536, 2.5 / 65536, -2.5 / 65536,
              np.float32(2.0 ** 31 - 128) / 65536, np.float32(-(2.0 ** 31) - 256) / 65536]
    return x


@pytest.mark.parametrize("seed", range(3))
def test_encode_fixed_is_the_references_bit_for_bit(seed):
    x = _special(4096, seed)
    want = np.asarray(jsec.encode_fixed(jnp.asarray(x)))
    got = tsec.encode_fixed(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tsec.decode_fixed(torch.from_numpy(want.copy())).numpy(),
                                  np.asarray(jsec.decode_fixed(jnp.asarray(want))))
    # the saturation and NaN rules, spelled out
    assert list(got[:4]) == [0, 0, 2 ** 31 - 1, -(2 ** 31)]
    assert list(got[8:14]) == [2 ** 31 - 1, -(2 ** 31), 0, 2, 2, -2]


def _unmasked_sum(mod, buffers, weights):
    """The wrapping int32 sum of each learner's encoded weighted row."""
    wsum = float(sum(weights))
    total = np.zeros(buffers[0].shape[0], np.int64)
    for buf, w in zip(buffers, weights):
        if mod is jsec:
            enc = np.asarray(mod.encode_fixed(jnp.asarray(buf) * jnp.float32(w / wsum)))
        else:
            enc = mod.encode_fixed(torch.from_numpy(buf) * float(np.float32(w / wsum))).numpy()
        total = (total + enc.astype(np.int64)) % (1 << 32)
    return np.where(total >= 1 << 31, total - (1 << 32), total).astype(np.int32)


@pytest.mark.parametrize("case", ["normal", "special", "wraps"])
def test_secure_aggregate_is_the_references_bit_for_bit(case):
    rng = np.random.default_rng(7)
    n, p = 5, 777
    if case == "normal":
        buffers = [(rng.normal(size=p) * 10 ** i).astype(np.float32) for i in range(n)]
    elif case == "special":
        buffers = [_special(p, i) for i in range(n)]
    else:  # a weighted mean of ~40000 is ~2.6e9 once encoded: the int32 sum wraps
        buffers = [np.full(p, 40000.0, np.float32) - rng.random(p).astype(np.float32)
                   for _ in range(n)]
        buffers[2][::3] *= -1
    weights = [1.0, 2.0, 3.5, 0.25, 7.0] if case != "wraps" else [1.0] * n
    want = np.asarray(jsec.secure_fedavg([jnp.asarray(b) for b in buffers], weights,
                                         base_seed=13))
    got = tsec.secure_fedavg([torch.from_numpy(b) for b in buffers], weights,
                             base_seed=13).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    # both equal the unmasked sum decoded: the pads cancel exactly
    plain = _unmasked_sum(tsec, buffers, weights)
    np.testing.assert_array_equal(plain, _unmasked_sum(jsec, buffers, weights))
    np.testing.assert_array_equal(got.view(np.int32),
                                  (plain.astype(np.float32) / tsec.FIXED_SCALE).view(np.int32))
    if case == "wraps":
        assert (plain < 0).any() and (plain > 0).any()
    # the arena form over the same rows is the same number
    arena = torch.from_numpy(np.stack([np.zeros(p, np.float32)] + buffers))
    got_arena = tsec.secure_fedavg_arena(arena, list(range(1, n + 1)), weights,
                                         base_seed=13).numpy()
    np.testing.assert_array_equal(got_arena.view(np.int32), got.view(np.int32))


def test_masked_upload_differs_from_its_encoding_and_pads_are_uniform():
    masker = tsec.PairwiseMasker(base_seed=7, participants=(0, 1, 2))
    x = torch.from_numpy(_special(4096, 1))
    up = tsec.mask_upload(masker, 1, x)
    enc = tsec.encode_fixed(x)
    assert up.dtype == torch.int32 and float((up == enc).float().mean()) < 0.01
    pad = masker.net_mask(0, 1 << 16, device="cpu")
    assert 0.48 < float((pad < 0).float().mean()) < 0.52  # the sign bit is drawn too


def test_arena_secure_sum_refuses_the_sharded_layout():
    # The sharded sum is ported (tests/test_torch_sharded.py); what it refuses
    # is an out_sharding that is not a row layout of models.sharding.
    with pytest.raises(TypeError, match="row layout"):
        tsec.secure_fedavg_arena(torch.zeros((2, 4)), [0, 1], [1.0, 1.0], out_sharding=object())


# -- the reference's tests/test_secure.py, against both packages -------------


@pytest.mark.parametrize("side", SIDES)
@settings(max_examples=20, deadline=None)
@given(n=st.integers(2, 6), p=st.integers(1, 128), seed=st.integers(0, 1000))
def test_secure_fedavg_matches_plain(side, n, p, seed):
    rng = np.random.default_rng(seed)
    buffers = [rng.normal(size=p).astype(np.float32) for _ in range(n)]
    weights = [float(i + 1) for i in range(n)]
    got = _np(_mod(side).secure_fedavg([_arr(side, b) for b in buffers], weights,
                                       base_seed=seed))
    want = np.average(np.stack(buffers).astype(np.float64), axis=0, weights=weights)
    bound = n / (2.0 * _mod(side).FIXED_SCALE) + 1e-6
    assert float(np.abs(got - want).max()) <= bound


@pytest.mark.parametrize("side", SIDES)
def test_net_masks_sum_to_zero(side):
    masker = _mod(side).PairwiseMasker(base_seed=42, participants=(0, 1, 2, 3))
    total = sum(_np(_net_mask(side, masker, i, 64)).astype(np.int64) for i in range(4))
    assert np.all(total % (1 << 32) == 0)


@pytest.mark.parametrize("side", SIDES)
def test_upload_is_masked(side):
    mod = _mod(side)
    masker = mod.PairwiseMasker(base_seed=7, participants=(0, 1))
    x = _arr(side, np.ones((256,), np.float32))
    frac_equal = float(np.mean(_np(mod.mask_upload(masker, 0, x)) == _np(mod.encode_fixed(x))))
    assert frac_equal < 0.01


@pytest.mark.parametrize("side", SIDES)
def test_masks_change_with_seed_and_pair(side):
    mod = _mod(side)
    m1 = _np(_net_mask(side, mod.PairwiseMasker(1, (0, 1)), 0, 32))
    m2 = _np(_net_mask(side, mod.PairwiseMasker(2, (0, 1)), 0, 32))
    assert not np.all(m1 == m2)


@pytest.mark.parametrize("side", SIDES)
@settings(max_examples=10, deadline=None)
@given(seed=st.integers(0, 50))
def test_fixed_point_codec_bound(side, seed):
    mod = _mod(side)
    x = (np.random.default_rng(seed).normal(size=512) * 10).astype(np.float32)
    back = _np(mod.decode_fixed(mod.encode_fixed(_arr(side, x))))
    assert float(np.abs(back - x).max()) <= 0.5 / mod.FIXED_SCALE + 1e-7


def test_mask_sessions_are_the_references():
    for base, epoch in ((0, 0), (0, 5), (7, 3), (123456789, 2 ** 20)):
        assert tsec.MaskSession(base, epoch).seed == jsec.MaskSession(base, epoch).seed
        for i, j in ((0, 1), (3, 2), (5, 31)):
            assert tsec._pair_seed(base, i, j) == jsec._pair_seed(base, i, j)


# -- the controller ----------------------------------------------------------


def _controller(side, **kw):
    m = J if side == "reference" else T
    dev = {} if side == "reference" else {"device": "cpu"}
    return m.Controller(**kw, **dev), m


@pytest.mark.parametrize("side", SIDES)
def test_secure_controller_round_matches_plain(side):
    def build(secure):
        ctrl, m = _controller(side, protocol=(J if side == "reference" else T).SyncProtocol(
            local_steps=3, batch_size=16), secure=secure)
        ctrl.set_initial_model({"w": _arr(side, np.zeros((4, 1), np.float32))})
        for i in range(3):
            ctrl.register_learner(_toy_learner(side, i))
        ctrl.engine.run(rounds=1)
        out = np.array(ctrl.global_params["w"])
        ctrl.shutdown()
        return out

    np.testing.assert_allclose(build(False), build(True), atol=1e-3)


@pytest.mark.parametrize("side", SIDES)
@pytest.mark.parametrize("kw,what", [
    (dict(aggregation_rule="median"), "aggregation_rule='median'"),
    (dict(aggregation_rule="trimmed_mean"), "aggregation_rule='trimmed_mean'"),
    (dict(arena_dtype="int8"), "arena_dtype='int8'"),
], ids=["median", "trimmed_mean", "int8_arena"])
def test_secure_refuses_robust_rules_and_the_int8_arena(side, kw, what):
    m = J if side == "reference" else T
    dev = {} if side == "reference" else {"device": "cpu"}
    with pytest.raises(ValueError, match=what) as err:
        m.Controller(secure=True, **kw, **dev)
    assert "secure" in str(err.value)


def test_secure_turns_admission_control_off():
    ctrl, _ = _controller("port", secure=True)
    assert ctrl.admission_control is False and ctrl.secure_seed == 0
    ctrl.shutdown()
    masker = tsec.PairwiseMasker(base_seed=1, participants=(0, 1))
    if not torch.cuda.is_available():  # the pads are drawn on the card by default
        with pytest.raises(RuntimeError, match="CUDA"):
            masker.net_mask(0, 8)


# -- conformance: secure and secure_async -------------------------------------

_CASES = {
    "secure": dict(proto="SyncProtocol", kw=dict(local_steps=2, batch_size=16), n=3,
                   rounds=2, updates=0),
    "secure_async": dict(proto="AsyncProtocol", kw=dict(local_steps=2, batch_size=16), n=1,
                         rounds=0, updates=3),
}


def _conformance_learner(side, i):
    """The conformance harness's learner: 64 samples, random batches."""
    return _toy_learner(side, i)


def _federation(side, case, store_mode, codec):
    m = J if side == "reference" else T
    ctrl, _ = _controller(side, protocol=getattr(m, case["proto"])(**case["kw"]), secure=True,
                          store_mode=store_mode, upload_codec=codec)
    ctrl.set_initial_model({"w": _arr(side, np.zeros((4, 1), np.float32))})
    for i in range(case["n"]):
        ctrl.register_learner(_conformance_learner(side, i))
    if case["updates"]:
        ctrl.engine.run(total_updates=case["updates"])
    else:
        ctrl.engine.run(rounds=case["rounds"])
    out = np.array(ctrl.global_params["w"])
    stats = ctrl.channel.stats
    ctrl.shutdown()
    return out, stats


def _replay(case):
    """The port's learner-side replay: the same fit sequence outside the
    controller, aggregated by ``secure_fedavg`` in per-epoch mask sessions,
    and by the naive f64 baseline, through the fedavg server optimizer."""
    from repro_torch.core import naive, packing
    from repro_torch.core.server_opt import make_server_optimizer

    init = {"w": torch.zeros((4, 1))}
    proto = getattr(T, case["proto"])(**case["kw"])
    manifest = packing.build_manifest(init)
    out = {}
    for mode in ("exact", "naive"):
        gbuf = packing.pack_numeric(init)
        params = packing.unpack_numeric(gbuf, manifest)
        server = make_server_optimizer("fedavg")
        state = server.init(gbuf)
        learners = [_conformance_learner("port", i) for i in range(case["n"])]
        for r in range(case["rounds"] or case["updates"]):
            ups = [learner.fit(params, proto.make_task(r, {})) for learner in learners]
            weights = [float(u.num_examples) for u in ups]
            if mode == "exact":
                new = tsec.secure_fedavg([packing.pack_numeric(u.params) for u in ups], weights,
                                         base_seed=tsec.MaskSession(0, r).seed)
            else:
                new = packing.pack_numeric(packing.tree_from_numpy(
                    naive.naive_aggregate([u.params for u in ups], weights)))
            state, gbuf = server.apply(state, gbuf, new)
            params = packing.unpack_numeric(gbuf, manifest)
        out[mode] = params["w"].numpy().copy()
    return out


@pytest.mark.parametrize("codec", ["raw", "int8"])
@pytest.mark.parametrize("store_mode", ["arena", "stack"])
@pytest.mark.parametrize("case", list(_CASES))
def test_secure_conformance(case, store_mode, codec):
    c = _CASES[case]
    got, stats = _federation("port", c, store_mode, codec)
    want, _ = _federation("reference", c, store_mode, codec)
    ref = _replay(c)
    if codec == "raw":
        np.testing.assert_array_equal(got, ref["exact"])
        # the naive replay aggregates in the clear: within the fixed-point step
        np.testing.assert_allclose(got, ref["naive"], rtol=1e-3, atol=5e-4)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    else:
        np.testing.assert_allclose(got, ref["exact"], rtol=0.02, atol=0.02)
        np.testing.assert_allclose(got, want, rtol=0.02, atol=0.02)
    uploads = c["n"] * (c["rounds"] + c["updates"])
    assert stats.upload_messages == uploads
    assert stats.upload_bytes > 0 and stats.bytes_moved > 0


# -- the reference's secure engine tests (tests/test_engine.py) ---------------


@pytest.mark.parametrize("side", SIDES)
def test_mask_session_seeds_are_fresh_per_epoch(side):
    mod = _mod(side)
    assert len({mod.MaskSession(7, e).seed for e in range(200)}) == 200
    assert mod.MaskSession(7, 3).seed != mod.MaskSession(8, 3).seed
    assert mod.MaskSession(7, 3).masker(4).participants == (0, 1, 2, 3)


class _Registered:
    """A registered learner that never trains (the arena is filled by hand)."""

    def __init__(self, lid):
        self.learner_id, self.num_examples = lid, 1

    def accept_manifest(self, *args, **kwargs):
        pass


@pytest.mark.parametrize("members", [None, ["l0", "l2"]], ids=["community", "fedbuff"])
def test_secure_community_update_matches_clear_staleness_average(members):
    """The secure community (and FedBuff) update on a hand-built arena with
    mixed staleness equals the clear staleness-weighted average up to the
    fixed-point step in both packages, and is the same number in both, bit
    for bit."""
    alpha = 0.5
    rng = np.random.default_rng(0)
    rows = rng.normal(size=(3, 8)).astype(np.float32) * 0.5
    weights, versions = [10.0, 20.0, 30.0], [0.0, 1.0, 2.0]
    out = {}
    for side in SIDES:
        m = J if side == "reference" else T
        proto = (m.AsyncProtocol(staleness_alpha=alpha) if members is None
                 else m.BufferedAsyncProtocol(buffer_k=2, staleness_alpha=alpha))
        ctrl, _ = _controller(side, protocol=proto, secure=True)
        ctrl.set_initial_model({"w": _arr(side, np.zeros((8,), np.float32))})
        for i in range(3):
            ctrl.register_learner(_Registered(f"l{i}"))
            buf = np.pad(rows[i], (0, ctrl.arena.padded_params - 8))
            ctrl.arena.write(f"l{i}", _arr(side, buf), weight=weights[i], version=versions[i])
        ctrl._model_version = 3
        if members is None:
            ctrl.aggregate_community()
        else:
            ctrl.aggregate_buffer(members)
        out[side] = np.array(ctrl.global_params["w"])
        ctrl.shutdown()
    keep = [0, 1, 2] if members is None else [0, 2]
    damped = np.asarray([weights[i] * (1.0 + 3 - versions[i]) ** (-alpha) for i in keep])
    expect = (damped[:, None] * rows[keep]).sum(0) / damped.sum()
    for got in out.values():
        np.testing.assert_allclose(got, expect, atol=1e-3)
    np.testing.assert_array_equal(out["port"].view(np.int32), out["reference"].view(np.int32))


@pytest.mark.parametrize("side", SIDES)
def test_secure_async_federation_converges_and_hides_models(side):
    m = J if side == "reference" else T
    ctrl, _ = _controller(side, protocol=m.AsyncProtocol(local_steps=2, batch_size=16),
                          secure=True)
    ctrl.set_initial_model({"w": _arr(side, np.zeros((4, 1), np.float32))})
    for i in range(3):
        ctrl.register_learner(_toy_learner(side, i))
    hist = ctrl.engine.run(total_updates=6)
    stats = ctrl.channel.stats
    ctrl.shutdown()
    assert len(hist) >= 6 and ctrl._model_version >= 6
    assert np.isfinite(np.array(ctrl.global_params["w"])).all()
    assert stats.upload_messages == ctrl.arena.total_writes
    assert all(h.aggregation_s > 0 for h in hist)


@pytest.mark.parametrize("side", SIDES)
def test_secure_async_single_learner_matches_plain_quantized(side):
    m = J if side == "reference" else T

    def run(secure):
        ctrl, _ = _controller(side, protocol=m.AsyncProtocol(local_steps=2, batch_size=16),
                              secure=secure)
        ctrl.set_initial_model({"w": _arr(side, np.zeros((4, 1), np.float32))})
        ctrl.register_learner(_toy_learner(side, 0))
        ctrl.engine.run(total_updates=3)
        out = np.array(ctrl.global_params["w"])
        ctrl.shutdown()
        return out

    np.testing.assert_allclose(run(True), run(False), atol=1e-3)
