"""The int8 slice as a whole: the int8 arena, the controller and both int8 legs.

The same operations run in both packages on the same numpy inputs.  The
int8 arena's contents must agree bit for bit (a row write moves bytes, and
quantization is bit-identical, ``tests/test_torch_quantize.py``).

Federations: ``Driver`` + ``SyncProtocol`` with 4 learners built as in
``launch/train.py::build_housing_learners``, the reduced housing MLP
initialized by the reference and carried across, 3 rounds, on two legs:

* ``int8_arena`` — ``upload_codec="int8"``, ``arena_dtype="int8"``: uploads
  land quantized and the fused dequant-into-aggregate reduces them;
* ``int8_wire`` — ``upload_codec="int8"`` on the f32 arena: uploads are
  dequantized on arrival.

The two frameworks' CPU BLAS kernels sum in different orders, so a learner's
upload can differ in the last bits and an int8 code can flip by one.  The
bar for the global buffer after every round: every coordinate within one
quantization step of its group (``amax_g / 127``) plus 1e-5, and fewer than
0.1% of the coordinates beyond rtol 1e-4 / atol 1e-5.  Byte counts and
counters must agree exactly.
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
from repro.core import learner as jlearner
from repro.core import store as jstore
from repro.core.controller import Controller as JController
from repro.kernels import ops as jops
from repro.launch import train as jtrain
from repro.models import mlp as jmlp
from repro_torch.core import Driver as TDriver
from repro_torch.core import FederationEnv as TEnv
from repro_torch.core import TerminationCriteria as TTerm
from repro_torch.core import learner as tlearner
from repro_torch.core import packing as tpack
from repro_torch.core import store as tstore
from repro_torch.core.controller import Controller as TController
from repro_torch.kernels import fedavg as tfed
from repro_torch.kernels import fused_agg as tfused
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tquant
from repro_torch.launch import train as ttrain
from repro_torch.models import mlp as tmlp

P = 3000  # pads to 3072 at row_align=1024: 12 groups of 256
ROUNDS = 3


def quantized_row_from_numpy(q, scales, device="cpu"):
    """The reference's quantized row (int8 ``q``, f32 scales) as the port's."""
    return (torch.from_numpy(np.array(q, np.int8)).to(device),
            torch.from_numpy(np.array(scales, np.float32)).to(device))


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _arena_state(arena):
    return {
        "buffer": np.asarray(arena.buffer),
        "scales": _bits(arena.scales),
        "weights": np.asarray(arena.weights),
        "versions": np.asarray(arena.versions),
        "mask": np.asarray(arena.mask),
        "valid": arena._valid.copy(),
    }


def test_int8_arena_sequence_matches_reference():
    rng = np.random.default_rng(0)
    rows = (rng.normal(size=(7, P)) * 3).astype(np.float32)
    ja = jstore.ArenaStore(num_params=P, n_max=2, arena_dtype="int8")
    ta = tstore.ArenaStore(num_params=P, n_max=2, arena_dtype="int8", device="cpu")
    assert (ta.qgroup, ta.padded_params) == (ja.qgroup, ja.padded_params) == (256, 3072)
    assert ta.buffer.dtype == torch.int8 and tuple(ta.scales.shape) == (2, 12)
    for i in range(7):  # 7 learners: the arena grows 2 -> 4 -> 8
        lid = f"l{i}"
        if i % 3 == 2:  # an already-quantized row (the direct landing)
            jq, js = jops.quantize(jnp.pad(jnp.asarray(rows[i]), (0, 72)),
                                   block_rows=tquant.effective_block_rows(3072))
            tq, ts = quantized_row_from_numpy(jq, js)
            assert ta.write_quantized(lid, tq, ts, weight=10.0 + i, version=1.0) == \
                ja.write_quantized(lid, jq, js, weight=10.0 + i, version=1.0)
        else:  # an f32 row, quantized on write (pre-padded or not)
            buf = rows[i] if i % 2 else np.pad(rows[i], (0, 72))
            assert ta.write(lid, torch.from_numpy(buf), weight=10.0 + i, version=2.0) == \
                ja.write(lid, jnp.asarray(buf), weight=10.0 + i, version=2.0)
    assert ta.n_max == ja.n_max == 8 and ta.grow_events == ja.grow_events == 2
    ja.invalidate("l3")
    ta.invalidate("l3")
    js_, ts_ = _arena_state(ja), _arena_state(ta)
    for key in js_:
        np.testing.assert_array_equal(ts_[key], js_[key], err_msg=key)
    assert (ta.total_writes, ta.bytes_ingested, ta.resident_bytes()) == (
        ja.total_writes, ja.bytes_ingested, ja.resident_bytes())
    for lid in ("l0", "l2", "l5"):
        np.testing.assert_array_equal(_bits(ta.row_view(lid).numpy()),
                                      _bits(ja.row_view(lid)))
    # Row writes quantize: the stored row is within half a step of the input.
    back = ta.row_view("l1").numpy()
    step = np.abs(rows[1]).reshape(-1)[:P].max() / 127
    assert np.abs(back - rows[1]).max() <= step / 2 + 1e-6
    with pytest.raises(ValueError, match="write_quantized requires"):
        tstore.ArenaStore(num_params=P, device="cpu").write_quantized(
            "x", torch.zeros(3072, dtype=torch.int8), torch.ones(12), 1.0)
    with pytest.raises(ValueError, match="quantized row holds"):
        ta.write_quantized("x", torch.zeros(3000, dtype=torch.int8), torch.ones(12), 1.0)


def test_int8_arena_resident_bytes_shrink_like_reference():
    sizes = {}
    for dtype in ("f32", "int8"):
        ja = jstore.ArenaStore(num_params=100_000, n_max=8, arena_dtype=dtype)
        ta = tstore.ArenaStore(num_params=100_000, n_max=8, arena_dtype=dtype, device="cpu")
        assert ta.resident_bytes() == ja.resident_bytes()
        sizes[dtype] = ta.resident_bytes()
    assert 3.8 < sizes["f32"] / sizes["int8"] < 4.0


def test_controller_int8_refusals_match_reference():
    fn = lambda stack, w: stack[0]  # noqa: E731
    for kwargs in ({"store_mode": "stack"}, {"secure": True},
                   {"aggregation_rule": "median"}, {"aggregate_fn": fn},
                   {"masked_aggregate_fn": fn}):
        with pytest.raises(ValueError) as jerr:
            JController(arena_dtype="int8", **kwargs)
        with pytest.raises(ValueError) as terr:
            TController(arena_dtype="int8", device="cpu", **kwargs)
        assert str(terr.value) == str(jerr.value), kwargs
    with pytest.raises(ValueError, match="arena_dtype must be"):
        TController(arena_dtype="bf16", device="cpu")


def _update(mod, lid, envelope):
    return mod.LocalUpdate(learner_id=lid, round_id=0, params=None, num_examples=10,
                           metrics={}, seconds_per_step=0.01, buffer=None, upload=envelope)


def test_nan_upload_lands_directly_and_is_admitted_like_reference():
    """A behaviour of the reference the port keeps: a NaN group quantizes to
    scale 1.0 and q = 0 there, so the quantized norm is finite and the
    admission screen admits the upload."""
    jctrl = JController(arena_dtype="int8", upload_codec="int8")
    tctrl = TController(arena_dtype="int8", upload_codec="int8", device="cpu")
    init = np.zeros((P,), np.float32)
    jctrl.set_initial_model({"w": jnp.asarray(init)})
    tctrl.set_initial_model({"w": torch.from_numpy(init)})
    jctrl.register_learner(jtrain.build_housing_learners("100k", 1, 0)[1][0])
    tctrl.register_learner(ttrain.build_housing_learners("100k", 1, 0, device="cpu")[1][0])
    lid = "learner_000"
    row = (np.random.default_rng(3).normal(size=3072) * 2).astype(np.float32)
    row[17] = np.nan
    jctrl.ingest(_update(jlearner, lid, jctrl.channel.upload(jnp.asarray(row))))
    tctrl.ingest(_update(tlearner, lid, tctrl.channel.upload(torch.from_numpy(row))))
    for ctrl in (jctrl, tctrl):
        tel = ctrl.telemetry
        assert tel.value("engine.uploads.quantized_direct") == 1
        assert tel.value("engine.uploads.rejected.nonfinite") == 0
        assert lid in ctrl.arena
    np.testing.assert_array_equal(np.asarray(tctrl.arena.buffer), np.asarray(jctrl.arena.buffer))
    np.testing.assert_array_equal(_bits(tctrl.arena.scales), _bits(jctrl.arena.scales))
    jctrl.shutdown()
    tctrl.shutdown()


def assert_within_q8_bar(got, want, group=256, what=""):
    """Every coordinate within one quantization step of its group plus 1e-5,
    and fewer than 0.1% beyond rtol 1e-4 / atol 1e-5."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    n = want.shape[0]
    pad = (-n) % group
    amax = np.abs(np.pad(want, (0, pad))).reshape(-1, group).max(1)
    step = np.repeat(amax / 127.0, group)[:n]
    err = np.abs(got - want)
    assert (err <= step + 1e-5).all(), f"{what}: {(err - step).max()} beyond one step"
    loose = np.mean(err > 1e-5 + 1e-4 * np.abs(want))
    assert loose < 1e-3, f"{what}: {loose:.4%} of coordinates beyond rtol 1e-4 / atol 1e-5"


def _run(driver, initial, learners, rounds=ROUNDS):
    driver.initialize(initial, learners)
    buffers = []
    for _ in range(rounds):
        driver.controller.engine.run(rounds=1)
        buffers.append(np.asarray(driver.controller.global_buffer))
    driver.shutdown()
    return buffers


def _drivers(seed=0, quantize=False, **kw):
    jinit = jmlp.init_params(jax.random.key(seed), housing_mlp.reduced())
    tinit = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jinit), "cpu")
    _, jlearners = jtrain.build_housing_learners("100k", 4, seed)
    _, tlearners = ttrain.build_housing_learners("100k", 4, seed, device="cpu")
    base = dict(protocol="sync", local_steps=3, batch_size=32, learning_rate=0.01, **kw)
    jd = JDriver(JEnv(termination=JTerm(max_rounds=ROUNDS), **base))
    td = TDriver(TEnv(termination=TTerm(max_rounds=ROUNDS), device="cpu", **base))
    if quantize:
        jd.controller.channel.codec = jops.QuantCodec()
        td.controller.channel.codec = tops.QuantCodec()
    return (jd, jinit, jlearners), (td, tinit, tlearners)


_LEGS = {
    "int8_arena": dict(upload_codec="int8", arena_dtype="int8"),
    "int8_wire": dict(upload_codec="int8"),
}


@pytest.mark.parametrize("leg", sorted(_LEGS))
def test_int8_legs_match_reference(leg):
    j, t = _drivers(**_LEGS[leg])
    jbufs, tbufs = _run(*j), _run(*t)
    for r, (got, want) in enumerate(zip(tbufs, jbufs)):
        assert_within_q8_bar(got, want, what=f"{leg} round {r}")
    init = np.asarray(tpack.pack_numeric(t[1]))
    assert not np.allclose(tbufs[-1], init)  # training moved the model
    jt, tt = j[0].controller.telemetry, t[0].controller.telemetry
    direct = 4 * ROUNDS if leg == "int8_arena" else 0
    assert tt.value("engine.uploads.quantized_direct") == direct
    assert tt.value("controller.aggregations.fused_q8") == (ROUNDS if direct else 0)
    for name in ("channel.bytes_moved", "channel.upload_bytes", "channel.upload_meta_bytes",
                 "channel.upload_messages", "engine.uploads.quantized_direct",
                 "controller.aggregations.fused_q8", "store.arena.total_writes",
                 "store.arena.bytes_ingested", "store.arena.bytes_resident",
                 "engine.uploads.rejected.nonfinite", "engine.uploads.clipped"):
        assert tt.value(name) == jt.value(name), name
    n_padded = t[0].controller.arena.padded_params
    assert tt.value("channel.upload_bytes") == 4 * ROUNDS * tquant.wire_layout(n_padded)[2]
    arena = t[0].controller.arena
    assert arena.buffer.dtype == (torch.int8 if direct else torch.float32)


def test_quantize_downlink_matches_reference():
    j, t = _drivers(quantize=True)
    jbufs, tbufs = _run(*j, rounds=2), _run(*t, rounds=2)
    for r, (got, want) in enumerate(zip(tbufs, jbufs)):
        assert_within_q8_bar(got, want, what=f"downlink round {r}")
    jt, tt = j[0].controller.telemetry, t[0].controller.telemetry
    for name in ("channel.bytes_moved", "channel.messages", "channel.serializations",
                 "channel.upload_bytes", "controller.dispatch_serializations"):
        assert tt.value(name) == jt.value(name), name


def test_cpu_int8_path_never_counts_kernel_launches():
    """On host tensors ops takes the plain versions: no kernel counter moves."""
    counters = (tquant.quantize_cuda, tquant.dequantize_cuda, tfused.masked_fedavg_q8_cuda,
                tfed.masked_fedavg_cuda)
    before = [c.launches for c in counters]
    _, learners = ttrain.build_housing_learners("100k", 2, 1, device="cpu")
    init = tmlp.init_params(torch.Generator().manual_seed(1), housing_mlp.reduced(), "cpu")
    td = TDriver(TEnv(protocol="sync", local_steps=1, batch_size=8, device="cpu",
                      upload_codec="int8", arena_dtype="int8",
                      termination=TTerm(max_rounds=1)))
    td.initialize(init, learners)
    assert len(td.run()) == 1
    assert td.controller.telemetry.value("controller.aggregations.fused_q8") == 1
    assert td.controller.arena.buffer.device.type == "cpu"
    assert [c.launches for c in counters] == before
