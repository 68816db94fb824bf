"""The port's arena store and raw transport against the reference's.

The same operation sequence runs in both packages on the same numpy inputs.
Store contents, host mirrors and counters must agree exactly (a row write
moves bits); so must every wire byte count, since the wire is host bytes in
both.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import learner as jlearner
from repro.core import store as jstore
from repro.core import transport as jtransport
from repro.core.engine import UploadRejectedError as JRejected
from repro.core.controller import Controller as JController
from repro_torch.core import learner as tlearner
from repro_torch.core import store as tstore
from repro_torch.core import transport as ttransport
from repro_torch.core.controller import Controller as TController
from repro_torch.core.engine import UploadRejectedError as TRejected
from repro_torch.core.metrics import Telemetry

P = 3000  # pads to 3072 at row_align=1024


def _rows(k, seed=0):
    return np.random.default_rng(seed).normal(size=(k, P)).astype(np.float32)


def _arena_state(arena):
    return {
        "buffer": np.asarray(arena.buffer),
        "weights": np.asarray(arena.weights),
        "versions": np.asarray(arena.versions),
        "mask": np.asarray(arena.mask),
        "valid": arena._valid.copy(),
        "weights_host": arena._weights_host.copy(),
        "versions_host": arena._versions_host.copy(),
    }


def test_arena_sequence_matches_reference():
    rows = _rows(11)
    tel_j, tel_t = Telemetry(), Telemetry()
    ja = jstore.ArenaStore(num_params=P, n_max=8, telemetry=None)
    ta = tstore.ArenaStore(num_params=P, n_max=8, device="cpu", telemetry=tel_t)
    assert ta.padded_params == ja.padded_params == 3072
    ids = [f"l{i}" for i in range(11)]
    for lid in ids[:3]:  # registration order fixes rows before any upload
        assert ta.ensure_row(lid) == ja.ensure_row(lid)
    for i, lid in enumerate(ids):  # 11 learners: the arena grows 8 -> 16
        buf = rows[i] if i % 2 else np.pad(rows[i], (0, 72))  # pre-padded or not
        jr = ja.write(lid, jnp.asarray(buf), weight=float(10 + i), version=float(i % 3))
        tr = ta.write(lid, torch.from_numpy(buf), weight=float(10 + i), version=float(i % 3))
        assert tr == jr
    assert ta.n_max == ja.n_max == 16 and ta.grow_events == ja.grow_events == 1
    ja.invalidate("l4")
    ta.invalidate("l4")
    ja.write("l2", jnp.asarray(rows[0]), weight=99.0, version=5.0)  # overwrite in place
    ta.write("l2", torch.from_numpy(rows[0]), weight=99.0, version=5.0)
    js, ts = _arena_state(ja), _arena_state(ta)
    for key in js:
        np.testing.assert_array_equal(ts[key], js[key], err_msg=key)
    for sel in (None, ["l0", "l4", "l7", "nobody"], ids[5:]):
        np.testing.assert_array_equal(np.asarray(ta.round_mask(sel)),
                                      np.asarray(ja.round_mask(sel)))
        assert ta.num_valid(sel) == ja.num_valid(sel)
    assert ta.valid_ids() == ja.valid_ids()
    assert (ta.total_writes, ta.bytes_ingested, ta.resident_bytes()) == (
        ja.total_writes, ja.bytes_ingested, ja.resident_bytes())
    np.testing.assert_array_equal(ta.row_view("l9").numpy(), np.asarray(ja.row_view("l9")))


def test_arena_refuses_later_slices():
    with pytest.raises(NotImplementedError, match="slice F"):
        tstore.ArenaStore(num_params=P, arena_dtype="topk", device="cpu")
    with pytest.raises(NotImplementedError, match="slice G"):
        tstore.ArenaStore(num_params=P, mesh=object(), device="cpu")


def test_raw_channel_bytes_and_stats_match_reference():
    rows = _rows(3, seed=1)
    jc = jtransport.Channel(bandwidth_gbps=2.0, latency_ms=0.3)
    tc = ttransport.Channel(bandwidth_gbps=2.0, latency_ms=0.3, device="cpu")
    for c in (jc, tc):
        c.set_learner_bandwidth("l1", 0.5)
    params = {"w": rows[0][:2000].reshape(40, 50), "b": rows[1][:7]}
    jb = jc.broadcast({k: jnp.asarray(v) for k, v in params.items()})
    tb = tc.broadcast({k: torch.from_numpy(v) for k, v in params.items()})
    assert tb.buffer.tobytes() == jb.buffer.tobytes()
    for lid in ("l0", "l1", "l2"):
        je, te = jb.to({"learner_id": lid}), tb.to({"learner_id": lid})
        np.testing.assert_array_equal(tc.recv(te)["w"].numpy(), np.asarray(jc.recv(je)["w"]))
    for i, lid in enumerate(("l0", "l1", "l2")):
        md = {"learner_id": lid, "round_id": 4}
        je = jc.upload(jnp.asarray(rows[i]), metadata=md)
        te = tc.upload(torch.from_numpy(rows[i]), metadata=md)
        assert te.payload.tobytes() == je.payload.tobytes()
        assert (te.meta_nbytes, te.wire_nbytes) == (je.meta_nbytes, je.wire_nbytes)
        jrow, jnorm = jc.recv_upload(je, with_norm=True)
        trow, tnorm = tc.recv_upload(te, with_norm=True)
        np.testing.assert_array_equal(trow.numpy(), np.asarray(jrow))
        np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    exact = ("messages", "bytes_moved", "serializations", "upload_messages",
             "upload_bytes", "upload_meta_bytes", "upload_serializations")
    for field in exact:
        assert getattr(tc.stats, field) == getattr(jc.stats, field), field
    for field in ("virtual_wire_s", "upload_virtual_wire_s"):
        assert getattr(tc.stats, field) == pytest.approx(getattr(jc.stats, field), rel=1e-12)
    assert tc.round_trip_s(1000, 4000, "l1") == jc.round_trip_s(1000, 4000, "l1")
    assert tc.stats.upload_bytes == 3 * 4 * P


def test_later_codecs_refused():
    assert isinstance(ttransport.get_upload_codec("int8"), ttransport.Int8UploadCodec)
    with pytest.raises(NotImplementedError, match="slice F"):
        ttransport.get_upload_codec("topk")


def _update(mod, lid, buffer, upload=None):
    return mod.LocalUpdate(learner_id=lid, round_id=0, params=None, num_examples=10,
                           metrics={}, seconds_per_step=0.01, buffer=buffer,
                           upload=upload)


def test_admission_screen_rejects_nan_row_in_both():
    params = {"w": np.zeros((P,), np.float32)}
    jctrl = JController()
    tctrl = TController(device="cpu")
    jctrl.set_initial_model({"w": jnp.asarray(params["w"])})
    tctrl.set_initial_model({"w": torch.from_numpy(params["w"])})
    bad = _rows(1, seed=2)[0]
    bad[17] = np.nan
    pad = tctrl.arena.padded_params
    with pytest.raises(JRejected):
        jctrl.ingest(_update(jlearner, "x", jnp.asarray(np.pad(bad, (0, pad - P)))))
    with pytest.raises(TRejected):
        tctrl.ingest(_update(tlearner, "x", torch.from_numpy(np.pad(bad, (0, pad - P)))))
    for ctrl in (jctrl, tctrl):
        assert ctrl.telemetry.value("engine.uploads.rejected.nonfinite") == 1
        assert ctrl.arena.num_valid() == 0 and "x" not in ctrl.arena
    # The rejected row still crossed the measured uplink in both.
    assert tctrl.telemetry.value("channel.upload_bytes") == jctrl.telemetry.value(
        "channel.upload_bytes") == 4 * pad
    jctrl.shutdown()
    tctrl.shutdown()


def test_controller_refuses_later_slices():
    for kwargs, slice_name in (({"secure": True}, "slice E"),
                               ({"upload_codec": "topk"}, "slice F"),
                               ({"arena_mesh": object()}, "slice G"),
                               ({"checkpoint_every": 1}, "slice B")):
        with pytest.raises(NotImplementedError, match=slice_name):
            TController(device="cpu", **kwargs)
    # Slice D is ported: the robust rules construct.
    for rule in ("median", "trimmed_mean"):
        assert TController(device="cpu", aggregation_rule=rule).aggregation_rule == rule
