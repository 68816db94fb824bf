"""The port's sparse reduce and sparse arena against the reference's.

``scatter_accumulate``, ``masked_fedavg_topk`` and ``masked_staleness_topk``
run in both packages on the same seeded ``(N, k)`` arenas, dead rows holding
NaN and out-of-range indices.  Given the same normalized weights the
scatter must equal the reference bit for bit (both sum each column in row
order), and so must ``masked_fedavg_topk`` on integer example counts (their
sum is exact).  Where the weights are normalized from arbitrary floats or
staleness-damped (``(1 + s)^-alpha``), the two frameworks may round the
weights' sum or power differently in the last bit, which moves a column by
up to ``2^-23 · Σ_i |ŵ_i v_i|`` (about 1e-6 for these values, whose
magnitudes reach 8), so the bar is rtol 1e-6 / atol 1e-6 against the
reference.  Every result is within rtol 2e-5 / atol
2e-5 of an f64 numpy oracle, the reference's own bar in
``tests/test_sparse_props.py``.
``ArenaStore(arena_dtype="topk")`` runs one operation sequence in both:
``write_sparse`` and its refusals, growth, ``row_view``, the byte counters
and ``export_state``/``restore_state`` must agree exactly.  The norm that
``Channel.recv_upload_sparse`` returns equals the densified row's norm.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import aggregation as jagg
from repro.core import store as jstore
from repro.core import transport as jtransport
from repro.kernels import sparse_agg as jsparse
from repro_torch.core import aggregation as tagg
from repro_torch.core import store as tstore
from repro_torch.core import transport as ttransport
from repro_torch.kernels import sparse_agg as tsparse
from repro_torch.kernels import topk as ttopk

P = 3000  # pads to 3072 at row_align=1024


def sparse_arena(n: int, k: int, width: int, seed: int, dead_garbage: bool = True):
    """A seeded ``(n, k)`` arena: unique indices per row, about 30% dead rows
    (NaN values and, if ``dead_garbage``, indices past ``width``)."""
    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(width, size=k, replace=False) for _ in range(n)]).astype(np.int32)
    val = (rng.normal(size=(n, k)) * 2).astype(np.float32)
    w = rng.uniform(0.5, 20.0, size=n).astype(np.float32)
    mask = (rng.uniform(size=n) < 0.7).astype(np.float32)
    if not mask.any():
        mask[0] = 1.0
    val[mask == 0] = np.nan
    if dead_garbage:
        idx[mask == 0] = width + 12345
    versions = rng.integers(0, 5, size=n).astype(np.float32)
    return idx, val, w, mask, versions


def f64_reduce(idx, val, w, mask, width) -> np.ndarray:
    """Densify each live row in f64, weight and sum."""
    out = np.zeros(width, np.float64)
    for r in range(idx.shape[0]):
        if mask[r] > 0:
            dense = np.zeros(width, np.float64)
            np.add.at(dense, idx[r], val[r].astype(np.float64))
            out += float(w[r]) * dense
    return out


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


CASES = [(1, 1, 16), (3, 8, 64), (9, 48, 600), (32, 100, 3072), (40, 512, 1024)]


@pytest.mark.parametrize("n,k,width", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_accumulate_bit_identical_and_near_f64(n, k, width, seed):
    idx, val, w, mask, _ = sparse_arena(n, k, width, seed)
    wn = np.asarray(jagg.masked_normalize(jnp.asarray(w), jnp.asarray(mask)))
    got = tsparse.scatter_accumulate(*_t(idx, val, wn, mask), width)
    want = np.asarray(jsparse.scatter_accumulate(*_j(idx, val, wn, mask), width))
    assert got.dtype == torch.float32 and tuple(got.shape) == (width,)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), f64_reduce(idx, val, wn, mask, width),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,k,width", CASES)
@pytest.mark.parametrize("counts", [True, False], ids=["example_counts", "float_weights"])
def test_masked_fedavg_topk_matches_reference(n, k, width, counts):
    idx, val, w, mask, _ = sparse_arena(n, k, width, 7)
    if counts:
        w = np.round(w * 10)
    got = tagg.masked_fedavg_topk(*_t(idx, val, w, mask), width).numpy()
    want = np.asarray(jagg.masked_fedavg_topk(*_j(idx, val, w, mask), width))
    if counts:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    wn = w * mask / (w * mask).sum()
    np.testing.assert_allclose(got, f64_reduce(idx, val, wn, mask, width), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("n,k,width", CASES)
@pytest.mark.parametrize("alpha", [0.5, 1.0])
def test_masked_staleness_topk_matches_reference(n, k, width, alpha):
    idx, val, w, mask, versions = sparse_arena(n, k, width, 11)
    got = tagg.masked_staleness_topk(*_t(idx, val, w, versions), 5.0,
                                     torch.from_numpy(mask), width, alpha).numpy()
    want = np.asarray(jagg.masked_staleness_topk(*_j(idx, val, w, versions), jnp.float32(5.0),
                                                 jnp.asarray(mask), width, alpha))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    sw = w * (1.0 + np.maximum(5.0 - versions, 0.0)) ** (-alpha) * mask
    np.testing.assert_allclose(got, f64_reduce(idx, val, sw / sw.sum(), mask, width),
                               rtol=2e-5, atol=2e-5)


def test_empty_mask_gives_zeros():
    idx, val, w, _, _ = sparse_arena(4, 8, 64, 3, dead_garbage=False)
    mask = np.zeros(4, np.float32)
    got = tagg.masked_fedavg_topk(*_t(idx, val, w, mask), 64).numpy()
    want = np.asarray(jagg.masked_fedavg_topk(*_j(idx, val, w, mask), 64))
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert not got.any()


# -- the sparse arena ---------------------------------------------------------


def _sparse_row(k, seed, width=3072):
    rng = np.random.default_rng(seed)
    return (rng.permutation(width)[:k].astype(np.int32),
            (rng.normal(size=k) * 3).astype(np.float32))


def _state(arena):
    return {"buffer": np.asarray(arena.buffer), "indices": np.asarray(arena.indices),
            "weights": np.asarray(arena.weights), "versions": np.asarray(arena.versions),
            "mask": np.asarray(arena.mask), "valid": arena._valid.copy()}


def test_sparse_arena_sequence_matches_reference():
    k = 48
    ja = jstore.ArenaStore(num_params=P, n_max=2, arena_dtype="topk", sparse_k=k)
    ta = tstore.ArenaStore(num_params=P, n_max=2, arena_dtype="topk", sparse_k=k, device="cpu")
    assert (ta.padded_params, ta.sparse_k) == (ja.padded_params, ja.sparse_k) == (3072, k)
    assert ta.buffer.dtype == torch.float32 and ta.indices.dtype == torch.int32
    for i in range(7):  # 7 learners: the arena grows 2 -> 4 -> 8
        idx, val = _sparse_row(k, i)
        jr = ja.write_sparse(f"l{i}", jnp.asarray(idx), jnp.asarray(val), 10.0 + i, i % 3)
        tr = ta.write_sparse(f"l{i}", *_t(idx, val), 10.0 + i, i % 3)
        assert tr == jr
    idx, val = _sparse_row(k, 99)  # overwrite in place
    ja.write_sparse("l2", jnp.asarray(idx), jnp.asarray(val), 99.0, 5.0)
    ta.write_sparse("l2", *_t(idx, val), 99.0, 5.0)
    ja.invalidate("l4")
    ta.invalidate("l4")
    assert ta.n_max == ja.n_max == 8 and ta.grow_events == ja.grow_events == 2
    js, ts = _state(ja), _state(ta)
    for key in js:
        np.testing.assert_array_equal(ts[key], js[key], err_msg=key)
    assert (ta.total_writes, ta.bytes_ingested, ta.resident_bytes()) == (
        ja.total_writes, ja.bytes_ingested, ja.resident_bytes())
    assert ta._telemetry.value("store.arena.bytes_resident") == ta.resident_bytes()
    for lid in ("l0", "l2", "l6"):
        got = ta.row_view(lid).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      np.asarray(ja.row_view(lid)).view(np.uint32))
        assert got.shape == (P,)
    with pytest.raises(KeyError):
        ta.row_view("l4")


def test_sparse_arena_refusals_match_reference():
    k = 16
    for mod, dev in ((jstore, {}), (tstore, {"device": "cpu"})):
        with pytest.raises(ValueError, match="needs sparse_k"):
            mod.ArenaStore(num_params=P, arena_dtype="topk", **dev)
        with pytest.raises(ValueError, match="'f32', 'int8' or 'topk'"):
            mod.ArenaStore(num_params=P, arena_dtype="bf16", **dev)
    ta = tstore.ArenaStore(num_params=P, arena_dtype="topk", sparse_k=k, device="cpu")
    idx, val = _sparse_row(k, 0)
    with pytest.raises(ValueError, match="no dense rows"):
        ta.write("x", torch.zeros(P), 1.0)
    with pytest.raises(ValueError, match="must be int32"):
        ta.write_sparse("x", torch.from_numpy(idx.astype(np.int64)), torch.from_numpy(val), 1.0)
    with pytest.raises(ValueError, match="sparse row holds"):
        ta.write_sparse("x", *_t(idx[:-1], val[:-1]), 1.0)
    with pytest.raises(ValueError, match="write_sparse requires"):
        tstore.ArenaStore(num_params=P, device="cpu").write_sparse("x", *_t(idx, val), 1.0)
    assert ta.num_valid() == 0
    # k clamps to the padded row width, as the wire codec clamps it.
    big = tstore.ArenaStore(num_params=P, arena_dtype="topk", sparse_k=10**6, device="cpu")
    assert big.sparse_k == jstore.ArenaStore(num_params=P, arena_dtype="topk",
                                             sparse_k=10**6).sparse_k == 3072


def test_sparse_arena_checkpoint_round_trip():
    k = 32
    ja = jstore.ArenaStore(num_params=P, n_max=4, arena_dtype="topk", sparse_k=k)
    ta = tstore.ArenaStore(num_params=P, n_max=4, arena_dtype="topk", sparse_k=k, device="cpu")
    for i in range(3):
        idx, val = _sparse_row(k, 20 + i)
        ja.write_sparse(f"l{i}", jnp.asarray(idx), jnp.asarray(val), 5.0 + i, 1.0)
        ta.write_sparse(f"l{i}", *_t(idx, val), 5.0 + i, 1.0)
    js, ts = ja.export_state(), ta.export_state()
    assert set(ts) == set(js) and "indices" in ts and "scales" not in ts
    for key in ("buffer", "indices", "weights", "versions", "valid"):
        np.testing.assert_array_equal(ts[key], js[key], err_msg=key)
    assert ts["rows"] == js["rows"]
    fresh = tstore.ArenaStore(num_params=P, n_max=2, arena_dtype="topk", sparse_k=k, device="cpu")
    fresh.restore_state(**ts)
    for key, v in _state(ta).items():
        np.testing.assert_array_equal(_state(fresh)[key], v, err_msg=key)
    np.testing.assert_array_equal(fresh.row_view("l1").numpy(), ta.row_view("l1").numpy())
    with pytest.raises(ValueError, match="needs the checkpointed indices"):
        fresh.restore_state(**{**ts, "indices": None})
    with pytest.raises(ValueError, match="sparse indices have shape"):
        fresh.restore_state(**{**ts, "indices": ts["indices"][:, :5]})
    with pytest.raises(ValueError, match="rows hold"):
        tstore.ArenaStore(num_params=P, arena_dtype="topk", sparse_k=k + 1,
                          device="cpu").restore_state(**ts)


def test_sparse_arena_resident_bytes_32x_below_f32():
    n, p = 32, 64 * 1024
    dense = tstore.ArenaStore(num_params=p, n_max=n, device="cpu").resident_bytes()
    sparse = tstore.ArenaStore(num_params=p, n_max=n, arena_dtype="topk", sparse_k=p // 64,
                               device="cpu").resident_bytes()
    assert sparse == jstore.ArenaStore(num_params=p, n_max=n, arena_dtype="topk",
                                       sparse_k=p // 64).resident_bytes()
    assert 31.5 < dense / sparse < 32.0


@given(st.integers(1, 64), st.integers(0, 2**31 - 1), st.sampled_from(("f32", "int8")))
@settings(max_examples=25, deadline=None)
def test_sparse_norm_equals_dense_row_norm(k, seed, value_dtype):
    """recv_upload_sparse's norm == the L2 norm of the densified row, and the
    decoded stream equals the reference's."""
    row = np.random.default_rng(seed).normal(size=(128,)).astype(np.float32)
    tc = ttransport.Channel(upload_codec=ttransport.TopkUploadCodec(k=k, value_dtype=value_dtype),
                            device="cpu")
    env = tc.upload(torch.from_numpy(row))
    idx, val, norm = tc.recv_upload_sparse(env)
    dense = ttopk.densify(idx, val, 128)
    np.testing.assert_allclose(float(norm), float(torch.linalg.vector_norm(dense)), rtol=1e-6)
    jc = jtransport.Channel(upload_codec=jtransport.TopkUploadCodec(k=k, value_dtype=value_dtype))
    jidx, jval, jnorm = jc.recv_upload_sparse(jc.upload(jnp.asarray(row)))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(jval))
    np.testing.assert_allclose(float(norm), float(jnorm), rtol=1e-6)
    assert tc.stats.upload_bytes == jc.stats.upload_bytes


def test_recv_upload_sparse_refuses_dense_codecs():
    ch = ttransport.Channel(device="cpu")
    env = ch.upload(torch.zeros(64))
    with pytest.raises(ValueError, match="cannot land sparse rows"):
        ch.recv_upload_sparse(env)


def test_sharded_scatter_is_a_later_slice():
    # The sharded scatter is ported (tests/test_torch_sharded.py): it refuses,
    # as the reference's does, an output that the slots do not divide.
    from repro_torch.launch.mesh import make_controller_mesh

    with pytest.raises(ValueError, match="out_width 1022 not divisible by 4 shards"):
        tsparse.scatter_accumulate_sharded(make_controller_mesh(4, "cpu"), "data", 1022)
