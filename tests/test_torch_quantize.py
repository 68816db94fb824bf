"""The port's int8 kernels and codecs against the reference's.

On the CPU the port's ``kernels/ops`` runs the plain torch versions; they
are held against the reference's Pallas kernels (``repro.kernels.ops``,
interpret mode on the CPU, as ``tests/test_kernels.py`` runs them) on the
same numpy inputs.  Bars:

* quantize's ``q`` and scales, dequantize's output and every int8 wire
  payload: bit-identical (the wire carries those bytes), including NaN,
  ±inf, all-zero and subnormal groups;
* the fused dequant-into-aggregate: rtol = atol = 2e-5 against the
  reference's f64 oracle, its Pallas kernel and its jnp rule, as in
  ``tests/test_kernels.py``;
* admission norms: rtol 1e-6 (summation order differs).

The hand-written kernels themselves run only on the card
(``tests/test_torch_cuda.py``, ``cuda`` marker).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregation as jagg
from repro.core import packing as jpack
from repro.core import transport as jtransport
from repro.kernels import ops as jops
from repro.kernels import quantize as jquant
from repro.kernels import ref as jref
from repro_torch.core import aggregation as tagg
from repro_torch.core import packing as tpack
from repro_torch.core import transport as ttransport
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tquant
from repro_torch.kernels import ref as tref


def _bits(a) -> np.ndarray:
    """A float32 array's raw bits (so NaN == NaN and -0 != 0)."""
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _close(got, want, tol=2e-5):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=tol, atol=tol)


def _special(size, group, seed):
    """Normal data plus groups of NaN, ±inf, zeros, subnormals and tiny scales."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=size) * 5).astype(np.float32)
    g = lambda k: slice(k * group, (k + 1) * group)  # noqa: E731
    x[g(0)] = 0.0
    x[g(1)] = (rng.normal(size=group) * 1e-39).astype(np.float32)  # subnormal
    x[g(2).start + 3] = np.nan
    x[g(3).start + 5] = np.inf
    x[g(4).start + 7] = -np.inf
    x[g(5)] = (rng.normal(size=group) * 1e-37).astype(np.float32)  # subnormal scale
    x[g(6)] = (rng.normal(size=group) * 1e30).astype(np.float32)
    x[g(7).start] = np.nan
    x[g(7).start + 1] = np.inf
    return x


@pytest.mark.parametrize("block_rows", [64, 8])
@pytest.mark.parametrize("group", [256, 512])
def test_layout_helpers_match_reference(group, block_rows):
    sizes = [1, 2, 255, 256, 257, 4095, 16384, 16385, 65537, 100_000,
             10_174_081, 10_174_464] + list(range(1, 200_000, 4_321))
    for n in sizes:
        assert tquant.effective_block_rows(n, group, block_rows) == \
            jquant.effective_block_rows(n, group, block_rows), n
        assert tquant.wire_layout(n, group, block_rows) == \
            jquant.wire_layout(n, group, block_rows), n
        assert tquant.scales_padding(n, group, block_rows) == \
            jquant.scales_padding(n, group, block_rows), n
    assert (tquant.DEFAULT_GROUP, tquant.DEFAULT_BLOCK_ROWS) == (
        jquant.DEFAULT_GROUP, jquant.DEFAULT_BLOCK_ROWS)


@pytest.mark.parametrize("group", [256, 512])
@pytest.mark.parametrize("size", [16384, 65537, 100_000])
def test_quantize_bit_identical_to_reference(size, group):
    x = (np.random.default_rng(size).normal(size=size) * 5).astype(np.float32)
    jq, js = jops.quantize(jnp.asarray(x), group=group)
    tq, ts = tops.quantize(torch.from_numpy(x), group=group)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))


@pytest.mark.parametrize("group", [256, 512])
def test_quantize_nonfinite_and_subnormal_groups_match_reference(group):
    x = _special(group * 64, group, seed=group)
    jq, js = jops.quantize(jnp.asarray(x), group=group)
    tq, ts = tops.quantize(torch.from_numpy(x), group=group)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    # The reference's behaviour the port reproduces (ROADMAP.md, queue 3).
    s = ts.numpy()
    assert s[0] == 1.0 and s[1] == 1.0  # all-zero and subnormal groups
    assert s[2] == 1.0 and s[7] == 1.0  # a NaN group gets scale 1.0
    assert np.isinf(s[3]) and np.isinf(s[4])  # an inf group gets scale inf
    assert s[5] == 0.0  # a subnormal scale flushes to 0
    q = tq.numpy().reshape(-1, group)
    assert (q[[0, 1, 3, 4]] == 0).all() and q[2, 3] == 0 and q[7, 0] == 0


@pytest.mark.parametrize("group", [256, 512])
def test_dequantize_bit_identical_to_reference(group):
    x = _special(group * 64 * 2, group, seed=7)
    jq, js = jops.quantize(jnp.asarray(x), group=group)
    n = x.size - 100
    want = jops.dequantize(jq, js, n, group=group)
    tq, ts = torch.from_numpy(np.array(jq)), torch.from_numpy(np.array(js))
    got = tops.dequantize(tq, ts, n, group=group)
    assert got.shape == (n,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(tquant.dequantize_torch(tq, ts, group)[:n]),
                                  _bits(jref.dequantize_ref(jq, js, group)[:n]))


def test_ops_shape_errors():
    with pytest.raises(ValueError, match="group\\*block_rows"):
        tops.dequantize(torch.zeros(1000, dtype=torch.int8), torch.ones(4), 1000)
    with pytest.raises(ValueError, match="scales_padding"):
        tops.dequantize(torch.zeros(16384, dtype=torch.int8), torch.ones(63), 16384)
    with pytest.raises(ValueError, match="multiple of 8"):
        tquant.quantize_torch(torch.zeros(300), group=12)
    q = torch.zeros((3, 2048), dtype=torch.int8)
    with pytest.raises(ValueError, match="scales shape"):
        tops.masked_fedavg_q8(q, torch.ones((3, 7)), torch.ones(3), torch.ones(3))


@pytest.mark.parametrize("n", [1, 255, 257, 65_537, 100_000, 100_225])
def test_quantize_writes_the_wire_layout(n):
    """``ops.quantize`` returns ``q`` and the scales as views of one buffer
    laid out as the int8 wire, whose prefix is the reference's wire; the
    whole buffer is the reference's ``q`` then all its scales."""
    x = (np.random.default_rng(n).normal(size=n) * 2).astype(np.float32)
    n_padded, n_scales, nbytes = tquant.wire_layout(n)
    q, s = tops.quantize(torch.from_numpy(x), block_rows=tquant.effective_block_rows(n))
    assert q.shape == (n_padded,) and s.shape == (n_padded // tquant.DEFAULT_GROUP,)
    assert q.untyped_storage().data_ptr() == s.untyped_storage().data_ptr()
    assert s.data_ptr() == q.data_ptr() + n_padded
    wire = tquant.wire_prefix(q, s, n_scales)
    assert wire.dtype == torch.uint8 and wire.shape == (nbytes,)
    je = jtransport.Channel(upload_codec="int8").upload(jnp.asarray(x))
    assert wire.numpy().tobytes() == je.payload.tobytes()
    jq, js = jops.quantize(jnp.asarray(x))
    tq, ts = tops.quantize(torch.from_numpy(x))
    whole = tquant.wire_prefix(tq, ts, ts.shape[0]).numpy().tobytes()
    assert whole == np.asarray(jq).tobytes() + np.asarray(js).tobytes()


def test_wire_prefix_refuses_separate_buffers():
    q = torch.zeros(256, dtype=torch.int8)
    with pytest.raises(ValueError, match="not one wire buffer"):
        tquant.wire_prefix(q, torch.ones(1), 1)
    q, s = tquant.quantize_torch(torch.ones(300), n_padded=512)
    with pytest.raises(ValueError, match="not one wire buffer"):
        tquant.wire_prefix(q, s, 3)
    with pytest.raises(ValueError, match="cannot pad 300 elements to 256"):
        tquant.quantize_torch(torch.ones(300), n_padded=256)


@pytest.mark.parametrize("n", [1, 255, 257, 65_537, 100_000])
def test_int8_codec_wire_bytes_match_reference(n):
    rng = np.random.default_rng(n)
    x = (rng.normal(size=n) * 2).astype(np.float32)
    x[n // 2] = np.nan if n > 300 else x[n // 2]
    jc = jtransport.Channel(upload_codec="int8")
    tc = ttransport.Channel(upload_codec="int8", device="cpu")
    md = {"learner_id": "l0", "round_id": 2}
    je = jc.upload(jnp.asarray(x), metadata=md)
    te = tc.upload(torch.from_numpy(x), metadata=md)
    assert te.payload.tobytes() == je.payload.tobytes()
    assert te.payload.nbytes == tquant.wire_layout(n)[2]
    assert (te.codec, te.codec_params, te.meta_nbytes) == (je.codec, je.codec_params,
                                                           je.meta_nbytes)
    for field in ("upload_bytes", "upload_meta_bytes", "upload_messages"):
        assert getattr(tc.stats, field) == getattr(jc.stats, field), field
    assert tc.upload_codec.wire_nbytes(n) == jc.upload_codec.wire_nbytes(n)


@pytest.mark.parametrize("n", [257, 65_537, 100_000])
def test_int8_decode_paths_match_reference(n):
    x = (np.random.default_rng(n + 1).normal(size=n) * 3).astype(np.float32)
    jc = jtransport.Channel(upload_codec="int8")
    tc = ttransport.Channel(upload_codec="int8", device="cpu")
    je, te = jc.upload(jnp.asarray(x)), tc.upload(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(tc.recv_upload(te).numpy()),
                                  _bits(jc.recv_upload(je)))
    (jrow, jnorm), (trow, tnorm) = jc.recv_upload(je, with_norm=True), tc.recv_upload(
        te, with_norm=True)
    np.testing.assert_array_equal(_bits(trow.numpy()), _bits(jrow))
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    out = (n // 256) * 256  # a whole number of groups, at most the padded count
    jq, js, jn = jc.recv_upload_quantized(je, out)
    tq, ts, tn = tc.recv_upload_quantized(te, out)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    with pytest.raises(ValueError, match="multiple of group"):
        tc.recv_upload_quantized(te, out + 1)
    with pytest.raises(ValueError, match="int8 payload holds"):
        tc.upload_codec.decode(te.payload[:-4], n, torch.device("cpu"))
    raw = ttransport.Channel(device="cpu").upload(torch.from_numpy(x))
    with pytest.raises(ValueError, match="cannot land quantized rows"):
        tc.recv_upload_quantized(raw, out)


def _q8_inputs(n, p, group, seed):
    rng = np.random.default_rng(seed)
    q = rng.integers(-127, 128, size=(n, p), dtype=np.int8)
    s = rng.uniform(0.01, 5.0, size=(n, p // group)).astype(np.float32)
    w = rng.uniform(1, 50, size=n).astype(np.float32)
    mask = (np.arange(n) % 3 != 1).astype(np.float32)
    return q, s, w, mask


def _q8_both(q, s, w, mask, group):
    """The port's ops and rule, and the reference's oracle, kernel and rule."""
    t = [torch.from_numpy(a) for a in (q, s, w, mask)]
    j = [jnp.asarray(a) for a in (q, s, w, mask)]
    return (
        [tops.masked_fedavg_q8(*t, group=group).numpy(),
         tagg.masked_fedavg_q8(*t, group=group).numpy()],
        [jref.masked_fedavg_q8_ref(*j, group=group), jops.masked_fedavg_q8(*j, group=group),
         jagg.masked_fedavg_q8(*j, group=group),
         tref.masked_fedavg_q8_f64(q, s, w, mask, group)],
    )


@pytest.mark.parametrize("n,p,group", [(1, 4096, 256), (3, 4096, 256), (8, 16384, 256),
                                       (33, 8192, 256), (4, 4096, 512), (3, 2304, 256)])
def test_masked_fedavg_q8_matches_reference(n, p, group):
    q, s, w, mask = _q8_inputs(n, p, group, seed=n + p)
    gots, wants = _q8_both(q, s, w, mask, group)
    for got in gots:
        assert got.shape == (p,)
        for want in wants:
            _close(got, want)


def test_masked_fedavg_q8_dead_rows_zero_weights_and_empty_mask():
    q, s, _, _ = _q8_inputs(5, 2048, 256, seed=11)
    q[2] = 127
    s[2] = 1e30
    s[4] = np.nan
    mask = np.array([1, 1, 0, 1, 0], np.float32)
    gots, wants = _q8_both(q, s, np.ones(5, np.float32), mask, 256)
    for got in gots:
        assert np.isfinite(got).all()
        for want in wants:
            _close(got, want)
    # Zero weights: uniform over the valid rows.
    gots, wants = _q8_both(q, s, np.zeros(5, np.float32), mask, 256)
    for got in gots:
        for want in wants:
            _close(got, want)
    # The empty mask gives zeros.
    gots, _ = _q8_both(q, s, np.ones(5, np.float32), np.zeros(5, np.float32), 256)
    for got in gots:
        assert (got == 0).all()


def test_masked_staleness_q8_matches_reference():
    n, p = 6, 4096
    q, s, w, mask = _q8_inputs(n, p, 256, seed=5)
    versions = np.array([3, 0, 1, 3, 2, 1], np.float32)
    got = tagg.masked_staleness_q8(torch.from_numpy(q), torch.from_numpy(s),
                                   torch.from_numpy(w), torch.from_numpy(versions), 3.0,
                                   torch.from_numpy(mask), alpha=0.5).numpy()
    want = jagg.masked_staleness_q8(jnp.asarray(q), jnp.asarray(s), jnp.asarray(w),
                                    jnp.asarray(versions), 3.0, jnp.asarray(mask), alpha=0.5)
    _close(got, want)
    # The same staleness weights through the f64 oracle.
    stal = 3.0 - versions.astype(np.float64)
    _close(got, tref.masked_fedavg_q8_f64(q, s, w * (1.0 + stal) ** -0.5, mask))


def _mixed_tree(rng):
    w = (rng.normal(size=(33, 57)) * 2).astype(np.float32)
    b = rng.normal(size=(129,)).astype(np.float32)
    return w, b


def test_quant_codec_roundtrip_and_downlink_bytes_match_reference():
    import ml_dtypes

    w, b = _mixed_tree(np.random.default_rng(0))
    w_bf16 = w.astype(ml_dtypes.bfloat16)
    jtree = {"w": jnp.asarray(w_bf16), "b": jnp.asarray(b), "step": jnp.asarray(7, jnp.int32)}
    ttree = tpack.tree_from_numpy({"w": w_bf16, "b": b, "step": np.asarray(7, np.int32)})
    jenc, tenc = jops.QuantCodec.encode(jtree), tops.QuantCodec.encode(ttree)
    jbuf, jman = jpack.pack_bytes(jenc)
    tbuf, tman = tpack.pack_bytes(tenc)
    assert tbuf.tobytes() == jbuf.tobytes()
    assert [(s.name, s.dtype, s.shape) for s in tman.specs] == [
        (s.name, s.dtype, s.shape) for s in jman.specs]
    dec = tops.QuantCodec.decode(tenc)
    jdec = jops.QuantCodec.decode(jenc)
    assert dec["w"].shape == (33, 57) and dec["w"].dtype == torch.bfloat16
    assert dec["b"].dtype == torch.float32 and int(dec["step"]) == 7
    np.testing.assert_array_equal(_bits(dec["b"].numpy()), _bits(jdec["b"]))
    np.testing.assert_array_equal(dec["w"].float().numpy(), np.asarray(jdec["w"], np.float32))
    assert np.abs(dec["b"].numpy() - b).max() < np.abs(b).max() / 100
    # Through a channel: the downlink's byte counts equal the reference's.
    jc = jtransport.Channel(quantize_codec=jops.QuantCodec())
    tc = ttransport.Channel(quantize_codec=tops.QuantCodec(), device="cpu")
    jb, tb = jc.broadcast(jtree), tc.broadcast(ttree)
    assert tb.buffer.tobytes() == jb.buffer.tobytes()
    te, je = tb.to({"learner_id": "l0"}), jb.to({"learner_id": "l0"})
    np.testing.assert_array_equal(_bits(tc.recv(te)["b"].numpy()), _bits(jc.recv(je)["b"]))
    js, ts = jc.send(jtree), tc.send(ttree)
    assert ts.buffer.tobytes() == js.buffer.tobytes()
    for field in ("messages", "bytes_moved", "serializations"):
        assert getattr(tc.stats, field) == getattr(jc.stats, field), field
