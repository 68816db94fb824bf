"""The port's top-k kernels module and codec against the reference's, bit for bit.

Every function of ``kernels/topk.py`` runs in both packages on the same
numpy inputs: the selected indices and their order under ties, ±0, NaN of
either sign and payload, and ±inf; the f32 and int8 wire bytes (a NaN value
encodes to 0 in both); ``quantize_values`` codes and scales,
``dequantize_values``, ``densify`` (``-0.0`` lands as ``+0.0``),
``ef_residual``, ``effective_k`` and ``wire_layout_topk``.  All must be the
same bits, with one exception: where ``ef_residual`` subtracts from a NaN,
the NaN's sign bit is XLA's choice of instruction (it subtracts for one
coordinate and adds the negation for more), so NaN positions are compared
as NaN.

The reference's property tests of ``tests/test_sparse_props.py`` for the
codec (round trip, conservation of update mass, permutation equivariance)
run on the port as well.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis_compat import given, settings, st

from repro.core import transport as jtransport
from repro.kernels import topk as jtopk
from repro_torch.core import transport as ttransport
from repro_torch.kernels import topk as ttopk

NEG_NAN = np.uint32(0xFFC00000).view(np.float32)


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a).view(np.uint8)


def special_row(n: int, seed: int) -> np.ndarray:
    """A seeded row with planted magnitude ties, ±0, NaN of both signs and
    two payloads, ±inf and subnormals among normal values."""
    rng = np.random.default_rng(seed)
    row = (rng.normal(size=n) * 3).astype(np.float32)
    pick = rng.permutation(n)
    tie = np.float32(row[pick[0]])
    row[pick[1:9]] = tie * np.where(np.arange(8) % 2, 1, -1).astype(np.float32)
    row[pick[9]], row[pick[10]] = 0.0, -0.0
    row[pick[11]], row[pick[12]] = np.nan, NEG_NAN
    row[pick[13]] = np.uint32(0x7FC00123).view(np.float32)
    row[pick[14]], row[pick[15]] = np.inf, -np.inf
    row[pick[16]], row[pick[17]] = np.float32(1e-40), np.float32(-3e-39)
    row[pick[18:30]] = np.round(row[pick[18:30]])  # integer ties
    return row


ISSUE_ROW = np.array([1, -3, np.nan, 3, NEG_NAN, 0, -0.0, 2, np.inf], np.float32)


@pytest.mark.parametrize("k", [1, 2, 6, 9])
def test_select_order_on_the_named_row(k):
    """``lax.top_k`` gives ``[2 4 8 1 3 7]`` at k = 6; ``torch.topk`` would not."""
    jidx, jval = jtopk.topk_select(jnp.asarray(ISSUE_ROW), k)
    tidx, tval = ttopk.topk_select(torch.from_numpy(ISSUE_ROW.copy()), k)
    assert tidx.dtype == torch.int32
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(_bits(tval), _bits(jval))
    if k == 6:
        assert tidx.tolist() == [2, 4, 8, 1, 3, 7]


@pytest.mark.parametrize("n,k", [(64, 1), (64, 30), (257, 40), (1000, 100),
                                 (1000, 1000), (4096, 64)])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_select_matches_reference_bit_for_bit(n, k, seed):
    row = special_row(n, seed)
    jidx, jval = jtopk.topk_select(jnp.asarray(row), k)
    tidx, tval = ttopk.topk_select(torch.from_numpy(row), k)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(_bits(tval), _bits(jval))


def test_select_ranks_nan_payloads_by_total_order():
    bits = np.array([0x7FC00001, 0x7FC00000, 0xFFC00005, 0x7F800001, 0x3F800000,
                     0xFF800000, 0x7FC00000], np.uint32)
    row = bits.view(np.float32)
    jidx, _ = jtopk.topk_select(jnp.asarray(row), 7)
    tidx, _ = ttopk.topk_select(torch.from_numpy(row.copy()), 7)
    assert tidx.tolist() == np.asarray(jidx).tolist() == [2, 0, 1, 6, 3, 5, 4]


@pytest.mark.parametrize("value_dtype", ["f32", "int8"])
@pytest.mark.parametrize("n,k,group", [(9, 6, 64), (1000, 100, 64), (3072, 48, 64),
                                       (3072, 3072, 32), (5000, 333, 7), (50, 500, 64)])
def test_wire_bytes_match_reference(value_dtype, n, k, group):
    row = special_row(max(n, 40), 3)[:n] if n >= 40 else ISSUE_ROW[:n]
    jc = jtransport.TopkUploadCodec(k=k, value_dtype=value_dtype, group=group)
    tc = ttransport.TopkUploadCodec(k=k, value_dtype=value_dtype, group=group)
    jw = jc.encode(jnp.asarray(row))
    tw = tc.encode(torch.from_numpy(row.copy()))
    assert tw.dtype == np.uint8 and tw.nbytes == tc.wire_nbytes(n) == jc.wire_nbytes(n)
    np.testing.assert_array_equal(tw, jw)
    assert tc.wire_params() == jc.wire_params()
    # Every decode half agrees too.
    jidx, jval = jc.unpack_coords(jw, n)
    tidx, tval = tc.unpack_coords(tw, n, torch.device("cpu"))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(_bits(tval), _bits(jval))
    jrow, jnorm = jc.decode_with_norm(jw, n)
    trow, tnorm = tc.decode_with_norm(tw, n, torch.device("cpu"))
    np.testing.assert_array_equal(_bits(trow), _bits(jrow))
    np.testing.assert_array_equal(_bits(tc.decode(tw, n, torch.device("cpu"))), _bits(jrow))
    np.testing.assert_allclose(float(tnorm), float(jnorm), rtol=1e-6)
    sidx, sval, snorm = tc.decode_sparse(tw, n, torch.device("cpu"))
    np.testing.assert_array_equal(sidx.numpy(), np.asarray(jidx))
    assert float(snorm) == float(tnorm) or np.isnan(float(tnorm))


def test_int8_values_encode_nan_as_zero():
    row = np.array([np.nan, 4.0, -2.0, NEG_NAN, 1.0], np.float32)
    for codec_mod, arr in ((jtransport, jnp.asarray(row)), (ttransport, torch.from_numpy(row))):
        wire = codec_mod.TopkUploadCodec(k=5, value_dtype="int8").encode(arr)
        assert wire[20] == wire[21] == 0  # the two NaNs rank first and ship as 0
    jw = jtransport.TopkUploadCodec(k=5, value_dtype="int8").encode(jnp.asarray(row))
    tw = ttransport.TopkUploadCodec(k=5, value_dtype="int8").encode(torch.from_numpy(row))
    np.testing.assert_array_equal(tw, jw)


@pytest.mark.parametrize("group", [1, 3, 8, 64, 100])
@pytest.mark.parametrize("seed", range(4))
def test_quantize_values_codes_and_scales(group, seed):
    rng = np.random.default_rng(seed)
    k = int(rng.integers(1, 400))
    v = (rng.normal(size=k) * 10.0 ** rng.integers(-40, 38, size=k)).astype(np.float32)
    u = rng.random(k)
    v[u < 0.05] = np.nan
    v[(u > 0.05) & (u < 0.07)] = NEG_NAN
    v[(u > 0.07) & (u < 0.09)] = np.inf
    v[(u > 0.09) & (u < 0.11)] = -np.inf
    v[(u > 0.11) & (u < 0.14)] = -0.0
    if seed == 3:
        v[: min(k, 2 * group)] = 0.0  # all-zero groups take scale 1.0
    jq, js = jtopk.quantize_values(jnp.asarray(v), group)
    tq, ts = ttopk.quantize_values(torch.from_numpy(v), group)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(_bits(ts), _bits(js))
    jd = jtopk.dequantize_values(jq, js, group)
    td = ttopk.dequantize_values(tq, ts, group)
    np.testing.assert_array_equal(_bits(td), _bits(jd))


@pytest.mark.parametrize("seed", range(4))
def test_densify_and_ef_residual(seed):
    row = special_row(512, seed)
    k = 64 + 32 * seed
    jidx, jval = jtopk.topk_select(jnp.asarray(row), k)
    tidx, tval = ttopk.topk_select(torch.from_numpy(row), k)
    for width in (512, 600):
        np.testing.assert_array_equal(_bits(ttopk.densify(tidx, tval, width)),
                                      _bits(jtopk.densify(jidx, jval, width)))
    acc = (np.random.default_rng(seed).normal(size=512) * 2).astype(np.float32)
    acc[:8] = [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-40, 5.0, -5.0]
    jr = np.asarray(jtopk.ef_residual(jnp.asarray(acc), jidx, jval))
    tr = ttopk.ef_residual(torch.from_numpy(acc), tidx, tval).numpy()
    np.testing.assert_array_equal(np.isnan(tr), np.isnan(jr))
    finite = ~np.isnan(jr)
    np.testing.assert_array_equal(tr[finite].view(np.uint32), jr[finite].view(np.uint32))


def test_densify_turns_negative_zero_positive():
    idx = np.array([3, 0, 1], np.int32)
    val = np.array([-0.0, 2.0, -0.0], np.float32)
    out = ttopk.densify(torch.from_numpy(idx), torch.from_numpy(val), 5).numpy()
    want = np.asarray(jtopk.densify(jnp.asarray(idx), jnp.asarray(val), 5))
    np.testing.assert_array_equal(out.view(np.uint32), want.view(np.uint32))
    assert not np.signbit(out).any()


@pytest.mark.parametrize("n,k", [(1, 5), (10, 0), (10, 3), (10, 10), (10, 11), (4096, 64)])
@pytest.mark.parametrize("value_dtype,group", [("f32", 64), ("int8", 64), ("int8", 7)])
def test_effective_k_and_wire_layout(n, k, value_dtype, group):
    assert ttopk.effective_k(n, k) == jtopk.effective_k(n, k)
    assert ttopk.wire_layout_topk(n, k, value_dtype, group) == jtopk.wire_layout_topk(
        n, k, value_dtype, group)


def test_codec_refusals_match_reference():
    for kwargs, match in (({"k": 0}, "k >= 1"), ({"value_dtype": "bf16"}, "value_dtype"),
                          ({"group": -1}, "group >= 1")):
        for mod in (jtransport, ttransport):
            with pytest.raises(ValueError, match=match):
                mod.TopkUploadCodec(**kwargs)
    with pytest.raises(ValueError, match="value_dtype"):
        ttopk.wire_layout_topk(10, 3, "fp8")
    tc = ttransport.TopkUploadCodec(k=4)
    with pytest.raises(ValueError, match="topk payload holds"):
        tc.decode(np.zeros(10, np.uint8), 100, torch.device("cpu"))


# -- the reference's sparse property tests, on the port -----------------------


@st.composite
def _rows(draw):
    """A random f32 row with its codec k (sometimes clamped: k >= n)."""
    n = draw(st.integers(2, 257))
    k = draw(st.integers(1, 300))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    return rng.normal(size=(n,)).astype(np.float32) * 3.0, k


@given(_rows(), st.sampled_from(("f32", "int8")))
@settings(max_examples=25, deadline=None)
def test_topk_codec_roundtrips(row_k, value_dtype):
    """encode -> unpack_coords/decode recovers the selected coordinates."""
    row, k = row_k
    n = row.shape[0]
    codec = ttransport.TopkUploadCodec(k=k, value_dtype=value_dtype, group=32)
    payload = codec.encode(torch.from_numpy(row))
    k_eff, _, nbytes = ttopk.wire_layout_topk(n, k, value_dtype, 32)
    assert payload.nbytes == nbytes
    idx, val = codec.unpack_coords(payload, n, torch.device("cpu"))
    idx, val = idx.numpy(), val.numpy()
    assert idx.shape == val.shape == (k_eff,)
    assert len(set(idx.tolist())) == k_eff and idx.min() >= 0 and idx.max() < n
    order = np.argsort(-np.abs(row), kind="stable")
    assert set(idx.tolist()) == set(order[:k_eff].tolist())
    dense = codec.decode(payload, n, torch.device("cpu")).numpy()
    assert dense.shape == (n,)
    if value_dtype == "f32":
        np.testing.assert_array_equal(val, row[idx])
        np.testing.assert_array_equal(dense[idx], row[idx])
    else:
        assert np.max(np.abs(val - row[idx])) <= np.abs(row).max() / 127.0
    off = np.ones(n, bool)
    off[idx] = False
    assert not dense[off].any()


@given(_rows(), st.sampled_from(("f32", "int8")))
@settings(max_examples=25, deadline=None)
def test_error_feedback_conserves_update_mass(row_k, value_dtype):
    """densify(sent) + residual == update, coordinate-exact in f32."""
    row, k = row_k
    n = row.shape[0]
    codec = ttransport.TopkUploadCodec(k=k, value_dtype=value_dtype, group=32)
    acc = torch.from_numpy(row)
    payload = codec.encode(acc)
    idx, val = codec.unpack_coords(payload, n, torch.device("cpu"))
    residual = ttopk.ef_residual(acc, idx, val)
    sent = ttopk.densify(idx, val, n)
    np.testing.assert_array_equal((sent + residual).numpy(), row)
    if value_dtype == "f32":
        assert not residual.numpy()[idx.numpy()].any()


@given(_rows(), st.integers(0, 2**31 - 1))
@settings(max_examples=25, deadline=None)
def test_topk_selection_is_permutation_equivariant(row_k, seed):
    """Permuting the row permutes the selected coordinate set with it."""
    row, k = row_k
    n = row.shape[0]
    rng = np.random.default_rng(seed)
    mags = np.sort(rng.uniform(0.5, 100.0, size=n))[::-1] + np.arange(n)[::-1]
    row = ((np.sign(row) + (row == 0)) * mags).astype(np.float32)
    k_eff = ttopk.effective_k(n, k)
    perm = rng.permutation(n)
    idx, _ = ttopk.topk_select(torch.from_numpy(row), k_eff)
    idx_p, _ = ttopk.topk_select(torch.from_numpy(row[perm].copy()), k_eff)
    assert {int(j) for j in idx} == {int(perm[j]) for j in idx_p}
