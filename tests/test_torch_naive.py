"""The paper's naive baseline, in both packages.

``repro_torch.core.naive`` takes the port's trees and must give the
reference's ``naive_aggregate`` bit for bit on the same leaves (both
accumulate in host float64, tensor by tensor and learner by learner, in the
same order), agree with the port's FedAvg within f32 rounding (after
``tests/test_aggregation.py::test_naive_aggregate_matches_fused``), and its
per-tensor pickles must round-trip.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import naive as jnaive
from repro_torch.core import aggregation, packing
from repro_torch.core import naive as tnaive
from repro_torch.tree import flatten


def _models(n, seed):
    rng = np.random.default_rng(seed)
    return [{"w1": rng.normal(size=(16, 8)).astype(np.float32),
             "b1": rng.normal(size=(8,)).astype(np.float32),
             "layers": [{"w": rng.normal(size=(8, 3)).astype(np.float32) * 10 ** i}
                        for i in range(2)]}
            for _ in range(n)]


@pytest.mark.parametrize("n,seed", [(1, 0), (4, 1), (7, 2)])
def test_naive_aggregate_is_the_references_bit_for_bit(n, seed):
    models = _models(n, seed)
    weights = [float(i + 1) * 0.7 for i in range(n)]
    want = jnaive.naive_aggregate([jax.tree_util.tree_map(jnp.asarray, m) for m in models],
                                  weights)
    got = tnaive.naive_aggregate([packing.tree_from_numpy(m) for m in models], weights)
    j_leaves = jax.tree_util.tree_leaves(want)
    t_leaves = flatten(got)[0]
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(a, np.asarray(b))


def test_naive_aggregate_matches_fused():
    models = [packing.tree_from_numpy(m) for m in _models(4, 3)]
    weights = [1.0, 2.0, 3.0, 4.0]
    out_naive = tnaive.naive_aggregate(models, weights)
    stack = torch.stack([packing.pack_numeric(m) for m in models])
    out_fused = packing.unpack_numeric(aggregation.fedavg(stack, torch.tensor(weights)),
                                       packing.build_manifest(models[0]))
    for a, b in zip(flatten(out_naive)[0], flatten(out_fused)[0]):
        np.testing.assert_allclose(a, b.numpy(), rtol=1e-5, atol=1e-6)


def test_naive_serialize_roundtrip():
    params = {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
              "b": [torch.ones(2), torch.zeros(1)]}
    blobs = tnaive.naive_serialize(params)
    assert len(blobs) == 3
    back = tnaive.naive_deserialize(blobs, flatten(params)[1])
    np.testing.assert_array_equal(back["w"], params["w"].numpy())
    np.testing.assert_array_equal(back["b"][0], np.ones(2, np.float32))
    # the same bytes as the reference's per-tensor pickles
    assert blobs == jnaive.naive_serialize({"w": np.arange(12, dtype=np.float32).reshape(3, 4),
                                            "b": [np.ones(2, np.float32),
                                                  np.zeros(1, np.float32)]})


def test_naive_dispatcher_is_sequential_and_blocking():
    order = []
    params = {"w": torch.ones(3)}

    def learner(i):
        def fit(received):
            order.append(i)
            return float(received["w"].sum()) + i
        return fit

    d = tnaive.NaiveDispatcher()
    assert d.dispatch(params, [learner(i) for i in range(4)]) == [3.0, 4.0, 5.0, 6.0]
    assert order == [0, 1, 2, 3] and d.dispatch_s > 0.0
