"""Parity of the port's wire format with the reference's (core/packing.py).

The same parameters — the reduced housing MLP initialized by the reference,
carried across as numpy — go through both packages.  The manifest, the
numeric buffer and every wire byte must be identical: packing moves bits, it
does no arithmetic.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import housing_mlp
from repro.core import packing as jpack
from repro.models import mlp as jmlp
from repro_torch import tree as ttree
from repro_torch.core import packing as tpack


def _params(dtype):
    p = jmlp.init_params(jax.random.key(0), housing_mlp.reduced())
    return jax.tree_util.tree_map(lambda x: x.astype(dtype), p)


def _carry(p):
    return tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, p), "cpu")


def _spec_tuples(manifest):
    return [(s.name, s.shape, s.dtype, s.offset, s.size, s.nbytes) for s in manifest.specs]


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_manifest_specs_match(dtype):
    jp = _params(dtype)
    tp = _carry(jp)
    jm, tm = jpack.build_manifest(jp), tpack.build_manifest(tp)
    assert _spec_tuples(tm) == _spec_tuples(jm)
    assert tm.total_elements == jm.total_elements
    assert tm.total_bytes == jm.total_bytes
    # Sorted dict keys: each layer's bias comes before its weight.
    assert tm.specs[0].name == "['layers'][0]['b']"


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_numeric_and_wire_bytes_identical(dtype):
    jp = _params(dtype)
    tp = _carry(jp)
    jm, tm = jpack.build_manifest(jp), tpack.build_manifest(tp)

    jbuf = np.asarray(jpack.pack_numeric(jp, pad_to=1024))
    tbuf = tpack.pack_numeric(tp, pad_to=1024).numpy()
    assert tbuf.shape == jbuf.shape and tbuf.shape[0] % 1024 == 0
    assert tbuf.tobytes() == jbuf.tobytes()

    jw, _ = jpack.pack_bytes(jp)
    tw, _ = tpack.pack_bytes(tp)
    assert tw.tobytes() == jw.tobytes()

    # Serialize-once broadcast bytes straight off the padded numeric buffer.
    assert (tpack.pack_bytes_from_numeric(torch.from_numpy(tbuf), tm).tobytes()
            == jpack.pack_bytes_from_numeric(jnp.asarray(jbuf), jm).tobytes())

    # Upload row bytes.
    assert (tpack.pack_row_bytes(torch.from_numpy(tbuf)).tobytes()
            == jpack.pack_row_bytes(jnp.asarray(jbuf)).tobytes())

    # Wire round trips in the port restore every leaf bit for bit.
    back = tpack.unpack_bytes(tw, tm, "cpu")
    for (_, a), (_, b) in zip(*(ttree.flatten_with_path(t)[0] for t in (back, tp))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    row = tpack.unpack_row_bytes(tpack.pack_row_bytes(torch.from_numpy(tbuf)),
                                 tbuf.shape[0], "float32", "cpu")
    assert row.numpy().tobytes() == tbuf.tobytes()
    un = tpack.unpack_numeric(torch.from_numpy(tbuf), tm)
    for a, b in zip(ttree.flatten(un)[0], ttree.flatten(tp)[0]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_tree_carry_round_trip_exact(dtype):
    jp = _params(dtype)
    np_tree = jax.tree_util.tree_map(np.asarray, jp)
    back = tpack.tree_to_numpy(tpack.tree_from_numpy(np_tree, "cpu"))
    jl, jdef = jax.tree_util.tree_flatten(np_tree)
    bl, bdef = jax.tree_util.tree_flatten(back)
    assert jdef == bdef
    for a, b in zip(jl, bl):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_mixed_containers_names_and_order():
    tree = {"z": [np.ones(2, np.float32), (np.zeros((), np.float32),)],
            "a": {3: np.arange(4, dtype=np.float32)}}
    jm = jpack.build_manifest(jax.tree_util.tree_map(jnp.asarray, tree))
    tm = tpack.build_manifest(tpack.tree_from_numpy(tree, "cpu"))
    assert _spec_tuples(tm) == _spec_tuples(jm)


def test_tree_walks_leave_no_reference_cycle_holding_leaves():
    """Flattening, rebuilding and mapping a tree create no reference cycle:
    a leaf dropped by every caller is freed at once, not when the cyclic
    garbage collector next runs (a model's tensors kept until then held an
    extra 4.9 GB row a step at qwen2-moe-a2.7b's full width on the card)."""
    import gc
    import weakref

    tree = {"a": [torch.ones(4), (torch.zeros(2), torch.ones(3))], "b": {"c": torch.ones(1)}}
    gc.collect()
    gc.disable()
    try:
        mapped = ttree.tree_map(lambda t: t * 2, tree)
        rebuilt = ttree.unflatten(*reversed(ttree.flatten(mapped)))
        named, _ = ttree.flatten_with_path(rebuilt)
        refs = [weakref.ref(leaf) for _, leaf in named]
        del mapped, rebuilt, named
        assert all(r() is None for r in refs)
    finally:
        gc.enable()
