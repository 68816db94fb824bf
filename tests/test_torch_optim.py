"""The local optimizers, in both packages and held against each other.

The reference's ``tests/test_infra.py::test_optimizers_descend_quadratic``
for all five optimizers in the port, and each optimizer stepped several
times in both packages on the same gradients (numpy, from a seed) over a
tree with 2-D, 1-D and 3-D leaves: the params must agree within rtol 1e-5 /
atol 1e-6 (Adam's bias corrections use each framework's f32 ``pow``, which
may differ in the last bit), and SGD and momentum bit for bit.  A learner
runs each one through a federation in both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.optim as J
import repro_torch.optim as T
from repro_torch.tree import flatten

OPTS = [
    ("sgd", (0.1,), {}, True),
    ("momentum", (0.05,), {}, True),
    ("momentum", (0.05,), {"nesterov": True}, True),
    ("adam", (0.05,), {}, False),
    ("adamw", (0.05,), {}, False),
    ("adafactor", (0.1,), {}, False),
]
IDS = ["sgd", "momentum", "nesterov", "adam", "adamw", "adafactor"]


@pytest.mark.parametrize("name,args,kw,exact", OPTS, ids=IDS)
def test_optimizers_descend_quadratic(name, args, kw, exact):
    opt = getattr(T, name)(*args, **kw)
    params = {"w": torch.full((6, 3), 2.0), "b": torch.full((3,), -1.5)}

    def loss(p):
        return torch.sum(p["w"] ** 2) + torch.sum(p["b"] ** 2)

    st = opt.init(params)
    l0 = float(loss(params))
    for _ in range(60):
        params, st = opt.apply(params, torch.func.grad(loss)(params), st)
    assert float(loss(params)) < 0.2 * l0, opt.name


@pytest.mark.parametrize("name,args,kw,exact", OPTS, ids=IDS)
def test_optimizer_steps_match_reference(name, args, kw, exact):
    rng = np.random.default_rng(3)
    p0 = {"w": rng.normal(size=(5, 3)), "b": rng.normal(size=(3,)),
          "c": rng.normal(size=(2, 4, 3))}
    p0 = {k: v.astype(np.float32) for k, v in p0.items()}
    jo, to = getattr(J, name)(*args, **kw), getattr(T, name)(*args, **kw)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    js, ts = jo.init(jp), to.init(tp)
    for _ in range(8):
        g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
        jp, js = jo.apply(jp, {k: jnp.asarray(v) for k, v in g.items()}, js)
        tp, ts = to.apply(tp, {k: torch.from_numpy(v) for k, v in g.items()}, ts)
    for k in p0:
        got, want = tp[k].numpy(), np.asarray(jp[k])
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the states have the reference's leaves, in its order and shapes
    j_leaves = jax.tree_util.tree_leaves(js)
    t_leaves = flatten(ts)[0]
    assert [tuple(np.shape(x)) for x in t_leaves] == [tuple(np.shape(x)) for x in j_leaves]
    for a, b in zip(t_leaves, j_leaves):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5, atol=1e-6)


def test_adafactor_factors_only_matrices():
    st = T.adafactor().init({"m": torch.zeros((4, 6)), "v": torch.zeros((6,))})
    assert tuple(st.vr["m"].shape) == (4,) and tuple(st.vc["m"].shape) == (6,)
    assert tuple(st.v["m"].shape) == () and tuple(st.v["v"].shape) == (6,)
    assert st.step.dtype == torch.int32


@pytest.mark.parametrize("name", ["momentum", "adam", "adamw", "adafactor"])
def test_learner_federates_with_each_optimizer_in_both_packages(name):
    """A 2-round sync federation of the reduced housing MLP with each local
    optimizer, in both packages from one init: global models within rtol 1e-4
    / atol 1e-5 (the frameworks' CPU BLAS sums in different orders)."""
    import repro.core as JC
    import repro_torch.core as TC
    from repro.configs import housing_mlp
    from repro.launch import train as jtrain
    from repro.models import mlp as jmlp
    from repro_torch.core import packing as tpack
    from repro_torch.launch import train as ttrain

    lr = 1e-3 if name != "momentum" else 0.01
    init = jmlp.init_params(jax.random.key(0), housing_mlp.reduced())
    out = {}
    for side, m in (("reference", JC), ("port", TC)):
        dev = {} if side == "reference" else {"device": "cpu"}
        if side == "reference":
            _, learners = jtrain.build_housing_learners("100k", 3, 0,
                                                        optimizer=getattr(J, name)(lr))
            params = init
        else:
            _, learners = ttrain.build_housing_learners("100k", 3, 0,
                                                        optimizer=getattr(T, name)(lr),
                                                        device="cpu")
            params = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, init), "cpu")
        ctrl = m.Controller(protocol=m.SyncProtocol(local_steps=2, batch_size=32),
                            max_dispatch_workers=1, **dev)
        ctrl.set_initial_model(params)
        for learner in learners:
            ctrl.register_learner(learner)
        ctrl.engine.run(rounds=2)
        out[side] = np.array(ctrl.global_buffer)
        ctrl.shutdown()
    assert np.isfinite(out["port"]).all()
    assert not np.array_equal(out["port"], np.array(tpack.pack_numeric(params)))
    np.testing.assert_allclose(out["port"], out["reference"], rtol=1e-4, atol=1e-5)
