"""One local SGD step of the reduced housing MLP in both packages.

Same params (the reference's init carried across), same batch, same
optimizer.  The gradient goes through different f32 BLAS kernels in the two
frameworks, so the trained params agree to f32 rounding: rtol 1e-5, atol 1e-6.
"""

import jax
import numpy as np

from repro import optim as joptim
from repro.configs import housing_mlp
from repro.core.learner import Learner as JLearner
from repro.core.scheduler import TrainTask as JTask
from repro.models import mlp as jmlp
from repro_torch import optim as toptim
from repro_torch import tree as ttree
from repro_torch.core import packing as tpack
from repro_torch.core.learner import Learner as TLearner
from repro_torch.core.scheduler import TrainTask as TTask
from repro_torch.models import mlp as tmlp


def test_one_local_step_matches_reference():
    cfg = housing_mlp.reduced()
    jp = jmlp.init_params(jax.random.key(7), cfg)
    tp = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(0)
    x = rng.normal(size=(100, 13)).astype(np.float32)
    y = rng.normal(size=(100, 1)).astype(np.float32)
    tbatch = tpack.tree_from_numpy((x, y), "cpu")

    def make(cls, mlp, opt, batch, **kw):
        return cls(
            "l0", loss_fn=mlp.mse_loss,
            eval_fn=lambda p, b: {"eval_loss": mlp.mse_loss(p, b)},
            data_fn=lambda bs: batch, eval_data_fn=lambda: batch,
            optimizer=opt, num_examples=100, **kw,
        )

    jl = make(JLearner, jmlp, joptim.sgd(0.05), (x, y))
    tl = make(TLearner, tmlp, toptim.sgd(0.05), tbatch, device="cpu")
    ju = jl.fit(jp, JTask(round_id=0, local_steps=1, batch_size=100, learning_rate=0.05))
    tu = tl.fit(tp, TTask(round_id=0, local_steps=1, batch_size=100, learning_rate=0.05))

    np.testing.assert_allclose(tu.metrics["train_loss"], ju.metrics["train_loss"], rtol=1e-5)
    names = [n for n, _ in ttree.flatten_with_path(tu.params)[0]]
    for name, got, want in zip(names, ttree.flatten(tu.params)[0],
                               jax.tree_util.tree_leaves(ju.params)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    # The step moved the params (the comparison is not of two untouched inits).
    assert not np.allclose(ttree.flatten(tu.params)[0][1].numpy(),
                           ttree.flatten(tp)[0][1].numpy())
    je, te = jl.evaluate(ju.params, 0), tl.evaluate(tu.params, 0)
    np.testing.assert_allclose(te.metrics["eval_loss"], je.metrics["eval_loss"], rtol=1e-5)
