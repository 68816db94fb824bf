"""The slice as a whole: sync FedAvg rounds in both packages from one init.

``Driver`` + ``SyncProtocol`` with 4 learners built as in
``launch/train.py::build_housing_learners`` (identical numpy data and batch
indices in both packages), the reduced housing MLP initialized by the
reference and carried across, 3 rounds, on the arena and on the stack leg.
The global buffer must agree after every round within rtol 1e-4 / atol 1e-5:
the two frameworks' CPU BLAS kernels sum in different orders, and those f32
rounding differences compound across the local steps and rounds.  Wire byte
counts, counter names and the round count must agree exactly.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import housing_mlp
from repro.core import Driver as JDriver
from repro.core import FederationEnv as JEnv
from repro.core import TerminationCriteria as JTerm
from repro.launch import train as jtrain
from repro.models import mlp as jmlp
from repro_torch.core import Driver as TDriver
from repro_torch.core import FederationEnv as TEnv
from repro_torch.core import TerminationCriteria as TTerm
from repro_torch.core import packing as tpack
from repro_torch.kernels import fedavg as tfed
from repro_torch.launch import train as ttrain
from repro_torch.models import mlp as tmlp

ROUNDS = 3


def _run(driver, initial, learners):
    driver.initialize(initial, learners)
    buffers, history = [], []
    for _ in range(ROUNDS):
        history += driver.controller.engine.run(rounds=1)
        buffers.append(np.asarray(driver.controller.global_buffer))
    driver.shutdown()
    return buffers, history


@pytest.mark.parametrize("store_mode", ["arena", "stack"])
def test_sync_rounds_match_reference(store_mode):
    seed = 0
    jinit = jmlp.init_params(jax.random.key(seed), housing_mlp.reduced())
    tinit = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jinit), "cpu")
    _, jlearners = jtrain.build_housing_learners("100k", 4, seed)
    _, tlearners = ttrain.build_housing_learners("100k", 4, seed, device="cpu")
    kw = dict(protocol="sync", local_steps=3, batch_size=32, learning_rate=0.01,
              store_mode=store_mode)
    jd = JDriver(JEnv(termination=JTerm(max_rounds=ROUNDS), **kw))
    td = TDriver(TEnv(termination=TTerm(max_rounds=ROUNDS), device="cpu", **kw))

    jbufs, jhist = _run(jd, jinit, jlearners)
    tbufs, thist = _run(td, tinit, tlearners)

    assert len(thist) == len(jhist) == ROUNDS
    for r, (got, want) in enumerate(zip(tbufs, jbufs)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"round {r}")
    for th, jh in zip(thist, jhist):
        np.testing.assert_allclose(th.metrics["eval_loss"], jh.metrics["eval_loss"],
                                   rtol=1e-4)
    # Training moved the model (the comparison is not of two idle federations).
    assert not np.allclose(tbufs[-1], np.asarray(tpack.pack_numeric(tinit)))

    jt, tt = jd.controller.telemetry, td.controller.telemetry
    assert set(tt.names()) <= set(jt.names())
    for name in ("channel.bytes_moved", "channel.messages", "channel.serializations",
                 "channel.upload_bytes", "channel.upload_meta_bytes",
                 "channel.upload_messages", "controller.dispatch_serializations",
                 "controller.model_version", "engine.round_id",
                 "store.arena.total_writes", "store.arena.bytes_ingested",
                 "store.model.total_inserts", "store.model.bytes_ingested",
                 "engine.uploads.rejected.nonfinite", "engine.uploads.clipped"):
        assert tt.value(name) == jt.value(name), name
    assert tt.value("channel.upload_messages") == 4 * ROUNDS


def test_cpu_path_never_counts_kernel_launches():
    """On host tensors ops takes the plain version: the kernel counters stay put."""
    before = (tfed.masked_fedavg_cuda.launches, tfed.fedavg_cuda.launches)
    _, learners = ttrain.build_housing_learners("100k", 2, 1, device="cpu")
    init = tmlp.init_params(torch.Generator().manual_seed(1), housing_mlp.reduced(), "cpu")
    d = TDriver(TEnv(protocol="sync", local_steps=1, batch_size=8, device="cpu",
                     termination=TTerm(max_rounds=1)))
    d.initialize(init, learners)
    hist = d.run()
    assert len(hist) == 1 and np.isfinite(hist[0].metrics["eval_loss"])
    assert (tfed.masked_fedavg_cuda.launches, tfed.fedavg_cuda.launches) == before
    assert d.controller.arena.buffer.device.type == "cpu"
