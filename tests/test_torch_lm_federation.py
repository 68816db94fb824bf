"""The dense LM through the federation, and the launcher's LM path, in both packages.

The reference's LM federation (``tests/test_system.py``'s
``test_transformer_federation_loss_decreases``: reduced qwen3-14b, 3
learners of 32 sequences of 24 tokens, 3 sync rounds of 6 local SGD steps
of batch 16) is run here in the f32 variant with one dispatch worker,
learners built by each package's ``build_lm_learners`` (identical numpy
tokens and batch indices) and the reference's initial weights carried
across.  The global buffer and the eval loss must agree after every round
within rtol 1e-4 / atol 1e-5 (the two frameworks' CPU BLAS sum in
different orders) at ``sgd(0.1)``, where local training is stable: at the
reference test's ``sgd(0.5)`` the loss climbs from 6.6 to 23 within five
steps and one ulp grows to 1.09 in 18 steps, so the reference jitted and
the reference eager differ by as much as the port does; there the port is
held to the reference test's own claim, a falling eval loss.  One
round on the int8 uplink into the int8 arena holds at the int8 bar: every
coordinate within one quantization step of its group plus 1e-5, fewer than
0.1% beyond rtol 1e-4 / atol 1e-5 (an int8 code may flip by one where the
sums differ).  The reduced MoE families run the same federation at the
same bars, reduced qwen2-moe for its first round: after it a near-tied
route flips (``_EXACT_ROUNDS``).  The launcher trains a reduced arch of every family on the host;
whisper, which it gives no audio frames, fails the reference's assertion as
the reference's launcher does.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as joptim
from repro.configs import get_reduced as jget_reduced
from repro.core import Controller as JController
from repro.core import SyncProtocol as JSync
from repro.core.transport import Channel as JChannel
from repro.launch import train as jtrain
from repro.models import transformer as jtf
from repro_torch import optim as toptim
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.core import Controller as TController
from repro_torch.core import SyncProtocol as TSync
from repro_torch.core import packing as tpack
from repro_torch.core.transport import Channel as TChannel
from repro_torch.launch import train as ttrain
from test_torch_int8 import assert_within_q8_bar

ARCH = "qwen3-14b"
LEARNERS = 3


def _federations(arch=ARCH, lr=0.1, **ctrl_kw):
    """The reference's and the port's controllers over the same learners and init."""
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_reduced(arch), dtype=torch.float32)
    jinit = jtf.init_params(jax.random.key(0), jcfg)
    tinit = tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, jinit), "cpu")
    data = dict(n_seq_per_learner=32, seq_len=24)
    jl = jtrain.build_lm_learners(jcfg, LEARNERS, 0, optimizer=joptim.sgd(lr), **data)
    tl = ttrain.build_lm_learners(tcfg, LEARNERS, 0, optimizer=toptim.sgd(lr), device="cpu",
                                  **data)
    codec = ctrl_kw.pop("upload_codec", "raw")
    jc = JController(protocol=JSync(6, 16, lr), arena_n_max=LEARNERS, max_dispatch_workers=1,
                     channel=JChannel(upload_codec=codec), **ctrl_kw)
    tc = TController(protocol=TSync(6, 16, lr), arena_n_max=LEARNERS, max_dispatch_workers=1,
                     channel=TChannel(upload_codec=codec, device="cpu"), device="cpu",
                     **ctrl_kw)
    for ctrl, init, learners in ((jc, jinit, jl), (tc, tinit, tl)):
        ctrl.set_initial_model(init)
        for learner in learners:
            ctrl.register_learner(learner)
    return jc, tc, tinit


def _rounds(ctrl, n):
    buffers, losses = [], []
    for _ in range(n):
        (h,) = ctrl.engine.run(rounds=1)
        buffers.append(np.asarray(ctrl.global_buffer))
        losses.append(h.metrics["eval_loss"])
    ctrl.shutdown()
    return buffers, losses


def test_lm_federation_matches_reference():
    jc, tc, tinit = _federations()
    jbufs, jloss = _rounds(jc, 3)
    tbufs, tloss = _rounds(tc, 3)
    for r, (got, want) in enumerate(zip(tbufs, jbufs)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"round {r}")
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4, atol=1e-5)
    assert tloss[-1] < tloss[0], tloss
    assert not np.allclose(tbufs[-1], np.asarray(tpack.pack_numeric(tinit)))
    assert tc.telemetry.value("channel.upload_bytes") == jc.telemetry.value("channel.upload_bytes")
    # The global buffer is the arena row: the manifest's params padded to 1024.
    assert tbufs[0].shape == jbufs[0].shape


def test_lm_federation_at_the_reference_tests_rate_learns():
    _, tc, _ = _federations(lr=0.5)
    _, losses = _rounds(tc, 3)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_lm_int8_round_matches_reference_at_the_int8_bar():
    jc, tc, _ = _federations(upload_codec="int8", arena_dtype="int8")
    (jbuf,), _ = _rounds(jc, 1)
    (tbuf,), _ = _rounds(tc, 1)
    assert tc.arena.buffer.dtype == torch.int8
    assert_within_q8_bar(tbuf, jbuf, what="int8 LM round")
    assert tc.telemetry.value("engine.uploads.quantized_direct") == LEARNERS
    assert tc.telemetry.value("controller.aggregations.fused_q8") == 1


def test_launcher_trains_a_reduced_dense_arch_on_the_host():
    driver, history = ttrain.main(["--arch", "qwen3-14b", "--reduced", "--device", "cpu",
                                   "--learners", "3", "--rounds", "2", "--dispatch-workers", "2"])
    assert len(history) == 2
    assert driver.controller.engine._executor._max_workers == 2
    assert all(np.isfinite(h.metrics["eval_loss"]) for h in history)
    assert driver.controller.telemetry.value("channel.upload_messages") == 6
    n = tpack.num_params(driver.controller.global_params)
    assert driver.controller.arena.buffer.shape[1] == tpack.round_up(n, 1024)


# Rounds held at the bar.  Reduced qwen2-moe's router (σ 0.02 over 4
# experts) leaves some of the federation's ~40,000 token routes a round on
# near-ties, where a last-ulp difference picks another expert: the port's
# model leaves the reference's by 2.2e-3 in round 2 (3.3e-7 in round 1), and
# the reference started from weights one ulp away leaves itself by 2.2e-3 in
# round 3.  Past its exact rounds the federation is held to the reference's
# eval loss within 1% and a falling loss (ROADMAP.md §3).
_EXACT_ROUNDS = {"qwen2-moe-a2.7b": 1, "deepseek-v3-671b": 3}


@pytest.mark.parametrize("arch", sorted(_EXACT_ROUNDS))
def test_moe_lm_federation_matches_reference(arch):
    """The MoE families (deepseek-v3 with MLA, a leading dense layer and the
    MTP head) through the same 3-round federation, at the same bars for
    their exact rounds."""
    jc, tc, tinit = _federations(arch)
    jbufs, jloss = _rounds(jc, 3)
    tbufs, tloss = _rounds(tc, 3)
    exact = _EXACT_ROUNDS[arch]
    for r, (got, want) in enumerate(zip(tbufs[:exact], jbufs)):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=f"round {r}")
    np.testing.assert_allclose(tloss[:exact], jloss[:exact], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-2)
    assert tloss[-1] < tloss[0], tloss
    assert not np.allclose(tbufs[-1], np.asarray(tpack.pack_numeric(tinit)))


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "deepseek-v3-671b", "mamba2-780m",
                                  "zamba2-1.2b"])
def test_launcher_trains_each_new_family(arch):
    """MoE, MLA with MTP, Mamba2 and the hybrid train through
    ``launch/train.py --arch ... --reduced`` on the host."""
    driver, history = ttrain.main(["--arch", arch, "--reduced", "--device", "cpu",
                                   "--learners", "2", "--rounds", "2", "--local-steps", "2"])
    assert len(history) == 2
    losses = [h.metrics["eval_loss"] for h in history]
    assert np.isfinite(losses).all(), losses
    assert driver.controller.telemetry.value("channel.upload_messages") == 4
    n = tpack.num_params(driver.controller.global_params)
    abstract = jtf.abstract_params(jget_reduced(arch))
    assert n == sum(math.prod(x.shape) for x in jax.tree_util.tree_leaves(abstract))
    assert driver.controller.arena.buffer.shape[1] == tpack.round_up(n, 1024)


def test_launcher_whisper_raises_the_references_assertion(monkeypatch):
    """Both launchers give whisper's learners no audio frames, so its first
    step fails the reference's assertion, with the same message."""
    msg = "enc-dec model needs frames or memory"
    with pytest.raises(AssertionError, match=msg):
        ttrain.main(["--arch", "whisper-large-v3", "--reduced", "--device", "cpu",
                     "--learners", "2", "--rounds", "1", "--local-steps", "1"])
    monkeypatch.setattr("sys.argv", ["train", "--arch", "whisper-large-v3", "--reduced",
                                     "--learners", "2", "--rounds", "1", "--local-steps", "1"])
    with pytest.raises(AssertionError, match=msg):
        jtrain.main()


def test_launcher_unknown_arch_raises_the_registry_key_error():
    with pytest.raises(KeyError, match="unknown arch"):
        ttrain.main(["--arch", "gpt-17", "--device", "cpu"])


def test_event_log_keeps_no_uploaded_model():
    """The engine's bounded event log keeps each arrival without its model
    (trained params, packed row, wire payload): at fedlm-100m's width every
    logged upload would otherwise pin 296 MB on the device and 296 MB of
    host bytes, 9.5 GB of each a round at 32 learners."""
    from repro_torch.core.engine import UploadArrived

    driver, _ = ttrain.main(["--arch", "qwen3-14b", "--reduced", "--device", "cpu",
                             "--learners", "2", "--rounds", "2", "--local-steps", "1"])
    arrivals = [e for e in driver.controller.engine.event_log if isinstance(e, UploadArrived)]
    assert len(arrivals) == 4
    for e in arrivals:
        assert e.update.params is None and e.update.buffer is None
        assert e.update.upload.payload is None
        assert e.update.upload.metadata["learner_id"] == e.learner_id
    assert sorted(e.update.round_id for e in arrivals) == [0, 0, 1, 1]
