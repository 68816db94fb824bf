"""The reference's four example workflows and their port twins, script against script.

Each test loads ``examples/<name>.py`` and ``examples/torch_<name>.py`` by
path and runs both on the CPU; the reference's initial model is carried
across with ``core/packing.tree_from_numpy``.  The bars:

* quickstart: ``W_TRUE`` and every learner's ``X`` and ``y`` bit-identical
  (the same numpy generator in the same order); 5 rounds and a final
  ``eval_loss`` below 1e-2 in both.  The history is not held round by
  round: the batch indices come from the one shared generator, and under 32
  dispatch workers the order in which the learners draw is fixed in neither
  package.
* fed_lm_e2e (``--small``, f32 compute, 2 rounds).  FedAdam's server step
  at lr 0.5 (no bias correction) moves each weight by 0.5·Δ/(|Δ| + 0.01):
  near ±0.5 wherever the learners moved it by more than 0.01, and with a
  gain of up to 50 on Δ below that.  At 2 learners x 2 local steps (the
  smallest run) each round's aggregate and the global params it starts
  from are within rtol 1e-4 / atol 1e-5, the bar of
  ``tests/test_torch_lm_federation.py``, and both eval losses at rtol 1e-4;
  the loss rises in both, so both scripts raise their own assertion before
  saving.  At 4 learners x 6 local steps the loss falls in both and both
  save a checkpoint; there ``sgd(0.3)``'s six steps from the jumped model
  are chaotic (round 1's aggregates differ by up to 0.37 where round 0's
  agree within 6% of the bar), so round 0 is held: its aggregate at the
  bar and its eval loss at rtol 1e-4.  In both runs every server step is
  held, in each package, against FedAdam's formula in numpy on that
  package's own moments, global and aggregate: the gain above takes an
  aggregate's last-bit gap (5.9e-7 at round 0 of the larger run) to 1.6e-5
  in the params, past the bar, so the new globals are held through the
  formula and not against each other.  The checkpoints' file names, keys
  and metadata are equal, and each holds its own run's final model bit for
  bit (the manifest inside is a pickle of each package's own class).
* secure_async_fl: ``tests/test_torch_examples_secure.py`` (the
  reference's run alone takes most of a minute here).
* serve_multiarch: each family's greedy tokens equal over 6 steps at f32
  compute (the bar of ``tests/test_torch_serve.py``).
* Every port script exits 0 from the command line with ``--device cpu`` at
  reduced arguments.

The port's CPU ops run on one thread each here (``OMP_NUM_THREADS=1`` on the
command line): a multithreaded reduction's order varies from run to run, and
the chaotic runs above turn that last-bit difference into another loss (at 3
learners x 7 steps, round 1 read 63.64-63.94 over four runs on all threads,
64.1884 in every run on one).  On one thread every run of a test is the same
run.
"""

import dataclasses
import importlib.util
import itertools
import pathlib
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jrestore
from repro.configs import get_reduced as jget_reduced
from repro.configs.fedlm_100m import config as jfedlm_config
from repro.core import packing as jpack
from repro.models import transformer as jtf
from repro_torch.checkpoint import restore_checkpoint as trestore
from repro_torch.configs import get_reduced as tget_reduced
from repro_torch.configs.fedlm_100m import config as tfedlm_config
from repro_torch.core import packing as tpack

ROOT = pathlib.Path(__file__).resolve().parents[1]
_fresh = itertools.count()
# Each port script's reduced command line (``--device cpu`` is added).
_CLI = {
    "torch_quickstart": [],
    "torch_fed_lm_e2e": ["--small", "--learners", "3", "--rounds", "2", "--local-steps", "3"],
    "torch_secure_async_fl": [],
    "torch_serve_multiarch": [],
}


@pytest.fixture(autouse=True)
def one_intra_op_thread():
    """The port's CPU ops on one thread for the test (see the module's
    docstring), the setting put back after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module", autouse=True)
def cli_runs(tmp_path_factory):
    """Every port script started from the command line at once, when this
    file's first test starts, so they run beside the in-process tests; each
    command-line test waits for its own.  Yields ``{script: (process, log)}``
    and kills what is still running at the end."""
    procs = {}
    try:
        for script, args in _CLI.items():
            cwd = tmp_path_factory.mktemp(script)
            if script == "torch_fed_lm_e2e":
                args = [*args, "--checkpoint-dir", str(cwd)]
            log = cwd / "log.txt"
            with open(log, "w") as out:
                procs[script] = (subprocess.Popen(
                    [sys.executable, str(ROOT / "examples" / f"{script}.py"), *args,
                     "--device", "cpu"],
                    stdout=out, stderr=subprocess.STDOUT, cwd=cwd,
                    env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                         "OMP_NUM_THREADS": "1"}), log)
        yield procs
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)


def _load(name: str):
    """A fresh module of ``examples/<name>.py`` (its import-time draws anew)."""
    spec = importlib.util.spec_from_file_location(f"_example_{name}_{next(_fresh)}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _carry(tree):
    return tpack.tree_from_numpy(jax.tree_util.tree_map(np.asarray, tree), "cpu")


def _spy_drivers(monkeypatch, module, seen: list, per_round: list | None = None):
    """Record every ``Driver`` the script builds (and, with ``per_round``, each
    server step's moments ``m`` and ``v``, global buffer, aggregate and new
    global buffer, as numpy arrays)."""
    base = module.Driver

    class Spy(base):
        def __init__(self, env, *args, **kwargs):
            super().__init__(env, *args, **kwargs)
            seen.append(self)
            if per_round is not None:
                opt = self.controller.server_opt

                def recorded(state, x_global, x_agg):
                    inputs = (state.m, state.v, x_global, x_agg)
                    state, new = opt.apply(state, x_global, x_agg)
                    per_round.append(tuple(np.asarray(x).copy() for x in (*inputs, new)))
                    return state, new

                self.controller.server_opt = dataclasses.replace(opt, apply=recorded)

        def run(self):
            self.history = super().run()
            return self.history

    monkeypatch.setattr(module, "Driver", Spy)


def test_quickstart_matches_reference(monkeypatch):
    jm, tm = _load("quickstart"), _load("torch_quickstart")
    np.testing.assert_array_equal(tm.W_TRUE, jm.W_TRUE)
    cpu = torch.device("cpu")
    for i in range(4):
        jx, jy = jm.make_learner(i)._eval_data_fn()
        tx, ty = tm.make_learner(i, cpu)._eval_data_fn()
        np.testing.assert_array_equal(tx.numpy(), jx)
        np.testing.assert_array_equal(ty.numpy(), jy)

    jm, tm = _load("quickstart"), _load("torch_quickstart")
    seen = []
    _spy_drivers(monkeypatch, jm, seen)
    jm.main()
    initial = _carry({"w": jnp.zeros((8, 1)), "b": jnp.zeros((1,))})
    driver, history = tm.main(["--device", "cpu"], initial=initial)
    for hist in (seen[0].history, history):
        assert len(hist) == 5
        assert hist[-1].metrics["eval_loss"] < 1e-2, hist[-1].metrics
    assert driver.controller.arena is not None


_SMALL = dict(n_layers=2, d_model=256, n_heads=4, n_kv_heads=2, d_ff=512, vocab_size=4096)


def _fed_lm_e2e(monkeypatch, tmp_path, args):
    """Both scripts at ``--small`` in f32 from the reference's init; returns
    each one's driver, server steps (as ``_spy_drivers`` records them) and
    result (the port's return value or either's ``AssertionError``), with
    round 0 held."""
    jm, tm = _load("fed_lm_e2e"), _load("torch_fed_lm_e2e")
    monkeypatch.setattr(jm, "fedlm_config",
                        lambda: dataclasses.replace(jfedlm_config(), dtype=jnp.float32))
    monkeypatch.setattr(tm, "fedlm_config",
                        lambda: dataclasses.replace(tfedlm_config(), dtype=torch.float32))
    jinit = jtf.init_params(jax.random.key(0),
                            dataclasses.replace(jfedlm_config(), dtype=jnp.float32, **_SMALL))
    jseen, tseen, jsteps, tsteps = [], [], [], []
    _spy_drivers(monkeypatch, jm, jseen, jsteps)
    _spy_drivers(monkeypatch, tm, tseen, tsteps)
    monkeypatch.setattr(sys, "argv", ["fed_lm_e2e.py", "--small", *args,
                                      "--checkpoint-dir", str(tmp_path / "ref")])
    results = []
    for run in (jm.main, lambda: tm.main(["--small", *args, "--checkpoint-dir",
                                          str(tmp_path / "port"), "--device", "cpu"],
                                         initial=_carry(jinit))):
        try:
            results.append(run())
        except AssertionError as err:
            results.append(err)
    (jd,), (td,) = jseen, tseen
    assert len(jd.history) == len(td.history) == len(jsteps) == len(tsteps) == 2
    np.testing.assert_array_equal(tsteps[0][2], jsteps[0][2])  # the carried init
    np.testing.assert_allclose(tsteps[0][3], jsteps[0][3], rtol=1e-4, atol=1e-5)
    for m, v, x_global, x_agg, new in jsteps + tsteps:  # FedAdam, lr 0.5, in each
        g = x_global - x_agg
        m = np.float32(0.9) * m + np.float32(0.1) * g
        v = np.float32(0.99) * v + np.float32(0.01) * (g * g)
        np.testing.assert_allclose(new, x_global - np.float32(0.5) * m
                                   / (np.sqrt(v) + np.float32(1e-3)), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(td.history[0].metrics["eval_loss"],
                               jd.history[0].metrics["eval_loss"], rtol=1e-4)
    return jd, td, jsteps, tsteps, results


def test_fed_lm_e2e_fails_its_own_assertion_as_the_reference_does(monkeypatch, tmp_path):
    """At the smallest run (2 learners, 2 rounds of 2 local steps) both
    rounds agree and the loss rises in both: both scripts raise their
    assertion before saving."""
    jd, td, jsteps, tsteps, results = _fed_lm_e2e(
        monkeypatch, tmp_path, ["--learners", "2", "--rounds", "2", "--local-steps", "2"])
    for jstep, tstep in zip(jsteps, tsteps):  # the global each round starts from, the aggregate
        for got, want in zip(tstep[2:4], jstep[2:4]):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(td.history[1].metrics["eval_loss"],
                               jd.history[1].metrics["eval_loss"], rtol=1e-4)
    for d, err in zip((jd, td), results):
        assert isinstance(err, AssertionError), err
        assert str(err) == "federated training must reduce loss"
        losses = [h.metrics["eval_loss"] for h in d.history]
        assert losses[1] > losses[0], losses
    assert not (tmp_path / "ref").exists() and not (tmp_path / "port").exists()


def test_fed_lm_e2e_matches_reference(monkeypatch, tmp_path):
    jd, td, _, _, (jout, tout) = _fed_lm_e2e(
        monkeypatch, tmp_path, ["--learners", "4", "--rounds", "2", "--local-steps", "6"])
    assert jout is None
    driver, history, path = tout
    assert driver is td and history == td.history
    for d in (jd, td):
        losses = [h.metrics["eval_loss"] for h in d.history]
        assert losses[1] < losses[0], losses

    jpath = tmp_path / "ref" / "ckpt_00000002.npz"
    assert pathlib.Path(path) == tmp_path / "port" / jpath.name and jpath.exists()
    with np.load(jpath) as jz, np.load(path) as tz:
        assert jz.files == tz.files
        assert jz["meta"].tobytes() == tz["meta"].tobytes()
        assert jz["buffer"].shape == tz["buffer"].shape
    jparams, _, jmeta = jrestore(str(tmp_path / "ref"))
    tparams, _, tmeta = trestore(str(tmp_path / "port"), device="cpu")
    assert jmeta == tmeta == {"step": 2, "arch": "fedlm-100m"}
    np.testing.assert_array_equal(
        tpack.pack_numeric(tparams).numpy(),
        tpack.pack_numeric(driver.controller.global_params).numpy())
    np.testing.assert_array_equal(
        np.asarray(jpack.pack_numeric(jparams)),
        np.asarray(jpack.pack_numeric(jd.controller.global_params)))


@pytest.mark.parametrize("arch", ["gemma3-4b", "mamba2-780m", "deepseek-v3-671b"])
def test_serve_multiarch_tokens_match_reference(monkeypatch, arch):
    jm, tm = _load("serve_multiarch"), _load("torch_serve_multiarch")
    jcfg = dataclasses.replace(jget_reduced(arch), dtype=jnp.float32)
    tcfg = dataclasses.replace(tget_reduced(arch), dtype=torch.float32)
    monkeypatch.setattr(jm, "get_reduced", lambda a: jcfg)
    steps = []

    def recording_jit(fn):
        jitted = jax.jit(fn)

        def step(*args):
            tok, caches = jitted(*args)
            steps.append(np.asarray(tok))
            return tok, caches

        return step

    monkeypatch.setattr(jm, "jax", types.SimpleNamespace(
        jit=recording_jit, random=jax.random, block_until_ready=jax.block_until_ready))
    gen = 6
    jm.serve(arch, batch=4, gen=gen)
    jinit = jtf.init_params(jax.random.key(0), jcfg)
    toks, tok_per_s = tm.serve(arch, batch=4, gen=gen, device="cpu", cfg=tcfg,
                               params=_carry(jinit))
    assert toks.dtype == torch.int32 and tuple(toks.shape) == (4, gen) and tok_per_s > 0
    np.testing.assert_array_equal(toks.numpy(), np.concatenate(steps[1:], axis=1))


@pytest.mark.parametrize("script", list(_CLI))
def test_port_script_runs_from_the_command_line(cli_runs, script):
    proc, log = cli_runs[script]
    proc.wait(timeout=300)
    assert proc.returncode == 0, log.read_text()
    assert "Traceback" not in log.read_text()
