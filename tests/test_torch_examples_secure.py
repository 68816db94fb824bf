"""The reference's secure_async_fl workflow and its port twin, script against script.

``examples/secure_async_fl.py`` and ``examples/torch_secure_async_fl.py``
run on the CPU (the helpers and the other three workflows are in
``tests/test_torch_examples.py``); the reference's initial model is carried
across with ``core/packing.tree_from_numpy``.  Phase 1 runs one of its three
secure rounds in both, to keep the file near half a minute (most of it the
reference's compiles).  The bars: phase 1's global params within the int8
bar (one quantization step of the group plus 1e-5; fewer than 0.1% of
coordinates beyond rtol 1e-4 / atol 1e-5); the int8 downlink's
``bytes_moved`` and ``messages`` equal; phase 2's community updates equal
in number and at least the 20 asked for (with 4 learners the 3 in flight at
the 20th are drained and aggregated), and its eval loss falling in both.
"""

import re

import jax
import numpy as np

from repro.configs import housing_mlp as jhousing_mlp
from repro.models import mlp as jmlp
from test_torch_examples import _carry, _load, _spy_drivers, one_intra_op_thread  # noqa: F401
from test_torch_int8 import assert_within_q8_bar


def test_secure_async_fl_matches_reference(monkeypatch, capsys):
    jm, tm = _load("secure_async_fl"), _load("torch_secure_async_fl")
    for module in (jm, tm):  # phase 1: one round of its three
        monkeypatch.setattr(module, "TerminationCriteria",
                            lambda max_rounds, _t=module.TerminationCriteria: _t(max_rounds=1))
    seen = []
    _spy_drivers(monkeypatch, jm, seen)
    jm.main()
    printed = capsys.readouterr().out
    jupdates = int(re.search(r"secure async phase: (\d+) community updates", printed)[1])
    jstart, jfinal = map(float, re.search(r"eval loss (\S+) -> (\S+)\n", printed).groups())
    jinit = jmlp.init_params(jax.random.key(0), jhousing_mlp.config("100k"))
    out = tm.main(["--device", "cpu"], initial=_carry(jinit))

    jctrl, tctrl = seen[0].controller, out["driver"].controller
    assert len(seen[0].history) == len(out["history"]) == 1
    assert_within_q8_bar(np.asarray(tctrl.global_buffer), np.asarray(jctrl.global_buffer),
                         what="secure sync phase")
    assert tctrl.channel.stats.bytes_moved == jctrl.channel.stats.bytes_moved
    assert tctrl.channel.stats.messages == jctrl.channel.stats.messages
    assert len(out["updates"]) == jupdates >= 20
    assert jfinal < jstart and out["final"] < out["start"]
