"""``tools/compare_smoke_legs.py``: the per-round comparison of two
``chip_smoke.py`` logs that a cut of a leg's rounds is checked with."""

from __future__ import annotations

import importlib.util
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
spec = importlib.util.spec_from_file_location("compare_smoke_legs",
                                              ROOT / "tools" / "compare_smoke_legs.py")
compare_smoke_legs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(compare_smoke_legs)


def _log(path: pathlib.Path, rounds: int, launches: int, clipped: int) -> str:
    lines = [{"phase": "main.int8_arena", "round": r, "eval_loss": 19.0} for r in range(rounds)]
    lines.append({"phase": "main.int8_arena", "breakdown": {"learner_recv_s": 1.0}})
    lines.append({"phase": "main.int8_arena", "launches": {"quantize": launches, "fedavg": 0},
                  "upload_bytes": 100 * rounds, "fused_q8": rounds,
                  "engine": {"engine.uploads.clipped": clipped}})
    path.write_text("not json\n" + "\n".join(json.dumps(d) for d in lines) + "\n")
    return str(path)


def test_a_leg_cut_to_one_round_keeps_its_paths(tmp_path):
    """Two rounds and one, each reading scaled by its rounds: the same paths."""
    old = compare_smoke_legs.legs(_log(tmp_path / "a.log", 2, 64, 0))
    new = compare_smoke_legs.legs(_log(tmp_path / "b.log", 1, 32, 0))
    got = compare_smoke_legs.compare(old["int8_arena"], new["int8_arena"])
    assert got == {"rounds": [2, 1], "same_paths": True, "set_in_one_run_only": [],
                   "differ_per_round": {}}


def test_a_counter_set_in_one_run_only_is_a_dropped_path(tmp_path, capsys):
    """A counter the longer run sets and the shorter one does not (a clip, a
    quarantine) shows as a path only one run took."""
    old = _log(tmp_path / "a.log", 3, 96, 1)
    new = _log(tmp_path / "b.log", 2, 64, 0)
    assert compare_smoke_legs.main([old, new]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["leg"] == "int8_arena" and not got["same_paths"]
    assert got["set_in_one_run_only"] == ["engine.uploads.clipped"]
    assert got["differ_per_round"] == {"engine.uploads.clipped": [1 / 3, 0.0]}
