"""Compare the main-phase legs of two ``chip_smoke.py`` logs, per round.

    python3 tools/compare_smoke_legs.py OLD.log NEW.log [LEG ...]

Each log is the standard output of one ``chip_smoke.py`` run.  For every leg
of the main phase that both logs hold (or only the ``LEG`` names given), it
reads the leg's rounds (the distinct ``"round"`` of its lines), its kernel
launches, its upload bytes and messages, its fused and direct aggregation
counts and its engine counters, and divides each by the leg's rounds.  A leg whose two runs
launch the same kernels and set the same counters, each the same per round,
went through the same paths in both; a counter or a kernel set in one run
and not the other is a path that only one run took.

Prints one JSON line per leg: its rounds in each run, ``same_paths``, and
every per-round reading that differs.  Reads only the logs; needs no card.
"""

from __future__ import annotations

import json
import sys

COUNTS = ("upload_bytes", "upload_messages", "upload_meta_bytes", "quantized_direct",
          "fused_q8")


def legs(path: str) -> dict[str, dict]:
    """Each main-phase leg's rounds and its counted readings."""
    out: dict[str, dict] = {}
    with open(path) as f:
        for line in f:
            if not line.startswith('{"phase": "main.'):
                continue
            try:
                d = json.loads(line)
            except ValueError:
                continue
            leg = out.setdefault(d["phase"][len("main."):], {"rounds": set(), "counts": {}})
            if "round" in d:
                leg["rounds"].add(d["round"])
            if "launches" in d:
                leg["counts"].update({f"launches.{k}": v for k, v in d["launches"].items()})
                leg["counts"].update({k: d[k] for k in COUNTS if k in d})
                leg["counts"].update(d.get("engine", {}))
    return {k: {**v, "rounds": len(v["rounds"])} for k, v in out.items()
            if v["rounds"] and v["counts"]}


def compare(old: dict, new: dict) -> dict:
    """The per-round readings of one leg in two runs, and where they differ."""
    keys = sorted(set(old["counts"]) | set(new["counts"]))
    per_round = {
        k: [old["counts"].get(k, 0) / old["rounds"], new["counts"].get(k, 0) / new["rounds"]]
        for k in keys}
    differ = {k: v for k, v in per_round.items() if v[0] != v[1]}
    paths = [{k for k in keys if run["counts"].get(k, 0)} for run in (old, new)]
    return {"rounds": [old["rounds"], new["rounds"]],
            "same_paths": paths[0] == paths[1] and not differ,
            "set_in_one_run_only": sorted(paths[0] ^ paths[1]), "differ_per_round": differ}


def main(argv: list[str]) -> int:
    if len(argv) < 2:
        sys.exit(__doc__)
    old, new = legs(argv[0]), legs(argv[1])
    for name in argv[2:] or sorted(set(old) & set(new)):
        print(json.dumps({"leg": name, **compare(old[name], new[name])}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
