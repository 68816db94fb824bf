"""The comparison that decides ``correct``.

The program's first ``check_steps`` federation steps (rounds, or community
updates under async) run in set-up, through the window's own ``engine.run``
and data closures; the reference follows them from the same initial model
and batches.  Compared, each against its own limit from
``limits/<workload>.json``:

* ``train_loss_gap``: over the steps and learners, the widest relative gap
  between a learner's last local-step loss and the reference's;
* ``eval_loss_gap``: over the rounds, the widest relative gap between the
  committed model's eval loss and the reference's (round-based protocols);
* ``step1_change_gap``: over the leaves, the widest gap between the norm of
  a leaf's change in the first step (FedAvg's pseudo-gradient: the server
  step is the identity) and the reference's, as a share of the larger of
  the reference leaf's norm and the median leaf's;
* ``steps_change_gap``: the same for the change over all ``check_steps``;
* ``model_loss_gap``: the relative gap between the eval loss the plain
  reference finds for the program's model after all ``check_steps`` and for
  its own (both judged by the reference's float32 forward, over every
  learner's eval set);
* ``steps_diff_worst`` and ``steps_diff_median``: the worst and the median
  leaf's norm of the difference between the two models after all the steps,
  against the larger of the reference leaf's change and the median leaf's.

A cell compares the numbers its limits file names; the others are printed
beside them as readings.

A leaf whose first-step change in the reference is under a thousandth of
the median leaf's (a key bias under softmax, whose gradient is zero but for
rounding) is left out of both change gaps.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3


def _loss_gap(prog: dict, ref: dict) -> float:
    return max(abs(prog[k] - ref[k]) / abs(ref[k]) for k in ref)


def change_gap(prog: dict, ref: dict, kept: list[str]) -> float:
    """The worst leaf's gap of norms, against the larger of its own
    reference norm and the median leaf's."""
    median = statistics.median(ref[k] for k in kept)
    return max(abs(prog[k] - ref[k]) / max(ref[k], median) for k in kept)


def kept_leaves(ref_first: dict) -> list[str]:
    """The leaves the change gaps read: all but those whose reference change
    in the first step is under a thousandth of the median leaf's."""
    median = statistics.median(ref_first.values())
    return [k for k, v in ref_first.items() if v >= NEGLIGIBLE * median]


def readings(prog_steps: list, ref_steps: list) -> dict:
    """The compared numbers of the program's steps against the reference's.

    Each step is a dict with ``train_losses`` (learner index -> loss),
    ``eval_loss`` (or None) and ``change`` (leaf -> norm)."""
    out = {"train_loss_gap": max(_loss_gap(p["train_losses"], r["train_losses"])
                                 for p, r in zip(prog_steps, ref_steps))}
    if ref_steps[0]["eval_loss"] is not None:
        out["eval_loss_gap"] = max(abs(p["eval_loss"] - r["eval_loss"]) / abs(r["eval_loss"])
                                   for p, r in zip(prog_steps, ref_steps))
    kept = kept_leaves(ref_steps[0]["change"])
    out["step1_change_gap"] = change_gap(prog_steps[0]["change"], ref_steps[0]["change"], kept)
    out["steps_change_gap"] = change_gap(prog_steps[-1]["change"], ref_steps[-1]["change"], kept)
    last_p, last_r = prog_steps[-1], ref_steps[-1]
    if last_p.get("judged") is not None and last_r.get("judged") is not None:
        out["model_loss_gap"] = abs(last_p["judged"] - last_r["judged"]) / abs(last_r["judged"])
    if last_p.get("theta") is not None and last_r.get("theta") is not None:
        change = last_r["change"]
        median = statistics.median(change[k] for k in kept)
        diffs = sorted(float(torch.linalg.vector_norm(last_p["theta"][k].to(last_r["theta"][k])
                                                      - last_r["theta"][k]))
                       / max(change[k], median) for k in kept)
        out["steps_diff_worst"], out["steps_diff_median"] = diffs[-1], statistics.median(diffs)
    return out


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """``correct`` and each compared number (those ``limits`` names) beside
    its limit.  A compared number that is missing or not finite fails."""
    shown, ok = {}, True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok = ok and good
        shown[name] = {"value": value, "limit": limit}
    return ok, shown
