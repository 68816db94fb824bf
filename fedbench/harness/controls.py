"""Readings that set the upper end of each limit: the control and the faults.

``correct`` must come out false when the reference, put in the program's
place, computes in the precision below the one the configuration states
(float8 e4m3 products for its bfloat16 compute: the control), and when a
fault a training cell can have is planted: half of every batch left out (the
mean taken over the rest), or a step that returns its state unchanged (which
reads 1 on both change gaps by their definition and needs no run).

These are read with the reference in the program's place: the readings of
the control's (or the fault's) steps against the plain reference's, from the
same seed.  An async cell follows ``first_updates``: the order a run takes
its first updates in, up to which of two tasks in flight arrives first.

The benchmark's own runs never run these; ``fedbench/tests`` does, at toy
size on the host and at the cells' sizes on the card.
"""

from __future__ import annotations

import torch

from fedbench.harness import check, spec, traffic, weights
from fedbench.reference import fl, model as ref_model


def half(batch: dict) -> dict:
    """The first half of a batch's sequences."""
    n = batch["tokens"].shape[0] // 2
    return {k: v[:n] for k, v in batch.items()}


def first_updates(learners: int, k: int) -> list[tuple[int, int, int]]:
    """``(learner, version, task)`` of the first ``k`` community updates when
    the learners' tasks arrive in turn: each learner's first task from the
    initial model, then its next from the model its previous update committed
    (update ``(task - 1) * learners + learner``)."""
    out = []
    for u in range(k):
        i, task = u % learners, u // learners
        out.append((i, 0 if task == 0 else (task - 1) * learners + i + 1, task))
    return out


def reference_steps(cell: spec.Cell, seed: int, device: torch.device, precision: str = "f32",
                    take=lambda b: b, schedule: list | None = None) -> list[dict]:
    """The reference's first ``check_steps`` steps at ``precision``, from the
    cell's inputs for ``seed``; an async cell's in ``schedule``'s order
    (``(learner, version, task)`` a step; by default ``first_updates``)."""
    t = cell.traffic
    theta0 = weights.draw(cell.config, seed, device)
    shards = traffic.make_shards(t, cell.config["vocab_size"], seed, device)
    ops = ref_model.Ops(precision)
    if t["protocol"] == "sync":
        steps = fl.replay_sync(theta0, shards, t, cell.config, t["check_steps"], ops, take)
    else:
        schedule = schedule or first_updates(t["learners"], t["check_steps"])
        steps = fl.replay_async(theta0, shards, t, cell.config, schedule, ops, take)
    out = [{"train_losses": s.train_losses, "eval_loss": s.eval_loss, "change": s.change}
           for s in steps]
    out[-1]["theta"] = steps[-1].theta
    out[-1]["judged"] = fl.judge(steps[-1].theta, shards, t, cell.config)
    return out


def readings(cell: spec.Cell, seed: int, device: torch.device) -> dict[str, dict]:
    """The compared numbers of the control and of the half-batch fault,
    each against the plain reference of the same seed."""
    plain = reference_steps(cell, seed, device)
    out = {}
    for name, kw in (("control_fp8", {"precision": "fp8"}), ("half_batch", {"take": half})):
        out[name] = check.readings(reference_steps(cell, seed, device, **kw), plain)
        torch.cuda.empty_cache() if device.type == "cuda" else None
    return out
