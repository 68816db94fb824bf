"""Plain reference of the federation: local SGD, the int8 wire, FedAvg and
the async protocol's staleness-weighted community update.

Frozen copies in plain PyTorch, importing nothing of the program.  A model is
a dict ``name -> float32 tensor`` in the order of ``harness/weights.layout``
(the order the port's flat row packs its leaves in).

* ``local_train``: ``steps`` SGD steps ``p <- p - lr * grad`` of the
  reference LM's loss, one batch each.
* ``quant_dequant``: the int8 codec's round trip on a flat row: groups of
  256, scale ``amax * float32(1/127)`` (1 for an all-zero group; magnitudes
  below the smallest normal float32 count as zero), ``q = clip(round(x /
  scale), -127, 127)``, then ``q * scale``.  The uplink quantizes a learner's
  whole packed row, the downlink each leaf apart.
* ``fedavg``: ``sum_i w_i x_i / sum_i w_i`` over the rows.
* ``staleness_weights``: ``n_i * (1 + s_i)^-alpha``, ``s_i`` the versions a
  row's model lags the current one.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from fedbench.reference import model as ref_model

GROUP = 256
INV_127 = torch.tensor(1.0 / 127.0, dtype=torch.float32)
FLT_MIN = float(torch.finfo(torch.float32).tiny)


def quant_dequant(x: torch.Tensor, group: int = GROUP) -> torch.Tensor:
    """A flat f32 row after the int8 codec's round trip."""
    n = x.numel()
    xg = torch.nn.functional.pad(x.reshape(-1), (0, (-n) % group)).reshape(-1, group)
    xg = torch.where(xg.abs() < FLT_MIN, torch.zeros_like(xg), xg)
    amax = xg.abs().amax(dim=1, keepdim=True)
    scale = amax * INV_127.to(x.device)
    scale = torch.where(scale < FLT_MIN, torch.zeros_like(scale), scale)
    scale = torch.where(amax > 0, scale, torch.ones_like(scale))
    q = torch.round(xg / scale)
    q = torch.where(torch.isnan(q), torch.zeros_like(q), q.clamp(-127.0, 127.0))
    return (q * scale).reshape(-1)[:n]


def pack(theta: dict) -> torch.Tensor:
    """The model as one flat f32 row, leaves in order."""
    return torch.cat([t.reshape(-1) for t in theta.values()])


def unpack(row: torch.Tensor, like: dict) -> dict:
    """``row`` cut into ``like``'s leaves."""
    out, offset = {}, 0
    for name, t in like.items():
        out[name] = row[offset: offset + t.numel()].view(t.shape)
        offset += t.numel()
    return out


def downlink(theta: dict, codec: str) -> dict:
    """What a learner receives: the model, or each leaf after the int8 round trip."""
    if codec == "raw":
        return theta
    return {k: quant_dequant(v.reshape(-1)).view(v.shape) for k, v in theta.items()}


def uplink(row: torch.Tensor, codec: str) -> torch.Tensor:
    """What the arena holds of an uploaded row."""
    return row if codec == "raw" else quant_dequant(row)


def local_train(theta: dict, batches: list, lr: float, cfg: dict,
                ops: ref_model.Ops, loss_fn: Callable = ref_model.lm_loss) -> tuple[dict, list]:
    """``len(batches)`` SGD steps from ``theta``; returns the model and each step's loss."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in theta.items()}
    losses = []
    for batch in batches:
        loss = loss_fn(params, batch, cfg, ops)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            params = {k: (p - lr * g).requires_grad_(True)
                      for (k, p), g in zip(params.items(), grads)}
        losses.append(float(loss.detach()))
        del loss, grads
    return {k: p.detach() for k, p in params.items()}, losses


def eval_loss(theta: dict, batches: list, cfg: dict, ops: ref_model.Ops) -> float:
    """The objective over the rows of ``batches`` together (blocks of rows of
    one eval set): the mean cross-entropy of every token, plus the MoE term
    from router statistics summed over the blocks."""
    with torch.no_grad():
        nll_sum, tokens, stats = 0.0, 0, None
        for batch in batches:
            nll, st = ref_model.token_losses(theta, batch, cfg, ops)
            nll_sum += float(nll.double().sum())
            tokens += nll.numel()
            stats = st if stats is None else [a + b for a, b in zip(stats, st)]
        mean = torch.tensor(nll_sum / tokens, dtype=torch.float32)
        return float(ref_model.objective(mean, [s.cpu() for s in stats], tokens, cfg))


def fedavg(rows: list[torch.Tensor], weights: list[float]) -> torch.Tensor:
    """The weighted mean of the rows."""
    total = sum(weights)
    out = torch.zeros_like(rows[0])
    for r, w in zip(rows, weights):
        out.add_(r, alpha=w / total)
    return out


def staleness_weights(examples: list[float], staleness: list[int], alpha: float) -> list[float]:
    """``n_i * (1 + s_i)^-alpha``."""
    return [n * (1.0 + max(s, 0)) ** (-alpha) for n, s in zip(examples, staleness)]


@dataclasses.dataclass
class Step:
    """One federation step the reference took: the learners' losses (each
    learner's last local step), the eval loss of the committed model (round-
    based protocols), and the norm of each leaf's change since the start."""

    train_losses: dict
    eval_loss: float | None
    change: dict
    theta: dict | None = None  # the committed model, kept on the last step only


def change_norms(theta: dict, theta0: dict) -> dict:
    """The norm of each leaf's change from ``theta0`` to ``theta``."""
    return {k: float(torch.linalg.vector_norm(theta[k] - theta0[k])) for k in theta0}


def _eval(theta: dict, shards, traffic: dict, cfg: dict, ops: ref_model.Ops,
          block: int = 4, codec: str | None = None) -> float:
    """The example-weighted mean eval loss over the learners (equal shards:
    the plain mean), each learner reading the model through the downlink
    (``codec``, by default the mix's)."""
    down = downlink(theta, codec or traffic["downlink"])
    n_ev = traffic["eval_seqs"]
    losses = [eval_loss(down, [shards.eval_batch(i, s, s + block) for s in range(0, n_ev, block)],
                        cfg, ops)
              for i in range(traffic["learners"])]
    return sum(losses) / len(losses)


def judge(theta: dict, shards, traffic: dict, cfg: dict) -> float:
    """The plain reference's own eval loss of a model (any side's), in f32,
    over every learner's eval set, the model taken as it is (no codec)."""
    return _eval(theta, shards, traffic, cfg, ref_model.Ops("f32"), codec="raw")


def replay_sync(theta0: dict, shards, traffic: dict, cfg: dict, rounds: int,
                ops: ref_model.Ops, take: Callable = lambda b: b,
                eval_block: int = 4) -> list[Step]:
    """The first ``rounds`` synchronous FedAvg rounds: every learner trains
    ``local_steps`` batches from the model it receives, uploads, and the
    committed model is the mean of the arena's rows (equal example counts).
    ``take`` maps each training batch before use (the identity; a fault
    reading passes half of it)."""
    steps = traffic["local_steps"]
    theta, out = theta0, []
    for r in range(rounds):
        down = downlink(theta, traffic["downlink"])
        acc, losses = None, {}
        n = traffic["learners"]
        for i in range(n):
            batches = [take(shards.batch(i, r * steps + s)) for s in range(steps)]
            trained, seen = local_train(down, batches, traffic["lr"], cfg, ops)
            row = uplink(pack(trained), traffic["upload_codec"])
            acc = row / n if acc is None else acc.add_(row, alpha=1.0 / n)
            losses[i] = seen[-1]
            del trained, row
        theta = unpack(acc, theta0)
        out.append(Step(losses, _eval(theta, shards, traffic, cfg, ops, eval_block),
                        change_norms(theta, theta0)))
    out[-1].theta = theta
    return out


def replay_async(theta0: dict, shards, traffic: dict, cfg: dict, schedule: list,
                 ops: ref_model.Ops, take: Callable = lambda b: b) -> list[Step]:
    """The async protocol's first community updates, in the order the
    program took them: ``schedule`` holds ``(learner, version, task)`` of
    each update's trigger (the global version its task was dispatched with,
    and which of that learner's tasks it was).  Each arrival lands in the
    learner's row; the update is the staleness-weighted mean of every row
    held, ``s_i`` the current version less the version row ``i`` was trained
    from."""
    steps, alpha = traffic["local_steps"], traffic["staleness_alpha"]
    models = {0: theta0}
    rows: dict[int, tuple[torch.Tensor, int]] = {}
    out = []
    for u, (lid, version, task) in enumerate(schedule):
        down = downlink(models[version], traffic["downlink"])
        batches = [take(shards.batch(lid, task * steps + s)) for s in range(steps)]
        trained, seen = local_train(down, batches, traffic["lr"], cfg, ops)
        rows[lid] = (uplink(pack(trained), traffic["upload_codec"]), version)
        held = sorted(rows)
        w = staleness_weights([1.0] * len(held), [u - rows[i][1] for i in held], alpha)
        models[u + 1] = unpack(fedavg([rows[i][0] for i in held], w), theta0)
        out.append(Step({lid: seen[-1]}, None, change_norms(models[u + 1], theta0)))
    out[-1].theta = models[len(schedule)]
    return out
