"""Local (learner-side) optimizers as pure tree transforms.

The port of ``repro/optim/optimizers.py``: ``init(params) -> state``,
``update(grads, state, params) -> (updates, state)``, with
``Optimizer.apply`` returning fresh tensors (no in-place update of the
caller's params).  SGD (the paper's stress-test optimizer), momentum, Adam,
AdamW, Adafactor and FedProx's proximal term.  States are trees mirroring the
params, on the params' device; the step counters are 0-d int32 tensors as in
the reference, so the bias corrections are computed in f32 as there.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch

from repro_torch.tree import flatten, tree_map, unflatten

__all__ = ["Optimizer", "OptState", "AdamState", "AdafactorState",
           "sgd", "momentum", "adam", "adamw", "adafactor", "apply_fedprox"]

OptState = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """An ``(init, update)`` pair over parameter trees."""

    name: str
    init: Callable[[Any], OptState]
    # (grads, state, params) -> (updates, new_state); apply: p + u
    update: Callable[[Any, OptState, Any], tuple[Any, OptState]]

    def apply(self, params: Any, grads: Any, state: OptState) -> tuple[Any, OptState]:
        """One step: ``params + update(grads)``, as new tensors."""
        updates, state = self.update(grads, state, params)
        return tree_map(lambda p, u: p + u, params, updates), state


def _zeros_like_tree(params):
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _step0(params) -> torch.Tensor:
    """A 0-d int32 step counter on the params' device."""
    leaves = flatten(params)[0]
    device = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(lr: float) -> Optimizer:
    """Vanilla SGD (the paper's stress-test optimizer)."""

    def init(params):
        return ()

    def update(grads, state, params):
        return tree_map(lambda g: -lr * g, grads), state

    return Optimizer("sgd", init, update)


def momentum(lr: float, beta: float = 0.9, nesterov: bool = False) -> Optimizer:
    """Heavy-ball momentum (Nesterov's variant with ``nesterov=True``)."""

    def init(params):
        return _zeros_like_tree(params)

    def update(grads, state, params):
        new_m = tree_map(lambda m, g: beta * m + g, state, grads)
        if nesterov:
            upd = tree_map(lambda m, g: -lr * (beta * m + g), new_m, grads)
        else:
            upd = tree_map(lambda m: -lr * m, new_m)
        return upd, new_m

    return Optimizer("momentum", init, update)


class AdamState(NamedTuple):
    """Adam's step counter and first and second moments."""

    step: torch.Tensor
    m: Any
    v: Any


def _adam_core(lr, b1, b2, eps, weight_decay):
    def init(params):
        return AdamState(_step0(params), _zeros_like_tree(params), _zeros_like_tree(params))

    def update(grads, state, params):
        step = state.step + 1
        m = tree_map(lambda m, g: b1 * m + (1 - b1) * g, state.m, grads)
        v = tree_map(lambda v, g: b2 * v + (1 - b2) * g * g, state.v, grads)
        t = step.to(torch.float32)
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)

        def u(mh, vh, p):
            upd = -lr * (mh / c1) / (torch.sqrt(vh / c2) + eps)
            if weight_decay:
                upd = upd - lr * weight_decay * p
            return upd

        return tree_map(u, m, v, params), AdamState(step, m, v)

    return init, update


def adam(lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    """Adam (Kingma & Ba) with bias-corrected moments."""
    init, update = _adam_core(lr, b1, b2, eps, 0.0)
    return Optimizer("adam", init, update)


def adamw(
    lr: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
    weight_decay: float = 0.01,
) -> Optimizer:
    """Adam with decoupled weight decay."""
    init, update = _adam_core(lr, b1, b2, eps, weight_decay)
    return Optimizer("adamw", init, update)


def apply_fedprox(loss_fn: Callable, mu: float, global_params: Any) -> Callable:
    """Wrap a local loss with the FedProx proximal term μ/2‖w − w_global‖²."""

    def prox_loss(params, *args, **kwargs):
        base = loss_fn(params, *args, **kwargs)
        sq = sum(
            torch.sum((p - g.to(p.dtype)) ** 2)
            for p, g in zip(flatten(params)[0], flatten(global_params)[0])
        )
        return base + 0.5 * mu * sq

    return prox_loss


# ---------------------------------------------------------------------------
# Adafactor (Shazeer & Stern): factored second moments for leaves of rank >= 2.
# ---------------------------------------------------------------------------


class AdafactorState(NamedTuple):
    """Adafactor's step counter and second-moment statistics."""

    step: torch.Tensor
    vr: Any  # row second moment (last dim reduced) for >=2-D leaves
    vc: Any  # column second moment (second-to-last dim reduced)
    v: Any  # full second moment for <2-D leaves


def adafactor(
    lr: float = 1e-2,
    decay_base: float = 0.8,
    eps1: float = 1e-30,
    clip_threshold: float = 1.0,
) -> Optimizer:
    """Adafactor with update clipping; factored moments for 2-D and up."""

    def _zeros(shape, p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def init(params):
        def vr(p):
            return _zeros(p.shape[:-1], p) if p.dim() >= 2 else _zeros((), p)

        def vc(p):
            return _zeros(p.shape[:-2] + p.shape[-1:], p) if p.dim() >= 2 else _zeros((), p)

        def v(p):
            return _zeros((), p) if p.dim() >= 2 else _zeros(p.shape, p)

        return AdafactorState(_step0(params), tree_map(vr, params), tree_map(vc, params),
                              tree_map(v, params))

    def update(grads, state, params):
        step = state.step + 1
        beta2 = 1.0 - step.to(torch.float32) ** (-decay_base)

        def upd(g, vr, vc, v):
            g = g.to(torch.float32)
            g2 = g * g + eps1
            if g.dim() >= 2:
                nvr = beta2 * vr + (1 - beta2) * torch.mean(g2, dim=-1)
                nvc = beta2 * vc + (1 - beta2) * torch.mean(g2, dim=-2)
                denom = (
                    nvr[..., None]
                    * nvc[..., None, :]
                    / torch.clamp(torch.mean(nvr, dim=-1, keepdim=True)[..., None], min=eps1)
                )
                u = g * torch.rsqrt(torch.clamp(denom, min=eps1))
                nv = v
            else:
                nv = beta2 * v + (1 - beta2) * g2
                u = g * torch.rsqrt(torch.clamp(nv, min=eps1))
                nvr, nvc = vr, vc
            rms_u = torch.sqrt(torch.mean(u * u) + eps1)
            u = u / torch.clamp(rms_u / clip_threshold, min=1.0)
            return -lr * u, nvr, nvc, nv

        flat_g, structure = flatten(grads)
        flat_p = flatten(params)[0]
        outs = [upd(*xs) for xs in zip(flat_g, flatten(state.vr)[0], flatten(state.vc)[0],
                                       flatten(state.v)[0])]
        updates = unflatten(structure, [o[0].to(p.dtype) for o, p in zip(outs, flat_p)])
        new_state = AdafactorState(
            step,
            unflatten(structure, [o[1] for o in outs]),
            unflatten(structure, [o[2] for o in outs]),
            unflatten(structure, [o[3] for o in outs]),
        )
        return updates, new_state

    return Optimizer("adafactor", init, update)
