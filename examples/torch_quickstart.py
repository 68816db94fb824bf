"""Quickstart on the port: a 4-learner federated workflow in ~40 lines.

The PyTorch twin of ``examples/quickstart.py``: the same workflow (Fig. 1)
end to end on the card — the driver initializes the controller with the
model state, learners register, and synchronous FedAvg rounds run with
per-operation timing (the measurements of Figs. 5-7).  Each learner is a
user-written ``Learner`` over its own ``loss_fn``/``data_fn`` closures.  The
datasets and every batch index are drawn from one numpy generator in the
reference's order, so both scripts train on the same silos.

    PYTHONPATH=src python examples/torch_quickstart.py                 # the card
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu    # the host
"""

import argparse

import numpy as np
import torch

from repro_torch.core import Driver, FederationEnv, Learner, TerminationCriteria
from repro_torch.device import full_f32, resolve_device
from repro_torch.optim import sgd

# --- a private dataset per learner (linear regression silos) ---------------
rng = np.random.default_rng(0)
W_TRUE = rng.normal(size=(8, 1)).astype(np.float32)


def make_learner(i: int, device: torch.device) -> Learner:
    X = rng.normal(size=(256, 8)).astype(np.float32)
    y = X @ W_TRUE + 0.01 * rng.normal(size=(256, 1)).astype(np.float32)
    X_dev, y_dev = torch.from_numpy(X).to(device), torch.from_numpy(y).to(device)

    def loss_fn(params, batch):
        xb, yb = batch
        return torch.mean((xb @ params["w"] + params["b"] - yb) ** 2)

    def data_fn(batch_size):
        idx = torch.from_numpy(rng.integers(0, 256, size=batch_size)).to(device)
        return X_dev[idx], y_dev[idx]

    return Learner(
        learner_id=f"hospital_{i}",
        loss_fn=loss_fn,
        eval_fn=lambda p, b: {"eval_loss": loss_fn(p, b)},
        data_fn=data_fn,
        eval_data_fn=lambda: (X_dev, y_dev),
        optimizer=sgd(0.1),
        num_examples=256,
        device=device,
    )


def main(argv=None, initial=None):
    """Run the federation; returns ``(driver, history)``.  ``initial`` replaces
    the zero model (a tree of tensors, e.g. carried from the reference)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    full_f32()

    env = FederationEnv(
        protocol="sync", local_steps=10, batch_size=64,
        server_optimizer="fedavg",
        termination=TerminationCriteria(max_rounds=5),
        device=device,
    )
    driver = Driver(env)
    if initial is None:
        initial = {"w": torch.zeros((8, 1), device=device),
                   "b": torch.zeros((1,), device=device)}
    driver.initialize(
        initial_params=initial,
        learners=[make_learner(i, device) for i in range(4)],
    )
    history = driver.run()

    print("round | federation_s | aggregation_s | eval_loss")
    for h in history:
        print(f"{h.round_id:>5} | {h.federation_round_s:>11.3f} | "
              f"{h.aggregation_s:>12.4f} | {h.metrics['eval_loss']:.6f}")
    assert history[-1].metrics["eval_loss"] < 1e-2
    print("converged ✓")
    return driver, history


if __name__ == "__main__":
    main()
