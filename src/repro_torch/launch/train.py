"""Federated training launcher of the port.

Wires configs → model → learners → controller → driver and runs a
federation on the card:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch housing-mlp --size 10m --learners 32 --rounds 3 \
        --local-steps 4 --batch-size 100 --protocol sync

``--arch housing-mlp --size 10m`` is the paper's stress-test model (100
hidden layers of width 320, 10,174,081 parameters).  ``--protocol`` picks
the workflow: ``sync`` and ``semi_sync`` run ``--rounds`` rounds, ``async``
``--rounds`` community updates.  ``--server-opt``, ``--selection``/
``--fraction`` and ``--prox-mu`` set the server optimizer, cohort selection
and FedProx term as in the reference's launcher.  ``--quantize`` ships the
downlink through the int8 codec (``kernels/ops.QuantCodec``).  ``--device
cpu`` runs on the host.  Other architectures are slice H of the port;
``--secure`` and ``--checkpoint-dir`` are slices E and B-2.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import optim as optim_mod
from repro_torch.configs import housing_mlp
from repro_torch.core import (
    Driver,
    FederationEnv,
    Learner,
    SelectionPolicy,
    TerminationCriteria,
)
from repro_torch.data import iid_partition, make_housing_data
from repro_torch.device import full_f32, resolve_device
from repro_torch.models import mlp as mlp_model

log = logging.getLogger("repro_torch.train")


def build_housing_learners(size: str, n_learners: int, seed: int = 0,
                           per_learner: int = 100, optimizer=None,
                           device: str | torch.device | None = None):
    """Paper §4.2 setup: 100 samples per learner, sampled with replacement.

    The data and every batch index come from numpy generators seeded as in
    the reference, so both packages train on identical batches.
    """
    device = resolve_device(device)
    cfg = housing_mlp.config(size)
    data = make_housing_data(seed=seed)
    shards = iid_partition(
        data.x.shape[0], n_learners, seed=seed,
        per_learner=per_learner, with_replacement=True,
    )
    learners = []
    for i, idx in enumerate(shards):
        x, y = data.x[idx], data.y[idx]
        rng = np.random.default_rng(seed + i)
        x_dev, y_dev = torch.from_numpy(x).to(device), torch.from_numpy(y).to(device)

        def data_fn(bs, _x=x_dev, _y=y_dev, _rng=rng, _n=x.shape[0]):
            j = torch.from_numpy(_rng.integers(0, _n, size=bs)).to(device)
            return _x[j], _y[j]

        learners.append(
            Learner(
                learner_id=f"learner_{i:03d}",
                loss_fn=mlp_model.mse_loss,
                eval_fn=lambda p, b: {"eval_loss": mlp_model.mse_loss(p, b)},
                data_fn=data_fn,
                eval_data_fn=lambda _x=x_dev, _y=y_dev: (_x, _y),
                optimizer=optimizer or optim_mod.sgd(0.01),
                num_examples=x.shape[0],
                device=device,
            )
        )
    return cfg, learners


def main(argv: list[str] | None = None):
    """Run the federation; returns ``(driver, history)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="housing-mlp")
    ap.add_argument("--size", default="1m", choices=list(housing_mlp.SIZES),
                    help="housing-mlp size")
    ap.add_argument("--learners", type=int, default=4)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=4)
    ap.add_argument("--batch-size", type=int, default=32)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--protocol", default="sync", choices=["sync", "semi_sync", "async"])
    ap.add_argument("--server-opt", default="fedavg",
                    choices=["fedavg", "sgdm", "fedadagrad", "fedyogi", "fedadam"])
    ap.add_argument("--selection", default="all", choices=["all", "random", "stratified"])
    ap.add_argument("--fraction", type=float, default=1.0)
    ap.add_argument("--prox-mu", type=float, default=0.0)
    ap.add_argument("--quantize", action="store_true",
                    help="int8 transport codec (hand-written Hopper kernels)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    if args.arch != "housing-mlp":
        raise NotImplementedError(
            f"--arch {args.arch}: the model zoo is slice H of the port (ROADMAP.md)"
        )
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    full_f32()
    device = resolve_device(args.device)

    cfg, learners = build_housing_learners(
        args.size, args.learners, args.seed,
        optimizer=optim_mod.sgd(args.lr), device=device,
    )
    # A host generator, so one seed gives the same initial model on every device.
    initial = mlp_model.init_params(torch.Generator().manual_seed(args.seed), cfg, device)

    env = FederationEnv(
        protocol=args.protocol,
        local_steps=args.local_steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        prox_mu=args.prox_mu,
        selection=SelectionPolicy(kind=args.selection, fraction=args.fraction),
        server_optimizer=args.server_opt,
        termination=TerminationCriteria(max_rounds=args.rounds),
        device=device,
    )
    driver = Driver(env)
    if args.quantize:
        from repro_torch.kernels.ops import QuantCodec

        driver.controller.channel.codec = QuantCodec()

    t0 = time.time()
    driver.initialize(initial, learners)
    history = driver.run()
    wall = time.time() - t0

    print("\nround,train_dispatch_s,train_round_s,aggregation_s,"
          "eval_dispatch_s,eval_round_s,federation_round_s,eval_loss")
    for h in history:
        r = h.as_row()
        print(
            f"{r['round']},{r['train_dispatch_s']:.4f},{r['train_round_s']:.4f},"
            f"{r['aggregation_s']:.4f},{r['eval_dispatch_s']:.4f},"
            f"{r['eval_round_s']:.4f},{r['federation_round_s']:.4f},"
            f"{h.metrics.get('eval_loss', float('nan')):.5f}"
        )
    stats = driver.controller.channel.stats
    print(f"\ntotal wall: {wall:.2f}s; wire bytes: {stats.bytes_moved:,}; "
          f"messages: {stats.messages}; serialize: {stats.serialize_s:.3f}s")
    return driver, history


if __name__ == "__main__":
    main()
