"""Federated training launcher of the port.

Wires configs → model → learners → controller → driver and runs a
federation on the card:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch housing-mlp --size 10m --learners 32 --rounds 3 \
        --local-steps 4 --batch-size 100 --protocol sync

``--arch housing-mlp --size 10m`` is the paper's stress-test model (100
hidden layers of width 320, 10,174,081 parameters).  ``--arch fedlm-100m``
trains the 73,937,664-parameter dense decoder LM, and an assigned
architecture trains at full size or, with ``--reduced``, at its smoke
scale: the dense ``qwen3-14b``, ``qwen2-72b``, ``codeqwen1.5-7b``,
``gemma3-4b`` and ``llava-next-34b`` (its text path), the MoE
``qwen2-moe-a2.7b`` and ``deepseek-v3-671b`` (MLA, multi-token prediction),
the SSM ``mamba2-780m`` and the hybrid ``zamba2-1.2b``; each learner holds
64 synthetic sequences of 64 tokens (``build_lm_learners``).  As in the
reference's launcher, ``whisper-large-v3`` gets no audio frames and its
first step raises ``AssertionError: enc-dec model needs frames or memory``;
an unknown ``--arch`` raises the registry's ``KeyError``.  ``--protocol`` picks the workflow: ``sync`` and
``semi_sync`` run ``--rounds`` rounds, ``async`` ``--rounds`` community
updates.  ``--server-opt``, ``--selection``/``--fraction`` and
``--prox-mu`` set the server optimizer, cohort selection and FedProx term
as in the reference's launcher.  ``--quantize`` ships the downlink through
the int8 codec (``kernels/ops.QuantCodec``).  ``--secure`` aggregates
masked fixed-point uploads (``core/secure.py``).  ``--checkpoint-dir DIR``
saves the final global model there
(``repro_torch.checkpoint.save_checkpoint``) and prints its path.
``--device cpu`` runs on the host.  ``--dispatch-workers`` bounds the
learners training at once (32 by default): at fedlm-100m's width 32
learners in flight (about 2 GB each) do not fit beside the 9.46 GB arena in
an H100's 80 GB.
"""

from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

from repro_torch import optim as optim_mod
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHITECTURES, fedlm_100m, get_config, get_reduced, housing_mlp
from repro_torch.core import (
    Driver,
    FederationEnv,
    Learner,
    SelectionPolicy,
    TerminationCriteria,
)
from repro_torch.data import LMDataIterator, iid_partition, make_housing_data, make_lm_data
from repro_torch.device import full_f32, resolve_device
from repro_torch.models import mlp as mlp_model
from repro_torch.models import transformer

log = logging.getLogger("repro_torch.train")


def _lm_batch(batch: dict, device: torch.device) -> dict:
    """A numpy ``{"tokens", "labels"}`` batch as int64 tensors on ``device``."""
    return {k: torch.from_numpy(v.astype(np.int64)).to(device) for k, v in batch.items()}


def build_lm_learners(cfg, n_learners: int, seed: int = 0, n_seq_per_learner: int = 64,
                      seq_len: int = 64, optimizer=None,
                      device: str | torch.device | None = None):
    """One learner per silo over a disjoint synthetic token shard.

    The tokens and every batch index come from numpy generators seeded as in
    the reference, so both packages train on identical batches.  As there,
    evaluation draws its batch of 16 from the learner's training iterator, so
    an evaluation advances the training batches' generator.
    """
    device = resolve_device(device)
    toks = make_lm_data(n_learners * n_seq_per_learner, seq_len, cfg.vocab_size, seed)
    shards = iid_partition(toks.shape[0], n_learners, seed=seed)

    def loss_fn(params, batch):
        return transformer.lm_loss(params, batch, cfg)

    def eval_fn(params, batch):
        return {"eval_loss": loss_fn(params, batch)}

    learners = []
    for i, idx in enumerate(shards):
        it = LMDataIterator(toks[idx], seed=seed + i)
        learners.append(
            Learner(
                learner_id=f"learner_{i:03d}",
                loss_fn=loss_fn,
                eval_fn=eval_fn,
                data_fn=lambda bs, _it=it: _lm_batch(_it(bs), device),
                eval_data_fn=lambda _it=it: _lm_batch(_it(16), device),
                optimizer=optimizer or optim_mod.sgd(0.5),
                num_examples=it.n_examples,
                device=device,
            )
        )
    return learners


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
    ap.add_argument("--arch", default="housing-mlp",
                    help=f"one of {['housing-mlp', 'fedlm-100m', *ARCHITECTURES]}")
    ap.add_argument("--size", default="1m", choices=list(housing_mlp.SIZES),
                    help="housing-mlp size")
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale variant of an assigned arch")
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
    ap.add_argument("--secure", action="store_true")
    ap.add_argument("--quantize", action="store_true",
                    help="int8 transport codec (hand-written Hopper kernels)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--dispatch-workers", type=int, default=32,
                    help="learners training at once (fewer when they do not all "
                         "fit in device memory)")
    args = ap.parse_args(argv)

    cfg = None
    if args.arch == "fedlm-100m":
        cfg = fedlm_100m.config()
    elif args.arch != "housing-mlp":
        cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    logging.basicConfig(level=logging.INFO, format="%(levelname)s %(name)s: %(message)s")
    full_f32()
    device = resolve_device(args.device)

    # A host generator, so one seed gives the same initial model on every device.
    generator = torch.Generator().manual_seed(args.seed)
    if cfg is None:
        cfg, learners = build_housing_learners(
            args.size, args.learners, args.seed,
            optimizer=optim_mod.sgd(args.lr), device=device,
        )
        initial = mlp_model.init_params(generator, cfg, device)
    else:
        learners = build_lm_learners(cfg, args.learners, args.seed,
                                     optimizer=optim_mod.sgd(args.lr), device=device)
        initial = transformer.init_params(generator, cfg, device)

    env = FederationEnv(
        protocol=args.protocol,
        local_steps=args.local_steps,
        batch_size=args.batch_size,
        learning_rate=args.lr,
        prox_mu=args.prox_mu,
        selection=SelectionPolicy(kind=args.selection, fraction=args.fraction),
        server_optimizer=args.server_opt,
        secure_aggregation=args.secure,
        termination=TerminationCriteria(max_rounds=args.rounds),
        device=device,
        max_dispatch_workers=args.dispatch_workers,
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

    if args.checkpoint_dir:
        path = save_checkpoint(
            args.checkpoint_dir, len(history), driver.controller.global_params,
            metadata={"arch": args.arch, "rounds": len(history)},
        )
        print(f"checkpoint: {path}")
    return driver, history


if __name__ == "__main__":
    main()
