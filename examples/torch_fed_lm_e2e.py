"""End-to-end driver on the port: federated training of the ~100M-parameter LM.

The PyTorch twin of ``examples/fed_lm_e2e.py``.  8 learner silos hold
disjoint synthetic token shards; the controller runs synchronous FedAvg with
a FedAdam server optimizer on the card, then saves the global model as a
checkpoint.  A few hundred local steps total (rounds x learners x
local_steps).

    PYTHONPATH=src python examples/torch_fed_lm_e2e.py                 # full (~100M)
    PYTHONPATH=src python examples/torch_fed_lm_e2e.py --small         # 2 layers, d 256
    PYTHONPATH=src python examples/torch_fed_lm_e2e.py --small --device cpu \\
        --learners 2 --rounds 2 --local-steps 2                       # the host
"""

import argparse
import dataclasses
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.fedlm_100m import config as fedlm_config
from repro_torch.core import Driver, FederationEnv, TerminationCriteria
from repro_torch.device import full_f32, resolve_device
from repro_torch.launch.train import build_lm_learners
from repro_torch.models import transformer
from repro_torch.optim import sgd


def main(argv=None, initial=None):
    """Train, then checkpoint; returns ``(driver, history, checkpoint_path)``.
    ``initial`` replaces the seeded init (a tree of tensors, e.g. carried from
    the reference)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--learners", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=6)
    ap.add_argument("--local-steps", type=int, default=8)
    ap.add_argument("--checkpoint-dir", default="experiments/fedlm_ckpt")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    full_f32()

    cfg = fedlm_config()
    if args.small:
        cfg = dataclasses.replace(cfg, n_layers=2, d_model=256, n_heads=4,
                                  n_kv_heads=2, d_ff=512, vocab_size=4096)

    n_params_est = cfg.param_count_estimate()
    print(f"model: {cfg.name}  ~{n_params_est/1e6:.0f}M params, "
          f"{args.learners} learners x {args.rounds} rounds x "
          f"{args.local_steps} local steps")

    learners = build_lm_learners(
        cfg, args.learners, seed=0, n_seq_per_learner=48, seq_len=48,
        optimizer=sgd(0.3), device=device,
    )
    if initial is None:
        initial = transformer.init_params(torch.Generator().manual_seed(0), cfg, device)

    env = FederationEnv(
        protocol="sync", local_steps=args.local_steps, batch_size=16,
        server_optimizer="fedadam", server_lr=0.5,
        termination=TerminationCriteria(max_rounds=args.rounds),
        device=device,
    )
    driver = Driver(env)
    t0 = time.time()
    driver.initialize(initial, learners)
    history = driver.run()
    wall = time.time() - t0

    losses = [h.metrics["eval_loss"] for h in history]
    print("\nround | eval_loss | fed_round_s | agg_s")
    for h in history:
        print(f"{h.round_id:>5} | {h.metrics['eval_loss']:>9.4f} | "
              f"{h.federation_round_s:>11.2f} | {h.aggregation_s:.4f}")
    print(f"\nwall: {wall:.1f}s  loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    assert losses[-1] < losses[0], "federated training must reduce loss"

    path = save_checkpoint(args.checkpoint_dir, len(history),
                           driver.controller.global_params,
                           metadata={"arch": cfg.name})
    print(f"checkpoint: {path}")
    return driver, history, path


if __name__ == "__main__":
    main()
