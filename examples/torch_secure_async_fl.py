"""Secure aggregation + asynchronous protocol + int8 transport on the port —
the three controller features the paper's Table 1 highlights as MetisFL
differentiators, composed in one workflow.

The PyTorch twin of ``examples/secure_async_fl.py``, doing what that
script's code does:

Phase 1: synchronous rounds with MASKED SECURE AGGREGATION — the controller
only ever sums fixed-point-masked uploads (pairwise pads cancel exactly).
Its downlink ships the global model through the int8 codec
(``kernels/ops.QuantCodec``): the card's quantize kernel encodes each
broadcast and its dequantize kernel decodes it at each learner.
Phase 2: SECURE ASYNCHRONOUS federation — the engine aggregates on every
arrival with staleness-discounted weights inside a fresh per-epoch mask
session (keyed by the global model version), still never seeing an
individual model; no round barrier.  Its fresh ``Controller`` builds a plain
``Channel``, so phase 2's models travel as f32, as in the reference's code
(whose docstring says both phases use the int8 codec).

    PYTHONPATH=src python examples/torch_secure_async_fl.py                # the card
    PYTHONPATH=src python examples/torch_secure_async_fl.py --device cpu   # the host
"""

import argparse

import numpy as np
import torch

from repro_torch.core import (
    AsyncProtocol, Controller, Driver, FederationEnv, TerminationCriteria,
)
from repro_torch.device import full_f32, resolve_device
from repro_torch.kernels.ops import QuantCodec
from repro_torch.launch.train import build_housing_learners
from repro_torch.models import mlp as mlp_model


def main(argv=None, initial=None):
    """Run both phases; returns a dict of phase 1's ``driver`` and ``history``,
    phase 2's ``controller`` and ``updates``, and the adaptation's ``start``
    and ``final`` eval losses.  ``initial`` replaces the seeded init (a tree
    of tensors, e.g. carried from the reference)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    full_f32()

    cfg, learners = build_housing_learners("100k", n_learners=4, seed=0, device=device)
    if initial is None:
        initial = mlp_model.init_params(torch.Generator().manual_seed(0), cfg, device)

    # ---- phase 1: secure synchronous rounds --------------------------------
    env = FederationEnv(
        protocol="sync", local_steps=6, batch_size=50, learning_rate=0.01,
        secure_aggregation=True,
        termination=TerminationCriteria(max_rounds=3),
        device=device,
    )
    driver = Driver(env)
    driver.controller.channel.codec = QuantCodec()
    driver.initialize(initial, learners)
    hist = driver.run()
    print("secure sync phase:")
    for h in hist:
        print(f"  round {h.round_id}: eval_loss={h.metrics['eval_loss']:.5f} "
              f"agg={h.aggregation_s:.4f}s")
    secure_params = driver.controller.global_params
    stats = driver.controller.channel.stats
    print(f"  wire: {stats.bytes_moved/1e6:.1f} MB over {stats.messages} msgs "
          f"(int8 codec)")

    # ---- phase 2: SECURE asynchronous continuation (a NEW task: fresh silos
    # with a different ground truth, warm-started from the secure phase's
    # model) — every community update opens a per-epoch mask session --------
    cfg2, learners2 = build_housing_learners("100k", n_learners=4, seed=1, device=device)
    ctrl = Controller(
        protocol=AsyncProtocol(local_steps=8, batch_size=50, learning_rate=0.01,
                               staleness_alpha=0.5),
        secure=True,
        device=device,
    )
    ctrl.set_initial_model(secure_params)
    with torch.no_grad():
        start = float(mlp_model.mse_loss(secure_params, learners2[0]._eval_data_fn()))
    for l in learners2:
        ctrl.register_learner(l)
    updates = ctrl.engine.run(total_updates=20)
    ctrl.shutdown()
    print(f"secure async phase: {len(updates)} community updates, "
          f"mean agg {np.mean([u.aggregation_s for u in updates])*1e3:.2f} ms")

    with torch.no_grad():
        final = float(mlp_model.mse_loss(ctrl.global_params,
                                         learners2[0]._eval_data_fn()))
    print(f"secure async adaptation: eval loss {start:.4f} -> {final:.4f}")
    assert final < start, "secure async federation must adapt to the new task"
    print("secure sync → secure async federation complete ✓")
    return {"driver": driver, "history": hist, "controller": ctrl, "updates": updates,
            "start": start, "final": final}


if __name__ == "__main__":
    main()
