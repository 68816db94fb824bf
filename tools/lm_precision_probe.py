"""One fedlm-100m learner's local SGD steps on each device and dtype, from
one initial model and one batch stream: how far each run strays from the
f32 run on the host.

    PYTHONPATH=src python tools/lm_precision_probe.py --devices cuda cpu --layers 8 --steps 8

The learners are ``examples/torch_fed_lm_e2e.py``'s (8 silos of 48
sequences of 48 tokens, ``sgd(0.3)``, batch 16); learner 0's ``fit`` runs
one local step at a time from ``transformer.init_params`` of a host
generator seeded 0, so every run starts from the same model and draws the
same batches.  Prints one JSON line a device and dtype: each step's train
loss, and after the last step the relative distance ``|p - p_ref| /
|p_ref - p_0|`` of its params from the host's f32 run's (``p_0`` the initial
model), over all params.
"""

import argparse
import dataclasses
import json
import time

import torch

from repro_torch.configs.fedlm_100m import config as fedlm_config
from repro_torch.core.packing import pack_numeric
from repro_torch.core.scheduler import TrainTask
from repro_torch.device import full_f32, resolve_device
from repro_torch.launch.train import build_lm_learners
from repro_torch.models import transformer
from repro_torch.optim import sgd


def local_steps(device: str, dtype: torch.dtype, layers: int, steps: int) -> dict:
    device = resolve_device(device)
    cfg = dataclasses.replace(fedlm_config(), n_layers=layers, dtype=dtype)
    learner = build_lm_learners(cfg, 8, seed=0, n_seq_per_learner=48, seq_len=48,
                                optimizer=sgd(0.3), device=device)[0]
    params = transformer.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    start = pack_numeric(params).double()
    losses = []
    t0 = time.perf_counter()
    for step in range(steps):
        update = learner.fit(params, TrainTask(round_id=step, local_steps=1, batch_size=16,
                                               learning_rate=0.3))
        params = update.params
        losses.append(update.metrics["train_loss"])
    return {"device": device.type, "dtype": str(dtype).removeprefix("torch."),
            "train_loss": losses, "seconds": time.perf_counter() - t0,
            "params": pack_numeric(params).double().cpu(), "start": start}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    full_f32()
    ref = local_steps("cpu", torch.float32, args.layers, args.steps)
    ref_params, start = ref.pop("params"), ref.pop("start")
    moved = torch.linalg.vector_norm(ref_params - start)
    for device in args.devices:
        for dtype in (torch.float32, torch.bfloat16):
            if (device, dtype) == ("cpu", torch.float32):
                run, gap = ref, 0.0
            else:
                run = local_steps(device, dtype, args.layers, args.steps)
                run.pop("start")
                gap = float(torch.linalg.vector_norm(run.pop("params") - ref_params) / moved)
            print(json.dumps({**run, "layers": args.layers, "distance_from_host_f32": gap}),
                  flush=True)


if __name__ == "__main__":
    main()
