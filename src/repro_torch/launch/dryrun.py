"""Dry-run: the counted costs of every (architecture × input shape) step on one
H100, and one chip's share of a pod's aggregate run on the card.

The port of ``repro/launch/dryrun.py``.  The reference lowers and compiles
each step for the 256- and 512-chip production meshes and reads XLA's cost
and memory analyses; the port has no counterpart of that pod lowering (no
compile times, no HLO, no per-chip terms of a model step on 256 or 512
chips), so asking for it (``multi_pod=True`` or ``hlo_dir`` in
:func:`dryrun_one`, ``--save-hlo``, ``--multi-pod`` without ``--agg``)
raises ``ValueError``.  What it has:

* :func:`dryrun_one` — **one H100**, no policy (one card runs no model
  axis): the real step of ``launch/steps.py`` at the shape's full
  ``global_batch`` and ``seq_len``, run on ``meta`` tensors (no memory, no
  device) under ``launch/roofline.step_costs``, which counts its FLOPs,
  bytes accessed, argument bytes and peak bytes alive.  Eager PyTorch runs
  every layer, so the count is the whole step's and needs none of the
  reference's depth-differencing (XLA counts a ``scan`` body once).  The
  record keeps the reference's field names where a counterpart exists and
  adds ``fits`` (the peak within the card's memory).  The MoE archs run
  every expert on every token here (``layers.apply_moe_dense``), so their
  ``useful_flops_ratio`` is low: about top-k / experts of the routed work
  is useful.
* :func:`dryrun_aggregation` — **runs on the card**: the paper's Fig. 4
  workload at pod scale, one chip's share of it.  The pod's ``(N, P_pad)``
  stack is split over its 256 or 512 chips along ``P``; the share,
  ``(N, P_pad / chips)``, is seeded on the device and reduced by
  ``core/aggregation.weighted_average`` (kernel 2, ``fedavg_cuda``, on the
  card), timed with CUDA events.  The hierarchical mode runs
  ``core/aggregation.hierarchical_fedavg`` over a ``(2, 16, 16)`` slot mesh
  of the device on the ``(2, P_pad)`` stack, each slot's window of
  ``P_pad / 256`` columns the width one chip holds of its pod's row in the
  reference.  A stack and output row past ``HARDWARE["hbm_bytes"]`` raise
  before anything is allocated.

Importing this module sets nothing and runs nothing.  Usage:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all          # host sweep on meta
    PYTHONPATH=src python -m repro_torch.launch.dryrun --agg          # every arch, 16x16, card
    PYTHONPATH=src python -m repro_torch.launch.dryrun --agg --multi-pod --hierarchical

Records append to ``<out-dir>/1xH100.jsonl`` and
``<out-dir>/agg_<mesh>_h100.jsonl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import time
import traceback

import torch

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_config, shape_applicable
from repro_torch.device import resolve_device
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import HARDWARE, make_production_mesh
from repro_torch.launch.specs import input_specs
from repro_torch.launch.steps import make_prefill_step, make_serve_step, make_train_step
from repro_torch.models.config import ModelConfig
from repro_torch.models.sharding import make_policy

# per-arch training-policy overrides (memory-driven)
ARCH_OVERRIDES: dict[str, dict] = {
    "deepseek-v3-671b": {"param_dtype": torch.bfloat16},
}
ARCH_OPTIMIZER: dict[str, str] = {
    # adafactor for the configs whose full Adam state cannot fit 16 GB/chip
    "deepseek-v3-671b": "adafactor",
    "qwen2-72b": "adafactor",
    "llava-next-34b": "adafactor",
}
MESH_NAME = "1xH100"
# Timed calls of the aggregate, after one untimed call.
AGG_REPEATS = 5


def _arch_config(arch: str, kind: str = "train") -> ModelConfig:
    cfg = get_config(arch)
    if arch in ARCH_OVERRIDES:
        cfg = dataclasses.replace(cfg, **ARCH_OVERRIDES[arch])
    if kind in ("decode", "prefill"):
        # serving layout: bf16 weights, stationary on-chip — no optimizer
        # state exists, so FSDP gathering is pure overhead.
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
    return cfg


def _serving_fsdp(arch: str, kind: str) -> bool | None:
    """FSDP only where even bf16 weights exceed the model-axis share.

    None -> make_policy heuristic (training).  Serving: False (replicate
    over data, shard over model) except deepseek-v3, whose 1.34 TB of bf16
    experts must stay sharded over both axes.
    """
    if kind != "decode":
        # train AND prefill use the heuristic: weight gathers amortize over
        # the whole sequence of compute.
        return None
    # decode: weights-stationary unless even bf16 weights exceed the
    # model-axis share when replicated over data.
    return arch in ("deepseek-v3-671b", "qwen2-72b")


def active_params(cfg: ModelConfig) -> int:
    """Per-token active parameters (MoE: top-k + shared experts only)."""
    if not cfg.n_experts:
        return cfg.param_count_estimate()
    total = cfg.param_count_estimate()
    E = cfg.padded_n_experts
    D, F = cfg.d_model, cfg.moe_d_ff
    moe_layers = sum(1 for s in cfg.layer_specs() if s.moe)
    all_expert = moe_layers * E * 3 * D * F
    active_expert = moe_layers * cfg.top_k * 3 * D * F
    return int(total - all_expert + active_expert)


def _not_ported(what: str) -> ValueError:
    return ValueError(f"{what}: the pod lowering (256/512-chip compile, its HLO and "
                      "per-chip model-step terms) is not ported; one H100 is counted "
                      "instead (dryrun_one) and one chip's share of the aggregate runs "
                      "on it (dryrun_aggregation)")


def _step_costs(cfg: ModelConfig, shape: str, opt_name: str) -> rl.StepCosts:
    """The step of ``shape``'s kind on ``meta`` inputs, counted."""
    kind = INPUT_SHAPES[shape]["kind"]
    ins = input_specs(cfg, make_policy(cfg, None), shape, optimizer_name=opt_name)
    if kind == "train":
        return rl.step_costs(make_train_step(cfg, ins["optimizer"]),
                             ins["params"], ins["opt_state"], ins["batch"])
    if kind == "prefill":
        return rl.step_costs(make_prefill_step(cfg), ins["params"], ins["batch"])
    args = [ins["params"], ins["caches"], ins["tokens"], ins["pos"]]
    if cfg.is_encoder_decoder:
        args.append(ins["memory"])
    return rl.step_costs(make_serve_step(cfg), *args)


def dryrun_one(arch: str, shape: str, multi_pod: bool = False,
               hlo_dir: str | None = None) -> dict:
    """Count one (arch, shape) step on one H100; return the record."""
    if multi_pod:
        raise _not_ported("multi_pod=True")
    if hlo_dir:
        raise _not_ported("hlo_dir")
    kind = INPUT_SHAPES[shape]["kind"]
    cfg = _arch_config(arch, kind)
    opt_name = ARCH_OPTIMIZER.get(arch, "adamw")
    record = {
        "arch": arch, "shape": shape, "kind": kind, "mesh": MESH_NAME, "n_devices": 1,
        "fsdp": False, "optimizer": opt_name if kind == "train" else None,
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    ok, reason = shape_applicable(arch, shape)
    if not ok:
        record.update(status="skipped", reason=reason)
        return record

    t0 = time.perf_counter()
    costs = _step_costs(cfg, shape, opt_name)
    count_s = time.perf_counter() - t0
    terms = rl.roofline_terms(costs.flops, costs.bytes_accessed, 0.0)

    # MODEL_FLOPS: useful-math floor
    n_params = cfg.param_count_estimate()
    n_active = active_params(cfg)
    B, S = INPUT_SHAPES[shape]["global_batch"], INPUT_SHAPES[shape]["seq_len"]
    tokens = B * S if kind in ("train", "prefill") else B  # decode: 1 tok/seq
    mf = rl.model_flops(n_active, tokens, kind)
    record.update(
        status="ok",
        count_s=count_s,
        ops=costs.ops,
        n_params=n_params,
        n_params_active=n_active,
        argument_size_bytes=costs.argument_bytes,
        peak_bytes_per_chip=costs.peak_bytes,
        hbm_per_chip=HARDWARE["hbm_bytes"],
        fits=costs.peak_bytes <= HARDWARE["hbm_bytes"],
        flops_per_chip=costs.flops,
        bytes_per_chip=costs.bytes_accessed,
        collective_bytes_per_chip=0.0,
        model_flops_global=mf,
        model_flops_per_chip=mf,
        useful_flops_ratio=(mf / costs.flops) if costs.flops else None,
        **terms,
    )
    return record


def aggregation_inputs(rows: int, width: int, device: torch.device,
                       seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(rows, width)`` f32 stack (standard normal) and ``(rows,)``
    weights (uniform in [0.05, 1.05)) that :func:`dryrun_aggregation` reduces,
    drawn from ``seed`` by a generator on ``device``: the same call gives the
    same values."""
    gen = torch.Generator(device=device).manual_seed(seed)
    stack = torch.randn((rows, width), generator=gen, device=device)
    weights = torch.rand((rows,), generator=gen, device=device) + 0.05
    return stack, weights


def _timed_ms(fn, device: torch.device, repeats: int) -> tuple[torch.Tensor, list[float]]:
    """``fn()``'s result and the milliseconds of ``repeats`` more calls (CUDA
    events on the card, the host clock on the CPU)."""
    out = fn()
    samples = []
    for _ in range(repeats):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            samples.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            out = fn()
            samples.append((time.perf_counter() - t0) * 1e3)
    return out, samples


def _aggregate(arch: str, n_learners: int, multi_pod: bool, hierarchical: bool,
               device, seed: int) -> tuple[dict, torch.Tensor]:
    """:func:`dryrun_aggregation`'s record and the aggregate it computed."""
    from repro_torch.core import aggregation

    dev = resolve_device(device)
    cfg = _arch_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    n_devices = mesh.devices.size
    P_total = cfg.param_count_estimate()
    # pad P to divisibility over all mesh axes
    P_pad = ((P_total + n_devices - 1) // n_devices) * n_devices
    share = P_pad // n_devices
    if hierarchical:
        if not multi_pod:
            raise ValueError("hierarchical aggregation needs the pod axis (multi_pod=True)")
        # the pods' rows, whole: the card runs every slot's window
        rows, width, chips = mesh.shape["pod"], P_pad, n_devices
    else:
        rows, width, chips = n_learners, share, 1  # one chip's share
    need = (rows + 1) * width * 4
    if need > HARDWARE["hbm_bytes"]:
        raise ValueError(
            f"fedavg-{arch} on {'2x16x16' if multi_pod else '16x16'}: the ({rows}, {width}) "
            f"f32 stack and its output row take {need:,} bytes, past the card's "
            f"{HARDWARE['hbm_bytes']:,}")

    record = {
        "arch": f"fedavg-{arch}", "shape": f"N{n_learners}",
        "kind": "aggregate", "mesh": "2x16x16" if multi_pod else "16x16",
        "n_devices": n_devices, "n_params": P_total,
        "hierarchical": hierarchical, "status": "ok",
        "device": str(dev), "seed": seed, "P_pad": P_pad, "share": share,
        "stack_shape": [rows, width],
    }
    stack, weights = aggregation_inputs(rows, width, dev, seed)
    fn = (aggregation.hierarchical_fedavg(mesh) if hierarchical
          else aggregation.weighted_average)
    out, samples = _timed_ms(lambda: fn(stack, weights), dev, AGG_REPEATS)
    must_move = rows * width * 4 + width * 4 + rows * 4  # stack and weights read, row written
    flops = 2.0 * rows * width
    record.update(
        peak_bytes_per_chip=(stack.nbytes + weights.nbytes + out.nbytes) / chips,
        flops_per_chip=flops / chips, bytes_per_chip=must_move / chips,
        collective_bytes_per_chip=0.0,
        # one card: the slots' sums are its own, no collective runs
        collective_counts_full_hlo=dict.fromkeys(rl._COLLECTIVES, 0),
        # analytic floor: read N·P + write P floats per chip-share
        model_bytes_per_chip=(n_learners + 1) * P_pad * 4 / n_devices
        if not hierarchical else 2 * P_pad * 4 / n_devices,
        aggregate_ms=statistics.median(samples), aggregate_ms_samples=samples,
        aggregate_bound_ms=must_move / HARDWARE["hbm_bandwidth"] * 1e3,
    )
    terms = rl.roofline_terms(record["flops_per_chip"], record["model_bytes_per_chip"], 0.0)
    record.update(**terms)
    del stack, weights
    return record, out


def dryrun_aggregation(arch: str, n_learners: int, multi_pod: bool,
                       hierarchical: bool = False, *, device: str | torch.device | None = None,
                       seed: int = 0) -> dict:
    """One chip's share of the controller's aggregation of ``arch``'s packed
    parameters on a production mesh, run on ``device`` (the card unless the
    caller asks for the CPU) from inputs drawn from ``seed``.

    Paper-faithful mode: the ``(n_learners, P_pad / chips)`` share through
    ``weighted_average`` — zero collectives.  Hierarchical mode: the
    ``(2, P_pad)`` stack, one row a pod, through ``hierarchical_fedavg`` over
    a ``(2, 16, 16)`` slot mesh of the device; the per-chip fields divide
    the pod's work by its 512 chips.  Raises ``ValueError``, before
    allocating, when the stack and its output row exceed the card's memory.
    """
    record, _ = _aggregate(arch, n_learners, multi_pod, hierarchical, device, seed)
    return record


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ARCHITECTURES)
    ap.add_argument("--shape", choices=list(INPUT_SHAPES))
    ap.add_argument("--agg", action="store_true",
                    help="run one chip's share of the controller's aggregation instead")
    ap.add_argument("--agg-learners", type=int, default=8)
    ap.add_argument("--hierarchical", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--out-dir", default="experiments/dryrun")
    ap.add_argument("--save-hlo", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where --agg runs (default: the CUDA card; 'cpu' for the host)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.save_hlo:
        raise SystemExit(str(_not_ported("--save-hlo")))
    if args.multi_pod and not args.agg:
        raise SystemExit(str(_not_ported("--multi-pod without --agg")))

    os.makedirs(args.out_dir, exist_ok=True)
    mesh_tag = "2x16x16" if args.multi_pod else "16x16"
    if args.agg:
        out_path = os.path.join(args.out_dir, f"agg_{mesh_tag}_h100.jsonl")
        archs = [args.arch] if args.arch else list(ARCHITECTURES)
        for arch in archs:
            try:
                rec = dryrun_aggregation(arch, args.agg_learners, args.multi_pod,
                                         args.hierarchical, device=args.device, seed=args.seed)
            except Exception as e:  # noqa: BLE001 — record and continue the sweep
                rec = {"arch": f"fedavg-{arch}", "status": "error", "error": repr(e)}
            with open(out_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
            if rec["status"] == "ok":
                print(
                    f"agg {arch}: P={rec['n_params']/1e9:.1f}B share={rec['share']} "
                    f"ms={rec['aggregate_ms']:.4f} bound_ms={rec['aggregate_bound_ms']:.4f} "
                    f"mem={rec['memory_s']*1e3:.2f}ms "
                    f"colls={sum(rec['collective_counts_full_hlo'].values())}",
                    flush=True,
                )
            else:
                print(f"agg {arch}: {rec.get('error')}", flush=True)
        return

    if args.all:
        combos = [(a, s) for a in ARCHITECTURES for s in INPUT_SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all")
        combos = [(args.arch, args.shape)]
    out_path = os.path.join(args.out_dir, f"{MESH_NAME}.jsonl")
    for arch, shape in combos:
        print(f"=== {arch} × {shape} × {MESH_NAME} ===", flush=True)
        try:
            rec = dryrun_one(arch, shape)
        except Exception as e:  # noqa: BLE001 — record and continue the sweep
            rec = {
                "arch": arch, "shape": shape, "mesh": MESH_NAME,
                "status": "error", "error": repr(e),
                "traceback": traceback.format_exc()[-2000:],
            }
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        if rec["status"] == "ok":
            print(
                f"  ok: count={rec['count_s']:.1f}s "
                f"peak={rec['peak_bytes_per_chip']/2**30:.2f}GiB fits={rec['fits']} "
                f"compute={rec['compute_s']*1e3:.2f}ms "
                f"memory={rec['memory_s']*1e3:.2f}ms "
                f"dominant={rec['dominant']} useful={rec['useful_flops_ratio']:.3f}",
                flush=True,
            )
        else:
            print(f"  {rec['status']}: {rec.get('reason', rec.get('error'))}", flush=True)


if __name__ == "__main__":
    main()
