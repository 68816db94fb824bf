"""The benchmark of the port's federation on one card.

    python3 fedbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of ``BENCHMARK.json`` from the root of a checkout: builds the
cell's federation from the seed, measures ``--seconds`` of it, checks what it
computed against the plain reference, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device`` and, traced, ``breakdown``; then ``card`` (name and power limit)
and, last, ``checks``: each compared number beside its limit, also printed as
the last lines of standard error.

Exits non-zero and prints no result without a CUDA card (or with fewer than
the cell asks for), without the port's package, for an unknown cell, or when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``repro`` was loaded.
"""

import time

PROCESS_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def fail(code: int, why: str) -> None:
    print(f"fedbench: {why}", file=sys.stderr, flush=True)
    sys.exit(code)


def loaded_forbidden() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & FORBIDDEN)


def power_limit() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else None


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    cache = ROOT / "build" / "fedbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from fedbench.harness import spec

    try:
        c = spec.load_cell(args.workload, ROOT)
    except spec.SpecError as exc:
        fail(2, str(exc))
    try:
        import torch

        from fedbench.harness import cell as cellmod
    except ImportError as exc:
        fail(3, f"cannot import the harness: {exc}")
    if not torch.cuda.is_available() or torch.cuda.device_count() < c.chips:
        fail(4, f"{args.workload} needs {c.chips} CUDA card(s); "
                f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    try:
        import repro_torch  # noqa: F401
    except ImportError as exc:
        fail(3, f"the port's package is not in this checkout: {exc}")

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    res = cellmod.run(c, args.seed, args.seconds, bool(args.trace), device, PROCESS_T0)
    info = res["info"]
    if args.trace:
        metrics = {}
        for m in c.per_layer:
            value = spec.metric_reader(m["name"])(info)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            else:
                cellmod.log(f"per-layer metric {m['name']}: nothing to read in this run")
    else:
        e2e = cellmod.end_to_end(info, res["setup_s"])
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in c.end_to_end}
    bad = loaded_forbidden()
    if bad:
        fail(5, f"modules of {bad} were loaded in the measuring process")

    line = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics,
            "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                       "count": c.chips, "memory_peak_bytes": res["memory_peak_bytes"]}}
    if args.trace and info.trace is not None:
        line["device"]["busy_s"] = info.trace.busy_s
        line["device"]["window_s"] = info.trace.window_s
        line["breakdown"] = {"device_ops": info.trace.top_ops(),
                             "idle_gaps": info.trace.idle_gaps(info.records)}
    line["card"] = {"name_power_limit": power_limit(), "setup_s": res["setup_s"],
                    "window_s": info.window_s, "steps": res["attempted"],
                    "eval_loss": res["eval_loss"], "readings": res["readings"],
                    "leaves_left_out": res["left_out"], "setup_phases": res["setup_phases"],
                    "schedule": res["schedule"], "rounds": res["rounds"]}
    line["checks"] = res["checks"]
    for name, v in res["checks"].items():
        cellmod.log(f"check {name} {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
