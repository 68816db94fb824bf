"""Run one package's fed_lm_e2e example at fedlm-100m's widths with fewer
layers, from one initial model, and compare two such runs.

    # the reference's script, 2 of its 8 layers, f32, 2 rounds, its other defaults
    PYTHONPATH=src python tools/fed_lm_e2e_probe.py --package reference --layers 2 \\
        --dtype float32 --out ref.npz -- --rounds 2
    # the port's script from the same initial model, on the host
    PYTHONPATH=src python tools/fed_lm_e2e_probe.py --package port --layers 2 \\
        --dtype float32 --init ref.npz --out port.npz -- --rounds 2 --device cpu
    python tools/fed_lm_e2e_probe.py --compare ref.npz port.npz

``examples/fed_lm_e2e.py`` (``--package reference``) or
``examples/torch_fed_lm_e2e.py`` (``--package port``) runs as its ``main``
runs, with the arguments after ``--`` and ``fedlm_config`` replaced by
fedlm-100m at ``--layers`` layers and ``--dtype`` compute (``model`` keeps
the config's own).  Each process imports only the package its script
imports.  ``--out`` keeps the initial global buffer, round 0's aggregate and
new global buffer, every round's eval loss and whether the script's own
assertion held.  ``--compare`` prints one JSON line: the initial buffers'
equality, round 0's aggregates and new buffers against rtol 1e-4 / atol
1e-5 (the bar of ``tests/test_torch_lm_federation.py``), and each run's
losses.
"""

import argparse
import dataclasses
import importlib.util
import json
import pathlib
import sys
import time
import types

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]
SCRIPTS = {"reference": "fed_lm_e2e", "port": "torch_fed_lm_e2e"}


def _load(name: str):
    spec = importlib.util.spec_from_file_location(f"probe_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run(package: str, layers: int, dtype: str, init: str | None, out: str,
        script_args: list[str]) -> None:
    script = _load(SCRIPTS[package])
    base_config = script.fedlm_config
    if dtype == "model":
        compute = base_config().dtype
    elif package == "reference":
        compute = getattr(script.jax.numpy, dtype)
    else:
        compute = getattr(script.torch, dtype)
    script.fedlm_config = lambda: dataclasses.replace(base_config(), n_layers=layers,
                                                      dtype=compute)
    steps, seen = [], []

    class Recorded(script.Driver):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            seen.append(self)
            opt = self.controller.server_opt

            def recorded(state, x_global, x_agg):
                state, new = opt.apply(state, x_global, x_agg)
                if not steps:
                    steps.append([np.array(_host(x)) for x in (x_global, x_agg, new)])
                return state, new

            self.controller.server_opt = dataclasses.replace(opt, apply=recorded)

        def run(self):
            self.history = super().run()
            return self.history

    script.Driver = Recorded
    held = True
    t0 = time.perf_counter()
    try:
        if package == "reference":
            sys.argv = [f"{SCRIPTS[package]}.py", *script_args]
            script.main()
        else:
            if init is not None:  # the other run's initial buffer in this run's layout
                from repro_torch.core import packing

                with np.load(init) as z:
                    buf = script.torch.from_numpy(z["init"])
                seeded = script.transformer.init_params

                def carried(generator, cfg, device):
                    layout = packing.build_manifest(seeded(generator, cfg, "cpu"))
                    return packing.unpack_numeric(buf.to(device), layout)

                script.transformer = types.SimpleNamespace(init_params=carried)
            script.main(script_args)
    except AssertionError as err:
        print(f"own assertion: {err}")
        held = False
    (driver,) = seen
    losses = [h.metrics["eval_loss"] for h in driver.history]
    (x_global, x_agg, new), = steps
    np.savez(out, init=x_global, aggregate0=x_agg, new0=new, eval_loss=np.array(losses),
             assertion_held=np.array(held))
    print(json.dumps({"package": package, "layers": layers, "dtype": dtype,
                      "args": script_args, "params": int(x_global.size),
                      "eval_loss": losses, "assertion_held": held,
                      "seconds": time.perf_counter() - t0}))


def _host(x):
    """A jax array or a tensor as numpy."""
    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def compare(a: str, b: str) -> None:
    with np.load(a) as za, np.load(b) as zb:
        line = {"init_equal": bool(np.array_equal(za["init"], zb["init"]))}
        for key in ("aggregate0", "new0"):
            gap = np.abs(zb[key] - za[key])
            over = gap > 1e-5 + 1e-4 * np.abs(za[key])
            line[key] = {"max_abs_gap": float(gap.max()), "beyond_bar": int(over.sum()),
                         "of": int(gap.size),
                         "worst_over_bar": float((gap / (1e-5 + 1e-4 * np.abs(za[key]))).max())}
        for name, z in ((a, za), (b, zb)):
            losses = z["eval_loss"].tolist()
            line[name] = {"eval_loss": losses, "assertion_held": bool(z["assertion_held"]),
                          "loss_rose": losses[-1] >= losses[0]}
    print(json.dumps(line))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    script_args = argv[argv.index("--") + 1:] if "--" in argv else []
    argv = argv[:argv.index("--")] if "--" in argv else argv
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=sorted(SCRIPTS))
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--dtype", default="model", choices=["model", "float32", "bfloat16"])
    ap.add_argument("--init", help="an --out file whose initial buffer the port starts from")
    ap.add_argument("--out")
    ap.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    if args.compare:
        compare(*args.compare)
    else:
        run(args.package, args.layers, args.dtype, args.init, args.out, script_args)


if __name__ == "__main__":
    main()
