"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the program.  Names are compared whole by their top-level
part: ``repro_torch`` is the port, ``repro`` the JAX package."""

from __future__ import annotations

import ast
import importlib.util
import json
import pathlib
import subprocess
import sys

from fedbench.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
REF_DIR = spec.BENCH_DIR / "reference"


def _top_levels_after(code: str) -> set[str]:
    """Top-level module names loaded by a fresh interpreter running ``code``."""
    probe = code + "\nimport sys, json\nprint(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         cwd=spec.ROOT, timeout=600,
                         env={"PYTHONPATH": f"{spec.ROOT}:{spec.ROOT / 'src'}", "PATH": "/usr/bin:/bin",
                              "OMP_NUM_THREADS": "2"})
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_toy_run_loads_no_jax_nor_the_jax_package():
    loaded = _top_levels_after(
        "import time, torch\n"
        "from fedbench.tests.toy import toy_cell\n"
        "from fedbench.harness import cell\n"
        "c = toy_cell('lm-sync-f32')\n"
        "cell.run(c, 3, 0.1, False, torch.device('cpu'), time.perf_counter())\n")
    assert "repro_torch" in loaded and "fedbench" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_levels_after("import fedbench.reference.fl, fedbench.reference.model")
    assert not loaded & (FORBIDDEN | {"repro_torch"})


def test_the_reference_sources_import_only_torch_and_themselves():
    for path in REF_DIR.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top in {"torch", "math", "dataclasses", "typing", "__future__"} or \
                    name.startswith("fedbench.reference"), (path.name, name)


def test_the_entry_point_compares_whole_top_level_names():
    spec_ = importlib.util.spec_from_file_location("fedbench_run_entry", spec.BENCH_DIR / "run.py")
    run = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(run)
    saved = dict(sys.modules)
    try:
        sys.modules["repro_torch_probe_only"] = sys
        assert "repro" not in run.loaded_forbidden()
        sys.modules["repro.probe"] = sys
        assert "repro" in run.loaded_forbidden()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_a_directory_of_only_the_benchmark_exits_without_a_result(tmp_path: pathlib.Path):
    import shutil

    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(spec.BENCH_DIR, tmp_path / "fedbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "fedbench/run.py", "--workload", "lm-sync-f32",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
