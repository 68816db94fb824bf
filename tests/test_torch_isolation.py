"""The port stands alone: no JAX, nothing of the reference, no silent CPU.

A fresh interpreter imports every module of ``repro_torch`` and must end
with neither ``jax`` nor ``repro`` loaded; a source scan pins the same rule
for every file of the port, its example scripts (``examples/torch_*.py``)
and ``chip_smoke.py``; and the default device is the card, never a silent
fallback to the host, for the entry points and the example scripts alike.
"""

import importlib.util
import pathlib
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.core.store import ArenaStore
from repro_torch.core.transport import Channel
from repro_torch.device import resolve_device
from repro_torch.kernels.ops import QuantCodec

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 20, names
assert {"repro_torch.core.faults", "repro_torch.kernels.robust", "repro_torch.core.secure",
        "repro_torch.core.naive", "repro_torch.checkpoint.checkpoint",
        "repro_torch.optim.optimizers", "repro_torch.models.transformer",
        "repro_torch.launch.steps"} <= set(names), names
"""


def test_port_imports_neither_jax_nor_reference():
    proc = subprocess.run(
        [sys.executable, "-c", _IMPORT_ALL],
        capture_output=True, text=True, timeout=300,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+jaxlib\b|from\s+jaxlib\b"
    r"|import\s+repro(\.|\s|$)|from\s+repro(\.|\s))",
    re.MULTILINE,
)


EXAMPLES = ("torch_quickstart", "torch_fed_lm_e2e", "torch_secure_async_fl",
            "torch_serve_multiarch")


def test_source_scan_has_no_forbidden_imports():
    scripts = sorted((ROOT / "examples").glob("torch_*.py"))
    assert [p.stem for p in scripts] == sorted(EXAMPLES)
    files = sorted(PORT.rglob("*.py")) + scripts + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        hits = _FORBIDDEN.findall(path.read_text())
        assert not hits, f"{path.relative_to(ROOT)} imports {hits}"


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    # The int8 entry points: the card by default, the host only when asked.
    for make in (lambda **kw: ArenaStore(num_params=300, arena_dtype="int8", **kw),
                 lambda **kw: Channel(upload_codec="int8", **kw),
                 lambda **kw: Channel(quantize_codec=QuantCodec(), **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(device="cuda")
    arena = ArenaStore(num_params=300, arena_dtype="int8", device="cpu")
    assert arena.buffer.device.type == arena.scales.device.type == "cpu"
    up = Channel(upload_codec="int8", device="cpu")
    row = up.recv_upload(up.upload(torch.ones(300)))
    assert row.device.type == "cpu" and row.shape == (300,)
    down = Channel(quantize_codec=QuantCodec(), device="cpu")
    got = down.recv(down.broadcast({"w": torch.ones(300)}).to())
    assert got["w"].device.type == "cpu"


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_scripts_default_to_the_card(monkeypatch, name):
    """Without CUDA a port script raises unless given ``--device cpu``; it
    never carries on with the host."""
    spec = importlib.util.spec_from_file_location(f"_isolation_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            script.main(argv)
    if name == "torch_serve_multiarch":
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            script.serve("gemma3-4b")
