"""Roofline terms: the reference's parser and formulas, and the port's cost count.

The port of ``repro/launch/roofline.py``.  Per (arch × shape × mesh):

    compute term    = FLOPs_per_chip / peak_FLOP/s
    memory term     = bytes_per_chip / HBM_bw
    collective term = collective_bytes_per_chip / link_bw

``CollectiveStats``, ``parse_collectives`` (a plain text parser over HLO:
per-op output bytes × a ring-algorithm multiplier × (g-1)/g for group size
g), ``roofline_terms`` and ``model_flops`` are the reference's as they are;
``roofline_terms``' default ``hw`` is the port's ``HARDWARE`` (the H100
SXM's), and either package's dict may be passed.

**The port's counterpart of ``compiled.cost_analysis()`` and
``memory_analysis()``** is :func:`step_costs`: it runs a function eagerly,
on ``meta`` tensors (no storage, no device time), and counts

* ``flops``: ``torch.utils.flop_counter.FlopCounterMode``'s count, which
  covers matrix products, convolutions and attention only (2 per
  multiply-add); XLA also counts elementwise work, reductions and
  transcendentals, so the port's count is the lower;
* ``bytes_accessed``: XLA's "bytes accessed" definition over aten ops — for
  every op, the bytes of its tensor inputs and outputs, a broadcast
  (stride-0) dimension counted once; views (``is_view`` ops and
  ``_unsafe_view``) and allocations without a write (``empty``) move
  nothing.  No fusion: each eager op reads and writes its tensors, where
  XLA counts a fused computation's operands and outputs once;
* ``argument_bytes``: the distinct storages of the arguments;
* ``peak_bytes``: the most bytes of distinct storages alive after any op
  (arguments plus every temporary not yet freed, autograd's saved tensors
  included), XLA's ``argument_size + temp_size`` counterpart.

Eager PyTorch runs every layer, so a count is the whole step's: XLA's
cost analysis counts a ``scan`` body once, which the reference's dry-run
corrects by lowering 1- and 2-cycle variants; the port needs no such
correction.
"""

from __future__ import annotations

import dataclasses
import math
import re
import weakref
from typing import NamedTuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.launch.mesh import HARDWARE

__all__ = ["CollectiveStats", "parse_collectives", "roofline_terms", "model_flops",
           "StepCosts", "step_costs"]

_SHAPE_RE = re.compile(r"([a-z0-9]+)\[([0-9,]*)\]")
_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}
# traffic multiplier per output byte for ring algorithms
_COLLECTIVES = {
    "all-reduce": 2.0,  # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,  # per-device sends ~input/g ... counted on output
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}
_GROUPS_ITOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")
_GROUPS_LIST_RE = re.compile(r"replica_groups=\{\{([0-9, ]+)\}")


@dataclasses.dataclass
class CollectiveStats:
    counts: dict[str, int]
    bytes_per_chip: dict[str, float]

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_per_chip.values())


def _line_out_bytes(line: str, op: str) -> float:
    """Bytes of the op's output type; handles tuple outputs like
    ``%x = (f32[2000]{0}, f32[]) all-reduce(...)``."""
    rhs = line.split("=", 1)[1]
    # shapes before the op invocation are the output type; after it, operands
    m = re.search(rf"\b{op}(-start|-done)?\(", rhs)
    head = rhs[: m.start()] if m else (rhs.split("(", 1)[0] if "(" in rhs else rhs)
    total = 0.0
    for dt, dims in _SHAPE_RE.findall(head):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str, default: int) -> int:
    m = _GROUPS_ITOTA_RE.search(line)
    if m:
        return int(m.group(2))
    m = _GROUPS_LIST_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    return default


def parse_collectives(hlo_text: str, n_devices: int) -> CollectiveStats:
    counts: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    bytes_pc: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    for line in hlo_text.splitlines():
        ls = line.strip()
        if "=" not in ls:
            continue
        for op, mult in _COLLECTIVES.items():
            # match op invocation, not metadata mentions
            if re.search(rf"= .*\b{op}(-start)?\(", ls) or re.search(
                rf"= {op}(-start)?\(", ls
            ):
                g = _group_size(ls, n_devices)
                if g <= 1:
                    continue
                out_b = _line_out_bytes(ls, op)
                counts[op] += 1
                bytes_pc[op] += out_b * mult * (g - 1) / g
                break
    return CollectiveStats(counts=counts, bytes_per_chip=bytes_pc)


def roofline_terms(
    flops_per_chip: float,
    bytes_per_chip: float,
    collective_bytes_per_chip: float,
    hw: dict | None = None,
) -> dict:
    hw = hw or HARDWARE
    compute_s = flops_per_chip / hw["peak_flops_bf16"]
    memory_s = bytes_per_chip / hw["hbm_bandwidth"]
    collective_s = collective_bytes_per_chip / hw["ici_link_bandwidth"]
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dominant = max(terms, key=terms.get)
    terms["dominant"] = dominant
    terms["bound_s"] = terms[dominant]
    return terms


def model_flops(n_params_active: int, n_tokens: int, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference forward passes."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_params_active * n_tokens


class StepCosts(NamedTuple):
    """What :func:`step_costs` counted."""

    flops: float
    bytes_accessed: float
    argument_bytes: int
    peak_bytes: int
    ops: int


# aten ops that allocate without writing, or alias their input without the
# schema saying so: no traffic.
_NO_TRAFFIC = {
    torch.ops.aten.empty, torch.ops.aten.empty_strided, torch.ops.aten.empty_like,
    torch.ops.aten.new_empty, torch.ops.aten.new_empty_strided, torch.ops.aten._unsafe_view,
}


def _tensors(tree) -> list[torch.Tensor]:
    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _distinct_bytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s elements, a stride-0 (broadcast) dimension once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


class _Traffic(TorchDispatchMode):
    """Adds up each aten op's input and output bytes, and the storages alive.

    A storage's Python object lives exactly as long as the storage (PyTorch
    preserves it while any tensor, autograd's saved ones included, holds the
    storage), so a weak reference's callback takes its bytes off the count
    the moment it is freed.
    """

    def __init__(self, args) -> None:
        super().__init__()
        self.bytes = 0
        self.ops = 0
        self.current = 0
        self._live: dict[int, weakref.ref] = {}
        for t in _tensors(args):
            self._track(t)
        self.argument_bytes = self.current
        self.peak = self.current

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return
        n = st.nbytes()

        def freed(_, key=key, n=n) -> None:
            self.current -= n
            del self._live[key]

        self._live[key] = weakref.ref(st, freed)
        self.current += n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.ops += 1
        if not func.is_view and func.overloadpacket not in _NO_TRAFFIC:
            self.bytes += sum(_distinct_bytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_distinct_bytes(t) for t in _tensors(out))
        for t in _tensors(out):
            self._track(t)
        self.peak = max(self.peak, self.current)
        return out


def step_costs(fn, *args, **kwargs) -> StepCosts:
    """Run ``fn(*args, **kwargs)`` (on ``meta`` tensors: nothing is computed
    or allocated) and count its FLOPs, bytes accessed, argument bytes and
    peak bytes alive, as the module docstring defines them."""
    traffic = _Traffic((args, kwargs))
    with FlopCounterMode(display=False) as flops, traffic:
        fn(*args, **kwargs)
    return StepCosts(flops=float(flops.get_total_flops()), bytes_accessed=float(traffic.bytes),
                     argument_bytes=int(traffic.argument_bytes), peak_bytes=int(traffic.peak),
                     ops=traffic.ops)
