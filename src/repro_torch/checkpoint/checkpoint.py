"""Federation checkpointing: packed model + controller state → ``.npz``.

The port of ``repro/checkpoint/checkpoint.py``.  The checkpoint is the wire
format: the packed numeric buffer plus the manifest (names, shapes, dtypes,
offsets), the same representation the controller aggregates and ships.
Server-optimizer state and round counters ride along so an interrupted
federation resumes exactly.  Files are named ``ckpt_%08d.npz`` and hold the
reference's keys: ``buffer``, ``manifest`` (a pickle of the port's
:class:`~repro_torch.core.packing.Manifest`), ``meta`` (JSON) and
``extra__*``.  Tensors leave the card with ``.cpu().numpy()``; the restored
model goes back to the caller's device.
"""

from __future__ import annotations

import json
import os
import pickle
import re
from typing import Any

import numpy as np
import torch

from repro_torch.core import packing
from repro_torch.device import resolve_device

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step"]

_FNAME = re.compile(r"ckpt_(\d+)\.npz$")


def _host(value: Any) -> np.ndarray:
    """A tensor, numpy array or Python scalar as a host numpy array."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def save_checkpoint(
    directory: str,
    step: int,
    params: Any,
    extra_arrays: dict[str, Any] | None = None,
    metadata: dict | None = None,
) -> str:
    """Write ``ckpt_{step:08d}.npz`` under ``directory``; returns its path."""
    os.makedirs(directory, exist_ok=True)
    buf = _host(packing.pack_numeric(params))
    manifest = packing.build_manifest(params)
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    payload = {"buffer": buf}
    for k, v in (extra_arrays or {}).items():
        payload[f"extra__{k}"] = _host(v)
    np.savez(
        path,
        manifest=np.frombuffer(pickle.dumps(manifest), dtype=np.uint8),
        meta=np.frombuffer(
            json.dumps({"step": step, **(metadata or {})}).encode(), dtype=np.uint8
        ),
        **payload,
    )
    return path


def restore_checkpoint(directory: str, step: int | None = None,
                       device: str | torch.device | None = None):
    """Returns ``(params, extra_arrays, metadata)``: the params on ``device``
    (the card unless told otherwise), the extras as host numpy arrays."""
    device = resolve_device(device)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = os.path.join(directory, f"ckpt_{step:08d}.npz")
    with np.load(path) as z:
        manifest = pickle.loads(z["manifest"].tobytes())
        meta = json.loads(z["meta"].tobytes().decode())
        params = packing.unpack_numeric(torch.from_numpy(z["buffer"]).to(device), manifest)
        extras = {
            k[len("extra__"):]: z[k] for k in z.files if k.startswith("extra__")
        }
    return params, extras, meta


def latest_step(directory: str) -> int | None:
    """The highest checkpointed step under ``directory`` (None if none)."""
    if not os.path.isdir(directory):
        return None
    steps = [
        int(m.group(1))
        for f in os.listdir(directory)
        if (m := _FNAME.match(f))
    ]
    return max(steps) if steps else None
