"""Oracles for the port's kernels: torch f32 references and f64 numpy ones.

The port of ``repro/kernels/ref.py`` for the ported kernels.  The f32
references are the kernels' plain versions in :mod:`repro_torch.kernels.fedavg`
and :mod:`repro_torch.kernels.quantize`/``fused_agg`` under the reference's
names (and :mod:`repro_torch.kernels.robust`'s sort-then-trim), so there is
one plain version to keep in step.
The f64 versions are independent host numpy, genuine f64 whatever the device.

One deliberate difference: :func:`fedavg_ref` normalizes like the
controller's ``aggregation._normalize`` (uniform weights when they sum to 0)
instead of the reference oracle's unguarded ``w / sum(w)``; the two agree
whenever the weights sum to a positive number.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.fedavg import fedavg_torch as fedavg_ref
from repro_torch.kernels.fedavg import masked_fedavg_torch as masked_fedavg_ref
from repro_torch.kernels.fused_agg import masked_fedavg_q8_torch as masked_fedavg_q8_ref
from repro_torch.kernels.quantize import dequantize_torch as dequantize_ref
from repro_torch.kernels.quantize import quantize_torch as quantize_ref
from repro_torch.kernels.robust import masked_trimmed_mean_torch as masked_trimmed_mean_ref

__all__ = [
    "fedavg_ref", "masked_fedavg_ref", "masked_fedavg_q8_ref", "masked_trimmed_mean_ref",
    "quantize_ref", "dequantize_ref", "fedavg_f64", "masked_fedavg_f64",
    "masked_fedavg_q8_f64", "masked_trimmed_mean_f64",
]


def _f64(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().to(torch.float64).numpy()
    return np.asarray(x, np.float64)


def fedavg_f64(stack, weights) -> np.ndarray:
    """Host f64 oracle of :func:`fedavg_ref` (uniform when the weights sum to 0)."""
    rows, w = _f64(stack), _f64(weights)
    total = float(w.sum())
    w = w / total if total > 0 else np.full_like(w, 1.0 / max(w.shape[0], 1))
    return w @ rows


def masked_fedavg_f64(arena, weights, mask) -> np.ndarray:
    """Host f64 oracle of :func:`masked_fedavg_ref`."""
    rows, m = _f64(arena), _f64(mask)
    w = _f64(weights) * m
    total = float(w.sum())
    w = w / total if total > 0 else m / max(float(m.sum()), 1.0)
    rows = np.where(m[:, None] > 0, rows, 0.0)
    return w @ rows


def masked_fedavg_q8_f64(q, scales, weights, mask, group: int = 256) -> np.ndarray:
    """Host f64 oracle of the fused dequant-into-aggregate: dequantize each row
    exactly, then :func:`masked_fedavg_f64`."""
    qh, sh = _f64(q), _f64(scales)
    n, p = qh.shape
    rows = (qh.reshape(n, p // group, group) * sh[:, :, None]).reshape(n, p)
    return masked_fedavg_f64(rows, weights, mask)


def masked_trimmed_mean_f64(arena, mask, trim_k: int) -> np.ndarray:
    """Host f64 oracle of :func:`masked_trimmed_mean_ref`: per column, the
    valid rows sorted, ``trim_k`` dropped from each end and the rest averaged;
    the untrimmed mean of the valid rows when that leaves none; 0 with none."""
    rows, m = _f64(arena), _f64(mask)
    n_valid = int(m.sum())
    if n_valid == 0:
        return np.zeros(rows.shape[1])
    valid = np.sort(rows[m > 0], axis=0)
    if n_valid <= 2 * trim_k:
        return valid.mean(axis=0)
    return valid[trim_k: n_valid - trim_k].mean(axis=0)
