"""The 'old Python controller' baseline MetisFL was re-engineered against.

The port of ``repro/core/naive.py``.  The paper (§3) describes the original
Python controller: per-tensor handling, GIL-serialized aggregation, blocking
dispatch.  Its 10x claim is measured against that baseline, so this module
does the controller's operations the slow way, on purpose, on the host:

* :func:`naive_aggregate` — iterate tensors in Python and, within each
  tensor, learners in Python, accumulating in host numpy float64 one learner
  at a time (no packing, no fusion, no vectorized ``(N, P)`` reduce);
* :func:`naive_serialize` / :func:`naive_deserialize` — per-tensor pickling
  (framework-native object transport instead of flat bytes);
* :class:`NaiveDispatcher` — strictly sequential, blocking task dispatch.

Leaves come in the port's tree order (``repro_torch.tree``), which is the
reference's; the results are numpy arrays, as the reference's are.  Used only
as the baseline arm of measurements and tests.
"""

from __future__ import annotations

import pickle
import time
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.tree import Structure, flatten, unflatten

__all__ = ["naive_aggregate", "naive_serialize", "naive_deserialize", "NaiveDispatcher"]


def _host(leaf: Any) -> np.ndarray:
    """A leaf as a host numpy array (one device-to-host copy for a tensor)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def naive_aggregate(models: Sequence[Any], weights: Sequence[float]) -> Any:
    """Per-tensor, per-learner Python-loop FedAvg (the GIL-era controller).

    models: one parameter tree per learner.  Returns the tree of numpy
    arrays, each in its tensor's dtype.
    """
    wsum = float(sum(weights))
    norm = [float(w) / wsum for w in weights]
    flat_models = [flatten(m)[0] for m in models]
    structure = flatten(models[0])[1]
    n_tensors = len(flat_models[0])
    out_leaves = []
    for t in range(n_tensors):  # one "thread" per tensor... except sequential
        acc = None
        for i, fm in enumerate(flat_models):  # learner loop, host-side
            contrib = np.asarray(_host(fm[t]), dtype=np.float64) * norm[i]
            acc = contrib if acc is None else acc + contrib
        out_leaves.append(np.asarray(acc, dtype=_host(flat_models[0][t]).dtype))
    return unflatten(structure, out_leaves)


def naive_serialize(params: Any) -> list[bytes]:
    """Per-tensor pickle — the framework-native-object wire format."""
    return [pickle.dumps(_host(leaf)) for leaf in flatten(params)[0]]


def naive_deserialize(blobs: list[bytes], structure: Structure) -> Any:
    """Inverse of :func:`naive_serialize`: per-tensor unpickle + unflatten."""
    return unflatten(structure, [pickle.loads(b) for b in blobs])


class NaiveDispatcher:
    """Blocking, sequential task dispatch: serialize + run + wait per learner."""

    def __init__(self):
        self.dispatch_s = 0.0

    def dispatch(self, params: Any, learners: Sequence[Callable[[Any], Any]]) -> list[Any]:
        """Serialize, send, and block on each learner strictly in turn."""
        results = []
        structure = flatten(params)[1]
        for learner_fn in learners:
            t0 = time.perf_counter()
            blobs = naive_serialize(params)
            received = naive_deserialize(blobs, structure)
            self.dispatch_s += time.perf_counter() - t0
            results.append(learner_fn(received))  # blocks until done
        return results
