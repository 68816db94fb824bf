"""MetisFL reproduction, PyTorch/CUDA port.

A second package beside the JAX reference (``src/repro/``), mirroring its
layout (``core/``, ``kernels/``, ``models/``, ``optim/``, ``data/``,
``configs/``, ``launch/``) so every counterpart is found by path.  It imports
``torch`` and numpy only — never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``
(:func:`repro_torch.device.resolve_device`); on a CUDA tensor the kernel
layer (``kernels/ops.py``) launches the hand-written Hopper kernels.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
