"""Device resolution and the port's numeric settings.

Every entry point of the port takes ``device=`` and defaults to the CUDA
card.  There is no silent CPU fallback: asking for the default device on a
machine without CUDA raises, so a run that was meant for the card can never
quietly measure the host instead.  The CPU is used only when the caller asks
for it (the parity tests pass ``device="cpu"``).
"""

from __future__ import annotations

import torch

__all__ = ["resolve_device", "full_f32", "wait_queued"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device a port entry point runs on: ``cuda`` unless told otherwise.

    ``None`` means the card; it raises when CUDA is absent instead of falling
    back.  An explicit ``"cuda"`` also raises without CUDA; ``"cpu"`` is always
    accepted.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the CUDA card by default and CUDA is not "
            "available here; pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def full_f32() -> None:
    """Compute float32 in full float32 on the card.

    The reference computes in full f32, while cuDNN's float32 convolutions
    default to TF32 (about three decimal digits).  Both switches are set at
    the port's entry points so every float32 product and convolution keeps
    the reference's precision.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def wait_queued(device: torch.device) -> None:
    """Wait for the work this thread has queued on the device so far (no-op on
    the CPU).

    PyTorch returns before the card finishes, so a host clock read without
    this measures the enqueue, not the work.  A CUDA event recorded on the
    current stream and waited on covers what was queued before it — as
    ``jax.block_until_ready`` covers one result — and not the work other
    threads queue later, which ``torch.cuda.synchronize`` would wait for too.
    """
    if device.type == "cuda":
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(device))
        done.synchronize()
