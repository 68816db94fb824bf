"""Useful FLOPs of every local step and eval forward of the window (the
counts of ``harness/counts.py``) over the window's seconds and the H100's
dense bf16 peak, in percent."""

from fedbench.harness.counts import PEAK_BF16_FLOPS


def read(run):
    if run.protocol != "async" or run.window_s <= 0:
        return None
    return 100.0 * run.useful_flops / (run.window_s * PEAK_BF16_FLOPS)
