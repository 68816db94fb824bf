"""Kernel 1 (``fedavg_kernel<F32>``, the masked FedAvg over the f32 arena)
in the traced window: the bytes its calls must move (every live row read,
the mean written) at 3.35 TB/s, over their device time, in percent."""

from fedbench.harness import counts


def read(run):
    if run.protocol != "async" or run.trace is None:
        return None
    calls = run.trace.calls(r"fedavg_kernel<.*\bF32>")
    if not calls:
        return None
    seconds = sum(op.end - op.start for op in calls) / 1e9
    nbytes = len(calls) * counts.fedavg_f32_bytes(run.learners, run.arena_width)
    return 100.0 * counts.bound_seconds(nbytes) / seconds
