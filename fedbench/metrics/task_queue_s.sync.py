"""Mean seconds a train task of the traced rounds waited in the engine's
executor queue for a worker: span ``dispatch.queue`` with ``task_kind``
``train`` (from ``executor.submit`` to the worker starting the task)."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "sync":
        return None
    return spans.mean_s(run, "dispatch.queue", task_kind="train")
