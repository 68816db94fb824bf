"""Mean seconds a train task waited in the engine's executor queue for a
worker once the traced window is in its steady state: span
``dispatch.queue`` with ``task_kind`` ``train`` (from ``executor.submit`` to
the worker starting the task), of the tasks submitted at or after the
window's first ``aggregate`` record.  The window opens on a drained engine,
which submits every learner's task at once into an empty queue; the tasks of
that burst wait less than those of the steady state behind ``update_p95_s``,
so they are left out.  A task whose wait outlasts the trace is not journaled."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "async":
        return None
    aggregates = spans.window_records(run, "aggregate")
    if not aggregates:
        return None
    return spans.mean_s(run, "dispatch.queue", since=min(r["t"] for r in aggregates),
                        task_kind="train")
