"""The share of the traced window in which the engine's loop thread was in
``controller.ingest``, ``controller.aggregate`` or ``controller.broadcast``
(the union of those spans), in percent."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "async" or run.trace is None or run.trace.window_s <= 0:
        return None
    busy = spans.union_s(run, "controller.ingest", "controller.aggregate",
                         "controller.broadcast")
    return None if busy is None else 100.0 * busy / run.trace.window_s
