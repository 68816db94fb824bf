"""Host seconds of the downlink a community update: spans
``controller.broadcast`` (the new model serialized once, its copy to the
host) and ``learner.recv`` (each receive, the copy to the card), summed over
the traced window and divided by the updates committed in it."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "async":
        return None
    return spans.per_step_s(run, "controller.broadcast", "learner.recv")
