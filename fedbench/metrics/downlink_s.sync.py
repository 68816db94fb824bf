"""Host seconds of the downlink a traced round: spans
``controller.broadcast`` (the model serialized once, its copy to the host)
and ``learner.recv`` (every train and eval receive, the copy to the card),
summed over the traced window and divided by its rounds.  Receives of the
two workers overlap in time."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "sync":
        return None
    return spans.per_step_s(run, "controller.broadcast", "learner.recv")
