"""Host seconds of the uplink a community update: spans ``learner.upload``
(pack the trained row, encode it: the copy to the host) and
``controller.ingest`` (decode: the copy to the card, screen, arena write),
summed over the traced window and divided by the updates committed in it."""

from fedbench.harness import spans


def read(run):
    if run.protocol != "async":
        return None
    return spans.per_step_s(run, "learner.upload", "controller.ingest")
